"""The ('dp', 'k') mesh over the ranks of a process group
(port of dgps_with_iwvi_tpu/parallel/mesh.py:115-123).

'dp' splits the minibatch rows (the gradient is summed over every rank),
'k' splits the K importance samples (or the S Monte Carlo samples) of
each row, whose logsumexp then runs across the 'k' ranks. The inducing
points stay replicated: chol(Kuu) at M of a few hundred is cheaper to
repeat than to communicate.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_dp: int | None = None, n_k: int = 1,
              device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` with ``mesh_dim_names=("dp", "k")`` over the ranks
    of the default group, laid out row-major: rank r sits at (r // n_k,
    r % n_k). By default every rank goes on 'dp'. The mesh must hold the
    whole world: a rank outside it would have nothing to run. Every rank
    calls this, in the same order as its other group calls.

    The groups of both axes are made here with the default group's
    backend (``dist.new_group``), so a gloo world stays gloo on cards."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize() first (or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_dp is None:
        if world % n_k:
            raise ValueError(f"n_k={n_k} does not divide the world of "
                             f"{world} ranks")
        n_dp = world // n_k
    if n_dp * n_k != world:
        raise ValueError(f"a {n_dp}x{n_k} mesh over a world of {world} "
                         "ranks: the mesh must hold every rank")
    grid = torch.arange(world).reshape(n_dp, n_k)
    me = dist.get_rank()
    dp_group = k_group = None
    for j in range(n_k):
        ranks = grid[:, j].tolist()
        group = dist.new_group(ranks)
        if me in ranks:
            dp_group = group
    for i in range(n_dp):
        ranks = grid[i].tolist()
        group = dist.new_group(ranks)
        if me in ranks:
            k_group = group
    return DeviceMesh.from_group([dp_group, k_group],
                                 torch.device(device).type, mesh=grid,
                                 mesh_dim_names=("dp", "k"))


def mesh_shape(mesh: DeviceMesh) -> tuple:
    """(n_dp, n_k)."""
    return mesh.size(0), mesh.size(1)


def coordinate(mesh: DeviceMesh) -> tuple:
    """(i_dp, i_k) of this rank (the row-major layout of ``make_mesh``)."""
    return divmod(dist.get_rank(), mesh.size(1))
