"""Process groups for several ranks
(port of dgps_with_iwvi_tpu/parallel/distributed.py:41-92).

The reference joins processes with ``jax.distributed``; the port joins
them with ``torch.distributed``. Under ``torchrun --nproc_per_node N``
every process calls :func:`initialize` first, which reads the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); then ``mesh.make_mesh`` lays the ranks out as a
('dp', 'k') mesh. A program that made its own group (``torch.
multiprocessing`` ranks joined through a ``FileStore``, say) hands it on:
:func:`initialize` leaves an existing default group as it is.

Backends: NCCL on cards and gloo on the CPU by default. gloo also takes
CUDA tensors, with its collectives crossing through the host; it is the
backend that lets several ranks share one card (NCCL refuses two ranks on
one device), and it is used only where the caller names it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None, *,
               device="cuda") -> bool:
    """Join the default process group; returns whether the run has more
    than one process.

    With no arguments it initializes from torchrun's environment, and is
    a no-op returning False where no launch is detectable (a single
    process: the common case). It is also a no-op where a default group
    already exists. `device` is where the ranks compute: on cards the
    backend defaults to NCCL and each rank takes the card LOCAL_RANK
    (``torch.cuda.set_device``, before any CUDA tensor exists); an
    explicit ``backend="gloo"`` lets ranks share cards, rank LOCAL_RANK
    on card LOCAL_RANK mod the card count."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and env.get("MASTER_ADDR"):
        init_method = "env://"
    if init_method is not None and world_size is None:
        # a coordinator with no world size cannot be a single-process run:
        # proceeding would have every process train its own model
        raise ValueError(
            f"initialize(init_method={init_method!r}) also needs world_size "
            "(and rank): pass them, or export WORLD_SIZE and RANK in every "
            "process (torchrun does)")
    if init_method is None:
        return False
    if rank is None:
        raise ValueError(f"initialize: world_size={world_size} but no rank "
                         "(pass rank= or export RANK)")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        count = torch.cuda.device_count()
        if backend == "nccl" and local >= count:
            raise RuntimeError(
                f"LOCAL_RANK {local} but {count} visible card(s): NCCL needs "
                "a card of its own per rank (backend='gloo' lets ranks "
                "share cards)")
        torch.cuda.set_device(local % count)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return world_size > 1


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1
