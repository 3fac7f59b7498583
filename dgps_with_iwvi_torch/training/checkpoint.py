"""Checkpoints and deterministic resume
(port of dgps_with_iwvi_tpu/training/checkpoint.py:40-116).

One ``step_<n>.pt`` per save, written by ``torch.save``. It holds the
whole training state (``rest``, the natgrad blocks ``natvars``, Adam's
``state_dict()`` and ``step``) and the training generator's state, so a
restarted run continues bit for bit. The reference saves through orbax;
the file format is the port's own.

Under a mesh (reference l.25-28 saves collectively): rank 0 writes the
file and every rank waits at a barrier; every rank restores the same
file, and the ranks then check that they agree bitwise.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..parallel.sharding import replicas_agree
from .train import TrainState


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState,
                    generator: torch.Generator, mesh=None) -> str:
    """Write the state and the generator's state to ckpt_dir/step_<step>.pt
    (through a temporary file, so a crash leaves no half-written
    checkpoint). Returns the path. With a mesh every rank calls this: rank
    0 writes, the others wait for it."""
    path = _path(ckpt_dir, step)
    if mesh is None or dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        payload = {"state": {"rest": _detached(state.rest),
                             "natvars": _detached(state.natvars),
                             "opt_state": state.opt_state.state_dict(),
                             "step": int(state.step)},
                   "generator": generator.get_state()}
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if mesh is not None:
        dist.barrier()
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        stem = name.removesuffix(".pt")
        if name.endswith(".pt") and stem.startswith("step_"):
            try:
                steps.append(int(stem.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _copy_into(dst, src, where: str) -> None:
    """Copy the saved tree `src` into the tensors of `dst` in place, after
    checking that both have the same structure and shapes."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"{where}: saved keys "
                             f"{sorted(src) if isinstance(src, dict) else src}"
                             f" differ from {sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k], f"{where}.{k}")
    elif isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"{where}: saved length differs from "
                             f"{len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{where}[{i}]")
    else:
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
            raise ValueError(f"{where}: saved shape "
                             f"{getattr(src, 'shape', None)} differs from "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)


def restore_checkpoint(ckpt_dir: str, step: int, like: dict,
                       mesh=None) -> dict:
    """Restore {'state': TrainState, 'generator': torch.Generator} into the
    template `like` of the same form (its state built by
    ``make_trainer(...)[0](params)``, on the device to restore to): the
    template's tensors, Adam and generator take the saved values, and the
    restored dict is returned. A template without 'generator' (a server,
    which draws no training minibatches) restores the state alone. With a
    mesh every rank restores the file, and all must then hold it bitwise
    alike."""
    path = _path(ckpt_dir, step)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state, tmpl = saved["state"], like["state"]
    try:
        _copy_into(tmpl.rest, state["rest"], "rest")
        _copy_into(tmpl.natvars, state["natvars"], "natvars")
        # Adam is capturable on the card only (training/train.py): the
        # template's device decides, so a state saved on one device
        # resumes on another
        for group_saved, group in zip(state["opt_state"]["param_groups"],
                                      tmpl.opt_state.param_groups):
            group_saved["capturable"] = group["capturable"]
        tmpl.opt_state.load_state_dict(state["opt_state"])
    except ValueError as e:
        raise ValueError(
            f"{e}\n[restore_checkpoint] {path} was written for another "
            "model or training layout (other --configuration, --M, "
            "--natgrad or --q_diag flags). Rebuild with the original flags, "
            "or retrain without --resume.") from None
    out = {"state": TrainState(tmpl.rest, tmpl.natvars, tmpl.opt_state,
                               state["step"])}
    if "generator" in like:
        like["generator"].set_state(saved["generator"])
        out["generator"] = like["generator"]
    if mesh is not None and not replicas_agree(mesh, out):
        raise RuntimeError(f"[restore_checkpoint] the ranks restored {path} "
                           "to different states")
    return out
