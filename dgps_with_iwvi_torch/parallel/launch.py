"""Ranks started by one program on one host (``torch.multiprocessing``).

A launcher such as ``torchrun`` starts the ranks from outside; a program
that is itself one process (a gate, a smoke run, a test) starts them
with :func:`spawn_ranks` and waits for them. Each rank joins its group
by itself, through a file in a directory of the caller's
(:func:`join_group`): no TCP port, so programs that run side by side
cannot collide.
"""

from __future__ import annotations

import os
import time

import torch

from . import distributed


def spawn_ranks(fn, world: int, *args, timeout_s: float) -> None:
    """Run ``fn(rank, world, *args)`` in `world` new processes (spawned,
    so `fn` and `args` must pickle) and wait for all of them.

    Raises ``torch.multiprocessing.ProcessException`` when a rank raises
    or exits non-zero (the others are then terminated), and
    ``TimeoutError`` when the ranks outlast `timeout_s` seconds (all of
    them are then killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"the ranks ran past {timeout_s:g} s")


def join_group(rank: int, world: int, store_dir: str, device) -> str:
    """Join the default group of a spawned world through a file store in
    `store_dir` (which every rank names, and which holds no store yet).
    The backend is NCCL where each rank has a card of its own
    (``distributed.initialize``'s rule), else gloo: the CPU, or ranks
    that share cards (NCCL refuses two ranks on one device); on cards
    rank r computes on card r mod the card count. Returns the backend."""
    device = torch.device(device)
    backend = ("nccl" if device.type == "cuda"
               and world <= torch.cuda.device_count() else "gloo")
    distributed.initialize(
        backend, "file://" + os.path.join(os.path.abspath(store_dir),
                                          "store"),
        world, rank, device=device)
    return backend
