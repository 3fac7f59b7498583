"""Carry a parameter tree between the reference and the port.

The reference's parameters are a pytree of dicts, lists and arrays; the
port's are the same tree of ``torch.Tensor``s under the same keys
(``layers[i].kernel.raw_variance``, ``.Z``, ``.q_mu``, ``.q_sqrt``,
``.mean_W``, ``.encoder...``, ``likelihood.raw_noise_variance``). Pass
the reference tree through ``numpy`` (``np.asarray`` per leaf, or
``jax.device_get``) and this module converts it; nothing here imports
the reference. A training state's values go the same way
(``state_to_numpy`` / ``state_from_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def params_from_numpy(tree, device="cuda", dtype=None):
    """A tree of array-likes -> the same tree of tensors on `device`.

    dtype=None keeps each leaf's dtype; otherwise floating leaves are
    cast to it."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        t = torch.from_numpy(np.array(x, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return conv(tree)


def params_to_device(tree, device):
    """The same tree of tensors on `device` (tensors already there are
    reused, not copied)."""
    if isinstance(tree, dict):
        return {k: params_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_device(v, device) for v in tree)
    return tree.to(device)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: tensors -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def state_to_numpy(state) -> dict:
    """A training state's values, {"rest": tree, "natvars": list}, as
    numpy arrays (the layout of the reference's ``TrainState`` fields)."""
    return {"rest": params_to_numpy(state.rest),
            "natvars": params_to_numpy(state.natvars)}


def state_from_numpy(state, arrays: dict):
    """Copy `arrays` (as ``state_to_numpy`` returns them, or the
    reference's ``TrainState`` fields through numpy) into the state's
    tensors in place; returns the state. The optimizer's moments are not
    touched."""
    def copy(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k])
        elif isinstance(dst, (list, tuple)):
            for d, s in zip(dst, src):
                copy(d, s)
        else:
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(src, copy=True)))

    copy(state.rest, arrays["rest"])
    copy(state.natvars, arrays["natvars"])
    return state
