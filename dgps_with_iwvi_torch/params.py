"""Carry a parameter tree between the reference and the port.

The reference's parameters are a pytree of dicts, lists and arrays; the
port's are the same tree of ``torch.Tensor``s under the same keys
(``layers[i].kernel.raw_variance``, ``.Z``, ``.q_mu``, ``.q_sqrt``,
``.mean_W``, ``.encoder...``, ``likelihood.raw_noise_variance``). Pass
the reference tree through ``numpy`` (``np.asarray`` per leaf, or
``jax.device_get``) and this module converts it; nothing here imports
the reference.
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
