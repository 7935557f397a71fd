"""Carry weights across from the JAX package.

The port keeps the JAX layouts (``wq (d,H,D)``, ``wk``/``wv (d,KV,D)``,
``wo (H,D,d)``, MLP matrices ``(d_in, d_out)``, a MoE layer's router
``(d, E)`` and experts ``(E, d, F)`` / ``(E, F, d)``, MLA's ``w_dkv``,
``w_kpe``, ``kv_norm``, ``w_uk``, ``w_uv``, every segment stacked on a
leading layer axis under ``seg{i}_{kind}``; xLSTM's, Hymba's and the
encoder-decoder's trees as the reference lays them out), so carrying a
parameter tree (or a KV, MLA latent or recurrent-state cache) across is a
copy, leaf for leaf, and checkpoint leaves match the JAX package's byte for
byte.  Inputs are numpy arrays (``np.asarray`` of the JAX leaves); bfloat16
arrays arrive as numpy's ml_dtypes bfloat16 and are moved by their bits.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.param import map_tree
from repro_torch.train.optimizer import AdamWState


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy array (any dtype JAX emits, bfloat16 included) as a tensor
    with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device) if device is not None else t


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as numpy; bfloat16 as its bits in a float32 widening (for
    comparisons only)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def from_jax_params(tree: Dict, device=None) -> Dict:
    """A JAX parameter tree (nested dicts and tuples of numpy arrays) as
    the port's, on ``device`` (the CUDA card unless given)."""
    device = resolve_device(device)
    return map_tree(lambda a: tensor_from_numpy(a, device), tree)


def from_jax_cache(tree: Dict, device=None) -> Dict:
    """A JAX cache tree of numpy (``TransformerLM``'s ``{seg_name: {"k",
    "v"}}``, Hymba's and the encoder-decoder's nested dicts, xLSTM's
    recurrent states with their ``(C, n, m)`` and ``(c, n, m, h)`` tuples;
    from ``init_cache`` or a decode step) as the port's, on ``device`` (the
    CUDA card unless given): the same tree, leaf for leaf."""
    return from_jax_params(tree, device)


def from_jax_opt_state(state: Any, device=None) -> AdamWState:
    """A JAX ``AdamWState(step, mu, nu)`` of numpy leaves as the port's, on
    ``device`` (the CUDA card unless given)."""
    device = resolve_device(device)
    step, mu, nu = state
    return AdamWState(tensor_from_numpy(step, device),
                      from_jax_params(mu, device), from_jax_params(nu, device))


def to_numpy_tree(tree: Any):
    """A nested dict / tuple of tensors as the same structure of numpy."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [to_numpy_tree(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tensor_to_numpy(tree)
