"""Gradient compression for the DP all-reduce path (twin of
``repro.distributed.compression``).

Error-feedback compressors applied to gradients before the optimizer:
* ``int8``  — per-tensor symmetric quantization (32→8 bits on the wire),
* ``topk``  — magnitude top-k sparsification with residual accumulation.

Each takes ``(grads, residual)`` and returns ``(sent, residual)``: ``sent``
is what crosses the wire (dequantized / sparsified float32), the new
residual what it left behind, so ``sent + residual_new == g +
residual_old`` up to float32 rounding and the optimizer stays unbiased over
time.  Trees are the port's nested dicts of tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from repro_torch.models.param import build_tree, get_path, iter_leaves, \
    map_tree


def _zeros_like(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _per_leaf(comp: Callable, grads, residual) -> Tuple:
    out = {path: comp(g, get_path(residual, path))
           for path, g in iter_leaves(grads)}
    return (build_tree(grads, lambda path: out[path][0]),
            build_tree(grads, lambda path: out[path][1]))


@dataclass(frozen=True)
class Int8Compressor:
    def init(self, params):
        """Float32 zero residuals on the params' device."""
        return _zeros_like(params)

    def __call__(self, grads, residual):
        def comp(g, r):
            g = g.float() + r
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
            # torch.round, like jnp.round, rounds half to even
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            deq = q.float() * scale
            return deq, g - deq
        return _per_leaf(comp, grads, residual)


@dataclass(frozen=True)
class TopKCompressor:
    frac: float = 0.1

    def init(self, params):
        """Float32 zero residuals on the params' device."""
        return _zeros_like(params)

    def __call__(self, grads, residual):
        def comp(g, r):
            g = g.float() + r
            a = g.abs()
            k = max(1, int(a.numel() * self.frac))
            # the k-th largest |g|: a radix-select top-k over the flat leaf
            # (kthvalue runs a large slice in one CUDA block; the embedding
            # leaf is 302 M elements, k 30 M)
            thresh = torch.topk(a.reshape(-1), k, sorted=False).values.min()
            sent = torch.where(a >= thresh, g, 0.0)
            return sent, g - sent
        return _per_leaf(comp, grads, residual)
