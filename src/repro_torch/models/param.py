"""Parameter descriptor trees (the port's twin of ``repro.models.param``).

Model ``describe_*`` functions build nested dicts whose leaves are ``P``
descriptors: a shape, an initializer kind and an optional dtype override.
``materialize`` turns one into real tensors on a device.

The reference folds a sha256 of each leaf's path into a JAX PRNG key; torch
cannot reproduce those bits, so the port draws every leaf, in sorted path
order, from one ``torch.Generator`` seeded by ``seed`` on the target device
(the same seed gives the same parameters on the same device).  Tests that
compare the two packages carry the JAX weights across
(``repro_torch.models.convert``) instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclass(frozen=True)
class P:
    """One parameter leaf descriptor."""

    shape: Tuple[int, ...]
    # "normal" (std ``stddev``, else fan-in scaled) | "ones" | "zeros" |
    # "const" (every element ``value``) | "log_arange" (log(1..N) along
    # the last axis, broadcast over the others: mamba's A_log)
    init: str = "normal"
    dtype: Optional[str] = None   # override of the param dtype
    stddev: Optional[float] = None
    value: Optional[float] = None

    def std(self) -> float:
        if self.stddev is not None:
            return self.stddev
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))


def dense(d_in: int, d_out: int) -> P:
    return P((d_in, d_out))


def norm_scale(d: int) -> P:
    return P((d,), init="ones", dtype="float32")


def stack_layers(tree, n: int):
    """Prepend a 'layers' dim of ``n`` to every leaf of a per-layer tree."""
    if isinstance(tree, P):
        return P((n,) + tree.shape, tree.init, tree.dtype, tree.stddev,
                 tree.value)
    return {k: stack_layers(v, n) for k, v in tree.items()}


def iter_leaves(tree, prefix: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level (the
    order JAX flattens a dict in); a plain tuple (xLSTM's recurrent states)
    is walked in order, its indices in the path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], prefix + (k,))
    elif type(tree) is tuple:
        for i, v in enumerate(tree):
            yield from iter_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a nested dict (plain tuples
    included), structure kept."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if type(tree) is tuple:
        return tuple(map_tree(fn, v) for v in tree)
    return fn(tree)


def get_path(tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def build_tree(like, fn, path: Tuple[str, ...] = ()):
    """A nested dict shaped like ``like`` whose leaf at each path is
    ``fn(path)``."""
    if isinstance(like, dict):
        return {k: build_tree(v, fn, path + (k,)) for k, v in like.items()}
    return fn(path)


def materialize(seed: int, tree, param_dtype: str = "float32",
                device=None) -> Dict:
    """Real parameters for a descriptor tree, drawn on ``device`` (the CUDA
    card unless given) from one generator seeded by ``seed`` (leaves in
    sorted path order), each straight into its own dtype: a bf16 leaf
    takes no float32 copy of itself (moonshot-v1-16b-a3b's bf16 expert
    leaves would need 35 GB more)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(p: P) -> torch.Tensor:
        dt = torch_dtype(p.dtype or param_dtype)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=device)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=device)
        if p.init == "const":
            return torch.full(p.shape, p.value, dtype=dt, device=device)
        if p.init == "log_arange":
            n = torch.arange(1, p.shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(n).expand(p.shape).to(dt).contiguous()
        return torch.empty(p.shape, dtype=dt, device=device).normal_(
            0.0, p.std(), generator=gen)

    out: Dict = {}
    for path, p in iter_leaves(tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = make(p)
    return out


def count_params(tree) -> int:
    return sum(math.prod(p.shape) for _, p in iter_leaves(tree))
