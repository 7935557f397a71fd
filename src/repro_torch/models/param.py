"""Parameter descriptor trees (the port's twin of ``repro.models.param``).

Model ``describe_*`` functions build nested dicts whose leaves are ``P``
descriptors: a shape, its logical sharding axes, an initializer kind and
an optional dtype override.  From one descriptor tree come:

* ``materialize``  — real tensors on a device,
* ``abstract``     — meta tensors of each leaf's shape and dtype (the dry
                     run; no memory, no generator),
* ``logical_axes`` — the same tree of logical-axis tuples, which
                     ``distributed.sharding`` maps onto a mesh.

The logical axis names are the reference's: "embed", "ffn", "heads", "kv",
"vocab", "experts", "expert_ffn", "layers" (the stacked layer dim), and
None (replicated).

The reference folds a sha256 of each leaf's path into a JAX PRNG key; torch
cannot reproduce those bits, so the port draws every leaf, in sorted path
order, from one ``torch.Generator`` seeded by ``seed`` on the target device
(the same seed gives the same parameters on the same device).  Tests that
compare the two packages carry the JAX weights across
(``repro_torch.models.convert``) instead.
"""
from __future__ import annotations

import dataclasses
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
    # logical axis name (or None) of each dim; None: every dim replicated
    axes: Optional[Tuple[Optional[str], ...]] = None
    # "normal" (std ``stddev``, else fan-in scaled) | "ones" | "zeros" |
    # "const" (every element ``value``) | "log_arange" (log(1..N) along
    # the last axis, broadcast over the others: mamba's A_log)
    init: str = "normal"
    dtype: Optional[str] = None   # override of the param dtype
    stddev: Optional[float] = None
    value: Optional[float] = None

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def std(self) -> float:
        if self.stddev is not None:
            return self.stddev
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))


def dense(d_in: int, d_out: int, in_ax: Optional[str],
          out_ax: Optional[str], stddev: Optional[float] = None) -> P:
    return P((d_in, d_out), (in_ax, out_ax), stddev=stddev)


def norm_scale(d: int, ax: Optional[str] = "embed") -> P:
    return P((d,), (ax,), init="ones", dtype="float32")


def bias(d: int, ax: Optional[str]) -> P:
    return P((d,), (ax,), init="zeros")


def stack_layers(tree, n: int):
    """Prepend a 'layers' dim of ``n`` to every leaf of a per-layer tree."""
    if isinstance(tree, P):
        return dataclasses.replace(tree, shape=(n,) + tree.shape,
                                   axes=("layers",) + tree.axes)
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


def logical_axes(tree):
    """The descriptor tree with each leaf replaced by its axes tuple."""
    return map_tree(lambda p: p.axes, tree)


def abstract(tree, param_dtype: str = "float32"):
    """Meta tensors of each leaf's shape and dtype (no memory, no
    generator: ``materialize`` cannot draw on the meta device)."""
    return map_tree(lambda p: torch.empty(
        p.shape, dtype=torch_dtype(p.dtype or param_dtype), device="meta"),
        tree)


def count_params(tree) -> int:
    return sum(math.prod(p.shape) for _, p in iter_leaves(tree))


def param_bytes(tree, param_dtype: str = "float32") -> int:
    return sum(math.prod(p.shape) *
               torch_dtype(p.dtype or param_dtype).itemsize
               for _, p in iter_leaves(tree))
