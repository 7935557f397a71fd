"""Logical-axis sharding (twin of ``repro.distributed.sharding``): one rules
table maps logical axes to mesh axes.

Parameters and activations carry *logical* axis names (``models/param.py``).
A ``MeshContext`` holds a mesh and the logical → mesh rules;
``logical_constraint`` redistributes a ``DTensor`` only while a context is
active, so the same model code runs unsharded on plain tensors (it returns
them unchanged) and laid out on a ``DeviceMesh``.

A mesh is anything with ``axis_names`` and a ``shape`` mapping (the
reference's ``FakeMesh``, ``launch.mesh.AbstractMesh``) or a torch
``DeviceMesh`` (its ``mesh_dim_names`` and sizes).  A partition spec is a
tuple with one entry a tensor dim: None, a mesh-axis name, or a tuple of
names (the reference's ``PartitionSpec`` as a tuple).  On a ``DeviceMesh``
it becomes DTensor placements: ``Shard(d)`` on each mesh dim named for dim
d, ``Replicate()`` elsewhere.  A dim split over two mesh axes, e.g.
``("pod", "data")``, is split in mesh-dim order, major first, which is
JAX's order when the names are in the mesh's order (the default rules'
always are; another order raises).

Default rules (production meshes, see ``launch/mesh.py``):
  batch   → ("pod", "data")     activations' batch dim (DP)
  fsdp    → ("pod", "data")     parameter dim sharded ZeRO-3 style
  seq     → ("data",)           sequence dim for long-context SP
  ffn/heads/kv/vocab/experts → ("model",)   TP / EP
  embed, layers, None → replicated
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

PartitionSpec = Tuple[Any, ...]


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(axis names, {name: size}) of a mesh or a torch ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), dict(zip(names, mesh.mesh.shape))
    return tuple(mesh.axis_names), dict(mesh.shape)


def default_rules(mesh, *, fsdp: bool = True,
                  seq_shard: bool = False) -> Dict[str, Tuple[str, ...]]:
    axes, _ = mesh_axes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    model_axes = ("model",) if "model" in axes else ()
    return {
        "batch": dp_axes,
        "fsdp": dp_axes if fsdp else (),
        # ZeRO-3: parameter embed dims shard over DP axes; on activations the
        # batch dim claims those axes first (pspec dedupes), so this only
        # affects parameters/optimizer state.
        "embed": dp_axes if fsdp else (),
        "seq": dp_axes if seq_shard else (),
        "ffn": model_axes,
        "heads": model_axes,
        "kv": model_axes,
        "vocab": model_axes,
        "experts": model_axes,
        "expert_ffn": (),   # per-expert hidden dim (experts already on model)
        "layers": (),
        "act_kv_seq": dp_axes if seq_shard else (),  # KV-cache seq dim (SP)
        # small-head archs shard attention over the idle model axis
        "attn_seq": model_axes,
        "attn_blocks": model_axes,
    }


def _names(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    def placements(self) -> list:
        """The spec as DTensor placements on ``mesh`` (a ``DeviceMesh``)."""
        from torch.distributed.tensor import Replicate, Shard
        names, _ = mesh_axes(self.mesh)
        out = [Replicate() for _ in names]
        for d, part in enumerate(self.spec):
            idx = [names.index(a) for a in _names(part)]
            if idx != sorted(idx):
                raise ValueError(f"dim {d} is split over {part}, not in the "
                                 f"mesh's order {names}: DTensor would split "
                                 f"it in another order than JAX")
            for i in idx:
                out[i] = Shard(d)
        return out

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's shard of a tensor of ``shape`` (dims divide)."""
        _, sizes = mesh_axes(self.mesh)
        out = list(shape)
        for d, part in enumerate(self.spec):
            for a in _names(part):
                out[d] //= sizes[a]
        return tuple(out)


@dataclass
class MeshContext:
    mesh: Any
    rules: Dict[str, Tuple[str, ...]]
    # axes whose mesh assignment was disabled because dims didn't divide
    disabled: set = field(default_factory=set)

    def pspec(self, axes: Sequence[Optional[str]],
              shape: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
        """Map logical axes to a partition spec, dropping mesh axes a dim
        already used claims and those a dim's size does not divide."""
        _, sizes = mesh_axes(self.mesh)
        parts = []
        used: set = set()
        for i, ax in enumerate(axes):
            mesh_axes_ = () if ax is None or ax in self.disabled else \
                self.rules.get(ax, ())
            mesh_axes_ = tuple(a for a in mesh_axes_ if a not in used)
            if shape is not None and mesh_axes_:
                total = 1
                for a in mesh_axes_:
                    total *= sizes[a]
                if shape[i] % total != 0:
                    mesh_axes_ = ()
            used.update(mesh_axes_)
            if len(mesh_axes_) == 0:
                parts.append(None)
            elif len(mesh_axes_) == 1:
                parts.append(mesh_axes_[0])
            else:
                parts.append(tuple(mesh_axes_))
        return tuple(parts)

    def sharding(self, axes: Sequence[Optional[str]],
                 shape: Optional[Tuple[int, ...]] = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.pspec(axes, shape))

    def placements(self, axes: Sequence[Optional[str]],
                   shape: Optional[Tuple[int, ...]] = None) -> list:
        return self.sharding(axes, shape).placements()


_tls = threading.local()


def current_mesh_context() -> Optional[MeshContext]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None,
                 **rule_kw):
    """Make a ``MeshContext`` of ``mesh`` current on this thread."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = MeshContext(mesh, rules or default_rules(mesh, **rule_kw))
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


def logical_constraint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` laid out by logical axes on the current context's mesh: a
    ``DTensor`` is redistributed to the context's placements; a plain
    tensor, or any tensor without a context, is returned unchanged."""
    ctx = current_mesh_context()
    if ctx is None or type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, ctx.placements(axes, tuple(x.shape)))


def _is_axes_leaf(t) -> bool:
    """Axes leaves are tuples of axis names / None (incl. the empty tuple).

    NamedTuples of tensors (optimizer state) and tuples of tensors
    (recurrent cell states) are NOT leaves.
    """
    return isinstance(t, tuple) and \
        all(x is None or isinstance(x, str) for x in t)


def map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` at every axes leaf of ``axes_tree``, the other
    trees walked in step (dicts, NamedTuples, tuples, lists); the result has
    ``axes_tree``'s structure."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(
            map_axes(fn, getattr(axes_tree, n), *(getattr(t, n)
                                                  for t in trees))
            for n in axes_tree._fields))
    if isinstance(axes_tree, (tuple, list)):
        return type(axes_tree)(map_axes(fn, v, *(t[i] for t in trees))
                               for i, v in enumerate(axes_tree))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts (keys sorted), NamedTuples, tuples and
    lists, in order; anything else (a tensor, a ``NamedSharding``) is a
    leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def logical_to_pspec(axes_tree, ctx: MeshContext, shape_tree=None):
    """Map a tree of logical-axes tuples (+ optional shapes) to specs."""
    if shape_tree is None:
        return map_axes(ctx.pspec, axes_tree)
    return map_axes(lambda axes, t: ctx.pspec(axes, tuple(t.shape)),
                    axes_tree, shape_tree)


def spec_tree_for(axes_tree, abstract_tree, ctx: MeshContext):
    """``NamedSharding``s for an abstract (meta tensor) tree."""
    return map_axes(lambda axes, t: ctx.sharding(axes, tuple(t.shape)),
                    axes_tree, abstract_tree)
