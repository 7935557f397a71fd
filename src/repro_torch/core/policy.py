"""Per-scope layout policy (twin of ``repro.core.policy``).

A copy of the JAX package's ``LayoutPolicy``: path scopes map to
``LayoutMode``s, compiled into a ``(scope_hash → mode)`` table.  Host-side
resolution (strings) is unchanged; ``resolve``/``mode_array`` work on
tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.core.layouts import (DEFAULT_MODE, LayoutMode, LayoutParams,
                                      str_hash)

# scope-hash value meaning "no scope matched → default mode"; str_hash is
# 31-bit non-negative, so -1 can never collide with a real scope hash.
SCOPE_NONE = -1


def _norm_scope(scope: str) -> str:
    s = scope.rstrip("/")
    return s if s else "/"


@dataclass(frozen=True)
class LayoutPolicy:
    """A per-scope layout plan, compiled into a vectorizable lookup table."""

    n_nodes: int
    default_mode: LayoutMode = DEFAULT_MODE
    scopes: Tuple[Tuple[str, LayoutMode], ...] = ()
    metadata_server_ratio: float = 0.125
    chunk_bytes: int = 1 << 20

    @classmethod
    def uniform(cls, mode: LayoutMode, n_nodes: int, **kw) -> "LayoutPolicy":
        """Single-mode plan."""
        return cls(n_nodes=n_nodes, default_mode=LayoutMode(mode), **kw)

    @classmethod
    def from_scopes(cls, scopes: Mapping[str, LayoutMode], n_nodes: int,
                    default: LayoutMode = DEFAULT_MODE, **kw
                    ) -> "LayoutPolicy":
        """Heterogeneous plan from a {scope-prefix: mode} mapping."""
        items = tuple(sorted((_norm_scope(s), LayoutMode(m))
                             for s, m in scopes.items()))
        return cls(n_nodes=n_nodes, default_mode=LayoutMode(default),
                   scopes=items, **kw)

    @property
    def n_md_servers(self) -> int:
        """Mode-2 metadata-server count: ratio × n_nodes, at least 1."""
        return max(1, int(round(self.n_nodes * self.metadata_server_ratio)))

    @property
    def table(self) -> Tuple[Tuple[int, int], ...]:
        """The compiled lookup table: ((scope_hash, mode_int), …)."""
        return tuple((str_hash(s), int(m)) for s, m in self.scopes)

    def modes_present(self) -> frozenset:
        """The set of modes any request under this policy can carry."""
        return frozenset({self.default_mode} | {m for _, m in self.scopes})

    def scope_of(self, path: str) -> Optional[str]:
        """Longest scope prefix matching ``path`` (on segment boundaries)."""
        best = None
        for s, _ in self.scopes:
            if path == s or path.startswith(s + "/") or s == "/":
                if best is None or len(s) > len(best):
                    best = s
        return best

    def mode_for_path(self, path: str) -> LayoutMode:
        """Host-side mode of one path (longest scope prefix, else default)."""
        s = self.scope_of(path)
        return self.default_mode if s is None else dict(self.scopes)[s]

    def scope_hash_of(self, path: str) -> int:
        """Scope hash for one path — feed tensors of these to ``resolve``."""
        s = self.scope_of(path)
        return SCOPE_NONE if s is None else str_hash(s)

    def resolve(self, scope_hash: torch.Tensor) -> torch.Tensor:
        """(scope_hash tensor) → (int32 mode tensor) over the compiled table;
        unmatched hashes fall back to ``default_mode``."""
        sh = scope_hash.to(torch.int32)
        out = torch.full(sh.shape, int(self.default_mode), dtype=torch.int32,
                         device=sh.device)
        for h, m in self.table:
            out = torch.where(sh == h, m, out)
        return out

    def mode_array(self, shape, device) -> torch.Tensor:
        """Uniform default-mode int32 tensor of ``shape`` on ``device``."""
        return torch.full(tuple(shape), int(self.default_mode),
                          dtype=torch.int32, device=device)


def as_policy(layout) -> LayoutPolicy:
    """Coerce ``LayoutPolicy`` | ``LayoutParams`` → policy."""
    if isinstance(layout, LayoutPolicy):
        return layout
    if isinstance(layout, LayoutParams):
        return LayoutPolicy(
            n_nodes=layout.n_nodes, default_mode=layout.mode,
            metadata_server_ratio=layout.metadata_server_ratio,
            chunk_bytes=layout.chunk_bytes)
    raise TypeError(f"cannot interpret {layout!r} as a LayoutPolicy")
