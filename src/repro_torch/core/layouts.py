"""The routing-function triplet on tensors (twin of ``repro.core.layouts``).

``LayoutMode``, ``str_hash`` and ``LayoutParams`` are copies of the JAX
package's pure-Python definitions; ``mix_hash``, ``route_data`` and
``route_meta`` are the same integer arithmetic on torch tensors.

PyTorch has no uint32 right shift on the CPU, so ``mix_hash`` runs the
FNV-style mix in int64 and masks every step back to 32 (then 31) bits:
``(h ^ x) * 16777619`` stays below 2⁵⁷, so the masked int64 product equals
the uint32 product mod 2³² of the reference, bit for bit.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import torch

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK31 = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


class LayoutMode(enum.IntEnum):
    """The paper's four burst-buffer data/metadata organizations.

    NODE_LOCAL: everything on the writing node (DataWarp-private);
    CENTRAL_META: metadata on a server subset, data hashed (BeeGFS);
    DIST_HASH: consistent hashing for both (GekkoFS, the fail-safe);
    HYBRID: local writes + hashed metadata with a recorded
    data-location rank and two-phase reads (HadaFS).
    """
    NODE_LOCAL = 1
    CENTRAL_META = 2
    DIST_HASH = 3
    HYBRID = 4


DEFAULT_MODE = LayoutMode.DIST_HASH


def str_hash(s: str) -> int:
    """FNV-1a over a path string → 31-bit non-negative int."""
    h = _FNV64_OFFSET
    for b in s.encode():
        h = ((h ^ b) * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h & _MASK31


@dataclass(frozen=True)
class LayoutParams:
    """Static per-job layout configuration (chosen before launch)."""

    mode: LayoutMode
    n_nodes: int
    metadata_server_ratio: float = 0.125
    chunk_bytes: int = 1 << 20

    @property
    def n_md_servers(self) -> int:
        """Mode-2 metadata-server count: ratio × n_nodes, at least 1."""
        return max(1, int(round(self.n_nodes * self.metadata_server_ratio)))


def mix_hash(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer mix of two int32 tensors → non-negative int32 (see module
    docstring for why the arithmetic is int64)."""
    h = 2166136261                      # FNV offset basis
    for part in (a, b):
        h = ((h ^ (part.to(torch.int64) & _MASK32)) * 16777619) & _MASK31
        h = h ^ (h >> 15)
    return (h & _MASK31).to(torch.int32)


def route_data(mode: torch.Tensor, n_nodes: int, path_hash: torch.Tensor,
               chunk_id: torch.Tensor, client_rank: torch.Tensor,
               data_loc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Data-placement routing with a per-request ``mode`` array.

    Mode 1 → writer-local; Modes 2/3 → consistent hash of (path, chunk);
    Mode 4 → ``data_loc`` when given (the metadata-recorded data location
    on reads), else the writer's rank.
    """
    local = torch.broadcast_to(client_rank, path_hash.shape).to(torch.int32)
    hashed = (mix_hash(path_hash, chunk_id) % n_nodes).to(torch.int32)
    placed = local if data_loc is None else data_loc.to(torch.int32)
    uses_hash = ((mode == LayoutMode.CENTRAL_META) |
                 (mode == LayoutMode.DIST_HASH))
    return torch.where(mode == LayoutMode.NODE_LOCAL, local,
                       torch.where(uses_hash, hashed, placed))


def route_meta(mode: torch.Tensor, n_nodes: int, n_md_servers: int,
               key_hash: torch.Tensor, client_rank: torch.Tensor
               ) -> torch.Tensor:
    """Metadata-owner routing (file or directory key) per-request mode.

    Mode 1 → client-local; Mode 2 → hash into the md-server subset;
    Modes 3/4 → hash over all nodes.
    """
    kh = key_hash.to(torch.int32)
    local = torch.broadcast_to(client_rank, kh.shape).to(torch.int32)
    central = (kh % n_md_servers).to(torch.int32)
    hashed = (kh % n_nodes).to(torch.int32)
    return torch.where(mode == LayoutMode.NODE_LOCAL, local,
                       torch.where(mode == LayoutMode.CENTRAL_META, central,
                                   hashed))
