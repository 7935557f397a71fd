"""Engine entry points of the send-order gather: kernel on CUDA, plain
version on the CPU (the twin of ``repro.kernels.chunk_pack.ops``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.chunk_pack.chunk_pack import pack_chunks
from repro_torch.kernels.chunk_pack.ref import pack_chunks_ref


def gather_rows(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Send-order gather ``out[i] = payload[idx[i]]`` (``-1`` → zero row).

    A CUDA tensor goes through the ``pack_chunks`` kernel (or raises); a
    CPU tensor through the bit-identical plain version.
    """
    if payload.is_cuda:
        return pack_chunks(payload, idx)
    if payload.device.type == "cpu":
        return pack_chunks_ref(payload, idx)
    raise ValueError(f"gather_rows: unsupported device {payload.device}")


def gather_rows_batched(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-batched send-order gather: (L, q, ...) × (L, S) → (L, S, ...).

    ``idx`` holds per-row request slots (``-1`` → zero row).  The row batch
    becomes one ``gather_rows`` call — one kernel launch on the card — by
    rebasing each row's slots onto the flat (L·q, w) payload.
    """
    L, q = x.shape[:2]
    rest = tuple(x.shape[2:])
    base = (torch.arange(L, dtype=torch.int32, device=x.device) * q)[:, None]
    flat = torch.where(idx >= 0, idx + base, -1).to(torch.int32).reshape(-1)
    out = gather_rows(x.reshape(L * q, math.prod(rest)), flat)
    return out.reshape((L, idx.shape[1]) + rest)
