"""Plain PyTorch versions of the send-order gather (the kernel's oracles)."""
from __future__ import annotations

import torch


def pack_chunks_ref(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(n, w) payload × (m,) row ids → (m, w); ``-1`` rows come back zero."""
    if payload.shape[0] == 0:
        return payload.new_zeros((idx.shape[0],) + payload.shape[1:])
    out = payload.index_select(0, idx.clamp(min=0).long())
    return out.masked_fill_((idx < 0)[:, None], 0)


def gather_rows_batched_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-batched oracle of ``ops.gather_rows_batched``: a per-row take with
    the same sentinel semantics and no flattening — pins the rebase
    arithmetic of the batched entry point."""
    L = x.shape[0]
    rows = torch.arange(L, device=x.device)[:, None]
    out = x[rows, idx.clamp(min=0).long()]
    mask = (idx < 0).reshape(idx.shape + (1,) * (x.dim() - 2))
    return out.masked_fill_(mask, 0)
