"""Plain PyTorch versions of the routing kernels (the kernels' oracles)."""
from __future__ import annotations

import torch

_MASK31 = 0x7FFFFFFF


def dest_histogram_ref(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """(n,) destinations → (n_bins,) int32 counts: a bincount of the values
    in [0, n_bins); the rest (the -1 sentinel, values past the last bin)
    go to one extra bin that is dropped."""
    inb = (dest >= 0) & (dest < n_bins)
    idx = torch.where(inb, dest, n_bins).long()
    return torch.bincount(idx, minlength=n_bins + 1)[:n_bins].to(torch.int32)


def dest_histogram2d_ref(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """(L, q) destinations → (L, n_bins) int32 per-row counts.

    One-hot reduction over the slot axis; values outside [0, n_bins) match
    no bin (the exchange plan's invalid-request sentinel).
    """
    bins = torch.arange(n_bins, dtype=dest.dtype, device=dest.device)
    return (dest[..., None] == bins).sum(dim=1, dtype=torch.int32)


def _sentinel_dest(dest: torch.Tensor, valid: torch.Tensor,
                   n_nodes: int) -> torch.Tensor:
    """Destinations with invalid slots, and slots routed outside
    [0, n_nodes), moved to the sentinel bin ``n_nodes``."""
    keep = valid & (dest >= 0) & (dest < n_nodes)
    return torch.where(keep, dest, n_nodes).to(torch.int32)


def route_plan_ref(dest: torch.Tensor, valid: torch.Tensor,
                   table: torch.Tensor, *, total: int):
    """Plain version of ``route_plan``: (L, q) destinations and validity,
    (2, N) budget/offset table → (send_idx (L, total), reply_idx (L, q),
    overflow (L,), counts (L, N)) int32.

    The reference planner's stable destination sort: sorted position p of
    a row holds request ``order[p]``; its rank in its destination's run is
    p − start[d], with start the exclusive cumsum of the row's counts.
    Send column ``offset[d] + k`` takes the request of rank k while
    k < counts[d] (budget columns past it: -1); a request's reply column
    is ``offset[d] + rank`` while rank < budget[d], else -1.
    """
    n = table.shape[1]
    L, q = dest.shape
    dev = dest.device
    budget, offset = table.to(torch.int64).unbind(0)
    d = _sentinel_dest(dest, valid, n)
    order = torch.argsort(d, dim=1, stable=True)
    sd = torch.gather(d, 1, order).long()
    counts = dest_histogram2d_ref(d, n_bins=n)
    start = torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    if q:
        dcol = torch.repeat_interleave(torch.arange(n, device=dev), budget,
                                       output_size=total)
        jcol = torch.arange(total, device=dev) - offset[dcol]
        pos = (start[:, dcol] + jcol[None, :]).clamp(0, q - 1)
        src = torch.gather(order, 1, pos)
        send_idx = torch.where(jcol[None, :] < counts[:, dcol], src,
                               -1).to(torch.int32)
    else:
        send_idx = torch.full((L, total), -1, dtype=torch.int32, device=dev)
    overflow = (counts - torch.minimum(counts, budget[None, :])).sum(
        dim=1, dtype=torch.int32)
    startx = torch.cat([start, start.new_zeros((L, 1))], dim=1)
    rank = torch.arange(q, device=dev)[None, :] - torch.gather(startx, 1, sd)
    bx = torch.cat([budget, budget.new_zeros(1)])
    ox = torch.cat([offset, offset.new_zeros(1)])
    slot = torch.where((sd < n) & (rank < bx[sd]), ox[sd] + rank,
                       -1).to(torch.int32)
    reply_idx = torch.zeros((L, q), dtype=torch.int32,
                            device=dev).scatter_(1, order, slot)
    return send_idx, reply_idx, overflow, counts


def dest_budgets_ref(dest: torch.Tensor, valid: torch.Tensor,
                     n_nodes: int) -> torch.Tensor:
    """Plain version of ``dest_budgets``: each destination's largest
    per-row count of valid requests, (n_nodes,) int32."""
    counts = dest_histogram2d_ref(_sentinel_dest(dest, valid, n_nodes),
                                  n_bins=n_nodes)
    if counts.shape[0] == 0:
        return counts.new_zeros(n_nodes)
    return counts.max(dim=0).values


def mix_hash_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The FNV-style mix of the reference's ``mix_hash_i32`` on int32
    tensors → non-negative int32.  The 31-bit mask after every step keeps
    the int64 product below 2⁵⁶, so its low 32 bits are the uint32
    product's."""
    h = 0x811C9DC5
    for part in (a, b):
        h = ((h ^ (part.to(torch.int64) & 0xFFFFFFFF)) * 16777619) & _MASK31
        h = h ^ (h >> 15)
    return (h & _MASK31).to(torch.int32)


def route_chunks_ref(path_hash: torch.Tensor, chunk_id: torch.Tensor,
                     client: torch.Tensor, *, mode: int, n_nodes: int):
    """(n,) descriptors → (dest (n,), counts (n_nodes,)) int32.

    Modes 1/4 → ``client``; otherwise the mix mod ``n_nodes``.  Counts are
    per destination; destinations outside [0, n_nodes) count nowhere.
    """
    if mode in (1, 4):
        dest = client.to(torch.int32)
    else:
        dest = (mix_hash_i32(path_hash, chunk_id) % n_nodes).to(torch.int32)
    counts = dest_histogram2d_ref(dest[None], n_bins=n_nodes)[0]
    return dest, counts


def route_chunks_segmented_ref(leaves: torch.Tensor, n_chunks: int, *,
                               n_nodes: int) -> torch.Tensor:
    """(L, 3) leaf table of rows (path_hash, mode, first chunk) →
    (n_chunks,) int32 destinations: chunk i of the concatenation routed as
    ``route_chunks_ref`` routes chunk id i − first of the last leaf whose
    first chunk is ≤ i, with client chunk id mod ``n_nodes``."""
    ph, mode, first = leaves.to(torch.int64).unbind(1)
    i = torch.arange(n_chunks, dtype=torch.int64, device=leaves.device)
    leaf = torch.searchsorted(first.contiguous(), i, right=True) - 1
    cid = (i - first[leaf]).to(torch.int32)
    client = cid % n_nodes
    hashed = mix_hash_i32(ph[leaf].to(torch.int32), cid) % n_nodes
    local = (mode[leaf] == 1) | (mode[leaf] == 4)
    return torch.where(local, client, hashed).to(torch.int32)
