"""Per-scope runtime intent telemetry: production traffic as the probe
(twin of ``repro.core.adapt.telemetry``).

The request batches the client already routes carry the behavioral
signals the intent probe measures before a job runs.  This module folds
them into a small dense ``(n_scopes, N_FEATURES)`` float32 tensor on the
client's device with a handful of tensor operations per client call — no
Python per-request work, no second pass over payloads — keyed by the
policy's scope hashes (row 0 is the default/unscoped bucket).

Raw counters (columns of the dense tensor):

====  ===========================================================
col   meaning
====  ===========================================================
0     write requests
1     read requests
2     metadata ops
3     payload words written
4     payload words read
5     self-affine reads (chunk previously written by this row)
6     routed data requests (write+read denominators)
7     sequential adjacent pairs (same path, chunk_id + 1)
8     adjacent same-path pairs (seq denominator)
9     expected requests beyond the uniform auto budget (pressure)
10    max chunk_id + 1 seen (file-extent proxy)
11-14 chunk-id log2 histogram bins (<1, <4, <16, ≥16)
====  ===========================================================

The reference scatter-adds each request into its row.  On the card a
scatter-add (``index_add_``) applies float additions in the order the
atomics arrive, so a sum of fractions (column 9) would change from run to
run, and the drift detector fires on thresholds.  Here every column of a
call is one masked sum per scope row over the call's requests, in a fixed
order: one stream gives the same counters on every run.  The
integer-valued columns equal the reference's exactly (float32 is exact on
them below 2²⁴, and on the word counts, multiples of the chunk width, far
above); column 9 differs from the reference's sequential float32 sum by
rounding only.  The pressure histogram is ``histogram_rows2d``, the
counts-only ``dest_histogram2d`` kernel on the card.

The derived **signature** (``SIG_NAMES``) is the 6-dim normalized vector
the drift detector and the re-decision pipeline consume: read share, meta
share, locality (self-affinity), sequentiality, budget pressure and file
extent — each in [0, 1].  ``signature_from_stats`` /
``signature_from_phases`` express a decision-time probe (``RuntimeStats``)
or a workload phase list in the same space.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.exchange_plan import _auto_budget
from repro_torch.core.layouts import str_hash
from repro_torch.core.policy import SCOPE_NONE, LayoutPolicy, as_policy
from repro_torch.kernels.chunk_router.ops import histogram_rows2d

# raw feature columns
F_WRITES, F_READS, F_META = 0, 1, 2
F_WORDS_W, F_WORDS_R = 3, 4
F_SELF, F_ROUTED = 5, 6
F_SEQ, F_PAIRS = 7, 8
F_PRESSURE = 9
F_EXTENT_MAX = 10
F_EXT0 = 11
N_EXT_BINS = 4
N_FEATURES = F_EXT0 + N_EXT_BINS

#: derived signature dimensions, in order
SIG_NAMES = ("read_share", "meta_share", "locality", "seq", "pressure",
             "extent")

DEFAULT_SCOPE = "<default>"

F32 = torch.float32


def _rows_of(scope_hash: torch.Tensor, table: Tuple[int, ...]
             ) -> torch.Tensor:
    """scope_hash → telemetry row; unmatched hashes (and ``SCOPE_NONE``)
    land in the default row 0."""
    sh = scope_hash.to(torch.int32)
    rows = torch.zeros(sh.shape, dtype=torch.int64, device=sh.device)
    for i, h in enumerate(table):
        rows = torch.where(sh == h, i + 1, rows)
    return rows


def _accumulate(counts: torch.Tensor, scope_hash, path_hash, chunk_id,
                dest, self_hint, valid, *, kind: str, words: int,
                table: Tuple[int, ...], n_nodes: int, capacity: float,
                per_node: bool = False) -> torch.Tensor:
    """One telemetry update for one client call; returns the new counters.

    ``counts`` is (S, F), or with ``per_node`` (L, S, F), each source row
    adding into its own node's slice.  Every added column is one masked
    sum per counter row over the call's (L, q) requests in a fixed order
    (deterministic on the card, see the module docstring); the extent
    maximum is a masked max.  Adjacent-pair counters (columns 7-8) sit at
    the pair's second slot, under that slot's scope, as in the reference.
    """
    L, q = path_hash.shape
    S = len(table) + 1
    dev = counts.device
    rows = _rows_of(scope_hash, table)                        # (L, q)
    if per_node:
        rows = rows + S * torch.arange(L, device=dev)[:, None]
    K = counts.numel() // N_FEATURES
    onehot = rows.reshape(1, -1) == torch.arange(K, device=dev)[:, None]
    v = valid.to(F32)
    add = {{"write": F_WRITES, "read": F_READS, "meta": F_META}[kind]: v}
    if kind != "meta":
        add[F_WORDS_W if kind == "write" else F_WORDS_R] = v * words
        add[F_ROUTED] = v
        if kind == "read":
            add[F_SELF] = v * self_hint.to(F32)
        # stride signature: adjacent same-path chunk-id+1 pairs per row
        pair = (path_hash[:, 1:] == path_hash[:, :-1]) & valid[:, 1:] & \
            valid[:, :-1]
        seq = pair & (chunk_id[:, 1:] == chunk_id[:, :-1] + 1)
        lead = torch.zeros((L, min(q, 1)), dtype=F32, device=dev)
        add[F_PAIRS] = torch.cat([lead, pair.to(F32)], dim=1)
        add[F_SEQ] = torch.cat([lead, seq.to(F32)], dim=1)
        ext_bin = torch.where(chunk_id < 1, 0, torch.where(
            chunk_id < 4, 1, torch.where(chunk_id < 16, 2, 3)))
        for b in range(N_EXT_BINS):
            add[F_EXT0 + b] = v * (ext_bin == b).to(F32)
    # budget pressure: expected share of each request beyond the uniform
    # auto budget its destination would get
    d = torch.where(valid, dest.to(torch.int32), n_nodes).to(torch.int32)
    hist = histogram_rows2d(d.contiguous(), n_bins=n_nodes + 1)[:, :n_nodes]
    budget = _auto_budget(q, n_nodes, capacity)
    over = torch.clamp(hist - budget, min=0) / torch.clamp(hist, min=1)
    per_req = torch.gather(over, 1, torch.clamp(
        dest.to(torch.int64), 0, n_nodes - 1))
    add[F_PRESSURE] = v * per_req
    # every column of the call as one (F, L·q) stack (zeros where the call
    # adds nothing), so one masked sum adds them all without an index
    zero = torch.zeros(L * q, dtype=F32, device=dev)
    stacked = torch.stack([add[c].reshape(-1) if c in add else zero
                           for c in range(N_FEATURES)])
    sums = torch.where(onehot[:, None, :], stacked[None], 0.0).sum(dim=2)
    flat = counts.reshape(K, N_FEATURES) + sums
    if kind != "meta" and q > 0:
        ext = torch.where(valid, chunk_id + 1, 0).to(F32).reshape(1, -1)
        top = torch.where(onehot, ext, 0.0).amax(dim=1)
        flat[:, F_EXTENT_MAX] = torch.maximum(flat[:, F_EXTENT_MAX], top)
    return flat.reshape(counts.shape)


class ScopeTelemetry:
    """Dense per-scope counters + the scope-hash registry behind them.

    One instance rides on a ``BBClient`` (``telemetry=True``); the client
    calls :meth:`record` from its write/read/meta entry points and the
    adaptation controller snapshots/diffs :attr:`counts` per tick.
    """

    def __init__(self, policy, per_node: int = 0, device=None,
                 reduce=None):
        """Build rows for the policy's scopes (+ the default row 0), on
        ``device`` (CUDA unless given).

        ``per_node`` > 0 keeps one counter slice per node — shape
        (per_node, S, F), each request row adding into its own node's
        slice — the layout a mesh client keeps for its rank's rows.
        ``reduce`` (the mesh's ``build_telemetry_reduce``) sums such
        counters over every rank.  ``snapshot``/``signatures`` always
        present the reduced (S, F) view.
        """
        policy = as_policy(policy)
        self.device = resolve_device(device)
        self.reduce = reduce
        self.scope_names = (DEFAULT_SCOPE,) + tuple(
            s for s, _ in policy.scopes)
        self.table: Tuple[int, ...] = tuple(
            str_hash(s) for s, _ in policy.scopes)
        self.per_node = int(per_node)
        shape = (len(self.table) + 1, N_FEATURES)
        if self.per_node:
            shape = (self.per_node,) + shape
        self.counts = torch.zeros(shape, dtype=F32, device=self.device)

    def rebind(self, policy: LayoutPolicy) -> None:
        """Follow a policy swap: keep counters of scopes that survive.

        Rows are matched by scope *hash*; scopes present in both policies
        keep their history (a mode change does not reset the signal),
        vanished scopes are dropped, new scopes start at zero.
        """
        policy = as_policy(policy)
        new = ScopeTelemetry(policy, per_node=self.per_node,
                             device=self.device, reduce=self.reduce)
        old_rows = {h: i + 1 for i, h in enumerate(self.table)}
        src = [0] + [old_rows.get(h, -1) for h in new.table]
        keep = torch.as_tensor([i >= 0 for i in src], device=self.device)
        pick = torch.as_tensor([max(i, 0) for i in src], device=self.device)
        moved = self.counts.index_select(self.counts.dim() - 2, pick)
        self.scope_names = new.scope_names
        self.table = new.table
        self.counts = torch.where(keep[:, None], moved, new.counts)

    def row_of(self, scope: str) -> int:
        """Telemetry row index of a scope name (0 for the default row)."""
        try:
            return self.scope_names.index(scope)
        except ValueError:
            return 0

    def record(self, kind: str, scope_hash, path_hash, chunk_id, dest,
               valid, *, words: int = 0,
               self_hint: Optional[torch.Tensor] = None,
               n_nodes: int = 1, capacity: float = 2.0) -> None:
        """Fold one client call into the counters (on their device).

        ``capacity`` is the client's uniform-budget headroom factor
        (``ExchangeConfig.capacity``): the pressure counter measures
        overflow against the budgets the data plane actually uses.
        """
        shape, dev = path_hash.shape, self.device
        sh = (torch.full(shape, SCOPE_NONE, dtype=torch.int32, device=dev)
              if scope_hash is None else scope_hash)
        hint = (torch.zeros(shape, dtype=torch.bool, device=dev)
                if self_hint is None else self_hint.to(torch.bool))
        self.counts = _accumulate(
            self.counts, sh, path_hash.to(torch.int32),
            chunk_id.to(torch.int32), dest, hint, valid.to(torch.bool),
            kind=kind, words=int(words), table=self.table,
            n_nodes=int(n_nodes), capacity=float(capacity),
            per_node=bool(self.per_node))

    def snapshot(self) -> np.ndarray:
        """Host copy of the (S, F) counter view (controller bookkeeping);
        a per-node layout is summed over its node axis, over every rank of
        a mesh (``reduce``), so every rank reads the same counters."""
        if self.reduce is not None:
            return self.reduce(self.counts).cpu().numpy().copy()
        c = self.counts.cpu().numpy()
        return (c.sum(axis=0) if self.per_node else c).copy()

    def suggest_align(self, q: int) -> int:
        """Ragged-budget quantization step seeded from live extent.

        The step doubles per extent-histogram band (8, 16, 32), clamped to
        ``q // 2``, so scopes the live extent histogram shows writing long
        files converge to fewer distinct specs; with too little signal
        (< 64 routed requests) the default 8 stands.
        """
        row = self.snapshot().sum(axis=0)
        ext = row[F_EXT0:F_EXT0 + N_EXT_BINS]
        tot = float(ext.sum())
        if tot < 64:
            return 8
        mean_bin = float((ext * np.arange(N_EXT_BINS)).sum() / tot)
        step = 8 * (2 ** int(min(2, max(0, round(mean_bin - 0.5)))))
        return int(max(8, min(step, max(8, q // 2))))

    def signatures(self, since: Optional[np.ndarray] = None
                   ) -> Dict[str, Tuple[np.ndarray, float]]:
        """Per-scope (signature, op-volume weight) since a snapshot."""
        cur = self.snapshot()
        delta = cur - since if since is not None else cur
        out = {}
        for i, name in enumerate(self.scope_names):
            row = delta[i]
            w = float(row[F_WRITES] + row[F_READS] + row[F_META])
            if w > 0:
                out[name] = (signature_of_row(row), w)
        return out


def signature_of_row(row: np.ndarray) -> np.ndarray:
    """Derive the 6-dim normalized signature from one raw counter row."""
    row = np.asarray(row, np.float64)
    writes, reads, meta = row[F_WRITES], row[F_READS], row[F_META]
    data = writes + reads
    read_share = reads / max(data, 1.0)
    meta_share = meta / max(meta + data, 1.0)
    locality = (row[F_SELF] / max(reads, 1.0)) if reads else 1.0
    seq = row[F_SEQ] / max(row[F_PAIRS], 1.0)
    pressure = min(1.0, row[F_PRESSURE] / max(row[F_ROUTED], 1.0))
    ext = row[F_EXT0:F_EXT0 + N_EXT_BINS]
    tot = ext.sum()
    extent = float((ext * np.arange(N_EXT_BINS)).sum() /
                   max(tot, 1.0) / (N_EXT_BINS - 1))
    return np.array([read_share, meta_share, locality, seq, pressure,
                     extent], np.float64)


def signature_from_stats(rs) -> np.ndarray:
    """A probe's ``RuntimeStats`` in signature space (decision baseline).

    Pressure has no probe-side counter (it is a data-plane artifact), so
    it maps to 0; extent maps to the neutral midpoint — the drift config's
    default weights de-emphasize both accordingly.
    """
    reads = max(rs.posix_reads, 1)
    locality = 1.0 - min(1.0, rs.cross_rank_ops / reads)
    return np.array([rs.read_ratio, rs.meta_share, locality,
                     rs.posix_seq_ratio, 0.0, 0.5], np.float64)


def signature_from_phases(phases) -> np.ndarray:
    """A workload phase list in signature space (oracle baseline)."""
    wr = rd = meta = cross = rdw = seqw = totw = 0.0
    for p in phases:
        if p.kind == "bw":
            n = max(1.0, p.total_mib / max(p.req_kib / 1024.0, 1e-6))
            if p.op == "write":
                wr += n
            else:
                rd += n
                if p.written_by in ("other", "shared"):
                    cross += n
                rdw += n
            seqw += n * (1.0 if p.pattern in ("seq", "strided") else 0.0)
            totw += n
        elif p.kind == "iops":
            rr = p.read_ratio if p.op == "mixed" else \
                (1.0 if p.op == "read" else 0.0)
            rd += p.n_ops * rr
            wr += p.n_ops * (1 - rr)
            if p.written_by in ("other", "shared"):
                cross += p.n_ops * rr
            rdw += p.n_ops * rr
            seqw += 0.0
            totw += p.n_ops
        else:
            meta += p.n_ops
    data = wr + rd
    return np.array([
        rd / max(data, 1.0),
        meta / max(meta + data, 1.0),
        1.0 - cross / max(rdw, 1.0),
        seqw / max(totw, 1.0),
        0.0, 0.5], np.float64)
