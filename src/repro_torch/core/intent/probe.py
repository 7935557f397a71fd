"""Lightweight runtime probe (§III-C.a, dynamic side; a copy of
``repro.core.intent.probe`` whose engine replay runs on the port's client).

The paper uses a single Darshan-instrumented probe run — NOT a layout search:
it collects only behavioral summaries (read/write ratio, dominant request
size, metadata intensity, access regularity, shared-file activity).

Here the probe executes a 1%-scale trace of the workload through an
instrumented counter shim (optionally through the real in-memory BB engine —
``run_probe(..., through_engine=True)`` — which replays a miniature trace on
an 8-node stacked engine and counts actual operations).  Counters follow
Darshan's POSIX module naming.  The counters are host arithmetic (numpy,
as in the reference); only the replay's requests are tensors, on the
client's device: the card unless ``device`` names another.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


@dataclass
class RuntimeStats:
    """Darshan-style aggregate I/O counters from one probe run.

    Collected by replaying a few seconds of the workload against the
    probe engine; the reasoner consumes the derived ratios below.
    """
    posix_bytes_written: float = 0.0
    posix_bytes_read: float = 0.0
    posix_writes: int = 0
    posix_reads: int = 0
    posix_meta_ops: int = 0
    meta_mix: Dict[str, float] = field(default_factory=dict)
    posix_seq_ratio: float = 1.0
    dominant_req_kib: float = 0.0
    shared_file_ops: int = 0          # ops touching files opened by >1 rank
    cross_rank_ops: int = 0           # ops touching another rank's files
    unique_files: int = 0
    n_phases: int = 1

    @property
    def read_ratio(self) -> float:
        """Fraction of bytes moved by reads."""
        tot = self.posix_bytes_read + self.posix_bytes_written
        return self.posix_bytes_read / tot if tot else 0.0

    @property
    def meta_share(self) -> float:
        """Fraction of metadata ops among all POSIX calls."""
        data = self.posix_reads + self.posix_writes
        return self.posix_meta_ops / max(1, data + self.posix_meta_ops)

    def to_darshan_dict(self) -> Dict[str, object]:
        """Human-formatted counter dict (the prompt's runtime block)."""
        def _fmt_bytes(b):
            if b >= 1 << 30:
                return f"{b / (1 << 30):.1f}GB"
            if b >= 1 << 20:
                return f"{b / (1 << 20):.0f}MB"
            return f"{int(b)}B"
        return {
            "posix_bytes_written": _fmt_bytes(self.posix_bytes_written),
            "posix_bytes_read": _fmt_bytes(self.posix_bytes_read),
            "posix_meta_ops": int(self.posix_meta_ops),
            "posix_seq_access_ratio": round(self.posix_seq_ratio, 2),
            "dominant_req_kib": round(self.dominant_req_kib, 1),
            "read_ratio": round(self.read_ratio, 3),
            "meta_share": round(self.meta_share, 3),
            "shared_file_ops": int(self.shared_file_ops),
            "cross_rank_ops": int(self.cross_rank_ops),
            "n_phases": self.n_phases,
        }


PROBE_SCALE = 0.01   # single probe at 1% of the production volume


def run_probe(workload, seed: int = 0, scale: float = PROBE_SCALE,
              through_engine: bool = False, device=None) -> RuntimeStats:
    """Execute a scaled probe of the workload and collect counters.

    ``through_engine`` also replays a miniature trace through a
    ``BBClient`` on ``device`` (CUDA when omitted); the replay leaves the
    counters as they are.
    """
    rng = np.random.RandomState(seed + 17)
    rs = RuntimeStats()
    rs.n_phases = len(workload.phases)
    sizes = []
    seq_weight, tot_weight = 0.0, 0.0
    for ph in workload.phases:
        noise = 1.0 + rng.normal(0, 0.02)
        if ph.kind == "bw":
            mib = ph.total_mib * scale * noise
            nops = mib / (ph.req_kib / 1024.0)
            if ph.op == "write":
                rs.posix_bytes_written += mib * (1 << 20)
                rs.posix_writes += int(nops)
            else:
                rs.posix_bytes_read += mib * (1 << 20)
                rs.posix_reads += int(nops)
            rs.posix_meta_ops += int(nops * 0.02 + 2)
            sizes += [ph.req_kib] * max(1, int(nops))
            w = nops
            seq_weight += w * (1.0 if ph.pattern in ("seq", "strided") else 0.0)
            tot_weight += w
            if ph.topology == "N1":
                rs.shared_file_ops += int(nops)
            if ph.written_by in ("other", "shared"):
                rs.cross_rank_ops += int(nops)
            rs.unique_files += workload.n_nodes if ph.topology == "NN" else 1
        elif ph.kind == "iops":
            nops = ph.n_ops * scale * noise
            rr = ph.read_ratio if ph.op == "mixed" else \
                (1.0 if ph.op == "read" else 0.0)
            rs.posix_reads += int(nops * rr)
            rs.posix_writes += int(nops * (1 - rr))
            rs.posix_bytes_read += nops * rr * ph.req_kib * 1024
            rs.posix_bytes_written += nops * (1 - rr) * ph.req_kib * 1024
            rs.posix_meta_ops += int(nops * 0.01)
            sizes += [ph.req_kib] * max(1, int(nops))
            seq_weight += 0.0 if ph.pattern == "random" else \
                (0.3 * nops if ph.op == "mixed" else 0.0)
            tot_weight += nops
            if ph.written_by in ("other", "shared"):
                rs.cross_rank_ops += int(nops * rr)
            if ph.written_by == "shared":
                rs.shared_file_ops += int(nops)
        else:  # meta
            nops = ph.n_ops * scale * noise
            rs.posix_meta_ops += int(nops)
            for op, frac in (ph.meta_mix or {"create": 1.0}).items():
                rs.meta_mix[op] = rs.meta_mix.get(op, 0.0) + nops * frac
            if ph.dir_pattern == "shared":
                rs.shared_file_ops += int(nops * 0.5)
            if ph.cross_rank:
                rs.cross_rank_ops += int(nops * ph.cross_rank *
                                         ph.meta_mix.get("stat", 0.0))
            rs.unique_files += int(nops / workload.n_nodes)
    total = sum(rs.meta_mix.values())
    if total:
        rs.meta_mix = {k: v / total for k, v in rs.meta_mix.items()}
    rs.posix_seq_ratio = seq_weight / tot_weight if tot_weight else 1.0
    rs.dominant_req_kib = float(np.median(sizes)) if sizes else 0.0

    if through_engine:
        _engine_replay(workload, rs, device=device)
    return rs


def _engine_replay(workload, rs: RuntimeStats, n_nodes: int = 8,
                   q: int = 4, device=None) -> None:
    """Replay a miniature trace through the real stacked BB engine.

    Grounds the probe in actual engine execution: op counts from the shim
    must match what the data plane performs (checked in tests).  Reads of
    keys the trace never wrote come back not found, as in the reference.

    The replay takes the compacted exchange, the engine's main path with
    its routing and gather kernels.  At this shape the reference's
    ``exchange="auto"`` picks the dense plane, which gives the same
    tables and replies bit for bit (held call for call in the tests).
    """
    import torch

    from repro_torch.core.client import BBClient, BBRequest
    from repro_torch.core.layouts import LayoutMode
    from repro_torch.core.policy import LayoutPolicy

    client = BBClient(LayoutPolicy.uniform(LayoutMode.DIST_HASH, n_nodes),
                      device=device, cap=256, words=8, mcap=256,
                      exchange="compacted")

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.int32, device=client.device)

    rng = np.random.RandomState(3)
    for ph in workload.phases[:2]:
        req = BBRequest(
            path_hash=tensor(rng.randint(1, 1 << 20, (n_nodes, q))),
            chunk_id=tensor(rng.randint(0, 4, (n_nodes, q))),
            payload=tensor(rng.randint(0, 99, (n_nodes, q, 8))))
        if ph.kind in ("bw", "iops") and ph.op != "read":
            client.write(req)
        else:
            client.read(req)
