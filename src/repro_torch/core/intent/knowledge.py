"""Domain knowledge base (Fig. 4): mode-level + application-level entries.

A copy of ``repro.core.intent.knowledge``;
the port imports nothing of the reference.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.layouts import LayoutMode

# ---------------------------------------------------------------------------
# mode-level architectural knowledge
# ---------------------------------------------------------------------------
MODE_INFO: Dict[LayoutMode, str] = {
    LayoutMode.NODE_LOCAL: (
        "Mode 1 (Node-Local Storage): all data and metadata routing resolves "
        "to localhost; the RPC stack is bypassed entirely. Maximizes write "
        "bandwidth for independent N-N workloads (checkpoint bursts). "
        "STRUCTURAL WEAKNESS: data written by one node is invisible to "
        "others without a broadcast search — any shared read, cross-rank "
        "stat, or shared-directory operation collapses. Never select for "
        "N-1 or read-shared workloads."),
    LayoutMode.CENTRAL_META: (
        "Mode 2 (Centralized Metadata): file metadata is owned by a "
        "dedicated server subset (hash(path) mod |S_md|); data remains "
        "distributed. Provides a strongly consistent global namespace, the "
        "most stable tail latency (single-point arbitration), cheap removes "
        "and directory traversals. Best for metadata storms on shared or "
        "deep namespaces, N-1 shared-file contention, and latency-critical "
        "small I/O. Weak at pure N-N write bandwidth."),
    LayoutMode.DIST_HASH: (
        "Mode 3 (Distributed Hashing): data chunks and metadata are "
        "consistent-hashed over all nodes (GekkoFS-style). Coordination-free "
        "placement, near-linear scaling for unstructured/random access, the "
        "robust fail-safe default. Weak when locality matters (sequential "
        "bursts pay full network cost) and when many clients hit one "
        "directory (the hashed owner becomes a lock hotspot)."),
    LayoutMode.HYBRID: (
        "Mode 4 (Hybrid): writes land on the local node (pathhost cache) "
        "while file metadata is hashed globally and records a "
        "data_location_rank for transparent read redirection. Combines "
        "near-local write bandwidth with a globally visible namespace: "
        "ideal for write-then-shared-read workflows, N-1 write bursts "
        "(local slabs + global index), and create-heavy metadata (local "
        "buffering). Jitter grows with scale under small random I/O."),
}

# ---------------------------------------------------------------------------
# application-level semantics (middleware/benchmark priors)
# ---------------------------------------------------------------------------
APP_INFO: Dict[str, str] = {
    "IOR": ("IOR: synthetic bandwidth benchmark. '-F' = file-per-process "
            "(independent N-N); '-c'/MPIIO = collective shared file (N-1); "
            "'-t' transfer size; '-s' segments (small segmented I/O); "
            "write phases are checkpoint-like, read phases restart-like."),
    "FIO": ("fio: flexible I/O tester. 'filename=' fixed → shared file; "
            "'filename_format=$jobnum' → file per process; 'rw=randrw' + "
            "'rwmixread' = mixed random; 'nrfiles' large = small-file/AI "
            "metadata workload; checkpoint jobs are sequential writes."),
    "HACC": ("HACC-IO: cosmology checkpoint/restart kernel. Writes are "
             "bursty N-1 collective slab writes to one restart file; the "
             "file is re-read later for analysis/restart, so written data "
             "IS re-read by other ranks across phases."),
    "MAD": ("MADbench2: out-of-core matrix benchmark. W phase writes large "
            "matrices (collective shared or unique streams); written data "
            "is re-read in later phases (S/C), so write bursts are followed "
            "by cross-rank reads; S phase mixes small tiles with metadata."),
    "MDTEST": ("mdtest: pure metadata benchmark (create/stat/remove). "
               "'-u' = unique dir per rank; '-z' = deep tree; '-N' = stats "
               "offset to ANOTHER rank's files (cross-rank); '-C -T' = "
               "separate create and stat phases. Create throughput "
               "benefits from local buffering when dirs are unique."),
    "S3D": ("S3D-IO: combustion checkpoint kernel. N-N field dumps with "
            "neighbor-halo validation reads after the burst; restart reads "
            "the full dump set globally; thermo-table updates are tiny "
            "latency-critical records."),
}


def app_expects_reread(app: str) -> bool:
    """App-level prior: written data is re-read (possibly by other ranks)."""
    return app in ("HACC", "MAD", "S3D")


def app_create_buffering(app: str) -> bool:
    """App-level prior: create-heavy metadata that benefits from local
    buffering (write-back creates)."""
    return app in ("MDTEST", "FIO")


def mode_info_text() -> str:
    """All four mode-knowledge cards as one prompt bullet list."""
    return "\n".join(f"- {v}" for v in MODE_INFO.values())


def app_info_text(app: str) -> str:
    """Application-reference card for ``app`` (or a placeholder)."""
    return APP_INFO.get(app, "(no application-level reference available)")
