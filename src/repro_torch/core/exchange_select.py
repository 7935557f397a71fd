"""Per-call dense/compacted pick from measured crossover data (twin of
``repro.core.exchange_select``).

``BBClient(exchange="auto")`` asks ``pick_backend`` per call shape.  The
pick is the reference's, computed from the same committed artifacts at the
repository root: the dense/compacted winner table of the benchmark sweep
(``BENCH_pr3.json``, falling back to ``BENCH_pr2.json``, falling back to
a baked-in table) and the affine fabric model fit from the mesh
all_to_all timings (``BENCH_pr5.json`` …), which together fit a decision
stump on the modeled dense-excess wire time.  So ``auto`` picks the plane
the reference picks, on any machine.  Both planes are exact, so a pick
costs time, never correctness; a crossover measured on the card is not
here yet (ROADMAP Queue 1 item 3).

Each load and pick emits an audit record (``record_decision``) as the
reference's does: ``crossover_load`` / ``crossover_fallback``,
``fabric_load`` / ``fabric_fallback`` once per cache fill, and one
``exchange_backend`` record per pick.
"""
from __future__ import annotations

import json
import math
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.obs import record_decision

#: benchmark artifacts searched for crossover rows, newest first
BENCH_FILES = ("BENCH_pr3.json", "BENCH_pr2.json")

#: benchmark artifacts searched for mesh-fabric all_to_all timings
FABRIC_FILES = ("BENCH_pr5.json", "BENCH_pr4.json", "BENCH_pr3.json")

#: analytic fallback fabric model when no measured rows exist:
#: (per-collective overhead µs, bytes per µs)
FALLBACK_FABRIC = (50.0, 500.0)

#: (n_nodes, batch, words, winner): the JAX package's ``FALLBACK_TABLE``,
#: used when no benchmark JSON is on disk
FALLBACK_TABLE = (
    (4, 8, 8, "dense"),
    (4, 16, 8, "dense"),
    (8, 16, 8, "dense"),
    (8, 64, 16, "compacted"),
    (16, 64, 16, "compacted"),
    (32, 64, 16, "compacted"),
    (64, 128, 16, "compacted"),
)


def round_us(row: Dict) -> float:
    """One full client round (write + read + stat) of a benchmark row, µs."""
    return row["write_us"] + row["read_us"] + row["stat_us"]


def _well_formed(row) -> bool:
    """True when a bench row carries every field the crossover needs;
    malformed rows are skipped, never fatal."""
    if not isinstance(row, dict):
        return False
    try:
        int(row["n_nodes"]), int(row["batch"]), int(row["words"])
        float(round_us(row))
    except (KeyError, TypeError, ValueError):
        return False
    return row.get("backend") in ("dense", "compacted")


def crossover_table(rows: Sequence[Dict]
                    ) -> Tuple[Tuple[int, int, int, str], ...]:
    """Reduce benchmark rows to ((n, q, w, winner), …) crossover cells:
    rows paired by (n_nodes, batch, words), a cell kept only when both
    backends were measured, its winner the one with the lower
    write+read+stat round time."""
    by: Dict[Tuple[int, int, int], Dict[str, Dict]] = {}
    for r in rows:
        if not _well_formed(r):
            continue
        key = (int(r["n_nodes"]), int(r["batch"]), int(r["words"]))
        by.setdefault(key, {})[r["backend"]] = r
    out = []
    for (n, q, w), pair in sorted(by.items()):
        if "dense" in pair and "compacted" in pair:
            winner = ("dense" if round_us(pair["dense"]) <=
                      round_us(pair["compacted"]) else "compacted")
            out.append((n, q, w, winner))
    return tuple(out)


def _bench_roots() -> Tuple[Path, ...]:
    # the repository root (src/repro_torch/core → repo) only, as in the
    # reference: never the working directory, which would make the pick
    # depend on where the process was started
    return (Path(__file__).resolve().parents[3],)


@lru_cache(maxsize=8)
def load_crossover(root: Optional[str] = None
                   ) -> Tuple[Tuple[int, int, int, str], ...]:
    """The newest committed benchmark sweep as a crossover table.

    Searches ``root`` (or the repository root) for ``BENCH_FILES`` in
    order and reduces the first parseable one via ``crossover_table``;
    ``FALLBACK_TABLE`` when nothing usable is on disk.  Cached per process.
    """
    roots = (Path(root),) if root is not None else _bench_roots()
    seen = []
    for r in roots:
        for name in BENCH_FILES:
            p = r / name
            if not p.is_file():
                continue
            seen.append(name)
            try:
                data = json.loads(p.read_text())
                rows = data.get("rows", []) if isinstance(data, dict) else []
            except (OSError, ValueError):
                continue
            table = crossover_table(rows)
            if table:
                record_decision(
                    "crossover_load", name,
                    inputs={"cells": len(table), "root": str(r)},
                    evidence={"grade": "measured", "source": name})
                return table
    record_decision(
        "crossover_fallback", "fallback_table",
        inputs={"reason": "malformed" if seen else "missing",
                "searched": list(BENCH_FILES), "artifacts_seen": seen,
                "roots": [str(r) for r in roots]},
        evidence={"grade": "fallback", "source": "FALLBACK_TABLE"})
    return FALLBACK_TABLE


def refresh() -> None:
    """Drop the cached crossover and fabric tables so the next pick
    re-reads disk."""
    load_crossover.cache_clear()
    fabric_model.cache_clear()
    _stump_threshold.cache_clear()


def _fit_fabric(rows: Sequence[Dict]) -> Optional[Tuple[float, float]]:
    """Least-squares (overhead µs, bytes/µs) fit ``us = a + bytes / bw`` of
    measured fabric rows; None with fewer than 2 well-formed rows of
    distinct sizes or a non-positive bandwidth."""
    pts = []
    for r in rows:
        if not isinstance(r, dict):
            continue
        try:
            us, nbytes = float(r["us_per_call"]), float(r["exchanged_bytes"])
        except (KeyError, TypeError, ValueError):
            continue
        if us > 0 and nbytes > 0:
            pts.append((nbytes, us))
    if len(pts) < 2 or len({b for b, _ in pts}) < 2:
        return None
    n = len(pts)
    sx = sum(b for b, _ in pts)
    sy = sum(u for _, u in pts)
    sxx = sum(b * b for b, _ in pts)
    sxy = sum(b * u for b, u in pts)
    denom = n * sxx - sx * sx
    slope = (n * sxy - sx * sy) / denom          # µs per byte
    a = (sy - slope * sx) / n                    # per-call overhead µs
    if slope <= 0:
        return None
    return max(a, 0.0), 1.0 / slope


@lru_cache(maxsize=8)
def fabric_model(root: Optional[str] = None) -> Tuple[float, float, bool]:
    """(overhead µs, bytes/µs, measured?) of the deployment's collectives:
    fit from the newest committed artifact carrying a ``fabric`` section,
    else the analytic ``FALLBACK_FABRIC`` with ``measured? = False``.
    Cached per process."""
    roots = (Path(root),) if root is not None else _bench_roots()
    seen = []
    for r in roots:
        for name in FABRIC_FILES:
            p = r / name
            if not p.is_file():
                continue
            seen.append(name)
            try:
                data = json.loads(p.read_text())
            except (OSError, ValueError):
                continue
            fab = data.get("fabric") if isinstance(data, dict) else None
            rows = fab.get("rows") if isinstance(fab, dict) else None
            fit = _fit_fabric(rows) if isinstance(rows, list) else None
            if fit is not None:
                record_decision(
                    "fabric_load", name,
                    inputs={"a_us": fit[0], "bytes_per_us": fit[1],
                            "root": str(r)},
                    evidence={"grade": "measured", "source": name})
                return fit[0], fit[1], True
    record_decision(
        "fabric_fallback", "analytic",
        inputs={"reason": "malformed" if seen else "missing",
                "searched": list(FABRIC_FILES), "artifacts_seen": seen,
                "a_us": FALLBACK_FABRIC[0],
                "bytes_per_us": FALLBACK_FABRIC[1]},
        evidence={"grade": "fallback", "source": "FALLBACK_FABRIC"})
    return FALLBACK_FABRIC[0], FALLBACK_FABRIC[1], False


def collective_us(nbytes: int, model: Optional[Tuple] = None) -> float:
    """Modeled wall time of one collective carrying ``nbytes`` bytes."""
    model = model if model is not None else fabric_model()
    a, bw = model[0], model[1]
    return a + nbytes / max(bw, 1e-9)


def auto_accuracy(table) -> Optional[float]:
    """Leave-one-out accuracy of ``pick_backend`` on a crossover table
    (each cell predicted from the table without it); None for fewer than
    2 cells."""
    if len(table) < 2:
        return None
    hits = sum(
        pick_backend(n, q, w, table[:i] + table[i + 1:]) == win
        for i, (n, q, w, win) in enumerate(table))
    return hits / len(table)


def _dense_excess_us(n_nodes: int, q: int, words: int, bw: float) -> float:
    """Modeled wire time the dense broadcast wastes against a routed
    exchange: (N² − N)·q rows of 4·(words + 3) bytes at the fabric's
    bandwidth, the feature the crossover stump splits on."""
    return max(n_nodes * n_nodes - n_nodes, 0) * q * 4 * (words + 3) \
        / max(bw, 1e-9)


@lru_cache(maxsize=8)
def _stump_threshold(table: Tuple, bw: float) -> Optional[float]:
    """The crossover stump's split point in dense-excess µs: the geometric
    mean of the gap between the largest dense cell and the smallest
    compacted one; None when the table has one winner or the two
    interleave."""
    dense, comp = [], []
    for n, q, w, winner in table:
        (dense if winner == "dense" else comp).append(
            _dense_excess_us(n, q, w, bw))
    if not dense or not comp:
        return None
    lo, hi = max(dense), min(comp)
    if lo <= 0 or lo >= hi:
        return None
    return math.sqrt(lo * hi)


def pick_backend(n_nodes: int, q: int, words: int,
                 table: Optional[Tuple] = None) -> str:
    """"dense" or "compacted" for one call shape (N, q, words).

    With no ``table``: the measured winner table and fabric model fit a
    stump on the modeled dense-excess time, which decides.  When the stump
    cannot be fit, or with an explicit ``table`` (the leave-one-out
    harness passes one), the winner of the nearest table cell in
    log-(N, q, words) space.

    Every pick emits an ``exchange_backend`` audit record naming the
    deciding ``oracle`` ("fabric_model" or "nearest_cell"); its
    alternatives carry the nearest-cell log-space distance of each losing
    backend.
    """
    explicit = table is not None
    table = table if explicit else load_crossover()
    oracle, choice, stump = "nearest_cell", None, {}
    if not explicit:
        model = fabric_model()
        thr = _stump_threshold(table, model[1])
        if thr is not None:
            excess = _dense_excess_us(n_nodes, q, words, model[1])
            choice = "compacted" if excess > thr else "dense"
            oracle = "fabric_model"
            stump = {"excess_us": excess, "threshold_us": thr,
                     "fabric_measured": bool(model[2])}
    best, best_d = "compacted", None
    near: Dict[str, float] = {}
    for ni, qi, wi, winner in table:
        d = (math.log(max(n_nodes, 1) / ni) ** 2 +
             math.log(max(q, 1) / qi) ** 2 +
             math.log(max(words, 1) / wi) ** 2)
        if winner not in near or d < near[winner]:
            near[winner] = d
        if best_d is None or d < best_d:
            best, best_d = winner, d
    if choice is None:
        choice = best
    record_decision(
        "exchange_backend", choice,
        inputs={"n_nodes": int(n_nodes), "q": int(q), "words": int(words),
                "table_cells": len(table),
                "distance": best_d if best_d is not None else -1.0,
                **stump},
        alternatives={k: v for k, v in near.items() if k != choice},
        evidence={"grade": ("fallback" if table is FALLBACK_TABLE
                            else "measured"),
                  "source": "crossover_table", "oracle": oracle})
    return choice
