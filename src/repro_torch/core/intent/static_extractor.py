"""Static intent extraction from source code and job scripts (§III-C.a).

Two engines feed the same ``StaticFeatures`` record:

* the **AST engine** (``repro_torch.core.intent.staticlib``) — a real lexer /
  parser / CFG / dataflow pipeline for the C-like I/O kernels: rank-taint
  propagation decides topology and cross-rank reads, reaching-definition
  chains classify offset evolution, and dead branches are excluded;
* the **regex engine** (this module) — retained as the fallback for
  non-C inputs (fio ini jobs, batch scripts) and as a *differential
  oracle* the AST engine is tested against.

Every decided feature carries an ``Evidence`` record: the rule that
fired, its confidence tier, and the source call site.  Downstream
(``HybridContext``) merging is confidence-weighted — strong runtime
evidence can override weak (regex/default-tier) static hints but not
dataflow-proven ones.

Execution-intensity quantities (exact byte volumes, op ratios) are
intentionally NOT inferred here; they come from the runtime probe
(probe.py), per the paper's hybrid split.

A copy of ``repro.core.intent.static_extractor``;
the port imports nothing of the reference.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# confidence tiers: how trustworthy each extraction rule class is
TIER_CONFIDENCE: Dict[str, float] = {
    "ast-dataflow": 0.90,   # proven by taint / reaching-definitions
    "script": 0.85,         # explicit benchmark CLI flags
    "ast-struct": 0.80,     # AST structure (calls, loops, formats)
    "regex": 0.55,          # textual pattern match (comment-foolable)
    "default": 0.30,        # fill-in when nothing decided
}
DEFAULT_CONFIDENCE = TIER_CONFIDENCE["default"]


@dataclass(frozen=True)
class Evidence:
    """Provenance of one decided feature value.

    ``rule`` is a stable rule identifier (e.g. ``taint-name-self``),
    ``tier`` one of ``TIER_CONFIDENCE``, ``site`` the ``func:line`` (or
    artifact) the rule fired on, ``detail`` a human-readable clause.
    """
    field: str
    value: str
    rule: str
    tier: str
    confidence: float
    site: str = ""
    detail: str = ""


@dataclass
class StaticFeatures:
    """Source/script-derived I/O intent hints (no execution needed)."""
    # access topology
    topology_hint: str = "unknown"      # "N-N" | "N-1" | "mixed"
    rank_indexed_files: bool = False
    shared_file: bool = False
    collective_io: bool = False
    # patterns
    access_pattern: str = "unknown"     # "seq" | "strided" | "random"
    cross_rank_read: bool = False       # reads of files another rank wrote
    multi_phase: bool = False
    phase_pattern: str = "single"       # "write_then_read"|"create_then_stat"|...
    # intensity hints (structural only)
    meta_intensity: str = "low"         # "low" | "medium" | "high"
    has_data_calls: bool = True
    create_heavy: bool = False
    small_requests: bool = False
    tiny_requests: bool = False         # <= 1 KiB records
    latency_sensitive: bool = False
    # namespace
    dir_pattern: str = "unknown"        # "unique" | "shared" | "deep"
    # direction
    direction_hint: str = "unknown"     # "write" | "read" | "mixed"
    # script-derived
    bench_params: Dict[str, str] = field(default_factory=dict)
    n_nodes: int = 0
    ppn: int = 0
    app_hint: str = ""
    # provenance
    engine: str = "regex"               # "ast" | "regex" (source engine)
    provenance: List[Evidence] = field(default_factory=list)

    # ---- evidence API ------------------------------------------------------
    def note(self, fieldname: str, value, rule: str, tier: str,
             site: str = "", detail: str = "") -> None:
        """Record one Evidence entry for a decided feature."""
        self.provenance.append(Evidence(
            fieldname, str(value), rule, tier, TIER_CONFIDENCE[tier],
            site, detail))

    def evidence_for(self, fieldname: str) -> List[Evidence]:
        """All evidence recorded for one feature field."""
        return [e for e in self.provenance if e.field == fieldname]

    def confidence(self, fieldname: str) -> float:
        """Best evidence confidence for a field (default tier if none)."""
        ev = self.evidence_for(fieldname)
        return max((e.confidence for e in ev), default=DEFAULT_CONFIDENCE)

    def provenance_dict(self) -> Dict[str, Dict[str, str]]:
        """Field → best-evidence summary (for the Fig-5 JSON block)."""
        out: Dict[str, Dict[str, str]] = {}
        for e in self.provenance:
            cur = out.get(e.field)
            if cur is None or float(cur["confidence"]) <= e.confidence:
                out[e.field] = {
                    "value": e.value, "rule": e.rule, "tier": e.tier,
                    "confidence": f"{e.confidence:.2f}", "site": e.site,
                }
        return out


_RANK_FILE = re.compile(
    r'sprintf\s*\([^;]*%[0-9]*d[^;]*rank|filename_format\s*=.*\$jobnum'
    r'|rank%04d|\.%0?\d*d", *dir, *rank', re.S)
_COLLECTIVE = re.compile(
    r'MPI_File_(write|read)(_at)?_all|MPI_File_set_view')
# tightened: a bare independent MPI_File_read/write no longer implies a
# shared file — only a shared open, a set_view, a collective variant, an
# explicit shared filename, or the word itself count as shared evidence.
_SHARED_FILE = re.compile(
    r'MPI_File_open|MPI_File_set_view|MPI_File_\w*_all'
    r'|filename\s*=\s*\S+\.dat|shared')
_RANDOM = re.compile(r'rand(read|write|rw|om)|file_service_type=random')
_STRIDED = re.compile(r'off\s*\+=\s*\(MPI_Offset\)\s*np|set_view')
_SEQ = re.compile(r'off\s*\+=\s*xfer|rw\s*=\s*write\b|for[^;]*off[^;]*\+=')
_CROSS_RANK = re.compile(
    r'\(rank\s*\+\s*1\)\s*%\s*np|for\s*\(int\s+r\s*=\s*0;\s*r\s*<\s*np')
_META_CALL = re.compile(r'\b(creat|unlink|stat|fstat|fsync|utime|mkdir)\s*\('
                        r'|O_CREAT')
_COND_META = re.compile(r'if\s*\([^)]*%[^)]*\)\s*{[^}]*\b(stat|fstat|utime)'
                        r'|if\s*\(\(i\s*&\s*\d+\)')
_OPEN_CLOSE_LOOP = re.compile(
    r'for[^{]*{[^}]*open\s*\([^}]*close\s*\(', re.S)
_SMALL_REQ = re.compile(
    r'\bbs\s*=\s*([0-9]+)k\b|sizeof\(attr|,\s*512\s*,|XFER\b.*4096|\b4k\b')
_TINY_REQ = re.compile(r',\s*512\s*,|sizeof\(attr|\bbs\s*=\s*(512|1k)\b')
_CREATE_HEAVY = re.compile(r'\bcreat\s*\(|O_CREAT|nrfiles\s*=\s*\d{4,}'
                           r'|filename_format')
_FIO_RW = re.compile(r'^\s*rw\s*=\s*(\w+)', re.M)
_RANK_SUBDIR = re.compile(r'rank%0?\d*d/')
_WRITE_CALLS = re.compile(r'\b(pwrite|write|MPI_File_write)\w*\s*\(')
_READ_CALLS = re.compile(r'\b(pread|read|MPI_File_read)\w*\s*\(')
_FIO_W_MODE = re.compile(r'\brw\s*=\s*(write|randwrite|randrw|rw|readwrite)')
_FIO_R_MODE = re.compile(r'\brw\s*=\s*(\w*read\w*|randrw|rw)\b')
_BARRIER_SPLIT = re.compile(r'MPI_Barrier')


def extract_source_features(src: str, f: Optional[StaticFeatures] = None
                            ) -> StaticFeatures:
    """Regex-mine application source for access-pattern hints."""
    f = f or StaticFeatures()
    f.engine = "regex"
    f.rank_indexed_files = bool(_RANK_FILE.search(src))
    if f.rank_indexed_files:
        f.note("rank_indexed_files", True, "rx-rank-file", "regex",
               detail="rank-bearing sprintf/filename_format pattern")
    f.collective_io = bool(_COLLECTIVE.search(src))
    if f.collective_io:
        f.note("collective_io", True, "rx-collective", "regex")
    shared = bool(_SHARED_FILE.search(src)) and not f.rank_indexed_files
    f.shared_file = shared
    if shared:
        f.note("shared_file", True, "rx-shared-evidence", "regex",
               detail="shared open / set_view / collective / named file")
    if f.rank_indexed_files and not shared:
        f.topology_hint = "N-N"
        f.note("topology_hint", "N-N", "rx-rank-file", "regex")
    elif shared:
        f.topology_hint = "N-1"
        f.note("topology_hint", "N-1", "rx-shared-evidence", "regex")

    if _RANDOM.search(src):
        f.access_pattern = "random"
        f.note("access_pattern", "random", "rx-random", "regex")
    elif _STRIDED.search(src):
        f.access_pattern = "strided"
        f.note("access_pattern", "strided", "rx-strided", "regex")
    elif _SEQ.search(src):
        f.access_pattern = "seq"
        f.note("access_pattern", "seq", "rx-seq", "regex")

    f.cross_rank_read = bool(_CROSS_RANK.search(src))
    if f.cross_rank_read:
        f.note("cross_rank_read", True, "rx-cross-rank", "regex")
    w_calls = list(_WRITE_CALLS.finditer(src))
    r_calls = list(_READ_CALLS.finditer(src))
    writes, reads = len(w_calls), len(r_calls)
    if writes and reads:
        f.direction_hint = "mixed"
    elif writes:
        f.direction_hint = "write"
    elif reads:
        f.direction_hint = "read"
    if f.direction_hint != "unknown":
        f.note("direction_hint", f.direction_hint, "rx-call-count", "regex")

    # write/read evidence positions (calls, or fio rw= modes below):
    # used for phase ordering instead of raw-substring offsets
    first_w = min((m.start() for m in w_calls), default=None)
    last_r = max((m.start() for m in r_calls), default=None)

    # fio ini jobs: rw= drives direction
    rw_modes = _FIO_RW.findall(src)
    if rw_modes:
        has_w = any("write" in m or m == "randrw" for m in rw_modes)
        has_r = any("read" in m or m == "randrw" for m in rw_modes)
        f.direction_hint = ("mixed" if has_w and has_r else
                            "write" if has_w else "read")
        f.note("direction_hint", f.direction_hint, "rx-fio-rw", "regex")
        if len(rw_modes) > 1 or any(m == "randrw" for m in rw_modes):
            f.multi_phase = len(rw_modes) > 1
        writes += 1 if has_w else 0
        reads += 1 if has_r else 0
        wm = _FIO_W_MODE.search(src)
        if wm is not None:
            first_w = wm.start() if first_w is None else \
                min(first_w, wm.start())
        rms = list(_FIO_R_MODE.finditer(src))
        if rms:
            last_r = rms[-1].start() if last_r is None else \
                max(last_r, rms[-1].start())
    nrfiles_high = bool(re.search(r"nrfiles\s*=\s*\d{4,}", src))

    meta_calls = len(_META_CALL.findall(src))
    data_calls = writes + reads
    in_loop_meta = bool(_OPEN_CLOSE_LOOP.search(src)) or \
        ("for" in src and meta_calls >= 2 and not _COND_META.search(src))
    if nrfiles_high or (meta_calls >= 2 and in_loop_meta):
        f.meta_intensity = "high"
    elif meta_calls >= 1 and not _COND_META.search(src):
        f.meta_intensity = "medium" if data_calls else "high"
    else:
        f.meta_intensity = "low"
    f.note("meta_intensity", f.meta_intensity, "rx-meta-density", "regex",
           detail=f"{meta_calls} meta-call matches")

    f.has_data_calls = data_calls > 0
    f.create_heavy = bool(_CREATE_HEAVY.search(src))
    if f.create_heavy:
        f.note("create_heavy", True, "rx-create", "regex")
    f.small_requests = bool(_SMALL_REQ.search(src))
    f.tiny_requests = bool(_TINY_REQ.search(src))
    f.latency_sensitive = f.tiny_requests and meta_calls >= 1
    if f.latency_sensitive:
        f.note("latency_sensitive", True, "rx-tiny-meta", "regex")

    # phase structure: write evidence positioned before the last read
    # evidence (call sites / fio modes), or an explicit barrier split
    ordered = (first_w is not None and last_r is not None
               and first_w < last_r)
    if _BARRIER_SPLIT.search(src) or (writes and reads and ordered):
        if writes and reads:
            f.multi_phase = True
            f.phase_pattern = "write_then_read"
            f.note("phase_pattern", "write_then_read", "rx-order-or-barrier",
                   "regex", detail="write evidence precedes last read")
    if "creat" in src and "stat" in src:
        if f.phase_pattern == "single":
            f.phase_pattern = "create_then_stat"
            f.note("phase_pattern", "create_then_stat", "rx-creat-stat",
                   "regex")

    # namespace structure: only a per-rank SUBDIR makes the namespace
    # unique; rank-indexed file NAMES in a common parent still contend on
    # that parent directory.
    if _RANK_SUBDIR.search(src):
        f.dir_pattern = "unique"
        f.note("dir_pattern", "unique", "rx-rank-subdir", "regex")
    elif re.search(r'/shared/|filename\s*=|%s/', src):
        f.dir_pattern = "shared"
        f.note("dir_pattern", "shared", "rx-common-parent", "regex")
    return f


_FLAG = re.compile(r'(-{1,2}[A-Za-z][\w-]*)(?:[= ]([^\s-][^\s]*))?')
_SBATCH_N = re.compile(r'#SBATCH\s+-N\s+(\d+)')
_SBATCH_PPN = re.compile(r'#SBATCH\s+--ntasks-per-node=(\d+)')


def extract_script_features(script: str, f: Optional[StaticFeatures] = None
                            ) -> StaticFeatures:
    """Mine the batch script (scale, benchmark CLI params, hints)."""
    f = f or StaticFeatures()
    m = _SBATCH_N.search(script)
    if m:
        f.n_nodes = int(m.group(1))
    m = _SBATCH_PPN.search(script)
    if m:
        f.ppn = int(m.group(1))
    # the srun/launch line
    launch = ""
    for line in script.splitlines():
        if line.strip().startswith(("srun", "mpirun", "aprun")):
            launch = line
    tokens = launch.split()
    app = ""
    for t in tokens[1:]:
        if not t.startswith("-") and not t[0].isdigit() and t != "srun":
            app = t
            break
    f.app_hint = app
    for flag, val in _FLAG.findall(launch):
        f.bench_params[flag] = val or "true"

    bp = f.bench_params
    # IOR / mdtest / fio flag semantics
    if "-F" in bp:
        f.topology_hint, f.rank_indexed_files = "N-N", True
        f.note("topology_hint", "N-N", "flag-F-file-per-proc", "script",
               site=app or "launch")
    if "-c" in bp or "-a" in bp and bp.get("-a") == "MPIIO":
        f.collective_io = True
        f.note("collective_io", True, "flag-collective", "script")
    if "mdtest" in app:
        # the script flags decide the namespace shape authoritatively
        f.dir_pattern = ("unique" if "-u" in bp else
                         "deep" if "-z" in bp else "shared")
        f.note("dir_pattern", f.dir_pattern, "flag-mdtest-namespace",
               "script", site=app)
    elif "-u" in bp:
        f.dir_pattern = "unique"
        f.note("dir_pattern", "unique", "flag-unique-dir", "script")
    if "-N" in bp and "mdtest" in app:
        f.cross_rank_read = True
        f.note("cross_rank_read", True, "flag-mdtest-N-shift", "script")
    if "--rwmixread" in bp:
        f.direction_hint = "mixed"
        f.bench_params["read_pct"] = bp["--rwmixread"]
        f.note("direction_hint", "mixed", "flag-rwmixread", "script")
    if "-w" in bp and "-r" in bp:
        f.direction_hint = "mixed"
        f.multi_phase = True
        f.phase_pattern = "write_then_read"
        f.note("phase_pattern", "write_then_read", "flag-w-r", "script")
    elif "-w" in bp:
        f.direction_hint = "write"
    elif "-r" in bp:
        f.direction_hint = "read"
    if "-C" in bp and "mdtest" in app:
        f.cross_rank_read = True
        f.note("cross_rank_read", True, "flag-mdtest-C-shift", "script")
    t = bp.get("-t", "")
    if t.endswith(("k", "K")) and t[:-1].isdigit() and int(t[:-1]) <= 64:
        f.small_requests = True
    if "shared_file" in launch or "-o" in bp and "shared" in bp.get("-o", ""):
        f.shared_file = True
        f.topology_hint = "N-1"
        f.note("topology_hint", "N-1", "flag-shared-target", "script")
    return f


def extract_static(source: str, script: str,
                   engine: str = "auto") -> StaticFeatures:
    """Full static pass: source (AST engine with regex fallback, per
    ``engine``: "auto" | "ast" | "regex") then script, with default fills.
    """
    f: Optional[StaticFeatures] = None
    if engine in ("auto", "ast"):
        from repro_torch.core.intent import staticlib
        try:
            f = staticlib.analyze_source(source)
        except staticlib.StaticAnalysisError:
            if engine == "ast":
                raise
    if f is None:
        f = extract_source_features(source)
    f = extract_script_features(script, f)
    # default: a common parent directory is shared territory
    if f.dir_pattern == "unknown":
        f.dir_pattern = "shared"
        f.note("dir_pattern", "shared", "default-common-parent", "default")
    if f.topology_hint == "unknown":
        f.topology_hint = "N-1" if f.shared_file else "N-N"
        f.note("topology_hint", f.topology_hint, "default-from-sharing",
               "default")
    return f
