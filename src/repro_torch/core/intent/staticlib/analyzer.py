"""AST-driven feature analyzer: parse → CFG → dataflow → StaticFeatures.

This is the corpus-facing entry point of the static engine.  For each
function it walks the live statement contexts (dead branches excluded),
maintains a taint environment and per-variable name/file records, and
emits flat event records (data calls, metadata calls, barriers, name
constructions).  One level of *wrapper inlining* maps a helper's data
calls back to its call sites, so ``dump(fd, buf, n, off)`` wrapping
``pwrite`` still contributes direction, intensity and offset evolution
at the caller's loop depth.

Every decided ``StaticFeatures`` field gets an ``Evidence`` record with
the rule id, confidence tier (``ast-dataflow`` for taint/RD-proven
facts, ``ast-struct`` for call/loop structure) and ``func:line`` site.

A copy of ``repro.core.intent.staticlib.analyzer``;
the port imports nothing of the reference.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.intent.static_extractor import StaticFeatures
from repro_torch.core.intent.staticlib import cparse as C
from repro_torch.core.intent.staticlib.cfg import (StmtCtx, build_cfg, const_value,
                                             walk_contexts)
from repro_torch.core.intent.staticlib.dataflow import (NPROC_NAMES, ReachingDefs,
                                                  TAINT_ALL, TAINT_NONE,
                                                  TAINT_OTHER, TAINT_SELF,
                                                  TaintEnv, calls_in,
                                                  classify_offset,
                                                  eval_taint, free_idents,
                                                  join, taint_name)


class StaticAnalysisError(ValueError):
    """The input is not analyzable C (caller should fall back to regex)."""


def looks_like_c(src: str) -> bool:
    """True when the source parses into at least one C-like function."""
    try:
        return bool(C.parse(src).funcs)
    except C.ParseError:
        return False


# call tables ---------------------------------------------------------------
_POSIX_WRITE = {"write", "pwrite", "pwritev", "writev", "fwrite"}
_POSIX_READ = {"read", "pread", "preadv", "readv", "fread"}
_META_FNS = {"creat", "unlink", "stat", "fstat", "lstat", "fsync",
             "fdatasync", "utime", "utimes", "mkdir", "rmdir", "rename",
             "access"}
_OPEN_FNS = {"open", "open64", "fopen", "creat"}
_SPRINTF = {"sprintf", "snprintf"}
_COLLECTIVE_RE = re.compile(r"MPI_File_(write|read)(_at)?_all$"
                            r"|MPI_File_set_view$")
_SPEC = re.compile(r"%[-+ #0-9.*]*(?:hh|h|ll|l|j|z|t|L)?"
                   r"[diouxXeEfFgGaAcspn]")


def _data_kind(name: str) -> Optional[str]:
    if name in _POSIX_WRITE or name.startswith("MPI_File_write") or \
            name.startswith("MPI_File_iwrite"):
        return "write"
    if name in _POSIX_READ or name.startswith("MPI_File_read") or \
            name.startswith("MPI_File_iread"):
        return "read"
    return None


def _arg_positions(name: str) -> Tuple[Optional[int], Optional[int], int]:
    """(offset_idx, size_idx, file_idx) for a data call, or Nones."""
    if name in ("pwrite", "pread"):
        return 3, 2, 0
    if name in ("write", "read"):
        return None, 2, 0
    if name in ("fwrite", "fread"):
        return None, 1, 3
    if name.startswith("MPI_File_"):
        if "_at" in name:
            return 1, 3, 0
        return None, 2, 0
    return None, None, 0


# record types --------------------------------------------------------------
@dataclass
class NameRec:
    """A constructed (or literal) file name and its taint structure."""
    fmt: str = ""
    taint: int = TAINT_NONE      # join over all bound arguments
    self_spec: bool = False      # SELF bound to some conversion spec
    self_in_dir: bool = False    # SELF-bound spec before the last '/'
    has_slash: bool = False
    literal: bool = False        # constant string, no conversion at all
    line: int = 0

    def joined(self, other: "NameRec") -> "NameRec":
        """Lattice join of two names reaching the same variable."""
        return NameRec(self.fmt or other.fmt,
                       join(self.taint, other.taint),
                       self.self_spec or other.self_spec,
                       self.self_in_dir or other.self_in_dir,
                       self.has_slash or other.has_slash,
                       self.literal and other.literal,
                       self.line or other.line)


@dataclass
class FileRec:
    """A file handle: where its name came from and how it was opened."""
    name: Optional[NameRec] = None
    mpi: bool = False
    param: bool = False          # handle received as a parameter
    opened_here: bool = False
    comm_self: bool = False      # MPI_File_open on MPI_COMM_SELF
    creat: bool = False
    line: int = 0

    @property
    def name_taint(self) -> int:
        """Taint of the underlying file name (NONE when unknown)."""
        return self.name.taint if self.name is not None else TAINT_NONE


@dataclass
class DataRec:
    """One data-path call (direct or wrapper-inlined)."""
    kind: str                    # "write" | "read"
    name: str
    order: int
    depth: int
    guard: int
    site: str
    file_rec: Optional[FileRec] = None
    off_taint: int = TAINT_NONE
    pattern: str = "unknown"
    why: str = ""
    size_kib: Optional[float] = None
    sizeof_struct: bool = False
    mpi: bool = False
    collective: bool = False
    # raw shapes kept for wrapper mapping
    off_expr: Optional[C.Node] = None
    size_expr: Optional[C.Node] = None
    file_expr: Optional[C.Node] = None

    @property
    def file_taint(self) -> int:
        """Taint of the file this call touches."""
        return self.file_rec.name_taint if self.file_rec else TAINT_NONE


@dataclass
class MetaRec:
    """One metadata call (creat/stat/unlink/... or an O_CREAT open)."""
    name: str
    order: int
    depth: int
    guard: int
    site: str
    creates: bool = False
    loop_sym: str = ""           # symbolic trip count of enclosing loop


@dataclass
class LocalCall:
    """A call to a function defined in the same translation unit."""
    name: str
    order: int
    depth: int
    guard: int
    site: str
    args: List[C.Node] = field(default_factory=list)
    arg_taints: List[int] = field(default_factory=list)
    arg_files: List[Optional[FileRec]] = field(default_factory=list)


class _FuncModel:
    """Per-function analysis state: CFG, dataflow and event records."""

    def __init__(self, func: C.FuncDef, order_base: int):
        self.func = func
        self.order_base = order_base
        self.ctxs = walk_contexts(func)
        self.cfg = build_cfg(func)
        self.rd = ReachingDefs(self.cfg)
        self.loop_vars: Dict[str, str] = {}
        loop_all = set()
        for ctx in self.ctxs:
            for info in ctx.loops:
                if info.var:
                    self.loop_vars.setdefault(info.var, info.step)
                    bound_ids = set(re.findall(r"[A-Za-z_]\w*", info.bound))
                    if bound_ids & NPROC_NAMES:
                        loop_all.add(info.var)
        self.env = TaintEnv(loop_all)
        self.names: Dict[str, NameRec] = {}
        self.files: Dict[str, FileRec] = {}
        for p in func.params:
            if "MPI_File" in p.type_text and p.name:
                self.files[p.name] = FileRec(mpi=True, param=True,
                                             line=p.line)
        self.data: List[DataRec] = []
        self.meta: List[MetaRec] = []
        self.barriers: List[int] = []
        self.local_calls: List[LocalCall] = []
        self.used_names: List[NameRec] = []
        self.set_view_line: Optional[int] = None
        # (rule, tier, site, detail) tuples
        self.shared_ev: List[Tuple[str, str, str, str]] = []
        self.private_open = False   # MPI_File_open on MPI_COMM_SELF seen

    def site(self, line: int) -> str:
        """Provenance call-site string for a source line."""
        return f"{self.func.name}:{line}"

    def order(self, ctx: StmtCtx) -> int:
        """Global (cross-function) statement order."""
        return self.order_base + ctx.order

    def loop_sym(self, ctx: StmtCtx) -> str:
        """Symbolic trip expression of the innermost enclosing loop."""
        if ctx.loops:
            info = ctx.loops[-1]
            return info.trip_sym or info.bound
        return ""


class _Analyzer:
    """Single-pass-per-function program analyzer."""

    def __init__(self, program: C.Program):
        self.program = program
        self.models: List[_FuncModel] = [
            _FuncModel(fn, i * 100_000)
            for i, fn in enumerate(program.funcs)]
        self.by_name = {m.func.name: m for m in self.models}

    # -- statement walk ------------------------------------------------------
    def run(self) -> None:
        """Walk every function's live statements and record events."""
        for m in self.models:
            for ctx in m.ctxs:
                if ctx.dead:
                    continue
                stmt = ctx.stmt
                if isinstance(stmt, C.Decl) and stmt.init is not None:
                    res = self._expr(m, ctx, stmt.init)
                    self._bind(m, ctx, stmt.name, stmt.init, "=", res)
                elif isinstance(stmt, C.ExprStmt):
                    self._expr(m, ctx, stmt.expr)
                elif isinstance(stmt, C.Return) and stmt.expr is not None:
                    self._expr(m, ctx, stmt.expr)

    def _expr(self, m: _FuncModel, ctx: StmtCtx, e: C.Node
              ) -> Optional[FileRec]:
        """Process one expression tree; returns a FileRec for open calls."""
        if isinstance(e, C.Assign):
            res = self._expr(m, ctx, e.value)
            if isinstance(e.target, C.Ident):
                self._bind(m, ctx, e.target.name, e.value, e.op, res)
            return None
        if isinstance(e, C.Call):
            return self._call(m, ctx, e)
        if isinstance(e, C.BinOp):
            self._expr(m, ctx, e.lhs)
            self._expr(m, ctx, e.rhs)
        elif isinstance(e, C.UnOp):
            self._expr(m, ctx, e.operand)
        elif isinstance(e, C.Cast):
            self._expr(m, ctx, e.expr)
        elif isinstance(e, C.Cond):
            self._expr(m, ctx, e.cond)
            self._expr(m, ctx, e.then)
            self._expr(m, ctx, e.orelse)
        return None

    def _bind(self, m: _FuncModel, ctx: StmtCtx, name: str,
              value: C.Node, op: str, res: Optional[FileRec]) -> None:
        weak = ctx.cond_depth > 0 or op != "="
        m.env.set(name, eval_taint(value, m.env), weak=weak)
        if res is not None:                      # fd = open(...)
            m.files[name] = res
        elif isinstance(value, C.Ident):         # handle/name aliasing
            if value.name in m.files and op == "=":
                m.files[name] = m.files[value.name]
            if value.name in m.names and op == "=":
                m.names[name] = m.names[value.name]

    # -- call dispatch -------------------------------------------------------
    def _call(self, m: _FuncModel, ctx: StmtCtx, call: C.Call
              ) -> Optional[FileRec]:
        for a in call.args:                      # nested calls first
            if not isinstance(a, (C.Num, C.Str, C.Ident)):
                self._expr(m, ctx, a)
        name = call.name
        if name in _SPRINTF:
            self._sprintf(m, ctx, call)
            return None
        if name == "MPI_Barrier":
            m.barriers.append(m.order(ctx))
            return None
        if name == "MPI_File_open":
            return self._mpi_open(m, ctx, call)
        if name == "MPI_File_set_view":
            m.set_view_line = call.line
            m.shared_ev.append(("mpi-set-view", "ast-struct",
                                m.site(call.line),
                                "file view partitioned across ranks"))
            return None
        if name in _OPEN_FNS:
            return self._open(m, ctx, call, name)
        if name in _META_FNS:
            self._meta(m, ctx, call, name, creates=name == "creat")
            return None
        kind = _data_kind(name)
        if kind is not None:
            self._data(m, ctx, call, kind)
            return None
        if name in self.by_name and self.by_name[name] is not m:
            args = list(call.args)
            m.local_calls.append(LocalCall(
                name, m.order(ctx), ctx.depth, ctx.guard_div,
                m.site(call.line), args,
                [eval_taint(a, m.env) for a in args],
                [m.files.get(a.name) if isinstance(a, C.Ident) else None
                 for a in args]))
        return None

    def _sprintf(self, m: _FuncModel, ctx: StmtCtx, call: C.Call) -> None:
        args = call.args
        fmt_idx = 2 if call.name == "snprintf" else 1
        if len(args) <= fmt_idx or not isinstance(args[fmt_idx], C.Str):
            return
        fmt = args[fmt_idx].text
        bound = args[fmt_idx + 1:]
        rec = NameRec(fmt=fmt, has_slash="/" in fmt, line=call.line,
                      literal=not bound and "%" not in fmt)
        last_slash = fmt.rfind("/")
        for i, spec in enumerate(_SPEC.finditer(fmt)):
            if i >= len(bound):
                break
            t = eval_taint(bound[i], m.env)
            rec.taint = join(rec.taint, t)
            if t == TAINT_SELF:
                rec.self_spec = True
                if spec.start() < last_slash:
                    rec.self_in_dir = True
        if isinstance(args[0], C.Ident):
            dest = args[0].name
            if ctx.cond_depth > 0 and dest in m.names:
                rec = m.names[dest].joined(rec)
            m.names[dest] = rec

    def _resolve_name(self, m: _FuncModel, e: C.Node) -> Optional[NameRec]:
        if isinstance(e, C.Ident):
            rec = m.names.get(e.name)
            if rec is None and e.name not in m.files:
                t = m.env.get(e.name)
                if t != TAINT_NONE:
                    rec = NameRec(taint=t, line=e.line)
            return rec
        if isinstance(e, C.Str):
            return NameRec(fmt=e.text, has_slash="/" in e.text,
                           literal=True, line=e.line)
        return None

    def _open(self, m: _FuncModel, ctx: StmtCtx, call: C.Call,
              name: str) -> FileRec:
        nrec = self._resolve_name(m, call.args[0]) if call.args else None
        creat = name == "creat" or any(
            "O_CREAT" in free_idents(a) for a in call.args[1:])
        rec = FileRec(name=nrec, opened_here=True, creat=creat,
                      line=call.line)
        if nrec is not None:
            m.used_names.append(nrec)
        if creat:
            self._meta(m, ctx, call, name, creates=True)
        return rec

    def _mpi_open(self, m: _FuncModel, ctx: StmtCtx,
                  call: C.Call) -> None:
        args = call.args
        comm_self = bool(args) and \
            "MPI_COMM_SELF" in free_idents(args[0])
        nrec = self._resolve_name(m, args[1]) if len(args) > 1 else None
        if nrec is not None:
            m.used_names.append(nrec)
        rec = FileRec(name=nrec, mpi=True, opened_here=True,
                      comm_self=comm_self, line=call.line)
        for a in args:
            if isinstance(a, C.UnOp) and a.op == "&" and \
                    isinstance(a.operand, C.Ident):
                m.files[a.operand.name] = rec
        if comm_self:
            m.private_open = True
        else:
            m.shared_ev.append(("mpi-shared-open", "ast-dataflow",
                                m.site(call.line),
                                "MPI_File_open on a multi-rank "
                                "communicator"))

    def _meta(self, m: _FuncModel, ctx: StmtCtx, call: C.Call,
              name: str, creates: bool) -> None:
        m.meta.append(MetaRec(name, m.order(ctx), ctx.depth, ctx.guard_div,
                              m.site(call.line), creates, m.loop_sym(ctx)))
        if call.args and name not in _OPEN_FNS:
            nrec = self._resolve_name(m, call.args[0])
            if nrec is not None:
                m.used_names.append(nrec)

    def _data(self, m: _FuncModel, ctx: StmtCtx, call: C.Call,
              kind: str) -> None:
        name = call.name
        off_i, size_i, file_i = _arg_positions(name)
        arg = lambda i: call.args[i] if i is not None and \
            i < len(call.args) else None
        off, size, fexpr = arg(off_i), arg(size_i), arg(file_i)
        frec = None
        if isinstance(fexpr, C.Ident):
            frec = m.files.get(fexpr.name)
        pattern, why = classify_offset(off, m.rd, m.loop_vars)
        rec = DataRec(
            kind, name, m.order(ctx), ctx.depth, ctx.guard_div,
            m.site(call.line), frec,
            eval_taint(off, m.env), pattern, why,
            _size_kib(size), isinstance(size, C.SizeOf),
            mpi=name.startswith("MPI_File_"),
            collective=bool(_COLLECTIVE_RE.match(name)),
            off_expr=off, size_expr=size, file_expr=fexpr)
        m.data.append(rec)
        self._sharing_from_data(m, rec)

    def _sharing_from_data(self, m: _FuncModel, rec: DataRec) -> None:
        if rec.mpi:
            fr = rec.file_rec
            if fr is not None and fr.opened_here and fr.comm_self:
                return                    # provably private handle
            if rec.collective:
                m.shared_ev.append(
                    ("mpi-collective-data", "ast-struct", rec.site,
                     f"collective {rec.name} implies one shared file"))
            elif fr is not None and fr.param:
                m.shared_ev.append(
                    ("mpi-handle-param", "ast-struct", rec.site,
                     "MPI file handle received from the caller"))
        else:
            fr = rec.file_rec
            if fr is not None and fr.name is not None and \
                    fr.name.literal and rec.off_taint >= TAINT_SELF:
                m.shared_ev.append(
                    ("literal-file-rank-offset", "ast-dataflow", rec.site,
                     "constant file name with rank-dependent offsets "
                     "→ every rank writes one file"))


def _size_kib(size: Optional[C.Node]) -> Optional[float]:
    v = const_value(size)
    return v / 1024.0 if v is not None else None


# ---------------------------------------------------------------------------
# wrapper inlining (one level)
# ---------------------------------------------------------------------------
def _stmt_exprs(stmt: C.Node) -> List[C.Node]:
    """Expression children of one statement node (shallow)."""
    out: List[C.Node] = []
    if isinstance(stmt, C.Decl) and stmt.init is not None:
        out.append(stmt.init)
    elif isinstance(stmt, C.ExprStmt):
        out.append(stmt.expr)
    elif isinstance(stmt, C.Return) and stmt.expr is not None:
        out.append(stmt.expr)
    elif isinstance(stmt, C.If):
        out.append(stmt.cond)
    elif isinstance(stmt, C.While):
        out.append(stmt.cond)
    elif isinstance(stmt, C.For):
        out.extend(e for e in (stmt.cond, stmt.step) if e is not None)
    return out


def _inline_wrappers(an: _Analyzer) -> Tuple[List[DataRec], List[MetaRec],
                                             List[int]]:
    """Data/meta/barrier records of root functions, with one level of
    helper-call inlining mapped back to the call sites.

    Helper-ness is *structural* (referenced by name anywhere, even from
    a dead branch); liveness governs inlining.  So a verify helper whose
    only call site sits under ``if (0)`` contributes nothing — it is not
    a root, and the dead call is never inlined.
    """
    called = set()
    for m in an.models:
        for ctx in m.ctxs:
            for e in _stmt_exprs(ctx.stmt):
                for call in calls_in(e):
                    if call.name in an.by_name:
                        called.add(call.name)
    roots = [m for m in an.models if m.func.name not in called]
    if not roots:
        roots = an.models
    data: List[DataRec] = []
    meta: List[MetaRec] = []
    barriers: List[int] = []
    for m in roots:
        data.extend(m.data)
        meta.extend(m.meta)
        barriers.extend(m.barriers)
        for lc in m.local_calls:
            g = an.by_name.get(lc.name)
            if g is None:
                continue
            pidx = {p.name: i for i, p in enumerate(g.func.params)}

            def mapped(e: Optional[C.Node]) -> Optional[C.Node]:
                if isinstance(e, C.Ident) and e.name in pidx and \
                        pidx[e.name] < len(lc.args):
                    return lc.args[pidx[e.name]]
                return None

            for dr in g.data:
                off = mapped(dr.off_expr)
                if dr.off_expr is None:
                    pattern, why = "seq", "no offset argument"
                elif off is not None:
                    pattern, why = classify_offset(off, m.rd, m.loop_vars)
                else:
                    pattern, why = "unknown", ("wrapper offset not "
                                               "parameter-mapped")
                fexpr = mapped(dr.file_expr)
                frec = None
                if isinstance(fexpr, C.Ident):
                    frec = m.files.get(fexpr.name)
                size = mapped(dr.size_expr)
                data.append(DataRec(
                    dr.kind, dr.name, lc.order, lc.depth + dr.depth,
                    lc.guard * dr.guard, lc.site, frec,
                    eval_taint(off, m.env) if off is not None else
                    TAINT_NONE,
                    pattern, why,
                    _size_kib(size) if size is not None else dr.size_kib,
                    dr.sizeof_struct, dr.mpi, dr.collective))
            for mr in g.meta:
                meta.append(MetaRec(
                    mr.name, lc.order, lc.depth + mr.depth,
                    lc.guard * mr.guard, lc.site, mr.creates, mr.loop_sym))
    return data, meta, barriers


# ---------------------------------------------------------------------------
# feature synthesis
# ---------------------------------------------------------------------------
def analyze_source(src: str, f: Optional[StaticFeatures] = None
                   ) -> StaticFeatures:
    """Analyze C-like source into evidence-graded ``StaticFeatures``.

    Raises ``StaticAnalysisError`` when the input is not the C dialect
    (fio ini jobs, shell scripts, free text) — the caller then falls
    back to the regex engine.
    """
    try:
        program = C.parse(src)
    except C.ParseError as e:
        raise StaticAnalysisError(f"not C-like source: {e}") from e
    if not program.funcs:
        raise StaticAnalysisError("no parsable C functions found")

    an = _Analyzer(program)
    an.run()
    data, meta, barriers = _inline_wrappers(an)
    shared_ev = [ev for m in an.models for ev in m.shared_ev]
    used_names = [n for m in an.models for n in m.used_names]
    set_view = any(m.set_view_line is not None for m in an.models)

    f = f or StaticFeatures()
    f.engine = "ast"

    writes = [d for d in data if d.kind == "write"]
    reads = [d for d in data if d.kind == "read"]
    f.has_data_calls = bool(data)

    # direction ------------------------------------------------------------
    if writes and reads:
        f.direction_hint = "mixed"
    elif writes:
        f.direction_hint = "write"
    elif reads:
        f.direction_hint = "read"
    if f.direction_hint != "unknown":
        f.note("direction_hint", f.direction_hint, "call-direction",
               "ast-struct", site=data[0].site,
               detail=f"{len(writes)} write / {len(reads)} read call sites")

    # collective -----------------------------------------------------------
    if set_view or any(d.collective for d in data):
        f.collective_io = True
        site = next((d.site for d in data if d.collective),
                    next((m.site(m.set_view_line) for m in an.models
                          if m.set_view_line is not None), ""))
        f.note("collective_io", True, "mpi-collective-call", "ast-struct",
               site=site)

    # file-name structure ---------------------------------------------------
    rank_named = [n for n in used_names if n.self_spec]
    f.rank_indexed_files = bool(rank_named)
    if rank_named:
        f.note("rank_indexed_files", True, "taint-name-self",
               "ast-dataflow", site=f"line {rank_named[0].line}",
               detail=f"rank taint reaches format {rank_named[0].fmt!r}")

    # sharing ---------------------------------------------------------------
    f.shared_file = bool(shared_ev)
    if shared_ev:
        rule, tier, site, detail = shared_ev[0]
        f.note("shared_file", True, rule, tier, site=site, detail=detail)

    if f.shared_file and f.rank_indexed_files:
        f.topology_hint = "mixed"
        f.note("topology_hint", "mixed", "mixed-sharing-evidence",
               "ast-struct")
    elif f.shared_file:
        f.topology_hint = "N-1"
        f.note("topology_hint", "N-1", shared_ev[0][0], shared_ev[0][1],
               site=shared_ev[0][2])
    elif f.rank_indexed_files:
        f.topology_hint = "N-N"
        f.note("topology_hint", "N-N", "taint-name-self", "ast-dataflow",
               detail="every rank opens a file named by its own rank")

    # cross-rank reads ------------------------------------------------------
    for r in reads:
        ft, ot = r.file_taint, r.off_taint
        if ft in (TAINT_OTHER, TAINT_ALL) or ot in (TAINT_OTHER, TAINT_ALL):
            f.cross_rank_read = True
            which = ("file name" if ft in (TAINT_OTHER, TAINT_ALL)
                     else "offset")
            t = ft if ft in (TAINT_OTHER, TAINT_ALL) else ot
            f.note("cross_rank_read", True, "taint-cross-rank",
                   "ast-dataflow", site=r.site,
                   detail=f"{r.name} {which} carries {taint_name(t)!r} "
                          "rank taint")
            break

    # access pattern (offset evolution) -------------------------------------
    for want in ("random", "strided", "seq"):
        hit = next((d for d in data if d.pattern == want), None)
        if set_view and want == "strided" and hit is None:
            f.access_pattern = "strided"
            f.note("access_pattern", "strided", "mpi-set-view",
                   "ast-struct")
            break
        if hit is not None:
            f.access_pattern = want
            f.note("access_pattern", want, "rd-offset-evolution",
                   "ast-dataflow", site=hit.site, detail=hit.why)
            break

    # metadata intensity -----------------------------------------------------
    unguarded = [mr for mr in meta if mr.guard == 1]
    in_loop = [mr for mr in unguarded if mr.depth >= 1]
    if len(unguarded) >= 2 and in_loop:
        f.meta_intensity = "high"
        sym = next((mr.loop_sym for mr in in_loop if mr.loop_sym), "")
        f.note("meta_intensity", "high", "loop-meta-density", "ast-struct",
               site=in_loop[0].site,
               detail=f"{len(unguarded)} metadata calls per iteration"
                      + (f", ~{sym} iterations" if sym else ""))
    elif unguarded:
        f.meta_intensity = "medium" if data else "high"
        f.note("meta_intensity", f.meta_intensity, "meta-present",
               "ast-struct", site=unguarded[0].site)
    else:
        f.meta_intensity = "low"
        if meta:
            f.note("meta_intensity", "low", "guard-sampled-meta",
                   "ast-dataflow", site=meta[0].site,
                   detail=f"metadata only every {meta[0].guard}-th "
                          "iteration")

    f.create_heavy = any(mr.creates for mr in meta)
    if f.create_heavy:
        cr = next(mr for mr in meta if mr.creates)
        f.note("create_heavy", True, "creat-or-ocreat", "ast-struct",
               site=cr.site)

    # request sizes ----------------------------------------------------------
    smalls = [d for d in data if d.sizeof_struct or
              (d.size_kib is not None and d.size_kib <= 64)]
    tinies = [d for d in data if d.sizeof_struct or
              (d.size_kib is not None and d.size_kib <= 1)]
    f.small_requests = bool(smalls)
    f.tiny_requests = bool(tinies)
    if tinies:
        f.note("tiny_requests", True, "const-size-arg", "ast-struct",
               site=tinies[0].site,
               detail="record size folds to <= 1 KiB" if not
               tinies[0].sizeof_struct else "sizeof(struct)-sized records")
    f.latency_sensitive = f.tiny_requests and bool(meta)
    if f.latency_sensitive:
        f.note("latency_sensitive", True, "tiny-records-plus-meta",
               "ast-struct", site=tinies[0].site)

    # phase structure --------------------------------------------------------
    if writes and reads:
        wmin = min(d.order for d in writes)
        rmax = max(d.order for d in reads)
        barrier_split = any(wmin < b < rmax for b in barriers) \
            or bool(barriers)
        if barrier_split or wmin < rmax:
            f.multi_phase = True
            f.phase_pattern = "write_then_read"
            rule = ("barrier-phase-split" if barrier_split
                    else "stmt-order-write-then-read")
            f.note("phase_pattern", "write_then_read", rule, "ast-struct",
                   site=writes[0].site,
                   detail="write statements precede reads"
                          + (" across an MPI_Barrier" if barrier_split
                             else " in statement order"))
    if f.phase_pattern == "single" and f.create_heavy and \
            any(mr.name in ("stat", "fstat", "lstat") for mr in meta):
        f.phase_pattern = "create_then_stat"
        f.note("phase_pattern", "create_then_stat", "creat-stat-sequence",
               "ast-struct")

    # namespace --------------------------------------------------------------
    if any(n.self_in_dir for n in used_names):
        n = next(n for n in used_names if n.self_in_dir)
        f.dir_pattern = "unique"
        f.note("dir_pattern", "unique", "fmt-rank-subdir", "ast-dataflow",
               site=f"line {n.line}",
               detail=f"rank-bound directory component in {n.fmt!r}")
    elif any(n.has_slash for n in used_names):
        f.dir_pattern = "shared"
        f.note("dir_pattern", "shared", "fmt-common-parent", "ast-struct",
               detail="file names share a parent directory")
    return f
