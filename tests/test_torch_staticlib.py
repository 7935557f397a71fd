"""The port's static-analysis engine (repro_torch.core.intent.staticlib)
against the JAX package's: tokens, the parsed AST, execution contexts, loop
nests, the basic-block CFG, reaching definitions, offset classes and rank
taint, and ``analyze_source``'s features with their provenance, on every
workload source and job script and on the reference tests' snippets; then
the reference's own staticlib cases run on the port.

Every comparison is exact: the engine is pure Python on both sides.
Objects are compared as ``plain`` trees (class name and fields), errors by
type name and message; a ``Def``'s node id (``id()`` of an AST node) is
compared as its position among the function's definitions.
"""
import dataclasses
import enum

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                     # pragma: no cover - env dependent
    from _minihyp import given, settings, strategies as st

from repro.core.adapt.redecide import signature_workload as j_sig_workload
from repro.core.intent import staticlib as jstaticlib
from repro.core.intent.staticlib import cfg as jcfg
from repro.core.intent.staticlib import cparse as jC
from repro.core.intent.staticlib import dataflow as jdf
from repro.core.intent.staticlib import lexer as jlexer
from repro.core.workloads import adversarial_workloads as j_adversarial
from repro.core.workloads import build_workloads as j_build
from repro.core.workloads import heterogeneous_workload as j_hetero
from repro_torch.core.intent import staticlib
from repro_torch.core.intent.oracle import suite_accuracy
from repro_torch.core.intent.selector import select_layout
from repro_torch.core.intent.static_extractor import (TIER_CONFIDENCE,
                                                      extract_static)
from repro_torch.core.intent.staticlib import cfg as tcfg
from repro_torch.core.intent.staticlib import cparse as C
from repro_torch.core.intent.staticlib import dataflow as tdf
from repro_torch.core.intent.staticlib import lexer as tlexer
from repro_torch.core.intent.staticlib.cfg import (build_cfg, loop_nests,
                                                   walk_contexts)
from repro_torch.core.intent.staticlib.dataflow import (
    RANK_NAMES, TAINT_ALL, TAINT_NONE, TAINT_OTHER, TAINT_SELF, ReachingDefs,
    TaintEnv, classify_offset, eval_taint)
from repro_torch.core.intent.staticlib.lexer import LexError, tokenize
from repro_torch.core.workloads import (adversarial_workloads,
                                        build_workloads,
                                        heterogeneous_workload,
                                        workload_by_name)
from test_staticlib import _DEAD_SRC, _LIVE_TEMPLATE, _PAYLOADS

WS = build_workloads(32)
ADV = adversarial_workloads(32)


def plain(x):
    """A comparable tree of ``x``: dataclasses as (class name, fields),
    enums as ints, containers element-wise, sets sorted."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((plain(v) for v in x), key=repr)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def outcome(fn, *args):
    """``plain(fn(*args))``, or the error's type name and message."""
    try:
        return "ok", plain(fn(*args))
    except Exception as e:              # compared, not swallowed
        return type(e).__name__, str(e)


# ---------------------------------------------------------------------------
# the corpus: every workload's source and job script, the synthesized
# drift source, and the reference tests' snippets
# ---------------------------------------------------------------------------
_SNIPPETS = {
    "lexer-comments": '/* shared */ #define X 1\nint a = 2; // shared\n',
    "lexer-shell": "numjobs=${NJOBS}",
    "parser-shape": """
    void f(int rank, size_t n) {
      for (size_t i = 0; i < n; i++)
        pwrite(fd, buf, 64, i * 64);
    }
    """,
    "parser-ini": "rw=write\nbs=4m\nnumjobs=${NJOBS}\n",
    "ini-global": "[global]\nrw=randread\n",
    "dead": _DEAD_SRC,
    "loop-nest": """
    void h(int n) {
      for (int i = 0; i < 128; i += 4)
        for (int j = 0; j < n; j++)
          write(fd, b, 1);
    }
    """,
    "reaching": """
    void k(size_t block, size_t xfer, int np) {
      size_t off = 0;
      for (size_t i = 0; i < block; i++) {
        pwrite(fd, buf, xfer, off);
        off += xfer;
      }
    }
    """,
    "strided-random": """
    void k(int np, size_t xfer) {
      size_t off = 0;
      size_t roff = 0;
      for (size_t i = 0; i < 100; i++) {
        off += np * xfer;
        roff = rand() % 7777;
      }
    }
    """,
    "taint": "void t(int rank, int np) { x = (rank + 1) % np; y = r_all; }",
    "mpi-unknown-handle":
        "void r(MPI_File fh) { MPI_File_read(fh, buf, n, MPI_BYTE, &st); }",
    "write-then-read":
        "void m(int fd) { pwrite(fd, b, n, 0); pread(fd, b, n, 0); }",
    "read-then-write":
        "void m(int fd) { pread(fd, b, n, 0); pwrite(fd, b, n, 0); }",
    "prose": "/* writers wrote previously */"
             " void m(int fd) { pread(fd, b, n, 0); }",
    "live-empty": _LIVE_TEMPLATE.replace("PAYLOAD", ";"),
    "live-all": _LIVE_TEMPLATE.replace(
        "PAYLOAD", "\n".join("    " + p for p in _PAYLOADS)),
}
_SIGS = {"read": np.array([0.95, 0.05, 0.0, 0.2, 0.0, 0.5]),
         "write": np.array([0.1, 0.3, 0.9, 0.8, 0.0, 0.9])}


def _corpus():
    out = {}
    for w in (j_build(32) + j_adversarial(32) + [j_hetero(32)]):
        out[f"{w.name}.source"] = w.source_code
        out[f"{w.name}.script"] = w.job_script
    for k, sig in _SIGS.items():
        w = j_sig_workload("/bb/hot", sig, 32)
        out[f"drift-{k}.source"] = w.source_code
    out.update({f"snippet-{k}": v for k, v in _SNIPPETS.items()})
    return out


CORPUS = _corpus()
IDS = sorted(CORPUS)


def _functions(mod_C, src):
    try:
        return mod_C.parse(src).funcs
    except (mod_C.ParseError, mod_C.LexError):
        return []


def _rd_plain(rd):
    order = {nid: i for i, nid in enumerate(rd.defs_by_id)}
    defs = [(d.var, d.compound, plain(v)) for d, v in rd.defs_by_id.values()]
    block_in = {bid: sorted((d.var, order[d.node_id], d.compound)
                            for d in s)
                for bid, s in rd.block_in.items()}
    return defs, block_in


def _function_facts(cfg_mod, df_mod, C_mod, func):
    """Everything the CFG and dataflow passes say about one function."""
    ctxs = [(plain(c.stmt), c.order, plain(c.loops), c.guard_div, c.dead,
             c.cond_depth, c.depth) for c in cfg_mod.walk_contexts(func)]
    nests = cfg_mod.loop_nests(func)
    g = cfg_mod.build_cfg(func)
    blocks = [(b.bid, plain(b.stmts), list(b.succs)) for b in g.blocks]
    rd = df_mod.ReachingDefs(g)
    loop_vars = {lp.var: lp.step for lp in nests}
    all_vars = {lp.var for lp in nests if lp.bound in df_mod.NPROC_NAMES}
    env = df_mod.TaintEnv(all_vars)
    per_var = {}
    for var in sorted({d.var for d, _ in rd.defs_by_id.values()}):
        per_var[var] = df_mod.classify_offset(
            C_mod.Ident(line=0, name=var), rd, loop_vars)
    values = [(df_mod.eval_taint(v, env), sorted(df_mod.free_idents(v)),
               plain(df_mod.calls_in(v)))
              for _, v in rd.defs_by_id.values()]
    return {"contexts": ctxs, "nests": plain(nests), "blocks": blocks,
            "entry": g.entry, "exit": g.exit, "rd": _rd_plain(rd),
            "offsets": per_var, "values": values}


@pytest.mark.parametrize("name", IDS)
def test_tokens_and_ast_match_reference(name):
    src = CORPUS[name]
    assert outcome(tlexer.tokenize, src) == outcome(jlexer.tokenize, src)
    assert outcome(C.parse, src) == outcome(jC.parse, src)
    assert staticlib.looks_like_c(src) == jstaticlib.looks_like_c(src)


@pytest.mark.parametrize("name", IDS)
def test_cfg_and_dataflow_match_reference(name):
    src = CORPUS[name]
    t_funcs, j_funcs = _functions(C, src), _functions(jC, src)
    assert len(t_funcs) == len(j_funcs)
    for tf, jf in zip(t_funcs, j_funcs):
        assert _function_facts(tcfg, tdf, C, tf) == \
            _function_facts(jcfg, jdf, jC, jf), tf.name


@pytest.mark.parametrize("name", IDS)
def test_analyze_source_matches_reference(name):
    src = CORPUS[name]
    got = outcome(staticlib.analyze_source, src)
    assert got == outcome(jstaticlib.analyze_source, src)
    if got[0] != "ok":
        assert got[0] == "StaticAnalysisError"


def test_corpus_covers_both_engines():
    """The corpus holds sources the AST engine takes and sources it
    refuses (job files, scripts), so both sides of ``auto`` are held."""
    kinds = {outcome(staticlib.analyze_source, CORPUS[n])[0] for n in IDS}
    assert kinds == {"ok", "StaticAnalysisError"}


# ---------------------------------------------------------------------------
# the reference's staticlib cases (tests/test_staticlib.py) on the port
# ---------------------------------------------------------------------------
def test_lexer_skips_comments_and_preproc():
    toks = tokenize('/* shared */ #define X 1\nint a = 2; // shared\n')
    texts = [t.text for t in toks]
    assert "shared" not in texts and texts[:3] == ["int", "a", "="]


def test_lexer_rejects_shell_chars():
    with pytest.raises(LexError):
        tokenize("numjobs=${NJOBS}")


def test_parser_function_shape():
    prog = C.parse(_SNIPPETS["parser-shape"])
    assert [fn.name for fn in prog.funcs] == ["f"]
    assert [p.name for p in prog.funcs[0].params] == ["rank", "n"]


def test_parser_rejects_ini():
    with pytest.raises(C.ParseError):
        C.parse("rw=write\nbs=4m\nnumjobs=${NJOBS}\n")
    assert not staticlib.looks_like_c("[global]\nrw=randread\n")


def test_walk_contexts_marks_dead_and_guards():
    func = C.parse(_DEAD_SRC).funcs[0]
    by_kind = {}
    for ctx in walk_contexts(func):
        if isinstance(ctx.stmt, C.Decl):
            by_kind[ctx.stmt.name] = ctx
    assert not by_kind["live"].dead
    assert by_kind["dead_var"].dead
    assert not by_kind["then_live"].dead
    assert by_kind["else_dead"].dead
    stat_ctx = next(ctx for ctx in walk_contexts(func)
                    if isinstance(ctx.stmt, C.ExprStmt)
                    and isinstance(ctx.stmt.expr, C.Call)
                    and ctx.stmt.expr.name == "stat")
    assert stat_ctx.guard_div == 8 and stat_ctx.depth == 1


def test_cfg_excludes_dead_branches():
    func = C.parse(_DEAD_SRC).funcs[0]
    cfg = build_cfg(func)
    decls = [s.name for s in cfg.iter_stmts() if isinstance(s, C.Decl)]
    assert "dead_var" not in decls and "else_dead" not in decls
    assert "live" in decls and "then_live" in decls


def test_loop_nest_trip_counts():
    func = C.parse(_SNIPPETS["loop-nest"]).funcs[0]
    loops = {lp.var: lp for lp in loop_nests(func)}
    assert loops["i"].trip == 32 and loops["i"].depth == 1
    assert loops["j"].trip is None and loops["j"].trip_sym == "n"
    assert loops["j"].depth == 2


def _expr(src):
    prog = C.parse("void t(int rank, int np) { x = %s; }" % src)
    stmt = prog.funcs[0].body.stmts[0]
    return stmt.expr.value


@pytest.mark.parametrize("src,taint", [
    ("rank", TAINT_SELF), ("rank + 1", TAINT_OTHER),
    ("(rank + 1) % np", TAINT_OTHER), ("rank % np", TAINT_SELF),
    ("r_all", TAINT_ALL), ("nblk * 4", TAINT_NONE)])
def test_taint_lattice_rules(src, taint):
    assert eval_taint(_expr(src), TaintEnv({"r_all"})) == taint
    assert "myrank" in RANK_NAMES


def test_taint_survives_loop_init_rebinding():
    env = TaintEnv({"r"})
    env.set("r", TAINT_NONE)
    assert env.get("r") == TAINT_ALL


def test_reaching_defs_compound_not_killed():
    func = C.parse(_SNIPPETS["reaching"]).funcs[0]
    rd = ReachingDefs(build_cfg(func))
    defs = rd.reaching("off")
    assert any(d.compound for d, _ in defs)
    assert any(not d.compound for d, _ in defs)
    pattern, _ = classify_offset(C.Ident(line=0, name="off"), rd, {"i": "1"})
    assert pattern == "seq"


def test_classify_offset_strided_and_random():
    func = C.parse(_SNIPPETS["strided-random"]).funcs[0]
    rd = ReachingDefs(build_cfg(func))
    assert classify_offset(C.Ident(line=0, name="off"), rd, {})[0] == \
        "strided"
    assert classify_offset(C.Ident(line=0, name="roff"), rd, {})[0] == \
        "random"


def test_analyzer_corpus_facts():
    f = staticlib.analyze_source(workload_by_name("IOR-A").source_code)
    assert f.engine == "ast"
    assert f.rank_indexed_files and f.topology_hint == "N-N"
    assert f.access_pattern == "seq" and f.direction_hint == "write"
    f = staticlib.analyze_source(workload_by_name("IOR-B").source_code)
    assert f.shared_file and f.collective_io and f.topology_hint == "N-1"
    assert f.access_pattern == "strided" and not f.cross_rank_read
    f = staticlib.analyze_source(workload_by_name("HACC-B").source_code)
    assert f.cross_rank_read
    f = staticlib.analyze_source(workload_by_name("MDTEST-A").source_code)
    assert f.dir_pattern == "unique" and f.meta_intensity == "high"
    assert f.phase_pattern == "create_then_stat"


@pytest.mark.parametrize("name", ["FIO-A", "FIO-C", "FIO-D", "FIO-E50"])
def test_fio_sources_reject_and_fall_back(name):
    w = workload_by_name(name)
    with pytest.raises(staticlib.StaticAnalysisError):
        staticlib.analyze_source(w.source_code)
    with pytest.raises(staticlib.StaticAnalysisError):
        extract_static(w.source_code, w.job_script, engine="ast")
    assert extract_static(w.source_code, w.job_script,
                          engine="auto").engine == "regex"
    hw = heterogeneous_workload()
    assert extract_static(hw.source_code, hw.job_script).engine == "regex"


_DIFF_FIELDS = [
    "rank_indexed_files", "shared_file", "collective_io", "access_pattern",
    "direction_hint", "cross_rank_read", "meta_intensity", "create_heavy",
    "small_requests", "tiny_requests", "latency_sensitive", "multi_phase",
    "phase_pattern", "dir_pattern", "topology_hint", "has_data_calls",
    "n_nodes", "ppn",
]


@pytest.mark.parametrize("w", WS, ids=lambda w: w.name)
def test_differential_refinement_compatible(w):
    rx = extract_static(w.source_code, w.job_script, engine="regex")
    au = extract_static(w.source_code, w.job_script, engine="auto")
    for fld in _DIFF_FIELDS:
        a, b = getattr(rx, fld), getattr(au, fld)
        if fld == "access_pattern" and a == "unknown":
            assert b in ("unknown", "seq", "strided"), (w.name, b)
            continue
        assert a == b, f"{w.name}.{fld}: regex={a!r} ast={b!r}"


@pytest.mark.parametrize("w", WS, ids=lambda w: w.name)
def test_decisions_identical_across_engines(w):
    rx = select_layout(w, use_runtime=False, static_engine="regex")
    au = select_layout(w, use_runtime=False, static_engine="auto")
    assert rx.mode == au.mode


@pytest.mark.parametrize("w", WS + ADV, ids=lambda w: w.name)
def test_provenance_covers_decided_features(w):
    f = extract_static(w.source_code, w.job_script)
    ev = f.provenance_dict()
    assert ev
    for entry in ev.values():
        assert entry["rule"] and entry["tier"] in TIER_CONFIDENCE
    assert "topology_hint" in ev


def test_golden_provenance_ior_a():
    w = workload_by_name("IOR-A")
    ev = extract_static(w.source_code, w.job_script).provenance_dict()
    assert ev["rank_indexed_files"]["rule"] == "taint-name-self"
    assert ev["rank_indexed_files"]["tier"] == "ast-dataflow"
    assert ev["topology_hint"]["value"] == "N-N"
    assert ev["access_pattern"]["rule"] == "rd-offset-evolution"
    assert ev["access_pattern"]["site"] == "write_phase:8"
    assert ev["create_heavy"]["rule"] == "creat-or-ocreat"
    assert ev["dir_pattern"]["tier"] == "default"


def test_golden_provenance_hacc_a():
    w = workload_by_name("HACC-A")
    ev = extract_static(w.source_code, w.job_script).provenance_dict()
    assert ev["shared_file"]["rule"] == "mpi-collective-data"
    assert ev["topology_hint"]["value"] == "N-1"
    assert ev["collective_io"]["rule"] == "mpi-collective-call"
    assert ev["direction_hint"]["site"] == "hacc_checkpoint:5"


def test_golden_provenance_mdtest_a():
    w = workload_by_name("MDTEST-A")
    ev = extract_static(w.source_code, w.job_script).provenance_dict()
    assert ev["meta_intensity"]["rule"] == "loop-meta-density"
    assert ev["dir_pattern"]["value"] == "unique"
    assert ev["phase_pattern"]["value"] == "create_then_stat"
    assert ev["cross_rank_read"]["rule"] == "flag-mdtest-N-shift"
    assert ev["cross_rank_read"]["tier"] == "script"


def test_confidence_weighted_topology_merge():
    from repro_torch.core.intent.context import ContextPack, HybridContext
    from repro_torch.core.intent.probe import run_probe
    assert ContextPack is HybridContext
    w = workload_by_name("HACC-A")
    static = extract_static(w.source_code, w.job_script)
    assert static.confidence("topology_hint") >= 0.8
    ctx = HybridContext(app=w.app, static=static,
                        runtime=run_probe(w, seed=0), n_nodes=w.n_nodes)
    assert ctx.topology == "N-1"
    fio = workload_by_name("FIO-E50")
    weak = extract_static(fio.source_code, fio.job_script)
    assert weak.confidence("topology_hint") < 0.8
    ctx2 = HybridContext(app="FIO", static=weak,
                         runtime=run_probe(fio, seed=0), n_nodes=32)
    assert ctx2.topology == "N-1"


def _features_tuple(mod, src):
    f = mod.analyze_source(src)
    return tuple(getattr(f, fld) for fld in _DIFF_FIELDS[:16])


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, len(_PAYLOADS) - 1), min_size=0,
                max_size=5))
def test_dead_code_never_changes_features(picks):
    """Dead code under ``if (0)`` is invisible to the port's engine, and
    the port's features equal the reference's on every mix."""
    baseline = _features_tuple(staticlib,
                               _LIVE_TEMPLATE.replace("PAYLOAD", ";"))
    payload = "\n".join("    " + _PAYLOADS[i] for i in picks) or ";"
    src = _LIVE_TEMPLATE.replace("PAYLOAD", payload)
    assert _features_tuple(staticlib, src) == baseline
    assert _features_tuple(staticlib, src) == _features_tuple(jstaticlib, src)


@pytest.mark.parametrize("engine", ["auto", "regex"])
def test_original_accuracy_pins_both_engines(engine):
    assert suite_accuracy(WS, static_engine=engine) == (21, 23)


def test_ast_strictly_beats_regex_on_adversarial():
    ast_c, t = suite_accuracy(ADV, use_runtime=False, static_engine="auto")
    rx_c, _ = suite_accuracy(ADV, use_runtime=False, static_engine="regex")
    assert t == 6 and ast_c == 6 and rx_c == 0


def test_adversarial_feature_recovery():
    by_id = {w.test_id: w for w in ADV}
    f = staticlib.analyze_source(by_id["A"].source_code)
    assert not f.collective_io and not f.shared_file
    assert f.rank_indexed_files and f.topology_hint == "N-N"
    f = staticlib.analyze_source(by_id["B"].source_code)
    assert f.direction_hint == "write" and f.access_pattern == "seq"
    f = staticlib.analyze_source(by_id["C"].source_code)
    assert not f.shared_file and f.rank_indexed_files
    f = staticlib.analyze_source(by_id["D"].source_code)
    assert f.meta_intensity == "medium"
    f = staticlib.analyze_source(by_id["E"].source_code)
    assert not f.shared_file and f.topology_hint == "N-N"
    f = staticlib.analyze_source(by_id["F"].source_code)
    assert f.cross_rank_read and f.phase_pattern == "write_then_read"
