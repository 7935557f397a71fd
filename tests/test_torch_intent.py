"""The port's Proteus decision pipeline (repro_torch.core.workloads and
repro_torch.core.intent) against the JAX package's, workload by workload:
the ``Workload`` itself, the probe's counters, static extraction on each
engine, the hybrid context's JSON, the Fig-6 prompt, ``select_layout``
under the four ablation settings (mode, confidence, reasoning steps,
prompt, context JSON, the per-scope plan and its policy), a backend's
decision JSON parsed back, the oracle and the suite accuracies, and the
GBDT baseline's leave-one-out accuracy; then the probe's engine replay
through the port's client on the CPU against the reference's replay; then
the reference's own intent cases run on the port.

Every comparison is exact (``==`` on strings, ints and floats): the
pipeline is host arithmetic on both sides, numpy where the reference uses
numpy.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.client import BBClient as JBBClient
from repro.core.intent import probe as jprobe
from repro.core.intent.context import HybridContext as JHybridContext
from repro.core.intent.ml_baseline import loo_accuracy as j_loo_accuracy
from repro.core.intent.oracle import oracle_mode as j_oracle_mode
from repro.core.intent.oracle import oracle_policy as j_oracle_policy
from repro.core.intent.oracle import oracle_table as j_oracle_table
from repro.core.intent.oracle import suite_accuracy as j_suite_accuracy
from repro.core.intent.prompt import build_prompt as j_build_prompt
from repro.core.intent.reasoner import ExternalLLMBackend as JExternal
from repro.core.intent.reasoner import KnowledgeReasoner as JReasoner
from repro.core.intent.reasoner import \
    KnowledgeReasonerBackend as JReasonerBackend
from repro.core.intent.reasoner import parse_decision as j_parse_decision
from repro.core.intent.selector import select_layout as j_select_layout
from repro.core.intent.static_extractor import \
    extract_static as j_extract_static
from repro.core.workloads import adversarial_workloads as j_adversarial
from repro.core.workloads import build_workloads as j_build
from repro.core.workloads import heterogeneous_workload as j_hetero
from repro.core.workloads import workload_by_name as j_workload_by_name
from repro_torch.core.client import BBClient
from repro_torch.core.intent import probe as tprobe
from repro_torch.core.intent.context import HybridContext
from repro_torch.core.intent.ml_baseline import (GBDTClassifier, featurize,
                                                 loo_accuracy)
from repro_torch.core.intent.oracle import (oracle_mode, oracle_policy,
                                            oracle_table, suite_accuracy)
from repro_torch.core.intent.probe import run_probe
from repro_torch.core.intent.prompt import build_prompt
from repro_torch.core.intent.reasoner import (CONFIDENCE_FALLBACK,
                                              ExternalLLMBackend,
                                              KnowledgeReasoner,
                                              KnowledgeReasonerBackend,
                                              parse_decision)
from repro_torch.core.intent.selector import select_layout
from repro_torch.core.intent.static_extractor import extract_static
from repro_torch.core.layouts import DEFAULT_MODE, LayoutMode
from repro_torch.core.workloads import (adversarial_workloads,
                                        build_workloads,
                                        heterogeneous_workload,
                                        workload_by_name)
from test_torch_staticlib import outcome, plain

ROOT = Path(__file__).resolve().parents[1]
SCALES = (8, 32, 64)
#: the four settings of tests/test_intent.py's accuracy and ablation pins
SETTINGS = {"full": {}, "wo-runtime": {"use_runtime": False},
            "wo-appref": {"use_app_ref": False},
            "wo-modeknow": {"use_mode_know": False}}
PINNED_ACCURACY = {"full": 21, "wo-runtime": 20, "wo-appref": 19,
                   "wo-modeknow": 15}


def _suite(build, adversarial, hetero):
    out = {}
    for n in SCALES:
        out.update({f"{w.name}@{n}": w for w in build(n)})
    out.update({f"{w.name}@32": w for w in adversarial(32)})
    w = hetero(32)
    out[f"{w.name}@32"] = w
    return out


T_SUITE = _suite(build_workloads, adversarial_workloads,
                 heterogeneous_workload)
J_SUITE = _suite(j_build, j_adversarial, j_hetero)
IDS = list(J_SUITE)


def test_suites_hold_the_same_workloads():
    assert list(T_SUITE) == IDS
    assert len(IDS) == 3 * 23 + 6 + 1


@pytest.mark.parametrize("wid", IDS)
def test_workload_matches_reference(wid):
    t, j = T_SUITE[wid], J_SUITE[wid]
    assert plain(t) == plain(j)
    assert t.name == j.name


@pytest.mark.parametrize("wid", IDS)
def test_probe_counters_match_reference(wid):
    t, j = T_SUITE[wid], J_SUITE[wid]
    for seed in range(4):
        a, b = run_probe(t, seed=seed), jprobe.run_probe(j, seed=seed)
        assert a.to_darshan_dict() == b.to_darshan_dict()
        assert plain(a) == plain(b)
        assert (a.read_ratio, a.meta_share) == (b.read_ratio, b.meta_share)


@pytest.mark.parametrize("wid", IDS)
def test_extract_static_matches_reference_on_each_engine(wid):
    t, j = T_SUITE[wid], J_SUITE[wid]
    for engine in ("auto", "ast", "regex"):
        got = outcome(extract_static, t.source_code, t.job_script, engine)
        assert got == outcome(j_extract_static, j.source_code,
                              j.job_script, engine), engine
        if got[0] == "ok" and engine != "auto":
            assert got[1][1]["engine"] == engine
        elif got[0] != "ok":
            assert engine == "ast" and got[0] == "StaticAnalysisError"


@pytest.mark.parametrize("wid", IDS)
def test_context_json_and_prompt_match_reference(wid):
    t, j = T_SUITE[wid], J_SUITE[wid]
    ts = extract_static(t.source_code, t.job_script)
    js = j_extract_static(j.source_code, j.job_script)
    for runtime in (True, False):
        tc = HybridContext(t.app, ts, run_probe(t) if runtime else None,
                           t.n_nodes)
        jc = JHybridContext(j.app, js,
                            jprobe.run_probe(j) if runtime else None,
                            j.n_nodes)
        assert tc.to_json() == jc.to_json()
        if runtime:
            assert '"evidence"' in tc.to_json()
        for app_ref in (True, False):
            for mode_know in (True, False):
                assert build_prompt(tc, use_app_ref=app_ref,
                                    use_mode_know=mode_know) == \
                    j_build_prompt(jc, use_app_ref=app_ref,
                                   use_mode_know=mode_know)


def _decision_view(d, n_nodes):
    return {"workload": d.workload, "mode": int(d.mode),
            "confidence": d.confidence, "decision": plain(d.decision),
            "decision_json": d.decision.to_json(), "prompt": d.prompt,
            "context_json": d.context_json,
            "scope_modes": {k: int(v) for k, v in d.scope_modes.items()},
            "scope_decisions": plain(d.scope_decisions),
            "params": plain(d.layout_params(n_nodes)),
            "policy": plain(d.layout_policy(n_nodes))}


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("wid", IDS)
def test_select_layout_matches_reference(wid, setting):
    t, j = T_SUITE[wid], J_SUITE[wid]
    kw = SETTINGS[setting]
    td, jd = select_layout(t, **kw), j_select_layout(j, **kw)
    assert isinstance(td.mode, LayoutMode)
    assert _decision_view(td, t.n_nodes) == _decision_view(jd, j.n_nodes)


@pytest.mark.parametrize("wid", IDS)
def test_backend_decisions_parse_like_reference(wid):
    """A backend's decision JSON (the knowledge reasoner behind the
    ``LLMBackend`` interface, and an injected callable behind
    ``ExternalLLMBackend``) parses to the reference's ``Decision`` and
    decides the same layout through ``select_layout``."""
    t, j = T_SUITE[wid], J_SUITE[wid]
    tc = HybridContext(t.app, extract_static(t.source_code, t.job_script),
                       run_probe(t), t.n_nodes)
    jc = JHybridContext(j.app, j_extract_static(j.source_code,
                                                j.job_script),
                        jprobe.run_probe(j), j.n_nodes)
    tb = KnowledgeReasonerBackend(KnowledgeReasoner(), tc)
    jb = JReasonerBackend(JReasoner(), jc)
    prompt = build_prompt(tc)
    assert tb.complete(prompt) == jb.complete(prompt)
    chatter = "Reasoning done.\n" + tb.complete(prompt) + "\nEnd."
    assert plain(parse_decision(chatter)) == \
        plain(j_parse_decision(chatter))
    prompts = []

    def answer(p):
        prompts.append(p)
        return jb.complete(p)

    td = select_layout(t, backend=ExternalLLMBackend(answer))
    jd = j_select_layout(j, backend=JExternal(jb.complete))
    assert _decision_view(td, t.n_nodes) == _decision_view(jd, j.n_nodes)
    assert prompts[0] == td.prompt


@pytest.mark.parametrize("n", SCALES)
def test_oracle_table_matches_reference(n):
    t = {k: int(v) for k, v in oracle_table(n).items()}
    assert t == {k: int(v) for k, v in j_oracle_table(n).items()}
    assert len(t) == 23


def test_oracle_policy_of_heterogeneous_matches_reference():
    for n in SCALES:
        assert plain(oracle_policy(heterogeneous_workload(n))) == \
            plain(j_oracle_policy(j_hetero(n)))
        assert int(oracle_mode(heterogeneous_workload(n))) == \
            int(j_oracle_mode(j_hetero(n)))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_suite_accuracy_matches_reference_and_paper(setting):
    kw = SETTINGS[setting]
    got = suite_accuracy(build_workloads(32), **kw)
    assert got == j_suite_accuracy(j_build(32), **kw)
    assert got == (PINNED_ACCURACY[setting], 23)


@pytest.mark.parametrize("n", SCALES)
def test_suite_accuracy_matches_reference_at_each_scale(n):
    for engine in ("auto", "regex"):
        assert suite_accuracy(build_workloads(n), static_engine=engine) == \
            j_suite_accuracy(j_build(n), static_engine=engine)


def test_adversarial_and_heterogeneous_decisions():
    t_adv = [int(select_layout(w).mode) == int(oracle_mode(w))
             for w in adversarial_workloads(32)]
    assert t_adv == [True] * 6
    d = select_layout(heterogeneous_workload(32))
    assert {k: int(v) for k, v in d.scope_modes.items()} == \
        {"/bb/ckpt": int(LayoutMode.NODE_LOCAL),
         "/bb/shared": int(LayoutMode.HYBRID)}
    assert d.mode == LayoutMode.HYBRID


def test_low_confidence_falls_back_to_mode3():
    """tests/test_intent.py's FIO-E50 case, and the fallback rule itself:
    every decision below ``CONFIDENCE_FALLBACK`` lands on the fail-safe
    mode with ``fallback_applied``, as the reference's does."""
    d = select_layout(workload_by_name("FIO-E50"))
    jd = j_select_layout(j_workload_by_name("FIO-E50"))
    assert d.mode == LayoutMode.DIST_HASH
    assert (d.confidence, d.decision.fallback_applied) == \
        (jd.confidence, jd.decision.fallback_applied)
    for wid in IDS:
        for kw in SETTINGS.values():
            dec = select_layout(T_SUITE[wid], **kw).decision
            if dec.fallback_applied:
                assert dec.mode == DEFAULT_MODE
                assert dec.confidence < CONFIDENCE_FALLBACK
                assert "fallback to Mode 3" in dec.steps[-1]


def test_loo_accuracy_matches_reference():
    acc, rows = loo_accuracy()
    jacc, jrows = j_loo_accuracy()
    assert acc == jacc
    assert [(n, int(p), int(t)) for n, p, t in rows] == \
        [(n, int(p), int(t)) for n, p, t in jrows]


def test_chip_smoke_decision_matrix_pinned_to_reference():
    """chip_smoke.py pins the 23 whole-job decisions and the four
    accuracies (phase h); the pins are the JAX package's."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = {w.name: (int(d.mode), d.confidence)
            for w in j_build(32) for d in [j_select_layout(w)]}
    assert smoke.DECISIONS == want
    assert smoke.ACCURACY == {k: (v, 23) for k, v in PINNED_ACCURACY.items()}
    assert smoke.HETERO_PLAN == (
        {k: int(v) for k, v in j_select_layout(j_hetero(32))
         .scope_modes.items()},
        int(j_select_layout(j_hetero(32)).mode))


# ---------------------------------------------------------------------------
# the probe's engine replay through the port's client on the CPU
# ---------------------------------------------------------------------------
class _Recorder:
    """Records every write and read of a client class while active: the
    read's outputs and the node tables after each call, as numpy."""

    def __init__(self, monkeypatch, cls, state_arrays):
        self.calls = []
        for name in ("write", "read"):
            real = getattr(cls, name)

            def wrapped(client, req, *a, _real=real, _name=name, **kw):
                out = _real(client, req, *a, **kw)
                got = ([np.array(x) for x in out] if _name == "read"
                       else [])
                self.calls.append((_name, got,
                                   state_arrays(client.state)))
                return out
            monkeypatch.setattr(cls, name, wrapped)


def _t_state(s):
    # copies: the port's node tables change in place on later calls
    return [np.array(getattr(s, f.name)) for f in dataclasses.fields(s)]


def _j_state(s):
    return [np.array(a) for a in s.tree_flatten()[0]]


@pytest.mark.parametrize("name", ["IOR-A", "IOR-C", "FIO-D", "FIO-E90",
                                  "MDTEST-A", "MDTEST-D", "HETERO"])
def test_probe_engine_replay_on_cpu_matches_reference(name, monkeypatch):
    """``run_probe(through_engine=True, device="cpu")``: the counters are
    the shim's (the replay changes none), and the replay's writes and reads
    through the port's client give the reference replay's outputs and node
    tables call for call (unwritten keys read back not found)."""
    torch.set_num_threads(2)
    if name == "HETERO":
        t, j = heterogeneous_workload(32), j_hetero(32)
    else:
        t, j = workload_by_name(name), j_workload_by_name(name)
    trec = _Recorder(monkeypatch, BBClient, _t_state)
    jrec = _Recorder(monkeypatch, JBBClient, _j_state)
    for seed in (0, 1):
        rs = run_probe(t, seed=seed, through_engine=True, device="cpu")
        assert rs.to_darshan_dict() == run_probe(t, seed=seed) \
            .to_darshan_dict()
        assert plain(rs) == plain(jprobe.run_probe(j, seed=seed,
                                                   through_engine=True))
    assert len(trec.calls) == len(jrec.calls) == \
        2 * min(2, len(t.phases))
    for (tk, tout, tst), (jk, jout, jst) in zip(trec.calls, jrec.calls):
        assert tk == jk
        assert len(tout) == len(jout)
        for a, b in zip(tout + tst, jout + jst):
            np.testing.assert_array_equal(a, b)


def test_probe_engine_replay_defaults_to_the_card(monkeypatch):
    """Without ``device`` the replay's client asks for CUDA: with no card
    it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_probe(workload_by_name("IOR-A"), through_engine=True)
    assert tprobe.PROBE_SCALE == jprobe.PROBE_SCALE


# ---------------------------------------------------------------------------
# the reference's intent cases (tests/test_intent.py) on the port
# ---------------------------------------------------------------------------
def test_static_extractor_ior_fpp():
    w = workload_by_name("IOR-A")
    f = extract_static(w.source_code, w.job_script)
    assert f.rank_indexed_files and f.topology_hint == "N-N"
    assert f.access_pattern == "seq" and f.direction_hint == "write"
    assert f.n_nodes == 32


def test_static_extractor_shared_collective():
    w = workload_by_name("HACC-A")
    f = extract_static(w.source_code, w.job_script)
    assert f.collective_io and f.topology_hint == "N-1"


def test_static_extractor_mdtest_flags():
    a = workload_by_name("MDTEST-A")
    fa = extract_static(a.source_code, a.job_script)
    assert fa.dir_pattern == "unique" and fa.cross_rank_read
    b = workload_by_name("MDTEST-B")
    assert extract_static(b.source_code, b.job_script).dir_pattern == \
        "shared"
    c = workload_by_name("MDTEST-C")
    assert extract_static(c.source_code, c.job_script).dir_pattern == "deep"


@pytest.mark.parametrize("name", ["IOR-B", "HACC-A", "HACC-B", "MAD-A"])
def test_shared_file_needs_real_evidence(name):
    from repro_torch.core.intent.static_extractor import \
        extract_source_features
    f = extract_source_features(
        "void r(MPI_File fh) { MPI_File_read(fh, buf, n, MPI_BYTE, &st); }")
    assert not f.shared_file
    w = workload_by_name(name)
    for engine in ("regex", "auto"):
        assert extract_static(w.source_code, w.job_script,
                              engine=engine).shared_file, engine


def test_phase_order_from_structure_not_substring():
    from repro_torch.core.intent.static_extractor import \
        extract_source_features
    rw = extract_source_features(
        "void m(int fd) { pwrite(fd, b, n, 0); pread(fd, b, n, 0); }")
    assert rw.multi_phase and rw.phase_pattern == "write_then_read"
    wr = extract_source_features(
        "void m(int fd) { pread(fd, b, n, 0); pwrite(fd, b, n, 0); }")
    assert not wr.multi_phase and wr.phase_pattern == "single"
    prose = extract_source_features(
        "/* writers wrote previously */"
        " void m(int fd) { pread(fd, b, n, 0); }")
    assert prose.direction_hint == "read" and not prose.multi_phase
    d = workload_by_name("FIO-D")
    fd = extract_static(d.source_code, d.job_script, engine="regex")
    assert fd.multi_phase and fd.phase_pattern == "write_then_read"


def test_probe_counters_reflect_phases():
    rs = run_probe(workload_by_name("FIO-E90"))
    assert 0.85 <= rs.read_ratio <= 0.95 and rs.shared_file_ops > 0
    rs2 = run_probe(workload_by_name("MDTEST-B"))
    assert rs2.meta_share > 0.9 and rs2.meta_mix.get("create", 0) > 0.3


def test_probe_deterministic():
    w = workload_by_name("IOR-A")
    assert run_probe(w, seed=3).to_darshan_dict() == \
        run_probe(w, seed=3).to_darshan_dict()


def test_hybrid_context_json_fig5_fields():
    w = workload_by_name("IOR-C")
    ctx = HybridContext(w.app, extract_static(w.source_code, w.job_script),
                        run_probe(w), w.n_nodes)
    d = json.loads(ctx.to_json())
    assert "bench_params" in d and "static_features" in d
    assert "posix_bytes_written" in d["runtime_stats"]


def test_prompt_contains_fig6_structure():
    w = workload_by_name("HACC-B")
    ctx = HybridContext(w.app, extract_static(w.source_code, w.job_script),
                        run_probe(w), w.n_nodes)
    p = build_prompt(ctx)
    for frag in ("### Knowledge Base", "### Application Context",
                 "### Hybrid Context", "### Reasoning Requirements",
                 "Select exactly one from [Mode 1, Mode 2, Mode 3, Mode 4]"):
        assert frag in p
    assert "withheld" in build_prompt(ctx, use_mode_know=False)


def test_decision_record_complete():
    d = select_layout(workload_by_name("IOR-A"))
    assert d.mode == LayoutMode.NODE_LOCAL and d.confidence > 0.9
    assert len(d.decision.steps) >= 4
    parsed = json.loads(d.decision.to_json())
    assert parsed["selected_mode"] == "Mode 1"
    assert "risk_analysis" in parsed


def test_gbdt_baseline_learns_something():
    ws = build_workloads(32)
    X = np.stack([featurize(run_probe(w), w.n_nodes) for w in ws])
    y = np.array([int(oracle_mode(w)) for w in ws])
    clf = GBDTClassifier(n_rounds=20).fit(X, y)
    assert np.mean([clf.predict(x) == t for x, t in zip(X, y)]) > 0.9
