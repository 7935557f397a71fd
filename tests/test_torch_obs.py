"""The port's flight recorder (repro_torch.core.obs) against the JAX
package's: recorder primitives, metrics, audit routing, export and
provenance, the audit records of ``exchange_select``, and a traced
client's span trees, byte counters and gauges against a traced JAX client
on the same calls; ``tools/bbstat.py`` reads a capture of the port.

The reference's ``cat="trace"`` spans fire while jax traces, i.e. on the
first call of a jit specialization; the port's fire on every call.  So the
span trees are compared on calls that the JAX client traces afresh (its
jit caches are cleared first), and span counts of repeated calls are not
compared.  Everything compared is compared for equality (names, depths,
counters, audit choices and inputs); only durations differ.
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro.core import client as jclient_mod
from repro.core import exchange_select as jxs
from repro.core import obs as jobs
from repro.core.adapt import AdaptConfig as JAdaptConfig
from repro.core.adapt import AdaptationController as JController
from repro.core.adapt import DriftConfig as JDriftConfig
from repro.core.adapt import LiveMigrator as JLiveMigrator
from repro.core.client import BBClient as JBBClient
from repro.core.policy import LayoutPolicy as JLayoutPolicy
from repro_torch.core import burst_buffer as bb
from repro_torch.core import exchange_select as xs
from repro_torch.core import obs
from repro_torch.core.adapt import (AdaptConfig, AdaptationController,
                                    DriftConfig, LiveMigrator)
from repro_torch.core.client import BBClient
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCOPES = {"/bb/ckpt": LayoutMode.HYBRID, "/bb/shared": LayoutMode.DIST_HASH}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes: a thread per core only spins against JAX's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# recorder primitives
# ---------------------------------------------------------------------------
def test_span_nesting_depth_and_activation():
    rec = obs.TraceRecorder()
    assert obs.current_recorder() is None
    with obs.activate(rec):
        assert obs.current_recorder() is rec
        with obs.span("outer", cat="t"):
            with obs.span("inner", cat="t", k=1):
                pass
    assert obs.current_recorder() is None
    names = {s.name: s for s in rec.spans}
    out, inn = names["outer"], names["inner"]
    assert (out.depth, inn.depth, inn.args["k"]) == (0, 1, 1)
    assert out.ts_us <= inn.ts_us
    assert inn.ts_us + inn.dur_us <= out.ts_us + out.dur_us + 1e-6


def test_span_without_active_recorder_is_inert():
    t = torch.zeros(3)
    with obs.span("nothing", cat="t") as h:
        h.set(k=2)
        assert h.fence(t) is t
    assert obs.current_recorder() is None
    assert len(obs.TraceRecorder().spans) == 0


def test_ring_buffer_drops_and_counts():
    rec = obs.TraceRecorder(capacity=4)
    with obs.activate(rec):
        for i in range(10):
            with obs.span(f"s{i}", cat="t"):
                pass
    assert rec.dropped_spans == 6
    assert [s.name for s in rec.spans] == ["s6", "s7", "s8", "s9"]


def test_span_bookkeeping_metrics_and_fence():
    rec = obs.TraceRecorder()
    with obs.activate(rec):
        for _ in range(3):
            with obs.span("x", cat="t") as h:
                h.fence({"a": (torch.ones(2), [bb.init_state(2, 1, 1, 1,
                                                             "cpu")])})
    assert rec.metrics.get("span_count_total", span="x") == 3
    assert rec.metrics.get("span_us_total", span="x") >= 0
    # the fence walks nests of tensors and dataclasses; CPU needs no wait
    assert list(obs.recorder._tensors(bb.init_state(2, 1, 1, 1, "cpu")))
    assert obs.block_on(None) is None


def test_metrics_and_audit_match_the_reference():
    for pkg in (obs, jobs):
        m = pkg.MetricsRegistry()
        m.inc("ops", op="write")
        m.inc("ops", 2, op="write")
        m.set_gauge("depth", 4.0, plane="data")
        for v in (0, 1, 3, 9, 0.5, 1e6):
            m.observe("lat", v)
    snaps = [pkg.MetricsRegistry() for pkg in (obs, jobs)]
    for m in snaps:
        m.inc("a", b=1, a=2)
        m.observe("h", 3, plane="x")
    assert snaps[0].snapshot() == snaps[1].snapshot()
    assert obs.metric_key("a", {"b": 1, "a": 2}) == \
        jobs.metric_key("a", {"b": 1, "a": 2})
    for args in ((10.0, 5.0, 2.0), (10.0, 12.0, 11.0), (3.0, 2.0, 1.0)):
        assert obs.overlap_efficiency(*args) == jobs.overlap_efficiency(*args)
    assert obs.EVIDENCE_GRADES == jobs.EVIDENCE_GRADES


def test_audit_ring_and_routing():
    rec = obs.TraceRecorder()
    with obs.activate(rec):
        obs.record_decision("kind_a", "x", inputs={"n": 1},
                            alternatives={"y": 2.0},
                            evidence={"grade": "measured"})
    assert rec.audit.counts() == {"kind_a": 1}
    r = rec.audit.records("kind_a")[0]
    assert r.choice == "x" and r.alternatives == {"y": 2.0}
    assert rec.metrics.get("decisions_total", kind="kind_a", choice="x") == 1
    before = len(obs.GLOBAL_AUDIT.records())
    obs.record_decision("kind_b", "z", evidence={"grade": "analytic"})
    assert len(obs.GLOBAL_AUDIT.records()) == before + 1
    small = obs.DecisionAudit(capacity=2)
    for i in range(3):
        small.record("k", str(i))
    assert [r.seq for r in small.records()] == [1, 2]


def test_trace_export_and_provenance(tmp_path):
    rec = obs.TraceRecorder()
    with obs.activate(rec):
        with obs.span("a", cat="t"):
            with obs.span("b", cat="t"):
                pass
    path = obs.write_recording(rec, tmp_path / "trace.json",
                               meta=obs.provenance_meta(warm_passes=1))
    d = json.loads(path.read_text())
    jrec = jobs.TraceRecorder()
    assert set(d) == set(jobs.recording_dict(jrec, meta={"x": 1}))
    for ev in d["traceEvents"]:
        assert ev["ph"] == "X"
        assert {"name", "cat", "ts", "dur", "pid", "tid", "args"} <= set(ev)
    assert [e["args"]["depth"] for e in d["traceEvents"]] == [1, 0]
    for key in obs.PROVENANCE_KEYS:
        assert key in d["meta"]
    assert d["meta"]["torch_version"] == torch.__version__
    assert d["meta"]["device_kind"] == (
        torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu")
    assert d["meta"]["warm_passes"] == 1


# ---------------------------------------------------------------------------
# exchange_select audit records
# ---------------------------------------------------------------------------
def _records(kind, rec):
    return [(r.choice, r.inputs, r.alternatives, r.evidence)
            for r in rec.audit.records(kind)]


def test_exchange_backend_audit_matches_the_reference():
    """Every pick's record, on 288 call shapes, through the auto path
    (fabric stump) and an explicit table (nearest cell).  Both packages'
    artifact caches are emptied first, so that each loads its tables
    inside the recording (its ``*_load`` counters compared too), whichever
    tests ran before in the process."""
    table = ((4, 8, 4, "dense"), (32, 64, 16, "compacted"),
             (8, 128, 64, "compacted"))
    xs.refresh()
    jxs.refresh()
    rec, jrec = obs.TraceRecorder(), jobs.TraceRecorder()
    shapes = [(n, q, w) for n in (1, 2, 4, 8, 16, 32, 64, 128)
              for q in (1, 4, 16, 64, 256, 1024) for w in (1, 16, 4096,
                                                           262144,
                                                           1 << 20, 3)]
    assert len(shapes) == 288
    with obs.activate(rec), jobs.activate(jrec):
        for n, q, w in shapes:
            assert xs.pick_backend(n, q, w) == jxs.pick_backend(n, q, w)
            assert xs.pick_backend(n, q, w, table) == \
                jxs.pick_backend(n, q, w, table)
    assert _records("exchange_backend", rec) == \
        _records("exchange_backend", jrec)
    assert rec.metrics.counters == jrec.metrics.counters


@pytest.mark.parametrize("case", ["missing", "malformed", "measured"])
def test_artifact_load_audits_match_the_reference(tmp_path, case):
    if case == "malformed":
        for name in ("BENCH_pr3.json", "BENCH_pr5.json"):
            (tmp_path / name).write_text("{not json")
    elif case == "measured":
        for name in ("BENCH_pr3.json", "BENCH_pr5.json"):
            (tmp_path / name).write_text((ROOT / name).read_text())
    root = str(tmp_path)
    rec, jrec = obs.TraceRecorder(), jobs.TraceRecorder()
    with obs.activate(rec), jobs.activate(jrec):
        assert xs.load_crossover(root) == jxs.load_crossover(root)
        assert xs.fabric_model(root) == jxs.fabric_model(root)
    xs.load_crossover.cache_clear()
    xs.fabric_model.cache_clear()
    jxs.load_crossover.cache_clear()
    jxs.fabric_model.cache_clear()
    for kind in ("crossover_load", "crossover_fallback", "fabric_load",
                 "fabric_fallback"):
        assert _records(kind, rec) == _records(kind, jrec), kind
    assert rec.audit.counts() == jrec.audit.counts()


# ---------------------------------------------------------------------------
# a traced client against a traced JAX client
# ---------------------------------------------------------------------------
def _fresh_jax_traces():
    """Make the JAX client trace (and so record its engine spans) anew."""
    for f in (jclient_mod._stacked_ops_for, jclient_mod._stacked_probe_for,
              jclient_mod._stacked_migrate_for):
        f.cache_clear()


def _traced_pair(n, **kw):
    default = kw.pop("default", 2)
    scopes = kw.pop("scopes", SCOPES)
    jrec, trec = jobs.TraceRecorder(), obs.TraceRecorder()
    jc = JBBClient(JLayoutPolicy.from_scopes(scopes, n_nodes=n,
                                             default=default),
                   trace=jrec, **kw)
    tc = BBClient(LayoutPolicy.from_scopes(scopes, n_nodes=n,
                                           default=default),
                  device="cpu", trace=trec, **kw)
    return jc, jrec, tc, trec


def _tree(rec, since):
    return [(s.name, s.cat, s.depth) for s in list(rec.spans)[since:]]


def _split_carry(tree):
    """(the tree without the carry rounds' spans, the spans each
    ``exchange.carry`` holds); children precede their parent in the ring."""
    out, rounds = [], []
    for span in tree:
        if span[0] == "exchange.carry":
            block = []
            while out and out[-1][2] > span[2]:
                block.insert(0, out.pop())
            rounds.append(block)
        out.append(span)
    return out, rounds


def _assert_same_tree(t_tree, j_tree, what):
    """The port's span tree is the reference's, but for the carry round:
    the reference traces it (and plans a pipelined one as a sibling
    ``exchange.carry.plan``) whether it runs or not; the port's
    ``exchange.carry`` holds the round's spans, ``exchange.carry.plan``
    first, only when it runs (``recorder.py``'s docstring).  Returns the
    number of carry rounds the port ran."""
    strip = [s for s in j_tree if s[0] != "exchange.carry.plan"]
    t_out, t_rounds = _split_carry(t_tree)
    j_out, j_rounds = _split_carry(strip)
    assert t_out == j_out, what
    ran = [t for t in t_rounds if t]
    for t, j in zip(t_rounds, j_rounds):
        if t:
            assert t[0][0] == "exchange.carry.plan", what
            assert t[1:] == j, what
    return len(ran)


def _calls(c, n, q, w, seed=0):
    rng = np.random.RandomState(seed)
    paths = [[(f"/bb/ckpt/r{i}/f{j % 2}", f"/bb/shared/g{j}",
               f"/o/x{i}-{j}")[j % 3] for j in range(q)] for i in range(n)]
    cid = rng.randint(0, 4, (n, q))
    pay = rng.randint(0, 999, (n, q, w))
    req = c.encode(paths, chunk_id=cid, payload=pay)
    rot = c.encode([paths[(i + 1) % n] for i in range(n)],
                   chunk_id=np.roll(cid, -1, axis=0))
    return (("write", lambda: c.write(req)), ("read", lambda: c.read(rot)),
            ("stat", lambda: c.stat(req)), ("remove", lambda: c.remove(req)))


@pytest.mark.parametrize("exchange,kw", [
    ("auto", {}), ("compacted", {}), ("compacted", {"pipeline": False}),
    ("compacted", {"ragged": False, "capacity": 0.5}),
    ("compacted", {"ragged": False, "budget": 2}),        # carry rounds
    ("compacted", {"ragged": False, "budget": 2, "lossless": False})])
def test_client_spans_and_counters_match_the_reference(exchange, kw):
    n, q, w = 8, 12, 8
    jc, jrec, tc, trec = _traced_pair(n, cap=256, words=w, mcap=256,
                                      exchange=exchange, **kw)
    carried = 0
    for (name, jcall), (_, tcall) in zip(_calls(jc, n, q, w),
                                         _calls(tc, n, q, w)):
        _fresh_jax_traces()            # every call a fresh JAX trace
        j0, t0 = len(jrec.spans), len(trec.spans)
        jcall()
        tcall()
        carried += _assert_same_tree(_tree(trec, t0), _tree(jrec, j0), name)
    assert trec.spans[-1].name.startswith("client.")
    assert (carried > 0) == (kw == {"ragged": False, "budget": 2})
    jm, tm = jrec.metrics, trec.metrics
    counts = {k: v for k, v in jm.counters.items()
              if not k.startswith("span_")}
    assert {k: v for k, v in tm.counters.items()
            if not k.startswith("span_")} == counts
    assert tm.gauges == jm.gauges
    assert tm.histograms == jm.histograms
    assert any(k.startswith("exchange_bytes_total") for k in counts)
    assert [(r.kind, r.choice) for r in trec.audit.records()] == \
        [(r.kind, r.choice) for r in jrec.audit.records()]


def test_byte_counter_is_the_footprint_of_the_call():
    n, q, w = 4, 8, 8
    rec = obs.TraceRecorder()
    policy = LayoutPolicy.uniform(LayoutMode.DIST_HASH, n)
    client = BBClient(policy, device="cpu", cap=4 * q, words=w, mcap=4 * q,
                      exchange="compacted", trace=rec)
    rng = np.random.RandomState(0)
    ph = torch.as_tensor(rng.randint(1, 1 << 20, (n, q)), dtype=torch.int32)
    cid = torch.as_tensor(rng.randint(0, 8, (n, q)), dtype=torch.int32)
    pay = torch.as_tensor(rng.randint(0, 9999, (n, q, w)), dtype=torch.int32)
    valid = torch.ones((n, q), dtype=torch.bool)
    mode = torch.full((n, q), int(LayoutMode.DIST_HASH), dtype=torch.int32)
    client.state = client._write(client.state, mode, ph, cid, pay, valid)
    cfg = client._call_config("write", mode, ph, cid, valid)
    foot = bb.exchange_footprint(policy, q, w, cfg)
    assert rec.metrics.get("exchange_bytes_total", op="write") == \
        4.0 * foot["write_elems"]
    assert rec.metrics.get("client_ops_total", op="write", kind="compacted",
                           epoch=0) == 1


@pytest.mark.parametrize("q", [8, 33])
@pytest.mark.parametrize("kind", ["dense", "compacted"])
def test_exchange_footprint_matches_the_reference(q, kind):
    from repro.core import burst_buffer as jbb
    for scopes in ({}, SCOPES):
        tpol = LayoutPolicy.from_scopes(scopes, n_nodes=8, default=2)
        jpol = JLayoutPolicy.from_scopes(scopes, n_nodes=8, default=2)
        for extra in ({}, {"budget": 3}, {"capacity": 0.5},
                      {"lossless": False}, {"carry_budget_hint": 8},
                      {"pipeline": False}):
            tcfg, jcfg = (bb.ExchangeConfig(kind, **extra),
                          jbb.ExchangeConfig(kind, **extra))
            assert bb.exchange_footprint(tpol, q, 16, tcfg) == \
                jbb.exchange_footprint(jpol, q, 16, jcfg)
        spec = bb.RaggedSpec(tuple(range(8)))
        jspec = jbb.RaggedSpec(tuple(range(8)))
        assert bb.exchange_footprint(
            tpol, q, 16, bb.ExchangeConfig(kind, data_spec=spec,
                                           meta_spec=spec)) == \
            jbb.exchange_footprint(
                jpol, q, 16, jbb.ExchangeConfig(kind, data_spec=jspec,
                                                meta_spec=jspec))


def test_dropped_rows_gauge_matches_engine_state():
    n, q, w = 4, 16, 8
    rec = obs.TraceRecorder()
    client = BBClient(LayoutPolicy.uniform(LayoutMode.DIST_HASH, n),
                      device="cpu", cap=4 * q, words=w, mcap=4 * q,
                      exchange="compacted", trace=rec, ragged=False,
                      budget=2, meta_budget=q, lossless=False)
    rng = np.random.RandomState(0)
    ph = torch.as_tensor(np.repeat(rng.randint(1, 1 << 20, (n, 1)), q,
                                   axis=1), dtype=torch.int32)
    cid = torch.as_tensor(np.tile(np.arange(q), (n, 1)), dtype=torch.int32)
    pay = torch.as_tensor(rng.randint(0, 9999, (n, q, w)), dtype=torch.int32)
    mode = torch.full((n, q), int(LayoutMode.DIST_HASH), dtype=torch.int32)
    client.state = client._write(client.state, mode, ph, cid, pay,
                                 torch.ones((n, q), dtype=torch.bool))
    dropped = int(client.state.dropped.sum())
    assert dropped > 0
    assert rec.metrics.gauge("exchange_dropped_rows") == float(dropped)


def test_untraced_client_records_nothing():
    rec = obs.TraceRecorder()
    client = BBClient(LayoutPolicy.from_scopes(SCOPES, n_nodes=4, default=2),
                      device="cpu", cap=64, words=4, mcap=64)
    with obs.activate(None):
        for _, call in _calls(client, 4, 6, 4):
            call()
    assert client.obs is None and len(rec.spans) == 0
    assert obs.current_recorder() is None


# ---------------------------------------------------------------------------
# adaptation spans: a migration installment and a controller tick
# ---------------------------------------------------------------------------
def _adapting_pair(n=4, q=8, w=4, before_writes=lambda jc, tc: None):
    """Traced JAX and port clients with telemetry; ``before_writes`` runs
    before each writes its NODE_LOCAL scope's chunks."""
    scopes = {"/bb/hot": LayoutMode.NODE_LOCAL}
    jc, jrec, tc, trec = _traced_pair(n, cap=256, words=w, mcap=256,
                                      telemetry=True, scopes=scopes,
                                      default=LayoutMode.DIST_HASH)
    before_writes(jc, tc)
    paths = [[f"/bb/hot/c{i}" for _ in range(q)] for i in range(n)]
    cid = np.tile(np.arange(q, dtype=np.int32), (n, 1))
    pay = np.random.RandomState(0).randint(0, 999, (n, q, w)).astype(
        np.int32)
    reqs = []
    for c in (jc, tc):
        req = c.encode(paths, chunk_id=cid, payload=pay)
        c.write(req)
        perm = [(i + 1) % n for i in range(n)]
        reqs.append(c.encode([paths[i] for i in perm], chunk_id=cid[perm]))
    return jc, jrec, tc, trec, reqs


def test_migration_installment_spans_match_the_reference():
    _fresh_jax_traces()
    jc, jrec, tc, trec, _ = _adapting_pair()
    jm = JLiveMigrator(jc, "/bb/hot", LayoutMode.HYBRID, step_chunks=8)
    tm = LiveMigrator(tc, "/bb/hot", LayoutMode.HYBRID, step_chunks=8)
    j0, t0 = len(jrec.spans), len(trec.spans)
    jm.step()
    tm.step()
    tree = _tree(trec, t0)
    _assert_same_tree(tree, _tree(jrec, j0), "installment")
    names = [name for name, _, _ in tree]
    for name in ("migrate.installment", "client.migrate",
                 "engine.migrate_rows", "engine.forward_read",
                 "engine.forward_write", "engine.meta_op", "exchange.plan"):
        assert name in names, name
    depth = {name: d for name, _, d in tree}
    assert depth["migrate.installment"] < depth["client.migrate"] < \
        depth["engine.migrate_rows"] < depth["engine.forward_read"]
    for key in ("migrate_calls_total{epoch=1}", "migrate_moved_total",
                "migrate_installments_total{scope=/bb/hot}"):
        assert trec.metrics.counters[key] == jrec.metrics.counters[key]
    assert trec.metrics.gauges == jrec.metrics.gauges
    assert [(r.kind, r.choice, r.inputs) for r in
            trec.audit.records("policy_epoch")] == \
        [(r.kind, r.choice, r.inputs) for r in
         jrec.audit.records("policy_epoch")]


def test_controller_tick_spans_and_audit_match_the_reference(tmp_path):
    cfg = dict(horizon_rounds=1e4, step_chunks=16)
    drift = dict(patience=2, cooldown=3, min_weight=4.0)
    ctls = {}

    def controllers(jc, tc):
        ctls["j"] = JController(jc, cfg=JAdaptConfig(
            drift=JDriftConfig(**drift), **cfg))
        ctls["t"] = AdaptationController(tc, cfg=AdaptConfig(
            drift=DriftConfig(**drift), **cfg))

    jc, jrec, tc, trec, (jread, tread) = _adapting_pair(
        before_writes=controllers)
    jctl, tctl = ctls["j"], ctls["t"]
    jctl.tick()
    tctl.tick()
    trees, phases = [], []
    for _ in range(8):
        jc.read(jread)
        tc.read(tread)
        j0, t0 = len(jrec.spans), len(trec.spans)
        phases.append(tctl.tick().phase)
        assert phases[-1] == jctl.tick().phase
        trees.append((_tree(trec, t0), _tree(jrec, j0)))
    assert "adopted" in phases and "migrating" in phases, phases
    # the tick that adopts and the installments: adapt.tick at the root
    for t_tree, j_tree in trees:
        assert t_tree[-1][:2] == ("adapt.tick", "adapt")
        assert [s for s in t_tree if not s[0].startswith(
            ("exchange.", "engine."))] == \
            [s for s in j_tree if not s[0].startswith(
                ("exchange.", "engine."))]
    kinds = ("redecide", "gate_delta", "policy_epoch")
    for kind in kinds:
        t, j = trec.audit.records(kind), jrec.audit.records(kind)
        assert [r.choice for r in t] == [r.choice for r in j], kind
    assert trec.metrics.gauges.keys() == jrec.metrics.gauges.keys()
    for k, v in jrec.metrics.gauges.items():
        assert trec.metrics.gauges[k] == pytest.approx(v, rel=1e-6), k
    # bbstat reads the port's capture
    sys.path.insert(0, str(ROOT / "tools"))
    import bbstat
    path = obs.write_recording(trec, tmp_path / "cap.json")
    assert bbstat.main([str(path)]) == 0
    rec = json.loads(path.read_text())
    rows = bbstat.phase_rows(rec)
    assert rows and abs(sum(r["share"] for r in rows) - 1.0) < 0.05
    assert {r["span"] for r in rows} >= {"adapt.tick", "client.read",
                                         "migrate.installment"}
    assert [r["kind"] for r in bbstat.decision_rows(rec, "gate_delta")] \
        == ["gate_delta"] * len(jrec.audit.records("gate_delta"))
    assert any(r["scope"] == "/bb/hot" for r in bbstat.scope_rows(rec))

