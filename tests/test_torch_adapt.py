"""Online adaptation in the port (repro_torch.core.adapt) against the JAX
package: telemetry counters, drift hysteresis, re-decision and its gate,
transition policies, the engine's relayout (``_clear_chunks``,
``_tombstone_broadcast``, ``migrate_rows``) on the same state, the pinned
relayout stream digest, the controller's decisions on the same stream, and
the train loop's adaptation tick.

Tolerances: the engine, the registry, the integer-valued telemetry columns
and every decision are held bit for bit (equal); the float32 pressure
column (a sum of fractions, added in another order than the reference's
sequential scatter) within 1e-6 relative; drift divergences and predicted
times, float64 host arithmetic on those counters, within 1e-9 relative.
"""
import dataclasses
import hashlib
import json
import pathlib
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import burst_buffer as jbb
from repro.core.adapt import AdaptConfig as JAdaptConfig
from repro.core.adapt import AdaptationController as JController
from repro.core.adapt import DriftConfig as JDriftConfig
from repro.core.adapt import DriftDetector as JDriftDetector
from repro.core.adapt import LiveMigrator as JLiveMigrator
from repro.core.adapt import redecide as jredecide
from repro.core.adapt import telemetry as jtm
from repro.core.adapt.migrate import transition_policy as j_transition
from repro.core.client import BBClient as JBBClient
from repro.core.client import BBRequest as JBBRequest
from repro.core.exchange_plan import stacked_exchange as j_stacked_exchange
from repro.core.intent.probe import RuntimeStats
from repro.core.policy import LayoutPolicy as JLayoutPolicy
from repro_torch.core import burst_buffer as bb
from repro_torch.core.adapt import (AdaptConfig, AdaptationController,
                                    DriftConfig, DriftDetector, LiveMigrator,
                                    signature_from_phases,
                                    signature_from_stats)
from repro_torch.core.adapt import redecide
from repro_torch.core.adapt import telemetry as tm
from repro_torch.core.adapt.controller import TickReport
from repro_torch.core.adapt.migrate import final_policy, transition_policy
from repro_torch.core.client import BBClient, BBRequest
from repro_torch.core.layouts import LayoutMode, str_hash
from repro_torch.core.policy import LayoutPolicy

from test_torch_cuda import interleaved_stream, mixed_stream
from test_torch_engine import assert_state_equal

N, Q, W = 8, 6, 8
SCOPE = "/bb/hot"
# tests/test_adapt.py's frozen observables of the interleaved stream
STREAM_DIGEST = "cfd76da6b40767fb96d3095ded4fbb01"
PRESSURE_RTOL = 1e-6
HOST_RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes: a thread per core only spins against JAX's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _policy(default=LayoutMode.DIST_HASH, scope_mode=LayoutMode.NODE_LOCAL,
            pkg=LayoutPolicy, n=N):
    return pkg.from_scopes({SCOPE: scope_mode}, n_nodes=n, default=default)


def _clients(n=N, **kw):
    """A JAX client and a port client on the CPU over one policy."""
    scope_mode = kw.pop("scope_mode", LayoutMode.NODE_LOCAL)
    default = kw.pop("default", LayoutMode.DIST_HASH)
    return (JBBClient(_policy(default, scope_mode, JLayoutPolicy, n), **kw),
            BBClient(_policy(default, scope_mode, LayoutPolicy, n),
                     device="cpu", **kw))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(_np(a)).tobytes())
    return h.hexdigest()[:32]


def _assert_counts_equal(jcounts, tcounts):
    """Integer-valued columns exact, the pressure column within 1e-6."""
    j, t = np.asarray(jcounts), _np(tcounts)
    assert j.shape == t.shape and t.dtype == np.float32
    cols = [c for c in range(tm.N_FEATURES) if c != tm.F_PRESSURE]
    np.testing.assert_array_equal(t[..., cols], j[..., cols])
    np.testing.assert_allclose(t[..., tm.F_PRESSURE], j[..., tm.F_PRESSURE],
                               rtol=PRESSURE_RTOL, atol=0)


def _rreq(req, perm, pkg=BBRequest):
    return pkg(path_hash=req.path_hash[perm], chunk_id=req.chunk_id[perm],
               scope_hash=req.scope_hash[perm])


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def test_telemetry_counts_op_mix_and_locality():
    jc, tc = _clients(cap=128, words=W, mcap=128, telemetry=True)
    rng = np.random.RandomState(0)
    paths = [[f"{SCOPE}/r{i}/f{j % 2}" for j in range(Q)] for i in range(N)]
    cid = np.tile(np.arange(Q, dtype=np.int32), (N, 1))
    payload = rng.randint(0, 99, (N, Q, W)).astype(np.int32)
    for c in (jc, tc):
        req = c.encode(paths, chunk_id=cid, payload=payload)
        c.write(req)
        c.read(req)
        c.stat(req)
    _assert_counts_equal(jc.telemetry.counts, tc.telemetry.counts)
    row = tc.telemetry.snapshot()[tc.telemetry.row_of(SCOPE)]
    assert row[tm.F_WRITES] == row[tm.F_READS] == row[tm.F_META] == N * Q
    assert row[tm.F_WORDS_W] == N * Q * W
    assert row[tm.F_SELF] == N * Q
    sig = tm.signature_of_row(row)
    assert np.array_equal(sig, jtm.signature_of_row(
        np.asarray(jc.telemetry.counts)[1]))
    assert sig[2] == 1.0
    # cross-rank replay flips the locality signal, on both packages; a
    # request built by hand carries no host copies, so the port copies
    # its index fields back
    perm = np.roll(np.arange(N), 1)
    before_j, before_t = jc.telemetry.snapshot(), tc.telemetry.snapshot()
    jc.read(_rreq(jc.encode(paths, chunk_id=cid), perm, JBBRequest))
    tc.read(_rreq(tc.encode(paths, chunk_id=cid), torch.as_tensor(perm)))
    (s_j, w_j), (s_t, w_t) = (jc.telemetry.signatures(since=before_j)[SCOPE],
                              tc.telemetry.signatures(since=before_t)[SCOPE])
    assert w_t == w_j == N * Q
    assert np.array_equal(s_t, s_j) and s_t[0] == 1.0 and s_t[2] == 0.0


MIXED_SCOPES = {SCOPE: LayoutMode.NODE_LOCAL, "/bb/h": LayoutMode.HYBRID}


def _jax_raw(ph, cid):
    return JBBRequest(path_hash=jnp.asarray(ph), chunk_id=jnp.asarray(cid))


def _port_raw(ph, cid):
    return BBRequest(path_hash=torch.as_tensor(ph),
                     chunk_id=torch.as_tensor(cid))


@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_telemetry_counters_match_the_reference_on_a_mixed_stream(capacity):
    # the counters do not depend on the exchange plane: the dense one
    # spares the JAX client a compile per measured spec
    kw = dict(cap=256, words=W, mcap=256, telemetry=True, capacity=capacity,
              exchange="dense")
    jc = mixed_stream(JBBClient(
        JLayoutPolicy.from_scopes(MIXED_SCOPES, n_nodes=N, default=2), **kw),
        _jax_raw)

    def port():
        return mixed_stream(BBClient(
            LayoutPolicy.from_scopes(MIXED_SCOPES, n_nodes=N, default=2),
            device="cpu", **kw), _port_raw)

    tc = port()
    _assert_counts_equal(jc.telemetry.counts, tc.telemetry.counts)
    assert tc.telemetry.snapshot()[:, tm.F_PRESSURE].sum() > 0
    assert tc.telemetry.suggest_align(8) == jc.telemetry.suggest_align(8)
    assert tc._files == jc._files and tc._writer == jc._writer
    # the same stream gives the same counters again (fixed-order sums)
    assert torch.equal(port().telemetry.counts, tc.telemetry.counts)


@pytest.mark.parametrize("kind", ["write", "read", "meta"])
def test_per_node_counter_layout_matches_the_reference(kind):
    """``per_node``: each request row adds into its own node's slice, and
    the snapshot sums the slices (the reference's mesh layout)."""
    pol = LayoutPolicy.from_scopes(MIXED_SCOPES, n_nodes=N)
    jpol = JLayoutPolicy.from_scopes(MIXED_SCOPES, n_nodes=N)
    tt = tm.ScopeTelemetry(pol, per_node=N, device="cpu")
    jt = jtm.ScopeTelemetry(jpol, per_node=N)
    rng = np.random.RandomState(2)
    for q in (7, 1):
        sh = rng.choice([str_hash(SCOPE), str_hash("/bb/h"), -1], (N, q))
        ph = rng.randint(1, 50, (N, q))
        cid = rng.randint(0, 20, (N, q))
        dest = rng.randint(0, N, (N, q))
        hint = rng.rand(N, q) > 0.5
        valid = rng.rand(N, q) > 0.2
        args = [a.astype(np.int32) for a in (sh, ph, cid, dest)]
        kw = dict(words=W, n_nodes=N, capacity=0.5)
        tt.record(kind, *(torch.as_tensor(a) for a in args),
                  torch.as_tensor(valid), self_hint=torch.as_tensor(hint),
                  **kw)
        jt.record(kind, *(jnp.asarray(a) for a in args), jnp.asarray(valid),
                  self_hint=jnp.asarray(hint), **kw)
    assert tuple(tt.counts.shape) == (N, 3, tm.N_FEATURES)
    _assert_counts_equal(jt.counts, tt.counts)
    np.testing.assert_allclose(tt.snapshot(), jt.snapshot(), rtol=1e-6)


def test_telemetry_sequential_stride_signature():
    jc, tc = _clients(cap=64, words=W, mcap=64, telemetry=True)
    paths = [[f"{SCOPE}/s{i}" for _ in range(Q)] for i in range(N)]
    cid = np.tile(np.arange(Q, dtype=np.int32), (N, 1))
    for c in (jc, tc):
        c.write(c.encode(paths, chunk_id=cid,
                         payload=np.zeros((N, Q, W), np.int32)))
    _assert_counts_equal(jc.telemetry.counts, tc.telemetry.counts)
    row = tc.telemetry.snapshot()[1]
    assert row[tm.F_PAIRS] == row[tm.F_SEQ] == N * (Q - 1)
    assert tm.signature_of_row(row)[3] == 1.0


def test_telemetry_rebind_preserves_surviving_scopes():
    jc, tc = _clients(cap=64, words=W, mcap=64, telemetry=True)
    paths = [[f"{SCOPE}/x" for _ in range(Q)] for _ in range(N)]
    for c in (jc, tc):
        c.write(c.encode(paths, chunk_id=np.zeros((N, Q), np.int32),
                         payload=np.zeros((N, Q, W), np.int32)))
    before = tc.telemetry.snapshot()[1].copy()
    jc.install_policy(_policy(scope_mode=LayoutMode.DIST_HASH,
                              pkg=JLayoutPolicy))
    tc.install_policy(_policy(scope_mode=LayoutMode.DIST_HASH))
    two = LayoutPolicy.from_scopes({SCOPE: 3, "/bb/new": 1}, n_nodes=N)
    jc.install_policy(JLayoutPolicy.from_scopes({SCOPE: 3, "/bb/new": 1},
                                                n_nodes=N))
    tc.install_policy(two)
    assert tc.telemetry.scope_names == jc.telemetry.scope_names
    _assert_counts_equal(jc.telemetry.counts, tc.telemetry.counts)
    assert np.array_equal(
        tc.telemetry.snapshot()[tc.telemetry.row_of(SCOPE)], before)
    assert tc.epoch == jc.epoch == 2


def test_baseline_signatures_share_the_live_space():
    rs = RuntimeStats(posix_bytes_written=1e6, posix_bytes_read=9e6,
                      posix_writes=10, posix_reads=90, posix_meta_ops=5,
                      posix_seq_ratio=0.8, cross_rank_ops=45)
    sig = signature_from_stats(rs)
    assert np.array_equal(sig, jtm.signature_from_stats(rs))
    phases = redecide.phases_from_signature(SCOPE, sig)
    jphases = jredecide.phases_from_signature(SCOPE, sig)
    assert [dataclasses.asdict(p) for p in phases] == \
        [dataclasses.asdict(p) for p in jphases]
    assert np.array_equal(signature_from_phases(phases),
                          jtm.signature_from_phases(jphases))


# ---------------------------------------------------------------------------
# drift detection + hysteresis
# ---------------------------------------------------------------------------
BASE = np.array([0.1, 0.05, 1.0, 0.9, 0.0, 0.5])
DRIFTED = np.array([0.95, 0.05, 0.0, 0.2, 0.0, 0.5])
OTHER = np.array([0.1, 0.9, 1.0, 0.9, 0.0, 0.5])


def test_drift_fires_only_after_patience():
    det = DriftDetector(baseline={"s": BASE.copy()},
                        cfg=DriftConfig(patience=2, cooldown=3))
    assert not det.observe("s", BASE, 100).fired
    r1 = det.observe("s", DRIFTED, 100)
    assert r1.armed == 1 and not r1.fired
    assert det.observe("s", DRIFTED, 100).fired


def test_cooldown_and_low_volume_ticks():
    cfg = DriftConfig(patience=1, cooldown=3, alpha=1.0)
    det = DriftDetector(baseline={"s": BASE.copy()}, cfg=cfg)
    assert not det.observe("s", DRIFTED, 2).fired        # below min_weight
    assert det.observe("s", DRIFTED, 100).fired
    det.rebase("s")
    for _ in range(cfg.cooldown):
        assert not det.observe("s", OTHER, 100).fired
    assert det.observe("s", OTHER, 100).fired


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_reports_match_the_reference(seed):
    """Random signature/weight sequences with rebases: every report equal,
    and the recorder's drift counters and gauges equal."""
    from repro.core import obs as jobs
    from repro_torch.core import obs
    rng = np.random.RandomState(seed)
    cfg = dict(patience=2, cooldown=2, alpha=0.5, min_weight=8.0)
    jdet = JDriftDetector(baseline={"a": BASE.copy()},
                          cfg=JDriftConfig(**cfg))
    tdet = DriftDetector(baseline={"a": BASE.copy()}, cfg=DriftConfig(**cfg))
    jrec, trec = jobs.TraceRecorder(), obs.TraceRecorder()
    for _ in range(30):
        scope = "ab"[rng.randint(2)]
        sig = np.where(rng.rand(6) < 0.5, BASE, DRIFTED) + \
            0.01 * rng.rand(6)
        w = float(rng.choice([2.0, 50.0, 200.0]))
        with jobs.activate(jrec):
            jr = jdet.observe(scope, sig, w)
        with obs.activate(trec):
            tr = tdet.observe(scope, sig, w)
        assert (tr.fired, tr.armed, tr.cooling) == \
            (jr.fired, jr.armed, jr.cooling)
        assert tr.divergence == pytest.approx(jr.divergence, rel=HOST_RTOL)
        if tr.fired:
            with jobs.activate(jrec):
                jdet.rebase(scope)
            with obs.activate(trec):
                tdet.rebase(scope)
    assert trec.metrics.counters.keys() == jrec.metrics.counters.keys()
    for k, v in jrec.metrics.counters.items():
        if not k.startswith("span_"):
            assert trec.metrics.counters[k] == v, k
    for k, v in jrec.metrics.gauges.items():
        assert trec.metrics.gauges[k] == pytest.approx(v, rel=HOST_RTOL), k


# ---------------------------------------------------------------------------
# re-decision + cost/benefit gate
# ---------------------------------------------------------------------------
SIGS = [DRIFTED, BASE, OTHER, np.array([0.0, 0.02, 1.0, 1.0, 0.0, 0.5]),
        np.array([0.5, 0.3, 0.2, 0.6, 0.4, 0.9]),
        np.array([0.9, 0.0, 0.6, 0.0, 0.1, 0.1])]


@pytest.mark.parametrize("mode", list(LayoutMode))
def test_propose_deltas_and_gate_match_the_reference(mode):
    from repro.core import obs as jobs
    from repro_torch.core import obs
    tpol = _policy(scope_mode=mode)
    jpol = _policy(scope_mode=mode, pkg=JLayoutPolicy)
    for sig in SIGS:
        jrec, trec = jobs.TraceRecorder(), obs.TraceRecorder()
        with jobs.activate(jrec):
            jd = jredecide.propose_deltas(jpol, {SCOPE: (sig, 1000.0)})
        with obs.activate(trec):
            td = redecide.propose_deltas(tpol, {SCOPE: (sig, 1000.0)})
        assert [(d.scope, int(d.old_mode), int(d.new_mode)) for d in td] == \
            [(d.scope, int(d.old_mode), int(d.new_mode)) for d in jd]
        for a, b in zip(td, jd):
            assert a.gain_s == pytest.approx(b.gain_s, rel=HOST_RTOL)
        (jr,), (tr,) = (jrec.audit.records("redecide"),
                        trec.audit.records("redecide"))
        assert tr.choice == jr.choice and tr.evidence == jr.evidence
        assert tr.alternatives.keys() == jr.alternatives.keys()
        for d_t, d_j in zip(td, jd):
            for n_chunks, horizon in ((256, 1e4), (1 << 22, 1e-6),
                                      (4096, 10.0)):
                ok_t, a_t = redecide.gate_delta(d_t, n_chunks, 16, N, horizon)
                ok_j, a_j = jredecide.gate_delta(d_j, n_chunks, 16, N,
                                                 horizon)
                assert ok_t == ok_j
                assert a_t.keys() == a_j.keys()
                for k in a_j:
                    assert a_t[k] == pytest.approx(a_j[k], rel=HOST_RTOL)


def test_migration_cost_matches_the_reference():
    from repro.core.simulator import Hardware as JHardware
    from repro_torch.core.simulator import Hardware
    for n_chunks, words, n, step in ((256, 16, 8, None), (4096, 262144, 32,
                                                          256)):
        assert redecide.migration_cost_s(n_chunks, words, n,
                                         step_chunks=step) == \
            pytest.approx(jredecide.migration_cost_s(n_chunks, words, n,
                                                     step_chunks=step),
                          rel=HOST_RTOL)
        hw = dict(net_mibs=100.0, rpc_ms=0.1)
        assert redecide.migration_cost_s(n_chunks, words, n,
                                         hw=Hardware(**hw)) == \
            pytest.approx(jredecide.migration_cost_s(
                n_chunks, words, n, hw=JHardware(**hw)), rel=HOST_RTOL)
        assert redecide.migration_cost_s(n_chunks, words, n,
                                         fabric=(20.0, 900.0)) == \
            jredecide.migration_cost_s(n_chunks, words, n,
                                       fabric=(20.0, 900.0))


def test_signature_workload_waits_for_the_intent_pipeline():
    """Named when the port's ``signature_workload`` raised until the intent
    pipeline was ported; now it is, and a drifted signature (and a few
    more: write-heavy, metadata-heavy, cross-rank, sequential and random)
    becomes the reference's ``Workload``, field for field, on which the
    full selector makes the reference's decision."""
    from repro.core.intent.selector import select_layout as j_select
    from repro_torch.core.intent.selector import select_layout
    sigs = [DRIFTED, BASE, OTHER,
            np.array([0.5, 0.3, 0.4, 0.6, 0.0, 0.9]),
            np.array([0.02, 0.01, 1.0, 1.0, 0.0, 0.1]),
            np.array([0.7, 0.0, 0.3, 0.0, 0.0, 0.8])]
    for sig in sigs:
        for n in (N, 32):
            w = redecide.signature_workload(SCOPE, sig, n_nodes=n)
            jw = jredecide.signature_workload(SCOPE, sig, n_nodes=n)
            assert (w.app, w.test_id, w.description, w.source_code,
                    w.job_script, w.n_nodes, w.name) == \
                (jw.app, jw.test_id, jw.description, jw.source_code,
                 jw.job_script, jw.n_nodes, jw.name)
            assert [dataclasses.asdict(p) for p in w.phases] == \
                [dataclasses.asdict(p) for p in jw.phases]
            d, jd = select_layout(w), j_select(jw)
            assert isinstance(d.mode, LayoutMode)
            assert (int(d.mode), d.confidence, d.decision.steps, d.prompt,
                    d.context_json) == \
                (int(jd.mode), jd.confidence, jd.decision.steps, jd.prompt,
                 jd.context_json)
            assert {k: int(v) for k, v in d.scope_modes.items()} == \
                {k: int(v) for k, v in jd.scope_modes.items()}


# ---------------------------------------------------------------------------
# transition policies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("new_mode", [2, 3, 4])
def test_transition_and_final_policies_match_the_reference(new_mode):
    p = _policy(scope_mode=LayoutMode.NODE_LOCAL)
    jp = _policy(scope_mode=LayoutMode.NODE_LOCAL, pkg=JLayoutPolicy)
    trans, old = transition_policy(p, SCOPE + "/", LayoutMode(new_mode), 3)
    jtrans, jold = j_transition(jp, SCOPE + "/", new_mode, 3)
    assert int(old) == int(jold) == int(LayoutMode.NODE_LOCAL)
    assert [(s, int(m)) for s, m in trans.scopes] == \
        [(s, int(m)) for s, m in jtrans.scopes]
    assert {LayoutMode.NODE_LOCAL, LayoutMode(new_mode)} <= \
        trans.modes_present()
    fin = final_policy(trans, SCOPE, LayoutMode(new_mode))
    assert fin.modes_present() == {LayoutMode(new_mode),
                                   LayoutMode.DIST_HASH}
    assert not any(s.startswith("/__epoch") for s, _ in fin.scopes)


# ---------------------------------------------------------------------------
# the engine's relayout against the reference's on the same state
# ---------------------------------------------------------------------------
def _filled_states(mode_of_scope=LayoutMode.NODE_LOCAL, cap=64, seed=0):
    """One JAX client's tables after a few writes (duplicates included),
    and the same tables as the port's state."""
    jc = JBBClient(_policy(scope_mode=mode_of_scope, pkg=JLayoutPolicy),
                   cap=cap, words=W, mcap=64)
    rng = np.random.RandomState(seed)
    reqs = []
    for step in range(3):
        paths = [[(f"{SCOPE}/r{i}/f{j % 3}", f"/o/g{j % 4}")[(i + j) % 2]
                  for j in range(Q)] for i in range(N)]
        cid = rng.randint(0, 3, (N, Q)).astype(np.int32)
        pay = rng.randint(0, 9999, (N, Q, W)).astype(np.int32)
        req = jc.encode(paths, chunk_id=cid, payload=pay)
        jc.write(req)
        reqs.append((np.asarray(req.path_hash), cid))
    arrays = [np.asarray(a) for a in jc.state.tree_flatten()[0]]
    return jc.state, bb.from_jax_state(arrays, device="cpu"), reqs, rng


def test_clear_chunks_matches_the_reference():
    jstate, tstate, reqs, rng = _filled_states()
    ph, cid = reqs[1]
    keys = np.stack([ph, cid], axis=-1)
    valid = rng.rand(N, Q) > 0.3
    jout = jbb._clear_chunks(jstate, jnp.asarray(keys), jnp.asarray(valid))
    tout = bb._clear_chunks(tstate, torch.as_tensor(keys),
                            torch.as_tensor(valid))
    assert tout is tstate                       # updated in place
    assert_state_equal(jout, tout)
    assert int(tout.data_count.sum()) < int(
        np.asarray(jstate.data_count).sum())


def test_tombstone_broadcast_matches_the_reference():
    jstate, tstate, reqs, rng = _filled_states(LayoutMode.HYBRID)
    ph, cid = reqs[0]
    keys = np.stack([ph, cid], axis=-1)
    valid = rng.rand(N, Q) > 0.2
    keep = rng.randint(0, N, (N, Q)).astype(np.int32)
    jout = jbb._tombstone_broadcast(
        jstate, jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(keep),
        j_stacked_exchange, N, None)
    tout = bb._tombstone_broadcast(tstate, torch.as_tensor(keys),
                                   torch.as_tensor(valid),
                                   torch.as_tensor(keep))
    assert_state_equal(jout, tout)


@pytest.mark.parametrize("old,new", [(1, 3), (1, 4), (4, 2), (3, 4)])
@pytest.mark.parametrize("kind", ["compacted", "dense"])
def test_migrate_rows_matches_the_reference(old, new, kind):
    jstate, tstate, reqs, rng = _filled_states(LayoutMode(old))
    tpol, _ = transition_policy(_policy(scope_mode=LayoutMode(old)), SCOPE,
                                LayoutMode(new), 1)
    jpol, _ = j_transition(_policy(scope_mode=LayoutMode(old),
                                   pkg=JLayoutPolicy), SCOPE, new, 1)
    jcfg = jbb.ExchangeConfig(kind) if kind == "dense" else \
        jbb.ExchangeConfig("compacted", capacity=0.5)
    tcfg = bb.ExchangeConfig(kind) if kind == "dense" else \
        bb.ExchangeConfig("compacted", capacity=0.5)
    for ph, cid in reqs[:2]:
        valid = rng.rand(N, Q) > 0.2
        jold, jnew = (jnp.full((N, Q), old, jnp.int32),
                      jnp.full((N, Q), new, jnp.int32))
        jstate, jmoved, jfound = jbb.migrate_rows(
            jstate, jpol, jnp.asarray(ph), jnp.asarray(cid),
            jnp.asarray(valid), jold, jnew, config=jcfg)
        tstate, tmoved, tfound = bb.migrate_rows(
            tstate, tpol, torch.as_tensor(ph), torch.as_tensor(cid),
            torch.as_tensor(valid), torch.full((N, Q), old),
            torch.full((N, Q), new), config=tcfg)
        assert np.array_equal(_np(tmoved), np.asarray(jmoved))
        assert np.array_equal(_np(tfound), np.asarray(jfound))
        assert_state_equal(jstate, tstate)
    assert bool(np.asarray(jmoved).any() or np.asarray(jfound).any())


def test_migrate_rows_refuses_a_ragged_spec():
    state = bb.init_state(N, 8, W, 8, device="cpu")
    spec = bb.RaggedSpec((1,) * N)
    z = torch.zeros((N, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="two mode arrays"):
        bb.migrate_rows(state, _policy(), z, z, z > 0, z + 1, z + 3,
                        config=bb.ExchangeConfig("compacted",
                                                 data_spec=spec))


# ---------------------------------------------------------------------------
# live relayout: the pinned interleaved stream
# ---------------------------------------------------------------------------
def test_relayout_is_invisible_to_reads_and_stats():
    _, plain = interleaved_stream(relayout=False)
    client, migrated = interleaved_stream(relayout=True)
    assert _digest(*plain) == _digest(*migrated) == STREAM_DIGEST
    assert client.epoch == 2
    assert client.fallback is None
    assert client.policy.mode_for_path(f"{SCOPE}/x") == LayoutMode.DIST_HASH


def test_relayout_into_hybrid_is_also_lossless():
    _, migrated = interleaved_stream(relayout=True,
                                     new_mode=LayoutMode.HYBRID)
    assert _digest(*migrated) == STREAM_DIGEST


def test_migration_moves_the_bytes_like_the_reference():
    jc, tc = _clients(cap=256, words=W, mcap=256, telemetry=True)
    paths = [[f"{SCOPE}/n{i}" for _ in range(Q)] for i in range(N)]
    cid = np.tile(np.arange(Q, dtype=np.int32), (N, 1))
    pay = np.random.RandomState(3).randint(0, 999, (N, Q, W)).astype(
        np.int32)
    for c, mig in ((jc, JLiveMigrator), (tc, LiveMigrator)):
        req = c.encode(paths, chunk_id=cid, payload=pay)
        c.write(req)
        assert mig(c, SCOPE, LayoutMode.DIST_HASH, step_chunks=16).run() \
            == N * Q
        out, found = c.read(req)
        assert bool(_np(found).all()) and np.array_equal(_np(out), pay)
    assert_state_equal(jc.state, tc.state)
    counts = _np(tc.state.data_count)
    assert int(counts.sum()) == N * Q and not np.array_equal(
        counts, np.full(N, Q))
    assert [(e.epoch, e.migrating) for e in tc.epoch_log] == \
        [(e.epoch, e.migrating) for e in jc.epoch_log]


def test_migrator_worklist_matches_the_reference():
    jc, tc = _clients(cap=128, words=W, mcap=128, telemetry=True)
    rng = np.random.RandomState(4)
    for _ in range(2):
        paths = [[f"{SCOPE}/w{(i + j) % 5}" for j in range(Q)]
                 for i in range(N)]
        cid = rng.randint(0, 5, (N, Q)).astype(np.int32)
        pay = rng.randint(0, 99, (N, Q, W)).astype(np.int32)
        for c in (jc, tc):
            c.write(c.encode(paths, chunk_id=cid, payload=pay))
    jm = JLiveMigrator(jc, SCOPE, LayoutMode.HYBRID, step_chunks=8)
    tm_ = LiveMigrator(tc, SCOPE, LayoutMode.HYBRID, step_chunks=8)
    assert tm_.worklist == jm.worklist and tm_.total_chunks > 0
    while not jm.done:
        assert tm_.step() == jm.step()
        assert_state_equal(jc.state, tc.state)
    assert tm_.done
    jm.finish()
    tm_.finish()
    assert [(s, int(m)) for s, m in tc.policy.scopes] == \
        [(s, int(m)) for s, m in jc.policy.scopes]


def test_migrate_rows_skips_phantom_worklist_entries():
    client = BBClient(_policy(), device="cpu", cap=64, words=W, mcap=64,
                      telemetry=True)
    trans, old = transition_policy(client.policy, SCOPE,
                                   LayoutMode.DIST_HASH, epoch=1)
    client.install_policy(trans, migrating=SCOPE, old_mode=int(old))
    ghost = np.full((N, 1), str_hash(f"{SCOPE}/never-written"), np.int32)
    moved, found_old = client.migrate_rows(
        ghost, np.zeros((N, 1), np.int32), np.ones((N, 1), bool),
        old_mode=int(old), new_mode=int(LayoutMode.DIST_HASH))
    assert not bool(moved.any()) and not bool(found_old.any())
    req = BBRequest(path_hash=torch.as_tensor(ghost),
                    scope_hash=torch.full((N, 1), str_hash(SCOPE),
                                          dtype=torch.int32))
    fnd, _, _ = client.stat(req)
    assert not bool(fnd.any())
    with pytest.raises(ValueError, match="modes_present"):
        client.migrate_rows(ghost, np.zeros((N, 1), np.int32),
                            np.ones((N, 1), bool), old_mode=1, new_mode=4)


def test_remove_during_migration_cannot_resurrect():
    client = BBClient(_policy(), device="cpu", cap=128, words=W, mcap=128,
                      telemetry=True)
    paths = [[f"{SCOPE}/d{i}" for _ in range(Q)] for i in range(N)]
    cid = np.tile(np.arange(Q, dtype=np.int32), (N, 1))
    req = client.encode(paths, chunk_id=cid,
                        payload=np.zeros((N, Q, W), np.int32))
    client.write(req)
    mig = LiveMigrator(client, SCOPE, LayoutMode.DIST_HASH, step_chunks=4)
    mig.step()
    client.remove(req)
    assert not bool(client.stat(req)[0].any())
    assert client.scope_files(SCOPE) == {}
    while not mig.done:
        mig.step()
    mig.finish()
    assert not bool(client.stat(req)[0].any())


def test_migrator_normalizes_trailing_slash_scopes():
    client = BBClient(_policy(), device="cpu", cap=128, words=W, mcap=128,
                      telemetry=True)
    paths = [[f"{SCOPE}/t{i}" for _ in range(Q)] for i in range(N)]
    cid = np.tile(np.arange(Q, dtype=np.int32), (N, 1))
    pay = np.random.RandomState(5).randint(0, 99, (N, Q, W)).astype(
        np.int32)
    req = client.encode(paths, chunk_id=cid, payload=pay)
    client.write(req)
    mig = LiveMigrator(client, SCOPE + "/", LayoutMode.DIST_HASH,
                       step_chunks=16)
    assert mig.total_chunks == N * Q
    assert client.fallback.scope_hash == str_hash(SCOPE)
    mig.step()
    assert bool(client.read(req)[1].all())
    while not mig.done:
        mig.step()
    mig.finish()
    assert [m for s, m in client.policy.scopes if s == SCOPE] == \
        [LayoutMode.DIST_HASH]
    out, found = client.read(req)
    assert bool(found.all()) and np.array_equal(_np(out), pay)


def _random_stream(pkg_client, pkg_mig, pkg_policy, seed, relayout):
    """``test_adapt.test_property_random_streams_migration_parity``'s
    stream for one seed through one package."""
    rng = np.random.RandomState(seed)
    n, q, w = 4, 4, 4
    policy = pkg_policy.from_scopes({SCOPE: int(rng.choice([3, 4]))},
                                    n_nodes=n, default=3)
    new_mode = LayoutMode(int(rng.choice([2, 3])))
    if new_mode == policy.mode_for_path(SCOPE):
        new_mode = LayoutMode.HYBRID
    mig_at = rng.randint(0, 8)
    ops = rng.randint(0, 3, 10)
    client = pkg_client(policy, cap=128, words=w, mcap=128, telemetry=True)
    r2 = np.random.RandomState(seed + 1)
    outs, mig = [], None
    for t, op in enumerate(ops):
        if op == 0:
            paths = [[f"{SCOPE}/r{i}/p{r2.randint(3)}" for _ in range(q)]
                     for i in range(n)]
        else:
            owner = r2.randint(0, n, (n, q))
            paths = [[f"{SCOPE}/r{owner[i, j]}/p{r2.randint(3)}"
                      for j in range(q)] for i in range(n)]
        cid = r2.randint(0, 3, (n, q)).astype(np.int32)
        pay = r2.randint(0, 99, (n, q, w)).astype(np.int32)
        req = client.encode(paths, chunk_id=cid, payload=pay)
        if op == 0:
            client.write(req)
        elif op == 1:
            outs += [_np(x) for x in client.read(req)]
        else:
            outs += [_np(x) for x in client.stat(req)[:2]]
        if relayout:
            if t == mig_at and mig is None:
                mig = pkg_mig(client, SCOPE, new_mode, step_chunks=4)
            if mig is not None and not mig.done:
                mig.step()
                if mig.done:
                    mig.finish()
    return outs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_streams_relayout_parity(seed):
    """The reference's property stream at fixed seeds: relayout is
    invisible through the port, and every observable equals the JAX
    package's with and without it."""
    port = lambda p, **k: BBClient(p, device="cpu", **k)     # noqa: E731
    plain = _random_stream(port, LiveMigrator, LayoutPolicy, seed, False)
    moved = _random_stream(port, LiveMigrator, LayoutPolicy, seed, True)
    jplain = _random_stream(JBBClient, JLiveMigrator, JLayoutPolicy, seed,
                            False)
    jmoved = _random_stream(JBBClient, JLiveMigrator, JLayoutPolicy, seed,
                            True)
    assert len(plain) == len(moved) == len(jmoved)
    for a, b, c, d in zip(plain, moved, jplain, jmoved):
        assert np.array_equal(a, b)
        assert np.array_equal(a, c) and np.array_equal(b, d)


@pytest.mark.parametrize("seed", [5, 1722])
def test_random_streams_relayout_parity_where_the_reference_fails(seed):
    """At these seeds a write during the migration makes the reference's
    dual-epoch stat report the wrong size, so relayout is visible there
    (ROADMAP Queue 3b).  The port inherits it: every observable equals the
    JAX package's, with and without the relayout.  A repair in the port,
    or a new divergence, shows here."""
    port = lambda p, **k: BBClient(p, device="cpu", **k)     # noqa: E731
    for relayout in (False, True):
        got = _random_stream(port, LiveMigrator, LayoutPolicy, seed,
                             relayout)
        want = _random_stream(JBBClient, JLiveMigrator, JLayoutPolicy, seed,
                              relayout)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a, b), relayout


# ---------------------------------------------------------------------------
# the controller, end to end, against the JAX controller
# ---------------------------------------------------------------------------
def _drifting(pkg, n=4, q=8, w=4, ticks=12):
    """``test_adapt._drifting_controller``'s stream through one package;
    returns (controller, client, history, reads ok)."""
    (Client, Policy, Controller, Cfg, Drift, Req) = pkg
    policy = Policy.from_scopes({SCOPE: LayoutMode.NODE_LOCAL}, n_nodes=n,
                                default=LayoutMode.DIST_HASH)
    client = Client(policy, cap=256, words=w, mcap=256, telemetry=True)
    ctl = Controller(client, cfg=Cfg(
        drift=Drift(patience=2, cooldown=3, min_weight=4.0),
        horizon_rounds=1e4, step_chunks=16))
    rng = np.random.RandomState(0)
    paths = [[f"{SCOPE}/c{i}" for _ in range(q)] for i in range(n)]
    cid = np.tile(np.arange(q, dtype=np.int32), (n, 1))
    pay = rng.randint(0, 999, (n, q, w)).astype(np.int32)
    client.write(client.encode(paths, chunk_id=cid, payload=pay))
    ctl.tick()
    perm = np.roll(np.arange(n), 1)
    rreq = client.encode([paths[i] for i in perm], chunk_id=cid[perm])
    ok = True
    for _ in range(ticks):
        out, found = client.read(rreq)
        ok &= bool(_np(found).all()) and np.array_equal(_np(out), pay[perm])
        ctl.tick()
    return ctl, client, ok


JPKG = (JBBClient, JLayoutPolicy, JController, JAdaptConfig, JDriftConfig,
        JBBRequest)
TPKG = (lambda p, **k: BBClient(p, device="cpu", **k), LayoutPolicy,
        AdaptationController, AdaptConfig, DriftConfig, BBRequest)


def _report(r):
    return (r.tick, r.phase, r.fired, r.watermark, r.total_chunks, r.epoch,
            None if r.delta is None else (r.delta.scope, int(r.delta.old_mode),
                                          int(r.delta.new_mode)))


def test_controller_decisions_match_the_jax_controller():
    jctl, jclient, jok = _drifting(JPKG, ticks=16)
    tctl, tclient, tok = _drifting(TPKG, ticks=16)
    assert jok and tok
    assert [_report(r) for r in tctl.history] == \
        [_report(r) for r in jctl.history]
    for a, b in zip(tctl.history, jctl.history):
        assert a.divergence.keys() == b.divergence.keys()
        for k in b.divergence:
            assert a.divergence[k] == pytest.approx(b.divergence[k],
                                                    rel=HOST_RTOL)
        assert a.gate.keys() == b.gate.keys()
        for k in b.gate:
            assert a.gate[k] == pytest.approx(b.gate[k], rel=HOST_RTOL)
    phases = [r.phase for r in tctl.history]
    assert phases.count("adopted") == 1 and "completed" in phases
    assert tclient.epoch == jclient.epoch and tclient.fallback is None
    assert [(s, int(m)) for s, m in tclient.policy.scopes] == \
        [(s, int(m)) for s, m in jclient.policy.scopes]
    assert_state_equal(jclient.state, tclient.state)
    ts, js = tctl.summary(), jctl.summary()
    assert ts["epoch"] == js["epoch"] and ts["completions"] == \
        js["completions"]
    assert [(a["tick"], a["new_mode"]) for a in ts["adoptions"]] == \
        [(a["tick"], a["new_mode"]) for a in js["adoptions"]]
    for prev, cur in zip(tctl.history, tctl.history[1:]):
        if prev.phase == "migrating":
            assert cur.phase in ("migrating", "completed")


def test_controller_never_adapts_the_default_bucket():
    policy = LayoutPolicy.from_scopes({SCOPE: LayoutMode.NODE_LOCAL},
                                      n_nodes=4,
                                      default=LayoutMode.NODE_LOCAL)
    client = BBClient(policy, device="cpu", cap=256, words=4, mcap=256,
                      telemetry=True)
    ctl = AdaptationController(
        client, cfg=AdaptConfig(drift=DriftConfig(patience=1, cooldown=0,
                                                  min_weight=1.0),
                                horizon_rounds=1e9))
    rng = np.random.RandomState(0)
    req = BBRequest(
        path_hash=torch.as_tensor(rng.randint(1, 1 << 20, (4, 8)),
                                  dtype=torch.int32),
        chunk_id=torch.zeros((4, 8), dtype=torch.int32),
        payload=torch.as_tensor(rng.randint(0, 9, (4, 8, 4)),
                                dtype=torch.int32))
    client.write(req)
    ctl.tick()
    for _ in range(6):
        client.read(req)
        assert ctl.tick().phase in ("idle", "drifted")
    assert all(s != tm.DEFAULT_SCOPE for s, _ in client.policy.scopes)


def test_controller_needs_telemetry():
    with pytest.raises(ValueError, match="telemetry=True"):
        AdaptationController(BBClient(_policy(), device="cpu", cap=8,
                                      words=W, mcap=8))


# ---------------------------------------------------------------------------
# the train loop's adaptation tick
# ---------------------------------------------------------------------------
def test_train_loop_runs_the_adaptation_tick():
    """The loop ticks the controller on its cadence and re-points the
    checkpoint manager at the adapted plan when a tick adopts (the
    reference's test at gemma3-1b's reduced size, through the port)."""
    from repro_torch.configs import all_configs
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import LoopConfig, run_training

    adopted_policy = LayoutPolicy.from_scopes(
        {"ckpt": LayoutMode.DIST_HASH}, n_nodes=8,
        default=LayoutMode.DIST_HASH)

    class StubController:
        """Duck-typed controller: adopts a new plan on its 2nd tick."""

        def __init__(self):
            self.ticks = 0
            self.client = type("C", (), {"policy": adopted_policy,
                                         "obs": rec})()

        def tick(self):
            self.ticks += 1
            return TickReport(self.ticks,
                              "adopted" if self.ticks == 2 else "idle")

    from repro_torch.core import obs
    rec = obs.TraceRecorder()
    ctl = StubController()
    cfg = all_configs()["gemma3-1b"].reduced()
    with tempfile.TemporaryDirectory() as d:
        res = run_training(build_model(cfg), cfg, batch_size=2, seq_len=16,
                           loop_cfg=LoopConfig(steps=6, ckpt_every=3,
                                               ckpt_dir=d,
                                               adapt_controller=ctl,
                                               adapt_every=2),
                           device="cpu")
        metas = {p.name: json.loads(p.read_text())
                 for p in pathlib.Path(d).glob("ckpt_*.json")}
    assert metas["ckpt_3.json"]["layout_mode"] == int(LayoutMode.NODE_LOCAL)
    assert metas["ckpt_6.json"]["layout_mode"] == int(LayoutMode.DIST_HASH)
    assert res.final_step == 6
    assert ctl.ticks == 3
    # each tick under a train.adapt_tick span on the client's recorder
    assert [(s.name, s.args["step"]) for s in rec.spans] == \
        [("train.adapt_tick", 2), ("train.adapt_tick", 4),
         ("train.adapt_tick", 6)]
