"""The port's mesh backend against the JAX package and against the port's
stacked backend.

In-process, against the JAX package (its stacked backend: the reference
runs the mesh plans' executors there too, ``tests/test_exchange_plan.py``):
``MeshRaggedSpec``, ``plan_mesh_ragged_spec`` and ``_ragged_floor_diag``,
``pick_mesh_executor`` and its audit record, ``build_executor``'s mesh
branch, and the mesh-ragged lifecycle (padded, ppermute pipelined and
not) through the port's stacked engine, bit for bit.

On spawned gloo ranks (marker ``mesh``), twins of the reference's mesh
tests: the mesh client against the stacked port on 8 and 4 ranks, the
pinned interleaved stream's digest, a forced-ppermute write, the telemetry
reduction, the relayout, the compacted-overflow and lossless-carry
parity, and the dry-run's BB cell.  Each rank group is one spawn: its
ranks run every scenario and record each one's outcome, and each test
reads one.  A group that outlives its time limit is killed and its
scenarios fail; a collective that waits on a rank which went elsewhere
times out inside gloo.  Every rank computes with one thread.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import burst_buffer as jbb
from repro.core import exchange_plan as jxp
from repro.core import exchange_select as jxs
from repro.core import obs as jobs
from repro.core.client import BBClient as JBBClient
from repro.core.client import BBRequest as JBBRequest
from repro.core.layouts import route_data as j_route_data
from repro.core.layouts import route_meta as j_route_meta
from repro.core.policy import LayoutPolicy as JLayoutPolicy
from repro_torch.core import burst_buffer as bb
from repro_torch.core import exchange_plan as xp
from repro_torch.core import exchange_select as xs
from repro_torch.core import mesh_engine as me
from repro_torch.core import obs
from repro_torch.core.client import BBClient
from repro_torch.core.layouts import LayoutMode, route_data
from repro_torch.core.policy import LayoutPolicy

ROOT = Path(__file__).resolve().parents[1]
N, Q, W = 8, 16, 8
SCOPES = {"/bb/hot": 4, "/bb/meta2": 2}            # HYBRID, CENTRAL_META


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(torch.int32)


def tbool(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, bool))


def _batch(seed=0, n=N, q=Q, w=W, modes=(2, 3)):
    """``tests/test_exchange_plan.py::_batch``, in numpy."""
    rng = np.random.RandomState(seed)
    ph = rng.randint(1, 1 << 20, (n, q)).astype(np.int32)
    cid = rng.randint(0, 4, (n, q)).astype(np.int32)
    pay = rng.randint(0, 9999, (n, q, w)).astype(np.int32)
    valid = rng.rand(n, q) > 0.15
    mode = rng.choice(list(modes), (n, q)).astype(np.int32)
    return ph, cid, pay, valid, mode


def _skewed_batch(kind, seed, n=N, q=Q, w=W):
    """``tests/test_exchange_plan.py::_skewed_batch``, in numpy."""
    rng = np.random.RandomState(seed)
    if kind == "one_file":
        ph = np.repeat(rng.randint(1, 1 << 20, (n, 1)), q, axis=1)
        cid = np.tile(np.arange(q, dtype=np.int32), (n, 1))
    elif kind == "incast":
        ph = np.full((n, q), 7919, np.int32)
        cid = rng.randint(0, 3, (n, q))
    else:
        hot = np.repeat(rng.randint(1, 1 << 20, (n, 1)), q // 2, axis=1)
        spread = rng.randint(1, 1 << 20, (n, q - q // 2))
        ph = np.concatenate([hot, spread], axis=1)
        cid = rng.randint(0, 3, (n, q))
    pay = np.broadcast_to(((ph * 7 + cid) % 9973)[..., None],
                          (n, q, w)).astype(np.int32)
    return ph.astype(np.int32), cid.astype(np.int32), pay


def _ranks(n=N):
    return np.arange(n, dtype=np.int32)[:, None]


def assert_state_equal(jstate, tstate):
    for x, y in zip(jstate.tree_flatten()[0], bb.to_numpy(tstate)):
        np.testing.assert_array_equal(np.asarray(x), y)


def _same_spec(t, j):
    assert (t.budgets, t.round_widths, t.executor) == \
        (j.budgets, j.round_widths, j.executor)


# ---------------------------------------------------------------------------
# specs, the planner's mesh branch, the executor pick
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [((1,), (1,), "bogus"),
                                  ((1, 1), (1,), "padded")])
def test_mesh_ragged_spec_validation_matches_reference(args):
    with pytest.raises(ValueError) as te:
        xp.MeshRaggedSpec(*args)
    with pytest.raises(ValueError) as je:
        jxp.MeshRaggedSpec(*args)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("fields", [((8, 2, 0, 4), (8, 4, 0, 2), "ppermute"),
                                    ((0, 0, 0), (0, 0, 0), "padded"),
                                    ((3,), (5,), "padded"), ((), (), "padded")])
def test_mesh_ragged_spec_tables_and_hash_match_reference(fields):
    t, j = xp.MeshRaggedSpec(*fields), jxp.MeshRaggedSpec(*fields)
    for name in ("n_nodes", "bmax", "total", "exchanged_cols"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("offsets", "col_round", "col_pos"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert hash(t) == hash(xp.MeshRaggedSpec(*fields)) and \
        t == xp.MeshRaggedSpec(*fields)


def _hist_dest(kind, n, q, seed):
    """(dest, valid) of one histogram shape: random, one-file, incast,
    lopsided (through the routing of a hashed policy), each node to its
    next neighbour, every node to itself, all invalid, or no requests."""
    rng = np.random.RandomState(seed)
    if kind in ("one_file", "incast", "lopsided"):
        ph, cid, _ = _skewed_batch(kind, seed, n, q)
        dest = j_route_data(np.full(ph.shape, 3, np.int32), n, ph, cid,
                            _ranks(n), xp=np)
        return np.asarray(dest, np.int32), np.ones(ph.shape, bool)
    if kind == "next":
        return (np.repeat((np.arange(n) + 1)[:, None] % n, q, 1)
                .astype(np.int32), np.ones((n, q), bool))
    if kind == "self":
        return (np.repeat(np.arange(n)[:, None], q, 1).astype(np.int32),
                np.ones((n, q), bool))
    if kind == "empty":
        return np.zeros((n, 0), np.int32), np.zeros((n, 0), bool)
    dest = rng.randint(0, n, (n, q)).astype(np.int32)
    valid = rng.rand(n, q) > (0.15 if kind == "random" else 1.0)
    return dest, valid


@pytest.mark.parametrize("kind", ["random", "one_file", "incast", "lopsided",
                                  "next", "self", "invalid", "empty"])
@pytest.mark.parametrize("n,q", [(8, 16), (4, 8), (1, 5), (16, 33)])
def test_plan_mesh_ragged_spec_matches_reference(kind, n, q):
    """Budgets, round widths and the executor pick, at align 1 and 8, with
    and without a floor, with explicit ``node_ids``, ppermute allowed or
    not, at two row widths; plus ``_ragged_floor_diag``."""
    dest, valid = _hist_dest(kind, n, q, seed=n + q)
    rng = np.random.RandomState(q)
    floor = rng.randint(0, q + 1, n)
    node_ids = rng.permutation(n)
    for kw in (dict(align=1), dict(), dict(floor=floor),
               dict(align=1, node_ids=node_ids),
               dict(allow_ppermute=False, floor=floor),
               dict(align=1, row_bytes=4 * (262144 + 3))):
        t = xp.plan_mesh_ragged_spec(t32(dest), tbool(valid), n, **kw)
        j = jxp.plan_mesh_ragged_spec(jnp.asarray(dest), jnp.asarray(valid),
                                      n, **kw)
        _same_spec(t, j)
    np.testing.assert_array_equal(
        xp._ragged_floor_diag(floor, node_ids, n),
        jxp._ragged_floor_diag(floor, node_ids, n))


def test_plan_mesh_ragged_spec_measures_diagonals():
    """``tests/test_exchange_plan.py:108``'s cases: round k is the widest
    (source → source + k) run; self traffic is round 0, which crosses
    nothing."""
    n, q = 4, 8
    dest = t32([[(i + 1) % n] * q for i in range(n)])
    valid = torch.ones((n, q), dtype=torch.bool)
    spec = xp.plan_mesh_ragged_spec(dest, valid, n, align=1)
    assert spec.round_widths == (0, q, 0, 0)
    assert spec.budgets == (q, q, q, q) and spec.exchanged_cols == q
    spec0 = xp.plan_mesh_ragged_spec(t32([[i] * q for i in range(n)]), valid,
                                     n, align=1)
    assert spec0.round_widths == (q, 0, 0, 0) and spec0.exchanged_cols == 0


def _mesh_records(rec):
    return [(r.choice, r.inputs, r.alternatives, r.evidence)
            for r in rec.audit.records("mesh_executor")]


def test_pick_mesh_executor_and_audit_match_reference():
    """The pick and its ``mesh_executor`` record, under explicit models
    (``tests/test_exchange_plan.py:437``) and the artifacts' fabric model,
    over even, skewed and empty round sets."""
    cases = [(8, 8000, [1000] * 7), (8, 80000, [1000]), (8, 8000, [999] * 8),
             (32, 32 * 8 * 64, [64 * 8] * 3), (4, 0, []),
             (16, 10 ** 9, [10 ** 6] * 15)]
    rec, jrec = obs.TraceRecorder(), jobs.TraceRecorder()
    with obs.activate(rec), jobs.activate(jrec):
        for model in ((50.0, 100.0), (0.0, 100.0), None,
                      (10.0, 1e6, True)):
            for n, padded, rounds in cases:
                assert xs.pick_mesh_executor(n, padded, rounds, model) == \
                    jxs.pick_mesh_executor(n, padded, rounds, model)
    assert xs.pick_mesh_executor(8, 80000, [1000], (50.0, 100.0)) == \
        "ppermute"
    assert _mesh_records(rec) == _mesh_records(jrec)
    assert rec.metrics.counters == jrec.metrics.counters


def test_build_executor_mesh_branch_matches_reference():
    """Padded → ``UniformExecutor`` at ``bmax``, no carry; ppermute →
    ``PermuteExecutor`` with the config's ``pipeline``; the meta role reads
    the meta spec; fusion as the reference's (``:57-87``)."""
    tpol = LayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=3)
    jpol = JLayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=3)
    specs = {"padded": ((8, 0, 3, 1, 1, 1, 1, 1), (8,) * N),
             "ppermute": ((8,) * N, (0, 8, 0, 0, 16, 0, 0, 8))}
    for ex, (b, w) in specs.items():
        for pipeline in (True, False):
            for role in ("data", "meta"):
                kw = dict(data_spec=None, meta_spec=None)
                kw["data_spec" if role == "data" else "meta_spec"] = \
                    (xp.MeshRaggedSpec(b, w, ex), jxp.MeshRaggedSpec(b, w, ex))
                t = xp.build_executor(role, tpol, Q, xp.ExchangeConfig(
                    "compacted", pipeline=pipeline,
                    **{k: v and v[0] for k, v in kw.items()}))
                j = jxp.build_executor(role, jpol, Q, jxp.ExchangeConfig(
                    "compacted", pipeline=pipeline,
                    **{k: v and v[1] for k, v in kw.items()}))
                assert type(t).__name__ == type(j).__name__
                assert t.carry_budget == j.carry_budget
                if ex == "padded":
                    assert t.budget == j.budget == 8
                else:
                    assert t.pipeline == j.pipeline == pipeline
            tcfg = xp.ExchangeConfig("compacted", pipeline=pipeline,
                                     data_spec=xp.MeshRaggedSpec(b, w, ex),
                                     meta_spec=xp.MeshRaggedSpec(w, b, ex))
            jcfg = jxp.ExchangeConfig("compacted", pipeline=pipeline,
                                      data_spec=jxp.MeshRaggedSpec(b, w, ex),
                                      meta_spec=jxp.MeshRaggedSpec(w, b, ex))
            tf, jf = (xp.fused_write_plan(tpol, Q, tcfg),
                      jxp.fused_write_plan(jpol, Q, jcfg))
            assert (tf is None) == (jf is None)
            if tf is not None:
                assert [e.budget for e in tf] == [e.budget for e in jf]
            assert xp.exchange_footprint(tpol, Q, W, tcfg) == \
                jxp.exchange_footprint(jpol, Q, W, jcfg)


def test_permute_plan_needs_ranks_and_covers_measured_traffic():
    """A ppermute plan without the rows' ranks is refused; over measured
    widths it has zero overflow and one reply slot a valid request."""
    ph, cid, _, valid, mode = _batch(3)
    dest = route_data(t32(mode), N, t32(ph), t32(cid), t32(_ranks()))
    spec = xp.plan_mesh_ragged_spec(dest, tbool(valid), N, align=1)
    ex = xp.PermuteExecutor(N, xp.MeshRaggedSpec(spec.budgets,
                                                 spec.round_widths,
                                                 "ppermute"))
    with pytest.raises(ValueError, match="global ranks"):
        ex.plan(dest, tbool(valid))
    plan = ex.plan(dest, tbool(valid), client=t32(_ranks()))
    assert int(plan.overflow.sum()) == 0
    ri = plan.reply_idx.numpy()
    assert (ri[valid] >= 0).all()
    for r in range(N):
        assert len(set(ri[r][valid[r]].tolist())) == int(valid[r].sum())


# ---------------------------------------------------------------------------
# the mesh-ragged lifecycle through the stacked engine, against JAX
# ---------------------------------------------------------------------------
EXECUTORS = [("padded", True), ("ppermute", True), ("ppermute", False)]


def _configs(dest, owner, valid, executor, pipeline):
    """The port's and the JAX package's configs over the same measured
    padded specs, forced to ``executor`` (``_spec_pair`` of the reference
    test), after checking the two planners agree."""
    out = []
    for lib, d, o, v in ((xp, t32(dest), t32(owner), tbool(valid)),
                         (jxp, jnp.asarray(dest), jnp.asarray(owner),
                          jnp.asarray(valid))):
        ds = lib.plan_mesh_ragged_spec(d, v, N, allow_ppermute=False)
        ms = lib.plan_mesh_ragged_spec(o, v, N, allow_ppermute=False)
        ds, ms = (lib.MeshRaggedSpec(s.budgets, s.round_widths, executor)
                  for s in (ds, ms))
        out.append(lib.ExchangeConfig("compacted", data_spec=ds,
                                      meta_spec=ms, pipeline=pipeline))
    _same_spec(out[0].data_spec, out[1].data_spec)
    _same_spec(out[0].meta_spec, out[1].meta_spec)
    return out


@pytest.mark.parametrize("executor,pipeline", EXECUTORS)
def test_mesh_ragged_lifecycle_matches_reference(executor, pipeline):
    """Tables after the write, the two-phase read's replies and the stat
    triples of a mixed hybrid/hashed batch, through the port's stacked
    engine with the mesh plans, equal the JAX engine's under the same
    plans, and the port's dense plane (``tests/test_exchange_plan.py:
    152-197``)."""
    tpol = LayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=3)
    jpol = JLayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=3)
    ph, cid, pay, valid, mode = _batch(1, modes=(2, 3, 4))
    owner = j_route_meta(mode, N, jpol.n_md_servers, ph, _ranks(), xp=np)
    dest_w = j_route_data(mode, N, ph, cid, _ranks(), xp=np)
    tcfg, jcfg = _configs(dest_w, owner, valid, executor, pipeline)
    targs = (t32(ph), t32(cid), t32(pay), tbool(valid))
    jargs = tuple(jnp.asarray(a) for a in (ph, cid, pay, valid))

    ts = bb.forward_write(bb.init_state(N, 256, W, 256, device="cpu"), tpol,
                          *targs, mode=t32(mode), config=tcfg)
    js = jbb.forward_write(jbb.init_state(N, 256, W, 256), jpol, *jargs,
                           mode=jnp.asarray(mode), config=jcfg)
    assert_state_equal(js, ts)
    td = bb.forward_write(bb.init_state(N, 256, W, 256, device="cpu"), tpol,
                          *targs, mode=t32(mode), config=bb.DENSE)
    for a, b in zip(bb.to_numpy(ts), bb.to_numpy(td)):
        np.testing.assert_array_equal(a, b)

    stat = np.full(ph.shape, bb.OP_STAT, np.int32)
    zeros = np.zeros(ph.shape, np.int32)
    _, fm, _, loc = bb.meta_op(ts, tpol, t32(stat), t32(ph), t32(zeros),
                               t32(zeros - 1), tbool(valid & (mode == 4)),
                               mode=t32(mode), config=tcfg)
    data_loc = torch.where(fm & (loc >= 0), loc,
                           t32(_ranks()).expand(N, Q)).numpy()
    dest_r = j_route_data(mode, N, ph, cid, _ranks(), data_loc=data_loc,
                          xp=np)
    tcfg_r, jcfg_r = _configs(dest_r, owner, valid, executor, pipeline)
    tp, tf = bb.forward_read(ts, tpol, t32(ph), t32(cid), tbool(valid),
                             mode=t32(mode), config=tcfg_r,
                             data_loc=t32(data_loc))
    jp, jf = jbb.forward_read(js, jpol, *(jargs[:2] + jargs[3:]),
                              mode=jnp.asarray(mode), config=jcfg_r,
                              data_loc=jnp.asarray(data_loc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf[valid].all()
    tm = bb.meta_op(ts, tpol, t32(stat), t32(ph), t32(zeros), t32(zeros - 1),
                    tbool(valid), mode=t32(mode), config=tcfg)
    jm = jbb.meta_op(js, jpol, jnp.asarray(stat), jnp.asarray(ph),
                     jnp.asarray(zeros), jnp.asarray(zeros - 1),
                     jnp.asarray(valid), mode=jnp.asarray(mode), config=jcfg)
    for a, b in zip(tm[1:], jm[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_state_equal(jm[0], tm[0])


@pytest.mark.parametrize("executor,pipeline", EXECUTORS)
@pytest.mark.parametrize("kind", ["one_file", "incast", "lopsided"])
def test_mesh_ragged_plans_lossless_on_skewed_histograms(kind, executor,
                                                         pipeline):
    """Measured mesh-ragged plans cover skewed histograms: the write's
    tables equal the JAX engine's under the same plan and the dense
    plane's (``tests/test_exchange_plan.py:263``), and the read finds
    every chunk."""
    tpol = LayoutPolicy.uniform(LayoutMode.DIST_HASH, N)
    jpol = JLayoutPolicy.uniform(LayoutMode.DIST_HASH, N)
    ph, cid, pay = _skewed_batch(kind, seed=11)
    valid = np.ones(ph.shape, bool)
    mode = np.full(ph.shape, 3, np.int32)
    dest = j_route_data(mode, N, ph, cid, _ranks(), xp=np)
    owner = j_route_meta(mode, N, jpol.n_md_servers, ph, _ranks(), xp=np)
    tcfg, jcfg = _configs(dest, owner, valid, executor, pipeline)
    ts = bb.forward_write(bb.init_state(N, 4 * Q, W, 4 * Q, device="cpu"),
                          tpol, t32(ph), t32(cid), t32(pay), tbool(valid),
                          mode=t32(mode), config=tcfg)
    js = jbb.forward_write(jbb.init_state(N, 4 * Q, W, 4 * Q), jpol,
                           jnp.asarray(ph), jnp.asarray(cid),
                           jnp.asarray(pay), jnp.asarray(valid),
                           mode=jnp.asarray(mode), config=jcfg)
    assert_state_equal(js, ts)
    jd = jbb.forward_write(jbb.init_state(N, 4 * Q, W, 4 * Q), jpol,
                           jnp.asarray(ph), jnp.asarray(cid),
                           jnp.asarray(pay), jnp.asarray(valid),
                           mode=jnp.asarray(mode), config=jbb.DENSE)
    assert_state_equal(jd, ts)
    out, found = bb.forward_read(ts, tpol, t32(ph), t32(cid), tbool(valid),
                                 mode=t32(mode), config=tcfg)
    assert found.all() and np.array_equal(out.numpy(), pay)


@pytest.mark.parametrize("budget", [1, 2, Q // 4, Q])
@pytest.mark.parametrize("kind", ["one_file", "incast", "lopsided"])
def test_lossless_plane_on_skewed_histograms_matches_reference(kind, budget):
    """The port's lossless compacted client at a uniform budget built to
    overflow equals the JAX dense client on every observable
    (``tests/test_exchange_plan.py:234``)."""
    ph, cid, pay = _skewed_batch(kind, seed=budget)
    kw = dict(cap=4 * Q, words=W, mcap=4 * Q)
    tight = BBClient(LayoutPolicy.uniform(LayoutMode.DIST_HASH, N),
                     device="cpu", exchange="compacted", budget=budget,
                     meta_budget=Q, **kw)
    dense = JBBClient(JLayoutPolicy.uniform(LayoutMode.DIST_HASH, N),
                      exchange="dense", **kw)
    from repro_torch.core.client import BBRequest
    treq = BBRequest(path_hash=t32(ph), chunk_id=t32(cid), payload=t32(pay))
    jreq = JBBRequest(path_hash=jnp.asarray(ph), chunk_id=jnp.asarray(cid),
                      payload=jnp.asarray(pay))
    tight.write(treq)
    dense.write(jreq)
    assert int(tight.state.dropped.sum()) == 0
    for f in ("data_count", "meta_count"):
        np.testing.assert_array_equal(getattr(tight.state, f).numpy(),
                                      np.asarray(getattr(dense.state, f)))
    for a, b in zip(tight.read(treq) + tight.stat(treq),
                    dense.read(jreq) + dense.stat(jreq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# a mesh of one rank, in this process
# ---------------------------------------------------------------------------
@pytest.fixture
def world1():
    """A gloo mesh of this process alone, its process group destroyed
    after the test."""
    assert not dist.is_initialized()
    mesh = me.make_node_mesh(1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_mesh_rejects_packed_specs_and_ppermute_off_the_ring(world1):
    """``tests/test_compacted_exchange.py:869-892``: a packed
    ``RaggedSpec`` is refused, a padded ``MeshRaggedSpec`` is carried, a
    ppermute spec needs nodes 1:1 with ranks — with the reference's
    messages; a 1-node client on 1 rank plans ragged and may rotate."""
    pol1 = LayoutPolicy.uniform(LayoutMode.DIST_HASH, 1)
    with pytest.raises(ValueError, match="ragged") as te:
        me.build_mesh_ops(world1, pol1, bb.ExchangeConfig(
            "compacted", data_spec=bb.RaggedSpec((1,))))
    me.build_mesh_ops(world1, pol1, bb.ExchangeConfig(
        "compacted", data_spec=bb.MeshRaggedSpec((1,), (1,))))
    with pytest.raises(ValueError, match="ppermute") as tp:
        me.build_mesh_probe(
            world1, LayoutPolicy.uniform(LayoutMode.DIST_HASH, 2),
            bb.ExchangeConfig("compacted", meta_spec=bb.MeshRaggedSpec(
                (1, 1), (1, 1), "ppermute")))
    from repro.core.mesh_engine import _check_specs as j_check
    for err, cfg, local_n in (
            (te, jbb.ExchangeConfig("compacted",
                                    data_spec=jbb.RaggedSpec((1,))), 1),
            (tp, jbb.ExchangeConfig("compacted", data_spec=jbb.MeshRaggedSpec(
                (1, 1), (1, 1), "ppermute")), 2)):
        with pytest.raises(ValueError) as je:
            j_check(cfg, local_n)
        assert str(err.value) == str(je.value)
    client = BBClient(pol1, world1, cap=16, words=4, mcap=16,
                      exchange="compacted", ragged=True)
    assert client.ragged and client._ppermute_ok
    assert not BBClient(LayoutPolicy.uniform(LayoutMode.DIST_HASH, 2),
                        world1, cap=16, words=4, mcap=16)._ppermute_ok
    with pytest.raises(ValueError, match="backend"):
        BBClient(pol1, "sharded", device="cpu")


def test_world_of_one_collectives(world1):
    """At world size 1 the shift is the identity, the all_to_all the
    stacked transpose, the global sum the sum, gather and shard identities,
    and the telemetry reduction the sum over the node axis."""
    assert world1.world == 1 and world1.backend == "gloo"
    x = torch.arange(4 * 4 * 3 * 2, dtype=torch.int32).reshape(4, 4, 3, 2)
    shift = me.build_mesh_shift(world1)
    for k in (0, 1, -3):
        assert shift(x, k) is x
    assert torch.equal(me.mesh_exchange(x, world1), xp.stacked_exchange(x))
    b = x > 40
    assert torch.equal(me.mesh_exchange(b, world1), xp.stacked_exchange(b))
    assert int(me.mesh_global_sum(x, world1)) == int(x.sum())
    assert world1.gather(x) is x and torch.equal(world1.shard(x), x)
    counts = torch.rand(4, 3, 15)
    torch.testing.assert_close(me.build_telemetry_reduce(world1)(counts),
                               counts.sum(dim=0))
    with pytest.raises(ValueError, match="2 ranks"):
        me.make_node_mesh(2, device="cpu")


def test_world_of_one_client_matches_stacked(world1):
    """The compacted mesh client on one gloo rank equals the stacked client
    on every observable of a mixed batch, the tables included, and plans
    only padded mesh specs at 8 nodes a rank."""
    pol = LayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=3)
    ph, cid, pay, valid, _ = _batch(2)
    from repro_torch.core.client import BBRequest
    paths = [[f"/bb/hot/r{i}/f{j % 3}" if j % 2 else f"/shared/g{i}{j}"
              for j in range(Q)] for i in range(N)]
    kw = dict(cap=128, words=W, mcap=128, telemetry=True,
              exchange="compacted")
    clients = [BBClient(pol, world1, **kw),
               BBClient(pol, device="cpu", **kw)]
    outs = []
    for c in clients:
        req = c.encode(paths, chunk_id=cid, payload=pay, valid=valid)
        c.write(req)
        rot = BBRequest(path_hash=torch.roll(req.path_hash, 1, 0),
                        chunk_id=torch.roll(req.chunk_id, 1, 0),
                        scope_hash=torch.roll(req.scope_hash, 1, 0))
        outs.append(list(c.read(rot)) + list(c.stat(req)) +
                    list(bb.to_numpy(c.state)) + [c.telemetry.snapshot()])
    for a, b in zip(outs[0][:-1], outs[1][:-1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # per-node counters are summed after, not in one pass: float rounding
    # only, and the extent maximum becomes a sum of the nodes' maxima (as
    # the reference's per-node layout, tests/test_exchange_plan.py:400)
    from repro_torch.core.adapt.telemetry import F_EXTENT_MAX
    cols = [c for c in range(outs[0][-1].shape[1]) if c != F_EXTENT_MAX]
    np.testing.assert_allclose(outs[0][-1][:, cols], outs[1][-1][:, cols],
                               rtol=1e-6)
    specs = list(clients[0].last_specs.values())
    assert specs and all(isinstance(s, bb.MeshRaggedSpec) and
                         s.executor == "padded" for s in specs)


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------
RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, datetime, json, sys, traceback
    from pathlib import Path
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], Path(sys.argv[4]))
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    from repro_torch.core import burst_buffer as bb
    from repro_torch.core.client import BBClient, BBRequest
    from repro_torch.core.layouts import LayoutMode, route_data, route_meta
    from repro_torch.core.mesh_engine import (build_mesh_ops,
                                              build_telemetry_reduce,
                                              make_node_mesh)
    from repro_torch.core.policy import LayoutPolicy
    mesh = make_node_mesh(world, device="cpu")
    G = mesh.gather

    def gather_state(state, mesh):
        # every node's tables (numpy, in field order) from the ranks'
        return tuple(G(getattr(state, f.name)).numpy()
                     for f in dataclasses.fields(bb.BBState))

    def t32(x):
        return torch.as_tensor(np.asarray(x)).to(torch.int32)

    def same(a, b, what):
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert np.array_equal(a, b), what

    def uniform_modes():
        # tests/test_mesh_engine.py, every exchange plane
        N, q, w = 8, 6, 16
        for mode in LayoutMode:
            policy = LayoutPolicy.uniform(mode, N)
            for ex in ("auto", "compacted", "dense"):
                mc = BBClient(policy, mesh, cap=128, words=w, mcap=128,
                              exchange=ex)
                sc = BBClient(policy, device="cpu", cap=128, words=w,
                              mcap=128, exchange=ex)
                rng = np.random.RandomState(int(mode))
                ph = t32(rng.randint(1, 10000, (N, q)))
                cid = t32(rng.randint(0, 4, (N, q)))
                pay = t32(rng.randint(0, 1000, (N, q, w)))
                wreq = BBRequest(path_hash=ph, chunk_id=cid, payload=pay)
                mc.write(wreq)
                sc.write(wreq)
                perm = torch.as_tensor(rng.permutation(N))
                rreq = BBRequest(path_hash=ph[perm], chunk_id=cid[perm])
                out_m, f_m = (G(x) for x in mc.read(rreq))
                out_s, f_s = sc.read(rreq)
                assert f_m.all() and f_s.all(), (mode, ex)
                same(out_m, out_s, (mode, ex))
                same(out_m, pay[perm], (mode, ex))
                for a, b in zip(mc.stat(wreq), sc.stat(wreq)):
                    same(G(a), b, (mode, ex, "stat"))
                for a, b in zip(gather_state(mc.state, mesh),
                                bb.to_numpy(sc.state)):
                    same(a, b, (mode, ex, "tables"))

    def pinned_stream():
        # tests/test_exchange_plan.py:466-546, part 1 (and 3: telemetry)
        from test_torch_cuda import (STREAM_DIGEST, adapt_digest,
                                     interleaved_stream)
        client, outs = interleaved_stream(False, backend=mesh)
        assert adapt_digest(*outs) == STREAM_DIGEST, adapt_digest(*outs)
        # auto picks dense at this shape: the compacted plane with its
        # mesh-ragged specs must give the same digest
        cc, outs = interleaved_stream(False, backend=mesh,
                                      exchange="compacted")
        assert adapt_digest(*outs) == STREAM_DIGEST, adapt_digest(*outs)
        specs = list(cc.last_specs.values())
        assert specs and all(isinstance(s, bb.MeshRaggedSpec)
                             for s in specs)
        tel = client.telemetry
        assert tel.per_node == 8 // world and tel.reduce is not None
        reduced = build_telemetry_reduce(mesh)(tel.counts).numpy()
        np.testing.assert_allclose(
            reduced, G(tel.counts).sum(dim=0).numpy(), rtol=1e-5,
            atol=1e-3)
        same(reduced, tel.snapshot(), "snapshot is the reduction")
        stacked, _ = interleaved_stream(False)
        cols = [c for c in range(reduced.shape[1]) if c != 10]  # extent max
        np.testing.assert_allclose(reduced[:, cols],
                                   stacked.telemetry.snapshot()[:, cols],
                                   rtol=1e-5, atol=1e-3)

    def forced_ppermute():
        # tests/test_exchange_plan.py:490-520
        N, q, w = 8, 16, 8
        pol = LayoutPolicy.from_scopes({"/bb/hot": LayoutMode.HYBRID},
                                       n_nodes=N,
                                       default=LayoutMode.DIST_HASH)
        rng = np.random.RandomState(0)
        ph = t32(rng.randint(1, 1 << 20, (N, q)))
        cid = t32(rng.randint(0, 4, (N, q)))
        pay = t32(rng.randint(0, 999, (N, q, w)))
        valid = torch.ones((N, q), dtype=torch.bool)
        mode = t32(rng.choice([3, 4], (N, q)))
        ranks = t32(np.arange(N)[:, None])
        dest = route_data(mode, N, ph, cid, ranks)
        owner = route_meta(mode, N, pol.n_md_servers, ph, ranks)
        ds = bb.plan_mesh_ragged_spec(dest, valid, N, allow_ppermute=False)
        ms = bb.plan_mesh_ragged_spec(owner, valid, N, allow_ppermute=False)
        dense = build_mesh_ops(mesh, pol, bb.DENSE)[0](
            bb.init_state(8 // world, 256, w, 256, device="cpu"), mode, ph,
            cid, pay, valid)
        for pipeline in (True, False):
            cfg = bb.ExchangeConfig(
                "compacted", pipeline=pipeline,
                data_spec=bb.MeshRaggedSpec(ds.budgets, ds.round_widths,
                                            "ppermute"),
                meta_spec=bb.MeshRaggedSpec(ms.budgets, ms.round_widths,
                                            "ppermute"))
            write, read, meta, _ = build_mesh_ops(mesh, pol, cfg)
            sm = write(bb.init_state(8 // world, 256, w, 256,
                                     device="cpu"), mode, ph, cid, pay,
                       valid)
            for a, b in zip(gather_state(sm, mesh),
                            gather_state(dense, mesh)):
                same(a, b, ("ppermute write", pipeline))
            stat = torch.full((N, q), bb.OP_STAT, dtype=torch.int32)
            zero = torch.zeros((N, q), dtype=torch.int32)
            _, fnd, size, _ = meta(sm, mode, stat, ph, zero, zero - 1,
                                   valid)
            assert G(fnd).all()
        # a forced-compacted mesh client plans mesh-ragged specs per call
        cc = BBClient(pol, mesh, cap=256, words=w, mcap=256,
                      exchange="compacted")
        cc.write(BBRequest(path_hash=ph, chunk_id=cid, payload=pay,
                           mode=mode))
        specs = cc.last_specs
        assert set(specs) == {"data", "meta"} and all(
            isinstance(s, bb.MeshRaggedSpec) for s in specs.values()), specs

    def bb_cell():
        from repro_torch.launch.dryrun import run_bb_cell
        rec = run_bb_cell(out / "dryrun", 8, mesh)
        assert rec["status"] == "ok" and rec["ranks"] == world

    def relayout():
        # tests/test_adapt.py:670-727
        from repro_torch.core.adapt import LiveMigrator
        N, q, w = 4, 6, 8
        policy = LayoutPolicy.from_scopes({"/bb/hot": LayoutMode.NODE_LOCAL},
                                          n_nodes=N,
                                          default=LayoutMode.DIST_HASH)
        clients = {"mesh": BBClient(policy, mesh, cap=128, words=w,
                                    mcap=128, telemetry=True),
                   "stacked": BBClient(policy, device="cpu", cap=128,
                                       words=w, mcap=128, telemetry=True)}
        rng = np.random.RandomState(0)
        paths = [[f"/bb/hot/r{i}/f{j % 2}" for j in range(q)]
                 for i in range(N)]
        cid = np.tile(np.arange(q, dtype=np.int32) // 2, (N, 1))
        pay = rng.randint(0, 9999, (N, q, w)).astype(np.int32)
        perm = torch.as_tensor(np.roll(np.arange(N), 1))
        obs = {}
        for name, c in clients.items():
            g = G if name == "mesh" else (lambda x: x)
            req = c.encode(paths, chunk_id=cid, payload=pay)
            c.write(req)
            rreq = BBRequest(path_hash=req.path_hash[perm],
                             chunk_id=req.chunk_id[perm],
                             scope_hash=req.scope_hash[perm])
            outs = []
            mig = LiveMigrator(c, "/bb/hot", LayoutMode.DIST_HASH,
                               step_chunks=4)
            while not mig.done:
                mig.step()
                out_, found = (g(x) for x in c.read(rreq))
                assert found.all(), (name, mig.watermark)
                outs += [out_, found] + [g(x) for x in c.stat(rreq)]
            mig.finish()
            out_, found = (g(x) for x in c.read(rreq))
            same(out_, pay[perm.numpy()], name)
            outs += [out_, found]
            outs += list(gather_state(c.state, mesh) if name == "mesh"
                         else bb.to_numpy(c.state))
            outs.append(c.telemetry.snapshot()[:, :9])   # integer-valued
            obs[name] = outs
        assert len(obs["mesh"]) == len(obs["stacked"])
        for a, b in zip(obs["mesh"], obs["stacked"]):
            same(a, b, "relayout observable")

    def _budget2(lossless):
        N, q, w = 4, 16, 8
        policy = LayoutPolicy.uniform(LayoutMode.DIST_HASH, N)
        kw = dict(cap=128, words=w, mcap=128, exchange="compacted",
                  budget=2, lossless=lossless)
        mc = BBClient(policy, mesh, **kw)
        ref = BBClient(policy, device="cpu", **(kw if not lossless else
                                                 dict(kw, exchange="dense")))
        rng = np.random.RandomState(0)
        req = BBRequest(path_hash=t32(rng.randint(1, 1 << 20, (N, q))),
                        chunk_id=t32(rng.randint(0, 4, (N, q))),
                        payload=t32(rng.randint(0, 999, (N, q, w))))
        mc.write(req)
        ref.write(req)
        tables = gather_state(mc.state, mesh)
        return mc, ref, req, tables

    def overflow():
        # tests/test_compacted_exchange.py:807: budget 2 < q, drops
        mc, sc, req, tables = _budget2(False)
        for a, b in zip(tables, bb.to_numpy(sc.state)):
            same(a, b, "overflow tables")
        assert tables[-1].sum() > 0
        for a, b in zip(mc.read(req) + mc.stat(req),
                        sc.read(req) + sc.stat(req)):
            same(G(a), b, "overflow replies")

    def lossless_carry():
        # tests/test_compacted_exchange.py:858: budget 2, carried
        mc, dn, req, tables = _budget2(True)
        assert tables[-1].sum() == 0
        same(tables[2], dn.state.data_count, "data_count")
        same(tables[6], dn.state.meta_count, "meta_count")
        out_m, f_m = (G(x) for x in mc.read(req))
        out_d, f_d = dn.read(req)
        same(out_m, out_d, "carry read")
        assert f_m.all()
        for a, b in zip(mc.stat(req), dn.stat(req)):
            same(G(a), b, "carry stat")

    results = {}
    for name in sys.argv[5].split(","):
        try:
            locals()[name]()
            results[name] = "ok"
        except Exception:
            results[name] = traceback.format_exc()
        (out / f"rank{rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()
""")

#: seconds a rank group may run before its ranks are killed
GROUP_TIMEOUT_S = 240
GROUPS = {8: ("uniform_modes", "pinned_stream", "forced_ppermute",
              "bb_cell"),
          4: ("relayout", "overflow", "lossless_carry")}


def _run_group(world, scenarios, tmp: Path) -> dict:
    """Spawn ``world`` gloo ranks running ``scenarios``; → {scenario:
    [each rank's outcome]} (a rank that recorded nothing, or was killed,
    gives its log instead)."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
             str(tmp / "store"), str(tmp), ",".join(scenarios)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    killed = False
    try:
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        killed = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    out = {s: [] for s in scenarios}
    for r in range(world):
        f = tmp / f"rank{r}.json"
        got = json.loads(f.read_text()) if f.exists() else {}
        log = (tmp / f"rank{r}.log").read_text()[-4000:]
        for s in scenarios:
            out[s].append(got.get(s, f"rank {r} recorded nothing"
                                     f"{' (killed)' if killed else ''}:\n"
                                     f"{log}"))
    return out


@pytest.fixture(scope="module")
def rank_groups(tmp_path_factory):
    """Each rank group's outcomes, spawned once for the module."""
    return {world: _run_group(world, scenarios,
                              tmp_path_factory.mktemp(f"ranks{world}"))
            for world, scenarios in GROUPS.items()}


def _assert_scenario(rank_groups, world, name):
    bad = [o for o in rank_groups[world][name] if o != "ok"]
    assert not bad, bad[0]


@pytest.mark.mesh
def test_mesh_client_matches_stacked_in_every_mode_on_8_ranks(rank_groups):
    """``tests/test_mesh_engine.py``: reads, stats and tables of the four
    uniform modes, through the auto, compacted and dense planes, equal
    the stacked port's bit for bit."""
    _assert_scenario(rank_groups, 8, "uniform_modes")


@pytest.mark.mesh
def test_mesh_pinned_stream_digest_and_telemetry_reduce_on_8_ranks(
        rank_groups):
    """The pinned interleaved stream through the mesh, under ``auto`` and
    under the compacted plane with its mesh-ragged specs, gives the
    reference's digest ``cfd76da6…``; ``build_telemetry_reduce`` equals
    the per-node counters' sum and the snapshot on every rank."""
    _assert_scenario(rank_groups, 8, "pinned_stream")


@pytest.mark.mesh
def test_mesh_forced_ppermute_write_equals_dense_on_8_ranks(rank_groups):
    """A forced-ppermute write (shift rounds over the real ring, pipelined
    and not) equals the dense write; a forced-compacted mesh client plans
    only ``MeshRaggedSpec``s."""
    _assert_scenario(rank_groups, 8, "forced_ppermute")


@pytest.mark.mesh
def test_dryrun_bb_cell_on_8_ranks(rank_groups):
    """``run_bb_cell``: the heterogeneous policy on 8 ranks, mesh/stacked
    parity."""
    _assert_scenario(rank_groups, 8, "bb_cell")


@pytest.mark.mesh
def test_mesh_relayout_matches_stacked_on_4_ranks(rank_groups):
    """``tests/test_adapt.py:670-727``: a ``LiveMigrator`` relayout on 4
    ranks gives every observable of the stacked port's (reads and stats at
    every watermark, the final tables, the telemetry's integer
    counters)."""
    _assert_scenario(rank_groups, 4, "relayout")


@pytest.mark.mesh
def test_mesh_compacted_overflow_parity_on_4_ranks(rank_groups):
    """``tests/test_compacted_exchange.py:807``: budget 2 < q under the
    drop plane, tables, reads and stats as the stacked port's."""
    _assert_scenario(rank_groups, 4, "overflow")


@pytest.mark.mesh
def test_mesh_lossless_carry_parity_on_4_ranks(rank_groups):
    """``tests/test_compacted_exchange.py:858``: the carry round's
    all-reduced predicate keeps the ranks in step; nothing dropped, every
    observable the dense plane's."""
    _assert_scenario(rank_groups, 4, "lossless_carry")


@pytest.mark.mesh
def test_dryrun_cli_spawns_its_ranks(tmp_path):
    """``python -m repro_torch.launch.dryrun --bb --device cpu --ranks 2``
    spawns two gloo ranks and writes the cell's record."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--bb",
         "--device", "cpu", "--ranks", "2", "--out", str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=GROUP_TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads((tmp_path / "bb-client__n8q8w16__node.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["ranks"] == 2 and \
        rec["backend"] == "gloo"
