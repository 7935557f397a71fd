"""The port's exchange planner against repro.core.exchange_plan: routing
plans, measured ragged specs, the stacked ragged exchange in both
directions, the fused write's receive views and the planner's gating — on
identical inputs, bit for bit.  The routing plans and specs go through
``route_plan``/``dest_budgets``, whose plain versions run here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exchange_plan as jxp
from repro.core.policy import LayoutPolicy as JLayoutPolicy
from repro.kernels.chunk_router.ops import histogram_rows2d as j_hist2d
from repro_torch.core import exchange_plan as txp
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy
from repro_torch.kernels.chunk_router.ref import (dest_budgets_ref,
                                                  route_plan_ref)


def _routing(seed, n=8, q=12, skew=False):
    rng = np.random.RandomState(seed)
    dest = rng.randint(0, n, (n, q)).astype(np.int32)
    if skew:
        dest[:, : q // 2] = rng.randint(0, 2)
    valid = rng.rand(n, q) > 0.25
    return dest, valid


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


@pytest.mark.parametrize("budget", [1, 2, 3, 12])
@pytest.mark.parametrize("seed", [0, 1])
def test_uniform_plan_matches_reference(seed, budget):
    dest, valid = _routing(seed, skew=seed == 1)
    ref = jxp._compact_plan(jnp.asarray(dest), jnp.asarray(valid), 8, budget)
    got = txp._compact_plan(torch.as_tensor(dest), torch.as_tensor(valid), 8,
                            budget)
    for a, b in zip(ref, got):
        _same(a, b)
        assert b.dtype == torch.int32


@pytest.mark.parametrize("align", [1, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_spec_and_plan_match_reference(seed, align):
    dest, valid = _routing(seed, skew=seed == 2)
    floor = np.arange(8) % 3 if seed == 1 else None
    jspec = jxp.plan_ragged_spec(jnp.asarray(dest), jnp.asarray(valid), 8,
                                 align=align, floor=floor)
    tspec = txp.plan_ragged_spec(torch.as_tensor(dest),
                                 torch.as_tensor(valid), 8, align=align,
                                 floor=floor)
    assert jspec.budgets == tspec.budgets
    ref = jxp._compact_plan_ragged(jnp.asarray(dest), jnp.asarray(valid), 8,
                                   jspec)
    got = txp._compact_plan_ragged(torch.as_tensor(dest),
                                   torch.as_tensor(valid), 8, tspec)
    for a, b in zip(ref, got):
        _same(a, b)
    assert int(got[2].sum()) == 0                 # measured ⇒ lossless


@pytest.mark.parametrize("budgets", [(3, 0, 1, 2), (0, 0, 0, 0), (4, 4, 4, 4),
                                     (0, 5, 0, 1)])
def test_ragged_exchange_both_directions_match_reference(budgets):
    n = len(budgets)
    rng = np.random.RandomState(sum(budgets))
    jspec, tspec = jxp.RaggedSpec(budgets), txp.RaggedSpec(budgets)
    x = rng.randint(1, 999, (n, jspec.total, 3)).astype(np.int32)
    _same(jxp.ragged_exchange(jnp.asarray(x), jspec, n),
          txp.ragged_exchange(torch.as_tensor(x), tspec, n))
    reply = rng.randint(1, 999, (n, n * jspec.bmax, 2)).astype(np.int32)
    _same(jxp.ragged_reply_exchange(jnp.asarray(reply), jspec, n),
          txp.ragged_reply_exchange(torch.as_tensor(reply), tspec, n))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fused_receive_views_match_reference_and_serial(seed):
    """The fused write's per-plane receive views equal the JAX fused
    buffer's split (payload columns), and each equals the plane's own
    serial receive view."""
    n, q, w = 8, 10, 5
    rng = np.random.RandomState(seed)
    dest, valid = _routing(seed, n, q, skew=seed % 2 == 1)
    owner = rng.randint(0, 3 if seed < 2 else n, (n, q)).astype(np.int32)
    fd = rng.randint(1, 999, (n, q, w + 3)).astype(np.int32)
    fd[..., -1] = 1
    fm = rng.randint(1, 999, (n, q, 5)).astype(np.int32)
    fm[..., -1] = 1
    jv, tv = jnp.asarray(valid), torch.as_tensor(valid)
    sd = jxp.plan_ragged_spec(jnp.asarray(dest), jv, n, align=1)
    sm = jxp.plan_ragged_spec(jnp.asarray(owner), jv, n, align=1)
    j_ex = (jxp.RaggedExecutor(n, sd), jxp.RaggedExecutor(n, sm))
    t_ex = (txp.RaggedExecutor(n, txp.RaggedSpec(sd.budgets)),
            txp.RaggedExecutor(n, txp.RaggedSpec(sm.budgets)))
    jpd, jpm = (j_ex[0].plan(jnp.asarray(dest), jv),
                j_ex[1].plan(jnp.asarray(owner), jv))
    tpd, tpm = (t_ex[0].plan(torch.as_tensor(dest), tv),
                t_ex[1].plan(torch.as_tensor(owner), tv))
    width = w + 3
    pad = np.zeros((n, q, width - 5), np.int32)
    fm_wide = np.concatenate([fm[..., :-1], pad, fm[..., -1:]], axis=-1)
    ref = jxp.fused_send(j_ex[0], jpd, jnp.asarray(fd), j_ex[1], jpm,
                         jnp.asarray(fm_wide), jxp.stacked_exchange)
    got = txp.fused_send(t_ex[0], tpd, torch.as_tensor(fd), t_ex[1], tpm,
                         torch.as_tensor(fm))
    _same(ref[0], got[0])
    _same(ref[1], got[1])
    _same(np.asarray(ref[2])[..., :4], got[2])
    _same(ref[3], got[3])
    serial_d = t_ex[0].send(tpd, torch.as_tensor(fd))
    serial_m = t_ex[1].send(tpm, torch.as_tensor(fm))
    for a, b in zip(serial_d + serial_m, got):
        assert torch.equal(a, b)


def _hetero(n=8):
    scopes = {"/bb/ckpt": 4, "/bb/shared": 3}
    return (JLayoutPolicy.from_scopes(scopes, n_nodes=n, default=2),
            LayoutPolicy.from_scopes(scopes, n_nodes=n, default=2))


@pytest.mark.parametrize("kw", [dict(kind="dense"), dict(kind="compacted"),
                                dict(kind="compacted", budget=2),
                                dict(kind="compacted", lossless=False),
                                dict(kind="compacted", pipeline=False),
                                dict(kind="compacted", meta_budget=3)])
def test_planner_gating_matches_reference(kw):
    jp, tp = _hetero()
    jc, tc = jxp.ExchangeConfig(**kw), txp.ExchangeConfig(**kw)
    for q in (0, 4, 16):
        assert jxp.data_budget(jp, q, jc) == txp.data_budget(tp, q, tc)
        assert jxp.meta_budget(jp, q, jc) == txp.meta_budget(tp, q, tc)
        for role in ("data", "meta"):
            je = jxp.build_executor(role, jp, q, jc)
            te = txp.build_executor(role, tp, q, tc)
            assert type(je).__name__ == type(te).__name__
            assert je.carry_budget == te.carry_budget
        jf, tf = jxp.fused_write_plan(jp, q, jc), txp.fused_write_plan(tp, q,
                                                                       tc)
        assert (jf is None) == (tf is None)
    spec = txp.RaggedSpec((8, 0, 8, 8, 0, 0, 8, 8))
    ragged = txp.ExchangeConfig("compacted", data_spec=spec, meta_spec=spec)
    assert isinstance(txp.fused_write_plan(tp, 8, ragged)[0],
                      txp.RaggedExecutor)
    with pytest.raises(ValueError, match="unknown exchange kind"):
        txp.ExchangeConfig("bogus")


@pytest.mark.parametrize("budget", [1, 2, 5])
def test_run_exchange_carry_round_matches_reference(budget):
    """A lookup-style round at a tight uniform budget: the eager carry
    predicate serves every request, with replies equal to the JAX
    ``lax.cond`` carry's."""
    n, q = 4, 10
    dest, valid = _routing(budget, n, q, skew=True)
    vals = np.random.RandomState(9).randint(1, 99, (n, q)).astype(np.int32)

    def fields(xp, v):
        return xp.stack([v, xp.ones_like(v)], -1)

    def japply(st, recv, rvalid):
        return None, jnp.stack([recv[..., 0] * 2, rvalid.astype(jnp.int32)],
                               -1)

    def tapply(st, recv, rvalid):
        return None, torch.stack([recv[..., 0] * 2, rvalid.to(torch.int32)],
                                 -1)

    jcfg = jxp.ExchangeConfig("compacted", budget=budget)
    tcfg = txp.ExchangeConfig("compacted", budget=budget)
    jp = JLayoutPolicy.uniform(LayoutMode.DIST_HASH, n)
    tp = LayoutPolicy.uniform(LayoutMode.DIST_HASH, n)
    _, jout, jserved, jover = jxp.run_exchange(
        "data", jp, jcfg, jnp.asarray(dest), jnp.asarray(valid),
        fields(jnp, jnp.asarray(vals)), japply,
        exchange=jxp.stacked_exchange, shift=jxp.stacked_shift,
        global_sum=jnp.sum, state=None, reply_fill=-1)
    _, tout, tserved, tover = txp.run_exchange(
        "data", tp, tcfg, torch.as_tensor(dest), torch.as_tensor(valid),
        fields(torch, torch.as_tensor(vals)), tapply, state=None,
        reply_fill=-1)
    for a, b in ((jout, tout), (jserved, tserved), (jover, tover)):
        _same(a, b)
    got = tout.numpy()
    assert (got[valid][:, 0] == 2 * vals[valid]).all()


# ---------------------------------------------------------------------------
# route_plan / dest_budgets: the plan's sweep
# ---------------------------------------------------------------------------
def _sweep_routing(n, q, skewed, seed):
    """(n + 2, q) requests to n nodes: row 0 all invalid, a fifth of the
    other slots invalid; ``skewed`` sends three quarters of every row to
    one or two nodes."""
    rng = np.random.RandomState(seed)
    dest = rng.randint(0, n, (n + 2, q)).astype(np.int32)
    if skewed:
        dest[:, : 3 * q // 4] = rng.randint(0, min(n, 2), (n + 2, 1))
    valid = rng.rand(n + 2, q) > 0.2
    valid[0] = False
    return dest, valid


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("q", [0, 1, 8, 33, 100])
@pytest.mark.parametrize("n", [1, 8, 32, 64])
def test_route_plan_sweep_matches_reference(n, q, skewed):
    """Uniform budgets {1, 3, q} and ragged specs measured on the same
    requests (lossless), on other requests and one below every count
    (overflow): the port's plans equal the JAX planner's, the measured
    budgets its ``plan_ragged_spec``'s, and ``route_plan_ref``'s counts and
    ``dest_budgets_ref`` the reference histogram's."""
    dest, valid = _sweep_routing(n, q, skewed, 1000 * n + q)
    jd, jv = jnp.asarray(dest), jnp.asarray(valid)
    td, tv = torch.as_tensor(dest), torch.as_tensor(valid)
    for budget in sorted({1, 3, q}):
        ref = jxp._compact_plan(jd, jv, n, budget)
        got = txp._compact_plan(td, tv, n, budget)
        for a, b in zip(ref, got):
            _same(a, b)
            assert b.dtype == torch.int32
    jspec = jxp.plan_ragged_spec(jd, jv, n)
    spec = txp.plan_ragged_spec(td, tv, n)
    assert jspec.budgets == spec.budgets
    od, ov = _sweep_routing(n, q, not skewed, 1000 * n + q + 1)
    other = txp.plan_ragged_spec(torch.as_tensor(od), torch.as_tensor(ov), n,
                                 align=1)
    exact = txp.plan_ragged_spec(td, tv, n, align=1)
    below = txp.RaggedSpec(tuple(max(0, b - 1) for b in exact.budgets))
    for s in (spec, other, below):
        ref = jxp._compact_plan_ragged(jd, jv, n, jxp.RaggedSpec(s.budgets))
        got = txp._compact_plan_ragged(td, tv, n, s)
        for a, b in zip(ref, got):
            _same(a, b)
        if s is spec:
            assert int(got[2].sum()) == 0         # measured ⇒ lossless
        if s is below and q and valid.any():
            assert int(got[2].sum()) > 0
    counts = np.asarray(j_hist2d(jnp.where(jv, jd, n), n_bins=n + 1))[:, :n]
    table = txp.spec_tables(spec, torch.device("cpu")).table
    _, _, over, got_counts = route_plan_ref(td, tv, table, total=spec.total)
    _same(counts, got_counts)
    _same(np.maximum(counts - np.asarray(spec.budgets), 0).sum(1), over)
    _same(counts.max(0), dest_budgets_ref(td, tv, n))


def test_spec_tables_are_built_once_per_spec_and_device():
    """A spec's device tables are cached: a second plan or exchange with
    the same spec copies nothing to the device."""
    spec = txp.RaggedSpec((3, 0, 1, 2))
    cpu = torch.device("cpu")
    t = txp.spec_tables(spec, cpu)
    assert txp.spec_tables(txp.RaggedSpec((3, 0, 1, 2)), cpu) is t
    assert t.table is t.table and t.table.dtype == torch.int32
    np.testing.assert_array_equal(t.table.numpy(),
                                  [[3, 0, 1, 2], [0, 3, 3, 4]])
    np.testing.assert_array_equal(t.recv_rows.numpy(),
                                  txp._ragged_recv_rows(spec, 4))
    assert t.reply_rows.shape == (4 * spec.total,)
    uni = txp.spec_tables(txp._uniform_spec(3, 2), cpu).table
    np.testing.assert_array_equal(uni.numpy(), [[2, 2, 2], [0, 2, 4]])
    with pytest.raises(ValueError, match="one per node"):
        txp.ragged_exchange(torch.zeros((3, spec.total, 2)), spec, 4)
