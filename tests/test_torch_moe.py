"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the JAX package's on the CPU, on the two reduced MoE configs
(deepseek-v2-lite-16b: 4 experts top-2 + 1 shared; moonshot-v1-16b-a3b the
same widths): the router, the three dispatches (``dense``, ``grouped``,
``dropping``) with and without dropped copies, their gradients, and the
capacity rule.

Inputs are unit-normal (B 2, S 24, d 64) from a numpy seed.  Weights: the
JAX init of ``describe_moe`` (its router at std 0.02), the expert matrices
rescaled from the reference's fan-in (``shape[0]``, the expert count, see
ROADMAP 3b) to each expert's own input width, except where a test says it
runs at the reference init.  Tolerances: float32 ``rtol 1e-5, atol 1e-6``
(gradients ``rtol 1e-4``), after the router's ids are asserted equal; bf16
``rtol 2e-2, atol 2e-2`` on the tokens whose top-k set agrees (every
disagreement a near-tie: ``tests/_model_families.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _model_families import flipped_rows, recorded_routing
from repro.configs import all_configs as j_all_configs
from repro.models import moe as jmoe
from repro.models.param import materialize as j_materialize
from repro_torch.configs import all_configs
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import from_jax_params
from repro_torch.models.param import iter_leaves

ARCHS = ("deepseek-v2-lite-16b", "moonshot-v1-16b-a3b")
IMPLS = ("dense", "grouped", "dropping")
B, S = 2, 24
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, dtype: str = "float32"):
    return tuple(dataclasses.replace(c[arch].reduced(), dtype=dtype)
                 for c in (j_all_configs(), all_configs()))


@functools.lru_cache(maxsize=None)
def _params(arch: str, per_expert_fan_in: bool = True):
    """The JAX init of the reduced ``arch``'s MoE leaf, as numpy."""
    j, _ = _cfgs(arch)
    p = jax.tree_util.tree_map(np.asarray, j_materialize(
        jax.random.PRNGKey(3), jmoe.describe_moe(j)))
    if per_expert_fan_in:
        for name in ("wi_gate", "wi_up", "wo"):
            a = p[name]
            p[name] = (a * np.sqrt(a.shape[0] / a.shape[1])).astype(a.dtype)
    return p


def _x(cfg, dtype: str, seed: int = 0):
    x = np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _f(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _np_keep(ids: np.ndarray, C: int) -> np.ndarray:
    """The capacity rule, written plainly: a copy (in token-major order) is
    kept while fewer than C earlier copies went to its expert."""
    seen, keep = {}, []
    for e in ids.reshape(-1):
        keep.append(seen.get(e, 0) < C)
        seen[e] = seen.get(e, 0) + 1
    return np.array(keep)


# ---------------------------------------------------------------------------
# the router and the capacity rule
# ---------------------------------------------------------------------------
def test_capacity_rule():
    """``max(8, roundup8(int(cf · N · k / E)))``: full deepseek's decode at B
    4 gets 8 slots, its 192-token prefill 24 (a mean of 18 copies)."""
    assert tmoe.capacity(4, 6, 64) == 8
    assert tmoe.capacity(192, 6, 64) == 24
    assert tmoe.capacity(48, 2, 4) == 32
    assert tmoe.capacity(48, 2, 4, 0.5) == 16
    assert tmoe.capacity(4096, 6, 64) == 480
    assert tmoe.DEFAULT_CAPACITY_FACTOR == jmoe.DEFAULT_CAPACITY_FACTOR


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_reference(arch):
    """float32: ids equal (order included), weights and aux within 1e-6."""
    j, t = _cfgs(arch)
    xj, xt = _x(j, "float32")
    ids_j, w_j, aux_j = jmoe._router(
        jax.tree_util.tree_map(jnp.asarray, _params(arch)),
        xj.reshape(-1, j.d_model), j)
    ids_t, w_t, aux_t = tmoe._router(from_jax_params(_params(arch), "cpu"),
                                     xt.reshape(-1, t.d_model), t)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(_f(w_t), _f(w_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=0,
                               atol=1e-6)
    assert w_t.dtype == torch.float32 and aux_t.dtype == torch.float32


def test_router_breaks_ties_by_lower_index():
    """Equal probabilities (duplicated router columns) pick the lower
    expert first, as ``jax.lax.top_k`` does."""
    j, t = _cfgs("deepseek-v2-lite-16b")
    p = dict(_params("deepseek-v2-lite-16b"))
    r = p["router"].copy()
    r[:, 2] = r[:, 3] = r[:, 0] = r[:, 1]          # four equal columns
    p["router"] = r
    xj, xt = _x(j, "float32")
    ids_j, _, _ = jmoe._router(jax.tree_util.tree_map(jnp.asarray, p),
                               xj.reshape(-1, j.d_model), j)
    ids_t, _, _ = tmoe._router(from_jax_params(p, "cpu"),
                               xt.reshape(-1, t.d_model), t)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert (ids_t.numpy() == [0, 1]).all()


# ---------------------------------------------------------------------------
# the three dispatches
# ---------------------------------------------------------------------------
def _run_both(arch, dtype, impl, params=None, capacity_factor=None, seed=0):
    j, t = _cfgs(arch, dtype)
    params = params if params is not None else _params(arch)
    xj, xt = _x(j, dtype, seed)
    kw = {} if capacity_factor is None else \
        {"capacity_factor": capacity_factor}
    with recorded_routing(jmoe, tmoe) as rec:
        yj, aj = jmoe.apply_moe(jax.tree_util.tree_map(jnp.asarray, params),
                                xj, j, impl=impl, **kw)
        yt, at = tmoe.apply_moe(from_jax_params(params, "cpu"), xt, t,
                                impl=impl, **kw)
    return (yj, aj), (yt, at), rec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, impl, dtype):
    (yj, aj), (yt, at), rec = _run_both(arch, dtype, impl)
    assert yt.shape == (B, S, yt.shape[-1]) and yt.dtype == getattr(
        torch, dtype)
    if dtype == "float32":
        flipped_rows(rec, exact=True)
        np.testing.assert_allclose(_f(yt), _f(yj), **F32)
        np.testing.assert_allclose(float(at), float(aj), rtol=0, atol=1e-6)
        return
    (rows,) = flipped_rows(rec)
    ok = np.ones(B * S, bool)
    ok[rows] = False
    assert ok.mean() > 0.9, rows
    np.testing.assert_allclose(_f(yt).reshape(B * S, -1)[ok],
                               _f(yj).reshape(B * S, -1)[ok], **BF16)
    np.testing.assert_allclose(float(at), float(aj), rtol=0, atol=1e-3)


@pytest.mark.parametrize("impl", IMPLS)
def test_apply_moe_at_reference_init(impl):
    """The reference's own init (expert fan-in from the expert count:
    outputs of ~1e2) in float32."""
    (yj, aj), (yt, at), rec = _run_both(
        "deepseek-v2-lite-16b", "float32", impl,
        params=_params("deepseek-v2-lite-16b", per_expert_fan_in=False))
    flipped_rows(rec, exact=True)
    assert np.abs(_f(yj)).max() > 20
    np.testing.assert_allclose(_f(yt), _f(yj), rtol=1e-5,
                               atol=1e-6 * np.abs(_f(yj)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["grouped", "dropping"])
def test_dispatch_that_drops_copies_matches_reference(impl, dtype):
    """At capacity factor 0.5 the reference's dispatch drops copies (the
    count from its ids by the plain capacity rule, above 0); the port's
    dispatch drops the same copies and gives the same outputs."""
    arch = "deepseek-v2-lite-16b"
    (yj, _), (yt, _), rec = _run_both(arch, dtype, impl, capacity_factor=0.5)
    j, _ = _cfgs(arch)
    k, E = j.num_experts_per_tok, j.num_experts
    ids_j = rec["jax"][0][0]
    groups = ids_j.reshape(B, S * k) if impl == "grouped" else \
        ids_j.reshape(1, B * S * k)
    C = tmoe.capacity(groups.shape[1] // k, k, E, 0.5)
    want = np.concatenate([_np_keep(g, C) for g in groups])
    assert (~want).sum() > 0
    if dtype == "float32":
        flipped_rows(rec, exact=True)
        got = tmoe.dispatch_slots(torch.as_tensor(groups.copy()), E, C)[1]
        np.testing.assert_array_equal(got.numpy().reshape(-1), want)
        assert int(tmoe.dropped_copies(torch.as_tensor(groups.copy()), E, C)) == \
            (~want).sum()
        np.testing.assert_allclose(_f(yt), _f(yj), **F32)
        return
    (rows,) = flipped_rows(rec)
    # a flipped token moves the ranks of the later copies of its group (the
    # batch row under ``grouped``, all tokens under ``dropping``): compare
    # the tokens before a group's first flip
    T = S if impl == "grouped" else B * S
    ok = np.ones(B * S, bool)
    for row in rows:
        ok[row:row // T * T + T] = False
    np.testing.assert_allclose(_f(yt).reshape(B * S, -1)[ok],
                               _f(yj).reshape(B * S, -1)[ok], **BF16)


def test_dropping_equals_dense_on_tokens_that_kept_all_copies():
    """The port's own ``dropping`` against its ``dense`` oracle: equal on
    every token whose copies were all kept, different on those that lost
    one (the lost expert's term is missing)."""
    arch = "deepseek-v2-lite-16b"
    _, t = _cfgs(arch)
    p = from_jax_params(_params(arch), "cpu")
    _, xt = _x(t, "float32")
    dense, _ = tmoe.apply_moe(p, xt, t, impl="dense")
    drop, _ = tmoe.apply_moe(p, xt, t, impl="dropping", capacity_factor=0.5)
    ids, _, _ = tmoe._router(p, xt.reshape(B * S, -1), t)
    k, E = t.num_experts_per_tok, t.num_experts
    keep = tmoe.dispatch_slots(ids.reshape(1, -1), E,
                               tmoe.capacity(B * S, k, E, 0.5))[1]
    whole = keep.reshape(B * S, k).all(dim=1).numpy()
    assert 0 < whole.sum() < B * S
    d, r = _f(dense).reshape(B * S, -1), _f(drop).reshape(B * S, -1)
    np.testing.assert_allclose(r[whole], d[whole], **F32)
    assert (np.abs(r - d).max(axis=1)[~whole] > 1e-3).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_apply_moe_gradients_match_jax(impl):
    """d(Σ y·r + 3·aux) with respect to every parameter and the input,
    float32, at capacity factor 0.5 (dropped copies included), against
    ``jax.grad``: rtol 1e-4 (atol 1e-6 of the leaf's largest entry)."""
    arch = "moonshot-v1-16b-a3b"
    j, t = _cfgs(arch)
    xj, xt = _x(j, "float32", seed=4)
    r = np.random.RandomState(5).randn(B, S, j.d_model).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(arch))

    def jloss(p, x):
        y, aux = jmoe.apply_moe(p, x, j, impl=impl, capacity_factor=0.5)
        return jnp.sum(y * r) + 3 * aux

    gj = jax.grad(jloss, argnums=(0, 1))(jp, xj)
    tp = {k: v.requires_grad_(True) for k, v in
          from_jax_params(_params(arch), "cpu").items()}
    xt = xt.requires_grad_(True)
    y, aux = tmoe.apply_moe(tp, xt, t, impl=impl, capacity_factor=0.5)
    ((y * torch.as_tensor(r)).sum() + 3 * aux).backward()
    pairs = [(np.asarray(gj[0][path[-1]]), leaf.grad.numpy())
             for path, leaf in iter_leaves(tp)] + \
        [(np.asarray(gj[1]), xt.grad.numpy())]
    for want, got in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


def test_unknown_dispatch_raises():
    _, t = _cfgs("deepseek-v2-lite-16b")
    _, xt = _x(t, "float32")
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        tmoe.apply_moe(from_jax_params(_params("deepseek-v2-lite-16b"),
                                       "cpu"), xt, t, impl="sparse")
