"""Serving in the port against the JAX package on the CPU, for the four
dense configs (gemma3-1b, gemma-7b, minitron-8b, qwen1.5-110b) and the MoE
and VLM ones (deepseek-v2-lite-16b, moonshot-v1-16b-a3b, qwen2-vl-2b),
reduced:
the configs and shapes, the cache tree, ``decode_step``, ``make_serve_step``
(16 prompt + 24 greedy tokens, teacher forced) and ``make_prefill_step``,
decode against prefill through the whole model, and the serving entry
points' devices.

Weights: the JAX init carried across, its stacked matrices rescaled to the
per-layer fan-in (``tests/_model_families.py``; ``tests/test_torch_train.py``'s
docstring: at the reference init the saturated softmax puts float32 itself
~1e-4 from float64), qkv biases random.  Tolerances: float32 ``rtol 1e-4, atol 1e-5``;
bf16 activations ``2e-2`` on logits (one bf16 ulp at 2-4), and for the MoE
and VLM configs the gate of ``tests/_model_families.py`` (twice the
reference's own bf16 distance from its float32 logits, on the positions no
routing near-tie reaches: through MLA and the experts the reference's own
bf16 error passes 2e-2).  Greedy tokens are compared where the step's top-2
logit margin is at least twice the largest logit difference, or the
tolerance (a near-tie may flip on rounding); the undecided rows are
counted.

The reference runs eagerly here.  Under ``jax.jit`` XLA's CPU fusions drop
some of its bf16 roundings, which moves its own bf16 decode logits by up to
0.094 from its eager ones (reduced gemma3-1b, 39 steps); the port rounds
where the eager reference rounds and lies within 0.016 of it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _model_families import (assert_bf16_close, flipped_rows,
                             per_layer_fan_in, reached_by_flips,
                             recorded_routing)
from repro.configs import all_configs as j_all_configs
from repro.configs import shapes as j_shapes
from repro.configs.base import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import moe as jmoe
from repro.models.param import count_params as j_count_params
from repro.train.train_step import make_prefill_step as j_make_prefill_step
from repro.train.train_step import make_serve_step as j_make_serve_step
from repro_torch.configs import (ALL_SHAPES, ShapeConfig, all_configs,
                                 applicable_shapes, get_config,
                                 shape_applicable, skip_reason)
from repro_torch.configs import shapes as t_shapes
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (from_jax_cache, from_jax_params,
                                        to_numpy_tree)
from repro_torch.models.param import count_params, iter_leaves
from repro_torch.models.registry import build_model
from repro_torch.train.train_step import make_prefill_step, make_serve_step

ARCHS = ("gemma3-1b", "gemma-7b", "minitron-8b", "qwen1.5-110b",
         "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "qwen2-vl-2b")
FAMILIES = ARCHS[4:]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
PROMPT, GEN = 16, 24


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, dtype: str):
    return tuple(dataclasses.replace(c[arch].reduced(), dtype=dtype)
                 for c in (j_all_configs(), all_configs()))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    """The reduced ``arch``'s JAX init as numpy (module docstring)."""
    j, _ = _cfgs(arch, "float32")
    p = per_layer_fan_in(jax.tree_util.tree_map(
        np.asarray, j_build_model(j).init(jax.random.PRNGKey(0))))
    rng = np.random.RandomState(1)

    def fix(path, a):
        if path[-1].key in ("bq", "bk", "bv"):
            return (0.5 * rng.randn(*a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fix, p)


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _prompt(B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, 256, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------
TREE_SIZES = {"gemma3-1b": 999_812_736, "gemma-7b": 8_537_680_896,
              "minitron-8b": 7_734_562_816, "qwen1.5-110b": 111_209_914_368,
              "deepseek-v2-lite-16b": 15_706_484_224,
              "moonshot-v1-16b-a3b": 28_386_592_768,
              "qwen2-vl-2b": 1_543_714_304}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Fields (full and reduced), the analytic ``param_count`` and the
    parameter tree's size equal the reference's: two numbers that the
    reference does not reconcile (its ``param_count`` counts four norm
    vectors a layer and no biases), copied as they are."""
    j, t = j_all_configs()[arch], all_configs()[arch]
    assert get_config(arch) is t and j_get_config(arch) is j
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.reduced().param_count() == j.reduced().param_count()
    tree = count_params(build_model(t).describe())
    assert tree == j_count_params(j_build_model(j).describe()) == \
        TREE_SIZES[arch]
    assert count_params(build_model(t.reduced()).describe()) == \
        j_count_params(j_build_model(j.reduced()).describe())
    assert sorted(all_configs()) == sorted(j_all_configs())
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("no-such-arch")


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in ALL_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_shapes.ALL_SHAPES.items()}
    assert t_shapes.SUBQUADRATIC_ARCHS == j_shapes.SUBQUADRATIC_ARCHS
    assert [s.is_decode for s in ALL_SHAPES.values()] == \
        [s.is_decode for s in j_shapes.ALL_SHAPES.values()] == \
        [False, False, True, True]
    for arch in ARCHS:
        j, t = j_all_configs()[arch], all_configs()[arch]
        for name, shape in ALL_SHAPES.items():
            js = j_shapes.ALL_SHAPES[name]
            assert shape_applicable(t, shape) == \
                j_shapes.shape_applicable(j, js)
            assert skip_reason(t, shape) == j_shapes.skip_reason(j, js)
        assert [s.name for s in applicable_shapes(t)] == \
            [s.name for s in j_shapes.applicable_shapes(j)]
    assert ShapeConfig("x", 1, 1, "long_decode").is_decode


# ---------------------------------------------------------------------------
# the cache tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_tree_matches_reference(arch):
    j, t = _cfgs(arch, "bfloat16")
    jm, tm = j_build_model(j), build_model(t)
    want = jm.init_cache(3, 20)
    got = tm.init_cache(3, 20, device="cpu")
    meta = tm.abstract_cache(3, 20, dtype="float32")
    assert tm.cache_axes(3, 20) == jm.cache_axes(3, 20)
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    for tree, dtype in ((got, "bfloat16"), (meta, "float32")):
        flat = list(iter_leaves(tree))
        assert [p for p, _ in flat] == \
            [tuple(k.key for k in path) for path, _ in jflat]
        for (_, a), (_, b) in zip(jflat, flat):
            assert tuple(b.shape) == a.shape
            assert str(b.dtype) == f"torch.{dtype}"
    assert all(t.device.type == "meta" for _, t in iter_leaves(meta))
    assert not any(t.any() for _, t in iter_leaves(got))
    assert jax.tree_util.tree_map(lambda s: s.shape,
                                  jm.abstract_cache(3, 20)) == \
        {k: {n: tuple(x.shape) for n, x in v.items()}
         for k, v in meta.items()}


# ---------------------------------------------------------------------------
# decode_step, make_serve_step, make_prefill_step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_serve(arch: str, dtype: str, B: int = 2):
    """The reference's decode over 16 prompt + 24 greedy tokens from a
    zero cache, run eagerly (module docstring): the tokens it was fed, its
    logits at every step, its last cache as numpy, and its routers' calls
    (``tests/_model_families.py``)."""
    j, _ = _cfgs(arch, dtype)
    model = j_build_model(j)
    params = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    step, serve = model.decode_step, j_make_serve_step(model)
    cache = model.init_cache(B, PROMPT + GEN + 4, dtype=dtype)
    prompt = _prompt(B, PROMPT, seed=len(arch))
    fed, logits, tok = [], [], prompt[:, :1]
    with recorded_routing(jmoe, tmoe) as rec:
        for i in range(PROMPT + GEN - 1):
            fed.append(tok)
            clen = jnp.asarray(i + 1, jnp.int32)
            lg, _ = step(params, cache, jnp.asarray(tok), clen)
            nxt, cache = serve(params, cache, jnp.asarray(tok), clen)
            logits.append(np.asarray(lg[:, -1], np.float32))
            assert (np.asarray(nxt) == logits[-1].argmax(-1)).all()
            tok = prompt[:, i + 1:i + 2] if i + 1 < PROMPT else \
                np.asarray(nxt)[:, None]
    return (np.concatenate(fed, 1), np.stack(logits, 1),
            jax.tree_util.tree_map(np.asarray, cache), rec["jax"])


@functools.lru_cache(maxsize=None)
def _jax_teacher_forced_f32(arch: str, B: int = 2):
    """The reference's float32 decode fed the tokens its bf16 serve loop
    was fed: logits at every step and the last cache."""
    fed = _jax_serve(arch, "bfloat16", B)[0]
    j, _ = _cfgs(arch, "float32")
    model = j_build_model(j)
    params = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    cache = model.init_cache(B, PROMPT + GEN + 4, dtype="float32")
    logits = []
    for i in range(fed.shape[1]):
        lg, cache = model.decode_step(params, cache,
                                      jnp.asarray(fed[:, i:i + 1]),
                                      jnp.asarray(i + 1, jnp.int32))
        logits.append(np.asarray(lg[:, -1], np.float32))
    return np.stack(logits, 1), jax.tree_util.tree_map(np.asarray, cache)


def _decided(logits: np.ndarray, tol: float) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] >= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(arch, dtype):
    """Teacher forced: the port's ``decode_step`` fed the reference's
    tokens gives its logits at all 39 steps, ``make_serve_step`` its greedy
    token on every decided row, and the cache ends equal to the
    reference's; the step returns the cache it was given, written in
    place."""
    fed, want, want_cache, jax_calls = _jax_serve(arch, dtype)
    _, t = _cfgs(arch, dtype)
    model = build_model(t)
    params = from_jax_params(_params(arch), "cpu")
    cache = model.init_cache(2, PROMPT + GEN + 4, dtype=dtype, device="cpu")
    serve = make_serve_step(model)
    got, toks = [], []
    with recorded_routing(jmoe, tmoe) as rec:
        for i in range(fed.shape[1]):
            tok = torch.as_tensor(fed[:, i:i + 1])
            copy = {k: {n: x.clone() for n, x in v.items()}
                    for k, v in cache.items()}
            nxt, again = serve(params, copy, tok, i + 1)
            assert nxt.dtype == torch.int32 and again is copy
            toks.append(nxt.numpy())
            lg, same = model.decode_step(params, cache, tok, i + 1)
            assert same is cache and lg.shape == (2, 1, t.padded_vocab)
            got.append(_f(lg[:, -1]))
            assert all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(iter_leaves(cache), iter_leaves(copy)))
    got = np.stack(got, 1)
    toks = np.stack(toks, 1)
    cache = to_numpy_tree(cache)
    if arch in FAMILIES and dtype == "bfloat16":
        # each step routes the batch's 2 tokens twice a MoE layer (the
        # serve step and decode_step, in both packages)
        rec["jax"] = jax_calls
        per_step = max(len(jax_calls) // fed.shape[1], 1)
        ok = ~reached_by_flips(
            flipped_rows(rec),
            lambda call, rows: (rows, np.full(len(rows), call // per_step)),
            2, fed.shape[1]) if jax_calls else np.ones(fed.shape, bool)
        assert ok.mean() > 0.5, ok
        want32, cache32 = _jax_teacher_forced_f32(arch)
        assert_bf16_close(got, want, want32, ok)
        decided = _decided(want, 2 * np.abs(got - want)[ok].max()) & ok
        # cache leaves (layers, B, max_len, ...) by position (B, max_len)
        mask = np.zeros((2, PROMPT + GEN + 4), bool)
        mask[:, :ok.shape[1]] = ok
        for (_, a), (_, b), (_, c) in zip(iter_leaves(cache),
                                          iter_leaves(want_cache),
                                          iter_leaves(cache32)):
            assert_bf16_close(np.moveaxis(a, 0, 2), np.moveaxis(
                np.asarray(b, np.float32), 0, 2), np.moveaxis(c, 0, 2),
                mask)
    else:
        if jax_calls:
            rec["jax"] = jax_calls
            flipped_rows(rec, exact=True)
        tol = TOL[dtype]
        np.testing.assert_allclose(got, want, **tol)
        decided = _decided(want, tol["atol"])
        for (path, a), (_, b) in zip(iter_leaves(cache),
                                     iter_leaves(want_cache)):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol,
                                       err_msg=str(path))
    assert (toks == want.argmax(-1))[decided].all()
    assert decided.mean() > 0.5, decided.mean()     # not a vacuous check


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch, dtype):
    """The last-position logits of a (2, 40) prompt: only that row is
    unembedded, equal to the reference's step and to the port's own full
    forward's last row (for the MoE and VLM configs in bf16, the module
    docstring's gate against the reference's float32 step)."""
    j, t = _cfgs(arch, dtype)
    toks = _prompt(2, 40, seed=3)
    with recorded_routing(jmoe, tmoe) as rec:
        want = j_make_prefill_step(j_build_model(j))(
            jax.tree_util.tree_map(jnp.asarray, _params(arch)),
            {"tokens": jnp.asarray(toks)})
        model = build_model(t)
        params = from_jax_params(_params(arch), "cpu")
        got = make_prefill_step(model)(params,
                                       {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, t.padded_vocab) and not got.requires_grad
    if arch in FAMILIES and dtype == "bfloat16":
        ok = ~reached_by_flips(flipped_rows(rec) if rec["jax"] else [],
                               lambda call, rows: divmod(rows, 40),
                               2, 40)[:, -1]
        j32, _ = _cfgs(arch, "float32")
        want32 = j_make_prefill_step(j_build_model(j32))(
            jax.tree_util.tree_map(jnp.asarray, _params(arch)),
            {"tokens": jnp.asarray(toks)})
        assert ok.any()
        assert_bf16_close(_f(got), _f(want), _f(want32), ok)
    else:
        if rec["jax"]:
            flipped_rows(rec, exact=True)
        np.testing.assert_allclose(_f(got), _f(want), **TOL[dtype])
    full, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(_f(got), _f(full[:, -1]), **TOL[dtype])


def test_decode_step_takes_a_cache_len_tensor():
    """A scalar tensor places writes and positions as the int does; a
    vector (one a row) takes its positions a row, its writes at the first
    entry, as the reference's ``decode_step``."""
    arch = "gemma-7b"
    j, t = _cfgs(arch, "float32")
    jm, model = j_build_model(j), build_model(t)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    params = from_jax_params(_params(arch), "cpu")
    tok = _prompt(2, 1, seed=9)
    for clen in (np.asarray(3, np.int32), np.asarray([3, 5], np.int32)):
        jc = jm.init_cache(2, 8, dtype="float32")
        want, wc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(clen))
        cache = from_jax_cache(jax.tree_util.tree_map(np.asarray, jc), "cpu")
        got, _ = model.decode_step(params, cache, torch.as_tensor(tok),
                                   torch.as_tensor(clen))
        np.testing.assert_allclose(_f(got), _f(want), **TOL["float32"])
        for (_, a), (_, b) in zip(iter_leaves(cache),
                                  iter_leaves(to_numpy_tree(
                                      from_jax_cache(jax.tree_util.tree_map(
                                          np.asarray, wc), "cpu")))):
            np.testing.assert_allclose(_f(a), b, **TOL["float32"])


# ---------------------------------------------------------------------------
# decode against prefill through the whole model
# ---------------------------------------------------------------------------
def _decode_vs_forward(arch: str, S: int = 24):
    """Logits of every position by the full forward and by decode steps
    from a zero cache, teacher forced, in both packages."""
    j, t = _cfgs(arch, "float32")
    toks = _prompt(2, S, seed=11)
    jm, model = j_build_model(j), build_model(t)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    params = from_jax_params(_params(arch), "cpu")
    out = {("jax", "prefill"): jm.forward(
               jp, {"tokens": jnp.asarray(toks)})[0],
           ("torch", "prefill"): model.forward(
               params, {"tokens": torch.as_tensor(toks)})[0]}
    step = jm.decode_step
    jc = jm.init_cache(2, S, dtype="float32")
    tc = model.init_cache(2, S, dtype="float32", device="cpu")
    jl, tl = [], []
    for i in range(S):
        lg, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                      jnp.asarray(i + 1, jnp.int32))
        jl.append(lg)
        tl.append(model.decode_step(params, tc,
                                    torch.as_tensor(toks[:, i:i + 1]),
                                    i + 1)[0])
    out["jax", "decode"] = jnp.concatenate(jl, 1)
    out["torch", "decode"] = torch.cat(tl, 1)
    return {k: _f(v) for k, v in out.items()}


def test_model_decode_equals_prefill_without_windows():
    out = _decode_vs_forward("gemma-7b")
    for key, got in out.items():
        np.testing.assert_allclose(got, out["jax", "prefill"],
                                   **TOL["float32"], err_msg=str(key))


def test_model_window_mismatch_pinned():
    """Reduced gemma3-1b (local layers at window 8): decode equals prefill
    below position 8 and differs from 8 on; each side equals the
    reference's."""
    W = all_configs()["gemma3-1b"].reduced().window_size
    out = _decode_vs_forward("gemma3-1b")
    for side in ("prefill", "decode"):
        np.testing.assert_allclose(out["torch", side], out["jax", side],
                                   **TOL["float32"], err_msg=side)
    dec, pre = out["torch", "decode"], out["torch", "prefill"]
    np.testing.assert_allclose(dec[:, :W], pre[:, :W], **TOL["float32"])
    gap = np.abs(dec - pre).max(axis=(0, 2))
    assert (gap[W:] > 1e-2).all(), gap
