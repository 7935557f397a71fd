"""The MoE and VLM families of the port's ``TransformerLM`` against the JAX
package on the CPU: M-RoPE, MLA (prefill, decode, the clamped cache write)
and the three reduced configs, deepseek-v2-lite-16b (MLA, MoE with a dense
first layer), moonshot-v1-16b-a3b (GQA, MoE) and qwen2-vl-2b (M-RoPE, qkv
biases, tied embeddings, patch embeddings): the parameter tree, ``forward``
(logits and aux loss), ``loss_fn`` and its gradients, three AdamW steps,
decode steps over the cache, the VLM batch, the weights carried across, the
``dropping`` dispatch's prefill-against-decode difference, and a MoE train
state through the checkpoint manager.

Weights: the JAX init, every stacked matrix rescaled to its per-layer
fan-in (``tests/_model_families.py``; at the reference init the saturated
softmax puts float32 itself ~1e-4 from float64, ``tests/test_torch_train.py``),
qkv biases random.  Inputs from numpy seeds.  Tolerances: float32 ``rtol
1e-4, atol 1e-5`` on logits after the routers' ids are asserted equal call
for call; bf16 logits on the positions that no routing near-tie reaches,
within twice the reference's own bf16 distance from its float32 logits of
both (``tests/_model_families.py``: a fixed 2e-2 is below the reference's
own bf16 error through these layers).  The reference runs
eagerly where bf16 is compared (``tests/test_torch_serve.py``'s docstring),
under ``jax.jit`` for float32 gradients and steps.
"""
import dataclasses
import functools
import json
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _model_families import (assert_bf16_close, flipped_rows,
                             per_layer_fan_in, reached_by_flips,
                             recorded_routing)
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import all_configs as j_all_configs
from repro.core.layouts import LayoutMode as JMode
from repro.core.policy import LayoutPolicy as JPolicy
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.models import moe as jmoe
from repro.models.param import count_params as j_count_params
from repro.models.param import materialize as j_materialize
from repro.models.transformer import segments as j_segments
from repro.train.optimizer import AdamW as JAdamW
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager, flatten_state
from repro_torch.configs import all_configs
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (from_jax_cache, from_jax_opt_state,
                                        from_jax_params, to_numpy_tree)
from repro_torch.models.param import count_params, iter_leaves
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import segments
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import _value_and_grad, make_train_step

ARCHS = ("deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "qwen2-vl-2b")
MOE_ARCHS = ARCHS[:2]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
B, S, NPATCH = 2, 24, 6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, dtype: str = "float32", **kw):
    return tuple(dataclasses.replace(c[arch].reduced(), dtype=dtype, **kw)
                 for c in (j_all_configs(), all_configs()))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    """The reduced ``arch``'s JAX init as numpy (module docstring)."""
    j, _ = _cfgs(arch)
    p = per_layer_fan_in(jax.tree_util.tree_map(
        np.asarray, j_build_model(j).init(jax.random.PRNGKey(0))))
    rng = np.random.RandomState(1)

    def biases(path, a):
        if path[-1].key in ("bq", "bk", "bv"):
            return (0.5 * rng.randn(*a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(biases, p)


def _np_batch(arch: str, B: int = B, S: int = S, seed: int = 0) -> dict:
    """Tokens and targets; for the VLM, NPATCH patch embeddings (a 2 x 3
    image grid) and their M-RoPE positions: the image's temporal, height
    and width streams, then text positions advancing on all three."""
    cfg = all_configs()[arch]
    r = np.random.RandomState(seed)
    toks = r.randint(0, 256, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = (0.02 * r.randn(B, NPATCH, 64)).astype(
            np.float32)
        img = np.arange(NPATCH)
        text = 3 + np.arange(S - NPATCH)
        pos = np.stack([np.r_[0 * img, text], np.r_[img // 3, text],
                        np.r_[img % 3, text]]).astype(np.int32)
        batch["mrope_positions"] = np.broadcast_to(pos[:, None],
                                                   (3, B, S)).copy()
    return batch


def _both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_norm(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


# ---------------------------------------------------------------------------
# M-RoPE and MLA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,sections", [(16, (4, 2, 2)), (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(D, sections, dtype):
    """Three different position streams: within 1e-6 in float32 (bf16:
    within one rounding); three equal streams give plain RoPE bit for
    bit."""
    r = np.random.RandomState(D)
    x = r.randn(2, 24, 4, D).astype(np.float32)
    pos = r.randint(0, 300, (3, 2, 24)).astype(np.int32)
    want = j_layers.apply_mrope(jnp.asarray(x).astype(dtype),
                                jnp.asarray(pos), 1e6, sections)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    got = t_layers.apply_mrope(xt, torch.as_tensor(pos), 1e6, sections)
    assert got.dtype == xt.dtype
    tol = dict(rtol=0, atol=1e-6) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_f(got), _f(want), **tol)
    same = torch.as_tensor(pos[:1]).expand(3, 2, 24)
    assert torch.equal(t_layers.apply_mrope(xt, same, 1e6, sections),
                       t_layers.apply_rope(xt, same[0], 1e6))


def _mla(dtype: str, seed: int = 2):
    j, t = _cfgs("deepseek-v2-lite-16b", dtype)
    p = jax.tree_util.tree_map(np.asarray, j_materialize(
        jax.random.PRNGKey(seed), j_attn.describe_attention(j)))
    return j, t, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mla_prefill_matches_reference(dtype):
    j, t, p = _mla(dtype)
    x = (0.3 * np.random.RandomState(3).randn(B, S, j.d_model)).astype(
        np.float32)
    pos = np.arange(S)[None]
    want, cache = j_attn.apply_mla(jax.tree_util.tree_map(jnp.asarray, p),
                                   jnp.asarray(x).astype(dtype),
                                   jnp.asarray(pos), j)
    got = t_attn.apply_mla(from_jax_params(p, "cpu"),
                           torch.as_tensor(x).to(getattr(torch, dtype)),
                           torch.as_tensor(pos), t)
    assert cache is None and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f(got), _f(want), **TOL[dtype])


def _mla_decode(dtype: str, steps, max_len: int, seed: int = 4):
    """Both packages' MLA decode fed the same tokens at ``steps`` (cache
    lengths) from zero caches: outputs a step and the last caches."""
    j, t, p = _mla(dtype)
    x = (0.3 * np.random.RandomState(seed).randn(B, len(steps), j.d_model)
         ).astype(np.float32)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), from_jax_params(p, "cpu")
    jc = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        j_attn.abstract_mla_cache(j, B, max_len, dtype))
    tc = t_attn.init_mla_cache(t, B, max_len, dtype, device="cpu")
    outs = {"jax": [], "torch": []}
    for i, n in enumerate(steps):
        xi = x[:, i:i + 1]
        pos = np.full((B, 1), n - 1, np.int32)
        o, jc = j_attn.apply_mla(jp, jnp.asarray(xi).astype(dtype),
                                 jnp.asarray(pos), j, cache=jc,
                                 cache_len=jnp.asarray(n, jnp.int32))
        outs["jax"].append(_f(o))
        outs["torch"].append(_f(t_attn.apply_mla(
            tp, torch.as_tensor(xi).to(getattr(torch, dtype)),
            torch.as_tensor(pos), t, cache=tc, cache_len=n)))
    return outs, jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mla_decode_matches_reference(dtype):
    """The absorbed decode over 12 steps: each step's output and the
    latent cache written in place equal the reference's returned ones."""
    outs, jc, tc = _mla_decode(dtype, range(1, 13), 12)
    np.testing.assert_allclose(np.stack(outs["torch"]),
                               np.stack(outs["jax"]), **TOL[dtype])
    assert set(tc) == {"c_kv", "k_pe"}
    for name in tc:
        assert tc[name].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_f(tc[name]), _f(jc[name]), **TOL[dtype])


def test_mla_cache_write_clamps_past_max_len():
    """Cache lengths past ``max_len`` (7 and 9 into a cache of 5): the
    write lands on the last slot, as ``dynamic_update_slice`` clamps it,
    and the step attends to the whole cache (ROADMAP 3b)."""
    outs, jc, tc = _mla_decode("float32", [1, 2, 3, 4, 5, 7, 9], 5)
    np.testing.assert_allclose(np.stack(outs["torch"]),
                               np.stack(outs["jax"]), **TOL["float32"])
    for name in tc:
        np.testing.assert_allclose(_f(tc[name]), _f(jc[name]),
                                   **TOL["float32"])


def test_mla_decode_matches_prefill():
    """The port's twin of ``tests/test_attention_math.py``'s: 12 decode
    steps of the absorbed form against the materialised prefill form."""
    j, t, p = _mla("float32")
    x = (0.3 * np.random.RandomState(0).randn(B, 12, t.d_model)).astype(
        np.float32)
    tp = from_jax_params(p, "cpu")
    full = t_attn.apply_mla(tp, torch.as_tensor(x),
                            torch.arange(12)[None], t)
    cache = t_attn.init_mla_cache(t, B, 12, "float32", device="cpu")
    dec = torch.cat([t_attn.apply_mla(
        tp, torch.as_tensor(x[:, i:i + 1]), torch.full((B, 1), i), t,
        cache=cache, cache_len=i + 1) for i in range(12)], dim=1)
    np.testing.assert_allclose(_f(dec), _f(full), atol=3e-3, rtol=1e-2)


def test_mla_cache_shapes_match_reference():
    j, t = _cfgs("deepseek-v2-lite-16b")
    want = j_attn.abstract_mla_cache(j, 3, 20, "float32")
    meta = t_attn.abstract_mla_cache(t, 3, 20, "float32")
    real = t_attn.init_mla_cache(t, 3, 20, device="cpu")
    assert {k: tuple(v.shape) for k, v in meta.items()} == \
        {k: v.shape for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in real.items()}
    assert all(v.device.type == "meta" for v in meta.values())
    assert all(v.dtype == torch.bfloat16 and not v.any()
               for v in real.values())


# ---------------------------------------------------------------------------
# the configs through the model
# ---------------------------------------------------------------------------
FULL_TREE_SIZES = {"deepseek-v2-lite-16b": 15_706_484_224,
                   "moonshot-v1-16b-a3b": 28_386_592_768,
                   "qwen2-vl-2b": 1_543_714_304}


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_and_param_tree_match_reference(arch):
    """``build_model`` builds the full config; the parameter tree (paths,
    shapes, dtypes under float32 and bf16 params) equals the reference's,
    reduced and full (descriptors only), segments included."""
    full = all_configs()[arch]
    assert count_params(build_model(full).describe()) == j_count_params(
        j_build_model(j_all_configs()[arch]).describe()) == \
        FULL_TREE_SIZES[arch]
    for pdt in ("float32", "bfloat16"):
        j, t = _cfgs(arch, param_dtype=pdt)
        jm, tm = j_build_model(j), build_model(t)
        assert segments(t) == [tuple(s) for s in j_segments(j)]
        want = jax.tree_util.tree_flatten_with_path(jm.abstract_params())[0]
        got = list(iter_leaves(tm.init(0, "cpu")))
        assert [p for p, _ in got] == \
            [tuple(k.key for k in path) for path, _ in want]
        for (_, a), (_, b) in zip(want, got):
            assert tuple(b.shape) == a.shape
            assert str(b.dtype) == f"torch.{a.dtype}"
    assert build_model(full, moe_impl="dense").moe_impl == "dense"
    assert build_model(full).moe_impl == "dropping"
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        build_model(full, moe_impl="sparse")


def _forward(arch: str, dtype: str, batch: dict):
    j, t = _cfgs(arch, dtype)
    jb, tb = _both(batch)
    with recorded_routing(jmoe, tmoe) as rec:
        jl, ja = j_build_model(j).forward(
            jax.tree_util.tree_map(jnp.asarray, _params(arch)), jb)
        tl, ta = build_model(t).forward(from_jax_params(_params(arch), "cpu"),
                                        tb)
    return (jl, ja), (tl, ta), rec


def _unreached(rec, dtype: str, Bn: int, Sn: int) -> np.ndarray:
    """(B, S): the positions to compare (module docstring); every router
    call of a forward routes B x S tokens, row-major."""
    if not rec["jax"]:
        return np.ones((Bn, Sn), bool)
    if dtype == "float32":
        flipped_rows(rec, exact=True)
        return np.ones((Bn, Sn), bool)
    reached = reached_by_flips(flipped_rows(rec),
                               lambda call, rows: divmod(rows, Sn), Bn, Sn)
    assert (~reached).mean() > 0.5, reached
    return ~reached


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    """Logits (B, S, V) and the summed aux loss; the VLM with its patch
    embeddings and three position streams."""
    (jl, ja), (tl, ta), rec = _forward(arch, dtype, _np_batch(arch))
    _, t = _cfgs(arch, dtype)
    assert tl.shape == (B, S, t.padded_vocab)
    assert len(rec["torch"]) == sum(n for k, n in segments(t)
                                    if t.is_moe and k != "dense")
    ok = _unreached(rec, dtype, B, S)
    if dtype == "float32":
        np.testing.assert_allclose(_f(tl), _f(jl), **TOL[dtype])
    else:
        jl32 = _forward(arch, "float32", _np_batch(arch))[0][0]
        assert_bf16_close(_f(tl), _f(jl), _f(jl32), ok)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5,
                               atol=1e-6 if dtype == "float32" else 1e-3)
    assert (float(ta) > 0) == t.is_moe


def test_vlm_patch_embeds_and_positions_change_the_logits():
    """The VLM batch's two inputs reach the model: patch embeddings replace
    the first tokens' embeddings, M-RoPE positions replace RoPE."""
    arch = "qwen2-vl-2b"
    _, t = _cfgs(arch)
    model, params = build_model(t), from_jax_params(_params(arch), "cpu")
    batch = _both(_np_batch(arch))[1]
    out = {name: model.forward(params, {k: v for k, v in batch.items()
                                        if k not in drop})[0]
           for name, drop in (("both", ()), ("no_patches", ("patch_embeds",)),
                              ("no_mrope", ("mrope_positions",)))}
    for name in ("no_patches", "no_mrope"):
        assert (out[name] - out["both"]).abs().max() > 1e-3, name


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """float32: loss, its parts (the aux loss among them) and every
    parameter's gradient (norm of the difference within 1e-4 of the
    gradient's norm), against ``jax.value_and_grad`` of the reference's
    ``loss_fn``."""
    j, t = _cfgs(arch)
    jb, tb = _both(_np_batch(arch))
    jm = j_build_model(j)
    (_, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, _params(arch)), jb)
    tg, tmet = _value_and_grad(build_model(t),
                               from_jax_params(_params(arch), "cpu"), tb)
    for key in ("loss", "ce", "z_loss", "aux_loss"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-4, atol=1e-7)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = list(iter_leaves(tg))
    assert [p for p, _ in got] == \
        [tuple(k.key for k in path) for path, _ in want]
    for (path, a), (_, b) in zip(want, got):
        assert _rel_norm(np.asarray(a, np.float64),
                         _f(b).astype(np.float64)) < 1e-4, path


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_reference(arch):
    """Three steps of each package's train step from the same weights and
    batch (the VLM's with its patch embeddings and positions): loss, aux
    loss and grad norm within 1e-4, parameters within 1e-4 and moments
    within 1e-3 (norm of the difference over the norm, per leaf; see
    ``tests/test_torch_train.py``)."""
    j, t = _cfgs(arch)
    jb, tb = _both(_np_batch(arch))
    jopt = JAdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    topt = AdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    js = jax.jit(j_make_train_step(j_build_model(j), jopt))
    ts = make_train_step(build_model(t), topt)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    jst = jopt.init(jp)
    tp = from_jax_params(_params(arch), "cpu")
    tst = from_jax_opt_state(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    for _ in range(3):
        jp, jst, jm = js(jp, jst, jb)
        tp, tst, tm = ts(tp, tst, tb)
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-7)
        for tree_j, tree_t, lim in ((jp, tp, 1e-4), (jst.mu, tst.mu, 1e-3),
                                    (jst.nu, tst.nu, 1e-3)):
            for a, (_, b) in zip(jax.tree_util.tree_leaves(tree_j),
                                 iter_leaves(tree_t)):
                assert _rel_norm(np.asarray(a, np.float64),
                                 _f(b).astype(np.float64)) < lim
    assert int(tst.step) == int(jst.step) == 3


DECODE_STEPS = 16


@functools.lru_cache(maxsize=None)
def _decode(arch: str, dtype: str):
    """DECODE_STEPS tokens through each package's ``decode_step`` from a
    zero cache: the logits of every step (B, steps, V) of both, the
    positions to compare (module docstring), both last caches as numpy."""
    j, t = _cfgs(arch, dtype)
    toks = _np_batch(arch)["tokens"][:, :DECODE_STEPS]
    jm, tm = j_build_model(j), build_model(t)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    tp = from_jax_params(_params(arch), "cpu")
    jc = jm.init_cache(B, DECODE_STEPS + 2, dtype=dtype)
    tc = tm.init_cache(B, DECODE_STEPS + 2, dtype=dtype, device="cpu")
    assert {k: set(v) for k, v in tc.items()} == \
        {k: set(v) for k, v in jc.items()}
    jl, tl = [], []
    with recorded_routing(jmoe, tmoe) as rec:
        for i in range(DECODE_STEPS):
            lg, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(i + 1, jnp.int32))
            jl.append(_f(lg[:, 0]))
            lg, same = tm.decode_step(tp, tc, torch.as_tensor(
                toks[:, i:i + 1]), i + 1)
            assert same is tc
            tl.append(_f(lg[:, 0]))
    ok = np.ones((B, DECODE_STEPS), bool)
    if rec["jax"]:
        # each step routes the batch's B tokens once a MoE layer
        per_step = len(rec["jax"]) // DECODE_STEPS
        ok = ~reached_by_flips(
            flipped_rows(rec, exact=dtype == "float32"),
            lambda call, rows: (rows, np.full(len(rows), call // per_step)),
            B, DECODE_STEPS)
    return (np.stack(jl, 1), np.stack(tl, 1), ok,
            jax.tree_util.tree_map(np.asarray, jc), to_numpy_tree(tc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, dtype):
    """DECODE_STEPS tokens through each package's ``decode_step`` from a
    zero cache (the MLA latent cache for deepseek; qwen2-vl's three
    position streams broadcast from the step's position): the logits of
    every step; in float32 the cache written in place equals the
    reference's returned one."""
    jl, tl, ok, jc, tc = _decode(arch, dtype)
    if dtype == "float32":
        assert ok.all()
        np.testing.assert_allclose(tl, jl, **TOL[dtype])
        want = jax.tree_util.tree_flatten_with_path(jc)[0]
        got = list(iter_leaves(tc))
        assert [p for p, _ in got] == \
            [tuple(k.key for k in path) for path, _ in want]
        for (path, a), (_, b) in zip(want, got):
            np.testing.assert_allclose(b, a, **TOL[dtype], err_msg=str(path))
        return
    assert ok.mean() > 0.5, ok
    assert_bf16_close(tl, jl, _decode(arch, "float32")[0], ok)


def test_vlm_pipeline_batch_matches_reference_through_the_train_step():
    """The port's ``TokenPipeline`` gives the reduced qwen2-vl the
    reference's batch bit for bit (tokens, targets, 8 patch embeddings,
    ``mrope_positions`` (3, B, S)); the train step passes the VLM inputs
    into ``loss_fn``: its loss is the reference's on that batch, and the
    patch embeddings reach it."""
    arch = "qwen2-vl-2b"
    j, t = _cfgs(arch)
    jb = JPipeline(j, 2, 32, seed=5).next_batch()
    tb = TokenPipeline(t, 2, 32, seed=5).next_batch()
    assert sorted(tb) == sorted(jb) == ["mrope_positions", "patch_embeds",
                                        "targets", "tokens"]
    for k in jb:
        assert tb[k].dtype == jb[k].dtype and tb[k].shape == jb[k].shape
        assert np.array_equal(tb[k], jb[k]), k
    assert tb["patch_embeds"].shape == (2, 8, t.d_model)
    _, jmet = j_build_model(j).loss_fn(
        jax.tree_util.tree_map(jnp.asarray, _params(arch)),
        {k: jnp.asarray(v) for k, v in jb.items()})
    step = make_train_step(build_model(t), AdamW(warmup_steps=1,
                                                 total_steps=2))
    params = from_jax_params(_params(arch), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in tb.items()}
    opt = AdamW(warmup_steps=1, total_steps=2)
    _, _, met = step(params, opt.init(params), batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert float(met["aux_loss"]) == 0.0
    batch["patch_embeds"] = batch["patch_embeds"] * 50
    _, _, met2 = step(params, opt.init(params), batch)
    assert abs(float(met2["loss"]) - float(met["loss"])) > 1e-4


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carry_across_bit_for_bit(arch, param_dtype):
    """``from_jax_params`` carries every leaf (router, experts, shared
    experts, MLA's and ``kv_norm``, biases) bit for bit, float32 and bf16
    params; ``from_jax_opt_state`` the AdamW state; ``from_jax_cache`` a
    decode step's cache (MLA's latent one for deepseek)."""
    j, _ = _cfgs(arch, param_dtype=param_dtype)
    jm = j_build_model(j)
    jp = jm.init(jax.random.PRNGKey(7))
    np_p = jax.tree_util.tree_map(np.asarray, jp)

    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else \
            a.view(np.uint8)

    got = list(iter_leaves(from_jax_params(np_p, "cpu")))
    want = jax.tree_util.tree_flatten_with_path(np_p)[0]
    assert len(got) == len(want)
    for (path, a), (_, b) in zip(want, got):
        assert str(b.dtype) == f"torch.{a.dtype}"
        back = b.view(torch.int16).numpy().view(np.uint16) \
            if b.dtype == torch.bfloat16 else b.numpy().view(np.uint8)
        assert np.array_equal(back, bits(a)), path
    st = jax.tree_util.tree_map(np.asarray, JAdamW().init(jp))
    ts = from_jax_opt_state(st, "cpu")
    assert int(ts.step) == 0
    assert all(np.array_equal(_f(b), np.asarray(a, np.float32)) for a, (_, b)
               in zip(jax.tree_util.tree_leaves(st.mu), iter_leaves(ts.mu)))
    cache = jm.init_cache(B, 4, dtype=j.dtype)
    _, cache = jm.decode_step(jp, cache, jnp.ones((B, 1), jnp.int32),
                              jnp.asarray(1, jnp.int32))
    np_c = jax.tree_util.tree_map(np.asarray, cache)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(np_c)[0],
                                 iter_leaves(from_jax_cache(np_c, "cpu"))):
        assert np.array_equal(_f(b), np.asarray(a, np.float32)), path
    assert any(np.abs(np.asarray(a, np.float32)).max() > 0
               for a in jax.tree_util.tree_leaves(np_c))


def test_dropping_prefill_differs_from_decode_pinned():
    """The reference's own semantics (ROADMAP 3b): a prefill of one
    repeated token routes every token alike, so the ``dropping`` dispatch
    drops copies past capacity, where decode (N = B tokens a step, 8 slots
    an expert) drops none.  Each side equals the reference's; decode
    equals prefill before the first dropped copy of each row and differs
    at it; under ``dense`` they agree everywhere."""
    arch, Sd = "deepseek-v2-lite-16b", 32
    toks = np.full((B, Sd), 17, np.int32)
    toks[:, ::5] = 3
    out = {}
    for impl in ("dropping", "dense"):
        j, t = _cfgs(arch)
        jm, tm = j_build_model(j, moe_impl=impl), build_model(t, moe_impl=impl)
        jp = jax.tree_util.tree_map(jnp.asarray, _params(arch))
        tp = from_jax_params(_params(arch), "cpu")
        with recorded_routing(jmoe, tmoe) as rec:
            jpre = _f(jm.forward(jp, {"tokens": jnp.asarray(toks)})[0])
            tpre = _f(tm.forward(tp, {"tokens": torch.as_tensor(toks)})[0])
        flipped_rows(rec, exact=True)
        tc = tm.init_cache(B, Sd, dtype="float32", device="cpu")
        jc = jm.init_cache(B, Sd, dtype="float32")
        tdec, jdec = [], []
        for i in range(Sd):
            lg, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(i + 1, jnp.int32))
            jdec.append(_f(lg[:, 0]))
            tdec.append(_f(tm.decode_step(tp, tc, torch.as_tensor(
                toks[:, i:i + 1]), i + 1)[0][:, 0]))
        tdec, jdec = np.stack(tdec, 1), np.stack(jdec, 1)
        np.testing.assert_allclose(tpre, jpre, **TOL["float32"])
        np.testing.assert_allclose(tdec, jdec, **TOL["float32"])
        out[impl] = (tpre, tdec, rec["torch"])
    np.testing.assert_allclose(out["dense"][1], out["dense"][0],
                               **TOL["float32"])
    pre, dec, calls = out["dropping"]
    k, E = _cfgs(arch)[1].num_experts_per_tok, _cfgs(arch)[1].num_experts
    C = tmoe.capacity(B * Sd, k, E)
    first = np.full(B, Sd)
    for ids, _ in calls:
        keep = tmoe.dispatch_slots(torch.as_tensor(ids.reshape(1, -1)), E,
                                   C)[1].numpy().reshape(B, Sd, k)
        lost = ~keep.all(axis=2)
        for b in range(B):
            if lost[b].any():
                first[b] = min(first[b], np.nonzero(lost[b])[0][0])
    assert (first < Sd).any(), "the prefill dropped no copy"
    for b in range(B):
        np.testing.assert_allclose(dec[b, :first[b]], pre[b, :first[b]],
                                   **TOL["float32"])
        if first[b] < Sd:
            assert np.abs(dec[b, first[b]] - pre[b, first[b]]).max() > 1e-2


def test_moe_train_state_checkpoint_round_trip():
    """A reduced deepseek train state after one step (params, AdamW state,
    cursor: router, expert, shared-expert, MLA and ``kv_norm`` leaves)
    through the port's ``CheckpointManager`` on the CPU: the manifest
    equals the JAX manager's for the same state (keys, shapes, dtypes,
    per-chunk checksums and sizes), the chunks sit on the same nodes, and
    the restore equals the saved state bit for bit."""
    arch = "deepseek-v2-lite-16b"
    _, t = _cfgs(arch)
    opt = AdamW(warmup_steps=1, total_steps=4)
    params = from_jax_params(_params(arch), "cpu")
    params, ost, _ = make_train_step(build_model(t), opt)(
        params, opt.init(params), _both(_np_batch(arch))[1])
    state = (params, ost, torch.tensor([0, 1], dtype=torch.int32))
    np_state = to_numpy_tree(state)
    from repro.train.optimizer import AdamWState as JAdamWState
    jstate = (jax.tree_util.tree_map(jnp.asarray, np_state[0]),
              JAdamWState(jnp.asarray(np_state[1].step),
                          jax.tree_util.tree_map(jnp.asarray,
                                                 np_state[1].mu),
                          jax.tree_util.tree_map(jnp.asarray,
                                                 np_state[1].nu)),
              jnp.asarray(np_state[2]))
    keys = [k for k, _ in flatten_state(state)]
    for leaf in ("['moe']/['router']", "['attn']/['kv_norm']",
                 "['moe']/['shared_wo']", "['moe']/['wi_gate']"):
        assert any(k.endswith(leaf) for k in keys), leaf
    jpol = JPolicy.from_scopes({"ckpt": JMode.HYBRID}, n_nodes=8,
                               default=JMode.CENTRAL_META)
    tpol = LayoutPolicy.from_scopes({"ckpt": LayoutMode.HYBRID}, n_nodes=8,
                                    default=LayoutMode.CENTRAL_META)
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        jm = JManager(dj, jpol, async_save=False)
        tm = CheckpointManager(dt, tpol, async_save=False, device="cpu")
        jm.save(1, jstate)
        tm.save(1, state)
        assert json.loads((tm.dir / "ckpt_1.json").read_text()) == \
            json.loads((jm.dir / "ckpt_1.json").read_text())
        for jn, tn in zip(jm.store.nodes, tm.store.nodes):
            assert list(tn) == list(jn)
        like = (params, ost, torch.zeros(2, dtype=torch.int32))
        restored, step = tm.restore(1, like)
        assert step == 1
        for (k, a), (_, b) in zip(flatten_state(restored),
                                  flatten_state(state)):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_take_the_new_archs(arch, capsys):
    """``launch/serve.py``, ``examples/serve_lm.py`` and ``launch/train.py``
    take ``--arch`` for the three configs (reduced, on the CPU), as the
    reference's do: greedy tokens of the expected shape, and a short
    training run with checkpoints and finite losses."""
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    from repro_torch.launch import train as launcher
    gen = serve.main(["--arch", arch, "--device", "cpu", "--tokens", "6"])
    assert gen.shape == (4, 6) and ((0 <= gen) & (gen < 256)).all()
    gen = serve_lm.main(["--arch", arch, "--device", "cpu", "--tokens", "5"])
    assert gen.shape == (4, 5)
    res = launcher.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                         "--ckpt-every", "1", "--batch", "2", "--seq", "16"])
    assert res.final_step == 2 and np.isfinite(res.losses).all()
    out = capsys.readouterr().out
    assert f"[serve] {arch}: generated 5 tokens" in out
    assert "[train] 2 steps in " in out


def test_materialize_draws_each_leaf_straight_into_its_dtype():
    """One generator, leaves in sorted path order, each drawn in place in
    its own dtype (a bf16 leaf through no float32 copy of itself) at its
    fan-in's std; a leaf's own dtype overrides the tree's."""
    from repro_torch.models import param as t_param
    tree = {"b": t_param.P((6, 4)), "a": t_param.P((3, 5, 7)),
            "n": t_param.P((4,), init="ones"),
            "z": t_param.P((2, 3), init="zeros"),
            "k": t_param.P((8, 2), dtype="float32")}
    for dtype in ("bfloat16", "float32"):
        got = t_param.materialize(0, tree, dtype, "cpu")
        gen = torch.Generator().manual_seed(0)
        for key in ("a", "b", "k"):
            p = tree[key]
            dt = t_param.torch_dtype(p.dtype or dtype)
            want = torch.empty(p.shape, dtype=dt).normal_(
                0.0, p.std(), generator=gen)
            assert got[key].dtype == dt and torch.equal(got[key], want), key
        assert torch.equal(got["n"], torch.ones(4, dtype=got["n"].dtype))
        assert not got["z"].any() and got["z"].dtype == got["b"].dtype


def test_vlm_microbatches_slice_the_positions_on_their_batch_axis():
    """Two microbatches of a VLM batch give the full batch's gradients:
    ``mrope_positions`` (3, B, S) are cut on B, not on the stream axis (the
    reference cuts every input on its first axis, ROADMAP 3b)."""
    arch = "qwen2-vl-2b"
    _, t = _cfgs(arch)
    batch = _both(_np_batch(arch, B=4))[1]
    opt = AdamW(warmup_steps=1, total_steps=2)
    params = from_jax_params(_params(arch), "cpu")
    one = make_train_step(build_model(t), opt)(params, opt.init(params),
                                               batch)[2]
    two = make_train_step(build_model(t), opt, microbatches=2)(
        params, opt.init(params), batch)[2]
    np.testing.assert_allclose(float(two["grad_norm"]),
                               float(one["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_fan_in_rule_matches_reference(arch):
    """The port draws every leaf at the reference's std: fan-in from
    ``shape[0]`` (after ``stack_layers``, the layer count, also for the
    (L, E, d, F) expert leaves: ROADMAP 3b), the router at 0.02, norms at
    one.  Sample stds of both packages' inits within 10% of each other
    and of that rule, leaf by leaf."""
    j, t = _cfgs(arch)
    jp = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(
        np.asarray, j_build_model(j).init(jax.random.PRNGKey(0))))[0]
    tp = list(iter_leaves(build_model(t).init(0, "cpu")))
    for (path, a), (tpath, b) in zip(jp, tp):
        assert tuple(k.key for k in path) == tpath
        b = b.numpy()
        if a.size < 1000 or tpath[-1] in ("kv_norm",):
            continue
        want = 0.02 if tpath[-1] == "router" else 1 / math.sqrt(a.shape[0])
        for x in (a, b):
            assert abs(x.std() / want - 1) < 0.1, (tpath, x.std(), want)
