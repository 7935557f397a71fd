"""The port's attention against the JAX package's on the CPU: one-token
decode against a cache (full, windowed, with sinks; GQA groups 1, 2 and 4;
``cache_len`` at 1, the window, the cache's end and one past it), the
blocked prefill forms, the layer with a cache (its output and the cache it
writes), qkv biases, and decode against prefill — equal on full layers,
and on local layers equal below the window and beyond it equal to each of
the reference's two sides, which differ there (prefill's query sees
``window + 1`` keys, decode's ``window``).

Tolerances: float32 ``rtol 1e-4, atol 1e-5`` (two float32 evaluations of
one formula in different summation orders); bf16 ``2e-2`` (both round a
float32 result to bf16 once: one bf16 ulp at 2-4).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.models import attention as j_attn
from repro.models.param import materialize as j_materialize
from repro_torch.configs import all_configs
from repro_torch.models import attention as t_attn
from repro_torch.models.convert import from_jax_params, tensor_from_numpy

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes: torch's thread a core only spins against JAX's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a CPU tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    return j, tensor_from_numpy(np.asarray(j), "cpu")


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------
MAX_LEN, WINDOW = 24, 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_len", [1, WINDOW, MAX_LEN, MAX_LEN + 1])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("window,sink", [(0, 0), (WINDOW, 0), (WINDOW, 3)],
                         ids=["full", "windowed", "sink"])
def test_decode_attention_matches_reference(window, sink, groups, cache_len,
                                            dtype):
    B, KV, D = 2, 2, 16
    rng = np.random.RandomState(groups * 100 + cache_len + window + sink)
    q = rng.randn(B, 1, KV * groups, D)
    kc, vc = (rng.randn(B, MAX_LEN, KV, D) for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kc, vc))
    kw = dict(window=window, scale=1 / math.sqrt(D), groups=groups,
              sink_len=sink)
    want = j_attn.decode_attention(jq, jk, jv, jnp.asarray(cache_len), **kw)
    got = t_attn.decode_attention(tq, tk, tv, cache_len, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


# ---------------------------------------------------------------------------
# the blocked prefill forms (tests/test_attention_math.py's shapes)
# ---------------------------------------------------------------------------
def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    return [jnp.asarray(a) for a in arrs], [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("block_q", [1024, 32])
@pytest.mark.parametrize("S,block", [(128, 32), (200, 64), (96, 96)])
def test_online_softmax_matches_reference(S, block, block_q, monkeypatch):
    """The port's q blocks (one block, and 32-row blocks that stop at the
    causal diagonal) against the reference's one pass over KV blocks, and
    against the masked form."""
    monkeypatch.setattr(t_attn, "BLOCK_Q", block_q)
    D = 16
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, S, 3, D), S + block)
    scale = 1 / math.sqrt(D)
    want = j_attn.online_softmax_attention(jq, jk, jv, causal=True,
                                           q_offset=0, scale=scale,
                                           block_kv=block)
    got = t_attn.online_softmax_attention(tq, tk, tv, causal=True,
                                          scale=scale, block_kv=block)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(
        _np(got), _np(t_attn.masked_attention(tq, tk, tv, window=0,
                                              scale=scale)), **F32)


@pytest.mark.parametrize("reference", ["windowed_attention",
                                       "windowed_attention_parallel"])
@pytest.mark.parametrize("window,sink,block_q", [(16, 0, 32), (32, 0, 32),
                                                 (16, 8, 32), (32, 8, 32),
                                                 (16, 8, 16)])
def test_windowed_matches_both_reference_forms(window, sink, block_q,
                                               reference):
    """One torch form for the reference's sequential and batched-block
    windowed attention (the second is a sharding layout of the first),
    and the masked form with the same window and sinks."""
    D = 16
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, 128, 2, D), window + sink + block_q)
    scale = 1 / math.sqrt(D)
    want = getattr(j_attn, reference)(jq, jk, jv, window=window, scale=scale,
                                      block_q=block_q, sink_len=sink)
    got = t_attn.windowed_attention(tq, tk, tv, window=window, scale=scale,
                                    block_q=block_q, sink_len=sink)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(
        _np(got), _np(t_attn.masked_attention(tq, tk, tv, window=window,
                                              scale=scale, sink_len=sink)),
        **F32)


# ---------------------------------------------------------------------------
# the layer: qkv biases, the cache branch, the blocked dispatch
# ---------------------------------------------------------------------------
def _layer(arch: str, dtype: str = "float32", seed: int = 1):
    """One attention layer of the reduced ``arch`` from the JAX init, its
    stacked-axis fan-in scale as in the reference, and random qkv biases
    where the config has them (the init makes them zero)."""
    j = dataclasses.replace(j_all_configs()[arch].reduced(), dtype=dtype)
    t = dataclasses.replace(all_configs()[arch].reduced(), dtype=dtype)
    p = jax.tree_util.tree_map(
        np.asarray, j_materialize(jax.random.PRNGKey(seed),
                                  j_attn.describe_attention(j)))
    rng = np.random.RandomState(seed)
    for name in ("bq", "bk", "bv"):
        if name in p:
            p[name] = (0.5 * rng.randn(*p[name].shape)).astype(np.float32)
    return j, t, p


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "gemma-7b", "gemma3-1b"])
@pytest.mark.parametrize("window", [0, 4])
def test_prefill_layer_with_biases_matches_reference(arch, window):
    """``apply_attention`` without a cache (masked form), qkv biases added
    before RoPE where the config has them."""
    j, t, p = _layer(arch)
    assert ("bq" in p) == j.qkv_bias
    rng = np.random.RandomState(7)
    x = rng.randn(2, 16, j.d_model).astype(np.float32)
    pos = np.arange(16)[None]
    want, _ = j_attn.apply_attention(jax.tree_util.tree_map(jnp.asarray, p),
                                     jnp.asarray(x), jnp.asarray(pos), j,
                                     window=window)
    got = t_attn.apply_attention(from_jax_params(p, "cpu"),
                                 torch.as_tensor(x), torch.as_tensor(pos), t,
                                 window=window)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    q, k, v = t_attn.project_qkv(from_jax_params(p, "cpu"),
                                 torch.as_tensor(x), torch.as_tensor(pos), t)
    assert q.shape == k.shape == v.shape == (2, 16, t.num_heads, t.head_dim)


@pytest.mark.parametrize("window", [0, 6])
def test_blocked_dispatch_matches_reference(window, monkeypatch):
    """Above ``MASKED_SCORES_BYTES`` the layer takes the blocked forms (here
    forced at S 40 with 16-row blocks): the same output as the masked form
    and as the reference's layer, which always takes its blocked forms."""
    j, t, p = _layer("qwen1.5-110b")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 40, j.d_model).astype(np.float32)
    pos = np.arange(40)[None]
    tp, tx, tpos = from_jax_params(p, "cpu"), torch.as_tensor(x), \
        torch.as_tensor(pos)
    masked = t_attn.apply_attention(tp, tx, tpos, t, window=window)
    calls = []
    for name in ("online_softmax_attention", "windowed_attention"):
        real = getattr(t_attn, name)
        monkeypatch.setattr(t_attn, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    monkeypatch.setattr(t_attn, "MASKED_SCORES_BYTES", 0)
    monkeypatch.setattr(t_attn, "BLOCK_Q", 16)
    blocked = t_attn.apply_attention(tp, tx, tpos, t, window=window)
    assert calls == ["windowed_attention" if window else
                     "online_softmax_attention"]
    want, _ = j_attn.apply_attention(jax.tree_util.tree_map(jnp.asarray, p),
                                     jnp.asarray(x), jnp.asarray(pos), j,
                                     window=window)
    np.testing.assert_allclose(_np(blocked), _np(masked), **F32)
    np.testing.assert_allclose(_np(blocked), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_len", [1, 5, 12, 13])
@pytest.mark.parametrize("arch,window", [("qwen1.5-110b", 0),
                                         ("gemma3-1b", 4)])
def test_layer_with_cache_matches_reference(arch, window, cache_len, dtype):
    """The cache branch: k and v written at ``cache_len - 1`` (at 13, past
    the 12-slot cache, the index is clamped as ``dynamic_update_slice``
    clamps it and the last slot is overwritten), then decode; the output
    and the whole written cache against the reference's."""
    j, t, p = _layer(arch, dtype)
    B, L = 2, 12
    rng = np.random.RandomState(cache_len)
    x = rng.randn(B, 1, j.d_model)
    kc, vc = (rng.randn(B, L, j.num_kv_heads, j.head_dim) for _ in range(2))
    (jx, tx), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (x, kc, vc))
    pos = np.full((B, 1), cache_len - 1, np.int32)
    want, new = j_attn.apply_attention(
        jax.tree_util.tree_map(jnp.asarray, p), jx, jnp.asarray(pos), j,
        window=window, cache={"k": jk, "v": jv},
        cache_len=jnp.asarray(cache_len))
    cache = {"k": tk.clone(), "v": tv.clone()}
    got = t_attn.apply_attention(from_jax_params(p, "cpu"), tx,
                                 torch.as_tensor(pos), t, window=window,
                                 cache=cache, cache_len=cache_len)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(new[name]), **tol)
        changed = (cache[name] != {"k": tk, "v": tv}[name]).any(dim=(0, 2, 3))
        slot = min(cache_len - 1, L - 1)
        assert changed.nonzero().flatten().tolist() == [slot]


def test_cache_write_refuses_another_dtype():
    _, t, p = _layer("gemma-7b")
    cache = t_attn.init_kv_cache(t, 1, 4, dtype="bfloat16", device="cpu")
    with pytest.raises(TypeError, match="bfloat16"):
        t_attn.apply_attention(from_jax_params(p, "cpu"),
                               torch.zeros(1, 1, t.d_model),
                               torch.zeros(1, 1, dtype=torch.int32), t,
                               cache=cache, cache_len=1)


def test_kv_cache_shapes_match_reference():
    j, t = (c["qwen1.5-110b"].reduced() for c in (j_all_configs(),
                                                   all_configs()))
    want = j_attn.init_kv_cache(j, 3, 10)
    got = t_attn.init_kv_cache(t, 3, 10, device="cpu")
    meta = t_attn.abstract_kv_cache(t, 3, 10, dtype="float32")
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape == \
            tuple(meta[name].shape) == j_attn.abstract_kv_cache(
                j, 3, 10)[name].shape
        assert got[name].dtype == torch.bfloat16 and not got[name].any()
        assert meta[name].device.type == "meta" and \
            meta[name].dtype == torch.float32


# ---------------------------------------------------------------------------
# decode against prefill, one layer (the reference's own test, and its
# sliding-window counterpart, which pins the reference's mismatch)
# ---------------------------------------------------------------------------
def _decode_and_prefill(arch: str, window: int, S: int = 16):
    """One layer's prefill over S positions and its decode token by token
    through a zero cache, in both packages: {(package, side): (B, S, d)}."""
    j, t, p = _layer(arch, seed=4)
    rng = np.random.RandomState(5)
    x = rng.randn(2, S, j.d_model).astype(np.float32)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), from_jax_params(p, "cpu")
    pos = np.arange(S)[None]
    out = {("jax", "prefill"): j_attn.apply_attention(
        jp, jnp.asarray(x), jnp.asarray(pos), j, window=window)[0],
        ("torch", "prefill"): t_attn.apply_attention(
        tp, torch.as_tensor(x), torch.as_tensor(pos), t, window=window)}
    shp = (2, S, j.num_kv_heads, j.head_dim)
    jc = {"k": jnp.zeros(shp), "v": jnp.zeros(shp)}
    tc = {"k": torch.zeros(shp), "v": torch.zeros(shp)}
    jo, to = [], []
    for i in range(S):
        post = np.full((2, 1), i, np.int32)
        o, jc = j_attn.apply_attention(jp, jnp.asarray(x[:, i:i + 1]),
                                       jnp.asarray(post), j, window=window,
                                       cache=jc, cache_len=jnp.asarray(i + 1))
        jo.append(o)
        to.append(t_attn.apply_attention(tp, torch.as_tensor(x[:, i:i + 1]),
                                         torch.as_tensor(post), t,
                                         window=window, cache=tc,
                                         cache_len=i + 1))
    out["jax", "decode"] = jnp.concatenate(jo, axis=1)
    out["torch", "decode"] = torch.cat(to, dim=1)
    return {k: _np(v) for k, v in out.items()}


def test_decode_equals_prefill_on_a_full_layer():
    out = _decode_and_prefill("gemma-7b", window=0)
    for key, got in out.items():
        np.testing.assert_allclose(got, out["jax", "prefill"], **F32,
                                   err_msg=str(key))


def test_window_mismatch_between_decode_and_prefill_pinned():
    """gemma3-1b's local layer at window 8: below position 8 the two sides
    agree; from 8 on, prefill's queries see 9 keys and decode's 8, so the
    sides differ, and the port equals the reference on each side."""
    W = 8
    out = _decode_and_prefill("gemma3-1b", window=W)
    for side in ("prefill", "decode"):
        np.testing.assert_allclose(out["torch", side], out["jax", side],
                                   **F32, err_msg=side)
    dec, pre = out["torch", "decode"], out["torch", "prefill"]
    np.testing.assert_allclose(dec[:, :W], pre[:, :W], **F32)
    gap = np.abs(dec - pre).max(axis=(0, 2))
    assert (gap[W:] > 1e-2).all(), gap
