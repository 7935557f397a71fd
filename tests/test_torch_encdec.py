"""The port's audio family (``models/encdec.py``, whisper-base) against the
JAX package on the CPU, at the reduced config: the layers it adds
(``layer_norm``, ``sinusoidal_positions``, attention without RoPE), the
parameter and cache trees, ``encode``, ``forward`` in float32 and bf16,
``loss_fn`` with its gradients and one AdamW step, decode steps with the
cache carried across (the port's written in place, equal to the reference's
returned tree), decode against ``forward`` and the serving entry points.

Weights: the JAX init carried across, the zero-init qkv biases drawn at
random (std 0.5).  Frames: seeded normal ``audio_embeds`` (B, 16, 64).
Tolerances: as ``tests/test_torch_recurrent.py``.

Pinned reference fault (ROADMAP 3b): ``init_cache`` zero-fills the cross
k and v and no serve path fills them, so decode from that cache does not
reproduce ``forward``; filled from ``_xattn_kv`` of ``encode``'s output
(composed by the caller, as ``chip_smoke.py`` phase l does), it does.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _model_families import (REL, as_float32 as _f, assert_bf16_close,
                             assert_rel_close as _close,
                             assert_tree_close as _assert_tree_close,
                             stdout_lines as _stdout)
from repro.configs import all_configs as j_all_configs
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import encdec as j_encdec
from repro.models import layers as j_layers
from repro.models.param import count_params as j_count_params
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import apply_updates as j_apply_updates
from repro.train.train_step import make_serve_step as j_make_serve_step
from repro_torch.configs import all_configs
from repro_torch.models import attention as t_attn
from repro_torch.models import encdec as t_encdec
from repro_torch.models import layers as t_layers
from repro_torch.models.convert import (from_jax_cache, from_jax_opt_state,
                                        from_jax_params, to_numpy_tree)
from repro_torch.models.param import count_params, iter_leaves
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import _value_and_grad, make_train_step

ARCH = "whisper-base"
TREE_SIZE = 87_465_984
STEPS = 10


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype: str):
    return tuple(dataclasses.replace(c[ARCH].reduced(), dtype=dtype)
                 for c in (j_all_configs(), all_configs()))


@functools.lru_cache(maxsize=None)
def _jax_init():
    j, _ = _cfgs("float32")
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        j_build_model(j).init)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _params():
    rng = np.random.RandomState(1)

    def fix(path, a):
        if path[-1].key in ("bq", "bk", "bv"):
            return (0.5 * rng.randn(*a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fix, _jax_init())


def _tokens(B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, 256, (B, S)).astype(
        np.int32)


def _frames(B: int, seed: int = 0) -> np.ndarray:
    j, _ = _cfgs("float32")
    return np.random.RandomState(100 + seed).randn(
        B, j.encoder_seq, j.d_model).astype(np.float32)


def _jbatch(toks, frames):
    return {"tokens": jnp.asarray(toks), "audio_embeds": jnp.asarray(frames)}


def _tbatch(toks, frames):
    return {"tokens": torch.as_tensor(toks),
            "audio_embeds": torch.as_tensor(frames)}


def _jp():
    return jax.tree_util.tree_map(jnp.asarray, _params())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d", [(16, 64), (1500, 512), (5, 2), (7, 3)])
def test_sinusoidal_positions_match_reference(n, d):
    """Whisper's table, the ``max(d//2 - 1, 1)`` denominator included (d 2
    and an odd d), against the reference's and a float64 table: at 1500
    frames an angle reaches ~1500, where an ulp of the float32 frequency
    moves a sine by ~1e-4 in either package, so the port is held within
    twice the reference's own distance from float64 (or 1e-5)."""
    want = np.asarray(j_layers.sinusoidal_positions(n, d), np.float64)
    got = t_layers.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, 2 * (d // 2))
    inv = np.exp(-np.log(10000.0) * np.arange(d // 2) / max(d // 2 - 1, 1))
    ang = np.arange(n)[:, None] * inv[None, :]
    exact = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    ref = np.abs(want - exact).max()
    assert np.abs(got.double().numpy() - exact).max() <= max(2 * ref, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.RandomState(0)
    x = (3 + 2 * rng.randn(2, 5, 48)).astype(np.float32)
    scale, b = rng.randn(48).astype(np.float32), rng.randn(48).astype(
        np.float32)
    jd = jnp.dtype(dtype)
    want = j_layers.layer_norm(jnp.asarray(x, jd), jnp.asarray(scale),
                               jnp.asarray(b))
    got = t_layers.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(scale), torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want)
    else:
        np.testing.assert_allclose(_f(got), _f(want), rtol=1e-2, atol=1e-2)


def test_attention_without_positions_applies_no_rope():
    """``positions=None`` (whisper's decoder): no rotation, in prefill and
    in decode, as the reference's ``elif positions is not None``."""
    j, t = _cfgs("float32")
    p = _params()["decoder"]["layer0"]["attn"]
    x = np.random.RandomState(3).randn(2, 6, j.d_model).astype(np.float32)
    want, _ = j_attn.apply_attention(jax.tree_util.tree_map(jnp.asarray, p),
                                     jnp.asarray(x), None, j)
    tp = from_jax_params(p, "cpu")
    _close(t_attn.apply_attention(tp, torch.from_numpy(x), None, t), want)
    jc = j_attn.init_kv_cache(j, 2, 8, "float32")
    want, _ = j_attn.apply_attention(jax.tree_util.tree_map(jnp.asarray, p),
                                     jnp.asarray(x[:, :1]), None, j,
                                     cache=jc, cache_len=jnp.asarray(1))
    tc = t_attn.init_kv_cache(t, 2, 8, "float32", device="cpu")
    _close(t_attn.apply_attention(tp, torch.from_numpy(x[:, :1]), None, t,
                                  cache=tc, cache_len=1), want)
    rotated = t_attn.apply_attention(
        tp, torch.from_numpy(x), torch.arange(6)[None], t)
    assert (_f(rotated) != np.asarray(j_attn.apply_attention(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), None,
        j)[0])).any()


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def test_param_tree_matches_reference():
    """Paths, shapes and dtypes of the reduced init; the tree's size at full
    width (the reference's and the pin); ``pos_dec`` drawn at std 0.01."""
    j, t = j_all_configs()[ARCH], all_configs()[ARCH]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.param_count() == j.param_count()
    assert count_params(build_model(t).describe()) == \
        j_count_params(j_build_model(j).describe()) == TREE_SIZE
    want = _jax_init()
    got = build_model(t.reduced()).init(0, "cpu")
    flat, jflat = list(iter_leaves(got)), \
        jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat] == [tuple(k.key for k in path)
                                    for path, _ in jflat]
    for (path, a), (_, b) in zip(flat, jflat):
        assert tuple(a.shape) == b.shape and str(a.dtype) == \
            f"torch.{b.dtype}", path
        if path[-1] in ("bq", "bk", "bv") or path[0].startswith("ln_"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=str(path))
    assert abs(got["pos_dec"].std().item() / 0.01 - 1) < 0.05


def test_cache_tree_matches_reference():
    j, t = _cfgs("bfloat16")
    jm, tm = j_build_model(j), build_model(t)
    want = jm.init_cache(3, 20)
    got = tm.init_cache(3, 20, device="cpu")
    _assert_tree_close(got, want)
    for (_, a), b in zip(iter_leaves(got), jax.tree_util.tree_leaves(want)):
        assert str(a.dtype) == f"torch.{b.dtype}"
    meta = tm.abstract_cache(3, 20, dtype="float32")
    assert all(x.device.type == "meta" and x.dtype == torch.float32
               for _, x in iter_leaves(meta))
    assert [tuple(x.shape) for _, x in iter_leaves(meta)] == \
        [s.shape for s in jax.tree_util.tree_leaves(jm.abstract_cache(3, 20))]
    assert tm.cache_axes(3, 20) == jm.cache_axes(3, 20)


# ---------------------------------------------------------------------------
# encode, forward, loss, gradients, AdamW
# ---------------------------------------------------------------------------
def test_encode_matches_reference():
    j, t = _cfgs("float32")
    frames = _frames(2)
    want = jax.jit(j_build_model(j).encode)(_jp(), jnp.asarray(frames))
    with torch.no_grad():
        got = build_model(t).encode(from_jax_params(_params(), "cpu"),
                                    torch.as_tensor(frames))
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _jax_forward(dtype: str):
    j, _ = _cfgs(dtype)
    toks, frames = _tokens(2, 24, seed=2), _frames(2, seed=2)
    out = jax.jit(j_build_model(j).forward)(_jp(), _jbatch(toks, frames))[0]
    return toks, frames, np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    toks, frames, want = _jax_forward(dtype)
    _, t = _cfgs(dtype)
    model = build_model(t)
    params = from_jax_params(_params(), "cpu")
    with torch.no_grad():
        got, aux = model.forward(params, _tbatch(toks, frames))
        last = model.last_logits(params, _tbatch(toks, frames))
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _close(last, got[:, -1], 1e-6)
    if dtype == "float32":
        _close(got, want)
    else:
        assert_bf16_close(_f(got), want, _jax_forward("float32")[2])


def test_loss_grads_and_adamw_step_match_reference():
    j, t = _cfgs("float32")
    toks, frames = _tokens(2, 17, seed=4), _frames(2, seed=4)
    jb = {**_jbatch(toks[:, :-1], frames), "targets": jnp.asarray(toks[:, 1:])}
    tb = {**_tbatch(toks[:, :-1], frames),
          "targets": torch.as_tensor(toks[:, 1:])}
    jm, tm = j_build_model(j), build_model(t)
    jp, tp = _jp(), from_jax_params(_params(), "cpu")
    jopt = JAdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    topt = AdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jst = jopt.init(jp)
    (jloss, jmet), jgrad = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, jb)

    def update(g, st, p):
        upd, _, met = jopt.update(g, st, p)
        return j_apply_updates(p, upd), met
    jp2, jopt_met = jax.jit(update)(jgrad, jst, jp)
    jmet = {**jmet, **jopt_met}
    tgrad, tmet = _value_and_grad(tm, tp, tb)
    _close(tmet["loss"], jloss)
    # the encoder's ``bk`` has an exact gradient of zero (it adds q·bk to
    # every score of a query, which the softmax removes): both packages
    # give float32 noise there, held to 1e-6 of the largest gradient
    top = max(np.abs(np.asarray(g)).max()
              for g in jax.tree_util.tree_leaves(jgrad))
    for (path, a), b in zip(iter_leaves(to_numpy_tree(tgrad)),
                            jax.tree_util.tree_leaves(jgrad)):
        b = np.asarray(b)
        if path[-1] == "bk":
            assert np.abs(b).max() < 1e-6 * top and \
                np.abs(a).max() < 1e-6 * top, path
        else:
            _close(a, b, 1e-4, str(path))
    tp2, _, tmet = make_train_step(tm, topt)(
        tp, from_jax_opt_state(jax.tree_util.tree_map(np.asarray, jst),
                               "cpu"), tb)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-4)
    for (_, a), b in zip(iter_leaves(to_numpy_tree(tp2)),
                         jax.tree_util.tree_leaves(jp2)):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_decode(dtype: str, filled: bool, B: int = 2):
    """The reference's decode steps (jitted) from its ``init_cache``, the
    cross k and v zero or (``filled``) ``_xattn_kv`` of ``encode``'s
    output: the tokens and frames, its logits, its first and last caches."""
    j, _ = _cfgs(dtype)
    model = j_build_model(j)
    params = _jp()
    toks, frames = _tokens(B, STEPS, seed=5), _frames(B, seed=5)
    cache = model.init_cache(B, STEPS, dtype=dtype)
    if filled:
        enc = model.encode(params, jnp.asarray(frames))
        for i in range(j.num_layers):
            k, v = j_encdec._xattn_kv(
                params["decoder"][f"layer{i}"]["xattn"], enc, j)
            cache[f"layer{i}"]["cross_k"] = k.astype(dtype)
            cache[f"layer{i}"]["cross_v"] = v.astype(dtype)
    cache0, logits = cache, []
    step = jax.jit(model.decode_step)
    for i in range(STEPS):
        lg, cache = step(params, cache, jnp.asarray(toks[:, i:i + 1]),
                         jnp.asarray(i + 1, jnp.int32))
        logits.append(np.asarray(lg[:, 0], np.float32))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return toks, frames, np.stack(logits, 1), np_tree(cache0), \
        np_tree(cache)


def _fill_cross(model, params, cache, frames):
    """The port's cross k and v from ``_xattn_kv`` of ``encode``'s output,
    written into ``cache`` in place."""
    with torch.no_grad():
        enc = model.encode(params, torch.as_tensor(frames))
        for i in range(model.cfg.num_layers):
            k, v = t_encdec._xattn_kv(params["decoder"][f"layer{i}"]["xattn"],
                                      enc, model.cfg)
            cache[f"layer{i}"]["cross_k"].copy_(k)
            cache[f"layer{i}"]["cross_v"].copy_(v)


def _port_decode(model, params, cache, toks):
    leaves = [x for _, x in iter_leaves(cache)]
    out = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            lg, same = model.decode_step(params, cache,
                                         torch.as_tensor(toks[:, i:i + 1]),
                                         i + 1)
            assert same is cache and lg.shape[1] == 1
            out.append(_f(lg[:, 0]))
    assert all(a is b for a, (_, b) in zip(leaves, iter_leaves(cache)))
    return np.stack(out, 1)


@pytest.mark.parametrize("filled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype, filled):
    """From the reference's cache carried across (zero cross k and v, as
    its serve path leaves them, or filled from the encoder): its logits at
    every step; the tree written in place ends equal to the reference's
    returned one."""
    toks, _, want, cache0, want_cache = _jax_decode(dtype, filled)
    _, t = _cfgs(dtype)
    model = build_model(t)
    params = from_jax_params(_params(), "cpu")
    cache = from_jax_cache(cache0, "cpu")
    got = _port_decode(model, params, cache, toks)
    if dtype == "float32":
        _close(got, want)
        _assert_tree_close(cache, want_cache)
    else:
        assert_bf16_close(got, want, _jax_decode("float32", filled)[2])


def test_decode_against_forward_pinned():
    """In float32: with the cross cache filled from ``encode`` (by the
    caller) decode reproduces ``forward`` within 1e-5 of the largest
    logit, in both packages; with the zero cross cache of ``init_cache``
    it does not, by as much as the reference's (ROADMAP 3b)."""
    j, t = _cfgs("float32")
    model = build_model(t)
    params = from_jax_params(_params(), "cpu")
    for filled in (True, False):
        toks, frames, jdec, _, _ = _jax_decode("float32", filled)
        jfwd = np.asarray(jax.jit(j_build_model(j).forward)(
            _jp(), _jbatch(toks, frames))[0], np.float32)
        with torch.no_grad():
            fwd = _f(model.forward(params, _tbatch(toks, frames))[0])
        cache = model.init_cache(2, STEPS, dtype="float32", device="cpu")
        if filled:
            _fill_cross(model, params, cache, frames)
        dec = _port_decode(model, params, cache, toks)
        _close(fwd, jfwd)
        _close(dec, jdec)
        scale = np.abs(fwd).max()
        gap, jgap = np.abs(dec - fwd).max(), np.abs(jdec - jfwd).max()
        if filled:
            assert gap <= REL * scale and jgap <= REL * scale, (gap, jgap)
        else:
            assert gap > 0.1 * scale, gap
            assert abs(gap - jgap) <= REL * scale, (gap, jgap)


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------
def test_serve_entry_points_take_the_arch():
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    lines, gen = _stdout(serve.main, ["--arch", ARCH, "--device", "cpu",
                                      "--tokens", "6", "--prompt-len", "4"])
    assert gen.shape == (4, 6) and ((0 <= gen) & (gen < 256)).all()
    assert re.fullmatch(r"\[serve\] generated \(4, 6\) in [0-9.]+s "
                        r"\([0-9.]+ tok/s\)", lines[0])
    assert lines[1] == f"[serve] sample: {gen[0][:16].tolist()}"
    lines, gen = _stdout(serve_lm.main, ["--arch", ARCH, "--device", "cpu",
                                         "--tokens", "5"])
    assert gen.shape == (4, 5)
    assert lines[0].startswith(f"[serve] {ARCH}: generated 5 tokens × "
                               f"batch 4 in ")
    assert lines[1] == f"[serve] first sequence: {gen[0].tolist()}"


def test_greedy_decode_gives_the_reference_tokens():
    """``launch.serve.greedy_decode`` with the weights carried across, in
    float32 (a float32 cache, its cross k and v zero as the reference's
    serve loop leaves them), gives that loop's tokens."""
    from repro_torch.launch.serve import greedy_decode
    j, t = _cfgs("float32")
    B, P, G = 2, 5, 7
    prompt = _tokens(B, P, seed=8)
    jm = j_build_model(j)
    serve = jax.jit(j_make_serve_step(jm))
    cache = jm.init_cache(B, P + G + 8, dtype="float32")
    tok, want = jnp.asarray(prompt[:, :1]), []
    for i in range(P + G - 1):
        nxt, cache = serve(_jp(), cache, tok, jnp.asarray(i + 1, jnp.int32))
        if i + 1 < P:
            tok = jnp.asarray(prompt[:, i + 1:i + 2])
        else:
            tok = nxt[:, None]
            want.append(np.asarray(nxt))
    model = build_model(t)
    model.init_cache = functools.partial(model.init_cache, dtype="float32")
    got = greedy_decode(model, from_jax_params(_params(), "cpu"), prompt, G,
                        P + G + 8, 0, "cpu")
    np.testing.assert_array_equal(got, np.stack(want, 1))
