"""The port's recurrent and hybrid families (``models/xlstm.py``,
``models/hymba.py``) against the JAX package on the CPU, at the reduced
configs: parameter trees, ``forward`` in float32 and bf16, ``loss_fn`` with
its gradients and one AdamW step, decode steps with caches carried across
(the port's written in place, equal to the reference's returned tree),
decode against ``forward`` and the serving entry points
(``tests/test_torch_train_lm.py`` holds the ``examples/train_lm`` twin).

Weights: the JAX init carried across (``models/convert.py``), the leaves
the init leaves at zero or constant drawn at random (xLSTM's gate and
recurrent weights, the conv biases) so that every product runs; Hymba's
stacked matrices rescaled to the per-layer fan-in
(``tests/_model_families.py``: its one-layer segments draw them at std 1,
ROADMAP 3b).  Sequence lengths: xLSTM at S 100 pads its mLSTM chunk,
Hymba at S 256 runs 260 rows with its 4 meta tokens, two scan chunks.

Tolerances: float32 1e-5 of the largest logit (``forward``, decode),
gradients 1e-4 of each leaf's largest, the loss and gradient norm of an
AdamW step 1e-4 relative and its parameters 1e-4 by each leaf's norm (as
``tests/test_torch_train.py``); bf16 the
gate of ``tests/_model_families.py`` (twice the reference's own bf16
distance from its float32 logits).

Pinned reference faults (ROADMAP 3b): Hymba's decode never feeds the meta
tokens, so it does not reproduce ``forward``; xLSTM's decode does.
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
                             per_layer_fan_in, stdout_lines as _stdout)
from repro.configs import all_configs as j_all_configs
from repro.models import build_model as j_build_model
from repro.models.param import count_params as j_count_params
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import apply_updates as j_apply_updates
from repro.train.train_step import make_serve_step as j_make_serve_step
from repro_torch.configs import all_configs
from repro_torch.models.convert import (from_jax_cache, from_jax_opt_state,
                                        from_jax_params, to_numpy_tree)
from repro_torch.models.param import count_params, iter_leaves
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import _value_and_grad, make_train_step

ARCHS = ("xlstm-125m", "hymba-1.5b")
TREE_SIZES = {"xlstm-125m": 155_651_408, "hymba-1.5b": 1_352_654_400}
SEQ = {"xlstm-125m": 100, "hymba-1.5b": 256}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, dtype: str):
    return tuple(dataclasses.replace(c[arch].reduced(), dtype=dtype)
                 for c in (j_all_configs(), all_configs()))


# leaves the reference inits at zero or a constant, drawn here at random
RANDOM_LEAVES = {"w_i": 0.3, "w_f": 0.3, "b_i": 1.0, "b_in": 0.5,
                 "r_z": 0.3, "r_i": 0.3, "r_f": 0.3, "r_o": 0.3,
                 "conv_b": 0.3}


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str):
    """The reduced ``arch``'s JAX init (PRNGKey(0)) as numpy."""
    j, _ = _cfgs(arch, "float32")
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        j_build_model(j).init)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    """The reduced ``arch``'s JAX init as numpy (module docstring)."""
    p = per_layer_fan_in(_jax_init(arch))
    rng = np.random.RandomState(1)

    def fix(path, a):
        std = RANDOM_LEAVES.get(path[-1].key)
        return a if std is None else (std * rng.randn(*a.shape)).astype(
            a.dtype)
    return jax.tree_util.tree_map_with_path(fix, p)


def _tokens(B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, 256, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Paths, shapes and dtypes of the reduced init equal the reference's;
    the tree's size at full width equals the reference's and the pin; the
    leaves with an init of their own (constants, A_log, ones) equal the
    reference's values, and the fixed-std normals draw at their std."""
    j, t = j_all_configs()[arch], all_configs()[arch]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.param_count() == j.param_count()
    assert count_params(build_model(t).describe()) == \
        j_count_params(j_build_model(j).describe()) == TREE_SIZES[arch]
    want = _jax_init(arch)
    got = build_model(t.reduced()).init(0, "cpu")
    flat, jflat = list(iter_leaves(got)), \
        jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat] == [tuple(k.key for k in path)
                                    for path, _ in jflat]
    for (path, a), (_, b) in zip(flat, jflat):
        assert tuple(a.shape) == b.shape and str(a.dtype) == \
            f"torch.{b.dtype}", path
        if path[-1] in ("b_f", "b_dt", "d_skip", "conv_b", "b_i", "w_i",
                        "w_f", "b_in") or path[-1].startswith("r_"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=str(path))
        if path[-1] == "a_log":    # float32 logs: XLA's and torch's, an ulp
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-7)
        if path[-1] == "conv_w":
            assert abs(a.std().item() / 0.1 - 1) < 0.15, a.std()


def test_registry_builds_every_arch():
    """``build_model`` builds all ten of the reference's ``ARCH_NAMES``:
    the same class names, fields, ``reduced()`` and parameter trees'
    sizes (full and reduced) as the reference's registry."""
    from repro.configs import ARCH_NAMES as J_ARCH_NAMES
    from repro_torch.configs import ARCH_NAMES
    assert ARCH_NAMES == J_ARCH_NAMES
    for arch in ARCH_NAMES:
        j, t = j_all_configs()[arch], all_configs()[arch]
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for jc, tc in ((j, t), (j.reduced(), t.reduced())):
            jm, tm = j_build_model(jc), build_model(tc)
            assert type(tm).__name__ == type(jm).__name__
            assert tm.param_count() == j_count_params(jm.describe())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_tree_matches_reference(arch):
    """``init_cache`` (stabilisers at -inf), ``abstract_cache`` (meta) and
    ``cache_axes`` against the reference's; ``from_jax_cache`` and
    ``to_numpy_tree`` carry xLSTM's tuple-valued states both ways."""
    j, t = _cfgs(arch, "bfloat16")
    jm, tm = j_build_model(j), build_model(t)
    want = jm.init_cache(3, 20)
    got = tm.init_cache(3, 20, device="cpu")
    _assert_tree_close(got, want)
    for (_, a), b in zip(iter_leaves(got), jax.tree_util.tree_leaves(want)):
        assert str(a.dtype) == f"torch.{b.dtype}"
    meta = tm.abstract_cache(3, 20)
    assert all(x.device.type == "meta" for _, x in iter_leaves(meta))
    assert [tuple(x.shape) for _, x in iter_leaves(meta)] == \
        [s.shape for s in jax.tree_util.tree_leaves(jm.abstract_cache(3, 20))]
    assert tm.cache_axes(3, 20) == jm.cache_axes(3, 20)
    rng = np.random.RandomState(0)
    filled = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(a.dtype), want)
    carried = from_jax_cache(filled, "cpu")
    assert jax.tree_util.tree_structure(to_numpy_tree(carried)) == \
        jax.tree_util.tree_structure(filled)
    for (_, a), b in zip(iter_leaves(to_numpy_tree(carried)),
                         jax.tree_util.tree_leaves(filled)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# forward, loss, gradients, AdamW
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_forward(arch: str, dtype: str):
    j, _ = _cfgs(arch, dtype)
    toks = _tokens(2, SEQ[arch], seed=2)
    return toks, _jax_logits(j, arch, toks)


def _jax_logits(j, arch: str, toks: np.ndarray) -> np.ndarray:
    """The reference's ``forward`` logits, jitted."""
    out = jax.jit(j_build_model(j).forward)(
        jax.tree_util.tree_map(jnp.asarray, _params(arch)),
        {"tokens": jnp.asarray(toks)})[0]
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    toks, want = _jax_forward(arch, dtype)
    _, t = _cfgs(arch, dtype)
    model = build_model(t)
    params = from_jax_params(_params(arch), "cpu")
    with torch.no_grad():
        got, aux = model.forward(params, {"tokens": torch.as_tensor(toks)})
        last = model.last_logits(params, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _close(last, got[:, -1], 1e-6)     # one row unembedded: another GEMM
    if dtype == "float32":
        _close(got, want)
    else:
        assert_bf16_close(_f(got), want, _jax_forward(arch, "float32")[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_adamw_step_match_reference(arch):
    """``loss_fn`` and its gradients against ``jax.grad`` of the
    reference's, then one AdamW train step."""
    j, t = _cfgs(arch, "float32")
    S = 24
    toks = _tokens(2, S + 1, seed=4)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:])}
    jm, tm = j_build_model(j), build_model(t)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    tp = from_jax_params(_params(arch), "cpu")
    jopt = JAdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    topt = AdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jst = jopt.init(jp)

    # the reference's train step: its gradients, then its optimizer's
    # update and apply_updates (each jitted once here)
    (jloss, jmet), jgrad = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, jb)

    def update(g, st, p):
        upd, _, met = jopt.update(g, st, p)
        return j_apply_updates(p, upd), met
    jp2, jopt_met = jax.jit(update)(jgrad, jst, jp)
    jmet = {**jmet, **jopt_met}
    tgrad, tmet = _value_and_grad(tm, tp, tb)
    _close(tmet["loss"], jloss)
    _assert_tree_close(tgrad, jgrad, rel=1e-4)
    tp2, _, tmet = make_train_step(tm, topt)(
        tp, from_jax_opt_state(jax.tree_util.tree_map(np.asarray, jst),
                               "cpu"), tb)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-4)
    # Adam's first step moves an entry by about ±lr whatever its gradient's
    # size, so entries with gradients below float32 noise may move either
    # way: each leaf is held by the norm of its difference
    # (tests/test_torch_train.py)
    for (_, a), b in zip(iter_leaves(to_numpy_tree(tp2)),
                         jax.tree_util.tree_leaves(jp2)):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
STEPS = 12


def _meta(cfg) -> int:
    return cfg.num_meta_tokens


@functools.lru_cache(maxsize=None)
def _jax_decode(arch: str, dtype: str, B: int = 2):
    """The reference's decode steps from a zero cache, eagerly: its logits
    at every step, its zero cache and its last cache, as numpy."""
    j, _ = _cfgs(arch, dtype)
    model = j_build_model(j)
    params = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    M = _meta(j)
    cache0 = model.init_cache(B, M + STEPS, dtype=dtype)
    cache, logits = cache0, []
    toks = _tokens(B, STEPS, seed=5)
    step = jax.jit(model.decode_step)
    for i in range(STEPS):
        lg, cache = step(params, cache, jnp.asarray(toks[:, i:i + 1]),
                         jnp.asarray(M + i + 1, jnp.int32))
        logits.append(np.asarray(lg[:, 0], np.float32))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return toks, np.stack(logits, 1), np_tree(cache0), np_tree(cache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, dtype):
    """The port's ``decode_step`` from the reference's zero cache (carried
    across) gives its logits at every step, returns the tree it was given,
    written in place, and that tree ends equal to the reference's
    returned one."""
    toks, want, cache0, want_cache = _jax_decode(arch, dtype)
    _, t = _cfgs(arch, dtype)
    model = build_model(t)
    params = from_jax_params(_params(arch), "cpu")
    cache = from_jax_cache(cache0, "cpu")
    leaves = [x for _, x in iter_leaves(cache)]
    got = []
    with torch.no_grad():
        for i in range(STEPS):
            lg, same = model.decode_step(params, cache,
                                         torch.as_tensor(toks[:, i:i + 1]),
                                         _meta(t) + i + 1)
            assert same is cache and lg.shape == (2, 1, t.padded_vocab)
            got.append(_f(lg[:, 0]))
    assert all(a is b for a, (_, b) in zip(leaves, iter_leaves(cache)))
    got = np.stack(got, 1)
    if dtype == "float32":
        _close(got, want)
        _assert_tree_close(cache, want_cache)
    else:
        assert_bf16_close(got, want, _jax_decode(arch, "float32")[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_against_forward_pinned(arch):
    """In float32, both packages: xLSTM's decode steps reproduce
    ``forward`` within 1e-5 of the largest logit; Hymba's do not (its
    decode never feeds the meta tokens, ROADMAP 3b), by as much as the
    reference's, and each side equals the reference's."""
    toks, dec, _, _ = _jax_decode(arch, "float32")
    j, t = _cfgs(arch, "float32")
    jfwd = _jax_logits(j, arch, toks)
    model = build_model(t)
    params = from_jax_params(_params(arch), "cpu")
    with torch.no_grad():
        fwd = _f(model.forward(params, {"tokens": torch.as_tensor(toks)})[0])
        cache = model.init_cache(2, _meta(t) + STEPS, dtype="float32",
                                 device="cpu")
        tdec = np.stack([_f(model.decode_step(
            params, cache, torch.as_tensor(toks[:, i:i + 1]),
            _meta(t) + i + 1)[0][:, 0]) for i in range(STEPS)], 1)
    _close(fwd, jfwd)
    _close(tdec, dec)
    gap, jgap = np.abs(tdec - fwd).max(), np.abs(dec - jfwd).max()
    if arch == "xlstm-125m":
        assert gap <= REL * np.abs(fwd).max() and \
            jgap <= REL * np.abs(jfwd).max(), (gap, jgap)
    else:
        assert gap > 0.1 * np.abs(fwd).max(), gap
        assert abs(gap - jgap) <= REL * np.abs(fwd).max(), (gap, jgap)


def test_decode_equals_forward_without_meta_tokens():
    """What Hymba's decode computes: ``forward`` with the meta tokens
    zeroed (zero rows stay zero through every layer: no biases, a zero
    conv bias, RMS norms of zero; their k, v and SSM state are zero, as
    decode's unfed meta slots), in both packages, float32, 1e-5 of the
    largest logit.  The window is widened to 64 so that the reference's
    decode/prefill window mismatch (ROADMAP 3b) stays out of it;
    ``chip_smoke.py`` phase l gates Hymba's decode on this identity."""
    arch = "hymba-1.5b"
    j, t = (dataclasses.replace(c, window_size=64)
            for c in _cfgs(arch, "float32"))
    p = dict(per_layer_fan_in(_jax_init(arch)))
    p["meta_tokens"] = np.zeros_like(p["meta_tokens"])
    M, S = t.num_meta_tokens, 20
    toks = _tokens(2, S, seed=9)
    jm = j_build_model(j)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jfwd = np.asarray(jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})[0])
    step, cache, jdec = jax.jit(jm.decode_step), \
        jm.init_cache(2, M + S, dtype="float32"), []
    for i in range(S):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, i:i + 1]),
                         jnp.asarray(M + i + 1, jnp.int32))
        jdec.append(np.asarray(lg))
    model, tp = build_model(t), from_jax_params(p, "cpu")
    with torch.no_grad():
        fwd = model.forward(tp, {"tokens": torch.as_tensor(toks)})[0]
        tc = model.init_cache(2, M + S, dtype="float32", device="cpu")
        dec = torch.cat([model.decode_step(tp, tc,
                                           torch.as_tensor(toks[:, i:i + 1]),
                                           M + i + 1)[0] for i in range(S)],
                        1)
    _close(fwd, jfwd)
    _close(dec, jfwd)
    _close(np.concatenate(jdec, 1), jfwd)


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_points_take_the_arch(arch):
    """``launch.serve.main`` and ``examples.serve_lm`` with ``--arch`` on
    the CPU print the reference's two lines over tokens of their shape."""
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    lines, gen = _stdout(serve.main, ["--arch", arch, "--device", "cpu",
                                      "--tokens", "6", "--prompt-len", "4"])
    assert gen.shape == (4, 6) and ((0 <= gen) & (gen < 256)).all()
    assert re.fullmatch(r"\[serve\] generated \(4, 6\) in [0-9.]+s "
                        r"\([0-9.]+ tok/s\)", lines[0])
    assert lines[1] == f"[serve] sample: {gen[0][:16].tolist()}"
    lines, gen = _stdout(serve_lm.main, ["--arch", arch, "--device", "cpu",
                                         "--tokens", "5"])
    assert gen.shape == (4, 5)
    assert lines[0].startswith(f"[serve] {arch}: generated 5 tokens × "
                               f"batch 4 in ")
    assert lines[1] == f"[serve] first sequence: {gen[0].tolist()}"


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_gives_the_reference_tokens(arch):
    """``launch.serve.greedy_decode`` with the weights carried across, in
    float32 (a float32 cache), gives the tokens of the reference's serve
    loop (``launch/serve.py``'s, meta offset included)."""
    from repro_torch.launch.serve import greedy_decode
    j, t = _cfgs(arch, "float32")
    B, P, G = 2, 5, 7
    M = _meta(t)
    prompt = _tokens(B, P, seed=8)
    jm = j_build_model(j)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    serve = jax.jit(j_make_serve_step(jm))
    cache = jm.init_cache(B, M + P + G + 8, dtype="float32")
    tok, want = jnp.asarray(prompt[:, :1]), []
    for i in range(P + G - 1):
        nxt, cache = serve(jp, cache, tok, jnp.asarray(M + i + 1, jnp.int32))
        if i + 1 < P:
            tok = jnp.asarray(prompt[:, i + 1:i + 2])
        else:
            tok = nxt[:, None]
            want.append(np.asarray(nxt))
    model = build_model(t)
    model.init_cache = functools.partial(model.init_cache, dtype="float32")
    got = greedy_decode(model, from_jax_params(_params(arch), "cpu"), prompt,
                        G, M + P + G + 8, M, "cpu")
    np.testing.assert_array_equal(got, np.stack(want, 1))
