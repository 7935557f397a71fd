"""The port's training path against the JAX package on the reduced
gemma3-1b: logits of carried-across weights, AdamW steps, gradient
accumulation, the token pipeline, and the fault-tolerant loop's
``FailureLog`` under the same ``FailurePlan``.

Conditioning of the reference init.  The JAX init takes a leaf's fan-in
from the stacked layer axis (``param.py:56`` reads ``shape[0]``), so in the
reduced model's one-layer segments every matrix has std 1 and layer-0
attention scores reach ~1e3: the softmax saturates and float32 gradients
of either package land ~1e-3 (relative to the leaf's largest entry) from
float64, the two packages' errors of the same size
(``test_gradients_at_reference_init_within_float32_conditioning``).  The
tests that follow AdamW steps therefore carry the same JAX weights across
rescaled to per-layer fan-in, where both packages agree to 1e-6; the
reference init itself is held in the logits tests and the conditioning
test."""
import dataclasses
import functools
import importlib.util
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.train.failure import FailurePlan as JPlan
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import run_training as j_run_training
from repro.train.optimizer import AdamW as JAdamW
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import all_configs
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import attention as t_attn
from repro_torch.models.convert import (from_jax_opt_state, from_jax_params,
                                        to_numpy_tree)
from repro_torch.models.param import iter_leaves, map_tree
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import segments
from repro_torch.train.failure import FailurePlan
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import _value_and_grad, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(dtype):
    j = dataclasses.replace(j_all_configs()["gemma3-1b"].reduced(),
                            dtype=dtype)
    t = dataclasses.replace(all_configs()["gemma3-1b"].reduced(),
                            dtype=dtype)
    return j, t


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX init of the reduced model (PRNGKey(0)) as numpy; it does not
    depend on the activation dtype."""
    j, _ = _cfgs("float32")
    return jax.tree_util.tree_map(np.asarray,
                                  j_build_model(j).init(jax.random.PRNGKey(0)))


def _jax_params(cfg, per_layer_fan_in=False):
    """The JAX init as numpy; optionally every stacked matrix rescaled from
    the stacked-axis fan-in to its per-layer fan-in (module docstring)."""
    p = _jax_init()
    if not per_layer_fan_in:
        return p

    def fix(path, a):
        if "stack" in jax.tree_util.keystr(path) and a.ndim >= 3:
            return (a * np.sqrt(a.shape[0] / a.shape[1])).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fix, p)


def _batch(B=4, S=32, seed=0):
    toks = np.random.RandomState(seed).randint(0, 256, (B, S + 1)).astype(
        np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "targets": torch.as_tensor(toks[:, 1:])})


def _leaves(tree):
    """A port tree's leaves as float64 numpy, in JAX's flattening order."""
    return [np.asarray(t, np.float64) for _, t in iter_leaves(
        to_numpy_tree(tree))]


def _jleaves(tree):
    return [np.asarray(t, np.float64)
            for t in jax.tree_util.tree_leaves(tree)]



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The shapes here are tiny: torch's default of a thread per core only
    spins against JAX's pool and the other test workers (a 10x slowdown)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
def test_reduced_config_and_segments_match_reference():
    j, t = _cfgs("bfloat16")
    assert dataclasses.asdict(t) == {k: v for k, v in
                                     dataclasses.asdict(j).items()}
    from repro.models.transformer import segments as j_segments
    assert segments(t) == j_segments(j)
    full = all_configs()["gemma3-1b"]
    assert segments(full) == j_segments(j_all_configs()["gemma3-1b"])
    assert build_model(full).param_count() == 999_812_736


def test_param_tree_matches_reference_layout():
    j, t = _cfgs("float32")
    jp = _jax_params(j)
    tp = build_model(t).init(0, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = list(iter_leaves(tp))
    assert [tuple(k.key for k in path) for path, _ in jflat] == \
        [path for path, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
    # the port's own init is seeded: same seed, same draw
    again = build_model(t).init(0, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(iter_leaves(tp), iter_leaves(again)))


@pytest.mark.parametrize("init", ["per_layer_fan_in", "reference"])
def test_logits_match_jax_float32(init):
    """float32 logits within rtol 1e-4, atol 1e-5 at a well-conditioned
    init.  At the reference init (module docstring) the saturated layer-0
    softmax puts the reference itself 9e-5 from float64, so there the port
    is held to that: at least as near float64 as the reference, and within
    twice the reference's error of it."""
    j, t = _cfgs("float32")
    jp = _jax_params(j, per_layer_fan_in=init == "per_layer_fan_in")
    jb, tb = _batch()
    want, _ = j_build_model(j).forward(jax.tree_util.tree_map(jnp.asarray,
                                                              jp), jb)
    got, _ = build_model(t).forward(from_jax_params(jp, "cpu"), tb)
    want, got = np.asarray(want, np.float64), got.detach().double().numpy()
    if init == "per_layer_fan_in":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        return
    t64 = dataclasses.replace(t, dtype="float64")
    exact, _ = build_model(t64).forward(
        map_tree(lambda x: x.double(), from_jax_params(jp, "cpu")), tb)
    exact = exact.detach().numpy()
    ref_err = np.abs(want - exact).max()
    assert np.abs(got - exact).max() <= ref_err
    assert np.abs(got - want).max() <= 2 * ref_err


def test_logits_match_jax_bfloat16():
    """bf16 activations: GELU and the embedding scale round where the
    reference rounds, so logits agree within 2e-2 (one bf16 ulp at 2-4)."""
    j, t = _cfgs("bfloat16")
    jp = _jax_params(j)
    jb, tb = _batch()
    want, _ = j_build_model(j).forward(jax.tree_util.tree_map(jnp.asarray,
                                                              jp), jb)
    got, _ = build_model(t).forward(from_jax_params(jp, "cpu"), tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2e-2)


@pytest.mark.parametrize("variant,S,window", [
    ("windowed_attention", 40, 8), ("windowed_attention", 37, 8),
    ("windowed_attention_parallel", 40, 8),
    ("windowed_attention_parallel", 64, 16),
    ("online_softmax_attention", 40, 0),
    ("online_softmax_attention", 1100, 0)])
def test_attention_matches_each_reference_variant(variant, S, window):
    """The port's one masked softmax against the reference's blocked forms
    (small q/kv blocks so several blocks and a ragged edge are covered);
    each query sees ``window + 1`` keys."""
    rng = np.random.RandomState(S + window)
    q, k, v = (rng.randn(2, S, 4, 16).astype(np.float32) for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if variant == "windowed_attention":
        want = j_attn.windowed_attention(jq, jk, jv, window=window,
                                         scale=0.25, block_q=16)
    elif variant == "windowed_attention_parallel":
        want = j_attn.windowed_attention_parallel(jq, jk, jv, window=window,
                                                  scale=0.25, block_q=16)
    else:
        want = j_attn.online_softmax_attention(jq, jk, jv, causal=True,
                                               q_offset=0, scale=0.25,
                                               block_kv=16)
    got = t_attn.masked_attention(*map(torch.as_tensor, (q, k, v)),
                                  window=window, scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gradients_at_reference_init_within_float32_conditioning():
    """At the reference init the port's float32 gradients lie within twice
    the reference's own distance from float64 (the port in float64) of
    both the reference's and the float64 ones, leaf by leaf."""
    j, t = _cfgs("float32")
    jp = _jax_params(j)
    jb, tb = _batch()
    jm = j_build_model(j)
    jg = jax.jit(jax.grad(lambda p: jm.loss_fn(p, jb)[0]))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    tg, _ = _value_and_grad(build_model(t), from_jax_params(jp, "cpu"), tb)
    t64 = dataclasses.replace(t, dtype="float64")
    g64, _ = _value_and_grad(build_model(t64), map_tree(
        lambda x: x.double(), from_jax_params(jp, "cpu")), tb)
    for a, b, c in zip(_jleaves(jg), _leaves(tg), _leaves(g64)):
        ref_err = np.abs(a - c).max()
        assert np.abs(b - a).max() <= 2 * ref_err + 1e-6 * np.abs(c).max()
        assert np.abs(b - c).max() <= 2 * ref_err + 1e-6 * np.abs(c).max()


@functools.lru_cache(maxsize=None)
def _steps(microbatches_j=1, microbatches_t=1, n=3):
    j, t = _cfgs("float32")
    jp = _jax_params(j, per_layer_fan_in=True)
    jb, tb = _batch()
    jopt = JAdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    topt = AdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    js = jax.jit(j_make_train_step(j_build_model(j), jopt,
                                   microbatches=microbatches_j))
    ts = make_train_step(build_model(t), topt, microbatches=microbatches_t)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jst = jopt.init(jparams)
    tparams = from_jax_params(jp, "cpu")
    tst = from_jax_opt_state(jax.tree_util.tree_map(np.asarray, jst),
                             "cpu")
    out = []
    for _ in range(n):
        jparams, jst, jm = js(jparams, jst, jb)
        before = [x.clone() for _, x in iter_leaves(tparams)]
        tparams2, tst2, tm = ts(tparams, tst, tb)
        # the step is pure: what it was given is unchanged
        assert all(torch.equal(a, b) for a, (_, b) in
                   zip(before, iter_leaves(tparams)))
        tparams, tst = tparams2, tst2
        out.append((jm, tm, jparams, tparams, jst, tst))
    return out


def _rel_norm(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


def test_three_adamw_steps_match_jax_float32():
    """Loss and grad norm within 1e-4 relative at every step; parameters
    within 1e-4 relative (norm of the difference over the norm, per leaf)
    after each of three steps.  Elementwise, Adam's first steps move a
    parameter by about ±lr whatever its gradient's size, so an entry whose
    gradient is below float32 noise may move either way.  The moments are
    running averages of the gradients themselves, whose float32 agreement
    on the leaves with the smallest gradients is ~4e-4: held at 1e-3."""
    for jm, tm, jp, tp, jst, tst in _steps(1, 1, 3):
        for key in ("loss", "grad_norm", "ce", "z_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4)
        for a, b in zip(_jleaves(jp), _leaves(tp)):
            assert _rel_norm(a, b) < 1e-4
        for tree_j, tree_t in ((jst.mu, tst.mu), (jst.nu, tst.nu)):
            for a, b in zip(_jleaves(tree_j), _leaves(tree_t)):
                assert _rel_norm(a, b) < 1e-3
        assert int(tst.step) == int(jst.step)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)


def test_microbatches_match_full_batch_and_reference():
    """Two microbatches of 2 against the full batch of 4 (the port) and
    against the reference's accumulation (same tolerances as above)."""
    full = _steps(1, 1, 3)[0]
    mb = _steps(2, 2, 1)[0]
    jm, tm, jp, tp, _, _ = mb
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(full[1]["grad_norm"]), rtol=1e-4)
    for a, b, c in zip(_jleaves(jp), _leaves(tp), _leaves(full[3])):
        assert _rel_norm(a, b) < 1e-4
        assert _rel_norm(c, b) < 1e-4


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_token_pipeline_bit_identical_and_replayable():
    j, t = _cfgs("bfloat16")
    jp, tp = JPipeline(j, 4, 16, seed=3), TokenPipeline(t, 4, 16, seed=3)
    for _ in range(5):
        a, b = jp.next_batch(), tp.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    cursor = tp.cursor()
    assert cursor == jp.cursor()
    after = tp.next_batch()
    tp2 = TokenPipeline(t, 4, 16, seed=3)
    tp2.restore_cursor(cursor)
    np.testing.assert_array_equal(tp2.next_batch()["tokens"],
                                  after["tokens"])


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both_loops(plan, steps, ckpt_every, jax_policy=None, policy=None):
    """Both packages' loops under one plan (float32 activations: the log
    does not depend on them, and the port's CPU bf16 matmuls are slow)."""
    j, t = _cfgs("float32")
    with tempfile.TemporaryDirectory() as d:
        jres = j_run_training(j_build_model(j), j, 4, 32,
                              JLoopConfig(steps=steps, ckpt_every=ckpt_every,
                                          ckpt_dir=d,
                                          layout_policy=jax_policy),
                              failure_plan=JPlan(dict(plan)))
    tres = run_training(build_model(t), t, 4, 32,
                        LoopConfig(steps=steps, ckpt_every=ckpt_every,
                                   layout_policy=policy),
                        failure_plan=FailurePlan(dict(plan)), device="cpu")
    return jres, tres


def test_run_training_failure_log_matches_jax_loop():
    """test_train_substrate.py's plan: a straggler redo, two crashes
    restored from checkpoints, a corruption that hits an older checkpoint's
    chunk (so nothing falls back)."""
    plan = {4: "straggler", 7: "crash", 11: "corrupt_ckpt", 13: "crash"}
    jres, tres = _both_loops(plan, 15, 3)
    assert dataclasses.asdict(tres.failure_log) == \
        dataclasses.asdict(jres.failure_log)
    assert tres.final_step == jres.final_step == 15
    assert len(tres.losses) == len(jres.losses)
    assert all(np.isfinite(tres.losses))
    params, opt_state, cursor = tres.state
    assert int(opt_state.step) == 15   # 12 restored at step 13, then 3
    assert cursor.tolist() == [0, 15]


def test_chip_plan_failure_log_pinned_to_jax_loop():
    """The plan chip_smoke.py runs at full width: its pinned FailureLog and
    final step are what the JAX loop gives under the same plan and policy
    (a straggler redo, a corruption the checksum rejects with a fallback to
    a cold start, a crash restored from a verified checkpoint)."""
    cs = _chip_smoke()
    jpol = JPolicy_from(cs.SCOPES, cs.N_NODES, cs.DEFAULT_MODE)
    tpol = LayoutPolicy.from_scopes(cs.SCOPES, n_nodes=cs.N_NODES,
                                    default=cs.DEFAULT_MODE)
    assert tpol.mode_for_path("/bb/ckpt/2/x") == LayoutMode.HYBRID
    jres, tres = _both_loops(cs.TRAIN_PLAN, cs.TRAIN_STEPS, cs.CKPT_EVERY,
                             jpol, tpol)
    assert dataclasses.asdict(tres.failure_log) == \
        dataclasses.asdict(jres.failure_log)
    assert tres.final_step == jres.final_step
    got = dataclasses.asdict(jres.failure_log)
    assert got == cs.TRAIN_EXPECTED["failure_log"]
    assert jres.final_step == cs.TRAIN_EXPECTED["final_step"]
    assert got["fallback_restores"] >= 1 and got["restores"] >= 1 and \
        got["stragglers"] >= 1


def JPolicy_from(scopes, n_nodes, default):
    from repro.core.policy import LayoutPolicy as JPolicy
    return JPolicy.from_scopes(scopes, n_nodes=n_nodes, default=default)


def test_run_training_refuses_adaptation_until_ported():
    """Adaptation is ported: the loop takes a controller and ticks it
    every ``adapt_every`` steps only (0 never ticks it, as in the
    reference); tests/test_torch_adapt.py holds the ticks' effect."""
    _, t = _cfgs("bfloat16")

    class Ticks:
        client = None

        def __init__(self):
            self.steps = []

        def tick(self):
            self.steps.append(len(self.steps))
            return type("R", (), {"phase": "idle"})()

    never, every = Ticks(), Ticks()
    for ctl, adapt_every in ((never, 0), (every, 1)):
        res = run_training(build_model(t), t, 4, 16,
                           LoopConfig(steps=2, adapt_controller=ctl,
                                      adapt_every=adapt_every),
                           device="cpu")
        assert res.final_step == 2
    assert never.steps == [] and every.steps == [0, 1]


def test_other_families_raise_not_implemented():
    cfg = dataclasses.replace(all_configs()["gemma3-1b"], family="ssm")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)


def test_entry_points_default_to_the_card(tmp_path):
    """With no device given, the model init, the converters, the manager
    and the loop put their tensors on the CUDA card, and raise without
    one rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would succeed")
    from repro_torch.checkpoint.manager import CheckpointManager
    _, t = _cfgs("float32")
    calls = [lambda: build_model(t).init(0),
             lambda: from_jax_params({"w": np.zeros(2, np.float32)}),
             lambda: CheckpointManager(str(tmp_path),
                                       LayoutPolicy.uniform(1, 8)),
             lambda: run_training(build_model(t), t, 4, 16,
                                  LoopConfig(steps=1))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
