"""Helpers of the tests that hold the port's model families against the JAX
package: the per-layer fan-in rescaling of a JAX parameter tree, routing
records of the two packages' MoE routers, and the bf16 gate.

Fan-in.  The reference's init takes a leaf's fan-in from ``shape[0]``:
after ``stack_layers`` that is the layer count, and for an unstacked expert
leaf (E, d, F) the expert count (ROADMAP 3b).  ``per_layer_fan_in``
rescales every stacked matrix to the fan-in of the matrix a layer (an
expert, for expert leaves) applies: ``shape[1]``, or ``shape[2]`` for the
(L, E, d_in, d_out) expert leaves; leaves with an init of their own keep it
(``OWN_INIT``: the router's std 0.02, Hymba's conv kernel and A_log).
Hymba's one-layer segments draw every other matrix at std 1 (ROADMAP 3b).

Routing.  Both routers compute their logits in the activation dtype.  In
bf16 the two packages' hidden states differ by an ulp or two (each rounds
after every op, in its own summation order), so where the k-th and (k+1)-th
experts of a token lie within that noise the two pick different experts,
and the token's output moves by O(1).  Such a flip is not a fault of either package: the
tests check that every flip is such a near-tie (the reference's own gap
between its k-th and (k+1)-th logit is within twice the largest difference
between the two packages' logits of that token) and compare outputs on the
positions no flip reaches.  In float32 the ids must be equal, call for call.

bf16 logits.  Through the MoE and MLA layers the reference's own bf16 logits
lie up to ~0.05 (of ~3.5) from its float32 ones, past a fixed 2e-2, and the
port's lie as far in another summation order.  ``assert_bf16_close`` holds
the port's bf16 values within ``BF16_RATIO`` times the reference's own bf16
distance from the reference's float32 values, of both the reference's bf16
and float32 values, as ``chip_smoke.py`` holds bf16 decode
(``check_teacher_forcing``).
"""
import contextlib
import io

import jax
import numpy as np
import torch

from repro_torch.models.convert import to_numpy_tree
from repro_torch.models.param import iter_leaves

BF16_RATIO = 2.0
REL = 1e-5             # float32: of the largest value compared
# stacked leaves with an init of their own, kept as drawn: the MoE router
# (std 0.02) and Hymba's conv kernel (std 0.1) and A_log (log 1..N)
OWN_INIT = ("router", "conv_w", "a_log")


def assert_bf16_close(got, want, want32, ok=None) -> None:
    """bf16 values ``got`` (float32 copies) against the reference's bf16
    ``want`` and float32 ``want32`` on the positions ``ok`` (a mask over
    the leading axes; all when None): both distances within BF16_RATIO
    times the reference's own bf16 distance from its float32 values."""
    if ok is None:
        ok = np.ones(want.shape[:1], bool)
    ref = np.abs(want - want32)[ok].max()
    assert 0 < ref < 0.1 * np.abs(want32).max(), ref
    assert np.abs(got - want32)[ok].max() <= BF16_RATIO * ref, \
        (np.abs(got - want32)[ok].max(), ref)
    assert np.abs(got - want)[ok].max() <= BF16_RATIO * ref, \
        (np.abs(got - want)[ok].max(), ref)


def per_layer_fan_in(tree):
    """A JAX parameter tree (numpy leaves) with every stacked matrix
    rescaled from the stacked axis' fan-in to its per-layer one (module
    docstring)."""
    def fix(path, a):
        keys = [k.key for k in path]
        if keys[0] != "stack" or a.ndim < 3 or keys[-1] in OWN_INIT:
            return a
        fan = a.shape[2] if "moe" in keys and a.ndim == 4 else a.shape[1]
        return (a * np.sqrt(a.shape[0] / fan)).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(fix, tree)


@contextlib.contextmanager
def recorded_routing(jmoe, tmoe):
    """Record every eager call of both packages' ``_router``: a dict
    ``{"jax": [...], "torch": [...]}`` of (ids (N, k), float32 logits
    (N, E)), one entry a call, in call order."""
    rec = {"jax": [], "torch": []}
    real_j, real_t = jmoe._router, tmoe._router

    def jax_router(params, x, cfg):
        out = real_j(params, x, cfg)
        logits = (x @ params["router"].astype(x.dtype)).astype("float32")
        rec["jax"].append((np.asarray(out[0]), np.asarray(logits)))
        return out

    def torch_router(params, x, cfg):
        out = real_t(params, x, cfg)
        logits = (x @ params["router"].to(x.dtype)).float()
        rec["torch"].append((out[0].detach().numpy(),
                             logits.detach().numpy()))
        return out

    jmoe._router, tmoe._router = jax_router, torch_router
    try:
        yield rec
    finally:
        jmoe._router, tmoe._router = real_j, real_t


def flipped_rows(rec, exact: bool = False):
    """For each router call, the rows (tokens) whose top-k expert set
    differs between the packages; every such row must be a near-tie (module
    docstring).  ``exact``: the ids must be equal, order included."""
    assert len(rec["jax"]) == len(rec["torch"]) > 0
    out = []
    for (ij, lj), (it, lt) in zip(rec["jax"], rec["torch"]):
        assert ij.shape == it.shape
        if exact:
            np.testing.assert_array_equal(it, ij)
            out.append(np.zeros(0, np.int64))
            continue
        k = ij.shape[1]
        rows = np.nonzero((np.sort(ij, 1) != np.sort(it, 1)).any(1))[0]
        top = np.sort(lj[rows], axis=1)[:, ::-1]
        gap = top[:, k - 1] - top[:, k]
        noise = np.abs(lj[rows] - lt[rows]).max(axis=1)
        assert (gap <= 2 * noise).all(), (rows, gap, noise)
        out.append(rows)
    return out


def reached_by_flips(flips, where, B: int, S: int) -> np.ndarray:
    """(B, S) bool: the positions at or after a flipped token in its own
    sequence (attention carries a token's output to the later ones).
    ``where(call, rows)`` gives the flipped rows' (b, s) arrays."""
    first = np.full(B, S)
    for call, rows in enumerate(flips):
        if len(rows):
            b, s = where(call, rows)
            np.minimum.at(first, b, s)
    return np.arange(S)[None, :] >= first[:, None]


def as_float32(x) -> np.ndarray:
    """A tensor (bf16 widened) or a JAX / numpy array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_rel_close(got, want, rel=REL, what=""):
    """Within ``rel`` of the largest finite |want|; infinities equal."""
    got, want = as_float32(got), as_float32(want)
    assert got.shape == want.shape, (got.shape, want.shape, what)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if fin.any():
        scale = np.abs(want[fin]).max()
        assert np.abs(got[fin] - want[fin]).max() <= rel * scale, \
            (what, np.abs(got[fin] - want[fin]).max(), scale)


def assert_tree_close(tree, jtree, rel=REL):
    """A port tree against a JAX one: paths, shapes and values."""
    flat = list(iter_leaves(to_numpy_tree(tree)))
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in flat] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jflat]
    for (path, a), (_, b) in zip(flat, jflat):
        assert_rel_close(a, b, rel, str(path))


def stdout_lines(fn, *args):
    """(the lines ``fn(*args)`` prints, its result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue().splitlines(), out
