"""The port's recurrent mixers (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the same numpy inputs, in float32:
mLSTM (sequential, chunkwise, step), sLSTM, the Mamba scan and step, the
causal convolution; states None and given, sequence lengths at a chunk
multiple and ragged, extreme gate pre-activations (i_pre ±20, f_pre -20 to
30).  Tolerance: 1e-5 of the largest value compared.

With extreme gates the chunkwise form is ill-conditioned where a row's
denominator |n·q| nearly cancels: the reference's own chunkwise output lies
up to ~3 (of ~900) from the float64 sequential form there, and its states
~1.2e-5 of their largest from it.  There each package is held to the
float64 sequential form instead: the port within twice the reference's own
distance, or 1e-5 of the largest value, whichever is larger.

Ragged lengths go through the padding each model uses: mLSTM blocks pad to
a 64-row chunk with i_pre -1e9 and f_pre 30 (``models/xlstm.py``), Hymba's
SSM pads the reference's scan with the identity (a 1, b 0) and the port
scans the last chunk unpadded (``models/hymba.py``); the state returned
must be the one after the last real row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    """Every pair of leaves within ``rel`` of the largest |want|."""
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else t,
        got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_array_equal(g[~fin], w[~fin])   # -inf stabilisers
        if fin.any():
            scale = max(np.abs(w[fin]).max(), 1e-30)
            assert np.abs(g[fin] - w[fin]).max() <= rel * scale, \
                (np.abs(g[fin] - w[fin]).max(), scale)


def _close_via_f64(got, want, exact, rel=REL):
    """``got`` no farther from the float64 ``exact`` than twice ``want``
    (the reference) is, or ``rel`` of the largest value (module
    docstring)."""
    leaves = [jax.tree_util.tree_leaves(t) for t in (got, want, exact)]
    for g, w, e in zip(*leaves):
        g = g.detach().double().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g, np.float64)
        w, e = np.asarray(w, np.float64), np.asarray(e, np.float64)
        fin = np.isfinite(e)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        ref = np.abs(w[fin] - e[fin]).max()
        bound = max(2 * ref, rel * np.abs(e[fin]).max())
        assert np.abs(g[fin] - e[fin]).max() <= bound, \
            (np.abs(g[fin] - e[fin]).max(), ref)


def _mlstm_f64(q, k, v, i_pre, f_pre, state=None):
    """The sequential mLSTM in float64 numpy: (h, (C, n, m))."""
    q, k, v, i_pre, f_pre = (np.asarray(a, np.float64)
                             for a in (q, k, v, i_pre, f_pre))
    B, S, H, D = q.shape
    if state is None:
        C, n = np.zeros((B, H, D, D)), np.zeros((B, H, D))
        m = np.full((B, H), -np.inf)
    else:
        C, n, m = (np.asarray(a, np.float64) for a in state)
    hs = []
    with np.errstate(over="ignore"):
        for t in range(S):
            kt = k[:, t] / np.sqrt(D)
            lf = -np.logaddexp(0.0, -f_pre[:, t])
            li = i_pre[:, t]
            m_new = np.maximum(lf + m, li)
            fp, ip = np.exp(lf + m - m_new), np.exp(li - m_new)
            C = fp[..., None, None] * C + ip[..., None, None] * \
                np.einsum("bhd,bhe->bhde", kt, v[:, t])
            n = fp[..., None] * n + ip[..., None] * kt
            num = np.einsum("bhde,bhd->bhe", C, q[:, t])
            den = np.abs(np.einsum("bhd,bhd->bh", n, q[:, t]))
            hs.append(num / np.maximum(den, np.exp(-m_new))[..., None])
            m = m_new
    return np.stack(hs, 1), (C, n, m)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _mlstm_inputs(S, extreme, seed=0, B=2, H=3, D=8):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    if extreme:
        i_pre = rng.choice([-20.0, 20.0], (B, S, H)).astype(np.float32)
        f_pre = rng.uniform(-20, 30, (B, S, H)).astype(np.float32)
    else:
        i_pre = rng.randn(B, S, H).astype(np.float32)
        f_pre = (2 + rng.randn(B, S, H)).astype(np.float32)
    return q, k, v, i_pre, f_pre


def _mlstm_state(seed=1, B=2, H=3, D=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, D, D).astype(np.float32),
            np.abs(rng.randn(B, H, D)).astype(np.float32),
            rng.randn(B, H).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("S", [1, 13])
def test_mlstm_sequential_matches_reference(S, extreme, with_state):
    x = _mlstm_inputs(S, extreme)
    st = _mlstm_state() if with_state else None
    want = jssm.mlstm_sequential(*_j(*x), _j(*st) if st else None)
    got = tssm.mlstm_sequential(*_t(*x), _t(*st) if st else None)
    _close(got, want)
    if S == 1:
        _close(tssm.mlstm_step(*_t(*x), _t(*st) if st else None), want)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("S", [64, 128])
def test_mlstm_chunkwise_matches_reference_and_sequential(S, extreme,
                                                          with_state):
    """At a chunk multiple; the port's chunkwise form also equals its own
    sequential one."""
    x = _mlstm_inputs(S, extreme, seed=S)
    st = _mlstm_state() if with_state else None
    want = jssm.mlstm_chunkwise(*_j(*x), _j(*st) if st else None)
    got = tssm.mlstm_chunkwise(*_t(*x), _t(*st) if st else None)
    if extreme:
        _close_via_f64(got, want, _mlstm_f64(*x, st))
        return
    _close(got, want)
    _close(got, tssm.mlstm_sequential(*_t(*x), _t(*st) if st else None),
           rel=1e-4)


@pytest.mark.parametrize("extreme", [False, True])
def test_mlstm_ragged_padding_keeps_the_state(extreme):
    """S 100 padded to 128 as the block pads (i_pre -1e9, f_pre 30): the
    port's outputs and state equal the reference's, and the state equals
    the sequential form's after the 100 real rows (the padding writes
    nothing and keeps the state); with extreme gates, through float64
    (module docstring)."""
    S, pad = 100, 28
    q, k, v, i_pre, f_pre = _mlstm_inputs(S, extreme, seed=7)
    z = ((0, 0), (0, pad), (0, 0), (0, 0))
    padded = (np.pad(q, z), np.pad(k, z), np.pad(v, z),
              np.pad(i_pre, z[:3], constant_values=-1e9),
              np.pad(f_pre, z[:3], constant_values=30.0))
    want_h, want_st = jssm.mlstm_chunkwise(*_j(*padded))
    got_h, got_st = tssm.mlstm_chunkwise(*_t(*padded))
    got, want = (got_h[:, :S], got_st), (np.asarray(want_h)[:, :S], want_st)
    if extreme:
        _close_via_f64(got, want, _mlstm_f64(q, k, v, i_pre, f_pre))
        return
    _close(got, want)
    _, seq_st = tssm.mlstm_sequential(*_t(q, k, v, i_pre, f_pre))
    _close(got_st, [s.numpy() for s in seq_st], rel=1e-4)


def _slstm_inputs(S, extreme, seed=0, B=2, H=3, Dh=4):
    rng = np.random.RandomState(seed)
    g = rng.randn(B, S, H, Dh, 4).astype(np.float32)
    if extreme:
        g[..., 1] = rng.choice([-20.0, 20.0], (B, S, H, Dh))
        g[..., 2] = rng.uniform(-20, 30, (B, S, H, Dh))
    r = {n: (0.3 * rng.randn(H, Dh, Dh)).astype(np.float32) for n in "zifo"}
    return g, r


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("S", [1, 37, 64])
def test_slstm_matches_reference(S, extreme, with_state):
    """S 64 takes the reference's chunked double scan, 37 and 1 its flat
    one; the port loops over steps either way."""
    g, r = _slstm_inputs(S, extreme, seed=S)
    st = None
    if with_state:
        rng = np.random.RandomState(2)
        st = tuple(rng.randn(2, 3, 4).astype(np.float32) for _ in range(4))
        st = (st[0], np.abs(st[1]) + 0.1, st[2], st[3])
    want = jssm.slstm_parallel(jnp.asarray(g),
                               {n: jnp.asarray(w) for n, w in r.items()},
                               _j(*st) if st else None)
    got = tssm.slstm_parallel(torch.from_numpy(g),
                              {n: torch.from_numpy(w) for n, w in r.items()},
                              _t(*st) if st else None)
    _close(got, want)
    if with_state:
        _close(tssm.slstm_step(torch.from_numpy(g), {
            n: torch.from_numpy(w) for n, w in r.items()}, _t(*st)), want)


def _mamba_inputs(S, seed=0, B=2, Di=6, N=4):
    rng = np.random.RandomState(seed)
    delta = np.log1p(np.exp(rng.randn(B, S, Di) - 2)).astype(np.float32)
    A = -np.exp(np.log(np.arange(1, N + 1, dtype=np.float32)))
    a = np.exp(delta[..., None] * A).astype(np.float32)
    b = (rng.randn(B, S, Di, N) * delta[..., None]).astype(np.float32)
    return a, b


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [256, 512])
def test_mamba_scan_matches_reference(S, with_state):
    a, b = _mamba_inputs(S, seed=S)
    h0 = np.random.RandomState(3).randn(2, 6, 4).astype(np.float32) \
        if with_state else None
    want = jssm.mamba_scan(jnp.asarray(a), jnp.asarray(b),
                           None if h0 is None else jnp.asarray(h0))
    got = tssm.mamba_scan(torch.from_numpy(a), torch.from_numpy(b),
                          None if h0 is None else torch.from_numpy(h0))
    _close(got, want)


def test_mamba_scan_ragged_chunk_matches_the_padded_reference():
    """260 rows: the reference pads to 512 with the identity (a 1, b 0) as
    ``hymba._mamba_path`` does; the port scans 256 rows, then the 4 left
    unpadded.  Rows and the last state agree; the doubling scan gives a
    row the same value whatever the chunk's length."""
    S = 260
    a, b = _mamba_inputs(S, seed=5)
    pad = ((0, 0), (0, 512 - S), (0, 0), (0, 0))
    want_h, want_last = jssm.mamba_scan(
        jnp.asarray(np.pad(a, pad, constant_values=1.0)),
        jnp.asarray(np.pad(b, pad)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    h1, last1 = tssm.mamba_scan(ta[:, :256], tb[:, :256])
    h2, last2 = tssm.mamba_scan(ta[:, 256:], tb[:, 256:], last1, chunk=4)
    _close((torch.cat([h1, h2], 1), last2),
           (np.asarray(want_h)[:, :S], want_last))
    assert torch.equal(h1[:, :100], tssm.mamba_scan(ta[:, :100],
                                                    tb[:, :100])[0])


def test_mamba_step_matches_reference():
    a, b = _mamba_inputs(1)
    h = np.random.RandomState(4).randn(2, 6, 4).astype(np.float32)
    want = jssm.mamba_step(jnp.asarray(a[:, 0]), jnp.asarray(b[:, 0]),
                           jnp.asarray(h))
    got = tssm.mamba_step(torch.from_numpy(a[:, 0]), torch.from_numpy(b[:, 0]),
                          torch.from_numpy(h))
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv1d_matches_reference(S, with_state, dtype):
    """Outputs and the new tail; in bf16 bit for bit (float32 sums of the
    same four products, one rounding)."""
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, 6).astype(np.float32)
    w = (0.1 * rng.randn(4, 6)).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    st = rng.randn(2, 3, 6).astype(np.float32) if with_state else None
    jd = jnp.dtype(dtype)
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jssm.causal_conv1d(jnp.asarray(x, jd), jnp.asarray(w),
                              jnp.asarray(bias),
                              None if st is None else jnp.asarray(st, jd))
    got = tssm.causal_conv1d(torch.from_numpy(x).to(td),
                             torch.from_numpy(w), torch.from_numpy(bias),
                             None if st is None else
                             torch.from_numpy(st).to(td))
    assert got[0].dtype == got[1].dtype == td
    if dtype == "float32":
        _close(got, want)
    else:
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w_, np.float32))
