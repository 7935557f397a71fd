"""The port's flash attention against the JAX package: its plain version (the
CPU path of ``repro_torch.kernels.flash_attention.flash_attention``) against
the Pallas kernel in interpret mode over the reference's own sweep, against
the JAX model's ``online_softmax_attention`` (what the reference's global
layers compute), and against the port's own global-layer attention.  The
kernel itself is held against the plain version on the card in
test_torch_cuda.py.

Tolerances are the reference's (tests/test_kernels.py): 2e-5 in float32,
where both sides compute in float32 and differ only in summation order, and
2e-2 in bf16, where both round the float32 result once to bf16 (one bf16
ulp is 2^-8 relative)."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models.attention import online_softmax_attention
from repro_torch.configs import all_configs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, flash_attention_bhsd, tma_geometry, tma_problem)
from repro_torch.kernels.flash_attention.ops import (attention_bshd,
                                                     padded_head_dim)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref)
from repro_torch.models import layers as nnl
from repro_torch.models.attention import masked_attention, project_qkv
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import segments

RNG = np.random.RandomState(7)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The shapes here are small: torch's default of a thread per core only
    spins against JAX's pool and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(shape, dtype):
    """The same q/k/v for both packages, made with numpy from the seed."""
    jdt, tdt, tol = DTYPES[dtype]
    arrs = [RNG.randn(*shape).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.as_tensor(a).to(tdt) for a in arrs], tol)


def _close(got: torch.Tensor, ref, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,H,D", [(2, 128, 2, 64), (1, 256, 4, 64),
                                     (2, 96, 3, 80), (1, 512, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_kernel(B, S, H, D, dtype,
                                                     causal):
    """The sweep of tests/test_kernels.py: the Pallas kernel in interpret
    mode with 64-row blocks, as the reference's test runs it."""
    (jq, jk, jv), (tq, tk, tv), tol = _qkv((B, S, H, D), dtype)
    ref = j_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, S, H, D)
    _close(got, ref, tol)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference_oracle(causal):
    """The (BH, S, D) plain version against the reference's jnp oracle,
    with an explicit scale."""
    (jq, jk, jv), (tq, tk, tv), tol = _qkv((3, 80, 64), "float32")
    ref = j_attention_ref(jq, jk, jv, scale=0.3, causal=causal)
    _close(attention_ref(tq, tk, tv, scale=0.3, causal=causal), ref, tol)


@pytest.mark.parametrize("B,S,H,D", [(2, 200, 2, 64), (1, 700, 2, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_global_layer_attention(B, S, H, D,
                                                            dtype):
    """What the JAX model's global layers compute
    (``online_softmax_attention(causal=True, q_offset=0)``, 512-key
    blocks, so S = 700 crosses a block)."""
    (jq, jk, jv), (tq, tk, tv), tol = _qkv((B, S, H, D), dtype)
    ref = online_softmax_attention(jq, jk, jv, causal=True, q_offset=0,
                                   scale=1.0 / math.sqrt(D))
    _close(flash_attention(tq, tk, tv, causal=True), ref, tol)


def test_flash_attention_scale_argument_matches_reference():
    (jq, jk, jv), (tq, tk, tv), tol = _qkv((1, 64, 2, 64), "float32")
    ref = j_flash(jq, jk, jv, causal=True, scale=0.05, block_q=64,
                  block_k=64)
    _close(flash_attention(tq, tk, tv, causal=True, scale=0.05), ref, tol)


def test_flash_attention_equals_the_ports_global_layer_attention():
    """On the reduced gemma3-1b, q/k/v from a global layer's projections and
    RoPE (``project_qkv``): the entry point equals the model's own
    ``masked_attention(window=0)`` in float32."""
    cfg = dataclasses.replace(all_configs()["gemma3-1b"].reduced(),
                              dtype="float32")
    params = build_model(cfg).init(3, device="cpu")
    i = next(i for i, (kind, _) in enumerate(segments(cfg))
             if kind == "global")
    seg = params["stack"][f"seg{i}_global"]
    attn_p = {k: v[0] for k, v in seg["attn"].items()}
    S = 96
    x = torch.as_tensor(RNG.randn(2, S, cfg.d_model).astype(np.float32))
    x = nnl.rms_norm(x, seg["ln_attn"][0], cfg.norm_eps, zero_centered=True)
    pos = torch.arange(S, dtype=torch.int32)[None, :]
    q, k, v = project_qkv(attn_p, x, pos, cfg)
    assert q.shape == k.shape == v.shape == (2, S, cfg.num_heads,
                                             cfg.head_dim)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    want = masked_attention(q, k, v, window=0, scale=scale)
    got = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


# --- what the entry point does around the kernel on CUDA, with the plain
# version in the kernel's place --------------------------------------------

def _plain_bhsd(q, k, v, *, scale, causal):
    """The plain version over (B, H, S, D) views, where the CUDA path puts
    ``flash_attention_bhsd``."""
    B, H, S, D = q.shape
    o = attention_ref(*(x.reshape(B * H, S, D) for x in (q, k, v)),
                      scale=scale, causal=causal)
    return o.reshape(B, H, S, D)


@pytest.mark.parametrize("D", [16, 32, 96, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_head_dim_matches_reference_pallas(D, causal):
    """Head dims without an instance (xlstm's and MLA's 192, the reduced
    configs' 16) are zero-padded to the next one and cut back, with the
    scale of the true D: the reference's Pallas kernel (interpret mode),
    which pads to 128 lanes, within 2e-5 in float32."""
    (jq, jk, jv), (tq, tk, tv), tol = _qkv((2, 96, 2, D), "float32")
    assert padded_head_dim(D) == {16: 64, 32: 64, 96: 128, 192: 256}[D]
    ref = j_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                  interpret=True)
    got = attention_bshd(tq, tk, tv, scale=D ** -0.5, causal=causal,
                         kernel=_plain_bhsd)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 96, 2, D)
    assert got.is_contiguous()
    _close(got, ref, tol)


def test_float16_goes_through_float32_and_rounds_once():
    """float16 runs in float32 and is rounded once to float16, as the
    reference's body casts to float32: within 2e-3 (one float16 ulp of a
    value below 2 is at most 2^-10 ≈ 9.8e-4, plus float32 summation)."""
    arrs = [RNG.randn(2, 80, 2, 64).astype(np.float16) for _ in range(3)]
    ref = j_flash(*(jnp.asarray(a) for a in arrs), causal=True, block_q=64,
                  block_k=64, interpret=True)
    got = attention_bshd(*(torch.as_tensor(a) for a in arrs),
                         scale=64 ** -0.5, causal=True, kernel=_plain_bhsd)
    assert got.dtype == torch.float16
    _close(got, ref, 2e-3)


@pytest.mark.parametrize("D", [320, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_head_dims_match_reference_pallas(D, dtype, causal):
    """Head dims above 256, which the reference pads to a multiple of 128
    and attends at: the entry point pads to the wide kernel's multiple of
    128 and computes in float32, also for bf16 (rounded once at the end,
    as the reference's body casts to float32).  Against the Pallas kernel
    in interpret mode: 2e-5 in float32, 2e-2 in bf16 (one rounding of a
    float32 result to bf16 on each side)."""
    (jq, jk, jv), (tq, tk, tv), tol = _qkv((1, 80, 2, D), dtype)
    seen = []

    def kernel(q, k, v, *, scale, causal):
        seen.append((q.dtype, q.shape[-1]))
        return _plain_bhsd(q, k, v, scale=scale, causal=causal)

    ref = j_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                  interpret=True)
    got = attention_bshd(tq, tk, tv, scale=D ** -0.5, causal=causal,
                         kernel=kernel)
    assert seen == [(torch.float32, -(-D // 128) * 128)]
    assert got.dtype == tq.dtype and tuple(got.shape) == (1, 80, 2, D)
    _close(got, ref, tol)


def test_wide_head_dim_pad_and_cut_keep_the_callers_scale():
    """D = 320 is padded to 384 with zero columns and cut back; the scale
    is the caller's, not 1/sqrt(384): equal to the reference at that
    scale, and far from it at 1/sqrt(384)."""
    assert [padded_head_dim(d) for d in (257, 320, 384, 512, 513)] == [
        384, 384, 384, 512, 640]
    (jq, jk, jv), (tq, tk, tv), tol = _qkv((2, 64, 1, 320), "float32")
    ref = j_flash(jq, jk, jv, causal=True, scale=0.2, block_q=64,
                  block_k=64, interpret=True)
    got = attention_bshd(tq, tk, tv, scale=0.2, causal=True,
                         kernel=_plain_bhsd)
    _close(got, ref, tol)
    _close(got, flash_attention_ref(tq, tk, tv, scale=0.2, causal=True),
           tol)
    other = flash_attention_ref(tq, tk, tv, scale=384 ** -0.5, causal=True)
    assert float((got - other).abs().max()) > 1e-2


@pytest.mark.parametrize("case", ["misaligned", "strided", "head_dim"])
def test_views_the_kernel_cannot_read_are_copied(case):
    """A bf16 view TMA cannot read, or a float32 view whose head dim is not
    contiguous, reaches the kernel as a copy it can read; the result is
    the plain version's on the view itself."""
    dtype = torch.float32 if case == "head_dim" else torch.bfloat16
    if case == "misaligned":
        x = torch.as_tensor(RNG.randn(2 * 96 * 3 * 64 + 1).astype(
            np.float32)).to(dtype)[1:].view(2, 96, 3, 64)
    elif case == "strided":
        x = torch.as_tensor(RNG.randn(2, 96, 3, 68).astype(np.float32)).to(
            dtype)[..., :64]
    else:
        x = torch.as_tensor(RNG.randn(2, 96, 3, 128).astype(np.float32))[
            ..., ::2]
    assert (tma_problem(x.transpose(1, 2)) if dtype == torch.bfloat16
            else x.stride(3) != 1)
    seen = []

    def kernel(q, k, v, *, scale, causal):
        for t in (q, k, v):
            assert (tma_problem(t) is None if t.dtype == torch.bfloat16
                    else t.stride(3) == 1)
        seen.append(q.dtype)
        return _plain_bhsd(q, k, v, scale=scale, causal=causal)

    y = torch.as_tensor(RNG.randn(2, 96, 3, 64).astype(np.float32)).to(dtype)
    got = attention_bshd(x, y, y, scale=0.125, causal=True, kernel=kernel)
    assert seen == [dtype]
    want = flash_attention_ref(x, y, y, scale=0.125, causal=True)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_entry_point_accepts_the_reference_keywords(causal):
    """``block_q``, ``block_k`` and ``interpret`` are the TPU kernel's:
    accepted and ignored."""
    _, (tq, tk, tv), _ = _qkv((1, 70, 2, 64), "float32")
    want = flash_attention(tq, tk, tv, causal=causal)
    got = flash_attention(tq, tk, tv, causal=causal, block_q=128,
                          block_k=64, interpret=True)
    assert torch.equal(got, want)


# --- the float32 kernel's arithmetic: 3xTF32, modelled in torch -----------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10 significand
    bits kept, to nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(a, b, passes):
    """a @ b on TF32 operands, float32 sums: one pass (hi·hi), or the
    kernel's three (hi·lo + lo·hi + hi·hi, lo = tf32(x − hi))."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def _tf32_attention(q, k, v, scale, passes, bk=32):
    """(S, D) causal attention as the kernel runs it: 32-key tiles, the
    online softmax in float32, both products through ``_tf32_product``."""
    S = q.shape[0]
    m = torch.full((S, 1), -1e30)
    l = torch.zeros(S, 1)
    acc = torch.zeros(S, q.shape[1])
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        s = _tf32_product(q, k[k0:k0 + bk].T, passes) * scale
        cols = torch.arange(k0, min(k0 + bk, S))[None, :]
        s = torch.where(cols <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.max(1, keepdim=True).values)
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(1, keepdim=True)
        acc = acc * corr + _tf32_product(p, v[k0:k0 + bk], passes)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


@pytest.mark.parametrize("S,D", [(128, 64), (256, 256)])
def test_3xtf32_holds_float32_accuracy_where_one_pass_does_not(S, D):
    """Against float64 on unit-normal q/k/v: three TF32 passes stay within
    the float32 tolerance 2e-5 (about 1e-6), one pass does not (about
    1e-3), so the check tells the two apart."""
    q, k, v = (torch.as_tensor(RNG.randn(S, D).astype(np.float32))
               for _ in range(3))
    s = (q.double() @ k.double().T) * D ** -0.5
    s = s.masked_fill(~torch.ones_like(s, dtype=torch.bool).tril(),
                      float("-inf"))
    exact = torch.softmax(s, -1) @ v.double()
    err = {p: float((_tf32_attention(q, k, v, D ** -0.5, p).double() -
                     exact).abs().max()) for p in (1, 3)}
    assert err[3] < 2e-5 < err[1], err


def test_flash_attention_kernel_wrapper_rejects_cpu_tensors():
    """The plain version is chosen by the entry point for CPU tensors,
    never by the kernel's wrapper."""
    x = torch.zeros((1, 2, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bhsd(x, x, x, scale=0.125)


def test_flash_attention_entry_point_rejects_bad_input():
    x = torch.zeros((1, 64, 2, 64))
    with pytest.raises(ValueError, match="shape"):
        flash_attention(x, x[:, :32], x)
    m = torch.zeros((1, 64, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(m, m, m)


# --- the bf16 kernel's TMA tensor maps, computed on the host --------------

def _tma_box(t: torch.Tensor, geo, coords):
    """What one TMA load of ``geo``'s box at ``coords`` (innermost first)
    copies, emulated from the tensor's storage and the geometry alone:
    elements past a dim's extent read as zero."""
    es = t.element_size()
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    base = t.storage_offset() * es
    st = (es,) + tuple(geo.strides)
    out = torch.zeros(geo.box[1], geo.box[0], dtype=t.dtype)
    c0, c1, c2, c3 = coords
    for r in range(geo.box[1]):
        for c in range(geo.box[0]):
            idx = (c0 + c, c1 + r, c2, c3)
            if all(i < n for i, n in zip(idx, geo.dims)):
                off = base + sum(i * s for i, s in zip(idx, st))
                assert off % es == 0
                out[r, c] = flat[off // es]
    return out


def _tile(t, geo, coords):
    """The same box read through torch indexing of the (B, H, S, D) view."""
    c0, c1, c2, c3 = coords
    want = torch.zeros(geo.box[1], geo.box[0], dtype=t.dtype)
    part = t[c3, c2, c1:c1 + geo.box[1], c0:c0 + geo.box[0]]
    want[:part.shape[0], :part.shape[1]] = part
    return want


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 63, 65, 1000])
def test_tma_geometry_of_transposed_view(D, S):
    """(B, S, H, D) → (B, H, S, D) views, as ``ops.flash_attention`` passes
    them: dims (D, S, H, B), byte strides (H·D, D, S·H·D) × 2, boxes of 64
    rows × 64 columns under the 128-byte swizzle, or × 16 under the 32-byte
    one at D = 80; and every box the kernel loads reads the view's own
    elements, zeros past S."""
    B, H = 2, 3
    x = torch.as_tensor(RNG.randn(B, S, H, D).astype(np.float32)).to(
        torch.bfloat16)
    t = x.transpose(1, 2)
    geo = tma_geometry(t)
    swizzle = 128 if D % 64 == 0 else 32
    assert geo.dims == (D, S, H, B)
    assert geo.strides == (H * D * 2, D * 2, S * H * D * 2)
    assert geo.box == (swizzle // 2, 64, 1, 1) and geo.swizzle == swizzle
    assert all(st % 16 == 0 for st in geo.strides)
    last_row = (S - 1) // 64 * 64
    for coords in ((0, 0, 0, 0), (D - geo.box[0], last_row, H - 1, B - 1),
                   (geo.box[0] * (D // geo.box[0] // 2), last_row, 1, 0)):
        assert torch.equal(_tma_box(x, geo, coords), _tile(t, geo, coords))


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_tma_geometry_of_contiguous_bhsd_tensor(D):
    B, H, S = 2, 3, 96
    t = torch.as_tensor(RNG.randn(B, H, S, D).astype(np.float32)).to(
        torch.bfloat16)
    geo = tma_geometry(t)
    assert geo.dims == (D, S, H, B)
    assert geo.strides == (D * 2, S * D * 2, H * S * D * 2)
    coords = (0, 64, 2, 1)
    assert torch.equal(_tma_box(t, geo, coords), _tile(t, geo, coords))


def test_tma_geometry_gives_size_one_dims_a_legal_stride():
    """A dim of size 1 is never stepped, whatever stride the view reports;
    the map still gets a multiple of 16 bytes no smaller than a row."""
    x = torch.zeros((1, 5, 1, 80), dtype=torch.bfloat16)
    t = x.transpose(1, 2)
    geo = tma_geometry(t)
    assert geo.dims == (80, 5, 1, 1)
    assert geo.strides[0] == 160
    assert all(st % 16 == 0 and st >= 160 for st in geo.strides)


@pytest.mark.parametrize("case", ["base", "stride", "head_dim", "rank"])
def test_tma_geometry_rejects_views_tma_cannot_read(case):
    if case == "base":          # one element past a 16-byte boundary
        t = torch.zeros(2 * 96 * 3 * 64 + 1, dtype=torch.bfloat16)[1:]
        t, match = t.view(2, 96, 3, 64).transpose(1, 2), "aligned base"
    elif case == "stride":      # rows of 68 elements: 136-byte strides
        t = torch.zeros((2, 96, 3, 68), dtype=torch.bfloat16)[..., :64]
        t, match = t.transpose(1, 2), "multiples of 16"
    elif case == "head_dim":
        t = torch.zeros((2, 3, 64, 96), dtype=torch.bfloat16)[..., ::2]
        match = "contiguous"
    else:
        t, match = torch.zeros((6, 64, 64), dtype=torch.bfloat16), "dims"
    with pytest.raises(ValueError, match=match):
        tma_geometry(t)
