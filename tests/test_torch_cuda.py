"""The port's hand-written kernels on a CUDA card (marker ``cuda``): each
held against its plain PyTorch version, with its launch count: the integer
kernels bit for bit, flash attention within the reference's tolerances
(2e-5 in float32, 2e-2 in bf16, tests/test_kernels.py).
Imports nothing of JAX, so it runs on the card:
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Skips elsewhere."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.chunk_pack.chunk_pack import PACK_CHUNKS, pack_chunks
from repro_torch.kernels.chunk_pack.ops import gather_rows
from repro_torch.kernels.chunk_pack.ref import pack_chunks_ref
from repro_torch.kernels.chunk_router.chunk_router import (
    DEST_HISTOGRAM, DEST_HISTOGRAM2D, ROUTE_CHUNKS, ROUTE_CHUNKS_SEGMENTED)
from repro_torch.kernels.chunk_router.chunk_router import \
    route_chunks as route_chunks_cuda
from repro_torch.kernels.chunk_router.ops import (histogram_rows,
                                                  histogram_rows2d,
                                                  leaf_table, route_chunks,
                                                  route_leaves)
from repro_torch.kernels.chunk_router.ref import (dest_histogram2d_ref,
                                                  dest_histogram_ref,
                                                  route_chunks_ref,
                                                  route_chunks_segmented_ref)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    FLASH_ATTENTION, FLASH_ATTENTION_F32, flash_attention_bhsd)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.fletcher.fletcher import FLETCHER, fletcher_chunks
from repro_torch.kernels.fletcher.ops import chunk_checksums
from repro_torch.kernels.fletcher.ref import fletcher_chunks_ref

RNG = np.random.RandomState(7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the chip)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_bins", [((32, 8), 33), ((1, 8), 5),
                                          ((16, 128), 32), ((4, 300), 4097),
                                          ((3, 50), 20000), ((0, 8), 5),
                                          ((5, 0), 9)])
def test_cuda_histogram_matches_plain(cuda, shape, n_bins):
    dest = torch.as_tensor(RNG.randint(-1, n_bins + 2, shape).astype(
        np.int32), device=cuda)
    before = DEST_HISTOGRAM2D.launches
    got = histogram_rows2d(dest, n_bins=n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, dest_histogram2d_ref(dest, n_bins=n_bins))
    assert DEST_HISTOGRAM2D.launches == before + (shape[0] > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,w", [(256, 1024, 262147), (16, 16, 8),
                                   (100, 333, 16), (1, 7, 1), (4, 0, 3)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_cuda_pack_matches_plain(cuda, n, m, w, dtype):
    payload = torch.randn((n, w), device=cuda).mul_(1e4).to(dtype)
    idx = torch.as_tensor(RNG.randint(-1, n, m).astype(np.int32),
                          device=cuda)
    before = PACK_CHUNKS.launches
    got = gather_rows(payload, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, pack_chunks_ref(payload, idx))
    assert PACK_CHUNKS.launches == before + (m > 0)


@pytest.mark.cuda
def test_cuda_pack_out_of_range_id_gives_zero_row(cuda):
    payload = torch.ones((4, 5), dtype=torch.int32, device=cuda)
    idx = torch.tensor([0, 4, 99, -7], dtype=torch.int32, device=cuda)
    got = pack_chunks(payload, idx).cpu()
    assert got[0].eq(1).all() and got[1:].eq(0).all()


def _words(n, cuda):
    w = RNG.randint(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
    if n:
        w[RNG.randint(0, n, max(1, n // 50))] = -2 ** 31   # float -0.0
        w[RNG.randint(0, n, max(1, n // 50))] = 2 ** 31 - 1
    return torch.as_tensor(w, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n,chunk", [(0, 65536), (1, 65536), (1000, 1000),
                                     (1001, 1000), (65536 * 3 + 17, 65536),
                                     (65536 * 2, 65536), (300001, 300001),
                                     (5, 1), (1 << 20, 1 << 20)])
def test_cuda_fletcher_matches_plain(cuda, n, chunk):
    words = _words(n, cuda)
    before = FLETCHER.launches
    got = chunk_checksums(words, chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, fletcher_chunks_ref(words, chunk))
    assert FLETCHER.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [65536, 1000])
def test_cuda_fletcher_unaligned_view(cuda, chunk):
    """A view starting 12 bytes past an aligned base takes the 4-byte
    load path."""
    words = _words(70003, cuda)[3:]
    assert torch.equal(fletcher_chunks(words, chunk),
                       fletcher_chunks_ref(words, chunk))


def test_fletcher_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fletcher_chunks(torch.zeros(4, dtype=torch.int32), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
@pytest.mark.parametrize("n,nodes", [(1, 32), (1000, 64), (45770, 32),
                                     (45770, 64), (3, 20000)])
def test_cuda_route_chunks_matches_plain(cuda, mode, n, nodes):
    ph = torch.as_tensor(RNG.randint(0, 2 ** 31 - 1, n).astype(np.int32),
                         device=cuda)
    cid = torch.arange(n, dtype=torch.int32, device=cuda)
    cl = torch.as_tensor(RNG.randint(-1, nodes + 2, n).astype(np.int32),
                         device=cuda)
    before = ROUTE_CHUNKS.launches
    d, c = route_chunks(ph, cid, cl, mode=mode, n_nodes=nodes)
    torch.cuda.synchronize()
    rd, rc = route_chunks_ref(ph, cid, cl, mode=mode, n_nodes=nodes)
    assert torch.equal(d, rd) and torch.equal(c, rc)
    assert ROUTE_CHUNKS.launches == before + 1


@pytest.mark.cuda
def test_cuda_route_chunks_rejects_mismatched_lengths(cuda):
    z = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="length"):
        route_chunks_cuda(z, z[:3], z, mode=3, n_nodes=8)


@pytest.mark.cuda
def test_cuda_checkpoint_roundtrip_goes_through_both_kernels(cuda, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.layouts import LayoutMode
    from repro_torch.core.policy import LayoutPolicy
    policy = LayoutPolicy.from_scopes({"/bb/ckpt": LayoutMode.HYBRID},
                                      n_nodes=32,
                                      default=LayoutMode.CENTRAL_META)
    state = {"w": torch.randn(3, 70001, device=cuda),
             "b": torch.randn(5, 5, 5, device=cuda).to(torch.bfloat16),
             "step": torch.tensor(7, dtype=torch.int32, device=cuda)}
    mgr = CheckpointManager(str(tmp_path), policy, async_save=True)
    f0, r0 = FLETCHER.launches, ROUTE_CHUNKS_SEGMENTED.launches
    mgr.save(1, state)
    mgr.wait()
    restored, step = mgr.restore(1, state)
    assert step == 1
    for k in state:
        assert restored[k].is_cuda and restored[k].dtype == state[k].dtype
        assert torch.equal(restored[k].reshape(-1).view(torch.uint8),
                           state[k].reshape(-1).view(torch.uint8))
    # a checksum launch a leaf; one routing launch a save and one a restore
    assert FLETCHER.launches == f0 + 6
    assert ROUTE_CHUNKS_SEGMENTED.launches == r0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves,nodes", [(1, 32), (251, 32), (251, 64),
                                            (20000, 7), (3, 20000)])
def test_cuda_route_leaves_matches_plain(cuda, n_leaves, nodes):
    """A whole checkpoint's chunks routed in one launch, leaves of every
    mode and of 0 to 4608 chunks; 20000 leaves take the kernel's shared
    offsets past 48 KB."""
    n_chunks = RNG.randint(0, 4609 if n_leaves < 1000 else 4, n_leaves)
    n_chunks[0] = max(n_chunks[0], 1)
    table, offsets = leaf_table(RNG.randint(0, 2 ** 31 - 1, n_leaves),
                                RNG.randint(1, 5, n_leaves), n_chunks)
    before = ROUTE_CHUNKS_SEGMENTED.launches
    got = route_leaves(table, int(offsets[-1]), n_nodes=nodes, device=cuda)
    torch.cuda.synchronize()
    assert ROUTE_CHUNKS_SEGMENTED.launches == before + 1
    want = route_chunks_segmented_ref(torch.as_tensor(table, device=cuda),
                                      int(offsets[-1]), n_nodes=nodes)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 8, 100, 4097, 45770, 1 << 22])
@pytest.mark.parametrize("n_bins", [4, 33, 20000])
def test_cuda_dest_histogram_matches_plain(cuda, n, n_bins):
    dest = torch.as_tensor(RNG.randint(-1, n_bins + 2, n).astype(np.int32),
                           device=cuda)
    before = DEST_HISTOGRAM.launches
    got = histogram_rows(dest, n_bins=n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, dest_histogram_ref(dest, n_bins=n_bins))
    assert DEST_HISTOGRAM.launches == before + (n > 0)


@pytest.mark.cuda
def test_cuda_dest_histogram_all_sentinel_counts_nothing(cuda):
    dest = torch.full((10000,), -1, dtype=torch.int32, device=cuda)
    dest[::3] = 33
    assert not histogram_rows(dest, n_bins=33).any()


def _launched():
    """The flash-attention launch counts, (bf16 kernel, float32 kernel)."""
    return FLASH_ATTENTION.launches, FLASH_ATTENTION_F32.launches


def _one_more(before, dtype):
    bf16, f32 = before
    return (bf16 + 1, f32) if dtype == torch.bfloat16 else (bf16, f32 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 96, 256, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_matches_plain(cuda, D, S, dtype, causal):
    """Ragged S (1, 63, 65, 96, 1000) leaves a partial last tile of
    queries and keys; bf16 runs the Hopper kernel, float32 the SIMT one."""
    q, k, v = (torch.as_tensor(RNG.randn(2, S, 3, D).astype(np.float32),
                               device=cuda).to(dtype) for _ in range(3))
    before = _launched()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _launched() == _one_more(before, dtype)
    assert got.dtype == dtype and got.is_contiguous()
    want = flash_attention_ref(q, k, v, scale=D ** -0.5, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,S", [(torch.float32, 256, 1024),
                                       (torch.bfloat16, 256, 1024),
                                       (torch.bfloat16, 256, 1000),
                                       (torch.bfloat16, 128, 1024),
                                       (torch.bfloat16, 80, 1024),
                                       (torch.bfloat16, 64, 1024)])
def test_cuda_flash_attention_gemma_global_shape(cuda, dtype, D, S):
    """B 4, S 1024, H 4, D 256: gemma3-1b's global layers at the training
    batch; in bf16 also ragged S and the other head dims."""
    q, k, v = (torch.randn((4, S, 4, D), device=cuda).to(dtype)
               for _ in range(3))
    before = _launched()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _launched() == _one_more(before, dtype)
    want = flash_attention_ref(q, k, v, scale=D ** -0.5, causal=True)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [80, 256])
def test_cuda_flash_attention_reads_any_strides(cuda, dtype, D):
    """Contiguous (BH, S, D)-style views, a (B, S, H, D) transpose and a
    head-dim slice of a wider tensor: the kernel follows each tensor's own
    strides (in bf16 through TMA tensor maps)."""
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    q = torch.randn((2, 3, 130, D), device=cuda).to(dtype)
    kt = torch.randn((2, 130, 3, D), device=cuda).to(dtype).transpose(1, 2)
    vs = torch.randn((2, 3, 130, 2 * D), device=cuda).to(dtype)[..., :D]
    got = flash_attention_bhsd(q, kt, vs, scale=0.125, causal=True)
    assert got.is_contiguous()
    want = attention_ref(q.reshape(6, 130, D), kt.reshape(6, 130, D),
                         vs.reshape(6, 130, D), scale=0.125, causal=True)
    torch.testing.assert_close(got.reshape(6, 130, D).float(), want.float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 1000, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_f32_tensor_cores_hold_2e5(cuda, D, S, causal):
    """The float32 kernel (3xTF32 on the tensor cores) over every head dim
    and ragged S, unit-normal q/k/v: within 2e-5 of the plain version."""
    q, k, v = (torch.as_tensor(RNG.randn(2, S, 3, D).astype(np.float32),
                               device=cuda) for _ in range(3))
    before = _launched()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _launched() == _one_more(before, torch.float32)
    want = flash_attention_ref(q, k, v, scale=D ** -0.5, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 96, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_pads_head_dims(cuda, D, dtype):
    """Head dims without an instance go through the next one, zero-padded,
    with the scale of the true D."""
    q, k, v = (torch.as_tensor(RNG.randn(2, 130, 3, D).astype(np.float32),
                               device=cuda).to(dtype) for _ in range(3))
    before = _launched()
    got = flash_attention(q, k, v, causal=True, block_q=256, block_k=128,
                          interpret=False)
    torch.cuda.synchronize()
    assert _launched() == _one_more(before, dtype)
    assert got.shape == q.shape and got.dtype == dtype
    want = flash_attention_ref(q, k, v, scale=D ** -0.5, causal=True)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 96])
def test_cuda_flash_attention_float16_runs_the_float32_kernel(cuda, D):
    """float16 is computed by the float32 kernel and rounded once: within
    2e-3 (one float16 ulp below 2 is ≤ 9.8e-4) of the float32 plain
    version rounded to float16."""
    q, k, v = (torch.as_tensor(RNG.randn(2, 200, 3, D).astype(np.float16),
                               device=cuda) for _ in range(3))
    before = _launched()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _launched() == _one_more(before, torch.float32)
    assert got.dtype == torch.float16
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               scale=D ** -0.5, causal=True).half()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.cuda
def test_cuda_flash_attention_misaligned_bf16_view_raises(cuda):
    """A bf16 view one element past a 16-byte boundary cannot be read by
    TMA: the kernel's wrapper raises and launches nothing."""
    flat = torch.randn(2 * 96 * 3 * 64 + 1, device=cuda).to(torch.bfloat16)
    bad = flat[1:].view(2, 96, 3, 64).transpose(1, 2)
    good = torch.randn((2, 3, 96, 64), device=cuda).to(torch.bfloat16)
    before = _launched()
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bhsd(bad, good, good, scale=0.125)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bhsd(good, good, bad, scale=0.125)
    assert _launched() == before


@pytest.mark.cuda
def test_cuda_flash_attention_misaligned_bf16_view_through_entry_point(cuda):
    """The entry point copies a view TMA cannot read and gives the plain
    version's result on it (2e-2, bf16), with one launch."""
    flat = torch.randn(2 * 96 * 3 * 64 + 1, device=cuda).to(torch.bfloat16)
    bad = flat[1:].view(2, 96, 3, 64)
    good = torch.randn((2, 96, 3, 64), device=cuda).to(torch.bfloat16)
    for args in ((bad, good, good), (good, good, bad)):
        before = _launched()
        got = flash_attention(*args)
        torch.cuda.synchronize()
        assert _launched() == _one_more(before, torch.bfloat16)
        want = flash_attention_ref(*args, scale=0.125, causal=True)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_unsupported_input(cuda):
    x = torch.zeros((1, 64, 2, 320), device=cuda)
    with pytest.raises(ValueError, match="head dim 320"):
        flash_attention(x, x, x)
    w = torch.zeros((1, 2, 64, 96), device=cuda)
    with pytest.raises(ValueError, match="head dim 96"):
        flash_attention_bhsd(w, w, w, scale=0.1)
    y = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(y, y.to(torch.bfloat16), y)
