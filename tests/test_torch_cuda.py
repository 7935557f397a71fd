"""The port's hand-written kernels on a CUDA card (marker ``cuda``): each
held against its plain PyTorch version, with its launch count: the integer
kernels bit for bit, flash attention within the reference's tolerances
(2e-5 in float32, 2e-2 in bf16, tests/test_kernels.py).
Imports nothing of JAX, so it runs on the card:
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Skips elsewhere."""
import numpy as np
import pytest
import torch

from repro_torch.core import exchange_plan as xp
from repro_torch.kernels.chunk_pack.chunk_pack import PACK_CHUNKS, pack_chunks
from repro_torch.kernels.chunk_pack.ops import gather_rows
from repro_torch.kernels.chunk_pack.ref import pack_chunks_ref
from repro_torch.kernels.chunk_router import chunk_router as router_cuda
from repro_torch.kernels.chunk_router.chunk_router import (
    CLUSTER_MAX_N, DEST_BUDGETS, DEST_HISTOGRAM, DEST_HISTOGRAM2D,
    ROUTE_CHUNKS, ROUTE_CHUNKS_SEGMENTED, ROUTE_PLAN)
from repro_torch.kernels.chunk_router.chunk_router import \
    route_chunks as route_chunks_cuda
from repro_torch.kernels.chunk_router.ops import (histogram_rows,
                                                  histogram_rows2d,
                                                  leaf_table, route_chunks,
                                                  route_leaves)
from repro_torch.kernels.chunk_router.ref import (dest_budgets_ref,
                                                  dest_histogram2d_ref,
                                                  dest_histogram_ref,
                                                  route_chunks_ref,
                                                  route_chunks_segmented_ref,
                                                  route_plan_ref)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    FLASH_ATTENTION, FLASH_ATTENTION_F32, FLASH_ATTENTION_WIDE,
    flash_attention_bhsd)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.fletcher.fletcher import (FLETCHER,
                                                   FLETCHER_SEGMENTED,
                                                   fletcher_chunks,
                                                   fletcher_segmented)
from repro_torch.kernels.fletcher.ops import chunk_checksums, leaf_checksums
from repro_torch.kernels.fletcher.ref import (fletcher_chunks_ref,
                                              fletcher_segmented_ref)

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


def _routing(cuda, L, q, n, skewed, seed):
    """(L, q) destinations in [-1, n] (both ends outside the nodes), a
    fifth invalid, row 0 all invalid; ``skewed`` sends three quarters of
    each row to one or two nodes."""
    rng = np.random.RandomState(seed)
    dest = rng.randint(-1, n + 1, (L, q)).astype(np.int32)
    if skewed:
        dest[:, : 3 * q // 4] = rng.randint(0, min(n, 2), (L, 1))
    valid = rng.rand(L, q) > 0.2
    valid[0] = False
    return (torch.as_tensor(dest, device=cuda),
            torch.as_tensor(valid, device=cuda), rng)


PLAN_SHAPES = ([(n + 2, q, n) for n in (1, 8, 32, 64)
                for q in (0, 1, 8, 33, 100)] +
               [(32, 8, 32), (100, 8, 32), (32, 1024, 256), (32, 100, 2048),
                (3, 40, 49999)])


@pytest.mark.cuda
@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("L,q,n", PLAN_SHAPES)
def test_cuda_route_plan_and_budgets_match_plain(cuda, L, q, n, skewed):
    """``route_plan`` on uniform budgets {1, 3, q}, the measured budgets
    and budgets below and above the counts, and ``dest_budgets``, each
    bit for bit against its plain version with one launch a call; the
    deployment's (32, 8) at 32 nodes, 1024 requests at 256 nodes, 2048
    and 49,999 nodes (one row a block, shared memory past 48 KB)."""
    dest, valid, rng = _routing(cuda, L, q, n, skewed, 7 * L + q + n)
    before = DEST_BUDGETS.launches
    got_b = router_cuda.dest_budgets(dest, valid, n)
    torch.cuda.synchronize()
    assert DEST_BUDGETS.launches == before + 1
    assert torch.equal(got_b, dest_budgets_ref(dest, valid, n))
    measured = got_b.cpu().numpy()
    budgets = [np.full(n, b) for b in sorted({1, 3, q})] + [
        measured, np.maximum(measured - 1, 0),
        rng.randint(0, q + 2, n)]
    for b in budgets:
        if n * int(b.max()) > 1 << 24:        # keep send rows ≤ 64 MiB
            continue
        table = torch.as_tensor(np.stack([b, np.cumsum(b) - b]).astype(
            np.int32), device=cuda)
        total = int(b.sum())
        before = ROUTE_PLAN.launches
        got = router_cuda.route_plan(dest, valid, table, total=total)
        torch.cuda.synchronize()
        assert ROUTE_PLAN.launches == before + (L > 0)
        want = route_plan_ref(dest, valid, table, total=total)
        for a, w in zip(got, want):
            assert a.dtype == torch.int32 and torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [1, 3, 8])
def test_cuda_planner_is_one_launch_a_plan_and_a_spec(cuda, budget):
    """The planner on the card: a uniform round and a ragged round are one
    ``route_plan`` launch each, a measured spec one ``dest_budgets``
    launch, each equal to the planner on the CPU."""
    n, q = 32, 8
    dest, valid, _ = _routing(cuda, n, q, n, budget == 3, budget)
    dc, vc = dest.cpu(), valid.cpu()
    p0, b0 = ROUTE_PLAN.launches, DEST_BUDGETS.launches
    spec = xp.plan_ragged_spec(dest, valid, n)
    assert DEST_BUDGETS.launches == b0 + 1
    assert spec == xp.plan_ragged_spec(dc, vc, n)
    for got, want in ((xp._compact_plan(dest, valid, n, budget),
                       xp._compact_plan(dc, vc, n, budget)),
                      (xp._compact_plan_ragged(dest, valid, n, spec),
                       xp._compact_plan_ragged(dc, vc, n, spec))):
        for a, w in zip(got, want):
            assert torch.equal(a.cpu(), w)
    assert ROUTE_PLAN.launches == p0 + 2
    assert DEST_BUDGETS.launches == b0 + 1


@pytest.mark.cuda
def test_cuda_route_plan_wrappers_refuse_misuse(cuda):
    """Other dtypes, non-contiguous views, mismatched shapes and a table
    off the card or of the wrong shape raise with no launch."""
    dest, valid, _ = _routing(cuda, 8, 16, 8, False, 0)
    table = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    p0, b0 = ROUTE_PLAN.launches, DEST_BUDGETS.launches
    bad = [(dest.long(), valid, table), (dest, valid.int(), table),
           (dest.t(), valid.t(), table), (dest[:, :8], valid, table),
           (dest, valid, table.cpu()), (dest, valid, table[:1]),
           (dest, valid, table.long()), (dest.t().contiguous().t(), valid,
                                         table)]
    for d, v, t in bad:
        with pytest.raises(ValueError):
            router_cuda.route_plan(d, v, t, total=0)
    for d, v, _ in bad[:4]:
        with pytest.raises(ValueError):
            router_cuda.dest_budgets(d, v, 8)
    with pytest.raises(ValueError):
        router_cuda.dest_budgets(dest, valid, 0)
    with pytest.raises(ValueError):
        router_cuda.route_plan(dest, valid, table, total=-1)
    assert (ROUTE_PLAN.launches, DEST_BUDGETS.launches) == (p0, b0)


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


def _leaves(cuda, chunk):
    """Leaves of a save: empty, one word, exact multiples of the chunk, a
    short last chunk, bases 4, 8 and 12 bytes past 16-byte alignment (the
    4-byte load path)."""
    big = _words(4 * chunk + 9, cuda)
    return [_words(0, cuda), _words(1, cuda), _words(chunk, cuda),
            _words(3 * chunk, cuda), big[1:], _words(chunk + 17, cuda),
            big[2:chunk + 5], big[3:], _words(0, cuda), _words(7, cuda)]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [65536, 1000, 4, 1])
def test_cuda_fletcher_segmented_matches_plain(cuda, chunk):
    """Every chunk of many leaves in one launch: bit for bit the plain
    version and the per-leaf kernel, aligned and unaligned leaf bases."""
    leaves = _leaves(cuda, chunk)
    before = FLETCHER_SEGMENTED.launches
    got = leaf_checksums(leaves, chunk)
    torch.cuda.synchronize()
    assert FLETCHER_SEGMENTED.launches == before + 1
    assert torch.equal(got, fletcher_segmented_ref(leaves, chunk))
    assert torch.equal(got, torch.cat([fletcher_chunks(w, chunk)
                                       for w in leaves]))


@pytest.mark.cuda
def test_cuda_fletcher_segmented_many_leaves(cuda):
    """3000 leaves (a leaf search over three rounds of probes)."""
    leaves = [_words(int(n), cuda) for n in RNG.randint(0, 300, 3000)]
    got = fletcher_segmented(leaves, 64)
    assert torch.equal(got, fletcher_segmented_ref(leaves, 64))


def test_fletcher_segmented_wrapper_rejects_bad_input():
    """CPU tensors, no leaves, and chunks the kernel's one block a chunk
    cannot cover."""
    w = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fletcher_segmented([w], 4)
    with pytest.raises(ValueError, match="at least one leaf"):
        fletcher_segmented([], 4)
    for chunk in (0, 65537):
        with pytest.raises(ValueError, match="chunk_words"):
            fletcher_segmented([w], chunk)


@pytest.mark.cuda
def test_cuda_fletcher_segmented_rejects_bad_leaves(cuda):
    w = _words(8, cuda)
    before = FLETCHER_SEGMENTED.launches
    with pytest.raises(ValueError, match="int32"):
        fletcher_segmented([w, w.to(torch.int64)], 4)
    with pytest.raises(ValueError, match="contiguous"):
        fletcher_segmented([w, _words(16, cuda)[::2]], 4)
    with pytest.raises(ValueError, match="dims"):
        fletcher_segmented([w.view(2, 4)], 4)
    with pytest.raises(ValueError, match="CUDA"):
        fletcher_segmented([w, w.cpu()], 4)
    assert FLETCHER_SEGMENTED.launches == before


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
    f0, r0 = FLETCHER_SEGMENTED.launches, ROUTE_CHUNKS_SEGMENTED.launches
    mgr.save(1, state)
    mgr.wait()
    restored, step = mgr.restore(1, state)
    assert step == 1
    for k in state:
        assert restored[k].is_cuda and restored[k].dtype == state[k].dtype
        assert torch.equal(restored[k].reshape(-1).view(torch.uint8),
                           state[k].reshape(-1).view(torch.uint8))
    # one checksum launch and one routing launch a save, and one each a
    # restore (the state is far below a verify group)
    assert FLETCHER_SEGMENTED.launches == f0 + 2
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
@pytest.mark.parametrize("n", [45884, CLUSTER_MAX_N, CLUSTER_MAX_N + 1])
@pytest.mark.parametrize("n_bins", [1, 32, 768, 769, 12288, 12289, 50000])
def test_cuda_dest_histogram_both_paths_and_bin_counts(cuda, n, n_bins):
    """Either side of the one-cluster path's limits: n up to and past
    CLUSTER_MAX_N, bins that fit a block's 48 KB of shared memory
    (<= 12288) and past it (the grid path's opt-in)."""
    dest = torch.as_tensor(RNG.randint(-1, n_bins + 2, n).astype(np.int32),
                           device=cuda)
    got = histogram_rows(dest, n_bins=n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, dest_histogram_ref(dest, n_bins=n_bins))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_dest_histogram_unaligned_view(cuda, offset):
    """A view 4, 8 or 12 bytes past 16-byte alignment takes the 4-byte
    loads."""
    dest = torch.as_tensor(RNG.randint(-1, 35, 50000).astype(np.int32),
                           device=cuda)[offset:]
    assert torch.equal(histogram_rows(dest, n_bins=33),
                       dest_histogram_ref(dest, n_bins=33))


@pytest.mark.cuda
def test_cuda_dest_histogram_all_sentinel_counts_nothing(cuda):
    dest = torch.full((10000,), -1, dtype=torch.int32, device=cuda)
    dest[::3] = 33
    assert not histogram_rows(dest, n_bins=33).any()


def _launched():
    """The flash-attention launch counts, (bf16 kernel, float32 kernel)."""
    return FLASH_ATTENTION.launches, FLASH_ATTENTION_F32.launches


@pytest.mark.cuda
@pytest.mark.parametrize("D", [320, 384, 512, 640])
@pytest.mark.parametrize("S", [1, 65, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_wide_head_dims(cuda, D, S, dtype, causal):
    """Head dims above 256 through the wide float32 kernel (bf16 computed
    in float32 and rounded once): within 2e-5 (3xTF32) of the float32
    plain version, 2e-2 in bf16."""
    q, k, v = (torch.as_tensor(RNG.randn(2, S, 3, D).astype(np.float32),
                               device=cuda).to(dtype) for _ in range(3))
    before = FLASH_ATTENTION_WIDE.launches, _launched()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (FLASH_ATTENTION_WIDE.launches, _launched()) == (
        before[0] + 1, before[1])
    assert got.shape == q.shape and got.dtype == dtype
    want = flash_attention_ref(q, k, v, scale=D ** -0.5, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


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
    """The kernel's wrapper takes the instances' head dims, and above 256
    float32 multiples of 128 only (the entry point pads and converts)."""
    x = torch.zeros((1, 2, 64, 320), device=cuda)
    with pytest.raises(ValueError, match="head dim 320"):
        flash_attention_bhsd(x, x, x, scale=0.1)
    x = torch.zeros((1, 2, 64, 384), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 384"):
        flash_attention_bhsd(x, x, x, scale=0.1)
    w = torch.zeros((1, 2, 64, 96), device=cuda)
    with pytest.raises(ValueError, match="head dim 96"):
        flash_attention_bhsd(w, w, w, scale=0.1)
    y = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(y, y.to(torch.bfloat16), y)


# ---------------------------------------------------------------------------
# online adaptation on the card: telemetry, re-compaction, the relayout
# stream (tests/test_torch_adapt.py holds the same streams on the CPU
# against the JAX package)
# ---------------------------------------------------------------------------
ADAPT_SCOPE = "/bb/hot"
ADAPT_SCOPES = {ADAPT_SCOPE: 1, "/bb/h": 4}      # NODE_LOCAL, HYBRID
# tests/test_adapt.py's frozen observables of the interleaved stream
STREAM_DIGEST = "cfd76da6b40767fb96d3095ded4fbb01"


def adapt_digest(*arrays) -> str:
    """sha256 of the observables' bytes, 32 hex digits (test_adapt's)."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:32]


def mixed_stream(client, raw_request, seed=11, n=8, w=8):
    """Two scopes and the default row, random validity, repeated paths,
    widths 12 and 1, every op, then an unscoped request built by
    ``raw_request(path_hash, chunk_id)`` (numpy int32 (n, 4) each)."""
    rng = np.random.RandomState(seed)
    for step in range(4):
        q = (12, 1, 12, 12)[step]
        paths = [[(f"{ADAPT_SCOPE}/r{i}/f{j % 3}", f"/bb/h/g{(i + j) % 4}",
                   f"/other/x{j}")[(i + j + step) % 3] for j in range(q)]
                 for i in range(n)]
        cid = rng.randint(0, 20, (n, q)).astype(np.int32)
        pay = rng.randint(0, 999, (n, q, w)).astype(np.int32)
        valid = rng.rand(n, q) > 0.25
        req = client.encode(paths, chunk_id=cid, payload=pay, valid=valid)
        client.write(req)
        client.read(req)
        client.stat(req)
    ph = rng.randint(1, 1 << 20, (n, 4)).astype(np.int32)
    client.read(raw_request(ph, np.zeros((n, 4), np.int32)))
    return client


def interleaved_stream(relayout, new_mode=3, device="cpu",
                       backend="stacked", exchange="auto"):
    """``tests/test_adapt.py::_interleaved_stream`` through the port on
    ``device`` (or on a ``NodeMesh`` ``backend``, whose device it takes,
    the observables gathered from every rank), under ``exchange``:
    returns (client, observables)."""
    from repro_torch.core.adapt import LiveMigrator
    from repro_torch.core.client import BBClient, BBRequest
    from repro_torch.core.policy import LayoutPolicy
    n, q, w = 8, 6, 8
    mesh = None if backend == "stacked" else backend
    client = BBClient(LayoutPolicy.from_scopes({ADAPT_SCOPE: 1}, n_nodes=n,
                                               default=3), backend,
                      device=device if mesh is None else None, cap=256,
                      words=w, mcap=256, telemetry=True, exchange=exchange)
    glob = (lambda x: x) if mesh is None else mesh.gather
    rng = np.random.RandomState(7)
    outs, reqs = [], []
    for _ in range(3):
        paths = [[f"{ADAPT_SCOPE}/r{i}/f{j % 2}" for j in range(q)]
                 for i in range(n)]
        shared = [[f"/shared/g{j}" for j in range(q)] for _ in range(n)]
        cid = rng.randint(0, 4, (n, q)).astype(np.int32)
        pay = rng.randint(0, 9999, (n, q, w)).astype(np.int32)
        wreq = client.encode(paths, chunk_id=cid, payload=pay)
        client.write(wreq)
        client.write(client.encode(shared, chunk_id=cid, payload=pay))
        reqs.append(wreq)
    mig = None
    if relayout:
        mig = LiveMigrator(client, ADAPT_SCOPE, new_mode, step_chunks=8)
        assert mig.total_chunks > 0
    perm = torch.as_tensor(np.roll(np.arange(n), 3), device=client.device)
    for step in range(12):
        base = reqs[step % len(reqs)]
        out, found = client.read(BBRequest(
            path_hash=base.path_hash[perm], chunk_id=base.chunk_id[perm],
            scope_hash=base.scope_hash[perm]))
        fnd, size, _ = client.stat(base)
        outs += [glob(x) for x in (out, found, fnd, size)]
        if mig is not None and not mig.done:
            mig.step()
            if mig.done:
                mig.finish()
    if mig is not None and mig.done and client.fallback is not None:
        mig.finish()
    return client, outs


def _port_raw_request(device):
    from repro_torch.core.client import BBRequest
    return lambda ph, cid: BBRequest(
        path_hash=torch.as_tensor(ph, device=device),
        chunk_id=torch.as_tensor(cid, device=device))


@pytest.mark.cuda
def test_cuda_telemetry_counters_match_the_cpu(cuda):
    """The same stream's counters on the card equal the port's CPU
    counters (integer-valued columns exact, pressure within 1e-6
    relative) and are identical on a second run; each record launches
    one counts-only dest_histogram2d."""
    from repro_torch.core.adapt import telemetry as tm
    from repro_torch.core.client import BBClient
    from repro_torch.core.policy import LayoutPolicy

    def run(device):
        client = BBClient(LayoutPolicy.from_scopes(ADAPT_SCOPES, n_nodes=8,
                                                   default=2),
                          device=device, cap=256, words=8, mcap=256,
                          telemetry=True, capacity=0.5)
        return mixed_stream(client, _port_raw_request(device)
                            ).telemetry.snapshot()

    before = DEST_HISTOGRAM2D.launches
    card = run(cuda)
    assert DEST_HISTOGRAM2D.launches - before == 13     # one per record
    cpu = run("cpu")
    cols = [c for c in range(tm.N_FEATURES) if c != tm.F_PRESSURE]
    np.testing.assert_array_equal(card[:, cols], cpu[:, cols])
    np.testing.assert_allclose(card[:, tm.F_PRESSURE], cpu[:, tm.F_PRESSURE],
                               rtol=1e-6, atol=0)
    assert card[:, tm.F_PRESSURE].sum() > 0
    np.testing.assert_array_equal(run(cuda), card)


@pytest.mark.cuda
def test_cuda_clear_chunks_matches_plain(cuda):
    """The re-compaction gathers the data and key tables through
    pack_chunks, bit for bit with the plain version on the CPU."""
    from repro_torch.core import burst_buffer as bb
    n, cap, w, m = 8, 64, 33, 40
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 6, (n, cap, 2)).astype(np.int32)
    keys[rng.rand(n, cap) < 0.3] = -1
    tables = [rng.randint(-2 ** 31, 2 ** 31 - 1, (n, cap, w)).astype(
        np.int32), keys, (keys[..., 0] >= 0).sum(1).astype(np.int32)] + \
        [np.zeros((n, 16), np.int32)] * 3 + [np.zeros(n, np.int32)] * 2
    q_keys = rng.randint(0, 6, (n, m, 2)).astype(np.int32)
    valid = rng.rand(n, m) > 0.3
    out = {}
    for dev in (cuda, "cpu"):
        state = bb.from_jax_state(tables, device=dev)
        before = PACK_CHUNKS.launches
        bb._clear_chunks(state, torch.as_tensor(q_keys, device=dev),
                         torch.as_tensor(valid, device=dev))
        if dev != "cpu":
            assert PACK_CHUNKS.launches - before == 2
        out[str(dev)] = bb.to_numpy(state)
    for a, b in zip(out[str(cuda)], out["cpu"]):
        np.testing.assert_array_equal(a, b)
    assert out["cpu"][2].sum() < tables[2].sum()


@pytest.mark.cuda
@pytest.mark.parametrize("new_mode", [3, 4])
def test_cuda_relayout_stream_digest(cuda, new_mode):
    """The pinned interleaved stream on the card, without and with a live
    relayout, reproduces the reference's digest."""
    _, plain = interleaved_stream(False, device=cuda)
    client, migrated = interleaved_stream(True, new_mode, device=cuda)
    assert adapt_digest(*plain) == adapt_digest(*migrated) == STREAM_DIGEST
    assert client.epoch == 2 and client.fallback is None
