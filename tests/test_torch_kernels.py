"""The port's kernels: plain versions against the JAX package's Pallas
kernel (interpret mode) and oracles, the CPU/CUDA dispatch and the build's
failure path.  The kernels themselves are held against their plain versions
on the card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunk_pack.ref import gather_rows_batched_ref as j_gbr
from repro.kernels.chunk_pack.ref import pack_chunks_ref as j_pack_ref
from repro.kernels.chunk_router.chunk_router import dest_histogram2d_kernel
from repro.kernels.chunk_router.ops import dest_histogram as j_dest_histogram
from repro.kernels.chunk_router.ref import dest_histogram2d_ref as j_hist_ref
from repro.kernels.chunk_router.ref import \
    dest_histogram_ref as j_hist1d_ref
from repro_torch import kernels
from repro_torch.kernels.chunk_pack.chunk_pack import pack_chunks
from repro_torch.kernels.chunk_pack.ops import gather_rows, gather_rows_batched
from repro_torch.kernels.chunk_pack.ref import (gather_rows_batched_ref,
                                                pack_chunks_ref)
from repro_torch.kernels.chunk_router import chunk_router as router_cuda
from repro_torch.kernels.chunk_router.chunk_router import (dest_histogram,
                                                          dest_histogram2d)
from repro_torch.kernels.chunk_router.ops import (dest_budgets,
                                                  histogram_rows,
                                                  histogram_rows2d,
                                                  route_plan)
from repro_torch.kernels.chunk_router.ref import (dest_budgets_ref,
                                                  dest_histogram2d_ref,
                                                  dest_histogram_ref,
                                                  route_plan_ref)

RNG = np.random.RandomState(7)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The shapes here are small: torch's default of a thread per core only
    spins against JAX's pool and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# plain versions vs the JAX package (cases of tests/test_kernels.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 8), (4, 33), (16, 128), (32, 8)])
@pytest.mark.parametrize("n_bins", [5, 32, 33])
def test_histogram_plain_matches_pallas_kernel(shape, n_bins):
    """Out-of-range values (the -1 sentinel and bins past n_bins) are
    counted nowhere, exactly as the Pallas kernel in interpret mode."""
    dest = RNG.randint(-1, n_bins + 2, shape).astype(np.int32)
    ref = np.asarray(dest_histogram2d_kernel(jnp.asarray(dest),
                                             n_bins=n_bins, interpret=True))
    np.testing.assert_array_equal(ref, np.asarray(
        j_hist_ref(jnp.asarray(dest), n_bins=n_bins)))
    got = dest_histogram2d_ref(torch.as_tensor(dest), n_bins=n_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        histogram_rows2d(torch.as_tensor(dest), n_bins=n_bins).numpy(), ref)


@pytest.mark.parametrize("shape,n_bins", [((0, 8), 5), ((3, 0), 5),
                                          ((2, 4), 1)])
def test_histogram_plain_edges(shape, n_bins):
    dest = RNG.randint(-1, 3, shape).astype(np.int32)
    got = histogram_rows2d(torch.as_tensor(dest), n_bins=n_bins)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_hist_ref(jnp.asarray(dest),
                                           n_bins=n_bins)).reshape(got.shape))


@pytest.mark.parametrize("n", [8, 100, 1024, 4097])
@pytest.mark.parametrize("n_bins", [4, 33])
def test_dest_histogram_plain_matches_pallas_kernel(n, n_bins):
    """The sweep of tests/test_kernels.py: the one-vector histogram's plain
    version and entry point against the Pallas kernel (interpret mode) and
    the reference's oracle, bit for bit; the -1 sentinel and values past
    the last bin are counted nowhere."""
    dest = RNG.randint(-1, n_bins + 2, n).astype(np.int32)
    ref = np.asarray(j_dest_histogram(jnp.asarray(dest), n_bins=n_bins))
    np.testing.assert_array_equal(ref, np.asarray(
        j_hist1d_ref(jnp.asarray(dest), n_bins=n_bins)))
    got = dest_histogram_ref(torch.as_tensor(dest), n_bins=n_bins)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_bins,)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        histogram_rows(torch.as_tensor(dest), n_bins=n_bins).numpy(), ref)


@pytest.mark.parametrize("case", ["empty", "all_sentinel"])
def test_dest_histogram_plain_edges(case):
    """n = 0 gives zeros (held against the oracle: the Pallas kernel's
    wrapper cannot slice an empty vector); a vector of sentinels and values
    past the last bin counts nothing (held against both)."""
    n_bins = 33
    if case == "empty":
        dest = np.zeros(0, np.int32)
    else:
        dest = RNG.choice([-1, -7, n_bins, n_bins + 5], 1000).astype(np.int32)
        np.testing.assert_array_equal(
            np.asarray(j_dest_histogram(jnp.asarray(dest), n_bins=n_bins)),
            np.zeros(n_bins, np.int32))
    ref = np.asarray(j_hist1d_ref(jnp.asarray(dest), n_bins=n_bins))
    np.testing.assert_array_equal(ref, np.zeros(n_bins, np.int32))
    for fn in (dest_histogram_ref, histogram_rows):
        got = fn(torch.as_tensor(dest), n_bins=n_bins)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n,m,w", [(16, 16, 8), (100, 333, 16), (512, 64, 4),
                                   (3, 5, 1)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_pack_plain_matches_reference(n, m, w, dtype):
    payload = (RNG.randn(n, w) * 100).astype(dtype)
    idx = RNG.randint(-1, n, m).astype(np.int32)
    ref = np.asarray(j_pack_ref(jnp.asarray(payload), jnp.asarray(idx)))
    got = pack_chunks_ref(torch.as_tensor(payload), torch.as_tensor(idx))
    assert got.dtype == torch.as_tensor(payload).dtype
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        gather_rows(torch.as_tensor(payload), torch.as_tensor(idx)).numpy(),
        ref)


@pytest.mark.parametrize("m", [3, 17, 256, 259])
def test_pack_sentinel_never_gathers_row_zero(m):
    """Poison row 0: a sentinel row must come back zero."""
    n, w = 8, 4
    payload = np.full((n, w), 7777, np.int32)
    payload[1:] = np.arange(1, n)[:, None]
    idx = RNG.randint(-1, n, m).astype(np.int32)
    idx[0] = -1
    got = gather_rows(torch.as_tensor(payload), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_pack_ref(jnp.asarray(payload), jnp.asarray(idx))))
    assert (got[idx < 0] == 0).all()


@pytest.mark.parametrize("shape", [(2, 4, 3), (8, 16, 8), (4, 6, 2, 3)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_gather_rows_batched_rebase_matches_reference(shape, dtype):
    """The (L·q, w) rebase never crosses rows; -1 columns come back zero;
    zero-column plans stay well formed."""
    L, q = shape[:2]
    x = (RNG.randn(*shape) * 1000).astype(dtype)
    idx = RNG.randint(-1, q, (L, 2 * q)).astype(np.int32)
    ref = np.asarray(j_gbr(jnp.asarray(x), jnp.asarray(idx)))
    tx, tidx = torch.as_tensor(x), torch.as_tensor(idx)
    np.testing.assert_array_equal(gather_rows_batched(tx, tidx).numpy(), ref)
    np.testing.assert_array_equal(gather_rows_batched_ref(tx, tidx).numpy(),
                                  ref)
    empty = gather_rows_batched(tx, torch.zeros((L, 0), dtype=torch.int32))
    assert tuple(empty.shape) == (L, 0) + shape[2:]


# ---------------------------------------------------------------------------
# route_plan: the kernel's warp algorithm against the plain version
# ---------------------------------------------------------------------------
def _warp_model(dest, valid, budget, offset, total):
    """``csrc/dest_histogram2d.cu``'s route_plan_kernel, one warp a row,
    in numpy: 32-slot chunks in slot order, peer masks (lanes of a chunk
    with the same destination), the leader (lowest peer) advancing the
    row's counter; the send row filled with -1, then pass 2's ranks (the
    counter before the chunk + lower peers) scattered over it.  Unwritten
    reply slots stay -99, so a slot the kernel would leave unwritten fails
    the comparison."""
    L, q = dest.shape
    n = len(budget)
    send = np.full((L, total), -99, np.int64)
    reply = np.full((L, q), -99, np.int64)
    over = np.zeros(L, np.int64)
    counts = np.zeros((L, n), np.int64)
    lanes = np.arange(32)
    for r in range(L):
        def chunk(base):
            j = base + lanes
            ok = j < q
            jj = np.minimum(j, max(q - 1, 0))
            d = dest[r, jj] if q else np.zeros(32, np.int64)
            inb = ok & (valid[r, jj] if q else False) & (d >= 0) & (d < n)
            d = np.where(inb, d, n)
            peers = d[:, None] == d[None, :]
            leader = peers.argmax(axis=1) == lanes
            return j, d, peers, leader

        cnt = np.zeros(n + 1, np.int64)
        for base in range(0, q, 32):
            _, d, peers, leader = chunk(base)
            np.add.at(cnt, d[leader], peers.sum(axis=1)[leader])
        counts[r] = cnt[:n]
        over[r] = np.maximum(cnt[:n] - budget, 0).sum()
        send[r] = -1
        cnt[:] = 0
        for base in range(0, q, 32):
            j, d, peers, leader = chunk(base)
            before = cnt[d]
            cnt[d[leader]] = before[leader] + peers.sum(axis=1)[leader]
            rank = before + np.tril(peers, -1).sum(axis=1)
            for lane in np.flatnonzero(j < q):
                dl = d[lane]
                slot = -1
                if dl < n and rank[lane] < budget[dl]:
                    slot = offset[dl] + rank[lane]
                    send[r, slot] = j[lane]
                reply[r, j[lane]] = slot
    return send, reply, over, counts


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("q", [0, 1, 8, 33, 100])
@pytest.mark.parametrize("n", [1, 8, 32, 64])
def test_route_plan_warp_algorithm_matches_plain(n, q, skewed):
    """The kernel's chunked peer-mask ranks equal the stable sort's on
    uniform budgets {1, 3, q} and a ragged table whose budgets lie above,
    at and below the counts (Σb > q included); ``dest_budgets_ref`` is the
    model's column maximum."""
    rng = np.random.RandomState(100 * n + q)
    dest = rng.randint(-1, n + 1, (n + 2, q)).astype(np.int32)
    if skewed:
        dest[:, : 3 * q // 4] = rng.randint(0, min(n, 2), (n + 2, 1))
    valid = rng.rand(n + 2, q) > 0.2
    valid[0] = False
    td, tv = torch.as_tensor(dest), torch.as_tensor(valid)
    tables = [np.stack([np.full(n, b), np.arange(n) * b]) for b in
              sorted({1, 3, q})]
    ragged = rng.randint(0, max(q, 1) + 2, n)
    tables.append(np.stack([ragged, np.cumsum(ragged) - ragged]))
    for tab in tables:
        total = int(tab[0].sum())
        want = _warp_model(dest, valid, tab[0], tab[1], total)
        got = route_plan_ref(td, tv, torch.as_tensor(tab.astype(np.int32)),
                             total=total)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b.numpy())
            assert b.dtype == torch.int32
        np.testing.assert_array_equal(
            dest_budgets_ref(td, tv, n).numpy(),
            want[3].max(axis=0) if len(dest) else np.zeros(n))
        np.testing.assert_array_equal(
            route_plan(td, tv, torch.as_tensor(tab.astype(np.int32)),
                       total=total)[0].numpy(), want[0])
    np.testing.assert_array_equal(dest_budgets(td, tv, n).numpy(),
                                  want[3].max(axis=0))


# ---------------------------------------------------------------------------
# dispatch and build: no quiet fallback
# ---------------------------------------------------------------------------
def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: the plain version is
    chosen by the dispatcher for CPU tensors, never by the wrapper."""
    with pytest.raises(ValueError, match="CUDA"):
        pack_chunks(torch.zeros((2, 2), dtype=torch.int32),
                    torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        dest_histogram2d(torch.zeros((2, 2), dtype=torch.int32), n_bins=3)


def test_route_plan_and_dest_budgets_wrappers_reject_cpu_tensors():
    """The planner's kernel wrappers take CUDA tensors only (dtype,
    contiguity and shape refusals on the card: test_torch_cuda.py); the
    entry points reject other devices."""
    dest = torch.zeros((2, 3), dtype=torch.int32)
    valid = torch.ones((2, 3), dtype=torch.bool)
    table = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        router_cuda.route_plan(dest, valid, table, total=0)
    with pytest.raises(ValueError, match="CUDA"):
        router_cuda.dest_budgets(dest, valid, 4)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        route_plan(dest.to(**meta), valid.to(**meta), table.to(**meta),
                   total=0)
    with pytest.raises(ValueError, match="unsupported device"):
        dest_budgets(dest.to(**meta), valid.to(**meta), 4)


def test_dest_histogram_wrapper_rejects_cpu_tensors_and_misuse():
    """Like ``dest_histogram2d``: CPU tensors, other dtypes and
    non-contiguous input raise; the entry point rejects other devices."""
    with pytest.raises(ValueError, match="CUDA"):
        dest_histogram(torch.zeros(4, dtype=torch.int32), n_bins=3)
    with pytest.raises(ValueError, match="unsupported device"):
        histogram_rows(torch.zeros(4, dtype=torch.int32, device="meta"),
                       n_bins=3)


def test_dispatch_rejects_other_devices():
    x = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_rows(x, torch.zeros(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        histogram_rows2d(x, n_bins=3)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler failure surfaces as an error with its output."""
    monkeypatch.setattr(kernels, "BUILD", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        kernels.build(["pack_chunks"])
    assert not list(tmp_path.glob("*.so"))


def test_library_names_follow_the_source():
    for name in kernels.KERNELS:
        p = kernels.library_path(name)
        assert p.parent == kernels.BUILD and p.name.startswith(f"lib{name}-")
        assert (kernels.CSRC / f"{name}.cu").is_file()
