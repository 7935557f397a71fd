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
from repro_torch.kernels.chunk_router.chunk_router import (dest_histogram,
                                                          dest_histogram2d)
from repro_torch.kernels.chunk_router.ops import (histogram_rows,
                                                  histogram_rows2d)
from repro_torch.kernels.chunk_router.ref import (dest_histogram2d_ref,
                                                  dest_histogram_ref)

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
