"""The port's hand-written kernels on a CUDA card (marker ``cuda``): each
held against its plain PyTorch version, bit for bit, with its launch count.
Imports nothing of JAX, so it runs on the card:
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Skips elsewhere."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.chunk_pack.chunk_pack import PACK_CHUNKS, pack_chunks
from repro_torch.kernels.chunk_pack.ops import gather_rows
from repro_torch.kernels.chunk_pack.ref import pack_chunks_ref
from repro_torch.kernels.chunk_router.chunk_router import DEST_HISTOGRAM2D
from repro_torch.kernels.chunk_router.ops import histogram_rows2d
from repro_torch.kernels.chunk_router.ref import dest_histogram2d_ref

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
