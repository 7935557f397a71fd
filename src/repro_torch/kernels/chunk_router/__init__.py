from repro_torch.kernels.chunk_router.ops import (  # noqa: F401
    histogram_rows, histogram_rows2d)
