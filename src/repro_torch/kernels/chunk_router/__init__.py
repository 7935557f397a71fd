from repro_torch.kernels.chunk_router.ops import histogram_rows2d  # noqa: F401
