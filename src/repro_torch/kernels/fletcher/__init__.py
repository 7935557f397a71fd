from repro_torch.kernels.fletcher.ops import chunk_checksums  # noqa: F401
