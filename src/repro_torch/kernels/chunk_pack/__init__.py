from repro_torch.kernels.chunk_pack.ops import (gather_rows,  # noqa: F401
                                                gather_rows_batched)
