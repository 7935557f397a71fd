"""Target-hardware constants: one NVIDIA H100 SXM (80 GB HBM3, 700 W;
NVIDIA's data sheet), the card the port runs on."""
import torch

PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12              # bytes/s per card
NVLINK_BW = 450e9             # bytes/s per card, each way

DTYPE_BYTES = {
    torch.float64: 8, torch.int64: 8, torch.complex64: 8,
    torch.float32: 4, torch.int32: 4, torch.uint32: 4,
    torch.bfloat16: 2, torch.float16: 2, torch.int16: 2, torch.uint16: 2,
    torch.int8: 1, torch.uint8: 1, torch.bool: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}
