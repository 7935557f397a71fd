"""hymba-1.5b — hybrid parallel attention + mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each layer runs attention heads and mamba (SSM) heads in PARALLEL on the same
input projection and fuses outputs (mean of per-path RMS-normed outputs).
Sliding-window attention (1024) everywhere except 3 full-attention layers
{0, 15, 31}; 128 learnable meta tokens are prepended to the KV stream.
Sub-quadratic (SWA + SSM) => runs the long_500k cell.
A copy of ``repro.configs.hymba_1_5b``.
"""
from repro_torch.configs.base import ModelConfig, register

_PATTERN = tuple(
    ("global" if i in (0, 15, 31) else "swa") for i in range(32)
)

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676; hf",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    mlp_type="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    attention_kind="swa",
    window_size=1024,
    layer_kinds=_PATTERN,
    ssm_state=16,
    conv_kernel=4,
    num_meta_tokens=128,
    shard_heads=False,  # 25 heads; shard ffn/vocab
))
