"""qwen1.5-110b — dense decoder LM [hf:Qwen/Qwen1.5-* family; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, SwiGLU, QKV bias.
The largest assigned cell; exercises FSDP+TP sharding in the reference
(a copy of ``repro.configs.qwen1_5_110b``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    source="hf:Qwen/Qwen1.5-110B; hf",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    mlp_type="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    attention_kind="full",
    shard_heads=True,
))
