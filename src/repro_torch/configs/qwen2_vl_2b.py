"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, QKV bias.
Per assigned spec the vision frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings; M-RoPE position ids (temporal/height/width
sections) are model inputs (a copy of ``repro.configs.qwen2_vl_2b``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    source="arXiv:2409.12191; hf",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mlp_type="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    attention_kind="full",
    mrope=True,
    mrope_sections=(16, 24, 24),  # temporal/height/width rotary sections (sum=64=hd/2)
    shard_heads=False,  # 12 heads not divisible by 16; shard ffn/vocab
))
