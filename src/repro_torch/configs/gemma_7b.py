"""gemma-7b — dense decoder LM [arXiv:2403.08295; hf].

28L d_model=3072 16H (GQA kv=16 == MHA at 7B) d_ff=24576 vocab=256000,
GeGLU, head_dim=256 (q_dim 4096 != d_model), tied embeddings scaled by
sqrt(d_model) (a copy of ``repro.configs.gemma_7b``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b",
    family="dense",
    source="arXiv:2403.08295; hf",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
    attention_kind="full",
    shard_heads=True,   # 16 heads == model axis
))
