"""gemma3-1b — dense LM with 5:1 local:global attention [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, GeGLU, head_dim=256,
sliding window 512 on local layers, every 6th layer global (a copy of
``repro.configs.gemma3_1b``).
"""
from repro_torch.configs.base import ModelConfig, register

_PATTERN = tuple(
    ("global" if (i + 1) % 6 == 0 else "local") for i in range(26)
)

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt; unverified",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    mlp_type="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=1_000_000.0,
    attention_kind="local_global",
    window_size=512,
    layer_kinds=_PATTERN,
    shard_heads=False,
))
