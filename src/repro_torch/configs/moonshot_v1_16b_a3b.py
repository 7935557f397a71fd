"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — MoE LM [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) expert d_ff=1408, MoE 64 routed top-6 +
2 shared experts, first layer dense, vocab=163840.  Standard GQA attention
(no MLA) per assigned spec (a copy of ``repro.configs.moonshot_v1_16b_a3b``).
"""
from repro_torch.configs.base import ModelConfig, register

_PATTERN = tuple("dense" if i == 0 else "moe" for i in range(48))

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=11264,        # dense (first) layer FFN = 8x expert width
    vocab_size=163840,
    mlp_type="swiglu",
    tie_embeddings=False,
    rope_theta=50_000.0,
    attention_kind="full",
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
    layer_kinds=_PATTERN,
    shard_heads=True,
))
