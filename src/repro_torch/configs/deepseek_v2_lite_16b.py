"""deepseek-v2-lite-16b — MoE with MLA [arXiv:2405.04434; hf].

27L d_model=2048 16H, MLA kv_lora_rank=512 (qk_nope 128 / qk_rope 64 /
v_head 128), first layer dense (d_ff 10944), MoE layers: 64 routed experts
top-6 + 2 shared, expert d_ff=1408, vocab=102400 (a copy of
``repro.configs.deepseek_v2_lite_16b``).
"""
from repro_torch.configs.base import ModelConfig, register

_PATTERN = tuple("dense" if i == 0 else "moe" for i in range(27))

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434; hf",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,   # MLA: logical kv heads == q heads post up-projection
    head_dim=128,
    d_ff=10944,        # dense (first) layer FFN
    vocab_size=102400,
    mlp_type="swiglu",
    tie_embeddings=False,
    rope_theta=10_000.0,
    attention_kind="full",
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
    layer_kinds=_PATTERN,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    shard_heads=True,
))
