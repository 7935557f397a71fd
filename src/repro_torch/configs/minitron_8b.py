"""minitron-8b — width-pruned Nemotron-4 [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.  Nemotron family:
squared-ReLU MLP (no gate), untied embeddings (a copy of ``repro.configs.minitron_8b``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    source="arXiv:2407.14679; hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="relu2",
    tie_embeddings=False,
    rope_theta=10_000.0,
    attention_kind="full",
    shard_heads=True,
))
