"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356].

6L enc + 6L dec, d_model=512 8H (MHA) d_ff=2048 vocab=51865.  Per assigned
spec the conv frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (B, 1500, 512).  Decoder cross-attends to the encoder
output; decode shapes lower the decoder serve_step.
A copy of ``repro.configs.whisper_base``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="audio",
    source="arXiv:2212.04356; unverified",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    encoder_seq=1500,        # 30 s of audio at 50 Hz post-conv (stub embeddings)
    cross_attention=True,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp_type="gelu",
    qkv_bias=True,
    tie_embeddings=True,
    attention_kind="full",
    shard_heads=False,   # 8 heads < model axis
    scan_layers=False,   # 6+6 small layers; unrolled
))
