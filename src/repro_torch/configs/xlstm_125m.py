"""xlstm-125m — sLSTM + mLSTM block stack [arXiv:2405.04517].

12L d_model=768 4H vocab=50304, d_ff=0 (projections live inside the blocks;
mLSTM up-projects by proj_factor=2).  xLSTM[7:1]-style mix: sLSTM blocks at
positions {3, 9}, mLSTM elsewhere.  Recurrent O(1) state per token =>
runs the long_500k cell.
A copy of ``repro.configs.xlstm_125m``.
"""
from repro_torch.configs.base import ModelConfig, register

_PATTERN = tuple("slstm" if i in (3, 9) else "mlstm" for i in range(12))

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517; unverified",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,      # inner dim (768*2)/4/2 per q/k head at proj_factor 2
    d_ff=0,
    vocab_size=50304,
    mlp_type="gelu",
    tie_embeddings=True,
    attention_kind="full",   # unused; blocks are recurrent
    layer_kinds=_PATTERN,
    proj_factor=2.0,
    conv_kernel=4,
    shard_heads=False,
    scan_layers=False,  # 12 mixed-kind layers; unrolled stack compiles fast
))
