"""Assigned input shapes (paper-pool spec; a copy of
``repro.configs.shapes``).

``decode_32k`` / ``long_500k`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), NOT ``train_step``.  ``long_500k`` is only runnable for
sub-quadratic architectures (gemma3-1b local:global, xlstm-125m, hymba-1.5b);
pure full-attention archs skip it (see DESIGN.md §5).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig, ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="long_decode")

ALL_SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

# architectures with a sub-quadratic decode path (SSM / sliding-window majority)
SUBQUADRATIC_ARCHS = {"gemma3-1b", "xlstm-125m", "hymba-1.5b"}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether a (arch, shape) cell is runnable (vs a documented skip)."""
    if shape.kind == "long_decode":
        return cfg.name in SUBQUADRATIC_ARCHS
    return True


def applicable_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    return [s for s in ALL_SHAPES.values() if shape_applicable(cfg, s)]


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    if shape_applicable(cfg, shape):
        return ""
    return ("pure full-attention architecture: long_500k requires a "
            "sub-quadratic attention path (DESIGN.md §5)")
