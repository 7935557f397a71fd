"""Model registry: build the port's model class for a config (twin of
``repro.models.registry``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig):
    """The dense decoder LM, for every dense config (gemma3-1b, gemma-7b,
    minitron-8b, qwen1.5-110b); other families are not ported yet."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet: ROADMAP Queue 1 "
        f"item 'the remaining model families'")
