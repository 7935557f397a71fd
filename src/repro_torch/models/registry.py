"""Model registry: build the port's model class for a config (twin of
``repro.models.registry``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, **kw):
    """The decoder LM for the dense, MoE and VLM families (``kw``: the
    ``TransformerLM`` constructor's, ``moe_impl``); the SSM, hybrid and
    audio families are not ported yet."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg, **kw)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet: ROADMAP Queue 1 "
        f"item 'the remaining model families'")
