"""Model registry: build the port's model class for a config (twin of
``repro.models.registry``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, **kw):
    """The decoder LM for the dense, MoE and VLM families (``kw``: the
    ``TransformerLM`` constructor's, ``moe_impl``), xLSTM for ``ssm``,
    Hymba for ``hybrid`` and the encoder-decoder for ``audio``."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg, **kw)
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import XLSTMModel
        return XLSTMModel(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hymba import HymbaModel
        return HymbaModel(cfg)
    if cfg.family == "audio":
        from repro_torch.models.encdec import EncDecModel
        return EncDecModel(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
