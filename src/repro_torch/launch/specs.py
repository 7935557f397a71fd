"""Meta-tensor inputs and their logical axes for every (arch × shape) (twin
of ``repro.launch.specs``).

``input_specs`` returns (args, arg_axes) trees for the production step of
the given shape kind:

* train_*    → train_step(params, opt_state, batch)
* prefill_*  → prefill_step(params, batch)
* decode_* / long_* → serve_step(params, cache, tokens, cache_len)

No memory is allocated: every tensor is on the meta device, and the
logical-axes trees map onto a mesh through ``distributed.sharding``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamW

VLM_PATCHES = {"train_4k": 256, "prefill_32k": 1024, "decode_32k": 1024}


def serving_config(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Training/prefill batch meta tensors + logical axes."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32)}
    axes = {"tokens": ("batch", None)}
    if shape.kind == "train":
        batch["targets"] = _meta((B, S), torch.int32)
        axes["targets"] = ("batch", None)
    if cfg.family == "vlm":
        npatch = VLM_PATCHES.get(shape.name, 256)
        batch["patch_embeds"] = _meta((B, npatch, cfg.d_model),
                                      torch.bfloat16)
        axes["patch_embeds"] = ("batch", None, "embed")
        batch["mrope_positions"] = _meta((3, B, S), torch.int32)
        axes["mrope_positions"] = (None, "batch", None)
    if cfg.family == "audio":
        batch["audio_embeds"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                      torch.float32)
        axes["audio_embeds"] = ("batch", None, "embed")
    return batch, axes


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                optimizer: AdamW = None) -> Tuple[tuple, tuple]:
    """Returns (args, arg_axes) for the step function of this shape."""
    if shape.kind == "train":
        model = build_model(cfg)
        params = model.abstract_params()
        p_axes = model.param_axes()
        optimizer = optimizer or AdamW()
        opt = optimizer.abstract_state(params)
        o_axes = optimizer.state_axes(p_axes)
        batch, b_axes = batch_specs(cfg, shape)
        return (params, opt, batch), (p_axes, o_axes, b_axes)

    scfg = serving_config(cfg)
    model = build_model(scfg)
    params = model.abstract_params()
    p_axes = model.param_axes()
    if shape.kind == "prefill":
        batch, b_axes = batch_specs(scfg, shape)
        return (params, batch), (p_axes, b_axes)

    # decode / long_decode: one new token against a cache of seq_len
    B, S = shape.global_batch, shape.seq_len
    max_len = S + getattr(scfg, "num_meta_tokens", 0)
    cache = model.abstract_cache(B, max_len)
    c_axes = model.cache_axes(B, max_len)
    tokens = _meta((B, 1), torch.int32)
    cache_len = _meta((), torch.int32)
    return ((params, cache, tokens, cache_len),
            (p_axes, c_axes, ("batch", None), ()))


def step_fn_for(cfg: ModelConfig, shape: ShapeConfig,
                optimizer: AdamW = None, microbatches: int = 1):
    """The port's production step for this shape kind."""
    from repro_torch.train.train_step import (make_prefill_step,
                                              make_serve_step,
                                              make_train_step)
    if shape.kind == "train":
        model = build_model(cfg)
        return make_train_step(model, optimizer or AdamW(),
                               microbatches=microbatches)
    model = build_model(serving_config(cfg))
    if shape.kind == "prefill":
        return make_prefill_step(model)
    return make_serve_step(model)
