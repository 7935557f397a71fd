"""Architecture configs the port can build (one module per arch) and the
shape registry."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, ShapeConfig,  # noqa: F401
                                      all_configs, get_config, register)
from repro_torch.configs.shapes import (ALL_SHAPES,  # noqa: F401
                                        applicable_shapes, shape_applicable,
                                        skip_reason)

_ARCH_MODULES = ("gemma_7b", "minitron_8b", "qwen1_5_110b", "gemma3_1b",
                 "deepseek_v2_lite_16b", "moonshot_v1_16b_a3b", "qwen2_vl_2b",
                 "xlstm_125m", "hymba_1_5b", "whisper_base")

ARCH_NAMES = ("gemma-7b", "minitron-8b", "qwen1.5-110b", "gemma3-1b",
              "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "qwen2-vl-2b",
              "xlstm-125m", "hymba-1.5b", "whisper-base")


def load_all() -> None:
    """Import every config module (each registers its config)."""
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
