"""Architecture configs the port can build (one module per arch)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, all_configs,  # noqa: F401
                                      register)

_ARCH_MODULES = ("gemma3_1b",)


def load_all() -> None:
    """Import every config module (each registers its config)."""
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
