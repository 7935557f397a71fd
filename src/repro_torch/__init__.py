"""Proteus burst buffer in PyTorch, with hand-written CUDA kernels.

The PyTorch/CUDA twin of the JAX package ``repro``: the same stacked
burst-buffer engine (``core/``), driven by the same ``BBClient`` facade, and
fault-tolerant training (``train/``, ``models/``, ``data/``, ``configs/``)
with Proteus checkpoints (``checkpoint/``), with the kernels of both paths
written by hand for Hopper (``kernels/``, sources in ``csrc/``).  It
imports ``torch``, numpy and the standard library only: whatever
pure-numpy code it shares with ``repro`` is kept as its own copy.

Tables and train state live on the CUDA card unless the caller names
another device
(``device="cpu"`` runs the plain PyTorch version of every kernel, which is
how the tests hold the port against the JAX package).  With no device given
and no card present, the entry points raise instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device the port's tables live on: CUDA unless ``device`` is given.

    Raises ``RuntimeError`` when no device is given and no CUDA card is
    present — the port never falls back to the CPU on its own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
