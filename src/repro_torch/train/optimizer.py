"""AdamW with the reference's schedule and global-norm clip (twin of
``repro.train.optimizer``).

Written out rather than ``torch.optim.AdamW``, which has neither the
warmup-cosine schedule nor the global-norm clip, and updates in place: here
``update`` returns new tensors and leaves its inputs untouched, so a step
can be redone from the same state (the loop's straggler redo relies on it).
Weight decay applies to every leaf, norms and the embedding included, as
in the reference.  Schedule scalars are float32 tensors, as in JAX.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.param import (build_tree, get_path, iter_leaves,
                                      map_tree)


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamW:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1

    # ---- schedule -----------------------------------------------------------
    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup, then cosine decay to ``min_lr_frac`` (float32)."""
        s = step.to(torch.float32)
        warm = s / max(1, self.warmup_steps)
        prog = torch.clamp((s - self.warmup_steps) /
                           max(1, self.total_steps - self.warmup_steps),
                           0.0, 1.0)
        cos = self.min_lr_frac + (1 - self.min_lr_frac) * \
            0.5 * (1 + torch.cos(math.pi * prog))
        return self.learning_rate * torch.minimum(warm, cos)

    # ---- state --------------------------------------------------------------
    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = next(t for _, t in iter_leaves(params)).device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          map_tree(zeros, params), map_tree(zeros, params))

    def abstract_state(self, abstract_params) -> AdamWState:
        """``init``'s shapes and dtypes as meta tensors: float32 moments,
        an int32 step."""
        def zeros(p):
            return torch.empty(p.shape, dtype=torch.float32, device="meta")
        return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                          map_tree(zeros, abstract_params),
                          map_tree(zeros, abstract_params))

    def state_axes(self, param_axes) -> AdamWState:
        """Logical axes of the optimizer state (the moments mirror the
        params; the step is a scalar)."""
        return AdamWState((), param_axes, map_tree(lambda a: a, param_axes))

    # ---- update -------------------------------------------------------------
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, dict]:
        """(updates, new state, metrics); nothing given is modified."""
        leaves = [g for _, g in iter_leaves(grads)]
        gsq = sum(g.float().square().sum() for g in leaves)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = self.lr_at(step)
        sf = step.to(torch.float32)
        b1c = 1 - torch.pow(self.b1, sf)      # float32, as b1 ** f32 in JAX
        b2c = 1 - torch.pow(self.b2, sf)

        def upd(g, m, v, p):
            g = g.float() * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g.square()
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            delta = delta + self.weight_decay * p.float()
            return (-lr * delta).to(p.dtype), m, v

        out = {path: upd(g, *(get_path(t, path) for t in
                                  (state.mu, state.nu, params)))
               for path, g in iter_leaves(grads)}
        updates = build_tree(grads, lambda path: out[path][0])
        mu = build_tree(grads, lambda path: out[path][1])
        nu = build_tree(grads, lambda path: out[path][2])
        return updates, AdamWState(step, mu, nu), {"grad_norm": gnorm,
                                                   "lr": lr}


def apply_updates(params, updates):
    """New parameters ``p + u`` (out of place)."""
    return build_tree(params, lambda path: get_path(params, path) +
                      get_path(updates, path).to(get_path(params, path).dtype))
