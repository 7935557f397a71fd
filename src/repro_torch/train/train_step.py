"""The step factories (twin of ``repro.train.train_step``): training, and
the serving steps, prefill and one-token decode."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.param import (build_tree, get_path, iter_leaves,
                                      map_tree)
from repro_torch.train.optimizer import AdamW, AdamWState, apply_updates


def _value_and_grad(model, params, batch):
    """(grads, metrics) of ``model.loss_fn`` at ``params``.  The leaves are
    detached aliases, so ``params`` itself is neither modified nor made
    part of a graph."""
    leaves = map_tree(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss_fn(leaves, batch)
    paths, flat = zip(*iter_leaves(leaves))
    by_path = dict(zip(paths, torch.autograd.grad(loss, flat)))
    return (build_tree(leaves, by_path.__getitem__),
            {k: v.detach() for k, v in metrics.items()})


def _batch_slice(name: str, v: torch.Tensor, i: int, n: int):
    """The i-th of n equal slices of one batch input along its batch axis
    (the second of ``mrope_positions``, the first of the others)."""
    axis = 1 if name == "mrope_positions" else 0
    size = v.shape[axis] // n
    return v.narrow(axis, i * size, size)


def make_train_step(model, optimizer: AdamW, compressor=None,
                    microbatches: int = 1) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, a pure function of its arguments: it returns new tensors
    and modifies none it is given.

    ``compressor`` is applied to the gradients before the optimizer as the
    reference applies it, ``compressor(grads)``; both compressors of
    ``distributed/compression.py`` take ``(grads, residual)``, so either
    raises ``TypeError`` there, in both packages (ROADMAP 3b).

    ``microbatches > 1`` accumulates float32 gradients over equal batch
    slices in order and averages them; the metrics are the last slice's
    (``loss_fn``'s: the loss with the MoE aux loss added, ``aux_loss``,
    ``ce``, ``z_loss``), with the optimizer's.  A VLM batch's
    ``mrope_positions`` (3, B, S) are sliced on their batch axis (the
    reference slices every input on its first axis, ROADMAP 3b).
    """

    def grads_of(params, batch):
        if microbatches == 1:
            return _value_and_grad(model, params, batch)
        acc = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        metrics = None
        for i in range(microbatches):
            mb = {k: _batch_slice(k, v, i, microbatches)
                  for k, v in batch.items()}
            g, metrics = _value_and_grad(model, params, mb)
            acc = build_tree(acc, lambda path: get_path(acc, path) +
                             get_path(g, path))
        return map_tree(lambda a: a / microbatches, acc), metrics

    def train_step(params, opt_state: AdamWState, batch):
        grads, metrics = grads_of(params, batch)
        if compressor is not None:
            grads = compressor(grads)
        updates, opt_state, opt_metrics = optimizer.update(
            grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(model) -> Callable:
    """Full-sequence forward (inference-prefill shapes): returns the
    last-position logits (B, V), as the reference's step keeps
    ``logits[:, -1]`` (here only that row is unembedded).  A VLM batch
    carries its ``patch_embeds`` and ``mrope_positions`` beside the
    tokens, as the reference's does."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.last_logits(params, batch)

    return prefill_step


def make_serve_step(model) -> Callable:
    """One-token decode against a KV cache (decode/long-context shapes):
    ``serve_step(params, cache, tokens, cache_len) -> (next_tok (B,)
    int32, cache)``, the greedy token (the first of equal maxima, as
    ``jnp.argmax``) and the cache, written in place."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, cache_len):
        logits, cache = model.decode_step(params, cache, tokens, cache_len)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache

    return serve_step
