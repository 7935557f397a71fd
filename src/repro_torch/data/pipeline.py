"""Deterministic synthetic token pipeline with BB staging (a copy of
``repro.data.pipeline``: the same numpy ``RandomState`` draws, so the
batches are bit-identical).

Production shape: the data loader stages shard files through the burst
buffer (N-N reads of pre-shuffled shards — the intent pipeline classifies
this as read-dominant sequential, landing on a global layout).  Offline we
synthesize deterministic Zipf-ish token streams per (epoch, host, step) so
elastic restarts replay exactly: the pipeline is a pure function of its
cursor, which rides in the checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class PipelineState:
    epoch: int = 0
    step: int = 0


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.state = PipelineState()

    def _rng_for(self, epoch: int, step: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 7919 + step * 131 +
             self.host_id) % (2 ** 31))

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng_for(self.state.epoch, self.state.step)
        self.state.step += 1
        V = self.cfg.vocab_size
        B = self.batch // self.n_hosts
        # zipf-ish marginal over the vocab, cheap + deterministic
        u = rng.random_sample((B, self.seq_len + 1))
        toks = np.minimum((u ** 3.5) * V, V - 1).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.family == "vlm":
            npatch = min(256, self.seq_len // 4)
            batch["patch_embeds"] = rng.standard_normal(
                (B, npatch, self.cfg.d_model)).astype(np.float32) * 0.02
            pos = np.arange(self.seq_len, dtype=np.int32)
            batch["mrope_positions"] = np.broadcast_to(
                pos, (3, B, self.seq_len)).copy()
        if self.cfg.family == "audio":
            batch["audio_embeds"] = rng.standard_normal(
                (B, self.cfg.encoder_seq, self.cfg.d_model)
            ).astype(np.float32) * 0.05
        return batch

    # ---- checkpointable cursor ---------------------------------------------
    def cursor(self) -> Tuple[int, int]:
        return (self.state.epoch, self.state.step)

    def restore_cursor(self, cursor: Tuple[int, int]) -> None:
        self.state = PipelineState(*cursor)
