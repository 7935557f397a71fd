"""Fault-tolerant training loop (twin of ``repro.train.loop``).

Wires together: model + optimizer + deterministic data pipeline +
Proteus-backed checkpointing + the failure policy.  The loop survives
crashes (restore + cursor replay), stragglers (deterministic redo) and
checkpoint corruption (checksum fallback), with the reference's semantics
event for event, so the same ``FailurePlan`` gives the same ``FailureLog``.

The train state lives on the card unless ``device`` is given; its
checkpoints are checksummed and routed there (``CheckpointManager``).
``LoopConfig.adapt_controller`` ticks an ``AdaptationController`` on the
step cadence; when a tick adopts a new per-scope plan, the checkpoint
manager follows it.
"""
from __future__ import annotations

import contextlib
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import obs
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.train.failure import FailureLog, FailurePlan
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step


@dataclass
class LoopConfig:
    steps: int = 20
    ckpt_every: int = 5
    # manifest directory; None → a temporary directory for the run
    ckpt_dir: Optional[str] = None
    layout_mode: LayoutMode = LayoutMode.NODE_LOCAL  # N-N checkpoint default
    # full per-scope plan; overrides layout_mode/n_bb_nodes when set
    layout_policy: Optional[LayoutPolicy] = None
    n_bb_nodes: int = 8
    microbatches: int = 1
    # online adaptation (repro_torch.core.adapt): an AdaptationController
    # whose tick() runs every adapt_every steps; when it adopts a new
    # per-scope plan, the checkpoint manager follows it (set_policy)
    adapt_controller: Optional[object] = None
    adapt_every: int = 0

    @property
    def bb_policy(self) -> LayoutPolicy:
        return self.layout_policy or LayoutPolicy.uniform(
            self.layout_mode, self.n_bb_nodes)


@dataclass
class LoopResult:
    losses: List[float] = field(default_factory=list)
    final_step: int = 0
    failure_log: FailureLog = field(default_factory=FailureLog)
    # the train state at the end: (params, opt_state, cursor)
    state: Optional[tuple] = None


def _cursor(pipeline: TokenPipeline, device) -> torch.Tensor:
    return torch.tensor(pipeline.cursor(), dtype=torch.int32, device=device)


def run_training(model, cfg, batch_size: int, seq_len: int,
                 loop_cfg: LoopConfig, optimizer: Optional[AdamW] = None,
                 failure_plan: Optional[FailurePlan] = None,
                 seed: int = 0, device=None) -> LoopResult:
    dev = resolve_device(device)
    optimizer = optimizer or AdamW(warmup_steps=5, total_steps=loop_cfg.steps)
    failure_plan = failure_plan or FailurePlan()
    log = FailureLog()

    params = model.init(seed, dev)
    opt_state = optimizer.init(params)
    pipeline = TokenPipeline(cfg, batch_size, seq_len, seed=seed)
    train_step = make_train_step(model, optimizer,
                                 microbatches=loop_cfg.microbatches)
    with contextlib.ExitStack() as stack:
        ckpt_dir = loop_cfg.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_"))
        ckpt = CheckpointManager(ckpt_dir, loop_cfg.bb_policy,
                                 async_save=True, device=dev)
        result = LoopResult()
        step = 0
        while step < loop_cfg.steps:
            event = failure_plan.at(step)

            if event == "crash":
                log.crashes += 1
                failure_plan.events.pop(step, None)  # the node came back up
                # host dies: in-memory state is gone → restore newest ckpt
                ckpt.wait()
                restored = _restore_latest(
                    ckpt, (params, opt_state,
                           torch.zeros((2,), dtype=torch.int32, device=dev)),
                    log)
                if restored is not None:
                    (params, opt_state, cursor), ck_step = restored
                    pipeline.restore_cursor(tuple(int(c) for c in
                                                  cursor.tolist()))
                    step = ck_step
                    log.restores += 1
                else:  # no checkpoint yet: cold restart
                    params = model.init(seed, dev)
                    opt_state = optimizer.init(params)
                    pipeline.restore_cursor((0, 0))
                    step = 0
                continue

            if event == "corrupt_ckpt":
                log.corruptions += 1
                _corrupt_newest_chunk(ckpt)

            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in pipeline.next_batch().items()}
            params2, opt2, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])

            if event == "straggler":
                # deadline exceeded: deterministic redo of the same step
                # (the first result is dropped before the redo runs)
                log.stragglers += 1
                log.redone_steps.append(step)
                del params2, opt2
                params2, opt2, metrics2 = train_step(params, opt_state,
                                                     batch)
                redo_loss = float(metrics2["loss"])
                if abs(redo_loss - loss) >= 1e-5:
                    raise AssertionError("redo must be deterministic: "
                                         f"{loss} then {redo_loss}")
                loss = redo_loss

            params, opt_state = params2, opt2
            del params2, opt2
            result.losses.append(loss)
            step += 1

            if step % loop_cfg.ckpt_every == 0:
                ckpt.save(step, (params, opt_state, _cursor(pipeline, dev)))

            ctl = loop_cfg.adapt_controller
            if ctl is not None and loop_cfg.adapt_every and \
                    step % loop_cfg.adapt_every == 0:
                # drift-tick span on the adapting client's recorder (if any)
                with obs.activate(getattr(ctl.client, "obs", None)), \
                        obs.span("train.adapt_tick", cat="train", step=step):
                    report = ctl.tick()
                if report.phase in ("adopted", "completed"):
                    # checkpoint traffic follows the adapted per-scope plan
                    ckpt.set_policy(ctl.client.policy)
        ckpt.wait()
    result.final_step = step
    result.failure_log = log
    result.state = (params, opt_state, _cursor(pipeline, dev))
    return result


def _ckpt_steps(ckpt: CheckpointManager) -> List[int]:
    return sorted({int(p.stem.split("_")[1])
                   for p in ckpt.dir.glob("ckpt_*.json")}, reverse=True)


def _restore_latest(ckpt: CheckpointManager, like_state, log: FailureLog):
    """Restore the newest checkpoint, falling back past corrupted ones."""
    for s in _ckpt_steps(ckpt):
        try:
            return ckpt.restore(s, like_state, verify=True)
        except IOError:
            log.fallback_restores += 1
    return None


def _corrupt_newest_chunk(ckpt: CheckpointManager) -> None:
    """Bit-flip one stored chunk (fault injection).  As in the reference,
    this is the first chunk of the first non-empty node — the oldest stored
    chunk there, not necessarily the newest checkpoint's (ROADMAP Queue 3)."""
    ckpt.wait()
    if not _ckpt_steps(ckpt):
        return
    for node in ckpt.store.nodes:
        for key, raw in list(node.items()):
            if len(raw) >= 4:
                b = bytearray(raw)
                b[0] ^= 0xFF
                node[key] = bytes(b)
                return
