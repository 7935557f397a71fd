"""End-to-end driver: train a ~100M-param LM for a few hundred steps with
Proteus-backed fault-tolerant checkpointing, random failures injected (twin
of the JAX package's ``examples/train_lm.py``, same arguments and prints),
on the CUDA card unless ``--device`` says otherwise.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
      (``--device cpu`` for the plain PyTorch path)
The default config is xlstm-125m, reduced, at a short sequence length;
pass --arch/--batch/--seq to scale.  Checkpoint manifests go to
``--ckpt-dir``; without one, to a temporary directory that the run removes.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.configs import all_configs
from repro_torch.core.intent.selector import select_layout
from repro_torch.core.workloads import workload_by_name
from repro_torch.models.registry import build_model
from repro_torch.train.failure import FailurePlan
from repro_torch.train.loop import LoopConfig, LoopResult, run_training
from repro_torch.train.optimizer import AdamW


def main(argv: Optional[list] = None) -> LoopResult:
    """Decide the checkpoint layout, train under a random failure plan,
    print the four lines of the reference's example and return the loop's
    result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fail-rate", type=float, default=0.02)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint manifests (default: a temporary "
                         "directory)")
    ap.add_argument("--device", default=None,
                    help="where the train state lives (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)

    cfg = all_configs()[args.arch].reduced()
    model = build_model(cfg)
    decision = select_layout(workload_by_name("IOR-A"))   # checkpoint profile
    print(f"[proteus] checkpoint layout: Mode {int(decision.mode)} "
          f"(conf {decision.confidence:.2f})")

    plan = FailurePlan.random_plan(args.steps, args.fail_rate, seed=1)
    print(f"[failure-plan] {len(plan.events)} injected events: "
          f"{dict(list(plan.events.items())[:5])}…")
    t0 = time.time()
    res = run_training(
        model, cfg, args.batch, args.seq,
        LoopConfig(steps=args.steps, ckpt_every=20, ckpt_dir=args.ckpt_dir,
                   layout_mode=decision.mode),
        optimizer=AdamW(learning_rate=1e-3, warmup_steps=args.steps // 10,
                        total_steps=args.steps),
        failure_plan=plan, device=args.device)
    dt = time.time() - t0
    fl = res.failure_log
    print(f"[train] {res.final_step} steps in {dt:.0f}s; "
          f"loss {res.losses[0]:.3f} → {res.losses[-1]:.3f}")
    print(f"[train] survived: {fl.crashes} crashes, {fl.stragglers} "
          f"stragglers, {fl.corruptions} corruptions "
          f"({fl.restores} restores, {fl.fallback_restores} checksum "
          f"fallbacks)")
    return res


if __name__ == "__main__":
    main()
