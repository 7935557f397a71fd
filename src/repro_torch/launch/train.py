"""End-to-end training driver (twin of ``repro.launch.train``).

Selects the burst-buffer layout for the job's checkpoint/data profile via
the Proteus intent pipeline, then runs the fault-tolerant loop.  The
``--reduced`` flag (default) shrinks the architecture so a few hundred
steps finish in minutes; ``--full`` trains the published width.  The train
state lives on the CUDA card unless ``--device`` names another device
(``--device cpu`` runs the kernels' plain versions).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 4 \\
      --ckpt-every 2 --batch 4 --seq 1024

Checkpoint manifests go to ``--ckpt-dir``; without one, to a temporary
directory that the run removes.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

from repro_torch.configs import all_configs
from repro_torch.core.intent.selector import select_layout
from repro_torch.core.workloads import workload_by_name
from repro_torch.models.registry import build_model
from repro_torch.train.failure import FailurePlan
from repro_torch.train.loop import LoopConfig, LoopResult, run_training
from repro_torch.train.optimizer import AdamW


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-rate", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="where the train state lives (default: cuda)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> LoopResult:
    """Decide the layout, train, print the three ``[train]`` lines and
    return the loop's result."""
    args = parse_args(argv)
    cfg = all_configs()[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)

    # Proteus: pick the BB layout for this job's I/O intent.  A training job's
    # dominant I/O is its independent N-N checkpoint burst — we feed the
    # matching workload profile through the full pipeline.
    decision = select_layout(workload_by_name("IOR-A"))
    print(f"[train] Proteus layout decision: Mode {int(decision.mode)} "
          f"(confidence {decision.confidence:.2f}) — "
          f"{decision.decision.steps[-1]}", flush=True)

    loop_cfg = LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir,
                          layout_mode=decision.mode)
    plan = (FailurePlan.random_plan(args.steps, args.fail_rate)
            if args.fail_rate else FailurePlan())
    optimizer = AdamW(learning_rate=args.lr, warmup_steps=args.steps // 10,
                      total_steps=args.steps)

    t0 = time.time()
    res = run_training(model, cfg, args.batch, args.seq, loop_cfg,
                       optimizer=optimizer, failure_plan=plan,
                       device=args.device)
    dt = time.time() - t0
    print(f"[train] {res.final_step} steps in {dt:.1f}s "
          f"({res.final_step / dt:.2f} steps/s)")
    print(f"[train] loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}")
    fl = res.failure_log
    print(f"[train] failures: crashes={fl.crashes} "
          f"stragglers={fl.stragglers} corruptions={fl.corruptions} "
          f"restores={fl.restores} fallbacks={fl.fallback_restores}",
          flush=True)
    return res


if __name__ == "__main__":
    main()
