"""Quickstart: the whole Proteus story in one minute (twin of the JAX
package's ``examples/quickstart.py``, same prints, same sizes).

1. A job arrives (HPC workload with source + launch script).
2. Proteus extracts static intent, runs one probe, reasons over the KB,
   and picks a burst-buffer layout (with the full Fig-6 prompt attached).
3. The decision becomes a LayoutPolicy driving the real in-memory BB data
   plane through the BBClient facade — write/read a checkpoint through it,
   its tables on the card.
4. The calibrated performance model shows the speedup vs the fixed default.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      (``--device cpu`` for the plain PyTorch path)
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.core.client import BBClient
from repro_torch.core.intent.selector import select_layout
from repro_torch.core.layouts import DEFAULT_MODE
from repro_torch.core.simulator import simulate
from repro_torch.core.workloads import workload_by_name


def main(argv: Optional[list] = None) -> BBClient:
    """Run the quickstart; returns the client it wrote and read through."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the tables live (default: the CUDA card)")
    args = ap.parse_args(argv)

    # 1-2. decide the layout for an N-N checkpoint job (IOR -F profile)
    w = workload_by_name("IOR-A")
    decision = select_layout(w)
    print(f"workload: {w.name} — {w.description}")
    print(f"Proteus selected: Mode {int(decision.mode)} "
          f"({decision.mode.name}), confidence {decision.confidence:.2f}")
    print("reasoning trace:")
    for s in decision.decision.steps:
        print("   ·", s)

    # 3. run real I/O through the selected layout: the decision compiles to
    #    a LayoutPolicy and the BBClient facade hides all engine plumbing
    policy = decision.layout_policy(n_nodes=8)
    client = BBClient(policy, device=args.device, cap=128, words=16,
                      mcap=128)
    rng = np.random.RandomState(0)
    paths = [[f"/bb/ior_fpp/file.{r:08d}/seg{j}" for j in range(8)]
             for r in range(8)]
    req = client.encode(paths, chunk_id=rng.randint(0, 4, (8, 8)),
                        payload=rng.randint(0, 999, (8, 8, 16)))
    client.write(req)
    out, found = client.read(req)
    if not (bool(found.all()) and np.array_equal(
            out.cpu().numpy(), req.payload.cpu().numpy())):
        raise AssertionError("the checkpoint did not read back intact")
    print("\nBB engine: 64 chunks written + read back intact "
          f"under Mode {int(decision.mode)} ✓")

    # 4. what did the decision buy?
    t_sel = simulate(w, policy, w.n_nodes).total_s
    t_def = simulate(w, DEFAULT_MODE, w.n_nodes).total_s
    print(f"\nmodeled job time: {t_sel:.1f}s (selected) vs {t_def:.1f}s "
          f"(fixed default) → {t_def / t_sel:.2f}× speedup")
    return client


if __name__ == "__main__":
    main()
