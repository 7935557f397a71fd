"""Layout-heterogeneity demo (twin of the JAX package's
``examples/proteus_layout_demo.py``, same prints, same sizes): the same
23-workload matrix under all four layouts, the oracle, Proteus's decision,
and the realized speedups — the paper's Figure 12 on your terminal —
followed by the part a single mode cannot do: a heterogeneous job whose
per-scope ``LayoutPolicy`` beats every uniform layout, executed as one
interleaved mixed-mode batch on the real BB engine, its tables on the
card.

Run:  PYTHONPATH=src python -m repro_torch.examples.proteus_layout_demo
      (``--device cpu`` for the plain PyTorch path)
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.client import BBClient
from repro_torch.core.intent.oracle import oracle_mode, oracle_policy
from repro_torch.core.intent.selector import select_layout
from repro_torch.core.layouts import DEFAULT_MODE, LayoutMode
from repro_torch.core.simulator import simulate
from repro_torch.core.workloads import build_workloads, heterogeneous_workload


def single_mode_matrix() -> int:
    """Print the 23-workload table; returns Proteus's hits."""
    ws = build_workloads(32)
    hits = 0
    print(f"{'workload':10s} {'oracle':9s} {'proteus':9s} {'conf':>5s} "
          f"{'speedup':>8s}  verdict")
    for w in ws:
        orc = oracle_mode(w)
        d = select_layout(w)
        t_def = simulate(w, DEFAULT_MODE, w.n_nodes).total_s
        t_sel = simulate(w, d.mode, w.n_nodes).total_s
        ok = d.mode == orc
        hits += ok
        print(f"{w.name:10s} M{int(orc)}        M{int(d.mode)}       "
              f"{d.confidence:5.2f} {t_def / t_sel:7.2f}x  "
              f"{'✓' if ok else '✗ ' + d.decision.steps[-1][:48]}")
    print(f"\naccuracy: {hits}/{len(ws)} = {hits / len(ws) * 100:.2f}%  "
          f"(paper: 91.30%)")
    return hits


def heterogeneous_plan(device=None) -> dict:
    """One job, two scopes, no single-mode answer: the LayoutPolicy story.
    Returns the simulated times and the client of the mixed batch."""
    w = heterogeneous_workload(32)
    print(f"\n=== heterogeneous job: {w.description} ===")
    d = select_layout(w)
    print(f"Proteus plan: default M{int(d.mode)}, scopes "
          + ", ".join(f"{s} → M{int(m)}" for s, m in d.scope_modes.items()))
    policy = d.layout_policy(w.n_nodes)

    times = {f"uniform M{int(m)}": simulate(w, m, w.n_nodes).total_s
             for m in LayoutMode}
    times["per-scope policy"] = simulate(w, policy, w.n_nodes).total_s
    orc = simulate(w, oracle_policy(w), w.n_nodes).total_s
    best_uniform = min(v for k, v in times.items() if k.startswith("uniform"))
    for k, v in sorted(times.items(), key=lambda kv: kv[1]):
        print(f"  {k:18s} {v:8.1f}s")
    print(f"  per-scope oracle   {orc:8.1f}s")
    print(f"→ heterogeneity buys {best_uniform / times['per-scope policy']:.2f}×"
          " over the best single mode")

    # and it runs for real: one interleaved mixed-mode batch, one exchange
    n = 8
    client = BBClient(dataclasses.replace(policy, n_nodes=n), device=device,
                      cap=128, words=8, mcap=128)
    rng = np.random.RandomState(0)
    paths = [[(f"/bb/ckpt/rank{r}/f{j}" if j % 2 == 0 else
               f"/bb/shared/obj{r}_{j}") for j in range(6)]
             for r in range(n)]
    req = client.encode(paths, chunk_id=np.zeros((n, 6), np.int32),
                        payload=rng.randint(0, 999, (n, 6, 8)))
    client.write(req)
    out, found = client.read(req)
    if not (bool(found.all()) and np.array_equal(
            out.cpu().numpy(), req.payload.cpu().numpy())):
        raise AssertionError("the mixed-mode batch did not read back intact")
    modes = sorted(set(client.policy.resolve(req.scope_hash).cpu().numpy()
                       .ravel().tolist()))
    print(f"BB engine: mixed-mode batch (modes {modes}) written + read "
          "back intact through one BBClient ✓")
    return {"times": times, "client": client}


def main(argv: Optional[list] = None) -> dict:
    """Run the demo; returns the matrix's hits and the plan's results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the tables live (default: the CUDA card)")
    args = ap.parse_args(argv)
    hits = single_mode_matrix()
    return {"hits": hits, **heterogeneous_plan(args.device)}


if __name__ == "__main__":
    main()
