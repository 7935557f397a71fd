"""The burst buffer's dry-run cell on a mesh of ranks (twin of
``repro.launch.dryrun``'s ``--bb`` cell).

``run_bb_cell`` serves a heterogeneous ``LayoutPolicy`` through the
``BBClient`` mesh backend and checks it element for element against the
stacked backend.  Every rank of the mesh calls it; rank 0 writes the
record.  The CLI spawns the ranks, one process each, joined in a process
group through a file in a temporary directory::

    python -m repro_torch.launch.dryrun --bb                # one rank a card, NCCL
    python -m repro_torch.launch.dryrun --bb --device cpu --ranks 8   # gloo

and writes ``bb-client__n8q8w16__node.json`` under ``--out``.  The
reference's model cells (lower and compile every arch × shape × mesh) are
not ported: they need the port's configs, shapes and sharding first.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

#: seconds the CLI waits for its ranks before it kills them and fails
RANK_TIMEOUT_S = 600


def _write(out_dir: Path, rec: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=2))


def run_bb_cell(out_dir: Path, n_nodes: int = 8, mesh=None) -> dict:
    """BB data-plane dry-run: a heterogeneous ``LayoutPolicy`` served by the
    ``BBClient`` mesh backend, checked element for element against the
    stacked backend on the mesh's device.  ``mesh``: this rank's
    ``NodeMesh`` (``make_node_mesh()`` when omitted).  Raises
    ``SystemExit(1)`` when the two disagree."""
    import torch

    from repro_torch.core.client import BBClient
    from repro_torch.core.layouts import LayoutMode
    from repro_torch.core.mesh_engine import make_node_mesh
    from repro_torch.core.policy import LayoutPolicy

    policy = LayoutPolicy.from_scopes(
        {"/bb/ckpt": LayoutMode.HYBRID, "/bb/shared": LayoutMode.DIST_HASH},
        n_nodes=n_nodes, default=LayoutMode.DIST_HASH)
    q, w = 8, 16
    paths = [[(f"/bb/ckpt/rank{r}/seg{j}" if j % 2 == 0 else
               f"/bb/shared/obj{r}_{j}") for j in range(q)]
             for r in range(n_nodes)]
    rng = np.random.RandomState(0)
    cid = rng.randint(0, 4, (n_nodes, q))
    payload = rng.randint(0, 999, (n_nodes, q, w))

    t0 = time.time()
    mesh = make_node_mesh() if mesh is None else mesh
    mesh_client = BBClient(policy, mesh, words=w)
    req = mesh_client.encode(paths, chunk_id=cid, payload=payload)
    mesh_client.write(req)
    out_m, found_m = (mesh.gather(x) for x in mesh_client.read(req))
    stacked = BBClient(policy, device=mesh.device, words=w)
    stacked.write(req)
    out_s, found_s = stacked.read(req)
    ok = (bool(found_m.all()) and torch.equal(out_m, out_s) and
          np.array_equal(out_m.cpu().numpy(), payload))
    rec = {"arch": "bb-client", "shape": f"n{n_nodes}q{q}w{w}",
           "mesh": "node", "status": "ok" if ok else "error",
           "policy": {s: int(m) for s, m in policy.scopes},
           "default_mode": int(policy.default_mode),
           "ranks": mesh.world, "backend": mesh.backend,
           "device": str(mesh.device),
           "wall_s": round(time.time() - t0, 1)}
    if mesh.rank == 0:
        _write(out_dir, rec)
        print(f"[dryrun] BB {'OK' if ok else 'FAIL'}: heterogeneous policy "
              f"{rec['policy']} on a {mesh.world}-rank {mesh.backend} mesh, "
              f"stacked/mesh parity={'✓' if ok else '✗'}", flush=True)
    if not ok:
        raise SystemExit(1)
    return rec


def _bb_rank(rank: int, world: int, device: str, init_file: str,
             out: str) -> None:
    """One spawned rank: join the group, run the cell, leave the group."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.mesh_engine import BACKENDS, make_node_mesh
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)        # the ranks share the host's cores
    dist.init_process_group(BACKENDS[device], init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        run_bb_cell(Path(out), mesh=make_node_mesh(
            device=None if device == "cuda" else device))
    finally:
        dist.destroy_process_group()


def spawn_bb_cell(out: Path, ranks: int, device: str) -> None:
    """Run ``run_bb_cell`` (8 nodes) on ``ranks`` spawned processes; raises
    ``SystemExit(1)`` if a rank fails or any is still running after
    ``RANK_TIMEOUT_S`` (it is then killed)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = str(Path(tmp) / "rendezvous")
        procs = [ctx.Process(target=_bb_rank, args=(
            r, ranks, device, init_file, str(out)))
            for r in range(ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    if hung:
        print(f"[dryrun] {len(hung)} of {ranks} ranks still running after "
              f"{RANK_TIMEOUT_S} s: killed", file=sys.stderr)
        raise SystemExit(1)
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        print(f"[dryrun] ranks {bad} failed", file=sys.stderr)
        raise SystemExit(1)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bb", action="store_true",
                    help="burst-buffer data-plane dry-run (BBClient mesh "
                         "backend, heterogeneous policy)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: NCCL, one rank a card (default); cpu: gloo")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes to spawn (default: the visible cards, "
                         "or 8 on the CPU)")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    if not args.bb:
        ap.error("only the burst-buffer cell (--bb) is ported")
    ranks = args.ranks
    if ranks is None:
        if args.device == "cuda":
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass "
                                   "--device cpu for a gloo mesh")
            ranks = torch.cuda.device_count()
        else:
            ranks = 8
    spawn_bb_cell(Path(args.out), ranks, args.device)


if __name__ == "__main__":
    main()
