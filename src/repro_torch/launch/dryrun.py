"""Dry run of every (arch × shape × mesh) model cell, and the burst
buffer's cell on a mesh of ranks (twin of ``repro.launch.dryrun``).

Model cells (``run_cell``): the reference lowers and compiles each
production step on a 16×16 or 2×16×16 mesh of placeholder devices.  The
port has no compiler to ask, so it runs the step once on meta tensors
(shapes and dtypes only; no memory, no card) under ``analysis.op_costs``,
with the inputs' shardings from the logical axes on the abstract
production mesh (``launch.mesh``), and writes the reference's record:
``memory_analysis`` holds the per-device argument and output bytes, exact
from the shardings (a temp size is unavailable: meta tensors have no
allocator), ``lower_s`` the meta run's seconds, ``compile_s`` 0,
``cost_analysis`` the counted per-device FLOPs and bytes, and
``roofline`` the three-term report on the H100's constants
(``analysis.roofline``)::

    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all            # every cell

BB cell (``run_bb_cell``): a heterogeneous ``LayoutPolicy`` served through
the ``BBClient`` mesh backend, checked element for element against the
stacked backend.  Every rank of the mesh calls it; rank 0 writes the
record.  The CLI spawns the ranks, one process each, joined in a process
group through a file in a temporary directory::

    python -m repro_torch.launch.dryrun --bb                # one rank a card, NCCL
    python -m repro_torch.launch.dryrun --bb --device cpu --ranks 8   # gloo

Records go to ``--out`` as ``{arch}__{shape}__{mesh}.json``.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import math
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np

#: seconds the CLI waits for its ranks before it kills them and fails
RANK_TIMEOUT_S = 600


def _write(out_dir: Path, rec: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=2))


def _shard_bytes(pairs) -> int:
    """Per-device bytes of ``(tensor, NamedSharding)`` pairs."""
    return sum(math.prod(sh.shard_shape(t.shape)) * t.element_size()
               for t, sh in pairs)


def _pairs(tree, shardings):
    """``(leaf, sharding)`` pairs of a tree and its shardings tree."""
    from repro_torch.distributed.sharding import tree_leaves
    leaves, shs = tree_leaves(tree), tree_leaves(shardings)
    assert len(leaves) == len(shs), (len(leaves), len(shs))
    return list(zip(leaves, shs))


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             save_hlo: bool = False) -> dict:
    """One model cell on meta tensors; writes and returns its record."""
    from repro_torch.analysis.op_costs import count_costs
    from repro_torch.analysis.roofline import (NOTE, build_report,
                                               sharding_collectives,
                                               split_chips)
    from repro_torch.configs import (ALL_SHAPES, all_configs,
                                     shape_applicable, skip_reason)
    from repro_torch.distributed.sharding import mesh_context, spec_tree_for
    from repro_torch.launch.mesh import make_production_mesh, mesh_chips
    from repro_torch.launch.specs import input_specs, step_fn_for
    from repro_torch.train.optimizer import AdamW

    cfg = all_configs()[arch]
    shape = ALL_SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": skip_reason(cfg, shape)}
        _write(out_dir, rec)
        print(f"[dryrun] SKIP {arch}×{shape_name}: {rec['reason']}")
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh_chips(mesh)
    optimizer = AdamW()
    train = shape.kind == "train"
    t0 = time.time()
    with mesh_context(mesh, fsdp=True,
                      seq_shard=(shape.kind == "long_decode")) as ctx:
        args, arg_axes = input_specs(cfg, shape, optimizer)
        in_sh = spec_tree_for(arg_axes, args, ctx)
        step = step_fn_for(cfg, shape, optimizer)
        call = list(args)
        if not train and shape.kind != "prefill":
            # the port's decode reads cache_len on the host: decode the
            # last of the shape's seq_len positions
            call[-1] = shape.seq_len
        out, costs = count_costs(step, *call)
        if train:
            out_axes = (arg_axes[0], arg_axes[1], {k: () for k in out[2]})
        elif shape.kind == "prefill":
            out_axes = ("batch", "vocab")
        else:
            out_axes = (("batch",), arg_axes[1])
        out_sh = spec_tree_for(out_axes, out, ctx)
    t_lower = time.time() - t0

    arg_pairs = _pairs(args, in_sh)
    split = split_chips(sh for _, sh in arg_pairs)
    dev = costs.scaled(split)
    dev.collective_bytes = sharding_collectives(
        _pairs(args[0], in_sh[0]), train)
    mem = {"argument_size_in_bytes": _shard_bytes(arg_pairs),
           "output_size_in_bytes": _shard_bytes(_pairs(out, out_sh)),
           "temp_size_in_bytes": "unavailable"}
    print(f"[dryrun] memory_analysis: {mem}")
    cost = {"flops": dev.flops, "bytes accessed": dev.traffic_bytes}
    print(f"[dryrun] cost_analysis: flops={cost['flops']} "
          f"bytes={cost['bytes accessed']}")
    note = NOTE.format(split=split, chips=chips,
                       bwd=" (forward and backward)" if train else "")
    report = build_report(arch, shape, mesh_kind, chips, dev, cfg, note=note)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "ok", "chips": chips,
           "lower_s": round(t_lower, 1), "compile_s": 0,
           "memory_analysis": mem, "cost_analysis": cost,
           "roofline": json.loads(report.to_json())}
    _write(out_dir, rec)
    if save_hlo:
        rows = sorted(costs.table.items(), key=lambda kv: -kv[1][1])
        (out_dir / f"{arch}__{shape_name}__{mesh_kind}.ops.txt").write_text(
            "op\tcount\tflops\tbytes\n" + "".join(
                f"{op}\t{n}\t{f:.6g}\t{b:.6g}\n" for op, (n, f, b) in rows))
    print(f"[dryrun] OK {arch}×{shape_name}×{mesh_kind}: "
          f"meta run {t_lower:.1f}s, bottleneck={report.bottleneck}, "
          f"terms(c/m/coll)={report.compute_s:.4f}/"
          f"{report.memory_s:.4f}/{report.collective_s:.4f}s, "
          f"useful={report.useful_ratio:.2f}", flush=True)
    return rec


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
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true",
                    help="every arch × shape × mesh cell")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write each cell's counted operation table "
                         "(op, count, FLOPs, bytes) as .ops.txt: the port "
                         "has no HLO to save")
    ap.add_argument("--skip-existing", action="store_true")
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
        run_cells(args)
        return
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


def run_cells(args) -> None:
    """The model cells the CLI names; ``SystemExit(1)`` if any failed."""
    from repro_torch.configs import ALL_SHAPES, all_configs
    out = Path(args.out)
    if args.all:
        cells = [(arch, shape, mesh) for arch in all_configs()
                 for shape in ALL_SHAPES for mesh in ("single", "multi")]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.mesh)]
    failures = []
    for arch, shape, mesh in cells:
        tag = f"{arch}__{shape}__{mesh}"
        if args.skip_existing and (out / f"{tag}.json").exists():
            print(f"[dryrun] skip existing {tag}")
            continue
        try:
            run_cell(arch, shape, mesh, out, save_hlo=args.save_hlo)
        except Exception as e:
            traceback.print_exc()
            failures.append(tag)
            _write(out, {"arch": arch, "shape": shape, "mesh": mesh,
                         "status": "error", "error": str(e)})
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all cells passed")


if __name__ == "__main__":
    main()
