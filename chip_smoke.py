#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the burst-buffer data plane once on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, each of which must succeed or the run fails without a result line:

  (a) build both hand-written kernels from ``src/repro_torch/csrc`` with
      nvcc for sm_90a, all sources compiled in parallel;
  (b) each kernel against its plain PyTorch version on the card, bit for
      bit, at the shapes the deployment's first write gives it and at
      sentinel and edge shapes;
  (c) the deployment, through ``BBClient``: 32 burst-buffer nodes, 1 MiB
      chunks, the heterogeneous policy (``/bb/ckpt`` HYBRID, ``/bb/shared``
      DIST_HASH, default CENTRAL_META), 256 chunk slots and 1024 metadata
      slots per node (an 8 GiB data table), 8 requests per node per call.
      Three fused writes, cross-node two-phase reads, stat, create and
      remove; every acknowledged write reads back bit for bit, stat sizes
      match, removed files report not found, and both kernels' launch
      counts (zeroed just before) are above 0;
  (d) the pinned seed digests of the JAX package's tests, through the
      engine and through ``BBClient``, dense and compacted, all four modes;
  (e) times: each kernel, its plain version and a one-call PyTorch
      yardstick (CUDA events; profiler device time for the launch-bound
      histogram) beside the bound; the client's write / read / stat
      latency (host clock), the read's stage breakdown, and a profile of
      one write, read and stat (device busy time, idle share, top kernels).

Before the last line it prints the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and one JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
no CUDA card is present or any phase fails.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, and the
# non-tensor-core fp32 rate used as the ceiling of simple integer ops
HBM_BYTES_PER_S = 3.35e12
SIMPLE_OPS_PER_S = 67e12

DEVICE = "cuda"
N_NODES, CAP, MCAP, Q = 32, 256, 1024, 8
WORDS = (1 << 20) // 4                    # one 1 MiB chunk in int32 words
SCOPES = {"/bb/ckpt": 4, "/bb/shared": 3}  # HYBRID, DIST_HASH
DEFAULT_MODE = 2                          # CENTRAL_META
N_WRITES = 3

# SHA-256 digests pinned by the JAX package's tests (tests/test_policy.py,
# SEED_DIGESTS: the seed engine's outputs for the fixed trace of
# _seed_trace / test_compacted_exchange._client_trace), copied here so
# this script needs nothing of the JAX package.
SEED_DIGESTS = {
    1: {"state": "17741f4a74c61103b1dc1d9105261236",
        "read": "ac274ad4bb81a2c36cd4c35757a67ff2",
        "meta": "98fada5874a6595dd18224298d7b1e62"},
    2: {"state": "c074204b6507057ad3fcace426659b41",
        "read": "ac274ad4bb81a2c36cd4c35757a67ff2",
        "meta": "98fada5874a6595dd18224298d7b1e62"},
    3: {"state": "69d5836cb233e683fba71d3927b997d5",
        "read": "ac274ad4bb81a2c36cd4c35757a67ff2",
        "meta": "98fada5874a6595dd18224298d7b1e62"},
    4: {"state": "1b4ea91373f2239492ef274b0e0afabc",
        "read": "ac274ad4bb81a2c36cd4c35757a67ff2",
        "meta": "b1c7a050f74a9acd615eead6cb60dbb5"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    """A phase's check did not hold."""


def check(cond, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# ---------------------------------------------------------------------------
# (a) build
# ---------------------------------------------------------------------------
def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    reports = kernels.build(kernels.KERNELS)
    for name in kernels.KERNELS:
        lib = kernels.library_path(name)
        check(lib.exists(), f"{name}: no library after the build")
        log(f"[build] {name} -> build/{lib.name}")
        for line in reports.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(kernels.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, in parallel)")


# ---------------------------------------------------------------------------
# the deployment's requests
# ---------------------------------------------------------------------------
def deployment_policy():
    from repro_torch.core.policy import LayoutPolicy
    return LayoutPolicy.from_scopes(SCOPES, n_nodes=N_NODES,
                                    default=DEFAULT_MODE)


def batch_paths(step: int):
    """Per node: one 4 MiB checkpoint transfer (4 chunks of one HYBRID
    file), 2 chunks of an N-to-1 shared file, 2 chunks of a log file."""
    paths, cids = [], []
    for r in range(N_NODES):
        paths.append([f"/bb/ckpt/rank{r}/ckpt.{step}"] * 4 +
                     [f"/bb/shared/out.{step}"] * 2 +
                     [f"/bb/run/rank{r}/log.{step}"] * 2)
        cids.append([0, 1, 2, 3, 2 * r, 2 * r + 1, 0, 1])
    return paths, np.asarray(cids, np.int32)


def expected_sizes(cids: np.ndarray) -> np.ndarray:
    size = np.empty_like(cids)
    size[:, :4], size[:, 4:6], size[:, 6:] = 4, 2 * N_NODES, 2
    return size


def random_payload(gen: torch.Generator) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (N_NODES, Q, WORDS),
                         dtype=torch.int32, device=DEVICE, generator=gen)


def first_write_inputs(seed: int):
    """The kernels' inputs on the deployment's first write, rebuilt with
    the port's own planner: the data plane's destination histogram input,
    the send-order pack (fields, rebased slots) and the ragged exchange's
    receive map."""
    from repro_torch.core import exchange_plan as xp
    from repro_torch.core.client import BBClient
    from repro_torch.core.layouts import route_data
    policy = deployment_policy()
    client = BBClient(policy, cap=1, words=1, mcap=1)   # encoder only
    paths, cids = batch_paths(0)
    req = client.encode(paths, chunk_id=cids)
    mode = client._modes(req)
    valid = torch.ones((N_NODES, Q), dtype=torch.bool, device=DEVICE)
    ranks = torch.arange(N_NODES, dtype=torch.int32, device=DEVICE)[:, None]
    dest = route_data(mode, N_NODES, req.path_hash, req.chunk_id, ranks)
    hist_in = xp._sentinel_dest(dest, valid, N_NODES)
    spec = xp.plan_ragged_spec(dest, valid, N_NODES)
    send_idx = xp._compact_plan_ragged(dest, valid, N_NODES, spec)[0]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    payload = random_payload(gen)
    keys = torch.stack([req.path_hash, req.chunk_id], dim=-1)
    fields = torch.cat([keys, payload, torch.ones_like(keys[..., :1])],
                       dim=-1).reshape(N_NODES * Q, -1)
    base = torch.arange(N_NODES, dtype=torch.int32, device=DEVICE)[:, None]
    idx = torch.where(send_idx >= 0, send_idx + base * Q, -1).to(
        torch.int32).reshape(-1)
    recv_rows = torch.as_tensor(
        xp._ragged_recv_rows(spec, N_NODES).reshape(-1), device=DEVICE)
    return hist_in, fields.contiguous(), idx, recv_rows, spec


# ---------------------------------------------------------------------------
# (b) each kernel against its plain version
# ---------------------------------------------------------------------------
def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max().item())


def phase_kernels_vs_plain(seed: int) -> dict:
    from repro_torch.kernels.chunk_pack.chunk_pack import pack_chunks
    from repro_torch.kernels.chunk_pack.ref import pack_chunks_ref
    from repro_torch.kernels.chunk_router.chunk_router import \
        dest_histogram2d
    from repro_torch.kernels.chunk_router.ref import dest_histogram2d_ref
    err = {"dest_histogram2d": 0.0, "pack_chunks": 0.0}
    rng = np.random.RandomState(seed)

    def hist_case(label, dest, n_bins):
        got = dest_histogram2d(dest, n_bins=n_bins)
        torch.cuda.synchronize()
        ref = dest_histogram2d_ref(dest, n_bins=n_bins)
        e = max_abs_err(got, ref)
        err["dest_histogram2d"] = max(err["dest_histogram2d"], e)
        check(torch.equal(got, ref), f"dest_histogram2d {label} differs")
        log(f"[kernels] dest_histogram2d {label} {tuple(dest.shape)} "
            f"n_bins={n_bins}: equal (max_abs_err {e})")

    def pack_case(label, payload, idx):
        got = pack_chunks(payload, idx)
        torch.cuda.synchronize()
        ref = pack_chunks_ref(payload, idx)
        e = max_abs_err(got, ref) if got.numel() < 1 << 24 else \
            float(not torch.equal(got, ref))
        err["pack_chunks"] = max(err["pack_chunks"], e)
        check(torch.equal(got, ref), f"pack_chunks {label} differs")
        log(f"[kernels] pack_chunks {label} payload {tuple(payload.shape)} "
            f"{payload.dtype} idx {tuple(idx.shape)}: equal "
            f"(max_abs_err {e})")
        del got, ref

    hist_in, fields, idx, recv_rows, spec = first_write_inputs(seed)
    hist_case("main path (write data plane)", hist_in, N_NODES + 1)
    pack_case("main path (write send pack)", fields, idx)
    packed = pack_chunks(fields, idx)
    pack_case("main path (ragged receive view)", packed, recv_rows)
    del packed
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    for shape, n_bins in (((1, 8), 5), ((16, 128), 32), ((4, 300), 4097),
                          ((3, 50), 20000), ((5, 0), 9)):
        d = torch.as_tensor(rng.randint(-1, n_bins + 2, shape).astype(
            np.int32), device=dev)
        hist_case("edge", d, n_bins)
    for (n, m, w), dtype in (((8, 259, 4), torch.int32),
                             ((100, 333, 16), torch.float32),
                             ((3, 7, 1), torch.int32),
                             ((64, 64, WORDS + 3), torch.float32)):
        payload = torch.randn((n, w), device=dev).mul_(1e4).to(dtype)
        payload[0] = 7777                     # poison: pads must not read it
        ids = rng.randint(-1, n, m).astype(np.int32)
        ids[0] = -1
        pack_case("edge", payload, torch.as_tensor(ids, device=dev))
    log(f"[kernels] spec of the first write's data plane: total "
        f"{spec.total} columns, bmax {spec.bmax}")
    return err


# ---------------------------------------------------------------------------
# (c) the deployment through BBClient
# ---------------------------------------------------------------------------
def phase_deployment(seed: int, counters) -> dict:
    from repro_torch.core.client import BBClient
    client = BBClient(deployment_policy(), cap=CAP, words=WORDS, mcap=MCAP)
    check(client.device.type == DEVICE, "client tables not on the card")
    kind = client._select_kind(Q)
    check(kind == "compacted", f"exchange auto picked {kind}, not compacted")
    log(f"[deploy] N={N_NODES} cap={CAP} mcap={MCAP} words={WORDS} q={Q}; "
        f"data table {client.state.data.numel() * 4 / 2 ** 30:.2f} GiB; "
        f"exchange auto -> {kind}")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    batches = []
    t0 = time.perf_counter()
    for step in range(N_WRITES):
        paths, cids = batch_paths(step)
        req = client.encode(paths, chunk_id=cids)
        req.payload = random_payload(gen)
        client.write(req)
        batches.append((paths, cids, req))
    torch.cuda.synchronize()
    check(int(client.state.dropped.sum()) == 0, "writes were dropped")
    for step, (paths, cids, req) in enumerate(batches):
        # node r reads what node r+1 wrote: hybrid chunks are remote, so
        # the read runs the metadata probe, then the measured data round
        rot = [paths[(r + 1) % N_NODES] for r in range(N_NODES)]
        rreq = client.encode(rot, chunk_id=np.roll(cids, -1, axis=0))
        out, found = client.read(rreq)
        check(bool(found.all()), f"write {step}: chunks not found")
        check(torch.equal(out, torch.roll(req.payload, -1, dims=0)),
              f"write {step}: read-back differs from the written payload")
        found, size, loc = client.stat(req)
        check(bool(found.all()), f"write {step}: stat misses a file")
        check(np.array_equal(size.cpu().numpy(), expected_sizes(cids)),
              f"write {step}: stat sizes wrong")
        ranks = np.broadcast_to(np.arange(N_NODES)[:, None], (N_NODES, 4))
        check(np.array_equal(loc[:, :4].cpu().numpy(), ranks),
              f"write {step}: hybrid data location is not the writer")
    new = client.encode([[f"/bb/ckpt/rank{r}/new{j}" if j % 2 else
                          f"/bb/run/rank{r}/new{j}" for j in range(Q)]
                         for r in range(N_NODES)])
    check(bool(client.create(new).all()), "create did not acknowledge")
    found, size, _ = client.stat(new)
    check(bool(found.all()) and not bool(size.any()),
          "created files not found with size 0")
    _, _, req0 = batches[0]
    check(bool(client.remove(req0).all()), "remove missed a file")
    found, _, _ = client.stat(req0)
    check(not bool(found.any()), "removed files still found")
    found, _, _ = client.stat(batches[1][2])
    check(bool(found.all()), "remove touched another write's files")
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters}
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    log(f"[deploy] {N_WRITES} fused writes ({N_WRITES * N_NODES * Q} chunks, "
        f"{N_WRITES * N_NODES * Q} MiB), {N_WRITES} reads, stats, create, "
        f"remove: all checks hold in {time.perf_counter() - t0:.2f} s")
    log(f"[deploy] launches on the main path: {launches}")
    log(f"[deploy] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return {"client": client, "batches": batches, "launches": launches}


# ---------------------------------------------------------------------------
# (d) the seed digests on the card
# ---------------------------------------------------------------------------
def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a.cpu().numpy()).tobytes())
    return h.hexdigest()[:32]


def seed_trace(mode: int, via: str, exchange: str) -> dict:
    from repro_torch.core import burst_buffer as bb
    from repro_torch.core.client import BBClient, BBRequest
    from repro_torch.core.policy import LayoutPolicy
    n, q, w = 8, 5, 8
    policy = LayoutPolicy.uniform(mode, n)
    rng = np.random.RandomState(42)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=DEVICE)

    ph = dev(rng.randint(1, 1 << 20, (n, q)))
    cid = dev(rng.randint(0, 4, (n, q)))
    payload = dev(rng.randint(0, 9999, (n, q, w)))
    perm = torch.as_tensor(rng.permutation(n), device=DEVICE)
    if via == "engine":
        cfg = bb.DENSE if exchange == "dense" else bb.COMPACTED
        valid = torch.ones((n, q), dtype=torch.bool, device=DEVICE)
        state = bb.forward_write(bb.init_state(n, 64, w, 64), policy, ph,
                                 cid, payload, valid, config=cfg)
        sd = digest(*[getattr(state, f) for f in state.__dataclass_fields__])
        rpay, rfound = bb.forward_read(state, policy, ph[perm], cid[perm],
                                       valid, config=cfg)
        zeros = torch.zeros((n, q), dtype=torch.int32, device=DEVICE)
        _, fnd, size, loc = bb.meta_op(state, policy, zeros + bb.OP_STAT, ph,
                                       zeros, zeros - 1, valid, config=cfg)
    else:
        client = BBClient(policy, cap=64, words=w, mcap=64,
                          exchange=exchange)
        client.write(BBRequest(path_hash=ph, chunk_id=cid, payload=payload))
        state = client.state
        sd = digest(*[getattr(state, f) for f in state.__dataclass_fields__])
        rpay, rfound = client.read(BBRequest(path_hash=ph[perm],
                                             chunk_id=cid[perm]))
        fnd, size, loc = client.stat(BBRequest(path_hash=ph))
    return {"state": sd, "read": digest(rpay, rfound),
            "meta": digest(fnd, size, loc)}


def phase_seed_digests() -> None:
    for via in ("engine", "client"):
        for exchange in ("dense", "compacted"):
            for mode in (1, 2, 3, 4):
                got = seed_trace(mode, via, exchange)
                check(got == SEED_DIGESTS[mode],
                      f"seed digests differ: {via} {exchange} mode {mode}")
    log("[digests] SEED_DIGESTS reproduced on the card: engine and client, "
        "dense and compacted, modes 1-4")


# ---------------------------------------------------------------------------
# (e) timings
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time per call: the summed time of every kernel and copy that
    ``reps`` calls of ``fn`` put on the card, from ``torch.profiler``,
    divided by ``reps``.  Unlike events around back-to-back calls it leaves
    out the gaps in which the card waits for the host to launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    check(busy > 0, "profiler recorded no device time")
    return busy / reps


def host_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def bound_ms(nbytes: float, ops: float):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SIMPLE_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def phase_timings(seed: int, deploy: dict) -> dict:
    from repro_torch.core import burst_buffer as bb
    from repro_torch.kernels.chunk_pack.chunk_pack import pack_chunks
    from repro_torch.kernels.chunk_pack.ref import pack_chunks_ref
    from repro_torch.kernels.chunk_router.chunk_router import \
        dest_histogram2d
    from repro_torch.kernels.chunk_router.ref import dest_histogram2d_ref
    out = {}
    hist_in, fields, idx, recv_rows, spec = first_write_inputs(seed)

    # dest_histogram2d at the write data plane's (32, 8) → 33 bins
    L, q = hist_in.shape
    nb = N_NODES + 1
    flat = torch.where((hist_in >= 0) & (hist_in < nb),
                       hist_in + nb * torch.arange(L, device=DEVICE)[:, None],
                       L * nb).reshape(-1)
    # launch-bound: device time per call, plus what back-to-back calls
    # through the wrapper sustain (the host's launch rate)
    t_k = device_ms(lambda: dest_histogram2d(hist_in, n_bins=nb), 50)
    t_p = device_ms(lambda: dest_histogram2d_ref(hist_in, n_bins=nb), 50)
    t_l = device_ms(lambda: torch.bincount(flat, minlength=L * nb + 1), 50)
    log(f"[time] dest_histogram2d back to back through the wrapper: "
        f"{cuda_ms(lambda: dest_histogram2d(hist_in, n_bins=nb), 200):.4f} "
        f"ms a call (host launch rate)")
    b, by = bound_ms(L * q * 4 + L * nb * 4, L * q)
    out["dest_histogram2d"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                   bound_ms=b, bound_by=by,
                                   shape=f"({L}, {q}) -> ({L}, {nb})")

    # pack_chunks at the write send pack and at the ragged receive view
    def pack_numbers(payload, ids, label):
        rows = int((ids >= 0).sum().item())
        w = payload.shape[1]
        nbytes = rows * w * 4 + ids.numel() * 4 + ids.numel() * w * 4
        t_k = cuda_ms(lambda: pack_chunks(payload, ids), 5)
        t_p = cuda_ms(lambda: pack_chunks_ref(payload, ids), 5)
        safe = ids.clamp(min=0).long()
        t_l = cuda_ms(lambda: torch.index_select(payload, 0, safe), 5)
        b, by = bound_ms(nbytes, 0)
        return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b,
                    bound_by=by, shape=f"{label}: payload {tuple(payload.shape)}, "
                          f"{ids.numel()} rows out, {rows} gathered")

    out["pack_chunks"] = pack_numbers(fields, idx, "write send pack")
    torch.cuda.empty_cache()
    packed = pack_chunks(fields, idx)
    out["pack_chunks_recv"] = pack_numbers(packed, recv_rows,
                                           "ragged receive view")
    del packed
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(f"[time] {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['ms']:.3f} of bound")

    # the client, end to end (tables already hold the deployment's writes)
    client = deploy["client"]
    paths, cids, req = deploy["batches"][-1]
    nbytes = N_NODES * Q * WORDS * 4
    t_w = host_ms(lambda: client.write(req), 3)
    t_r = host_ms(lambda: client.read(req), 3)
    t_s = host_ms(lambda: client.stat(req), 3)
    log(f"[time] client write {t_w:.3f} ms ({nbytes / t_w / 1e6:.2f} GB/s), "
        f"read {t_r:.3f} ms ({nbytes / t_r / 1e6:.2f} GB/s), stat "
        f"{t_s:.3f} ms; best of 3, {N_NODES}x{Q} requests of 1 MiB")

    # where a read's time goes: the client's two-phase read, stage by stage
    st, pol = client.state, client.policy
    mode = client._modes(req)
    ph, cid, valid = req.path_hash, req.chunk_id, client._valid(req)
    probe_valid = valid & (mode == 4)
    ranks = client._client_ranks().expand(N_NODES, Q)
    stages = {}
    box = {}

    def probe():
        cfg_m = client._call_config("meta", mode, ph, None, probe_valid)
        z = torch.zeros_like(ph)
        _, fm, _, loc = bb.meta_op(st, pol, z + bb.OP_STAT, ph, z, z - 1,
                                   probe_valid, mode=mode, config=cfg_m)
        box["loc"] = torch.where(fm & (loc >= 0), loc, ranks)

    stages["metadata probe"] = host_ms(probe, 3)

    def data_round():
        cfg = client._call_config("read", mode, ph, cid, valid,
                                  data_loc=box["loc"])
        dest = bb.route_data(mode, N_NODES, ph, cid, ranks[:, :1],
                             data_loc=box["loc"])
        keys = torch.stack([ph, cid], dim=-1)
        box["found"] = bb.routed_lookup(st, pol, dest, keys, valid, cfg)[1]

    stages["routed data round"] = host_ms(data_round, 3)
    keys = torch.stack([ph, cid], dim=-1)
    miss = valid & ~box["found"] & ((mode == 1) | (mode == 4))
    stages["stranded-data broadcast"] = host_ms(
        lambda: bb._broadcast_lookup(st, keys, miss, N_NODES), 3)
    log("[time] read stages: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items()))
    for name, fn in (("write", lambda: client.write(req)),
                     ("read", lambda: client.read(req)),
                     ("stat", lambda: client.stat(req))):
        profile_call(name, fn)
    out["client"] = dict(write_ms=t_w, read_ms=t_r, stat_ms=t_s,
                         read_stages=stages)
    return out


def profile_call(name: str, fn) -> None:
    """One call under ``torch.profiler``: wall time, device busy time (sum
    of kernel and copy times), idle share, launches, and the kernels that
    take the most device time.  The profiler's own host overhead inflates
    the wall time, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    syncs = sum(e.count for e in events if e.key == "aten::nonzero" or
                "Synchronize" in e.key)
    check(busy > 0, f"profile of {name}: no device time recorded")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    log(f"[profile] {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {max(0.0, 1 - busy / wall):.3f}, {launches} kernel "
        f"launches, {syncs} host syncs (nonzero/synchronize)")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


# ---------------------------------------------------------------------------
def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random payloads (default 0)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import kernels
    from repro_torch.kernels.chunk_pack.chunk_pack import PACK_CHUNKS
    from repro_torch.kernels.chunk_router.chunk_router import \
        DEST_HISTOGRAM2D
    counters = (DEST_HISTOGRAM2D, PACK_CHUNKS)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase = "build"
    try:
        phase_build(kernels)
        phase = "kernels vs plain"
        err = phase_kernels_vs_plain(args.seed)
        phase = "deployment"
        deploy = phase_deployment(args.seed, counters)
        phase = "seed digests"
        phase_seed_digests()
        phase = "timings"
        times = phase_timings(args.seed, deploy)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    except Exception:                          # any failure fails the run
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        return 1
    rows = []
    for c, src, replaces in (
            (DEST_HISTOGRAM2D, "src/repro_torch/csrc/dest_histogram2d.cu",
             "src/repro/kernels/chunk_router/chunk_router.py:133"),
            (PACK_CHUNKS, "src/repro_torch/csrc/pack_chunks.cu",
             "src/repro/kernels/chunk_pack/chunk_pack.py:42")):
        t = times[c.name]
        rows.append({"name": c.name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": deploy["launches"][c.name],
                     "max_abs_err": err[c.name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
