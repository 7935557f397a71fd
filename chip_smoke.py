#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one card: the burst-buffer data
plane, then fault-tolerant training of gemma3-1b with Proteus checkpoints.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, each of which must succeed or the run fails without a result line:

  (a) build the eight hand-written kernel libraries from
      ``src/repro_torch/csrc`` with nvcc for sm_90a, all sources compiled
      in parallel, and check that the bf16 attention library's SASS holds
      wgmma (``HGMMA``) and TMA loads (``UTMALDG``), and the two float32
      ones' tensor-core products with a TF32 type (``HMMA ... TF32``);
      beside them ``dest_histogram.cu`` once more with the cluster path in
      another block shape (``HIST_OTHER_SHAPE``), for timing only;
  (b) each kernel of the data plane and the checkpoint path against its
      plain PyTorch version on the card, bit for bit, at the shapes its
      main path gives it and at sentinel and edge shapes (the planner's
      ``route_plan`` and ``dest_budgets`` on the first write's data plane
      and on the CPU tests' sweep: 1 to 64 nodes, 0 to 100 requests, rows
      all invalid, skewed rows, uniform, measured, short and random
      budgets, and up to 1024 requests and 49,999 nodes; ``fletcher`` up
      to the full embedding leaf, 302 M words in 4608 chunks;
      ``fletcher_segmented`` on mixed leaves: empty, one word, unaligned
      bases, 3000 leaves;
      ``route_chunks`` in all four modes; ``route_chunks_segmented`` on a
      whole gemma3-1b save's leaf table, 251 leaves, and on mixed modes,
      empty leaves and 20000 leaves);
  (b2) the last kernels through their entry points: ``flash_attention``
      on gemma3-1b's global attention (layer 5 of the full-width
      parameters; q/k/v from the port's own projections and RoPE on bf16
      activations, B 4, S 1024, H 4, D 256, causal) through the bf16
      Hopper kernel, finite, and within 2e-2 of the plain version and of
      the model's ``masked_attention(window=0)`` on every query row whose
      softmax is decided (the near-ties of the reference init's huge
      scores, where float32 rounding of the scores alone moves the plain
      version by more, are counted and reported); ``histogram_rows`` on the
      45,884 chunk destinations of one gemma3-1b save (the checkpoint
      manager's routing, 32 nodes), bit for bit; both launch counts
      (zeroed just before) above 0.  Then float32 causal and full at that
      shape through the SIMT kernel (its count zeroed just before, above
      0 after; 3xTF32 on the tensor cores) within 2e-5, and in bf16
      within 2e-2 on every element; the bf16 sweep over D 64/80/128/256 ×
      S 1..1024 (ragged included) × causal/full, the float32 sweep over D
      64/80/128/256 × S 1/63/64/65/1000/1024 × causal/full (2e-5), the JAX
      sweep's shapes in both dtypes, strided views; a misaligned bf16 view
      on which the kernel's wrapper must raise with no launch and which
      the entry point copies (2e-2); head dims 16/32/96/192 padded to an
      instance, in both dtypes, with the reference's keywords; float16
      through the float32 kernel (2e-3); head dims above 256 (320, 512
      and 640, float32 and bf16, causal and full) through the wide float32
      kernel (its count zeroed just before, above 0 after; 2e-5 / 2e-2);
      the histogram's sweep, sentinels, 20000 bins, the save's
      destinations and 16 M values into 32 bins, both of its paths;
      kernel, plain, library (SDPA, timed in turns with the kernel,
      ``bincount``) and bound times (float32: 3xTF32 at the TF32 peak, and
      the float32 SIMT peak beside it; the wide kernel at (4, 1024, 4,
      512)); the histogram's one-cluster path against the same path in
      ``HIST_OTHER_SHAPE``, its grid path (the earlier design) and
      ``bincount`` from 45,884 to 16 M values, with the device operations
      a call puts on the card.  A profiler reading counts only where two
      sessions agree on the operations a call put on the card and read at
      least the work's bound, else the time is taken by CUDA events behind
      a sleep (``device_ms``); a kernel whose time stays below its bound
      fails the run;
  (c) the deployment, through ``BBClient``: 32 burst-buffer nodes, 1 MiB
      chunks, the heterogeneous policy (``/bb/ckpt`` HYBRID, ``/bb/shared``
      DIST_HASH, default CENTRAL_META), 256 chunk slots and 1024 metadata
      slots per node (an 8 GiB data table), 8 requests per node per call.
      Three fused writes, cross-node two-phase reads, stat, create and
      remove; every acknowledged write reads back bit for bit, stat sizes
      match, removed files report not found, the data plane's kernels'
      launch counts (zeroed just before) are above 0, and the planner made
      exactly one ``route_plan`` launch a routing round and one
      ``dest_budgets`` launch a measured spec;
  (d) the pinned seed digests of the JAX package's tests, through the
      engine and through ``BBClient``, dense and compacted, all four modes;
  (e) times: each kernel, its plain version and a one-call PyTorch
      yardstick (CUDA events; profiler device time for the launch-bound
      planner kernels, beside an empty kernel's queued launch, the launch
      floor) beside the bound; one ragged and one uniform plan round under
      the profiler, each one device operation with no host-to-device copy
      and no stream sync; the client's write / read / stat latency (host
      clock), the read's stage breakdown, and a profile of one write, read
      and stat (device busy time, idle share, launches, host syncs,
      copies, top kernels);
  (e2) online adaptation (the deployment's client freed first):
      ``tests/test_adapt.py``'s pinned interleaved stream (N 8, q 6, 8
      words) on the card without and with a ``LiveMigrator`` (into
      DIST_HASH and HYBRID), each giving the pinned digest; then a scope
      that drifts at the deployment's width: 32 nodes, 1 MiB chunks,
      ``/bb/hot`` NODE_LOCAL (default DIST_HASH), ``telemetry=True`` and a
      ``TraceRecorder``; every node writes 16 files x 8 chunks (4 GiB),
      then ring-permuted cross-rank reads with an
      ``AdaptationController`` tick after each (patience 2, cooldown 3,
      min weight 4, horizon 1e4 rounds, 256-chunk installments, 4 a
      tick).  It asserts exactly one adoption, the migration's completion
      within the phase, every read bit for bit, the fallback disarmed, one
      ``/bb/hot`` entry in the new mode, one counts-only
      ``dest_histogram2d`` launch per telemetry record, a ``pack_chunks``
      re-compaction (two launches) and ``route_plan`` rounds in every
      installment, one ``route_plan`` a round and one ``dest_budgets`` a
      spec, and ``exchange.*`` spans under adapt.tick ->
      migrate.installment -> client.migrate -> engine.migrate_rows; and
      times one telemetry record, a tick without adoption, each
      installment (one under the profiler), the migration, the
      re-compaction's gather against its bytes bound and the phase's
      peak memory; then the deployment's write, read and stat with
      telemetry and tracing each turned on and off in place (latency,
      launches, syncs, copies);
  (f) training: ``run_training`` with gemma3-1b at full width (26 layers,
      d 1152, vocab 262144, 999,812,736 params, bf16 compute, f32 params),
      batch 4 × 1024 tokens, checkpoints every 2 steps through the
      deployment policy (/bb/ckpt → HYBRID, 32 nodes) under a failure plan
      with a straggler redo, a corrupted checkpoint rejected by the card's
      checksum with a fallback, and a crash restored from a checkpoint
      verified on the card; the FailureLog and final step must equal what
      the JAX loop gives under the same plan (pinned below), both
      checkpoint kernels' launch counts (zeroed just before) above 0, the
      routing's exactly one a save and one a restore, the checksum's one a
      save and one per group of leaves on restore;
  (g) checkpoint and step times: a save (blocking part and async part) and
      a restore of the full final state (12 GB), checked bit for bit, and
      a restore rejected by a corrupt chunk in a middle leaf;
      ``fletcher_segmented`` over the whole save bit for bit against its
      plain version and the 251 per-leaf ``fletcher`` results, its time
      against its bound beside the per-leaf launches'; the routing's time
      and host time per save; the train step's time, tokens/s and a
      profile of one step.

Before the last line it prints the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and one JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
no CUDA card is present or any phase fails.

``--calls-only`` fills the deployment and times and profiles one write,
read and stat, printing one ``{"calls": ...}`` line and no result line;
it needs only what every slice's package has, so a copy of this script
beside an earlier commit's ``src/`` measures that commit on the same card.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from statistics import median

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, the
# non-tensor-core fp32 rate (also the ceiling of simple integer ops), and
# the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
SIMPLE_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
TF32_TENSOR_OPS_PER_S = 495e12

DEVICE = "cuda"
N_NODES, CAP, MCAP, Q = 32, 256, 1024, 8
WORDS = (1 << 20) // 4                    # one 1 MiB chunk in int32 words
SCOPES = {"/bb/ckpt": 4, "/bb/shared": 3}  # HYBRID, DIST_HASH
DEFAULT_MODE = 2                          # CENTRAL_META
N_WRITES = 3

# (f) training: gemma3-1b at full width, checkpoints through the deployment
# policy above (/bb/ckpt → HYBRID).  The plan: a straggler redo at step 1;
# a corruption at step 2 of the only checkpoint (step 2), rejected by the
# checksum at the crash at step 3, with a fallback to a cold start; the
# replay meets the straggler and the corruption again; the crash at step 4
# restores the verified checkpoint of step 4.  The store keeps every save
# (two distinct, 12 GB each).  TRAIN_EXPECTED is what the JAX loop gives
# under the same plan and policy on the CPU
# (tests/test_torch_train.py::test_chip_plan_failure_log_pinned_to_jax_loop).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "gemma3-1b", 4, 1024
TRAIN_STEPS, CKPT_EVERY = 5, 2
TRAIN_PLAN = {1: "straggler", 2: "corrupt_ckpt", 3: "crash", 4: "crash"}
TRAIN_EXPECTED = {
    "failure_log": {"crashes": 2, "stragglers": 2, "corruptions": 2,
                    "restores": 1, "fallback_restores": 1,
                    "redone_steps": [1, 1]},
    "final_step": 5,
}

# (b2) the last two kernels: gemma3's first global layer (0-based), and the
# reference's tolerances (tests/test_kernels.py): 2e-5 where both sides
# compute in float32 and differ in summation order, 2e-2 where both round
# a float32 result once to bf16
GLOBAL_LAYER = 5
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
TIE_GAP = 10.0                 # scaled-score lead of a decided softmax row
# the histogram's cluster path in one more block shape, built from the same
# source with -D beside the shipped one, for the timing in phase b2
HIST_OTHER_SHAPE = {"CLUSTER_THREADS": 512, "LOADS": 4}

# (e2) online adaptation: a NODE_LOCAL scope whose traffic drifts from
# writes to cross-rank reads, under the reference's test settings
# (tests/test_adapt.py: patience 2, cooldown 3, min weight 4, horizon 1e4
# rounds) with 256-chunk installments, four a tick; and the pinned digest
# of tests/test_adapt.py's interleaved relayout stream
ADAPT_SCOPE = "/bb/hot"
ADAPT_FILES, ADAPT_CHUNKS = 16, 8          # per node: 16 files x 8 chunks
ADAPT_READS = 12                           # cross-rank reads, a tick each
ADAPT_DRIFT = dict(patience=2, cooldown=3, min_weight=4.0)
ADAPT_HORIZON, ADAPT_STEP, ADAPT_PER_TICK = 1e4, 256, 4
STREAM_DIGEST = "cfd76da6b40767fb96d3095ded4fbb01"

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
def sass_count(kernels, name: str, op: str, also: str = "") -> int:
    """Lines of one library's SASS (``cuobjdump -sass``) holding ``op``
    (and ``also``, where given)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(kernels.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-2000:]}")
    return sum(op in line and also in line for line in sass.stdout.splitlines())


def hist_other_library() -> Path:
    """Where ``dest_histogram.cu`` built with ``HIST_OTHER_SHAPE`` goes."""
    from repro_torch import kernels
    lib = kernels.library_path("dest_histogram")
    tag = "-".join(f"{k.lower()}{v}" for k, v in HIST_OTHER_SHAPE.items())
    return lib.with_name(f"{lib.stem}-{tag}.so")


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    other = hist_other_library()
    other.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS,
         *(f"-D{k}={v}" for k, v in HIST_OTHER_SHAPE.items()),
         "-o", str(other), str(kernels.CSRC / "dest_histogram.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        reports = kernels.build(kernels.KERNELS)
    finally:
        out, _ = proc.communicate()
    check(proc.returncode == 0, f"dest_histogram with {HIST_OTHER_SHAPE}: "
                                f"nvcc exit {proc.returncode}:\n{out}")
    log(f"[build] dest_histogram with {HIST_OTHER_SHAPE} -> "
        f"build/{other.name}")
    for name in kernels.KERNELS:
        lib = kernels.library_path(name)
        check(lib.exists(), f"{name}: no library after the build")
        log(f"[build] {name} -> build/{lib.name}")
        for line in reports.get(name, "").splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "entry function" in line or "wgmma" in line):
                log(f"[build]   {line.strip()[:140]}")
    log(f"[build] {len(kernels.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, in parallel)")
    counts = {op: sass_count(kernels, "flash_attention", op)
              for op in ("HGMMA", "UTMALDG")}
    log(f"[build] flash_attention SASS: {counts}")
    for op, n in counts.items():
        check(n > 0, f"flash_attention's SASS holds no {op}")
    for name in ("flash_attention_f32", "flash_attention_wide"):
        tf32 = sass_count(kernels, name, "HMMA", "TF32")
        log(f"[build] {name} SASS: {tf32} HMMA lines with a TF32 type "
            f"(3xTF32 on the tensor cores)")
        check(tf32 > 0, f"{name}'s SASS holds no TF32 HMMA")


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


def first_write_inputs(seed: int) -> dict:
    """The kernels' inputs on the deployment's first write, rebuilt with
    the port's own planner: the data plane's destinations and validity
    (``dest``, ``valid``), its measured spec and the spec's device table
    (``route_plan``'s and ``dest_budgets``' inputs), the same destinations
    with the invalid-slot sentinel (``hist_in``, the per-row histogram's
    input), the send-order pack (``fields``, rebased slots ``idx``) and the
    ragged exchange's receive map (``recv_rows``)."""
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
    hist_in = torch.where(valid, dest, N_NODES).to(torch.int32)
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
    tables = xp.spec_tables(spec, dest.device)
    return dict(dest=dest, valid=valid, spec=spec, table=tables.table,
                hist_in=hist_in, fields=fields.contiguous(), idx=idx,
                recv_rows=tables.recv_rows.reshape(-1))


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
    err = {"dest_histogram2d": 0.0, "pack_chunks": 0.0, "route_plan": 0.0,
           "dest_budgets": 0.0}
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

    inp = first_write_inputs(seed)
    spec = inp["spec"]
    hist_case("main path (write data plane)", inp["hist_in"], N_NODES + 1)
    planner_vs_plain(inp, rng, err)
    pack_case("main path (write send pack)", inp["fields"], inp["idx"])
    packed = pack_chunks(inp["fields"], inp["idx"])
    pack_case("main path (ragged receive view)", packed, inp["recv_rows"])
    del packed, inp
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


def planner_vs_plain(inp: dict, rng: np.random.RandomState,
                     err: dict) -> None:
    """``route_plan`` and ``dest_budgets`` against their plain versions,
    bit for bit: the first write's data plane (its measured spec's table),
    then the sweep of the CPU tests (N 1/8/32/64 × q 0/1/8/33/100, rows
    all invalid, skewed rows, destinations outside [0, N); uniform budgets
    {1, 3, q}, the measured ones, one below them, random ones) and
    (32, 1024) at 256 nodes, (32, 100) at 2048 nodes, (3, 40) at 49,999."""
    from repro_torch.kernels.chunk_router.chunk_router import (dest_budgets,
                                                              route_plan)
    from repro_torch.kernels.chunk_router.ref import (dest_budgets_ref,
                                                      route_plan_ref)
    dev = torch.device(DEVICE)
    cases = 0

    def plan_case(dest, valid, table, total):
        got = route_plan(dest, valid, table, total=total)
        torch.cuda.synchronize()
        want = route_plan_ref(dest, valid, table, total=total)
        for name, a, w in zip(("send_idx", "reply_idx", "overflow",
                               "counts"), got, want):
            err["route_plan"] = max(err["route_plan"], max_abs_err(a, w))
            check(torch.equal(a, w), f"route_plan {name} differs at "
                                     f"{tuple(dest.shape)}, N "
                                     f"{table.shape[1]}, total {total}")

    def budgets_case(dest, valid, n):
        got = dest_budgets(dest, valid, n)
        torch.cuda.synchronize()
        want = dest_budgets_ref(dest, valid, n)
        err["dest_budgets"] = max(err["dest_budgets"], max_abs_err(got, want))
        check(torch.equal(got, want), f"dest_budgets differs at "
                                      f"{tuple(dest.shape)}, N {n}")
        return got.cpu().numpy()

    budgets_case(inp["dest"], inp["valid"], N_NODES)
    plan_case(inp["dest"], inp["valid"], inp["table"], inp["spec"].total)
    log(f"[kernels] route_plan / dest_budgets main path (write data plane, "
        f"(32, 8), N {N_NODES}, total {inp['spec'].total}): equal")
    shapes = ([(n + 2, q, n) for n in (1, 8, 32, 64)
               for q in (0, 1, 8, 33, 100)] +
              [(32, 1024, 256), (32, 100, 2048), (3, 40, 49999)])
    for L, q, n in shapes:
        for skewed in (False, True):
            dest = rng.randint(-1, n + 1, (L, q)).astype(np.int32)
            if skewed:
                dest[:, : 3 * q // 4] = rng.randint(0, min(n, 2), (L, 1))
            valid = rng.rand(L, q) > 0.2
            valid[0] = False
            dest = torch.as_tensor(dest, device=dev)
            valid = torch.as_tensor(valid, device=dev)
            measured = budgets_case(dest, valid, n)
            for b in ([np.full(n, b) for b in sorted({1, 3, q})] +
                      [measured, np.maximum(measured - 1, 0),
                       rng.randint(0, q + 2, n)]):
                if n * int(b.max()) > 1 << 24:
                    continue
                table = torch.as_tensor(np.stack([b, np.cumsum(b) - b]).astype(
                    np.int32), device=dev)
                plan_case(dest, valid, table, int(b.sum()))
                cases += 1
    log(f"[kernels] route_plan: {cases} sweep plans, dest_budgets: "
        f"{2 * len(shapes)} sweep specs, all equal (max_abs_err "
        f"{err['route_plan']}, {err['dest_budgets']})")


def embedding_leaf(gen: torch.Generator) -> torch.Tensor:
    """A leaf the size of gemma3-1b's embedding: 262144 × 1152 float32."""
    return torch.randn((262144, 1152), device=DEVICE, generator=gen)


def phase_checkpoint_kernels_vs_plain(seed: int) -> dict:
    """``fletcher`` and ``route_chunks`` against their plain versions, bit
    for bit, at the checkpoint path's shapes and at edge shapes."""
    from repro_torch.checkpoint.manager import CHUNK_WORDS
    from repro_torch.core.layouts import str_hash
    from repro_torch.kernels.chunk_router.chunk_router import route_chunks
    from repro_torch.kernels.chunk_router.ops import leaf_table, route_leaves
    from repro_torch.kernels.chunk_router.ref import (
        route_chunks_ref, route_chunks_segmented_ref)
    from repro_torch.kernels.fletcher.fletcher import (fletcher_chunks,
                                                       fletcher_segmented)
    from repro_torch.kernels.fletcher.ops import as_words
    from repro_torch.kernels.fletcher.ref import (fletcher_chunks_ref,
                                                  fletcher_segmented_ref)
    err = {"fletcher": 0.0, "fletcher_segmented": 0.0, "route_chunks": 0.0,
           "route_chunks_segmented": 0.0}
    rng = np.random.RandomState(seed)
    dev = torch.device(DEVICE)

    def fl_case(label, words, chunk):
        got = fletcher_chunks(words, chunk)
        torch.cuda.synchronize()
        ref = fletcher_chunks_ref(words, chunk)
        e = max_abs_err(got, ref)
        err["fletcher"] = max(err["fletcher"], e)
        check(torch.equal(got, ref), f"fletcher {label} differs")
        log(f"[kernels] fletcher {label}: {words.numel()} words, chunks of "
            f"{chunk} -> {tuple(got.shape)}: equal (max_abs_err {e})")

    for n, chunk in ((1, CHUNK_WORDS), (1000, 1000), (1023, 1024),
                     (1025, 1024), (3 * CHUNK_WORDS + 17, CHUNK_WORDS),
                     (2 * CHUNK_WORDS, CHUNK_WORDS), (0, CHUNK_WORDS),
                     (300001, 300001)):
        w = rng.randint(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64).astype(
            np.int32)
        if n:
            w[rng.randint(0, n, max(1, n // 50))] = -2 ** 31    # -0.0
            w[rng.randint(0, n, max(1, n // 50))] = 2 ** 31 - 1
        fl_case("edge", torch.as_tensor(w, device=dev), chunk)
    def words(n):
        w = rng.randint(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64).astype(
            np.int32)
        w[:n // 3] = -2 ** 31
        return torch.as_tensor(w, device=dev)

    # the segmented form: empty and one-word leaves, exact multiples of
    # the chunk, bases 4, 8 and 12 bytes past 16-byte alignment, 3000
    # leaves (three rounds of the leaf search)
    for chunk in (CHUNK_WORDS, 1000, 1):
        big = words(4 * chunk + 9)
        leaves = [words(0), words(1), words(chunk), words(3 * chunk),
                  big[1:], words(chunk + 17), big[2:chunk + 5], big[3:],
                  words(0), words(7)]
        cases = [(f"mixed leaves, chunks of {chunk}", leaves)]
        if chunk == 1000:
            cases.append(("3000 leaves, chunks of 1000",
                          [words(int(n)) for n in
                           rng.randint(0, 3000, 3000)]))
        for label, leaves in cases:
            got = fletcher_segmented(leaves, chunk)
            torch.cuda.synchronize()
            want = fletcher_segmented_ref(leaves, chunk)
            e = max_abs_err(got, want)
            err["fletcher_segmented"] = max(err["fletcher_segmented"], e)
            check(torch.equal(got, want) and torch.equal(
                got, torch.cat([fletcher_chunks(w, chunk) for w in leaves])),
                f"fletcher_segmented {label} differs")
            log(f"[kernels] fletcher_segmented {label}: {len(leaves)} "
                f"leaves -> {tuple(got.shape)}: equal to the plain version "
                f"and the per-leaf kernel (max_abs_err {e})")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    emb = embedding_leaf(gen)
    emb[0, :64] = -0.0
    fl_case("main path (embedding leaf)", as_words(emb), CHUNK_WORDS)
    del emb
    torch.cuda.empty_cache()

    for mode in (1, 2, 3, 4):
        for n in (1, 1000, 45770):
            for nodes in (32, 64):
                ph = torch.as_tensor(rng.randint(0, 2 ** 31 - 1, n).astype(
                    np.int32), device=dev)
                cid = torch.arange(n, dtype=torch.int32, device=dev)
                cl = cid % nodes
                d, c = route_chunks(ph, cid, cl, mode=mode, n_nodes=nodes)
                torch.cuda.synchronize()
                rd, rc = route_chunks_ref(ph, cid, cl, mode=mode,
                                          n_nodes=nodes)
                e = max(max_abs_err(d, rd), max_abs_err(c, rc))
                err["route_chunks"] = max(err["route_chunks"], e)
                check(torch.equal(d, rd) and torch.equal(c, rc),
                      f"route_chunks mode {mode} n {n} nodes {nodes} differs")
    log(f"[kernels] route_chunks modes 1-4 x n 1/1000/45770 x nodes 32/64: "
        f"equal (max_abs_err {err['route_chunks']})")

    # the segmented form: a whole save's leaf table (gemma3-1b's 251 leaves
    # under the deployment policy), then mixed modes, empty leaves and
    # 20000 leaves (offsets past 48 KB of shared memory)
    paths, n_chunks = save_leaves(TRAIN_STEPS)
    policy = deployment_policy()
    cases = [("main path (one save)",
              leaf_table([str_hash(p) for p in paths],
                         [int(policy.mode_for_path(p)) for p in paths],
                         n_chunks), N_NODES)]
    for n_leaves, nodes in ((7, 64), (251, 7), (20000, 32), (3, 20000)):
        nc = rng.randint(0, 4609 if n_leaves < 1000 else 4, n_leaves)
        nc[0] = max(nc[0], 1)
        cases.append((f"edge {n_leaves} leaves", leaf_table(
            rng.randint(0, 2 ** 31 - 1, n_leaves),
            rng.randint(1, 5, n_leaves), nc), nodes))
    for label, (table, offsets), nodes in cases:
        got = route_leaves(table, int(offsets[-1]), n_nodes=nodes,
                           device=dev)
        torch.cuda.synchronize()
        want = route_chunks_segmented_ref(torch.as_tensor(table, device=dev),
                                          int(offsets[-1]), n_nodes=nodes)
        e = max_abs_err(got, want)
        err["route_chunks_segmented"] = max(err["route_chunks_segmented"], e)
        check(torch.equal(got, want), f"route_chunks_segmented {label} "
                                      f"differs")
        log(f"[kernels] route_chunks_segmented {label}: {len(table)} "
            f"leaves, {int(offsets[-1])} chunks, {nodes} nodes: equal "
            f"(max_abs_err {e})")
    return err


# ---------------------------------------------------------------------------
# (b2) the last two kernels through their entry points
# ---------------------------------------------------------------------------
def global_layer_qkv(cfg, params: dict, seed: int):
    """q, k, v (B, S, H, D) of gemma3's first global layer at the training
    batch: the layer's norm, projections and RoPE (the port's own
    ``project_qkv``) on bf16 activations made from the seed; k and v are
    GQA-expanded from the one kv head to 4."""
    from repro_torch.models import layers as nnl
    from repro_torch.models.attention import project_qkv
    from repro_torch.models.transformer import (_layer_slice,
                                                layer_kind_list, segments)
    check(layer_kind_list(cfg)[GLOBAL_LAYER] == "global",
          f"layer {GLOBAL_LAYER} of {cfg.name} is not global")
    first = 0
    for i, (kind, n) in enumerate(segments(cfg)):
        if first <= GLOBAL_LAYER < first + n:
            layer = _layer_slice(params["stack"][f"seg{i}_{kind}"],
                                 GLOBAL_LAYER - first)
            break
        first += n
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), device=DEVICE,
                    generator=gen).to(torch.bfloat16)
    h = nnl.rms_norm(x, layer["ln_attn"], cfg.norm_eps, zero_centered=True)
    pos = torch.arange(TRAIN_SEQ, dtype=torch.int32, device=DEVICE)[None, :]
    return project_qkv(layer["attn"], h, pos, cfg)


def save_leaves(step: int):
    """The leaf paths and chunk counts of one gemma3-1b save under the
    deployment policy (the checkpoint manager's own paths; shapes only:
    the state is made of meta tensors)."""
    from repro_torch.checkpoint.manager import CHUNK_WORDS, flatten_state
    from repro_torch.configs import all_configs
    from repro_torch.kernels.fletcher.ops import as_words
    from repro_torch.kernels.fletcher.ref import n_chunks_of
    from repro_torch.models.param import map_tree, torch_dtype
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import AdamW
    cfg = all_configs()[TRAIN_ARCH]
    params = map_tree(lambda p: torch.empty(p.shape, device="meta",
                                            dtype=torch_dtype(
                                                p.dtype or cfg.param_dtype)),
                      build_model(cfg).describe())
    state = (params, AdamW().init(params),
             torch.zeros(2, dtype=torch.int32, device="meta"))
    leaves = flatten_state(state)
    return ([f"/bb/ckpt/{step}/{key}" for key, _ in leaves],
            [n_chunks_of(as_words(t).numel(), CHUNK_WORDS) for _, t in leaves])


def save_destinations() -> torch.Tensor:
    """The destinations of every chunk of one gemma3-1b save under the
    deployment policy, leaf after leaf: the checkpoint manager's own
    routing (one launch)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, deployment_policy(), async_save=False)
        paths, n_chunks = save_leaves(TRAIN_STEPS)
        check(all(p.startswith(mgr.scope + "/") for p in paths),
              f"checkpoint scope {mgr.scope} is not /bb/ckpt")
        dest, _ = mgr.route(paths, n_chunks, DEVICE)
    return dest


def decided_rows(q: torch.Tensor, k: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """(B, S, H) mask of the causal query rows whose top score leads the
    runner-up by at least TIE_GAP (scores in float64): there the runner-up
    weighs under e^-TIE_GAP, so neither float32 rounding of the scores nor
    bf16 rounding of P moves the output by the bf16 tolerance."""
    B, S, H, D = q.shape
    rows = []
    for b in range(B):
        for h in range(H):
            s = (q[b, :, h].double() @ k[b, :, h].double().T) * scale
            s = s.masked_fill(~torch.ones_like(s, dtype=torch.bool).tril(),
                              float("-inf"))
            top = s.topk(min(2, S), dim=-1).values
            gap = top[:, 0] - top[:, -1] if S > 1 else top[:, 0]
            rows.append((gap >= TIE_GAP) | ~torch.isfinite(gap))
    return torch.stack(rows).reshape(B, H, S).transpose(1, 2)


def causal_attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Causal attention over (B, S, H, D) computed in float64 throughout
    (the plain version casts to float32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    S = q.shape[1]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double())


def attention_flops(B: int, S: int, H: int, D: int, causal: bool) -> float:
    """Multiply-adds ×2 of QKᵀ and PV over the (query, key) pairs the mask
    keeps: S(S+1)/2 of them causal, S² full."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4.0 * B * H * D * pairs


def device_ops(fn) -> dict:
    """The operations one call of ``fn`` puts on the card (kernels, copies,
    memsets), by name, from ``torch.profiler``: the session that recorded
    the most of three (one now and then records only part of them)."""
    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(3):
        ops = {e.key: e.count for e in profiled(fn, 1)}
        if sum(ops.values()) > sum(best.values()):
            best = ops
    return best


_HIST_OTHER = {}


def histogram_path(dest: torch.Tensor, n_bins: int, path: str
                   ) -> torch.Tensor:
    """``dest_histogram``'s kernel with its path forced: "cluster" (one
    thread-block cluster, one launch) or "grid" (the earlier design: a
    memset, then up to two blocks an SM), through the kernel's own
    launch; or "other": the cluster path of the library built with
    ``HIST_OTHER_SHAPE``."""
    from repro_torch.kernels.chunk_router.chunk_router import DEST_HISTOGRAM
    counts = torch.empty(n_bins, dtype=torch.int32, device=dest.device)
    args = (dest.data_ptr(), counts.data_ptr(), dest.numel(), n_bins,
            -1 if path == "grid" else 2 ** 62)
    if path != "other":
        DEST_HISTOGRAM.launch(*args)
        return counts
    fn = _HIST_OTHER.get("fn")
    if fn is None:
        fn = _HIST_OTHER["fn"] = ctypes.CDLL(
            str(hist_other_library())).dest_histogram
        fn.argtypes = DEST_HISTOGRAM.argtypes
        fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"dest_histogram with {HIST_OTHER_SHAPE}: CUDA error "
                    f"{err}")
    return counts


def phase_last_kernels(seed: int, counters, f32_counter,
                       wide_counter) -> dict:
    """This slice's path: ``flash_attention`` and ``histogram_rows`` at the
    shapes the port's paths give them, then checks and times.
    ``counters`` are the bf16 attention and histogram kernels' (the main
    path), ``f32_counter`` the float32 attention kernel's (the float32
    calls at the same shape), ``wide_counter`` the wide float32 kernel's
    (the calls at head dims above 256)."""
    import torch.nn.functional as F
    from repro_torch.configs import all_configs
    from repro_torch.kernels.chunk_router.ops import histogram_rows
    from repro_torch.kernels.chunk_router.ref import dest_histogram_ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_bhsd
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         flash_attention_ref)
    from repro_torch.models.attention import masked_attention
    from repro_torch.models.registry import build_model
    # the plain versions' products in full float32 (the card's default,
    # stated and set here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    err, times = {}, {}
    torch.cuda.reset_peak_memory_stats()
    cfg = all_configs()[TRAIN_ARCH]
    params = build_model(cfg).init(seed)
    q, k, v = global_layer_qkv(cfg, params, seed)
    del params
    torch.cuda.empty_cache()
    dest = save_destinations()
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s00 = (q[0, :, 0].float() @ k[0, :, 0].float().T) * scale
    s00 = s00.masked_fill(~torch.ones_like(s00, dtype=torch.bool).tril(),
                          -1e30)
    top = torch.softmax(s00, dim=-1).max(dim=-1).values.mean()
    log(f"[last] flash_attention input: layer {GLOBAL_LAYER} of {cfg.name}, "
        f"q/k/v {tuple(q.shape)} {q.dtype} (batch 0, head 0: causal score "
        f"std {s00[s00 > -1e29].std():.1f}, mean top probability "
        f"{top:.4f}); histogram input: {dest.numel()} chunk destinations "
        f"of one save, {N_NODES} nodes")
    del s00

    # the main path, through the entry points
    for c in counters:
        c.launches = 0
    out = flash_attention(q, k, v, causal=True)
    counts = histogram_rows(dest, n_bins=N_NODES)
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters}
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on this slice's path")
    log(f"[last] launches on this slice's path: {launches}")

    def close(label, got, want, tol, quiet=False):
        e = max_abs_err(got, want)
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"flash_attention {label}: max_abs_err {e} beyond {tol}")
        if not quiet:
            log(f"[last] flash_attention {label}: within {tol} "
                f"(max_abs_err {e})")
        return e

    # the reference init's layer-5 scores reach ~1.4e4 (ROADMAP Queue 3):
    # most rows' softmax is decided, a few are near-ties between two keys,
    # where float32 rounding of the scores alone moves the output past 2e-2
    # (the plain version against its own float64 evaluation).  2e-2 holds
    # on every decided row; the near-ties are counted and reported
    check(out.shape == q.shape and out.dtype == q.dtype and
          bool(torch.isfinite(out).all()),
          "flash_attention main path: wrong shape, dtype or non-finite")
    plain = flash_attention_ref(q, k, v, scale=scale, causal=True)
    decided = decided_rows(q, k, scale)
    n_tie = int((~decided).sum())
    log(f"[last] layer {GLOBAL_LAYER}: {decided.numel() - n_tie} of "
        f"{decided.numel()} query rows decided (runner-up key's weight "
        f"below e^-{TIE_GAP}), {n_tie} near-ties")
    err["flash_attention"] = close(
        "main path vs plain (bf16, causal), decided rows", out[decided],
        plain[decided], ATTN_TOL[torch.bfloat16])
    close("main path vs masked_attention(window=0), decided rows",
          out[decided], masked_attention(q, k, v, window=0,
                                         scale=scale)[decided],
          ATTN_TOL[torch.bfloat16])
    if n_tie:
        exact = causal_attention_f64(q, k, v, scale)
        sdpa = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2)
        tie = ~decided

        def beyond(got, want):
            g, w = got[tie].double(), want[tie].double()
            tol = ATTN_TOL[torch.bfloat16]
            return (f"max_abs_err {max_abs_err(g, w):.4g}, "
                    f"{int(((g - w).abs() > tol + tol * w.abs()).sum())} "
                    f"elements beyond {tol}")
        log(f"[last] near-tie rows ({n_tie}): kernel vs plain "
            f"{beyond(out, plain)}; SDPA vs plain {beyond(sdpa, plain)}; "
            f"kernel vs SDPA {beyond(out, sdpa)}; float32 plain vs float64 "
            f"{beyond(plain, exact.to(plain.dtype))}")
        del exact, sdpa
    del plain
    ref_counts = dest_histogram_ref(dest, n_bins=N_NODES)
    err["dest_histogram"] = max_abs_err(counts, ref_counts)
    check(torch.equal(counts, ref_counts) and
          int(counts.sum()) == dest.numel(),
          "dest_histogram on the save's destinations differs")
    log(f"[last] dest_histogram main path: equal (max_abs_err "
        f"{err['dest_histogram']}); counts {counts.tolist()}")

    # float32 at the same shape, through the SIMT kernel: unit-normal
    # q/k/v (the reference init's layer-5 scores reach ~1e3, where float32
    # rounding of the scores alone moves a near-tie's softmax past 2e-5;
    # that is conditioning, not the kernel)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    f32 = [torch.randn((B, S, H, D), device=dev, generator=gen)
           for _ in range(3)]
    f32_counter.launches = 0
    f32_out = {causal: flash_attention(*f32, causal=causal)
               for causal in (True, False)}
    torch.cuda.synchronize()
    launches[f32_counter.name] = f32_counter.launches
    check(f32_counter.launches > 0,
          f"{f32_counter.name} never launched on the float32 calls")
    err[f32_counter.name] = max(
        close(f"float32 {'causal' if causal else 'full'} {(B, S, H, D)}",
              f32_out[causal],
              flash_attention_ref(*f32, scale=scale, causal=causal),
              ATTN_TOL[torch.float32]) for causal in (True, False))
    del f32_out
    bf = [a.to(torch.bfloat16) for a in f32]
    for causal in (True, False):
        close(f"bf16 unit-normal {'causal' if causal else 'full'} "
              f"{(B, S, H, D)}, every element",
              flash_attention(*bf, causal=causal),
              flash_attention_ref(*bf, scale=scale, causal=causal),
              ATTN_TOL[torch.bfloat16])
    del bf
    log(f"[last] launches of the float32 calls: "
        f"{{{f32_counter.name!r}: {launches[f32_counter.name]}}}")

    # sweeps: bf16 over every head dim and ragged S, the JAX sweep's
    # shapes in both dtypes, strided views, a misaligned view
    def rand(shape, dtype):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev).to(dtype)

    n_sweep = 0
    for d in (64, 80, 128, 256):
        for s_len in (1, 63, 64, 65, 96, 128, 256, 512, 1000, 1024):
            for causal in (True, False):
                x = [rand((2, s_len, 3, d), torch.bfloat16) for _ in range(3)]
                close(f"bf16 {(2, s_len, 3, d)} causal={causal}",
                      flash_attention(*x, causal=causal),
                      flash_attention_ref(*x, scale=d ** -0.5,
                                          causal=causal),
                      ATTN_TOL[torch.bfloat16], quiet=True)
                n_sweep += 1
    log(f"[last] flash_attention bf16 sweep D 64/80/128/256 x S "
        f"1/63/64/65/96/128/256/512/1000/1024 x causal/full: {n_sweep} "
        f"cases within {ATTN_TOL[torch.bfloat16]}")
    # the float32 kernel (3xTF32 on the tensor cores) over the same head
    # dims, unit-normal q/k/v
    worst, n_sweep = 0.0, 0
    for d in (64, 80, 128, 256):
        for s_len in (1, 63, 64, 65, 1000, 1024):
            for causal in (True, False):
                x = [rand((2, s_len, 3, d), torch.float32) for _ in range(3)]
                worst = max(worst, close(
                    f"float32 {(2, s_len, 3, d)} causal={causal}",
                    flash_attention(*x, causal=causal),
                    flash_attention_ref(*x, scale=d ** -0.5, causal=causal),
                    ATTN_TOL[torch.float32], quiet=True))
                n_sweep += 1
    err[f32_counter.name] = max(err[f32_counter.name], worst)
    log(f"[last] flash_attention float32 sweep D 64/80/128/256 x S "
        f"1/63/64/65/1000/1024 x causal/full: {n_sweep} cases within "
        f"{ATTN_TOL[torch.float32]} (max_abs_err {worst})")
    shapes = ((2, 128, 2, 64), (1, 256, 4, 64), (2, 96, 3, 80),
              (1, 512, 1, 128), (2, 96, 2, 256), (1, 1000, 2, 256),
              (2, 1, 2, 256), (2, 63, 2, 80), (1, 65, 2, 256),
              (1, 64, 3, 80))
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                x = [rand(shape, dtype) for _ in range(3)]
                close(f"{shape} {dtype} causal={causal}",
                      flash_attention(*x, causal=causal),
                      flash_attention_ref(*x, scale=shape[3] ** -0.5,
                                          causal=causal),
                      ATTN_TOL[dtype], quiet=True)
    log(f"[last] flash_attention sweep {' '.join(map(str, shapes))} x "
        f"f32/bf16 x causal/full: within tolerance")
    for dtype in (torch.bfloat16, torch.float32):
        for d in (80, 256):
            # q a head-dim slice of a wider tensor, k (B, H, S, D)
            # contiguous, v a (B, S, H, D) transpose: three stride patterns
            qw = rand((2, 200, 3, 2 * d), dtype)[..., :d].transpose(1, 2)
            kc = rand((2, 3, 200, d), dtype)
            vt = rand((2, 200, 3, d), dtype).transpose(1, 2)
            for causal in (True, False):
                got = flash_attention_bhsd(qw, kc, vt, scale=0.1,
                                           causal=causal)
                want = attention_ref(*(a.reshape(6, 200, d) for a in
                                       (qw.contiguous(), kc, vt.contiguous())),
                                     scale=0.1, causal=causal)
                close(f"strided {dtype} D={d} causal={causal}",
                      got.reshape(6, 200, d), want, ATTN_TOL[dtype],
                      quiet=True)
    log("[last] flash_attention strided views (head-dim slice, contiguous "
        "(B, H, S, D), (B, S, H, D) transpose) x bf16/f32 x D 80/256 x "
        "causal/full: within tolerance")
    bad = rand((2 * 96 * 3 * 64 + 1,), torch.bfloat16)[1:].view(
        2, 96, 3, 64)
    before = counters[0].launches
    try:
        flash_attention_bhsd(bad.transpose(1, 2), bad.transpose(1, 2),
                             bad.transpose(1, 2), scale=0.125)
        raised = False
    except ValueError:
        raised = True
    check(raised and counters[0].launches == before,
          "a bf16 view one element off alignment did not raise in the "
          "kernel's wrapper")
    got = flash_attention(bad, bad, bad, causal=True)
    check(counters[0].launches == before + 1,
          "the entry point did not launch the bf16 kernel on a copy")
    close("bf16 view one element off 16-byte alignment, entry point",
          got, flash_attention_ref(bad, bad, bad, scale=0.125, causal=True),
          ATTN_TOL[torch.bfloat16])
    log("[last] flash_attention bf16 view one element off 16-byte "
        "alignment: the wrapper raised with no launch; the entry point "
        "copied it and launched once")

    # what the entry point takes beyond the kernels' instances: head dims
    # padded to the next one, float16 through the float32 kernel, the
    # reference's keywords
    for d in (16, 32, 96, 192):
        for dtype in (torch.float32, torch.bfloat16):
            x = [rand((2, 130, 3, d), dtype) for _ in range(3)]
            close(f"padded head dim {d} {dtype}",
                  flash_attention(*x, causal=True, block_q=512, block_k=512,
                                  interpret=False),
                  flash_attention_ref(*x, scale=d ** -0.5, causal=True),
                  ATTN_TOL[dtype], quiet=True)
    log("[last] flash_attention head dims 16/32/96/192 (padded to 64/64/"
        "128/256) x f32/bf16, keywords block_q/block_k/interpret: within "
        "tolerance")
    before = f32_counter.launches
    for d in (64, 96):
        x = [rand((2, 200, 3, d), torch.float16) for _ in range(3)]
        got = flash_attention(*x, causal=True)
        check(got.dtype == torch.float16, "float16 in, not float16 out")
        close(f"float16 D={d} (the float32 kernel, rounded once)", got,
              flash_attention_ref(*(a.float() for a in x), scale=d ** -0.5,
                                  causal=True).half(),
              ATTN_TOL[torch.float16])
    check(f32_counter.launches == before + 2,
          "float16 did not run the float32 kernel")

    # head dims above 256: the wide float32 kernel (bf16 computed in
    # float32 and rounded once), with its count zeroed just before
    wide_counter.launches = 0
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for d in (320, 512, 640):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                x = [rand((2, 200, 3, d), dtype) for _ in range(3)]
                got = flash_attention(*x, causal=causal)
                check(got.shape == x[0].shape and got.dtype == dtype,
                      f"wide head dim {d} {dtype}: wrong shape or dtype")
                worst[dtype] = max(worst[dtype], close(
                    f"wide head dim {d} {dtype} causal={causal}", got,
                    flash_attention_ref(*x, scale=d ** -0.5, causal=causal),
                    ATTN_TOL[dtype], quiet=True))
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    wide = [torch.randn((B, S, H, 512), device=dev, generator=gen)
            for _ in range(3)]
    worst[torch.float32] = max(worst[torch.float32], close(
        f"wide float32 causal {(B, S, H, 512)}",
        flash_attention(*wide, causal=True),
        flash_attention_ref(*wide, scale=512 ** -0.5, causal=True),
        ATTN_TOL[torch.float32]))
    torch.cuda.synchronize()
    launches[wide_counter.name] = wide_counter.launches
    check(wide_counter.launches == 13,
          f"{wide_counter.name}: {wide_counter.launches} launches for 13 "
          f"calls above head dim 256")
    err[wide_counter.name] = worst[torch.float32]
    log(f"[last] flash_attention head dims 320/512/640 x f32/bf16 x "
        f"causal/full "
        f"and (4, 1024, 4, 512) float32 causal through the wide kernel: "
        f"within tolerance (max_abs_err float32 {worst[torch.float32]}, "
        f"bf16 {worst[torch.bfloat16]}); launches "
        f"{{{wide_counter.name!r}: {wide_counter.launches}}}")

    def hist_case(label, d, n_bins):
        got = histogram_rows(d, n_bins=n_bins)
        torch.cuda.synchronize()
        check(torch.equal(got, dest_histogram_ref(d, n_bins=n_bins)),
              f"dest_histogram {label} n={d.numel()} n_bins={n_bins} "
              f"differs")

    for n in (0, 8, 100, 1024, 4097):
        for nb in (4, 33):
            hist_case("sweep", torch.as_tensor(
                rng.randint(-1, nb + 2, n).astype(np.int32), device=dev), nb)
    micro = torch.as_tensor(rng.randint(-1, 64, 4096).astype(np.int32),
                            device=dev)
    hist_case("microbench 4096 -> 64", micro, 64)
    hist_case("20000 bins", torch.as_tensor(
        rng.randint(-1, 20002, 100000).astype(np.int32), device=dev), 20000)
    hist_case("all sentinel", torch.full((5000,), -1, dtype=torch.int32,
                                         device=dev), 33)
    # 16 M values into the save's 32 bins, sentinel-free like the save's
    # destinations (bincount, timed beside it, takes no negative value)
    large = torch.as_tensor(rng.randint(0, N_NODES, 1 << 24).astype(
        np.int32), device=dev)
    hist_case("large", large, N_NODES)
    # both of the kernel's paths, forced, on the sweep and the main shapes
    n_paths = 0
    for d, nb in ([(torch.as_tensor(rng.randint(-1, nb + 2, n).astype(
            np.int32), device=dev), nb) for n in (8, 100, 1024, 4097)
                   for nb in (4, 33)] +
                  [(dest, N_NODES), (large, N_NODES), (micro, 64)]):
        want = dest_histogram_ref(d, n_bins=nb)
        for path in ("cluster", "grid", "other"):
            got = histogram_path(d, nb, path)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"dest_histogram {path} path "
                                          f"n={d.numel()} n_bins={nb} "
                                          f"differs")
            n_paths += 1
    log(f"[last] dest_histogram sweep n 0/8/100/1024/4097 x bins 4/33, "
        f"4096 -> 64, 100000 -> 20000, all sentinel, the save's "
        f"{dest.numel()} destinations, {large.numel()} values -> {N_NODES} "
        f"bins: equal; both paths and the cluster path with "
        f"{HIST_OTHER_SHAPE} forced ({n_paths} cases): equal")

    # times (card and power limit printed at the end): kernel and SDPA in
    # turns, best of each, as device time (the profiler's sum of kernel
    # times: back to back, the wrapper's host work, not the card, would
    # set the pace of a 0.03 ms kernel; that rate is logged apart)
    # three turns each, the median kept (not the best of two): a
    # profiler session that records only part of a call's device work
    # reads low; one below the bound is taken again (device_ms), and one
    # low session above it must not decide the figure.  ``floor`` bounds
    # the kernel's work, ``lib_floor`` the library's
    def turns(kernel, library, reps, floor, lib_floor):
        ks, ls = [], []
        for _ in range(3):
            ks.append(device_ms(kernel, reps, floor))
            ls.append(device_ms(library, reps, lib_floor))
        return median(ks), median(ls), ks, ls

    def in_turns(ks, ls):
        return ", ".join(f"kernel {k:.5f}, SDPA {v:.5f}"
                         for k, v in zip(ks, ls)) + " ms"

    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    nbytes = 4 * q.numel() * q.element_size()
    for causal in (True, False):
        b, by = bound_ms(nbytes, attention_flops(B, S, H, D, causal),
                         BF16_TENSOR_OPS_PER_S)
        t_k, t_l, ks, ls = turns(
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal), 50,
            b, b)
        t_p = cuda_ms(lambda: flash_attention_ref(q, k, v, scale=scale,
                                                  causal=causal), 5)
        mode = "causal" if causal else "full"
        log(f"[time] flash_attention bf16 {mode} {(B, S, H, D)}, device "
            f"time in turns: {in_turns(ks, ls)}")
        times[f"flash_attention {mode}"] = dict(
            ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b, bound_by=by,
            shape=f"{(B, S, H, D)} bf16 {mode}, device time, bound at the "
                  f"bf16 tensor-core peak; library: "
                  f"scaled_dot_product_attention")
    log(f"[time] flash_attention bf16 causal back to back through the "
        f"entry point: "
        f"{cuda_ms(lambda: flash_attention(q, k, v, causal=True), 100):.4f}"
        f" ms a call (host launch rate)")
    times["flash_attention"] = times.pop("flash_attention causal")
    # float32: the kernel runs three TF32 tensor-core products for each
    # product of the work, so its bound is 3x the work at the TF32 peak;
    # the float32 SIMT peak's bound is printed beside it
    f32t = [a.transpose(1, 2) for a in f32]
    for causal in (True, False):
        mode = "causal" if causal else "full"
        flops = attention_flops(B, S, H, D, causal)
        b32, by32 = bound_ms(4 * f32[0].numel() * 4, 3 * flops,
                             TF32_TENSOR_OPS_PER_S)
        simt, _ = bound_ms(4 * f32[0].numel() * 4, flops)
        # SDPA's floor: the work once at the TF32 peak, whatever it runs
        one, _ = bound_ms(4 * f32[0].numel() * 4, flops,
                          TF32_TENSOR_OPS_PER_S)
        t32, t32l, ks, ls = turns(
            lambda: flash_attention(*f32, causal=causal),
            lambda: F.scaled_dot_product_attention(*f32t, is_causal=causal),
            20, b32, one)
        t32p = cuda_ms(lambda: flash_attention_ref(*f32, scale=scale,
                                                   causal=causal), 5)
        log(f"[time] flash_attention float32 {mode} {(B, S, H, D)}, device "
            f"time in turns: {in_turns(ks, ls)}; bound {b32:.5f} ms (3xTF32 "
            f"at the TF32 peak, {by32}), {b32 / t32:.3f} of it; float32 "
            f"SIMT bound {simt:.5f} ms")
        times[f"{f32_counter.name} {mode}"] = dict(
            ms=t32, plain_ms=t32p, library_ms=t32l, bound_ms=b32,
            bound_by=by32, simt_bound_ms=simt,
            shape=f"{(B, S, H, D)} float32 {mode}, device time, bound: "
                  f"3xTF32 at the TF32 tensor-core peak (float32 SIMT "
                  f"peak: {simt:.4f} ms); library: "
                  f"scaled_dot_product_attention")
    times[f32_counter.name] = times.pop(f"{f32_counter.name} causal")
    del f32, f32t

    # the wide kernel at (4, 1024, 4, 512) float32 causal, SDPA in turns
    widet = [a.transpose(1, 2) for a in wide]
    bw, byw = bound_ms(4 * wide[0].numel() * 4,
                       3 * attention_flops(B, S, H, 512, True),
                       TF32_TENSOR_OPS_PER_S)
    one, _ = bound_ms(4 * wide[0].numel() * 4,
                      attention_flops(B, S, H, 512, True),
                      TF32_TENSOR_OPS_PER_S)
    tw, twl, ks, ls = turns(
        lambda: flash_attention(*wide, causal=True),
        lambda: F.scaled_dot_product_attention(*widet, is_causal=True), 10,
        bw, one)
    twp = cuda_ms(lambda: flash_attention_ref(*wide, scale=512 ** -0.5,
                                              causal=True), 5)
    log(f"[time] {wide_counter.name} float32 causal {(B, S, H, 512)}, "
        f"device time in turns: {in_turns(ks, ls)}")
    times[wide_counter.name] = dict(
        ms=tw, plain_ms=twp, library_ms=twl, bound_ms=bw, bound_by=byw,
        shape=f"{(B, S, H, 512)} float32 causal, device time, bound: "
              f"3xTF32 at the TF32 tensor-core peak; library: "
              f"scaled_dot_product_attention")
    del wide, widet

    # the histogram: the one-cluster path (what the entry point takes at
    # the save's shape) against the grid path (the earlier design) and
    # bincount, from the save's destinations to 16 M values, device time;
    # the operations a call puts on the card
    nb = N_NODES
    ops = device_ops(lambda: histogram_rows(dest, n_bins=nb))
    grid_ops = device_ops(lambda: histogram_path(dest, nb, "grid"))
    lib_ops = device_ops(lambda: torch.bincount(dest, minlength=nb))
    log(f"[time] dest_histogram at the save's shape: device operations a "
        f"call {ops}; grid path {grid_ops}; bincount {lib_ops}")
    check(sum(ops.values()) == 1,
          f"dest_histogram at the save's shape: {ops} on the card, not one "
          f"launch")
    n = dest.numel()
    b, by = bound_ms(n * 4 + nb * 4, n)
    t_p = device_ms(lambda: dest_histogram_ref(dest, n_bins=nb), 50, b)
    # "other": the cluster path in HIST_OTHER_SHAPE, against the shipped
    # shape ("cluster") in the same turns
    sweep = {}
    for d in (dest, large[:1 << 16], large[:1 << 17], large[:1 << 18],
              large[:1 << 20], large[:1 << 22], large):
        floor, _ = bound_ms(d.numel() * 4 + nb * 4, d.numel())
        row = {}
        for rep in range(3):
            for name, fn in (
                    ("entry", lambda: histogram_rows(d, n_bins=nb)),
                    ("cluster", lambda: histogram_path(d, nb, "cluster")),
                    ("other", lambda: histogram_path(d, nb, "other")),
                    ("grid", lambda: histogram_path(d, nb, "grid")),
                    ("bincount", lambda: torch.bincount(d, minlength=nb))):
                row.setdefault(name, []).append(device_ms(fn, 50, floor))
        sweep[d.numel()] = {k: median(v) for k, v in row.items()}
        log(f"[time] dest_histogram n {d.numel()} -> {nb} bins, device ms "
            f"(three turns each, the median kept; other: "
            f"{HIST_OTHER_SHAPE}): " + ", ".join(
                f"{k} " + "/".join(f"{t:.5f}" for t in v)
                for k, v in row.items()))
    host = cuda_ms(lambda: histogram_rows(dest, n_bins=nb), 200)
    log(f"[time] dest_histogram back to back through the entry point: "
        f"{host:.4f} ms a call (host launch rate); microbench 4096 -> 64: "
        f"{device_ms(lambda: histogram_rows(micro, n_bins=64), 50):.5f} ms "
        f"device")
    bl, _ = bound_ms(large.numel() * 4 + nb * 4, large.numel())
    times["dest_histogram"] = dict(
        ms=sweep[n]["entry"], plain_ms=t_p, library_ms=sweep[n]["bincount"],
        bound_ms=b, bound_by=by, pr16_ms=sweep[n]["grid"],
        cluster_ms=sweep[n]["cluster"], host_ms=host,
        large=dict(sweep[large.numel()], bound_ms=bl),
        sweep={str(k): v for k, v in sweep.items()},
        shape=f"{n} save destinations -> {nb} bins, device time; "
              f"library: bincount on this sentinel-free input")
    del large
    for name in ("flash_attention", "flash_attention full", f32_counter.name,
                 f"{f32_counter.name} full", wide_counter.name,
                 "dest_histogram"):
        r = times[name]
        log(f"[time] {name} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['ms']:.3f} of bound")
    log(f"[last] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return {"err": err, "times": times, "launches": launches}


# ---------------------------------------------------------------------------
# (c) the deployment through BBClient
# ---------------------------------------------------------------------------
class PlannerCalls:
    """Counts the planner's routing rounds (``_compact_plan_ragged`` with
    q > 0, which the uniform ``_compact_plan`` also calls) and measured
    specs (``plan_ragged_spec``, as the engine calls it) while active, by
    wrapping the module functions; restores them on exit."""

    def __init__(self):
        from repro_torch.core import burst_buffer as bb
        from repro_torch.core import exchange_plan as xp
        self.rounds = self.specs = 0
        self._targets = [(xp, "_compact_plan_ragged", "rounds"),
                         (bb, "plan_ragged_spec", "specs")]
        self._saved = []

    def __enter__(self):
        for mod, name, field in self._targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def counted(dest, *a, _fn=fn, _field=field, **k):
                if _field == "specs" or dest.shape[1] > 0:
                    setattr(self, _field, getattr(self, _field) + 1)
                return _fn(dest, *a, **k)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def drive_deployment(client, gen: torch.Generator) -> list:
    """The deployment's calls and checks: three fused writes, cross-node
    two-phase reads and stats of each, create, remove; returns the writes'
    (paths, chunk ids, request)."""
    batches = []
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
    return batches


def phase_deployment(seed: int, counters, plan_counter,
                     spec_counter) -> dict:
    """``counters`` are every data-plane kernel's (each must launch);
    ``plan_counter`` must launch exactly once a routing round and
    ``spec_counter`` once a measured spec."""
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
    with PlannerCalls() as planner:
        t0 = time.perf_counter()
        batches = drive_deployment(client, gen)
        torch.cuda.synchronize()
        launches = {c.name: c.launches for c in counters}
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    check(plan_counter.launches == planner.rounds,
          f"{planner.rounds} routing rounds made {plan_counter.launches} "
          f"{plan_counter.name} launches, not one each")
    check(spec_counter.launches == planner.specs,
          f"{planner.specs} measured specs made {spec_counter.launches} "
          f"{spec_counter.name} launches, not one each")
    log(f"[deploy] planner: {planner.rounds} routing rounds, one "
        f"{plan_counter.name} launch each; {planner.specs} measured specs, "
        f"one {spec_counter.name} launch each")
    log(f"[deploy] {N_WRITES} fused writes ({N_WRITES * N_NODES * Q} chunks, "
        f"{N_WRITES * N_NODES * Q} MiB), {N_WRITES} reads, stats, create, "
        f"remove: all checks hold in {time.perf_counter() - t0:.2f} s")
    log(f"[deploy] launches on the data-plane path: {launches}")
    log(f"[deploy] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return {"client": client, "batches": batches, "launches": launches}


def phase_calls(seed: int) -> None:
    """``--calls-only``: build the kernels, fill the deployment (its calls
    and checks) and time and profile one write, read and stat of the last
    write's batch; one JSON line ``{"calls": ...}``.  Uses only what the
    earlier slices' package also has, so that the parent commit's tree can
    be measured by this script in the same machine."""
    from repro_torch import kernels
    from repro_torch.core.client import BBClient
    kernels.build(kernels.KERNELS)
    client = BBClient(deployment_policy(), cap=CAP, words=WORDS, mcap=MCAP)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    req = drive_deployment(client, gen)[-1][2]
    calls = {}
    for name, fn in (("write", lambda: client.write(req)),
                     ("read", lambda: client.read(req)),
                     ("stat", lambda: client.stat(req))):
        calls[name] = {"ms": host_ms(fn, 3)}
    for name, st in profile_client_calls(client, req).items():
        calls[name].update(st)
    log(json.dumps({"calls": calls, "src": str(Path(__file__).resolve()
                                                .parent)}))


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


def profiled(fn, reps: int) -> list:
    """``reps`` calls of ``fn`` in one ``torch.profiler`` session, to the
    end of their device work: the session's device events (kernels,
    copies, memsets), aggregated by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def queued_span_ms(fn, reps: int) -> float:
    """Device span per call of ``reps`` calls of ``fn``, by CUDA events,
    with every call queued behind a sleep on the card so that the host's
    launch gaps fall inside the sleep: the kernels' times and the card's
    own gaps between them.  A call that waits for the card (``bincount``
    does) brings its host time back in.  It cannot read less than the
    work took."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * reps)        # about 1 ms a call queued
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def per_call(events, reps: int):
    """What one call of ``fn`` put on the card, from a session of ``reps``
    calls: its mix of operations (name → times a call, the session's count
    over ``reps`` rounded) and its device time in ms (each operation's mean
    time × its times a call), so that a few records the session lost do
    not lower the time."""
    mix = {e.key: round(e.count / reps) for e in events
           if round(e.count / reps)}
    return mix, sum(e.self_device_time_total / e.count * mix[e.key]
                    for e in events if e.key in mix) / 1e3


def device_ms(fn, reps: int, floor_ms: float = 0.0) -> float:
    """Device time per call: the time of every kernel and copy that a call
    of ``fn`` puts on the card, from ``torch.profiler`` sessions of
    ``reps`` calls (``per_call``).  Unlike events around back-to-back
    calls it leaves out the gaps in which the card waits for the host to
    launch.

    A profiler session now and then records none or only part of the
    device work (about one session in 70 on the H100, once three in a
    row; after training, every session lost 6 of its records).  So a
    reading is kept only where two sessions agree on the largest mix of
    operations any session recorded and each reads at least ``floor_ms``
    (the work's bound, which no call beats); their mean is kept.  After
    six sessions without that, the figure is ``queued_span_ms`` instead,
    which no lost record can lower; a span below ``floor_ms`` fails the
    run."""
    fn()
    torch.cuda.synchronize()
    seen = []                                  # (mix, ms a call)
    for _ in range(6):
        seen.append(per_call(profiled(fn, reps), reps))
        most = max(seen, key=lambda s: sum(s[0].values()))[0]
        whole = [t for mix, t in seen if mix == most and t >= floor_ms]
        if most and len(whole) >= 2:
            return sum(whole[:2]) / 2
    span = queued_span_ms(fn, reps)
    log(f"[time] profiler sessions (operations a call, ms a call) "
        f"{[(sum(m.values()), t) for m, t in seen]} never agreed; device "
        f"span by events instead: {span:.6f} ms a call")
    check(span >= floor_ms, f"device span {span} ms a call is below the "
                            f"work's bound {floor_ms} ms")
    return span


def host_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = SIMPLE_OPS_PER_S):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def launch_floor_fn():
    """A launch of ``csrc/dest_histogram2d.cu``'s empty kernel, through
    ctypes like the planner's kernels: the launch floor."""
    from repro_torch import kernels
    fn = kernels.load("dest_histogram2d").launch_floor
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        err = fn(torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"launch_floor: CUDA error {err}")
    return launch


def planner_timings(inp: dict) -> dict:
    """The planner's kernels at the write data plane's shape ((32, 8), 32
    nodes, the measured spec): device time (profiler), the queued span
    (CUDA events behind a sleep, launch gaps hidden), and the host's
    launch rate through the wrapper; beside them the plain versions (the
    parent's planner, moved), ``bincount`` for the counts-only entry, the
    bytes bound and the launch floor (an empty kernel, queued the same
    way)."""
    from repro_torch.kernels.chunk_router.chunk_router import (
        dest_budgets, dest_histogram2d, route_plan)
    from repro_torch.kernels.chunk_router.ref import (dest_budgets_ref,
                                                      dest_histogram2d_ref,
                                                      route_plan_ref)
    out = {}
    dest, valid, table = inp["dest"], inp["valid"], inp["table"]
    total = inp["spec"].total
    L, q = dest.shape
    n = N_NODES
    empty = launch_floor_fn()
    floor = dict(device=device_ms(empty, 50), queued=queued_span_ms(empty,
                                                                    200))
    log(f"[time] launch floor (an empty kernel): {floor['device']:.6f} ms "
        f"device, {floor['queued']:.6f} ms queued")

    def numbers(name, kernel, plain, nbytes, shape, library=None):
        b, by = bound_ms(nbytes, L * q)
        r = dict(ms=device_ms(kernel, 50, b), plain_ms=device_ms(plain, 50, b),
                 library_ms=None if library is None else device_ms(library,
                                                                   50, b),
                 bound_ms=b, bound_by=by, floor_ms=floor,
                 queued_ms=queued_span_ms(kernel, 200),
                 host_ms=cuda_ms(kernel, 200), shape=shape)
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.6f}"
        log(f"[time] {name} {shape}: kernel {r['ms']:.6f} ms device "
            f"({r['ms'] / floor['device']:.2f}x the floor's), "
            f"{r['queued_ms']:.6f} queued "
            f"({r['queued_ms'] / floor['queued']:.2f}x), {r['host_ms']:.6f} "
            f"back to back through the wrapper; plain {r['plain_ms']:.6f}; "
            f"library {lib}; bound {b:.7f} ({by})")
        out[name] = r

    # the whole plan of one ragged round: one launch against the parent's
    # ~35 operations (the plain version)
    numbers("route_plan",
            lambda: route_plan(dest, valid, table, total=total),
            lambda: route_plan_ref(dest, valid, table, total=total),
            L * q * 5 + table.numel() * 4 + L * (n + total + q + 1) * 4,
            f"({L}, {q}), N {n}, total {total}")
    numbers("dest_budgets", lambda: dest_budgets(dest, valid, n),
            lambda: dest_budgets_ref(dest, valid, n), L * q * 5 + n * 4,
            f"({L}, {q}) -> ({n},)")
    hist_in = inp["hist_in"]
    nb = n + 1
    flat = torch.where((hist_in >= 0) & (hist_in < nb),
                       hist_in + nb * torch.arange(L, device=DEVICE)[:, None],
                       L * nb).reshape(-1)
    numbers("dest_histogram2d", lambda: dest_histogram2d(hist_in, n_bins=nb),
            lambda: dest_histogram2d_ref(hist_in, n_bins=nb),
            L * q * 4 + L * nb * 4, f"({L}, {q}) -> ({L}, {nb})",
            lambda: torch.bincount(flat, minlength=L * nb + 1))
    return out


def profile_plan_rounds(inp: dict) -> None:
    """One ragged and one uniform routing round of the write data plane
    under the profiler (their spec tables already on the card): each must
    put exactly one operation on the card, ``route_plan``, and make no
    host-to-device copy and no stream synchronisation."""
    from repro_torch.core import exchange_plan as xp
    dest, valid, spec = inp["dest"], inp["valid"], inp["spec"]
    for label, fn in (
            ("ragged", lambda: xp._compact_plan_ragged(dest, valid, N_NODES,
                                                       spec)),
            ("uniform", lambda: xp._compact_plan(dest, valid, N_NODES, Q))):
        fn()                                   # the spec's table to the card
        stats = call_profile(fn)
        log(f"[profile] plan round ({label}): {stats['device_ops']} device "
            f"operations {stats['ops']}, {stats['htod']} host-to-device "
            f"copies, {stats['syncs']} stream syncs, {stats['launches']} "
            f"kernel launches")
        check(stats["htod"] == 0 and stats["syncs"] == 0,
              f"a {label} plan round copies to the card or waits for it")
        check(stats["device_ops"] == 1 and "route_plan" in
              " ".join(stats["ops"]), f"a {label} plan round is not one "
                                      f"route_plan launch: {stats['ops']}")


def phase_timings(seed: int, deploy: dict) -> dict:
    from repro_torch.core import burst_buffer as bb
    from repro_torch.kernels.chunk_pack.chunk_pack import pack_chunks
    from repro_torch.kernels.chunk_pack.ref import pack_chunks_ref
    inp = first_write_inputs(seed)
    out = planner_timings(inp)
    profile_plan_rounds(inp)
    fields, idx, recv_rows = inp["fields"], inp["idx"], inp["recv_rows"]
    del inp

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

    packs = {"pack_chunks": pack_numbers(fields, idx, "write send pack")}
    torch.cuda.empty_cache()
    packed = pack_chunks(fields, idx)
    packs["pack_chunks_recv"] = pack_numbers(packed, recv_rows,
                                             "ragged receive view")
    del packed
    torch.cuda.empty_cache()
    out.update(packs)
    for name, r in packs.items():
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
    out["client"] = dict(write_ms=t_w, read_ms=t_r, stat_ms=t_s,
                         read_stages=stages,
                         profiles=profile_client_calls(client, req))
    return out


def profile_client_calls(client, req) -> dict:
    """One write, read and stat of ``req`` under the profiler each."""
    return {name: profile_call(name, fn) for name, fn in (
        ("write", lambda: client.write(req)),
        ("read", lambda: client.read(req)),
        ("stat", lambda: client.stat(req)))}


def call_profile(fn, tries: int = 3) -> dict:
    """One call of ``fn`` under ``torch.profiler``, ended by a
    synchronize: wall ms, device busy ms (kernels, copies, memsets), the
    device operations by name, kernel launches (runtime and driver launch
    calls), host-to-device and device-to-host copies on the card, and the
    host's syncs (``cudaStreamSynchronize`` and blocking ``cudaMemcpy``
    calls: each blocking copy, ``.item()`` and ``.cpu()`` makes one; the
    closing device synchronize is not counted).  A session that recorded no device work is taken again,
    up to ``tries`` sessions in all (``fn`` runs once a session)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        if dev:
            break

    def count(pred, among=events):
        return sum(e.count for e in among if pred(e.key))

    return dict(
        wall_ms=wall, dev=dev,
        busy_ms=sum(e.self_device_time_total for e in dev) / 1e3,
        ops={e.key: e.count for e in dev},
        device_ops=sum(e.count for e in dev),
        launches=count(lambda k: "LaunchKernel" in k),
        htod=count(lambda k: "HtoD" in k, dev),
        dtoh=count(lambda k: "DtoH" in k, dev),
        syncs=count(lambda k: k in ("cudaStreamSynchronize", "cudaMemcpy")))


def profile_call(name: str, fn) -> dict:
    """One call under ``torch.profiler`` (``call_profile``): wall time,
    device busy time, idle share, launches, host syncs and copies, and the
    kernels that take the most device time.  The profiler's own host
    overhead inflates the wall time, so the idle share is an upper
    bound."""
    st = call_profile(fn)
    check(st["busy_ms"] > 0, f"profile of {name}: no device time recorded "
                             f"in three sessions")
    st["idle"] = max(0.0, 1 - st["busy_ms"] / st["wall_ms"])
    top = sorted(st.pop("dev"), key=lambda e: -e.self_device_time_total)[:5]
    log(f"[profile] {name}: wall {st['wall_ms']:.3f} ms, device busy "
        f"{st['busy_ms']:.3f} ms, idle share {st['idle']:.3f}, "
        f"{st['launches']} kernel launches, {st['device_ops']} device "
        f"operations, {st['syncs']} host syncs (stream syncs, blocking "
        f"copies), "
        f"{st['htod']} host-to-device and {st['dtoh']} device-to-host "
        f"copies")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    del st["ops"]
    return st


# ---------------------------------------------------------------------------
# (e2) online adaptation: telemetry, drift, re-decision, live relayout
# ---------------------------------------------------------------------------
def relayout_stream(relayout: bool, new_mode: int = 3):
    """``tests/test_adapt.py``'s pinned interleaved stream (N 8, q 6, 8
    words, ``/bb/hot`` NODE_LOCAL, default DIST_HASH) on the card, with a
    ``LiveMigrator`` advancing one 8-chunk installment after every read and
    stat when ``relayout``: returns (client, observables)."""
    from repro_torch.core.adapt import LiveMigrator
    from repro_torch.core.client import BBClient, BBRequest
    from repro_torch.core.policy import LayoutPolicy
    n, q, w = 8, 6, 8
    client = BBClient(LayoutPolicy.from_scopes({ADAPT_SCOPE: 1}, n_nodes=n,
                                               default=3),
                      device=DEVICE, cap=256, words=w, mcap=256,
                      telemetry=True)
    rng = np.random.RandomState(7)
    outs, reqs = [], []
    for _ in range(3):
        paths = [[f"{ADAPT_SCOPE}/r{i}/f{j % 2}" for j in range(q)]
                 for i in range(n)]
        shared = [[f"/shared/g{j}" for j in range(q)] for _ in range(n)]
        cid = rng.randint(0, 4, (n, q)).astype(np.int32)
        pay = rng.randint(0, 9999, (n, q, w)).astype(np.int32)
        wreq = client.encode(paths, chunk_id=cid, payload=pay)
        client.write(wreq)
        client.write(client.encode(shared, chunk_id=cid, payload=pay))
        reqs.append(wreq)
    mig = LiveMigrator(client, ADAPT_SCOPE, new_mode, step_chunks=8) \
        if relayout else None
    perm = torch.as_tensor(np.roll(np.arange(n), 3), device=DEVICE)
    for step in range(12):
        base = reqs[step % len(reqs)]
        outs += client.read(BBRequest(
            path_hash=base.path_hash[perm], chunk_id=base.chunk_id[perm],
            scope_hash=base.scope_hash[perm]))
        outs += client.stat(base)[:2]
        if mig is not None and not mig.done:
            mig.step()
            if mig.done:
                mig.finish()
    return client, outs


def adapt_payload(seed: int, k: int) -> torch.Tensor:
    """The payload every node writes into its file ``k`` of the drifting
    scope, (N_NODES, ADAPT_CHUNKS, WORDS) int32, made anew from the seed
    whenever a read is checked."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed * 1000 + k)
    return torch.randint(-2 ** 31, 2 ** 31 - 1,
                         (N_NODES, ADAPT_CHUNKS, WORDS), dtype=torch.int32,
                         device=DEVICE, generator=gen)


def adapt_paths(k: int, rows):
    """File ``k`` of each listed rank, ADAPT_CHUNKS requests a row."""
    return [[f"{ADAPT_SCOPE}/rank{r}/f{k}"] * ADAPT_CHUNKS for r in rows]


def span_parents(rec) -> dict:
    """Each span's enclosing span one level up (by depth and time)."""
    spans = list(rec.spans)
    out = {}
    for i, s in enumerate(spans):
        for p in spans:
            if p.depth == s.depth - 1 and p.ts_us <= s.ts_us and \
                    s.ts_us + s.dur_us <= p.ts_us + p.dur_us + 1e-3:
                out[i] = p
                break
    return out


class AdaptProbes:
    """Wraps, while active: the client's ``telemetry.record`` (each call
    must launch exactly one counts-only ``dest_histogram2d``),
    ``LiveMigrator.step`` (wall time and the launches of each installment,
    one of them under the profiler) and ``burst_buffer._clear_chunks``
    (each re-compaction two ``pack_chunks`` launches, data and keys)."""

    def __init__(self, client, kernels: dict, profile_installment: int):
        from repro_torch.core import burst_buffer as bb
        from repro_torch.core.adapt import migrate
        self.client, self.k = client, kernels
        self.records = self.clears = 0
        self.installments = []
        self.profile_at = profile_installment
        self.profile = None
        self._targets = [(bb, "_clear_chunks", self._clear),
                         (migrate.LiveMigrator, "step", self._step),
                         (client.telemetry, "record", self._record)]
        self._saved = []

    def _record(self, fn, *a, **kw):
        before = self.k["dest_histogram2d"].launches
        out = fn(*a, **kw)
        got = self.k["dest_histogram2d"].launches - before
        check(got == 1, f"a telemetry record made {got} dest_histogram2d "
                        f"launches, not one")
        self.records += 1
        return out

    def _clear(self, fn, *a, **kw):
        before = self.k["pack_chunks"].launches
        out = fn(*a, **kw)
        got = self.k["pack_chunks"].launches - before
        check(got == 2, f"a re-compaction made {got} pack_chunks launches, "
                        f"not two (data and key tables)")
        self.clears += 1
        return out

    def _step(self, fn, mig, *a, **kw):
        before = {name: c.launches for name, c in self.k.items()}
        clears = self.clears
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(self.installments) == self.profile_at:
            box = {}
            self.profile = call_profile(
                lambda: box.setdefault("n", fn(mig, *a, **kw)), tries=1)
            taken = box["n"]
        else:
            taken = fn(mig, *a, **kw)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        self.installments.append(dict(
            ms=wall, chunks=taken, clears=self.clears - clears,
            launches={n: c.launches - before[n]
                      for n, c in self.k.items()}))
        return taken

    def __enter__(self):
        for owner, name, wrap in self._targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn, owner.__dict__.get(name)))
            if isinstance(owner, type):
                def bound(mig, *a, _fn=fn, _wrap=wrap, **kw):
                    return _wrap(_fn, mig, *a, **kw)
                setattr(owner, name, bound)
            else:
                setattr(owner, name,
                        lambda *a, _fn=fn, _wrap=wrap, **kw:
                        _wrap(_fn, *a, **kw))
        return self

    def __exit__(self, *exc):
        for owner, name, fn, own in reversed(self._saved):
            if isinstance(owner, type) or own is not None:
                setattr(owner, name, fn if own is None else own)
            else:
                delattr(owner, name)


def drive_adapt(client, ctl, seed: int) -> dict:
    """The drifting scope's traffic and checks: every node writes its
    ADAPT_FILES files of ADAPT_CHUNKS chunks ((N, 8) calls), a controller
    tick (the write baseline), then ADAPT_READS ring-permuted cross-rank
    reads of those files (node r reads what node r-1 wrote), a tick after
    each; every read is held bit for bit against the written payload."""
    cids = np.tile(np.arange(ADAPT_CHUNKS, dtype=np.int32), (N_NODES, 1))
    t0 = time.perf_counter()
    for k in range(ADAPT_FILES):
        req = client.encode(adapt_paths(k, range(N_NODES)), chunk_id=cids)
        req.payload = adapt_payload(seed, k)
        client.write(req)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    check(int(client.state.dropped.sum()) == 0, "adapt writes were dropped")
    reports = [ctl.tick()]
    perm = np.roll(np.arange(N_NODES), 1)
    tick_ms = []
    for step in range(ADAPT_READS):
        k = step % ADAPT_FILES
        rreq = client.encode(adapt_paths(k, perm), chunk_id=cids[perm])
        out, found = client.read(rreq)
        check(bool(found.all()), f"adapt read {step} (epoch "
                                 f"{client.epoch}): chunks not found")
        want = adapt_payload(seed, k)[torch.as_tensor(perm, device=DEVICE)]
        check(torch.equal(out, want), f"adapt read {step} (epoch "
                                      f"{client.epoch}) differs from the "
                                      f"written payload")
        del out, want
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reports.append(ctl.tick())
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t1) * 1e3)
    return {"reports": reports, "tick_ms": tick_ms, "write_s": write_s}


def phase_adapt(seed: int, kernels: dict) -> dict:
    """(e2): the pinned relayout stream on the card, then a scope that
    drifts at the deployment's width, adapted by the controller; returns
    its launch counts and times.  ``kernels`` maps name → counter of the
    path's kernels; each must launch."""
    from repro_torch.core import obs
    from repro_torch.core.adapt import (AdaptConfig, AdaptationController,
                                        DriftConfig)
    from repro_torch.core.client import BBClient
    from repro_torch.core.policy import LayoutPolicy
    for new_mode in (3, 4):
        _, plain = relayout_stream(False)
        client, moved = relayout_stream(True, new_mode)
        got = (digest(*plain), digest(*moved))
        check(got == (STREAM_DIGEST, STREAM_DIGEST),
              f"relayout stream into mode {new_mode}: digests {got}, "
              f"pinned {STREAM_DIGEST}")
        check(client.epoch == 2 and client.fallback is None,
              "relayout stream: migration did not finish")
        log(f"[adapt] pinned relayout stream (N 8, q 6, W 8, /bb/hot "
            f"NODE_LOCAL -> mode {new_mode}): {got[0]} without and {got[1]} "
            f"with a LiveMigrator, pinned {STREAM_DIGEST}")
    del client, plain, moved
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    rec = obs.TraceRecorder(capacity=1 << 17)
    client = BBClient(LayoutPolicy.from_scopes({ADAPT_SCOPE: 1},
                                               n_nodes=N_NODES, default=3),
                      cap=CAP, words=WORDS, mcap=MCAP, telemetry=True,
                      trace=rec)
    ctl = AdaptationController(client, cfg=AdaptConfig(
        drift=DriftConfig(**ADAPT_DRIFT), horizon_rounds=ADAPT_HORIZON,
        step_chunks=ADAPT_STEP, installments_per_tick=ADAPT_PER_TICK))
    for c in kernels.values():
        c.launches = 0
    with PlannerCalls() as planner, \
            AdaptProbes(client, kernels, profile_installment=1) as probes:
        t0 = time.perf_counter()
        drove = drive_adapt(client, ctl, seed)
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        launches = {name: c.launches for name, c in kernels.items()}
    reports = drove["reports"]
    phases = [r.phase for r in reports]
    log(f"[adapt] {N_NODES} nodes x {ADAPT_FILES} files x {ADAPT_CHUNKS} "
        f"chunks of 1 MiB written in {drove['write_s']:.3f} s; "
        f"{ADAPT_READS} cross-rank reads, all bit for bit; tick phases "
        f"{phases}")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the adaptation path")
    check(phases.count("adopted") == 1,
          f"{phases.count('adopted')} adoptions, not exactly one: {phases}")
    check("completed" in phases[phases.index("adopted"):],
          f"the migration did not complete within the phase: {phases}")
    check(client.fallback is None, "the dual-epoch fallback is still armed")
    adopted = reports[phases.index("adopted")]
    new_mode = adopted.delta.new_mode
    hot = [m for s, m in client.policy.scopes if s == ADAPT_SCOPE]
    check(hot == [new_mode] and not any(s.startswith("/__epoch") for s, _ in
                                        client.policy.scopes),
          f"final policy {client.policy.scopes}, not one {ADAPT_SCOPE} "
          f"entry in mode {new_mode!r}")
    check(launches["route_plan"] == planner.rounds,
          f"{planner.rounds} routing rounds made {launches['route_plan']} "
          f"route_plan launches, not one each")
    check(launches["dest_budgets"] == planner.specs,
          f"{planner.specs} measured specs made "
          f"{launches['dest_budgets']} dest_budgets launches, not one each")
    inst = probes.installments
    check(inst and all(i["clears"] == 1 and i["launches"]["pack_chunks"] > 0
                       and i["launches"]["route_plan"] > 0 for i in inst),
          f"an installment ran no re-compaction, pack_chunks or route_plan: "
          f"{inst}")
    check(probes.records == launches["dest_histogram2d"],
          f"{probes.records} telemetry records, "
          f"{launches['dest_histogram2d']} dest_histogram2d launches")
    parents = span_parents(rec)
    spans = list(rec.spans)
    chain = ("adapt.tick", "migrate.installment", "client.migrate",
             "engine.migrate_rows")
    ok = 0
    for i, s in enumerate(spans):
        if s.name.startswith("exchange."):
            up, names = parents.get(i), []
            while up is not None:
                names.append(up.name)
                up = parents.get(spans.index(up))
            if [n for n in reversed(names) if n in chain] == list(chain):
                ok += 1
    check(ok > 0, "no exchange.* span under adapt.tick -> "
                  "migrate.installment -> client.migrate -> "
                  "engine.migrate_rows in the trace")
    gate = adopted.gate
    moved = rec.metrics.get("migrate_moved_total")
    mig_ticks = [t for r, t in zip(reports[1:], drove["tick_ms"])
                 if r.phase in ("adopted", "migrating", "completed")]
    log(f"[adapt] adopted at tick {adopted.tick}: {ADAPT_SCOPE} "
        f"{adopted.delta.old_mode.name} -> {new_mode.name} (gain "
        f"{adopted.delta.gain_s:.6f} s a round, horizon {ADAPT_HORIZON:g} "
        f"rounds, migration cost {gate['migration_cost_s']:.6f} s, "
        f"fabric measured {bool(gate['fabric_measured'])}); "
        f"{len(inst)} installments of <= {ADAPT_STEP} chunks, "
        f"{ADAPT_PER_TICK} a tick; final epoch {client.epoch}")
    log(f"[adapt] launches on the adaptation path: {launches}; "
        f"{probes.records} telemetry records, one dest_histogram2d each; "
        f"{planner.rounds} routing rounds, {planner.specs} measured specs; "
        f"{ok} exchange spans under adapt.tick -> migrate.installment -> "
        f"client.migrate -> engine.migrate_rows")
    log(f"[adapt] migration: {sum(mig_ticks):.3f} ms of ticks from adoption "
        f"to completion (host clock), {int(moved)} chunks moved "
        f"({moved * WORDS * 4 / 2 ** 30:.3f} GiB of payload); "
        f"installments {[round(i['ms'], 3) for i in inst]} ms")
    prof = probes.profile
    log(f"[adapt] one installment under the profiler: wall "
        f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, "
        f"{prof['launches']} launches, {prof['syncs']} host syncs, "
        f"{prof['htod']} host-to-device copies")
    for e in sorted(prof["dev"], key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[adapt]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    out = {"launches": launches, "phases": phases,
           "installment_ms": [i["ms"] for i in inst],
           "installment_profile": {k: v for k, v in prof.items()
                                   if k in ("wall_ms", "busy_ms", "launches",
                                            "syncs", "htod", "dtoh")},
           "migration_ms": sum(mig_ticks), "moved_chunks": moved,
           "drive_s": drive_s, "gate": dict(gate),
           "new_mode": int(new_mode)}
    out.update(adapt_path_timings(client, ctl, seed))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[adapt] peak device memory of the phase "
        f"{out['peak_gib']:.2f} GiB (data table "
        f"{client.state.data.numel() * 4 / 2 ** 30:.2f} GiB)")
    return out


def adapt_path_timings(client, ctl, seed: int) -> dict:
    """Times on the adapted tables: one telemetry record, a tick without
    adoption, and the re-compaction's gather against its bytes bound."""
    from repro_torch.core.layouts import route_data
    from repro_torch.kernels.chunk_pack.ops import gather_rows_batched
    from repro_torch.kernels.chunk_pack.ref import pack_chunks_ref
    out = {}
    cids = np.tile(np.arange(ADAPT_CHUNKS, dtype=np.int32), (N_NODES, 1))
    perm = np.roll(np.arange(N_NODES), 1)
    req = client.encode(adapt_paths(0, perm), chunk_id=cids[perm])
    mode, valid = client._modes(req), client._valid(req)
    dest = route_data(mode, N_NODES, req.path_hash, req.chunk_id,
                      client._client_ranks())
    hint = torch.zeros_like(valid)
    tel = client.telemetry

    def record():
        tel.record("read", req.scope_hash, req.path_hash, req.chunk_id,
                   dest, valid, words=WORDS, self_hint=hint,
                   n_nodes=N_NODES, capacity=2.0)

    rec_ms = device_ms(record, 20)
    rec_prof = call_profile(record)
    log(f"[time] one telemetry.record ({N_NODES}, {ADAPT_CHUNKS}): device "
        f"{rec_ms:.6f} ms, {rec_prof['launches']} launches, "
        f"{rec_prof['syncs']} host syncs, {rec_prof['htod']} host-to-device "
        f"copies, wall {rec_prof['wall_ms']:.3f} ms under the profiler")
    ticks = []
    for _ in range(3):
        client.read(req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = ctl.tick()
        torch.cuda.synchronize()
        ticks.append(((time.perf_counter() - t0) * 1e3, rep.phase))
    check(all(p not in ("adopted", "migrating") for _, p in ticks),
          f"a tick after the migration adopted again: {ticks}")
    log(f"[time] a tick without adoption (after one read): best "
        f"{min(t for t, _ in ticks):.3f} ms host clock, phases "
        f"{[p for _, p in ticks]}")
    # the re-compaction's gather on the adapted data table
    st = client.state
    keep = st.data_keys[..., 0] != -1
    cap = keep.shape[1]
    ar = torch.arange(cap, device=DEVICE)[None, :]
    order = torch.argsort(torch.where(keep, ar, cap), dim=1, stable=True)
    idx = torch.where(torch.gather(keep, 1, order), order, -1).to(
        torch.int32)
    rows = int(keep.sum())
    check(rows < keep.numel(), "the re-compaction check needs blank rows")
    nbytes = (rows + keep.numel()) * WORDS * 4 + idx.numel() * 4
    b, by = bound_ms(nbytes, 0)
    flat = st.data.reshape(-1, WORDS)
    base = torch.arange(N_NODES, dtype=torch.int32,
                        device=DEVICE)[:, None] * cap
    fidx = torch.where(idx >= 0, idx + base, -1).reshape(-1)
    got = gather_rows_batched(st.data, idx)
    ref = pack_chunks_ref(flat, fidx)
    check(torch.equal(got.reshape(-1, WORDS), ref),
          f"re-compaction gather ({N_NODES}, {cap}) rows of 1 MiB: "
          f"pack_chunks differs from its plain version")
    del got, ref
    check_clear_chunks(st)
    g_ms = device_ms(lambda: gather_rows_batched(st.data, idx), 3, b)
    p_ms = cuda_ms(lambda: pack_chunks_ref(flat, fidx), 2, warmup=1)
    log(f"[time] re-compaction gather ({N_NODES}, {cap}) rows of 1 MiB, "
        f"{rows} live: pack_chunks {g_ms:.4f} ms device, plain "
        f"{p_ms:.4f} ms, bound {b:.4f} ms ({by}, "
        f"{nbytes / 2 ** 30:.2f} GiB moved), {b / g_ms:.3f} of bound")
    out.update(record_ms=rec_ms, record_profile={
        k: rec_prof[k] for k in ("launches", "syncs", "htod", "wall_ms")},
        tick_ms=min(t for t, _ in ticks), gather=dict(
            ms=g_ms, plain_ms=p_ms, bound_ms=b, bound_by=by,
            gib=nbytes / 2 ** 30, rows=rows))
    return out


def check_clear_chunks(st) -> None:
    """``_clear_chunks`` at the deployment's shape, on a copy of the
    adapted state with every third slot's key cleared, against a plain
    version: each node keeps its other live rows in order, then blank
    rows (payload 0, key EMPTY), and its count is the kept rows."""
    import dataclasses
    from repro_torch.core import burst_buffer as bb
    keys = st.data_keys[:, ::3].contiguous()
    valid = keys[..., 0] != bb.EMPTY
    new = bb._clear_chunks(dataclasses.replace(st), keys, valid)
    host = st.data_keys.cpu().numpy()
    cleared = 0
    for n in range(N_NODES):
        gone = {tuple(k) for k in host[n, ::3] if k[0] != -1}
        keep = np.array([k[0] != -1 and k not in gone
                         for k in map(tuple, host[n])])
        live = int(keep.sum())
        cleared += int((host[n, :, 0] != -1).sum()) - live
        mask = torch.as_tensor(keep, device=DEVICE)
        check(int(new.data_count[n]) == live and
              torch.equal(new.data_keys[n, :live], st.data_keys[n][mask])
              and bool((new.data_keys[n, live:] == bb.EMPTY).all())
              and torch.equal(new.data[n, :live], st.data[n][mask])
              and not bool(new.data[n, live:].any()),
              f"_clear_chunks ({N_NODES}, {host.shape[1]}) rows of 1 MiB: "
              f"node {n} differs from the plain re-compaction")
    check(cleared > 0, "_clear_chunks check cleared no row")
    log(f"[adapt] _clear_chunks on the adapted ({N_NODES}, "
        f"{host.shape[1]}) tables of 1 MiB rows, {cleared} rows cleared: "
        f"data, keys and counts equal to the plain re-compaction")
    del new
    torch.cuda.empty_cache()


def phase_adapt_calls(seed: int) -> dict:
    """The deployment's write, read and stat (its policy, 32 x 8 requests
    of 1 MiB) on one client with telemetry and a recorder, each turned
    off and on in place: latency (host clock, best of 3, untraced and
    traced in turns), launches, host syncs and copies (profiler), against
    the same calls with both off."""
    from repro_torch.core import obs
    from repro_torch.core.client import BBClient
    rec = obs.TraceRecorder(capacity=1 << 16)
    client = BBClient(deployment_policy(), cap=CAP, words=WORDS, mcap=MCAP,
                      telemetry=True, trace=rec)
    tel = client.telemetry
    client.telemetry = client.obs = None
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    req = drive_deployment(client, gen)[-1][2]
    calls = (("write", lambda: client.write(req)),
             ("read", lambda: client.read(req)),
             ("stat", lambda: client.stat(req)))

    def setting(name):
        client.telemetry = tel if name == "telemetry" else None
        client.obs = rec if name == "traced" else None

    best = {}
    for _ in range(3):
        for name in ("plain", "traced"):
            setting(name)
            for call, fn in calls:
                key = (name, call)
                best[key] = min(best.get(key, float("inf")), host_ms(fn, 1))
    setting("telemetry")
    for call, fn in calls:
        best[("telemetry", call)] = host_ms(fn, 3)
    out = {}
    for name in ("plain", "traced", "telemetry"):
        setting(name)
        for call, fn in calls:
            st = call_profile(fn)
            out[f"{name}_{call}"] = dict(
                ms=best[(name, call)], launches=st["launches"],
                syncs=st["syncs"], htod=st["htod"], dtoh=st["dtoh"],
                busy_ms=st["busy_ms"])
    setting("plain")
    for name in ("traced", "telemetry"):
        for call, _ in calls:
            a, b = out[f"{name}_{call}"], out[f"plain_{call}"]
            a["ratio"] = a["ms"] / b["ms"]
            log(f"[time] {call} with {name} on: {a['ms']:.3f} ms against "
                f"{b['ms']:.3f} ms off ({a['ratio']:.4f}x); launches "
                f"{a['launches']} against {b['launches']}, host syncs "
                f"{a['syncs']} against {b['syncs']}, host-to-device copies "
                f"{a['htod']} against {b['htod']}")
    log(f"[time] plain calls (both off): " + ", ".join(
        f"{c} {out['plain_' + c]['launches']}/{out['plain_' + c]['syncs']}/"
        f"{out['plain_' + c]['htod']}" for c, _ in calls) +
        " launches/syncs/host-to-device copies")
    spans = {s.name for s in rec.spans}
    check({"client.write", "client.read.data", "client.meta",
           "engine.forward_write", "exchange.plan"} <= spans,
          f"the traced calls recorded spans {sorted(spans)}")
    return out


# ---------------------------------------------------------------------------
# (f) training gemma3-1b with Proteus checkpoints
# ---------------------------------------------------------------------------
def mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def phase_train(seed: int, counters, route_counter, checksum_counter,
                per_leaf_counter) -> dict:
    """``counters``: the checkpoint kernels' launch counts; each must be
    above 0 after the run, ``route_counter`` (the segmented routing) must
    read one launch per save and one per restore, ``checksum_counter``
    (the segmented checksum) one per save and between one and
    ``ceil(state / VERIFY_GROUP_BYTES)`` per restore, and
    ``per_leaf_counter`` (the per-leaf checksum) none."""
    from repro_torch.checkpoint.manager import (VERIFY_GROUP_BYTES,
                                                CheckpointManager)
    from repro_torch.configs import all_configs
    from repro_torch.models.registry import build_model
    from repro_torch.train.failure import FailurePlan
    from repro_torch.train.loop import LoopConfig, run_training
    cfg = all_configs()[TRAIN_ARCH]
    model = build_model(cfg)
    n_params = model.param_count()
    check(n_params == 999_812_736, f"{TRAIN_ARCH} has {n_params} params")
    log(f"[train] {TRAIN_ARCH}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {n_params:,} params ({cfg.param_dtype} "
        f"params, {cfg.dtype} compute); batch {TRAIN_BATCH} x {TRAIN_SEQ}; "
        f"window {cfg.window_size} < S: local layers take the windowed mask")
    log(f"[train] host MemAvailable {mem_available_gib():.1f} GiB before; "
        f"the store keeps every save (12.0 GB each)")
    loop_cfg = LoopConfig(steps=TRAIN_STEPS, ckpt_every=CKPT_EVERY,
                          layout_policy=deployment_policy())
    # count the manager's saves and restores (restores that fail their
    # checksum included) by wrapping its two methods for this run
    calls = {"save": 0, "restore": 0}
    real = {name: getattr(CheckpointManager, name) for name in calls}

    def counted(name):
        def method(self, *args, **kw):
            calls[name] += 1
            return real[name](self, *args, **kw)
        return method

    torch.cuda.reset_peak_memory_stats()
    for c in counters + (per_leaf_counter,):
        c.launches = 0
    t0 = time.perf_counter()
    try:
        for name in calls:
            setattr(CheckpointManager, name, counted(name))
        res = run_training(model, cfg, TRAIN_BATCH, TRAIN_SEQ, loop_cfg,
                           failure_plan=FailurePlan(dict(TRAIN_PLAN)),
                           seed=seed)
    finally:
        for name in calls:
            setattr(CheckpointManager, name, real[name])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.name: c.launches for c in counters}
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the training path")
    check(launches[route_counter.name] == calls["save"] + calls["restore"],
          f"{route_counter.name}: {launches[route_counter.name]} launches "
          f"for {calls['save']} saves and {calls['restore']} restores")
    # f32 params and two f32 moments: 12 bytes a param, in groups of at
    # least VERIFY_GROUP_BYTES but the last
    groups = 12 * n_params // VERIFY_GROUP_BYTES + 1
    n_sum = launches[checksum_counter.name]
    check(calls["save"] + calls["restore"] <= n_sum <=
          calls["save"] + groups * calls["restore"],
          f"{checksum_counter.name}: {n_sum} launches for {calls['save']} "
          f"saves and {calls['restore']} restores")
    check(per_leaf_counter.launches == 0,
          f"{per_leaf_counter.name} launched {per_leaf_counter.launches} "
          f"times on the training path")
    log(f"[train] {calls['save']} saves and {calls['restore']} restores "
        f"(one failing its checksum), {launches[route_counter.name]} "
        f"routing launches: one a save and one a restore; "
        f"{n_sum} {checksum_counter.name} launches: one a save, one per "
        f"group of leaves of at least {VERIFY_GROUP_BYTES} bytes a restore "
        f"(a per-leaf fletcher launch a leaf would make 1005); "
        f"{per_leaf_counter.name}: {per_leaf_counter.launches}")
    got = dataclasses.asdict(res.failure_log)
    log(f"[train] FailureLog {got}, final step {res.final_step}, "
        f"{len(res.losses)} steps kept, in {wall:.2f} s")
    check(got == TRAIN_EXPECTED["failure_log"],
          f"FailureLog {got} differs from the JAX loop's "
          f"{TRAIN_EXPECTED['failure_log']}")
    check(res.final_step == TRAIN_EXPECTED["final_step"],
          f"final step {res.final_step}")
    check(all(np.isfinite(res.losses)) and len(res.losses) > 0,
          f"losses not finite: {res.losses}")
    log(f"[train] losses {['%.4f' % x for x in res.losses]}")
    log(f"[train] launches on the training path: {launches}")
    log(f"[train] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; host "
        f"MemAvailable {mem_available_gib():.1f} GiB after")
    return {"result": res, "launches": launches, "cfg": cfg, "model": model,
            "wall_s": wall}


# ---------------------------------------------------------------------------
# (g) checkpoint and step times
# ---------------------------------------------------------------------------
def phase_checkpoint_times(train: dict) -> dict:
    from repro_torch.checkpoint.manager import (CHUNK_WORDS,
                                                CheckpointManager,
                                                flatten_state)
    from repro_torch.core.layouts import str_hash
    from repro_torch.kernels.chunk_router.chunk_router import \
        route_chunks_segmented
    from repro_torch.kernels.chunk_router.ops import leaf_table
    from repro_torch.kernels.chunk_router.ref import \
        route_chunks_segmented_ref
    from repro_torch.kernels.fletcher.fletcher import (FLETCHER_SEGMENTED,
                                                       fletcher_chunks,
                                                       fletcher_segmented)
    from repro_torch.kernels.fletcher.ops import as_words
    from repro_torch.kernels.fletcher.ref import (fletcher_chunks_ref,
                                                  fletcher_segmented_ref,
                                                  n_chunks_of)
    out = {}
    state = train["result"].state
    leaves = flatten_state(state)
    nbytes = sum(t.numel() * t.element_size() for _, t in leaves)
    n_chunks = sum(n_chunks_of(as_words(t).numel(), CHUNK_WORDS)
                   for _, t in leaves)
    log(f"[ckpt] final state: {len(leaves)} leaves, {nbytes / 1e9:.3f} GB, "
        f"{n_chunks} chunks of {CHUNK_WORDS * 4 // 1024} KiB")
    policy = deployment_policy()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, policy, async_save=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(TRAIN_STEPS, state)
        t_block = time.perf_counter() - t0
        mgr.wait()
        t_total = time.perf_counter() - t0
        FLETCHER_SEGMENTED.launches = 0
        t0 = time.perf_counter()
        restored, step = mgr.restore(TRAIN_STEPS, state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        restore_launches = FLETCHER_SEGMENTED.launches
        check(step == TRAIN_STEPS, f"restored step {step}")
        for (k, a), (_, b) in zip(flatten_state(restored), leaves):
            check(a.device == b.device and a.dtype == b.dtype and
                  a.shape == b.shape,
                  f"restored leaf {k} differs in kind")
            check(torch.equal(a.reshape(-1).view(torch.uint8),
                              b.reshape(-1).view(torch.uint8)),
                  f"restored leaf {k} differs from the saved one")
        del restored
        # a corrupt chunk in the middle leaf: the restore stops at most
        # one group of leaves past it
        bad_key = leaves[len(leaves) // 2][0]
        path = f"{mgr.scope}/{TRAIN_STEPS}/{bad_key}"
        node = next(n for n in mgr.store.nodes if (str_hash(path), 0) in n)
        good = node[(str_hash(path), 0)]
        node[(str_hash(path), 0)] = bytes([good[0] ^ 1]) + good[1:]
        FLETCHER_SEGMENTED.launches = 0
        failures = mgr.verify_failures
        t0 = time.perf_counter()
        try:
            mgr.restore(TRAIN_STEPS, state)
            rejected = None
        except IOError as e:
            rejected = str(e)
        torch.cuda.synchronize()
        t_reject = time.perf_counter() - t0
        check(rejected == f"checksum mismatch {bad_key}#0" and
              mgr.verify_failures == failures + 1,
              f"the corrupt restore gave {rejected!r}")
        reject_launches = FLETCHER_SEGMENTED.launches
        del mgr
    log(f"[ckpt] restore: {restore_launches} {FLETCHER_SEGMENTED.name} "
        f"launches (groups of whole leaves of at least 1 GiB); a corrupt "
        f"chunk in leaf {len(leaves) // 2} of {len(leaves)} ({bad_key}) was "
        f"rejected in {t_reject * 1e3:.1f} ms after {reject_launches} "
        f"launches: {rejected!r}")
    log(f"[ckpt] save of the full state: {t_block * 1e3:.1f} ms blocks the "
        f"loop (checksums and routing on the card, device-to-host copy), "
        f"{(t_total - t_block) * 1e3:.1f} ms more on the save thread "
        f"({nbytes / t_total / 1e9:.2f} GB/s end to end); restore "
        f"{t_restore * 1e3:.1f} ms ({nbytes / t_restore / 1e9:.2f} GB/s); "
        f"restored state equals the saved one bit for bit")
    out["save"] = dict(block_ms=t_block * 1e3,
                       async_ms=(t_total - t_block) * 1e3,
                       restore_ms=t_restore * 1e3, reject_ms=t_reject * 1e3,
                       restore_launches=restore_launches,
                       reject_launches=reject_launches, nbytes=nbytes,
                       n_chunks=n_chunks, n_leaves=len(leaves))

    # fletcher_segmented: every chunk of one save in one launch, bit for
    # bit against its plain version and the per-leaf kernel; its time (CUDA
    # events) beside a per-leaf launch for each leaf, in turns
    words = [as_words(t) for _, t in leaves]
    got = fletcher_segmented(words, CHUNK_WORDS)
    per_leaf = torch.cat([fletcher_chunks(w, CHUNK_WORDS) for w in words])
    torch.cuda.synchronize()
    want = fletcher_segmented_ref(words, CHUNK_WORDS)
    e_seg = max_abs_err(got, want)
    check(got.shape == (n_chunks, 2) and torch.equal(got, want) and
          torch.equal(got, per_leaf),
          "fletcher_segmented over one save differs")
    log(f"[ckpt] fletcher_segmented over one save ({len(words)} leaves, "
        f"{n_chunks} chunks): equal to its plain version and to the "
        f"{len(words)} per-leaf fletcher results (max_abs_err {e_seg})")
    del got, per_leaf, want
    seg, loop = [], []
    for _ in range(2):
        seg.append(cuda_ms(lambda: fletcher_segmented(words, CHUNK_WORDS),
                           10))
        loop.append(cuda_ms(lambda: [fletcher_chunks(w, CHUNK_WORDS)
                                     for w in words], 3))
    t_sp = cuda_ms(lambda: fletcher_segmented_ref(words, CHUNK_WORDS), 1,
                   warmup=1)
    b_save, by_save = bound_ms(sum(w.numel() * 4 for w in words) +
                               n_chunks * 8, 0)
    log(f"[time] fletcher per save, in turns: one fletcher_segmented "
        f"launch {seg[0]:.4f} / {seg[1]:.4f} ms, {len(words)} per-leaf "
        f"fletcher calls {loop[0]:.4f} / {loop[1]:.4f} ms (CUDA events); "
        f"bound {b_save:.4f} ms (bytes), {b_save / min(seg):.3f} of it")
    emb = as_words(dict(leaves)["[0]/['embed']/['embedding']"])
    nc = n_chunks_of(emb.numel(), CHUNK_WORDS)
    t_k = cuda_ms(lambda: fletcher_chunks(emb, CHUNK_WORDS), 10)
    t_ks = cuda_ms(lambda: fletcher_segmented([emb], CHUNK_WORDS), 10)
    b, _ = bound_ms(emb.numel() * 4 + nc * 8, 0)
    log(f"[time] fletcher on the embedding leaf ({emb.numel()} words, "
        f"{nc} chunks): per-leaf kernel {t_k:.4f} ms, segmented "
        f"{t_ks:.4f} ms, bound {b:.4f} ms")
    out["fletcher_segmented"] = dict(
        ms=min(seg), plain_ms=t_sp, library_ms=None, bound_ms=b_save,
        bound_by=by_save, per_leaf_ms=min(loop),
        embedding_ms=t_k, embedding_segmented_ms=t_ks, embedding_bound_ms=b,
        err=e_seg,
        shape=f"one save: {len(words)} leaves, {n_chunks} chunks, "
              f"{nbytes / 1e9:.3f} GB")
    del words, emb
    torch.cuda.empty_cache()

    # routing: one route_chunks_segmented launch over a whole save's leaf
    # table; device time of the launch, and the manager's host time per
    # save (leaf table, one copy to the card, the launch, the copy back)
    nodes = policy.n_nodes
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, policy, async_save=False)
        paths = [f"{mgr.scope}/{TRAIN_STEPS}/{key}" for key, _ in leaves]
        counts = [n_chunks_of(as_words(t).numel(), CHUNK_WORDS)
                  for _, t in leaves]
        route_host = host_ms(
            lambda: mgr.route(paths, counts, DEVICE)[0].cpu(), 5)
    table, offsets = leaf_table([str_hash(p) for p in paths],
                                [int(policy.mode_for_path(p)) for p in paths],
                                counts)
    lt = torch.as_tensor(table, device=DEVICE)
    n = int(offsets[-1])
    # a binary search over the leaves and the hash, ~16 integer ops a chunk
    b, by = bound_ms(lt.numel() * 4 + n * 4, n * 16)
    t_k = device_ms(lambda: route_chunks_segmented(lt, n, n_nodes=nodes), 50,
                    b)
    t_p = device_ms(lambda: route_chunks_segmented_ref(lt, n, n_nodes=nodes),
                    50, b)
    out["route_chunks_segmented"] = dict(
        ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b, bound_by=by,
        host_ms_per_save=route_host,
        shape=f"one save: {len(table)} leaves, {n} chunks, {nodes} nodes")
    for name in ("fletcher_segmented", "route_chunks_segmented"):
        r = out[name]
        log(f"[time] {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound")
    log(f"[time] routing per save through the manager (host clock, best of "
        f"5, {len(table)} leaves in one launch): {route_host:.3f} ms; the "
        f"save blocks the loop for {t_block * 1e3:.1f} ms")
    return out


def phase_step_times(seed: int, train: dict) -> dict:
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step
    cfg, model = train["cfg"], train["model"]
    params, opt_state, _ = train["result"].state
    step = make_train_step(model, AdamW(warmup_steps=5,
                                        total_steps=TRAIN_STEPS))
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in pipe.next_batch().items()}
    box = {}

    def one():
        box["out"] = step(params, opt_state, batch)
        box.pop("out")

    t_step = host_ms(one, 3)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[time] train step {t_step:.1f} ms (best of 3), "
        f"{tokens / t_step * 1e3:.0f} tokens/s, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}")
    profile_call("train step", one)
    return {"step_ms": t_step, "tokens_per_s": tokens / t_step * 1e3}


# ---------------------------------------------------------------------------
def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random payloads (default 0)")
    parser.add_argument("--calls-only", action="store_true",
                        help="only fill the deployment and profile one "
                             "write, read and stat (no result line)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if args.calls_only:
        phase_calls(args.seed)
        return 0
    from repro_torch import kernels
    from repro_torch.kernels.chunk_pack.chunk_pack import PACK_CHUNKS
    from repro_torch.kernels.chunk_router.chunk_router import (
        DEST_BUDGETS, DEST_HISTOGRAM, DEST_HISTOGRAM2D,
        ROUTE_CHUNKS_SEGMENTED, ROUTE_PLAN)
    from repro_torch.kernels.fletcher.fletcher import (FLETCHER,
                                                       FLETCHER_SEGMENTED)
    from repro_torch.kernels.flash_attention.flash_attention import (
        FLASH_ATTENTION, FLASH_ATTENTION_F32, FLASH_ATTENTION_WIDE)
    counters = (ROUTE_PLAN, DEST_BUDGETS, PACK_CHUNKS)
    ckpt_counters = (FLETCHER_SEGMENTED, ROUTE_CHUNKS_SEGMENTED)
    last_counters = (FLASH_ATTENTION, DEST_HISTOGRAM)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase = "build"
    try:
        phase_build(kernels)
        phase = "kernels vs plain"
        err = phase_kernels_vs_plain(args.seed)
        err.update(phase_checkpoint_kernels_vs_plain(args.seed))
        phase = "last kernels"
        last = phase_last_kernels(args.seed, last_counters,
                                  FLASH_ATTENTION_F32, FLASH_ATTENTION_WIDE)
        err.update(last["err"])
        torch.cuda.empty_cache()
        phase = "deployment"
        deploy = phase_deployment(args.seed, counters, ROUTE_PLAN,
                                  DEST_BUDGETS)
        phase = "seed digests"
        phase_seed_digests()
        phase = "timings"
        times = phase_timings(args.seed, deploy)
        times.update(last["times"])
        launches = dict(deploy["launches"])
        launches.update(last["launches"])
        del deploy
        torch.cuda.empty_cache()
        phase = "adapt"
        adapt = phase_adapt(args.seed, {
            c.name: c for c in (DEST_HISTOGRAM2D, PACK_CHUNKS, ROUTE_PLAN,
                                DEST_BUDGETS)})
        launches[DEST_HISTOGRAM2D.name] = \
            adapt["launches"][DEST_HISTOGRAM2D.name]
        torch.cuda.empty_cache()
        phase = "adapt calls"
        adapt["calls"] = phase_adapt_calls(args.seed)
        log(json.dumps({"adapt": adapt}))
        torch.cuda.empty_cache()
        phase = "train"
        train = phase_train(args.seed, ckpt_counters,
                            ROUTE_CHUNKS_SEGMENTED, FLETCHER_SEGMENTED,
                            FLETCHER)
        launches.update(train["launches"])
        phase = "checkpoint times"
        times.update(phase_checkpoint_times(train))
        err["fletcher_segmented"] = max(err["fletcher_segmented"],
                                        times["fletcher_segmented"]["err"])
        phase = "step times"
        times["step"] = phase_step_times(args.seed, train)
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
            (ROUTE_PLAN, "src/repro_torch/csrc/dest_histogram2d.cu",
             "src/repro/kernels/chunk_router/chunk_router.py:133"),
            (DEST_BUDGETS, "src/repro_torch/csrc/dest_histogram2d.cu",
             "src/repro/kernels/chunk_router/chunk_router.py:133"),
            (DEST_HISTOGRAM2D, "src/repro_torch/csrc/dest_histogram2d.cu",
             "src/repro/kernels/chunk_router/chunk_router.py:133"),
            (PACK_CHUNKS, "src/repro_torch/csrc/pack_chunks.cu",
             "src/repro/kernels/chunk_pack/chunk_pack.py:42"),
            (FLETCHER_SEGMENTED, "src/repro_torch/csrc/fletcher.cu",
             "src/repro/kernels/fletcher/fletcher.py:39"),
            (ROUTE_CHUNKS_SEGMENTED, "src/repro_torch/csrc/route_chunks.cu",
             "src/repro/kernels/chunk_router/chunk_router.py:68"),
            (DEST_HISTOGRAM, "src/repro_torch/csrc/dest_histogram.cu",
             "src/repro/kernels/chunk_router/chunk_router.py:107"),
            (FLASH_ATTENTION, "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:72"),
            (FLASH_ATTENTION_F32,
             "src/repro_torch/csrc/flash_attention_f32.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:72"),
            (FLASH_ATTENTION_WIDE,
             "src/repro_torch/csrc/flash_attention_wide.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:72")):
        t = times[c.name]
        if not t["ms"] >= t["bound_ms"]:
            print(f"chip_smoke: {c.name} read {t['ms']} ms, below its bound "
                  f"{t['bound_ms']} ms: a partial reading", file=sys.stderr)
            return 1
        rows.append({"name": c.name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": launches[c.name],
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
