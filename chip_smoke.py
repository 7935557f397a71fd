#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one card: the burst-buffer data
plane, then fault-tolerant training of gemma3-1b with Proteus checkpoints.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, each of which must succeed or the run fails without a result line:

  (a) build the seven hand-written kernel libraries from
      ``src/repro_torch/csrc`` with nvcc for sm_90a, all sources compiled
      in parallel, and check that the bf16 attention library's SASS holds
      wgmma (``HGMMA``) and TMA loads (``UTMALDG``), and the float32 one's
      tensor-core products with a TF32 type (``HMMA ... TF32``);
  (b) each kernel of the data plane and the checkpoint path against its
      plain PyTorch version on the card, bit for bit, at the shapes its
      main path gives it and at sentinel and edge shapes (``fletcher`` up
      to the full embedding leaf, 302 M words in 4608 chunks;
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
      through the float32 kernel (2e-3); the histogram's sweep, sentinels
      and 20000 bins; kernel, plain, library (SDPA, timed in turns with
      the kernel, ``bincount``) and bound times (float32: 3xTF32 at the
      TF32 peak, and the float32 SIMT peak beside it);
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
      one write, read and stat (device busy time, idle share, top kernels);
  (f) training: ``run_training`` with gemma3-1b at full width (26 layers,
      d 1152, vocab 262144, 999,812,736 params, bf16 compute, f32 params),
      batch 4 × 1024 tokens, checkpoints every 2 steps through the
      deployment policy (/bb/ckpt → HYBRID, 32 nodes) under a failure plan
      with a straggler redo, a corrupted checkpoint rejected by the card's
      checksum with a fallback, and a crash restored from a checkpoint
      verified on the card; the FailureLog and final step must equal what
      the JAX loop gives under the same plan (pinned below), both
      checkpoint kernels' launch counts (zeroed just before) above 0, and
      the routing's exactly one a save and one a restore;
  (g) checkpoint and step times: a save (blocking part and async part) and
      a restore of the full final state (12 GB), checked bit for bit; the
      kernels' times per save against their bounds, and the routing's host
      time per save; the train step's time, tokens/s and a profile of one
      step.

Before the last line it prints the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and one JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
no CUDA card is present or any phase fails.
"""
from __future__ import annotations

import argparse
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


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    reports = kernels.build(kernels.KERNELS)
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
    tf32 = sass_count(kernels, "flash_attention_f32", "HMMA", "TF32")
    log(f"[build] flash_attention_f32 SASS: {tf32} HMMA lines with a TF32 "
        f"type (3xTF32 on the tensor cores)")
    check(tf32 > 0, "flash_attention_f32's SASS holds no TF32 HMMA")


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
    from repro_torch.kernels.fletcher.fletcher import fletcher_chunks
    from repro_torch.kernels.fletcher.ops import as_words
    from repro_torch.kernels.fletcher.ref import fletcher_chunks_ref
    err = {"fletcher": 0.0, "route_chunks": 0.0,
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


def phase_last_kernels(seed: int, counters, f32_counter) -> dict:
    """This slice's path: ``flash_attention`` and ``histogram_rows`` at the
    shapes the port's paths give them, then checks and times.
    ``counters`` are the bf16 attention and histogram kernels' (the main
    path), ``f32_counter`` the float32 attention kernel's (the float32
    calls at the same shape)."""
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
    log("[last] dest_histogram sweep n 0/8/100/1024/4097 x bins 4/33, "
        "4096 -> 64, 100000 -> 20000, all sentinel: equal")

    # times (card and power limit printed at the end): kernel and SDPA in
    # turns, best of each, as device time (the profiler's sum of kernel
    # times: back to back, the wrapper's host work, not the card, would
    # set the pace of a 0.03 ms kernel; that rate is logged apart)
    def turns(kernel, library, reps):
        ks, ls = [], []
        for _ in range(2):
            ks.append(device_ms(kernel, reps))
            ls.append(device_ms(library, reps))
        return min(ks), min(ls), ks, ls

    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    nbytes = 4 * q.numel() * q.element_size()
    for causal in (True, False):
        t_k, t_l, ks, ls = turns(
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal), 50)
        t_p = cuda_ms(lambda: flash_attention_ref(q, k, v, scale=scale,
                                                  causal=causal), 5)
        b, by = bound_ms(nbytes, attention_flops(B, S, H, D, causal),
                         BF16_TENSOR_OPS_PER_S)
        mode = "causal" if causal else "full"
        log(f"[time] flash_attention bf16 {mode} {(B, S, H, D)}, device "
            f"time in turns: kernel {ks[0]:.5f}, SDPA {ls[0]:.5f}, kernel "
            f"{ks[1]:.5f}, SDPA {ls[1]:.5f} ms")
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
        t32, t32l, ks, ls = turns(
            lambda: flash_attention(*f32, causal=causal),
            lambda: F.scaled_dot_product_attention(*f32t, is_causal=causal),
            20)
        t32p = cuda_ms(lambda: flash_attention_ref(*f32, scale=scale,
                                                   causal=causal), 5)
        flops = attention_flops(B, S, H, D, causal)
        b32, by32 = bound_ms(4 * f32[0].numel() * 4, 3 * flops,
                             TF32_TENSOR_OPS_PER_S)
        simt, _ = bound_ms(4 * f32[0].numel() * 4, flops)
        log(f"[time] flash_attention float32 {mode} {(B, S, H, D)}, device "
            f"time in turns: kernel {ks[0]:.5f}, SDPA {ls[0]:.5f}, kernel "
            f"{ks[1]:.5f}, SDPA {ls[1]:.5f} ms; bound {b32:.5f} ms (3xTF32 "
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

    nb = N_NODES
    t_k = device_ms(lambda: histogram_rows(dest, n_bins=nb), 50)
    t_p = device_ms(lambda: dest_histogram_ref(dest, n_bins=nb), 50)
    t_l = device_ms(lambda: torch.bincount(dest, minlength=nb), 50)
    log(f"[time] dest_histogram back to back through the entry point: "
        f"{cuda_ms(lambda: histogram_rows(dest, n_bins=nb), 200):.4f} ms a "
        f"call (host launch rate); microbench 4096 -> 64: "
        f"{device_ms(lambda: histogram_rows(micro, n_bins=64), 50):.5f} ms "
        f"device")
    b, by = bound_ms(dest.numel() * 4 + nb * 4, dest.numel())
    times["dest_histogram"] = dict(
        ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b, bound_by=by,
        shape=f"{dest.numel()} save destinations -> {nb} bins, device time; "
              f"library: bincount on this sentinel-free input")
    for name in ("flash_attention", "flash_attention full", f32_counter.name,
                 f"{f32_counter.name} full", "dest_histogram"):
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
    log(f"[deploy] launches on the data-plane path: {launches}")
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


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = SIMPLE_OPS_PER_S):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
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
# (f) training gemma3-1b with Proteus checkpoints
# ---------------------------------------------------------------------------
def mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def phase_train(seed: int, counters, route_counter) -> dict:
    """``counters``: the checkpoint kernels' launch counts; each must be
    above 0 after the run, and ``route_counter`` (the segmented routing)
    must read one launch per save and one per restore."""
    from repro_torch.checkpoint.manager import CheckpointManager
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
    for c in counters:
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
    log(f"[train] {calls['save']} saves and {calls['restore']} restores "
        f"(one failing its checksum), {launches[route_counter.name]} "
        f"routing launches: one a save and one a restore")
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
    from repro_torch.kernels.fletcher.fletcher import fletcher_chunks
    from repro_torch.kernels.fletcher.ops import as_words
    from repro_torch.kernels.fletcher.ref import (fletcher_chunks_ref,
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
        t0 = time.perf_counter()
        restored, step = mgr.restore(TRAIN_STEPS, state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        check(step == TRAIN_STEPS, f"restored step {step}")
        for (k, a), (_, b) in zip(flatten_state(restored), leaves):
            check(a.device == b.device and a.dtype == b.dtype and
                  a.shape == b.shape,
                  f"restored leaf {k} differs in kind")
            check(torch.equal(a.reshape(-1).view(torch.uint8),
                              b.reshape(-1).view(torch.uint8)),
                  f"restored leaf {k} differs from the saved one")
        del restored, mgr
    log(f"[ckpt] save of the full state: {t_block * 1e3:.1f} ms blocks the "
        f"loop (checksums and routing on the card, device-to-host copy), "
        f"{(t_total - t_block) * 1e3:.1f} ms more on the save thread "
        f"({nbytes / t_total / 1e9:.2f} GB/s end to end); restore "
        f"{t_restore * 1e3:.1f} ms ({nbytes / t_restore / 1e9:.2f} GB/s); "
        f"restored state equals the saved one bit for bit")
    out["save"] = dict(block_ms=t_block * 1e3,
                       async_ms=(t_total - t_block) * 1e3,
                       restore_ms=t_restore * 1e3, nbytes=nbytes,
                       n_chunks=n_chunks, n_leaves=len(leaves))

    # fletcher: every leaf of one save, one launch each (CUDA events)
    words = [as_words(t) for _, t in leaves]
    per_save = cuda_ms(lambda: [fletcher_chunks(w, CHUNK_WORDS)
                                for w in words], 3)
    b_save, _ = bound_ms(sum(w.numel() * 4 for w in words) + n_chunks * 8,
                         0)
    log(f"[time] fletcher per save: {per_save:.3f} ms for {len(words)} "
        f"launches over {nbytes / 1e9:.3f} GB, bound {b_save:.3f} ms "
        f"(bytes), {b_save / per_save:.3f} of bound")
    emb = as_words(dict(leaves)["[0]/['embed']/['embedding']"])
    nc = n_chunks_of(emb.numel(), CHUNK_WORDS)
    t_k = cuda_ms(lambda: fletcher_chunks(emb, CHUNK_WORDS), 10)
    t_p = cuda_ms(lambda: fletcher_chunks_ref(emb, CHUNK_WORDS), 2,
                  warmup=1)
    b, by = bound_ms(emb.numel() * 4 + nc * 8, emb.numel() * 8)
    out["fletcher"] = dict(ms=t_k, plain_ms=t_p, library_ms=None,
                           bound_ms=b, bound_by=by, per_save_ms=per_save,
                           per_save_bound_ms=b_save,
                           shape=f"embedding leaf: {emb.numel()} words, "
                                 f"{nc} chunks")
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
    t_k = device_ms(lambda: route_chunks_segmented(lt, n, n_nodes=nodes), 50)
    t_p = device_ms(lambda: route_chunks_segmented_ref(lt, n, n_nodes=nodes),
                    50)
    # a binary search over the leaves and the hash, ~16 integer ops a chunk
    b, by = bound_ms(lt.numel() * 4 + n * 4, n * 16)
    out["route_chunks_segmented"] = dict(
        ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b, bound_by=by,
        host_ms_per_save=route_host,
        shape=f"one save: {len(table)} leaves, {n} chunks, {nodes} nodes")
    for name in ("fletcher", "route_chunks_segmented"):
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import kernels
    from repro_torch.kernels.chunk_pack.chunk_pack import PACK_CHUNKS
    from repro_torch.kernels.chunk_router.chunk_router import (
        DEST_HISTOGRAM, DEST_HISTOGRAM2D, ROUTE_CHUNKS_SEGMENTED)
    from repro_torch.kernels.fletcher.fletcher import FLETCHER
    from repro_torch.kernels.flash_attention.flash_attention import (
        FLASH_ATTENTION, FLASH_ATTENTION_F32)
    counters = (DEST_HISTOGRAM2D, PACK_CHUNKS)
    ckpt_counters = (FLETCHER, ROUTE_CHUNKS_SEGMENTED)
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
                                  FLASH_ATTENTION_F32)
        err.update(last["err"])
        torch.cuda.empty_cache()
        phase = "deployment"
        deploy = phase_deployment(args.seed, counters)
        phase = "seed digests"
        phase_seed_digests()
        phase = "timings"
        times = phase_timings(args.seed, deploy)
        times.update(last["times"])
        launches = dict(deploy["launches"])
        launches.update(last["launches"])
        del deploy
        torch.cuda.empty_cache()
        phase = "train"
        train = phase_train(args.seed, ckpt_counters,
                            ROUTE_CHUNKS_SEGMENTED)
        launches.update(train["launches"])
        phase = "checkpoint times"
        times.update(phase_checkpoint_times(train))
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
            (DEST_HISTOGRAM2D, "src/repro_torch/csrc/dest_histogram2d.cu",
             "src/repro/kernels/chunk_router/chunk_router.py:133"),
            (PACK_CHUNKS, "src/repro_torch/csrc/pack_chunks.cu",
             "src/repro/kernels/chunk_pack/chunk_pack.py:42"),
            (FLETCHER, "src/repro_torch/csrc/fletcher.cu",
             "src/repro/kernels/fletcher/fletcher.py:39"),
            (ROUTE_CHUNKS_SEGMENTED, "src/repro_torch/csrc/route_chunks.cu",
             "src/repro/kernels/chunk_router/chunk_router.py:68"),
            (DEST_HISTOGRAM, "src/repro_torch/csrc/dest_histogram.cu",
             "src/repro/kernels/chunk_router/chunk_router.py:107"),
            (FLASH_ATTENTION, "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:72"),
            (FLASH_ATTENTION_F32,
             "src/repro_torch/csrc/flash_attention_f32.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:72")):
        t = times[c.name]
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
