#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one card: the burst-buffer data
plane, fault-tolerant training of gemma3-1b with Proteus checkpoints,
serving the dense configs, the MoE and VLM families, then the recurrent,
hybrid and audio families.

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
  (h) the decision pipeline (``core/intent``, ``core/workloads.py``,
      ``launch/train.py``): ``select_layout`` over ``build_workloads(32)``
      under the four settings of ``tests/test_intent.py`` (accuracy 21,
      20, 19 and 15 of 23) with the 23 whole-job modes and confidences
      pinned to the JAX package's (``DECISIONS``), the adversarial corpus
      (6 of 6) and the heterogeneous plan (``/bb/ckpt`` NODE_LOCAL,
      ``/bb/shared`` HYBRID, default HYBRID), with the host ms of one
      decision and of the matrix; the probe's engine replay of every
      workload on the card (counters as the shim's, ``route_plan``
      launched, every write and read — its outputs and the node tables
      after it — equal to the same replay on the CPU, bit for bit); then every decided layout executed at the deployment's
      width, one 8 GiB table at a time: the heterogeneous plan (a 4 MiB
      checkpoint and 4 one-chunk shared files a node in one fused write,
      creates and stats, reads of the node's own checkpoint and of its
      ring neighbour's shared files) and a uniform policy of each
      whole-job mode decided (phase c's batch: a write, a ring-permuted
      cross-node read, a stat), every read bit for bit, stat sizes as the
      layout keeps them, ``route_plan``, ``dest_budgets`` and
      ``pack_chunks`` (zeroed just before) launched, one ``route_plan`` a
      round and one ``dest_budgets`` a spec, and each call's latency,
      launches, syncs and copies; phase e2's adopted ``/bb/hot``
      signature through ``signature_workload`` and the selector; and the
      launcher, ``repro_torch.launch.train.main`` with ``--full``
      gemma3-1b (its own batch of 8 x 128 tokens, a save every 2 steps,
      as many saves as host RAM holds, up to 2): it prints the decision
      Mode 1, trains to its last step with finite losses, and makes one
      ``fletcher_segmented`` and one ``route_chunks_segmented`` launch a
      save (zeroed just before); its wall time beside one
      ``select_layout`` of the launcher's workload;
  (i) the examples and the mesh backend (earlier clients freed first):
      both examples' ``main()`` with their tables on the card (the demo's
      ``21/23 = 91.30%``, its per-scope plan faster than every uniform
      mode, both mixed batches read back bit for bit); the mesh plans at
      the deployment's width through the stacked engine — the measured
      padded ``MeshRaggedSpec``s, the same forced to ``ppermute``
      pipelined and not — a write, the two-phase read and a stat of phase
      c's batch each, tables, replies and stat triples equal to the
      compacted stacked client's bit for bit, ``dest_histogram2d``
      (counts only: the mesh specs) and ``pack_chunks`` launched (zeroed
      just before), each call's latency and profile, the padded buffer's
      bytes beside the stacked ragged Σbᵢ, peak memory; then
      ``BBClient(policy, make_node_mesh())``, NCCL at world size 1
      (a gloo group fails the phase), through ``counted_drive`` with
      phase c's calls and checks, its tables equal to a stacked client's
      after the same calls, its latency beside the stacked client's, the
      NCCL kernels' device time and the ``all_to_all`` bytes of a call;
      the dry-run's BB cell (``run_bb_cell``) on that mesh, its record in
      a temporary directory; and at world size 1 the shift is the
      identity, ``mesh_global_sum`` the sum, ``build_telemetry_reduce``
      of a telemetry client's counters its ``snapshot()``.  Phase b holds
      the mesh plans' kernel calls on the first write (the ppermute
      rounds' ``route_plan``, a shift round's pack, the receive
      permutation's gather) against their plain versions;
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
      profile of one step;
  (j) serving (the training state freed first), under the reference's
      serving dtypes (``serving_config``: bf16 params, bf16 activations):
      gemma3-1b at full width, 16 prompt + 32 greedy tokens at B 4 through
      ``make_serve_step`` (step time, tokens/s, launches, syncs, device
      busy time and idle share of one step), then teacher forcing over
      those 48 tokens (all below the 512 window): the logits of the full
      forward (``make_prefill_step``'s) against 48 decode steps, reported
      at the model's own init and checked at the per-layer fan-in
      (``condition``): with float32 activations within ``TF_TOL32`` of the
      largest logit, in bf16 the decode within ``BF16_RATIO`` times the
      prefill's distance of the float32 logits, greedy tokens equal on
      decided rows; the blocked prefill forms against
      ``masked_attention`` at S 2048; decode_32k (cache 32,768, B 128 cut
      to 32) and long_500k (cache 524,288, B 1): a cache filled from the
      seed, one serve step's time, profile and bytes bound, and
      ``decode_attention`` of a global and a local layer against float64;
      prefill_32k (B 32 cut to 4): finite last logits, time beside the
      operations bound; gemma-7b and minitron-8b at full width (one after
      the other): teacher forcing over 1 x 64 tokens and 8 decode steps at
      B 8 against the weights' bytes bound; then
      ``repro_torch.launch.serve.main`` and the ``serve_lm`` example on
      the card; no kernel of the port launches on this path (the
      reference's serve path reaches no Pallas kernel either); the peak
      device memory of each part, and one ``{"serve": ...}`` JSON line;
  (k) the MoE and VLM families (phase j's state freed, each model freed
      before the next), in bf16 as phase j: deepseek-v2-lite-16b (MLA, 64
      experts top-6 + 2 shared), moonshot-v1-16b-a3b and qwen2-vl-2b
      (M-RoPE) at full width, their parameter trees' sizes checked; each
      16 prompt + 32 greedy tokens at B 4 through ``make_serve_step``
      (the default ``dropping`` dispatch) beside a bytes bound that reads
      only the experts the step routes to; at the reference init
      (reported) the decode steps reproduce the greedy tokens and the
      ``dropping`` prefill's dropped copies are counted; at the per-layer
      fan-in (``condition``) teacher forcing with the ``dense`` dispatch
      on both sides under phase j's gates over every position (the
      tokens whose routing flips between the runs counted by
      ``RouterProbe`` and reported; the greedy-token check holds only on
      the decided rows, whose count is reported); deepseek's
      decode_32k with the MLA latent cache (B 128 cut to 32) beside its
      bytes bound and MLA layer 1's absorbed decode against float64
      (``o_lat`` and the layer output within 2e-2), its prefill at S 4096
      (its dropped copies counted); qwen2-vl's prefill_32k (B 32 cut to 4)
      with 1024 patch embeddings and their M-RoPE positions; no kernel of
      the port launches on those paths; then ``launch/train.py --full
      --arch qwen2-vl-2b`` (one checksum and one routing launch a save)
      and deepseek at full width cut to two layers (dense, moe): three
      train steps with finite loss and aux loss, one save and one restore
      through ``CheckpointManager`` (one routing and one checksum launch a
      save, one routing launch and a checksum launch a group of leaves a
      restore), the restore equal to the saved state bit for bit; every
      checkpoint kernel launch of the launcher's save and of deepseek's
      save and restore held against its plain version on the same
      inputs, bit for bit; the peak device memory of each part, and one
      ``{"families": ...}`` JSON line;
  (l) the recurrent, hybrid and audio families (phase k's state freed,
      one model at a time), in bf16 as phase j, at full width and depth,
      their parameter trees' sizes checked: xlstm-125m (mLSTM and sLSTM
      blocks), hymba-1.5b (attention and Mamba heads, 128 meta tokens) and
      whisper-base (encoder-decoder; 1500 seeded frames encoded at B 4 and
      the cross cache filled from them with ``_xattn_kv``, which the
      reference's serve path never does); each 16 prompt + 32 greedy
      tokens at B 4 through ``make_serve_step`` (step time, tokens/s,
      launches, syncs, busy time, idle share, beside a bytes bound of the
      weights and the states read and written); teacher forcing under phase
      j's gates for xLSTM and whisper (the count of decided rows reported;
      with none the token check only reports); Hymba's decode, which
      cannot reproduce ``forward`` (its meta tokens are never fed) but
      computes ``forward`` with the meta tokens zeroed, at the per-layer
      fan-in teacher-forced against that forward under phase j's gates and
      held to the same steps in float64 on the card (float32 within
      ``TF_TOL32`` of the largest logit, bf16 within ``BF16_RATIO`` times
      the zero-meta bf16 forward's distance from its float64 run), the
      reference init and the decode-vs-forward difference reported;
      xLSTM's decode at B 128 (decode_32k's batch, 3.0 GB of state from
      the seed) and prefill at S 4096, B 4; Hymba's long_500k (cache
      524,288 + 128 at B 1, 21.5 GB from the seed) with a window layer's
      ``decode_attention`` and ``_mamba_path``'s step against float64, and
      prefill at S 4096 (+ 128), B 4; whisper's prefill_32k at B 4; no
      kernel of the port launches on those paths; then ``launch/train.py
      --full --arch xlstm-125m`` (one save), the ``examples/train_lm``
      twin at 40 steps (its FailureLog and final step those of the JAX
      example's loop, ``TRAIN_LM_EXPECTED``) and hymba-1.5b at full width
      cut to 4 layers (three train steps at 4 × 1024, a save and a restore
      bit for bit); every checkpoint kernel launch of these held against
      its plain version on its own inputs, bit for bit; the peak device
      memory of each part, and one ``{"recurrent": ...}`` JSON line.

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
import gc
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

# (h) the decision pipeline: the JAX package's whole-job decisions over
# build_workloads(32) (mode, confidence), its accuracies against the
# oracle under tests/test_intent.py's four settings, and its per-scope
# plan of heterogeneous_workload(32) (scope modes, default), pinned here
# as phase f pins the FailureLog
# (tests/test_torch_intent.py::test_chip_smoke_decision_matrix_pinned_to_reference)
DECISIONS = {
    "IOR-A": (1, 0.95), "IOR-B": (2, 0.85), "IOR-C": (4, 0.72),
    "IOR-D": (4, 0.9), "FIO-A": (1, 0.95), "FIO-C": (4, 0.78),
    "FIO-D": (4, 0.84), "FIO-E10": (4, 0.84), "FIO-E50": (3, 0.55),
    "FIO-E90": (3, 0.85), "HACC-A": (4, 0.82), "HACC-B": (2, 0.85),
    "HACC-C": (2, 0.92), "MAD-A": (4, 0.82), "MAD-B": (1, 0.95),
    "MAD-C": (4, 0.72), "MDTEST-A": (4, 0.86), "MDTEST-B": (2, 0.92),
    "MDTEST-C": (2, 0.92), "MDTEST-D": (4, 0.86), "S3D-A": (4, 0.9),
    "S3D-B": (2, 0.85), "S3D-C": (2, 0.74),
}
DECIDE_SETTINGS = {"full": {}, "wo-runtime": {"use_runtime": False},
                   "wo-appref": {"use_app_ref": False},
                   "wo-modeknow": {"use_mode_know": False}}
ACCURACY = {"full": (21, 23), "wo-runtime": (20, 23),
            "wo-appref": (19, 23), "wo-modeknow": (15, 23)}
HETERO_PLAN = ({"/bb/ckpt": 1, "/bb/shared": 4}, 4)
HETERO_CKPT, HETERO_SHARED = 4, 4      # per node: chunks, one-chunk files
# the launcher: gemma3-1b at full width under its own batch defaults (8 x
# 128 tokens), a save every LAUNCH_CKPT_EVERY steps, as many saves (up to
# LAUNCH_SAVES) as host RAM holds beside LAUNCH_RESERVE_GIB
LAUNCH_ARGS = ["--full", "--arch", TRAIN_ARCH]
LAUNCH_CKPT_EVERY, LAUNCH_SAVES, LAUNCH_RESERVE_GIB = 2, 2, 24.0

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


def expected_sizes() -> np.ndarray:
    """Stat sizes of ``batch_paths``' files, in chunks."""
    size = np.empty((N_NODES, Q), np.int32)
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
    del packed
    mesh_plan_vs_plain(inp, err, pack_case)
    del inp
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
                             ((32, 32, 8), torch.int32),   # probe replay
                             ((32, 32, 11), torch.int32),
                             ((8 * 256, 32, 8), torch.int32),
                             ((64, 64, WORDS + 3), torch.float32)):
        payload = torch.randn((n, w), device=dev).mul_(1e4).to(dtype)
        payload[0] = 7777                     # poison: pads must not read it
        ids = rng.randint(-1, n, m).astype(np.int32)
        ids[0] = -1
        pack_case("edge", payload, torch.as_tensor(ids, device=dev))
    log(f"[kernels] spec of the first write's data plane: total "
        f"{spec.total} columns, bmax {spec.bmax}")
    return err


def mesh_plan_vs_plain(inp: dict, err: dict, pack_case) -> None:
    """The mesh plans' kernel calls on the first write's data plane, each
    against its plain version: the ppermute plan's ``route_plan`` (the
    round-relative destinations on the round widths' table), the
    pipelined send pack of one shift round, and the receive permutation's
    gather back to source order over the whole (32, Σw) receive buffer.
    The mesh spec's counts-only ``dest_histogram2d`` is the main path's
    case above, the padded plan's rounds the uniform ``route_plan``."""
    from repro_torch.core import exchange_plan as xp
    from repro_torch.kernels.chunk_router.chunk_router import route_plan
    from repro_torch.kernels.chunk_router.ref import route_plan_ref
    s = xp.plan_mesh_ragged_spec(inp["dest"], inp["valid"], N_NODES,
                                 allow_ppermute=False)
    spec = xp.MeshRaggedSpec(s.budgets, s.round_widths, "ppermute")
    ranks = torch.arange(N_NODES, dtype=torch.int32, device=DEVICE)[:, None]
    rounds = torch.remainder(inp["dest"] - ranks, N_NODES).to(torch.int32)
    table = xp.spec_tables(xp._round_spec(spec), rounds.device).table
    got = route_plan(rounds, inp["valid"], table, total=spec.total)
    torch.cuda.synchronize()
    for name, a, w in zip(("send_idx", "reply_idx", "overflow", "counts"),
                          got, route_plan_ref(rounds, inp["valid"], table,
                                              total=spec.total)):
        err["route_plan"] = max(err["route_plan"], max_abs_err(a, w))
        check(torch.equal(a, w), f"route_plan {name} differs on the "
                                 f"ppermute plan's rounds")
    log(f"[kernels] route_plan ppermute rounds (32, 8), widths "
        f"{spec.round_widths}: equal")
    plan = xp.PermuteExecutor(N_NODES, spec).plan(inp["dest"], inp["valid"],
                                                  client=ranks)
    base = torch.arange(N_NODES, dtype=torch.int32, device=DEVICE)[:, None]
    k, off, w = max(xp.PermuteExecutor(N_NODES, spec)._segments()[1:],
                    key=lambda seg: seg[2])
    part = plan.send_idx[:, off:off + w]
    pack_case(f"mesh path (ppermute round {k} send pack, width {w})",
              inp["fields"], torch.where(part >= 0, part + base * Q, -1)
              .to(torch.int32).reshape(-1))
    recv = pack_chunks_flat(inp["fields"], plan.send_idx, base * Q)
    pack_case("mesh path (ppermute receive permutation)", recv,
              (plan.recv_perm + base * spec.total).to(torch.int32)
              .reshape(-1))
    del recv


def pack_chunks_flat(fields: torch.Tensor, send_idx: torch.Tensor,
                     base: torch.Tensor) -> torch.Tensor:
    """The (L·S, F) send buffer of a plan's (L, S) slots over the (L·q, F)
    request rows (rebased by ``base``), through ``pack_chunks``."""
    from repro_torch.kernels.chunk_pack.chunk_pack import pack_chunks
    return pack_chunks(fields, torch.where(send_idx >= 0, send_idx + base,
                                           -1).to(torch.int32).reshape(-1))


def planner_vs_plain(inp: dict, rng: np.random.RandomState,
                     err: dict) -> None:
    """``route_plan`` and ``dest_budgets`` against their plain versions,
    bit for bit: the first write's data plane (its measured spec's table),
    then the sweep of the CPU tests (N 1/8/32/64 × q 0/1/8/33/100, rows
    all invalid, skewed rows, destinations outside [0, N); uniform budgets
    {1, 3, q}, the measured ones, one below them, random ones), (8, 4) at
    8 nodes (the probe's replay), (32, 1024) at 256 nodes, (32, 100) at
    2048 nodes and (3, 40) at 49,999."""
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
              [(8, 4, 8), (32, 1024, 256), (32, 100, 2048), (3, 40, 49999)])
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
    q > 0, which the uniform ``_compact_plan`` and the ppermute plan also
    call) and measured specs (``plan_ragged_spec`` and
    ``plan_mesh_ragged_spec``, as the client calls them) while active, by
    wrapping the module functions; restores them on exit."""

    def __init__(self):
        from repro_torch.core import burst_buffer as bb
        from repro_torch.core import exchange_plan as xp
        self.rounds = self.specs = 0
        self._targets = [(xp, "_compact_plan_ragged", "rounds"),
                         (bb, "plan_ragged_spec", "specs"),
                         (bb, "plan_mesh_ragged_spec", "specs")]
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


def write_read_stat(client, gen: torch.Generator, n_writes: int,
                    sizes: np.ndarray, writer_cols: int, label: str) -> list:
    """``n_writes`` fused writes of the deployment's batch, then for each
    the ring-permuted cross-node read (node r reads what node r+1 wrote),
    bit for bit, and a stat: every file found with ``sizes``, the data of
    the first ``writer_cols`` columns at their writer.  Returns the
    writes' (paths, chunk ids, request, read request)."""
    batches = []
    for step in range(n_writes):
        paths, cids = batch_paths(step)
        req = client.encode(paths, chunk_id=cids)
        req.payload = random_payload(gen)
        client.write(req)
        batches.append((paths, cids, req))
    torch.cuda.synchronize()
    check(int(client.state.dropped.sum()) == 0, f"{label}: writes dropped")
    out = []
    ranks = np.broadcast_to(np.arange(N_NODES)[:, None],
                            (N_NODES, writer_cols))
    for step, (paths, cids, req) in enumerate(batches):
        # hybrid chunks are remote, so the read runs the metadata probe,
        # then the measured data round
        rot = [paths[(r + 1) % N_NODES] for r in range(N_NODES)]
        rreq = client.encode(rot, chunk_id=np.roll(cids, -1, axis=0))
        data, found = client.read(rreq)
        check(bool(found.all()), f"{label} write {step}: chunks not found")
        check(torch.equal(data, torch.roll(req.payload, -1, dims=0)),
              f"{label} write {step}: read-back differs from the written "
              f"payload")
        found, size, loc = client.stat(req)
        check(bool(found.all()) and np.array_equal(size.cpu().numpy(),
                                                   sizes),
              f"{label} write {step}: stat misses a file or its size")
        check(np.array_equal(loc[:, :writer_cols].cpu().numpy(), ranks),
              f"{label} write {step}: data location is not the writer")
        out.append((paths, cids, req, rreq))
    return out


def drive_deployment(client, gen: torch.Generator) -> list:
    """The deployment's calls and checks: three fused writes, cross-node
    two-phase reads and stats of each (hybrid checkpoint data at its
    writer), create, remove; returns ``write_read_stat``'s batches."""
    batches = write_read_stat(client, gen, N_WRITES, expected_sizes(), 4,
                              "deploy")
    new = client.encode([[f"/bb/ckpt/rank{r}/new{j}" if j % 2 else
                          f"/bb/run/rank{r}/new{j}" for j in range(Q)]
                         for r in range(N_NODES)])
    check(bool(client.create(new).all()), "create did not acknowledge")
    found, size, _ = client.stat(new)
    check(bool(found.all()) and not bool(size.any()),
          "created files not found with size 0")
    req0 = batches[0][2]
    check(bool(client.remove(req0).all()), "remove missed a file")
    found, _, _ = client.stat(req0)
    check(not bool(found.any()), "removed files still found")
    found, _, _ = client.stat(batches[1][2])
    check(bool(found.all()), "remove touched another write's files")
    return batches


def counted_drive(name: str, policy, drive, counters, gen,
                  backend="stacked"):
    """A fresh client under ``policy`` at the deployment's width on
    ``backend`` ("stacked" or a ``NodeMesh``), driven by ``drive(client,
    gen)`` with the data plane's launch counts zeroed just before: each
    must be above 0, with one ``route_plan`` a routing round and one spec
    launch a measured spec.  ``counters``: route_plan, the spec kernel,
    pack_chunks — ``dest_budgets`` measures a stacked spec, the
    counts-only ``dest_histogram2d`` a mesh spec (every row's counts).
    Returns the client, the drive's result, the launches and the
    ``PlannerCalls``."""
    from repro_torch.core.client import BBClient
    client = BBClient(policy, backend, cap=CAP, words=WORDS, mcap=MCAP)
    check(client.device.type == DEVICE, f"{name}: tables not on the card")
    spec_kernel = "dest_budgets" if backend == "stacked" \
        else "dest_histogram2d"
    for c in counters:
        c.launches = 0
    with PlannerCalls() as planner:
        res = drive(client, gen)
        torch.cuda.synchronize()
        launches = {c.name: c.launches for c in counters}
    for k, n in launches.items():
        check(n > 0, f"{name}: {k} never launched on the main path")
    check(launches["route_plan"] == planner.rounds,
          f"{name}: {planner.rounds} routing rounds made "
          f"{launches['route_plan']} route_plan launches, not one each")
    check(launches[spec_kernel] == planner.specs,
          f"{name}: {planner.specs} measured specs made "
          f"{launches[spec_kernel]} {spec_kernel} launches, not one each")
    return client, res, launches, planner


def phase_deployment(seed: int, counters) -> dict:
    """``counters`` are every data-plane kernel's (route_plan,
    dest_budgets, pack_chunks), held by ``counted_drive``."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client, batches, launches, planner = counted_drive(
        "deploy", deployment_policy(), drive_deployment, counters, gen)
    wall = time.perf_counter() - t0
    kind = client._select_kind(Q)
    check(kind == "compacted", f"exchange auto picked {kind}, not compacted")
    log(f"[deploy] N={N_NODES} cap={CAP} mcap={MCAP} words={WORDS} q={Q}; "
        f"data table {client.state.data.numel() * 4 / 2 ** 30:.2f} GiB; "
        f"exchange auto -> {kind}")
    log(f"[deploy] planner: {planner.rounds} routing rounds, one "
        f"route_plan launch each; {planner.specs} measured specs, one "
        f"dest_budgets launch each")
    log(f"[deploy] {N_WRITES} fused writes ({N_WRITES * N_NODES * Q} chunks, "
        f"{N_WRITES * N_NODES * Q} MiB), {N_WRITES} reads, stats, create, "
        f"remove: all checks hold in {wall:.2f} s (client made included)")
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
    paths, cids, req, _ = deploy["batches"][-1]
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
    up to ``tries`` sessions in all (``fn`` runs once a session).  The
    ``nccl:*`` device records are the ranges of NCCL collectives around
    their own copies and kernels (``nccl_ms``), not operations: busy time
    and the operation count leave them out."""
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

    nccl = [e for e in dev if e.key.startswith("nccl:")]
    dev = [e for e in dev if not e.key.startswith("nccl:")]
    return dict(
        wall_ms=wall, dev=dev,
        busy_ms=sum(e.self_device_time_total for e in dev) / 1e3,
        nccl_ms=sum(e.self_device_time_total for e in nccl) / 1e3,
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
    hot_sig = adapted_signature(rec)
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
           "new_mode": int(new_mode), "hot_signature": hot_sig}
    out.update(adapt_path_timings(client, ctl, seed))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[adapt] peak device memory of the phase "
        f"{out['peak_gib']:.2f} GiB (data table "
        f"{client.state.data.numel() * 4 / 2 ** 30:.2f} GiB)")
    return out


def adapted_signature(rec) -> list:
    """The live ``/bb/hot`` signature the adoption was decided on: the
    ``redecide`` audit record of that scope just before the adopting
    ``gate_delta`` record."""
    records = rec.audit.records()
    at = [i for i, r in enumerate(records)
          if r.kind == "gate_delta" and r.choice == "adopt"]
    check(len(at) == 1, f"{len(at)} adopting gate_delta records")
    sig = [r for r in records[:at[0]] if r.kind == "redecide"
           and r.inputs.get("scope") == ADAPT_SCOPE]
    check(bool(sig), f"no redecide record of {ADAPT_SCOPE} before the "
                     f"adoption")
    return [float(x) for x in sig[-1].inputs["signature"]]


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
# (h) the decision pipeline: decide, execute every decided layout, launch
# ---------------------------------------------------------------------------
def host_cpu() -> str:
    """The host's CPU model and core count (host-only times name it), as
    ``lscpu`` gives them."""
    import os
    import platform
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60).stdout
    model = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
             if ln.startswith("Model name:")]
    return (f"{model[0] if model else platform.machine()}, "
            f"{os.cpu_count()} cores")


def decide_matrix() -> dict:
    """``select_layout`` over ``build_workloads(32)`` under the four
    settings, held against the pinned decisions and accuracies; the
    adversarial corpus and the heterogeneous plan; host times."""
    from repro_torch.core.intent.oracle import oracle_mode
    from repro_torch.core.intent.selector import select_layout
    from repro_torch.core.workloads import (adversarial_workloads,
                                            build_workloads,
                                            heterogeneous_workload)
    ws = build_workloads(N_NODES)
    oracle = {w.name: oracle_mode(w) for w in ws}
    got, acc, per = {}, {}, []
    t0 = time.perf_counter()
    for setting, kw in DECIDE_SETTINGS.items():
        hits = 0
        for w in ws:
            t1 = time.perf_counter()
            d = select_layout(w, **kw)
            if setting == "full":
                per.append((time.perf_counter() - t1) * 1e3)
                got[w.name] = (int(d.mode), d.confidence)
            hits += int(d.mode == oracle[w.name])
        acc[setting] = (hits, len(ws))
    matrix_ms = (time.perf_counter() - t0) * 1e3
    for name, want in DECISIONS.items():
        check(got.get(name) == want, f"{name}: decided {got.get(name)}, "
                                     f"the reference {want}")
    check(acc == ACCURACY, f"accuracies {acc}, the reference's {ACCURACY}")
    adv = [(w.name, int(select_layout(w, static_engine="auto").mode),
            int(oracle_mode(w))) for w in adversarial_workloads(N_NODES)]
    check(all(m == o for _, m, o in adv) and len(adv) == 6,
          f"adversarial corpus (decided, oracle): {adv}")
    het = select_layout(heterogeneous_workload(N_NODES))
    plan = ({k: int(v) for k, v in het.scope_modes.items()}, int(het.mode))
    check(plan == HETERO_PLAN, f"heterogeneous plan {plan}, the "
                               f"reference's {HETERO_PLAN}")
    modes = sorted({m for m, _ in got.values()})
    log(f"[decide] {len(ws)} workloads x {len(DECIDE_SETTINGS)} settings: "
        f"accuracies {acc} as the reference's; the 23 modes and "
        f"confidences equal the pinned ones; adversarial 6 of 6 (auto); "
        f"heterogeneous plan {plan[0]} default {plan[1]}; whole-job modes "
        f"{modes}")
    log(f"[decide] host ms, one select_layout (median of 23, full "
        f"setting) {median(per):.3f}, the matrix ({len(ws)} x "
        f"{len(DECIDE_SETTINGS)}) {matrix_ms:.3f}; CPU {host_cpu()}")
    return {"modes": modes, "hetero": het, "accuracy": acc,
            "select_ms": median(per), "matrix_ms": matrix_ms}


class ClientCalls:
    """Records every write and read of ``BBClient`` while active: the
    read's outputs and every node table after each call, on the host."""

    def __init__(self):
        from repro_torch.core.client import BBClient
        self.cls, self.calls, self._saved = BBClient, [], {}

    def __enter__(self):
        for name in ("write", "read"):
            real = self._saved[name] = getattr(self.cls, name)

            def recorded(client, req, *a, _real=real, _name=name, **kw):
                out = _real(client, req, *a, **kw)
                got = list(out) if _name == "read" else []
                got += [getattr(client.state, f.name)
                        for f in dataclasses.fields(client.state)]
                self.calls.append((_name, [   # a copy: tables change in place
                    x.to("cpu", copy=True) if torch.is_tensor(x) else x
                    for x in got]))
                return out
            setattr(self.cls, name, recorded)
        return self

    def __exit__(self, *exc):
        for name, real in self._saved.items():
            setattr(self.cls, name, real)


def same_call(a, b) -> bool:
    return a[0] == b[0] and len(a[1]) == len(b[1]) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(a[1], b[1]))


def probe_replay(counters) -> dict:
    """``run_probe(through_engine=True)`` for every workload on the card:
    the counters equal the shim's; the replay's routing rounds launch
    ``route_plan`` (``counters``: route_plan, dest_budgets, pack_chunks);
    every write and read (read outputs, node tables after the call) equals
    the same replay on the CPU, bit for bit."""
    from repro_torch.core.intent.probe import run_probe
    from repro_torch.core.workloads import build_workloads
    ws = build_workloads(N_NODES)
    for c in counters:
        c.launches = 0
    with PlannerCalls() as planner, ClientCalls() as card:
        t0 = time.perf_counter()
        for w in ws:
            got = run_probe(w, through_engine=True).to_darshan_dict()
            want = run_probe(w).to_darshan_dict()
            check(got == want, f"{w.name}: the replay changed the probe's "
                               f"counters: {got} against {want}")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {c.name: c.launches for c in counters}
    check(launches["route_plan"] > 0, "the probe replay launched no "
                                      "route_plan")
    check(launches["route_plan"] == planner.rounds and
          launches["dest_budgets"] == planner.specs,
          f"probe replay: {planner.rounds} rounds and {planner.specs} specs "
          f"made {launches}")
    with ClientCalls() as host:
        for w in ws:
            run_probe(w, through_engine=True, device="cpu")
    names = [w.name for w in ws for _ in w.phases[:2]]   # a call a phase
    check(len(card.calls) == len(host.calls) == len(names),
          f"replay calls: {len(card.calls)} on the card, {len(host.calls)} "
          f"on the CPU, {len(names)} phases replayed")
    for name, c, h in zip(names, card.calls, host.calls):
        check(same_call(c, h), f"replay of {name} ({c[0]}): the card's "
                               f"outputs or node tables differ from the "
                               f"CPU's")
    log(f"[decide] probe replay (8 nodes, q 4, 8 words) of {len(ws)} "
        f"workloads on the card in {wall:.3f} ms (each call's tables "
        f"copied to the host included): counters as the shim's; "
        f"{len(card.calls)} writes and reads equal the CPU replay's, "
        f"outputs and node tables; launches {launches}")
    return {"launches": launches, "ms": wall}


def hetero_batch():
    """Per node r: a 4 MiB N-N checkpoint transfer (4 chunks) under
    ``/bb/ckpt/rank{r}/`` and 4 one-chunk files under ``/bb/shared/``,
    one fused write (``heterogeneous_workload``'s phases)."""
    paths, cids = [], []
    for r in range(N_NODES):
        paths.append([f"/bb/ckpt/rank{r}/ckpt.0"] * HETERO_CKPT +
                     [f"/bb/shared/rank{r}/part{j}"
                      for j in range(HETERO_SHARED)])
        cids.append(list(range(HETERO_CKPT)) + [0] * HETERO_SHARED)
    return paths, np.asarray(cids, np.int32)


def drive_hetero(client, gen: torch.Generator) -> dict:
    """The heterogeneous plan's traffic and checks: the fused write,
    creates and stats of shared files, then each node reads its own
    checkpoint chunks and its ring neighbour's shared files (node r reads
    what node r+1 wrote), bit for bit; returns the timed requests."""
    paths, cids = hetero_batch()
    req = client.encode(paths, chunk_id=cids)
    req.payload = random_payload(gen)
    client.write(req)
    torch.cuda.synchronize()
    check(int(client.state.dropped.sum()) == 0, "hetero writes dropped")
    new = client.encode([[f"/bb/shared/rank{r}/new{j}" for j in range(Q)]
                         for r in range(N_NODES)])
    check(bool(client.create(new).all()), "shared creates not acknowledged")
    found, size, _ = client.stat(new)
    check(bool(found.all()) and not bool(size.any()),
          "created shared files not found with size 0")
    rpaths = [paths[r][:HETERO_CKPT] + paths[(r + 1) % N_NODES][HETERO_CKPT:]
              for r in range(N_NODES)]
    rreq = client.encode(rpaths, chunk_id=cids)
    out, found = client.read(rreq)
    want = torch.cat([req.payload[:, :HETERO_CKPT],
                      torch.roll(req.payload[:, HETERO_CKPT:], -1, dims=0)],
                     dim=1)
    check(bool(found.all()), "hetero read: chunks not found")
    check(torch.equal(out, want), "hetero read differs from the written "
                                  "payload")
    found, size, loc = client.stat(rreq)
    sizes = np.array([HETERO_CKPT] * HETERO_CKPT + [1] * HETERO_SHARED)
    check(bool(found.all()) and np.array_equal(
        size.cpu().numpy(), np.broadcast_to(sizes, (N_NODES, Q))),
          "hetero stat: files missing or sizes wrong")
    writers = np.roll(np.arange(N_NODES), -1)[:, None]
    check(np.array_equal(loc[:, HETERO_CKPT:].cpu().numpy(),
                         np.broadcast_to(writers, (N_NODES, HETERO_SHARED))),
          "hetero stat: a HYBRID shared file's data is not at its writer")
    return {"write": req, "read": rreq, "stat": rreq}


def drive_uniform(client, mode: int, gen: torch.Generator) -> dict:
    """``write_read_stat`` of one batch under a uniform policy; under
    NODE_LOCAL a node's metadata of the N-to-1 file holds only its own
    chunks (size 2r + 2).  Returns the timed requests."""
    sizes = expected_sizes()
    if mode == 1:
        sizes[:, 4:6] = 2 * np.arange(1, N_NODES + 1)[:, None]
    (_, _, req, rreq), = write_read_stat(client, gen, 1, sizes, 0,
                                         f"mode {mode}")
    return {"write": req, "read": rreq, "stat": req}


def run_layout(name: str, policy, drive, counters, gen) -> dict:
    """``counted_drive``, then each call's latency (host clock, best of 3)
    and profile (launches, host syncs, host-to-device copies)."""
    client, reqs, launches, planner = counted_drive(name, policy, drive,
                                                    counters, gen)
    calls = {"write": lambda: client.write(reqs["write"]),
             "read": lambda: client.read(reqs["read"]),
             "stat": lambda: client.stat(reqs["stat"])}
    out = {"kind": client._select_kind(Q), "launches": launches,
           "rounds": planner.rounds, "specs": planner.specs}
    for call, fn in calls.items():
        st = call_profile(fn)
        out[call] = {"ms": host_ms(fn, 3), "launches": st["launches"],
                     "syncs": st["syncs"], "htod": st["htod"],
                     "busy_ms": st["busy_ms"]}
    log(f"[decide] {name}: exchange {out['kind']}; reads bit for bit; "
        f"{launches} ({planner.rounds} rounds, {planner.specs} specs); " +
        "; ".join(f"{c} {out[c]['ms']:.3f} ms, {out[c]['launches']}/"
                  f"{out[c]['syncs']}/{out[c]['htod']} launches/syncs/"
                  f"copies, busy {out[c]['busy_ms']:.3f}" for c in calls))
    return out


def execute_layouts(decided: dict, counters, seed: int) -> dict:
    """The decided heterogeneous plan, then a uniform policy of each
    whole-job mode the decisions gave, one client at a time."""
    from repro_torch.core.policy import LayoutPolicy
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    policy = decided["hetero"].layout_policy(N_NODES)
    check(({s: int(m) for s, m in policy.scopes}, int(policy.default_mode))
          == HETERO_PLAN, f"the decided policy {policy} is not the plan")
    runs = [("hetero", "heterogeneous plan " + str(HETERO_PLAN), policy,
             drive_hetero)]
    runs += [(f"M{m}", f"uniform mode {m}", LayoutPolicy.uniform(m, N_NODES),
              lambda c, g, m=m: drive_uniform(c, m, g))
             for m in decided["modes"]]
    out = {}
    for key, name, pol, drive in runs:
        # free any client left unreferenced (this phase's or an earlier
        # phase's) before the next 8 GiB table is made
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        out[key] = run_layout(name, pol, drive, counters, gen)
        out[key]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[decide] {name}: peak device memory "
            f"{out[key]['peak_gib']:.2f} GiB ({held:.2f} GiB held before "
            f"its client was made)")
    return out


def redecide_hot(signature: list) -> int:
    """Phase e2's adopted ``/bb/hot`` signature through
    ``signature_workload`` and the full selector."""
    from repro_torch.core.adapt.redecide import signature_workload
    from repro_torch.core.intent.selector import select_layout
    from repro_torch.core.layouts import LayoutMode
    w = signature_workload(ADAPT_SCOPE, np.asarray(signature), N_NODES)
    d = select_layout(w)
    check(isinstance(d.mode, LayoutMode), f"re-decision gave {d.mode!r}")
    log(f"[decide] {ADAPT_SCOPE} signature at adoption "
        f"{[round(x, 4) for x in signature]} -> selector Mode "
        f"{int(d.mode)} ({d.mode.name}, confidence {d.confidence:.2f}; "
        f"{d.decision.steps[-1]})")
    return int(d.mode)


def release_host_memory() -> None:
    """Hand freed host memory back to the system: the page-locked blocks
    PyTorch keeps cached (the checkpoint manager's staging buffers, freed
    with its store; ``torch.accelerator.empty_host_cache``, before it
    ``torch._C._host_emptyCache``) and the C heap's free pages
    (``malloc_trim``: a store's freed 1 MiB chunks stay in it)."""
    empty = getattr(torch.accelerator, "empty_host_cache", None) or \
        getattr(torch._C, "_host_emptyCache", None)
    check(empty is not None, "this torch cannot release cached pinned "
                             "host memory")
    empty()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def launch_training(counters, args=LAUNCH_ARGS,
                    n_params: int = 999_812_736,
                    max_saves: int = LAUNCH_SAVES) -> dict:
    """``repro_torch.launch.train.main`` in-process at full width (``args``,
    a model of ``n_params`` params): it decides Mode 1, trains, and
    checkpoints every LAUNCH_CKPT_EVERY steps, up to ``max_saves`` saves as
    host RAM holds them; ``counters`` (segmented checksum and routing)
    launch once a save.  The decision's host time is its call timed once
    beside the run."""
    import contextlib
    import io
    from repro_torch.core.intent.selector import select_layout
    from repro_torch.core.workloads import workload_by_name
    from repro_torch.launch import train as launcher
    save_gib = 12 * n_params / 2 ** 30
    avail = mem_available_gib()
    saves = min(max_saves, int((avail - LAUNCH_RESERVE_GIB) // save_gib))
    check(saves >= 1, f"host MemAvailable {avail:.1f} GiB holds no save")
    steps = saves * LAUNCH_CKPT_EVERY
    argv = list(args) + ["--steps", str(steps), "--ckpt-every",
                         str(LAUNCH_CKPT_EVERY)]
    t1 = time.perf_counter()
    select_layout(workload_by_name("IOR-A"))
    decide_ms = (time.perf_counter() - t1) * 1e3
    for c in counters:
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = launcher.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(line)
    launches = {c.name: c.launches for c in counters}
    check(lines and lines[0].startswith(
        "[train] Proteus layout decision: Mode 1 "),
          f"the launcher decided {lines[:1]}, not Mode 1 (NODE_LOCAL)")
    check(res.final_step == steps and len(res.losses) == steps and
          all(np.isfinite(res.losses)),
          f"final step {res.final_step}, losses {res.losses}")
    check(all(n == saves for n in launches.values()),
          f"{saves} saves made {launches}, not one of each a save")
    check(not any(dataclasses.asdict(res.failure_log).values()),
          f"FailureLog {res.failure_log}")
    log(f"[launch] {' '.join(argv)}: {steps} steps, {saves} saves (host "
        f"MemAvailable {avail:.1f} GiB before), launches {launches}; wall "
        f"{wall:.3f} s; one select_layout of IOR-A {decide_ms:.3f} ms "
        f"host, so training ~{wall - decide_ms / 1e3:.3f} s")
    del res
    gc.collect()
    log(f"[launch] host MemAvailable {mem_available_gib():.1f} GiB after "
        f"the run's store is freed")
    return {"argv": argv, "steps": steps, "saves": saves,
            "launches": launches, "wall_s": wall, "decision_ms": decide_ms,
            "train_s": wall - decide_ms / 1e3}


def phase_decide(seed: int, plane, ckpt, hot_signature: list) -> dict:
    """(h): ``plane`` are the data plane's counters (route_plan,
    dest_budgets, pack_chunks), ``ckpt`` the checkpoint path's
    (fletcher_segmented, route_chunks_segmented)."""
    t0 = time.perf_counter()
    decided = decide_matrix()
    out = {k: decided[k] for k in ("modes", "accuracy", "select_ms",
                                   "matrix_ms")}
    out["replay"] = probe_replay(plane)
    out["layouts"] = execute_layouts(decided, plane, seed)
    out["hot_redecided"] = redecide_hot(hot_signature)
    torch.cuda.empty_cache()
    out["launch"] = launch_training(ckpt)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"[decide] phase h wall {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# (i) the examples and the mesh backend
# ---------------------------------------------------------------------------
#: the mesh plans driven through the stacked engine: (executor, pipeline)
MESH_PLANS = (("padded", True), ("ppermute", True), ("ppermute", False))


def run_examples() -> dict:
    """Both examples' ``main()`` in this process, their tables where the
    examples put them by default (the card): the demo's accuracy line and
    per-scope plan faster than every uniform mode in the simulator, and
    both mixed batches read back bit for bit (each ``main`` raises
    otherwise)."""
    import contextlib
    import io

    from repro_torch.examples import proteus_layout_demo, quickstart
    argv = [] if DEVICE == "cuda" else ["--device", DEVICE]
    out = {}
    for name, mod in (("quickstart", quickstart),
                      ("demo", proteus_layout_demo)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "lines": buf.getvalue().splitlines()}
        client = res if name == "quickstart" else res["client"]
        check(client.state.data.device.type == DEVICE,
              f"{name}: tables not on the card")
    qs, demo = out["quickstart"]["lines"], out["demo"]["lines"]
    check(any("64 chunks written + read back intact" in x for x in qs),
          "quickstart: no read-back line")
    check("accuracy: 21/23 = 91.30%  (paper: 91.30%)" in demo,
          "demo: accuracy is not 21/23")
    times = res["times"]
    check(all(times["per-scope policy"] < v for k, v in times.items()
              if k.startswith("uniform")),
          f"demo: the per-scope plan does not beat every uniform mode "
          f"{times}")
    check(any(x.startswith("BB engine: mixed-mode batch") for x in demo),
          "demo: no mixed-batch read-back line")
    for name, lines in (("quickstart", qs[-4:]), ("demo", demo[-10:])):
        for line in lines:
            if line.strip():
                log(f"[mesh] example {name}: {line}")
    log(f"[mesh] examples on the card: quickstart "
        f"{out['quickstart']['ms']:.1f} ms, demo {out['demo']['ms']:.1f} "
        f"ms (host, decisions included)")
    return {k: v["ms"] for k, v in out.items()}


def mesh_plan_calls(policy, state, req, rreq, executor: str,
                    pipeline: bool) -> dict:
    """A write of ``req``, the two-phase read of ``rreq`` and a stat of
    ``req`` through the stacked engine with every plane's spec measured on
    its call's destinations (``plan_mesh_ragged_spec``, as a mesh client
    plans) and forced to ``executor``: the mesh plans' executors on the
    single-device hooks (``stacked_exchange``, ``stacked_shift``)."""
    from repro_torch.core import burst_buffer as bb
    from repro_torch.core.layouts import LayoutMode, route_data, route_meta
    ranks = torch.arange(N_NODES, dtype=torch.int32, device=DEVICE)[:, None]
    valid = torch.ones((N_NODES, Q), dtype=torch.bool, device=DEVICE)

    def full(v):
        return torch.full((N_NODES, Q), v, dtype=torch.int32, device=DEVICE)

    def spec(dest, ok):
        s = bb.plan_mesh_ragged_spec(dest, ok, N_NODES, allow_ppermute=False)
        return bb.MeshRaggedSpec(s.budgets, s.round_widths, executor)

    def config(data=None, meta=None):
        return bb.ExchangeConfig(
            "compacted", pipeline=pipeline,
            data_spec=None if data is None else spec(*data),
            meta_spec=None if meta is None else spec(*meta))

    def owners(r, mode):
        return route_meta(mode, N_NODES, policy.n_md_servers, r.path_hash,
                          ranks)

    def write():
        mode = policy.resolve(req.scope_hash)
        dest = route_data(mode, N_NODES, req.path_hash, req.chunk_id, ranks)
        return bb.forward_write(
            state, policy, req.path_hash, req.chunk_id, req.payload, valid,
            mode=mode, config=config((dest, valid),
                                     (owners(req, mode), valid)))

    def read():
        mode = policy.resolve(rreq.scope_hash)
        probe = valid & (mode == LayoutMode.HYBRID)
        _, fm, _, loc = bb.meta_op(
            state, policy, full(bb.OP_STAT), rreq.path_hash, full(0),
            full(-1), probe, mode=mode,
            config=config(meta=(owners(rreq, mode), probe)))
        data_loc = torch.where(fm & (loc >= 0), loc,
                               ranks.expand(N_NODES, Q))
        dest = route_data(mode, N_NODES, rreq.path_hash, rreq.chunk_id,
                          ranks, data_loc=data_loc)
        return bb.forward_read(state, policy, rreq.path_hash, rreq.chunk_id,
                               valid, mode=mode,
                               config=config((dest, valid)),
                               data_loc=data_loc)

    def stat():
        mode = policy.resolve(req.scope_hash)
        _, f, size, loc = bb.meta_op(
            state, policy, full(bb.OP_STAT), req.path_hash, full(0),
            full(-1), valid, mode=mode,
            config=config(meta=(owners(req, mode), valid)))
        return f, size, loc

    return {"write": write, "read": read, "stat": stat}


def call_stats(label: str, calls: dict) -> dict:
    """Each call's latency (host clock, best of 3) and one profile of it
    (``profile_call``: launches, host syncs, host-to-device copies, device
    busy ms and idle share, the NCCL kernels' device ms, the top
    kernels logged)."""
    out = {}
    for name, fn in calls.items():
        st = profile_call(f"{label} {name}", fn)
        out[name] = {"ms": host_ms(fn, 3),
                     **{k: st[k] for k in ("launches", "syncs", "htod",
                                           "busy_ms", "idle", "nccl_ms")}}
    return out


def same_tables(a, b, label: str) -> None:
    for f in dataclasses.fields(a):
        check(torch.equal(getattr(a, f.name), getattr(b, f.name)),
              f"{label}: table {f.name} differs from the stacked client's")


def mesh_plans(seed: int, policy, counters: dict) -> dict:
    """(i) 2: the padded and ppermute plans, pipelined and not, at the
    deployment's width through the stacked engine, against the compacted
    stacked client on one batch: tables after the write, the read's
    replies and the stat triples, bit for bit; ``dest_histogram2d`` (the
    mesh specs) and ``pack_chunks`` launched; each call's latency and
    profile; the write's data-plane buffer against the stacked plan's
    packed Σbᵢ; peak memory."""
    from repro_torch.core import burst_buffer as bb
    from repro_torch.core.client import BBClient
    from repro_torch.core.layouts import route_data
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    ref = BBClient(policy, cap=CAP, words=WORDS, mcap=MCAP)
    paths, cids = batch_paths(0)
    req = ref.encode(paths, chunk_id=cids)
    req.payload = random_payload(gen)
    rreq = ref.encode([paths[(r + 1) % N_NODES] for r in range(N_NODES)],
                      chunk_id=np.roll(cids, -1, axis=0))
    ref.write(req)
    want_read, want_stat = ref.read(rreq), ref.stat(req)
    check(bool(want_read[1].all()), "mesh plans: the stacked read missed")
    ranks = torch.arange(N_NODES, dtype=torch.int32, device=DEVICE)[:, None]
    mode = policy.resolve(req.scope_hash)
    dest = route_data(mode, N_NODES, req.path_hash, req.chunk_id, ranks)
    valid = torch.ones((N_NODES, Q), dtype=torch.bool, device=DEVICE)
    row = 4 * (WORDS + 3)                      # a write's data row, bytes
    ragged = bb.plan_ragged_spec(dest, valid, N_NODES)
    mspec = bb.plan_mesh_ragged_spec(dest, valid, N_NODES,
                                     allow_ppermute=False)
    out = {"data_plane": {
        "budgets": list(mspec.budgets), "round_widths":
        list(mspec.round_widths), "bmax": mspec.bmax,
        "padded_bytes": N_NODES * N_NODES * mspec.bmax * row,
        "ppermute_bytes": N_NODES * mspec.total * row,
        "ppermute_exchanged_bytes": N_NODES * mspec.exchanged_cols * row,
        "ragged_bytes": N_NODES * ragged.total * row}}
    log(f"[mesh] write data plane at {N_NODES} nodes: bmax {mspec.bmax}, "
        f"padded buffer {out['data_plane']['padded_bytes'] / 2 ** 30:.3f} "
        f"GiB; ppermute Σw {mspec.total} ({mspec.exchanged_cols} off the "
        f"node), round widths {mspec.round_widths}; stacked ragged Σb "
        f"{ragged.total} "
        f"({out['data_plane']['ragged_bytes'] / 2 ** 30:.3f} GiB)")
    for executor, pipeline in MESH_PLANS:
        key = f"{executor}{'' if pipeline else '-sync'}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = bb.init_state(N_NODES, CAP, WORDS, MCAP, device=DEVICE)
        calls = mesh_plan_calls(policy, state, req, rreq, executor,
                                pipeline)
        for c in counters.values():
            c.launches = 0
        calls["write"]()
        same_tables(state, ref.state, key)
        got = calls["read"]()
        check(all(torch.equal(a, b) for a, b in zip(got, want_read)),
              f"{key}: the read differs from the stacked client's")
        got = calls["stat"]()
        check(all(torch.equal(a, b) for a, b in zip(got, want_stat)),
              f"{key}: the stat differs from the stacked client's")
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        for k in ("dest_histogram2d", "pack_chunks"):
            check(launches[k] > 0, f"{key}: {k} never launched")
        del got
        res = {"launches": launches, **call_stats(f"mesh {key}", calls)}
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out[key] = res
        log(f"[mesh] {key} plan (stacked engine): tables, read and stat "
            f"bit for bit; launches {launches}; " +
            "; ".join(f"{c} {res[c]['ms']:.3f} ms, {res[c]['launches']}/"
                      f"{res[c]['syncs']}/{res[c]['htod']} launches/syncs/"
                      f"copies, busy {res[c]['busy_ms']:.3f}"
                      for c in ("write", "read", "stat")) +
            f"; peak {res['peak_gib']:.2f} GiB")
        del calls, state
    return out


def mesh_client(seed: int, policy, counters: dict, mesh) -> dict:
    """(i) 3: ``BBClient(policy, mesh)`` over the process group's backend,
    through ``counted_drive`` (the stacked client's gate, mesh specs
    counted by their ``dest_histogram2d`` launches), its tables equal to a
    stacked client's after the same calls; latency beside the stacked
    client's, the profile with the NCCL kernels' device ms, the bytes the
    ``all_to_all``s of one call carry, and peak memory."""
    import torch.distributed as dist

    from repro_torch.core.client import BBClient
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    client, batches, launches, planner = counted_drive(
        "mesh client", policy, drive_deployment,
        tuple(counters[k] for k in ("route_plan", "dest_histogram2d",
                                    "pack_chunks")), gen, backend=mesh)
    specs = list(client.last_specs.values())
    check(specs and all(type(s).__name__ == "MeshRaggedSpec" and
                        s.executor == "padded" for s in specs),
          "mesh client: planned specs other than padded mesh ones")
    stacked = BBClient(policy, cap=CAP, words=WORDS, mcap=MCAP)
    drive_deployment(stacked, torch.Generator(device=DEVICE).manual_seed(
        seed + 11))
    same_tables(client.state, stacked.state, "mesh client")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, _, req, rreq = batches[-1]
    out = {"launches": launches, "rounds": planner.rounds,
           "specs": planner.specs, "peak_gib": peak}
    sent = []
    real = dist.all_to_all_single

    def counted(output, input, *a, **k):
        sent.append(input.numel() * input.element_size())
        return real(output, input, *a, **k)

    for name, c in (("mesh", client), ("stacked", stacked)):
        calls = {"write": lambda c=c: c.write(req),
                 "read": lambda c=c: c.read(rreq),
                 "stat": lambda c=c: c.stat(req)}
        out[name] = call_stats(f"mesh client ({name})", calls)
        if name == "mesh":
            for call, fn in calls.items():
                sent.clear()
                dist.all_to_all_single = counted
                try:
                    fn()
                finally:
                    dist.all_to_all_single = real
                out[name][call]["all_to_all"] = len(sent)
                out[name][call]["all_to_all_bytes"] = sum(sent)
    log(f"[mesh] client on a {mesh.world}-rank {mesh.backend} mesh "
        f"({mesh.device}): every read bit for bit, tables equal to the "
        f"stacked client's; {planner.rounds} rounds, {planner.specs} mesh "
        f"specs, launches {launches}; peak {peak:.2f} GiB")
    for call in ("write", "read", "stat"):
        m, s_ = out["mesh"][call], out["stacked"][call]
        log(f"[mesh]   {call}: mesh {m['ms']:.3f} ms ({m['launches']}/"
            f"{m['syncs']}/{m['htod']}, busy {m['busy_ms']:.3f}, NCCL "
            f"{m['nccl_ms']:.3f} ms device over {m['all_to_all']} "
            f"all_to_all of {m['all_to_all_bytes'] / 2 ** 30:.3f} GiB) vs "
            f"stacked {s_['ms']:.3f} ms ({s_['launches']}/{s_['syncs']}/"
            f"{s_['htod']}, busy {s_['busy_ms']:.3f})")
    return out


def mesh_collectives(mesh) -> None:
    """(i) 5: at world size 1 the shift is the identity, ``mesh_exchange``
    the stacked transpose, ``mesh_global_sum`` the sum, and
    ``build_telemetry_reduce`` of a telemetry client's counters its
    ``snapshot()``."""
    from repro_torch.core import mesh_engine as me
    from repro_torch.core.client import BBClient
    from repro_torch.core.policy import LayoutPolicy
    x = torch.arange(4 * 4 * 3 * 5, dtype=torch.int32,
                     device=DEVICE).reshape(4, 4, 3, 5)
    shift = me.build_mesh_shift(mesh)
    check(all(shift(x, k) is x for k in (1, 3, -2)),
          "the shift at world size 1 is not the identity")
    check(torch.equal(me.mesh_exchange(x, mesh), x.transpose(0, 1)),
          "mesh_exchange at world size 1 is not the transpose")
    check(int(me.mesh_global_sum(x, mesh)) == int(x.sum()),
          "mesh_global_sum is not the sum")
    client = BBClient(LayoutPolicy.from_scopes({ADAPT_SCOPE: 1}, n_nodes=8,
                                               default=3), mesh, cap=64,
                      words=16, mcap=64, telemetry=True)
    rng = np.random.RandomState(5)
    paths = [[f"{ADAPT_SCOPE}/r{i}/f{j % 3}" if j % 2 else f"/x/{i}/{j}"
              for j in range(6)] for i in range(8)]
    req = client.encode(paths, chunk_id=rng.randint(0, 4, (8, 6)),
                        payload=rng.randint(0, 999, (8, 6, 16)))
    client.write(req)
    client.read(req)
    client.stat(req)
    red = me.build_telemetry_reduce(mesh)(client.telemetry.counts)
    check(np.array_equal(red.cpu().numpy(), client.telemetry.snapshot()),
          "build_telemetry_reduce differs from the snapshot")
    log("[mesh] world size 1: shift identity, all_to_all = transpose, "
        "global sum = sum, telemetry reduce = snapshot")


def phase_mesh(seed: int, counters: dict) -> dict:
    """(i): the examples, the mesh plans through the stacked engine, the
    mesh client on a world of one rank, the dry-run's BB cell and the
    collectives at world size 1.  ``counters``: name → launch counter of
    route_plan, dest_budgets, dest_histogram2d and pack_chunks; returns
    the phase's numbers and the launches of its mesh client (the main
    path's)."""
    import torch.distributed as dist

    from repro_torch.core import mesh_engine as me
    from repro_torch.launch.dryrun import run_bb_cell
    t0 = time.perf_counter()
    out = {"examples_ms": run_examples()}
    policy = deployment_policy()
    out["plans"] = mesh_plans(seed, policy, counters)
    mesh = me.make_node_mesh(device=None if DEVICE == "cuda" else DEVICE)
    try:
        check(mesh.device.type == DEVICE and
              mesh.backend == me.BACKENDS[DEVICE] and
              dist.get_backend() == me.BACKENDS[DEVICE],
              f"make_node_mesh gave {mesh} on {dist.get_backend()}")
        out["client"] = mesh_client(seed, policy, counters, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            rec = run_bb_cell(Path(tmp), 8, mesh)
            check(rec["status"] == "ok" and rec["backend"] ==
                  me.BACKENDS[DEVICE] and
                  (Path(tmp) / "bb-client__n8q8w16__node.json").exists(),
                  f"the BB cell's record {rec}")
        log(f"[mesh] dry-run BB cell at world size {rec['ranks']} on "
            f"{rec['backend']}: heterogeneous policy, mesh/stacked parity")
        mesh_collectives(mesh)
    finally:
        dist.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t0
    log(f"[mesh] phase i wall {out['wall_s']:.3f} s")
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
# (j) serving: KV cache, decode and prefill steps, the serve command lines
# ---------------------------------------------------------------------------
# gemma3-1b at full width under the reference's serving dtypes (bf16 params,
# bf16 activations): teacher forcing and greedy generation at B 4, 16 + 32
# tokens (all below the 512 window); the decode cells, name → (cache length,
# batch), decode_32k's batch 128 cut to 32 (its cache alone is 26 GiB at
# 32); prefill_32k at batch 4 of 32 (the blocked forms' float32 tiles and
# the MLP's activations at 32 x 32,768 tokens would not fit); the blocked
# forms against the masked one at S 2048; gemma-7b and minitron-8b at full
# width, teacher forcing over 1 x 64 tokens and 8 decode steps at B 8.
# examples/train_lm's twin at 40 steps (reduced xlstm-125m, the example's
# random failure plan: stragglers at 15 and 23, saves at 20 and 40): the
# FailureLog and final step of the JAX example's loop on the CPU
# (tests/test_torch_recurrent.py holds this pin to the JAX package)
TRAIN_LM_STEPS = 40
TRAIN_LM_EXPECTED = ({"crashes": 0, "stragglers": 2, "corruptions": 0,
                      "restores": 0, "fallback_restores": 0,
                      "redone_steps": [15, 23]}, 40)

SERVE_ARCH = "gemma3-1b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32
DECODE_CELLS = {"decode_32k": (32768, 32), "long_500k": (524288, 1)}
PREFILL_CELL = ("prefill_32k", 32768, 4)
BLOCKED_SEQ = 2048
BIG_ARCHS = {"gemma-7b": 8_537_680_896, "minitron-8b": 7_734_562_816}
BIG_TOKENS, BIG_BATCH, BIG_STEPS = 64, 8, 8
# teacher forcing: with float32 activations (on the same bf16 params)
# decode and prefill logits agree within TF_TOL32 of the largest logit (a
# wrong position, slot or mask moves them by O(1); bf16 activations alone
# move them by ~3e-2 of it on the card); as served, in bf16, the decode's
# logits are within BF16_RATIO times the prefill's own distance of the
# float32 prefill's (each side rounds to bf16 after every op, in its own
# order of summation)
TF_TOL32 = 1e-3
BF16_RATIO = 2.0
SERVE_ARGS = ["--arch", SERVE_ARCH]


def serving_model(name: str, seed: int):
    """``name`` at full width under the reference's ``serving_config``
    (``launch/specs.py``: bf16 params), its params drawn on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config(name), param_dtype="bfloat16")
    model = build_model(cfg)
    return cfg, model, model.init(seed, DEVICE)


def tree_bytes(tree) -> int:
    from repro_torch.models.param import iter_leaves
    return sum(t.numel() * t.element_size() for _, t in iter_leaves(tree))


def matmul_weights(cfg, params: dict):
    """(elements, bytes) of the weights a token's matrix products read:
    the layers' and the unembedding's (the embedding table itself when
    tied; untied, a lookup reads one row a token)."""
    head = params["embed"]["embedding" if cfg.tie_embeddings else "lm_head"]
    n = head.numel() + sum(t.numel() for t in _stack_leaves(params))
    return n, tree_bytes(params["stack"]) + head.numel() * head.element_size()


def _stack_leaves(params: dict):
    from repro_torch.models.param import iter_leaves
    return [t for _, t in iter_leaves(params["stack"]) if t.ndim >= 3]


# stacked leaves with an init of their own, which ``condition`` keeps: the
# MoE router (std 0.02), Hymba's conv kernel (std 0.1) and A_log (log 1..N)
OWN_INIT = ("router", "conv_w", "a_log")


def condition(params: dict) -> None:
    """Rescale every stacked matrix in place from the stacked axis' fan-in
    to its per-layer fan-in, as the CPU tests do (ROADMAP Queue 3b: the
    reference init, which the port copies, draws them at the layer count's
    fan-in, and at full width gemma3's scores reach ~1.4e4, where one bf16
    ulp of q moves a score by more than the lead of the top key on some
    rows; Hymba's one-layer segments draw them at std 1): ``shape[1]``, an
    expert leaf (L, E, d_in, d_out) its ``shape[2]``; leaves with an init
    of their own keep it (``OWN_INIT``, ``tests/_model_families.py``).
    Unstacked trees (xLSTM's blocks, whisper's layers) are drawn at their
    per-layer fan-in already and are left as they are."""
    from repro_torch.models.param import iter_leaves
    for path, leaf in iter_leaves(params.get("stack", {})):
        if leaf.ndim >= 3 and path[-1] not in OWN_INIT:
            fan = leaf.shape[2] if "moe" in path and leaf.ndim == 4 else \
                leaf.shape[1]
            leaf.mul_(math.sqrt(leaf.shape[0] / fan))


def prefill_logits(model, params: dict, tokens: torch.Tensor,
                   audio=None):
    """Float32 copies of the logits of every position of ``tokens`` (B, S)
    by the full forward (``make_prefill_step``'s), in the model's
    activation dtype (whisper: over the frames ``audio``)."""
    batch = {"tokens": tokens}
    if audio is not None:
        batch["audio_embeds"] = audio
    with torch.no_grad():
        return model.forward(params, batch)[0].float()


def decode_logits(model, params: dict, tokens: torch.Tensor, audio=None):
    """The same by S decode steps from a fresh cache fed the tokens (its
    length counting Hymba's meta tokens before them; whisper's cross cache
    filled from ``audio``, ``fill_cross``)."""
    B, S = tokens.shape
    M = model.cfg.num_meta_tokens
    cache = model.init_cache(B, M + S, dtype=model.cfg.dtype, device=DEVICE)
    if audio is not None:
        fill_cross(model, params, cache, audio)
    dec = None
    with torch.no_grad():
        for i in range(S):
            lg, cache = model.decode_step(params, cache, tokens[:, i:i + 1],
                                          M + i + 1)
            if dec is None:
                dec = torch.empty((B, S, lg.shape[-1]), dtype=torch.float32,
                                  device=lg.device)
            dec[:, i] = lg[:, 0].float()
    return dec


def teacher_forcing(cfg, params: dict, tokens: torch.Tensor,
                    served_only: bool = False, audio=None) -> dict:
    """Decode against prefill over ``tokens`` (whisper: over the frames
    ``audio``, its cross cache filled from them): as served (bf16
    activations) and, unless ``served_only``, with float32 activations on
    the same bf16 params (``tf_summary``)."""
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    pre = prefill_logits(model, params, tokens, audio)
    dec = decode_logits(model, params, tokens, audio)
    out = dict(rows=tokens.numel(), served=max_abs_err(dec, pre),
               max_logit=float(pre.abs().max()),
               tokens_agree=int((dec.argmax(-1) == pre.argmax(-1)).sum()),
               finite=bool(torch.isfinite(pre).all() and
                           torch.isfinite(dec).all()))
    if served_only:
        out["greedy"] = dec.argmax(-1)
        return out
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    return tf_summary(pre, dec, prefill_logits(model, params, tokens, audio),
                      decode_logits(model, params, tokens, audio))


def tf_summary(pre, dec, pre32, dec32) -> dict:
    """Teacher forcing's statistics from the logits of bf16 prefill and
    decode and of float32 prefill and decode (B, S, V): their distances,
    the largest float32 logit, and the decided rows (the float32 prefill's
    top-2 margin at least twice the larger bf16 error, so that no such
    error can flip their greedy token) with those on which both bf16
    sides' greedy tokens equal the float32 prefill's."""
    out = dict(rows=pre.shape[0] * pre.shape[1], served=max_abs_err(dec, pre),
               tokens_agree=int((dec.argmax(-1) == pre.argmax(-1)).sum()),
               f32=max_abs_err(dec32, pre32), max_logit=float(
                   pre32.abs().max()), dec_vs_f32=max_abs_err(dec, pre32),
               pre_vs_f32=max_abs_err(pre, pre32),
               finite=all(bool(torch.isfinite(t).all())
                          for t in (pre, dec, pre32, dec32)))
    top2 = pre32.topk(2, dim=-1).values
    decided = top2[..., 0] - top2[..., 1] >= \
        2 * max(out["dec_vs_f32"], out["pre_vs_f32"])
    want = pre32.argmax(-1)[decided]
    out.update(decided=int(decided.sum()), decided_agree=int(
        ((dec.argmax(-1)[decided] == want) &
         (pre.argmax(-1)[decided] == want)).sum()))
    return out


def check_teacher_forcing(name: str, tf: dict) -> None:
    """The float32 decode within TF_TOL32 of the float32 prefill (of the
    largest logit); the served bf16 decode within BF16_RATIO times the
    bf16 prefill's distance of the float32 prefill; both bf16 sides'
    greedy tokens equal the float32 prefill's on decided rows."""
    log(f"[serve] {name} teacher forcing over {tf['rows']} positions: "
        f"float32 activations: max |decode - prefill| {tf['f32']:.3e} "
        f"({tf['f32'] / tf['max_logit']:.2e} of max |logit| "
        f"{tf['max_logit']:.4f}); bf16 (served): decode {tf['dec_vs_f32']:.5f}"
        f" and prefill {tf['pre_vs_f32']:.5f} from the float32 prefill, "
        f"{tf['served']:.5f} apart; greedy tokens: bf16 decode = bf16 "
        f"prefill on {tf['tokens_agree']} rows, both = float32 on "
        f"{tf['decided_agree']} of {tf['decided']} decided rows")
    check(tf["finite"], f"{name}: non-finite logits")
    check(tf["f32"] <= TF_TOL32 * tf["max_logit"],
          f"{name}: float32 decode and prefill logits differ by {tf['f32']}")
    check(tf["dec_vs_f32"] <= BF16_RATIO * tf["pre_vs_f32"],
          f"{name}: bf16 decode is {tf['dec_vs_f32']} from the float32 "
          f"logits, bf16 prefill {tf['pre_vs_f32']}")
    check(tf["decided_agree"] == tf["decided"],
          f"{name}: greedy tokens differ on decided rows")
    if not tf["decided"]:
        log(f"[serve] {name}: no decided rows: the greedy-token check only "
            f"reports")


def decode_attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: int, window: int, scale: float,
                         groups: int, sink_len: int = 0) -> torch.Tensor:
    """One-token attention against a (B, S, KV, D) cache in float64: the
    ``window`` positions ending at ``cache_len`` (every position below it
    without a window) and the first ``sink_len`` positions before them,
    query head h on kv head h // groups."""
    B, _, KV, D = k.shape
    lo = max(cache_len - window, 0) if window else 0
    k, v = (torch.cat([t[:, :min(sink_len, lo)], t[:, lo:cache_len]],
                      dim=1).double() for t in (k, v))
    qg = q.double().view(B, 1, KV, groups, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k) * scale
    o = torch.einsum("bkgqt,btkd->bqkgd", torch.softmax(s, dim=-1), v)
    return o.reshape(B, 1, KV * groups, D)


def layer_windows(cfg):
    """Each layer's window (0: a full layer), in stack order."""
    from repro_torch.models.transformer import _window, layer_kind_list
    return [_window(cfg, kind) for kind in layer_kind_list(cfg)]


def decode_bound(cfg, params: dict, B: int, S: int):
    """Least time of one decode step at cache length S: every weight and
    every cache position a layer attends to read once (a local layer reads
    its window), the new k/v and the logits written once; operations: the
    weights' multiply-adds at the bf16 tensor peak, the attention's in
    float32 at the SIMT peak."""
    kv = cfg.num_kv_heads * cfg.head_dim * 2             # bf16 k and v a token
    seen = [min(w, S) if w else S for w in layer_windows(cfg)]
    n_mm, w_bytes = matmul_weights(cfg, params)
    nbytes = (w_bytes + B * sum(seen) * 2 * kv
              + cfg.num_layers * B * 2 * kv + B * cfg.padded_vocab * 2)
    mm = 2.0 * B * n_mm
    attn = 4.0 * B * cfg.num_heads * cfg.head_dim * sum(seen)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mm / BF16_TENSOR_OPS_PER_S + attn / SIMPLE_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def prefill_bound(cfg, params: dict, B: int, S: int):
    """Least time of the prefill step: the matrices' multiply-adds over
    every token (the unembedding over the last one only) at the bf16 tensor
    peak, and the attention's over the (query, key) pairs its masks keep
    in float32 at the SIMT peak; bytes: weights, tokens, logits once."""
    n_mm, w_bytes = matmul_weights(cfg, params)
    emb = cfg.padded_vocab * cfg.d_model
    mm = 2.0 * B * S * (n_mm - emb) + 2.0 * B * emb
    attn = 0.0
    for w in layer_windows(cfg):
        pairs = S * (S + 1) // 2 if not w or w >= S else \
            (w + 1) * S - w * (w + 1) // 2
        attn += 4.0 * B * cfg.num_heads * cfg.head_dim * pairs
    t_ops = (mm / BF16_TENSOR_OPS_PER_S + attn / SIMPLE_OPS_PER_S) * 1e3
    t_bytes = (w_bytes + B * S * 4 + B * cfg.padded_vocab * 2) \
        / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), mm + attn


def fill_cache(cache: dict, seed: int) -> None:
    """Every cache leaf filled in place with normal values from the seed."""
    from repro_torch.models.param import iter_leaves
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    for _, leaf in iter_leaves(cache):
        leaf.normal_(generator=gen)


def layer_cache(cfg, cache: dict, layer: int) -> dict:
    from repro_torch.models.transformer import _layer_slice, segments
    first = 0
    for i, (kind, n) in enumerate(segments(cfg)):
        if first <= layer < first + n:
            return _layer_slice(cache[f"seg{i}_{kind}"], layer - first)
        first += n
    raise IndexError(layer)


def decode_cell(cfg, model, params: dict, name: str, S: int, B: int,
                seed: int) -> dict:
    """One serve step against a full cache of length S from the seed: its
    time beside its bound, a profile, and ``decode_attention`` of one
    global and one local layer against float64."""
    from repro_torch.models.attention import decode_attention
    from repro_torch.train.train_step import make_serve_step
    serve = make_serve_step(model)
    cache = model.init_cache(B, S, device=DEVICE)
    fill_cache(cache, seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    nxt, _ = serve(params, cache, tok, S)
    check(nxt.shape == (B,) and bool(((0 <= nxt) &
                                      (nxt < cfg.padded_vocab)).all()),
          f"{name}: greedy tokens out of range")
    step_ms = host_ms(lambda: serve(params, cache, tok, S), 3)
    prof = profile_call(f"serve step {name} (B {B}, cache {S})",
                        lambda: serve(params, cache, tok, S))
    bound, by, nbytes = decode_bound(cfg, params, B, S)
    errs = {}
    G = cfg.num_heads // cfg.num_kv_heads
    scale = 1.0 / math.sqrt(cfg.head_dim)
    windows = layer_windows(cfg)
    for kind, layer in (("global", windows.index(0)),
                        ("local", windows.index(cfg.window_size))):
        c = layer_cache(cfg, cache, layer)
        q = torch.randn((B, 1, cfg.num_heads, cfg.head_dim), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        got = decode_attention(q, c["k"], c["v"], S, window=windows[layer],
                               scale=scale, groups=G)
        want = decode_attention_f64(q, c["k"], c["v"], S, windows[layer],
                                    scale, G)
        errs[kind] = max_abs_err(got, want)
        check(errs[kind] <= ATTN_TOL[torch.bfloat16],
              f"{name}: decode_attention of layer {layer} ({kind}) is "
              f"{errs[kind]} from float64")
    cache_gib = tree_bytes(cache) / 2 ** 30
    del cache
    log(f"[serve] {name}: B {B}, cache {S} ({cache_gib:.2f} GiB bf16); "
        f"step {step_ms:.3f} ms (host clock, best of 3), device busy "
        f"{prof['busy_ms']:.3f} ms; bound {bound:.4f} ms ({by}, "
        f"{nbytes / 1e9:.3f} GB), {bound / prof['busy_ms']:.3f} of it busy; "
        f"decode_attention vs float64: global {errs['global']:.2e}, local "
        f"{errs['local']:.2e}")
    return dict(batch=B, cache_len=S, cache_gib=cache_gib, step_ms=step_ms,
                busy_ms=prof["busy_ms"], idle=prof["idle"],
                launches=prof["launches"], syncs=prof["syncs"],
                bound_ms=bound, bound_by=by, bound_bytes=nbytes,
                attn_err=errs, tokens_per_s=B / step_ms * 1e3)


def blocked_vs_masked(seed: int) -> dict:
    """The blocked prefill forms against ``masked_attention`` on the card
    at S 2048, gemma3's heads, unit-normal bf16 q/k/v, on every element."""
    from repro_torch.models.attention import (masked_attention,
                                              online_softmax_attention,
                                              windowed_attention)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)
    q, k, v = (torch.randn((2, BLOCKED_SEQ, 4, 256), generator=gen,
                           device=DEVICE).to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / 16
    err = {"online_softmax": max_abs_err(
        online_softmax_attention(q, k, v, causal=True, scale=scale),
        masked_attention(q, k, v, window=0, scale=scale)),
        "windowed": max_abs_err(
        windowed_attention(q, k, v, window=512, scale=scale),
        masked_attention(q, k, v, window=512, scale=scale))}
    for name, e in err.items():
        check(e <= ATTN_TOL[torch.bfloat16],
              f"{name} differs from masked_attention by {e}")
    log(f"[serve] blocked forms vs masked_attention at S {BLOCKED_SEQ} "
        f"(B 2, H 4, D 256, bf16): online softmax {err['online_softmax']}, "
        f"windowed (512) {err['windowed']}")
    return err


def prefill_cell(cfg, model, params: dict, seed: int) -> dict:
    from repro_torch.train.train_step import make_prefill_step
    name, S, B = PREFILL_CELL
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=DEVICE,
                                     dtype=torch.int32)}
    prefill = make_prefill_step(model)
    last = prefill(params, batch)
    check(last.shape == (B, cfg.padded_vocab) and
          bool(torch.isfinite(last).all()),
          f"{name}: last logits {tuple(last.shape)} not finite")
    ms = host_ms(lambda: prefill(params, batch), 1)
    bound, by, flops = prefill_bound(cfg, params, B, S)
    log(f"[serve] {name}: B {B} x {S} tokens, finite last logits; "
        f"{ms:.1f} ms (host clock, the second call), "
        f"{B * S / ms * 1e3:.0f} "
        f"tokens/s; bound {bound:.3f} ms ({by}: {flops / 1e12:.2f} TFLOP, "
        f"matrices at the bf16 tensor peak, attention in float32 at the "
        f"SIMT peak), {bound / ms:.3f} of it")
    return dict(batch=B, seq=S, ms=ms, bound_ms=bound, bound_by=by,
                flops=flops, tokens_per_s=B * S / ms * 1e3)


def greedy_generation(cfg, model, params: dict, seed: int, bound=None,
                      meta: int = 0, prepare=None):
    """SERVE_PROMPT prompt tokens from the seed fed through the serve step,
    then SERVE_GEN greedy tokens; the step's time and profile beside
    ``bound(B, cache length, step)`` (default: ``decode_bound``, every
    weight read).  ``meta``: the positions before the tokens that the cache
    length counts (Hymba's meta tokens); ``prepare(cache)`` fills the fresh
    cache first (whisper's cross k and v)."""
    from repro_torch.train.train_step import make_serve_step
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    serve = make_serve_step(model)
    cache = model.init_cache(B, meta + P + G, device=DEVICE)
    if prepare is not None:
        prepare(cache)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 4)
    prompt = torch.randint(1, cfg.vocab_size, (B, P), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    tok, out = prompt[:, :1], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(P + G - 1):
        nxt, cache = serve(params, cache, tok, meta + i + 1)
        if i + 1 < P:
            tok = prompt[:, i + 1:i + 2]
        else:
            tok = nxt[:, None]
            out.append(nxt)
    tokens = torch.cat([prompt, torch.stack(out, 1)], dim=1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    L = meta + P + G

    def step():
        return serve(params, cache, tok, L)
    step_ms = host_ms(step, 5)
    prof = profile_call(f"serve step {cfg.name} (B {B}, cache {L})", step)
    if bound is None:
        bound, by, _ = decode_bound(cfg, params, B, L)
    else:
        bound, by, _ = bound(B, L, step)
    log(f"[serve] {cfg.name} greedy: {P} prompt + {G} tokens x batch {B} "
        f"in {wall:.1f} ms ({B * G / wall * 1e3:.1f} generated tokens/s); "
        f"one step {step_ms:.3f} ms (best of 5), {B / step_ms * 1e3:.1f} "
        f"tokens/s, bound {bound:.4f} ms ({by})")
    return tokens, dict(wall_ms=wall, step_ms=step_ms,
                        tokens_per_s=B / step_ms * 1e3,
                        busy_ms=prof["busy_ms"],
                        idle=prof["idle"], launches=prof["launches"],
                        syncs=prof["syncs"], htod=prof["htod"],
                        dtoh=prof["dtoh"], bound_ms=bound, bound_by=by)


def big_model(name: str, n_params: int, seed: int) -> dict:
    """A dense config at full width: teacher forcing over 1 x BIG_TOKENS
    tokens, then BIG_STEPS decode steps at batch BIG_BATCH."""
    from repro_torch.train.train_step import make_serve_step
    cfg, model, params = serving_model(name, seed)
    n = model.param_count()
    check(n == n_params, f"{name} has {n} params")
    condition(params)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 6)
    tokens = torch.randint(0, cfg.vocab_size, (1, BIG_TOKENS), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    tf = teacher_forcing(cfg, params, tokens)
    check_teacher_forcing(name, tf)
    serve = make_serve_step(model)
    cache = model.init_cache(BIG_BATCH, BIG_STEPS, device=DEVICE)
    tok = tokens[:, :1].expand(BIG_BATCH, 1).contiguous()
    steps = []
    for i in range(BIG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, cache = serve(params, cache, tok, i + 1)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        tok = nxt[:, None]
    prof = profile_call(f"serve step {name} (B {BIG_BATCH}, cache "
                        f"{BIG_STEPS})",
                        lambda: serve(params, cache, tok, BIG_STEPS))
    bound, by, nbytes = decode_bound(cfg, params, BIG_BATCH, BIG_STEPS)
    out = dict(params=n, param_gb=tree_bytes(params) / 1e9, tf=tf,
               steps_ms=steps, step_ms=median(steps[1:]), bound_ms=bound,
               bound_by=by, busy_ms=prof["busy_ms"], idle=prof["idle"],
               launches=prof["launches"], syncs=prof["syncs"])
    log(f"[serve] {name}: {n:,} params ({out['param_gb']:.2f} GB bf16), "
        f"{BIG_STEPS} decode steps at B {BIG_BATCH}: median "
        f"{out['step_ms']:.3f} ms after the first ({steps[0]:.1f} ms), "
        f"bound {bound:.4f} ms ({by}, {nbytes / 1e9:.2f} GB), "
        f"{bound / out['step_ms']:.3f} of it")
    return out


def run_serve_entry_points() -> dict:
    """``repro_torch.launch.serve.main`` and the ``serve_lm`` example on
    the card (their default device), in this process: their two lines in
    the reference's format and the token arrays they return."""
    import contextlib
    import io

    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    argv = [] if DEVICE == "cuda" else ["--device", DEVICE]
    out = {}
    for name, main, args, shape, first, second in (
            ("launch.serve", serve.main, SERVE_ARGS + argv, (4, 32),
             "[serve] generated (4, 32) in ",
             lambda g: f"[serve] sample: {g[0][:16].tolist()}"),
            ("serve_lm", serve_lm.main, argv, (4, 24),
             f"[serve] {SERVE_ARCH}: generated 24 tokens × batch 4 in ",
             lambda g: f"[serve] first sequence: {g[0].tolist()}")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            gen = main(args)
        ms = (time.perf_counter() - t0) * 1e3
        lines = buf.getvalue().splitlines()
        check(gen.shape == shape and len(lines) == 2 and
              lines[0].startswith(first) and lines[1] == second(gen),
              f"{name} printed {lines} for tokens of shape {gen.shape}")
        for line in lines:
            log(f"[serve] {name} on the card: {line}")
        out[name] = ms
    return out


def phase_serve(seed: int, counters) -> dict:
    """Phase j (module docstring).  ``counters``: every kernel wrapper's
    launch count, none of which the serving path may move (the reference's
    serve path reaches no Pallas kernel, the port's none of its kernels)."""
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    before = {c.name: c.launches for c in counters}
    peaks = {}

    def part_done(name: str) -> None:
        """The part's peak device memory; the next part starts clean."""
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    out = {}
    cfg, model, params = serving_model(SERVE_ARCH, seed)
    log(f"[serve] {SERVE_ARCH}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {model.param_count():,} params "
        f"({tree_bytes(params) / 1e9:.3f} GB: bf16 params, {cfg.dtype} "
        f"activations)")
    check(SERVE_PROMPT + SERVE_GEN <= cfg.window_size,
          "teacher forcing beyond the window would meet the reference's "
          "decode/prefill window mismatch (ROADMAP Queue 3b)")
    tokens, out["greedy"] = greedy_generation(cfg, model, params, seed)
    tf = out["tf_reference_init"] = teacher_forcing(cfg, params, tokens,
                                                    served_only=True)
    # the serve step's greedy tokens are the argmax of the decode step's
    # logits: fed back, the same steps on the same shapes give them again
    check(torch.equal(tf.pop("greedy")[:, SERVE_PROMPT - 1:-1].int(),
                      tokens[:, SERVE_PROMPT:]),
          "teacher-forced decode does not reproduce the greedy tokens")
    log(f"[serve] {SERVE_ARCH} at the reference init (reported, not "
        f"checked): bf16 max |decode - prefill| {tf['served']:.4f} of max "
        f"|logit| {tf['max_logit']:.4f}; greedy tokens agree on "
        f"{tf['tokens_agree']} of {tf['rows']} rows; the decode steps "
        f"reproduce the {SERVE_GEN} greedy tokens")
    condition(params)
    out["tf"] = teacher_forcing(cfg, params, tokens)
    check_teacher_forcing(SERVE_ARCH, out["tf"])
    out["blocked_err"] = blocked_vs_masked(seed)
    part_done(SERVE_ARCH)
    for name, (S, B) in DECODE_CELLS.items():
        out[name] = decode_cell(cfg, model, params, name, S, B, seed)
        part_done(name)
    out[PREFILL_CELL[0]] = prefill_cell(cfg, model, params, seed)
    del params, model
    part_done(PREFILL_CELL[0])
    for name, n_params in BIG_ARCHS.items():
        out[name] = big_model(name, n_params, seed)
        part_done(name)
    out["entry_points_ms"] = run_serve_entry_points()
    part_done("entry points")
    moved = {c.name: c.launches - before[c.name] for c in counters
             if c.launches != before[c.name]}
    check(not moved, f"kernels launched on the serving path: {moved}")
    out["peak_gib"] = peaks
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[serve] phase j: peak device memory by part (GiB) "
        f"{ {k: round(v, 2) for k, v in peaks.items()} }, wall "
        f"{out['wall_s']:.3f} s; no kernel of the port launched")
    return out


# ---------------------------------------------------------------------------
# (k) the MoE and VLM families: serving at full width, training with BB
# checkpoints
# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b (MLA, 64 experts top-6 + 2 shared, a dense first
# layer) and moonshot-v1-16b-a3b (GQA, the same experts) and qwen2-vl-2b
# (M-RoPE, qkv biases, patch embeddings) at full width under the reference's
# serving dtypes, their parameter trees' sizes as the reference's
# (tests/test_torch_families.py); deepseek's decode_32k with the MLA latent
# cache, B 128 cut to 32 (32.6 GB of cache beside 31.4 GB of weights), and
# its prefill at S 4096, B 1; moonshot (56.8 GB of weights) has no
# long-cache cell; qwen2-vl's prefill_32k, B 32 cut to 4 as phase j's
# gemma3-1b, with 1024 patch embeddings (a 32 x 32 grid); training: the
# launcher on qwen2-vl-2b at full width, then deepseek at full width cut to
# two layers (dense, moe), FAMILY_TRAIN_STEPS steps, a save and a restore
# through the deployment policy.
FAMILY_MOE = ("deepseek-v2-lite-16b", "moonshot-v1-16b-a3b")
FAMILY_VLM = "qwen2-vl-2b"
FAMILY_TREES = {"xlstm-125m": 155_651_408, "hymba-1.5b": 1_352_654_400,
                "whisper-base": 87_465_984,
                "deepseek-v2-lite-16b": 15_706_484_224,
                "moonshot-v1-16b-a3b": 28_386_592_768,
                "qwen2-vl-2b": 1_543_714_304}
MLA_DECODE = ("decode_32k", 32768, 32)
MLA_PREFILL = ("prefill_4k", 4096, 1)
MLA_CHECK_ROWS = 4             # batch rows of the float64 absorbed decode
MLA_TOL = 2e-2
VLM_PREFILL = ("prefill_32k", 32768, 4)
VLM_GRID = 32                  # 32 x 32 = 1024 patch embeddings
FAMILY_TRAIN_KINDS = ("dense", "moe")
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_STEPS = 4, 1024, 3
VLM_LAUNCH_ARGS = ["--full", "--arch", FAMILY_VLM]


class RouterProbe:
    """While on, records every call of the MoE router (``models/moe.py``'s
    ``_router``, wrapped): its ids (N, k) and float32 logits (N, E), left on
    the card.  Used on the runs that read routing only, never on the timed
    ones (it recomputes the logits)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.calls = moe, moe._router, []

    def __enter__(self):
        real = self.real

        def router(params, x, cfg):
            out = real(params, x, cfg)
            self.calls.append((out[0], (x @ params["router"].to(x.dtype))
                               .float()))
            return out
        self.moe._router = router
        return self

    def __exit__(self, *exc):
        self.moe._router = self.real

    def dropped(self, cfg) -> int:
        """Routed copies the ``dropping`` dispatch dropped over the calls
        (each call one capacity group, as that dispatch's)."""
        from repro_torch.models.moe import capacity, dropped_copies
        k, E = cfg.num_experts_per_tok, cfg.num_experts
        return sum(int(dropped_copies(ids.reshape(1, -1), E,
                                      capacity(ids.shape[0], k, E)))
                   for ids, _ in self.calls)

    def by_position(self, B: int, S: int, decode: bool):
        """The calls as (layers, B, S, k) sorted ids and (layers, B, S, E)
        logits: a prefill makes one call a MoE layer over B x S tokens, a
        decode one a layer a step over B."""
        ids = torch.stack([i for i, _ in self.calls])
        lg = torch.stack([g for _, g in self.calls])
        if decode:
            L = ids.shape[0] // S
            ids = ids.view(S, L, B, -1).permute(1, 2, 0, 3)
            lg = lg.view(S, L, B, -1).permute(1, 2, 0, 3)
        else:
            ids = ids.view(ids.shape[0], B, S, -1)
            lg = lg.view(lg.shape[0], B, S, -1)
        return ids.sort(dim=-1).values, lg


def routing_reach(runs: dict, base: str, B: int, S: int):
    """Positions (B, S) at or after the first token of their row whose
    top-k expert set differs, at any MoE layer, between any run and the
    ``base`` run (a flip moves its token's output by O(1), and attention
    carries it to the later tokens); and the flipped tokens' count."""
    want = runs[base][0]
    flipped = torch.zeros((B, S), dtype=torch.bool, device=want.device)
    for ids, _ in runs.values():
        flipped |= (ids != want).any(dim=-1).any(dim=0)
    first = torch.where(flipped, torch.arange(S, device=want.device),
                        S).amin(dim=1)
    reached = torch.arange(S, device=want.device)[None] >= first[:, None]
    return reached, int(flipped.sum())


def family_teacher_forcing(cfg, params: dict, tokens: torch.Tensor) -> dict:
    """Decode against prefill over ``tokens`` with the ``dense`` dispatch
    on both sides (no capacity drops), served (bf16 activations) and with
    float32 activations on the same bf16 params: phase j's statistics over
    every position.  A bf16 side routes some near-tied tokens to other
    experts than the float32 prefill does; that is part of its rounding,
    as it is of the bf16 prefill the gate measures it against.  Reported:
    the tokens whose top-k set differs, at any MoE layer, between any run
    and the float32 prefill; the positions before the first such token of
    their row; and the share of tokens whose routing is decided (the gap
    between their k-th and (k+1)-th router logit in the float32 prefill,
    at every MoE layer, above twice their largest bf16 router-logit
    difference)."""
    from repro_torch.models.registry import build_model
    B, S = tokens.shape
    runs, logits = {}, {}
    for dtype in ("bfloat16", "float32"):
        model = build_model(dataclasses.replace(cfg, dtype=dtype),
                            moe_impl="dense")
        for side, fn in (("pre", prefill_logits), ("dec", decode_logits)):
            with RouterProbe() as probe:
                logits[side, dtype] = fn(model, params, tokens)
            if cfg.is_moe:
                runs[side, dtype] = probe.by_position(B, S, side == "dec")
    flips, before_flips, decided = 0, B * S, 0.0
    if cfg.is_moe:
        reached, flips = routing_reach(runs, ("pre", "float32"), B, S)
        before_flips = int((~reached).sum())
        noise = (runs["pre", "bfloat16"][1] - runs["pre", "float32"][1]
                 ).abs().amax(dim=-1)
        top = runs["pre", "float32"][1].topk(cfg.num_experts_per_tok + 1,
                                             dim=-1).values
        decided = float(((top[..., -2] - top[..., -1]) > 2 * noise)
                        .all(dim=0).float().mean())

    def err(a, b):
        return max_abs_err(logits[a], logits[b])
    pre, dec = logits["pre", "bfloat16"], logits["dec", "bfloat16"]
    pre32 = logits["pre", "float32"]
    out = dict(rows=B * S, flipped_tokens=flips, before_flips=before_flips,
               routing_decided=decided,
               served=err(("dec", "bfloat16"), ("pre", "bfloat16")),
               f32=err(("dec", "float32"), ("pre", "float32")),
               dec_vs_f32=err(("dec", "bfloat16"), ("pre", "float32")),
               pre_vs_f32=err(("pre", "bfloat16"), ("pre", "float32")),
               max_logit=float(pre32.abs().max()),
               tokens_agree=int((dec.argmax(-1) == pre.argmax(-1)).sum()),
               finite=all(bool(torch.isfinite(t).all())
                          for t in logits.values()))
    top2 = pre32.topk(2, dim=-1).values
    rows = top2[..., 0] - top2[..., 1] >= \
        2 * max(out["dec_vs_f32"], out["pre_vs_f32"])
    want = pre32.argmax(-1)
    out.update(decided=int(rows.sum()), decided_agree=int(
        ((dec.argmax(-1) == want) & (pre.argmax(-1) == want) & rows).sum()))
    return out


def expert_leaf(path) -> bool:
    return "moe" in path and path[-1] in ("wi_gate", "wi_up", "wo")


def family_weights(cfg, params: dict):
    """(matrix elements a token's products read apart from the experts,
    their bytes, one expert's bytes): the stacked matrices but the expert
    leaves, and the unembedding."""
    from repro_torch.models.param import iter_leaves
    head = params["embed"]["embedding" if cfg.tie_embeddings else "lm_head"]
    n, nbytes = head.numel(), head.numel() * head.element_size()
    expert = 0
    for path, t in iter_leaves(params["stack"]):
        if expert_leaf(path):
            expert += t[0, 0].numel() * t.element_size()
        elif t.ndim >= 3:
            n += t.numel()
            nbytes += t.numel() * t.element_size()
    return n, nbytes, expert


def n_moe_layers(cfg) -> int:
    from repro_torch.models.transformer import layer_kind_list
    return sum(cfg.is_moe and k != "dense" for k in layer_kind_list(cfg))


def cache_bytes_a_token(cfg) -> int:
    """bf16 cache bytes a token a layer: MLA's latent and rope key, or k
    and v."""
    if cfg.use_mla:
        return 2 * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    return 2 * 2 * cfg.num_kv_heads * cfg.head_dim


def attention_flops_a_key(cfg) -> float:
    """Float32 operations a (query, key) pair costs a layer: q·k and p·v
    over the heads (MLA's absorbed decode: its latent width twice and its
    rope width; its prefill: the padded 192-wide heads)."""
    if cfg.use_mla:
        return 2.0 * cfg.num_heads * (
            2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    return 4.0 * cfg.num_heads * cfg.head_dim


def routed_experts(cfg, step) -> int:
    """Distinct (layer, expert) pairs one call of ``step`` routes to."""
    with RouterProbe() as probe:
        step()
    return sum(int(ids.unique().numel()) for ids, _ in probe.calls)


def family_decode_bound(cfg, params: dict, B: int, S: int, experts: int):
    """Least time of one decode step at cache length S: the weights read
    once (of the experts, the ``experts`` pairs the step routes to), every
    cache position of every layer read once and the new ones written, the
    logits written; operations: the products' multiply-adds (k experts a
    token a MoE layer) at the bf16 tensor peak and the attention's in
    float32 at the SIMT peak."""
    n, w_bytes, one_expert = family_weights(cfg, params)
    L = cfg.num_layers
    nbytes = (w_bytes + experts * one_expert
              + B * L * (S + 1) * cache_bytes_a_token(cfg)
              + B * cfg.padded_vocab * 2)
    mm = 2.0 * B * (n + n_moe_layers(cfg) * cfg.num_experts_per_tok *
                    one_expert / 2)
    attn = B * L * S * attention_flops_a_key(cfg)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mm / BF16_TENSOR_OPS_PER_S + attn / SIMPLE_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def family_prefill_bound(cfg, params: dict, B: int, S: int):
    """Least time of a prefill: the products' multiply-adds over every
    token (k experts a token a MoE layer; the unembedding over the last
    token only) at the bf16 tensor peak, the causal attention's pairs in
    float32 at the SIMT peak (MLA's prefill at its 192-wide heads, q·k and
    the padded p·v); bytes: weights, tokens and logits once."""
    n, w_bytes, one_expert = family_weights(cfg, params)
    head = cfg.padded_vocab * cfg.d_model
    per_token = n - head + n_moe_layers(cfg) * cfg.num_experts_per_tok * \
        one_expert / 2
    mm = 2.0 * B * S * per_token + 2.0 * B * head
    width = (4.0 * cfg.num_heads * (cfg.qk_nope_head_dim +
                                    cfg.qk_rope_head_dim)
             if cfg.use_mla else 4.0 * cfg.num_heads * cfg.head_dim)
    attn = B * cfg.num_layers * width * S * (S + 1) / 2
    t_ops = (mm / BF16_TENSOR_OPS_PER_S + attn / SIMPLE_OPS_PER_S) * 1e3
    t_bytes = (w_bytes + n_moe_layers(cfg) * cfg.num_experts * one_expert
               + B * S * 4 + B * cfg.padded_vocab * 2) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), mm + attn


def family_model(name: str, seed: int):
    """``serving_model`` with the parameter tree's size checked."""
    cfg, model, params = serving_model(name, seed)
    n = model.param_count()
    check(n == FAMILY_TREES[name], f"{name} has {n} params")
    log(f"[family] {name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {n:,} params ({tree_bytes(params) / 1e9:.3f}"
        f" GB bf16); {'MLA, ' if cfg.use_mla else ''}"
        f"{'M-RoPE, ' if cfg.mrope else ''}"
        + (f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} + "
           f"{cfg.num_shared_experts} shared, {n_moe_layers(cfg)} MoE layers"
           if cfg.is_moe else f"{cfg.num_heads} heads, kv {cfg.num_kv_heads}"))
    return cfg, model, params


def family_serving(name: str, seed: int):
    """Greedy B 4 x (16 + 32) tokens under the default ``dropping``
    dispatch beside the bound of the experts a step routes to; at the
    reference init (reported): the decode steps reproduce the greedy
    tokens, the ``dropping`` prefill of those tokens, its dropped copies
    and its distance from decode; at the per-layer fan-in (checked):
    ``family_teacher_forcing``."""
    cfg, model, params = family_model(name, seed)
    out = {"params": model.param_count(),
           "param_gb": tree_bytes(params) / 1e9}
    experts = {}

    def bound(B, S, step):
        experts["n"] = routed_experts(cfg, step) if cfg.is_moe else 0
        return family_decode_bound(cfg, params, B, S, experts["n"])

    tokens, out["greedy"] = greedy_generation(cfg, model, params, seed,
                                              bound=bound)
    out["greedy"]["experts_read"] = experts["n"]
    with RouterProbe() as probe:
        pre = prefill_logits(model, params, tokens)
    dec = decode_logits(model, params, tokens)
    check(torch.equal(dec.argmax(-1)[:, SERVE_PROMPT - 1:-1].int(),
                      tokens[:, SERVE_PROMPT:]),
          f"{name}: teacher-forced decode does not reproduce the greedy "
          f"tokens")
    dropped = probe.dropped(cfg) if cfg.is_moe else 0
    out["tf_reference_init"] = dict(
        prefill_dropped=dropped, copies=tokens.numel() *
        cfg.num_experts_per_tok * n_moe_layers(cfg) if cfg.is_moe else 0,
        served=max_abs_err(dec, pre), max_logit=float(pre.abs().max()),
        tokens_agree=int((dec.argmax(-1) == pre.argmax(-1)).sum()),
        rows=tokens.numel())
    r = out["tf_reference_init"]
    log(f"[family] {name} at the reference init (reported, not checked): "
        f"the decode steps reproduce the {SERVE_GEN} greedy tokens; the "
        f"default 'dropping' prefill of those {tokens.numel()} tokens drops "
        f"{dropped} of {r['copies']} routed copies (decode, {SERVE_BATCH} "
        f"tokens a step, drops none); its max |decode - prefill| "
        f"{r['served']:.4f} of max |logit| {r['max_logit']:.4f}, greedy "
        f"tokens agree on {r['tokens_agree']} of {r['rows']} rows")
    del pre, dec
    condition(params)
    tf = out["tf"] = family_teacher_forcing(cfg, params, tokens)
    if cfg.is_moe:
        log(f"[family] {name} teacher forcing, 'dense' dispatch both sides:"
            f" {tf['flipped_tokens']} of {tf['rows']} tokens routed to "
            f"another expert set by a run than by the float32 prefill at "
            f"some MoE layer ({tf['before_flips']} positions before the "
            f"first such token of their row); routing decided at every "
            f"layer on {tf['routing_decided']:.3f} of tokens")
    check_teacher_forcing(name, tf)
    return cfg, model, params, out


def mla_latent_f64(q_lat, q_pe, c_kv, k_pe, L: int, scale: float):
    """``mla_latent_attention`` in float64 over positions below L."""
    ckv, kpe = c_kv[:, :L].double(), k_pe[:, :L].double()
    s = (torch.einsum("bshr,btr->bhst", q_lat.double(), ckv) +
         torch.einsum("bshk,btk->bhst", q_pe.double(), kpe)) * scale
    return torch.einsum("bhst,btr->bshr", torch.softmax(s, dim=-1), ckv)


def mla_decode_f64(cfg, p: dict, x, pos, c: dict, L: int):
    """One MLA layer's absorbed decode of x (B, 1, d) in float64 from the
    cache as written (RoPE in float32, as the port's)."""
    from repro_torch.models.layers import apply_rope
    B, d = x.shape[0], cfg.d_model
    H, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    q = (x.double() @ p["wq"].double().reshape(d, -1)).view(B, 1, H, dn + dr)
    q_pe = apply_rope(q[..., dn:], pos, cfg.rope_theta)
    q_lat = torch.einsum("bshk,rhk->bshr", q[..., :dn], p["w_uk"].double())
    o_lat = mla_latent_f64(q_lat, q_pe, c["c_kv"], c["k_pe"], L,
                           1.0 / math.sqrt(dn + dr))
    o = torch.einsum("bshr,rhk->bshk", o_lat, p["w_uv"].double())
    return o.reshape(B, 1, H * dv) @ p["wo"].double().reshape(H * dv, d)


def mla_decode_cell(cfg, model, params: dict, seed: int) -> dict:
    """decode_32k with the latent cache filled from the seed: one serve
    step's time, profile and bound; MLA layer 1's absorbed decode against
    float64 on MLA_CHECK_ROWS rows: its ``o_lat`` and its output."""
    from repro_torch.models.attention import (apply_mla,
                                              mla_latent_attention,
                                              mla_project)
    from repro_torch.train.train_step import make_serve_step
    name, S, B = MLA_DECODE
    serve = make_serve_step(model)
    cache = model.init_cache(B, S, device=DEVICE)
    fill_cache(cache, seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    nxt, _ = serve(params, cache, tok, S)
    check(nxt.shape == (B,) and bool(((0 <= nxt) &
                                      (nxt < cfg.padded_vocab)).all()),
          f"{name}: greedy tokens out of range")
    step_ms = host_ms(lambda: serve(params, cache, tok, S), 3)
    prof = profile_call(f"serve step {cfg.name} {name} (B {B}, cache {S})",
                        lambda: serve(params, cache, tok, S))
    experts = routed_experts(cfg, lambda: serve(params, cache, tok, S))
    bound, by, nbytes = family_decode_bound(cfg, params, B, S, experts)
    n = MLA_CHECK_ROWS
    p = layer_cache(cfg, params["stack"], 1)["attn"]
    c = layer_cache(cfg, cache, 1)
    c = {k: v[:n] for k, v in c.items()}
    x = torch.randn((n, 1, cfg.d_model), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    pos = torch.full((n, 1), S - 1, dtype=torch.int32, device=DEVICE)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_nope, q_pe, _, _ = mla_project(p, x, pos, cfg)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    o_lat = mla_latent_attention(q_lat, q_pe, c["c_kv"], c["k_pe"], S, scale)
    err = {"o_lat": max_abs_err(o_lat, mla_latent_f64(
        q_lat, q_pe, c["c_kv"], c["k_pe"], S, scale))}
    got = apply_mla(p, x, pos, cfg, cache=c, cache_len=S)
    want = mla_decode_f64(cfg, p, x, pos, c, S)
    err["out"] = max_abs_err(got, want) / float(want.abs().max())
    check(err["o_lat"] <= MLA_TOL and err["out"] <= MLA_TOL,
          f"{name}: absorbed decode against float64: {err}")
    cache_gb = tree_bytes(cache) / 1e9
    del cache
    log(f"[family] {cfg.name} {name}: B {B}, latent cache {S} "
        f"({cache_gb:.2f} GB bf16); step {step_ms:.3f} ms (host clock, best "
        f"of 3), device busy {prof['busy_ms']:.3f} ms; bound {bound:.4f} ms "
        f"({by}, {nbytes / 1e9:.3f} GB: {experts} routed experts read), "
        f"{bound / prof['busy_ms']:.3f} of it busy; absorbed decode vs "
        f"float64: o_lat {err['o_lat']:.2e}, layer output {err['out']:.2e} "
        f"of its largest")
    return dict(batch=B, cache_len=S, cache_gb=cache_gb, step_ms=step_ms,
                busy_ms=prof["busy_ms"], idle=prof["idle"],
                launches=prof["launches"], syncs=prof["syncs"],
                bound_ms=bound, bound_by=by, bound_bytes=nbytes,
                experts_read=experts, err=err, tokens_per_s=B / step_ms * 1e3)


def family_prefill(cfg, model, params: dict, seed: int, cell,
                   vlm: bool = False) -> dict:
    """``make_prefill_step`` at ``cell`` (name, S, B) from the seed: finite
    last logits, time (one call, after a probed one for a MoE) beside the
    operations bound (``recurrent_prefill_bound`` for the recurrent,
    hybrid and audio families); the VLM's batch with VLM_GRID² patch
    embeddings and their M-RoPE positions (temporal 0, the grid's rows and
    columns; text after them advancing on all three streams), whisper's
    with its frames, and the dropped copies of a MoE prefill."""
    from repro_torch.train.train_step import make_prefill_step
    name, S, B = cell
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 8)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=DEVICE,
                                     dtype=torch.int32)}
    if vlm:
        n = VLM_GRID ** 2
        i = torch.arange(n, device=DEVICE)
        text = VLM_GRID + torch.arange(S - n, device=DEVICE)
        pos = torch.stack([torch.cat([0 * i, text]),
                           torch.cat([i // VLM_GRID, text]),
                           torch.cat([i % VLM_GRID, text])]).int()
        batch["mrope_positions"] = pos[:, None].expand(3, B, S)
        batch["patch_embeds"] = (0.02 * torch.randn(
            (B, n, cfg.d_model), generator=gen, device=DEVICE)).to(
            torch.bfloat16)
    if cfg.family == "audio":
        batch["audio_embeds"] = frames(cfg, B, seed)
    prefill = make_prefill_step(model)
    dropped = 0
    if cfg.is_moe:
        with RouterProbe() as probe:
            prefill(params, batch)
        dropped = probe.dropped(cfg)
    box = {}
    ms = host_ms(lambda: box.update(last=prefill(params, batch)), 1)
    last = box.pop("last")
    check(last.shape == (B, cfg.padded_vocab) and
          bool(torch.isfinite(last).all()),
          f"{name}: last logits {tuple(last.shape)} not finite")
    bound_of = recurrent_prefill_bound if cfg.family in RECURRENT_FAMILIES \
        else family_prefill_bound
    bound, by, flops = bound_of(cfg, params, B, S)
    extra = f" ({VLM_GRID ** 2} patch embeddings, M-RoPE)" if vlm else \
        f" (+ {cfg.num_meta_tokens} meta tokens)" if cfg.num_meta_tokens \
        else f" over {cfg.encoder_seq} frames" if cfg.family == "audio" \
        else ""
    log(f"[family] {cfg.name} {name}: B {B} x {S} tokens{extra}, "
        f"finite last logits; {ms:.1f} ms (host clock, "
        f"{'the second call' if cfg.is_moe else 'one call'}), "
        f"{B * S / ms * 1e3:.0f} tokens/s; bound {bound:.3f} ms ({by}: "
        f"{flops / 1e12:.2f} TFLOP), {bound / ms:.3f} of it"
        + (f"; the 'dropping' dispatch dropped {dropped} routed copies"
           if cfg.is_moe else ""))
    return dict(batch=B, seq=S, ms=ms, bound_ms=bound, bound_by=by,
                flops=flops, tokens_per_s=B * S / ms * 1e3, dropped=dropped)


class HeldAgainstPlain:
    """While on, every call the checkpoint manager makes to its two
    kernels (``fletcher_segmented`` through ``leaf_checksums``,
    ``route_chunks_segmented`` through ``route_leaves``) is held against
    the kernel's plain version on the same inputs, bit for bit, as soon as
    it returns: the saves' and restores' own leaves, in their own layout.
    The plain versions launch no kernel, so the launch counts stay the
    path's.  ``calls`` and ``rows`` count what was held, by kernel;
    ``seconds`` is the checks' share of the wall time."""

    def __init__(self):
        from repro_torch.kernels.chunk_router import ops as route_ops
        from repro_torch.kernels.chunk_router.ref import (
            route_chunks_segmented_ref)
        from repro_torch.kernels.fletcher import ops as fletcher_ops
        from repro_torch.kernels.fletcher.ref import fletcher_segmented_ref
        self.sites = ((fletcher_ops, "fletcher_segmented",
                       fletcher_segmented_ref),
                      (route_ops.cuda, "route_chunks_segmented",
                       route_chunks_segmented_ref))
        self.real = {}
        self.calls = {name: 0 for _, name, _ in self.sites}
        self.rows = dict(self.calls)
        self.seconds = 0.0

    def __enter__(self):
        for module, name, plain in self.sites:
            self.real[name] = getattr(module, name)
            setattr(module, name, self._held(name, self.real[name], plain))
        return self

    def _held(self, name: str, kernel, plain):
        def call(*a, **k):
            got = kernel(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(torch.equal(got, plain(*a, **k)),
                  f"{name} differs from its plain version on a checkpoint's "
                  f"{got.shape[0]} rows")
            self.seconds += time.perf_counter() - t0
            self.calls[name] += 1
            self.rows[name] += got.shape[0]
            return got
        return call

    def __exit__(self, *exc):
        for module, name, _ in self.sites:
            setattr(module, name, self.real[name])

    def report(self) -> dict:
        return dict(calls=self.calls, rows=self.rows,
                    seconds=self.seconds)


def family_launcher(counters, args=VLM_LAUNCH_ARGS,
                    n_params: int = FAMILY_TREES[FAMILY_VLM]) -> dict:
    """``launch/train.py`` at full width (``launch_training`` with ``args``,
    a model of ``n_params``; by default qwen2-vl-2b: the pipeline's VLM
    batch, patch embeddings and M-RoPE positions, through the train step;
    one save of 18.5 GB, as the host's 96 GiB hold beside the earlier
    phases' stores; its checkpoint kernels ``HeldAgainstPlain``), then the
    freed host memory released for the training part's save."""
    with HeldAgainstPlain() as held:
        out = launch_training(counters, args, n_params, max_saves=1)
    out["held"] = held.report()
    check(all(held.calls.values()), f"launcher: held {held.calls}")
    log(f"[family] launcher's checkpoint kernels held against their plain "
        f"versions, bit for bit: {held.calls} calls over {held.rows} rows "
        f"({held.seconds * 1e3:.1f} ms of the wall time)")
    release_host_memory()
    out["mem_available_gib"] = mem_available_gib()
    log(f"[family] host MemAvailable {out['mem_available_gib']:.1f} GiB "
        f"once freed host memory is released after the launcher")
    return out


def family_training(seed: int, route_counter, checksum_counter,
                    per_leaf_counter, name: str = FAMILY_MOE[0],
                    kinds=FAMILY_TRAIN_KINDS) -> dict:
    """``name`` (deepseek-v2-lite-16b unless given) at full width cut to
    the layers ``kinds`` (deepseek's two: dense, moe): FAMILY_TRAIN_STEPS
    train steps (finite loss; a MoE's aux loss finite and above 0), one
    save of
    the state through ``CheckpointManager`` under the deployment policy
    (one routing and one checksum launch, as phases f and h), one restore
    (one routing launch, one checksum launch a group of leaves) equal to
    the saved state bit for bit; every one of those launches
    ``HeldAgainstPlain`` (its time taken out of the save's and the
    restore's)."""
    from repro_torch.checkpoint.manager import (VERIFY_GROUP_BYTES,
                                                CheckpointManager,
                                                flatten_state)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step
    cfg = dataclasses.replace(get_config(name), num_layers=len(kinds),
                              layer_kinds=kinds)
    model = build_model(cfg)
    n = model.param_count()
    params = model.init(seed, DEVICE)
    opt = AdamW(warmup_steps=1, total_steps=FAMILY_TRAIN_STEPS)
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    pipe = TokenPipeline(cfg, FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ, seed=seed)
    losses, aux, steps_ms = [], [], []
    for _ in range(FAMILY_TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in pipe.next_batch().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = step(params, opt_state, batch)
        losses.append(float(met["loss"]))
        aux.append(float(met.get("aux_loss", 0.0)))
        steps_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)) and all(np.isfinite(aux)) and
          (all(a > 0 for a in aux) or not cfg.is_moe),
          f"losses {losses}, aux losses {aux}")
    state = (params, opt_state, torch.tensor(pipe.cursor(), dtype=torch.int32,
                                             device=DEVICE))
    state_gb = tree_bytes({"p": params, "m": opt_state.mu,
                           "n": opt_state.nu}) / 1e9
    counters = (route_counter, checksum_counter, per_leaf_counter)
    with tempfile.TemporaryDirectory(prefix="family_ckpt_") as d, \
            HeldAgainstPlain() as held:
        ckpt = CheckpointManager(d, deployment_policy(), async_save=False)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(FAMILY_TRAIN_STEPS, state)
        save_ms = (time.perf_counter() - t0 - held.seconds) * 1e3
        saved = {c.name: c.launches for c in counters}
        held_save = held.seconds
        for c in counters:
            c.launches = 0
        like = (params, opt_state, torch.zeros(2, dtype=torch.int32,
                                               device=DEVICE))
        t0 = time.perf_counter()
        restored, got_step = ckpt.restore(FAMILY_TRAIN_STEPS, like)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0 - held.seconds +
                      held_save) * 1e3
        loaded = {c.name: c.launches for c in counters}
        del ckpt
    gc.collect()
    same = all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
        for (_, a), (_, b) in zip(flatten_state(restored),
                                  flatten_state(state)))
    check(got_step == FAMILY_TRAIN_STEPS and same,
          f"the restored {name} state differs from the saved one")
    groups = int(state_gb * 1e9) // VERIFY_GROUP_BYTES + 1
    check(saved[route_counter.name] == 1 and
          saved[checksum_counter.name] == 1 and
          loaded[route_counter.name] == 1 and
          1 <= loaded[checksum_counter.name] <= groups and
          saved[per_leaf_counter.name] == loaded[per_leaf_counter.name] == 0,
          f"launches: save {saved}, restore {loaded}")
    check(held.calls == {route_counter.name: saved[route_counter.name] +
                         loaded[route_counter.name],
                         checksum_counter.name:
                         saved[checksum_counter.name] +
                         loaded[checksum_counter.name]},
          f"held {held.calls} of the launches: save {saved}, restore "
          f"{loaded}")
    leaves = len(flatten_state(state))
    log(f"[family] {cfg.name} cut to {cfg.num_layers} layers "
        f"{kinds}: {n:,} params, {state_gb:.2f} GB of float32 "
        f"state; {FAMILY_TRAIN_STEPS} steps at {FAMILY_TRAIN_BATCH} x "
        f"{FAMILY_TRAIN_SEQ}: losses {['%.4f' % x for x in losses]}, aux "
        f"{['%.5f' % x for x in aux]}, {['%.1f' % x for x in steps_ms]} ms;"
        f" save {save_ms:.1f} ms, restore {restore_ms:.1f} ms ({leaves} "
        f"leaves, bit for bit); launches: save {saved}, restore {loaded}, "
        f"each held against its plain version, bit for bit ({held.rows} "
        f"rows, {held.seconds * 1e3:.1f} ms, not in the times); host "
        f"MemAvailable {mem_available_gib():.1f} GiB after")
    return dict(params=n, state_gb=state_gb, losses=losses, aux=aux,
                steps_ms=steps_ms, save_ms=save_ms, restore_ms=restore_ms,
                leaves=leaves, save_launches=saved, restore_launches=loaded,
                held=held.report())


def phase_families(seed: int, counters, route_counter, checksum_counter,
                   per_leaf_counter) -> dict:
    """Phase k (module docstring).  ``counters``: every kernel wrapper's
    launch count; the serving parts launch none of them, the training
    parts only the two checkpoint kernels (``route_counter``,
    ``checksum_counter``), whose launches are returned."""
    gc.collect()
    torch.cuda.empty_cache()
    held = mem_available_gib()
    release_host_memory()
    log(f"[family] host MemAvailable at the start of phase k {held:.1f} "
        f"GiB, {mem_available_gib():.1f} GiB once freed host memory is "
        f"released (PyTorch's cached page-locked blocks, malloc_trim)")
    t_phase = time.perf_counter()
    peaks, out = {}, {}

    def part_done(name: str) -> None:
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def moved(among, before):
        return {c.name: c.launches - before[c.name] for c in among
                if c.launches != before[c.name]}

    torch.cuda.reset_peak_memory_stats()
    before = {c.name: c.launches for c in counters}
    cfg, model, params, out[FAMILY_MOE[0]] = family_serving(FAMILY_MOE[0],
                                                            seed)
    out[FAMILY_MOE[0]][MLA_DECODE[0]] = mla_decode_cell(cfg, model, params,
                                                        seed)
    out[FAMILY_MOE[0]][MLA_PREFILL[0]] = family_prefill(cfg, model, params,
                                                        seed, MLA_PREFILL)
    del cfg, model, params
    part_done(FAMILY_MOE[0])
    out[FAMILY_MOE[1]] = family_serving(FAMILY_MOE[1], seed)[3]
    part_done(FAMILY_MOE[1])
    cfg, model, params, out[FAMILY_VLM] = family_serving(FAMILY_VLM, seed)
    out[FAMILY_VLM][VLM_PREFILL[0]] = family_prefill(cfg, model, params, seed,
                                                     VLM_PREFILL, vlm=True)
    del cfg, model, params
    part_done(FAMILY_VLM)
    check(not moved(counters, before), f"kernels launched on the serving "
                                       f"path: {moved(counters, before)}")
    # the launcher and the training part zero and read the two checkpoint
    # kernels' counts themselves; every other count must stay
    ckpt = (route_counter, checksum_counter)
    others = [c for c in counters if c not in ckpt]
    before = {c.name: c.launches for c in others}
    out["launcher"] = family_launcher((checksum_counter, route_counter))
    part_done("launcher")
    check(not moved(others, before), f"the launcher launched "
                                     f"{moved(others, before)}")
    out["training"] = family_training(seed, route_counter, checksum_counter,
                                      per_leaf_counter)
    part_done("training")
    tr = out["training"]
    launches = {c.name: out["launcher"]["launches"][c.name] +
                tr["save_launches"][c.name] + tr["restore_launches"][c.name]
                for c in ckpt}
    out["launches"] = launches
    out["peak_gib"] = peaks
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[family] phase k: peak device memory by part (GiB) "
        f"{ {k: round(v, 2) for k, v in peaks.items()} }, launches "
        f"{launches}, wall {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# (l) the recurrent, hybrid and audio families: serving at full width,
# training with BB checkpoints
# ---------------------------------------------------------------------------
# xlstm-125m (arXiv:2405.04517), hymba-1.5b (arXiv:2411.13676) and
# whisper-base (arXiv:2212.04356) at full width under the reference's
# serving dtypes, their parameter trees' sizes as the reference's
# (tests/test_torch_recurrent.py, tests/test_torch_encdec.py), depth never
# cut.  Cells: xLSTM's decode at decode_32k's batch (its state is O(1) in
# length: no cut) and a prefill at S 4096, B 4 (prefill_32k cut: its sLSTM
# is a per-token loop); Hymba's long_500k (cache 524,288 + 128 at B 1) and
# a prefill at S 4096 + 128, B 4 (prefill_32k cut: a (B, S, di, N) float32
# scan input is 13.5 GB at B 4 × 32,896 rows); whisper's prefill_32k, B 32
# cut to 4, over 1500 frames.  Training: the launcher on xlstm-125m at full
# width, the examples/train_lm twin (TRAIN_LM_EXPECTED) and hymba-1.5b at
# full width cut to 4 layers (HYMBA_TRAIN_KINDS: 32 layers' activations do
# not fit), each save and restore held against the kernels' plain versions.
RECURRENT = ("xlstm-125m", "hymba-1.5b", "whisper-base")
RECURRENT_FAMILIES = ("ssm", "hybrid", "audio")
XLSTM_WIDE = ("decode_32k", 128)
RECURRENT_PREFILL = ("prefill_4k", 4096, 4)
HYMBA_LONG = ("long_500k", 524288, 1)
WHISPER_PREFILL = ("prefill_32k", 32768, 4)
HYMBA_TRAIN_KINDS = ("global", "swa", "swa", "global")
XLSTM_LAUNCH_ARGS = ["--full", "--arch", RECURRENT[0]]
SSM_OPS = 6      # float32 operations a (row, channel, state) of a Mamba step


def frames(cfg, B: int, seed: int) -> torch.Tensor:
    """Seeded whisper frame embeddings (B, encoder_seq, d), the stand-in
    for the convolutional front end's output."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 20)
    return torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen,
                       device=DEVICE)


def fill_cross(model, params: dict, cache: dict, audio: torch.Tensor):
    """Whisper's cross k and v of every decoder layer from ``_xattn_kv`` of
    ``encode``'s output, written into ``cache`` in place (the reference
    zero-fills them and no serve path fills them, ROADMAP 3b)."""
    from repro_torch.models.encdec import _xattn_kv
    with torch.no_grad():
        enc = model.encode(params, audio)
        for i in range(model.cfg.num_layers):
            c = cache[f"layer{i}"]
            k, v = _xattn_kv(params["decoder"][f"layer{i}"]["xattn"], enc,
                             model.cfg)
            c["cross_k"].copy_(k)
            c["cross_v"].copy_(v)


def read_weights(cfg, params: dict):
    """(matrix elements, embedding elements, bytes) of the weights one
    decode step reads: every leaf but Hymba's meta tokens and whisper's
    encoder, its cross k/v projections (the cross cache holds their
    output) and all but one row of its learned positions."""
    from repro_torch.models.param import iter_leaves
    mm = emb = nbytes = 0
    for path, t in iter_leaves(params):
        if path[0] in ("meta_tokens", "encoder", "ln_enc") or (
                path[-1] in ("wk", "wv", "bv") and "xattn" in path):
            continue
        n = t.shape[-1] if path[0] == "pos_dec" else t.numel()
        nbytes += n * t.element_size()
        if path[0] == "embed":
            emb += n
        elif t.ndim >= 2 and path[0] != "pos_dec":
            mm += n
    return mm, emb, nbytes


def attended(cfg, L: int):
    """Each attention layer's positions a decode step at cache length L
    reads (a window layer: its window and the meta-token sinks before it;
    whisper: the self cache and the 1500 cross positions)."""
    if cfg.family == "hybrid":
        M = cfg.num_meta_tokens
        return [L if k == "global" else min(L, cfg.window_size + M)
                for k in cfg.layer_kinds]
    if cfg.family == "audio":
        return [L + cfg.encoder_seq] * cfg.num_layers
    return []


def recurrent_state_ops(cfg, B: int, rows: int) -> float:
    """Float32 operations of the recurrences over ``rows`` tokens a
    sequence: an mLSTM head's memory update and readout (5·Dh² a token), an
    sLSTM head's four recurrent products (8·Dh²), a Mamba channel's step
    (SSM_OPS a state)."""
    if cfg.family == "ssm":
        di = int(cfg.proj_factor * cfg.d_model)
        Dm, Ds = di // cfg.num_heads, cfg.d_model // cfg.num_heads
        return sum(B * rows * cfg.num_heads *
                   (8 * Ds * Ds if k == "slstm" else 5 * Dm * Dm)
                   for k in cfg.layer_kinds)
    if cfg.family == "hybrid":
        di = cfg.num_heads * cfg.head_dim
        return SSM_OPS * B * rows * di * cfg.ssm_state * cfg.num_layers
    return 0.0


def recurrent_decode_bound(cfg, params: dict, cache: dict, B: int, L: int):
    """Least time of one decode step at cache length L: the weights read
    (``read_weights``), the recurrent states read and written, each KV
    position attended read and one written, the logits written; operations:
    the weights' multiply-adds at the bf16 tensor peak, attention and the
    recurrences in float32 at the SIMT peak."""
    from repro_torch.models.param import iter_leaves
    mm, emb, w_bytes = read_weights(cfg, params)
    kv = cfg.num_kv_heads * cfg.head_dim * 2 * 2      # bf16 k and v a token
    seen = attended(cfg, L)
    state = sum(t.numel() * t.element_size() for p, t in iter_leaves(cache)
                if not {"attn", "self", "cross_k", "cross_v"} & set(p))
    nbytes = w_bytes + 2 * state + B * cfg.padded_vocab * 2 + \
        B * kv * (sum(seen) + len(seen))
    ops_mm = 2.0 * B * (mm + emb)
    ops_f32 = 4.0 * B * cfg.num_heads * cfg.head_dim * sum(seen) + \
        recurrent_state_ops(cfg, B, 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops_mm / BF16_TENSOR_OPS_PER_S + ops_f32 / SIMPLE_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def recurrent_prefill_bound(cfg, params: dict, B: int, S: int):
    """Least time of the prefill step over S tokens (Hymba: S + 128 rows;
    whisper: and the encoder over its 1500 frames): the matrices'
    multiply-adds over every row (the unembedding over the last token
    only) at the bf16 tensor peak; in float32 at the SIMT peak the
    attention's over the (query, key) pairs its masks keep and the
    recurrences (``recurrent_state_ops``); bytes: the weights, tokens and
    logits once."""
    from repro_torch.models.param import iter_leaves
    emb = cfg.padded_vocab * cfg.d_model
    HD = cfg.num_heads * cfg.head_dim
    rows = S + cfg.num_meta_tokens
    mm = 2.0 * B * emb
    attn = recurrent_state_ops(cfg, B, rows)
    for path, t in iter_leaves(params):
        if t.ndim < 2 or path[0] in ("embed", "pos_dec", "meta_tokens"):
            continue
        if path[0] == "encoder" or (path[-1] in ("wk", "wv") and
                                    "xattn" in path):
            mm += 2.0 * B * cfg.encoder_seq * t.numel()
        else:
            mm += 2.0 * B * rows * t.numel()
    if cfg.family == "ssm":        # mLSTM chunks: causal pairs, q·k and s·v
        di = int(cfg.proj_factor * cfg.d_model)
        L = 64
        attn += sum(4.0 * B * cfg.num_heads * (di // cfg.num_heads) *
                    (S // L) * L * (L + 1) // 2
                    for k in cfg.layer_kinds if k == "mlstm")
    elif cfg.family == "hybrid":
        W, M = cfg.window_size, cfg.num_meta_tokens
        for k in cfg.layer_kinds:
            pairs = rows * (rows + 1) // 2 if k == "global" else \
                (W + 1) * rows - W * (W + 1) // 2 + \
                M * max(rows - W - M, 0)
            attn += 4.0 * B * HD * pairs
    else:
        E = cfg.encoder_seq
        attn += 4.0 * B * HD * (cfg.encoder_layers * E * E + cfg.num_layers *
                                (S * (S + 1) // 2 + S * E))
    t_ops = (mm / BF16_TENSOR_OPS_PER_S + attn / SIMPLE_OPS_PER_S) * 1e3
    t_bytes = (tree_bytes(params) + B * S * 4 + B * cfg.padded_vocab * 2) \
        / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), mm + attn


def l_runs(cfg, params: dict, tokens: torch.Tensor, runs) -> dict:
    """``{(side, dtype): logits}`` for each (side, dtype) of ``runs``:
    side "pre" ``prefill_logits``, "dec" ``decode_logits``, each dtype's
    model built once."""
    from repro_torch.models.registry import build_model
    out, models = {}, {}
    for side, dtype in runs:
        if dtype not in models:
            models[dtype] = build_model(dataclasses.replace(cfg, dtype=dtype))
        fn = decode_logits if side == "dec" else prefill_logits
        out[side, dtype] = fn(models[dtype], params, tokens)
    return out


def zero_meta(params: dict) -> dict:
    """Hymba's parameters with the meta tokens zeroed (the other leaves
    shared)."""
    return dict(params, meta_tokens=torch.zeros_like(params["meta_tokens"]))


def hymba_reference_init(cfg, params: dict, tokens: torch.Tensor) -> dict:
    """Reported at the reference init, served (bf16): the decode steps'
    distance from the forward with zero meta tokens (the same function,
    ``hymba_teacher_forcing``) and from the forward with them (the
    reference's fault)."""
    lg = l_runs(cfg, params, tokens, [("dec", "bfloat16"),
                                      ("pre", "bfloat16")])
    zero = l_runs(cfg, zero_meta(params), tokens, [("pre", "bfloat16")])
    out = dict(rows=tokens.numel(), max_logit=float(
        lg["pre", "bfloat16"].abs().max()),
        vs_zero_meta=max_abs_err(lg["dec", "bfloat16"],
                                 zero["pre", "bfloat16"]),
        fault=max_abs_err(lg["dec", "bfloat16"], lg["pre", "bfloat16"]))
    log(f"[recurrent] {cfg.name} at the reference init (reported, bf16, "
        f"{out['rows']} positions): max |decode - forward with zero meta "
        f"tokens| {out['vs_zero_meta']:.5f}, max |decode - forward| "
        f"{out['fault']:.4f} (the missing meta tokens) of max |logit| "
        f"{out['max_logit']:.4f}")
    return out


def hymba_teacher_forcing(cfg, params: dict, tokens: torch.Tensor) -> dict:
    """Hymba's decode never feeds the meta tokens (ROADMAP 3b): their cache
    slots stay zero and the SSM starts from zero, so it does not reproduce
    ``forward``.  It computes exactly ``forward`` with the meta tokens
    zeroed (zero rows stay zero through every layer: no biases, a zero
    conv bias, RMS norms of zero; their k, v and SSM state are zero), the
    float32 identity held on the CPU
    (``tests/test_torch_recurrent.py::test_decode_equals_forward_without_meta_tokens``).
    So decode is held (1) by phase j's teacher forcing against that forward (``tf_summary``,
    ``check_teacher_forcing``), and (2) against the same steps in float64
    on the card: the float32 steps within TF_TOL32 of the largest float64
    logit, the bf16 steps within BF16_RATIO times the bf16 forward's
    distance from the float64 forward, both forwards with the meta tokens
    zeroed (the same function as decode; beside it the distance of the
    bf16 forward with its meta tokens is reported).  Norms, softmax and
    the scan compute in float32 whatever the activations' dtype (as the
    reference's), so the float64 runs differ from the float32 ones in the
    products and the residual stream only.  The decode-vs-forward
    difference the fault causes is reported, in float32."""
    check(cfg.num_meta_tokens + tokens.shape[1] <= cfg.window_size,
          "decode against forward beyond the window would meet the "
          "reference's decode/prefill window mismatch (ROADMAP 3b)")
    dtypes = ("bfloat16", "float32", "float64")
    lg = l_runs(cfg, params, tokens, [("dec", d) for d in dtypes] +
                [("pre", d) for d in dtypes])
    lg.update({("zero", d): v for (_, d), v in l_runs(
        cfg, zero_meta(params), tokens, [("pre", d) for d in dtypes]).items()})

    def err(a, b):
        return max_abs_err(lg[a], lg[b])
    out = dict(tf=tf_summary(lg["zero", "bfloat16"], lg["dec", "bfloat16"],
                             lg["zero", "float32"], lg["dec", "float32"]),
               max_logit=float(lg["dec", "float64"].abs().max()),
               f32_vs_f64=err(("dec", "float32"), ("dec", "float64")),
               dec_vs_f64=err(("dec", "bfloat16"), ("dec", "float64")),
               zero_vs_f64=err(("zero", "bfloat16"), ("zero", "float64")),
               pre_vs_f64=err(("pre", "bfloat16"), ("pre", "float64")),
               fault=err(("dec", "float32"), ("pre", "float32")),
               fault_max_logit=float(lg["pre", "float32"].abs().max()),
               finite=all(bool(torch.isfinite(t).all()) for t in lg.values()))
    log(f"[recurrent] {cfg.name} decode held against float64 on the card "
        f"over {tokens.numel()} positions: float32 steps "
        f"{out['f32_vs_f64']:.3e} ({out['f32_vs_f64'] / out['max_logit']:.2e}"
        f" of max |logit| {out['max_logit']:.4f}); bf16 steps "
        f"{out['dec_vs_f64']:.5f} from float64, the bf16 forward with zero "
        f"meta tokens {out['zero_vs_f64']:.5f} from its float64 run (with "
        f"its meta tokens {out['pre_vs_f64']:.5f}); the reference's missing "
        f"meta tokens: float32 max |decode - forward| {out['fault']:.4f} of "
        f"max |logit| {out['fault_max_logit']:.4f} (reported)")
    check_teacher_forcing(f"{cfg.name} (forward with zero meta tokens)",
                          out["tf"])
    check(out["finite"], f"{cfg.name}: non-finite logits")
    check(out["f32_vs_f64"] <= TF_TOL32 * out["max_logit"],
          f"{cfg.name}: float32 decode is {out['f32_vs_f64']} from float64")
    check(out["dec_vs_f64"] <= BF16_RATIO * out["zero_vs_f64"],
          f"{cfg.name}: bf16 decode is {out['dec_vs_f64']} from float64, "
          f"the bf16 forward with zero meta tokens {out['zero_vs_f64']}")
    return out


def l_state_cell(cfg, model, params: dict, name: str, B: int, L: int,
                 seed: int) -> dict:
    """One serve step against a cache (states, KV) filled from the seed at
    cache length L: its time (best of 3) and profile beside its bound."""
    from repro_torch.train.train_step import make_serve_step
    serve = make_serve_step(model)
    cache = model.init_cache(B, L, device=DEVICE)
    fill_cache(cache, seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 21)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    nxt, _ = serve(params, cache, tok, L)
    check(nxt.shape == (B,) and bool(((0 <= nxt) &
                                      (nxt < cfg.padded_vocab)).all()),
          f"{name}: greedy tokens out of range")
    step_ms = host_ms(lambda: serve(params, cache, tok, L), 3)
    prof = profile_call(f"serve step {cfg.name} {name} (B {B}, cache {L})",
                        lambda: serve(params, cache, tok, L))
    bound, by, nbytes = recurrent_decode_bound(cfg, params, cache, B, L)
    gib = tree_bytes(cache) / 2 ** 30
    log(f"[recurrent] {cfg.name} {name}: B {B}, cache length {L} ({gib:.2f}"
        f" GiB of state and cache); step {step_ms:.3f} ms (best of 3), "
        f"device busy {prof['busy_ms']:.3f} ms; bound {bound:.4f} ms ({by},"
        f" {nbytes / 1e9:.3f} GB), {bound / prof['busy_ms']:.3f} of it busy")
    return cache, dict(batch=B, cache_len=L, state_gib=gib, step_ms=step_ms,
                       busy_ms=prof["busy_ms"], idle=prof["idle"],
                       launches=prof["launches"], syncs=prof["syncs"],
                       bound_ms=bound, bound_by=by, bound_bytes=nbytes,
                       tokens_per_s=B / step_ms * 1e3)


def mamba_decode_f64(cfg, p: dict, h: torch.Tensor, conv: torch.Tensor,
                     ssm: torch.Tensor):
    """``hymba._mamba_path``'s one-token step in float64 from the same
    inputs: (output (B, 1, d), new SSM state)."""
    F = torch.nn.functional
    di, N = cfg.num_heads * cfg.head_dim, cfg.ssm_state
    h, conv = h.double(), conv.double()
    xz = h @ p["w_xz"].double()
    xs, z = xz[..., :di], xz[..., di:]
    win = torch.cat([conv, xs], dim=1)                       # (B, K, di)
    xc = F.silu((win * p["conv_w"].double()).sum(1, keepdim=True) +
                p["conv_b"].double())
    bc = xc @ p["w_bc"].double()
    delta = F.softplus(xc @ p["w_dt1"].double() @ p["w_dt2"].double() +
                       p["b_dt"].double())[:, 0]             # (B, di)
    A = -torch.exp(p["a_log"].double())
    new = torch.exp(delta[..., None] * A) * ssm.double() + \
        (delta * xc[:, 0])[..., None] * bc[:, 0, None, :N]
    y = (new * bc[:, 0, None, N:]).sum(-1) + p["d_skip"].double() * xc[:, 0]
    return (y[:, None] * F.silu(z)) @ p["w_ssm_out"].double(), new


def hymba_long_checks(cfg, params: dict, cache: dict, seed: int) -> dict:
    """On long_500k's filled cache: a sliding-window layer's
    ``decode_attention`` (window and meta-token sinks at the cache's end)
    and ``_mamba_path``'s decode step (output and SSM state) against
    float64, both within ATTN_TOL's bf16 2e-2 of their largest value."""
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.hymba import _mamba_path
    from repro_torch.models.transformer import _layer_slice
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 22)
    c = _layer_slice(cache["seg1_swa"], 0)
    p = _layer_slice(params["stack"]["seg1_swa"], 0)
    B, L = c["attn"]["k"].shape[:2]
    G = cfg.num_heads // cfg.num_kv_heads
    scale = 1.0 / math.sqrt(cfg.head_dim)
    M = cfg.num_meta_tokens
    q = torch.randn((B, 1, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    got = decode_attention(q, c["attn"]["k"], c["attn"]["v"], L,
                           window=cfg.window_size, scale=scale, groups=G,
                           sink_len=M)
    want = decode_attention_f64(q, c["attn"]["k"], c["attn"]["v"], L,
                                cfg.window_size, scale, G, sink_len=M)
    err = {"swa_attention": max_abs_err(got, want) /
           float(want.abs().max())}
    h = torch.randn((B, 1, cfg.d_model), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    state = {"conv": c["conv"].clone(), "ssm": c["ssm"].clone()}
    want_out, want_ssm = mamba_decode_f64(cfg, p, h, state["conv"],
                                          state["ssm"])
    with torch.no_grad():
        out = _mamba_path(p, h, cfg, state)
    err["mamba_out"] = max_abs_err(out, want_out) / float(
        want_out.abs().max())
    err["mamba_state"] = max_abs_err(state["ssm"], want_ssm) / float(
        want_ssm.abs().max())
    for k, e in err.items():
        check(e <= ATTN_TOL[torch.bfloat16],
              f"{cfg.name} long_500k: {k} is {e} of its largest from float64")
    log(f"[recurrent] {cfg.name} long_500k against float64 (of the largest "
        f"value): window layer's decode_attention (window {cfg.window_size},"
        f" {M} sinks) {err['swa_attention']:.2e}; _mamba_path decode step: "
        f"output {err['mamba_out']:.2e}, SSM state {err['mamba_state']:.2e}")
    return err


def l_serving(name: str, seed: int, part_done) -> dict:
    """One model of phase l (module docstring), its parts' peaks through
    ``part_done``."""
    cfg, model, params = family_model(name, seed)
    out = {"params": model.param_count(),
           "param_gb": tree_bytes(params) / 1e9}
    M = cfg.num_meta_tokens
    audio, prepare = None, None
    if cfg.family == "audio":
        audio = frames(cfg, SERVE_BATCH, seed).to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            enc = model.encode(params, audio)
        torch.cuda.synchronize()
        out["encode_ms"] = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(enc).all()), "encoder output not finite")
        log(f"[recurrent] {name}: encode {cfg.encoder_seq} frames at B "
            f"{SERVE_BATCH}: {out['encode_ms']:.1f} ms (host clock, first "
            f"call), finite; the cross cache filled from it (_xattn_kv)")
        del enc

        def prepare(cache):
            fill_cross(model, params, cache, audio)

    def bound(B, L, step):
        cache = model.init_cache(B, L, device="meta")
        return recurrent_decode_bound(cfg, params, cache, B, L)

    tokens, out["greedy"] = greedy_generation(cfg, model, params, seed,
                                              bound=bound, meta=M,
                                              prepare=prepare)
    if cfg.family == "hybrid":
        out["tf_reference_init"] = hymba_reference_init(cfg, params, tokens)
        condition(params)
        out["tf"] = hymba_teacher_forcing(cfg, params, tokens)
    else:
        out["tf"] = teacher_forcing(cfg, params, tokens, audio=audio)
        check_teacher_forcing(name, out["tf"])
    part_done(name)
    if cfg.family == "ssm":
        cell, B = XLSTM_WIDE
        _, out[cell] = l_state_cell(cfg, model, params, cell, B, 1, seed)
        part_done(f"{name} {cell}")
    if cfg.family == "hybrid":
        cell, L, B = HYMBA_LONG
        cache, out[cell] = l_state_cell(cfg, model, params, cell, B, L + M,
                                        seed)
        out[cell]["err"] = hymba_long_checks(cfg, params, cache, seed)
        del cache
        part_done(f"{name} {cell}")
    cell = WHISPER_PREFILL if cfg.family == "audio" else RECURRENT_PREFILL
    out[cell[0]] = family_prefill(cfg, model, params, seed, cell)
    part_done(f"{name} {cell[0]}")
    return out


def train_lm_example(counters) -> dict:
    """``repro_torch.examples.train_lm`` on the card at TRAIN_LM_STEPS
    steps (reduced xlstm-125m, the example's failure plan and checkpoint
    interval): its four lines, and the FailureLog and final step the JAX
    example's loop gives under the same plan (TRAIN_LM_EXPECTED); its
    checkpoint kernels ``HeldAgainstPlain``."""
    import contextlib
    import io
    from repro_torch.examples import train_lm
    for c in counters:
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with HeldAgainstPlain() as held, contextlib.redirect_stdout(buf):
        res = train_lm.main(["--steps", str(TRAIN_LM_STEPS)])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[recurrent] train_lm on the card: {line}")
    launches = {c.name: c.launches for c in counters}
    log_, step = TRAIN_LM_EXPECTED
    check(len(lines) == 4 and lines[0].startswith("[proteus] ") and
          lines[1].startswith("[failure-plan] 2 injected events: "),
          f"train_lm printed {lines}")
    check(dataclasses.asdict(res.failure_log) == log_ and
          res.final_step == step and all(np.isfinite(res.losses)),
          f"train_lm: FailureLog {res.failure_log}, step {res.final_step}")
    check(all(launches.values()) and held.calls == launches,
          f"train_lm: launches {launches}, held {held.calls}")
    return dict(wall_s=wall, launches=launches, held=held.report(),
                losses=[res.losses[0], res.losses[-1]])


def phase_recurrent(seed: int, counters, route_counter, checksum_counter,
                    per_leaf_counter) -> dict:
    """Phase l (module docstring).  ``counters``: every kernel wrapper's
    launch count; the serving parts launch none, the training parts only
    the two checkpoint kernels, whose launches are returned."""
    gc.collect()
    torch.cuda.empty_cache()
    release_host_memory()
    t_phase = time.perf_counter()
    peaks, out = {}, {}

    def part_done(name: str) -> None:
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def moved(among, before):
        return {c.name: c.launches - before[c.name] for c in among
                if c.launches != before[c.name]}

    torch.cuda.reset_peak_memory_stats()
    before = {c.name: c.launches for c in counters}
    for name in RECURRENT:
        out[name] = l_serving(name, seed, part_done)
    check(not moved(counters, before), f"kernels launched on the serving "
                                       f"path: {moved(counters, before)}")
    ckpt = (route_counter, checksum_counter)
    others = [c for c in counters if c not in ckpt]
    before = {c.name: c.launches for c in others}
    out["launcher"] = family_launcher((checksum_counter, route_counter),
                                      XLSTM_LAUNCH_ARGS,
                                      FAMILY_TREES[RECURRENT[0]])
    part_done("launcher")
    out["train_lm"] = train_lm_example(ckpt)
    part_done("train_lm")
    out["training"] = family_training(seed, route_counter, checksum_counter,
                                      per_leaf_counter, RECURRENT[1],
                                      HYMBA_TRAIN_KINDS)
    part_done("training")
    check(not moved(others, before), f"phase l's training launched "
                                     f"{moved(others, before)}")
    tr = out["training"]
    launches = {c.name: out["launcher"]["launches"][c.name] +
                out["train_lm"]["launches"][c.name] +
                tr["save_launches"][c.name] + tr["restore_launches"][c.name]
                for c in ckpt}
    out["launches"] = launches
    out["peak_gib"] = peaks
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[recurrent] phase l: peak device memory by part (GiB) "
        f"{ {k: round(v, 2) for k, v in peaks.items()} }, launches "
        f"{launches}, wall {out['wall_s']:.3f} s")
    return out


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
        phase = "decide"
        decide = phase_decide(args.seed, counters, ckpt_counters,
                              adapt["hot_signature"])
        log(json.dumps({"decide": decide}))
        gc.collect()
        torch.cuda.empty_cache()
        phase = "mesh"
        mesh = phase_mesh(args.seed, {c.name: c for c in (
            ROUTE_PLAN, DEST_BUDGETS, DEST_HISTOGRAM2D, PACK_CHUNKS)})
        for k, n in mesh["client"]["launches"].items():
            launches[k] += n
        log(json.dumps({"mesh": mesh}))
        gc.collect()
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
        del train
        phase = "serve"
        serve = phase_serve(args.seed, counters + ckpt_counters + (
            DEST_HISTOGRAM2D, FLETCHER, FLASH_ATTENTION, FLASH_ATTENTION_F32,
            FLASH_ATTENTION_WIDE, DEST_HISTOGRAM))
        log(json.dumps({"serve": serve}))
        del serve
        phase = "families"
        fam = phase_families(args.seed, counters + ckpt_counters + (
            DEST_HISTOGRAM2D, FLETCHER, FLASH_ATTENTION, FLASH_ATTENTION_F32,
            FLASH_ATTENTION_WIDE, DEST_HISTOGRAM), ROUTE_CHUNKS_SEGMENTED,
            FLETCHER_SEGMENTED, FLETCHER)
        for name, n in fam["launches"].items():
            launches[name] += n
        log(json.dumps({"families": fam}))
        del fam
        phase = "recurrent"
        rec = phase_recurrent(args.seed, counters + ckpt_counters + (
            DEST_HISTOGRAM2D, FLETCHER, FLASH_ATTENTION, FLASH_ATTENTION_F32,
            FLASH_ATTENTION_WIDE, DEST_HISTOGRAM), ROUTE_CHUNKS_SEGMENTED,
            FLETCHER_SEGMENTED, FLETCHER)
        for name, n in rec["launches"].items():
            launches[name] += n
        log(json.dumps({"recurrent": rec}))
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
