"""Proteus-backed checkpoint manager (twin of ``repro.checkpoint.manager``).

The training loop's fault-tolerance substrate: the train state is chunked
into 256 KiB chunks, checksummed, routed by the policy's mode for the
checkpoint scope, and staged in the burst-buffer store; restores verify
every chunk.  The manifest JSON, ``CHUNK_WORDS``, the scope rule, ``keep``,
the async save and ``set_policy`` are the reference's, and a state saved
here stores the same chunks at the same nodes with the same manifest as the
JAX manager given the same leaves.

What moves to the card: on save, each leaf's chunks are checksummed by one
``fletcher`` launch, and the chunks of all leaves are routed by one
``route_chunks_segmented`` launch, before the device-to-host copy; on
restore, the chunks of all leaves are routed by one launch, then each
leaf's chunks go to the card in one copy, are checked there by one
``fletcher`` launch, and that tensor becomes the restored leaf.  For a
state on the CPU the same calls run the kernels' plain versions.

A state is a nested structure of tensors — dicts, tuples and NamedTuples,
like the JAX train state ``(params, AdamWState(step, mu, nu), cursor)`` —
flattened to ``(key, tensor)`` leaves whose keys are the ones JAX's
``tree_flatten_with_path`` gives (``[0]/['embed']/['embedding']``,
``[1]/.mu/...``), dict keys sorted.

Reference behaviour kept on purpose: ``_gc`` deletes manifests only, so the
store keeps every checkpoint's chunks (ROADMAP Queue 3).
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.layouts import str_hash
from repro_torch.core.policy import as_policy
from repro_torch.kernels.chunk_router.ops import leaf_table, route_leaves
from repro_torch.kernels.fletcher.ops import as_words, chunk_checksums

CHUNK_WORDS = 1 << 16     # 256 KiB chunks
CKPT_SCOPE = "ckpt"       # scope prefix of all checkpoint paths

DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.float64: "float64",
               torch.int32: "int32", torch.int64: "int64",
               torch.int16: "int16", torch.int8: "int8",
               torch.uint8: "uint8", torch.bool: "bool"}
DTYPES = {v: k for k, v in DTYPE_NAMES.items()}


# ---------------------------------------------------------------------------
# state trees
# ---------------------------------------------------------------------------
def flatten_state(state, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(key, tensor)`` leaves in JAX's flattening order and key format."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part
    if isinstance(state, dict):
        out = []
        for k in sorted(state):
            out += flatten_state(state[k], join(f"[{k!r}]"))
        return out
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        out = []
        for name in state._fields:
            out += flatten_state(getattr(state, name), join(f".{name}"))
        return out
    if isinstance(state, (tuple, list)):
        out = []
        for i, v in enumerate(state):
            out += flatten_state(v, join(f"[{i}]"))
        return out
    if state is None:
        return []
    return [(prefix, state)]


def unflatten_like(like, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    """``like``'s structure with the leaf at each key taken from ``leaves``."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part
    if isinstance(like, dict):
        return {k: unflatten_like(v, leaves, join(f"[{k!r}]"))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(unflatten_like(getattr(like, n), leaves,
                                           join(f".{n}"))
                            for n in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(unflatten_like(v, leaves, join(f"[{i}]"))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves[prefix]


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------
@dataclass
class CheckpointMeta:
    step: int
    layout_mode: int
    leaves: Dict[str, dict] = field(default_factory=dict)  # key → shape/dtype
    chunks: List[dict] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({"step": self.step, "layout_mode": self.layout_mode,
                           "leaves": self.leaves, "chunks": self.chunks})

    @classmethod
    def from_json(cls, s: str) -> "CheckpointMeta":
        d = json.loads(s)
        return cls(d["step"], d["layout_mode"], d["leaves"], d["chunks"])


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------
class BurstBufferStore:
    """In-memory BB-backed object store: one dict per node (the node-local
    tier), chunks keyed by ``(str_hash(path), chunk_id)``.  The manager
    routes every chunk of a checkpoint in one batch (``route_leaves``) and
    passes each chunk's node in."""

    def __init__(self, policy):
        self.policy = as_policy(policy)
        self.nodes: List[Dict[Tuple[int, int], bytes]] = [
            {} for _ in range(self.policy.n_nodes)]

    def put(self, dest: int, path: str, chunk_id: int, data: bytes) -> None:
        self.nodes[dest][(str_hash(path), chunk_id)] = data

    def get(self, dest: int, path: str, chunk_id: int) -> Optional[bytes]:
        key = (str_hash(path), chunk_id)
        hit = self.nodes[dest].get(key)
        if hit is not None:
            return hit
        for node in self.nodes:  # stranded-data fallback (Modes 1/4)
            if key in node:
                return node[key]
        return None


def _host_buffer(n_words: int, pinned: bool) -> torch.Tensor:
    """An int32 host buffer; page-locked (``pinned``) when it is copied to or
    from the card, where a pageable copy of a 12 GB state ran at 1.7 GB/s
    (PERF.md).  Freed page-locked blocks are cached by PyTorch and reused by
    the next save."""
    return torch.empty(n_words, dtype=torch.int32, pin_memory=pinned)


@dataclass
class _StagedLeaf:
    """One leaf of a save after its device work: host words, per-chunk
    checksums and destinations."""
    key: str
    shape: List[int]
    dtype: str
    nbytes: int
    words: np.ndarray        # int32, the leaf's bytes zero-padded to words
    checksums: np.ndarray    # (n_chunks, 2) int32
    dest: np.ndarray         # (n_chunks,) int32


class CheckpointManager:
    def __init__(self, directory: str, layout, async_save: bool = True,
                 keep: int = 3, scope: Optional[str] = None, device=None):
        """``layout``: a LayoutPolicy (per-scope plan) or a single-mode
        LayoutParams.  ``scope`` is the path prefix checkpoint chunks are
        stored under; when omitted, a policy scope whose last segment
        starts with "ckpt" is used if one exists, else "ckpt".  Restored
        leaves go to ``device`` (the CUDA card unless given)."""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.layout = as_policy(layout)
        if scope is None:
            cands = [s for s, _ in self.layout.scopes
                     if s.rstrip("/").rsplit("/", 1)[-1].startswith("ckpt")]
            scope = cands[0] if cands else CKPT_SCOPE
        self.scope = scope.rstrip("/")
        self.store = BurstBufferStore(self.layout)
        self.async_save = async_save
        self.keep = keep
        self.device = resolve_device(device)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.save_count = 0
        self.verify_failures = 0

    def set_policy(self, policy) -> None:
        """Route later chunks by a new plan; stored chunks still restore
        (``get`` falls back to scanning every node).  Joins any in-flight
        save first."""
        self.wait()
        self.layout = as_policy(policy)
        self.store.policy = self.layout

    # ---- routing ----------------------------------------------------------
    def route(self, paths: List[str], n_chunks: List[int],
              device) -> Tuple[torch.Tensor, np.ndarray]:
        """Destinations of chunks 0..n_chunks[i]-1 of each leaf path, leaf
        after leaf, on ``device`` (one leaf table copied there, one
        ``route_leaves`` launch, no wait), and the len(paths) + 1 offsets
        that cut them into leaves."""
        table, offsets = leaf_table(
            [str_hash(p) for p in paths],
            [int(self.layout.mode_for_path(p)) for p in paths], n_chunks)
        return route_leaves(table, int(offsets[-1]),
                            n_nodes=self.layout.n_nodes,
                            device=device), offsets

    # ---- save -------------------------------------------------------------
    def save(self, step: int, state) -> None:
        """Checksum and route every leaf on its device, copy it to the host,
        then store it (on a background thread when ``async_save``).  The
        state is not read after this returns, so the caller may go on."""
        staged = self._stage(step, state)
        if self.async_save:
            self.wait()
            t = threading.Thread(target=self._save_thread,
                                 args=(step, staged), daemon=True)
            t.start()
            self._pending = t
        else:
            self._save_sync(step, staged)

    def _stage(self, step: int, state) -> List[_StagedLeaf]:
        device_side = []
        for key, t in flatten_state(state):
            t = t.detach()
            words = as_words(t)
            device_side.append((key, t, words,
                                chunk_checksums(words, CHUNK_WORDS)))
        dest, offsets = self.route(
            [f"{self.scope}/{step}/{key}" for key, _, _, _ in device_side],
            [len(cs) for _, _, _, cs in device_side],
            device_side[0][2].device if device_side else "cpu")
        # a copy even for a state on the CPU: the caller may change its
        # tensors while the save thread still reads the words
        hosts = []
        for _, _, words, _ in device_side:
            host = _host_buffer(words.numel(), words.is_cuda)
            hosts.append(host.copy_(words, non_blocking=True))
        if any(words.is_cuda for _, _, words, _ in device_side):
            torch.cuda.current_stream().synchronize()
        dests = np.split(dest.cpu().numpy(), offsets[1:-1])
        return [_StagedLeaf(key, list(t.shape), DTYPE_NAMES[t.dtype],
                            t.numel() * t.element_size(), host.numpy(),
                            cs.cpu().numpy(), dest)
                for (key, t, _, cs), host, dest in zip(device_side, hosts,
                                                       dests)]

    def wait(self) -> None:
        """Join the in-flight save; re-raise its error, if it failed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _save_thread(self, step: int, staged: List[_StagedLeaf]) -> None:
        try:
            self._save_sync(step, staged)
        except BaseException as e:   # reported by the next wait()
            self._error = e

    def _save_sync(self, step: int, staged: List[_StagedLeaf]) -> None:
        scope_mode = self.layout.mode_for_path(f"{self.scope}/{step}")
        meta = CheckpointMeta(step=step, layout_mode=int(scope_mode))
        for leaf in staged:
            path = f"{self.scope}/{step}/{leaf.key}"
            meta.leaves[leaf.key] = {"shape": leaf.shape,
                                     "dtype": leaf.dtype,
                                     "nbytes": leaf.nbytes}
            for cid in range(len(leaf.dest)):
                seg = leaf.words[cid * CHUNK_WORDS:(cid + 1) * CHUNK_WORDS]
                self.store.put(int(leaf.dest[cid]), path, cid, seg.tobytes())
                cs = leaf.checksums[cid]
                meta.chunks.append({"key": leaf.key, "chunk_id": cid,
                                    "checksum": [int(cs[0]), int(cs[1])],
                                    "nbytes": int(seg.nbytes)})
        (self.dir / f"ckpt_{step}.json").write_text(meta.to_json())
        self.save_count += 1
        self._gc()

    def _gc(self) -> None:
        metas = sorted(self.dir.glob("ckpt_*.json"),
                       key=lambda p: int(p.stem.split("_")[1]))
        for p in metas[:-self.keep]:
            p.unlink()

    # ---- restore ----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        metas = sorted(self.dir.glob("ckpt_*.json"),
                       key=lambda p: int(p.stem.split("_")[1]))
        return int(metas[-1].stem.split("_")[1]) if metas else None

    def restore(self, step: int, like_state, *, verify: bool = True):
        """Rebuild ``like_state``'s structure from the store, leaves on
        ``self.device``.  Raises ``IOError`` on a missing chunk or, with
        ``verify``, on the first chunk whose checksum (or length) differs
        from the manifest's, chunks taken leaf by leaf in order."""
        meta = CheckpointMeta.from_json(
            (self.dir / f"ckpt_{step}.json").read_text())
        by_key: Dict[str, List[dict]] = {}
        for ch in meta.chunks:
            by_key.setdefault(ch["key"], []).append(ch)
        keys = [key for key, _ in flatten_state(like_state)]
        chunks = {key: sorted(by_key[key], key=lambda c: c["chunk_id"])
                  for key in keys}
        paths = [f"{self.scope}/{step}/{key}" for key in keys]
        # a leaf's chunk ids are 0..n-1 unless the manifest lost some: then
        # the ids up to its last one are routed
        dest, offsets = self.route(
            paths, [max((c["chunk_id"] for c in chunks[key]), default=-1) + 1
                    for key in keys], self.device)
        dests = np.split(dest.cpu().numpy(), offsets[1:-1])
        leaves = {}
        for key, path, dest in zip(keys, paths, dests):
            leaves[key] = self._restore_leaf(
                path, key, meta.leaves[key], chunks[key],
                dest[[c["chunk_id"] for c in chunks[key]]], verify)
        return unflatten_like(like_state, leaves), meta.step

    def _restore_leaf(self, path: str, key: str, info: dict,
                      chunks: List[dict], dest: np.ndarray,
                      verify: bool) -> torch.Tensor:
        raws: List[bytes] = []
        for ch, d in zip(chunks, dest):
            raw = self.store.get(int(d), path, ch["chunk_id"])
            if raw is None:
                break
            raws.append(raw)
        host = _host_buffer(sum(len(r) for r in raws) // 4,
                            self.device.type == "cuda")
        buf, at = memoryview(host.numpy()).cast("B"), 0
        for r in raws:
            buf[at:at + len(r)] = r
            at += len(r)
        words = host.to(self.device, non_blocking=True)
        if verify and raws:
            self._verify(key, words, raws, chunks)
        if len(raws) < len(chunks):
            raise IOError(f"missing chunk {key}#"
                          f"{chunks[len(raws)]['chunk_id']}")
        dtype = DTYPES[info["dtype"]]
        return words.view(torch.uint8)[:info["nbytes"]].view(dtype).reshape(
            info["shape"])

    def _verify(self, key: str, words: torch.Tensor, raws: List[bytes],
                chunks: List[dict]) -> None:
        """Check the chunks of one leaf on its device (one ``fletcher``
        launch); a chunk whose length differs from the manifest's fails
        too (chunks then no longer sit at whole multiples of CHUNK_WORDS)."""
        bad = [i for i, r in enumerate(raws) if len(r) != chunks[i]["nbytes"]]
        if not bad:
            got = chunk_checksums(words, CHUNK_WORDS).cpu().numpy()
            want = np.asarray([c["checksum"] for c in chunks[:len(raws)]],
                              np.int32).reshape(-1, 2)
            bad = np.flatnonzero((got[:len(raws)] != want).any(axis=1))
        if len(bad):
            self.verify_failures += 1
            raise IOError(f"checksum mismatch {key}#"
                          f"{chunks[int(bad[0])]['chunk_id']}")
