"""Proteus-backed checkpoint manager (twin of ``repro.checkpoint.manager``).

The training loop's fault-tolerance substrate: the train state is chunked
into 256 KiB chunks, checksummed, routed by the policy's mode for the
checkpoint scope, and staged in the burst-buffer store; restores verify
every chunk.  The manifest JSON, ``CHUNK_WORDS``, the scope rule, ``keep``,
the async save and ``set_policy`` are the reference's, and a state saved
here stores the same chunks at the same nodes with the same manifest as the
JAX manager given the same leaves.

What moves to the card: on save, the chunks of all leaves are checksummed
by one ``fletcher_segmented`` launch and routed by one
``route_chunks_segmented`` launch, before the device-to-host copy; on
restore, the chunks of all leaves are routed by one launch, then each
leaf's chunks go to the card in one copy, which becomes the restored leaf,
and the leaves are checked there in groups of at least
``VERIFY_GROUP_BYTES``, one ``fletcher_segmented`` launch a group.  A
group's result is read back only once the next group's copies are queued,
so the host assembles leaves while the card checks, and a corrupt restore
stops at most one group past the bad chunk.  For a state on the CPU the
same calls run the kernels' plain versions.

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
from repro_torch.kernels.fletcher.ops import as_words, leaf_checksums
from repro_torch.kernels.fletcher.ref import n_chunks_of

CHUNK_WORDS = 1 << 16     # 256 KiB chunks
CKPT_SCOPE = "ckpt"       # scope prefix of all checkpoint paths
VERIFY_GROUP_BYTES = 1 << 30   # a restore checks leaves in groups this big

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
        leaves = [(key, t.detach()) for key, t in flatten_state(state)]
        words = [as_words(t) for _, t in leaves]
        checksums = leaf_checksums(words, CHUNK_WORDS)
        dest, offsets = self.route(
            [f"{self.scope}/{step}/{key}" for key, _ in leaves],
            [n_chunks_of(w.numel(), CHUNK_WORDS) for w in words],
            words[0].device if words else "cpu")
        # a copy even for a state on the CPU: the caller may change its
        # tensors while the save thread still reads the words
        hosts = []
        for w in words:
            host = _host_buffer(w.numel(), w.is_cuda)
            hosts.append(host.copy_(w, non_blocking=True))
        if any(w.is_cuda for w in words):
            torch.cuda.current_stream().synchronize()
        cut = offsets[1:-1]
        return [_StagedLeaf(key, list(t.shape), DTYPE_NAMES[t.dtype],
                            t.numel() * t.element_size(), host.numpy(), cs,
                            dest)
                for (key, t), host, cs, dest in zip(
                    leaves, hosts,
                    np.split(checksums.cpu().numpy(), cut),
                    np.split(dest.cpu().numpy(), cut))]

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
        restored: List[_RestoredLeaf] = []
        group: List[_RestoredLeaf] = []
        pending = None   # (leaves, checksums) launched, not yet read back

        def flush():
            """Launch the group's check, then read back the one before."""
            nonlocal pending
            launched = (list(group), leaf_checksums(
                [g.words for g in group], CHUNK_WORDS))
            group.clear()
            if pending:
                self._check(*pending)
            pending = launched

        for key, path, dest in zip(keys, paths, dests):
            got = self._fetch(path, key, chunks[key],
                              dest[[c["chunk_id"] for c in chunks[key]]])
            restored.append(got)
            missing = got.n_present < len(got.chunks)
            if verify:
                group.append(got)
                size = sum(g.words.numel() * 4 for g in group)
                if missing or size >= VERIFY_GROUP_BYTES:
                    flush()
            if missing:
                if pending:
                    self._check(*pending)
                raise IOError(f"missing chunk {key}#"
                              f"{got.chunks[got.n_present]['chunk_id']}")
        if group:
            flush()
        if pending:
            self._check(*pending)
        leaves = {}
        for got in restored:
            info = meta.leaves[got.key]
            raw = got.words.view(torch.uint8)[:info["nbytes"]]
            leaves[got.key] = raw.view(DTYPES[info["dtype"]]).reshape(
                info["shape"])
        return unflatten_like(like_state, leaves), meta.step

    def _fetch(self, path: str, key: str, chunks: List[dict],
               dest: np.ndarray) -> "_RestoredLeaf":
        """One leaf's chunks from the store, up to the first missing one,
        in one host buffer, and their copy to ``self.device`` (queued)."""
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
        return _RestoredLeaf(key, chunks, len(raws),
                             [len(r) for r in raws],
                             host.to(self.device, non_blocking=True))

    def _check(self, group: List["_RestoredLeaf"],
               checksums: torch.Tensor) -> None:
        """Compare a group's checksums with the manifest, leaf by leaf:
        the first chunk whose checksum or length differs from the
        manifest's fails the restore (chunks after a wrong length no
        longer sit at whole multiples of CHUNK_WORDS, so none of them is
        trusted)."""
        got = checksums.cpu().numpy()
        at = 0
        for leaf in group:
            n = leaf.n_present
            rows = n_chunks_of(leaf.words.numel(), CHUNK_WORDS)
            ok_len = [leaf.lengths[i] == leaf.chunks[i]["nbytes"]
                      for i in range(n)]
            n_ok = ok_len.index(False) if False in ok_len else n
            want = np.asarray([c["checksum"] for c in leaf.chunks[:n_ok]],
                              np.int32).reshape(-1, 2)
            bad = np.flatnonzero((got[at:at + n_ok] != want).any(axis=1))
            at += rows
            if len(bad) or n_ok < n:
                self.verify_failures += 1
                first = int(bad[0]) if len(bad) else n_ok
                raise IOError(f"checksum mismatch {leaf.key}#"
                              f"{leaf.chunks[first]['chunk_id']}")


@dataclass
class _RestoredLeaf:
    """One leaf of a restore: its manifest chunks, how many were found and
    their byte lengths, and its words on the restore's device."""
    key: str
    chunks: List[dict]
    n_present: int
    lengths: List[int]
    words: torch.Tensor
