"""The burst-buffer engine on a mesh of ranks over ``torch.distributed``
(twin of ``repro.core.mesh_engine``).

The reference is one controller driving every device through
``shard_map``.  PyTorch has no such thing, so the port runs one process a
rank (SPMD) with *replicated requests*: every rank makes the same
``BBClient`` call with the same global (N, q) request, as the reference's
single controller does.  A rank holds the tables of its own node rows
``[rank·L, (rank+1)·L)``, ``L = N / world``; the ops below take the global
request, run the stacked engine (``burst_buffer``) on the rank's rows with
the collective hooks of this module, and return the rank's rows of the
result (``NodeMesh.gather`` gives the global array, as ``np.asarray`` of a
sharded array does in JAX).  Every host decision the client makes (the
``auto`` pick, spec planning, the write registry, migration worklists) is
made from the same global arrays on every rank, so the ranks stay in step
without talking.

The hooks: ``mesh_exchange`` is one ``all_to_all_single`` (the src/dst
transpose across ranks), ``build_mesh_shift`` a ring of
``batch_isend_irecv`` (the ppermute plan's rounds), ``mesh_global_sum`` an
``all_reduce`` (the carry round's predicate, so every rank takes the same
branch).  A packed ``RaggedSpec`` cannot cross ``all_to_all_single``
(equal splits) and is rejected; a ``MeshRaggedSpec`` can: its padded plan
rides the ordinary all_to_all at the global max budget, its ppermute plan
the shift rounds.

Process groups: ``make_node_mesh`` uses the default group of the process
when one is initialized (the ranks were spawned and joined by their
launcher, as ``launch.dryrun --bb`` does), else it initializes a world of
one itself; a CUDA mesh is NCCL, a CPU mesh gloo, and nothing falls back
from one to the other.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import burst_buffer as bb
from repro_torch.core import obs
from repro_torch.core.exchange_plan import MeshRaggedSpec, RaggedSpec
from repro_torch.core.policy import as_policy

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class NodeMesh:
    """The ranks of the default process group as a 1-D node mesh.

    ``rank``/``world``: this process's place; ``device``: where its tables
    live (``cuda:<rank mod cards>`` under NCCL, the CPU under gloo);
    ``backend``: ``"nccl"`` or ``"gloo"``.
    """

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str):
        self.rank, self.world = int(rank), int(world)
        self.device, self.backend = torch.device(device), backend

    def __repr__(self) -> str:
        return (f"NodeMesh(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend!r})")

    def local_n(self, n_nodes: int) -> int:
        """Node rows a rank holds: ``n_nodes / world``."""
        if n_nodes % self.world:
            raise ValueError(f"{n_nodes} nodes do not split over "
                             f"{self.world} ranks")
        return n_nodes // self.world

    def rows(self, n_nodes: int) -> slice:
        """This rank's rows of a global (n_nodes, ...) array."""
        L = self.local_n(n_nodes)
        return slice(self.rank * L, (self.rank + 1) * L)

    def node_ids(self, n_nodes: int) -> torch.Tensor:
        """(L,) int32 global ranks of this rank's rows, on its device."""
        r = self.rows(n_nodes)
        return torch.arange(r.start, r.stop, dtype=torch.int32,
                            device=self.device)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global array (a view)."""
        return x[self.rows(x.shape[0])]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's rows (``all_gather``)."""
        if self.world == 1:
            return x
        wire, back = _wire(x.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire)
        return back(torch.cat(parts, dim=0))


def _wire(x: torch.Tensor) -> Tuple[torch.Tensor, Callable]:
    """A collective's tensor: bool travels as uint8 (gloo has no bool)."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8), lambda y: y.to(torch.bool)
    return x, lambda y: y


def mesh_exchange(x: torch.Tensor, mesh: NodeMesh) -> torch.Tensor:
    """Local (L, N, s, ...) → (L, N, s, ...) with src and dst swapped
    across the mesh: row j of the result, column i holds what global row i
    sent to this rank's row j.  One ``all_to_all_single``: the destination
    rank is made the leading, contiguous dim of the send buffer, and each
    rank's block arrives as (L_src, L_dst, ...), which is put back as
    (L_dst, N_src, ...).  Slot-count agnostic, like the reference's."""
    W, L = mesh.world, x.shape[0]
    rest = tuple(x.shape[2:])
    wire, back = _wire(x)
    send = wire.reshape((L, W, L) + rest).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)                     # (W, L_src, L_dst, ...)
    dist.all_to_all_single(recv, send)
    y = recv.transpose(0, 2).transpose(1, 2)          # (L_dst, W, L_src, ...)
    return back(y.reshape((L, W * L) + rest))


def build_mesh_shift(mesh: NodeMesh) -> Callable:
    """The mesh twin of ``exchange_plan.stacked_shift``: ``shift(x, k)``
    sends this rank's buffer to rank ``(rank + k) mod world`` and returns
    the one from ``(rank − k) mod world`` (one ``batch_isend_irecv``), the
    reference's ``[(i, (i + k) % N) for i]`` ppermute.  A shift by a
    multiple of the world is the identity and moves nothing.  Only valid
    with one node row a rank (``_check_specs``)."""
    W, r = mesh.world, mesh.rank

    def shift(x: torch.Tensor, k: int) -> torch.Tensor:
        if k % W == 0:
            return x
        wire, back = _wire(x.contiguous())
        out = torch.empty_like(wire)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wire, (r + k) % W),
            dist.P2POp(dist.irecv, out, (r - k) % W)])
        for req in reqs:
            req.wait()
        return back(out)

    return shift


def mesh_global_sum(x: torch.Tensor, mesh: NodeMesh) -> torch.Tensor:
    """All-node scalar sum: the local sum, then an ``all_reduce``, so every
    rank reads the same total (the carry predicate's reduction)."""
    s = x.sum()
    dist.all_reduce(s)
    return s


def _check_specs(config: bb.ExchangeConfig, local_n: int) -> None:
    """Reject exchange specs the mesh collectives cannot carry."""
    for spec in (config.data_spec, config.meta_spec):
        if isinstance(spec, RaggedSpec):
            raise ValueError(
                "packed ragged exchange specs need a single-device packed "
                "layout; the mesh all_to_all requires uniform splits — "
                "use a MeshRaggedSpec (padded or ppermute plan) or "
                "uniform budgets (the lossless carry round covers "
                "overflow)")
        if isinstance(spec, MeshRaggedSpec) and \
                spec.executor == "ppermute" and local_n != 1:
            raise ValueError(
                "the ppermute segmented exchange rotates the device ring; "
                f"with {local_n} node rows per device the rotation would "
                "move them together — use the padded plan (bmax "
                "all_to_all) when nodes aren't 1:1 with devices")


def _hooks(mesh: NodeMesh, n_nodes: int) -> dict:
    """The engine's collective hooks on ``mesh``."""
    return dict(exchange=functools.partial(mesh_exchange, mesh=mesh),
                node_ids=mesh.node_ids(n_nodes),
                global_sum=functools.partial(mesh_global_sum, mesh=mesh),
                shift=build_mesh_shift(mesh))


@obs.trace_span("mesh.build_ops", cat="build")
def build_mesh_ops(mesh: NodeMesh, policy,
                   config: bb.ExchangeConfig = bb.DENSE) -> Tuple:
    """(write, read, meta, read_loc) ops of one config on ``mesh``.

    Each takes the rank's tables and the *global* request arrays, with the
    per-request ``mode`` right after the state, as the client's stacked
    ops do: ``write(state, mode, ph, cid, payload, valid) -> state``,
    ``read(state, mode, ph, cid, valid) -> (payload, found)``,
    ``meta(state, mode, op, ph, size, loc, valid) -> (state, found, size,
    loc)`` and ``read_loc(..., valid, data_loc) -> (payload, found)``
    (the two-phase read's data round).  They run the engine on the rank's
    rows and return the rank's rows.
    """
    policy = as_policy(policy)
    N = policy.n_nodes
    rows = mesh.rows(N)
    _check_specs(config, mesh.local_n(N))
    hooks = _hooks(mesh, N)

    def write(state, mode, ph, cid, payload, valid):
        return bb.forward_write(state, policy, ph[rows], cid[rows],
                                payload[rows], valid[rows], mode=mode[rows],
                                config=config, **hooks)

    def read(state, mode, ph, cid, valid):
        return bb.forward_read(state, policy, ph[rows], cid[rows],
                               valid[rows], mode=mode[rows], config=config,
                               **hooks)

    def meta(state, mode, op, ph, size, loc, valid):
        return bb.meta_op(state, policy, op[rows], ph[rows], size[rows],
                          loc[rows], valid[rows], mode=mode[rows],
                          config=config, **hooks)

    def read_loc(state, mode, ph, cid, valid, data_loc):
        return bb.forward_read(state, policy, ph[rows], cid[rows],
                               valid[rows], mode=mode[rows], config=config,
                               data_loc=data_loc[rows], **hooks)

    return write, read, meta, read_loc


@obs.trace_span("mesh.build_migrate", cat="build")
def build_mesh_migrate(mesh: NodeMesh, policy,
                       config: bb.ExchangeConfig = bb.COMPACTED) -> Callable:
    """``migrate_rows`` on ``mesh`` (live relayout): the op takes
    ``(state, ph, cid, valid, old_mode, new_mode)`` with global request
    arrays and returns ``(state, moved, found_old)`` of the rank's rows;
    the carry predicates are all-reduced, so every rank takes the same
    branch."""
    policy = as_policy(policy)
    rows = mesh.rows(policy.n_nodes)
    hooks = _hooks(mesh, policy.n_nodes)

    def migrate(state, ph, cid, valid, old_mode, new_mode):
        return bb.migrate_rows(state, policy, ph[rows], cid[rows],
                               valid[rows], old_mode[rows], new_mode[rows],
                               config=config, **hooks)

    return migrate


@obs.trace_span("mesh.build_probe", cat="build")
def build_mesh_probe(mesh: NodeMesh, policy,
                     config: bb.ExchangeConfig = bb.DENSE) -> Callable:
    """The two-phase read's probe on ``mesh``: ``(state, mode, ph, valid)``
    → (found, loc) of the rank's rows, one STAT ``meta_op``."""
    policy = as_policy(policy)
    N = policy.n_nodes
    rows = mesh.rows(N)
    _check_specs(config, mesh.local_n(N))
    hooks = _hooks(mesh, N)

    def probe(state, mode, ph, valid):
        ph = ph[rows]
        shape, dev = ph.shape, ph.device
        _, found, _, loc = bb.meta_op(
            state, policy, torch.full(shape, bb.OP_STAT, dtype=torch.int32,
                                      device=dev),
            ph, torch.zeros(shape, dtype=torch.int32, device=dev),
            torch.full(shape, -1, dtype=torch.int32, device=dev),
            valid[rows], mode=mode[rows], config=config, **hooks)
        return found, loc

    return probe


def build_telemetry_reduce(mesh: NodeMesh) -> Callable:
    """Fleet-wide sum of per-node telemetry counters: takes this rank's
    (L, n_scopes, n_features) slice (``ScopeTelemetry(per_node=L)``) and
    returns the (n_scopes, n_features) sum over every node, the same on
    every rank (one ``all_reduce``), so drift fires on every rank alike."""

    def reduce(counts: torch.Tensor) -> torch.Tensor:
        s = counts.sum(dim=0)
        dist.all_reduce(s)
        return s

    return reduce


def make_node_mesh(n_devices: Optional[int] = None,
                   device=None) -> NodeMesh:
    """The node mesh of this process's ranks.

    ``device``: ``None`` (a CUDA card, NCCL; raises without one) or
    ``"cpu"`` (gloo).  With a default process group initialized — the
    ranks were spawned and joined by their launcher — its ranks are the
    mesh, and its backend must be the device's (no fallback from one to
    the other).  With none, this initializes a default group of one rank
    itself (an in-process ``HashStore``, no port or file); the caller may
    ``torch.distributed.destroy_process_group()`` it when done.
    ``n_devices``, when given, must equal the world size.
    """
    dev = (torch.device("cpu") if device is not None and
           torch.device(device).type == "cpu" else resolve_device(device))
    backend = BACKENDS.get(dev.type)
    if backend is None:
        raise ValueError(f"no mesh backend for device {dev}")
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs {n_devices} processes "
                "joined in a process group (spawn them, as launch.dryrun "
                "--bb does); without one this process makes a world of 1")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    got = dist.get_backend()
    if got != backend:
        raise RuntimeError(f"the default process group runs {got}; a mesh "
                           f"on {dev.type} needs {backend}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"asked for {n_devices} ranks, the process group "
                         f"has {world}")
    if backend == "nccl":
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return NodeMesh(rank, world, dev, backend)
