"""Three-term roofline of a dry-run cell (twin of
``repro.analysis.roofline``), on the H100's own constants:

    compute term    = device FLOPs / peak bf16 FLOP/s
    memory term     = device bytes / HBM bytes/s
    collective term = device collective bytes / NVLink bytes/s (each way)

The reference reads per-device figures from the compiled SPMD module.  The
port counts the whole step on meta tensors (``op_costs``), so a device's
share is the counted total divided by the chips the step's argument
shardings split over (``split_chips``), assuming the work divides evenly
over them.  The collective term comes from the argument shardings alone
(``sharding_collectives``): each parameter leaf sharded over the data axes
is all-gathered in the forward pass, and again in the backward pass of a
train step, and its gradient is reduce-scattered.  Activation collectives
on the ``model`` axis are not counted: the port has no SPMD partitioner to
show them.  ``note`` says so in every report.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, Tuple

from repro_torch.analysis.costs import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.analysis.op_costs import Costs, tensor_bytes
from repro_torch.distributed.sharding import _names, mesh_axes

DATA_AXES = ("pod", "data")

NOTE = ("per-device figures are the meta run's counted totals divided by "
        "the {split} of {chips} chips the argument shardings split over "
        "(even division assumed); collectives from the argument shardings "
        "only: data-axis parameter all-gathers{bwd} and gradient "
        "reduce-scatters; activation collectives on the model axis are not "
        "counted (no SPMD partitioner)")


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # per-device quantities
    device_flops: float
    device_traffic_bytes: float
    device_collective_bytes: float
    collective_breakdown: Dict[str, float]
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    # usefulness
    model_flops: float            # 6·N·D (dense) / 6·N_active·D (MoE)
    hlo_total_flops: float        # device_flops × chips
    useful_ratio: float
    # the counted per-device figures (the reference: XLA's cost_analysis)
    xla_flops: float = 0.0
    xla_bytes: float = 0.0
    note: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for training, 2·N·D for inference."""
    n_params = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params * tokens
    # decode: one token per sequence
    return 2.0 * n_params * shape.global_batch


def split_chips(shardings: Iterable) -> int:
    """Chips the shardings split over: the product of the sizes of every
    mesh axis some leaf's spec names."""
    used, sizes = set(), {}
    for sh in shardings:
        sizes = mesh_axes(sh.mesh)[1]
        for part in sh.spec:
            used.update(_names(part))
    return math.prod(sizes[a] for a in used)


def sharding_collectives(param_pairs: Iterable[Tuple[object, object]],
                         train: bool) -> Dict[str, float]:
    """Per-device collective bytes implied by the parameters' shardings
    (``(meta tensor, NamedSharding)`` pairs), counted as the reference
    counts a collective, by its operand: an all-gather of a leaf sharded
    over data axes reads the device's shard (forward; again in the
    backward of a train step), a reduce-scatter of its gradient reads the
    gradient gathered over those axes."""
    out: Dict[str, float] = {}
    for t, sh in param_pairs:
        sizes = mesh_axes(sh.mesh)[1]
        n_data = math.prod(sizes[a] for part in sh.spec
                           for a in _names(part) if a in DATA_AXES)
        if n_data == 1:
            continue
        shard = tensor_bytes(t) / math.prod(
            sizes[a] for part in sh.spec for a in _names(part))
        out["all-gather"] = out.get("all-gather", 0.0) + \
            shard * (2 if train else 1)
        if train:
            out["reduce-scatter"] = out.get("reduce-scatter", 0.0) + \
                shard * n_data
    return out


def build_report(arch: str, shape, mesh_name: str, n_chips: int,
                 costs: Costs, cfg, note: str = "") -> RooflineReport:
    """The report from one device's ``costs`` (``Costs.scaled`` of the
    counted totals, the collectives added)."""
    c = costs
    compute_s = c.flops / PEAK_FLOPS_BF16
    memory_s = c.traffic_bytes / HBM_BW
    coll_s = c.total_collective() / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_for(cfg, shape)
    total_flops = c.flops * n_chips
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        device_flops=c.flops, device_traffic_bytes=c.traffic_bytes,
        device_collective_bytes=c.total_collective(),
        collective_breakdown=dict(c.collective_bytes),
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck,
        model_flops=mf, hlo_total_flops=total_flops,
        useful_ratio=(mf / total_flops) if total_flops else 0.0,
        xla_flops=c.flops, xla_bytes=c.traffic_bytes,
        note=note,
    )
