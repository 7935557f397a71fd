"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (twin of
``repro.distributed.pipeline``).

``gpipe_apply`` runs a stacked-stage function over microbatches with the
classic (M + S - 1)-tick schedule.  The reference is one ``shard_map``
program; the port runs it SPMD, one process a stage, on the mesh backend's
process group (``core.mesh_engine.NodeMesh``): each rank takes its stage's
slice of the parameters, activations hop to rank + 1 through the mesh's
ring shift (``build_mesh_shift``, the reference's ``ppermute``), and the
last stage's deposits are all-reduced (the reference's ``psum``) so every
rank returns the whole output.  A rank's schedule is known on the host, so
a bubble (a tick where its stage has no microbatch) skips ``stage_fn`` and
passes its state on, where the reference computes it and masks it out.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.param import map_tree

STAGE_AXIS = "stage"


def gpipe_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                mesh, n_stages: int) -> torch.Tensor:
    """Run microbatches through a pipeline of stages, this rank one stage.

    stage_fn(params_one_stage, x) -> y  (same shape as x)
    stage_params: tree with a leading stage axis (n_stages, ...), the same
    on every rank; x_micro: (n_micro, mb, ...) microbatched input, the same
    on every rank; mesh: a ``NodeMesh`` of ``n_stages`` ranks, rank i
    stage i.  Every rank returns the (n_micro, mb, ...) outputs of the
    final stage.
    """
    from repro_torch.core.mesh_engine import build_mesh_shift
    if mesh.world != n_stages:
        raise ValueError(f"{n_stages} stages on a mesh of {mesh.world} ranks")
    stage = mesh.rank
    n_micro = x_micro.shape[0]
    params_l = map_tree(lambda a: a[stage], stage_params)
    shift = build_mesh_shift(mesh)
    state = torch.zeros_like(x_micro[0])
    outputs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        active = 0 <= t - stage < n_micro
        if active:
            inp = x_micro[t] if stage == 0 else state
            out = stage_fn(params_l, inp)
            if stage == n_stages - 1:
                outputs[t - stage] = out
        else:
            out = state
        state = shift(out, 1)
    if n_stages > 1:
        dist.all_reduce(outputs)
    return outputs


def sequential_ref(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   n_stages: int) -> torch.Tensor:
    """Oracle: run every microbatch through all stages sequentially."""
    out = []
    for x in x_micro:
        for s in range(n_stages):
            x = stage_fn(map_tree(lambda a: a[s], stage_params), x)
        out.append(x)
    return torch.stack(out)
