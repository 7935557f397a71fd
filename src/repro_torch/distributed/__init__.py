"""Sharding rules, gradient compression and pipeline parallelism (twin of
``repro.distributed``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    MeshContext,
    current_mesh_context,
    logical_constraint,
    logical_to_pspec,
    mesh_context,
    spec_tree_for,
)
