"""The port's logical axes and sharding rules against the JAX package.

Descriptors only, at full width: every arch's parameter axes, abstract
parameters (meta tensors against ShapeDtypeStructs), parameter bytes and
optimizer state axes; every applicable (arch × shape) cell's
``input_specs`` (shapes, dtypes, axes trees) and each leaf's partition spec
on both production meshes, the reference's taken from its
``MeshContext`` over a fake mesh of the same names and sizes (the
reference's own 256- and 512-device meshes need placeholder devices).
Then ``logical_constraint``: the identity on plain tensors and without a
context, a redistribution of a ``DTensor`` on a gloo ``DeviceMesh`` of one
rank, and a reduced forward under that context equal to the one without
it, bit for bit.
"""
import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ALL_SHAPES as J_SHAPES
from repro.configs import all_configs as j_all_configs
from repro.distributed.sharding import MeshContext as JMeshContext
from repro.distributed.sharding import default_rules as j_default_rules
from repro.launch.specs import input_specs as j_input_specs
from repro.models.param import param_bytes as j_param_bytes
from repro.models.registry import build_model as j_build_model
from repro.train.optimizer import AdamW as JAdamW
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import ALL_SHAPES, all_configs, shape_applicable
from repro_torch.distributed.sharding import (MeshContext, NamedSharding,
                                              _is_axes_leaf, default_rules,
                                              logical_constraint,
                                              logical_to_pspec, mesh_context,
                                              spec_tree_for)
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.specs import input_specs
from repro_torch.models.param import param_bytes
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step

ARCHS = tuple(all_configs())


class FakeMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


def _ctx():
    return MeshContext(FakeMesh(), default_rules(FakeMesh()))


# ---------------------------------------------------------------------------
# the reference's pspec tests, on the port
# ---------------------------------------------------------------------------
def test_pspec_basic_mapping():
    p = _ctx().pspec(("embed", "ffn"), (4096, 16384))
    assert p[0] == ("pod", "data")   # fsdp over dp axes
    assert p[1] == "model"


def test_pspec_dedup_batch_claims_dp_axes():
    p = _ctx().pspec(("batch", None, "embed"), (256, 128, 4096))
    assert p[0] == ("pod", "data")
    assert p[2] is None              # dp axes already used by batch


def test_pspec_divisibility_drop():
    ctx = _ctx()
    assert ctx.pspec(("ffn",), (100,))[0] is None   # 100 % 16 != 0
    assert ctx.pspec(("ffn",), (1600,))[0] == "model"


def test_pspec_batch_one_not_sharded():
    assert _ctx().pspec(("batch", "act_kv_seq"), (1, 524288))[0] is None


def test_default_rules_and_production_meshes_match_reference():
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for kw in ({}, {"fsdp": False}, {"seq_shard": True}):
            assert default_rules(mesh, **kw) == j_default_rules(mesh, **kw)
        assert mesh_chips(make_production_mesh(multi_pod=multi)) == \
            (512 if multi else 256)
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}


def test_axes_leaf_rule():
    assert _is_axes_leaf(()) and _is_axes_leaf((None,)) and \
        _is_axes_leaf(("batch", None))
    assert not _is_axes_leaf((("batch",), ())) and \
        not _is_axes_leaf(AdamW().state_axes({"w": ("embed",)}))


def test_placements_split_two_axis_dims_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    sh = NamedSharding(FakeMeshDims(), (("pod", "data"), "model", None))
    assert sh.placements() == [Shard(0), Shard(0), Shard(1)]
    assert sh.shard_shape((64, 32, 3)) == (16, 16, 3)
    assert NamedSharding(FakeMeshDims(), (None, None)).placements() == \
        [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        NamedSharding(FakeMeshDims(), (("data", "pod"),)).placements()


class FakeMeshDims:
    """A stand-in for a torch ``DeviceMesh``: dim names and a mesh array."""
    mesh_dim_names = ("pod", "data", "model")
    mesh = np.zeros((2, 2, 2))


# ---------------------------------------------------------------------------
# parameters, abstract parameters, optimizer state: all ten archs
# ---------------------------------------------------------------------------
def _walk(tree, path=()):
    """(path, leaf) pairs of nested dicts, NamedTuples, tuples and lists
    (keys sorted); an axes tuple is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif _is_axes_leaf(tree) and not hasattr(tree, "_fields"):
        yield path, tree
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _shapes(tree):
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _walk(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_abstract_params_and_state_match_reference(arch):
    jm, tm = j_build_model(j_all_configs()[arch]), build_model(
        all_configs()[arch])
    ja, ta = jm.param_axes(), tm.param_axes()
    assert dict(_walk(ta)) == dict(_walk(ja))
    assert _shapes(tm.abstract_params()) == _shapes(jm.abstract_params())
    assert all(t.device.type == "meta"
               for _, t in _walk(tm.abstract_params()))
    assert param_bytes(tm.describe(), tm.cfg.param_dtype) == \
        j_param_bytes(jm.describe(), jm.cfg.param_dtype)
    jo, to = JAdamW().state_axes(ja), AdamW().state_axes(ta)
    assert type(to).__name__ == "AdamWState" and tuple(to) == tuple(jo)
    assert _shapes(AdamW().abstract_state(tm.abstract_params())) == \
        _shapes(JAdamW().abstract_state(jm.abstract_params()))


# ---------------------------------------------------------------------------
# input_specs and every leaf's partition spec, every applicable cell
# ---------------------------------------------------------------------------
def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _pspec_pairs(axes_tree, shape_tree):
    """(path, axes, shape) of every axes leaf and its tensor."""
    shapes = dict(_walk(shape_tree))
    return [(p, ax, tuple(shapes[p].shape)) for p, ax in _walk(axes_tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_pspecs_match_reference(arch):
    cfg, jcfg = all_configs()[arch], j_all_configs()[arch]
    cells = 0
    for name, shape in ALL_SHAPES.items():
        if not shape_applicable(cfg, shape):
            continue
        cells += 1
        args, axes = input_specs(cfg, shape)
        jargs, jaxes = j_input_specs(jcfg, J_SHAPES[name])
        assert _shapes(args) == _shapes(jargs), (arch, name)
        assert dict(_walk(axes)) == dict(_walk(jaxes)), (arch, name)
        assert all(t.device.type == "meta" for _, t in _walk(args))
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            kw = dict(fsdp=True, seq_shard=shape.kind == "long_decode")
            ctx = MeshContext(mesh, default_rules(mesh, **kw))
            jctx = JMeshContext(mesh, j_default_rules(mesh, **kw))
            got = logical_to_pspec(axes, ctx, args)
            sh = spec_tree_for(axes, args, ctx)
            for path, ax, shp in _pspec_pairs(axes, args):
                want = tuple(jctx.pspec(ax, shp))
                assert _at(got, path) == want, (arch, name, multi, path)
                assert _at(sh, path) == NamedSharding(mesh, want)
    assert cells == sum(shape_applicable(cfg, s) for s in ALL_SHAPES.values())


# ---------------------------------------------------------------------------
# make_train_step's argument order, logical_constraint
# ---------------------------------------------------------------------------
def test_make_train_step_signature_matches_reference():
    """The third positional argument is ``compressor`` in both packages;
    the step given ``(model, opt, None, 2)`` is the two-microbatch step."""
    assert list(inspect.signature(make_train_step).parameters) == \
        list(inspect.signature(j_make_train_step).parameters)
    cfg = all_configs()["gemma3-1b"].reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    opt = AdamW(warmup_steps=1, total_steps=10)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                        dtype=torch.int32)
    batch = {"tokens": tok, "targets": tok}
    by_pos = make_train_step(model, opt, None, 2)(params, opt.init(params),
                                                  batch)
    by_kw = make_train_step(model, opt, microbatches=2)(
        params, opt.init(params), batch)
    for a, b in zip(_walk(by_pos[0]), _walk(by_kw[0])):
        assert torch.equal(a[1], b[1]), a[0]


def test_logical_constraint_identity_without_a_dtensor():
    x = torch.randn(2, 3, 4)
    assert logical_constraint(x, "batch", "seq", "embed") is x
    with mesh_context(FakeMesh()):
        assert logical_constraint(x, "batch", "seq", "embed") is x


@pytest.fixture
def mesh11(tmp_path):
    """A (1, 1) ``("data", "model")`` DeviceMesh over a gloo group of this
    process alone, destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_dtensor_redistributed_under_context_and_forward_unchanged(mesh11):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.randn(4, 8, 16)
    d = distribute_tensor(x, mesh11, [Replicate(), Replicate()])
    with mesh_context(mesh11) as ctx:
        assert ctx.pspec(("batch", "seq", "embed"), (4, 8, 16)) == \
            ("data", None, None)
        y = logical_constraint(d, "batch", "seq", "embed")
        assert list(y.placements) == [Shard(0), Replicate()]
        assert torch.equal(y.full_tensor(), x)
        f = logical_constraint(d, None, None, "ffn")
        assert list(f.placements) == [Replicate(), Shard(2)]
    for arch in ("gemma3-1b", "deepseek-v2-lite-16b", "xlstm-125m",
                 "hymba-1.5b", "whisper-base"):
        cfg = all_configs()[arch].reduced()
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                            dtype=torch.int32)
        batch = {"tokens": tok, "targets": tok}
        if cfg.family == "audio":
            batch["audio_embeds"] = torch.randn(
                2, cfg.encoder_seq, cfg.d_model, generator=g)
        plain = model.forward(params, batch)[0]
        with mesh_context(mesh11):
            laid = model.forward(params, batch)[0]
        assert torch.equal(plain, laid), arch
