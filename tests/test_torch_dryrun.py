"""The port's dry run: operation counts on meta tensors, the roofline, the
model cells and the CLI, against the JAX package where it has a twin.

The FLOP counts of the reduced gemma3-1b and deepseek-v2-lite-16b
``loss_fn`` are held against the reference's ``analyze_hlo`` of its
compiled module, dot by dot: at S 128 the reference's blocked attention
forms compute over more keys than the port's masked form (the online
softmax pads the keys to its 512-key block; the batched windowed form gives
each query block its window's W + Bq keys), so those dots are named and
counted apart, and everything else — projections, MLPs, the MoE experts
and router, MLA's latent projections, the chunked unembedding — agrees.
"""
import ast
import collections
import dataclasses
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.analysis.hlo_parse import _dot_flops, analyze_hlo, parse_module
from repro.analysis.roofline import RooflineReport as JRooflineReport
from repro.configs import all_configs as j_all_configs
from repro.models.registry import build_model as j_build_model
from repro_torch.analysis.costs import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.analysis.op_costs import count_costs
from repro_torch.analysis.roofline import (RooflineReport, model_flops_for,
                                           sharding_collectives)
from repro_torch.configs import ALL_SHAPES, all_configs, shape_applicable
from repro_torch.distributed.sharding import (MeshContext, NamedSharding,
                                              default_rules, spec_tree_for,
                                              tree_leaves)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.registry import build_model

ROOT = Path(__file__).resolve().parents[1]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_count_costs_counts_a_matmul_chain_exactly():
    x, w1, b1 = _meta(8, 16), _meta(32, 16), _meta(32)
    w2, a3, b3 = _meta(32, 4), _meta(3, 4, 5), _meta(3, 5, 6)
    c3 = _meta(3, 4, 6)

    def chain(x, w1, b1, w2, a3, b3, c3):
        h = torch.relu(F.linear(x, w1, b1))        # addmm (8,16)x(16,32)
        y = h @ w2                                  # mm (8,32)x(32,4)
        z = torch.baddbmm(c3, a3, b3)               # (3,4,5)x(3,5,6)
        return y, torch.bmm(a3, b3) + z             # bmm

    (y, z), c = count_costs(chain, x, w1, b1, w2, a3, b3, c3)
    assert y.device.type == "meta" and tuple(z.shape) == (3, 4, 6)
    want = 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4 + 2 * (2 * 3 * 4 * 5 * 6)
    assert c.flops == want
    assert c.table["aten.addmm"][:2] == [1, 2 * 8 * 16 * 32]
    assert c.table["aten.bmm"][:2] == [1, 2 * 3 * 4 * 5 * 6]
    # a matmul moves its operands and result; relu its result; views none
    assert c.table["aten.mm"][2] == 4 * (8 * 32 + 32 * 4 + 8 * 4)
    assert c.table["aten.relu"][2] == 4 * 8 * 32
    assert "aten.t" not in c.table or c.table["aten.t"][2] == 0
    assert c.collective_bytes == {} and c.total_collective() == 0


def test_dryrun_skip_logic():
    cfgs = all_configs()
    long = ALL_SHAPES["long_500k"]
    assert shape_applicable(cfgs["xlstm-125m"], long)
    assert shape_applicable(cfgs["hymba-1.5b"], long)
    assert shape_applicable(cfgs["gemma3-1b"], long)
    assert not shape_applicable(cfgs["gemma-7b"], long)
    assert not shape_applicable(cfgs["qwen1.5-110b"], long)
    assert not shape_applicable(cfgs["whisper-base"], long)


def _reference_record_keys():
    """The keys of the reference's ``ok`` record, read from its source
    (its ``run_cell`` needs 512 placeholder devices and minutes)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(v, ast.Constant) and v.value == "ok"
                for v in node.values):
            return [k.value for k in node.keys]
    raise AssertionError("no ok record in the reference's dry run")


def test_h100_constants():
    assert (PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)


def test_run_cell_full_width_record(tmp_path):
    rec = dryrun.run_cell("gemma3-1b", "decode_32k", "single", tmp_path,
                          save_hlo=True)
    assert list(rec) == _reference_record_keys()
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["compile_s"] == 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] == "unavailable"
    assert [f.name for f in dataclasses.fields(RooflineReport)] == \
        [f.name for f in dataclasses.fields(JRooflineReport)]
    r = rec["roofline"]
    assert 0 < r["useful_ratio"] <= 1.2
    assert r["compute_s"] == r["device_flops"] / 989e12
    assert r["bottleneck"] == max(("compute", "memory", "collective"),
                                  key=lambda k: r[f"{k}_s"])
    assert rec["cost_analysis"] == {"flops": r["device_flops"],
                                    "bytes accessed":
                                    r["device_traffic_bytes"]}
    # argument bytes: every leaf's shard, counted from the specs by hand
    cfg, shape = all_configs()["gemma3-1b"], ALL_SHAPES["decode_32k"]
    mesh = make_production_mesh()
    ctx = MeshContext(mesh, default_rules(mesh))
    args, axes = input_specs(cfg, shape)
    total = 0
    for t, sh in zip(tree_leaves(args), tree_leaves(
            spec_tree_for(axes, args, ctx))):
        div = math.prod(mesh.shape[a] for p in sh.spec if p
                        for a in (p if isinstance(p, tuple) else (p,)))
        total += t.numel() * t.element_size() // div
    assert rec["memory_analysis"]["argument_size_in_bytes"] == total
    on_disk = json.loads((tmp_path / "gemma3-1b__decode_32k__single.json")
                         .read_text())
    assert on_disk == rec
    table = (tmp_path / "gemma3-1b__decode_32k__single.ops.txt").read_text()
    assert table.startswith("op\tcount\tflops\tbytes\n") and "aten.mm" in table


def test_sharding_collectives_rule():
    mesh = make_production_mesh(multi_pod=True)
    t = _meta(1024, 512)
    fsdp = NamedSharding(mesh, (("pod", "data"), "model"))
    tp = NamedSharding(mesh, (None, "model"))
    shard = 1024 * 512 * 4 / 512
    assert sharding_collectives([(t, fsdp), (t, tp)], train=False) == \
        {"all-gather": shard}
    assert sharding_collectives([(t, fsdp), (t, tp)], train=True) == \
        {"all-gather": 2 * shard, "reduce-scatter": 32 * shard}


def test_cli_cells_and_failures(tmp_path, capsys):
    dryrun.main(["--arch", "gemma-7b", "--shape", "long_500k", "--mesh",
                 "multi", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "gemma-7b__long_500k__multi.json")
                     .read_text())
    assert rec["status"] == "skipped" and rec["reason"]
    dryrun.main(["--arch", "gemma-7b", "--shape", "long_500k",
                 "--skip-existing", "--out", str(tmp_path), "--mesh",
                 "multi"])
    assert "skip existing" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "no-such-arch__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "error"


def test_model_flops_match_reference():
    from repro.analysis.roofline import model_flops_for as j_model_flops
    from repro.configs import ALL_SHAPES as J_SHAPES
    for name, cfg in all_configs().items():
        for s, shape in ALL_SHAPES.items():
            assert model_flops_for(cfg, shape) == j_model_flops(
                j_all_configs()[name], J_SHAPES[s])


# ---------------------------------------------------------------------------
# FLOPs of the reduced gemma3-1b loss against the reference's dots
# ---------------------------------------------------------------------------
B, S = 2, 128


def _reference_dots(cfg):
    """(total dot FLOPs, {category: FLOPs}) of the reference's compiled
    ``loss_fn`` (``analyze_hlo``'s count, loop bodies scaled by their trip
    counts); attention dots are those with a 4-D result, all in the entry
    computation (the layers are unrolled), the rest "other"."""
    model = j_build_model(cfg)
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "targets")}
    hlo = jax.jit(lambda p, b: model.loss_fn(p, b)[0]).lower(
        model.abstract_params(), batch).compile().as_text()
    comps, entry = parse_module(hlo)
    cats = collections.Counter()
    for comp in comps.values():
        for ins in comp.instrs.values():
            rank = len(re.search(r"\[([0-9,]*)\]", ins.out_type)
                       .group(1).split(","))
            if ins.op == "dot" and rank == 4:
                assert comp.name == entry, comp.name
                cats["attention"] += _dot_flops(ins, comp, comps)
    total = analyze_hlo(hlo).flops
    cats["other"] = total - cats["attention"]
    return total, cats


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v2-lite-16b"])
def test_loss_flops_against_reference_dots(arch):
    jcfg = j_all_configs()[arch].reduced()
    cfg = all_configs()[arch].reduced()
    ref_total, ref = _reference_dots(jcfg)
    model = build_model(cfg)
    batch = {k: _meta(B, S, dtype=torch.int32) for k in ("tokens",
                                                         "targets")}
    _, c = count_costs(lambda p, b: model.loss_fn(p, b)[0],
                       model.abstract_params(), batch)
    H, W = cfg.num_heads, cfg.window_size
    # MLA's prefill runs both products at head dim dn + dr (v padded)
    D = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim if cfg.use_mla
         else cfg.head_dim)
    n_local = sum(k == "local" for k in cfg.layer_kinds) if W else 0
    n_full = cfg.num_layers - n_local
    # the port: the masked form at S 128, QK^T and PV over all S keys
    port_attn = cfg.num_layers * 2 * (2 * B * H * S * S * D)
    # the reference: the online softmax pads the keys to its 512 block;
    # the batched windowed form (one q block of Bq = S) sees W + S keys
    blk = 512 * -(-S // 512)
    ref_attn = n_full * 2 * (2 * B * H * S * blk * D) + \
        n_local * 2 * (2 * B * H * S * (W + S) * D)
    assert ref["attention"] == ref_attn
    assert c.table["aten.bmm"][1] >= port_attn
    port_other = c.flops - port_attn
    assert abs(port_other - ref["other"]) <= 0.01 * ref["other"]
    # the gap the whole counts show (gemma 0.809, deepseek 0.482) is those
    # attention shapes
    assert c.flops / ref_total == pytest.approx(
        (ref["other"] + port_attn) / ref_total, rel=0.01)
