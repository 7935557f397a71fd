"""The port's training launcher (repro_torch.launch.train) against the JAX
package's: the same arguments reach the same model config, layout
decision, loop config, optimizer schedule and failure plan; a short run on
the reduced gemma3-1b on the CPU decides Mode 1 through the port's intent
pipeline, trains, checkpoints and prints the reference's three ``[train]``
lines; without ``--device`` the launcher asks for the card.

Exact comparisons throughout (ints, floats, strings): both launchers do
host arithmetic only before the loop starts.
"""
import dataclasses
import math
import sys

import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.core.intent.selector import select_layout as j_select_layout
from repro.core.workloads import workload_by_name as j_workload_by_name
from repro.train.loop import LoopResult as JLoopResult
from repro_torch.core.layouts import LayoutMode
from repro_torch.launch import train as ttrain
from repro_torch.train.loop import LoopResult

SHORT = ["--device", "cpu", "--steps", "2", "--ckpt-every", "2",
         "--batch", "2", "--seq", "16"]


def _captured(monkeypatch, module, result_cls, argv, run_argv=None):
    """Run ``module.main`` with ``run_training`` replaced by a recorder;
    returns what the launcher handed the loop."""
    seen = {}

    def fake(model, cfg, batch, seq, loop_cfg, optimizer=None,
             failure_plan=None, **kw):
        seen.update(cfg=cfg, batch=batch, seq=seq, loop_cfg=loop_cfg,
                    optimizer=optimizer, plan=failure_plan, kw=kw)
        return result_cls(losses=[1.0, 0.5], final_step=loop_cfg.steps)

    monkeypatch.setattr(module, "run_training", fake)
    if run_argv is None:
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        module.main()
    else:
        module.main(run_argv)
    return seen


def _config_view(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if not isinstance(v, (list, tuple, dict))}


@pytest.mark.parametrize("argv", [
    [], ["--full"], ["--steps", "10", "--fail-rate", "0.3"],
    ["--batch", "2", "--seq", "16", "--ckpt-every", "4", "--lr", "1e-3"],
    ["--full", "--steps", "4", "--ckpt-every", "2", "--batch", "4",
     "--seq", "1024"]])
def test_launcher_hands_the_loop_what_the_reference_does(argv,
                                                          monkeypatch):
    j = _captured(monkeypatch, jtrain, JLoopResult, argv)
    t = _captured(monkeypatch, ttrain, LoopResult, argv,
                  run_argv=argv + ["--device", "cpu"])
    tv, jv = _config_view(t["cfg"]), _config_view(j["cfg"])
    assert {k: tv[k] for k in jv if k in tv} == \
        {k: jv[k] for k in jv if k in tv}
    assert (t["cfg"].name, t["cfg"].num_layers, t["cfg"].d_model) == \
        (j["cfg"].name, j["cfg"].num_layers, j["cfg"].d_model)
    assert (t["batch"], t["seq"]) == (j["batch"], j["seq"])
    tl, jl = t["loop_cfg"], j["loop_cfg"]
    assert (tl.steps, tl.ckpt_every, int(tl.layout_mode), tl.n_bb_nodes,
            tl.microbatches) == \
        (jl.steps, jl.ckpt_every, int(jl.layout_mode), jl.n_bb_nodes,
         jl.microbatches)
    assert tl.layout_policy is None and jl.layout_policy is None
    # the reference writes manifests to /tmp/repro_ckpt; the port to a
    # temporary directory of its own unless --ckpt-dir is given
    assert jl.ckpt_dir == "/tmp/repro_ckpt" and tl.ckpt_dir is None
    to, jo = t["optimizer"], j["optimizer"]
    assert (to.learning_rate, to.warmup_steps, to.total_steps) == \
        (jo.learning_rate, jo.warmup_steps, jo.total_steps)
    assert t["plan"].events == j["plan"].events
    assert t["kw"] == {"device": "cpu"}


def test_launcher_decides_then_trains_on_cpu(capsys):
    torch.set_num_threads(2)
    res = ttrain.main(SHORT)
    out = capsys.readouterr().out.splitlines()
    jd = j_select_layout(j_workload_by_name("IOR-A"))
    assert jd.mode == LayoutMode.NODE_LOCAL
    assert out[0] == (f"[train] Proteus layout decision: Mode "
                      f"{int(jd.mode)} (confidence {jd.confidence:.2f}) — "
                      f"{jd.decision.steps[-1]}")
    assert out[1].startswith("[train] 2 steps in ")
    assert out[2] == (f"[train] loss {res.losses[0]:.4f} -> "
                      f"{res.losses[-1]:.4f}")
    assert out[3] == ("[train] failures: crashes=0 stragglers=0 "
                      "corruptions=0 restores=0 fallbacks=0")
    assert isinstance(res, LoopResult)
    assert res.final_step == 2 and len(res.losses) == 2
    assert all(math.isfinite(x) for x in res.losses)
    assert dataclasses.asdict(res.failure_log) == {
        "crashes": 0, "stragglers": 0, "corruptions": 0, "restores": 0,
        "fallback_restores": 0, "redone_steps": []}
    params, _, cursor = res.state
    assert all(p.device.type == "cpu" for p in
               torch.utils._pytree.tree_leaves(params))
    assert np.asarray(cursor).tolist() != [0, 0]


def test_launcher_trains_on_the_card_unless_told(monkeypatch):
    """No ``--device``: the train state is asked of CUDA, and with no card
    the launcher raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main([a for a in SHORT if a not in ("--device", "cpu")])
    assert ttrain.parse_args([]).device is None
    assert ttrain.parse_args([]).reduced is True
    assert ttrain.parse_args(["--full"]).reduced is False
