"""The ``examples/train_lm`` twin (``repro_torch.examples.train_lm``)
against the JAX package's example on the CPU: its printed lines, the
fault-tolerant loop's ``FailureLog`` and final step under the example's
random failure plan, and ``chip_smoke.py``'s pin of them."""
import contextlib
import dataclasses
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue().splitlines(), out


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_example_matches_reference(tmp_path, monkeypatch):
    """The twin at 40 steps on the CPU (reduced xlstm-125m, two stragglers,
    saves at 20 and 40) prints the reference example's ``[proteus]``,
    ``[failure-plan]`` and ``survived`` lines, its loss line in the
    reference's format, and ends with the reference loop's FailureLog and
    step; ``chip_smoke.py`` pins the same (``TRAIN_LM_EXPECTED``)."""
    from repro_torch.examples import train_lm
    chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    ref = _load("reference_example_train_lm",
                ROOT / "examples" / "train_lm.py")
    results = []
    real_config, real_run = ref.LoopConfig, ref.run_training

    def config(**kw):      # the reference example's manifests to tmp_path
        return real_config(**{**kw, "ckpt_dir": str(tmp_path / "jax")})

    def run(*a, **kw):
        results.append(real_run(*a, **kw))
        return results[-1]
    monkeypatch.setattr(ref, "LoopConfig", config)
    monkeypatch.setattr(ref, "run_training", run)
    monkeypatch.setattr("sys.argv", ["train_lm.py", "--steps", "40"])
    want, _ = _stdout(ref.main)
    got, res = _stdout(train_lm.main, ["--steps", "40", "--device", "cpu"])
    assert got[:2] == want[:2] and got[3] == want[3], (got, want)
    assert re.fullmatch(r"\[train\] 40 steps in \d+s; loss [0-9.]+ → "
                        r"[0-9.]+", got[2]), got[2]
    jlog = results[0].failure_log
    assert dataclasses.asdict(res.failure_log) == dataclasses.asdict(jlog)
    assert res.final_step == results[0].final_step == 40
    assert np.isfinite(res.losses).all()
    assert chip_smoke.TRAIN_LM_EXPECTED == (
        dataclasses.asdict(jlog), results[0].final_step)
