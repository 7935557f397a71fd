"""The port's examples (``repro_torch.examples``) print what the JAX
package's ``examples/`` print, line for line, on the CPU: the same
decisions, tables, simulated times and read-backs."""
import contextlib
import importlib.util
import io
from pathlib import Path

import pytest
import torch

from repro_torch.examples import proteus_layout_demo, quickstart

ROOT = Path(__file__).resolve().parents[1]


def _stdout(fn, *args) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue().splitlines(), out


def _reference(name: str):
    """``examples/<name>.py`` of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quickstart_prints_what_the_reference_prints():
    ref, _ = _stdout(_reference("quickstart").main)
    got, client = _stdout(quickstart.main, ["--device", "cpu"])
    assert got == ref
    assert client.device.type == "cpu" and \
        "64 chunks written + read back intact" in "\n".join(got)


def test_layout_demo_prints_what_the_reference_prints():
    ref, _ = _stdout(_reference("proteus_layout_demo").main)
    got, res = _stdout(proteus_layout_demo.main, ["--device", "cpu"])
    assert got == ref
    assert "accuracy: 21/23 = 91.30%  (paper: 91.30%)" in got
    assert res["hits"] == 21
    times = res["times"]
    assert all(times["per-scope policy"] < v for k, v in times.items()
               if k.startswith("uniform"))
    assert res["client"].device.type == "cpu"


def test_examples_default_to_the_card():
    """Without ``--device`` the examples put their tables on CUDA, which
    raises here rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _stdout(quickstart.main, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _stdout(proteus_layout_demo.heterogeneous_plan)
