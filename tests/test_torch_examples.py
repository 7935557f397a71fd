"""The port's examples (``repro_torch.examples``) print what the JAX
package's ``examples/`` print, line for line, on the CPU: the same
decisions, tables, simulated times and read-backs.  The serving example and
``launch/serve.py`` print in the reference's format (their tokens come from
the port's own seeded init, not the reference's)."""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest
import torch

from repro_torch.examples import proteus_layout_demo, quickstart, serve_lm
from repro_torch.launch import serve

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


def _shape_of(line: str) -> str:
    """A printed line with every number replaced by ``N``."""
    return re.sub(r"\d+(\.\d+)?", "N", line)


def _reference_serve_lines(main) -> list:
    """What a reference serving ``main`` prints; it parses ``sys.argv``,
    which is given no arguments here."""
    import sys
    argv = sys.argv
    sys.argv = ["serve"]
    try:
        return _stdout(main)[0]
    finally:
        sys.argv = argv


def test_serve_lm_prints_in_the_reference_format():
    ref = _reference_serve_lines(_reference("serve_lm").main)
    got, gen = _stdout(serve_lm.main, ["--device", "cpu"])
    assert [_shape_of(x) for x in got] == [_shape_of(x) for x in ref]
    assert got[0].startswith("[serve] gemma3-1b: generated 24 tokens × "
                             "batch 4 in ")
    assert gen.shape == (4, 24) and got[1] == \
        f"[serve] first sequence: {gen[0].tolist()}"


def test_serve_cli_prints_in_the_reference_format():
    """``python -m repro_torch.launch.serve`` against the reference's
    ``repro.launch.serve``."""
    from repro.launch import serve as j_serve
    ref = _reference_serve_lines(j_serve.main)
    got, gen = _stdout(serve.main, ["--device", "cpu", "--arch",
                                    "minitron-8b"])
    assert [_shape_of(x) for x in got] == [_shape_of(x) for x in ref]
    assert gen.shape == (4, 32) and got[0].startswith(
        "[serve] generated (4, 32) in ")
    assert got[1] == f"[serve] sample: {gen[0][:16].tolist()}"
    assert ((0 <= gen) & (gen < 256)).all()
