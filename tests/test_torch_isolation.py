"""The port stands alone: importing any of repro_torch loads neither JAX nor
the JAX package, no source of the port (or chip_smoke.py) imports them, and
nothing builds or touches a card at import time."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_and_no_reference(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_module():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))
    code = textwrap.dedent(f"""
        import sys
        for m in {mods!r}:
            __import__(m)
        import repro_torch.core.adapt, repro_torch.core.obs
        import repro_torch.core.intent, repro_torch.core.intent.staticlib
        import repro_torch.launch.train, repro_torch.launch.dryrun
        import repro_torch.core.mesh_engine
        import repro_torch.examples.quickstart
        import repro_torch.examples.proteus_layout_demo
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert "repro_torch.core.adapt.controller" in sys.modules
        assert "repro_torch.core.obs.recorder" in sys.modules
        assert "repro_torch.core.intent.selector" in sys.modules
        assert "repro_torch.core.intent.staticlib.analyzer" in sys.modules
        assert "repro_torch.core.workloads" in sys.modules
        assert "repro_torch.core.mesh_engine" in sys.modules
        assert "repro_torch.launch.dryrun" in sys.modules
        assert "repro_torch.examples.proteus_layout_demo" in sys.modules
        import torch.distributed as dist
        assert not dist.is_initialized(), "a process group at import time"
        from repro_torch import kernels
        assert not kernels._LIBS, "a kernel was built at import time"
        print("ok", len({mods!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_to_run_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin",
                                        "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
