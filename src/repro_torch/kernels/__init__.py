"""Hand-written Hopper kernels of the port, and their build.

Each kernel is one CUDA C++ source ``csrc/<name>.cu`` exposing a plain C
entry point ``int <name>(..., void *stream)`` that launches on the given
stream and returns ``cudaGetLastError()``.  At first use the source is
compiled by ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at the
repository root (the hash is the source's, so an edited source never loads
a stale library) and bound with ``ctypes``.  No PyTorch header is involved,
so a build takes seconds.  A failed build raises: nothing falls back to the
plain version.

Kernels (one subpackage each, mirroring ``repro.kernels``):

* ``chunk_router`` — ``dest_histogram2d``: per-row destination histogram of
  the exchange planner; ``dest_histogram``: destination histogram of one
  vector (``histogram_rows``); ``route_chunks``: per-chunk destinations
  (and a destination histogram) of one vector of descriptors, and
  ``route_chunks_segmented`` (same source): the destinations of every
  chunk of a whole checkpoint, one launch a save or restore;
* ``chunk_pack`` — ``pack_chunks``: the send-order row gather;
* ``fletcher`` — ``fletcher``: per-chunk checksums of a checkpoint leaf;
* ``flash_attention`` — ``flash_attention``: blocked online-softmax
  attention over (B, S, H, D) q/k/v in bf16 (wgmma fed by TMA);
  ``flash_attention_f32``: the same in float32 (3xTF32 on the tensor
  cores).

Each subpackage holds ``<name>.py`` (the CUDA wrapper and its launch
count), ``ops.py`` (dispatch: the kernel for CUDA tensors, the plain
version for CPU tensors) and ``ref.py`` (the plain PyTorch version).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("dest_histogram2d", "pack_chunks", "fletcher", "route_chunks",
           "dest_histogram", "flash_attention", "flash_attention_f32")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ on a machine with the CUDA "
                           "toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is (or will be) built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    return BUILD / f"lib{name}-{hashlib.sha256(src).hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, all in parallel.

    Returns ``{name: compiler report}`` (``-Xptxas -v``: registers, shared
    memory and spills per kernel) for the kernels compiled by this call.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD / f".lib{name}-{os.getpid()}.so"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


class CudaKernel:
    """One C entry point ``name`` of ``csrc/<source>.cu`` (``source``
    defaults to ``name``): lazy build, binding, launch count.

    ``launches`` counts the successful launches of this kernel in the
    process; the wrappers call ``launch`` exactly where the kernel runs.
    """

    def __init__(self, name: str, argtypes: Sequence, source: str = None):
        self.name = name
        self.source = source or name
        self.argtypes = list(argtypes) + [ctypes.c_void_p]    # + stream
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        """Launch on PyTorch's current stream; raise on a CUDA error."""
        if self._fn is None:
            fn = getattr(load(self.source), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1


def check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int,
               device: torch.device = None) -> None:
    """Validate one tensor argument of a CUDA wrapper (raise on misuse)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
