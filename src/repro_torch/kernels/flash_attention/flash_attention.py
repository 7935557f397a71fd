"""CUDA wrappers of the flash-attention kernels: ``csrc/flash_attention.cu``
(bf16, wgmma fed by TMA), ``csrc/flash_attention_f32.cu`` (float32, 3xTF32
on the tensor cores) and ``csrc/flash_attention_wide.cu`` (float32 head dims
above 256, the same arithmetic over streamed 64-dim chunks).

All replace ``repro.kernels.flash_attention.flash_attention.
flash_attention_bhsd``; ``flash_attention_bhsd`` below picks one by dtype
and head dim (bf16 → ``FLASH_ATTENTION``, float32 → ``FLASH_ATTENTION_F32``,
float32 above 256 → ``FLASH_ATTENTION_WIDE``), and each counts its own
launches.  The source files' headers say what bounds each kernel, how its
tiles are laid out and how it is built.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import CudaKernel

# head dims with an instance, and query rows a block (all sources); above
# the last instance, float32 head dims that are multiples of WIDE_STEP
HEAD_DIMS = (64, 80, 128, 256)
WIDE_STEP = 128
BLOCK_Q = 64
TMA_ALIGN = 16                    # bytes: TMA's base and stride alignment

FLASH_ATTENTION = CudaKernel(
    "flash_attention",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
     ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
     ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int])

_F32_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int]
FLASH_ATTENTION_F32 = CudaKernel("flash_attention_f32", _F32_ARGS)
FLASH_ATTENTION_WIDE = CudaKernel("flash_attention_wide", _F32_ARGS)


class TmaGeometry(NamedTuple):
    """How TMA reads one (B, H, S, D) view: a 4-D tensor map in place.

    ``dims`` are (D, S, H, B), innermost first; ``strides`` the byte
    strides of dims 1..3 (S, H, B); ``box`` the box a load copies, (BW,
    64, 1, 1); ``swizzle`` its shared-memory swizzle in bytes, which is
    also a box row's width (BW bf16 columns).
    """
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    swizzle: int


def tma_problem(t: torch.Tensor) -> Optional[str]:
    """Why TMA cannot read a (B, H, S, D) view in place, or None if it can:
    a head dim that is not contiguous, a base address that is not 16-byte
    aligned, or a stride (of a dim longer than 1) that is not a multiple of
    16 bytes."""
    if t.dim() != 4:
        return f"expected a (B, H, S, D) view, got {t.dim()} dims"
    if t.stride(3) != 1:
        return "the head dim must be contiguous"
    base = t.data_ptr() % TMA_ALIGN
    if base:
        return (f"TMA needs a {TMA_ALIGN}-byte aligned base; this view "
                f"starts {base} bytes past one")
    es = t.element_size()
    for dim in (2, 1, 0):
        st = t.stride(dim) * es
        if t.shape[dim] > 1 and st % TMA_ALIGN:
            return (f"TMA needs strides that are multiples of {TMA_ALIGN} "
                    f"bytes; dim {dim} has {st}")
    return None


def tma_geometry(t: torch.Tensor) -> TmaGeometry:
    """The tensor map of a (B, H, S, D) view for ``csrc/flash_attention.cu``.

    The 128-byte swizzle (boxes of 64 bf16 columns) where D is a multiple
    of 64, else the 32-byte one (boxes of 16: D = 80).  Raises
    ``ValueError`` where TMA cannot read the view in place (``tma_problem``).
    The dim and stride order follow the view, so a (B, S, H, D) tensor
    passed as ``x.transpose(1, 2)`` maps to dims (D, S, H, B) with byte
    strides (H·D, D, S·H·D) × 2.
    """
    problem = tma_problem(t)
    if problem:
        raise ValueError(problem)
    B, H, S, D = t.shape
    sb, sh, ss, _ = t.stride()
    es = t.element_size()
    strides = [ss * es, sh * es, sb * es]
    stepped = [n > 1 for n in (S, H, B)]
    # a dim of size 1 is never stepped: give it a stride TMA accepts
    filler = max([D * es] + [st for st, step in zip(strides, stepped)
                             if step])
    swizzle = 128 if D % 64 == 0 else 32
    return TmaGeometry((D, S, H, B),
                       tuple(st if step else filler
                             for st, step in zip(strides, stepped)),
                       (swizzle // es, BLOCK_Q, 1, 1), swizzle)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool = True
                         ) -> torch.Tensor:
    """Attention over (B, H, S, D) CUDA views (kernel); float32 or bf16,
    output in q's dtype and q's memory layout.

    bf16 goes to the Hopper kernel (``FLASH_ATTENTION``), which reads each
    view in place with TMA: its base must be 16-byte aligned and its
    strides multiples of 16 bytes (``tma_geometry``).  A contiguous
    tensor, ``project_qkv``'s outputs and their (B, S, H, D) →
    (B, H, S, D) transposes all are; a view that is not (a slice one
    element in, say) raises.  float32 goes to the 3xTF32 tensor-core
    kernel (``FLASH_ATTENTION_F32``), which needs only the head dim
    contiguous; float32 head dims above 256 that are multiples of 128 go
    to ``FLASH_ATTENTION_WIDE`` (the entry point pads to one and brings
    bf16 to float32 there).
    This is a dispatch by dtype and head dim: nothing falls back from one
    kernel to another.  Raises on CPU tensors, mismatched shapes, devices
    or dtypes, and head dims the kernels have no instance for.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise ValueError(f"q, k and v must all be float32 or all bfloat16,"
                             f" got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"q, k and v must share one (B, H, S, D) shape, "
                             f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    B, H, S, D = q.shape
    wide = D > HEAD_DIMS[-1]
    if not (D % WIDE_STEP == 0 and q.dtype == torch.float32 if wide
            else D in HEAD_DIMS):
        raise ValueError(f"head dim {D} not supported in {q.dtype}: the "
                         f"kernels take {HEAD_DIMS}, and float32 multiples "
                         f"of {WIDE_STEP} above {HEAD_DIMS[-1]}")
    if B * H * -(-S // BLOCK_Q) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        geo = [tma_geometry(t) for t in (q, k, v)]
        strides = (ctypes.c_uint64 * 9)(*[s for g in geo for s in g.strides])
        FLASH_ATTENTION.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_uint64 * 4)(*geo[0].dims), strides,
            (ctypes.c_uint32 * 4)(*geo[0].box), geo[0].swizzle,
            (ctypes.c_longlong * 3)(*[out.stride(i) for i in (0, 2, 1)]),
            float(scale), int(bool(causal)))
        return out
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)])
    kernel = FLASH_ATTENTION_WIDE if wide else FLASH_ATTENTION_F32
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  strides, B, H, S, D, float(scale), int(bool(causal)))
    return out
