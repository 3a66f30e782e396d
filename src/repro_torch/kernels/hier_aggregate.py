"""Eq. (8)/(14) weighted mean over a client stack: the wrapper of the CUDA
kernel.

The kernel (``csrc/hier_aggregate.cu``) replaces
``repro/kernels/hier_aggregate.py::_agg_kernel``, the Pallas TPU kernel.
Its bound on the H100 is bytes: it reads the ``(C, P)`` stack once and
writes ``(P,)``. Each thread streams the rows of a few consecutive columns
with vector loads, so every row read is coalesced; the rows of a column
tile are split over the blocks of a thread block cluster
(``ref.agg_splits``), whose partial sums meet in shared memory.

A CPU tensor goes to the plain version, :func:`repro_torch.kernels.ref.
hier_aggregate_ref`. A CUDA tensor launches the kernel or raises; nothing
falls back. ``LAUNCHES`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0

# dtype code of the C entry point, and the vector widths (elements per
# thread) the kernel is instantiated for, widest first
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC_WIDTHS = {torch.float32: (4, 2, 1), torch.bfloat16: (8, 4, 2, 1)}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load("hier_aggregate").lib
    fn = lib.hier_aggregate_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.hier_aggregate_error_string.argtypes = [ctypes.c_int]
        lib.hier_aggregate_error_string.restype = ctypes.c_char_p
    return lib


def vector_width(updates: torch.Tensor) -> int:
    """The widest vector the kernel can load ``updates``' rows with: P a
    multiple of it and the base address aligned to it (then every row is)."""
    p, size = updates.shape[1], updates.element_size()
    return next(v for v in VEC_WIDTHS[updates.dtype]
                if p % v == 0 and updates.data_ptr() % (v * size) == 0)


def _check(updates, weights):
    if updates.dim() != 2 or 0 in updates.shape:
        raise ValueError("updates must be a non-empty (C, P) matrix, got "
                         f"{tuple(updates.shape)}")
    if tuple(weights.shape) != updates.shape[:1]:
        raise ValueError(f"weights have shape {tuple(weights.shape)}, "
                         f"expected {tuple(updates.shape[:1])}")
    if updates.dtype not in DTYPES:
        raise TypeError(f"updates must be float32 or bfloat16, got "
                        f"{updates.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if updates.device != weights.device:
        raise ValueError(f"inputs lie on several devices: {updates.device}, "
                         f"{weights.device}")


def hier_aggregate(updates: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """``updates`` (C, P) float32 or bfloat16, ``weights`` (C,) float32 ->
    the weighted average (P,) in ``updates``' dtype, accumulated in float32,
    weights normalised by ``max(sum, 1e-30)``."""
    global LAUNCHES
    _check(updates, weights)
    if updates.device.type == "cpu":
        return ref.hier_aggregate_ref(updates, weights)
    if updates.device.type != "cuda":
        raise ValueError(f"no kernel for device {updates.device}")
    if not (updates.is_contiguous() and weights.is_contiguous()):
        raise ValueError("hier_aggregate needs contiguous inputs")
    c, p = updates.shape
    out = torch.empty(p, dtype=updates.dtype, device=updates.device)
    lib = _library()
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.hier_aggregate_launch(
        updates.data_ptr(), weights.data_ptr(), out.data_ptr(), c, p,
        DTYPES[updates.dtype], vector_width(updates), *ref.agg_splits(c, p),
        stream)
    if rc != 0:
        raise RuntimeError("hier_aggregate kernel launch failed: "
                           + lib.hier_aggregate_error_string(rc).decode())
    LAUNCHES += 1
    return out
