"""Batched golden-section RA solve: the wrapper of the CUDA kernel.

The kernel (``csrc/golden_section.cu``) replaces
``repro/kernels/golden_section.py::_golden_section_kernel``, the Pallas TPU
kernel. Its bound on the H100 is float32 ALU work (cbrt, divides) and its
dependent chain, not bytes: each input is read once and each output written
once, while every active slot runs some 650 fixed-point steps. One warp
per group packs the group's active slots onto its lanes and keeps the
whole iteration in registers, with only warp shuffles between steps; a
group too wide for one warp gets a block of its own (``ref.GS_*`` is the
dispatch table).

A CPU tensor goes to the plain version, :func:`repro_torch.kernels.ref.
golden_section_ref`. A CUDA tensor launches the kernel or raises; nothing
falls back. ``LAUNCHES`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
MAX_R = ref.MAX_R      # widest group the kernel takes

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _library(*defines: str) -> ctypes.CDLL:
    """The kernel's library, built at first use. ``defines`` are ``-D``
    macros of the source; ``GS_CBRT_F32`` builds the cbrtf variant, which
    only ``chip_smoke.py`` loads, to measure it."""
    lib = build.load("golden_section", defines).lib
    fn = lib.golden_section_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.golden_section_error_string.argtypes = [ctypes.c_int]
        lib.golden_section_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, b, d, e, w, f_min, f_max, mask):
    if a.dim() != 2:
        raise ValueError(f"constants must be (G, R), got {tuple(a.shape)}")
    g, r = a.shape
    for name, x in (("a", a), ("b", b), ("d", d), ("e", e),
                    ("f_min", f_min), ("f_max", f_max), ("mask", mask)):
        if tuple(x.shape) != (g, r):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {(g, r)}")
    if tuple(w.shape) != (g,):
        raise ValueError(f"w has shape {tuple(w.shape)}, expected {(g,)}")
    for name, x in (("a", a), ("b", b), ("d", d), ("e", e), ("w", w),
                    ("f_min", f_min), ("f_max", f_max)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    devices = {x.device for x in (a, b, d, e, w, f_min, f_max, mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def golden_section_solve(a, b, d, e, w, f_min, f_max, mask, *,
                         n_golden: int = 48, n_inner: int = 12,
                         n_bracket: int = 60):
    """Solve G groups of problem (18) along the KKT deadline path.

    ``a, b, d, e, f_min, f_max`` float32 and ``mask`` bool, all ``(G, R)``;
    ``w`` float32 ``(G,)``. Returns ``(f (G, R), beta (G, R), cost (G,),
    deadline (G,))``.
    """
    global LAUNCHES
    _check(a, b, d, e, w, f_min, f_max, mask)
    if a.device.type == "cpu":
        return ref.golden_section_ref(a, b, d, e, w, f_min, f_max, mask,
                                      n_golden=n_golden, n_inner=n_inner,
                                      n_bracket=n_bracket)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    ins = (a, b, d, e, w, f_min, f_max, mask)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("golden_section_solve needs contiguous inputs")
    out = launch(ins, n_golden=n_golden, n_inner=n_inner,
                 n_bracket=n_bracket)
    LAUNCHES += 1
    return out


def launch(ins, *, n_golden: int, n_inner: int, n_bracket: int,
           defines: tuple[str, ...] = ()):
    """Launch the kernel built with ``defines`` (see :func:`_library`) on
    checked contiguous CUDA inputs ``ins`` = ``(a, b, d, e, w, f_min, f_max,
    mask)`` on the current stream, without counting it. Returns ``(f, beta,
    cost, deadline)``."""
    a = ins[0]
    g, r = a.shape
    if r > MAX_R:
        raise ValueError(f"group width {r} exceeds the kernel's {MAX_R}")
    f = torch.empty_like(a)
    beta = torch.empty_like(a)
    cost = torch.empty(g, dtype=a.dtype, device=a.device)
    deadline = torch.empty_like(cost)
    lib = _library(*defines)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.golden_section_launch(
        *(x.data_ptr() for x in (*ins, f, beta, cost, deadline)),
        g, r, n_golden, n_inner, n_bracket, stream)
    if rc != 0:
        raise RuntimeError("golden_section kernel launch failed: "
                           + lib.golden_section_error_string(rc).decode())
    return f, beta, cost, deadline
