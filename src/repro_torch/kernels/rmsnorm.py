"""Fused RMSNorm: the wrapper of the CUDA kernel.

The kernel (``csrc/rmsnorm.cu``) replaces
``repro/kernels/rmsnorm.py::_rmsnorm_kernel``, the Pallas TPU kernel. Its
bound on the H100 is bytes: it reads ``x`` once and writes ``y`` once. One
warp normalises one row with vector loads, so every read is coalesced, and
holds the row in registers between its two passes.

The JAX package's models do not call their kernel: they normalise with
``layers.apply_norm``, which computes the same function. The port's
``apply_norm`` sends RMSNorm with a scale here, so the serving path runs
this kernel (57 launches per qwen3-0.6b forward or decode step).

A CPU tensor goes to the plain version, :func:`repro_torch.kernels.ref.
rmsnorm_ref`. A CUDA tensor launches the kernel or raises; nothing falls
back. ``LAUNCHES`` counts kernel launches, and only those.

Gradients go through :class:`RMSNormFn` on both devices: its forward is
:func:`rmsnorm` (the kernel on the card), its backward the closed form of
:func:`rmsnorm_bwd` in plain PyTorch, the same code on the CPU and the
card (the JAX package differentiates its plain ``apply_norm`` with XLA).
:func:`repro_torch.kernels.ops.rmsnorm` takes the Function whenever an
input needs a gradient. ``BACKWARD_CALLS`` counts its backward calls.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref

LAUNCHES = 0
BACKWARD_CALLS = 0

# dtype code of the C entry point, and the vector widths (elements per
# load) the kernel is instantiated for, widest first
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC_WIDTHS = {torch.float32: (4, 2, 1), torch.bfloat16: (8, 4, 2, 1)}

# vectors per lane the kernel holds in registers between its two passes
# (its launch_k<T, V, K> instantiations); a wider row reads the rest twice
HELD_VECTORS = (4, 8, 16, 24)

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load("rmsnorm").lib
    fn = lib.rmsnorm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def vector_width(d: int, dtype: torch.dtype) -> int:
    """The widest vector that divides the row length ``d``; the plain
    version sums in the order this width gives."""
    return next(v for v in VEC_WIDTHS[dtype] if d % v == 0)


def held_vectors(d: int, vec: int) -> int:
    """The register budget K (vectors per lane) the kernel picks for rows
    of ``d`` elements loaded ``vec`` at a time: the smallest that holds the
    row, else the largest. It changes where the row lives, not the order
    of the arithmetic."""
    per_lane = -(-(d // vec) // 32)
    return next((k for k in HELD_VECTORS if per_lane <= k), HELD_VECTORS[-1])


def _check(x, scale):
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"x must be non-empty, got {tuple(x.shape)}")
    if tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"scale has shape {tuple(scale.shape)}, expected "
                         f"({x.shape[-1]},)")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not scale.is_floating_point():
        raise TypeError(f"scale must be floating point, got {scale.dtype}")
    if x.device != scale.device:
        raise ValueError(f"inputs lie on several devices: {x.device}, "
                         f"{scale.device}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x`` (..., d) float32 or bfloat16, ``scale`` (d,) -> RMSNorm of
    each row with float32 statistics, in ``x``'s dtype."""
    global LAUNCHES
    _check(x, scale)
    d = x.shape[-1]
    vec = vector_width(d, x.dtype)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps, vec=vec)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm needs a contiguous x")
    if x.data_ptr() % (vec * x.element_size()):
        raise ValueError(f"rmsnorm needs x aligned to {vec} elements")
    scale = scale.to(torch.float32).contiguous()
    if scale.data_ptr() % 16:            # the kernel reads it as float4s
        scale = scale.clone()
    y = torch.empty_like(x)
    lib = _library()
    # the raw handle of the current stream, as PyTorch's own generated code
    # reads it: no Stream object per call (a decode step makes 57 calls)
    rc = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                            x.numel() // d, d, eps, DTYPES[x.dtype], vec,
                            torch._C._cuda_getCurrentRawStream(x.device.index))
    if rc != 0:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.rmsnorm_error_string(rc).decode())
    LAUNCHES += 1
    return y


# :func:`rmsnorm` as a PyTorch operator, ``repro_torch::rmsnorm``
# (dispatching as above; a fake implementation for fake tensors, a FLOP
# formula for ``FlopCounterMode``). It is defined through a ``Library``
# rather than ``torch.library.custom_op``, whose Python wrapper costs
# several times the host time a call.

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("rmsnorm(Tensor x, Tensor scale, float eps) -> Tensor")
_LIB.impl("rmsnorm", lambda x, scale, eps: rmsnorm(x, scale, eps=eps),
          "CompositeExplicitAutograd")
rmsnorm_op = torch.ops.repro_torch.rmsnorm.default


@torch.library.register_fake("repro_torch::rmsnorm", lib=_LIB)
def _(x, scale, eps):
    _check(x, scale)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.rmsnorm)
def _(x_shape, *args, out_shape=None, **kwargs) -> int:
    """4 operations an element (square, add, two multiplies): the bound's
    count."""
    n = 1
    for d in x_shape:
        n *= d
    return 4 * n


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The VJP of :func:`rmsnorm` at ``(x, scale)`` for the output
    cotangent ``g``, in float32: with ``r = rsqrt(mean(x^2) + eps)`` and
    ``gs = g * scale``, ``dx = r * (gs - x * r^2 * mean(gs * x))`` (cast
    to x's dtype) and ``dscale = sum over rows of g * x * r`` (in scale's
    dtype)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(torch.float32)
    gf = g.reshape(-1, d).to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gs = gf * scale.to(torch.float32)
    dx = r * (gs - xf * (r * r) * torch.mean(gs * xf, dim=-1, keepdim=True))
    dscale = torch.sum(gf * xf * r, dim=0)
    return dx.to(x.dtype).reshape(x.shape), dscale.to(scale.dtype)


class RMSNormFn(torch.autograd.Function):
    """:func:`rmsnorm` with :func:`rmsnorm_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_op(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        global BACKWARD_CALLS
        x, scale = ctx.saved_tensors
        with torch.profiler.record_function("rmsnorm_bwd"):
            dx, dscale = rmsnorm_bwd(x, scale, g, eps=ctx.eps)
        BACKWARD_CALLS += 1
        return dx, dscale, None
