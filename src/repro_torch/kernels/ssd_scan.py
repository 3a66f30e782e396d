"""Mamba2 SSD inter-chunk state recurrence: the wrapper of the CUDA kernel.

The kernel (``csrc/ssd_scan.cu``) replaces
``repro/kernels/ssd_scan.py::_scan_kernel``, the Pallas TPU kernel. Its
bound on the H100 is bytes: it reads ``states`` once and writes the
entering states and the final one once. One thread owns one (b, h, n, p)
element and walks the chunks with its float32 carry in a register.

The JAX package's ``models/ssm.py::ssd_chunked`` runs the same recurrence
inline in its ``lax.scan``; the port's ``ssd_chunked`` computes every
chunk's state at once and sends the recurrence here, so every SSM layer's
prefill runs this kernel (48 launches per mamba2-1.3b forward).

A CPU tensor goes to the plain version, :func:`repro_torch.kernels.ref.
ssd_state_scan_ref`. A CUDA tensor launches the kernel or raises; nothing
falls back. ``LAUNCHES`` counts kernel launches, and only those.

Gradients go through :class:`SSDStateScanFn` on both devices: its forward
is :func:`ssd_state_scan` (the kernel on the card), its backward the
reverse recurrence of :func:`ssd_state_scan_bwd` in plain PyTorch, the
same code on the CPU and the card (the JAX package's gradient comes from
XLA's autodiff of its ``lax.scan``).
:func:`repro_torch.kernels.ops.ssd_state_scan` takes the Function whenever
an input needs a gradient. ``BACKWARD_CALLS`` counts its backward calls.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref

LAUNCHES = 0
BACKWARD_CALLS = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # dtype code of states

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan").lib
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(states, decay, initial_state):
    if states.dim() != 5 or 0 in states.shape:
        raise ValueError(f"states must be a non-empty (NC, B, H, N, P), got "
                         f"{tuple(states.shape)}")
    nc, b, h, n, p = states.shape
    if tuple(decay.shape) != (nc, b, h):
        raise ValueError(f"decay has shape {tuple(decay.shape)}, expected "
                         f"{(nc, b, h)}")
    if initial_state is not None and tuple(initial_state.shape) != (b, h, n,
                                                                    p):
        raise ValueError(f"initial_state has shape "
                         f"{tuple(initial_state.shape)}, expected "
                         f"{(b, h, n, p)}")
    if states.dtype not in DTYPES:
        raise TypeError(f"states must be float32 or bfloat16, got "
                        f"{states.dtype}")
    others = [decay] + ([] if initial_state is None else [initial_state])
    if not all(t.is_floating_point() for t in others):
        raise TypeError("decay and initial_state must be floating point")
    if any(t.device != states.device for t in others):
        raise ValueError(f"inputs lie on several devices: "
                         f"{[str(t.device) for t in [states, *others]]}")


def ssd_state_scan(states: torch.Tensor, decay: torch.Tensor,
                   initial_state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``states`` (NC, B, H, N, P) float32 or bfloat16, ``decay``
    (NC, B, H), ``initial_state`` (B, H, N, P) or None -> (entering
    (NC, B, H, N, P), final (B, H, N, P)) in ``states``' dtype, with a
    float32 carry."""
    global LAUNCHES
    _check(states, decay, initial_state)
    if states.device.type == "cpu":
        return ref.ssd_state_scan_ref(states, decay, initial_state)
    if states.device.type != "cuda":
        raise ValueError(f"no kernel for device {states.device}")
    if not states.is_contiguous():
        raise ValueError("ssd_state_scan needs contiguous states")
    nc, b, h, n, p = states.shape
    decay = decay.to(torch.float32).contiguous()
    init = (None if initial_state is None
            else initial_state.to(torch.float32).contiguous())
    entering = torch.empty_like(states)
    final = torch.empty((b, h, n, p), dtype=states.dtype,
                        device=states.device)
    lib = _library()
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.ssd_scan_launch(states.data_ptr(), decay.data_ptr(),
                             None if init is None else init.data_ptr(),
                             entering.data_ptr(), final.data_ptr(), nc,
                             b * h, n * p, DTYPES[states.dtype], stream)
    if rc != 0:
        raise RuntimeError("ssd_state_scan kernel launch failed: "
                           + lib.ssd_scan_error_string(rc).decode())
    LAUNCHES += 1
    return entering, final


# :func:`ssd_state_scan` as a PyTorch operator,
# ``repro_torch::ssd_state_scan`` (dispatching as above; a fake
# implementation for fake tensors, a FLOP formula for ``FlopCounterMode``),
# defined through a ``Library`` as ``rmsnorm``'s is

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_state_scan(Tensor states, Tensor decay, "
            "Tensor? initial_state) -> (Tensor, Tensor)")
_LIB.impl("ssd_state_scan",
          lambda states, decay, initial_state: ssd_state_scan(
              states, decay, initial_state), "CompositeExplicitAutograd")
ssd_state_scan_op = torch.ops.repro_torch.ssd_state_scan.default


@torch.library.register_fake("repro_torch::ssd_state_scan", lib=_LIB)
def _(states, decay, initial_state):
    _check(states, decay, initial_state)
    _, b, h, n, p = states.shape
    return (torch.empty_like(states, memory_format=torch.contiguous_format),
            states.new_empty((b, h, n, p)))


@register_flop_formula(torch.ops.repro_torch.ssd_state_scan)
def _(states_shape, *args, out_shape=None, **kwargs) -> int:
    """A multiply and an add per state element: the bound's count."""
    n = 1
    for d in states_shape:
        n *= d
    return 2 * n


def ssd_state_scan_bwd(decay: torch.Tensor, entering: torch.Tensor,
                       g_entering: torch.Tensor, g_final: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The VJP of :func:`ssd_state_scan` for the cotangents ``g_entering``
    (NC, B, H, N, P) and ``g_final`` (B, H, N, P), given ``decay`` and the
    forward's ``entering`` states. The reverse recurrence with a float32
    carry G: G starts at g_final; for c = NC - 1 down to 0, g_states[c] =
    G, g_decay[c] = sum over (N, P) of G * entering[c], G = g_entering[c]
    + decay[c] * G; g_initial is G at the end. Returns (g_states, g_decay,
    g_initial) in float32."""
    f32 = torch.float32
    dec = decay.to(f32)
    carry = g_final.to(f32)
    g_states = torch.empty(entering.shape, dtype=f32, device=entering.device)
    g_decay = torch.empty(dec.shape, dtype=f32, device=dec.device)
    for c in range(entering.shape[0] - 1, -1, -1):
        g_states[c] = carry
        g_decay[c] = torch.sum(carry * entering[c].to(f32), dim=(-2, -1))
        carry = g_entering[c].to(f32) + dec[c][..., None, None] * carry
    return g_states, g_decay, carry


class SSDStateScanFn(torch.autograd.Function):
    """:func:`ssd_state_scan` with :func:`ssd_state_scan_bwd` as its
    backward. The entering states it saves are the forward's output, exact
    for float32 states (the model's case)."""

    @staticmethod
    def forward(ctx, states, decay, initial_state):
        entering, final = ssd_state_scan_op(states, decay, initial_state)
        ctx.save_for_backward(decay, entering)
        ctx.dtypes = (states.dtype, decay.dtype,
                      None if initial_state is None else initial_state.dtype)
        return entering, final

    @staticmethod
    def backward(ctx, g_entering, g_final):
        global BACKWARD_CALLS
        decay, entering = ctx.saved_tensors
        with torch.profiler.record_function("ssd_state_scan_bwd"):
            g_states, g_decay, g_init = ssd_state_scan_bwd(
                decay, entering, g_entering, g_final)
        BACKWARD_CALLS += 1
        s_dt, d_dt, i_dt = ctx.dtypes
        return (g_states.to(s_dt), g_decay.to(d_dt),
                None if i_dt is None else g_init.to(i_dt))
