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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0

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
