"""Flash attention forward: the wrapper of the CUDA kernel.

The kernel (``csrc/flash_attention.cu``) replaces
``repro/kernels/flash_attention.py::_fwd_kernel``, the Pallas TPU kernel.
Its bound on the H100 is operations: the QK^T and PV products over the
visible (causal) part of the score matrix. One block owns a tile of query
rows of one (batch, head) and walks the kv tiles it can see, with the
products of bfloat16 inputs on the tensor cores (scores and probabilities
in registers, K/V tiles copied asynchronously while the previous one
computes) and float32 inputs on the CUDA cores; no score matrix reaches
device memory.

The causal mask keeps kv_pos <= q_pos, aligned top-left as the Pallas
kernel aligns it; ``block_q`` and ``block_kv`` are accepted for the JAX
signature, and the kernel's tiles are its own choice.

A CPU tensor goes to the plain version, :func:`repro_torch.kernels.ref.
flash_attention_ref`. A CUDA tensor launches the kernel or raises; nothing
falls back. ``LAUNCHES`` counts kernel launches, and only those.

Gradients go through :class:`FlashAttentionFn` on both devices: its
forward is :func:`flash_attention` (the kernel on the card), its backward
:func:`flash_attention_bwd`, which recomputes attention in float32 in
plain PyTorch and takes its VJP, as the JAX package's custom VJP
(``repro/kernels/ops.py::_fa_bwd``) recomputes through its reference. It
is the same code on the CPU and the card. ``BACKWARD_CALLS`` counts its
backward calls.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
BACKWARD_CALLS = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 192)   # the kernel's instantiations

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a library built from ``flash_attention.cu``
    (or from a modified copy of it, which ``chip_smoke.py`` builds to show
    that its tolerance catches a planted fault)."""
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load("flash_attention").lib)


def _check(q, k, v, block_q, block_kv):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Sq, Hq, hd) and k, v (B, Skv, Hkv, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or hq % k.shape[2]:
        raise ValueError(f"k, v of shape {tuple(k.shape)} do not fit q of "
                         f"shape {tuple(q.shape)}")
    if 0 in q.shape or 0 in k.shape:
        raise ValueError("empty attention input")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"inputs lie on several devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if block_q <= 0 or block_kv <= 0:
        raise ValueError("block sizes must be positive")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512, scale: float | None = None
                    ) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd) in
    q's dtype; scores scaled by ``scale`` (default hd ** -0.5), float32
    softmax statistics and accumulation."""
    global LAUNCHES
    _check(q, k, v, block_q, block_kv)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention needs contiguous, 16-byte aligned "
                         "q, k, v")
    if max(q.shape[0], q.shape[2]) > 65535:
        raise ValueError("batch and heads must each be at most 65535")
    out = launch(q, k, v, causal, _library(), scale)
    LAUNCHES += 1
    return out


def launch(q, k, v, causal: bool, lib: ctypes.CDLL,
           scale: float | None = None) -> torch.Tensor:
    """Launch ``lib``'s kernel (see :func:`bind`) on checked contiguous
    CUDA inputs on the current stream, without counting it."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        hq, hkv, hd, hd ** -0.5 if scale is None else scale, int(causal), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, *, causal: bool = True,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The VJP of attention (the function of :func:`ref.
    flash_attention_ref`) at ``(q, k, v)`` for the output cotangent ``g``,
    recomputed in float32 with c = ``scale`` (default hd^-0.5): S = (q c)
    k^T under the top-left causal mask, P = softmax(S), dV = P^T g, dP = g
    V^T, dS = P (dP - rowsum(P dP)), dq = dS k c, dk = dS^T (q c). One
    batch element at a time, so the transient score-sized tensors (P, dP/dS
    and one product) are those of one sequence. Returns (dq, dk, dv) in
    the inputs' dtype.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    grp = hq // hkv
    scale = hd ** -0.5 if scale is None else scale
    f32 = torch.float32
    mask = (torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
            if causal else None)

    def heads(x):          # (S, Hkv * G, hd) -> (Hkv, G * S, hd)
        return (x.to(f32).reshape(sq, hkv, grp, hd).permute(1, 2, 0, 3)
                .reshape(hkv, grp * sq, hd))

    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for i in range(b):
        qi = heads(q[i]) * scale
        gi = heads(g[i])
        ki = k[i].to(f32).transpose(0, 1)                  # (Hkv, Skv, hd)
        vi = v[i].to(f32).transpose(0, 1)
        s = qi @ ki.transpose(1, 2)                        # (Hkv, G*Sq, Skv)
        if causal:
            s.view(hkv, grp, sq, skv).masked_fill_(~mask, -1e30)
        p = torch.softmax(s, dim=-1)
        del s
        dv[i] = (p.transpose(1, 2) @ gi).transpose(0, 1).to(v.dtype)
        ds = gi @ vi.transpose(1, 2)                       # dP
        ds.sub_(torch.sum(p * ds, dim=-1, keepdim=True)).mul_(p)
        del p
        dq[i] = ((ds @ ki) * scale).reshape(hkv, grp, sq, hd).permute(
            2, 0, 1, 3).reshape(sq, hq, hd).to(q.dtype)
        dk[i] = (ds.transpose(1, 2) @ qi).transpose(0, 1).to(k.dtype)
        del ds
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with :func:`flash_attention_bwd` as its
    backward; q, k and v are saved, no score-sized residual."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv, scale=None):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        ctx.scale = scale
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_kv=block_kv, scale=scale)

    @staticmethod
    def backward(ctx, g):
        global BACKWARD_CALLS
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_bwd"):
            dq, dk, dv = flash_attention_bwd(q, k, v, g, causal=ctx.causal,
                                             scale=ctx.scale)
        BACKWARD_CALLS += 1
        return dq, dk, dv, None, None, None, None
