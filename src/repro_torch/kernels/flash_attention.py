"""Flash attention: the wrappers of the forward and backward CUDA kernels.

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
forward is :func:`flash_attention` with the rows' logsumexp (the kernel on
the card), its backward :func:`flash_attention_backward` from the saved q,
k, v, output and logsumexp: on the card the kernel of
``csrc/flash_attention_bwd.cu``, which replaces the JAX package's custom
VJP (``repro/kernels/ops.py::_fa_bwd``, XLA autodiff through its
reference), on the CPU its plain version :func:`ref.
flash_attention_bwd_ref`. ``BACKWARD_CALLS`` counts the Function's
backward calls, ``BWD_LAUNCHES`` the backward kernel's launches, counted
once a call: in bf16 up to head dim 128 a pre-pass, one walk per kv tile
and the passes that round its sums (:func:`bwd_plan` says how the walk is
split), above it and in float32 a pre-pass, the dK/dV walk (two above
head dim 128) and the dQ walk. :func:`flash_attention_bwd` recomputes
attention whole in float32 and takes its VJP: the oracle the tests and
``chip_smoke.py`` hold both to.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
BACKWARD_CALLS = 0
BWD_LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 192)   # the kernel's instantiations

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
# the backward's (B, Hq, Sq_pad) scratch of lse and D: Sq rounded up to
# this (csrc/flash_attention_bwd.cu's kPad)
BWD_PAD = 128
# the walk's tiles (csrc/flash_attention_bwd.cu's kBQ and kBKV): q rows a
# step, kv rows a block
BWD_Q_ROWS, BWD_KV_ROWS = 64, 128
BWD_WALK_MAX_HD = 128    # the walk's head dims; above them, three walks
H100_SMS = 132


@dataclass(frozen=True)
class BwdPlan:
    """How the backward kernel is launched for one shape (pure arithmetic,
    so the CPU tests check it). ``walk``: bf16 at head dim <= 128, one walk
    per kv tile; then ``split`` blocks share each (batch, kv head, kv
    tile), rank r taking q heads ``heads[r]`` (a half-open range of the
    GQA group's), and ``grid`` is the walk's (Hkv * split, B, kv tiles).
    ``longest`` and ``balanced`` are steps (one q tile of one head): the
    longest block's walk and the walks' sum over the SMs. Scratch bytes:
    the pre-pass's lse and D, the walk's float32 dQ sums and their counts,
    and the ranks' float32 dK and dV partials."""

    walk: bool
    split: int
    heads: tuple[tuple[int, int], ...]
    grid: tuple[int, int, int]
    longest: int
    balanced: float
    stats_bytes: int
    dq_acc_bytes: int
    sem_bytes: int
    kv_part_bytes: int


def bwd_plan(b: int, sq: int, skv: int, hq: int, hkv: int, hd: int,
             causal: bool, dtype=torch.bfloat16, sms: int = H100_SMS
             ) -> BwdPlan:
    """The launch plan of :func:`flash_attention_backward` at q (b, sq, hq,
    hd), k and v (b, skv, hkv, hd). The walk's kv tile z sees the q tiles
    from ``first(z)`` on (all of them without the causal mask); a block
    walks them for each head of its share. ``split`` is the fewest ranks
    (at most the group's size and 8) whose longest walk, ceil(G / split)
    heads at kv tile 0, is at most the balanced share, so that one long
    block does not set the launch's time (internvl2's GQA 7 at batch 2)."""
    pad = -(-sq // BWD_PAD) * BWD_PAD
    stats = 2 * b * hq * pad * 4
    walk = dtype == torch.bfloat16 and hd <= BWD_WALK_MAX_HD
    group = hq // hkv
    n_q = -(-sq // BWD_Q_ROWS)
    n_kv = -(-skv // BWD_KV_ROWS)
    per_head = [n_q - (min(z * BWD_KV_ROWS // BWD_Q_ROWS, n_q) if causal
                       else 0) for z in range(n_kv)]
    balanced = b * hkv * group * sum(per_head) / sms
    split = 1
    if walk:
        while (split < min(group, 8)
               and -(-group // split) * per_head[0] > balanced):
            split += 1
    heads = tuple((r * group // split, (r + 1) * group // split)
                  for r in range(split))
    longest = max(hi - lo for lo, hi in heads) * per_head[0]
    return BwdPlan(
        walk=walk, split=split, heads=heads,
        grid=(hkv * split, b, n_kv), longest=longest, balanced=balanced,
        stats_bytes=stats,
        dq_acc_bytes=b * hq * pad * hd * 4 if walk else 0,
        sem_bytes=b * hq * (pad // BWD_Q_ROWS) * 4 if walk else 0,
        kv_part_bytes=split * 2 * b * skv * hkv * hd * 4 if split > 1
        else 0)


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


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a library built from
    ``flash_attention_bwd.cu`` (or a copy with a planted fault)."""
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load("flash_attention").lib)


def _bwd_library() -> ctypes.CDLL:
    return bind_bwd(build.load("flash_attention_bwd").lib)


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


def _on_card(*tensors) -> None:
    """Raise unless every tensor lies on the card, contiguous and 16-byte
    aligned, with batch and heads within the grid's 65535."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"no kernel for device {tensors[0].device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("flash attention's kernels need contiguous, "
                         "16-byte aligned inputs")
    if max(tensors[0].shape[0], tensors[0].shape[2]) > 65535:
        raise ValueError("batch and heads must each be at most 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512, scale: float | None = None,
                    return_lse: bool = False):
    """q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd) in
    q's dtype; scores scaled by ``scale`` (default hd ** -0.5), float32
    softmax statistics and accumulation. With ``return_lse``, also each
    row's logsumexp (float32 (B, Hq, Sq), log2 units: the residual of
    :func:`flash_attention_backward`)."""
    global LAUNCHES
    _check(q, k, v, block_q, block_kv)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                       return_lse=return_lse)
    _on_card(q, k, v)
    out = launch(q, k, v, causal, _library(), scale, return_lse)
    LAUNCHES += 1
    return out


def launch(q, k, v, causal: bool, lib: ctypes.CDLL,
           scale: float | None = None, return_lse: bool = False):
    """Launch ``lib``'s kernel (see :func:`bind`) on checked contiguous
    CUDA inputs on the current stream, without counting it; with
    ``return_lse`` the output and the rows' logsumexp."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, skv, hq, hkv, hd,
        hd ** -0.5 if scale is None else scale, int(causal), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    return (out, lse) if return_lse else out


def _check_bwd(q, o, lse, g) -> None:
    if o.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and g {tuple(g.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    b, sq, hq, _ = q.shape
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 of shape {(b, hq, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if o.dtype != q.dtype or g.dtype != q.dtype:
        raise TypeError(f"o and g must have q's dtype {q.dtype}, got "
                        f"{o.dtype}, {g.dtype}")
    if not (q.device == o.device == lse.device == g.device):
        raise ValueError("inputs lie on several devices")


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, g: torch.Tensor, *,
                             causal: bool = True, scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` at ``(q, k, v)`` for the
    output cotangent ``g``, from the forward's output ``o`` and logsumexp
    ``lse`` (``return_lse``), in the inputs' dtype. CPU tensors take the
    plain version (:func:`ref.flash_attention_bwd_ref`); CUDA tensors
    launch the kernel or raise."""
    global BWD_LAUNCHES
    _check(q, k, v, 1, 1)
    _check_bwd(q, o, lse, g)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, g, causal=causal,
                                           scale=scale)
    _on_card(q, k, v, o, lse, g)
    out = launch_bwd(q, k, v, o, lse, g, causal, _bwd_library(), scale)
    BWD_LAUNCHES += 1
    return out


def launch_bwd(q, k, v, o, lse, g, causal: bool, lib: ctypes.CDLL,
               scale: float | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``lib``'s backward (see :func:`bind_bwd`) on checked
    contiguous CUDA inputs on the current stream, without counting it."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    plan = bwd_plan(b, sq, skv, hq, hkv, hd, causal, q.dtype,
                    torch.cuda.get_device_properties(q.device)
                    .multi_processor_count)
    pad = -(-sq // BWD_PAD) * BWD_PAD
    lse_p = torch.empty(b, hq, pad, dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse_p)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

    def scratch(nbytes, dtype=torch.float32):
        return (torch.empty(nbytes // 4, dtype=dtype, device=q.device)
                if nbytes else None)

    dq_acc = scratch(plan.dq_acc_bytes)
    sem = scratch(plan.sem_bytes, torch.int32)
    kv_part = scratch(plan.kv_part_bytes)
    rc = lib.flash_attention_bwd_launch(
        *(t.data_ptr() for t in (q, k, v, o, g, lse, lse_p, dsum, dq, dk,
                                 dv)),
        *(None if t is None else t.data_ptr() for t in (dq_acc, sem,
                                                        kv_part)),
        b, sq, skv, hq, hkv, hd, pad, plan.split,
        hd ** -0.5 if scale is None else scale, int(causal),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention backward launch failed: "
                           + lib.flash_attention_bwd_error_string(rc).decode())
    return dq, dk, dv


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
    """:func:`flash_attention` with :func:`flash_attention_backward` as its
    backward; q, k, v, the output and the rows' logsumexp are saved, no
    score-sized residual."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv, scale=None):
        out, lse = flash_attention(q, k, v, causal=causal, block_q=block_q,
                                   block_kv=block_kv, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        global BACKWARD_CALLS
        q, k, v, o, lse = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_bwd"):
            dq, dk, dv = flash_attention_backward(
                q, k, v, o, lse, g.contiguous(), causal=ctx.causal,
                scale=ctx.scale)
        BACKWARD_CALLS += 1
        return dq, dk, dv, None, None, None, None
