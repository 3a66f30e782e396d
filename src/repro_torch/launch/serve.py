"""Serving launcher: batched greedy decode over the KV cache, on one
device or over a mesh of ranks. Port of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch qwen3-0.6b --new-tokens 32 \\
        --reduced --device cpu
    python -m repro_torch.launch.serve --arch qwen3-0.6b --new-tokens 4 \\
        --reduced --devices 2x2 --device cpu

``--devices DxM`` serves over a (data=D, model=M) mesh of D x M ranks:
under ``torchrun`` (or any launcher that sets ``RANK``, ``WORLD_SIZE`` and
``MASTER_ADDR``) the process group comes from the environment; otherwise
the launcher spawns the ranks itself (gloo on the CPU; on the card gloo
too, since NCCL refuses two ranks on one card). Each rank holds its
blocks of the params (``make_serve_step``'s ``params_shardings``), of the
cache (``cache_shardings``) and of the requests (``token_sharding``);
rank 0 prints.

``--arch`` takes any architecture of the registry: dense, MoE
(``deepseek-v2-lite-16b``, with MLA; ``kimi-k2-1t-a32b``, reduced only on
one card), SSM (``mamba2-1.3b``), hybrid (``zamba2-2.7b``), VLM
(``internvl2-1b``, whose decode takes no vision prefix, as in the JAX
package) or encoder-decoder (``whisper-large-v3``, decoding from frames of
zeros by default, as the JAX launcher does). Without ``--device`` it runs
on the card. Params are a random initialisation from a seed, built as the
serving copy a layer at a time (:meth:`Model.init_serving`); no weights
are downloaded.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.ranks import launch, parse_devices
from repro_torch.launch.steps import ServeStepBundle, make_serve_step
from repro_torch.models import SHAPES, Model, ShapeSpec, build_model
from repro_torch.models.transformer import SSM_FAMILIES, activation_dtype


@dataclass
class ServeResult:
    tokens: torch.Tensor        # (B, new_tokens) int32, the greedy tokens
    prompt_logits: torch.Tensor | None   # (B, P, V) decode logits per prompt
    prompt_s: float             # seconds feeding the prompts, step by step
    decode_s: float             # seconds of the greedy steps after them
    prompt_steps: int
    decode_steps: int

    @property
    def tokens_per_s(self) -> float:
        """Generated tokens over the seconds of every step."""
        return self.tokens.numel() / (self.prompt_s + self.decode_s)

    @property
    def ms_per_decode_step(self) -> float:
        return 1e3 * self.decode_s / max(self.decode_steps, 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(model: Model, params, prompts: torch.Tensor, new_tokens: int, *,
          max_len: int | None = None, frames: torch.Tensor | None = None,
          keep_prompt_logits: bool = False,
          bundle: ServeStepBundle | None = None) -> ServeResult:
    """Answer a batch of requests: feed each prompt (B, P) through the
    decode step token by token (teacher forced; the last prompt step's
    argmax is the first new token), then decode greedily with the serve
    step until ``new_tokens`` tokens per request exist. The cache holds
    ``max_len`` positions (default P + new_tokens). An encoder-decoder
    needs ``frames`` (B, encoder_seq_len, d), which its cache's set-up
    encodes once.

    With a mesh's ``bundle`` (``make_serve_step(model, mesh, shape)``),
    every rank calls this with its blocks of ``params``
    (``bundle.params_shardings``; each step gathers them a layer at a
    time) and its rows of ``prompts`` and ``frames``
    (``bundle.token_sharding``); the result holds every request's tokens
    and logits (gathered over the batch axes)."""
    bundle = bundle or make_serve_step(model)
    b, p = prompts.shape
    if p < 1 or new_tokens < 1:
        raise ValueError("need at least one prompt token and one new token")
    steps = p + new_tokens - 1
    max_len = max_len or steps + 1
    if max_len < steps:
        raise ValueError(f"a cache of {max_len} positions cannot hold "
                         f"{steps} steps")
    device = prompts.device
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    cache = bundle.init_cache(params, batch, max_len,
                              activation_dtype(model.cfg))
    kept = []
    _sync(device)
    t0 = time.perf_counter()
    for t in range(p):
        logits, cache = bundle.decode_fn(params, cache, prompts[:, t])
        if keep_prompt_logits:
            kept.append(logits)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(new_tokens - 1):
        tok, cache = bundle.step_fn(params, cache, tok)
        out.append(tok)
    _sync(device)
    t2 = time.perf_counter()
    tokens = torch.stack(out, dim=1)
    logits = torch.stack(kept, dim=1) if keep_prompt_logits else None
    if bundle.mesh is not None:       # every request's, from every rank
        spec = bundle.token_sharding.spec
        tokens = shd.gather_full(tokens, shd.NamedSharding(
            bundle.mesh, spec + (None,)))
        if logits is not None:
            logits = shd.gather_full(logits, shd.NamedSharding(
                bundle.mesh, spec + (None, None)))
    return ServeResult(
        tokens=tokens, prompt_logits=logits,
        prompt_s=t1 - t0, decode_s=t2 - t1, prompt_steps=p,
        decode_steps=new_tokens - 1)


def cache_bytes(cfg, batch: int, max_len: int, dtype: torch.dtype) -> int:
    """Device bytes of the decode cache's float tensors, by family: dense
    k and v of every layer in ``dtype``; an MLA layer's latent and rope key
    (kv_lora_rank + qk_rope_head_dim columns) in ``dtype``, the leading
    dense layers' too; an SSM layer's state (B, H, N, P) and conv buffer
    (B, K - 1, conv_dim) in float32, whatever ``dtype`` and ``max_len``;
    zamba2 both, with one k/v cache per application of the shared block;
    an encoder-decoder's self k/v of every decoder layer and its cross k/v
    of ``encoder_seq_len`` positions, both in ``dtype``. The int32 lengths
    and positions (4 bytes per request and layer) are not counted."""
    item = torch.empty((), dtype=dtype).element_size()
    if cfg.mla is not None:
        m = cfg.mla
        return (cfg.n_layers * batch * max_len
                * (m.kv_lora_rank + m.qk_rope_head_dim) * item)
    per_position = 2 * batch * cfg.n_kv_heads * cfg.resolved_head_dim * item
    kv = per_position * max_len
    if cfg.family == "encdec":
        return cfg.n_layers * per_position * (max_len + cfg.encoder_seq_len)
    if cfg.family not in SSM_FAMILIES:
        return cfg.n_layers * kv
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    state = batch * d_inner * s.state_size * 4        # H * P = d_inner
    conv = batch * (s.conv_kernel - 1) * (d_inner + 2 * s.n_groups
                                          * s.state_size) * 4
    apps = (cfg.n_layers // cfg.hybrid_attn_period
            if cfg.family == "hybrid" and cfg.hybrid_attn_period else 0)
    return cfg.n_layers * (state + conv) + apps * kv


def serve_shape(cfg, shape: ShapeSpec, new_tokens: int, *, device=None,
                params=None, prompts=None, frames=None,
                keep_prompt_logits: bool = False) -> ServeResult:
    """The launcher's body: serve ``shape.global_batch`` requests with a
    cache of ``shape.seq_len`` positions. ``params`` default to a random
    init from seed 0 built as the serving copy (:meth:`Model.init_serving`,
    which never holds the float32 params); ``prompts`` default to one
    token 0 per request, and an encoder-decoder's ``frames`` to zeros in
    the activation dtype (bfloat16 at full size, float32 reduced), as the
    JAX launcher starts."""
    dev = resolve_device(device)
    model = build_model(cfg)
    dtype = activation_dtype(cfg)
    need = cache_bytes(cfg, shape.global_batch, shape.seq_len, dtype)
    if dev.type == "cuda" and need > torch.cuda.mem_get_info(dev)[0]:
        raise ValueError(
            f"{cfg.name} at {shape.name}: the decode cache needs "
            f"{need / 1e9:.1f} GB, more than the card has free; use "
            "--reduced or a smaller shape")
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init_serving(gen)
    if prompts is None:
        prompts = torch.zeros(shape.global_batch, 1, dtype=torch.int32,
                              device=dev)
    if frames is None and cfg.family == "encdec":
        frames = torch.zeros(shape.global_batch, cfg.encoder_seq_len,
                             cfg.d_model, dtype=dtype, device=dev)
    return serve(model, params, prompts, new_tokens, max_len=shape.seq_len,
                 frames=frames, keep_prompt_logits=keep_prompt_logits)


def _serve_rank(mesh, args) -> None:
    """One rank of ``main``'s ``--devices`` mesh: the launcher's requests,
    its blocks of params, cache and tokens; rank 0 prints."""
    cfg, shape = _config(args)
    dev = resolve_device(args.device)
    model = build_model(cfg)
    bundle = make_serve_step(model, mesh, shape)
    params = shd.shard_tree(
        model.init_serving(torch.Generator(device=dev).manual_seed(0)),
        bundle.params_shardings)
    prompts = bundle.token_sharding.local(
        torch.zeros(shape.global_batch, 1, dtype=torch.int32, device=dev))
    frames = None
    if cfg.family == "encdec":
        frames = bundle.token_sharding.local(torch.zeros(
            shape.global_batch, cfg.encoder_seq_len, cfg.d_model,
            dtype=activation_dtype(cfg), device=dev))
    res = serve(model, params, prompts, args.new_tokens,
                max_len=shape.seq_len, frames=frames, bundle=bundle)
    if torch.distributed.get_rank() == 0:
        _report(args, res, f"mesh {shd.axis_sizes(mesh)}")


def _config(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    shape = SHAPES[args.shape]
    if args.reduced:
        n_batch = 1
        if args.devices:
            sizes, axes = parse_devices(args.devices)
            n_batch = dict(zip(axes, sizes)).get("data", 1)
        shape = ShapeSpec(shape.name, seq_len=128,
                          global_batch=max(n_batch, 2), kind="decode")
    return cfg, shape


def _report(args, res, where) -> None:
    dt = res.prompt_s + res.decode_s
    print(f"{args.arch}: {res.tokens.numel()} tokens in {dt:.2f}s "
          f"-> {res.tokens_per_s:.1f} tok/s on {where}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", default=None,
                    help="a DxM (data x model) mesh of ranks, e.g. 2x2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.devices:
        launch(_serve_rank, args.devices, args.device, args)
        return None
    cfg, shape = _config(args)
    res = serve_shape(cfg, shape, args.new_tokens, device=args.device)
    _report(args, res, res.tokens.device)
    return res


if __name__ == "__main__":
    main()
