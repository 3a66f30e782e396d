"""Training launcher for one card. Port of ``repro.launch.train``.

Runs the HFEL-hierarchical (or sync-baseline) train step with
checkpointing, retry, and the paper's L/I sync schedule: in hierarchical
mode the pods train apart and ``cloud_sync_fn`` averages them every
``--edge-period`` steps.

    python -m repro_torch.launch.train --arch qwen3-0.6b --shape train_4k \\
        --mode hierarchical --pods 2 --batch 4 --edge-period 10 --steps 100

There is no mesh on one card, so JAX's ``--devices`` is gone: ``--pods``
sets the pod count of hierarchical mode, and ``--batch`` overrides the
global batch (``train_4k``'s 256 x 4096 does not fit one card). Without
``--device`` it runs on the card; ``--reduced --device cpu`` runs a
reduced float32 config at sequence 128 on the CPU. Params are a random
initialisation from ``--seed``; no weights are downloaded.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import SHAPES, ShapeSpec, build_model
from repro_torch.runtime import retry_with_backoff


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    model = build_model(cfg)
    pods = args.pods if args.mode == "hierarchical" else 1
    shape = SHAPES[args.shape]
    if args.reduced:
        shape = ShapeSpec(shape.name, seq_len=128,
                          global_batch=max(pods, 2), kind="train")
    bundle = make_train_step(model, shape, mode=args.mode, lr=args.lr,
                             n_pods=pods, batch_override=args.batch,
                             device=args.device)
    return cfg, model, shape, bundle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mode", default="sync",
                    choices=["sync", "hierarchical"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--edge-period", type=int, default=10,
                    help="I: steps between cloud (pod) syncs")
    ap.add_argument("--pods", type=int, default=2,
                    help="pods of hierarchical mode")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config/shape (CPU integration runs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, model, shape, bundle = build(args)
    batch = bundle.batch_spec["tokens"][0][0]
    print(f"{dev} | {args.arch} | mode={args.mode} pods={bundle.n_pods} "
          f"| batch {batch} x seq {shape.seq_len}")

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    params, opt, step = bundle.init_state(params)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    pipe = TokenPipeline(cfg.vocab_size, shape.seq_len, batch,
                         seed=args.seed)
    t0 = time.perf_counter()
    for k in range(args.steps):
        tokens = {"tokens": torch.as_tensor(next(pipe), device=dev)}
        params, opt, step, loss = retry_with_backoff(
            lambda: bundle.step_fn(params, opt, step, tokens))
        if args.mode == "hierarchical" and (k + 1) % args.edge_period == 0:
            params, opt = bundle.cloud_sync_fn(params, opt)
        if (k + 1) % args.ckpt_every == 0:
            mgr.save(k + 1, {"params": params})
        if k % 10 == 0 or k == args.steps - 1:
            print(f"step {k:5d} loss {float(loss):.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    mgr.wait()


if __name__ == "__main__":
    main()
