"""Training launcher. Port of ``repro.launch.train``.

Runs the HFEL-hierarchical (or sync-baseline) train step with
checkpointing, retry, and the paper's L/I sync schedule: in hierarchical
mode the pods train apart and ``cloud_sync_fn`` averages them every
``--edge-period`` steps.

    python -m repro_torch.launch.train --arch qwen3-0.6b --shape train_4k \\
        --mode hierarchical --pods 2 --batch 4 --edge-period 10 --steps 100
    python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
        --devices 2x2 --steps 4 --device cpu

Without ``--devices`` it trains on one card: ``--pods`` sets the pod count
of hierarchical mode, and ``--batch`` overrides the global batch
(``train_4k``'s 256 x 4096 does not fit one card). ``--devices DxM`` (a
data x model mesh) or ``PxDxM`` (pod x data x model) trains on a mesh of
ranks, as the JAX launcher's ``--devices``: each rank holds its blocks
(placed as ``make_train_step``'s default, ``fsdp``) and its rows of the
batch; rank 0 prints and writes whole leaves to the checkpoint. Under
``torchrun`` the process group comes from the environment; otherwise the
launcher spawns the ranks (``launch.ranks``). Without ``--device`` it runs
on the card; ``--reduced --device cpu`` runs a reduced float32 config at
sequence 128 on the CPU. Params are a random initialisation from
``--seed``; no weights are downloaded.
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
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.ranks import launch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import SHAPES, ShapeSpec, build_model
from repro_torch.runtime import retry_with_backoff


def build(args, mesh=None):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    model = build_model(cfg)
    pods = args.pods if args.mode == "hierarchical" else 1
    n_shards = pods
    if mesh is not None:
        sizes = axis_sizes(mesh)
        n_shards = sizes.get("pod", 1) * sizes.get("data", 1)
    shape = SHAPES[args.shape]
    if args.reduced:
        shape = ShapeSpec(shape.name, seq_len=128,
                          global_batch=max(n_shards, 2), kind="train")
    bundle = make_train_step(model, shape, mesh=mesh, mode=args.mode,
                             lr=args.lr,
                             n_pods=pods, batch_override=args.batch,
                             device=args.device)
    return cfg, model, shape, bundle


def make_opt_state(bundle, params):
    """The optimizer state of ``params`` (a rank's blocks on a mesh, placed
    as ``bundle.opt_shardings``)."""
    return bundle.optimizer.init(params)


def train(args, mesh=None) -> None:
    """The launcher's loop, on one card or on a rank of ``mesh``."""
    dev = resolve_device(args.device)
    cfg, model, shape, bundle = build(args, mesh)
    lead = mesh is None or torch.distributed.get_rank() == 0
    batch = bundle.batch_spec["tokens"][0][0]
    where = dev if mesh is None else f"mesh {axis_sizes(mesh)}"
    if lead:
        print(f"{where} | {args.arch} | mode={args.mode} "
              f"pods={bundle.n_pods} | batch {batch} x seq {shape.seq_len}",
              flush=True)

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    params, _, step = bundle.init_state(params)
    opt = make_opt_state(bundle, params)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    pipe = TokenPipeline(cfg.vocab_size, shape.seq_len, batch,
                         seed=args.seed)
    t0 = time.perf_counter()
    for k in range(args.steps):
        tokens = bundle.local_batch(
            {"tokens": torch.as_tensor(next(pipe), device=dev)})
        params, opt, step, loss = retry_with_backoff(
            lambda: bundle.step_fn(params, opt, step, tokens))
        if args.mode == "hierarchical" and (k + 1) % args.edge_period == 0:
            params, opt = bundle.cloud_sync_fn(params, opt)
        if (k + 1) % args.ckpt_every == 0:
            mgr.save(k + 1, {"params": params},
                     shardings=None if mesh is None
                     else {"params": bundle.params_shardings})
        if lead and (k % 10 == 0 or k == args.steps - 1):
            print(f"step {k:5d} loss {float(loss):.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    mgr.wait()


def _train_rank(mesh, args) -> None:
    train(args, mesh)


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
                    help="pods of hierarchical mode on one card")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--devices", default=None,
                    help="a mesh of ranks: DxM (data x model) or PxDxM "
                         "(pod x data x model), e.g. 2x2 or 2x2x1")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config/shape (CPU integration runs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.devices:
        launch(_train_rank, args.devices, args.device, args)
    else:
        train(args)


if __name__ == "__main__":
    main()
