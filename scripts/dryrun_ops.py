#!/usr/bin/env python
"""FLOPs of one stacked layer by operator, on rank 0 of the production
mesh (fake ranks, fake tensors; ``launch/dryrun.py``'s train step).

    PYTHONPATH=src python scripts/dryrun_ops.py deepseek-v2-lite-16b \\
        prefill_32k

Counts the train step of the cell's two probe depths
(``dryrun._probe_layer_counts``) under ``FlopCounterMode`` and prints each
operator's FLOPs in the deeper one less the shallower one (one layer of
the repeated unit: an MoE layer, an SSM layer, ...) and its share.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import SHAPES, build_model


def step_flops(cfg, shape, mesh) -> dict:
    """Each operator's FLOPs in one train step of ``cfg`` on ``mesh``."""
    model = build_model(cfg)
    with FakeTensorMode():
        bundle = make_train_step(model, shape, mesh=mesh, device="cpu")
        params, opt, step, batch = dryrun._train_state(bundle, model)
        counter = FlopCounterMode(display=False)
        with counter:
            bundle.step_fn(params, opt, step, batch)
    return {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("arch")
    ap.add_argument("shape", choices=[s for s, v in SHAPES.items()
                                      if v.kind == "train"])
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    small, big, _ = dryrun._probe_layer_counts(cfg)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        shape = SHAPES[args.shape]
        lo = step_flops(dataclasses.replace(cfg, **small), shape, mesh)
        hi = step_flops(dataclasses.replace(cfg, **big), shape, mesh)
    finally:
        dist.destroy_process_group()
    layer = {op: hi.get(op, 0) - lo.get(op, 0) for op in hi}
    total = sum(layer.values())
    print(f"{args.arch} {args.shape}: one layer {total:.4g} FLOPs on rank 0")
    for op, n in sorted(layer.items(), key=lambda kv: -kv[1]):
        print(f"  {op:45s} {n:.4g}  {n / total:.1%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
