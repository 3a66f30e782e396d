"""Hillclimb runner: re-counts a dry-run cell with named optimizations
applied and records its roofline. Port of ``repro.launch.hillclimb``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --cell qwen3-0.6b:train_4k --opt tp_only,no_remat \\
        --out experiments/dryrun_torch

Optimizations (composable via comma):
  flash_vjp    -- the JAX package's custom-VJP flash backward; the port's
                  attention always takes its flash backward kernel, so this
                  is the port's baseline: accepted, and changes nothing
  tp_only      -- sharding_mode="tp": no FSDP parameter sharding over
                  `data` (no per-step parameter all-gathers; parameters
                  replicated over `data`)
  hierarchical -- HFEL pod-local training on the multi-pod mesh (the record
                  adds the cloud sync amortised over --edge-period)
  no_remat     -- remat="none": keep every layer's activations (memory for
                  FLOPs)
  baseline     -- nothing
Any other name raises ``ValueError``, as the JAX package's does for the
names it does not know (``full_sched``, whose blocked-attention schedule
the port does not have, is one).
"""

import argparse
import json
import os

from repro_torch.launch.dryrun import OUT_DIR, run_cell


def apply_opts(opts: list[str]):
    overrides = {}
    kwargs = {"mode": "sync", "sharding_mode": "fsdp", "multi_pod": False}
    for opt in opts:
        if opt in ("flash_vjp", "baseline"):
            pass
        elif opt == "tp_only":
            kwargs["sharding_mode"] = "tp"
        elif opt == "no_remat":
            overrides["remat"] = "none"
        elif opt == "hierarchical":
            kwargs["mode"] = "hierarchical"
            kwargs["multi_pod"] = True
        else:
            raise ValueError(opt)
    return overrides, kwargs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--opt", required=True,
                    help="comma list: flash_vjp,tp_only,hierarchical,"
                         "no_remat,baseline")
    ap.add_argument("--edge-period", type=int, default=10)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    arch, shape = args.cell.split(":")
    opts = args.opt.split(",")
    overrides, kwargs = apply_opts(opts)
    if args.multi_pod:
        kwargs["multi_pod"] = True

    res = run_cell(arch, shape, overrides=overrides,
                   edge_period=args.edge_period, probe=True, **kwargs)
    res["opts"] = opts
    mesh_tag = "multi" if kwargs["multi_pod"] else "single"
    tag = f"{arch}__{shape}__{mesh_tag}__{kwargs['mode']}__" + "-".join(opts)
    path = os.path.join(args.out, tag + ".json")
    os.makedirs(args.out, exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    r = res["roofline"]
    amortized = r.get("collective_s_amortized", r["collective_s"])
    print(f"{tag}: dominant={r['dominant']} compute={r['compute_s']:.4f}s "
          f"memory={r['memory_s']:.4f}s collective={r['collective_s']:.4f}s "
          f"(amortized={amortized:.4f}s)"
          f" peak={res['per_device_bytes'] / 1e9:.2f} GB", flush=True)


if __name__ == "__main__":
    main()
