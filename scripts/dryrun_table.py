#!/usr/bin/env python
"""Markdown roofline table of the port's dry-run records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mode hierarchical --mesh multi
    python scripts/dryrun_table.py [--dir experiments/dryrun_torch]

One row a cell (``launch/dryrun.py``'s JSON: rank 0 of the mesh on fake
ranks, H100 figures): the single-mesh ``sync`` record's compute, memory
and collective terms in seconds, the dominant one, MODEL_FLOPS over the
counted FLOPs, the rank's peak in GB and whether it fits the card's 80
GB; then the multi-pod ``hierarchical`` record's collective term, the
same with the cloud sync amortised, its peak and whether it fits.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

CARD_BYTES = 80e9
HEAD = ["arch", "shape", "compute s", "memory s", "collective s",
        "dominant", "MODEL/counted FLOPs", "peak GB", "fits",
        "hier. collective s", "amortised s", "hier. peak GB", "hier. fits"]


def fits(r: dict) -> str:
    return "yes" if r["per_device_bytes"] <= CARD_BYTES else "no"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    by = {}
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if "opts" not in r:                     # not a hillclimb record
            by[r["arch"], r["shape"], r["mesh"], r["mode"]] = r
    print("| " + " | ".join(HEAD) + " |")
    print("|" + " --- |" * len(HEAD))
    for (arch, shape, mesh, mode), r in sorted(by.items()):
        if (mesh, mode) != ("16x16", "sync"):
            continue
        t = r["roofline"]
        cells = [arch, shape, f"{t['compute_s']:.4g}",
                 f"{t['memory_s']:.4g}", f"{t['collective_s']:.4g}",
                 t["dominant"], f"{t['flops_ratio']:.3g}",
                 f"{r['per_device_bytes'] / 1e9:.4g}", fits(r)]
        h = by.get((arch, shape, "2x16x16", "hierarchical"))
        if h is None:
            cells += ["-"] * 4
        else:
            th = h["roofline"]
            amortised = th.get("collective_s_amortized", th["collective_s"])
            cells += [f"{th['collective_s']:.4g}", f"{amortised:.4g}",
                      f"{h['per_device_bytes'] / 1e9:.4g}", fits(h)]
        print("| " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
