#!/usr/bin/env python
"""hfellint for the PyTorch port: lint ``src/repro_torch`` and
``chip_smoke.py`` against ``lint_baseline_torch.json``.

    python scripts/torch_lint.py --check            # the gate (default)
    python scripts/torch_lint.py --fix-baseline     # re-record findings
    python scripts/torch_lint.py --check src/repro_torch/core   # a subset

``--check`` exits non-zero if any finding is not in the baseline. A
finding is silenced by an inline ``# hfellint: disable=RULE -- reason``
pragma or kept in the baseline; ``--fix-baseline`` regenerates the
baseline from the current state. Stale baseline entries are reported but
never fail the gate. Stdlib-only (no torch import); the test suite runs
the gate (``tests/test_torch_lint.py``).
"""

from __future__ import annotations

import argparse
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "src"))

from repro_torch.analysis import (diff_against_baseline,  # noqa: E402
                                  lint_paths, load_baseline, save_baseline)
from repro_torch.analysis.baseline import DEFAULT_BASELINE  # noqa: E402

DEFAULT_TARGETS = ["src/repro_torch", "chip_smoke.py"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="fail on findings not in the baseline (default)")
    mode.add_argument("--fix-baseline", action="store_true",
                      help="regenerate the baseline from current findings")
    ap.add_argument("--baseline",
                    default=os.path.join(REPO_ROOT, DEFAULT_BASELINE),
                    help="baseline JSON path (default: repo root)")
    ap.add_argument("targets", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_TARGETS})")
    args = ap.parse_args(argv)

    findings = lint_paths(args.targets or DEFAULT_TARGETS, root=REPO_ROOT)
    if args.fix_baseline:
        body = save_baseline(args.baseline, findings)
        print(f"lint: baseline rewritten with "
              f"{sum(e['count'] for e in body['findings'].values())} "
              f"finding(s) across {len(body['findings'])} fingerprint(s) "
              f"-> {os.path.relpath(args.baseline, REPO_ROOT)}")
        return 0

    new, stale = diff_against_baseline(findings,
                                       load_baseline(args.baseline))
    for entry in stale:
        print(f"lint: stale baseline entry {entry['fingerprint']} "
              f"({entry['rule']} {entry['path']}: {entry['line']!r}) — "
              "fixed? run --fix-baseline to drop it")
    baselined = len(findings) - len(new)
    if new:
        for f in new:
            print(f.render())
        print(f"lint: FAIL — {len(new)} new finding(s) "
              f"({baselined} baselined, {len(stale)} stale)")
        return 1
    print(f"lint: OK — 0 new findings "
          f"({baselined} baselined, {len(stale)} stale)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
