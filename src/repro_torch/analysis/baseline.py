"""Finding baseline: pre-existing findings are recorded with counts and new
ones fail the gate. Port of ``repro.analysis.baseline``.

The baseline file (``lint_baseline_torch.json`` at the repo root) maps each
:meth:`~repro_torch.analysis.engine.Finding.fingerprint` to the number of
times it occurs plus human-readable context (rule, path, the offending
line). The
fingerprint hashes rule + path + stripped source line — not the line NUMBER
— so edits elsewhere in a file don't churn the baseline, while touching the
flagged line itself (or copying it) surfaces as a new finding.

``diff_against_baseline`` returns the findings in EXCESS of the baselined
count per fingerprint: a second identical violation on a new line fails even
though the first is baselined.
"""

from __future__ import annotations

import json
import os
from collections import Counter, defaultdict

from repro_torch.analysis.engine import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = "lint_baseline_torch.json"


def baseline_counts(findings: list[Finding]) -> dict[str, dict]:
    """The JSON-ready baseline body for a findings list."""
    by_fp: dict[str, dict] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.lineno, f.rule)):
        fp = f.fingerprint()
        if fp in by_fp:
            by_fp[fp]["count"] += 1
        else:
            by_fp[fp] = {"rule": f.rule, "path": f.path, "line": f.line,
                         "count": 1}
    return by_fp


def save_baseline(path: str, findings: list[Finding]) -> dict:
    body = {"version": BASELINE_VERSION,
            "findings": baseline_counts(findings)}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(body, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return body


def load_baseline(path: str) -> dict[str, dict]:
    """fingerprint -> entry; a missing file is an empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        body = json.load(fh)
    if body.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported lint baseline version {body.get('version')!r} "
            f"in {path} (expected {BASELINE_VERSION}); regenerate with "
            "scripts/torch_lint.py --fix-baseline")
    return dict(body.get("findings", {}))


def diff_against_baseline(findings: list[Finding],
                          baseline: dict[str, dict]
                          ) -> tuple[list[Finding], list[dict]]:
    """(new findings beyond the baselined counts, stale baseline entries).

    Stale entries — baselined fingerprints no longer (fully) present — are
    informational: the violation was fixed and ``--fix-baseline`` will drop
    the entry."""
    grouped: dict[str, list[Finding]] = defaultdict(list)
    for f in sorted(findings, key=lambda f: (f.path, f.lineno, f.col)):
        grouped[f.fingerprint()].append(f)
    new: list[Finding] = []
    for fp, group in grouped.items():
        allowed = int(baseline.get(fp, {}).get("count", 0))
        if len(group) > allowed:
            new.extend(group[allowed:])
    current = Counter(f.fingerprint() for f in findings)
    stale = [dict(entry, fingerprint=fp)
             for fp, entry in sorted(baseline.items())
             if current[fp] < int(entry.get("count", 0))]
    return sorted(new, key=lambda f: (f.path, f.lineno, f.col)), stale
