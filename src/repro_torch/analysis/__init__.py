"""hfellint for the port: repo-specific static analysis and the host-sync
sentinel. Port of ``repro.analysis``.

Static side (stdlib-only, no torch import):
  * :mod:`repro_torch.analysis.rules`    — the HFEL001/002/003/005 AST rules
  * :mod:`repro_torch.analysis.engine`   — file walking, pragma suppression
  * :mod:`repro_torch.analysis.baseline` — fingerprint baseline diffing

Dynamic side (imports torch, keep it out of the lint fast path):
  * :mod:`repro_torch.analysis.recompile` — ``SyncLog``, the host-sync
    capture behind ``tests/test_torch_sync_sentinel.py``, and
    ``CompileLog``, the kernels' builds
"""

from repro_torch.analysis.baseline import (baseline_counts,
                                           diff_against_baseline,
                                           load_baseline, save_baseline)
from repro_torch.analysis.engine import Finding, lint_paths, lint_source

__all__ = ["Finding", "lint_paths", "lint_source", "load_baseline",
           "save_baseline", "baseline_counts", "diff_against_baseline"]
