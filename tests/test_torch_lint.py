"""The port's lint (``repro_torch.analysis``, ``scripts/torch_lint.py``).

* A fixture corpus: HFEL001 (numpy's module-level RNG, unseeded
  generators) and HFEL002 (``time.time()``) give the JAX package's
  findings (``repro.analysis``, stdlib-only) on the same snippets, field
  for field; the port's own cases of HFEL001 (torch samplers without
  ``generator=``), HFEL003 (host syncs, in ``core`` and ``kernels``
  only) and HFEL005 (float64 in ``kernels``); pragmas and the baseline.
* The gate: no finding in ``src/repro_torch`` or ``chip_smoke.py``
  outside ``lint_baseline_torch.json``.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import (diff_against_baseline, lint_paths,
                                  lint_source, load_baseline)
from repro_torch.analysis.baseline import baseline_counts
from repro_torch.analysis.rules import JAX_ONLY_NAMES

try:                     # the oracle; absent on a machine with only torch
    from repro.analysis import lint_source as jax_lint_source
except ImportError:
    jax_lint_source = None

ROOT = Path(__file__).resolve().parents[1]

SHARED = {
    "np_module_rng": """
        import numpy as np
        a = np.random.rand(3)
        b = np.random.normal(0.0, 1.0, size=4)
        np.random.seed(0)
        """,
    "np_generators": """
        import numpy as np
        from numpy.random import default_rng
        r0 = np.random.default_rng()
        r1 = np.random.default_rng(None)
        r2 = np.random.default_rng(7)
        r3 = np.random.RandomState()
        r4 = np.random.Generator(np.random.PCG64(seed=3))
        r5 = default_rng()
        """,
    "time": """
        import time
        t0 = time.time()
        t1 = time.perf_counter()
        stamp = f"{int(time.time() * 1e6)}"  # hfellint: disable=HFEL002 -- wall-clock tmp name
        """,
    "pragma_without_reason": """
        import time
        t = time.time()  # hfellint: disable=HFEL002
        """,
    "clean": """
        import numpy as np
        rng = np.random.default_rng(0)
        x = rng.normal(size=3)
        """,
}


def key(f):
    return (f.rule, f.path, f.lineno, f.col, f.message, f.line)


@pytest.mark.parametrize("name", sorted(SHARED))
def test_hfel001_002_match_jax(name):
    if jax_lint_source is None:
        pytest.skip("needs the JAX package, the oracle")
    text = textwrap.dedent(SHARED[name])
    path = "examples/snippet.py"
    got = [key(f) for f in lint_source(path, text)]
    want = [key(f) for f in jax_lint_source(path, text)]
    assert got == want
    if name != "clean":
        assert got


PORT = {
    "torch_rng": ("src/repro_torch/fl/x.py", """
        import torch
        g = torch.Generator().manual_seed(0)
        a = torch.randn(3)
        b = torch.randn(3, generator=g)
        c = torch.randint(0, 5, (2,))
        d = torch.randperm(4, generator=g)
        e = torch.empty(3).normal_()
        f = torch.empty(3).normal_(generator=g)
        """, [("HFEL001", 4), ("HFEL001", 6), ("HFEL001", 8)]),
    "host_sync_core": ("src/repro_torch/core/x.py", """
        import numpy as np
        import torch

        def f(a, n):
            x = torch.zeros(n)
            y = x.sum()
            k = int(y)
            m = int(x.shape[0])
            s = y.item()
            h = x.cpu()
            l = x.tolist()
            z = np.asarray(x)
            w = int(n)
            return k, m, s, h, l, z, w
        """, [("HFEL003", 8), ("HFEL003", 10), ("HFEL003", 11),
              ("HFEL003", 12), ("HFEL003", 13)]),
    "host_sync_elsewhere": ("src/repro_torch/launch/x.py", """
        import torch
        x = torch.zeros(3)
        k = x.sum().item()
        """, []),
    "float64_kernels": ("src/repro_torch/kernels/x.py", """
        import torch
        a = torch.zeros(3, dtype=torch.float64)
        b = a.double()
        c = a.to("float64")
        """, [("HFEL005", 3), ("HFEL005", 4), ("HFEL005", 5)]),
    "float64_elsewhere": ("src/repro_torch/core/y.py", """
        import torch
        a = torch.zeros(3, dtype=torch.float64)
        """, []),
    "pragma": ("src/repro_torch/core/z.py", """
        import torch

        def f(x):
            # hfellint: disable=HFEL003 -- one read a round, by design
            return torch.stack([x]).tolist()
        """, []),
}


@pytest.mark.parametrize("name", sorted(PORT))
def test_port_rules(name):
    path, text, want = PORT[name]
    got = [(f.rule, f.lineno) for f in lint_source(path,
                                                   textwrap.dedent(text))]
    assert got == want


def test_baseline_counts_and_diff():
    text = textwrap.dedent("""
        import time
        a = time.time()
        b = time.time()
        """)
    found = lint_source("src/repro_torch/x.py", text)
    assert len(found) == 2
    base = baseline_counts(found[:1])       # one of two identical lines
    new, stale = diff_against_baseline(found, base)
    assert [f.lineno for f in new] == [4] and stale == []


def test_jax_only_rules_are_named():
    """HFEL004, 006 and 007 have no eager counterpart; the module names
    their machinery (``tests/test_torch_mirror.py`` reads the list)."""
    assert {"rule_hfel006", "rule_hfel007", "find_jit_scopes"} <= \
        JAX_ONLY_NAMES


def test_gate_no_finding_outside_the_baseline():
    findings = lint_paths(["src/repro_torch", "chip_smoke.py"],
                          root=str(ROOT))
    baseline = load_baseline(str(ROOT / "lint_baseline_torch.json"))
    new, stale = diff_against_baseline(findings, baseline)
    assert not new, "\n".join(f.render() for f in new)
    assert not stale, stale


def test_lint_script_check_exits_0():
    proc = subprocess.run([sys.executable, "scripts/torch_lint.py",
                           "--check"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: OK" in proc.stdout
