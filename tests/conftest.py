import os
import sys

# Smoke tests and benches run single-device (the 512-device override lives
# ONLY in repro.launch.dryrun, which runs as its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
# marker hygiene: over-limit unmarked tests FAIL when scripts/tier1.sh
# exports TIER1_SLOW_MARKER_LIMIT_S (see tests/_marker_hygiene.py)
from _marker_hygiene import pytest_runtest_makereport  # noqa: E402,F401

jax.config.update("jax_enable_x64", False)

# Tests already failing in the seed snapshot (v0) get tagged with the
# ``seed_known_failure`` marker so ``scripts/tier1.sh`` (which runs
# ``-m "not seed_known_failure"``) keeps a meaningful green/red signal.
# The original 14 entries (flash-attention kernel sweeps, small-mesh
# launch smoke tests, the end-to-end LM loop) were jax-version
# incompatibilities, fixed in PR 3 (pltpu.TPUCompilerParams,
# jax.tree_util.tree_flatten_with_path, ``with mesh:``), so the set is now
# empty and tier-1 runs the full suite. The plumbing stays for any future
# genuinely environment-bound straggler — add its nodeid here WITH a
# comment saying what environment limitation it needs.
SEED_KNOWN_FAILURES: frozenset[str] = frozenset()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "seed_known_failure: test already failing in the seed snapshot; "
        "excluded by scripts/tier1.sh so tier-1 green/red is meaningful")
    config.addinivalue_line(
        "markers",
        "slow: multi-minute test (launch/serve smoke tests, large "
        "association convergence runs); deselected by scripts/tier1.sh "
        "--fast")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the PyTorch port's kernels); skips inside "
        "the test body when torch.cuda.is_available() is False")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid in SEED_KNOWN_FAILURES:
            item.add_marker(pytest.mark.seed_known_failure)


@pytest.fixture
def compile_log():
    """One jax-compile event recorder per test (repro.analysis.recompile):
    ``jax_log_compiles`` is enabled for the test's duration and every real
    XLA compilation appends the compiled function's name to ``.events`` —
    cache hits append nothing. Backs the recompilation-sentinel tier
    (tests/test_recompile_sentinel.py)."""
    from repro.analysis.recompile import CompileLog

    with CompileLog() as log:
        yield log
