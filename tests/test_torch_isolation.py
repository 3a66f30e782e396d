"""The PyTorch port stands alone: neither ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and importing the port's
deepest module leaves ``jax`` out of ``sys.modules``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process holds both frameworks)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.core.assoc_fast, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.fl.training, "
            "repro_torch.data, repro_torch.core.hierarchy, "
            "repro_torch.fl.live, "
            "repro_torch.configs, repro_torch.models, "
            "repro_torch.models.moe, repro_torch.models.attention, "
            "repro_torch.configs.deepseek_v2_lite_16b, "
            "repro_torch.configs.kimi_k2_1t_a32b, "
            "repro_torch.models.encdec, "
            "repro_torch.configs.whisper_large_v3, "
            "repro_torch.configs.internvl2_1b, "
            "repro_torch.launch.serve, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.checkpoint, repro_torch.runtime, "
            "repro_torch.core.compression, repro_torch.data.tokens; "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro was imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
