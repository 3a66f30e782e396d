"""The port's train and serve launchers over a mesh of spawned ranks on the
CPU: the three cases of ``tests/test_launch.py`` (which runs the JAX
launchers on four forced host devices), run as the port's with ``--devices``
and ``--device cpu``. Each launcher spawns its four gloo ranks (~8 s a
run)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _run(args, timeout: int = 300):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "PYTHONWARNINGS": "ignore::FutureWarning"}
    return subprocess.run([sys.executable, "-m"] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_sync_small_mesh(tmp_path):
    r = _run(["repro_torch.launch.train", "--arch", "qwen3-0.6b",
              "--reduced", "--devices", "2x2", "--steps", "4",
              "--ckpt-every", "1000", "--shape", "train_4k",
              "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "mesh {'data': 2, 'model': 2}" in r.stdout
    assert "step     3" in r.stdout
    assert r.stdout.count("step     0") == 1        # rank 0 alone prints


def test_train_hierarchical_small_mesh(tmp_path):
    r = _run(["repro_torch.launch.train", "--arch", "olmo-1b", "--reduced",
              "--devices", "2x2x1", "--mode", "hierarchical",
              "--edge-period", "2", "--steps", "4", "--ckpt-every", "2",
              "--shape", "train_4k", "--device", "cpu",
              "--ckpt-dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "mode=hierarchical pods=2" in r.stdout
    # rank 0 wrote whole pod-stacked leaves, the pods equal after the sync
    step = tmp_path / "step_0000000004"
    with np.load(step / "shard_0.npz") as z:
        table = z["params\x1fembed\x1ftable"]
    assert table.shape == (2, 256, 64)
    np.testing.assert_array_equal(table[0], table[1])


def test_serve_small_mesh():
    r = _run(["repro_torch.launch.serve", "--arch", "qwen3-0.6b",
              "--reduced", "--devices", "2x2", "--new-tokens", "4",
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "tok/s" in r.stdout and "mesh" in r.stdout
