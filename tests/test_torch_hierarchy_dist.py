"""Port parity: Algorithm 1's collectives (``psum_mean``,
``hierarchical_sync``) over a (pod=2, data=2) mesh of four gloo ranks.

The ranks are spawned processes on the CPU (a ``file://`` store in the
test's directory) that run ``_torch_hierarchy_worker.run`` on a mesh from
the port's ``make_test_mesh``. Every mean is held to plain numpy and to
JAX's own ``hierarchical_sync``/``psum_mean`` under ``shard_map`` on four
forced host devices, at rtol 1e-6. The JAX side runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the test process's
JAX sees one device) and ``check_rep=False``: under the default
replication check its ``lax.switch`` refuses branches whose outputs vary
differently over the mesh axes. Spawning the ranks takes ~6 s, the JAX
subprocess ~5 s; both run once for the module."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.multiprocessing as mp

import _torch_hierarchy_worker as worker

RTOL = 1e-6
TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
LEAVES = ("a", "b")

# rank r sits at (pod r // 2, data r % 2); each axis's groups of ranks
GROUPS = {"data": [[0, 1], [2, 3]], "pod": [[0, 2], [1, 3]]}

JAX_SIDE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.core.hierarchy import SyncLevel, hierarchical_sync, psum_mean
from _torch_hierarchy_worker import LEVELS, WEIGHTS, inputs

assert len(jax.devices()) == 4, jax.devices()
mesh = jax.make_mesh((2, 2), ("pod", "data"))
spec = P(("pod", "data"))
data = inputs()
w = np.asarray(WEIGHTS, np.float32)


def sharded(fn):
    def body(a, b, wt):
        return fn({"a": a, "b": b}, wt[0])
    f = shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                  out_specs=spec, check_rep=False)
    return f(data["a"], data["b"], w)


cases = {}
for axis in ("data", "pod"):
    cases[f"mean_{axis}"] = sharded(lambda t, wt: psum_mean(t, axis))
    cases[f"wmean_{axis}"] = sharded(lambda t, wt: psum_mean(t, axis, wt))
for name in LEVELS:
    cases[f"sync_{name}"] = sharded(lambda t, wt: hierarchical_sync(
        t, int(SyncLevel[name]), weight=wt))
data = {k: jnp.asarray(v, jnp.bfloat16) for k, v in data.items()}
for axis in ("data", "pod"):
    cases[f"bf16_mean_{axis}"] = sharded(lambda t, wt: psum_mean(t, axis))
    cases[f"bf16_wmean_{axis}"] = sharded(
        lambda t, wt: psum_mean(t, axis, wt))
for name in LEVELS:
    cases[f"bf16_sync_{name}"] = sharded(lambda t, wt: hierarchical_sync(
        t, int(SyncLevel[name])))
np.savez(sys.argv[1], **{f"{c}/{leaf}": np.asarray(t[leaf], np.float32)
                         for c, t in cases.items() for leaf in ("a", "b")},
         **{f"{c}/{leaf}/dtype": str(t[leaf].dtype)
            for c, t in cases.items() for leaf in ("a", "b")})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(torch results by rank, JAX results stacked over ranks)."""
    tmp = tmp_path_factory.mktemp("hierarchy_dist")
    mp.start_processes(worker.run, args=(str(tmp / "store"), str(tmp)),
                       nprocs=worker.WORLD, join=True, start_method="spawn")
    ranks = []
    for r in range(worker.WORLD):
        with np.load(tmp / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(SRC), str(TESTS)])}
    out = tmp / "jax.npz"
    subprocess.run([sys.executable, "-c", JAX_SIDE, str(out)], env=env,
                   check=True, timeout=120)
    with np.load(out) as z:
        jax_side = {k: z[k] for k in z.files}
    return ranks, jax_side


def stacked(ranks, case, leaf):
    return np.stack([r[f"{case}/{leaf}"] for r in ranks])


def group_mean(x, axis, weights=None):
    """Each rank's mean over its group along ``axis``, in float64."""
    w = np.ones(len(x)) if weights is None else np.asarray(weights)
    out = np.empty(x.shape, np.float64)
    for group in GROUPS[axis]:
        wg = w[group].reshape((-1,) + (1,) * (x.ndim - 1))
        out[group] = (wg * x[group].astype(np.float64)).sum(0) / wg.sum()
    return out


def want(case, leaf):
    x = worker.inputs()[leaf]
    if case.startswith("mean_"):
        return group_mean(x, case[5:])
    if case.startswith("wmean_"):
        return group_mean(x, case[6:], worker.WEIGHTS)
    level = case.rsplit("_", 1)[1]
    if level == "LOCAL":
        return x
    edge = group_mean(x, "data", worker.WEIGHTS)
    return edge if level == "EDGE" else group_mean(edge, "pod")


MEAN_CASES = [f"{kind}_{axis}" for kind in ("mean", "wmean")
              for axis in ("data", "pod")]
SYNC_CASES = [f"sync_{name}" for name in worker.LEVELS]


@pytest.mark.parametrize("case", MEAN_CASES + SYNC_CASES)
def test_collective_matches_numpy(runs, case):
    ranks, _ = runs
    for leaf in LEAVES:
        np.testing.assert_allclose(stacked(ranks, case, leaf),
                                   want(case, leaf), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("case", MEAN_CASES + SYNC_CASES)
def test_collective_matches_jax(runs, case):
    ranks, jax_side = runs
    for leaf in LEAVES:
        np.testing.assert_allclose(stacked(ranks, case, leaf),
                                   jax_side[f"{case}/{leaf}"], rtol=RTOL,
                                   atol=1e-7)


@pytest.mark.parametrize("name", worker.LEVELS)
def test_level_and_weight_as_tensors(runs, name):
    """A 0-d tensor level and weight give the int level's bits."""
    ranks, _ = runs
    for leaf in LEAVES:
        assert np.array_equal(stacked(ranks, f"sync_tensor_{name}", leaf),
                              stacked(ranks, f"sync_{name}", leaf))


def test_cloud_drops_the_weight_at_the_pod_step(runs):
    """CLOUD is the unweighted mean of the pods' weighted means, the same
    on every rank, and not the weighted mean over all four ranks."""
    ranks, _ = runs
    got = stacked(ranks, "sync_CLOUD", "a")
    assert all(np.array_equal(got[0], g) for g in got)
    x = worker.inputs()["a"].astype(np.float64)
    w = np.asarray(worker.WEIGHTS)[:, None]
    assert not np.allclose(got[0], (w * x).sum(0) / w.sum(), rtol=1e-4)


def test_inputs_untouched_and_float32(runs):
    ranks, _ = runs
    data = worker.inputs()
    for leaf in LEAVES:
        assert np.array_equal(stacked(ranks, "inputs_after", leaf),
                              data[leaf])
    for r in ranks:
        assert r["dtypes"].tolist() == ["torch.float32"]


def test_mesh_helpers(runs):
    """``batch_axes`` and ``n_pods`` on the (pod, data) mesh and on the
    default (data, model) one, and the mesh's axis sizes."""
    ranks, _ = runs
    for r in ranks:
        assert r["batch_axes"].tolist() == ["pod", "data"]
        assert int(r["n_pods"]) == 2
        assert r["plain_batch_axes"].tolist() == ["data"]
        assert int(r["plain_n_pods"]) == 1
        assert int(r["pod_size"]) == int(r["data_size"]) == 2


def bf16_ulp(x):
    """One bfloat16 ulp at each |x| (8 bits of significand)."""
    x = np.abs(np.asarray(x, np.float32))
    exp = np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7)


@pytest.mark.parametrize("case", MEAN_CASES + SYNC_CASES)
def test_bf16_leaves_match_jax_within_an_ulp(runs, case):
    """A bfloat16 tree's means stay bfloat16 (accumulated in float32, cast
    back once) and lie within one bfloat16 ulp of JAX's ``psum_mean`` /
    ``hierarchical_sync`` of the same bfloat16 tree under ``shard_map``
    (JAX's unweighted means keep bfloat16; a float32 weight promotes its
    weighted ones to float32, which the ulp bound covers; the syncs run
    unweighted, since JAX's ``lax.switch`` refuses branches of bfloat16 and
    float32)."""
    ranks, jax_side = runs
    for r in ranks:
        assert r["bf16_dtypes"].tolist() == ["torch.bfloat16"]
    for leaf in LEAVES:
        got = stacked(ranks, f"bf16_{case}", leaf)
        want = jax_side[f"bf16_{case}/{leaf}"]
        if case.startswith(("mean_", "sync_")):
            assert str(jax_side[f"bf16_{case}/{leaf}/dtype"]) == "bfloat16"
        assert np.all(np.abs(got - want) <= bf16_ulp(want)), case
