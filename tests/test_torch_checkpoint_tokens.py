"""Port parity: ``repro_torch.data.TokenPipeline``,
``repro_torch.checkpoint`` and ``repro_torch.runtime.fault_tolerance``
against the JAX package.

- ``TokenPipeline``: bit-identical batches (numpy, the same generator
  calls in the same order), for every process slice.
- Checkpoints: the same on-disk format, so a checkpoint written by JAX's
  ``save_checkpoint`` restores in the port and one written by the port in
  JAX, bit for bit, leaf names included, also split over several shards
  under a small ``max_shard_bytes``; ``CheckpointManager`` keeps the last
  k steps.
- Fault tolerance: ``StragglerPolicy`` masks and ``FailureInjector``
  membership sequences are identical (numpy); ``retry_with_backoff``
  sleeps and re-raises the same way; ``ElasticReassociator`` on the port's
  engine lands on the JAX engine's assignments before and after a
  membership change (costs at rtol 2e-4, the association tests' pin).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.data import TokenPipeline
from repro_torch.runtime import (ElasticReassociator, FailureInjector,
                                 StragglerPolicy, retry_with_backoff)
from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jck
    from repro import runtime as jrt
    from repro.core import scenario as jsc
    from repro.data import TokenPipeline as JTokenPipeline
except ImportError:
    jax = None

torch.set_num_threads(2)


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index,count", [(0, 1), (1, 2)])
def test_token_pipeline_is_bit_identical(index, count):
    need_jax()
    args = (97, 33, 4)
    kw = dict(seed=3, process_index=index, process_count=count)
    tp, jp = TokenPipeline(*args, **kw), JTokenPipeline(*args, **kw)
    for _ in range(3):
        a, b = next(tp), next(jp)
        assert a.dtype == b.dtype == np.int32
        assert a.shape == (4 // count, 34)
        np.testing.assert_array_equal(a, b)


def test_token_pipeline_is_bit_identical_at_a_full_vocabulary():
    # qwen3's vocabulary: the draw reads one CDF built once
    need_jax()
    args, kw = (151_936, 257, 2), dict(seed=0)
    tp, jp = TokenPipeline(*args, **kw), JTokenPipeline(*args, **kw)
    for _ in range(2):
        np.testing.assert_array_equal(next(tp), next(jp))


def test_token_pipeline_checks_the_batch_split():
    with pytest.raises(ValueError):
        TokenPipeline(10, 8, 3, process_count=2)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def train_state(seed):
    """A tree shaped like a hierarchical train state: pod-stacked params,
    AdamW moments, the step."""
    r = np.random.default_rng(seed)

    def params():
        return {"embed": {"table": r.normal(size=(2, 50, 8))
                          .astype(np.float32)},
                "blocks": {"attn": {"wq": {"w": r.normal(size=(2, 3, 8, 8))
                                           .astype(np.float32)}},
                           "norm1": {"scale": r.normal(size=(2, 3, 8))
                                     .astype(np.float32)}}}

    return {"params": params(), "opt": {"m": params(), "v": params()},
            "step": np.asarray(7, np.int32)}


def assert_same(got_leaves, want_leaves):
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("max_shard_bytes", [1 << 30, 2048])
def test_jax_checkpoint_restores_in_the_port(tmp_path, max_shard_bytes):
    need_jax()
    state = train_state(0)
    jck.save_checkpoint(str(tmp_path), 5, jax.tree.map(jnp.asarray, state),
                        extras={"mode": "hierarchical"},
                        max_shard_bytes=max_shard_bytes)
    n_shards = len([f for f in os.listdir(tmp_path / "step_0000000005")
                    if f.startswith("shard_")])
    assert (n_shards > 1) == (max_shard_bytes == 2048)
    template = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(
        a).dtype), state)
    step, got, extras = load_checkpoint(str(tmp_path), template=template)
    assert (step, extras) == (5, {"mode": "hierarchical"})
    assert_same(tree_leaves(got), jax.tree.leaves(state))


@pytest.mark.parametrize("max_shard_bytes", [1 << 30, 2048])
def test_port_checkpoint_restores_in_jax(tmp_path, max_shard_bytes):
    need_jax()
    state = train_state(1)
    tstate = tree_map(torch.tensor, state)
    save_checkpoint(str(tmp_path), 9, tstate, extras={"k": 1},
                    max_shard_bytes=max_shard_bytes)
    step, got, extras = jck.load_checkpoint(
        str(tmp_path), template=jax.tree.map(jnp.asarray, state))
    assert (step, extras) == (9, {"k": 1})
    assert_same(jax.tree.leaves(got), tree_leaves(tstate))
    # the same leaf names, in the same order
    _, raw_j, _ = jck.load_checkpoint(str(tmp_path))
    names = ["/".join(map(str, p)) for p, _ in tree_leaves_with_path(tstate)]
    assert sorted(raw_j) == sorted(names)
    assert names == ["/".join(str(k.key) for k in p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(state)[0]]


def test_checkpoint_manager_keeps_the_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = tree_map(torch.tensor, train_state(2))
    for s in range(1, 6):
        mgr.save(s, state, extras={"s": s})
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000004",
                                            "step_0000000005"]
    assert mgr.latest_step() == 5
    step, got, extras = mgr.restore(state)
    assert (step, extras) == (5, {"s": 5})
    assert_same(tree_leaves(got), tree_leaves(state))
    step, _, _ = mgr.restore(state, step=4)
    assert step == 4
    sync = CheckpointManager(str(tmp_path / "sync"), keep=1,
                             async_save=False)
    sync.save(1, state)
    sync.save(2, state)
    assert os.listdir(tmp_path / "sync") == ["step_0000000002"]


def test_load_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_straggler_policy_and_failure_injector_match_jax():
    need_jax()
    r = np.random.default_rng(4)
    for deadline, slack, least in ((1.0, 1.1, 1), (0.2, 1.0, 3)):
        times = r.uniform(0.1, 2.0, 40)
        np.testing.assert_array_equal(
            StragglerPolicy(deadline, slack, least).mask(times),
            jrt.StragglerPolicy(deadline, slack, least).mask(times))
    a = FailureInjector(50, p_fail=0.1, p_recover=0.3, seed=5)
    b = jrt.FailureInjector(50, p_fail=0.1, p_recover=0.3, seed=5)
    for _ in range(10):
        np.testing.assert_array_equal(a.step(), b.step())


def test_retry_with_backoff():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert retry_with_backoff(flaky, base_delay=0.5,
                              sleep=sleeps.append) == "ok"
    assert sleeps == [0.5, 1.0]
    with pytest.raises(OSError):
        retry_with_backoff(lambda: (_ for _ in ()).throw(OSError("down")),
                           max_attempts=2, sleep=sleeps.append)
    with pytest.raises(ValueError):          # not retried
        retry_with_backoff(lambda: int("x"), sleep=sleeps.append)


def test_elastic_reassociator_matches_jax():
    need_jax()
    from test_torch_assoc_fast import port_scenario
    js = jsc.make_scenario(14, 3, seed=6)
    want = jrt.ElasticReassociator(js, seed=0)
    got = ElasticReassociator(port_scenario(js), seed=0, device="cpu")
    alive = np.ones(14, bool)
    alive[[2, 9]] = False
    for a, b in ((want.initial(), got.initial()),
                 (want.on_membership_change(alive),
                  got.on_membership_change(alive))):
        np.testing.assert_array_equal(a.assignment, b.assignment)
        assert b.total_cost == pytest.approx(a.total_cost, rel=2e-4)
