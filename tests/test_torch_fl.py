"""Port parity: the FL side — tree helpers, federated datasets, the paper's
models, the sync schedule, and the HFEL/FedAvg trainer.

The JAX package is the oracle. Datasets are numpy on both sides and must be
bit-identical. Elementwise float32 math (trees, logits, losses) holds to
rtol 1e-6. The trainers start from the same omega^0 (the JAX trainer's
init, carried across with ``fl_params_from_numpy``) and must hold client
params to rtol 1e-5 / atol 1e-6 after one HFEL or FedAvg round: the port's
means go through the ``hier_aggregate`` kernel's plain version where the
JAX trainer uses ``segment_sum``, and its matrix products are PyTorch's,
so they round differently. Histories over 3 rounds hold the loss to rtol
1e-4 and accuracies to one test sample.

The JAX trainer's property tests (``tests/test_fl_training.py``) are
repeated on the port through the repo's hypothesis shim.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.configs.paper_mnist as jcfg
import repro.core.hierarchy as jh
import repro.data as jdata
import repro.fl as jfl
import repro.utils as jutils
import repro_torch.configs as tcfg
import repro_torch.core.hierarchy as th
import repro_torch.data as tdata
import repro_torch.fl as tfl
import repro_torch.utils as tutils
from repro_torch import convert
from repro_torch.fl import training as ttr
from repro_torch.kernels import hier_aggregate as tha

torch.set_num_threads(2)


def as_np(tree):
    return [np.asarray(x) for x in tutils.tree_leaves(tree)]


# -- utils/trees ---------------------------------------------------------------

def _trees(seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(3, 4)).astype(np.float32),
             "b": [rng.normal(size=(5,)).astype(np.float32),
                   rng.normal(size=(2, 2)).astype(np.float32)]}
            for _ in range(3)]


def _to(tree, fn):
    return {"w": fn(tree["w"]), "b": [fn(x) for x in tree["b"]]}


TREE_CASES = {
    "tree_add": lambda u, t: u.tree_add(t[0], t[1]),
    "tree_sub": lambda u, t: u.tree_sub(t[0], t[1]),
    "tree_scale": lambda u, t: u.tree_scale(t[0], 0.3),
    "tree_zeros_like": lambda u, t: u.tree_zeros_like(t[0]),
    "tree_cast": lambda u, t: u.tree_cast(
        t[0], torch.float16 if u is tutils else jnp.float16),
    "tree_weighted_mean": lambda u, t: u.tree_weighted_mean(
        t, np.asarray([20.0, 35.0, 71.0], np.float32)),
    "tree_global_norm": lambda u, t: u.tree_global_norm(t[0]),
    "tree_size": lambda u, t: u.tree_size(t[0]),
}


@pytest.mark.parametrize("name", sorted(TREE_CASES))
def test_trees_match_jax(name):
    raw = _trees(1)
    got = TREE_CASES[name](tutils, [_to(t, torch.tensor) for t in raw])
    want = TREE_CASES[name](jutils, [_to(t, jnp.asarray) for t in raw])
    if name == "tree_size":
        assert got == want == 21
        return
    got_leaves = ([got] if isinstance(got, torch.Tensor)
                  else tutils.tree_leaves(got))
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-6,
                                   atol=1e-7)


def test_tree_unflatten_inverts_tree_leaves():
    tree = _to(_trees(2)[0], torch.tensor)
    again = tutils.tree_unflatten(tree, tutils.tree_leaves(tree))
    assert isinstance(again["b"], list)
    assert all(a is b for a, b in zip(tutils.tree_leaves(again),
                                      tutils.tree_leaves(tree)))
    with pytest.raises(ValueError):
        tutils.tree_unflatten(tree, tutils.tree_leaves(tree) * 2)


# -- data/federated ------------------------------------------------------------

@pytest.mark.parametrize("maker,n_clients,dim,samples_total,seed", [
    ("make_mnist_like", 8, 16, 400, 0),
    ("make_mnist_like", 30, 64, 6000, 1),
    ("make_femnist_like", 12, 32, 1500, 2),
    ("make_femnist_like", 5, 8, 300, 3),
])
def test_datasets_are_bit_identical(maker, n_clients, dim, samples_total,
                                    seed):
    got = getattr(tdata, maker)(n_clients, dim=dim,
                                samples_total=samples_total, seed=seed)
    want = getattr(jdata, maker)(n_clients, dim=dim,
                                 samples_total=samples_total, seed=seed)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert np.array_equal(g, w), f.name
        assert np.asarray(g).dtype == np.asarray(w).dtype, f.name
    assert (got.n_clients, got.dim) == (n_clients, dim)


def test_partition_power_law_is_bit_identical():
    for seed in (0, 5):
        assert np.array_equal(
            tdata.partition_power_law(5000, 40, rng=np.random.default_rng(
                seed)),
            jdata.partition_power_law(5000, 40, rng=np.random.default_rng(
                seed)))


def test_paper_config_is_copied():
    assert (dataclasses.asdict(tcfg.CONFIG)
            == dataclasses.asdict(jcfg.CONFIG))
    assert tcfg.PaperTaskConfig is not jcfg.PaperTaskConfig


# -- fl/fl_model ---------------------------------------------------------------

def _model_inputs(model, batch, seed):
    rng = np.random.default_rng(seed)
    dim, classes, s = 12, 5, 9
    shapes = {"mlr": {"w": (dim, classes), "b": (classes,)},
              "mlp": {"w1": (dim, 128), "b1": (128,), "w2": (128, classes),
                      "b2": (classes,)}}[model]
    lead = (batch,) if batch else ()
    params = {k: (rng.normal(size=lead + v) * 0.3).astype(np.float32)
              for k, v in shapes.items()}
    x = rng.normal(size=lead + (s, dim)).astype(np.float32)
    y = rng.integers(0, classes, lead + (s,)).astype(np.int32)
    y[..., -2:] = -1                                   # padding
    return params, x, y


@pytest.mark.parametrize("batch", [0, 4])
@pytest.mark.parametrize("model", ["mlr", "mlp"])
def test_model_functions_match_jax(model, batch):
    params, x, y = _model_inputs(model, batch, 3)
    t_logits_fn = tfl.MODELS[model][1]
    j_logits_fn = jfl.MODELS[model][1]
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tx, ty, jx, jy = torch.tensor(x), torch.tensor(y), jnp.asarray(x), \
        jnp.asarray(y)

    def jfn(f):
        return jax.vmap(f, in_axes=(0, 0, 0)) if batch else f

    got_logits = t_logits_fn(tp, tx)
    want_logits = (jax.vmap(j_logits_fn) if batch else j_logits_fn)(jp, jx)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-6, atol=1e-6)
    got_loss = tfl.masked_loss(t_logits_fn, tp, tx, ty)
    want_loss = jfn(lambda p, a, b: jfl.masked_loss(j_logits_fn, p, a, b))(
        jp, jx, jy)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               rtol=1e-6)
    got_acc = tfl.accuracy(t_logits_fn, tp, tx, ty)
    want_acc = jfn(lambda p, a, b: jfl.accuracy(j_logits_fn, p, a, b))(
        jp, jx, jy)
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_acc),
                               rtol=1e-6)


@pytest.mark.parametrize("model", ["mlr", "mlp"])
def test_model_init_shapes_and_seed(model):
    init = tfl.MODELS[model][0]
    a = init(torch.Generator().manual_seed(3), 10, 4)
    b = init(torch.Generator().manual_seed(3), 10, 4)
    ref = jfl.MODELS[model][0](jax.random.key(0), 10, 4)
    assert sorted(a) == sorted(ref)
    for k in a:
        assert tuple(a[k].shape) == ref[k].shape and torch.equal(a[k], b[k])
        assert a[k].dtype == torch.float32


# -- core/hierarchy ------------------------------------------------------------

@pytest.mark.parametrize("local_iters,edge_iters", [(1, 1), (3, 2), (10, 5),
                                                    (4, 1)])
def test_sync_schedule_matches_jax(local_iters, edge_iters):
    got = th.SyncSchedule(local_iters, edge_iters)
    want = jh.SyncSchedule(local_iters, edge_iters)
    n = 3 * local_iters * edge_iters + 2
    assert [int(got.level(s)) for s in range(n)] == [
        int(want.level(s)) for s in range(n)]
    assert np.array_equal(got.level_array(n).numpy(),
                          np.asarray(want.level_array(n)))
    assert got.cloud_period == want.cloud_period


def test_simulation_scale_aggregates_match_jax():
    raw = _trees(4)
    w = [30.0, 12.0, 50.0]
    for fn in ("edge_aggregate", "cloud_aggregate"):
        got = getattr(th, fn)([_to(t, torch.tensor) for t in raw], w)
        want = getattr(jh, fn)([_to(t, jnp.asarray) for t in raw], w)
        for g, x in zip(tutils.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-6,
                                       atol=1e-7)
    # the datacenter-scale collectives take a mesh (their parity over four
    # gloo ranks is test_torch_hierarchy_dist.py's); LOCAL needs none
    tree = {"a": torch.ones(2)}
    assert th.hierarchical_sync(tree, th.SyncLevel.LOCAL, mesh=None) is tree
    with pytest.raises(TypeError, match="mesh"):
        th.psum_mean(tree, "data")


# -- fl/training: the trainer against the JAX trainer --------------------------

_DS8 = dict(n_clients=8, samples_total=800, seed=0)
# server 1 is fully masked (clients 2, 3), server 2 has no member, and
# client 6 of the live server 3 is masked
MASK8 = np.array([1, 1, 0, 0, 1, 1, 0, 1], bool)
ASSIGN8 = np.array([0, 0, 1, 1, 3, 3, 3, 0])


def _pair(model, lr=0.05):
    """The JAX trainer and the port's on the CPU, from the same omega^0."""
    jt = jfl.FederatedTrainer(jdata.make_mnist_like(**_DS8), model=model,
                              lr=lr)
    tt = tfl.FederatedTrainer(tdata.make_mnist_like(**_DS8), model=model,
                              lr=lr, device="cpu")
    omega0 = {k: np.asarray(v) for k, v in jt.global_params().items()}
    tt.client_params = convert.fl_params_from_numpy(omega0, 8, device="cpu")
    return jt, tt


def _close(jt, tt, rtol=1e-5, atol=1e-6):
    want = jt.client_params
    got = tt.client_params
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("model", ["mlr", "mlp"])
def test_trainer_rounds_match_jax(model):
    jt, tt = _pair(model)
    _close(jt, tt, rtol=0, atol=0)
    jt.client_mask = jnp.asarray(MASK8)
    tt.client_mask = MASK8
    jt.hfel_round(jnp.asarray(ASSIGN8), 4, 10, 5)
    before = tha.LAUNCHES
    tt.hfel_round(ASSIGN8, 4, 10, 5)
    assert tha.LAUNCHES == before        # the CPU path launches nothing
    _close(jt, tt)
    jt.fedavg_round(10, 5)
    tt.fedavg_round(10, 5)
    _close(jt, tt)
    m_t, m_j = tt.evaluate(), jt.evaluate()
    np.testing.assert_allclose(m_t["train_loss"], m_j["train_loss"],
                               rtol=1e-5)


def test_edge_aggregate_keeps_dead_group_and_broadcasts_to_masked():
    """One edge aggregation alone, from distinct client params: the fully
    masked server 1 keeps its clients' params, the masked client 6 of a
    live server receives its group's mean, as in the JAX trainer."""
    jt, tt = _pair("mlr")
    shift = np.arange(8, dtype=np.float32)
    jt.client_params = jax.tree.map(
        lambda p: p + jnp.asarray(shift).reshape((8,) + (1,) * (p.ndim - 1)),
        jt.client_params)
    tt.client_params = {k: v + torch.tensor(shift).reshape(
        (8,) + (1,) * (v.dim() - 1)) for k, v in tt.client_params.items()}
    jt.client_mask = jnp.asarray(MASK8)
    tt.client_mask = MASK8
    before = tt.client_params["w"].clone()
    jt.edge_aggregate(jnp.asarray(ASSIGN8), 4)
    tt.edge_aggregate(ASSIGN8, 4)
    _close(jt, tt)
    after = tt.client_params["w"]
    assert torch.equal(after[2:4], before[2:4])
    assert torch.equal(after[6], after[4]) and torch.equal(after[0], after[7])


@pytest.mark.parametrize("arrivals,mask,assignment", [
    # client 3 joins server 1 (donor: client 2); client 5 joins server 2
    ([0, 0, 0, 1, 0, 1, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1],
     [0, 0, 1, 1, 2, 2, 0, 0]),
    # client 7 joins an otherwise empty server 3: global donor mean
    ([0, 0, 0, 0, 0, 0, 0, 1], [1, 1, 1, 0, 1, 1, 1, 1],
     [0, 0, 1, 1, 2, 2, 2, 3]),
    # nobody can donate: the arrival keeps its params
    ([1, 0, 0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0, 0, 0],
     [0, 0, 1, 1, 2, 2, 2, 3]),
])
def test_readmit_clients_matches_jax(arrivals, mask, assignment):
    jt, tt = _pair("mlr")
    rng = np.random.default_rng(8)
    shift = rng.normal(size=8).astype(np.float32)
    jt.client_params = jax.tree.map(
        lambda p: p + jnp.asarray(shift).reshape((8,) + (1,) * (p.ndim - 1)),
        jt.client_params)
    tt.client_params = {k: v + torch.tensor(shift).reshape(
        (8,) + (1,) * (v.dim() - 1)) for k, v in tt.client_params.items()}
    arrivals, mask = np.asarray(arrivals, bool), np.asarray(mask, bool)
    jt.client_mask = jnp.asarray(mask)
    tt.client_mask = mask
    jt.readmit_clients(jnp.asarray(arrivals), jnp.asarray(assignment), 4)
    tt.readmit_clients(arrivals, np.asarray(assignment), 4)
    _close(jt, tt)


class _StartFrom:
    """Round policy that sets the trainer's omega^0 before round 0 and
    keeps the assignment."""

    def __init__(self, omega0):
        self.omega0 = omega0

    def begin_round(self, trainer, r):
        if r == 0:
            trainer.client_params = convert.fl_params_from_numpy(
                self.omega0, trainer.ds.n_clients, device="cpu")
        return None


@pytest.mark.parametrize("method", ["hfel", "fedavg"])
@pytest.mark.parametrize("model", ["mlr", "mlp"])
def test_train_federated_history_matches_jax(model, method):
    jds = jdata.make_mnist_like(**_DS8)
    omega0 = {k: np.asarray(v) for k, v in jfl.FederatedTrainer(
        jds, model=model, lr=0.05).global_params().items()}
    kw = dict(method=method, assignment=ASSIGN8, n_servers=4, rounds=3,
              local_iters=5, edge_iters=2, lr=0.05, model=model)
    want = jfl.train_federated(jds, **kw)
    got = tfl.train_federated(tdata.make_mnist_like(**_DS8),
                              round_hook=_StartFrom(omega0), device="cpu",
                              **kw)
    assert got.eval_rounds == want.eval_rounds == [0, 1, 2]
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-4)
    one = 1.0 / len(jds.test_y) + 1e-6
    assert np.abs(np.subtract(got.test_acc, want.test_acc)).max() <= one
    assert np.abs(np.subtract(got.train_acc, want.train_acc)).max() <= (
        1.0 / jds.client_sizes.sum() + 1e-6)


def test_plain_round_hook_and_eval_every():
    seen = []
    hist = tfl.train_federated(tdata.make_mnist_like(**_DS8), rounds=4,
                               eval_every=3, local_iters=2, edge_iters=1,
                               round_hook=lambda tr, r: seen.append(r),
                               device="cpu")
    assert seen == [0, 1, 2, 3] and hist.eval_rounds == [0, 3]
    assert len(hist.test_acc) == len(hist.train_loss) == 2


def test_entry_points_check_device_and_assignment():
    ds = tdata.make_mnist_like(**_DS8)
    tt = tfl.FederatedTrainer(ds, device="cpu")
    with pytest.raises(ValueError):
        tt.edge_aggregate(np.full(8, 4), 4)          # server out of range
    with pytest.raises(ValueError):
        tt.edge_aggregate(np.zeros(7, int), 4)       # wrong length
    with pytest.raises(ValueError):
        tt.client_mask = np.ones(3, bool)
    with pytest.raises(ValueError):
        tfl.train_federated(ds, method="sgd", rounds=1, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfl.FederatedTrainer(ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfl.train_federated(ds, rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.fl_params_from_numpy({"b": np.zeros(3)}, 2)


def test_fl_params_from_numpy_stacks_one_model():
    got = convert.fl_params_from_numpy(
        {"w": np.arange(6.0).reshape(2, 3), "b": np.ones(3)}, 4,
        device="cpu")
    assert got["w"].shape == (4, 2, 3) and got["w"].dtype == torch.float32
    assert got["w"].is_contiguous() and torch.equal(got["w"][3], got["w"][0])
    got["w"][0, 0, 0] = 7.0                 # each client owns its copy
    assert got["w"][1, 0, 0].item() == 0.0


# -- the JAX trainer's property tests, on the port -----------------------------

def test_hfel_equals_fedavg_when_one_edge_iter_one_server():
    """With K=1, I=1, HFEL degenerates to FedAvg exactly."""
    ds = tdata.make_mnist_like(8, samples_total=800, seed=0)
    h1 = tfl.train_federated(ds, method="hfel", assignment=np.zeros(8, int),
                             n_servers=1, rounds=3, local_iters=5,
                             edge_iters=1, lr=0.05, device="cpu")
    h2 = tfl.train_federated(ds, method="fedavg", rounds=3, local_iters=5,
                             edge_iters=1, lr=0.05, device="cpu")
    np.testing.assert_allclose(h1.train_loss, h2.train_loss, rtol=1e-5)


def test_aggregation_weights_match_eq8():
    ds = tdata.make_mnist_like(4, samples_total=400, seed=2)
    tr = tfl.FederatedTrainer(ds, lr=0.05, device="cpu")
    base = tr.client_params["b"].clone()
    w = torch.tensor(ds.client_sizes)
    tr.client_params = {k: v + torch.arange(4.0).reshape(
        (4,) + (1,) * (v.dim() - 1)) for k, v in tr.client_params.items()}
    tr.edge_aggregate(np.zeros(4, int), 1)
    expect_shift = float((w * torch.arange(4.0)).sum() / w.sum())
    got = tr.client_params["b"]
    np.testing.assert_allclose(float(got[0, 0] - base[0, 0]), expect_shift,
                               rtol=1e-5)


def test_client_mask_excludes_stragglers_from_aggregation():
    ds = tdata.make_mnist_like(4, samples_total=400, seed=3)
    tr = tfl.FederatedTrainer(ds, lr=0.05, device="cpu")
    tr.client_params["b"][3] = 1e6
    tr.client_mask = [True, True, True, False]
    tr.cloud_aggregate()
    assert float(tr.client_params["b"].abs().max()) < 1e3


_DS6 = tdata.make_mnist_like(6, samples_total=500, seed=4)


def _trainer(param_seed):
    """A 6-client trainer whose per-client params were made distinct (a
    seeded shift), so aggregation actually mixes state."""
    tr = tfl.FederatedTrainer(_DS6, lr=0.05, device="cpu")
    shift = torch.tensor(np.random.default_rng(param_seed).normal(
        0.0, 1.0, (6,)).astype(np.float32))
    tr.client_params = {k: v + shift.reshape((6,) + (1,) * (v.dim() - 1))
                        for k, v in tr.client_params.items()}
    return tr


def _global(tr):
    return [v.clone() for v in tutils.tree_leaves(tr.global_params())]


def _weighted_mean(tr):
    w = tr._weights().numpy().astype(np.float64)
    leaf = tutils.tree_leaves(tr.client_params)[0].numpy().astype(np.float64)
    return (leaf * w.reshape((-1,) + (1,) * (leaf.ndim - 1))).sum(0) / w.sum()


def test_edge_aggregate_empty_server_keeps_client_params():
    tr = _trainer(0)
    before = tutils.tree_leaves(tr.client_params)[0].clone()
    tr.client_mask = [True, True, True, True, False, False]
    tr.edge_aggregate(np.array([0, 0, 0, 0, 1, 1]), 2)  # server 1 masked
    after = tutils.tree_leaves(tr.client_params)[0]
    assert torch.equal(after[4:], before[4:])
    np.testing.assert_allclose(after[0].numpy(), after[3].numpy(), rtol=1e-6)


def test_cloud_aggregate_all_masked_keeps_params():
    tr = _trainer(1)
    before = tutils.tree_leaves(tr.client_params)[0].clone()
    tr.client_mask = np.zeros(6, bool)
    tr.cloud_aggregate()
    assert torch.equal(tutils.tree_leaves(tr.client_params)[0], before)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000), n_servers=st.integers(1, 4))
def test_cloud_aggregate_invariant_to_assignment(seed, n_servers):
    """edge_aggregate(a) then cloud_aggregate gives the SAME global model
    for every assignment ``a``."""
    rng = np.random.default_rng(seed)
    globals_ = []
    for _ in range(2):
        tr = _trainer(seed)
        tr.edge_aggregate(rng.integers(0, n_servers, 6), n_servers)
        tr.cloud_aggregate()
        globals_.append(_global(tr))
    for a, b in zip(*globals_):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000), mask_bits=st.integers(1, 62))
def test_edge_aggregate_conserves_weighted_mean(seed, mask_bits):
    """The participating-weighted mean of the client fleet is unchanged by
    edge aggregation, for any participation mask and assignment."""
    rng = np.random.default_rng(seed)
    tr = _trainer(seed)
    mask = np.array([(mask_bits >> i) & 1 for i in range(6)], bool)
    if not mask.any():
        mask[0] = True
    tr.client_mask = mask
    before = _weighted_mean(tr)
    tr.edge_aggregate(rng.integers(0, 3, 6), 3)
    np.testing.assert_allclose(_weighted_mean(tr), before, rtol=1e-5,
                               atol=1e-6)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000), garbage=st.floats(1e3, 1e8))
def test_masked_client_never_influences_global_model(seed, garbage):
    """A departed (masked) client's parameters are inert: perturbing them
    arbitrarily changes NOTHING about the post-aggregation global model."""
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, 3, 6)
    outs = []
    for junk in (garbage, -2.0 * garbage):
        tr = _trainer(seed)
        tr.client_mask = [True, True, True, True, True, False]
        tr.flat[5] = junk
        tr.edge_aggregate(assignment, 3)
        tr.cloud_aggregate()
        outs.append(_global(tr))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_readmit_fallback_properties():
    """The JAX readmit test's two cases on the port: an arrival takes its
    edge's donor, and one joining an otherwise empty edge takes the global
    donor mean."""
    tr = _trainer(2)
    arrivals = np.array([False, False, False, True, False, True])
    tr.client_mask = np.array([True, True, True, False, True, False]) \
        | arrivals
    tr.readmit_clients(arrivals, np.array([0, 0, 1, 1, 2, 2]), 3)
    leaf = tutils.tree_leaves(tr.client_params)[0]
    np.testing.assert_allclose(leaf[3].numpy(), leaf[2].numpy(), rtol=1e-6)
    np.testing.assert_allclose(leaf[5].numpy(), leaf[4].numpy(), rtol=1e-6)
    tr2 = _trainer(3)
    arrivals2 = np.array([False] * 5 + [True])
    tr2.client_mask = np.ones(6, bool)
    probe = _trainer(3)
    probe.client_mask = np.array([True] * 5 + [False])
    donors_mean = _weighted_mean(probe)
    tr2.readmit_clients(arrivals2, np.array([0, 0, 0, 1, 1, 2]), 3)
    got = tutils.tree_leaves(tr2.client_params)[0][5].numpy()
    np.testing.assert_allclose(got, donors_mean, rtol=1e-5)
