"""Port parity: training, serving and checkpoints over a mesh of ranks
against the port's one-rank step (which ``test_torch_train_step`` holds to
JAX).

Four gloo ranks are spawned once per mesh (a module fixture running
``_torch_mesh_worker.run``, ~6 s a spawn): on (data=2, model=2) a
``sync`` step of reduced qwen3 in ``fsdp`` and in ``tp`` mode and of every
other family (deepseek, kimi-k2, mamba2, zamba2, whisper, internvl2) in
``fsdp``, one reduced MoE layer of deepseek and kimi-k2 (experts split
over ``model``) at capacity factors 1.25 and 0.5 and with a planted fault
(the combine's sum over ``model`` dropped), ``collectives.all_to_all``,
greedy serving of reduced qwen3 and deepseek, and a checkpoint saved from
that mesh and restored onto (data=4, model=1); on (pod=2, data=2,
model=1) olmo-1b's ``hierarchical`` steps (4, a cloud sync every 2, the
JAX launcher test's case) and mamba2's, zamba2's, whisper's and
internvl2's alike, reduced deepseek's (2 and a sync: each pod's MoE
capacity its own) and the DTensor placements of two axes on one
dim. Rank 0 writes what it gathered; the test process runs the one-rank
step on the same params and batches, and the MoE layer's oracle, the JAX
package's unsharded ``moe_apply`` (skipped without JAX).

Tolerances are ``test_torch_train_step``'s: the loss at rtol 1e-5; the
state after a step at rtol 1e-4, atol 1e-4 x the leaf's largest value,
except parameter entries whose one-rank gradient is within that tolerance
of zero, which AdamW's first step moves by up to lr either way (held to
lr), and whisper's key biases, whose exact gradient is zero (their
moments held at the scale of the same projection's weight's). Greedy
tokens are equal, decode logits within 1e-4; a restored block is equal
bit for bit. The MoE layer against JAX: y and aux at 1e-5 (as
``test_torch_moe``), the kept pairs exactly, the gradients at 1e-4."""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_worker as worker
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.utils import (tree_leaves, tree_leaves_with_path, tree_map,
                               tree_unflatten)

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
except ImportError:
    jax = None

RTOL = 1e-4
LOSS_RTOL = 1e-5
FAMILIES = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-1.3b",
            "zamba2-2.7b", "whisper-large-v3", "internvl2-1b"]
SYNC_CASES = [("qwen3-0.6b", "fsdp"), ("qwen3-0.6b", "tp")] + [
    (a, "fsdp") for a in FAMILIES]
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_CASES = [(a, cf) for a in (MOE_ARCH, "kimi-k2-1t-a32b")
             for cf in (1.25, 0.5)]
MOE_TOL = 1e-5           # test_torch_moe's: y and aux against JAX
HIER_FAMILIES = ["mamba2-1.3b", "zamba2-2.7b", "whisper-large-v3",
                 "internvl2-1b"]


def spawn(tmp, mesh_shape, axes, cases) -> dict:
    """Run ``cases`` on four spawned ranks; rank 0's results by name."""
    mp.start_processes(worker.run, args=(4, str(tmp / "store"), str(tmp),
                                         mesh_shape, axes, cases),
                       nprocs=4, join=True, start_method="spawn")
    out = {}
    for name, _, _ in cases:
        with np.load(tmp / f"{name}.npz") as z:
            out[name] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh22")
    cases = [(f"{a}-{m}", "train_case",
              dict(arch=a, mode="sync", sharding_mode=m))
             for a, m in SYNC_CASES]
    cases += [(f"moe-{a}-{cf}", "moe_case", dict(arch=a, cf=cf))
              for a, cf in MOE_CASES]
    cases += [("moe-fault", "moe_case", dict(arch=MOE_ARCH, cf=1.25,
                                             fault=True)),
              ("all_to_all", "all_to_all_case", {}),
              ("serve-moe", "serve_case", dict(arch=MOE_ARCH)),
              ("serve", "serve_case", {}),
              ("restore", "restore_case",
               dict(other=((4, 1), ("data", "model")),
                    directory=str(tmp / "ckpt")))]
    return spawn(tmp, (2, 2), ("data", "model"), cases)


@pytest.fixture(scope="module")
def mesh221(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh221")
    cases = [("olmo-hier", "train_case",
              dict(arch="olmo-1b", mode="hierarchical", sharding_mode="fsdp",
                   steps=worker.HIER_STEPS, period=worker.HIER_PERIOD)),
             ("moe-hier", "train_case",
              dict(arch=MOE_ARCH, mode="hierarchical", sharding_mode="fsdp",
                   steps=worker.HIER_PERIOD, period=worker.HIER_PERIOD)),
             ("placements", "placements_case", {})]
    cases += [(f"{a}-hier", "train_case",
               dict(arch=a, mode="hierarchical", sharding_mode="fsdp",
                    steps=worker.HIER_STEPS, period=worker.HIER_PERIOD))
              for a in HIER_FAMILIES]
    return spawn(tmp, (2, 2, 1), ("pod", "data", "model"), cases)


def one_rank(arch, mode="sync", steps=1, period=0):
    """The one-rank step's whole state, losses and first gradients."""
    model = build_model(worker.config(arch))
    bundle = make_train_step(model, worker.shape(), mode=mode, lr=worker.LR,
                             device="cpu")
    p, o, step = bundle.init_state(worker.params(arch))
    leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
    grads = [g.numpy() for g in torch.autograd.grad(
        model.loss(tree_unflatten(p, leaves), worker.batch(arch, 0)),
        leaves)] if mode == "sync" else None
    losses = []
    for k in range(steps):
        p, o, step, loss = bundle.step_fn(p, o, step, worker.batch(arch, k))
        losses.append(float(loss))
        if period and (k + 1) % period == 0:
            p, o = bundle.cloud_sync_fn(p, o)
    state = {**worker.flat(p, "params/"), **worker.flat(o["m"], "opt/m/"),
             **worker.flat(o["v"], "opt/v/")}
    return state, np.array(losses), grads


def close(got, want, scale=None):
    scale = float(np.abs(want).max() + 1e-30) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def key_bias_scale(state, key):
    """For a key bias of a model without rope (exact gradient zero): the
    largest |value| of the same projection's weight entry in ``state``."""
    if key.endswith("wk/b"):
        return float(np.abs(state[key[:-1] + "w"]).max())
    return None


@pytest.mark.parametrize("arch,mode", SYNC_CASES,
                         ids=[f"{a}-{m}" for a, m in SYNC_CASES])
def test_sync_step_matches_one_rank(mesh22, arch, mode):
    got = mesh22[f"{arch}-{mode}"]
    want, losses, grads = one_rank(arch)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert int(got["step"]) == 1
    names = [k for k in want if k.startswith("params/")]
    zero_grad = worker.config(arch).qkv_bias \
        and not worker.config(arch).use_rope
    for name, g in zip(names, grads):
        a, b, g = got[name], want[name], np.abs(g)
        scale = key_bias_scale(want, name) if zero_grad else None
        tiny = g <= RTOL * (g.max() if scale is None else scale)
        np.testing.assert_array_less(np.abs(a - b)[tiny],
                                     worker.LR * (1 + 1e-6))
        if not tiny.all():
            close(a[~tiny], b[~tiny])
    for name in want:
        if name.startswith("opt/"):
            scale = key_bias_scale(want, name) if zero_grad else None
            close(got[name], want[name], scale)


def test_hierarchical_steps_match_one_card(mesh221):
    """olmo-1b, 4 hierarchical steps with a cloud sync every 2, over
    (pod=2, data=2, model=1) against the one-card step's loop over pods."""
    got = mesh221["olmo-hier"]
    want, losses, _ = one_rank("olmo-1b", "hierarchical",
                               worker.HIER_STEPS, worker.HIER_PERIOD)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert int(got["step"]) == worker.HIER_STEPS
    for name in want:
        assert got[name].shape == want[name].shape, name
        close(got[name], want[name])


def test_moe_hierarchical_steps_match_one_card(mesh221):
    """Reduced deepseek, hierarchical over (pod=2, data=2, model=1): the
    MoE layers over a pod's data ranks (the expert ids gathered over
    ``data`` alone) against the one-card step's loop over pods; 2 steps
    and a cloud sync. Both losses at ``LOSS_RTOL``; both moments at
    ``RTOL``; the params at ``RTOL`` where neither step's gradient is
    tiny, and elsewhere within an AdamW step's size a step (AdamW's step
    is ~``LR`` whatever the size of the gradient, so float32 summation
    noise on a near-zero gradient can move a param by up to ``LR``: the
    rule of ``test_sync_step_matches_one_rank``, with the one card's
    first moments after the first and the last step standing for the
    two gradients)."""
    got = mesh221["moe-hier"]
    steps = worker.HIER_PERIOD
    want, losses, _ = one_rank(MOE_ARCH, "hierarchical", steps, steps)
    first, _, _ = one_rank(MOE_ARCH, "hierarchical", 1, steps)

    def tiny(m):
        return np.abs(m) <= RTOL * np.abs(m).max()

    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert int(got["step"]) == steps
    assert bool(got["synced_equal"].all())
    for name in want:
        assert got[name].shape == want[name].shape, name
        if name.startswith("opt/"):
            close(got[name], want[name])
            continue
        a, b = got[name], want[name]
        m = "opt/m/" + name[len("params/"):]
        noisy = tiny(first[m]) | tiny(want[m])
        np.testing.assert_array_less(np.abs(a - b)[noisy],
                                     steps * worker.LR * (1 + 1e-6))
        if not noisy.all():
            close(a[~noisy], b[~noisy])


@pytest.mark.parametrize("arch", HIER_FAMILIES)
def test_hierarchical_families_match_one_card(mesh221, arch):
    """mamba2, zamba2, whisper and internvl2, 4 hierarchical steps with a
    cloud sync every 2 over (pod=2, data=2, model=1), against the
    one-card step's loop over pods: the pods' copies equal bit for bit
    after each sync; the losses at ``LOSS_RTOL``; both moments at
    ``RTOL`` (whisper's key biases, whose exact gradient is zero, at the
    scale of the same projection's weight). The moments carry the
    gradients' check: after several AdamW steps a param's gap follows
    the ratio of its moments, which float32 summation noise moves by more
    than ``RTOL`` where the gradients cancel across steps (up to 1.5e-4
    of a leaf's largest entry here), so each param is held within an
    AdamW step's size a step (``LR``), the bound of this file's rule for
    near-zero gradients."""
    got = mesh221[f"{arch}-hier"]
    steps, period = worker.HIER_STEPS, worker.HIER_PERIOD
    want, losses, _ = one_rank(arch, "hierarchical", steps, period)
    zero_grad = worker.config(arch).qkv_bias \
        and not worker.config(arch).use_rope
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert int(got["step"]) == steps
    assert got["synced_equal"].shape == (steps // period,)
    assert bool(got["synced_equal"].all())
    for name in want:
        assert got[name].shape == want[name].shape, name
        if name.startswith("opt/"):
            scale = key_bias_scale(want, name) if zero_grad else None
            close(got[name], want[name], scale)
        else:
            np.testing.assert_array_less(np.abs(got[name] - want[name]),
                                         steps * worker.LR * (1 + 1e-6))


def test_pods_equal_after_each_cloud_sync(mesh221):
    synced = mesh221["olmo-hier"]["synced_equal"]
    assert synced.shape == (worker.HIER_STEPS // worker.HIER_PERIOD,)
    assert synced.all()


def test_serve_matches_one_rank(mesh22):
    """Greedy tokens equal and prompt decode logits within 1e-4 of the
    one-rank serve on the same params and prompts."""
    got = mesh22["serve"]
    model = build_model(worker.config("qwen3-0.6b"))
    res = serve(model, worker.params("qwen3-0.6b"), worker.serve_prompts(),
                worker.SERVE_NEW, max_len=worker.SERVE_PROMPT
                + worker.SERVE_NEW, keep_prompt_logits=True)
    np.testing.assert_array_equal(got["tokens"], res.tokens.numpy())
    np.testing.assert_allclose(got["logits"], res.prompt_logits.numpy(),
                               rtol=RTOL, atol=RTOL)


def test_moe_serve_matches_one_rank(mesh22):
    """Reduced deepseek (experts split over ``model``) served greedily over
    (data=2, model=2): the one-rank serve's tokens, decode logits within
    1e-4."""
    got = mesh22["serve-moe"]
    model = build_model(worker.config(MOE_ARCH))
    res = serve(model, worker.params(MOE_ARCH), worker.serve_prompts(MOE_ARCH),
                worker.SERVE_NEW, max_len=worker.SERVE_PROMPT
                + worker.SERVE_NEW, keep_prompt_logits=True)
    np.testing.assert_array_equal(got["tokens"], res.tokens.numpy())
    np.testing.assert_allclose(got["logits"], res.prompt_logits.numpy(),
                               rtol=RTOL, atol=RTOL)


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def jax_moe(arch, cf):
    """The JAX package's unsharded ``moe_apply`` on the worker's inputs:
    (y, aux, the kept pairs of its own slots, the gradients of sum(y * ct)
    + aux with respect to the params tree and x)."""
    from test_torch_moe import jax_kept
    params, x, ct = worker.moe_inputs(arch, cf)
    jcfg = jget(arch).reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    y, aux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))

    def objective(p, xx):
        yy, a = jmoe.moe_apply(p, jcfg, xx)
        return jnp.sum(yy * ct) + a

    grads = jax.grad(objective, argnums=(0, 1))(jp, jnp.asarray(x))
    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x).reshape(t, -1) @ jp["router"]["w"],
                           axis=-1)
    _, ids = jax.lax.top_k(probs, jcfg.moe.top_k)
    cap = max(int(math.ceil(t * jcfg.moe.top_k * cf / jcfg.moe.n_experts)),
              4)
    return np.asarray(y), float(aux), jax_kept(ids, cap)[1], grads


MOE_IDS = [f"{a}-{cf}" for a, cf in MOE_CASES]


@pytest.mark.parametrize("arch,cf", MOE_CASES, ids=MOE_IDS)
def test_moe_layer_matches_jax(mesh22, arch, cf):
    """One reduced MoE layer over (data=2, model=2), experts split over
    ``model``, against the JAX package's unsharded ``moe_apply`` on the
    same inputs and params: y and aux at 1e-5, the same pairs kept and
    dropped (some drop at 0.5, asserted), and the gradients of sum(y * ct)
    + aux at ``RTOL`` (each rank's objective holding its rows and 1/2 of
    aux)."""
    need_jax()
    got = mesh22[f"moe-{arch}-{cf}"]
    y, aux, kept, (gp, gx) = jax_moe(arch, cf)
    np.testing.assert_allclose(got["y"], y, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(float(got["aux"]), aux, rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_array_equal(got["kept"], kept)
    if cf < 1:
        assert (~got["kept"]).sum() > 0
    close(got["grad_x"], np.asarray(gx))
    for path, want in tree_leaves_with_path(gp):
        close(got["grad/" + "/".join(map(str, path))], np.asarray(want))


@pytest.mark.parametrize("arch,cf", MOE_CASES, ids=MOE_IDS)
def test_moe_ranks_hold_half_the_experts(mesh22, arch, cf):
    """Every rank's (E/2, C, d) buffer and each expert weight it computes
    with hold E/2 experts: E split over the two ``model`` ranks."""
    rows = mesh22[f"moe-{arch}-{cf}"]["rows"]      # (ranks, calls, 1 + leaves)
    n_experts = worker.config(arch).moe.n_experts
    assert rows.shape[:2] == (4, 1) and rows.shape[2] >= 3
    assert (rows == n_experts // 2).all()


def test_moe_dropped_combine_sum_is_caught(mesh22):
    """A planted fault, the combine's sum over ``model`` left out (each rank
    keeps its experts' partial y), lands outside the 1e-5 that
    ``test_moe_layer_matches_jax`` holds y to."""
    need_jax()
    y, _, _, _ = jax_moe(MOE_ARCH, 1.25)
    gap = np.abs(mesh22["moe-fault"]["y"] - y)
    assert not (gap <= MOE_TOL + MOE_TOL * np.abs(y)).all()


def test_all_to_all_moves_the_split(mesh22):
    """``collectives.all_to_all`` turns a split over ``model`` on one dim
    into the split on another and back, bf16 kept, on every rank."""
    assert mesh22["all_to_all"]["ok"].shape == (4, 3)
    assert mesh22["all_to_all"]["ok"].all()


def test_restore_onto_another_mesh(mesh22):
    got = mesh22["restore"]
    assert int(got["step"]) == 3
    assert bool(got["same"])


@pytest.mark.parametrize("case", ["batch", "model_cols", "data_only"])
def test_placements_match_dtensor(mesh221, case):
    """``NamedSharding.placements`` fed to DTensor's ``distribute_tensor``
    gives each rank the block ``NamedSharding.local`` does (pod-major for
    ``("pod", "data")`` on one dim)."""
    assert bool(mesh221["placements"][f"{case}/equal"])
    full = np.arange(48, dtype=np.float32).reshape(8, 6)
    if case != "data_only":            # rank 0: pod 0, data 0, the first
        np.testing.assert_array_equal(mesh221["placements"][f"{case}/block"],
                                      full[:2])
