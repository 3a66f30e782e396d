"""Port parity: training, serving and checkpoints over a mesh of ranks
against the port's one-rank step (which ``test_torch_train_step`` holds to
JAX).

Four gloo ranks are spawned once per mesh (a module fixture running
``_torch_mesh_worker.run``, ~6 s a spawn): on (data=2, model=2) a
``sync`` step of reduced qwen3 in ``fsdp`` and in ``tp`` mode and of every
other family (deepseek, kimi-k2, mamba2, zamba2, whisper, internvl2) in
``fsdp``, greedy serving of reduced qwen3, and a checkpoint saved from
that mesh and restored onto (data=4, model=1); on (pod=2, data=2,
model=1) olmo-1b's ``hierarchical`` steps (4, a cloud sync every 2, the
JAX launcher test's case) and the DTensor placements of two axes on one
dim. Rank 0 writes what it gathered; the test process runs the one-rank
step on the same params and batches.

Tolerances are ``test_torch_train_step``'s: the loss at rtol 1e-5; the
state after a step at rtol 1e-4, atol 1e-4 x the leaf's largest value,
except parameter entries whose one-rank gradient is within that tolerance
of zero, which AdamW's first step moves by up to lr either way (held to
lr), and whisper's key biases, whose exact gradient is zero (their
moments held at the scale of the same projection's weight's). Greedy
tokens are equal, decode logits within 1e-4; a restored block is equal
bit for bit."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_worker as worker
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.utils import tree_leaves, tree_unflatten

RTOL = 1e-4
LOSS_RTOL = 1e-5
FAMILIES = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-1.3b",
            "zamba2-2.7b", "whisper-large-v3", "internvl2-1b"]
SYNC_CASES = [("qwen3-0.6b", "fsdp"), ("qwen3-0.6b", "tp")] + [
    (a, "fsdp") for a in FAMILIES]


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
    cases += [("serve", "serve_case", {}),
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
             ("placements", "placements_case", {})]
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
