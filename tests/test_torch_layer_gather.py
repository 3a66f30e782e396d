"""The layer-wise gather of ``fsdp`` over a mesh of ranks: the train step
and the serve step take the rank's parameter blocks; the leaves outside
the stacked layer trees are gathered before the forward
(``pjit_hints.use_tree``) and each stacked layer's slice inside its own
step (``pjit_hints.use_layer``), as GSPMD gathers inside the JAX
package's scanned layers.

Four gloo ranks on the CPU are spawned once (``_torch_mesh_worker.run``,
a module fixture, ~6 s a spawn, one thread a rank) on (data=2, model=2):
a ``sync`` forward and backward of every family, reduced and float32,
under ``remat="block"`` and ``"none"`` (qwen3, deepseek and kimi-k2 with
their MoE layers, mamba2, zamba2 at 4 layers with its shared block after
every 2, whisper, internvl2; the MoE models at 3 layers, so that two
are stacked), and greedy serving of reduced qwen3. Inputs
come from seeds (torch's generator for the params, numpy for the batch),
the same in every rank and in this process, which runs the one-rank step
they are held to. A process of its own counts the dry run of reduced
qwen3 on fake ranks at three depths.

Tolerances are ``test_torch_mesh_train``'s: the loss at rtol 1e-5, each
gradient at rtol 1e-4 and atol 1e-4 x its largest entry (whisper's key
biases, whose exact gradient is zero, at the scale of the same
projection's weight); greedy tokens equal, decode logits within 1e-4.
The gathered bytes are what ``pjit_hints.GatherMeter`` sees alive: the
storages ``use_params`` returns, from their gather until they are
freed."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_worker as worker
from repro_torch.launch.serve import serve
from repro_torch.models import build_model
from repro_torch.utils import tree_leaves, tree_unflatten

RTOL = 1e-4
LOSS_RTOL = 1e-5
ZAMBA2 = {"n_layers": 4, "hybrid_attn_period": 2}     # two applications
MOE = {"n_layers": 3}         # the leading dense layer and two MoE layers
FAMILIES = [("qwen3-0.6b", None), ("deepseek-v2-lite-16b", MOE),
            ("kimi-k2-1t-a32b", MOE), ("mamba2-1.3b", None),
            ("zamba2-2.7b", ZAMBA2), ("whisper-large-v3", None),
            ("internvl2-1b", None)]
REMATS = ("block", "none")
CASES = [(a, o, r) for a, o in FAMILIES for r in REMATS]
IDS = [f"{a}-{r}" for a, _, r in CASES]
DEPTHS = (2, 3, 4)


def spawn(fn, world, args) -> None:
    mp.start_processes(fn, args=(world, *args), nprocs=world, join=True,
                       start_method="spawn")


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gather22")
    cases = [(f"{a}-{r}", "gather_case", dict(arch=a, remat=r, overrides=o))
             for a, o, r in CASES]
    cases.append(("serve", "serve_gather_case", {}))
    spawn(worker.run, 4, (str(tmp / "store"), str(tmp), (2, 2),
                          ("data", "model"), cases))
    out = {}
    for name, _, _ in cases:
        with np.load(tmp / f"{name}.npz") as z:
            out[name] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def depths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("depths")
    spawn(worker.dryrun_depths, 1, (str(tmp), "qwen3-0.6b", list(DEPTHS)))
    with np.load(tmp / "dryrun_depths.npz") as z:
        return {k: int(z[k]) for k in z.files}


def one_rank(arch, overrides, remat):
    """The one-rank loss and gradients (``tree_leaves`` order) on the
    whole batch."""
    kw = dict(remat=remat, overrides=overrides)
    model = build_model(worker.config(arch, **kw))
    params = worker.params(arch, **kw)
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss = model.loss(tree_unflatten(params, leaves),
                      worker.batch(arch, **kw))
    grads = torch.autograd.grad(loss, leaves)
    names = ["grad/" + k for k in worker.flat(params, "")]
    return float(loss.detach()), dict(zip(names, (g.numpy() for g in grads)))


def close(got, want, scale=None):
    scale = float(np.abs(want).max() + 1e-30) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("arch,overrides,remat", CASES, ids=IDS)
def test_loss_and_grads_match_one_rank(mesh22, arch, overrides, remat):
    """Over (data=2, model=2) with each layer gathering its own blocks:
    the loss and every gradient of the one-rank step."""
    got = mesh22[f"{arch}-{remat}"]
    loss, grads = one_rank(arch, overrides, remat)
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
    cfg = worker.config(arch, remat, overrides)
    zero = cfg.qkv_bias and not cfg.use_rope
    for name, want in grads.items():
        scale = None
        if zero and name.endswith("wk/b"):
            scale = float(np.abs(grads[name[:-1] + "w"]).max())
        close(got[name], want, scale)


@pytest.mark.parametrize("arch,overrides", FAMILIES,
                         ids=[a for a, _ in FAMILIES])
def test_block_remat_holds_one_layer_gathered(mesh22, arch, overrides):
    """Under ``remat="block"`` the gathered bytes alive at once, forward
    and backward (the recompute's gathers among them), are at most the
    leaves outside the stacked trees gathered and one stacked layer's
    gathered blocks; none is alive after the backward. Under ``"none"``
    the gathered blocks are the backward's residuals, as XLA's scan keeps
    them, so the backward starts with every layer's."""
    block, none = mesh22[f"{arch}-block"], mesh22[f"{arch}-none"]
    layers = block["layers"]
    bound = int(block["outside"]) + int(layers.max())
    assert len(layers) >= 2 and layers.min() > 0
    assert 0 < int(block["peak_forward"]) <= bound
    assert 0 < int(block["peak_backward"]) <= bound
    assert int(block["alive_after"]) == 0 == int(none["alive_after"])
    assert int(none["peak_forward"]) > bound


def test_serve_takes_the_blocks(mesh22):
    """The serve step over (data=2, model=2) on the rank's blocks: the
    one-rank serve's greedy tokens, its decode logits within 1e-4; each
    step gathers at most the leaves outside the stacked trees and one
    layer at once, and no gathered leaf is alive between two steps."""
    got = mesh22["serve"]
    model = build_model(worker.config("qwen3-0.6b"))
    res = serve(model, worker.params("qwen3-0.6b"), worker.serve_prompts(),
                worker.SERVE_NEW, max_len=worker.SERVE_PROMPT
                + worker.SERVE_NEW, keep_prompt_logits=True)
    np.testing.assert_array_equal(got["tokens"], res.tokens.numpy())
    np.testing.assert_allclose(got["logits"], res.prompt_logits.numpy(),
                               rtol=RTOL, atol=RTOL)
    steps = worker.SERVE_PROMPT + worker.SERVE_NEW - 1
    assert got["alive_after"].shape == (steps,)
    assert (got["alive_after"] == 0).all()
    bound = int(got["outside"]) + int(got["layers"].max())
    assert (got["peaks"] > 0).all() and (got["peaks"] <= bound).all()


def test_dryrun_peak_grows_by_a_layers_blocks_not_its_gather(depths):
    """The dry run's peak a rank of reduced qwen3's sync fsdp step over
    (data=2, model=2) on fake ranks (``remat="block"``), at 2, 3 and 4
    layers: each added layer adds its stored blocks, their two moments and
    their gradient (four times the layer's blocks), and at most its saved
    input (a rank's rows of the layer's float32 input), the same for each
    layer; not the layer's gathered blocks, which live only while the
    layer runs (at least half the whole layer on a model axis of 2, more
    than the saved input)."""
    cfg = worker.config("qwen3-0.6b")
    saved = worker.BATCH // 2 * worker.SEQ * cfg.d_model * 4
    grows = [depths[f"peak_{b}"] - depths[f"peak_{a}"]
             for a, b in zip(DEPTHS, DEPTHS[1:])]
    block = depths[f"layer_block_{DEPTHS[0]}"]
    gathered = depths[f"layer_whole_{DEPTHS[0]}"] // 2
    assert gathered > saved
    assert len(set(grows)) == 1
    assert 4 * block <= grows[0] <= 4 * block + saved
    args = [depths[f"arguments_{b}"] - depths[f"arguments_{a}"]
            for a, b in zip(DEPTHS, DEPTHS[1:])]
    assert args == [3 * block] * len(args)
