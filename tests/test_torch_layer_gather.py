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
are stacked), and greedy serving of reduced qwen3, mamba2, zamba2 (4
layers), whisper (with frames) and internvl2. MLA and the Mamba2 block
compute on the rank's own heads, as the JAX package's rules split their
leaves (``wkv_b``; ``in_proj``, ``conv_w``, ``out_proj``): asserted by
the shapes each layer computes with (``chip_smoke.LayerShapes``),
and by four planted faults of the split's reductions that the one-rank
comparison must catch. Inputs
come from seeds (torch's generator for the params, numpy for the batch),
the same in every rank and in this process, which runs the one-rank step
they are held to. A process of its own counts the dry run of reduced
qwen3 on fake ranks at three depths; another counts reduced mamba2's and
deepseek's FLOPs a rank at (data=1, model=2) against one rank's.

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
SERVE_FAMILIES = [("mamba2-1.3b", None), ("zamba2-2.7b", ZAMBA2),
                  ("whisper-large-v3", None), ("internvl2-1b", None)]
# the planted faults (``_torch_mesh_worker.FAULTS``) and the model each
# is planted in, at remat "none"
FAULT_CASES = [("gated_norm_local", "mamba2-1.3b", None),
               ("ssm_sum_dropped", "mamba2-1.3b", None),
               ("mla_sum_dropped", "deepseek-v2-lite-16b", MOE),
               ("wkv_a_grad_partial", "deepseek-v2-lite-16b", MOE)]
SHARE_ARCHS = ["mamba2-1.3b", "deepseek-v2-lite-16b"]


def spawn(fn, world, args) -> None:
    mp.start_processes(fn, args=(world, *args), nprocs=world, join=True,
                       start_method="spawn")


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gather22")
    cases = [(f"{a}-{r}", "gather_case", dict(arch=a, remat=r, overrides=o))
             for a, o, r in CASES]
    cases.append(("serve", "serve_gather_case", {}))
    cases += [(f"serve-{a}", "serve_gather_case", dict(arch=a, overrides=o))
              for a, o in SERVE_FAMILIES]
    cases += [(f"fault-{f}", "gather_case",
               dict(arch=a, remat="none", overrides=o, fault=f))
              for f, a, o in FAULT_CASES]
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


@pytest.fixture(scope="module")
def shares(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("share")
    spawn(worker.dryrun_share, 1, (str(tmp), SHARE_ARCHS))
    with np.load(tmp / "dryrun_share.npz") as z:
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


def hold_to_one_rank(got, arch, overrides, remat):
    """``got``'s loss and every gradient against the one-rank step's, at
    the tolerances above (raises AssertionError)."""
    loss, grads = one_rank(arch, overrides, remat)
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
    cfg = worker.config(arch, remat, overrides)
    zero = cfg.qkv_bias and not cfg.use_rope
    for name, want in grads.items():
        scale = None
        if zero and name.endswith("wk/b"):
            scale = float(np.abs(grads[name[:-1] + "w"]).max())
        close(got[name], want, scale)


@pytest.mark.parametrize("arch,overrides,remat", CASES, ids=IDS)
def test_loss_and_grads_match_one_rank(mesh22, arch, overrides, remat):
    """Over (data=2, model=2) with each layer gathering its own blocks:
    the loss and every gradient of the one-rank step."""
    hold_to_one_rank(mesh22[f"{arch}-{remat}"], arch, overrides, remat)


def assert_local_heads(got, cfg, train: bool):
    """The shapes the layers of ``cfg`` computed with on rank 0 of a
    (data=2, model=2) mesh (``chip_smoke.LayerShapes``): half the heads
    of every attention layer (its flash q on a train step; ``wo``'s rows,
    an MLA layer's ``wkv_b`` columns: blocks, not gathered over
    ``model``) and of every Mamba2 block (its scan's x on a train step,
    its decode state otherwise; ``out_proj``'s rows, ``in_proj``'s z, x
    and dt columns beside the whole B/C)."""
    d = cfg.d_model
    if cfg.family != "ssm":
        heads = cfg.n_heads // 2
        if cfg.mla is not None:
            m = cfg.mla
            v = m.v_head_dim
            assert {tuple(w) for w in got["local/wkv_b"]} == {
                (m.kv_lora_rank, heads * (m.qk_nope_head_dim + v))}
        else:
            v = cfg.resolved_head_dim
        assert len(got["local/wo"]) > 0
        assert {tuple(w) for w in got["local/wo"]} == {(heads * v, d)}
        if train:
            assert len(got["local/flash_q"]) > 0
            assert set(got["local/flash_q"][:, 2]) == {heads}
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * d
        h, gn = d_inner // s.head_dim, s.n_groups * s.state_size
        key = "local/scan_heads" if train else "local/state_heads"
        assert len(got[key]) > 0 and set(got[key].ravel()) == {h // 2}
        assert {tuple(w) for w in got["local/out_proj"]} == {
            (d_inner // 2, d)}
        assert {tuple(w) for w in got["local/in_proj"]} == {
            (d, d_inner + 2 * gn + h // 2)}


@pytest.mark.parametrize("arch,overrides", FAMILIES[1:5],
                         ids=[a for a, _ in FAMILIES[1:5]])
@pytest.mark.parametrize("remat", REMATS)
def test_rank_computes_its_local_heads(mesh22, arch, overrides, remat):
    """Over (data=2, model=2) every layer of deepseek (MLA), kimi-k2 (GQA,
    as before), mamba2 and zamba2 (the Mamba2 blocks and the shared
    attention) computes on half the heads, with its own blocks of the
    split leaves."""
    assert_local_heads(mesh22[f"{arch}-{remat}"],
                       worker.config(arch, remat, overrides), train=True)


@pytest.mark.parametrize("fault,arch,overrides", FAULT_CASES,
                         ids=[f for f, _, _ in FAULT_CASES])
def test_planted_split_faults_are_caught(mesh22, fault, arch, overrides):
    """Each planted fault of the split's reductions (the gated norm's
    statistic over the rank's columns alone; the SSM block's or the MLA
    layer's output without its all-reduce over ``model``; ``wkv_a``'s
    partial gradient not summed over ``model``) fails the one-rank
    comparison that the sound step passes."""
    with pytest.raises(AssertionError):
        hold_to_one_rank(mesh22[f"fault-{fault}"], arch, overrides, "none")


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


@pytest.mark.parametrize("arch,overrides", SERVE_FAMILIES,
                         ids=[a for a, _ in SERVE_FAMILIES])
def test_serve_families_take_the_blocks(mesh22, arch, overrides):
    """The serve step over (data=2, model=2) of the SSM, hybrid,
    encoder-decoder and VLM families (whisper with its rows of the
    frames): the one-rank serve's greedy tokens and its decode logits
    within 1e-4, each step gathering at most the leaves outside the
    stacked trees and one layer, none alive between steps; each layer on
    its local heads (the SSM state's heads and ``out_proj``'s rows halved
    in the decode layout)."""
    got = mesh22[f"serve-{arch}"]
    cfg = worker.config(arch, overrides=overrides)
    model = build_model(cfg)
    res = serve(model, worker.params(arch, overrides=overrides),
                worker.serve_prompts(arch), worker.SERVE_NEW,
                max_len=worker.SERVE_PROMPT + worker.SERVE_NEW,
                frames=worker.serve_frames(arch, overrides),
                keep_prompt_logits=True)
    np.testing.assert_array_equal(got["tokens"], res.tokens.numpy())
    np.testing.assert_allclose(got["logits"], res.prompt_logits.numpy(),
                               rtol=RTOL, atol=RTOL)
    assert (got["alive_after"] == 0).all()
    bound = int(got["outside"]) + int(got["layers"].max())
    assert (got["peaks"] > 0).all() and (got["peaks"] <= bound).all()
    assert_local_heads(got, cfg, train=False)


@pytest.mark.parametrize("arch", SHARE_ARCHS)
def test_dryrun_rank_flops_share(shares, arch):
    """The dry run's counted FLOPs of a reduced ``sync`` fsdp step
    (``remat="none"``, the whole batch of 4 x 64) on a rank of (data=1,
    model=2), against one rank's: every product of the split layers
    halves, and what stays whole on each rank counts in full. From the
    shapes (T = 256 tokens, L = 2 layers), the whole parts R are: the
    residual rmsnorm kernels (4 T d a norm); mamba2's B/C columns of
    ``in_proj`` (3 products of 2 T d 2GN a layer) and its chunks' C B^T
    (3 of 2 B NC Q^2 N); deepseek's ``wkv_a`` (3 of 2 T d (r + rope) a
    layer), router (3 of 2 T d E) and shared expert (9 of 2 T d F).
    mamba2's gated norm is the rmsnorm kernel on one rank (4 T d_inner a
    layer, G) and plain under the split. So the rank counts exactly
    (whole + R - G) / 2: mamba2 71,794,688 of 135,790,592 (0.5287),
    deepseek 98,205,696 of 178,388,992 (0.5505), at most 0.6."""
    whole, split = shares[f"{arch}/whole"], shares[f"{arch}/split"]
    cfg = worker.config(arch, remat="none")
    b, seq = worker.BATCH, worker.SEQ
    t, d, n_layers = b * seq, cfg.d_model, cfg.n_layers
    norms = 4 * t * d * (n_layers + 1)
    if cfg.ssm is not None:
        s = cfg.ssm
        gn, d_inner, q = s.n_groups * s.state_size, s.expand * d, \
            s.chunk_size
        replicated = norms + n_layers * (
            3 * 2 * t * d * 2 * gn
            + 3 * 2 * b * (seq // q) * s.n_groups * q * q * s.state_size)
        gated = 4 * t * d_inner * n_layers
    else:
        m, moe = cfg.mla, cfg.moe
        norms = 4 * t * d * (2 * n_layers + 1)
        replicated = norms + n_layers * 3 * 2 * t * d * (
            m.kv_lora_rank + m.qk_rope_head_dim) + (
            n_layers - moe.n_dense_layers) * (
            3 * 2 * t * d * moe.n_experts
            + 9 * 2 * t * d * moe.d_expert * moe.n_shared)
        gated = 0
    assert 2 * split == whole + replicated - gated
    assert split <= 0.6 * whole


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
