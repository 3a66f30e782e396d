"""Ranks of the port's mesh tests (``test_torch_mesh_train``): each spawned
gloo rank builds its mesh with the port's ``make_test_mesh`` on the CPU,
runs the cases it is given and writes what rank 0 gathered (whole
parameters, moments, losses, tokens, logits) to ``out/<case>.npz``.

The inputs are made from seeds with torch and numpy, the same in every
rank and in the test process, which runs the one-rank steps they are held
to (``one_rank_*``)."""

from __future__ import annotations

import numpy as np

SEQ = 64           # two chunks of the reduced SSM's 32
BATCH = 4
LR = 1e-2
HIER_STEPS = 4
HIER_PERIOD = 2
SERVE_BATCH = 4
SERVE_PROMPT = 5
SERVE_NEW = 4


def config(arch: str, remat: str | None = None, overrides=None):
    """The reduced float32 config of ``arch``; ``remat`` and ``overrides``
    replace its fields (zamba2 at 4 layers, its shared block after every
    2)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced(dtype="float32")
    return dataclasses.replace(cfg, remat=remat or cfg.remat,
                               **(overrides or {}))


def shape(batch: int = BATCH):
    from repro_torch.models import ShapeSpec
    return ShapeSpec("train_test", SEQ, batch, "train")


def params(arch: str, **kw):
    """The whole float32 params from seed 0 (the same on every rank) of
    ``config(arch, **kw)``."""
    import torch
    from repro_torch.models import build_model
    return build_model(config(arch, **kw)).init(
        torch.Generator().manual_seed(0))


def batch(arch: str, seed: int = 0, **kw) -> dict:
    """The whole batch of ``batch_specs``' keys of ``config(arch, **kw)``:
    tokens below the vocab; frames and prefix as float32 normals."""
    import torch
    from repro_torch.models import build_model
    model = build_model(config(arch, **kw))
    r = np.random.default_rng(seed)
    out = {}
    for key, (shp, _) in model.batch_specs(shape()).items():
        out[key] = torch.from_numpy(
            r.integers(0, model.cfg.vocab_size, shp).astype(np.int32)
            if key == "tokens" else r.normal(size=shp).astype(np.float32))
    return out


def flat(tree, prefix: str) -> dict:
    from repro_torch.utils import tree_leaves_with_path
    return {prefix + "/".join(map(str, p)): x.detach().numpy()
            for p, x in tree_leaves_with_path(tree)}


def train_case(mesh, arch: str, mode: str, sharding_mode: str,
               steps: int = 1, period: int = 0) -> dict:
    """``steps`` steps of ``mode`` (a cloud sync every ``period`` steps),
    the batch of seed k at step k; the whole state after them, the losses
    and, after each sync, whether the pods' copies are equal bit for
    bit."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    model = build_model(config(arch))
    bundle = make_train_step(model, shape(), mesh=mesh, mode=mode,
                             sharding_mode=sharding_mode, lr=LR,
                             device="cpu")
    p, o, step = bundle.init_state(params(arch))
    losses, synced_equal = [], []
    for k in range(steps):
        p, o, step, loss = bundle.step_fn(
            p, o, step, bundle.local_batch(batch(arch, k)))
        losses.append(float(loss))
        if period and (k + 1) % period == 0:
            p, o = bundle.cloud_sync_fn(p, o)
            whole = bundle.whole_params(p)
            synced_equal.append(all(torch.equal(x[0], x[1])
                                    for x in _leaves(whole)))
    whole_p = bundle.whole_params(p)
    whole_o = {k: bundle.whole_params(v) for k, v in o.items()}
    return {**flat(whole_p, "params/"), **flat(whole_o, "opt/"),
            "losses": np.array(losses), "step": np.array(int(step)),
            "synced_equal": np.array(synced_equal, bool)}


def _leaves(tree):
    from repro_torch.utils import tree_leaves
    return tree_leaves(tree)


def serve_case(mesh, arch: str = "qwen3-0.6b") -> dict:
    """Prompts of ``SERVE_PROMPT`` tokens, then ``SERVE_NEW`` greedy
    tokens, over the mesh: the whole tokens and prompt logits."""
    import torch
    from repro_torch.launch.serve import serve
    from repro_torch.launch.sharding import shard_tree
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import ShapeSpec, build_model
    model = build_model(config(arch))
    max_len = SERVE_PROMPT + SERVE_NEW
    shp = ShapeSpec("serve_test", max_len, SERVE_BATCH, "decode")
    bundle = make_serve_step(model, mesh, shp)
    local = shard_tree(params(arch), bundle.params_shardings)
    prompts = serve_prompts(arch)
    res = serve(model, local, bundle.token_sharding.local(prompts), SERVE_NEW,
                max_len=max_len, keep_prompt_logits=True, bundle=bundle)
    return {"tokens": res.tokens.numpy(),
            "logits": res.prompt_logits.numpy()}


def serve_prompts(arch: str = "qwen3-0.6b"):
    import torch
    r = np.random.default_rng(7)
    return torch.from_numpy(r.integers(0, config(arch).vocab_size,
                                       (SERVE_BATCH, SERVE_PROMPT))
                            .astype(np.int32))


MOE_BATCH, MOE_SEQ = 4, 16


def moe_config(arch: str, cf: float):
    """The reduced config of ``arch`` at capacity factor ``cf``."""
    import dataclasses
    cfg = config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def moe_inputs(arch: str, cf: float):
    """(whole MoE layer params of ``moe_init`` from seed 3, x, ct): x the
    layer's (MOE_BATCH, MOE_SEQ, d) input and ct a cotangent of y, float32
    normals from a numpy seed."""
    import torch
    from repro_torch.models import moe
    cfg = moe_config(arch, cf)
    params = moe.moe_init(torch.Generator().manual_seed(3), cfg)
    r = np.random.default_rng(17)
    x, ct = (r.normal(size=(MOE_BATCH, MOE_SEQ, cfg.d_model))
             .astype(np.float32) for _ in range(2))
    return params, x, ct


def moe_case(mesh, arch: str, cf: float, fault: bool = False) -> dict:
    """``moe_apply`` of one reduced MoE layer over the mesh, its params
    placed as a model's (paths under ``ffn/``) and gathered to the layout
    the layer computes with, each batch rank on its rows of x: the whole
    y, the aux loss, every pair's ``kept`` (global token order), the
    gradients of sum(y * ct) + aux (whole leaves, then x), and each rank's
    rows of its buffer and expert leaves. ``fault``: the combine's sum over
    ``model`` dropped (forward only)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.models import ShapeDtype, moe, pjit_hints
    from repro_torch.utils import (tree_leaves, tree_leaves_with_path,
                                   tree_map, tree_unflatten)
    from repro_torch.utils import collectives as coll

    cfg = moe_config(arch, cf)
    whole, x, ct = moe_inputs(arch, cf)
    spec = tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), whole)
    p_shard = shd.param_shardings(spec, mesh)
    blocks = shd.shard_tree(whole, p_shard)
    paths = ["ffn/" + shd._key_str(p) for p, _ in tree_leaves_with_path(spec)]
    specs = [sh.spec for sh in shd._sharding_leaves(p_shard)]
    rows = shd.batch_shardings({"x": ShapeDtype(x.shape, torch.float32)},
                               mesh)["x"]
    xl = rows.local(torch.tensor(x)).requires_grad_()
    ctl = rows.local(torch.tensor(ct))
    n_batch = coll.size(mesh.get_group("data"))

    seen, kept = [], []
    ffn, dispatch, reduce = moe._expert_ffn, moe.dispatch, \
        pjit_hints.reduce_from_model

    def recording_ffn(experts, buf, kind):
        seen.append([buf.shape[0]] + [experts[k]["w"].shape[0]
                                      for k in sorted(experts)])
        return ffn(experts, buf, kind)

    def recording_dispatch(ids, cap):
        slot, keep = dispatch(ids, cap)
        kept.append(keep)
        return slot, keep

    moe._expert_ffn, moe.dispatch = recording_ffn, recording_dispatch
    if fault:
        pjit_hints.reduce_from_model = lambda y: y
    leaves = [b.detach().requires_grad_() for b in tree_leaves(blocks)]
    try:
        with pjit_hints.hints_ctx(pjit_hints.from_mesh(mesh)):
            used = pjit_hints.use_params(leaves, paths, specs, cfg)
            y, aux = moe.moe_apply(tree_unflatten(whole, used), cfg, xl)
            grads = None if fault else torch.autograd.grad(
                (y * ctl).sum() + aux / n_batch, leaves + [xl])
    finally:
        moe._expert_ffn, moe.dispatch = ffn, dispatch
        pjit_hints.reduce_from_model = reduce
    data = mesh.get_group("data")
    out = {"y": coll.all_gather(y.detach(), data, 0).numpy(),
           "aux": np.array(float(aux)), "kept": kept[0].numpy(),
           "rows": coll.all_gather(torch.tensor([seen]), dist.group.WORLD,
                                   0).numpy()}
    if grads is not None:
        whole_g = shd.gather_tree(tree_unflatten(whole, list(grads[:-1])),
                                  p_shard)
        out.update(flat(whole_g, "grad/"))
        out["grad_x"] = coll.all_gather(grads[-1], data, 0).numpy()
    return out


def all_to_all_case(mesh) -> dict:
    """A bf16 (4, 6) tensor split over ``model`` on dim 1 moved to a split
    on dim 0 by ``collectives.all_to_all``, and back: on every rank,
    whether each is its block of the whole (and still bf16)."""
    import torch
    import torch.distributed as dist
    from repro_torch.utils import collectives as coll
    group = mesh.get_group("model")
    r = dist.get_rank(group)
    full = torch.arange(24, dtype=torch.bfloat16).reshape(4, 6)
    moved = coll.all_to_all(full[:, 3 * r:3 * r + 3], group, 0, 1)
    back = coll.all_to_all(moved, group, 1, 0)
    ok = torch.tensor([[torch.equal(moved, full[2 * r:2 * r + 2]),
                        torch.equal(back, full[:, 3 * r:3 * r + 3]),
                        moved.dtype == back.dtype == torch.bfloat16]],
                      dtype=torch.int32)
    return {"ok": coll.all_gather(ok, dist.group.WORLD, 0).numpy()}


def restore_case(mesh, other, directory: str) -> dict:
    """qwen3's params placed by fsdp on ``mesh``, written by rank 0 as whole
    leaves, restored onto ``other`` (another mesh of the same ranks):
    whether each rank's restored block is its block of the whole leaf."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.sharding import param_shardings, shard_tree
    arch = "qwen3-0.6b"
    whole = params(arch)
    local = shard_tree(whole, param_shardings(whole, mesh))
    mgr = CheckpointManager(directory, keep=1, async_save=False)
    mgr.save(3, {"params": local},
             shardings={"params": param_shardings(whole, mesh)})
    target = param_shardings(whole, other)
    step, got, _ = mgr.restore({"params": whole},
                               shardings={"params": target})
    want = shard_tree(whole, target)
    same = all(torch.equal(a, b) for a, b in zip(_leaves(got["params"]),
                                                 _leaves(want)))
    return {"step": np.array(step), "same": np.array(same)}


def placements_case(mesh) -> dict:
    """Each rank's block under a spec with ``("pod", "data")`` on one dim,
    by ``NamedSharding.local`` and by DTensor's ``distribute_tensor`` with
    the spec's placements."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.sharding import NamedSharding
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    out = {}
    for name, spec in (("batch", (("pod", "data"), None)),
                       ("model_cols", (("pod", "data"), "model")),
                       ("data_only", (None, "data"))):
        sh = NamedSharding(mesh, spec)
        mine = sh.local(full)
        dt = distribute_tensor(full, mesh, sh.placements).to_local()
        out[f"{name}/equal"] = np.array(torch.equal(mine, dt))
        out[f"{name}/block"] = mine.numpy()
    return out


def run(rank: int, world: int, store: str, out: str, mesh_shape: tuple,
        axes: tuple, cases: list) -> None:
    """Rank ``rank`` of a ``mesh_shape`` mesh: every case of ``cases``
    (``(name, function name, kwargs)``), rank 0 writing each result."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(mesh_shape, axes, device_type="cpu")
        for name, fn, kwargs in cases:
            kwargs = dict(kwargs)
            if "other" in kwargs:
                kwargs["other"] = make_test_mesh(*kwargs["other"],
                                                 device_type="cpu")
            res = globals()[fn](mesh, **kwargs)
            if rank == 0:
                np.savez(f"{out}/{name}.npz", **res)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The layer-wise gather (``test_torch_layer_gather``)
# ---------------------------------------------------------------------------

def chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch inside its
    functions), for the recorder of what each layer computes with
    (``LayerShapes``) and its planted faults (``HintsRebound``)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def shape_arrays(shapes) -> dict:
    """A ``LayerShapes``' records as arrays (a call a row), keys prefixed
    ``local/``."""
    return {f"local/{k}": np.array(v, dtype=np.int64)
            for k, v in shapes.rec.items()}


# the planted faults of ``gather_case``: each breaks one reduction of the
# split over ``model`` that ``test_torch_layer_gather`` must catch: the
# SSM's gated norm with its statistic over the rank's columns alone; the
# SSM block's or the MLA layer's output without its row-parallel
# all-reduce; MLA's ``wkv_a`` gradient taken as whole (not summed over
# ``model``)
FAULTS = ("gated_norm_local", "ssm_sum_dropped", "mla_sum_dropped",
          "wkv_a_grad_partial")


class WkvAWhole:
    """While in use, ``param_use`` says MLA's ``wkv_a`` has a whole
    gradient on each rank (it is partial: the latent serves the local
    heads only)."""

    def __enter__(self):
        from repro_torch.models import pjit_hints
        self.real = real = pjit_hints.param_use

        def param_use(path, cfg):
            use = real(path, cfg)
            return (use[0], False, use[2]) if path.endswith("wkv_a/w") \
                else use

        pjit_hints.param_use = param_use
        return self

    def __exit__(self, *exc):
        from repro_torch.models import pjit_hints
        pjit_hints.param_use = self.real


def planted(smoke, fault: str | None):
    """The context that plants ``fault`` (one of :data:`FAULTS`, or
    none)."""
    import contextlib
    def identity(x):
        return x
    return {None: contextlib.nullcontext(),
            "gated_norm_local": smoke.norm_sum_dropped(),
            "ssm_sum_dropped": smoke.HintsRebound(
                "ssm", reduce_from_model=identity),
            "mla_sum_dropped": smoke.HintsRebound(
                "attention", reduce_from_model=identity),
            "wkv_a_grad_partial": WkvAWhole()}[fault]


def gather_case(mesh, arch: str, remat: str, overrides=None,
                fault: str | None = None) -> dict:
    """One ``sync`` fsdp forward and backward of reduced ``arch`` under
    ``remat`` over the mesh (the train step's ``loss_and_grads``, on the
    batch of seed 0, each rank its rows): the loss (the mean over the
    ranks), every whole gradient, the gathered parameter bytes alive
    (``GatherMeter``): their peak in the forward and in the backward, what
    the leaves outside the stacked trees and each stacked layer gather
    alone (``pjit_hints.gathered_alone``), and what is alive after; and
    what the layers computed with on rank 0 (``LayerShapes``).
    ``fault``: one of :data:`FAULTS` planted (:func:`planted`)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, pjit_hints
    from repro_torch.utils import collectives as coll
    from repro_torch.utils import tree_unflatten
    kw = dict(remat=remat, overrides=overrides)
    cfg = config(arch, **kw)
    bundle = make_train_step(build_model(cfg), shape(), mesh=mesh, lr=LR,
                             device="cpu")
    blocks = shd.shard_tree(params(arch, **kw), bundle.params_shardings)
    local = bundle.local_batch(batch(arch, **kw))
    peaks = {}
    smoke = chip_smoke()
    with pjit_hints.GatherMeter() as meter, smoke.LayerShapes() as shapes, \
            planted(smoke, fault):
        def clock(part):
            if part == "backward":
                peaks["forward"], meter.peak = meter.peak, meter.live
        loss, grads = bundle.loss_and_grads(blocks, local, clock)
        peaks["backward"] = meter.peak
        after = meter.live
    with pjit_hints.hints_ctx(bundle.hints):
        outside, layers = pjit_hints.gathered_alone(blocks, cfg)
    data = mesh.get_group("data")
    loss = coll.all_reduce(loss, data) / coll.size(data)
    whole = shd.gather_tree(tree_unflatten(blocks, grads),
                            bundle.params_shardings)
    return {**flat(whole, "grad/"), "loss": np.array(float(loss)),
            "peak_forward": np.array(peaks["forward"]),
            "peak_backward": np.array(peaks["backward"]),
            "alive_after": np.array(after), "outside": np.array(outside),
            "layers": np.array(layers), **shape_arrays(shapes)}


def serve_frames(arch: str, overrides=None):
    """An encoder-decoder's (SERVE_BATCH, encoder_seq_len, d) float32
    frames from a numpy seed; None for another family."""
    import torch
    cfg = config(arch, overrides=overrides)
    if not cfg.n_encoder_layers:
        return None
    r = np.random.default_rng(11)
    return torch.from_numpy(r.normal(size=(
        SERVE_BATCH, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))


def serve_gather_case(mesh, arch: str = "qwen3-0.6b",
                      overrides=None) -> dict:
    """``serve_case`` over the mesh on the parameter blocks, under a
    ``GatherMeter``: the tokens and prompt logits, the gathered bytes
    alive after each step and the most alive during one, beside what the
    leaves outside the stacked trees and each layer gather alone, and
    what the layers computed with on rank 0 (``LayerShapes``). An
    encoder-decoder's rows of ``serve_frames``."""
    from repro_torch.launch.serve import serve
    from repro_torch.launch.sharding import NamedSharding, shard_tree
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import ShapeSpec, build_model, pjit_hints
    cfg = config(arch, overrides=overrides)
    model = build_model(cfg)
    max_len = SERVE_PROMPT + SERVE_NEW
    bundle = make_serve_step(model, mesh, ShapeSpec("serve_test", max_len,
                                                    SERVE_BATCH, "decode"))
    local = shard_tree(params(arch, overrides=overrides),
                       bundle.params_shardings)
    frames = serve_frames(arch, overrides)
    if frames is not None:
        frames = NamedSharding(mesh, bundle.token_sharding.spec
                               + (None, None)).local(frames)
    after, peaks = [], []
    with pjit_hints.GatherMeter() as meter, \
            chip_smoke().LayerShapes() as shapes:
        def watched(fn):
            def step(*args):
                meter.peak = meter.live
                out = fn(*args)
                after.append(meter.live)
                peaks.append(meter.peak)
                return out
            return step

        bundle.step_fn = watched(bundle.step_fn)
        bundle.decode_fn = watched(bundle.decode_fn)
        res = serve(model, local,
                    bundle.token_sharding.local(serve_prompts(arch)),
                    SERVE_NEW, max_len=max_len, frames=frames,
                    keep_prompt_logits=True, bundle=bundle)
    with pjit_hints.hints_ctx(bundle.hints):
        outside, layers = pjit_hints.gathered_alone(local, cfg)
    return {"tokens": res.tokens.numpy(),
            "logits": res.prompt_logits.numpy(),
            "alive_after": np.array(after), "peaks": np.array(peaks),
            "outside": np.array(outside), "layers": np.array(layers),
            **shape_arrays(shapes)}


def dryrun_depths(rank: int, world: int, out: str, arch: str,
                  depths: list) -> None:
    """The dry run's count of a reduced ``arch`` sync fsdp step
    (``remat="block"``) at each of ``depths`` layers, rank 0 of a (data=2,
    model=2) mesh of fake ranks, in a process of its own: each depth's
    peak and argument bytes a rank, and the bytes of one layer's blocks
    and of it whole, to ``out/dryrun_depths.npz``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves_with_path
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
        res = {}
        for n in depths:
            cfg = config(arch, overrides={"n_layers": n})
            c = dryrun.count_train_step(cfg, shape(), mesh=mesh)["step"]
            res[f"peak_{n}"] = np.array(c.peak_bytes)
            res[f"arguments_{n}"] = np.array(c.argument_bytes)
            spec = build_model(cfg).param_specs()
            sh = shd.param_shardings(spec, mesh)
            block = whole = 0
            for (p, s), h in zip(tree_leaves_with_path(spec),
                                 shd._sharding_leaves(sh)):
                if p[0] == "blocks":
                    block += 4 * int(np.prod(h.shard_shape(s.shape))) // n
                    whole += 4 * int(np.prod(s.shape)) // n
            res[f"layer_block_{n}"] = np.array(block)
            res[f"layer_whole_{n}"] = np.array(whole)
        np.savez(f"{out}/dryrun_depths.npz", **res)
    finally:
        dist.destroy_process_group()


def dryrun_share(rank: int, world: int, out: str, archs: list) -> None:
    """The dry run's counted FLOPs of one ``sync`` fsdp step of each of
    ``archs`` (reduced, ``remat="none"``), on rank 0 of a (data=1,
    model=2) mesh of fake ranks and alone (``mesh=None``) on the same
    whole batch, in a process of its own, to ``out/dryrun_share.npz``
    (``<arch>/split``, ``<arch>/whole``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = make_test_mesh((1, 2), ("data", "model"), device_type="cpu")
        res = {}
        for arch in archs:
            cfg = config(arch, remat="none")
            for key, m in (("split", mesh), ("whole", None)):
                c = dryrun.count_train_step(cfg, shape(), mesh=m)["step"]
                res[f"{arch}/{key}"] = np.array(c.flops)
        np.savez(f"{out}/dryrun_share.npz", **res)
    finally:
        dist.destroy_process_group()
