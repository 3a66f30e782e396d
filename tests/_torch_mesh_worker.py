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


def config(arch: str):
    from repro_torch.configs import get_config
    return get_config(arch).reduced(dtype="float32")


def shape(batch: int = BATCH):
    from repro_torch.models import ShapeSpec
    return ShapeSpec("train_test", SEQ, batch, "train")


def params(arch: str):
    """The whole float32 params from seed 0 (the same on every rank)."""
    import torch
    from repro_torch.models import build_model
    return build_model(config(arch)).init(torch.Generator().manual_seed(0))


def batch(arch: str, seed: int = 0) -> dict:
    """The whole batch of ``batch_specs``' keys: tokens below the vocab;
    frames and prefix as float32 normals."""
    import torch
    from repro_torch.models import build_model
    model = build_model(config(arch))
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
    res = serve(model, bundle.compute_params(local),
                bundle.token_sharding.local(prompts), SERVE_NEW,
                max_len=max_len, keep_prompt_logits=True, bundle=bundle)
    return {"tokens": res.tokens.numpy(),
            "logits": res.prompt_logits.numpy()}


def serve_prompts(arch: str = "qwen3-0.6b"):
    import torch
    r = np.random.default_rng(7)
    return torch.from_numpy(r.integers(0, config(arch).vocab_size,
                                       (SERVE_BATCH, SERVE_PROMPT))
                            .astype(np.int32))


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
