"""A rank of the port's collectives test (``test_torch_hierarchy_dist``):
the inputs both frameworks average, and the function each spawned gloo
rank runs. numpy alone at import, so the JAX side can import the inputs
without torch."""

import numpy as np

WORLD = 4                      # a (pod=2, data=2) mesh, rank = 2 pod + data
WEIGHTS = (1.0, 2.0, 3.0, 4.0)
LEVELS = ("LOCAL", "EDGE", "CLOUD")


def inputs() -> dict:
    """Two float32 leaves, one row per rank."""
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((WORLD, 3)).astype(np.float32),
            "b": rng.standard_normal((WORLD, 2, 5)).astype(np.float32)}


def run(rank: int, store: str, out: str) -> None:
    """Rank ``rank``: every mean of the test on its rows of :func:`inputs`,
    written to ``out/rank<r>.npz`` as ``<case>/a`` and ``<case>/b``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.core.hierarchy import (SyncLevel, hierarchical_sync,
                                                psum_mean)
        from repro_torch.launch.mesh import batch_axes, make_test_mesh, n_pods

        mesh = make_test_mesh((2, 2), ("pod", "data"), device_type="cpu")
        data = inputs()
        tree = {"a": torch.from_numpy(data["a"][rank].copy()),
                "b": [torch.from_numpy(data["b"][rank].copy())]}
        w = WEIGHTS[rank]
        res = {}
        for axis in ("data", "pod"):
            res[f"mean_{axis}"] = psum_mean(tree, axis, mesh=mesh)
            res[f"wmean_{axis}"] = psum_mean(tree, axis, w, mesh=mesh)
        for name in LEVELS:
            level = int(SyncLevel[name])
            res[f"sync_{name}"] = hierarchical_sync(tree, level, mesh=mesh,
                                                    weight=w)
            res[f"sync_tensor_{name}"] = hierarchical_sync(
                tree, torch.tensor(level), mesh=mesh,
                weight=torch.tensor(w))
        res["inputs_after"] = tree
        flat = {f"{case}/{leaf}": (t["a"] if leaf == "a" else t["b"][0])
                for case, t in res.items() for leaf in ("a", "b")}
        dtypes = sorted({str(x.dtype) for x in flat.values()})
        # the same means of the tree in bfloat16 (the syncs unweighted):
        # each leaf stays bfloat16
        half = {"a": tree["a"].to(torch.bfloat16),
                "b": [tree["b"][0].to(torch.bfloat16)]}
        low = {}
        for axis in ("data", "pod"):
            low[f"mean_{axis}"] = psum_mean(half, axis, mesh=mesh)
            low[f"wmean_{axis}"] = psum_mean(half, axis, w, mesh=mesh)
        for name in LEVELS:
            low[f"sync_{name}"] = hierarchical_sync(
                half, int(SyncLevel[name]), mesh=mesh)
        low = {f"bf16_{case}/{leaf}": (t["a"] if leaf == "a" else t["b"][0])
               for case, t in low.items() for leaf in ("a", "b")}
        bf16_dtypes = sorted({str(x.dtype) for x in low.values()})
        flat.update(low)
        flat = {k: x.float().numpy() for k, x in flat.items()}
        plain = make_test_mesh((2, 2), device_type="cpu")
        np.savez(f"{out}/rank{rank}.npz", **flat,
                 dtypes=np.array(dtypes),
                 bf16_dtypes=np.array(bf16_dtypes),
                 batch_axes=np.array(batch_axes(mesh)),
                 n_pods=np.array(n_pods(mesh)),
                 plain_batch_axes=np.array(batch_axes(plain)),
                 plain_n_pods=np.array(n_pods(plain)),
                 pod_size=np.array(mesh.size(0)),
                 data_size=np.array(mesh.size(1)))
    finally:
        dist.destroy_process_group()
