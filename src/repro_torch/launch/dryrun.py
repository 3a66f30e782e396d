"""Dry run of every (architecture x input shape) cell on the production
meshes: per-rank FLOPs, bytes, collectives and memory, and the H100
roofline terms. Port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single --mode sync \\
        --out experiments/dryrun_torch

The JAX package lowers and compiles each cell for 256 or 512 host devices
and reads XLA's cost and memory analyses. The port runs the step itself,
once, as rank 0 of the mesh: a ``fake`` process group of 256 or 512 ranks
(every collective returns at once and moves nothing) carries the named
mesh of :func:`launch.mesh.make_production_mesh`, and every tensor is a
fake tensor (a shape and a dtype; no memory, no arithmetic). The dry run
computes nothing and allocates nothing, so it takes no device: the card
policy (``device=None`` means CUDA) concerns runs that compute, and the
fake tensors lie on the CPU. The kernels run as their operators' fake
implementations (``kernels/ops.py``), so flash attention counts as the
kernel, not as its plain version's whole score matrix.

Per rank it counts (:func:`count_call`):

* FLOPs with ``FlopCounterMode`` (matrix products, and each kernel's
  operator by its own formula, the bound's count);
* bytes: every operator's tensor inputs read once and its outputs written
  once, views and metadata operators counting zero (the eager
  counterpart of XLA's "bytes accessed": nothing is fused, so a chain of
  elementwise operators counts each link). A copy that changes only the
  layout (``contiguous()``, a ``reshape`` that cannot view: ``clone`` to
  the contiguous format) counts zero too, as XLA chooses its layouts
  itself; so the count does not depend on whether a dim of size 1 (a
  probe's one layer) left a view contiguous. Under ``inference_mode`` (a
  decode step) such a ``reshape`` or ``flatten`` arrives whole, as a view
  operator: where its output has a storage of its own, it is that copy;
* collectives with :class:`launch.roofline.CollectiveCounter`;
* memory: the arguments' bytes (the rank's blocks of parameters and
  optimizer state and its rows of the batch; for a decode step its
  parameter blocks, its cache blocks and its tokens) and the peak of live
  tensor bytes over the step, each stacked layer's gathered blocks among
  them while that layer runs (``pjit_hints.use_layer``).

Eager runs every layer, so the full-depth count is exact (XLA's cost
analysis counts a scanned loop's body once, which is why the JAX package
extrapolates from two unrolled probes). The probes still run: the 1- and
2-unit configs of :func:`_probe_layer_counts` give ``per_layer_flops``
and ``per_layer_wire_bytes``, and the cell fails unless their linear
extrapolation equals the full count (FLOPs, bytes, wire and cross-pod
bytes) exactly.

Modes: ``sync`` and ``hierarchical`` (HFEL pod-local training; the cloud
sync is also counted and amortised over ``edge_period`` steps). Decode
shapes count ``make_serve_step``'s step instead of the train step (on
the rank's parameter blocks, which the step gathers a layer at a time,
as the JAX package's serve step does).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import CollectiveCounter, roofline_terms
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import SHAPES, build_model, shape_applicable
from repro_torch.utils import tree_map

OUT_DIR = "experiments/dryrun_torch"


def _train_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params; excludes the
    quadratic attention term, as is standard for the 6ND accounting)."""
    n_active = cfg.active_param_count()
    tokens = shape.seq_len * shape.global_batch
    return 6.0 * n_active * tokens


def _decode_flops_estimate(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    return 2.0 * n_active * shape.global_batch      # one token per sequence


def _probe_layer_counts(cfg):
    """(overrides_small, overrides_big, full_units) for the cost probes.

    The extrapolation unit is one homogeneous stack layer (hybrid: one
    period-group; encdec: one encoder + one decoder layer)."""
    if cfg.family == "hybrid" and cfg.hybrid_attn_period:
        p = cfg.hybrid_attn_period
        return {"n_layers": p}, {"n_layers": 2 * p}, cfg.n_layers // p
    if cfg.moe is not None and cfg.moe.n_dense_layers:
        nd = cfg.moe.n_dense_layers
        return ({"n_layers": nd + 1}, {"n_layers": nd + 2},
                cfg.n_layers - nd)
    if cfg.family == "encdec":
        return ({"n_layers": 1, "n_encoder_layers": 1},
                {"n_layers": 2, "n_encoder_layers": 2}, cfg.n_layers)
    return {"n_layers": 1}, {"n_layers": 2}, cfg.n_layers


# ---------------------------------------------------------------------------
# Counting one call
# ---------------------------------------------------------------------------

# operators that move no data: views (``OpOverload.is_view``), the
# ``prim`` namespace's metadata queries, and these
_NO_TRAFFIC = frozenset({
    "_unsafe_view", "detach", "alias", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "_local_scalar_dense",
    "set_", "resize_",
})


def _layout_copy(func, kwargs) -> bool:
    """Whether ``func`` is ``clone`` to the contiguous format: the copy of
    ``contiguous()`` and of a ``reshape`` that cannot view."""
    return func is torch.ops.aten.clone.default and \
        kwargs.get("memory_format") is torch.contiguous_format


class Traffic(TorchDispatchMode):
    """Bytes each operator reads and writes, and the live tensor bytes:
    every storage an operator returns (or :meth:`track` is given) counts
    from then until it is freed; ``peak`` is the largest sum seen."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            # an operator that views where it can (``flatten``,
            # ``reshape``: under ``inference_mode`` they arrive whole, not
            # as their ``clone`` and view) copies where it cannot: that
            # copy is a layout copy (no bytes) whose output is live memory
            seen = {id(t.untyped_storage())
                    for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor)}
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and \
                        id(t.untyped_storage()) not in seen:
                    self.track(t)
            return out
        if func.namespace == "prim" or \
                func._overloadpacket.__name__ in _NO_TRAFFIC:
            return out
        tensors_out = [t for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor)]
        if not _layout_copy(func, kwargs):      # which still takes memory
            tensors_in = [t for t in tree_flatten((args, kwargs))[0]
                          if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tensors_in + tensors_out)
        for t in tensors_out:
            self.track(t)
        return out


@dataclass
class StepCounts:
    """What :func:`count_call` counted over one call."""

    flops: int
    bytes: int
    collectives: CollectiveCounter
    argument_bytes: int
    peak_bytes: int
    output_bytes: int
    seconds: float

    def cost(self) -> dict:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes)}


def count_call(fn, *args):
    """``fn(*args)`` under the counters: (its result, :class:`StepCounts`).
    The storages of ``args``' tensors are live from the start (the
    argument bytes); fake or real tensors alike."""
    from torch.utils.flop_counter import FlopCounterMode
    traffic = Traffic()
    arg_tensors = [t for t in tree_flatten(args)[0]
                   if isinstance(t, torch.Tensor)]
    for t in arg_tensors:
        traffic.track(t)
    argument_bytes = traffic.live
    arg_storages = {id(t.untyped_storage()) for t in arg_tensors}
    coll = CollectiveCounter()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, coll, traffic:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    outs = {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)}
    output_bytes = sum(n for k, n in outs.items() if k not in arg_storages)
    return out, StepCounts(flops.get_total_flops(), traffic.bytes, coll,
                           argument_bytes, traffic.peak, output_bytes,
                           seconds)


# ---------------------------------------------------------------------------
# A rank's step on fake tensors
# ---------------------------------------------------------------------------

def _blank(spec_tree, shardings=None):
    """Zero tensors of a :class:`ShapeDtype` tree: whole, or each leaf's
    block under ``shardings``."""
    if shardings is None:
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                        spec_tree)
    return tree_map(lambda s, sh: torch.zeros(sh.shard_shape(s.shape),
                                              dtype=s.dtype),
                    spec_tree, shardings)


def _train_state(bundle, model):
    """(params, opt_state, step, batch) of the bundle's rank, zeros."""
    if bundle.mesh is None:
        params, opt_state, step = bundle.init_state(
            _blank(model.param_specs()))
    else:
        params = _blank(bundle.params_spec, bundle.params_shardings)
        opt_state = bundle.optimizer.init(params)
        step = torch.zeros((), dtype=torch.int32)
    batch = {}
    for k, (shape, dtype) in bundle.batch_spec.items():
        if bundle.mesh is not None:
            shape = bundle.batch_shardings[k].shard_shape(shape)
        batch[k] = torch.zeros(shape, dtype=dtype)
    return params, opt_state, step, batch


def count_train_step(cfg, shape, *, mesh=None, mode: str = "sync",
                     sharding_mode: str = "fsdp", batch_override=None,
                     cloud_sync: bool = False) -> dict:
    """Counts of one train step of ``cfg`` at ``shape`` on fake tensors,
    on one rank of ``mesh`` (or alone): ``{"step": StepCounts}``, plus
    ``"cloud_sync"`` when asked for in hierarchical mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = build_model(cfg)
    with FakeTensorMode():
        bundle = make_train_step(model, shape, mesh=mesh, mode=mode,
                                 sharding_mode=sharding_mode,
                                 batch_override=batch_override,
                                 device="cpu")
        params, opt_state, step, batch = _train_state(bundle, model)
        out = {"step": count_call(bundle.step_fn, params, opt_state, step,
                                  batch)[1]}
        if cloud_sync and bundle.cloud_sync_fn is not None:
            out["cloud_sync"] = count_call(bundle.cloud_sync_fn, params,
                                           opt_state)[1]
    return out


def count_serve_step(cfg, shape, *, mesh=None, sharding_mode: str = "fsdp",
                     batch_override=None) -> dict:
    """Counts of one greedy decode step at ``shape`` (a cache of
    ``shape.seq_len`` positions) on fake tensors: ``{"step":
    StepCounts}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = build_model(cfg)
    b = batch_override or shape.global_batch
    with FakeTensorMode():
        bundle = make_serve_step(model, mesh, shape,
                                 sharding_mode=sharding_mode)
        cache_spec, _ = model.decode_specs(shape, batch_override=b)
        if mesh is None:
            params = _blank(bundle.params_spec)
            cache = _blank(cache_spec)
            tokens = torch.zeros(b, dtype=torch.int32)
        else:
            params = _blank(bundle.params_spec, bundle.params_shardings)
            cache = _blank(cache_spec, bundle.cache_shardings)
            tokens = torch.zeros(bundle.token_sharding.shard_shape((b,)),
                                 dtype=torch.int32)
        out = {"step": count_call(bundle.step_fn, params, cache, tokens)[1]}
    return out


def _count(cfg, shape, mesh, mode, sharding_mode, cloud_sync=False):
    if shape.kind == "decode":
        return count_serve_step(cfg, shape, mesh=mesh,
                                sharding_mode=sharding_mode)
    return count_train_step(cfg, shape, mesh=mesh, mode=mode,
                            sharding_mode=sharding_mode,
                            cloud_sync=cloud_sync)


def _totals(c: StepCounts) -> dict:
    return {"flops": c.flops, "bytes": c.bytes, "wire": c.collectives.wire,
            "cross_pod": c.collectives.cross_pod}


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _fake_group(world_size: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group already exists; the dry run "
                           "runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             mode: str = "sync", sharding_mode: str = "fsdp",
             edge_period: int = 10, probe: bool = True,
             overrides: dict | None = None) -> dict:
    """Count rank 0's step of ``arch`` at ``shape_name`` on the production
    mesh (16 x 16, or 2 x 16 x 16 with ``multi_pod``) and return the JAX
    package's record of the cell. Initialises the fake process group and
    destroys it on exit; refuses to run beside an existing group."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    n_chips = 512 if multi_pod else 256
    _fake_group(n_chips)
    try:
        t0 = time.perf_counter()
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        result = {"arch": arch, "shape": shape_name,
                  "mesh": "2x16x16" if multi_pod else "16x16"}
        result.update(count_cell(cfg, SHAPES[shape_name], mesh, mode=mode,
                                 sharding_mode=sharding_mode,
                                 edge_period=edge_period, probe=probe,
                                 t0=t0))
    finally:
        dist.destroy_process_group()
    return result


def count_cell(cfg, shape, mesh, *, mode: str = "sync",
               sharding_mode: str = "fsdp", edge_period: int = 10,
               probe: bool = True, t0: float | None = None) -> dict:
    """The record of one cell (``cfg`` at ``shape``) on rank 0 of
    ``mesh``, a mesh on the current (fake) process group: memory, the
    probes, the counts and the roofline terms, under the JAX package's
    keys."""
    t0 = time.perf_counter() if t0 is None else t0
    n_chips = mesh.size()
    result = {"mode": mode, "sharding": sharding_mode}
    counts = _count(cfg, shape, mesh, mode, sharding_mode,
                    cloud_sync=mode == "hierarchical")
    step = counts["step"]
    # "lower": building the step and the rank's state; "compile": the
    # counted run of the full step
    result["lower_s"] = round(time.perf_counter() - t0 - step.seconds, 1)
    result["compile_s"] = round(step.seconds, 1)
    result["argument_size_in_bytes"] = step.argument_bytes
    result["output_size_in_bytes"] = step.output_bytes
    result["temp_size_in_bytes"] = step.peak_bytes - step.argument_bytes
    result["per_device_bytes"] = step.peak_bytes

    if probe:
        ov1, ov2, full_units = _probe_layer_counts(cfg)
        t1 = time.perf_counter()
        c1 = _totals(_count(dataclasses.replace(cfg, **ov1), shape, mesh,
                            mode, sharding_mode)["step"])
        c2 = _totals(_count(dataclasses.replace(cfg, **ov2), shape, mesh,
                            mode, sharding_mode)["step"])
        result["probe_s"] = round(time.perf_counter() - t1, 1)
        full = _totals(step)
        extrap = {k: c1[k] + (c2[k] - c1[k]) * (full_units - 1)
                  for k in full}
        if extrap != full:
            raise AssertionError(
                "the probes' extrapolation differs from the full count: "
                + ", ".join(f"{k} {float(extrap[k])!r} != "
                            f"{float(full[k])!r}" for k in full
                            if extrap[k] != full[k]))
        result["probe"] = {
            "full_units": full_units,
            "per_layer_flops": c2["flops"] - c1["flops"],
            "per_layer_wire_bytes": float(c2["wire"] - c1["wire"]),
            "extrapolation_exact": True,
        }

    result["flops_per_partition"] = float(step.flops)
    result["bytes_per_partition"] = float(step.bytes)
    model_flops = (_decode_flops_estimate(cfg, shape)
                   if shape.kind == "decode"
                   else _train_flops_estimate(cfg, shape))
    terms = roofline_terms(step.cost(), step.collectives.stats(),
                           n_chips=n_chips, model_flops=model_flops)
    result["roofline"] = terms.as_dict()

    if "cloud_sync" in counts:
        sync = counts["cloud_sync"]
        sync_terms = roofline_terms(sync.cost(), sync.collectives.stats(),
                                    n_chips=n_chips)
        result["cloud_sync"] = sync_terms.as_dict()
        result["edge_period"] = edge_period
        result["roofline"]["collective_s_amortized"] = (
            terms.collective_s + sync_terms.collective_s / edge_period)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="sync",
                    choices=["sync", "hierarchical"])
    ap.add_argument("--sharding", default="fsdp", choices=["fsdp", "tp"])
    ap.add_argument("--edge-period", type=int, default=10)
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the probes (the full count only)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if not shape_applicable(cfg, SHAPES[shape_name]):
                print(f"SKIP {arch} x {shape_name} (long_500k needs a "
                      "sub-quadratic family)", flush=True)
                continue
            for multi_pod in meshes:
                mesh_tag = "multi" if multi_pod else "single"
                tag = f"{arch}__{shape_name}__{mesh_tag}__{args.mode}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"SKIP {tag} (exists)", flush=True)
                    continue
                try:
                    # probes drive the single-pod roofline table only
                    res = run_cell(arch, shape_name, multi_pod=multi_pod,
                                   mode=args.mode,
                                   sharding_mode=args.sharding,
                                   edge_period=args.edge_period,
                                   probe=not args.no_probe and not multi_pod)
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    r = res["roofline"]
                    print(f"OK   {tag}: compile={res['compile_s']}s "
                          f"probe={res.get('probe_s', 0)}s "
                          f"dominant={r['dominant']} "
                          f"(c={r['compute_s']:.4f}s m={r['memory_s']:.4f}s "
                          f"x={r['collective_s']:.4f}s)", flush=True)
                except Exception as e:
                    failures += 1
                    with open(path + ".err", "w") as f:
                        f.write(traceback.format_exc())
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
