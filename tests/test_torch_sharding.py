"""Port parity: the partition rules (``launch.sharding``) and the sharding
hints (``models.pjit_hints``) against the JAX package's.

For every architecture of the registry, full and reduced, on the
production meshes (16, 16) and (2, 16, 16) and the small ones (2, 2),
(2, 2, 1), (1, 4) and (4, 1), in ``fsdp`` and ``tp`` mode, the port's
spec of each parameter equals JAX's ``param_pspec`` leaf for leaf (the
trees from ``jax.eval_shape(model.init)`` and the port's
``Model.param_specs``, matched by path), and so do the pod-stacked specs
(``_hier_param_shardings``), ``batch_shardings`` and ``cache_shardings``
(JAX's functions run on an ``AbstractMesh``, which needs no devices).

On the small meshes each rank's block (``NamedSharding.block``) equals
JAX's ``devices_indices_map`` on four forced host devices (a subprocess,
as ``tests/test_launch.py`` runs its meshes). ``from_mesh`` gives JAX's
hints, and each ``shard_*`` helper chooses JAX's spec (JAX's recorded by
monkeypatching ``repro.models.pjit_hints._wsc``); what each layer computes
with on a rank (``param_use``, the split predicates) follows those specs,
for every architecture and mesh."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.launch import sharding as tsh
from repro_torch.models import ShapeDtype, ShapeSpec
from repro_torch.models import build_model as tbuild
from repro_torch.models import pjit_hints as thints
from repro_torch.utils import tree_leaves_with_path, tree_map

try:                     # the oracle; absent on a machine with only torch
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget
    from repro.launch import sharding as jsh
    from repro.launch.steps import _hier_param_shardings
    from repro.models import build_model as jbuild
    from repro.models import pjit_hints as jhints
except ImportError:
    jax = None

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
POD_MESHES = [m for m, (_, axes) in MESHES.items() if "pod" in axes]
SMALL = ["2x2", "2x2x1", "1x4", "4x1"]
SIZES = ("full", "reduced")


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def sizes(mesh: str) -> dict:
    shape, axes = MESHES[mesh]
    return dict(zip(axes, shape))


def jmesh(mesh: str):
    shape, axes = MESHES[mesh]
    return AbstractMesh(shape, axes)


def norm(spec, ndim: int) -> tuple:
    """A spec as a tuple of ``ndim`` entries, a one-axis tuple as its
    name."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    return tuple(out)


def jkey(path) -> str:
    return jsh._key_str(path)


_SPECS = {}


def specs(arch: str, size: str):
    """(JAX's params ShapeDtypeStructs, the port's ShapeDtype tree),
    once per config."""
    if (arch, size) not in _SPECS:
        jcfg, tcfg = jget(arch), tget(arch)
        if size == "reduced":
            jcfg, tcfg = (c.reduced(dtype="float32") for c in (jcfg, tcfg))
        _SPECS[arch, size] = (
            jax.eval_shape(jbuild(jcfg).init, jax.random.key(0)),
            tbuild(tcfg).param_specs())
    return _SPECS[arch, size]


def by_path_jax(tree, shardings) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jkey(p): norm(s.spec, len(l.shape)) for (p, l), s in
            zip(flat, jax.tree.leaves(shardings))}


def by_path_port(tree, shardings) -> dict:
    flat = tree_leaves_with_path(tree)
    return {tsh._key_str(p): norm(s.spec, len(l.shape)) for (p, l), s in
            zip(flat, tsh._sharding_leaves(shardings))}


def test_port_params_have_jax_paths_and_shapes():
    need_jax()
    for arch in ARCH_IDS:
        for size in SIZES:
            j, t = specs(arch, size)
            jshape = {jkey(p): tuple(l.shape) for p, l in
                      jax.tree_util.tree_flatten_with_path(j)[0]}
            tshape = {tsh._key_str(p): l.shape for p, l in
                      tree_leaves_with_path(t)}
            assert jshape == tshape, (arch, size)


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, size, mesh, mode):
    need_jax()
    j, t = specs(arch, size)
    want = by_path_jax(j, jsh.param_shardings(j, jmesh(mesh), mode=mode))
    got = by_path_port(t, tsh.param_shardings(t, sizes(mesh), mode=mode))
    assert got == want


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("mesh", POD_MESHES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_hier_specs_match_jax(arch, size, mesh, mode):
    need_jax()
    j, t = specs(arch, size)
    n = sizes(mesh)["pod"]
    j = jax.tree.map(lambda l: jax.ShapeDtypeStruct((n,) + l.shape,
                                                    l.dtype), j)
    t = tree_map(lambda l: ShapeDtype((n,) + l.shape, l.dtype), t)
    want = by_path_jax(j, _hier_param_shardings(j, jmesh(mesh), mode=mode))
    got = by_path_port(t, tsh.hier_param_shardings(t, sizes(mesh),
                                                   mode=mode))
    assert got == want


def shape_for(size: str, kind: str) -> ShapeSpec:
    if size == "full":
        return ShapeSpec("train_4k", 4096, 256, kind) if kind == "train" \
            else ShapeSpec("decode_32k", 32768, 128, kind)
    return ShapeSpec("small", 128, 4, kind)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_shardings_match_jax(arch, size, mesh):
    need_jax()
    jcfg, tcfg = jget(arch), tget(arch)
    if size == "reduced":
        jcfg, tcfg = (c.reduced(dtype="float32") for c in (jcfg, tcfg))
    shape = shape_for(size, "train")
    jspec = jbuild(jcfg).batch_specs(shape)
    tspec = {k: ShapeDtype(tuple(s), d) for k, (s, d) in
             tbuild(tcfg).batch_specs(shape).items()}
    want = {k: norm(s.spec, len(jspec[k].shape)) for k, s in
            jsh.batch_shardings(jspec, jmesh(mesh)).items()}
    got = {k: norm(s.spec, len(tspec[k].shape)) for k, s in
           tsh.batch_shardings(tspec, sizes(mesh)).items()}
    assert got == want


_CACHES = {}


def caches(arch: str, size: str):
    if (arch, size) not in _CACHES:
        jcfg, tcfg = jget(arch), tget(arch)
        if size == "reduced":
            jcfg, tcfg = (c.reduced(dtype="float32") for c in (jcfg, tcfg))
        shape = shape_for(size, "decode")
        _CACHES[arch, size] = (jbuild(jcfg).decode_specs(shape)[0],
                               tbuild(tcfg).decode_specs(shape)[0])
    return _CACHES[arch, size]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_match_jax(arch, size, mesh):
    need_jax()
    j, t = caches(arch, size)
    want = by_path_jax(j, jsh.cache_shardings(j, jmesh(mesh)))
    got = by_path_port(t, tsh.cache_shardings(t, sizes(mesh)))
    assert got == want


def test_port_cache_has_jax_paths_and_shapes():
    need_jax()
    for arch in ARCH_IDS:
        for size in SIZES:
            j, t = caches(arch, size)
            jshape = {jkey(p): tuple(l.shape) for p, l in
                      jax.tree_util.tree_flatten_with_path(j)[0]}
            tshape = {tsh._key_str(p): l.shape for p, l in
                      tree_leaves_with_path(t)}
            assert jshape == tshape, (arch, size)


# ---------------------------------------------------------------------------
# Each rank's block against JAX's devices_indices_map
# ---------------------------------------------------------------------------

# (shape, spec) pairs: qwen3's reduced leaves in both modes, a batch, a
# cache leaf, and specs with two axes on one dim
BLOCK_CASES = [((8, 6), (("pod", "data"), None)),
               ((8, 6), (("pod", "data"), "model")),
               ((2, 4, 8, 2, 16), (None, ("pod", "data"), None, None,
                                   "model")),
               ((4, 8), ("data", "model")), ((4, 8), ("model", "data")),
               ((2, 64, 128), (None, "data", "model")),
               ((256, 64), ("model", None)), ((8,), (None,))]

JAX_BLOCKS = r"""
import json, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
out = {}
for mesh_name, (shape, axes) in cases["meshes"].items():
    mesh = jax.make_mesh(tuple(shape), tuple(axes))
    coords = {}
    for idx in __import__("numpy").ndindex(*mesh.devices.shape):
        coords[mesh.devices[idx].id] = dict(zip(axes, map(int, idx)))
    for i, (tshape, spec) in enumerate(cases["blocks"]):
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        if any(a not in axes for e in spec if e is not None
               for a in ((e,) if isinstance(e, str) else e)):
            continue
        sh = NamedSharding(mesh, P(*spec))
        for dev, index in sh.devices_indices_map(tuple(tshape)).items():
            key = f"{mesh_name}/{i}/" + json.dumps(coords[dev.id],
                                                   sort_keys=True)
            out[key] = [[s.start or 0, s.stop if s.stop is not None else n]
                        for s, n in zip(index, tshape)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_blocks():
    need_jax()
    payload = json.dumps({"meshes": {m: MESHES[m] for m in SMALL},
                          "blocks": BLOCK_CASES})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", JAX_BLOCKS, payload],
                          env=env, capture_output=True, text=True,
                          timeout=120, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", SMALL)
def test_blocks_match_devices_indices_map(jax_blocks, mesh):
    shape, axes = MESHES[mesh]
    n = 0
    for i, (tshape, spec) in enumerate(BLOCK_CASES):
        if any(a not in axes for e in spec if e is not None
               for a in ((e,) if isinstance(e, str) else e)):
            continue
        for idx in np.ndindex(*shape):
            coords = dict(zip(axes, map(int, idx)))
            block = tsh.NamedSharding(sizes(mesh), spec).block(tshape,
                                                               coords)
            key = f"{mesh}/{i}/" + json.dumps(coords, sort_keys=True)
            assert [[s.start, s.stop] for s in block] == jax_blocks[key], key
            n += 1
    assert n >= 4 * 5


@pytest.mark.parametrize("mesh", SMALL)
def test_param_blocks_tile_the_leaf(mesh):
    """Every rank's block of each reduced qwen3 leaf (fsdp), joined, is
    the leaf once: each entry in exactly one rank's block per replica."""
    shape, axes = MESHES[mesh]
    t = tbuild(tget("qwen3-0.6b").reduced(dtype="float32")).param_specs()
    for path, leaf in tree_leaves_with_path(t):
        spec = tsh.param_pspec(tsh._key_str(path), leaf.shape, sizes(mesh))
        sh = tsh.NamedSharding(sizes(mesh), spec)
        hits = torch.zeros(leaf.shape, dtype=torch.int64)
        for idx in np.ndindex(*shape):
            hits[sh.block(leaf.shape, dict(zip(axes, map(int, idx))))] += 1
        copies = int(np.prod(shape)) // int(np.prod(
            [sizes(mesh)[a] for a in tsh.spec_axes(spec)] or [1]))
        assert torch.all(hits == copies), tsh._key_str(path)


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    sh = tsh.NamedSharding(sizes("2x2x1"), (("pod", "data"), "model"))
    assert sh.placements == [Shard(0), Shard(0), Shard(1)]
    sh = tsh.NamedSharding(sizes("2x2"), (None, "data"))
    assert sh.placements == [Shard(1), Replicate()]


# ---------------------------------------------------------------------------
# Hints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inside", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_from_mesh_matches_jax(mesh, inside):
    need_jax()
    want = jhints.from_mesh(jmesh(mesh), inside_pod_vmap=inside)
    got = thints.from_mesh(sizes(mesh), inside_pod_vmap=inside)
    assert (got.batch_axes, got.model_axis, got.model_size) == \
        (want.batch_axes, want.model_axis, want.model_size)


# (helper, logical shape): divisible and not by every mesh's model axis
HELPER_CASES = [("shard_batch", (4, 8, 16)), ("shard_heads", (4, 8, 16, 32)),
                ("shard_heads", (4, 8, 6, 32)), ("shard_heads", (4, 8, 7, 32)),
                ("shard_scores", (4, 16, 8, 8)),
                ("shard_scores", (4, 6, 8, 8)),
                ("shard_ffn", (4, 8, 3072)), ("shard_ffn", (4, 8, 4866)),
                ("shard_logits", (4, 8, 151936)), ("shard_logits", (4, 51866)),
                ("shard_experts", (64, 8, 16)), ("shard_experts", (6, 8, 16))]


def port_args(helper: str, shape: tuple) -> tuple:
    """The port's ``shard_*`` arguments for a tensor of ``shape``: the
    logical size of the dim the helper decides (and the rank, where the
    spec's length depends on it)."""
    dim = {"shard_heads": 2, "shard_scores": 1, "shard_ffn": -1}
    if helper == "shard_batch":
        return (len(shape),)
    if helper in dim:
        return (shape[dim[helper]],)
    return (shape[-1 if helper == "shard_logits" else 0], len(shape))


def jax_spec(monkeypatch, mesh: str, helper: str, shape: tuple):
    """The spec JAX's ``helper`` constrains a tensor of ``shape`` to on
    ``mesh`` (recorded from its ``_wsc``)."""
    import jax.numpy as jnp
    seen = []
    monkeypatch.setattr(jhints, "_wsc",
                        lambda x, spec: seen.append(spec) or x)
    with jhints.hints_ctx(jhints.from_mesh(jmesh(mesh))):
        getattr(jhints, helper)(jax.ShapeDtypeStruct(shape, jnp.float32))
    return norm(seen[0], len(shape))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("helper,shape", HELPER_CASES,
                         ids=[f"{h}-{'x'.join(map(str, s))}"
                              for h, s in HELPER_CASES])
def test_shard_helpers_choose_jax_spec(monkeypatch, mesh, helper, shape):
    need_jax()
    want = jax_spec(monkeypatch, mesh, helper, shape)
    with thints.hints_ctx(thints.from_mesh(sizes(mesh))):
        got = getattr(thints, helper)(*port_args(helper, shape))
    assert norm(got, len(shape)) == want


def test_helpers_give_no_spec_without_hints():
    for helper, shape in HELPER_CASES:
        assert getattr(thints, helper)(*port_args(helper, shape)) is None
    assert not thints.heads_split(16) and not thints.vocab_split(256)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layers_compute_in_jax_specs(monkeypatch, arch, mesh):
    """What each layer computes with on a rank (``param_use``'s
    ``keep_model``, ``attention_split``, ``mlp_split``, ``vocab_split``)
    is split over ``model`` exactly where JAX's ``shard_*`` spec of that
    layer's activation names ``model`` on a model axis above one."""
    need_jax()
    cfg = tget(arch)
    model_size = sizes(mesh).get("model", 1)
    hd = cfg.resolved_head_dim

    def on_model(helper, shape, dim):
        spec = jax_spec(monkeypatch, mesh, helper, shape)
        return spec[dim] == "model" and model_size > 1

    heads = on_model("shard_heads", (1, 1, cfg.n_heads, hd), 2)
    kv_heads = on_model("shard_heads", (1, 1, cfg.n_kv_heads, hd), 2)
    vocab = on_model("shard_logits", (1, 1, cfg.vocab_size), 2)
    attn = cfg.mla is None and heads
    with thints.hints_ctx(thints.from_mesh(sizes(mesh))):
        assert thints.attention_split(cfg) == attn
        assert thints.vocab_split(cfg.vocab_size) == vocab
        for path, leaf in tree_leaves_with_path(tbuild(cfg).param_specs()):
            key = tsh._key_str(path)
            parts = key.split("/")
            got = thints.param_use(key, cfg)
            if key.endswith(("embed/table", "unembed/w")):
                want = (vocab, False)
            elif any(p in parts for p in ("experts", "router", "ssm")) \
                    or "ffn/shared" in key:
                want = (False, False)
            elif any(p in parts for p in ("attn", "self_attn",
                                          "cross_attn")):
                want = (False, False) if not attn else \
                    (True, False) if key.endswith(("wq/w", "wo/w")) else \
                    (kv_heads, True) if key.endswith(("wk/w", "wv/w")) \
                    else (False, True)
            elif "ffn" in parts and parts[-1] == "w":
                width = leaf.shape[-1] if parts[-2] != "wo" \
                    else leaf.shape[-2]
                want = (on_model("shard_ffn", (1, 1, width), 2), False)
                assert thints.mlp_split(cfg) == want[0], key
            else:
                want = (False, False)
            assert got == want, key


def test_split_predicates_follow_the_rules():
    with thints.hints_ctx(thints.from_mesh(sizes("2x2"))):
        assert thints.heads_split(16) and not thints.heads_split(7)
        assert thints.vocab_split(151936) and not thints.vocab_split(51867)
    with thints.hints_ctx(thints.from_mesh(sizes("4x1"))):
        assert not thints.heads_split(16)      # a model axis of one
