"""The port's dry run (``repro_torch.launch.dryrun``) and hillclimb
runner at reduced widths, on fake process groups and fake tensors.

* A reduced dense, MoE, SSM and encoder-decoder cell (train and decode,
  sync and hierarchical) on a 4-rank fake mesh: the JAX package's record
  keys, and the probes' linear extrapolation equal to the full count
  (FLOPs, bytes, wire and cross-pod bytes) exactly.
* Reduced qwen3 on one rank: the counted forward and train FLOPs equal a
  closed form written here: 2 x tokens x in x out per product, the flash
  kernel's 4 x batch x heads x hd x visible causal pairs (its backward 5/2
  of that: five products), the rmsnorm kernel's 4 operations an element;
  a product's backward is two products; ``remat="block"`` adds the
  blocks' forward once more, but for each block's last product (the MLP's
  ``wo``), whose output no backward needs: PyTorch's non-reentrant
  checkpoint stops recomputing once the saved tensors are back.
* MODEL_FLOPS (``_train_flops_estimate``, ``_decode_flops_estimate``)
  and ``_probe_layer_counts`` equal the JAX package's functions for every
  architecture and shape, and ``apply_opts`` equals the JAX package's for
  every lever.

``repro.launch.dryrun`` and ``repro.launch.hillclimb`` set ``XLA_FLAGS``
to 512 host devices when imported, so they stay out of this process: a
subprocess imports them and prints their results as JSON (``jax_side``),
and the port's functions are held to that output."""

import builtins
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import visible_pairs
from repro_torch.launch import dryrun
from repro_torch.launch.hillclimb import apply_opts
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import SHAPES, ShapeSpec, build_model

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ShapeSpec("train_small", 64, 8, "train")
DECODE = ShapeSpec("decode_small", 64, 8, "decode")
KEYS = {"mode", "sharding", "lower_s", "compile_s", "argument_size_in_bytes",
        "output_size_in_bytes", "temp_size_in_bytes", "per_device_bytes",
        "probe_s", "probe", "flops_per_partition", "bytes_per_partition",
        "roofline"}
ROOF_KEYS = {"compute_s", "memory_s", "collective_s", "flops", "hbm_bytes",
             "wire_bytes", "cross_pod_bytes", "dominant", "model_flops",
             "flops_ratio", "collective_counts"}


@pytest.fixture
def fake4():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


CELLS = [("qwen3-0.6b", TRAIN), ("qwen3-0.6b", DECODE),
         ("deepseek-v2-lite-16b", TRAIN), ("kimi-k2-1t-a32b", DECODE),
         ("mamba2-1.3b", TRAIN), ("zamba2-2.7b", DECODE),
         ("whisper-large-v3", TRAIN), ("whisper-large-v3", DECODE)]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s.kind}" for a, s in CELLS])
@pytest.mark.parametrize("sharding", ["fsdp", "tp"])
def test_reduced_cell_on_a_fake_mesh(fake4, arch, shape, sharding):
    mesh = make_test_mesh((2, 2), device_type="cpu")
    res = dryrun.count_cell(get_config(arch).reduced(), shape, mesh,
                            sharding_mode=sharding)
    assert set(res) == KEYS
    assert set(res["roofline"]) == ROOF_KEYS
    assert res["probe"]["extrapolation_exact"]
    assert res["flops_per_partition"] > 0 and res["bytes_per_partition"] > 0
    assert res["per_device_bytes"] >= res["argument_size_in_bytes"] > 0
    assert res["roofline"]["wire_bytes"] > 0          # the mesh is used
    json.dumps(res)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3"])
def test_reduced_hierarchical_cell_counts_the_cloud_sync(fake4, arch):
    mesh = make_test_mesh((2, 1, 2), ("pod", "data", "model"),
                          device_type="cpu")
    res = dryrun.count_cell(get_config(arch).reduced(), TRAIN, mesh,
                            mode="hierarchical", edge_period=4)
    assert res["probe"]["extrapolation_exact"]
    sync = res["cloud_sync"]
    assert sync["collective_counts"] == {"all-reduce": sync[
        "collective_counts"]["all-reduce"]}
    assert sync["wire_bytes"] > 0
    r = res["roofline"]
    assert r["collective_s_amortized"] == \
        r["collective_s"] + sync["collective_s"] / 4


def closed_form(cfg, b: int, s: int, *, train: bool) -> int:
    t = b * s
    d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, ff, v, n = cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, \
        cfg.n_layers

    def prod(i, o):
        return 2 * t * i * o

    last = prod(ff, d)                                # the MLP's wo
    blocks = n * (prod(d, h * hd) + 2 * prod(d, hk * hd) + prod(h * hd, d)
                  + 2 * prod(d, ff) + last)
    flash = n * 4 * b * h * hd * visible_pairs(s, s, True)
    norms = n * 2 * 4 * t * d                         # norm1, norm2
    head = prod(d, v)                                 # tied read-out
    forward = blocks + flash + norms + head + 4 * t * d   # + final norm
    if not train:
        return forward
    remat = (blocks - n * last + flash + norms) if cfg.remat != "none" \
        else 0
    return forward + remat + 2 * (blocks + head) + 10 * n * b * h * hd * \
        visible_pairs(s, s, True)


@pytest.mark.parametrize("remat", ["block", "none"])
def test_reduced_qwen3_flops_equal_the_closed_form(remat):
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              remat=remat)
    assert cfg.tie_embeddings and cfg.qk_norm      # qk-norm is plain: 0
    b, s = 2, 64
    got = dryrun.count_train_step(cfg, ShapeSpec("t", s, b, "train"))
    assert got["step"].flops == closed_form(cfg, b, s, train=True)

    from torch._subclasses.fake_tensor import FakeTensorMode
    model = build_model(cfg)
    with FakeTensorMode(), torch.no_grad():
        params = dryrun._blank(model.param_specs())
        batch = {"tokens": torch.zeros(b, s + 1, dtype=torch.int32)}
        _, fwd = dryrun.count_call(model.loss, params, batch)
    assert fwd.flops == closed_form(cfg, b, s, train=False)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "kimi-k2-1t-a32b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_full_count_equals_the_probes_on_one_rank(arch):
    """Without a mesh too: the 1- and 2-unit probes extrapolate to the
    full count of a reduced config deepened to 4 units."""
    cfg = get_config(arch).reduced()
    ov1, ov2, _ = dryrun._probe_layer_counts(cfg)
    unit = ov2["n_layers"] - ov1["n_layers"]
    deep = dict(n_layers=ov1["n_layers"] + 3 * unit)
    if cfg.family == "encdec":
        deep["n_encoder_layers"] = 4
    full = dryrun._totals(dryrun.count_train_step(
        dataclasses.replace(cfg, **deep), TRAIN)["step"])
    c1, c2 = (dryrun._totals(dryrun.count_train_step(
        dataclasses.replace(cfg, **ov), TRAIN)["step"]) for ov in (ov1, ov2))
    assert {k: c1[k] + (c2[k] - c1[k]) * 3 for k in full} == full


# run with the JAX package importable; prints one JSON object
JAX_SIDE = r"""
import json
from repro.configs import ARCH_IDS, get_config
from repro.launch.dryrun import (_decode_flops_estimate, _probe_layer_counts,
                                 _train_flops_estimate)
from repro.launch.hillclimb import apply_opts
from repro.models import SHAPES

levers = json.loads(LEVERS)
out = {"archs": {}, "opts": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    out["archs"][arch] = {
        "probe": list(_probe_layer_counts(cfg)),
        "model_flops": {
            name: (_decode_flops_estimate(cfg, shape)
                   if shape.kind == "decode"
                   else _train_flops_estimate(cfg, shape))
            for name, shape in SHAPES.items()}}
for key, opts in levers.items():
    try:
        overrides, kwargs = apply_opts(opts)
        out["opts"][key] = {"overrides": overrides, "kwargs": kwargs}
    except Exception as e:
        out["opts"][key] = {"raises": type(e).__name__}
print(json.dumps(out))
"""

LEVERS = {"baseline": ["baseline"], "tp_only": ["tp_only"],
          "no_remat": ["no_remat"], "hierarchical": ["hierarchical"],
          "flash_vjp": ["flash_vjp"], "full_sched": ["full_sched"],
          "tp_only,no_remat": ["tp_only", "no_remat"],
          "hierarchical,flash_vjp,baseline": ["hierarchical", "flash_vjp",
                                              "baseline"]}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's ``_probe_layer_counts`` and MODEL_FLOPS for every
    architecture and shape, and ``apply_opts`` for every lever, computed
    in a subprocess (its ``XLA_FLAGS`` stay there)."""
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    code = f"LEVERS = {json.dumps(json.dumps(LEVERS))}\n" + JAX_SIDE
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_probes_match_jax(jax_side, arch):
    assert set(jax_side["archs"]) == set(ARCH_IDS)
    want = jax_side["archs"][arch]
    cfg = get_config(arch)
    assert set(want["model_flops"]) == set(SHAPES)
    for name, shape in SHAPES.items():
        got = (dryrun._decode_flops_estimate(cfg, shape)
               if shape.kind == "decode"
               else dryrun._train_flops_estimate(cfg, shape))
        assert got == want["model_flops"][name], name
    assert list(dryrun._probe_layer_counts(cfg)) == want["probe"]


def test_run_cell_refuses_an_existing_group(fake4):
    with pytest.raises(RuntimeError, match="already exists"):
        dryrun.run_cell("qwen3-0.6b", "train_4k", multi_pod=False)


@pytest.mark.parametrize("lever", list(LEVERS))
def test_apply_opts(jax_side, lever):
    """The JAX package's overrides and arguments for every lever; its
    ``flash_vjp`` also sets ``attn_vjp``, a field the port's config does
    not have (its attention always takes the flash backward kernel), so
    the port's overrides are JAX's without it."""
    want = jax_side["opts"][lever]
    if "raises" in want:
        with pytest.raises(getattr(builtins, want["raises"])):
            apply_opts(LEVERS[lever])
        return
    overrides, kwargs = apply_opts(LEVERS[lever])
    assert kwargs == want["kwargs"]
    assert "attn_vjp" not in {f.name for f in dataclasses.fields(
        get_config("qwen3-0.6b"))}
    want_overrides = dict(want["overrides"])
    want_overrides.pop("attn_vjp", None)
    assert overrides == want_overrides


def test_layout_copies_count_no_bytes():
    """``contiguous()`` and a ``reshape`` that cannot view count zero bytes
    (XLA chooses its layouts); a copy of the values (``clone()``) and a
    dtype change count their input and output. Each copy's output is live
    memory all the same."""
    x = torch.zeros(4, 6).t()
    cases = [(lambda: x.contiguous(), 0, 96), (lambda: x.reshape(24), 0, 96),
             (lambda: x.clone(), 2 * 96, 96),
             (lambda: x.double(), 96 + 192, 192)]
    for fn, want, peak in cases:
        traffic = dryrun.Traffic()
        with traffic:
            y = fn()
        assert (traffic.bytes, traffic.peak) == (want, peak)
        del y


@pytest.mark.parametrize("opt,sharding", [("tp_only,no_remat", "tp"),
                                          ("baseline", "fsdp")])
def test_hillclimb_cli_writes_its_record(tmp_path, opt, sharding):
    """The acceptance command at full width (qwen3-0.6b on the 16 x 16
    mesh, rank 0 on fake tensors: ~10 s), and the baseline: under fsdp a
    1-layer probe's gathers run along a dim of size 1, which leaves views
    contiguous that are not at full depth."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", "--cell",
         "qwen3-0.6b:train_4k", "--opt", opt, "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (path,) = tmp_path.glob("*.json")
    assert path.name == ("qwen3-0.6b__train_4k__single__sync__"
                         + opt.replace(",", "-") + ".json")
    res = json.loads(path.read_text())
    assert res["opts"] == opt.split(",")
    assert res["sharding"] == sharding and res["mesh"] == "16x16"
    assert res["probe"]["extrapolation_exact"]
