"""Port parity: ``repro_torch.launch.roofline`` against the JAX package's
``repro.launch.roofline`` (which imports no JAX, so it is imported here
directly). ``roofline_terms`` must give JAX's record field for field
(``==``) on the same inputs and hardware; ``wire_bytes`` and the
collective counter's cross-pod split JAX's ``parse_collectives`` on
synthetic HLO lines, for each of the five collectives at group sizes 2,
16 and 256; the counter must see the port's own collectives on a fake
process group with the same formulas."""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import roofline as troof

try:                     # the oracle; absent on a machine with only torch
    from repro.launch import roofline as jroof
except ImportError:
    jroof = None

OPS = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute"]
SIZES = [2, 16, 256]


def need_jax():
    if jroof is None:
        pytest.skip("needs the JAX package, the oracle")


def hlo_line(op: str, n: int, groups: str) -> tuple[str, int]:
    """One HLO instruction of ``op`` over ``groups`` with a bf16 result of
    ``n * 96`` elements (and a tuple result for all-to-all); its result
    bytes."""
    elems = n * 96
    if op == "all-to-all":
        ty = f"(bf16[{elems // 2}]{{0}}, bf16[{elems // 2}]{{0}})"
    else:
        ty = f"bf16[{elems}]{{0}}"
    return (f"  %x.1 = {ty} {op}(bf16[{elems}]{{0}} %p), {groups}, "
            f"to_apply=%add\n", elems * 2)


def group_specs(n: int) -> dict:
    """Replica-group spellings of size ``n``: contiguous and strided
    explicit lists, and an iota spec over 512 ids."""
    return {
        "contiguous": "replica_groups={{" + ",".join(map(str, range(n)))
                      + "}}",
        "strided": "replica_groups={{" + ",".join(
            str(i * (512 // n)) for i in range(n)) + "}}",
        "iota": f"replica_groups=[{512 // n},{n}]<=[{n},{512 // n}]T(1,0)",
    }


CASES = [(op, n, kind) for op in OPS for n in SIZES
         for kind in ("contiguous", "strided", "iota")]


@pytest.mark.parametrize("op,n,kind", CASES,
                         ids=[f"{o}-{n}-{k}" for o, n, k in CASES])
@pytest.mark.parametrize("pod_size", [8, 256])
def test_wire_bytes_and_cross_pod_match_parse_collectives(op, n, kind,
                                                          pod_size):
    need_jax()
    line, nbytes = hlo_line(op, n, group_specs(n)[kind])
    want = jroof.parse_collectives(line, pod_size=pod_size)
    assert want.counts == {op: 1}
    assert troof.wire_bytes(op, nbytes, n) == want.wire_bytes
    got = troof.parse_collectives(line, pod_size=pod_size)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the counter fed by hand: spread from the line's own group
    spread = {"contiguous": n - 1,
              "strided": (n - 1) * (512 // n)}.get(kind)
    if spread is not None:
        counter = troof.CollectiveCounter(pod_size=pod_size)
        counter.record(op, nbytes, n, spread)
        assert dataclasses.asdict(counter.stats()) == \
            dataclasses.asdict(want)


ROOF_INPUTS = [
    ({"flops": 3.7e13, "bytes accessed": 1.2e12},
     dict(wire_bytes=7.2e10, cross_pod_bytes=0.0,
          counts={"all-gather": 9}), 256, True, 0.0),
    ({"flops": 5.5e13, "bytes accessed": 8.8e9},
     dict(wire_bytes=1.4e9, cross_pod_bytes=9.1e8,
          counts={"all-reduce": 3, "reduce-scatter": 2}), 512, True,
     3.7e15),
    ({"flops": 1.0e9, "bytes accessed": 6.4e11},
     dict(wire_bytes=0.0, cross_pod_bytes=0.0, counts={}), 256, False,
     2.0e9),
    ({}, dict(wire_bytes=2.5e6, cross_pod_bytes=2.5e6, counts={}), 512,
     True, 0.0),
]


@pytest.mark.parametrize("hw", ["V5E", "H100"])
@pytest.mark.parametrize("case", range(len(ROOF_INPUTS)))
def test_roofline_terms_match_jax_field_for_field(case, hw):
    need_jax()
    cost, coll, n_chips, per_partition, model_flops = ROOF_INPUTS[case]
    figures = troof.V5E if hw == "V5E" else troof.H100
    if hw == "V5E":
        assert troof.V5E == jroof.V5E
    want = jroof.roofline_terms(
        cost, jroof.CollectiveStats(**coll), n_chips=n_chips,
        per_partition=per_partition, model_flops=model_flops, hw=figures)
    got = troof.roofline_terms(
        cost, troof.CollectiveStats(**coll), n_chips=n_chips,
        per_partition=per_partition, model_flops=model_flops, hw=figures)
    assert got.as_dict() == want.as_dict()


def test_h100_figures():
    assert troof.H100 == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                          "ici_bw": 450e9, "dcn_bw": 50e9, "pod_size": 8}


def test_unknown_collective_raises():
    with pytest.raises(ValueError):
        troof.wire_bytes("all-scatter", 8, 2)


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


def test_counter_sees_the_ports_collectives(fake_group):
    """utils/collectives.py's three collectives and core/hierarchy.py's
    all-reduce on the (pod=2, data=16, model=16) mesh: JAX's formulas over
    each group's size, cross-pod by the group's global ranks."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.hierarchy import psum_mean
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.utils import collectives as coll
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    with FakeTensorMode():
        x = torch.zeros(16, 8, dtype=torch.bfloat16)     # moved as float32
        counter = troof.CollectiveCounter(pod_size=256)
        with counter:
            coll.all_reduce(x, mesh.get_group("model"))
            coll.all_gather(x, mesh.get_group("data"), 1)
            coll.reduce_scatter(x, mesh.get_group("model"), 0)
            psum_mean({"a": x}, "pod", mesh=mesh)
    b = 16 * 8 * 4
    want_in = (troof.wire_bytes("all-reduce", b, 16)
               + troof.wire_bytes("all-gather", 16 * b, 16)
               + troof.wire_bytes("reduce-scatter", b // 16, 16))
    want_cross = troof.wire_bytes("all-reduce", b, 2)    # pod: 0 and 256
    stats = counter.stats()
    assert stats.counts == {"all-reduce": 2, "all-gather": 1,
                            "reduce-scatter": 1}
    assert stats.cross_pod_bytes == want_cross
    assert stats.wire_bytes == want_in + want_cross
