"""Roofline terms of one rank's step. Port of ``repro.launch.roofline``.

Hardware model: one NVIDIA H100 SXM5 (the H100 data sheet's SXM column):
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, 450 GB/s
each way of NVLink (900 GB/s bidirectional), and between nodes one 400
Gb/s NDR InfiniBand link a card (50 GB/s). A "pod" of the cross-pod rule
is one HGX node of 8 cards joined by NVLink. The compute term counts
every operation at the bf16 peak, as the JAX package's model counts them
at the TPU's bf16 peak, whatever their dtype.

  compute term    = FLOPs / peak          (per rank)
  memory term     = bytes / hbm_bw        (per rank)
  collective term = wire bytes inside a pod / ici_bw
                    + wire bytes across pods / dcn_bw

The JAX package reads FLOPs and bytes from XLA's cost analysis and the
collectives from the compiled HLO. An eager step has neither, so
``launch/dryrun.py`` counts FLOPs with ``FlopCounterMode``, bytes op by
op, and collectives as the step issues them, through
:class:`CollectiveCounter`: a ``TorchDispatchMode`` that sees every
``c10d`` operator (the port's ``utils/collectives.py`` and
``core/hierarchy.py``'s all-reduce alike, and any collective added later,
without touching a call site) and reads its group's global ranks from the
process group the operator carries. Each collective goes through
:func:`wire_bytes`, the JAX package's ring formulas, and JAX's
``spread >= pod_size`` rule (the group's largest minus smallest global
rank) decides whether it crosses pods. :func:`parse_collectives` is the
JAX package's HLO reader over the same formula, for HLO text.
"""

from __future__ import annotations

import re
from dataclasses import asdict, dataclass
from fractions import Fraction

import torch
from torch.utils._python_dispatch import TorchDispatchMode

H100 = {
    "peak_flops": 989e12,     # dense bf16, tensor cores
    "hbm_bw": 3.35e12,        # bytes/s, HBM3
    "ici_bw": 450e9,          # bytes/s, NVLink, each way per card
    "dcn_bw": 50e9,           # bytes/s, one 400 Gb/s NDR link per card
    "pod_size": 8,            # cards of one HGX node
}

# the JAX package's TPU v5e figures (its roofline's default), kept so one
# formula can be held to the JAX package's on the same inputs
V5E = {
    "peak_flops": 197e12,     # bf16
    "hbm_bw": 819e9,          # bytes/s
    "ici_bw": 50e9,           # bytes/s per link
    "dcn_bw": 6.25e9,         # bytes/s per host (cross-pod)
}

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


def wire_bytes(op: str, result_bytes: int, n: int, *, exact: bool = False):
    """Bytes one member of a group of ``n`` sends for collective ``op``
    whose result holds ``result_bytes`` (ring algorithms, the JAX
    package's formulas): all-reduce 2 b (n-1)/n, all-gather and all-to-all
    b (n-1)/n, reduce-scatter b (n-1) (its result is one member's block),
    collective-permute b. A float, or with ``exact`` a ``Fraction`` (the
    float is its correctly rounded value, as the JAX package's
    expression gives it)."""
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}")
    b = Fraction(result_bytes)
    if op == "all-reduce":
        wire = 2 * b * (n - 1) / n
    elif op in ("all-gather", "all-to-all"):
        wire = b * (n - 1) / n
    elif op == "reduce-scatter":
        wire = b * (n - 1)
    else:
        wire = b
    return wire if exact else float(wire)


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0          # per participating device
    cross_pod_bytes: float = 0.0     # subset crossing the pod boundary
    counts: dict = None

    def __post_init__(self):
        if self.counts is None:
            self.counts = {}


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives issued while it is active: per collective,
    :func:`wire_bytes` of its result over its group, cross-pod when the
    group's global ranks spread over ``pod_size`` or more. Sums are exact
    (``Fraction``), so a count extrapolated from two shallow runs can be
    held to a full one exactly. :meth:`record` takes one collective by
    hand (``parse_collectives`` feeds it HLO)."""

    # c10d operator -> the JAX package's name of the collective; the
    # operator's first argument is its result (a list of tensors for
    # ``allreduce_``)
    C10D = {
        "allreduce_": "all-reduce",
        "_allgather_base_": "all-gather",
        "_reduce_scatter_base_": "reduce-scatter",
        "alltoall_base_": "all-to-all",
    }
    MOVE_NOTHING = ("barrier", "monitored_barrier_")

    def __init__(self, pod_size: int = H100["pod_size"]):
        super().__init__()
        self.pod_size = pod_size
        self.wire = Fraction(0)
        self.cross_pod = Fraction(0)
        self.counts: dict = {}

    def record(self, op: str, result_bytes: int, n: int,
               spread: int) -> None:
        """One collective ``op`` with a result of ``result_bytes`` over a
        group of ``n`` whose global ranks span ``spread``."""
        if n <= 1:
            return
        wire = wire_bytes(op, result_bytes, n, exact=True)
        self.wire += wire
        if spread >= self.pod_size:
            self.cross_pod += wire
        self.counts[op] = self.counts.get(op, 0) + 1

    def stats(self) -> CollectiveStats:
        return CollectiveStats(float(self.wire), float(self.cross_pod),
                               dict(self.counts))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if func.namespace == "c10d" and name not in self.MOVE_NOTHING:
            if name not in self.C10D:
                raise NotImplementedError(
                    f"the collective counter has no rule for c10d.{name}")
            result = args[0]
            tensors = result if isinstance(result, (list, tuple)) \
                else [result]
            ranks = _group_ranks(args, kwargs)
            self.record(self.C10D[name],
                        sum(t.numel() * t.element_size() for t in tensors),
                        len(ranks), max(ranks) - min(ranks))
        return func(*args, **kwargs)


def _group_ranks(args, kwargs) -> list:
    """The global ranks of the process group a ``c10d`` operator carries."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import ProcessGroup
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, ProcessGroup):
            return dist.get_process_group_ranks(a)
        if isinstance(a, torch.ScriptObject):
            pg = ProcessGroup.unbox(a)
            return dist.get_process_group_ranks(pg)
    raise ValueError("collective without a process group")


def parse_collectives(hlo_text: str, *, pod_size: int = 256
                      ) -> CollectiveStats:
    """The collectives of compiled HLO text (the JAX package's reader):
    each op's result shape, its replica groups (explicit or iota), through
    :meth:`CollectiveCounter.record`."""
    counter = CollectiveCounter(pod_size=pod_size)
    for m in _COLL_RE.finditer(hlo_text):
        type_str, opcode = m.group(1), m.group(2)
        line_end = hlo_text.find("\n", m.end())
        line = hlo_text[m.start():line_end if line_end > 0 else None]
        g = _GROUPS_RE.search(line)
        gi = _GROUPS_IOTA_RE.search(line)
        if g:
            members = [int(x) for x in g.group(1).split(",") if x]
            n = max(len(members), 1)
            spread = (max(members) - min(members)) if members else 0
        elif gi:
            n_groups, n = int(gi.group(1)), int(gi.group(2))
            dims = [int(x) for x in gi.group(3).split(",")]
            perm = ([int(x) for x in gi.group(4).split(",")]
                    if gi.group(4) else None)
            spread = _iota_group_spread(n_groups, n, dims, perm)
        else:
            n, spread = 1, 0
        counter.record(opcode, _shape_bytes(type_str), n, spread)
    return counter.stats()


_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1,
}
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"=\s*(\([^()]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([0-9,]+)\}")
_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\](?:T\(([0-9,]+)\))?")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _iota_group_spread(n_groups: int, group_size: int, dims, perm) -> int:
    """The largest (max - min) id spread over the groups of an iota
    replica-group spec."""
    import numpy as np
    ids = np.arange(int(np.prod(dims))).reshape(dims)
    if perm is not None:
        ids = ids.transpose(perm)
    flat = ids.reshape(n_groups, group_size)
    return int((flat.max(axis=1) - flat.min(axis=1)).max())


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    wire_bytes: float
    cross_pod_bytes: float
    dominant: str
    model_flops: float = 0.0
    flops_ratio: float = 0.0          # MODEL_FLOPS / counted FLOPs (global)
    collective_counts: dict = None

    def as_dict(self):
        return asdict(self)


def roofline_terms(cost_analysis: dict, collectives: CollectiveStats, *,
                   n_chips: int, per_partition: bool = True,
                   model_flops: float = 0.0, hw=H100) -> RooflineTerms:
    """``cost_analysis``: ``{"flops": ..., "bytes accessed": ...}`` of one
    rank's step (per partition, as XLA reports a partitioned program's);
    the JAX package's arithmetic, term for term."""
    flops = float(cost_analysis.get("flops", 0.0))
    raw_bytes = float(cost_analysis.get("bytes accessed", 0.0))
    compute_s = flops / hw["peak_flops"]
    memory_s = raw_bytes / hw["hbm_bw"]
    coll_s = (collectives.wire_bytes - collectives.cross_pod_bytes) \
        / hw["ici_bw"] + collectives.cross_pod_bytes / hw["dcn_bw"]
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    global_flops = flops * (n_chips if per_partition else 1)
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        flops=flops, hbm_bytes=raw_bytes,
        wire_bytes=collectives.wire_bytes,
        cross_pod_bytes=collectives.cross_pod_bytes,
        dominant=dominant,
        model_flops=model_flops,
        flops_ratio=(model_flops / global_flops) if global_flops else 0.0,
        collective_counts=collectives.counts)
