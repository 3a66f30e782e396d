"""Edge association to a stable point: the device-resident engine.

Port of ``repro.core.assoc_fast.FastAssociationEngine``, with Algorithm 3's
transfers and sampled exchanges, in every sweep space of the reference.
State is a dense ``(K, N)`` boolean membership mask plus, per *bucket* of
servers, a toggle-cost cache of shape ``(K_b, R_b)``::

    toggle_b[row, r] = group cost of  member[server] XOR {device at slot r}
    cur[server]      = group cost of  member[server]

XOR adds a device when it is absent and removes it when present, so the
cache holds both halves of every transfer and the delta of moving device n
from its server s to server k is pure arithmetic::

    delta = (toggle[s at n's slot] - cur[s]) + (toggle[k at n's slot] - cur[k])

The sweep spaces are configurations of one loop, differing only in their
slot maps (:class:`_Bucket`):

* dense (``compact=False``): one bucket whose maps are the identity, every
  slot a device, availability gating candidacy only;
* flat compact (``compact=True``): one bucket from
  :func:`repro_torch.core.scenario.reach_index_map`, every server padded to
  the widest reach count R;
* bucketed (``compact="bucketed"``): servers grouped by binary reach count,
  each bucket compacted at its own width R_b;
* ``"auto"`` (the default, as in the reference): dense when some server
  reaches every device, else flat, or bucketed when the flat map wastes
  more than :data:`BUCKETED_AUTO_THRESHOLD` of its slots on padding.

Each round scans every candidate from the cache with no solve and picks
the best permitted move with the reference's explicit device-major
tie-break key (smallest ``n*K + k`` among equal deltas). The per-bucket
caches are views of one flat buffer (one a shard, below), so the scan is
one pass over all of them: since every (server, device) pair has its own
key, the global minimum of (delta, key) is the reference's fold of the
per-bucket argmins.
Padded slots hold garbage costs and are never candidates. A move re-solves
the two touched servers' rows: ``R_b + 1`` groups of width ``R_b`` each,
one launch of the golden-section kernel per row for the ``fast`` kind.

A round with no permitted transfer tries sampled exchanges (Definition 5):
it splits the PRNG key (:mod:`repro_torch.core.prng`, the reference's
threefry stream bit for bit), draws ``exchange_samples`` device pairs over
N, prices both swapped groups of every pair in one shared flat ``(K,
R_max)`` slot space (the single bucket of the dense and flat spaces) in one
batch of ``2 * exchange_samples`` groups (one launch), and applies the
first best permitted swap. Swapped masks are XORs of one-hot slot
encodings; an out-of-reach slot encodes as the all-zero row. The descent
stops on a round where neither applies. The reference runs this loop as
one ``lax.while_loop``; here it is a Python loop with one host sync per
round.

:meth:`FastAssociationEngine.run_tiered` runs the loop once per profile of
a ``TIER_PLANS`` plan. :meth:`FastAssociationEngine.rerun_incremental`
re-converges after churn from the previous stable point: it patches the
reach maps, repairs the assignment (:func:`repair_assignment`) and re-solves
only the cache rows the delta or the repair made stale.

The sharded sweep (``shards=p``) is the reference's ``shard_map`` program
with one process in place of the single controller: ``p`` shards, each on
its own device (the first ``p`` cards, every shard on the CPU for
``device="cpu"``, or ``shard_devices=`` explicitly, repeats allowed).
Every bucket's rows are split into ``p`` contiguous ranges of
``ceil(K_b / p)`` rows (the padding to a multiple of ``p`` holds nothing,
so a bucket narrower than ``p`` leaves some shards empty); a shard holds
its rows' constants, its slice of the flat toggle cache and the whole
exchange space. Membership, assignment, ``cur`` and the merges stay on
``device``, the leader. A round gathers each device's removal toggle from
the shard that owns its server, scans every shard's candidates with the
global key, and folds the shards' best (delta, key) pairs
lexicographically: keys are unique, so that is the move ``shards=None``
picks. A move re-solves each touched row on its owner. An exchange round
splits the 2S candidate solves into contiguous sample chunks, one launch a
shard, and folds the shards' first best (delta, sample index) pairs, which
is ``argmin``'s first-occurrence tie-break. The pair proposal stays on the
host (the same threefry stream), a round still costs one host sync, and
the moves, the trace and the stable point are those of ``shards=None``,
bit for bit. ``shards=None`` is the same loop with one shard on the
leader, which ``shards=1`` on the leader's device also gives.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core import resource_allocation as ra
from repro_torch.core.cost_model import RAConstants, cloud_delay, cloud_energy
from repro_torch.core.edge_association import (AssociationResult, GroupSolver,
                                               NoFeasibleServerError,
                                               _gather_f_beta,
                                               _true_cost_terms,
                                               greedy_admission,
                                               initial_assignment,
                                               nearest_feasible, parked_slots,
                                               solve_groups)
from repro_torch.core.scenario import (ReachBuckets, ReachIndex, Scenario,
                                       ScenarioDelta, reach_index_map,
                                       update_reach_buckets,
                                       update_reach_index)
from repro_torch.kernels.golden_section import MAX_R

#: The engine-wide sampled-exchange budget (Definition 5 escape moves per
#: stuck round), as in the JAX engine; pass ``exchange_samples=0`` for a
#: deterministic transfer-only sweep.
DEFAULT_EXCHANGE_SAMPLES = 64

#: ``compact="auto"`` takes the bucketed space when the flat map wastes
#: more than this fraction of its slots on padding (the reference's value).
BUCKETED_AUTO_THRESHOLD = 0.25

_I64_BIG = torch.iinfo(torch.int64).max


@dataclass(frozen=True)
class _Bucket:
    """One slot-width bucket of the sweep: its servers' slot maps and every
    RA constant gathered into its ``(K_b, R_b)`` slot space."""

    servers: torch.Tensor    # (K_b,) global server ids
    idx: torch.Tensor        # (K_b, R_b) device per slot
    exists: torch.Tensor     # (K_b, R_b) slot holds a real device
    ok: torch.Tensor         # (K_b, R_b) slot is a legal transfer target
    consts: RAConstants      # (K_b, R_b) leaves, w (K_b,)
    random_f: torch.Tensor | None   # (K_b, R_b), fixed-f kinds only
    inv_dist: torch.Tensor | None   # (K_b, R_b), proportional only
    eye: torch.Tensor        # (R_b, R_b) single-slot toggles

    @property
    def width(self) -> int:
        return int(self.idx.shape[1])

    def cut(self, lo: int, hi: int, device) -> "_Bucket":
        """Rows ``[lo, hi)`` on ``device`` (views when it is already
        there)."""
        def part(x):
            return None if x is None else x[lo:hi].to(device)

        return _Bucket(
            servers=part(self.servers), idx=part(self.idx),
            exists=part(self.exists), ok=part(self.ok),
            consts=RAConstants(**{name: part(v) for name, v
                                  in vars(self.consts).items()}),
            random_f=part(self.random_f), inv_dist=part(self.inv_dist),
            eye=self.eye.to(device))


@dataclass(frozen=True)
class _Shard:
    """One shard of the sweep on its device: rows ``spans[b]`` of every
    bucket b, the whole exchange space, and the layout of its slice of the
    flat toggle cache (bucket after bucket)."""

    device: torch.device
    spans: tuple[tuple[int, int], ...]
    buckets: tuple[_Bucket, ...]
    ex_bucket: _Bucket
    offsets: np.ndarray         # (n_buckets + 1,) bucket starts in the cache
    flat_dev: torch.Tensor      # per cache slot: device, server, target flag
    flat_srv: torch.Tensor
    flat_ok: torch.Tensor
    flat_order: torch.Tensor    # the global key n*K + k
    row_base: torch.Tensor      # (K,) cache start of an owned server's row
    row_width: torch.Tensor     # (K,) its width; 1 for servers owned elsewhere
    cloud_const: torch.Tensor   # (K,)
    cap: torch.Tensor           # (K,)

    @property
    def size(self) -> int:
        return int(self.offsets[-1])


def _shard_devices(shards, shard_devices, leader: torch.device):
    """``(shards, devices)``: the shard count (None for the plain sweep) and
    the device of each shard, after checking them."""
    if shard_devices is not None:
        shard_devices = tuple(torch.device(d) for d in shard_devices)
        if shards is None:
            shards = len(shard_devices)
        elif len(shard_devices) != shards:
            raise ValueError(f"shard_devices names {len(shard_devices)} "
                             f"devices for shards={shards}")
    if shards is None:
        return None, (leader,)
    if isinstance(shards, bool) or int(shards) != shards or shards < 1:
        raise ValueError(f"shards must be a positive integer, got {shards!r}")
    shards = int(shards)
    if shard_devices is not None:
        return shards, shard_devices
    if leader.type == "cpu":
        return shards, (leader,) * shards
    count = torch.cuda.device_count()
    if shards > count:
        raise ValueError(f"shards={shards} but only {count} CUDA device(s) "
                         "visible (shard_devices= places shards explicitly)")
    return shards, tuple(torch.device("cuda", i) for i in range(shards))


def _dense_member(assignment: np.ndarray, active: np.ndarray,
                  n_servers: int) -> np.ndarray:
    """Dense (K, N) membership of an assignment, gated by the active mask:
    inactive devices keep a parked slot but belong to no group."""
    member = np.zeros((n_servers, assignment.shape[0]), dtype=bool)
    act = np.asarray(active, dtype=bool)
    member[np.asarray(assignment)[act], np.flatnonzero(act)] = True
    return member


def assignment_true_cost(sc: Scenario, assignment: np.ndarray, *,
                         solver: GroupSolver | None = None,
                         kind: str = "fast", seed: int = 0, device=None
                         ) -> tuple[float, float, float]:
    """Eqs. (15)-(17) ``(energy, delay, cost)`` of an explicit assignment at
    reference RA accuracy, gated by the scenario's active mask. A prebuilt
    ``solver`` is viewed at the default profile (its constants stay valid
    across churn, but for the ``proportional`` kind's distances)."""
    if solver is None:
        solver = GroupSolver(sc, kind, seed=seed, profile="default",
                             device=device)
    elif solver.kind != kind:
        raise ValueError(f"prebuilt solver was built for kind="
                         f"{solver.kind!r}, not {kind!r}")
    else:
        solver = solver.with_profile("default")
    assignment = np.asarray(assignment)
    active = sc.active_mask
    member = torch.as_tensor(_dense_member(assignment, active, sc.n_servers),
                             device=solver.device)
    sols = solver.solve_batch(np.arange(sc.n_servers), member)
    f, beta = _gather_f_beta(member, sols)
    return _true_cost_terms(sc, active, assignment, f, beta)


def repair_assignment(sc_new: Scenario, prev_assign: np.ndarray,
                      old_active: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Repair a previous stable assignment onto a churned scenario, the one
    rule set of the warm path and of any cold re-solve compared with it.

    Departures park at their nearest raw-reachable server; active devices
    whose server is no longer effectively reachable move to their nearest
    effectively-reachable one (raising :class:`NoFeasibleServerError` when
    there is none); everyone else keeps their slot. Under capacities the
    displaced devices and all arrivals are re-admitted greedily in device
    order (:func:`greedy_admission`). Returns ``(assignment, departed,
    arrived, displaced)``."""
    prev_assign = np.asarray(prev_assign)
    n = sc_new.n_devices
    dist = np.asarray(sc_new.dist)
    eff = np.asarray(sc_new.eff_avail)
    active = sc_new.active_mask
    old_active = np.asarray(old_active, dtype=bool)
    cap = sc_new.capacity
    departed = old_active & ~active
    arrived = active & ~old_active
    ok_now = eff[prev_assign, np.arange(n)]
    displaced = active & ~ok_now
    assign = prev_assign.copy()
    assign[departed] = parked_slots(sc_new)[departed]
    if cap is None:
        assign[displaced] = nearest_feasible(dist, eff,
                                             need=displaced)[displaced]
        return assign, departed, arrived, displaced
    readmit = displaced | arrived
    keep = active & ~readmit
    load = np.bincount(assign[keep], minlength=sc_new.n_servers)
    todo = np.flatnonzero(readmit)
    placed = greedy_admission(dist, eff, load, cap, todo)
    if (placed < 0).any():
        raise NoFeasibleServerError(todo[placed < 0], "no admitting server")
    assign[todo] = placed
    return assign, departed, arrived, displaced


class FastAssociationEngine:
    """Steepest permitted transfer per round, and the best of a batch of
    sampled exchanges when no transfer is permitted, to a stable point,
    with the reference's permission rules, tolerances, tie-breaking and
    PRNG stream, in the sweep space ``compact`` selects (module docstring).
    ``kind`` is any §V.A scheme kind of :class:`GroupSolver`.

    ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path. ``shards=p`` runs the
    sharded sweep (module docstring) over the first ``p`` cards, or over
    ``p`` CPU shards for ``device="cpu"``, or over ``shard_devices``; it
    raises ``ValueError`` for ``p < 1`` or fewer cards. A ``fast``-kind bucket (or
    exchange space) wider than the kernel's ``MAX_R`` slots raises
    ``ValueError``. ``last_timing`` holds the seconds of the last sweep's
    cache init, of its moves (every round after the init) and, within
    them, of pricing its exchange rounds (and, after
    :meth:`rerun_incremental`, of its host preparation: maps, repair,
    cache alignment); ``last_counts`` its transfers, exchanges, exchange
    rounds and the cache rows its init solved.
    ``last_state`` dumps the last sweep's membership and caches.
    """

    def __init__(self, sc: Scenario, *, kind: str = "fast",
                 permission: str = "utilitarian", min_residual_group: int = 2,
                 seed: int = 0, rel_tol: float = 1e-5,
                 profile: str = "default", compact: bool | str = "auto",
                 shards: int | None = None, shard_devices=None,
                 device=None):
        if permission not in ("utilitarian", "pareto"):
            raise ValueError(f"unknown permission {permission!r}")
        if compact not in (True, False, "auto", "bucketed"):
            raise ValueError(f"unknown compact={compact!r}")
        self.device = resolve_device(device)
        self.shards, self.shard_devices = _shard_devices(
            shards, shard_devices, self.device)
        self.solver = GroupSolver(sc, kind, seed=seed, profile=profile,
                                  device=self.device)
        # final reporting is always at reference accuracy
        self._eval_solver = self.solver.with_profile("default")
        self.sc = sc
        self.kind = kind
        self.profile = profile
        self.permission = permission
        self.min_residual = min_residual_group
        self.rel_tol = rel_tol
        self.rng = np.random.default_rng(seed)
        self._active = sc.active_mask
        self.avail = np.asarray(sc.eff_avail)
        self.cap = sc.capacity
        # uncapped engines pass N: never binding, since an inbound transfer
        # needs a donor group elsewhere
        self._cap = torch.as_tensor(
            np.full(sc.n_servers, sc.n_devices, np.int64)
            if self.cap is None else self.cap, device=self.device)
        self.cloud_const = (sc.lp.lambda_e * cloud_energy(sc.srv)
                            + sc.lp.lambda_t * cloud_delay(sc.srv)
                            ).to(self.device)
        self.seed = seed
        self.reach: ReachIndex | None = None
        self.reach_buckets: ReachBuckets | None = None
        try:
            self.reach = reach_index_map(np.asarray(sc.avail),
                                         active=self._active)
        except ValueError:
            if compact in (True, "bucketed"):
                raise
        if compact == "auto":
            if self.reach is None or self.reach.r_max >= sc.n_devices:
                compact = False
            else:
                compact = ("bucketed" if self.reach.padded_fraction
                           > BUCKETED_AUTO_THRESHOLD else True)
        self.compact = "bucketed" if compact == "bucketed" else bool(compact)
        if self.compact == "bucketed":
            self.reach_buckets = reach_index_map(
                np.asarray(sc.avail), bucketed=True, active=self._active)
        self._rebuild_space()
        self.last_moves: int | None = None
        self.last_tier_moves: list[int] | None = None
        self.last_timing: dict[str, float] | None = None
        self.last_counts: dict[str, int] | None = None
        self.last_state: dict | None = None
        self._warm_cache: dict | None = None
        self.last_repaired_assignment: np.ndarray | None = None

    # -- the slot space -------------------------------------------------------

    def _rebuild_space(self) -> None:
        """(Re)derive the buckets, the shared exchange bucket and the slot
        locators from ``reach``/``reach_buckets``/``avail``; the toggle
        cache, which :meth:`rerun_incremental` keeps, is not touched."""
        k, n = self.sc.n_servers, self.sc.n_devices
        servers = np.arange(k, dtype=np.int32)
        ex_raw = None
        if self.compact == "bucketed":
            rbk = self.reach_buckets
            raw = [(b.servers, b.idx, b.valid, b.valid) for b in rbk.buckets]
            slot_of, bucket_of, row_of = rbk.slot, rbk.bucket_of, rbk.row_of
            # exchanges hit arbitrary server pairs: they are priced in one
            # flat (K, R_max) space with the buckets' slot numbering
            ex_raw = (servers, self.reach.idx, self.reach.valid,
                      self.reach.valid)
        elif self.compact:
            r = self.reach
            raw = [(servers, r.idx, r.valid, r.valid)]
            slot_of, bucket_of, row_of = r.slot, np.zeros(k, np.int32), servers
        else:
            # identity maps: every slot exists (an out-of-reach member is
            # still priced), availability gates candidacy only
            ident = np.broadcast_to(np.arange(n, dtype=np.int32), (k, n))
            raw = [(servers, ident, np.ones((k, n), bool), self.avail)]
            slot_of, bucket_of, row_of = ident, np.zeros(k, np.int32), servers
        if self.kind == "fast":
            for _, idx, _, _ in raw + ([ex_raw] if ex_raw else []):
                if idx.shape[1] > MAX_R:
                    raise ValueError(
                        f"slot width {idx.shape[1]} exceeds the "
                        f"golden-section kernel's {MAX_R}: a compact space "
                        f"(compact=True or 'bucketed') keeps groups at "
                        f"their reach counts")
        dev = self.device
        self._buckets = tuple(self._gather_bucket(*r) for r in raw)
        self._ex_bucket = (self._gather_bucket(*ex_raw) if ex_raw
                           else self._buckets[0])
        self._slot_of = torch.as_tensor(np.ascontiguousarray(slot_of),
                                        dtype=torch.int32, device=dev)
        self._bucket_of = np.asarray(bucket_of, np.int64)
        self._row_of = np.asarray(row_of, np.int64)
        # the partition: ceil(K_b / p) rows of bucket b a shard
        p = len(self.shard_devices)
        per = np.array([max(-(-bd.servers.shape[0] // p), 1)
                        for bd in self._buckets], np.int64)
        self._owner = self._row_of // per[self._bucket_of]
        self._local_row = self._row_of % per[self._bucket_of]
        self._owner_t = torch.as_tensor(self._owner, device=dev)
        self._shards = tuple(self._make_shard(
            j, d, [(min(j * c, bd.servers.shape[0]),
                    min((j + 1) * c, bd.servers.shape[0]))
                   for bd, c in zip(self._buckets, per)])
            for j, d in enumerate(self.shard_devices))

    def _make_shard(self, j: int, device, spans) -> _Shard:
        """Shard j on ``device``: rows ``spans[b]`` of every bucket b, and
        the flat layout of its slice of the toggle cache (every bucket's
        slice is a view of one buffer, so a scan is one pass)."""
        k = self.sc.n_servers
        buckets = tuple(bd.cut(lo, hi, device)
                        for bd, (lo, hi) in zip(self._buckets, spans))
        sizes = [bd.idx.numel() for bd in buckets]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        widths = np.array([bd.width for bd in buckets], np.int64)
        flat_dev = torch.cat([bd.idx.reshape(-1) for bd in buckets])
        flat_srv = torch.cat([
            bd.servers[:, None].expand(bd.idx.shape).reshape(-1)
            for bd in buckets])
        own = self._owner == j
        b_of = self._bucket_of
        ex = self._ex_bucket
        return _Shard(
            device=device, spans=tuple(spans), buckets=buckets,
            ex_bucket=ex.cut(0, ex.servers.shape[0], device),
            offsets=offsets, flat_dev=flat_dev, flat_srv=flat_srv,
            flat_ok=torch.cat([bd.ok.reshape(-1) for bd in buckets]),
            flat_order=flat_dev * k + flat_srv,
            row_base=torch.as_tensor(np.where(
                own, offsets[b_of] + self._local_row * widths[b_of], 0),
                device=device),
            row_width=torch.as_tensor(np.where(own, widths[b_of], 1),
                                      device=device),
            cloud_const=self.cloud_const.to(device),
            cap=self._cap.to(device))

    def _gather_bucket(self, servers, idx, exists, ok) -> _Bucket:
        """Gather every per-device RA quantity into this bucket's (K_b,
        R_b) slot space; per-server (1-D) leaves gather by server id."""
        dev = self.device
        srv = torch.as_tensor(np.asarray(servers), dtype=torch.int64,
                              device=dev)
        ridx = torch.as_tensor(np.ascontiguousarray(idx), dtype=torch.int64,
                               device=dev)
        rows = srv[:, None]
        s = self.solver
        consts = RAConstants(**{
            name: (v[srv] if v.dim() == 1 else v[rows, ridx])
            for name, v in vars(s.consts).items()})
        fixed_f = self.kind in ("comm_only", "uniform", "proportional")
        return _Bucket(
            servers=srv, idx=ridx,
            exists=torch.as_tensor(np.asarray(exists), device=dev),
            ok=torch.as_tensor(np.asarray(ok), device=dev), consts=consts,
            random_f=s.random_f[ridx] if fixed_f else None,
            inv_dist=(s.inv_dist[rows, ridx] if self.kind == "proportional"
                      else None),
            eye=torch.eye(ridx.shape[1], dtype=torch.bool, device=dev))

    # -- public surface -------------------------------------------------------

    def initial_assignment(self, init: str = "nearest") -> np.ndarray:
        return initial_assignment(self.sc, self.avail, self.rng, init)

    def _member_of(self, assignment: np.ndarray) -> np.ndarray:
        return _dense_member(np.asarray(assignment), self._active,
                             self.sc.n_servers)

    def evaluate_assignment(self, assignment: np.ndarray) -> float:
        """Reference-accuracy total system cost of an explicit assignment,
        the same evaluation ``_finalize`` applies to a stable point."""
        member = self._member_of(np.asarray(assignment))
        sols = self._eval_solver.solve_batch(np.arange(self.sc.n_servers),
                                             member)
        cloud = self.cloud_const.cpu().numpy()
        return float(np.sum(sols.cost.cpu().numpy()
                            + np.where(member.any(axis=1), cloud, 0.0)))

    @property
    def stable_assignment(self) -> np.ndarray | None:
        """The last sweep's stable assignment (parked slots included), or
        ``None`` before the first run."""
        if self._warm_cache is None:
            return None
        return self._warm_cache["assignment"].copy()

    def run(self, init: str = "nearest", *, max_moves: int = 10_000,
            exchange_samples: int = DEFAULT_EXCHANGE_SAMPLES,
            assignment: np.ndarray | None = None, finalize: bool = True):
        """One descent to the stable point with the key ``PRNGKey(seed)``.
        ``exchange_samples`` (default 64) device pairs are drawn on each
        round with no permitted transfer; 0 gives a deterministic
        transfer-only sweep. ``finalize=False`` returns just the (N,)
        stable assignment."""
        assignment = (self.initial_assignment(init) if assignment is None
                      else np.asarray(assignment))
        assignment, member, moves, trace = self._sweep(
            assignment, self.profile, max_moves, exchange_samples,
            prng.PRNGKey(self.seed))
        if not finalize:
            return assignment.copy()
        return self._finalize(assignment, member, moves, trace)

    def run_tiered(self, init: str = "nearest", *,
                   tiers: str | tuple[str, ...] = "two_tier",
                   max_moves: int = 10_000,
                   exchange_samples: int = DEFAULT_EXCHANGE_SAMPLES,
                   tier_rel_tols: tuple[float, ...] | None = None,
                   assignment: np.ndarray | None = None) -> AssociationResult:
        """Drive each profile of ``tiers`` (a ``TIER_PLANS`` plan name or a
        profile tuple) to its stable point, each tier warm-started from the
        previous tier's assignment with the key ``fold_in(PRNGKey(seed),
        tier)`` and its own stop tolerance (``tier_rel_tols``, default the
        engine's). The trace concatenates the tiers (monotone within each);
        ``last_tier_moves`` holds each tier's moves."""
        profiles = ra.resolve_tiers(tiers)
        rel_tols = (tuple(tier_rel_tols) if tier_rel_tols is not None
                    else (self.rel_tol,) * len(profiles))
        if len(rel_tols) != len(profiles):
            raise ValueError(
                f"tier_rel_tols has {len(rel_tols)} entries for "
                f"{len(profiles)} tiers")
        assignment = (self.initial_assignment(init) if assignment is None
                      else np.asarray(assignment))
        base_key = prng.PRNGKey(self.seed)
        total_moves = 0
        trace: list[float] = []
        tier_moves: list[int] = []
        member = None
        for i, (prof, tol) in enumerate(zip(profiles, rel_tols)):
            assignment, member, moves, tr = self._sweep(
                assignment, prof, max_moves, exchange_samples,
                prng.fold_in(base_key, i), rel_tol=tol)
            total_moves += moves
            tier_moves.append(moves)
            trace.extend(tr)
        self.last_tier_moves = tier_moves
        return self._finalize(assignment, member, total_moves, trace)

    def rerun_incremental(self, sc_new: Scenario, delta: ScenarioDelta, *,
                          max_moves: int = 10_000,
                          exchange_samples: int = DEFAULT_EXCHANGE_SAMPLES,
                          verify: bool = False, finalize: bool = True):
        """Re-converge on ``sc_new`` (a churn step of the engine's scenario,
        ``delta`` from :func:`perturb_scenario` or :func:`diff_scenarios`)
        from the previous stable point, keeping the toggle cache.

        The reach maps are patched (only overflowing buckets rebuild), the
        previous stable assignment is repaired (:func:`repair_assignment`),
        and the sweep restarts from the previous cache: only the rows of
        stale servers are re-solved (the delta's, the repair's departures,
        displaced devices and arrivals, every row of a rebuilt bucket, and
        every row of a dense ``proportional`` engine when devices moved).
        It runs at the profile of the last sweep. Chained deltas work: each
        call refreshes the cache for the next. Under ``shards=p`` the cache
        is kept whole on the leader; each shard takes its rows of it back
        (a rebuilt bucket is partitioned anew) and re-solves its stale
        rows.

        ``verify=True`` builds a cold engine on ``sc_new``, descends it from
        the same repaired assignment and raises unless the two stable
        points are identical. ``finalize=False`` returns just the (N,)
        stable assignment.
        """
        if self._warm_cache is None:
            raise RuntimeError(
                "rerun_incremental needs a prior run()/run_tiered() on this "
                "engine to warm-start from")
        t0 = time.perf_counter()
        cache = self._warm_cache
        profile = cache["profile"]
        prev_assign = cache["assignment"]
        old_active = self._active
        n, k = self.sc.n_devices, self.sc.n_servers
        if sc_new.n_devices != n or sc_new.n_servers != k:
            raise ValueError("rerun_incremental requires fixed (N, K); "
                             "churn uses the active mask, not resizing")
        new_cap = sc_new.capacity
        if ((self.cap is None) != (new_cap is None)
                or (self.cap is not None
                    and not np.array_equal(self.cap, new_cap))):
            raise ValueError(
                "rerun_incremental requires churn-invariant max_devices; "
                "rebuild the engine to change capacities")

        # ---- swap the scenario and patch the slot maps ----
        self.sc = sc_new
        self._active = sc_new.active_mask.copy()
        self.avail = np.asarray(sc_new.eff_avail)
        if delta.moved.any():
            # distance-derived solver buffers (only "proportional" reads
            # them; the RA constants are delta-invariant)
            inv = 1.0 / np.maximum(np.asarray(sc_new.dist), 1.0)
            self.solver.inv_dist = torch.as_tensor(inv.astype(np.float32),
                                                   device=self.device)
            self._eval_solver = self.solver.with_profile("default")
        raw = np.asarray(sc_new.avail)
        stale = np.asarray(delta.stale_servers, dtype=bool).copy()
        carry: list = [0] * len(self._buckets)
        if self.compact:
            # the flat map backs the flat sweep and the bucketed space's
            # exchange slots; a dense engine never reads it again
            self.reach, flat_rebuilt = update_reach_index(
                self.reach, raw, active=self._active,
                changed_servers=delta.stale_servers)
        else:
            self.reach = None
        if self.compact == "bucketed":
            self.reach_buckets, carry = update_reach_buckets(
                self.reach_buckets, raw, active=self._active,
                changed_servers=delta.stale_servers)
        elif self.compact:
            carry = [None] if flat_rebuilt else [0]
        elif self.kind == "proportional" and delta.moved.any():
            # dense rows span every device, so a moved device's distance
            # can change any row's cached cost
            stale[:] = True
        self._rebuild_space()

        # ---- repair the previous stable assignment on the host ----
        assign, departed, arrived, displaced = repair_assignment(
            sc_new, prev_assign, old_active)
        stale[prev_assign[departed]] = True
        stale[prev_assign[displaced & old_active]] = True
        stale[assign[displaced]] = True
        stale[assign[arrived]] = True

        # ---- align cached rows to the (possibly patched) layout ----
        toggles_warm = []
        for b, bd in enumerate(self._buckets):
            src = carry[b] if b < len(carry) else None
            if (src is None
                    or tuple(cache["toggles"][src].shape) != tuple(
                        bd.idx.shape)):
                toggles_warm.append(None)
                stale[bd.servers.cpu().numpy()] = True
            else:
                toggles_warm.append(cache["toggles"][src])
        warm = (cache["cur"], toggles_warm, stale)

        self.last_repaired_assignment = assign.copy()
        prepare_s = time.perf_counter() - t0
        assignment, member, moves, trace = self._sweep(
            assign, profile, max_moves, exchange_samples,
            prng.PRNGKey(self.seed), warm=warm)
        self.last_timing["prepare_s"] = prepare_s
        if verify:
            cold = FastAssociationEngine(
                sc_new, kind=self.kind, permission=self.permission,
                min_residual_group=self.min_residual, seed=self.seed,
                rel_tol=self.rel_tol, profile=profile, compact=self.compact,
                shards=self.shards,
                shard_devices=self.shard_devices if self.shards else None,
                device=self.device)
            ref = cold.run(assignment=self.last_repaired_assignment,
                           max_moves=max_moves,
                           exchange_samples=exchange_samples, finalize=False)
            if not np.array_equal(assignment, ref):
                raise AssertionError(
                    "incremental warm start diverged from the cold rebuild: "
                    f"{int((assignment != ref).sum())} device placements "
                    "differ")
        if not finalize:
            return assignment.copy()
        return self._finalize(assignment, member, moves, trace)

    # -- the sweep ------------------------------------------------------------

    def _sweep(self, assignment: np.ndarray, profile: str, max_moves: int,
               exchange_samples: int, key: torch.Tensor,
               rel_tol: float | None = None, warm=None):
        """One profile's adjustment loop; returns (assignment, dense member,
        n_moves, trace), fills ``last_state`` and keeps the stable point's
        cache for :meth:`rerun_incremental`."""
        assignment = np.asarray(assignment, dtype=np.int64)
        n, k = self.sc.n_devices, self.sc.n_servers
        if self.compact:
            # an out-of-reach placement has no slot in a compact space: the
            # device would vanish from its group and its removal toggle
            # would be read from another device's slot
            unreachable = self._active & ~self.avail[assignment, np.arange(n)]
            if unreachable.any():
                bad = np.flatnonzero(unreachable)[:8]
                raise ValueError(
                    "compact sweep requires every device assigned within "
                    f"reach; devices {bad.tolist()} are not (e.g. device "
                    f"{bad[0]} -> server {assignment[bad[0]]})")
        if self.cap is not None:
            # transfers are cap-gated and exchanges cap-neutral, so a sweep
            # keeps an assignment feasible only if it starts feasible
            load = np.bincount(assignment[self._active], minlength=k)
            over = np.flatnonzero(load > self.cap)
            if over.size:
                raise ValueError(
                    f"assignment exceeds max_devices at server(s) "
                    f"{over.tolist()[:8]} (load {load[over].tolist()[:8]} "
                    f"> cap {self.cap[over].tolist()[:8]})")
        member = torch.as_tensor(self._member_of(assignment),
                                 device=self.device)
        assign = assignment.copy()
        cur, per_bucket, moves, trace = self._descend(
            member, assign, profile, max_moves, exchange_samples, key,
            self.rel_tol if rel_tol is None else rel_tol, warm)
        self.last_moves = moves
        member_np = member.cpu().numpy()
        self.last_state = {"member": member_np,
                           "cur_cost": cur.cpu().numpy()}
        if self.compact == "bucketed":
            self.last_state.update(
                toggle_cost_buckets=[t.cpu().numpy() for t in per_bucket],
                reach_buckets=self.reach_buckets)
        elif self.compact:
            r = self.reach
            self.last_state.update(
                member_compact=member_np[np.arange(k)[:, None], r.idx]
                & r.valid,
                toggle_cost_compact=per_bucket[0].cpu().numpy(), reach=r)
        else:
            self.last_state.update(toggle_cost=per_bucket[0].cpu().numpy())
        self._warm_cache = {"assignment": assign.copy(), "cur": cur.clone(),
                            "toggles": per_bucket, "profile": profile}
        return assign, member_np, moves, trace

    @staticmethod
    def _refresh_groups(member_row: torch.Tensor, bd: _Bucket, row: int):
        """The refresh batch of row ``row`` of bucket ``bd``, whose server's
        membership is ``member_row`` (N,): ``(rows (R_b + 1,), masks (R_b +
        1, R_b))``, its current group and its R_b single-slot toggles."""
        base = (member_row[bd.idx[row]] & bd.exists[row])[None]
        rows = torch.full((bd.width + 1,), row, device=bd.idx.device)
        return rows, torch.cat([base, base ^ bd.eye])

    def _exchange_groups(self, member: torch.Tensor, assign_t: torch.Tensor,
                         pairs: torch.Tensor):
        """The exchange batch of sampled device pairs ``pairs`` (S, 2) in
        the exchange space: ``(rows (2S,), masks (2S, R_max), okay (S,))``,
        both swapped groups of every pair (rows are server ids) and which
        pairs are distinct, on distinct servers and within reach."""
        ex, slot_of = self._ex_bucket, self._slot_of
        r_ex = ex.width
        dn, dm = pairs[:, 0], pairs[:, 1]
        si, sj = assign_t[dn], assign_t[dm]

        def slot(srv, dv):
            return slot_of[srv, dv].long()

        def can_join(srv, dv):
            sl = slot(srv, dv)
            return (sl < r_ex) & ex.ok[srv, sl.clamp(max=r_ex - 1)]

        def onehot(srv, dv):
            # an out-of-reach slot encodes as the all-zero row
            return (torch.arange(r_ex, device=member.device)[None, :]
                    == slot(srv, dv)[:, None])

        def base(rows):
            return (member[ex.servers[rows][:, None], ex.idx[rows]]
                    & ex.exists[rows])

        okay = ((dn != dm) & (si != sj)
                & can_join(sj, dn) & can_join(si, dm))
        masks = torch.cat([base(si) ^ onehot(si, dn) ^ onehot(si, dm),
                           base(sj) ^ onehot(sj, dm) ^ onehot(sj, dn)])
        return torch.cat([si, sj]), masks, okay

    def _descend(self, member: torch.Tensor, assign: np.ndarray,
                 profile: str, max_moves: int, exchange_samples: int,
                 key: torch.Tensor, rel_tol: float, warm):
        """The adjustment loop (``_run_device_impl`` of the reference) over
        the engine's shards. Updates ``member`` and ``assign`` in place;
        returns (cur, each bucket's (K_b, R_b) cache on the leader,
        n_moves, trace) and sets ``last_timing`` and ``last_counts``."""
        k, n = member.shape
        dev = self.device
        shards = self._shards
        idx_n = torch.arange(n, device=dev)
        big = torch.tensor(_I64_BIG, device=dev)
        assign_t = torch.as_tensor(assign, device=dev)
        slot_of = self._slot_of
        pareto = self.permission == "pareto"
        kind = self.kind

        def harmless(new, old):
            return new <= old + rel_tol * torch.clamp_min(old, 1e-9)

        def bucket_costs(bd: _Bucket, rows: torch.Tensor, masks, cloud):
            """Group costs of ``masks`` (M, R_b) at bucket rows ``rows``,
            plus each non-empty group's cloud constant: one batched solve
            (one kernel launch for the ``fast`` kind)."""
            sol = solve_groups(
                kind, bd.consts.rows(rows), masks,
                random_f=None if bd.random_f is None else bd.random_f[rows],
                inv_dist=None if bd.inv_dist is None else bd.inv_dist[rows],
                profile=profile)
            return sol.cost + torch.where(masks.any(-1),
                                          cloud[bd.servers[rows]], 0.0)

        def fold(pairs):
            """The lexicographic minimum of the shards' (delta, order)
            pairs, on the leader."""
            if len(pairs) == 1:
                return pairs[0]
            deltas = torch.stack([d.to(dev) for d, _ in pairs])
            orders = torch.stack([o.to(dev) for _, o in pairs])
            best = deltas.min()
            return best, torch.where(deltas == best, orders, big).min()

        t0 = time.perf_counter()
        cur = torch.zeros(k, device=dev)
        toggles = [torch.empty(sh.size, device=sh.device) for sh in shards]
        views = [[t[sh.offsets[b]:sh.offsets[b + 1]].view(bd.idx.shape)
                  for b, bd in enumerate(sh.buckets)]
                 for sh, t in zip(shards, toggles)]

        def refresh(s: int) -> None:
            """Re-solve server s's row of its bucket on the shard that owns
            it: R_b + 1 groups, one batch."""
            j, b = int(self._owner[s]), int(self._bucket_of[s])
            row = int(self._local_row[s])
            sh = shards[j]
            bd = sh.buckets[b]
            rows, masks = self._refresh_groups(member[s].to(sh.device), bd,
                                               row)
            costs = bucket_costs(bd, rows, masks, sh.cloud_const)
            cur[s] = costs[0].to(dev)
            views[j][b][row] = costs[1:]

        if warm is None:
            solve_rows = np.arange(k)
        else:
            cur_prev, toggles_prev, stale = warm
            cur.copy_(cur_prev)
            for sh, shard_views in zip(shards, views):
                for (lo, hi), view, prev in zip(sh.spans, shard_views,
                                                toggles_prev):
                    if prev is not None:
                        view.copy_(prev[lo:hi])
            solve_rows = np.flatnonzero(stale)
        for s in solve_rows:
            refresh(int(s))
        trace = [cur.sum()]
        for d in {sh.device for sh in shards} | {dev}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)     # so init_s times the init
        t1 = time.perf_counter()

        def best_transfer():
            """Scan every transfer candidate of every shard from the cache,
            no solves: (delta, key n*K + k) of the best permitted one."""
            # each device's slot in its server's row (clamped below: a
            # parked device has no slot and is no candidate)
            sl = slot_of[assign_t, idx_n].long()
            gsize = member.sum(1)                                # (k,)
            a_sh = [assign_t.to(sh.device) for sh in shards]
            # each device's removal toggle, from the shard owning its server
            minus = []
            for sh, t, a in zip(shards, toggles, a_sh):
                if not sh.size:
                    minus.append(torch.zeros(n, device=dev))
                    continue
                at = sh.row_base[a] + torch.minimum(sl.to(sh.device),
                                                    sh.row_width[a] - 1)
                minus.append(t[at].to(dev))
            minus = (minus[0] if len(minus) == 1 else torch.stack(minus)
                     .gather(0, self._owner_t[assign_t][None])[0])
            pairs = []
            for sh, t, a in zip(shards, toggles, a_sh):
                if not sh.size:
                    continue
                d = sh.device
                cur_d, gsize_d, minus_d = (x.to(d) for x in (cur, gsize,
                                                            minus))
                f_dev, f_srv = sh.flat_dev, sh.flat_srv
                cur_src = cur_d[a]                                # (n,)
                cur_b = cur_d[f_srv]
                src = a[f_dev]
                delta = (minus_d - cur_src)[f_dev] + t - cur_b
                scale = torch.clamp_min(cur_b + cur_src[f_dev], 1e-9)
                valid = (sh.flat_ok & (src != f_srv)
                         & (gsize_d[src] > self.min_residual)
                         & (gsize_d[f_srv] < sh.cap[f_srv]))
                permitted = valid & (delta < -rel_tol * scale)
                if pareto:
                    permitted &= (harmless(t, cur_b)
                                  & harmless(minus_d, cur_src)[f_dev])
                masked = torch.where(permitted, delta, math.inf)
                best = masked.min()
                p = torch.where(masked == best, sh.flat_order,
                                _I64_BIG).argmin()
                # a 1-element index: a 0-d one is read on the host
                pairs.append((best, sh.flat_order[p.reshape(1)][0]))
            return fold(pairs)

        def best_exchange(pairs: torch.Tensor):
            """Price both swapped groups of every sampled pair in the
            exchange space, a contiguous chunk of samples a shard (one batch
            each): (delta, sample index) of the first best permitted one."""
            rows, masks, okay = self._exchange_groups(member, assign_t, pairs)
            chunk = -(-exchange_samples // len(shards))
            out = []
            for j, sh in enumerate(shards):
                lo = j * chunk
                hi = min(lo + chunk, exchange_samples)
                if lo >= hi:
                    continue
                if hi - lo == exchange_samples:
                    rows_j, masks_j = rows, masks
                else:
                    sel = torch.cat([torch.arange(lo, hi, device=dev),
                                     torch.arange(exchange_samples + lo,
                                                  exchange_samples + hi,
                                                  device=dev)])
                    rows_j, masks_j = rows[sel], masks[sel]
                d = sh.device
                rows_j, masks_j = rows_j.to(d), masks_j.to(d)
                costs = bucket_costs(sh.ex_bucket, rows_j, masks_j,
                                     sh.cloud_const)
                m = hi - lo
                cur_d = cur.to(d)
                si, sj = rows_j[:m], rows_j[m:]
                ci, cj = costs[:m], costs[m:]
                old = cur_d[si] + cur_d[sj]
                delta = ci + cj - old
                permitted = okay[lo:hi].to(d) & (
                    delta < -rel_tol * torch.clamp_min(old, 1e-9))
                if pareto:
                    permitted &= (harmless(ci, cur_d[si])
                                  & harmless(cj, cur_d[sj]))
                masked = torch.where(permitted, delta, math.inf)
                e = masked.argmin()
                out.append((masked[e], e + lo))
            return fold(out)

        def move(dev_: int, src: int, dst: int) -> None:
            member[src, dev_] = False
            member[dst, dev_] = True
            assign[dev_] = dst
            assign_t[dev_] = dst

        moves = transfers = exchanges = exchange_rounds = 0
        exchange_s = 0.0
        while moves < max_moves:
            best, order = best_transfer()
            # hfellint: disable=HFEL003 -- the round's one host sync
            best_v, order_v = torch.stack([best.double(),
                                           order.double()]).tolist()
            if math.isfinite(best_v):
                t_dev, t_dst = divmod(int(order_v), k)
                t_src = int(assign[t_dev])
                move(t_dev, t_src, t_dst)
                transfers += 1
            else:
                if not exchange_samples:
                    break
                # only a round with no permitted transfer splits the key
                te = time.perf_counter()
                key, sub = prng.split(key)
                pairs = prng.randint(sub, (exchange_samples, 2), 0, n)
                exchange_rounds += 1
                best, e = best_exchange(pairs.to(dev))
                # hfellint: disable=HFEL003 -- the round's one host sync
                best_v, e_v = torch.stack([best.double(),
                                           e.double()]).tolist()
                exchange_s += time.perf_counter() - te
                if not math.isfinite(best_v):
                    break
                # hfellint: disable=HFEL003 -- the proposal lies on the host
                dn, dm = pairs[int(e_v)].tolist()
                t_src, t_dst = int(assign[dn]), int(assign[dm])
                move(dn, t_src, t_dst)
                move(dm, t_dst, t_src)
                exchanges += 1
            refresh(t_src)
            refresh(t_dst)
            moves += 1
            trace.append(cur.sum())
        trace = torch.stack(trace).cpu().double().tolist()
        self.last_timing = {"init_s": t1 - t0,
                            "moves_s": time.perf_counter() - t1,
                            "exchange_pricing_s": exchange_s}
        self.last_counts = {"transfers": transfers, "exchanges": exchanges,
                            "exchange_rounds": exchange_rounds,
                            "init_rows": int(len(solve_rows))}
        # each bucket's cache back in its unsharded layout, on the leader
        per_bucket = [torch.cat([v[b].to(dev) for v in views])
                      for b in range(len(self._buckets))]
        return cur, per_bucket, moves, trace

    def _finalize(self, assignment, member, moves, trace) -> AssociationResult:
        k = self.sc.n_servers
        masks = torch.as_tensor(member, device=self.device)
        sols = self._eval_solver.solve_batch(np.arange(k), masks)
        f, beta = _gather_f_beta(masks, sols)
        server_cost = sols.cost.cpu().numpy()
        cloud = self.cloud_const.cpu().numpy()
        total = float(np.sum(server_cost
                             + np.where(member.any(axis=1), cloud, 0.0)))
        e, t, c = _true_cost_terms(self.sc, self._active, assignment, f, beta)
        return AssociationResult(
            assignment=assignment.copy(), f=f, beta=beta,
            server_cost=server_cost, total_cost=total,
            true_energy=e, true_delay=t, true_cost=c,
            n_adjustments=moves, n_rounds=moves, cost_trace=trace)
