"""Random HFEL scenario generation following the paper's Table II.

Port of ``repro.core.scenario``. The draws are the reference's numpy
code, line for line, with ``numpy.random.default_rng``, so every field is
bit-identical to the JAX package's scenario for the same arguments.
Geometry (``avail``, ``dist``, positions) stays in numpy on the host; the
device and server parameters become float32 tensors on the scenario's
device.

Beside the generators: the reach maps of the compacted sweep spaces
(:func:`reach_index_map`, flat or bucketed by binary reach count) and their
incremental updates (:func:`update_reach_index`,
:func:`update_reach_buckets`); churn (:func:`perturb_scenario`, a seeded
tick of mobility, reach flips, departures and arrivals, and
:func:`diff_scenarios`, the combined delta of several ticks); and the
device-client bridge of the live loop (:func:`device_client_bridge`). All
of it is numpy and bit-identical to the reference.

Table II: edge bandwidth 10 MHz, transmit power 200 mW, CPU frequency
[1, 10] GHz, processing density [30, 100] cycle/bit, noise 1e-8 W, training
size [5, 10] MB, model size 25000 nats, capacitance 2e-28.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import DTYPE, resolve_device
from repro_torch.core.cost_model import (DeviceParams, LearningParams,
                                         ServerParams)


@dataclass(frozen=True)
class ReachIndex:
    """Per-server compaction maps of a (K, N) availability matrix.

    ``idx[k, r]`` is the device in reachable slot ``r`` of server ``k``
    (ascending device ids, 0-padded past the reach count); ``valid[k, r]``
    marks real slots; ``slot[k, n]`` inverts the map, with ``r_max`` (the
    widest reach count, the compacted width) marking an out-of-reach device,
    so a one-hot encoding of it is all-zero.
    """

    idx: np.ndarray        # (K, R) int32
    valid: np.ndarray      # (K, R) bool
    slot: np.ndarray       # (K, N) int32, r_max == "unreachable"
    r_max: int

    @property
    def density(self) -> float:
        return float(self.valid.mean())

    @property
    def padded_fraction(self) -> float:
        """Fraction of compacted slots that are padding."""
        return 1.0 - self.density


@dataclass(frozen=True)
class ReachBucket:
    """One width bucket of :class:`ReachBuckets`: the servers whose reach
    count shares a binary magnitude, compacted at the bucket's own width."""

    servers: np.ndarray    # (K_b,) int32 global server ids
    idx: np.ndarray        # (K_b, R_b) int32 device per slot (0-padded)
    valid: np.ndarray      # (K_b, R_b) bool — real slots
    width: int             # R_b = widest reach count in this bucket
    key: int = -1          # ceil(log2(count)) of its servers


@dataclass(frozen=True)
class ReachBuckets:
    """Adaptive-width compaction maps: servers grouped by
    ``ceil(log2(reach count))``, each bucket compacted to its own width.
    Device ``n`` of server ``k`` lives at slot ``slot[k, n]`` of row
    ``row_of[k]`` in bucket ``bucket_of[k]``; ``r_max`` is the shared
    out-of-reach sentinel, at least every bucket's width."""

    buckets: tuple[ReachBucket, ...]
    bucket_of: np.ndarray  # (K,) int32
    row_of: np.ndarray     # (K,) int32 — row within the owning bucket
    slot: np.ndarray       # (K, N) int32, r_max == "unreachable"
    r_max: int

    @property
    def padded_fraction(self) -> float:
        total = sum(b.idx.size for b in self.buckets)
        real = sum(int(b.valid.sum()) for b in self.buckets)
        return 1.0 - real / max(total, 1)


def _fill_reach_row(reach: np.ndarray, idx_row: np.ndarray,
                    valid_row: np.ndarray, slot_row: np.ndarray,
                    sentinel: int) -> None:
    """Write one server's compacted row in place: ascending device ids in
    the leading slots (0-padded), their validity flags, and the inverse
    slot map with ``sentinel`` for out-of-reach devices. The builder and
    both incremental patchers share it."""
    idx_row[:] = 0
    valid_row[:] = False
    idx_row[:reach.size] = reach
    valid_row[:reach.size] = True
    slot_row[:] = sentinel
    slot_row[reach] = np.arange(reach.size, dtype=np.int32)


def reach_index_map(avail: np.ndarray, *, bucketed: bool = False,
                    active: np.ndarray | None = None):
    """The compacted reachable-set maps of ``avail`` (K, N):
    :class:`ReachIndex`, or :class:`ReachBuckets` with ``bucketed=True``.
    ``active`` (N,) restricts them to the active devices (inactive ones
    occupy no slot and need not reach a server). An active device that
    reaches no server raises (constraint 17e)."""
    avail = np.asarray(avail, dtype=bool)
    if active is not None:
        avail = avail & np.asarray(active, dtype=bool)[None, :]
    need_reach = (np.ones(avail.shape[1], bool) if active is None
                  else np.asarray(active, dtype=bool))
    if not avail.any(axis=0)[need_reach].all():
        raise ValueError("every device must reach at least one server")
    k, n = avail.shape
    counts = avail.sum(axis=1)
    r_max = int(counts.max()) if k else 0

    def fill(servers, width, slot):
        idx = np.zeros((len(servers), width), dtype=np.int32)
        valid = np.zeros((len(servers), width), dtype=bool)
        for row, srv in enumerate(servers):
            _fill_reach_row(np.flatnonzero(avail[srv]), idx[row],
                            valid[row], slot[srv], r_max)
        return idx, valid

    slot = np.full((k, n), r_max, dtype=np.int32)
    if not bucketed:
        idx, valid = fill(range(k), r_max, slot)
        return ReachIndex(idx=idx, valid=valid, slot=slot, r_max=r_max)

    # key = ceil(log2(count)); a zero-reach server joins the narrowest
    keys = np.array([max(int(c) - 1, 0).bit_length() for c in counts])
    buckets = []
    bucket_of = np.zeros(k, dtype=np.int32)
    row_of = np.zeros(k, dtype=np.int32)
    for b, key in enumerate(sorted(set(keys.tolist()))):
        servers = np.flatnonzero(keys == key).astype(np.int32)
        width = max(int(counts[servers].max()), 1)
        idx, valid = fill(servers, width, slot)
        bucket_of[servers] = b
        row_of[servers] = np.arange(servers.size, dtype=np.int32)
        buckets.append(ReachBucket(servers=servers, idx=idx, valid=valid,
                                   width=width, key=int(key)))
    return ReachBuckets(buckets=tuple(buckets), bucket_of=bucket_of,
                        row_of=row_of, slot=slot, r_max=r_max)


@dataclass
class Scenario:
    dev: DeviceParams
    srv: ServerParams
    avail: np.ndarray            # (K, N) bool — device n can reach server i
    dist: np.ndarray             # (K, N) meters
    lp: LearningParams = field(default_factory=LearningParams)
    # ``active`` marks the devices currently present; ``None`` = everyone
    active: np.ndarray | None = None     # (N,) bool
    dev_xy: np.ndarray | None = None     # (N, 2) meters
    srv_xy: np.ndarray | None = None     # (K, 2) meters
    reach_m: float | None = None
    # per-edge admission capacity; ``None`` = unlimited (the paper's model)
    max_devices: np.ndarray | None = None  # (K,) int

    @property
    def n_devices(self) -> int:
        return self.dev.n_devices

    @property
    def n_servers(self) -> int:
        return self.srv.n_servers

    @property
    def device(self) -> torch.device:
        return self.dev.f_min.device

    @property
    def active_mask(self) -> np.ndarray:
        """(N,) bool — always materialized, all-True when ``active`` unset."""
        if self.active is None:
            return np.ones(self.n_devices, dtype=bool)
        return np.asarray(self.active, dtype=bool)

    @property
    def eff_avail(self) -> np.ndarray:
        """Reachability restricted to active devices."""
        if self.active is None:
            return np.asarray(self.avail, dtype=bool)
        return np.asarray(self.avail, dtype=bool) & self.active_mask[None, :]

    @property
    def capacity(self) -> np.ndarray | None:
        """Validated (K,) int64 per-edge capacity, or ``None``."""
        if self.max_devices is None:
            return None
        cap = np.asarray(self.max_devices, dtype=np.int64)
        if cap.shape != (self.n_servers,):
            raise ValueError(
                f"max_devices must have shape ({self.n_servers},), "
                f"got {cap.shape}")
        if (cap < 1).any():
            raise ValueError("max_devices entries must be >= 1")
        return cap


# ---------------------------------------------------------------------------
# Churn: seeded perturbations, multi-tick deltas and incremental reach maps
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScenarioDelta:
    """One :func:`perturb_scenario` step (or a :func:`diff_scenarios`
    combination of several). ``stale_servers`` is the conservative
    invalidation set for caches keyed on the scenario: every server whose
    effective reachable set changed, plus every server reaching a moved
    device before or after."""

    seed: int
    moved: np.ndarray          # (N,) bool — position (dist column) changed
    arrived: np.ndarray        # (N,) bool — inactive -> active
    departed: np.ndarray       # (N,) bool — active -> inactive
    avail_flips: np.ndarray    # (K, N) bool — raw reachability bits flipped
    eff_flips: np.ndarray      # (K, N) bool — effective (active-masked) flips
    stale_servers: np.ndarray  # (K,) bool — see above

    @property
    def touched_devices(self) -> np.ndarray:
        return (self.moved | self.arrived | self.departed
                | self.avail_flips.any(axis=0))


def perturb_scenario(sc: Scenario, *, seed: int, drift_m: float = 50.0,
                     move_frac: float = 0.1, flip_frac: float = 0.0,
                     depart_frac: float = 0.0, arrive_frac: float = 0.0
                     ) -> tuple[Scenario, ScenarioDelta]:
    """One seeded churn step: Gaussian position drift (re-deriving the
    touched dist/avail columns), one flipped reach bit per picked device,
    and departures/arrivals through ``active``. Physical parameters (hence
    every RA constant) are held fixed, and the device and server tensors
    stay the same objects, on the scenario's device. Fractions are of the
    eligible population (active for departures, moves and flips, inactive
    for arrivals). Every device keeps at least its nearest server (17e
    repair over all devices). Returns ``(new_scenario, delta)``; ``sc`` is
    not mutated."""
    if sc.dev_xy is None or sc.srv_xy is None or sc.reach_m is None:
        raise ValueError(
            "perturb_scenario needs positions and reach_m on the Scenario "
            "(rebuild it with make_scenario/make_large_scenario)")
    rng = np.random.default_rng(seed)
    n, k = sc.n_devices, sc.n_servers
    active_old = sc.active_mask
    avail_old = np.asarray(sc.avail, dtype=bool)

    def pick(mask: np.ndarray, frac: float) -> np.ndarray:
        cand = np.flatnonzero(mask)
        m = min(int(round(frac * cand.size)), cand.size)
        out = np.zeros(n, dtype=bool)
        if m:
            out[rng.choice(cand, size=m, replace=False)] = True
        return out

    departed = pick(active_old, depart_frac)
    arrived = pick(~active_old, arrive_frac)
    active_new = (active_old & ~departed) | arrived

    moved = pick(active_new, move_frac)
    dev_xy = np.asarray(sc.dev_xy, dtype=float).copy()
    dist = np.asarray(sc.dist, dtype=float).copy()
    avail = avail_old.copy()
    if moved.any():
        dev_xy[moved] += rng.normal(0.0, drift_m,
                                    size=(int(moved.sum()), 2))
        dist[:, moved] = np.linalg.norm(
            np.asarray(sc.srv_xy)[:, None, :] - dev_xy[None, moved, :],
            axis=-1)
        avail[:, moved] = dist[:, moved] <= sc.reach_m

    flipped = pick(active_new, flip_frac)
    if flipped.any():
        cols = np.flatnonzero(flipped)
        rows = rng.integers(0, k, cols.size)
        avail[rows, cols] = ~avail[rows, cols]

    # 17e repair over every device, parked ones included (their parked
    # slot reads raw reach)
    nearest = np.argmin(dist, axis=0)
    bad = ~avail.any(axis=0)
    avail[nearest[bad], bad] = True

    avail_flips, eff_flips, stale = _delta_flips(
        avail_old, active_old, avail, active_new, moved)

    sc_new = dataclasses.replace(sc, avail=avail, dist=dist,
                                 active=active_new, dev_xy=dev_xy)
    delta = ScenarioDelta(seed=seed, moved=moved, arrived=arrived,
                          departed=departed, avail_flips=avail_flips,
                          eff_flips=eff_flips, stale_servers=stale)
    return sc_new, delta


def _same_params(a, b) -> bool:
    """True when two parameter dataclasses hold equal tensors (identity
    short-circuits: churn carries the very same objects across ticks)."""
    if a is b:
        return True

    def host(x):
        return torch.as_tensor(x).cpu()

    return all(torch.equal(host(getattr(a, f.name)), host(getattr(b, f.name)))
               for f in dataclasses.fields(a))


def _delta_flips(avail_old: np.ndarray, active_old: np.ndarray,
                 avail_new: np.ndarray, active_new: np.ndarray,
                 moved: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A delta's ``(avail_flips, eff_flips, stale_servers)``, shared by
    :func:`perturb_scenario` and :func:`diff_scenarios`."""
    avail_flips = avail_new != avail_old
    eff_flips = ((avail_new & active_new[None, :])
                 != (avail_old & active_old[None, :]))
    stale = eff_flips.any(axis=1)
    if moved.any():
        stale |= avail_old[:, moved].any(axis=1)
        stale |= avail_new[:, moved].any(axis=1)
    return avail_flips, eff_flips, stale


def diff_scenarios(sc_old: Scenario, sc_new: Scenario) -> ScenarioDelta:
    """The single :class:`ScenarioDelta` between two same-shaped scenarios
    of one churn trajectory (several ticks at once; a device that left and
    came back cancels out; ``seed`` is -1). Raises unless the device,
    server and learning parameters and the capacities are the same."""
    if (sc_old.n_devices != sc_new.n_devices
            or sc_old.n_servers != sc_new.n_servers):
        raise ValueError("diff_scenarios requires same-shaped scenarios")
    caps_match = ((sc_old.max_devices is None) == (sc_new.max_devices is None)
                  and (sc_old.max_devices is None
                       or np.array_equal(np.asarray(sc_old.max_devices),
                                         np.asarray(sc_new.max_devices))))
    if not (_same_params(sc_old.dev, sc_new.dev)
            and _same_params(sc_old.srv, sc_new.srv)
            and sc_old.lp == sc_new.lp and caps_match):
        # caches keyed on RA constants survive a delta only because these
        # are churn-invariant
        raise ValueError(
            "diff_scenarios requires churn-invariant device/server/learning "
            "parameters and capacities (only avail/dist/active/dev_xy may "
            "differ)")
    active_old = sc_old.active_mask
    active_new = sc_new.active_mask
    avail_old = np.asarray(sc_old.avail, dtype=bool)
    avail_new = np.asarray(sc_new.avail, dtype=bool)
    moved = (np.asarray(sc_old.dist) != np.asarray(sc_new.dist)).any(axis=0)
    arrived = active_new & ~active_old
    departed = active_old & ~active_new
    avail_flips, eff_flips, stale = _delta_flips(
        avail_old, active_old, avail_new, active_new, moved)
    return ScenarioDelta(seed=-1, moved=moved, arrived=arrived,
                         departed=departed, avail_flips=avail_flips,
                         eff_flips=eff_flips, stale_servers=stale)


@dataclass(frozen=True)
class DeviceClientBridge:
    """Index bridge between a scenario's device axis and a federated
    dataset's client axis: ``device_of[c]`` backs client ``c``;
    ``client_of[n]`` is device ``n``'s client, or -1."""

    device_of: np.ndarray   # (n_clients,) int32
    client_of: np.ndarray   # (n_devices,) int32, -1 = no client

    @property
    def n_clients(self) -> int:
        return int(self.device_of.shape[0])

    @property
    def n_devices(self) -> int:
        return int(self.client_of.shape[0])

    def client_mask(self, devices: np.ndarray) -> np.ndarray:
        """A device-axis boolean mask on the client axis."""
        return np.asarray(devices, dtype=bool)[self.device_of]

    def client_assignment(self, assignment: np.ndarray) -> np.ndarray:
        """A device -> server assignment on the client axis."""
        return np.asarray(assignment)[self.device_of]


def device_client_bridge(sc: Scenario, n_clients: int,
                         device_of: np.ndarray | None = None
                         ) -> DeviceClientBridge:
    """The validated bridge for ``sc``: ``device_of`` defaults to the
    identity prefix (client c is device c, so ``n_clients <= N``); an
    explicit one maps clients to distinct devices."""
    n = sc.n_devices
    if device_of is None:
        if n_clients > n:
            raise ValueError(
                f"dataset has {n_clients} clients but the scenario only "
                f"{n} devices; pass an explicit device_of mapping")
        device_of = np.arange(n_clients, dtype=np.int32)
    device_of = np.asarray(device_of, dtype=np.int32)
    if device_of.shape != (n_clients,):
        raise ValueError(f"device_of must have shape ({n_clients},)")
    if device_of.size and (device_of.min() < 0 or device_of.max() >= n):
        raise ValueError("device_of entries must be valid device indices")
    if np.unique(device_of).size != device_of.size:
        raise ValueError("device_of must map clients to distinct devices")
    client_of = np.full(n, -1, dtype=np.int32)
    client_of[device_of] = np.arange(n_clients, dtype=np.int32)
    return DeviceClientBridge(device_of=device_of, client_of=client_of)


def _changed_rows(eff: np.ndarray, row_sets: list[np.ndarray]) -> np.ndarray:
    """Servers whose stored reachable set (ascending device ids) no longer
    matches ``eff[s]``."""
    out = np.zeros(eff.shape[0], dtype=bool)
    for s in range(eff.shape[0]):
        reach = np.flatnonzero(eff[s])
        out[s] = (reach.size != row_sets[s].size
                  or not np.array_equal(reach, row_sets[s]))
    return out


def update_reach_index(ri: ReachIndex, avail: np.ndarray, *,
                       active: np.ndarray | None = None,
                       changed_servers: np.ndarray | None = None
                       ) -> tuple[ReachIndex, bool]:
    """Patch a flat :class:`ReachIndex` across an availability delta:
    changed servers' rows are rewritten at the allocated width (kept when
    the widest count shrinks); a count past that width rebuilds the map.
    Returns ``(new_map, rebuilt)``; ``ri`` is not mutated."""
    eff = np.asarray(avail, dtype=bool)
    if active is not None:
        eff = eff & np.asarray(active, dtype=bool)[None, :]
    k, n = eff.shape
    counts = eff.sum(axis=1)
    if k and int(counts.max()) > ri.r_max:
        return reach_index_map(avail, active=active), True
    if changed_servers is None:
        changed_servers = _changed_rows(
            eff, [ri.idx[s, ri.valid[s]] for s in range(k)])
    idx, valid, slot = ri.idx.copy(), ri.valid.copy(), ri.slot.copy()
    for s in np.flatnonzero(np.asarray(changed_servers, dtype=bool)):
        _fill_reach_row(np.flatnonzero(eff[s]), idx[s], valid[s], slot[s],
                        ri.r_max)
    return ReachIndex(idx=idx, valid=valid, slot=slot, r_max=ri.r_max), False


def update_reach_buckets(rbk: ReachBuckets, avail: np.ndarray, *,
                         active: np.ndarray | None = None,
                         changed_servers: np.ndarray | None = None
                         ) -> tuple[ReachBuckets, list]:
    """Maintain :class:`ReachBuckets` across an availability delta. A
    changed server that keeps its bucket's key and fits its width is
    patched in place; one that does not rebuilds exactly the buckets it
    leaves and joins. Untouched buckets keep their arrays. The sentinel
    only grows (stale sentinel entries are remapped when it does).

    Returns ``(new_rbk, carry)``: ``carry[b]`` is the old bucket whose
    (servers, width) layout new bucket ``b`` keeps, or ``None`` for a
    rebuilt one; per-row caches of a carried bucket stay aligned. ``rbk``
    is not mutated."""
    eff = np.asarray(avail, dtype=bool)
    if active is not None:
        eff = eff & np.asarray(active, dtype=bool)[None, :]
    k, n = eff.shape
    counts = eff.sum(axis=1)
    keys_new = np.array([max(int(c) - 1, 0).bit_length() for c in counts])
    if changed_servers is None:
        sets = [None] * k
        for b in rbk.buckets:
            for row, srv in enumerate(b.servers):
                sets[srv] = b.idx[row, b.valid[row]]
        changed_servers = _changed_rows(eff, sets)
    changed = np.flatnonzero(np.asarray(changed_servers, dtype=bool))

    rebuild_keys: set[int] = set()
    patch: list[int] = []
    for s in changed:
        bk = rbk.buckets[rbk.bucket_of[s]]
        if int(keys_new[s]) == bk.key and int(counts[s]) <= bk.width:
            patch.append(int(s))
        else:
            rebuild_keys.add(bk.key)
            rebuild_keys.add(int(keys_new[s]))

    members = {key: np.flatnonzero(keys_new == key).astype(np.int32)
               for key in rebuild_keys}
    new_widths = [max(int(counts[m].max()), 1)
                  for m in members.values() if m.size]
    sentinel = max([rbk.r_max] + new_widths)
    slot = rbk.slot.copy()
    if sentinel > rbk.r_max:
        # valid slots are below their bucket's width <= the old sentinel,
        # so entries equal to it are exactly the out-of-reach markers
        slot[slot == rbk.r_max] = sentinel

    def fill_rows(servers, width):
        idx = np.zeros((len(servers), width), dtype=np.int32)
        valid = np.zeros((len(servers), width), dtype=bool)
        for row, srv in enumerate(servers):
            _fill_reach_row(np.flatnonzero(eff[srv]), idx[row], valid[row],
                            slot[srv], sentinel)
        return idx, valid

    new_buckets: list[ReachBucket] = []
    carry: list = []
    for ob, bk in enumerate(rbk.buckets):
        if bk.key in rebuild_keys:
            srvs = members[bk.key]
            if srvs.size:
                idx, valid = fill_rows(srvs, max(int(counts[srvs].max()), 1))
                new_buckets.append(ReachBucket(
                    servers=srvs, idx=idx, valid=valid,
                    width=idx.shape[1], key=bk.key))
                carry.append(None)
            continue
        in_bucket = [s for s in patch if rbk.bucket_of[s] == ob]
        if in_bucket:
            idx, valid = bk.idx.copy(), bk.valid.copy()
            for s in in_bucket:
                row = rbk.row_of[s]
                _fill_reach_row(np.flatnonzero(eff[s]), idx[row],
                                valid[row], slot[s], sentinel)
            bk = ReachBucket(servers=bk.servers, idx=idx, valid=valid,
                             width=bk.width, key=bk.key)
        new_buckets.append(bk)
        carry.append(ob)
    existing = {b.key for b in rbk.buckets}
    for key in sorted(rebuild_keys - existing):
        srvs = members[key]
        if srvs.size:
            idx, valid = fill_rows(srvs, max(int(counts[srvs].max()), 1))
            new_buckets.append(ReachBucket(servers=srvs, idx=idx, valid=valid,
                                           width=idx.shape[1], key=key))
            carry.append(None)

    bucket_of = np.zeros(k, dtype=np.int32)
    row_of = np.zeros(k, dtype=np.int32)
    for b, bk in enumerate(new_buckets):
        bucket_of[bk.servers] = b
        row_of[bk.servers] = np.arange(bk.servers.size, dtype=np.int32)
    return ReachBuckets(buckets=tuple(new_buckets), bucket_of=bucket_of,
                        row_of=row_of, slot=slot, r_max=sentinel), carry


def pairwise_dist(srv_xy: np.ndarray, dev_xy: np.ndarray, *,
                  chunk: int = 16_384) -> np.ndarray:
    """(K, N) server-device distances, chunked along the device axis (the
    chunking never changes an element's arithmetic)."""
    srv_xy = np.asarray(srv_xy, dtype=float)
    dev_xy = np.asarray(dev_xy, dtype=float)
    k, n = srv_xy.shape[0], dev_xy.shape[0]
    out = np.empty((k, n), dtype=np.float64)
    for lo in range(0, max(n, 1), chunk):
        sl = slice(lo, min(lo + chunk, n))
        out[:, sl] = np.linalg.norm(
            srv_xy[:, None, :] - dev_xy[None, sl, :], axis=-1)
    return out


def channel_gain_from_distance(dist_m: np.ndarray) -> np.ndarray:
    """h = 10^(-PL/10), PL = 128.1 + 37.6 log10(d_km)."""
    d_km = np.maximum(dist_m, 1.0) / 1000.0
    pl_db = 128.1 + 37.6 * np.log10(d_km)
    return 10.0 ** (-pl_db / 10.0)


def make_scenario(n_devices: int, n_servers: int, *, seed: int = 0,
                  area_m: float = 500.0, reach_m: float = 10_000.0,
                  cap_slack: float | None = None,
                  lp: LearningParams | None = None,
                  device=None) -> Scenario:
    """Sample a random scenario with Table II parameters (devices and
    servers uniform in an ``area_m`` box; the default ``reach_m`` makes
    every server reachable, the paper's fully dense evaluation)."""
    rng = np.random.default_rng(seed)
    dev_xy = rng.uniform(0.0, area_m, size=(n_devices, 2))
    srv_xy = rng.uniform(0.0, area_m, size=(n_servers, 2))
    return _assemble(rng, dev_xy, srv_xy, reach_m, lp, cap_slack, device)


def make_large_scenario(n_devices: int, n_servers: int, *, seed: int = 0,
                        area_m: float | None = None,
                        reach_m: float | None = None,
                        spread_m: float = 120.0,
                        cap_slack: float | None = None,
                        lp: LearningParams | None = None,
                        device=None) -> Scenario:
    """Cluster-structured scenario: the area grows with the server count,
    devices drop as Gaussian clusters of width ``spread_m`` around a random
    anchor server, and ``reach_m`` defaults to a restricted radius so
    availability is sparse (every device still reaches its nearest server).
    """
    rng = np.random.default_rng(seed)
    area = area_m if area_m is not None else 500.0 * np.sqrt(n_servers / 5.0)
    reach = reach_m if reach_m is not None else 3.0 * spread_m
    srv_xy = rng.uniform(0.0, area, size=(n_servers, 2))
    anchor = rng.integers(0, n_servers, n_devices)
    dev_xy = np.clip(srv_xy[anchor]
                     + rng.normal(0.0, spread_m, size=(n_devices, 2)),
                     0.0, area)
    return _assemble(rng, dev_xy, srv_xy, reach, lp, cap_slack, device)


def _capacities(dist: np.ndarray, cap_slack: float) -> np.ndarray:
    """Per-edge ``max_devices``: ``max(1, ceil(cap_slack * nearest count))``.
    Consumes no rng draws."""
    if cap_slack <= 0.0:
        raise ValueError(f"cap_slack must be > 0, got {cap_slack}")
    nearest_count = np.bincount(np.argmin(dist, axis=0),
                                minlength=dist.shape[0])
    return np.maximum(1, np.ceil(cap_slack * nearest_count)).astype(np.int32)


def _assemble(rng: np.random.Generator, dev_xy: np.ndarray,
              srv_xy: np.ndarray, reach_m: float,
              lp: LearningParams | None,
              cap_slack: float | None = None, device=None) -> Scenario:
    """Draw Table II device/server parameters for given node positions."""
    dev_t = resolve_device(device)
    f32 = np.float32
    n_devices = dev_xy.shape[0]
    n_servers = srv_xy.shape[0]
    dist = pairwise_dist(srv_xy, dev_xy)

    data_bits = rng.uniform(5e6, 10e6, n_devices) * 8.0          # 5-10 MB
    density = rng.uniform(30.0, 100.0, n_devices)                # cycle/bit
    samples = np.floor(rng.pareto(2.0, n_devices) * 200 + 50)

    # one channel gain per device, to its geometrically nearest server
    nearest = np.argmin(dist, axis=0)
    h = channel_gain_from_distance(dist[nearest, np.arange(n_devices)])
    h *= rng.lognormal(0.0, 0.5, n_devices)                      # shadowing

    def t(x):
        return torch.as_tensor(np.asarray(x, f32), dtype=DTYPE,
                               device=dev_t)

    dev = DeviceParams(
        cycles_per_iter=t(density * data_bits),
        data_samples=t(samples),
        model_nats=t(np.full(n_devices, 25_000.0)),
        tx_power=t(np.full(n_devices, 0.2)),
        channel_gain=t(h),
        alpha=t(np.full(n_devices, 2e-28)),
        f_min=t(np.full(n_devices, 1e9)),
        f_max=t(np.full(n_devices, 10e9)),
    )
    srv = ServerParams(
        bandwidth=t(np.full(n_servers, 10e6)),
        noise=t(np.full(n_servers, 1e-8)),
        cloud_rate=t(rng.uniform(0.5e5, 1.5e5, n_servers)),
        cloud_power=t(np.full(n_servers, 1.0)),
        cloud_nats=t(np.full(n_servers, 25_000.0)),
    )
    avail = dist <= reach_m
    # constraint (17e): every device must be associable somewhere
    unreachable = ~avail.any(axis=0)
    avail[nearest[unreachable], unreachable] = True

    return Scenario(dev=dev, srv=srv, avail=avail, dist=dist,
                    lp=lp or LearningParams(),
                    dev_xy=dev_xy.copy(), srv_xy=srv_xy.copy(),
                    reach_m=float(reach_m),
                    max_devices=(None if cap_slack is None
                                 else _capacities(dist, cap_slack)))
