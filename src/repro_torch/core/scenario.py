"""Random HFEL scenario generation following the paper's Table II.

Port of ``repro.core.scenario`` (static scenarios). The draws are the
reference's numpy code, line for line, with ``numpy.random.default_rng``,
so every field is bit-identical to the JAX package's scenario for the same
arguments. Geometry (``avail``, ``dist``, positions) stays in numpy on the
host; the device and server parameters become float32 tensors on the
scenario's device. Reach maps and churn are not ported yet.

Table II: edge bandwidth 10 MHz, transmit power 200 mW, CPU frequency
[1, 10] GHz, processing density [30, 100] cycle/bit, noise 1e-8 W, training
size [5, 10] MB, model size 25000 nats, capacitance 2e-28.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import DTYPE, resolve_device
from repro_torch.core.cost_model import (DeviceParams, LearningParams,
                                         ServerParams)


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
