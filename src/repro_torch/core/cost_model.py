"""HFEL cost model — paper eqs. (1)-(18), in PyTorch.

Port of ``repro.core.cost_model``. Parameters are frozen dataclasses of
float32 tensors (on one device) instead of JAX pytrees; every function is
the reference's arithmetic in the same order. Units as in the reference:
seconds, joules, nats/second, nats, Hz.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LearningParams:
    """Learning-task constants (paper §II.A)."""

    theta: float = 0.5          # local accuracy
    epsilon: float = 0.1        # edge accuracy
    mu: float = 14.4            # local-iteration constant (=> L ≈ 10)
    delta: float = 2.17         # edge-iteration constant  (=> I ≈ 10)
    lambda_e: float = 0.5       # energy weight  (eq. 17)
    lambda_t: float = 0.5       # delay weight   (eq. 17)

    @property
    def local_iters(self) -> float:
        return self.mu * math.log(1.0 / self.theta)

    @property
    def edge_iters(self) -> float:
        return self.delta * math.log(1.0 / self.epsilon) / (1.0 - self.theta)


def _map_tensors(obj, fn):
    """Apply ``fn`` to every tensor field of a dataclass of tensors."""
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


@dataclass(frozen=True)
class DeviceParams:
    """Per-device physical parameters; every field is a (N,) tensor."""

    cycles_per_iter: torch.Tensor   # c_n * |D_n|
    data_samples: torch.Tensor      # |D_n|
    model_nats: torch.Tensor        # d_n
    tx_power: torch.Tensor          # p_n (W)
    channel_gain: torch.Tensor      # h_n
    alpha: torch.Tensor             # alpha_n (F)
    f_min: torch.Tensor             # Hz
    f_max: torch.Tensor             # Hz

    @property
    def n_devices(self) -> int:
        return int(self.cycles_per_iter.shape[0])

    def take(self, idx) -> "DeviceParams":
        """The parameters of the devices ``idx`` (an index tensor)."""
        return _map_tensors(self, lambda x: x[idx])


@dataclass(frozen=True)
class ServerParams:
    """Per-edge-server parameters; every field is a (K,) tensor."""

    bandwidth: torch.Tensor         # B_i (Hz)
    noise: torch.Tensor             # N_0 (W)
    cloud_rate: torch.Tensor        # r_i (nats/s)
    cloud_power: torch.Tensor       # p_i (W)
    cloud_nats: torch.Tensor        # d_i (nats)

    @property
    def n_servers(self) -> int:
        return int(self.bandwidth.shape[0])


# ---------------------------------------------------------------------------
# Primitive overheads, eqs. (3)-(7)
# ---------------------------------------------------------------------------

def spectral_efficiency(dev: DeviceParams, noise) -> torch.Tensor:
    """ln(1 + h_n p_n / N_0) (eq. 5)."""
    return torch.log1p(dev.channel_gain * dev.tx_power / noise)


def tx_rate(beta, bandwidth, dev: DeviceParams, noise) -> torch.Tensor:
    """r_n = beta * B_i * ln(1 + h p / N0)  (eq. 5)."""
    return beta * bandwidth * spectral_efficiency(dev, noise)


def comp_time(dev: DeviceParams, f, lp: LearningParams) -> torch.Tensor:
    """t^cmp_n — eq. (3)."""
    return lp.local_iters * dev.cycles_per_iter / f


def comp_energy(dev: DeviceParams, f, lp: LearningParams) -> torch.Tensor:
    """e^cmp_n — eq. (4)."""
    return lp.local_iters * 0.5 * dev.alpha * torch.square(f) \
        * dev.cycles_per_iter


def comm_time(dev: DeviceParams, beta, bandwidth, noise) -> torch.Tensor:
    """t^com_{i:n} — eq. (6)."""
    return dev.model_nats / tx_rate(beta, bandwidth, dev, noise)


def comm_energy(dev: DeviceParams, beta, bandwidth, noise) -> torch.Tensor:
    """e^com_{i:n} — eq. (7)."""
    return comm_time(dev, beta, bandwidth, noise) * dev.tx_power


# ---------------------------------------------------------------------------
# Edge-level aggregation overheads, eqs. (10)-(11)
# ---------------------------------------------------------------------------

def edge_energy(dev: DeviceParams, mask, f, beta, bandwidth, noise,
                lp: LearningParams) -> torch.Tensor:
    """E^edge_{S_i} — eq. (10); ``mask`` selects S_i out of all devices
    (masked sum over the last axis)."""
    per_dev = comm_energy(dev, beta, bandwidth, noise) + comp_energy(dev, f, lp)
    return lp.edge_iters * torch.where(mask, per_dev,
                                       per_dev.new_zeros(())).sum(-1)


def edge_delay(dev: DeviceParams, mask, f, beta, bandwidth, noise,
               lp: LearningParams) -> torch.Tensor:
    """T^edge_{S_i} — eq. (11): I * max_n (t^com + t^cmp)."""
    per_dev = comm_time(dev, beta, bandwidth, noise) + comp_time(dev, f, lp)
    return lp.edge_iters * torch.where(mask, per_dev,
                                       per_dev.new_zeros(())).amax(-1)


def edge_cost(dev: DeviceParams, mask, f, beta, bandwidth, noise,
              lp: LearningParams) -> torch.Tensor:
    """C_i = lambda_e E^edge + lambda_t T^edge — the objective of (18)."""
    e = edge_energy(dev, mask, f, beta, bandwidth, noise, lp)
    t = edge_delay(dev, mask, f, beta, bandwidth, noise, lp)
    return lp.lambda_e * e + lp.lambda_t * t


# ---------------------------------------------------------------------------
# Cloud aggregation overheads, eqs. (12)-(16), and global objective (17)
# ---------------------------------------------------------------------------

def cloud_delay(srv: ServerParams) -> torch.Tensor:
    """T^cloud_i — eq. (12); shape (K,)."""
    return srv.cloud_nats / srv.cloud_rate


def cloud_energy(srv: ServerParams) -> torch.Tensor:
    """E^cloud_i — eq. (13); shape (K,)."""
    return srv.cloud_power * cloud_delay(srv)


def global_cost(dev: DeviceParams, srv: ServerParams, assignment, f, beta,
                lp: LearningParams):
    """System cost of one global iteration — eqs. (15)-(17).

    ``assignment`` (N,) int64 device -> server; ``f``/``beta`` (N,).
    Returns 0-dim tensors ``(E, T, cost)``.
    """
    k = srv.n_servers
    masks = torch.nn.functional.one_hot(assignment, k).T.bool()  # (K, N)
    bw = srv.bandwidth[assignment]
    n0 = srv.noise[assignment]

    per_dev_e = comm_energy(dev, beta, bw, n0) + comp_energy(dev, f, lp)
    per_dev_t = comm_time(dev, beta, bw, n0) + comp_time(dev, f, lp)

    zero = per_dev_e.new_zeros(())
    e_edge = lp.edge_iters * torch.where(masks, per_dev_e[None, :],
                                         zero).sum(dim=1)
    t_edge = lp.edge_iters * torch.where(masks, per_dev_t[None, :],
                                         zero).amax(dim=1)

    energy = torch.sum(e_edge + cloud_energy(srv))                  # eq. (15)
    delay = torch.max(t_edge + cloud_delay(srv))                    # eq. (16)
    return energy, delay, lp.lambda_e * energy + lp.lambda_t * delay


# ---------------------------------------------------------------------------
# Section-III constants (A_n, B_n, D_n, E_n, W) for problem (18)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RAConstants:
    """Constants of problem (18). Fields share a leading shape ``(..., N)``
    except ``w``, which has the leading shape ``(...)`` alone.

      a = lambda_e I d_n p_n / (B_i ln(1 + h p/N0))
      b = lambda_e I L (alpha/2) c_n |D_n|
      d = d_n / (B_i ln(1 + h p/N0))
      e = L c_n |D_n|
      w = lambda_t I
    """

    a: torch.Tensor
    b: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor
    w: torch.Tensor
    f_min: torch.Tensor
    f_max: torch.Tensor

    def rows(self, idx) -> "RAConstants":
        """Index the leading axis of every field (a batch of groups)."""
        return _map_tensors(self, lambda x: x[idx])


def ra_constants(dev: DeviceParams, bandwidth, noise,
                 lp: LearningParams) -> RAConstants:
    """Section-III constants. ``bandwidth``/``noise`` are one server's
    scalars, or ``(K, 1)`` columns for every server at once (fields then
    come out ``(K, N)`` and ``w`` ``(K,)``)."""
    eff = bandwidth * spectral_efficiency(dev, noise)   # B_i ln(1+hp/N0)
    i_it = lp.edge_iters
    l_it = lp.local_iters
    b = lp.lambda_e * i_it * l_it * 0.5 * dev.alpha * dev.cycles_per_iter
    e = l_it * dev.cycles_per_iter
    shape = eff.shape
    return RAConstants(
        a=lp.lambda_e * i_it * dev.model_nats * dev.tx_power / eff,
        b=b.expand(shape),
        d=dev.model_nats / eff,
        e=e.expand(shape),
        w=torch.full(shape[:-1], lp.lambda_t * i_it, dtype=eff.dtype,
                     device=eff.device),
        f_min=dev.f_min.expand(shape),
        f_max=dev.f_max.expand(shape),
    )


def ra_objective(c: RAConstants, mask, f, beta) -> torch.Tensor:
    """Objective of problem (18) given the constants (masked sum/max over
    the last axis)."""
    per_sum = c.a / beta + c.b * torch.square(f)
    per_max = c.d / beta + c.e / f
    zero = per_sum.new_zeros(())
    return (torch.where(mask, per_sum, zero).sum(-1)
            + c.w * torch.where(mask, per_max, zero).amax(-1))
