"""Synthetic federated classification datasets matching the paper's §V.B
protocol.

Port of ``repro.data.federated``: the same numpy code, line for line, so
every field is bit-identical to the JAX package's dataset for the same
arguments. The arrays stay in numpy; the trainer moves them to its device.

The datasets: MNIST-like (10 classes) and FEMNIST-like (62 classes),
partitioned non-IID — each client holds only ``labels_per_client`` labels,
with power-law sample counts (per [20] Li et al.). 75/25 train/test split.

No external downloads: inputs are drawn from per-class
Gaussian prototypes with within-class structure, which preserves everything
the paper's experiments measure (relative convergence of HFEL vs FedAvg
under non-IID client skew), if not absolute MNIST accuracy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FederatedDataset:
    client_x: np.ndarray      # (N_clients, max_samples, dim) padded
    client_y: np.ndarray      # (N_clients, max_samples) int, -1 = pad
    client_sizes: np.ndarray  # (N_clients,)
    test_x: np.ndarray
    test_y: np.ndarray
    n_classes: int

    @property
    def n_clients(self) -> int:
        return self.client_x.shape[0]

    @property
    def dim(self) -> int:
        return self.client_x.shape[-1]


def partition_power_law(n_total: int, n_clients: int, *, alpha: float = 2.0,
                        min_size: int = 20, rng=None) -> np.ndarray:
    """Power-law client sample counts summing to ~n_total."""
    rng = rng or np.random.default_rng(0)
    raw = rng.pareto(alpha, n_clients) + 1.0
    sizes = np.maximum((raw / raw.sum() * n_total).astype(int), min_size)
    return sizes


def _make_classification(n_clients: int, n_classes: int, dim: int, *,
                         labels_per_client: int, samples_total: int,
                         class_sep: float, seed: int) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, (n_classes, dim)) * class_sep / np.sqrt(dim)
    # shared within-class covariance structure + heavy isotropic overlap
    mix = rng.normal(0.0, 1.0, (dim, dim)) / np.sqrt(dim)

    def sample(cls, n):
        z = rng.normal(0.0, 1.0, (n, dim))
        return (protos[cls][None, :] + z @ mix).astype(np.float32)

    sizes = partition_power_law(samples_total, n_clients, rng=rng)
    max_size = int(sizes.max())
    cx = np.zeros((n_clients, max_size, dim), np.float32)
    cy = np.full((n_clients, max_size), -1, np.int32)
    for c in range(n_clients):
        labels = rng.choice(n_classes, labels_per_client, replace=False)
        per = np.array_split(np.arange(sizes[c]), labels_per_client)
        for lbl, idx in zip(labels, per):
            cx[c, idx] = sample(lbl, len(idx))
            cy[c, idx] = lbl

    n_test = max(samples_total // 4, n_classes * 20)
    ty = rng.integers(0, n_classes, n_test).astype(np.int32)
    tx = np.concatenate([sample(int(l), 1) for l in ty], axis=0)
    return FederatedDataset(cx, cy, sizes.astype(np.float32), tx, ty,
                            n_classes)


def make_mnist_like(n_clients: int = 30, *, dim: int = 64,
                    samples_total: int = 6000, seed: int = 0) -> FederatedDataset:
    """10 classes, 2 labels per client (the paper's MNIST protocol)."""
    return _make_classification(n_clients, 10, dim, labels_per_client=2,
                                samples_total=samples_total, class_sep=2.0,
                                seed=seed)


def make_femnist_like(n_clients: int = 30, *, dim: int = 64,
                      samples_total: int = 9000, seed: int = 0) -> FederatedDataset:
    """62 classes, 8 labels per client (FEMNIST-flavoured heterogeneity)."""
    return _make_classification(n_clients, 62, dim, labels_per_client=8,
                                samples_total=samples_total, class_sep=2.5,
                                seed=seed)
