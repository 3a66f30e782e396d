"""The paper's own learning task (§V): multinomial logistic regression /
small MLP over MNIST-like federated data, trained full-batch.

This config drives the FL simulation stack (``repro_torch.fl``), not an
LM: use ``repro_torch.fl.train_federated``. A copy of
``repro.configs.paper_mnist``.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class PaperTaskConfig:
    model: str = "mlr"            # "mlr" (paper's convex task) or "mlp"
    dataset: str = "mnist"        # "mnist" (10-way) or "femnist" (62-way)
    n_devices: int = 30
    n_servers: int = 5
    local_iters: int = 10         # L(theta)
    edge_iters: int = 5           # I(eps, theta)
    global_rounds: int = 1000     # paper's §V.B budget
    lr: float = 1e-4              # paper Table II learning rate


CONFIG = PaperTaskConfig()
