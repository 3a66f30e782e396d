from repro_torch.data.federated import (FederatedDataset, make_femnist_like,
                                        make_mnist_like, partition_power_law)
from repro_torch.data.tokens import TokenPipeline

__all__ = ["FederatedDataset", "make_femnist_like", "make_mnist_like",
           "partition_power_law", "TokenPipeline"]
