from repro_torch.fl.fl_model import (MODELS, accuracy, masked_loss, mlp_init,
                                     mlr_init)
from repro_torch.fl.training import (FederatedTrainer, TrainHistory,
                                     train_federated)

__all__ = ["MODELS", "accuracy", "masked_loss", "mlr_init", "mlp_init",
           "FederatedTrainer", "TrainHistory", "train_federated"]
