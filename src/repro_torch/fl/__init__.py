from repro_torch.fl.fl_model import (MODELS, accuracy, masked_loss, mlp_init,
                                     mlr_init)
from repro_torch.fl.training import (FederatedTrainer, TrainHistory,
                                     train_federated)
from repro_torch.fl.live import (DEFAULT_CHURN, POLICIES, LiveHFELRunner,
                                 LiveHistory, run_live)

__all__ = ["MODELS", "accuracy", "masked_loss", "mlr_init", "mlp_init",
           "FederatedTrainer", "TrainHistory", "train_federated",
           "DEFAULT_CHURN", "POLICIES", "LiveHFELRunner", "LiveHistory",
           "run_live"]
