from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup_cosine)

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "sgd", "constant", "cosine_decay", "linear_warmup_cosine"]
