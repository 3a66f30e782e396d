from repro_torch.models.config import (MLAConfig, MoEConfig, ModelConfig,
                                       SSMConfig)
from repro_torch.models.model import (SHAPES, Model, ShapeDtype, ShapeSpec,
                                      build_model, shape_applicable)

__all__ = ["MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig", "Model",
           "ShapeDtype", "ShapeSpec", "SHAPES", "build_model",
           "shape_applicable"]
