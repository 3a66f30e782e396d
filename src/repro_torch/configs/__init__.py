"""Configurations of the port: the paper's own FL task and the model zoo's
architecture registry (port of ``repro.configs``).

``get_config(name)`` accepts either the registry id (``qwen3-0.6b``) or the
module name (``qwen3_0p6b``). Every architecture of the JAX package's
registry is here as data: dense, MoE (kimi-k2; deepseek-v2-lite with MLA),
SSM (mamba2), hybrid (zamba2), VLM (internvl2) and encoder-decoder
(whisper).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.paper_mnist import CONFIG, PaperTaskConfig
from repro_torch.models.config import ModelConfig

_MODULES = {
    "whisper-large-v3": "whisper_large_v3",
    "olmo-1b": "olmo_1b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-0.6b": "qwen3_0p6b",
    "qwen3-32b": "qwen3_32b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "internvl2-1b": "internvl2_1b",
    "mamba2-1.3b": "mamba2_1p3b",
    "zamba2-2.7b": "zamba2_2p7b",
}

ARCH_IDS = tuple(_MODULES)

# architectures of the registry the port does not run: none
NOT_PORTED: dict[str, str] = {}


def get_config(name: str) -> ModelConfig:
    module_name = _MODULES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{module_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    """Every architecture of the registry, by registry id."""
    return {arch: get_config(arch) for arch in ARCH_IDS}


__all__ = ["ARCH_IDS", "CONFIG", "NOT_PORTED", "PaperTaskConfig",
           "all_configs", "get_config"]
