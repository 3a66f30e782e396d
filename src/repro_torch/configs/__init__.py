"""Configurations of the port. Only the paper's own FL task so far; the LM
configurations come with the model zoo."""

from repro_torch.configs.paper_mnist import CONFIG, PaperTaskConfig

__all__ = ["CONFIG", "PaperTaskConfig"]
