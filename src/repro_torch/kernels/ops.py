"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``).

Dispatch is by the tensors' device, inside each wrapper: CPU tensors take
the plain PyTorch version, CUDA tensors launch the hand-written kernel or
raise.
"""

from repro_torch.kernels.golden_section import golden_section_solve

__all__ = ["golden_section_solve"]
