"""PyTorch + CUDA port of the HFEL reproduction (``repro``).

Module and public names mirror ``repro`` so every counterpart is easy to
find. The port never imports ``jax`` or ``repro``; only the parity tests
import both.

Device policy: every entry point takes ``device=None``, which means
``"cuda"``. Without a card that raises — there is no silent CPU fallback.
The CPU runs only when the caller asks for it (``device="cpu"``), as the
CPU tests do. All arithmetic is float32, like the reference.
"""

from __future__ import annotations

import torch

DTYPE = torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for and no
    card is present. ``"cpu"`` is honoured only when passed explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
