"""Host-sync sentinel: capture what makes the host wait for the card.
Port of ``repro.analysis.recompile``.

The JAX package's sentinel counts XLA compilations, because a jitted
program that recompiles pays seconds a call. The eager port compiles
nothing but its kernels, each once per source and flags
(``kernels/build.py``; :class:`CompileLog` records those builds). What
recurs in an eager hot loop instead is the host sync: a read of a card
tensor's value on the host (``.item()``, ``int()``, ``.tolist()``,
``.cpu()``) waits for every launch queued before it. :class:`SyncLog` is a
dispatch mode that records one event per ``aten._local_scalar_dense`` (a
scalar read) and per copy from a CUDA tensor to the host; a CPU tensor's
``.tolist()`` and ``.numpy()`` dispatch no operator, so the log also
records those calls, under their own names. A test fixes the budget of a
cold -> churn -> warm cycle with it, as the JAX package's
``tests/test_recompile_sentinel.py`` fixes the compile budget.
"""

from __future__ import annotations

from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class SyncLog(TorchDispatchMode):
    """Context manager recording one entry per host sync.

    >>> with SyncLog() as log:
    ...     run_cold()
    ...     log.reset()
    ...     run_warm_again()
    ...     assert log.count() == budget
    """

    def __init__(self):
        super().__init__()
        self.events: list[str] = []
        self._patched: dict = {}
        self._inside = 0

    def __enter__(self) -> "SyncLog":
        for name in ("tolist", "numpy"):
            orig = getattr(torch.Tensor, name)
            self._patched[name] = orig

            def wrapped(t, *a, _orig=orig, _name=name, **kw):
                self.events.append(f"{_name}:{t.device.type}")
                self._inside += 1
                try:
                    return _orig(t, *a, **kw)
                finally:
                    self._inside -= 1

            setattr(torch.Tensor, name, wrapped)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        for name, orig in self._patched.items():
            setattr(torch.Tensor, name, orig)
        self._patched.clear()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._inside:
            if func is torch.ops.aten._local_scalar_dense.default:
                self.events.append(f"item:{args[0].device.type}")
            elif func in (torch.ops.aten._to_copy.default,
                          torch.ops.aten.copy_.default):
                src = args[1] if func is torch.ops.aten.copy_.default \
                    else args[0]
                dst = (args[0].device if func is torch.ops.aten.copy_.default
                       else kwargs.get("device"))
                if src.device.type == "cuda" and dst is not None and \
                        torch.device(dst).type == "cpu":
                    self.events.append("to_host:cuda")
        return func(*args, **kwargs)

    def reset(self) -> None:
        self.events.clear()

    def count(self) -> int:
        return len(self.events)

    def kinds(self) -> Counter:
        """Syncs by kind: "item", "tolist", "numpy", "to_host"."""
        return Counter(e.split(":")[0] for e in self.events)


class CompileLog:
    """Context manager recording one entry per kernel build (an ``nvcc``
    run of ``kernels/build.load``; a library already on disk or loaded is
    no event)."""

    def __init__(self):
        self.events: list[str] = []
        self._orig = None

    def __enter__(self) -> "CompileLog":
        from repro_torch.kernels import build
        self._orig = orig = build.load

        def load(name, defines=()):
            built = orig(name, defines)
            if built.seconds > 0.0:
                self.events.append(name)
            return built

        build.load = load
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import build
        build.load = self._orig

    def reset(self) -> None:
        self.events.clear()
