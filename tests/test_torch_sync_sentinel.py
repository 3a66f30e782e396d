"""Host-sync sentinel: the dynamic half of the port's lint, the
counterpart of ``tests/test_recompile_sentinel.py``.

The eager port compiles nothing but its kernels; what recurs in its hot
loop is the host sync, a read of a tensor's value on the host, which on
the card waits for every queued launch. ``SyncLog``
(``repro_torch.analysis.recompile``) records each one around
``FastAssociationEngine`` cycles on the CPU.

Sync budget (the contract): a descent reads one value a round (the
round's best move and its index, in one ``tolist``; a round that finds no
permitted move also reads once, then stops), plus a fixed count at the
end of a run (the trace, and the stable point's membership, costs and
toggle cache copied to numpy). So a cold run, a churn tick and the warm
rerun each take ``rounds + FIXED_SYNCS`` syncs, whatever the space, and
an identical repeat cycle takes the same.
"""

import pytest
import torch

from repro_torch.analysis.recompile import CompileLog, SyncLog
from repro_torch.core.assoc_fast import FastAssociationEngine
from repro_torch.core.scenario import make_large_scenario, perturb_scenario

N, K = 16, 3
CHURN = dict(drift_m=60.0, move_frac=0.1, flip_frac=0.05, depart_frac=0.05)
FIXED_SYNCS = 4


def rounds(eng, max_moves: int) -> int:
    """Rounds the last descent ran: one a move, and one more that found
    nothing when it stopped before ``max_moves``."""
    return eng.last_moves + (eng.last_moves < max_moves)


def cycle(compact, max_moves: int) -> list:
    """cold run -> one churn tick -> warm incremental rerun: the syncs of
    the two descents, each with its rounds."""
    out = []
    with SyncLog() as log:
        sc = make_large_scenario(N, K, seed=0, device="cpu")
        eng = FastAssociationEngine(sc, kind="fast", seed=0,
                                    profile="coarse", rel_tol=1e-3,
                                    compact=compact, device="cpu")
        log.reset()
        eng.run("nearest", max_moves=max_moves, exchange_samples=0,
                finalize=False)
        out.append((log.count(), rounds(eng, max_moves), log.kinds()))
        sc2, delta = perturb_scenario(sc, seed=1, **CHURN)
        log.reset()
        eng.rerun_incremental(sc2, delta, max_moves=max_moves,
                              exchange_samples=0, finalize=False)
        out.append((log.count(), rounds(eng, max_moves), log.kinds()))
    return out


@pytest.mark.parametrize("compact", [False, True, "bucketed"],
                         ids=["dense", "flat", "bucketed"])
def test_cycle_sync_budget(compact):
    first = cycle(compact, max_moves=6)
    for syncs, n_rounds, kinds in first:
        assert syncs == n_rounds + FIXED_SYNCS, kinds
        assert "item" not in kinds       # no scalar read inside a round
    # an identical repeat cycle syncs exactly as often
    assert [(s, r) for s, r, _ in cycle(compact, max_moves=6)] == \
        [(s, r) for s, r, _ in first]


def test_more_moves_cost_one_sync_each():
    (s3, r3, _), _ = cycle(False, max_moves=3)
    assert r3 == 3
    (s6, r6, _), _ = cycle(False, max_moves=6)
    assert s6 - s3 == r6 - r3


def test_sync_log_sees_each_kind_of_read():
    x = torch.arange(4.0)
    with SyncLog() as log:
        x.sum().item()
        int(x[1])
        bool(x.sum() > 0)
        x.tolist()
        x.numpy()
        x.cpu()                          # a CPU tensor: no copy, no read
    assert log.kinds() == {"item": 3, "tolist": 1, "numpy": 1}
    assert x.tolist() == [0, 1, 2, 3] and log.count() == 5   # unpatched


def test_compile_log_records_builds_only(monkeypatch):
    from repro_torch.kernels import build
    calls = []

    def fake_load(name, defines=()):
        calls.append(name)
        return build.Built(lib=None, path=None,
                           seconds=1.0 if len(calls) == 1 else 0.0,
                           ptxas_log="")

    monkeypatch.setattr(build, "load", fake_load)
    with CompileLog() as log:
        build.load("rmsnorm")
        build.load("rmsnorm")           # already built: no event
    assert log.events == ["rmsnorm"]
    assert calls == ["rmsnorm", "rmsnorm"]
