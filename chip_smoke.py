#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``. It imports the port (``src/repro_torch``) and nothing of JAX,
and exits non-zero if any phase fails. Each phase prints one JSON line:

1. ``card``: device name and count, and the ``nvidia-smi`` name and power
   limit (also printed raw on a line of its own).
2. ``build``: builds every kernel of the main path with ``nvcc`` from the
   checkout's sources (and the cbrtf variant of phase 3b), all at once;
   build seconds and the ptxas register/spill report.
3. ``kernel``: each kernel against its plain PyTorch version on the same
   card tensors, at the main path's shapes and at ragged ones, with the
   stated tolerance; kernel and plain times (CUDA events), the operation
   and byte counts, the bound they give and the kernel's share of it.
3b. ``design``: the golden-section kernel built with ``cbrtf`` instead of
   the double cube root, at the main shape: its time, and how many groups
   leave the pin against the plain version (reported, not asserted).
4. ``main_path``: ``make_scenario(1000, 20)`` and the dense transfer-only
   association engine to a stable point on the card, with the kernel's
   launch count read around exactly this run.
5. ``card_vs_cpu``: the engine on the card and on the CPU (plain version)
   land on the same stable point for ``make_scenario(60, 5)``.

Then a ``kernels`` line, the raw ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

PIN_RTOL = 2e-4          # cost, deadline, f (tests/test_assoc_sharded.py)
BETA_ATOL = 1e-7
FLIP_COST_RTOL = 2e-2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_report(log: str) -> dict:
    """Registers and spills per kernel instantiation, from nvcc -Xptxas -v
    (templates <NT, IT>: threads per block, slots per thread)."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            t = re.search(r"ILi(\d+)ELi(\d+)E", entry.group(1))
            name = f"NT={t.group(1)},IT={t.group(2)}" if t else entry.group(1)
            out[name] = []
        elif name and re.search(r"registers|spill", line):
            out[name].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def golden_section_work(mask, n_golden: int, n_inner: int, n_bracket: int):
    """Operations and bytes that one golden-section solve of these groups
    needs, counted from the kernel's loops (each add, multiply, divide,
    max/min, sqrt and cbrt is one operation; selects are free). Operations
    count the active slots only: a masked slot's outputs are constants
    (f_min, beta 0) and need no arithmetic, though the kernel does it.
    Bytes count every input read once and every output written once.
    ``mask`` (G, R); returns (operations, bytes, active slots)."""
    g, r = mask.shape
    active = int(mask.sum())
    beta_of_f = 13                         # tau (6), score (3), sum, norm
    step = beta_of_f + 7                   # + slack, f update, clip
    objective = 9
    fb = 2 + n_inner * step + beta_of_f
    per_slot = (8 + 10 * n_bracket                      # bracket
                + (2 + n_golden) * (fb + objective) + fb  # golden section
                + 5 + objective)                        # finalize
    nbytes = g * r * (6 * 4 + 1) + g * 4 + g * r * 2 * 4 + g * 2 * 4
    return per_slot * active, nbytes, active


def bound_ms(ops: int, nbytes: int) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def outside_pin(got, want):
    """Indices of the groups where ``got`` and ``want`` differ beyond the
    pin (cost, deadline, f at rtol 2e-4; beta also atol 1e-7)."""
    import numpy as np
    gf, gb, gc, gd = (x.double().cpu().numpy() for x in got)
    wf, wb, wc, wd = (x.double().cpu().numpy() for x in want)
    return np.flatnonzero(
        ~np.isclose(gc, wc, rtol=PIN_RTOL, atol=0)
        | ~np.isclose(gd, wd, rtol=PIN_RTOL, atol=0)
        | ~np.isclose(gf, wf, rtol=PIN_RTOL, atol=0).all(1)
        | ~np.isclose(gb, wb, rtol=PIN_RTOL, atol=BETA_ATOL).all(1))


def check_pin(got, want, f_min, f_max, mask) -> dict:
    """The CPU tests' rule: every group within the pin except at most one
    flipped group, which must be feasible on both sides with costs within
    2e-2. Raises on a breach; returns the error summary."""
    import numpy as np
    gf, gb, gc, gd = (x.double().cpu().numpy() for x in got)
    wf, wb, wc, wd = (x.double().cpu().numpy() for x in want)
    lo, hi = f_min.double().cpu().numpy(), f_max.double().cpu().numpy()
    m = mask.cpu().numpy()
    flipped = outside_pin(got, want)
    if flipped.size > 1:
        raise AssertionError(f"groups {flipped.tolist()} outside the pin")
    for g in flipped:
        for f, beta in ((gf[g], gb[g]), (wf[g], wb[g])):
            if not (beta[m[g]].sum() <= 1 + 1e-5
                    and (f[m[g]] >= lo[g][m[g]] * (1 - 1e-6)).all()
                    and (f[m[g]] <= hi[g][m[g]] * (1 + 1e-6)).all()):
                raise AssertionError(f"flipped group {g} is infeasible")
        if abs(gc[g] - wc[g]) > FLIP_COST_RTOL * abs(wc[g]):
            raise AssertionError(f"flipped group {g}: cost {gc[g]} vs "
                                 f"{wc[g]}")
    for x in (gf, gb, gc, gd):
        if not np.isfinite(x).all():
            raise AssertionError("kernel output is not finite")
    rel = np.abs(gc - wc) / np.maximum(np.abs(wc), 1e-30)
    return {"flipped": flipped.tolist(),
            "max_abs_err_cost": float(np.abs(gc - wc).max()),
            "max_rel_err_cost": float(rel.max()),
            "max_rel_err_f": float((np.abs(gf - wf) / wf).max())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import resource_allocation as ra
    from repro_torch.core.assoc_fast import FastAssociationEngine
    from repro_torch.core.cost_model import RAConstants
    from repro_torch.core.edge_association import (GroupSolver,
                                                   initial_assignment)
    from repro_torch.core.scenario import make_scenario
    from repro_torch.kernels import build, golden_section, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card ----
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("card", name=name, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build the main path's kernels and the variant, all at once ----
    variants = {"golden_section": (), "golden_section_cbrtf": ("GS_CBRT_F32",)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda defines: build.load("golden_section", defines),
            variants.values())))
    build_s = time.perf_counter() - t0
    for kname, b in built.items():
        emit("build", kernel=kname, seconds=build_s, nvcc_seconds=b.seconds,
             library=str(b.path.relative_to(ROOT)),
             ptxas=ptxas_report(b.ptxas_log))

    # ---- 3. kernel vs plain version on the card ----
    dev = torch.device("cuda")
    main_sc = make_scenario(1000, 20, seed=0)
    solver = GroupSolver(main_sc)
    n = main_sc.n_devices
    start = initial_assignment(main_sc, main_sc.eff_avail,
                               np.random.default_rng(0))
    # the main path's first batch: server 0's group and its N toggles
    base = torch.as_tensor(start == 0, device=dev)[None]
    masks = torch.cat([base, base ^ torch.eye(n, dtype=torch.bool,
                                              device=dev)])
    c = solver.consts.rows(torch.zeros(n + 1, dtype=torch.int64, device=dev))
    main_in = [x.contiguous() for x in (c.a, c.b, c.d, c.e, c.w, c.f_min,
                                        c.f_max)] + [masks]
    iters = ra.SCREEN_PROFILES["default"]
    got = golden_section.golden_section_solve(*main_in, **iters)
    torch.cuda.synchronize()
    want = ref.golden_section_ref(*main_in, **iters)
    err = check_pin(got, want, main_in[5], main_in[6], masks)
    k_ms = cuda_ms(lambda: golden_section.golden_section_solve(
        *main_in, **iters), reps=20)
    p_ms = cuda_ms(lambda: ref.golden_section_ref(*main_in, **iters),
                   reps=3)
    ops, nbytes, active = golden_section_work(masks, **iters)
    b_ms, b_by = bound_ms(ops, nbytes)
    emit("kernel", kernel="golden_section", shape=list(masks.shape),
         profile="default", ms=k_ms, plain_ms=p_ms, operations=ops,
         bytes=nbytes, active_slots=active,
         active_share=active / masks.numel(), bound_ms=b_ms, bound_by=b_by,
         bound_share=b_ms / k_ms, library_ms=None, **err)
    main_kernel = dict(max_abs_err=err["max_abs_err_cost"], ms=k_ms,
                       plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)

    # ---- 3b. the cbrtf variant at the main shape (not on the main path) ----
    cbrtf = variants["golden_section_cbrtf"]
    got = golden_section.launch(main_in, defines=cbrtf, **iters)
    torch.cuda.synchronize()
    v_ms = cuda_ms(lambda: golden_section.launch(main_in, defines=cbrtf,
                                                 **iters), reps=20)
    v_out = outside_pin(got, want)
    emit("design", kernel="golden_section", variant="cbrtf",
         shape=list(masks.shape), profile="default", ms=v_ms,
         ms_double_cbrt=k_ms, groups_outside_pin=int(v_out.size),
         max_rel_err_cost=float(((got[2] - want[2]).abs()
                                 / want[2].abs().clamp_min(1e-30)).max()))

    # ragged: G=5, R=37, group 0 a singleton and group 1 empty
    g, r = 5, 37
    sc_small = make_scenario(r, 2, seed=2)
    cs = GroupSolver(sc_small).consts
    rng = np.random.default_rng(15)
    scale = torch.tensor(rng.uniform(0.7, 1.3, (g, 1)).astype(np.float32),
                         device=dev)
    rag = RAConstants(**{k: (v[0] * scale if k != "w" else v[0].expand(g))
                         for k, v in vars(cs).items()})
    rmask = torch.tensor(rng.uniform(size=(g, r)) < 0.7, device=dev)
    rmask[0] = torch.arange(r, device=dev) == 0
    rmask[1] = False
    rag_in = [x.contiguous() for x in (rag.a, rag.b, rag.d, rag.e, rag.w,
                                       rag.f_min, rag.f_max)] + [rmask]
    for profile, it in ra.SCREEN_PROFILES.items():
        got = golden_section.golden_section_solve(*rag_in, **it)
        torch.cuda.synchronize()
        want = ref.golden_section_ref(*rag_in, **it)
        err = check_pin(got, want, rag_in[5], rag_in[6], rmask)
        if got[2][1].item() != 0.0:
            raise AssertionError("empty group must cost 0")
        emit("kernel", kernel="golden_section", shape=[g, r],
             profile=profile, **err)

    # ---- 4. the main path on the card ----
    golden_section.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = FastAssociationEngine(main_sc)
    res = eng.run("nearest", exchange_samples=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = golden_section.LAUNCHES
    moves = res.n_adjustments
    k = main_sc.n_servers
    trace = np.asarray(res.cost_trace)
    emit("main_path", n_devices=n, n_servers=k, moves=moves,
         first_cost=float(trace[0]), last_cost=float(trace[-1]),
         total_cost=res.total_cost, true_cost=res.true_cost,
         init_s=eng.last_timing["init_s"],
         ms_per_move=(1e3 * eng.last_timing["moves_s"] / max(moves, 1)),
         total_s=total_s,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, launches_expected=k + 2 * moves + 1)
    if launches != k + 2 * moves + 1 or launches <= 0:
        raise AssertionError(f"{launches} launches, expected K + 2*moves + "
                             f"1 = {k + 2 * moves + 1}")
    if not (np.all(np.diff(trace) <= 0) and trace.shape == (moves + 1,)):
        raise AssertionError("cost trace is not monotone")
    if not (np.isfinite([res.total_cost, res.true_cost]).all()
            and res.assignment.shape == (n,)
            and np.isfinite(res.f).all() and np.isfinite(res.beta).all()
            and abs(res.total_cost - trace[-1]) <= 2e-4 * trace[-1]):
        raise AssertionError("main-path result is not finite or consistent")

    # ---- 5. card vs CPU on (60, 5, 0) ----
    sc60 = make_scenario(60, 5, seed=0, device="cpu")
    t0 = time.perf_counter()
    on_card = FastAssociationEngine(sc60).run("nearest", exchange_samples=0)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = FastAssociationEngine(sc60, device="cpu").run(
        "nearest", exchange_samples=0)
    cpu_s = time.perf_counter() - t0
    same = (np.array_equal(on_card.assignment, on_cpu.assignment)
            and on_card.n_adjustments == on_cpu.n_adjustments
            and math.isclose(on_card.total_cost, on_cpu.total_cost,
                             rel_tol=PIN_RTOL))
    emit("card_vs_cpu", fixture=[60, 5, 0], moves_card=on_card.n_adjustments,
         moves_cpu=on_cpu.n_adjustments, total_cost_card=on_card.total_cost,
         total_cost_cpu=on_cpu.total_cost, same_assignment=bool(np.array_equal(
             on_card.assignment, on_cpu.assignment)),
         card_s=card_s, cpu_s=cpu_s)
    if not same:
        raise AssertionError("card and CPU engines disagree on (60, 5, 0)")

    print(json.dumps({"kernels": [dict(
        name="golden_section", route="cuda",
        source="src/repro_torch/kernels/csrc/golden_section.cu",
        replaces="src/repro/kernels/golden_section.py:169",
        launches=launches, library_ms=None, **main_kernel)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
