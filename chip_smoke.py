#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``. It imports the port (``src/repro_torch``) and nothing of JAX,
and exits non-zero if any phase fails. Each phase prints one JSON line:

1. ``card``: device name and count, and the ``nvidia-smi`` name and power
   limit (also printed raw on a line of its own).
2. ``build``: builds every kernel of the main paths with ``nvcc`` from the
   checkout's sources (golden_section, its cbrtf variant of phase 3b, and
   hier_aggregate), all at once; build seconds and the ptxas register/spill
   report.
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
3c. ``kernel`` (hier_aggregate, run after phase 4, whose assignment sets
   its edge shape): the eq. (8)/(14) kernel against its plain version at
   the cloud shape (1000 clients of the MLP), at the largest edge group of
   phase 4's assignment, and at ragged and bfloat16 shapes; kernel, plain
   and ``torch.mv`` times, bytes, bound and the kernel's share of it.
5. ``card_vs_cpu``: the engine on the card and on the CPU (plain version)
   land on the same stable point for ``make_scenario(60, 5)``.
6. ``train_path``: HFEL training (Algorithm 1) on the card from phase 4's
   stable assignment: MNIST-sized data over the 1000 devices, the MLP,
   L = 10 and I = 5, 3 HFEL rounds then 3 FedAvg rounds from the same
   omega^0; seconds per round, the kernel's launches per round (asserted),
   test accuracy and train loss per round, peak device memory. Then
   ``train_breakdown``: local steps against aggregation, timed apart, and
   the kernel at each edge group; and ``train_profile``: one more HFEL
   round under ``torch.profiler``, device time by kernel and idle share.
7. ``train_card_vs_cpu``: ``train_federated`` on the card and on the CPU
   agree on ``make_mnist_like(30)`` with the engine's assignment for
   ``make_scenario(30, 5)``.

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

AGG_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # hier_aggregate vs plain
TRAIN_LR = 0.05          # benchmarks/paper_training.py's learning rate
TRAIN_ROUNDS = 3


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
    (golden_section<NT, IT>: threads per block, slots per thread;
    hier_aggregate<T, V>: element type, elements per thread)."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            t = re.search(r"ILi(\d+)ELi(\d+)E", entry.group(1))
            v = re.search(r"kernelI(f|13__nv_bfloat16)Li(\d+)E",
                          entry.group(1))
            name = (f"NT={t.group(1)},IT={t.group(2)}" if t else
                    f"T={'f32' if v.group(1) == 'f' else 'bf16'},"
                    f"V={v.group(2)}" if v else entry.group(1))
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


def cuda_ms_cold(fn, reps: int, flush) -> float:
    """Mean milliseconds of ``fn()`` alone, with ``flush`` (a write larger
    than the L2 cache) run before each launch outside the timed span."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


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


class KeepTrainer:
    """Round policy for ``train_federated`` that keeps the trainer (to read
    its final global params) and never swaps the assignment."""

    trainer = None

    def begin_round(self, trainer, round_idx):
        self.trainer = trainer
        return None


def profile_round(trainer, assignment, n_servers, n_local, n_edge) -> None:
    """One more HFEL round under ``torch.profiler``: device time by kernel
    and the device's idle share of the round (profiler on). Reports a
    profiler failure on its line instead of failing the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.hfel_round(assignment, n_servers, n_local, n_edge)
            torch.cuda.synchronize()
            round_s = time.perf_counter() - t0
        rows = []
        for e in prof.key_averages():
            if "CUDA" not in str(e.device_type):
                continue
            rows.append((e.key, e.self_device_time_total, e.count))
    except (RuntimeError, AttributeError) as exc:
        emit("train_profile", error=repr(exc))
        return
    busy_s = sum(us for _, us, _ in rows) / 1e6
    rows.sort(key=lambda x: -x[1])
    emit("train_profile", round_s=round_s, device_busy_s=busy_s,
         idle_share=1.0 - busy_s / round_s, n_device_events=len(rows),
         top=[dict(name=name[:80], ms=us / 1e3, count=cnt)
              for name, us, cnt in rows[:10]])


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
    from repro_torch.configs import CONFIG
    from repro_torch.core.scenario import make_scenario
    from repro_torch.data import make_mnist_like
    from repro_torch.fl import FederatedTrainer, train_federated
    from repro_torch.kernels import build, golden_section, hier_aggregate, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card ----
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("card", name=name, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build the main paths' kernels and the variant, all at once ----
    variants = {"golden_section": ("golden_section", ()),
                "golden_section_cbrtf": ("golden_section", ("GS_CBRT_F32",)),
                "hier_aggregate": ("hier_aggregate", ())}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda job: build.load(*job), variants.values())))
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
    cbrtf = variants["golden_section_cbrtf"][1]
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

    # ---- 3c. hier_aggregate vs its plain version; the edge shape is the
    # largest group of phase 4's stable assignment ----
    group_sizes = np.bincount(res.assignment, minlength=k)
    n_params = 784 * 128 + 128 + 128 * 10 + 10     # the MLP at MNIST width
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20 // 4, device=dev).zero_   # 64 MiB > L2
    f32, bf16 = torch.float32, torch.bfloat16
    agg = {}
    for case, c_, p_, dtype in (
            ("cloud", n, n_params, f32),
            ("edge", int(group_sizes.max()), n_params, f32),
            ("ragged", 1, 17, f32), ("ragged", 4, 100, f32),
            ("ragged", 37, 4099, f32), ("bfloat16", 50, n_params, bf16),
            ("bfloat16", 37, 4099, bf16)):
        u = torch.randn(c_, p_, generator=gen, device=dev).to(dtype)
        w = 20.0 + 900.0 * torch.rand(c_, generator=gen, device=dev)
        got = hier_aggregate.hier_aggregate(u, w)
        torch.cuda.synchronize()
        want = ref.hier_aggregate_ref(u, w)
        tname = str(dtype).removeprefix("torch.")
        tol = AGG_TOL[tname]
        err = (got.float() - want.float()).abs()
        fields = dict(kernel="hier_aggregate", case=case, shape=[c_, p_],
                      dtype=tname, vector_width=hier_aggregate.vector_width(u),
                      tolerance=tol, bitwise=bool(torch.equal(got, want)),
                      max_abs_err=float(err.max()))
        if not (torch.isfinite(got.float()).all()
                and (err <= tol + tol * want.float().abs()).all()):
            emit("kernel", **fields)
            raise AssertionError(f"hier_aggregate {case} {c_}x{p_} {tname} "
                                 "disagrees with its plain version")
        if case in ("cloud", "edge"):
            ut, wn = u.t(), w / w.sum()
            k_ms = cuda_ms(lambda: hier_aggregate.hier_aggregate(u, w),
                           reps=50)
            nbytes = (c_ + 1) * p_ * u.element_size() + c_ * 4
            b_ms, b_by = bound_ms(2 * c_ * p_ + c_, nbytes)
            fields.update(
                ms=k_ms, ms_cold_l2=cuda_ms_cold(
                    lambda: hier_aggregate.hier_aggregate(u, w), 20, flush),
                plain_ms=cuda_ms(lambda: ref.hier_aggregate_ref(u, w),
                                 reps=3),
                library_ms=cuda_ms(lambda: torch.mv(ut, wn), reps=50),
                library="torch.mv(u.T, w_normalised)",
                library_max_abs_err=float((torch.mv(ut, wn) - want)
                                          .abs().max()),
                bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / k_ms)
            agg[case] = fields
        emit("kernel", **fields)
    del u, w, got, want, err

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

    # ---- 6. HFEL training on the card from phase 4's stable assignment ----
    n_local, n_edge = CONFIG.local_iters, CONFIG.edge_iters
    assignment = res.assignment
    servers = int((group_sizes > 0).sum())
    t0 = time.perf_counter()
    ds = make_mnist_like(n, dim=784, samples_total=60000, seed=0)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hfel = FederatedTrainer(ds, model="mlp", lr=TRAIN_LR, seed=0)
    omega0 = hfel.flat.clone()
    m0 = hfel.evaluate()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if tuple(hfel.flat.shape) != (n, n_params):
        raise AssertionError(f"client stack {tuple(hfel.flat.shape)}")
    golden_section.LAUNCHES = 0
    hier_aggregate.LAUNCHES = 0
    rounds, peak = {}, {}
    for method in ("hfel", "fedavg"):
        torch.cuda.reset_peak_memory_stats()
        if method == "hfel":
            tr, expected = hfel, n_edge * servers + 1
        else:
            tr, expected = FederatedTrainer(ds, model="mlp", lr=TRAIN_LR,
                                            seed=0), 1
            if not torch.equal(tr.flat, omega0):
                raise AssertionError("FedAvg does not start from omega^0")
        rounds[method] = []
        for r in range(TRAIN_ROUNDS):
            before = hier_aggregate.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if method == "hfel":
                tr.hfel_round(assignment, k, n_local, n_edge)
            else:
                tr.fedavg_round(n_local, n_edge)
            torch.cuda.synchronize()
            round_s = time.perf_counter() - t0
            launched = hier_aggregate.LAUNCHES - before
            rounds[method].append(dict(round=r, s=round_s, launches=launched,
                                       launches_expected=expected,
                                       **tr.evaluate()))
            if launched != expected:
                raise AssertionError(f"{method} round {r}: {launched} "
                                     f"launches, expected {expected}")
        peak[method] = torch.cuda.max_memory_allocated()
    train_launches = hier_aggregate.LAUNCHES
    fedavg = tr
    per_round = {m: [x["s"] for x in v] for m, v in rounds.items()}
    emit("train_path", n_clients=n, n_servers=k, servers_with_members=servers,
         model="mlp", n_params=n_params, local_iters=n_local,
         edge_iters=n_edge, lr=TRAIN_LR, data_s=data_s, setup_s=setup_s,
         client_x_bytes=int(ds.client_x.nbytes), omega0=m0,
         hfel=rounds["hfel"], fedavg=rounds["fedavg"],
         s_per_hfel_round=sum(per_round["hfel"]) / TRAIN_ROUNDS,
         s_per_fedavg_round=sum(per_round["fedavg"]) / TRAIN_ROUNDS,
         launches=train_launches,
         golden_section_launches=golden_section.LAUNCHES,
         max_memory_allocated_hfel=peak["hfel"],
         max_memory_allocated_fedavg_both_trainers=peak["fedavg"])
    last = rounds["hfel"][-1]
    values = [m0["train_loss"], *(x[f] for v in rounds.values() for x in v
                                  for f in ("s", "test_acc", "train_acc",
                                            "train_loss"))]
    if not (np.isfinite(values).all() and torch.isfinite(hfel.flat).all()
            and torch.isfinite(fedavg.flat).all()):
        raise AssertionError("training produced a value that is not finite")
    if not last["train_loss"] < m0["train_loss"]:
        raise AssertionError(f"HFEL train loss {last['train_loss']} is not "
                             f"below omega^0's {m0['train_loss']}")

    # local steps against aggregation, timed apart (after the counted run)
    local_ms = cuda_ms(lambda: hfel._local(n_local), reps=2, warm=0)
    edge_ms = cuda_ms(lambda: hfel.edge_aggregate(assignment, k), reps=5)
    cloud_ms = cuda_ms(hfel.cloud_aggregate, reps=5)
    w_all = hfel._weights()
    group_ms = []
    for srv in np.flatnonzero(group_sizes):
        sel = torch.as_tensor(np.flatnonzero(assignment == srv), device=dev)
        rows, w_k = hfel.flat.index_select(0, sel), w_all.index_select(0, sel)
        group_ms.append(cuda_ms(lambda: hier_aggregate.hier_aggregate(
            rows, w_k), reps=20))
    cloud_kernel_ms = cuda_ms(lambda: hier_aggregate.hier_aggregate(
        hfel.flat, w_all), reps=20)
    kernel_round_ms = n_edge * sum(group_ms) + cloud_kernel_ms
    hfel_round_ms = 1e3 * per_round["hfel"][-1]
    emit("train_breakdown", local_steps_ms=local_ms / n_local,
         local_block_ms=local_ms, edge_aggregate_ms=edge_ms,
         cloud_aggregate_ms=cloud_ms,
         hfel_round_ms_sum=n_edge * (local_ms + edge_ms) + cloud_ms,
         hfel_round_ms_measured=hfel_round_ms,
         kernel_ms_edge_groups=group_ms, kernel_ms_cloud=cloud_kernel_ms,
         kernel_ms_per_hfel_round=kernel_round_ms,
         kernel_share_hfel_round=kernel_round_ms / hfel_round_ms,
         kernel_share_fedavg_round=cloud_kernel_ms
         / (1e3 * per_round["fedavg"][-1]))
    profile_round(hfel, assignment, k, n_local, n_edge)
    del ds, hfel, fedavg, tr, omega0, rows, w_all

    # ---- 7. train_federated on the card and on the CPU ----
    ds30 = make_mnist_like(30, seed=0)
    a30 = FastAssociationEngine(make_scenario(30, 5, seed=0)).run(
        "nearest", exchange_samples=0).assignment
    out = {}
    for where in ("cuda", "cpu"):
        keep = KeepTrainer()
        t0 = time.perf_counter()
        hist = train_federated(ds30, method="hfel", assignment=a30,
                               n_servers=5, rounds=TRAIN_ROUNDS,
                               local_iters=n_local, edge_iters=n_edge,
                               lr=TRAIN_LR, model="mlr", seed=0,
                               round_hook=keep, device=where)
        out[where] = (hist, {key: v.cpu().numpy() for key, v in
                             keep.trainer.global_params().items()},
                      time.perf_counter() - t0)
    (h_card, p_card, s_card), (h_cpu, p_cpu, s_cpu) = out["cuda"], out["cpu"]
    params_close = all(np.allclose(p_card[key], p_cpu[key], rtol=1e-4,
                                   atol=1e-5) for key in p_cpu)
    acc_gap = float(np.abs(np.subtract(h_card.test_acc, h_cpu.test_acc))
                    .max())
    one_sample = 1.0 / len(ds30.test_y)
    emit("train_card_vs_cpu", fixture=[30, 5, 0], model="mlr",
         assignment_sizes=np.bincount(a30, minlength=5).tolist(),
         test_acc_card=h_card.test_acc, test_acc_cpu=h_cpu.test_acc,
         train_loss_card=h_card.train_loss, train_loss_cpu=h_cpu.train_loss,
         max_abs_err_params=max(float(np.abs(p_card[key] - p_cpu[key]).max())
                                for key in p_cpu),
         params_close=params_close, max_test_acc_gap=acc_gap,
         one_test_sample=one_sample, card_s=s_card, cpu_s=s_cpu)
    if not (params_close and acc_gap <= one_sample + 1e-9):
        raise AssertionError("card and CPU training disagree on (30, 5, 0)")

    cloud = agg["cloud"]
    print(json.dumps({"kernels": [
        dict(name="golden_section", route="cuda",
             source="src/repro_torch/kernels/csrc/golden_section.cu",
             replaces="src/repro/kernels/golden_section.py:169",
             launches=launches, library_ms=None, shape=list(masks.shape),
             **main_kernel),
        dict(name="hier_aggregate", route="cuda",
             source="src/repro_torch/kernels/csrc/hier_aggregate.cu",
             replaces="src/repro/kernels/hier_aggregate.py:35",
             launches=train_launches, max_abs_err=cloud["max_abs_err"],
             ms=cloud["ms"], plain_ms=cloud["plain_ms"],
             bound_ms=cloud["bound_ms"], bound_by=cloud["bound_by"],
             library_ms=cloud["library_ms"], shape=cloud["shape"])]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
