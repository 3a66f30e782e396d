#!/usr/bin/env python3
"""Measurements of flash attention's backward kernel on one CUDA card,
beside ``chip_smoke.py``'s phase 21b (which holds the kernel to its plain
version). Run from the root of a checkout on the card's machine:

    python3 scripts/flash_bwd_study.py steps --root DIR --label NAME
    python3 scripts/flash_bwd_study.py variants
    python3 scripts/flash_bwd_study.py kernels
    python3 scripts/flash_bwd_study.py walk192

``steps`` imports the tree at ``--root`` (its ``chip_smoke.py`` and
``src/repro_torch``; another commit unpacked with ``git archive``) and
prints, as JSON lines, its backward's device ms at every train shape of
phase 21b (three runs of 50 calls, the card spun first so the host's
enqueueing is not timed) and its train steps (phase 22's qwen3-0.6b
``sync``, phase 27's deepseek and internvl2). Run it for two trees in
turns in one call (A, B, B, A) to compare them on one card.

``variants`` builds copies of ``csrc/flash_attention_bwd.cu`` that leave
out parts of the ordered dQ sum (the wait for an add to land, the wait
for the kv tiles before, the add itself; their results are wrong or not
repeatable, so they are timings only) and times each beside the kernel,
in turns.

``kernels`` gives each kernel of one backward call its device ms under
``torch.profiler`` (the pre-pass, the walk, the passes that round its
sums; at hd 192 the three walks), at every train shape.

``walk192`` compiles the walk at head dim 192 (with the m64n192 product it
would need) and prints ptxas' registers, stack and spills.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS, REPS, HOST_US, CYCLES_PER_US = 3, 50, 500, 1980
# the backward's kernels (csrc/flash_attention_bwd.cu's flash_bwd_<name>)
KERNELS = ("pre", "walk", "post_dq", "post_kv", "dkdv", "dq")

# texts of the source that ``variants`` takes out (each occurs once)
_LAND = ("        bulk_wait();\n        fence_async_global();\n"
         "        red_release_add(a.sem + tile, 1);\n")
_ORDER = "          wait_count(a.sem + tile, z);\n"
_ADD = ("        if (z == 0) bulk_store(dst, src, L::kDQBytes);   "
        "// the first partial\n"
        "        else bulk_reduce_add(dst, src, L::kDQBytes);   "
        "// the next in kv order\n")
VARIANTS = {
    "no_land": [(_LAND, "        red_release_add(a.sem + tile, 1);\n")],
    "no_order": [(_ORDER, "")],
    "no_dq_add": [(_ADD, "")],
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def shapes(cs):
    """Phase 21b's bf16 train shapes: (case, (B, Sq, Skv, Hq, Hkv, hd),
    causal, scale)."""
    vlm = cs.VLM_PREFIX + cs.TRAIN_SEQ
    return [
        ("qwen3_layer", (cs.TRAIN_SYNC_BATCH, cs.TRAIN_SEQ, cs.TRAIN_SEQ, 16,
                         8, 128), True, None),
        ("deepseek_layer", (cs.MOE_TRAIN_BATCH, cs.TRAIN_SEQ, cs.TRAIN_SEQ,
                            16, 16, 192), True, 192 ** -0.5),
        ("internvl2_layer", (cs.VLM_TRAIN_BATCH, vlm, vlm, 14, 2, 64), True,
         None),
        ("internvl2_pod", (cs.TRAIN_PER_POD, vlm, vlm, 14, 2, 64), True,
         None),
        ("whisper_encoder", (cs.ENCDEC_TRAIN_BATCH, 1500, 1500, 20, 20, 64),
         False, None),
        ("whisper_cross", (cs.ENCDEC_TRAIN_BATCH, cs.ENCDEC_DEC_SEQ, 1500,
                           20, 20, 64), False, None),
        ("whisper_decoder", (cs.ENCDEC_TRAIN_BATCH, cs.ENCDEC_DEC_SEQ,
                             cs.ENCDEC_DEC_SEQ, 20, 20, 64), True, None)]


def device_ms(fn) -> float:
    """Mean ms of ``fn()`` over ``REPS`` back-to-back calls (CUDA events),
    the card spun first for ``HOST_US`` a call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(REPS * HOST_US * CYCLES_PER_US)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def inputs(cs, gen, shape, causal, scale):
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, sq, skv, hq, hkv, hd = shape
    dev = gen.device
    q, g = (torch.randn(b, sq, hq, hd, generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    k, v = (torch.randn(b, skv, hkv, hd, generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                return_lse=True)
    return q, k, v, o, lse, g


def steps(root: Path, label: str) -> None:
    """The backward's ms at the train shapes and the train steps of the
    tree at ``root``."""
    os.chdir(root)
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm"):
        build.load(name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    emit(tree=label, card=cs.nvidia_smi_line())
    for case, shape, causal, scale in shapes(cs):
        q, k, v, o, lse, g = inputs(cs, gen, shape, causal, scale)
        runs = [device_ms(lambda: fa.flash_attention_backward(
            q, k, v, o, lse, g, causal=causal, scale=scale))
            for _ in range(RUNS)]
        emit(tree=label, case=case, ms_runs=runs)
        del q, k, v, o, lse, g
    torch.cuda.empty_cache()
    model = build_model(get_config(cs.TRAIN_ARCH))
    data, _ = cs.train_data(
        model, (cs.TRAIN_SYNC_STEPS + 1) * cs.TRAIN_SYNC_BATCH, cs.TRAIN_SEQ,
        dev)
    cs.train_run(dev, model, data, phase="train_lm_sync", mode="sync",
                 batch=cs.TRAIN_SYNC_BATCH, steps=cs.TRAIN_SYNC_STEPS)
    del model, data
    torch.cuda.empty_cache()
    cs.train_moe_path(dev)
    torch.cuda.empty_cache()
    cs.train_vlm_path(dev)


def compile_copy(directory: Path, name: str, text: str
                 ) -> tuple[Path, str]:
    """``text`` as ``csrc/flash_attention_bwd.cu`` built with its flags;
    the library's path and nvcc's report."""
    from repro_torch.kernels import build
    src = directory / f"{name}.cu"
    src.write_text(text)
    out = src.with_suffix(".so")
    proc = subprocess.run([build.nvcc_path(),
                           *build.nvcc_flags("flash_attention_bwd"), "-o",
                           str(out), str(src)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    return out, proc.stdout + proc.stderr


def variants() -> None:
    """Each copy of ``VARIANTS`` timed beside the kernel, in turns."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    directory = Path(tempfile.mkdtemp())

    def make(name):
        copy = text
        for old, new in VARIANTS[name]:
            if copy.count(old) != 1:
                raise AssertionError(f"{name}: its text is not in the source "
                                     "exactly once")
            copy = copy.replace(old, new)
        return compile_copy(directory, name, copy)[0]

    with ThreadPoolExecutor(len(VARIANTS) + 2) as pool:
        jobs = {name: pool.submit(make, name) for name in VARIANTS}
        kernel = pool.submit(build.load, "flash_attention_bwd")
        build.load("flash_attention")
        libs = {"kernel": fa.bind_bwd(kernel.result().lib)}
        libs.update({name: fa.bind_bwd(ctypes.CDLL(str(job.result())))
                     for name, job in jobs.items()})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    emit(card=cs.nvidia_smi_line())
    for case, shape, causal, scale in shapes(cs):
        if shape[-1] > 128:      # the walk's head dims only
            continue
        q, k, v, o, lse, g = inputs(cs, gen, shape, causal, scale)
        runs = {}
        for _ in range(RUNS):
            for name, lib in libs.items():
                runs.setdefault(name, []).append(device_ms(
                    lambda: fa.launch_bwd(q, k, v, o, lse, g, causal, lib,
                                          scale)))
        emit(case=case, ms_runs=runs)
        del q, k, v, o, lse, g


def kernels() -> None:
    """Each kernel's device ms in one backward call (after a warm one) at
    every train shape, from ``torch.profiler``."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from torch.profiler import ProfilerActivity, profile
    for name in ("flash_attention", "flash_attention_bwd"):
        build.load(name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    emit(card=cs.nvidia_smi_line())
    for case, shape, causal, scale in shapes(cs):
        q, k, v, o, lse, g = inputs(cs, gen, shape, causal, scale)

        def call():
            return fa.flash_attention_backward(q, k, v, o, lse, g,
                                               causal=causal, scale=scale)

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        device_ms = {}
        for e in prof.key_averages():
            found = re.search(r"flash_bwd_([a-z]+(?:_(?:dq|kv))?)", e.key)
            if found and found.group(1) in KERNELS:
                device_ms[found.group(1)] = (device_ms.get(found.group(1), 0.0)
                                             + e.self_device_time_total / 1e3)
        emit(case=case, device_ms=device_ms or None)
        del q, k, v, o, lse, g


def walk192() -> None:
    """ptxas' report of the walk instantiated at head dim 192."""
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import build
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    head = ("template <>\n__device__ __forceinline__ void "
            "wgmma_ss_tt<128>(")
    i0 = text.index(head)
    i1 = text.index("}\n", text.index('"r"(scale_d));', i0)) + 2
    regs = ", ".join(f"%{i}" for i in range(96))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(96))
    n192 = (
        "template <>\n__device__ __forceinline__ void wgmma_ss_tt<192>("
        "float* d, uint64_t da, uint64_t db, int scale_d) {\n"
        '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %98, 0;\\n"\n'
        '  "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 '
        f'{{{regs}}}, %96, %97, p, 1, 1, 1, 1;\\n}}\\n"\n'
        f'  : {outs}\n  : "l"(da), "l"(db), "r"(scale_d));\n}}\n')
    text = text[:i1] + "\n" + n192 + text[i1:]
    text = text.replace(
        "}  // namespace\n", "void* const kWalk192 = reinterpret_cast<void*>("
        "&flash_bwd_walk_bf16<192>);\n}  // namespace\n", 1)
    _, log = compile_copy(Path(tempfile.mkdtemp()), "walk192", text)
    entry = re.search(r"Compiling entry function '(\S*walk_bf16ILi192\S*)'"
                      r".*?\n(.*?)\n(.*?)\n(.*?)\n", log, re.S)
    emit(kernel="flash_bwd_walk_bf16<192>",
         ptxas=[line.split(":", 1)[-1].strip()
                for line in entry.groups()[1:]] if entry else None,
         smem_bytes_at_2_stages_1_staging_tile=(
             2 * 128 * 192 * 2 + 2 * 2 * 64 * 192 * 2 + 2 * 512
             + 128 * 64 * 2 + 64 * 192 * 4),
         smem_limit_bytes=232448)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    tree = sub.add_parser("steps")
    tree.add_argument("--root", type=Path, default=ROOT)
    tree.add_argument("--label", default="this")
    sub.add_parser("variants")
    sub.add_parser("kernels")
    sub.add_parser("walk192")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if args.mode == "steps":
        steps(args.root.resolve(), args.label)
    elif args.mode == "variants":
        variants()
    elif args.mode == "kernels":
        kernels()
    else:
        walk192()
    emit(mode=args.mode, seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
