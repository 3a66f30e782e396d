#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``. It imports the port (``src/repro_torch``) and nothing of JAX,
and exits non-zero if any phase fails. Each phase prints one JSON line:

1. ``card``: device name and count, and the ``nvidia-smi`` name and power
   limit (also printed raw on a line of its own).
2. ``build``: builds every kernel of the main paths with ``nvcc`` from the
   checkout's sources (golden_section, its cbrtf variant of phase 3b,
   hier_aggregate, rmsnorm, flash_attention, flash_attention_bwd and its
   build with the walk's counters for phase 21b, ssd_scan), and the flash kernel's five planted faults of phase 8 and
   the backward's five of phase 21b in a temporary directory, all at
   once, each with its own nvcc flags (``build.nvcc_flags``: every kernel
   but flash's forward and backward with -fmad=false); build seconds and
   the ptxas register/spill report.
3. ``kernel``: each kernel against its plain PyTorch version on the same
   card tensors, at the main path's shapes and at ragged ones, with the
   stated tolerance; kernel and plain times (CUDA events), the operation
   and byte counts, the bound they give and the kernel's share of it. The
   golden-section lines (the main path's (1001, 1000) batch; fully active
   (8, 1000) and (1001, 1000) batches, a block per group; 64 groups at 20%
   active; 64 groups half at 5% and half at 30%, both of the kernel's
   paths in one call; the ragged (5, 37) batch under every profile) assert
   the pin and report ``groups_not_bitwise``, the groups on each of the
   kernel's paths and, off the main batch, the kernel's time.
3b. ``design``: the golden-section kernel built with ``cbrtf`` instead of
   the double cube root, at the main shape: its time, and how many groups
   leave the pin and how many differ in any bit from the plain version
   (reported, not asserted).
4. ``main_path``: ``make_scenario(1000, 20)`` and the dense transfer-only
   association engine to a stable point on the card, with the kernel's
   launch count read around exactly this run; ms per move and the share
   of it that the two launches' kernel time makes.
4b. ``exchange_path``: Algorithm 3 complete, as ``evaluate_scheme("hfel")``
   runs it: ``make_scenario(1000, 20)`` from a random start with 64
   sampled exchanges a stuck round (the engine's defaults, its threefry
   stream), to a stable point on the card: moves, transfers, exchanges
   applied and exchange rounds tried, seconds, cache-init seconds, ms per
   move and per exchange round, costs, the kernel's launches (asserted: K
   at init, 2 per applied move, 1 per exchange round, 1 at finalize) and a
   monotone trace (asserted). Then ``exchange_from_stuck``: exchanges from
   phase 4's transfer-only stable point, how many apply and how far the
   cost falls; and a golden-section ``kernel`` line at an exchange round's
   batch, (128, 1000), bit-equal to the plain version (asserted), with its
   time and bound.
3c. ``kernel`` (hier_aggregate, run after phase 4, whose assignment sets
   its edge shape): the eq. (8)/(14) kernel against its plain version at
   the cloud shape (1000 clients of the MLP), at the largest edge group of
   phase 4's assignment, and at ragged and bfloat16 shapes, with its
   client-axis ``splits``; kernel, plain and ``torch.mv`` times at the
   cloud and edge shapes, bytes, bound and the kernel's share of it.
5. ``card_vs_cpu``: the engine on the card and on the CPU (plain version)
   land on the same stable point for ``make_scenario(60, 5)``.
5b. ``exchange_card_vs_cpu``: ``make_scenario(60, 5)`` from the nearest
   start with exchanges, card and CPU: the same stable point, moves and
   exchanges applied (at least one).
5c. ``solvers_card_vs_cpu``: each plain-solver scheme kind on one (8, 30)
   batch, card against CPU: bitwise or not, the largest cost difference
   (asserted within the pin; ``solve_paper`` within 2.5e-2, the JAX
   solver's own spread), and how often the card's ``exp``, ``log`` and
   ``sqrt`` round otherwise than the CPU's.
   ``schemes``: the paper's seven §V.A schemes (``evaluate_scheme``) on
   the card at the Fig. 3 points (N = 15, 30, 60 at K = 5) and the Fig. 4
   point K = 15 at N = 60, seed 0, as ``benchmarks/paper_cost.py`` runs
   them (but comm_opt at (60, 15), ``SCHEME_SKIP``: it alone takes 2.5
   minutes): each scheme's total cost over uniform's, true cost, seconds,
   moves and launches; HFEL at most 1.001 x random and x uniform
   (asserted). ``schemes_card_vs_cpu``: the seven at (20, 5, 4) and (12,
   3, 5) on the card and the CPU: the same assignment and moves, costs
   within 2e-4 (asserted).
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
8. ``kernel`` (rmsnorm, flash_attention): each serving kernel against its
   plain version at the serving path's shapes (qwen3-0.6b's prefill and
   decode rows; its attention layer at B=4, S=4096) and at ragged ones;
   kernel times on warm inputs and with the L2 flushed before each launch,
   plain and library-call times, the bound and the kernel's share, flash's
   TFLOP/s, each kernel's registers and spills from phase 2, and
   rmsnorm's host and device microseconds per call at the decode shape.
   Every flash line also holds the rows' logsumexp the kernel writes for
   the backward against the plain forward's under ``FLASH_LSE_ATOL``.
   Then ``fault``: copies of the flash kernel with a planted fault (one kv
   tile left out; O rounded to bfloat16 after each k16 step of P V; S
   reading K from the next ring stage, a stale or not-yet-landed tile;
   lse without the scale in its running max; lse in natural-log units) at
   the layer shape, each of which the flash tolerance or the lse one must
   reject. Every
   flash launch of phases 8 and 12 is waited for against a host-side
   deadline (``CARD_DEADLINE_S``): a launch that never finishes prints the
   phase's failing line and ends the run non-zero.
9. ``prefill_path``: ``Model.logits`` of full-size qwen3-0.6b (28 layers,
   random weights from seed 0, bfloat16 serving copy, the flash kernel) on
   4 x 4096 tokens; seconds and tokens/s per forward, the launch counts
   (28 flash, 57 rmsnorm per forward, asserted), peak memory, and
   ``prefill_profile``: device time of flash, GEMMs and the rest, and the
   idle share.
10. ``serve_path``: the server answers 8 requests of a 256-token prompt
   and 32 greedy tokens: prompts prefilled by ``Model.logits``, fed through
   the decode step token by token, then decoded greedily by the serve
   step; ms per step, tokens/s, launches per step (57 rmsnorm, 0 flash,
   asserted) and the gap between decode and prefill logits (asserted).
   Then ``serve_profile``: two serve steps under ``torch.profiler``, wall
   and device time per step, kernels per step, idle share.
11. ``serve_card_vs_cpu``: reduced qwen3-0.6b in float32, the same params on
   the card (kernels) and the CPU (plain versions): logits and 8 decode
   steps agree, greedy tokens identical.
12. ``kernel`` (ssd_state_scan, flash_attention at head dim 80): the scan
   kernel against its plain version, bit for bit, at mamba2-1.3b's and
   zamba2-2.7b's prefill shapes (NC=16 chunks of 4 x 4096 tokens), a long
   sequence (NC=128), a ragged shape and bfloat16 states, with kernel and
   plain times, bytes, bound and share at mamba2's (no PyTorch call
   computes it); the flash kernel at zamba2's shared attention layer (B=4,
   S=4096, 32 heads of 80, bf16, causal) under phase 8's bf16 tolerance,
   with its warm and L2-cold times, bound and SDPA's time.
13. ``ssm_prefill_path``: ``Model.logits`` of full-size mamba2-1.3b (48
   layers) and zamba2-2.7b (54 layers, the shared block after every 6),
   random weights from seed 0, bfloat16 serving copy, on 4 x 4096 tokens:
   seconds and tokens/s per forward, launches (asserted: 48 scans and 97
   rmsnorm; 54 scans, 9 flash and 127 rmsnorm per forward), peak memory;
   ``ssm_layer_split``: device time in the SSM blocks and in
   ``ssd_chunked``; ``ssm_prefill_profile``: device time by kernel class
   and idle share.
14. ``ssm_serve_path``: the server answers 128 requests of mamba2-1.3b
   (decode_32k's batch) with a 512-token prompt (two chunks) and 32 greedy
   tokens: ms per step, tokens/s, the cache's bytes (asserted equal to
   ``cache_bytes``), launches (48 scans in the check prefill, 97 rmsnorm
   per step and no scan in decode, asserted); on the first 8 requests the
   decode logits against ``Model.logits`` (state carried across the chunk
   boundary by the scan kernel): in float32 at 2e-3 (asserted), in bf16
   against phase 10's bound beside the bf16 prefill's own distance to the
   float32 one (reported), first tokens equal to the prefill argmax;
   ``ssm_serve_profile``: a profiled step.
15. ``ssm_card_vs_cpu``: reduced mamba2 and zamba2 in float32 over 64
   positions (two chunks), card vs CPU: logits and decode within 1e-4,
   greedy tokens identical.

16. ``compact_path``: ``make_large_scenario(1000, 20)``, the ``fast`` kind
   at the coarse profile, nearest start, transfers only, to a stable point
   in the dense, flat and bucketed spaces: the same assignment, moves and
   cost bits in all three, K + 2 moves launches each (asserted); ms per
   move, init seconds, R_max, the bucket widths and padded fractions.
17. ``scale_path``: ``make_large_scenario(50_000, 500, spread_m=60)``,
   coarse, rel_tol 1e-2, bucketed, on one card: the cold descent (stable
   within 8000 moves, asserted; seconds, ms per move, the kernel's share
   of a move from a replayed 1-in-50 sample of its launches, peak memory),
   a churn tick and ``rerun_incremental`` (seconds, host preparation,
   stale rows), and a cold rebuild from the same repaired assignment,
   bit-identical to the warm result (asserted). Then golden-section
   ``kernel`` lines at the widest bucket's refresh batch and at a flat
   exchange batch, bit-equal to the plain version (asserted), and
   ``scale_warm_profile``: a second warm tick under ``cProfile``, the
   functions that take the most host time.
18. ``live_path``: the live loop (``run_live``, ``LiveHFELRunner``) on
   ``make_large_scenario(250, 10)`` with 250 clients, 8 rounds, re-solve
   every 2, for the three policies: warm and cold swaps identical, both
   cheaper than static (asserted); then hier_aggregate ``kernel`` lines at
   its masked stacks (parked clients at weight 0; an edge of all-zero
   weights, which averages to 0), bit-equal (asserted); then
   ``live_admission``: a capacitated warm run (2000 devices, cap_slack
   1.1, 2 rounds), every placement within its cap (asserted).
19. ``live_scale``: one incremental-warm live run at N = 50k / K = 500
   with 128 clients, 2 rounds and 64 exchanges: seconds, moves, costs.
20. ``compact_card_vs_cpu``: the bucketed engine with exchanges and one
   ``rerun_incremental``, and ``run_live`` at N = 40 / K = 4 with verify
   on, card against CPU: the same assignments (asserted).

21. LM training. First (21b) ``kernel`` lines of flash's backward kernel
   (``csrc/flash_attention_bwd.cu``, from the forward kernel's o and lse)
   against its plain version under ``FLASH_BWD_TOL``, and that lse against
   the plain forward's under ``FLASH_LSE_ATOL``, at every attention
   shape of the train paths in bf16: qwen3-0.6b's layer (4 x 4096, 16/8
   heads of 128, causal; the five planted faults of ``FLASH_BWD_FAULTS``
   rejected there, the plain version's and the whole float32 recompute's
   ms), deepseek-v2-lite's MLA at hd 192, internvl2-1b's layer at the sync
   and pod batches, whisper-large-v3's encoder, cross attention and
   decoder; each with its ms and SDPA's autograd backward at the same
   shape (three device-time runs of each in turns, their median and
   spread), the bound and its share, TFLOP/s, the launch plan
   (``flash_attention.bwd_plan``), that two runs give the same bits
   (asserted), ptxas' report (asserted spill-free), and where the time
   goes (``counters``: the walk's own cycle counters by phase); then
   float32 at small shapes of every head dim. Then ``backward``: each kernel's backward (flash's
   kernel, rmsnorm's closed form and the scan's reverse recurrence in
   plain PyTorch, the same code as on the CPU) at the train shapes, with
   its ms and bound, the library call's backward at the same shape
   (``scaled_dot_product_attention``'s and ``rms_norm``'s autograd
   backward; the scan has none), and card against CPU on the same inputs
   (flash's forward and backward kernels in bf16 against the plain forward
   and backward on the CPU, each side from its own forward's o and lse,
   under ``FLASH_BWD_TOL`` and ``FLASH_LSE_ATOL``; the others in float32
   at 1e-5);
   then ``train_card_vs_cpu``: reduced qwen3-0.6b and mamba2-1.3b in
   float32, the loss, gradients, one ``sync`` and one ``hierarchical``
   step, card against CPU at 1e-4 (parameter entries with a gradient
   within that of zero to lr: AdamW's first step), and the cloud sync
   under TopK and Int8 on identical inputs at 1e-6.
22. ``train_lm_sync`` and ``train_lm_hierarchical``: full-width
   qwen3-0.6b (28 layers, bf16 activations, float32 params and AdamW
   state) at sequence 4096, random weights from seed 0, tokens from one
   ``TokenPipeline`` draw: ``sync`` at batch 4 for 3 steps, then
   ``hierarchical`` with 2 pods x 2 sequences, a cloud sync every 2 steps
   under ``TopKCompressor(0.01)``, 4 steps. Each line: s a step split into
   forward, backward and optimizer (CUDA events at the step's marks), the
   cloud syncs' seconds, tokens/s, peak memory (asserted under 75 GB), the
   loss at every step (asserted finite), the launches of flash, rmsnorm
   and the scan and their backward calls (asserted), flash's backward
   kernel launches (asserted: one a backward call), the mfu (model FLOPs
   over step time x the bf16 dense peak), and ``profile``: one more step
   under ``torch.profiler``, device time and share of the step of each
   backward function, idle share, top kernels.
23. ``checkpoint``: the hierarchical train state through
   ``CheckpointManager`` and back, every leaf bit-identical (asserted).
24. ``train_ssm_sync``: mamba2-1.3b at full width with its depth cut to 8
   of 48 layers, batch 2 x 2048, 2 ``sync`` steps, the same fields.

25. MoE + MLA serving, deepseek-v2-lite-16b. (a) ``kernel``: flash at
   head dim 192 (MLA's prefill: q, k of 128 + 64 columns, v padded to 192)
   against its plain version at the layer shape (B=4, S=4096, 16 heads,
   bf16, causal) under ``FLASH_TOL``, the five planted faults rejected
   there, and in float32 at ragged shapes; warm and L2-cold times, the
   bound (v at 192 and at its useful 128 columns), SDPA's time, registers
   and spills (asserted spill-free); rmsnorm at d_model 2048 in bf16 (8
   held vectors, the instantiation this path runs) bit for bit against
   its plain version at the prefill's 16,384 rows and the decode step's
   8, timed. (b) ``moe_prefill_path``: the full
   model (27 layers, 64 experts top-6 + 2 shared, random weights from
   seed 0) built as the bf16 serving copy a layer at a time (init seconds
   and peak), ``Model.logits`` on 4 x 4096 tokens: s per forward,
   tokens/s, launches (27 flash and 55 rmsnorm per forward, asserted),
   peak memory (asserted under 75 GB); ``moe_layer``: one MoE layer at the
   prefill shape under ``set_sync_debug_mode("error")`` (no host sync);
   ``moe_prefill_profile``: device time of flash, GEMMs, the MoE dispatch
   and the rest, idle share. (c) ``moe_serve_path``: 8 requests of a
   64-token prompt and 32 greedy tokens through ``serve_shape``: ms per
   step, launches (0 flash, 55 rmsnorm a step, asserted), the MLA cache's
   bytes (asserted equal to ``cache_bytes``), the bf16 decode-vs-prefill
   gap and the positions whose top-k routing differs between the two
   paths (reported); ``moe_serve_profile``. (d) ``moe_card_vs_cpu``:
   reduced deepseek (MLA at 16 + 8 columns, padded to the kernel's 32) and
   kimi-k2 in float32, card vs CPU within 1e-4, greedy tokens identical.
   (e) ``moe_decode_vs_prefill``: the full width cut to 4 layers (1 dense
   + 3 MoE), float32, capacity factor 64: decode within 2e-3 of the
   prefill (asserted), the routing differences reported.

26. Encoder-decoder and VLM serving, whisper-large-v3 and internvl2-1b.
   (a) ``kernel``: flash against its plain version under ``FLASH_TOL`` at
   whisper's encoder (B=4, 1500 frames, 20 heads of 64, non-causal) and
   cross attention (448 queries over 1500 frames, non-causal), internvl2's
   layer (B=4, S=4096, 14/2 heads of 64, causal) and kimi-k2's (64/8
   heads of 112, causal), each with warm and L2-cold times, the bound,
   SDPA's time and its share; at hd 112 the five planted faults rejected,
   ragged float32 and bf16 cases, no spills (asserted); rmsnorm at d_model
   896 in bf16 bit for bit at (16,384, 896) and (8, 896), timed. (b)
   ``encdec_prefill_path``: full-size whisper (32 + 32 layers, random
   weights from seed 0, bf16 serving copy built a layer at a time),
   ``Model.logits`` on 4 x 1500 frames and 448 tokens: s a forward,
   tokens/s, launches (96 flash and no rmsnorm a forward, asserted), peak
   memory, ``encdec_prefill_profile``. (c) ``encdec_serve_path``: 8
   requests of 1500 frames, whisper's 4-token start of transcript and 32
   greedy tokens: ms a step, the encoder's 32 flash launches at the
   cache's set-up and none a step (asserted), the cache's bytes (asserted
   equal to ``cache_bytes``), the bf16 decode-vs-prefill gap (reported),
   ``encdec_serve_profile``. (d) ``vlm_prefill_path``: full-size internvl2
   (24 layers) on 4 x (256 random prefix embeddings + 3840 tokens): 24
   flash and 49 rmsnorm a forward (asserted); ``vlm_serve_path``: 8
   requests of 256 + 32 tokens (no flash, 49 rmsnorm a step, asserted),
   then ``vlm_decode_32k``: ``serve_shape`` at decode_32k (128 requests, a
   32,768-position cache): ms a step, peak memory (asserted under 75 GB),
   the cache's bytes (asserted). (e) ``encdec_card_vs_cpu`` and
   ``vlm_card_vs_cpu``: reduced whisper (16 frames against 32 decoder
   positions) and internvl2 (with a prefix) in float32, card vs CPU
   within 1e-4, greedy tokens identical.

27. Training the MoE/MLA, encoder-decoder and VLM families, each line
   with phase 22's fields (the launches per forward by family; the mfu
   counts an MoE layer's active parameters and whisper's encoder over its
   frames; the profile adds the MoE dispatch's ops, forward and backward,
   and their share of the step). (a) ``train_moe_sync``:
   deepseek-v2-lite-16b at full width cut to 4 layers (the dense one and
   3 MoE), batch 4 x 4096, 3 ``sync`` steps (4 flash at hd 192 and 9
   rmsnorm at d 2048 a forward, asserted). (b) ``train_encdec_sync``:
   whisper-large-v3 whole on 4 x (1500 bf16 frames + 448 tokens), 3
   ``sync`` steps (96 flash a forward, no rmsnorm). (c)
   ``train_vlm_sync`` and ``train_vlm_hierarchical``: internvl2-1b whole
   on 4 x (256 bf16 image tokens + 4096 tokens), 3 ``sync`` steps, then 2
   pods x 2 for 4 steps with a TopK(0.01) cloud sync every 2 (24 flash and
   49 rmsnorm a forward). (d) ``train_families_card_vs_cpu``: phase 21's
   check on the reduced deepseek at capacity factor 0.5 (pairs dropped in
   every MoE layer, asserted), kimi-k2 at head dim 112, whisper and
   internvl2, all float32. Before (a), the kernels at the shapes of these
   paths that phases 25a and 26a do not hold: flash at internvl2's 256 +
   4096 positions (batch 4 and a pod's 2) and whisper's causal 448-token
   decoder self attention in bf16, rmsnorm at d 896 on internvl2's train
   rows; and in the MoE profile one of each dispatch op per MoE layer and
   forward (asserted).

28. The sharded sweep and Algorithm 1's collectives, run after phase 20:
   it holds phases 4, 4b, 17 and 18 to their sharded runs, every shard on
   the one card (``shard_devices``). ``sharded_setup``: ``distinct_cards``
   (false unless the machine has more than one card). ``sharded_path``:
   (a) phase 4's transfer-only descent at p = 1 and p = 4 (and over the
   first cards when there are several): the same assignment, moves and
   trace bits, K + 2 moves + 1 launches (asserted), ms a move; (b) phase
   4b's exchange descent at p = 4: the same moves, exchanges, exchange
   rounds, assignment and trace, K + 2 moves + p exchange rounds + 1
   launches (asserted); (c) phase 17's N = 50k cold descent and warm
   rerun at p = 4: the same stable points and moves (asserted), seconds;
   (d) phase 18's incremental-warm live run at p = 2: the same swaps
   (asserted). ``collectives``: four spawned ranks on a (pod=2, data=2)
   mesh from ``launch.mesh.make_test_mesh``, gloo over CUDA tensors (NCCL
   refuses two ranks on one card): ``psum_mean`` over each axis, weighted
   and not, and ``hierarchical_sync`` at every level, of the MLP's leaves,
   against plain float64 means on one process (within 1e-6 of the
   magnitudes, asserted), and ms a cloud sync; then a 1-rank NCCL mesh
   whose mean is its own tree (asserted).

29. The model zoo over a mesh of ranks, after phase 27 (``mesh_path``):
   qwen3-0.6b at full width, random weights from seed 0, bf16 activations,
   float32 params and AdamW state, ranks spawned on the one card. (f)
   first, on one NCCL rank (``mesh_one_rank``): a (1, 1) mesh's step is
   the ``mesh=None`` step bit for bit (asserted), whose loss is (a)'s
   reference. Then four gloo ranks (``mesh_rank``): the collectives the
   backend carries on CUDA tensors; (a) ``sync``, ``fsdp`` over (data=2,
   model=2) at 4096 x 2, 3 steps: s a step, each rank's peak (their sum
   under 75 GB, asserted), flash forward and backward 28 + 28 and rmsnorm
   57 launches a step on every rank (asserted), the first loss within
   ``MESH_LOSS_RTOL`` of (f)'s and the logits at every 256th position
   within ``MESH_BF16_LOGIT_ATOL`` of (f)'s, while a control forward with
   the last layer's row-parallel all-reduce dropped lands outside both
   (asserted); (e) (a)'s params written by rank 0 and
   restored onto (data=4, model=1), every leaf reassembled bit for bit
   (asserted); (b) (a) at float32 and 2 layers, one step, the loss within
   1e-5 and the state within ``TRAIN_TOL`` of the one-rank step's
   (asserted); (c) ``hierarchical`` over (pod=2, data=2, model=1) at 2048
   x 4, 4 steps, a cloud sync every 2: the pods' leaves equal bit for bit
   after each (asserted), ms a sync; (d) serving over (data=2, model=2):
   phase 10's 8 requests with 64-token prompts and 32 new tokens in
   bf16 (ms a step, the share of greedy tokens equal to one rank's), then
   at float32 and 2 layers the same greedy tokens and decode logits
   within 1e-4 (asserted). Four ranks sharing one card measure the
   mechanism and its cost, not the speed-up of four cards.

Then a ``kernels`` line (golden_section's launches are phases 4 and 4b's,
with each path's, phases 16-19's, phase 28's and the HFEL scheme runs'
beside them;
rmsnorm, flash and the scan add their train paths' launches (phases 22,
24 and 27) and a ``backward`` entry; rmsnorm and flash phases 25 and
26's launches and phase 29's (a) (``mesh_train``, summed over the four
ranks), rmsnorm ``d2048`` and ``d896`` entries, flash ``hd192``
and ``hd112`` entries and one for each of whisper's two shapes and
internvl2's layer), then ``flash_attention_bwd``, the backward kernel:
its launches on each train path, phase 21b's qwen3 line and one entry for
each other train shape,
the raw ``nvidia-smi`` line, and as the last line ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import cProfile
import json
import math
import os
import pstats
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, bfloat16 dense on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

PIN_RTOL = 2e-4          # cost, deadline, f (tests/test_assoc_sharded.py)
BETA_ATOL = 1e-7
FLIP_COST_RTOL = 2e-2

AGG_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # hier_aggregate vs plain
TRAIN_LR = 0.05          # benchmarks/paper_training.py's learning rate
TRAIN_ROUNDS = 3

# serving kernels vs their plain versions. rmsnorm must agree bit for bit
# (same reduction order, -fmad=false). flash attention is held to its plain
# version computed in float32 on the same inputs, not rounded, by (atol,
# rtol, block): elementwise |got - want| <= atol + rtol * scale, and the
# largest norm-relative error ||got - want|| / ||want|| of a block of 64
# query rows of one (batch, head) at most ``block``. float32: scale = |want|,
# 1e-5 (another summation order). bfloat16: the kernel rounds each P entry
# and the output to bf16, each by at most u = 2^-8 relatively, so its
# error is at most u (|want| + P|V|), P|V| being attention over |v|; scale =
# |want| + P|V| and rtol = 2u, and 5e-3 per block (about 2u, where the
# roundings give 1e-3 to 2.5e-3). A kernel that skips a kv tile, rounds O
# to bf16 after each PV product or computes on the other ring stage's K/V
# must fail (phase 8 plants all three and checks).
FLASH_TOL = {"float32": (1e-5, 1e-5, None),
             "bfloat16": (1e-5, 2 ** -7, 5e-3)}
FLASH_ROWS = 64          # query rows of a block in the norm-relative error
# the rows' logsumexp that the forward writes for the backward (log2
# units), against the plain version's computed in float32 on the same
# inputs: |got - want| <= FLASH_LSE_ATOL. The kernel's differs by the
# float32 roundings of the scores (about 2^-24 |s c log2 e| each, 1e-6 at
# |s c| <= 8), ex2.approx's 2^-22 relative error in each term of the sum
# l (3.4e-7 in log2 l) and the sum's own order (a thread's chain of at
# most ~1100 terms, 2^-24 each, 9.4e-5 in log2 l at worst). An lse off
# by 1e-4 moves every P by 1e-4 ln 2 = 6.9e-5 relatively, under 2% of the
# bf16 rounding u = 2^-8 that FLASH_BWD_TOL grants P. An lse that leaves
# the scale out of the running max, or is written in natural-log units,
# must fail (phase 8 plants both and checks).
FLASH_LSE_ATOL = 1e-4
# faults planted in copies of csrc/flash_attention.cu (bfloat16 kernel):
# (text that must occur once, text put in its place)
_BUF = "    const int buf = stage;  // the ring stage S(t) reads\n"
_SOFTMAX = ("    online_softmax(s, m, l, corr, a, t * kBKV, q_lo, row0, t4, "
            "cl);\n")
_PV = "    pv_tile<HD>(o, pa, v_tile(prev));  // O += P(t-1) V(t-1)\n"
_LSE = "            m[r] * cl + log2f(fmaxf(l[r], 1e-30f));\n"
FLASH_FAULTS = {
    # the middle tile's scores all masked: it adds nothing
    "skip_one_kv_tile": (_SOFTMAX, "    if (n_tiles > 2 && t == n_tiles / 2)"
                         "\n      for (int i = 0; i < kBKV / 2; ++i) s[i] = "
                         "neg_inf();\n" + _SOFTMAX),
    # O rounded to bf16 after each k16 step of P V
    "bf16_accumulator": (_PV, (
        "    for (int kk = 0; kk < kBKV / 16; ++kk) {\n"
        "      pv_step<HD>(o, pa[kk], v_tile(prev), kk);\n"
        "      wgmma_commit();\n"
        "      wgmma_wait0();\n"
        "      fence_regs(o);\n"
        "#pragma unroll\n"
        "      for (int i = 0; i < HD / 2; ++i)\n"
        "        o[i] = __bfloat162float(__float2bfloat16_rn(o[i]));\n"
        "      wgmma_fence();\n"
        "    }\n")),
    # S(t) reads K from the next ring stage (the tile in flight, or one
    # already consumed): a stale or not-yet-landed tile
    "stale_ring_stage": (_BUF, _BUF.replace("= stage;",
                                            "= (stage + 1) % kStages;")),
    # lse = m + log2(l): the running max of the raw scores, unscaled
    "lse_without_scale": (_LSE, _LSE.replace("m[r] * cl + ", "m[r] + ")),
    # lse = m c + ln(l): natural-log units
    "lse_natural_log": (_LSE, _LSE.replace(
        "m[r] * cl + log2f(fmaxf(l[r], 1e-30f));",
        "(m[r] * cl + log2f(fmaxf(l[r], 1e-30f))) * 0.69314718f;")),
}

# the backward kernel against its plain version (phase 21b), in FLASH_TOL's
# form: elementwise |got - want| <= atol + rtol (|want| + A), A the
# magnitudes of the terms the kernel rounds (P^T |dO| for dv, c |dS|^T |q|
# for dk, c |dS| |k| for dq), and the norm-relative error of every block of
# 64 rows of one (batch, head) at most ``block`` (A from
# ref.flash_attention_bwd_ref(magnitudes=True)). In phase 21b both sides
# take the same o and lse (the forward kernel's, each checked against the
# plain forward), so D = rowsum(dO o) is one function of the same bf16 o
# on both and o's rounding cancels; phase 21's card-vs-CPU check, whose CPU
# side runs its own forward, widens A by what o's rounding can move D
# (``o_err``). float32: the summation
# order alone, rtol 1e-5. bfloat16: the kernel rounds P (dV's operand) and
# dS (dK's and dQ's) to bf16 and each result once, each by at most u = 2^-8
# relatively: rtol 2u; per block 1e-2, about 3x the sqrt(2) u / sqrt(3) =
# 3.2e-3 that two independent roundings of uniform relative error give a
# block's norm. A q tile left out of dK/dV, D left out of dS, dK/dV from
# the first q head of each GQA group alone, lse read as a natural log, or
# one kv tile's dQ partials left out of the ordered sum must fail (phase
# 21b plants all five and checks).
FLASH_BWD_TOL = {"float32": (1e-5, 1e-5, None),
                 "bfloat16": (1e-5, 2 ** -7, 1e-2)}
# faults planted in copies of csrc/flash_attention_bwd.cu, as FLASH_FAULTS;
# the walk's (bf16 at hd <= 128, the qwen3 layer where they are planted)
_PACK_P = "    pack(pa, s);    // P^T: dV's A operand\n"
_DQ_ADD = ("        else bulk_reduce_add(dst, src, L::kDQBytes);   "
           "// the next in kv order\n")
FLASH_BWD_FAULTS = {
    # the middle step of each walk adds nothing (P and dS zero: to dV, dK
    # and dQ's partial)
    "skipped_q_tile": (_PACK_P, (
        "    if (n_steps > 2 && i == n_steps / 2)\n"
        "#pragma unroll\n"
        "      for (int e = 0; e < kBQ / 2; ++e) s[e] = dp[e] = 0.f;\n"
        + _PACK_P)),
    # dS = P dP
    "no_d": ("  return p * (dp - d);\n", "  return p * dp;\n"),
    # each walk over the first q head of its GQA group alone
    "first_head_only": (
        "  return hi - lo;   // the rank's q heads of the GQA group\n",
        "  return lo == 0 ? 1 : 0;\n"),
    # the forward's log2-unit lse converted as if it were a natural log
    "natural_lse": (
        "    lse2 = a.lse[static_cast<long long>(bh) * a.Sq + qi];   "
        "// log2 units\n",
        "    lse2 = a.lse[static_cast<long long>(bh) * a.Sq + qi] * kLog2e;\n"),
    # the middle kv tile's dQ partials left out of the ordered sum (its
    # count still moves on, so the kv tiles after it add theirs)
    "dropped_dq_partial": (_DQ_ADD, _DQ_ADD.replace(
        "        else ", "        else if (z != gridDim.z / 2) ")),
}

PREFILL_BATCH, PREFILL_SEQ, PREFILL_REPS = 4, 4096, 3
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 256, 32
# decode logits vs prefill logits of the full bfloat16 model, elementwise
# |decode - prefill| <= atol + rtol * |prefill|: both paths round every
# activation of 28 layers to bfloat16 (2^-8 relative) at other places, the
# bf16 analogue of tests/test_models.py's 2e-3 float32 bound
SERVE_GAP_ATOL, SERVE_GAP_RTOL = 0.1, 0.05
CARD_VS_CPU_TOL = 1e-4   # reduced float32 model: kernels vs plain versions
# mamba2-1.3b serving: decode_32k's batch of 128 (its float32 state, 13.2
# GB, fits one card), a prompt of two chunks of 256, and greedy tokens; the
# decode-vs-prefill gap is checked on the first 8 requests
SSM_SERVE_REQUESTS, SSM_SERVE_PROMPT, SSM_SERVE_NEW = 128, 512, 32
SSM_CHECK_REQUESTS = 8
# float32 decode vs float32 prefill of full mamba2-1.3b: atol = rtol, the
# bound of tests/test_models.py's decode-vs-forward test. Phase 10's bf16
# bound is reported for mamba2, not asserted: at 48 layers the bf16 gap is
# as large as the bf16 prefill's own distance to the float32 one, in the
# JAX package too (PERF.md, Findings)
SSM_GAP_F32 = 2e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# host-side deadline on a flash launch of phases 8 and 12: the kernel's
# mbarrier wait has no timeout, so a TMA copy that never lands would spin
# until an outside limit ends the run; a whole timed run of 20 launches
# takes well under a second
CARD_DEADLINE_S = 120.0


def await_card(phase: str, what: str,
               deadline_s: float = CARD_DEADLINE_S) -> None:
    """Wait for the work enqueued so far on the current stream by polling
    a CUDA event (``event.query()``) against a host-side deadline. On
    expiry print the phase's failing line and end the process at once with
    a non-zero code (``os._exit``: a stream that never drains would block
    a normal exit)."""
    import torch
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > deadline_s:
            emit(phase, ok=False, error=f"{what}: the card has not finished "
                 f"after {deadline_s} s")
            sys.stdout.flush()
            os._exit(1)
        time.sleep(1e-3)
    torch.cuda.synchronize()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# card cycles per microsecond of torch.cuda._sleep, at the H100's 1.98 GHz
# boost clock (a lower clock only lengthens the spin), and the host time a
# timed call may take to enqueue (the wrappers take 20-30 us)
SLEEP_CYCLES_PER_US = 1980
HOST_US_PER_CALL = 60
# phase 21b's times of the flash backward and SDPA's autograd backward:
# runs of each, taken in turns; back-to-back calls a run; the host time a
# call may take to enqueue (SDPA's autograd backward takes more than 60
# us, and was timed at the host's pace at whisper's small shapes)
BWD_TIMING_RUNS, BWD_TIMING_REPS, BWD_HOST_US = 3, 50, 500


def cuda_ms(fn, reps: int, warm: int = 1, guard: str | None = None,
            host_us: int = HOST_US_PER_CALL) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events).
    The card spins first for ``host_us`` microseconds per rep, so the host
    can enqueue every rep before the first runs: a call that is shorter on
    the card than on the host is timed at the card's rate, not the host's.
    With ``guard`` (the launches' name), every wait goes through
    :func:`await_card` under the ``kernel`` phase."""
    import torch

    def wait():
        if guard is None:
            torch.cuda.synchronize()
        else:
            await_card("kernel", guard)

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    wait()
    torch.cuda._sleep(reps * host_us * SLEEP_CYCLES_PER_US)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    wait()
    return start.elapsed_time(stop) / reps


def ptxas_report(log: str) -> dict:
    """Registers and spills per kernel instantiation, from nvcc -Xptxas -v
    (golden_section: its two kernels, ``warp_per_group`` and
    ``block_per_group``;
    hier_aggregate<T, V>: element type, elements per thread; rmsnorm<T,
    V, K>: element type, elements per load, vectors per lane held in
    registers; flash_fwd_<type><HD>: input type, head dim;
    ssd_scan_kernel<T>: states type)."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            mangled = entry.group(1)
            v = re.search(r"kernelI(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?",
                          mangled)
            f = re.search(r"flash_fwd_(bf16|f32)ILi(\d+)E", mangled)
            fb = re.search(r"flash_bwd_(pre|dq|dkdv|walk|post_dq|post_kv)"
                           r"(?:_(bf16|f32))?I"
                           r"(f|13__nv_bfloat16)?Li(\d+)E(?:Lb(\d)ELb(\d)E)?",
                           mangled)
            sc = re.search(r"ssd_scan_kernelI(f|13__nv_bfloat16)E", mangled)
            name = ("warp_per_group" if "golden_section_kernel" in mangled
                    else "block_per_group"
                    if "golden_section_wide_kernel" in mangled
                    else f"T={'f32' if v.group(1) == 'f' else 'bf16'},"
                    f"V={v.group(2)}"
                    + (f",K={v.group(3)}" if v.group(3) else "") if v else
                    f"{f.group(1)},HD={f.group(2)}" if f else
                    bwd_kernel_name(*fb.groups()) if fb else
                    f"T={'f32' if sc.group(1) == 'f' else 'bf16'}" if sc else
                    mangled)
            out[name] = []
        elif name and re.search(r"registers|spill", line):
            out[name].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def bwd_kernel_name(kind, dtype, pre_type, hd, dv, dk) -> str:
    """ptxas_report's key of a flash_attention_bwd.cu instantiation: its
    kernel (pre, dq, dkdv, walk, post_dq, post_kv), type and head dim, and
    for dkdv the gradients it computes."""
    dtype = dtype or ("f32" if pre_type == "f" else "bf16")
    grads = "" if dv is None else "," + "+".join(
        name for name, on in (("dv", dv), ("dk", dk)) if on == "1")
    return f"{kind} {dtype},HD={hd}{grads}"


def groups_not_bitwise(got, want) -> int:
    """Groups whose f, beta, cost or deadline differ from the plain
    version's in any bit."""
    import torch

    def differ(x, y):
        d = x.view(torch.int32) != y.view(torch.int32)
        return d.any(-1) if d.dim() == 2 else d

    return int(torch.stack([differ(x, y) for x, y in zip(got, want)]).any(0)
               .sum())


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


def l2_flush(dev):
    """A call that reads 64 MiB (more than the 50 MB L2) and writes one
    number, so the L2 holds other, clean lines before a cold launch."""
    import torch
    buf = torch.ones(64 * 2**20 // 4, device=dev)
    return lambda: buf.sum()


def cuda_ms_cold(fn, reps: int, flush, guard: str | None = None) -> float:
    """Mean milliseconds of ``fn()`` alone, with ``flush`` (see
    :func:`l2_flush`) run before each launch outside the timed span. A spin
    of the card (0.1 ms) after the flush keeps the card busy while the host
    enqueues ``fn``, so the span holds the kernel and not the host's
    latency in reaching it. ``guard`` as in :func:`cuda_ms`."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        flush()
        torch.cuda._sleep(100 * SLEEP_CYCLES_PER_US)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        if guard is None:
            torch.cuda.synchronize()
        else:
            await_card("kernel", guard)
        total += start.elapsed_time(stop)
    return total / reps


def bound_ms(ops: int, nbytes: int,
             peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak_flops, nbytes / PEAK_BYTES_S
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


def profiled(phase: str, fn):
    """``fn()`` under ``torch.profiler``: (wall seconds, [(kernel name,
    device microseconds, count)]) of the card's events. A failure of the
    profiler itself is reported on the phase's line and gives None; an
    error raised by ``fn`` (a kernel launch, say) fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except (RuntimeError, AttributeError) as exc:
        emit(phase, error=repr(exc))
        return None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    except BaseException:
        try:
            prof.stop()
        except (RuntimeError, AttributeError):
            pass
        raise
    try:
        prof.stop()
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if "CUDA" in str(e.device_type)]
    except (RuntimeError, AttributeError) as exc:
        emit(phase, error=repr(exc))
        return None
    return wall_s, rows


def profile_round(trainer, assignment, n_servers, n_local, n_edge) -> None:
    """One more HFEL round under ``torch.profiler``: device time by kernel
    and the device's idle share of the round (profiler on)."""
    run = profiled("train_profile", lambda: trainer.hfel_round(
        assignment, n_servers, n_local, n_edge))
    if run is None:
        return
    round_s, rows = run
    busy_s = sum(us for _, us, _ in rows) / 1e6
    rows.sort(key=lambda x: -x[1])
    emit("train_profile", round_s=round_s, device_busy_s=busy_s,
         idle_share=1.0 - busy_s / round_s, n_device_events=len(rows),
         top=[dict(name=name[:80], ms=us / 1e3, count=cnt)
              for name, us, cnt in rows[:10]])


def attention_work(b, sq, skv, hq, hkv, hd, causal, itemsize):
    """Operations and bytes of one attention forward: QK^T and PV over the
    visible (q, kv) pairs, 2 operations per multiply-add (the exponentials
    of the softmax are not counted); q, k, v read once, o written once."""
    if causal:   # kv_pos <= q_pos, top-left
        pairs = sum(min(i + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    ops = 2 * 2 * b * hq * hd * pairs
    nbytes = itemsize * hd * (2 * b * sq * hq + 2 * b * skv * hkv)
    return ops, nbytes


def flash_error(got, want, want_abs, dtype: str,
                tol: tuple | None = None) -> tuple[dict, bool]:
    """A flash-attention output against the float32 plain version ``want``
    (and ``want_abs``, the plain version over |v|) under ``tol`` (by
    default :data:`FLASH_TOL`'s): the error measures, and whether it
    passes. The scale is |want|, plus ``want_abs`` where one is given
    (the forward's bf16 checks, and the backward's ``FLASH_BWD_TOL``)."""
    import torch
    import torch.nn.functional as F
    atol, rtol, block_limit = tol or FLASH_TOL[dtype]
    err = (got.float() - want).abs()
    scale = want.abs() if want_abs is None else want.abs() + want_abs
    share = float((err / (atol + rtol * scale)).max())
    b, s, h, d = want.shape
    pad = (0, 0, 0, 0, 0, (-s) % FLASH_ROWS)

    def block_norm(x):
        return F.pad(x.square(), pad).view(b, -1, FLASH_ROWS, h, d).sum(
            (2, 4)).sqrt()

    block_rel = float((block_norm(err)
                       / block_norm(want).clamp_min(1e-30)).max())
    ok = (bool(torch.isfinite(got.float()).all()) and share <= 1.0
          and (block_limit is None or block_rel <= block_limit))
    return dict(tolerance=dict(atol=atol, rtol=rtol,
                               scale="|want|" if want_abs is None
                               else "|want| + P|V|",
                               max_block_rel_err=block_limit),
                max_abs_err=float(err.max()), limit_share=share,
                max_block_rel_err=block_rel), ok


def lse_error(got, want) -> tuple[dict, bool]:
    """The forward's logsumexp against the plain version's, computed in
    float32 on the same inputs, under ``FLASH_LSE_ATOL`` (log2 units): the
    largest difference, and whether it passes."""
    import torch
    err = float((got - want).abs().max())
    return dict(lse_max_abs_err=err, lse_atol=FLASH_LSE_ATOL), (
        bool(torch.isfinite(got).all()) and err <= FLASH_LSE_ATOL)


def build_flash_fault(directory: str, name: str,
                      kernel: str = "flash_attention"):
    """A copy of ``csrc/<kernel>.cu`` (``flash_attention`` or
    ``flash_attention_bwd``) with the fault ``FLASH_FAULTS[name]`` or
    ``FLASH_BWD_FAULTS[name]`` planted, built with the kernel's own flags
    into ``directory`` and loaded; returns the bound library."""
    import ctypes

    from repro_torch.kernels import build, flash_attention
    forward = kernel == "flash_attention"
    old, new = (FLASH_FAULTS if forward else FLASH_BWD_FAULTS)[name]
    text = (build.CSRC / f"{kernel}.cu").read_text()
    if text.count(old) != 1:
        raise AssertionError(f"fault {name}: its anchor is not in the source "
                             "exactly once")
    src = Path(directory) / f"{kernel}_{name}.cu"
    src.write_text(text.replace(old, new))
    out = src.with_suffix(".so")
    proc = subprocess.run([build.nvcc_path(), *build.nvcc_flags(kernel),
                           "-o", str(out), str(src)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on fault {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    return flash_attention.bind(lib) if forward else flash_attention.bind_bwd(
        lib)


def sdpa(q, k, v, causal: bool) -> tuple[float, str]:
    """``scaled_dot_product_attention``'s ms on the (B, H, S, hd) views of
    the same tensors, GQA through ``enable_gqa`` (kv repeated beforehand on
    a torch without it), and the call's name."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    name = ("torch.nn.functional.scaled_dot_product_attention"
            f"(is_causal={causal}")
    if q.shape[2] == k.shape[2]:
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=20), name + ")"
    try:
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True),
            reps=20), name + ", enable_gqa=True)"
    except TypeError:      # a torch without enable_gqa
        g = q.shape[2] // k.shape[2]
        kr, vr = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kr, vr, is_causal=causal), reps=20), (
            name + ") on kv repeated beforehand")


def flash_case(gen, case: str, shape: tuple, dtype, causal: bool, *,
               fault_libs: dict | None = None, flush=None,
               report: str | None = None) -> dict:
    """The flash kernel on random inputs of ``shape`` (B, Sq, Skv, Hq, Hkv,
    hd) against its plain version in float32 under ``FLASH_TOL``, and the
    rows' logsumexp it writes for the backward under ``FLASH_LSE_ATOL``
    (raises otherwise); ``fault_libs``' planted faults must fail one of
    the two. With
    ``flush``, warm and L2-cold times, the plain version's and SDPA's, the
    bound and its share, TFLOP/s and ``report`` (ptxas). Returns the
    ``kernel`` line's fields for the caller to emit."""
    import torch
    from repro_torch.kernels import flash_attention, ref
    b, sq, skv, hq, hkv, hd = shape
    dev = gen.device
    q = torch.randn(b, sq, hq, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, skv, hkv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, skv, hkv, hd, generator=gen, device=dev).to(dtype)
    guard = f"flash_attention {case}"
    got, lse = flash_attention.flash_attention(q, k, v, causal=causal,
                                               return_lse=True)
    await_card("kernel", guard)
    want, want_lse = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                             causal=causal, return_lse=True)
    tname = str(dtype).removeprefix("torch.")
    want_abs = None if dtype == torch.float32 else ref.flash_attention_ref(
        q.float(), k.float(), v.float().abs(), causal=causal)
    measures, ok = flash_error(got, want, want_abs, tname)
    lse_measures, lse_ok = lse_error(lse, want_lse)
    fields = dict(kernel="flash_attention", case=case, shape=list(shape),
                  dtype=tname, causal=causal, **measures, **lse_measures)
    if not (ok and lse_ok):
        emit("kernel", **fields)
        raise AssertionError(f"flash_attention {case} disagrees with its "
                             "plain version")
    for fault, lib in (fault_libs or {}).items():
        bad, bad_lse = flash_attention.launch(q, k, v, causal, lib,
                                              return_lse=True)
        await_card("fault", f"flash_attention {case} fault {fault}")
        f_measures, passed = flash_error(bad, want, want_abs, tname)
        l_measures, l_passed = lse_error(bad_lse, want_lse)
        caught = not (passed and l_passed)
        emit("fault", kernel="flash_attention", fault=fault, case=case,
             caught=caught, **f_measures, **l_measures)
        if not caught:
            raise AssertionError(f"the tolerance lets the planted fault "
                                 f"{fault} pass at {case}")
        del bad, bad_lse
    del got, lse, want, want_lse, want_abs
    if flush is not None:
        ops, nbytes = attention_work(b, sq, skv, hq, hkv, hd, causal,
                                     q.element_size())
        b_ms, b_by = bound_ms(ops, nbytes, PEAK_BF16_FLOPS)
        k_ms = cuda_ms(lambda: flash_attention.flash_attention(
            q, k, v, causal=causal), reps=20, guard=guard)
        lib_ms, lib_name = sdpa(q, k, v, causal)
        fields.update(
            ms=k_ms, ms_cold_l2=cuda_ms_cold(
                lambda: flash_attention.flash_attention(
                    q, k, v, causal=causal), 10, flush, guard=guard),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal), reps=3),
            library_ms=lib_ms, library=lib_name,
            library_share=lib_ms / k_ms, operations=ops, bytes=nbytes,
            peak_flops=PEAK_BF16_FLOPS, bound_ms=b_ms, bound_by=b_by,
            bound_share=b_ms / k_ms, tflops=ops / (k_ms * 1e-3) / 1e12,
            ptxas=report)
    return fields


def bwd_work(b, sq, skv, hq, hkv, hd, causal):
    """Operations and bytes of one attention backward: the five products
    (S, dP, dV, dK, dQ) over the visible pairs, 2 operations a
    multiply-add; q, k, v, o, dO (bf16) and lse read once, dq, dk, dv
    written once."""
    ops, _ = attention_work(b, sq, skv, hq, hkv, hd, causal, 2)
    nbytes = 2 * hd * (4 * b * sq * hq + 4 * b * skv * hkv) + 4 * b * hq * sq
    return ops * 5 // 2, nbytes


def bwd_error(got, want, mags, dtype: str) -> tuple[dict, bool]:
    """(dq, dk, dv) against the plain version under ``FLASH_BWD_TOL``:
    each gradient's measures, the largest error, and whether all pass."""
    errs, ok = {}, True
    for name, a, w, m in zip(("dq", "dk", "dv"), got, want, mags):
        e, passed = flash_error(a, w, m, dtype, FLASH_BWD_TOL[dtype])
        errs[name] = {key: e[key] for key in ("max_abs_err", "limit_share",
                                              "max_block_rel_err")}
        ok = ok and passed
    return dict(tolerance=dict(zip(("atol", "rtol", "max_block_rel_err"),
                                   FLASH_BWD_TOL[dtype]),
                               scale="|want| + A"),
                max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                errors=errs), ok


def flash_bwd_case(gen, case: str, shape: tuple, dtype, causal: bool, *,
                   scale=None, v_cols=None, fault_libs=None,
                   timed: bool = False) -> dict:
    """The backward kernel on random inputs of ``shape`` (B, Sq, Skv, Hq,
    Hkv, hd), with o and lse from the forward kernel, against its plain
    version in float32 under ``FLASH_BWD_TOL``, and that lse against the
    plain forward's under ``FLASH_LSE_ATOL`` (raises otherwise; v and the
    cotangent zero past ``v_cols``, as MLA pads them); ``fault_libs``'
    planted faults must fail there. With ``timed``: the kernel's ms and
    the library call's backward's (SDPA's autograd backward at the same
    scale), each the median of ``BWD_TIMING_RUNS`` device-time runs taken
    in turns, with every run and the spread; the bound (and at v's useful
    columns); the launch plan; and that two runs give the same bits
    (raises otherwise). Returns the line's fields."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, sq, skv, hq, hkv, hd = shape
    dev = gen.device

    def randn(*dims):
        return torch.randn(*dims, generator=gen, device=dev).to(dtype)

    q, g = randn(b, sq, hq, hd), randn(b, sq, hq, hd)
    k, v = randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)
    if v_cols is not None:
        v[..., v_cols:] = 0
        g[..., v_cols:] = 0
    guard = f"flash_attention_bwd {case}"
    o, lse = fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                return_lse=True)
    got = fa.flash_attention_backward(q, k, v, o, lse, g, causal=causal,
                                      scale=scale)
    await_card("kernel", guard)
    want, mags = ref.flash_attention_bwd_ref(
        *(x.float() for x in (q, k, v, o, lse, g)), causal=causal,
        scale=scale, magnitudes=True)
    tname = str(dtype).removeprefix("torch.")
    measures, ok = bwd_error(got, want, mags, tname)
    lse_measures, lse_ok = lse_error(lse, ref.flash_attention_ref(
        q.float(), k.float(), v.float(), causal=causal, scale=scale,
        return_lse=True)[1])
    fields = dict(kernel="flash_attention_bwd", case=case, shape=list(shape),
                  dtype=tname, causal=causal, scale=scale, v_cols=v_cols,
                  **measures, **lse_measures)
    if not (ok and lse_ok):
        emit("kernel", **fields)
        raise AssertionError(f"flash_attention_bwd {case} disagrees with "
                             "its plain version")
    for fault, lib in (fault_libs or {}).items():
        bad = fa.launch_bwd(q, k, v, o, lse, g, causal, lib, scale)
        await_card("fault", f"flash_attention_bwd {case} fault {fault}")
        f_measures, passed = bwd_error(bad, want, mags, tname)
        emit("fault", kernel="flash_attention_bwd", fault=fault, case=case,
             caught=not passed, **f_measures)
        if passed:
            raise AssertionError(f"the tolerance lets the planted fault "
                                 f"{fault} pass at {case}")
        del bad
    del want, mags
    if timed:
        ops, nbytes = bwd_work(b, sq, skv, hq, hkv, hd, causal)
        b_ms, b_by = bound_ms(ops, nbytes, PEAK_BF16_FLOPS)
        again = fa.flash_attention_backward(q, k, v, o, lse, g,
                                            causal=causal, scale=scale)
        await_card("kernel", guard)
        fields["bitwise_repeatable"] = all(bool(torch.equal(x, y))
                                           for x, y in zip(got, again))
        del again
        if not fields["bitwise_repeatable"]:
            emit("kernel", **fields)
            raise AssertionError(f"flash_attention_bwd {case}: two runs "
                                 "give different bits")
        plan = fa.bwd_plan(b, sq, skv, hq, hkv, hd, causal, dtype,
                           torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
        kernel = lambda: fa.flash_attention_backward(  # noqa: E731
            q, k, v, o, lse, g, causal=causal, scale=scale)
        library = library_bwd_fn(
            lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(
                q_, k_, v_, is_causal=causal, enable_gqa=hq != hkv,
                scale=scale), [x.transpose(1, 2) for x in (q, k, v)],
            g.transpose(1, 2))
        k_runs, lib_runs = [], []
        for _ in range(BWD_TIMING_RUNS):   # in turns, device time
            k_runs.append(cuda_ms(kernel, reps=BWD_TIMING_REPS, guard=guard,
                                  host_us=BWD_HOST_US))
            lib_runs.append(cuda_ms(library, reps=BWD_TIMING_REPS,
                                    host_us=BWD_HOST_US))
        del library
        k_ms, lib_ms = statistics.median(k_runs), statistics.median(lib_runs)
        fields.update(
            ms=k_ms, ms_runs=k_runs, ms_spread=max(k_runs) / min(k_runs) - 1,
            library_ms=lib_ms, library_ms_runs=lib_runs,
            library_ms_spread=max(lib_runs) / min(lib_runs) - 1,
            library="scaled_dot_product_"
            f"attention(is_causal={causal}, enable_gqa={hq != hkv}), its "
            "autograd backward", library_share=lib_ms / k_ms,
            operations=ops, bytes=nbytes, peak_flops=PEAK_BF16_FLOPS,
            bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / k_ms,
            tflops=ops / (k_ms * 1e-3) / 1e12,
            plan=dict(walk=plan.walk, split=plan.split, grid=plan.grid,
                      longest=plan.longest, balanced=plan.balanced,
                      scratch_bytes=plan.stats_bytes + plan.dq_acc_bytes
                      + plan.sem_bytes + plan.kv_part_bytes))
        if v_cols is not None:   # dV and dP over v's useful columns
            ops_v = ops * (3 * hd + 2 * v_cols) // (5 * hd)
            fields["bound_ms_v_cols"] = bound_ms(ops_v, nbytes,
                                                 PEAK_BF16_FLOPS)[0]
    return fields


# the walk's own counters (csrc/flash_attention_bwd.cu's ProfSlot order,
# the build with -DFLASH_BWD_PROFILE): cycles by phase of one thread of
# each consumer and of writer 0 a block, summed over the blocks
BWD_COUNTER_SLOTS = ("setup", "walk", "full", "sdp", "softmax", "grads",
                     "half", "stage", "epilogue", "writer", "dq_full",
                     "count", "bulk", "steps")


def bwd_counters(counters_lib, q, k, v, o, lse, g, causal: bool,
                 scale) -> dict:
    """Where a walk's time goes: its counters from one launch of
    ``counters_lib``, the consumer's phases as shares of its block time
    (setup + walk + epilogue), the writer's as shares of its own, and
    block cycles a step; empty where the call runs no walk (hd 192)."""
    import ctypes

    import torch
    from repro_torch.kernels import flash_attention as fa
    fn = counters_lib.flash_attention_bwd_profile
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_ulonglong * len(BWD_COUNTER_SLOTS))()

    def read():
        rc = fn(ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"flash_attention_bwd_profile failed: {rc}")
        return dict(zip(BWD_COUNTER_SLOTS, out))

    result = {}
    torch.cuda.synchronize()
    read()                                        # cleared
    fa.launch_bwd(q, k, v, o, lse, g, causal, counters_lib, scale)
    await_card("kernel", "flash_attention_bwd counters")
    c = read()
    if c["steps"]:
        block = c["setup"] + c["walk"] + c["epilogue"]
        result.update(
            block_cycles_per_step=block / c["steps"],
            consumer={key: c[key] / block for key in BWD_COUNTER_SLOTS[:9]},
            writer={key: c[key] / c["writer"]
                    for key in ("dq_full", "count", "bulk")})
    return result


def flash_bwd_kernels(dev, fault_libs: dict, ptxas: dict,
                      counters_lib=None) -> dict:
    """Phase 21b: the backward kernel against its plain version on the
    card under ``FLASH_BWD_TOL``, and the forward's lse against the plain
    forward's under ``FLASH_LSE_ATOL``, at every attention shape of the
    train paths in bf16, with its ms, bound and SDPA's backward: qwen3-0.6b's
    layer (4 x 4096, 16/8 heads of 128, causal; the four planted faults
    rejected there, the plain version's and the whole recompute's ms),
    deepseek-v2-lite's MLA (16 heads at hd 192, scale 192^-0.5, v padded
    from 128), internvl2-1b's (256 + 4096 positions, 14/2 heads of 64) at
    the sync batch and a pod's, whisper-large-v3's encoder (1500 frames,
    non-causal), cross attention (448 over 1500) and decoder (448,
    causal), 20 heads of 64; then float32 at small shapes of every head
    dim (ragged, GQA, Sq != Skv). Registers and spills of the bf16
    instantiations (asserted spill-free). With ``counters_lib`` (the build
    with the walk's counters), each bf16 line's ``counters``
    (:func:`bwd_counters`). Returns the lines by case."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(21)
    bf16, f32 = torch.bfloat16, torch.float32
    vlm = VLM_PREFIX + TRAIN_SEQ
    cases = [
        ("qwen3_layer", (TRAIN_SYNC_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 8, 128),
         True, {}),
        ("deepseek_layer", (MOE_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16,
                            192), True, dict(scale=192 ** -0.5, v_cols=128)),
        ("internvl2_layer", (VLM_TRAIN_BATCH, vlm, vlm, 14, 2, 64), True, {}),
        ("internvl2_pod", (TRAIN_PER_POD, vlm, vlm, 14, 2, 64), True, {}),
        ("whisper_encoder", (ENCDEC_TRAIN_BATCH, 1500, 1500, 20, 20, 64),
         False, {}),
        ("whisper_cross", (ENCDEC_TRAIN_BATCH, ENCDEC_DEC_SEQ, 1500, 20, 20,
                           64), False, {}),
        ("whisper_decoder", (ENCDEC_TRAIN_BATCH, ENCDEC_DEC_SEQ,
                             ENCDEC_DEC_SEQ, 20, 20, 64), True, {})]
    out = {}
    for case, shape, causal, extra in cases:
        first = case == "qwen3_layer"
        fields = flash_bwd_case(gen, case, shape, bf16, causal, timed=True,
                                fault_libs=fault_libs if first else None,
                                **extra)
        hd = shape[-1]
        fields["ptxas"] = {key: r for key, r in ptxas.items()
                           if key.endswith(f"bf16,HD={hd}") or
                           f" bf16,HD={hd}," in key}
        if counters_lib is not None:
            b, sq, skv, hq, hkv, _ = shape
            ins = [torch.randn(b, n, h, hd, generator=gen, device=dev).to(bf16)
                   for n, h in ((sq, hq), (skv, hkv), (skv, hkv), (sq, hq))]
            o, lse = fa.flash_attention(*ins[:3], causal=causal,
                                        scale=extra.get("scale"),
                                        return_lse=True)
            fields["counters"] = bwd_counters(
                counters_lib, *ins[:3], o, lse, ins[3], causal,
                extra.get("scale"))
            del ins, o, lse
        if first:
            b, s, _, hq, hkv, _ = shape
            q, g = (torch.randn(b, s, hq, hd, generator=gen, device=dev)
                    .to(bf16) for _ in range(2))
            k, v = (torch.randn(b, s, hkv, hd, generator=gen, device=dev)
                    .to(bf16) for _ in range(2))
            o, lse = fa.flash_attention(q, k, v, return_lse=True)
            fields.update(
                plain_ms=cuda_ms(lambda: ref.flash_attention_bwd_ref(
                    q, k, v, o, lse, g), reps=2),
                recompute_ms=cuda_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, g), reps=2))
            del q, k, v, g, o, lse
        emit("kernel", **fields)
        out[case] = fields
    for hd in fa.HEAD_DIMS:
        for shape, causal in (((2, 200, 200, 4, 2, hd), True),
                              ((1, 77, 150, 2, 1, hd), False),
                              ((1, 150, 77, 2, 2, hd), True)):
            emit("kernel", **flash_bwd_case(gen, f"f32_hd{hd}", shape, f32,
                                            causal))
    bf16_reports = {key: r for key, r in ptxas.items() if " bf16," in key}
    if not bf16_reports or not all(spill_free(r)
                                   for r in bf16_reports.values()):
        raise AssertionError(f"the bf16 backward spills: {bf16_reports}")
    return out


def rmsnorm_decode_split(x, scale, calls: int = 200) -> dict:
    """Host and device microseconds per ``rmsnorm`` call at a small shape:
    the host clock around ``calls`` enqueues (no synchronize between them),
    and the kernel's device time per launch under ``torch.profiler``
    (None when the profiler gives none)."""
    import torch
    from repro_torch.kernels import rmsnorm
    rmsnorm.rmsnorm(x, scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        rmsnorm.rmsnorm(x, scale)
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    run = profiled("kernel", lambda: [rmsnorm.rmsnorm(x, scale)
                                      for _ in range(calls)])
    device_us = None
    if run is not None:
        spans = [(us, cnt) for name, us, cnt in run[1]
                 if "rmsnorm_kernel" in name]
        if spans:
            device_us = sum(us for us, _ in spans) / sum(c for _, c in spans)

    def stream_in_device_scope():        # the wrapper's lookup before
        with torch.cuda.device(x.device):
            return torch.cuda.current_stream().cuda_stream

    lookups = {"device_scope": stream_in_device_scope,
               "current_stream": lambda: torch.cuda.current_stream(
                   x.device).cuda_stream,
               "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
                   x.device.index)}
    lookup_us = {}
    for name, fn in lookups.items():
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        lookup_us[name] = 1e6 * (time.perf_counter() - t0) / calls
    return dict(host_us_per_call=host_us, device_us_per_call=device_us,
                stream_lookup_us=lookup_us, calls=calls)


def rmsnorm_case(gen, case: str, rows: int, d: int, dtype, flush,
                 ptxas: dict, timed: bool):
    """The rmsnorm kernel on random (rows, d) ``dtype`` input against its
    plain version, bit for bit (raises otherwise); ``timed`` adds warm and
    L2-cold times, the plain version's and ``F.rms_norm``'s, the bound and
    the instantiation's ptxas report. Returns (fields, x, scale)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, rmsnorm
    dev = gen.device
    x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    got = rmsnorm.rmsnorm(x, scale)
    torch.cuda.synchronize()
    vec = rmsnorm.vector_width(d, dtype)
    want = ref.rmsnorm_ref(x, scale, vec=vec)
    err = float((got.float() - want.float()).abs().max())
    fields = dict(kernel="rmsnorm", case=case, shape=[rows, d],
                  dtype=str(dtype).removeprefix("torch."), vector_width=vec,
                  held_vectors=rmsnorm.held_vectors(d, vec),
                  tolerance="bitwise", max_abs_err=err)
    if not (torch.equal(got, want) and torch.isfinite(got.float()).all()):
        emit("kernel", **fields)
        raise AssertionError(f"rmsnorm {case} {rows}x{d} disagrees with its "
                             "plain version")
    if timed:
        nbytes = 2 * rows * d * x.element_size() + d * 4
        b_ms, b_by = bound_ms(4 * rows * d, nbytes)
        k_ms = cuda_ms(lambda: rmsnorm.rmsnorm(x, scale), reps=100)
        w = scale.to(dtype)
        lib = getattr(F, "rms_norm", None)      # torch 2.4 and later
        fields.update(
            ms=k_ms, ms_cold_l2=cuda_ms_cold(
                lambda: rmsnorm.rmsnorm(x, scale), 50, flush),
            plain_ms=cuda_ms(lambda: ref.rmsnorm_ref(x, scale, vec=vec),
                             reps=5),
            library_ms=None if lib is None else cuda_ms(
                lambda: lib(x, (d,), w, 1e-6), reps=100),
            library_ms_cold_l2=None if lib is None else cuda_ms_cold(
                lambda: lib(x, (d,), w, 1e-6), 50, flush),
            library="torch.nn.functional.rms_norm(x, (d,), scale, 1e-6)",
            bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
            bound_share=b_ms / k_ms,
            ptxas=ptxas.get(f"T={'f32' if dtype == torch.float32 else 'bf16'}"
                            f",V={vec},K={fields['held_vectors']}"))
    return fields, x, scale


def serving_kernels(dev, fault_libs: dict, ptxas: dict) -> dict:
    """Phase 8: rmsnorm and flash_attention against their plain versions
    at the serving path's shapes and at ragged ones, with warm and
    L2-cold times at the main shapes beside each kernel's ptxas report
    (``ptxas``, from phase 2), rmsnorm's host and device time per call at
    the decode shape, and the flash kernel's planted faults
    (``fault_libs``) against the same tolerance at the layer shape.
    Returns the main shapes' fields for the kernels line."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    flush = l2_flush(dev)
    main = {}
    for case, rows, d, dtype in (("prefill", PREFILL_BATCH * PREFILL_SEQ,
                                  1024, bf16),
                                 ("decode", SERVE_REQUESTS, 1024, bf16),
                                 ("ragged", 5, 37, f32),
                                 ("ragged", 3, 3584, f32),
                                 ("ragged", 7, 1030, bf16),
                                 ("prefill_f32", 4096, 1024, f32)):
        fields, x, scale = rmsnorm_case(gen, case, rows, d, dtype, flush,
                                        ptxas["rmsnorm"],
                                        timed=case in ("prefill", "decode"))
        if case == "decode":    # host-bound: the wrapper's cost apart
            fields.update(rmsnorm_decode_split(x, scale))
        if case in ("prefill", "decode"):
            main.setdefault("rmsnorm", fields)
        emit("kernel", **fields)

    for case, b, sq, skv, hq, hkv, hd, dtype, causal in (
            ("layer", PREFILL_BATCH, PREFILL_SEQ, PREFILL_SEQ, 16, 8, 128,
             bf16, True),
            ("gqa_ragged", 2, 1000, 1000, 8, 2, 64, f32, True),
            ("full", 2, 777, 777, 4, 4, 128, bf16, False),
            ("top_left", 1, 300, 700, 4, 2, 16, f32, True),
            ("serve_prompt", SERVE_REQUESTS, SERVE_PROMPT, SERVE_PROMPT, 16,
             8, 128, bf16, True)):
        layer = case == "layer"
        fields = flash_case(gen, case, (b, sq, skv, hq, hkv, hd), dtype,
                            causal, fault_libs=fault_libs if layer else None,
                            flush=flush if layer else None,
                            report=ptxas["flash_attention"].get(
                                f"bf16,HD={hd}"))
        if layer:
            main["flash_attention"] = fields
        emit("kernel", **fields)
    return main


def init_timed(model, dev) -> tuple:
    """``model.init_serving`` from seed 0 on the card: (params, seconds,
    peak bytes above what was allocated before, parameters, bytes)."""
    import torch
    from repro_torch.utils import tree_leaves
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init_serving(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    return (params, init_s, torch.cuda.max_memory_allocated() - base,
            sum(p.numel() for p in leaves),
            sum(p.numel() * p.element_size() for p in leaves))


def timed_forwards(model, params, batch) -> tuple:
    """A warm-up forward, then ``PREFILL_REPS`` forwards counted: (seconds
    of each, {kernel: launches} of flash_attention, rmsnorm and
    ssd_state_scan, peak bytes, the last logits)."""
    import torch
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    kernels = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
               "ssd_state_scan": ssd_scan}
    model.logits(params, batch)                      # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for module in kernels.values():
        module.LAUNCHES = 0
    times, logits = [], None
    for _ in range(PREFILL_REPS):
        del logits                          # one logits tensor at a time
        t0 = time.perf_counter()
        logits = model.logits(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (times, {k: m.LAUNCHES for k, m in kernels.items()},
            torch.cuda.max_memory_allocated(), logits)


def profile_forward(model, params, batch,
                    phase: str = "prefill_profile") -> None:
    """One more forward under ``torch.profiler``: device time of the flash,
    ssd_scan and rmsnorm kernels, the GEMMs (float32 ones apart), for a
    MoE model its dispatch (top-k, sort, search, scatter and gather
    kernels), and the rest, and the device's idle share of the forward
    (profiler on)."""
    gemm = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|sm90_", re.I)
    f32_gemm = re.compile(r"sgemm|f32f32|fp32|tf32", re.I)
    dispatch = re.compile(r"sort|radix|searchsorted|topk|index|scatter|"
                          r"gather", re.I)
    run = profiled(phase, lambda: model.logits(params, batch))
    if run is None:
        return
    wall_s, rows = run
    split = {"flash_attention": 0.0, "ssd_state_scan": 0.0, "gemm": 0.0,
             "gemm_f32": 0.0, "rmsnorm": 0.0, "other": 0.0}
    if model.cfg.moe is not None:
        split["moe_dispatch"] = 0.0
    for name, us, _ in rows:
        key = ("flash_attention" if "flash_fwd" in name else
               "ssd_state_scan" if "ssd_scan_kernel" in name else
               "rmsnorm" if "rmsnorm_kernel" in name else
               ("gemm_f32" if f32_gemm.search(name) else "gemm")
               if gemm.search(name) else
               "moe_dispatch" if "moe_dispatch" in split
               and dispatch.search(name) else "other")
        split[key] += us / 1e3
    busy_ms = sum(split.values())
    rows.sort(key=lambda x: -x[1])
    emit(phase, arch=model.cfg.name, wall_ms=1e3 * wall_s,
         device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / (1e3 * wall_s), device_ms=split,
         share={k: v / busy_ms for k, v in split.items()} if busy_ms else {},
         top=[dict(name=name[:80], ms=us / 1e3, count=cnt)
              for name, us, cnt in rows[:12]])


def profile_decode(model, params, prompts, max_len: int,
                   phase: str = "serve_profile", frames=None) -> None:
    """Two serve steps under ``torch.profiler``, after a few warm steps on
    a fresh cache of ``max_len`` positions (an encoder-decoder's encodes
    ``frames``): wall and device time per step, device kernels per step
    and the idle share (profiler on)."""
    from repro_torch.launch.steps import make_serve_step
    step = make_serve_step(model).step_fn
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    cache = model.decode_init(params, batch, max_len)
    state = {"tok": prompts[:, 0], "cache": cache}
    for t in range(4):
        state["tok"], state["cache"] = step(params, state["cache"],
                                            prompts[:, t])
    n = 2

    def steps():
        for _ in range(n):
            state["tok"], state["cache"] = step(params, state["cache"],
                                                state["tok"])

    run = profiled(phase, steps)
    if run is None:
        return
    wall_s, rows = run
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    rows.sort(key=lambda x: -x[1])
    emit(phase, arch=model.cfg.name, steps=n, wall_ms_per_step=1e3 * wall_s / n,
         device_busy_ms_per_step=busy_ms / n,
         idle_share=1.0 - busy_ms / (1e3 * wall_s),
         device_kernels_per_step=sum(c for _, _, c in rows) / n,
         top=[dict(name=name[:80], ms=us / 1e3 / n, count=cnt / n)
              for name, us, cnt in rows[:8]])


def serving_paths(dev) -> dict:
    """Phases 9 and 10: the prefill and serve paths of full-size
    qwen3-0.6b on the card. Returns the kernels' launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.launch.serve import serve_shape
    from repro_torch.models import ShapeSpec, build_model

    cfg = get_config("qwen3-0.6b")
    model = build_model(cfg)
    # the copy the server keeps, built a layer at a time
    params, init_s, _, n_params, param_bytes = init_timed(model, dev)
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size,
                                     (PREFILL_BATCH, PREFILL_SEQ + 1)),
                        device=dev)
    batch = {"tokens": toks}
    per_fwd = (cfg.n_layers, 2 * cfg.n_layers + 1)   # flash, rmsnorm

    # ---- 9. prefill ----
    with torch.inference_mode():
        times, counts, peak, logits = timed_forwards(model, params, batch)
        launched = (counts["flash_attention"], counts["rmsnorm"])
        ok = (tuple(logits.shape) == (PREFILL_BATCH, PREFILL_SEQ,
                                      cfg.vocab_size)
              and bool(torch.isfinite(logits).all()))
        emit("prefill_path", arch=cfg.name, n_layers=cfg.n_layers,
             n_params=n_params, param_bytes=param_bytes, init_s=init_s,
             batch=PREFILL_BATCH, seq=PREFILL_SEQ, dtype=cfg.dtype,
             s_per_forward=times, mean_s=sum(times) / len(times),
             tokens_per_s=PREFILL_BATCH * PREFILL_SEQ / min(times),
             launches_flash=launched[0], launches_rmsnorm=launched[1],
             launches_expected=[PREFILL_REPS * n for n in per_fwd],
             max_memory_allocated=peak,
             logits_bytes=logits.numel() * logits.element_size(),
             logits_std=float(logits[0, :64].float().std()), finite=ok)
        if launched != tuple(PREFILL_REPS * n for n in per_fwd):
            raise AssertionError(f"prefill launches {launched}, expected "
                                 f"{PREFILL_REPS} x {per_fwd}")
        if not ok:
            raise AssertionError("prefill logits are not finite or of the "
                                 "wrong shape")
        del logits
        profile_forward(model, params, batch)
    prefill_launches = launched
    del batch, toks

    # ---- 10. serve: prefill the prompts, feed them, decode greedily ----
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size,
                                        (SERVE_REQUESTS, SERVE_PROMPT)),
                           dtype=torch.int32, device=dev)
    shape = ShapeSpec("serve_smoke", seq_len=SERVE_PROMPT + SERVE_NEW,
                      global_batch=SERVE_REQUESTS, kind="decode")
    flash_attention.LAUNCHES = rmsnorm.LAUNCHES = 0
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pad = torch.zeros(SERVE_REQUESTS, 1, dtype=torch.int32, device=dev)
        prefill = model.logits(params, {"tokens": torch.cat([prompts, pad],
                                                            1)})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    at_prefill = (flash_attention.LAUNCHES, rmsnorm.LAUNCHES)
    res = serve_shape(cfg, shape, SERVE_NEW, device=dev, params=params,
                      prompts=prompts, keep_prompt_logits=True)
    steps = res.prompt_steps + res.decode_steps
    decode = (flash_attention.LAUNCHES - at_prefill[0],
              rmsnorm.LAUNCHES - at_prefill[1])
    pre, dec = prefill.float(), res.prompt_logits.float()
    gap = (dec - pre).abs()
    within = bool((gap <= SERVE_GAP_ATOL + SERVE_GAP_RTOL * pre.abs()).all())
    first = int((res.tokens[:, 0] == pre[:, -1].argmax(-1)).sum())
    emit("serve_path", arch=cfg.name, requests=SERVE_REQUESTS,
         prompt=SERVE_PROMPT, new_tokens=SERVE_NEW, cache_len=shape.seq_len,
         prefill_s=prefill_s, prompt_steps=res.prompt_steps,
         prompt_ms_per_step=1e3 * res.prompt_s / res.prompt_steps,
         decode_steps=res.decode_steps,
         decode_ms_per_step=res.ms_per_decode_step,
         decode_tokens_per_s=SERVE_REQUESTS / (res.ms_per_decode_step / 1e3),
         tokens_per_s=res.tokens_per_s,
         launches_prefill=list(at_prefill),
         launches_decode_flash=decode[0],
         rmsnorm_per_step=decode[1] / steps,
         max_gap=float(gap.max()), mean_gap=float(gap.mean()),
         max_abs_prefill_logit=float(pre.abs().max()),
         gap_bound=[SERVE_GAP_ATOL, SERVE_GAP_RTOL], gap_within=within,
         first_token_equal=first, tokens=res.tokens[:2, :8].tolist())
    if at_prefill != per_fwd or decode != (0, per_fwd[1] * steps):
        raise AssertionError(f"serve launches: prefill {at_prefill}, decode "
                             f"{decode}; expected {per_fwd} and (0, "
                             f"{per_fwd[1]} x {steps})")
    if not (within and torch.isfinite(dec).all()
            and tuple(res.tokens.shape) == (SERVE_REQUESTS, SERVE_NEW)):
        raise AssertionError("decode logits leave the bound around the "
                             "prefill logits")
    profile_decode(model, params, prompts, SERVE_PROMPT + SERVE_NEW)
    return {"flash_attention": prefill_launches[0] + at_prefill[0]
            + decode[0],
            "rmsnorm": prefill_launches[1] + at_prefill[1] + decode[1]}


def serve_card_vs_cpu(dev, arch: str = "qwen3-0.6b", n_tokens: int = 33,
                      phase: str = "serve_card_vs_cpu") -> None:
    """Phase 11 (and 15, 25d, 26e): reduced ``arch`` in float32, the same
    params on the card (kernels) and the CPU (plain versions): logits of
    ``n_tokens - 1`` positions, 8 prompt and 8 decode steps; an
    encoder-decoder's from random frames (its encoder's 16 against the
    decoder's ``n_tokens - 1``: non-causal Sq != Skv), a VLM's logits with
    a random prefix (its decode takes none)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.utils import tree_map

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    card_params = tree_map(lambda p: p.to(dev), cpu_params)
    draw = np.random.default_rng(2)
    toks = torch.tensor(draw.integers(0, cfg.vocab_size, (2, n_tokens)))
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.tensor(draw.normal(
            size=(2, cfg.encoder_seq_len, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        extra["prefix_embeds"] = torch.tensor(draw.normal(
            size=(2, cfg.n_vision_tokens, cfg.d_model)), dtype=torch.float32)
    out = {}
    for where, params in (("card", card_params), ("cpu", cpu_params)):
        on = next(iter(params["embed"].values())).device
        batch = {k: v.to(on) for k, v in extra.items()}
        with torch.inference_mode():
            logits = model.logits(params, {"tokens": toks.to(on), **batch})
        res = serve(model, params, toks[:, :8].to(on), 8,
                    frames=batch.get("frames"), keep_prompt_logits=True)
        out[where] = (logits.cpu(), res.prompt_logits.cpu(), res.tokens.cpu())
    (lc, pc, tc), (lh, ph, th) = out["card"], out["cpu"]
    err_fwd = float((lc - lh).abs().max())
    err_dec = float((pc - ph).abs().max())
    close = all(torch.allclose(a, b, atol=CARD_VS_CPU_TOL,
                               rtol=CARD_VS_CPU_TOL)
                for a, b in ((lc, lh), (pc, ph)))
    emit(phase, arch=cfg.name + " (reduced)", positions=n_tokens - 1,
         dtype=cfg.dtype, tolerance=CARD_VS_CPU_TOL,
         max_abs_err_logits=err_fwd, max_abs_err_decode=err_dec,
         tokens_card=tc.tolist(), tokens_cpu=th.tolist(),
         same_tokens=bool(torch.equal(tc, th)))
    if not (close and torch.equal(tc, th)):
        raise AssertionError(f"card and CPU serving of {cfg.name} disagree")


def ssm_kernels(dev, ptxas: dict) -> dict:
    """Phase 12: ssd_state_scan against its plain version on the same card
    tensors, bit for bit, at mamba2-1.3b's and zamba2-2.7b's prefill
    shapes (4 x 4096 tokens in chunks of 256), a long sequence, a ragged
    shape and bfloat16 states, with times at mamba2's; then the flash
    kernel at zamba2's shared attention layer (head dim 80; ``ptxas`` is
    its build's report from phase 2). Returns the main shapes' fields for
    the kernels line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref, ssd_scan
    gen = torch.Generator(device=dev).manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16

    def prefill_shape(arch, nc=None):
        """(NC, B, H, N, P) of ``arch``'s scan on the prefill batch."""
        cfg = get_config(arch)
        s = cfg.ssm
        return (nc or PREFILL_SEQ // s.chunk_size, PREFILL_BATCH,
                s.expand * cfg.d_model // s.head_dim, s.state_size,
                s.head_dim)

    mamba = prefill_shape("mamba2-1.3b")           # (16, 4, 64, 128, 64)
    main = {}
    for case, shape, dtype, with_init in (
            ("mamba2_prefill", mamba, f32, False),
            ("mamba2_prefill", mamba, f32, True),
            ("zamba2_prefill", prefill_shape("zamba2-2.7b"), f32, False),
            ("long", (128, 1, *mamba[2:]), f32, True),
            ("ragged", (3, 1, 5, 7, 9), f32, True),
            ("bfloat16", mamba, bf16, True),
            ("bfloat16", (3, 1, 5, 7, 9), bf16, False)):
        _, b, h, n, p = shape
        states = torch.randn(shape, generator=gen, device=dev).to(dtype)
        # exp(sum(da)) of a chunk lies in (0, 1)
        decay = 0.3 + 0.7 * torch.rand(shape[:3], generator=gen, device=dev)
        init = (torch.randn((b, h, n, p), generator=gen, device=dev)
                if with_init else None)
        got = ssd_scan.ssd_state_scan(states, decay, init)
        torch.cuda.synchronize()
        want = ref.ssd_state_scan_ref(states, decay, init)
        equal = all(torch.equal(g, w) and bool(torch.isfinite(g.float()).all())
                    for g, w in zip(got, want))
        fields = dict(kernel="ssd_state_scan", case=case, shape=list(shape),
                      dtype=str(dtype).removeprefix("torch."),
                      initial_state=with_init, tolerance="bitwise",
                      max_abs_err=max(float((g.float() - w.float()).abs()
                                            .max()) for g, w in zip(got,
                                                                    want)))
        if not equal:
            emit("kernel", **fields)
            raise AssertionError(f"ssd_state_scan {case} {shape} disagrees "
                                 "with its plain version")
        del got, want
        if case == "mamba2_prefill" and not with_init:   # the path's call
            item = states.element_size()
            nbytes = (2 * states.numel() + b * h * n * p) * item \
                + decay.numel() * 4
            b_ms, b_by = bound_ms(2 * states.numel(), nbytes)
            k_ms = cuda_ms(lambda: ssd_scan.ssd_state_scan(states, decay),
                           reps=50)
            fields.update(
                ms=k_ms, plain_ms=cuda_ms(lambda: ref.ssd_state_scan_ref(
                    states, decay), reps=5),
                library_ms=None,
                library="none: no single PyTorch call computes it",
                bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / k_ms)
            main["ssd_state_scan"] = fields
        emit("kernel", **fields)
        del states, decay, init

    # zamba2's shared attention layer: B=4, S=4096, 32/32 heads of 80
    zamba = get_config("zamba2-2.7b")
    h, hd = zamba.n_heads, zamba.resolved_head_dim
    fields = flash_case(gen, "zamba2_layer", (PREFILL_BATCH, PREFILL_SEQ,
                                              PREFILL_SEQ, h, h, hd),
                        bf16, True, flush=l2_flush(dev),
                        report=ptxas.get(f"bf16,HD={hd}"))
    main["flash_attention_hd80"] = fields
    emit("kernel", **fields)
    return main


def ssm_layer_times(model, params, batch) -> dict:
    """Device milliseconds of every SSM block and of every ``ssd_chunked``
    inside one forward, from CUDA events around each call."""
    import torch
    from repro_torch.models import ssm, transformer
    spans = {"ssm_apply": [], "ssd_chunked": []}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            spans[key].append((start, stop))
            return out
        return wrapper

    real = (transformer.ssm_apply, ssm.ssd_chunked)
    transformer.ssm_apply = timed("ssm_apply", real[0])
    ssm.ssd_chunked = timed("ssd_chunked", real[1])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.logits(params, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        transformer.ssm_apply, ssm.ssd_chunked = real
    out = {f"{key}_ms": sum(a.elapsed_time(b) for a, b in v)
           for key, v in spans.items()}
    out.update(forward_wall_ms=wall_ms,
               calls=len(spans["ssd_chunked"]))
    return out


def ssm_prefill_path(dev, arch: str) -> dict:
    """Phase 13: ``Model.logits`` of full-size ``arch`` on 4 x 4096 tokens,
    ``PREFILL_REPS`` times: seconds and tokens/s per forward, the kernels'
    launches (asserted: one scan per layer; rmsnorm at norm1, the gated
    norm and the final norm, plus zamba2's shared block's two norms and one
    flash launch per application), peak memory, the per-layer split and a
    profiled forward. Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    model = build_model(cfg)
    params, init_s, _, n_params, param_bytes = init_timed(model, dev)
    apps = cfg.n_layers // cfg.hybrid_attn_period \
        if cfg.hybrid_attn_period else 0
    per_fwd = (cfg.n_layers, apps, 2 * cfg.n_layers + 2 * apps + 1)
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ + 1)), device=dev)
    batch = {"tokens": toks}
    kernels = ("ssd_state_scan", "flash_attention", "rmsnorm")
    with torch.inference_mode():
        times, counts, peak, logits = timed_forwards(model, params, batch)
        launched = tuple(counts[k] for k in kernels)
        ok = (tuple(logits.shape) == (PREFILL_BATCH, PREFILL_SEQ,
                                      cfg.vocab_size)
              and bool(torch.isfinite(logits).all()))
        expected = tuple(PREFILL_REPS * n for n in per_fwd)
        emit("ssm_prefill_path", arch=cfg.name, family=cfg.family,
             n_layers=cfg.n_layers, n_params=n_params,
             param_bytes=param_bytes, init_s=init_s, batch=PREFILL_BATCH,
             seq=PREFILL_SEQ, chunk=cfg.ssm.chunk_size, dtype=cfg.dtype,
             s_per_forward=times, mean_s=sum(times) / len(times),
             tokens_per_s=PREFILL_BATCH * PREFILL_SEQ / min(times),
             launches_ssd_state_scan=launched[0],
             launches_flash=launched[1], launches_rmsnorm=launched[2],
             launches_expected=list(expected), max_memory_allocated=peak,
             logits_std=float(logits[0, :64].float().std()), finite=ok)
        if launched != expected:
            raise AssertionError(f"{cfg.name} prefill launches {launched}, "
                                 f"expected {PREFILL_REPS} x {per_fwd}")
        if not ok:
            raise AssertionError(f"{cfg.name} prefill logits are not finite "
                                 "or of the wrong shape")
        del logits
        split = ssm_layer_times(model, params, batch)
        emit("ssm_layer_split", arch=cfg.name, **split,
             ssm_apply_share=split["ssm_apply_ms"] / split["forward_wall_ms"],
             ssd_chunked_share=split["ssd_chunked_ms"]
             / split["forward_wall_ms"])
        profile_forward(model, params, batch, phase="ssm_prefill_profile")
    return dict(zip(kernels, launched))


def ssm_serve_path(dev) -> dict:
    """Phase 14: the server answers ``SSM_SERVE_REQUESTS`` requests of
    full-size mamba2-1.3b (decode_32k's batch, whose float32 state fits one
    card) with a ``SSM_SERVE_PROMPT``-token prompt (two chunks) and
    ``SSM_SERVE_NEW`` greedy tokens from the bfloat16 serving copy: ms per
    step, tokens/s, the cache's bytes against ``cache_bytes``, launches and
    a profiled step. On the first ``SSM_CHECK_REQUESTS`` requests the
    decode logits are held to ``Model.logits`` (which carries the state
    across the chunk boundary through the scan kernel): in float32, on the
    float32 weights the serving copy rounds, at ``SSM_GAP_F32`` (asserted);
    in bfloat16 against phase 10's bound, reported beside the bfloat16
    prefill's own distance to the float32 one. Returns the launch
    counts."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    from repro_torch.launch.serve import cache_bytes, serve, serve_shape
    from repro_torch.models import ShapeSpec, build_model
    from repro_torch.utils import tree_leaves

    cfg = get_config("mamba2-1.3b")
    model = build_model(cfg)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = model.init(torch.Generator(device=dev).manual_seed(0))
    params = model.serving_params(params32)
    per_step = 2 * cfg.n_layers + 1
    rng = np.random.default_rng(1)
    prompts = torch.tensor(rng.integers(
        0, cfg.vocab_size, (SSM_SERVE_REQUESTS, SSM_SERVE_PROMPT)),
        dtype=torch.int32, device=dev)
    shape = ShapeSpec("ssm_serve_smoke",
                      seq_len=SSM_SERVE_PROMPT + SSM_SERVE_NEW,
                      global_batch=SSM_SERVE_REQUESTS, kind="decode")
    expected_bytes = cache_bytes(cfg, SSM_SERVE_REQUESTS, shape.seq_len,
                                 torch.bfloat16)
    cache = model.decode_init(params, {"tokens": prompts}, shape.seq_len)
    built = sum(t.nbytes for t in tree_leaves(cache) if t.is_floating_point())
    del cache
    if built != expected_bytes:
        raise AssertionError(f"cache of {built} B, cache_bytes says "
                             f"{expected_bytes}")
    check = prompts[:SSM_CHECK_REQUESTS]
    pad = torch.zeros(len(check), 1, dtype=torch.int32, device=dev)
    ssd_scan.LAUNCHES = flash_attention.LAUNCHES = rmsnorm.LAUNCHES = 0
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill = model.logits(params, {"tokens": torch.cat([check, pad], 1)})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    at_prefill = (ssd_scan.LAUNCHES, rmsnorm.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    res = serve_shape(cfg, shape, SSM_SERVE_NEW, device=dev, params=params,
                      prompts=prompts, keep_prompt_logits=True)
    peak = torch.cuda.max_memory_allocated()
    steps = res.prompt_steps + res.decode_steps
    decode = (ssd_scan.LAUNCHES - at_prefill[0],
              rmsnorm.LAUNCHES - at_prefill[1])
    pre = prefill.float()
    dec = res.prompt_logits[:SSM_CHECK_REQUESTS].float()
    del res.prompt_logits, prefill

    # the same check in float32 on the float32 weights
    before = (ssd_scan.LAUNCHES, rmsnorm.LAUNCHES)
    with torch.inference_mode():
        pre32 = model32.logits(params32,
                               {"tokens": torch.cat([check, pad], 1)})
    dec32 = serve(model32, params32, check, 1,
                  keep_prompt_logits=True).prompt_logits
    f32_launches = (ssd_scan.LAUNCHES - before[0],
                    rmsnorm.LAUNCHES - before[1])
    del params32
    gap32 = (dec32 - pre32).abs()
    within32 = bool((gap32 <= SSM_GAP_F32 + SSM_GAP_F32 * pre32.abs()).all())
    gap = (dec - pre).abs()
    within = bool((gap <= SERVE_GAP_ATOL + SERVE_GAP_RTOL * pre.abs()).all())
    floor, dec_err = (pre - pre32).abs(), (dec - pre32).abs()
    first = int((res.tokens[:SSM_CHECK_REQUESTS, 0]
                 == pre[:, -1].argmax(-1)).sum())
    emit("ssm_serve_path", arch=cfg.name, requests=SSM_SERVE_REQUESTS,
         prompt=SSM_SERVE_PROMPT, chunk=cfg.ssm.chunk_size,
         new_tokens=SSM_SERVE_NEW, cache_bytes=built,
         cache_bytes_expected=expected_bytes,
         max_memory_allocated_serving=peak, prefill_check_s=prefill_s,
         prompt_steps=res.prompt_steps,
         prompt_ms_per_step=1e3 * res.prompt_s / res.prompt_steps,
         decode_steps=res.decode_steps,
         decode_ms_per_step=res.ms_per_decode_step,
         decode_tokens_per_s=SSM_SERVE_REQUESTS
         / (res.ms_per_decode_step / 1e3),
         tokens_per_s=res.tokens_per_s,
         launches_prefill=list(at_prefill),
         launches_decode_ssd_state_scan=decode[0],
         rmsnorm_per_step=decode[1] / steps,
         checked_requests=SSM_CHECK_REQUESTS,
         f32_max_gap=float(gap32.max()), f32_mean_gap=float(gap32.mean()),
         f32_gap_bound=SSM_GAP_F32, f32_gap_within=within32,
         bf16_max_gap=float(gap.max()), bf16_mean_gap=float(gap.mean()),
         bf16_gap_bound=[SERVE_GAP_ATOL, SERVE_GAP_RTOL],
         bf16_gap_within=within,
         bf16_prefill_vs_f32_max=float(floor.max()),
         bf16_prefill_vs_f32_mean=float(floor.mean()),
         bf16_decode_vs_f32_max=float(dec_err.max()),
         bf16_decode_vs_f32_mean=float(dec_err.mean()),
         max_abs_prefill_logit=float(pre.abs().max()),
         first_token_equal=first, tokens=res.tokens[:2, :8].tolist())
    if at_prefill != (cfg.n_layers, per_step) or decode != (
            0, per_step * steps) or f32_launches != (
            cfg.n_layers, per_step * (1 + SSM_SERVE_PROMPT)):
        raise AssertionError(f"ssm serve launches: prefill {at_prefill}, "
                             f"decode {decode}, float32 check "
                             f"{f32_launches}; expected ({cfg.n_layers}, "
                             f"{per_step}), (0, {per_step} x {steps})")
    if not (within32 and torch.isfinite(dec).all()
            and tuple(res.tokens.shape) == (SSM_SERVE_REQUESTS,
                                            SSM_SERVE_NEW)):
        raise AssertionError("mamba2 float32 decode logits leave the bound "
                             "around the float32 prefill logits")
    del pre, dec, pre32, dec32, gap, gap32, floor, dec_err
    profile_decode(model, params, prompts, shape.seq_len,
                   phase="ssm_serve_profile")
    return {"ssd_state_scan": at_prefill[0] + decode[0] + f32_launches[0],
            "rmsnorm": at_prefill[1] + decode[1] + f32_launches[1]}


# the paper's §V.A comparison (benchmarks/paper_cost.py): Fig. 3 varies N
# at K = 5, Fig. 4 varies K at N = 60, seed 0; every scheme's total cost is
# read over uniform's. HFEL must beat random and uniform within the bound
# of tests/test_edge_association.py:56-57.
SCHEMES = ("hfel", "comp_opt", "greedy", "random", "comm_opt", "uniform",
           "proportional")
SCHEME_POINTS = ((15, 5), (30, 5), (60, 5), (60, 15))
# comm_opt is launch-bound (its nested bisection is some 40k small kernels
# a batched solve, 1.5 s a move on the card): at (60, 15) it alone took
# 157.7 s, so that one run is left out (PERF.md, PR 17; ROADMAP queue 2)
SCHEME_SKIP = {(60, 15): ("comm_opt",)}
SCHEME_CHECK_POINTS = ((20, 5, 4), (12, 3, 5))    # card vs CPU, (N, K, seed)
HFEL_BOUND = 1.001


def exchange_path(dev, main_sc, stuck) -> dict:
    """Phase 4b: Algorithm 3 with sampled exchanges, what
    ``evaluate_scheme("hfel")`` runs: the engine at its defaults (64
    exchanges a stuck round, seed 0) from a random start on the card, with
    the kernel's launches read around exactly this run and asserted against
    the loop's count (K at init, 2 per applied move, 1 per exchange round,
    1 at finalize) and a monotone trace asserted. Then exchanges from phase
    4's transfer-only stable point ``stuck``. Returns the launches, the
    result and its counts."""
    import numpy as np
    import torch
    from repro_torch.core.assoc_fast import FastAssociationEngine
    from repro_torch.kernels import golden_section
    k, n = main_sc.n_servers, main_sc.n_devices
    golden_section.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = FastAssociationEngine(main_sc, device=dev)
    res = eng.run("random")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = golden_section.LAUNCHES
    counts, timing = eng.last_counts, eng.last_timing
    moves = res.n_adjustments
    expected = k + 2 * moves + counts["exchange_rounds"] + 1
    trace = np.asarray(res.cost_trace)
    monotone = bool(np.all(np.diff(trace) <= 0)
                    and trace.shape == (moves + 1,))
    emit("exchange_path", n_devices=n, n_servers=k, init="random",
         exchange_samples=64, moves=moves, **counts,
         first_cost=float(trace[0]), total_cost=res.total_cost,
         true_cost=res.true_cost, seconds=total_s, init_s=timing["init_s"],
         moves_s=timing["moves_s"],
         exchange_pricing_s=timing["exchange_pricing_s"],
         ms_per_move=1e3 * timing["moves_s"] / max(moves, 1),
         ms_per_exchange_round=1e3 * timing["exchange_pricing_s"]
         / max(counts["exchange_rounds"], 1),
         monotone=monotone, launches=launches, launches_expected=expected)
    if launches != expected:
        raise AssertionError(f"{launches} launches, expected K + 2*moves + "
                             f"exchange rounds + 1 = {expected}")
    if not monotone:
        raise AssertionError("exchange-path cost trace is not monotone")
    if not (np.isfinite([res.total_cost, res.true_cost]).all()
            and np.isfinite(res.f).all() and np.isfinite(res.beta).all()
            and abs(res.total_cost - trace[-1]) <= PIN_RTOL * trace[-1]):
        raise AssertionError("exchange-path result is not finite or "
                             "consistent")

    t0 = time.perf_counter()
    eng2 = FastAssociationEngine(main_sc, device=dev)
    res2 = eng2.run(assignment=stuck.assignment)
    torch.cuda.synchronize()
    emit("exchange_from_stuck", start="phase 4's transfer-only stable point",
         moves=res2.n_adjustments, **eng2.last_counts,
         total_cost_before=stuck.total_cost, total_cost_after=res2.total_cost,
         cost_fall=stuck.total_cost - res2.total_cost,
         true_cost_before=stuck.true_cost, true_cost_after=res2.true_cost,
         seconds=time.perf_counter() - t0)
    if not res2.total_cost <= stuck.total_cost * (1 + PIN_RTOL):
        raise AssertionError("exchanges from the stable point raised its "
                             "cost")
    return dict(launches=launches, res=res, counts=counts)


def exchange_batch_kernel(dev, main_sc, assignment, iters: dict,
                          ptxas: str) -> dict:
    """The golden-section kernel at an exchange round's batch: 64 pairs
    drawn as the engine draws them (first round of seed 0) on ``assignment``
    (phase 4's stable point), both swapped groups of each, (128, N). Bit
    for bit its plain version (asserted), with its time, plain time and
    bound."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.assoc_fast import _dense_member
    from repro_torch.core.edge_association import GroupSolver
    from repro_torch.kernels import golden_section, ref
    n = main_sc.n_devices
    member = torch.as_tensor(_dense_member(assignment, main_sc.active_mask,
                                           main_sc.n_servers), device=dev)
    _, sub = prng.split(prng.PRNGKey(0))
    pairs = prng.randint(sub, (64, 2), 0, n).to(dev)
    dn, dm = pairs[:, 0], pairs[:, 1]
    a_t = torch.as_tensor(assignment, device=dev)
    si, sj = a_t[dn], a_t[dm]
    idx = torch.arange(n, device=dev)
    hot_n, hot_m = idx[None] == dn[:, None], idx[None] == dm[:, None]
    masks = torch.cat([member[si] ^ hot_n ^ hot_m,
                       member[sj] ^ hot_m ^ hot_n]).contiguous()
    c = GroupSolver(main_sc, device=dev).consts.rows(torch.cat([si, sj]))
    ins = [x.contiguous() for x in (c.a, c.b, c.d, c.e, c.w, c.f_min,
                                    c.f_max)] + [masks]
    got = golden_section.golden_section_solve(*ins, **iters)
    torch.cuda.synchronize()
    want = ref.golden_section_ref(*ins, **iters)
    err = check_pin(got, want, ins[5], ins[6], masks)
    err["groups_not_bitwise"] = groups_not_bitwise(got, want)
    ms = cuda_ms(lambda: golden_section.golden_section_solve(*ins, **iters),
                 reps=20)
    plain = cuda_ms(lambda: ref.golden_section_ref(*ins, **iters), reps=1,
                    warm=0)
    ops, nbytes, active = golden_section_work(masks, **iters)
    b_ms, b_by = bound_ms(ops, nbytes)
    fields = dict(shape=list(masks.shape), ms=ms, plain_ms=plain,
                  active_share=active / masks.numel(),
                  paths=ref.golden_section_paths(masks), bound_ms=b_ms,
                  bound_by=b_by, bound_share=b_ms / ms, **err)
    emit("kernel", kernel="golden_section", case="exchange_batch",
         profile="default", operations=ops, bytes=nbytes, ptxas=ptxas,
         **fields)
    if err["groups_not_bitwise"]:
        raise AssertionError("golden_section differs from its plain version "
                             "at the exchange batch")
    return fields


def exchange_card_vs_cpu(dev) -> None:
    """``make_scenario(60, 5, 0)`` with exchanges from the nearest start on
    the card and on the CPU: the same stable point, moves and exchanges."""
    import numpy as np
    from repro_torch.core.assoc_fast import FastAssociationEngine
    from repro_torch.core.scenario import make_scenario
    sc60 = make_scenario(60, 5, seed=0, device="cpu")
    out = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        eng = FastAssociationEngine(sc60, device=where)
        out[where] = (eng.run("nearest"), eng.last_counts,
                      time.perf_counter() - t0)
    (card, c_counts, card_s), (cpu, p_counts, cpu_s) = out[dev], out["cpu"]
    same = (np.array_equal(card.assignment, cpu.assignment)
            and card.n_adjustments == cpu.n_adjustments
            and c_counts == p_counts
            and math.isclose(card.total_cost, cpu.total_cost,
                             rel_tol=PIN_RTOL))
    emit("exchange_card_vs_cpu", fixture=[60, 5, 0], init="nearest",
         counts_card=c_counts, counts_cpu=p_counts,
         total_cost_card=card.total_cost, total_cost_cpu=cpu.total_cost,
         same=bool(same), card_s=card_s, cpu_s=cpu_s)
    if not same or c_counts["exchanges"] < 1:
        raise AssertionError("card and CPU disagree with exchanges on "
                             "(60, 5, 0), or none applied")


# solve_paper's bound across devices: the JAX solver's own jit-vs-eager
# spread (tests/test_torch_ra_solvers.py's PAPER_RTOL)
PAPER_RTOL = 2.5e-2


def solvers_card_vs_cpu(dev) -> None:
    """Each plain-solver scheme kind on one batch of 8 groups of
    ``make_scenario(30, 5, 1)`` (one empty), card against CPU: whether
    each output is the CPU's bit for bit, and the largest relative cost
    difference (asserted within the pin, ``solve_paper`` within
    ``PAPER_RTOL``); and the share of 2^20 float32 inputs on which the
    card's ``exp``, ``log`` and ``sqrt`` round otherwise than the CPU's."""
    import numpy as np
    import torch
    from repro_torch.core.edge_association import GroupSolver
    from repro_torch.core.scenario import make_scenario
    sc = make_scenario(30, 5, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    masks = rng.uniform(size=(8, 30)) < 0.4
    masks[0] = False
    sids = np.arange(8) % 5
    kinds = {}
    for kind in ("comp_only", "comm_only", "uniform", "proportional",
                 "optimal", "paper"):
        out, secs = {}, {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            sol = GroupSolver(sc, kind, device=where).solve_batch(sids, masks)
            out[where] = [x.cpu() for x in (sol.f, sol.beta, sol.cost,
                                            sol.deadline)]
            secs[str(where)] = time.perf_counter() - t0
        card, cpu = out[dev], out["cpu"]
        rel = float(((card[2] - cpu[2]).abs()
                     / cpu[2].abs().clamp_min(1e-30)).max())
        kinds[kind] = dict(bitwise=[bool(torch.equal(a, b))
                                    for a, b in zip(card, cpu)],
                           max_rel_diff_cost=rel, seconds=secs)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(1 << 20, generator=gen) * 60 - 30
    pos = torch.rand(1 << 20, generator=gen) * 1e6 + 1e-3
    rounding = {name: float((fn(inp.to(dev)).cpu().view(torch.int32)
                             != fn(inp).view(torch.int32)).float().mean())
                for name, fn, inp in (("exp", torch.exp, x),
                                      ("log", torch.log, pos),
                                      ("sqrt", torch.sqrt, pos))}
    emit("solvers_card_vs_cpu", batch=[8, 30], **kinds,
         share_rounding_otherwise=rounding)
    bad = [k for k, v in kinds.items()
           if v["max_rel_diff_cost"] > (PAPER_RTOL if k == "paper"
                                        else PIN_RTOL)]
    if bad:
        raise AssertionError(f"card and CPU solvers disagree: {bad}")


def schemes(dev) -> dict:
    """The §V.A schemes on the card at the Fig. 3/4 points: each scheme's
    total cost over uniform's, its true cost, seconds, moves and the
    kernel's launches; HFEL asserted at or below ``HFEL_BOUND`` x random
    and x uniform. Then every scheme at ``SCHEME_CHECK_POINTS`` on the card
    and on the CPU: the same assignment, costs within the pin. Returns the
    points' rows and the launches of the HFEL runs."""
    import numpy as np
    import torch
    from repro_torch.core.edge_association import evaluate_scheme
    from repro_torch.core.scenario import make_scenario
    from repro_torch.kernels import golden_section
    points, hfel_launches = [], 0
    for n, k in SCHEME_POINTS:
        sc = make_scenario(n, k, seed=0, device=dev)
        rows = {}
        for scheme in SCHEMES:
            if scheme in SCHEME_SKIP.get((n, k), ()):
                continue
            before = golden_section.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = evaluate_scheme(sc, scheme, seed=0, device=dev)
            torch.cuda.synchronize()
            rows[scheme] = dict(total_cost=r.total_cost,
                                true_cost=r.true_cost,
                                s=time.perf_counter() - t0,
                                moves=r.n_adjustments,
                                launches=golden_section.LAUNCHES - before)
            if scheme == "hfel":
                hfel_launches += rows[scheme]["launches"]
        base = rows["uniform"]["total_cost"]
        for row in rows.values():
            row["ratio"] = row["total_cost"] / base
            row["s_per_move"] = row["s"] / max(row["moves"], 1)
        emit("schemes", n_devices=n, n_servers=k, seed=0,
             left_out=list(SCHEME_SKIP.get((n, k), ())), **rows)
        points.append(dict(n=n, k=k, rows=rows))
        hfel = rows["hfel"]["total_cost"]
        for other in ("random", "uniform"):
            if not hfel <= HFEL_BOUND * rows[other]["total_cost"]:
                raise AssertionError(f"hfel {hfel} above {HFEL_BOUND} x "
                                     f"{other} at N={n}, K={k}")
        if not all(np.isfinite([x["total_cost"], x["true_cost"]]).all()
                   for x in rows.values()):
            raise AssertionError(f"a scheme's cost is not finite at N={n}, "
                                 f"K={k}")
    for n, k, seed in SCHEME_CHECK_POINTS:
        sc = make_scenario(n, k, seed=seed, device="cpu")
        diffs, secs = {}, {}
        for scheme in SCHEMES:
            got = {}
            for where in ("card", "cpu"):
                t0 = time.perf_counter()
                got[where] = evaluate_scheme(
                    sc, scheme, seed=0,
                    device=dev if where == "card" else "cpu")
                secs[f"{scheme}_{where}"] = time.perf_counter() - t0
            card, cpu = got["card"], got["cpu"]
            diffs[scheme] = dict(
                same_assignment=bool(np.array_equal(card.assignment,
                                                    cpu.assignment)),
                moves=[card.n_adjustments, cpu.n_adjustments],
                rel_diff_total=abs(card.total_cost - cpu.total_cost)
                / cpu.total_cost,
                rel_diff_true=abs(card.true_cost - cpu.true_cost)
                / cpu.true_cost,
                bitwise_total=card.total_cost == cpu.total_cost)
        emit("schemes_card_vs_cpu", fixture=[n, k, seed], seconds=secs,
             **diffs)
        bad = [s for s, d in diffs.items()
               if not (d["same_assignment"] and d["moves"][0] == d["moves"][1]
                       and d["rel_diff_total"] <= PIN_RTOL
                       and d["rel_diff_true"] <= PIN_RTOL)]
        if bad:
            raise AssertionError(f"card and CPU disagree on {bad} at "
                                 f"{(n, k, seed)}")
    return dict(points=points, hfel_launches=hfel_launches)


# ---- phases 16-20: association at scale and under churn, the live loop ----

SCALE_N, SCALE_K, SCALE_SPREAD = 50_000, 500, 60.0
SCALE_MOVES = 8000
SCALE_PERTURB = dict(seed=1, drift_m=60.0, move_frac=0.01, depart_frac=0.005)
LIVE_SCALE_CHURN = dict(drift_m=60.0, move_frac=0.01, flip_frac=0.005,
                        depart_frac=0.005, arrive_frac=0.1)
REPLAY_EVERY = 50        # 1 in 50 golden-section launches replayed for time


def bits(x) -> list:
    """The int32 bits of a float32 array (for bit-for-bit comparisons)."""
    import numpy as np
    return np.asarray(x, np.float32).view(np.int32).tolist()


class LaunchSampler:
    """Wraps ``ops.golden_section_solve`` while active: keeps the inputs of
    one launch in ``every`` so that their kernel time can be replayed and
    timed afterwards (:meth:`kernel_ms`), without timing the run itself."""

    def __init__(self, every: int):
        self.every, self.calls, self.seen = every, [], 0

    def __enter__(self):
        from repro_torch.kernels import ops
        self._orig = ops.golden_section_solve

        def wrapped(*args, **kwargs):
            if self.seen % self.every == 0:
                self.calls.append((args, kwargs))
            self.seen += 1
            return self._orig(*args, **kwargs)

        ops.golden_section_solve = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.golden_section_solve = self._orig

    def kernel_ms(self) -> float:
        """Mean kernel milliseconds of the sampled launches (CUDA events)."""
        from repro_torch.kernels import golden_section
        times = [cuda_ms(lambda a=a, kw=kw: golden_section.launch(a, **kw),
                         reps=3) for a, kw in self.calls]
        self.calls = []
        return sum(times) / max(len(times), 1)


def compact_path(dev) -> dict:
    """Phase 16: ``make_large_scenario(1000, 20)``, ``fast`` kind at the
    coarse profile, nearest start, transfers only, to a stable point in the
    dense, flat and bucketed spaces: the same assignment, moves and cost
    bits in all three (asserted), K + 2 moves launches each (asserted);
    moves, init seconds, ms per move, R_max, bucket widths, padded
    fractions. Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core.assoc_fast import FastAssociationEngine
    from repro_torch.core.scenario import make_large_scenario, reach_index_map
    from repro_torch.kernels import golden_section
    sc = make_large_scenario(1000, 20, seed=0, device=dev)
    k = sc.n_servers
    flat = reach_index_map(sc.avail)
    rbk = reach_index_map(sc.avail, bucketed=True)
    spaces, launches = {}, 0
    for compact in (False, True, "bucketed"):
        golden_section.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = FastAssociationEngine(sc, profile="coarse", compact=compact,
                                    device=dev)
        a = eng.run("nearest", exchange_samples=0, finalize=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = golden_section.LAUNCHES
        launches += got
        moves = eng.last_moves
        spaces[str(compact)] = dict(
            assignment=a, moves=moves, seconds=seconds,
            init_s=eng.last_timing["init_s"],
            ms_per_move=1e3 * eng.last_timing["moves_s"] / max(moves, 1),
            launches=got, launches_expected=k + 2 * moves,
            cur_bits=bits(eng.last_state["cur_cost"]),
            total_cost=eng.evaluate_assignment(a),
            widths=[bd.width for bd in eng._buckets])
    ref = spaces["False"]
    same = {c: bool(np.array_equal(s["assignment"], ref["assignment"])
                    and s["moves"] == ref["moves"]
                    and s["cur_bits"] == ref["cur_bits"]
                    and bits([s["total_cost"]]) == bits([ref["total_cost"]]))
            for c, s in spaces.items()}
    emit("compact_path", n_devices=sc.n_devices, n_servers=k,
         profile="coarse", r_max=flat.r_max,
         padded_fraction_flat=flat.padded_fraction,
         padded_fraction_bucketed=rbk.padded_fraction,
         bucket_widths=[b.width for b in rbk.buckets],
         same_as_dense=same,
         **{c: {key: v for key, v in s.items()
                if key not in ("assignment", "cur_bits")}
            for c, s in spaces.items()})
    for c, s in spaces.items():
        if s["launches"] != s["launches_expected"]:
            raise AssertionError(f"compact={c}: {s['launches']} launches, "
                                 f"expected K + 2*moves")
    if not all(same.values()) or ref["moves"] <= 0:
        raise AssertionError(f"the sweep spaces disagree: {same}")
    return dict(launches=launches)


def kernel_inputs(bucket, rows, masks) -> list:
    """The golden-section kernel's inputs for ``masks`` at ``rows`` of
    ``bucket`` (an engine's ``_Bucket``), as the engine's batched solve
    passes them."""
    c = bucket.consts.rows(rows)
    return [x.contiguous() for x in (c.a, c.b, c.d, c.e, c.w, c.f_min,
                                     c.f_max)] + [masks.contiguous()]


def gs_kernel_line(case: str, ins, iters: dict, profile: str) -> dict:
    """The golden-section kernel against its plain version on ``ins``:
    bit-equal (asserted), its time, the plain time and the bound."""
    import torch
    from repro_torch.kernels import golden_section, ref
    masks = ins[-1]
    got = golden_section.golden_section_solve(*ins, **iters)
    torch.cuda.synchronize()
    want = ref.golden_section_ref(*ins, **iters)
    err = check_pin(got, want, ins[5], ins[6], masks)
    err["groups_not_bitwise"] = groups_not_bitwise(got, want)
    ms = cuda_ms(lambda: golden_section.golden_section_solve(*ins, **iters),
                 reps=20)
    plain = cuda_ms(lambda: ref.golden_section_ref(*ins, **iters), reps=1,
                    warm=0)
    ops_, nbytes, active = golden_section_work(masks, **iters)
    b_ms, b_by = bound_ms(ops_, nbytes)
    fields = dict(shape=list(masks.shape), ms=ms, plain_ms=plain,
                  max_abs_err=err["max_abs_err_cost"],
                  active_share=active / masks.numel(),
                  paths=ref.golden_section_paths(masks), bound_ms=b_ms,
                  bound_by=b_by, bound_share=b_ms / ms, library_ms=None,
                  groups_not_bitwise=err["groups_not_bitwise"])
    emit("kernel", kernel="golden_section", case=case, profile=profile,
         operations=ops_, bytes=nbytes, **err,
         **{k: v for k, v in fields.items() if k not in err})
    if err["groups_not_bitwise"]:
        raise AssertionError(f"golden_section differs from its plain "
                             f"version at the {case} batch")
    return fields


def scale_path(dev) -> dict:
    """Phase 17: ``make_large_scenario(50_000, 500, spread_m=60)``, coarse
    profile, rel_tol 1e-2, bucketed space, on one card. Cold: nearest
    start, transfers only, at most 8000 moves (stability asserted);
    seconds, moves, init seconds, ms per move, the kernel's share of a move
    (1 in 50 launches replayed) and peak memory. Warm: one churn tick and
    ``rerun_incremental``; seconds, moves, stale rows. Cold rebuild: a
    fresh engine descends from the same repaired assignment, bit-identical
    to the warm result (asserted). Then the golden-section kernel at the
    widest bucket's refresh batch and at a flat exchange batch, bit-equal
    to its plain version (asserted)."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.core import resource_allocation as ra
    from repro_torch.core.assoc_fast import FastAssociationEngine
    from repro_torch.core.scenario import (make_large_scenario,
                                           perturb_scenario)
    from repro_torch.kernels import golden_section
    opts = dict(profile="coarse", rel_tol=1e-2, compact="bucketed",
                device=dev)
    t0 = time.perf_counter()
    sc = make_large_scenario(SCALE_N, SCALE_K, seed=0, spread_m=SCALE_SPREAD,
                             device=dev)
    scenario_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    golden_section.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = FastAssociationEngine(sc, **opts)
    build_s = time.perf_counter() - t0
    with LaunchSampler(REPLAY_EVERY) as sampler:
        cold_a0 = eng.run("nearest", max_moves=SCALE_MOVES,
                          exchange_samples=0, finalize=False)
        torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = golden_section.LAUNCHES
    moves, timing = eng.last_moves, eng.last_timing
    peak = torch.cuda.max_memory_allocated()
    kernel_ms = sampler.kernel_ms()
    ms_move = 1e3 * timing["moves_s"] / max(moves, 1)
    rbk = eng.reach_buckets
    cold = dict(seconds=cold_s, engine_build_s=build_s, moves=moves,
                stable=moves < SCALE_MOVES, init_s=timing["init_s"],
                ms_per_move=ms_move, kernel_ms_per_launch=kernel_ms,
                kernel_share_of_move=2 * kernel_ms / ms_move,
                launches=launches,
                launches_expected=sc.n_servers + 2 * moves,
                max_memory_allocated=peak)
    emit("scale_path", phase_part="cold", n_devices=SCALE_N,
         n_servers=SCALE_K, spread_m=SCALE_SPREAD, scenario_s=scenario_s,
         r_max=eng.reach.r_max, padded_fraction_flat=eng.reach.padded_fraction,
         padded_fraction_bucketed=rbk.padded_fraction,
         bucket_widths=[b.width for b in rbk.buckets],
         bucket_servers=[int(b.servers.size) for b in rbk.buckets], **cold)
    if launches != sc.n_servers + 2 * moves:
        raise AssertionError(f"{launches} launches, expected K + 2*moves")
    if not cold["stable"]:
        raise AssertionError(f"the N={SCALE_N} cold descent hit its cap of "
                             f"{SCALE_MOVES} moves before stability")

    sc2, delta = perturb_scenario(sc, **SCALE_PERTURB)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm_a = eng.rerun_incremental(sc2, delta, max_moves=SCALE_MOVES,
                                   exchange_samples=0, finalize=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = dict(seconds=warm_s, moves=eng.last_moves,
                stale_rows=eng.last_counts["init_rows"],
                prepare_s=eng.last_timing["prepare_s"],
                init_s=eng.last_timing["init_s"],
                delta_stale_servers=int(delta.stale_servers.sum()),
                moved=int(delta.moved.sum()),
                departed=int(delta.departed.sum()))
    t0 = time.perf_counter()
    rebuilt = FastAssociationEngine(sc2, **opts)
    cold_a = rebuilt.run(assignment=eng.last_repaired_assignment,
                         max_moves=SCALE_MOVES, exchange_samples=0,
                         finalize=False)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    same = bool(np.array_equal(warm_a, cold_a))
    emit("scale_path", phase_part="warm", perturb=SCALE_PERTURB, **warm,
         cold_rebuild_s=rebuild_s, cold_rebuild_moves=rebuilt.last_moves,
         warm_equals_cold_rebuild=same,
         warm_speedup=rebuild_s / max(warm_s, 1e-9))
    if not same:
        raise AssertionError("warm rerun differs from the cold rebuild at "
                             f"N={SCALE_N}")

    # the kernel at this slice's shapes, the engine's own batches at the
    # warm stable point: the widest bucket's fullest row's refresh, and a
    # first exchange round's 64 pairs (drawn as the engine draws them)
    iters = ra.SCREEN_PROFILES["coarse"]
    member = torch.as_tensor(eng.last_state["member"], device=dev)
    wide = max(eng._buckets, key=lambda bd: bd.width)
    server = int(wide.servers[wide.exists.sum(1).argmax()])
    b, row = int(eng._bucket_of[server]), int(eng._row_of[server])
    rows, masks = eng._refresh_groups(member[server], eng._buckets[b], row)
    refresh = gs_kernel_line("bucket_refresh",
                             kernel_inputs(eng._buckets[b], rows, masks),
                             iters, "coarse")
    _, sub = prng.split(prng.PRNGKey(eng.seed))
    pairs = prng.randint(sub, (64, 2), 0, sc2.n_devices).to(dev)
    rows, masks, _ = eng._exchange_groups(
        member, torch.as_tensor(warm_a, device=dev), pairs)
    exch = gs_kernel_line("flat_exchange_batch",
                          kernel_inputs(eng._ex_bucket, rows, masks), iters,
                          "coarse")

    # where a warm rerun's host time goes: a second tick under cProfile
    # (its seconds include the profiler's own cost)
    sc3, delta3 = perturb_scenario(sc2, **{**SCALE_PERTURB, "seed": 2})
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    eng.rerun_incremental(sc3, delta3, max_moves=SCALE_MOVES,
                          exchange_samples=0, finalize=False)
    torch.cuda.synchronize()
    prof.disable()
    profiled_s = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    emit("scale_warm_profile", seconds_profiled=profiled_s,
         moves=eng.last_moves, stale_rows=eng.last_counts["init_rows"],
         prepare_s=eng.last_timing["prepare_s"],
         init_s=eng.last_timing["init_s"],
         by_own_time=[dict(function=f"{Path(f).name}:{line}:{name}",
                           calls=v[1], own_s=v[2], cumulative_s=v[3])
                      for (f, line, name), v in top])
    return dict(launches=launches, cold=cold, warm=warm,
                bucket_refresh=refresh, flat_exchange_batch=exch,
                cold_assignment=cold_a0, warm_assignment=warm_a)


class HookedRunner:
    """A live runner as ``train_federated``'s round policy that keeps the
    trainer and checks, after every round, that the admitted view's loads
    are within the caps."""

    def __init__(self, runner):
        self.runner, self.trainer, self.max_over = runner, None, 0

    def begin_round(self, trainer, r):
        import numpy as np
        self.trainer = trainer
        out = self.runner.begin_round(trainer, r)
        sc = self.runner.sc
        if sc.capacity is not None:
            load = np.bincount(self.runner.assignment[sc.active_mask],
                               minlength=sc.n_servers)
            self.max_over = max(self.max_over,
                                int((load - sc.capacity).max()))
        return out


def hier_aggregate_masked(dev, trainer, assignment, n_servers) -> dict:
    """The hier_aggregate kernel at the live loop's masked stacks, from
    ``trainer`` after its last round: the cloud stack with the parked
    clients at weight 0, and the largest edge group with every weight 0
    (an edge whose clients have all departed). Bit-equal to the plain
    version (asserted); an all-zero edge averages to 0 (asserted). Times,
    bound and ``torch.mv``'s time."""
    import numpy as np
    import torch
    from repro_torch.kernels import hier_aggregate, ref
    w = trainer._weights()
    parked = int((~trainer.client_mask).sum())
    edge = int(np.argmax(np.bincount(assignment, minlength=n_servers)))
    rows = torch.as_tensor(np.flatnonzero(assignment == edge), device=dev)
    out = {}
    for case, u, wt, n_parked in (
            ("masked_cloud", trainer.flat, w, parked),
            ("zero_weight_edge", trainer.flat.index_select(0, rows),
             torch.zeros(rows.numel(), device=dev), int(rows.numel()))):
        got = hier_aggregate.hier_aggregate(u, wt)
        torch.cuda.synchronize()
        want = ref.hier_aggregate_ref(u, wt)
        c_, p_ = u.shape
        nbytes = (c_ + 1) * p_ * 4 + c_ * 4
        b_ms, b_by = bound_ms(2 * c_ * p_ + c_, nbytes)
        wn = wt / wt.sum().clamp_min(1e-30)
        fields = dict(
            kernel="hier_aggregate", case=case, shape=[c_, p_],
            parked=n_parked, bitwise=bool(torch.equal(got, want)),
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(lambda: hier_aggregate.hier_aggregate(u, wt), reps=50),
            plain_ms=cuda_ms(lambda: ref.hier_aggregate_ref(u, wt), reps=3),
            library_ms=cuda_ms(lambda: torch.mv(u.t(), wn), reps=50),
            library="torch.mv(u.T, w_normalised)", bytes=nbytes,
            bound_ms=b_ms, bound_by=b_by)
        emit("kernel", **fields)
        out[case] = fields
        if not fields["bitwise"]:
            raise AssertionError(f"hier_aggregate {case} differs from its "
                                 "plain version")
        if case == "zero_weight_edge" and float(got.abs().max()) != 0.0:
            raise AssertionError("an all-zero-weight edge must average to 0")
    if parked == 0:
        raise AssertionError("the live run parked no client")
    return out


def live_path(dev) -> dict:
    """Phase 18: the live HFEL policy run of the JAX live benchmark on the
    card: ``make_large_scenario(250, 10)`` and 250 MNIST-like clients, 8
    rounds, re-solve every 2, ``DEFAULT_CHURN``, L = I = 2, lr 0.05, for
    the three policies (``run_live``; the warm one through
    ``LiveHFELRunner`` as ``train_federated``'s round policy, to keep its
    trainer): warm and cold swap assignments identical and cumulative
    costs within 1e-6, both cheaper than static (asserted); seconds per
    policy. The hier_aggregate kernel at the warm run's masked stacks
    (:func:`hier_aggregate_masked`). Then one capacitated incremental-warm
    run on ``make_large_scenario(2000, 20, spread_m=60, cap_slack=1.1)``, 2
    rounds: admitted, queued, rejected, every placement within its cap
    (asserted). Returns the launches of both kernels and the masked-stack
    line."""
    import numpy as np
    import torch
    from repro_torch.core.scenario import make_large_scenario
    from repro_torch.data import make_mnist_like
    from repro_torch.fl import (DEFAULT_CHURN, LiveHFELRunner, run_live,
                                train_federated)
    from repro_torch.kernels import golden_section, hier_aggregate
    sc = make_large_scenario(250, 10, seed=0, device=dev)
    ds = make_mnist_like(250, samples_total=3000, seed=0)
    opts = dict(resolve_every=2, churn=DEFAULT_CHURN, seed=0,
                profile="coarse", rel_tol=1e-3)
    train = dict(local_iters=2, edge_iters=2, lr=0.05, eval_every=8)
    golden_section.LAUNCHES = hier_aggregate.LAUNCHES = 0
    hists, rows, hooked = {}, {}, None
    for policy in ("static", "periodic-cold", "incremental-warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if policy == "incremental-warm":
            hooked = HookedRunner(LiveHFELRunner(
                sc, ds.n_clients, policy=policy, device=dev, **opts))
            train_hist = train_federated(
                ds, method="hfel", n_servers=sc.n_servers, rounds=8,
                model="mlr", seed=0, round_hook=hooked, device=dev, **train)
            h = hooked.runner.history
            h.train = train_hist
        else:
            h = run_live(sc, ds, policy=policy, rounds=8, device=dev,
                         **opts, **train)
        torch.cuda.synchronize()
        hists[policy] = h
        rows[policy] = dict(total_s=time.perf_counter() - t0,
                            assoc_s=h.assoc_seconds_total,
                            assoc_seconds=h.assoc_seconds,
                            cumulative_cost=h.cumulative_cost,
                            moves=[int(m) for m in h.moves],
                            swap_rounds=h.swap_rounds,
                            n_active=h.n_active,
                            final_test_acc=h.train.test_acc[-1])
    warm, cold = hists["incremental-warm"], hists["periodic-cold"]
    static = hists["static"]
    same = (warm.swap_rounds == cold.swap_rounds
            and all(np.array_equal(a, b) for a, b in
                    zip(warm.swap_assignments, cold.swap_assignments)))
    rel = (abs(warm.cumulative_cost - cold.cumulative_cost)
           / cold.cumulative_cost)
    launches = dict(golden_section=golden_section.LAUNCHES,
                    hier_aggregate=hier_aggregate.LAUNCHES)
    emit("live_path", n_devices=250, n_servers=10, rounds=8,
         resolve_every=2, churn=DEFAULT_CHURN, warm_equals_cold=bool(same),
         cumulative_cost_rel_gap=rel, launches=launches, **rows)
    if not (same and rel <= 1e-6):
        raise AssertionError("warm and cold live policies disagree")
    for h in (warm, cold):
        if not h.cumulative_cost <= static.cumulative_cost * (1 + 1e-9):
            raise AssertionError(f"{h.policy} is not cheaper than static")
    if not all(np.isfinite(h.system_cost).all() for h in hists.values()):
        raise AssertionError("a live round's cost is not finite")
    runner = hooked.runner
    masked = hier_aggregate_masked(
        dev, hooked.trainer, runner.bridge.client_assignment(
            runner.assignment), sc.n_servers)

    golden_section.LAUNCHES = hier_aggregate.LAUNCHES = 0
    scc = make_large_scenario(2000, 20, seed=0, spread_m=60.0, cap_slack=1.1,
                              device=dev)
    dsc = make_mnist_like(128, samples_total=2000, seed=0)
    runner = LiveHFELRunner(scc, dsc.n_clients, policy="incremental-warm",
                            churn=DEFAULT_CHURN, seed=0, device=dev)
    hooked = HookedRunner(runner)
    t0 = time.perf_counter()
    train_federated(dsc, method="hfel", n_servers=scc.n_servers,
                    local_iters=1, edge_iters=1, rounds=2, lr=0.05,
                    eval_every=2, round_hook=hooked, device=dev)
    torch.cuda.synchronize()
    h = runner.history
    emit("live_admission", n_devices=2000, n_servers=20, cap_slack=1.1,
         rounds=2, seconds=time.perf_counter() - t0,
         assoc_s=h.assoc_seconds_total, moves=h.moves,
         n_active=h.n_active, n_admitted=h.n_admitted, n_queued=h.n_queued,
         n_rejected=h.n_rejected, system_cost=h.system_cost,
         max_load_over_cap=hooked.max_over)
    if hooked.max_over > 0:
        raise AssertionError("a live placement exceeds its server's cap")
    launches = {k_: launches[k_] + v for k_, v in (
        ("golden_section", golden_section.LAUNCHES),
        ("hier_aggregate", hier_aggregate.LAUNCHES))}
    return dict(launches=launches, masked=masked["masked_cloud"],
                zero_edge=masked["zero_weight_edge"], warm=warm)


def live_scale(dev) -> dict:
    """Phase 19: one incremental-warm live run at N = 50k / K = 500 on one
    card (128 clients, 2 rounds, 64 exchanges, at most 8000 moves, L = I =
    1): seconds, association seconds, moves and per-round cost. Returns
    the launches."""
    import numpy as np
    import torch
    from repro_torch.core.scenario import make_large_scenario
    from repro_torch.data import make_mnist_like
    from repro_torch.fl import run_live
    from repro_torch.kernels import golden_section, hier_aggregate
    sc = make_large_scenario(SCALE_N, SCALE_K, seed=0, spread_m=SCALE_SPREAD,
                             device=dev)
    ds = make_mnist_like(128, samples_total=2000, seed=0)
    golden_section.LAUNCHES = hier_aggregate.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = run_live(sc, ds, policy="incremental-warm", rounds=2,
                 resolve_every=1, churn=LIVE_SCALE_CHURN, seed=0,
                 local_iters=1, edge_iters=1, eval_every=2,
                 profile="coarse", rel_tol=1e-2, compact="bucketed",
                 exchange_samples=64, max_moves=SCALE_MOVES, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(golden_section=golden_section.LAUNCHES,
                    hier_aggregate=hier_aggregate.LAUNCHES)
    emit("live_scale", n_devices=SCALE_N, n_servers=SCALE_K, clients=128,
         rounds=2, churn=LIVE_SCALE_CHURN, total_s=total_s,
         assoc_s=h.assoc_seconds_total, assoc_seconds=h.assoc_seconds,
         moves=h.moves, stable=[m < SCALE_MOVES for m in h.moves],
         system_cost=h.system_cost, n_active=h.n_active,
         n_arrived=h.n_arrived, n_departed=h.n_departed,
         test_acc=h.train.test_acc, launches=launches)
    # a round at its move cap is a finding (``stable`` above), not a fault
    if not (np.isfinite(h.system_cost).all() and len(h.moves) == 2):
        raise AssertionError("live_scale rounds are not finite")
    return dict(launches=launches)


def compact_card_vs_cpu(dev) -> None:
    """Phase 20: the bucketed engine with 64 exchanges on
    ``make_scenario(16, 4, seed=1, reach_m=300)``, then ``rerun_incremental``
    after one churn tick, on the card and on the CPU: the same assignments
    (asserted). ``run_live`` at N = 40 / K = 4, 2 rounds, verify on, card
    and CPU: the same swap assignments (asserted)."""
    import numpy as np
    from repro_torch.core.assoc_fast import FastAssociationEngine
    from repro_torch.core.scenario import (make_large_scenario,
                                           make_scenario, perturb_scenario)
    from repro_torch.data import make_mnist_like
    from repro_torch.fl import DEFAULT_CHURN, run_live
    sc = make_scenario(16, 4, seed=1, reach_m=300.0, device="cpu")
    sc2, delta = perturb_scenario(sc, seed=5, drift_m=80.0, move_frac=0.2,
                                  flip_frac=0.1, depart_frac=0.15)
    out = {}
    for where in (dev, "cpu"):
        eng = FastAssociationEngine(sc, compact="bucketed", device=where)
        first = eng.run("nearest", finalize=False)
        counts = dict(eng.last_counts)
        second = eng.rerun_incremental(sc2, delta, verify=True,
                                       finalize=False)
        out[str(where)] = (first, second, counts, eng.last_moves)
    card, cpu = out[str(dev)], out["cpu"]
    same_engine = (np.array_equal(card[0], cpu[0])
                   and np.array_equal(card[1], cpu[1])
                   and card[2] == cpu[2] and card[3] == cpu[3])
    sc40 = make_large_scenario(40, 4, seed=0, device="cpu")
    ds40 = make_mnist_like(40, samples_total=800, seed=0)
    lives = {where: run_live(sc40, ds40, policy="incremental-warm",
                             rounds=2, resolve_every=1, churn=DEFAULT_CHURN,
                             seed=0, local_iters=1, edge_iters=1,
                             profile="coarse", rel_tol=1e-3, verify=True,
                             device=where)
             for where in (dev, "cpu")}
    hc, hp = lives[dev], lives["cpu"]
    same_live = (hc.swap_rounds == hp.swap_rounds
                 and all(np.array_equal(a, b) for a, b in
                         zip(hc.swap_assignments, hp.swap_assignments)))
    emit("compact_card_vs_cpu", fixture=[16, 4, 1], compact="bucketed",
         counts_card=card[2], counts_cpu=cpu[2],
         warm_moves=[card[3], cpu[3]], same_engine=bool(same_engine),
         live_fixture=[40, 4, 0], live_swaps=hc.swap_rounds,
         live_cost_card=hc.system_cost, live_cost_cpu=hp.system_cost,
         same_live=bool(same_live))
    if not (same_engine and same_live):
        raise AssertionError("card and CPU disagree in a compact space or "
                             "in the live loop")


# ---- phase 28: the sharded sweep and Algorithm 1's collectives ----

SHARDS = 4             # (a)-(c): four shards, all on the one card
LIVE_SHARDS = 2        # (d)
# (e): a (pod=2, data=2) mesh of gloo ranks over CUDA tensors (NCCL refuses
# two ranks on one card), each rank's weight; the MLP's leaves at MNIST
# width (phase 6) as the tree; plain float64 means on one process as the
# reference, |got - want| <= rtol x the same mean over |x|
COLLECTIVE_WEIGHTS = (1.0, 2.0, 3.0, 4.0)
COLLECTIVE_SHAPES = {"w1": (784, 128), "b1": (128,), "w2": (128, 10),
                     "b2": (10,)}
COLLECTIVE_RTOL = 1e-6
COLLECTIVE_REPS = 20
COLLECTIVE_GROUPS = {"data": [[0, 1], [2, 3]], "pod": [[0, 2], [1, 3]]}
LEVEL_NAMES = ("LOCAL", "EDGE", "CLOUD")


def collective_inputs(rank: int) -> dict:
    """Rank ``rank``'s tree: float32 normals from seed 100 + rank."""
    import numpy as np
    rng = np.random.default_rng(100 + rank)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k, shape in COLLECTIVE_SHAPES.items()}


def collective_rank(rank: int, world: int, backend: str, out: str) -> None:
    """One spawned rank of phase 28e on the card: ``psum_mean`` over each
    axis, weighted and not, and ``hierarchical_sync`` at every level of its
    tree (a (pod, data) mesh of ``world`` ranks from
    ``launch.mesh.make_test_mesh``), then the seconds of
    ``COLLECTIVE_REPS`` cloud syncs; written to ``out/rank<r>.npz``."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    try:
        from repro_torch.core.hierarchy import (SyncLevel, hierarchical_sync,
                                                psum_mean)
        from repro_torch.launch.mesh import batch_axes, make_test_mesh, n_pods
        mesh = make_test_mesh((2, world // 2) if world > 1 else (1, 1),
                              ("pod", "data"), device_type="cuda")
        tree = {k: torch.from_numpy(v).cuda()
                for k, v in collective_inputs(rank).items()}
        w = COLLECTIVE_WEIGHTS[rank]
        res = {}
        for axis in ("data", "pod"):
            res[f"mean_{axis}"] = psum_mean(tree, axis, mesh=mesh)
            res[f"wmean_{axis}"] = psum_mean(tree, axis, w, mesh=mesh)
        for name in LEVEL_NAMES:
            res[f"sync_{name}"] = hierarchical_sync(
                tree, SyncLevel[name], mesh=mesh, weight=w)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(COLLECTIVE_REPS):
            hierarchical_sync(tree, SyncLevel.CLOUD, mesh=mesh, weight=w)
        torch.cuda.synchronize()
        cloud_ms = 1e3 * (time.perf_counter() - t0) / COLLECTIVE_REPS
        on_card = all(x.is_cuda for t in res.values() for x in t.values())
        np.savez(f"{out}/rank{rank}.npz",
                 **{f"{case}/{k}": x.cpu().numpy()
                    for case, t in res.items() for k, x in t.items()},
                 cloud_ms=cloud_ms, on_card=on_card,
                 backend=dist.get_backend(), batch_axes=batch_axes(mesh),
                 n_pods=n_pods(mesh))
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, backend: str, out: str) -> tuple[list, float]:
    """Phase 28e's ranks as spawned processes, joined; (each rank's
    results, seconds from spawn to join)."""
    import numpy as np
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.start_processes(collective_rank, args=(world, backend, out),
                       nprocs=world, join=True, start_method="spawn")
    seconds = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with np.load(f"{out}/rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks, seconds


def collective_want(case: str, leaf: str):
    """Plain float64 means of phase 28e's case for every rank: (want (4,
    ...), the same mean over |x|)."""
    import numpy as np
    x = np.stack([collective_inputs(r)[leaf] for r in range(4)]
                 ).astype(np.float64)

    def mean(v, axis, weights=None):
        w = np.ones(4) if weights is None else np.asarray(weights)
        out = np.empty_like(v)
        for group in COLLECTIVE_GROUPS[axis]:
            wg = w[group].reshape((-1,) + (1,) * (v.ndim - 1))
            out[group] = (wg * v[group]).sum(0) / wg.sum()
        return out

    def of(v):
        kind, rest = case.split("_", 1)
        if kind == "mean":
            return mean(v, rest)
        if kind == "wmean":
            return mean(v, rest, COLLECTIVE_WEIGHTS)
        if rest == "LOCAL":
            return v
        edge = mean(v, "data", COLLECTIVE_WEIGHTS)
        return edge if rest == "EDGE" else mean(edge, "pod")

    return of(x), of(np.abs(x))


def collectives(dev) -> dict:
    """Phase 28e: ``psum_mean`` and ``hierarchical_sync`` over a (pod=2,
    data=2) mesh of four gloo ranks on the one card, against plain weighted
    means on one process (asserted within ``COLLECTIVE_RTOL`` of the
    magnitudes), with the seconds of a cloud sync; then a 1-rank NCCL
    mesh whose mean over ``data`` is its own tree (asserted)."""
    import numpy as np
    cases = ([f"{k}_{a}" for k in ("mean", "wmean") for a in ("data", "pod")]
             + [f"sync_{n}" for n in LEVEL_NAMES])
    with tempfile.TemporaryDirectory() as tmp:
        ranks, gloo_s = spawn_ranks(4, "gloo", tmp)
        nccl_dir = os.path.join(tmp, "nccl")
        os.makedirs(nccl_dir)
        nccl, nccl_s = spawn_ranks(1, "nccl", nccl_dir)
    errs = {}
    for case in cases:
        worst = 0.0
        for leaf in COLLECTIVE_SHAPES:
            want, scale = collective_want(case, leaf)
            got = np.stack([r[f"{case}/{leaf}"] for r in ranks])
            worst = max(worst, float((np.abs(got - want) / scale).max()))
        errs[case] = worst
    x0 = collective_inputs(0)
    nccl_same = all(np.array_equal(nccl[0][f"mean_data/{k}"], x0[k])
                    and np.array_equal(nccl[0][f"sync_CLOUD/{k}"], x0[k])
                    for k in COLLECTIVE_SHAPES)
    on_card = bool(all(r["on_card"] for r in ranks + nccl))
    fields = dict(
        mesh={"pod": 2, "data": 2}, backend=str(ranks[0]["backend"]),
        ranks_on_one_card=4, tree_shapes=COLLECTIVE_SHAPES,
        weights=COLLECTIVE_WEIGHTS, rtol=COLLECTIVE_RTOL,
        max_err_over_magnitude=errs, outputs_on_card=on_card,
        batch_axes=ranks[0]["batch_axes"].tolist(),
        n_pods=int(ranks[0]["n_pods"]),
        cloud_sync_ms=[float(r["cloud_ms"]) for r in ranks],
        spawn_to_join_s=gloo_s, nccl_backend=str(nccl[0]["backend"]),
        nccl_ranks=1, nccl_mean_is_input=bool(nccl_same),
        nccl_cloud_sync_ms=float(nccl[0]["cloud_ms"]),
        nccl_spawn_to_join_s=nccl_s)
    emit("collectives", **fields)
    if not (max(errs.values()) <= COLLECTIVE_RTOL and on_card
            and nccl_same and fields["batch_axes"] == ["pod", "data"]
            and fields["n_pods"] == 2
            and fields["nccl_backend"] == "nccl"):
        raise AssertionError("the collectives disagree with the plain "
                             f"means: {errs}")
    return fields


def sharded_run(make, run) -> dict:
    """Build an engine (``make``), run it (``run``) under the card's clock
    with the golden-section launches counted: (engine, result, seconds,
    launches)."""
    import torch
    from repro_torch.kernels import golden_section
    golden_section.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = make()
    res = run(eng)
    torch.cuda.synchronize()
    return eng, res, time.perf_counter() - t0, golden_section.LAUNCHES


def sharded_path(dev, main_sc, main_res, ex, scale, live) -> dict:
    """Phase 28 (a)-(d): the sharded sweep with its shards on the card
    (``shard_devices``), against the unsharded phases: (a) phase 4's
    transfer-only descent at p = 1 and 4 (and across the first cards when
    there are several): the same assignment, moves and trace bits, K + 2
    moves + 1 launches (asserted); (b) phase 4b's exchange descent at p = 4:
    the same moves, exchanges, exchange rounds, assignment and trace, K + 2
    moves + p rounds + 1 launches (asserted); (c) phase 17's N = 50k cold
    descent and warm rerun at p = 4, the same stable points and moves
    (asserted); (d) phase 18's incremental-warm live run at p = 2, the same
    swaps (asserted). Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core.assoc_fast import FastAssociationEngine
    from repro_torch.core.scenario import (make_large_scenario,
                                           perturb_scenario)
    from repro_torch.data import make_mnist_like
    from repro_torch.fl import DEFAULT_CHURN, run_live
    k = main_sc.n_servers
    cards = torch.cuda.device_count()
    distinct = cards > 1
    emit("sharded_setup", distinct_cards=distinct, cards=cards,
         shards=SHARDS, shard_devices=[str(dev)] * SHARDS)
    launches = {}

    def on_card(p):
        return [dev] * p

    # (a) transfers only, phase 4's scenario
    want = main_res
    runs = {}
    for name, opts in [("p1", dict(shards=1, shard_devices=on_card(1))),
                       ("p4", dict(shards=SHARDS,
                                   shard_devices=on_card(SHARDS)))] + (
            [("distinct", dict(shards=min(SHARDS, cards)))] if distinct
            else []):
        eng, res, secs, n_launch = sharded_run(
            lambda: FastAssociationEngine(main_sc, device=dev, **opts),
            lambda e: e.run("nearest", exchange_samples=0))
        moves = res.n_adjustments
        same = (np.array_equal(res.assignment, want.assignment)
                and moves == want.n_adjustments
                and bits(res.cost_trace) == bits(want.cost_trace))
        runs[name] = dict(
            shards=eng.shards, devices=sorted({str(d) for d in
                                               eng.shard_devices}),
            moves=moves, seconds=secs, init_s=eng.last_timing["init_s"],
            ms_per_move=1e3 * eng.last_timing["moves_s"] / max(moves, 1),
            launches=n_launch, launches_expected=k + 2 * moves + 1,
            same_as_phase_4=bool(same))
        launches[f"transfers_{name}"] = n_launch
        if not (same and n_launch == k + 2 * moves + 1):
            emit("sharded_path", part="transfers", **runs)
            raise AssertionError(f"sharded transfers ({name}) differ from "
                                 "phase 4 or launched otherwise")
    emit("sharded_path", part="transfers", n_devices=main_sc.n_devices,
         n_servers=k, **runs)

    # (b) exchanges, phase 4b's random start
    want, counts = ex["res"], ex["counts"]
    eng, res, secs, n_launch = sharded_run(
        lambda: FastAssociationEngine(main_sc, device=dev, shards=SHARDS,
                                      shard_devices=on_card(SHARDS)),
        lambda e: e.run("random"))
    moves, got = res.n_adjustments, eng.last_counts
    expected = k + 2 * moves + SHARDS * got["exchange_rounds"] + 1
    same = (got == counts and moves == want.n_adjustments
            and np.array_equal(res.assignment, want.assignment)
            and bits(res.cost_trace) == bits(want.cost_trace))
    launches["exchanges"] = n_launch
    emit("sharded_path", part="exchanges", shards=SHARDS, moves=moves,
         **got, seconds=secs, init_s=eng.last_timing["init_s"],
         ms_per_move=1e3 * eng.last_timing["moves_s"] / max(moves, 1),
         ms_per_exchange_round=1e3 * eng.last_timing["exchange_pricing_s"]
         / max(got["exchange_rounds"], 1), launches=n_launch,
         launches_expected=expected, same_as_phase_4b=bool(same))
    if not (same and n_launch == expected):
        raise AssertionError("sharded exchanges differ from phase 4b or "
                             "launched otherwise")

    # (c) N = 50k, phase 17's cold descent and churn tick
    opts = dict(profile="coarse", rel_tol=1e-2, compact="bucketed",
                device=dev, shards=SHARDS, shard_devices=on_card(SHARDS))
    sc = make_large_scenario(SCALE_N, SCALE_K, seed=0, spread_m=SCALE_SPREAD,
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    eng, cold_a, cold_s, n_cold = sharded_run(
        lambda: FastAssociationEngine(sc, **opts),
        lambda e: e.run("nearest", max_moves=SCALE_MOVES, exchange_samples=0,
                        finalize=False))
    cold_moves, cold_init = eng.last_moves, eng.last_timing["init_s"]
    sc2, delta = perturb_scenario(sc, **SCALE_PERTURB)
    _, warm_a, warm_s, n_warm = sharded_run(
        lambda: eng, lambda e: e.rerun_incremental(
            sc2, delta, max_moves=SCALE_MOVES, exchange_samples=0,
            finalize=False))
    same = (np.array_equal(cold_a, scale["cold_assignment"])
            and cold_moves == scale["cold"]["moves"]
            and np.array_equal(warm_a, scale["warm_assignment"])
            and eng.last_moves == scale["warm"]["moves"])
    launches["scale_cold"] = n_cold
    emit("sharded_path", part="scale", shards=SHARDS, n_devices=SCALE_N,
         n_servers=SCALE_K, cold_s=cold_s, cold_init_s=cold_init,
         cold_moves=cold_moves, cold_launches=n_cold,
         phase_17_cold_s=scale["cold"]["seconds"],
         warm_s=warm_s, warm_moves=eng.last_moves,
         warm_prepare_s=eng.last_timing["prepare_s"],
         stale_rows=eng.last_counts["init_rows"], warm_launches=n_warm,
         phase_17_warm_s=scale["warm"]["seconds"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         same_as_phase_17=bool(same))
    if not same:
        raise AssertionError("the sharded N = 50k sweep differs from phase "
                             "17's")
    del eng, sc, sc2

    # (d) phase 18's incremental-warm live run at p = 2
    sc = make_large_scenario(250, 10, seed=0, device=dev)
    ds = make_mnist_like(250, samples_total=3000, seed=0)
    want = live["warm"]
    _, h, secs, n_live = sharded_run(lambda: None, lambda _: run_live(
        sc, ds, policy="incremental-warm", rounds=8, resolve_every=2,
        churn=DEFAULT_CHURN, seed=0, profile="coarse", rel_tol=1e-3,
        local_iters=2, edge_iters=2, lr=0.05, eval_every=8, model="mlr",
        shards=LIVE_SHARDS, shard_devices=on_card(LIVE_SHARDS), device=dev))
    same = (h.swap_rounds == want.swap_rounds
            and all(np.array_equal(a, b) for a, b in
                    zip(h.swap_assignments, want.swap_assignments))
            and h.moves == want.moves)
    launches["live"] = n_live
    emit("sharded_path", part="live", shards=LIVE_SHARDS, seconds=secs,
         assoc_s=h.assoc_seconds_total, swap_rounds=h.swap_rounds,
         moves=[int(m) for m in h.moves], launches=n_live,
         same_as_phase_18=bool(same))
    if not same:
        raise AssertionError("the sharded live run swaps otherwise than "
                             "phase 18's")
    return dict(launches=launches, total=sum(launches.values()),
                transfers=runs)


# ---------------------------------------------------------------------------
# 21-24. LM training on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_SEQ = "qwen3-0.6b", 4096       # train_4k's sequence
TRAIN_SYNC_BATCH, TRAIN_SYNC_STEPS = 4, 3        # train_4k's 256, cut to 4
TRAIN_PODS, TRAIN_PER_POD, TRAIN_HIER_STEPS = 2, 2, 4
TRAIN_EDGE_PERIOD, TRAIN_TOPK = 2, 0.01          # two cloud syncs
TRAIN_PEAK_LIMIT = 75e9   # bytes; past it the batch is halved (PERF.md)
SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS = "mamba2-1.3b", 8   # depth 8 of 48
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 2, 2048, 2
# each backward function's profiler range (``record_function`` label)
BWD_LABELS = {"flash_attention": "flash_attention_bwd",
              "rmsnorm": "rmsnorm_bwd",
              "ssd_state_scan": "ssd_state_scan_bwd"}
# the MoE dispatch's ops in a train step's profile (models/moe.py): the
# scatter of token copies into the expert buffer (``index_copy_``, its
# backward a row gather) and the gather out of the (E, C, d) buffer
# (advanced indexing, its backward an accumulating ``index_put_`` into
# zeros of that shape); (op, rank of its first input, or None). The rank
# tells the MoE gather from the embedding lookup, the same ops on a 2-D
# table.
DISPATCH_OPS = {"index_copy_fwd": ("aten::index_copy_", None),
                "index_copy_bwd": ("IndexCopyBackward0", None),
                "gather_fwd": ("aten::index", 3),
                "gather_bwd": ("aten::_index_put_impl_", 3)}
# card vs CPU of the train step (reduced float32 models): the loss,
# gradients and moments at 1e-4 (atol 1e-4 x the leaf's largest value, the
# CPU tests' bound for JAX parity); parameters after AdamW's first step the
# same, but entries whose gradient is within that bound of zero move by
# lr * g / (|g| + 1e-8) of either sign and are held to lr; the cloud sync
# on identical inputs at 1e-6. Each backward function on its own: the
# norm and the scan in float32 at 1e-5, flash in bf16 under FLASH_TOL.
TRAIN_TOL, SYNC_TOL, GRAD_TOL_F32 = 1e-4, 1e-6, 1e-5


def no_remat(cfg):
    """``cfg`` with ``remat="none"``: the train phases 21-29 pin it, so
    that their launch counts (one a forward) and times stay comparable
    with the runs before the port had ``remat`` (its default is JAX's
    "block"); phase 30 measures "block" against "none"."""
    import dataclasses
    return dataclasses.replace(cfg, remat="none")


class StepClock:
    """The ``clock`` of a train step: a CUDA event at each mark; after a
    synchronize, ``split()`` gives the milliseconds from each mark to the
    next, summed by the earlier mark's label."""

    def __init__(self):
        self.marks = []

    def __call__(self, label: str) -> None:
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((label, ev))

    def split(self) -> dict:
        out = {}
        for (label, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[label] = out.get(label, 0.0) + a.elapsed_time(b)
        return out


def train_flops(cfg, params, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x each parameter x the positions
    it multiplies (forward and backward of every matrix product; the tied
    table's read-out included), plus attention's QK^T and PV over the
    visible pairs, three times over (forward, and the backward's four
    products at twice the forward's cost). A VLM's positions are its
    prefix's and its tokens'. An MoE layer counts its active parameters:
    the router, ``top_k`` of its routed experts and the shared ones.
    An encoder-decoder's encoder (and its decoder's cross k, v
    projections) multiply the frames, the rest of its decoder the tokens
    (``pos_embed`` is added, not multiplied); its encoder and cross
    attention see every pair, its decoder's self attention the causal
    ones. MLA's products run over its q/k and v widths, not the padding.
    An untied embedding table is a lookup, not a product."""
    from repro_torch.utils import tree_leaves_with_path
    positions = seq + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    frames = cfg.encoder_seq_len if cfg.family == "encdec" else 0
    moe = cfg.moe

    def uses(path) -> float:
        """Positions a leaf multiplies, times its active fraction."""
        if path[0] == "embed" and not cfg.tie_embeddings:
            return 0.0
        if cfg.family == "encdec":
            if path[0] == "pos_embed":
                return 0.0
            if path[0] in ("enc_blocks", "enc_norm") or (
                    path[0] == "dec_blocks" and path[1] == "cross_attn"
                    and path[2] in ("wk", "wv")):
                return float(frames)
        if moe is not None and "experts" in path:
            return positions * moe.top_k / moe.n_experts
        return float(positions)

    matmul = sum(6.0 * leaf.numel() * uses(path) * batch
                 for path, leaf in tree_leaves_with_path(params))
    if cfg.mla is not None:
        qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        vd = cfg.mla.v_head_dim
    else:
        qk = vd = cfg.resolved_head_dim
    per_pair = 3 * 2 * cfg.n_heads * (qk + vd) * batch

    def causal(n):
        return n * (n + 1) // 2

    if cfg.family == "encdec":
        pairs = (cfg.n_encoder_layers * frames * frames
                 + cfg.n_layers * (causal(seq) + seq * frames))
    elif cfg.family in ("dense", "vlm", "moe"):
        pairs = cfg.n_layers * causal(positions)
    elif cfg.hybrid_attn_period:
        pairs = cfg.n_layers // cfg.hybrid_attn_period * causal(positions)
    else:
        pairs = 0
    return matmul + per_pair * pairs


def train_launches_per_forward(cfg) -> dict:
    """Each kernel's launches in one training forward, by family (each
    launch has one backward call): flash once per attention (whisper:
    encoder, decoder self and cross), rmsnorm at every parametric RMS
    norm (two a layer and the final one; none under LayerNorm), the scan
    once per SSM layer."""
    flash = {"dense": cfg.n_layers, "vlm": cfg.n_layers,
             "moe": cfg.n_layers, "ssm": 0,
             "encdec": cfg.n_encoder_layers + 2 * cfg.n_layers}[cfg.family]
    return {"flash_attention": flash,
            "rmsnorm": 0 if cfg.norm_type == "layernorm"
            else 2 * cfg.n_layers + 1,
            "ssd_state_scan": cfg.n_layers if cfg.family == "ssm" else 0}


def profile_train(phase: str, fn, shapes: bool = False) -> dict | None:
    """``fn()`` (one train step) under ``torch.profiler``: wall and device
    time, idle share, each backward function's device time (its
    ``record_function`` range, the kernels it launched included; flash's
    backward kernels by name) and its
    share of the profiled step, the MoE dispatch's ops (``DISPATCH_OPS``;
    ``shapes`` records the input shapes that tell them apart, at some
    host cost), and the top kernels. None when the profiler fails
    (reported on the phase's line)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=shapes)
        prof.start()
    except (RuntimeError, AttributeError) as exc:
        emit(phase, error=repr(exc))
        return None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    except BaseException:
        try:
            prof.stop()
        except (RuntimeError, AttributeError):
            pass
        raise
    try:
        prof.stop()
        kernels, bwd, dispatch = [], {}, {}
        labels = set(BWD_LABELS.values())
        for e in prof.key_averages(group_by_input_shape=True):
            on_host = "CPU" in str(e.device_type)
            op = [name for name, (key, rank) in DISPATCH_OPS.items()
                  if e.key == key and (rank is None or (
                      e.input_shapes and len(e.input_shapes[0]) == rank))]
            if e.key in labels:
                if on_host:      # a label's shape groups summed
                    b = bwd.setdefault(e.key, dict(device_ms=0.0,
                                                   host_ms=0.0, calls=0))
                    b["device_ms"] += e.device_time_total / 1e3
                    b["host_ms"] += e.cpu_time_total / 1e3
                    b["calls"] += e.count
            elif op and on_host:
                d = dispatch.setdefault(op[0], dict(device_ms=0.0, calls=0))
                d["device_ms"] += e.device_time_total / 1e3
                d["calls"] += e.count
            elif "CUDA" in str(e.device_type):
                kernels.append((e.key, e.self_device_time_total, e.count))
    except (RuntimeError, AttributeError) as exc:
        emit(phase, error=repr(exc))
        return None
    # the flash backward's kernels launch through ctypes, which the
    # profiler does not tie to the range they run in: they count by name
    flash_bwd = sum(us for name, us, _ in kernels if "flash_bwd_" in name)
    if flash_bwd:
        entry = bwd.setdefault(BWD_LABELS["flash_attention"], dict(
            device_ms=0.0, host_ms=0.0, calls=0))
        entry["device_ms"] += flash_bwd / 1e3
    busy_ms = sum(us for _, us, _ in kernels) / 1e3
    kernels.sort(key=lambda x: -x[1])
    for v in (*bwd.values(), *dispatch.values()):
        v["share_of_step"] = v["device_ms"] / wall_ms
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, backward=bwd,
                moe_dispatch=dispatch or None,
                top=[dict(name=name[:80], ms=us / 1e3, count=cnt)
                     for name, us, cnt in kernels[:10]])


def train_run(dev, model, data, *, phase: str, mode: str, batch: int,
              steps: int, compressor=None, edge_period: int = 0, **extra):
    """``steps`` train steps of ``model`` (random float32 params, seed 0)
    in ``mode`` on the rows of ``data`` (a batch in ``batch_specs``' keys:
    step k takes rows [k * batch, (k + 1) * batch) of every key), then one
    more under the profiler. Emits the phase's line (with ``extra``): s a
    step split into forward, backward, optimizer and cloud sync; tokens/s;
    peak memory; the loss at every step (asserted finite); the kernels'
    launches and the backward functions' calls (asserted, per forward as
    ``train_launches_per_forward``); each backward's share of the
    profiled step, and the MoE dispatch's; the mfu. Returns (line fields,
    the train state)."""
    import torch
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ShapeSpec
    from repro_torch.utils import tree_size

    cfg = model.cfg
    seq = data["tokens"].shape[1] - 1
    shape = ShapeSpec(f"train_{seq}", seq, batch, "train")
    bundle = make_train_step(model, shape, mode=mode, n_pods=TRAIN_PODS,
                             compressor=compressor, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = tree_size(params)
    flops = train_flops(cfg, params, batch, seq)
    params, opt, step = bundle.init_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = [{key: v[i * batch:(i + 1) * batch].to(dev)
                for key, v in data.items()} for i in range(steps + 1)]
    mods = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
            "ssd_state_scan": ssd_scan}
    for mod in mods.values():
        mod.LAUNCHES = mod.BACKWARD_CALLS = 0
    flash_attention.BWD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for k in range(steps):
        clock = StepClock()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, step, loss = bundle.step_fn(
            params, opt, step, batches[k], clock=clock)
        torch.cuda.synchronize()
        row = dict(step=k, loss=float(loss),
                   s=time.perf_counter() - t0,
                   split_ms=clock.split())
        if mode == "hierarchical" and (k + 1) % edge_period == 0:
            t0 = time.perf_counter()
            params, opt = bundle.cloud_sync_fn(params, opt)
            torch.cuda.synchronize()
            row["cloud_sync_s"] = time.perf_counter() - t0
        rows.append(row)
    peak = torch.cuda.max_memory_allocated()
    launched = {name: (mod.LAUNCHES, mod.BACKWARD_CALLS)
                for name, mod in mods.items()}
    # backward kernel launches: flash's (one a backward call); the norm's
    # and the scan's backwards are plain PyTorch
    bwd_kernel = {name: flash_attention.BWD_LAUNCHES
                  if name == "flash_attention" else 0 for name in mods}
    forwards = steps * bundle.n_pods
    expected = {name: (forwards * n, forwards * n)
                for name, n in train_launches_per_forward(cfg).items()}
    prof = profile_train(phase + "_profile", lambda: bundle.step_fn(
        params, opt, step.clone(), batches[steps]),
        shapes=cfg.moe is not None)
    warm = rows[1:] or rows
    step_s = sum(r["s"] for r in warm) / len(warm)
    # the profiler's own host cost stretches a host-bound step: each
    # entry's device time over the warm step's unprofiled time too
    for entry in ({**prof["backward"], **(prof["moe_dispatch"] or {})}
                  .values() if prof else ()):
        entry["share_of_warm_step"] = entry["device_ms"] / (1e3 * step_s)
    syncs = [r["cloud_sync_s"] for r in rows if "cloud_sync_s" in r]
    positions = seq + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    fields = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_params=n_params, mode=mode, batch=batch, seq=seq,
        inputs={key: [list(v.shape[1:]), str(v.dtype)]
                for key, v in batches[0].items()}, **extra,
        pods=bundle.n_pods, dtype=cfg.dtype, param_dtype="float32",
        compressor=None if compressor is None else repr(compressor),
        edge_period=edge_period or None, init_s=init_s, steps=rows,
        s_per_step_warm=step_s, s_first_step=rows[0]["s"],
        split_ms_warm={key: sum(r["split_ms"].get(key, 0.0) for r in warm)
                       / len(warm)
                       for key in ("forward", "backward", "optimizer")},
        cloud_sync_s=syncs, tokens_per_s=batch * seq / step_s,
        positions_per_s=batch * positions / step_s,
        frames_per_s=(batch * cfg.encoder_seq_len / step_s
                      if cfg.family == "encdec" else None),
        max_memory_allocated=peak, peak_limit=TRAIN_PEAK_LIMIT,
        launches={name: dict(kernel=v[0], backward=v[1],
                             backward_kernel=bwd_kernel[name],
                             expected=list(expected[name]))
                  for name, v in launched.items()},
        model_flops_per_step=flops, peak_bf16_flops=PEAK_BF16_FLOPS,
        mfu=flops / (step_s * PEAK_BF16_FLOPS), profile=prof)
    emit(phase, **fields)
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: a loss is not finite: {losses}")
    if launched != expected:
        raise AssertionError(f"{phase}: launches {launched}, expected "
                             f"{expected}")
    if bwd_kernel["flash_attention"] != launched["flash_attention"][1]:
        raise AssertionError(f"{phase}: {bwd_kernel['flash_attention']} "
                             "flash backward kernel launches for "
                             f"{launched['flash_attention'][1]} backward "
                             "calls")
    if peak > TRAIN_PEAK_LIMIT:
        raise AssertionError(f"{phase}: peak memory {peak} passes "
                             f"{TRAIN_PEAK_LIMIT}")
    if prof is not None and cfg.moe is not None:
        # one of each dispatch op per MoE layer and forward: nothing else
        # on the path matched DISPATCH_OPS' keys and ranks
        want = (cfg.n_layers - cfg.moe.n_dense_layers) * bundle.n_pods
        calls = {op: (prof["moe_dispatch"] or {}).get(op, {}).get("calls")
                 for op in DISPATCH_OPS}
        if any(c != want for c in calls.values()):
            raise AssertionError(f"{phase}: MoE dispatch op calls {calls} "
                                 f"in the profiled step, expected {want} "
                                 "each")
    return fields, (params, opt, step)


def train_data(model, rows: int, seq: int, dev):
    """A training batch of ``rows`` rows in ``model.batch_specs``' keys,
    shapes and dtypes: tokens (B, seq + 1) from one ``TokenPipeline`` draw
    (seed 0; its cost is one pass over the sequence whatever the rows), an
    encoder-decoder's frames and a VLM's prefix as bf16 normals from a
    seeded generator on the card (both frontends are stubs). Returns
    (batch, seconds)."""
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.models import ShapeSpec
    t0 = time.perf_counter()
    out = {"tokens": torch.as_tensor(next(TokenPipeline(
        model.cfg.vocab_size, seq, rows, seed=0)))}
    gen = torch.Generator(device=dev).manual_seed(1)
    for key, (shape, dtype) in model.batch_specs(
            ShapeSpec("train_data", seq, rows, "train")).items():
        if key != "tokens":
            out[key] = torch.randn(shape, generator=gen,
                                   device=dev).to(dtype)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_lm_path(dev) -> dict:
    """Phases 22 and 23: full-width qwen3-0.6b (bf16 activations, float32
    params and AdamW state) at sequence 4096: ``sync`` at batch 4 for 3
    steps, then ``hierarchical`` with 2 pods x 2 sequences, a cloud sync
    every 2 steps under ``TopKCompressor(0.01)``, 4 steps; then the
    hierarchical train state through ``CheckpointManager`` and back, bit
    for bit. Returns the launches of the kernels and backwards."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import TopKCompressor
    from repro_torch.models import build_model

    cfg = no_remat(get_config(TRAIN_ARCH))
    model = build_model(cfg)
    need = max(TRAIN_SYNC_STEPS, TRAIN_HIER_STEPS) + 1
    data, data_s = train_data(
        model, need * max(TRAIN_SYNC_BATCH, TRAIN_PODS * TRAIN_PER_POD),
        TRAIN_SEQ, dev)
    sync, _ = train_run(dev, model, data, phase="train_lm_sync",
                        mode="sync", batch=TRAIN_SYNC_BATCH,
                        steps=TRAIN_SYNC_STEPS)
    torch.cuda.empty_cache()
    hier, state = train_run(dev, model, data, phase="train_lm_hierarchical",
                            mode="hierarchical",
                            batch=TRAIN_PODS * TRAIN_PER_POD,
                            steps=TRAIN_HIER_STEPS,
                            compressor=TopKCompressor(TRAIN_TOPK),
                            edge_period=TRAIN_EDGE_PERIOD)
    emit("train_lm_data", rows=data["tokens"].shape[0], seq=TRAIN_SEQ,
         pipeline_s=data_s)
    checkpoint_phase(state)
    del state
    torch.cuda.empty_cache()
    return path_launches(train_lm_sync=sync, train_lm_hierarchical=hier)


def path_launches(**runs) -> dict:
    """A train path's summary for the ``kernels`` line: each kernel's
    launches and backward calls summed over its ``runs`` (phase name ->
    ``train_run`` fields), and the runs."""
    first = next(iter(runs.values()))["launches"]
    return dict(launches={name: {key: sum(run["launches"][name][key]
                                          for run in runs.values())
                                 for key in ("kernel", "backward",
                                             "backward_kernel")}
                          for name in first}, runs=runs)


def checkpoint_phase(state) -> None:
    """Phase 23: the hierarchical train state (pod-stacked params, AdamW
    moments, step) saved through ``CheckpointManager`` (async, keep 2),
    restored into its own tree and held bit for bit; seconds, bytes and
    shards."""
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.utils import tree_leaves
    params, opt, step = state
    tree = {"params": params, "opt": opt, "step": step}
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(tree))
    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        mgr = CheckpointManager(d, keep=2)
        t0 = time.perf_counter()
        mgr.save(int(step), tree, extras={"mode": "hierarchical"})
        snapshot_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_step, got, extras = mgr.restore(tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        shards = len([f for f in os.listdir(os.path.join(
            d, f"step_{int(step):010d}")) if f.startswith("shard_")])
    same = [bool(torch.equal(a, b)) and a.dtype == b.dtype
            and a.device == b.device
            for a, b in zip(tree_leaves(got), tree_leaves(tree))]
    emit("checkpoint", leaves=len(same), bytes=nbytes, disk_free=free,
         shards=shards, step=got_step, extras=extras,
         snapshot_s=snapshot_s, save_s=save_s, restore_s=restore_s,
         bit_identical=all(same))
    if not (all(same) and got_step == int(step)
            and len(same) == len(tree_leaves(tree))):
        raise AssertionError("checkpoint: the restored state differs")


def train_ssm_path(dev) -> dict:
    """Phase 24: mamba2-1.3b at full width (d_model 2048), depth cut to 8
    of 48 layers, batch 2 x 2048, 2 ``sync`` steps: the scan kernel and
    the gated norm with their backwards. Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = no_remat(dataclasses.replace(get_config(SSM_TRAIN_ARCH),
                                       n_layers=SSM_TRAIN_LAYERS))
    model = build_model(cfg)
    data, data_s = train_data(model, (SSM_TRAIN_STEPS + 1)
                              * SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, dev)
    run, _ = train_run(dev, model, data, phase="train_ssm_sync",
                       mode="sync", batch=SSM_TRAIN_BATCH,
                       steps=SSM_TRAIN_STEPS)
    emit("train_ssm_data", rows=data["tokens"].shape[0], seq=SSM_TRAIN_SEQ,
         pipeline_s=data_s)
    torch.cuda.empty_cache()
    return path_launches(train_ssm_sync=run)


def grad_close(got, want, rtol: float,
               scale: float | None = None) -> tuple[float, bool]:
    """Largest |got - want| and whether every entry is within rtol x
    (|want| elementwise + ``scale``, by default the leaf's largest
    |want|); with a ``scale`` given (a leaf whose exact value is zero,
    ``zero_grad_scales``) |want| must lie within rtol x scale too."""
    import torch
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = (got - want).abs()
    ok = scale is None or bool((want.abs() <= rtol * scale).all())
    scale = want.abs().max() if scale is None else scale
    ok = ok and bool(torch.isfinite(got).all()
                     and (err <= rtol * (want.abs() + scale)).all())
    return float(err.max()), ok


def step_close(got, want, grads, lr: float,
               scale: float | None = None) -> tuple[float, bool]:
    """Parameters after AdamW's first step against a reference: entries
    whose gradient ``grads`` is within ``TRAIN_TOL`` of zero (relative to
    the leaf's largest, or to ``scale`` where the leaf's exact gradient is
    zero) to lr, the rest as ``grad_close`` at ``TRAIN_TOL``. For
    pod-stacked leaves the gradient is per pod."""
    import torch
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    g = grads.detach().float().cpu().abs()
    tiny = g <= TRAIN_TOL * (g.max() if scale is None else scale)
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()
              and (err[tiny] <= lr * (1 + 1e-6)).all()
              and (err[~tiny] <= TRAIN_TOL * (want.abs()[~tiny]
                                              + want.abs().max())).all())
    return float(err.max()), ok


def zero_grad_scales(cfg, tree) -> list:
    """Per leaf of ``tree`` (gradients, parameters or moments in the
    params' layout): None, or, for a key bias of a model with qkv biases
    and no rope (whisper's), the largest |value| of the same projection's
    weight leaf. Such a bias adds q.b to every score of a query's row,
    which the softmax ignores: its exact gradient is zero and both devices
    give rounding noise, held at the scale of the terms that cancel."""
    from repro_torch.utils import tree_leaves_with_path
    pairs = tree_leaves_with_path(tree)
    if not cfg.qkv_bias or cfg.use_rope:
        return [None] * len(pairs)
    leaf = dict(pairs)
    return [float(leaf[path[:-1] + ("w",)].abs().max())
            if path[-2:] == ("wk", "b") else None for path, _ in pairs]


def library_bwd_fn(fn, inputs, g):
    """The backward alone of one PyTorch call ``fn(*inputs)`` as a call:
    its autograd graph built once, then ``torch.autograd.grad`` with the
    graph retained."""
    import torch
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def library_bwd_ms(fn, inputs, g, reps: int) -> float:
    """Milliseconds of :func:`library_bwd_fn`'s call, ``reps`` times."""
    return cuda_ms(library_bwd_fn(fn, inputs, g), reps=reps)


def backward_kernels(dev, flash_line: dict) -> dict:
    """Phase 21: each backward function at the train shape on the card
    (ms, and the bound of the same work), the library call's backward at
    the same shape where one PyTorch call computes the function
    (``scaled_dot_product_attention``, ``rms_norm``), and card against CPU
    on the same inputs (flash in bf16: the forward and backward kernels
    against the plain forward and backward in float32 on the CPU, the
    gradients under ``FLASH_BWD_TOL`` with A widened by o's rounding, lse
    under ``FLASH_LSE_ATOL``; the norm and the scan in float32 at
    ``GRAD_TOL_F32``). Flash's times are phase 21b's at the qwen3 layer
    (``flash_line``). Returns per kernel: route, ms, bound, library ms, max
    error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, rmsnorm, ssd_scan
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # flash: the kernel at the qwen3 train layer (phase 21b's line), and
    # card against CPU on a (1, 1024) slice: the forward and backward
    # kernels against the plain forward and backward on the CPU, each side
    # from its own forward's o and lse (A widened by o's rounding, o_err)
    b, s, hq, hkv, hd = TRAIN_SYNC_BATCH, TRAIN_SEQ, 16, 8, 128
    q, k, v, g = (randn(1, 1024, h, hd, dtype=torch.bfloat16)
                  for h in (hq, hkv, hkv, hq))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    got = fa.flash_attention_backward(q, k, v, o, lse, g)
    ins = [x.cpu().float() for x in (q, k, v)]
    o_cpu, lse_cpu = fa.flash_attention(*ins, return_lse=True)
    want, mags = ref.flash_attention_bwd_ref(
        *ins, o_cpu, lse_cpu, g.cpu().float(), magnitudes=True, o_err=True)
    measures, ok = bwd_error([x.cpu() for x in got], want, mags, "bfloat16")
    lse_measures, lse_ok = lse_error(lse.cpu(), lse_cpu)
    out["flash_attention"] = dict(
        route="cuda (csrc/flash_attention_bwd.cu)",
        shape=[b, s, hq, hkv, hd], dtype="bfloat16",
        **{key: flash_line[key] for key in (
            "ms", "plain_ms", "recompute_ms", "bound_ms", "bound_by",
            "library_ms", "library", "bitwise_repeatable")},
        max_abs_err=measures["max_abs_err"], errors=measures["errors"],
        **lse_measures, check_shape=[1, 1024, hq, hkv, hd],
        tolerance=FLASH_BWD_TOL["bfloat16"], within=ok and lse_ok)
    del q, k, v, g, o, lse, got, want, mags, ins, o_cpu, lse_cpu

    # rmsnorm: the train path's rows (B x S of d_model), bf16
    x = randn(b * s, 1024, dtype=torch.bfloat16)
    gy = randn(b * s, 1024, dtype=torch.bfloat16)
    scale = 1 + 0.1 * randn(1024)
    ms = cuda_ms(lambda: rmsnorm.rmsnorm_bwd(x, scale, gy), reps=20)
    lib_ms = library_bwd_ms(
        lambda x_, w_: torch.nn.functional.rms_norm(x_, (1024,), w_, 1e-6),
        [x, scale.to(x.dtype)], gy, reps=20)
    bound, by = bound_ms(10 * x.numel(), 3 * x.numel() * 2 + 2 * 4096)
    xf, gf = x[:4096].float(), gy[:4096].float()
    got = rmsnorm.rmsnorm_bwd(xf, scale, gf)
    want = rmsnorm.rmsnorm_bwd(xf.cpu(), scale.cpu(), gf.cpu())
    pairs_ok = [grad_close(a, w, GRAD_TOL_F32) for a, w in zip(got, want)]
    out["rmsnorm"] = dict(
        route="plain PyTorch (closed form; XLA autodiff's counterpart)",
        shape=list(x.shape), dtype="bfloat16", ms=ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms,
        library="rms_norm(x, (d,), scale, 1e-6), its autograd backward",
        max_abs_err=max(e for e, _ in pairs_ok),
        check_shape=[4096, 1024], tolerance=GRAD_TOL_F32,
        within=all(p for _, p in pairs_ok))
    del x, gy, xf, gf, got, want

    # the scan: mamba2-1.3b's train shape (8 chunks of 256)
    nc, sb, h, n, p = SSM_TRAIN_SEQ // 256, SSM_TRAIN_BATCH, 64, 128, 64
    states = randn(nc, sb, h, n, p)
    decay = torch.rand(nc, sb, h, generator=gen, device=dev) * 0.7 + 0.3
    ent, _ = ssd_scan.ssd_state_scan(states, decay)
    g_ent, g_fin = randn(nc, sb, h, n, p), randn(sb, h, n, p)
    ms = cuda_ms(lambda: ssd_scan.ssd_state_scan_bwd(decay, ent, g_ent,
                                                     g_fin), reps=20)
    bound, by = bound_ms(4 * states.numel(),
                         4 * (3 * states.numel() + 2 * sb * h * n * p))
    got = ssd_scan.ssd_state_scan_bwd(decay, ent, g_ent, g_fin)
    want = ssd_scan.ssd_state_scan_bwd(decay.cpu(), ent.cpu(), g_ent.cpu(),
                                       g_fin.cpu())
    pairs_ok = [grad_close(a, w, GRAD_TOL_F32) for a, w in zip(got, want)]
    out["ssd_state_scan"] = dict(
        route="plain PyTorch (reverse recurrence; XLA autodiff's "
        "counterpart)", shape=[nc, sb, h, n, p], dtype="float32", ms=ms,
        bound_ms=bound, bound_by=by, library_ms=None,
        max_abs_err=max(e for e, _ in pairs_ok),
        tolerance=GRAD_TOL_F32, within=all(p_ for _, p_ in pairs_ok))
    for name, line in out.items():
        emit("backward", kernel=name, **line)
        if not line["within"]:
            raise AssertionError(f"{name} backward: card and CPU disagree")
    return out


def train_card_vs_cpu(dev, configs=None,
                      phase: str = "train_card_vs_cpu") -> None:
    """Phase 21 (and 27d): reduced models in float32 from the same params
    (by default qwen3-0.6b and mamba2-1.3b), card (kernels) against CPU
    (plain versions): the loss and gradients, one ``sync`` step, one
    ``hierarchical`` step, and its cloud sync under TopK and under Int8 on
    identical inputs. ``configs``: (config, whether MoE pairs must drop)
    pairs. The batch has ``batch_specs``' keys (frames and prefix as
    float32 normals); where pairs must drop, the card's run records each
    MoE layer's kept pairs (``moe.dispatch``) and asserts some dropped."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import Int8Compressor, TopKCompressor
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ShapeSpec, build_model, moe
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    lr = 1e-2
    shape = ShapeSpec("train_check", 64, 4, "train")   # 2 chunks of 32
    if configs is None:
        configs = [(get_config(arch).reduced(dtype="float32"), False)
                   for arch in (TRAIN_ARCH, SSM_TRAIN_ARCH)]
    for cfg, drop in configs:
        model = build_model(no_remat(cfg))
        cpu_params = model.init(torch.Generator().manual_seed(3))
        draw = np.random.default_rng(4)
        cpu_batch = {key: torch.tensor(
            draw.integers(0, cfg.vocab_size, spec) if key == "tokens"
            else draw.normal(size=spec).astype(np.float32))
            for key, (spec, _) in model.batch_specs(shape).items()}
        dispatch, kept = moe.dispatch, []

        def recording(ids, cap):
            slot, k = dispatch(ids, cap)
            kept.append(k)
            return slot, k

        res, errs, ok = {}, {}, True
        for where in ("card", "cpu"):
            on = dev if where == "card" else torch.device("cpu")
            params = tree_map(lambda p: p.to(on), cpu_params)
            batch = {key: v.to(on) for key, v in cpu_batch.items()}

            def grads_of(rows):
                leaves = [p.detach().requires_grad_()
                          for p in tree_leaves(params)]
                loss = model.loss(tree_unflatten(params, leaves),
                                  {key: v[rows] for key, v in batch.items()})
                return loss, torch.autograd.grad(loss, leaves)

            moe.dispatch = recording if where == "card" else dispatch
            try:
                loss, grads = grads_of(slice(None))
            finally:
                moe.dispatch = dispatch
            pod_grads = [torch.stack(gs) for gs in zip(
                *(grads_of(slice(2 * p, 2 * p + 2))[1] for p in range(2)))]
            bundle = make_train_step(model, shape, mode="sync", lr=lr,
                                     device=on)
            p1, o1, s1 = bundle.init_state(tree_map(torch.clone, params))
            p1, o1, _, l1 = bundle.step_fn(p1, o1, s1, batch)
            hb = make_train_step(model, shape, mode="hierarchical", lr=lr,
                                 n_pods=2, device=on)
            p2, o2, s2 = hb.init_state(params)
            p2, o2, _, l2 = hb.step_fn(p2, o2, s2, batch)
            res[where] = dict(loss=float(loss.detach()),
                              grads=tree_unflatten(params, list(grads)),
                              pod_grads=tree_unflatten(params, pod_grads),
                              p1=p1, o1=o1, l1=float(l1), p2=p2, o2=o2,
                              l2=float(l2))
        card, cpu = res["card"], res["cpu"]
        dropped = [int((~k).sum()) for k in kept]
        errs["loss"] = max(abs(card[k] - cpu[k]) for k in ("loss", "l1",
                                                            "l2"))
        ok = all(math.isclose(card[k], cpu[k], rel_tol=TRAIN_TOL)
                 for k in ("loss", "l1", "l2"))
        checks = (("grads", card["grads"], cpu["grads"], None),
                  ("sync_params", card["p1"], cpu["p1"], cpu["grads"]),
                  ("sync_moments", card["o1"], cpu["o1"], None),
                  ("hier_params", card["p2"], cpu["p2"], cpu["pod_grads"]),
                  ("hier_moments", card["o2"], cpu["o2"], None))
        for name, gots, wants, step_grads in checks:
            if step_grads is None:
                pairs = [grad_close(a, w, TRAIN_TOL, z) for a, w, z in zip(
                    tree_leaves(gots), tree_leaves(wants),
                    zero_grad_scales(cfg, wants))]
            else:
                pairs = [step_close(a, w, g, lr, z) for a, w, g, z in zip(
                    tree_leaves(gots), tree_leaves(wants),
                    tree_leaves(step_grads),
                    zero_grad_scales(cfg, step_grads))]
            errs[name] = max(e for e, _ in pairs)
            ok = ok and all(p for _, p in pairs)
        # the cloud sync on identical inputs: the card's state after the
        # hierarchical step, synced on the card and on the CPU
        for cname, comp in (("topk", TopKCompressor(TRAIN_TOPK)),
                            ("int8", Int8Compressor())):
            sync_fn = make_train_step(model, shape, mode="hierarchical",
                                      n_pods=2, compressor=comp,
                                      device=dev).cloud_sync_fn
            a = sync_fn(tree_map(torch.clone, card["p2"]),
                        tree_map(torch.clone, card["o2"]))
            w = sync_fn(tree_map(lambda t: t.cpu(), card["p2"]),
                        tree_map(lambda t: t.cpu(), card["o2"]))
            pairs = [grad_close(x, y, SYNC_TOL) for x, y in
                     zip(tree_leaves(a), tree_leaves(w))]
            errs[f"cloud_sync_{cname}"] = max(e for e, _ in pairs)
            ok = ok and all(p for _, p in pairs)
        emit(phase, arch=cfg.name + " (reduced)", dtype="float32", lr=lr,
             head_dim=cfg.resolved_head_dim,
             inputs=sorted(cpu_batch), tolerance=dict(
                 train=TRAIN_TOL, cloud_sync=SYNC_TOL,
                 tiny_gradient_entries="lr",
                 exact_zero_key_bias="rtol x |wk.w|"
                 if any(zero_grad_scales(cfg, cpu_params)) else None),
             capacity_factor=cfg.moe.capacity_factor if cfg.moe else None,
             dropped_pairs_card=dropped if cfg.moe else None,
             max_abs_err=errs, loss_card=card["loss"], loss_cpu=cpu["loss"],
             within=ok)
        if not ok:
            raise AssertionError(f"{phase}: {cfg.name} card and CPU "
                                 "disagree")
        if drop and not (dropped and all(n > 0 for n in dropped)):
            raise AssertionError(f"{phase}: {cfg.name} dropped no pair in "
                                 f"some MoE layer: {dropped}")


# ---------------------------------------------------------------------------
# 25. MoE + MLA serving: deepseek-v2-lite-16b on the card
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek-v2-lite-16b"
MOE_SERVE_REQUESTS, MOE_SERVE_PROMPT, MOE_SERVE_NEW = 8, 64, 32
# phase 25e: full width at depth 4 (the dense layer and 3 MoE layers) in
# float32, a capacity factor of 64 (no pair drops, as tests/test_models.py
# sets it), decode against prefill at tests/test_models.py's 2e-3
MOE_F32_LAYERS, MOE_F32_REQUESTS, MOE_F32_PROMPT = 4, 4, 48
MOE_GAP_F32 = 2e-3
MOE_PEAK_LIMIT = 75e9     # bytes, the acceptance bound on the card's 80 GB


def spill_free(report: str | None) -> bool:
    return bool(report) and "0 bytes spill stores, 0 bytes spill loads" \
        in report


def mla_kernels(dev, fault_libs: dict, ptxas: dict) -> dict:
    """Phase 25a: the flash kernel at head dim 192 (MLA's prefill, q and k
    of 128 + 64 columns, v padded to 192) against its plain version: at
    deepseek-v2-lite's layer (B=4, S=4096, 16 heads, bf16, causal) under
    ``FLASH_TOL`` with the five planted faults rejected there too, and in
    float32 at ragged shapes. The layer's line: warm and L2-cold times, the
    bound (v at 192 columns, and at its useful 128), its share, TFLOP/s,
    SDPA's time at the same shape, registers and spills of both
    instantiations (asserted spill-free). Returns the layer's fields."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(25)
    bf16, f32 = torch.bfloat16, torch.float32
    flush = l2_flush(dev)
    reports = {t: ptxas.get(f"{t},HD=192") for t in ("bf16", "f32")}
    main = None
    for case, b, sq, skv, hq, hkv, dtype, causal in (
            ("layer", PREFILL_BATCH, PREFILL_SEQ, PREFILL_SEQ, 16, 16, bf16,
             True),
            ("ragged", 2, 333, 333, 4, 2, f32, True),
            ("top_left", 1, 70, 130, 4, 4, f32, True),
            ("full", 1, 200, 170, 4, 4, f32, False),
            ("ragged", 2, 333, 333, 4, 2, bf16, True)):
        layer = case == "layer"
        fields = flash_case(gen, f"hd192_{case}", (b, sq, skv, hq, hkv, 192),
                            dtype, causal,
                            fault_libs=fault_libs if layer else None,
                            flush=flush if layer else None,
                            report=reports["bf16"])
        if layer:
            # the useful work: P V over v's 128 columns, not the padding
            ops_v128 = fields["operations"] * (192 + 128) // (2 * 192)
            b128_ms, _ = bound_ms(ops_v128, fields["bytes"], PEAK_BF16_FLOPS)
            fields.update(bound_ms_v128=b128_ms,
                          bound_share_v128=b128_ms / fields["ms"],
                          ptxas_f32=reports["f32"])
            main = fields
        emit("kernel", **fields)
    if not all(spill_free(r) for r in reports.values()):
        raise AssertionError(f"flash at hd 192 spills: {reports}")
    return main


def moe_rmsnorm(dev, ptxas: dict) -> dict:
    """Phase 25a: the rmsnorm kernel at deepseek-v2-lite's d_model 2048 in
    bf16 (the instantiation of 8 held vectors that its path runs), bit for
    bit against its plain version at the prefill's rows and the decode
    step's, each timed. Returns {case: fields} for the kernels line."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(26)
    flush = l2_flush(dev)
    out = {}
    for case, rows in (("moe_prefill", PREFILL_BATCH * PREFILL_SEQ),
                       ("moe_decode", MOE_SERVE_REQUESTS)):
        fields, _, _ = rmsnorm_case(gen, case, rows, 2048, torch.bfloat16,
                                    flush, ptxas, timed=True)
        emit("kernel", **fields)
        out[case] = fields
    return out


class RoutingRecorder:
    """Wraps ``moe.route`` while in use: for every MoE layer call it records
    the top-k expert ids of each token that the router gave ``moe_apply``,
    in call order."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self.real = moe.route

        def recording(params, cfg, tokens):
            probs, gate, ids = self.real(params, cfg, tokens)
            self.calls.append(ids)
            return probs, gate, ids

        moe.route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.real


def routing_gap(cfg, prefill_calls, decode_calls, b: int, p: int) -> dict:
    """How the top-k routing of the prefill (one call per MoE layer over
    ``b`` x ``p``(+1) tokens) and of the prompt's decode steps (one call per
    layer and step over ``b`` tokens) differ: (layer, request, position)
    triples whose expert sets differ, positions with any such layer, and
    the pairs each path drops at its capacity (``moe.dispatch``)."""
    import torch
    from repro_torch.models import moe
    n_moe = len(prefill_calls)
    pre = torch.stack([c.reshape(b, -1, c.shape[-1])[:, :p]
                       for c in prefill_calls])            # (L, B, P, k)
    dec = torch.stack([torch.stack(decode_calls[t * n_moe:(t + 1) * n_moe])
                       for t in range(p)], 2)              # (L, B, P, k)
    differ = (pre.sort(-1)[0] != dec.sort(-1)[0]).any(-1)  # (L, B, P)
    pre_tokens = prefill_calls[0].shape[0]
    dropped_pre = sum(int((~moe.dispatch(c, moe.capacity(cfg, pre_tokens))[1])
                          .sum()) for c in prefill_calls)
    dropped_dec = sum(int((~moe.dispatch(c, moe.capacity(cfg, b))[1]).sum())
                      for c in decode_calls[:n_moe * p])
    return dict(moe_layers=n_moe, positions=b * p,
                layer_positions_differing=int(differ.sum()),
                positions_differing=int(differ.any(0).sum()),
                pairs_dropped_prefill=dropped_pre,
                pairs_dropped_decode=dropped_dec,
                capacity_prefill=moe.capacity(cfg, pre_tokens),
                capacity_decode=moe.capacity(cfg, b))


def moe_prefill_path(dev):
    """Phase 25b: full-width deepseek-v2-lite-16b (27 layers: one dense, 26
    MoE; MLA in all), random weights from seed 0 built as the bf16 serving
    copy a layer at a time: init seconds and peak, then ``Model.logits`` on
    4 x 4096 tokens ``PREFILL_REPS`` times: s per forward, tokens/s, the
    launches (27 flash at head dim 192 and 55 rmsnorm per forward,
    asserted), peak memory (asserted under ``MOE_PEAK_LIMIT``), one MoE
    layer at the prefill shape under ``set_sync_debug_mode("error")`` (no
    host synchronisation, asserted), and a profiled forward. Returns
    (model, params, launch counts)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe
    from repro_torch.utils import tree_map

    cfg = get_config(MOE_ARCH)
    model = build_model(cfg)
    params, init_s, init_peak, n_params, param_bytes = init_timed(model, dev)
    per_fwd = (cfg.n_layers, 2 * cfg.n_layers + 1)    # flash, rmsnorm
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ + 1)), device=dev)
    batch = {"tokens": toks}
    with torch.inference_mode():
        times, counts, peak, logits = timed_forwards(model, params, batch)
        launched = (counts["flash_attention"], counts["rmsnorm"])
        ok = (tuple(logits.shape) == (PREFILL_BATCH, PREFILL_SEQ,
                                      cfg.vocab_size)
              and bool(torch.isfinite(logits).all()))
        expected = tuple(PREFILL_REPS * n for n in per_fwd)
        tokens = PREFILL_BATCH * PREFILL_SEQ
        emit("moe_prefill_path", arch=cfg.name, n_layers=cfg.n_layers,
             n_dense_layers=cfg.moe.n_dense_layers, n_params=n_params,
             param_bytes=param_bytes, init_s=init_s,
             init_peak_bytes=init_peak, batch=PREFILL_BATCH,
             seq=PREFILL_SEQ, dtype=cfg.dtype,
             capacity=moe.capacity(cfg, tokens), s_per_forward=times,
             mean_s=sum(times) / len(times), tokens_per_s=tokens / min(times),
             launches_flash=launched[0], launches_rmsnorm=launched[1],
             launches_expected=list(expected), max_memory_allocated=peak,
             peak_limit=MOE_PEAK_LIMIT,
             logits_std=float(logits[0, :64].float().std()), finite=ok)
        if launched != expected:
            raise AssertionError(f"{cfg.name} prefill launches {launched}, "
                                 f"expected {PREFILL_REPS} x {per_fwd}")
        if not ok:
            raise AssertionError(f"{cfg.name} prefill logits are not finite "
                                 "or of the wrong shape")
        if max(peak, init_peak) > MOE_PEAK_LIMIT:
            raise AssertionError(f"{cfg.name}: peak memory {peak} passes "
                                 f"{MOE_PEAK_LIMIT}")
        del logits
        layer = tree_map(lambda t: t[0], params["blocks"]["ffn"])
        x = torch.randn(PREFILL_BATCH, PREFILL_SEQ, cfg.d_model, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1)
                        ).to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe.moe_apply(layer, cfg, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        moe_ms = cuda_ms(lambda: moe.moe_apply(layer, cfg, x), reps=5)
        emit("moe_layer", arch=cfg.name, shape=list(x.shape),
             host_syncs=0, ms=moe_ms, aux=float(aux),
             finite=bool(torch.isfinite(y).all()))
        del x, y, layer
        profile_forward(model, params, batch, phase="moe_prefill_profile")
    return model, params, {"flash_attention": launched[0],
                           "rmsnorm": launched[1]}


def moe_serve_path(dev, model, params) -> dict:
    """Phase 25c: the server answers ``MOE_SERVE_REQUESTS`` requests of a
    ``MOE_SERVE_PROMPT``-token prompt and ``MOE_SERVE_NEW`` greedy tokens
    with deepseek-v2-lite's bf16 serving copy (``serve_shape``): ms per
    step, tokens/s, the MLA cache's bytes (asserted equal to
    ``cache_bytes``), launches per step (no flash, 55 rmsnorm; asserted);
    the bf16 gap between decode and prefill logits and how the two paths'
    top-k routing differs (reported, not asserted); a profiled step.
    Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.launch.serve import cache_bytes, serve, serve_shape
    from repro_torch.models import ShapeSpec
    from repro_torch.utils import tree_leaves

    cfg = model.cfg
    b, p, new = MOE_SERVE_REQUESTS, MOE_SERVE_PROMPT, MOE_SERVE_NEW
    prompts = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, p)), dtype=torch.int32, device=dev)
    shape = ShapeSpec("moe_serve_smoke", seq_len=p + new, global_batch=b,
                      kind="decode")
    flash_attention.LAUNCHES = rmsnorm.LAUNCHES = 0
    res = serve_shape(cfg, shape, new, device=dev, params=params,
                      prompts=prompts, keep_prompt_logits=True)
    steps = res.prompt_steps + res.decode_steps
    launched = (flash_attention.LAUNCHES, rmsnorm.LAUNCHES)
    per_step = 2 * cfg.n_layers + 1
    cache = model.decode_init(params, {"tokens": prompts}, p + new,
                              dtype=torch.bfloat16)
    built = sum(t.nbytes for t in tree_leaves(cache) if t.is_floating_point())
    need = cache_bytes(cfg, b, p + new, torch.bfloat16)
    del cache
    pad = torch.zeros(b, 1, dtype=torch.int32, device=dev)
    with torch.inference_mode(), RoutingRecorder() as pre_rec:
        prefill = model.logits(params, {"tokens": torch.cat([prompts, pad],
                                                            1)})
    with RoutingRecorder() as dec_rec:
        serve(model, params, prompts, 1)
    routing = routing_gap(cfg, pre_rec.calls, dec_rec.calls, b, p)
    pre, dec = prefill.float(), res.prompt_logits.float()
    gap = (dec - pre).abs()
    within = bool((gap <= SERVE_GAP_ATOL + SERVE_GAP_RTOL * pre.abs()).all())
    emit("moe_serve_path", arch=cfg.name, requests=b, prompt=p,
         new_tokens=new, cache_len=shape.seq_len, cache_bytes=built,
         cache_bytes_expected=need, prompt_steps=res.prompt_steps,
         prompt_ms_per_step=1e3 * res.prompt_s / res.prompt_steps,
         decode_steps=res.decode_steps,
         decode_ms_per_step=res.ms_per_decode_step,
         decode_tokens_per_s=b / (res.ms_per_decode_step / 1e3),
         tokens_per_s=res.tokens_per_s, launches_flash=launched[0],
         rmsnorm_per_step=launched[1] / steps,
         max_gap=float(gap.max()), mean_gap=float(gap.mean()),
         max_abs_prefill_logit=float(pre.abs().max()),
         gap_bound_reported=[SERVE_GAP_ATOL, SERVE_GAP_RTOL],
         gap_within_reported=within, routing=routing,
         first_token_equal=int((res.tokens[:, 0] == pre[:, -1].argmax(-1))
                               .sum()),
         tokens=res.tokens[:2, :8].tolist())
    if launched != (0, per_step * steps):
        raise AssertionError(f"{cfg.name} serve launches {launched}, "
                             f"expected (0, {per_step} x {steps})")
    if built != need:
        raise AssertionError(f"{cfg.name} cache of {built} B, cache_bytes "
                             f"says {need}")
    if not (torch.isfinite(dec).all()
            and tuple(res.tokens.shape) == (b, new)):
        raise AssertionError(f"{cfg.name} decode logits are not finite")
    profile_decode(model, params, prompts, p + new,
                   phase="moe_serve_profile")
    return {"flash_attention": launched[0], "rmsnorm": launched[1]}


def moe_decode_vs_prefill_f32(dev) -> None:
    """Phase 25e: full-width deepseek-v2-lite cut to ``MOE_F32_LAYERS``
    layers, float32, a capacity factor of 64: decode logits over the
    prompt against ``Model.logits``, asserted within ``MOE_GAP_F32``, with
    the routing differences between the two (reported)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(
        full, n_layers=MOE_F32_LAYERS, dtype="float32",
        moe=dataclasses.replace(full.moe, capacity_factor=64.0))
    model = build_model(cfg)
    params = model.init_serving(torch.Generator(device=dev).manual_seed(0))
    b, p = MOE_F32_REQUESTS, MOE_F32_PROMPT
    prompts = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (b, p)), dtype=torch.int32, device=dev)
    pad = torch.zeros(b, 1, dtype=torch.int32, device=dev)
    with torch.inference_mode(), RoutingRecorder() as pre_rec:
        prefill = model.logits(params, {"tokens": torch.cat([prompts, pad],
                                                            1)})
    with RoutingRecorder() as dec_rec:
        res = serve(model, params, prompts, 1, keep_prompt_logits=True)
    routing = routing_gap(cfg, pre_rec.calls, dec_rec.calls, b, p)
    gap = (res.prompt_logits - prefill).abs()
    within = bool((gap <= MOE_GAP_F32 + MOE_GAP_F32 * prefill.abs()).all())
    emit("moe_decode_vs_prefill", arch=cfg.name, n_layers=cfg.n_layers,
         dtype=cfg.dtype, capacity_factor=64.0, requests=b, prompt=p,
         bound=[MOE_GAP_F32, MOE_GAP_F32], within=within,
         max_gap=float(gap.max()), mean_gap=float(gap.mean()),
         max_abs_prefill_logit=float(prefill.abs().max()), routing=routing,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if not (within and torch.isfinite(res.prompt_logits).all()):
        raise AssertionError(f"{cfg.name} float32 decode leaves "
                             f"{MOE_GAP_F32} of the prefill")


ENCDEC_ARCH, VLM_ARCH = "whisper-large-v3", "internvl2-1b"
# whisper: 4 requests of 1500 frames (30 s of audio) and 448 tokens, its
# published decoder context; 8 served requests from the start of
# transcript (<|startoftranscript|> <|en|> <|transcribe|>
# <|notimestamps|> in large-v3's vocabulary) and 32 greedy tokens
ENCDEC_BATCH, ENCDEC_DEC_SEQ = 4, 448
WHISPER_PROMPT = (50258, 50259, 50360, 50364)
ENCDEC_SERVE_REQUESTS, ENCDEC_SERVE_NEW = 8, 32
# internvl2: 256 vision tokens before the text, 4 x 4096 positions in all;
# 8 served requests of 256 + 32 tokens (as qwen3's phase 10); decode_32k's
# 128 requests over a 32,768-position cache, 8 new tokens each
VLM_PREFIX, VLM_PREFILL_TEXT = 256, PREFILL_SEQ - 256
VLM_DECODE_32K_NEW = 8
VLM_PEAK_LIMIT = 75e9     # bytes, the acceptance bound on the card's 80 GB


def encdec_kernels(dev, fault_libs: dict, ptxas: dict) -> dict:
    """Phase 26a: the flash kernel at this slice's shapes against its
    plain version under ``FLASH_TOL``: whisper's encoder (4 x 1500 frames,
    20 heads of 64, non-causal) and cross attention (448 queries over 1500
    frames, non-causal, Sq != Skv), internvl2's layer (4 x 4096, 14/2
    heads of 64, causal) and kimi-k2's (4 x 4096, 64/8 heads of 112,
    causal), each timed beside SDPA with its bound; at hd 112 the three
    planted faults rejected, ragged float32 and bf16 cases, and no spills
    in either instantiation (asserted). Then rmsnorm at internvl2's
    d_model 896 in bf16 (vec 8, 3.5 vectors a lane: lanes hold unequal
    counts), bit for bit, at the prefill's rows and the decode step's.
    Returns {"flash": {case: fields}, "rmsnorm": {case: fields}}."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(27)
    bf16, f32 = torch.bfloat16, torch.float32
    flush = l2_flush(dev)
    fla = ptxas["flash_attention"]
    reports = {t: fla.get(f"{t},HD=112") for t in ("bf16", "f32")}
    flash = {}
    for case, shape, dtype, causal, timed in (
            ("whisper_encoder", (ENCDEC_BATCH, 1500, 1500, 20, 20, 64), bf16,
             False, True),
            ("whisper_cross", (ENCDEC_BATCH, ENCDEC_DEC_SEQ, 1500, 20, 20,
                               64), bf16, False, True),
            ("internvl2_layer", (PREFILL_BATCH, PREFILL_SEQ, PREFILL_SEQ, 14,
                                 2, 64), bf16, True, True),
            ("kimi_layer", (PREFILL_BATCH, PREFILL_SEQ, PREFILL_SEQ, 64, 8,
                            112), bf16, True, True),
            ("hd112_top_left", (1, 300, 700, 4, 2, 112), f32, True, False),
            ("hd112_full", (2, 333, 200, 4, 4, 112), f32, False, False),
            ("hd112_ragged", (2, 333, 333, 8, 1, 112), bf16, True, False),
            ("cross_f32", (2, 97, 300, 4, 4, 64), f32, False, False)):
        flash[case] = flash_case(
            gen, case, shape, dtype, causal,
            fault_libs=fault_libs if case == "kimi_layer" else None,
            flush=flush if timed else None,
            report=fla.get(f"bf16,HD={shape[-1]}"))
        if case == "kimi_layer":
            flash[case]["ptxas_f32"] = reports["f32"]
        emit("kernel", **flash[case])
    if not all(spill_free(r) for r in reports.values()):
        raise AssertionError(f"flash at hd 112 spills: {reports}")
    rms = {}
    for case, rows in (("vlm_prefill", PREFILL_BATCH * PREFILL_SEQ),
                       ("vlm_decode", SERVE_REQUESTS)):
        fields, _, _ = rmsnorm_case(gen, case, rows, 896, bf16, flush,
                                    ptxas["rmsnorm"], timed=True)
        emit("kernel", **fields)
        rms[case] = fields
    return {"flash": flash, "rmsnorm": rms}


def encdec_prefill_path(dev):
    """Phase 26b: full-size whisper-large-v3 (32 + 32 layers, d 1280, 20
    heads of 64, vocab 51,866), random weights from seed 0 built as the
    bf16 serving copy a layer at a time (init seconds and peak), then
    ``Model.logits`` on 4 requests of 1500 random bf16 frames and 448
    tokens ``PREFILL_REPS`` times: s a forward, decoder tokens/s and
    encoder frames/s, launches (96 flash: 32 encoder, 32 self, 32 cross;
    no rmsnorm: LayerNorm, asserted), peak memory, a profiled forward.
    Returns (model, params, launch counts)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(ENCDEC_ARCH)
    model = build_model(cfg)
    params, init_s, init_peak, n_params, param_bytes = init_timed(model, dev)
    b, s = ENCDEC_BATCH, ENCDEC_DEC_SEQ
    frames = torch.randn(b, cfg.encoder_seq_len, cfg.d_model, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1)
                         ).to(torch.bfloat16)
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1)), device=dev)
    batch = {"frames": frames, "tokens": toks}
    per_fwd = (cfg.n_encoder_layers + 2 * cfg.n_layers, 0)
    with torch.inference_mode():
        times, counts, peak, logits = timed_forwards(model, params, batch)
        launched = (counts["flash_attention"], counts["rmsnorm"])
        expected = tuple(PREFILL_REPS * n for n in per_fwd)
        ok = (tuple(logits.shape) == (b, s, cfg.vocab_size)
              and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()))
        emit("encdec_prefill_path", arch=cfg.name,
             n_layers=[cfg.n_encoder_layers, cfg.n_layers],
             n_params=n_params, param_bytes=param_bytes, init_s=init_s,
             init_peak_bytes=init_peak, batch=b, frames=cfg.encoder_seq_len,
             seq=s, dtype="bfloat16", s_per_forward=times,
             mean_s=sum(times) / len(times),
             tokens_per_s=b * s / min(times),
             frames_per_s=b * cfg.encoder_seq_len / min(times),
             launches_flash=launched[0], launches_rmsnorm=launched[1],
             launches_expected=list(expected), max_memory_allocated=peak,
             logits_std=float(logits[0, :64].float().std()), finite=ok)
        if launched != expected:
            raise AssertionError(f"{cfg.name} prefill launches {launched}, "
                                 f"expected {PREFILL_REPS} x {per_fwd}")
        if not ok:
            raise AssertionError(f"{cfg.name} prefill logits are not finite "
                                 "or of the wrong shape or dtype")
        del logits
        profile_forward(model, params, batch,
                        phase="encdec_prefill_profile")
    return model, params, {"flash_attention": launched[0],
                           "rmsnorm": launched[1]}


def encdec_serve_path(dev, model, params) -> dict:
    """Phase 26c: the server answers ``ENCDEC_SERVE_REQUESTS`` requests of
    1500 random bf16 frames from whisper's start of transcript (4 tokens)
    with ``ENCDEC_SERVE_NEW`` greedy tokens (``serve_shape``): the cache's
    set-up (the encoder once: 32 flash launches, asserted; its bytes
    asserted equal to ``cache_bytes``), ms a step, launches a step (none,
    asserted), the bf16 gap between the decode and prefill logits of the
    prompt (reported), a profiled step. Returns the launch counts."""
    import torch
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.launch.serve import cache_bytes, serve_shape
    from repro_torch.models import ShapeSpec
    from repro_torch.utils import tree_leaves

    cfg = model.cfg
    b, new = ENCDEC_SERVE_REQUESTS, ENCDEC_SERVE_NEW
    p = len(WHISPER_PROMPT)
    prompts = torch.tensor([WHISPER_PROMPT] * b, dtype=torch.int32,
                           device=dev)
    frames = torch.randn(b, cfg.encoder_seq_len, cfg.d_model, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3)
                         ).to(torch.bfloat16)
    flash_attention.LAUNCHES = rmsnorm.LAUNCHES = 0
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = model.decode_init(params, {"tokens": prompts,
                                           "frames": frames}, p + new,
                                  dtype=torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    at_init = (flash_attention.LAUNCHES, rmsnorm.LAUNCHES)
    built = sum(t.nbytes for t in tree_leaves(cache) if t.is_floating_point())
    need = cache_bytes(cfg, b, p + new, torch.bfloat16)
    del cache
    shape = ShapeSpec("encdec_serve_smoke", seq_len=p + new, global_batch=b,
                      kind="decode")
    flash_attention.LAUNCHES = rmsnorm.LAUNCHES = 0
    res = serve_shape(cfg, shape, new, device=dev, params=params,
                      prompts=prompts, frames=frames, keep_prompt_logits=True)
    launched = (flash_attention.LAUNCHES, rmsnorm.LAUNCHES)
    pad = torch.zeros(b, 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        prefill = model.logits(params, {"frames": frames,
                                        "tokens": torch.cat([prompts, pad],
                                                            1)})
    pre, dec = prefill.float(), res.prompt_logits.float()
    gap = (dec - pre).abs()
    within = bool((gap <= SERVE_GAP_ATOL + SERVE_GAP_RTOL * pre.abs()).all())
    emit("encdec_serve_path", arch=cfg.name, requests=b, prompt=p,
         frames=cfg.encoder_seq_len, new_tokens=new, cache_len=p + new,
         cache_bytes=built, cache_bytes_expected=need,
         decode_init_s=init_s, launches_decode_init=list(at_init),
         prompt_steps=res.prompt_steps,
         prompt_ms_per_step=1e3 * res.prompt_s / res.prompt_steps,
         decode_steps=res.decode_steps,
         decode_ms_per_step=res.ms_per_decode_step,
         decode_tokens_per_s=b / (res.ms_per_decode_step / 1e3),
         tokens_per_s=res.tokens_per_s,
         launches_serve=list(launched),
         launches_per_step=[(launched[i] - at_init[i])
                            / (res.prompt_steps + res.decode_steps)
                            for i in range(2)],
         max_gap=float(gap.max()), mean_gap=float(gap.mean()),
         max_abs_prefill_logit=float(pre.abs().max()),
         gap_bound_reported=[SERVE_GAP_ATOL, SERVE_GAP_RTOL],
         gap_within_reported=within,
         first_token_equal=int((res.tokens[:, 0] == pre[:, -1].argmax(-1))
                               .sum()),
         tokens=res.tokens[:2, :8].tolist())
    if at_init != (cfg.n_encoder_layers, 0) or launched != at_init:
        raise AssertionError(f"{cfg.name} serve launches: decode_init "
                             f"{at_init}, serve {launched}; expected "
                             f"({cfg.n_encoder_layers}, 0) in each")
    if built != need:
        raise AssertionError(f"{cfg.name} cache of {built} B, cache_bytes "
                             f"says {need}")
    if not (torch.isfinite(dec).all()
            and tuple(res.tokens.shape) == (b, new)):
        raise AssertionError(f"{cfg.name} decode logits are not finite")
    profile_decode(model, params, prompts, p + new,
                   phase="encdec_serve_profile", frames=frames)
    return {"flash_attention": launched[0], "rmsnorm": launched[1]}


def vlm_prefill_path(dev):
    """Phase 26d: full-size internvl2-1b (24 layers, d 896, 14/2 heads of
    64, QKV bias, vocab 151,655), random weights from seed 0 as the bf16
    serving copy, ``Model.logits`` on 4 x (256 random bf16 prefix
    embeddings + 3840 tokens) ``PREFILL_REPS`` times: s a forward,
    positions/s, launches (24 flash and 49 rmsnorm a forward, asserted),
    peak memory, a profiled forward. Returns (model, params, launch
    counts)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(VLM_ARCH)
    model = build_model(cfg)
    params, init_s, init_peak, n_params, param_bytes = init_timed(model, dev)
    b = PREFILL_BATCH
    prefix = torch.randn(b, VLM_PREFIX, cfg.d_model, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2)
                         ).to(torch.bfloat16)
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, VLM_PREFILL_TEXT + 1)), device=dev)
    batch = {"tokens": toks, "prefix_embeds": prefix}
    per_fwd = (cfg.n_layers, 2 * cfg.n_layers + 1)
    with torch.inference_mode():
        times, counts, peak, logits = timed_forwards(model, params, batch)
        launched = (counts["flash_attention"], counts["rmsnorm"])
        expected = tuple(PREFILL_REPS * n for n in per_fwd)
        ok = (tuple(logits.shape) == (b, VLM_PREFIX + VLM_PREFILL_TEXT,
                                      cfg.vocab_size)
              and bool(torch.isfinite(logits).all()))
        emit("vlm_prefill_path", arch=cfg.name, n_layers=cfg.n_layers,
             n_params=n_params, param_bytes=param_bytes, init_s=init_s,
             init_peak_bytes=init_peak, batch=b, prefix=VLM_PREFIX,
             seq=VLM_PREFILL_TEXT, dtype=cfg.dtype, s_per_forward=times,
             mean_s=sum(times) / len(times),
             positions_per_s=b * PREFILL_SEQ / min(times),
             launches_flash=launched[0], launches_rmsnorm=launched[1],
             launches_expected=list(expected), max_memory_allocated=peak,
             logits_std=float(logits[0, :64].float().std()), finite=ok)
        if launched != expected:
            raise AssertionError(f"{cfg.name} prefill launches {launched}, "
                                 f"expected {PREFILL_REPS} x {per_fwd}")
        if not ok:
            raise AssertionError(f"{cfg.name} prefill logits are not finite "
                                 "or of the wrong shape")
        del logits
        profile_forward(model, params, batch, phase="vlm_prefill_profile")
    return model, params, {"flash_attention": launched[0],
                           "rmsnorm": launched[1]}


def vlm_serve_path(dev, model, params) -> dict:
    """Phase 26d: internvl2-1b serves 8 requests of 256 + 32 tokens (its
    decode takes no vision prefix, as in the JAX package): ms a step,
    launches (no flash, 49 rmsnorm a step, asserted), the bf16 gap to the
    prefill logits without a prefix (reported), a profiled step; then
    ``serve_shape`` at decode_32k (128 requests, a 32,768-position cache,
    ``VLM_DECODE_32K_NEW`` tokens): ms a step, peak memory (asserted under
    ``VLM_PEAK_LIMIT``), launches (asserted), the cache's bytes
    (asserted equal to ``cache_bytes``) and a profiled step. Returns the
    launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.launch.serve import cache_bytes, serve_shape
    from repro_torch.models import SHAPES, ShapeSpec
    from repro_torch.utils import tree_leaves

    cfg = model.cfg
    b, p, new = SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW
    per_step = 2 * cfg.n_layers + 1
    prompts = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, p)), dtype=torch.int32, device=dev)
    shape = ShapeSpec("vlm_serve_smoke", seq_len=p + new, global_batch=b,
                      kind="decode")
    flash_attention.LAUNCHES = rmsnorm.LAUNCHES = 0
    res = serve_shape(cfg, shape, new, device=dev, params=params,
                      prompts=prompts, keep_prompt_logits=True)
    steps = res.prompt_steps + res.decode_steps
    launched = (flash_attention.LAUNCHES, rmsnorm.LAUNCHES)
    pad = torch.zeros(b, 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        prefill = model.logits(params, {"tokens": torch.cat([prompts, pad],
                                                            1)})
    pre, dec = prefill.float(), res.prompt_logits.float()
    del prefill
    gap = (dec - pre).abs()
    within = bool((gap <= SERVE_GAP_ATOL + SERVE_GAP_RTOL * pre.abs()).all())
    emit("vlm_serve_path", arch=cfg.name, requests=b, prompt=p,
         new_tokens=new, cache_len=p + new, prompt_steps=res.prompt_steps,
         prompt_ms_per_step=1e3 * res.prompt_s / res.prompt_steps,
         decode_steps=res.decode_steps,
         decode_ms_per_step=res.ms_per_decode_step,
         decode_tokens_per_s=b / (res.ms_per_decode_step / 1e3),
         tokens_per_s=res.tokens_per_s, launches_flash=launched[0],
         rmsnorm_per_step=launched[1] / steps,
         max_gap=float(gap.max()), mean_gap=float(gap.mean()),
         max_abs_prefill_logit=float(pre.abs().max()),
         gap_bound_reported=[SERVE_GAP_ATOL, SERVE_GAP_RTOL],
         gap_within_reported=within,
         first_token_equal=int((res.tokens[:, 0] == pre[:, -1].argmax(-1))
                               .sum()),
         tokens=res.tokens[:2, :8].tolist())
    if launched != (0, per_step * steps):
        raise AssertionError(f"{cfg.name} serve launches {launched}, "
                             f"expected (0, {per_step} x {steps})")
    if not (torch.isfinite(dec).all()
            and tuple(res.tokens.shape) == (b, new)):
        raise AssertionError(f"{cfg.name} decode logits are not finite")
    del pre, dec, gap, res
    profile_decode(model, params, prompts, p + new,
                   phase="vlm_serve_profile")

    # decode_32k: the zoo's first cache of that shape that one card holds
    big = SHAPES["decode_32k"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.LAUNCHES = rmsnorm.LAUNCHES = 0
    t0 = time.perf_counter()
    res = serve_shape(cfg, big, VLM_DECODE_32K_NEW, device=dev,
                      params=params)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps32 = res.prompt_steps + res.decode_steps
    step_ms = 1e3 * (res.prompt_s + res.decode_s) / steps32
    decode_ms = res.ms_per_decode_step
    launched32 = (flash_attention.LAUNCHES, rmsnorm.LAUNCHES)
    tokens_ok = (tuple(res.tokens.shape) == (big.global_batch,
                                             VLM_DECODE_32K_NEW)
                 and bool((res.tokens >= 0).all()))
    del res
    need = cache_bytes(cfg, big.global_batch, big.seq_len, torch.bfloat16)
    cache = model.decode_init(params, {"tokens": torch.zeros(
        big.global_batch, 1, dtype=torch.int32, device=dev)}, big.seq_len,
        dtype=torch.bfloat16)
    built = sum(t.nbytes for t in tree_leaves(cache) if t.is_floating_point())
    del cache
    torch.cuda.empty_cache()
    emit("vlm_decode_32k", arch=cfg.name, requests=big.global_batch,
         cache_len=big.seq_len, new_tokens=VLM_DECODE_32K_NEW,
         total_s=total_s, steps=steps32, ms_per_step=step_ms,
         decode_ms_per_step=decode_ms,
         decode_tokens_per_s=big.global_batch / (decode_ms / 1e3),
         cache_bytes=built, cache_bytes_expected=need,
         max_memory_allocated=peak, peak_limit=VLM_PEAK_LIMIT,
         launches_flash=launched32[0],
         rmsnorm_per_step=launched32[1] / steps32)
    if launched32 != (0, per_step * steps32) or not tokens_ok:
        raise AssertionError(f"{cfg.name} decode_32k launches {launched32}, "
                             f"expected (0, {per_step} x {steps32})")
    if built != need:
        raise AssertionError(f"{cfg.name} decode_32k cache of {built} B, "
                             f"cache_bytes says {need}")
    if peak > VLM_PEAK_LIMIT:
        raise AssertionError(f"{cfg.name} decode_32k peak memory {peak} "
                             f"passes {VLM_PEAK_LIMIT}")
    profile_decode(model, params, torch.zeros(big.global_batch, 4,
                                              dtype=torch.int32, device=dev),
                   big.seq_len, phase="vlm_decode_32k_profile")
    return {"flash_attention": launched[0] + launched32[0],
            "rmsnorm": launched[1] + launched32[1]}


# ---------------------------------------------------------------------------
# 27. Training the MoE/MLA, encoder-decoder and VLM families
# ---------------------------------------------------------------------------

# 27a: deepseek-v2-lite-16b at full width, depth cut to the dense layer
# and 3 MoE layers of 27 (the memory arithmetic is in PERF.md), train_4k's
# sequence at batch 4 (train_4k's 256, cut)
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 4, 4, 3
# 27b: whisper-large-v3 whole: 1500 frames, its 448-token decoder context
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_STEPS = 4, 3
# 27c: internvl2-1b whole: 256 image tokens before 4096 text tokens; sync
# at batch 4, then hierarchical at TRAIN_PODS x TRAIN_PER_POD
VLM_TRAIN_BATCH, VLM_TRAIN_STEPS, VLM_TRAIN_HIER_STEPS = 4, 3, 4
# 27d: the reduced deepseek at a capacity factor where every MoE layer
# drops pairs (asserted); the reduced kimi-k2 at its own head dim 112
TRAIN_DROP_CF, KIMI_HEAD_DIM = 0.5, 112


def train_kernels(dev) -> None:
    """Phase 27 (first): each kernel at the shapes of this phase's paths
    that no earlier phase holds, against its plain version: flash under
    ``FLASH_TOL`` at internvl2's train layer (256 + 4096 positions, 14/2
    heads of 64, causal, bf16) at the sync batch and a pod's, and at
    whisper's decoder self attention (448 positions, 3.5 kv tiles of 128,
    causal, bf16); rmsnorm at d 896 on the rows of both, bit for bit.
    deepseek's train shapes are phase 25a's layer and ``moe_prefill``,
    whisper's encoder and cross attention phase 26a's."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(28)
    positions = VLM_PREFIX + TRAIN_SEQ
    for batch in (VLM_TRAIN_BATCH, TRAIN_PER_POD):
        emit("kernel", **flash_case(
            gen, f"vlm_train_b{batch}", (batch, positions, positions, 14, 2,
                                         64), torch.bfloat16, True))
        fields, _, _ = rmsnorm_case(gen, f"vlm_train_b{batch}",
                                    batch * positions, 896, torch.bfloat16,
                                    None, {}, timed=False)
        emit("kernel", **fields)
    emit("kernel", **flash_case(
        gen, "whisper_decoder_self", (ENCDEC_TRAIN_BATCH, ENCDEC_DEC_SEQ,
                                      ENCDEC_DEC_SEQ, 20, 20, 64),
        torch.bfloat16, True))


def train_moe_path(dev) -> dict:
    """Phase 27a: deepseek-v2-lite-16b at full width (d 2048, MLA, 64
    experts top-6 + 2 shared, vocab 102,400) cut to 4 layers (the dense
    one and 3 MoE), bf16 activations, float32 params and AdamW state,
    batch 4 x 4096, 3 ``sync`` steps: flash at head dim 192 (one a layer)
    and rmsnorm at d 2048 with their backwards; the profile's MoE dispatch
    share. Returns the path's launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import SHAPES, build_model, moe

    full = get_config(MOE_ARCH)
    cfg = no_remat(dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS))
    model = build_model(cfg)
    data, data_s = train_data(model, (MOE_TRAIN_STEPS + 1)
                              * MOE_TRAIN_BATCH, TRAIN_SEQ, dev)
    run = train_run(dev, model, data, phase="train_moe_sync", mode="sync",
                    batch=MOE_TRAIN_BATCH, steps=MOE_TRAIN_STEPS,
                    cut=dict(n_layers=[MOE_TRAIN_LAYERS, full.n_layers],
                             batch=[MOE_TRAIN_BATCH,
                                    SHAPES["train_4k"].global_batch]),
                    capacity=moe.capacity(cfg, MOE_TRAIN_BATCH * TRAIN_SEQ),
                    data_s=data_s)[0]
    del data
    torch.cuda.empty_cache()
    return path_launches(train_moe_sync=run)


def train_encdec_path(dev) -> dict:
    """Phase 27b: whisper-large-v3 whole (32 + 32 layers, d 1280, vocab
    51,866), bf16 activations from bf16 frames, float32 params and AdamW
    state, batch 4 x (1500 frames + 448 tokens), 3 ``sync`` steps: 96
    flash launches a forward (encoder, decoder self, cross; the cross
    attention non-causal at 448 over 1500) and no rmsnorm (LayerNorm).
    Returns the path's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(no_remat(get_config(ENCDEC_ARCH)))
    data, data_s = train_data(model, (ENCDEC_TRAIN_STEPS + 1)
                              * ENCDEC_TRAIN_BATCH, ENCDEC_DEC_SEQ, dev)
    run = train_run(dev, model, data, phase="train_encdec_sync",
                    mode="sync", batch=ENCDEC_TRAIN_BATCH,
                    steps=ENCDEC_TRAIN_STEPS, data_s=data_s)[0]
    del data
    torch.cuda.empty_cache()
    return path_launches(train_encdec_sync=run)


def train_vlm_path(dev) -> dict:
    """Phase 27c: internvl2-1b whole (24 layers, d 896, tied vocab
    151,655) on 256 bf16 image tokens before 4096 text tokens: ``sync`` at
    batch 4 for 3 steps, then ``hierarchical`` with 2 pods x 2 sequences
    (the prefix split with its tokens), a ``TopKCompressor(0.01)`` cloud
    sync every 2 steps, 4 steps: 24 flash and 49 rmsnorm launches a
    forward. Returns the path's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import TopKCompressor
    from repro_torch.models import build_model

    model = build_model(no_remat(get_config(VLM_ARCH)))
    need = max(VLM_TRAIN_STEPS, VLM_TRAIN_HIER_STEPS) + 1
    data, data_s = train_data(model, need * max(
        VLM_TRAIN_BATCH, TRAIN_PODS * TRAIN_PER_POD), TRAIN_SEQ, dev)
    sync = train_run(dev, model, data, phase="train_vlm_sync", mode="sync",
                     batch=VLM_TRAIN_BATCH, steps=VLM_TRAIN_STEPS,
                     data_s=data_s)[0]
    torch.cuda.empty_cache()
    hier = train_run(dev, model, data, phase="train_vlm_hierarchical",
                     mode="hierarchical", batch=TRAIN_PODS * TRAIN_PER_POD,
                     steps=VLM_TRAIN_HIER_STEPS,
                     compressor=TopKCompressor(TRAIN_TOPK),
                     edge_period=TRAIN_EDGE_PERIOD)[0]
    del data
    torch.cuda.empty_cache()
    return path_launches(train_vlm_sync=sync, train_vlm_hierarchical=hier)


def train_families_card_vs_cpu(dev) -> None:
    """Phase 27d: phase 21's card-against-CPU check of the train step on
    the reduced deepseek-v2-lite-16b at capacity factor 0.5 (pairs drop in
    every MoE layer, asserted; MLA), kimi-k2 at head dim 112, whisper (its
    16 frames against 64 decoder positions) and internvl2 (with its
    prefix), all float32."""
    import dataclasses
    from repro_torch.configs import get_config

    deepseek = get_config(MOE_ARCH).reduced(dtype="float32")
    deepseek = dataclasses.replace(deepseek, moe=dataclasses.replace(
        deepseek.moe, capacity_factor=TRAIN_DROP_CF))
    train_card_vs_cpu(dev, [
        (deepseek, True),
        (get_config("kimi-k2-1t-a32b").reduced(dtype="float32",
                                               head_dim=KIMI_HEAD_DIM),
         False),
        (get_config(ENCDEC_ARCH).reduced(dtype="float32"), False),
        (get_config(VLM_ARCH).reduced(dtype="float32"), False)],
        phase="train_families_card_vs_cpu")


def train_entry(kernel: str, bwd: dict, paths: dict) -> dict:
    """A kernel's launches on the train paths (``paths``: path name ->
    ``path_launches``) and its ``backward`` entry for the ``kernels``
    line: route, ms at the train shape and error against the CPU
    (``bwd``), calls on each train path and share of each profiled
    step."""
    share = {}
    for path in paths.values():
        for label, run in path["runs"].items():
            b = (run["profile"] or {}).get("backward", {}).get(
                BWD_LABELS[kernel])
            share[label] = None if b is None else b["share_of_step"]
    return dict(kernel=sum(p["launches"][kernel]["kernel"]
                           for p in paths.values()),
                by_path={name: p["launches"][kernel]["kernel"]
                         for name, p in paths.items()},
                backward=dict(bwd[kernel], calls={
                    name: p["launches"][kernel]["backward"]
                    for name, p in paths.items()}, kernel_launches={
                    name: p["launches"][kernel]["backward_kernel"]
                    for name, p in paths.items()}, share_of_step=share))


# ---- 29: the model zoo over a mesh of ranks, all on the one card ----
# qwen3-0.6b at full width (hf Qwen/Qwen3-0.6B), random weights from seed
# 0, bf16 activations, float32 params and AdamW state; gloo ranks over CUDA
# tensors (NCCL refuses two ranks on one card), spawned processes. Four
# ranks sharing one card measure the mechanism and its cost, not the
# speed-up of four cards.
MESH_ARCH = "qwen3-0.6b"
MESH_SEQ, MESH_BATCH, MESH_STEPS = 4096, 2, 3        # (a), (b), (f)
# (a)'s bf16 first-step loss against the one-rank step's (relative), and
# the max abs gap of its logits at every MESH_LOGIT_STRIDE-th position.
# Each limit is the geometric mean of the sound reading and a control's:
# the same forward with the last layer's row-parallel all-reduce dropped
# (MESH_FAULT_LAYERS), the weakest of the two faults planted in the
# control run. On an H100 80GB HBM3 at 700 W (PERF.md): loss 7.2e-6 sound,
# 1.77e-4 fault; logits 0.082 sound, 0.416 fault. Every run asserts that
# the control lands above both limits.
MESH_LOSS_RTOL = 3.5e-5
MESH_BF16_LOGIT_ATOL = 0.18
MESH_LOGIT_STRIDE = 256
MESH_FAULT_LAYERS = (-1,)
MESH_F32_LAYERS = 2                                  # (b), (d)'s check
# (c): (pod=2, data=2, model=1), one row a rank; at sequence 4096 a rank
# would hold a whole pod copy's float32 params, moments and gathered
# blocks (~7 GB) and one row's activations (~10 GB): ~70 GB for four, too
# close to 75; at 2048 ~55 GB
MESH_HIER_SEQ, MESH_HIER_BATCH = 2048, 4
MESH_HIER_STEPS, MESH_HIER_PERIOD = 4, 2
# (d): phase 10's 8 requests with their prompts cut from 256 to the first
# 64 tokens: over gloo a step takes ~0.45 s (0.4326 s a decode step and
# 0.5351 s a prompt step on an H100 80GB HBM3 at 700 W, PERF.md), so the
# 287 steps of the whole requests took ~140 s; 95 steps take ~45 s
MESH_SERVE_PROMPT = 64
MESH_SERVE_F32 = (64, 16)          # (d)'s float32 check: prompt, new tokens
MESH_LOGIT_ATOL = 1e-4
MESH_PEAK_LIMIT = 75e9             # bytes: the ranks' peaks summed
MESH_TIMEOUT_S = 600               # a collective's deadline in the ranks


def mesh_plan(device: str = "cuda") -> dict:
    """Phase 29's sizes, handed to the spawned ranks (which do not see
    this module's globals as a test may have patched them)."""
    return dict(device=device, arch=MESH_ARCH, reduced=False, seq=MESH_SEQ,
                batch=MESH_BATCH, steps=MESH_STEPS,
                f32_layers=MESH_F32_LAYERS, hier_seq=MESH_HIER_SEQ,
                hier_batch=MESH_HIER_BATCH, hier_steps=MESH_HIER_STEPS,
                hier_period=MESH_HIER_PERIOD,
                serve=[SERVE_REQUESTS, MESH_SERVE_PROMPT, SERVE_NEW],
                serve_f32=list(MESH_SERVE_F32), lr=3e-4,
                train_tol=TRAIN_TOL, logit_stride=MESH_LOGIT_STRIDE,
                fault_layers=list(MESH_FAULT_LAYERS))


def mesh_config(plan: dict, f32: bool = False):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = no_remat(get_config(plan["arch"]))
    if plan["reduced"]:
        cfg = cfg.reduced(dtype="bfloat16")
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  n_layers=plan["f32_layers"])
    return cfg


def mesh_tokens(cfg, rows: int, seq: int, dev, seed: int = 29):
    """(rows, seq + 1) int32 tokens below the vocab from a numpy seed, the
    same in every process."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, cfg.vocab_size, (rows, seq + 1)),
                        dtype=torch.int32, device=dev)


def mesh_prompts(cfg, plan, dev):
    """Phase 10's requests (the same numpy draws: the prefill batch first,
    then the prompts), each prompt's first ``plan["serve"][1]`` tokens."""
    import numpy as np
    import torch
    n, p, _ = plan["serve"]
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ + 1))
    full = rng.integers(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))
    return torch.tensor(full[:n, :p], dtype=torch.int32, device=dev)


def _dev_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak(dev) -> int:
    import torch
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0


def _reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _counts() -> dict:
    from repro_torch.kernels import flash_attention, rmsnorm
    return {"flash_attention": flash_attention.LAUNCHES,
            "flash_attention_bwd": flash_attention.BWD_LAUNCHES,
            "rmsnorm": rmsnorm.LAUNCHES}


def _zero_counts() -> None:
    from repro_torch.kernels import flash_attention, rmsnorm
    flash_attention.LAUNCHES = flash_attention.BWD_LAUNCHES = 0
    flash_attention.BACKWARD_CALLS = rmsnorm.LAUNCHES = 0
    rmsnorm.BACKWARD_CALLS = 0


def mesh_train_steps(bundle, params, batches, dev, *, period: int = 0,
                     pod_equal=None) -> dict:
    """``bundle``'s steps on ``batches`` (whole batches; each rank takes its
    rows) from whole ``params``: s a step, the loss, each step's kernel
    launches on this rank, the peak memory; after each cloud sync the
    seconds it took and ``pod_equal(params)``."""
    import torch
    p, o, step = bundle.init_state(params)
    del params
    _reset_peak(dev)
    rows = []
    for k, whole in enumerate(batches):
        batch = bundle.local_batch(whole)
        before = _counts()
        _dev_sync(dev)
        t0 = time.perf_counter()
        p, o, step, loss = bundle.step_fn(p, o, step, batch)
        _dev_sync(dev)
        row = dict(step=k, s=time.perf_counter() - t0, loss=float(loss),
                   launches={key: v - before[key]
                             for key, v in _counts().items()})
        if period and (k + 1) % period == 0:
            _dev_sync(dev)
            t0 = time.perf_counter()
            p, o = bundle.cloud_sync_fn(p, o)
            _dev_sync(dev)
            row["cloud_sync_ms"] = 1e3 * (time.perf_counter() - t0)
            row["pods_equal"] = pod_equal(p)
        rows.append(row)
    return dict(rows=rows, peak=_peak(dev),
                s_median=statistics.median(r["s"] for r in rows)), \
        (p, o, step)


def mesh_forward(bundle, model, mesh, blocks, batch, stride: int,
                 fault_layer: int | None = None):
    """(loss, logits) of one forward of (a)'s model from this rank's
    parameter blocks on its rows of ``batch``, no gradient: the loss the
    mean over the ranks, the logits at every ``stride``-th position
    gathered whole over ``model``. ``fault_layer``: that layer's
    attention output is not all-reduced over ``model`` (a planted tensor
    parallel fault; the rank keeps its partial sum)."""
    import torch
    from repro_torch.launch import sharding as shd
    from repro_torch.models import attention, pjit_hints
    from repro_torch.models.layers import dense
    from repro_torch.utils import collectives as coll
    from repro_torch.utils import (tree_leaves, tree_leaves_with_path,
                                   tree_unflatten)

    cfg = model.cfg
    paths = [shd._key_str(p)
             for p, _ in tree_leaves_with_path(bundle.params_spec)]
    specs = [sh.spec for sh in shd._sharding_leaves(bundle.params_shardings)]
    real, calls = attention.out_proj, [0]
    fault = None if fault_layer is None else fault_layer % cfg.n_layers

    def out_proj(params, out, split):
        calls[0] += 1
        if calls[0] - 1 == fault:
            return dense(params["wo"], out)
        return real(params, out, split)

    attention.out_proj = out_proj
    try:
        with torch.no_grad(), pjit_hints.hints_ctx(
                pjit_hints.from_mesh(mesh)):
            used = tree_unflatten(blocks, pjit_hints.use_params(
                tree_leaves(blocks), paths, specs, cfg))
            loss = model.loss(used, batch) if fault is not None else None
            calls[0] = 0
            logits = model.logits(used, batch)[:, ::stride].float()
            logits = pjit_hints.gather_from_model(logits, -1)
    finally:
        attention.out_proj = real
    if loss is not None:
        loss = float(coll.all_reduce(loss.float(), mesh.get_group("data"))
                     / coll.size(mesh.get_group("data")))
    return loss, logits


def mesh_controls(bundle, model, mesh, params, batch, plan, out) -> dict:
    """(a)'s sound forward and its two planted faults against the one-rank
    logits of (f): each one's loss (the faults') and max abs logit gap,
    the gap's max over the ranks."""
    import torch
    from repro_torch.launch import sharding as shd
    from repro_torch.utils import collectives as coll
    import torch.distributed as dist

    blocks = shd.shard_tree(params, bundle.params_shardings)
    local = bundle.local_batch(batch)
    ref = bundle.batch_shardings["tokens"].local(
        torch.load(f"{out}/one/logits.pt")).to(batch["tokens"].device)
    got = {}
    for name, layer in [("sound", None)] + [
            (f"fault_layer_{k % model.cfg.n_layers}", k)
            for k in plan["fault_layers"]]:
        loss, logits = mesh_forward(bundle, model, mesh, blocks, local,
                                    plan["logit_stride"], layer)
        gap = coll.all_reduce((logits - ref).abs().max(), dist.group.WORLD,
                              "max")
        got[name] = dict(loss=loss, max_abs_logit_err=float(gap))
        del logits
    return got


def mesh_job_a(mesh, plan, dev, out) -> dict:
    """(a) sync fsdp over (data=2, model=2) at full width, then (e): its
    params written by rank 0 and restored onto (data=4, model=1)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ShapeSpec, build_model
    from repro_torch.utils import tree_leaves

    cfg = mesh_config(plan)
    model = build_model(cfg)
    shape = ShapeSpec("train_mesh", plan["seq"], plan["batch"], "train")
    bundle = make_train_step(model, shape, mesh=mesh, lr=plan["lr"],
                             device=dev)
    data = mesh_tokens(cfg, plan["batch"] * plan["steps"], plan["seq"], dev)
    batches = [{"tokens": data[k * plan["batch"]:(k + 1) * plan["batch"]]}
               for k in range(plan["steps"])]
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    t0 = time.perf_counter()
    controls = mesh_controls(bundle, model, mesh, params, batches[0], plan,
                             out)
    controls_s = time.perf_counter() - t0
    _zero_counts()
    res, (p, o, step) = mesh_train_steps(bundle, params, batches, dev)
    res["controls"], res["controls_s"] = controls, controls_s
    res["local_param_bytes"] = sum(x.numel() * x.element_size()
                                   for x in tree_leaves(p))
    del o
    # (e): whole leaves written by rank 0, restored onto (data=4, model=1)
    other = make_test_mesh((4, 1), ("data", "model"), device_type=dev.type)
    target = shd.param_shardings(bundle.params_spec, other)
    mgr = CheckpointManager(os.path.join(out, "ckpt"), keep=1,
                            async_save=False)
    t0 = time.perf_counter()
    mgr.save(plan["steps"], {"params": p},
             shardings={"params": bundle.params_shardings})
    dist.barrier()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    at, got, _ = mgr.restore({"params": p}, shardings={"params": target})
    restore_s = time.perf_counter() - t0
    whole = shd.gather_tree(p, bundle.params_shardings)
    del p
    again = shd.gather_tree(got["params"], target)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                 tree_leaves(whole)))
    blocks = all(torch.equal(a.to(dev), sh.local(b)) for a, b, sh in zip(
        tree_leaves(got["params"]), tree_leaves(whole),
        shd._sharding_leaves(target)))
    res["restore"] = dict(step=at, reassembled_bitwise=bool(same),
                          blocks_bitwise=bool(blocks), save_s=save_s,
                          restore_s=restore_s, to_mesh=[4, 1])
    del whole, again, got
    return res


def mesh_job_b(mesh, plan, dev) -> dict:
    """(b) (a) at float32 and 2 layers, one step; rank 0 holds it to the
    one-rank step (loss at 1e-5, state at ``TRAIN_TOL``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ShapeSpec, build_model
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    cfg = mesh_config(plan, f32=True)
    model = build_model(cfg)
    shape = ShapeSpec("train_mesh_f32", plan["seq"], plan["batch"], "train")
    bundle = make_train_step(model, shape, mesh=mesh, lr=plan["lr"],
                             device=dev)
    batch = {"tokens": mesh_tokens(cfg, plan["batch"], plan["seq"], dev)}
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _zero_counts()
    res, (p, o, _) = mesh_train_steps(bundle, tree_map(torch.clone, params),
                                      [batch], dev)
    got = {"params": shd.gather_tree(p, bundle.params_shardings),
           "m": shd.gather_tree(o["m"], bundle.opt_shardings["m"]),
           "v": shd.gather_tree(o["v"], bundle.opt_shardings["v"])}
    del p, o
    if dist.get_rank() == 0:
        one = make_train_step(model, shape, lr=plan["lr"], device=dev)
        p1, o1, s1 = one.init_state(params)
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p1)]
        loss1 = model.loss(tree_unflatten(p1, leaves), batch)
        grads = torch.autograd.grad(loss1, leaves)
        del leaves
        p1, o1, s1, loss1 = one.step_fn(p1, o1, s1, batch)
        tol = plan["train_tol"]
        worst, ok = 0.0, True
        for g, w, gr in zip(tree_leaves(got["params"]), tree_leaves(p1),
                            grads):
            e, good = step_close(g, w, gr, plan["lr"])
            worst, ok = max(worst, e), ok and good
        for key in ("m", "v"):
            for g, w in zip(tree_leaves(got[key]), tree_leaves(o1[key])):
                e, good = grad_close(g, w, tol)
                worst, ok = max(worst, e), ok and good
        loss_rel = abs(res["rows"][0]["loss"] - float(loss1)) \
            / abs(float(loss1))
        res["vs_one_rank"] = dict(loss=res["rows"][0]["loss"],
                                  loss_one_rank=float(loss1),
                                  loss_rel_err=loss_rel, loss_rtol=1e-5,
                                  state_max_abs_err=worst, state_tol=tol,
                                  state_within=bool(ok),
                                  loss_within=bool(loss_rel <= 1e-5))
        del p1, o1, grads
    del got, params
    dist.barrier()
    return res


def mesh_job_c(plan, dev) -> dict:
    """(c) hierarchical over (pod=2, data=2, model=1): 4 steps, a cloud
    sync every 2; after each sync every leaf of the two pods' copies equal
    bit for bit."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ShapeSpec, build_model
    from repro_torch.utils import collectives as coll
    from repro_torch.utils import tree_leaves

    mesh = make_test_mesh((2, 2, 1), ("pod", "data", "model"),
                          device_type=dev.type)
    cfg = mesh_config(plan)
    model = build_model(cfg)
    shape = ShapeSpec("train_mesh_hier", plan["hier_seq"],
                      plan["hier_batch"], "train")
    bundle = make_train_step(model, shape, mesh=mesh, mode="hierarchical",
                             lr=plan["lr"], device=dev)
    rows = plan["hier_batch"]
    data = mesh_tokens(cfg, rows * plan["hier_steps"], plan["hier_seq"], dev,
                       seed=30)
    batches = [{"tokens": data[k * rows:(k + 1) * rows]}
               for k in range(plan["hier_steps"])]
    pod = mesh.get_group("pod")

    def pod_equal(p):
        return all(bool(torch.equal(*coll.all_gather(x, pod, 0)
                                    .chunk(2)))
                   for x in tree_leaves(p))

    _zero_counts()
    res, _ = mesh_train_steps(bundle, model.init(torch.Generator(
        device=dev).manual_seed(0)), batches, dev,
        period=plan["hier_period"], pod_equal=pod_equal)
    return res


def mesh_job_d(mesh, plan, dev) -> dict:
    """(d) serving over (data=2, model=2): phase 10's requests in bf16 (ms
    a decode step, the share of greedy tokens equal to one rank's), then
    at float32 and 2 layers the same greedy tokens and decode logits
    within ``MESH_LOGIT_ATOL`` of one rank's."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import ShapeSpec, build_model

    out = {}
    for case, f32 in (("bf16", False), ("f32", True)):
        cfg = mesh_config(plan, f32=f32)
        model = build_model(cfg)
        prompts = mesh_prompts(cfg, plan, dev)
        new = plan["serve"][2]
        if f32:
            prompts, new = prompts[:, :plan["serve_f32"][0]], \
                plan["serve_f32"][1]
        n, prompt = prompts.shape
        shape = ShapeSpec("serve_mesh", prompt + new, n, "decode")
        bundle = make_serve_step(model, mesh, shape)
        whole = model.init_serving(torch.Generator(device=dev).manual_seed(0))
        params = bundle.compute_params(shd.shard_tree(
            whole, bundle.params_shardings))
        _zero_counts()
        _reset_peak(dev)
        res = serve(model, params, bundle.token_sharding.local(prompts), new,
                    max_len=prompt + new, keep_prompt_logits=f32,
                    bundle=bundle)
        steps = res.prompt_steps + res.decode_steps
        line = dict(requests=n, prompt=prompt, new_tokens=new,
                    dtype=cfg.dtype, n_layers=cfg.n_layers,
                    decode_ms_per_step=res.ms_per_decode_step,
                    prompt_ms_per_step=1e3 * res.prompt_s / res.prompt_steps,
                    rmsnorm_per_step=_counts()["rmsnorm"] / steps,
                    flash_launches=_counts()["flash_attention"],
                    peak=_peak(dev))
        del params
        if dist.get_rank() == 0:
            one = serve(model, whole, prompts, new, max_len=prompt + new,
                        keep_prompt_logits=f32)
            same = (res.tokens == one.tokens)
            line.update(tokens_equal_share=float(same.float().mean()),
                        one_rank_decode_ms_per_step=one.ms_per_decode_step)
            if f32:
                gap = (res.prompt_logits - one.prompt_logits).abs()
                line.update(max_abs_logit_err=float(gap.max()),
                            logit_atol=MESH_LOGIT_ATOL,
                            tokens_equal=bool(same.all()),
                            logits_within=bool(gap.max() <= MESH_LOGIT_ATOL))
        del whole
        dist.barrier()
        out[case] = line
    return out


def mesh_rank(rank: int, world: int, out: str, plan: dict) -> None:
    """One of phase 29's four gloo ranks on the card: the collectives the
    backend carries, then jobs (a) + (e), (b), (c) and (d); its fields to
    ``out/rank<r>.json``."""
    sys.path.insert(0, str(SRC))
    import datetime
    import torch
    import torch.distributed as dist
    dev = torch.device(plan["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    fields = {}
    try:
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.utils import collectives as coll
        mesh = make_test_mesh((2, 2), ("data", "model"),
                              device_type=dev.type)
        fields["carries"] = coll.probe(dist.group.WORLD, dev)
        for job, fn in (("a", lambda: mesh_job_a(mesh, plan, dev, out)),
                        ("b", lambda: mesh_job_b(mesh, plan, dev)),
                        ("c", lambda: mesh_job_c(plan, dev)),
                        ("d", lambda: mesh_job_d(mesh, plan, dev))):
            t0 = time.perf_counter()
            fields[job] = fn()
            fields[job]["job_s"] = time.perf_counter() - t0
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(fields, f)
    finally:
        dist.destroy_process_group()


def mesh_one_rank(rank: int, world: int, out: str, plan: dict) -> None:
    """(f): a 1-rank NCCL mesh of (a)'s step against the ``mesh=None``
    step on the same params and batch (bit for bit), whose loss is also
    (a)'s one-rank reference."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    dev = torch.device(plan["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{out}/store", rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import ShapeSpec, build_model
        from repro_torch.utils import tree_leaves, tree_map
        mesh = make_test_mesh((1, 1), ("data", "model"),
                              device_type=dev.type)
        cfg = mesh_config(plan)
        model = build_model(cfg)
        shape = ShapeSpec("train_mesh", plan["seq"], plan["batch"], "train")
        batch = {"tokens": mesh_tokens(cfg, plan["batch"] * plan["steps"],
                                       plan["seq"], dev)[:plan["batch"]]}
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        runs = {}
        for name, kw in (("none", {}), ("mesh", {"mesh": mesh})):
            bundle = make_train_step(model, shape, lr=plan["lr"],
                                     device=dev, **kw)
            p, o, step = bundle.init_state(tree_map(torch.clone, params))
            _dev_sync(dev)
            t0 = time.perf_counter()
            p, o, step, loss = bundle.step_fn(p, o, step, batch)
            _dev_sync(dev)
            runs[name] = (time.perf_counter() - t0, loss,
                          tree_leaves(p) + tree_leaves(o))
        loss_none = float(runs["none"][1])
        s_none, s_mesh = runs["none"][0], runs["mesh"][0]
        same = bool(torch.equal(runs["none"][1], runs["mesh"][1])) and all(
            torch.equal(a, b) for a, b in zip(runs["none"][2],
                                              runs["mesh"][2]))
        del runs
        with torch.no_grad():      # (a)'s reference logits
            ref = model.logits(params, batch)[:, ::plan["logit_stride"]]
            torch.save(ref.float().cpu(), f"{out}/logits.pt")
        with open(f"{out}/one_rank.json", "w") as f:
            json.dump(dict(backend=dist.get_backend(), bitwise=same,
                           loss=loss_none, s_none=s_none, s_mesh=s_mesh), f)
    finally:
        dist.destroy_process_group()


def spawn_mesh(fn, world: int, out: str, plan: dict) -> float:
    """``fn`` on ``world`` spawned ranks, joined; the seconds from spawn to
    join."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.start_processes(fn, args=(world, out, plan), nprocs=world, join=True,
                       start_method="spawn")
    return time.perf_counter() - t0


def mesh_path(dev, plan: dict | None = None) -> dict:
    """Phase 29: (f) first (its ``mesh=None`` step is (a)'s one-rank
    reference), then (a)-(e) on four ranks. Emits ``mesh_train``,
    ``mesh_restore``, ``mesh_train_f32``, ``mesh_hier``, ``mesh_serve``
    and ``mesh_one_rank``; asserts each check. Returns each kernel's
    launches in (a) summed over the ranks."""
    import torch
    plan = plan or mesh_plan(dev.type)
    held = 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/one")
        one_s = spawn_mesh(mesh_one_rank, 1, f"{tmp}/one", plan)
        with open(f"{tmp}/one/one_rank.json") as f:
            one = json.load(f)
        four_s = spawn_mesh(mesh_rank, 4, tmp, plan)
        ranks = []
        for r in range(4):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
    smi = nvidia_smi_line() if dev.type == "cuda" else "cpu"
    emit("mesh_one_rank", card=smi, backend=one["backend"],
         bitwise=one["bitwise"], loss=one["loss"], s_mesh_none=one["s_none"],
         s_mesh_1x1=one["s_mesh"], spawn_to_join_s=one_s)
    cfg = mesh_config(plan)
    a = [r["a"] for r in ranks]
    per_step = {"flash_attention": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers,
                "rmsnorm": 2 * cfg.n_layers + 1}
    launches_ok = all(row["launches"] == per_step
                      for ra in a for row in ra["rows"])
    first = a[0]["rows"][0]["loss"]
    loss_rel = abs(first - one["loss"]) / abs(one["loss"])
    ctrl = a[0]["controls"]
    faults = {k: dict(v, loss_rel_err=abs(v["loss"] - one["loss"])
                      / abs(one["loss"])) for k, v in ctrl.items()
              if k != "sound"}
    logit_err = ctrl["sound"]["max_abs_logit_err"]
    peaks = [ra["peak"] for ra in a]
    emit("mesh_train", card=smi, arch=cfg.name, mesh={"data": 2, "model": 2},
         sharding="fsdp", backend="gloo", ranks_on_one_card=4,
         seq=plan["seq"], global_batch=plan["batch"], steps=plan["steps"],
         dtype=cfg.dtype, carries=ranks[0]["carries"],
         s_per_step_median=[ra["s_median"] for ra in a],
         s_per_step=[[row["s"] for row in ra["rows"]] for ra in a],
         losses=[row["loss"] for row in a[0]["rows"]],
         first_loss_one_rank=one["loss"], first_loss_rel_err=loss_rel,
         loss_rtol=MESH_LOSS_RTOL, max_abs_logit_err=logit_err,
         logit_atol=MESH_BF16_LOGIT_ATOL, logit_stride=plan["logit_stride"],
         controls=faults, controls_s=a[0]["controls_s"],
         launches_per_step_per_rank=[ra["rows"][-1]["launches"] for ra in a],
         launches_expected=per_step, peak_per_rank=peaks,
         peak_total=sum(peaks), peak_limit=MESH_PEAK_LIMIT,
         local_param_bytes=[ra["local_param_bytes"] for ra in a],
         job_s=[ra["job_s"] for ra in a], spawn_to_join_s=four_s,
         parent_reserved_bytes=held)
    rest = [r["a"]["restore"] for r in ranks]
    emit("mesh_restore", **rest[0],
         bitwise_all_ranks=all(x["reassembled_bitwise"] and x["blocks_bitwise"]
                               for x in rest))
    b = ranks[0]["b"]
    emit("mesh_train_f32", n_layers=plan["f32_layers"], seq=plan["seq"],
         global_batch=plan["batch"], peak_per_rank=[r["b"]["peak"]
                                                    for r in ranks],
         job_s=b["job_s"], **b["vs_one_rank"])
    c = [r["c"] for r in ranks]
    syncs = [row for row in c[0]["rows"] if "cloud_sync_ms" in row]
    emit("mesh_hier", mesh={"pod": 2, "data": 2, "model": 1},
         seq=plan["hier_seq"], global_batch=plan["hier_batch"],
         steps=plan["hier_steps"], edge_period=plan["hier_period"],
         s_per_step_median=[rc["s_median"] for rc in c],
         losses=[row["loss"] for row in c[0]["rows"]],
         cloud_sync_ms=[[row["cloud_sync_ms"] for row in rc["rows"]
                         if "cloud_sync_ms" in row] for rc in c],
         pods_equal=[[row["pods_equal"] for row in rc["rows"]
                      if "pods_equal" in row] for rc in c],
         peak_per_rank=[rc["peak"] for rc in c],
         peak_total=sum(rc["peak"] for rc in c), job_s=c[0]["job_s"])
    d = ranks[0]["d"]
    emit("mesh_serve", card=smi, mesh={"data": 2, "model": 2},
         bf16=d["bf16"], f32=d["f32"],
         decode_ms_per_step_per_rank=[r["d"]["bf16"]["decode_ms_per_step"]
                                      for r in ranks],
         peak_per_rank=[r["d"]["bf16"]["peak"] for r in ranks],
         job_s=d["job_s"])
    checks = dict(
        launches=launches_ok, one_rank_bitwise=one["bitwise"],
        first_loss=loss_rel <= MESH_LOSS_RTOL,
        logits=logit_err <= MESH_BF16_LOGIT_ATOL,
        controls_caught=all(
            f["loss_rel_err"] > MESH_LOSS_RTOL
            and f["max_abs_logit_err"] > MESH_BF16_LOGIT_ATOL
            for f in faults.values()),
        peak=sum(peaks) <= MESH_PEAK_LIMIT,
        finite=all(math.isfinite(row["loss"]) for ra in a + c
                   for row in ra["rows"]),
        restore=all(x["reassembled_bitwise"] and x["blocks_bitwise"]
                    for x in rest),
        f32_loss=b["vs_one_rank"]["loss_within"],
        f32_state=b["vs_one_rank"]["state_within"],
        hier_pods_equal=len(syncs) == plan["hier_steps"]
        // plan["hier_period"] and all(row["pods_equal"] for rc in c
                                       for row in rc["rows"]
                                       if "pods_equal" in row),
        hier_peak=sum(rc["peak"] for rc in c) <= MESH_PEAK_LIMIT,
        serve_f32_tokens=d["f32"]["tokens_equal"],
        serve_f32_logits=d["f32"]["logits_within"],
        serve_rmsnorm=all(r["d"][k]["rmsnorm_per_step"]
                          == 2 * r["d"][k]["n_layers"] + 1
                          and r["d"][k]["flash_launches"] == 0
                          for r in ranks for k in ("bf16", "f32")))
    emit("mesh_checks", **checks)
    if not all(checks.values()):
        raise AssertionError(f"phase 29 failed: {checks}")
    return {key: sum(sum(row["launches"][key] for row in ra["rows"])
                     for ra in a) for key in per_step}


# ---- 30: the dry run against the card's own step ----

DRYRUN_PEAK_RTOL = 0.15      # the predicted peak against the measured one
DRYRUN_DECODE_LEN = SERVE_PROMPT + SERVE_NEW     # phase 10's cache
DRYRUN_HOST_CALLS = 200


def dryrun_host_us(x, scale, q, k, v) -> dict:
    """Host microseconds a call (``DRYRUN_HOST_CALLS`` enqueues, no
    synchronize between them) of rmsnorm at phase 10's decode shape and
    flash's forward at a small one: the wrapper alone (the call before
    the kernels became operators), through its ``torch.ops.repro_torch``
    operator, and through ``ops`` (the model's entry point)."""
    import torch
    from repro_torch.kernels import flash_attention, ops, rmsnorm
    calls = {
        "rmsnorm": {"wrapper": lambda: rmsnorm.rmsnorm(x, scale),
                    "operator": lambda: rmsnorm.rmsnorm_op(x, scale, 1e-6),
                    "ops": lambda: ops.rmsnorm(x, scale)},
        "flash_attention": {
            "wrapper": lambda: flash_attention.flash_attention(q, k, v),
            "operator": lambda: flash_attention.flash_attention_fwd(q, k, v),
            "ops": lambda: ops.flash_attention(q, k, v)}}
    out = {}
    with torch.inference_mode():
        for kernel, fns in calls.items():
            out[kernel] = {}
            for route, fn in fns.items():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DRYRUN_HOST_CALLS):
                    fn()
                out[kernel][route] = (1e6 * (time.perf_counter() - t0)
                                      / DRYRUN_HOST_CALLS)
                torch.cuda.synchronize()
    return out


def dryrun_train_side(dev, model, batch) -> dict:
    """The card's side of phase 30 (a) and (b) for one ``remat``: a step's
    FLOPs under ``FlopCounterMode``, two timed steps after a warm-up one
    (s each, and the peak bytes above what the process held beside the
    step's own tensors), from seed 0's float32 params."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ShapeSpec
    from repro_torch.utils import tree_leaves
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_SYNC_BATCH, "train")
    bundle = make_train_step(model, shape, device=dev)
    params, opt, step = bundle.init_state(
        model.init(torch.Generator(device=dev).manual_seed(0)))
    params, opt, step, loss0 = bundle.step_fn(params, opt, step, batch)
    torch.cuda.synchronize()
    args = [t for t in tree_leaves((params, opt, batch)) + [step]]
    arg_bytes = sum({t.untyped_storage().data_ptr():
                     t.untyped_storage().nbytes() for t in args}.values())
    torch.cuda.empty_cache()
    other = torch.cuda.memory_allocated() - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        params, opt, step, loss = bundle.step_fn(params, opt, step, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - other
    with FlopCounterMode(display=False) as fc:
        bundle.step_fn(params, opt, step, batch)
    torch.cuda.synchronize()
    del params, opt
    torch.cuda.empty_cache()
    return dict(flops=fc.get_total_flops(), s=times, peak=peak,
                arg_bytes=arg_bytes, other=other, first_loss=float(loss0),
                loss=float(loss))


# (f): one cell of each family that phases 24-27 train, as they cut it:
# (arch, layers or None for the whole model, rows, sequence)
REMAT_CELLS = ((MOE_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, TRAIN_SEQ),
               (SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS, SSM_TRAIN_BATCH,
                SSM_TRAIN_SEQ),
               (ENCDEC_ARCH, None, ENCDEC_TRAIN_BATCH, ENCDEC_DEC_SEQ),
               (VLM_ARCH, None, VLM_TRAIN_BATCH, TRAIN_SEQ))
REMAT_KERNELS = ("flash_attention", "rmsnorm", "ssd_state_scan")


def remat_launches() -> dict:
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    return dict(flash_attention=flash_attention.LAUNCHES,
                flash_attention_bwd=flash_attention.BWD_LAUNCHES,
                rmsnorm=rmsnorm.LAUNCHES, ssd_state_scan=ssd_scan.LAUNCHES)


def remat_close(got, want, zero_scale: float | None) -> tuple[float, bool]:
    """``grad_close`` at ``TRAIN_TOL`` of two gradients of one leaf; a leaf
    whose exact gradient is zero (``zero_grad_scales``) is held at the
    larger of its weight's scale and its own largest value: both sides are
    rounding noise, in bf16 above ``TRAIN_TOL`` of that scale."""
    import torch
    if zero_scale is None:
        return grad_close(got, want, TRAIN_TOL)
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    scale = max(zero_scale, float(want.abs().max()))
    return float(err.max()), bool(torch.isfinite(got).all()
                                  and (err <= TRAIN_TOL * scale).all())


def remat_families(dev) -> dict:
    """Phase 30 (f): ``remat="block"``, every family's default, against
    "none" on the card for one cell of each family that phases 24-27 train
    with "none" pinned (``REMAT_CELLS``: deepseek cut to
    ``MOE_TRAIN_LAYERS``, mamba2 to ``SSM_TRAIN_LAYERS``, whisper and
    internvl2 whole, at those phases' batches; float32 params, bf16
    activations). One loss-and-gradients call each from the same params
    and batch ("block" first, after an untimed warm-up call): the loss bit for bit, the gradients within
    ``TRAIN_TOL`` (``remat_close``), and each kernel's launches: every forward
    kernel the family runs launches more often under "block" (its
    recomputation), flash's backward as often. Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.models import build_model
    from repro_torch.utils import tree_unflatten

    smi = nvidia_smi_line()
    total = dict.fromkeys(remat_launches(), 0)
    failed = []
    for arch, layers, rows, seq in REMAT_CELLS:
        base = get_config(arch)
        if layers is not None:
            base = dataclasses.replace(base, n_layers=layers)
        assert base.remat == "block"
        params = build_model(base).init(
            torch.Generator(device=dev).manual_seed(0))
        batch, _ = train_data(build_model(base), rows, seq, dev)
        batch = {k: v.to(dev) for k, v in batch.items()}
        # one untimed call first: a process's first call at a family's
        # shapes pays its set-up (40x the step for deepseek alone)
        _loss_and_grads(build_model(dataclasses.replace(base, remat="none")),
                        params, batch, 1.0, lambda _: None)
        runs = {}
        for remat in ("block", "none"):
            model = build_model(dataclasses.replace(base, remat=remat))
            flash_attention.LAUNCHES = flash_attention.BWD_LAUNCHES = 0
            rmsnorm.LAUNCHES = ssd_scan.LAUNCHES = 0
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, grads = _loss_and_grads(model, params, batch, 1.0,
                                          lambda _: None)
            torch.cuda.synchronize()
            runs[remat] = dict(loss=loss, grads=grads,
                               s=time.perf_counter() - t0,
                               peak=torch.cuda.max_memory_allocated() - held,
                               launches=remat_launches())
        blk, non = runs["block"], runs["none"]
        scales = zero_grad_scales(base, tree_unflatten(params, non["grads"]))
        pairs = [remat_close(a, b, z)
                 for a, b, z in zip(blk["grads"], non["grads"], scales)]
        bitwise = all(bool(torch.equal(a, b))
                      for a, b in zip(blk["grads"], non["grads"]))
        lb, ln = blk["launches"], non["launches"]
        recomputed = all(lb[k] > ln[k] for k in REMAT_KERNELS if ln[k])
        checks = dict(loss_bitwise=bool(torch.equal(blk["loss"],
                                                    non["loss"])),
                      grads_within_tol=all(ok for _, ok in pairs),
                      forward_recomputed=recomputed and any(ln.values()),
                      backward_as_often=(lb["flash_attention_bwd"]
                                         == ln["flash_attention_bwd"]))
        emit("dryrun_remat_family", arch=arch, n_layers=base.n_layers,
             rows=rows, seq=seq, dtype=base.dtype, param_dtype="float32",
             loss_block=float(blk["loss"]), loss_none=float(non["loss"]),
             grad_max_err=max(e for e, _ in pairs), grad_tol=TRAIN_TOL,
             grads_bitwise=bitwise, s_block=blk["s"], s_none=non["s"],
             time_ratio=blk["s"] / non["s"], peak_block=blk["peak"],
             peak_none=non["peak"], peak_ratio=blk["peak"] / non["peak"],
             launches_block=lb, launches_none=ln, checks=checks,
             nvidia_smi=smi)
        if not all(checks.values()):
            failed.append((arch, checks))
        for k in total:
            total[k] += lb[k] + ln[k]
        del params, batch, runs, blk, non, pairs
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"dryrun_remat_family: {failed}")
    return total


def dryrun_path(dev) -> dict:
    """Phase 30: the port's dry run (``launch/dryrun.py``) against the
    card. (a) The one-rank count of phase 22's cell (qwen3-0.6b, train_4k
    at batch 4, sync, float32 params, bf16 activations, ``remat="block"``)
    on fake tensors against a real step: the FLOPs equal, the predicted
    peak within ``DRYRUN_PEAK_RTOL`` of the measured one, the H100
    roofline terms and max(term) over the measured step. (b) The same
    with ``remat="none"``: the first loss bit for bit and the gradients
    within ``TRAIN_TOL``; both times and peaks. (c) The count check of
    phase 9's prefill (4 x 4096) and of a phase-10 decode step. (d) The
    production-mesh dry run of qwen3-0.6b train_4k (a process of its own:
    it holds a fake process group of 256 ranks). (e) The custom
    operators' host cost a call. (f) ``remat_families``: "block" against
    "none" for the MoE, SSM, encoder-decoder and VLM families. Returns the
    kernels' launches."""
    import dataclasses
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import H100, roofline_terms
    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.models import ShapeSpec, build_model

    smi = nvidia_smi_line()
    cfg = get_config(TRAIN_ARCH)
    assert cfg.remat == "block" and cfg.dtype == "bfloat16"
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_SYNC_BATCH, "train")
    data, _ = train_data(build_model(cfg), TRAIN_SYNC_BATCH, TRAIN_SEQ, dev)
    batch = {k: v.to(dev) for k, v in data.items()}

    # (a) and (b): the fake counts, then the card's steps
    flash_attention.LAUNCHES = flash_attention.BWD_LAUNCHES = 0
    rmsnorm.LAUNCHES = 0
    sides = {}
    for remat in ("block", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        t0 = time.perf_counter()
        fake = dryrun.count_train_step(c, shape)["step"]
        fake_s = time.perf_counter() - t0
        card = dryrun_train_side(dev, build_model(c), batch)
        step_s = min(card["s"])
        terms = roofline_terms(fake.cost(), fake.collectives.stats(),
                               n_chips=1, model_flops=dryrun.
                               _train_flops_estimate(c, shape))
        sides[remat] = dict(
            fake_flops=fake.flops, card_flops=card["flops"],
            fake_bytes=fake.bytes, fake_s=fake_s,
            predicted_peak=fake.peak_bytes,
            predicted_arguments=fake.argument_bytes,
            measured_peak=card["peak"], measured_arguments=card["arg_bytes"],
            peak_rel_err=(fake.peak_bytes - card["peak"]) / card["peak"],
            s_per_step=card["s"], first_loss=card["first_loss"],
            roofline={k: getattr(terms, k) for k in (
                "compute_s", "memory_s", "collective_s", "dominant",
                "flops_ratio")},
            roofline_fraction=max(terms.compute_s, terms.memory_s,
                                  terms.collective_s) / step_s)
    launched = dict(flash_attention=flash_attention.LAUNCHES,
                    flash_attention_bwd=flash_attention.BWD_LAUNCHES,
                    rmsnorm=rmsnorm.LAUNCHES)

    # (b) gradients: both remats from the same params and batch
    grads = {}
    for remat in ("block", "none"):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        loss, g = _loss_and_grads(model, params, batch, 1.0, lambda _: None)
        grads[remat] = (loss, g)
        del params
    (lb, gb), (ln, gn) = grads["block"], grads["none"]
    grad_err = max(grad_close(a, b, TRAIN_TOL)[0] for a, b in zip(gb, gn))
    grads_ok = all(grad_close(a, b, TRAIN_TOL)[1] for a, b in zip(gb, gn))
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(gb, gn))
    del grads, gb, gn
    torch.cuda.empty_cache()
    a, b = sides["block"], sides["none"]
    emit("dryrun_train", arch=cfg.name, batch=TRAIN_SYNC_BATCH,
         seq=TRAIN_SEQ, dtype=cfg.dtype, param_dtype="float32",
         hw=H100, nvidia_smi=smi, block=a, none=b,
         loss_block=float(lb), loss_none=float(ln),
         loss_bitwise=bool(torch.equal(lb, ln)), grad_max_err=grad_err,
         grad_tol=TRAIN_TOL, grads_bitwise=bitwise,
         remat_time_ratio=min(a["s_per_step"]) / min(b["s_per_step"]),
         remat_peak_ratio=a["measured_peak"] / b["measured_peak"],
         peak_rtol=DRYRUN_PEAK_RTOL, launches=launched)
    for remat, side in sides.items():
        if side["fake_flops"] != side["card_flops"]:
            raise AssertionError(f"dryrun_train: remat={remat}: the fake "
                                 f"count {side['fake_flops']} != the card's "
                                 f"{side['card_flops']}")
    if abs(a["peak_rel_err"]) > DRYRUN_PEAK_RTOL:
        raise AssertionError(f"dryrun_train: predicted peak "
                             f"{a['predicted_peak']} vs measured "
                             f"{a['measured_peak']}")
    if not (torch.equal(lb, ln) and grads_ok):
        raise AssertionError(f"dryrun_train: remat changes the loss "
                             f"({float(lb)!r} vs {float(ln)!r}) or the "
                             f"gradients (max error {grad_err})")
    if not all(launched.values()):
        raise AssertionError(f"dryrun_train: a kernel was not launched: "
                             f"{launched}")

    # (c) prefill and decode: the fake count against the card's
    model = build_model(cfg)
    params = model.init_serving(torch.Generator(device=dev).manual_seed(0))
    pre_batch = {"tokens": torch.zeros(PREFILL_BATCH, PREFILL_SEQ + 1,
                                       dtype=torch.int32, device=dev)}
    prompts = torch.zeros(SERVE_REQUESTS, 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        cache = model.decode_init(params, {"tokens": prompts},
                                  DRYRUN_DECODE_LEN)
        with FlopCounterMode(display=False) as fc:
            model.logits(params, pre_batch)
        card_prefill = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            model.decode_step(params, cache, prompts[:, 0])
        card_decode = fc.get_total_flops()
    del params, cache
    torch.cuda.empty_cache()
    with FakeTensorMode(), torch.inference_mode():
        fparams = model.init_serving(torch.Generator())
        _, f_pre = dryrun.count_call(model.logits, fparams, {
            "tokens": torch.zeros(PREFILL_BATCH, PREFILL_SEQ + 1,
                                  dtype=torch.int32)})
        ftok = torch.zeros(SERVE_REQUESTS, 1, dtype=torch.int32)
        fcache = model.decode_init(fparams, {"tokens": ftok},
                                   DRYRUN_DECODE_LEN)
        _, f_dec = dryrun.count_call(model.decode_step, fparams, fcache,
                                     ftok[:, 0])
    counts = dict(prefill=[f_pre.flops, card_prefill],
                  decode=[f_dec.flops, card_decode])
    emit("dryrun_serve", arch=cfg.name, prefill=[PREFILL_BATCH, PREFILL_SEQ],
         decode=[SERVE_REQUESTS, DRYRUN_DECODE_LEN], flops_fake_card=counts,
         prefill_bytes=f_pre.bytes, decode_bytes=f_dec.bytes,
         nvidia_smi=smi)
    if any(f != c for f, c in counts.values()):
        raise AssertionError(f"dryrun_serve: fake and card counts differ: "
                             f"{counts}")

    # (d) the production mesh, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             TRAIN_ARCH, "--shape", "train_4k", "--mesh", "single",
             "--out", tmp], capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT)
        mesh_s = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(("OK", "FAIL"))]
        path = Path(tmp) / f"{TRAIN_ARCH}__train_4k__single__sync.json"
        record = json.loads(path.read_text()) if path.exists() else None
    import importlib.util
    emit("dryrun_mesh", line=lines, seconds=mesh_s, rc=proc.returncode,
         torch=torch.__version__, fake_collectives_module=importlib.util.
         find_spec("torch.distributed._tools.fake_collectives") is not None,
         record={k: record[k] for k in ("mesh", "per_device_bytes",
                                        "flops_per_partition",
                                        "bytes_per_partition", "roofline",
                                        "probe")} if record else None,
         stderr=proc.stderr[-2000:] if proc.returncode else "")
    if proc.returncode != 0 or record is None:
        raise AssertionError("dryrun_mesh: the production-mesh dry run "
                             "failed")

    # (e) the operators' host cost a call
    gen = torch.Generator(device=dev).manual_seed(30)
    x = torch.randn(SERVE_REQUESTS, 1024, generator=gen, device=dev
                    ).to(torch.bfloat16)
    scale = torch.ones(1024, device=dev)
    q = torch.randn(1, 128, 2, 128, generator=gen, device=dev
                    ).to(torch.bfloat16)
    host = dryrun_host_us(x, scale, q, q[:, :, :1].contiguous(),
                          q[:, :, :1].contiguous())
    emit("dryrun_host", us_per_call=host, calls=DRYRUN_HOST_CALLS,
         rmsnorm_shape=list(x.shape), flash_shape=[1, 128, 2, 128],
         nvidia_smi=smi)
    del x, scale, q
    torch.cuda.empty_cache()

    # (f) remat on the other families' train paths
    families = remat_families(dev)
    return {k: launched.get(k, 0) + families[k] for k in families}


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
    from repro_torch.kernels import flash_attention as fa

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
                "hier_aggregate": ("hier_aggregate", ()),
                "rmsnorm": ("rmsnorm", ()),
                "flash_attention": ("flash_attention", ()),
                "flash_attention_bwd": ("flash_attention_bwd", ()),
                "flash_attention_bwd_counters": ("flash_attention_bwd",
                                                 ("FLASH_BWD_PROFILE",)),
                "ssd_state_scan": ("ssd_scan", ())}
    t0 = time.perf_counter()
    # the planted faults of phases 8 and 21b build beside them, into a
    # directory that goes once they are loaded
    with tempfile.TemporaryDirectory() as fault_dir, ThreadPoolExecutor(
            len(variants) + len(FLASH_FAULTS)
            + len(FLASH_BWD_FAULTS)) as pool:
        faults = {f: pool.submit(build_flash_fault, fault_dir, f)
                  for f in FLASH_FAULTS}
        bwd_faults = {f: pool.submit(build_flash_fault, fault_dir, f,
                                     "flash_attention_bwd")
                      for f in FLASH_BWD_FAULTS}
        built = dict(zip(variants, pool.map(
            lambda job: build.load(*job), variants.values())))
        fault_libs = {f: job.result() for f, job in faults.items()}
        bwd_fault_libs = {f: job.result() for f, job in bwd_faults.items()}
    build_s = time.perf_counter() - t0
    ptxas = {kname: ptxas_report(b.ptxas_log) for kname, b in built.items()}
    for kname, b in built.items():
        emit("build", kernel=kname, seconds=build_s, nvcc_seconds=b.seconds,
             library=str(b.path.relative_to(ROOT)), ptxas=ptxas[kname])

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
    err["groups_not_bitwise"] = groups_not_bitwise(got, want)
    k_ms = cuda_ms(lambda: golden_section.golden_section_solve(
        *main_in, **iters), reps=20)
    p_ms = cuda_ms(lambda: ref.golden_section_ref(*main_in, **iters),
                   reps=3)
    ops, nbytes, active = golden_section_work(masks, **iters)
    b_ms, b_by = bound_ms(ops, nbytes)
    emit("kernel", kernel="golden_section", shape=list(masks.shape),
         profile="default", ms=k_ms, plain_ms=p_ms, operations=ops,
         bytes=nbytes, active_slots=active,
         active_share=active / masks.numel(),
         paths=ref.golden_section_paths(masks), bound_ms=b_ms, bound_by=b_by,
         bound_share=b_ms / k_ms, library_ms=None,
         ptxas=ptxas["golden_section"], **err)
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
         groups_not_bitwise=groups_not_bitwise(got, want),
         ptxas=ptxas["golden_section_cbrtf"],
         max_rel_err_cost=float(((got[2] - want[2]).abs()
                                 / want[2].abs().clamp_min(1e-30)).max()))

    # off the main path's batch: fully active groups (a block of 512
    # threads each), 8 and 1001 of them; 64 groups of 20% active (one warp
    # each, 7 steps a lane); 64 groups, half 5% and half 30% active (both
    # kernels in one call)
    gen_m = torch.Generator(device=dev).manual_seed(5)

    def share(g_, p_):
        return torch.rand(g_, n, generator=gen_m, device=dev) < p_

    mixed = share(64, 0.3)
    mixed[::2] = share(32, 0.05)
    for case, m_, reps in (
            ("fully_active", torch.ones(8, n, dtype=torch.bool,
                                        device=dev), 5),
            ("fully_active", torch.ones(n + 1, n, dtype=torch.bool,
                                        device=dev), 2),
            ("share_20", share(64, 0.2), 5), ("mixed", mixed, 5)):
        x_in = [x[:m_.shape[0]].contiguous() for x in main_in[:7]] + [m_]
        got = golden_section.golden_section_solve(*x_in, **iters)
        torch.cuda.synchronize()
        want = ref.golden_section_ref(*x_in, **iters)
        err = check_pin(got, want, x_in[5], x_in[6], m_)
        emit("kernel", kernel="golden_section", case=case,
             shape=list(m_.shape), profile="default",
             paths=ref.golden_section_paths(m_),
             active_share=float(m_.float().mean()),
             ms=cuda_ms(lambda: golden_section.golden_section_solve(
                 *x_in, **iters), reps=reps),
             groups_not_bitwise=groups_not_bitwise(got, want), **err)
    del got, want, x_in

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
        emit("kernel", kernel="golden_section", case="ragged", shape=[g, r],
             profile=profile, paths=ref.golden_section_paths(rmask),
             groups_not_bitwise=groups_not_bitwise(got, want), **err)

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
    ms_per_move = 1e3 * eng.last_timing["moves_s"] / max(moves, 1)
    emit("main_path", n_devices=n, n_servers=k, moves=moves,
         first_cost=float(trace[0]), last_cost=float(trace[-1]),
         total_cost=res.total_cost, true_cost=res.true_cost,
         init_s=eng.last_timing["init_s"],
         ms_per_move=ms_per_move, kernel_ms_per_move=2 * main_kernel["ms"],
         kernel_share_of_move=2 * main_kernel["ms"] / ms_per_move,
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

    # ---- 4b. exchanges: the random start that evaluate_scheme("hfel")
    # runs, exchanges from phase 4's stable point, the exchange batch ----
    ex = exchange_path(dev, main_sc, res)
    ex_kernel = exchange_batch_kernel(dev, main_sc, res.assignment, iters,
                                      ptxas["golden_section"])

    # ---- 3c. hier_aggregate vs its plain version; the edge shape is the
    # largest group of phase 4's stable assignment ----
    group_sizes = np.bincount(res.assignment, minlength=k)
    n_params = 784 * 128 + 128 + 128 * 10 + 10     # the MLP at MNIST width
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = l2_flush(dev)
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
        splits, rows = ref.agg_splits(c_, p_)
        fields = dict(kernel="hier_aggregate", case=case, shape=[c_, p_],
                      dtype=tname, vector_width=hier_aggregate.vector_width(u),
                      splits=splits, rows_per_split=rows,
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
                bound_share=b_ms / k_ms, ptxas=ptxas["hier_aggregate"].get(
                    f"T=f32,V={hier_aggregate.vector_width(u)}"))
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

    # ---- 5b. exchanges card vs CPU; 5c. the §V.A schemes ----
    exchange_card_vs_cpu(dev)
    solvers_card_vs_cpu(dev)
    scheme_runs = schemes(dev)

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

    # ---- 16-20. association at scale and under churn, the live loop ----
    compact_run = compact_path(dev)
    scale = scale_path(dev)
    live = live_path(dev)
    live_big = live_scale(dev)
    compact_card_vs_cpu(dev)

    # ---- 28. the sharded sweep against phases 4, 4b, 17 and 18, and
    # Algorithm 1's collectives over spawned ranks ----
    sharded = sharded_path(dev, main_sc, res, ex, scale, live)
    collectives(dev)

    # ---- 8-11. serving: kernels, prefill and serve paths, card vs CPU ----
    serving = serving_kernels(dev, fault_libs, ptxas)
    serve_launches = serving_paths(dev)
    serve_card_vs_cpu(dev)

    # ---- 12-15. SSM and hybrid serving ----
    ssm = ssm_kernels(dev, ptxas["flash_attention"])
    ssm_launches = [ssm_prefill_path(dev, arch)
                    for arch in ("mamba2-1.3b", "zamba2-2.7b")]
    ssm_launches.append(ssm_serve_path(dev))
    for arch in ("mamba2-1.3b", "zamba2-2.7b"):   # 64 positions, 2 chunks
        serve_card_vs_cpu(dev, arch, n_tokens=65, phase="ssm_card_vs_cpu")

    def launched(kernel):
        return sum(run.get(kernel, 0) for run in ssm_launches)

    # ---- 21-24. LM training: gradients through the kernels ----
    fla_bwd = flash_bwd_kernels(
        dev, bwd_fault_libs, ptxas["flash_attention_bwd"],
        fa.bind_bwd(built["flash_attention_bwd_counters"].lib))
    bwd = backward_kernels(dev, fla_bwd["qwen3_layer"])
    train_card_vs_cpu(dev)
    train_lm = train_lm_path(dev)
    train_ssm = train_ssm_path(dev)

    # ---- 25. MoE + MLA serving: deepseek-v2-lite-16b ----
    torch.cuda.empty_cache()
    fla192 = mla_kernels(dev, fault_libs, ptxas["flash_attention"])
    rms2048 = moe_rmsnorm(dev, ptxas["rmsnorm"])
    moe_model, moe_params, moe_prefill = moe_prefill_path(dev)
    moe_serve = moe_serve_path(dev, moe_model, moe_params)
    del moe_model, moe_params
    torch.cuda.empty_cache()
    serve_card_vs_cpu(dev, MOE_ARCH, phase="moe_card_vs_cpu")
    serve_card_vs_cpu(dev, "kimi-k2-1t-a32b", phase="moe_card_vs_cpu")
    moe_decode_vs_prefill_f32(dev)
    moe_launches = {k: moe_prefill[k] + moe_serve[k]
                    for k in ("flash_attention", "rmsnorm")}

    # ---- 26. encoder-decoder and VLM serving: whisper-large-v3 and
    # internvl2-1b; flash at head dim 112 ----
    torch.cuda.empty_cache()
    ed_kernels = encdec_kernels(dev, fault_libs, ptxas)
    ed_model, ed_params, ed_prefill = encdec_prefill_path(dev)
    ed_serve = encdec_serve_path(dev, ed_model, ed_params)
    del ed_model, ed_params
    torch.cuda.empty_cache()
    vlm_model, vlm_params, vlm_prefill = vlm_prefill_path(dev)
    vlm_serve = vlm_serve_path(dev, vlm_model, vlm_params)
    del vlm_model, vlm_params
    torch.cuda.empty_cache()
    serve_card_vs_cpu(dev, ENCDEC_ARCH, phase="encdec_card_vs_cpu")
    serve_card_vs_cpu(dev, VLM_ARCH, phase="vlm_card_vs_cpu")
    ed_launches, vlm_launches = ({k: run[0][k] + run[1][k]
                                  for k in ("flash_attention", "rmsnorm")}
                                 for run in ((ed_prefill, ed_serve),
                                             (vlm_prefill, vlm_serve)))

    # ---- 27. training the MoE/MLA, encoder-decoder and VLM families ----
    train_kernels(dev)
    train_paths = dict(train_lm=train_lm, train_ssm=train_ssm,
                       train_moe=train_moe_path(dev),
                       train_encdec=train_encdec_path(dev),
                       train_vlm=train_vlm_path(dev))
    train_families_card_vs_cpu(dev)

    # ---- 29. the model zoo over a mesh of ranks on the one card ----
    mesh_launches = mesh_path(dev)

    # ---- 30. the dry run against the card's own step ----
    dryrun_path(dev)

    no_train = {name: 0 for name in train_paths}
    t_rms, t_fla, t_scan = (train_entry(k, bwd, train_paths)
                            for k in ("rmsnorm", "flash_attention",
                                      "ssd_state_scan"))

    cloud = agg["cloud"]
    rms, fla = serving["rmsnorm"], serving["flash_attention"]
    scan, fla80 = ssm["ssd_state_scan"], ssm["flash_attention_hd80"]
    print(json.dumps({"kernels": [
        dict(name="golden_section", route="cuda",
             source="src/repro_torch/kernels/csrc/golden_section.cu",
             replaces="src/repro/kernels/golden_section.py:169",
             launches=launches + ex["launches"],
             launches_by_path={"main_path": launches,
                               "exchange_path": ex["launches"],
                               "schemes_hfel": scheme_runs["hfel_launches"],
                               "compact_path": compact_run["launches"],
                               "scale_path_cold": scale["launches"],
                               "live_path":
                                   live["launches"]["golden_section"],
                               "live_scale":
                                   live_big["launches"]["golden_section"],
                               "sharded_path": sharded["total"],
                               **no_train},
             backward=None, library_ms=None, shape=list(masks.shape), **main_kernel,
             exchange_batch={key: ex_kernel[key] for key in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                 "groups_not_bitwise")},
             **{case: {key: scale[case][key] for key in (
                 "shape", "ms", "plain_ms", "max_abs_err", "bound_ms",
                 "bound_by", "groups_not_bitwise")}
                for case in ("bucket_refresh", "flat_exchange_batch")}),
        dict(name="hier_aggregate", route="cuda",
             source="src/repro_torch/kernels/csrc/hier_aggregate.cu",
             replaces="src/repro/kernels/hier_aggregate.py:35",
             launches=train_launches,
             launches_by_path={"train_path": train_launches,
                               "live_path":
                                   live["launches"]["hier_aggregate"],
                               "live_scale":
                                   live_big["launches"]["hier_aggregate"],
                               **no_train},
             backward=None, max_abs_err=cloud["max_abs_err"],
             ms=cloud["ms"], plain_ms=cloud["plain_ms"],
             bound_ms=cloud["bound_ms"], bound_by=cloud["bound_by"],
             library_ms=cloud["library_ms"], shape=cloud["shape"],
             **{case: {key: live[case][key] for key in (
                 "shape", "parked", "ms", "plain_ms", "max_abs_err",
                 "bound_ms", "bound_by", "library_ms", "bitwise")}
                for case in ("masked", "zero_edge")}),
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:39",
             launches=serve_launches["rmsnorm"] + launched("rmsnorm")
             + t_rms["kernel"] + moe_launches["rmsnorm"]
             + ed_launches["rmsnorm"] + vlm_launches["rmsnorm"]
             + mesh_launches["rmsnorm"],
             launches_by_path={"serving": serve_launches["rmsnorm"],
                               "ssm_serving": launched("rmsnorm"),
                               **t_rms["by_path"],
                               "moe_serving": moe_launches["rmsnorm"],
                               "encdec_serving": ed_launches["rmsnorm"],
                               "vlm_serving": vlm_launches["rmsnorm"],
                               "mesh_train": mesh_launches["rmsnorm"]},
             backward=t_rms["backward"],
             max_abs_err=rms["max_abs_err"], ms=rms["ms"],
             ms_cold_l2=rms["ms_cold_l2"],
             plain_ms=rms["plain_ms"], bound_ms=rms["bound_ms"],
             bound_by=rms["bound_by"], library_ms=rms["library_ms"],
             shape=rms["shape"], ptxas=rms["ptxas"],
             d2048={case: {key: f[key] for key in (
                 "shape", "held_vectors", "max_abs_err", "ms", "ms_cold_l2",
                 "plain_ms", "bound_ms", "bound_by", "library_ms", "ptxas")}
                 for case, f in rms2048.items()},
             d896={case: {key: f[key] for key in (
                 "shape", "held_vectors", "max_abs_err", "ms", "ms_cold_l2",
                 "plain_ms", "bound_ms", "bound_by", "library_ms", "ptxas")}
                 for case, f in ed_kernels["rmsnorm"].items()}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:103",
             launches=serve_launches["flash_attention"]
             + launched("flash_attention") + t_fla["kernel"]
             + moe_launches["flash_attention"]
             + ed_launches["flash_attention"]
             + vlm_launches["flash_attention"]
             + mesh_launches["flash_attention"],
             launches_by_path={"serving": serve_launches["flash_attention"],
                               "ssm_serving": launched("flash_attention"),
                               **t_fla["by_path"],
                               "moe_serving":
                                   moe_launches["flash_attention"],
                               "encdec_serving":
                                   ed_launches["flash_attention"],
                               "vlm_serving":
                                   vlm_launches["flash_attention"],
                               "mesh_train":
                                   mesh_launches["flash_attention"]},
             backward=t_fla["backward"],
             max_abs_err=fla["max_abs_err"], ms=fla["ms"],
             ms_cold_l2=fla["ms_cold_l2"], tflops=fla["tflops"],
             plain_ms=fla["plain_ms"], bound_ms=fla["bound_ms"],
             bound_by=fla["bound_by"], library_ms=fla["library_ms"],
             shape=fla["shape"], ptxas=fla["ptxas"],
             hd80={key: fla80[key] for key in (
                 "shape", "max_abs_err", "ms", "ms_cold_l2", "plain_ms",
                 "bound_ms", "bound_by", "library_ms", "tflops")},
             hd192={key: fla192[key] for key in (
                 "shape", "max_abs_err", "ms", "ms_cold_l2", "plain_ms",
                 "bound_ms", "bound_by", "bound_ms_v128", "library_ms",
                 "tflops", "ptxas", "ptxas_f32")},
             hd112={key: ed_kernels["flash"]["kimi_layer"][key] for key in (
                 "shape", "max_abs_err", "ms", "ms_cold_l2", "plain_ms",
                 "bound_ms", "bound_by", "library_ms", "tflops", "ptxas",
                 "ptxas_f32")},
             **{case: {key: ed_kernels["flash"][case][key] for key in (
                 "shape", "causal", "max_abs_err", "ms", "ms_cold_l2",
                 "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops")}
                for case in ("whisper_encoder", "whisper_cross",
                             "internvl2_layer")}),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/ops.py:38",
             launches=sum(t_fla["backward"]["kernel_launches"].values())
             + mesh_launches["flash_attention_bwd"],
             launches_by_path={
                 **t_fla["backward"]["kernel_launches"],
                 "mesh_train": mesh_launches["flash_attention_bwd"]},
             backward=None, **{key: fla_bwd["qwen3_layer"][key] for key in (
                 "shape", "max_abs_err", "ms", "plain_ms", "recompute_ms",
                 "bound_ms", "bound_by", "library_ms", "tflops",
                 "bitwise_repeatable", "ptxas")},
             **{case: {key: line.get(key) for key in (
                 "shape", "causal", "max_abs_err", "ms", "bound_ms",
                 "bound_by", "bound_ms_v_cols", "library_ms", "tflops")}
                for case, line in fla_bwd.items() if case != "qwen3_layer"}),
        dict(name="ssd_state_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:47",
             launches=launched("ssd_state_scan") + t_scan["kernel"],
             launches_by_path={"ssm_serving": launched("ssd_state_scan"),
                               **t_scan["by_path"]},
             backward=t_scan["backward"],
             max_abs_err=scan["max_abs_err"], ms=scan["ms"],
             plain_ms=scan["plain_ms"], bound_ms=scan["bound_ms"],
             bound_by=scan["bound_by"], library_ms=None,
             shape=scan["shape"])]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
