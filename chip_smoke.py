#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Card check: name and power limit, versions, float32 matrix products in
   full float32 (no TF32), and the build of the seven CUDA kernels and the
   empty launch probe (one ``nvcc`` per source, started together).
2. Charge sweep, kernel vs plain PyTorch version, on the full boot sweep
   (1,048,576 DIMMs × 4 bins), the JEDEC-corner cell, a 95 °C above-grid
   column, the worst-case stack (the boot stack with thresholds no
   candidate passes) and 100,003 mixed lanes (45 and 95 °C, worst-case and
   masked cells side by side): indices must be equal. Timed at the boot
   shape and on the worst-case stack beside their bounds, with the
   candidate evaluations the plain indices imply, warp by warp, and the
   invariant precompute's time.
3. Replay chunk, kernel vs plain, on 65,536 DIMMs at chunkings 1, 37, 256
   with error injections and a ladder of boundary temperatures, and at the
   main path's shapes: a full-width chunk (1,048,576 DIMMs × 256 steps)
   followed by the ragged 160-step chunk that ends a day, then the same on
   1,048,573 DIMMs (rows a 16-byte copy cannot take: the kernel's narrow
   copy path). State, occupancy, switches and timing sums must be bitwise
   equal. The emitting entry against the plain emit scan on the same
   inputs, at the same chunkings (rows also written 4 bytes past a 16-byte
   boundary at chunks 1 and 37) and at full width (the 256-step chunk,
   then the ragged one from its state): rows, bins, switch and fuse flags,
   state and partials bitwise, the carry also the non-emitting entry's.
   The full-width chunk is timed through both entries (the non-emitting
   one again after the emitting one), and trace-eval's launch (chunk 1
   × 65,536 DIMMs) as device time from ``torch.profiler``, each beside its
   bound; so are the full-width chunk's ingest steps and two ways of
   streaming chunks from pageable host memory: the engine's pinned double
   buffer and a plain ``tensor.to(device)``.
4. Serve: the fleet-controller service on a small fleet, card vs CPU (the
   plain versions) on the same table and trace; then the main path,
   ``serve_fleet.serve`` at 1,048,576 DIMMs × 1,440 steps (one day at one
   reading a minute), with every kernel's launch count read around it; its
   boot again, split into synthesis, invariants, kernel, the joint stack
   and table; then
   the same run under ``torch.profiler`` (trace in ``chiprun_out/``) for the
   device's busy share and where the loop's time goes. Then (4b) the same
   day with decisions (``serve(decisions=True)``, launches read around it):
   score and switch total equal to the day without, wall and the loop's
   peak device memory; a day through the service with and without
   decisions, state, partials and score equal, the last chunk's rows,
   bins and flags equal to ``controller.replay`` of its steps from the
   state before them; eight profiled days in turns (without, with, with,
   without, twice): the host's waits for the device equal in every day, the
   mean busy share with decisions no lower than without by more than twice
   the standard error of the difference.
5. Accumulate kernel vs plain at the trace-eval path's full width (65,536
   DIMMs × 10,000 steps of cycle-quantized rows, bins over every column,
   running partials to fold into) and on a ragged real history (4,096 DIMMs
   × 97 steps of a card replay with errors at 1e-3 and temperatures over
   every bin): 0 mismatching words. Timed at full width against its bound
   and beside ``torch.sum(timings, dim=0)`` alone.
6. Card replay and step vs plain step: ``controller.replay`` on the card
   (the emitting entry, one launch a ``REPLAY_CHUNK_STEPS`` steps) and
   ``controller.step`` (the emitting entry at chunk 1, every step) against a
   loop of ``controller.step_plain`` on the card, 65,536 DIMMs × 512 steps:
   timings, bins, switches, fuses and the final state bitwise equal.
7. Trace-eval, card vs CPU: ``trace_eval.run`` on 4,096 DIMMs × 500 steps
   (refresh_storm, errors at 1e-3) on the card and on the CPU with the same
   table, trace and errors: history and partials bitwise, every score
   figure within 1e-5.
8. Trace-eval main path: ``trace_eval.run`` at 65,536 DIMMs × 10,000 steps
   (one reading a minute for ~7 days), scenarios diurnal and refresh_storm,
   refresh ddr3, no errors, each with every kernel's launch count read
   around it (two replays of 10,000 steps and the 500-step sub-grid, each
   one launch a ``REPLAY_CHUNK_STEPS`` steps); then a 200-step window run
   one launch a step (the card's ``controller.step``) and through
   ``controller.replay``, each under ``torch.profiler`` for µs a step and
   the device's busy share; then ``controller.replay``'s launch size, the
   whole trace against 256 steps, timed in turns at 65,536 × 10,000.
9. Flash attention, kernel vs plain on every tile instantiated at the
   case's head width and nine cases — the LM serve shape (B 4, H 24, Hk 8,
   S 1,024, dh 128, causal), a long causal 8,192, a ragged 1,000, a
   512-token window, SmolLM's heads (H 9, Hk 3, dh 64), a non-causal
   ragged cross shape, and the three new head widths at their main paths'
   shapes: gemma3-4b's (dh 320, H 8 / Hk 4, S 2,048, window 1,024),
   recurrentgemma-9b's (dh 256, MQA 16 / 1, S 2,560, window 2,048) and
   hubert-xlarge's (dh 80, 16 / 16, 1,500 frames, non-causal), and
   kimi-k2-1t-a32b's (dh 112, 64 / 8, 2 × 256, causal) with a ragged
   non-causal dh 112 cross shape, and dh 16 at the reduced Kimi's heads
   (8 / 2, 4 × 1,024, causal; and a ragged 300 window):
   ``max|kernel - plain| <= 1e-5 * max|plain| + 1e-6``. Every tile timed at
   the serve shape, at altune's (B 8, S 4,096, H 32, Hk 8, dh 128,
   causal) and at the five cases of other widths (Kimi's dh 112 and the dh
   16 causal one besides the three above), each against its bound and beside
   ``scaled_dot_product_attention`` on KV heads repeated to H (the
   yardstick; a boolean mask for a window); the plain version at the serve
   shape.
10. LM serve, card vs CPU: reduced Llama-3.2-3B, gemma3-4b, chatglm3-6b,
   qwen2-vl-72b (embeddings and three M-RoPE position streams),
   recurrentgemma-9b, xlstm-125m, deepseek-moe-16b and kimi-k2-1t-a32b
   (dh 16) with the same weights and inputs, prefill and 8 teacher-forced
   decode steps, and hubert-xlarge's forward of embeddings (encoder-only):
   logits and caches within 1e-4, greedy ids equal wherever the CPU's
   top-2 gap exceeds 2e-4, one flash-attention launch per attention layer
   in the prefill (recurrentgemma 1 of 5, xlstm 0), none in decode. With
   experts every routing is compared too: a token routed to other experts
   on the card must be a near-tie on the CPU (its k-th and (k+1)-th
   probabilities within ``serve.FLIP_EPS``), and the rows after the first
   such flip are left out and counted.
11. LM serve main path: ``launch.serve.serve`` on Llama-3.2-3B at full
   width (28 layers, d_model 3,072, random weights from a seed), 4 prompts
   of 1,024 tokens, 32 new tokens: one flash-attention launch per layer in
   the prefill, none elsewhere; prefill ms, decode ms a token, peak device
   memory. Then one prefill and a few decode steps of the same model under
   ``torch.profiler`` for the device's busy share and where the time goes.
   (b) The same for gemma3-4b at full width and depth (34 layers, 4 ×
   2,048-token prompts; 34 flash-attention launches) and recurrentgemma-9b
   (38 layers, 2 × 2,560-token prompts, longer than its 2,048 window; 12
   launches), both profiled, and xlstm-125m (4 × 1,024 tokens, no
   attention); the RG-LRU doubling scan's and the sLSTM time loop's shares
   of a prefill (each call timed between synchronizations). (c)
   hubert-xlarge's encoder forward at full width (4 × 1,500 frames of
   embeddings, 48 launches, non-causal). (d) chatglm3-6b at full width,
   qwen2-vl-72b at 4 of its 80 layers and deepseek-moe-16b at 2 of its 28,
   card vs CPU as in phase 10 (weights drawn on the card and copied to the
   host), logits within 1e-4.
12. The altune kernels against their plain versions on every instantiated
   tile: the latency matmul at 4096³ float32 (timed beside ``torch.matmul``)
   and ragged (1000, 3000, 700) in float32 and bfloat16 (1,400-byte rows,
   the kernel's register path), within
   ``kernel.tolerance``; the RG-LRU scan at (8, 4096, 4096) float32 (timed)
   and ragged S and D in float32 and bfloat16, 0 mismatching words; flash
   decode at B 8, L 32,768, H 64, Hk 8, dh 128 with lengths 32,768 (timed
   beside ``scaled_dot_product_attention``), 1,000 and 1, and in bfloat16
   (timed, also beside SDPA), within ``kernel.tolerance``.
13. The tile gate against the card: for every instantiated tile of the four
   altune kernels (the float32 matmul's cp.async and register-path builds
   both), the cost model's verdict and its shared memory (static plus the
   dynamic amount the launcher requests; decode's in its operands' dtype)
   and threads against ``cudaFuncGetAttributes``; then an empty kernel's launch
   and per-block overheads (the cost model's constants).
14. The altune main path: ``launch.altune_margin.run`` on the card, every
   candidate validated and timed at the production shapes, with every
   kernel's launch count read around it; every worst-case tile must
   validate. The timing table goes to ``chiprun_out/``.
15. The profiling path: ``fleet.sweep`` of the serve boot's 1,048,576 DIMMs
   (seed 0) × 5 temperatures × 4 patterns, one charge-sweep launch, its
   wall time, peak device memory and 55 °C means beside the paper's (within
   its ±0.025 window); ``DimmTimingTable.profile`` equal to the sweep's
   table and a JSON round trip of 4,096 DIMMs of it; 65,536 DIMMs through
   the port on the card and on the CPU (the read and write stacks equal up
   to one-grid-step flips at a decision threshold — the CPU's search
   reaches the card's value under a perturbation of the cell of at most
   1e-6 — and the joint stack up to one-tCK flips at a cycle boundary, each
   counted and listed;
   ``summary()``, ``fig2_summary`` and ``repeatability`` on the same draws
   within 1e-6); the Fig. 3 speedup report, single- and multi-core, card
   within 1e-5 of CPU.
16. The region path: (a) ``fleet.sweep_regions`` of the serve boot's
   1,048,576 DIMMs × 5 temperatures × 4 patterns × 4 regions (83,886,080
   cells, one charge-sweep launch), cold and warm wall time, split by part,
   peak device memory, the kernel timed alone on its stack beside its
   bound; the anchor region bitwise equal to the card's ``fleet.sweep``,
   the region axis monotone; 65,536 DIMMs card vs CPU by the threshold rule
   of phase 15. (b) ``DimmTimingTable.profile(n_regions=4)`` of the same
   fleet at the serve bins: its max-over-regions registers bitwise equal to
   the region-free boot table, a 4,096-DIMM slice's v5 JSON both ways.
   (c) ``trace_eval.run`` at 65,536 DIMMs × 10,000 steps, ``design_skew``
   with 4 regions (near mix), ``ddr3`` refresh: the region rows, aware
   strictly above oblivious, the region section's time by part (sweep,
   table, mix, counts, finalize) and the counts' peak memory (no
   ``(S, N, B+1)`` one-hot). (d) ``replay_stream`` of the region table
   with a near mix, 65,536 DIMMs × 1,440 steps, chunk 256: the region
   counts equal to ``region_counts_accumulate`` of the materialized replay,
   the partials bitwise those of the mix-free stream, every chunk one
   launch of the emitting entry. Launches are read around (a)–(d).
18. The sharded path (run after 16, before the summary): (a) three gloo
   ranks sharing the card (``shard.launch(..., "cuda:0")``), once a probe
   of raw ``all_reduce`` SUM/MIN and ``all_gather_single`` on CUDA tensors
   shows gloo takes them with the right values (only gloo's own refusal
   leaves (a) out, with the reason logged; a wrong value fails the phase):
   at 4,099 DIMMs (3 does not divide it) and 2 (fewer than the ranks),
   ``fleet.sweep``, ``sweep_regions`` (4 regions), ``controller.replay``
   with errors at ``ERROR_RATE`` over 512 steps, ``trace_score``, a stream
   with decisions at chunkings 1, 37 and whole and a region stream, each
   with ``mesh=`` against the unsharded card call: map outputs bitwise,
   counts exact, score floats within 1e-5, the streamed sharded score
   bitwise the materialized one. (b) ``torch.cuda.device_count()`` NCCL
   ranks (one a card): ``serve_fleet.serve(sharded=True)`` at 1,048,576
   DIMMs × 1,440 steps, chunk 256 — score and switch total equal to
   phase 4's day (counts exact, floats within 1e-5) — and
   ``trace_eval.run(sharded=True)`` at 65,536 DIMMs × 10,000 steps
   (diurnal, ddr3) with its sharded replay bitwise; each rank's wall,
   finalize seconds and peak device memory; every kernel's launch counter
   read around both on each rank and summed.
19. The experts' main paths (run after 18, where the process holds least
   device memory; their card-vs-CPU checks are in phases 10 and 11d):
   deepseek-moe-16b served at full width and depth (4 × 1,024-token
   prompts, 32 new tokens, 28 flash-attention launches) and
   kimi-k2-1t-a32b at full width on its dense first layer and one MoE
   layer (2 × 256, 32 new, 2 launches at dh 112; 74.26 GiB of weights),
   each profiled as in phase 11, and each prefill split: the MoE layers'
   share, and the routed experts' router/top-k, sort and tables, gather,
   three batched products and scatter-add.
20. Training (run after 19, its weights freed): (a) one step of reduced
   smollm-135m, deepseek-moe-16b, recurrentgemma-9b and xlstm-125m at
   float32 compute, of smollm and deepseek-moe-16b at bfloat16, and of
   Llama-3.2-3B at full width on its first layer at float32, card vs
   CPU from the same state (``launch.train.compare_card_to_cpu``, within
   ``launch.train.STEP_TOL``; a routing flip only at a near-tie); (b)
   smollm-135m at full width and depth through ``launch.train.train``,
   50 steps of 8 × 1,024 tokens in 2 microbatches: the mean loss of the
   last 10 steps at least 0.5 below step 1's; the median step, tokens/s,
   6·N·D FLOP/s, peak memory, and one more step under ``torch.profiler``
   (busy share, host waits, launches) and the launches that bfloat16
   ``blocks.silu`` adds to it; (c) Llama-3.2-3B at full width and depth, 3
   steps of 2 × 1,024 (default ``TrainConfig``: bfloat16 compute, remat),
   step times and peak memory (≤ 79 GiB); (d) deepseek-moe-16b at full
   width on its dense first layer and two MoE layers, 3 steps of 4 ×
   1,024, step times, peak memory and a finite aux loss. Every kernel's
   count is read around (b)–(d) and must be 0: the training path runs no
   kernel of this repository.
21. Sharded training (run after 20, before the summary): (a) four gloo
   ranks sharing the card on a (2, 2) ``("data", "model")`` mesh under
   ``parallel.sharding.DEFAULT_RULES`` (TP, FSDP and, with experts, EP),
   once a probe shows gloo runs phase 18(a)'s collectives and DTensor's
   all-reduce, all-gather and reduce-scatter on CUDA tensors (a refusal, or
   a rank ended by one of them, is logged and leaves (a) out; torch
   2.11's gloo ended a rank in the all-gather): one float32 step each of reduced
   smollm-135m and reduced deepseek-moe-16b (8 experts over ``model`` =
   2: the expert-parallel branch) held against the one-rank step of the
   same state and batch (``sharded_step_vs_one_rank``, within
   ``STEP_TOL["float32"]``, a routing flip only at a near-tie); (b)
   ``torch.cuda.device_count()`` NCCL ranks, one a card, on the (1, 1)
   mesh of one card or the (2, 2) mesh of four: ``train(mesh=)`` with
   ``make_policy``'s placements, Llama-3.2-3B at full width and depth, 3
   steps of 2 × 1,024 at the default ``TrainConfig`` (step ms, tokens/s,
   each rank's peak memory over the call, the state's part-by-part
   placement included, and up to the end of the placement), on four cards
   also deepseek-moe-16b at full
   width on 3 layers (64 experts over ``model`` = 2); then one float32 step
   of Llama-3.2-3B at full width on its first 2 layers held against the
   unsharded step on rank 0's card. Every kernel's count is read around
   (a) and (b) on each rank and summed: the path runs none.
22. The cost model, the dry run and the step tuner (run after 21): (c)
   first, ``core.altune.steptuner.tune_train_cell`` for phase 20(c)'s cell
   (Llama-3.2-3B whole, 2 × 1,024, the default ``TrainConfig``) on one
   card at its budget, and its chosen candidate for 3 steps through
   ``train(cfg=)`` as 20(c) ran the baseline, from the same state and
   batches: the chosen one's measured peak within the budget and each loss
   within ``STEP_TOL["bfloat16"]`` of 20(c)'s; both step times printed;
   then (a) and (b) side by side, each ``launch.dryrun.run_cell`` in a
   process of its own on the host's CPU (a fake-tensor step of 16
   microbatches takes minutes of one CPU core; nothing of it touches the
   card), with nothing else running: (a) Llama-3.2-3B × train_4k on a fake
   (16, 16) process group: it must complete, and its per-rank state bytes
   from the local shards must equal ``analytic.tree_device_bytes`` of the
   same policy's specs over a ``MeshShape``; its record is printed; (b)
   20(c)'s cell on a (1, 1) mesh: its predicted peak (MemTracker) and the
   analytic memory model beside the peak 20(c) measured, and the roofline
   lower bound at the H100's constants beside 20(c)'s median step; a cell
   that the dry run says fits 79 GiB must run without running out of
   memory;
   (d) with four or more cards only (else its reason is printed):
   chatglm3-6b whole on a (2, 2) mesh under ``make_policy``, 3 steps of 4
   × 1,024 through ``train(mesh=)`` at the default ``TrainConfig`` (no
   card over 79 GiB, finite losses, the last below the first), its
   float32 step at full width on 2 layers against the unsharded one on
   one card, and reduced xlstm-125m's sharded step against one rank (both
   within ``STEP_TOL["float32"]``). Every kernel's count is
   read around (c) and (d): the path runs none. The phase's time is
   printed.
17. One JSON line describing each kernel (``launches_by_path`` with
   ``"sharded"``: phase 18(b)'s launches, ``"lm_serve/<arch>"``: phase
   11b–c's and 19's, ``"train"``: phase 20(b)–(d)'s,
   ``"sharded_train"``: phase 21's and ``"cost_model"``: phase 22's;
   flash attention's
   ``by_head_dim``: the timed cases of other widths); the card's name and
   power limit; the last line ``{"ok": true, "device": {...}}``.

A failing phase prints ``[chip_smoke] FAIL in phase <name>: <reason>`` on
both standard output and standard error and exits 1, also for an exception
outside the script's own checks (its traceback on standard error first).
Run alone, in a directory without the repository, the script stops so in
phase 0, where it imports the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FULL_DIMMS = 1 << 20
#: DIMMs taken off the full fleet for the replay check on rows that a
#: 16-byte copy cannot take.
UNALIGNED_CUT = 3
BOOT_BINS = (45.0, 55.0, 70.0, 85.0)
REPLAY_DIMMS = 65536
CHUNKINGS = (1, 37, 256)
ERROR_RATE = 1e-3
SERVE_STEPS = 1440
CHUNK = 256
RAGGED = SERVE_STEPS % CHUNK
INGEST_CHUNKS = 6
SMALL_DIMMS, SMALL_STEPS = 4096, 300
EVAL_DIMMS, EVAL_STEPS = 65536, 10_000
EVAL_SCENARIOS = ("diurnal", "refresh_storm")
EVAL_LOOP_STEPS = 500          # trace_eval.run's default observe-loop sub-grid
RAGGED_ACC_DIMMS, RAGGED_ACC_STEPS = 4096, 97
STEP_CHECK_STEPS = 512
PROFILED_STEPS = 200
EVAL_SMALL_DIMMS, EVAL_SMALL_STEPS = 4096, 500
#: Flash-attention checks: (name, B, Sq, Skv, H, Hk, dh, causal, window).
FA_CASES = (
    ("serve", 4, 1024, 1024, 24, 8, 128, True, 0),
    ("long causal", 1, 8192, 8192, 24, 8, 128, True, 0),
    ("ragged", 4, 1000, 1000, 24, 8, 128, True, 0),
    ("window 512", 2, 2048, 2048, 24, 8, 128, True, 512),
    ("smollm heads", 4, 1024, 1024, 9, 3, 64, True, 0),
    ("non-causal", 2, 1000, 777, 24, 8, 128, False, 0),
    ("gemma3 dh 320", 4, 2048, 2048, 8, 4, 320, True, 1024),
    ("recurrentgemma dh 256", 2, 2560, 2560, 16, 1, 256, True, 2048),
    ("hubert dh 80", 4, 1500, 1500, 16, 16, 80, False, 0),
    ("kimi dh 112", 2, 256, 256, 64, 8, 112, True, 0),
    ("dh 112 ragged", 2, 1000, 777, 64, 8, 112, False, 0),
    ("kimi reduced heads dh 16", 4, 1024, 1024, 8, 2, 16, True, 0),
    ("dh 16 ragged window", 2, 1000, 1000, 8, 2, 16, True, 300),
)
#: The FA_CASES timed at each head width other than 128 (gemma3-4b's,
#: recurrentgemma-9b's, hubert-xlarge's and kimi-k2-1t-a32b's main-path
#: shapes: the window shorter than the prompt, MQA, non-causal and ragged,
#: GQA 8; and the reduced Kimi's heads, dh 16, at 4 × 1,024): each tile timed
#: there beside the bound and SDPA.
FA_WIDE_TIMED = ("gemma3 dh 320", "recurrentgemma dh 256", "hubert dh 80", "kimi dh 112",
                 "kimi reduced heads dh 16")
#: Flash-attention timing shapes (B, S, H, Hk, dh), causal: the LM serve
#: path's prefill and altune's production shape.
FA_SERVE_SHAPE = (4, 1024, 24, 8, 128)
FA_ALTUNE_SHAPE = (8, 4096, 32, 8, 128)
LM_ARCH = "llama3.2-3b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1024, 32
LM_SMALL_BATCH, LM_SMALL_PROMPT, LM_SMALL_STEPS = 2, 40, 8
LM_TOL = 1e-4
LM_PROFILED_DECODE = 4
#: The LM families without experts beside Llama: each reduced config card
#: vs CPU (phase 10).
LM_FAMILIES = ("gemma3-4b", "chatglm3-6b", "qwen2-vl-72b", "hubert-xlarge",
               "recurrentgemma-9b", "xlstm-125m", "deepseek-moe-16b", "kimi-k2-1t-a32b")
#: Their full-width main paths (phase 11b): (arch, batch, prompt, new tokens,
#: profiled). The prompts outrun the local windows (1,024 and 2,048).
LM_FULL_PATHS = (("gemma3-4b", 4, 2048, 32, True), ("recurrentgemma-9b", 2, 2560, 32, True),
                 ("xlstm-125m", 4, 1024, 32, False))
#: hubert-xlarge's encoder forward at full width: 4 clips of 1,500 frames
#: (30 s at its 50 frames a second; no multiple of a tile).
HUBERT_BATCH, HUBERT_FRAMES = 4, 1500
#: Full-width card-vs-CPU checks (phase 11d, at ``LM_TOL`` as the reduced
#: ones): (arch, layers; None: all). qwen2-vl-72b (72.7e9 parameters, 291 GB
#: in float32) is cut to 4 layers, deepseek-moe-16b (61.0 GiB) to 2 (4.07 GiB).
LM_FULL_COMPARE = (("chatglm3-6b", None), ("qwen2-vl-72b", 4), ("deepseek-moe-16b", 2))
#: The experts' main paths (phase 19): (arch, batch, prompt, new tokens,
#: layers; None: all). deepseek-moe-16b whole (28 layers, 61.0 GiB);
#: kimi-k2-1t-a32b (3,827 GiB in float32) at its dense first layer and one
#: MoE layer (74.26 GiB).
MOE_FULL_PATHS = (("deepseek-moe-16b", 4, 1024, 32, None), ("kimi-k2-1t-a32b", 2, 256, 32, 2))
#: Phase 20 (training). (a) One step of each reduced config on the card and
#: on the CPU from the same state, at the compute dtype given; within
#: ``launch.train.STEP_TOL``.
TRAIN_COMPARE = (("smollm-135m", "float32"), ("deepseek-moe-16b", "float32"),
                 ("recurrentgemma-9b", "float32"), ("xlstm-125m", "float32"),
                 ("smollm-135m", "bfloat16"), ("deepseek-moe-16b", "bfloat16"))
#: ... and at full width, cut in depth: (arch, compute dtype, layers, batch,
#: sequence). Llama-3.2-3B's 128,256-entry untied head and its full-width
#: decay rule, on its first layer (0.89e9 parameters; phase 21(b) holds 2
#: layers against the card's own step).
TRAIN_COMPARE_FULL = (("llama3.2-3b", "float32", 1, 2, 64),)
#: (b) smollm-135m at full width and depth through ``launch.train.train``:
#: steps, batch, sequence, microbatches; the mean loss of the last
#: ``TRAIN_LAST`` steps must sit ``TRAIN_DROP`` below the first step's.
TRAIN_SMOLLM = (50, 8, 1024, 2)
TRAIN_LAST, TRAIN_DROP = 10, 0.5
#: (c, d) Full-width steps at the default ``TrainConfig`` (bfloat16 compute,
#: remat, the default schedule's first steps): (arch, steps, batch,
#: sequence, layers; None: all).
#: Llama-3.2-3B whole (3.61e9 parameters: 53.7 GiB of float32 parameters,
#: gradients and moments); deepseek-moe-16b on its dense first layer and two
#: MoE layers (1.68e9).
TRAIN_FULL = (("llama3.2-3b", 3, 2, 1024, None), ("deepseek-moe-16b", 3, 4, 1024, 3))
#: The card's memory a full-width training step may take at its peak.
TRAIN_PEAK_GIB = 79.0
#: Phase 21 (sharded training). (a) Gloo ranks sharing the card on this
#: ("data", "model") mesh under ``DEFAULT_RULES``: one float32 step of each
#: reduced (arch, microbatches, layers; None: all) at batch × sequence,
#: against the one-rank step.
SHARDED_TRAIN_MESH = (2, 2)
SHARDED_TRAIN_COMPARE = (("smollm-135m", 1, None), ("deepseek-moe-16b", 1, None))
SHARDED_TRAIN_BATCH, SHARDED_TRAIN_SEQ = 4, 16
#: ``train(mesh=)``'s runs held against one rank's: the reference's default
#: ``TrainConfig`` (its schedule's first rates, ~1e-7) at float32 compute
#: (these fields of it).
#: At a rate of 1e-3, AdamW's first step, g / (|g| + ε) an entry, turns
#: float32 sum-order differences of gradients near ε into steps of ~lr and
#: the losses part by ~1e-4 after it.
SHARDED_TRAIN_CONFIG = {"compute_dtype": "float32"}
#: (b) One NCCL rank a card, ``train(mesh=)`` at full width: (arch, steps,
#: batch, sequence, layers; None: all); the second entry on four cards only.
SHARDED_TRAIN_FULL = (("llama3.2-3b", 3, 2, 1024, None), ("deepseek-moe-16b", 3, 4, 1024, 3))
#: ... and one float32 step at full width against the unsharded step on
#: rank 0's card: (arch, layers, batch, sequence).
SHARDED_TRAIN_CHECK = ("llama3.2-3b", 2, 2, 64)
#: Phase 22. (a) The dry run at a production mesh: (arch, cell, the dry
#: run's ``--mesh``: "single", the (16, 16) pod).
DRYRUN_PRODUCTION = ("llama3.2-3b", "train_4k", "single")
#: (b, c) Phase 20(c)'s cell, ``TRAIN_FULL``'s first: the dry run on one
#: card's (1, 1) mesh, and the tuner's choice run as 20(c) ran the baseline.
COST_CELL = TRAIN_FULL[0]
#: (d) Four cards, a (2, 2) mesh: ``train(mesh=)`` of (arch, steps, batch,
#: sequence) whole, and reduced (arch, layers, batch, sequence)'s sharded
#: float32 step against one rank.
#: It trains at the reference's default ``TrainConfig``, whose warmup keeps
#: the first updates at ~1e-7: at a peak rate reached in one step
#: (``train()``'s own schedule for 3 steps), AdamW's first updates move
#: every one of the 6.2e9 parameters by the rate and the loss rose on four
#: cards (1e-3: 11.66, 10.57, 13.67; 1e-4: 11.66, 13.02, 22.38).
FOUR_CARD_TRAIN = ("chatglm3-6b", 3, 4, 1024)
FOUR_CARD_CHECK = ("xlstm-125m", 4, 4, 16)
#: ... and that arch's float32 step at full width on its first layers under
#: ``make_policy``'s rules against the unsharded step on rank 0's card:
#: (arch, layers, batch, sequence).
FOUR_CARD_FULL_CHECK = ("chatglm3-6b", 2, 2, 64)
#: The routed experts' parts, each timed in a prefill: (``models.moe``
#: function, part).
MOE_PARTS = (("_route", "router/top-k"), ("_tables", "sort and tables"),
             ("_gather", "gather"), ("_experts", "three batched products"),
             ("_combine", "scatter-add"))

#: Latency-matmul checks: (name, m, k, n, dtype); the first is timed.
MM_CASES = (("production", 4096, 4096, 4096, "float32"),
            ("ragged", 1000, 3000, 700, "float32"),
            ("ragged bf16", 1000, 3000, 700, "bfloat16"))
#: RG-LRU scan checks: (name, B, S, D, dtype); the first is timed.
SCAN_CASES = (("production", 8, 4096, 4096, "float32"),
              ("ragged", 3, 1001, 777, "float32"),
              ("ragged bf16", 3, 1001, 777, "bfloat16"))
#: Flash-decode checks: (name, B, L, H, Hk, dh, length, dtype); the first is timed.
FD_CASES = (("production", 8, 32768, 64, 8, 128, 32768, "float32"),
            ("length 1000", 8, 32768, 64, 8, 128, 1000, "float32"),
            ("length 1", 8, 32768, 64, 8, 128, 1, "float32"),
            ("bf16", 8, 32768, 64, 8, 128, 32768, "bfloat16"),
            ("bf16 rows on 8-byte boundaries", 8, 32768, 64, 8, 128, 30001, "bfloat16"))
#: Empty-kernel probe: launches timed back to back, and the blocks of the
#: many-block launch (8,192 a SM).
PROBE_LAUNCHES, PROBE_BLOCKS = 200, 132 * 8192

#: The profiling path's card-vs-CPU check: DIMMs, the repeatability trials,
#: the JSON round trip's table slice, and the tolerance of its means.
PROFILE_CHECK_DIMMS = 65536
REPEAT_TRIALS = 10
JSON_SLICE_DIMMS = 4096
MEAN_TOL = 1e-6
#: The Fig. 3 report, card against CPU (a 60-step float32 bisection each).
REPORT_TOL = 1e-5
#: The region path: regions profiled, the region stream's steps (a day) and
#: mix, and the most device memory the region counts of trace-eval's
#: history may take above their inputs (a one-hot of the bins would take
#: EVAL_STEPS × EVAL_DIMMS × 6 × 4 bytes, 15.7 GB).
REGIONS = 4
REGION_STREAM_STEPS = SERVE_STEPS
REGION_STREAM_MIX = "near"
REGION_COUNTS_PEAK_BYTES = 1 << 30
#: The paper's §1.5 means at 55 °C and the window the repository holds its
#: sweep to (``tests/test_fleet.py``); its memory-intensive Fig. 3 claim.
PAPER_55C = {"trcd": 0.173, "tras": 0.377, "twr": 0.548, "trp": 0.352}
PAPER_TOL = 0.025
PAPER_INTENSIVE = 0.140

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: Float operations per candidate a search of the charge sweep evaluates,
#: counted in csrc/charge_sweep.cu with expf and a division as one each, the
#: candidate's product included (SEARCH_NAMES order); a tRAS candidate where
#: the restore has not started costs SWEEP_OPS_LATCHED (product, two
#: subtractions, compare).
SWEEP_OPS_PER_EVALUATION = (6, 10, 7, 2, 10, 8, 2)
SWEEP_OPS_LATCHED = 4
#: The searches with an expf and a division, and of them the two tRAS
#: searches with a latched shortcut: (search, its sense-latch row).
SWEEP_CHARGE_SEARCHES = (0, 1, 2, 4, 5)
SWEEP_TRAS_SEARCHES = ((1, "t_sense_r"), (4, "t_sense_w"))
#: The charge sweep's worst-case stack: these invariant rows of the boot
#: stack overwritten so that every search walks its whole grid and none passes.
SWEEP_WORST_CASE = {"dv0_r": 0.0, "thr_rest": 2.0, "thr_trp": -1.0,
                    "thr_trcd_w": 1e9, "thr_trp_w": 1e9}
#: Cells of the charge sweep's mixed-lanes check (45 and 95 °C, worst-case and
#: masked lanes side by side; the last warp partial).
MIXED_CELLS = 100_003
#: Float operations per (DIMM, step) of the replay chunk: the guard-band add,
#: four edge compares, the hysteresis subtract and compare, eight sum adds.
REPLAY_OPS_PER_STEP = 15
#: Profiled launches of the replay chunk at chunk 1.
REPLAY_STEP_LAUNCHES = 200
#: Bytes a (DIMM, step) the replay chunk's emitting entry writes: the
#: realized row (8 float32), the effective bin (int32), the switch and fuse
#: flags (uint8 each).
EMIT_BYTES_PER_STEP = 8 * 4 + 4 + 1 + 1
#: ``controller.replay``'s launch sizes timed against each other at the
#: trace-eval width, in turns (``None``: the whole trace in one launch).
REPLAY_CHUNK_CHOICES = (None, 256)
#: Float operations per (step, DIMM) of the accumulation: eight sum adds.
ACCUMULATE_OPS_PER_STEP = 8
#: Float operations per unmasked (query, key) pair and head dim of attention:
#: a multiply-add in Q K^T and one in P V.
ATTENTION_OPS_PER_PAIR_DIM = 4


#: The joint stack's comparison rule: an entry may differ by exactly one tCK
#: from its reference where the reference's raw minimum lies within this
#: relative distance of a cycle boundary (``exp``/``log`` differ by an ulp
#: between torch and XLA, and between torch's CPU and CUDA builds).
JOINT_BOUNDARY_RTOL = 1e-5
TCK_NS = 1.25


def joint_mismatches(got, want, want_raw, rtol: float = JOINT_BOUNDARY_RTOL):
    """``(flips, bad)``: entries of the joint stack ``got`` exactly one tCK
    from ``want`` where ``want_raw / tCK`` lies within ``rtol`` (relative)
    of an integer, and every other entry that differs. Tensors or arrays."""
    import torch

    got, want, raw = ((x if isinstance(x, torch.Tensor) else torch.tensor(x)).cpu().double()
                      for x in (got, want, want_raw))
    differs = got != want
    cycles = raw / TCK_NS
    at_boundary = (cycles - cycles.round()).abs() <= rtol * cycles.abs()
    flip = differs & ((got - want).abs() == TCK_NS) & at_boundary
    return int(flip.sum()), int((differs & ~flip).sum())


#: The read and write stacks' comparison rule, card against CPU: an entry
#: may differ by exactly one grid step (one tCK) where the CPU's own search
#: reaches the card's value once the cell's r, c and leak are scaled by at
#: most this relative amount (each by 1 − δ, 1 or 1 + δ): the cell sits on a
#: decision threshold, within the rounding of the transcendentals.
SWEEP_BOUNDARY_RTOL = 1e-6


def sweep_mismatches(card, host, host_cells, rtol: float = SWEEP_BOUNDARY_RTOL) -> dict:
    """Entries of the card's read and write stacks that differ from the CPU's
    (``card``, ``host``: ``SweepResult`` or ``RegionSweepResult`` of the same
    fleet; ``host_cells`` its cells on the CPU): ``{stack: (flips, bad,
    details)}``, ``flips`` those one
    tCK apart that a perturbation of the cell by δ ≤ ``rtol`` (tried at
    ``rtol`` / 10, ``rtol`` · 0.3 and ``rtol``) moves the CPU's search onto,
    ``bad`` every other one, ``details`` a line each with the smallest δ that
    reproduces it."""
    import torch

    from repro_torch.core import charge
    from repro_torch.kernels.charge_sweep import ops

    signs = torch.cartesian_prod(*[torch.tensor([-1.0, 0.0, 1.0])] * 3)   # (27, 3)
    out = {}
    for s_i, name in enumerate(("read", "write")):
        got, want = getattr(card, name).cpu(), getattr(host, name)
        flips, bad, details = 0, 0, []
        for where in (got != want).nonzero().tolist():
            t_i, p_i, *r_i, n_i, col = where
            g, w = float(got[tuple(where)]), float(want[tuple(where)])
            at = None
            for delta in ((rtol / 10, rtol * 0.3, rtol) if abs(g - w) == TCK_NS else ()):
                cells = charge.CellParams(*(a[n_i] * (1.0 + delta * signs[:, j])
                                            for j, a in enumerate(host_cells)))
                eff = charge.apply_pattern(cells, host.patterns[p_i])
                if r_i:
                    eff = charge.apply_region(eff, host.region_fracs[r_i[0]])
                if bool((ops.sweep_min_timings(eff, host.temps_c[t_i])[s_i][:, col] == g).any()):
                    at = delta
                    break
            flips, bad = flips + (at is not None), bad + (at is None)
            region = f", region {r_i[0]}" if r_i else ""
            details.append(f"{name} {('trcd', 'tras', 'twr', 'trp')[col]} at "
                           f"{float(host.temps_c[t_i])} °C, pattern "
                           f"{float(host.patterns[p_i])}{region}, DIMM {n_i}: card {g} ns, "
                           f"CPU {w} ns, reproduced on the CPU at δ = {at}")
        out[name] = (flips, bad, details)
    return out


#: The sharded path's parity check: the temperature bins and patterns it
#: sweeps, its regions, and the tolerance of its score floats against the
#: single-device score (counts are held exactly).
SHARD_BINS = (45.0, 55.0, 70.0, 85.0)
SHARD_PATTERNS = (1.0, 1.03)
SHARD_REGIONS = 4
SHARD_SCORE_TOL = 1e-5
#: Phase 18(a): ranks sharing the one card over gloo, the fleet sizes (one
#: that 3 does not divide, one smaller than the mesh), steps and chunkings
#: (``None``: the whole trace in one chunk).
SHARD_GLOO_RANKS = 3
SHARD_GLOO_SIZES = (4099, 2)
SHARD_STEPS = 512
SHARD_CHUNKINGS = (1, 37, None)


def _mismatches(torch, a, b) -> int:
    """Words that differ between two tensors of one shape (float32 compared
    as bit patterns)."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _score_errors(got: dict, want: dict) -> tuple:
    """``(max float error relative to max(|want|, 1), integer mismatches)``
    of two score dicts; a missing or extra key is an integer mismatch."""
    ints = ("switches_total", "n_regions", "region_accesses_total")
    err, bad = 0.0, int(set(got) != set(want))
    for k in set(got) & set(want):
        if k in ints:
            bad += int(got[k] != want[k])
        else:
            err = max(err, abs(got[k] - want[k]) / max(abs(want[k]), 1.0))
    return err, bad


def shard_inputs(dev, n: int, steps: int, error_rate: float, seed: int = 0):
    """The parity check's inputs for one fleet size, from ``seed + n`` on
    ``dev``: a fleet, a ``(steps, n)`` trace of uniform temperatures over
    every bin, error injections at ``error_rate`` and a region-access mix
    of ``SHARD_REGIONS`` regions. Every rank draws the same whole inputs."""
    import torch

    from repro_torch.core import fleet

    gen = torch.Generator(device=dev).manual_seed(seed + n)
    fl = fleet.synthesize(gen, n, device=dev)
    trace = torch.rand((steps, n), generator=gen, device=dev) * 75.0 + 20.0
    errors = torch.rand((steps, n), generator=gen, device=dev) < error_rate
    mix = torch.randint(0, 16, (steps, n, SHARD_REGIONS), generator=gen, device=dev,
                        dtype=torch.int32)
    return fl, trace, errors, mix


def shard_parity(device: str, sizes, steps: int, chunkings, error_rate: float,
                 seed: int = 0, eval_kwargs=None, return_inputs: bool = False) -> dict:
    """Rank body of the sharded path's parity check (run it on the ranks of
    one process group, e.g. ``shard.launch(shard_parity, 4, "cpu", "cpu",
    ...)``; ``device`` is ``"cpu"`` or ``"cuda"``, the rank's own card).

    For each fleet size: the inputs of :func:`shard_inputs` on this rank's
    device; then the single-device port and the sharded port (``mesh=``) on
    the same inputs: ``fleet.sweep`` (read, write, joint stacks) and
    ``sweep_regions`` (``SHARD_REGIONS``), ``controller.replay`` with errors,
    ``trace_score`` with the ddr3 refresh policy, a stream with decisions at
    each chunking and the region stream. Map outputs are held bitwise: the
    gathered stacks whole, and this rank's block of the replay history,
    stream state, partials, decisions and region counts against the same
    columns of the single-device result (the replay's state and bins also
    gathered whole); the switch totals exactly; score floats within
    ``SHARD_SCORE_TOL``; the last chunking's streamed sharded score against
    the materialized sharded one bitwise (dict equality). With
    ``eval_kwargs``, also ``trace_eval.run(sharded=True)`` on them.

    Returns, on every rank, ``{size: {check: mismatches summed over ranks
    (largest error for ``*_err``), ...}}`` with the sharded scores under
    ``"score"`` and ``"region_score"`` and, with ``return_inputs``, the
    fleet's cells, the trace and the errors under ``"inputs"`` and the
    sharded sweep's stacks and the sharded replay's history and final state,
    gathered whole, under ``"sharded"`` (host tensors); the sharded trace-eval's rows under ``"eval_rows"``; the
    rank's loaded modules of JAX or the JAX package under
    ``"foreign_modules"`` (none); on cards the kernels' launches summed
    over ranks under ``"launches"``. Imports no JAX: spawned ranks import
    this module."""
    import torch

    from repro_torch.core import controller, fleet, perfmodel, shard, stream
    from repro_torch.core import refresh as rf

    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device("cpu"))
    mesh = shard.fleet_mesh(device=dev)
    out = {}
    for n in sizes:
        lo, hi = shard.local_range(n, mesh)
        fl, trace, errors, mix = shard_inputs(dev, n, steps, error_rate, seed)
        trace_h, errors_h = trace.cpu(), errors.cpu()
        m = {}

        one = fleet.sweep(fl, SHARD_BINS, SHARD_PATTERNS)
        got = fleet.sweep(fl, SHARD_BINS, SHARD_PATTERNS, mesh=mesh)
        m["sweep"] = sum(_mismatches(torch, getattr(got, k), getattr(one, k))
                         for k in ("read", "write", "joint"))
        one_r = fleet.sweep_regions(fl, SHARD_BINS, (1.0,), n_regions=SHARD_REGIONS)
        got_r = fleet.sweep_regions(fl, SHARD_BINS, (1.0,), n_regions=SHARD_REGIONS,
                                    mesh=mesh)
        m["sweep_regions"] = sum(_mismatches(torch, getattr(got_r, k), getattr(one_r, k))
                                 for k in ("read", "write"))
        table = controller.DimmTimingTable.from_fleet(got, refresh=rf.DDR3_EXTENDED)
        rtable = got_r.to_table()

        rep1 = controller.replay(table, trace, errors)
        rep = controller.replay(table, trace, errors, mesh=mesh)
        m["replay"] = sum(_mismatches(torch, getattr(rep, k), getattr(rep1, k)[:, lo:hi])
                          for k in ("timings", "bin_idx", "switched", "fused"))
        m["replay_state"] = sum(_mismatches(torch, a, b[lo:hi])
                                for a, b in zip(rep.state, rep1.state))
        m["replay_gathered"] = sum(
            _mismatches(torch, shard.gather_dimm(a, mesh, n, axis), b)
            for a, b, axis in ((rep.bin_idx, rep1.bin_idx, 1), (rep.switched, rep1.switched, 1),
                               (rep.state.fused, rep1.state.fused, 0)))
        score1 = perfmodel.trace_score(table.stack, rep1, refresh=table.bin_refresh())
        score = perfmodel.trace_score(table.stack, rep, refresh=table.bin_refresh(), mesh=mesh)
        m["score_err"], m["score_int"] = _score_errors(score, score1)
        m["switch_total"] = abs(int(score["switches_total"]) - rep1.total_switches)

        for c in chunkings:
            c_steps = steps if c is None else c
            single = stream.StreamingController(table)
            engine = stream.StreamingController(table, mesh=mesh)
            decs = []
            for temps_c, errs_c in stream.iter_chunks(trace_h, errors_h, c_steps):
                single.ingest(temps_c, errs_c)
                decs.append(engine.ingest(temps_c, errs_c, return_decisions=True))
            key = f"stream_{'whole' if c is None else c}"
            m[key] = sum(_mismatches(torch, a, b[lo:hi]) for a, b in
                         zip((*engine.state, *engine.partials[:3]),
                             (*single.state, *single.partials[:3])))
            m[key + "_decisions"] = sum(
                _mismatches(torch, torch.cat([d[i] for d in decs]), full[:, lo:hi])
                for i, full in enumerate((rep1.timings, rep1.bin_idx, rep1.switched)))
            m[key + "_switch_total"] = abs(int(engine.total_switches) - rep1.total_switches)
        # The streamed sharded score of the last chunking (the partials of
        # every chunking are held above; the finalize is one function of them).
        m["stream_score_vs_materialized"] = int(engine.score() != score)

        c_reg = steps if chunkings[-1] is None else chunkings[-1]
        reg1 = stream.replay_stream(rtable, trace_h, errors_h, chunk_steps=c_reg,
                                    region_mix=mix)
        reg = stream.replay_stream(rtable, trace_h, errors_h, chunk_steps=c_reg,
                                   region_mix=mix, mesh=mesh)
        m["region_counts"] = _mismatches(torch, reg.region_counts, reg1.region_counts[lo:hi])
        m["region_partials"] = sum(_mismatches(torch, a, b[lo:hi]) for a, b in
                                   zip(reg.partials[:3], reg1.partials[:3]))
        region_score = reg.region_score()
        m["region_score_err"], m["region_score_int"] = _score_errors(region_score,
                                                                     reg1.region_score())

        counts = torch.tensor([v for k, v in m.items() if not k.endswith("_err")],
                              dtype=torch.int64, device=dev)
        errs = torch.tensor([v for k, v in m.items() if k.endswith("_err")],
                            dtype=torch.float64, device=dev)
        counts, errs = shard.psum(counts, mesh).tolist(), shard.pmax(errs, mesh).tolist()
        ints = iter(counts)
        floats = iter(errs)
        out[n] = {k: next(floats) if k.endswith("_err") else next(ints) for k in m}
        out[n].update(score=score, region_score=region_score)
        if return_inputs:
            out[n]["inputs"] = {"cells": tuple(a.cpu() for a in fl.cells), "trace": trace_h,
                                "errors": errors_h}
            out[n]["sharded"] = {
                **{k: getattr(got, k).cpu() for k in ("read", "write", "joint")},
                **{k: shard.gather_dimm(getattr(rep, k), mesh, n, 1).cpu()
                   for k in ("timings", "bin_idx", "switched", "fused")},
                "state": tuple(shard.gather_dimm(a, mesh, n).cpu() for a in rep.state)}
    if eval_kwargs is not None:
        from repro_torch.launch import trace_eval

        out["eval_rows"] = trace_eval.run(**eval_kwargs, device=dev, sharded=True,
                                          verbose=False)["rows"]
    out["foreign_modules"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if dev.type == "cuda":
        from repro_torch.kernels.charge_sweep import kernel as sweep_k
        from repro_torch.kernels.replay_step import kernel as replay_k

        fns = (sweep_k.charge_sweep_cuda, replay_k.replay_chunk_cuda, replay_k.accumulate_cuda)
        launches = shard.psum(torch.tensor([f.launches for f in fns], device=dev), mesh)
        out["launches"] = dict(zip(("charge_sweep", "replay_chunk", "accumulate"),
                                   launches.tolist()))
    return out


#: What gloo says when it refuses a CUDA tensor: the one outcome of the
#: probe that leaves phase 18(a) out.
GLOO_REFUSAL = re.compile(r"unsupported|not supported|no support|does not support", re.I)


def gloo_cuda_probe() -> Optional[str]:
    """Rank body: whether this torch build's gloo takes CUDA tensors for the
    collectives the sharded path uses, called raw on the default group:
    ``all_reduce`` SUM (int64, float64) and MIN (float32) and
    ``all_gather_single`` (int32). Returns ``None`` where it does, and the
    backend's own refusal (a message ``GLOO_REFUSAL`` matches) where it
    refuses one. A wrong value or any other exception raises, and fails the
    caller: only the refusal leaves 18(a) out."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    total = torch.tensor([rank], dtype=torch.int64, device=dev)
    fsum = torch.tensor([0.5 * rank], dtype=torch.float64, device=dev)
    low = torch.tensor([float(rank) + 1.0], device=dev)
    mine = torch.full((1, 2), rank, dtype=torch.int32, device=dev)
    gathered = torch.empty((world, 2), dtype=torch.int32, device=dev)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    calls = (("all_reduce SUM int64", lambda: dist.all_reduce(total)),
             ("all_reduce SUM float64", lambda: dist.all_reduce(fsum)),
             ("all_reduce MIN float32", lambda: dist.all_reduce(low, op=dist.ReduceOp.MIN)),
             ("all_gather_single int32", lambda: gather(gathered, mine)))
    for name, call in calls:
        try:
            call()
        except (RuntimeError, NotImplementedError) as e:
            if not GLOO_REFUSAL.search(str(e)):
                raise
            return f"{name}: {type(e).__name__}: {str(e).strip().splitlines()[-1][:300]}"
    want = torch.arange(world, dtype=torch.int32)[:, None].expand(world, 2)
    if not (int(total) == world * (world - 1) // 2
            and float(fsum) == 0.25 * world * (world - 1) and float(low) == 1.0
            and torch.equal(gathered.cpu(), want)):
        raise AssertionError(
            f"gloo collectives on CUDA tensors returned wrong values on rank {rank}: sum "
            f"{int(total)}, float sum {float(fsum)}, min {float(low)}, gathered "
            f"{gathered.cpu().tolist()}")
    return None


def kernel_counters() -> dict:
    """Each kernel's launching wrapper by name; its ``launches`` attribute
    counts this process's launches."""
    from repro_torch.kernels.charge_sweep import kernel as sweep_k
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_decode import kernel as fd_k
    from repro_torch.kernels.latency_matmul import kernel as mm_k
    from repro_torch.kernels.replay_step import kernel as replay_k
    from repro_torch.kernels.rglru_scan import kernel as sc_k

    return {"charge_sweep": sweep_k.charge_sweep_cuda,
            "replay_chunk": replay_k.replay_chunk_cuda,
            "accumulate": replay_k.accumulate_cuda,
            "flash_attention": fa_k.flash_attention_cuda,
            "latency_matmul": mm_k.matmul_cuda,
            "rglru_scan": sc_k.rglru_scan_cuda,
            "flash_decode": fd_k.flash_decode_cuda}


def _summed_launches(torch, counters: dict, dev) -> dict:
    """The counters' launches summed over the default process group."""
    import torch.distributed as dist

    total = torch.tensor([fn.launches for fn in counters.values()], dtype=torch.int64,
                         device=dev)
    dist.all_reduce(total)
    return dict(zip(counters, total.tolist()))


@contextlib.contextmanager
def data_shards(n: int):
    """Within the block, ``moe.moe_forward`` without a policy splits the
    batch rows into ``n`` equal groups and dispatches each alone (capacity
    from its own tokens), the load-balance losses averaged: what the
    expert-parallel branch computes on a mesh whose batch axes have ``n``
    shards, on one device. The one-rank oracle of a sharded step: it wraps
    ``moe._local_dispatch`` for the block and puts it back after."""
    import torch

    from repro_torch.models import moe

    whole = moe._local_dispatch

    def grouped(p, x, cfg, e_lo, e_count, w):
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows in {n} data shards")
        parts = [whole(p, xs, cfg, e_lo, e_count, w) for xs in x.chunk(n, dim=0)]
        y = torch.cat([yp for yp, _ in parts], dim=0)
        return y, torch.stack([a for _, a in parts]).mean()

    moe._local_dispatch = grouped if n > 1 else whole
    try:
        yield
    finally:
        moe._local_dispatch = whole


def sharded_step_vs_one_rank(arch: str, shape=(2, 2), axes=("data", "model"),
                             device: str = "cpu", compute_dtype: str = "float32",
                             batch: int = 4, seq: int = 16, microbatches: int = 1,
                             reduced: bool = True, n_layers: Optional[int] = None,
                             seed: int = 0, rules: Optional[dict] = None) -> dict:
    """Rank body of phases 21(a) and (b) and of the CPU tests (every rank of
    a process group of ``prod(shape)`` calls it): one training step of ``arch`` on a ``shape`` mesh of ``axes``
    under ``rules`` (default ``DEFAULT_RULES``: TP, FSDP and, with experts,
    EP), held against the one-rank step of the same state and batch on
    rank 0's device. The state is drawn from ``seed`` on the device (on
    every rank alike), the batch is step 0 of the data pipeline's global
    batch, the schedule ``launch.train.compare_card_to_cpu``'s. With
    experts the one-rank step runs under :func:`data_shards` of the mesh's
    batch shards — the expert-parallel branch's capacity and load-balance loss
    are each data shard's, as the reference's ``shard_map`` — and each
    rank's routings are compared with its shard's. Returns, on every rank,
    ``compare_card_to_cpu``'s keys (``launch.train.within_tolerance``
    applies) and
    the sharded step's ``step_ms`` and each rank's ``peak_device_bytes``
    (None on the CPU)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.data.pipeline import DataConfig, batch_for_step, shard_batch, to_device
    from repro_torch.launch.mesh import auto_mesh
    from repro_torch.launch.train import _compare_config, _rel, _route_flips, placed_state
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import DEFAULT_RULES, ShardingPolicy, use_policy
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import leaves

    dev = (torch.device("cuda", torch.cuda.current_device()) if device.startswith("cuda")
           else torch.device(device))
    mesh = auto_mesh(shape, axes, dev)
    rank = dist.get_rank()
    cfg, tc = _compare_config(arch, compute_dtype, reduced, n_layers, microbatches)
    pol = ShardingPolicy(mesh, dict(rules or DEFAULT_RULES))
    np_batch = batch_for_step(cfg, DataConfig(seq_len=seq, global_batch=batch), 0,
                              process=(0, 1))
    b_pl = pol.placements(pol.fit(np_batch["labels"].shape, ("batch", None)))
    groups = math.prod(mesh.size(i) for i, p in enumerate(b_pl) if isinstance(p, Shard))
    group = sum(mesh.get_local_rank(i) * math.prod(
        mesh.size(j) for j in range(i + 1, mesh.ndim) if isinstance(b_pl[j], Shard))
        for i, p in enumerate(b_pl) if isinstance(p, Shard))
    step = make_train_step(cfg, tc)
    one = None
    if rank == 0:
        p1, o1 = init_train_state(torch.Generator(device=dev).manual_seed(seed), cfg, tc)
        before = [t.clone() for t in leaves(p1)]
        with moe.recording_routes() as r1, data_shards(groups if cfg.moe else 1):
            p1, o1, m1 = step(p1, o1, to_device(np_batch, dev))
        one = (p1, o1, m1, before, r1)
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    params, opt = placed_state(torch.Generator(device=dev).manual_seed(seed), cfg, tc, pol)
    data = shard_batch(np_batch, pol, dev)
    t0 = time.perf_counter()
    with use_policy(pol), moe.recording_routes() as rs:
        params, opt, ms = step(params, opt, data)
    loss = float(ms["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    peaks = [None] * mesh.size()
    dist.all_gather_object(peaks, peak)
    routes = [None] * mesh.size()
    dist.all_gather_object(routes, (group, [(i.cpu(), p.detach().cpu()) for i, p in rs]))
    # Every rank gathers each leaf (a collective); rank 0 compares.
    num = {"params": [0.0, 0.0], "update": [0.0, 0.0]}
    moments = []
    if rank == 0:
        ones = list(zip(leaves(one[0]), leaves(one[1]["m"]), one[3]))
    for i, (p, m) in enumerate(zip(leaves(params), leaves(opt["m"]))):
        p, m = p.full_tensor(), m.full_tensor()
        if rank == 0:
            p1, m1_, b0 = ones[i]
            for key, a, b in (("params", p, p1), ("update", p.double() - b0.double(),
                                                    p1.double() - b0.double())):
                a, b = a.double(), b.double()
                num[key][0] += float(torch.sum((a - b) ** 2))
                num[key][1] += float(torch.sum(b * b))
            moments.append((_rel([(m, m1_)]), i))
        del p, m
    out = None
    if rank == 0:
        m1 = one[2]
        out = {"loss": loss, "loss_err": _rel([(ms["loss"], m1["loss"])]),
               "grad_norm_err": _rel([(ms["grad_norm"], m1["grad_norm"])]),
               "skipped": float(ms["skipped"]) + float(m1["skipped"]),
               "moe_calls": len(one[4]), "route_flips": 0, "flips_not_near_tie": 0,
               "max_flip_gap": 0.0}
        one_routes = one[4]
        for g, rr in routes:  # the one-rank step's calls: layer by layer, group by group
            _route_flips(out, rr, one_routes[g::groups], cfg, compute_dtype)
        out["compared"] = out["route_flips"] == 0
        for key, (a, b) in num.items():
            out[key] = math.sqrt(a) / max(math.sqrt(b), 1e-300)
        out["moments"], out["moments_leaf"] = max(moments)
        out.update(step_ms=step_ms, peak_device_bytes=peaks, mesh=list(shape),
                   batch_groups=groups)
    obj = [out]
    dist.broadcast_object_list(obj, src=0)
    return obj[0]


#: The error-fuse check of :func:`fuse_restore`: reduced smollm-135m cut to
#: one layer, this many steps with a checkpoint after each, the parameters
#: poisoned (NaN) before step ``FUSE_STEP``, and rank 0's write of the
#: checkpoint pending then (``step_<FUSE_STEP>``) held back
#: ``FUSE_WRITE_DELAY_S`` seconds, several steps' time (a rank that read
#: without waiting for it would find the step before).
FUSE_STEPS, FUSE_STEP, FUSE_WRITE_DELAY_S = 3, 2, 1.0


def fuse_restore(dev, ckpt_dir: str, batch: int, seq: int) -> dict:
    """Rank body: ``train(mesh=)`` on a ``SHARDED_TRAIN_MESH`` mesh with a
    ``save_async`` after every step, rank 0's last write slowed, and a
    non-finite step at ``FUSE_STEP``: the error fuse restores the latest
    checkpoint on every rank. Returns the skipped steps, the step each
    rank restored, the leaves whose gathered values after the restore
    differ from that step's files, and the losses."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.mesh import auto_mesh
    from repro_torch.train.step import TrainConfig
    from repro_torch.tree import leaves, walk

    real_step, real_restore, real_write = (lm_train.make_train_step, ckpt.restore,
                                           ckpt._write)
    restored = []

    def make_step(cfg, tc):
        step_fn, calls = real_step(cfg, tc), [0]

        def poisoned(params, opt, data):
            calls[0] += 1
            if calls[0] == FUSE_STEP + 1:
                with torch.no_grad():
                    next(iter(leaves(params))).to_local().fill_(float("nan"))
            return step_fn(params, opt, data)

        return poisoned

    def restore(ckpt_dir_, state, step=None, **kw):
        got, at = real_restore(ckpt_dir_, state, step=step, **kw)
        cdir = os.path.join(ckpt_dir_, f"step_{at:010d}")
        bad = 0
        for path, t in walk(got["params"]):
            whole = t.full_tensor().cpu()
            name = "__".join(map(str, ("params",) + path)) + ".npy"
            bad += not np.array_equal(whole.numpy(), np.load(os.path.join(cdir, name)))
        restored.append((at, bad))
        return got, at

    def slow_write(ckpt_dir_, step, *a, **kw):
        if step == FUSE_STEP:
            time.sleep(FUSE_WRITE_DELAY_S)
        return real_write(ckpt_dir_, step, *a, **kw)

    lm_train.make_train_step, ckpt.restore = make_step, restore
    if dist.get_rank() == 0:
        ckpt._write = slow_write
    try:
        _, _, losses, rep = lm_train.train(
            "smollm-135m", steps=FUSE_STEPS, batch=batch, seq=seq, device=dev, n_layers=1,
            ckpt_dir=ckpt_dir, ckpt_every=1, log_every=FUSE_STEPS, return_report=True,
            train_config=TrainConfig(**SHARDED_TRAIN_CONFIG),
            mesh=auto_mesh(SHARDED_TRAIN_MESH, ("data", "model"), dev))
    finally:
        lm_train.make_train_step, ckpt.restore, ckpt._write = (real_step, real_restore,
                                                               real_write)
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, (restored, losses))
    return {"skipped": rep["skipped"], "restored_by_rank": [r for r, _ in by_rank],
            "losses_by_rank": [x for _, x in by_rank]}


def escaped_leaf(dev, batch: int, seq: int) -> str:
    """Rank body: a train step under a ``SHARDED_TRAIN_MESH`` policy whose
    batch was left plain (never placed). Returns the ``TypeError`` it
    raises; no error fails the caller."""
    import torch

    import repro_torch.configs as lm_configs
    from repro_torch.data.pipeline import DataConfig, batch_for_step, to_device
    from repro_torch.launch.mesh import auto_mesh
    from repro_torch.launch.train import placed_state
    from repro_torch.parallel import sharding
    from repro_torch.train.step import TrainConfig, make_train_step

    cfg = dataclasses.replace(lm_configs.reduced("smollm-135m"), n_layers=1)
    tc = TrainConfig(**SHARDED_TRAIN_CONFIG)
    pol = sharding.ShardingPolicy(auto_mesh(SHARDED_TRAIN_MESH, ("data", "model"), dev),
                                  dict(sharding.DEFAULT_RULES))
    params, opt = placed_state(torch.Generator(device=dev).manual_seed(0), cfg, tc, pol)
    data = to_device(batch_for_step(cfg, DataConfig(seq_len=seq, global_batch=batch), 0), dev)
    try:
        with sharding.use_policy(pol):
            make_train_step(cfg, tc)(params, opt, data)
    except TypeError as e:
        return str(e)
    raise AssertionError("a train step under a policy took a plain batch leaf")


def sharded_train_parity(device: str, cases, batch: int, seq: int, train_case=None,
                         ckpt_dir: Optional[str] = None, ep: Optional[dict] = None,
                         fuse_dir: Optional[str] = None) -> dict:
    """Rank body of phase 21(a) and of the CPU tests (four ranks, gloo):
    with the kernels' counters set to 0, for each (arch, microbatches,
    layers) of ``cases`` one float32 step on a ``SHARDED_TRAIN_MESH`` mesh
    under ``DEFAULT_RULES`` against the one-rank step
    (``sharded_step_vs_one_rank``); with ``train_case`` (arch,
    steps, layers), ``train(mesh=)``'s losses at ``SHARDED_TRAIN_CONFIG``; with ``ckpt_dir``, reduced smollm-135m's parameters saved
    under (2, 2) and restored under (4, 1) and (1, 4) (``restore(
    shardings=)``): mismatching leaves and wrong placements counted; with
    ``ep`` (numpy ``params`` of a reduced deepseek-moe-16b MoE layer and
    ``x`` (B, S, d)), ``moe.moe_forward`` under the (2, 2) policy: the
    gathered output and aux loss; with ``fuse_dir``, :func:`fuse_restore`
    in it and :func:`escaped_leaf`. Returns the results and the kernels'
    launches summed over the ranks (``device``: "cpu", or "cuda" for the
    card each rank selected)."""
    import torch

    import repro_torch.configs as lm_configs
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.mesh import auto_mesh
    from repro_torch.models import model as lm
    from repro_torch.models import moe
    from repro_torch.parallel import sharding
    from repro_torch.train.step import TrainConfig
    from repro_torch.tree import leaves, walk

    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device(device))
    axes = ("data", "model")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    out = {"compare": {}}
    out["seconds"] = {}
    for arch, micro, layers in cases:
        t0 = time.perf_counter()
        out["compare"][arch] = sharded_step_vs_one_rank(
            arch, SHARDED_TRAIN_MESH, axes, device, "float32", batch, seq, micro,
            n_layers=layers)
        out["seconds"][arch] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if train_case is not None:
        arch, steps, layers = train_case
        out["train"] = lm_train.train(arch, steps=steps, batch=batch, seq=seq, device=dev,
                                      n_layers=layers, log_every=steps,
                                      train_config=TrainConfig(**SHARDED_TRAIN_CONFIG),
                                      mesh=auto_mesh(SHARDED_TRAIN_MESH, axes, dev))[2]
    out["seconds"]["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if ckpt_dir is not None:
        cfg = lm_configs.reduced("smollm-135m")
        params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        specs = lm.logical_specs(params, cfg)

        def placed(shape):
            pol = sharding.ShardingPolicy(auto_mesh(shape, axes, dev),
                                          dict(sharding.DEFAULT_RULES))
            return sharding.param_specs(specs, params, pol)

        ckpt.save(ckpt_dir, 1, {"params": sharding.distribute(params, placed((2, 2)))})
        out["elastic"] = {}
        for shape in ((4, 1), (1, 4)):
            want = placed(shape)
            got, step = ckpt.restore(ckpt_dir, {"params": params},
                                     shardings={"params": want})
            pairs = list(zip(leaves(got["params"]), leaves(params), leaves(want)))
            out["elastic"][shape] = {
                "step": step, "leaves": len(pairs),
                "mismatches": sum(not torch.equal(g.full_tensor(), p) for g, p, _ in pairs),
                "wrong_placements": sum(tuple(g.placements) != w.placements
                                        for g, _, w in pairs)}
        out["params"] = {"/".join(map(str, path)): t.cpu().numpy()
                         for path, t in walk(params)}
    out["seconds"]["ckpt"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if ep is not None:
        cfg = lm_configs.reduced("deepseek-moe-16b")
        p = {k: (torch.from_numpy(v).to(dev) if not isinstance(v, dict) else
                 {kk: torch.from_numpy(vv).to(dev) for kk, vv in v.items()})
             for k, v in ep["params"].items()}
        pol = sharding.ShardingPolicy(auto_mesh(SHARDED_TRAIN_MESH, axes, dev),
                                      dict(sharding.DEFAULT_RULES))
        dp = sharding.distribute(p, sharding.param_specs(lm.logical_specs(p, cfg), p, pol))
        x = torch.from_numpy(ep["x"])
        dx = sharding.from_whole(x, pol.mesh, pol.placements(("batch", None, None)), dev)
        with torch.no_grad(), sharding.use_policy(pol):
            y, aux = moe.moe_forward(dp, dx, cfg)
        out["ep"] = {"y": y.full_tensor().cpu().numpy(), "aux": float(aux.full_tensor()),
                     "expert_parallel": moe.expert_parallel(pol, cfg.moe)}
    out["seconds"]["ep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if fuse_dir is not None:
        out["fuse"] = fuse_restore(dev, fuse_dir, batch, seq)
        out["escaped"] = escaped_leaf(dev, batch, seq)
    out["seconds"]["fuse"] = time.perf_counter() - t0
    out["launches"] = _summed_launches(torch, counters, dev)
    return out


def sharded_train_main_path() -> dict:
    """Rank body of phase 21(b), one NCCL rank a card: on the (1, 1) mesh
    of one card or a (2, n / 2) mesh of n, with the kernels' counters set
    to 0, ``train(mesh=)`` of each ``SHARDED_TRAIN_FULL`` entry (the second
    on four or more cards only) at the default ``TrainConfig``; then the
    ``SHARDED_TRAIN_CHECK`` step under ``make_policy``'s rules against the
    unsharded step on rank 0's card. Returns each run's figures (each
    rank's peak bytes), the check and the summed launches."""
    import torch
    import torch.distributed as dist

    import repro_torch.configs as lm_configs
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.mesh import auto_mesh
    from repro_torch.parallel import policies
    from repro_torch.train.step import TrainConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    shape = (1, 1) if world == 1 else (2, world // 2)
    axes = ("data", "model")
    mesh = auto_mesh(shape, axes, dev)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    runs = {}
    for i, (arch, steps, batch, seq, layers) in enumerate(SHARDED_TRAIN_FULL):
        if i > 0 and world < 4:
            continue
        cfg = dataclasses.replace(lm_configs.get(arch),
                                  n_layers=layers or lm_configs.get(arch).n_layers)
        pol = policies.make_policy(mesh, cfg, "train", seq, batch)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params, opt, losses, rep = lm_train.train(
            arch, steps=steps, batch=batch, seq=seq, reduced=False, mesh=mesh, device=dev,
            n_layers=layers, return_report=True, train_config=TrainConfig(), log_every=1)
        runs[arch] = {"layers": cfg.n_layers, "params": cfg.param_count(), "batch": batch,
                      "seq": seq, "losses": losses, "step_ms": rep["step_ms"],
                      "peak_bytes_by_rank": rep["peak_device_bytes_by_rank"],
                      "placed_bytes_by_rank": rep["placed_device_bytes_by_rank"],
                      "rules": {k: list(v) for k, v in pol.sharding.rules.items()},
                      "notes": list(pol.notes), "wall_s": time.perf_counter() - t0}
        del params, opt
    torch.cuda.empty_cache()
    arch, layers, batch, seq = SHARDED_TRAIN_CHECK
    cfg = dataclasses.replace(lm_configs.get(arch), n_layers=layers)
    rules = policies.make_policy(mesh, cfg, "train", seq, batch).sharding.rules
    check = sharded_step_vs_one_rank(arch, shape, axes, "cuda", "float32", batch, seq,
                                              reduced=False, n_layers=layers, rules=rules)
    return {"shape": list(shape), "runs": runs, "check": check,
            "launches": _summed_launches(torch, counters, dev)}


def sharded_train_phase(torch, dev) -> dict:
    """Phase 21, sharded training (see the module docstring). Returns the
    kernels' launches over (a) and (b), summed over ranks, and the
    figures."""
    import gc

    from repro_torch.core import shard
    from repro_torch.launch import train as lm_train

    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: 0 for k in kernel_counters()}
    out = {}
    ranks = SHARDED_TRAIN_MESH[0] * SHARDED_TRAIN_MESH[1]
    refused = gloo_dtensor_refusal(ranks)
    if refused:
        log(f"21(a) left out: gloo refuses CUDA tensors on this torch build ({refused})")
    else:
        t0 = time.perf_counter()
        got = shard.launch(sharded_train_parity, ranks, "cuda:0", "cuda",
                           SHARDED_TRAIN_COMPARE, SHARDED_TRAIN_BATCH, SHARDED_TRAIN_SEQ)
        for arch, r in got["compare"].items():
            log(f"21(a) {ranks} gloo ranks on one card, {SHARDED_TRAIN_MESH} mesh, reduced "
                f"{arch} float32 step against one rank: " + json.dumps(r))
            if not lm_train.within_tolerance(r, "float32"):
                fail(f"the sharded step of reduced {arch} on {ranks} gloo ranks is outside "
                     f"{lm_train.STEP_TOL['float32']} of the one-rank step (or skipped, or "
                     f"a flip away from a near-tie): {r}")
        for k, v in got["launches"].items():
            launches[k] += v
        out["gloo"] = got["compare"]
        log(f"21(a) done in {time.perf_counter() - t0:.1f} s (spawns included)")

    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    got = shard.launch(sharded_train_main_path, cards, "cuda")
    wall = time.perf_counter() - t0
    gib = 2.0 ** 30
    for arch, r in got["runs"].items():
        ms = r["step_ms"]
        after = sorted(ms[1:]) or ms
        med = after[len(after) // 2]
        r["median_step_ms"] = med
        r["tokens_per_s"] = r["batch"] * r["seq"] / (med / 1e3)
        log(f"21(b) {cards} NCCL rank(s), mesh {tuple(got['shape'])}, {arch} full width "
            f"({r['layers']} layers, {r['params']:,} parameters), {len(ms)} steps of "
            f"{r['batch']} x {r['seq']}: losses {[round(x, 4) for x in r['losses']]}, step ms "
            f"{[round(x, 1) for x in ms]}, median after the first {med:.1f} ms, "
            f"{r['tokens_per_s']:,.0f} tokens/s, peak GiB by rank over the call "
            f"{[round(b / gib, 2) for b in r['peak_bytes_by_rank']]} (up to the end of the "
            f"placement {[round(b / gib, 2) for b in r['placed_bytes_by_rank']]}); rules "
            f"{r['rules']}, "
            f"notes {r['notes']}; {r['wall_s']:.1f} s")
        if len(r["losses"]) != len(ms) or not all(math.isfinite(x) for x in r["losses"]):
            fail(f"sharded training of {arch} skipped a step or gave a non-finite loss: {r}")
        if max(r["peak_bytes_by_rank"]) / gib > TRAIN_PEAK_GIB:
            fail(f"sharded training of {arch} peaked over {TRAIN_PEAK_GIB} GiB on a rank")
    chk = got["check"]
    arch, layers, batch, seq = SHARDED_TRAIN_CHECK
    log(f"21(b) {arch} full width on {layers} layers, {batch} x {seq}, float32, mesh "
        f"{tuple(got['shape'])} against the unsharded step on one card: " + json.dumps(chk))
    if not lm_train.within_tolerance(chk, "float32"):
        fail(f"the sharded full-width {arch} step is outside {lm_train.STEP_TOL['float32']} "
             f"of the unsharded one: {chk}")
    for k, v in got["launches"].items():
        launches[k] += v
    log(f"21(b) done in {wall:.1f} s (spawn included); kernel launches on the sharded "
        f"training path {launches}")
    if any(launches.values()):
        fail(f"the sharded training path launched a kernel of this repository: {launches}")
    out.update(runs=got["runs"], check=chk, shape=got["shape"], launches=launches)
    return out


def four_card_main_path() -> dict:
    """Rank body of phase 22(d), one NCCL rank a card on a (2, 2) mesh:
    with the kernels' counters set to 0, ``train(mesh=)`` of
    ``FOUR_CARD_TRAIN`` whole under ``make_policy``'s placements at the
    default ``TrainConfig``, then ``FOUR_CARD_FULL_CHECK``'s and
    ``FOUR_CARD_CHECK``'s sharded float32 steps against one rank. Returns
    the run's figures, the checks and the summed launches."""
    import torch

    import repro_torch.configs as lm_configs
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.mesh import auto_mesh
    from repro_torch.parallel import policies
    from repro_torch.train.step import TrainConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    shape, axes = (2, 2), ("data", "model")
    mesh = auto_mesh(shape, axes, dev)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    arch, steps, batch, seq = FOUR_CARD_TRAIN
    pol = policies.make_policy(mesh, lm_configs.get(arch), "train", seq, batch)
    t0 = time.perf_counter()
    _, _, losses, rep = lm_train.train(arch, steps=steps, batch=batch, seq=seq, reduced=False,
                                       mesh=mesh, device=dev, train_config=TrainConfig(),
                                       return_report=True, log_every=1)
    run = {"losses": losses, "step_ms": rep["step_ms"],
           "peak_bytes_by_rank": rep["peak_device_bytes_by_rank"],
           "placed_bytes_by_rank": rep["placed_device_bytes_by_rank"],
           "notes": list(pol.notes), "wall_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    arch, layers, batch, seq = FOUR_CARD_FULL_CHECK
    cfg = dataclasses.replace(lm_configs.get(arch), n_layers=layers)
    rules = policies.make_policy(mesh, cfg, "train", seq, batch).sharding.rules
    full = sharded_step_vs_one_rank(arch, shape, axes, "cuda", "float32", batch, seq,
                                    reduced=False, n_layers=layers, rules=rules)
    arch, layers, batch, seq = FOUR_CARD_CHECK
    check = sharded_step_vs_one_rank(arch, shape, axes, "cuda", "float32", batch, seq,
                                     n_layers=layers)
    return {"run": run, "full_check": full, "check": check,
            "launches": _summed_launches(torch, counters, dev)}


def cost_model_phase(torch, dev, zero_counts, read_counts, training) -> dict:
    """Phase 22 (see the module docstring). ``training``: phase 20's
    figures, whose (c) is (c)'s baseline. Returns the figures and the
    launches of (c) and (d)."""
    import concurrent.futures
    import statistics

    import repro_torch.configs as lm_configs
    from repro_torch.core import shard
    from repro_torch.core.altune import steptuner
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as lm_train
    from repro_torch.parallel import policies
    from repro_torch.parallel.sharding import MeshShape
    from repro_torch.train.step import TrainConfig

    gib = 2.0 ** 30
    t_phase = time.perf_counter()
    out = {}
    arch, steps, batch, seq, _ = COST_CELL
    cfg = lm_configs.get(arch)
    cell = lm_configs.ShapeCell(f"train_{batch}x{seq}", seq, batch, "train")
    base_tc = TrainConfig()

    # (c) The tuner at the card's budget; its choice run as phase 20(c) ran
    # the baseline.
    mesh = MeshShape(("data", "model"), (1, 1))
    pol = policies.make_policy(mesh, cfg, "train", seq, batch)
    tuned = steptuner.tune_train_cell(cfg, batch, seq, pol, mesh,
                                      dryrun.state_bytes(cfg, cell, (1, 1), base_tc))
    cand = tuned.candidate
    log(f"22(c) tuner at {steptuner.HBM_BUDGET / gib:.0f} GiB: {cand.describe()} "
        f"(bound {tuned.bound_s * 1e3:.3f} ms, {tuned.bottleneck}; baseline bound "
        f"{tuned.baseline_bound_s * 1e3:.3f} ms, speedup x{tuned.speedup:.4f}; modelled "
        f"{tuned.mem_gb} GiB, feasible {tuned.feasible})")
    chosen_tc = dataclasses.replace(base_tc, microbatches=cand.microbatches,
                                    remat_offload=cand.remat_offload)
    chosen_cfg = dataclasses.replace(cfg, attn_block_skip=cand.block_skip,
                                     chunk_len=cand.chunk_len)
    zero_counts()
    torch.cuda.empty_cache()
    try:
        got = lm_train.train(arch, steps=steps, batch=batch, seq=seq, reduced=False,
                             cfg=chosen_cfg, train_config=chosen_tc, device=dev, log_every=1,
                             return_report=True)
    except torch.cuda.OutOfMemoryError as e:
        fail(f"the tuner's choice ran out of memory (modelled {tuned.mem_gb} GiB): {e}")
    losses, rep = got[2], got[3]
    del got
    torch.cuda.empty_cache()
    launches = read_counts()
    p20 = training[arch]
    runs = {"baseline": {"losses": p20["losses"], "step_ms": p20["step_ms"],
                         "peak_gib": p20["peak_gib"]},
            "chosen": {"losses": losses, "step_ms": rep["step_ms"],
                       "peak_gib": (rep["peak_device_bytes"] or 0) / gib}}
    for name, c, tc in (("baseline", cfg, base_tc), ("chosen", chosen_cfg, chosen_tc)):
        r = runs[name]
        r["median_step_ms"] = statistics.median(r["step_ms"][1:])
        log(f"22(c) {name}{' (phase 20(c))' if name == 'baseline' else ''} "
            f"({c.chunk_len}-token chunks, block-skip {c.attn_block_skip}, {tc.microbatches} "
            f"microbatch(es), offload {tc.remat_offload}): losses {r['losses']}, step ms "
            f"{[round(x, 1) for x in r['step_ms']]}, median after the first "
            f"{r['median_step_ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB")
    base, chosen = runs["baseline"], runs["chosen"]
    tol = lm_train.STEP_TOL["bfloat16"]["loss"]
    if chosen["peak_gib"] * gib > steptuner.HBM_BUDGET:
        fail(f"the tuner's choice peaked at {chosen['peak_gib']:.2f} GiB, over its budget")
    bad = [(a, b) for a, b in zip(chosen["losses"], base["losses"]) if abs(a - b) > tol * abs(b)]
    if bad or len(chosen["losses"]) != steps:
        fail(f"the tuner's choice gives other losses than the baseline (relative {tol}): {bad}")

    # (a) and (b): the two dry runs side by side on the host's CPU, nothing
    # else running.
    t0 = time.perf_counter()
    p_arch, p_cell, p_mesh = DRYRUN_PRODUCTION
    mesh_name, shape = dryrun.MESHES[p_mesh]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fut = pool.submit(dryrun.run_cell, p_arch, p_cell, shape, mesh_name=mesh_name,
                          sampled=True)
        one = pool.submit(dryrun.run_cell, arch, cell, (1, 1), cfg=cfg, train_config=base_tc,
                          mesh_name="1x1").result()
        rec = fut.result()
    log(f"22(a) dry run of {p_arch} x {p_cell} on a fake {shape} group: "
        + json.dumps({k: v for k, v in rec.items() if k != "traceback"}))
    if not rec["ok"]:
        fail(f"the dry run of {DRYRUN_PRODUCTION} did not complete: {rec.get('error')}\n"
             f"{rec.get('traceback', '')}")
    mem = rec["memory"]
    if mem["state_bytes_per_device"] != mem["state_bytes_analytic"]:
        fail(f"the dry run's state bytes a rank {mem['state_bytes_per_device']:,} differ "
             f"from analytic.tree_device_bytes {mem['state_bytes_analytic']:,}")
    out["production"] = rec
    log(f"22(b) dry run of {arch} {batch} x {seq} on a fake (1, 1) group: " + json.dumps(one))
    if not one["ok"] or one["memory"]["state_bytes_per_device"] != \
            one["memory"]["state_bytes_analytic"]:
        fail(f"the one-card dry run failed or its state bytes differ: {one}")
    log(f"22(a, b) dry runs side by side in {time.perf_counter() - t0:.1f} s")

    # (b) continued: the predictions beside phase 20(c)'s measured baseline.
    peak = base["peak_gib"] * gib
    pred, model = one["memory"]["peak_bytes_per_device"], one["analytic_memory"]["total"]
    roof = one["roofline"]
    bound_ms = max(roof["t_compute"], roof["t_memory"], roof["t_collective"]) * 1e3
    exec_ms = one["executed"]["step_lower_bound_s"] * 1e3
    med = base["median_step_ms"]
    log(f"22(b) {arch} {batch} x {seq}, one card: predicted peak {pred / gib:.2f} GiB "
        f"(MemTracker of the fake step), analytic model {model / gib:.2f} GiB; measured "
        f"{base['peak_gib']:.2f} GiB (phase 20(c)); predicted / measured {pred / peak:.4f}, "
        f"model / measured {model / peak:.4f}")
    log(f"22(b) roofline lower bound at the H100's peaks {bound_ms:.2f} ms "
        f"({roof['bottleneck']}; {roof['flops_exec'] / 1e12:.2f} TFLOP, "
        f"{roof['bytes_hbm'] / 1e9:.2f} GB), the executed step's {exec_ms:.2f} ms "
        f"({one['executed']['flops_per_device'] / 1e12:.2f} TFLOP counted, "
        f"{one['executed']['bytes_per_device'] / 1e9:.2f} GB moved op by op); measured median "
        f"{med:.1f} ms: {bound_ms / med * 100:.2f} % / {exec_ms / med * 100:.2f} % of the bound")
    if one["memory"]["fits_80gb"] and peak > steptuner.HBM_BUDGET:
        fail("the dry run said the cell fits 79 GiB and the card's run peaked over it")
    out.update(one_card=one, tuned={"candidate": cand.describe(), "bound_s": tuned.bound_s,
                                    "baseline_bound_s": tuned.baseline_bound_s,
                                    "mem_gb": tuned.mem_gb}, runs=runs,
               predicted_over_measured=pred / peak, bound_share=bound_ms / med)

    # (d) Four cards.
    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"22(d) left out: {cards} card(s); chatglm3-6b whole (93.0 GiB of float32 state) "
            "runs on a (2, 2) mesh of four")
    else:
        t0 = time.perf_counter()
        got = shard.launch(four_card_main_path, 4, "cuda")
        r, chk, full = got["run"], got["check"], got["full_check"]
        log(f"22(d) {FOUR_CARD_TRAIN[0]} whole on four cards, (2, 2): losses "
            f"{[round(x, 4) for x in r['losses']]}, step ms {[round(x, 1) for x in r['step_ms']]}"
            f", peak GiB by rank {[round(b / gib, 2) for b in r['peak_bytes_by_rank']]} (placed "
            f"{[round(b / gib, 2) for b in r['placed_bytes_by_rank']]}), notes {r['notes']}; "
            f"{FOUR_CARD_FULL_CHECK[0]} on {FOUR_CARD_FULL_CHECK[1]} layers vs one card: "
            + json.dumps(full) + f"; {FOUR_CARD_CHECK[0]} sharded step vs one rank: "
            + json.dumps(chk) + f"; {time.perf_counter() - t0:.1f} s")
        if max(r["peak_bytes_by_rank"]) / gib > TRAIN_PEAK_GIB or not all(
                math.isfinite(x) for x in r["losses"]) or not r["losses"][-1] < r["losses"][0]:
            fail(f"four-card training of {FOUR_CARD_TRAIN[0]}: over {TRAIN_PEAK_GIB} GiB, a "
                 f"non-finite loss or no fall: {r}")
        for name, c in ((FOUR_CARD_FULL_CHECK[0], full), (FOUR_CARD_CHECK[0], chk)):
            if not lm_train.within_tolerance(c, "float32"):
                fail(f"the sharded {name} step is outside {lm_train.STEP_TOL['float32']} of "
                     f"one rank: {c}")
        for k, v in got["launches"].items():
            launches[k] += v
        out["four_cards"] = got
    log(f"kernel launches on the cost-model path: {launches}")
    if any(launches.values()):
        fail(f"the cost-model path launched a kernel of this repository: {launches}")
    out["launches"] = launches
    log(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return out


#: The collectives DTensor issues on a (2, 2) mesh, probed in this order by
#: :func:`gloo_dtensor_probe`.
DTENSOR_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter")


def gloo_dtensor_probe() -> Optional[str]:
    """Rank body (four ranks sharing a card over gloo): :func:`gloo_cuda_probe`,
    then each collective that DTensor issues on a (2, 2) mesh of CUDA
    tensors, values checked — ``all_reduce`` (partial sums replicated),
    ``all_gather`` (a ``full_tensor`` of a tensor sharded on both axes) and
    ``reduce_scatter`` (partial sums to shards). Returns the refusal of
    :func:`gloo_cuda_probe` or None. Rank 0 logs each collective before it
    runs: a build whose gloo cannot run one may end the rank (a
    segmentation fault), and the log names the collective."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import auto_mesh

    refused = gloo_cuda_probe()
    if refused:
        return refused
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = auto_mesh(SHARDED_TRAIN_MESH, ("data", "model"), dev)
    full = torch.arange(48, dtype=torch.float32, device=dev).reshape(8, 6)
    r, c = mesh.get_local_rank(0), mesh.get_local_rank(1)
    for op in DTENSOR_COLLECTIVES:
        if dist.get_rank() == 0:
            log(f"gloo DTensor probe: {op} on CUDA tensors")
        if op == "all_gather":
            x = DTensor.from_local(full[r * 4:(r + 1) * 4, c * 3:(c + 1) * 3].contiguous(),
                                   mesh, (Shard(0), Shard(1)), run_check=False)
            got, want = x.full_tensor(), full
        else:
            x = DTensor.from_local(full.clone(), mesh, (Partial(), Partial()), run_check=False)
            want = full * 4
            if op == "reduce_scatter":
                got = x.redistribute(mesh, (Shard(0), Shard(1))).full_tensor()
            else:
                got = x.redistribute(mesh, (Replicate(), Replicate())).to_local()
        if not torch.equal(got, want):
            raise AssertionError(f"gloo {op} of a DTensor on CUDA tensors gave wrong values")
    return None


def gloo_dtensor_refusal(ranks: int) -> Optional[str]:
    """Why ``ranks`` gloo ranks sharing card 0 cannot run sharded training
    (:func:`gloo_dtensor_probe` in one spawn: gloo's refusal, or the rank
    ended by a collective), or None where they can."""
    from repro_torch.core import shard

    try:
        return shard.launch(gloo_dtensor_probe, ranks, "cuda:0")
    except Exception as e:  # a rank ended by the collective itself
        if "signal" not in str(e):
            raise
        return (f"a DTensor collective on gloo ranks sharing the card ended a rank (the "
                f"probe's last logged collective): {type(e).__name__}: {e}")


def sharded_main_path() -> dict:
    """Rank body of phase 18(b), one rank a card over NCCL: the kernels'
    counters set to 0, then ``serve_fleet.serve(sharded=True)`` at the full
    width (1,048,576 DIMMs × 1,440 steps, chunk 256, diurnal) and
    ``trace_eval.run(sharded=True)`` at 65,536 DIMMs × 10,000 steps
    (diurnal, ddr3), each rank's wall, score-finalize seconds and peak
    device memory, and the counters read after, summed over ranks. Returns
    the serve report (its per-rank figures under ``"per_rank"``), the
    trace-eval rows, each rank's figures and the summed launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import serve_fleet, trace_eval

    dev = torch.device("cuda", torch.cuda.current_device())
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    serve = serve_fleet.serve(n_dimms=FULL_DIMMS, n_steps=SERVE_STEPS, chunk=CHUNK,
                              scenario="diurnal", error_rate=0.0, device=dev, sharded=True)
    serve_run_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ev = trace_eval.run(n_dimms=EVAL_DIMMS, n_steps=EVAL_STEPS, scenario="diurnal",
                        refresh="ddr3", error_rate=0.0, device=dev, sharded=True,
                        verbose=False)
    eval_run_s = time.perf_counter() - t0
    mine = {"rank": dist.get_rank(), "card": torch.cuda.current_device(),
            "serve_run_s": serve_run_s, "eval_run_s": eval_run_s,
            "eval_sharded_replay_s": ev["sharded_s"],
            "eval_peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    rows = ev["rows"]
    del ev
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, mine)
    return {"serve": serve, "eval_rows": rows, "per_rank": per_rank,
            "launches": _summed_launches(torch, counters, dev)}


def sharded_phase(torch, dev, serve_score: dict, serve_switches: int) -> dict:
    """Phase 18, the sharded path (see the module docstring): (a) the parity
    check on three gloo ranks sharing this card, after a probe of gloo's
    CUDA collectives; (b) one NCCL rank a card through
    :func:`sharded_main_path`, its serve day held to phase 4's unsharded
    one. Returns the kernels' launches on (b), summed over ranks."""
    import gc

    from repro_torch.core import shard

    gc.collect()
    torch.cuda.empty_cache()
    log(f"sharded path: this process holds {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
        f"of device memory ({torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved) "
        "while its ranks run")
    refused = shard.launch(gloo_cuda_probe, SHARD_GLOO_RANKS, "cuda:0")
    if refused:
        log(f"18(a) left out: gloo refuses CUDA tensors on this torch build ({refused})")
    else:
        t0 = time.perf_counter()
        got = shard.launch(shard_parity, SHARD_GLOO_RANKS, "cuda:0", "cuda", SHARD_GLOO_SIZES,
                           SHARD_STEPS, SHARD_CHUNKINGS, ERROR_RATE)
        wall = time.perf_counter() - t0
        for n in SHARD_GLOO_SIZES:
            r = {k: v for k, v in got[n].items() if k not in ("score", "region_score")}
            log(f"18(a) {SHARD_GLOO_RANKS} gloo ranks on one card, {n:,} DIMMs × "
                f"{SHARD_STEPS} steps: " + json.dumps(r))
            bad = {k: v for k, v in r.items()
                   if (v > SHARD_SCORE_TOL if k.endswith("_err") else v != 0)}
            if bad:
                fail(f"sharded path on {SHARD_GLOO_RANKS} gloo ranks, {n} DIMMs, disagrees "
                     f"with the unsharded card call: {bad}")
        log(f"18(a) done in {wall:.3f} s (spawn included); launches over the ranks "
            f"{got['launches']}")

    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    got = shard.launch(sharded_main_path, cards, "cuda")
    wall = time.perf_counter() - t0
    serve = got["serve"]
    err = max(abs(serve["score"][k] - v) / max(abs(v), 1.0) for k, v in serve_score.items()
              if k != "switches_total")
    log(f"18(b) {cards} NCCL rank(s): serve {FULL_DIMMS:,} DIMMs × {SERVE_STEPS} steps "
        f"sharded: slowest loop {serve['wall_s']:.3f} s, {serve['obs_per_s']:,.0f} obs/s, boot "
        f"{serve['boot_s']:.3f} s, score {serve['score_s']:.3f} s (rank 0), switches "
        f"{serve['total_switches']} (phase 4: {serve_switches}), max score difference from "
        f"phase 4 {err:.3e}; launch of the ranks and both runs {wall:.3f} s")
    for r in serve["per_rank"]:
        log(f"  serve rank {r['rank']}: loop {r['wall_s']:.3f} s, finalize {r['score_s']:.4f} s, "
            f"peak device memory {r['peak_device_bytes'] / 2**30:.2f} GiB")
    for r in got["per_rank"]:
        log(f"  rank {r['rank']} on cuda:{r['card']}: serve run {r['serve_run_s']:.3f} s, "
            f"trace-eval run {r['eval_run_s']:.3f} s (sharded replay "
            f"{r['eval_sharded_replay_s']:.4f} s), trace-eval peak device memory "
            f"{r['eval_peak_device_bytes'] / 2**30:.2f} GiB")
    rows = {name: value for name, value, _ in got["eval_rows"]}
    log("  trace-eval sharded rows: " + json.dumps(
        {k: v for k, v in rows.items() if k.startswith("trace/sharded")
         or k in ("trace/scan_seconds", "trace/accumulate_seconds",
                  "trace/finalize_seconds")}))
    log(f"  launches over the ranks {got['launches']}")
    if int(serve["total_switches"]) != serve_switches or \
            serve["score"]["switches_total"] != serve_score["switches_total"] or err > SHARD_SCORE_TOL:
        fail("the sharded serve day disagrees with phase 4's unsharded day")
    if rows.get("trace/sharded_replay_parity_exact") != 1.0:
        fail("trace-eval's sharded replay is not bitwise the single-device replay")
    launches = got["launches"]
    if not (launches["charge_sweep"] and launches["replay_chunk"] and launches["accumulate"]):
        fail(f"the sharded path did not launch every fleet kernel: {launches}")
    return launches


#: The phase running, named in every failure.
_PHASE = ["0. card and imports"]


def phase(name: str) -> None:
    _PHASE[0] = name
    log(f"---- phase {name}")


def fail(msg: str) -> None:
    """Report a failure, naming the phase, on both streams, and exit 1."""
    line = f"[chip_smoke] FAIL in phase {_PHASE[0]}: {msg}"
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (after one
    warm-up call), by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, kernel: str) -> float:
    """Mean device time a call of the kernels whose name holds ``kernel``,
    over ``reps`` back-to-back calls of ``fn`` (after one warm-up call), from
    ``torch.profiler``'s kernel records: for launches shorter than the
    wrapper's host time, where CUDA events would time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    # The profiler may drop a few records of a long run of short kernels.
    if not reps // 2 <= len(spans) <= reps:
        fail(f"the profiler saw {len(spans)} launches of {kernel} in {reps} calls")
    return sum(spans) / len(spans) * 1e-3


def replay_bytes(state, out, steps: int, n: int) -> int:
    """Bytes a replay chunk must move: its telemetry (4 + 1 bytes a step), the
    table rows of the bins each DIMM's steps realized (the JEDEC row is a
    constant), and its state and partials read and written. ``state`` and
    ``out`` are the chunk's (state3, occ, sw, sums) before and after."""
    visited = int(((out[1][:-1] - state[1][:-1]) > 0).sum())
    per_dimm_state = sum(t.element_size() * t.numel() for t in state) // n
    return n * steps * (4 + 1) + visited * 8 * 4 + 2 * n * per_dimm_state


def replay_launches(steps: int) -> int:
    """Replay-chunk launches of one ``controller.replay`` of ``steps`` steps
    on the card: one a ``REPLAY_CHUNK_STEPS`` steps, or one for the trace."""
    from repro_torch.kernels.replay_step import ops

    return -(-steps // (ops.REPLAY_CHUNK_STEPS or steps))


def emit_chunk(torch, replay_k, x, y, stack_t, tc, ec, scal, aligned: bool = True):
    """One chunk through the replay chunk's emitting entry (carry ``x``) and
    its plain version (carry ``y``), the kernel's rows written at a 16-byte
    boundary or, unless ``aligned``, 4 bytes past one. Returns ``(x, y,
    the kernel's decisions, mismatching words by field)``."""
    c, n = tc.shape
    out = replay_k.Decisions.empty(c, n, tc.device)
    if not aligned:
        rows = torch.empty(c * n * 8 + 1, device=tc.device)[1:].view(c, n, 2, 4)
        out = out._replace(rows=rows)
    *x, got = replay_k.replay_chunk_emit_cuda(*x, stack_t, tc, ec, scal, out)
    *y, want = replay_k.replay_chunk_emit_plain(*y, stack_t, tc, ec, scal)
    torch.cuda.synchronize()
    mism = {name: int((words(torch, a) != words(torch, b)).sum())
            for name, a, b in zip(got._fields, got, want)}
    return x, y, got, mism


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sweep_worst_case(inv, lanes=slice(None)):
    """The charge sweep's worst-case stack: ``inv`` with the rows of
    ``SWEEP_WORST_CASE`` overwritten in the cells ``lanes`` (all by default)."""
    from repro_torch.kernels.charge_sweep.kernel import INVARIANT_NAMES

    out = inv.clone()
    for name, value in SWEEP_WORST_CASE.items():
        out[INVARIANT_NAMES.index(name), lanes] = value
    return out


def sweep_masks_off(inv):
    """``inv`` with one search masked off in every fifth cell: cell 5 m has
    search m % 7's JEDEC mask at 0."""
    from repro_torch.kernels.charge_sweep.kernel import N_SEARCHES

    out = inv.clone()
    for j in range(N_SEARCHES):
        out[11 + j, 5 * j::5 * N_SEARCHES] = 0.0
    return out


def sweep_mixed_lanes(cold, hot, worst, n: int):
    """``n`` charge-sweep cells whose neighbouring lanes end their searches at
    very different candidates: cells of the ``cold`` and ``hot`` stacks
    alternating lane by lane, every third lane a ``worst`` cell, and every
    fifth lane with one search (in turn) masked off (``sweep_masks_off``)."""
    out = cold[:, :n].clone()
    out[:, 1::2] = hot[:, 1:n:2]
    out[:, ::3] = worst[:, :n:3]
    return sweep_masks_off(out)


def sweep_evaluations(torch, inv, idx, scal, n_grid, warp: int = 32) -> dict:
    """The candidates the charge sweep evaluates on ``inv``, implied by its
    indices ``idx`` (a search stops at its first pass, never starts where its
    mask is 0, ends before its grid's last candidate): ``ops``, the float
    operations the cells need, one by one; ``charge`` and
    ``charge_latched``, the expf-and-division evaluations a cell of the five
    charge searches costs warp by warp (a warp of ``warp`` neighbouring cells
    runs a search until its slowest lane is done), without and with the tRAS
    searches' latched shortcut (no expf where the restore has not started,
    unless another live lane of the warp needs it); ``charge_full``, the
    same for a walk of every charge search over the longest grid, as a
    search that never stops costs; ``steps_by_search``, each search's mean
    candidates a cell."""
    from repro_torch.kernels.charge_sweep.kernel import INVARIANT_NAMES

    n = inv.shape[1]
    pad = -n % warp
    masks = inv[11:] > 0.5
    last = torch.tensor(n_grid, device=idx.device)[:, None] - 1
    steps = torch.where(masks, torch.minimum(idx + 1, last), 0).to(torch.int64)  # (7, n)
    lanes = torch.nn.functional.pad(steps, (0, pad)).view(len(n_grid), -1, warp)
    warp_steps = lanes.amax(dim=2).to(torch.float64)               # (7, warps)
    charge = float(warp_steps[list(SWEEP_CHARGE_SEARCHES)].sum(0).mean())
    ops = sum(float(steps[j].sum()) * SWEEP_OPS_PER_EVALUATION[j] for j in range(len(n_grid)))
    latched_saved = 0.0
    for j, row in SWEEP_TRAS_SEARCHES:
        t_sense = inv[INVARIANT_NAMES.index(row)]
        for k in range(n_grid[j]):
            t = torch.full_like(t_sense, k + 1) * scal.tck
            latched = (t - scal.ovh_ras - t_sense) <= 0.0
            live = steps[j] > k
            ops -= float((live & latched).sum()) * (
                SWEEP_OPS_PER_EVALUATION[j] - SWEEP_OPS_LATCHED)
            # The warp skips the expf at k if no live lane of it needs one.
            need = torch.nn.functional.pad(live & ~latched, (0, pad)).view(-1, warp).any(1)
            latched_saved += float(((warp_steps[j] > k) & ~need).sum())
    warps = warp_steps.shape[1]
    return {"ops": ops, "charge": charge, "charge_latched": charge - latched_saved / warps,
            "charge_full": float(len(SWEEP_CHARGE_SEARCHES) * max(n_grid)),
            "steps_by_search": [round(float(s), 3) for s in
                                steps.to(torch.float64).mean(1)]}


def time_split(torch, label: str, run, hooks, rest: str) -> dict:
    """Seconds of ``run()`` by part, the device synchronized around each call
    of the hooked module attributes (``hooks``: (module, attribute, part));
    ``rest`` names the remainder of the run. Fails if a part was never
    called, as it would be if the path stopped reaching it through the
    hooked attribute."""
    parts = {part: 0.0 for _, _, part in hooks}
    calls = dict.fromkeys(parts, 0)

    def timed(fn, part):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[part] += time.perf_counter() - t0
            calls[part] += 1
            return out
        return call

    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in hooks]
    for mod, name, part in hooks:
        setattr(mod, name, timed(getattr(mod, name), part))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    if not all(calls.values()):
        fail(f"{label} split: a part was never reached: {calls}")
    return {**parts, rest: total - sum(parts.values()), "total": total}


def sweep_hooks(sweep_ops, profiler):
    """The fleet sweep's parts: the invariant precompute
    (``stacked_invariants``), the search kernel (``search_indices``) and the
    joint stack (``profiler.joint_min_timings``)."""
    return ((sweep_ops, "stacked_invariants", "invariants"),
            (sweep_ops, "search_indices", "kernel"),
            (profiler, "joint_min_timings", "joint"))


def boot_split(torch, dev, serve_fleet, fleet, sweep_ops, profiler) -> dict:
    """Seconds of the serve path's boot by part: ``serve_fleet.bootstrap_table``
    at ``FULL_DIMMS`` from seed 0, split into the population's synthesis
    (``fleet.synthesize``), the sweep's parts (``sweep_hooks``) and ``table``,
    the rest (pattern, indices to ns, the controller's table)."""
    return time_split(
        torch, "boot",
        lambda: serve_fleet.bootstrap_table(torch.Generator(device=dev).manual_seed(0),
                                            FULL_DIMMS, device=dev),
        ((fleet, "synthesize", "synthesis"),) + sweep_hooks(sweep_ops, profiler), "table")


def sweep_card_vs_cpu(fl, temps, patterns) -> dict:
    """``fleet.sweep`` of the card's fleet ``fl`` on the card and, on a copy,
    on the CPU: the read and write stacks' threshold flips and other
    mismatches (``sweep_mismatches``), the joint stack's one-tCK boundary
    flips and other mismatches (``joint_mismatches`` against the CPU's raw
    minima), and the largest difference of ``summary()``. Returns both
    sweeps too."""
    from repro_torch.core import charge, fleet, profiler

    card = fleet.sweep(fl, temps, patterns)
    host_cells = charge.CellParams(*(a.cpu() for a in fl.cells))
    host = fleet.sweep(fleet.Fleet(host_cells, fl.vendor.cpu()), temps, patterns)
    rw = sweep_mismatches(card, host, host_cells)
    raw = profiler.joint_raw_timings(charge.CellParams(*(a[None, :] for a in host_cells)),
                                     host.temps_c[:, None])
    flips, bad = joint_mismatches(card.joint[:, 0], host.joint[:, 0], raw)
    sc, sh = card.summary(), host.summary()
    return {"read_flips": rw["read"][0], "read_bad": rw["read"][1],
            "write_flips": rw["write"][0], "write_bad": rw["write"][1],
            "flip_details": rw["read"][2] + rw["write"][2],
            "joint_flips": flips, "joint_bad": bad,
            "summary_diff": max(abs(a - b) for t in sh for p in sh[t]
                                for a, b in zip(sc[t][p], sh[t][p])),
            "card": card, "host": host}


def profiling_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 15: the profiling path. The main path first — ``fleet.sweep`` of
    the serve boot's fleet at full width over every default temperature and
    pattern, every kernel's count read around it, then once more split into
    its parts — then the controller's table from ``DimmTimingTable.profile``
    against the sweep's, a JSON round trip, the port on the card against the
    port on the CPU, and the Fig. 3 report on both. Returns the main path's
    launches."""
    from repro_torch.core import charge, controller, fleet, perfmodel, profiler
    from repro_torch.kernels.charge_sweep import ops as sweep_ops

    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    fl = fleet.synthesize(gen, FULL_DIMMS, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)
    zero_counts()
    t0 = time.perf_counter()
    res = fleet.sweep(fl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base_bytes
    cells = res.read.shape[0] * res.read.shape[1] * res.read.shape[2]
    s55 = res.summary()[55.0]
    log(f"profiling main path: fleet.sweep of {FULL_DIMMS:,} DIMMs × "
        f"{len(fleet.DEFAULT_TEMPS_C)} temperatures × {len(fleet.DEFAULT_PATTERNS)} patterns "
        f"({cells:,} cells): wall {wall * 1e3:.3f} ms, peak device memory above the fleet "
        f"{peak / 2**30:.3f} GiB, launches {launches}")
    log("  summary()[55.0] mean reductions against the paper's §1.5: " + ", ".join(
        f"{p} {s55[p][1]:.4f} (paper {PAPER_55C[p]:.3f})" for p in PAPER_55C))
    want_l = dict.fromkeys(launches, 0)
    want_l["charge_sweep"] = 1
    if launches != want_l:
        fail(f"profiling main path: launches {launches}, expected {want_l}")
    stacks = (res.read, res.write, res.joint)
    if not all(tuple(x.shape) == (5, 4, FULL_DIMMS, 4) and bool(torch.isfinite(x).all())
               for x in stacks):
        fail("profiling main path: a stack of the wrong shape or with a non-finite entry")
    if any(abs(s55[p][1] - v) > PAPER_TOL for p, v in PAPER_55C.items()):
        fail(f"profiling main path: 55 °C means outside the paper's ±{PAPER_TOL} window")
    del res, stacks
    split = time_split(torch, "profiling", lambda: fleet.sweep(fl),
                       sweep_hooks(sweep_ops, profiler), "rest")
    log("  the same sweep again, synchronized between parts (rest: pattern, indices to "
        "ns, stacking): " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in split.items()))

    table = controller.DimmTimingTable.profile(fl.cells, BOOT_BINS)
    same = table == fleet.sweep(fl, BOOT_BINS, (1.0,)).to_table()
    part = controller.DimmTimingTable(table.temp_bins, table.stack[:JSON_SLICE_DIMMS])
    text = part.to_json()
    again = controller.DimmTimingTable.from_json(text, device=dev)
    log(f"DimmTimingTable.profile == fleet.sweep(...).to_table() at {FULL_DIMMS:,} DIMMs: "
        f"{same}; JSON round trip of {JSON_SLICE_DIMMS:,} DIMMs ({len(text):,} bytes, "
        f"schema v{controller.TABLE_SCHEMA_VERSION}): equal={again == part}")
    if not same or again != part:
        fail("the profiled table or its JSON round trip differs")
    del table, part, again, fl

    small = fleet.synthesize(torch.Generator(device=dev).manual_seed(0), PROFILE_CHECK_DIMMS,
                             device=dev)
    cmp = sweep_card_vs_cpu(small, fleet.DEFAULT_TEMPS_C, fleet.DEFAULT_PATTERNS)
    host_cells = charge.CellParams(*(a.cpu() for a in small.cells))
    f_card = profiler.fig2_summary(small.cells, 55.0)
    f_host = profiler.fig2_summary(host_cells, 55.0)
    normals = torch.randn((REPEAT_TRIALS, PROFILE_CHECK_DIMMS), generator=gen, device=dev)
    r_card = profiler.repeatability_from_normals(normals, small.cells, 55.0)
    r_host = profiler.repeatability_from_normals(normals.cpu(), host_cells, 55.0)
    fig2_diff = max(abs(f_card[k] - f_host[k]) for k in f_host)
    rep_diff = max(abs(r_card[k] - r_host[k]) for k in r_host)
    n_entries = cmp["host"].read.numel()
    log(f"profiling {PROFILE_CHECK_DIMMS:,} DIMMs × 5 × 4, card vs CPU, of {n_entries:,} "
        f"entries a stack: read and write entries one grid step apart at a decision "
        f"threshold {cmp['read_flips']} and {cmp['write_flips']}, other mismatches "
        f"{cmp['read_bad']} and {cmp['write_bad']}; joint entries one tCK apart at a cycle "
        f"boundary {cmp['joint_flips']}, other joint mismatches {cmp['joint_bad']}; largest "
        f"difference of summary() {cmp['summary_diff']:.3e}, of fig2_summary(55 °C) "
        f"{fig2_diff:.3e}, of repeatability on the same draws {rep_diff:.3e} "
        f"(repeat fraction {r_card['repeat_fraction']:.5f})")
    for line in cmp["flip_details"]:
        log(f"  {line}")
    if (cmp["read_bad"] or cmp["write_bad"] or cmp["joint_bad"]
            or cmp["summary_diff"] > MEAN_TOL or fig2_diff > MEAN_TOL or rep_diff > MEAN_TOL):
        fail("the profiling path on the card disagrees with the CPU")
    del cmp

    worst = 0.0
    for name in ("SINGLE_CORE", "MULTI_CORE"):
        cfg = getattr(perfmodel, name)
        card_r = perfmodel.speedup_report(cfg, device=dev)
        host_r = perfmodel.speedup_report(cfg, device="cpu")
        worst = max([worst] + [abs(card_r[k] - host_r[k]) for k in host_r])
        log(f"Fig. 3 report, {name}, on the card: " + json.dumps(card_r))
        if not all(math.isfinite(v) for v in card_r.values()):
            fail(f"Fig. 3 report {name}: a non-finite figure")
    log(f"  multi-core memory-intensive geomean {card_r['intensive_geomean']:.6f} beside the "
        f"paper's {PAPER_INTENSIVE:.3f}; card vs CPU largest difference {worst:.3e}")
    if worst > REPORT_TOL:
        fail("the Fig. 3 report on the card disagrees with the CPU")
    return launches


def regions_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 16: the region path, (a)–(d) of the module docstring. Returns
    the launches of the four main-path runs, summed, and the charge sweep's
    figures on the region stack."""
    from repro_torch.core import charge, controller, fleet, perfmodel, stream, traces
    from repro_torch.kernels.charge_sweep import kernel as sweep_k
    from repro_torch.kernels.charge_sweep import ops as sweep_ops
    from repro_torch.launch import trace_eval

    total = {}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def expect(label: str, launches: dict, **want) -> None:
        full = dict.fromkeys(launches, 0) | want
        if launches != full:
            fail(f"{label}: launches {launches}, expected {full}")

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    # (a) The region sweep at full width.
    torch.cuda.empty_cache()
    fl = fleet.synthesize(torch.Generator(device=dev).manual_seed(0), FULL_DIMMS, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)
    zero_counts()
    t0 = time.perf_counter()
    res = fleet.sweep_regions(fl, n_regions=REGIONS)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = read_counts()
    add(launches)
    peak = torch.cuda.max_memory_allocated(dev) - base_bytes
    cells = math.prod(res.read.shape[:-1])
    expect("region sweep", launches, charge_sweep=1)
    del res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fleet.sweep_regions(fl, n_regions=REGIONS)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"region sweep: fleet.sweep_regions of {FULL_DIMMS:,} DIMMs × "
        f"{len(fleet.DEFAULT_TEMPS_C)} temperatures × {len(fleet.DEFAULT_PATTERNS)} patterns × "
        f"{REGIONS} regions ({cells:,} cells, one charge-sweep launch): cold {cold * 1e3:.3f} "
        f"ms, warm {warm * 1e3:.3f} ms, peak device memory above the fleet "
        f"{peak / 2**30:.3f} GiB, launches {launches}")
    free = fleet.sweep(fl)
    anchor = all(torch.equal(bits(getattr(res, k)[:, :, -1]), bits(getattr(free, k)))
                 for k in ("read", "write"))
    monotone = all(bool((getattr(res, k).diff(dim=2) >= 0).all()) for k in ("read", "write"))
    log(f"  anchor region bitwise equal to fleet.sweep on the card: {anchor}; region axis "
        f"monotone (each region <= the next, read and write): {monotone}")
    if not (anchor and monotone):
        fail("region sweep: the anchor region differs from fleet.sweep or the region axis "
             "is not monotone")
    del res, free
    split = time_split(torch, "region sweep",
                       lambda: fleet.sweep_regions(fl, n_regions=REGIONS),
                       ((sweep_ops, "stacked_invariants", "invariants"),
                        (sweep_ops, "search_indices", "kernel")), "rest")
    log("  the same sweep again, synchronized between parts (rest: pattern, region, "
        "indices to ns): " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in split.items()))
    # The kernel alone on the region stack, beside its bound.
    t = torch.tensor(fleet.DEFAULT_TEMPS_C, dtype=torch.float32, device=dev)
    p = torch.tensor(fleet.DEFAULT_PATTERNS, dtype=torch.float32, device=dev)
    eff = charge.apply_region(
        charge.apply_pattern(charge.CellParams(*(a[None, None, None, :] for a in fl.cells)),
                             p[None, :, None, None]),
        charge.region_fracs(REGIONS, device=dev)[None, None, :, None])
    inv, _ = sweep_ops.stacked_invariants(eff, t[:, None, None, None])
    scal = sweep_ops.kernel_scalars()
    n_grid = sweep_ops.ref.SEARCH_GRID_SIZES
    kernel_ms = cuda_ms(torch, lambda: sweep_k.charge_sweep_cuda(inv, scal), 5)
    idx = sweep_k.charge_sweep_cuda(inv, scal)
    ops = sweep_evaluations(torch, inv, idx, scal, n_grid)["ops"]
    region_bound, region_by = bound_ms(inv.shape[1] * (inv.shape[0] + sweep_k.N_SEARCHES) * 4,
                                       ops)
    log(f"  the charge-sweep kernel alone on the region stack ({inv.shape[1]:,} cells): "
        f"{kernel_ms:.4f} ms, bound {region_bound:.4f} ms ({region_by})")
    del inv, idx, eff
    torch.cuda.empty_cache()

    small = fleet.synthesize(torch.Generator(device=dev).manual_seed(0), PROFILE_CHECK_DIMMS,
                             device=dev)
    host_cells = charge.CellParams(*(a.cpu() for a in small.cells))
    t0 = time.perf_counter()
    card = fleet.sweep_regions(small, n_regions=REGIONS)
    host = fleet.sweep_regions(host_cells, n_regions=REGIONS)
    cmp = sweep_mismatches(card, host, host_cells)
    log(f"region sweep {PROFILE_CHECK_DIMMS:,} DIMMs × 5 × 4 × {REGIONS}, card vs CPU, of "
        f"{host.read.numel():,} entries a stack ({time.perf_counter() - t0:.1f} s): read and "
        f"write entries one grid step apart at a decision threshold {cmp['read'][0]} and "
        f"{cmp['write'][0]}, other mismatches {cmp['read'][1]} and {cmp['write'][1]}")
    for line in cmp["read"][2] + cmp["write"][2]:
        log(f"  {line}")
    if cmp["read"][1] or cmp["write"][1]:
        fail("the region sweep on the card disagrees with the CPU beyond the threshold rule")
    del card, host, small

    # (b) The region boot.
    zero_counts()
    t0 = time.perf_counter()
    rtable = controller.DimmTimingTable.profile(fl.cells, BOOT_BINS, n_regions=REGIONS)
    torch.cuda.synchronize()
    boot = time.perf_counter() - t0
    launches = read_counts()
    add(launches)
    expect("region boot", launches, charge_sweep=1)
    free = controller.DimmTimingTable.profile(fl.cells, BOOT_BINS)
    same = torch.equal(bits(rtable.oblivious_stack()), bits(free.stack))
    part = controller.DimmTimingTable(rtable.temp_bins, rtable.stack[:JSON_SLICE_DIMMS])
    text = part.to_json()
    again = controller.DimmTimingTable.from_json(text, device=dev)
    json_ok = again == part and again.to_json() == text and json.loads(text)["n_regions"] == REGIONS
    log(f"region boot: DimmTimingTable.profile(n_regions={REGIONS}) of {FULL_DIMMS:,} DIMMs × "
        f"{len(BOOT_BINS)} bins ({rtable.n_dimms * rtable.n_bins * REGIONS:,} cells) "
        f"{boot * 1e3:.3f} ms, launches {launches}; oblivious registers bitwise equal to the "
        f"region-free boot: {same}; v5 JSON of {JSON_SLICE_DIMMS:,} DIMMs ({len(text):,} bytes) "
        f"both ways: {json_ok}")
    if not (same and json_ok):
        fail("region boot: the oblivious registers or the v5 JSON round trip differ")
    del rtable, free, part, again, fl

    # (c) Trace-eval design_skew with regions at the trace-eval width.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    out = {}

    def run():
        out["rep"] = trace_eval.run(n_dimms=EVAL_DIMMS, n_steps=EVAL_STEPS,
                                    scenario="design_skew", refresh="ddr3", error_rate=0.0,
                                    regions=REGIONS, device=dev)

    parts = time_split(torch, "trace-eval regions", run, (
        (fleet, "sweep_regions", "sweep"), (fleet.RegionSweepResult, "to_table", "table"),
        (traces, "region_access_mix", "mix"), (perfmodel, "region_counts_add_", "counts"),
        (perfmodel, "region_score_finalize", "finalize")), "rest of the run")
    launches = read_counts()
    add(launches)
    rep = out["rep"]
    expect("trace-eval design_skew", launches, charge_sweep=2,
           replay_chunk=2 * replay_launches(EVAL_STEPS) + replay_launches(EVAL_LOOP_STEPS),
           accumulate=1)
    rs = rep["region_score"]
    log(f"trace-eval main path, design_skew with {REGIONS} regions: {EVAL_DIMMS:,} DIMMs × "
        f"{EVAL_STEPS:,} steps, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {launches}")
    log("  region section by part (synchronized between parts; s): " + json.dumps(
        {k: round(v, 6) for k, v in parts.items()}))
    log("  region rows: " + json.dumps({name: value for name, value, _ in rep["rows"]
                                        if "region" in name}))
    aware = rs["speedup_region_aware_intensive_mean"]
    oblivious = rs["speedup_region_oblivious_intensive_mean"]
    if not aware > oblivious or not all(math.isfinite(v) for v in rs.values()):
        fail(f"trace-eval design_skew: aware {aware} not above oblivious {oblivious}, or a "
             "non-finite region figure")
    rtable, mix = rep["region_table"], rep["region_mix"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    counts = perfmodel.region_counts_add_(
        perfmodel.region_counts_init(EVAL_DIMMS, rtable.n_bins, REGIONS, dev),
        rep["replay"].bin_idx, mix)
    torch.cuda.synchronize()
    counts_peak = torch.cuda.max_memory_allocated(dev) - before
    onehot = EVAL_STEPS * EVAL_DIMMS * (rtable.n_bins + 1) * 4
    log(f"  region counts of the {EVAL_STEPS:,}-step history: peak device memory above their "
        f"inputs {counts_peak / 2**20:.1f} MiB (a one-hot of the bins: {onehot / 2**30:.1f} "
        f"GiB); mix an expanded view (stride {tuple(mix.stride())})")
    if counts_peak > REGION_COUNTS_PEAK_BYTES or mix.stride(0) != 0:
        fail("trace-eval region counts: too much memory, or the mix was copied over steps")
    day = rep["trace"][:REGION_STREAM_STEPS].cpu()
    del rep, out, counts, mix

    # (d) The region stream.
    mix = traces.region_access_mix(None, REGION_STREAM_STEPS, EVAL_DIMMS, REGIONS,
                                   profile=REGION_STREAM_MIX, device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    streamed = stream.replay_stream(rtable, day, chunk_steps=CHUNK, region_mix=mix)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    add(launches)
    expect("region stream", launches, replay_chunk=-(-REGION_STREAM_STEPS // CHUNK))
    free = stream.replay_stream(rtable, day, chunk_steps=CHUNK)
    mat = controller.replay(rtable, day)
    want = perfmodel.region_counts_accumulate(
        perfmodel.region_counts_init(EVAL_DIMMS, rtable.n_bins, REGIONS, dev), mat.bin_idx, mix)
    counts_same = torch.equal(streamed.region_counts, want)
    partials_same = all(torch.equal(bits(a), bits(b))
                        for a, b in zip(streamed.partials, free.partials))
    state_same = all(torch.equal(a, b) for a, b in zip(streamed.state, mat.state))
    score = streamed.region_score()
    log(f"region stream: {EVAL_DIMMS:,} DIMMs × {REGION_STREAM_STEPS:,} steps, chunk {CHUNK}, "
        f"{REGION_STREAM_MIX} mix: {wall:.3f} s, launches {launches}; region counts equal to "
        f"the materialized replay's: {counts_same}; partials bitwise equal to the mix-free "
        f"stream's: {partials_same}; final state equal: {state_same}; aware intensive "
        f"{score['speedup_region_aware_intensive_mean']:.6f}, oblivious "
        f"{score['speedup_region_oblivious_intensive_mean']:.6f}")
    if not (counts_same and partials_same and state_same):
        fail("region stream: counts, partials or state differ")
    return {"launches": total, "regions_ms": kernel_ms, "regions_bound_ms": region_bound,
            "regions_bound_by": region_by, "regions_cells": cells}


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of one head under the kernel's masks."""
    return sum(max((min(qp + 1, skv) if causal else skv)
                   - (max(qp - window + 1, 0) if window > 0 else 0), 0) for qp in range(sq))


def wide_timing(torch, fa_k, q, k, v, causal: bool, window: int) -> dict:
    """Every tile instantiated at q's head width timed on (q, k, v), beside
    the bound, the plain version and ``scaled_dot_product_attention`` on
    head-major copies with the KV heads repeated to H (a boolean mask for a
    window)."""
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    by_tile = {t: cuda_ms(torch, lambda t=t: fa_k.flash_attention_cuda(
        q, k, v, causal=causal, window=window, tile=t), 5) for t in fa_k.tiles(dh)}
    best = min(by_tile, key=by_tile.get)
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (x.transpose(1, 2).repeat_interleave(h // hk, dim=1).contiguous() for x in (k, v))
    mask = None
    if window > 0:
        dpos = (torch.arange(sq, device=q.device)[:, None]
                - torch.arange(skv, device=q.device)[None, :])
        mask = (dpos < window) & ((dpos >= 0) if causal else True)
    sdpa_ms = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None), 3)
    del qh, kh, vh, mask
    plain_ms = cuda_ms(torch, lambda: fa_k.flash_attention_plain(
        q, k, v, causal=causal, window=window), 3)
    pairs = b * h * attention_pairs(sq, skv, causal, window)
    bound, by = bound_ms(4 * (2 * b * sq * h * dh + 2 * b * skv * hk * dh),
                         ATTENTION_OPS_PER_PAIR_DIM * dh * pairs)
    return {"ms": by_tile[best], "tile": str(best),
            "ms_by_tile": {str(t): round(v_, 4) for t, v_ in by_tile.items()},
            "bound_ms": bound, "bound_by": by, "library_ms": sdpa_ms, "plain_ms": plain_ms,
            "pairs": pairs}


def flash_attention_phase(torch, dev, gen, fa_k):
    """Phase 9: the kernel against its plain version on every case and every
    tile instantiated at its head width (the wide cases also timed), then
    every tile timed at the serve shape and at altune's. Returns the
    kernel's figures (the serve shape's at the top level, altune's under
    ``"altune"``, the wide cases' under ``"by_head_dim"``)."""
    max_err, wide = 0.0, {}
    for name, b, sq, skv, h, hk, dh, causal, window in FA_CASES:
        q = torch.randn((b, sq, h, dh), generator=gen, device=dev)
        k, v = (torch.randn((b, skv, hk, dh), generator=gen, device=dev) for _ in range(2))
        want = fa_k.flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = fa_k.tolerance(want)
        errs = {}
        for tile in fa_k.tiles(dh):
            got = fa_k.flash_attention_cuda(q, k, v, causal=causal, window=window, tile=tile)
            torch.cuda.synchronize()
            errs[tile] = float((got - want).abs().max())
            if not (errs[tile] <= tol and bool(torch.isfinite(got).all())):
                fail(f"flash-attention kernel, tile {tile}, disagrees with its plain version "
                     f"on {name}: {errs[tile]:.3e} > {tol:.3e}")
            del got
        log(f"flash attention, {name}: B {b}, Sq {sq}, Skv {skv}, H {h}, Hk {hk}, dh {dh}, "
            f"causal {causal}, window {window}: max|kernel - plain| by tile "
            f"{[(t, f'{e:.3e}') for t, e in errs.items()]} (tolerance {tol:.3e})")
        max_err = max([max_err] + list(errs.values()))
        if name in FA_WIDE_TIMED:
            wide[dh] = wide_timing(torch, fa_k, q, k, v, causal, window)
            log(f"flash attention at {name} (B {b}, Sq {sq}, Skv {skv}, H {h}, Hk {hk}, dh {dh}, "
                f"causal {causal}, window {window}): kernel by tile {wide[dh]['ms_by_tile']} ms, "
                f"best {wide[dh]['tile']} {wide[dh]['ms']:.4f} ms "
                f"({wide[dh]['bound_ms'] / wide[dh]['ms'] * 100:.1f} % of its bound), "
                f"plain {wide[dh]['plain_ms']:.3f} ms, "
                f"scaled_dot_product_attention {wide[dh]['library_ms']:.4f} ms, bound "
                f"{wide[dh]['bound_ms']:.4f} ms ({wide[dh]['bound_by']}), "
                f"{wide[dh]['pairs']:,} visible pairs")
        del q, k, v, want
    torch.cuda.empty_cache()

    out = {"max_abs_err": max_err, "by_head_dim": wide}
    for label, (b, s, h, hk, dh), reps in (("serve", FA_SERVE_SHAPE, 20),
                                           ("altune", FA_ALTUNE_SHAPE, 3)):
        q = torch.randn((b, s, h, dh), generator=gen, device=dev)
        k, v = (torch.randn((b, s, hk, dh), generator=gen, device=dev) for _ in range(2))
        by_tile = {t: cuda_ms(torch, lambda t=t: fa_k.flash_attention_cuda(
            q, k, v, causal=True, tile=t), reps) for t in fa_k.TILES}
        best = min(by_tile, key=by_tile.get)
        # The library yardstick on head-major copies (its preferred layout)
        # with the KV heads repeated to H: its float32 GQA path
        # (enable_gqa) is the math one, which materializes the scores.
        qh = q.transpose(1, 2).contiguous()
        kh, vh = (x.transpose(1, 2).repeat_interleave(h // hk, dim=1).contiguous()
                  for x in (k, v))
        sdpa_ms = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), reps)
        del qh, kh, vh
        pairs = b * h * s * (s + 1) // 2
        bound, by = bound_ms(4 * (2 * b * s * h * dh + 2 * b * s * hk * dh),
                             ATTENTION_OPS_PER_PAIR_DIM * dh * pairs)
        fig = {"ms": by_tile[best], "tile": str(best),
               "ms_by_tile": {str(t): v_ for t, v_ in by_tile.items()},
               "bound_ms": bound, "bound_by": by, "library_ms": sdpa_ms}
        plain = ""
        if label == "serve":
            fig["plain_ms"] = cuda_ms(torch, lambda: fa_k.flash_attention_plain(
                q, k, v, causal=True), 3)
            plain = f"plain {fig['plain_ms']:.3f} ms, "
        log(f"flash attention at the {label} shape (B {b}, S {s}, H {h}, Hk {hk}, dh {dh}, "
            f"causal): kernel by tile {[(t, round(v_, 4)) for t, v_ in by_tile.items()]} ms, "
            f"best {best} {by_tile[best]:.4f} ms "
            f"({ATTENTION_OPS_PER_PAIR_DIM * dh * pairs / by_tile[best] / 1e9:.2f} TFLOP/s, "
            f"{bound / by_tile[best] * 100:.1f} % of its bound), {plain}"
            f"scaled_dot_product_attention {sdpa_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        if label == "serve":
            out.update(fig)
        else:
            out["altune"] = fig
        del q, k, v
        torch.cuda.empty_cache()
    return out


def lm_card_vs_cpu_phase(dev):
    """Phase 10: each reduced LM on the card and on the CPU, same weights and
    inputs; the decode is teacher-forced with the CPU's ids (hubert-xlarge,
    encoder-only: one forward of embeddings, every position compared)."""
    from repro_torch.launch import serve as lm_launch

    for arch in (LM_ARCH,) + LM_FAMILIES:
        r = lm_launch.compare_card_to_cpu(arch, dev, LM_SMALL_BATCH, LM_SMALL_PROMPT,
                                          LM_SMALL_STEPS, LM_TOL)
        log_compare(f"reduced {arch}", r, LM_TOL)


def log_compare(label: str, r: dict, tol: float) -> None:
    """Log one ``compare_card_to_cpu`` result and fail unless it holds:
    logits and caches within ``tol``, greedy ids equal where the CPU is sure,
    every routing flip a near-tie on the CPU (rows after the first flip left
    out), one flash-attention launch per attention layer in the prefill,
    none in decode."""
    log(f"LM card vs CPU, {label} ({r['n_layers']} layers, {r['attn_layers']} of them "
        f"attention, d_model {r['d_model']}, dh {r['d_head']}), {LM_SMALL_BATCH} × "
        f"{LM_SMALL_PROMPT}-position inputs + {LM_SMALL_STEPS} decode steps (none if "
        f"encoder-only): max logit difference {r['logit_err']:.3e}, max cache difference "
        f"{r['cache_err']:.3e} (tolerance {tol:g}); greedy ids equal at {r['agree']} of "
        f"{r['sure']} rows whose top-2 gap exceeds {2 * tol:g}; flash-attention launches in "
        f"the card's prefill {r['prefill_launches']}, in its decode {r['decode_launches']}")
    if r["moe_calls"] or r["route_flips"]:
        from repro_torch.launch.serve import FLIP_EPS

        log(f"  routes: {r['moe_calls']} routings compared, {r['route_flips']} tokens with "
            f"another expert set on the card ({r['flips_not_near_tie']} of them with a CPU "
            f"gap between the k-th and (k+1)-th probability above {FLIP_EPS:g}; largest gap "
            f"{r['flip_max_gap']:.3e}); logit rows left out after the first flip "
            f"{r['excluded_rows']}, caches compared {r['cache_compared']}")
    if (r["logit_err"] > tol or r["cache_err"] > tol or not (r["sure"] or r["excluded_rows"])
            or r["agree"] != r["sure"] or r["flips_not_near_tie"]
            or r["prefill_launches"] != r["attn_layers"] or r["decode_launches"]):
        fail(f"LM serve of {label} on the card disagrees with the CPU reference")


def lm_main_path_phase(torch, dev, zero_counts, read_counts, arch=LM_ARCH, batch=LM_BATCH,
                       prompt=LM_PROMPT, gen=LM_GEN, profiled=True, layers=None):
    """Phases 11, 11b and 19: ``serve`` of ``arch`` at full width (cut to
    its first ``layers`` layers unless None), every kernel's count read
    around it (one flash-attention launch per attention layer), then, if
    ``profiled``, a profiled prefill and a few decode steps of the same
    model. Returns the launches and the serve report."""
    import repro_torch.configs as lm_configs
    from repro_torch.launch import serve as lm_launch
    from repro_torch.launch import serve_fleet
    from repro_torch.models import model as lm
    from repro_torch.models import stack as lm_stack
    from repro_torch.train import serve as lm_serve
    from torch.profiler import ProfilerActivity, profile, record_function

    cfg = lm_configs.get(arch)
    cut = "" if layers is None else f", cut from {cfg.n_layers} layers to {layers}"
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
    torch.cuda.empty_cache()
    zero_counts()
    ids, rep = lm_launch.serve(arch, batch=batch, prompt_len=prompt, gen=gen,
                               reduced=False, device=dev, return_report=True, n_layers=layers)
    launches = read_counts()
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    log(f"LM serve main path: {arch} at full width{cut} ({cfg.n_layers} layers, "
        f"{lm_stack.attention_layers(cfg)} of them attention, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, dh {cfg.d_head}, vocab {cfg.vocab_size:,}, "
        f"{n_params / 1e9:.3f}e9 parameters, float32), {batch} × {prompt}-token prompts, "
        f"{gen} new tokens: prefill {rep['prefill_s'] * 1e3:.3f} ms, decode "
        f"{rep['decode_s_per_token'] * 1e3:.3f} ms a token, peak device memory "
        f"{rep['peak_device_bytes'] / 2**30:.2f} GiB, launches {launches}")
    log(f"  generated ids[0, :16]: {ids[0, :16].tolist()}")
    want = {name: 0 for name in launches}
    want["flash_attention"] = lm_stack.attention_layers(cfg)
    if launches != want:
        fail(f"LM serve main path of {arch} launched {launches}, expected {want} (one "
             f"flash-attention launch per attention layer in the prefill)")
    if (tuple(ids.shape) != (batch, gen) or not rep["logits_finite"]
            or int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab_size):
        fail(f"LM serve main path of {arch}: malformed ids or non-finite logits")
    del ids
    if not profiled:
        return {"launches": launches, "report": rep}

    # Where the time goes: one prefill and a few decode steps, profiled.
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    sc = lm_serve.ServeConfig(max_len=prompt + LM_PROFILED_DECODE + 1, cache_dtype="float32")
    prefill, decode = lm_serve.make_prefill_step(cfg, sc), lm_serve.make_decode_step(cfg, sc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("lm_prefill"):
            last, caches = prefill(params, {"tokens": prompts})
            nxt = torch.argmax(last, -1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
        with record_function("lm_decode"):
            for i in range(LM_PROFILED_DECODE):
                nxt, _, caches = decode(params, caches, nxt, prompt + i)
            torch.cuda.synchronize()
    for name in ("lm_prefill", "lm_decode"):
        tr = serve_fleet._trace_summary(prof, top=8, range_name=name)
        steps = 1 if name == "lm_prefill" else LM_PROFILED_DECODE
        log(f"{arch} {name} under torch.profiler ({steps} call(s)): span {tr['loop_s']:.4f} s "
            f"({tr['loop_s'] / steps * 1e3:.3f} ms a call), device busy "
            f"{tr['device_busy_s'] * 1e3:.3f} ms ({tr['device_busy_frac'] * 100:.2f} %)")
        top = dict(list(tr["device_s_by_name"].items())[:8])
        log("  device time by activity (s): " + json.dumps(top))
        rep[f"{name}_busy_frac"] = tr["device_busy_frac"]
    log("  host ops by self time (both ranges): " + json.dumps(tr["host_self_s_top"]))
    del params, caches, prompts, prof, last
    torch.cuda.empty_cache()
    return {"launches": launches, "report": rep}


def recurrence_share(torch, dev, arch: str, batch: int, prompt: int, module, fn_name: str):
    """One prefill of ``arch`` at full width (random weights) with
    ``module.fn_name`` timed around each call (synchronized): that
    function's seconds, the prefill's, and the share."""
    import repro_torch.configs as lm_configs
    from repro_torch.models import model as lm

    cfg = dataclasses.replace(lm_configs.get(arch), attn_impl="pallas")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    inner, spent = getattr(module, fn_name), [0.0, 0]

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        spent[1] += 1
        return out

    setattr(module, fn_name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill(params, cfg, cache_len=prompt, tokens=prompts, last_logits=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        setattr(module, fn_name, inner)
    del params, prompts
    torch.cuda.empty_cache()
    log(f"{arch} prefill ({batch} × {prompt} tokens) with {module.__name__}.{fn_name} timed "
        f"around each of its {spent[1]} calls: {spent[0] * 1e3:.3f} ms of {total * 1e3:.3f} ms "
        f"({spent[0] / total * 100:.2f} %)")
    return {"s": spent[0], "prefill_s": total, "share": spent[0] / total, "calls": spent[1]}


def lm_families_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 11b–d: the LM families' full-width main paths, hubert-xlarge's
    encoder forward, the recurrences' shares of their prefills, and the
    full-width card-vs-CPU checks. Returns each path's launches and figures."""
    import repro_torch.configs as lm_configs
    from repro_torch.launch import serve as lm_launch
    from repro_torch.models import model as lm
    from repro_torch.models import rglru, xlstm

    out = {}
    for arch, batch, prompt, gen, profiled in LM_FULL_PATHS:
        out[arch] = lm_main_path_phase(torch, dev, zero_counts, read_counts, arch, batch,
                                       prompt, gen, profiled)
    out["recurrentgemma-9b"]["rglru_scan"] = recurrence_share(
        torch, dev, "recurrentgemma-9b", *LM_FULL_PATHS[1][1:3], rglru, "linear_scan")
    out["xlstm-125m"]["slstm_scan"] = recurrence_share(
        torch, dev, "xlstm-125m", *LM_FULL_PATHS[2][1:3], xlstm, "slstm_scan")

    # hubert-xlarge: the encoder forward of embeddings (no serving: encoder-only).
    cfg = dataclasses.replace(lm_configs.get("hubert-xlarge"), attn_impl="pallas")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    embeds = torch.randn((HUBERT_BATCH, HUBERT_FRAMES, cfg.d_model),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    lm.forward(params, cfg, embeds=embeds[:, :64])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    logits, _, _ = lm.forward(params, cfg, embeds=embeds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"hubert-xlarge encoder forward at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, dh {cfg.d_head}, {cfg.param_count() / 1e9:.3f}e9 "
        f"parameters, float32, non-causal), {HUBERT_BATCH} × {HUBERT_FRAMES} frames: "
        f"{wall * 1e3:.3f} ms, peak device memory {peak / 2**30:.2f} GiB, launches {launches}")
    want = {name: 0 for name in launches}
    want["flash_attention"] = cfg.n_layers
    if (launches != want or tuple(logits.shape) != (HUBERT_BATCH, HUBERT_FRAMES, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        fail(f"hubert-xlarge forward: launches {launches} (expected {want}), logits "
             f"{tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    out["hubert-xlarge"] = {"launches": launches, "report": {"forward_s": wall,
                                                              "peak_device_bytes": peak}}
    del params, embeds, logits
    torch.cuda.empty_cache()

    # Full width card vs CPU (weights drawn on the card, copied to the host).
    for arch, layers in LM_FULL_COMPARE:
        t0 = time.perf_counter()
        r = lm_launch.compare_card_to_cpu(arch, dev, LM_SMALL_BATCH, LM_SMALL_PROMPT,
                                          LM_SMALL_STEPS, LM_TOL, reduced=False,
                                          n_layers=layers)
        full = lm_configs.get(arch).n_layers
        cut = "" if layers is None else f", cut from {full} layers to {layers}"
        log_compare(f"{arch} at full width{cut}", r, LM_TOL)
        log(f"  {time.perf_counter() - t0:.1f} s with the host's share")
        torch.cuda.empty_cache()
    return out


def moe_split(torch, dev, arch: str, batch: int, prompt: int, layers=None) -> dict:
    """One prefill of ``arch`` at full width (random weights; cut to
    ``layers`` unless None) with each MoE layer (``moe.moe_forward``) and,
    inside it, the routed experts' parts (``MOE_PARTS``) timed, every call
    synchronized. Returns the seconds by part and the MoE layers' share of
    the prefill."""
    import repro_torch.configs as lm_configs
    from repro_torch.models import model as lm
    from repro_torch.models import moe

    cfg = lm_configs.get(arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas", n_layers=layers or cfg.n_layers)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)

    def run():
        lm.prefill(params, cfg, cache_len=prompt, tokens=prompts, last_logits=True)

    run()  # warm-up
    # The parts run inside the MoE layers: time_split's remainder counts
    # them twice, so the layers' rest is taken from the same run here.
    split = time_split(torch, f"{arch} MoE layers", run,
                       ((moe, "moe_forward", "moe layers"),)
                       + tuple((moe, name, part) for name, part in MOE_PARTS), "rest")
    del params, prompts
    torch.cuda.empty_cache()
    parts = {part: split[part] for _, part in MOE_PARTS}
    out = {"prefill_s": split["total"], "moe_layers_s": split["moe layers"],
           "moe_share": split["moe layers"] / split["total"], "parts_s": parts,
           "shared_and_rest_s": split["moe layers"] - sum(parts.values())}
    log(f"{arch} prefill ({batch} × {prompt} tokens, each call synchronized): "
        f"{split['total'] * 1e3:.3f} ms, of which the MoE layers {split['moe layers'] * 1e3:.3f} "
        f"ms ({out['moe_share'] * 100:.2f} %), in ms: "
        + json.dumps({part: round(v * 1e3, 3) for part, v in parts.items()})
        + f", shared experts and the rest {out['shared_and_rest_s'] * 1e3:.3f}")
    return out


def moe_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 19: the experts' main paths, ``MOE_FULL_PATHS``, each served
    (``lm_main_path_phase``, profiled) and its prefill split
    (:func:`moe_split`), the cached blocks of every earlier phase released
    first. Returns each path's launches and figures."""
    import repro_torch.configs as lm_configs

    out = {}
    for arch, batch, prompt, gen, layers in MOE_FULL_PATHS:
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        cfg = dataclasses.replace(lm_configs.get(arch), n_layers=layers or
                                  lm_configs.get(arch).n_layers)
        log(f"{arch}: {cfg.param_count() * 4 / 2**30:.2f} GiB of float32 parameters "
            f"({cfg.active_param_count() / 1e9:.3f}e9 active of {cfg.param_count() / 1e9:.3f}e9); "
            f"the card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free, this process "
            f"holds {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
        out[arch] = lm_main_path_phase(torch, dev, zero_counts, read_counts, arch, batch,
                                       prompt, gen, True, layers)
        out[arch]["moe_split"] = moe_split(torch, dev, arch, batch, prompt, layers)
    return out


def words(torch, t):
    """A tensor's bits as integers, for bitwise comparison."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


def latency_matmul_phase(torch, dev, gen):
    """Phase 12a: the matmul kernel against its plain version on every case
    and instantiated tile; timed at the production shape."""
    from repro_torch.kernels.latency_matmul import kernel as mm_k

    out = {"max_abs_err": 0.0}
    for name, m, k, n, dt in MM_CASES:
        dtype = getattr(torch, dt)
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        y = torch.randn((k, n), generator=gen, device=dev).to(dtype)
        want = mm_k.matmul_plain(x, y)
        tol = mm_k.tolerance(want)
        errs = {}
        for tile in mm_k.TILES:
            got = mm_k.matmul_cuda(x, y, *tile)
            torch.cuda.synchronize()
            errs[tile] = float((got.float() - want.float()).abs().max())
            if not (errs[tile] <= tol and bool(torch.isfinite(got).all())):
                fail(f"latency-matmul kernel, tile {tile}, disagrees with its plain version "
                     f"on {name}: {errs[tile]:.3e} > {tol:.3e}")
        log(f"latency matmul, {name} ({m}, {k}) @ ({k}, {n}) {dt}: max|kernel - plain| by "
            f"tile {[(t, f'{e:.3e}') for t, e in errs.items()]} (tolerance {tol:.3e})")
        out["max_abs_err"] = max([out["max_abs_err"]] + list(errs.values()))
        if name == "production":
            by_tile = {t: cuda_ms(torch, lambda t=t: mm_k.matmul_cuda(x, y, *t), 10)
                       for t in mm_k.TILES}
            best = min(by_tile, key=by_tile.get)
            plain_ms = cuda_ms(torch, lambda: mm_k.matmul_plain(x, y), 10)
            lib_ms = cuda_ms(torch, lambda: torch.matmul(x, y), 10)
            bound, by = bound_ms(x.element_size() * (m * k + k * n + m * n), 2 * m * k * n)
            log(f"latency matmul at {m}³ {dt}: kernel by tile "
                f"{[(t, round(v, 4)) for t, v in by_tile.items()]} ms, best {best} "
                f"{by_tile[best]:.4f} ms ({2 * m * k * n / by_tile[best] / 1e9:.2f} TFLOP/s), "
                f"plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound {bound:.4f} ms "
                f"({by})")
            out.update(ms=by_tile[best], tile=str(best),
                       ms_by_tile={str(t): v for t, v in by_tile.items()}, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del x, y, want, got
    return out


def rglru_scan_phase(torch, dev, gen):
    """Phase 12b: the scan kernel against its plain version on every case and
    instantiated tile, bitwise; timed at the production shape."""
    from repro_torch.kernels.rglru_scan import kernel as sc_k

    out = {"mismatches": 0, "max_abs_err": 0.0}
    for name, b, s, d, dt in SCAN_CASES:
        dtype = getattr(torch, dt)
        a = (torch.rand((b, s, d), generator=gen, device=dev) * 0.9 + 0.05).to(dtype)
        bb = torch.randn((b, s, d), generator=gen, device=dev).to(dtype)
        h0 = torch.randn((b, d), generator=gen, device=dev).to(dtype)
        want = sc_k.rglru_scan_plain(a, bb, h0)
        mism = {}
        for tile in sc_k.TILES:
            got = sc_k.rglru_scan_cuda(a, bb, h0, *tile)
            torch.cuda.synchronize()
            mism[tile] = int((words(torch, got) != words(torch, want)).sum())
            out["max_abs_err"] = max(out["max_abs_err"],
                                     float((got.float() - want.float()).abs().max()))
        log(f"rglru scan, {name} (B {b}, S {s}, D {d}) {dt}: mismatching words by tile "
            f"{list(mism.items())}")
        out["mismatches"] += sum(mism.values())
        if any(mism.values()):
            fail(f"rglru-scan kernel disagrees with its plain version on {name}: {mism}")
        if name == "production":
            by_tile = {t: cuda_ms(torch, lambda t=t: sc_k.rglru_scan_cuda(a, bb, h0, *t), 20)
                       for t in sc_k.TILES}
            best = min(by_tile, key=by_tile.get)
            plain_ms = cuda_ms(torch, lambda: sc_k.rglru_scan_plain(a, bb, h0), 1)
            bound, by = bound_ms(a.element_size() * (3 * b * s * d + b * d), 2 * b * s * d)
            log(f"rglru scan at (8, 4096, 4096) {dt}: kernel by tile "
                f"{[(t, round(v, 4)) for t, v in by_tile.items()]} ms, best {best} "
                f"{by_tile[best]:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by})")
            out.update(ms=by_tile[best], tile=str(best),
                       ms_by_tile={str(t): v for t, v in by_tile.items()}, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=None)
        del a, bb, h0, want, got
    return out


def flash_decode_phase(torch, dev, gen):
    """Phase 12c: the decode kernel against its plain version on every case
    and instantiated tile; timed at the production shape beside SDPA."""
    from repro_torch.kernels.flash_decode import kernel as fd_k

    out = {"max_abs_err": 0.0}
    for name, b, n, h, hk, dh, length, dt in FD_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((b, h, dh), generator=gen, device=dev).to(dtype)
        if "8-byte" in name:  # views whose rows start 4 elements past a 16-byte boundary
            kv = torch.randn((b, n, hk, dh + 4), generator=gen, device=dev).to(dtype)
            k, v = kv[..., 4:], kv[..., :dh]
            del kv
        else:
            k, v = (torch.randn((b, n, hk, dh), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
        want = fd_k.flash_decode_plain(q, k, v, length)
        tol = fd_k.tolerance(want)
        errs = {}
        for bk in fd_k.TILES:
            got = fd_k.flash_decode_cuda(q, k, v, length, bk)
            torch.cuda.synchronize()
            errs[bk] = float((got.float() - want.float()).abs().max())
            if not (errs[bk] <= tol and bool(torch.isfinite(got).all())):
                fail(f"flash-decode kernel, bk {bk}, disagrees with its plain version on "
                     f"{name}: {errs[bk]:.3e} > {tol:.3e}")
        log(f"flash decode, {name} (B {b}, L {n}, H {h}, Hk {hk}, dh {dh}, length {length}) "
            f"{dt}: max|kernel - plain| by bk {[(t, f'{e:.3e}') for t, e in errs.items()]} "
            f"(tolerance {tol:.3e})")
        out["max_abs_err"] = max([out["max_abs_err"]] + list(errs.values()))
        if name == "production":
            by_tile = {t: cuda_ms(torch, lambda t=t: fd_k.flash_decode_cuda(q, k, v, length, t),
                                  20) for t in fd_k.TILES}
            best = min(by_tile, key=by_tile.get)
            plain_ms = cuda_ms(torch, lambda: fd_k.flash_decode_plain(q, k, v, length), 3)
            qh, kh, vh = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
            sdpa_ms = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, enable_gqa=True), 20)
            del kh, vh
            bound, by = bound_ms(q.element_size() * (2 * b * length * hk * dh + 2 * b * h * dh),
                                 ATTENTION_OPS_PER_PAIR_DIM * dh * b * h * length)
            log(f"flash decode at the production shape: kernel by bk "
                f"{[(t, round(v_, 4)) for t, v_ in by_tile.items()]} ms, best {best} "
                f"{by_tile[best]:.4f} ms ({2 * b * length * hk * dh * q.element_size() / by_tile[best] / 1e9:.3f}"
                f" TB/s of K and V), plain {plain_ms:.3f} ms, scaled_dot_product_attention "
                f"{sdpa_ms:.4f} ms, bound {bound:.4f} ms ({by})")
            out.update(ms=by_tile[best], tile=str(best),
                       ms_by_tile={str(t): v_ for t, v_ in by_tile.items()}, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=sdpa_ms)
        if name == "bf16":
            by_tile = {t: cuda_ms(torch, lambda t=t: fd_k.flash_decode_cuda(q, k, v, length, t),
                                  20) for t in fd_k.TILES}
            bound, _ = bound_ms(q.element_size() * (2 * b * length * hk * dh + 2 * b * h * dh),
                                ATTENTION_OPS_PER_PAIR_DIM * dh * b * h * length)
            qh, kh, vh = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
            sdpa_ms = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, enable_gqa=True), 20)
            del kh, vh
            log(f"flash decode at the production shape in bfloat16: kernel by bk "
                f"{[(t, round(v_, 4)) for t, v_ in by_tile.items()]} ms, "
                f"scaled_dot_product_attention {sdpa_ms:.4f} ms, bound {bound:.4f} ms")
            out.update(bf16_ms_by_tile={str(t): v_ for t, v_ in by_tile.items()},
                       bf16_bound_ms=bound, bf16_library_ms=sdpa_ms)
        del q, k, v, want, got
        torch.cuda.empty_cache()
    return out


def gate_phase(torch):
    """Phase 13a: the cost model's tile gate against cudaFuncGetAttributes
    for every instantiated tile of the four altune kernels."""
    from repro_torch.core.altune import costmodel as cm
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import kernel as fd_k
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.latency_matmul import kernel as mm_k
    from repro_torch.kernels.latency_matmul import ops as mm_ops
    from repro_torch.kernels.rglru_scan import kernel as sc_k
    from repro_torch.kernels.rglru_scan import ops as sc_ops

    checks = []  # (label, config, model args, card attributes[, model shared memory])
    # The float32 matmul has two builds a tile: cp.async for 16-byte aligned
    # rows, the register path for others; bfloat16 takes the register path.
    for dt, aligned, path in ((torch.float32, True, "cp.async"),
                              (torch.float32, False, "register path"),
                              (torch.bfloat16, False, "register path")):
        checks += [(f"latency_matmul {dt} {path}", c, (),
                    mm_k.attributes((c.bm, c.bn, c.bk), dt, aligned))
                   for c in mm_ops.CANDIDATES]
    for dt in (torch.float32, torch.bfloat16):
        checks += [(f"rglru_scan {dt}", c, (), sc_k.attributes((c.bd, c.bs), dt))
                   for c in sc_ops.CANDIDATES]
        # Decode stages K and V in their dtype: its shared memory follows it.
        itemsize = torch.empty((), dtype=dt).element_size()
        checks += [(f"flash_decode dh {dh} {dt}", c, (dh,), fd_k.attributes(c.bk, dh, dt),
                    c.smem_bytes(dh, itemsize))
                   for c in fd_ops.CANDIDATES for dh in fd_k.HEAD_DIMS]
    checks += [(f"flash_attention dh {dh}", c, (dh,), fa_k.attributes(dh, (c.bq, c.bk)))
               for dh in fa_k.HEAD_DIMS for c in fa_ops.candidates(dh)]
    table = []
    for label, cfg, args, at, *smem in checks:
        smem = smem[0] if smem else cfg.smem_bytes(*args)
        threads, regs = cfg.threads(*args), cfg.registers(*args)
        model_ok, note = cm.gate(smem, threads, regs)
        card_ok = (at["registers"] <= cm.MAX_REGS_PER_THREAD
                   and at["registers"] * at["threads"] <= cm.REGS_PER_BLOCK
                   and at["threads"] <= at["max_threads"] and at["smem_bytes"] <= cm.SMEM_PER_BLOCK)
        agree = model_ok == card_ok and at["smem_bytes"] == smem and at["threads"] == threads
        table.append({"kernel": label, "config": str(cfg), "model_feasible": model_ok,
                      "card_launchable": card_ok, "registers": at["registers"],
                      "registers_lower_bound": regs, "smem_bytes": at["smem_bytes"],
                      "model_smem_bytes": smem, "threads": at["threads"],
                      "max_threads": at["max_threads"], "spill_bytes": at["local_bytes"]})
        if not (agree and card_ok):
            fail(f"tile gate disagrees with the card for {label} {cfg}: {table[-1]} {note}")
    log(f"tile gate vs cudaFuncGetAttributes: {len(table)} instantiated tiles, all feasible by "
        f"the cost model and launchable by the card, shared memory and threads equal")
    for row in table:
        log("  " + json.dumps(row))
    refused = [(mm_ops.MMConfig(256, 256, 256), ()), (mm_ops.MMConfig(512, 512, 1024), ()),
               (sc_ops.ScanConfig(256, 128), ()), (fa_ops.FAConfig(128, 128), (128,))]
    log("  the reference's TPU tiles through the gate: " + json.dumps({
        str(c): cm.gate(c.smem_bytes(*a), c.threads(*a), c.registers(*a))[1]
        for c, a in refused}))
    # The tiles of the widths up to 128 not instantiated at 256 or 320: the
    # gate must refuse each, for its shared memory.
    skipped = {f"{c} dh {dh}": cm.gate(c.smem_bytes(dh), c.threads(dh), c.registers(dh))
               for dh in fa_k.HEAD_DIMS for c in fa_ops.CANDIDATES
               if c not in fa_ops.candidates(dh)}
    log("  attention tiles not instantiated at a head width, through the gate: "
        + json.dumps({k: v[1] for k, v in skipped.items()}))
    if any(ok or "shared memory" not in note for ok, note in skipped.values()):
        fail(f"the gate admits an attention tile the kernel does not instantiate: {skipped}")


def launch_overheads(torch, dev):
    """Phase 13b: an empty kernel's launch overhead (one block a launch,
    back to back) and extra time a block (one launch of PROBE_BLOCKS), as
    the cost model's LAUNCH_OVERHEAD_S and STEP_OVERHEAD_S (per block on
    its SM: the wall time a block times the SM count)."""
    import ctypes

    from repro_torch.core.altune import costmodel as cm
    from repro_torch.kernels import _build

    lib = _build.load("launch_probe")
    lib.launch_probe.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    lib.launch_probe.restype = ctypes.c_int
    stream = _build.stream_ptr(dev)

    def probe(blocks: int, launches: int) -> None:
        _build.check(lib, lib.launch_probe(blocks, 128, launches, stream), "launch_probe")

    launch_s = cuda_ms(torch, lambda: probe(1, PROBE_LAUNCHES), 5) / PROBE_LAUNCHES * 1e-3
    many_s = cuda_ms(torch, lambda: probe(PROBE_BLOCKS, 1), 5) * 1e-3
    block_s = (many_s - launch_s) / PROBE_BLOCKS * cm.N_SMS
    log(f"empty kernel: {launch_s * 1e6:.4f} µs a launch (one block, {PROBE_LAUNCHES} back to "
        f"back), {many_s * 1e3:.4f} ms for {PROBE_BLOCKS:,} blocks = {block_s * 1e9:.4f} ns a "
        f"block on its SM; the cost model has LAUNCH_OVERHEAD_S {cm.LAUNCH_OVERHEAD_S:g}, "
        f"STEP_OVERHEAD_S {cm.STEP_OVERHEAD_S:g}")


def altune_main_path_phase(torch, dev, zero_counts, read_counts, out_dir):
    """Phase 14: the altune main path on the card, every kernel's count read
    around it; every worst-case tile must validate."""
    from repro_torch.launch import altune_margin

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    rows, results = altune_margin.run(device=dev, return_results=True,
                                      out=os.path.join(out_dir, "altune_timing_table.json"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"altune main path: run {wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {launches}")
    log("  rows: " + json.dumps({name: [value, ref] for name, value, ref in rows}))
    for res in results:
        wc = [e for e in res.entries if e.config == res.worst_case]
        if not wc or not (wc[0].feasible and wc[0].validated and wc[0].repeat_ok):
            fail(f"altune: the worst-case tile of {res.kernel} did not validate on the card: "
                 f"{wc}")
        if not all(math.isfinite(e.t_seconds) and e.t_seconds > 0 for e in res.entries
                   if e.feasible and e.validated):
            fail(f"altune: {res.kernel} has a validated tile without a measured time")
    for name in ("latency_matmul", "rglru_scan", "flash_decode", "flash_attention"):
        if launches[name] < 1:
            fail(f"the altune main path never launched the {name} kernel")
    if launches["charge_sweep"] or launches["replay_chunk"] or launches["accumulate"]:
        fail(f"the altune main path launched kernels of other paths: {launches}")
    return launches


def silu_fork_launches(torch, dev, shape) -> dict:
    """Kernel launches of one bfloat16 silu call on a ``shape`` input,
    (forward, backward), for ``blocks.silu`` (the reference's rounding
    steps) as ``"fork"`` and torch's fused ``F.silu`` as ``"fused"``."""
    import torch.nn.functional as F
    from repro_torch.models import blocks
    from torch.profiler import ProfilerActivity, profile

    def launches(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")

    x = torch.randn(shape, device=dev, dtype=torch.bfloat16, requires_grad=True)
    out = {}
    for name, f in (("fork", blocks.silu), ("fused", F.silu)):
        f(x)  # warm
        holder = {}
        fwd = launches(lambda: holder.update(y=f(x)))
        gy = torch.ones_like(holder["y"])
        x.grad = None
        bwd = launches(lambda: holder["y"].backward(gy))
        out[name] = (fwd, bwd)
    return out


def train_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 20: training. (a) ``TRAIN_COMPARE`` and ``TRAIN_COMPARE_FULL``:
    one step card vs CPU; (b)
    smollm-135m at full width and depth through ``launch.train.train``
    (``TRAIN_SMOLLM``), learning, timed, and one more step profiled; (c, d)
    ``TRAIN_FULL``: full-width steps of Llama-3.2-3B and deepseek-moe-16b
    (3 layers), step time and peak memory (at the default schedule's first
    rates, ~1e-7: these steps show memory and time; (a) holds the
    full-width step's values). Every kernel's count is read
    around (b)–(d): the training path runs no kernel of this repository
    (attention is the chunked form; the flash-attention kernel has no
    backward pass). Returns those launches and the figures."""
    import statistics

    import repro_torch.configs as lm_configs
    from repro_torch.data import pipeline as data
    from repro_torch.launch import serve_fleet
    from repro_torch.launch import train as lm_train
    from repro_torch.models import model as lm
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as train_step
    from torch.profiler import ProfilerActivity, profile, record_function

    gib = 2.0 ** 30
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    log(f"training phase starts with {held / gib:.2f} GiB held by this process")
    out = {"compare": {}}
    t0 = time.perf_counter()
    cases = [(arch, dtype, "reduced", {}) for arch, dtype in TRAIN_COMPARE] + [
        (arch, dtype, f"full-width, {layers}-layer",
         dict(reduced=False, n_layers=layers, batch=batch, seq=seq))
        for arch, dtype, layers, batch, seq in TRAIN_COMPARE_FULL]
    for arch, dtype, size, kw in cases:
        t1 = time.perf_counter()
        r = lm_train.compare_card_to_cpu(arch, dev, dtype, **kw)
        log(f"train step card vs CPU, {size} {arch} at {dtype}: loss {r['loss']:.6f}, "
            f"loss diff {r['loss_err']:.3e}, grad norm diff {r['grad_norm_err']:.3e}, params "
            f"{r['params']:.3e}, moments {r['moments']:.3e} (leaf {r['moments_leaf']}), "
            f"update {r['update']:.3e}; tolerance {lm_train.STEP_TOL[dtype]}; routings "
            f"{r['moe_calls']}, flips {r['route_flips']} ({r['flips_not_near_tie']} not at a "
            f"near-tie; largest gap of a flipped token {r['max_flip_gap']:.3e}, near-tie "
            f"bound {lm_train.STEP_FLIP_EPS[dtype]:.3e}); {time.perf_counter() - t1:.1f} s")
        if not lm_train.within_tolerance(r, dtype):
            fail(f"train step of {size} {arch} ({dtype}) card vs CPU outside "
                 f"{lm_train.STEP_TOL[dtype]} (or skipped, or a flip away from a near-tie): {r}")
        out["compare"][f"{arch}/{dtype}/{size}"] = r
    log(f"(a) took {time.perf_counter() - t0:.1f} s")

    launches = {}
    zero_counts()
    steps, batch, seq, micro = TRAIN_SMOLLM
    arch = "smollm-135m"
    cfg = lm_configs.get(arch)
    n_params = cfg.param_count()
    t0 = time.perf_counter()
    params, opt, losses, rep = lm_train.train(arch, steps=steps, batch=batch, seq=seq,
                                              reduced=False, microbatches=micro,
                                              log_every=10, device=dev, return_report=True)
    wall = time.perf_counter() - t0
    for k, v in read_counts().items():
        launches[k] = launches.get(k, 0) + v
    ms = rep["step_ms"]
    med = statistics.median(ms[1:])
    tokens = batch * seq
    last = sum(losses[-TRAIN_LAST:]) / TRAIN_LAST
    smollm = {"steps": steps, "batch": batch, "seq": seq, "microbatches": micro,
              "first_loss": losses[0], "last_mean_loss": last, "first_step_ms": ms[0],
              "median_step_ms": med, "tokens_per_s": tokens / (med / 1e3),
              "flops_per_s_6nd": 6 * n_params * tokens / (med / 1e3),
              "peak_gib": (rep["peak_device_bytes"] or 0) / gib, "wall_s": wall,
              "skipped": rep["skipped"]}
    log(f"(b) {arch} full width ({cfg.n_layers} layers, {n_params:,} parameters), {steps} "
        f"steps of {batch} x {seq} tokens, {micro} microbatches: loss {losses[0]:.4f} -> "
        f"mean of the last {TRAIN_LAST} {last:.4f}; step 1 {ms[0]:.1f} ms, median after it "
        f"{med:.2f} ms, {smollm['tokens_per_s']:,.0f} tokens/s, 6·N·D "
        f"{smollm['flops_per_s_6nd'] / 1e12:.2f} TFLOP/s; peak {smollm['peak_gib']:.2f} GiB; "
        f"{wall:.1f} s in all")
    if len(losses) != steps or rep["skipped"] or not all(math.isfinite(x) for x in losses):
        fail(f"{arch} training skipped steps or gave non-finite losses: {rep['skipped']}")
    if last > losses[0] - TRAIN_DROP:
        fail(f"{arch} did not learn: last-{TRAIN_LAST} mean {last:.4f} is not "
             f"{TRAIN_DROP} below step 1's {losses[0]:.4f}")

    # One more step under the profiler: the device's busy share and the
    # host's waits for it within the step.
    tc = train_step.TrainConfig(microbatches=micro, opt=OptConfig(
        peak_lr=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps))
    fn = train_step.make_train_step(cfg, tc)
    dc = data.DataConfig(seq_len=seq, global_batch=batch)
    zero_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("train_step"):
            b = data.to_device(data.batch_for_step(cfg, dc, steps), dev)
            params, opt, m = fn(params, opt, b)
            float(m["loss"])
    for k, v in read_counts().items():
        launches[k] += v
    tr = serve_fleet._trace_summary(prof, top=8, range_name="train_step")
    smollm.update(profiled_step_ms=tr["loop_s"] * 1e3, busy_frac=tr["device_busy_frac"],
                  host_waits=tr["host_syncs"])
    log(f"(b) one step under torch.profiler: span {tr['loop_s'] * 1e3:.2f} ms, device busy "
        f"{tr['device_busy_s'] * 1e3:.2f} ms ({tr['device_busy_frac'] * 100:.2f} %), host "
        f"waits for the device {tr['host_syncs']}")
    log("  device time by activity (s): " + json.dumps(dict(list(
        tr["device_s_by_name"].items())[:8])))
    log("  host ops by self time: " + json.dumps(tr["host_self_s_top"]))
    launched = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    fork = silu_fork_launches(torch, dev, (batch // micro, seq, cfg.d_ff))
    calls = cfg.n_layers * micro  # one gated FFN a layer and microbatch
    extra = calls * (2 * (fork["fork"][0] - fork["fused"][0])  # forward and its recompute
                     + fork["fork"][1] - fork["fused"][1])
    smollm.update(step_launches=launched, silu_fork=fork, silu_fork_extra_launches=extra)
    log(f"(b) bfloat16 silu as the reference's steps (blocks.silu): {fork['fork'][0]} forward "
        f"+ {fork['fork'][1]} backward launches a call, torch's fused silu "
        f"{fork['fused'][0]} + {fork['fused'][1]}; {calls} calls a step (forward twice with "
        f"remat): {extra} more launches of the step's {launched}")
    out["smollm"] = smollm
    del params, opt, m, b, prof, fn
    torch.cuda.empty_cache()

    for arch, steps, batch, seq, layers in TRAIN_FULL:
        cfg = dataclasses.replace(lm_configs.get(arch),
                                  n_layers=layers or lm_configs.get(arch).n_layers)
        zero_counts()
        params, opt, losses, rep = lm_train.train(arch, steps=steps, batch=batch, seq=seq,
                                                  reduced=False, log_every=1, device=dev,
                                                  n_layers=layers, return_report=True,
                                                  train_config=train_step.TrainConfig())
        for k, v in read_counts().items():
            launches[k] += v
        r = {"layers": cfg.n_layers, "params": cfg.param_count(), "batch": batch, "seq": seq,
             "losses": losses, "step_ms": rep["step_ms"],
             "peak_gib": (rep["peak_device_bytes"] or 0) / gib}
        if cfg.moe is not None:
            b = data.to_device(data.batch_for_step(
                cfg, data.DataConfig(seq_len=seq, global_batch=batch), steps), dev)
            with torch.no_grad():
                _, metrics = lm.lm_loss(params, cfg, b)
            r["aux"] = float(metrics["aux"])
            del b, metrics
        log(f"({'c' if cfg.moe is None else 'd'}) {arch} full width, {cfg.n_layers} layers "
            f"({r['params']:,} parameters), {steps} steps of {batch} x {seq}: losses "
            f"{[round(x, 4) for x in losses]}, step ms {[round(x, 1) for x in rep['step_ms']]}, "
            f"peak {r['peak_gib']:.2f} GiB" + (f", aux loss {r['aux']:.6f}" if "aux" in r else ""))
        if len(losses) != steps or not all(math.isfinite(x) for x in losses) or (
                "aux" in r and not math.isfinite(r["aux"])):
            fail(f"{arch} full-width training skipped a step or gave a non-finite loss: {r}")
        if r["peak_gib"] > TRAIN_PEAK_GIB:
            fail(f"{arch} full-width training peaked at {r['peak_gib']:.2f} GiB, over "
                 f"{TRAIN_PEAK_GIB} GiB")
        out[arch] = r
        del params, opt
        torch.cuda.empty_cache()
    log(f"kernel launches on the training path: {launches}")
    if any(launches.values()):
        fail(f"the training path launched a kernel of this repository: {launches}")
    out["launches"] = launches
    return out


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        from repro_torch.core import (charge, controller, fleet, perfmodel, profiler, stream,
                                      traces)
        from repro_torch.kernels import _build
        from repro_torch.kernels.charge_sweep import kernel as sweep_k
        from repro_torch.kernels.charge_sweep import ops as sweep_ops
        from repro_torch.kernels.flash_attention import kernel as fa_k
        from repro_torch.kernels.flash_decode import kernel as fd_k
        from repro_torch.kernels.latency_matmul import kernel as mm_k
        from repro_torch.kernels.replay_step import kernel as replay_k
        from repro_torch.kernels.rglru_scan import kernel as sc_k
        from repro_torch.kernels.replay_step import ops as replay_ops
        from repro_torch.launch import serve_fleet, trace_eval
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")

    dev = torch.device("cuda")
    counters = {"charge_sweep": sweep_k.charge_sweep_cuda,
                "replay_chunk": replay_k.replay_chunk_cuda,
                "accumulate": replay_k.accumulate_cuda,
                "flash_attention": fa_k.flash_attention_cuda,
                "latency_matmul": mm_k.matmul_cuda,
                "rglru_scan": sc_k.rglru_scan_cuda,
                "flash_decode": fd_k.flash_decode_cuda}
    altune_kernels = ("latency_matmul", "rglru_scan", "flash_decode")

    def zero_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in counters.items()}

    # ---- 1. card check and build -------------------------------------------
    phase("1. card check and build")
    smi = nvidia_smi()
    log(f"card: {smi} | torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("float32 matrix products must run in full float32 (TF32 off, precision "
             "'highest'): the LM checks hold the card to the CPU in float32")
    t0 = time.perf_counter()
    logs = _build.build(["charge_sweep", "replay_step", "accumulate", "flash_attention",
                         "latency_matmul", "rglru_scan", "flash_decode", "launch_probe"])
    log(f"kernels built in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name, out in logs.items():
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in out.splitlines() if "Used " in line})
        log(f"  {name}: ptxas {regs}")
    gen = torch.Generator(device=dev).manual_seed(0)

    # ---- 2. charge sweep: kernel vs plain ------------------------------------
    phase("2. charge sweep: kernel vs plain")
    fl = fleet.synthesize(gen, FULL_DIMMS, device=dev)
    boot_t = torch.tensor(BOOT_BINS, dtype=torch.float32, device=dev)[:, None, None]
    cells = charge.CellParams(*(a[None, None, :] for a in fl.cells))
    inv_boot, _ = sweep_ops.stacked_invariants(cells, boot_t)
    consts = charge.DEFAULT_CONSTANTS
    corner = charge.CellParams(*(torch.tensor([[[v]]], dtype=torch.float32, device=dev)
                                 for v in (consts.r_max, consts.c_min, 1.0)))
    inv_corner, _ = sweep_ops.stacked_invariants(
        corner, torch.tensor([45.0, 85.0, 95.0], device=dev)[:, None, None])
    inv_hot, _ = sweep_ops.stacked_invariants(cells, torch.tensor(95.0, device=dev))
    inv_worst = sweep_worst_case(inv_boot)
    n_boot = inv_boot.shape[1]
    stacks = {"boot": inv_boot, "JEDEC corner": inv_corner, "95 °C": inv_hot,
              "worst case": inv_worst,
              "mixed lanes": sweep_mixed_lanes(inv_boot, inv_hot, inv_worst, MIXED_CELLS)}
    scal = sweep_ops.kernel_scalars()
    n_grid = sweep_ops.ref.SEARCH_GRID_SIZES
    sweep_mism, sweep_err, plain_idx = {}, 0.0, {}
    for label, inv in stacks.items():
        got = sweep_k.charge_sweep_cuda(inv, scal)
        want = plain_idx[label] = sweep_k.charge_sweep_plain(inv, scal)
        torch.cuda.synchronize()
        sweep_mism[label] = int((got != want).sum())
        sweep_err = max(sweep_err, float((got - want).abs().max()))
    pinned = torch.tensor(n_grid, device=dev)[:, None] - 1
    log(f"charge sweep, kernel vs plain: index mismatches {sweep_mism} (corner cell at "
        f"45/85/95 °C: {plain_idx['JEDEC corner'].t().tolist()}; worst case pinned to "
        f"JEDEC everywhere: {bool((plain_idx['worst case'] == pinned).all())})")
    if any(sweep_mism.values()):
        fail(f"charge-sweep kernel disagrees with its plain version: {sweep_mism}")
    sweep_ms = cuda_ms(torch, lambda: sweep_k.charge_sweep_cuda(inv_boot, scal), 20)
    sweep_worst_ms = cuda_ms(torch, lambda: sweep_k.charge_sweep_cuda(inv_worst, scal), 20)
    sweep_plain_ms = cuda_ms(torch, lambda: sweep_k.charge_sweep_plain(inv_boot, scal), 3)
    invariants_ms = cuda_ms(torch, lambda: sweep_ops.stacked_invariants(cells, boot_t), 3)
    evals = {label: sweep_evaluations(torch, stacks[label], plain_idx[label], scal, n_grid)
             for label in ("boot", "worst case")}
    sweep_bound, sweep_by = bound_ms(
        n_boot * (inv_boot.shape[0] + sweep_k.N_SEARCHES) * 4, evals["boot"]["ops"])
    worst_bound, _ = bound_ms(
        n_boot * (inv_boot.shape[0] + sweep_k.N_SEARCHES) * 4, evals["worst case"]["ops"])
    log(f"charge sweep at {n_boot:,} cells: kernel {sweep_ms:.4f} ms, plain "
        f"{sweep_plain_ms:.3f} ms, bound {sweep_bound:.4f} ms ({sweep_by}); worst-case "
        f"stack {sweep_worst_ms:.4f} ms (bound {worst_bound:.4f} ms, its operations "
        f"implied by the plain indices); the invariants "
        f"(stacked_invariants) {invariants_ms:.4f} ms")
    # A model, not a count taken on the kernel: what the plain indices imply
    # if each search's loop is a branch and a warp runs to its slowest lane.
    for label, ev in evals.items():
        log(f"  {label} stack, implied by the plain indices (not counted on the kernel): "
            f"candidates a cell by search {ev['steps_by_search']}; "
            f"expf-and-division evaluations a cell, warp by warp: {ev['charge']:.2f} "
            f"stopping at the first pass, {ev['charge_latched']:.2f} with the tRAS "
            f"shortcut, {ev['charge_full']:.0f} walking the longest grid")
    del stacks, inv_worst, inv_hot, inv_corner, got, want, plain_idx

    # ---- 3. replay chunk: kernel vs plain ------------------------------------
    phase("3. replay chunk: kernel vs plain")
    table = serve_fleet.bootstrap_table(gen, REPLAY_DIMMS, device=dev)
    params = controller.ControllerParams()
    rscal = replay_ops.replay_scalars(table.temp_bins, params)
    ladder = []
    for e in table.temp_bins:
        g = e - params.guard_band_c
        ladder += [e, g, g - params.hysteresis_c,
                   float(np.nextafter(np.float32(g), np.float32(-np.inf)))]
    ladder = torch.tensor(sorted(ladder, reverse=True) * 3, dtype=torch.float32, device=dev)
    rand = torch.rand((300, REPLAY_DIMMS), generator=gen, device=dev) * 75.0 + 20.0
    temps = torch.cat([ladder[:, None].expand(-1, REPLAY_DIMMS), rand]).contiguous()
    errs = (torch.rand(temps.shape, generator=gen, device=dev) < ERROR_RATE).to(torch.uint8)
    stack_t = replay_ops.to_stack_t(table.stack)

    def fresh(n):
        st = replay_ops.to_state3(controller.init_state(n, table.n_bins, dev))
        occ = torch.zeros((table.n_bins + 1, n), dtype=torch.int32, device=dev)
        return (st, occ, torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros((replay_k.ROW_SLOTS, n), dtype=torch.float32, device=dev))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    replay_mism, replay_err, finals = 0, 0.0, []
    for c in CHUNKINGS:
        x = y = fresh(REPLAY_DIMMS)
        for s in range(0, temps.shape[0], c):
            tc, ec = temps[s:s + c].contiguous(), errs[s:s + c].contiguous()
            x = replay_k.replay_chunk_cuda(*x, stack_t, tc, ec, rscal)
            y = replay_k.replay_chunk_plain(*y, stack_t, tc, ec, rscal)
        torch.cuda.synchronize()
        mism = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(x, y))
        replay_mism += mism
        replay_err = max([replay_err] + [float((a.double() - b.double()).abs().max())
                                         for a, b in zip(x, y)])
        finals.append(x)
        log(f"replay chunk {c:>3}: {temps.shape[0]} steps × {REPLAY_DIMMS:,} DIMMs, "
            f"{mism} mismatching words, switches {int(x[2].sum()):,}, "
            f"fused {int(x[0][2].sum()):,}")
    chunk_inv = all(torch.equal(bits(a), bits(b))
                    for f in finals[1:] for a, b in zip(finals[0], f))
    if replay_mism or not chunk_inv:
        fail(f"replay-chunk kernel: {replay_mism} mismatching words vs plain, "
             f"chunking-invariant={chunk_inv}")

    # The emitting entry against the plain emit scan: rows, bins, switch and
    # fuse flags bitwise, its carry bitwise the plain one's and the
    # non-emitting entry's; rows also 4 bytes past a 16-byte boundary.
    emit_mism = {}
    for c, final in zip(CHUNKINGS, finals):
        for aligned in (True, False) if c < CHUNK else (True,):
            x = y = fresh(REPLAY_DIMMS)
            mism = {}
            for s in range(0, temps.shape[0], c):
                x, y, _, m = emit_chunk(torch, replay_k, x, y, stack_t,
                                        temps[s:s + c].contiguous(), errs[s:s + c].contiguous(),
                                        rscal, aligned)
                mism = {k: mism.get(k, 0) + v for k, v in m.items()}
            mism["carry"] = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(x, y))
            mism["carry vs non-emitting"] = sum(int((bits(a) != bits(b)).sum())
                                                for a, b in zip(x, final))
            key = f"chunk {c}" + ("" if aligned else ", rows 4 bytes off 16")
            emit_mism[key] = sum(mism.values())
            log(f"replay emit {key}: {temps.shape[0]} steps × {REPLAY_DIMMS:,} DIMMs, "
                f"mismatching words {mism}")
    if any(emit_mism.values()):
        fail(f"replay-chunk emitting entry disagrees with its plain version: {emit_mism}")

    big_table = fleet.sweep(fl, BOOT_BINS, (1.0,)).to_table()
    big_stack_t = replay_ops.to_stack_t(big_table.stack)
    big_scal = replay_ops.replay_scalars(big_table.temp_bins, params)
    big_temps = (torch.rand((CHUNK, FULL_DIMMS), generator=gen, device=dev) * 20.0 + 25.0)
    big_errs = torch.zeros((CHUNK, FULL_DIMMS), dtype=torch.uint8, device=dev)
    big_state = fresh(FULL_DIMMS)
    rag_temps = (torch.rand((RAGGED, FULL_DIMMS), generator=gen, device=dev) * 75.0 + 20.0)
    rag_errs = (torch.rand(rag_temps.shape, generator=gen, device=dev)
                < ERROR_RATE).to(torch.uint8)
    full_mism = {}
    # The serve path's fleet (16-byte copies), then one of 2^20 - 3 DIMMs
    # (views of the same data; the kernel's narrow copy path).
    for n_full in (FULL_DIMMS, FULL_DIMMS - UNALIGNED_CUT):
        x = y = fresh(n_full)
        stack_n = big_stack_t[:, :n_full].contiguous()
        for label, tc, ec in ((f"{CHUNK}-step", big_temps, big_errs),
                              (f"ragged {RAGGED}-step", rag_temps, rag_errs)):
            tc, ec = tc[:, :n_full].contiguous(), ec[:, :n_full].contiguous()
            x = replay_k.replay_chunk_cuda(*x, stack_n, tc, ec, big_scal)
            y = replay_k.replay_chunk_plain(*y, stack_n, tc, ec, big_scal)
            torch.cuda.synchronize()
            key = f"{label} × {n_full:,}"
            full_mism[key] = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(x, y))
            replay_err = max([replay_err] + [float((a.double() - b.double()).abs().max())
                                             for a, b in zip(x, y)])
            log(f"replay chunk at full width, {label} chunk × {n_full:,} DIMMs: "
                f"{full_mism[key]} mismatching words, switches {int(x[2].sum()):,}, "
                f"fused {int(x[0][2].sum()):,}")
        del x, y, stack_n, tc, ec
    replay_mism += sum(full_mism.values())
    if any(full_mism.values()):
        fail(f"replay-chunk kernel disagrees with its plain version at full width: {full_mism}")
    x = y = z = fresh(FULL_DIMMS)
    for label, tc, ec in ((f"{CHUNK}-step", big_temps, big_errs),
                          (f"ragged {RAGGED}-step", rag_temps, rag_errs)):
        x, y, _, m = emit_chunk(torch, replay_k, x, y, big_stack_t, tc, ec, big_scal)
        z = replay_k.replay_chunk_cuda(*z, big_stack_t, tc, ec, big_scal)
        m["carry"] = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(x, y))
        m["carry vs non-emitting"] = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(x, z))
        key = f"{label} × {FULL_DIMMS:,}"
        emit_mism[key] = sum(m.values())
        log(f"replay emit at full width, {label} chunk × {FULL_DIMMS:,} DIMMs (after the "
            f"{CHUNK}-step chunk's state for the ragged one): mismatching words {m}")
    del x, y, z
    if any(emit_mism.values()):
        fail(f"replay-chunk emitting entry disagrees with its plain version: {emit_mism}")
    replay_mism += sum(emit_mism.values())
    del rag_temps, rag_errs
    torch.cuda.empty_cache()
    replay_ms = cuda_ms(torch, lambda: replay_k.replay_chunk_cuda(
        *big_state, big_stack_t, big_temps, big_errs, big_scal), 10)
    replay_plain_ms = cuda_ms(torch, lambda: replay_k.replay_chunk_plain(
        *big_state, big_stack_t, big_temps, big_errs, big_scal), 1)
    big_out = replay_k.replay_chunk_cuda(*big_state, big_stack_t, big_temps, big_errs, big_scal)
    replay_bound, replay_by = bound_ms(
        replay_bytes(big_state, big_out, CHUNK, FULL_DIMMS),
        FULL_DIMMS * CHUNK * REPLAY_OPS_PER_STEP)
    # The emitting entry at the same shape, every decision written, between
    # two more timings of the non-emitting kernel.
    emit_bound, emit_by = bound_ms(
        replay_bytes(big_state, big_out, CHUNK, FULL_DIMMS)
        + FULL_DIMMS * CHUNK * EMIT_BYTES_PER_STEP, FULL_DIMMS * CHUNK * REPLAY_OPS_PER_STEP)
    del big_out
    emit_out = replay_k.Decisions.empty(CHUNK, FULL_DIMMS, dev)
    emit_ms = cuda_ms(torch, lambda: replay_k.replay_chunk_emit_cuda(
        *big_state, big_stack_t, big_temps, big_errs, big_scal, emit_out), 10)
    replay_again_ms = cuda_ms(torch, lambda: replay_k.replay_chunk_cuda(
        *big_state, big_stack_t, big_temps, big_errs, big_scal), 10)
    del emit_out
    emit_plain_ms = cuda_ms(torch, lambda: replay_k.replay_chunk_emit_plain(
        *big_state, big_stack_t, big_temps, big_errs, big_scal), 1)

    # Trace-eval's launch: chunk 1 × 65,536 DIMMs, device time per launch.
    step_state = fresh(REPLAY_DIMMS)
    st1, ste1 = temps[:1].contiguous(), errs[:1].contiguous()
    replay_step_ms = device_ms(torch, lambda: replay_k.replay_chunk_cuda(
        *step_state, stack_t, st1, ste1, rscal), REPLAY_STEP_LAUNCHES, "replay_")
    step_out = replay_k.replay_chunk_cuda(*step_state, stack_t, st1, ste1, rscal)
    replay_step_bound, replay_step_by = bound_ms(
        replay_bytes(step_state, step_out, 1, REPLAY_DIMMS), REPLAY_DIMMS * REPLAY_OPS_PER_STEP)
    log(f"replay chunk at 1 step × {REPLAY_DIMMS:,} DIMMs (trace-eval's launch): "
        f"{replay_step_ms:.5f} ms of device time a launch (torch.profiler, "
        f"{REPLAY_STEP_LAUNCHES} launches), bound {replay_step_bound:.5f} ms ({replay_step_by}; "
        f"its operands stay in L2 between launches)")
    del step_state, step_out
    host = torch.empty((CHUNK, FULL_DIMMS), dtype=torch.float32, pin_memory=True)
    h2d_ms = cuda_ms(torch, lambda: big_temps.copy_(host, non_blocking=True), 5)
    pageable = torch.full((CHUNK, FULL_DIMMS), 30.0)
    stage_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        host.copy_(pageable)
        stage_s.append(time.perf_counter() - t0)
    stage_ms = 1e3 * sum(stage_s) / len(stage_s)
    gb = host.numel() * 4 / 1e9
    log(f"replay chunk at {FULL_DIMMS:,} DIMMs × {CHUNK} steps: kernel {replay_ms:.4f} ms "
        f"(again after the emitting entry: {replay_again_ms:.4f} ms), plain "
        f"{replay_plain_ms:.3f} ms, bound {replay_bound:.4f} ms ({replay_by})")
    log(f"replay emitting entry at {FULL_DIMMS:,} DIMMs × {CHUNK} steps (rows, bins, switch "
        f"and fuse flags written): kernel {emit_ms:.4f} ms, plain {emit_plain_ms:.3f} ms, "
        f"bound {emit_bound:.4f} ms ({emit_by}; {EMIT_BYTES_PER_STEP} bytes a (DIMM, step) "
        f"written, {FULL_DIMMS * CHUNK * EMIT_BYTES_PER_STEP / emit_ms / 1e6:.1f} GB/s of "
        f"decisions)")
    log(f"ingest of that chunk's temperatures ({gb:.3f} GB): host staging copy into "
        f"pinned memory {stage_ms:.3f} ms ({gb / stage_ms * 1e3:.1f} GB/s, "
        f"{torch.get_num_threads()} threads), host→device copy {h2d_ms:.3f} ms "
        f"({gb / h2d_ms * 1e3:.1f} GB/s) = {h2d_ms / replay_ms:.1f}× the kernel")
    del host

    # Streaming chunks from pageable host memory, kernel included: the
    # engine's double buffer against a plain synchronous copy, in turns.
    t0 = time.perf_counter()
    ingestor = stream._Ingestor(FULL_DIMMS, dev, rows=CHUNK)
    torch.cuda.synchronize()
    reserve_ms = (time.perf_counter() - t0) * 1e3

    def stream_ms(double_buffer: bool) -> float:
        st = big_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(INGEST_CHUNKS):
            if double_buffer:
                tc, ec, slot = ingestor.stage(pageable, None)
            else:
                tc, ec, slot = pageable.to(dev), big_errs, None
            st = replay_k.replay_chunk_cuda(*st, big_stack_t, tc, ec, big_scal)
            ingestor.release(slot)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / INGEST_CHUNKS

    turns = [("plain .to", False), ("double buffer", True),
             ("double buffer", True), ("plain .to", False)]
    ingest_ms = {}
    for label, db in turns:
        ingest_ms.setdefault(label, []).append(stream_ms(db))
    log(f"streaming {INGEST_CHUNKS} full-width chunks from pageable host memory, ms per "
        f"chunk in turns {[(k, [round(v, 3) for v in vs]) for k, vs in ingest_ms.items()]}; "
        f"allocating the double buffer (two pinned + device slots, no error "
        f"buffers) took {reserve_ms:.3f} ms")
    del big_temps, big_errs, big_state, pageable, big_stack_t, big_table, ingestor

    # ---- 4. serve: small card-vs-CPU check, then the main path ---------------
    phase("4. serve: small card-vs-CPU check, then the main path")
    small_table = serve_fleet.bootstrap_table(gen, SMALL_DIMMS, device=dev)
    small_trace = (torch.rand((SMALL_STEPS, SMALL_DIMMS), generator=gen, device=dev)
                   * 60.0 + 20.0).cpu()
    small_errs = (torch.rand((SMALL_STEPS, SMALL_DIMMS), generator=gen, device=dev)
                  < ERROR_RATE).cpu()
    cpu_table = controller.DimmTimingTable(small_table.temp_bins, small_table.stack.cpu())
    svc_gpu = serve_fleet.FleetControllerService(small_table)
    svc_cpu = serve_fleet.FleetControllerService(cpu_table)
    for s in range(0, SMALL_STEPS, 64):
        svc_gpu.submit(small_trace[s:s + 64], small_errs[s:s + 64])
        svc_cpu.submit(small_trace[s:s + 64], small_errs[s:s + 64])
    pg, pc = svc_gpu.engine.partials, svc_cpu.engine.partials
    same = all(torch.equal(bits(a.cpu()), bits(b)) for a, b in zip(pg, pc))
    sg, sc = svc_gpu.running_score(), svc_cpu.running_score()
    score_err = max(abs(sg[k] - sc[k]) for k in sg)
    log(f"serve {SMALL_DIMMS} DIMMs × {SMALL_STEPS} steps, card vs CPU: partials "
        f"bitwise equal={same}, max score difference {score_err:.3e}")
    if not same or score_err > 1e-5:
        fail("the service on the card disagrees with the CPU reference")

    zero_counts()
    report = serve_fleet.serve(n_dimms=FULL_DIMMS, n_steps=SERVE_STEPS, chunk=CHUNK,
                               scenario="diurnal", error_rate=0.0, device=dev)
    launches = read_counts()
    score = report["score"]
    log(f"serve main path: {FULL_DIMMS:,} DIMMs × {SERVE_STEPS} steps in "
        f"{report['n_chunks']} chunks: wall {report['wall_s']:.3f} s, "
        f"{report['obs_per_s']:,.0f} obs/s, boot {report['boot_s']:.3f} s, service "
        f"setup (staging buffers) {report['setup_s']:.3f} s, score "
        f"{report['score_s']:.3f} s, peak device "
        f"memory {report['peak_device_bytes'] / 2**30:.2f} GiB, launches {launches}")
    log("score: " + json.dumps(score, sort_keys=True))
    if launches["charge_sweep"] < 1:
        fail("the main path never launched the charge-sweep kernel")
    if launches["replay_chunk"] != report["n_chunks"]:
        fail(f"replay-chunk launches {launches['replay_chunk']} != chunks {report['n_chunks']}")
    if launches["accumulate"] or launches["flash_attention"] or any(
            launches[k] for k in altune_kernels):
        fail(f"the serve main path launched kernels of other paths: {launches}")
    if not all(math.isfinite(v) for v in score.values()):
        fail("non-finite score figure")
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")
    boot = boot_split(torch, dev, serve_fleet, fleet, sweep_ops, profiler)
    log(f"serve boot split (bootstrap_table again, synchronized between parts): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in boot.items())
        + f"; the main path's boot_s {report['boot_s']:.4f} s")

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    traced = serve_fleet.serve(n_dimms=FULL_DIMMS, n_steps=SERVE_STEPS, chunk=CHUNK,
                               scenario="diurnal", error_rate=0.0, device=dev,
                               trace_path=os.path.join(out_dir, "serve_trace.json"))
    tr = traced["trace"]
    log(f"serve main path under torch.profiler: wall {traced['wall_s']:.3f} s, loop span "
        f"{tr['loop_s']:.3f} s, device busy {tr['device_busy_s'] * 1e3:.3f} ms "
        f"({tr['device_busy_frac'] * 100:.2f} %)")
    log("  device time by activity (s): " + json.dumps(tr["device_s_by_name"]))
    log("  host ops by self time: " + json.dumps(tr["host_self_s_top"]))

    # ---- 4b. serve with decisions: the main path, then its checks ---------------
    phase("4b. serve with decisions: the main path, then its checks")
    zero_counts()
    dec = serve_fleet.serve(n_dimms=FULL_DIMMS, n_steps=SERVE_STEPS, chunk=CHUNK,
                            scenario="diurnal", error_rate=0.0, device=dev, decisions=True)
    dec_launches = read_counts()
    log(f"serve with decisions: {FULL_DIMMS:,} DIMMs × {SERVE_STEPS} steps in "
        f"{dec['n_chunks']} chunks: wall {dec['wall_s']:.3f} s (without decisions "
        f"{report['wall_s']:.3f} s), loop peak device memory "
        f"{dec['loop_peak_device_bytes'] / 2**30:.2f} GiB, total_switches "
        f"{dec['total_switches']:,} (without decisions {report['total_switches']:,}), "
        f"launches {dec_launches}")
    want_l = dict.fromkeys(counters, 0) | {"charge_sweep": launches["charge_sweep"],
                                           "replay_chunk": dec["n_chunks"]}
    if dec_launches != want_l:
        fail(f"serve with decisions: launches {dec_launches}, expected {want_l}")
    if dec["score"] != report["score"] or dec["total_switches"] != report["total_switches"]:
        fail("serve with decisions: the score or the switch total differs from the day "
             "without decisions")
    # The same day through the service directly: every chunk with decisions
    # beside one without; the last chunk's decisions against controller.replay
    # of its steps from the state before them.
    chk_table = serve_fleet.bootstrap_table(gen, FULL_DIMMS, device=dev)
    day = traces.generate("diurnal", gen, FULL_DIMMS, SERVE_STEPS, device=dev).cpu()
    svc = serve_fleet.FleetControllerService(chk_table, chunk_steps=CHUNK)
    free = serve_fleet.FleetControllerService(chk_table, chunk_steps=CHUNK)
    last_start = (SERVE_STEPS - 1) // CHUNK * CHUNK
    for s in range(0, SERVE_STEPS, CHUNK):
        if s == last_start:
            before = svc.engine.state
        resp = svc.submit(day[s:s + CHUNK], decisions=True)
        free.submit(day[s:s + CHUNK])
    dec_same = {
        "state": sum(int((a != b).sum()) for a, b in zip(svc.engine.state, free.engine.state)),
        "partials": sum(int((bits(a) != bits(b)).sum())
                        for a, b in zip(svc.engine.partials, free.engine.partials)),
        "score": int(svc.running_score() != free.running_score())}
    last = controller.replay(chk_table, day[last_start:], state=before)
    for key in ("timings", "bin_idx", "switched"):
        dec_same[f"last chunk {key}"] = int((bits(resp[key]) != bits(getattr(last, key))).sum())
    log(f"serve with decisions, the day through the service ({SERVE_STEPS - last_start}-step "
        f"last chunk, {int(resp['total_switches']):,} switches): mismatches against the day "
        f"without decisions and the last chunk against controller.replay {dec_same}")
    if any(dec_same.values()):
        fail(f"serve with decisions disagrees with the day without them: {dec_same}")
    del svc, free, resp, last, before, day, chk_table
    # No host sync added to the loop. Its exact sign is the host's waits for
    # the device, counted in every profiled day and equal in all of them. The
    # device's busy share is the second sign: a sync a chunk would serialize
    # the host's staging copy with the device's work and cut the share by
    # about the device's part of the loop. The share moves from day to day
    # with the host's copy rate (the loop's span and its pinned copies both
    # follow it), so with decisions it may fall below the share without by
    # no more than twice the standard error of the difference of the means,
    # over eight profiled days in turns (without, with, with, without, twice).
    torch.cuda.empty_cache()
    traced_by = {False: [], True: []}
    turns = (False, True, True, False) * 2
    for i, with_dec in enumerate(turns):
        rep = serve_fleet.serve(n_dimms=FULL_DIMMS, n_steps=SERVE_STEPS, chunk=CHUNK,
                                scenario="diurnal", error_rate=0.0, device=dev,
                                decisions=with_dec, trace_path=os.path.join(
                                    out_dir, f"serve_trace_turn{i + 1}.json"))
        t = rep["trace"]
        traced_by[with_dec].append(t)
        log(f"serve {'with' if with_dec else 'without'} decisions under torch.profiler (turn "
            f"{i + 1} of {len(turns)}): wall {rep['wall_s']:.3f} s, loop span "
            f"{t['loop_s']:.3f} s, device busy {t['device_busy_s'] * 1e3:.3f} ms "
            f"({t['device_busy_frac'] * 100:.2f} %), host waits {t['host_syncs']}, setup "
            f"{rep['setup_s']:.3f} s")
        log("  device time by activity (s): " + json.dumps(t["device_s_by_name"]))
        log("  host ops by self time: " + json.dumps(t["host_self_s_top"]))
    fracs = {d: [t["device_busy_frac"] for t in ts] for d, ts in traced_by.items()}
    busy = {d: sum(v) / len(v) for d, v in fracs.items()}
    se = math.sqrt(sum(sum((x - busy[d]) ** 2 for x in v) / (len(v) - 1) / len(v)
                       for d, v in fracs.items()))
    waits = {d: [t["host_syncs"] for t in ts] for d, ts in traced_by.items()}
    spans = {d: sum(t["loop_s"] for t in ts) / len(ts) for d, ts in traced_by.items()}
    log(f"serve loop in turns, mean device busy share without / with decisions: "
        f"{busy[False] * 100:.2f} / {busy[True] * 100:.2f} % (standard error of the "
        f"difference {se * 100:.2f} points, least share allowed with decisions "
        f"{(busy[False] - 2 * se) * 100:.2f} %); mean loop span {spans[False]:.3f} / "
        f"{spans[True]:.3f} s ({spans[True] / spans[False]:.2f}×); host waits for the device "
        f"{waits[False]} / {waits[True]}")
    if len(set(waits[False] + waits[True])) != 1:
        fail("the serve loop with decisions waits on the device more often than without: "
             "a host sync in the loop")
    if busy[True] < busy[False] - 2 * se:
        fail("the serve loop with decisions keeps the device busy a smaller share of the "
             "time than without, by more than twice the standard error: a host sync in "
             "the loop?")
    del rep, traced_by

    # ---- 5. accumulate: kernel vs plain ---------------------------------------
    phase("5. accumulate: kernel vs plain")
    n_bins = len(controller.DEFAULT_TEMP_BINS)
    acc_timings = torch.empty((EVAL_STEPS, EVAL_DIMMS, 2, 4), dtype=torch.float32, device=dev)
    for s in range(0, EVAL_STEPS, 1000):
        acc_timings[s:s + 1000] = torch.randint(
            8, 29, (min(1000, EVAL_STEPS - s), EVAL_DIMMS, 2, 4), generator=gen, device=dev,
            dtype=torch.int32).to(torch.float32) * 1.25
    acc_bins = torch.randint(0, n_bins + 1, (EVAL_STEPS, EVAL_DIMMS), generator=gen,
                             device=dev, dtype=torch.int32)
    acc_sw = (torch.rand((EVAL_STEPS, EVAL_DIMMS), generator=gen, device=dev)
              < 0.01).view(torch.uint8)
    acc_in = (torch.randint(0, 1000, (EVAL_DIMMS, n_bins + 1), generator=gen, device=dev,
                            dtype=torch.int32),
              torch.randint(0, 1000, (EVAL_DIMMS,), generator=gen, device=dev,
                            dtype=torch.int32),
              torch.randint(0, 4000, (EVAL_DIMMS, 2, 4), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.float32) * 1.25)
    acc_args = (*acc_in, acc_timings, acc_bins, acc_sw)
    got = replay_k.accumulate_cuda(*acc_args)
    want = replay_k.accumulate_plain(*acc_args)
    torch.cuda.synchronize()
    acc_mism = {"full": sum(int((bits(a) != bits(b)).sum()) for a, b in zip(got, want))}
    acc_err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    del got, want
    acc_ms = cuda_ms(torch, lambda: replay_k.accumulate_cuda(*acc_args), 5)
    acc_plain_ms = cuda_ms(torch, lambda: replay_k.accumulate_plain(*acc_args), 1)
    acc_sum_ms = cuda_ms(torch, lambda: torch.sum(acc_timings, dim=0), 5)
    pairs = EVAL_STEPS * EVAL_DIMMS
    acc_bound, acc_by = bound_ms(
        pairs * (32 + 4 + 1) + 2 * EVAL_DIMMS * ((n_bins + 1) * 4 + 4 + 32),
        pairs * ACCUMULATE_OPS_PER_STEP)
    log(f"accumulate at {EVAL_DIMMS:,} DIMMs × {EVAL_STEPS:,} steps: {acc_mism['full']} "
        f"mismatching words; kernel {acc_ms:.4f} ms, plain {acc_plain_ms:.3f} ms, "
        f"torch.sum(timings, dim=0) alone {acc_sum_ms:.4f} ms, bound {acc_bound:.4f} ms "
        f"({acc_by})")
    del acc_args, acc_timings, acc_bins, acc_sw, acc_in
    torch.cuda.empty_cache()

    rag_table = serve_fleet.bootstrap_table(gen, RAGGED_ACC_DIMMS, device=dev)
    rag_temps = torch.rand((RAGGED_ACC_STEPS, RAGGED_ACC_DIMMS), generator=gen,
                           device=dev) * 75.0 + 20.0
    rag_errs = torch.rand(rag_temps.shape, generator=gen, device=dev) < ERROR_RATE
    rag = controller.replay(rag_table, rag_temps, rag_errs)
    zero = perfmodel.trace_score_init(RAGGED_ACC_DIMMS, rag_table.n_bins, dev)
    rag_args = (zero.occupancy, zero.switches, zero.timing_sums, rag.timings, rag.bin_idx,
                rag.switched.view(torch.uint8))
    got = replay_k.accumulate_cuda(*rag_args)
    want = replay_k.accumulate_plain(*rag_args)
    torch.cuda.synchronize()
    acc_mism["ragged"] = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(got, want))
    occ_cols = [int(c) for c in got[0].sum(dim=0).tolist()]
    log(f"accumulate on a card replay of {RAGGED_ACC_DIMMS:,} DIMMs × {RAGGED_ACC_STEPS} "
        f"steps: {acc_mism['ragged']} mismatching words; steps per effective bin "
        f"{occ_cols} (last = JEDEC), switches {int(got[1].sum()):,}, fused "
        f"{int(rag.state.fused.sum()):,}")
    if any(acc_mism.values()):
        fail(f"accumulate kernel disagrees with its plain version: {acc_mism}")
    if min(occ_cols) == 0:
        fail("the ragged accumulate check did not reach every effective bin")

    # ---- 6. card step vs plain step -------------------------------------------
    phase("6. card step vs plain step")
    step_temps = torch.cat([ladder[:, None].expand(-1, REPLAY_DIMMS),
                            torch.rand((STEP_CHECK_STEPS - ladder.shape[0], REPLAY_DIMMS),
                                       generator=gen, device=dev) * 75.0 + 20.0]).contiguous()
    step_errs = torch.rand(step_temps.shape, generator=gen, device=dev) < ERROR_RATE
    on_card = controller.replay(table, step_temps, step_errs)
    edges = torch.tensor(table.temp_bins, dtype=torch.float32, device=dev)
    st = controller.init_state(REPLAY_DIMMS, table.n_bins, dev)
    plain_hist = {k: [] for k in ("timings", "bin_idx", "switched", "fused")}
    for k in range(STEP_CHECK_STEPS):
        st, rows, sw, eff = controller.step_plain(table.stack, edges, params, st,
                                                  step_temps[k], step_errs[k])
        for key, v in (("timings", rows), ("bin_idx", eff), ("switched", sw),
                       ("fused", st.fused)):
            plain_hist[key].append(v)
    torch.cuda.synchronize()
    step_mism = {key: int((bits(getattr(on_card, key)) != bits(torch.stack(v))).sum())
                 for key, v in plain_hist.items()}
    step_mism["state"] = sum(int((a != b).sum()) for a, b in zip(on_card.state, st))
    # controller.step on the card: the emitting entry at chunk 1, every step.
    st_k = controller.init_state(REPLAY_DIMMS, table.n_bins, dev)
    step_mism["step"] = 0
    for k in range(STEP_CHECK_STEPS):
        st_k, rows, sw, eff = controller.step(table.stack, edges, params, st_k,
                                              step_temps[k], step_errs[k])
        step_mism["step"] += sum(int((bits(a) != bits(b[k])).sum()) for a, b in (
            (rows, on_card.timings), (eff, on_card.bin_idx), (sw, on_card.switched),
            (st_k.fused, on_card.fused)))
    step_mism["step"] += sum(int((a != b).sum()) for a, b in zip(st_k, st))
    log(f"card replay ({replay_launches(STEP_CHECK_STEPS)} launch(es) of the emitting entry) "
        f"and card step (the emitting entry at chunk 1, every step) vs plain step, "
        f"{REPLAY_DIMMS:,} DIMMs × {STEP_CHECK_STEPS} steps: mismatches {step_mism}, switches "
        f"{on_card.total_switches:,}, fused {int(st.fused.sum()):,}")
    if any(step_mism.values()):
        fail(f"the card's step disagrees with the plain step: {step_mism}")
    del on_card, plain_hist, step_temps, step_errs

    # ---- 7. trace-eval: card vs CPU --------------------------------------------
    phase("7. trace-eval: card vs CPU")
    small_kw = dict(scenario="refresh_storm", error_rate=ERROR_RATE, verbose=False)
    card = trace_eval.run(n_dimms=EVAL_SMALL_DIMMS, n_steps=EVAL_SMALL_STEPS, device=dev,
                          **small_kw)
    host = trace_eval.run(device="cpu", table=card["table"].to("cpu"),
                          trace=card["trace"].cpu(), errors=card["errors"].cpu(), **small_kw)
    hist_same = all(torch.equal(bits(getattr(card["replay"], k).cpu()),
                                bits(getattr(host["replay"], k)))
                    for k in ("timings", "bin_idx", "switched", "fused"))
    hist_same &= all(torch.equal(a.cpu(), b) for a, b in zip(card["replay"].state,
                                                            host["replay"].state))
    part_same = all(torch.equal(bits(a.cpu()), bits(b))
                    for a, b in zip(card["partials"], host["partials"]))
    eval_err = max(abs(card["score"][k] - host["score"][k]) for k in host["score"])
    log(f"trace-eval {EVAL_SMALL_DIMMS:,} DIMMs × {EVAL_SMALL_STEPS} steps, card vs CPU: "
        f"history bitwise equal={hist_same}, partials bitwise equal={part_same}, max "
        f"score difference {eval_err:.3e}, fused {int(card['replay'].state.fused.sum())}")
    if not (hist_same and part_same) or eval_err > 1e-5 or set(card["score"]) != set(host["score"]):
        fail("trace-eval on the card disagrees with the CPU reference")
    del card, host

    # ---- 8. trace-eval main path -------------------------------------------------
    phase("8. trace-eval main path")
    eval_launches = {}
    for scenario in EVAL_SCENARIOS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        rep = trace_eval.run(n_dimms=EVAL_DIMMS, n_steps=EVAL_STEPS, scenario=scenario,
                             refresh="ddr3", error_rate=0.0, device=dev)
        wall = time.perf_counter() - t0
        got_l = read_counts()
        eval_launches[scenario] = got_l
        sc = rep["score"]
        log(f"trace-eval main path, {scenario}: {EVAL_DIMMS:,} DIMMs × {EVAL_STEPS:,} steps, "
            f"run {wall:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {got_l}")
        log(f"  scan_seconds {rep['scan_s']:.6f}, loop_equivalence_exact "
            f"{rep['loop_exact']}, speedup_realized_intensive_mean "
            f"{sc['speedup_realized_intensive_mean']:.6f}, speedup_combined_intensive_mean "
            f"{sc['speedup_combined_intensive_mean']:.6f}, refresh_occupancy_mean "
            f"{sc['refresh_occupancy_mean']:.6f}, switches_total {sc['switches_total']:.0f}")
        log("  rows: " + json.dumps({name: value for name, value, _ in rep["rows"]}))
        want_l = {name: 0 for name in counters}
        want_l.update(charge_sweep=1, accumulate=1, replay_chunk=2 * replay_launches(
            EVAL_STEPS) + replay_launches(EVAL_LOOP_STEPS))
        if got_l != want_l:
            fail(f"trace-eval {scenario}: launches {got_l}, expected {want_l} (two "
                 f"replays of {EVAL_STEPS} steps and the {EVAL_LOOP_STEPS}-step sub-grid)")
        if not rep["loop_exact"] or not all(math.isfinite(v) for v in sc.values()):
            fail(f"trace-eval {scenario}: loop equivalence or a non-finite figure")
        del rep
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # Where a replay step's time goes: a short window of the same replay
    # under torch.profiler (not counted as the main path's launches).
    from torch.profiler import ProfilerActivity, profile, record_function

    prof_table = controller.DimmTimingTable(
        controller.DEFAULT_TEMP_BINS, torch.full((EVAL_DIMMS, len(controller.DEFAULT_TEMP_BINS),
                                                  2, 4), 12.5, device=dev))
    prof_temps = torch.rand((PROFILED_STEPS, EVAL_DIMMS), generator=gen, device=dev) * 75 + 20
    per_step = replay_ops.StepKernel(prof_table.stack, prof_table.temp_bins, params)

    def step_loop():
        st = controller.init_state(EVAL_DIMMS, prof_table.n_bins, dev)
        for k in range(PROFILED_STEPS):
            st = per_step(st, prof_temps[k])[0]

    # One launch a step (the card's controller.step, the shape of a per-step
    # loop) against controller.replay.
    for label, run in (("one launch a step (controller.step)", step_loop),
                       (f"controller.replay ({replay_launches(PROFILED_STEPS)} launch(es))",
                        lambda: controller.replay(prof_table, prof_temps))):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("replay_window"):
                run()
                torch.cuda.synchronize()
        tr = serve_fleet._trace_summary(prof, range_name="replay_window")
        log(f"replay of {EVAL_DIMMS:,} DIMMs × {PROFILED_STEPS} steps, {label}, under "
            f"torch.profiler: span {tr['loop_s']:.4f} s "
            f"({tr['loop_s'] / PROFILED_STEPS * 1e6:.2f} µs a step), device busy "
            f"{tr['device_busy_s'] * 1e3:.3f} ms ({tr['device_busy_frac'] * 100:.2f} %)")
        log("  device time by activity (s): " + json.dumps(tr["device_s_by_name"]))
        log("  host ops by self time: " + json.dumps(tr["host_self_s_top"]))
    del prof_table, prof_temps, per_step

    # controller.replay's launch size: the whole trace in one launch against
    # a fixed chunk, in turns, at the trace-eval width (history written in place).
    torch.cuda.empty_cache()
    hist = replay_ops.Decisions.empty(EVAL_STEPS, EVAL_DIMMS, dev)
    ch_temps = torch.rand((EVAL_STEPS, EVAL_DIMMS), generator=gen, device=dev) * 75 + 20
    st0 = controller.init_state(EVAL_DIMMS, table.n_bins, dev)
    chunk_ms = {}
    for ch in REPLAY_CHUNK_CHOICES + REPLAY_CHUNK_CHOICES[::-1]:
        chunk_ms.setdefault(str(ch), []).append(cuda_ms(torch, lambda: replay_ops.replay_history(
            table.stack, table.temp_bins, params, st0, ch_temps, None, hist, ch), 3))
    replay_hist_bound, _ = bound_ms(EVAL_STEPS * EVAL_DIMMS * (4 + EMIT_BYTES_PER_STEP), 0)
    log(f"controller.replay's launches at {EVAL_DIMMS:,} DIMMs × {EVAL_STEPS:,} steps, ms in "
        f"turns by steps a launch (None: the whole trace): "
        f"{ {k: [round(v, 4) for v in vs] for k, vs in chunk_ms.items()} }; bound "
        f"{replay_hist_bound:.4f} ms (bytes: temperatures read, decisions written); "
        f"REPLAY_CHUNK_STEPS = {replay_ops.REPLAY_CHUNK_STEPS}")
    del hist, ch_temps, st0

    # ---- 9-11. flash attention and the LM serving paths --------------------------
    phase("9-11. flash attention and the LM serving paths")
    torch.cuda.empty_cache()
    fa = flash_attention_phase(torch, dev, gen, fa_k)
    lm_card_vs_cpu_phase(dev)
    lm = lm_main_path_phase(torch, dev, zero_counts, read_counts)
    families = lm_families_phase(torch, dev, zero_counts, read_counts)
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # ---- 12-14. the altune kernels, the tile gate, the altune main path ----------
    phase("12-14. the altune kernels, the tile gate, the altune main path")
    torch.cuda.empty_cache()
    mm = latency_matmul_phase(torch, dev, gen)
    sc = rglru_scan_phase(torch, dev, gen)
    fd = flash_decode_phase(torch, dev, gen)
    gate_phase(torch)
    launch_overheads(torch, dev)
    alt_launches = altune_main_path_phase(torch, dev, zero_counts, read_counts, out_dir)
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # ---- 15. the profiling path --------------------------------------------------
    phase("15. the profiling path")
    prof_launches = profiling_phase(torch, dev, zero_counts, read_counts)
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # ---- 16. the region path ----------------------------------------------------
    phase("16. the region path")
    reg = regions_phase(torch, dev, zero_counts, read_counts)
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # ---- 18. the sharded path --------------------------------------------------
    phase("18. the sharded path")
    shard_launches = sharded_phase(torch, dev, score, int(report["total_switches"]))
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # ---- 19. the experts ---------------------------------------------------------
    phase("19. the experts")
    experts = moe_phase(torch, dev, zero_counts, read_counts)
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # ---- 20. training -------------------------------------------------------------
    phase("20. training")
    training = train_phase(torch, dev, zero_counts, read_counts)
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # ---- 21. sharded training -------------------------------------------------
    phase("21. sharded training")
    sharded_training = sharded_train_phase(torch, dev)
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # ---- 22. the cost model, the dry run and the step tuner ---------------------
    phase("22. the cost model, the dry run and the step tuner")
    cost_model = cost_model_phase(torch, dev, zero_counts, read_counts, training)
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    # ---- 17. summary -----------------------------------------------------------
    phase("17. summary")
    by_path = {"serve": launches, "serve_decisions": dec_launches, "trace_eval": {
        k: sum(v[k] for v in eval_launches.values()) for k in counters},
        "lm_serve": lm["launches"],
        **{f"lm_serve/{arch}": fam["launches"] for arch, fam in
           {**families, **experts}.items()},
        "altune": alt_launches, "profile": prof_launches,
        "regions": reg["launches"], "sharded": shard_launches, "train": training["launches"],
        "sharded_train": sharded_training["launches"], "cost_model": cost_model["launches"]}

    def counted(name: str) -> dict:
        """Launches of one kernel on each main path, as read around it."""
        return {"launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {path: p[name] for path, p in by_path.items()}}

    kernels = [
        {"name": "charge_sweep", "route": "cuda",
         "source": "src/repro_torch/csrc/charge_sweep.cu",
         "replaces": "src/repro/kernels/charge_sweep/kernel.py:96",
         **counted("charge_sweep"), "mismatches": sum(sweep_mism.values()),
         "max_abs_err": sweep_err, "ms": sweep_ms, "plain_ms": sweep_plain_ms,
         "bound_ms": sweep_bound, "bound_by": sweep_by, "library_ms": None,
         "worst_case_ms": sweep_worst_ms, "invariants_ms": invariants_ms,
         "regions_ms": reg["regions_ms"], "regions_bound_ms": reg["regions_bound_ms"],
         "regions_cells": reg["regions_cells"]},
        {"name": "replay_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/replay_step.cu",
         "replaces": "src/repro/kernels/replay_step/kernel.py:92",
         **counted("replay_chunk"), "mismatches": replay_mism + sum(step_mism.values()),
         "max_abs_err": replay_err, "ms": replay_ms, "plain_ms": replay_plain_ms,
         "bound_ms": replay_bound, "bound_by": replay_by, "library_ms": None,
         "chunk1_ms": replay_step_ms, "chunk1_bound_ms": replay_step_bound,
         "emit_ms": emit_ms, "emit_bound_ms": emit_bound, "emit_plain_ms": emit_plain_ms},
        {"name": "accumulate", "route": "cuda",
         "source": "src/repro_torch/csrc/accumulate.cu",
         "replaces": "src/repro/kernels/replay_step/kernel.py:240",
         **counted("accumulate"), "mismatches": sum(acc_mism.values()),
         "max_abs_err": acc_err, "ms": acc_ms, "plain_ms": acc_plain_ms,
         "bound_ms": acc_bound, "bound_by": acc_by, "library_ms": None,
         "sum_alone_ms": acc_sum_ms},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:35",
         **counted("flash_attention"), **fa},
        {"name": "latency_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/latency_matmul.cu",
         "replaces": "src/repro/kernels/latency_matmul/kernel.py:29",
         **counted("latency_matmul"), **mm},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:25",
         **counted("rglru_scan"), **sc},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/kernel.py:28",
         **counted("flash_decode"), **fd},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # a failure outside fail(): name the phase on both streams
        import traceback

        traceback.print_exc()
        fail(f"{type(e).__name__}: {e}")
