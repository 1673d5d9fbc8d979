#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py          # one CUDA device, from the repo root

1. prints the card's name and power limit (nvidia-smi);
2. builds the six CUDA kernels, with the eight quantized branches of three
   of them, from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
   all started together, on a thread of its own while phases 20-22 and
   phase 24's train half, which launch no kernel, run on the card), and
   prints ptxas's report of each source (registers, shared memory,
   spills);
3. holds each kernel and each quantized branch (``segment_build`` under
   int8 / fp8 / int8+kv / fp8+kv, ``fused_synopsis_score_attention`` and
   ``block_gather_attention`` on int8 / fp8 tables or cache) against its
   plain PyTorch version at the shapes of the serving paths (llama3-8b,
   B=2, prompt 8192), in bf16 and f32, and times both with CUDA events
   (median of 20) and the profiler (the rows of the kernel's own launches,
   KERNEL_ROWS), beside the kernel's bound (the larger of bytes / 3.35
   TB/s and operations / peak rate) and, for prefill and decode,
   ``F.scaled_dot_product_attention`` as a yardstick; for the bf16
   ``flash_prefill`` (wgmma) also its achieved TFLOP/s; the three decode
   kernels (``flash_decode``, ``block_gather_attention``,
   ``fused_synopsis_score_attention``) also L2-cold (256 MB written and
   read back between calls), and ``flash_decode`` over the I * C rows that
   ``block_gather`` reads, as the gather's yardstick; stage 1 and
   ``synopsis_score`` also at M = 1024 (stage 1's chunks and their merge;
   the score kernel's time beside its bound, warm and L2-cold), and each
   ``segment_build`` branch's share of its bound;
4. on a small model in f32, checks that the kernels and the plain
   versions generate the same token ids in synopsis mode (unquantized and
   under each quant spec) and in exact mode, and that a synopsis step at
   full budget equals the exact step;
5. drives the synopsis serving loop (``repro_torch.launch.serve.run``) at
   full llama3-8b width and depth with random weights: prefill, synopsis
   build, 130 decode steps budgeted by the deadline controller (one absorb
   of the 128-token ring); checks finite logits of the right shape and
   full-budget synopsis decode equal to exact attention on one layer, and
   profiles three decode steps at budgets 0 and 32 (torch.profiler: wall
   time, device busy time and the kernels that take it);
6. runs the loop again with budget 32 on every step: the decode baseline,
   whose work per step does not follow the host clock; then the same on
   the quantized arena under int8+kv and fp8+kv (quantized build, decode
   and absorb), each with its peak memory and a profiled window;
7. runs the exact baseline (``mode="exact"``, 130 steps over the whole
   prompt cache) and profiles three of its steps;
8. on that prompt cache and its synopsis (unquantized and under each quant
   spec), the accuracy of synopsis decode against exact per budget
   (total-variation distance of the next-token distributions, argmax
   match; random weights, so not the paper's numbers) and the full-budget
   deviation from exact attention on layer 0 (below 7% relative L2); the
   unfused synopsis op against the fused one on layer 0;
9. stage 1's bytes against its time (warm and L2-cold), bf16 against
   int8 / fp8 tables, at M = 64 and 1024;
10. the continuous-batching engine (``repro_torch.serve.engine``), whose
    decode steps replay one captured CUDA graph per budget bucket: on a
    small f32 model the same ids on the card (graphs, kernels) as on the
    CPU (eager, plain versions), under ``fixed`` and ``basic``; at full
    llama3-8b width (4 slots, prompt 8192, 32 new tokens) every warm
    bucket captured, each bucket's replayed step against the same step
    called eagerly on the same pool (host ms, CUDA-event ms, device busy ms
    from the profiler, bitwise-equal outputs, the kernels' rows inside the
    replays), one Poisson trace under ``accuracytrader`` and under
    ``basic`` on the same arrivals (request latency, accuracy loss, misses,
    budgets, goodput, admission time, peak memory), and one simulator
    window on the measured step table (``MeasuredStepBackend``);
11. the rest of the single-device engine at the same width: the contracts
    (an estimator fit from fixed-budget ``deadline_with_bound`` windows,
    then the Poisson window under ``error_bounded`` and
    ``deadline_with_bound``; the budget-32 replay with the coverage
    profile beside the ``deadline`` replay, whose device-op count must stay
    within 4 of the engine's 3631 / 3663 / 3695 a bucket,
    ``check_deadline_replay_ops``), queue-aware admission (EDF, two SLO classes,
    shedding, twice the rate), the corpus cache (a 100%-repeat window with
    the cache on and off: hits launch neither prefill nor build, the same
    ids; a Zipf window; delta replay of a 4096-token prefix's
    8192-token extension, its KV held against the full prefill's), and the
    loop's ``--batches 2`` serial against ``--pipeline``;
11b. the scatter-gather cluster tier on its stacked path
    (``repro_torch.serve.cluster``, ``[cluster]``) on the same weights,
    N = 4 components over the engine phase's prompt (M = 64), budget 32:
    one decode step's layer-0 attention in f32 and bf16, kernels against
    their plain versions (alloc topk with every component FULL, also
    against the single-component synopsis attention; every component
    DROP, also against flash_decode over the ring and the self token; a
    FULL/STAGE1/DROP mix under alloc mass at skew 0 and 1.2), with the
    records ``<kernel>[cluster]`` of stage 1 over B*N folded rows, stage 2
    over the m_max*C-row shards and flash_decode over the extras; the
    budget-32 step of a cluster engine beside the single-component one
    (replay bitwise equal to its eager call, host / event / device busy
    ms, stage 1 and stage 2 launched once a layer, the step's copies no
    more than the query's N-fold repeat and the score table: no shard is
    copied); three Poisson windows (``--cluster 4`` under accuracytrader
    and basic; skew 1.2, rotate, R = 2 and a crash of component 1 at step
    8 under accuracytrader) with p50 / p99, loss, misses, fault counters,
    availability and the measured per-component ms at full budget; and
    the SMOKE cluster engine's ids on the card against the CPU under
    basic and fixed;
11c. the fleet tier on its stacked path (``repro_torch.serve.fleet``,
    ``[fleet]``) on the same weights, N = 4 components x R = 2 replica
    rows: layer-0 fleet attention in f32 and bf16 under random replica
    selections, kernels against their plain versions and every output
    bitwise equal to the all-primary one (records ``<kernel>[fleet]``:
    stage 2 reads the selected lanes through its row map); the budget-32
    fleet step beside the cluster step (replay bitwise equal to its eager
    call and unmoved by the selection, host / event / device busy ms and
    ops, stage 1 and stage 2 once a layer, no aten copy, gathers
    included, as large as a shard); the engine window under ``--fleet
    --cluster 4 --replicas 2`` under accuracytrader and basic (p50 / p99,
    loss, misses, the steps that read a replica other than the primary,
    per-component ms at full budget, peak memory); ``--autoscale`` over
    the 24 Sogou hours from that window's measured export (host only);
    and the SMOKE fleet engine's ids on the card against the CPU under
    basic and fixed;
12-14. the other architectures at their published width, depth cut to
    keep the script in its limit (``DEPTH``), random bf16 weights from
    seed 0, each after the previous model's weights are freed: gemma2-2b
    (8 of its 26 layers alternating local, window 4096, and global;
    softcaps; sandwich norms; tied embeddings; hd 256), smollm-135m (10 of
    30 layers, 9/3 heads of 64: G = 3, which the kernels pad to a bucket
    of 4; tied embeddings) and pixtral-12b (the mistral-nemo backbone, 10
    of 40 layers, 32/8 heads of 128, and the vision stub).  Each phase: the SMOKE loop in f32 on the card against the CPU
    (the same ids, every step's logits; gemma2 under its table-only int8 /
    fp8 specs), each kernel of its path against its plain version at its
    shapes (records ``<kernel>[gemma2]`` / ``[smollm]`` / ``[pixtral]``;
    SDPA as the library time for prefill and exact decode where there is
    no softcap, a yardstick where there is; gemma2's ``flash_prefill`` also
    on a local layer and its ``flash_decode`` on the local window's
    strided view), the budget-32 loop (130 steps, one absorb: prefill /
    build ms, p50 / p99, peak memory, a profiled window's device busy
    share) with every branch's exact launch count, the full-budget
    deviation on the first global layer, gemma2's budget-32 loop under
    int8 and fp8 (tables only) and their full-budget deviation on a global
    layer (< 7%), the exact loop, one step per budget against exact,
    pixtral's prefix prefill (256 patch embeddings and 7936 tokens, the
    build, a step at budget M against an exact step on that cache), the
    unfused op, and one engine window under ``accuracytrader`` and
    ``basic``;
15. whisper-medium the same way (``[whisper]``: the encoder's 24 layers
    and 8 of the decoder's 24, d 1024, 16/16 heads of 64, G = 1, d_ff
    4096, vocab 51865, untied): the SMOKE loops card against CPU in synopsis and exact mode and
    under int8+kv, its kernels at its shapes (and ``flash_decode`` over
    the 1500 encoder frames, ``flash_decode[whisper-cross1500]``), the
    budget-32 and exact loops (no frames, as in the JAX loop: the cross
    blocks read the decoder's own 8192 rows), the encoder prefill (1500
    seeded frames, the encoder timed alone, a step at budget M against
    exact on that cache), the unfused op, and the engine's refusal (the
    JAX engine fails on whisper; no window);
16. jamba-v0.1-52b at full width with its depth cut to 8 of 32 layers
    (``[jamba]``, ``DEPTH``: 1 of its 4 eight-layer superblocks; the whole
    model does not fit one card, 16 layers would, ~52 GB): mamba
    (SSD) layers, one attention layer in eight (llama3-8b's heads, G = 4
    at D = 128), an MoE FFN (16 experts, top 2) on every other layer.
    The same as 12-14: the SMOKE loops card against CPU (synopsis,
    exact), its kernels at its shapes (records ``<kernel>[jamba]``), the
    budget-32 and exact loops with exact launch counts (the kernels run on
    its attention layer only), the full-budget deviation on its
    attention layer, one step per budget against exact, the unfused op,
    and the engine window under ``accuracytrader`` and ``basic`` with each
    step's change of the slots' SSM state (a state not written back shows
    as 0 and fails the phase);
17-18. arctic-480b at full width with its depth cut to 2 of 35 layers
    (``[arctic]``: 56/8 heads of 128, G = 7 in the kernels' head bucket of
    8; an MoE of 128 experts of 4864, top 2, with a dense MLP beside it on
    every layer, ~27.7B parameters) and command-r-plus-104b at full width
    with its depth cut to 3 of 64 (``[command-r]``: 96/8 heads of 128,
    G = 12 in the bucket of 16, flash_prefill's 128 rows as 10 positions
    of 12 heads; parallel attention and FFN blocks, tied 256000-token
    embeddings; 12 layers, ~22.0B parameters, would fit), ``DEPTH``: the
    same as 12-14, the
    loops at budget 32 (``LOOP_BUDGET``: command-r's published i_max is
    64 = M);
19. deepseek-v2-236b at full width with its depth cut to 3 of 60 layers
    (``[deepseek]``, ``DEPTH``: MLA with one latent key/value head of
    kv_lora + rope = 576 read by 128 query heads, an MoE of 160 experts
    of 1536, top 6, with 2 shared experts on every layer, vocab 102400
    untied; 3 layers: ~13.0B parameters, ~26.9 GB with the f32
    unembedding): the
    same as 12-14, with the SMOKE engine card against CPU beside the
    loops, its kernels at MLA's shapes (``check_mla_kernels``:
    ``flash_prefill`` bf16 at D = 192 with G = 1 and SDPA beside it; the
    latent core's four decode kernels with an f32 query over bf16 latent
    rows, SDPA beside ``flash_decode`` naming its backend), the loops'
    launches on the latent branches only; and every quant spec on the
    latent core's quantized branches (``check_mla_quant_kernels``: the
    build's flushes at D = 576, stage 1 on int8 / fp8 tables and stage 2
    on an int8 / fp8 cache against their plain versions, warm and L2-cold,
    records ``<branch>[deepseek]``; the SMOKE int8+kv loop card against
    CPU; the budget-32 loops under int8+kv and fp8+kv with exact launch
    counts on the "latent-int8" / "latent-fp8" branches, a profiled
    window each; one step under int8 and under fp8; the full-budget
    deviation on layer 0 under all four, ``run_mla_quant``);
20. mamba2-370m at full width and depth (``[mamba2]``, 48 SSD layers):
    the SMOKE loop card against CPU, the exact loop (no attention, so
    exact whatever the mode: prefill ms, p50 / p99, peak memory) with no
    kernel launched, a profiled window (device busy ms and ops a step),
    and the engine's refusal (``ValueError``, as the JAX engine);
21. the generic-data Algorithm 1: the llama3-8b SMOKE cache built with
    ``method="morton"`` (``[morton]``, record ``segment_build[morton]``:
    the Morton permutation on the card beside the CPU's, ``segment_build``
    against its plain version on it); then ``[apps]``: the CF recommender
    (4000 x 1000 MovieLens-shaped ratings, 64 clusters) and the search
    engine (20000 x 2000 Sogou-shaped pages, 128 clusters) on the card
    against the card machine's CPU on the CPU's synopsis (``predict``
    within 1e-5 of max|ref|, the same top-10 ids at 0 / 5 / 10 / 20 / 40 /
    100% of the clusters and exact), the card's own builds' invariants and
    their share of rows in the CPU build's cluster; one larger component
    of each drawn on the device (65536 x 4096 ratings, 131072 x 2048
    pages, 1024 clusters): the build's wall time, per-query p50 / p99
    over 200 queries one at a time (each budget, exact, and the
    recommender's unranked 25% partial execution), RMSE loss / top-10
    overlap, peak memory; plain PyTorch, f32 without TF32;
22. training (``[train]``): one f32 step of smollm's SMOKE config on the
    card against the CPU (within 4x the CPU's distance from its float64
    step); smollm-135m at full width, every gradient finite and non-zero,
    14 steps at batch 8 x 2048 with a checkpoint at step 8
    (``launch.train.run``: the loss every 5 steps, step p50 from CUDA
    events, tokens/s, peak memory), a second uninterrupted run (the
    run-to-run spread) and a restart from the step-8 checkpoint to 14,
    held to the first run within twice that spread; no kernel may launch
    (the training forward takes the differentiable attention);
23. the sharded path over ``torch.distributed`` (``[mesh]``, ``run_mesh``):
    MESH_WORLD = 8 ranks spawned on the one card (gloo, the collectives'
    operands staged through host memory), the kernels built above and
    loaded by every rank, llama3-8b at full width with 2 of its 32 layers
    on every rank: ``sharded_synopsis_attention`` through the serve step
    on a model-4 mesh and a data-2 x model-4 mesh (SERVE_RULES; each rank
    prefills and builds the global prompt and cuts its shard): layer 0
    against the one-rank kernels on the global cache at budget 16 of
    M = 32 (a partial selection across the shards), each rank's stage 1
    and stage 2 against their plain versions at its shard's shapes, 4
    decode steps with stage 1 and stage 2 launched once a layer on every
    rank, the collectives' bytes and host-staged ms a layer; one short
    engine window (a functional check: a handful of requests) of the
    cluster tier on a component-4 mesh and of the fleet tier on a
    replica-2 x component-4 mesh (eager steps, rank 0's plans broadcast),
    each rank's kernels against their plain versions; the SMOKE f32
    cluster and fleet engines' ids on a mesh against the stacked engines'
    under basic and fixed; smollm-135m's compressed train step (full
    width, 8 of its 30 layers, 2 steps) over (pod 2, data 2) against the
    one-rank step (losses, parameters and error buffers); the weights cut by the rule tables (``shard_params``):
    llama3-8b in f32 on both meshes (the second FSDP-cut over `data`) and
    deepseek-v2-236b (1 layer, bf16) FSDP-cut on the second, each rank's
    weights held to their ``shard_shape`` bytes, prefill and decode steps
    against the one-rank step on the same global weights and cache;
    the train step on a state cut by ``TRAIN_RULES`` (``[tp train]``):
    smollm-135m at full width and depth in f32 on (data 2, model 3), every
    cut applied, each rank's master, m and v held to their ``shard_shape``
    bytes, the loss, every leaf's assembled step-1 gradient and the
    master, m and v after the cut AdamW against the one-rank step in
    float64 at TP_TRAIN_GATE_DEPTH layers, TP_TRAIN_STEPS f32 steps at
    every layer timed (each rank holds only its shard), no kernel
    launched;
    records ``<kernel>[mesh]`` (stage 1 and stage 2 at the data-2 x
    model-4 shard, flash_decode over the cluster window's extras),
    ``<kernel>[tp]`` and ``<kernel>[tp-mla]`` (rank 0's cut path), timed on
    rank 0 with the others waiting;
24. the dry run against the card (``[dryrun]``, ``run_dryrun_decode`` on
    phase 6's weights, ``run_dryrun_train`` after phase 22): the card's
    ``total_memory``; the dry run's per-rank program (no mesh) traced on
    ``meta`` by ``analysis.tracker.MemoryTracker``, then run on the card
    (after one warm-up call) for llama3-8b's budget-32 synopsis step at the
    loop's shapes (B = 2, prompt 8192, all 32 layers) and smollm-135m's
    train step at 8 x 2048: the argument bytes predicted and measured
    must be equal, the output + temp predicted within 10% or 1 MB of
    ``max_memory_allocated() - memory_allocated()`` around the step, and
    ``total_memory`` must equal ``launch.dryrun.CARD_MEMORY``; the
    cost model's bound for the decode step beside phase 6's profiled
    device time a step, as a share (printed, not gated).

Every path's launch counts are reset just before it runs and read just
after: the synopsis loop must launch its four kernels, the quantized loops
their quantized branches and not the unquantized ones, the exact loop
``flash_prefill`` and ``flash_decode``, the unfused op ``synopsis_score``,
``flash_decode`` and ``block_gather_attention``, the cluster engine
stage 1, stage 2 and ``flash_decode`` (records ``<kernel>[cluster]``), the
engine the four synopsis-path kernels (counted at the graphs' capture: a replay runs no
Python, so the profiler's rows show the kernels inside the replays); the
phases 12-18's loops exactly one ``flash_prefill`` an attention layer
(two with a cross block), two builds (build and absorb) and, a step,
``flash_decode`` twice on each local layer and once on each cross block
and the two synopsis kernels on each global one, on the quant spec's
branches (exact: ``flash_decode`` twice on every attention layer, plus
the cross blocks'), every other branch not at all, and gemma2's engine
``flash_decode`` beside the four; mamba2's loop launches nothing.

Any failed phase raises and exits non-zero.  The last lines are the
kernels' JSON record, the nvidia-smi line and ``{"ok": true, ...}``.
Without a CUDA device, or without the repo around it, it exits non-zero
and prints no result.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
            torch.float32: 67e12}    # f32 outside the tensor cores
REPS = 20
# Calls timed of a plain version (after one warm-up): the slowest take
# 100-600 ms a call, where 20 would cost ~40 s of the script's limit over
# its 80-odd records.
PLAIN_REPS = 5
PROMPT, BATCH, STEPS = 8192, 2, 130
# Torch's CPU threads while nvcc builds the kernels beside phases 20-22
# (run HH: with all of the card machine's 8, the build took 196.7 s beside
# them against 137.2 s alone in HG).
BUILD_SIDE_THREADS = 2
# The controller's per-step deadline.  No published deadline exists for
# this model and prompt; 100 ms is the smallest round value above this
# port's budget-0 step time on one H100 (68-100 ms, host-bound: PERF.md),
# so the controller has budgets to choose from.  At the JAX launcher's
# 50 ms default it picks budget 0 on every step.  The decode baseline is
# the fixed-budget run, not this closed loop.
DEADLINE_MS = 100.0
NEG_INF = -1e30
# bf16 outputs: kernel and plain version round f32 results that differ in
# their last bits to bf16, so they may differ by one ulp, at most 2^-7 of
# the value; 1e-4 absolute covers outputs near zero.  (atol, rtol)
BF16_OUT_TOL = (1e-4, 2.0 ** -7)
# f32 partials of the decode kernels: o and m differ only in the order of
# f32 sums, but l sums up to S = 8320 terms, so the bound is relative as
# well as absolute (the card tests' tolerance).  (atol, rtol)
PARTIALS_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 1e-3)}
ACCURACY_BUDGETS = (0, 1, 2, 4, 8, 16, 32, 64)
FUSION_BUDGETS = (1, 8, 32, 64)
# The engine phase: 4 slots of an 8192-token prompt, 32 new tokens each,
# and one window of Poisson arrivals from seed 0 at 3 req/s for 4 s (9
# requests; 2-4 slots resident).  The per-request deadline: no published
# one exists for this model and prompt.  A request's latency is mostly the
# admissions it waits behind (a B=1 prefill + build of 8192 tokens takes
# ~340 ms on the H100, and an iteration admits every arrival that fits).
# At 1500 ms the controller runs out of slack on nearly every step (mean
# budget ~6 of 64, every request late), at 2500 ms it keeps budget 64 on
# most (the "[engine deadline]" lines, PERF.md §6).  2000 ms is the
# smallest round value between, so the controller has budgets to choose
# from.
ENGINE_SLOTS, ENGINE_NEW = 4, 32
ENGINE_RATE, ENGINE_WINDOW_S = 3.0, 4.0
ENGINE_DEADLINE_MS = 2000.0
# The engine's replayed step at these shapes issued these device ops
# before the contracts' telemetry existed (PERF.md §5, counted by
# engine_step_table); under the deadline contract the step must issue
# them still (its telemetry runs under the other two).  The same tree
# reads 3630 to 3634 at bucket 0 from one process to the next (PERF.md
# §7), so each count is held to a band of DEADLINE_REPLAY_SLACK ops either
# way: one op more a layer of the 32 adds 32.
DEADLINE_REPLAY_OPS = {0: 3631, 1: 3663}
DEADLINE_REPLAY_OPS_REST = 3695
DEADLINE_REPLAY_SLACK = 4
# The contracts: an estimator fit on short fixed-budget windows (one per
# budget, every lane admitted at once), then error_bounded at the JAX
# launcher's default ε.
CALIB_BUDGETS = (0, 4, 16, 64)
ENGINE_EPSILON = 0.02
# Admission: two SLO classes, the interactive one at the engine's deadline
# and a batch class at twice it, requests taking them in turn.
SLO_CLASSES = "interactive:2000,batch:4000"


# The device-side names of each kernel's launches (substrings of the
# profiler's rows): a kernel's device time sums these rows and no others.
KERNEL_ROWS = {
    "flash_prefill": ("flash_prefill_kernel", "flash_prefill_wgmma"),
    "segment_build": ("segment_build_kernel",),
    "fused_synopsis_score_attention": ("fused_synopsis_kernel",
                                       "latent_synopsis_kernel"),
    "block_gather_attention": ("block_gather_kernel",
                               "latent_gather_kernel", "latent_gather_wgmma",
                               "latent_merge_kernel<true>"),
    # flash_decode_kernel also matches latent_flash_decode_kernel
    "flash_decode": ("flash_decode_kernel", "latent_flash_decode_wgmma",
                     "latent_merge_kernel<false>"),
    "synopsis_score": ("synopsis_score_warp_kernel", "latent_score_kernel"),
}
# The second launch of a call of the latent core's tensor-core kernels
# (the merge of their parts): its time is the call's, its launches are not
# the wrapper's.
MERGE_ROWS = ("latent_merge_kernel",)
# L2 flush between the reps of a cold time: writing this many bytes
# evicts the 50 MB L2, and reading them back then writes the dirty lines
# out, so that the timed call pays for neither; neither kernel is a row of
# any kernel above.
FLUSH_BYTES = 256 * 2 ** 20
FLUSH_ROWS = ("FillFunctor", "reduce_kernel")
PROFILE_TRIES = 3
# _queued_ms's sleep: ~25 ms at the H100's 1.98 GHz, several times what
# the host takes to queue REPS calls of a kernel's wrapper (PERF.md: the
# slowest wrapper's host work is well under 1 ms a call).
QUEUE_SLEEP_CYCLES = 50_000_000
_flush = []


def _flush_l2():
  if not _flush:
    _flush.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                              device="cuda"))
  _flush[0].zero_()
  _flush[0].sum()


# Whether the timing helpers time (phase 3 checks its f32 pass without
# timing it: only the bf16 records, the serving path's type, are kept).
_TIMING = [True]


def _median_ms(fn, reps=REPS, warmup=2, cold=False):
  """CUDA-event time of one call, median of ``reps``; ``cold``: the L2 is
  flushed before each call, so that its inputs come from HBM.  NaN while
  ``_TIMING`` is off, as for the other timing helpers."""
  if not _TIMING[0]:
    return float("nan")
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    if cold:
      _flush_l2()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def _device_ms(fn, names=None, reps=REPS, cold=False, floor_ms=0.0):
  """Device time of one call: the profiler's device rows over ``reps``
  calls, per call, summed over the rows whose name holds one of
  ``names`` (a kernel's own, KERNEL_ROWS); ``names=None`` (a library
  call, whose kernels we do not name) takes every row but the L2
  flush's.  Unlike a pair of CUDA events around a call, it leaves out the
  gaps in which the device waits for the host to launch, which dominate
  a call shorter than its wrapper's host work.  A session may lose
  device records (it shows one launch fewer than were made, or none, only
  the host's launch rows): a kernel of ours, which a call launches once,
  is timed over the launches the session recorded (each row a launch,
  times its launches a call: the latent core's tensor-core kernels add a
  merge launch, MERGE_ROWS).  A library call may
  launch several kernels a call: each of its rows is timed over the
  launches it recorded, times its whole number of launches a call (its
  count over ``reps``, rounded).  Given ``floor_ms`` (the least time the
  device could take), that reading counts only where every row kept nine
  tenths of its launches and the sum is not below the floor (a reading
  below it lost whole rows); else the session is run again, as is one
  that recorded none.  After PROFILE_TRIES such sessions the time comes
  from CUDA events instead (_queued_ms; a reading of 0 is not a time).
  ``cold``: as _median_ms."""
  if not _TIMING[0]:
    return float("nan")
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  for _ in range(PROFILE_TRIES):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        if cold:
          _flush_l2()
        fn()
      torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0
            and (any(n in e.key for n in names) if names
                 else not any(n in e.key for n in FLUSH_ROWS))]
    launches = sum(e.count for e in rows
                   if not any(n in e.key for n in MERGE_ROWS))
    if names is not None:
      if launches != reps:
        print(f"  [profiler] {launches} launches of {names} recorded for "
              f"{reps} calls")
      if launches:  # each row's time a launch, times its launches a call
        return sum(e.self_device_time_total / e.count
                   * max(1, round(e.count / reps)) for e in rows) / 1e3
    elif rows:
      per_call = [max(1, round(e.count / reps)) for e in rows]
      ms = sum(e.self_device_time_total / e.count * k
               for e, k in zip(rows, per_call)) / 1e3
      lost = [(e.key[:60], e.count) for e, k in zip(rows, per_call)
              if e.count < 0.9 * k * reps]
      if lost:
        print(f"  [profiler] rows that lost launches: {lost}")
      if not floor_ms or (not lost and ms >= floor_ms):
        return ms
      print(f"  [profiler] library call: {ms:.4f} ms a call (floor "
            f"{floor_ms:.4f}): run again")
      continue
    print(f"  [profiler] no device row of {names}: "
          f"{[e.key[:60] for e in prof.key_averages()]}")
  ms = _queued_ms(fn, reps=reps, cold=cold)
  print(f"  [profiler] no whole device record of {names} in {PROFILE_TRIES} "
        f"sessions: {ms:.4f} ms from CUDA events on a queued stream")
  return ms


def _queued_ms(fn, reps=REPS, cold=False):
  """Device time of one call from CUDA events, median of ``reps``: a
  sleep kernel holds the stream while the host queues every call, each
  between its own pair of events, so the device runs them back to back
  and no wait for the host falls between a pair.  Only a call that the
  host had queued before the sleep ended counts: with a sleep too short
  it sleeps ten times longer, then raises.  The events between kernels
  add ~0.004 ms to a call of a few microseconds, nothing measurable to
  one of a millisecond (PERF.md).  ``cold``: as _median_ms (the flush
  lies outside the pair)."""
  fn()
  torch.cuda.synchronize()
  for cycles in (QUEUE_SLEEP_CYCLES, 10 * QUEUE_SLEEP_CYCLES):
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    gate = torch.cuda.Event()
    torch.cuda._sleep(cycles)
    gate.record()
    for start, end in pairs:
      if cold:
        _flush_l2()
      start.record()
      fn()
      end.record()
    queued = not gate.query()
    torch.cuda.synchronize()
    if queued:
      return statistics.median(s.elapsed_time(e) for s, e in pairs)
  raise AssertionError("the host did not queue its calls within a sleep of "
                       f"{10 * QUEUE_SLEEP_CYCLES} cycles")


def _nbytes(*tensors):
  return sum(t.numel() * t.element_size() for t in tensors)


def _max_err(got, want):
  if isinstance(got, (tuple, list)):
    return max(_max_err(g, w) for g, w in zip(got, want))
  return float((got.float() - want.float()).abs().max())


def _check(name, dtype, got, want, atol, rtol=0.0):
  """Every element within ``atol + rtol * |want|``; returns the max
  absolute error."""
  if not isinstance(got, (tuple, list)):
    got, want = (got,), (want,)
  ok = all(bool(((g.float() - w.float()).abs()
                 <= atol + rtol * w.float().abs()).all())
           for g, w in zip(got, want))
  err = _max_err(got, want)
  print(f"  [{name} {str(dtype)[6:]}] max_abs_err={err:.3e} "
        f"tol={atol:.1e}+{rtol:.3g}|x|")
  if not ok:
    raise AssertionError(f"{name} ({dtype}) disagrees with its plain "
                         f"version (max abs err {err})")
  return err


def _bound(nbytes, ops, dtype):
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = ops / PEAK_OPS[dtype] * 1e3
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(name, source, replaces, dtype, err, kernel_fn, plain_fn, nbytes,
            ops, library_fn=None, cold=False):
  """Times the kernel (warm: repeated calls on the same inputs; and, with
  ``cold``, with the L2 flushed before each call) beside its plain
  version, its bound and the library call; returns its record."""
  names = KERNEL_ROWS[name.split("[")[0]]
  ms = _median_ms(kernel_fn)
  plain_ms = _median_ms(plain_fn, reps=PLAIN_REPS, warmup=1)
  library_ms = _median_ms(library_fn) if library_fn is not None else None
  bound_ms, bound_by = _bound(nbytes, ops, dtype)
  ops_ms = ops / PEAK_OPS[dtype] * 1e3  # warm inputs may sit in the L2
  lib_dev = (_device_ms(library_fn, floor_ms=ops_ms)
             if library_fn is not None else None)
  dev_ms = _device_ms(kernel_fn, names)
  print(f"  [{name} {str(dtype)[6:]}] ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms={library_ms}; "
        f"device time: kernel {dev_ms:.4f} ms, library "
        f"{None if lib_dev is None else f'{lib_dev:.4f}'} ms")
  rec = {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": library_ms, "device_ms": dev_ms,
         "library_device_ms": lib_dev}
  if cold:
    rec["ms_cold"] = _median_ms(kernel_fn, cold=True)
    rec["device_ms_cold"] = _device_ms(kernel_fn, names, cold=True)
    lib_cold = (_device_ms(library_fn, cold=True, floor_ms=bound_ms)
                if library_fn is not None else None)
    print(f"  [{name} {str(dtype)[6:]}] L2-cold: ms={rec['ms_cold']:.4f} "
          f"device {rec['device_ms_cold']:.4f} ms (warm {dev_ms:.4f}), "
          f"{bound_ms / rec['device_ms_cold']:.1%} of the bound; library "
          f"device {None if lib_cold is None else f'{lib_cold:.4f}'} ms")
  return rec


def _bound_share(rec, dtype):
  """Prints the kernel's device time as a share of its bound; returns the
  record."""
  print(f"  [{rec['name']} {str(dtype)[6:]}] {rec['bound_ms']:.4f} ms bound "
        f"({rec['bound_by']}) / {rec['device_ms']:.4f} ms device = "
        f"{rec['bound_ms'] / rec['device_ms']:.1%} of its bound")
  return rec


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version, at the path's shapes
# ---------------------------------------------------------------------------

def check_flash_prefill(dev, dtype, g):
  from repro_torch.kernels import ref
  from repro_torch.kernels.flash_prefill import flash_prefill
  B, S, H, Hkv, D = BATCH, PROMPT, 32, 8, 128
  q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
  k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
  v = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
  sm = D ** -0.5
  got = flash_prefill(q, k, v, sm_scale=sm)
  want = ref.flash_prefill_ref(q, k, v, sm_scale=sm)
  err = _check("flash_prefill", dtype, got, want,
               *(BF16_OUT_TOL if dtype == torch.bfloat16 else (1e-4,)))
  qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
  sdpa = torch.nn.functional.scaled_dot_product_attention
  ops = 4 * B * H * D * (S * (S + 1) // 2)
  rec = _record(
      "flash_prefill", "src/repro_torch/kernels/csrc/flash_prefill.cu",
      "src/repro/kernels/flash_prefill.py:140", dtype, err,
      lambda: flash_prefill(q, k, v, sm_scale=sm),
      lambda: ref.flash_prefill_ref(q, k, v, sm_scale=sm),
      _nbytes(q, k, v, got), ops,
      lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
  if dtype == torch.bfloat16:
    # The wgmma kernel issues P.V twice (P = P_hi + P_lo): 1.5x the
    # algorithm's operations go through the tensor cores.
    dev_ms, lib_ms = rec["device_ms"], rec["library_device_ms"]
    print(f"  [flash_prefill bf16] {ops / 1e12:.3f} TFLOP "
          f"({1.5 * ops / 1e12:.3f} issued with the P split) in "
          f"{dev_ms:.4f} ms of device time: "
          f"{ops / dev_ms / 1e9:.1f} TFLOP/s of the algorithm, "
          f"{1.5 * ops / dev_ms / 1e9:.1f} issued (peak 989); bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
          f"{rec['bound_ms'] / dev_ms:.1%} of it; SDPA {lib_ms:.4f} ms "
          f"device, kernel / SDPA {dev_ms / lib_ms:.2f}x")
  return rec


def check_segment_build(dev, dtype, g):
  from repro_torch.kernels import ref
  from repro_torch.kernels.synopsis_build import segment_build
  N, Hkv, S, D, C = 32 * BATCH, 8, PROMPT, 128, 128
  k = torch.randn((N, Hkv, S, D), generator=g, device=dev).to(dtype)
  v = torch.randn((N, Hkv, S, D), generator=g, device=dev).to(dtype)
  perm = torch.argsort(torch.rand((N, S), generator=g, device=dev),
                       dim=-1).to(torch.int32)
  got = segment_build(k, v, perm, cluster_size=C)
  want = ref.synopsis_build_ref(k, v, perm, cluster_size=C)
  # The permuted rows are copies; the centroids round an f32 mean taken
  # in another order.
  tol = BF16_OUT_TOL if dtype == torch.bfloat16 else (1e-5,)
  err = _check("segment_build", dtype, got, want, *tol)
  # absorb: the 128-token ring with the identity permutation
  ring = torch.arange(128, device=dev, dtype=torch.int32).expand(N, 128)
  ka, va = k[:, :, :128].contiguous(), v[:, :, :128].contiguous()
  _check("segment_build absorb", dtype,
         segment_build(ka, va, ring, cluster_size=C),
         ref.synopsis_build_ref(ka, va, ring, cluster_size=C), *tol)
  M = S // C
  return _bound_share(_record(
      "segment_build", "src/repro_torch/kernels/csrc/segment_build.cu",
      "src/repro/kernels/synopsis_build.py:173", dtype, err,
      lambda: segment_build(k, v, perm, cluster_size=C),
      lambda: ref.synopsis_build_ref(k, v, perm, cluster_size=C),
      _nbytes(k, v, perm, *got), 2 * N * Hkv * S * D + 2 * N * Hkv * M * D),
      dtype)


def _decode_inputs(dev, dtype, g, S, Hkv=8, G=4, D=128):
  B, C = BATCH, 128
  M = S // C
  q = torch.randn((B, Hkv * G, D), generator=g, device=dev).to(dtype)
  k = torch.randn((B, Hkv, S, D), generator=g, device=dev).to(dtype)
  v = torch.randn((B, Hkv, S, D), generator=g, device=dev).to(dtype)
  k_syn = k.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype)
  v_syn = v.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype)
  cbias = torch.full((B, M), float(torch.log(torch.tensor(float(C)))),
                     device=dev)
  return q, k, v, k_syn, v_syn, cbias, C


def _stage1_tol(dtype, M):
  """Stage 1 against its plain version: at the loop's M <= 65 every output
  within 1e-4 (f32) / 1e-3 (bf16 inputs), f32 sums in another order; at
  M = 1024 l sums 1024 terms of up to e^(log-count bias), so its f32
  rounding grows with l and the bound is relative as well (PARTIALS_TOL,
  the card tests' tolerance for stage 1 at every M)."""
  if M > 65:
    return PARTIALS_TOL[dtype]
  return (1e-3 if dtype == torch.bfloat16 else 1e-4,)


def check_fused_synopsis(dev, dtype, g):
  from repro_torch.kernels import ref
  from repro_torch.kernels.fused_synopsis import (
      fused_synopsis_score_attention as fused)
  # M = 1024 (a 131072-token prompt's tables: 8 chunks and their merge),
  # then the loop's 65 (ragged) and 64, which is timed.
  for S in (16 * PROMPT, PROMPT + 128, PROMPT):
    q, _, _, k_syn, v_syn, cbias, _ = _decode_inputs(dev, dtype, g, S)
    sm = q.shape[-1] ** -0.5
    got = fused(q, k_syn, v_syn, cbias, sm_scale=sm)
    want = ref.fused_synopsis_score_attention_ref(q, k_syn, v_syn, cbias,
                                                  sm_scale=sm)
    err = _check(f"fused_synopsis M={k_syn.shape[2]}", dtype,
                 (got[0], *got[1]), (want[0], *want[1]),
                 *_stage1_tol(dtype, k_syn.shape[2]))
  B, H, D = q.shape
  M = k_syn.shape[2]
  return _record(
      "fused_synopsis_score_attention",
      "src/repro_torch/kernels/csrc/fused_synopsis.cu",
      "src/repro/kernels/fused_synopsis.py:139", dtype, err,
      lambda: fused(q, k_syn, v_syn, cbias, sm_scale=sm),
      lambda: ref.fused_synopsis_score_attention_ref(q, k_syn, v_syn, cbias,
                                                     sm_scale=sm),
      _nbytes(q, k_syn, v_syn, cbias, got[0], *got[1]), 4 * B * H * M * D,
      cold=True)


def _equal_keys(k, sel, C):
  """k with the C keys of each (b, hkv)'s first selected cluster set to
  that cluster's first key: the cluster's rows and its centroid's
  decrement term cancel, so its part's l is ~0."""
  k = k.clone()
  B, Hkv = sel.shape[:2]
  for b in range(B):
    for h in range(Hkv):
      c = int(sel[b, h, 0])
      k[b, h, c * C:(c + 1) * C] = k[b, h, c * C]
  return k


def check_block_gather(dev, dtype, g):
  from repro_torch.kernels import ops, ref
  from repro_torch.kernels.block_gather_attention import (
      block_gather_attention as gather)
  from repro_torch.kernels.flash_decode import flash_decode
  tol = PARTIALS_TOL[dtype]
  # The last case is the synopsis loop's and is timed; (S, I, epilogues,
  # ids): the unfused op runs the kernel with neither epilogue; budget 0
  # pads every id and keeps the extras; "no extras" pads every id of three
  # parts, which all survive the merge; "equal" cancels one part's l.
  for S, I, epi, ids in ((PROMPT + 128, 32, "both", "topk"),
                         (PROMPT, 1, "both", "padded"),
                         (PROMPT, 3, "no extras", "padded"),
                         (PROMPT, 32, "none", "topk"),
                         (PROMPT, 32, "both", "equal"),
                         (PROMPT, 32, "both", "topk")):
    q, k, v, k_syn, v_syn, cbias, C = _decode_inputs(dev, dtype, g, S)
    B, Hkv, M, D = k_syn.shape
    sm = D ** -0.5
    scores, _ = ref.fused_synopsis_score_attention_ref(q, k_syn, v_syn,
                                                       cbias, sm_scale=sm)
    if ids == "padded":
      sel = torch.full((B, Hkv, I), -1, dtype=torch.int32, device=dev)
    else:
      sel = torch.topk(scores, min(I, M), dim=-1).indices.to(torch.int32)
    if ids == "equal":
      k = _equal_keys(k, sel, C)
      k_syn = k.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype)
    I = sel.shape[-1]
    safe = sel.long().clamp_min(0)[..., None].expand(-1, -1, -1, D)
    dec = dict(k_sel=torch.gather(k_syn, 2, safe),
               v_sel=torch.gather(v_syn, 2, safe),
               sel_bias=cbias[:, None, :1].expand(B, Hkv, I).contiguous())
    rk = torch.randn((B, Hkv, 128, D), generator=g, device=dev).to(dtype)
    rv = torch.randn((B, Hkv, 128, D), generator=g, device=dev).to(dtype)
    sk, sv = q[:, ::4, None].contiguous(), q[:, 1::4, None].contiguous()
    ek, ev, eb = ops.build_extras(rk, rv, None, (sk, sv))  # E = 129
    ext = dict(extras_k=ek, extras_v=ev, extras_bias=eb)
    kw = dict(cluster_size=C, sm_scale=sm,
              **{"both": dec | ext, "no extras": dec, "none": {}}[epi])
    got = gather(q, k, v, sel, **kw)
    want = ref.fused_gather_attention_ref(q, k, v, sel, **kw)
    err = _check(f"block_gather S={S} I={I} epilogues={epi} ids={ids}",
                 dtype, got, want, *tol)
  H = q.shape[1]
  rows = int((sel >= 0).sum()) * C              # rows this selection reads
  nbytes = (_nbytes(q, sel, dec["k_sel"], dec["v_sel"], dec["sel_bias"], ek,
                    ev, eb, *got) + 2 * rows * D * k.element_size())
  ops_n = 4 * (H // Hkv) * D * (rows + B * Hkv * (I + ek.shape[2]))
  rec = _record(
      "block_gather_attention", "src/repro_torch/kernels/csrc/block_gather.cu",
      "src/repro/kernels/block_gather_attention.py:255", dtype, err,
      lambda: gather(q, k, v, sel, **kw),
      lambda: ref.fused_gather_attention_ref(q, k, v, sel, **kw),
      nbytes, ops_n, cold=True)
  # The yardstick: flash_decode over I * C contiguous rows reads the same
  # cache bytes as the gather of I clusters; the gap is the gather's own
  # cost (its extras, decrement rows, parts and ids).
  n = I * C
  kc, vc = k[:, :, :n].contiguous(), v[:, :, :n].contiguous()
  fd = lambda: flash_decode(q, kc, vc, sm_scale=sm)
  fd_dev = _device_ms(fd, KERNEL_ROWS["flash_decode"])
  fd_cold = _device_ms(fd, KERNEL_ROWS["flash_decode"], cold=True)
  print(f"  [yardstick {str(dtype)[6:]}] flash_decode over S={n} contiguous "
        f"rows: device {fd_dev:.4f} ms warm, {fd_cold:.4f} cold; "
        f"block_gather I={I}: {rec['device_ms']:.4f} warm, "
        f"{rec['device_ms_cold']:.4f} cold (gather / contiguous, cold: "
        f"{rec['device_ms_cold'] / fd_cold:.2f}x)")
  return rec


def check_flash_decode(dev, dtype, g):
  """The exact loop's shapes (the cache at S = 8192 and 8320 after an
  absorb, the self token at S = 1), the unfused stage 1's (64 and 65
  centroids with a log(count) bias, -1e30 on the selected ones, and every
  centroid masked as at i_max = M), and one softcap case."""
  from repro_torch.kernels import ref
  from repro_torch.kernels.flash_decode import flash_decode
  tol = PARTIALS_TOL[dtype]
  for S, bias_kind, cap in ((PROMPT + 128, None, None), (1, None, None),
                            (PROMPT + 128, "masked", None),
                            (PROMPT // 128, "masked", None),
                            (PROMPT // 128 + 1, "all_masked", None),
                            (PROMPT // 2 + 1, None, None),
                            (PROMPT, None, 30.0), (PROMPT, None, None)):
    q, k, v, _, _, _, _ = _decode_inputs(dev, dtype, g, -(-S // 128) * 128)
    k, v = k[:, :, :S].contiguous(), v[:, :, :S].contiguous()
    bias = None
    if bias_kind is not None:
      B, Hkv = k.shape[:2]
      bias = torch.log(torch.randint(1, 129, (B, Hkv, S), generator=g,
                                     device=dev).float())
      masked = torch.rand((B, Hkv, S), generator=g, device=dev) < 0.5
      bias[masked | (bias_kind == "all_masked")] = NEG_INF
    kw = dict(sm_scale=q.shape[-1] ** -0.5, cap=cap)
    got = flash_decode(q, k, v, bias, **kw)
    want = ref.flash_decode_ref(q, k, v, bias, **kw)
    err = _check(f"flash_decode S={S} bias={bias_kind} cap={cap}", dtype,
                 got, want, *tol)
  B, H, D = q.shape
  sdpa = torch.nn.functional.scaled_dot_product_attention
  return _record(
      "flash_decode", "src/repro_torch/kernels/csrc/flash_decode.cu",
      "src/repro/kernels/flash_decode.py:125", dtype, err,
      lambda: flash_decode(q, k, v, **kw),
      lambda: ref.flash_decode_ref(q, k, v, **kw),
      _nbytes(q, k, v, *got), 4 * B * H * PROMPT * D,
      lambda: sdpa(q[:, :, None], k, v, enable_gqa=True), cold=True)


def check_synopsis_score(dev, dtype, g):
  from repro_torch.kernels import ref
  from repro_torch.kernels.synopsis_score import synopsis_score
  tol = PARTIALS_TOL[dtype]
  # M = 1024 (a 131072-token prompt's table: four warps a block), timed
  # here against its bound; then the loop's 65 (ragged) and 64, which is
  # recorded.
  for S in (16 * PROMPT, PROMPT + 128, PROMPT):
    q, _, _, k_syn, _, _, _ = _decode_inputs(dev, dtype, g, S)
    B, H, D = q.shape
    M = k_syn.shape[2]
    sm = D ** -0.5
    fn = functools.partial(synopsis_score, q, k_syn, sm_scale=sm)
    got = fn()
    want = ref.synopsis_score_ref(q, k_syn, sm_scale=sm)
    err = _check(f"synopsis_score M={M}", dtype, got, want, *tol)
    if M > 65:
      names = KERNEL_ROWS["synopsis_score"]
      warm, cold = _device_ms(fn, names), _device_ms(fn, names, cold=True)
      bound, by = _bound(_nbytes(q, k_syn, got), 2 * B * H * M * D, dtype)
      print(f"  [synopsis_score M={M} {str(dtype)[6:]}] device {warm:.5f} "
            f"ms warm, {cold:.5f} ms L2-cold; bound {bound:.5f} ms ({by}): "
            f"{bound / warm:.1%} / {bound / cold:.1%} of its bound")
  # No single PyTorch call computes it (a product, then an amax).
  return _record(
      "synopsis_score", "src/repro_torch/kernels/csrc/synopsis_score.cu",
      "src/repro/kernels/synopsis_score.py:46", dtype, err, fn,
      lambda: ref.synopsis_score_ref(q, k_syn, sm_scale=sm),
      _nbytes(q, k_syn, got), 2 * B * H * M * D, cold=True)


# ---------------------------------------------------------------------------
# Phase 3b: the quantized branches against their plain versions
# ---------------------------------------------------------------------------

QSPECS = ("int8", "fp8", "int8+kv", "fp8+kv")
QKINDS = ("int8", "fp8")


def _steps(x):
  """Codes as ordered integers (fp8 by sign and magnitude bits), so that
  neighbouring codes differ by 1."""
  if x.dtype == torch.int8:
    return x.long()
  bits = x.view(torch.uint8).long()
  return torch.where(bits >= 128, -(bits & 0x7F), bits)


def _check_codes(name, dtype, got, want, exact):
  """Quantized codes: bit-equal (``exact``), or at most one step apart (a
  code that follows an f32 mean summed in another order).  Returns the
  number of codes one step apart."""
  step = (_steps(got) - _steps(want)).abs()
  moved = int((step > 0).sum())
  print(f"  [{name} {str(dtype)[6:]}] codes one step apart: {moved} of "
        f"{step.numel()} (allowed: {'none' if exact else 'at most 1%'})")
  if int(step.max()) > 1 or (exact and moved) or moved > 0.01 * step.numel():
    raise AssertionError(f"{name} ({dtype}): codes differ from the plain "
                         f"version's ({moved} moved, max {int(step.max())})")
  return moved


def check_segment_build_quant(dev, dtype, g, spec, cfg=None, tag=""):
  """The quantized build at the shape of ``cfg``'s prompt build (every
  layer sequence of a B = 2 prompt, the cache's rows: MLA's one latent
  head of 576; llama3-8b's by default): sorted-KV
  codes and their scales bit-equal to the plain version's, centroid codes
  at most one step apart, centroid scales within f32 rounding; and the
  absorb.  The record is the branch's name and ``tag``."""
  from repro_torch.configs.registry import get_config
  from repro_torch.kernels import _build, ref
  from repro_torch.kernels import quant as qt
  from repro_torch.kernels.synopsis_build import segment_build
  from repro_torch.models.common import kv_dims
  cfg = cfg or get_config("llama3-8b")
  (Hkv, D), N, S = kv_dims(cfg), cfg.n_layers * BATCH, PROMPT
  C = cfg.synopsis.cluster_size
  qc = qt.parse_qconfig(spec)
  k = torch.randn((N, Hkv, S, D), generator=g, device=dev).to(dtype)
  v = torch.randn((N, Hkv, S, D), generator=g, device=dev).to(dtype)
  perm = torch.argsort(torch.rand((N, S), generator=g, device=dev),
                       dim=-1).to(torch.int32)
  ring = torch.arange(C, device=dev, dtype=torch.int32).expand(N, C)
  ka, va = k[:, :, :C].contiguous(), v[:, :, :C].contiguous()
  name = _build.branch("segment_build", spec) + tag
  for args, label in (((k, v, perm), f"{name} N={N} Hkv={Hkv} D={D}"),
                      ((ka, va, ring), name + " absorb")):
    got = segment_build(*args, cluster_size=C, quant=spec)
    want = ref.synopsis_build_quant_ref(*args, cluster_size=C, qc=qc)
    for leaf in ("k", "v"):
      if qc.sorted_kv:
        _check_codes(f"{label} {leaf}", dtype, got[leaf], want[leaf], True)
      elif not torch.equal(got[leaf], want[leaf]):
        raise AssertionError(f"{label}: sorted {leaf} differs")
    for leaf in ("k_syn", "v_syn"):
      _check_codes(f"{label} {leaf}", dtype, got[leaf], want[leaf], False)
    scales = [n for n in qt.SCALE_LEAVES if n in want]
    err = _check(f"{label} scales", dtype, [got[n] for n in scales],
                 [want[n] for n in scales], 1e-7, 1e-5)
    # The centroids as the decode path reads them: codes times scales.
    err = max(err, *(_max_err(
        qt.dequantize_rows(got[x], got[x + "_scale"]),
        qt.dequantize_rows(want[x], want[x + "_scale"]))
        for x in ("k_syn", "v_syn")))
    for leaf in qt.KV_SCALE_LEAVES:
      if leaf in want and not torch.equal(got[leaf], want[leaf]):
        raise AssertionError(f"{label}: {leaf} differs (no sum in it)")
  got = segment_build(k, v, perm, cluster_size=C, quant=spec)
  M = S // C
  return _bound_share(_record(
      name, "src/repro_torch/kernels/csrc/segment_build.cu",
      "src/repro/kernels/synopsis_build.py:173", dtype, err,
      lambda: segment_build(k, v, perm, cluster_size=C, quant=spec),
      lambda: ref.synopsis_build_quant_ref(k, v, perm, cluster_size=C, qc=qc),
      _nbytes(k, v, perm, *got.values()),
      2 * N * Hkv * S * D * (2 if qc.sorted_kv else 1)
      + 4 * N * Hkv * M * D), dtype)


def _quant_arena(dev, dtype, g, S, spec, **heads):
  """The decode inputs (``heads``: Hkv, G, D) with their synopsis arena
  quantized under ``spec`` (plain version of the build, identity
  permutation)."""
  from repro_torch.kernels import ops, ref
  from repro_torch.kernels import quant as qt
  q, k, v, _, _, _, C = _decode_inputs(dev, dtype, g, S, **heads)
  B = k.shape[0]
  ident = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
  arena = ref.synopsis_build_quant_ref(k, v, ident, cluster_size=C,
                                       qc=qt.parse_qconfig(spec))
  return q, arena, ops.count_bias(arena["counts"]), C


def check_fused_synopsis_quant(dev, dtype, g, kind, cfg=None, tag=""):
  """Stage 1 on int8 / fp8 tables at ``cfg``'s heads and softcap (llama3-8b's
  by default), M = 1024, 65 and 64 (the loop's, which is recorded under
  the branch's name and ``tag``)."""
  from repro_torch.configs.registry import get_config
  from repro_torch.kernels import _build, ref
  from repro_torch.kernels.fused_synopsis import (
      fused_synopsis_score_attention as fused)
  cfg = cfg or get_config("llama3-8b")
  heads = dict(Hkv=cfg.n_kv_heads, G=cfg.n_heads // cfg.n_kv_heads,
               D=cfg.hd)
  name = _build.branch("fused_synopsis_score_attention", kind) + tag
  for S in (16 * PROMPT, PROMPT + 128, PROMPT):      # M = 1024, 65, 64
    q, arena, cbias, _ = _quant_arena(dev, dtype, g, S, kind, **heads)
    tables = (arena["k_syn"], arena["v_syn"], cbias)
    kw = dict(sm_scale=q.shape[-1] ** -0.5, cap=cfg.attn_softcap,
              k_scale=arena["k_syn_scale"], v_scale=arena["v_syn_scale"])
    got = fused(q, *tables, **kw)
    want = ref.fused_synopsis_score_attention_ref(q, *tables, **kw)
    err = _check(f"{name} M={tables[0].shape[2]} {heads} cap="
                 f"{cfg.attn_softcap}", dtype,
                 (got[0], *got[1]), (want[0], *want[1]),
                 *_stage1_tol(dtype, tables[0].shape[2]))
  B, H, D = q.shape
  M = tables[0].shape[2]
  return _record(
      name, "src/repro_torch/kernels/csrc/fused_synopsis.cu",
      "src/repro/kernels/fused_synopsis.py:139", dtype, err,
      lambda: fused(q, *tables, **kw),
      lambda: ref.fused_synopsis_score_attention_ref(q, *tables, **kw),
      _nbytes(q, *tables, kw["k_scale"], kw["v_scale"], got[0], *got[1]),
      4 * B * H * M * D, cold=True)


def check_block_gather_quant(dev, dtype, g, spec):
  """Stage 2 on a quantized arena, with its inputs built as
  ``refine_stage2`` builds them (decrement rows dequantized in f32, E = 129
  extras): at M = 65, at budget 0 (all ``-1`` ids) and at budget 32, which
  is timed.  Under int8 / fp8 the cache is bf16 / f32 with f32 decrement
  rows (the unquantized kernel's key); under ``+kv`` it is quantized."""
  from repro_torch.kernels import _build, ops, ref
  from repro_torch.kernels import quant as qt
  from repro_torch.kernels.block_gather_attention import (
      block_gather_attention as gather)
  qc = qt.parse_qconfig(spec)
  tol = PARTIALS_TOL[dtype]
  name = _build.branch("block_gather_attention",
                       qc.kind if qc.sorted_kv else "none")
  for S, I in ((PROMPT + 128, 32), (PROMPT, 1), (PROMPT, 32)):
    q, arena, cbias, C = _quant_arena(dev, dtype, g, S, spec)
    B, Hkv, M, D = arena["k_syn"].shape
    sm = D ** -0.5
    if I == 1:                        # budget 0: all padded, extras only
      sel = torch.full((B, Hkv, 1), -1, dtype=torch.int32, device=dev)
    else:
      scores, _ = ref.fused_synopsis_score_attention_ref(
          q, arena["k_syn"], arena["v_syn"], cbias, sm_scale=sm,
          k_scale=arena["k_syn_scale"], v_scale=arena["v_syn_scale"])
      sel = torch.topk(scores, min(I, M), dim=-1).indices.to(torch.int32)
    safe = sel.long().clamp_min(0)
    rows = safe[..., None].expand(-1, -1, -1, D)
    dec = {f"{x}_sel": qt.gather_rows(arena[f"{x}_syn"], 2, rows).float()
           * torch.gather(arena[f"{x}_syn_scale"], 2, safe)[..., None]
           for x in "kv"}
    dec["sel_bias"] = torch.gather(cbias[:, None].expand(B, Hkv, M), 2,
                                   safe)
    rk = torch.randn((B, Hkv, 128, D), generator=g, device=dev).to(dtype)
    rv = torch.randn((B, Hkv, 128, D), generator=g, device=dev).to(dtype)
    sk, sv = q[:, ::4, None].contiguous(), q[:, 1::4, None].contiguous()
    ek, ev, eb = ops.build_extras(rk, rv, None, (sk, sv))  # E = 129
    kw = dict(cluster_size=C, sm_scale=sm, extras_k=ek, extras_v=ev,
              extras_bias=eb, **dec)
    if qc.sorted_kv:
      kw.update(kv_k_scale=arena["k_scale"], kv_v_scale=arena["v_scale"])
    kv = (arena["k"], arena["v"])
    got = gather(q, *kv, sel, **kw)
    want = ref.fused_gather_attention_ref(q, *kv, sel, **kw)
    err = _check(f"{name} ({spec}) S={S} I={sel.shape[-1]}", dtype, got,
                 want, *tol)
  H = q.shape[1]
  rows_read = int((sel >= 0).sum()) * C
  scales = [kw[n] for n in ("kv_k_scale", "kv_v_scale") if n in kw]
  nbytes = (_nbytes(q, sel, dec["k_sel"], dec["v_sel"], dec["sel_bias"], ek,
                    ev, eb, *got)
            + 2 * rows_read * D * kv[0].element_size()
            + len(scales) * int((sel >= 0).sum()) * 4)
  ops_n = 4 * (H // Hkv) * D * (rows_read + B * Hkv * (I + ek.shape[2]))
  return _record(
      name, "src/repro_torch/kernels/csrc/block_gather.cu",
      "src/repro/kernels/block_gather_attention.py:255", dtype, err,
      lambda: gather(q, *kv, sel, **kw),
      lambda: ref.fused_gather_attention_ref(q, *kv, sel, **kw),
      nbytes, ops_n, cold=True)


def stage1_bytes_against_time(dev, g, rounds=5):
  """Stage 1 on one layer's tables, unquantized (bf16) and int8 / fp8, at
  the slice's M = 64 and at M = 1024 (the table of a 131072-token prompt,
  synthetic): the bytes the kernel must move, its bound and its time.
  The three variants are timed in turns, ``rounds`` times, and the median
  device time is reported (a 10-20 us kernel's time varies between
  calls).  This is the card's answer to the modelled "~1.9-3.8x less
  stage-1 HBM traffic" of quantization."""
  from repro_torch.kernels import quant as qt
  from repro_torch.kernels.fused_synopsis import (
      fused_synopsis_score_attention as fused)
  B, Hkv, G, D = BATCH, 8, 4, 128
  for M in (64, 1024):
    q = torch.randn((B, Hkv * G, D), generator=g, device=dev).to(
        torch.bfloat16)
    cbias = torch.full((B, M), 4.85, device=dev)
    fns, nbytes = {}, {}
    for kind in ("none",) + QKINDS:
      kt = torch.randn((B, Hkv, M, D), generator=g, device=dev)
      vt = torch.randn((B, Hkv, M, D), generator=g, device=dev)
      if kind == "none":
        tables, kw = (kt.to(torch.bfloat16), vt.to(torch.bfloat16)), {}
      else:
        (kq, ks), (vq, vs) = qt.quantize_rows(kt, kind), qt.quantize_rows(
            vt, kind)
        tables, kw = (kq, vq), dict(k_scale=ks, v_scale=vs)
      fns[kind] = functools.partial(fused, q, *tables, cbias,
                                    sm_scale=D ** -0.5, **kw)
      out = fns[kind]()
      nbytes[kind] = _nbytes(q, *tables, cbias, *kw.values(), out[0],
                             *out[1])
    times = {kind: [] for kind in fns}
    rows = KERNEL_ROWS["fused_synopsis_score_attention"]
    for _ in range(rounds):
      for kind, fn in fns.items():
        times[kind].append((_median_ms(fn), _device_ms(fn, rows),
                            _device_ms(fn, rows, cold=True)))
    base = statistics.median(t[1] for t in times["none"])
    for kind in fns:
      ms = statistics.median(t[0] for t in times[kind])
      dev_ms = statistics.median(t[1] for t in times[kind])
      cold_ms = statistics.median(t[2] for t in times[kind])
      bound, _ = _bound(nbytes[kind], 4 * B * Hkv * G * M * D,
                        torch.bfloat16)
      print(f"[stage-1 bytes] M={M:4d} {kind:4s}: bytes={nbytes[kind]} "
            f"({nbytes['none'] / nbytes[kind]:.2f}x fewer than bf16) "
            f"bound_ms={bound:.6f} ms={ms:.4f} device_ms={dev_ms:.4f} "
            f"(min {min(t[1] for t in times[kind]):.4f}, max "
            f"{max(t[1] for t in times[kind]):.4f} over {rounds} turns; "
            f"bf16/this {base / dev_ms:.2f}x) device_ms_cold={cold_ms:.4f} "
            f"({bound / cold_ms:.1%} of the bound)")


# ---------------------------------------------------------------------------
# Phases 4-8: the serving loops and their checks
# ---------------------------------------------------------------------------

def _tree_to(tree, dev):
  return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
          for k, v in tree.items()}


def check_small_model_parity(dev):
  """SMOKE llama3-8b in f32: the kernels on the card and the plain
  versions on the CPU generate the same ids, in synopsis mode (fixed
  budgets, one absorb; unquantized and under each quant spec) and in exact
  mode; and on the card a synopsis step at i_max = M equals the exact step
  on the same prompt cache.  Returns each quant spec's launch counts."""
  from repro_torch.configs.registry import get_config
  from repro_torch.kernels import _build
  from repro_torch.launch import serve
  from repro_torch.models import transformer as tf
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.prefill import make_prefill_step
  from repro_torch.serve.serve_step import make_serve_step
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  params = tf.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
  gparams = _tree_to(params, dev)
  prompt = torch.randint(0, cfg.vocab, (2, 128),
                         generator=torch.Generator().manual_seed(2))
  quant_launches = {}
  for mode, quant in ([("synopsis", "none")]
                      + [("synopsis", q) for q in QSPECS]
                      + [("exact", "none")]):
    extra = dict(budgets=[2, 1, 0] * 6) if mode == "synopsis" else {}
    quiet = dict(batch=2, prompt_len=128, tokens=18, prompt=prompt,
                 mode=mode, log=lambda _: None, **extra)
    qcfg = serve.apply_quant(cfg, quant)
    _build.reset_launches()
    gpu = serve.run(qcfg, device=dev, params=gparams, **quiet)
    torch.cuda.synchronize()
    quant_launches[quant] = _build.launch_counts()
    cpu = serve.run(qcfg, device="cpu", params=params, **quiet)
    label = mode if quant == "none" else f"{mode} quant={quant}"
    if not torch.equal(gpu["tokens"].cpu(), cpu["tokens"]):
      raise AssertionError(f"small-model {label} ids differ: "
                           f"{gpu['tokens'].tolist()} vs "
                           f"{cpu['tokens'].tolist()}")
    err = _max_err(gpu["logits"].cpu(), cpu["logits"])
    print(f"[parity] smoke f32 {label}: {gpu['tokens'].shape[1]} ids equal "
          f"on card and CPU; last logits max_abs_err={err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
      raise AssertionError(f"small-model {label} logits differ by {err}")
    if quant != "none":
      _require_quant_launches(f"smoke {label}", quant_launches[quant], quant)

  logits, cache = make_prefill_step(cfg)(gparams, prompt.to(dev))
  syn = skv.build(cache, cfg)
  M = syn["k_syn"].shape[4]
  tok = logits.argmax(-1, keepdim=True)
  lg_ex, _ = make_serve_step(cfg, mode="exact")(gparams, cache, tok)
  lg_syn, _ = make_serve_step(cfg, i_max=M)(gparams, syn, tok)
  rel = _max_err(lg_syn, lg_ex) / float(lg_ex.abs().max())
  # f32 throughout; the stage-1 centroid terms cancel in the decrement.
  print(f"[parity] smoke f32: synopsis step at i_max=M={M} vs exact step, "
        f"logits max err {rel:.3e} of max|logits| (tol 1e-4)")
  if not rel <= 1e-4:
    raise AssertionError(f"full-budget synopsis step != exact step: {rel}")
  return quant_launches


def _step_stats(step_ms):
  steps = sorted(step_ms)
  p99 = steps[min(len(steps) - 1, int(0.99 * len(steps)))]
  return (f"p50={statistics.median(steps):.2f} p99={p99:.2f} "
          f"max={steps[-1]:.2f}")


def _check_run(out, cfg, absorbs=1):
  """130 steps with one absorb (none in exact mode), finite logits, ids in
  the vocabulary."""
  if out["absorbs"] != absorbs or len(out["step_ms"]) != STEPS:
    raise AssertionError(f"the run did not take {STEPS} steps with "
                         f"{absorbs} absorb(s)")
  lg, ids = out["logits"], out["tokens"]
  if (tuple(lg.shape) != (BATCH, cfg.vocab) or not torch.isfinite(lg).all()
      or tuple(ids.shape) != (BATCH, STEPS + 1)
      or int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab):
    raise AssertionError("bad logits or token ids from the serving loop")


def check_full_budget(cache, dev, g, pos=0, cap=None, G=4, q_dtype=None):
  """The first layer at pattern position ``pos`` of the run's final cache
  (a synopsis layer): synopsis decode with i_max = M equals exact
  attention over every cached, ring and self token (both softcapped by
  ``cap``); G query heads a KV head, the query in ``q_dtype`` (default
  the cache's; f32 under MLA, as the absorbed q_eff)."""
  from repro_torch.kernels import ops, ref
  k, v = cache["k"][0, pos], cache["v"][0, pos]
  B, Hkv, S, D = k.shape
  M = cache["k_syn"].shape[4]
  rl = int(cache["recent_len"][0])
  q = torch.randn((B, Hkv * G, D), generator=g, device=dev).to(
      q_dtype or k.dtype)
  sk = torch.randn((B, Hkv, 1, D), generator=g, device=dev).to(k.dtype)
  sv = torch.randn((B, Hkv, 1, D), generator=g, device=dev).to(k.dtype)
  got = ops.synopsis_cache_attention(
      q, k, v, cache["k_syn"][0, pos], cache["v_syn"][0, pos],
      cache["counts"][0, pos], cache["recent_k"][0, pos],
      cache["recent_v"][0, pos], cache["recent_len"], sk, sv, i_max=M,
      cluster_size=S // M, sm_scale=D ** -0.5, cap=cap)
  keys = torch.cat([k, cache["recent_k"][0, pos][:, :, :rl], sk], dim=2)
  vals = torch.cat([v, cache["recent_v"][0, pos][:, :, :rl], sv], dim=2)
  want = ref.exact_attention_ref(q, keys, vals, sm_scale=D ** -0.5, cap=cap)
  rel = _max_err(got, want) / float(want.abs().max())
  # bf16 inputs, f32 sums in another order, and the stage-1 centroid terms
  # cancelled by the decrement: 1e-3 of the output's scale.
  print(f"[full budget] layer {pos}, i_max=M={M}, S={S}+{rl}+1, cap={cap}: "
        f"max err {rel:.3e} of max|exact| (tol 1e-3)")
  if not rel <= 1e-3:
    raise AssertionError(f"full-budget synopsis decode != exact: {rel}")


def _require_launches(path, counts, kernels, absent=()):
  """Every kernel of the path launched at least once in its run, and none
  of ``absent`` (branches the path must not fall back to)."""
  print(f"[{path}] launches {({k: n for k, n in counts.items() if n})}")
  missing = [k for k in kernels if counts[k] == 0]
  if missing:
    raise AssertionError(f"{path}: {missing} not launched: {counts}")
  fallback = [k for k in absent if counts[k]]
  if fallback:
    raise AssertionError(f"{path}: launched {fallback}, which it must not: "
                         f"{counts}")


def _quant_branches(quant):
  """The kernel branches a synopsis loop under ``quant`` launches, and the
  unquantized branches it must not fall back to."""
  from repro_torch.kernels import _build
  from repro_torch.kernels import quant as qt
  qc = qt.parse_qconfig(quant)
  stage2 = qc.kind if qc.sorted_kv else "none"
  need = (_build.branch("segment_build", quant),
          _build.branch("fused_synopsis_score_attention", qc.kind),
          _build.branch("block_gather_attention", stage2))
  absent = ("segment_build", "fused_synopsis_score_attention")
  return need, absent + (("block_gather_attention",) if qc.sorted_kv else ())


def _require_quant_launches(path, counts, quant):
  need, absent = _quant_branches(quant)
  _require_launches(path, counts, need, absent)


def check_accuracy_vs_exact(cfg, params, cache, syn, dev,
                            budgets=ACCURACY_BUDGETS):
  """One exact step on the prompt cache and synopsis steps on its synopsis
  (quantized under ``cfg.synopsis.quant``) at each budget, with the same
  next token: the mean total-variation distance of the next-token
  distributions and the argmax match.  The weights are random (the JAX
  init's scales), so these are not the paper's accuracy numbers."""
  from repro_torch.serve.serve_step import make_serve_step
  nt = torch.randint(0, cfg.vocab, (BATCH, 1),
                     generator=torch.Generator().manual_seed(7)).to(dev)
  lg_ex, _ = make_serve_step(cfg, mode="exact")(params, cache, nt)
  p_ex = torch.softmax(lg_ex, -1)
  M, C = syn["k_syn"].shape[4], cfg.synopsis.cluster_size
  quant = cfg.synopsis.quant
  print(f"[accuracy vs exact] random weights, {cfg.name}, B={BATCH}, "
        f"S={PROMPT}, M={M}, quant={quant}")
  for budget in budgets:
    lg, _ = make_serve_step(cfg, mode="synopsis", i_max=budget)(params, syn,
                                                                 nt)
    if not torch.isfinite(lg).all():
      raise AssertionError(f"non-finite logits at budget {budget}")
    tv = float(0.5 * (torch.softmax(lg, -1) - p_ex).abs().sum(-1).mean())
    match = float((lg.argmax(-1) == lg_ex.argmax(-1)).float().mean())
    print(f"[accuracy vs exact] quant={quant} budget={budget:2d} kv_rows="
          f"{M + budget * C}/{PROMPT} tv={tv:.6f} argmax_match={match:.2f}")


def _layer_query(k, G, dev, g, q_dtype=None):
  """A decode query for one layer's keys ``k`` (B, Hkv, S, D), G heads a
  KV head, scaled so that its logits spread ~2 (as in the fused/unfused
  comparison), in ``q_dtype`` (default the keys'; f32 under MLA), and a
  self token."""
  B, Hkv, _, D = k.shape
  q = torch.randn((B, Hkv * G, D), generator=g, device=dev)
  q = (q * 2.0 * D ** 0.5 / k.float().norm(dim=-1).mean()).to(
      q_dtype or k.dtype)
  sk = torch.randn((B, Hkv, 1, D), generator=g, device=dev).to(k.dtype)
  sv = torch.randn((B, Hkv, 1, D), generator=g, device=dev).to(k.dtype)
  return q, sk, sv


def _layer_decode(syn, pos, q, sk, sv, i_max, cap, return_scores=False):
  """Synopsis decode on the first layer at pattern position ``pos`` of
  the arena ``syn`` (quantized or not), with a self token and no ring."""
  from repro_torch.kernels import ops
  from repro_torch.kernels import quant as qt
  lay = {n: syn[n][0, pos] for n in syn if n not in ("recent_len", "pos")}
  S, M, D = lay["k"].shape[2], lay["k_syn"].shape[2], q.shape[-1]
  return ops.synopsis_cache_attention(
      q, lay["k"], lay["v"], lay["k_syn"], lay["v_syn"], lay["counts"],
      None, None, None, sk, sv, *(lay.get(n) for n in qt.SCALE_LEAVES),
      i_max=i_max, cluster_size=S // M, sm_scale=D ** -0.5, cap=cap,
      return_scores=return_scores)


def check_full_budget_quant(cache, syn, quant, dev, g, pos=0, G=4,
                            cap=None, q_dtype=None):
  """The first layer at pattern position ``pos`` of the exact run's prompt
  cache and of its synopsis built under ``quant``: synopsis decode at
  i_max = M (with a self token) against exact attention over the
  unquantized cache (both softcapped by ``cap``; G query heads a KV head),
  relative L2 below 7%, the JAX package's bound for quantization noise.
  At i_max = M stage 2 subtracts every centroid's stage-1 term again, so
  the quantized tables cancel here: check_budget_quant reads them."""
  from repro_torch.kernels import ref
  k, v = cache["k"][0, pos], cache["v"][0, pos]
  D, M = k.shape[3], syn["k_syn"].shape[4]
  q, sk, sv = _layer_query(k, G, dev, g, q_dtype)
  got = _layer_decode(syn, pos, q, sk, sv, M, cap)
  want = ref.exact_attention_ref(q, torch.cat([k, sk], 2),
                                 torch.cat([v, sv], 2), sm_scale=D ** -0.5,
                                 cap=cap)
  rel = float((got - want).norm() / want.norm())
  print(f"[full budget quant] layer {pos}, quant={quant}, i_max=M={M}, "
        f"cap={cap}: relative L2 deviation from exact {rel:.4e} (bound "
        f"0.07)")
  if not rel < 0.07:
    raise AssertionError(f"full-budget {quant} decode deviates {rel}")
  return rel


def check_budget_quant(syn, qsyn, quant, dev, g, pos=0, G=4, cap=None,
                       budgets=(0, 8, 32)):
  """What the quantized tables contribute below the full budget, on the
  first layer at pattern position ``pos``: the arena built under
  ``quant`` against the unquantized arena of the same cache, same query.
  Stage 1's scores (the k tables) and the budget-0 output (the output of
  the tables alone) each within a relative L2 of 7%, the JAX package's
  stage-1 floor for quantization noise.  At budgets 8 and 32 the scores
  pick the clusters stage 2 refines, and a score moved by the codes can
  swap a cluster among near-ties for another, which moves the output by
  the two clusters' exact-minus-centroid terms: the share of selected
  clusters both arenas pick and the output's deviation are printed, with
  no bound (the model's next-token distributions under either arena are
  compared with exact in check_accuracy_vs_exact)."""
  q, sk, sv = _layer_query(syn["k"][0, pos], G, dev, g)
  for budget in budgets:
    want, s_want = _layer_decode(syn, pos, q, sk, sv, budget, cap, True)
    got, s_got = _layer_decode(qsyn, pos, q, sk, sv, budget, cap, True)
    rel = float((got - want).norm() / want.norm())
    line = (f"[budget quant] layer {pos}, quant={quant}, i_max={budget}, "
            f"cap={cap}: output's relative L2 deviation from the "
            f"unquantized arena's {rel:.4e}")
    if budget == 0:
      srel = float((s_got - s_want).norm() / s_want.norm())
      print(f"{line} (bound 0.07); stage-1 scores' {srel:.4e} (bound 0.07)")
      if not (rel < 0.07 and srel < 0.07):
        raise AssertionError(f"{quant} tables deviate: output {rel}, "
                             f"scores {srel}")
    else:
      pick = [torch.topk(s, budget, dim=-1).indices.sort(-1).values
              for s in (s_want, s_got)]
      same = float((pick[0][..., :, None] == pick[1][..., None, :])
                   .any(-1).float().mean())
      print(f"{line} (no bound); {same:.1%} of the {budget} clusters a "
            f"head refines picked by both")


def run_fixed_budget(cfg, params, dev, quant="none"):
  """The decode baseline: the synopsis loop with budget i_max on every
  step (its work per step does not follow the host clock), under
  ``quant``; launch counts and peak memory of this run alone."""
  from repro_torch.kernels import _build
  from repro_torch.launch import serve
  qcfg = serve.apply_quant(cfg, quant)
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  out = serve.run(qcfg, batch=BATCH, prompt_len=PROMPT, tokens=STEPS,
                  budgets=[cfg.synopsis.i_max] * STEPS, device=dev,
                  params=params, log=lambda _: None)
  torch.cuda.synchronize()
  launches = _build.launch_counts()
  _check_run(out, cfg)
  print(f"[decode baseline] quant={quant} budget {cfg.synopsis.i_max} on "
        f"every step: decode_ms {_step_stats(out['step_ms'])} "
        f"prefill_ms={out['prefill_ms']:.1f} build_ms={out['build_ms']:.1f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
  return out, launches


def compare_fused_unfused(syn, dev, g):
  """Layer 0 of the built full-width cache: the unfused op (score kernel,
  masked flash_decode over the centroids, block_gather with neither
  epilogue) against the fused pipeline at several budgets: the same
  selection, outputs within 1e-3 of max|out| (bf16 inputs, f32 sums in
  other orders), and both timed.  Returns the unfused op's launches."""
  from repro_torch.kernels import _build, ops
  k, v = syn["k"][0, 0], syn["v"][0, 0]
  k_syn, v_syn = syn["k_syn"][0, 0], syn["v_syn"][0, 0]
  counts = syn["counts"][0, 0]
  B, Hkv, _, D = k.shape
  # The random-weight model's keys are long enough that a unit-normal
  # query gives one-hot attention, which any composition gets right; scale
  # the query so that its logits have a spread of ~2.
  q = torch.randn((B, Hkv * 4, D), generator=g, device=dev)
  q = (q * 2.0 * D ** 0.5 / k.float().norm(dim=-1).mean()).to(k.dtype)
  args = (q, k, v, k_syn, v_syn, counts)
  _build.reset_launches()
  unfused = {i: ops.synopsis_attention(*args, i_max=i, sm_scale=D ** -0.5,
                                       return_diag=True)
             for i in FUSION_BUDGETS}
  torch.cuda.synchronize()
  launches = _build.launch_counts()
  for i in FUSION_BUDGETS:
    kw = dict(i_max=i, sm_scale=D ** -0.5)
    a, (_, sel_a, _, _) = unfused[i]
    b, (_, sel_b, _, _) = ops.synopsis_attention_fused(*args, **kw,
                                                       return_diag=True)
    if not torch.equal(sel_a.sort(-1).values, sel_b.sort(-1).values):
      raise AssertionError(f"fused and unfused select differently, i={i}")
    rel = _max_err(a, b) / float(a.abs().max())
    unfused_fn = lambda: ops.synopsis_attention(*args, **kw)
    fused_fn = lambda: ops.synopsis_attention_fused(*args, **kw)
    ms_u, ms_f = _median_ms(unfused_fn), _median_ms(fused_fn)
    dev_u, dev_f = _device_ms(unfused_fn), _device_ms(fused_fn)
    print(f"[fused vs unfused] layer 0, i_max={i:2d}: unfused_ms={ms_u:.4f} "
          f"fused_ms={ms_f:.4f} ratio={ms_u / ms_f:.2f}; device time "
          f"unfused {dev_u:.4f} fused {dev_f:.4f} ratio {dev_u / dev_f:.2f}; "
          f"max err {rel:.2e} of max|out| (tol 1e-3)")
    if not rel <= 1e-3:
      raise AssertionError(f"fused != unfused at i_max={i}: {rel}")
  return launches


def profile_decode(cfg, params, cache, dev, budget, steps=3,
                   mode="synopsis"):
  """torch.profiler over a few decode steps on the run's final cache:
  wall time, device busy time and the kernels that take it."""
  from torch.profiler import ProfilerActivity, profile
  from repro_torch.serve.serve_step import make_serve_step
  step = make_serve_step(cfg, mode=mode, i_max=budget)
  tok = torch.zeros((BATCH, 1), dtype=torch.long, device=dev)
  step(params, cache, tok)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(steps):
      step(params, cache, tok)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps

  # Device-side rows only (kernels, copies): a CPU op's row repeats the
  # device time of the kernels it launched.
  rows = sorted(((e.self_device_time_total, e.key, e.count)
                 for e in prof.key_averages()
                 if e.device_type != torch.autograd.DeviceType.CPU
                 and e.self_device_time_total > 0), reverse=True)
  busy = sum(r[0] for r in rows) / 1e3 / steps
  label = f"budget={budget}" if mode == "synopsis" else "exact"
  if cfg.synopsis.quant != "none":
    label += f" quant={cfg.synopsis.quant}"
  print(f"[profile] {label}: {wall:.2f} ms/step wall under the "
        f"profiler, device busy {busy:.2f} ms/step "
        f"({100 * busy / wall:.1f}%), {sum(r[2] for r in rows) // steps} "
        "device ops/step")
  for us, name, n in rows[:10]:
    print(f"  {us / 1e3 / steps:8.3f} ms/step  x{n // steps:5d}  {name[:80]}")
  per = {k: sum(r[0] for r in rows if any(n in r[1] for n in names))
         for k, names in KERNEL_ROWS.items()}
  print(f"[profile] {label}: port kernels, ms/step: " + ", ".join(
      f"{k} {us / 1e3 / steps:.3f}" for k, us in per.items() if us))
  return busy


# ---------------------------------------------------------------------------
# Phase 10: the continuous-batching engine on one CUDA graph per bucket
# ---------------------------------------------------------------------------

def check_engine_parity(dev):
  """SMOKE llama3-8b in f32: the engine on the card (captured graphs, the
  kernels) and on the CPU (eager programs, plain versions) generate the
  same ids for the same requests, under fixed budget 1 and basic, with
  admission overlap on (the default)."""
  from repro_torch.configs.registry import get_config
  from repro_torch.models import transformer as tf
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        make_requests)
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  params = tf.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
  for arm in (dict(policy="fixed", fixed_budget=1), dict(policy="basic")):
    ids = {}
    for where, p in (("cpu", params), ("card", _tree_to(params, dev))):
      eng = ServingEngine(cfg, EngineConfig(n_slots=2, prompt_len=128,
                                            max_new_tokens=8, **arm),
                          params=p, device=dev if where == "card" else "cpu")
      reqs = make_requests([0.0, 1.0, 2.0, 3.0, 4.0], 128, 8, cfg.vocab,
                           seed=3)
      eng.run(reqs)
      ids[where] = [r.tokens for r in reqs]
      graphs = len(eng.programs.graphs)
    if ids["card"] != ids["cpu"]:
      raise AssertionError(f"engine ids differ on card and CPU ({arm}): "
                           f"{ids['card']} vs {ids['cpu']}")
    print(f"[engine parity] smoke f32 {arm['policy']}: "
          f"{sum(map(len, ids['card']))} ids of 5 requests equal on card "
          f"({graphs} graphs) and CPU")


def _profile_rows(fn, calls):
  """Device rows of ``calls`` calls of ``fn`` under the profiler: (busy ms
  a call, device ops a call, {kernel: launches a call}, span ms: the
  first device op's start to the last one's end, or None without
  device ops)."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  rows = [e for e in prof.key_averages()
          if e.device_type != torch.autograd.DeviceType.CPU
          and e.self_device_time_total > 0]
  busy = sum(e.self_device_time_total for e in rows) / 1e3 / calls
  per = {k: sum(e.count for e in rows if any(n in e.key for n in names)
             and not any(n in e.key for n in MERGE_ROWS))
         / calls for k, names in KERNEL_ROWS.items()}
  ranges = [e.time_range for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CPU]
  span = ((max(r.end for r in ranges) - min(r.start for r in ranges)) / 1e3
          if ranges else None)
  return busy, sum(e.count for e in rows) / calls, per, span


def engine_step_table(eng, reps=10):
  """Each bucket's replayed step against the same program called eagerly,
  on the pool the trace left (resident lanes): host ms (median of
  ``reps``, each call waited for), CUDA-event ms (``reps`` calls queued
  back to back), device busy ms and device ops a step (profiler), and the
  step's outputs, which must be bitwise equal.  Returns {bucket: (replay
  host ms, busy ms, device ops)}."""
  rows = {}
  for b in eng.buckets:
    key = ("step", b)
    if key not in eng.programs.graphs:
      raise AssertionError(f"bucket {b} has no captured graph")
    host = {}
    for mode, fn in (("replay", lambda: eng.programs.run(key)),
                     ("eager", lambda: eng.programs.call_eager(key))):
      fn()
      torch.cuda.synchronize()
      out = {k: v.clone() for k, v in eng.step_out.items()}
      ts = []
      for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(reps):
        fn()
      end.record()
      end.synchronize()
      busy, ops_n, per, _ = _profile_rows(fn, 3)
      host[mode] = (statistics.median(ts), start.elapsed_time(end) / reps,
                    busy, ops_n, per, out)
    (r_host, r_ev, r_busy, r_ops, r_per, r_out) = host["replay"]
    (e_host, e_ev, e_busy, e_ops, _, e_out) = host["eager"]
    equal = all(torch.equal(r_out[k], e_out[k]) for k in r_out)
    print(f"[engine step] bucket {b:2d}: replay host {r_host:.3f} ms, "
          f"events {r_ev:.3f} ms, device busy {r_busy:.3f} ms "
          f"({r_ops:.0f} device ops; host / busy {r_host / r_busy:.2f}x) | "
          f"eager host {e_host:.3f} ms, events {e_ev:.3f} ms, busy "
          f"{e_busy:.3f} ms ({e_ops:.0f} ops) | eager / replay host "
          f"{e_host / r_host:.2f}x | outputs bitwise equal: {equal}")
    inside = {k: n for k, n in r_per.items() if n}
    print(f"  [engine step] bucket {b:2d}: kernel launches inside one "
          f"replay (profiler rows): {inside}")
    if not equal:
      raise AssertionError(f"bucket {b}: replayed and eager step differ")
    if any(inside.get(k, 0) != eng.cfg.n_layers for k in (
        "fused_synopsis_score_attention", "block_gather_attention")):
      raise AssertionError(f"bucket {b}: the replay does not run the "
                           f"decode kernels once a layer: {inside}")
    rows[b] = (r_host, r_busy, r_ops)
  return rows


def _replay_row(eng, b, reps=10):
  """One bucket's replay: host ms (median of ``reps``, each waited for),
  device busy ms and device ops (profiler)."""
  key = ("step", b)
  eng.programs.run(key)
  torch.cuda.synchronize()
  ts = []
  for _ in range(reps):
    t0 = time.perf_counter()
    eng.programs.run(key)
    torch.cuda.synchronize()
    ts.append((time.perf_counter() - t0) * 1e3)
  busy, ops_n, _, _ = _profile_rows(lambda: eng.programs.run(key), 3)
  return statistics.median(ts), busy, ops_n


def _engine_metrics(label, s, eng):
  print(f"[engine trace] {label}: n={s['n']} p50={s['p50']:.1f} ms "
        f"p99={s['p99']:.1f} ms accuracy_loss_pct="
        f"{s['accuracy_loss_pct']:.3f} deadline_miss_pct="
        f"{s['deadline_miss_pct']:.1f} mean_budget={s['mean_budget']:.2f} "
        f"goodput_per_s={s['goodput_per_s']:.3f} admission_p50="
        f"{s['admission_p50']:.1f} ms queue_p99={s['queue_p99']:.1f} ms "
        f"steps={s['steps']} prefills={s['prefills']}")
  steps = [ms for _, ms, _ in eng.step_log]
  print(f"  [engine trace] {label}: step ms {_step_stats(steps)}; budgets "
        f"{[b for b, _, _ in eng.step_log]}; resident "
        f"{[a for _, _, a in eng.step_log]}")
  if s["n"] < 8 or not all(len(r.tokens) == ENGINE_NEW + 1
                           for r in eng.completed):
    raise AssertionError(f"{label}: the trace did not serve its requests")


ENGINE_KERNELS = ("flash_prefill", "segment_build",
                  "fused_synopsis_score_attention", "block_gather_attention")


@contextlib.contextmanager
def _first_inputs(module, names):
  """Within the block, each kernel wrapper in ``names`` that ``module``
  calls keeps a copy of its first call's inputs: yields name -> (args,
  kwargs)."""
  seen, saved = {}, {n: getattr(module, n) for n in names}

  def copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else x

  def keep(name, fn):
    def call(*args, **kw):
      if name not in seen:
        seen[name] = ([copy(a) for a in args],
                      {k: copy(x) for k, x in kw.items()})
      return fn(*args, **kw)
    return call

  for n in names:
    setattr(module, n, keep(n, saved[n]))
  try:
    yield seen
  finally:
    for n, fn in saved.items():
      setattr(module, n, fn)


def _engine_plain(name, args, kw):
  from repro_torch.kernels import ref
  if name == "segment_build":
    if kw.get("quant") is not None:
      raise AssertionError("the engine phase builds unquantized")
    kw = {k: x for k, x in kw.items() if k != "quant"}
    return ref.synopsis_build_ref(*args, **kw)
  return {"flash_prefill": ref.flash_prefill_ref,
          "fused_synopsis_score_attention":
              ref.fused_synopsis_score_attention_ref,
          "block_gather_attention": ref.fused_gather_attention_ref,
          }[name](*args, **kw)


def _prefill_f64(q, k, v, *, sm_scale, cap=None, window=None):
  """Causal GQA attention in f64: the exact answer the engine's prefill
  approximates (no softcap or window on its model)."""
  if cap is not None or window is not None:
    raise ValueError("the f64 prefill takes neither softcap nor window")
  B, S, H, D = q.shape
  Hkv = k.shape[2]
  qg = q.double().reshape(B, S, Hkv, H // Hkv, D)
  kd, vd = k.double(), v.double()
  pos = torch.arange(S, device=q.device)
  out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
  for q0 in range(0, S, 512):
    q1 = min(S, q0 + 512)
    lg = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, q0:q1], kd[:, :q1])
    lg = (lg * sm_scale).masked_fill(pos[q0:q1, None] < pos[None, :q1],
                                     -math.inf)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(lg, -1), vd[:, :q1])
    out[:, q0:q1] = o.reshape(B, q1 - q0, H, D)
  return out


def _gather_f64(q, k, v, selected, *, cluster_size, sm_scale, cap=None,
                k_sel=None, v_sel=None, sel_bias=None, extras_k=None,
                extras_v=None, extras_bias=None, kv_k_scale=None,
                kv_v_scale=None, rows=None):
  """Stage 2's signed softmax in f64 (the selected clusters' tokens +,
  their centroid terms -, the extras +): partials (o, m, l); ``rows``
  the fleet tier's row map into k / v."""
  if cap is not None or kv_k_scale is not None or kv_v_scale is not None:
    raise ValueError("the f64 gather takes neither softcap nor scales")
  if rows is not None:
    k, v = k.index_select(0, rows.long()), v.index_select(0, rows.long())
  B, H, D = q.shape
  Hkv, C = k.shape[1], cluster_size
  qg = q.double().reshape(B, Hkv, H // Hkv, D)
  sel = selected.long()
  valid = sel >= 0
  rows = (sel.clamp_min(0)[..., None] * C
          + torch.arange(C, device=q.device)).reshape(B, Hkv, -1)
  ix = rows[..., None].expand(-1, -1, -1, D)
  zero = torch.zeros(rows.shape, dtype=torch.float64, device=q.device)
  parts = [(torch.gather(k, 2, ix), torch.gather(v, 2, ix),
            zero.masked_fill(~valid.repeat_interleave(C, -1), -math.inf),
            1.0)]
  if k_sel is not None:
    parts.append((k_sel, v_sel,
                  sel_bias.double().masked_fill(~valid, -math.inf), -1.0))
  if extras_k is not None:
    parts.append((extras_k, extras_v, extras_bias.double()[:, None], 1.0))
  logits = [torch.einsum("bhgd,bhsd->bhgs", qg, kk.double()) * sm_scale
            + bias[:, :, None, :] for kk, _, bias, _ in parts]
  m = torch.stack([lg.amax(-1) for lg in logits]).amax(0)
  l = torch.zeros_like(m)
  acc = torch.zeros(qg.shape, dtype=torch.float64, device=q.device)
  for lg, (_, vv, _, sign) in zip(logits, parts):
    p = torch.exp(lg - m[..., None])
    l = l + sign * p.sum(-1)
    acc = acc + sign * torch.einsum("bhgs,bhsd->bhgd", p, vv.double())
  o = acc / torch.where(l.abs() > 1e-30, l, torch.ones_like(l))[..., None]
  return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def _tol_units(got, want, atol, rtol=0.0):
  """The largest error of ``got`` against ``want``, in units of the
  tolerance ``atol + rtol * |want|``."""
  return max(float(((g.double() - w.double()).abs()
                    / (atol + rtol * w.double().abs())).max())
             for g, w in zip(got, want))


# Which inputs of each engine-path kernel scale together: the queries (Q),
# the keys and their centroids and extras (K), the values and theirs (V);
# ids, permutations and biases (None) are kept.
_SCALED = {"flash_prefill": ("Q", "K", "V"),
           "segment_build": ("K", "V", None),
           "fused_synopsis_score_attention": ("Q", "K", "V", None),
           "block_gather_attention": ("Q", "K", "V", None)}
_SCALED_KW = {"k_sel": "K", "v_sel": "V", "extras_k": "K", "extras_v": "V"}


def _unit_scaled(name, args, kw):
  """The inputs with Q, K and V each multiplied by the power of two
  nearest its inverse RMS: exact in bf16, so every zero, id, mask and
  centroid relation stays as it was, at the unit scale the kernel checks'
  random inputs have."""
  scale = {}
  for fam, a in zip(_SCALED[name], args):
    if fam is not None:
      rms = float(a.float().square().mean().sqrt())
      scale[fam] = 2.0 ** -round(math.log2(rms)) if rms > 0 else 1.0
  args = [a if fam is None else a * scale[fam]
          for fam, a in zip(_SCALED[name], args)]
  kw = {key: x * scale[_SCALED_KW[key]]
        if key in _SCALED_KW and x is not None else x
        for key, x in kw.items()}
  return args, kw, scale


def _engine_check(label, name, args, kw):
  """One engine-path kernel on the inputs the engine gave it, against its
  plain version.

  As given: the engine's layer-0 activations are far from unit scale
  (RMS ~10 for q, ~20 for k and v under the random init), so prefill and
  gather logits reach several hundred and an f32 result of either side
  carries errors the size of the unit-scale tolerance (prefill: 2 bf16
  ulps apart in ~5e-5 of the outputs; both as far from the exact answer).
  There the kernel is held to the exact (f64) answer: its largest error,
  in units of its kernel check's tolerance, is at most 1 or twice the
  plain version's.  Stage 1 and the build hold that tolerance outright.
  Scaled: the same inputs with Q, K and V scaled to unit RMS by powers of
  two (``_unit_scaled``), against the plain version at its kernel check's
  tolerance."""
  from repro_torch.kernels import ops
  dtype = args[0].dtype
  exact = {"flash_prefill": _prefill_f64,
           "block_gather_attention": _gather_f64}.get(name)
  for scaled in (False, True):
    if scaled:
      args, kw, scale = _unit_scaled(name, args, kw)
    got = getattr(ops, name)(*args, **kw)
    want = _engine_plain(name, args, kw)
    if name == "fused_synopsis_score_attention":
      got, want = (got[0], *got[1]), (want[0], *want[1])
      tol = _stage1_tol(dtype, args[1].shape[2])
    elif name == "block_gather_attention":
      tol = PARTIALS_TOL[dtype]
    elif dtype == torch.bfloat16:
      tol = BF16_OUT_TOL
    else:
      tol = (1e-4,) if name == "flash_prefill" else (1e-5,)
    if not isinstance(got, (tuple, list)):
      got, want = (got,), (want,)
    tag = f"engine {label} {name}"
    if scaled:
      print(f"  [{tag}] inputs scaled by {scale}")
      _check(f"{tag} scaled", dtype, got, want, *tol)
    elif exact is None:
      _check(tag, dtype, got, want, *tol)
    else:
      ref64 = exact(*args, **kw)
      ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
      kern, plain = _tol_units(got, ref64, *tol), _tol_units(want, ref64, *tol)
      print(f"  [{tag} {str(dtype)[6:]}] kernel against plain max_abs_err="
            f"{_max_err(got, want):.3e}; against f64, in units of "
            f"{tol[0]:.1e}+{tol[1] if len(tol) > 1 else 0:.3g}|x|: kernel "
            f"{kern:.3f}, plain {plain:.3f}")
      if kern > max(1.0, 2.0 * plain):
        raise AssertionError(f"{tag}: the kernel is further from the exact "
                             f"answer ({kern:.3f} tolerances) than the plain "
                             f"version allows ({plain:.3f})")


def check_engine_kernels(eng):
  """Each engine-path kernel against its plain version on the inputs the
  engine itself gives it at full width (layer 0's): one admission's
  prefill and build (B = 1 over the prompt's tokens), then each warm
  bucket's step, called eagerly, on a pool of ENGINE_SLOTS lanes of which
  two are resident and the rest zeroed (counts 0) as free lanes are; as
  given and scaled to unit RMS (``_engine_check``).  The replay-against-
  eager comparison cannot see a kernel fault that depends on these shapes:
  both run the same kernels."""
  from repro_torch.kernels import ops
  from repro_torch.serve.engine import make_requests
  eng.reset()
  reqs = make_requests([0.0, 0.0], PROMPT, ENGINE_NEW, eng.cfg.vocab,
                       seed=11)
  with _first_inputs(ops, ("flash_prefill", "segment_build")) as seen:
    for slot, req in enumerate(reqs):
      eng._admit(req, slot)
  q = seen["flash_prefill"][0][0]
  k = seen["segment_build"][0][0]
  if q.shape[:2] != (1, PROMPT) or k.shape[2] != PROMPT:
    raise AssertionError(f"admission shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}, expected B = 1 over {PROMPT}")
  for name in ("flash_prefill", "segment_build"):
    _engine_check("admission", name, *seen[name])
  del seen
  decode = ("fused_synopsis_score_attention", "block_gather_attention")
  for b in eng._warm_buckets():
    with _first_inputs(ops, decode) as seen:
      eng.programs.call_eager(("step", b))
      torch.cuda.synchronize()
    k_syn = seen[decode[0]][0][1]
    zeroed = [i for i in range(k_syn.shape[0]) if not k_syn[i].any()]
    if (k_syn.shape[0] != ENGINE_SLOTS or k_syn.shape[2] != eng.M
        or zeroed != list(range(len(reqs), ENGINE_SLOTS))):
      raise AssertionError(f"bucket {b}: stage 1 saw k_syn "
                           f"{tuple(k_syn.shape)} with zeroed lanes "
                           f"{zeroed}")
    print(f"[engine kernels] bucket {b}: B={ENGINE_SLOTS} M={eng.M}, "
          f"lanes {zeroed} zeroed")
    for name in decode:
      _engine_check(f"bucket {b}", name, *seen[name])
  eng.reset()


def check_deadline_replay_ops(eng, replays, sessions=3):
  """Under the deadline contract every bucket's replayed step must issue
  the device ops the engine issued at these shapes before the contracts'
  telemetry existed, to within DEADLINE_REPLAY_SLACK
  (``tests/test_torch_card.py`` holds at SMOKE size that the telemetry
  runs only under the other two contracts).  ``replays`` is
  ``engine_step_table``'s {bucket: (host ms, busy ms, device ops)}; a
  count outside the band is read again, the most of up to ``sessions``
  profiler sessions (a session at times loses rows)."""
  for b, (_, _, ops_n) in replays.items():
    want = DEADLINE_REPLAY_OPS.get(b, DEADLINE_REPLAY_OPS_REST)
    for _ in range(sessions - 1):
      if abs(round(ops_n) - want) <= DEADLINE_REPLAY_SLACK:
        break
      ops_n = max(ops_n, _profile_rows(
          lambda: eng.programs.run(("step", b)), 3)[1])
    print(f"  [engine step] bucket {b:2d}: {ops_n:.0f} device ops, the "
          f"engine's {want} +- {DEADLINE_REPLAY_SLACK}")
    if abs(round(ops_n) - want) > DEADLINE_REPLAY_SLACK:
      raise AssertionError(f"bucket {b}: the deadline replay issues "
                           f"{ops_n} device ops, the engine {want} +- "
                           f"{DEADLINE_REPLAY_SLACK}")


def run_engine(cfg, params, dev):
  """The engine at full width: capture, the per-bucket table, the trace
  under accuracytrader and basic, the simulator window.  Returns the
  path's launch counts (capture and admissions)."""
  from repro_torch.kernels import _build
  from repro_torch.serve.engine import (EngineConfig, MeasuredStepBackend,
                                        ServingEngine, run_open_loop)
  from repro_torch.serving.service import ScatterGatherService, ServiceConfig
  _build.reset_launches()
  summaries = {}
  for policy in ("accuracytrader", "basic"):
    torch.cuda.empty_cache()      # this engine's peak is its own
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, EngineConfig(
        n_slots=ENGINE_SLOTS, prompt_len=PROMPT, max_new_tokens=ENGINE_NEW,
        deadline_ms=ENGINE_DEADLINE_MS, policy=policy), params=params,
        device=dev)
    torch.cuda.synchronize()
    warm = eng._warm_buckets()
    print(f"[engine] {policy}: {cfg.name} slots={ENGINE_SLOTS} "
          f"prompt={PROMPT} M={eng.M} buckets={eng.buckets}; built, warmed "
          f"and captured {len(eng.programs.graphs)} graphs (steps {warm} + "
          f"append) in {time.perf_counter() - t0:.1f}s")
    if set(eng.programs.graphs) != {("step", b) for b in warm} | {"append"}:
      raise AssertionError(f"captured {sorted(eng.programs.graphs, key=str)}"
                           f", expected every warm bucket {warm}")
    t0 = time.perf_counter()
    s = run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0)
    served_ms = (time.perf_counter() - t0) * 1e3
    print(f"[engine trace] {policy}: {ENGINE_RATE} req/s for "
          f"{ENGINE_WINDOW_S} s of arrivals, deadline {ENGINE_DEADLINE_MS} "
          f"ms, served in {served_ms:.0f} ms of wall (engine clock "
          f"{eng.now_ms:.0f} ms)")
    _engine_metrics(policy, s, eng)
    summaries[policy] = s
    if policy == "accuracytrader":
      launches = _build.launch_counts()
      # The deadline's round neighbours on the same window: how much of
      # the budget range the controller uses at each.
      for deadline in (ENGINE_DEADLINE_MS - 500.0,
                       ENGINE_DEADLINE_MS + 500.0):
        eng.ecfg.deadline_ms = deadline
        n = run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0)
        print(f"[engine deadline] accuracytrader at {deadline:.0f} ms: "
              f"mean_budget={n['mean_budget']:.2f} deadline_miss_pct="
              f"{n['deadline_miss_pct']:.1f} p50={n['p50']:.1f} ms "
              f"accuracy_loss_pct={n['accuracy_loss_pct']:.3f}")
      eng.ecfg.deadline_ms = ENGINE_DEADLINE_MS
      replays = engine_step_table(eng)
      check_deadline_replay_ops(eng, replays)
      backend = MeasuredStepBackend(eng, iters=5)
      print(f"[engine simulator] measured step table (ms): "
            f"{ {b: round(ms, 3) for b, ms in backend.table.items()} }")
      svc = ScatterGatherService(ServiceConfig(seed=0), step_backend=backend)
      sim = svc.run_open_loop(20.0, 1.0)
      print(f"[engine simulator] 108 components, accuracytrader, 20 req/s "
            f"for 1 s on the measured table: "
            f"{ {k: round(v, 3) for k, v in sim.items()} }")
    print(f"[engine] {policy}: peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} (weights, slot "
          "pool, one admission's transients, graphs' pool)")
    if policy == "accuracytrader":     # after the peak: it keeps copies
      check_engine_kernels(eng)
    del eng
  for k in ("p50", "p99", "accuracy_loss_pct", "deadline_miss_pct",
            "mean_budget", "goodput_per_s", "admission_p50"):
    print(f"[engine compare] {k}: accuracytrader "
          f"{summaries['accuracytrader'][k]:.3f} basic "
          f"{summaries['basic'][k]:.3f}")
  return launches, replays[cfg.synopsis.i_max]


# ---------------------------------------------------------------------------
# Phase 11: the contracts, admission, the corpus cache and delta replay,
# the loop's --batches / --pipeline
# ---------------------------------------------------------------------------

def _engine(cfg, params, dev, **kw):
  from repro_torch.serve.engine import EngineConfig, ServingEngine
  torch.cuda.empty_cache()      # each engine's memory is its own
  estimator = kw.pop("estimator", None)
  kw.setdefault("deadline_ms", ENGINE_DEADLINE_MS)
  return ServingEngine(cfg, EngineConfig(
      n_slots=ENGINE_SLOTS, prompt_len=PROMPT, max_new_tokens=ENGINE_NEW,
      **kw), params=params, estimator=estimator, device=dev)


def _served(label, eng, n=None):
  """Every request served to its last token (none shed unless asked),
  with finite ids."""
  served = [r for r in eng.completed if not r.shed_admission]
  if n is not None and len(eng.completed) != n:
    raise AssertionError(f"{label}: {len(eng.completed)} requests, not {n}")
  if not served or not all(len(r.tokens) == ENGINE_NEW + 1
                           for r in served if not r.dropped):
    raise AssertionError(f"{label}: requests not served")


def run_engine_contract(cfg, params, dev, deadline_replay):
  """The ε-or-deadline contracts at full width: an estimator fit from one
  short deadline_with_bound window per calibration budget (policy fixed),
  shared by the engines that follow; the Poisson window under
  error_bounded (ε = ENGINE_EPSILON) and deadline_with_bound; the budget-32
  replay with the coverage profile beside ``deadline_replay`` (the
  deadline engine's).  Returns the path's launch counts."""
  from repro_torch.control import calibration_pairs
  from repro_torch.kernels import _build
  from repro_torch.serve.engine import make_requests, run_open_loop
  _build.reset_launches()
  t0 = time.perf_counter()
  est, raws, meas = None, [], []
  for b in CALIB_BUDGETS:
    eng = _engine(cfg, params, dev, policy="fixed", fixed_budget=b,
                  contract="deadline_with_bound", estimator=est)
    est = eng.estimator
    eng.run(make_requests([0.0] * ENGINE_SLOTS, PROMPT, ENGINE_NEW,
                          cfg.vocab, seed=100 + b))
    _served(f"calibration at budget {b}", eng, ENGINE_SLOTS)
    r, m = calibration_pairs(eng.completed)
    raws += r
    meas += m
    del eng
  fit = est.fit(raws, meas)
  print(f"[engine contract] calibration: budgets {CALIB_BUDGETS}, "
        f"{fit['n']} (raw, measured loss) pairs, spearman "
        f"{fit['spearman']:.3f}, band half-width {fit['resid_q']:.4f}, "
        f"raw {min(raws):.5f}-{max(raws):.5f}, in "
        f"{time.perf_counter() - t0:.1f}s")
  for contract in ("error_bounded", "deadline_with_bound"):
    eng = _engine(cfg, params, dev, policy="accuracytrader",
                  contract=contract, epsilon=ENGINE_EPSILON, estimator=est)
    s = run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0)
    _served(f"[engine contract] {contract}", eng)
    if not all(len(r.est_raw) == ENGINE_NEW and r.band_lo <= r.pred_loss
               <= r.band_hi for r in eng.completed):
      raise AssertionError(f"{contract}: a request lacks its telemetry")
    print(f"[engine contract] {contract} (ε={ENGINE_EPSILON}): n={s['n']} "
          f"p50={s['p50']:.1f} ms p99={s['p99']:.1f} ms mean_budget="
          f"{s['mean_budget']:.2f} pred_loss_mean={s['pred_loss_mean']:.5f} "
          f"measured loss {s['accuracy_loss_pct'] / 100:.5f} "
          f"band_cover_pct={s['band_cover_pct']:.1f} freed_budget_mean="
          f"{s['freed_budget_mean']:.2f} deadline_miss_pct="
          f"{s['deadline_miss_pct']:.1f} admission_p50="
          f"{s['admission_p50']:.1f} ms")
    if contract == "error_bounded":
      host, busy, ops_n = _replay_row(eng, cfg.synopsis.i_max)
      d_host, d_busy, d_ops = deadline_replay
      print(f"[engine contract] budget-{cfg.synopsis.i_max} replay with the "
            f"coverage profile: "
            f"host {host:.3f} ms, device busy {busy:.3f} ms, {ops_n:.0f} "
            f"device ops | deadline replay: host {d_host:.3f} ms, busy "
            f"{d_busy:.3f} ms, {d_ops:.0f} ops | the profile costs "
            f"{busy - d_busy:.3f} ms busy, {ops_n - d_ops:.0f} ops a step")
    del eng
  return _build.launch_counts()


def run_engine_admission(cfg, params, dev):
  """EDF over two SLO classes with predictive shedding, on the contract
  window's arrivals at twice the rate.  Returns the launch counts."""
  from repro_torch.control import AdmissionConfig, parse_slo_classes
  from repro_torch.kernels import _build
  from repro_torch.serve.engine import run_open_loop
  classes = parse_slo_classes(SLO_CLASSES)
  names = [c.name for c in classes]
  _build.reset_launches()
  eng = _engine(cfg, params, dev, policy="accuracytrader",
                admission=AdmissionConfig(order="edf", shed=True,
                                          classes=classes))
  s = run_open_loop(eng, 2 * ENGINE_RATE, ENGINE_WINDOW_S, seed=0,
                    slo_of=lambda rid: names[rid % len(names)])
  _served("[engine admission]", eng)
  n = len(eng.completed)
  if s["served_n"] + s["shed_admission_n"] != n or set(s["classes"]) != \
      set(names):
    raise AssertionError(f"admission accounting: {s}")
  print(f"[engine admission] edf, classes {SLO_CLASSES}, shedding on, "
        f"{2 * ENGINE_RATE} req/s for {ENGINE_WINDOW_S} s: {n} requests, "
        f"served {s['served_n']}, shed at admission "
        f"{s['shed_admission_n']}, shed_pct={s['shed_pct']:.1f} goodput="
        f"{s['goodput_n']} ({s['goodput_per_s']:.3f}/s) p50={s['p50']:.1f} "
        f"ms p99={s['p99']:.1f} ms mean_budget={s['mean_budget']:.2f} "
        f"prefills={s['prefills']}")
  for name in names:
    c = s["classes"][name]
    print(f"[engine admission] {name}: served {c['served_n']} shed "
          f"{c['shed_admission_n']} shed_pct={c['shed_pct']:.1f} goodput="
          f"{c['goodput_n']} p50={c['p50']:.1f} ms p99={c['p99']:.1f} ms "
          f"deadline_miss_pct={c['deadline_miss_pct']:.1f}")
  del eng
  return _build.launch_counts()


def _prefill_plain():
  """Within the block, prefill attention runs its plain version on the
  card (the noise floor of a second correct bf16 prefill)."""
  from repro_torch.kernels import ops, ref
  return _swapped(ops, "flash_prefill", ref.flash_prefill_ref)


@contextlib.contextmanager
def _swapped(module, name, fn):
  saved = getattr(module, name)
  setattr(module, name, fn)
  try:
    yield
  finally:
    setattr(module, name, saved)


def _layer_rel(a, b):
  """max |a - b| / max |b| per layer of (nb, na, ...) tensors."""
  a = a.flatten(2).float()
  b = b.flatten(2).float()
  return ((a - b).abs().amax(-1) / b.abs().amax(-1)).flatten().tolist()


def run_engine_cache(cfg, params, dev, g):
  """The corpus cache at full width: the 100%-repeat arm with the cache on
  and off (fixed budget 32, serial admissions, the second window
  measured), a Zipf window, and delta replay of a 4096-token prefix's
  8192-token extension.  Returns {kind: launch counts}."""
  import numpy as np
  from repro_torch.kernels import _build, ops, ref
  from repro_torch.kernels.synopsis_build import segment_build
  from repro_torch.serve.corpus_cache import CacheConfig
  from repro_torch.serve.engine import EngineRequest, run_open_loop
  C = cfg.synopsis.cluster_size
  arms, launches = {}, {}
  for on in (False, True):
    eng = _engine(cfg, params, dev, policy="fixed", fixed_budget=32,
                  overlap_admission=False,
                  cache=CacheConfig(capacity=4 if on else 0, delta_unit=C))
    run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0, zipf_corpora=1)
    _build.reset_launches()
    s = run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0,
                      zipf_corpora=1)
    launches["hit" if on else "miss"] = _build.launch_counts()
    _served(f"[engine cache] cache {'on' if on else 'off'}", eng)
    arms[on] = (s, [r.tokens for r in sorted(eng.completed,
                                             key=lambda r: r.rid)])
    if not on:
      del eng
  (s_on, ids_on), (s_off, ids_off) = arms[True], arms[False]
  print(f"[engine cache] 100%-repeat arm (1 corpus), fixed 32, serial "
        f"admissions, second window: cache on {s_on['cache_hits']:.0f} hits "
        f"of {s_on['n']}, prefills {s_on['prefills']}, admission_p50 (hits) "
        f"{s_on['admission_p50']:.2f} ms p99 {s_on['admission_p99']:.2f} ms, "
        f"request p50 {s_on['p50']:.1f} ms | cache off prefills "
        f"{s_off['prefills']}, admission_p50 (misses) "
        f"{s_off['admission_p50']:.2f} ms p99 {s_off['admission_p99']:.2f} "
        f"ms, request p50 {s_off['p50']:.1f} ms")
  delta = s_on["accuracy_loss_pct"] - s_off["accuracy_loss_pct"]
  print(f"[engine cache] loss delta {delta} (on - off), ids equal "
        f"{ids_on == ids_off}")
  if delta != 0 or ids_on != ids_off or s_on["prefills"] != 0 or \
      s_on["cache_hits"] != s_on["n"]:
    raise AssertionError("the repeat arm's hits differ from its misses")
  _require_launches("engine cache hits", launches["hit"], (),
                    absent=("flash_prefill", "segment_build"))

  torch.cuda.reset_peak_memory_stats()
  s = run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0,
                    zipf_corpora=4)
  _served("[engine cache] zipf", eng)
  print(f"[engine cache] zipf window (4 corpora, capacity 4): hit_rate="
        f"{s['cache_hit_rate']:.3f} ({s['cache_hits']:.0f} hits, "
        f"{s['cache_misses']:.0f} misses, {s['cache_evictions']:.0f} "
        f"evictions), entries {s['cache_entries']:.0f}, arena bytes "
        f"{s['cache_bytes'] / 1e9:.3f} GB, peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}, p50="
        f"{s['p50']:.1f} ms admission_p50={s['admission_p50']:.2f} ms")

  # Delta replay: the prefix's arena published, then its extension.
  P = PROMPT // 2
  prompt = torch.randint(0, cfg.vocab, (PROMPT,), generator=g,
                         device=dev).cpu().numpy().astype(np.int32)
  eng.reset()
  lg, pre = eng._prefill(params, eng._stage(prompt[:P]))
  arena = eng._build(pre)
  del pre
  e = eng.corpus_cache.publish(prompt[:P], arena, lg.argmax(-1))
  eng.corpus_cache.release(e.key)
  req = EngineRequest(rid=0, arrival_ms=0.0, prompt=prompt,
                      max_new_tokens=ENGINE_NEW)
  _build.reset_launches()
  with _first_inputs(ops, ("segment_build",)) as seen:
    eng._admit(req, 0)
  launches["extend"] = _build.launch_counts()
  other = EngineRequest(rid=1, arrival_ms=0.0, prompt=np.roll(prompt, 1),
                        max_new_tokens=ENGINE_NEW)
  eng._admit(other, 1)
  cst = eng.corpus_cache.stats()
  print(f"[engine cache] delta replay: prefix {P} tokens (M={P // C}) + "
        f"extension {PROMPT - P} -> {PROMPT} (M={PROMPT // C}): extension "
        f"admission {req.admit_wall_ms:.1f} ms against a full admission "
        f"(miss) {other.admit_wall_ms:.1f} ms; cache {cst}")
  if cst["delta_hits"] != 1 or cst["misses"] != 1:
    raise AssertionError(f"the extension was not replayed: {cst}")
  _require_launches("engine cache extension", launches["extend"],
                    ("segment_build",), absent=("flash_prefill",))
  # segment_build at the extension's shape, against its plain version.
  (k, v, perm), kw = seen["segment_build"]
  del seen
  if kw.pop("quant", None) is not None:
    raise AssertionError("the extension builds unquantized")
  got = segment_build(k, v, perm, **kw)
  want = ref.synopsis_build_ref(k, v, perm, **kw)
  err = _check("segment_build extension", k.dtype, got, want,
               *BF16_OUT_TOL)
  N, Hkv, E, D = k.shape
  M = E // kw["cluster_size"]
  rec = _bound_share(_record(
      "segment_build", "src/repro_torch/kernels/csrc/segment_build.cu",
      "src/repro/kernels/synopsis_build.py:173", k.dtype, err,
      lambda: segment_build(k, v, perm, **kw),
      lambda: ref.synopsis_build_ref(k, v, perm, **kw),
      _nbytes(k, v, perm, *got), 2 * N * Hkv * E * D + 2 * N * Hkv * M * D),
      k.dtype)
  print(f"[engine cache] segment_build at the extension's shape: {N} "
        f"sequences x {tuple(k.shape[1:])}, {M} clusters: device "
        f"{rec['device_ms']:.4f} ms against {rec['bound_ms']:.4f} ms bound "
        f"({rec['bound_by']}), {launches['extend']['segment_build']} "
        "launch(es) an extension")
  del got, want, k, v, perm

  # The extension's KV against the full prefill's slice, in bf16.  Each
  # layer's bound is relative to max|full|: twice the distance of a second
  # correct bf16 prefill (the plain attention version on the card) from
  # the kernel's, plus one bf16 ulp at the top of the range (2^-7): the
  # random init's activations amplify a last-bit difference layer by
  # layer, in any two bf16 prefills, until two prefills of 32 layers are
  # unrelated from layer ~9 on and pick different first tokens.  So the
  # first token is held to the full prefill's with the depth cut to one
  # layer (full width), and at full depth to the admission's own.
  lg_e, (k_e, v_e) = eng._extend(params, eng._stage(prompt[P:]),
                                 arena["k"], arena["v"], P)
  lg_f, full = eng._prefill(params, eng._stage(prompt))
  with _prefill_plain():
    lg_p, plain = eng._prefill(params, eng._stage(prompt))
  firsts = {n: int(x.argmax()) for n, x in (("extension", lg_e),
                                            ("full", lg_f), ("plain", lg_p))}
  shallow = _delta_first_tokens(cfg, params, eng, prompt, P)
  worst = 0.0
  for name, ext in (("k", k_e), ("v", v_e)):
    e_ext = _layer_rel(ext, full[name][..., P:, :])
    e_plain = _layer_rel(plain[name][..., P:, :], full[name][..., P:, :])
    e_pe = _layer_rel(ext, plain[name][..., P:, :])
    ratio = [a / (2 * b + 2.0 ** -7) for a, b in zip(e_ext, e_plain)]
    worst = max(worst, max(ratio))
    print(f"[engine cache] extension {name} vs the full prefill, max err / "
          f"max|full| by layer: "
          + " ".join(f"{x:.2e}" for x in e_ext))
    print(f"  [engine cache] plain-attention prefill {name} vs the kernel's: "
          + " ".join(f"{x:.2e}" for x in e_plain))
    print(f"  [engine cache] extension {name} vs the plain-attention "
          f"prefill: " + " ".join(f"{x:.2e}" for x in e_pe))
  print(f"[engine cache] extension KV: worst layer at {worst:.3f} of its "
        f"bound (2 x plain-vs-kernel + 2^-7 of max|full|); first token at "
        f"{cfg.n_layers} layers: {firsts}, the admission's {req.tokens[0]}; "
        f"at one "
        f"layer: {shallow}")
  if worst > 1.0 or req.tokens[0] != firsts["extension"] or \
      shallow["extension"] != shallow["full"]:
    raise AssertionError("the extension's KV or first token differs from "
                         "the full prefill's")
  del eng, arena, full, plain, k_e, v_e
  return launches


def _delta_first_tokens(cfg, params, eng, prompt, P):
  """The delta path at full width with the depth cut to the first layer:
  {path: first token} of the extension (prefix arena + extension step),
  the full prefill and the plain-attention full prefill."""
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.prefill import make_extend_step, make_prefill_step
  cut = dataclasses.replace(cfg, n_layers=1)

  def first(tree):
    return {k: first(x) if isinstance(x, dict) else x[:1]
            for k, x in tree.items()}
  p1 = {**params, "blocks": first(params["blocks"])}
  prefill = make_prefill_step(cut)
  _, pre = prefill(p1, eng._stage(prompt[:P]))
  arena = skv.build(pre, cut)
  lg_e, _ = make_extend_step(cut)(p1, eng._stage(prompt[P:]), arena["k"],
                                  arena["v"], P)
  lg_f, _ = prefill(p1, eng._stage(prompt))
  with _prefill_plain():
    lg_p, _ = prefill(p1, eng._stage(prompt))
  rel = float((lg_e - lg_f).abs().max() / lg_f.abs().max())
  print(f"[engine cache] one layer: extension logits vs the full prefill's "
        f"max err {rel:.2e} of max|full|")
  return {n: int(x.argmax()) for n, x in (("extension", lg_e),
                                          ("full", lg_f), ("plain", lg_p))}


def run_pipeline(cfg, params, dev):
  """``--batches 2`` serial against ``--pipeline`` (B = BATCH, PROMPT
  tokens): both walls, and batch 0's cache equal in both lanes.  Returns
  the pipelined lane's launch counts."""
  from repro_torch.kernels import _build
  from repro_torch.launch import serve
  outs = {}
  for pipeline in (False, True):
    torch.cuda.empty_cache()
    _build.reset_launches()
    outs[pipeline] = serve.run(cfg, batch=BATCH, prompt_len=PROMPT, tokens=0,
                               batches=2, pipeline=pipeline, device=dev,
                               params=params, log=print)
    launches = _build.launch_counts()
  equal = all(torch.equal(outs[False]["cache"][k], t)
              for k, t in outs[True]["cache"].items()) and torch.equal(
                  outs[False]["tokens"], outs[True]["tokens"])
  print(f"[pipeline] 2 batches x B={BATCH} x {PROMPT} tokens: serial "
        f"{outs[False]['prefill_build_ms']:.1f} ms (prefill "
        f"{outs[False]['prefill_ms']:.1f} + build "
        f"{outs[False]['build_ms']:.1f}), pipelined "
        f"{outs[True]['prefill_build_ms']:.1f} ms; batch-0 caches and first "
        f"tokens equal: {equal}")
  if not equal:
    raise AssertionError("the pipelined lane's batch 0 differs from the "
                         "serial lane's")
  del outs
  return launches


# ---------------------------------------------------------------------------
# Phase 11b: the scatter-gather cluster tier on its stacked path, at
# llama3-8b's full width and depth (the engine phase's shapes)
# ---------------------------------------------------------------------------

# N components over the engine phase's prompt (M = 64 clusters of 128), the
# budget of i_max = 32; the second window's Zipf exponent over the
# components' shares, its route, replicas and fault world (the JAX
# launcher's --faults example: component 1 crashes at step 8, forever).
CLUSTER_N, CLUSTER_BUDGET = 4, 32
CLUSTER_SKEW = 1.2
CLUSTER_FAULTS = "crash=1@8,seed=3"
# The kernels a cluster step launches: stage 1 and stage 2 over the B*N
# folded rows, flash_decode over the frontend's recent ring and self KV.
CLUSTER_KERNELS = ("fused_synopsis_score_attention", "block_gather_attention",
                   "flash_decode")
# The cluster step's copies beyond the single-component step's, a layer:
# the query's N-fold repeat, and the frontend's small tables (score
# relayout, selections and budgets cast to int32 or f32: each at most
# B*Hkv*N*m_max entries of 8 bytes), of which it makes fewer than this.
# A shard of one component of one layer is B*Hkv*m_max*C*D entries, C*D =
# 16384 times a table's.
CLUSTER_FRONTEND_TABLES = 8
CLUSTER_SOURCES = {
    "fused_synopsis_score_attention": ("fused_synopsis.cu",
                                       "fused_synopsis.py:139"),
    "block_gather_attention": ("block_gather.cu",
                               "block_gather_attention.py:255"),
    "flash_decode": ("flash_decode.cu", "flash_decode.py:125")}


@contextlib.contextmanager
def _plain_decode():
  """Within the block the decode wrappers ``ops`` calls run their plain
  versions, on the card's tensors."""
  from repro_torch.kernels import ops, ref
  with _swapped(ops, "fused_synopsis_score_attention",
                ref.fused_synopsis_score_attention_ref), \
      _swapped(ops, "block_gather_attention",
               ref.fused_gather_attention_ref), \
      _swapped(ops, "flash_decode", ref.flash_decode_ref):
    yield


def _component_layer(layer, topo):
  """One layer's single-component slice -> the cluster tier's layout:
  ``k``/``v`` (B, N, Hkv, m_max*C, D), the tables (B, N, Hkv, m_max, D),
  ``counts`` (B, N, m_max), zero on the pads (``ClusterStepBackend.
  write_slot``'s routing, ``route="fixed"``)."""
  N, Mp = topo.n_components, topo.m_max
  counts = layer["counts"]
  C = layer["k"].shape[2] // counts.shape[1]
  out = {n: layer[n] for n in ("recent_k", "recent_v", "recent_len")}
  for name, unit in (("k", C), ("v", C), ("k_syn", 1), ("v_syn", 1)):
    x = layer[name]
    B, Hkv, _, D = x.shape
    o = x.new_zeros((B, N, Hkv, Mp * unit, D))
    for c in range(N):
      off, cnt = topo.offsets[c] * unit, topo.counts[c] * unit
      o[:, c, :, :cnt] = x[:, :, off:off + cnt]
    out[name] = o
  o = counts.new_zeros((counts.shape[0], N, Mp))
  for c in range(N):
    off, cnt = topo.offsets[c], topo.counts[c]
    o[:, c, :cnt] = counts[:, off:off + cnt]
  out["counts"] = o
  return out


def _cluster_modes(kind, N):
  from repro_torch.serve.cluster import MODE_DROP, MODE_FULL, MODE_STAGE1
  return {"full": [MODE_FULL] * N, "drop": [MODE_DROP] * N,
          "mixed": ([MODE_FULL, MODE_STAGE1, MODE_FULL, MODE_DROP]
                    * N)[:N]}[kind]


def check_cluster_attention(cfg, dev, g):
  """One decode step's layer-0 attention of the cluster tier at full width
  (B = ENGINE_SLOTS lanes of an 8192-token prompt, N = CLUSTER_N, budget
  32), in f32 and bf16, kernels against their plain versions on the same
  tensors: ``alloc="topk"`` with every component FULL (also against the
  single-component synopsis attention at the same budget: the same math),
  every component DROP (also against flash_decode over the ring and the
  self token: all that is left), and a FULL/STAGE1/DROP mix under
  ``alloc="mass"`` at skew 0 and CLUSTER_SKEW.  Returns the records of the
  three kernels at the tier's shapes (bf16, the skewed mix: stage 1 over
  B*N rows of m_max centroids, stage 2 over m_max*C-row shards,
  flash_decode over the extras), keyed ``<kernel>[cluster]``."""
  from repro_torch.dist.topology import ComponentTopology
  from repro_torch.kernels import ops, ref
  from repro_torch.serve import cluster as cl
  from repro_torch.serve.serve_step import synopsis_decode_attention
  B, H, Hkv, D = ENGINE_SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.hd
  C, R = cfg.synopsis.cluster_size, cfg.synopsis.recent
  M, N, I = PROMPT // C, CLUSTER_N, CLUSTER_BUDGET
  sm = D ** -0.5
  sdpa = torch.nn.functional.scaled_dot_product_attention
  recs = {}
  for dtype in (torch.float32, torch.bfloat16):
    def rnd(*shape):
      return torch.randn(shape, generator=g, device=dev).to(dtype)
    k, v = rnd(B, Hkv, PROMPT, D), rnd(B, Hkv, PROMPT, D)
    layer = {"k": k, "v": v,
             "k_syn": k.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype),
             "v_syn": v.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype),
             "counts": torch.full((B, M), float(C), device=dev),
             "recent_k": rnd(B, Hkv, R, D), "recent_v": rnd(B, Hkv, R, D),
             "recent_len": torch.tensor([5, 64, 100, R][:B],
                                        dtype=torch.int32, device=dev)}
    q = rnd(B, H, D)
    self_kv = (rnd(B, Hkv, 1, D), rnd(B, Hkv, 1, D))
    kw = dict(i_max=I, cluster_size=C, sm_scale=sm, self_kv=self_kv)
    tol = PARTIALS_TOL[dtype]
    for label, alloc, skew, modes in (
        ("topk FULL", "topk", 0.0, "full"), ("DROP", "topk", 0.0, "drop"),
        ("mass mix", "mass", 0.0, "mixed"),
        ("mass mix", "mass", CLUSTER_SKEW, "mixed")):
      topo = ComponentTopology.plan(M, N, skew)
      csl = _component_layer(layer, topo)
      csl["fe_mode"] = torch.tensor(_cluster_modes(modes, N),
                                    dtype=torch.int32, device=dev)
      attn = cl.make_cluster_attention(topo, alloc=alloc)
      tag = f"cluster attention {label} skew={skew} N={N} m_max=" \
            f"{topo.m_max} I={I}"
      keep = dtype == torch.bfloat16 and skew == CLUSTER_SKEW
      with (_first_inputs(ops, CLUSTER_KERNELS) if keep
            else contextlib.nullcontext()) as seen:
        got, aux = attn(q, csl, **kw)
      with _plain_decode():
        want, _ = attn(q, csl, **kw)
      _check(tag, dtype, got, want, *tol)
      if modes == "full":
        single = synopsis_decode_attention(q, layer, **kw)
        _check(f"{tag} against single-component", dtype, got, single, *tol)
        if float(aux["fe_cover"].sum()) != min(I, M):
          raise AssertionError(f"{tag}: the components refined "
                               f"{aux['fe_cover'].tolist()}, not {I}")
      if modes == "drop":
        ek, ev, eb = ops.build_extras(layer["recent_k"], layer["recent_v"],
                                      layer["recent_len"], self_kv)
        bias = eb[:, None, :].expand(B, Hkv, eb.shape[1]).contiguous()
        _check(f"{tag} against flash_decode over the extras", dtype, got,
               ops.decode_partials(q, ek, ev, bias, sm_scale=sm)[0], *tol)
      print(f"  [{tag} {str(dtype)[6:]}] fe_cover "
            f"{[round(x, 2) for x in aux['fe_cover'].tolist()]} fe_mass "
            f"{[round(x, 3) for x in aux['fe_mass'].tolist()]}")
      if keep:
        recs.update(_cluster_records(seen, dtype, G=H // Hkv, C=C,
                                     sdpa=sdpa))
    del k, v, layer
  return recs


def _cluster_records(seen, dtype, *, G, C, sdpa, tag="[cluster]",
                     names=CLUSTER_KERNELS, source=None):
  """Each cluster kernel on the inputs the tier gave it (first call),
  against its plain version, timed beside its bound: bytes that this
  run's data needs (stage 1 the valid centroid rows, stage 2 the selected
  clusters' rows, through the fleet tier's row map where it has one).
  ``source``: {kernel: its source under csrc/} where it is not
  CLUSTER_SOURCES'.  Records keyed ``<kernel><tag>``."""
  from repro_torch.kernels import ops, ref
  plain = {"fused_synopsis_score_attention":
               ref.fused_synopsis_score_attention_ref,
           "block_gather_attention": ref.fused_gather_attention_ref,
           "flash_decode": ref.flash_decode_ref}
  recs = {}
  for name in names:
    args, kw = seen[name]
    kern = getattr(ops, name)
    out = kern(*args, **kw)
    want = plain[name](*args, **kw)
    q = args[0]
    BN, H, D = q.shape
    lib = None
    if name == "fused_synopsis_score_attention":
      k_syn, v_syn, cbias = args[1:4]
      valid = int((cbias > NEG_INF / 2).sum()) * k_syn.shape[1]
      got, exp = (out[0], *out[1]), (want[0], *want[1])
      err = _check(f"{name}{tag} B*N={BN} m_max={k_syn.shape[2]}", dtype,
                   got, exp, *_stage1_tol(dtype, k_syn.shape[2]))
      nbytes = _nbytes(q, cbias, *got) + 2 * valid * D * k_syn.element_size()
      ops_n = 4 * G * D * valid
    elif name == "block_gather_attention":
      k, sel = args[1], args[3]
      n_sel = int((sel >= 0).sum())
      err = _check(f"{name}{tag} B*N={BN} S={k.shape[2]} "
                   f"I={sel.shape[-1]} ({n_sel} selected)"
                   + (f" rows of {k.shape[0]} through the row map"
                      if kw.get("rows") is not None else ""), dtype, out,
                   want, *PARTIALS_TOL[dtype])
      # The recent ring and self token where they fold in (the sharded
      # synopsis path's shard 0).
      ex = [kw[n] for n in ("extras_k", "extras_v", "extras_bias")
            if kw.get(n) is not None]
      n_ex = ex[0].shape[2] * ex[0].shape[0] * ex[0].shape[1] if ex else 0
      nbytes = (_nbytes(q, sel, kw["k_sel"], kw["v_sel"], kw["sel_bias"],
                        *ex, *out) + 2 * n_sel * C * D * k.element_size())
      ops_n = 4 * G * D * (n_sel * C + n_sel + n_ex)
    else:
      ek, ev, bias = args[1:4]
      err = _check(f"{name}{tag} extras E={ek.shape[2]}", dtype, out,
                   want, *PARTIALS_TOL[dtype])
      nbytes = _nbytes(q, ek, ev, bias, *out)
      ops_n = 4 * BN * H * ek.shape[2] * D
      mask = bias.repeat_interleave(H // ek.shape[1], 1)[:, :, None, :]
      lib = lambda: sdpa(q[:, :, None], ek, ev, attn_mask=mask,  # noqa
                         enable_gqa=True)
    src, line = CLUSTER_SOURCES[name]
    src = (source or {}).get(name, src)
    r = _record(f"{name}{tag}", f"src/repro_torch/kernels/csrc/{src}",
                f"src/repro/kernels/{line}", dtype, err,
                lambda: kern(*args, **kw), lambda: plain[name](*args, **kw),
                nbytes, ops_n, library_fn=lib)
    recs[r["name"]] = _bound_share(r, dtype)
  return recs


def _copy_rows(fn, calls=3):
  """The profiler's copy rows of one call of ``fn`` (Memcpy DtoD and the
  elementwise copy kernels): (rows a call, device ms a call)."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  rows = [e for e in prof.key_averages()
          if e.device_type != torch.autograd.DeviceType.CPU
          and e.self_device_time_total > 0
          and ("Memcpy" in e.key or "copy" in e.key.lower())]
  return (sum(e.count for e in rows) / calls,
          sum(e.self_device_time_total for e in rows) / 1e3 / calls)


COPY_OPS = ("copy_", "clone", "_to_copy", "cat", "stack")
# The ops that copy rows picked by index: an indexed shard would show here.
GATHER_OPS = ("index", "index_select", "gather", "take")


def _copy_bytes(fn, ops_=COPY_OPS):
  """The copies one eager call of ``fn`` makes, from the aten ops
  themselves (a TorchDispatchMode): ``ops_`` (by default copy_, clone,
  _to_copy, cat and stack), counted by the bytes each writes.  Returns
  (total bytes, largest single copy's bytes, {op: bytes}, {(op, shape,
  type): bytes})."""
  from torch.utils._python_dispatch import TorchDispatchMode
  per, big, shapes = {}, [0], {}

  class Count(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      out = func(*args, **(kwargs or {}))
      name = func._overloadpacket.__name__
      if name in ops_:
        outs = out if isinstance(out, (list, tuple)) else (out,)
        ts = [t for t in outs if isinstance(t, torch.Tensor)]
        n = sum(t.numel() * t.element_size() for t in ts)
        per[name] = per.get(name, 0) + n
        big[0] = max(big[0], n)
        key = (name, tuple(ts[0].shape), str(ts[0].dtype)[6:])
        shapes[key] = shapes.get(key, 0) + n
      return out

  with Count():
    fn()
  torch.cuda.synchronize()
  return sum(per.values()), big[0], per, shapes


def cluster_step_table(cfg, params, dev):
  """The budget-32 step of a cluster engine (N = CLUSTER_N, a
  FULL/STAGE1/FULL/DROP gather) beside the single-component engine's, both
  at policy ``fixed`` with the same ENGINE_SLOTS requests resident: the
  graph replay against its eager call (bitwise), host ms, CUDA-event ms,
  device busy ms and ops, the kernels' launches inside one replay (stage
  1 and stage 2 once a layer, not N times), and the step's copies: the
  profiler's copy rows of a replay, and the bytes the eager call's aten
  copies write.  The cluster step may copy more than the single step by
  the query's N-fold repeat and the frontend's score table (B*Hkv*N*m_max
  f32) a layer, no more, and no copy may be as large as one component's
  shard of one layer: the shards are read in place."""
  from repro_torch.serve.cluster import ClusterConfig, ClusterStepBackend
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        make_requests)
  key = ("step", CLUSTER_BUDGET)
  rows = {}
  for label in ("single", "cluster"):
    torch.cuda.empty_cache()
    backend = ClusterStepBackend(ClusterConfig(n_components=CLUSTER_N)) \
        if label == "cluster" else None
    eng = ServingEngine(cfg, EngineConfig(
        n_slots=ENGINE_SLOTS, prompt_len=PROMPT, max_new_tokens=ENGINE_NEW,
        policy="fixed", fixed_budget=CLUSTER_BUDGET), params=params,
        device=dev, backend=backend)
    for slot, req in enumerate(make_requests(
        [0.0] * ENGINE_SLOTS, PROMPT, ENGINE_NEW, cfg.vocab, seed=21)):
      eng._admit(req, slot)
    if backend is not None:
      backend.load_mode(np.asarray(_cluster_modes("mixed", CLUSTER_N)))
    outs = {}
    for mode, fn in (("replay", lambda: eng.programs.run(key)),
                     ("eager", lambda: eng.programs.call_eager(key))):
      fn()
      torch.cuda.synchronize()
      outs[mode] = {k: t.clone() for k, t in eng.step_out.items()}
    equal = all(torch.equal(outs["replay"][k], outs["eager"][k])
                for k in outs["replay"])
    replay = lambda: eng.programs.run(key)  # noqa: E731
    host, busy, ops_n = _replay_row(eng, CLUSTER_BUDGET)
    ev = _median_ms(replay, reps=10)
    _, _, per, _ = _profile_rows(replay, 3)
    n_copy, copy_ms = _copy_rows(replay)
    c_bytes, c_big, c_per, c_shapes = _copy_bytes(
        lambda: eng.programs.call_eager(key))
    rows[label] = dict(host=host, busy=busy, ops=ops_n, per=per,
                       bytes=c_bytes, big=c_big, shapes=c_shapes)
    print(f"[cluster step] {label} budget {CLUSTER_BUDGET}: replay host "
          f"{host:.3f} ms, events {ev:.3f} ms, device busy {busy:.3f} ms "
          f"({ops_n:.0f} device ops); kernel launches inside one replay "
          f"{ {k: n for k, n in per.items() if n} }; replay bitwise equal "
          f"to its eager call: {equal}")
    print(f"  [cluster step] {label}: copy rows a replay {n_copy:.0f} "
          f"({copy_ms:.3f} ms of device time); eager aten copies write "
          f"{c_bytes / 1e6:.3f} MB ({ {k: n for k, n in c_per.items()} }), "
          f"the largest {c_big / 1e6:.3f} MB")
    if not equal:
      raise AssertionError(f"{label}: the budget-{CLUSTER_BUDGET} replay "
                           "differs from its eager call")
    kernels = ("fused_synopsis_score_attention", "block_gather_attention") \
        + (("flash_decode",) if label == "cluster" else ())
    if any(per.get(k, 0) != cfg.n_layers for k in kernels):
      raise AssertionError(f"{label}: the replay does not launch "
                           f"{kernels} once a layer: {per}")
    if label == "cluster":
      m_max = backend.topo.m_max
    del eng, backend
  B, H, D, Hkv = ENGINE_SLOTS, cfg.n_heads, cfg.hd, cfg.n_kv_heads
  C, L = cfg.synopsis.cluster_size, cfg.n_layers
  itemsize = torch.empty((), dtype=cfg.dtype).element_size()
  repeat = L * CLUSTER_N * B * H * D * itemsize
  table = B * Hkv * CLUSTER_N * m_max * 8     # one frontend table, 8 bytes
  allowed = repeat + L * CLUSTER_FRONTEND_TABLES * table
  shard = B * Hkv * m_max * C * D * itemsize
  extra = rows["cluster"]["bytes"] - rows["single"]["bytes"]
  diff = {k: n - rows["single"]["shapes"].get(k, 0)
          for k, n in rows["cluster"]["shapes"].items()}
  top = sorted(((n, k) for k, n in diff.items() if n), reverse=True)[:8]
  print(f"[cluster step] cluster / single: host "
        f"{rows['cluster']['host'] / rows['single']['host']:.2f}x, device "
        f"busy {rows['cluster']['busy'] / rows['single']['busy']:.2f}x; "
        f"copies {extra / 1e6:+.3f} MB a step: the query's {CLUSTER_N}-fold "
        f"repeat {repeat / 1e6:.3f} MB, the rest the frontend's tables "
        f"(allowed: {CLUSTER_FRONTEND_TABLES} of {table} bytes a layer, "
        f"{allowed / 1e6:.3f} MB in all); largest copy "
        f"{rows['cluster']['big'] / 1e6:.3f} MB, one component's shard of "
        f"a layer {shard / 1e6:.1f} MB")
  print(f"  [cluster step] the copies the cluster step adds, by op, shape "
        f"and type (bytes a step): {top}")
  if extra > allowed or rows["cluster"]["big"] >= shard:
    raise AssertionError("the cluster step copies more than its query's "
                         "repeat and the frontend's tables: a shard is "
                         "copied")
  return rows


def _cluster_window(cfg, params, dev, label, ccfg, policy):
  """One Poisson window (seed 0, ENGINE_RATE req/s for ENGINE_WINDOW_S s)
  on a cluster engine; prints its metrics, fault counters, availability
  and the measured per-component ms at full budget.  Returns (summary,
  launch counts of the build, capture and window)."""
  from repro_torch.kernels import _build
  from repro_torch.serve.cluster import ClusterConfig, ClusterStepBackend
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  backend = ClusterStepBackend(ClusterConfig(**ccfg))
  eng = ServingEngine(cfg, EngineConfig(
      n_slots=ENGINE_SLOTS, prompt_len=PROMPT, max_new_tokens=ENGINE_NEW,
      deadline_ms=ENGINE_DEADLINE_MS, policy=policy), params=params,
      device=dev, backend=backend)
  built = time.perf_counter() - t0
  s = run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0)
  launches = _build.launch_counts()
  comp_ms = [round(float(x), 3)
             for x in backend.export().step_ms_per_component(100)]
  print(f"[cluster engine] {label} {policy}: counts={backend.topo.counts} "
        f"built and captured {len(eng.programs.graphs)} graphs in "
        f"{built:.1f}s; n={s['n']} p50={s['p50']:.1f} ms p99="
        f"{s['p99']:.1f} ms accuracy_loss_pct={s['accuracy_loss_pct']:.3f} "
        f"deadline_miss_pct={s['deadline_miss_pct']:.1f} mean_budget="
        f"{s['mean_budget']:.2f} steps={s['steps']} availability_pct="
        f"{s['availability_pct']:.1f}")
  print(f"  [cluster engine] {label} {policy}: fault_stats "
        f"{backend.fault_stats}; per-component ms at full budget {comp_ms}; "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
  if s["n"] < 8 or not all(len(r.tokens) == ENGINE_NEW + 1
                           for r in eng.completed if not r.dropped):
    raise AssertionError(f"{label} {policy}: the window did not serve "
                         "its requests")
  del eng, backend
  return s, launches


def check_cluster_parity(dev):
  """SMOKE llama3-8b in f32 on the tier (N = 4, skew 1.2): the cluster
  engine on the card (graphs, kernels) and on the CPU (eager, plain
  versions) generate the same ids under ``basic`` and ``fixed`` (budgets
  under accuracytrader follow the host clock)."""
  from repro_torch.configs.registry import get_config
  from repro_torch.models import transformer as tf
  from repro_torch.serve.cluster import ClusterConfig, ClusterStepBackend
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        make_requests, run_open_loop)
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  params = tf.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
  for arm in (dict(policy="basic"), dict(policy="fixed", fixed_budget=2)):
    ids = {}
    for where, p in (("cpu", params), ("card", _tree_to(params, dev))):
      eng = ServingEngine(
          cfg, EngineConfig(n_slots=2, prompt_len=128, max_new_tokens=8,
                            deadline_ms=1e6, **arm), params=p,
          device=dev if where == "card" else "cpu",
          backend=ClusterStepBackend(ClusterConfig(
              n_components=4, skew=CLUSTER_SKEW)))
      run_open_loop(eng, 20.0, 0.3, seed=3)
      ids[where] = [r.tokens for r in sorted(eng.completed,
                                             key=lambda r: r.rid)]
    if ids["card"] != ids["cpu"] or not ids["card"]:
      raise AssertionError(f"cluster engine ids differ on card and CPU "
                           f"({arm}): {ids['card']} vs {ids['cpu']}")
    print(f"[cluster parity] smoke f32 N=4 skew={CLUSTER_SKEW} "
          f"{arm['policy']}: {sum(map(len, ids['card']))} ids of "
          f"{len(ids['card'])} requests equal on card and CPU")


def run_cluster(cfg, params, dev, g):
  """Phase 11b: the tier's attention at full width, its budget-32 step
  beside the single-component one, three engine windows (``--cluster 4``
  under accuracytrader and basic; skew 1.2, rotate, R = 2 and a crash
  under accuracytrader) and the SMOKE parity.  Returns (records keyed
  ``<kernel>[cluster]``, their launches on the accuracytrader window's
  path)."""
  from repro_torch.serve.resilience import parse_fault_spec
  t0 = time.perf_counter()
  recs = check_cluster_attention(cfg, dev, g)
  torch.cuda.empty_cache()
  cluster_step_table(cfg, params, dev)
  launches = None
  summaries = {}
  for label, ccfg, policy in (
      ("N=4", dict(n_components=CLUSTER_N), "accuracytrader"),
      ("N=4", dict(n_components=CLUSTER_N), "basic"),
      (f"N=4 skew={CLUSTER_SKEW} rotate R=2 faults={CLUSTER_FAULTS}",
       dict(n_components=CLUSTER_N, skew=CLUSTER_SKEW, route="rotate",
            replicas=2, faults=parse_fault_spec(CLUSTER_FAULTS)),
       "accuracytrader")):
    s, counts = _cluster_window(cfg, params, dev, label, ccfg, policy)
    summaries[(label, policy)] = s
    if launches is None:
      launches = counts
  _require_launches("cluster engine", launches,
                    ENGINE_KERNELS + ("flash_decode",),
                    absent=("synopsis_score",))
  check_cluster_parity(dev)
  print(f"[cluster] phase in {time.perf_counter() - t0:.1f}s")
  return recs, {f"{k}[cluster]": launches[k] for k in CLUSTER_KERNELS}


# ---------------------------------------------------------------------------
# Phase 11c: the fleet tier (R materialized replica rows) on its stacked path
# ---------------------------------------------------------------------------

FLEET_R = 2


def _free():
  """Collect the engines just deleted: an engine and its step backend hold
  each other, so their pools (the fleet's is twice the cluster's) go only
  with the cyclic collector, here rather than inside a later capture."""
  gc.collect()
  torch.cuda.empty_cache()


def _fleet_layer(csl, R):
  """One layer of the cluster layout -> the fleet tier's (B, R, N, ...):
  row r the components rolled right by r (``kv_cache.replicate_leaf``,
  as the slot write lays them), copies made."""
  from repro_torch.serve import kv_cache as kvc
  out = dict(csl)
  for name in ("k", "v", "k_syn", "v_syn", "counts"):
    out[name] = kvc.replicate_leaf(csl[name], R, axis=1).contiguous()
  return out


def check_fleet_attention(cfg, dev, g):
  """One decode step's layer-0 attention of the fleet tier at full width
  (B = ENGINE_SLOTS lanes of an 8192-token prompt, N = CLUSTER_N, R =
  FLEET_R, skew CLUSTER_SKEW, alloc mass, a FULL/STAGE1/FULL/DROP gather,
  budget 32), in f32 and bf16: under three random replica selections the
  kernels against their plain versions on the same tensors, and each
  output bitwise equal to the all-primary one (every copy is
  bit-identical and the fold runs in shard order).  Returns the records of
  the three kernels at the tier's shapes (bf16, the first selection; stage
  2 reads the selected lanes in place through its row map), keyed
  ``<kernel>[fleet]``."""
  from repro_torch.dist.topology import plan_2d
  from repro_torch.kernels import ops
  from repro_torch.serve import fleet as fl
  B, H, Hkv, D = ENGINE_SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.hd
  C, R = cfg.synopsis.cluster_size, cfg.synopsis.recent
  M, N, I = PROMPT // C, CLUSTER_N, CLUSTER_BUDGET
  sm = D ** -0.5
  sdpa = torch.nn.functional.scaled_dot_product_attention
  topo = plan_2d(M, N, FLEET_R, skew=CLUSTER_SKEW)
  attn = fl.make_fleet_attention(topo, alloc="mass")
  rng = np.random.default_rng(11)
  sels = [rng.integers(0, FLEET_R, N).astype(np.int32) for _ in range(3)]
  sels[0][0] = 1                     # at least one shard off its primary
  recs = {}
  for dtype in (torch.float32, torch.bfloat16):
    def rnd(*shape):
      return torch.randn(shape, generator=g, device=dev).to(dtype)
    k, v = rnd(B, Hkv, PROMPT, D), rnd(B, Hkv, PROMPT, D)
    layer = {"k": k, "v": v,
             "k_syn": k.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype),
             "v_syn": v.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype),
             "counts": torch.full((B, M), float(C), device=dev),
             "recent_k": rnd(B, Hkv, R, D), "recent_v": rnd(B, Hkv, R, D),
             "recent_len": torch.tensor([5, 64, 100, R][:B],
                                        dtype=torch.int32, device=dev)}
    csl = _fleet_layer(_component_layer(layer, topo), FLEET_R)
    del k, v, layer
    csl["fe_mode"] = torch.tensor(_cluster_modes("mixed", N),
                                  dtype=torch.int32, device=dev)
    q = rnd(B, H, D)
    kw = dict(i_max=I, cluster_size=C, sm_scale=sm,
              self_kv=(rnd(B, Hkv, 1, D), rnd(B, Hkv, 1, D)))
    primary, paux = attn(q, dict(csl, fe_replica=torch.zeros(
        N, dtype=torch.int32, device=dev)), **kw)
    for i, sel in enumerate(sels):
      c = dict(csl, fe_replica=torch.from_numpy(sel).to(dev))
      keep = dtype == torch.bfloat16 and i == 0
      with (_first_inputs(ops, CLUSTER_KERNELS) if keep
            else contextlib.nullcontext()) as seen:
        got, aux = attn(q, c, **kw)
      with _plain_decode():
        want, _ = attn(q, c, **kw)
      tag = (f"fleet attention mass mix skew={CLUSTER_SKEW} N={N} "
             f"R={FLEET_R} m_max={topo.m_max} I={I} fe_replica="
             f"{sel.tolist()}")
      _check(tag, dtype, got, want, *PARTIALS_TOL[dtype])
      same = torch.equal(got, primary) and torch.equal(
          aux["fe_cover"], paux["fe_cover"])
      print(f"  [{tag} {str(dtype)[6:]}] bitwise equal to the all-primary "
            f"output: {same}; fe_cover "
            f"{[round(x, 2) for x in aux['fe_cover'].tolist()]}")
      if not same:
        raise AssertionError(f"{tag}: the output follows the selection")
      if keep:
        if seen["block_gather_attention"][1].get("rows") is None:
          raise AssertionError("the fleet's stage 2 took no row map")
        recs.update(_cluster_records(seen, dtype, G=H // Hkv, C=C,
                                     sdpa=sdpa, tag="[fleet]"))
    del csl
  return recs


def fleet_step_table(cfg, params, dev):
  """The budget-32 step of a fleet engine (N = CLUSTER_N, R = FLEET_R) beside
  the cluster engine's (the same gather modes), both at policy ``fixed``
  with the same ENGINE_SLOTS requests resident: the replay against its
  eager call (bitwise) and, for the fleet, against the replay under a
  random selection (bitwise: the output cannot follow it); host ms,
  CUDA-event ms, device busy ms and ops; stage 1 and stage 2 launched once
  a layer inside a replay; and the step's copies and gathers (the aten
  ops that copy, ``index_select`` / ``index`` / ``gather`` included, by
  the bytes each writes): no single one as large as one component's shard
  of one layer, and the fleet's beyond the cluster's no more than its
  gathered stage-1 tables (B*N rows of k_syn, v_syn and counts a layer)."""
  from repro_torch.serve.cluster import ClusterConfig, ClusterStepBackend
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        make_requests)
  from repro_torch.serve.fleet import FleetConfig, FleetStepBackend
  key = ("step", CLUSTER_BUDGET)
  modes = np.asarray(_cluster_modes("mixed", CLUSTER_N), np.int32)
  sel = np.asarray([1, 0, 1, 1][:CLUSTER_N], np.int32)
  rows = {}
  for label in ("cluster", "fleet"):
    torch.cuda.empty_cache()
    backend = (FleetStepBackend(FleetConfig(n_components=CLUSTER_N,
                                            replicas=FLEET_R))
               if label == "fleet" else
               ClusterStepBackend(ClusterConfig(n_components=CLUSTER_N)))
    eng = ServingEngine(cfg, EngineConfig(
        n_slots=ENGINE_SLOTS, prompt_len=PROMPT, max_new_tokens=ENGINE_NEW,
        policy="fixed", fixed_budget=CLUSTER_BUDGET), params=params,
        device=dev, backend=backend)
    for slot, req in enumerate(make_requests(
        [0.0] * ENGINE_SLOTS, PROMPT, ENGINE_NEW, cfg.vocab, seed=21)):
      eng._admit(req, slot)
    load = ((lambda s: backend.load_mode(np.stack([modes, s])))
            if label == "fleet" else (lambda s: backend.load_mode(modes)))
    load(np.zeros_like(sel))
    outs = {}
    for mode, fn in (("replay", lambda: eng.programs.run(key)),
                     ("eager", lambda: eng.programs.call_eager(key))):
      fn()
      torch.cuda.synchronize()
      outs[mode] = {k: t.clone() for k, t in eng.step_out.items()}
    equal = all(torch.equal(outs["replay"][k], outs["eager"][k])
                for k in outs["replay"])
    moved = True
    if label == "fleet":
      load(sel)
      eng.programs.run(key)
      torch.cuda.synchronize()
      moved = all(torch.equal(outs["replay"][k], t)
                  for k, t in eng.step_out.items())
    replay = lambda: eng.programs.run(key)  # noqa: E731
    host, busy, ops_n = _replay_row(eng, CLUSTER_BUDGET)
    ev = _median_ms(replay, reps=10)
    _, _, per, _ = _profile_rows(replay, 3)
    n_copy, copy_ms = _copy_rows(replay)
    c_bytes, c_big, c_per, c_shapes = _copy_bytes(
        lambda: eng.programs.call_eager(key), COPY_OPS + GATHER_OPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows[label] = dict(host=host, busy=busy, ops=ops_n, bytes=c_bytes,
                       big=c_big, shapes=c_shapes)
    print(f"[fleet step] {label} budget {CLUSTER_BUDGET}: replay host "
          f"{host:.3f} ms, events {ev:.3f} ms, device busy {busy:.3f} ms "
          f"({ops_n:.0f} device ops); kernel launches inside one replay "
          f"{ {k: n for k, n in per.items() if n} }; replay bitwise equal "
          f"to its eager call: {equal}"
          + (f"; to the replay reading replicas {sel.tolist()}: {moved}"
             if label == "fleet" else ""))
    print(f"  [fleet step] {label}: copy rows a replay {n_copy:.0f} "
          f"({copy_ms:.3f} ms of device time); eager aten copies and "
          f"gathers write {c_bytes / 1e6:.3f} MB ({c_per}), the largest "
          f"{c_big / 1e6:.3f} MB; peak_mem_gb={peak:.2f}")
    if not (equal and moved):
      raise AssertionError(f"{label}: the budget-{CLUSTER_BUDGET} replay "
                           "differs from its eager call or follows the "
                           "selection")
    if any(per.get(k, 0) != cfg.n_layers for k in CLUSTER_KERNELS):
      raise AssertionError(f"{label}: the replay does not launch "
                           f"{CLUSTER_KERNELS} once a layer: {per}")
    m_max = backend.topo.m_max
    del eng, backend
    _free()
  B, D, Hkv = ENGINE_SLOTS, cfg.hd, cfg.n_kv_heads
  C, L = cfg.synopsis.cluster_size, cfg.n_layers
  itemsize = torch.empty((), dtype=cfg.dtype).element_size()
  shard = B * Hkv * m_max * C * D * itemsize
  tables = L * B * CLUSTER_N * m_max * (2 * Hkv * D * itemsize + 4)
  extra = rows["fleet"]["bytes"] - rows["cluster"]["bytes"]
  diff = {k: n - rows["cluster"]["shapes"].get(k, 0)
          for k, n in rows["fleet"]["shapes"].items()}
  top = sorted(((n, k) for k, n in diff.items() if n), reverse=True)[:6]
  print(f"[fleet step] fleet / cluster: host "
        f"{rows['fleet']['host'] / rows['cluster']['host']:.2f}x, device "
        f"busy {rows['fleet']['busy'] / rows['cluster']['busy']:.2f}x, ops "
        f"{rows['fleet']['ops'] - rows['cluster']['ops']:+.0f}; copies and "
        f"gathers {extra / 1e6:+.3f} MB a step (the gathered stage-1 "
        f"tables: {tables / 1e6:.3f} MB); largest {rows['fleet']['big'] / 1e6:.3f}"
        f" MB against one component's shard of a layer {shard / 1e6:.1f} MB;"
        f" the fleet's additions {top}")
  if rows["fleet"]["big"] >= shard or extra > 1.25 * tables:
    raise AssertionError("the fleet step copies a shard, or more than its "
                         "stage-1 tables")
  return rows


def _fleet_window(cfg, params, dev, policy):
  """One Poisson window (seed 0, ENGINE_RATE req/s for ENGINE_WINDOW_S s)
  on the fleet tier (``--fleet --cluster CLUSTER_N --replicas FLEET_R``):
  p50 / p99, loss, misses, the steps whose selection read a replica
  other than a primary, per-component ms at full budget, peak memory.
  Returns (summary, launch counts, the backend's measured export)."""
  from repro_torch.kernels import _build
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  from repro_torch.serve.fleet import FleetConfig, FleetStepBackend
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  backend = FleetStepBackend(FleetConfig(n_components=CLUSTER_N,
                                         replicas=FLEET_R))
  eng = ServingEngine(cfg, EngineConfig(
      n_slots=ENGINE_SLOTS, prompt_len=PROMPT, max_new_tokens=ENGINE_NEW,
      deadline_ms=ENGINE_DEADLINE_MS, policy=policy), params=params,
      device=dev, backend=backend)
  built = time.perf_counter() - t0
  sels = []
  account = backend.account

  def counted(budget, wall, plan, st, warming=False):
    if not warming:
      sels.append(plan.sel.copy())
    return account(budget, wall, plan, st, warming=warming)
  backend.account = counted
  try:
    s = run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0)
  finally:
    del backend.account            # no reference cycle through the engine
  launches = _build.launch_counts()
  exp = backend.export()
  comp_ms = [round(float(x), 3) for x in exp.step_ms_per_component(100)]
  off = sum(bool(x.any()) for x in sels)
  shards = sum(int((x != 0).sum()) for x in sels)
  print(f"[fleet engine] N={CLUSTER_N} R={FLEET_R} {policy}: grid "
        f"{FLEET_R}x{CLUSTER_N} counts={backend.topo.counts} built and "
        f"captured {len(eng.programs.graphs)} graphs in {built:.1f}s; "
        f"n={s['n']} p50={s['p50']:.1f} ms p99={s['p99']:.1f} ms "
        f"accuracy_loss_pct={s['accuracy_loss_pct']:.3f} deadline_miss_pct="
        f"{s['deadline_miss_pct']:.1f} mean_budget={s['mean_budget']:.2f} "
        f"steps={s['steps']} admission_p50={s['admission_p50']:.1f} ms")
  print(f"  [fleet engine] {policy}: off_primary: {off} of {len(sels)} steps "
        f"read a replica other than a primary ({shards} of "
        f"{len(sels) * CLUSTER_N} shard reads); per-component ms at full "
        f"budget {comp_ms}; peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
  if s["n"] < 8 or not all(len(r.tokens) == ENGINE_NEW + 1
                           for r in eng.completed if not r.dropped):
    raise AssertionError(f"fleet {policy}: the window did not serve its "
                         "requests")
  del eng, backend
  _free()
  return s, launches, exp


def run_autoscale(exp):
  """``--autoscale`` over the 24 Sogou hours from the fleet window's
  measured export (``launch.serve.autoscale_main``; host only): grids up
  to CLUSTER_N x FLEET_R, the p99 target the engine's deadline, and the
  rates scaled so that the peak hour (90 req/s) offers 80% of the full
  grid's modelled capacity (slots x 1000 / (4 steps x its step ms))."""
  import types
  from repro_torch.launch import serve
  from repro_torch.serving.service import ScaledFleetExport
  from repro_torch.serving.workload import SOGOU_HOURLY
  t0 = time.perf_counter()
  step_full = ScaledFleetExport(exp, CLUSTER_N, FLEET_R).step_model(
      CLUSTER_N, FLEET_R)
  capacity = ENGINE_SLOTS * 1000.0 / (4.0 * step_full)
  scale = 0.8 * capacity / max(SOGOU_HOURLY)
  print(f"[autoscale] full grid {CLUSTER_N}x{FLEET_R}: modelled step "
        f"{step_full:.3f} ms, capacity {capacity:.1f} req/s; rate_scale "
        f"{scale:.4f}")
  args = types.SimpleNamespace(
      cluster=CLUSTER_N, replicas=FLEET_R, p99_target=ENGINE_DEADLINE_MS,
      n_slots=ENGINE_SLOTS, rate_scale=scale,
      deadline_ms=ENGINE_DEADLINE_MS, duration=ENGINE_WINDOW_S)
  out = serve.autoscale_main(args, types.SimpleNamespace(export=lambda: exp))
  grids = sorted({(w["n"], w["r"]) for w in out["windows"]})
  print(f"[autoscale] grids used {grids}; component-hours "
        f"{out['component_hours']} against {out['component_hours_static']} "
        f"static ({out['component_hours'] / out['component_hours_static']:.1%}"
        f"); host {time.perf_counter() - t0:.1f}s")
  if len(out["windows"]) != 24:
    raise AssertionError("the autoscaler did not size 24 hours")
  return out


def check_fleet_parity(dev):
  """SMOKE llama3-8b in f32 on the fleet tier (N = 4, R = 2, skew 1.2): the
  fleet engine on the card (graphs, kernels, the row map) and on the CPU
  (eager, plain versions) generate the same ids under ``basic`` and
  ``fixed``."""
  from repro_torch.configs.registry import get_config
  from repro_torch.models import transformer as tf
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  from repro_torch.serve.fleet import FleetConfig, FleetStepBackend
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  params = tf.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
  for arm in (dict(policy="basic"), dict(policy="fixed", fixed_budget=2)):
    ids = {}
    for where, p in (("cpu", params), ("card", _tree_to(params, dev))):
      eng = ServingEngine(
          cfg, EngineConfig(n_slots=2, prompt_len=128, max_new_tokens=8,
                            deadline_ms=1e6, **arm), params=p,
          device=dev if where == "card" else "cpu",
          backend=FleetStepBackend(FleetConfig(
              n_components=4, skew=CLUSTER_SKEW, replicas=FLEET_R)))
      run_open_loop(eng, 20.0, 0.3, seed=3)
      ids[where] = [r.tokens for r in sorted(eng.completed,
                                             key=lambda r: r.rid)]
    if ids["card"] != ids["cpu"] or not ids["card"]:
      raise AssertionError(f"fleet engine ids differ on card and CPU "
                           f"({arm}): {ids['card']} vs {ids['cpu']}")
    print(f"[fleet parity] smoke f32 N=4 R={FLEET_R} skew={CLUSTER_SKEW} "
          f"{arm['policy']}: {sum(map(len, ids['card']))} ids of "
          f"{len(ids['card'])} requests equal on card and CPU")


def run_fleet(cfg, params, dev, g):
  """Phase 11c: the fleet tier's attention at full width, its budget-32
  step beside the cluster step, the ``--fleet --cluster 4 --replicas 2``
  window under accuracytrader and basic, the 24-hour autoscaler from the
  accuracytrader window's export, and the SMOKE parity.  Returns (records
  keyed ``<kernel>[fleet]``, their launches on the accuracytrader window's
  path)."""
  t0 = time.perf_counter()
  _free()                                # the cluster phase's engines
  recs = check_fleet_attention(cfg, dev, g)
  torch.cuda.empty_cache()
  fleet_step_table(cfg, params, dev)
  launches = exp = None
  for policy in ("accuracytrader", "basic"):
    _, counts, e = _fleet_window(cfg, params, dev, policy)
    if launches is None:
      launches, exp = counts, e
  _require_launches("fleet engine", launches,
                    ENGINE_KERNELS + ("flash_decode",),
                    absent=("synopsis_score",))
  run_autoscale(exp)
  check_fleet_parity(dev)
  print(f"[fleet] phase in {time.perf_counter() - t0:.1f}s")
  return recs, {f"{k}[fleet]": launches[k] for k in CLUSTER_KERNELS}


# ---------------------------------------------------------------------------
# Phases 12-18: the other architectures at full width (depth cut where
# DEPTH says): gemma2-2b (local and global layers, softcaps, sandwich
# norms, tied embeddings; flash_prefill at D = 256; its table-only
# quantized arena), smollm-135m (G = 3 at D = 64), pixtral-12b (the vision
# stub's patch prefix), whisper-medium (G = 1 at D = 64; the encoder, cross
# blocks, GELU MLPs, attention biases), jamba-v0.1-52b (SSD and MoE
# layers), arctic-480b (an MoE beside a dense MLP, G = 7) and
# command-r-plus-104b (parallel blocks, G = 12)
# ---------------------------------------------------------------------------

# arch -> (record tag, the SMOKE loops held card against CPU: (mode,
# quant) pairs, the table-only quant specs of the full-width phase).
MODELS = {
    "gemma2-2b": ("[gemma2]", (("synopsis", "int8"), ("synopsis", "fp8")),
                  ("int8", "fp8")),
    "smollm-135m": ("[smollm]", (("synopsis", "none"), ("exact", "none")),
                    ()),
    "pixtral-12b": ("[pixtral]", (("synopsis", "none"), ("exact", "none")),
                    ()),
    "whisper-medium": ("[whisper]", (("synopsis", "none"), ("exact", "none"),
                                     ("synopsis", "int8+kv")), ()),
    "jamba-v0.1-52b": ("[jamba]", (("synopsis", "none"), ("exact", "none")),
                       ()),
    "arctic-480b": ("[arctic]", (("synopsis", "none"), ("exact", "none")),
                    ()),
    "command-r-plus-104b": ("[command-r]", (("synopsis", "none"),
                                            ("exact", "none")), ()),
    "deepseek-v2-236b": ("[deepseek]", (("synopsis", "none"),
                                        ("exact", "none"),
                                        ("synopsis", "int8+kv")), ()),
}
# Depth cuts, layers run of the config's: jamba-v0.1-52b's 32 layers are
# ~51.4B parameters, ~103 GB in bf16, which one 80 GB card cannot hold; 16
# layers (2 of its 4 eight-layer superblocks: 2 attention, 14 mamba, 8 MoE
# and 8 dense-MLP layers) are ~26.0B, ~52 GB, and 24 would be ~77 GB of
# weights alone.  arctic-480b's layers hold 128 experts of 7168 x 4864 each
# (26.8 GB in bf16): 2 of its 35 (~55.4 GB with the embeddings) fit, 3 would
# not.  command-r-plus-104b's are 3.15 GB each beside its 6.3 GB tied
# embedding and the 12.6 GB f32 unembedding the logits read: 12 of 64
# (~56.6 GB) leave room for an 8192-token B = 2 prefill's transients; 16
# would hold ~69 GB before them.  deepseek-v2-236b's layers are 7.94 GB
# each (7.55 GB of them the 160 experts): 7 of 60 (~58.8 GB with the 2.1
# GB f32 unembedding) leave room for the prefill's MLA and MoE transients;
# 8 would hold 66.7 GB before them.  The models that fit whole are cut too,
# so that the script stays inside its 1200 s with the apps, training and
# the mesh's cut weights (a whole run with the first two took 1195.9 s on
# one H100; the cut weights took more depth out): gemma2-2b 4 of 26 (2
# local, 2 global), smollm-135m 4 of 30, pixtral-12b 4 of 40,
# whisper-medium's decoder 4 of 24 (its encoder whole), and jamba 8 (one
# superblock: 1 attention, 7 mamba, 4 MoE layers), command-r 3 and
# deepseek 3 of the depths that fit.  Width is never cut.
DEPTH = {"jamba-v0.1-52b": 8, "arctic-480b": 2, "command-r-plus-104b": 3,
         "deepseek-v2-236b": 3, "gemma2-2b": 4, "smollm-135m": 4,
         "pixtral-12b": 4, "whisper-medium": 4}
# The per-model loops' budget: every model's published i_max but
# command-r-plus-104b's, whose 64 is M at prompt 8192 (the full budget).
LOOP_BUDGET = 32


def _loop_budget(cfg):
  return min(LOOP_BUDGET, cfg.synopsis.i_max)


def _n_attn(cfg, local=None):
  """The config's attention layers (of a ``local`` kind, or all)."""
  return cfg.n_blocks * sum(
      s.kind == "attn" and (local is None or s.local == local)
      for s in cfg.block_pattern)


def _pairs_in_window(S, window):
  """(query, key) pairs a causal prefill over S positions attends: all
  S(S+1)/2, or those within ``window`` of the query."""
  if window is None or window >= S:
    return S * (S + 1) // 2
  return window * (window + 1) // 2 + (S - window) * window


def check_model_kernels(cfg, tag, dev, g):
  """Every kernel of the arch's path against its plain version at its
  full-width shapes, bf16: flash_prefill on a global layer (and, where the
  config has local layers, a local one), the build of every layer
  sequence of a B = 2 prompt and its absorb, stage 1 and stage 2 on one
  layer's arena, flash_decode as the path runs it (a local layer's window
  view, or the exact loop's whole cache), synopsis_score (the unfused
  op), all with the config's softcap.  Returns the records, keyed by
  ``<kernel><tag>``.  SDPA is the library time where it computes the same
  function (no softcap); with a cap it is printed as a yardstick only.
  With cross blocks (whisper) also ``flash_decode`` over the encoder's
  ``source_len`` cross rows, the frames path's decode (record
  ``flash_decode[<arch>-cross<T>]``).  Where the group takes the
  tensor-core stream (bf16 in the head bucket of 16: command-r-plus),
  stage 2's and flash_decode's records are that branch's
  (``<kernel>[g16]<tag>``)."""
  from repro_torch.kernels import _build, ops, ref
  from repro_torch.kernels.block_gather_attention import (
      block_gather_attention as gather)
  from repro_torch.kernels.flash_decode import flash_decode
  from repro_torch.kernels.flash_prefill import flash_prefill
  from repro_torch.kernels.fused_synopsis import (
      fused_synopsis_score_attention as fused)
  from repro_torch.kernels.synopsis_build import segment_build
  from repro_torch.kernels.synopsis_score import synopsis_score
  dtype = torch.bfloat16
  B, S, H, Hkv, D = BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.hd
  C, W, cap = cfg.synopsis.cluster_size, cfg.sliding_window, cfg.attn_softcap
  M, I, G = S // C, _loop_budget(cfg), H // Hkv
  local = any(s.local for s in cfg.block_pattern)
  sm = D ** -0.5
  sdpa = torch.nn.functional.scaled_dot_product_attention
  recs = {}

  def rnd(*shape):
    return torch.randn(shape, generator=g, device=dev).to(dtype)

  def rec(kernel, err, kfn, pfn, nbytes, ops_n, src, line, **kw):
    r = _record(f"{kernel}{tag}", f"src/repro_torch/kernels/csrc/{src}",
                f"src/repro/kernels/{line}", dtype, err, kfn, pfn, nbytes,
                ops_n, **kw)
    recs[r["name"]] = r
    return r

  # flash_prefill: the global layer is the record; a local one printed.
  q, k, v = rnd(B, S, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
  qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
  lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa
  times = {}
  for label, window in ((("local", W),) if local else ()) + (
      ("global", None),):
    kw = dict(sm_scale=sm, cap=cap, window=window)
    got = flash_prefill(q, k, v, **kw)
    err = _check(f"flash_prefill{tag} {label} D={D} G={G}", dtype, got,
                 ref.flash_prefill_ref(q, k, v, **kw), *BF16_OUT_TOL)
    ops_n = 4 * B * H * D * _pairs_in_window(S, window)
    if label == "global":
      r = rec("flash_prefill", err, lambda: flash_prefill(q, k, v, **kw),
              lambda: ref.flash_prefill_ref(q, k, v, **kw),
              _nbytes(q, k, v, got), ops_n, "flash_prefill.cu",
              "flash_prefill.py:140", library_fn=None if cap else lib)
      dev_ms, bound = r["device_ms"], r["bound_ms"]
    else:
      fn = lambda: flash_prefill(q, k, v, **kw)  # noqa: E731
      dev_ms = _device_ms(fn, KERNEL_ROWS["flash_prefill"])
      bound = _bound(_nbytes(q, k, v, got), ops_n, dtype)[0]
      print(f"  [flash_prefill{tag} local bf16] ms={_median_ms(fn):.4f}")
    times[label] = dev_ms
    print(f"  [flash_prefill{tag} {label} bf16] {ops_n / 1e12:.3f} TFLOP "
          f"in {dev_ms:.4f} ms of device time ({ops_n / dev_ms / 1e9:.1f} "
          f"TFLOP/s, {1.5 * ops_n / dev_ms / 1e9:.1f} issued with the P "
          f"split); bound {bound:.4f} ms (operations), {bound / dev_ms:.1%} "
          f"of it")
  n_glob, n_loc = _n_attn(cfg, local=False), _n_attn(cfg, local=True)
  prompt_ms = n_glob * times["global"] + n_loc * times.get("local", 0.0)
  print(f"  [flash_prefill{tag}] a prompt's {n_glob + n_loc} launches: "
        f"{prompt_ms:.3f} ms of device time")
  if cap:
    lib_dev = _device_ms(lib, floor_ms=_bound(0, 4 * B * H * D * S * (S + 1)
                                              // 2, dtype)[0])
    print(f"  [yardstick bf16] SDPA at the global layer's shape, causal, "
          f"no softcap (not the same function: SDPA has no softcap): ms="
          f"{_median_ms(lib):.4f} device {lib_dev:.4f} ms; flash_prefill"
          f"{tag} global / SDPA device {times['global'] / lib_dev:.2f}x")
  else:
    print(f"  [flash_prefill{tag}] kernel / SDPA device "
          f"{times['global'] / r['library_device_ms']:.2f}x")
  del q, k, v, qt, kt, vt, got

  # segment_build: every attention layer's sequence of one B = 2 prompt,
  # and the absorb of the 128-token ring.
  N = _n_attn(cfg) * B
  kb, vb = rnd(N, Hkv, S, D), rnd(N, Hkv, S, D)
  perm = torch.argsort(torch.rand((N, S), generator=g, device=dev),
                       dim=-1).to(torch.int32)
  got = segment_build(kb, vb, perm, cluster_size=C)
  err = _check(f"segment_build{tag} N={N} Hkv={Hkv} D={D}", dtype, got,
               ref.synopsis_build_ref(kb, vb, perm, cluster_size=C),
               *BF16_OUT_TOL)
  ring = torch.arange(C, device=dev, dtype=torch.int32).expand(N, C)
  ka, va = kb[:, :, :C].contiguous(), vb[:, :, :C].contiguous()
  _check(f"segment_build{tag} absorb", dtype,
         segment_build(ka, va, ring, cluster_size=C),
         ref.synopsis_build_ref(ka, va, ring, cluster_size=C), *BF16_OUT_TOL)
  _bound_share(rec(
      "segment_build", err,
      lambda: segment_build(kb, vb, perm, cluster_size=C),
      lambda: ref.synopsis_build_ref(kb, vb, perm, cluster_size=C),
      _nbytes(kb, vb, perm, *got),
      2 * N * Hkv * S * D + 2 * N * Hkv * M * D, "segment_build.cu",
      "synopsis_build.py:173"), dtype)
  del kb, vb, perm, got, ka, va

  # The decode kernels on one (global) layer's arena.
  q1, k, v = rnd(B, H, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
  k_syn = k.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype)
  v_syn = v.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype)
  counts = torch.full((B, M), float(C), device=dev)
  cbias = ops.count_bias(counts)
  tol = PARTIALS_TOL[dtype]
  kw = dict(sm_scale=sm, cap=cap)
  got = fused(q1, k_syn, v_syn, cbias, **kw)
  want = ref.fused_synopsis_score_attention_ref(q1, k_syn, v_syn, cbias,
                                                **kw)
  err = _check(f"fused_synopsis{tag} M={M} G={G} cap={cap}", dtype,
               (got[0], *got[1]), (want[0], *want[1]), *_stage1_tol(dtype, M))
  rec("fused_synopsis_score_attention", err,
      lambda: fused(q1, k_syn, v_syn, cbias, **kw),
      lambda: ref.fused_synopsis_score_attention_ref(q1, k_syn, v_syn,
                                                     cbias, **kw),
      _nbytes(q1, k_syn, v_syn, cbias, got[0], *got[1]), 4 * B * H * M * D,
      "fused_synopsis.cu", "fused_synopsis.py:139", cold=True)

  sel = torch.topk(got[0], I, dim=-1).indices.to(torch.int32)
  safe = sel.long()[..., None].expand(-1, -1, -1, D)
  rk, rv = rnd(B, Hkv, cfg.synopsis.recent, D), rnd(B, Hkv,
                                                   cfg.synopsis.recent, D)
  ek, ev, eb = ops.build_extras(rk, rv, None, (rnd(B, Hkv, 1, D),
                                                rnd(B, Hkv, 1, D)))
  gkw = dict(cluster_size=C, sm_scale=sm, cap=cap,
             k_sel=torch.gather(k_syn, 2, safe),
             v_sel=torch.gather(v_syn, 2, safe),
             sel_bias=cbias[:, None, :1].expand(B, Hkv, I).contiguous(),
             extras_k=ek, extras_v=ev, extras_bias=eb)
  got = gather(q1, k, v, sel, **gkw)
  err = _check(f"block_gather{tag} S={S} I={I} E={ek.shape[2]} G={G} "
               f"cap={cap}", dtype, got,
               ref.fused_gather_attention_ref(q1, k, v, sel, **gkw), *tol)
  rows = I * C * B * Hkv
  key = _build.decode_branch("block_gather_attention", dtype, G)
  rec(key, err, lambda: gather(q1, k, v, sel, **gkw),
      lambda: ref.fused_gather_attention_ref(q1, k, v, sel, **gkw),
      _nbytes(q1, sel, gkw["k_sel"], gkw["v_sel"], gkw["sel_bias"], ek, ev,
              eb, *got) + 2 * rows * D * k.element_size(),
      4 * G * D * (rows + B * Hkv * (I + ek.shape[2])),
      "decode_mma.cuh" if key != "block_gather_attention"
      else "block_gather.cu", "block_gather_attention.py:255", cold=True)

  # flash_decode: the exact path's whole cache (recorded, with SDPA as the
  # library call, where the config has no local layer), then a local
  # layer's window as the loop gives it, a view of the layer's cache.
  got = flash_decode(q1, k, v, **kw)
  err = _check(f"flash_decode{tag} S={S} G={G} cap={cap}", dtype, got,
               ref.flash_decode_ref(q1, k, v, **kw), *tol)
  if not local:
    key = _build.decode_branch("flash_decode", dtype, G)
    rec(key, err, lambda: flash_decode(q1, k, v, **kw),
        lambda: ref.flash_decode_ref(q1, k, v, **kw),
        _nbytes(q1, k, v, *got), 4 * B * H * S * D,
        "decode_mma.cuh" if key != "flash_decode" else "flash_decode.cu",
        "flash_decode.py:125", cold=True, library_fn=None if cap else (
            lambda: sdpa(q1[:, :, None], k, v, enable_gqa=True)))
  else:
    kw_, vw = k[:, :, -W:], v[:, :, -W:]
    got = flash_decode(q1, kw_, vw, **kw)
    same = all(torch.equal(a, b) for a, b in zip(
        got, flash_decode(q1, kw_.contiguous(), vw.contiguous(), **kw)))
    err = _check(f"flash_decode{tag} window view S={W} of {S} cap={cap}",
                 dtype, got, ref.flash_decode_ref(q1, kw_, vw, **kw), *tol)
    print(f"  [flash_decode{tag}] the window view equals a contiguous copy "
          f"bit for bit: {same}")
    if not same:
      raise AssertionError("flash_decode on the window view differs from "
                           "the same rows copied")
    copy_ms = _device_ms(lambda: (kw_.contiguous(), vw.contiguous()))
    print(f"  [flash_decode{tag}] a .contiguous() copy of the window would "
          f"take {copy_ms:.4f} ms of device time a local layer "
          f"({2 * _nbytes(kw_, vw) / 1e6:.1f} MB moved)")
    rec("flash_decode", err, lambda: flash_decode(q1, kw_, vw, **kw),
        lambda: ref.flash_decode_ref(q1, kw_, vw, **kw),
        _nbytes(q1, kw_, vw, *got), 4 * B * H * W * D, "flash_decode.cu",
        "flash_decode.py:125", cold=True)
  if cfg.encoder is not None:
    T = cfg.encoder.source_len
    kc, vc = rnd(B, Hkv, T, D), rnd(B, Hkv, T, D)
    got = flash_decode(q1, kc, vc, sm_scale=sm)
    err = _check(f"flash_decode{tag} cross S={T} G={G}", dtype, got,
                 ref.flash_decode_ref(q1, kc, vc, sm_scale=sm), *tol)
    r = _record(f"flash_decode{tag[:-1]}-cross{T}]",
                "src/repro_torch/kernels/csrc/flash_decode.cu",
                "src/repro/kernels/flash_decode.py:125", dtype, err,
                lambda: flash_decode(q1, kc, vc, sm_scale=sm),
                lambda: ref.flash_decode_ref(q1, kc, vc, sm_scale=sm),
                _nbytes(q1, kc, vc, *got), 4 * B * H * T * D, cold=True,
                library_fn=lambda: sdpa(q1[:, :, None], kc, vc,
                                        enable_gqa=True))
    recs[r["name"]] = r
    del kc, vc

  # synopsis_score (the unfused op's first stage).
  got = synopsis_score(q1, k_syn, sm_scale=sm)
  err = _check(f"synopsis_score{tag} M={M} G={G}", dtype, got,
               ref.synopsis_score_ref(q1, k_syn, sm_scale=sm), *tol)
  rec("synopsis_score", err, lambda: synopsis_score(q1, k_syn, sm_scale=sm),
      lambda: ref.synopsis_score_ref(q1, k_syn, sm_scale=sm),
      _nbytes(q1, k_syn, got), 2 * B * H * M * D, "synopsis_score.cu",
      "synopsis_score.py:46", cold=True)
  return recs


def _sdpa_backend(fn):
  """The first of SDPA's backends, in PyTorch's order of preference, that
  takes the call ``fn`` when it is the only one allowed."""
  from torch.nn.attention import SDPBackend, sdpa_kernel
  for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                  SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
    try:
      with sdpa_kernel([backend]):
        fn()
      return backend.name
    except RuntimeError:
      continue
  return "none"


def check_mla_kernels(cfg, tag, dev, g):
  """deepseek-v2's kernels at full width against their plain versions, bf16
  rows: ``flash_prefill`` at MLA's prefill width (D = qk_nope + qk_rope =
  192, G = 1, v zero-padded from v_head_dim, scale 192^-0.5; SDPA as the
  library time); ``segment_build`` over every layer's latent (B sequences
  a layer of one head of kv_lora + rope = 576) and its absorb; and the
  latent core's four decode kernels, an f32 query of all 128 heads (the
  absorbed q_eff) over one latent head of 576, L2-cold too: stage 1 on one
  layer's tables (M = 64), stage 2 over 32 clusters with the ring and the
  self token, ``flash_decode`` over the exact loop's whole latent cache
  and over the self token (SDPA beside it as a yardstick, the query
  rounded to bf16, naming the backend it takes) and ``synopsis_score``.
  Then each of them on f32 rows at the same shapes, checked and not
  timed.  Returns the records, keyed ``<kernel><tag>``."""
  from repro_torch.kernels import ops, ref
  from repro_torch.kernels.block_gather_attention import (
      block_gather_attention as gather)
  from repro_torch.kernels.flash_decode import flash_decode
  from repro_torch.kernels.flash_prefill import flash_prefill
  from repro_torch.kernels.fused_synopsis import (
      fused_synopsis_score_attention as fused)
  from repro_torch.kernels.synopsis_build import segment_build
  from repro_torch.kernels.synopsis_score import synopsis_score
  m = cfg.mla
  dtype = torch.bfloat16
  B, S, H = BATCH, PROMPT, cfg.n_heads
  Dp, D = m.qk_nope_dim + m.qk_rope_dim, m.kv_lora_rank + m.qk_rope_dim
  C, I = cfg.synopsis.cluster_size, _loop_budget(cfg)
  M = S // C
  sm = Dp ** -0.5
  sdpa = torch.nn.functional.scaled_dot_product_attention
  recs = {}

  def rnd(*shape):
    return torch.randn(shape, generator=g, device=dev).to(dtype)

  def rec(kernel, err, kfn, pfn, nbytes, ops_n, src, line, **kw):
    r = _record(f"{kernel}{tag}", f"src/repro_torch/kernels/csrc/{src}",
                f"src/repro/kernels/{line}", dtype, err, kfn, pfn, nbytes,
                ops_n, **kw)
    recs[r["name"]] = r
    return r

  # flash_prefill at D = 192, G = 1: v's columns past v_head_dim are zero.
  q, k, v = rnd(B, S, H, Dp), rnd(B, S, H, Dp), rnd(B, S, H, Dp)
  v[..., m.v_head_dim:] = 0
  qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
  lib = lambda: sdpa(qt, kt, vt, is_causal=True, scale=sm)  # noqa: E731
  got = flash_prefill(q, k, v, sm_scale=sm)
  err = _check(f"flash_prefill{tag} D={Dp} G=1", dtype, got,
               ref.flash_prefill_ref(q, k, v, sm_scale=sm), *BF16_OUT_TOL)
  ops_n = 4 * B * H * Dp * S * (S + 1) // 2
  r = rec("flash_prefill", err, lambda: flash_prefill(q, k, v, sm_scale=sm),
          lambda: ref.flash_prefill_ref(q, k, v, sm_scale=sm),
          _nbytes(q, k, v, got), ops_n, "flash_prefill.cu",
          "flash_prefill.py:140", library_fn=lib)
  print(f"  [flash_prefill{tag} bf16] {ops_n / 1e12:.3f} TFLOP in "
        f"{r['device_ms']:.4f} ms of device time ({ops_n / r['device_ms'] / 1e9:.1f}"
        f" TFLOP/s); bound {r['bound_ms']:.4f} ms (operations), "
        f"{r['bound_ms'] / r['device_ms']:.1%} of it; SDPA backend "
        f"{_sdpa_backend(lib)}, kernel / SDPA device "
        f"{r['device_ms'] / r['library_device_ms']:.2f}x; a prompt's "
        f"{cfg.n_layers} launches: {cfg.n_layers * r['device_ms']:.3f} ms")
  del q, k, v, qt, kt, vt, got

  # segment_build: every layer's latent of one B = 2 prompt, and the
  # absorb of the 128-token ring.
  N = cfg.n_layers * B
  kb, vb = rnd(N, 1, S, D), rnd(N, 1, S, D)
  perm = torch.argsort(torch.rand((N, S), generator=g, device=dev),
                       dim=-1).to(torch.int32)
  got = segment_build(kb, vb, perm, cluster_size=C)
  err = _check(f"segment_build{tag} N={N} Hkv=1 D={D}", dtype, got,
               ref.synopsis_build_ref(kb, vb, perm, cluster_size=C),
               *BF16_OUT_TOL)
  ring = torch.arange(C, device=dev, dtype=torch.int32).expand(N, C)
  ka, va = kb[:, :, :C].contiguous(), vb[:, :, :C].contiguous()
  _check(f"segment_build{tag} absorb", dtype,
         segment_build(ka, va, ring, cluster_size=C),
         ref.synopsis_build_ref(ka, va, ring, cluster_size=C), *BF16_OUT_TOL)
  _bound_share(rec(
      "segment_build", err,
      lambda: segment_build(kb, vb, perm, cluster_size=C),
      lambda: ref.synopsis_build_ref(kb, vb, perm, cluster_size=C),
      _nbytes(kb, vb, perm, *got), 2 * N * S * D + 2 * N * M * D,
      "segment_build.cu", "synopsis_build.py:173"), dtype)
  del kb, vb, perm, got, ka, va

  # The latent core on one layer's arena: an f32 query whose logits spread
  # ~1 over the bf16 latent rows.
  q1 = torch.randn((B, H, D), generator=g, device=dev) * (3.0 * D ** -0.5)
  k, v = rnd(B, 1, S, D), rnd(B, 1, S, D)
  k_syn = k.float().reshape(B, 1, M, C, D).mean(3).to(dtype)
  v_syn = v.float().reshape(B, 1, M, C, D).mean(3).to(dtype)
  cbias = ops.count_bias(torch.full((B, M), float(C), device=dev))
  tol = PARTIALS_TOL[dtype]
  kw = dict(sm_scale=sm)
  got = fused(q1, k_syn, v_syn, cbias, **kw)
  want = ref.fused_synopsis_score_attention_ref(q1, k_syn, v_syn, cbias,
                                                **kw)
  err = _check(f"fused_synopsis{tag} M={M} G={H} D={D}", dtype,
               (got[0], *got[1]), (want[0], *want[1]), *_stage1_tol(dtype, M))
  rec("fused_synopsis_score_attention", err,
      lambda: fused(q1, k_syn, v_syn, cbias, **kw),
      lambda: ref.fused_synopsis_score_attention_ref(q1, k_syn, v_syn,
                                                     cbias, **kw),
      _nbytes(q1, k_syn, v_syn, cbias, got[0], *got[1]), 4 * B * H * M * D,
      "latent_decode.cu", "fused_synopsis.py:139", cold=True)

  sel = torch.topk(got[0], I, dim=-1).indices.to(torch.int32)
  safe = sel.long()[..., None].expand(-1, -1, -1, D)
  rk, rv = rnd(B, 1, cfg.synopsis.recent, D), rnd(B, 1, cfg.synopsis.recent,
                                                  D)
  ek, ev, eb = ops.build_extras(rk, rv, None, (rnd(B, 1, 1, D),
                                                rnd(B, 1, 1, D)))
  gkw = dict(cluster_size=C, sm_scale=sm,
             k_sel=torch.gather(k_syn, 2, safe),
             v_sel=torch.gather(v_syn, 2, safe),
             sel_bias=cbias[:, None, :1].expand(B, 1, I).contiguous(),
             extras_k=ek, extras_v=ev, extras_bias=eb)
  got = gather(q1, k, v, sel, **gkw)
  err = _check(f"block_gather{tag} S={S} I={I} E={ek.shape[2]} G={H} "
               f"D={D}", dtype, got,
               ref.fused_gather_attention_ref(q1, k, v, sel, **gkw), *tol)
  rows = I * C * B
  rec("block_gather_attention", err, lambda: gather(q1, k, v, sel, **gkw),
      lambda: ref.fused_gather_attention_ref(q1, k, v, sel, **gkw),
      _nbytes(q1, sel, gkw["k_sel"], gkw["v_sel"], gkw["sel_bias"], ek, ev,
              eb, *got) + 2 * rows * D * k.element_size(),
      4 * H * D * (rows + B * (I + ek.shape[2])), "latent_mma.cuh",
      "block_gather_attention.py:255", cold=True)

  # flash_decode: the exact loop's whole latent cache, and its self token.
  got = flash_decode(q1, k, v, **kw)
  err = _check(f"flash_decode{tag} S={S} G={H} D={D}", dtype, got,
               ref.flash_decode_ref(q1, k, v, **kw), *tol)
  q1b = q1.to(dtype)[:, :, None]
  lib = lambda: sdpa(q1b, k, v, enable_gqa=True, scale=sm)  # noqa: E731
  r = rec("flash_decode", err, lambda: flash_decode(q1, k, v, **kw),
          lambda: ref.flash_decode_ref(q1, k, v, **kw),
          _nbytes(q1, k, v, *got), 4 * B * H * S * D, "latent_mma.cuh",
          "flash_decode.py:125", cold=True, library_fn=lib)
  print(f"  [flash_decode{tag}] SDPA yardstick (the query rounded to bf16, "
        f"enable_gqa over the one latent head) takes the "
        f"{_sdpa_backend(lib)} backend; kernel / SDPA device "
        f"{r['device_ms'] / r['library_device_ms']:.2f}x")
  ks, vs = rk[:, :, :1].contiguous(), rv[:, :, :1].contiguous()
  _check(f"flash_decode{tag} self token S=1", dtype,
         flash_decode(q1, ks, vs, **kw), ref.flash_decode_ref(q1, ks, vs,
                                                              **kw), *tol)
  print(f"  [flash_decode{tag} self token] device "
        f"{_device_ms(lambda: flash_decode(q1, ks, vs, **kw), KERNEL_ROWS['flash_decode']):.4f} ms")

  got = synopsis_score(q1, k_syn, **kw)
  err = _check(f"synopsis_score{tag} M={M} G={H} D={D}", dtype, got,
               ref.synopsis_score_ref(q1, k_syn, **kw), *tol)
  rec("synopsis_score", err, lambda: synopsis_score(q1, k_syn, **kw),
      lambda: ref.synopsis_score_ref(q1, k_syn, **kw),
      _nbytes(q1, k_syn, got), 2 * B * H * M * D, "latent_decode.cu",
      "synopsis_score.py:46", cold=True)
  del k, v, rk, rv, ek, ev, q1b

  # The same kernels on f32 rows (the SMOKE parity loops' type), checked
  # only: the records are the serving path's bf16.
  f32 = torch.float32
  tol = PARTIALS_TOL[f32]
  q = torch.randn((B, S, H, Dp), generator=g, device=dev)
  k, v = torch.randn_like(q), torch.randn_like(q)
  v[..., m.v_head_dim:] = 0
  _check(f"flash_prefill{tag} D={Dp} G=1", f32,
         flash_prefill(q, k, v, sm_scale=sm),
         ref.flash_prefill_ref(q, k, v, sm_scale=sm), *tol)
  del q, k, v
  k, v = (torch.randn((B, 1, S, D), generator=g, device=dev)
          for _ in range(2))
  perm = torch.argsort(torch.rand((B, S), generator=g, device=dev),
                       dim=-1).to(torch.int32)
  _check(f"segment_build{tag} N={B} Hkv=1 D={D}", f32,
         segment_build(k, v, perm, cluster_size=C),
         ref.synopsis_build_ref(k, v, perm, cluster_size=C), *tol)
  k_syn, v_syn = (x.reshape(B, 1, M, C, D).mean(3) for x in (k, v))
  got = fused(q1, k_syn, v_syn, cbias, **kw)
  want = ref.fused_synopsis_score_attention_ref(q1, k_syn, v_syn, cbias,
                                                **kw)
  _check(f"fused_synopsis{tag} M={M} G={H} D={D}", f32, (got[0], *got[1]),
         (want[0], *want[1]), *_stage1_tol(f32, M))
  gkw.update(k_sel=torch.gather(k_syn, 2, safe),
             v_sel=torch.gather(v_syn, 2, safe),
             extras_k=gkw["extras_k"].float(),
             extras_v=gkw["extras_v"].float())
  _check(f"block_gather{tag} S={S} I={I} G={H} D={D}", f32,
         gather(q1, k, v, sel, **gkw),
         ref.fused_gather_attention_ref(q1, k, v, sel, **gkw), *tol)
  _check(f"flash_decode{tag} S={S} G={H} D={D}", f32,
         flash_decode(q1, k, v, **kw), ref.flash_decode_ref(q1, k, v, **kw),
         *tol)
  _check(f"synopsis_score{tag} M={M} G={H} D={D}", f32,
         synopsis_score(q1, k_syn, **kw),
         ref.synopsis_score_ref(q1, k_syn, **kw), *tol)
  return recs


def check_mla_quant_kernels(cfg, tag, dev, g):
  """deepseek-v2's quantized branches at full width against their plain
  versions: the build of every layer's latent under each quant spec
  (``segment_build``'s flushes at D = 576), and the latent core's stage 1
  (``has_scale``) and stage 2 (``has_kq``) on a one-byte arena of the
  JAX build oracle (identity permutation): an f32 query of all 128 heads
  over one latent head of 576 codes, stage 1 on one layer's tables (M =
  64), stage 2 over the 32 clusters stage 1 ranks first with the ring and
  the self token (E = 129, bf16) and f32 decrement rows, warm and
  L2-cold.  Their bound: the bytes, or the operations the function needs
  (4 H D a row), stage 1's at the f32 rate (its kernel runs every product
  as an f32 FMA), stage 2's at the bf16 tensor rate (the card can run its
  products on the tensor cores: the codes widen to bf16 exactly); no
  library call scales per cluster.  Returns the records, keyed
  ``<branch><tag>``."""
  from repro_torch.kernels import _build, ops, ref
  from repro_torch.kernels import quant as qt
  from repro_torch.kernels.block_gather_attention import (
      block_gather_attention as gather)
  from repro_torch.kernels.fused_synopsis import (
      fused_synopsis_score_attention as fused)
  recs = {}
  for spec in QSPECS:
    rec = check_segment_build_quant(dev, torch.bfloat16, g, spec, cfg=cfg,
                                    tag=tag)
    recs[rec["name"]] = rec
    torch.cuda.empty_cache()
  m, f32, bf16 = cfg.mla, torch.float32, torch.bfloat16
  B, H, S = BATCH, cfg.n_heads, PROMPT
  D = m.kv_lora_rank + m.qk_rope_dim
  C, I, R = cfg.synopsis.cluster_size, _loop_budget(cfg), cfg.synopsis.recent
  M = S // C
  sm = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5

  def rnd(*shape):
    return torch.randn(shape, generator=g, device=dev).to(bf16)

  q1 = torch.randn((B, H, D), generator=g, device=dev) * (3.0 * D ** -0.5)
  k, v = rnd(B, 1, S, D), rnd(B, 1, S, D)
  ident = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
  ek, ev, eb = ops.build_extras(rnd(B, 1, R, D), rnd(B, 1, R, D), None,
                                (rnd(B, 1, 1, D), rnd(B, 1, 1, D)))
  for kind in QKINDS:
    arena = ref.synopsis_build_quant_ref(
        k, v, ident, cluster_size=C, qc=qt.parse_qconfig(f"{kind}+kv"))
    src = f"src/repro_torch/kernels/csrc/latent_decode_{kind}.cu"
    cbias = ops.count_bias(arena["counts"])
    tables = (arena["k_syn"], arena["v_syn"], cbias)
    kw = dict(sm_scale=sm, k_scale=arena["k_syn_scale"],
              v_scale=arena["v_syn_scale"])
    got = fused(q1, *tables, **kw)
    want = ref.fused_synopsis_score_attention_ref(q1, *tables, **kw)
    name = _build.branch("fused_synopsis_score_attention",
                         _build.latent_branch(kind)) + tag
    err = _check(f"{name} M={M} G={H} D={D}", f32, (got[0], *got[1]),
                 (want[0], *want[1]), *_stage1_tol(f32, M))
    recs[name] = _bound_share(_record(
        name, src, "src/repro/kernels/fused_synopsis.py:139", f32, err,
        lambda: fused(q1, *tables, **kw),
        lambda: ref.fused_synopsis_score_attention_ref(q1, *tables, **kw),
        _nbytes(q1, *tables, kw["k_scale"], kw["v_scale"], got[0], *got[1]),
        4 * B * H * M * D, cold=True), f32)
    # Stage 2 over stage 1's top I, its inputs as refine_stage2 makes them.
    sel = torch.topk(got[0], I, dim=-1).indices.to(torch.int32)
    safe = sel.long()
    rows = safe[..., None].expand(-1, -1, -1, D)
    gkw = {f"{x}_sel": qt.gather_rows(arena[f"{x}_syn"], 2, rows).float()
           * torch.gather(arena[f"{x}_syn_scale"], 2, safe)[..., None]
           for x in "kv"}
    gkw.update(sel_bias=torch.gather(cbias[:, None].expand(B, 1, M), 2,
                                     safe),
               cluster_size=C, sm_scale=sm, extras_k=ek, extras_v=ev,
               extras_bias=eb, kv_k_scale=arena["k_scale"],
               kv_v_scale=arena["v_scale"])
    kv = (arena["k"], arena["v"])
    got = gather(q1, *kv, sel, **gkw)
    name = _build.branch("block_gather_attention",
                         _build.latent_branch(kind)) + tag
    err = _check(f"{name} S={S} I={I} E={ek.shape[2]} G={H} D={D}", f32,
                 got, ref.fused_gather_attention_ref(q1, *kv, sel, **gkw),
                 *PARTIALS_TOL[bf16])
    n_rows = B * I * C
    recs[name] = _bound_share(_record(
        name, "src/repro_torch/kernels/csrc/latent_mma.cuh",
        "src/repro/kernels/block_gather_attention.py:255", bf16,
        err, lambda: gather(q1, *kv, sel, **gkw),
        lambda: ref.fused_gather_attention_ref(q1, *kv, sel, **gkw),
        _nbytes(q1, sel, gkw["k_sel"], gkw["v_sel"], gkw["sel_bias"], ek, ev,
                eb, *got) + 2 * n_rows * D * kv[0].element_size()
        + 2 * B * I * 4, 4 * H * D * (n_rows + B * (I + ek.shape[2])),
        cold=True), bf16)
    del arena, kv, got
  return recs


def run_mla_quant(cfg, params, dev, g, tag, cache, launches):
  """MLA under each quant spec, on the exact loop's prompt cache: each
  spec's build, one budget-``LOOP_BUDGET`` step under the table-only specs
  (exact launch counts: the build, stage 1 on the "latent-<kind>" branch
  and stage 2 on "latent" on every layer), and the full-budget deviation
  on layer 0 against exact attention over the unquantized cache (the f32
  query of all heads; < 7%, the JAX package's bound).  Adds the
  table-only builds' launches to ``launches``."""
  from repro_torch.kernels import _build
  from repro_torch.kernels import quant as qt
  from repro_torch.launch import serve
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.serve_step import make_serve_step
  key = _decode_key(cfg)
  n = _n_attn(cfg)
  tok = torch.randint(0, cfg.vocab, (BATCH, 1),
                      generator=torch.Generator().manual_seed(7)).to(dev)
  for quant in QSPECS:
    qc = qt.parse_qconfig(quant)
    qcfg = serve.apply_quant(cfg, quant)
    _build.reset_launches()
    qsyn = skv.build(cache, qcfg)
    if not qc.sorted_kv:
      lg, _ = make_serve_step(qcfg, mode="synopsis", i_max=_loop_budget(
          cfg))(params, qsyn, tok)
      torch.cuda.synchronize()
      if not torch.isfinite(lg).all():
        raise AssertionError(f"{tag} quant={quant}: non-finite logits")
      build_key = _build.branch("segment_build", quant)
      _require_exact_launches(f"{tag} one step quant={quant}",
                              _build.launch_counts(), {
          build_key: 1, key("fused_synopsis_score_attention", qc.kind): n,
          key("block_gather_attention"): n})
      launches[f"{build_key}{tag}"] = 1
    check_full_budget_quant(cache, qsyn, quant, dev, g, G=cfg.n_heads,
                            q_dtype=torch.float32)
    del qsyn
    torch.cuda.empty_cache()


def check_arch_engine_parity(arch, tag, dev):
  """The arch's SMOKE engine in f32 (tf32 off) on the card (graphs,
  kernels) and on the CPU (eager, plain versions) from the same weights
  and requests, policy ``fixed`` at budget 1: the same ids, and every
  step's logits within 1e-4 of max|logits|."""
  from repro_torch.launch import parity
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        make_requests)
  cfg, params = parity.smoke_f32(arch)
  ids, logs = {}, {}
  for where in ("cpu", dev):
    eng = ServingEngine(cfg, EngineConfig(
        n_slots=2, prompt_len=64, max_new_tokens=4, policy="fixed",
        fixed_budget=1, overlap_admission=False),
        params=parity.tree_to(params, where), device=where)
    log = logs[str(where)] = []
    inner = eng._decode_step

    def step(active, *a, _eng=eng, _inner=inner, _log=log, **kw):
      _inner(active, *a, **kw)
      _log.append(_eng.step_out["logits"][list(active)].cpu())
    eng._decode_step = step
    reqs = make_requests([0.0, 1.0, 2.0, 3.0], 64, 4, cfg.vocab, seed=9)
    eng.run(reqs)
    ids[str(where)] = [r.tokens for r in reqs]
    del eng._decode_step, eng
  rel = max(float((a - b).abs().max() / b.abs().max())
            for a, b in zip(logs["cuda"], logs["cpu"]))
  if ids["cuda"] != ids["cpu"] or len(logs["cuda"]) != len(logs["cpu"]) \
      or not rel <= 1e-4:
    raise AssertionError(f"{tag} engine parity: ids {ids}, logits {rel}")
  print(f"{tag} [engine parity] smoke f32 fixed budget 1: "
        f"{sum(map(len, ids['cpu']))} ids equal on card and CPU; every "
        f"step's logits within {rel:.3e} of max (tol 1e-4)")


def _require_model_launches(path, counts, cfg, steps, mode, quant="none"):
  """Exact launch counts of a full-width loop, every branch: flash_prefill
  once an attention layer (a mamba layer launches no kernel); in synopsis
  mode segment_build twice (the build and the
  absorb) on the quant spec's branch, and each step stage 1 (on the spec's
  branch) and stage 2 on every global layer and flash_decode twice on
  every local layer (its window view and the self token); in exact mode
  flash_decode twice on every layer.  A cross block (whisper) adds one
  flash_prefill a layer (its causal branch) and, in both modes, one
  flash_decode a layer a step.  The decode kernels count on the branch of
  the stream they take (``_decode_key``).  Every other branch launches
  0."""
  from repro_torch.kernels import _build
  from repro_torch.kernels import quant as qt
  qc = qt.parse_qconfig(quant)
  n_loc, n_glob = _n_attn(cfg, local=True), _n_attn(cfg, local=False)
  n_cross = sum(s.cross_attn for s in cfg.block_pattern) * cfg.n_blocks
  key = _decode_key(cfg)
  want = {"flash_prefill": n_loc + n_glob + n_cross}
  if mode == "synopsis":
    want[_build.branch("segment_build", qc.spec)] = 2
    want[key("fused_synopsis_score_attention", qc.kind)] = n_glob * steps
    want[key("block_gather_attention",
             qc.kind if qc.sorted_kv else "none")] = n_glob * steps
    want["flash_decode"] = (2 * n_loc + n_cross) * steps
  else:
    want[key("flash_decode")] = (2 * (n_loc + n_glob) + n_cross) * steps
  _require_exact_launches(path, counts, want)


def _decode_key(cfg):
  """key(kernel, quant="none") -> the launch-count key of a decode
  kernel's branch on ``cfg``'s path: under MLA the latent core's branch
  ("latent", or "latent-int8" / "latent-fp8" on a quantized arena), else
  the quant spec's, and unquantized the stream ``_build.decode_mma`` picks
  for the config's dtype and group."""
  from repro_torch.kernels import _build
  if cfg.mla is not None:
    return lambda name, quant="none": _build.branch(
        name, _build.latent_branch(quant))
  G = cfg.n_heads // cfg.n_kv_heads
  return lambda name, quant="none": (
      _build.decode_branch(name, cfg.dtype, G) if quant == "none"
      else _build.branch(name, quant))


def _record_name(key, name, tag):
  """The record of kernel ``name``'s launches on branch ``key`` in an arch's
  phase: the tensor-core stream's under its key, any other under the
  kernel's name (the latent core's records carry the arch's tag only)."""
  from repro_torch.kernels import _build
  mma = key == _build.branch(name, _build.DECODE_MMA)
  return f"{key if mma else name}{tag}"


def _require_exact_launches(path, counts, want):
  """Each branch launched exactly as often as ``want`` says, and every
  branch it does not name not at all."""
  print(f"[{path}] launches {({k: n for k, n in counts.items() if n})}")
  want = {**dict.fromkeys(counts, 0), **want}
  if counts != want:
    raise AssertionError(f"{path}: launches {counts}, expected {want}")


def check_arch_smoke_parity(arch, tag, runs, dev):
  """The arch's SMOKE loop in f32, card against CPU, for each (mode,
  quant) of ``runs``: the same ids and every step's logits within the
  larger of 1e-4 and four times the CPU's f32 loop's distance from the
  same loop in float64, measured in the same call, of max|logits|
  (``repro_torch.launch.parity``, which the card tests run too)."""
  from repro_torch.launch import parity
  for mode, quant in runs:
    _, rel, bound = parity.loop_parity(arch, dev, mode, quant)
    print(f"{tag} [parity] smoke f32 {mode} quant={quant}: "
          f"{parity.TOKENS + 1} ids equal on card and CPU; every step's "
          f"logits within {rel:.3e} of max (bound {bound:.3e})")


def check_prefix_prefill(cfg, params, dev, tag):
  """The vision stub's path at full width: 256 patch embeddings from the
  seed (f32 normal, cast to the model's dtype) and 7936 text tokens, 8192
  positions in all, through the prefill (one flash_prefill a layer),
  then the build (segment_build once), then one synopsis step at budget
  M against one exact step on that cache: logits within 1e-3 of
  max|exact| (the full-budget bound)."""
  from repro_torch.kernels import _build
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.prefill import make_prefill_step
  gen = torch.Generator(dev).manual_seed(0)
  P = cfg.frontend_tokens
  patches = torch.randn((BATCH, P, cfg.frontend_dim), generator=gen,
                        device=dev).to(cfg.dtype)
  text = torch.randint(0, cfg.vocab, (BATCH, PROMPT - P), generator=gen,
                       device=dev)
  _build.reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  logits, cache = make_prefill_step(cfg)(params, text, patches)
  torch.cuda.synchronize()
  prefill_ms = (time.perf_counter() - t0) * 1e3
  t0 = time.perf_counter()
  syn = skv.build(cache, cfg)
  torch.cuda.synchronize()
  build_ms = (time.perf_counter() - t0) * 1e3
  want = {"flash_prefill": cfg.n_layers, "segment_build": 1}
  _require_exact_launches(f"{tag} prefix prefill", _build.launch_counts(),
                          want)
  S = cache["k"].shape[4]
  if (S != PROMPT or cache["pos"].tolist() != [PROMPT] * BATCH
      or tuple(logits.shape) != (BATCH, cfg.vocab)
      or not torch.isfinite(logits).all()):
    raise AssertionError(f"{tag} prefix prefill: S={S}, pos "
                         f"{cache['pos'].tolist()}, logits "
                         f"{tuple(logits.shape)}")
  rel, tv, same = _budget_m_against_exact(cfg, params, cache, syn, logits,
                                          tag)
  print(f"{tag} prefix prefill: {P} patches + {PROMPT - P} tokens = {S} "
        f"positions, B={BATCH}: prefill_ms={prefill_ms:.1f} build_ms="
        f"{build_ms:.1f}; synopsis step at i_max=M={syn['k_syn'].shape[4]} "
        f"against the exact step: max err {rel:.3e} of max|exact| (tol "
        f"1e-3), tv={tv:.6f}, argmax equal {same}")


def _budget_m_against_exact(cfg, params, cache, syn, logits, tag,
                            counts=None):
  """One synopsis step at budget M on ``syn`` against one exact step on
  ``cache``, from the prefill ``logits``' argmax: (max error as a share of
  max|exact|, TV distance, argmax equal); raises beyond 1e-3 (the
  full-budget bound).  With ``counts`` the synopsis step's launches must
  be exactly those."""
  from repro_torch.kernels import _build
  from repro_torch.serve.serve_step import make_serve_step
  M = syn["k_syn"].shape[4]
  tok = logits.argmax(-1, keepdim=True)
  lg_ex, _ = make_serve_step(cfg, mode="exact")(params, cache, tok)
  _build.reset_launches()
  lg_syn, _ = make_serve_step(cfg, mode="synopsis", i_max=M)(params, syn,
                                                              tok)
  torch.cuda.synchronize()
  if counts is not None:
    _require_exact_launches(f"{tag} budget-M step", _build.launch_counts(),
                            counts)
  rel = _max_err(lg_syn, lg_ex) / float(lg_ex.abs().max())
  tv = float(0.5 * (torch.softmax(lg_syn, -1) - torch.softmax(lg_ex, -1))
             .abs().sum(-1).mean())
  if not rel <= 1e-3:
    raise AssertionError(f"{tag}: full-budget step != exact step: {rel}")
  return rel, tv, bool(torch.equal(lg_syn.argmax(-1), lg_ex.argmax(-1)))


def check_encoder_prefill(cfg, params, dev, tag):
  """The audio stub's path at full width: ``source_len`` (1500) frame
  embeddings from the seed (f32 normal, cast to the model's dtype) and
  8192 tokens.  The encoder alone (plain torch, as in JAX: no kernel),
  timed; then the prefill (the encoder, then one flash_prefill a decoder
  layer: its cross blocks attend over the encoder's output in plain
  torch), the build (segment_build once), and one synopsis step at budget
  M against one exact step on that cache: logits within 1e-3 of
  max|exact| (the full-budget bound), the synopsis step's cross
  flash_decode over the T rows counted, one a layer.  Returns that
  count."""
  from repro_torch.kernels import _build
  from repro_torch.models import transformer as tf
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.prefill import make_prefill_step
  gen = torch.Generator(dev).manual_seed(0)
  T = cfg.encoder.source_len
  frames = torch.randn((BATCH, T, cfg.frontend_dim), generator=gen,
                       device=dev).to(cfg.dtype)
  text = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                       device=dev)
  _build.reset_launches()
  with torch.no_grad():
    tf.encode(params, cfg, frames)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = tf.encode(params, cfg, frames)
    torch.cuda.synchronize()
  encoder_ms = (time.perf_counter() - t0) * 1e3
  if (tuple(enc.shape) != (BATCH, T, cfg.d_model)
      or not torch.isfinite(enc).all()):
    raise AssertionError(f"{tag} encoder output {tuple(enc.shape)}")
  del enc
  t0 = time.perf_counter()
  logits, cache = make_prefill_step(cfg)(params, text, frames)
  torch.cuda.synchronize()
  prefill_ms = (time.perf_counter() - t0) * 1e3
  t0 = time.perf_counter()
  syn = skv.build(cache, cfg)
  torch.cuda.synchronize()
  build_ms = (time.perf_counter() - t0) * 1e3
  _require_exact_launches(f"{tag} encoder prefill", _build.launch_counts(),
                          {"flash_prefill": cfg.n_layers, "segment_build": 1})
  S, Tc = cache["k"].shape[4], cache["cross_k"].shape[4]
  if (S != PROMPT or Tc != T or cache["pos"].tolist() != [PROMPT] * BATCH
      or tuple(logits.shape) != (BATCH, cfg.vocab)
      or not torch.isfinite(logits).all()):
    raise AssertionError(f"{tag} encoder prefill: S={S}, T={Tc}, pos "
                         f"{cache['pos'].tolist()}, logits "
                         f"{tuple(logits.shape)}")
  n = cfg.n_layers
  rel, tv, same = _budget_m_against_exact(cfg, params, cache, syn, logits,
                                          tag, {
      "flash_decode": n, "fused_synopsis_score_attention": n,
      "block_gather_attention": n})
  print(f"{tag} encoder prefill: {T} frames of {cfg.frontend_dim} + "
        f"{PROMPT} tokens, B={BATCH}: encoder_ms={encoder_ms:.1f} "
        f"prefill_ms={prefill_ms:.1f} (the encoder included) build_ms="
        f"{build_ms:.1f}; cross rows T={Tc}; synopsis step at i_max=M="
        f"{syn['k_syn'].shape[4]} against the exact step: max err "
        f"{rel:.3e} of max|exact| (tol 1e-3), tv={tv:.6f}, argmax equal "
        f"{same}; its cross flash_decode over the {T} rows: {n} launches")
  return n


def _model_loop(cfg, params, dev, tag, mode="synopsis", quant="none"):
  """The budget-32 loop (or the exact loop) at full width, B = 2, prompt
  8192, 130 steps, under ``quant``: exact launch counts, peak memory.
  Returns (the run's output, its launch counts)."""
  from repro_torch.kernels import _build
  from repro_torch.launch import serve
  qcfg = serve.apply_quant(cfg, quant)
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  out = serve.run(qcfg, batch=BATCH, prompt_len=PROMPT, tokens=STEPS,
                  budgets=([_loop_budget(cfg)] * STEPS
                           if mode == "synopsis" else None),
                  mode=mode, device=dev, params=params, log=lambda _: None)
  torch.cuda.synchronize()
  counts = _build.launch_counts()
  peak = torch.cuda.max_memory_allocated() / 1e9
  _check_run(out, cfg, absorbs=1 if mode == "synopsis" else 0)
  label = (f"budget {_loop_budget(cfg)} on every step"
           if mode == "synopsis" else "exact")
  print(f"{tag} loop quant={quant} {label}: prefill_ms="
        f"{out['prefill_ms']:.1f} build_ms={out['build_ms']:.1f} decode_ms "
        f"{_step_stats(out['step_ms'])} absorbs={out['absorbs']} "
        f"peak_mem_gb={peak:.2f}")
  _require_model_launches(f"{tag} loop {mode} quant={quant}", counts, cfg,
                          STEPS, mode, quant)
  return out, counts


def _window(eng):
  """One Poisson window (``run_open_loop``, seed 0).  Returns its summary
  and, on a hybrid, each decode step's largest change of the active
  lanes' ``ssd_state`` across the step (taken outside the step's timed
  wall): a state the step did not write back shows as 0."""
  from repro_torch.serve.engine import run_open_loop
  if "ssd_state" not in eng.cache:
    return run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0), None
  moved = []
  inner = eng._decode_step

  def step(active, *a, **kw):
    before = eng.cache["ssd_state"][:, :, list(active)].clone()
    inner(active, *a, **kw)
    after = eng.cache["ssd_state"][:, :, list(active)]
    moved.append(float((after - before).abs().amax()))
  eng._decode_step = step
  try:
    s = run_open_loop(eng, ENGINE_RATE, ENGINE_WINDOW_S, seed=0)
  finally:
    # The wrapper closes over the engine: left in place, it would make the
    # engine a reference cycle, whose weights and graphs only the cyclic
    # collector frees (possibly inside a later engine's capture).
    del eng._decode_step
  return s, moved


def _report_ssm_state(label, moved):
  frozen = sum(m == 0.0 for m in moved)
  print(f"{label}: SSM state over the window: max|change| per step min "
        f"{min(moved):.3e} median {statistics.median(moved):.3e} max "
        f"{max(moved):.3e}; {frozen} of {len(moved)} steps left it as it "
        "was")
  if frozen:
    raise AssertionError(f"{label}: {frozen} steps did not advance the SSM "
                         "state")


def run_model(arch, dev, g):
  """One architecture at its published width and depth (depth cut where
  ``DEPTH`` says: jamba, arctic, command-r-plus), random bf16 weights from
  seed 0: SMOKE parity
  card against CPU, the kernel checks
  at its shapes, the budget-32 loop (130 steps, one absorb; budget
  ``LOOP_BUDGET``) with exact
  launch counts, the full-budget deviation on its first global layer, a
  profiled window (device busy share); under gemma2's table-only quant
  specs the quantized build and stage 1 at its shapes, the same loop,
  accuracy against exact, the full-budget deviation and each budget's
  deviation from the unquantized arena (< 7%); the exact
  loop and a profiled window, one step per budget against exact; the
  vision stub's prefix prefill (pixtral), or the audio stub's encoder
  prefill (whisper); the unfused op; one engine window under
  accuracytrader and basic (whisper: the engine's refusal), with a
  hybrid's SSM state watched over it (jamba).  Returns (records, {record
  name: launches on its path})."""
  from repro_torch.configs.registry import get_config
  from repro_torch.kernels import _build, ops
  from repro_torch.launch import serve
  from repro_torch.models import transformer as tf
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.serve_step import global_positions
  t_start = time.perf_counter()
  tag, smoke_runs, table_quants = MODELS[arch]
  cfg = get_config(arch)
  full_layers = cfg.n_layers
  if arch in DEPTH:
    cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
  local = any(s.local for s in cfg.block_pattern)
  pos = global_positions(cfg)[0]          # the first global (synopsis) layer
  G = cfg.n_heads // cfg.n_kv_heads
  kinds = [s.kind for s in cfg.block_pattern]
  print(f"{tag} {cfg.name} full width, "
        + (f"depth cut to {cfg.n_layers} of {full_layers} layers"
           + (f" ({cfg.n_blocks} of {full_layers // len(kinds)} "
              f"{len(kinds)}-layer superblocks)" if len(kinds) > 1 else "")
           + ": " if cfg.n_layers != full_layers
           else "depth too, nothing cut: ")
        + f"{cfg.n_layers} layers"
        + (f" ({_n_attn(cfg)} attention, {cfg.n_layers - _n_attn(cfg)} "
           f"mamba (SSD state {cfg.ssm.d_state}, "
           f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} heads of "
           f"{cfg.ssm.head_dim}), "
           f"{sum(s.use_moe for s in cfg.block_pattern) * cfg.n_blocks} MoE "
           f"({cfg.moe.num_experts} experts of {cfg.moe.d_ff_expert}, top "
           f"{cfg.moe.top_k}; {cfg.param_count(active=True) / 1e9:.3f}B "
           "params active a token))" if "mamba" in kinds else "")
        + (f", an MoE on every layer ({cfg.moe.num_experts} experts of "
           f"{cfg.moe.d_ff_expert}, top {cfg.moe.top_k}) with a dense MLP "
           f"of {cfg.d_ff} beside it ({cfg.param_count(active=True) / 1e9:.3f}"
           "B params active a token)"
           if cfg.moe is not None and cfg.moe.dense_parallel else "")
        + (f", MLA (q_lora {cfg.mla.q_lora_rank}; decode over one latent "
           f"head of kv_lora {cfg.mla.kv_lora_rank} + rope "
           f"{cfg.mla.qk_rope_dim} read by all {cfg.n_heads} heads, prefill "
           f"at D = {cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim}), an MoE on "
           f"every layer ({cfg.moe.num_experts} experts of "
           f"{cfg.moe.d_ff_expert}, top {cfg.moe.top_k}, "
           f"{cfg.moe.num_shared} shared; "
           f"{cfg.param_count(active=True) / 1e9:.3f}B params active a "
           "token)" if cfg.mla is not None else "")
        + (", parallel attention and FFN blocks (no ln2)"
           if cfg.parallel_block else "")
        + (f" (local window {cfg.sliding_window} / global)" if local else "")
        + f", d={cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads (G={G}),"
        f" hd={cfg.hd}, d_ff={cfg.d_ff}, vocab {cfg.vocab}"
        + (f", {cfg.frontend} {cfg.frontend_tokens}x{cfg.frontend_dim}"
           if cfg.frontend == "vision_stub" else "")
        + (f", encoder {cfg.encoder.n_layers} layers over "
           f"{cfg.encoder.source_len}x{cfg.frontend_dim} frames, cross "
           f"blocks, {cfg.mlp_type} MLPs, attention biases"
           if cfg.encoder else "")
        + f", {cfg.param_count() / 1e9:.3f}B params, {cfg.dtype}; "
        f"B={BATCH} prompt={PROMPT} steps={STEPS}")
  check_arch_smoke_parity(arch, tag, smoke_runs, dev)
  dkey = _decode_key(cfg)
  if cfg.mla is not None:
    check_arch_engine_parity(arch, tag, dev)
    records = check_mla_kernels(cfg, tag, dev, g)
    records.update(check_mla_quant_kernels(cfg, tag, dev, g))
  else:
    records = check_model_kernels(cfg, tag, dev, g)
  for quant in table_quants:          # the branches the quantized loops run
    for check in (check_segment_build_quant, check_fused_synopsis_quant):
      rec = check(dev, torch.bfloat16, g, quant, cfg=cfg, tag=tag)
      records[rec["name"]] = rec
      torch.cuda.empty_cache()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  params = tf.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
  torch.cuda.synchronize()
  print(f"{tag} random weights in {time.perf_counter() - t0:.1f}s")
  launches = {}

  out, counts = _model_loop(cfg, params, dev, tag)
  for name in ("flash_prefill", "segment_build",
               "fused_synopsis_score_attention", "block_gather_attention"):
    key = dkey(name) if name in _build.LATENT_KERNELS else name
    launches[_record_name(key, name, tag)] = counts[key]
  if local:
    launches[f"flash_decode{tag}"] = counts["flash_decode"]
  check_full_budget(out["cache"], dev, g, pos=pos, cap=cfg.attn_softcap,
                    G=cfg.n_heads if cfg.mla else G,
                    q_dtype=torch.float32 if cfg.mla else None)
  profile_decode(cfg, params, out["cache"], dev, _loop_budget(cfg))
  del out
  # MLA's loops on the quantized latent core (the sorted cache's specs:
  # stage 1 and stage 2 both on their one-byte branches).
  for quant in (("int8+kv", "fp8+kv") if cfg.mla is not None else ()):
    out, counts = _model_loop(cfg, params, dev, tag, quant=quant)
    kind = quant.split("+")[0]
    for key in (_build.branch("segment_build", quant),
                dkey("fused_synopsis_score_attention", kind),
                dkey("block_gather_attention", kind)):
      launches[f"{key}{tag}"] = counts[key]
    profile_decode(serve.apply_quant(cfg, quant), params, out["cache"], dev,
                   _loop_budget(cfg))
    del out
  for quant in table_quants:
    out, counts = _model_loop(cfg, params, dev, tag, quant=quant)
    for name in ("segment_build", "fused_synopsis_score_attention"):
      key = _build.branch(name, quant)
      launches[f"{key}{tag}"] = counts[key]
    profile_decode(serve.apply_quant(cfg, quant), params, out["cache"], dev,
                   _loop_budget(cfg))
    del out

  exact, counts = _model_loop(cfg, params, dev, tag, mode="exact")
  if not local:
    key = dkey("flash_decode")
    launches[_record_name(key, "flash_decode", tag)] = counts[key]
  cache = exact["cache"]
  del exact
  profile_decode(cfg, params, cache, dev, 0, mode="exact")
  syn = skv.build(cache, cfg)
  check_accuracy_vs_exact(cfg, params, cache, syn, dev)
  if cfg.mla is not None:
    run_mla_quant(cfg, params, dev, g, tag, cache, launches)
  for quant in table_quants:
    qcfg = serve.apply_quant(cfg, quant)
    qsyn = skv.build(cache, qcfg)
    check_accuracy_vs_exact(qcfg, params, cache, qsyn, dev,
                            budgets=(0, 8, 32, 64))
    check_full_budget_quant(cache, qsyn, quant, dev, g, pos=pos, G=G,
                            cap=cfg.attn_softcap)
    check_budget_quant(syn, qsyn, quant, dev, g, pos=pos, G=G,
                       cap=cfg.attn_softcap)
    del qsyn
  del cache
  if cfg.frontend == "vision_stub":
    check_prefix_prefill(cfg, params, dev, tag)
  if cfg.encoder is not None:
    T = cfg.encoder.source_len
    launches[f"flash_decode{tag[:-1]}-cross{T}]"] = check_encoder_prefill(
        cfg, params, dev, tag)

  # The unfused op on a global layer: synopsis_score's path.
  k, v = syn["k"][0, pos], syn["v"][0, pos]
  Bq, Hkv, _, D = k.shape
  q = torch.randn((Bq, cfg.n_heads, D), generator=g, device=dev)
  q = (q * 2.0 * D ** 0.5 / k.float().norm(dim=-1).mean()).to(
      torch.float32 if cfg.mla else k.dtype)
  args = (q, k, v, syn["k_syn"][0, pos], syn["v_syn"][0, pos],
          syn["counts"][0, pos])
  kw = dict(i_max=_loop_budget(cfg), sm_scale=D ** -0.5,
            cap=cfg.attn_softcap)
  _build.reset_launches()
  a = ops.synopsis_attention(*args, **kw)
  torch.cuda.synchronize()
  counts = _build.launch_counts()
  _require_launches(f"{tag} unfused op", counts,
                    (dkey("synopsis_score"), dkey("flash_decode"),
                     dkey("block_gather_attention")))
  launches[f"synopsis_score{tag}"] = counts[dkey("synopsis_score")]
  b = ops.synopsis_cache_attention(*args[:6], i_max=kw["i_max"],
                                   cluster_size=cfg.synopsis.cluster_size,
                                   sm_scale=kw["sm_scale"], cap=kw["cap"])
  rel = _max_err(a, b) / float(a.abs().max())
  print(f"{tag} unfused op against the fused one, layer {pos}, cap "
        f"{cfg.attn_softcap}: max err {rel:.2e} of max|out| (tol 1e-3)")
  if not rel <= 1e-3:
    raise AssertionError(f"{tag} fused != unfused: {rel}")
  del syn, args, k, v

  # The engine refuses an encoder-decoder, as the JAX engine fails on one
  # (ROADMAP C): no window runs.
  policies = ("accuracytrader", "basic")
  if cfg.encoder is not None:
    policies = ()
    try:
      _engine(cfg, params, dev)
    except NotImplementedError as e:
      print(f"{tag} engine refused: {e}")
    else:
      raise AssertionError(f"{tag}: the engine took an encoder-decoder")
  for policy in policies:
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    eng = _engine(cfg, params, dev, policy=policy)
    n_graphs = len(eng.programs.graphs)
    built_s = time.perf_counter() - t0
    s, moved = _window(eng)
    counts = _build.launch_counts()
    print(f"{tag} engine {policy}: {n_graphs} graphs captured in "
          f"{built_s:.1f}s; peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    _engine_metrics(f"{tag} {policy}", s, eng)
    if moved is not None:
      _report_ssm_state(f"{tag} engine {policy}", moved)
    # A local layer's flash_decode is captured in every bucket's graph
    # beside the global layers' two synopsis kernels (under MLA their
    # latent branches, and no other branch of theirs).
    _require_launches(f"{tag} engine {policy}", counts, tuple(
        dkey(n) if n in _build.LATENT_KERNELS else n for n in ENGINE_KERNELS)
        + (("flash_decode",) if local else ()), absent=(
            "synopsis_score", dkey("synopsis_score")) + (
            () if local else ("flash_decode", dkey("flash_decode"))) + tuple(
            n for n in ("fused_synopsis_score_attention",
                        "block_gather_attention") if dkey(n) != n))
    del eng
  del params
  torch.cuda.empty_cache()
  print(f"{tag} phase in {time.perf_counter() - t_start:.1f}s")
  return records, launches


def run_mamba2(dev):
  """mamba2-370m at full width and depth (48 SSD layers, nothing cut),
  random bf16 weights from seed 0.  No attention: the loop runs in exact
  mode and launches none of the six kernels (the SSD scan, the conv and
  the state update are plain torch, as the reference is plain JAX).  The
  SMOKE loop card against CPU (``launch.parity``), the exact loop at B =
  2, prompt 8192, 130 steps (prefill ms, step p50 / p99, peak memory, no
  launch), a profiled window (device busy ms and ops a step), and the
  engine's refusal (``ValueError``, as the JAX engine refuses it)."""
  from repro_torch.configs.registry import get_config
  from repro_torch.kernels import _build
  from repro_torch.launch import parity, serve
  from repro_torch.models import transformer as tf
  t_start = time.perf_counter()
  tag = "[mamba2]"
  cfg = get_config("mamba2-370m")
  s = cfg.ssm
  print(f"{tag} {cfg.name} full width and depth, nothing cut: "
        f"{cfg.n_layers} mamba layers, d={cfg.d_model}, d_inner "
        f"{s.expand * cfg.d_model} in {s.expand * cfg.d_model // s.head_dim}"
        f" heads of {s.head_dim}, state {s.d_state}, conv {s.d_conv}, chunk "
        f"{s.chunk}, no FFN, vocab {cfg.vocab} (tied), "
        f"{cfg.param_count() / 1e9:.3f}B params, {cfg.dtype}; B={BATCH} "
        f"prompt={PROMPT} steps={STEPS}")
  launched, rel, bound = parity.loop_parity("mamba2-370m", dev, "exact")
  if any(launched.values()):
    raise AssertionError(f"{tag} SMOKE loop launched {launched}")
  print(f"{tag} [parity] smoke f32 exact: {parity.TOKENS + 1} ids equal on "
        f"card and CPU; every step's logits within {rel:.3e} of max (bound "
        f"{bound:.3e}); no kernel launched")
  t0 = time.perf_counter()
  params = tf.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
  torch.cuda.synchronize()
  print(f"{tag} random weights in {time.perf_counter() - t0:.1f}s")
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  out = serve.run(cfg, batch=BATCH, prompt_len=PROMPT, tokens=STEPS,
                  device=dev, params=params, log=lambda _: None)
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated() / 1e9
  _check_run(out, cfg, absorbs=0)
  if out["budgets"] != [0] * STEPS or out["build_ms"] != 0.0:
    raise AssertionError(f"{tag}: the loop did not run in exact mode")
  print(f"{tag} loop exact (no attention): prefill_ms="
        f"{out['prefill_ms']:.1f} decode_ms {_step_stats(out['step_ms'])} "
        f"peak_mem_gb={peak:.2f}")
  _require_exact_launches(f"{tag} loop exact", _build.launch_counts(), {})
  profile_decode(cfg, params, out["cache"], dev, 0, mode="exact")
  del out
  try:
    _engine(cfg, params, dev)
  except ValueError as e:
    print(f"{tag} engine refused: {e}")
  else:
    raise AssertionError(f"{tag}: the engine took an attention-free model")
  del params
  torch.cuda.empty_cache()
  print(f"{tag} phase in {time.perf_counter() - t_start:.1f}s")


# ---------------------------------------------------------------------------
# Phase 21: the generic-data Algorithm 1 and its two services (``[apps]``),
# with the Morton build of a KV cache; phase 22: training (``[train]``)
# ---------------------------------------------------------------------------

MORTON_PROMPT = 1024
# The per-component scale of the JAX generators' defaults, then one larger
# component on the device (CF: ~18 M ratings, 2.1 GB of dense ratings and
# mask; search: 1.07 GB of term frequencies).
APPS_CF = dict(n_users=4000, n_items=1000, density=0.0675)
APPS_SE = dict(n_docs=20000, vocab=2000)
APPS_CF_LARGE = dict(n_users=65536, n_items=4096, density=0.0675)
APPS_SE_LARGE = dict(n_docs=131072, vocab=2048)
APPS_CLUSTERS = {"cf": 64, "se": 128, "large": 1024}
APPS_FRACTIONS = (0.0, 0.05, 0.1, 0.2, 0.4, 1.0)
APPS_PARITY_QUERIES = 20
APPS_QUERIES = 200
APPS_PARTIAL = 0.25          # the unranked partial execution's share
TRAIN_STEPS, TRAIN_CKPT, TRAIN_BATCH, TRAIN_SEQ = 14, 8, 8, 2048


def _sync(dev):
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)


def _pct(xs, p):
  return float(np.percentile(np.asarray(xs), p))


def check_segment_build_morton(dev, g):
  """The llama3-8b SMOKE cache (bf16, prompt 1024) built with
  ``method="morton"`` through ``segment_build`` on the card, held against
  the plain version on the same Morton permutation; the card's Morton
  permutation beside the CPU's.  Returns (record, the build's launches)."""
  from repro_torch.configs.registry import get_config
  from repro_torch.kernels import _build, ref
  from repro_torch.kernels.synopsis_build import segment_build
  from repro_torch.models import transformer as tf
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.prefill import make_prefill_step
  cfg = get_config("llama3-8b", smoke=True)
  params = tf.init_model(cfg, torch.Generator(dev).manual_seed(3), dev)
  prompt = torch.randint(0, cfg.vocab, (BATCH, MORTON_PROMPT), generator=g,
                         device=dev)
  _, cache = make_prefill_step(cfg)(params, prompt)
  _build.reset_launches()
  syn = skv.build(cache, cfg, method="morton")
  _sync(dev)
  launches = _build.launch_counts()["segment_build"]
  nb, na, B, Hkv, S, D = cache["k"].shape
  N, C = nb * na * B, cfg.synopsis.cluster_size
  M = S // C
  k = cache["k"].reshape(N, Hkv, S, D)
  v = cache["v"].reshape(N, Hkv, S, D)
  perm = skv.cluster_perms(k, M, method="morton")
  same = float((perm.cpu() == skv.cluster_perms(
      k.cpu(), M, method="morton")).float().mean())
  print(f"[morton] {N} sequences x {S} tokens: the card's Morton "
        f"permutation equals the CPU's at {same:.2%} of positions (f32 PCA "
        "in another order; codes tie often)")
  want = ref.synopsis_build_ref(k, v, perm, cluster_size=C)
  got = tuple(syn[n].reshape(want[i].shape) for i, n in enumerate(
      ("k", "v", "k_syn", "v_syn", "counts")))
  if not torch.equal(got[4], want[4]):
    raise AssertionError("morton build counts differ from the plain version")
  err = _check("segment_build[morton]", cfg.dtype, got, want, *BF16_OUT_TOL)
  perm32 = perm.to(torch.int32)
  rec = _record(
      "segment_build[morton]", "src/repro_torch/kernels/csrc/segment_build.cu",
      "src/repro/kernels/synopsis_build.py:173", cfg.dtype, err,
      lambda: segment_build(k, v, perm32, cluster_size=C),
      lambda: ref.synopsis_build_ref(k, v, perm32, cluster_size=C),
      _nbytes(k, v, perm32, *want), 2 * N * Hkv * S * D + 2 * N * Hkv * M * D)
  return _bound_share(rec, cfg.dtype), launches


def _card_copy(obj, dev, **fields):
  """The app object on ``dev`` with the CPU object's synopsis (no build)."""
  out = type(obj).__new__(type(obj))
  out.__dict__.update({k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                       for k, v in obj.__dict__.items() if k != "syn"})
  out.syn = obj.syn.to(dev)
  out.__dict__.update(fields)
  return out


def _cf_queries(ratings, mask, n, rng):
  """The recommender example's active users: (q, q_mask, test items,
  truth) with the held-out ratings masked, on the data's device."""
  mask_np = mask.cpu().numpy()
  out = []
  while len(out) < n:
    uid = int(rng.integers(0, ratings.shape[0]))
    rated = np.where(mask_np[uid] > 0)[0]
    if len(rated) < 10:
      continue
    test = rng.choice(rated, size=min(10, len(rated) // 2), replace=False)
    items = torch.from_numpy(test).to(ratings.device)
    qm = mask[uid].clone()
    qm[items] = 0.0
    out.append((ratings[uid] * qm, qm, items, ratings[uid][items]))
  return out


def _check_build_invariants(label, syn, data, mask, n):
  """tests/test_core.py's invariants of a build, on the device: every row
  in exactly one cluster (row_cluster its inverse), counts balanced, each
  centroid the masked mean of its members within 1e-5."""
  mi = syn.member_idx.long()
  valid = mi >= 0
  rows = mi[valid]
  cids = torch.arange(mi.shape[0], device=mi.device)[:, None].expand_as(
      mi)[valid]
  hits = torch.bincount(rows, minlength=n)
  ok = (int(syn.counts.sum()) == n and bool((hits == 1).all())
        and bool((syn.row_cluster.long()[rows] == cids).all())
        and int(syn.counts.max() - syn.counts.min()) <= 1
        and torch.equal(valid.sum(1).to(syn.counts.dtype), syn.counts))
  safe = mi.clamp_min(0)
  w = (mask[safe] * valid[..., None]).double()
  mean = ((data[safe].double() * w).sum(1) / w.sum(1).clamp_min(1))
  err = float((syn.centroids.double() - mean).abs().max())
  print(f"[apps] {label} build on the card: {mi.shape[0]} clusters, "
        f"counts {int(syn.counts.min())}-{int(syn.counts.max())}, every row "
        f"in one cluster: {ok}; centroid max_abs_err {err:.2e} (tol 1e-5)")
  if not ok or not err <= 1e-5:
    raise AssertionError(f"{label}: the card's build breaks the synopsis "
                         "invariants")


def _apps_parity(dev):
  """The per-component scale, card against the card machine's CPU."""
  from repro_torch.serving import apps
  rng = np.random.default_rng(0)
  ratings, mask = apps.movielens_like(**APPS_CF)
  cpu = apps.CFRecommender(ratings, mask, num_clusters=APPS_CLUSTERS["cf"])
  card = _card_copy(cpu, dev)
  budgets = sorted({int(f * APPS_CLUSTERS["cf"]) for f in APPS_FRACTIONS})
  worst = 0.0
  for q, qm, items, _ in _cf_queries(ratings, mask, APPS_PARITY_QUERIES,
                                     rng):
    qg, qmg, ig = q.to(dev), qm.to(dev), items.to(dev)
    pairs = [(cpu.predict_exact(q, qm, items),
              card.predict_exact(qg, qmg, ig))]
    pairs += [(cpu.predict(q, qm, items, b), card.predict(qg, qmg, ig, b))
              for b in budgets]
    for want, got in pairs:
      rel = float((got.cpu() - want).abs().max() / want.abs().max())
      worst = max(worst, rel)
  print(f"[apps] cf {APPS_CF['n_users']}x{APPS_CF['n_items']} "
        f"({int(mask.sum())} ratings, {APPS_CLUSTERS['cf']} clusters): "
        f"predict on the card against the CPU, same synopsis, "
        f"{APPS_PARITY_QUERIES} users x budgets {budgets} + exact: max "
        f"{worst:.2e} of max|ref| (tol 1e-5)")
  if not worst <= 1e-5:
    raise AssertionError("cf predict on the card disagrees with the CPU")
  built = apps.CFRecommender(ratings.to(dev), mask.to(dev),
                             num_clusters=APPS_CLUSTERS["cf"])
  _check_build_invariants("cf", built.syn, built.ratings, built.mask,
                          ratings.shape[0])
  same = float((built.syn.row_cluster.cpu() == cpu.syn.row_cluster).float()
               .mean())
  print(f"[apps] cf: {same:.2%} of users in the same cluster as in the CPU "
        "build")

  docs = apps.webpages_like(**APPS_SE)
  cpu = apps.SearchEngine(docs, num_clusters=APPS_CLUSTERS["se"])
  card = _card_copy(cpu, dev)
  budgets = sorted({int(f * APPS_CLUSTERS["se"]) for f in APPS_FRACTIONS})
  differ = 0
  for i in range(APPS_PARITY_QUERIES):
    qv = docs[int(rng.integers(0, docs.shape[0]))] + 0.05 * torch.randn(
        docs.shape[1], generator=torch.Generator().manual_seed(i))
    qg = qv.to(dev)
    differ += not torch.equal(cpu.search_exact(qv), card.search_exact(qg).cpu())
    for b in budgets:
      differ += not torch.equal(cpu.search(qv, b), card.search(qg, b).cpu())
  print(f"[apps] search {APPS_SE['n_docs']} pages x {APPS_SE['vocab']} terms "
        f"({APPS_CLUSTERS['se']} clusters): top-10 ids on the card against "
        f"the CPU, same synopsis, {APPS_PARITY_QUERIES} queries x budgets "
        f"{budgets} + exact: {differ} lists differ")
  if differ:
    raise AssertionError("search on the card disagrees with the CPU")
  built = apps.SearchEngine(docs.to(dev), num_clusters=APPS_CLUSTERS["se"])
  _check_build_invariants("search", built.syn, built.docs,
                          torch.ones_like(built.docs), docs.shape[0])
  same = float((built.syn.row_cluster.cpu() == cpu.syn.row_cluster).float()
               .mean())
  print(f"[apps] search: {same:.2%} of pages in the same cluster as in the "
        "CPU build")


def _movielens_on(dev, n_users, n_items, density, seed=0, n_taste=8):
  """``apps.movielens_like``'s recipe drawn on the device with torch's RNG
  (numpy on the host takes ~20 s at the large component's size): low-rank
  tastes, scaled to mean 3 and std 1.2, rounded to half stars in [0.5,
  5], a Bernoulli(density) mask.  Returns (ratings, mask) f32."""
  g = torch.Generator(dev).manual_seed(seed)
  u = torch.randn((n_users, n_taste), generator=g, device=dev,
                  dtype=torch.float64)
  v = torch.randn((n_items, n_taste), generator=g, device=dev,
                  dtype=torch.float64)
  full = u @ v.T
  full = 3.0 + 1.2 * (full / full.std())
  full = torch.clamp(torch.round(full * 2) / 2, 0.5, 5.0).float()
  mask = (torch.rand((n_users, n_items), generator=g, device=dev)
          < density).float()
  return full * mask, mask


def _webpages_on(dev, n_docs, vocab, n_topics=32, seed=0):
  """``apps.webpages_like``'s recipe drawn on the device: Dirichlet(0.05)
  topics over the terms, Dirichlet(0.2) topic mixtures, plus
  Gamma(0.3, 0.02) noise.  Returns the term frequencies f32."""
  dist = torch.distributions
  full = lambda shape, x: torch.full(shape, x, device=dev)
  # torch's Dirichlet and Gamma draw from the global generator only
  with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
    torch.manual_seed(seed)
    topics = dist.Dirichlet(full((vocab,), 0.05)).sample((n_topics,))
    doc_topic = dist.Dirichlet(full((n_topics,), 0.2)).sample((n_docs,))
    noise = dist.Gamma(full((), 0.3), full((), 50.0)).sample((n_docs, vocab))
  return doc_topic @ topics + noise


def _timed(fn, dev):
  """(result, host ms of one synchronised call)."""
  _sync(dev)
  t0 = time.perf_counter()
  out = fn()
  _sync(dev)
  return out, (time.perf_counter() - t0) * 1e3


def _latency_row(label, ms, acc):
  print(f"[apps] {label:>16s} p50 {_pct(ms, 50):8.3f} ms  p99 "
        f"{_pct(ms, 99):8.3f} ms  {acc}")


def _apps_large_cf(dev, cf=APPS_CF_LARGE, m=APPS_CLUSTERS["large"],
                   queries=APPS_QUERIES):
  from repro_torch.serving import apps
  t0 = time.perf_counter()
  ratings, mask = _movielens_on(dev, **cf)
  _sync(dev)
  gen_s = time.perf_counter() - t0
  if dev.type == "cuda":
    torch.cuda.reset_peak_memory_stats()
  rec, build_ms = _timed(lambda: apps.CFRecommender(ratings, mask,
                                                    num_clusters=m), dev)
  print(f"[apps] cf large {cf['n_users']}x{cf['n_items']}: "
        f"{int(mask.sum())} ratings (made in {gen_s:.1f}s), {m} clusters, "
        f"build {build_ms:.1f} ms")
  rng = np.random.default_rng(1)
  qs = _cf_queries(ratings, mask, queries, rng)
  budgets = [int(f * m) for f in APPS_FRACTIONS]
  variants = ["exact", "partial_25"] + budgets
  ms = {k: [] for k in variants}
  sq = {k: [] for k in variants}
  for q, qm, items, truth in qs:
    for b in budgets:
      pr, t = _timed(lambda: rec.predict(q, qm, items, b), dev)
      ms[b].append(t)
      sq[b].append(((pr - truth) ** 2).cpu().numpy())
    pr, t = _timed(lambda: rec.predict_exact(q, qm, items), dev)
    ms["exact"].append(t)
    sq["exact"].append(((pr - truth) ** 2).cpu().numpy())
    keep = torch.from_numpy(rng.random(cf["n_users"]) < APPS_PARTIAL).to(
        dev)[:, None].float()
    view = _card_copy(rec, dev, ratings=rec.ratings * keep,
                      mask=rec.mask * keep)
    pr, t = _timed(lambda: apps.CFRecommender.predict_exact(view, q, qm,
                                                            items), dev)
    ms["partial_25"].append(t)
    sq["partial_25"].append(((pr - truth) ** 2).cpu().numpy())
    del view
  rmse = {k: float(np.sqrt(np.mean(np.concatenate(v)))) for k, v in sq.items()}
  for k in variants:
    name = f"budget={k}" if isinstance(k, int) else k
    loss = 100.0 * (rmse[k] - rmse["exact"]) / rmse["exact"]
    _latency_row(name, ms[k], f"RMSE {rmse[k]:.4f} loss {loss:+.2f}%")
  peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
          else float("nan"))
  print(f"[apps] cf large: {len(qs)} users one at a time, synchronised; "
        f"peak device memory {peak:.2f} GB")
  return rmse, ms


def _apps_large_search(dev, se=APPS_SE_LARGE, m=APPS_CLUSTERS["large"],
                       queries=APPS_QUERIES):
  from repro_torch.serving import apps
  t0 = time.perf_counter()
  docs = _webpages_on(dev, **se)
  _sync(dev)
  gen_s = time.perf_counter() - t0
  if dev.type == "cuda":
    torch.cuda.reset_peak_memory_stats()
  eng, build_ms = _timed(lambda: apps.SearchEngine(docs, num_clusters=m), dev)
  print(f"[apps] search large {se['n_docs']} pages x {se['vocab']} terms "
        f"(made in {gen_s:.1f}s), {m} clusters, build {build_ms:.1f} ms")
  g = torch.Generator(dev).manual_seed(5)
  rng = np.random.default_rng(2)
  budgets = [int(f * m) for f in APPS_FRACTIONS]
  ms = {k: [] for k in ["exact"] + budgets}
  acc = {b: [] for b in budgets}
  for _ in range(queries):
    qv = docs[int(rng.integers(0, se["n_docs"]))] + 0.05 * torch.randn(
        se["vocab"], generator=g, device=dev)
    exact, t = _timed(lambda: eng.search_exact(qv), dev)
    ms["exact"].append(t)
    exact = set(exact.tolist())
    for b in budgets:
      got, t = _timed(lambda: eng.search(qv, b), dev)
      ms[b].append(t)
      acc[b].append(len(set(got.tolist()) & exact) / len(exact))
  _latency_row("exact", ms["exact"], "top-10 overlap 100.0%")
  for b in budgets:
    _latency_row(f"budget={b}", ms[b],
                 f"top-10 overlap {100 * np.mean(acc[b]):.1f}%")
  peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
          else float("nan"))
  print(f"[apps] search large: {queries} queries one at a time, "
        f"synchronised; peak device memory {peak:.2f} GB")
  return acc, ms


def run_apps(dev):
  """Phase 21 (``[apps]``): the recommender and the search engine at the
  JAX generators' per-component scale, card against CPU on the same
  synopsis and the card's own build's invariants; then one larger
  component of each on the card: latency per query and accuracy per
  budget, the build's wall time, peak memory.  Plain PyTorch (the
  reference runs no kernel here); f32 products without TF32."""
  t0 = time.perf_counter()
  if torch.backends.cuda.matmul.allow_tf32:
    raise AssertionError("TF32 is on: the apps' f32 products must stay f32")
  _apps_parity(dev)
  _apps_large_cf(dev)
  _free()
  _apps_large_search(dev)
  _free()
  print(f"[apps] phase in {time.perf_counter() - t0:.1f}s")


def _train_grads_card_vs_cpu(dev):
  """One f32 step of smollm's SMOKE config on the card against the card
  machine's CPU: the loss and every gradient within 4 times the CPU f32
  step's distance from its float64 step (1e-4 of max|ref| at least), as
  ``launch.parity`` holds the loops."""
  from repro_torch.configs.registry import get_config
  from repro_torch.models.common import leaves
  from repro_torch.train.data import DataConfig, TokenStream
  from repro_torch.train.optimizer import OptConfig, tree_map
  from repro_torch.train.train_step import init_train_state, loss_and_grads
  cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                            dtype=torch.float32)
  state = init_train_state(cfg, OptConfig(), device="cpu",
                           generator=torch.Generator().manual_seed(0))
  tokens, labels = TokenStream(DataConfig(cfg.vocab, 256, 4)).batch_at(0)
  batch = {"tokens": torch.from_numpy(tokens),
           "labels": torch.from_numpy(labels)}
  out = {}
  for name, where, c in (("cpu", "cpu", cfg), ("card", dev, cfg),
                         ("f64", "cpu", dataclasses.replace(
                             cfg, dtype=torch.float64))):
    p = tree_map(lambda t: t.to(where, c.dtype), state["params"])
    b = {k: v.to(where) for k, v in batch.items()}
    loss, _, g = loss_and_grads(c, p, b)
    out[name] = (float(loss), {k: x.double().cpu() for k, x in leaves(g)})

  def dist(a, b):
    return max(float((a[1][k] - b[1][k]).abs().max()
                     / b[1][k].abs().max()) for k in b[1])
  floor = dist(out["cpu"], out["f64"])
  bound = max(4 * floor, 1e-4)
  err = dist(out["card"], out["cpu"])
  loss_err = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
  print(f"[train] smoke f32 step, card against CPU: loss {out['card'][0]:.6f}"
        f" / {out['cpu'][0]:.6f} (rel {loss_err:.2e}); gradients max "
        f"{err:.2e} of max|ref| per leaf, bound {bound:.2e} (4x the CPU "
        f"f32's {floor:.2e} from float64, 1e-4 at least)")
  if not (err <= bound and loss_err <= 1e-5):
    raise AssertionError("the card's training step disagrees with the CPU")


def run_train(dev, cfg=None, steps=TRAIN_STEPS, ckpt=TRAIN_CKPT,
              batch=TRAIN_BATCH, seq=TRAIN_SEQ):
  """Phase 22 (``[train]``): smollm-135m at full width, TRAIN_STEPS steps
  at batch 8 x 2048 with a checkpoint at step TRAIN_CKPT
  (``launch.train.run``); every parameter's gradient finite and non-zero
  on the first batch; a second uninterrupted run to measure the
  run-to-run spread; a restart from the checkpoint to the last step, its
  losses held to the first run's
  within twice that spread (1e-5 of the loss at least); no kernel launched
  (the training forward takes the differentiable attention); and one f32
  SMOKE step card against CPU."""
  import tempfile
  from repro_torch.configs.registry import get_config
  from repro_torch.kernels import _build
  from repro_torch.launch import train
  from repro_torch.models.common import leaves
  from repro_torch.train.data import DataConfig, TokenStream
  from repro_torch.train.optimizer import OptConfig
  from repro_torch.train.train_step import init_train_state, loss_and_grads
  t0 = time.perf_counter()
  _train_grads_card_vs_cpu(dev)
  cfg = cfg or get_config("smollm-135m")
  opt_cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
  _build.reset_launches()
  state = init_train_state(cfg, opt_cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
  tokens, labels = TokenStream(DataConfig(cfg.vocab, seq, batch)).batch_at(0)
  _, _, grads = loss_and_grads(cfg, state["params"], {
      "tokens": torch.from_numpy(tokens).to(dev),
      "labels": torch.from_numpy(labels).to(dev)})
  bad = [p for p, g in leaves(grads)
         if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
  n = sum(x.numel() for _, x in leaves(state["params"]))
  print(f"[train] {cfg.name}: {n / 1e6:.1f}M params in "
        f"{len(list(leaves(grads)))} leaves; every gradient finite and "
        f"non-zero: {not bad} {bad}")
  if bad:
    raise AssertionError(f"parameters without a gradient: {bad}")
  del state, grads
  _free()
  kw = dict(steps=steps, batch=batch, seq=seq, opt_cfg=opt_cfg, device=dev,
            log_every=5, log=lambda s: print(f"[train] {s}"))
  scratch = pathlib.Path(__file__).resolve().parent / "build"
  scratch.mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=str(scratch)) as tmp:
    if dev.type == "cuda":
      torch.cuda.reset_peak_memory_stats()
    a = train.run(cfg, ckpt_dir=tmp, ckpt_every=ckpt, **kw)
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else float("nan"))
    del a["state"]
    _free()
    b = train.run(cfg, **kw)
    del b["state"]
    _free()
    c = train.run(cfg, ckpt_dir=tmp, ckpt_every=ckpt, **kw)
    del c["state"]
  launched = {k: v for k, v in _build.launch_counts().items() if v}
  la, lb, lc = a["losses"], b["losses"], c["losses"]
  p50 = statistics.median(a["step_ms"][1:])
  print(f"[train] losses every 5 steps: "
        + " ".join(f"{i}:{la[i]:.4f}" for i in range(0, steps, 5))
        + f" {steps - 1}:{la[-1]:.4f}")
  print(f"[train] step p50 {p50:.2f} ms (CUDA events, steps 2-{steps}), "
        f"first step {a['step_ms'][0]:.1f} ms, "
        f"{batch * seq / p50 * 1e3:.0f} tokens/s, peak device memory "
        f"{peak:.2f} GB; batch {batch} x {seq}")
  spread = max(abs(x - y) for x, y in zip(la, lb))
  bound = max(2 * spread, 1e-5 * max(map(abs, la)))
  dev_c = max(abs(x - y) for x, y in zip(lc, la[ckpt:]))
  print(f"[train] restart at step {c['start']} -> {steps}: losses against "
        f"the uninterrupted run max |diff| {dev_c:.3e}; a second "
        f"uninterrupted run differs by {spread:.3e} (bound {bound:.3e})")
  fell = np.mean(la[-5:]) < np.mean(la[:5])
  if c["start"] != ckpt or len(lc) != steps - ckpt or not dev_c <= bound:
    raise AssertionError("the restart does not resume the run")
  if not fell:
    raise AssertionError(f"the loss did not fall: {la}")
  if launched:
    raise AssertionError(f"the training path launched kernels: {launched}")
  print(f"[train] phase in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 23: the sharded path over torch.distributed, every rank on the card
# ---------------------------------------------------------------------------

# One world of MESH_WORLD ranks shares the one card (gloo: NCCL refuses two
# ranks on one device), each rank a process of its own launching the
# kernels on its shard; the kernels are built here, before any rank
# starts, and the ranks load the library.  llama3-8b at full width with
# MESH_DEPTH of its 32 layers on every rank: every rank holds the whole
# model (~4 GB with its f32 unembedding; tensor-parallel weights are
# ROADMAP A.7d).  Sizes are this phase's own, cut to keep it under ~150 s
# and the eight ranks inside the card's 80 GB (at B = 2 x 8192 tokens the
# ranks' prefills left cuSOLVER no memory for its handle): B = 2 prompts
# of MESH_PROMPT tokens (M = 32 clusters of 128) for the sharded synopsis
# (4 decode steps at budget MESH_BUDGET: half of M, so the global top-k
# picks a part of each shard's clusters and the ranking is tested), the
# engine windows on prompts of MESH_PROMPT tokens, 8 new tokens, for
# MESH_WINDOW_S s: a functional check of the tiers on a mesh (a handful of
# requests), not a latency measurement.
MESH_DEPTH = 2
MESH_PROMPT = 4096
MESH_B, MESH_STEPS, MESH_BUDGET = 2, 4, 16
MESH_N, MESH_R = 4, 2
MESH_WORLD = MESH_N * MESH_R
MESH_NEW, MESH_WINDOW_S = 8, 2.0
# [mesh train]: smollm-135m at full width, MESH_TRAIN_DEPTH of its 30
# layers (the gradients' host-staged all-reduce follows the parameter
# count: 8 layers hold 42% of it), 2 steps: the second reaches AdamW's
# second moment step and a non-zero error-feedback buffer.
MESH_TRAIN_STEPS, MESH_TRAIN_DEPTH = 2, 8
MESH_TIMEOUT_S = 420.0
# The sharded attention against the one-rank kernels on the same global
# cache, in f32 out of bf16 tables: only the order of the partials' f32
# merges differs (PARTIALS_TOL's f32 bound).
MESH_TOL = PARTIALS_TOL[torch.float32]
MESH_KERNELS = ("fused_synopsis_score_attention", "block_gather_attention")


def _plain_errs(seen, dtype):
  """Each captured kernel call against its plain version on the same
  inputs, at the card's tolerances; returns name -> max abs error (raises
  past the tolerance)."""
  from repro_torch.kernels import ops, ref
  plain = {"fused_synopsis_score_attention":
               ref.fused_synopsis_score_attention_ref,
           "block_gather_attention": ref.fused_gather_attention_ref,
           "flash_decode": ref.flash_decode_ref}
  errs = {}
  for name, (args, kw) in seen.items():
    got = getattr(ops, name)(*args, **kw)
    want = plain[name](*args, **kw)
    if name == "fused_synopsis_score_attention":
      got, want = (got[0], *got[1]), (want[0], *want[1])
      atol, *rtol = _stage1_tol(dtype, args[1].shape[2])
    else:
      atol, *rtol = PARTIALS_TOL[dtype]
    rtol = rtol[0] if rtol else 0.0
    ok = all(bool(((g.float() - w.float()).abs()
                   <= atol + rtol * w.float().abs()).all())
             for g, w in zip(got, want))
    errs[name] = _max_err(got, want)
    if not ok:
      raise AssertionError(f"{name}[mesh] disagrees with its plain version "
                           f"(max abs err {errs[name]})")
  return errs


def _layer(cache, i=0):
  """Layer ``i`` of a (nb, na, ...) cache (or a rank's shard of one)."""
  return {k: (v if k in ("layout", "recent_len", "pos") else v[0, i])
          for k, v in cache.items()}


def _mesh_synopsis(cfg, params, dev, out):
  """The sharded synopsis attention through the serve step on a (model 4)
  and a (data 2, model 4) mesh of the world's ranks: each rank prefills and
  builds the global prompt cache, cuts its shard (``shard_cache``), holds
  layer 0's sharded attention against the one-rank kernels on the global
  layer, its kernels against their plain versions on its shard (the second
  mesh), then runs MESH_STEPS decode steps at budget MESH_BUDGET with the
  counts reset just before (stage 1 and stage 2 once a global layer each
  step) and the collectives' bytes and host-staged wall counted."""
  import torch.distributed as dist
  from repro_torch.dist import sharding as shd
  from repro_torch.kernels import _build, ops
  from repro_torch.serve import serve_step as ss
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.prefill import make_prefill_step
  g = torch.Generator(dev).manual_seed(1)
  prompt = torch.randint(0, cfg.vocab, (MESH_B, MESH_PROMPT), generator=g,
                         device=dev)
  logits, cache = make_prefill_step(cfg)(params, prompt)
  tok0 = logits.argmax(-1, keepdim=True)
  del logits
  torch.cuda.empty_cache()        # the prefill's transients, before QR
  syn = skv.build(cache, cfg)
  del cache
  torch.cuda.empty_cache()
  G, D = cfg.n_heads // cfg.n_kv_heads, cfg.hd
  q = torch.randn((MESH_B, cfg.n_heads, D), generator=g,
                  device=dev).to(cfg.dtype)
  kd, vd = (torch.randn((MESH_B, cfg.n_kv_heads, 1, D), generator=g,
                        device=dev).to(cfg.dtype) for _ in range(2))
  kw = dict(i_max=MESH_BUDGET, cluster_size=cfg.synopsis.cluster_size,
            sm_scale=D ** -0.5)
  M = syn["counts"].shape[-1]
  if not MESH_BUDGET < M:
    raise AssertionError(f"[mesh] budget {MESH_BUDGET} selects all {M} "
                         f"clusters: the ranking would go untested")
  out["M"] = M
  one_rank = ss.synopsis_decode_attention(q, _layer(syn),
                                          self_kv=(kd, vd), **kw)
  step = ss.make_serve_step(cfg, i_max=MESH_BUDGET)
  for shape, axes in (((MESH_N,), ("model",)),
                      ((2, MESH_N), ("data", "model"))):
    mesh = shd.Mesh(shape, axes)
    label = "x".join(f"{a}{n}" for a, n in zip(axes, shape))
    if mesh.member:
      loc = ss.shard_cache(syn, mesh, shd.SERVE_RULES)
      lay = loc["layout"]
      rows = slice(None)
      if lay.dp_n > 1:
        n = MESH_B // lay.dp_n
        rows = slice(mesh.index(lay.dp_axes) * n,
                     (mesh.index(lay.dp_axes) + 1) * n)
      last = shape == (2, MESH_N)
      with shd.use_mesh(mesh, shd.SERVE_RULES):
        with (_first_inputs(ops, MESH_KERNELS) if last
              else contextlib.nullcontext()) as seen:
          got = ss.sharded_synopsis_attention(
              q[rows], _layer(loc), self_kv=(kd[rows], vd[rows]), **kw)
        want = one_rank[rows]
        ok = bool(((got - want).abs() <= MESH_TOL[0]
                   + MESH_TOL[1] * want.abs()).all())
        err = float((got - want).abs().max())
        if not ok:
          raise AssertionError(f"[mesh] {label}: sharded attention on rank "
                               f"{mesh.rank} off the one-rank kernels by "
                               f"{err}")
        res = {"attn_err": err, "layout": dataclasses.asdict(lay),
               "shard": tuple(loc["k"].shape)}
        if last:
          res["kernel_errs"] = _plain_errs(seen, cfg.dtype)
          if mesh.rank == 0:
            out["seen_syn"] = seen
        tok = tok0[rows]
        _sync(dev)
        _build.reset_launches()
        mesh.reset_stats()
        step_ms = []
        for _ in range(MESH_STEPS):
          t0 = time.perf_counter()
          lg, st = step(params, loc, tok)
          _sync(dev)
          step_ms.append((time.perf_counter() - t0) * 1e3)
          skv.append_recent(loc, st["k_delta"], st["v_delta"])
          loc["pos"] = st["pos"]
          tok = lg.argmax(-1, keepdim=True)
        counts = _build.launch_counts()
        per = MESH_STEPS * cfg.n_layers
        res.update(step_ms=step_ms, launches={k: counts[k]
                                              for k in MESH_KERNELS},
                   finite=bool(torch.isfinite(lg).all()),
                   gather_bytes_layer=mesh.stats["bytes"] / per,
                   gather_ms_layer=mesh.stats["ms"] / per,
                   collectives_layer=mesh.stats["calls"] / per)
        if any(counts[k] != per for k in MESH_KERNELS) or not res["finite"]:
          raise AssertionError(f"[mesh] {label} rank {mesh.rank}: launches "
                               f"{res['launches']} (want {per} each), "
                               f"finite logits {res['finite']}")
        out.setdefault("synopsis", {})[label] = res
        if last and mesh.rank == 0:
          out["syn_launches"] = {k: counts[k] for k in MESH_KERNELS}
      del loc
    dist.barrier()


# Weights cut by the rule tables (``shard_params``) on the serving path:
# the cut program's logits against the one-rank step on the same global
# weights and cache.  llama3-8b runs in f32 (its bf16 weights cast, which
# is exact; TF32 off): random weights at its full width attend near
# one-hot, so bf16 rounding alone moves its logits by tens of percent of
# max|ref| (the one-rank bf16 step against its f32 twin: up to 0.8) and
# no bf16 bound could tell a fault from rounding.  In f32 the cut and the
# one-rank program differ only in the order of their sums: TP_F32_TOL of
# max|ref|.  deepseek-v2 runs in bf16, as it serves: its bound is the
# one-rank bf16 step's own distance from the same step in f32 on the same
# weights and inputs (a witness of how far bf16 rounding carries this
# model), times TP_WITNESS, and 2^-7 of max|ref| at least; the phase fails
# if that bound exceeds TP_WITNESS_CAP of max|ref|, where it could no
# longer tell a fault (a missing all-reduce, a wrong block: O(1)) from
# rounding.  All relative to max|one-rank logits|.
TP_F32_TOL = 1e-3
TP_WITNESS, TP_FLOOR, TP_WITNESS_CAP = 2.0, 2.0 ** -7, 0.05
TP_STEPS_EXACT = 1
# deepseek-v2-236b: 1 of its 60 layers (MLA, 160 experts, 2 shared) a rank
# (~11 GB whole with its f32 unembedding: the ranks build it one at a
# time), on prompts of TP_DS_PROMPT tokens, TP_DS_STEPS synopsis step
# (each step gathers the layer's ~2 GB of FSDP-cut weights through host
# memory on every rank: ~9 s a step on the shared card).  Without FSDP the
# eight ranks' shards and rank 0's build ran out of the card's memory.
TP_DS_DEPTH, TP_DS_PROMPT, TP_DS_STEPS = 1, 2048, 1
# llama3-8b's FSDP-cut decode steps move a layer's f32 weights through
# host memory each step (~2.5 s a layer, run GI): one synopsis step there
# (MESH_STEPS on the model-4 mesh), to make room for [tp train].
TP_FSDP_STEPS = 1
# [tp train]: smollm-135m at full width and depth (30 layers, d 576, 9 / 3
# heads of 64, ff 1536, vocab 49152, tied) in f32 under TRAIN_RULES on
# (data 2, model 3), the first 6 ranks of the world: 3 query heads, 1 KV
# head, ff 512, vocab 16384 and embed 288 a rank.  TP_TRAIN_STEPS steps at
# a global batch of TP_TRAIN_BATCH x TP_TRAIN_SEQ; the loss and each
# leaf's assembled step-1 gradient against the one-rank step on the same
# batch (its data shares as microbatches).
#
# The gate runs step 1 in float64 on the first TP_TRAIN_GATE_DEPTH of the
# 30 layers at full width (the same seed's init, cut the same way), within
# TP_TRAIN_F64_TOL of max|ref| of the one-rank float64 step.  At this
# random init (loss ~88) the gradient is chaotic in depth: a perturbation
# grows ~3.6x a layer, so no precision tells a fault from rounding at 30
# layers.  On a CPU (full width, S 1024) the cut step lies
# from the one-rank step, of max|ref|: in f32 6.9e-5 at 2 layers, 2.0 at
# 6 (the one-rank f32 step itself 6.9e-3 and 1.37 from float64); in
# float64 8.2e-8 at 6 layers (the f32 rounding of the returned gradients)
# and 2.5e-5 at 12; on the card at 30 layers float64 moved
# blocks/pos0/attn/wk by 2.66 and f32 blocks/pos0/ln2 by 1.22, where the
# one-rank f32 step itself lay 3.91 from float64.  The f32 steps at every
# layer are timed.
TP_TRAIN_MESH = ((2, 3), ("data", "model"))
TP_TRAIN_STEPS, TP_TRAIN_BATCH, TP_TRAIN_SEQ = 3, 4, 1024
TP_TRAIN_GATE_DEPTH, TP_TRAIN_F64_TOL = 6, 1e-6
TP_KERNELS = ("flash_prefill", "fused_synopsis_score_attention",
              "block_gather_attention", "flash_decode")


def _rows_of(cache, rows):
  """Batch rows ``rows`` of a global decode cache, copied (the one-rank
  reference's own cache)."""
  from repro_torch.serve import serve_step as ss
  return {k: v.narrow(ss._SHARD_AXES[k][0], rows.start,
                      rows.stop - rows.start).clone()
          for k, v in cache.items()}


def _shard_bytes(cfg, specs, mesh):
  """(the bytes of a rank's shard, every leaf of ``shard_shape`` under its
  spec, the f32 unembedding as (embed, vocab); the same with each leaf
  rounded as the caching allocator rounds an allocation)."""
  from repro_torch.analysis.tracker import allocator_bytes
  from repro_torch.dist import sharding as shd
  from repro_torch.models import common as cm
  shapes = dict(cm.leaves(cm.param_shapes(cfg)))
  shapes["unembed"] = (cfg.d_model, cfg.vocab)
  es = torch.empty((), dtype=cfg.dtype).element_size()
  raw = rounded = 0
  for path, spec in cm.leaves(specs):
    n = math.prod(shd.shard_shape(shapes[path], spec, mesh))
    raw += n * (4 if path == "unembed" else es)
    rounded += allocator_bytes(n * (4 if path == "unembed" else es))
  return raw, rounded


def _held_bytes():
  """(requested, allocated) bytes of the caching allocator now."""
  st = torch.cuda.memory_stats()
  return st["requested_bytes.all.current"], st["allocated_bytes.all.current"]


def _tp_close(label, got, want, want32=None):
  """(the cut logits' distance from the one-rank step's, the one-rank
  step's from its f32 witness or None, the bound), each over max|want|:
  TP_F32_TOL for an f32 program (no witness), else TP_WITNESS times the
  witness's distance, TP_FLOOR at least and TP_WITNESS_CAP at most."""
  scale = float(want.float().abs().max())
  dev = float((got.float() - want.float()).abs().max()) / scale
  if want32 is None:
    wit, bound = None, TP_F32_TOL
  else:
    wit = float((want.float() - want32.float()).abs().max()) / scale
    bound = max(TP_WITNESS * wit, TP_FLOOR)
    if not bound <= TP_WITNESS_CAP:
      raise AssertionError(f"[tp] {label}: the bf16 witness {wit:.3e} of "
                           f"max|ref| gives a bound {bound:.3e} > "
                           f"{TP_WITNESS_CAP}: too loose to tell a fault")
  if not dev <= bound:
    raise AssertionError(f"[tp] {label}: the cut program's logits off the "
                         f"one-rank step's by {dev:.3e} of max|ref| > "
                         f"{bound:.3e} (the f32 witness {wit})")
  return dev, wit, bound


def _f32(tree, in_place=False):
  """A tree's floating leaves in f32 (the witness's weights or cache, or
  llama3's): a new tree, or with ``in_place`` the same dicts, each leaf
  replaced as it is cast (its old copy freed before the next leaf's
  cast); anything but a tensor (a shard's ``Cut``) as it is."""
  out = tree if in_place else {}
  for k, v in list(tree.items()):
    out[k] = _f32(v, in_place) if isinstance(v, dict) else (
        v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
  return out


def _tp_case(cfg, local, whole, mesh, rules, prompt, dev, label, capture,
             syn_steps, own_whole=False):
  """The cut program on one mesh: prefill on the rank's shard (every rank
  the global prompt's logits and KV), the synopsis build, ``syn_steps``
  decode steps at budget MESH_BUDGET on the rank's shard of the synopsis
  cache and TP_STEPS_EXACT exact ones on its shard of the prompt's cache,
  with the launch counts and the mesh's collectives counted over the cut
  program's calls only; each against the one-rank step of ``whole`` (on
  the rank's rows: an MoE routes a data-parallel shard's tokens
  together) and its f32 witness (``_tp_close``), where ``whole`` is
  given.  Every call of the three reads the same cache and token: the
  cut step's (the same on every rank of a data group), so that each
  comparison is one step's, not a drift of diverging sequences.  The
  witness runs last, replaying the steps' tokens and new KV, on an f32
  copy of ``whole`` (with ``own_whole``, ``whole`` itself converted leaf
  by leaf, so that a large model's two copies never coexist).  With
  ``capture`` the cut path's first call of each of TP_KERNELS is kept
  for the records."""
  from repro_torch.dist import sharding as shd
  from repro_torch.kernels import _build, ops
  from repro_torch.serve import serve_step as ss
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.prefill import make_prefill_step
  prefill = make_prefill_step(cfg)
  steps = {"synopsis": ss.make_serve_step(cfg, i_max=MESH_BUDGET),
           "exact": ss.make_serve_step(cfg, mode="exact")}
  launches = {}
  res = {"rel": {}, "ms": {}}
  seen = {}

  def cut(fn):
    _sync(dev)
    _build.reset_launches()
    with shd.use_mesh(mesh, rules), (
        _first_inputs(ops, [n for n in TP_KERNELS if n not in seen])
        if capture else contextlib.nullcontext()) as got:
      t0 = time.perf_counter()
      out = fn()
      _sync(dev)
      ms = (time.perf_counter() - t0) * 1e3
    for k, n in _build.launch_counts().items():
      launches[k] = launches.get(k, 0) + n
    if capture:
      seen.update({k: v for k, v in got.items() if k not in seen})
    return out, ms

  def append(c, st):
    skv.append_recent(c, st["k_delta"].to(c["recent_k"].dtype),
                      st["v_delta"].to(c["recent_v"].dtype))
    c["pos"] = st["pos"]

  mesh.reset_stats()
  (logits, cache), res["ms"]["prefill"] = cut(lambda: prefill(local, prompt))
  res["prefill_stats"] = dict(mesh.stats)
  # (label, cut logits, one-rank logits) of every call, for the witness.
  pairs = []
  if whole is not None:
    pairs.append(("prefill", logits, prefill(whole, prompt)[0]))
  tok0 = logits.argmax(-1, keepdim=True)
  del logits
  exact_cache = {k: cache[k] for k in ("k", "v", "pos")}
  syn, res["ms"]["build"] = cut(lambda: skv.build(cache, cfg))
  del cache
  torch.cuda.empty_cache()
  mesh.reset_stats()
  step_ms = []
  replay = {}                     # mode -> (rows, [(tok, new KV)])
  for mode, n_steps, glob in (("synopsis", syn_steps, syn),
                              ("exact", TP_STEPS_EXACT, exact_cache)):
    loc = ss.shard_cache(glob, mesh, rules)
    lay = loc["layout"]
    rows = slice(0, MESH_B)
    if lay.dp_n > 1:
      n = MESH_B // lay.dp_n
      rows = slice(mesh.index(lay.dp_axes) * n,
                   (mesh.index(lay.dp_axes) + 1) * n)
    one = _rows_of(glob, rows) if whole is not None else None
    tok = tok0[rows]
    replay[mode] = (rows, [])
    for i in range(n_steps):
      (lg, st), ms = cut(lambda: steps[mode](local, loc, tok))
      step_ms.append(ms)
      if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"[tp] {label} {mode}: logits not finite")
      if one is not None:
        pairs.append((f"{mode}{i}", lg, steps[mode](whole, one, tok)[0]))
      replay[mode][1].append((tok, st))
      tok = lg.argmax(-1, keepdim=True)
      if mode == "synopsis":
        append(loc, st)
        if one is not None:
          append(one, st)
    res["shard_k"] = tuple(loc["k"].shape)
    res["layout"] = dataclasses.asdict(lay)
    del loc, one
  per = (syn_steps + TP_STEPS_EXACT) * cfg.n_layers
  res.update(step_ms=step_ms, launches=launches, seen=seen,
             calls_layer=mesh.stats["calls"] / per,
             bytes_layer=mesh.stats["bytes"] / per,
             gloo_ms_layer=mesh.stats["ms"] / per)
  if whole is None:
    return res
  if cfg.dtype == torch.float32:
    for key, lg, lg1 in pairs:
      res["rel"][key] = _tp_close(f"{label} {key}", lg, lg1)
    return res
  # The f32 witness (activations in cfg.dtype, so an f32 config) on the
  # same prompt, caches and tokens.
  cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
  whole32 = _f32(whole, in_place=own_whole)
  del whole
  torch.cuda.empty_cache()
  wit = {"prefill": make_prefill_step(cfg32)(whole32, prompt)[0]}
  for mode, glob in (("synopsis", syn), ("exact", exact_cache)):
    rows, calls = replay[mode]
    one32 = _f32(_rows_of(glob, rows))
    step32 = ss.make_serve_step(cfg32, mode=mode, i_max=MESH_BUDGET)
    for i, (tok, st) in enumerate(calls):
      wit[f"{mode}{i}"] = step32(whole32, one32, tok)[0]
      if mode == "synopsis":
        append(one32, st)
    del one32
  for key, lg, lg1 in pairs:
    res["rel"][key] = _tp_close(f"{label} {key}", lg, lg1, wit[key])
  return res


def _tp_records(seen, cfg, tag):
  """Each kernel of the cut path on the inputs it gave the kernel (one
  rank's first call), against its plain version, timed beside its bound:
  ``flash_prefill`` at the rank's query heads, stage 1 and stage 2 on the
  rank's shard of the cache for all (gathered) heads, ``flash_decode``
  over the rank's rows.  The model's layer-0 activations are far from
  unit scale (logits of several hundred under the random init), so
  ``flash_prefill`` is held as the engine phase holds it
  (``_engine_check``: against the f64 answer as given, and to its plain
  version on the inputs scaled to unit RMS by powers of two), and both it
  and ``flash_decode`` are recorded on the scaled inputs.  The latent
  core's source under MLA.  Records keyed ``<kernel><tag>``."""
  from repro_torch.kernels import ops, ref
  dtype = cfg.dtype
  sdpa = torch.nn.functional.scaled_dot_product_attention
  latent = cfg.mla is not None
  src = ({"fused_synopsis_score_attention": "latent_decode.cu",
          "block_gather_attention": "latent_mma.cuh"} if latent else None)
  q, k_syn = seen["fused_synopsis_score_attention"][0][:2]
  recs = _cluster_records(seen, dtype, G=q.shape[1] // k_syn.shape[1],
                          C=cfg.synopsis.cluster_size, sdpa=sdpa, tag=tag,
                          names=CLUSTER_KERNELS[:2], source=src)
  args, kw = seen["flash_prefill"]
  _engine_check(tag, "flash_prefill", args, kw)
  args, kw, _ = _unit_scaled("flash_prefill", args, kw)
  q, k, v = args[:3]
  out = ops.flash_prefill(*args, **kw)
  B, S, H, D = q.shape
  err = _check(f"flash_prefill{tag} D={D} H={H} Hkv={k.shape[2]} scaled",
               dtype, out, ref.flash_prefill_ref(*args, **kw),
               *(BF16_OUT_TOL if dtype == torch.bfloat16 else (1e-4,)))
  qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
  lib = (None if kw.get("cap") is not None or kw.get("window") is not None
         else lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
  r = _record(f"flash_prefill{tag}",
              "src/repro_torch/kernels/csrc/flash_prefill.cu",
              "src/repro/kernels/flash_prefill.py:140", dtype, err,
              lambda: ops.flash_prefill(*args, **kw),
              lambda: ref.flash_prefill_ref(*args, **kw),
              _nbytes(q, k, v, out), 4 * B * H * D * (S * (S + 1) // 2),
              library_fn=lib)
  recs[r["name"]] = r
  args, kw = seen["flash_decode"]
  q, k, v = args[:3]
  scale = {}
  for fam, a in (("Q", q), ("K", k), ("V", v)):
    rms = float(a.float().square().mean().sqrt())
    scale[fam] = 2.0 ** -round(math.log2(rms)) if rms > 0 else 1.0
  if latent:                  # MLA's key and value are the same latent
    scale["V"] = scale["K"]
  q, k, v = q * scale["Q"], k * scale["K"], v * scale["V"]
  args = (q, k, v, *args[3:])
  print(f"  [flash_decode{tag}] inputs scaled by {scale}")
  out = ops.flash_decode(*args, **kw)
  B, H, D = q.shape
  S = k.shape[2]
  err = _check(f"flash_decode{tag} S={S} H={H} Hkv={k.shape[1]} scaled",
               dtype, out, ref.flash_decode_ref(*args, **kw),
               *PARTIALS_TOL[dtype])
  # SDPA computes the same function (its math backend at the latent's D =
  # 576, the f32 query rounded to the cache's bf16).
  lib = (None if args[3:4] != (None,) and len(args) > 3
         else lambda: sdpa(q.to(k.dtype)[:, :, None], k, v, enable_gqa=True,
                           scale=kw.get("sm_scale")))
  r = _record(f"flash_decode{tag}",
              "src/repro_torch/kernels/csrc/"
              + ("latent_mma.cuh" if latent else "flash_decode.cu"),
              "src/repro/kernels/flash_decode.py:125", dtype, err,
              lambda: ops.flash_decode(*args, **kw),
              lambda: ref.flash_decode_ref(*args, **kw),
              _nbytes(q, k, v, *out), 4 * B * H * S * D, library_fn=lib)
  recs[r["name"]] = _bound_share(r, dtype)
  return recs


def _tp_require_launches(label, cfg, launches):
  """Every kernel of the cut path launched: flash_prefill at prefill,
  segment_build at the build (the global cache, as the loop builds it),
  stage 1 and stage 2 each step on every layer, flash_decode in the exact
  steps; the latent core's keys under MLA."""
  want = ["flash_prefill", "segment_build"]
  mla = "[latent]" if cfg.mla is not None else ""
  want += [f"fused_synopsis_score_attention{mla}",
           f"block_gather_attention{mla}", f"flash_decode{mla}"]
  missing = [k for k in want if not launches.get(k)]
  if missing:
    raise AssertionError(f"[tp] {label}: kernels of the cut path never "
                         f"launched: {missing} ({launches})")


def _mesh_tp(cfg, params, dev, out, label_arch, meshes, prompt_len,
             syn_steps=MESH_STEPS, f32=False):
  """The cut serving path of ``cfg`` (full width) on each of ``meshes``
  ((shape, axes, rules[, synopsis steps, else ``syn_steps``])): every
  rank's weights cut by ``shard_params``,
  their ``memory_allocated`` held to the ``shard_shape`` bytes, then
  ``_tp_case``.  ``params``: the whole weights on every rank (the first
  rank of each data group holds its rows to the one-rank step), or None
  to build them rank by rank (too large for 8 at once) and keep them on
  rank 0 only.  With ``f32`` (given ``params``) the program runs in f32:
  each rank's shard of ``params`` cast leaf by leaf, and the comparing
  ranks' whole copy cast."""
  import torch.distributed as dist
  from repro_torch.dist import sharding as shd
  from repro_torch.models import transformer as tf
  g = torch.Generator(dev).manual_seed(2)
  prompt = torch.randint(0, cfg.vocab, (MESH_B, prompt_len), generator=g,
                         device=dev)
  rank = dist.get_rank()
  if f32:
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
  for shape, axes, rules, *steps in meshes:
    mesh = shd.Mesh(shape, axes)
    label = f"{label_arch} " + "x".join(f"{a}{n}"
                                        for a, n in zip(axes, shape))
    if "embed" in rules and rules["embed"] is not None:
      label += " fsdp"
    whole = params
    if mesh.member:
      if params is None:
        for r in range(mesh.size):
          if r == rank:
            w = tf.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
            torch.cuda.synchronize()
            before = _held_bytes()
            local, specs = shd.shard_params(w, cfg, mesh, rules)
            held = [a - b for a, b in zip(_held_bytes(), before)]
            # Rank 0 keeps the whole weights for its rows' one-rank steps
            # and their f32 witness (two copies more would not fit).
            whole = w if rank == 0 else None
            del w
            gc.collect()
            torch.cuda.empty_cache()
          dist.barrier(group=mesh._line(mesh.axis_names)[0])
      else:
        torch.cuda.synchronize()
        before = _held_bytes()
        local, specs = shd.shard_params(params, cfg, mesh, rules)
        if f32:
          _f32(local, in_place=True)
        held = [a - b for a, b in zip(_held_bytes(), before)]
        # The cut logits are the same on every rank of a data group: the
        # first of each holds them to the one-rank step (and its witness).
        whole = None
        if mesh.coords.get("model", 0) == 0:
          whole = _f32(params) if f32 else params
      raw, rounded = _shard_bytes(cfg, specs, mesh)
      if held[0] != raw or held[1] < rounded:
        raise AssertionError(f"[tp] {label} rank {rank}: its weights hold "
                             f"{held[0]} requested / {held[1]} allocated "
                             f"bytes, the shard_shape bytes {raw} "
                             f"({rounded} in the allocator's 512s)")
      res = _tp_case(cfg, local, whole, mesh, rules, prompt, dev, label,
                     capture=rank == 0 and axes == ("data", "model"),
                     syn_steps=steps[0] if steps else syn_steps,
                     own_whole=params is None)
      res.update(weight_bytes=held, shard_bytes=(raw, rounded))
      out.setdefault("tp", {})[label] = res
      _tp_require_launches(label, cfg, res["launches"])
      del local, whole
      gc.collect()
      torch.cuda.empty_cache()
    dist.barrier()


def _mesh_engine(cfg, params, dev, out, fleet):
  """One short Poisson window of the cluster tier on a (component 4) mesh
  (the first 4 ranks) or of the fleet tier on a (replica 2, component 4)
  mesh (all 8), under accuracytrader, as a functional check (requests and
  tokens served, steps, budget, loss; too few requests for a latency); the
  kernels' launches with the counts reset just before; then one probe step
  whose stage 1, stage 2 and flash_decode calls are held against their
  plain versions."""
  import torch.distributed as dist
  from repro_torch.dist import topology
  from repro_torch.kernels import _build, ops
  from repro_torch.serve.cluster import ClusterConfig, ClusterStepBackend
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  from repro_torch.serve.fleet import FleetConfig, FleetStepBackend
  rank = dist.get_rank()
  need = MESH_N * (MESH_R if fleet else 1)
  label = f"fleet N={MESH_N} R={MESH_R}" if fleet else f"cluster N={MESH_N}"
  if rank >= need:                   # builds its part of the mesh, waits
    topology.make_component_mesh(MESH_N)
    dist.barrier()
    return
  backend = (FleetStepBackend(FleetConfig(n_components=MESH_N,
                                          replicas=MESH_R, use_mesh=True))
             if fleet else ClusterStepBackend(ClusterConfig(
                 n_components=MESH_N, use_mesh=True)))
  _sync(dev)
  _build.reset_launches()
  t0 = time.perf_counter()
  eng = ServingEngine(cfg, EngineConfig(
      n_slots=ENGINE_SLOTS, prompt_len=MESH_PROMPT, max_new_tokens=MESH_NEW,
      deadline_ms=ENGINE_DEADLINE_MS, policy="accuracytrader"),
      params=params, device=dev, backend=backend)
  built = time.perf_counter() - t0
  backend.mesh.reset_stats()
  s = run_open_loop(eng, ENGINE_RATE, MESH_WINDOW_S, seed=0)
  counts = _build.launch_counts()
  stats = dict(backend.mesh.stats)
  with _first_inputs(ops, CLUSTER_KERNELS) as seen:
    eng.probe_step_ms(MESH_BUDGET, iters=1)
  res = {"built_s": built, "eager": not eng.programs.captures,
         "summary": {k: s[k] for k in ("n", "steps", "mean_budget",
                                       "accuracy_loss_pct",
                                       "deadline_miss_pct")},
         "tokens": sum(len(r.tokens) for r in eng.completed
                       if not r.dropped),
         "launches": {k: counts[k] for k in CLUSTER_KERNELS + (
             "flash_prefill", "segment_build")},
         "kernel_errs": _plain_errs(seen, cfg.dtype),
         "gather_bytes_step": stats["bytes"] / max(s["steps"], 1),
         "gather_ms_step": stats["ms"] / max(s["steps"], 1),
         "served": all(len(r.tokens) == MESH_NEW + 1 for r in eng.completed
                       if not r.dropped) and s["n"] > 0}
  if rank == 0 and not fleet:
    out["seen_cluster"] = seen
  missing = [k for k in CLUSTER_KERNELS if not counts[k]]
  if missing or not res["served"] or not res["eager"]:
    raise AssertionError(f"[mesh] {label} rank {rank}: kernels not launched "
                         f"{missing}, served {res['served']}, eager "
                         f"{res['eager']}")
  out[label] = res
  del eng, backend
  gc.collect()
  torch.cuda.empty_cache()
  dist.barrier()


def _mesh_parity(dev, out):
  """SMOKE llama3-8b in f32: the cluster engine on a (component 4) mesh and
  the fleet engine on a (replica 2, component 2) mesh of the first 4 ranks
  against rank 0's stacked engines of the same configs, under basic and
  fixed: the same ids."""
  import torch.distributed as dist
  from repro_torch.configs.registry import get_config
  from repro_torch.dist import topology
  from repro_torch.models import transformer as tf
  from repro_torch.serve.cluster import ClusterConfig, ClusterStepBackend
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  from repro_torch.serve.fleet import FleetConfig, FleetStepBackend
  rank = dist.get_rank()
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  params = _tree_to(tf.init_model(cfg, torch.Generator().manual_seed(1),
                                  "cpu"), dev)
  tiers = (("cluster", lambda m: ClusterStepBackend(ClusterConfig(
      n_components=4, skew=CLUSTER_SKEW, use_mesh=m))),
           ("fleet", lambda m: FleetStepBackend(FleetConfig(
               n_components=2, replicas=2, use_mesh=m))))
  for tier, backend_of in tiers:
    for arm in (dict(policy="basic"), dict(policy="fixed", fixed_budget=2)):
      ids = {}
      for where in ("mesh", "stacked"):
        if where == "mesh" and rank >= 4:
          if tier == "fleet":
            topology.make_fleet_mesh(2, 2)
          else:
            topology.make_component_mesh(4)
          continue
        if where == "stacked" and rank != 0:
          continue
        eng = ServingEngine(
            cfg, EngineConfig(n_slots=2, prompt_len=128, max_new_tokens=8,
                              deadline_ms=1e6, **arm), params=params,
            device=dev, backend=backend_of(where == "mesh"))
        run_open_loop(eng, 20.0, 0.3, seed=3)
        ids[where] = [r.tokens for r in sorted(eng.completed,
                                               key=lambda r: r.rid)]
        del eng
        gc.collect()
      if rank == 0:
        if ids["mesh"] != ids["stacked"] or not ids["mesh"]:
          raise AssertionError(f"[mesh parity] {tier} {arm}: mesh ids "
                               f"{ids['mesh']} vs stacked {ids['stacked']}")
        out.setdefault("parity", []).append(
            (tier, arm["policy"], sum(map(len, ids["mesh"])),
             len(ids["mesh"])))
      dist.barrier()


def _one_rank_compressed(cfg, opt_cfg, dev, steps, batch, seq, shares):
  """The one-rank reference of the compressed mesh step: the shares as
  microbatches, then ``local_quantise_feedback`` and AdamW; the losses and
  the final state."""
  from repro_torch.train import compression as comp
  from repro_torch.train.data import DataConfig, TokenStream
  from repro_torch.train.optimizer import adamw_update
  from repro_torch.train.train_step import init_train_state, loss_and_grads
  state = init_train_state(cfg, opt_cfg, device=dev, compress=True,
                           generator=torch.Generator(dev).manual_seed(0))
  data = TokenStream(DataConfig(cfg.vocab, seq, batch, seed=0))
  losses = []
  for i in range(steps):
    tokens, labels = data.batch_at(i)
    loss, _, grads = loss_and_grads(cfg, state["params"], {
        "tokens": torch.from_numpy(tokens).to(dev),
        "labels": torch.from_numpy(labels).to(dev)}, microbatches=shares)
    with torch.no_grad():
      deq, err = comp.local_quantise_feedback(grads, state["err"])
      params, opt, _ = adamw_update(deq, state["opt"], state["params"],
                                    opt_cfg)
    state = {"params": params, "opt": opt, "err": err}
    losses.append(float(loss))
  return losses, state


def _mesh_train(dev, out):
  """smollm-135m at full width (MESH_TRAIN_DEPTH layers) on a (pod 2, data
  2) mesh of the first 4 ranks: MESH_TRAIN_STEPS steps at TRAIN_BATCH x
  TRAIN_SEQ
  through ``launch.train.run(mesh=..., compress_pods=True)``, no kernel
  launched; on rank 0 the one-rank step over the same shares with
  ``local_quantise_feedback``, twice (the card's run-to-run spread): the
  mesh run's losses within twice that spread (1e-5 of the loss at
  least), its parameters and error buffers, leaf by leaf, within twice
  theirs (4e-5 of the leaf's max|ref| at least: the CPU tests' bound), so
  that a wrong gradient reduction fails even where the losses, near flat
  at this init, do not move."""
  import torch.distributed as dist
  from repro_torch.configs.registry import get_config
  from repro_torch.dist import sharding as shd
  from repro_torch.kernels import _build
  from repro_torch.launch import train
  from repro_torch.models.common import leaves
  from repro_torch.train.optimizer import OptConfig
  mesh = shd.Mesh((2, 2), ("pod", "data"))
  if mesh.member:
    cfg = dataclasses.replace(get_config("smollm-135m"),
                              n_layers=MESH_TRAIN_DEPTH)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1,
                        total_steps=MESH_TRAIN_STEPS)
    _build.reset_launches()
    mesh.reset_stats()
    run = train.run(cfg, steps=MESH_TRAIN_STEPS, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, opt_cfg=opt_cfg, device=dev, mesh=mesh,
                    compress_pods=True, log=lambda _: None)
    launched = {k: v for k, v in _build.launch_counts().items() if v}
    res = {"losses": run["losses"], "step_ms": run["step_ms"],
           "launched": launched,
           "gather_mb_step": mesh.stats["bytes"] / 1e6 / MESH_TRAIN_STEPS,
           "gather_ms_step": mesh.stats["ms"] / MESH_TRAIN_STEPS}
    if launched:
      raise AssertionError(f"[mesh train] kernels launched: {launched}")
    if mesh.rank == 0:
      a = _one_rank_compressed(cfg, opt_cfg, dev, MESH_TRAIN_STEPS,
                               TRAIN_BATCH, TRAIN_SEQ, 4)
      b = _one_rank_compressed(cfg, opt_cfg, dev, MESH_TRAIN_STEPS,
                               TRAIN_BATCH, TRAIN_SEQ, 4)
      spread = max(abs(x - y) for x, y in zip(a[0], b[0]))
      bound = max(2 * spread, 1e-5 * max(map(abs, a[0])))
      dev_l = max(abs(x - y) for x, y in zip(run["losses"], a[0]))

      def rel(got, part):
        want = dict(leaves(a[1][part]))
        return max(float((x - want[p]).abs().max()
                         / want[p].abs().max().clamp_min(1e-30))
                   for p, x in leaves(got[part]))
      res.update(ref_losses=a[0], spread=spread, bound=bound, dev=dev_l)
      for part in ("params", "err"):
        res[f"{part}_rel"] = rel(run["state"], part)
        res[f"ref_spread_{part}"] = rel(b[1], part)
        res[f"{part}_bound"] = max(2 * res[f"ref_spread_{part}"], 4e-5)
      if not dev_l <= bound:
        raise AssertionError(f"[mesh train] losses {run['losses']} off the "
                             f"one-rank step's {a[0]} by {dev_l} > {bound}")
      for part in ("params", "err"):
        if not res[f"{part}_rel"] <= res[f"{part}_bound"]:
          raise AssertionError(
              f"[mesh train] {part} {res[f'{part}_rel']} of max|ref| off "
              f"the one-rank step's > {res[f'{part}_bound']}")
    out["train"] = res
  dist.barrier()


def _state_leaves(params, opt):
  """{"<part>/<leaf>": tensor} of the master, m and v."""
  from repro_torch.models.common import leaves
  return {f"{part}/{p}": x for part, tree in (
      ("master", params), ("m", opt["m"]), ("v", opt["v"]))
          for p, x in leaves(tree)}


def _tp_train_step1(cfg, opt_cfg, mesh, batch, dev):
  """Step 1 of ``cfg``'s state (seed 0) cut by TRAIN_RULES: (loss,
  {leaf: gradient}, {part/leaf: master, m, v after AdamW on the cut state,
  its global norm summed over each leaf's cut}) assembled on every rank;
  on rank 0 the one-rank step's loss and gradients on the same batch (the
  data shares as microbatches) and the one-rank AdamW applied to the
  assembled gradients, else None.  (AdamW's first step is near sign(g):
  where a gradient is near 0, the two steps' gradients, 1e-7 of max|ref|
  apart, can move its master ~1e-5 of max|ref|; on the same gradients only
  the global norm's order of summation differs.)"""
  from repro_torch.dist import sharding as shd
  from repro_torch.models.common import leaves
  from repro_torch.train.optimizer import adamw_update
  from repro_torch.train.train_step import (init_train_state,
                                            loss_and_grads,
                                            mesh_loss_and_grads,
                                            shard_batch, shard_train_state,
                                            unshard_train_state)
  whole = init_train_state(cfg, opt_cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
  state = shard_train_state(whole, cfg, mesh, shd.TRAIN_RULES)
  loss, _, grads = mesh_loss_and_grads(cfg, state["params"],
                                       shard_batch(batch, mesh), mesh)
  with torch.no_grad():
    params, opt, _ = adamw_update(grads, state["opt"], state["params"],
                                  opt_cfg, mesh=mesh)
  new = unshard_train_state({"params": params, "opt": opt}, mesh)
  assembled = shd.unshard_tree(grads, mesh)
  cut = (float(loss), dict(leaves(assembled)),
         _state_leaves(new["params"], new["opt"]))
  del state, grads, params, opt, new
  one = None
  if mesh.rank == 0:
    loss, _, grads = loss_and_grads(cfg, whole["params"], batch,
                                    microbatches=mesh.shape["data"])
    with torch.no_grad():
      params, opt, _ = adamw_update(assembled, whole["opt"],
                                    whole["params"], opt_cfg)
    one = (float(loss), dict(leaves(grads)), _state_leaves(params, opt))
  return cut, one


def _rel_leaves(got, ref, part=1):
  """{"loss": relative error, leaf: max |diff| / max|ref|} of the
  gradients (``part`` 1) or the state after the step (2)."""
  return {"loss": abs(got[0] - ref[0]) / abs(ref[0]),
          **{p: float((x - ref[part][p]).abs().max()
                      / ref[part][p].abs().max().clamp_min(1e-30))
             for p, x in got[part].items()}}


def _mesh_tp_train(dev, out):
  """[tp train] on every rank (the first 6 hold the mesh): the f32 state
  of smollm-135m cut by ``shard_train_state`` under TRAIN_RULES, each
  rank's master, m and v (and the allocator's delta) held to 3 x their
  ``shard_shape`` f32 bytes; the gate: step 1 in float64 on its first
  TP_TRAIN_GATE_DEPTH layers against the one-rank float64 step, within
  TP_TRAIN_F64_TOL of max|ref| (loss and every leaf's gradient), and every
  leaf's master, m and v after AdamW on the cut state, whose global norm
  sums each leaf's squares over its cut, against the one-rank AdamW on the
  same assembled gradients, within the same bound; then TP_TRAIN_STEPS
  f32 steps of ``make_train_step(mesh=...)`` at every layer, timed (each
  rank holds only its shard), with no kernel launched."""
  import torch.distributed as dist
  from repro_torch.configs.registry import get_config
  from repro_torch.dist import sharding as shd
  from repro_torch.kernels import _build
  from repro_torch.models import common as cm
  from repro_torch.train.data import DataConfig, TokenStream
  from repro_torch.train.optimizer import OptConfig, tree_leaves
  from repro_torch.train.train_step import (init_train_state,
                                            make_train_step, shard_batch,
                                            shard_train_state)
  mesh = shd.Mesh(*TP_TRAIN_MESH)
  if mesh.member:
    cfg = dataclasses.replace(get_config("smollm-135m"), dtype=torch.float32)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=TP_TRAIN_STEPS)
    data = TokenStream(DataConfig(cfg.vocab, TP_TRAIN_SEQ, TP_TRAIN_BATCH,
                                  seed=0))
    batches = []
    for i in range(TP_TRAIN_STEPS):
      tokens, labels = data.batch_at(i)
      batches.append({"tokens": torch.from_numpy(tokens).to(dev),
                      "labels": torch.from_numpy(labels).to(dev)})
    _build.reset_launches()
    res = {}
    # The gate, at TP_TRAIN_GATE_DEPTH layers in float64.
    cut, one = _tp_train_step1(
        dataclasses.replace(cfg, dtype=torch.float64,
                            n_layers=TP_TRAIN_GATE_DEPTH),
        opt_cfg, mesh, batches[0], dev)
    if one is not None:
      res["rel64"] = _rel_leaves(cut, one)
      res["state64"] = _rel_leaves(cut, one, part=2)
      for d in (res["rel64"], res["state64"]):
        worst = max(d, key=d.get)
        if not d[worst] <= TP_TRAIN_F64_TOL:
          raise AssertionError(
              f"[tp train] the cut step's float64 {worst} off the one-rank "
              f"float64 step's by {d[worst]:.3e} of max|ref| > "
              f"{TP_TRAIN_F64_TOL} ({TP_TRAIN_GATE_DEPTH} layers)")
    del cut, one
    whole = init_train_state(cfg, opt_cfg, device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    before = _held_bytes()
    state = shard_train_state(whole, cfg, mesh, shd.TRAIN_RULES)
    torch.cuda.synchronize()
    held = [a - b for a, b in zip(_held_bytes(), before)]
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    shapes = dict(cm.leaves(cm.param_shapes(cfg)))
    axes = dict(cm.leaves(cm.param_axes(cfg)))
    want = 4 * sum(math.prod(shd.shard_shape(
        s_, shd.mesh_axes_for(axes[p], mesh, shd.TRAIN_RULES, shape=s_),
        mesh)) for p, s_ in shapes.items())
    parts = [sum(x.numel() * x.element_size() for x in tree_leaves(t))
             for t in (state["params"], state["opt"]["m"],
                       state["opt"]["v"])]
    if parts != [want] * 3 or held[0] != 3 * want:
      raise AssertionError(f"[tp train] rank {mesh.rank}: master, m, v "
                           f"{parts} bytes (allocator {held}), want 3 x "
                           f"{want}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.reset_stats()
    step = make_train_step(cfg, opt_cfg, mesh=mesh)
    losses, step_ms = [], []
    for b in batches:
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      state, m = step(state, shard_batch(b, mesh))
      torch.cuda.synchronize()
      step_ms.append((time.perf_counter() - t0) * 1e3)
      losses.append(float(m["loss"]))
    launched = {k: v for k, v in _build.launch_counts().items() if v}
    if launched:
      raise AssertionError(f"[tp train] kernels launched: {launched}")
    res.update(losses=losses, step_ms=step_ms, bytes=(parts, held),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               calls_step=mesh.stats["calls"] / TP_TRAIN_STEPS,
               bytes_step=mesh.stats["bytes"] / TP_TRAIN_STEPS,
               gloo_ms_step=mesh.stats["ms"] / TP_TRAIN_STEPS,
               kinds_step={k: mesh.stats[k] / TP_TRAIN_STEPS
                           for k in shd.COLLECTIVES if mesh.stats[k]})
    out["tp_train"] = res
    del state
    gc.collect()
    torch.cuda.empty_cache()
  dist.barrier()


def _mesh_rank(device="cuda"):
  """The phase's body on every rank of the world (see run_mesh)."""
  import torch.distributed as dist
  from repro_torch.configs.registry import get_config
  from repro_torch.dist import sharding as shd
  from repro_torch.models import transformer as tf
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = (torch.device("cuda", torch.cuda.current_device())
         if device == "cuda" else torch.device(device))
  rank = dist.get_rank()
  out = {"rank": rank, "t": {}}
  cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=MESH_DEPTH)
  t0 = time.perf_counter()
  params = tf.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
  _mesh_synopsis(cfg, params, dev, out)
  out["t"]["synopsis"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  fsdp = dict(shd.SERVE_RULES, embed=("data",))
  _mesh_tp(cfg, params, dev, out, "llama3-8b", (
      ((MESH_N,), ("model",), shd.SERVE_RULES),
      ((2, MESH_N), ("data", "model"), fsdp, TP_FSDP_STEPS)), MESH_PROMPT,
      f32=True)
  out["t"]["tp llama3-8b"] = time.perf_counter() - t0
  for fleet in (False, True):
    t0 = time.perf_counter()
    _mesh_engine(cfg, params, dev, out, fleet)
    out["t"]["fleet" if fleet else "cluster"] = time.perf_counter() - t0
  if rank == 0:
    # The [mesh] and [tp] records, timed with every other rank waiting.
    seen = {**out.pop("seen_syn"), "flash_decode":
            out.pop("seen_cluster")["flash_decode"]}
    out["records"] = _cluster_records(
        seen, cfg.dtype, G=cfg.n_heads // cfg.n_kv_heads,
        C=cfg.synopsis.cluster_size,
        sdpa=torch.nn.functional.scaled_dot_product_attention, tag="[mesh]")
    tp = out["tp"]["llama3-8b data2xmodel4 fsdp"]
    out["records"].update(_tp_records(
        tp.pop("seen"), dataclasses.replace(cfg, dtype=torch.float32),
        "[tp]"))
  dist.barrier()
  del params
  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  ds = dataclasses.replace(get_config("deepseek-v2-236b"),
                           n_layers=TP_DS_DEPTH)
  _mesh_tp(ds, None, dev, out, "deepseek-v2-236b", (
      ((2, MESH_N), ("data", "model"), fsdp),), TP_DS_PROMPT, TP_DS_STEPS)
  if rank == 0:
    tp = out["tp"]["deepseek-v2-236b data2xmodel4 fsdp"]
    out["records"].update(_tp_records(tp.pop("seen"), ds, "[tp-mla]"))
  for r in out.get("tp", {}).values():
    r.pop("seen", None)
  dist.barrier()
  gc.collect()
  torch.cuda.empty_cache()
  out["t"]["tp deepseek-v2-236b"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  _mesh_parity(dev, out)
  out["t"]["parity"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  _mesh_train(dev, out)
  out["t"]["train"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  _mesh_tp_train(dev, out)
  out["t"]["tp train"] = time.perf_counter() - t0
  out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                    if dev.type == "cuda" else float("nan"))
  return out


def run_mesh(dev, smi):
  """Phase 23 (``[mesh]``): MESH_WORLD ranks spawned on the one card
  (``dist.world.run_world``), each a process running the same program on
  its shard: the sharded synopsis attention through the serve step (a
  model-4 and a data-2 x model-4 mesh), one cluster window (N = 4) and one
  fleet window (N = 4, R = 2) on the engine, the SMOKE engines' ids on a
  mesh against the stacked engines', and the mesh train step of
  smollm-135m over (pod 2, data 2).  A rank that fails fails the phase.
  Then the weights cut by the rule tables (``shard_params``) on the serving
  path: llama3-8b (MESH_DEPTH layers, in f32) under SERVE_RULES on the
  model-4 mesh and with ``embed -> data`` on the data-2 x model-4 mesh,
  and deepseek-v2-236b (TP_DS_DEPTH layer, in bf16: MLA, its experts over
  `model`, the shared experts, the FSDP gathers) on the second: prefill,
  the build, MESH_STEPS synopsis steps (deepseek's TP_DS_STEPS) and
  TP_STEPS_EXACT exact ones against the one-rank step on the same global
  weights and cache, within TP_F32_TOL (llama3) or the bf16 witness's
  bound (deepseek) of max|ref| (``[tp]``).
  Returns (the records ``<kernel>[mesh]``, ``<kernel>[tp]`` and
  ``<kernel>[tp-mla]``, their launches on the phase's paths: stage 1 and
  stage 2 on the data-2 x model-4 serve steps, rank 0's, flash_decode on
  the cluster window; each [tp] kernel on rank 0's cut path)."""
  from repro_torch.dist import world
  _free()
  print(f"[mesh] this process holds {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB of the card ({torch.cuda.memory_reserved() / 1e9:.2f} reserved) "
        f"while the ranks run")
  t0 = time.perf_counter()
  backend = world.backend_for(dev, MESH_WORLD)
  print(f"[mesh] {MESH_WORLD} ranks on {torch.cuda.device_count()} card: "
        f"backend {backend} (the collectives' operands staged through host "
        f"memory; NCCL, one card a rank, is not exercised here); "
        f"llama3-8b at full width, {MESH_DEPTH} of 32 layers on every rank")
  res = world.run_world(_mesh_rank, MESH_WORLD, device="cuda",
                        timeout_s=MESH_TIMEOUT_S)
  r0 = res[0]
  for label in ("model4", "data2xmodel4"):
    rs = [r["synopsis"][label] for r in res if label in r.get("synopsis",
                                                              {})]
    print(f"[mesh] sharded synopsis {label} (SERVE_RULES), {len(rs)} ranks: "
          f"layout {rs[0]['layout']}, rank shard k {rs[0]['shard']}; layer 0 "
          f"against the one-rank kernels on the global cache: max abs err "
          f"{max(x['attn_err'] for x in rs):.3e} (tol {MESH_TOL[0]:.0e}+"
          f"{MESH_TOL[1]:.0e}|x|) at budget {MESH_BUDGET} of M = {r0['M']}; "
          f"{MESH_STEPS} decode steps: ms {[round(t, 2) for t in rs[0]['step_ms']]} "
          f"(rank 0), stage 1 / stage 2 launches per rank "
          f"{[tuple(x['launches'].values()) for x in rs]} "
          f"({MESH_DEPTH} a step each)")
    print(f"[mesh] {label}: per layer and rank {rs[0]['collectives_layer']:.0f} "
          f"collectives, {rs[0]['gather_bytes_layer']:.0f} bytes all-gathered "
          f"(received), host-staged gloo ms {rs[0]['gather_ms_layer']:.3f} "
          f"(host clock, rank 0; {smi})")
    if "kernel_errs" in rs[0]:
      print(f"[mesh] {label} kernels against their plain versions on each "
            f"rank's shard: max abs err "
            + ", ".join(f"{k} {max(x['kernel_errs'][k] for x in rs):.3e}"
                        for k in MESH_KERNELS))
  for label in (f"cluster N={MESH_N}", f"fleet N={MESH_N} R={MESH_R}"):
    rs = [r[label] for r in res if label in r]
    s = rs[0]["summary"]
    print(f"[mesh engine] {label}, {len(rs)} ranks, eager steps: built in "
          f"{rs[0]['built_s']:.1f}s; a functional check, not a latency "
          f"(too few requests): n={s['n']} requests, {rs[0]['tokens']} tokens "
          f"served, steps={s['steps']} mean_budget="
          f"{s['mean_budget']:.2f} loss={s['accuracy_loss_pct']:.3f}% "
          f"miss={s['deadline_miss_pct']:.1f}%; launches per rank "
          f"{[tuple(x['launches'].values()) for x in rs]} "
          f"{tuple(rs[0]['launches'])}; all-gathered {rs[0]['gather_bytes_step']:.0f} "
          f"bytes a step and rank in {rs[0]['gather_ms_step']:.2f} ms "
          f"(host-staged gloo, host clock; {smi}); kernels against their "
          f"plain versions: "
          + ", ".join(f"{k} {max(x['kernel_errs'][k] for x in rs):.3e}"
                      for k in CLUSTER_KERNELS))
  for label in r0.get("tp", {}):
    rs = [r["tp"][label] for r in res if label in r.get("tp", {})]
    rels = {}
    for x in rs:
      for k, v in x["rel"].items():
        rels[k] = max(rels.get(k, v), v, key=lambda t: t[0])
    f32 = all(v[1] is None for v in rels.values())
    print(f"[tp] {label}: weights cut by the rules on {len(rs)} ranks, "
          f"each holding its shard_shape bytes: requested "
          f"{sorted({x['weight_bytes'][0] for x in rs})} (want "
          f"{sorted({x['shard_bytes'][0] for x in rs})}), allocated "
          f"{sorted({x['weight_bytes'][1] for x in rs})} (the allocator's "
          f"512s: {sorted({x['shard_bytes'][1] for x in rs})}); layout "
          f"{rs[0]['layout']}, rank shard k {rs[0]['shard_k']}")
    how = (f"f32 step on the same global weights and cache, max |diff| / "
           f"max|ref| (bound {TP_F32_TOL:.0e})" if f32 else
           f"bf16 step on the same global weights and cache, max |diff| / "
           f"max|ref| (the one-rank step's f32 witness; the bound, "
           f"{TP_WITNESS:.0f}x it, {TP_FLOOR:.4f} at least, "
           f"{TP_WITNESS_CAP} at most)")
    print(f"[tp] {label}: the cut program against the one-rank {how}: "
          + ", ".join(f"{k} {v[0]:.3e}" + ("" if f32 else
                                          f" ({v[1]:.3e}; {v[2]:.3e})")
                      for k, v in rels.items())
          + f"; prefill {rs[0]['ms']['prefill']:.1f} ms, "
          f"build {rs[0]['ms']['build']:.1f} ms, steps ms "
          f"{[round(t, 1) for t in rs[0]['step_ms']]} (rank 0, host clock, "
          f"ranks sharing the card)")
    print(f"[tp] {label}: launches of the cut path, rank 0 "
          f"{ {k: v for k, v in rs[0]['launches'].items() if v} }; prefill "
          f"collectives {rs[0]['prefill_stats']['calls']} "
          f"({rs[0]['prefill_stats']['bytes']:.0f} bytes received, "
          f"{rs[0]['prefill_stats']['ms']:.1f} ms host-staged); decode per "
          f"layer and rank {rs[0]['calls_layer']:.1f} collectives, "
          f"{rs[0]['bytes_layer']:.0f} bytes received, host-staged gloo ms "
          f"{rs[0]['gloo_ms_layer']:.3f} (host clock, rank 0; {smi})")
  for tier, policy, n_ids, n_req in r0["parity"]:
    print(f"[mesh parity] smoke f32 {tier} {policy}: {n_ids} ids of {n_req} "
          f"requests on the mesh equal to the stacked engine's")
  tr = r0["train"]
  print(f"[mesh train] smollm-135m full width, {MESH_TRAIN_DEPTH} of 30 "
        f"layers, over (pod 2, data 2), "
        f"compress_pods: losses {[round(x, 5) for x in tr['losses']]} vs the "
        f"one-rank step {[round(x, 5) for x in tr['ref_losses']]}: max |diff| "
        f"{tr['dev']:.3e} (bound {tr['bound']:.3e}: twice the one-rank "
        f"run-to-run spread {tr['spread']:.3e}, 1e-5 of the loss at least); "
        f"params {tr['params_rel']:.3e} / err {tr['err_rel']:.3e} of max|ref| "
        f"per leaf off it (bounds {tr['params_bound']:.1e} / "
        f"{tr['err_bound']:.1e}: twice the one-rank run-to-run "
        f"{tr['ref_spread_params']:.3e} / {tr['ref_spread_err']:.3e}, 4e-5 "
        f"at least); step ms "
        f"{[round(x, 1) for x in tr['step_ms']]}; all-gathered "
        f"{tr['gather_mb_step']:.1f} MB received a step and rank by the "
        f"gradients' all-reduce (all-to-all + all-gather) in "
        f"{tr['gather_ms_step']:.1f} ms (host-staged gloo); no kernel launched")
  rs = [r["tp_train"] for r in res if "tp_train" in r]
  tt = rs[0]

  def worst(d, loss=True):
    k = max((p for p in d if p != "loss"), key=d.get)
    head = f"loss {d['loss']:.3e}, gradients max" if loss else "max"
    return f"{head} {d[k]:.3e} ({k})"
  print(f"[tp train] smollm-135m full width and depth, state cut by "
        f"TRAIN_RULES on (data 2, model 3) ({len(rs)} ranks): master / m / "
        f"v bytes a rank {sorted({x['bytes'][0][0] for x in rs})} each "
        f"(3 x their shard_shape f32 bytes; allocator requested "
        f"{sorted({x['bytes'][1][0] for x in rs})}); step 1 on "
        f"{TP_TRAIN_BATCH} x {TP_TRAIN_SEQ} against the one-rank step, of "
        f"max|ref|: float64 at {TP_TRAIN_GATE_DEPTH} layers "
        f"{worst(tt['rel64'])}; master / m / v after the cut AdamW against "
        f"the one-rank AdamW on the same gradients "
        f"{worst(tt['state64'], loss=False)} (bound "
        f"{TP_TRAIN_F64_TOL:.0e})")
  print(f"[tp train] {TP_TRAIN_STEPS} f32 steps: losses "
        f"{[round(x, 5) for x in tt['losses']]}; step ms "
        f"{[round(x, 1) for x in tt['step_ms']]} (rank 0, host clock, 6 ranks "
        f"sharing the card); peak memory a rank "
        f"{max(x['peak_gb'] for x in rs):.2f} GB; collectives a step and "
        f"rank {tt['calls_step']:.0f} (operand bytes "
        f"{ {k: round(v) for k, v in tt['kinds_step'].items()} }), "
        f"{tt['bytes_step'] / 1e6:.1f} MB received, host-staged gloo ms "
        f"{tt['gloo_ms_step']:.1f} ({smi}); no kernel launched")
  print(f"[mesh] rank phases (s): {r0['t']}; peak device memory per rank "
        f"{max(r['peak_gb'] for r in res):.2f} GB; phase in "
        f"{time.perf_counter() - t0:.1f}s")
  launches = dict(r0["syn_launches"])
  launches["flash_decode"] = r0[f"cluster N={MESH_N}"]["launches"][
      "flash_decode"]
  recs = r0["records"]
  out = {f"{k}[mesh]": launches[k] for k in CLUSTER_KERNELS}
  for label, tag in (("llama3-8b data2xmodel4 fsdp", "[tp]"),
                     ("deepseek-v2-236b data2xmodel4 fsdp", "[tp-mla]")):
    n = r0["tp"][label]["launches"]
    for k in TP_KERNELS:
      out[f"{k}{tag}"] = sum(v for key, v in n.items()
                             if key.split("[")[0] == k)
  return recs, out


# ---------------------------------------------------------------------------
# Phase 24: the dry run's per-rank program, traced on meta, against the card
# ---------------------------------------------------------------------------

# The trace's output + temp against the card's: within this share of the
# measured bytes or these bytes, whichever is larger (the caching
# allocator charges a large request the rest of its block when that rest
# is under 1 MB, too small to split off).
DRYRUN_SHARE, DRYRUN_BYTES = 0.10, 1 << 20


def _dryrun_against_card(label, step, meta_args, card_args, smi):
  """Trace ``step`` on ``meta_args`` (``MemoryTracker``), then run it on
  ``card_args`` after one warm-up call (lazy workspaces): the argument
  bytes must be equal, and the trace's output + temp (its peak of new
  storage) must match ``max_memory_allocated() - memory_allocated()``
  around the call within DRYRUN_SHARE or DRYRUN_BYTES."""
  from repro_torch.analysis.tracker import MemoryTracker, storage_bytes
  t0 = time.perf_counter()
  with MemoryTracker(meta_args) as trk:
    out = step(*meta_args)
    trk.finish(out)
  del out
  trace_s = time.perf_counter() - t0
  predicted = trk.output_bytes - trk.alias_bytes + trk.temp_bytes
  args = storage_bytes(card_args)
  out = step(*card_args)
  del out
  gc.collect()
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  out = step(*card_args)
  torch.cuda.synchronize()
  step_ms = (time.perf_counter() - t0) * 1e3
  measured = torch.cuda.max_memory_allocated() - base
  del out
  tol = max(DRYRUN_SHARE * measured, DRYRUN_BYTES)
  print(f"[dryrun] {label}: argument bytes predicted {trk.argument_bytes} "
        f"measured {args}; output + temp predicted {predicted} (output "
        f"{trk.output_bytes - trk.alias_bytes}, temp {trk.temp_bytes}, "
        f"{trk.allocations} allocations) measured {measured} "
        f"(max_memory_allocated - memory_allocated), diff "
        f"{predicted - measured:+d} (tol {tol:.0f}); trace {trace_s:.1f}s, "
        f"step {step_ms:.1f} ms host; {smi}")
  if trk.argument_bytes != args:
    raise AssertionError(f"[dryrun] {label}: argument bytes predicted "
                         f"{trk.argument_bytes} != measured {args}")
  if abs(predicted - measured) > tol:
    raise AssertionError(f"[dryrun] {label}: output + temp predicted "
                         f"{predicted}, measured {measured}, beyond {tol}")


def run_dryrun_decode(cfg, params, dev, busy_ms, smi):
  """Phase 24, first half (on phase 6's llama3-8b weights): the card's
  memory beside the dry run's constant; the budget-32 synopsis step at the
  loop's shapes (B = BATCH, prompt PROMPT, every layer) traced on meta
  and run on the card (a zero cache of the loop's layout after its
  build); the cost model's bound for that step beside phase 6's profiled
  device time a step."""
  from repro_torch.analysis import costmodel, roofline
  from repro_torch.configs.shapes import ShapeSpec
  from repro_torch.launch import dryrun as dr
  from repro_torch.serve import kv_cache as kvc
  from repro_torch.serve.serve_step import make_serve_step
  t0 = time.perf_counter()
  total = torch.cuda.get_device_properties(0).total_memory
  print(f"[dryrun] total_memory {total} bytes "
        f"(launch.dryrun.CARD_MEMORY {dr.CARD_MEMORY}); {smi}")
  if total != dr.CARD_MEMORY:
    raise AssertionError(f"[dryrun] total_memory {total} != "
                         f"launch.dryrun.CARD_MEMORY {dr.CARD_MEMORY}")
  step = make_serve_step(cfg, mode="synopsis", i_max=cfg.synopsis.i_max)
  struct = kvc.cache_struct(cfg, BATCH, PROMPT, synopsis=True)
  meta = (dr.serve_params(cfg),
          {k: torch.empty(sh, dtype=dt, device="meta")
           for k, (sh, dt, _) in struct.items()},
          torch.empty((BATCH, 1), dtype=torch.long, device="meta"))
  card = (params, kvc.zeros_cache(cfg, BATCH, PROMPT, synopsis=True,
                                  device=dev),
          torch.zeros((BATCH, 1), dtype=torch.long, device=dev))
  _dryrun_against_card(
      f"{cfg.name} budget-{cfg.synopsis.i_max} synopsis step B={BATCH} "
      f"prompt={PROMPT} {cfg.n_layers} layers", step, meta, card, smi)
  del card
  c = costmodel.cell_cost(cfg, ShapeSpec("loop", PROMPT, BATCH, "decode"),
                          "synopsis")
  r = roofline.Roofline(c.flops_global, c.bytes_global, 0.0, 1)
  print(f"[dryrun] cost model's bound for that step {r.bound_s * 1e3:.4f} ms "
        f"({r.dominant}: {c.flops_global:.4e} FLOPs, {c.bytes_global:.4e} "
        f"bytes) against phase 6's profiled device time {busy_ms:.4f} ms a "
        f"step: {100 * r.bound_s * 1e3 / busy_ms:.1f}% (printed, not gated)")
  print(f"[dryrun] decode half in {time.perf_counter() - t0:.1f}s")


def run_dryrun_train(dev, smi):
  """Phase 24, second half: smollm-135m's train step (no mesh, one
  microbatch) at TRAIN_BATCH x TRAIN_SEQ traced on meta and run on the
  card, from ``init_train_state`` and the data pipeline's first batch."""
  from repro_torch.configs.registry import get_config
  from repro_torch.launch import dryrun as dr
  from repro_torch.train.data import DataConfig, TokenStream
  from repro_torch.train.optimizer import OptConfig
  from repro_torch.train.train_step import init_train_state, make_train_step
  t0 = time.perf_counter()
  _free()
  cfg = get_config("smollm-135m")
  opt_cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
  state = init_train_state(cfg, opt_cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
  tokens, labels = TokenStream(DataConfig(cfg.vocab, TRAIN_SEQ,
                                          TRAIN_BATCH)).batch_at(0)
  batch = {"tokens": torch.from_numpy(tokens).to(dev),
           "labels": torch.from_numpy(labels).to(dev)}
  meta = (dr.train_state(cfg, compress=False),
          {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
           for k, v in batch.items()})
  _dryrun_against_card(
      f"{cfg.name} train step {TRAIN_BATCH} x {TRAIN_SEQ}",
      make_train_step(cfg, opt_cfg), meta, (state, batch), smi)
  del state, batch
  _free()
  print(f"[dryrun] train half in {time.perf_counter() - t0:.1f}s")


T_START = time.perf_counter()


def _mark(label):
  """Prints the script's wall time so far, after ``label``."""
  print(f"[wall] {label}: {time.perf_counter() - T_START:.1f}s")


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 1
  sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
  from repro_torch.configs.registry import get_config
  from repro_torch.kernels import _build
  from repro_torch.launch import serve
  from repro_torch.models import transformer as tf
  from repro_torch.serve import synopsis_kv as skv

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  print(smi)
  print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

  # nvcc builds the kernels on a thread of its own while the phases that
  # launch none (plain torch: the generic-data services, training, the dry
  # run's train half, mamba2) run on the card; a kernel called meanwhile
  # would wait for the build, and each of these phases fails if one
  # launched.  Their CPU work takes BUILD_SIDE_THREADS threads, so that
  # nvcc keeps the other cores.
  t0 = time.perf_counter()
  ptxas = []
  threads = torch.get_num_threads()
  torch.set_num_threads(min(threads, BUILD_SIDE_THREADS))
  builder = _build.start_build(log=ptxas.append)
  try:
    run_apps(dev)
    run_train(dev)
    run_dryrun_train(dev, smi)
    run_mamba2(dev)
  finally:                       # no nvcc outlives the script
    t_free = time.perf_counter() - t0
    builder.join()
    torch.set_num_threads(threads)
  waited = time.perf_counter() - t0 - t_free
  _mark("the kernel-free phases and the build")
  if builder.error is not None:
    raise builder.error
  for report in ptxas:
    print(report)
  _build.library()
  n_quant = sum(map(len, _build.QUANT_BRANCHES.values()))
  print(f"[build] {len(_build.KERNELS)} CUDA kernels with {n_quant} "
        f"quantized branches ({len(_build.LAUNCHES)} launch-counted "
        f"branches) in {builder.seconds:.1f}s, beside {t_free:.1f}s of the "
        f"kernel-free phases 20-22 (waited {waited:.1f}s after them)")

  g = torch.Generator(dev).manual_seed(0)
  records = {}
  for dtype in (torch.float32, torch.bfloat16):
    _TIMING[0] = dtype == torch.bfloat16      # f32: correctness only
    checks = [functools.partial(c, dev, dtype, g) for c in (
        check_fused_synopsis, check_block_gather, check_segment_build,
        check_flash_prefill, check_flash_decode, check_synopsis_score)]
    checks += [functools.partial(check_segment_build_quant, dev, dtype, g, q)
               for q in QSPECS]
    checks += [functools.partial(check_fused_synopsis_quant, dev, dtype, g, k)
               for k in QKINDS]
    checks += [functools.partial(check_block_gather_quant, dev, dtype, g, q)
               for q in QSPECS]
    for check in checks:
      rec = check()
      if dtype == torch.bfloat16:          # the serving path's type
        records.setdefault(rec["name"], rec)
      torch.cuda.empty_cache()
  _flush.clear()                 # the loops' peak memory leaves it out
  _mark("phase 3, each kernel against its plain version")

  smoke_launches = check_small_model_parity(dev)
  _mark("phase 4, the SMOKE loops card against CPU")

  cfg = get_config("llama3-8b")
  print(f"[model] {cfg.name} full width: {cfg.n_layers} layers, d="
        f"{cfg.d_model}, {cfg.param_count() / 1e9:.2f}B params, "
        f"{cfg.dtype}; B={BATCH} prompt={PROMPT} steps={STEPS}")
  t0 = time.perf_counter()
  params = tf.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
  torch.cuda.synchronize()
  print(f"[model] random weights in {time.perf_counter() - t0:.1f}s")
  torch.cuda.reset_peak_memory_stats()   # the main path's peak, not the checks'
  _build.reset_launches()
  out = serve.run(cfg, batch=BATCH, prompt_len=PROMPT, tokens=STEPS,
                  deadline_ms=DEADLINE_MS, device=dev, params=params,
                  log=lambda s: None if s.startswith("[decode") else print(s))
  launches = _build.launch_counts()
  print(f"[main path] prefill_ms={out['prefill_ms']:.1f} build_ms="
        f"{out['build_ms']:.1f} decode_ms {_step_stats(out['step_ms'])} "
        f"absorbs={out['absorbs']} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f}")
  misses = sum(ms > DEADLINE_MS for ms in out["step_ms"])
  print(f"[main path] deadline {DEADLINE_MS} ms: {misses}/{STEPS} steps "
        "missed it")
  print(f"[main path] budgets {out['budgets']}")
  by_budget = {}
  for b, ms in zip(out["budgets"], out["step_ms"]):
    by_budget.setdefault(b, []).append(ms)
  print("[main path] step ms by budget " + ", ".join(
      f"{b}: n={len(v)} p50={statistics.median(v):.2f}"
      for b, v in sorted(by_budget.items())))
  _require_launches("main path", launches,
                    ("flash_prefill", "segment_build",
                     "fused_synopsis_score_attention",
                     "block_gather_attention"))
  _check_run(out, cfg)
  check_full_budget(out["cache"], dev, g)
  busy_ms = {budget: profile_decode(cfg, params, out["cache"], dev, budget)
             for budget in (0, cfg.synopsis.i_max)}
  del out
  _mark("the main path")

  # Decode baselines: every step at the full budget, so the work per step
  # does not follow the host clock as the controller's budgets do;
  # unquantized, then the quantized arena under int8+kv and fp8+kv, in the
  # same call so that they compare.
  fixed, _ = run_fixed_budget(cfg, params, dev)
  del fixed
  quant_launches = {}
  for quant in ("int8+kv", "fp8+kv"):
    qout, quant_launches[quant] = run_fixed_budget(cfg, params, dev, quant)
    _require_quant_launches(f"decode baseline quant={quant}",
                            quant_launches[quant], quant)
    profile_decode(serve.apply_quant(cfg, quant), params, qout["cache"], dev,
                   cfg.synopsis.i_max)
    del qout

  # Exact baseline: every step attends over the whole prompt cache and its
  # own token (64 flash_decode launches a step), in the same call as the
  # budget-32 baselines above, so the two compare.
  torch.cuda.empty_cache()
  _build.reset_launches()
  exact = serve.run(cfg, batch=BATCH, prompt_len=PROMPT, tokens=STEPS,
                    mode="exact", device=dev, params=params,
                    log=lambda _: None)
  exact_launches = _build.launch_counts()
  _check_run(exact, cfg, absorbs=0)
  print(f"[exact baseline] decode_ms {_step_stats(exact['step_ms'])} "
        f"prefill_ms={exact['prefill_ms']:.1f}")
  _require_launches("exact baseline", exact_launches,
                    ("flash_prefill", "flash_decode"))
  want = {"flash_prefill": cfg.n_layers,
          "flash_decode": 2 * cfg.n_layers * STEPS}
  if any(exact_launches[k] != n for k, n in want.items()):
    raise AssertionError(f"exact loop launches {exact_launches}, expected "
                         f"{want}")
  cache = exact["cache"]                # the prompt's KV: nothing appended
  del exact
  profile_decode(cfg, params, cache, dev, 0, mode="exact")

  _mark("the decode baselines and the exact loop")
  syn = skv.build(cache, cfg)
  check_accuracy_vs_exact(cfg, params, cache, syn, dev)
  check_full_budget_quant(cache, syn, "none", dev, g)
  # The quantized arena on the same prompt cache, per spec: the build under
  # each spec, accuracy against exact, and the full-budget deviation.  The
  # builds are the full-width path of the int8 / fp8 (synopsis-only) build
  # branches.
  for quant in QSPECS:
    qcfg = serve.apply_quant(cfg, quant)
    _build.reset_launches()
    qsyn = skv.build(cache, qcfg)
    torch.cuda.synchronize()
    quant_launches.setdefault(quant, _build.launch_counts())
    check_accuracy_vs_exact(qcfg, params, cache, qsyn, dev,
                            budgets=(0, 8, 32, 64))
    check_full_budget_quant(cache, qsyn, quant, dev, g)
    del qsyn
  del cache
  unfused_launches = compare_fused_unfused(syn, dev, g)
  _require_launches("unfused op", unfused_launches,
                    ("synopsis_score", "flash_decode",
                     "block_gather_attention"))
  del syn
  stage1_bytes_against_time(dev, g)
  _mark("accuracy against exact, fused against unfused, stage-1 bytes")

  # The dry run's per-rank program against the card, on these weights.
  run_dryrun_decode(cfg, params, dev, busy_ms[cfg.synopsis.i_max], smi)

  # The continuous-batching engine: its decode steps are graph replays.
  check_engine_parity(dev)
  engine_launches, deadline_replay = run_engine(cfg, params, dev)
  engine_kernels = ("flash_prefill", "segment_build",
                    "fused_synopsis_score_attention",
                    "block_gather_attention")
  _require_launches("engine", engine_launches, engine_kernels,
                    absent=("flash_decode", "synopsis_score"))
  _mark("the dry run's decode half and the engine")

  # The rest of the single-device engine, and the loop's pipelining.
  t_new = time.perf_counter()
  _require_launches("engine contract", run_engine_contract(
      cfg, params, dev, deadline_replay), engine_kernels,
                    absent=("flash_decode", "synopsis_score"))
  _require_launches("engine admission", run_engine_admission(
      cfg, params, dev), engine_kernels,
                    absent=("flash_decode", "synopsis_score"))
  run_engine_cache(cfg, params, dev, g)
  _require_launches("pipeline", run_pipeline(cfg, params, dev),
                    ("flash_prefill", "segment_build"))
  print(f"[phase 11] contracts, admission, cache, pipeline in "
        f"{time.perf_counter() - t_new:.1f}s")

  # The scatter-gather cluster tier on the same weights, then its fleet
  # tier.
  cluster_records, cluster_launches = run_cluster(cfg, params, dev, g)
  records.update(cluster_records)
  fleet_records, fleet_launches = run_fleet(cfg, params, dev, g)
  records.update(fleet_records)

  # The other architectures at full width: each its own weights, so
  # llama3-8b's go first, and each model's before the next one's.
  del params
  _free()
  model_launches = {}
  for arch in MODELS:
    arch_records, arch_launches = run_model(arch, dev, g)
    records.update(arch_records)
    model_launches.update(arch_launches)

  # The Morton build of a KV cache (the generic-data services, training
  # and mamba2 ran beside the build).
  morton_record, morton_launches = check_segment_build_morton(dev, g)
  records[morton_record["name"]] = morton_record

  # The sharded path: ranks sharing the card, each on its shard.
  mesh_records, mesh_launches = run_mesh(dev, smi)
  records.update(mesh_records)

  # Each kernel branch's launches on the path that runs it: the synopsis
  # loop's four, the exact loop's flash_decode, the unfused op's
  # synopsis_score; the quantized branches on the int8+kv / fp8+kv loops,
  # and the synopsis-only builds on their full-width builds.
  path_launches = {k: launches[k] for k in (
      "flash_prefill", "segment_build", "fused_synopsis_score_attention",
      "block_gather_attention")}
  path_launches.update(flash_decode=exact_launches["flash_decode"],
                       synopsis_score=unfused_launches["synopsis_score"])
  for quant, counts in quant_launches.items():
    for key in _quant_branches(quant)[0]:
      if key in _build.KERNELS:            # unquantized: the runs above
        continue
      path_launches[key] = max(path_launches.get(key, 0), counts[key])
  path_launches.update(model_launches)
  path_launches.update(cluster_launches)
  path_launches.update(fleet_launches)
  path_launches.update(mesh_launches)
  path_launches[morton_record["name"]] = morton_launches
  missing = sorted(set(records) ^ set(path_launches))
  idle = [k for k, n in path_launches.items() if n == 0]
  if missing or idle:
    raise AssertionError(f"kernel branches without a path {missing} or not "
                         f"launched on it {idle}")
  for key, n in path_launches.items():
    records[key]["launches"] = n
  smoke = {q: {k: n for k, n in c.items() if n}
           for q, c in smoke_launches.items()}
  print(f"[smoke launches] {smoke}")
  keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
          "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
  print(json.dumps({"kernels": [{k: records[n][k] for k in keys}
                                for n in path_launches]}))
  print(f"[total] chip_smoke.py ran {time.perf_counter() - T_START:.1f}s")
  print(smi)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
