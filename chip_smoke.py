#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, ``sm_90a``).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, any failure of which exits non-zero:

1. build every CUDA source of ``src/repro_torch/kernels/csrc`` (in parallel,
   into ``build/repro_torch/``) and print the build time;
2. hold each ResNet kernel against its plain PyTorch version: at the inputs
   the RESNET18 forward gives it (batch 32, captured from one forward on the
   card), and at edge cases (ragged tiles, int32 wrap, negative pool sums,
   float32).  The plain versions run on a CPU copy, since PyTorch has no
   int32 matrix product on CUDA.  Integers must match bit for bit;
3. the main paths, each driven through the entry points a user calls, with
   every launch counter reset just before it and read just after:

   a. RESNET18 at full width, batch 32, random weights from seed 0, eager:
      logits bit-equal to the plain CPU forward, launches equal to what
      ``layer_names`` implies (GEMM 21, relu 17, add 8, pool-sum 1);
   b. the same network through the Program API (``api.trace`` → ``Program``
      → cached ``Executor``): logits bit-equal to (a), the same launches, a
      compile-cache hit on the second call;
   c. the paper's bit-sliced GEMM at its Table III shape (x 61440 × 2048,
      w 2048 × 32) through ``api.quantized_matmul`` under the ``int4``,
      ``int8``, ``int16`` and ``w8a16`` presets, and through
      ``SlicedTensor.from_int`` → ``api.matmul`` with an all-zero activation
      slice whose pairs must never be launched;
   d. ``quant_linear_relu`` (a traced matmul → relu Program) at Qwen2-0.5B's
      MLP width, 4096 tokens × 896 → 4864, under ``w8a16``;
   e. serving: ``decode_program`` at Qwen2-0.5B's attention width (head_dim
      64, int8 K/V caches of capacity 32768), compiled once per request with
      ``api.compile`` (1 miss, 3 hits), answering 4 requests prefilled to
      1024, 4096, 16384 and 32760 rows, 8 tokens each; the caches carried
      from step to step by ``api.kv_append``.  Launches per step, exact:
      ``kv_append`` 2 + 2, ``attention_qk``, ``softmax_fixedpoint`` and
      ``attention_pv`` 1 each; every step's softmax non-degenerate;
   f. ``decode_layer_program`` at Qwen2-0.5B's width (model 896, head 64,
      FFN 4864) on a full 32768-row cache, and again at capacity 4096:
      launches qk, softmax, pv 1 each, GEMM 3, relu 1.

   g. the entry points whose kernels no model path reaches, each eagerly
      and through ``api.trace`` → ``api.compile`` → a held ``Executor``
      (one launch each, exact): ``api.decode_gemv`` at Qwen2-0.5B's
      single-token projections (int8 weights (896, 896), (128, 896),
      (4864, 896), (896, 4864) and the tied (151936, 896) LM head) and at
      kernels_bench's (512, 512) int32; ``api.rglru_scan`` at
      RecurrentGemma-2B's width, (4, 2048, 2560); ``api.htree_reduce`` at
      (256, 65536) in float32, bfloat16 and int32 and at (256, 2048)
      float32; ``api.maxpool2d`` at this ResNet's stem (``pool_max``, which
      RESNET18 does not run).  The RG-LRU output also within 1e-4 of the
      associative-scan oracle.
   h. the eager pimsab backend (``api.use_backend("pimsab")``: the PIMSAB
      compiler and bit-serial simulator, numpy on the host) with operands
      on the card: each of the 15 registry kernels at the inputs of
      ``tests/test_pimsab_conformance.py`` (its result on the card, no
      launch counted, integers bit-equal to the card kernel on the same
      operands, floats within the conformance tolerance); the three
      ``large_shapes`` workloads modeled on the full PIMSAB machine, their
      modeled, serialized and overlapped cycles and instruction counts
      equal to ``BENCH_kernels.json``; the paper-scale int_matmul
      (256×1024×1024, seeds 50 and 51) run bit-exactly on
      ``FUNCTIONAL_CFG_LARGE`` and bit-equal to K1, with its host wall time;
      the eager MICRO residual network bit-equal to its forward on the
      card; a pimsab call during a CUDA graph capture refused.  It prints
      each kernel's modeled cycles and host seconds.
   i. the pimsab Program lowering (``api.compile(prog, "pimsab")`` and
      ``api.trace`` under the scope: one fused WorkloadGraph run on the
      host's simulator) with operands on the card, no launch counted, each
      step's host seconds printed: the ``matmul → ewise_add → relu`` chain
      of ``benchmarks/kernels_bench.py`` (seed 0, tuning budget 96) with its
      output on the card, bit-equal to the card Executor's graph replay of
      the same Program, its report equal to ``BENCH_kernels.json``'s
      ``program`` row, the second compile a cache hit; the traced TINY
      ResNet under ``benchmarks/e2e_resnet.py``'s tuning (budget 256, params
      from seed 0, input from seed 1), its logits bit-equal to the card
      Executor's graph replay (K1, K2, K3 and K5), its report equal to
      ``e2e.tiny``; RESNET18 through ``timing_program_report``, tuned, equal
      to ``e2e.resnet18``; ``decode_program(AttnServeConfig(), 4)`` with its
      caches bound as ``ResidentState`` (``states=``), three steps bit-equal
      to the card Executor's (K6, K7, K8, K10) and the handles equal to the
      card's caches carried by ``api.kv_append``, its ``state:`` edges
      present; a pimsab Executor called during a CUDA graph capture refused.
   j. the LLM serving path, ``repro_torch.launch.serve``'s main path at
      Qwen2-0.5B's full width and depth (24 layers, random bfloat16 weights
      from seed 0 served as int8): the launcher's 4 requests of 8 tokens, 16
      new tokens each, at max_len 128 (a second engine of the same
      signature a compile-cache hit); one 512-token prompt at max_len 1024
      (the chunked prefill); the 4 requests again with ``quant_kv``.
      Launches exact: the bit-sliced GEMM 7 a layer (168) in each prefill
      and decode step, the row dot once a layer for each group of batch
      rows ``attention.int8_scores_rows_per_call`` gives (at batch 4 one
      group: 24) in each ``quant_kv`` decode step, nothing else; logits
      finite; each K4 and K6 call shape of the runs bit-equal to its plain
      version (K4 on the tensor cores); then at full width and 2 layers,
      the card against CPU copies of the same weights (quantized weights
      bit-equal; bfloat16 with and without ``quant_kv`` and float32 within
      2**-7 of the largest CPU logit, greedy tokens equal where the top-2
      margin exceeds twice that, the positions so covered counted),
      with the tied LM head's gap under PyTorch's bfloat16 reduced-precision
      reductions and without them.
   l. the other model families (after the scheduler's phase 3k): the same
      launcher path at RecurrentGemma-2B's full width and depth (26 layers:
      18 RG-LRU, 8 local attention; 2.9 B random bfloat16 parameters from
      seed 0 served as int8) over the same three runs, launches exact: the
      bit-sliced GEMM 200 a prefill or decode step (8 an RG-LRU layer, 7 a
      local-attention layer; the tied head is a float product), the RG-LRU
      scan 18 a prefill (one an RG-LRU layer) and none in a decode step, the
      row dot 8 a ``quant_kv`` decode step; each K4 and K6 shape bit-equal to
      its plain version and every RG-LRU scan call within 1e-4 of its plain
      version at the call's inputs; ``loss_fn`` finite; the card against CPU
      copies of one pattern group (13 layers).  Then xLSTM-1.3B and
      Whisper-medium (1500 frames) at full depth and DBRX-132B at 2 layers:
      one launcher run each with exact K4 counts a run, a prefill and a
      step, every K4 shape held, ``loss_fn`` finite (the MoE aux above 0),
      the card against CPU copies of the first pattern groups.  Prints the
      phase's seconds.
   m. training (after 3l): ``repro_torch.train.trainer.train`` at
      RecurrentGemma-2B's full width and depth (26 layers, 2.894 B bfloat16
      parameters from seed 0, float32 moments and master weights) at the JAX
      launcher's batch 8 × 64 and run flags (``attn_chunk`` 64,
      ``flash_threshold`` 256, per-block remat), TRAIN_STEPS steps, every
      loss finite; launches exact: the RG-LRU scan 36 a step (18 RG-LRU
      layers and their remat recompute) and its gradient kernel 18; every
      K11 forward and gradient call of step TRAIN_RECORD_STEP bit-equal to
      its plain version; prints the step ms (median after the first),
      tokens/s, peak memory and launches a step.  Then the card against its
      CPU copy at one pattern group (3 layers, full width: loss and
      gradients), every arch of ``list_archs()`` at ``reduced_config`` one
      train step on the card against its CPU copy, the bit-exact resume (8
      steps straight against 4, a restore and 4 more, deterministic
      algorithms, in a process of its own: ``chip_smoke.py
      --train-resume``) and the CLI (``python -m repro_torch.launch.train
      --arch recurrentgemma-2b --reduced --steps 4``, exit 0).  The
      per-leaf sha256 digests of the state after step DIST_STEPS are held
      to 3n's (their time is taken out of the step times).
   n. sharding rules and mesh collectives, run first (after phase 1, while
      this process holds next to nothing on the card) in a process of its
      own (``chip_smoke.py --dist-phase``) with an NCCL process group of one
      rank (``tcp://localhost``), destroyed once the card is idle: the
      ("data", "model") = (1, 1) host mesh and its ``MeshRules``; the four
      collectives through NCCL, each bit-equal to its CPU copy, their
      ``torch.distributed`` calls printed; ``trainer.train`` at
      RecurrentGemma-2B's full width and depth under the rules with ZeRO-1,
      3m's batch, seed and schedule, DIST_STEPS steps, K11 launches exact,
      its calls a step printed; the compressed mean of the tied embedding's
      float32 gradient (655 M entries) bit-equal to its CPU copy; Qwen2-0.5B's
      4 × 8 prefill and one decode step through ``make_prefill_step`` and
      ``make_decode_step`` with the rules, K4 launches exact; the memory
      model's state bytes equal to the live train state's and its params
      bytes to the served parameters', its analytic peak beside
      ``max_memory_allocated``.  Phase 3j holds its 4 × 8 logits, and 3m its
      state after step DIST_STEPS (per-leaf sha256), bit-equal to these.
   o. tensor-parallel execution, run after 3n in TP_RANKS processes of their
      own (``chip_smoke.py --tp-phase RANK PORT``) on the one card, a gloo
      group whose collectives stage through host memory
      (``make_host_mesh(2, host_collectives=True)``; NCCL refuses two ranks
      on one device, and every kernel launch stays on the card): the mesh
      (1, 2) and its ``MeshRules``; Qwen2-0.5B and RecurrentGemma-2B at full
      width and depth and DBRX-132B at full width, 1 layer, each rank on its
      ``shard_params`` slices, 3j's 4 × 8 prefill and decode step with and
      without quant_kv through ``make_prefill_step`` / ``make_decode_step``
      under the rules, K4, K6 and K11 launches exact, held bit-equal to rank
      0's 1-rank run of the same steps (the gap printed), whose 4 × 8 logits
      3j holds bit-equal to its own; every K4
      and K6 shape's first call and every K11 call held to its plain
      version on each rank; RecurrentGemma-2B trained at full width and
      TP_TRAIN_LAYERS layers through ``trainer.train`` under the rules, K11
      launches exact and step TRAIN_RECORD_STEP's held, its state gathered
      leaf by leaf and held to rank 0's 1-rank run (TP_TRAIN_TOL), one more
      step profiled (torch.profiler: device busy time, host-device copies,
      host time inside torch.distributed's ops); each rank's live parameter
      and state bytes equal to the memory model's.  Each serving step's
      collective records (``collectives.collective_records``) go to 3p.
   p. the dry run (after 3m; ``repro_torch.launch.dryrun``: a step run on
      ``meta`` tensors as one rank of a fake process group, touching no
      device) held to the live runs: 3j's 4 x 8 prefill and its decode step
      at batch 4, and 3m's 8 x 64 training step, each predicted at mesh
      (1, 1) and run once on the card from ``dryrun.live_step_args`` (random
      weights from SEED), its kernel launches and argument and output bytes
      equal to the prediction's; the prediction's peak (``MemTracker`` on
      ``meta``) printed beside ``max_memory_allocated`` and its roofline
      max(compute, memory) beside the step's time (DRYRUN_TIMED_STEPS calls,
      host clock); the (1, TP_RANKS) dry run of 3o's serving steps on each
      rank, its ``collective_stats`` (counts and operand bytes by op) equal
      to 3o's live records; and DRYRUN_CLI_CELLS, one production cell of
      each kind, through ``python -m repro_torch.launch.dryrun`` at
      pod16x16 (exit 0, an ok record).

   Each of (c)–(g) runs again on CPU copies of its inputs (the plain
   versions); the bit-sliced kernel's output must equal its plain version's
   on the same slices, and the path's output the CPU path's, bit for bit.
   Every Executor that (b) and (d)–(g) call on the card must take the graph
   route at every call (its first call runs the ops eagerly, then captures
   them into a CUDA graph; later calls replay it); one more replay of each
   launches exactly the path's kernels and is bit-equal to the same
   Executor's eager replay and to the CPU path.  The card's peak memory is
   printed after (g).
   Phase 2 also holds the four attention kernels against their plain
   versions at the decode shapes (GQA groups of 7 included) and at edges
   (a 131072-long equal row, shift 40, int32 caches, multi-hot and all-zero
   selectors), the KV append at the edges of its launch plan (selected rows
   at the first and last rows of blocks, every row selected, a ragged T,
   D 16 and 48, an int32 selector; a cache off 16 bytes on the generic
   kernel), the softmax and p·V at the edges of their launch plans (each
   call held to the path its case names: the rows kernel at T = 1 to 512 and
   64 rows of T = 8; the cluster's registers at T = 513 to 65536, ragged T
   and views off 16 bytes with element loads; its loop past the registers
   and at 2**20; int8 scores; the packed p·V at M = 1, 2, 9, T = 1, T below a
   warp's rows, ragged T, Dv 16 to 256, int32 wrap at shifts 0, 31, 40; the
   generic one at Dv 48 and 300, int32 v, int8 p, a v one byte off), the p·V
   ticket (two shapes back to back, three CUDA-graph replays) and one device
   kernel a p·V call (profiler), decode_gemv, htree_reduce and rglru_scan at theirs (an
   int32 wrap, a ragged K, misaligned int8 views, N = 1 and 2 in each
   dtype; for the scan and its gradient kernel T = 1, T one short of and one past a stage, T = 8192,
   W = 1, 3 and 4, ragged last groups, B · W below a group, a and b off 16
   bytes on 4-byte copies, ±0 and subnormal operands, each call held to the
   copies its plan names), the row dot of q·Kᵀ and decode_gemv at the edges
   of its plan (every lanes from 1 to 32 at one and 9 queries, rows split
   over 2, 4 and 8 warps, row counts off a warp's rows, M = 1 to 9, queries
   streamed past the registers, the grid-stride loop, int32 wrap, (512, 512)
   int32, views one byte off on the generic kernels; each call held to the
   path its plan names, one device kernel a call), and the row reduction and the elementwise
   kernels at the edges of their launch plans (every lane-group size,
   misaligned views, INT32_MIN and NaN rows, n from 1 to 255, channels-last
   operands whose layout the result keeps), and the int32 GEMM and H-tree at
   theirs (INT32_MIN, -1, INT32_MAX and full-range operands on both sides,
   tiles whose byte counts differ, K = 40000, M = 1 to 17 around the small-M
   path, the stem's K = 27, ragged shapes, B as (K, N) and (N, K), misaligned
   views; N = 1 to 65536 lanes, D off the 16-byte pack, INT32_MIN columns
   that wrap, float32 and bfloat16 in tree order), the bit-sliced GEMM's
   two paths at theirs (each tensor-core tile at ragged M, N and K, 4-byte
   w copies, the zero-skip pair set, K = 2**17 + 32 of all -128 stacks,
   which the block must fold; __dp4a at K % 16 != 0, N % 4 != 0, 3 of 4
   pairs and stacks off 16 bytes; each call must take the path its case
   names), and K1 float32 at ragged shapes in both B layouts, on split and
   unsplit plans (normals within 1e-4, integer values exact, the same bits
   in two calls), the bit-sliced GEMM at the LLM path's linears (phase 3j's
   and 3l's (K, N) pairs at M = 1, 4, 32 and 512, the untied heads of
   xLSTM, Whisper and DBRX at M = 1 and 4, on the tensor cores); and the
   Executor's graph replay on the decode step at
   1024 rows: leaves that are views off 16 bytes (generic kernels eagerly,
   vector kernels in the graph, bit-equal), an output kept unchanged across
   the next call, a call inside an outer CUDA graph (the eager route) and two
   threads on their own streams sharing one Executor;
4. time each kernel at those inputs (CUDA events around a CUDA-graph replay
   of 20 calls, after warm-up; eager back-to-back calls too) beside its
   bound, its plain version and, where one PyTorch call computes the same
   function, that call (``torch._int_mm`` for a single-pair bit-sliced
   GEMM, in paired rounds; transposed, ``torch._int_mm(w, x8)`` with the
   query or activation in column 0 of a (K, 8) int8 matrix, beside q·Kᵀ at
   the serving call and the int8 decode GEMVs, in paired rounds); the bit-sliced GEMM's path (every phase 3c/3d
   call must take the tensor cores) and, for quant_linear_relu, whose
   inputs fit in L2, a reading with them cold; the int32 GEMM's bound counts the int8 tensor-core digit products
   its inputs need (``digit_products``), with the SIMT design's IMAD bound
   beside it; K1 in the decode layer (M = 1) and K1's float32 instance beside
   ``torch.matmul`` (TF32 off, paired rounds) at RESNET18's stage-3 shape;
   time 50 eager forwards one by one (median and p80), and the
   eager forward, the traced call (re-trace included), a held
   ``Executor``'s graph replay and the same Executor's eager replay from an
   idle card (host clock), with the device time of the replay's copy-in;
   time the attention kernels at the serving path's T = 32768 inputs (warm
   and cold) beside the launch floor (one ``x.add_(1)`` on a one-element
   tensor in graph replay), one decode step (Program call plus the cache carry) at 4096 and 32768 rows
   and the decode layer, each from an idle card (median of 20), by graph
   replay and by the same Executor's eager replay, with the copy-in's
   device time, and phase 3g's held Executors the same two ways; time
   decode_gemv, rglru_scan and htree_reduce at phase 3g's inputs, beside
   their bounds, plain versions and, for the int32 H-tree, ``torch.sum`` in
   paired rounds, warm and cold (the scan and the other H-trees cold once);
   the pool and elementwise kernels beside their library calls in paired
   rounds (each read once a round, in alternating order; medians), warm and
   with cold inputs (rotated over copies worth more than twice the L2);
   phase 3j's prefills (4 × 8, 1 × 512), decode steps (batch 4 with and
   without ``quant_kv``, batch 1 on 1024 rows) and a whole engine run, host
   clock from an idle card; each K4 and K6 shape of 3j beside its bound,
   its plain version (CPU) and ``torch._int_mm`` where it takes the shape;
   the same for 3l's RecurrentGemma-2B, and the RG-LRU scan at its path's
   shapes (4 × 8 × 2560, 1 × 512 × 2560) beside its bound and plain version;
   the scan and its gradient kernel at 3m's 8 × 64 × 2560 the same way;
5. profile (torch.profiler) three eager forwards and one call of each
   Table III bit-sliced path: device time by kernel name and the device's
   idle share, and the eager forward's PyTorch copies (``aten::copy_``) and
   other glue kernels, launches and device time; then, in a process of its
   own (``chip_smoke.py --replay-profiles``), the graph replays of the held
   Executors at the same shapes: three of RESNET18, five decode steps,
   three decode layers, one ``quant_linear_relu`` call and three calls of
   each phase 3g Executor; and three eager LLM decode steps of 3j at batch
   4, with and without ``quant_kv``, and of 3l's RecurrentGemma-2B without:
   K4's and K6's device time and share, and the device's idle share.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Per-call details go
to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import faulthandler
import itertools
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BATCH = 32
SEED = 0
# Peak rates of one H100 SXM (NVIDIA data sheet, 700 W): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores.  int32 multiply-adds run on IMAD at
# 64 per clock per SM; that rate is computed from the card's own clock.
MEM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core rate; a multiply-add is 2 ops
IMAD_PER_CLOCK_PER_SM = 64
FLOAT_ATOL = FLOAT_RTOL = 1e-4  # the JAX package's float kernel tolerance
# forwards timed one by one: the p80 then has 10 samples beyond it
FORWARD_SAMPLES = 50
# latency samples of the Program API and of each bit-sliced path
LATENCY_SAMPLES = 20

# The paper's Table III GEMM (benchmarks/workloads.py:gemm, fig09_gpu.py).
TABLE3 = (61440, 2048, 32)  # (M, K, N)
GEMM_PRESETS = ("int4", "int8", "int16", "w8a16")
# quant_linear_relu: 4096 tokens through Qwen2-0.5B's MLP up-projection
# (src/repro/configs/qwen2_0_5b.py: d_model 896 → d_ff 4864).
QLR = (4096, 896, 4864)

# The attention decode slice at Qwen2-0.5B's width (src/repro/configs/
# qwen2_0_5b.py): head_dim 64 (14 query heads, 2 KV heads: a GQA group of
# 7), d_model 896, d_ff 4864, a 32768-token context.  score_frac 13 keeps the
# fixed-point softmax of int8 scores non-degenerate.
DECODE_CFG = dict(head_dim=64, value_dim=64, kv_bits=8, q_bits=8, score_bits=22, score_frac=13)
DECODE_CAPACITY = 32768
DECODE_PREFILL = (1024, 4096, 16384, 32760)  # rows already in each request's cache
DECODE_STEPS = 8
GQA = 7
LAYER_DIMS = (896, 64, 4864)  # model_dim, head_dim, ff_dim
STEP_LAUNCHES = {"kv_append": 4, "attention_qk": 1, "softmax_fixedpoint": 1, "attention_pv": 1}
# the decode step's Program alone (without the two carry appends)
PROGRAM_STEP_LAUNCHES = {"kv_append": 2, "attention_qk": 1, "softmax_fixedpoint": 1, "attention_pv": 1}
# phase 2's Executor routes: the decode step at this many rows, and calls per thread
ROUTE_CAPACITY = 1024
ROUTE_THREAD_CALLS = 10
LAYER_LAUNCHES = {"attention_qk": 1, "softmax_fixedpoint": 1, "attention_pv": 1, "gemm": 3, "relu": 1}
ATTN_SOURCE = "src/repro_torch/kernels/csrc/attention.cu"
ATTN_REPLACES = {
    "attention_qk": "src/repro/kernels/attention.py:48",
    "softmax_fixedpoint": "src/repro/kernels/attention.py:88",
    "attention_pv": "src/repro/kernels/attention.py:145",
    "kv_append": "src/repro/kernels/attention.py:218",
}
# why no single PyTorch call computes the same function
ATTN_NO_LIBRARY = {
    "softmax_fixedpoint": "no fixed-point softmax in PyTorch",
    "attention_pv": "no int32 matrix product on CUDA (torch._int_mm needs int8 p and M > 16)",
}

# The entry points whose kernels no model of the JAX package reaches, each at
# a size its users run.  decode_gemv: Qwen2-0.5B's single-token projections
# (src/repro/configs/qwen2_0_5b.py: d_model 896, 14 query and 2 KV heads of
# 64, d_ff 4864, the tied 151936-row embedding as LM head), int8 weights in
# (out, in) layout, and benchmarks/kernels_bench.py's (512, 512) in int32.
GEMV_SHAPES = {
    "q_o_proj": (896, 896), "k_v_proj": (128, 896), "gate_up_proj": (4864, 896),
    "down_proj": (896, 4864), "lm_head": (151936, 896),
}
GEMV_BENCH = (512, 512)
# rglru_scan: RecurrentGemma-2B's RG-LRU width (src/repro/configs/
# recurrentgemma_2b.py: d_model 2560) over one 2048-token local-attention
# window of prefill, batch 4; a = sigmoid(normal), b and h0 normal.
RGLRU_SHAPE = (4, 2048, 2560)
# htree_reduce: PimsabConfig's 256 CRAM lanes (crams_per_tile) × 65536
# columns (pes_per_tile), and kernels_bench's (256, 2048) float32.
HTREE_SHAPE = (256, 65536)
HTREE_BENCH = (256, 2048)
ENTRY_SOURCES = {
    "decode_gemv": ATTN_SOURCE,
    "rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "htree_reduce": "src/repro_torch/kernels/csrc/htree_reduce.cu",
}
ENTRY_REPLACES = {
    "decode_gemv": "src/repro/kernels/attention.py:182",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:25",
    "htree_reduce": "src/repro/kernels/htree_reduce.py:25",
}
ENTRY_NO_LIBRARY = {
    "decode_gemv": "int32 operands: no int32 matrix product on CUDA (torch._int_mm takes int8)",
    "rglru_scan": "no linear-recurrence scan in PyTorch",
    "htree_reduce": "torch.sum adds floats in another order",
}

# Phase 3h, the eager pimsab backend (src/repro_torch/kernels/pimsab_backend.py):
# the float tolerances of tests/test_pimsab_conformance.py (the fixed-point
# lowerings against float kernels), the paper-scale int_matmul of its slow
# tier (x (256, 1024) and w (1024, 1024) int8-range, seeds 50 and 51), the
# MICRO residual network of tests/test_resnet_e2e.py, and the tuning budget
# under which benchmarks/kernels_bench.py models its large_shapes rows.
PIMSAB_TOL = {"htree_reduce": 5e-3, "rglru_scan": 5e-2}
PIMSAB_MATMUL = ((256, 1024), (1024, 1024), 50, 51)
PIMSAB_MICRO = dict(in_channels=2, input_hw=8, stem_channels=4, stem_pool="max",
                    stage_channels=(4,), blocks_per_stage=(1,), num_classes=5)
PIMSAB_TUNE = dict(budget=96, beam=4, seed=0)
# phase 3i: benchmarks/e2e_resnet.py's DEFAULT_TUNE for the e2e rows, and the
# resident-state decode step of tests/test_serve_pimsab.py (capacity 4, the
# default AttnServeConfig) over this many steps
E2E_TUNE = dict(budget=256, beam=4, seed=0)
PIMSAB_STATE_CAPACITY = 4
PIMSAB_STATE_STEPS = 3

# Phase 3j, the LLM serving path: repro_torch.launch.serve's main path at
# Qwen2-0.5B's full width and depth (src/repro/configs/qwen2_0_5b.py: 24
# layers, d_model 896, 14 query and 2 KV heads of 64, d_ff 4864, the tied
# 151936-token vocabulary padded to 153600), random bfloat16 weights from
# seed 0 served as int8: the launcher's 4 requests of 8 tokens, 16 new tokens
# each, at max_len 128; one 512-token prompt at max_len 1024 (longer than
# the launcher's flash_threshold of 256: the chunked prefill); the 4
# requests again with quant_kv.  Every quantized linear launches the
# bit-sliced GEMM (wq, wk, wv, wo, w_gate, w_up, w_down: the (K, N) pairs of
# LLM_KN); under quant_kv the int8 scores launch the row dot once a layer
# for each group of batch rows (attention.int8_scores_rows_per_call).
LLM_ARCH = "qwen2-0.5b"
LLM_REQUESTS = 4
LLM_NEW_TOKENS = 16
LLM_LONG = (512, 1024)  # (prompt tokens, max_len)
LLM_K4_PER_LAYER = 7
LLM_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896))
# card against CPU copies: full width at this depth, a prefill and this many
# decode steps; tolerances relative to the largest CPU logit, set from this
# comparison's own readings (both sides run the port's code and the kernels
# are bit-exact; the largest gaps read were 0.0078 in bfloat16, one ulp of a
# logit below 2, and 0.0114 in float32, an int8 activation one rounding step
# apart, against a largest logit of about 9: 2**-7 of it is 0.07)
LLM_CPU_LAYERS = 2
LLM_CPU_STEPS = 3
LLM_TOL = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -7}
LLM_TIMING_SAMPLES = 20
LLM_PROFILE_STEPS = 3

# Phase 3l, the families beyond decoder-only attention at full width.
# RecurrentGemma-2B's full width and depth (src/repro/configs/
# recurrentgemma_2b.py: 26 layers, 18 RG-LRU and 8 local-attention blocks,
# d_model 2560, 10 query heads and 1 KV head of 256, d_ff 7680, window 2048,
# the tied 256000-token vocabulary), random bfloat16 weights from seed 0
# served as int8, driven as 3j drives Qwen2-0.5B: every RG-LRU prefill runs
# the RG-LRU scan (K11) at (B, S, 2560) float32, every quantized linear K4
# (the (K, N) pairs of FAM_KN), the local attention's int8 scores under
# quant_kv K6 at head_dim 256.  Then xLSTM-1.3B (48 layers) and
# Whisper-medium (24 + 24 layers, 1500 frames) at full depth and DBRX-132B
# at 2 layers (132 B parameters do not fit one 80 GB card even as int8): one
# launcher run each.  Each family against CPU copies of its first
# FAM_CPU_GROUPS pattern groups (Whisper: and 2 encoder layers).
FAM_ARCH = "recurrentgemma-2b"
FAM_KN = ((2560, 2560), (2560, 256), (2560, 7680), (7680, 2560))
FAM_OTHERS = {"xlstm-1.3b": None, "whisper-medium": None, "dbrx-132b": 2}  # layers on the card (None: all)
FAM_CPU_GROUPS = {"recurrentgemma-2b": 1, "xlstm-1.3b": 1, "whisper-medium": 2, "dbrx-132b": 1}
FAM_CPU_ENC_LAYERS = 2
# card against CPU copies: tolerances relative to the largest CPU logit, set
# from readings (scripts/torch_family_gap_probe.py records every block output
# on both devices: the first differences are one float32 ulp of the card's
# exp, sigmoid, softplus and expm1 in the RG-LRU coefficients and the mLSTM
# chunk scan, and one bfloat16 ulp of the attention products over Whisper's
# 1500 keys; int8 re-quantization then moves a value a whole step where a
# rounding flips, and depth adds up).  Read at these depths by this
# comparison and by the probe (weights drawn for the cut config):
# RecurrentGemma 0.0101 and 0.0008 (13 layers), xLSTM 0.051 and 0.026 (8),
# Whisper 0.028 and 0.028 (2 + 2), DBRX 0.004 (1); each limit the least power
# of two at least twice the larger
FAM_TOL = {"recurrentgemma-2b": 2.0 ** -5, "xlstm-1.3b": 2.0 ** -3, "whisper-medium": 2.0 ** -4,
           "dbrx-132b": 2.0 ** -6}
# the other families' new (K, N) pairs, held at LLM_MS, and the untied heads
# (xLSTM, Whisper, DBRX: the vocabularies padded to 51200, 53248, 100352),
# held at M = 1 and LLM_REQUESTS: a head sees only each request's last token
FAM_KN_CHECKS = ((2048, 8192), (4096, 4096), (4096, 8), (4096, 2048), (2048, 5504), (2752, 2048),
                 (1024, 1024), (1024, 4096), (4096, 1024), (6144, 6144), (6144, 1024))
FAM_HEADS = ((2048, 51200), (1024, 53248), (6144, 100352))
# bit-sliced GEMM launches of a block's mixer (its quantized linears)
K4_PER_MIXER = {"attn": 4, "local_attn": 4, "rglru": 5, "mlstm": 6, "slstm": 3}

# Phase 3m, the single-device training path: src/repro/launch/train.py's
# defaults (batch 8, seq 64, RunFlags(attn_chunk=64, flash_threshold=256),
# remat on) through trainer.train at RecurrentGemma-2B's full width and depth
# (26 layers, 2.894 B bfloat16 parameters from seed 0, float32 moments and
# master weights), TRAIN_STEPS steps, the K11 calls of step TRAIN_RECORD_STEP
# held; the card against its CPU copy at one TRAIN_CPU_PATTERN group (full
# width: 0.9 B parameters) on a TRAIN_CPU_SHAPE batch; every arch's
# reduced_config one step.
# Card-vs-CPU limits (loss and the largest gradient or first-moment gap,
# relative to the CPU's largest) set from readings.
TRAIN_ARCH = "recurrentgemma-2b"
TRAIN_BATCH, TRAIN_SEQ = 8, 64
TRAIN_STEPS = 5
TRAIN_RECORD_STEP = 2
TRAIN_CPU_PATTERN = ("rglru", "rglru", "local_attn")
TRAIN_CPU_SHAPE = (2, 16)
# (loss, gradients or first moments), each the least power of two at least
# twice the largest gap read on the card: at 3 layers 1.73e-5 and 0.0094 of
# the largest gradient (bfloat16 products summed in another order; at 13
# layers 1.43e-4 and 0.0198); reduced configs 1.7e-5 (Whisper) and 0.013
# (xLSTM's first moments)
TRAIN_TOL = {"full": (2.0 ** -14, 2.0 ** -5), "reduced": (2.0 ** -14, 2.0 ** -5)}
TRAIN_REPLACES = {
    "rglru_scan": "src/repro/kernels/rglru_scan.py:25",
    # no Pallas body: JAX differentiates its associative scan
    "rglru_scan_bwd": "src/repro/models/recurrent.py:97",
}
TRAIN_NO_LIBRARY = {
    "rglru_scan": "no linear-recurrence scan in PyTorch",
    "rglru_scan_bwd": "no linear-recurrence scan (nor its gradient) in PyTorch",
}

# Phase 3n, the sharding rules and mesh collectives on an NCCL process group
# of one rank (a process of its own, run first): phase 3m's training for
# DIST_STEPS steps under MeshRules with ZeRO-1, which 3m's state after the
# same step must equal; phase 3j's 4 x 8 prefill and decode step under the
# rules, which 3j's logits must equal.
DIST_STEPS = 3
DIST_TIMEOUT_S = 600

# Phase 3o, tensor-parallel execution: TP_RANKS ranks on the one card (a
# process each, run after 3n while the main process holds next to nothing on
# the card), their collectives over gloo staged through host memory
# (make_host_mesh(..., host_collectives=True): NCCL refuses two ranks on one
# device).  Serving: 3j's 4 x 8 prefill and decode step with and without
# quant_kv for each TP_SERVE config (layers on the card; None: all), held
# bit-equal to rank 0's 1-rank run of the same steps (every cross-rank
# combine of serving is an int32 sum, a max or a gather; the gap to the
# largest logit is printed).
# Training: RecurrentGemma-2B at full width, one pattern group
# (TP_TRAIN_LAYERS layers: two ranks and the 1-rank reference on one 80 GB
# card), TP_STEPS steps of 3m's batch, held to rank 0's 1-rank run: the
# first step's loss and the last step's first moments within TP_TRAIN_TOL
# (TRAIN_TOL's rule applied to the card-vs-CPU gaps read at 13 layers,
# 1.43e-4 and 0.0198).  These two are the checks that can catch a fault (a
# wrong or missing partial sum moves the first loss and the moments); the
# masters' gap is printed only: AdamW's first steps move each master by
# about lr whatever the gradient, so no limit on it could fail for a wrong
# one.
TP_RANKS = 2
TP_SERVE = {"qwen2-0.5b": None, "recurrentgemma-2b": None, "dbrx-132b": 1}
TP_TRAIN_LAYERS = 13
TP_STEPS = 3
TP_TRAIN_TOL = (2.0 ** -11, 2.0 ** -4)
TP_TIMEOUT_S = 700
TP_COLLECTIVE_TIMEOUT_S = 300

# Phase 3k, the continuous-batching scheduler and multi-chip scale-out on the
# host's simulator, held to BENCH_kernels.json's serve and scaling sections
# and to the card's kernels.  benchmarks/serve_bench.py's recipe (BATCH_SIZES,
# PROMPTS, MAX_NEW_TOKENS, DEFAULT_TUNE), kernels_bench.py's SCALING_CHIPS,
# and tests/test_multichip.py's meshes and workloads (name, shapes, seed,
# value range of the int8 operands).
SERVE_BATCH_SIZES = (1, 4, 16)
SERVE_PROMPTS = ([1, 2], [2, 3], [3, 1], [1, 3])
SERVE_MAX_NEW_TOKENS = 2
SERVE_TUNE = dict(budget=96, beam=4, seed=0)
SCALING_CHIPS = (1, 2, 4, 8)
CLUSTER_MESHES = ((1, 2), (2, 2), (2, 4))
CLUSTER_WORKLOADS = {
    "mc_matmul_chain": (((4, 16), (16, 16), (16, 8)), 11, (4, 4, 4)),
    "mc_conv_block": (((1, 8, 6, 6), (8, 8, 3, 3), (8, 8, 3, 3)), 12, (3, 3, 3)),
    "mc_attn_decode": (((1, 16), (8, 16), (8, 16)), 13, (3, 3, 3)),
    "decode_layer": (((8, 16), (8, 16), (1, 16), (16, 256), (256, 512), (512, 256)), 7, (3, 3, 3, 7, 7, 7)),
}
# the plans tests/test_multichip.py forces beside auto and tp
CLUSTER_PP = {"mc_matmul_chain": (1, 2), "mc_conv_block": (1, 2), "mc_attn_decode": (1, 2), "decode_layer": (2, 2)}

# K1's float32 instance beside torch.matmul (TF32 off) at RESNET18's stage-3
# GEMM shape in float32: (M, K, N).  No path runs it (the forward is int32).
F32_GEMM = (2048, 2304, 256)
# Window lengths that reach every lane-group size of the row reduction (1 to
# 32 lanes a row), each with a K % 4 == 0 neighbour (16-byte loads) and a
# ragged one (element loads).
POOL_EDGE_K = (1, 2, 3, 4, 5, 8, 15, 16, 17, 32, 33, 49, 100, 1000)
# A cold reading rotates a kernel's inputs over copies worth more than this,
# twice the H100's 50 MB L2, so each call reads its inputs from HBM.
COLD_BYTES = 100 * 2**20
# The pool and elementwise kernels beside their library calls: readings of
# each, in turns, per path run (their gaps are a few percent, about the
# spread of one reading)
PAIRED_ROUNDS = 7

BITSLICE_SOURCE = "src/repro_torch/kernels/csrc/bitslice_gemm.cu"
BITSLICE_REPLACES = "src/repro/kernels/bitslice_matmul.py:29"

SOURCES = {
    "gemm": "src/repro_torch/kernels/csrc/int_gemm.cu",
    "pool_sum": "src/repro_torch/kernels/csrc/pool_reduce.cu",
    "pool_max": "src/repro_torch/kernels/csrc/pool_reduce.cu",
    "ewise_add": "src/repro_torch/kernels/csrc/ewise.cu",
    "relu": "src/repro_torch/kernels/csrc/ewise.cu",
}
REPLACES = {
    "gemm": "src/repro/kernels/conv.py:49",
    "pool_sum": "src/repro/kernels/conv.py:88",
    "pool_max": "src/repro/kernels/conv.py:84",
    "ewise_add": "src/repro/kernels/ewise.py:25",
    "relu": "src/repro/kernels/ewise.py:29",
}
# registry kernel → the CUDA kernel it launches
LAUNCHED_BY = {
    "conv2d": "gemm", "int_matmul": "gemm", "relu": "relu", "ewise_add": "ewise_add",
    "global_avgpool": "pool_sum", "avgpool2d": "pool_sum", "maxpool2d": "pool_max",
}


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    r = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}", f"--format={fmt}"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.cases = []

    def check(self, kernel, case, got, want, exact, tol=None):
        """Compare a kernel's output (on the card) with its plain version's
        (on the CPU), float outputs within ``tol`` (default the float kernel
        tolerance); record the case, and a failure on disagreement."""
        torch = self.torch
        got = got.cpu()
        ok = got.shape == want.shape and got.dtype == want.dtype
        err = None
        if ok and got.is_floating_point() and (got.isnan().any() or want.isnan().any()):
            # NaN must sit where the plain version has it; the rest compares as usual
            ok = torch.equal(got.isnan(), want.isnan())
            got, want = got.nan_to_num(0.0), want.nan_to_num(0.0)
        if ok:
            diff = (got.double() - want.double()).abs()
            err = float(diff.max()) if diff.numel() else 0.0
            if exact:
                ok = torch.equal(got, want)
            else:
                atol = rtol = FLOAT_ATOL if tol is None else tol
                ok = bool((diff <= atol + rtol * want.double().abs()).all())
        self.cases.append({"kernel": kernel, "case": case, "ok": ok, "max_abs_err": err,
                           "exact": exact, "shape": list(got.shape), "dtype": str(got.dtype)})
        if not ok:
            self.failures.append(f"{kernel} [{case}]: disagrees with its plain version "
                                 f"(max_abs_err={err}, shape {tuple(got.shape)}/{tuple(want.shape)})")
        return err


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Mean time of ``fn`` in ms over ``reps`` back-to-back eager calls (CUDA
    events): the device time plus whatever launch gaps the host leaves."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_timer(torch, fn, reps=20, warmup=3):
    """Capture ``reps`` calls of ``fn`` in one CUDA graph (after warm-up and
    one warm replay); returns a function that replays it between CUDA events
    and gives the mean device time of a call in ms, host launch cost left
    out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def replay_ms():
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    replay_ms.fn = fn  # the graph reads the tensors fn holds: keep them alive while it can replay
    return replay_ms


def graph_ms(torch, fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms over one replay of ``reps`` calls
    captured in a CUDA graph."""
    return graph_timer(torch, fn, reps, warmup)()


def cold_timer(torch, fn, args):
    """A :func:`graph_timer` of ``fn(*args)`` with its inputs cold in L2: the
    calls of the graph rotate over clones of ``args`` (each keeping its
    layout) worth more than COLD_BYTES together."""
    nbytes = sum(a.element_size() * a.numel() for a in args)
    copies = max(2, -(-COLD_BYTES // max(nbytes, 1)) + 1)
    sets = itertools.cycle([tuple(a.clone() for a in args) for _ in range(copies)])
    return graph_timer(torch, lambda: fn(*next(sets)), reps=max(LATENCY_SAMPLES, copies))


def paired_rounds(pairs, rounds):
    """Read each ``(kernel timer, library timer)`` of ``pairs`` once a round,
    the library first in every other round, so that both sides see the same
    drift of the card; returns the per-round sums over ``pairs``, kernel and
    library, and the per-pair medians."""
    sums = {"kernel": [], "library": []}
    per_pair = [([], []) for _ in pairs]
    for r in range(rounds):
        tot = [0.0, 0.0]
        for (k, lib), reads in zip(pairs, per_pair):
            for side in ((0, 1) if r % 2 == 0 else (1, 0)):
                ms = (k, lib)[side]()
                reads[side].append(ms)
                tot[side] += ms
        sums["kernel"].append(tot[0])
        sums["library"].append(tot[1])
    return sums, [(median(sorted(a)), median(sorted(b))) for a, b in per_pair]


def forward_samples(torch, fn, n, warmup=3):
    """Sorted times in ms of ``n`` calls of ``fn``, each between its own pair
    of CUDA events, issued back to back as a caller would."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(start.elapsed_time(end) for start, end in events)


def sync_samples(torch, fn, n, warmup=2):
    """Sorted host-clock times in ms of ``n`` calls of ``fn``, each from an
    idle card (synchronized) to the end of its device work: the latency a
    caller sees, host work such as tracing and launching included."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return sorted(out)


def median(xs):
    return xs[len(xs) // 2]


def shapes_of(args):
    """The shapes of a call's tensor arguments (a GEMM's B layout is a str)."""
    return [tuple(a.shape) for a in args if hasattr(a, "shape")]


def gemm_dims(a, b, layout):
    """(M, K, N) of ``a @ B``, B ``(K, N)`` (``"kn"``) or ``(N, K)``."""
    return a.shape[0], a.shape[1], b.shape[0] if layout == "nk" else b.shape[1]


def plan_of(conv, a, b, layout):
    """K1's launch plan for the int32 call ``a @ B``."""
    m, k, n = gemm_dims(a, b, layout)
    return conv.gemm_plan(m, n, k, layout, (a.data_ptr(), b.data_ptr()))


# digit pairs (i < na, j < nb, i + j <= 3) of K1's tensor-core path
DIGIT_PAIRS = [[sum(1 for i in range(na) for j in range(nb) if i + j <= 3) for nb in range(5)] for na in range(5)]


def digit_products(torch, a, b, layout, tile=32):
    """int8 tensor-core multiply-adds K1's tile path needs at these int32
    inputs: per 32-row tile of A, 32-column tile of B and 32-wide K step,
    the bytes each side's values need (the kernel's vote), their digit pairs
    with i + j <= 3, times the tile's actual rows, columns and K depth."""
    import torch.nn.functional as F

    a, bt = a.cpu(), (b if layout == "nk" else b.T).cpu()
    k = a.shape[1]
    steps = -(-k // tile)
    depth = torch.full((steps,), tile, dtype=torch.float64)
    depth[-1] = k - tile * (steps - 1)

    def need(x):
        """(weights (tiles,), bytes needed (tiles, steps)) of a (rows, k)
        operand."""
        mag = x ^ (x >> 31)
        e = 1 + (mag >= 0x80).to(torch.int8) + (mag >= 0x8000).to(torch.int8) + (mag >= 0x800000).to(torch.int8)
        tiles = -(-x.shape[0] // tile)
        pad = torch.ones((tiles * tile, steps * tile), dtype=torch.int8)
        pad[:x.shape[0], :k] = e
        rows = torch.full((tiles,), tile, dtype=torch.float64)
        rows[-1] = x.shape[0] - tile * (tiles - 1)
        return rows, pad.view(tiles, tile, steps, tile).amax(dim=(1, 3)).long()

    (ra, na), (rb, nb) = need(a), need(bt)
    wa = (F.one_hot(na, 5).double() * ra[:, None, None]).sum(0)  # (steps, 5): A rows by byte count
    wb = (F.one_hot(nb, 5).double() * rb[:, None, None]).sum(0)
    pairs = torch.tensor(DIGIT_PAIRS, dtype=torch.float64)
    return int(round(float((torch.einsum("sv,vw,sw->s", wa, pairs, wb) * depth).sum())))


def gemm_htree_edge_checks(torch, conv, ht, smoke, dev, seed):
    """Phase 2 for K1's int32 paths and K12's int32 kernel at their edges:
    INT32_MIN, -1, INT32_MAX and full-range operands on both sides, tiles
    whose byte counts differ, K = 40000, M = 1, 2, 15, 16 and 17 at K = 4864
    (the small-M boundary), the stem's K = 27, ragged M, N and K, B in both
    layouts, views 4 bytes off a 16-byte boundary; the H-tree at N = 1, 2,
    ..., 65536, D % 4 != 0, a misaligned view and INT32_MIN columns that
    wrap, and in float32 and bfloat16 at every chunk count, a D off the
    16-byte pack and a misaligned view."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = -2**31, 2**31 - 1

    def i32(shape, a=lo, b=hi):
        return torch.randint(a, b, shape, generator=g, dtype=torch.int32)

    def full(kind, shape):
        return i32(shape) if kind == "full" else torch.full(shape, kind, dtype=torch.int32)

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        return buf[1:].view(t.shape).copy_(t)

    def mixed(shape):
        """1-, 2-, 3- and 4-byte values, changing every 16 rows and 32 K."""
        r = torch.arange(shape[0])[:, None] // 16 + torch.arange(shape[1])[None, :] // 32
        bits = torch.tensor([7, 15, 23, 31])[r % 4]
        return (i32(shape).double() / 2**31 * 2.0 ** bits).floor().clamp(lo, hi).to(torch.int32)

    def b_of(layout, k, n, make):
        return make((n, k) if layout == "nk" else (k, n))

    # (case, A, B, layout, card operands or None for copies)
    cases = []
    kinds = [lo, -1, hi, "full"]
    for x, p in enumerate(kinds):
        for q in kinds[x:]:
            layout = "nk" if x % 2 else "kn"
            cases.append((f"A {p} x B {q} ({layout})", full(p, (70, 100)), b_of(layout, 100, 40, lambda s: full(q, s)),
                          layout, None))
    for layout in ("kn", "nk"):
        cases.append((f"mixed-byte tiles ({layout})", mixed((130, 200)), b_of(layout, 200, 70, mixed), layout, None))
    cases.append(("K=40000 INT32_MAX (all-255 digits), tile path", full(hi, (40, 40000)), full(hi, (24, 40000)),
                  "nk", None))
    cases.append(("K=40000 INT32_MAX, small-M path", full(hi, (3, 40000)), full(hi, (40000, 24)), "kn", None))
    w4864 = i32((4864, 896), -128, 128)
    for m in (1, 2, 15, 16, 17):
        cases.append((f"M={m} K=4864 N=896 (kn)", i32((m, 4864)), w4864, "kn", None))
    cases.append(("M=1 K=4864 N=896, B as (N, K): tile path", i32((1, 4864)), w4864.T.contiguous(), "nk", None))
    cases.append(("stem K=27 (nk)", i32((2048, 27), -8, 8), i32((64, 27), -3, 4), "nk", None))
    cases.append(("ragged M=129 K=1001 N=67 (nk)", i32((129, 1001)), i32((67, 1001), -3, 4), "nk", None))
    cases.append(("ragged M=65 K=33 N=1000 (kn)", i32((65, 33)), i32((33, 1000)), "kn", None))
    cases.append(("M=1 ragged N=1001 (kn)", i32((1, 300)), i32((300, 1001)), "kn", None))
    for layout in ("kn", "nk"):
        for m in (1, 100):
            a, b = i32((m, 96)), b_of(layout, 96, 64, i32)
            cases.append((f"misaligned A and B, M={m} ({layout})", a, b, layout, (off(a), off(b))))
    gemm = {"tile-aligned": ((128, 64), (64, 128), -8, 8, -4, 4), "ragged-K27-N1000": ((1000, 27), (27, 1000), -8, 8, -4, 4),
            "ragged-M77-K4608": ((77, 4608), (4608, 130), -1000, 1000, -4, 4),
            "int32-wrap": ((65, 300), (300, 33), lo, hi, lo, hi), "one-row": ((1, 512), (512, 1000), -100, 100, -4, 4)}
    for name, (sa, sb, a0, a1, b0, b1) in gemm.items():
        a, b = i32(sa, a0, a1), i32(sb, b0, b1)
        cases += [(f"{name} (kn)", a, b, "kn", None), (f"{name} (nk)", a, b.T.contiguous(), "nk", None)]
    for case, a, b, layout, card in cases:
        ca, cb = card or (a.to(dev), b.to(dev))
        got = conv._gemm(ca, cb, layout)
        torch.cuda.synchronize()
        smoke.check("gemm", case, got, conv._gemm_plain(a, b, layout), exact=True)

    ht_cases = [(f"int32 N={2**e}", i32((2**e, 4 * 2**(16 - e) if e < 14 else 16)), None) for e in range(17)]
    ht_cases += [("int32 D=1001 (D % 4 = 1)", i32((64, 1001)), None), ("int32 D=4098 (D % 4 = 2)", i32((32, 4098)), None),
                 ("INT32_MIN columns wrap", torch.full((256, 1024), lo, dtype=torch.int32), None)]
    x = i32((128, 4096))
    ht_cases.append(("int32 misaligned view", x, off(x)))
    for dtype in (torch.float32, torch.bfloat16):  # the same chunked kernel, in tree order
        for n, d in ((1, 4096), (8, 4096), (64, 4100), (2048, 40), (65536, 16)):
            ht_cases.append((f"{dtype} N={n} D={d}", torch.randn((n, d), generator=g).to(dtype), None))
        x = torch.randn((256, 4096), generator=g).to(dtype)
        ht_cases.append((f"{dtype} misaligned view", x, off(x)))
    for case, x, card in ht_cases:
        got = ht._htree(card if card is not None else x.to(dev))
        torch.cuda.synchronize()
        smoke.check("htree_reduce", case, got, ht._htree_plain(x), exact=True)


def bitslice_f32_edge_checks(torch, conv, bm, api, smoke, dev, seed):
    """Phase 2 for K4's two paths and K1's float32 kernel at their edges:
    the tensor-core path on each tile at ragged M, N and K (4-byte w copies
    where N % 16 != 0), the zero-skip pair set, K = 2**17 + 32 of all -128
    stacks (one and two pairs a diagonal: the block folds its s32
    accumulators); the __dp4a path at K % 16 != 0, N % 4 != 0, 3 of 4 pairs
    and stacks off 16 bytes.  Each call must take the path its case names.
    K1 float32 at ragged shapes in both B layouts, on split and unsplit
    plans: within the float tolerance on normals scaled by K**-0.25 (outputs
    of unit size), equal on integer values, the same bits in two calls."""
    rng = torch.Generator().manual_seed(seed)

    def stack(shape, lo=-128, hi=128):
        return torch.randint(lo, hi, shape, generator=rng, dtype=torch.int8)

    # (case, sx, m, k, sw, n, skip, path, fill, x offset in bytes)
    cases = [
        ("mma narrow 1x1 M130 K208 N20", 1, 130, 208, 1, 20, (), "mma", None, 0),
        ("mma narrow 2x2 M77 K48 N32", 2, 77, 48, 2, 32, (), "mma", None, 0),
        ("mma square 2x1 M77 K80 N100", 2, 77, 80, 1, 100, (), "mma", None, 0),
        ("mma square 1x2 M200 K144 N36", 1, 200, 144, 2, 36, (), "mma", None, 0),
        ("mma square 2x2 M65 K80 N132", 2, 65, 80, 2, 132, (), "mma", None, 0),
        ("mma zero-skip M129 K64 N64", 2, 129, 64, 2, 64, ((1, 0), (1, 1)), "mma", None, 0),
        ("mma 1x1 K=2^17+32 all -128", 1, 20, 2**17 + 32, 1, 40, (), "mma", -128, 0),
        ("mma 2x2 K=2^17+32 all -128", 2, 20, 2**17 + 32, 2, 40, (), "mma", -128, 0),
        ("dp4a K40", 1, 64, 40, 1, 64, (), "dp4a", None, 0),
        ("dp4a N30", 2, 64, 64, 1, 30, (), "dp4a", None, 0),
        ("dp4a 3 of 4 pairs", 2, 64, 64, 2, 64, ((1, 1),), "dp4a", None, 0),
        ("dp4a x stack 4 bytes off 16", 2, 50, 64, 1, 40, (), "dp4a", None, 4),
        ("dp4a x stack 1 byte off", 2, 50, 64, 1, 40, (), "dp4a", None, 1),
    ]
    for case, sx, m, k, sw, n, skip, path, fill, offset in cases:
        if fill is None:
            x, w = stack((sx, m, k)), stack((sw, k, n))
        else:
            x, w = torch.full((sx, m, k), fill, dtype=torch.int8), torch.full((sw, k, n), fill, dtype=torch.int8)
        pairs = api.active_pairs(sx, sw, skip)
        buf = torch.empty(x.numel() + offset, dtype=torch.int8, device=dev)
        xc = buf[offset:].view(x.shape)
        xc.copy_(x)
        got = bm._bitslice_gemm(xc, w.to(dev), 8, pairs)
        torch.cuda.synchronize()
        if bm.launched_path() != path:
            smoke.failures.append(f"bitslice_matmul [{case}]: took the {bm.launched_path()} path, not {path}")
        smoke.check("bitslice_matmul", case, got, bm._bitslice_plain(x, w, 8, pairs), exact=True)

    for m, k, n in ((129, 27, 1000), (300, 200, 130), (77, 4608, 130), (1000, 1001, 67), F32_GEMM):
        for layout in ("kn", "nk"):
            scale = k ** -0.25
            a = torch.randn((m, k), generator=rng) * scale
            b = torch.randn((n, k) if layout == "nk" else (k, n), generator=rng) * scale
            plan = conv.gemm_f32_plan(m, n, k, layout, (0, 0))
            case = f"float32 M{m} K{k} N{n} ({layout}, {plan.splits} K ranges)"
            ac, bc = a.to(dev), b.to(dev)
            got, again = conv._gemm(ac, bc, layout), conv._gemm(ac, bc, layout)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                smoke.failures.append(f"gemm_f32 [{case}]: two calls gave different bits")
            smoke.check("gemm_f32", case, got, conv._gemm_plain(a, b, layout), exact=False)
            ai, bi = (a / scale * 4).round(), (b / scale * 2).round()
            smoke.check("gemm_f32", f"{case}, integer values", conv._gemm(ai.to(dev), bi.to(dev), layout),
                        conv._gemm_plain(ai, bi, layout), exact=True)


def bitslice_work(x, w, slice_bits, pairs):
    """(bytes, operations) one bit-sliced GEMM needs: each slice that a
    computed pair reads, read once, and the int32 output written once; two
    int8 operations (multiply, add) per product of each computed pair.  A
    pair whose shift is 32 or more adds 0 mod 2**32 and is not computed."""
    (_, m, k), (_, _, n) = x.shape, w.shape
    live = [(s, t) for s, t in pairs if slice_bits * (s + t) < 32]
    nbytes = len({s for s, _ in live}) * m * k + len({t for _, t in live}) * k * n + 4 * m * n
    return nbytes, 2 * m * k * n * len(live)


def run_bitslice_path(torch, api, bm, smoke, path, run, expected, skipped=()):
    """Drive one bit-sliced path: ``run("cuda")`` with the launch counters
    reset just before and read just after, then ``run("cpu")`` (the plain
    versions).  Holds the kernel's output against its plain version's on the
    same slices, the path's output against the CPU path's, the launch counts
    against ``expected`` and the skipped pairs against the executed ones."""
    card, cpu = [], []
    sink = [card]
    orig = bm._bitslice_gemm

    def rec(x, w, slice_bits, pairs):
        t = time.perf_counter()
        out = orig(x, w, slice_bits, pairs)
        if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing: no result to hold yet
            sink[0].append(((x, w, slice_bits, pairs), out, time.perf_counter() - t))
        return out

    bm._bitslice_gemm = rec
    try:
        api.reset_launch_counts()
        got = run("cuda")
        torch.cuda.synchronize()
        counts = {k: v for k, v in api.launch_counts().items() if v}
        executed, launched, kernel_path = api.last_executed_pairs(), bm.launched_pairs(), bm.launched_path()
        sink[0] = cpu
        want = run("cpu")
    finally:
        bm._bitslice_gemm = orig
    if counts != expected:
        smoke.failures.append(f"{path}: launch counts {counts} != expected {expected}")
    if kernel_path != "mma":
        smoke.failures.append(f"{path}: the bit-sliced GEMM took the {kernel_path} path, not the tensor cores")
    if len(card) != 1 or len(cpu) != 1:
        smoke.failures.append(f"{path}: {len(card)} card and {len(cpu)} CPU bit-sliced GEMM calls, not 1 and 1")
        return None
    (args, out, _), (cargs, plain, plain_s) = card[0], cpu[0]
    if not (torch.equal(args[0].cpu(), cargs[0]) and torch.equal(args[1].cpu(), cargs[1])
            and args[2:] == cargs[2:]):
        smoke.failures.append(f"{path}: the card and CPU paths gave the kernel different slices")
        t = time.perf_counter()
        plain = bm._bitslice_plain(args[0].cpu(), args[1].cpu(), *args[2:])
        plain_s = time.perf_counter() - t
    # the kernel against its plain version on the same slices
    err = smoke.check("bitslice_matmul", f"{path} kernel vs plain {tuple(args[0].shape)}x{tuple(args[1].shape)}",
                      out, plain, exact=True)
    smoke.check(path, "output vs the CPU path", got, want, exact=True)
    active = set(api.active_pairs(args[0].shape[0], args[1].shape[0], skipped))
    if set(skipped) & (set(executed) | set(launched)) or not set(executed) == set(launched) == active:
        smoke.failures.append(f"{path}: executed {executed}, launched {launched}, skipped {skipped}")
    return {"path": path, "run": run, "launches": counts, "args": args, "out": out, "plain": plain,
            "plain_ms": plain_s * 1e3, "kernel_path": kernel_path,
            "max_abs_err": err, "executed": [list(p) for p in executed],
            "launched": [list(p) for p in launched], "skipped": [list(p) for p in skipped]}


def is_glue(kernel_name):
    """Whether a device kernel is PyTorch's (glue: copies, fills, casts)
    rather than one of the port's own."""
    return "at::" in kernel_name or kernel_name.startswith(("Memcpy", "Memset"))


def device_profile(torch, fn, iters=3):
    """Device time by kernel name over ``iters`` calls of ``fn`` (torch
    profiler), and the window's wall time on CUDA events: returns
    ``(wall_ms, {name: (calls, device_ms)}, (copy calls, copy device_ms))``,
    the last over PyTorch's ``aten::copy_`` ops; the dict is empty when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    by_name = {}
    copies, copy_ms = 0, 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            calls, ms = by_name.get(ev.name, (0, 0.0))
            by_name[ev.name] = (calls + 1, ms + ev.time_range.elapsed_us() / 1e3)
        elif ev.name == "aten::copy_":
            copies += 1
            copy_ms += ev.device_time_total
    return start.elapsed_time(end), by_name, (copies, copy_ms / 1e3)


def attention_kernel_checks(torch, att, ref, smoke, dev, seed):
    """Phase 2 for the attention kernels: each against its plain version
    (on a CPU copy) at the decode shapes and at edges."""
    g = torch.Generator().manual_seed(seed)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)

    def i32(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    def sel(rows, t=DECODE_CAPACITY):
        s = torch.zeros(t, dtype=torch.int8)
        s[list(rows)] = 1
        return s

    t, d = DECODE_CAPACITY, DECODE_CFG["head_dim"]
    sigma = ref.softmax_sigma(DECODE_CFG["score_frac"])
    kc, vc, q1, qg = i8((t, d)), i8((t, d)), i8((1, d)), i8((GQA, d))
    scores = att._qk_plain(qg, kc)
    probs = att._softmax_plain(scores, sigma)
    equal_row = torch.zeros((1, 131072), dtype=torch.int32)
    cases = [
        ("attention_qk", f"(1, {d}) x ({t}, {d}) int8", att._qk, att._qk_plain, (q1, kc)),
        ("attention_qk", f"GQA ({GQA}, {d}) x ({t}, {d}) int8", att._qk, att._qk_plain, (qg, kc)),
        ("attention_qk", "int32 wrap (3, 32) x (500, 32)", att._qk, att._qk_plain,
         (i32((3, 32), -2**31, 2**31 - 1), i32((500, 32), -2**31, 2**31 - 1))),
        ("softmax_fixedpoint", f"GQA ({GQA}, {t}) in_frac 13", lambda x: att._softmax(x, sigma),
         lambda x: att._softmax_plain(x, sigma), (scores,)),
        ("softmax_fixedpoint", "equal row (1, 131072)", lambda x: att._softmax(x, sigma),
         lambda x: att._softmax_plain(x, sigma), (equal_row,)),
        ("attention_pv", f"GQA ({GQA}, {t}) int32 x ({t}, {d}) int8 shift 6", lambda p, v: att._pv(p, v, 6),
         lambda p, v: att._pv_plain(p, v, 6), (probs, vc)),
        ("attention_pv", "negative accumulators (3, 300) x (300, 5) shift 40", lambda p, v: att._pv(p, v, 40),
         lambda p, v: att._pv_plain(p, v, 40), (i32((3, 300), -1000, 1000), i32((300, 5), -1000, 1000))),
        ("kv_append", f"int8 ({t}, {d}) one-hot", att._kv_append, att._kv_append_plain, (kc, i8((d,)), sel([5000]))),
        ("kv_append", f"int8 ({t}, {d}) all-zero selector", att._kv_append, att._kv_append_plain,
         (kc, i8((d,)), sel([]))),
        ("kv_append", f"int8 ({t}, {d}) two-hot", att._kv_append, att._kv_append_plain,
         (kc, i8((d,)), sel([0, t - 1]))),
    ]
    cache32, row32 = i32((t, d), -2**31, 2**31 - 1), i32((d,), -2**31, 2**31 - 1)
    for what, rows in (("one-hot", [t // 2]), ("all-zero selector", []), ("two-hot", [1, t - 2])):
        cases.append(("kv_append", f"int32 ({t}, {d}) {what}", att._kv_append, att._kv_append_plain,
                      (cache32, row32, sel(rows))))
    for kernel, case, run, plain, args in cases:
        got = run(*[a.to(dev) for a in args])
        torch.cuda.synchronize()
        smoke.check(kernel, case, got, plain(*args), exact=True)
    kv_append_edge_checks(torch, att, smoke, dev, seed + 50)
    # the oracle's exact divide gives 0 on the long equal row, where the
    # Pallas body's shifted restoring division wraps and gives 64
    if att._softmax_plain(equal_row, sigma).any():
        smoke.failures.append("softmax_fixedpoint: the plain version is not 0 on the equal 131072 row")
    softmax_pv_edge_checks(torch, att, ref, smoke, dev, seed + 100)


def kv_append_edge_checks(torch, att, smoke, dev, seed):
    """Phase 2 for the KV append's launch plan (attention.kv_plan): each
    case against its plain version (on a CPU copy) and held to the kernel its
    case names: selected rows at the first and last row of a block's rows,
    every row selected, a T that is not a multiple of a block's rows, D 16
    and 48, an int32 selector, a cache one byte off 16-byte alignment."""
    g = torch.Generator().manual_seed(seed)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)

    def sel(t, rows, dtype=torch.int8):
        s = torch.zeros(t, dtype=dtype)
        s[list(rows)] = 1
        return s

    def offset(x):  # a copy one byte past a 16-byte boundary
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:] = x.to(dev).reshape(-1)
        return buf[1:].view(x.shape)

    block_rows = att.KV_THREADS * 16 // 64  # rows of a vector-kernel block at D = 64
    cases = [  # (case, path, cache, new, selector, cache off 16 bytes)
        ("first and last rows of blocks", "vec", i8((32768, 64)), i8((64,)),
         sel(32768, [0, block_rows - 1, block_rows, 2 * block_rows - 1, 32768 - block_rows, 32767]), False),
        ("every row selected", "vec", i8((4096, 64)), i8((64,)), sel(4096, range(4096)), False),
        ("T not a multiple of a block's rows", "vec", i8((1000, 64)), i8((64,)), sel(1000, [0, 959, 960, 999]),
         False),
        ("D 16", "vec", i8((5000, 16)), i8((16,)), sel(5000, [0, 255, 256, 4999]), False),
        ("D 48", "vec", i8((3000, 48)), i8((48,)), sel(3000, [0, 84, 85, 2999]), False),
        ("int32 selector", "vec", i8((32768, 64)), i8((64,)), sel(32768, [7, 30000], torch.int32), False),
        ("cache off 16 bytes", "generic", i8((4096, 64)), i8((64,)), sel(4096, [0, 4095]), True),
    ]
    for case, path, cache, new, s, off in cases:
        dc, dn, ds = (offset(cache) if off else cache.to(dev)), new.to(dev), s.to(dev)
        vec = att.kv_plan(*cache.shape, 1, 1, (dc.data_ptr(), dn.data_ptr(), 0)).vec
        if vec != (path == "vec"):
            smoke.failures.append(f"kv_append [{case}]: the plan's vector kernel is {vec}, not {path == 'vec'}")
        got = att._kv_append(dc, dn, ds)
        torch.cuda.synchronize()
        smoke.check("kv_append", f"{path}: {case}", got, att._kv_append_plain(cache, new, s), exact=True)


def softmax_path(att, x):
    """The path of attention.softmax_plan for ``x``: rows, registers, loop;
    with ``+element`` where the cluster path cannot take 16-byte access."""
    plan = att.softmax_plan(*x.shape, x.element_size(), x.data_ptr())
    if plan.cluster == 0:
        return "rows"
    return ("registers" if plan.regs else "loop") + ("" if plan.vec else "+element")


def softmax_pv_edge_checks(torch, att, ref, smoke, dev, seed):
    """Phase 2 for the softmax and p·V launch plans: each path at its edges
    (every call held to the path its case names), a value cache one byte off
    16-byte alignment, the p·V ticket through back-to-back calls of two
    shapes and three CUDA-graph replays, and one device kernel a p·V call."""
    g = torch.Generator().manual_seed(seed)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)

    def i32(shape, lo=-2**20, hi=2**20):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    def offset(x):  # a copy one element past the start of a buffer: off 16-byte alignment
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:] = x.to(dev).reshape(-1)
        return buf[1:].view(x.shape)

    lo, hi = -2**31, 2**31 - 1
    sm_cases = [  # (case, path, scores, in_frac)
        ("one query (1, 32768)", "registers", att._qk_plain(i8((1, 64)), i8((32768, 64))), 13),
        ("T = 1", "rows", i32((1, 1)), 13),
        ("T below a warp (3, 20)", "rows", i32((3, 20)), 13),
        ("64 rows of T = 8", "rows", i32((64, 8)), 13),
        ("widest rows-path rows (9, 512)", "rows", i32((9, 512)), 13),
        ("cluster of one (3, 513)", "registers+element", i32((3, 513)), 13),
        ("ragged (3, 4099)", "registers+element", i32((3, 4099)), 13),
        ("registers full (1, 65536)", "registers", i32((1, 65536)), 13),
        ("past the registers (2, 70000)", "loop", i32((2, 70000)), 13),
        ("row of 2**20", "loop", i32((1, 2**20)), 13),
        ("equal row (1, 131072)", "loop", torch.zeros((1, 131072), dtype=torch.int32), 13),
        ("full range (2, 32768)", "registers", i32((2, 32768), lo, hi), 10),
        ("int8 (2, 32768)", "registers", i8((2, 32768)), 5),
        ("int8 past the registers (1, 70000)", "loop", i8((1, 70000)), 5),
        ("int8 ragged (2, 4097)", "registers+element", i8((2, 4097)), 5),
    ]
    for case, path, x, in_frac in sm_cases:
        sig = ref.softmax_sigma(in_frac)
        for view, where in ((x.to(dev), ""), (offset(x), " off 16 bytes")):
            if where and path == "rows":
                continue
            want_path = path if not where else path.split("+")[0] + "+element"
            got_path = softmax_path(att, view)
            if got_path != want_path:
                smoke.failures.append(f"softmax_fixedpoint [{case}{where}]: took {got_path}, not {want_path}")
            got = att._softmax(view, sig)
            torch.cuda.synchronize()
            smoke.check("softmax_fixedpoint", f"{want_path}: {case}{where}", got, att._softmax_plain(x, sig),
                        exact=True)

    pv_cases = [  # (case, packed, p, v, shift)
        ("one query T = 32768", True, i32((1, 32768), 0, 64), i8((32768, 64)), 6),
        ("two queries T = 32768", True, i32((2, 32768), 0, 64), i8((32768, 64)), 6),
        ("9 queries, three groups", True, i32((9, 1000), 0, 64), i8((1000, 64)), 6),
        ("T = 1", True, i32((1, 1), 0, 64), i8((1, 64)), 6),
        ("T below a warp's rows", True, i32((2, 5), 0, 64), i8((5, 64)), 6),
        ("T ragged 1000", True, i32((1, 1000), 0, 64), i8((1000, 64)), 6),
        ("T ragged 32767", True, i32((1, 32767), 0, 64), i8((32767, 64)), 6),
        ("int32 wrap shift 0", True, i32((2, 3000), lo, hi), i8((3000, 64)), 0),
        ("int32 wrap shift 31", True, i32((2, 3000), lo, hi), i8((3000, 64)), 31),
        ("int32 wrap shift 40", True, i32((2, 3000), lo, hi), i8((3000, 64)), 40),
        ("Dv 16", True, i32((3, 777), 0, 64), i8((777, 16)), 6),
        ("Dv 128", True, i32((5, 2048), 0, 64), i8((2048, 128)), 6),
        ("Dv 256", True, i32((4, 999), 0, 64), i8((999, 256)), 6),
        ("Dv 48", False, i32((2, 700), 0, 64), i8((700, 48)), 6),
        ("Dv 300", False, i32((2, 400), 0, 64), i8((400, 300)), 6),
        ("int32 v T = 32768", False, i32((1, 32768), 0, 64), i32((32768, 64)), 6),
        ("int8 p and v", False, i8((3, 4096)), i8((4096, 64)), 2),
    ]
    for case, packed, pc, vc, shift in pv_cases:
        views = [(pc.to(dev), vc.to(dev), "", packed)]
        if packed:
            views.append((pc.to(dev), offset(vc), " v off by one byte", False))
        for dp, dv_, where, want in views:
            plan = att.pv_plan(dp.shape[0], dp.shape[1], dv_.shape[1], dp.element_size(), dv_.element_size(),
                               (dp.data_ptr(), dv_.data_ptr()))
            path = "packed" if want else "generic"
            if plan.packed != want:
                smoke.failures.append(f"attention_pv [{case}{where}]: took the {'packed' if plan.packed else 'generic'} "
                                      f"kernel, not the {path} one")
            got = att._pv(dp, dv_, shift)
            torch.cuda.synchronize()
            smoke.check("attention_pv", f"{path}: {case}{where}", got, att._pv_plain(pc, vc, shift), exact=True)

    # the ticket: two shapes back to back, then three replays of a captured call
    (p1, v1), (p2, v2) = (i32((1, 32768), 0, 64), i8((32768, 64))), (i32((7, 999), 0, 64), i8((999, 64)))
    d1, d2 = (p1.to(dev), v1.to(dev)), (p2.to(dev), v2.to(dev))
    outs = [att._pv(*d1, 6), att._pv(*d2, 6)]
    for (pc, vc), got, what in zip(((p1, v1), (p2, v2)), outs, ("first", "second")):
        smoke.check("attention_pv", f"ticket: {what} of two calls back to back", got, att._pv_plain(pc, vc, 6),
                    exact=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = att._pv(*d1, 6)
    for i in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        smoke.check("attention_pv", f"ticket: graph replay {i + 1}", captured, att._pv_plain(p1, v1, 6), exact=True)
    if int(att._pv_ticket(dev).item()) != 0:
        smoke.failures.append("attention_pv: the ticket is not 0 after a launch")
    # one device kernel a call (the profiler sees every kernel the call launches)
    _, names, _ = device_profile(torch, lambda: att._pv(*d1, 6), 1)
    if sum(c for c, _ in names.values()) != 1 or not any("pv_packed" in n for n in names):
        smoke.failures.append(f"attention_pv: one call launched {sorted(names)} on the device, not one pv_packed")


class AttentionRecorder:
    """Records every call of the four attention kernel wrappers (arguments
    and output) while installed; launches nothing of its own.  A call made
    while a CUDA graph is captured runs nothing: its output, a buffer of the
    graph that each replay rewrites, goes to ``in_graph`` instead."""

    NAMES = {"attention_qk": "_qk", "softmax_fixedpoint": "_softmax", "attention_pv": "_pv",
             "kv_append": "_kv_append"}

    def __init__(self, torch, att):
        self.torch, self.att = torch, att
        self.calls = {k: [] for k in self.NAMES}
        self.in_graph = {}

    def __enter__(self):
        self.orig = {k: getattr(self.att, f) for k, f in self.NAMES.items()}
        for k, f in self.NAMES.items():
            setattr(self.att, f, self._wrap(k, self.orig[k]))
        return self

    def _wrap(self, kernel, fn):
        def rec(*args):
            out = fn(*args)
            if self.torch.cuda.is_current_stream_capturing():
                self.in_graph[kernel] = out
            else:
                self.calls[kernel].append((args, out))
            return out
        return rec

    def __exit__(self, *exc):
        for k, f in self.NAMES.items():
            setattr(self.att, f, self.orig[k])


class ExecutorRecorder:
    """Records every call of an Executor (held, or behind a traced function)
    while installed: the Executor, its leaves and the route the call took
    (``replay``, ``replay_reason``); runs nothing of its own."""

    def __init__(self, api):
        self.api = api
        self.calls = []

    def __enter__(self):
        orig = self.orig = self.api.Executor._execute_leaves

        def rec(ex, leaves):
            out = orig(ex, leaves)
            self.calls.append((ex, list(leaves), ex.replay, ex.replay_reason))
            return out

        self.api.Executor._execute_leaves = rec
        return self

    def __exit__(self, *exc):
        self.api.Executor._execute_leaves = self.orig


def eager_call(program, ex, *args):
    """The Executor's eager replay of ``ex(*args)`` (its route on the CPU):
    the ops one by one through ``api.dispatch``, for timing and holding
    beside its graph replay."""
    leaves, _ = program.tree_flatten((args, {}))
    return program.tree_unflatten(ex.program.out_tree, ex._eager(leaves))


def copy_in_ms(torch, leaves):
    """Device time (CUDA-graph replay) of the copy of ``leaves`` into static
    buffers of their layout, the copy an Executor's graph replay starts with,
    and its bytes."""
    bufs = [torch.empty_like(l) for l in leaves]
    return graph_ms(torch, lambda: torch._foreach_copy_(bufs, leaves)), sum(l.element_size() * l.numel() for l in leaves)


def held_executor_checks(torch, api, smoke, label, recorder, expected, cpu_outputs=None):
    """Phases 3b and 3d–3g: every call that the path made on the card of an
    Executor took the graph route, its first call included (which ran
    eagerly, then captured); one more graph replay of each, at the leaves of
    its last card call, launches exactly ``expected`` and is bit-equal to the
    same Executor's eager replay and to the CPU path: ``cpu_outputs``, else
    its eager replay on CPU copies of the leaves."""
    held = {}
    for ex, leaves, route, reason in recorder.calls:
        if any(torch.is_tensor(l) and l.is_cuda for l in leaves):
            held.setdefault(id(ex), (ex, []))[1].append((leaves, route, reason))
    if not held:
        smoke.failures.append(f"{label}: no Executor was called on the card")
    out = []
    for ex, calls in held.values():
        name = ex.program.name
        off = [(i, route, why) for i, (_, route, why) in enumerate(calls) if route != "graph"]
        if off:
            smoke.failures.append(f"{label}: Executor {name!r} left the graph route at calls {off}")
        leaves = calls[-1][0]
        api.reset_launch_counts()
        got = ex._run(leaves)
        torch.cuda.synchronize()
        counts = {k: v for k, v in api.launch_counts().items() if v}
        if ex.replay != "graph" or counts != expected:
            smoke.failures.append(f"{label}: Executor {name!r} replay took the {ex.replay} route "
                                  f"({ex.replay_reason}) with launches {counts}, not {expected}")
        eager = ex._eager(leaves)
        want = cpu_outputs if cpu_outputs is not None else ex._eager([l.cpu() for l in leaves])
        for j, (g_, e_, w_) in enumerate(zip(got, eager, want)):
            smoke.check("program", f"{label} {name} output {j}: graph replay vs eager replay", g_, e_.cpu(), True)
            smoke.check("program", f"{label} {name} output {j}: graph replay vs the CPU path", g_, w_, True)
        out.append({"name": name, "card_calls": len(calls), "routes": sorted({r for _, r, _ in calls}),
                    "replay_launches": counts})
    return out


def executor_route_checks(torch, api, att, pimsab_step, smoke, dev, seed):
    """Phase 2 for the Executor's graph replay, on ``decode_program`` at
    ROUTE_CAPACITY rows: leaves that are views off 16 bytes (the first,
    eager call takes the generic kernels; the graph reads aligned static
    buffers and takes the vector ones: bit-equal), one call's output kept
    across the next call, a call inside an outer CUDA graph (the eager
    route, into that graph), and two threads on their own streams sharing
    the Executor.  Every output against the CPU path."""
    cfg = pimsab_step.AttnServeConfig(**DECODE_CFG)
    cap, d = ROUTE_CAPACITY, DECODE_CFG["head_dim"]
    g = torch.Generator().manual_seed(seed)

    def step_args():
        onehot = torch.zeros(cap, dtype=torch.int8)
        onehot[int(torch.randint(0, cap, (1,), generator=g))] = 1
        return [torch.randint(-128, 128, s, generator=g, dtype=torch.int8) for s in ((cap, d), (cap, d), (1, d),
                                                                                      (d,), (d,))] + [onehot]

    sets = [step_args() for _ in range(6)]
    ex = api.compile(pimsab_step.decode_program(cfg, cap))
    want = [ex(*a) for a in sets]  # the CPU path: the plain versions

    def off16(t):  # a view 8 bytes past a 16-byte boundary
        v = torch.empty(t.numel() + 8, dtype=t.dtype, device=dev)[8:].view(t.shape)
        return v.copy_(t.to(dev))

    views = [off16(t) for t in sets[0]]
    kv_generic = not att.kv_plan(cap, d, 1, 1, (views[0].data_ptr(), views[3].data_ptr(), 0)).vec
    qk_generic = not att.rowdot_plan(cap, d, 1, 1, 1, (0, views[2].data_ptr())).vec
    first = ex(*views)
    api.reset_launch_counts()
    second = ex(*views)
    torch.cuda.synchronize()
    counts = {k: v for k, v in api.launch_counts().items() if v}
    (replay,) = ex._graphs.values()
    aligned = all(b.data_ptr() % 16 == 0 for b in replay.inputs)
    smoke.check("program", "leaves off 16 bytes: first call (eager, generic kernels) vs CPU", first, want[0], True)
    smoke.check("program", "leaves off 16 bytes: graph replay (vector kernels) vs CPU", second, want[0], True)
    if not (kv_generic and qk_generic and aligned) or ex.replay != "graph" or counts != PROGRAM_STEP_LAUNCHES:
        smoke.failures.append(f"executor routes: off-16 views take generic kernels {kv_generic}/{qk_generic}, "
                              f"static buffers aligned {aligned}, route {ex.replay} ({ex.replay_reason}), "
                              f"replay launches {counts} (expected {PROGRAM_STEP_LAUNCHES})")

    card = [[a.to(dev) for a in args] for args in sets]
    kept = ex(*card[1])
    before = kept.clone()
    later = ex(*card[2])
    torch.cuda.synchronize()
    smoke.check("program", "an output kept across the next call is unchanged", kept, before.cpu(), True)
    smoke.check("program", "two calls in a row: the first's output vs CPU", kept, want[1], True)
    smoke.check("program", "two calls in a row: the second's output vs CPU", later, want[2], True)

    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        inside = ex(*card[3])
        nested = (ex.replay, ex.replay_reason)
    outer.replay()
    torch.cuda.synchronize()
    smoke.check("program", "a call inside an outer CUDA graph, replayed, vs CPU", inside, want[3], True)
    if nested[0] != "eager":
        smoke.failures.append(f"executor routes: a call inside an outer capture took the {nested[0]} route")

    outs, errors = {0: [], 1: []}, []

    def worker(i):
        try:
            s = torch.cuda.Stream(dev)
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                for _ in range(ROUTE_THREAD_CALLS):
                    outs[i].append(ex(*card[4 + i]))
            s.synchronize()
        except Exception as exc:  # reported as a failure below
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors or any(th.is_alive() for th in threads):
        smoke.failures.append(f"executor routes: two threads sharing an Executor failed: {errors}")
    for i in (0, 1):
        for n, o in enumerate(outs[i]):
            smoke.check("program", f"thread {i} call {n} on its own stream vs CPU", o, want[4 + i], True)
    print(f"phase 2 Executor routes on decode_program({cap}): off-16 views eager on the generic kernels "
          f"{kv_generic and qk_generic}, replay launches {counts}; nested call route {nested[0]}; "
          f"{sum(map(len, outs.values()))} calls from two threads")
    del outer


def decode_requests(torch, seed):
    """The serving path's requests, on the CPU: per request a prefilled K and
    V cache (random int8 rows up to its length, zero after) and, per step, a
    query, the new K and V rows and the one-hot selector of its row."""
    g = torch.Generator().manual_seed(seed)
    cap, d, dv = DECODE_CAPACITY, DECODE_CFG["head_dim"], DECODE_CFG["value_dim"]

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)

    reqs = []
    for length in DECODE_PREFILL:
        kc, vc = torch.zeros((cap, d), dtype=torch.int8), torch.zeros((cap, dv), dtype=torch.int8)
        kc[:length], vc[:length] = i8((length, d)), i8((length, dv))
        steps = []
        for i in range(DECODE_STEPS):
            onehot = torch.zeros(cap, dtype=torch.int8)
            onehot[length + i] = 1
            steps.append((i8((1, d)), i8((d,)), i8((dv,)), onehot))
        reqs.append({"length": length, "kc": kc, "vc": vc, "steps": steps})
    return reqs


def serve(api, pimsab_step, cfg, reqs, dev, per_step=None):
    """Answer every request token by token through the bucket's compiled
    decode step, carrying the caches with ``api.kv_append``; returns the
    contexts (per request, per step).  ``per_step(req, step)`` runs after
    each step."""
    contexts = []
    for r, req in enumerate(reqs):
        ex = api.compile(pimsab_step.decode_program(cfg, DECODE_CAPACITY))
        kc, vc = req["kc"].to(dev), req["vc"].to(dev)
        ctx = []
        for i, step in enumerate(req["steps"]):
            q, k_new, v_new, onehot = (a.to(dev) for a in step)
            ctx.append(ex(kc, vc, q, k_new, v_new, onehot))
            kc = api.kv_append(kc, k_new, onehot)
            vc = api.kv_append(vc, v_new, onehot)
            if per_step is not None:
                per_step(r, i)
        contexts.append(ctx)
    return contexts


def run_serve_path(torch, api, att, pimsab_step, smoke, dev, seed):
    """Phase 3e: the serving path on the card, then on CPU copies."""
    cfg = pimsab_step.AttnServeConfig(**DECODE_CFG)
    reqs = decode_requests(torch, seed)
    step_counts, probs = [], []
    last = {}
    seen = [0]  # eager softmax calls already read

    def per_step(r, i):
        now = api.launch_counts()
        step_counts.append({k: v - last.get(k, 0) for k, v in now.items() if v - last.get(k, 0)})
        last.clear()
        last.update(now)
        # the step's probabilities: its eager call's output (the first step
        # runs eagerly, then captures), else the graph's buffer, which this
        # step's replay wrote
        eager = rec.calls["softmax_fixedpoint"][seen[0]:]
        seen[0] += len(eager)
        probs.append(eager[-1][1] if eager else rec.in_graph["softmax_fixedpoint"].clone())

    info0 = api.compile_cache_info()
    with AttentionRecorder(torch, att) as rec, ExecutorRecorder(api) as exs:
        api.reset_launch_counts()
        t = time.perf_counter()
        got = serve(api, pimsab_step, cfg, reqs, dev, per_step)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        counts = {k: v for k, v in api.launch_counts().items() if v}
    info1 = api.compile_cache_info()
    t = time.perf_counter()
    want = serve(api, pimsab_step, cfg, reqs, torch.device("cpu"))
    cpu_s = time.perf_counter() - t

    n_steps = len(DECODE_PREFILL) * DECODE_STEPS
    expected = {k: v * n_steps for k, v in STEP_LAUNCHES.items()}
    if counts != expected:
        smoke.failures.append(f"decode serving: launch counts {counts} != expected {expected}")
    bad_steps = [i for i, c in enumerate(step_counts) if c != STEP_LAUNCHES]
    if bad_steps:
        smoke.failures.append(f"decode serving: steps {bad_steps} launched {step_counts[bad_steps[0]]}, "
                              f"not {STEP_LAUNCHES}")
    if (info1.misses - info0.misses, info1.hits - info0.hits) != (1, len(reqs) - 1):
        smoke.failures.append(f"decode serving: compile cache {info0.hits}/{info0.misses} → "
                              f"{info1.hits}/{info1.misses} (hits/misses), expected 1 miss and "
                              f"{len(reqs) - 1} hits")
    for r, (g_ctx, w_ctx) in enumerate(zip(got, want)):
        for i, (g_, w_) in enumerate(zip(g_ctx, w_ctx)):
            if g_.shape != (1, DECODE_CFG["value_dim"]) or g_.dtype != torch.int32:
                smoke.failures.append(f"decode serving: context {r}/{i} has shape {tuple(g_.shape)} {g_.dtype}")
            smoke.check("decode_serving", f"request {r} (prefill {reqs[r]['length']}) step {i} context",
                        g_, w_, exact=True)
    sums = [int(p.sum()) for p in probs]
    nonzero = [int((p != 0).sum()) for p in probs]
    if len(probs) != n_steps or min(sums) < 32 or max(nonzero) < 2:
        smoke.failures.append(f"decode serving: degenerate softmax (row sums {sums}, nonzero {nonzero})")
    return {"counts": counts, "step_counts": step_counts, "calls": rec.calls, "executors": exs,
            "cache": {"hits": info1.hits - info0.hits, "misses": info1.misses - info0.misses},
            "first_s": first_s, "cpu_s": cpu_s, "prob_sums": sums, "prob_nonzero": nonzero}


def run_layer_path(torch, api, att, pimsab_step, smoke, dev, seed, capacity):
    """Phase 3f: the decode layer at Qwen2-0.5B's width on a full cache of
    ``capacity`` rows, on the card and on CPU copies."""
    model_dim, head_dim, ff_dim = LAYER_DIMS
    prog = pimsab_step.decode_layer_program(
        model_dim, head_dim, ff_dim, capacity, q_bits=8, kv_bits=8,
        score_bits=DECODE_CFG["score_bits"], score_frac=DECODE_CFG["score_frac"], w_bits=8)
    g = torch.Generator().manual_seed(seed)
    shapes = ((capacity, head_dim), (capacity, head_dim), (1, head_dim), (head_dim, model_dim),
              (model_dim, ff_dim), (ff_dim, model_dim))
    args = [torch.randint(-128, 128, s, generator=g, dtype=torch.int8) for s in shapes]
    ex = api.compile(prog)
    card_args = [a.to(dev) for a in args]
    from repro_torch.kernels import conv

    gemm_calls, orig = [], conv._gemm

    def rec_gemm(a, b, layout="kn"):
        if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing (and a clone would join its graph)
            gemm_calls.append((a.clone(), b.clone(), layout))
        return orig(a, b, layout)

    conv._gemm = rec_gemm
    try:
        with AttentionRecorder(torch, att) as rec, ExecutorRecorder(api) as exs:
            api.reset_launch_counts()
            got = ex(*card_args)
            torch.cuda.synchronize()
            counts = {k: v for k, v in api.launch_counts().items() if v}
            again = ex(*card_args)  # the graph replay
    finally:
        conv._gemm = orig
    want = ex(*args)
    smoke.check("decode_layer", f"capacity {capacity} graph replay output", again, want, exact=True)
    for i, (a, b, layout) in enumerate(gemm_calls):  # K1 at M = 1 against its plain version
        smoke.check("gemm", f"decode layer {capacity} call {i} {shapes_of((a, b))}", orig(a, b, layout),
                    conv._gemm_plain(a.cpu(), b.cpu(), layout), exact=True)
    if counts != LAYER_LAUNCHES:
        smoke.failures.append(f"decode layer {capacity}: launch counts {counts} != {LAYER_LAUNCHES}")
    if got.shape != (1, model_dim) or got.dtype != torch.int32:
        smoke.failures.append(f"decode layer {capacity}: output {tuple(got.shape)} {got.dtype}")
    smoke.check("decode_layer", f"capacity {capacity} output", got, want, exact=True)
    p = rec.calls["softmax_fixedpoint"][0][1]
    if int(p.sum()) < 32 or int((p != 0).sum()) < 2:
        smoke.failures.append(f"decode layer {capacity}: degenerate softmax (sum {int(p.sum())}, "
                              f"nonzero {int((p != 0).sum())})")
    return {"ex": ex, "args": card_args, "counts": counts, "executors": exs, "prob_sum": int(p.sum()),
            "prob_nonzero": int((p != 0).sum()), "out_absmax": int(got.abs().max()), "gemm_calls": gemm_calls}


def decode_gemm_timing(torch, conv, smoke, layer, imad_per_s):
    """Phase 4 for K1 in the decode layer: its three M = 1 calls (the small-M
    path) at the layer's inputs, summed in CUDA-graph replay and eager, beside
    the bound (bytes; the multiply-adds are int32 on IMAD), the plain version
    on the CPU."""
    k_ms = eager_ms = plain_ms = b_bytes = b_ops = 0.0
    nbytes = ops = 0
    for a, b, layout in layer["gemm_calls"]:
        k_ms += graph_ms(torch, lambda: conv._gemm(a, b, layout))
        eager_ms += cuda_ms(torch, lambda: conv._gemm(a, b, layout))
        ca, cb = a.cpu(), b.cpu()
        t = time.perf_counter()
        conv._gemm_plain(ca, cb, layout)
        plain_ms += (time.perf_counter() - t) * 1e3
        m, k, n = gemm_dims(a, b, layout)
        nbytes += 4 * (m * k + k * n + m * n)
        ops += m * k * n
    b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / imad_per_s * 1e3
    calls = layer["gemm_calls"]
    row = {
        "name": "gemm[decode_layer]", "route": "cuda", "source": SOURCES["gemm"], "replaces": REPLACES["gemm"],
        "launches": layer["counts"].get("gemm", 0), "max_abs_err": max(
            (c["max_abs_err"] or 0.0) for c in smoke.cases if c["kernel"] == "gemm"),
        "ms": k_ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "operations" if b_ops > b_bytes else "bytes", "library_ms": None,
        "library_none_reason": "PyTorch has no int32 matrix product on CUDA", "eager_ms": eager_ms,
        "plain_device": "cpu", "plans": [plan_of(conv, a, b, lay)._asdict() for a, b, lay in calls],
        "shapes": [[list(sh) for sh in shapes_of((a, b))] for a, b, _ in calls], "bytes": nbytes, "ops": ops,
    }
    print(f"kernel gemm in the decode layer: {len(calls)} calls {row['shapes']}, {k_ms * 1e3:.2f} us summed in "
          f"graph replay ({eager_ms * 1e3:.2f} us eager; bound {row['bound_ms'] * 1e3:.2f} us by "
          f"{row['bound_by']}, roofline share {row['bound_ms'] / k_ms:.1%}), plain {plain_ms:.3f} ms on the CPU")
    return row


def f32_gemm_timing(torch, conv, smoke, dev, seed):
    """Phase 4 for K1's float32 instance, which no path runs: at RESNET18's
    stage-3 GEMM shape in float32 (F32_GEMM), held to its plain version and
    timed beside torch.matmul with TF32 off, in paired rounds (graph replay).
    The operands hold the forward's kind of values (4-bit activations, 3-bit
    weights) as floats: every product and partial sum is then exact, so any
    order of adds gives the same bits, and the kernel and torch.matmul must
    equal the plain version exactly (random normals over K = 2304 drift past
    the float tolerance by the order of adds alone)."""
    m, k, n = F32_GEMM
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-8, 8, (m, k), generator=g).float()
    b = torch.randint(-3, 4, (k, n), generator=g).float()
    t = time.perf_counter()
    want = conv._gemm_plain(a, b)
    plain_ms = (time.perf_counter() - t) * 1e3
    ca, cb = a.to(dev), b.to(dev)
    err = smoke.check("gemm_f32", f"float32 {F32_GEMM}", conv._gemm(ca, cb), want, exact=True)
    smoke.check("gemm_f32", "torch.matmul library call", torch.matmul(ca, cb), want, exact=True)
    sums, _ = paired_rounds([(graph_timer(torch, lambda: conv._gemm(ca, cb)),
                              graph_timer(torch, lambda: torch.matmul(ca, cb)))], PAIRED_ROUNDS)
    k_ms, lib_ms = median(sorted(sums["kernel"])), median(sorted(sums["library"]))
    cbt = cb.T.contiguous()  # B as (N, K), a conv weight's layout
    nk_ms = graph_ms(torch, lambda: conv._gemm(ca, cbt, "nk"))
    b_bytes, b_ops = 4 * (m * k + k * n + m * n) / MEM_BYTES_PER_S * 1e3, 2 * m * k * n / FP32_FLOP_PER_S * 1e3
    row = {
        "name": "gemm[float32]", "route": "cuda", "source": SOURCES["gemm"], "replaces": REPLACES["gemm"],
        "launches": 0, "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "operations" if b_ops > b_bytes else "bytes", "library_ms": lib_ms,
        "library": "torch.matmul (TF32 off)", "eager_ms": cuda_ms(torch, lambda: conv._gemm(ca, cb)),
        "plain_device": "cpu", "shapes": [[m, k], [k, n]], "rounds": sums, "nk_ms": nk_ms,
        "plan": conv.gemm_f32_plan(m, n, k, "kn", (ca.data_ptr(), cb.data_ptr()))._asdict(),
        "kernel_no_slower": sum(x <= y for x, y in zip(sums["kernel"], sums["library"])),
    }
    print(f"kernel gemm float32 at {F32_GEMM} (no path runs it): {k_ms:.4f} ms in graph replay (bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}, roofline share {row['bound_ms'] / k_ms:.1%}); "
          f"torch.matmul {lib_ms:.4f} ms (medians of {PAIRED_ROUNDS} paired rounds, kernel no slower in "
          f"{row['kernel_no_slower']}); B as (N, K) {nk_ms:.4f} ms; plain {plain_ms:.1f} ms on the CPU")
    return row


def launch_floor(torch, dev):
    """The least device time of one launch on this card: one PyTorch op on
    a one-element tensor (``x.add_(1)``) in CUDA-graph replay, the median of
    5 readings (ms)."""
    x = torch.zeros(1, dtype=torch.int32, device=dev)
    return median(sorted(graph_ms(torch, lambda: x.add_(1)) for _ in range(5)))


def int_mm_yardstick(torch, smoke, kernel, case, run, w, x, want):
    """The library call beside a row dot ``w (rows, K) · x (K,)`` of int8:
    ``torch._int_mm(w, x8)``, with ``x8`` the (K, 8) int8 matrix holding
    ``x`` in column 0 and zeros elsewhere, built here outside the timed call
    (``_int_mm`` refuses 16 rows or fewer in its first operand, so the
    untransposed call cannot take a GEMV).  Column 0 is checked bit-equal to
    ``want``; then kernel (``run``) and library are read in PAIRED_ROUNDS
    paired rounds, warm.  Returns ``(kernel ms, library ms, reason)``: the
    medians, or ``(None, None, the card's message)`` when ``_int_mm`` refuses
    the shape."""
    x8 = torch.zeros((x.shape[0], 8), dtype=torch.int8, device=w.device)
    x8[:, 0] = x
    try:
        lib = torch._int_mm(w, x8)
    except RuntimeError as e:  # the yardstick's own refusal, recorded; the kernel is timed elsewhere
        return None, None, f"torch._int_mm refused: {str(e).splitlines()[0]}"
    smoke.check(kernel, f"{case} torch._int_mm library call (column 0)", lib[:, 0].reshape(want.shape), want,
                exact=True)
    sums, _ = paired_rounds([(graph_timer(torch, run), graph_timer(torch, lambda: torch._int_mm(w, x8)))],
                            PAIRED_ROUNDS)
    return median(sorted(sums["kernel"])), median(sorted(sums["library"])), None


def attention_timing(torch, att, ref, smoke, serve_run, imad_per_s, floor_ms):
    """Phase 4 for the attention kernels: each at the serving path's inputs
    of its T = 32768 request (checked once more against its plain version),
    CUDA-graph ms warm and with the inputs cold in L2, eager ms, the plain
    version (on the card where PyTorch has the ops, else on the CPU), the
    library call where there is one, the bound from this call's bytes and
    operations, and the launch floor beside them."""
    sigma = ref.softmax_sigma(DECODE_CFG["score_frac"])
    run = {"attention_qk": att._qk, "softmax_fixedpoint": lambda x: att._softmax(x, sigma),
           "attention_pv": lambda p, v: att._pv(p, v, ref.SOFTMAX_F), "kv_append": att._kv_append}
    plain = {"attention_qk": att._qk_plain, "softmax_fixedpoint": lambda x: att._softmax_plain(x, sigma),
             "attention_pv": lambda p, v: att._pv_plain(p, v, ref.SOFTMAX_F),
             "kv_append": att._kv_append_plain}
    plain_on_card = {"softmax_fixedpoint", "kv_append"}  # PyTorch has no int32 matmul on CUDA

    def width(a):
        return a.element_size() * a.numel()

    rows = []
    for kernel in ATTN_REPLACES:
        args, path_out = serve_run["calls"][kernel][-1]  # every request's cache holds 32768 rows
        args = tuple(a for a in args if torch.is_tensor(a))  # sigma and shift are fixed above
        cpu_args = [a.cpu() for a in args]
        err = smoke.check(kernel, f"serving path T={DECODE_CAPACITY} call", run[kernel](*args),
                          plain[kernel](*cpu_args), exact=True)
        k_ms = graph_ms(torch, lambda: run[kernel](*args))
        k_cold = cold_timer(torch, run[kernel], args)()
        k_eager = cuda_ms(torch, lambda: run[kernel](*args))
        if kernel in plain_on_card:
            p_ms = graph_ms(torch, lambda: plain[kernel](*args))
        else:
            samples = []
            for _ in range(5):
                t = time.perf_counter()
                plain[kernel](*cpu_args)
                samples.append((time.perf_counter() - t) * 1e3)
            p_ms = median(sorted(samples))
        lib_ms, lib_name, lib_reason = None, None, ATTN_NO_LIBRARY.get(kernel)
        if kernel == "kv_append":
            cache, new, sel = args
            sel_b, new_c = (sel != 0)[:, None], new.to(cache.dtype)[None, :]
            lib = torch.where(sel_b, new_c, cache)
            smoke.check(kernel, "torch.where library call", lib, plain[kernel](*cpu_args), exact=True)
            lib_ms, lib_name = graph_ms(torch, lambda: torch.where(sel_b, new_c, cache)), "torch.where"
        elif kernel == "attention_qk":  # M = 1: the scores are the cache's GEMV by q
            q, k = args
            paired_ms, lib_ms, lib_reason = int_mm_yardstick(torch, smoke, kernel, "serving path", lambda: run[kernel](q, k),
                                                             k, q[0], plain[kernel](*cpu_args))
            if paired_ms is not None:
                k_ms, lib_name = paired_ms, "torch._int_mm (transposed, paired rounds)"
        nbytes = sum(width(a) for a in args) + width(path_out)
        if kernel == "attention_qk":  # int8 products: the int8 peak, two operations a multiply-add
            ops, rate = 2 * args[0].shape[0] * args[1].shape[0] * args[0].shape[1], INT8_OPS_PER_S
        elif kernel == "attention_pv":  # int32 multiply-adds on IMAD
            ops, rate = args[0].shape[0] * args[0].shape[1] * args[1].shape[1], imad_per_s
        elif kernel == "softmax_fixedpoint":
            # int32 operations an element, each once: the max, 13 for the
            # exponential, the sum, the final multiply and shift
            ops, rate = 17 * args[0].numel(), imad_per_s
        else:
            ops, rate = 0, imad_per_s
        b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / rate * 1e3
        rows.append({
            "name": kernel, "route": "cuda", "source": ATTN_SOURCE, "replaces": ATTN_REPLACES[kernel],
            "launches": serve_run["counts"].get(kernel, 0), "max_abs_err": max(
                (c["max_abs_err"] or 0.0) for c in smoke.cases if c["kernel"] == kernel),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(b_bytes, b_ops),
            "bound_by": "operations" if b_ops > b_bytes else "bytes", "library_ms": lib_ms,
            "eager_ms": k_eager, "cold_ms": k_cold, "launch_floor_ms": floor_ms,
            "plain_device": "cuda" if kernel in plain_on_card else "cpu",
            "library": lib_name, "library_none_reason": lib_reason,
            "launches_per_step": STEP_LAUNCHES[kernel], "main_path_max_abs_err": err,
            "shapes": [list(a.shape) for a in args], "dtypes": [str(a.dtype) for a in args],
            "bytes": nbytes, "ops": ops,
        })
        print(f"kernel {kernel}: {k_ms * 1e3:.2f} us in graph replay ({k_cold * 1e3:.2f} us cold, {k_eager * 1e3:.2f} "
              f"us eager; bound {max(b_bytes, b_ops) * 1e3:.3f} us by {rows[-1]['bound_by']}, roofline share "
              f"{max(b_bytes, b_ops) / k_ms:.1%}; {k_ms / floor_ms:.2f}x the launch floor) at "
              f"{rows[-1]['shapes']}; plain {p_ms:.4f} ms on "
              f"{rows[-1]['plain_device']}; library {lib_ms}; launches on the serving path "
              f"{rows[-1]['launches']}")
    return rows


def decode_latency(torch, api, program, pimsab_step, dev, seed, layer):
    """One decode step (the Program call and the two-row cache carry) and the
    Program call alone at 4096 and 32768 rows, and the decode layer, each
    from an idle card (host clock, median of LATENCY_SAMPLES), two ways: the
    held Executor's graph replay and the same Executor's eager replay; beside
    their device time (CUDA-graph replay of the ops) and the device time of
    the replay's copy of the leaves into its static buffers."""
    cfg = pimsab_step.AttnServeConfig(**DECODE_CFG)
    g = torch.Generator().manual_seed(seed)
    out = {}
    for cap in (4096, DECODE_CAPACITY):
        ex = api.compile(pimsab_step.decode_program(cfg, cap))
        d = DECODE_CFG["head_dim"]
        kc, vc = (torch.randint(-128, 128, (cap, d), generator=g, dtype=torch.int8).to(dev) for _ in range(2))
        q, k_new, v_new = (torch.randint(-128, 128, s, generator=g, dtype=torch.int8).to(dev)
                           for s in ((1, d), (d,), (d,)))
        onehot = torch.zeros(cap, dtype=torch.int8, device=dev)
        onehot[cap - 1] = 1
        args = (kc, vc, q, k_new, v_new, onehot)

        def program_call(run=ex):
            return run(*args)

        def eager_program():
            return eager_call(program, ex, *args)

        def step(call=program_call):
            ctx = call()
            api.kv_append(kc, k_new, onehot)
            api.kv_append(vc, v_new, onehot)
            return ctx

        lat, prog_lat = sync_samples(torch, step, LATENCY_SAMPLES), sync_samples(torch, program_call, LATENCY_SAMPLES)
        eager_lat = sync_samples(torch, lambda: step(eager_program), LATENCY_SAMPLES)
        eager_prog = sync_samples(torch, eager_program, LATENCY_SAMPLES)
        copy_ms, copy_bytes = copy_in_ms(torch, list(args))
        out[cap] = {"step_ms_median": median(lat), "step_ms_samples": lat,
                    "program_ms_median": median(prog_lat), "program_ms_samples": prog_lat,
                    "eager_step_ms_median": median(eager_lat), "eager_step_ms_samples": eager_lat,
                    "eager_program_ms_median": median(eager_prog), "eager_program_ms_samples": eager_prog,
                    "copy_in_device_ms": copy_ms, "copy_in_bytes": copy_bytes, "replay": ex.replay,
                    "step_device_ms": graph_ms(torch, step), "step": step}
        print(f"decode step at {cap} rows (median of {LATENCY_SAMPLES}, host clock from an idle card): graph replay "
              f"{median(lat):.4f} ms with the cache carry, {median(prog_lat):.4f} ms the Program call alone; eager "
              f"replay {median(eager_lat):.4f} / {median(eager_prog):.4f} ms; copy-in {copy_ms * 1e3:.2f} us device "
              f"time ({copy_bytes} bytes, {copy_ms / median(prog_lat):.1%} of the Program call); device time "
              f"{out[cap]['step_device_ms'] * 1e3:.2f} us in graph replay")
    lex, largs = layer["ex"], layer["args"]  # new names: out[cap]["step"] keeps reading ex and args
    lat = sync_samples(torch, lambda: lex(*largs), LATENCY_SAMPLES)
    eager_lat = sync_samples(torch, lambda: eager_call(program, lex, *largs), LATENCY_SAMPLES)
    copy_ms, copy_bytes = copy_in_ms(torch, list(largs))
    out["layer"] = {"ms_median": median(lat), "ms_samples": lat, "eager_ms_median": median(eager_lat),
                    "eager_ms_samples": eager_lat, "copy_in_device_ms": copy_ms, "copy_in_bytes": copy_bytes,
                    "device_ms": graph_ms(torch, lambda: lex(*largs))}
    print(f"decode layer at {DECODE_CAPACITY} rows (median of {LATENCY_SAMPLES}, host clock from an idle card): "
          f"graph replay {median(lat):.4f} ms, eager replay {median(eager_lat):.4f} ms; copy-in "
          f"{copy_ms * 1e3:.2f} us device time ({copy_bytes} bytes, {copy_ms / median(lat):.1%} of the replay); "
          f"device time {out['layer']['device_ms']:.4f} ms in graph replay")
    return out


def entry_kernel_checks(torch, att, ht, rg, smoke, dev, seed):
    """Phase 2 for decode_gemv, htree_reduce and rglru_scan: each kernel
    against its plain version (on a CPU copy) at edges: a wrapping int32
    dot product, a ragged K, misaligned int8 views, N = 1 and 2 lanes in
    each dtype, T = 1 and a ragged W."""
    g = torch.Generator().manual_seed(seed)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)

    def i32(shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g, dtype=torch.int32)

    def f32(shape):
        return torch.randn(shape, generator=g)

    def off(t):
        """A copy of the int8 ``t`` on the card, one byte off its allocation's
        alignment."""
        buf = torch.empty(t.numel() + 1, dtype=torch.int8, device=dev)
        return buf[1:].view(t.shape).copy_(t)

    def gates(shape):
        return torch.sigmoid(f32(shape)), f32(shape), f32((shape[0], shape[2]))

    w896, x896, x64k = i8((128, 896)), i8((896,)), i8((65536,))
    w64k = i8((40, 65536))
    # (kernel, case, run, plain, CPU operands, card operands or None for copies)
    cases = [
        ("decode_gemv", "q_o_proj (896, 896) int8", att._gemv, att._gemv_plain, (i8((896, 896)), x896), None),
        ("decode_gemv", "int32 wrap (300, 64)", att._gemv, att._gemv_plain, (i32((300, 64)), i32((64,))), None),
        ("decode_gemv", "ragged K (500, 37) int8", att._gemv, att._gemv_plain, (i8((500, 37)), i8((37,))), None),
        ("decode_gemv", "int8 w, int32 x (77, 96)", att._gemv, att._gemv_plain,
         (i8((77, 96)), torch.randint(-2**20, 2**20, (96,), generator=g, dtype=torch.int32)), None),
        ("decode_gemv", "misaligned int8 w (128, 896)", att._gemv, att._gemv_plain, (w896, x896),
         (off(w896), x896.to(dev))),
        ("decode_gemv", "misaligned int8 x, K 65536 (not staged)", att._gemv, att._gemv_plain, (w64k, x64k),
         (w64k.to(dev), off(x64k))),
    ]
    for n in (1, 2):
        for dtype, make in (("float32", f32), ("bfloat16", lambda s: f32(s).to(torch.bfloat16)), ("int32", i32)):
            cases.append(("htree_reduce", f"N={n} {dtype} D=1000", ht._htree, ht._htree_plain,
                          (make((n, 1000)),), None))
    cases.append(("htree_reduce", "N=8 float32 D=1", ht._htree, ht._htree_plain, (f32((8, 1)),), None))
    for shape in ((2, 1, 5), (2, 37, 300)):
        cases.append(("rglru_scan", f"(B, T, W) = {shape}", rg._scan, rg._scan_plain, gates(shape), None))
    for kernel, case, run, plain, cpu_args, card_args in cases:
        got = run(*(card_args or [a.to(dev) for a in cpu_args]))
        torch.cuda.synchronize()
        smoke.check(kernel, case, got, plain(*cpu_args), exact=True)
    rglru_edge_checks(torch, rg, smoke, dev, seed + 50)
    rowdot_edge_checks(torch, att, smoke, dev, seed + 70)


def rglru_edge_checks(torch, rg, smoke, dev, seed):
    """Phase 2 for the RG-LRU scan's launch plan (rglru_scan.rglru_plan),
    forward and gradient kernel (``rglru_scan_bwd_f32``, ∂h0 in every other
    case): each case bit-equal to the plain version on a CPU copy, ±0 included, and
    held to the copies its case names: T = 1, T one short of and one past a
    stage, T = 8192, W = 1, 3 and 4, a ragged last group, B · W below a
    group, a and b 4 bytes off 16-byte alignment (4-byte copies), and ±0 and
    subnormal operands (a build that flushed subnormals would differ)."""
    g = torch.Generator().manual_seed(seed)

    def gates(shape):
        bsz, _, w = shape
        return (torch.sigmoid(torch.randn(shape, generator=g)), torch.randn(shape, generator=g),
                torch.randn((bsz, w), generator=g))

    def subnormal(shape):
        bsz, _, w = shape

        def draw(shp, scale):
            kind = torch.randint(0, 4, shp, generator=g)
            vals = torch.randn(shp, generator=g) * scale
            return torch.where(kind == 0, 0.0, torch.where(kind == 1, -0.0, vals))

        return draw(shape, 0.5).abs(), draw(shape, 2.0**-135), draw((bsz, w), 2.0**-130)

    def offset(x):  # a copy 4 bytes past a 16-byte boundary
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:] = x.to(dev).reshape(-1)
        return buf[1:].view(x.shape)

    steps = rg.SCAN_STEPS
    cases = [  # (case, shape, 16-byte copies, a and b off 16 bytes, operands)
        ("T = 1", (4, 1, 2560), True, False, gates),
        ("T one short of a stage", (2, steps - 1, 64), True, False, gates),
        ("T one past a stage", (2, steps + 1, 64), True, False, gates),
        ("ragged last group W = 40", (2, 40, 40), True, False, gates),
        ("T = 8192", (1, 8192, 40), True, False, gates),
        ("W = 1", (3, 50, 1), False, False, gates),
        ("W = 3", (2, 50, 3), False, False, gates),
        ("W = 4", (2, 50, 4), True, False, gates),
        ("ragged last group W = 300", (2, 37, 300), True, False, gates),
        ("ragged last group W = 513", (3, 260, 513), False, False, gates),
        ("B * W below a group", (3, 33, 4), True, False, gates),
        ("a and b off 16 bytes", (2, 100, 2560), False, True, gates),
        ("±0 and subnormals", (2, 70, 48), True, False, subnormal),
        ("±0 and subnormals, 4-byte copies", (2, 70, 50), False, False, subnormal),
    ]
    tiny = torch.finfo(torch.float32).tiny
    for n, (case, shape, vec, off, make) in enumerate(cases):
        a, b, h0 = make(shape)
        da, db = (offset(a), offset(b)) if off else (a.to(dev), b.to(dev))
        if rg.rglru_plan(*shape, (da.data_ptr(), db.data_ptr())).vec != vec:
            smoke.failures.append(f"rglru_scan [{case}]: the plan's 16-byte copies are not {vec}")
        got = rg._scan(da, db, h0.to(dev))
        torch.cuda.synchronize()
        want = rg._scan_plain(a, b, h0)
        path = "16-byte copies" if vec else "4-byte copies"
        smoke.check("rglru_scan", f"{path}: {case}", got, want, exact=True)
        if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
            smoke.failures.append(f"rglru_scan [{case}]: the bits differ from the plain version's (±0)")
        if make is subnormal and not ((want.abs() < tiny) & (want != 0)).any():
            smoke.failures.append(f"rglru_scan [{case}]: the plain version holds no subnormal output")
        # the gradient kernel at the same edges: ∂a, ∂b (and ∂h0 in every
        # other case) from an upstream gradient with ±0 where the case has them
        up = torch.randn(shape, generator=g)
        if make is subnormal:
            up = torch.where(b == 0, b, up)  # ±0 where b has them
        need_h0 = n % 2 == 0
        dg, dhs = (offset(up), offset(want)) if off else (up.to(dev), want.to(dev))
        if rg.rglru_plan(*shape, (da.data_ptr(), dhs.data_ptr(), h0.data_ptr(), dg.data_ptr())).vec != vec:
            smoke.failures.append(f"rglru_scan_bwd [{case}]: the plan's 16-byte copies are not {vec}")
        grads = rg._scan_bwd(da, h0.to(dev), dhs, dg, need_h0)
        torch.cuda.synchronize()
        wants = rg._scan_bwd_plain(a, h0, want, up, need_h0)
        for name, x, y in zip(("da", "db", "dh0"), grads, wants):
            if y is None:
                if x is not None:
                    smoke.failures.append(f"rglru_scan_bwd [{case}]: ∂h0 computed though not asked for")
                continue
            smoke.check("rglru_scan_bwd", f"{path}: {case} {name}", x, y, exact=True)
            if not torch.equal(x.cpu().view(torch.int32), y.view(torch.int32)):
                smoke.failures.append(f"rglru_scan_bwd [{case}] {name}: the bits differ from the plain version's")
        if make is subnormal and not ((wants[0].abs() < tiny) & (wants[0] != 0)).any():
            smoke.failures.append(f"rglru_scan_bwd [{case}]: the plain version holds no subnormal ∂a")


def pool_ewise_edge_checks(torch, conv, ewise, smoke, dev, seed):
    """Phase 2 for the row reduction and the elementwise kernels at the edges
    of their launch plans: every lane-group size (POOL_EDGE_K) at row counts
    off the groups' tiles, a window matrix and operands 4 bytes past a
    16-byte boundary, int32 sums that wrap, INT32_MIN rows, float rows and
    elements holding NaN, n from 1 to 255, and channels-last operands, whose
    layout the result must keep, beside a mixed pair that is copied."""
    g = torch.Generator().manual_seed(seed)

    def i32(shape, lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    def off(t):
        """A copy of ``t`` on the card, one element past its allocation's
        (16-byte aligned) start."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        return buf[1:].view(t.shape).copy_(t)

    def cl(t):
        return t.to(dev).contiguous(memory_format=torch.channels_last)

    def pool(op):
        return (lambda p: conv._pool_rows(p, op)), (lambda p: conv._pool_rows_plain(p, op))

    add = (lambda a, b: ewise._ewise("add", a, b)), (lambda a, b: ewise._ewise_plain("add", a, b))
    relu = (lambda a: ewise._ewise("relu", a)), (lambda a: ewise._ewise_plain("relu", a))
    # (kernel, case, (run, plain), CPU operands, card operands or None for copies, exact, keeps layout)
    cases = []
    for k in POOL_EDGE_K:
        for op in ("sum", "max"):
            cases.append((f"pool_{op}", f"int32 K={k} rows={1000 + k}", pool(op), (i32((1000 + k, k)),),
                          None, True, False))
    cases.append(("pool_sum", "float32 K=1000 rows=333", pool("sum"), (torch.randn((333, 1000), generator=g),),
                  None, False, False))
    for k in (4, 16, 100):
        p = i32((777, k))
        for op in ("sum", "max"):
            cases.append((f"pool_{op}", f"misaligned view K={k}", pool(op), (p,), (off(p),), True, False))
    wrap = torch.full((300, 16), 2**31 - 1, dtype=torch.int32)
    wrap[::3] = -2**31
    nan = torch.randn((300, 16), generator=g)
    nan[5, 7], nan[17] = float("nan"), float("nan")
    for op in ("sum", "max"):
        cases.append((f"pool_{op}", "INT32_MAX / INT32_MIN rows", pool(op), (wrap,), None, True, False))
        cases.append((f"pool_{op}", "float32 rows holding NaN", pool(op), (nan,), None, op == "max", False))
    for n in (1, 3, 4, 5, 255):
        f = torch.randn((n,), generator=g)
        f[n // 2] = float("nan")
        cases += [("ewise_add", f"int32 wrap n={n}", add, (i32((n,)), i32((n,))), None, True, False),
                  ("relu", f"int32 n={n}", relu, (i32((n,)),), None, True, False),
                  ("relu", f"float32 holding NaN n={n}", relu, (f,), None, True, False)]
    for n in (5, 1000003):
        x, y = i32((n,)), i32((n,))
        cases += [("ewise_add", f"misaligned x[1:] n={n}", add, (x, y), (off(x), y.to(dev)), True, False),
                  ("relu", f"misaligned x[1:] n={n}", relu, (x,), (off(x),), True, False)]
    for dtype in (torch.int32, torch.float32):
        x, y = (i32((4, 24, 7, 5)) if dtype == torch.int32 else torch.randn((4, 24, 7, 5), generator=g)
                for _ in range(2))
        cases += [("ewise_add", f"channels-last {dtype}", add, (x, y), (cl(x), cl(y)), True, True),
                  ("relu", f"channels-last {dtype}", relu, (x,), (cl(x),), True, True),
                  ("ewise_add", f"channels-last + contiguous {dtype} (copied)", add, (x, y),
                   (cl(x), y.to(dev)), True, False)]
    for kernel, case, (run, plain), cpu_args, card_args, exact, keeps_layout in cases:
        card_args = card_args or [a.to(dev) for a in cpu_args]
        got = run(*card_args)
        torch.cuda.synchronize()
        smoke.check(kernel, case, got, plain(*cpu_args), exact)
        if keeps_layout and got.stride() != card_args[0].stride():
            smoke.failures.append(f"{kernel} [{case}]: result strides {got.stride()} != the operands' "
                                  f"{card_args[0].stride()}")


def rowdot_edge_checks(torch, att, smoke, dev, seed):
    """Phase 2 for the row-dot launch plan (attention.rowdot_plan) through
    both of its wrappers, each case against its plain version (on a CPU
    copy) and held to the path its case names (row dot with its lanes and
    split, or the generic kernel): every lanes from 1 to 32 (K = 16 · lanes
    int8) at one and at 9 queries, rows split over 2, 4 and 8 warps, row
    counts that are not a multiple of a warp's rows, M = 1 to 9 queries, the
    queries streamed past the registers, the grid-stride loop, int32 wrap,
    kernels_bench's (512, 512) int32, and views one byte off; and one call
    of each wrapper on each path launches one device kernel, the one its
    plan names (profiler)."""
    g = torch.Generator().manual_seed(seed)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)

    def i32(shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g, dtype=torch.int32)

    def off8(t):  # int8: a copy on the card one byte off a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=torch.int8, device=dev)
        return buf[1:].view(t.shape).copy_(t)

    def off4(t):  # int32: one element (4 bytes) off
        buf = torch.empty(t.numel() + 1, dtype=torch.int32, device=dev)
        return buf[1:].view(t.shape).copy_(t)

    # (kernel, case, want: (lanes, split) or None for the generic kernel,
    #  a (nq, K) and w (rows, K) on the CPU, which operand sits off alignment)
    cases = []
    for lanes, split in ((1, 1), (2, 1), (4, 1), (8, 1), (16, 1), (32, 1), (32, 2), (32, 4), (32, 8)):
        for nq in (1, 9):
            # split: a lane's target of chunks on every thread of the row, and
            # one row past ROWDOT_TARGET_BLOCKS blocks' (ragged last warp), so
            # no more threads a row are needed; a block's 8 warps take any rows
            target = min(att.ROWDOT_TARGET_ITERS, att.ROWDOT_XREG_CHUNKS // (1 if nq == 1 else att.ROWDOT_GROUP))
            span = lanes * split
            rows = 37 if split == att.ROWDOT_MAX_WARPS else att.ROWDOT_TARGET_BLOCKS * 256 // span + 3
            rows, k = (1001, 16 * lanes) if split == 1 else (rows, 16 * target * span)  # unsplit: whole rows
            cases.append(("attention_qk" if nq > 1 or split == 1 else "decode_gemv",
                          f"lanes {lanes} split {split}, ({nq}, {k}) x ({rows}, {k})", (lanes, split), i8((nq, k)),
                          i8((rows, k)), None))
    for m in range(1, 10):
        cases.append(("attention_qk", f"M = {m}, ({m}, 64) x (1001, 64)", (4, 1), i8((m, 64)), i8((1001, 64)), None))
    cases += [
        ("attention_qk", "queries streamed, (3, 16384) x (100, 16384)", (32, 8), i8((3, 16384)), i8((100, 16384)),
         None),
        ("decode_gemv", "grid-stride loop, (1100000, 16)", (1, 1), i8((1, 16)), i8((1100000, 16)), None),
        ("decode_gemv", "int32 wrap (300, 64)", (16, 1), i32((1, 64)), i32((300, 64)), None),
        ("attention_qk", "int32 wrap (3, 32) x (500, 32)", (8, 1), i32((3, 32)), i32((500, 32)), None),
        ("decode_gemv", "kernels_bench (512, 512) int32", (32, 4), i32((1, 512)), i32((512, 512)), None),
        ("decode_gemv", "unroll 8 in registers, (37, 20000)", (32, 8), i8((1, 20000)), i8((37, 20000)), None),
        ("decode_gemv", "unroll 2, (2000, 1024)", (32, 1), i8((1, 1024)), i8((2000, 1024)), None),
        ("decode_gemv", "int32 unroll 2, (2000, 256)", (32, 1), i32((1, 256)), i32((2000, 256)), None),
        ("decode_gemv", "int32 unroll 4, (5000, 256)", (16, 1), i32((1, 256)), i32((5000, 256)), None),
        ("decode_gemv", "int32 unroll 8 in registers, (40, 8192)", (32, 8), i32((1, 8192)), i32((40, 8192)), None),
        ("decode_gemv", "int32 streamed, (40, 16384)", (32, 8), i32((1, 16384)), i32((40, 16384)), None),
        ("decode_gemv", "weight one byte off (128, 896)", None, i8((1, 896)), i8((128, 896)), "w"),
        ("decode_gemv", "activation one byte off (896, 896)", None, i8((1, 896)), i8((896, 896)), "a"),
        ("attention_qk", "cache one byte off (1001, 64)", None, i8((2, 64)), i8((1001, 64)), "w"),
        ("attention_qk", "queries one byte off (7, 64)", None, i8((7, 64)), i8((1001, 64)), "a"),
        ("decode_gemv", "int32 weight 4 bytes off (300, 64)", None, i32((1, 64)), i32((300, 64)), "w"),
    ]
    probes = {}  # (kernel, device kernel) → the first case that takes it
    for kernel, case, want, a, w, shifted in cases:
        move = {torch.int8: off8, torch.int32: off4}[a.dtype]
        da = move(a) if shifted == "a" else a.to(dev)
        dw = move(w) if shifted == "w" else w.to(dev)
        plan = att.rowdot_plan(w.shape[0], w.shape[1], a.shape[0], dw.element_size(), da.element_size(),
                               (dw.data_ptr(), da.data_ptr()))
        took = (plan.lanes, plan.split) if plan.vec else None
        if took != want:
            smoke.failures.append(f"{kernel} [{case}]: the plan takes {took or 'the generic kernel'}, not "
                                  f"{want or 'the generic kernel'}")
        if case.startswith("grid-stride") and plan.blocks * plan.rows_per_step >= w.shape[0]:
            smoke.failures.append(f"{kernel} [{case}]: the grid ({plan.blocks} blocks) walks no second step")
        if kernel == "attention_qk":
            call, want_out = (lambda da=da, dw=dw: att._qk(da, dw)), att._qk_plain(a, w)
        else:
            call, want_out = (lambda da=da, dw=dw: att._gemv(dw, da[0])), att._gemv_plain(w, a[0])
        got = call()
        torch.cuda.synchronize()
        path = f"rowdot lanes {plan.lanes} split {plan.split}" if plan.vec else "generic"
        smoke.check(kernel, f"{path}: {case}", got, want_out, exact=True)
        device_kernel = "rowdot" if plan.vec else {"attention_qk": "qk_generic", "decode_gemv": "gemv_generic"}[kernel]
        probes.setdefault((kernel, device_kernel), (case, call))
    # one device kernel a call, the one the plan names (profiler)
    for (kernel, device_kernel), (case, call) in sorted(probes.items()):
        _, names, _ = device_profile(torch, call, 1)
        if sum(c for c, _ in names.values()) != 1 or not any(device_kernel in n for n in names):
            smoke.failures.append(f"{kernel} [{case}]: one call launched {sorted(names)} on the device, not one "
                                  f"{device_kernel}")


def entry_point_cases(torch, api, cfg, seed):
    """Phase 3g's calls, on the CPU: ``(kernel, case, entry point, operands)``
    for the decode projections, the RG-LRU scan, the H-tree reductions and
    the max pool at the stem of this ResNet (the one path that runs
    ``pool_max``)."""
    g = torch.Generator().manual_seed(seed)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)

    acts = {k: i8((k,)) for k in sorted({k for _, k in GEMV_SHAPES.values()})}  # one activation a width
    cases = [("decode_gemv", name, api.decode_gemv, (i8((m, k)), acts[k])) for name, (m, k) in GEMV_SHAPES.items()]
    m, k = GEMV_BENCH
    cases.append(("decode_gemv", "kernels_bench_int32", api.decode_gemv,
                  (torch.randint(-50, 50, (m, k), generator=g, dtype=torch.int32),
                   torch.randint(-50, 50, (k,), generator=g, dtype=torch.int32))))
    bsz, _, w = RGLRU_SHAPE
    cases.append(("rglru_scan", "recurrentgemma_2b", api.rglru_scan,
                  (torch.sigmoid(torch.randn(RGLRU_SHAPE, generator=g)), torch.randn(RGLRU_SHAPE, generator=g),
                   torch.randn((bsz, w), generator=g))))
    for dtype in ("float32", "bfloat16", "int32"):
        x = (torch.randint(-2**31, 2**31 - 1, HTREE_SHAPE, generator=g, dtype=torch.int32) if dtype == "int32"
             else torch.randn(HTREE_SHAPE, generator=g).to(getattr(torch, dtype)))
        cases.append(("htree_reduce", f"pimsab_tile_{dtype}", api.htree_reduce, (x,)))
    cases.append(("htree_reduce", "kernels_bench_float32", api.htree_reduce,
                  (torch.randn(HTREE_BENCH, generator=g),)))
    stem = torch.randint(-2**20, 2**20, (BATCH, cfg.stem_channels, cfg.input_hw, cfg.input_hw),
                         generator=g, dtype=torch.int32)
    cases.append(("maxpool2d", "resnet18_stem", lambda v: api.maxpool2d(v, window=2), (stem,)))
    return cases


def run_entry_points(torch, api, ref, smoke, dev, cases):
    """Phase 3g: each call of ``cases`` on the card, eagerly and through
    ``api.trace`` → ``api.compile`` → a held ``Executor``, with the launch
    counters reset just before and read just after each; both outputs
    against the same call on the CPU copies, bit for bit, and the RG-LRU
    scan also within the float tolerance of the associative-scan oracle."""
    results = []
    for kernel, case, fn, cpu_args in cases:
        launched = LAUNCHED_BY.get(kernel, kernel)
        args = [a.to(dev) for a in cpu_args]
        api.reset_launch_counts()
        got = fn(*args)
        torch.cuda.synchronize()
        eager = {k: v for k, v in api.launch_counts().items() if v}
        ex = api.compile(api.trace(fn, name=f"{kernel}_{case}").program_for(*args))
        api.reset_launch_counts()
        with ExecutorRecorder(api) as exs:
            replay = ex(*args)
            torch.cuda.synchronize()
        traced = {k: v for k, v in api.launch_counts().items() if v}
        t = time.perf_counter()
        want = fn(*cpu_args)
        cpu_s = time.perf_counter() - t
        held = held_executor_checks(torch, api, smoke, f"phase 3g {kernel} {case}", exs, {launched: 1}, [want])
        for how, counts in (("eager", eager), ("Executor replay", traced)):
            if counts != {launched: 1}:
                smoke.failures.append(f"{kernel} {case} {how}: launch counts {counts} != {{{launched!r}: 1}}")
        smoke.check(launched, f"{case} eager vs CPU", got, want, exact=True)
        smoke.check(launched, f"{case} Executor replay vs CPU", replay, want, exact=True)
        if kernel == "rglru_scan":
            oracle = ref.rglru_scan_ref(*args)
            smoke.check("rglru_scan_oracle", f"{case} vs the associative-scan oracle", got, oracle.cpu(), exact=False)
        results.append({"kernel": kernel, "launched": launched, "case": case, "args": args, "cpu_args": cpu_args,
                        "want": want, "ex": ex, "held": held, "launches": eager.get(launched, 0) + traced.get(launched, 0),
                        "eager_counts": eager, "traced_counts": traced, "cpu_s": cpu_s,
                        "shapes": [list(a.shape) for a in args], "dtypes": [str(a.dtype) for a in args]})
        print(f"phase 3g {kernel} {case} {[tuple(a.shape) for a in args]}: launches eager {eager}, "
              f"Executor {traced} then {held[0]['replay_launches'] if held else None} a graph replay; bit-equal to "
              f"CPU: {torch.equal(got.cpu(), want)} / {torch.equal(replay.cpu(), want)}; CPU call {cpu_s:.3f} s")
    return results


def entry_executor_latency(torch, program, entry):
    """Phase 4 for phase 3g's held Executors: each call from an idle card
    (host clock, median of LATENCY_SAMPLES), graph replay and eager replay,
    beside the device time of the replay's copy-in."""
    rows = {}
    for r in entry:
        ex, args = r["ex"], r["args"]
        lat = sync_samples(torch, lambda: ex(*args), LATENCY_SAMPLES)
        eager = sync_samples(torch, lambda: eager_call(program, ex, *args), LATENCY_SAMPLES)
        copy_ms, copy_bytes = copy_in_ms(torch, list(args))
        name = f"{r['kernel']}[{r['case']}]"
        rows[name] = {"graph_ms_median": median(lat), "eager_ms_median": median(eager), "copy_in_device_ms": copy_ms,
                      "copy_in_bytes": copy_bytes, "graph_ms_samples": lat, "eager_ms_samples": eager}
        print(f"held Executor {name} (median of {LATENCY_SAMPLES}, host clock from an idle card): graph replay "
              f"{median(lat):.4f} ms, eager replay {median(eager):.4f} ms; copy-in {copy_ms * 1e3:.2f} us device time "
              f"({copy_bytes} bytes, {copy_ms / median(lat):.1%} of the replay)")
    return rows


def entry_point_timing(torch, att, ht, rg, smoke, entry, imad_per_s):
    """Phase 4 for decode_gemv, rglru_scan and htree_reduce: each at phase
    3g's inputs, CUDA-graph and eager ms, its plain version (decode_gemv on
    the CPU: PyTorch has no int32 matrix product on CUDA; the others on the
    card), torch.sum as the library call for the int32 H-tree, and the bound
    from this call's bytes and operations."""
    run = {"decode_gemv": att._gemv, "htree_reduce": ht._htree, "rglru_scan": rg._scan}
    plain = {"decode_gemv": att._gemv_plain, "htree_reduce": ht._htree_plain, "rglru_scan": rg._scan_plain}

    def width(a):
        return a.element_size() * a.numel()

    rows = []
    for r in entry:
        kernel, args = r["kernel"], r["args"]
        if kernel not in run:
            continue
        k_ms = graph_ms(torch, lambda: run[kernel](*args))
        k_eager = cuda_ms(torch, lambda: run[kernel](*args))
        if kernel == "decode_gemv":
            samples = []
            for _ in range(3):
                t = time.perf_counter()
                plain[kernel](*r["cpu_args"])
                samples.append((time.perf_counter() - t) * 1e3)
            p_ms, p_dev = median(sorted(samples)), "cpu"
        elif kernel == "htree_reduce":
            p_ms, p_dev = graph_ms(torch, lambda: plain[kernel](*args)), "cuda"
        else:  # T steps of a few elementwise kernels each: eager, one call after a warm-up
            p_ms, p_dev = cuda_ms(torch, lambda: plain[kernel](*args), reps=1, warmup=1), "cuda"
        lib_ms, lib_name, lib_reason, paired = None, None, ENTRY_NO_LIBRARY[kernel], {}
        if kernel == "decode_gemv" and all(a.dtype == torch.int8 for a in args):
            paired_ms, lib_ms, lib_reason = int_mm_yardstick(torch, smoke, kernel, r["case"],
                                                             lambda: run[kernel](*args), *args, r["want"])
            if paired_ms is not None:
                k_ms, lib_name = paired_ms, "torch._int_mm (transposed, paired rounds)"
        if kernel == "htree_reduce" and args[0].dtype == torch.int32:
            def lib(x):
                return torch.sum(x, 0, dtype=torch.int32)

            smoke.check(kernel, f"{r['case']} torch.sum library call", lib(*args), r["want"], exact=True)
            # kernel and torch.sum read in turns, warm and with inputs cold in L2
            for temp, pair in (("warm", (graph_timer(torch, lambda: run[kernel](*args)),
                                         graph_timer(torch, lambda: lib(*args)))),
                               ("cold", (cold_timer(torch, run[kernel], args), cold_timer(torch, lib, args)))):
                sums, _ = paired_rounds([pair], PAIRED_ROUNDS)
                paired[temp] = dict(sums, kernel_no_slower=sum(x <= y for x, y in zip(sums["kernel"], sums["library"])),
                                    ms=median(sorted(sums["kernel"])), library_ms=median(sorted(sums["library"])))
            k_ms, lib_ms, lib_name, lib_reason = paired["warm"]["ms"], paired["warm"]["library_ms"], "torch.sum", None
        out_bytes = width(r["want"])
        nbytes = sum(width(a) for a in args) + out_bytes
        if kernel == "decode_gemv":
            (m, k), int8 = args[0].shape, all(a.dtype == torch.int8 for a in args)
            # int8 products at the int8 peak, two operations a multiply-add;
            # any int32 operand on IMAD, one a multiply-add
            ops, rate = (2 * m * k, INT8_OPS_PER_S) if int8 else (m * k, imad_per_s)
        elif kernel == "rglru_scan":
            ops, rate = 2 * args[0].numel(), FP32_FLOP_PER_S  # one fma a step
        else:  # N - 1 adds a column; bfloat16 adds run in float32
            n, d = args[0].shape
            ops, rate = (n - 1) * d, imad_per_s if args[0].dtype == torch.int32 else FP32_FLOP_PER_S
        b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / rate * 1e3
        name = f"{kernel}[{r['case']}]"
        rows.append({
            "name": name, "route": "cuda", "source": ENTRY_SOURCES[kernel], "replaces": ENTRY_REPLACES[kernel],
            "launches": r["launches"], "max_abs_err": max(
                (c["max_abs_err"] or 0.0) for c in smoke.cases if c["kernel"] == kernel),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(b_bytes, b_ops),
            "bound_by": "operations" if b_ops > b_bytes else "bytes", "library_ms": lib_ms,
            "eager_ms": k_eager, "plain_device": p_dev, "library": lib_name, "library_none_reason": lib_reason,
            "launches_by_path": {name: r["launches"]}, "shapes": r["shapes"], "dtypes": r["dtypes"],
            "bytes": nbytes, "ops": ops,
        })
        if kernel in ("htree_reduce", "rglru_scan") and not paired:  # a warm reading can sit in the 50 MB L2
            cold = cold_timer(torch, run[kernel], args)
            rows[-1]["cold_ms"] = median(sorted(cold() for _ in range(3)))
            print(f"kernel {name}: cold L2 {rows[-1]['cold_ms'] * 1e3:.2f} us, "
                  f"{max(b_bytes, b_ops) / rows[-1]['cold_ms']:.1%} of the bound")
        if paired:
            rows[-1].update(cold_ms=paired["cold"]["ms"], library_cold_ms=paired["cold"]["library_ms"], rounds=paired)
            print(f"kernel {name} beside torch.sum, medians of {PAIRED_ROUNDS} paired rounds: warm "
                  f"{paired['warm']['ms'] * 1e3:.2f} us vs {paired['warm']['library_ms'] * 1e3:.2f} us (kernel no "
                  f"slower in {paired['warm']['kernel_no_slower']}), cold {paired['cold']['ms'] * 1e3:.2f} us vs "
                  f"{paired['cold']['library_ms'] * 1e3:.2f} us ({paired['cold']['kernel_no_slower']}); "
                  f"{max(b_bytes, b_ops) / paired['warm']['ms']:.1%} of the bound warm, "
                  f"{max(b_bytes, b_ops) / paired['cold']['ms']:.1%} cold")
        print(f"kernel {name}: {k_ms * 1e3:.2f} us in graph replay ({k_eager * 1e3:.2f} us eager; bound "
              f"{max(b_bytes, b_ops) * 1e3:.3f} us by {rows[-1]['bound_by']}, roofline share "
              f"{max(b_bytes, b_ops) / k_ms:.1%}) at {r['shapes']} {r['dtypes']}; plain {p_ms:.4f} ms on "
              f"{p_dev}; library {lib_ms}; launches {r['launches']} (eager + Executor replay)")
    return rows


def pimsab_cases(torch, np):
    """Phase 3h's calls: ``(kernel, call, CPU operands)`` for each registry
    kernel at tests/test_pimsab_conformance.py's inputs, drawn with numpy
    from its seeds; ``call(api, *operands)`` runs it through the API."""

    def ints(shape, lo, hi, seed):
        return torch.from_numpy(np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32))

    def normal(shape, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))

    def matmul(api, x, w):
        return api.matmul(api.SlicedTensor.from_int(x, 8), api.SlicedTensor.from_int(w, 8))

    onehot = torch.zeros(8, dtype=torch.int32)
    onehot[5] = 1
    a = torch.from_numpy((1.0 / (1.0 + np.exp(-normal((2, 8, 24), 3).double().numpy()))).astype(np.float32))
    return [
        ("bitslice_matmul", matmul, (ints((16, 32), -100, 100, 0), ints((32, 8), -100, 100, 1))),
        ("htree_reduce", lambda api, x: api.htree_reduce(x), (normal((16, 32), 2),)),
        ("rglru_scan", lambda api, a, b, h: api.rglru_scan(a, b, h), (a, normal((2, 8, 24), 4), normal((2, 24), 5))),
        ("ewise_add", lambda api, x, y: api.ewise_add(x, y), (ints((8, 32), -500, 500, 6), ints((8, 32), -500, 500, 7))),
        ("relu", lambda api, x: api.relu(x), (ints((8, 32), -500, 500, 8),)),
        ("conv2d", lambda api, x, w: api.conv2d(x, w, stride=2, padding=1),
         (ints((2, 3, 8, 8), -8, 8, 20), ints((4, 3, 3, 3), -100, 100, 21))),
        ("int_matmul", lambda api, x, w: api.int_matmul(x, w), (ints((8, 32), -200, 200, 22), ints((32, 8), -200, 200, 23))),
        ("maxpool2d", lambda api, x: api.maxpool2d(x, window=2), (ints((2, 4, 8, 8), -500, 500, 24),)),
        ("avgpool2d", lambda api, x: api.avgpool2d(x, window=2), (ints((2, 4, 8, 8), -500, 500, 25),)),
        ("global_avgpool", lambda api, x: api.global_avgpool(x), (ints((2, 8, 4, 4), -500, 500, 26),)),
        ("attention_qk", lambda api, q, k: api.attention_qk(q, k), (ints((2, 8), -10, 10, 27), ints((4, 8), -10, 10, 28))),
        ("softmax_fixedpoint", lambda api, x: api.softmax_fixedpoint(x, in_frac=7), (ints((4, 8), -400, 400, 29),)),
        ("attention_pv", lambda api, p, v: api.attention_pv(p, v), (ints((2, 8), 0, 64, 30), ints((8, 4), -100, 100, 31))),
        ("decode_gemv", lambda api, w, x: api.decode_gemv(w, x), (ints((8, 16), -50, 50, 32), ints((16,), -20, 20, 33))),
        ("kv_append", lambda api, c, n, o: api.kv_append(c, n, o),
         (ints((8, 4), -100, 100, 34), ints((4,), -100, 100, 35), onehot)),
    ]


def large_shape_workloads():
    """benchmarks/kernels_bench.py's large_shapes workloads, restated on the
    port's DSL: the paper-scale GEMM and the 64k-element add and relu."""
    from repro_torch.core.compiler.tensor_dsl import Loop, Ref, Workload

    return [
        Workload(name="matmul_256x1024x1024_i8",
                 loops=(Loop("x", 256, "data"), Loop("y", 1024, "data"), Loop("k", 1024, "reduce")),
                 out=Ref("c", ("x", "y"), prec=32),
                 ins=(Ref("a", ("x", "k"), prec=9), Ref("b", ("k", "y"), prec=9)), op="mac", acc_prec=32),
        Workload(name="ewise_add_65536_i16", loops=(Loop("i", 65536, "data"),), out=Ref("y", ("i",), prec=17),
                 ins=(Ref("xa", ("i",), prec=16), Ref("xb", ("i",), prec=16)), op="map_add", acc_prec=17),
        Workload(name="relu_65536_i16", loops=(Loop("i", 65536, "data"),), out=Ref("y", ("i",), prec=16),
                 ins=(Ref("xa", ("i",), prec=16), Ref("z", ("i",), prec=16, is_const=True, const_value=0)),
                 op="relu", acc_prec=16),
    ]


def run_pimsab_phase(torch, np, api, pb, resnet, smoke, dev):
    """Phase 3h: the eager pimsab backend with operands on the card.  Each
    registry kernel under ``api.use_backend("pimsab")`` (its result on the
    card, no launch counted) against the card kernel on the same operands;
    the large_shapes rows modeled on the full machine against
    BENCH_kernels.json; the paper-scale int_matmul on FUNCTIONAL_CFG_LARGE
    bit-equal to K1; the eager MICRO network bit-equal to its forward on the
    card; a call during a CUDA graph capture refused."""
    out = {"kernels": []}
    cases = pimsab_cases(torch, np)
    runs = []
    api.reset_launch_counts()
    for name, call, cpu_ops in cases:
        ops = [o.to(dev) for o in cpu_ops]
        api.clear_sim_report_log()
        t = time.perf_counter()
        with api.use_backend("pimsab"):
            got = call(api, *ops)
        wall = time.perf_counter() - t
        runs.append((name, call, ops, got, api.sim_report_log(), wall))
    counts = {k: v for k, v in api.launch_counts().items() if v}
    if counts:
        smoke.failures.append(f"phase 3h: pimsab calls counted launches {counts}")
    for name, call, ops, got, log, wall in runs:
        want = call(api, *ops)  # the card kernel on the same operands
        torch.cuda.synchronize()
        if got.device != want.device:
            smoke.failures.append(f"phase 3h {name}: result on {got.device}, operands on {want.device}")
        if [r.kernel for r in log] != [name]:
            smoke.failures.append(f"phase 3h {name}: reports {[r.kernel for r in log]}")
        tol = PIMSAB_TOL.get(name)
        err = smoke.check(f"pimsab:{name}", "conformance input vs the card kernel", got, want.cpu(),
                          exact=tol is None, tol=tol)
        rep = log[-1] if log else None
        out["kernels"].append({"kernel": name, "modeled_cycles": rep.total_cycles if rep else None,
                               "functional_instrs": rep.functional_instrs if rep else None,
                               "host_s": wall, "max_abs_err_vs_card": err, "shapes": [list(o.shape) for o in ops]})

    pinned = {r["workload"]: r for r in json.loads((ROOT / "BENCH_kernels.json").read_text())["large_shapes"]}
    out["large_shapes"] = []
    for w in large_shape_workloads():
        t = time.perf_counter()
        rep = pb.timing_report(w, kernel=w.name, tune=api.TuneConfig(**PIMSAB_TUNE))
        row = {"workload": w.name, "modeled_cycles": rep.total_cycles, "serialized_cycles": rep.serialized_cycles,
               "overlapped_cycles": rep.overlapped_cycles, "instrs": rep.instrs, "host_s": time.perf_counter() - t}
        want = pinned.get(w.name, {})
        if any(row[k] != want.get(k) for k in ("modeled_cycles", "serialized_cycles", "overlapped_cycles", "instrs")):
            smoke.failures.append(f"phase 3h large_shapes {w.name}: {row} != BENCH_kernels.json {want}")
        out["large_shapes"].append(row)

    (xs, ws, sx, sw) = PIMSAB_MATMUL
    x = torch.from_numpy(np.random.default_rng(sx).integers(-128, 128, xs).astype(np.int32)).to(dev)
    w = torch.from_numpy(np.random.default_rng(sw).integers(-128, 128, ws).astype(np.int32)).to(dev)
    api.reset_launch_counts()
    t = time.perf_counter()
    with pb.functional_config(pb.FUNCTIONAL_CFG_LARGE), api.use_backend("pimsab"):
        got = api.int_matmul(x, w, x_bits=8, w_bits=8)
        rep = api.last_sim_report()
    wall = time.perf_counter() - t
    if api.launch_counts():
        smoke.failures.append(f"phase 3h paper-scale int_matmul counted launches {api.launch_counts()}")
    want = api.int_matmul(x, w)  # K1
    torch.cuda.synchronize()
    smoke.check("pimsab:int_matmul", f"paper scale {xs}x{ws} on FUNCTIONAL_CFG_LARGE vs K1", got, want.cpu(), True)
    out["paper_scale_int_matmul"] = {"shape": [*xs, ws[1]], "host_s": wall, "modeled_cycles": rep.total_cycles,
                                     "functional_instrs": rep.functional_instrs,
                                     "bit_equal_to_k1": torch.equal(got.cpu(), want.cpu())}

    cfg = resnet.ResNetConfig(**PIMSAB_MICRO)
    model = resnet.ResNet(cfg, seed=SEED, device=dev)
    xin = resnet.make_input(cfg, 1, seed=SEED + 1, device=dev)
    api.clear_sim_report_log()
    api.reset_launch_counts()
    t = time.perf_counter()
    with torch.no_grad(), api.use_backend("pimsab"):
        logits = model(xin)
    wall = time.perf_counter() - t
    log = api.sim_report_log()
    if api.launch_counts():
        smoke.failures.append(f"phase 3h MICRO ResNet counted launches {api.launch_counts()}")
    if [r.kernel for r in log] != resnet.layer_names(cfg):
        smoke.failures.append(f"phase 3h MICRO ResNet reports {[r.kernel for r in log]}")
    with torch.no_grad():
        want = model(xin)
    smoke.check("pimsab:resnet", "MICRO eager logits vs the card's forward", logits, want.cpu(), True)
    out["micro_resnet"] = {"host_s": wall, "layers": len(log), "modeled_cycles": sum(r.total_cycles for r in log),
                           "logits_device": str(logits.device)}

    graph, refused = torch.cuda.CUDAGraph(), None
    y = torch.zeros(8, dtype=torch.int32, device=dev)
    stream = torch.cuda.Stream(dev)
    try:
        with torch.cuda.graph(graph, stream=stream), api.use_backend("pimsab"):
            api.relu(y)
    except api.PimsabTracerError as exc:
        refused = str(exc)
    torch.cuda.synchronize()
    if refused is None:
        smoke.failures.append("phase 3h: a pimsab call during a CUDA graph capture was not refused")
    out["capture_refused"] = refused is not None

    kernel_line = {r["kernel"]: [r["modeled_cycles"], round(r["host_s"], 4)] for r in out["kernels"]}
    print(f"phase 3h pimsab per kernel [modeled cycles, host s]: {json.dumps(kernel_line)}")
    print(f"phase 3h pimsab large_shapes: " + "; ".join(
        f"{r['workload']} {r['modeled_cycles']:g}/{r['serialized_cycles']:g}/{r['overlapped_cycles']:g} cycles, "
        f"{r['instrs']} instrs, {r['host_s']:.2f} s" for r in out["large_shapes"]))
    pm = out["paper_scale_int_matmul"]
    print(f"phase 3h pimsab paper-scale int_matmul {pm['shape']}: {pm['host_s']:.1f} s host wall, "
          f"{pm['modeled_cycles']:g} modeled cycles, bit-equal to K1: {pm['bit_equal_to_k1']}")
    print(f"phase 3h pimsab MICRO ResNet eager: {out['micro_resnet']['layers']} layers, "
          f"{out['micro_resnet']['host_s']:.2f} s host wall, logits on {out['micro_resnet']['logits_device']}; "
          f"capture refused: {out['capture_refused']}")
    return out


def pimsab_e2e_per_layer(rep):
    """``benchmarks/e2e_resnet.py``'s ``per_layer`` rows of a report."""
    return [{k: p[k] for k in ("node", "kernel", "total_cycles", "serialized_cycles", "dram_cycles")}
            for p in rep.per_kernel]


def pinned_equal(row, pinned):
    """``row`` equal to the pinned ``BENCH_kernels.json`` row, as JSON, but
    for ``energy_j`` within 1e-12 relative: a float sum whose last bit
    depends on the host's numpy, for the JAX package too."""
    row, pinned = json.loads(json.dumps(row)), dict(pinned)
    if "energy_j" in row or "energy_j" in pinned:
        a, b = row.pop("energy_j", None), pinned.pop("energy_j", None)
        if a is None or b is None or abs(a - b) > 1e-12 * abs(b):
            return False
    return row == pinned


def run_pimsab_program_phase(torch, np, api, pb, resnet, pimsab_step, smoke, dev):
    """Phase 3i: the pimsab Program lowering with operands on the card.  The
    bench chain, the traced TINY, RESNET18 timing-only and the resident-state
    decode step, each against the card Executor's graph replay of the same
    Program (or BENCH_kernels.json's rows), no launch counted on the pimsab
    side; a pimsab Executor called during a CUDA graph capture refused."""
    bench = json.loads((ROOT / "BENCH_kernels.json").read_text())
    out = {}

    def no_launch(label):
        counts = {k: v for k, v in api.launch_counts().items() if v}
        if counts:
            smoke.failures.append(f"phase 3i {label}: pimsab calls counted launches {counts}")

    def graph_replay(ex, *args):
        ex(*args)  # eager, then captured
        got = ex(*args)
        torch.cuda.synchronize()
        if ex.replay != "graph":
            smoke.failures.append(f"phase 3i: card Executor {ex.program.name!r} took the {ex.replay} route "
                                  f"({ex.replay_reason})")
        return got

    # (a) the bench chain: benchmarks/kernels_bench.py program_mode, restated
    rng = np.random.default_rng(0)
    x, w, y = (torch.from_numpy(rng.integers(-100, 100, s).astype(np.int32)).to(dev)
               for s in ((16, 8), (8, 16), (16, 16)))
    xs, ws = api.SlicedTensor.from_int(x, 8), api.SlicedTensor.from_int(w, 8)

    def chain(xs, ws, y):
        return api.relu(api.ewise_add(api.matmul(xs, ws), y))

    tune = api.TuneConfig(**PIMSAB_TUNE)
    api.reset_launch_counts()
    t = time.perf_counter()
    eager_reports = []
    with api.tuning(tune), api.use_backend("pimsab"):
        acc = api.matmul(xs, ws)
        eager_reports.append(api.last_sim_report())
        s_ = api.ewise_add(acc, y)
        eager_reports.append(api.last_sim_report())
        eager = api.relu(s_)
        eager_reports.append(api.last_sim_report())
    traced = api.trace(chain, name="bench_matmul_add_relu")
    before = api.compile_cache_info()
    with api.tuning(tune), api.use_backend("pimsab"):
        got = traced(xs, ws, y)
        rep = api.last_sim_report()
        pim = api.compile(traced.program_for(xs, ws, y))
    after = api.compile_cache_info()
    chain_s = time.perf_counter() - t
    no_launch("bench chain")
    card = graph_replay(api.compile(traced.program_for(xs, ws, y)), xs, ws, y)
    if got.device != dev or pim.replay != "pimsab":
        smoke.failures.append(f"phase 3i bench chain: output on {got.device}, route {pim.replay}")
    smoke.check("pimsab:program", "bench chain vs the card Executor's graph replay", got, card.cpu(), True)
    eager_dram = sum(r.cycles["dram"] for r in eager_reports)
    row = {
        "chain": list(rep.kernels),
        "bit_exact_vs_eager": bool(torch.equal(got, eager)),
        "modeled_cycles": rep.total_cycles,
        "serialized_cycles": rep.serialized_cycles,
        "overlapped_cycles": rep.overlapped_cycles,
        "critical_path": {k: round(v, 1) for k, v in rep.critical_path.items()},
        "utilization": {k: round(v, 4) for k, v in rep.utilization.items()},
        "dram_cycles": rep.cycles["dram"],
        "eager_dram_cycles_sum": eager_dram,
        "eager_modeled_cycles_sum": sum(r.total_cycles for r in eager_reports),
        "dram_cycle_win": eager_dram - rep.cycles["dram"],
        "elided_dram_bits": rep.elided_dram_bits,
        "resident_edges": list(rep.resident_edges),
        "per_kernel_cycles": {p["kernel"]: p["total_cycles"] for p in rep.per_kernel},
        "autotune": dict(rep.autotune),
        "compile_cache": {"second_compile_was_hit": after.hits > before.hits,
                          "misses_added": after.misses - before.misses},
    }
    if not pinned_equal(row, bench["program"]):
        smoke.failures.append(f"phase 3i bench chain: {row} != BENCH_kernels.json program {bench['program']}")
    out["program"] = {"host_s": chain_s, "modeled_cycles": rep.total_cycles, "dram_cycles": rep.cycles["dram"],
                      "row_equal": pinned_equal(row, bench["program"])}
    print(f"phase 3i pimsab bench chain: {chain_s:.3f} s host wall (3 eager calls, trace, tuned compile, run), "
          f"{rep.total_cycles:g} modeled cycles, DRAM {rep.cycles['dram']:g} against {eager_dram:g} eager; "
          f"BENCH_kernels.json program row equal: {out['program']['row_equal']}")

    # (b) the traced TINY: benchmarks/e2e_resnet.py run_tiny, restated
    cfg = resnet.TINY
    params = resnet.init_params(cfg, seed=0, device=dev)
    xin = resnet.make_input(cfg, batch=1, seed=1, device=dev)
    traced = api.trace(lambda p, v: resnet.forward(cfg, p, v), name="resnet_tiny")
    api.reset_launch_counts()
    before = api.compile_cache_info()
    t = time.perf_counter()
    with api.tuning(api.TuneConfig(**E2E_TUNE)), api.use_backend("pimsab"):
        logits = traced(params, xin)
        rep = api.last_sim_report()
        api.compile(traced.program_for(params, xin))
    tiny_s = time.perf_counter() - t
    after = api.compile_cache_info()
    no_launch("TINY")
    card_ex = api.compile(traced.program_for(params, xin))
    card = graph_replay(card_ex, params, xin)
    api.reset_launch_counts()
    card_ex(params, xin)
    torch.cuda.synchronize()
    tiny_launches = {k: v for k, v in api.launch_counts().items() if v}
    expected = {}
    for name in resnet.layer_names(cfg):
        expected[LAUNCHED_BY[name]] = expected.get(LAUNCHED_BY[name], 0) + 1
    if tiny_launches != expected:
        smoke.failures.append(f"phase 3i TINY card Executor replay launches {tiny_launches} != {expected}")
    if logits.device != dev:
        smoke.failures.append(f"phase 3i TINY: logits on {logits.device}")
    smoke.check("pimsab:resnet", "traced TINY vs the card Executor's graph replay", logits, card.cpu(), True)
    row = {
        "config": "TINY",
        "layers": len(rep.kernels),
        "kernels": list(rep.kernels),
        "bit_exact_vs_oracle": bool(torch.equal(logits, card)),
        "modeled_cycles": rep.total_cycles,
        "serialized_cycles": rep.serialized_cycles,
        "overlapped_cycles": rep.overlapped_cycles,
        "dram_cycles": rep.cycles["dram"],
        "modeled_seconds": rep.modeled_seconds,
        "energy_j": rep.energy_j,
        "cycle_breakdown": {k: round(v, 4) for k, v in rep.cycle_breakdown.items()},
        "utilization": {k: round(v, 4) for k, v in rep.utilization.items()},
        "resident_edges": list(rep.resident_edges),
        "elided_dram_bits": rep.elided_dram_bits,
        "per_layer": pimsab_e2e_per_layer(rep),
        "autotune": dict(rep.autotune),
        "compile_cache": {"second_compile_was_hit": after.hits > before.hits,
                          "misses_added": after.misses - before.misses},
    }
    tiny_equal = pinned_equal(row, bench["e2e"]["tiny"])
    if not tiny_equal:
        smoke.failures.append(f"phase 3i TINY: {row} != BENCH_kernels.json e2e.tiny")
    out["tiny"] = {"host_s": tiny_s, "layers": row["layers"], "modeled_cycles": rep.total_cycles,
                   "resident_edges": len(rep.resident_edges), "row_equal": tiny_equal,
                   "card_executor_launches": tiny_launches}
    print(f"phase 3i pimsab traced TINY: {tiny_s:.3f} s host wall (trace, tuned compile, run, second compile), "
          f"{row['layers']} layers, {rep.total_cycles:g} modeled cycles, {len(rep.resident_edges)} resident edges; "
          f"logits bit-equal to the card Executor ({tiny_launches} a replay): {torch.equal(logits, card)}; "
          f"e2e.tiny equal: {tiny_equal}")

    # (c) RESNET18, timing-only: benchmarks/e2e_resnet.py run_resnet18_timing, restated
    cfg = resnet.RESNET18
    api.reset_launch_counts()
    t = time.perf_counter()
    prog = api.trace(lambda p, v: resnet.forward(cfg, p, v), name="resnet18").trace(
        resnet.init_params(cfg, seed=0, device=dev), resnet.make_input(cfg, batch=1, seed=1, device=dev))
    rep = pb.timing_program_report(prog, tune=api.TuneConfig(**E2E_TUNE))
    rn18_s = time.perf_counter() - t
    no_launch("RESNET18 timing")
    row = {
        "config": "RESNET18",
        "layers": len(rep.kernels),
        "modeled_cycles": rep.total_cycles,
        "serialized_cycles": rep.serialized_cycles,
        "overlapped_cycles": rep.overlapped_cycles,
        "dram_cycles": rep.cycles["dram"],
        "modeled_seconds": rep.modeled_seconds,
        "energy_j": rep.energy_j,
        "cycle_breakdown": {k: round(v, 4) for k, v in rep.cycle_breakdown.items()},
        "resident_edges": len(rep.resident_edges),
        "elided_dram_bits": rep.elided_dram_bits,
        "per_layer": pimsab_e2e_per_layer(rep),
        "autotune": dict(rep.autotune),
    }
    rn18_equal = pinned_equal(row, bench["e2e"]["resnet18"])
    if not rn18_equal:
        smoke.failures.append(f"phase 3i RESNET18 timing: {row} != BENCH_kernels.json e2e.resnet18")
    out["resnet18_timing"] = {"host_s": rn18_s, "layers": row["layers"], "modeled_cycles": rep.total_cycles,
                              "resident_edges": row["resident_edges"], "row_equal": rn18_equal}
    print(f"phase 3i pimsab RESNET18 timing-only: {rn18_s:.3f} s host wall (trace, tuned timing compile), "
          f"{row['layers']} layers, {rep.total_cycles:g} modeled cycles, {row['resident_edges']} resident edges; "
          f"e2e.resnet18 equal: {rn18_equal}")

    # (d) the decode step with its caches bound as ResidentState
    scfg, cap = pimsab_step.AttnServeConfig(), PIMSAB_STATE_CAPACITY
    k_st, v_st = pimsab_step.kv_states(scfg, cap)
    prog = pimsab_step.decode_program(scfg, cap)
    card_ex = api.compile(prog)
    kc = torch.zeros((cap, scfg.head_dim), dtype=torch.int8, device=dev)
    vc = torch.zeros((cap, scfg.value_dim), dtype=torch.int8, device=dev)
    rng = np.random.default_rng(0)
    state_s, state_ok = 0.0, True
    for pos in range(PIMSAB_STATE_STEPS):
        q = torch.from_numpy(rng.integers(-7, 8, (1, scfg.head_dim)).astype(np.int8)).to(dev)
        kn = torch.from_numpy(rng.integers(-15, 16, scfg.head_dim).astype(np.int8)).to(dev)
        vn = torch.from_numpy(rng.integers(-100, 100, scfg.value_dim).astype(np.int8)).to(dev)
        onehot = torch.zeros(cap, dtype=torch.int8, device=dev)
        onehot[pos] = 1
        api.reset_launch_counts()
        t = time.perf_counter()
        pim = api.compile(prog, "pimsab", states={0: k_st, 1: v_st})
        got = pim(k_st.placeholder().to(dev), v_st.placeholder().to(dev), q, kn, vn, onehot)
        state_s += time.perf_counter() - t
        no_launch(f"decode step {pos}")
        want = card_ex(kc, vc, q, kn, vn, onehot)
        kc, vc = api.kv_append(kc, kn, onehot), api.kv_append(vc, vn, onehot)
        torch.cuda.synchronize()
        smoke.check("pimsab:program", f"resident-state decode step {pos} vs the card Executor", got, want.cpu(), True)
        smoke.check("pimsab:program", f"K handle after step {pos} vs the card's cache", k_st.value,
                    kc.cpu().to(torch.int64), True)
        smoke.check("pimsab:program", f"V handle after step {pos} vs the card's cache", v_st.value,
                    vc.cpu().to(torch.int64), True)
        state_ok = state_ok and got.device == dev and torch.equal(got, want)
    rep = api.last_sim_report()
    state_edges = [e for e in rep.resident_edges if "state:" in e]
    if len(state_edges) != 4:
        smoke.failures.append(f"phase 3i decode step: state edges {state_edges}")
    if card_ex.replay != "graph":
        smoke.failures.append(f"phase 3i decode step: the card Executor took the {card_ex.replay} route")
    out["resident_state"] = {"host_s": state_s, "steps": PIMSAB_STATE_STEPS, "state_edges": state_edges,
                             "bit_equal": state_ok, "modeled_cycles": rep.total_cycles}
    print(f"phase 3i pimsab resident-state decode_program(AttnServeConfig(), {cap}): {state_s:.3f} s host wall "
          f"for {PIMSAB_STATE_STEPS} steps (compile hit + run each), outputs bit-equal to the card Executor: "
          f"{state_ok}; state edges {state_edges}")

    # (e) a pimsab Executor called during a CUDA graph capture
    z = torch.zeros(8, dtype=torch.int32, device=dev)
    pim = api.compile(api.trace(lambda v: api.relu(v), name="pimsab_capture").program_for(z), "pimsab")
    graph, refused = torch.cuda.CUDAGraph(), None
    stream = torch.cuda.Stream(dev)
    try:
        with torch.cuda.graph(graph, stream=stream):
            pim(z)
    except api.PimsabTracerError as exc:
        refused = str(exc)
    torch.cuda.synchronize()
    if refused is None:
        smoke.failures.append("phase 3i: a pimsab Executor called during a CUDA graph capture was not refused")
    out["capture_refused"] = refused is not None
    print(f"phase 3i pimsab Executor during a CUDA graph capture refused: {out['capture_refused']}")
    return out


# ---------------------------------------------------------------------------
# phase 3j: the LLM serving path at Qwen2-0.5B's full width and depth
# ---------------------------------------------------------------------------


class LLMKernelRecorder:
    """While active, records each bit-sliced GEMM and q·Kᵀ call of the LLM
    path by (kernel, operand shapes): the count, and the first call's
    operands and output (clones) with the path the bit-sliced GEMM took;
    given the RG-LRU scan's module ``rg``, also every scan call's operands
    and output (``scans``)."""

    def __init__(self, torch, bm, att, rg=None):
        self.torch, self.bm, self.att, self.rg = torch, bm, att, rg
        self.calls = {}
        self.scans = []

    def _note(self, key, args, out, path=None):
        if key in self.calls:
            self.calls[key]["count"] += 1
            return
        self.calls[key] = {"count": 1, "path": path, "out": out.clone(),
                           "args": tuple(a.clone() if self.torch.is_tensor(a) else a for a in args)}

    def __enter__(self):
        bm, att = self.bm, self.att
        self.orig = orig_b, orig_q = bm._bitslice_gemm, att._qk

        def rec_b(x, w, slice_bits, pairs):
            out = orig_b(x, w, slice_bits, pairs)
            self._note(("bitslice_matmul", tuple(x.shape), tuple(w.shape)), (x, w, slice_bits, pairs), out,
                       bm.launched_path())
            return out

        def rec_q(q, k):
            out = orig_q(q, k)
            self._note(("attention_qk", tuple(q.shape), tuple(k.shape)), (q, k), out)
            return out

        bm._bitslice_gemm, att._qk = rec_b, rec_q
        if self.rg is not None:
            orig_s = self.orig_scan = self.rg._scan

            def rec_s(a, b, h0):
                out = orig_s(a, b, h0)
                self.scans.append((a.clone(), b.clone(), h0.clone(), out.clone()))
                return out

            self.rg._scan = rec_s
        return self

    def __exit__(self, *exc):
        self.bm._bitslice_gemm, self.att._qk = self.orig
        if self.rg is not None:
            self.rg._scan = self.orig_scan


LLM_MS = (1, LLM_REQUESTS, LLM_REQUESTS * 8, LLM_LONG[0])


def llm_bitslice_checks(torch, bm, smoke, dev, seed, kn=LLM_KN, ms=LLM_MS, groups=2):
    """Phase 2 for the LLM path's quantized linears: the bit-sliced GEMM at
    one int8 slice pair at every (K, N) of ``kn`` and M of ``ms`` (1: a
    decode token, LLM_REQUESTS: a decode step, 4 × 8 and 512: prefills), the
    weight a group's view of a (``groups``, K, N) stack as the path hands it
    (an untied head's is a whole (1, K, N) tensor); each bit-equal to its
    plain version and on the tensor cores."""
    g = torch.Generator().manual_seed(seed)
    for m in ms:
        for k, n in kn:
            x = torch.randint(-127, 128, (1, m, k), generator=g, dtype=torch.int8)
            w = torch.randint(-127, 128, (groups, k, n), generator=g, dtype=torch.int8)
            got = bm._bitslice_gemm(x.to(dev), w.to(dev)[groups - 1:], 8, ((0, 0),))
            torch.cuda.synchronize()
            smoke.check("bitslice_matmul", f"LLM linear M={m} K={k} N={n}", got,
                        bm._bitslice_plain(x, w[groups - 1:], 8, ((0, 0),)), exact=True)
            if bm.launched_path() != "mma":
                smoke.failures.append(f"bitslice_matmul LLM linear M={m} K={k} N={n}: the {bm.launched_path()} path")


def llm_k6_calls(cfg, batch, max_len):
    """Row-dot calls of one layer's int8 scores at ``batch`` rows of a
    ``max_len``-row cache: one for each group of batch rows."""
    from repro_torch.models import attention as tmattn

    hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    return -(-batch // tmattn.int8_scores_rows_per_call(batch, hkv, g, max_len))


def llm_expected(cfg, decode_steps, quant_kv, batch=LLM_REQUESTS, max_len=None):
    """Launches of one engine run: 7 bit-sliced GEMMs a layer in the prefill
    and in each decode step, and the row-dot calls of :func:`llm_k6_calls`
    a layer a decode step under quant_kv (the tied LM head is a float
    product)."""
    per_step = LLM_K4_PER_LAYER * cfg.n_layers
    want = {"bitslice_matmul": per_step * (1 + decode_steps)}
    if quant_kv:
        from repro_torch.launch import serve as serve_cli

        want["attention_qk"] = cfg.n_layers * decode_steps * llm_k6_calls(cfg, batch, max_len or serve_cli.MAX_LEN)
    return want


def llm_step_expected(cfg, quant_kv, batch=LLM_REQUESTS, max_len=None):
    """Launches of one decode step (see :func:`llm_expected`)."""
    want = llm_expected(cfg, 1, quant_kv, batch, max_len)
    want["bitslice_matmul"] = LLM_K4_PER_LAYER * cfg.n_layers
    return want


def llm_decode_profiles(torch, dev, arch=LLM_ARCH, quant_kvs=(False, True)):
    """For ``--replay-profiles``: LLM_PROFILE_STEPS eager decode steps of the
    launcher's engine at batch 4 (phase 3j's or 3l's weights), with and
    without quant_kv, under torch.profiler: device time by kernel, the
    bit-sliced GEMM's and the row dot's share of the busy time, the idle
    share."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer
    from repro_torch.serve import engine as serve_engine

    cfg = get_config(arch)
    params = transformer.init_params(cfg, SEED, device=dev)
    out = {}
    for quant_kv in quant_kvs:
        flags = dataclasses.replace(serve_cli.serve_flags(cfg=cfg), quant_kv=quant_kv)
        e = serve_engine.ServeEngine(cfg, params, flags, max_len=serve_cli.MAX_LEN)
        batch = e.prompt_batch(serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS))
        with torch.no_grad():
            cache, logits = e._prefill(e.params, batch)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            wall, names, _ = device_profile(torch, lambda: e._decode(e.params, cache, tok), LLM_PROFILE_STEPS)
        n = LLM_PROFILE_STEPS
        busy = sum(ms for _, ms in names.values())

        def part(*keys):
            hits = [(c, ms) for nm, (c, ms) in names.items() if any(k in nm for k in keys)]
            return sum(c for c, _ in hits) / n, sum(ms for _, ms in hits) / n

        k4_calls, k4_ms = part("bitslice")
        k6_calls, k6_ms = part("rowdot", "qk_generic")
        out[f"decode step b{LLM_REQUESTS} quant_kv={quant_kv}"] = {
            "steps": n, "wall_ms_per_step": wall / n, "device_busy_ms_per_step": busy / n if names else None,
            "device_kernels_per_step": sum(c for c, _ in names.values()) / n,
            "idle_share": 1 - busy / wall if names else None,
            "k4_launches_per_step": k4_calls, "k4_ms_per_step": k4_ms, "k4_share_of_busy": k4_ms * n / busy if busy else None,
            "k6_launches_per_step": k6_calls, "k6_ms_per_step": k6_ms, "k6_share_of_busy": k6_ms * n / busy if busy else None,
            "kernels": sorted(([nm, c / n, ms / n] for nm, (c, ms) in names.items()), key=lambda q: -q[2])[:12],
        }
    return out


def serve_params_pair(torch, common, transformer, smoke, cfg, raw, flags, label):
    """The serving parameters of ``raw`` (on the card) on the card and on a
    CPU copy, each quantized on its own device under ``quant_serve``; the
    quantized weights must be bit-equal."""
    raw_cpu = transformer._tree_map(lambda a: a.cpu(), raw)
    p_card = common.maybe_quantize_tree(raw, cfg) if flags.quant_serve else raw
    p_cpu = common.maybe_quantize_tree(raw_cpu, cfg) if flags.quant_serve else raw_cpu
    mism = [n for n, (a, b) in enumerate(zip(transformer._tree_leaves(p_card), transformer._tree_leaves(p_cpu)))
            if not torch.equal(a.cpu(), b)]
    if mism:
        smoke.failures.append(f"{label}: quantized weights differ from the CPU's at leaves {mism}")
    return p_card, p_cpu


def card_vs_cpu(torch, common, transformer, smoke, dev, cfg, raw, flags, label, rel, extra=None, pair=None):
    """The port on the card against the same port on CPU copies of the same
    weights ``raw`` (on the card, config ``cfg``; or the ``pair`` of
    :func:`serve_params_pair`): the quantized weights bit-equal, the
    prefill's and LLM_CPU_STEPS decode steps' logits within ``rel`` of the
    CPU's largest logit, greedy tokens equal where the CPU's top-2 margin
    exceeds twice that.  Each decode step is fed the CPU's greedy tokens;
    ``extra`` adds CPU tensors to the prefill batch (an encoder–decoder's
    frame embeddings).  Returns the errors."""
    dtype = str(transformer.dtype_of(cfg)).replace("torch.", "")
    p_card, p_cpu = pair or serve_params_pair(torch, common, transformer, smoke, cfg, raw, flags, label)
    toks = torch.randint(2, cfg.vocab_size, (LLM_REQUESTS, 8), generator=torch.Generator().manual_seed(SEED + 2),
                         dtype=torch.int32)
    batch = {"tokens": toks, **(extra or {})}
    batch_card = {k: v.to(dev) for k, v in batch.items()}
    out = {"errors": [], "atol": [], "greedy_covered": 0, "positions": 0, "rel": rel}

    def compare(step, got, want):
        got, want = got.float().cpu(), want.float()
        atol = rel * float(want.abs().max())
        err = float((got - want).abs().max())
        top2 = torch.topk(want, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * atol
        same = torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
        out["errors"].append(err)
        out["atol"].append(atol)
        out["greedy_covered"] += int(sure.sum())
        out["positions"] += sure.numel()
        finite = bool(torch.isfinite(got).all())
        smoke.cases.append({"kernel": "llm", "case": f"{label} {step}", "ok": err <= atol and same and finite,
                            "max_abs_err": err, "exact": False, "shape": list(got.shape), "dtype": dtype})
        if not (err <= atol and same and finite):
            smoke.failures.append(f"{label} {step}: max |card - cpu| {err} > {atol}, or greedy tokens differ "
                                  f"where the margin exceeds {2 * atol}, or non-finite")

    with torch.no_grad():
        cache_d, got = transformer.prefill(p_card, cfg, batch_card, flags, max_len=16)
        cache_c, want = transformer.prefill(p_cpu, cfg, batch, flags, max_len=16)
        compare("prefill", got, want)
        if dtype == "bfloat16" and not flags.quant_kv and cfg.tie_embeddings:
            # the tied LM head (a bfloat16 cuBLAS product) with PyTorch's default
            # reduced-precision reductions against them off, for this call only
            matmul = torch.backends.cuda.matmul
            saved = matmul.allow_bf16_reduced_precision_reduction
            try:
                matmul.allow_bf16_reduced_precision_reduction = not saved
                _, other = transformer.prefill(p_card, cfg, batch_card, flags, max_len=16)
            finally:
                matmul.allow_bf16_reduced_precision_reduction = saved
            out["bf16_reduced_precision_reduction"] = {
                str(saved): out["errors"][0], str(not saved): float((other.float().cpu() - want.float()).abs().max())}
        for step in range(LLM_CPU_STEPS):
            nt = torch.argmax(want, -1).to(torch.int32)[:, None]
            cache_d, got = transformer.decode_step(p_card, cfg, cache_d, nt.to(dev), flags)
            cache_c, want = transformer.decode_step(p_cpu, cfg, cache_c, nt, flags)
            compare(f"decode step {step}", got, want)
    torch.cuda.synchronize()
    print(f"{label}: max |card - cpu| {[f'{e:.3g}' for e in out['errors']]} against "
          f"{[f'{a:.3g}' for a in out['atol']]} ({rel:g} of the CPU's largest logit); the greedy check "
          f"covered {out['greedy_covered']} of {out['positions']} positions (top-2 margin above twice the limit)"
          + (f"; bf16 reduced-precision reductions {out['bf16_reduced_precision_reduction']}"
             if "bf16_reduced_precision_reduction" in out else ""))
    return out


def llm_card_vs_cpu(torch, common, transformer, smoke, dev, cfg, flags, dtype):
    """(c): the port at full width and LLM_CPU_LAYERS layers on the card
    against the same port on CPU copies of the same weights
    (:func:`card_vs_cpu`)."""
    import dataclasses

    c2 = dataclasses.replace(cfg, n_layers=LLM_CPU_LAYERS, dtype=dtype)
    raw = transformer.init_params(c2, SEED, device=dev)
    label = f"phase 3j card vs CPU {dtype} {LLM_CPU_LAYERS} layers quant_kv={flags.quant_kv}"
    return card_vs_cpu(torch, common, transformer, smoke, dev, c2, raw, flags, label, LLM_TOL[dtype])


def check_recorded(torch, bm, att, smoke, rec, phase, tag, want_keys):
    """The recorder's K4 and K6 shapes must be ``want_keys`` (any, if None); each shape's
    first call is held bit-equal to its plain version on the CPU (timed),
    and every bit-sliced call must have taken the tensor cores."""
    if want_keys is not None and set(rec.calls) != want_keys:
        smoke.failures.append(f"{phase}: kernel shapes {sorted(rec.calls)} != expected {sorted(want_keys)}")
    for key, c in sorted(rec.calls.items()):
        args = [a.cpu() if torch.is_tensor(a) else a for a in c["args"]]
        t = time.perf_counter()
        plain = bm._bitslice_plain(*args) if key[0] == "bitslice_matmul" else att._qk_plain(*args)
        c["plain_ms"] = (time.perf_counter() - t) * 1e3
        c["max_abs_err"] = smoke.check(key[0], f"{phase} {tag} {key[1]}x{key[2]}", c["out"], plain, exact=True)
        if key[0] == "bitslice_matmul" and c["path"] != "mma":
            smoke.failures.append(f"{phase}: the bit-sliced GEMM at {key[1:]} took the {c['path']} path")


def drive_engine(torch, api, smoke, rec, phase, label, eng, reqs, vp, out, path_counts, want_of):
    """One ``engine.run`` of ``reqs`` with the launch counters reset just
    before it and read just after, inside the kernel recorder ``rec``: the
    counts must equal ``want_of(decode steps)``, and every request must get
    its full stream of tokens in the vocabulary.  Records the run in
    ``out["runs"]`` and adds its counts to ``path_counts``."""
    api.reset_launch_counts()
    with rec:
        t = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = {k: v for k, v in api.launch_counts().items() if v}
    steps = max(len(r.generated) for r in done)
    want = want_of(steps - 1)
    if counts != want:
        smoke.failures.append(f"{phase} {label}: launches {counts} != expected {want}")
    bad = [r.rid for r in done if len(r.generated) != r.max_new_tokens
           or not all(0 <= tok < vp for tok in r.generated)]
    if bad:
        smoke.failures.append(f"{phase} {label}: requests {bad} got no full stream of tokens in the vocabulary")
    ntok = sum(len(r.generated) for r in done)
    for k, v in counts.items():
        path_counts[k] = path_counts.get(k, 0) + v
    out["runs"][label] = {"launches": counts, "expected": want, "tokens": ntok, "first_run_s": wall,
                          "streams": [r.generated for r in done]}
    print(f"{phase} {label}: {len(done)} requests, {ntok} tokens, launches {counts} (expected {want}); "
          f"first run {wall:.3f} s; req 0 {done[0].generated[:8]}")
    return done


def step_launches(torch, api, smoke, label, e, reqs, vp, want_prefill, want_decode, digests=None):
    """One prefill and one decode step of engine ``e`` on ``reqs``, each
    with the counters reset around it and held to ``want_prefill`` and
    ``want_decode``; the logits must be (B, vp), finite, in the config's
    dtype.  Returns (the counts, (e, batch, cache, next tokens)); the two
    logits' sha256 go to ``digests`` (a dict) when one is given."""
    batch = e.prompt_batch(reqs)
    with torch.no_grad():
        api.reset_launch_counts()
        cache, logits = e._prefill(e.params, batch)
        torch.cuda.synchronize()
        pre = {k: v for k, v in api.launch_counts().items() if v}
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        api.reset_launch_counts()
        _, logits2 = e._decode(e.params, cache, tok)
        torch.cuda.synchronize()
        dec = {k: v for k, v in api.launch_counts().items() if v}
    for what, got, want in (("prefill", pre, want_prefill), ("decode step", dec, want_decode)):
        if got != want:
            smoke.failures.append(f"{label} {what}: launches {got} != {want}")
    dtype = e.params["embed"]["w"].dtype
    for lg in (logits, logits2):
        if lg.shape != (batch["tokens"].shape[0], vp) or lg.dtype != dtype or not bool(torch.isfinite(lg).all()):
            smoke.failures.append(f"{label}: logits {tuple(lg.shape)} {lg.dtype}, finite "
                                  f"{bool(torch.isfinite(lg).all())}")
    if digests is not None:
        digests.update(prefill=tensor_sha256(torch, logits), decode_step=tensor_sha256(torch, logits2))
    return {"prefill": pre, "decode_step": dec}, (e, batch, cache, tok)


def run_llm_phase(torch, api, bm, att, smoke, dev, gpu, dist_run=None):
    """Phase 3j: ``repro_torch.launch.serve``'s main path at Qwen2-0.5B's
    full width and depth on the card (module docstring, 3j); the 4 × 8
    prefill's and decode step's logits held to phase 3n's (``dist_run``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import attention as tmattn
    from repro_torch.models import common, transformer
    from repro_torch.serve import engine as serve_engine

    cfg = get_config(LLM_ARCH)
    flags = serve_cli.serve_flags()
    flags_kv = dataclasses.replace(flags, quant_kv=True)
    vp = cfg.padded_vocab()
    t = time.perf_counter()
    params = transformer.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    out = {"gpu": gpu, "arch": LLM_ARCH, "init_s": time.perf_counter() - t,
           "param_bytes": transformer.param_bytes(params), "runs": {}}
    rec = LLMKernelRecorder(torch, bm, att)
    path_counts = {}

    def drive(label, eng, reqs, quant_kv):
        return drive_engine(torch, api, smoke, rec, "phase 3j", label, eng, reqs, vp, out, path_counts,
                            lambda steps: llm_expected(cfg, steps, quant_kv))

    info0 = api.compile_cache_info()
    eng = serve_engine.ServeEngine(cfg, params, flags, max_len=serve_cli.MAX_LEN)
    drive("launcher 4x8", eng, serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS), False)
    again = serve_engine.ServeEngine(cfg, params, flags, max_len=serve_cli.MAX_LEN)
    info1 = api.compile_cache_info()
    hit = ((info1.hits, info1.misses) == (info0.hits + 2, info0.misses + 2)
           and again._decode is eng._decode and again._prefill is eng._prefill)
    if not hit:
        smoke.failures.append(f"phase 3j: the second engine did not hit the compile cache ({info0} -> {info1})")
    out["second_engine_cache_hit"] = hit
    prompt, max_len = LLM_LONG
    eng_long = serve_engine.ServeEngine(cfg, params, flags, max_len=max_len)
    drive(f"1x{prompt} chunked prefill", eng_long,
          serve_cli.make_requests(cfg, 1, LLM_NEW_TOKENS, seed=SEED + 1, prompt_len=prompt), False)
    eng_kv = serve_engine.ServeEngine(cfg, params, flags_kv, max_len=serve_cli.MAX_LEN)
    drive("launcher 4x8 quant_kv", eng_kv, serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS), True)
    out["path_launches"] = path_counts

    # one prefill and one decode step, each with the counters reset around it
    per_step = {}
    steps = {}
    out["logits_digests"] = {}  # the 4 x 8 step's, held to phase 3n's
    for label, e, reqs in (("4x8", eng, serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS)),
                           (f"1x{prompt}", eng_long, serve_cli.make_requests(cfg, 1, 1, SEED + 1, prompt)),
                           ("4x8 quant_kv", eng_kv, serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS))):
        per_step[label], steps[label] = step_launches(
            torch, api, smoke, f"phase 3j {label}", e, reqs, vp, llm_expected(cfg, 0, False),
            llm_step_expected(cfg, e.flags.quant_kv), out["logits_digests"] if label == "4x8" else None)
    out["per_step_launches"] = per_step
    print(f"phase 3j launches a step: {per_step}; second engine a compile-cache hit: {hit}")
    if dist_run is not None:
        serving = dist_run.get("serving", {})
        out["dist_differ"] = hold_to_dist_digests(
            smoke, "phase 3j", "4x8 prefill and decode step logits", out["logits_digests"],
            serving.get("logits_digests"), serving.get("logits_shape", []), serving.get("logits_dtype", ""))

    # (a) K4 and K6 against their plain versions at every shape the path gave them
    k4_keys = {("bitslice_matmul", (1, m, k), (1, k, n)) for m in (LLM_REQUESTS * 8, LLM_REQUESTS, prompt, 1)
               for k, n in LLM_KN}
    hd, hkv, g = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    rows = tmattn.int8_scores_rows_per_call(LLM_REQUESTS, hkv, g, serve_cli.MAX_LEN)
    k6_keys = {("attention_qk", (r * hkv * g, hd), (r * serve_cli.MAX_LEN * hkv, hd))
               for r in {min(rows, LLM_REQUESTS - lo) for lo in range(0, LLM_REQUESTS, rows)}}
    check_recorded(torch, bm, att, smoke, rec, "phase 3j", "LLM", k4_keys | k6_keys)

    # (c) card against CPU copies, full width, LLM_CPU_LAYERS layers
    out["card_vs_cpu"] = {
        "bfloat16": llm_card_vs_cpu(torch, common, transformer, smoke, dev, cfg, flags, "bfloat16"),
        "bfloat16_quant_kv": llm_card_vs_cpu(torch, common, transformer, smoke, dev, cfg, flags_kv, "bfloat16"),
        "float32": llm_card_vs_cpu(torch, common, transformer, smoke, dev, cfg, flags, "float32"),
    }
    out["recorder"] = rec
    out["steps"] = steps
    return out


def engine_latency(torch, steps, arch, gpu, samples=LLM_TIMING_SAMPLES):
    """Host-clock latencies from an idle card of each engine's prefill and
    decode step in ``steps`` (label → (engine, batch, cache, next tokens)),
    medians of ``samples`` (a prompt of 64 tokens or more: a quarter)."""
    lat = {}
    with torch.no_grad():
        for label, (e, batch, cache, tok) in steps.items():
            n = samples if batch["tokens"].shape[1] < 64 else max(1, samples // 4)
            pre = sync_samples(torch, lambda: e._prefill(e.params, batch), n)
            dec = sync_samples(torch, lambda: e._decode(e.params, cache, tok), samples)
            b = batch["tokens"].shape[0]
            lat[label] = {"prefill_ms_median": median(pre), "decode_step_ms_median": median(dec),
                          "decode_tokens_per_s": b / median(dec) * 1e3, "prefill_ms": pre, "decode_step_ms": dec}
            print(f"phase 4 LLM {arch} {label} ({gpu}): prefill {median(pre):.3f} ms, decode step "
                  f"{median(dec):.3f} ms ({b / median(dec) * 1e3:.1f} tokens/s at batch {b}), eager, host clock "
                  f"from an idle card, medians of {n} and {samples}")
    return lat


def llm_timing(torch, bm, att, smoke, llm, floor_ms):
    """Phase 4 for 3j: host-clock latencies from an idle card (prefill 4 × 8
    and 1 × 512, the decode step at batch 4 with and without quant_kv and at
    batch 1 on the 1024-row cache, medians), a second engine run end to
    end; each K4 and K6 shape of the path (:func:`recorded_kernel_rows`).
    Returns (summary, kernel rows)."""
    from repro_torch.launch import serve as serve_cli

    gpu = llm["gpu"]
    lat = engine_latency(torch, llm["steps"], LLM_ARCH, gpu)
    with torch.no_grad():
        e = llm["steps"]["4x8"][0]
        reqs = serve_cli.make_requests(e.cfg, LLM_REQUESTS, LLM_NEW_TOKENS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = e.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    ntok = sum(len(r.generated) for r in done)
    lat["engine_run"] = {"tokens": ntok, "s": wall, "tokens_per_s": ntok / wall}
    print(f"phase 4 LLM {LLM_ARCH} engine.run 4 requests x {LLM_NEW_TOKENS} tokens ({gpu}): {wall * 1e3:.1f} ms, "
          f"{ntok / wall:.1f} tokens/s (second run)")
    return lat, recorded_kernel_rows(torch, bm, att, smoke, llm["recorder"], e.cfg, floor_ms, "llm", "llm_serving",
                                     gpu)


def recorded_kernel_rows(torch, bm, att, smoke, rec, cfg, floor_ms, tag, path, gpu):
    """Each K4 and K6 shape of a recorded path by CUDA-graph replay and
    eagerly, beside its bound, its plain version (CPU) and torch._int_mm
    where it takes the shape: the kernel rows."""
    hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    rows = []
    for key, c in sorted(rec.calls.items()):
        kernel, sa, sb = key
        call_work = None
        if kernel == "bitslice_matmul":
            x, w, slice_bits, pairs = c["args"]
            run = lambda x=x, w=w, s=slice_bits, p=pairs: bm._bitslice_gemm(x, w, s, p)  # noqa: E731
            nbytes, ops = bitslice_work(x, w, slice_bits, pairs)
            m, k, n = x.shape[1], x.shape[2], w.shape[2]
            name = f"bitslice_matmul[{tag} M={m} K={k} N={n}]"
            lib = (lambda x0=x[0], w0=w[0]: torch._int_mm(x0, w0)) if m > 16 else None
            lib_want = c["out"]
            source, replaces = BITSLICE_SOURCE, BITSLICE_REPLACES
        else:
            q, kk = c["args"]
            run = lambda q=q, kk=kk: att._qk(q, kk)  # noqa: E731
            # the bound is the contraction the path needs: the call's R batch
            # rows of (Hkv·G, d) queries each against its own (T, d) KV head
            # (the call computes R·Hkv times those products, kept as call_work)
            d = q.shape[1]
            r = q.shape[0] // (hkv * g)
            t = kk.shape[0] // (r * hkv)
            nbytes = r * hkv * g * d + r * t * hkv * d + 4 * r * hkv * g * t
            ops = 2 * r * hkv * g * t * d
            call_work = {"bytes": q.numel() + kk.numel() + 4 * c["out"].numel(),
                         "ops": 2 * q.shape[0] * kk.shape[0] * d, "batch_rows": r, "cache_rows": t}
            name = f"attention_qk[{tag} quant_kv M={q.shape[0]} T={kk.shape[0]} D={d}]"
            qt = q.t().contiguous()
            lib = lambda kk=kk, qt=qt: torch._int_mm(kk, qt)  # noqa: E731
            lib_want = c["out"].t()
            source, replaces = ATTN_SOURCE, ATTN_REPLACES["attention_qk"]
        k_timer = graph_timer(torch, run)
        eager = cuda_ms(torch, run)
        lib_ms = rounds = None
        if lib is not None:
            smoke.check(kernel, f"{name} torch._int_mm library call", lib(), lib_want.cpu(), exact=True)
            sums, _ = paired_rounds([(k_timer, graph_timer(torch, lib))], PAIRED_ROUNDS)
            k_ms, lib_ms = median(sorted(sums["kernel"])), median(sorted(sums["library"]))
            rounds = dict(sums, kernel_no_slower=sum(a <= b for a, b in zip(sums["kernel"], sums["library"])))
        else:
            k_ms = k_timer()
        b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": c["count"],
            "max_abs_err": c["max_abs_err"], "ms": k_ms, "plain_ms": c["plain_ms"],
            "bound_ms": max(b_bytes, b_ops), "bound_by": "operations" if b_ops > b_bytes else "bytes",
            "library_ms": lib_ms, "eager_ms": eager, "plain_device": "cpu", "path": path,
            "library": "torch._int_mm" if lib is not None else None,
            "library_note": None if lib is not None else "torch._int_mm needs more than 16 rows in its first operand",
            "kernel_path": c["path"], "rounds": rounds, "bytes": nbytes, "ops": ops, "call_work": call_work,
            "launches_by_path": {path: c["count"]}, "floors": k_ms / floor_ms,
        })
        print(f"kernel {name}: {k_ms * 1e3:.3f} us graph replay ({eager * 1e3:.3f} us eager; bound "
              f"{max(b_bytes, b_ops) * 1e3:.3f} us by {rows[-1]['bound_by']}, roofline share "
              f"{max(b_bytes, b_ops) / k_ms:.1%}, {k_ms / floor_ms:.2f} launch floors), plain {c['plain_ms']:.2f} ms "
              f"on the CPU, torch._int_mm {lib_ms}; {c['count']} launches on the {path} path ({gpu})")
    return rows


# ---------------------------------------------------------------------------
# phase 3l: the families beyond decoder-only attention at full width
# ---------------------------------------------------------------------------


def fam_k4(cfg, prefill):
    """Bit-sliced GEMM launches of one prefill or decode step: each quantized
    linear once (``models/transformer.py``): a block's mixer, a dense FFN's
    three (the MoE experts and router are float products), the
    cross-attention's wq and wo (and wk, wv over the encoder's output in the
    prefill), an untied head; in the prefill also the audio adapter and each
    encoder block's 7."""
    n = 0
    for kind in cfg.layer_kinds():
        n += K4_PER_MIXER[kind]
        if cfg.d_ff > 0 and kind in ("attn", "local_attn", "rglru") and not cfg.is_moe:
            n += 3
        if cfg.is_encdec:
            n += 4 if prefill else 2
    if cfg.is_encdec and prefill:
        n += 1 + 7 * cfg.n_enc_layers
    return n + (0 if cfg.tie_embeddings else 1)


def fam_k6(cfg, batch, max_len):
    """Row-dot calls of one quant_kv decode step: each attention layer's
    int8 scores over its cache (a local-attention layer's holds
    min(window, max_len) rows)."""
    n = 0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "local_attn"):
            n += llm_k6_calls(cfg, batch, min(cfg.window, max_len) if kind == "local_attn" else max_len)
    return n


def fam_expected(cfg, decode_steps, quant_kv, batch, max_len):
    """Launches of an engine run with ``decode_steps`` decode steps: K4 a
    prefill and a step (:func:`fam_k4`), K11 once for each RG-LRU layer of
    the prefill (a decode step is elementwise), K6 a quant_kv step
    (:func:`fam_k6`)."""
    want = {"bitslice_matmul": fam_k4(cfg, True) + decode_steps * fam_k4(cfg, False)}
    n_rglru = sum(kind == "rglru" for kind in cfg.layer_kinds())
    if n_rglru:
        want["rglru_scan"] = n_rglru
    if quant_kv and decode_steps and fam_k6(cfg, batch, max_len):
        want["attention_qk"] = decode_steps * fam_k6(cfg, batch, max_len)
    return want


def fam_step_expected(cfg, quant_kv, batch, max_len):
    """Launches of one decode step (see :func:`fam_expected`)."""
    want = {"bitslice_matmul": fam_k4(cfg, False)}
    if quant_kv and fam_k6(cfg, batch, max_len):
        want["attention_qk"] = fam_k6(cfg, batch, max_len)
    return want


def cut_to(transformer, cfg, params, groups, enc_layers):
    """The config and parameters of ``params``'s first ``groups`` pattern
    groups (and first ``enc_layers`` encoder blocks): views, no copy."""
    import dataclasses

    cut = dict(params, blocks=transformer._tree_map(lambda a: a[:groups], params["blocks"]))
    kw = {"n_layers": groups * len(cfg.block_pattern)}
    if cfg.is_encdec:
        cut["enc_blocks"] = transformer._tree_map(lambda a: a[:enc_layers], params["enc_blocks"])
        kw["n_enc_layers"] = enc_layers
    return dataclasses.replace(cfg, **kw), cut


def fam_extra(torch, cfg, batch=LLM_REQUESTS):
    """An encoder–decoder's frame embeddings for a card-vs-CPU check: seeded
    normals (the engine feeds zeros), on the CPU."""
    if not cfg.is_encdec:
        return None
    g = torch.Generator().manual_seed(SEED + 3)
    return {"enc_embeds": torch.randn((batch, cfg.enc_seq_len, cfg.d_model), generator=g).to(torch.bfloat16)}


def fam_loss(torch, transformer, smoke, cfg, params, flags, dev, label):
    """``loss_fn`` on the card at the card's depth: a finite ce and aux (aux
    above 0 for a mixture of experts)."""
    g = torch.Generator().manual_seed(SEED + 4)
    toks = torch.randint(2, cfg.vocab_size, (LLM_REQUESTS, 8), generator=g, dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (LLM_REQUESTS, 8), generator=g, dtype=torch.int32)
    batch = {"tokens": toks.to(dev), "labels": labels.to(dev)}
    extra = fam_extra(torch, cfg)
    if extra:
        batch.update({k: v.to(dev) for k, v in extra.items()})
    with torch.no_grad():
        loss, parts = transformer.loss_fn(params, cfg, batch, flags)
    ce, aux = float(parts["ce"]), float(parts["aux"])
    ok = all(map(lambda v: v == v and abs(v) != float("inf"), (float(loss), ce, aux))) and (aux > 0) == cfg.is_moe
    if not ok:
        smoke.failures.append(f"{label} loss_fn: loss {float(loss)}, ce {ce}, aux {aux}")
    return {"loss": float(loss), "ce": ce, "aux": aux}


def scan_checks(torch, rg, smoke, rec, label):
    """Every RG-LRU scan call of the recorded runs against its plain version
    at the call's inputs (on the card: each step one exact fma), the
    recurrence's float32 values within 1e-4.  Returns the shapes seen with
    their counts."""
    shapes = {}
    for a, b, h0, out in rec.scans:
        shape = tuple(a.shape)
        shapes[shape] = shapes.get(shape, 0) + 1
        smoke.check("rglru_scan", f"{label} {shape} call {shapes[shape]}", out, rg._scan_plain(a, b, h0).cpu(),
                    exact=False, tol=1e-4)
    return shapes


def run_families_phase(torch, api, bm, att, rg, smoke, dev, gpu):
    """Phase 3l (module docstring): RecurrentGemma-2B through the launcher's
    main path at full width and depth with K4, K6 and K11 counted and held,
    then xLSTM-1.3B, Whisper-medium and DBRX-132B (2 layers); each against
    CPU copies of its first pattern groups and through ``loss_fn``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import attention as tmattn
    from repro_torch.models import common, transformer
    from repro_torch.serve import engine as serve_engine

    t_phase = time.perf_counter()
    cfg = get_config(FAM_ARCH)
    flags = serve_cli.serve_flags(cfg=cfg)
    flags_kv = dataclasses.replace(flags, quant_kv=True)
    vp = cfg.padded_vocab()
    t = time.perf_counter()
    params = transformer.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    out = {"gpu": gpu, "arch": FAM_ARCH, "init_s": time.perf_counter() - t,
           "param_bytes": transformer.param_bytes(params), "runs": {}, "others": {}}
    rec = LLMKernelRecorder(torch, bm, att, rg)
    path_counts = {}

    def drive(label, eng, reqs, quant_kv):
        return drive_engine(torch, api, smoke, rec, "phase 3l", label, eng, reqs, vp, out, path_counts,
                            lambda steps: fam_expected(cfg, steps, quant_kv, len(reqs), eng.max_len))

    prompt, long_len = LLM_LONG
    eng = serve_engine.ServeEngine(cfg, params, flags, max_len=serve_cli.MAX_LEN)
    eng_long = serve_engine.ServeEngine(cfg, params, flags, max_len=long_len)
    eng_kv = serve_engine.ServeEngine(cfg, params, flags_kv, max_len=serve_cli.MAX_LEN)
    drive("launcher 4x8", eng, serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS), False)
    drive(f"1x{prompt} chunked prefill", eng_long,
          serve_cli.make_requests(cfg, 1, LLM_NEW_TOKENS, seed=SEED + 1, prompt_len=prompt), False)
    drive("launcher 4x8 quant_kv", eng_kv, serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS), True)
    out["path_launches"] = path_counts

    per_step, steps = {}, {}
    for label, e, reqs in (("4x8", eng, serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS)),
                           (f"1x{prompt}", eng_long, serve_cli.make_requests(cfg, 1, 1, SEED + 1, prompt)),
                           ("4x8 quant_kv", eng_kv, serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS))):
        b = len(reqs)
        per_step[label], steps[label] = step_launches(
            torch, api, smoke, f"phase 3l {label}", e, reqs, vp, fam_expected(cfg, 0, False, b, e.max_len),
            fam_step_expected(cfg, e.flags.quant_kv, b, e.max_len))
    out["per_step_launches"] = per_step
    print(f"phase 3l {FAM_ARCH} launches a step: {per_step}")

    # K4 and K6 at every shape the path gave them, every K11 call
    k4_keys = {("bitslice_matmul", (1, m, k), (1, k, n)) for m in (LLM_REQUESTS * 8, LLM_REQUESTS, prompt, 1)
               for k, n in FAM_KN}
    hd, hkv, g = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    t_rows = min(cfg.window, serve_cli.MAX_LEN)
    rows = tmattn.int8_scores_rows_per_call(LLM_REQUESTS, hkv, g, t_rows)
    k6_keys = {("attention_qk", (r * hkv * g, hd), (r * t_rows * hkv, hd))
               for r in {min(rows, LLM_REQUESTS - lo) for lo in range(0, LLM_REQUESTS, rows)}}
    check_recorded(torch, bm, att, smoke, rec, "phase 3l", FAM_ARCH, k4_keys | k6_keys)
    for key in sorted(k6_keys & set(rec.calls)):
        q, kk = rec.calls[key]["args"]
        plan = att.rowdot_plan(kk.shape[0], kk.shape[1], q.shape[0], 1, 1, (kk.data_ptr(), q.data_ptr()))
        out["k6_plan"] = plan._asdict()
        print(f"phase 3l K6 at head_dim {hd}, q {tuple(q.shape)} x cache rows {tuple(kk.shape)}: plan {plan}")
    scans = scan_checks(torch, rg, smoke, rec, f"phase 3l {FAM_ARCH}")
    n_rglru = sum(kind == "rglru" for kind in cfg.layer_kinds())
    want_scans = {(LLM_REQUESTS, 8, cfg.d_model): 2 * n_rglru, (1, prompt, cfg.d_model): n_rglru}
    if scans != want_scans:
        smoke.failures.append(f"phase 3l: RG-LRU scan calls {scans} != {want_scans}")
    out["scan_calls"] = {str(k): v for k, v in scans.items()}
    print(f"phase 3l {FAM_ARCH}: RG-LRU scan calls by shape {scans}, each held to its plain version")
    out["loss"] = fam_loss(torch, transformer, smoke, cfg, params, flags, dev, f"phase 3l {FAM_ARCH}")
    c_cut, p_cut = cut_to(transformer, cfg, params, FAM_CPU_GROUPS[FAM_ARCH], FAM_CPU_ENC_LAYERS)
    label = f"phase 3l card vs CPU {FAM_ARCH} {c_cut.n_layers} layers"
    pair = serve_params_pair(torch, common, transformer, smoke, c_cut, p_cut, flags, label)
    out["card_vs_cpu"] = {
        name: card_vs_cpu(torch, common, transformer, smoke, dev, c_cut, p_cut, fl,
                          f"{label} quant_kv={fl.quant_kv}", FAM_TOL[FAM_ARCH], pair=pair)
        for name, fl in (("bfloat16", flags), ("bfloat16_quant_kv", flags_kv))}
    del pair
    out["recorder"], out["steps"] = rec, steps
    out[f"{FAM_ARCH}_seconds"] = time.perf_counter() - t_phase
    print(f"phase 3l {FAM_ARCH}: {out[f'{FAM_ARCH}_seconds']:.1f} s")
    del params, p_cut, eng, eng_long, eng_kv
    torch.cuda.empty_cache()

    for arch, layers in FAM_OTHERS.items():
        out["others"][arch] = run_other_family(torch, api, bm, att, smoke, dev, gpu, arch, layers)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 3l: {out['seconds']:.1f} s ({gpu})")
    return out


def run_other_family(torch, api, bm, att, smoke, dev, gpu, arch, layers):
    """One launcher run of ``arch`` (at ``layers`` layers, or all) with K4
    counted a run and a step and held at every shape, ``loss_fn``, and the
    card against CPU copies of its first pattern groups."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import common, transformer
    from repro_torch.serve import engine as serve_engine

    t_arch = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    flags = serve_cli.serve_flags(cfg=cfg)
    vp = cfg.padded_vocab()
    t = time.perf_counter()
    params = transformer.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    out = {"arch": arch, "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers, "init_s": time.perf_counter() - t,
           "param_bytes": transformer.param_bytes(params), "runs": {}}
    rec = LLMKernelRecorder(torch, bm, att)
    path_counts = {}
    eng = serve_engine.ServeEngine(cfg, params, flags, max_len=serve_cli.MAX_LEN)
    reqs = serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS)
    drive_engine(torch, api, smoke, rec, f"phase 3l {arch}", "launcher 4x8", eng, reqs, vp, out, path_counts,
                 lambda steps: fam_expected(cfg, steps, False, LLM_REQUESTS, eng.max_len))
    out["path_launches"] = path_counts
    out["per_step_launches"], step = step_launches(
        torch, api, smoke, f"phase 3l {arch} 4x8", eng, serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS),
        vp, fam_expected(cfg, 0, False, LLM_REQUESTS, eng.max_len),
        fam_step_expected(cfg, False, LLM_REQUESTS, eng.max_len))
    check_recorded(torch, bm, att, smoke, rec, f"phase 3l {arch}", arch, None)
    out["k4_shapes"] = {f"{k[1]}x{k[2]}": c["count"] for k, c in sorted(rec.calls.items())}
    out["loss"] = fam_loss(torch, transformer, smoke, cfg, params, flags, dev, f"phase 3l {arch}")
    out["latency"] = engine_latency(torch, {"4x8": step}, arch, gpu, samples=5)
    c_cut, p_cut = cut_to(transformer, cfg, params, FAM_CPU_GROUPS[arch], FAM_CPU_ENC_LAYERS)
    enc = f" + {c_cut.n_enc_layers} encoder" if c_cut.is_encdec else ""
    out["card_vs_cpu"] = card_vs_cpu(torch, common, transformer, smoke, dev, c_cut, p_cut, flags,
                                     f"phase 3l card vs CPU {arch} {c_cut.n_layers}{enc} layers", FAM_TOL[arch],
                                     fam_extra(torch, c_cut))
    print(f"phase 3l {arch} ({cfg.n_layers} layers{f', {cfg.n_enc_layers} encoder' if cfg.is_encdec else ''}, "
          f"{out['param_bytes'] / 1e9:.2f} GB of weights): launches a step {out['per_step_launches']}; "
          f"loss {out['loss']}; {time.perf_counter() - t_arch:.1f} s")
    out["seconds"] = time.perf_counter() - t_arch
    return out


def families_timing(torch, bm, att, rg, smoke, fam, floor_ms):
    """Phase 4 for 3l: RecurrentGemma-2B's prefills and decode steps (host
    clock from an idle card, medians), each K4 and K6 shape of its path
    (:func:`recorded_kernel_rows`), and the RG-LRU scan at the path's
    shapes: CUDA-graph replay, eager, cold, its plain version (on the card),
    its bound.  Returns (latencies, kernel rows)."""
    gpu = fam["gpu"]
    lat = engine_latency(torch, fam["steps"], FAM_ARCH, gpu)
    cfg = fam["steps"]["4x8"][0].cfg
    rows = recorded_kernel_rows(torch, bm, att, smoke, fam["recorder"], cfg, floor_ms, FAM_ARCH,
                                "families_serving", gpu)
    seen = {}
    for a, b, h0, out in fam["recorder"].scans:
        seen.setdefault(tuple(a.shape), (a, b, h0, []))[3].append(out)
    for shape, (a, b, h0, outs) in sorted(seen.items()):
        args = (a, b, h0)
        k_ms = graph_ms(torch, lambda: rg._scan(*args))
        eager = cuda_ms(torch, lambda: rg._scan(*args))
        cold = cold_timer(torch, rg._scan, args)
        cold_ms = median(sorted(cold() for _ in range(3)))
        p_ms = cuda_ms(torch, lambda: rg._scan_plain(*args), reps=1, warmup=1)
        nbytes = 4 * (a.numel() + b.numel() + h0.numel() + outs[0].numel())
        ops = 2 * a.numel()  # one fma a step
        b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        name = f"rglru_scan[{FAM_ARCH} prefill {'x'.join(map(str, shape))}]"
        err = max((c["max_abs_err"] or 0.0) for c in smoke.cases
                  if c["kernel"] == "rglru_scan" and c["case"].startswith(f"phase 3l {FAM_ARCH} {shape}"))
        rows.append({
            "name": name, "route": "cuda", "source": ENTRY_SOURCES["rglru_scan"],
            "replaces": ENTRY_REPLACES["rglru_scan"], "launches": len(outs), "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(b_bytes, b_ops), "bound_by": "operations" if b_ops > b_bytes else "bytes",
            "library_ms": None, "library_none_reason": ENTRY_NO_LIBRARY["rglru_scan"], "eager_ms": eager,
            "cold_ms": cold_ms, "plain_device": "cuda", "path": "families_serving",
            "launches_by_path": {"families_serving": len(outs)}, "shapes": [list(shape)], "bytes": nbytes, "ops": ops,
            "floors": k_ms / floor_ms,
        })
        print(f"kernel {name}: {k_ms * 1e3:.3f} us graph replay ({eager * 1e3:.3f} us eager, cold {cold_ms * 1e3:.3f} "
              f"us; bound {max(b_bytes, b_ops) * 1e3:.3f} us by {rows[-1]['bound_by']}, roofline share "
              f"{max(b_bytes, b_ops) / k_ms:.1%}, {k_ms / floor_ms:.2f} launch floors), plain {p_ms:.3f} ms on the "
              f"card; {len(outs)} launches on the path ({gpu})")
    return lat, rows


# ---------------------------------------------------------------------------
# phase 3m: the single-device training path at RecurrentGemma-2B's full width
# ---------------------------------------------------------------------------


class ScanRecorder:
    """While active, counts every RG-LRU scan forward (``rg._scan``) and
    gradient (``rg._scan_bwd``) call, and keeps clones of the operands and
    outputs of the calls whose index (per kind) falls in ``window``:
    ``{"fwd": range, "bwd": range}``."""

    def __init__(self, rg, window):
        self.rg, self.window = rg, window
        self.n = {"fwd": 0, "bwd": 0}
        self.calls = {"fwd": [], "bwd": []}

    def __enter__(self):
        rg = self.rg
        self.orig = fwd, bwd = rg._scan, rg._scan_bwd

        def clone(x):
            return None if x is None else x.detach().clone()

        def rec_fwd(a, b, h0):
            out = fwd(a, b, h0)
            if self.n["fwd"] in self.window["fwd"]:
                self.calls["fwd"].append((clone(a), clone(b), clone(h0), clone(out)))
            self.n["fwd"] += 1
            return out

        def rec_bwd(a, h0, hs, g, need_h0):
            out = bwd(a, h0, hs, g, need_h0)
            if self.n["bwd"] in self.window["bwd"]:
                self.calls["bwd"].append(((clone(a), clone(h0), clone(hs), clone(g), need_h0),
                                          tuple(clone(x) for x in out)))
            self.n["bwd"] += 1
            return out

        rg._scan, rg._scan_bwd = rec_fwd, rec_bwd
        return self

    def __exit__(self, *exc):
        self.rg._scan, self.rg._scan_bwd = self.orig


def train_batch(torch, cfg, batch, seq, step, dev):
    """The trainer's batch ``step`` (``data.pipeline.batch_at``, seed 0) on
    ``dev``, with seeded normal frame embeddings for an encoder–decoder and
    patch embeddings for a vision config."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import transformer

    out = {k: torch.from_numpy(v) for k, v in batch_at(DataConfig(cfg.vocab_size, seq, batch), step).items()}
    g = torch.Generator().manual_seed(SEED + 5)
    for name, on, rows in (("enc_embeds", cfg.is_encdec, cfg.enc_seq_len),
                           ("patch_embeds", cfg.frontend == "vision", cfg.n_patches)):
        if on:
            out[name] = torch.randn((batch, rows, cfg.d_model), generator=g).to(transformer.dtype_of(cfg))
    return {k: v.to(dev) for k, v in out.items()}


def tree_gap(torch, leaves_card, leaves_cpu):
    """max |card - cpu| over a tree's leaves, relative to the CPU tree's
    largest magnitude."""
    top = max(float(x.float().abs().max()) for x in leaves_cpu if x.numel())
    err = max(float((x.cpu().float() - y.float()).abs().max()) for x, y in zip(leaves_card, leaves_cpu) if y.numel())
    return err / top if top else err


def master_gap(torch, leaves_card, leaves_cpu):
    """The largest gap of master weights beyond two float32 ulps of the CPU
    value (AdamW's first step moves a weight by at most about lr, so
    directions that flip between the devices differ by at most 2 lr)."""
    worst = 0.0
    for x, y in zip(leaves_card, leaves_cpu):
        ulp = torch.nextafter(y.abs(), torch.tensor(float("inf"))) - y.abs()
        worst = max(worst, float(((x.cpu() - y).abs() - 2 * ulp).clamp(min=0).max()) if y.numel() else 0.0)
    return worst


def run_training_phase(torch, api, rg, smoke, dev, gpu, dist_run=None):
    """Phase 3m (module docstring): RecurrentGemma-2B trained at full width
    and depth through ``trainer.train`` with K11's forward and gradient
    counted and one step's calls held bit-equal; the card against its CPU
    copy at one pattern group; every arch's ``reduced_config`` one step on
    both; the bit-exact resume and the CLI in processes of their own."""
    import dataclasses
    import math

    from repro_torch.configs import get_config, list_archs, reduced_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer
    from repro_torch.train import optimizer, steps, trainer

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    flags = train_cli.TRAIN_FLAGS
    n_rglru = sum(kind == "rglru" for kind in cfg.layer_kinds())
    per_step = {"rglru_scan": 2 * n_rglru, "rglru_scan_bwd": n_rglru}
    rec_step = TRAIN_RECORD_STEP - 1
    window = {"fwd": range(rec_step * per_step["rglru_scan"], (rec_step + 1) * per_step["rglru_scan"]),
              "bwd": range(rec_step * per_step["rglru_scan_bwd"], (rec_step + 1) * per_step["rglru_scan_bwd"])}
    out = {"gpu": gpu, "arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "memory_before_gib": torch.cuda.memory_allocated(dev) / 2**30}
    torch.cuda.reset_peak_memory_stats(dev)
    loop = trainer.TrainLoopConfig(steps=TRAIN_STEPS, log_every=1)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    with ScanRecorder(rg, window) as rec, StepDigest(torch, trainer, DIST_STEPS) as digest:
        api.reset_launch_counts()
        t = time.perf_counter()
        run = trainer.train(cfg, data_cfg, loop, flags, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t - digest.seconds
        counts = api.launch_counts()
    # the state after step DIST_STEPS against phase 3n's; the digests' time is out of the step times
    out["digest_s"] = digest.seconds
    run["history"][DIST_STEPS - 1]["s_per_step"] -= digest.seconds
    if dist_run is not None:
        out["dist_differ"] = hold_to_dist_digests(
            smoke, "phase 3m", f"state after step {DIST_STEPS} (per-leaf sha256)", digest.digests,
            dist_run.get("training", {}).get("state_digests"), [TRAIN_BATCH, TRAIN_SEQ], "bfloat16")
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(x.numel() for x in transformer._tree_leaves(run["state"]["params"]))
    state_bytes = transformer.param_bytes(run["state"])
    # one more step (after a warm one) under the profiler: device busy time,
    # idle share and the kernels that take it
    holder = {"state": run.pop("state")}
    step_fn = steps.make_train_step(cfg, flags, base_lr=loop.base_lr, total_steps=loop.steps)
    extra = train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, dev)

    def one_step():
        holder["state"], _ = step_fn(holder["state"], extra)

    prof_wall, names, _ = device_profile(torch, one_step, 1)
    del holder
    torch.cuda.empty_cache()
    busy = sum(ms for _, ms in names.values())
    top = sorted(([nm, c, ms] for nm, (c, ms) in names.items()), key=lambda q: -q[2])
    k11 = sum(ms for nm, (_, ms) in names.items() if "rglru_scan" in nm)
    out["profile"] = {"wall_ms": prof_wall, "device_busy_ms": busy if names else None,
                      "idle_share": 1 - busy / prof_wall if names else None,
                      "device_kernels": sum(c for c, _ in names.values()), "k11_ms": k11, "top": top[:12]}
    print(f"phase 3m profile of one step: {prof_wall:.1f} ms wall, {busy:.1f} ms device busy, idle share "
          f"{out['profile']['idle_share']}, {out['profile']['device_kernels']} device kernels, K11 {k11:.3f} ms; top: "
          + "; ".join(f"{nm[:40]} x{c} {ms:.2f} ms" for nm, c, ms in top[:6]))
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    step_s = [h["s_per_step"] for h in hist]
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if counts != want:
        smoke.failures.append(f"phase 3m: launches {counts} != {want} ({per_step} a step)")
    if [h["step"] for h in hist] != list(range(1, TRAIN_STEPS + 1)) or not all(map(math.isfinite, losses)):
        smoke.failures.append(f"phase 3m: history {hist}")
    med = median(sorted(step_s[1:]))
    out.update({"launches": counts, "launches_per_step": {k: v / TRAIN_STEPS for k, v in counts.items()},
                "losses": losses, "s_per_step": step_s, "step_ms_median": med * 1e3,
                "first_step_ms": step_s[0] * 1e3, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
                "peak_memory_gib": peak / 2**30, "train_wall_s": wall, "n_params": n_params,
                "state_gib": state_bytes / 2**30})
    print(f"phase 3m {TRAIN_ARCH} trained ({cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters, "
          f"{state_bytes / 2**30:.1f} GiB of train state), batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps "
          f"in {wall:.1f} s: step {med * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}; first {step_s[0] * 1e3:.1f} ms), "
          f"{out['tokens_per_s']:.1f} tokens/s, peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated; {out['memory_before_gib']:.2f} GiB held before), K11 launches a step "
          f"{out['launches_per_step']} (predicted {per_step}); losses {[f'{x:.4f}' for x in losses]} ({gpu}); "
          f"state digests after step {DIST_STEPS} in {digest.seconds:.1f} s (out of the step times)")

    # every K11 forward and gradient call of step TRAIN_RECORD_STEP against its plain version
    for i, (a, b, h0, hs) in enumerate(rec.calls["fwd"]):
        smoke.check("rglru_scan", f"phase 3m step {TRAIN_RECORD_STEP} forward call {i}", hs,
                    rg._scan_plain(a, b, h0).cpu(), exact=True)
    for i, ((a, h0, hs, g, need_h0), got) in enumerate(rec.calls["bwd"]):
        wants = rg._scan_bwd_plain(a, h0, hs, g, need_h0)
        for name, x, y in zip(("da", "db", "dh0"), got, wants):
            if y is not None:
                smoke.check("rglru_scan_bwd", f"phase 3m step {TRAIN_RECORD_STEP} call {i} {name}", x, y.cpu(),
                            exact=True)
    held = (len(rec.calls["fwd"]), len(rec.calls["bwd"]))
    if held != (per_step["rglru_scan"], per_step["rglru_scan_bwd"]):
        smoke.failures.append(f"phase 3m: held {held} K11 calls of step {TRAIN_RECORD_STEP}, not {per_step}")
    print(f"phase 3m: step {TRAIN_RECORD_STEP}'s {held[0]} K11 forward and {held[1]} gradient calls "
          f"(shapes {sorted({tuple(c[0].shape) for c in rec.calls['fwd']})}) held bit-equal to their plain versions")
    out["recorded"] = rec.calls

    # the card against its CPU copy at one pattern group, full width
    c_cut = dataclasses.replace(cfg, n_layers=len(TRAIN_CPU_PATTERN), block_pattern=TRAIN_CPU_PATTERN)
    t = time.perf_counter()
    params = transformer.init_params(c_cut, SEED, device=dev)
    p_cpu = transformer._tree_map(lambda x: x.cpu(), params)
    bsz, seq = TRAIN_CPU_SHAPE
    batch = train_batch(torch, c_cut, bsz, seq, 0, dev)
    loss_d, parts_d, g_d = steps._grads_of(params, c_cut, batch, flags)
    loss_c, parts_c, g_c = steps._grads_of(p_cpu, c_cut, {k: v.cpu() for k, v in batch.items()}, flags)
    torch.cuda.synchronize()
    loss_gap = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    grad_gap = tree_gap(torch, optimizer.tree_leaves(g_d), optimizer.tree_leaves(g_c))
    cut_params = sum(x.numel() for x in transformer._tree_leaves(params))
    out["card_vs_cpu"] = {"n_layers": c_cut.n_layers, "n_params": cut_params, "batch": [bsz, seq],
                          "loss_card": float(loss_d), "loss_cpu": float(loss_c), "loss_gap": loss_gap,
                          "grad_gap": grad_gap, "tol": TRAIN_TOL["full"], "seconds": time.perf_counter() - t}
    loss_tol, grad_tol = TRAIN_TOL["full"]
    ok = loss_gap <= loss_tol and grad_gap <= grad_tol and math.isfinite(float(loss_d))
    smoke.cases.append({"kernel": "training", "case": f"phase 3m card vs CPU {c_cut.n_layers} layers", "ok": ok,
                        "max_abs_err": grad_gap, "exact": False, "shape": [bsz, seq], "dtype": "bfloat16"})
    if not ok:
        smoke.failures.append(f"phase 3m card vs CPU {c_cut.n_layers} layers: loss gap {loss_gap} (limit {loss_tol}), "
                              f"gradient gap {grad_gap} of the largest CPU gradient (limit {grad_tol})")
    print(f"phase 3m card vs CPU, {TRAIN_ARCH} at {c_cut.n_layers} layers ({cut_params / 1e9:.3f} B parameters), "
          f"batch {bsz} x {seq}: loss {float(loss_d):.6f} vs {float(loss_c):.6f} (gap {loss_gap:.3g} relative), "
          f"gradients within {grad_gap:.3g} of the largest CPU gradient (limits {loss_tol:g}, {grad_tol:g}); "
          f"{out['card_vs_cpu']['seconds']:.1f} s")
    del params, p_cpu, g_d, g_c
    torch.cuda.empty_cache()

    # every arch at reduced_config: one train step on the card against its CPU copy
    out["reduced"] = {}
    for arch in list_archs():
        rcfg = reduced_config(get_config(arch))
        p0 = transformer.init_params(rcfg, SEED, device="cpu")
        cpu_state = steps.make_train_state(p0, optimizer.AdamWConfig())
        card_state = steps.make_train_state(transformer._tree_map(lambda x: x.to(dev), p0), optimizer.AdamWConfig())
        step = steps.make_train_step(rcfg, flags)
        batch = train_batch(torch, rcfg, 2, 12, 0, "cpu")
        new_c, m_c = step(cpu_state, batch)
        new_d, m_d = step(card_state, {k: v.to(dev) for k, v in batch.items()})
        lr = float(m_c["lr"])
        r = {"loss_card": float(m_d["loss"]), "loss_cpu": float(m_c["loss"]),
             "loss_gap": abs(float(m_d["loss"]) - float(m_c["loss"])) / abs(float(m_c["loss"])),
             "m_gap": tree_gap(torch, optimizer.tree_leaves(new_d["opt"]["m"]), optimizer.tree_leaves(new_c["opt"]["m"])),
             "master_gap_lr": master_gap(torch, optimizer.tree_leaves(new_d["opt"]["master"]),
                                         optimizer.tree_leaves(new_c["opt"]["master"])) / lr,
             "dtype": str(transformer.dtype_of(rcfg)).replace("torch.", "")}
        ok = r["loss_gap"] <= TRAIN_TOL["reduced"][0] and r["m_gap"] <= TRAIN_TOL["reduced"][1] \
            and r["master_gap_lr"] <= 2.0 and math.isfinite(r["loss_card"])
        smoke.cases.append({"kernel": "training", "case": f"phase 3m reduced {arch}", "ok": ok,
                            "max_abs_err": r["m_gap"], "exact": False, "shape": [2, 12], "dtype": r["dtype"]})
        if not ok:
            smoke.failures.append(f"phase 3m reduced {arch}: card vs CPU {r} (limit {TRAIN_TOL['reduced']}, "
                                  f"masters within 2 lr)")
        out["reduced"][arch] = r
    print("phase 3m every arch at reduced_config, one train step, card vs CPU (loss gap, first-moment gap of the "
          "largest, master gap in lr): " + "; ".join(
              f"{a} {r['loss_gap']:.2g} {r['m_gap']:.2g} {r['master_gap_lr']:.2g}" for a, r in out["reduced"].items())
          + f" (limits {TRAIN_TOL['reduced'][0]:g}, {TRAIN_TOL['reduced'][1]:g}, masters 2 lr)")

    # the resume, deterministic, and the CLI, each in a process of its own
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"), CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--train-resume"], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT), env=env)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    resume = json.loads(lines[-1]) if r.returncode == 0 and lines else {"error": r.stderr[-3000:]}
    resume["seconds"] = time.perf_counter() - t
    out["resume"] = resume
    if not resume.get("equal") or resume.get("resumed_from") != 4:
        smoke.failures.append(f"phase 3m resume: {resume}")
    print(f"phase 3m resume on the card ({TRAIN_ARCH} reduced, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"torch.use_deterministic_algorithms): 8 steps straight against 4 + restore + 4: "
          f"{'bit-equal' if resume.get('equal') else 'DIFFERENT'} over {resume.get('leaves')} leaves, resumed from "
          f"{resume.get('resumed_from')}; ops without a deterministic CUDA path: {resume.get('nondeterministic_ops')}; "
          f"{resume['seconds']:.1f} s")
    t = time.perf_counter()
    cli = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--reduced", "--steps", "4"]
    r = subprocess.run(cli, capture_output=True, text=True, timeout=600, cwd=str(ROOT), env=env)
    out["cli"] = {"rc": r.returncode, "stdout": r.stdout[-2000:], "seconds": time.perf_counter() - t}
    if r.returncode != 0 or "{'step': 4, 'loss': " not in r.stdout:
        smoke.failures.append(f"phase 3m CLI {' '.join(cli[1:])}: exit {r.returncode}, {r.stderr[-2000:]}")
    print(f"phase 3m CLI `python -m repro_torch.launch.train --arch {TRAIN_ARCH} --reduced --steps 4`: exit "
          f"{r.returncode}, {r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ''} "
          f"({out['cli']['seconds']:.1f} s)")
    out["path_launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 3m: {out['seconds']:.1f} s ({gpu})")
    return out


def train_resume_main() -> int:
    """``chip_smoke.py --train-resume``, run by phase 3m with
    ``CUBLAS_WORKSPACE_CONFIG`` set: reduced RecurrentGemma trained 8 steps
    straight and 4, a checkpoint, a restore and 4 more on the card under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (every op
    without a deterministic CUDA path named by its warning); prints one JSON
    line.  The two runs' train states must be bit-equal."""
    import tempfile
    import warnings

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TRAIN_FLAGS
    from repro_torch.train import optimizer, trainer

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    cfg = reduced_config(get_config(TRAIN_ARCH))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    (ROOT / "build").mkdir(exist_ok=True)
    with warnings.catch_warnings(record=True) as caught, tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        warnings.simplefilter("always")

        def run(steps, every, sub):
            loop = trainer.TrainLoopConfig(steps=steps, ckpt_every=every, ckpt_dir=f"{d}/{sub}", log_every=4,
                                           schedule_steps=8)
            return trainer.train(cfg, data_cfg, loop, TRAIN_FLAGS, device=dev)

        straight = run(8, 100, "a")
        run(4, 4, "b")
        resumed = run(8, 100, "b")
    a, b = optimizer.tree_leaves(straight["state"]), optimizer.tree_leaves(resumed["state"])
    mismatched = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    nondet = sorted({str(w.message).split("\n")[0] for w in caught if "determinis" in str(w.message)})
    print(json.dumps({"equal": not mismatched and len(a) == len(b), "leaves": len(a), "mismatched": mismatched,
                      "resumed_from": resumed["resumed_from"], "nondeterministic_ops": nondet,
                      "losses": [h["loss"] for h in straight["history"]],
                      "losses_resumed": [h["loss"] for h in resumed["history"]]}))
    return 0


def training_timing(torch, rg, smoke, train, floor_ms):
    """Phase 4 for 3m: K11's forward and gradient kernels at the training
    path's shape (the recorded step's first calls): CUDA-graph replay, eager,
    cold, the plain version on the card, the bound.  Returns kernel rows."""
    gpu = train["gpu"]
    a, b, h0, _ = train["recorded"]["fwd"][0]
    (ga, gh0, ghs, gg, need_h0), _ = train["recorded"]["bwd"][0]
    shape = tuple(a.shape)
    tag = f"{TRAIN_ARCH} train {'x'.join(map(str, shape))}"
    cases = (
        ("rglru_scan", (a, b, h0), rg._scan, rg._scan_plain, 4 * (3 * a.numel() + h0.numel()), 2 * a.numel(),
         "phase 3m step"),
        ("rglru_scan_bwd", (ga, gh0, ghs, gg), lambda *t: rg._scan_bwd(*t, need_h0),
         lambda *t: rg._scan_bwd_plain(*t, need_h0), 4 * (5 * ga.numel() + gh0.numel() * (2 if need_h0 else 1)),
         3 * ga.numel(), "phase 3m step"),
    )
    rows = []
    for kernel, args, fn, plain, nbytes, ops, prefix in cases:
        k_ms = graph_ms(torch, lambda: fn(*args))
        eager = cuda_ms(torch, lambda: fn(*args))
        cold = cold_timer(torch, fn, args)
        cold_ms = median(sorted(cold() for _ in range(3)))
        p_ms = cuda_ms(torch, lambda: plain(*args), reps=1, warmup=1)
        b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        name = f"{kernel}[{tag}]"
        err = max((c["max_abs_err"] or 0.0) for c in smoke.cases
                  if c["kernel"] == kernel and c["case"].startswith(prefix))
        launches = train["launches"].get(kernel, 0)
        rows.append({
            "name": name, "route": "cuda", "source": ENTRY_SOURCES["rglru_scan"],
            "replaces": TRAIN_REPLACES[kernel], "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(b_bytes, b_ops), "bound_by": "operations" if b_ops > b_bytes else "bytes",
            "library_ms": None, "library_none_reason": TRAIN_NO_LIBRARY[kernel], "eager_ms": eager,
            "cold_ms": cold_ms, "plain_device": "cuda", "path": "training",
            "launches_by_path": {"training": launches}, "shapes": [list(shape)], "bytes": nbytes, "ops": ops,
            "floors": k_ms / floor_ms,
        })
        print(f"kernel {name}: {k_ms * 1e3:.3f} us graph replay ({eager * 1e3:.3f} us eager, cold {cold_ms * 1e3:.3f} "
              f"us; bound {max(b_bytes, b_ops) * 1e3:.3f} us by {rows[-1]['bound_by']}, roofline share "
              f"{max(b_bytes, b_ops) / k_ms:.1%}, {k_ms / floor_ms:.2f} launch floors), plain {p_ms:.3f} ms on the "
              f"card; {launches} launches on the path ({gpu})")
    return rows


# ---------------------------------------------------------------------------
# phase 3n: sharding rules and mesh collectives on an NCCL process group
# ---------------------------------------------------------------------------


def tensor_sha256(torch, t):
    """sha256 of a tensor's bytes (any dtype), read on the host."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()).hexdigest()


def tree_digests(torch, leaves, workers=8, chunk=64 << 20):
    """{path: sha256} of ``(path, tensor)`` pairs, each leaf hashed by one of
    ``workers`` threads through a pinned host buffer of ``chunk`` bytes of
    its own; at most ``workers`` leaves are held at once (``leaves`` may
    make each leaf as it is read)."""
    import hashlib
    import threading
    from concurrent.futures import ThreadPoolExecutor

    local = threading.local()
    gate = threading.BoundedSemaphore(workers)

    def digest(t):
        try:
            if getattr(local, "buf", None) is None:
                local.buf = torch.empty(chunk, dtype=torch.uint8, pin_memory=t.is_cuda)
            flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
            h = hashlib.sha256()
            for i in range(0, flat.numel(), chunk):
                n = min(chunk, flat.numel() - i)
                local.buf[:n].copy_(flat[i:i + n])
                h.update(local.buf[:n].numpy())
            return h.hexdigest()
        finally:
            gate.release()

    futures = {}
    with ThreadPoolExecutor(workers) as pool:
        for path, t in leaves:
            gate.acquire()
            futures[path] = pool.submit(digest, t)
            del t
        return {p: f.result() for p, f in futures.items()}


def state_leaves(tree, prefix=""):
    """(path, leaf) of a dict tree in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from state_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


class StepDigest:
    """While active, wraps the train steps ``trainer.train`` builds: after
    step ``at`` (1-based) it records the per-leaf sha256 digests of the new
    state (``digests``) and the seconds that took (``seconds``, inside that
    step's time in the trainer's history)."""

    def __init__(self, torch, trainer, at):
        self.torch, self.trainer, self.at = torch, trainer, at
        self.digests, self.seconds = None, 0.0

    def __enter__(self):
        self.orig = make = self.trainer.make_train_step

        def wrapped_make(*args, **kwargs):
            step, n = make(*args, **kwargs), [0]

            def wrapped(state, batch):
                new, metrics = step(state, batch)
                n[0] += 1
                if n[0] == self.at:
                    self.torch.cuda.synchronize()
                    t = time.perf_counter()
                    self.digests = tree_digests(self.torch, state_leaves(new))
                    self.seconds = time.perf_counter() - t
                return new, metrics

            return wrapped

        self.trainer.make_train_step = wrapped_make
        return self

    def __exit__(self, *exc):
        self.trainer.make_train_step = self.orig


def run_dist_phase(torch, smoke, gpu):
    """Phase 3n (module docstring): ``chip_smoke.py --dist-phase`` in a
    process of its own, run while this process holds next to nothing on the
    card; its checks and failures join this run's, and its logits and state
    digests go to phases 3j and 3m (:func:`hold_to_dist_digests`)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--dist-phase"],
                           capture_output=True, text=True, timeout=DIST_TIMEOUT_S, cwd=str(ROOT), env=env)
        rc, stdout, stderr = r.returncode, r.stdout, r.stderr
    except subprocess.TimeoutExpired as e:
        rc, stdout, stderr = None, e.stdout or "", f"timed out after {DIST_TIMEOUT_S} s"
        stdout = stdout.decode() if isinstance(stdout, bytes) else stdout
    lines = stdout.splitlines()
    for ln in lines:
        if not ln.startswith("{"):
            print(ln)
    js = [ln for ln in lines if ln.startswith("{")]
    out = json.loads(js[-1]) if js else {}
    out["rc"], out["seconds"] = rc, time.perf_counter() - t
    if rc != 0 or not js:
        smoke.failures.append(f"phase 3n: child exit {rc}: {(stderr or '')[-3000:]}")
    smoke.cases.extend(out.get("cases", []))
    smoke.failures.extend(f"phase 3n: {f}" for f in out.get("failures", []))
    print(f"phase 3n: {out['seconds']:.1f} s in its own process, exit {rc} ({gpu})")
    return out


def hold_to_dist_digests(smoke, phase, what, mine, theirs, shape, dtype):
    """Phase ``phase``'s digests (``mine``: {name: sha256}) against phase
    3n's of the same computation under MeshRules (``theirs``): every name
    present in both and equal.  Returns the names that differ."""
    differ = sorted(k for k in set(mine) | set(theirs or {}) if (theirs or {}).get(k) != mine.get(k))
    ok = bool(theirs) and not differ
    smoke.cases.append({"kernel": "dist", "case": f"{phase} {what} vs phase 3n under MeshRules", "ok": ok,
                        "max_abs_err": None, "exact": True, "shape": list(shape), "dtype": dtype})
    if not ok:
        smoke.failures.append(f"{phase} {what}: {len(differ)} of {len(mine)} digests differ from phase 3n's under "
                              f"MeshRules ({differ[:8]}){'' if theirs else '; phase 3n gave none'}")
    print(f"{phase} {what}: {len(mine) - len(differ)}/{len(mine)} bit-equal to phase 3n's under MeshRules (1, 1)")
    return differ


def dist_phase_main() -> int:
    """``chip_smoke.py --dist-phase``, run by phase 3n: an NCCL process
    group of one rank on card 0 (``tcp://localhost``, a free port), then
    :func:`dist_checks`, then the process group destroyed after the card is
    idle.  Prints one JSON line."""
    import socket

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smoke = Smoke(torch)
    out = {"gpu": nvidia_smi("name,power.limit")}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        dist_checks(torch, dev, smoke, out)
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    out["cases"], out["failures"] = smoke.cases, smoke.failures
    print(json.dumps(out))
    return 0


def dist_checks(torch, dev, smoke, out):
    """Phase 3n's checks on the initialised process group (one rank): the
    ("data", "model") = (1, 1) host mesh on ``dev`` and its MeshRules; the
    collectives (each against its CPU copy), the training and serving paths
    under those rules (their state and logits digests recorded for 3m and
    3j) and the memory model.  Records into ``smoke`` and ``out``."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.kernels import api
    from repro_torch.launch import memory_model, specs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import MeshDescription, make_host_mesh
    from repro_torch.launch.train import TRAIN_FLAGS
    from repro_torch.models import transformer
    from repro_torch.serve import engine as serve_engine
    from repro_torch.train import optimizer, steps, trainer

    mesh = make_host_mesh(device=dev.type)
    rules = MeshRules.from_mesh(mesh)
    out["backend"] = {a: str(dist.get_backend(mesh.group(a))) for a in mesh.axis_names}
    out["mesh"] = mesh.shape
    if set(out["backend"].values()) != {"nccl"}:
        smoke.failures.append(f"backend {out['backend']}, not nccl")
    cpu_mesh = MeshDescription((1, 1), ("data", "model"))

    # (a) the four collectives through NCCL, each against its CPU copy
    g = torch.Generator().manual_seed(SEED + 7)
    cases = {
        "htree_allreduce float32": (lambda m, x: collectives.htree_allreduce(x, m, "model"),
                                    (torch.randn((4, 64), generator=g),)),
        "htree_allreduce int32": (lambda m, x: collectives.htree_allreduce(x, m, "data"),
                                  (torch.randint(-2**31, 2**31 - 1, (4, 64), generator=g, dtype=torch.int32),)),
        # integer-valued floats: the card's and the CPU's products are exact
        "ring_allgather_matmul": (lambda m, a, w: collectives.ring_allgather_matmul(a, w, m, "model"),
                                  (torch.randint(-8, 8, (16, 64), generator=g).float(),
                                   torch.randint(-8, 8, (64, 24), generator=g).float())),
        "shuffle": (lambda m, x: collectives.shuffle(x, m, "data", split_dim=0),
                    (torch.arange(64 * 3, dtype=torch.int32).reshape(64, 3),)),
        "compressed_psum_with_feedback": (
            lambda m, gr, e: torch.cat(collectives.compressed_psum_with_feedback(gr, e, m, ("data", "model"))),
            (torch.randn(4096, generator=g), 0.01 * torch.randn(4096, generator=g))),
    }
    out["collectives"] = {}
    for name, (fn, args) in cases.items():
        collectives.reset_call_counts()
        got = fn(mesh, *[a.to(dev) for a in args])
        torch.cuda.synchronize()
        calls = collectives.call_counts()
        smoke.check("collectives", f"phase 3n {name}", got, fn(cpu_mesh, *args), exact=True)
        out["collectives"][name] = calls
    print(f"phase 3n process group: backend {out['backend']}, mesh {mesh.shape}; torch.distributed calls of "
          f"each collective on the card: {out['collectives']} (a butterfly and a ring of one rank have no "
          f"rounds); each bit-equal to its CPU copy")

    # (b) training: trainer.train under the rules with ZeRO-1, phase 3m's batch, seed and schedule
    cfg = get_config(TRAIN_ARCH)
    flags = dataclasses.replace(TRAIN_FLAGS, zero1=True)
    n_rglru = sum(kind == "rglru" for kind in cfg.layer_kinds())
    want = {"rglru_scan": 2 * n_rglru * DIST_STEPS, "rglru_scan_bwd": n_rglru * DIST_STEPS}
    loop = trainer.TrainLoopConfig(steps=DIST_STEPS, log_every=1, schedule_steps=TRAIN_STEPS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    api.reset_launch_counts()
    collectives.reset_call_counts()
    t = time.perf_counter()
    run = trainer.train(cfg, data_cfg, loop, flags, rules=rules, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts, calls = api.launch_counts(), collectives.call_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if counts != want:
        smoke.failures.append(f"training launches {counts} != {want}")
    sspecs = steps.train_state_specs(cfg, rules, optimizer.AdamWConfig(), flags)
    live_bytes = transformer.param_bytes(run["state"])
    cell = ShapeCell("phase3n_train", "train", TRAIN_SEQ, TRAIN_BATCH)
    mem = memory_model.analytic_memory(cfg, cell, rules, flags, specs.input_specs(cfg, cell, rules, flags))
    t = time.perf_counter()
    spec_of = dict(state_leaves(sspecs))
    digests = tree_digests(torch, ((p, steps._gather(x, spec_of[p], rules))
                                   for p, x in state_leaves(run["state"])))
    digest_s = time.perf_counter() - t
    if mem["state_bytes_per_device"] != live_bytes:
        smoke.failures.append(f"analytic state bytes {mem['state_bytes_per_device']} != live {live_bytes}")
    hist = run["history"]
    out["training"] = {
        "launches": counts, "launches_per_step": {k: v / DIST_STEPS for k, v in counts.items()},
        "collective_calls": calls, "collective_calls_per_step": {k: v / DIST_STEPS for k, v in calls.items()},
        "losses": [h["loss"] for h in hist], "s_per_step": [h["s_per_step"] for h in hist], "wall_s": wall,
        "state_digests": digests, "digest_s": digest_s,
        "state_bytes_live": live_bytes, "memory_model": mem, "max_memory_allocated": peak}
    print(f"phase 3n {TRAIN_ARCH} trained under MeshRules (1, 1) with ZeRO-1, {DIST_STEPS} steps at "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} in {wall:.1f} s (steps {[round(h['s_per_step'] * 1e3, 1) for h in hist]} ms); "
          f"K11 launches {counts} (expected {want}); torch.distributed calls a step "
          f"{out['training']['collective_calls_per_step']}; {len(digests)} leaf digests after step {DIST_STEPS} "
          f"for phase 3m ({digest_s:.1f} s); state bytes: analytic "
          f"{mem['state_bytes_per_device']}, live {live_bytes}; analytic peak "
          f"{mem['analytic_peak_per_device'] / 2**30:.2f} GiB, max_memory_allocated {peak / 2**30:.2f} GiB")
    del run
    torch.cuda.empty_cache()

    # (c) the compressed mean on the tied embedding's gradient (float32), card against CPU
    params = transformer.init_params(cfg, SEED, device=dev)
    batch = train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, 0, dev)
    _, _, grads = steps._global_grads_of(params, cfg, batch, flags, rules)
    grad = grads["embed"]["w"].to(torch.float32)
    del params, grads
    torch.cuda.empty_cache()
    collectives.reset_call_counts()
    t = time.perf_counter()
    red, err = collectives.compressed_psum_with_feedback(grad, torch.zeros_like(grad), mesh, ("data",))
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t) * 1e3
    comp_calls = collectives.call_counts()
    red, err = red.cpu(), err.cpu()
    grad = grad.cpu()
    want_red, want_err = collectives.compressed_psum_with_feedback(grad, torch.zeros_like(grad), cpu_mesh,
                                                                  ("data",))
    smoke.check("collectives", f"phase 3n compressed mean of the {tuple(grad.shape)} embedding gradient",
                red, want_red, exact=True)
    smoke.check("collectives", f"phase 3n compressed new error of the {tuple(grad.shape)} embedding gradient",
                err, want_err, exact=True)
    out["compressed_embedding_grad"] = {"shape": list(grad.shape), "numel": grad.numel(), "card_ms": card_ms,
                                        "calls": comp_calls}
    print(f"phase 3n compressed_psum_with_feedback on the tied embedding's gradient {tuple(grad.shape)} "
          f"({grad.numel() / 1e6:.0f} M float32): {card_ms:.1f} ms on the card (host clock), calls {comp_calls}, "
          f"mean and new error bit-equal to the CPU copy")
    del red, err, grad, want_red, want_err

    # (d) serving: Qwen2-0.5B's prefill and decode steps under the rules, against phase 3j's logits
    scfg = get_config(LLM_ARCH)
    sflags = serve_cli.serve_flags()
    eng = serve_engine.ServeEngine(scfg, transformer.init_params(scfg, SEED, device=dev), sflags,
                                   max_len=serve_cli.MAX_LEN)
    batch = eng.prompt_batch(serve_cli.make_requests(scfg, LLM_REQUESTS, LLM_NEW_TOKENS))
    api.reset_launch_counts()
    collectives.reset_call_counts()
    with torch.no_grad():
        cache, logits = serve_engine.make_prefill_step(scfg, sflags, rules, max_len=serve_cli.MAX_LEN)(
            eng.params, batch)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        _, logits2 = serve_engine.make_decode_step(scfg, sflags, rules)(eng.params, cache, tok)
    torch.cuda.synchronize()
    counts, calls = api.launch_counts(), collectives.call_counts()
    want = {"bitslice_matmul": 2 * LLM_K4_PER_LAYER * scfg.n_layers}
    if counts != want:
        smoke.failures.append(f"serving launches {counts} != {want}")
    got_d = {"prefill": tensor_sha256(torch, logits), "decode_step": tensor_sha256(torch, logits2)}
    if not all(bool(torch.isfinite(lg).all()) for lg in (logits, logits2)):
        smoke.failures.append("serving logits not finite")
    dcell = ShapeCell("phase3n_decode", "decode", serve_cli.MAX_LEN, LLM_REQUESTS)
    smem = memory_model.analytic_memory(scfg, dcell, rules, sflags, specs.input_specs(scfg, dcell, rules, sflags))
    served = transformer.param_bytes(eng.params)
    if smem["params_bytes_per_device"] != served:
        smoke.failures.append(f"analytic params bytes {smem['params_bytes_per_device']} != served {served}")
    out["serving"] = {"launches": counts, "collective_calls": calls, "logits_digests": got_d,
                      "logits_shape": list(logits.shape), "logits_dtype": str(logits.dtype),
                      "memory_model": smem, "params_bytes_served": served}
    print(f"phase 3n {LLM_ARCH} prefill {tuple(batch['tokens'].shape)} and one decode step under MeshRules "
          f"(1, 1): launches {counts} (expected {want}), torch.distributed calls {calls}; logits digests for "
          f"phase 3j; params bytes: analytic "
          f"{smem['params_bytes_per_device']}, served {served}")
    out["path_launches"] = {"dist_training": out["training"]["launches"], "dist_serving": counts}


# ---------------------------------------------------------------------------
# phase 3o: tensor-parallel execution, two ranks on the one card
# ---------------------------------------------------------------------------


def tp_k6_calls(cfg, tp, batch, rows):
    """Row-dot calls of one attention layer's int8 scores on a rank of a
    model axis of ``tp``: its query heads against the KV heads they need."""
    from repro_torch.models import attention as tmattn

    hq = cfg.n_heads // tp
    hkv = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else max(1, hq * cfg.n_kv_heads // cfg.n_heads)
    return -(-batch // tmattn.int8_scores_rows_per_call(batch, hkv, hq // hkv, rows))


def run_tp_phase(torch, smoke, gpu):
    """Phase 3o (module docstring): ``chip_smoke.py --tp-phase RANK PORT``
    for TP_RANKS ranks in processes of their own on the one card, run while
    this process holds next to nothing on it, under one time limit; each
    rank's checks and failures join this run's."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # gloo's own transport over the loopback interface (the machine has no other network)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--tp-phase", str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(ROOT), env=env)
             for r in range(TP_RANKS)]
    outs, rcs = [], []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=max(TP_TIMEOUT_S - (time.perf_counter() - t), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            stdout, stderr = p.communicate()
            stderr = f"{stderr}\ntimed out after {TP_TIMEOUT_S} s"
        outs.append((stdout, stderr))
        rcs.append(p.returncode)
    runs = []
    for r, (stdout, stderr) in enumerate(outs):
        lines = stdout.splitlines()
        for ln in lines:
            if not ln.startswith("{") and (r == 0 or rcs[r] != 0):
                print(ln)
        js = [ln for ln in lines if ln.startswith("{")]
        res = json.loads(js[-1]) if js else {}
        if rcs[r] != 0 or not js:
            smoke.failures.append(f"phase 3o rank {r}: exit {rcs[r]}: {(stderr or '')[-3000:]}")
        smoke.cases.extend(res.get("cases", []))
        smoke.failures.extend(f"phase 3o rank {r}: {f}" for f in res.get("failures", []))
        runs.append(res)
    out = dict(runs[0]) if runs else {}
    out.pop("cases", None), out.pop("failures", None)
    out["ranks"] = [{k: v for k, v in res.items() if k not in ("cases", "failures")} for res in runs[1:]]
    out["rc"], out["seconds"] = rcs, time.perf_counter() - t
    print(f"phase 3o: {out['seconds']:.1f} s, {TP_RANKS} ranks in processes of their own, exits {rcs} ({gpu})")
    return out


def tp_phase_main(rank: int, port: int) -> int:
    """``chip_smoke.py --tp-phase RANK PORT``, run by phase 3o: one of
    TP_RANKS ranks of a gloo process group (``tcp://localhost:PORT``) on
    card 0, then :func:`tp_checks`, then the group destroyed after the card
    is idle.  Prints one JSON line."""
    import datetime

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smoke = Smoke(torch)
    out = {"gpu": nvidia_smi("name,power.limit"), "rank": rank}
    t_phase = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=TP_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=TP_COLLECTIVE_TIMEOUT_S))
    try:
        tp_checks(torch, dev, rank, smoke, out)
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    out["cases"], out["failures"] = smoke.cases, smoke.failures
    print(json.dumps(out))
    return 0


def tp_kernel_shapes(rec):
    """The recorder's K4 and K6 shapes with their counts, JSON-able."""
    shapes = []
    for (kernel, sa, sb), c in sorted(rec.calls.items()):
        extra = {"slice_bits": c["args"][2], "pairs": [list(p) for p in c["args"][3]], "path": c["path"]} \
            if kernel == "bitslice_matmul" else {}
        shapes.append(dict({"kernel": kernel, "a": list(sa), "b": list(sb), "count": c["count"],
                            "max_abs_err": c.get("max_abs_err")}, **extra))
    return shapes


def tp_gap(torch, want, got):
    """The largest |got - want| over the largest |want|."""
    want, got = want.float().cpu(), got.float().cpu()
    return float((got - want).abs().max()) / float(want.abs().max())


def tp_checks(torch, dev, rank, smoke, out):
    """Phase 3o's checks on one rank of the host-staged gloo group: the
    ("data", "model") = (1, TP_RANKS) mesh over ``host_collectives``; the
    serving steps of TP_SERVE's configs under its rules on this rank's
    slices, held to rank 0's 1-rank run of the same steps; RecurrentGemma-2B
    trained at TP_TRAIN_LAYERS layers, held to rank 0's 1-rank run; every
    K4, K6 and K11 call against its plain version; the live bytes against
    the memory model's.  Records into ``smoke`` and ``out``."""
    import dataclasses
    import math

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist import collectives, sharding
    from repro_torch.kernels import api
    from repro_torch.kernels import attention as att
    from repro_torch.kernels import bitslice_matmul as bm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.launch import memory_model, specs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.serve import engine as serve_engine
    from repro_torch.train import optimizer, steps, trainer

    mesh = make_host_mesh(TP_RANKS, device=dev.type, host_collectives=True)
    rules = sharding.MeshRules.from_mesh(mesh)
    out["mesh"] = mesh.shape
    out["transport"] = {a: f"{dist.get_backend(mesh.group(a))} staged through host memory "
                           f"({collectives.host_staged(mesh.group(a))})" for a in mesh.axis_names}
    if rank == 0:
        print(f"phase 3o: {TP_RANKS} ranks on one card, mesh {mesh.shape}; every collective copies its tensors to "
              f"the host, runs gloo there and copies back ({out['transport']}): NCCL refuses two ranks on one "
              f"device; every kernel launch stays on the card")
    path_counts = {"tp_serving": {}, "tp_training": {}}

    def add(path, counts):
        for k, v in counts.items():
            if v:
                path_counts[path][k] = path_counts[path].get(k, 0) + v

    # (a) serving: the 4 x 8 prefill and one decode step of each config, with and without quant_kv
    out["serving"] = {}
    rec = LLMKernelRecorder(torch, bm, att, rg)
    for arch, layers in TP_SERVE.items():
        t = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        flags = serve_cli.serve_flags(cfg=cfg)
        eng = serve_engine.ServeEngine(cfg, transformer.init_params(cfg, SEED, device=dev), flags,
                                       max_len=serve_cli.MAX_LEN)
        batch = eng.prompt_batch(serve_cli.make_requests(cfg, LLM_REQUESTS, LLM_NEW_TOKENS))
        local = sharding.shard_params(eng.params, cfg, rules)
        served = transformer.param_bytes(local)
        dcell = ShapeCell("phase3o_decode", "decode", serve_cli.MAX_LEN, LLM_REQUESTS)
        smem = memory_model.analytic_memory(cfg, dcell, rules, flags, specs.input_specs(cfg, dcell, rules, flags))
        if smem["params_bytes_per_device"] != served:
            smoke.failures.append(f"{arch}: analytic params bytes {smem['params_bytes_per_device']} != served {served}")
        res = {"layers": cfg.n_layers, "params_bytes_served": served,
               "params_bytes_analytic": smem["params_bytes_per_device"], "runs": {}}
        for quant_kv in (False, True):
            fl = dataclasses.replace(flags, quant_kv=quant_kv)
            label = f"{arch} quant_kv={quant_kv}"
            tok = torch.zeros((LLM_REQUESTS, 1), dtype=torch.int32)
            ref = {}
            if rank == 0:  # the 1-rank run of the same steps, first
                with torch.no_grad():
                    cache, lg = serve_engine.make_prefill_step(cfg, fl, max_len=serve_cli.MAX_LEN)(eng.params, batch)
                    tok = torch.argmax(lg, -1).to(torch.int32)[:, None].cpu()
                    _, lg2 = serve_engine.make_decode_step(cfg, fl)(eng.params, cache, tok.to(dev))
                ref = {"prefill": lg.cpu(), "decode_step": lg2.cpu()}
                del cache, lg, lg2
            dist.broadcast(tok, 0, group=None)  # the greedy tokens of the 1-rank prefill, to every rank
            api.reset_launch_counts()
            collectives.reset_call_counts()
            records = {}  # what each step's collectives moved, held by phase 3p to the (1, 2) dry run
            with torch.no_grad(), rec, collectives.recording_collectives():
                collectives.reset_collective_records()
                cache, lg = serve_engine.make_prefill_step(cfg, fl, rules, max_len=serve_cli.MAX_LEN)(local, batch)
                records["prefill"] = [list(r) for r in collectives.collective_records()]
                collectives.reset_collective_records()
                _, lg2 = serve_engine.make_decode_step(cfg, fl, rules)(local, cache, tok.to(dev))
                records["decode_step"] = [list(r) for r in collectives.collective_records()]
                torch.cuda.synchronize()
            counts, calls = {k: v for k, v in api.launch_counts().items() if v}, collectives.call_counts()
            add("tp_serving", counts)
            n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_kinds())
            want = {"bitslice_matmul": fam_k4(cfg, True) + fam_k4(cfg, False)}
            if quant_kv:
                want["attention_qk"] = sum(
                    tp_k6_calls(cfg, TP_RANKS, LLM_REQUESTS,
                                min(cfg.window, serve_cli.MAX_LEN) if kind == "local_attn" else serve_cli.MAX_LEN)
                    for kind in cfg.layer_kinds() if kind in ("attn", "local_attn"))
            n_rglru = sum(kind == "rglru" for kind in cfg.layer_kinds())
            if n_rglru:
                want["rglru_scan"] = n_rglru
            if counts != want:
                smoke.failures.append(f"{label}: launches {counts} != {want}")
            run = {"launches": counts, "expected": want, "collective_calls": calls, "collective_records": records,
                   "attention_layers": n_attn,
                   "digests": {"prefill": tensor_sha256(torch, lg), "decode_step": tensor_sha256(torch, lg2)}}
            for name, x in (("prefill", lg), ("decode_step", lg2)):
                if not bool(torch.isfinite(x).all()) or x.shape != (LLM_REQUESTS, cfg.padded_vocab()):
                    smoke.failures.append(f"{label} {name}: logits {tuple(x.shape)}, finite "
                                          f"{bool(torch.isfinite(x).all())}")
            if rank == 0:
                run["ref_digests"] = {k: tensor_sha256(torch, v) for k, v in ref.items()}
                run["bit_equal"] = run["digests"] == run["ref_digests"]
                for name, x in (("prefill", lg), ("decode_step", lg2)):
                    gap = tp_gap(torch, ref[name], x)
                    run[f"{name}_gap"] = gap
                    ok = run["digests"][name] == run["ref_digests"][name]
                    smoke.cases.append({"kernel": "tp", "case": f"phase 3o {label} {name} vs 1 rank", "ok": ok,
                                        "max_abs_err": gap, "exact": True, "shape": list(x.shape),
                                        "dtype": str(x.dtype)})
                    if not ok:
                        smoke.failures.append(f"{label} {name}: not bit-equal to the 1-rank run, gap {gap} of "
                                              f"its largest logit")
            res["runs"][f"quant_kv={quant_kv}"] = run
            del cache, lg, lg2
        del eng, local
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t
        out["serving"][arch] = res
        if rank == 0:
            print(f"phase 3o {arch} ({cfg.n_layers} layers) under MeshRules {mesh.shape}, 4 x 8 prefill and decode "
                  f"step: " + "; ".join(
                      f"{k}: launches {r['launches']} (expected {r['expected']}), torch.distributed calls "
                      f"{r['collective_calls']}, bit-equal to 1 rank {r['bit_equal']}, gaps "
                      f"{r['prefill_gap']:.3g} / {r['decode_step_gap']:.3g}"
                      for k, r in res["runs"].items())
                  + f"; params bytes served {served}, analytic {smem['params_bytes_per_device']}; "
                  f"{res['seconds']:.1f} s")

    # every K4 and K6 shape's first call and every K11 call against its plain version
    check_recorded(torch, bm, att, smoke, rec, f"phase 3o rank {rank}", "TP", None)
    scans = scan_checks(torch, rg, smoke, rec, f"phase 3o rank {rank}")
    out["kernel_shapes"] = tp_kernel_shapes(rec)
    out["scans"] = {str(k): v for k, v in scans.items()}
    del rec
    torch.cuda.empty_cache()

    # (b) training: RecurrentGemma-2B at TP_TRAIN_LAYERS layers, rank 0's 1-rank run first
    t = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TP_TRAIN_LAYERS)
    flags = train_cli.TRAIN_FLAGS
    n_rglru = sum(kind == "rglru" for kind in cfg.layer_kinds())
    per_step = {"rglru_scan": 2 * n_rglru, "rglru_scan_bwd": n_rglru}
    loop = trainer.TrainLoopConfig(steps=TP_STEPS, log_every=1, schedule_steps=TRAIN_STEPS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    tr = {"layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TP_STEPS}
    ref_m = ref_master = None
    if rank == 0:
        torch.cuda.reset_peak_memory_stats(dev)
        ref = trainer.train(cfg, data_cfg, loop, flags, device=dev)
        torch.cuda.synchronize()
        tr["ref_losses"] = [h["loss"] for h in ref["history"]]
        tr["ref_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        ref_m = {p: x.cpu() for p, x in state_leaves(ref["state"]["opt"]["m"])}
        ref_master = {p: x.cpu() for p, x in state_leaves(ref["state"]["opt"]["master"])}
        del ref
        torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    rec_step = TRAIN_RECORD_STEP - 1
    window = {"fwd": range(rec_step * per_step["rglru_scan"], (rec_step + 1) * per_step["rglru_scan"]),
              "bwd": range(rec_step * per_step["rglru_scan_bwd"], (rec_step + 1) * per_step["rglru_scan_bwd"])}
    api.reset_launch_counts()
    collectives.reset_call_counts()
    t_run = time.perf_counter()
    with ScanRecorder(rg, window) as srec:
        run = trainer.train(cfg, data_cfg, loop, flags, rules=rules, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts, calls = {k: v for k, v in api.launch_counts().items() if v}, collectives.call_counts()
    add("tp_training", counts)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: v * TP_STEPS for k, v in per_step.items()}
    if counts != want:
        smoke.failures.append(f"training launches {counts} != {want}")
    for i, (a, b, h0, hs) in enumerate(srec.calls["fwd"]):
        smoke.check("rglru_scan", f"phase 3o rank {rank} training step {TRAIN_RECORD_STEP} forward call {i}", hs,
                    rg._scan_plain(a, b, h0).cpu(), exact=True)
    for i, ((a, h0, hs, g, need_h0), got) in enumerate(srec.calls["bwd"]):
        for name, x, y in zip(("da", "db", "dh0"), got, rg._scan_bwd_plain(a, h0, hs, g, need_h0)):
            if y is not None:
                smoke.check("rglru_scan_bwd", f"phase 3o rank {rank} training step {TRAIN_RECORD_STEP} call {i} "
                            f"{name}", x, y.cpu(), exact=True)
    held = (len(srec.calls["fwd"]), len(srec.calls["bwd"]))
    if held != (per_step["rglru_scan"], per_step["rglru_scan_bwd"]):
        smoke.failures.append(f"training: held {held} K11 calls of step {TRAIN_RECORD_STEP}, not {per_step}")
    del srec
    sspecs = steps.train_state_specs(cfg, rules, optimizer.AdamWConfig(), flags)
    live = transformer.param_bytes(run["state"])
    tcell = ShapeCell("phase3o_train", "train", TRAIN_SEQ, TRAIN_BATCH)
    mem = memory_model.analytic_memory(cfg, tcell, rules, flags, specs.input_specs(cfg, tcell, rules, flags))
    if mem["state_bytes_per_device"] != live:
        smoke.failures.append(f"analytic state bytes {mem['state_bytes_per_device']} != live {live}")
    spec_of = dict(state_leaves(sspecs))
    losses = [h["loss"] for h in run["history"]]
    tr.update({"launches": counts, "launches_per_step": {k: v / TP_STEPS for k, v in counts.items()},
               "collective_calls_per_step": {k: v / TP_STEPS for k, v in calls.items()}, "losses": losses,
               "s_per_step": [h["s_per_step"] for h in run["history"]], "wall_s": wall, "peak_gib": peak / 2**30,
               "state_bytes_live": live, "state_bytes_analytic": mem["state_bytes_per_device"],
               "analytic_peak_gib": mem["analytic_peak_per_device"] / 2**30})
    # the state after the last step, gathered leaf by leaf, against the 1-rank run's (on rank 0)
    top = err = master_worst = 0.0
    for part in ("m", "master"):
        for p, x in state_leaves(run["state"]["opt"][part]):
            whole = sharding.gather_leaf(x, spec_of[f"opt/{part}/{p}"], rules)
            if rank == 0:
                y = (ref_m if part == "m" else ref_master).pop(p)
                if part == "m":
                    top = max(top, float(y.abs().max()))
                    err = max(err, float((whole.cpu() - y).abs().max()))
                else:
                    master_worst = max(master_worst, master_gap(torch, [whole], [y]))
            del whole
    # one more step (after a warm one) under the profiler: where the step's time goes
    holder = {"state": run.pop("state")}
    step_fn = steps.make_train_step(cfg, flags, rules, optimizer.AdamWConfig(lr=loop.base_lr), base_lr=loop.base_lr,
                                    total_steps=loop.schedule_steps)
    extra = train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, TP_STEPS, dev)

    def one_step():
        holder["state"], _ = step_fn(holder["state"], extra)

    tr["profile"] = tp_step_profile(torch, one_step)
    del run, holder
    torch.cuda.empty_cache()
    if rank == 0:
        lr = loop.base_lr
        # the first step's loss is of the same weights; later ones of weights that AdamW's
        # sign-like first steps moved apart (printed, held through the moments and masters)
        tr["loss_gaps"] = [abs(a - b) / abs(b) for a, b in zip(losses, tr["ref_losses"])]
        loss_gap = tr["loss_gaps"][0]
        m_gap, master_lr = err / top, master_worst / lr
        tr.update({"loss_gap": loss_gap, "m_gap": m_gap, "master_gap_lr": master_lr, "tol": TP_TRAIN_TOL})
        loss_tol, m_tol = TP_TRAIN_TOL
        ok = loss_gap <= loss_tol and m_gap <= m_tol and all(map(math.isfinite, losses))
        smoke.cases.append({"kernel": "tp", "case": f"phase 3o training {cfg.n_layers} layers vs 1 rank", "ok": ok,
                            "max_abs_err": m_gap, "exact": False, "shape": [TRAIN_BATCH, TRAIN_SEQ],
                            "dtype": "bfloat16"})
        if not ok:
            smoke.failures.append(f"training vs 1 rank: step-1 loss gap {loss_gap} (limit {loss_tol}), first-moment gap "
                                  f"{m_gap} (limit {m_tol}); master gap {master_lr} lr")
    tr["seconds"] = time.perf_counter() - t
    out["training"] = tr
    out["path_launches"] = path_counts
    if rank == 0:
        print(f"phase 3o {TRAIN_ARCH} trained at {cfg.n_layers} layers under MeshRules {mesh.shape}, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TP_STEPS} steps in {wall:.1f} s (steps "
              f"{[round(s * 1e3, 1) for s in tr['s_per_step']]} ms): K11 launches {counts} (expected {want}); "
              f"torch.distributed calls a step {tr['collective_calls_per_step']}; losses {losses} vs 1 rank "
              f"{tr['ref_losses']} (gaps {[float(f'{x:.3g}') for x in tr['loss_gaps']]}), first moments within "
              f"{tr['m_gap']:.3g} of the "
              f"largest (limits {TP_TRAIN_TOL}), masters within {tr['master_gap_lr']:.3g} lr (printed); "
              f"state bytes a rank: live {live}, analytic {mem['state_bytes_per_device']}; peak "
              f"{tr['peak_gib']:.2f} GiB a rank (1 rank: {tr['ref_peak_gib']:.2f}); {tr['seconds']:.1f} s")
        pr = tr["profile"]
        print(f"phase 3o profile of one training step on rank 0: {pr['wall_ms']:.1f} ms wall, device busy "
              f"{pr['device_busy_ms']} ms (idle share {pr['idle_share']}; host-device copies {pr['copy_calls']} "
              f"taking {pr['copy_ms']} ms of it), host ops by self CPU time: "
              + "; ".join(f"{nm} x{c} {ms:.1f} ms" for nm, c, ms in pr["host_top"]))


def tp_step_profile(torch, fn):
    """``fn`` (one training step of a rank of phase 3o) once warm, then once
    under torch.profiler: the wall time on CUDA events, the device busy time
    and idle share (None when the profiler saw no device activity), the
    host-device copies' count and device time, and the host ops that took
    the most self CPU time (``[name, calls, ms]``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    busy = copy_ms = 0.0
    kernels = copies = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            busy, kernels = busy + ms, kernels + 1
            if ev.name.startswith("Memcpy"):
                copy_ms, copies = copy_ms + ms, copies + 1
    wall = start.elapsed_time(end)
    host = sorted(([a.key, a.count, a.self_cpu_time_total / 1e3] for a in prof.key_averages()),
                  key=lambda q: -q[2])
    return {"wall_ms": wall, "device_busy_ms": busy if kernels else None,
            "idle_share": 1 - busy / wall if kernels else None, "device_events": kernels,
            "copy_calls": copies, "copy_ms": copy_ms, "host_top": host[:8]}


def tp_kernel_rows(torch, bm, att, smoke, tp_run, floor_ms, gpu):
    """Phase 4 for 3o: each K4 shape that rank 0 of phase 3o launched, on
    operands drawn here, timed as :func:`recorded_kernel_rows` times the
    LLM path's (the rank's own calls were held to their plain versions in
    3o); their launches are rank 0's."""
    import types

    g = torch.Generator().manual_seed(SEED + 29)
    rec = types.SimpleNamespace(calls={})
    for s in tp_run.get("kernel_shapes", []):
        if s["kernel"] != "bitslice_matmul":
            continue
        x = torch.randint(-128, 128, s["a"], generator=g, dtype=torch.int8)
        w = torch.randint(-128, 128, s["b"], generator=g, dtype=torch.int8)
        pairs = tuple(tuple(p) for p in s["pairs"])
        xd, wd = x.to("cuda"), w.to("cuda")
        got = bm._bitslice_gemm(xd, wd, s["slice_bits"], pairs)
        t = time.perf_counter()
        want = bm._bitslice_plain(x, w, s["slice_bits"], pairs)
        plain_ms = (time.perf_counter() - t) * 1e3
        err = smoke.check("bitslice_matmul", f"phase 4 TP shape {s['a']}x{s['b']}", got, want, exact=True)
        rec.calls[("bitslice_matmul", tuple(s["a"]), tuple(s["b"]))] = {
            "count": s["count"], "path": bm.launched_path(), "out": got, "args": (xd, wd, s["slice_bits"], pairs),
            "plain_ms": plain_ms, "max_abs_err": err}
    heads = types.SimpleNamespace(n_kv_heads=1, n_heads=1)  # read for K6 rows only
    return recorded_kernel_rows(torch, bm, att, smoke, rec, heads, floor_ms, "tp2", "tp_serving", gpu)


# ---------------------------------------------------------------------------
# phase 3p: the dry run's predictions against the live runs
# ---------------------------------------------------------------------------

# one production cell of each kind through the dry run's CLI at pod16x16
DRYRUN_CLI_CELLS = (("qwen2-0.5b", "train_4k"), ("recurrentgemma-2b", "prefill_32k"),
                    ("recurrentgemma-2b", "long_500k"))
DRYRUN_CLI_TIMEOUT_S = 300
DRYRUN_TIMED_STEPS = 3  # the step timed after its counted call


def dryrun_cells():
    """Phase 3p's cells, ``(label, arch, cell, flags)``: 3j's 4 x 8 prefill
    and its decode step at batch 4 on the launcher's MAX_LEN-row cache, 3m's
    8 x 64 training step, each with its phase's run flags."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.train import TRAIN_FLAGS

    sflags = serve_cli.serve_flags(cfg=get_config(LLM_ARCH))
    return (
        ("3j prefill", LLM_ARCH, ShapeCell("phase3p_prefill", "prefill", serve_cli.PROMPT_LEN, LLM_REQUESTS), sflags),
        ("3j decode step", LLM_ARCH, ShapeCell("phase3p_decode", "decode", serve_cli.MAX_LEN, LLM_REQUESTS), sflags),
        ("3m training step", TRAIN_ARCH, ShapeCell("phase3p_train", "train", TRAIN_SEQ, TRAIN_BATCH), TRAIN_FLAGS),
    )


def live_cell(torch, api, dryrun, cfg, cell, flags, dev):
    """One cell's step on the card from ``dryrun.live_step_args`` (random
    weights from SEED, no rules): its launches, argument and output bytes and
    ``max_memory_allocated`` above what the card held before its arguments
    in the counted call, then DRYRUN_TIMED_STEPS calls timed on the host
    clock to the card's idle."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    step, args = dryrun.live_step_args(cfg, cell, None, flags, dev, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    api.reset_launch_counts()
    with torch.no_grad():
        out = step(*args)
    torch.cuda.synchronize()
    res = {"launches": {k: v for k, v in api.launch_counts().items() if v},
           "argument_bytes": dryrun.tree_bytes(args), "output_bytes": dryrun.output_bytes(out),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev), "base_bytes": base}
    res["peak_above_base"] = res["max_memory_allocated"] - base
    del out
    times = []
    for _ in range(DRYRUN_TIMED_STEPS):
        t = time.perf_counter()
        with torch.no_grad():
            out = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        del out
    res["step_ms"] = times
    res["step_ms_median"] = median(sorted(times))
    del step, args
    torch.cuda.empty_cache()
    return res


def tp_collective_checks(torch, smoke, dryrun, tp_run):
    """Phase 3o's live records against the (1, TP_RANKS) dry run of the same
    steps on each rank of a fake group: counts and operand bytes by op."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.hlo_analysis import collective_stats
    from repro_torch.launch.mesh import make_dryrun_mesh

    ranks = [tp_run] + list(tp_run.get("ranks", []))
    cells = {"prefill": ShapeCell("phase3o_prefill", "prefill", serve_cli.PROMPT_LEN, LLM_REQUESTS),
             "decode_step": ShapeCell("phase3o_decode", "decode", serve_cli.MAX_LEN, LLM_REQUESTS)}
    out = {}
    for arch, layers in TP_SERVE.items():
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        for quant_kv in (False, True):
            fl = dataclasses.replace(serve_cli.serve_flags(cfg=cfg), quant_kv=quant_kv)
            for r in range(TP_RANKS):
                live_run = (ranks[r].get("serving", {}).get(arch, {}).get("runs", {}).get(f"quant_kv={quant_kv}", {})
                            if r < len(ranks) else {})
                with make_dryrun_mesh(shape=(1, TP_RANKS), rank=r) as mesh, torch.no_grad():
                    rules = MeshRules.from_mesh(mesh)
                    for name, cell in cells.items():
                        step, args, *_ = dryrun._build_step_args(cfg, cell, rules, fl)
                        pred = collective_stats(dryrun.count_step(step, args).records)
                        del step, args
                        got = live_run.get("collective_records", {}).get(name)
                        live = collective_stats(collectives.CollectiveRecord(*x) for x in (got or []))
                        key = f"{arch} quant_kv={quant_kv} rank {r} {name}"
                        ok = got is not None and (pred.counts, pred.operand_bytes) == (live.counts, live.operand_bytes)
                        out[key] = {"predicted": {"counts": pred.counts, "operand_bytes": pred.operand_bytes},
                                    "live": {"counts": live.counts, "operand_bytes": live.operand_bytes}, "equal": ok}
                        smoke.cases.append({"kernel": "dryrun", "case": f"phase 3p {key} collectives vs phase 3o",
                                            "ok": ok, "exact": True})
                        if not ok:
                            smoke.failures.append(f"phase 3p {key}: the (1, {TP_RANKS}) dry run's collectives "
                                                  f"{out[key]['predicted']} != phase 3o's live "
                                                  f"{out[key]['live'] if got is not None else 'records: none'}")
    return out


def run_dryrun_phase(torch, api, smoke, dev, gpu, tp_run):
    """Phase 3p (module docstring): the dry run (``repro_torch.launch.dryrun``,
    meta tensors on a fake process group) predicts phase 3j's and 3m's steps
    at mesh (1, 1) and phase 3o's collectives at (1, TP_RANKS); the live
    steps on the card are held to its launches and argument and output
    bytes, its peak and roofline printed beside the live ones; then one
    production cell of each kind through the CLI at pod16x16."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dryrun_mesh

    t_phase = time.perf_counter()
    out = {"gpu": gpu, "cells": {}}
    for label, arch, cell, flags in dryrun_cells():
        cfg = get_config(arch)
        live = live_cell(torch, api, dryrun, cfg, cell, flags, dev)
        t = time.perf_counter()
        with make_dryrun_mesh(shape=(1, 1)) as mesh, torch.no_grad():
            pred = dryrun.run_cell(cfg, cell, MeshRules.from_mesh(mesh), flags, correction=False)
        pred_s = time.perf_counter() - t
        mem, rl = pred["memory"], pred["roofline"]
        bound_ms = max(rl["compute_s"], rl["memory_s"]) * 1e3
        res = {"arch": arch, "kind": cell.kind, "seq": cell.seq_len, "batch": cell.global_batch, "live": live,
               "predicted": {"launches": pred["launches"], "argument_bytes": mem["argument_bytes_per_device"],
                             "output_bytes": mem["output_bytes_per_device"], "peak_bytes": mem["peak_bytes_per_device"],
                             "peak_from": mem["peak_from"], "analytic_peak": mem["analytic"]["analytic_peak_per_device"],
                             "flops": pred["cost"]["flops"], "bytes_accessed": pred["cost"]["bytes_accessed"],
                             "roofline": rl, "roofline_ms": bound_ms, "seconds": pred_s}}
        for what, p, lv in (("launches", pred["launches"], live["launches"]),
                            ("argument bytes", mem["argument_bytes_per_device"], live["argument_bytes"]),
                            ("output bytes", mem["output_bytes_per_device"], live["output_bytes"])):
            ok = p == lv
            smoke.cases.append({"kernel": "dryrun", "case": f"phase 3p {label} {what} predicted vs live", "ok": ok,
                                "exact": True})
            if not ok:
                smoke.failures.append(f"phase 3p {label}: predicted {what} {p} != live {lv}")
        peak = mem["peak_bytes_per_device"]
        print(f"phase 3p {label} ({arch}, {cell.kind} {cell.global_batch} x {cell.seq_len}, mesh (1, 1)): launches "
              f"predicted {pred['launches']}, live {live['launches']}; argument bytes {mem['argument_bytes_per_device']} "
              f"/ {live['argument_bytes']}, output bytes {mem['output_bytes_per_device']} / {live['output_bytes']}; "
              f"peak predicted {'n/a' if peak is None else f'{peak / 2**30:.3f}'} GiB ({mem['peak_from']}), "
              f"analytic {mem['analytic']['analytic_peak_per_device'] / 2**30:.3f} GiB, beside max_memory_allocated "
              f"{live['peak_above_base'] / 2**30:.3f} GiB above the card's {live['base_bytes'] / 2**30:.3f} GiB before "
              f"the arguments; roofline max(compute, memory) {bound_ms:.4f} ms (dominant {rl['dominant']}) beside the "
              f"measured step {live['step_ms_median']:.3f} ms (median of {DRYRUN_TIMED_STEPS}, host clock); the dry "
              f"run took {pred_s:.1f} s ({gpu})")
        out["cells"][label] = res

    # the CLI at pod16x16, its processes on the host's cores while the (1, 2) dry runs run here
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = {f"{arch} {shape}": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", "single",
         "--no-save"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(ROOT), env=env)
        for arch, shape in DRYRUN_CLI_CELLS}
    t = time.perf_counter()
    out["tp_collectives"] = tp_collective_checks(torch, smoke, dryrun, tp_run)
    n_eq = sum(v["equal"] for v in out["tp_collectives"].values())
    print(f"phase 3p: the (1, {TP_RANKS}) dry run's collective_stats equal to phase 3o's live records (counts and "
          f"operand bytes by op) in {n_eq}/{len(out['tp_collectives'])} steps ({time.perf_counter() - t:.1f} s); "
          + "; ".join(f"{k}: {v['predicted']['counts']}" for k, v in out["tp_collectives"].items()
                      if k.endswith("rank 0 decode_step") and "quant_kv=False" in k))
    out["cli"] = {}
    for key, proc in cli.items():
        try:
            stdout, stderr = proc.communicate(timeout=max(DRYRUN_CLI_TIMEOUT_S - (time.perf_counter() - t), 1))
        except subprocess.TimeoutExpired:
            for p in cli.values():
                p.kill()
            stdout, stderr = proc.communicate()
            stderr = f"{stderr}\ntimed out after {DRYRUN_CLI_TIMEOUT_S} s"
        lines = [ln for ln in stdout.splitlines() if ln.startswith("[pod16x16]")]
        ok = proc.returncode == 0 and len(lines) == 1 and " ok " in lines[0]
        out["cli"][key] = {"rc": proc.returncode, "line": lines[0] if lines else None}
        smoke.cases.append({"kernel": "dryrun", "case": f"phase 3p CLI {key} pod16x16", "ok": ok, "exact": True})
        if not ok:
            smoke.failures.append(f"phase 3p CLI {key}: exit {proc.returncode}: {stdout[-1000:]} {stderr[-2000:]}")
        print(f"phase 3p CLI: {lines[0] if lines else stdout[-300:]}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 3p: {out['seconds']:.1f} s ({gpu})")
    return out


# ---------------------------------------------------------------------------
# phase 3k: the continuous-batching scheduler and multi-chip scale-out
# ---------------------------------------------------------------------------


def cluster_programs(torch, np, api, pimsab_step, dev):
    """tests/test_multichip.py's workloads and the decode layer, traced, with
    their seeded int8 operands on the card."""
    def chain(x, w1, w2):
        h = api.relu(api.int_matmul(x, w1, x_bits=4, w_bits=4))
        return api.int_matmul(h, w2, w_bits=4)

    def conv(x, w1, w2):
        h = api.relu(api.conv2d(x, w1, padding=1, x_bits=3, w_bits=3))
        return api.conv2d(h, w2, padding=1, w_bits=3)

    def attn(q, kc, vc):
        s = api.attention_qk(q, kc, q_bits=3, k_bits=3, out_bits=10)
        return api.attention_pv(api.softmax_fixedpoint(s, in_frac=7), vc)

    fns = {"mc_matmul_chain": chain, "mc_conv_block": conv, "mc_attn_decode": attn}
    out = {}
    for name, (shapes, seed, ranges) in CLUSTER_WORKLOADS.items():
        rng = np.random.default_rng(seed)
        args = [torch.from_numpy(rng.integers(-r, r + 1, s, dtype=np.int8)).to(dev) for s, r in zip(shapes, ranges)]
        if name == "decode_layer":
            prog = pimsab_step.decode_layer_program()
        else:
            prog = api.trace(fns[name], name=name).trace(*(torch.zeros_like(a) for a in args))
        out[name] = (prog, args)
    return out


class RecordingModel:
    """A ToyTokenModel whose ``detok`` records the batcher's every step:
    request, cache row, context (on its device) and token."""

    def __init__(self, scheduler, cfg):
        self.inner = scheduler.ToyTokenModel(cfg)
        self.steps, self.request = [], None

    def embed(self, token):
        return self.inner.embed(token)

    def detok(self, context):
        tok = self.inner.detok(context)
        r = self.request
        self.steps.append((r.rid, r.pos - 1, context, tok))
        return tok


def recording_batcher(scheduler, **kw):
    """A ContinuousBatcher that tells its RecordingModel which request each
    decode step serves."""
    class Recording(scheduler.ContinuousBatcher):
        def _decode_one(self, r):
            self.model.request = r
            super()._decode_one(r)

    cfg = scheduler.AttnServeConfig()
    return Recording(cfg, model=RecordingModel(scheduler, cfg), **kw)


def serve_row(api, scheduler, smoke, batch, dev):
    """benchmarks/serve_bench.py's ``_run_batch`` on the port, with every
    step recorded: (row, host seconds, batcher)."""
    before = api.compile_cache_info()
    t = time.perf_counter()
    sched = recording_batcher(scheduler, max_active=batch, buckets=(4,), tune=api.TuneConfig(**SERVE_TUNE),
                              device=dev)
    for i in range(batch):
        sched.submit(SERVE_PROMPTS[i % len(SERVE_PROMPTS)], max_new_tokens=SERVE_MAX_NEW_TOKENS)
    sched.run()
    host_s = time.perf_counter() - t
    after = api.compile_cache_info()
    rep = api.last_sim_report()
    resident = any(e.startswith("state:") for e in rep.resident_edges)
    append_traffic = sum(t.get("a", 0.0) + t.get("out", 0.0) for node, t in rep.dram_traffic.items()
                         if "kv_append" in node)
    s = sched.summary()
    row = {
        "batch": batch,
        "requests": batch,
        "max_new_tokens": SERVE_MAX_NEW_TOKENS,
        "tokens": int(s["tokens"]),
        "steps": int(s["steps"]),
        "modeled_seconds": s["modeled_seconds"],
        "total_cycles": int(s["total_cycles"]),
        "energy_j": s["energy_j"],
        "tokens_per_sec": round(s["tokens_per_sec"], 1),
        "joules_per_token": s["joules_per_token"],
        "kv_resident": bool(resident and append_traffic == 0.0),
        "autotune": dict(rep.autotune),
        "compile_cache": {"hits_added": after.hits - before.hits, "misses_added": after.misses - before.misses},
    }
    off = [c.device for _, _, c, _ in sched.model.steps if c.device != dev]
    if off:
        smoke.failures.append(f"phase 3k serve batch {batch}: contexts on {sorted(set(map(str, off)))}, not {dev}")
    return row, host_s, sched


def serve_pinned_equal(row, pinned):
    """A serve row equal to BENCH_kernels.json's, ``energy_j`` and
    ``joules_per_token`` within 1e-12 relative (float sums pinned on another
    host), everything else exactly."""
    row, pinned = json.loads(json.dumps(row)), dict(pinned)
    for key in ("energy_j", "joules_per_token"):
        a, b = row.pop(key), pinned.pop(key, None)
        if b is None or abs(a - b) > 1e-12 * abs(b):
            return False
    return row == pinned


def replay_on_card(torch, api, pimsab_step, scheduler, smoke, sched, dev):
    """Every request of a finished batcher replayed through the card's device
    Executor of the same decode program (graph route), the caches carried
    with ``api.kv_append`` and seeded as ``_prefill`` does: each context and
    token against the batcher's, the launches counted exactly per step."""
    cfg = sched.cfg
    model = scheduler.ToyTokenModel(cfg)
    card_ex = api.compile(pimsab_step.decode_program(cfg, 4))
    steps = {(rid, pos): (ctx, tok) for rid, pos, ctx, tok in sched.model.steps}
    n, equal, routes, bad_launches = 0, True, set(), []
    for r in sorted(sched.retired, key=lambda r: r.rid):
        kc = torch.zeros((r.capacity, cfg.head_dim), dtype=torch.int8, device=dev)
        vc = torch.zeros((r.capacity, cfg.value_dim), dtype=torch.int8, device=dev)
        for pos, t in enumerate(r.prompt):
            _, k, v = model.embed(t)
            kc[pos], vc[pos] = k.to(dev), v.to(dev)
        tok = r.prompt[-1]
        for i, want_tok in enumerate(r.generated):
            pos = len(r.prompt) + i
            q, k, v = (x.to(dev) for x in model.embed(tok))
            onehot = torch.zeros(r.capacity, dtype=torch.int8, device=dev)
            onehot[pos] = 1
            torch.cuda.synchronize()
            api.reset_launch_counts()
            ctx = card_ex(kc, vc, q.reshape(1, cfg.head_dim), k, v, onehot)
            kc, vc = api.kv_append(kc, k, onehot), api.kv_append(vc, v, onehot)
            torch.cuda.synchronize()
            counts = {k_: c for k_, c in api.launch_counts().items() if c}
            if counts != STEP_LAUNCHES:
                bad_launches.append((r.rid, pos, counts))
            routes.add(card_ex.replay)
            got_ctx, got_tok = steps[(r.rid, pos)]
            smoke.check("serve:scheduler", f"batch {len(sched.retired)} request {r.rid} row {pos} context vs the "
                        "card Executor", got_ctx, ctx.cpu(), True)
            card_tok = model.detok(ctx)
            equal = equal and torch.equal(got_ctx.cpu(), ctx.cpu()) and card_tok == got_tok == want_tok
            if not card_tok == got_tok == want_tok:
                smoke.failures.append(f"phase 3k request {r.rid} row {pos}: token {got_tok} (batcher) vs {card_tok} "
                                      f"(card Executor) vs {want_tok} (generated)")
            tok, n = want_tok, n + 1
    if bad_launches:
        smoke.failures.append(f"phase 3k card replay launches per step != {STEP_LAUNCHES}: {bad_launches[:4]}")
    if routes - {"eager", "graph"} or "graph" not in routes:
        smoke.failures.append(f"phase 3k card replay routes {sorted(routes)}: the graph route never ran")
    if n != len(sched.model.steps):
        smoke.failures.append(f"phase 3k card replay covered {n} of {len(sched.model.steps)} steps")
    return {"steps": n, "bit_equal": equal, "launches_per_step": STEP_LAUNCHES,
            "launches": {k: v * n for k, v in STEP_LAUNCHES.items()}, "routes": sorted(routes)}


def scaling_rows_of(api, prog, workload):
    """benchmarks/kernels_bench.py's ``_scaling_rows`` on the port."""
    strong, weak = [], []
    base = None
    for chips in SCALING_CHIPS:
        rep = api.cluster_timing_report(prog, chips=chips)
        if base is None:
            base = rep.total_cycles
        strong.append({
            "chips": chips,
            "mesh": list(rep.mesh),
            "plan": rep.plan,
            "total_cycles": rep.total_cycles,
            "serial_cycles": rep.serial_cycles,
            "serialized_cycles": rep.serialized_cycles,
            "overlapped_cycles": rep.overlapped_cycles,
            "link_bits": rep.link_bits,
            "speedup": round(base / rep.total_cycles, 3),
            "notes": sorted({n.split(":", 1)[0] for n in rep.notes}),
        })
        if chips > 1:
            wrep = api.weak_scaling_report(prog, chips=chips)
            weak.append({"chips": chips, "total_cycles": wrep.total_cycles,
                         "throughput_x": round(chips * base / wrep.total_cycles, 3)})
    return {"workload": workload, "strong": strong, "weak": weak}


def run_serve_scaling_phase(torch, np, api, pimsab_step, scheduler, resnet, smoke, dev, gpu):
    """Phase 3k: the continuous-batching scheduler (ROADMAP S9) and the
    multi-chip executors and reports (S10) with operands on the card, held to
    BENCH_kernels.json's serve and scaling sections and to the card's
    kernels (K6, K7, K8, K10 through the decode program's device Executor;
    K1, K5, K6, K7, K8 through the cluster workloads').  Their own work runs
    on the host's numpy simulator and counts no launch: every time printed
    here is host wall time, not card time."""
    bench = json.loads((ROOT / "BENCH_kernels.json").read_text())
    out = {"gpu": gpu}

    def no_launch(label):
        counts = {k: v for k, v in api.launch_counts().items() if v}
        if counts:
            smoke.failures.append(f"phase 3k {label}: host-simulator calls counted launches {counts}")

    # (1) the serve rows
    rows, last = [], None
    for batch, pinned in zip(SERVE_BATCH_SIZES, bench["serve"]["batches"]):
        api.reset_launch_counts()
        row, host_s, sched = serve_row(api, scheduler, smoke, batch, dev)
        no_launch(f"serve batch {batch}")
        equal = serve_pinned_equal(row, pinned)
        if not equal:
            smoke.failures.append(f"phase 3k serve batch {batch}: {row} != BENCH_kernels.json {pinned}")
        rows.append({"batch": batch, "host_s": host_s, "row_equal": equal, "tokens": row["tokens"],
                     "total_cycles": row["total_cycles"], "tokens_per_sec": row["tokens_per_sec"],
                     "compile_cache": row["compile_cache"]})
        print(f"phase 3k serve batch {batch}: {host_s:.3f} s host wall (numpy simulator; {gpu}), {row['tokens']} "
              f"tokens, {row['total_cycles']} modeled cycles, {row['tokens_per_sec']} modeled tokens/s, cache "
              f"{row['compile_cache']}; BENCH_kernels.json serve row equal: {equal}")
        last = sched
    out["serve"] = rows

    # (2) batch 16's streams against the card's decode Executor
    t = time.perf_counter()
    out["serve_card_replay"] = replay_on_card(torch, api, pimsab_step, scheduler, smoke, last, dev)
    out["serve_card_replay"]["host_s"] = time.perf_counter() - t
    r = out["serve_card_replay"]
    print(f"phase 3k serve batch {SERVE_BATCH_SIZES[-1]} replayed on the card's decode Executor: {r['steps']} steps "
          f"in {r['host_s']:.3f} s host wall ({gpu}), contexts and tokens bit-equal: {r['bit_equal']}, "
          f"launches a step {r['launches_per_step']}, routes {r['routes']}")

    # (3) preemption: max_active 1 against 2 on buckets (4, 8)
    t = time.perf_counter()
    gens, preempted = {}, 0
    api.reset_launch_counts()
    for max_active in (1, 2):
        sched = scheduler.ContinuousBatcher(max_active=max_active, buckets=(4, 8), device=dev)
        sched.submit([1], max_new_tokens=5)
        sched.submit([2, 3], max_new_tokens=2)
        done = sched.run()
        gens[max_active] = {tuple(r.prompt): list(r.generated) for r in done}
        if max_active == 1:
            preempted = sum(r.preemptions for r in done)
    no_launch("preemption")
    pre_s = time.perf_counter() - t
    if gens[1] != gens[2] or not preempted:
        smoke.failures.append(f"phase 3k preemption: generations {gens[1]} (pressured) vs {gens[2]} (free), "
                              f"{preempted} preemptions")
    out["preemption"] = {"host_s": pre_s, "lossless": gens[1] == gens[2], "preemptions": preempted}
    print(f"phase 3k preemption on buckets (4, 8): {pre_s:.3f} s host wall ({gpu}), {preempted} preemptions, "
          f"generations equal to the run without pressure: {gens[1] == gens[2]}")

    # (4) cluster executors on card operands
    t = time.perf_counter()
    cases, card_launches = [], {}
    for name, (prog, args) in cluster_programs(torch, np, api, pimsab_step, dev).items():
        one = api.compile(prog, "pimsab")(*args)
        card_ex = api.compile(prog)
        card_ex(*args)
        api.reset_launch_counts()
        card = card_ex(*args)
        torch.cuda.synchronize()
        card_launches[name] = {k: v for k, v in api.launch_counts().items() if v}
        if card_ex.replay != "graph":
            smoke.failures.append(f"phase 3k {name}: the card Executor took the {card_ex.replay} route")
        smoke.check(f"cluster:{name}", "one-chip pimsab Executor vs the card Executor", one, card.cpu(), True)
        plans = [(mesh, plan) for mesh in CLUSTER_MESHES for plan in ("auto", "tp")] + [(CLUSTER_PP[name], "pp")]
        for mesh, plan in plans:
            api.reset_launch_counts()
            ex = api.compile(prog, "pimsab", cluster=api.ChipCluster(mesh=mesh), plan=plan)
            got = ex(*args)
            no_launch(f"{name} {mesh} {plan}")
            label = f"{mesh[0]}x{mesh[1]} {plan} (plan {ex.plan})"
            smoke.check(f"cluster:{name}", f"{label} vs the card Executor", got, card.cpu(), True)
            if got.device != dev:
                smoke.failures.append(f"phase 3k {name} {label}: output on {got.device}")
            if (name == "decode_layer" and plan != "pp" and ex.plan != "tp") or (plan == "pp" and ex.plan != "pp"):
                smoke.failures.append(f"phase 3k {name} {label}: plan {ex.plan}")
            cases.append({"workload": name, "mesh": list(mesh), "plan": plan, "chosen": ex.plan,
                          "bit_equal": bool(torch.equal(got.cpu(), card.cpu())),
                          "total_cycles": ex.report.total_cycles})
    graph, stream, refused = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev), None
    try:
        with torch.cuda.graph(graph, stream=stream):
            ex(*args)
    except api.PimsabTracerError as exc:
        refused = str(exc)
    torch.cuda.synchronize()
    if refused is None:
        smoke.failures.append("phase 3k: a ClusterExecutor called during a CUDA graph capture was not refused")
    cl_s = time.perf_counter() - t
    out["cluster"] = {"host_s": cl_s, "cases": cases, "capture_refused": refused is not None,
                      "card_executor_launches": card_launches}
    n_equal = sum(c["bit_equal"] for c in cases)
    print(f"phase 3k cluster executors: {len(cases)} (workload, mesh, plan) cases in {cl_s:.3f} s host wall ({gpu}), "
          f"{n_equal} bit-equal to the card Executor's graph replay; decode layer plans "
          f"{[c['chosen'] for c in cases if c['workload'] == 'decode_layer']}; card Executor launches a replay "
          f"{card_launches}; call during a capture refused: {refused is not None}")

    # (5) the scaling rows
    cfg = resnet.RESNET18
    t = time.perf_counter()
    prog = api.trace(lambda p, v: resnet.forward(cfg, p, v), name="resnet18_scaling").trace(
        resnet.init_params(cfg, seed=0, device=dev), resnet.make_input(cfg, batch=1, seed=1, device=dev))
    workloads = [(prog, "resnet18"), (pimsab_step.decode_layer_program(), "decode_layer")]
    out["scaling"] = []
    for (wprog, workload), pinned in zip(workloads, bench["scaling"]["workloads"]):
        api.reset_launch_counts()
        got = scaling_rows_of(api, wprog, workload)
        no_launch(f"scaling {workload}")
        s_ = time.perf_counter() - t
        equal = json.loads(json.dumps(got)) == pinned
        if not equal:
            smoke.failures.append(f"phase 3k scaling {workload}: {got} != BENCH_kernels.json {pinned}")
        totals = [r["total_cycles"] for r in got["strong"]]
        out["scaling"].append({"workload": workload, "host_s": s_, "row_equal": equal, "total_cycles": totals,
                               "plans": [r["plan"] for r in got["strong"]]})
        print(f"phase 3k scaling {workload} on {list(SCALING_CHIPS)} chips: {s_:.3f} s host wall ({gpu}), strong "
              f"{totals} modeled cycles, plans {[r['plan'] for r in got['strong']]}; BENCH_kernels.json scaling "
              f"rows equal: {equal}")
        t = time.perf_counter()
    return out


def replay_profile_main() -> int:
    """``chip_smoke.py --replay-profiles``, run by phase 5: the held
    Executors' graph replays under torch.profiler in a process that has
    profiled nothing before, at the main run's shapes: RESNET18 b32, the
    decode step at DECODE_CAPACITY rows with its cache carry, the decode
    layer, quant_linear_relu and phase 3g's Executors.  Each path is called
    twice first (eagerly then captured; replayed).  Prints one JSON line."""
    faulthandler.enable()
    import torch

    from repro_torch.kernels import api
    from repro_torch.models import common, resnet
    from repro_torch.serve import pimsab_step

    dev = torch.device("cuda", 0)
    profiles, routes = {}, {}

    def run(label, fn, calls):
        with ExecutorRecorder(api) as rec:
            fn()
            fn()
            wall, names, _ = device_profile(torch, fn, calls)
        busy = sum(ms for _, ms in names.values())
        routes[label] = sorted({route for _, _, route, _ in rec.calls})
        profiles[label] = {
            "calls": calls, "wall_ms_per_call": wall / calls,
            "device_busy_ms_per_call": busy / calls if names else None,
            "idle_share": 1 - busy / wall if names else None,
            "kernels": sorted(([nm, c / calls, ms / calls] for nm, (c, ms) in names.items()), key=lambda q: -q[2]),
        }

    cfg = resnet.RESNET18
    params = resnet.ResNet(cfg, resnet.init_params(cfg, SEED, device="cpu"), device=dev).params()
    x = resnet.make_input(cfg, BATCH, seed=SEED + 1, device="cpu").to(dev)
    ex = api.compile(api.trace(lambda p, v: resnet.forward(cfg, p, v), name="resnet18").program_for(params, x))
    run(f"RESNET18 b{BATCH} held Executor", lambda: ex(params, x), 3)

    g = torch.Generator().manual_seed(SEED + 7)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8).to(dev)

    d, cap = DECODE_CFG["head_dim"], DECODE_CAPACITY
    kc, vc, q, k_new, v_new = i8((cap, d)), i8((cap, d)), i8((1, d)), i8((d,)), i8((d,))
    onehot = torch.zeros(cap, dtype=torch.int8, device=dev)
    onehot[cap - 1] = 1
    step_ex = api.compile(pimsab_step.decode_program(pimsab_step.AttnServeConfig(**DECODE_CFG), cap))

    def step():
        ctx = step_ex(kc, vc, q, k_new, v_new, onehot)
        api.kv_append(kc, k_new, onehot)
        api.kv_append(vc, v_new, onehot)
        return ctx

    run(f"decode step at {cap} rows with the cache carry", step, 5)
    model_dim, head_dim, ff_dim = LAYER_DIMS
    layer_args = [i8(s) for s in ((cap, head_dim), (cap, head_dim), (1, head_dim), (head_dim, model_dim),
                                  (model_dim, ff_dim), (ff_dim, model_dim))]
    layer_ex = api.compile(pimsab_step.decode_layer_program(
        model_dim, head_dim, ff_dim, cap, q_bits=8, kv_bits=8, score_bits=DECODE_CFG["score_bits"],
        score_frac=DECODE_CFG["score_frac"], w_bits=8))
    run(f"decode layer at {cap} rows", lambda: layer_ex(*layer_args), 3)
    mq, kq, nq = QLR
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qx = torch.randn((mq, kq), generator=gen, device=dev)
    qp = common.quantize_weight(torch.randn((kq, nq), generator=gen, device=dev) * 0.05, 8)
    run("quant_linear_relu (whole call)", lambda: common.quant_linear_relu(qp, qx, api.PrecisionSpec.w8a16), 1)
    for kernel, case, fn, cpu_args in entry_point_cases(torch, api, cfg, SEED + 9):
        args = [a.to(dev) for a in cpu_args]
        entry_ex = api.compile(api.trace(fn, name=f"{kernel}_{case}").program_for(*args))
        run(f"held Executor {kernel}[{case}]", lambda: entry_ex(*args), 3)
    llm = {LLM_ARCH: llm_decode_profiles(torch, dev)}
    torch.cuda.empty_cache()
    llm[FAM_ARCH] = llm_decode_profiles(torch, dev, FAM_ARCH, (False,))
    print(json.dumps({"gpu": nvidia_smi("name,power.limit"), "profiles": profiles, "routes": routes, "llm": llm}))
    return 0


def main() -> int:
    faulthandler.enable()  # a crash in native code prints the Python stack that led to it
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU", file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.kernels import _build, api, conv, ewise, pimsab_backend, program, ref
    from repro_torch.kernels import attention as att
    from repro_torch.kernels import bitslice_matmul as bm
    from repro_torch.kernels import htree_reduce as ht
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.models import common, resnet
    from repro_torch.serve import pimsab_step, scheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smoke = Smoke(torch)
    gpu = nvidia_smi("name,power.limit")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    imad_per_s = sm_count * IMAD_PER_CLOCK_PER_SM * clock_hz
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {sm_count} SMs, "
          f"max SM clock {clock_hz / 1e6:.0f} MHz")

    # ---------------- phase 1: build ----------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s wall for {sorted(built) or 'nothing (cached)'}")
    for src, info in sorted(built.items()):
        regs = [ln.strip() for ln in str(info["log"]).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {src}.cu: {info['seconds']:.1f} s; " + " | ".join(regs[:8]))

    # ---------------- phase 3n, first: sharding rules and collectives on NCCL, in a process of its own ----------------
    dist_run = run_dist_phase(torch, smoke, gpu)

    # ---------------- phase 3o, next: tensor-parallel execution, two ranks on the card ----------------
    tp_run = run_tp_phase(torch, smoke, gpu)

    # ---------------- phase 2: kernels against their plain versions ----------------
    cfg = resnet.RESNET18
    params_cpu = resnet.init_params(cfg, SEED, device="cpu")
    x_cpu = resnet.make_input(cfg, BATCH, seed=SEED + 1, device="cpu")
    model = resnet.ResNet(cfg, params_cpu, device=dev)
    x = x_cpu.to(dev)

    # capture the inputs each kernel wrapper gets on the main path
    calls = {k: [] for k in SOURCES}
    orig = (conv._gemm, conv._pool_rows, ewise._ewise)

    def rec_gemm(a, b, layout="kn"):
        calls["gemm"].append((a.contiguous(), b.contiguous(), layout))
        return orig[0](a, b, layout)

    # clone() keeps each operand's layout (the forward's relu and add
    # operands are channels-last), so phase 4 times what the path launches
    def rec_pool(p, op):
        calls[f"pool_{op}"].append((p.clone(),))
        return orig[1](p, op)

    def rec_ewise(op, a, b=None):
        calls["ewise_add" if op == "add" else "relu"].append(
            tuple(t.clone() for t in ((a,) if b is None else (a, b))))
        return orig[2](op, a, b)

    conv._gemm, conv._pool_rows, ewise._ewise = rec_gemm, rec_pool, rec_ewise
    try:
        with torch.no_grad():
            model(x)
    finally:
        conv._gemm, conv._pool_rows, ewise._ewise = orig
    torch.cuda.synchronize()

    run = {
        "gemm": lambda a, b, layout: conv._gemm(a, b, layout),
        "pool_sum": lambda p: conv._pool_rows(p, "sum"),
        "pool_max": lambda p: conv._pool_rows(p, "max"),
        "ewise_add": lambda a, b: ewise._ewise("add", a, b),
        "relu": lambda a: ewise._ewise("relu", a),
    }
    plain = {
        "gemm": conv._gemm_plain,
        "pool_sum": lambda p: conv._pool_rows_plain(p, "sum"),
        "pool_max": lambda p: conv._pool_rows_plain(p, "max"),
        "ewise_add": lambda a, b: ewise._ewise_plain("add", a, b),
        "relu": lambda a: ewise._ewise_plain("relu", a),
    }

    main_err = {k: 0.0 for k in SOURCES}
    gemm_plain_cpu_ms = 0.0
    for kernel, arglist in calls.items():
        for i, args in enumerate(arglist):
            got = run[kernel](*args)
            torch.cuda.synchronize()
            cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
            t = time.perf_counter()
            want = plain[kernel](*cpu_args)
            if kernel == "gemm":
                gemm_plain_cpu_ms += (time.perf_counter() - t) * 1e3
            err = smoke.check(kernel, f"resnet18 b{BATCH} call {i} {shapes_of(args)}", got, want, exact=True)
            main_err[kernel] = max(main_err[kernel], err or 0.0)

    g = torch.Generator().manual_seed(SEED)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    def floats(shape):
        return torch.randn(shape, generator=g, dtype=torch.float32)

    big = 2**30
    edge_cases = [
        ("gemm", "ragged M=1000 K=27 N=1000", (ints((1000, 27), -8, 8), ints((27, 1000), -4, 4), "kn"), True),
        ("gemm", "ragged M=77 K=4608 N=130", (ints((77, 4608), -1000, 1000), ints((4608, 130), -4, 4), "kn"), True),
        ("gemm", "int32 wrap K=576", (ints((130, 576), -big, big), ints((576, 70), -big, big), "kn"), True),
        ("gemm", "float32 M=300 K=200 N=130", (floats((300, 200)), floats((200, 130)), "kn"), False),
        ("gemm", "float32 ragged M=129 K=27 N=1000", (floats((129, 27)), floats((27, 1000)), "kn"), False),
        ("gemm", "float32 B as (N, K)", (floats((129, 200)), floats((130, 200)), "nk"), False),
        ("pool_sum", "negative sums K=16", (ints((1000, 16), -50, 10),), True),
        ("pool_sum", "int32 wrap K=49", (ints((777, 49), -2**31, 2**31 - 1),), True),
        ("pool_sum", "ragged K=100", (ints((300, 100), -1000, 1000),), True),
        ("pool_sum", "float32 K=16", (floats((1000, 16)),), False),
        ("pool_max", "int32 K=4", (ints((1000, 4), -2**31, 2**31 - 1),), True),
        ("pool_max", "int32 K=9", (ints((999, 9), -100, 100),), True),
        ("pool_max", "float32 K=4", (floats((1000, 4)),), True),
        ("ewise_add", "int32 wrap n=1000003", (ints((1000003,), -2**31, 2**31 - 1),
                                                ints((1000003,), -2**31, 2**31 - 1)), True),
        ("ewise_add", "float32 n=4097", (floats((4097,)), floats((4097,))), True),
        ("relu", "int32 n=1000003", (ints((1000003,), -2**31, 2**31 - 1),), True),
        ("relu", "float32 n=4097", (floats((4097,)),), True),
    ]
    for kernel, case, cpu_args, exact in edge_cases:
        got = run[kernel](*[a.to(dev) if torch.is_tensor(a) else a for a in cpu_args])
        torch.cuda.synchronize()
        smoke.check(kernel, case, got, plain[kernel](*cpu_args), exact)

    # whole-network checks at a small input: TINY (stem max pool) in int32,
    # and a float32 conv through the registry
    tiny = resnet.TINY
    tp = resnet.init_params(tiny, SEED, device="cpu")
    tx = resnet.make_input(tiny, 4, seed=SEED + 1, device="cpu")
    tiny_gpu = resnet.ResNet(tiny, tp, device=dev)(tx.to(dev))
    smoke.check("resnet", "TINY batch 4 logits", tiny_gpu, resnet.forward(tiny, tp, tx), True)
    fx, fw = floats((2, 5, 12, 12)), floats((7, 5, 3, 3))
    smoke.check("conv2d", "float32 stride 2 pad 1",
                api.conv2d(fx.to(dev), fw.to(dev), stride=2, padding=1),
                api.conv2d(fx, fw, stride=2, padding=1), False)
    torch.cuda.synchronize()
    attention_kernel_checks(torch, att, ref, smoke, dev, SEED + 3)
    entry_kernel_checks(torch, att, ht, rg, smoke, dev, SEED + 8)
    pool_ewise_edge_checks(torch, conv, ewise, smoke, dev, SEED + 10)
    gemm_htree_edge_checks(torch, conv, ht, smoke, dev, SEED + 11)
    bitslice_f32_edge_checks(torch, conv, bm, api, smoke, dev, SEED + 13)
    executor_route_checks(torch, api, att, pimsab_step, smoke, dev, SEED + 14)
    llm_bitslice_checks(torch, bm, smoke, dev, SEED + 15)
    llm_bitslice_checks(torch, bm, smoke, dev, SEED + 16, FAM_KN + FAM_KN_CHECKS)
    llm_bitslice_checks(torch, bm, smoke, dev, SEED + 17, FAM_HEADS, (1, LLM_REQUESTS), groups=1)
    n_ok = sum(c["ok"] for c in smoke.cases)
    print(f"phase 2 kernels vs plain: {n_ok}/{len(smoke.cases)} cases agree")

    # ---------------- phase 3a: the main path, RESNET18 eager ----------------
    expected = {}
    for name in resnet.layer_names(cfg):
        expected[LAUNCHED_BY[name]] = expected.get(LAUNCHED_BY[name], 0) + 1
    api.reset_launch_counts()
    t = time.perf_counter()
    with torch.no_grad():
        logits = model(x)
    torch.cuda.synchronize()
    first_forward_s = time.perf_counter() - t
    counts = api.launch_counts()
    launches = {k: counts.get(k, 0) for k in SOURCES}
    t = time.perf_counter()
    want = resnet.forward(cfg, params_cpu, x_cpu)
    cpu_forward_s = time.perf_counter() - t
    if logits.shape != (BATCH, cfg.num_classes) or logits.dtype != torch.int32:
        smoke.failures.append(f"logits have shape {tuple(logits.shape)} {logits.dtype}")
    smoke.check("resnet", f"RESNET18 batch {BATCH} logits", logits, want, True)
    if {k: v for k, v in counts.items() if v} != expected:
        smoke.failures.append(f"launch counts {counts} != expected {expected}")
    print(f"phase 3 RESNET18 b{BATCH}: logits {tuple(logits.shape)} |max| "
          f"{int(logits.abs().max())}, bit-equal to CPU: {torch.equal(logits.cpu(), want)}; "
          f"launches {launches} (expected {expected}); first forward {first_forward_s:.3f} s, "
          f"CPU plain forward {cpu_forward_s:.2f} s")
    path_launches = {"resnet18_eager": {k: v for k, v in counts.items() if v}}
    path_launches.update(dist_run.get("path_launches", {}))
    path_launches.update(tp_run.get("path_launches", {}))

    # ---------------- phase 3b: RESNET18 through the Program API ----------------
    traced = api.trace(lambda p, v: resnet.forward(cfg, p, v), name="resnet18")
    params = model.params()
    with ExecutorRecorder(api) as resnet_calls:
        api.reset_launch_counts()
        t = time.perf_counter()
        with torch.no_grad():
            logits_traced = traced(params, x)
        torch.cuda.synchronize()
        first_traced_s = time.perf_counter() - t
        counts = {k: v for k, v in api.launch_counts().items() if v}
        path_launches["resnet18_traced"] = counts
        smoke.check("program", f"traced RESNET18 batch {BATCH} logits vs eager", logits_traced,
                    logits.cpu(), True)
        if counts != expected:
            smoke.failures.append(f"traced RESNET18: launch counts {counts} != expected {expected}")
        info0 = api.compile_cache_info()
        api.reset_launch_counts()
        smoke.check("program", "traced call (graph replay) vs eager", traced(params, x), want, True)
        replay_counts = {k: v for k, v in api.launch_counts().items() if v}
        ex = api.compile(traced.program_for(params, x))
        info1 = api.compile_cache_info()
        if (info1.hits, info1.misses) != (info0.hits + 2, info0.misses):
            smoke.failures.append(f"traced RESNET18: compile cache {info0} → {info1}, expected two hits")
        if replay_counts != expected:
            smoke.failures.append(f"traced RESNET18 replay: launch counts {replay_counts} != expected {expected}")
        smoke.check("program", "held Executor replay vs eager", ex(params, x), logits.cpu(), True)
    resnet_held = held_executor_checks(torch, api, smoke, "phase 3b RESNET18", resnet_calls, expected, [want])
    print(f"phase 3b traced RESNET18 b{BATCH}: {len(ex.program.ops)} ops, logits bit-equal to "
          f"eager: {torch.equal(logits_traced, logits)}; launches {counts} (first call: eager, then captured), "
          f"{replay_counts} a traced call's graph replay; routes {resnet_held}; first call "
          f"{first_traced_s:.3f} s; compile cache {info1.hits} hits / {info1.misses} misses")

    # ---------------- phase 3c: the bit-sliced GEMM at Table III ----------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m, k, n = TABLE3
    gx = torch.randn((m, k), generator=gen, device=dev)
    gw = torch.randn((k, n), generator=gen, device=dev) * 0.1
    host = {"cuda": {"x": gx}, "cpu": {"x": gx.cpu()}}
    bitslice_paths = []
    for preset in GEMM_PRESETS:
        spec = getattr(api.PrecisionSpec, preset)
        w_st = api.SlicedTensor.quantize(gw, spec, weight=True)
        wq, ws = w_st.to_int(), w_st.scale.reshape(-1)
        for d, wqd, wsd in (("cuda", wq, ws), ("cpu", wq.cpu(), ws.cpu())):
            host[d][preset] = (wqd, wsd)
        r = run_bitslice_path(
            torch, api, bm, smoke, f"gemm_{preset}",
            lambda d, preset=preset, spec=spec: api.quantized_matmul(host[d]["x"], *host[d][preset], spec),
            {"bitslice_matmul": 1})
        if r:
            bitslice_paths.append(r)
    # zero-skip: int16 operands whose activations fit one slice, so the high
    # activation slice is all zero and both pairs that read it are skipped
    zx = torch.randint(-100, 100, (m, k), generator=gen, device=dev, dtype=torch.int32)
    zw = torch.randint(-30000, 30000, (k, n), generator=gen, device=dev, dtype=torch.int32)
    zero = {"cuda": (zx, zw), "cpu": (zx.cpu(), zw.cpu())}
    r = run_bitslice_path(
        torch, api, bm, smoke, "gemm_zero_skip",
        lambda d: api.matmul(api.SlicedTensor.from_int(zero[d][0], 16),
                             api.SlicedTensor.from_int(zero[d][1], 16)),
        {"bitslice_matmul": 1}, skipped=((1, 0), (1, 1)))
    if r:
        bitslice_paths.append(r)

    # ---------------- phase 3d: quant_linear_relu at Qwen2-0.5B's MLP width ----------------
    mq, kq, nq = QLR
    qx = torch.randn((mq, kq), generator=gen, device=dev)
    qp = common.quantize_weight(torch.randn((kq, nq), generator=gen, device=dev) * 0.05, 8)
    qlr = {"cuda": (qp, qx), "cpu": ({k_: v.cpu() for k_, v in qp.items()}, qx.cpu())}
    with ExecutorRecorder(api) as qlr_calls:
        r = run_bitslice_path(
            torch, api, bm, smoke, "quant_linear_relu",
            lambda d: common.quant_linear_relu(*qlr[d], api.PrecisionSpec.w8a16),
            {"bitslice_matmul": 1, "relu": 1})
    if r:
        bitslice_paths.append(r)
        qlr_held = held_executor_checks(torch, api, smoke, "phase 3d quant_linear_relu", qlr_calls,
                                        {"bitslice_matmul": 1, "relu": 1}, [ewise._ewise_plain("relu", r["plain"])])
        print(f"phase 3d quant_linear_relu Executor: {qlr_held}")
        # the relu kernel at the accumulator this path hands it
        smoke.check("relu", "quant_linear_relu accumulator", ewise._ewise("relu", r["out"]),
                    ewise._ewise_plain("relu", r["out"].cpu()), True)
    for r in bitslice_paths:
        path_launches[r["path"]] = r["launches"]
        print(f"phase 3c/d {r['path']}: launches {r['launches']}, kernel path {r['kernel_path']}, "
              f"executed pairs {r['executed']}, "
              f"launched {r['launched']}, skipped {r['skipped']}; kernel vs plain max_abs_err "
              f"{r['max_abs_err']}; plain {r['plain_ms']:.0f} ms on the CPU")
    torch.cuda.synchronize()

    # ---------------- phase 3e: serving, the decode step at Qwen2-0.5B's attention width ----------------
    serve_run = run_serve_path(torch, api, att, pimsab_step, smoke, dev, SEED + 4)
    path_launches["decode_serving"] = serve_run["counts"]
    serve_held = held_executor_checks(torch, api, smoke, "phase 3e decode serving", serve_run["executors"],
                                      PROGRAM_STEP_LAUNCHES)
    print(f"phase 3e decode serving: {len(DECODE_PREFILL)} requests x {DECODE_STEPS} tokens at capacity "
          f"{DECODE_CAPACITY}; launches {serve_run['counts']}; compile cache {serve_run['cache']}; softmax "
          f"row sums {min(serve_run['prob_sums'])}-{max(serve_run['prob_sums'])}, nonzero entries "
          f"{min(serve_run['prob_nonzero'])}-{max(serve_run['prob_nonzero'])}; Executor {serve_held}; first run "
          f"{serve_run['first_s']:.3f} s, CPU copies {serve_run['cpu_s']:.2f} s")

    # ---------------- phase 3f: the decode layer at Qwen2-0.5B's width ----------------
    layers = {}
    for i, cap in enumerate((DECODE_CAPACITY, 4096)):
        layers[cap] = run_layer_path(torch, api, att, pimsab_step, smoke, dev, SEED + 5 + i, cap)
        path_launches[f"decode_layer_{cap}"] = layers[cap]["counts"]
        layers[cap]["held"] = held_executor_checks(torch, api, smoke, f"phase 3f decode layer {cap}",
                                                   layers[cap]["executors"], LAYER_LAUNCHES)
        print(f"phase 3f decode layer {LAYER_DIMS} capacity {cap}: launches {layers[cap]['counts']}; "
              f"Executor {layers[cap]['held']}; "
              f"softmax row sum {layers[cap]['prob_sum']}, {layers[cap]['prob_nonzero']} nonzero; "
              f"|out| max {layers[cap]['out_absmax']}")
    torch.cuda.synchronize()

    # ---------------- phase 3g: the entry points no model path reaches ----------------
    entry = run_entry_points(torch, api, ref, smoke, dev, entry_point_cases(torch, api, cfg, SEED + 9))
    for r in entry:
        path_launches[f"{r['kernel']}[{r['case']}]"] = {r["launched"]: r["launches"]}
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase 3 peak device memory {peak_gib:.2f} GiB allocated ({torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB "
          f"reserved now), {api.compile_cache_info().size} cached Executors")

    # ---------------- phase 3h: the eager pimsab backend, operands on the card ----------------
    pimsab = run_pimsab_phase(torch, np, api, pimsab_backend, resnet, smoke, dev)

    # ---------------- phase 3i: the pimsab Program lowering, operands on the card ----------------
    pimsab["program_lowering"] = run_pimsab_program_phase(torch, np, api, pimsab_backend, resnet, pimsab_step,
                                                          smoke, dev)
    path_launches["pimsab_tiny_card_executor"] = pimsab["program_lowering"]["tiny"]["card_executor_launches"]

    # ---------------- phase 3j: the LLM serving path at Qwen2-0.5B's full width ----------------
    llm = run_llm_phase(torch, api, bm, att, smoke, dev, gpu, dist_run)
    path_launches["llm_serving"] = llm["path_launches"]
    tp_ref = tp_run.get("serving", {}).get(LLM_ARCH, {}).get("runs", {}).get("quant_kv=False", {}).get("ref_digests")
    llm["tp_reference_equal"] = tp_ref == llm["logits_digests"]
    smoke.cases.append({"kernel": "tp", "case": "phase 3j 4x8 logits vs phase 3o's 1-rank run", "exact": True,
                        "ok": llm["tp_reference_equal"], "max_abs_err": None, "shape": [], "dtype": ""})
    if not llm["tp_reference_equal"]:
        smoke.failures.append(f"phase 3j: the 4x8 logits digests {llm['logits_digests']} differ from phase 3o's "
                              f"1-rank run's {tp_ref}")
    print(f"phase 3j 4x8 prefill and decode step logits bit-equal to phase 3o's 1-rank run, the reference of its "
          f"two ranks: {llm['tp_reference_equal']}")
    torch.cuda.synchronize()

    # ---------------- phase 3k: the scheduler and multi-chip scale-out ----------------
    serve_scaling = run_serve_scaling_phase(torch, np, api, pimsab_step, scheduler, resnet, smoke, dev, gpu)
    path_launches["serve_card_replay"] = serve_scaling["serve_card_replay"]["launches"]
    path_launches["cluster_card_executors"] = serve_scaling["cluster"]["card_executor_launches"]

    # ---------------- phase 3l: the MoE, recurrent and encoder-decoder families at full width ----------------
    fam = run_families_phase(torch, api, bm, att, rg, smoke, dev, gpu)
    path_launches["families_serving"] = fam["path_launches"]
    for arch, o in fam["others"].items():
        path_launches[f"families_serving[{arch}]"] = o["path_launches"]
    torch.cuda.synchronize()

    # ---------------- phase 3m: the training path at RecurrentGemma-2B's full width and depth ----------------
    train = run_training_phase(torch, api, rg, smoke, dev, gpu, dist_run)
    path_launches["training"] = train["path_launches"]

    # ---------------- phase 3p: the dry run's predictions against the live runs ----------------
    dry = run_dryrun_phase(torch, api, smoke, dev, gpu, tp_run)
    for label, c in dry["cells"].items():
        path_launches[f"dryrun_live[{label}]"] = c["live"]["launches"]


    # ---------------- phase 4: timing ----------------
    library = {
        "gemm": None,  # PyTorch has no int32 matrix product on CUDA
        "pool_sum": lambda p: torch.sum(p, dim=1, dtype=p.dtype),
        "pool_max": lambda p: torch.amax(p, dim=1),
        "ewise_add": torch.add,
        "relu": torch.relu,
    }

    def work(kernel, args):
        """(bytes moved, operations, operation rate) of one call: each input
        read once, each output written once.  An int32 GEMM runs int8
        tensor-core digit products, two operations each, as many as its
        inputs need (``digit_products``); a float32 multiply-add is two FLOPs;
        other int32 operations run at the IMAD rate."""
        integer = args[0].dtype == torch.int32
        if kernel == "gemm":
            m, k, n = gemm_dims(*args)
            if integer:
                return 4 * (m * k + k * n + m * n), 2 * digit_products(torch, *args), INT8_OPS_PER_S
            return 4 * (m * k + k * n + m * n), m * k * n, FP32_FLOP_PER_S / 2
        rate = imad_per_s if integer else FP32_FLOP_PER_S
        if kernel.startswith("pool"):
            rows, k = args[0].shape
            return 4 * (rows * k + rows), rows * k, rate
        n = args[0].numel()
        return 4 * n * (len(args) + 1), n, rate

    # pool_max is not on RESNET18's path (no stem pool): time it at the
    # window matrix of phase 3g's stem max pool
    entry_launches = {r["launched"]: r["launches"] for r in entry if r["kernel"] == "maxpool2d"}
    if not calls["pool_max"]:
        (stem,) = next(r["cpu_args"] for r in entry if r["kernel"] == "maxpool2d")
        calls["pool_max"].append((ref.pool_patches(stem, 2, 2).contiguous().to(dev),))

    rows = []
    details = []
    for kernel, arglist in calls.items():
        ms = eager_ms = plain_ms = bound_ms = lib_ms = 0.0
        bytes_s = ops_s = 0.0
        # the pool and ewise kernels: graph timers, warm and with inputs cold
        # in L2, of each call and of its library call, read in paired rounds
        warm_pairs, cold_pairs, mine = [], [], []
        imad_ms = 0.0  # the SIMT design's bound: int32 multiply-adds on IMAD
        for args in arglist:
            k_eager = cuda_ms(torch, lambda: run[kernel](*args))
            if kernel == "gemm":
                k_ms, p_ms = graph_ms(torch, lambda: run[kernel](*args)), None
            else:
                p_ms = graph_ms(torch, lambda: plain[kernel](*args))
                warm_pairs.append((graph_timer(torch, lambda args=args: run[kernel](*args)),
                                   graph_timer(torch, lambda args=args: library[kernel](*args))))
                cold_pairs.append((cold_timer(torch, run[kernel], args), cold_timer(torch, library[kernel], args)))
                k_ms = 0.0  # filled in from the rounds below
            nbytes, ops, rate = work(kernel, args)
            b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / rate * 1e3
            if kernel == "gemm":
                m, k, n = gemm_dims(*args)
                imad_ms += m * k * n / imad_per_s * 1e3
            ms += k_ms
            eager_ms += k_eager
            plain_ms += p_ms or 0.0
            bound_ms += max(b_bytes, b_ops)
            bytes_s += b_bytes
            ops_s += b_ops
            mine.append({"kernel": kernel, "shapes": [list(sh) for sh in shapes_of(args)], "ms": k_ms,
                         "eager_ms": k_eager, "plain_ms": p_ms, "library_ms": None,
                         "bound_ms": max(b_bytes, b_ops), "bytes": nbytes, "ops": ops})
        details += mine
        if kernel == "gemm":
            plain_ms = gemm_plain_cpu_ms  # on the CPU: no int32 matmul on CUDA
        else:
            rounds = {}
            for temp, pairs in (("warm", warm_pairs), ("cold", cold_pairs)):
                sums, each = paired_rounds(pairs, PAIRED_ROUNDS)
                rounds[temp] = dict(sums, kernel_no_slower=sum(k <= lib for k, lib in zip(sums["kernel"],
                                                                                        sums["library"])))
                for d, (k, lib) in zip(mine, each):
                    d.update({"ms": k, "library_ms": lib} if temp == "warm" else
                             {"cold_ms": k, "library_cold_ms": lib})
            ms, lib_ms = median(sorted(rounds["warm"]["kernel"])), median(sorted(rounds["warm"]["library"]))
            cold = {"ms": median(sorted(rounds["cold"]["kernel"])),
                    "library_ms": median(sorted(rounds["cold"]["library"]))}
        n_launches = launches[kernel] or entry_launches.get(kernel, 0)
        on_path = n_launches > 0
        row = {
            "name": kernel, "route": "cuda", "source": SOURCES[kernel], "replaces": REPLACES[kernel],
            "launches": n_launches,
            "max_abs_err": max((c["max_abs_err"] or 0.0) for c in smoke.cases if c["kernel"] == kernel),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
            "library_ms": None if library[kernel] is None else lib_ms,
            "calls_timed": len(arglist), "eager_ms": eager_ms,
            "plain_device": "cpu" if kernel == "gemm" else "cuda",
            "main_path_max_abs_err": main_err[kernel] if on_path else None,
        }
        if kernel == "gemm":
            row.update(imad_bound_ms=imad_ms, b_layouts=[args[2] for args in arglist])
        else:
            row.update(cold_ms=cold["ms"], library_cold_ms=cold["library_ms"], rounds=rounds,
                       channels_last_operands=sum(
                           not a.is_contiguous() and a.is_contiguous(memory_format=torch.channels_last)
                           for args in arglist for a in args), operands=sum(len(args) for args in arglist))
        rows.append(row)
        paired_text = (f"; the SIMT design's IMAD bound {imad_ms:.4f} ms" if kernel == "gemm" else
                       f"; medians of {PAIRED_ROUNDS} rounds read in turns with the library call (kernel no slower in "
                       f"{rounds['warm']['kernel_no_slower']} warm, {rounds['cold']['kernel_no_slower']} cold); cold L2 "
                       f"{cold['ms']:.4f} ms (roofline share {bound_ms / cold['ms']:.1%}), library cold "
                       f"{cold['library_ms']:.4f} ms; {row['channels_last_operands']} of {row['operands']} operands "
                       f"channels-last")
        print(f"kernel {kernel}: {len(arglist)} calls, {ms / len(arglist):.4f} ms per call, "
              f"{ms:.4f} ms summed in graph replay "
              f"({eager_ms:.4f} ms eager; bound {bound_ms:.4f} ms "
              f"by {row['bound_by']}, roofline share {bound_ms / ms:.1%}), plain {plain_ms:.4f} ms on "
              f"{row['plain_device']}, library {row['library_ms']}, launches/forward {launches[kernel]}, "
              f"on the stem pool path {entry_launches.get(kernel, 0)}{paired_text}")

    fwd_samples = forward_samples(torch, lambda: model(x), FORWARD_SAMPLES)
    fwd_ms = fwd_samples[len(fwd_samples) // 2]
    fwd_p80 = fwd_samples[int(0.8 * len(fwd_samples)) - 1]
    kernel_ms = sum(r["ms"] for r in rows if r["launches"])
    print(f"RESNET18 b{BATCH} forward: median {fwd_ms:.3f} ms, p80 {fwd_p80:.3f} ms, "
          f"min {fwd_samples[0]:.3f}, max {fwd_samples[-1]:.3f} over {len(fwd_samples)} forwards "
          f"(CUDA events each); {BATCH / fwd_ms * 1e3:.1f} images/s at the median; "
          f"the ported kernels alone {kernel_ms:.3f} ms")
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in path_launches.items() if row["name"] in c}

    # the Program API beside the eager forward, each call from an idle card
    lat = {
        "eager_forward": sync_samples(torch, lambda: model(x), LATENCY_SAMPLES),
        "traced_call": sync_samples(torch, lambda: traced(params, x), LATENCY_SAMPLES),
        "executor_replay": sync_samples(torch, lambda: ex(params, x), LATENCY_SAMPLES),
        "executor_eager_replay": sync_samples(torch, lambda: eager_call(program, ex, params, x), LATENCY_SAMPLES),
    }
    resnet_leaves = program.tree_flatten(((params, x), {}))[0]
    resnet_copy_ms, resnet_copy_bytes = copy_in_ms(torch, resnet_leaves)
    retrace = []
    for _ in range(LATENCY_SAMPLES):
        t = time.perf_counter()
        traced.trace(params, x)
        retrace.append((time.perf_counter() - t) * 1e3)
    lat["retrace_host"] = sorted(retrace)
    back_to_back = {
        "eager_forward": forward_samples(torch, lambda: model(x), LATENCY_SAMPLES),
        "traced_call": forward_samples(torch, lambda: traced(params, x), LATENCY_SAMPLES),
        "executor_replay": forward_samples(torch, lambda: ex(params, x), LATENCY_SAMPLES),
        "executor_eager_replay": forward_samples(torch, lambda: eager_call(program, ex, params, x), LATENCY_SAMPLES),
    }
    program_timing = {
        "copy_in_device_ms": resnet_copy_ms, "copy_in_bytes": resnet_copy_bytes, "routes": resnet_held,
        "latency_ms_median": {k: median(v) for k, v in lat.items()},
        "back_to_back_ms_median": {k: median(v) for k, v in back_to_back.items()},
        "latency_ms_samples": lat, "back_to_back_ms_samples": back_to_back,
    }
    print(f"Program API RESNET18 b{BATCH} (median of {LATENCY_SAMPLES}, host clock from an idle "
          f"card): eager {median(lat['eager_forward']):.3f} ms, traced call "
          f"{median(lat['traced_call']):.3f} ms, held Executor graph replay {median(lat['executor_replay']):.3f} ms, "
          f"its eager replay {median(lat['executor_eager_replay']):.3f} ms, copy-in {resnet_copy_ms:.4f} ms device "
          f"time ({resnet_copy_bytes} bytes, {resnet_copy_ms / median(lat['executor_replay']):.1%} of the replay), "
          f"re-trace alone {median(lat['retrace_host']):.3f} ms host; back to back (CUDA events): "
          + ", ".join(f"{k} {median(v):.3f} ms" for k, v in back_to_back.items()))

    # the bit-sliced GEMM per path: kernel (graph replay and eager), its
    # bound, its plain version (CPU), torch._int_mm where one pair is all
    # there is (medians of paired rounds), the kernel with its inputs cold in
    # L2 where they fit in it (quant_linear_relu), and the whole entry-point
    # call from an idle card
    bitslice_rows = []
    for r in bitslice_paths:
        xs, ws, sb, pairs = r["args"]
        k_timer = graph_timer(torch, lambda xs=xs, ws=ws, sb=sb, pairs=pairs: bm._bitslice_gemm(xs, ws, sb, pairs))
        k_eager = cuda_ms(torch, lambda: bm._bitslice_gemm(xs, ws, sb, pairs))
        lib_ms = lib_agrees = rounds = cold_ms = None
        if tuple(pairs) == ((0, 0),):
            lib_agrees = torch.equal(torch._int_mm(xs[0], ws[0]), r["out"])
            x0, w0 = xs[0], ws[0]
            sums, _ = paired_rounds([(k_timer, graph_timer(torch, lambda: torch._int_mm(x0, w0)))], PAIRED_ROUNDS)
            rounds = dict(sums, kernel_no_slower=sum(k <= lib for k, lib in zip(sums["kernel"], sums["library"])))
            k_ms, lib_ms = median(sorted(sums["kernel"])), median(sorted(sums["library"]))
        else:
            k_ms = k_timer()
        nbytes, ops = bitslice_work(xs, ws, sb, pairs)
        if nbytes - 4 * r["out"].numel() < COLD_BYTES // 4:  # inputs that sit in L2 when warm
            cold_ms = cold_timer(torch, lambda a, b: bm._bitslice_gemm(a, b, sb, pairs), (xs, ws))()
        b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        call_ms = sync_samples(torch, lambda: r["run"]("cuda"), LATENCY_SAMPLES // 2)
        row = {
            "name": f"bitslice_matmul[{r['path']}]", "route": "cuda", "source": BITSLICE_SOURCE,
            "replaces": BITSLICE_REPLACES, "launches": r["launches"]["bitslice_matmul"],
            "max_abs_err": r["max_abs_err"], "ms": k_ms, "plain_ms": r["plain_ms"],
            "bound_ms": max(b_bytes, b_ops), "bound_by": "operations" if b_ops > b_bytes else "bytes",
            "library_ms": lib_ms, "eager_ms": k_eager, "plain_device": "cpu", "kernel_path": r["kernel_path"],
            "cold_ms": cold_ms, "rounds": rounds,
            "library": "torch._int_mm" if lib_ms is not None else None,
            "library_agrees": lib_agrees, "launches_by_path": {r["path"]: r["launches"]["bitslice_matmul"]},
            "shapes": [list(xs.shape), list(ws.shape)], "slice_bits": sb,
            "pairs": [list(p) for p in pairs], "bytes": nbytes, "ops": ops,
            "path_call_ms_median": median(call_ms), "path_call_ms_samples": call_ms,
        }
        bitslice_rows.append(row)
        paired_text = "" if rounds is None else (
            f" (medians of {PAIRED_ROUNDS} rounds read in turns, kernel no slower in {rounds['kernel_no_slower']})")
        cold_text = "" if cold_ms is None else f"; inputs cold in L2 {cold_ms:.4f} ms"
        print(f"kernel {row['name']} ({r['kernel_path']} path): {k_ms:.4f} ms in graph replay ({k_eager:.4f} ms "
              f"eager; bound {row['bound_ms']:.4f} ms by {row['bound_by']}, roofline share "
              f"{row['bound_ms'] / k_ms:.1%}){cold_text}, plain {r['plain_ms']:.1f} ms on the CPU, "
              f"torch._int_mm {lib_ms}{paired_text}; whole {r['path']} call {median(call_ms):.3f} ms")

    k1_rows = [decode_gemm_timing(torch, conv, smoke, layers[DECODE_CAPACITY], imad_per_s),
               f32_gemm_timing(torch, conv, smoke, dev, SEED + 12)]
    floor_ms = launch_floor(torch, dev)
    print(f"launch floor: {floor_ms * 1e3:.3f} us a launch (x.add_(1) on one element, CUDA-graph replay, "
          f"median of 5)")
    attention_rows = attention_timing(torch, att, ref, smoke, serve_run, imad_per_s, floor_ms)
    for row in attention_rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in path_launches.items() if row["name"] in c}
    decode = decode_latency(torch, api, program, pimsab_step, dev, SEED + 7, layers[DECODE_CAPACITY])
    entry_rows = entry_point_timing(torch, att, ht, rg, smoke, entry, imad_per_s)
    entry_latency = entry_executor_latency(torch, program, entry)
    llm_latency, llm_rows = llm_timing(torch, bm, att, smoke, llm, floor_ms)
    tp_rows = tp_kernel_rows(torch, bm, att, smoke, tp_run, floor_ms, gpu)
    fam_latency, fam_rows = families_timing(torch, bm, att, rg, smoke, fam, floor_ms)
    train_rows = training_timing(torch, rg, smoke, train, floor_ms)
    for r in train_rows:  # phase 3n's launches of K11 beside 3m's
        kernel = r["name"].split("[")[0]
        r["launches_by_path"]["dist_training"] = dist_run.get("training", {}).get("launches", {}).get(kernel, 0)

    # ---------------- phase 5: where the forward's device time goes ----------------
    prof_iters = 3
    wall_ms, by_name, (copies, copy_ms) = device_profile(torch, lambda: model(x), prof_iters)
    busy_ms = sum(ms for _, ms in by_name.values())
    profile_summary = {
        "wall_ms_per_forward": wall_ms / prof_iters,
        "device_busy_ms_per_forward": busy_ms / prof_iters if by_name else None,
        "idle_share": 1 - busy_ms / wall_ms if by_name else None,
        "kernels": sorted(([n, c / prof_iters, ms / prof_iters] for n, (c, ms) in by_name.items()),
                          key=lambda r: -r[2]),
        "glue_launches_per_forward": sum(c for n, (c, _) in by_name.items() if is_glue(n)) / prof_iters,
        "glue_device_ms_per_forward": sum(ms for n, (_, ms) in by_name.items() if is_glue(n)) / prof_iters,
        "copies_per_forward": copies / prof_iters,
        "copy_device_ms_per_forward": copy_ms / prof_iters,
    }
    if by_name:
        top = "; ".join(f"{n[:40]} x{c:g} {ms:.3f} ms" for n, c, ms in profile_summary["kernels"][:6])
        print(f"profile RESNET18 b{BATCH} (torch.profiler, {prof_iters} forwards): "
              f"{wall_ms / prof_iters:.3f} ms wall, {busy_ms / prof_iters:.3f} ms device busy, "
              f"idle share {profile_summary['idle_share']:.3f}; per forward: {top}")
        print(f"profile RESNET18 b{BATCH} PyTorch glue per forward: "
              f"{profile_summary['copies_per_forward']:g} copies (aten::copy_) taking "
              f"{profile_summary['copy_device_ms_per_forward']:.4f} ms of device time; all glue "
              f"{profile_summary['glue_launches_per_forward']:g} launches, "
              f"{profile_summary['glue_device_ms_per_forward']:.4f} ms")
    else:
        print("profile: the profiler saw no device activity; device breakdown not measured")
    for r in bitslice_paths:
        if r["path"] == "quant_linear_relu":  # a graph replay: profiled in the child process below
            continue
        wall, names, _ = device_profile(torch, lambda: r["run"]("cuda"), 1)
        busy = sum(ms for _, ms in names.values())
        profile_summary[r["path"]] = {
            "wall_ms": wall, "device_busy_ms": busy if names else None,
            "idle_share": 1 - busy / wall if names else None,
            "kernels": sorted(([nm, c, ms] for nm, (c, ms) in names.items()), key=lambda q: -q[2]),
        }
        if names:
            top = "; ".join(f"{nm[:40]} x{c:g} {ms:.3f} ms"
                            for nm, c, ms in profile_summary[r["path"]]["kernels"][:5])
            print(f"profile {r['path']} (one call): {wall:.3f} ms wall, {busy:.3f} ms device busy; {top}")
    # The Executors' graph replays are profiled in a process of their own:
    # in this one, after its dozens of profiler sessions, a graph replay
    # inside a session crashed the process in most runs (a fresh process
    # never did).  The child builds the same paths at the same shapes.
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--replay-profiles"], cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
    replay_profiles = json.loads(child.stdout.splitlines()[-1]) if child.returncode == 0 else None
    if replay_profiles is None:
        smoke.failures.append(f"phase 5: the graph-replay profiles' process exited {child.returncode}: "
                              f"{child.stderr[-2000:]}")
    else:
        for label, summary in replay_profiles["profiles"].items():
            profile_summary[label] = summary
            if summary["device_busy_ms_per_call"] is None:
                print(f"profile {label}: the profiler saw no device activity; not measured")
                continue
            top = "; ".join(f"{nm[:40]} x{c:g} {ms * 1e3:.2f} us" for nm, c, ms in summary["kernels"][:6])
            print(f"profile {label} ({summary['calls']} calls, graph replay, its own process): "
                  f"{summary['wall_ms_per_call'] * 1e3:.2f} us wall, {summary['device_busy_ms_per_call'] * 1e3:.2f} us "
                  f"device busy, idle share {summary['idle_share']:.3f}; per call: {top}")
        off = {k: v for k, v in replay_profiles["routes"].items() if v != ["graph"]}
        if off:
            smoke.failures.append(f"phase 5: Executors off the graph route in the profiling process: {off}")
        for arch, label, s in ((a, lb, v) for a, by in replay_profiles["llm"].items() for lb, v in by.items()):
            profile_summary[f"LLM {arch} {label}"] = s
            if s["device_busy_ms_per_step"] is None:
                print(f"profile LLM {arch} {label}: the profiler saw no device activity; not measured")
                continue
            top = "; ".join(f"{nm[:40]} x{cnt:g} {ms * 1e3:.1f} us" for nm, cnt, ms in s["kernels"][:5])
            print(f"profile LLM {arch} {label} ({s['steps']} eager steps, its own process; {gpu}): "
                  f"{s['wall_ms_per_step']:.3f} ms wall, {s['device_busy_ms_per_step']:.3f} ms device busy, idle "
                  f"share {s['idle_share']:.3f}, {s['device_kernels_per_step']:g} device kernels; K4 x{s['k4_launches_per_step']:g} {s['k4_ms_per_step']:.4f} ms "
                  f"({s['k4_share_of_busy']:.1%} of busy), K6 x{s['k6_launches_per_step']:g} "
                  f"{s['k6_ms_per_step']:.4f} ms ({s['k6_share_of_busy']:.1%}); per step: {top}")
    decode_summary = {
        k: {cap: decode[cap][k] for cap in (4096, DECODE_CAPACITY)}
        for k in ("step_ms_median", "program_ms_median", "eager_step_ms_median", "eager_program_ms_median",
                  "copy_in_device_ms", "step_device_ms")
    }
    decode_summary.update({"layer_ms_median": decode["layer"]["ms_median"],
                           "layer_eager_ms_median": decode["layer"]["eager_ms_median"],
                           "layer_copy_in_device_ms": decode["layer"]["copy_in_device_ms"],
                           "layer_device_ms": decode["layer"]["device_ms"]})
    for cap in (4096, DECODE_CAPACITY):
        del decode[cap]["step"]
    registered = {name: LAUNCHED_BY.get(name, name) for name in sorted(api.registered_kernels())}

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda, "batch": BATCH,
        "sm_count": sm_count, "max_sm_clock_hz": clock_hz, "launch_floor_ms": floor_ms, "forward_ms": fwd_ms,
        "forward_ms_p80": fwd_p80, "forward_ms_samples": fwd_samples,
        "kernel_ms": kernel_ms, "profile": profile_summary, "launches": launches, "expected_launches": expected,
        "path_launches": path_launches, "program": program_timing, "peak_memory_gib": peak_gib,
        "entry_executor_latency": entry_latency,
        "kernels": rows + k1_rows + bitslice_rows + attention_rows + entry_rows + llm_rows + fam_rows + train_rows
        + tp_rows,
        "registered_kernels": registered,
        "entry_points": [{k: v for k, v in r.items() if k not in ("args", "cpu_args", "want", "ex")} for r in entry],
        "decode": decode, "decode_summary": decode_summary,
        "decode_serving": dict({k: serve_run[k] for k in ("counts", "step_counts", "cache", "first_s", "cpu_s",
                                                           "prob_sums", "prob_nonzero")}, executor=serve_held),
        "decode_layer": {cap: {k: v for k, v in r.items() if k not in ("ex", "args", "gemm_calls", "executors")}
                         for cap, r in layers.items()},
        "pimsab": pimsab, "serve_scaling": serve_scaling, "calls": details, "cases": smoke.cases, "failures": smoke.failures,
        "llm": dict({k: v for k, v in llm.items() if k not in ("recorder", "steps")}, latency=llm_latency),
        "families": dict({k: v for k, v in fam.items() if k not in ("recorder", "steps")}, latency=fam_latency),
        "training": {k: v for k, v in train.items() if k != "recorded"},
        "dist": {k: v for k, v in dist_run.items() if k not in ("cases", "failures")},
        "tp": tp_run,
        "dryrun": dry,
    }, indent=1))

    if smoke.failures:
        for f in smoke.failures:
            print("FAIL", f, file=sys.stderr)
        return 1
    path = [r for r in rows if r["launches"]] + k1_rows + bitslice_rows + attention_rows + entry_rows + llm_rows \
        + fam_rows + train_rows + tp_rows
    off_path = [r["name"] for r in rows if not r["launches"]]
    if off_path:
        print(f"FAIL kernels launched on no path: {off_path}", file=sys.stderr)
        return 1
    print(gpu)
    print(json.dumps({"kernels": path, "registered_kernels": registered, "launch_floor_ms": floor_ms,
                      "forward_ms": fwd_ms, "forward_ms_p80": fwd_p80, "batch": BATCH,
                      "copies_per_forward": profile_summary["copies_per_forward"] if by_name else None,
                      "path_launches": path_launches,
                      "program_latency_ms": program_timing["latency_ms_median"],
                      "program_copy_in_ms": resnet_copy_ms, "decode": decode_summary,
                      "peak_memory_gib": peak_gib,
                      "llm": {label: {k: v for k, v in r.items() if not isinstance(v, list)}
                              for label, r in llm_latency.items()},
                      "families": {FAM_ARCH: {label: {k: v for k, v in r.items() if not isinstance(v, list)}
                                              for label, r in fam_latency.items()},
                                   **{arch: {k: v for k, v in o["latency"]["4x8"].items() if not isinstance(v, list)}
                                      for arch, o in fam["others"].items()}},
                      "families_seconds": fam["seconds"],
                      "training": {k: train[k] for k in ("arch", "batch", "seq", "steps", "step_ms_median",
                                                         "tokens_per_s", "peak_memory_gib", "launches_per_step",
                                                         "losses", "seconds")},
                      "dist": {"backend": dist_run.get("backend"), "seconds": dist_run.get("seconds"),
                               "training": {k: dist_run.get("training", {}).get(k) for k in (
                                   "launches_per_step", "collective_calls_per_step", "losses", "s_per_step",
                                   "max_memory_allocated")},
                               "serving": {k: dist_run.get("serving", {}).get(k) for k in (
                                   "launches", "collective_calls")},
                               "state_leaves_differing_from_3m": train.get("dist_differ"),
                               "logits_differing_from_3j": llm.get("dist_differ")},
                      "tp": {"ranks": TP_RANKS, "mesh": tp_run.get("mesh"), "seconds": tp_run.get("seconds"),
                             "serving": {arch: {k: {n: r.get(n) for n in (
                                 "launches", "bit_equal", "prefill_gap", "decode_step_gap")}
                                 for k, r in res.get("runs", {}).items()}
                                 for arch, res in tp_run.get("serving", {}).items()},
                             "training": {k: tp_run.get("training", {}).get(k) for k in (
                                 "layers", "launches_per_step", "collective_calls_per_step", "losses", "ref_losses",
                                 "loss_gap", "m_gap", "master_gap_lr", "peak_gib", "s_per_step", "profile")},
                             "logits_3j_equal_1_rank": llm.get("tp_reference_equal")},
                      "dryrun": {"seconds": dry["seconds"],
                                 "cells": {label: {"predicted": {k: c["predicted"][k] for k in (
                                     "launches", "argument_bytes", "output_bytes", "peak_bytes", "roofline_ms")},
                                     "live": {k: c["live"][k] for k in (
                                         "launches", "argument_bytes", "output_bytes", "peak_above_base",
                                         "step_ms_median")}} for label, c in dry["cells"].items()},
                                 "tp_collectives_equal": sum(v["equal"] for v in dry["tp_collectives"].values()),
                                 "tp_collectives_steps": len(dry["tp_collectives"]),
                                 "cli": dry["cli"]}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--replay-profiles"]:
        sys.exit(replay_profile_main())
    if sys.argv[1:] == ["--dist-phase"]:
        sys.exit(dist_phase_main())
    if sys.argv[1:2] == ["--tp-phase"]:
        sys.exit(tp_phase_main(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(train_resume_main() if sys.argv[1:] == ["--train-resume"] else main())
