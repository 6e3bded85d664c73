#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card and set-up: the card's name and power limit, torch and CUDA
     versions, and the build of every kernel from ``csrc/`` with nvcc
     (one nvcc per source, all started together);
  2. K1 (kmeans_assign's scan and, where k is split across blocks, its
     merge) against the plain PyTorch version at the K-Means path's
     shapes (plus ragged, bf16, wide, tie and tie-across-split-boundary
     cases), bitwise equal across split counts, the merge alone against
     its plain version, then timed beside the bound, the plain version
     and one library call;
  3. the K-Means path: ResourceManager -> PilotManager -> Pilot ->
     spawn_analytics_cluster -> AnalyticsEngine -> kmeans_fit on the
     paper's three K-Means scenarios at full size, both data paths,
     then one K-Means as a gang CU through the Agent;
  4. a torch.profiler breakdown of one K-Means run per scenario;
  5. mamba_scan against its plain version at the reference's test
     shapes, Hymba-1.5B and Falcon-Mamba-7B widths, an odd shape and
     bf16, then timed beside its bound and its plain version;
  6. flash_attention against its plain version at Hymba-1.5B (windowed
     and full causal), Llama-3.2-1B, Yi-6B and SeamlessM4T-medium
     encoder widths, a prime S, bf16, S_q != S_k, a window narrower than
     one tensor-core tile, hd 32 at a ragged S and the reference's test
     shapes, then timed (f32 and bf16) beside its bound at the peak of
     the units it runs on, its plain version and
     scaled_dot_product_attention;
  7. the autotuner entry point, ``autotune.main`` once per kernel family
     against a temporary registry: launches counted, a second call is a
     cache hit, the wrappers resolve the tuned blocks, a call at them
     matches the plain version, and K1 is bitwise equal across every
     candidate block size;
  8. the Session (the paper's Fig 8): pilots ``hpc`` and ``ana`` on one
     card, ``simulate`` -> ``analyze`` (kmeans_fit with K1) at each
     K-Means scenario and DCN cost: native on ``ana`` moving n*d*4 bytes
     at cost 0, a Mode-I carve on ``hpc`` moving none at cost 1, at most
     one change along the sweep, K1 in every analyze, and the cost of a
     direct kmeans_fit (rel 1e-5);
  9. Raptor micro-tasks: K1 on 16 row shards of the 1M x 50 points
     through ``Session.map``, bitwise equal to one call over all points,
     then the dispatch time of no-op micro-tasks and no-op CUs;
 10. failure recovery (a pilot killed by the FailureInjector, its data
     re-made through lineage on a survivor) and checkpoint/resume on a
     fresh resource manager, each giving phase 8's cost;
 11. the model stack: (a) a Hymba-1.5B and a Falcon-Mamba-7B Mamba layer
     at full width in f32, their scan through K3, against the same layer
     on the CPU (the plain scan), then Hymba-1.5B cut to 3 layers (full,
     windowed, full attention): forward and prefill above the window on
     the card against the CPU, and teacher-forced decode against the
     forward; left-padded prompts give the unpadded greedy tokens; (b) serving through ``make_prefill_step`` /
     ``make_decode_step(sample=True)`` at full width and depth in bf16:
     Hymba-1.5B (2 prompts of 4096 tokens, 32 greedy tokens) and
     Falcon-Mamba-7B (2 prompts of 2048, 16 tokens), K3 launched once per
     SSM layer a prefill and never in decode, prefill and decode times
     and K3's share of prefill device time from torch.profiler;
 12. the serving engine (``serve/engine.py``, ``kv_pages.py``,
     ``router.py``, ``Session.serve_pool``) at Hymba-1.5B's full width
     and depth in bf16, 8 prompts of 512-4096 tokens, 16 new tokens
     each: (a) one engine of 4 slots, each request alone and then all at
     once (token for token equal, fewer decode steps than tokens, K3 32
     times a prefill and never in a decode step), one decode step under
     torch.profiler; (b) ``Session.serve_pool`` over pilots d0, d1 and
     pf on the card, prefill as Raptor micro-tasks on pf, at DCN 1e-3
     (every splice local) and at 1e-15 with one slot an engine (pages
     shipped, ledger == router bytes), held against each request alone
     in an engine of 1 slot; (c) decode pilot d1 recovered through the
     ControlPlane mid-flight, its requests served on pf.  Every request
     must end with max_new tokens and no error; wall, req/s, time to
     first token and per output token are printed for each run;
 13. training (``optim/``, ``train/``, ``data/pipeline.py``,
     ``checkpoint/``, ``launch/train.py``) with the fused backward of the
     scan and its input tail (``mamba_ssm_bwd``): (a) K3's op-level
     backward (K3-bwd) and K3 forward against their plain versions at
     K3's shapes plus the training (4 x 2048) and hybrid (2 x 512) shapes
     at Hymba-1.5B width, K3-bwd twice (bitwise equal), timed beside its
     bound, its plain version and K3 forward; then the fused backward
     against its plain version at K3-bwd's test shapes and the training,
     hybrid and Falcon-Mamba-7B shapes, twice (bitwise equal), its exp
     against torch.exp in ulps, timed beside its bound, its plain version
     and the path it replaces (the tail's autograd and K3-bwd); (b) a
     full-width f32 Hymba-1.5B Mamba layer's gradients on the card
     against the CPU; (c) Hymba-1.5B at full width and depth trains 8
     steps of 8 x 2048 in 2 microbatches through ``launch.train`` (a gang
     CU on a Pilot), on the sharding layer's plan path: a 1 x 1
     ``DeviceMesh`` over NCCL world size 1, params and moments DTensors
     placed by ``sharding.Plan``, K3 and the fused backward reached
     through each layer's local shard: finite, falling loss, K3 128, the
     fused backward 64 and K3-bwd 0 launches a step, one profiled step, a
     blocking save of the whole (DTensor) state and a restore into a
     fresh Trainer (bitwise), and resume exactness at 4 layers (rel
     1e-3); (d) the paper's simulate -> analyze -> train DAG
     (``examples/torch_hybrid_pipeline.py``) at Hymba-1.5B width on
     pilots ``hpc`` and ``ana``, K1 in every analyze, ending "pipeline
     complete.";
 14. the sharding layer at one rank: (a) the plain ``make_train_step``
     on plain tensors from 13c's initial state and batches, its first
     PLAIN_STEPS steps' loss and grad norm against 13c's (rel 1e-4;
     whether bit for bit, and if not the first op that differs), ms a
     step, tokens/s and peak memory beside 13c's; (b) one
     Qwen2-MoE-A2.7B MoE layer at full width in bf16 (1 x 2048 tokens)
     on the 1 x 1 mesh: the expert-parallel combine against the GSPMD
     combine, forward and the layer's gradients (2e-2 of max |want|;
     whether bit for bit), each timed;
 15. the roofline and dry-run layer: (a) ``roofline.analytic``'s step
     cost of 13c's step, 11b's Hymba-1.5B prefill and one of its decode
     steps beside the walls measured there: model FLOP utilisation
     (model FLOPs over wall x the bf16 peak) and the roofline estimate's
     error ratio, and FlopCounterMode over one forward of 11a's 3-layer
     Hymba on the card against ``analytic.forward_flops`` (0.7-1.4); (b) a
     Session train stage (Hymba-1.5B, 13d's 2 x 512, STAGE_STEPS steps)
     carrying ``StageCost.from_model``: its placement's estimate, actual
     runtime and their ratio, and the pilot's estimate drift; (c)
     ``python -m repro_torch.launch.dryrun --device cuda`` in a
     subprocess on DRYRUN_CELL, a fake process group of 256 ranks with
     fake CUDA tensors: the record's keys, collective bytes, the analytic fit
     in 80 GB, no kernel launched; (d) 13c's plan path for SAVE_TP_STEPS
     steps with the ``save_tp_out`` remat policy: losses against 13c's
     (rel 1e-4; whether bit for bit), exact K3 and fused-backward counts,
     ms a step and peak memory;
 16. sharded serving on the weight-stationary serving plan: (a) 11b's
     Hymba-1.5B run (full width and depth, bf16, the same seed, prompts
     and 32 greedy tokens) through ``make_prefill_step`` /
     ``make_decode_step`` on DTensor params of ``Plan(serving=True)`` on
     a 1 x 1 ``DeviceMesh``, caches placed by ``Plan.cache_specs``: the
     prefill's logits and caches and each step's logits against 11b's
     (bit for bit, else 1e-4), the tokens equal, K3 32 times a prefill,
     the prefill wall, decode ms a step and peak beside 11b's; (b) in
     15c's subprocess, the dry-run of hymba-1.5b x ``decode_32k`` on the
     fake (16, 16) group (the sharded decode step): keys, 0 launches,
     collective bytes, and the traced peak a device beside the analytic
     one and the whole weights' bytes;
 17. the paper's dynamic resource management on the card: (a)
     ``examples/torch_quickstart.py`` with no device flag in a
     subprocess, its printed values those of the reference quickstart,
     its pilot startup and CU overhead printed; (b) the Fig-6 K-Means
     CUs (``kmeans_fit`` with K1 at 100k x 500, d 3) of three tenants
     under DRF (weights 1, 1, 2, each queue capped at 2 chips) on one
     pilot of 4 lease slots, each CU's draw staged from the GFS archive
     through the pilot's Prefetcher: with the first wave running, the
     ControlPlane drains 2 slots (the CUs there requeue onto the
     survivors) and then grows the pilot back.  Every CU ends DONE, the
     requeued ones on surviving slots, with centroids and cost bitwise
     those of the same fit alone; K1's scan and merge counts are exact
     for the fits run; no lease slot is held twice; no queue is charged
     past its cap; GFS moves each dataset's bytes once.

Phases 8-10 run after phase 4; each sets K1's launch counts to 0 before
it and reads them after.  Phase 11b sets K3's count to 0 before it and
reads it after (``launches_model``), and so does phase 12
(``launches_engine``).  Phases 13c and 13d set K3's, the fused
backward's and K3-bwd's counts to 0 before them and read them after
(``launches_train``, ``launches_hybrid``; the fused backward's and
K3-bwd's ``launches`` are 13c's: K3-bwd is off the model path, 0), and
phase 14a around its plain steps (``launches_plain``), and phase 15d
around its steps (``launches_save_tp_out``), and phase 16a around its
prefills and decode steps (``launches_serve_sharded``).
``launches_dryrun`` is the 15c subprocess's own count over its trace (0).
Phase 17b sets K1's counts to 0 just before its CUs are submitted and
reads them when all are done (``launches_elastic``).

The second-to-last lines are the ``{"kernels": ...}`` record and the
card line; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: FP32 (non-tensor) peak and HBM3 bandwidth
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# the same data sheet's dense tensor-core peaks: 495 TFLOP/s TF32, 989
# bf16.  K2's f32 path runs every product as three TF32 products
# (3xTF32), so its f32 peak is a third of the TF32 one.
TF32X3_FLOP_PER_S = 495e12 / 3
BF16_TC_FLOP_PER_S = 989e12
# the SFU (exp2, the core of expf): 16 results a clock an SM (CUDA C
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz, the clock of the FP32 peak above
SFU_PER_S = 16 * 132 * 1.98e9

ITERS = 2          # the paper's K-Means iterations
REPS = 5           # main-path repetitions per scenario and path
TIMED_LAUNCHES = 20
PLAIN_SCAN_REPS = 2    # the plain scan is a Python loop over S: ~0.1 s

# (label, B, S, di, st, bf16, timed): the reference's test shapes
# (tests/test_kernels.py), the Mamba widths of the repo's configs, an odd
# shape and bf16
SCAN_CASES = [
    ("test 1x32x8x4", 1, 32, 8, 4, False, False),
    ("test 2x64x16x8", 2, 64, 16, 8, False, False),
    ("test 1x128x32x16", 1, 128, 32, 16, False, False),
    ("st=2 3x40x16x2", 3, 40, 16, 2, False, False),
    ("odd 1x48x24x8", 1, 48, 24, 8, False, False),
    ("bf16 2x256x64x16", 2, 256, 64, 16, True, False),
    ("hymba-1.5b", 1, 4096, 3200, 16, False, True),
    ("falcon-mamba-7b", 1, 2048, 8192, 16, False, True),
]
# (label, B, S_q, S_k, H, hd, causal, window, bf16, timed): the attention
# widths of the repo's configs (Hymba-1.5B's KV heads repeated to 25), a
# prime S, bf16, S_q != S_k, a 5-key window (narrower than one 8- or
# 16-key mma tile), hd 32 at a ragged S and the reference's test shapes
ATTN_CASES = [
    ("hymba-1.5b windowed", 1, 4096, 4096, 25, 64, True, 2048, False, True),
    ("hymba-1.5b full causal", 1, 4096, 4096, 25, 64, True, 0, False, True),
    ("llama-3.2-1b", 1, 2048, 2048, 32, 64, True, 0, False, True),
    ("yi-6b", 1, 2048, 2048, 32, 128, True, 0, False, True),
    ("seamless-m4t-medium encoder", 1, 1024, 1024, 16, 64, False, 0, False,
     True),
    ("prime S=1021", 1, 1021, 1021, 4, 64, True, 256, False, False),
    ("bf16 llama-3.2-1b", 1, 2048, 2048, 32, 64, True, 0, True, True),
    ("bf16 hymba windowed", 1, 4096, 4096, 25, 64, True, 2048, True, True),
] + [(f"S_q 64 x S_k 128 hd{hd} c{int(c)}{' bf16' * bf}", 2, 64, 128, 3,
      hd, c, 0, bf, False)
     for hd in (64, 128) for c in (True, False) for bf in (False, True)] + [
    (f"window 5 hd{hd} c{int(c)}{' bf16' * bf}", 1, 300, 300, 2, hd, c, 5,
     bf, False)
    for hd in (32, 64, 128) for c in (True, False) for bf in (False, True)
] + [(f"hd32 ragged S=333{' bf16' * bf}", 2, 333, 333, 3, 32, True, 0, bf,
      False) for bf in (False, True)] + [
    (f"test {B}x{S}x{H}x{hd} c{int(c)} w{w}", B, S, S, H, hd, c, w, False,
     False)
    for B, S, H, hd in ((1, 128, 2, 32), (2, 256, 4, 64), (1, 512, 1, 128))
    for c, w in ((True, 0), (True, 64), (False, 0))]
# phase 7's shapes: Hymba-1.5B's windowed attention and its Mamba width,
# the paper's 10k x 5000 K-Means
TUNE_SHAPES = {
    "flash_attention": {"B": 1, "H": 25, "S_q": 4096, "S_k": 4096, "hd": 64,
                        "causal": 1, "window": 2048},
    "mamba_scan": {"B": 1, "S": 4096, "di": 3200, "st": 16},
    "kmeans": {"n": 10_000, "k": 5_000, "d": 3},
}
# phase 11a: one Mamba layer over two of the reference's scan chunks, then
# Hymba-1.5B cut to 3 layers, forward at 4096 and prefill at 3072 tokens
# (both above its 2048 window and multiples of the 1024 attention chunk)
# and teacher-forced decode after the prompt.  Tolerances: K3's own for
# one layer; through three f32 layers at full width the card and the CPU
# sum in other orders (1e-3); decode against forward is the reference's
# (tests/test_arch_smoke.py)
LAYER_B, LAYER_S = 2, 512
PARITY_S, PARITY_PROMPT, PARITY_DECODE = 4096, 3072, 16
LAYER_TOL, MODEL_TOL, DECODE_TOL = 1e-4, 1e-3, 2e-3
SCAN_TOL = 1e-4       # K3 against the plain scan (phase 5's, the reference's)
# phase 11a, bucketed prompts (tests/test_serving_engine.py's lengths)
PAD_LAYERS, PAD_PROMPTS, PAD_BUCKET, PAD_STEPS = 2, (5, 9, 12), 16, 8
# phase 11b: (arch, prompts, prompt length, greedy tokens), full width and
# depth in the configs' own dtype (bf16)
SERVE_MODELS = (("hymba-1.5b", 2, 4096, 32), ("falcon-mamba-7b", 2, 2048, 16))
PREFILL_REPS = 3       # the first prefill warms up; the median of the rest
SUBLAYER_REPS = 5      # Hymba's sublayers timed alone, after phase 11b
# phase 12: the serving engine at full width and depth in the config's
# dtype (bf16): prompt lengths uniform in ENGINE_PROMPT, token ids uniform
# in the vocabulary, from ENGINE_SEED (which also seeds the weights).
# Buckets of 1024: above 2048 tokens the prefill's attention runs in
# chunks of 1024 and takes only whole chunks (as the reference's does)
ENGINE_ARCH = "hymba-1.5b"
ENGINE_REQUESTS = 8
ENGINE_PROMPT = (512, 4096)
ENGINE_MAX_NEW = 16
ENGINE_BUCKET = 1024
ENGINE_MAX_SEQ = 4608
ENGINE_SLOTS = 4
ENGINE_SEED = 17
# phase 13: K3-bwd (label, B, S, di, st, bf16, timed) at the reference's
# K3 test shapes, Hymba-1.5B's training shape (B 4 = one of two
# microbatches of 8 x 2048), the hybrid pipeline's (2 x 512, phase 13d),
# Falcon-Mamba-7B's width, an odd shape (st 32, S not a multiple of the
# kernel's 16-step chunk) and bf16.  K3 forward is held at each of these
# shapes too (SCAN_TOL, on y and h_last).  f32 at K3's
# tolerance; bf16 outputs are rounded to bf16 (8 mantissa bits) after f32
# sums in another order, so bf16 is held at the reference's bf16
# tolerance (tests/test_kernels.py, K1's bf16 case)
BWD_CASES = [
    ("test 1x32x8x4", 1, 32, 8, 4, False, False),
    ("test 2x64x16x8", 2, 64, 16, 8, False, False),
    ("test 1x128x32x16", 1, 128, 32, 16, False, False),
    ("st=2 3x40x16x2", 3, 40, 16, 2, False, False),
    ("odd 1x37x5x32", 1, 37, 5, 32, False, False),
    ("bf16 2x256x64x16", 2, 256, 64, 16, True, False),
    ("hymba-1.5b train", 4, 2048, 3200, 16, False, True),
    ("hymba-1.5b hybrid", 2, 512, 3200, 16, False, False),
    ("falcon-mamba-7b", 1, 2048, 8192, 16, False, True),
]
BWD_TOL, BWD_BF16_TOL = 1e-4, 2e-2
# phase 13a: the fused backward of the scan and its input tail (label, B,
# S, di, st, timed) at K3-bwd's test shapes (st 2, st 32 and a ragged S
# among them), the training and hybrid shapes at Hymba-1.5B width and
# Falcon-Mamba-7B's width.  ddt, du and dh0 are held like K3-bwd's outputs
# (SSM_TOL); dBc and dC sum over d_inner (3200 or 8192 rows) and dA over
# B x S steps, in another order than the plain loop, so they are held at
# SSM_SUM_TOL x max |want|
SSM_CASES = [
    ("test 1x32x8x4", 1, 32, 8, 4, False),
    ("test 2x64x16x8", 2, 64, 16, 8, False),
    ("test 1x128x32x16", 1, 128, 32, 16, False),
    ("st=2 1x40x8x2", 1, 40, 8, 2, False),
    ("odd 2x37x5x32", 2, 37, 5, 32, False),
    ("hymba-1.5b train", 4, 2048, 3200, 16, True),
    ("hymba-1.5b hybrid", 2, 512, 3200, 16, False),
    ("falcon-mamba-7b", 1, 2048, 8192, 16, True),
]
SSM_TOL, SSM_SUM_TOL = 1e-4, 1e-3
REPLACED_REPS = 5      # the replaced path's backward: ~10 ms a call
# 13b: a full-width f32 Mamba layer's gradients, card vs CPU, per leaf
# max |err| <= GRAD_TOL * max |want| (sums over 512 steps and 3200 rows
# in other orders)
GRAD_TOL = 1e-3
# 13c: Hymba-1.5B at full width and depth, bf16 params, f32 moments,
# remat; global batch 8 x 2048 in 2 microbatches, lr 1e-3, warmup 2 of 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 8, 2048, 2
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 8, 2, 1e-3
# resume exactness at full width cut to 4 layers: 8 steps, a checkpoint
# every 4, the reference's test_checkpoint_restart_resumes_exactly rel
RESUME_LAYERS, RESUME_STEPS, RESUME_BATCH, RESUME_TOL = 4, 8, 2, 1e-3
# 13d: the hybrid pipeline at Hymba-1.5B full width
HYBRID_BATCH, HYBRID_SEQ, HYBRID_ROUNDS, HYBRID_STEPS = 2, 512, 3, 2
# 14a: the plain step's first steps against 13c's plan path
PLAIN_STEPS, PLAN_TOL = 4, 1e-4
# 14b: one Qwen2-MoE-A2.7B MoE layer, 1 x 2048 tokens in bf16
EP_ARCH, EP_TOKENS, EP_TOL, EP_REPS = "qwen2-moe-a2.7b", 2048, 2e-2, 5
# 15a: FlopCounterMode's count against the analytic one (the reference's
# 0.7-1.4 of its XLA cross-check)
FLOP_RATIO = (0.7, 1.4)
# 15b: train steps of the Session stage that carries a StageCost
STAGE_STEPS = 3
# 15c and 16b: dry-run cells (arch, shapes) on the single-pod (16, 16)
# mesh, traced in one subprocess: train_4k reaches the shape rules of K3
# and of the fused backward; decode_32k runs the sharded decode step on
# the weight-stationary serving plan
DRYRUN_CELL = ("hymba-1.5b", ("train_4k", "decode_32k"))
DRYRUN_TIMEOUT = 600
# 16a: the sharded serving steps against 11b's plain run, where they are
# not bit for bit
SHARDED_TOL = 1e-4
# 15d: 13c's plan path with the save_tp_out remat policy
SAVE_TP_STEPS, SAVE_TP_TOL = 2, 1e-4
# phase 8's DCN costs per byte (benchmarks/bench_session_placement.py)
SESSION_DCN_COSTS = (0.0, 1e-9, 1e-7, 1e-5, 1e-3, 1.0)
SESSION_SEED = 80      # simulate's seed is this plus the scenario's index
RAPTOR_SHARDS = 16     # phase 9: row shards of the 1M x 50 points
RAPTOR_SLOTS = 4       # lease slots of phase 9's pilot (2 overlay workers)
MICRO_TASKS = 10_000   # no-op micro-tasks timed (and a tenth of them)
# no-op CUs timed: the per-CU path scans its queue each round, so its
# cost per task grows with the backlog; two sizes show the growth
CU_TASKS = (1_000, 2_000)
# phase 17: the quickstart's subprocess, then the Fig-6 K-Means CUs under
# elastic multi-tenant scheduling at the paper's 100k x 500 scenario
QUICKSTART_TIMEOUT = 300
ELASTIC_SCENARIO = "100k_points_500_clusters"
ELASTIC_TENANTS = (("t0", 1.0), ("t1", 1.0), ("t2", 2.0))   # DRF weights
ELASTIC_CUS = 4        # CUs a tenant submits, CU j on draw j
ELASTIC_CAP = 2        # each tenant queue's max_chips
ELASTIC_SLOTS = 4      # lease slots of the K-Means pilot
ELASTIC_RESERVE = 2    # ...and of the pilot the shrink hands chips to
ELASTIC_SHRINK = 2     # slots the ControlPlane drains, then grants back
ELASTIC_SEED = 170
ELASTIC_TIMEOUT = 300.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def ptxas_instances(log: str) -> list:
    """(kernel, registers, bytes of spill stores) for each instance in
    nvcc's ``-Xptxas -v`` report."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split()[-1])
        elif "registers" in line and name:
            out.append((name, int(line.split("Used ")[1].split()[0]), spill))
            name = None
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = TIMED_LAUNCHES) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events, after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def assign_bound(n: int, k: int, d: int) -> dict:
    """Least time for one assignment on the card: each input read once
    and each output written once, or k*(d+1) FMAs (2 FLOPs each) per
    point at the FP32 peak — whichever is larger."""
    nbytes = 4 * (n * d + k * d) + 8 * n
    flops = 2 * n * k * (d + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "flops": flops, "t_bytes": t_bytes,
            "t_ops": t_ops}


def bound_of(nbytes: float, flops: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> dict:
    """The least time on the card: bytes over the memory rate or the
    operations over the peak of the units that run them (FP32 unless
    given), whichever is larger."""
    return bound_from(nbytes / HBM_BYTES_PER_S, flops / flop_per_s,
                      bytes=nbytes, flops=flops)


def bound_from(t_bytes: float, t_ops: float, **counts) -> dict:
    return {**counts, "t_bytes": t_bytes, "t_ops": t_ops,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def scan_bound(B: int, S: int, di: int, st: int, es: int) -> dict:
    """a, b, C, h0 read once (es bytes each), y and h_last written once
    (f32); one FMA for the recurrence and one for the readout per
    element of a."""
    nbytes = es * (2 * B * S * di * st + B * S * st + B * di * st) \
        + 4 * (B * S * di + B * di * st)
    return bound_of(nbytes, 4 * B * S * di * st)


def live_pairs(S_q: int, S_k: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave live: what this run's data
    needs, with positions from 0 on both sides."""
    import numpy as np
    r = np.arange(S_q)
    hi = np.minimum(r + 1, S_k) if causal else np.full(S_q, S_k)
    lo = np.maximum(r - window + 1, 0) if window else np.zeros(S_q, int)
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound(B, S_q, S_k, H, hd, causal, window, es) -> dict:
    """q, k, v read once and o written once; QK^T and PV cost 2 FMAs a
    head dim for every live pair, at the peak of the tensor cores' path
    the kernel takes: 3xTF32 for f32, bf16 for bf16.  ``simt_bound_ms``
    is the same work at the FP32 (non-tensor) peak, the bound of the
    earlier one-thread-per-row kernel."""
    nbytes = es * B * H * hd * (2 * S_q + 2 * S_k)
    flops = 4 * hd * B * H * live_pairs(S_q, S_k, causal, window)
    peak = TF32X3_FLOP_PER_S if es == 4 else BF16_TC_FLOP_PER_S
    return bound_of(nbytes, flops, peak) | {
        "simt_bound_ms": bound_of(nbytes, flops)["bound_ms"]}


def held(torch, got, want, tol: float, label: str) -> float:
    """|got - want| <= tol + tol * |want| everywhere (the reference's
    allclose); returns the max |error|."""
    err = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got.float()).all()), f"{label}: non-finite")
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"{label}: max |err| {err.max().item():.3e} over rtol/atol {tol}")
    return err.max().item()


def sdpa_call(torch, q, k, v, causal: bool, window: int):
    """The library yardstick: one scaled_dot_product_attention call on
    the same inputs and mask, with the mask and the (B, H, S, hd) views
    made beforehand (timed here only; the port never calls it)."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not window:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
    S_q, S_k = q.shape[1], k.shape[1]
    qp = torch.arange(S_q, device=q.device)[:, None]
    kp = torch.arange(S_k, device=q.device)[None, :]
    mask = (qp - kp) < window
    if causal:
        mask &= qp >= kp
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def compare_assign(torch, ops, ref, p, c, label: str) -> float:
    """Kernel vs plain version on the same inputs; returns max |err|."""
    ik, dk = ops.assign(p, c)
    ir, dr = ref.assign(p, c)
    torch.cuda.synchronize()
    same = (ik == ir).float().mean().item()
    err = (dk - dr).abs()
    tol = 1e-3 + 1e-4 * dr.abs()
    check(bool(torch.isfinite(dk).all()), f"{label}: non-finite distances")
    check(same >= 0.999, f"{label}: index agreement {same:.5f} < 0.999")
    check(bool((err <= tol).all()),
          f"{label}: distance error {err.max().item():.3e} over "
          "rtol 1e-4 / atol 1e-3")
    print(f"  {label}: n={p.shape[0]} k={c.shape[0]} d={p.shape[1]} "
          f"{p.dtype}: index agreement {same:.6f}, max |err| "
          f"{err.max().item():.3e}")
    return err.max().item()


def bare_launcher(torch, km_kernel, p, c, bn: int, bk: int, splits: int):
    """K1 through its launcher, without the wrapper's checks, allocations
    or launch counts: the scan, and the merge when k is split.  Returns a
    callable that launches and gives (idx, distance); its ``partials``
    are the scan's (splits, n) indices and minima when k is split."""
    n = p.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    part = km_kernel.partials(splits, n, p.device)

    def run():
        km_kernel.assign_cuda(p, c, idx, dist, bn=bn, bk=bk, part=part)
        return idx, dist
    run.partials = () if part is None else (part[0],
                                            part[1].view(torch.float32))
    return run


def chosen_splits(ops, km_kernel, n: int, k: int, d: int, blocks: dict,
                  sms: int) -> int:
    return ops.split_count(n, k, blocks["bn"], blocks["bk"],
                           km_kernel.rows(d), sms)


def graph_ms(torch, fn, reps: int = TIMED_LAUNCHES, rounds: int = 5
             ) -> float:
    """Device time per call of `fn` without the host's cost: `reps` calls
    captured in one CUDA graph, its replay timed with CUDA events (best
    of `rounds`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(rounds):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def host_us(torch, fn, reps: int = TIMED_LAUNCHES) -> float:
    """Host time per call of `fn` back to back, without waiting for the
    card: the wrapper's own cost (checks, lookups, allocations, launch)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def first_iteration_flips(torch, km_kernel, ops, ref, pts, centroids,
                          blocks: dict, sms: int) -> int:
    """Points the kernel and the plain version assign differently from
    the same centroids.  Each must be a tie by distance: the two
    choices' float64 squared distances agree within the comparison's
    tolerance (atol 1e-3, rtol 1e-4).  Uses the bare launchers (the
    split count the wrapper would choose), so these comparison launches
    stay out of the wrapper's launch counts."""
    n, d = pts.shape
    splits = chosen_splits(ops, km_kernel, n, centroids.shape[0], d, blocks,
                           sms)
    idx, _ = bare_launcher(torch, km_kernel, pts, centroids, blocks["bn"],
                           blocks["bk"], splits)()
    plain_idx, _ = ref.assign(pts, centroids)
    diff = (idx != plain_idx).nonzero()[:, 0]
    p64 = pts[diff].double()
    d_k = ((p64 - centroids[idx[diff].long()].double()) ** 2).sum(1)
    d_p = ((p64 - centroids[plain_idx[diff].long()].double()) ** 2).sum(1)
    check(bool(((d_k - d_p).abs() <= 1e-3 + 1e-4 * d_p).all()),
          "a first-iteration disagreement is not a tie by distance")
    return int(diff.numel())


def profile_fit(torch, km, eng, name: str, k: int) -> dict:
    """One local kmeans_fit under torch.profiler: wall time, device busy
    time (summed self device time of every kernel; one stream, so they
    do not overlap) and the heaviest operators by device time."""
    from torch.profiler import ProfilerActivity, profile
    km.kmeans_fit(eng, name, k, iters=ITERS, use_kernel=True)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        km.kmeans_fit(eng, name, k, iters=ITERS, use_kernel=True)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    # device-side entries (kernels, copies, memsets) only: an operator's
    # own entry repeats the device time of the kernels it launched
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host_ops = [e for e in events if e.device_type == DeviceType.CPU]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    k1_ms = sum(dev_us(e) for e in kernels if "kmeans_" in e.key) / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "k1_device_ms": k1_ms,
           "top_device_ms": {e.key[:72]: dev_us(e) / 1e3 for e in
                             sorted(kernels, key=dev_us, reverse=True)[:6]},
           "top_cpu_ms": {e.key[:72]: e.self_cpu_time_total / 1e3 for e in
                          sorted(host_ops, key=lambda e: e.self_cpu_time_total,
                                 reverse=True)[:6]}}
    share = (f"{100 * busy_ms / wall_ms:.1f} %" if busy_ms
             else "not measured (no device events)")
    print(f"  {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({share}), K1 (scan + merge) {k1_ms:.4f} ms")
    for key, ms in out["top_device_ms"].items():
        print(f"    device {ms:9.4f} ms  {key}")
    for key, ms in out["top_cpu_ms"].items():
        print(f"    host   {ms:9.4f} ms  {key}")
    return out


def numpy_lloyd(pts, init, iters: int) -> float:
    """Plain numpy K-Means (float64), independent of the port's code."""
    import numpy as np
    c = init.astype(np.float64)
    x = pts.astype(np.float64)
    cost = math.inf
    for _ in range(iters):
        d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        a = d2.argmin(1)
        cost = d2[np.arange(len(x)), a].sum()
        for j in range(len(c)):
            if (a == j).any():
                c[j] = x[a == j].mean(0)
    return float(cost)


def randn(torch, gen, dev, *size, scale=1.0, dtype=None):
    return (scale * torch.randn(*size, generator=gen, device=dev)).to(dtype)


def scan_inputs(torch, gen, dev, B, S, di, st, dtype):
    """Decays in (0.7, 0.999) like exp(dt * A) with A < 0, as the
    reference's tests draw them."""
    a = (0.7 + 0.299 * torch.rand(B, S, di, st, generator=gen, device=dev)
         ).to(dtype)
    return (a, randn(torch, gen, dev, B, S, di, st, scale=0.1, dtype=dtype),
            randn(torch, gen, dev, B, S, st, dtype=dtype),
            randn(torch, gen, dev, B, di, st, scale=0.1, dtype=dtype))


def attn_inputs(torch, gen, dev, B, S_q, H, hd, dtype, S_k=None):
    S_k = S_k or S_q
    return (randn(torch, gen, dev, B, S_q, H, hd, scale=0.3, dtype=dtype),
            randn(torch, gen, dev, B, S_k, H, hd, scale=0.3, dtype=dtype),
            randn(torch, gen, dev, B, S_k, H, hd, dtype=dtype))


def phase_scan(torch, dev):
    """5. K3 against its plain version (rtol/atol 1e-4 on y and h_last,
    the reference's tolerance), timed at the configs' widths."""
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    print("phase 5: mamba_scan against its plain version")
    gen = torch.Generator(device=dev).manual_seed(5)
    max_err, rows = 0.0, []
    for label, B, S, di, st, bf16, timed in SCAN_CASES:
        dtype = torch.bfloat16 if bf16 else torch.float32
        args = scan_inputs(torch, gen, dev, B, S, di, st, dtype)
        y, h = ms_ops.scan(*args)
        yr, hr = ms_ref.scan(*args)
        torch.cuda.synchronize()
        check(y.dtype == h.dtype == torch.float32
              and tuple(y.shape) == (B, S, di)
              and tuple(h.shape) == (B, di, st), f"{label}: bad outputs")
        err = max(held(torch, y, yr, 1e-4, f"{label} y"),
                  held(torch, h, hr, 1e-4, f"{label} h_last"))
        max_err = max(max_err, err)
        line = f"  {label} {dtype}: max |err| {err:.3e}"
        if timed:
            # kernel, plain, kernel: in turns on one card
            t_k = cuda_ms(torch, lambda: ms_ops.scan(*args))
            t_p = cuda_ms(torch, lambda: ms_ref.scan(*args), PLAIN_SCAN_REPS)
            t_k = min(t_k, cuda_ms(torch, lambda: ms_ops.scan(*args)))
            bound = scan_bound(B, S, di, st, args[0].element_size())
            rows.append({"shape": label, "B": B, "S": S, "di": di, "st": st,
                         "dtype": str(dtype), "ms": t_k, "plain_ms": t_p,
                         "library_ms": None, **bound})
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                     f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                     f"{bound['bytes'] / t_k / 1e9:.3f} TB/s")
        print(line)
        del args, y, h, yr, hr
    return max_err, rows


def phase_attention(torch, dev):
    """6. K2 against its plain version (2e-4 for f32, 5e-2 for bf16, the
    reference's tolerances), timed at the configs' widths beside
    scaled_dot_product_attention in the same dtype."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    print("phase 6: flash_attention against its plain version")
    gen = torch.Generator(device=dev).manual_seed(6)
    max_err, rows = {"float32": 0.0, "bfloat16": 0.0}, []
    for label, B, S, S_k, H, hd, causal, window, bf16, timed in ATTN_CASES:
        dtype = torch.bfloat16 if bf16 else torch.float32
        q, k, v = attn_inputs(torch, gen, dev, B, S, H, hd, dtype, S_k)
        mask = {"causal": causal, "window": window}
        o = fa_ops.attention(q, k, v, **mask)
        r = fa_ref.attention(q, k, v, **mask)
        torch.cuda.synchronize()
        check(o.dtype == dtype and o.shape == q.shape, f"{label}: bad output")
        err = held(torch, o, r, 5e-2 if bf16 else 2e-4, label)
        name = str(dtype).removeprefix("torch.")
        max_err[name] = max(max_err[name], err)
        line = f"  {label} {dtype}: max |err| {err:.3e}"
        if timed:
            # kernel, plain, library, kernel, plain: in turns on one card
            t_k = cuda_ms(torch, lambda: fa_ops.attention(q, k, v, **mask))
            t_p = cuda_ms(torch, lambda: fa_ref.attention(q, k, v, **mask))
            library = sdpa_call(torch, q, k, v, **mask)
            t_l = cuda_ms(torch, library)
            t_k = min(t_k, cuda_ms(torch,
                                   lambda: fa_ops.attention(q, k, v, **mask)))
            t_p = min(t_p, cuda_ms(torch,
                                   lambda: fa_ref.attention(q, k, v, **mask)))
            lib_err = (library().transpose(1, 2) - r).abs().max().item()
            bound = attention_bound(B, S, S_k, H, hd, causal, window,
                                    q.element_size())
            rows.append({"shape": label, "B": B, "S": S, "H": H, "hd": hd,
                         **mask, "dtype": str(dtype), "ms": t_k,
                         "plain_ms": t_p, "library_ms": t_l,
                         "library_max_abs_err": lib_err,
                         "share_of_bound": bound["bound_ms"] / t_k, **bound})
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, sdpa "
                     f"{t_l:.4f} ms (|err| {lib_err:.1e}), bound "
                     f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
                     f"{100 * bound['bound_ms'] / t_k:.1f} % of it), FP32 "
                     f"SIMT bound {bound['simt_bound_ms']:.4f} ms, "
                     f"{bound['flops'] / t_k / 1e9:.2f} TFLOP/s")
        print(line)
        del q, k, v, o, r
    f32 = [r for r in rows if r["dtype"] == "torch.float32"]
    print(f"  f32 widths summed: kernel {sum(r['ms'] for r in f32):.4f} ms, "
          f"sdpa {sum(r['library_ms'] for r in f32):.4f} ms, plain "
          f"{sum(r['plain_ms'] for r in f32):.4f} ms, bound "
          f"{sum(r['bound_ms'] for r in f32):.4f} ms")
    return max_err, rows


def phase_autotune(torch, dev, compare_kmeans):
    """7. The autotuner entry point, once per family, with every kernel's
    launch count set to 0 just before and read just after."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.kmeans import ops as km_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    print("phase 7: the autotuner entry point, autotune.main per family")
    counters = {"flash_attention": fa_ops, "mamba_scan": ms_ops,
                "kmeans": km_ops}
    argv = {fam: [fam, "--shapes", json.dumps(shape), "--reps", "5"]
            for fam, shape in TUNE_SHAPES.items()}
    for mod in counters.values():
        mod.LAUNCHES = 0
    recs, walls = {}, {}
    for fam in TUNE_SHAPES:
        t0 = time.perf_counter()
        recs[fam] = autotune.main(argv[fam])[0]
        torch.cuda.synchronize()
        walls[fam] = time.perf_counter() - t0
    launches = {fam: mod.LAUNCHES for fam, mod in counters.items()}
    for fam, rec in recs.items():
        check(launches[fam] > 0 and rec["trials"] > 0 and not rec["cached"],
              f"{fam}: the tuner ran {rec['trials']} trials and "
              f"{launches[fam]} launches")
        check(rec["speedup_vs_default"] >= 1.0 - 1e-9,
              f"{fam}: the winner is slower than the default")
        rec["wall_s"] = walls[fam]
        print(f"  {fam}: {walls[fam]:.3f} s wall, {rec['trials']} trials, "
              f"{launches[fam]} launches; "
              f"tuned {rec['config']}, {rec['speedup_vs_default']:.4f}x vs "
              f"default {rec['default_config']} ({1e3 * rec['best_s']:.4f} "
              f"vs {1e3 * rec['default_s']:.4f} ms)")
    for fam in TUNE_SHAPES:                # 2. a cache hit, 0 trials
        again = autotune.main(argv[fam])[0]
        check(again["cached"] and again["trials"] == 0
              and again["config"] == recs[fam]["config"],
              f"{fam}: the second call was not a cache hit")
    check({fam: mod.LAUNCHES for fam, mod in counters.items()} == launches,
          "a cache hit launched a kernel")
    f32 = torch.float32
    fs, ms, ks = (TUNE_SHAPES[f] for f in ("flash_attention", "mamba_scan",
                                           "kmeans"))
    resolved = {                           # 3. the wrappers find the entry
        "flash_attention": fa_ops.resolve_blocks(
            fs["S_q"], fs["S_k"], fs["hd"], f32, dev, None, None),
        "mamba_scan": ms_ops.resolve_blocks(ms["S"], ms["di"], ms["st"], f32,
                                            dev, None, None),
        "kmeans": km_ops.resolve_blocks(ks["n"], ks["k"], ks["d"], f32, dev,
                                        None, None)}
    for fam, got in resolved.items():
        check(got == tuple(recs[fam]["config"].values()),
              f"{fam}: the wrapper resolves {got}, the tuner chose "
              f"{recs[fam]['config']}")
    print(f"  a second call per family: cache hit, 0 trials; the wrappers "
          f"resolve {resolved}")
    # 4. one call at the tuned blocks still matches the plain version
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = attn_inputs(torch, gen, dev, fs["B"], fs["S_q"], fs["H"],
                          fs["hd"], f32)
    mask = {"causal": bool(fs["causal"]), "window": fs["window"]}
    err = held(torch, fa_ops.attention(q, k, v, **mask),
               fa_ref.attention(q, k, v, **mask), 2e-4, "tuned attention")
    args = scan_inputs(torch, gen, dev, ms["B"], ms["S"], ms["di"], ms["st"],
                       f32)
    (y, h), (yr, hr) = ms_ops.scan(*args), ms_ref.scan(*args)
    err_s = max(held(torch, y, yr, 1e-4, "tuned scan y"),
                held(torch, h, hr, 1e-4, "tuned scan h_last"))
    p = torch.randn(ks["n"], ks["d"], generator=gen, device=dev)
    c = torch.randn(ks["k"], ks["d"], generator=gen, device=dev)
    err_k = compare_kmeans(p, c, "tuned kmeans")
    print(f"  at the tuned blocks: attention |err| {err:.3e}, scan |err| "
          f"{err_s:.3e}, kmeans |err| {err_k:.3e}")
    # 5. K1 gives bitwise the same result at every candidate block size
    base = km_ops.assign(p, c, **autotune.DEFAULTS["kmeans"])
    cands = autotune.candidates_kmeans(ks["n"], ks["k"], ks["d"])
    for cfg in cands:
        got = km_ops.assign(p, c, **cfg)
        check(torch.equal(got[0], base[0]) and torch.equal(got[1], base[1]),
              f"kmeans at {cfg}: not bitwise equal to the default blocks")
    print(f"  kmeans: idx and minimum bitwise equal across all {len(cands)} "
          "candidate block sizes")
    return launches, recs


def model_scan_inputs(torch, cfg, p, x):
    """K3's inputs as a Mamba layer's prefill builds them from its input
    `x` (``mamba_forward`` up to the scan): the post-conv x1, and a, b
    (f32, from the model's own ``_ssm_inputs``), C in f32 and a zero h0."""
    from repro_torch.models.layers import mamba
    x1 = torch.nn.functional.silu(mamba._causal_conv(
        p, (x @ p["in_proj"])[..., :cfg.ssm_d_inner]).float()).to(x.dtype)
    a, b, Cc = mamba._ssm_inputs(cfg, p, x1)
    h0 = torch.zeros(x.shape[0], cfg.ssm_d_inner, cfg.ssm_d_state,
                     device=x.device)
    return x1, (a, b, Cc.float().contiguous(), h0)


def _serving_scan_parity(torch, dev, gen, arch: str, B: int, S: int
                         ) -> float:
    """K3 at the shape phase 11b's prefill gives it, on the inputs a
    Mamba layer of `arch` (full width, its own dtype) builds from a B x S
    input, against the plain scan on the same inputs at SCAN_TOL."""
    from repro_torch import configs
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    from repro_torch.models.layers import mamba
    cfg = configs.get(arch)
    di, st = cfg.ssm_d_inner, cfg.ssm_d_state
    p = mamba.init_mamba(cfg, gen)
    x = randn(torch, gen, dev, B, S, cfg.d_model, dtype=cfg.param_dtype)
    with torch.inference_mode():
        _, args = model_scan_inputs(torch, cfg, p, x)
        del x
        check(all(t.dtype == torch.float32 for t in args)
              and tuple(args[0].shape) == (B, S, di, st),
              f"{arch} scan inputs: {[(t.dtype, tuple(t.shape)) for t in args]}")
        y, h = ms_ops.scan(*args)
        yr, hr = ms_ref.scan(*args)
        torch.cuda.synchronize()
    check(tuple(y.shape) == (B, S, di) and tuple(h.shape) == (B, di, st),
          f"{arch} scan at the serving shape: bad outputs")
    err = max(held(torch, y, yr, SCAN_TOL, f"{arch} serving scan y"),
              held(torch, h, hr, SCAN_TOL, f"{arch} serving scan h_last"))
    print(f"  {arch} K3 at the serving shape (B {B}, S {S}, d_inner {di}, "
          f"d_state {st}; a, b, C from the layer's own _ssm_inputs, "
          f"{cfg.dtype} weights): vs plain scan max |err| {err:.3e} "
          f"(tol {SCAN_TOL})")
    return err


def _mamba_layer_parity(torch, dev, gen, arch: str) -> float:
    """One Mamba layer of `arch` at full width in f32: on the card (one
    K3 launch) against the same layer and weights on the CPU (the plain
    scan), out, h_last and the conv cache at LAYER_TOL."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models.layers import mamba
    from repro_torch.util import tree_map
    cfg = dataclasses.replace(configs.get(arch), dtype="float32")
    p = mamba.init_mamba(cfg, gen)
    x = randn(torch, gen, dev, LAYER_B, LAYER_S, cfg.d_model)
    before = ms_ops.LAUNCHES
    with torch.inference_mode():
        out, cache = mamba.mamba_forward(cfg, p, x)
        torch.cuda.synchronize()
        check(ms_ops.LAUNCHES - before == 1,
              f"{arch} layer: {ms_ops.LAUNCHES - before} K3 launches, want 1")
        out_c, cache_c = mamba.mamba_forward(
            cfg, tree_map(lambda t: t.cpu(), p), x.cpu())
    err = max(held(torch, out.cpu(), out_c, LAYER_TOL, f"{arch} layer out"),
              *(held(torch, cache[k].cpu(), cache_c[k], LAYER_TOL,
                     f"{arch} layer {k}") for k in ("h", "conv")))
    print(f"  {arch} Mamba layer (B {LAYER_B}, S {LAYER_S}, d_inner "
          f"{cfg.ssm_d_inner}, d_state {cfg.ssm_d_state}, f32): card (K3) "
          f"vs CPU (plain scan) max |err| {err:.3e} (tol {LAYER_TOL})")
    return err


def _padded_vs_unpadded(torch, dev) -> float:
    """Llama-3.2-1B at full width cut to PAD_LAYERS layers, f32: each
    prompt of PAD_PROMPTS left-padded to PAD_BUCKET (pad mask,
    pad-relative positions, ``start``) gives the unpadded run's greedy
    tokens through PAD_STEPS decode steps.  Returns the largest logit
    difference (0 when bit for bit, as on the CPU)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serve import make_decode_step, make_prefill_step
    cfg = dataclasses.replace(configs.get("llama3.2-1b"), n_layers=PAD_LAYERS,
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(13)
    params = tf.init_params(cfg, gen, device=dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg,
                                                                sample=True)

    def serve(prompt, bucket):
        pad = bucket - prompt.shape[0]
        toks = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
        toks[0, pad:] = prompt
        slots = torch.arange(bucket, device=dev)
        caches, logits = prefill(params, {"tokens": toks,
                                          "positions": slots - pad,
                                          "pad_mask": slots >= pad})
        caches = tf.grow_caches(caches, tf.init_caches(
            cfg, 1, bucket + PAD_STEPS, device=dev))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        outs, toks_out = [logits], [tok]
        for t in range(PAD_STEPS):
            caches, logits, tok = decode(
                params, caches, tok,
                torch.tensor([bucket + t], device=dev),
                torch.tensor([pad], device=dev))
            outs.append(logits)
            toks_out.append(tok)
        return outs, torch.cat(toks_out, 1)

    worst, bitwise = 0.0, True
    for n in PAD_PROMPTS:
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                               device=dev, dtype=torch.int32)
        (lp, tp), (lu, tu) = serve(prompt, PAD_BUCKET), serve(prompt, n)
        check(torch.equal(tp, tu), f"padded prompt of {n}: greedy tokens "
              f"{tp.tolist()} vs unpadded {tu.tolist()}")
        for a, b in zip(lp, lu):
            bitwise &= torch.equal(a, b)
            worst = max(worst, (a - b).abs().max().item())
    print(f"  Llama-3.2-1B width, {PAD_LAYERS} layers, f32: prompts "
          f"{PAD_PROMPTS} left-padded to {PAD_BUCKET} give the unpadded "
          f"greedy tokens over {PAD_STEPS} steps; logits "
          f"{'bit for bit equal' if bitwise else 'not bitwise equal'}, max "
          f"|diff| {worst:.3e}")
    return worst


def phase_model_parity(torch, dev) -> dict:
    """11a. Layer and model parity at full width, f32: a Hymba-1.5B and a
    Falcon-Mamba-7B Mamba layer, K3 at each shape phase 11b's prefill
    gives it (B = 2 included), then Hymba-1.5B cut to 3 layers (full,
    windowed, full attention): forward at PARITY_S and prefill at
    PARITY_PROMPT on the card against the CPU, then a teacher-forced
    decode on the card against the card's forward."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import transformer as tf
    from repro_torch.util import tree_map
    print("phase 11a: model layers and a 3-layer Hymba-1.5B at full width, "
          "card against CPU (f32)")
    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {f"{arch} mamba layer": _mamba_layer_parity(torch, dev, gen, arch)
            for arch in ("hymba-1.5b", "falcon-mamba-7b")}
    for arch, B, S, _ in SERVE_MODELS:
        errs[f"{arch} K3 at serving shape"] = _serving_scan_parity(
            torch, dev, gen, arch, B, S)
        torch.cuda.empty_cache()

    cfg = dataclasses.replace(configs.get("hymba-1.5b"), n_layers=3,
                              full_attn_layers=(0, 2), dtype="float32")
    windows = [seg.window for seg in tf.build_segments(cfg)]
    check(windows == [0, cfg.sliding_window, 0], f"segments {windows}")
    params = tf.init_params(cfg, gen, device=dev)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    tokens = torch.randint(0, cfg.vocab_size, (1, PARITY_S), generator=gen,
                           device=dev, dtype=torch.int32)
    prompt = tokens[:, :PARITY_PROMPT]
    with torch.inference_mode():
        before = ms_ops.LAUNCHES
        logits, _ = tf.forward(cfg, params, {"tokens": tokens})
        caches, last = tf.prefill(cfg, params, {"tokens": prompt})
        torch.cuda.synchronize()
        check(ms_ops.LAUNCHES - before == 2 * cfg.n_layers,
              f"3-layer forward + prefill: {ms_ops.LAUNCHES - before} K3 "
              f"launches, want {2 * cfg.n_layers}")
        logits_c, _ = tf.forward(cfg, cpu_params, {"tokens": tokens.cpu()})
        caches_c, last_c = tf.prefill(cfg, cpu_params,
                                      {"tokens": prompt.cpu()})
        errs["forward logits"] = held(torch, logits.cpu(), logits_c,
                                      MODEL_TOL, "3-layer forward logits")
        errs["prefill logits"] = held(torch, last.cpu(), last_c, MODEL_TOL,
                                      "3-layer prefill logits")
        errs["prefill caches"] = max(
            held(torch, c[k].cpu(), cc[k], MODEL_TOL, f"prefill cache {k}")
            for c, cc in zip(caches, caches_c) for k in c)
        check(caches[1]["k"].shape[2] == cfg.sliding_window,
              "the windowed layer's prefill cache is not one window long")
        del logits_c, caches_c, cpu_params
        dec = tf.grow_caches(caches, tf.init_caches(cfg, 1, PARITY_S,
                                                    device=dev))
        worst = 0.0
        for t in range(PARITY_PROMPT, PARITY_PROMPT + PARITY_DECODE):
            dec, lg = tf.decode_step(
                cfg, params, dec, tokens[:, t:t + 1],
                torch.full((1,), t, dtype=torch.int32, device=dev))
            worst = max(worst, held(torch, lg[:, 0], logits[:, t],
                                    DECODE_TOL, f"decode step {t}"))
        errs["decode vs forward"] = worst
    print(f"  3-layer Hymba-1.5B (windows {windows}): forward S {PARITY_S}, "
          f"prefill S {PARITY_PROMPT} (ring-buffer roll, chunked attention), "
          f"card vs CPU max |err| logits {errs['forward logits']:.3e} / "
          f"{errs['prefill logits']:.3e}, caches "
          f"{errs['prefill caches']:.3e} (tol {MODEL_TOL}); "
          f"{PARITY_DECODE} teacher-forced decode steps vs forward "
          f"{worst:.3e} (tol {DECODE_TOL})")
    errs["padded vs unpadded logits"] = _padded_vs_unpadded(torch, dev)
    return errs


def _device_profile(torch, fn) -> dict:
    """`fn` once under torch.profiler: device busy time (self device time
    of every kernel; one stream, so they do not overlap), K3's part,
    K3-bwd's (its two kernels) and the fused backward's (its two)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    k3 = sum(dev_us(e) for e in kernels if "mamba_scan_kernel" in e.key) / 1e3
    k3_bwd = sum(dev_us(e) for e in kernels if "mamba_scan_bwd_kernel"
                 in e.key or "mamba_scan_dc_kernel" in e.key) / 1e3
    ssm_bwd = sum(dev_us(e) for e in kernels if "mamba_ssm_bwd" in e.key) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "k3_device_ms": k3,
            "k3_share": k3 / busy if busy else None,
            "k3_bwd_device_ms": k3_bwd,
            "k3_bwd_share": k3_bwd / busy if busy else None,
            "ssm_bwd_device_ms": ssm_bwd,
            "ssm_bwd_share": ssm_bwd / busy if busy else None,
            "busy_share": busy / wall if busy else None,
            "kernels": len(kernels),
            "kernel_launches": sum(e.count for e in kernels),
            "top_device_ms": [[e.key[:96], dev_us(e) / 1e3] for e in
                              sorted(kernels, key=dev_us, reverse=True)[:8]]}


def _share(x) -> str:
    return f"{100 * x:.1f} %" if x is not None else "not measured"


def serve_model(torch, dev, arch: str, B: int, S: int, new: int,
                keep: bool = False) -> dict:
    """Serve `arch` at full width and depth in its own dtype through the
    serving steps: PREFILL_REPS prefills of B prompts of S tokens (the
    first one warms up), one more under the profiler, then the caches
    grown and `new` greedy decode steps.  K3 rises by the SSM layer count
    per prefill and by 0 per decode step.  With `keep` the record holds
    the outputs on the host under ``"_outputs"`` (the last timed
    prefill's logits and caches, each step's logits, the tokens), for
    phase 16a; the caller takes them out before the record is printed."""
    from repro_torch import configs
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.util import tree_map
    cfg = configs.get(arch)
    n_ssm = sum(s.n_layers for s in tf.build_segments(cfg) if s.ssm)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    params = tf.init_params(cfg, gen, device=dev)
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg, sample=True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device=dev, dtype=torch.int32)}
    V = cfg.vocab_size

    def counted(fn, want: int, label: str):
        before = ms_ops.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check(ms_ops.LAUNCHES - before == want,
              f"{arch} {label}: {ms_ops.LAUNCHES - before} K3 launches, "
              f"want {want}")
        return out, ms

    prefill_ms = []
    for _ in range(PREFILL_REPS):
        (caches, logits), ms = counted(lambda: prefill(params, batch), n_ssm,
                                       "prefill")
        prefill_ms.append(ms)
        check(tuple(logits.shape) == (B, 1, cfg.vocab_padded)
              and bool(torch.isfinite(logits[..., :V]).all()),
              f"{arch} prefill: bad logits")
    kept = {"prefill_logits": logits.cpu(),
            "prefill_caches": tree_map(lambda t: t.cpu(), caches),
            "logits": []} if keep else None
    before = ms_ops.LAUNCHES
    prof = _device_profile(torch, lambda: prefill(params, batch))
    check(ms_ops.LAUNCHES - before == n_ssm, f"{arch} profiled prefill: "
          f"{ms_ops.LAUNCHES - before} K3 launches, want {n_ssm}")
    # one slot more than the timed steps: the last step runs profiled
    dec = tf.grow_caches(caches, tf.init_caches(cfg, B, S + new + 1,
                                                device=dev))
    tok = logits[:, -1, :V].argmax(-1).to(torch.int32)[:, None]
    out, step_ms = [tok], []
    for t in range(new + 1):
        pos = torch.full((B,), S + t, dtype=torch.int32, device=dev)
        if t == new:
            res = {}
            before = ms_ops.LAUNCHES
            dprof = _device_profile(torch, lambda: res.update(
                out=decode(params, dec, tok, pos)))
            check(ms_ops.LAUNCHES == before, f"{arch} profiled decode "
                  "step launched K3")
            dec, lg, tok = res["out"]
        else:
            (dec, lg, tok), ms = counted(
                lambda: decode(params, dec, tok, pos), 0, f"decode step {t}")
            step_ms.append(ms)
        check(bool(torch.isfinite(lg[..., :V]).all()),
              f"{arch} decode step {t}: non-finite logits")
        if keep:
            kept["logits"].append(lg.cpu())
        out.append(tok)
    gen_toks = torch.cat(out, dim=1)
    check(bool(((gen_toks >= 0) & (gen_toks < V)).all()),
          f"{arch}: a sampled token outside the vocabulary")
    timed = prefill_ms[1:]
    rec = {"arch": arch, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "ssm_layers": n_ssm, "params": sum(sizes), "B": B, "S": S,
           "new_tokens": new, "prefill_ms": statistics.median(timed),
           "prefill_ms_all": prefill_ms,
           "prefill_tokens_per_s": B * S / (statistics.median(timed) / 1e3),
           "decode_ms_per_token": statistics.median(step_ms),
           "decode_ms_all": step_ms,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "k3_launches_per_prefill": n_ssm, "prefill_profile": prof,
           "decode_profile": dprof}
    print(f"  {arch} ({cfg.n_layers} layers, {n_ssm} SSM, {sum(sizes)} "
          f"params, {cfg.dtype}, B {B}, S {S}): prefill "
          f"{rec['prefill_ms']:.3f} ms (median of {len(timed)}; first "
          f"{prefill_ms[0]:.3f}), {rec['prefill_tokens_per_s']:.0f} tokens/s; "
          f"decode {rec['decode_ms_per_token']:.3f} ms a step of {B} tokens "
          f"(median of {new}); K3 {n_ssm} launches a prefill, 0 a decode "
          f"step; peak {rec['peak_memory_gb']:.2f} GB")
    for label, pr in (("prefill", prof), ("decode step", dprof)):
        print(f"    profiled {label}: wall {pr['wall_ms']:.3f} ms, device "
              f"busy {pr['device_busy_ms']:.3f} ms ({_share(pr['busy_share'])}"
              f"), {pr['kernel_launches']} device kernels of "
              f"{pr['kernels']} names; K3 {pr['k3_device_ms']:.3f} "
              f"ms ({_share(pr['k3_share'])} of device time)")
        for key, ms in pr["top_device_ms"]:
            print(f"      device {ms:9.4f} ms  {key}")
    print(f"    greedy tokens, row 0: {gen_toks[0, :12].tolist()} ...")
    if keep:
        rec["_outputs"] = kept | {"tokens": gen_toks.cpu()}
    return rec


def hymba_sublayers(torch, dev, B: int, S: int) -> dict:
    """Where a Hymba-1.5B prefill layer spends its device time: each
    sublayer of one full-attention and one windowed layer (bf16, full
    width, B x S) timed alone with CUDA events, K3 and the f32 scan
    inputs it reads (``_ssm_inputs``) among them."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import attention, common, mamba
    cfg = dataclasses.replace(configs.get("hymba-1.5b"), n_layers=2,
                              full_attn_layers=(0,))
    gen = torch.Generator(device=dev).manual_seed(14)
    params = tf.init_params(cfg, gen, device=dev)
    full, windowed = (tf._layer(sp, 0) for sp in params["segments"])
    x = randn(torch, gen, dev, B, S, cfg.d_model, dtype=cfg.param_dtype)
    pos = torch.arange(S, device=dev)
    out = {}
    with torch.inference_mode():
        h = common.rmsnorm(full["ln1"], x, cfg.norm_eps)
        x1, scan_args = model_scan_inputs(torch, cfg, full["ssm"], h)
        out["attention, full"] = cuda_ms(torch, lambda: attention.gqa_forward(
            cfg, full["attn"], h, pos), SUBLAYER_REPS)
        out[f"attention, window {cfg.sliding_window}"] = cuda_ms(
            torch, lambda: attention.gqa_forward(
                cfg, windowed["attn"], h, pos, window=cfg.sliding_window),
            SUBLAYER_REPS)
        out["mamba (all)"] = cuda_ms(torch, lambda: mamba.mamba_forward(
            cfg, full["ssm"], h), SUBLAYER_REPS)
        out["mamba: _ssm_inputs (a, b f32)"] = cuda_ms(
            torch, lambda: mamba._ssm_inputs(cfg, full["ssm"], x1),
            SUBLAYER_REPS)
        out["mamba: K3 scan"] = cuda_ms(
            torch, lambda: ms_ops.scan(*scan_args), SUBLAYER_REPS)
        out["mlp"] = cuda_ms(torch, lambda: common.mlp(full["mlp"], h),
                             SUBLAYER_REPS)
        out["rmsnorm"] = cuda_ms(torch, lambda: common.rmsnorm(
            full["ln1"], x, cfg.norm_eps), SUBLAYER_REPS)
    print(f"  Hymba-1.5B layer breakdown (bf16, B {B}, S {S}; CUDA events, "
          f"mean of {SUBLAYER_REPS}): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in out.items()))
    return out


def phase_serving(torch, dev) -> dict:
    """11b. Serving at full width and full depth through the serving
    steps: Hymba-1.5B (32 layers, bf16), then Falcon-Mamba-7B (64 layers,
    bf16).  Returns the per-model records."""
    print("phase 11b: serving at full width and depth (make_prefill_step, "
          "make_decode_step(sample=True))")
    recs = {}
    for arch, B, S, new in SERVE_MODELS:
        # phase 16a holds the sharded steps against the first model's
        recs[arch] = serve_model(torch, dev, arch, B, S, new,
                                 keep=arch == SERVE_MODELS[0][0])
        torch.cuda.empty_cache()
    return recs


def engine_prompts(vocab: int) -> list:
    """Phase 12's traffic: ENGINE_REQUESTS prompts of uniform length in
    ENGINE_PROMPT and uniform token ids, from a fixed seed."""
    import numpy as np
    rng = np.random.default_rng(ENGINE_SEED)
    lens = rng.integers(ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1,
                        ENGINE_REQUESTS)
    return [rng.integers(0, vocab, (int(n),), dtype=np.int32) for n in lens]


def counted_backend(backend, calls: list, n_ssm: int | None = None):
    """`backend` with its prefill calls appended to `calls`.  With
    `n_ssm` (one thread only) each prefill must launch K3 exactly n_ssm
    times and each decode step none, counted around the call."""
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    prefill, step = backend.prefill, backend.step

    def launches(fn, *args):
        before = ms_ops.LAUNCHES
        return fn(*args), ms_ops.LAUNCHES - before

    def counted_prefill(tokens, bucket):
        calls.append(len(tokens))
        out, n = launches(prefill, tokens, bucket)
        check(n_ssm is None or n == n_ssm,
              f"prefill: {n} K3 launches, want {n_ssm}")
        return out

    def counted_step(*args):
        out, n = launches(step, *args)
        check(n == 0, f"decode step: {n} K3 launches, want 0")
        return out

    backend.prefill = counted_prefill
    if n_ssm is not None:
        backend.step = counted_step
    return backend


def token_mismatches(reqs, want, label: str) -> list:
    """Every request finished with max_new tokens and no error (checked
    here); returns a line for each request whose tokens are not the
    ones it got alone (12a), naming the first step that differs."""
    out = []
    for r, w in zip(reqs, want):
        err = getattr(r, "error", None)
        check(r.done and err is None, f"{label}: request {r.uid} ended with "
              f"{err!r}")
        check(r.output is not None and len(r.output) == r.max_new,
              f"{label}: request {r.uid} output {r.output!r}")
        diff = [i for i, (a, b) in enumerate(zip(r.output, w)) if a != b]
        if diff:
            out.append(f"{label}: request {r.uid} (prompt {len(r.tokens)}) "
                       f"differs from its solo tokens from step {diff[0]}: "
                       f"{r.output.tolist()} vs {list(w)}")
    return out


def serve_latency(reqs, wall_s: float) -> dict:
    """Wall, req/s, time to first token (t_first_token - t_submit) p50
    and p99, time per output token (t_done - t_first_token over the
    tokens after the first) p50."""
    import numpy as np
    ttft = np.array([r.t_first_token - r.t_submit for r in reqs])
    tpot = np.array([(r.t_done - r.t_first_token) / (len(r.output) - 1)
                     for r in reqs])
    return {"wall_s": wall_s, "req_per_s": len(reqs) / wall_s,
            "ttft_ms_p50": 1e3 * float(np.percentile(ttft, 50)),
            "ttft_ms_p99": 1e3 * float(np.percentile(ttft, 99)),
            "tpot_ms_p50": 1e3 * float(np.percentile(tpot, 50))}


def _latency_line(rec: dict) -> str:
    return (f"wall {rec['wall_s']:.3f} s, {rec['req_per_s']:.3f} req/s, "
            f"TTFT p50 {rec['ttft_ms_p50']:.3f} ms p99 "
            f"{rec['ttft_ms_p99']:.3f} ms, TPOT p50 {rec['tpot_ms_p50']:.3f} "
            f"ms, {rec['decode_steps']} decode steps, K3 "
            f"{rec['k3_launches']} launches ({rec['prefills']} prefills)")


def engine_run(torch, dev, cfg, params, prompts, n_ssm: int, *,
               solo: bool, slots: int = ENGINE_SLOTS) -> tuple:
    """The prompts through one engine of `slots` slots, each alone
    (submitted after the previous one drained) or all at once.  Returns
    (requests, record, engine)."""
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.serve import ModelBackend, Request, ServeEngine
    calls = []
    engine = ServeEngine(cfg, backend=counted_backend(
        ModelBackend(cfg, params, device=dev), calls, n_ssm),
        slots=slots, max_seq=ENGINE_MAX_SEQ, prompt_bucket=ENGINE_BUCKET)
    reqs = [Request(uid=i, tokens=p, max_new=ENGINE_MAX_NEW)
            for i, p in enumerate(prompts)]
    before = ms_ops.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
        if solo:
            engine.run_until_drained(timeout_s=600)
    engine.run_until_drained(timeout_s=600)
    torch.cuda.synchronize()
    rec = serve_latency(reqs, time.perf_counter() - t0) | {
        "decode_steps": engine.steps, "prefills": len(calls),
        "k3_launches": ms_ops.LAUNCHES - before}
    check(rec["k3_launches"] == n_ssm * len(prompts) == n_ssm * len(calls),
          f"12: {rec['k3_launches']} K3 launches for {len(calls)} prefills")
    return reqs, rec, engine


def pool_run(torch, dev, cfg, params, prompts, want, n_ssm: int, *,
             dcn: float, slots: int, kill: str | None = None,
             **router_kw) -> tuple:
    """12b/12c: ``Session.serve_pool`` over pilots d0, d1, pf aliased on
    the one card, decode engines on pf and d1, prefill as Raptor
    micro-tasks on pf, pages sized by kv_cache_rates(cfg), one params
    tree.  With `kill`, that decode pilot is recovered through the
    ControlPlane after two of its decode steps.  Returns (record,
    requests)."""
    from repro_torch.core import (PilotDescription, ResourceManager, Session,
                                  TransferCostModel)
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.serve import ModelBackend, Request
    session = Session(ResourceManager(devices=[dev] * 3),
                      cost_model=TransferCostModel(dcn_cost_per_byte=dcn))
    calls, backends = [], []

    def factory():
        backends.append(counted_backend(ModelBackend(cfg, params, device=dev),
                                        calls))
        return backends[-1]

    try:
        for name in ("d0", "d1", "pf"):
            session.add_pilot(PilotDescription(n_chips=1, name=name,
                                               enable_speculation=False))
        if kill:
            session.enable_fault_tolerance(heartbeat_timeout_s=60.0)
        router = session.serve_pool(
            factory, slots=slots, max_seq=ENGINE_MAX_SEQ,
            prompt_bucket=ENGINE_BUCKET, decode_pilots=["pf", "d1"],
            prefill_pilot="pf", cfg=cfg, **router_kw)
        check(all(b.params is params for b in backends),
              "a backend copied the weights")
        engines = [h.engine for h in router.handles]
        victim = taken = None
        if kill:
            victim = session.pilots[kill]
            (handle,) = [h for h in router.handles if h.pilot == victim.uid]
            taken = hold_after(handle, 2)
        reqs = [Request(uid=i, tokens=p, max_new=ENGINE_MAX_NEW)
                for i, p in enumerate(prompts)]
        before = ms_ops.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            router.submit(r)
        recovered = None
        if kill:
            deadline = time.monotonic() + 300
            while len(taken) < 2 and time.monotonic() < deadline:
                time.sleep(1e-3)
            check(handle.engine.n_active > 0,
                  f"12c: no request is decoding on {kill}")
            ev = session.control_plane.recover_pilot(victim,
                                                     reason="chip-smoke")
            check(not session.control_plane.errors,
                  f"12c: recovery errors {session.control_plane.errors}")
            recovered = ev.serve_requests_recovered
            check(recovered >= 1, f"12c: {recovered} requests recovered")
        router.drain(timeout_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = router.snapshot()
        ledger = session.dataplane.ledger()
    finally:
        session.shutdown()
    rec = serve_latency(reqs, wall) | {
        "mismatches": token_mismatches(
            reqs, want, f"12 dcn {dcn:.0e}{f' kill {kill}' if kill else ''}"),
        "dcn_cost_per_byte": dcn, "slots": slots,
        "decode_steps": sum(e.steps for e in engines),
        "prefills": len(calls), "k3_launches": ms_ops.LAUNCHES - before,
        "cross_pilot": snap["cross_pilot"],
        "splice_bytes": snap["splice_bytes"],
        "local_splices": snap["kv"]["local_splices"],
        "ledger_kv_splice": ledger["by_reason"].get("kv-splice", 0),
        "admitted": [e.admitted for e in engines],
        "recovered_requests": recovered}
    check(rec["k3_launches"] == n_ssm * len(calls),
          f"12: {rec['k3_launches']} K3 launches for {len(calls)} prefills")
    check(snap["prefill_offloaded"] == len(prompts),
          f"12: {snap['prefill_offloaded']} prefills offloaded")
    return rec, reqs


def hold_after(handle, n_steps: int) -> list:
    """Let `handle`'s engine take `n_steps` decode steps, then hold its
    next step until the engine is told to stop (its pilot is being
    recovered): the kill lands while its requests are mid-flight."""
    backend = handle.engine.backend
    step, taken = backend.step, []

    def held(*args):
        if len(taken) >= n_steps:
            handle.stop_event.wait(300)
        taken.append(1)
        return step(*args)

    backend.step = held
    return taken


def phase_engine(torch, dev) -> dict:
    """12. The serving engine at ENGINE_ARCH's full width and depth in its
    own dtype: (a) one engine, each request alone and then all at once,
    token for token equal; (b) ``Session.serve_pool`` at the reference
    test's two DCN settings; (c) a decode pilot recovered mid-flight.

    A request's tokens are held against the same request alone in an
    engine of the same slot count: a decode step's rounding depends on
    its batch's row count (``tools/decode_rows.py``), so the 1-slot pool
    of 12b is held against each request alone in a 1-slot engine, and
    how far it is from 12a's 4-slot tokens is printed."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serve import kv_cache_rates
    cfg = configs.get(ENGINE_ARCH)
    n_ssm = sum(s.n_layers for s in tf.build_segments(cfg) if s.ssm)
    gen = torch.Generator(device=dev).manual_seed(ENGINE_SEED)
    params = tf.init_params(cfg, gen, device=dev)
    prompts = engine_prompts(cfg.vocab_size)
    print(f"phase 12: serving engine, {ENGINE_ARCH} ({cfg.n_layers} layers, "
          f"{cfg.dtype}), {len(prompts)} prompts of "
          f"{sorted(len(p) for p in prompts)} tokens, max_new "
          f"{ENGINE_MAX_NEW}, bucket {ENGINE_BUCKET}, max_seq "
          f"{ENGINE_MAX_SEQ}; kv_cache_rates {kv_cache_rates(cfg)}")
    out = {"arch": ENGINE_ARCH, "prompt_lens": [len(p) for p in prompts],
           "max_new": ENGINE_MAX_NEW}
    solo, out["12a solo"], _ = engine_run(torch, dev, cfg, params, prompts,
                                          n_ssm, solo=True)
    want = [r.output for r in solo]
    batched, out["12a batched"], engine = engine_run(
        torch, dev, cfg, params, prompts, n_ssm, solo=False)
    problems = token_mismatches(batched, want, "12a batched")
    check(engine.steps < sum(r.max_new for r in batched),
          f"12a: {engine.steps} decode steps, not under "
          f"{sum(r.max_new for r in batched)}")
    prof = _device_profile(torch, lambda: engine.backend.step(
        engine.state, engine.pos, engine.start))
    out["12a batched"]["decode_step_profile"] = prof
    # one slot: the requests one at a time, each decoded in a 1-row batch
    one, out["12b solo, 1 slot"], _ = engine_run(
        torch, dev, cfg, params, prompts, n_ssm, solo=False, slots=1)
    want_1 = [r.output for r in one]
    out["1 slot vs 4 slots"] = token_mismatches(one, want, "1 slot alone")
    for key in ("12a solo", "12a batched", "12b solo, 1 slot"):
        print(f"  {key}: {_latency_line(out[key])}")
    print(f"  12a: K3 {n_ssm} launches a prefill, 0 a decode step; one "
          f"profiled decode step of {ENGINE_SLOTS} rows: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f}"
          f" ms ({_share(prof['busy_share'])}), {prof['kernel_launches']} "
          "device kernels")
    print(f"  alone at 1 slot vs alone at {ENGINE_SLOTS} slots: "
          f"{len(out['1 slot vs 4 slots'])} of {len(prompts)} requests differ")
    for line in out["1 slot vs 4 slots"]:
        print(f"    {line}")
    b1, reqs_b1 = pool_run(torch, dev, cfg, params, prompts, want, n_ssm,
                           dcn=1e-3, slots=ENGINE_SLOTS)
    check(b1["cross_pilot"] == 0 and b1["local_splices"] == len(prompts)
          and b1["ledger_kv_splice"] == 0,
          f"12b at DCN 1e-3: {b1}")
    b2, _ = pool_run(torch, dev, cfg, params, prompts, want_1, n_ssm,
                     dcn=1e-15, slots=1, load_weight=4.0)
    check(b2["cross_pilot"] > 0
          and b2["ledger_kv_splice"] == b2["splice_bytes"] > 0,
          f"12b at DCN 1e-15: {b2}")
    c, _ = pool_run(torch, dev, cfg, params, prompts, want, n_ssm, dcn=1e-15,
                    slots=ENGINE_SLOTS, kill="d1", load_weight=4.0)
    out["12b dcn 1e-3"], out["12b dcn 1e-15"], out["12c recovery"] = b1, b2, c
    for key in ("12b dcn 1e-3", "12b dcn 1e-15", "12c recovery"):
        rec = out[key]
        print(f"  {key} ({rec['slots']} slots an engine): "
              f"{_latency_line(rec)}; {rec['cross_pilot']} "
              f"cross-pilot splices, {rec['splice_bytes']} B (ledger "
              f"kv-splice {rec['ledger_kv_splice']} B), {rec['local_splices']}"
              f" local; admitted {rec['admitted']}"
              + (f"; {rec['recovered_requests']} requests recovered"
                 if rec["recovered_requests"] is not None else ""))
        problems += rec["mismatches"]
    for line in problems:
        print(f"  MISMATCH {line}")
    check(not problems, f"phase 12: {len(problems)} requests differ from "
          "their solo tokens")
    print("  12a-12c: every request got the tokens it gets alone in an "
          "engine of its slot count")
    return out


def fig8_stages(km, n: int, k: int, seed: int, runs: dict | None = None,
                pin: str | None = None):
    """The paper's Fig-8 DAG: ``simulate`` draws n points on its pilot's
    card from a generator seeded with `seed` (so a re-run draws the same
    points) and ``analyze`` runs K-Means with K1.  `runs` counts the
    simulate runs and the K1 launches of each analyze."""
    from repro_torch.core import analytics_stage, hpc_stage
    from repro_torch.kernels.kmeans import ops
    runs = {} if runs is None else runs

    def simulate(mesh=None):
        runs["simulate"] = runs.get("simulate", 0) + 1
        return {"pts": km.make_dataset(n, km.PAPER_DIM, seed=seed,
                                       device=mesh.devices.flat[0])}

    def analyze(engine=None, pts=None):
        before = ops.LAUNCHES
        _, cost = km.kmeans_fit(engine, "pts", k, iters=ITERS,
                                use_kernel=True)
        runs.setdefault("k1", []).append(ops.LAUNCHES - before)
        return {"cost": cost}

    return [hpc_stage("simulate", simulate, outputs=("pts",), pilot=pin),
            analytics_stage("analyze", analyze, inputs=("pts",))]


def direct_fit(torch, km, dev, n: int, k: int, seed: int) -> float:
    """kmeans_fit with K1 on the same points, outside any Session."""
    from repro_torch.analytics.engine import AnalyticsEngine
    from repro_torch.core import DataPlane, DeviceGrid
    eng = AnalyticsEngine(DeviceGrid([dev]), DataPlane())
    eng.put("pts", km.make_dataset(n, km.PAPER_DIM, seed=seed, device=dev))
    cost = km.kmeans_fit(eng, "pts", k, iters=ITERS, use_kernel=True)[1]
    torch.cuda.synchronize()
    return cost


def phase_session(torch, dev, km, direct: dict):
    """8. The paper's Fig 8 through the Session: two pilots aliased over
    one card, the analyze stage placed by the DCN cost, at each K-Means
    scenario and each cost of benchmarks/bench_session_placement.py."""
    from repro_torch.core import (Link, PilotDescription, ResourceManager,
                                  Session, TransferCostModel)
    print("phase 8: Session (Fig 8): simulate -> analyze over pilots hpc "
          "and ana on one card")
    rows = []
    for s, (name, (n, k)) in enumerate(km.PAPER_SCENARIOS.items()):
        modes = []
        for dcn in SESSION_DCN_COSTS:
            session = Session(ResourceManager(devices=[dev] * 2),
                              cost_model=TransferCostModel(
                                  dcn_cost_per_byte=dcn))
            try:
                session.add_pilot(PilotDescription(n_chips=1, name="hpc",
                                                   runtime="hpc"))
                session.add_pilot(PilotDescription(n_chips=1, name="ana",
                                                   runtime="analytics"))
                runs = {}
                t0 = time.perf_counter()
                out = session.run(fig8_stages(km, n, k, SESSION_SEED + s,
                                              runs), timeout=600)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
                place = session.placements["analyze"]
                dcn_b = session.dataplane.moved_by_link(Link.DCN)
                row = {"scenario": name, "dcn_cost_per_byte": dcn,
                       "placed_on": place["pilot"], "mode": place["mode"],
                       "dcn_bytes": dcn_b,
                       "ici_bytes": session.dataplane.moved_by_link(Link.ICI),
                       "score_hpc": place["scores"]["hpc"]["total"],
                       "score_ana": place["scores"]["ana"]["total"],
                       "cost": out["analyze"]["cost"],
                       "direct_cost": direct[name], "wall_ms": wall_ms,
                       "mode1_spawn_s": place.get("mode1_spawn_s"),
                       "k1_launches": runs["k1"][0]}
            finally:
                session.shutdown()
            check(row["k1_launches"] >= ITERS,
                  f"{name} at {dcn}: analyze launched K1 "
                  f"{row['k1_launches']} times")
            check(math.isclose(row["cost"], direct[name], rel_tol=1e-5),
                  f"{name} at {dcn}: session cost {row['cost']} vs direct "
                  f"kmeans_fit {direct[name]}")
            if dcn == SESSION_DCN_COSTS[0]:
                check((row["placed_on"], row["mode"], dcn_b)
                      == ("ana", "native", n * km.PAPER_DIM * 4),
                      f"{name} at DCN cost 0: {row}")
            if dcn == SESSION_DCN_COSTS[-1]:
                check((row["placed_on"], row["mode"], dcn_b)
                      == ("hpc", "mode1-carve", 0),
                      f"{name} at DCN cost 1: {row}")
            modes.append((row["placed_on"], row["mode"]))
            rows.append(row)
            spawn = row["mode1_spawn_s"]
            print(f"  {name} dcn {dcn:.0e}/B: {row['placed_on']} "
                  f"{row['mode']}, DCN {dcn_b} B, ICI {row['ici_bytes']} B, "
                  f"scores hpc {row['score_hpc']:.6g} ana "
                  f"{row['score_ana']:.6g}, wall {wall_ms:.3f} ms, "
                  f"mode1_spawn_s {spawn if spawn is None else f'{spawn:.6f}'}"
                  f", cost {row['cost']:.6e} (direct {direct[name]:.6e}), "
                  f"K1 {row['k1_launches']} launches")
        changes = sum(a != b for a, b in zip(modes, modes[1:]))
        check(changes <= 1, f"{name}: the decision changed {changes} times "
              "along the sweep")
    return rows


def noop(_=None) -> None:
    return None


def phase_raptor(torch, dev, km, ops) -> dict:
    """9. Raptor micro-tasks through Session.map: K1 on 16 row shards of
    the 1M x 50 points, bitwise equal to one call over all of them; then
    the dispatch time of no-op micro-tasks and of no-op CUs."""
    from repro_torch.core import (ComputeUnitDescription, PilotDescription,
                                  ResourceManager, Session)
    print("phase 9: Raptor micro-tasks through Session.map")
    n, k = km.PAPER_SCENARIOS["1m_points_50_clusters"]
    gen = torch.Generator(device=dev).manual_seed(9)
    pts = km.make_dataset(n, seed=9, device=dev)
    cent = pts[torch.randperm(n, generator=gen, device=dev)[:k]].contiguous()
    want_idx, want_min = ops.assign(pts, cent)
    shards = torch.tensor_split(pts, RAPTOR_SHARDS)
    session = Session(ResourceManager(devices=[dev] * RAPTOR_SLOTS))
    try:
        pilot = session.add_pilot(PilotDescription(
            n_chips=RAPTOR_SLOTS, name="hpc", enable_speculation=False))

        def assign_shard(shard):       # a closure: runs by reference
            return ops.assign(shard, cent)

        ops.LAUNCHES = ops.MERGE_LAUNCHES = 0
        parts = session.map(assign_shard, shards, timeout=600)
        torch.cuda.synchronize()
        launches = (ops.LAUNCHES, ops.MERGE_LAUNCHES)
        check(launches[0] == RAPTOR_SHARDS,
              f"Session.map launched K1 {launches[0]} times, want "
              f"{RAPTOR_SHARDS}")
        got_idx = torch.cat([p[0] for p in parts])
        got_min = torch.cat([p[1] for p in parts])
        check(torch.equal(got_idx, want_idx) and torch.equal(got_min,
                                                             want_min),
              "sharded K1 through Session.map is not bitwise equal to one "
              "call over all points")
        workers = next(iter(session._overlays.values())).n_workers
        print(f"  {RAPTOR_SHARDS} shards of {n // RAPTOR_SHARDS} points, "
              f"k={k}, {workers} overlay workers: indices and minima "
              f"bitwise equal to one call; {launches[0]} K1 launches")
        dispatch = {}
        for count in (MICRO_TASKS // 10, MICRO_TASKS):
            t0 = time.perf_counter()
            session.map(noop, range(count), timeout=600)
            dispatch[f"micro_us_{count}"] = (
                1e6 * (time.perf_counter() - t0) / count)
        for count in CU_TASKS:
            t0 = time.perf_counter()
            cus = [pilot.submit(ComputeUnitDescription(
                fn=noop, n_chips=1, needs_mesh=False, tag="noop"))
                for _ in range(count)]
            for cu in cus:
                cu.wait(600)
            dispatch[f"cu_us_{count}"] = (
                1e6 * (time.perf_counter() - t0) / count)
    finally:
        session.shutdown()
    small = MICRO_TASKS // 10
    print(f"  no-op dispatch: micro-task {dispatch[f'micro_us_{small}']:.3f} "
          f"us at {small}, {dispatch[f'micro_us_{MICRO_TASKS}']:.3f} us at "
          f"{MICRO_TASKS}; CU "
          + ", ".join(f"{dispatch[f'cu_us_{c}']:.3f} us at {c}"
                      for c in CU_TASKS)
          + f"; per task, CU / micro-task at {small}: "
          f"{dispatch[f'cu_us_{small}'] / dispatch[f'micro_us_{small}']:.1f}x")
    return {"launches": launches[0], "merge_launches": launches[1],
            "shards": RAPTOR_SHARDS, "workers": workers, **dispatch}


def phase_recovery(torch, dev, km, ops, want_cost: float) -> dict:
    """10. (a) lineage recovery: simulate pinned to HPC pilot b, b killed
    and recovered, pts re-made on HPC pilot a, analyze's cost unchanged;
    (b) checkpoint, shutdown, Session.resume on a fresh ResourceManager:
    simulate is not re-run and the cost is the same."""
    from repro_torch.core import (FailureInjector, PilotDescription,
                                  ResourceManager, Session)
    print("phase 10: failure recovery and checkpoint/resume at 1M x 50")
    n, k = km.PAPER_SCENARIOS["1m_points_50_clusters"]
    seed = SESSION_SEED + list(km.PAPER_SCENARIOS).index(
        "1m_points_50_clusters")
    out = {}
    ops.LAUNCHES = ops.MERGE_LAUNCHES = 0
    # (a) three lease slots: HPC pilots a and b, analytics pilot ana
    session = Session(ResourceManager(devices=[dev] * 3))
    try:
        a = session.add_pilot(PilotDescription(n_chips=1, name="a"))
        b = session.add_pilot(PilotDescription(n_chips=1, name="b"))
        session.add_pilot(PilotDescription(n_chips=1, name="ana",
                                           runtime="analytics"))
        session.enable_fault_tolerance(heartbeat_timeout_s=1.0)
        runs = {}
        simulate, analyze = fig8_stages(km, n, k, seed, runs, pin="b")
        session.run([simulate], timeout=600)
        check(session.dataplane.home_pilots("pts") == {b.uid},
              "pts is not homed on b")
        inj = FailureInjector(list(session.pilots.values()), seed=0)
        check(inj.kill_pilot(b) is not None, "the injector refused to kill b")
        ev = session.control_plane.recover_pilot(b, reason="chip-smoke")
        check(not session.control_plane.errors,
              f"recovery errors: {session.control_plane.errors}")
        check(ev.lost_datasets == ["pts"] and ev.rematerialized == 1,
              f"recovery lost {ev.lost_datasets}, re-made "
              f"{ev.rematerialized}")
        check(session.dataplane.home_pilots("pts") == {a.uid}
              and session.placements["simulate"]["pilot"] == "a",
              "pts was not re-made on a")
        res = session.run([analyze], timeout=600)
        torch.cuda.synchronize()
        mttr = inj.mttr_samples(session.control_plane)
        check(runs["simulate"] == 2, f"simulate ran {runs['simulate']} times")
        check(len(mttr) == 1, f"{len(mttr)} MTTR samples")
        out["recovered_cost"] = res["analyze"]["cost"]
        out["mttr_s"] = mttr[0]
        out["recovery_s"] = ev.recovery_s
        out["analyze_placed_on"] = session.placements["analyze"]["pilot"]
        out["k1_after_recovery"] = runs["k1"][0]
    finally:
        session.shutdown()
    check(math.isclose(out["recovered_cost"], want_cost, rel_tol=1e-5),
          f"cost after recovery {out['recovered_cost']} vs {want_cost}")
    check(out["k1_after_recovery"] >= ITERS, "analyze did not launch K1")
    print(f"  (a) b killed and recovered: pts re-made on a through lineage, "
          f"simulate ran 2 times; MTTR {out['mttr_s']:.6f} s (recovery "
          f"{out['recovery_s']:.6f} s); analyze on "
          f"{out['analyze_placed_on']}: cost {out['recovered_cost']:.6e} "
          f"(phase 8 {want_cost:.6e})")
    # (b) checkpoint after simulate, resume on a fresh pool
    pilots = (PilotDescription(n_chips=1, name="hpc"),
              PilotDescription(n_chips=1, name="ana", runtime="analytics"))
    runs = {}
    stages = fig8_stages(km, n, k, seed, runs)
    with tempfile.TemporaryDirectory() as ck:
        first = Session(ResourceManager(devices=[dev] * 2))
        try:
            for desc in pilots:
                first.add_pilot(desc)
            first.run(stages[:1], timeout=600)
            t0 = time.perf_counter()
            first.checkpoint(ck)
            out["checkpoint_s"] = time.perf_counter() - t0
        finally:
            first.shutdown()
        t0 = time.perf_counter()
        second = Session.resume(ck, ResourceManager(devices=[dev] * 2))
        try:
            for desc in pilots:
                second.add_pilot(desc)
            res = second.run(stages, timeout=600)
            torch.cuda.synchronize()
            out["resume_s"] = time.perf_counter() - t0
            out["resumed_cost"] = res["analyze"]["cost"]
            out["resume_bytes"] = second.dataplane.ledger()["by_reason"][
                "session-resume"]
        finally:
            second.shutdown()
    check(runs["simulate"] == 1, f"simulate ran {runs['simulate']} times "
          "across checkpoint and resume")
    check(out["resume_bytes"] == n * km.PAPER_DIM * 4,
          f"resume restored {out['resume_bytes']} bytes")
    check(math.isclose(out["resumed_cost"], out["recovered_cost"],
                       rel_tol=1e-5),
          f"resumed cost {out['resumed_cost']} vs {out['recovered_cost']}")
    out["launches"], out["merge_launches"] = ops.LAUNCHES, ops.MERGE_LAUNCHES
    print(f"  (b) checkpoint {out['checkpoint_s']:.6f} s; resume (fresh "
          f"pool, restore {out['resume_bytes']} B, analyze) "
          f"{out['resume_s']:.6f} s; simulate ran once; cost "
          f"{out['resumed_cost']:.6e}; {out['launches']} K1 launches in "
          "phase 10")
    return out


def bitwise_across_splits(torch, ops, km_kernel, p, c, blocks: dict,
                          sms: int, label: str) -> list:
    """K1 gives bitwise the same idx and distance with one split, the
    split count the wrapper chooses and the most it takes."""
    n, d = p.shape
    k = c.shape[0]
    counts = sorted({1, chosen_splits(ops, km_kernel, n, k, d, blocks, sms),
                     ops.max_splits(k, blocks["bk"])})
    base = [t.clone() for t in bare_launcher(
        torch, km_kernel, p, c, blocks["bn"], blocks["bk"], counts[0])()]
    for s in counts[1:]:
        got = bare_launcher(torch, km_kernel, p, c, blocks["bn"],
                            blocks["bk"], s)()
        check(torch.equal(got[0], base[0]) and torch.equal(got[1], base[1]),
              f"{label}: {s} splits not bitwise equal to {counts[0]}")
    return counts


def phase_assign(torch, dev, km, km_kernel, ops, ref, blocks: dict,
                 sms: int):
    """2. K1 (scan and merge) against its plain version at the paper's
    shapes and the ragged, bf16, wide and tie cases; bitwise equal across
    split counts; timed beside its bound, its plain version and
    cdist + min."""
    print(f"phase 2: kmeans_assign against its plain version (blocks "
          f"{blocks}, {sms} SMs)")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err, merge_err = 0.0, 0.0
    shapes, merge_rows = [], []
    for name, (n, k) in km.PAPER_SCENARIOS.items():
        d = km.PAPER_DIM
        p = km.make_dataset(n, seed=1, device=dev)
        c = p[torch.randperm(n, generator=gen, device=dev)[:k]].contiguous()
        max_err = max(max_err, compare_assign(torch, ops, ref, p, c, name))
        counts = bitwise_across_splits(torch, ops, km_kernel, p, c, blocks,
                                       sms, name)
        splits = chosen_splits(ops, km_kernel, n, k, d, blocks, sms)
        grid = -(-n // (blocks["bn"] * km_kernel.rows(d))) * splits
        bound = assign_bound(n, k, d)
        bare = bare_launcher(torch, km_kernel, p, c, blocks["bn"],
                             blocks["bk"], splits)
        # kernel, plain, library, kernel, plain: in turns on one card
        t_kernel = cuda_ms(torch, lambda: ops.assign(p, c))
        t_plain = cuda_ms(torch, lambda: ref.assign(p, c))
        t_lib = cuda_ms(torch, lambda: torch.cdist(p, c).min(dim=1))
        t_kernel = min(t_kernel, cuda_ms(torch, lambda: ops.assign(p, c)))
        t_plain = min(t_plain, cuda_ms(torch, lambda: ref.assign(p, c)))
        # the bare launches (no checks, no allocations) back to back, and
        # their device time alone, replayed from a CUDA graph
        t_bare = cuda_ms(torch, bare)
        t_dev = graph_ms(torch, bare)
        t_host = host_us(torch, lambda: ops.assign(p, c))
        row = {"shape": name, "n": n, "k": k, "d": d, "splits": splits,
               "split_counts_bitwise": counts, "blocks": grid,
               "sms_filled": min(grid, sms), "ms": t_kernel,
               "kernel_only_ms": t_bare, "device_ms": t_dev,
               "wrapper_host_us": t_host, "plain_ms": t_plain,
               "library_ms": t_lib,
               **bound_from(bound["t_bytes"], bound["t_ops"],
                            bytes=bound["bytes"], flops=bound["flops"])}
        row["share_of_bound"] = row["bound_ms"] / t_dev
        shapes.append(row)
        print(f"  {name}: {splits} splits x "
              f"{grid // splits} point blocks = {grid} blocks on {sms} "
              f"SMs; wrapper {t_kernel:.4f} ms (host {t_host:.1f} us a "
              f"call), bare launch {t_bare:.4f} ms, device {t_dev:.4f} ms; "
              f"plain {t_plain:.4f} ms, cdist+min {t_lib:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{100 * row['share_of_bound']:.1f} % of it on the device); "
              f"bitwise equal over splits {counts}")
        if splits > 1:
            # the merge kernel alone against its plain version, on the
            # scan's own partials
            idx, dist = bare()
            part_idx, part_min = bare.partials
            want_idx, want_dist = ref.merge(p, part_idx, part_min)
            torch.cuda.synchronize()
            check(torch.equal(idx, want_idx), f"{name}: merge indices")
            err = held(torch, dist, want_dist, 1e-5, f"{name} merge")
            merge_err = max(merge_err, err)
            i_out = torch.empty_like(idx)
            d_out = torch.empty_like(dist)

            def merge():
                km_kernel.merge_cuda(p, part_idx, part_min, i_out, d_out)
            t_m = graph_ms(torch, merge)
            t_mp = cuda_ms(torch, lambda: ref.merge(p, part_idx, part_min))
            # partials and points read once, results written once; a
            # compare per partial and d FMAs (2 FLOPs each) per point
            mb = bound_of(4 * (2 * splits * n + n * d) + 8 * n,
                          n * (splits + 2 * d))
            merge_rows.append({"shape": name, "n": n, "splits": splits,
                               "ms": t_m, "plain_ms": t_mp,
                               "library_ms": None, **mb})
            print(f"    merge ({splits} partials a point): device "
                  f"{t_m:.4f} ms, plain {t_mp:.4f} ms, bound "
                  f"{mb['bound_ms']:.4f} ms ({mb['bound_by']}), max |err| "
                  f"{err:.1e}")
    ragged_p = torch.randn(10_007, 3, generator=gen, device=dev)
    ragged_c = torch.randn(517, 3, generator=gen, device=dev)
    max_err = max(max_err, compare_assign(torch, ops, ref, ragged_p,
                                          ragged_c, "ragged"))
    bitwise_across_splits(torch, ops, km_kernel, ragged_p, ragged_c, blocks,
                          sms, "ragged")
    bf_p = torch.randn(4_099, 3, generator=gen, device=dev).bfloat16()
    bf_c = torch.randn(300, 3, generator=gen, device=dev).bfloat16()
    max_err = max(max_err, compare_assign(torch, ops, ref, bf_p, bf_c,
                                          "bf16"))
    for w in (16, 32):
        wide_p = torch.randn(2_000, w, generator=gen, device=dev)
        wide_c = torch.randn(100, w, generator=gen, device=dev)
        max_err = max(max_err, compare_assign(torch, ops, ref, wide_p,
                                              wide_c, f"wide d={w}"))
        bitwise_across_splits(torch, ops, km_kernel, wide_p, wide_c, blocks,
                              sms, f"wide d={w}")
    base = torch.randn(40, 3, generator=gen, device=dev)
    tie_c = torch.cat([base, base, base]).contiguous()  # every centroid x3
    tie_p = torch.randn(5_000, 3, generator=gen, device=dev)
    max_err = max(max_err, compare_assign(torch, ops, ref, tie_p, tie_c,
                                          "tie"))
    tie_idx, _ = ops.assign(tie_p, tie_c)
    check(bool((tie_idx < base.shape[0]).all()),
          "tie: a duplicate centroid did not resolve to its first index")
    # duplicates straddling every split boundary at 10k x 5000: the
    # centroid after each boundary repeats the one before it, and points
    # sit next to them
    n, k = km.PAPER_SCENARIOS["10k_points_5k_clusters"]
    splits = chosen_splits(ops, km_kernel, n, k, 3, blocks, sms)
    check(splits > 1, "10k x 5000 is not split: no boundary to test")
    lows = torch.tensor([lo for lo, _ in ops.split_ranges(k, splits)[1:]],
                        device=dev)
    sc = torch.randn(k, 3, generator=gen, device=dev)
    sc[lows] = sc[lows - 1]
    sp = torch.randn(n, 3, generator=gen, device=dev)
    near = sc[lows - 1].repeat(4, 1)
    sp[:near.shape[0]] = near + 1e-3 * torch.randn(
        near.shape, generator=gen, device=dev)
    max_err = max(max_err, compare_assign(torch, ops, ref, sp, sc,
                                          "tie across split boundaries"))
    counts = bitwise_across_splits(torch, ops, km_kernel, sp, sc, blocks,
                                   sms, "tie across split boundaries")
    s_idx, _ = ops.assign(sp, sc)
    check(not bool(torch.isin(s_idx, lows.to(torch.int32)).any()),
          "a duplicate across a split boundary took the later index")
    print(f"  tie across split boundaries: {len(lows)} boundaries, "
          f"{near.shape[0]} points beside them resolve to the lower "
          f"index; bitwise equal over splits {counts}")
    return max_err, shapes, merge_err, merge_rows


# ------------------------------------------------ 13. training on the card
def scan_bwd_bound(B: int, S: int, di: int, st: int, es: int) -> dict:
    """K3-bwd's least time: a, b, C, h0 read once (es bytes each), dy and
    dh_last (f32) read once, da, db, dC, dh0 written once (es bytes); per
    element of a, 8 FLOPs (the h rebuild's FMA, g's FMA, da, the carry,
    and dC's multiply-add)."""
    big, c, h = B * S * di * st, B * S * st, B * di * st
    nbytes = es * (2 * big + c + h) + 4 * (B * S * di + h) \
        + es * (2 * big + c + h)
    return bound_of(nbytes, 8 * big)


def phase_scan_bwd(torch, dev):
    """13a. K3-bwd against its plain version (``ref.scan_backward``) at
    BWD_CASES, run twice (bitwise equal), timed beside its bound, its
    plain version and K3 forward at the same shape.  K3 forward is held
    against ``ref.scan`` on the same inputs, so both kernels of the
    training and hybrid paths are held at those paths' own shapes.
    Returns (K3-bwd's max |err|, K3 forward's max |err|, timed rows)."""
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    print("phase 13a: mamba_scan backward (K3-bwd) against its plain version")
    gen = torch.Generator(device=dev).manual_seed(13)
    max_err, fwd_err, rows = 0.0, 0.0, []
    names = ("da", "db", "dC", "dh0")
    for label, B, S, di, st, bf16, timed in BWD_CASES:
        dtype = torch.bfloat16 if bf16 else torch.float32
        tol = BWD_BF16_TOL if bf16 else BWD_TOL
        args = scan_inputs(torch, gen, dev, B, S, di, st, dtype) + (
            randn(torch, gen, dev, B, S, di),
            randn(torch, gen, dev, B, di, st))
        got = ms_ops.scan_backward(*args)
        again = ms_ops.scan_backward(*args)
        want = ms_ref.scan_backward(*args)
        torch.cuda.synchronize()
        check(all(g.dtype == dtype for g in got), f"{label}: output dtypes "
              f"{[g.dtype for g in got]}, want {dtype}")
        check(all(torch.equal(g, h) for g, h in zip(got, again)),
              f"{label}: two runs on the same inputs differ")
        err = max(held(torch, g, w, tol, f"{label} {n}")
                  for g, w, n in zip(got, want, names))
        max_err = max(max_err, err)
        y, h = ms_ops.scan(*args[:4])
        yr, hr = ms_ref.scan(*args[:4])
        f_err = max(held(torch, y, yr, SCAN_TOL, f"{label} K3 y"),
                    held(torch, h, hr, SCAN_TOL, f"{label} K3 h_last"))
        fwd_err = max(fwd_err, f_err)
        del y, h, yr, hr
        line = (f"  {label} {dtype}: max |err| {err:.3e} (tol {tol}), "
                f"bitwise equal over two runs; K3 forward max |err| "
                f"{f_err:.3e} (tol {SCAN_TOL})")
        if timed:
            # kernel, plain, kernel: in turns on one card
            t_k = cuda_ms(torch, lambda: ms_ops.scan_backward(*args))
            t_p = cuda_ms(torch, lambda: ms_ref.scan_backward(*args), 1)
            t_k = min(t_k, cuda_ms(torch, lambda: ms_ops.scan_backward(*args)))
            t_f = cuda_ms(torch, lambda: ms_ops.scan(*args[:4]))
            bound = scan_bwd_bound(B, S, di, st, args[0].element_size())
            rows.append({"shape": label, "B": B, "S": S, "di": di, "st": st,
                         "dtype": str(dtype), "ms": t_k, "plain_ms": t_p,
                         "forward_ms": t_f, "library_ms": None, **bound})
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, K3 "
                     f"forward {t_f:.4f} ms, bound {bound['bound_ms']:.4f} "
                     f"ms ({bound['bound_by']}), "
                     f"{bound['bytes'] / t_k / 1e9:.3f} TB/s")
        print(line)
        del args, got, again, want
    return max_err, fwd_err, rows


def ssm_bwd_bound(B: int, S: int, di: int, st: int) -> dict:
    """The fused backward's least time.  Bytes, all f32: dt, u and dy read
    once and ddt, du written once ((B, S, di) each); Bc, C read and dBc,
    dC written ((B, S, st)); A read and dA written ((di, st)); h0, dh_last
    read and dh0 written ((B, di, st)).  Operations, per element of the
    (B, S, di, st) state: 22 FP32 operations (an FMA counts 2): the
    forward walk's dt A, u Bc and h's FMA (4), the backward walk's rebuild
    of the same (4), g's FMA, a g, a g h_{t-1} (4) and the ddt, dA, du,
    dBc and dC FMAs (10); and 2 exp (one a walk) at the SFU's rate.  The
    FP32 and SFU pipes run side by side: the larger of the two."""
    big = B * S * di * st
    nbytes = 4 * (5 * B * S * di + 4 * B * S * st + 2 * di * st
                  + 3 * B * di * st)
    t_ops = max(22 * big / FP32_FLOP_PER_S, 2 * big / SFU_PER_S)
    return bound_from(nbytes / HBM_BYTES_PER_S, t_ops, bytes=nbytes,
                      flops=22 * big, exps=2 * big)


def ssm_bwd_inputs(torch, gen, dev, B, S, di, st) -> tuple:
    """(dt, A, u, Bc, C, h0, dy, dh_last), f32, at a Mamba layer's scale:
    dt after the softplus in (0.001, 0.1), A = -(1..st) per row (the
    configs' init) times (0.5, 1.5), u = dt x1 with x1 normal, Bc, C and
    the cotangents normal, h0 normal x 0.1."""
    dt = 0.001 + 0.099 * torch.rand(B, S, di, generator=gen, device=dev)
    A = -torch.arange(1, st + 1, dtype=torch.float32, device=dev) * (
        0.5 + torch.rand(di, st, generator=gen, device=dev))
    u = dt * randn(torch, gen, dev, B, S, di)
    return (dt, A.contiguous(), u, randn(torch, gen, dev, B, S, st),
            randn(torch, gen, dev, B, S, st),
            randn(torch, gen, dev, B, di, st, scale=0.1),
            randn(torch, gen, dev, B, S, di),
            randn(torch, gen, dev, B, di, st))


def ssm_held(torch, got, want, label: str) -> dict:
    """The fused backward's outputs (ddt, dA, du, dBc, dC, dh0) against
    its plain version's: ddt, du and dh0 held elementwise at SSM_TOL (max
    |err| returned), the sums dBc, dC and dA at SSM_SUM_TOL x max |want|
    (max |err| / max |want| returned)."""
    errs = {}
    for g, w, n in zip(got, want, ("ddt", "dA", "du", "dBc", "dC", "dh0")):
        check(g.shape == w.shape and g.dtype == torch.float32,
              f"{label} {n}: {g.dtype} {tuple(g.shape)}")
        if n in ("dBc", "dC", "dA"):
            check(bool(torch.isfinite(g).all()), f"{label} {n}: non-finite")
            scale = w.abs().max().item()
            e = (g - w).abs().max().item()
            check(e <= SSM_SUM_TOL * scale, f"{label} {n}: max |err| {e:.3e} "
                  f"over {SSM_SUM_TOL} x max |want| {scale:.3e}")
            errs[n] = e / scale if scale else 0.0
        else:
            errs[n] = held(torch, g, w, SSM_TOL, f"{label} {n}")
    return errs


def replaced_path(torch, ms_ops, dt, A, u, Bc, C, h0):
    """What the model ran before the fused backward: the tail as
    ``_ssm_inputs`` computes it, then ``ops.Scan`` (K3, K3-bwd)."""
    a = torch.exp_(dt[..., None] * A)
    b = u[..., None] * Bc[:, :, None, :]
    return ms_ops.Scan.apply(a, b, C, h0)


def backward_ms(torch, fwd, args, reps: int) -> float:
    """Device time of one backward through `fwd`'s graph on args[:6]
    (each requiring grad) for the cotangents args[6:], the graph kept."""
    ins = [x.detach().requires_grad_(True) for x in args[:6]]
    outs = fwd(*ins)
    ms = cuda_ms(torch, lambda: torch.autograd.grad(
        outs, ins, args[6:], retain_graph=True), reps)
    del outs, ins
    return ms


def phase_ssm_bwd(torch, dev):
    """13a. The fused backward of the scan and its input tail
    (``mamba_ssm_bwd.cu``) against its plain version (``ref.ssm_backward``)
    at SSM_CASES, run twice (bitwise equal); at the timed shapes, timed
    beside its bound, its plain version and the path it replaces (the
    tail's autograd and K3-bwd, one backward through each graph); its
    exp(dt A) against torch.exp's at the training shape, in ulps.
    Returns (max |err| of the per-element outputs, max |err| / max |want|
    of the sums, timed rows, the exp's max ulp difference)."""
    from repro_torch.kernels.mamba_scan import mamba_scan as ms_k
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    print("phase 13a: fused backward of the scan and its tail "
          "(mamba_ssm_bwd) against its plain version")
    gen = torch.Generator(device=dev).manual_seed(131)
    max_err, sum_err, rows, ulps = 0.0, 0.0, [], None
    for label, B, S, di, st, timed in SSM_CASES:
        args = ssm_bwd_inputs(torch, gen, dev, B, S, di, st)
        got = ms_ops.ssm_backward(*args)
        again = ms_ops.ssm_backward(*args)
        want = ms_ref.ssm_backward(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(g, h) for g, h in zip(got, again)),
              f"{label}: two runs on the same inputs differ")
        errs = ssm_held(torch, got, want, label)
        max_err = max(max_err, *(errs[n] for n in ("ddt", "du", "dh0")))
        sum_err = max(sum_err, *(errs[n] for n in ("dBc", "dC", "dA")))
        line = (f"  {label}: " + ", ".join(f"{n} {e:.3e}" for n, e in
                                            errs.items())
                + f" (ddt, du, dh0 max |err|, tol {SSM_TOL}; dBc, dC, dA "
                f"over max |want|, tol {SSM_SUM_TOL}), bitwise equal over "
                "two runs")
        del got, again, want
        if timed:
            lay = ms_k.ssm_layout(di, st)
            occ = ms_k.ssm_occupancy(di, st)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            blocks = lay["blocks"] * B
            waves = max(blocks / (occ["blocks_per_sm"] * sms),
                        blocks / lay["cluster"] / occ["resident_clusters"])
            print(f"  {label} launch: {lay['lane_states']} states a lane, "
                  f"{ms_k.SSM_THREADS} threads, {lay['rows']} rows a block, "
                  f"clusters of {lay['cluster']}, {blocks} blocks; "
                  f"{occ['blocks_per_sm']} blocks "
                  f"({occ['blocks_per_sm'] * ms_k.SSM_THREADS // 32} warps) "
                  f"resident an SM, {occ['resident_clusters']} clusters at "
                  f"once: {waves:.2f} waves")
            if ulps is None:
                dt, A = args[:2]
                mine = ms_k.decay_cuda(dt, A).view(torch.int32)
                theirs = torch.exp(dt[..., None] * A).view(torch.int32)
                diff = (mine - theirs).abs()
                ulps = int(diff.max().item())
                print(f"  exp(dt A) in the kernel vs torch.exp at {label}: "
                      f"max {ulps} ulp, {int((diff > 0).sum().item())} of "
                      f"{diff.numel()} differ")
                del mine, theirs, diff
            # kernel, plain, kernel: in turns on one card
            t_k = cuda_ms(torch, lambda: ms_ops.ssm_backward(*args))
            t_p = cuda_ms(torch, lambda: ms_ref.ssm_backward(*args), 1)
            t_k = min(t_k, cuda_ms(torch, lambda: ms_ops.ssm_backward(*args)))
            t_old = backward_ms(torch, lambda *x: replaced_path(
                torch, ms_ops, *x), args, REPLACED_REPS)
            t_new = backward_ms(torch, ms_ops.SelectiveScan.apply, args,
                                REPLACED_REPS)
            bound = ssm_bwd_bound(B, S, di, st)
            rows.append({"shape": label, "B": B, "S": S, "di": di, "st": st,
                         "layout": lay | occ, "waves": waves,
                         "ms": t_k, "plain_ms": t_p, "replaced_ms": t_old,
                         "function_backward_ms": t_new, "library_ms": None,
                         **bound})
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, replaced "
                     f"path (tail autograd + K3-bwd) {t_old:.4f} ms, the "
                     f"Function's backward {t_new:.4f} ms, bound "
                     f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
                     f"bytes {1e3 * bound['t_bytes']:.4f}, operations "
                     f"{1e3 * bound['t_ops']:.4f}), "
                     f"{bound['bytes'] / t_k / 1e9:.3f} TB/s")
        print(line)
        del args
    torch.cuda.empty_cache()
    return max_err, sum_err, rows, ulps


def _mamba_layer_grads(torch, dev, gen) -> float:
    """13b. One Hymba-1.5B Mamba layer at full width in f32, B 1 x S 512:
    every parameter's (and the input's) gradient for a fixed random
    cotangent, on the card (K3 + the fused backward) against the same
    layer on the CPU (the plain scan and the plain fused backward), per
    leaf max |err| <= GRAD_TOL * max |want|."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models.layers import mamba
    cfg = dataclasses.replace(configs.get("hymba-1.5b"), dtype="float32")
    p = mamba.init_mamba(cfg, gen)
    x = randn(torch, gen, dev, 1, LAYER_S, cfg.d_model)
    cot = randn(torch, gen, dev, 1, LAYER_S, cfg.d_model)

    def grads(p, x, cot):
        names = sorted(p)
        leaves = [p[k].detach().requires_grad_(True) for k in names]
        xs = x.detach().requires_grad_(True)
        out, _ = mamba.mamba_forward(cfg, dict(zip(names, leaves)), xs)
        gs = torch.autograd.grad((out * cot).sum(), leaves + [xs])
        return out, dict(zip(names + ["x"], gs))

    before = (ms_ops.LAUNCHES, ms_ops.SSM_BWD_LAUNCHES, ms_ops.BWD_LAUNCHES)
    out, got = grads(p, x, cot)
    torch.cuda.synchronize()
    check(out.grad_fn is not None, "Mamba layer output has no grad_fn on "
          "the card")
    n = tuple(x - y for x, y in zip(
        (ms_ops.LAUNCHES, ms_ops.SSM_BWD_LAUNCHES, ms_ops.BWD_LAUNCHES),
        before))
    check(n == (1, 1, 0), f"Mamba layer gradient: K3 {n[0]}, fused "
          f"backward {n[1]}, K3-bwd {n[2]} launches, want 1, 1, 0")
    _, want = grads({k: v.cpu() for k, v in p.items()}, x.cpu(), cot.cpu())
    worst = 0.0
    for name, w in want.items():
        err = (got[name].cpu() - w).abs().max().item()
        scale = w.abs().max().item()
        check(err <= GRAD_TOL * scale, f"Mamba layer grad {name}: max |err| "
              f"{err:.3e} over {GRAD_TOL} x max |want| {scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
    print(f"  phase 13b: Hymba-1.5B Mamba layer (B 1, S {LAYER_S}, f32): "
          f"{len(want)} gradients, card (K3 + fused backward) vs CPU (plain) "
          f"worst "
          f"max |err| / max |want| {worst:.3e} (tol {GRAD_TOL}); output "
          "grad_fn set")
    return worst


def _state_nbytes(state) -> int:
    from repro_torch.util import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(state))


def _states_equal(torch, a, b) -> bool:
    """Same tree, and every leaf the same dtype, shape, placements (for
    DTensors) and bits."""
    from repro_torch.sharding import parallel
    from repro_torch.util import tree_paths
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    def bits(t):
        return parallel.local(t).contiguous().view(ints[t.element_size()])

    def where(t):
        return getattr(t, "placements", None)

    if any(where(x) != where(y) for (_, x), (_, y) in zip(tree_paths(a),
                                                          tree_paths(b))):
        return False

    pa, pb = list(tree_paths(a)), list(tree_paths(b))
    return [k for k, _ in pa] == [k for k, _ in pb] and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y))
        for (_, x), (_, y) in zip(pa, pb))


def _checkpoint_roundtrip(torch, dev, cfg, trainer, card: str) -> dict:
    """One blocking save of the whole train state and one restore into a
    fresh Trainer, each timed; the restored state equal bit for bit."""
    import shutil
    from repro_torch.core import DeviceGrid
    from repro_torch.train.trainer import Trainer
    nbytes = _state_nbytes(trainer.state)
    ckpt_root = ROOT / "build" / "phase13-ckpt"
    ckpt_root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(ckpt_root).free
    print(f"  checkpoint: state {nbytes / 1e9:.3f} GB, free disk "
          f"{free / 1e9:.1f} GB at {ckpt_root}")
    check(free > 1.2 * nbytes, f"not enough disk for a {nbytes / 1e9:.1f} "
          f"GB checkpoint: {free / 1e9:.1f} GB free")
    try:
        fresh = Trainer(cfg, DeviceGrid([dev]), global_batch=TRAIN_BATCH,
                        seq=TRAIN_SEQ, ckpt_dir=str(ckpt_root))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.ckpt.save(trainer.state, int(trainer.state["step"]),
                        blocking=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step = fresh.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(step == int(trainer.state["step"]), f"restored step {step}")
        check(_states_equal(torch, trainer.state, fresh.state),
              "restored train state differs from the saved one")
        del fresh
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    print(f"  checkpoint save (blocking) {save_s:.3f} s, restore into a "
          f"fresh Trainer {restore_s:.3f} s, {nbytes / 1e9:.3f} GB, "
          f"bitwise equal [{card}]")
    return {"state_gb": nbytes / 1e9, "save_s": save_s,
            "restore_s": restore_s, "free_disk_gb": free / 1e9}


def _resume_exactness(torch, dev) -> dict:
    """Hymba-1.5B at full width cut to RESUME_LAYERS layers: RESUME_STEPS
    steps with a checkpoint every half, then a fresh Trainer restores the
    half-way checkpoint and runs the second half; its losses within rel
    RESUME_TOL of the uninterrupted run's."""
    import dataclasses
    import shutil
    from repro_torch import configs
    from repro_torch.core import DeviceGrid
    from repro_torch.optim import adamw
    from repro_torch.train.step import abstract_train_state
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(configs.get("hymba-1.5b"),
                              n_layers=RESUME_LAYERS,
                              full_attn_layers=(0, RESUME_LAYERS - 1))
    half = RESUME_STEPS // 2
    ckpt_dir = ROOT / "build" / "phase13-resume"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def make():
        return Trainer(cfg, DeviceGrid([dev]), global_batch=RESUME_BATCH,
                       seq=TRAIN_SEQ, hyper=adamw.Hyper(lr=TRAIN_LR),
                       n_microbatches=TRAIN_MICROBATCHES,
                       ckpt_dir=str(ckpt_dir), ckpt_every=half,
                       warmup_steps=TRAIN_WARMUP, total_steps=RESUME_STEPS)

    try:
        a = make()
        full = [h["loss"] for h in a.run(RESUME_STEPS, log_every=0)]
        state_gb = _state_nbytes(a.state) / 1e9
        del a
        b = make()
        b.state = b.ckpt.restore(abstract_train_state(cfg), step=half,
                                 device=dev)
        check(int(b.state["step"]) == half, "resume: wrong checkpoint step")
        resumed = [h["loss"] for h in b.run(RESUME_STEPS, log_every=0)]
        del b
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(len(resumed) == RESUME_STEPS - half, f"resume ran {len(resumed)} "
          "steps")
    rel = max(abs(x - y) / abs(y) for x, y in zip(resumed, full[half:]))
    check(rel <= RESUME_TOL, f"resumed losses {resumed} vs uninterrupted "
          f"{full[half:]}: rel {rel:.3e} over {RESUME_TOL}")
    print(f"  resume exactness (Hymba-1.5B width, {RESUME_LAYERS} layers, "
          f"state {state_gb:.3f} GB, {RESUME_BATCH} x {TRAIN_SEQ}): steps "
          f"{half}-{RESUME_STEPS - 1} resumed from the step-{half} "
          f"checkpoint vs uninterrupted: max rel loss diff {rel:.3e} "
          f"(tol {RESUME_TOL}); losses {[round(x, 6) for x in full]}")
    return {"layers": RESUME_LAYERS, "state_gb": state_gb,
            "losses": full, "resumed": resumed, "max_rel_diff": rel}


def phase_train(torch, dev, card: str) -> dict:
    """13c. Hymba-1.5B at full width and depth trains TRAIN_STEPS steps
    through ``launch/train``'s path (a gang CU on a Pilot): finite and
    falling loss, K3 and the fused backward launched exactly 128 and 64
    times a step and K3-bwd never (counts set to 0 just before, read just
    after), the step time, a
    profiled step, a checkpoint round trip of the whole state, and resume
    exactness at 4 layers."""
    from repro_torch import configs
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tf
    cfg = configs.get("hymba-1.5b")
    n_ssm = sum(s.n_layers for s in tf.build_segments(cfg) if s.ssm)
    print(f"phase 13c: training {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, {cfg.dtype} params, f32 moments, remat) "
          f"through launch.train: batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"{TRAIN_MICROBATCHES} microbatches, {TRAIN_STEPS} steps")
    import gc
    gc.collect()       # an earlier phase's cycles may still hold tensors
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base_gb = torch.cuda.memory_allocated(dev) / 1e9
    # phase 13c's window
    ms_ops.LAUNCHES = ms_ops.SSM_BWD_LAUNCHES = ms_ops.BWD_LAUNCHES = 0
    out = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                microbatches=TRAIN_MICROBATCHES, lr=TRAIN_LR,
                warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
                log_every=1, device=dev)
    torch.cuda.synchronize()
    launches = (ms_ops.LAUNCHES, ms_ops.SSM_BWD_LAUNCHES, ms_ops.BWD_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    hist, trainer = out["history"], out["trainer"]
    from repro_torch.sharding import parallel
    from repro_torch.util import tree_leaves
    mesh = trainer.dmesh
    check(mesh is not None and tuple(mesh.shape) == (1, 1)
          and parallel.is_sharded(trainer.state["params"])
          and all(parallel.is_sharded(trainer.state["opt"][k])
                  for k in ("m", "v")),
          "phase 13c did not train on the plan path (DTensor state on a "
          "1 x 1 DeviceMesh)")
    import torch.distributed as dist
    print(f"  plan path: DeviceMesh {tuple(mesh.mesh_dim_names)} "
          f"{tuple(mesh.shape)} on {mesh.device_type}, backend "
          f"{dist.get_backend(mesh.get_group(0))}, world size "
          f"{dist.get_world_size()}; "
          f"{len(tree_leaves(trainer.state['params']))} param leaves as "
          f"DTensors, plan {trainer.plan.mesh_axes} dp "
          f"{trainer.plan.dp_axes}")
    per_step = (2 * n_ssm * TRAIN_MICROBATCHES, n_ssm * TRAIN_MICROBATCHES, 0)
    check(len(hist) == TRAIN_STEPS, f"trained {len(hist)} steps")
    check(launches == tuple(TRAIN_STEPS * n for n in per_step),
          f"phase 13c launched K3 {launches[0]}, the fused backward "
          f"{launches[1]} and K3-bwd {launches[2]} times, want {per_step} a "
          "step")
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"non-finite loss or grad_norm: {hist}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_ms = 1e3 * statistics.median(h["step_s"] for h in hist[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"  losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}")
    print(f"  {step_ms:.1f} ms a step (median of steps 1-{TRAIN_STEPS - 1}; "
          f"step 0 {1e3 * hist[0]['step_s']:.1f} ms), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB ({base_gb:.2f} GB held before); K3 "
          f"{per_step[0]}, the fused backward "
          f"{per_step[1]} and K3-bwd {per_step[2]} launches a step [{card}]")
    prof = _device_profile(torch, lambda: trainer.run(
        TRAIN_STEPS + 1, log_every=0))
    print(f"  profiled step: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms ({_share(prof['busy_share'])}), "
          f"K3 {prof['k3_device_ms']:.1f} ms ({_share(prof['k3_share'])}), "
          f"fused backward {prof['ssm_bwd_device_ms']:.1f} ms "
          f"({_share(prof['ssm_bwd_share'])}), K3-bwd "
          f"{prof['k3_bwd_device_ms']:.1f} ms of device time [{card}]")
    for key, ms in prof["top_device_ms"]:
        print(f"      device {ms:9.4f} ms  {key}")
    ckpt = _checkpoint_roundtrip(torch, dev, cfg, trainer, card)
    del trainer, out
    torch.cuda.empty_cache()
    resume = _resume_exactness(torch, dev)
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "microbatches": TRAIN_MICROBATCHES,
            "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
            "step_ms": step_ms, "step_ms_all": [1e3 * h["step_s"]
                                                for h in hist],
            "tokens_per_s": tokens / step_ms * 1e3, "peak_memory_gb": peak_gb,
            "memory_before_gb": base_gb,
            "k3_launches": launches[0], "ssm_bwd_launches": launches[1],
            "k3_bwd_launches": launches[2], "profile": prof,
            "checkpoint": ckpt, "resume": resume}


def _op_trace(torch, fn) -> list:
    """(op, checksum) of every op `fn` dispatches that makes a new
    tensor (views and copies of metadata skipped), DTensor outputs read
    through their local tensor."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.sharding import parallel
    skip = ("view", "alias", "detach", "select", "slice", "expand",
            "_to_copy", "t.default", "transpose", "permute", "unsqueeze",
            "squeeze", "split", "chunk", "as_strided", "_unsafe_view")
    out = []

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            name = str(func)
            if not any(k in name for k in skip):
                for r in (res if isinstance(res, (tuple, list)) else (res,)):
                    if isinstance(r, torch.Tensor) and r.is_floating_point():
                        loc = parallel.local(r)
                        out.append((name, float(loc.double().sum())))
            return res

    with Trace():
        fn()
    return out


def phase_plan_vs_plain(torch, dev, card: str, training: dict) -> dict:
    """14a. The plain step (``make_train_step`` on plain tensors, no
    plan) from 13c's initial state on 13c's batches for PLAIN_STEPS
    steps: each step's loss and grad norm against 13c's plan path (rel
    PLAN_TOL), whether bit for bit (and if not, the first op of the
    first microbatch's loss whose output differs), ms a step, tokens/s
    and peak memory beside 13c's."""
    from repro_torch import configs
    from repro_torch.core import DeviceGrid
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw, schedule
    from repro_torch.sharding import Plan, parallel
    from repro_torch.train.step import make_train_state, make_train_step
    from repro_torch.launch import spmd
    cfg = configs.get("hymba-1.5b")
    n_ssm = sum(s.n_layers for s in tf.build_segments(cfg) if s.ssm)
    print(f"phase 14a: the plain step (no plan, plain tensors) against "
          f"13c's plan path, {PLAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} in {TRAIN_MICROBATCHES} microbatches")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base_gb = torch.cuda.memory_allocated(dev) / 1e9

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)  # Trainer's seed
        return make_train_state(cfg, tf.init_params(cfg, gen, device=dev))

    state = init_state()
    step = make_train_step(
        cfg, hyper=adamw.Hyper(lr=TRAIN_LR),
        n_microbatches=TRAIN_MICROBATCHES,
        lr_schedule=lambda s: schedule.warmup_cosine(
            s, warmup=TRAIN_WARMUP, total=TRAIN_STEPS))
    pipe = TokenPipeline(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0,
                         device=dev)
    hist = []
    ms_ops.LAUNCHES = ms_ops.SSM_BWD_LAUNCHES = ms_ops.BWD_LAUNCHES = 0
    for i in range(PLAIN_STEPS):
        batch = pipe.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        m["step_s"] = time.perf_counter() - t0
        hist.append(m)
    launches = (ms_ops.LAUNCHES, ms_ops.SSM_BWD_LAUNCHES, ms_ops.BWD_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    per_step = (2 * n_ssm * TRAIN_MICROBATCHES, n_ssm * TRAIN_MICROBATCHES, 0)
    check(launches == tuple(PLAIN_STEPS * n for n in per_step),
          f"phase 14a launched K3, the fused backward and K3-bwd "
          f"{launches} times, want {per_step} a step")
    del state
    torch.cuda.empty_cache()
    rows, bitwise = [], True
    for i, m in enumerate(hist):
        plan_loss = training["losses"][i]
        plan_gn = training["grad_norms"][i]
        rel = max(abs(m["loss"] - plan_loss) / abs(plan_loss),
                  abs(m["grad_norm"] - plan_gn) / abs(plan_gn))
        same = m["loss"] == plan_loss and m["grad_norm"] == plan_gn
        bitwise = bitwise and same
        rows.append({"step": i, "plain_loss": m["loss"],
                     "plan_loss": plan_loss, "plain_grad_norm": m["grad_norm"],
                     "plan_grad_norm": plan_gn, "max_rel": rel,
                     "bitwise": same})
        check(rel <= PLAN_TOL, f"phase 14a step {i}: plain loss/grad norm "
              f"{m['loss']}/{m['grad_norm']} vs plan {plan_loss}/{plan_gn}: "
              f"rel {rel:.3e} over {PLAN_TOL}")
    first_diff = None
    if not bitwise:
        # the first microbatch's loss, op by op, on both paths
        mb = {k: v[:TRAIN_BATCH // TRAIN_MICROBATCHES]
              for k, v in pipe.batch_at(0).items()}
        plain = init_state()["params"]
        mesh = spmd.local_mesh(DeviceGrid([dev]))
        plan = Plan.for_mesh(mesh)
        placed = parallel.distribute_tree(plain, plan.param_specs(plain),
                                          mesh)
        with torch.no_grad():
            a = _op_trace(torch, lambda: tf.loss_fn(cfg, plain, mb,
                                                    remat=False))
            b = _op_trace(torch, lambda: tf.loss_fn(
                cfg, placed, mb, remat=False, act_spec=plan.act_spec(),
                moe_groups=plan.dp_size))
        del plain, placed
        torch.cuda.empty_cache()
        for j, (x, y) in enumerate(zip(a, b)):
            if x != y:
                first_diff = {"index": j, "plain": x, "plan": y}
                break
        if first_diff is None and len(a) != len(b):
            first_diff = {"index": min(len(a), len(b)),
                          "plain_ops": len(a), "plan_ops": len(b)}
    step_ms = 1e3 * statistics.median(h["step_s"] for h in hist[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    worst = max(r["max_rel"] for r in rows)
    print(f"  per step plain vs plan: "
          + "; ".join(f"{r['plain_loss']:.6f}/{r['plan_loss']:.6f} gnorm "
                      f"{r['plain_grad_norm']:.6f}/{r['plan_grad_norm']:.6f}"
                      for r in rows))
    print(f"  max rel diff {worst:.3e} (tol {PLAN_TOL}); bit for bit: "
          f"{bitwise}" + ("" if first_diff is None else
                          f"; first differing op {first_diff}"))
    print(f"  plain step {step_ms:.1f} ms a step (median of steps 1-"
          f"{PLAIN_STEPS - 1}), {tokens / step_ms * 1e3:.0f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB ({base_gb:.2f} GB held before); plan "
          f"path (13c) {training['step_ms']:.1f} ms a step, "
          f"{training['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{training['peak_memory_gb']:.2f} GB "
          f"({training['memory_before_gb']:.2f} GB held before); plan / plain "
          f"{training['step_ms'] / step_ms:.4f} [{card}]")
    return {"steps": rows, "bitwise": bitwise, "first_diff": first_diff,
            "max_rel": worst, "plain_step_ms": step_ms,
            "plain_step_ms_all": [1e3 * h["step_s"] for h in hist],
            "plain_tokens_per_s": tokens / step_ms * 1e3,
            "plain_peak_memory_gb": peak_gb, "plain_memory_before_gb": base_gb,
            "plan_step_ms": training["step_ms"],
            "plan_tokens_per_s": training["tokens_per_s"],
            "plan_peak_memory_gb": training["peak_memory_gb"],
            "launches_plain": launches}


def phase_ep_combine(torch, dev, card: str) -> dict:
    """14b. One Qwen2-MoE-A2.7B MoE layer at full width in bf16 on the
    1 x 1 mesh: the expert-parallel combine (``ep_axis="model"``)
    against the GSPMD combine, forward and the layer's gradients (each
    within EP_TOL of its max |want|; whether bit for bit), each timed
    (forward + backward, CUDA events)."""
    from repro_torch import configs
    from repro_torch.core import DeviceGrid
    from repro_torch.launch import spmd
    from repro_torch.models.layers import moe
    from repro_torch.sharding import parallel
    cfg = configs.get(EP_ARCH)
    print(f"phase 14b: {cfg.name} MoE layer (d {cfg.d_model}, "
          f"{cfg.moe_n_routed_padded} experts of {cfg.moe_d_ff}, top "
          f"{cfg.moe_top_k}, {cfg.moe_n_shared} shared), 1 x {EP_TOKENS} "
          "tokens in bf16 on the 1 x 1 mesh: EP combine vs GSPMD combine")
    gen = torch.Generator(device=dev).manual_seed(41)
    p = moe.init_moe(cfg, gen)
    x = (torch.randn(1, EP_TOKENS, cfg.d_model, generator=gen, device=dev)
         .to(cfg.param_dtype))
    cot = torch.randn(1, EP_TOKENS, cfg.d_model, generator=gen, device=dev)
    ctx = parallel.Ctx(spmd.local_mesh(DeviceGrid([dev])), ())
    calls = []
    real = moe._combine_ep
    moe._combine_ep = lambda *a: calls.append(1) or real(*a)

    def run(ep_axis):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in p.items() if k != "shared"}
        xi = x.detach().requires_grad_(True)
        out, aux = moe.moe_forward(cfg, {**p, **leaves}, xi, ep_axis=ep_axis,
                                   ctx=ctx)
        grads = torch.autograd.grad((out.float() * cot).sum() + aux,
                                    [xi, *leaves.values()])
        return [out, aux, *grads]

    try:
        want = run(None)
        got = run("model")
        check(calls == [1], f"phase 14b: EP combine ran {len(calls)} times")
        ms = {k: cuda_ms(torch, lambda k=k: run(k), reps=EP_REPS)
              for k in (None, "model")}
    finally:
        moe._combine_ep = real
    names = ["out", "aux", "dx", *[f"d{k}" for k in p if k != "shared"]]
    errs, bitwise = {}, True
    for name, g, w in zip(names, got, want):
        g, w = g.detach(), w.detach()
        scale = max(float(w.float().abs().max()), 1e-30)
        errs[name] = float((g.float() - w.float()).abs().max()) / scale
        bitwise = bitwise and torch.equal(g, w)
        check(errs[name] <= EP_TOL, f"phase 14b {name}: rel {errs[name]:.3e}"
              f" over {EP_TOL}")
    print(f"  EP vs GSPMD max |err| / max |want|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {EP_TOL}); bit for bit: {bitwise}")
    print(f"  forward + backward: GSPMD {ms[None]:.3f} ms, EP "
          f"{ms['model']:.3f} ms (mean of {EP_REPS} after 3 warm-ups) "
          f"[{card}]")
    return {"errors": errs, "bitwise": bitwise, "gspmd_ms": ms[None],
            "ep_ms": ms["model"]}


def phase_hybrid(torch, dev) -> dict:
    """13d. The paper's simulate -> analyze -> train DAG
    (``examples/torch_hybrid_pipeline.py``) on the card: a Session over
    pilots ``hpc`` and ``ana`` on ``[dev] * 2``, Hymba-1.5B at full width
    training in ``simulate`` (K3, the fused backward; K3-bwd never),
    K-Means with K1 in every ``analyze``."""
    import importlib.util
    from repro_torch import configs
    from repro_torch.kernels.kmeans import ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import transformer as tf
    spec = importlib.util.spec_from_file_location(
        "torch_hybrid_pipeline", ROOT / "examples" / "torch_hybrid_pipeline.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = configs.get("hymba-1.5b")
    n_ssm = sum(s.n_layers for s in tf.build_segments(cfg) if s.ssm)
    print(f"phase 13d: the hybrid pipeline ({cfg.name} full width, "
          f"{HYBRID_BATCH} x {HYBRID_SEQ}, {HYBRID_ROUNDS} rounds x "
          f"{HYBRID_STEPS} steps) on [dev] * 2")
    k1 = []

    def counted(run):
        before = ops.LAUNCHES
        res = run()
        k1.append(ops.LAUNCHES - before)
        return res

    # phase 13d's window
    ms_ops.LAUNCHES = ms_ops.SSM_BWD_LAUNCHES = ms_ops.BWD_LAUNCHES = 0
    session = example.make_session(dev)
    t0 = time.perf_counter()
    try:
        rounds = example.run_pipeline(
            session, cfg, rounds=HYBRID_ROUNDS, batch=HYBRID_BATCH,
            seq=HYBRID_SEQ, steps_per_round=HYBRID_STEPS, on_analyze=counted)
    finally:
        session.shutdown()
    wall = time.perf_counter() - t0
    launches = (ms_ops.LAUNCHES, ms_ops.SSM_BWD_LAUNCHES, ms_ops.BWD_LAUNCHES)
    # each round: HYBRID_STEPS steps (forward + remat recompute + backward)
    # and one probe forward without grad
    want = (HYBRID_ROUNDS * n_ssm * (2 * HYBRID_STEPS + 1),
            HYBRID_ROUNDS * n_ssm * HYBRID_STEPS, 0)
    check(launches == want, f"phase 13d: K3 {launches[0]}, fused backward "
          f"{launches[1]}, K3-bwd {launches[2]} launches, want {want}")
    check(len(k1) == HYBRID_ROUNDS and all(n > 0 for n in k1),
          f"phase 13d: K1 launches per analyze {k1}")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["cost"])
              for r in rounds), f"phase 13d: {rounds}")
    print(f"  K3 {launches[0]}, fused backward {launches[1]}, K3-bwd "
          f"{launches[2]}, K1 per analyze {k1}; wall {wall:.3f} s")
    print("pipeline complete.")
    return {"rounds": rounds, "k3_launches": launches[0],
            "ssm_bwd_launches": launches[1], "k3_bwd_launches": launches[2],
            "k1_per_analyze": k1, "wall_s": wall}


def phase_analytic(torch, dev, card: str, training: dict,
                   serving: dict) -> dict:
    """15a. The analytic step cost of 13c's step and of 11b's Hymba-1.5B
    prefill and decode step beside the walls measured there (one card:
    n_devices 1, tp 1): roofline terms on the H100's ``HW``, model FLOP
    utilisation and the estimate's error ratio; then FlopCounterMode
    over one forward of 11a's 3-layer Hymba-1.5B on the card against
    ``analytic.forward_flops``."""
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ShapeConfig
    from repro_torch.roofline import HW, analytic, estimate_error
    from repro_torch.roofline import roofline_terms
    hw = HW()
    arch, B, S, new = SERVE_MODELS[0]
    cfg = configs.get(arch)
    serve = serving[arch]
    print(f"phase 15a: analytic step costs of {cfg.name} beside the measured "
          f"walls (n_devices 1, tp 1; peak {hw.peak_flops:.4g} FLOP/s, HBM "
          f"{hw.hbm_bw:.4g} B/s) [{card}]")
    cells = (("13c train step",
              ShapeConfig("13c", TRAIN_SEQ, TRAIN_BATCH, "train"),
              TRAIN_MICROBATCHES, training["step_ms"]),
             ("11b prefill", ShapeConfig("11b-prefill", S, B, "prefill"), 1,
              serve["prefill_ms"]),
             # the decode step reads a cache of S + new + 1 slots
             ("11b decode step",
              ShapeConfig("11b-decode", S + new + 1, B, "decode"), 1,
              serve["decode_ms_per_token"]))
    rows = {}
    for label, shape, n_mb, wall_ms in cells:
        cost = analytic.step_cost(cfg, shape, n_devices=1, tp=1,
                                  n_microbatches=n_mb)
        terms = roofline_terms(
            flops_global=cost.flops, hbm_bytes_global=cost.hbm_bytes,
            collective_bytes_per_device=0.0, n_chips=1,
            model_flops=cost.model_flops, hw=hw)
        wall_s = wall_ms / 1e3
        est_s = max(terms["compute_s"], terms["memory_s"])
        mfu = cost.model_flops / (wall_s * hw.peak_flops)
        ratio = estimate_error(est_s, wall_s)
        check(cost.flops > 0 and cost.hbm_bytes > 0 and cost.model_flops > 0
              and math.isfinite(mfu) and 0 < mfu < 1 and ratio is not None,
              f"phase 15a {label}: cost {cost}, mfu {mfu}, ratio {ratio}")
        rows[label] = {"batch": shape.global_batch, "seq": shape.seq_len,
                       "n_microbatches": n_mb, "flops": cost.flops,
                       "hbm_bytes": cost.hbm_bytes,
                       "model_flops": cost.model_flops, "terms": terms,
                       "est_s": est_s, "wall_s": wall_s, "mfu": mfu,
                       "est_error_ratio": ratio}
        print(f"  {label} ({shape.global_batch} x {shape.seq_len}, "
              f"{n_mb} microbatches): flops {cost.flops:.6e}, hbm_bytes "
              f"{cost.hbm_bytes:.6e}, model_flops {cost.model_flops:.6e}; "
              f"compute {1e3 * terms['compute_s']:.4f} ms, memory "
              f"{1e3 * terms['memory_s']:.4f} ms ({terms['dominant']}); "
              f"wall {wall_ms:.4f} ms; model FLOP utilisation "
              f"{100 * mfu:.4f} %; est_error_ratio {ratio:.4f} [{card}]")

    cfg3 = dataclasses.replace(cfg, n_layers=3, full_attn_layers=(0, 2),
                               dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(15)
    params = tf.init_params(cfg3, gen, device=dev)
    tokens = torch.randint(0, cfg3.vocab_size, (1, PARITY_S), generator=gen,
                           device=dev, dtype=torch.int32)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        logits, _ = tf.forward(cfg3, params, {"tokens": tokens})
        torch.cuda.synchronize()
    counted = counter.get_total_flops()
    want = analytic.forward_flops(cfg3, 1, PARITY_S)
    flop_ratio = want / counted
    check(bool(torch.isfinite(logits).all()), "phase 15a: non-finite logits")
    check(FLOP_RATIO[0] < flop_ratio < FLOP_RATIO[1],
          f"phase 15a: analytic/counted forward FLOPs {flop_ratio:.4f}, "
          f"want within {FLOP_RATIO}")
    del params, logits
    torch.cuda.empty_cache()
    print(f"  3-layer {cfg.name} forward at 1 x {PARITY_S} (f32): "
          f"FlopCounterMode {counted:.6e} FLOPs, analytic {want:.6e}, "
          f"analytic/counted {flop_ratio:.4f} (within {FLOP_RATIO})")
    return {"cells": rows, "forward_flops_counted": counted,
            "forward_flops_analytic": want, "forward_flop_ratio": flop_ratio}


def phase_stage_cost(torch, dev, card: str) -> dict:
    """15b. A Session train stage (Hymba-1.5B at 13d's HYBRID_BATCH x
    HYBRID_SEQ, STAGE_STEPS steps from a fresh Trainer) carrying
    ``StageCost.from_model``'s step cost times its steps: where it is
    placed, the placement's estimate, actual runtime and their ratio,
    and the pilot's estimate drift."""
    from repro_torch import configs
    from repro_torch.core import (PilotDescription, ResourceManager,
                                  Session, hpc_stage)
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.models.config import ShapeConfig
    from repro_torch.roofline import StageCost
    from repro_torch.train.trainer import Trainer
    cfg = configs.get("hymba-1.5b")
    step = StageCost.from_model(
        cfg, ShapeConfig("15b", HYBRID_SEQ, HYBRID_BATCH, "train"),
        n_devices=1, tp=1)
    cost = StageCost(flops=STAGE_STEPS * step.flops,
                     hbm_bytes=STAGE_STEPS * step.hbm_bytes)
    print(f"phase 15b: a Session train stage ({cfg.name}, {HYBRID_BATCH} x "
          f"{HYBRID_SEQ}, {STAGE_STEPS} steps of a fresh Trainer) carrying "
          f"StageCost.from_model: flops {cost.flops:.6e}, hbm_bytes "
          f"{cost.hbm_bytes:.6e}")
    session = Session(ResourceManager(devices=[dev] * 2))
    session.add_pilot(PilotDescription(n_chips=1, name="hpc", runtime="hpc"))
    session.add_pilot(PilotDescription(n_chips=1, name="ana",
                                       runtime="analytics"))

    def train(mesh=None):
        tr = Trainer(cfg, mesh, global_batch=HYBRID_BATCH, seq=HYBRID_SEQ)
        return {"loss": tr.run(STAGE_STEPS, log_every=0)[-1]["loss"]}

    try:
        session.run([hpc_stage("train", train, outputs=("loss",),
                               cost=cost)])
        place = dict(session.placements["train"])
        drift = ControlPlane.estimate_drift(
            session.pilots[place["pilot"]].agent.heartbeat())
        loss = float(session.results["train"]["loss"])
    finally:
        session.shutdown()
    torch.cuda.empty_cache()
    check(math.isfinite(loss), f"phase 15b: loss {loss}")
    check(place.get("est_runtime_s", 0) > 0
          and place.get("actual_runtime_s", 0) > 0
          and place.get("est_error_ratio") is not None,
          f"phase 15b: placement {place}")
    print(f"  placed on {place['pilot']} ({place['chosen']['bound']}-bound): "
          f"est_runtime_s {place['est_runtime_s']:.6f}, actual_runtime_s "
          f"{place['actual_runtime_s']:.6f}, est_error_ratio "
          f"{place['est_error_ratio']:.4f}, est_drift {drift}; loss "
          f"{loss:.6f} [{card}]")
    return {"pilot": place["pilot"], "bound": place["chosen"]["bound"],
            "flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
            "est_runtime_s": place["est_runtime_s"],
            "actual_runtime_s": place["actual_runtime_s"],
            "est_error_ratio": place["est_error_ratio"], "est_drift": drift,
            "loss": loss}


DRYRUN_KEYS = ("memory", "cost_analysis", "collectives", "analytic",
               "params_bytes_per_device", "state_bytes_per_device",
               "analytic_peak_bytes_per_device", "n_microbatches",
               "fits_hbm_analytic", "terms", "trace_s", "torch_version",
               "kernel_launches")
DRYRUN_SERVE_KEYS = ("memory", "cost_analysis", "collectives", "analytic",
                     "params_bytes_per_device", "cache_bytes_per_device",
                     "analytic_peak_bytes_per_device", "fits_hbm_analytic",
                     "terms", "trace_s", "torch_version", "kernel_launches")


def phase_dryrun(card: str) -> dict:
    """15c and 16b. ``python -m repro_torch.launch.dryrun --device cuda``
    on DRYRUN_CELL's shapes in one subprocess.  15c, the train cell: its
    record's keys, collective bytes, the analytic fit in 80 GB, traced
    FLOPs against the analytic count and its own kernel counts (0).  16b,
    the decode cell on the sharded serving step: its keys, collective
    bytes, 0 launches, and the traced peak a device beside the analytic
    one and the bytes of the whole weights (what each rank held when the
    serving cells gathered them)."""
    from repro_torch import configs
    from repro_torch.core.resource_manager import HBM_BYTES_PER_CHIP
    arch, shapes = DRYRUN_CELL
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    recs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--mesh", "single", "--device", "cuda", "--out",
               out_dir]
        for shape in shapes:
            cmd += ["--shape", shape]
        try:
            # subprocess.run kills the child when the timeout expires
            proc = subprocess.run(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired as e:
            check(False, f"phase 15c/16b {arch} x {shapes}: over "
                  f"{DRYRUN_TIMEOUT} s; {str(e.output)[-2000:]}")
        check(proc.returncode == 0, f"phase 15c/16b {arch} x {shapes}: exit "
              f"{proc.returncode}; {proc.stdout[-3000:]}")
        for shape in shapes:
            with open(os.path.join(out_dir,
                                   f"{arch}__{shape}__single.json")) as f:
                recs[shape] = json.load(f)
    wall = time.perf_counter() - t0
    out = {}
    for shape, rec in recs.items():
        phase = "15c" if rec["kind"] == "train" else "16b"
        keys = DRYRUN_KEYS if rec["kind"] == "train" else DRYRUN_SERVE_KEYS
        missing = [k for k in keys if k not in rec]
        check(not missing, f"phase {phase} {arch} x {shape}: keys {missing} "
              "missing")
        check(rec["collectives"]["total"] > 0,
              f"phase {phase} {arch} x {shape}: no collective bytes")
        check(not any(rec["kernel_launches"].values()),
              f"phase {phase} {arch} x {shape}: kernels launched "
              f"{rec['kernel_launches']}")
        peak = rec["analytic_peak_bytes_per_device"]
        check(rec["fits_hbm_analytic"] == (peak < HBM_BYTES_PER_CHIP),
              f"phase {phase} {arch}: fits_hbm_analytic "
              f"{rec['fits_hbm_analytic']} at {peak} B")
        flops_ratio = (rec["cost_analysis"]["flops_per_device"]
                       / (rec["analytic"]["flops"] / rec["n_devices"]))
        traced = rec["memory"]["peak_bytes_per_device"]
        summary = {"cell": f"{arch} x {shape}", "trace_s": rec["trace_s"],
                   "peak_bytes_per_device": traced,
                   "analytic_peak_bytes_per_device": peak,
                   "fits_hbm_analytic": rec["fits_hbm_analytic"],
                   "collectives": rec["collectives"],
                   "flops_per_device": rec["cost_analysis"][
                       "flops_per_device"],
                   "traced_over_analytic_flops": flops_ratio,
                   "terms": rec["terms"],
                   "torch_version": rec["torch_version"],
                   "kernel_launches": rec["kernel_launches"]}
        if rec["kind"] == "train":
            check(FLOP_RATIO[0] < flops_ratio < FLOP_RATIO[1],
                  f"phase 15c {arch}: traced/analytic FLOPs {flops_ratio}")
            print(f"  15c {arch} x {shape} on a fake (16, 16) group, fake "
                  f"cuda tensors, torch {rec['torch_version']}: trace "
                  f"{rec['trace_s']:.3f} s, traced peak "
                  f"{traced / 1e9:.4f} GB a device, analytic "
                  f"{peak / 1e9:.4f} GB (fits 80 GB: "
                  f"{rec['fits_hbm_analytic']}), collectives "
                  f"{rec['collectives']['total']:.6e} B a device, "
                  f"traced/analytic FLOPs {flops_ratio:.4f}, "
                  f"{rec.get('n_microbatches')} microbatches, kernel "
                  f"launches {rec['kernel_launches']} [{card}]")
            out.update(summary, n_microbatches=rec.get("n_microbatches"))
            continue
        weights = configs.get(arch).n_params() * 2     # bf16, whole
        print(f"  16b {arch} x {shape} (sharded decode step, serving plan) "
              f"on a fake (16, 16) group, fake cuda tensors: trace "
              f"{rec['trace_s']:.3f} s, traced peak {traced / 1e9:.4f} GB "
              f"a device (argument "
              f"{rec['memory']['argument_bytes'] / 1e9:.4f} GB), analytic "
              f"{peak / 1e9:.4f} GB, the whole weights "
              f"{weights / 1e9:.4f} GB; params "
              f"{rec['params_bytes_per_device'] / 1e9:.4f} GB and caches "
              f"{rec['cache_bytes_per_device'] / 1e9:.4f} GB a device; "
              f"collectives {rec['collectives']['total']:.6e} B a device "
              f"(all-gather {rec['collectives']['all-gather']:.6e}); "
              f"traced/analytic FLOPs {flops_ratio:.4f}; kernel launches "
              f"{rec['kernel_launches']} [{card}]")
        out["decode"] = summary | {
            "argument_bytes": rec["memory"]["argument_bytes"],
            "params_bytes_per_device": rec["params_bytes_per_device"],
            "cache_bytes_per_device": rec["cache_bytes_per_device"],
            "whole_weights_bytes": weights}
    out["wall_s"] = wall
    print(f"  15c/16b subprocess: {wall:.3f} s")
    return out


def phase_save_tp_out(torch, dev, card: str, training: dict) -> dict:
    """15d. 13c's plan path (a Trainer on the one-card grid, 13c's seed,
    batches and schedule) for SAVE_TP_STEPS steps with the
    ``save_tp_out`` remat policy: losses and grad norms against 13c's
    first steps (rel SAVE_TP_TOL; whether bit for bit), K3 and the fused
    backward launched exactly as in 13c, ms a step and peak memory."""
    from repro_torch import configs
    from repro_torch.core import DeviceGrid
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer
    cfg = configs.get("hymba-1.5b")
    n_ssm = sum(s.n_layers for s in tf.build_segments(cfg) if s.ssm)
    print(f"phase 15d: 13c's plan path with remat_policy='save_tp_out', "
          f"{SAVE_TP_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} in "
          f"{TRAIN_MICROBATCHES} microbatches")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base_gb = torch.cuda.memory_allocated(dev) / 1e9
    trainer = Trainer(cfg, DeviceGrid([dev]), global_batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, hyper=adamw.Hyper(lr=TRAIN_LR),
                      n_microbatches=TRAIN_MICROBATCHES,
                      warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
                      remat_policy="save_tp_out")
    ms_ops.LAUNCHES = ms_ops.SSM_BWD_LAUNCHES = ms_ops.BWD_LAUNCHES = 0
    hist = trainer.run(SAVE_TP_STEPS, log_every=0)    # phase 15d's window
    torch.cuda.synchronize()
    launches = (ms_ops.LAUNCHES, ms_ops.SSM_BWD_LAUNCHES, ms_ops.BWD_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del trainer
    torch.cuda.empty_cache()
    per_step = (2 * n_ssm * TRAIN_MICROBATCHES, n_ssm * TRAIN_MICROBATCHES, 0)
    check(launches == tuple(SAVE_TP_STEPS * n for n in per_step),
          f"phase 15d launched K3, the fused backward and K3-bwd {launches} "
          f"times, want {per_step} a step")
    rows, bitwise = [], True
    for i, h in enumerate(hist):
        want_loss, want_gn = training["losses"][i], training["grad_norms"][i]
        rel = max(abs(h["loss"] - want_loss) / abs(want_loss),
                  abs(h["grad_norm"] - want_gn) / abs(want_gn))
        same = h["loss"] == want_loss and h["grad_norm"] == want_gn
        bitwise = bitwise and same
        rows.append({"step": i, "loss": h["loss"], "plan_loss": want_loss,
                     "grad_norm": h["grad_norm"], "plan_grad_norm": want_gn,
                     "max_rel": rel, "bitwise": same})
        check(rel <= SAVE_TP_TOL, f"phase 15d step {i}: loss/grad norm "
              f"{h['loss']}/{h['grad_norm']} vs 13c {want_loss}/{want_gn}: "
              f"rel {rel:.3e} over {SAVE_TP_TOL}")
    step_ms = [1e3 * h["step_s"] for h in hist]
    print(f"  per step save_tp_out vs 13c: "
          + "; ".join(f"{r['loss']:.6f}/{r['plan_loss']:.6f} gnorm "
                      f"{r['grad_norm']:.6f}/{r['plan_grad_norm']:.6f}"
                      for r in rows)
          + f"; bit for bit: {bitwise}")
    print(f"  {step_ms[-1]:.1f} ms the last step (step 0 {step_ms[0]:.1f} "
          f"ms; 13c {training['step_ms']:.1f} ms a step), peak memory "
          f"{peak_gb:.2f} GB ({base_gb:.2f} GB held before; 13c "
          f"{training['peak_memory_gb']:.2f} GB); K3 {per_step[0]}, the "
          f"fused backward {per_step[1]} and K3-bwd {per_step[2]} launches "
          f"a step [{card}]")
    return {"steps": rows, "bitwise": bitwise, "step_ms_all": step_ms,
            "peak_memory_gb": peak_gb, "memory_before_gb": base_gb,
            "launches": launches}


def _rel_err(torch, got, want) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale or 1.0)


def phase_serve_sharded(torch, dev, card: str, plain: dict) -> dict:
    """16a. 11b's first model (Hymba-1.5B, full width and depth, bf16, the
    same seed, prompts and greedy steps) through the same serving steps
    on DTensor params placed by the weight-stationary serving plan
    (``Plan(serving=True)``) on a 1 x 1 ``DeviceMesh``, caches placed by
    ``Plan.cache_specs`` (``init_caches(mesh=)``): the prefill's logits
    and caches and every step's logits against 11b's plain run (`plain`,
    its record with the outputs it kept; bit for bit, else within
    SHARDED_TOL), the greedy tokens equal, K3 once per SSM layer a
    prefill and never in decode, and the prefill wall and peak memory
    beside 11b's.  The decode steps alternate with plain ones (the plain
    params, copies of the same caches), so that both meet one host's
    load: the plan path's host cost a step."""
    from repro_torch import configs
    from repro_torch.core import DeviceGrid
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.launch import spmd
    from repro_torch.models import transformer as tf
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.sharding import Plan, parallel
    from repro_torch.util import tree_leaves
    import dataclasses
    arch, B, S, new = SERVE_MODELS[0]
    want = plain.pop("_outputs")
    cfg = configs.get(arch)
    n_ssm = sum(s.n_layers for s in tf.build_segments(cfg) if s.ssm)
    print(f"phase 16a: {arch} (full width and depth, {cfg.dtype}) on the "
          f"serving plan at one rank: DTensor params on a 1 x 1 DeviceMesh, "
          f"{B} x {S} prompts, {new} greedy tokens")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(12)     # 11b's seed
    params = tf.init_params(cfg, gen, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device=dev, dtype=torch.int32)}
    mesh = spmd.local_mesh(DeviceGrid([dev], tp=1))
    plan = dataclasses.replace(Plan.for_mesh(mesh), serving=True)
    plain_params = params         # at one rank the DTensors wrap these
    params = parallel.distribute_tree(params, plan.param_specs(params), mesh)
    check(all(isinstance(t, parallel.DTensor) for t in tree_leaves(params)),
          "phase 16a: a param is not a DTensor")
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg, sample=True)
    V = cfg.vocab_size

    def timed(fn, want_k3: int, label: str):
        before = ms_ops.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check(ms_ops.LAUNCHES - before == want_k3,
              f"phase 16a {label}: {ms_ops.LAUNCHES - before} K3 launches, "
              f"want {want_k3}")
        return out, ms

    prefill_ms = []
    for _ in range(PREFILL_REPS):
        (caches, logits), ms = timed(lambda: prefill(params, batch), n_ssm,
                                     "prefill")
        prefill_ms.append(ms)
    check(isinstance(logits, parallel.DTensor)
          and all(isinstance(t, parallel.DTensor)
                  for t in tree_leaves(caches)),
          "phase 16a: the sharded prefill returned plain tensors")
    errs = {"prefill_logits": _rel_err(torch, logits.full_tensor().cpu(),
                                       want["prefill_logits"])}
    bitwise = {"prefill_logits": torch.equal(logits.full_tensor().cpu(),
                                             want["prefill_logits"])}
    cache_eq, cache_err = True, 0.0
    for got_c, want_c in zip(caches, want["prefill_caches"]):
        for k, w in want_c.items():
            g = got_c[k].full_tensor().cpu()
            cache_eq &= torch.equal(g, w)
            cache_err = max(cache_err, _rel_err(torch, g, w))
    errs["prefill_caches"], bitwise["prefill_caches"] = cache_err, cache_eq
    # the plain steps' caches: copies of the same prefill's, so that plan
    # and plain decode steps alternate under one host's load
    plain_dec = tf.grow_caches(
        [{k: parallel.local(v).clone() for k, v in c.items()}
         for c in caches], tf.init_caches(cfg, B, S + new + 1, device=dev))
    dec = tf.grow_caches(caches, tf.init_caches(cfg, B, S + new + 1,
                                                device=dev, mesh=mesh))
    tok = logits.full_tensor()[:, -1, :V].argmax(-1).to(torch.int32)[:, None]
    plain_tok = tok
    out, step_ms, plain_ms, step_eq, step_err = [tok], [], [], True, 0.0
    for t in range(new + 1):
        pos = torch.full((B,), S + t, dtype=torch.int32, device=dev)
        (dec, lg, tok), ms = timed(lambda: decode(params, dec, tok, pos), 0,
                                   f"decode step {t}")
        (plain_dec, _, plain_tok), p_ms = timed(
            lambda: decode(plain_params, plain_dec, plain_tok, pos), 0,
            f"plain decode step {t}")
        if t < new:
            step_ms.append(ms)
            plain_ms.append(p_ms)
        g = lg.full_tensor().cpu()
        step_eq &= torch.equal(g, want["logits"][t])
        step_err = max(step_err, _rel_err(torch, g, want["logits"][t]))
        tok = tok.full_tensor()
        check(torch.equal(tok, plain_tok),
              f"phase 16a step {t}: plan and plain tokens differ")
        out.append(tok)
    errs["decode_logits"], bitwise["decode_logits"] = step_err, step_eq
    tokens = torch.cat(out, dim=1).cpu()
    check(torch.equal(tokens, want["tokens"]),
          f"phase 16a: greedy tokens differ from 11b's: {tokens[0, :12]} vs "
          f"{want['tokens'][0, :12]}")
    worst = max(errs.values())
    check(all(bitwise.values()) or worst <= SHARDED_TOL,
          f"phase 16a: against 11b's plain run, max rel err {errs}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    timed_pre = prefill_ms[1:]
    rec = {"arch": arch, "B": B, "S": S, "new_tokens": new,
           "prefill_ms": statistics.median(timed_pre),
           "prefill_ms_all": prefill_ms,
           "prefill_ms_plain": plain["prefill_ms"],
           "decode_ms_per_token": statistics.median(step_ms),
           "decode_ms_all": step_ms,
           "decode_ms_per_token_plain": statistics.median(plain_ms),
           "decode_ms_plain_all": plain_ms,
           "decode_ms_per_token_11b": plain["decode_ms_per_token"],
           "peak_memory_gb": peak, "peak_memory_gb_plain":
               plain["peak_memory_gb"],
           "bitwise": bitwise, "max_rel_err": errs,
           "k3_launches_per_prefill": n_ssm}
    host = rec["decode_ms_per_token"] - rec["decode_ms_per_token_plain"]
    print(f"  16a plan / plain (11b): prefill {rec['prefill_ms']:.3f} / "
          f"{plain['prefill_ms']:.3f} ms (median of {len(timed_pre)}; first "
          f"{prefill_ms[0]:.3f}); decode, plan and plain steps alternating: "
          f"{rec['decode_ms_per_token']:.3f} / "
          f"{rec['decode_ms_per_token_plain']:.3f} ms a step of {B} tokens "
          f"(medians of {new}; the plan path's host cost {host:+.3f} ms; "
          f"11b's plain {plain['decode_ms_per_token']:.3f}), peak "
          f"{peak:.2f} / {plain['peak_memory_gb']:.2f} GB; "
          f"bit for bit {bitwise}, max rel err {errs}; tokens equal 11b's; "
          f"K3 {n_ssm} a prefill, 0 a decode step [{card}]")
    return rec


def phase_quickstart(card: str) -> dict:
    """17a. ``examples/torch_quickstart.py`` with no device flag in a
    subprocess: its pilot lands on the card, and the values it prints are
    the reference quickstart's (the eight map results, the HPC stage at
    ``.3e``, the Mode-I map_reduce sum)."""
    print("phase 17a: examples/torch_quickstart.py on the card")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=QUICKSTART_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        check(False, f"17a: over {QUICKSTART_TIMEOUT} s; "
              f"{str(e.output)[-2000:]}")
    wall = time.perf_counter() - t0
    out = proc.stdout
    check(proc.returncode == 0, f"17a: exit {proc.returncode}; {out[-3000:]}")
    patterns = {
        "pilot": r"ACTIVE on 1 chip\(s\) \((\w+)\) in ([\d.]+) ms",
        "maps": r"\[2\] map results: (\[.*\])",
        "hpc": r"\[3\] HPC stage -> (\S+) \(CU overhead ([\d.]+) ms\)",
        "sum": r"\(spawn ([\d.]+) ms\) map_reduce sum = (\d+)"}
    found = {key: re.search(p, out) for key, p in patterns.items()}
    check(all(found.values()) and out.rstrip().endswith("done."),
          f"17a: unexpected output: {out[-2000:]}")
    want = (str([i * i for i in range(8)]),
            f"{sum(i * i for i in range(1024)):.3e}", "8386560")
    got = (found["maps"][1], found["hpc"][1], found["sum"][2])
    check(found["pilot"][1] == "gpu", f"17a: the pilot is on "
          f"{found['pilot'][1]}, not the card")
    check(got == want, f"17a: printed {got}, want {want}")
    rec = {"platform": found["pilot"][1],
           "pilot_startup_ms": float(found["pilot"][2]),
           "cu_overhead_ms": float(found["hpc"][2]),
           "mode1_spawn_ms": float(found["sum"][1]),
           "maps": got[0], "hpc": got[1], "map_reduce_sum": got[2],
           "subprocess_s": wall}
    print(f"  quickstart on the {rec['platform']}: maps {got[0]}, HPC "
          f"{got[1]}, sum {got[2]} (the reference's values); pilot startup "
          f"{rec['pilot_startup_ms']} ms, CU overhead "
          f"{rec['cu_overhead_ms']} ms, Mode-I spawn "
          f"{rec['mode1_spawn_ms']} ms; subprocess {wall:.3f} s [{card}]")
    return rec


def wait_for(cond, what: str, timeout: float = ELASTIC_TIMEOUT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"17b: no {what} after "
              f"{timeout} s")
        time.sleep(0.001)


def lease_conflicts(events: list) -> list:
    """Replays a ResourceManager's lease log: every grant of a slot some
    pilot still holds, and every reclaim or release by a non-holder."""
    held, bad = {}, []
    for e in events:
        for i in e["indices"]:
            if e["event"] == "grant":
                if i in held:
                    bad.append((e["event"], e["pilot"], i, held[i]))
                held[i] = e["pilot"]
            elif e["event"] in ("reclaim", "release"):
                if held.get(i) != e["pilot"]:
                    bad.append((e["event"], e["pilot"], i, held.get(i)))
                held.pop(i, None)
            else:
                held.pop(i, None)
    return bad


def phase_elastic(torch, dev, km, ops, card: str) -> dict:
    """17b. The paper's Fig-6 K-Means CUs under elastic multi-tenant
    scheduling: one pilot of ELASTIC_SLOTS lease slots on the card, DRF
    over three tenant queues (weights 1, 1, 2; each capped at
    ELASTIC_CAP chips), ELASTIC_CUS CUs a tenant of ``kmeans_fit`` with
    K1 at 100k x 500, d 3, each staging its draw from the GFS archive
    through the pilot's Prefetcher.  With the first wave running, the
    ControlPlane shrinks the pilot by ELASTIC_SHRINK slots (drain with
    preemption: the CUs there are cloned onto the survivors), and once
    the clones run, grows it back.  K1's counts are set to 0 just before
    the CUs are submitted and read once all of them are done."""
    from repro_torch.analytics.engine import AnalyticsEngine
    from repro_torch.core import (ComputeUnit, ComputeUnitDescription,
                                  CUState, DataPlane, DataRef, DeviceGrid,
                                  DrfPolicy, GFS_ARCHIVE, Link,
                                  PilotDescription, PilotManager,
                                  QueueConfig, ResourceManager, place,
                                  replicated_sharding)
    n, k = km.PAPER_SCENARIOS[ELASTIC_SCENARIO]
    print(f"phase 17b: {len(ELASTIC_TENANTS)} tenants x {ELASTIC_CUS} "
          f"K-Means CUs ({n} x {k}, d {km.PAPER_DIM}) under DRF on "
          f"{ELASTIC_SLOTS} slots, shrink by {ELASTIC_SHRINK} and grow back")
    draws = [km.make_dataset(n, km.PAPER_DIM, seed=ELASTIC_SEED + j,
                             device=dev) for j in range(ELASTIC_CUS)]
    # each tenant submits its CUs in two halves: the first before the
    # shrink, the second once the shrink is done (CU j reads draw j)
    half = ELASTIC_CUS // 2
    jobs = [(tenant, j, ELASTIC_SEED + 10 * t + j)
            for wave in (range(half), range(half, ELASTIC_CUS))
            for t, (tenant, _) in enumerate(ELASTIC_TENANTS) for j in wave]
    n_first = len(ELASTIC_TENANTS) * half
    # each CU's fit alone, outside the counting window
    solo, per_fit = {}, set()
    for tenant, j, seed in jobs:
        eng = AnalyticsEngine(DeviceGrid([dev]), DataPlane())
        eng.put("pts", draws[j])
        before = (ops.LAUNCHES, ops.MERGE_LAUNCHES)
        solo[seed] = km.kmeans_fit(eng, "pts", k, iters=ITERS,
                                   use_kernel=True, seed=seed)
        per_fit.add((ops.LAUNCHES - before[0],
                     ops.MERGE_LAUNCHES - before[1]))
    torch.cuda.synchronize()
    check(len(per_fit) == 1 and next(iter(per_fit))[0] == ITERS,
          f"17b: solo fits launched K1 {per_fit} (scan, merge) times")
    (scan_per_fit, merge_per_fit), = per_fit

    pm = PilotManager(ResourceManager(
        devices=[dev] * (ELASTIC_SLOTS + ELASTIC_RESERVE)),
        drain_preempt_after_s=0.0)
    data = DataPlane()
    lock = threading.Lock()
    gate = threading.Event()
    started, invocations, finished, binds, charges = [], [], [], [], []
    try:
        # the CUs wait for their stage-in to land: no remote reads
        pilot = pm.submit(PilotDescription(
            n_chips=ELASTIC_SLOTS, name="kmeans", enable_speculation=False,
            scheduler_policy=DrfPolicy(), staging_delay_rounds=10_000,
            queues=[QueueConfig(t, weight=w, max_chips=ELASTIC_CAP)
                    for t, w in ELASTIC_TENANTS]), data_registry=data)
        reserve = pm.submit(PilotDescription(
            n_chips=ELASTIC_RESERVE, name="reserve",
            enable_speculation=False))
        for j, pts in enumerate(draws):
            data.put(f"pts{j}", place(pts, replicated_sharding([dev])),
                     pilot=GFS_ARCHIVE)
        ds_bytes = sum(data.get(f"pts{j}").nbytes for j in range(len(draws)))
        sched = pilot.agent.scheduler
        # record every bind, and each queue's charged chips at every charge
        bind_round, charge = sched.schedule_round, sched.queues.charge

        def logged_round():
            out = bind_round()
            binds.extend((cu.uid, cu.desc.queue, list(idxs))
                         for cu, idxs, _ in out)
            return out

        def logged_charge(name, chips, hbm):
            charge(name, chips, hbm)
            charges.append((name, sched.queues.get(name).chips_used))

        sched.schedule_round = logged_round
        sched.queues.charge = logged_charge

        def fit(name, seed, mesh=None):
            with lock:
                started.append(name)
            # the first wave is held here until the shrink has drained
            # (a fit takes milliseconds): the drain then always preempts
            check(gate.wait(ELASTIC_TIMEOUT), "17b: the gate never opened")
            home = mesh.devices.flat[0]
            eng = AnalyticsEngine(DeviceGrid([home]), DataPlane())
            eng.put("pts", data.get(name).array.full(home))
            with lock:
                invocations.append(name)
            res = km.kmeans_fit(eng, "pts", k, iters=ITERS, use_kernel=True,
                                seed=seed)
            with lock:
                finished.append(name)
            return res

        descs = [ComputeUnitDescription(
            fn=fit, args=(f"pts{j}", seed), n_chips=1, tag="kmeans",
            tenant=tenant, queue=tenant, needs_mesh=True,
            stage_in=(DataRef(f"pts{j}", link_hint=Link.GFS),))
            for tenant, j, seed in jobs]
        steps = {}

        def drive():
            t0 = time.perf_counter()
            cus = pilot.agent.submit_many(descs[:n_first])
            wait_for(lambda: len(started) >= ELASTIC_SLOTS, "first wave")
            first = {uid: idxs for uid, _, idxs in binds}
            ev = pm.control_plane.move(pilot, reserve, ELASTIC_SHRINK,
                                       reason="shrink")
            steps["shrink_ms"] = 1e3 * (time.perf_counter() - t0)
            check(ev is not None and ev.n_chips == ELASTIC_SHRINK,
                  f"17b: the shrink moved {ev and ev.n_chips} chips")
            steps["slots_after_shrink"] = sched.n_slots
            steps["evicted_bytes"] = ev.evicted_bytes
            victims = [cu for cu in cus if cu.state is CUState.CANCELED]
            steps["drained"] = sorted(i for cu in victims
                                      for i in first[cu.uid])
            steps["binds_before_shrink"] = len(binds)
            gate.set()
            cus += pilot.agent.submit_many(descs[n_first:])
            clones = [cu.result for cu in victims]
            wait_for(lambda: {c.uid for c in clones}
                     <= {uid for uid, _, _ in binds}, "clone bound")
            granted = pm.control_plane.grow(pilot, ELASTIC_SHRINK,
                                            reason="grow")
            steps["grow_ms"] = 1e3 * (time.perf_counter() - t0)
            steps["granted"] = granted
            steps["slots_after_grow"] = sched.n_slots
            steps["binds_before_grow"] = len(binds)
            results = [cu.follow(ELASTIC_TIMEOUT) for cu in cus]
            # a preempted CU's own fit runs on to its end, unpublished
            wait_for(lambda: len(finished) == len(started), "fit to end")
            torch.cuda.synchronize()
            steps["wall_ms"] = 1e3 * (time.perf_counter() - t0)
            return cus, victims, results

        ops.LAUNCHES = ops.MERGE_LAUNCHES = 0      # phase 17b's window
        prof = _device_profile(torch, lambda: steps.update(
            run=drive()))
        launches = (ops.LAUNCHES, ops.MERGE_LAUNCHES)
        cus, victims, results = steps.pop("run")
        ledger = data.ledger()
        staging = pilot.prefetcher.snapshot()
        requests = [r for cu in cus for r in cu.staging_futures]
    finally:
        gate.set()
        pm.shutdown()

    def final(cu):
        while cu.state is CUState.CANCELED and isinstance(cu.result,
                                                          ComputeUnit):
            cu = cu.result
        return cu

    finals = [final(cu) for cu in cus]
    lost = sum(f.state is not CUState.DONE for f in finals)
    check(lost == 0, f"17b: {lost} CUs did not end DONE")
    check(len(victims) == ELASTIC_SHRINK and len(steps["drained"])
          == ELASTIC_SHRINK, f"17b: the shrink requeued {len(victims)} "
          f"CUs from slots {steps['drained']}")
    check((steps["slots_after_shrink"], steps["granted"],
           steps["slots_after_grow"]) == (ELASTIC_SLOTS - ELASTIC_SHRINK,
                                          ELASTIC_SHRINK, ELASTIC_SLOTS),
          f"17b: slots {steps['slots_after_shrink']} after the shrink, "
          f"{steps['granted']} granted, {steps['slots_after_grow']} after "
          "the grow")
    survivors = set(range(ELASTIC_SLOTS)) - set(steps["drained"])
    bound_at = {uid: idxs for uid, _, idxs in binds}
    for cu in victims:
        idxs = bound_at[final(cu).uid]
        check(set(idxs) <= survivors, f"17b: requeued {cu.uid} reran on "
              f"slots {idxs}, not on the survivors {sorted(survivors)}")
    late = [idxs for _, _, idxs in binds[steps["binds_before_shrink"]:]
            if set(idxs) & set(steps["drained"])]
    grown = sum(1 for _, _, idxs in binds if min(idxs) >= ELASTIC_SLOTS)
    steps["binds_on_grown_slots"] = grown
    check(not late, f"17b: drained slots bound again: {late}")
    for (tenant, j, seed), f, res in zip(jobs, finals, results):
        cent, cost = res
        want_cent, want_cost = solo[seed]
        check(torch.equal(cent, want_cent) and cost == want_cost,
              f"17b: {tenant}'s CU on pts{j} differs from its solo fit "
              f"(cost {cost} vs {want_cost})")
    check(len(invocations) == len(jobs) + len(victims),
          f"17b: {len(invocations)} fits ran, want {len(jobs)} + "
          f"{len(victims)} preempted")
    want = (scan_per_fit * len(invocations), merge_per_fit * len(invocations))
    check(launches == want, f"17b: K1 launched {launches} (scan, merge) "
          f"times, want {want}")
    conflicts = lease_conflicts(pm.rm.lease_events)
    check(not conflicts, f"17b: lease slots held twice: {conflicts}")
    over = [(q, used) for q, used in charges if used > ELASTIC_CAP]
    check(not over and charges, f"17b: queues over their cap of "
          f"{ELASTIC_CAP} chips at a bind: {over}")
    check(ledger["by_link"][Link.GFS] == ds_bytes,
          f"17b: {ledger['by_link'][Link.GFS]} GFS bytes, want each "
          f"dataset's once: {ds_bytes}")
    check(staging["transfers"] == len(draws) and all(
        r.state.value == "done" for r in requests),
        f"17b: {staging['transfers']} transfers; request states "
        f"{sorted({r.state.value for r in requests})}")
    order = [queue for _, queue, _ in binds]
    out = {"cus": len(jobs), "requeued": len(victims), "lost": lost,
           "fits": len(invocations), "k1_launches": launches[0],
           "merge_launches": launches[1], "dataset_bytes": ds_bytes,
           "bytes_by_link": ledger["by_link"],
           "bytes_by_reason": ledger["by_reason"],
           "stage_transfers": staging["transfers"],
           "stage_hits": staging["cache"]["hits"], "bind_order": order,
           "max_charged": {q: max(u for n_, u in charges if n_ == q)
                           for q, _ in ELASTIC_TENANTS},
           "lease_events": len(pm.rm.lease_events), **steps,
           "device_busy_ms": prof["device_busy_ms"],
           "busy_share": prof["busy_share"],
           "profiled_wall_ms": prof["wall_ms"]}
    print(f"  {len(jobs)} CUs DONE (0 lost), {len(victims)} requeued from "
          f"slots {steps['drained']} onto {sorted(survivors)}; centroids "
          f"and costs bitwise those of solo fits; K1 {launches[0]} scans "
          f"and {launches[1]} merges for {len(invocations)} fits")
    print(f"  wall {steps['wall_ms']:.3f} ms (shrink done at "
          f"{steps['shrink_ms']:.3f} ms, grow at {steps['grow_ms']:.3f}); "
          f"bytes by link {ledger['by_link']} (GFS = {len(draws)} datasets "
          f"once, {staging['cache']['hits']} coalesced hits); device busy "
          f"{prof['device_busy_ms']:.3f} of {prof['wall_ms']:.3f} ms "
          f"profiled ({_share(prof['busy_share'])}) [{card}]")
    print(f"  {steps['binds_before_grow']} of {len(binds)} binds before "
          f"the grow, {grown} on the grown slots")
    print(f"  bind order by tenant: {' '.join(order)}; most chips charged "
          f"a queue: {out['max_charged']} (cap {ELASTIC_CAP}); "
          f"{len(pm.rm.lease_events)} lease events, no slot held twice")
    return out


def kernel_entry(name, source, replaces, launches, err, rows,
                 library: bool) -> dict:
    """One kernel's record: times summed over its timed shapes, bound
    from their summed bytes and their operations at each shape's peak."""
    bound = bound_from(sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S,
                       sum(r["t_ops"] for r in rows))
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": (sum(r["library_ms"] for r in rows) if library
                           else None),
            "shapes": rows}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # a registry of this run's own: phases 2-6 run the default blocks,
    # and phase 7 tunes into it
    with tempfile.TemporaryDirectory() as reg_dir:
        os.environ["REPRO_AUTOTUNE_REGISTRY"] = os.path.join(
            reg_dir, "autotune.json")
        return run(torch)


def run(torch) -> int:
    from repro_torch.analytics import kmeans as km
    from repro_torch.analytics.engine import AnalyticsEngine
    from repro_torch.core import (ComputeUnitDescription, CUState, Link,
                                  PilotDescription, PilotManager,
                                  ResourceManager)
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.kmeans import kmeans as km_kernel
    from repro_torch.kernels.kmeans import ops, ref
    from repro_torch.kernels.mamba_scan import mamba_scan as ms_k
    from repro_torch.launch import platform

    platform.configure("cuda")      # TF32 off: full f32 products
    dev = torch.device("cuda", 0)
    km_blocks = autotune.DEFAULTS["kmeans"]

    # ------------------------------------------------- 1. card and set-up
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    sources = [km_kernel.SOURCE, fa_k.SOURCE, ms_k.SOURCE, ms_k.BWD_SOURCE,
               ms_k.SSM_BWD_SOURCE]
    build_s = build.build_all(sources)
    print(f"kernel build: {build_s:.2f} s")
    for src in sources:
        inst = ptxas_instances(build.build_log(src))
        if inst:
            regs = [r for _, r, _ in inst]
            print(f"  ptxas {src.name}: {len(inst)} kernels, "
                  f"{min(regs)}-{max(regs)} registers, "
                  f"{sum(sp for *_, sp in inst)} bytes of spill stores in all")
    for name, regs, spill in ptxas_instances(build.build_log(fa_k.SOURCE)):
        hd, bk, elem = re.search(r"ILi(\d+)ELi(\d+)E(f|13__nv_bfloat16)",
                                 name).groups()
        print(f"    K2 hd {hd} bk {bk} {'f32' if elem == 'f' else 'bf16'}: "
              f"{regs} registers, {spill} bytes of spill stores")

    k1_ptxas = {}
    for name, regs, spill in ptxas_instances(
            build.build_log(km_kernel.SOURCE)):
        m = re.search(r"kmeans_assign_kernelILi(\d+)ELi(\d+)E", name)
        k1_ptxas[f"scan D {m[1]} R {m[2]}" if m else "merge"] = [regs, spill]
    items = [f"{key}: {r}/{sp}" for key, (r, sp) in k1_ptxas.items()]
    for i in range(0, len(items), 6):
        print("    K1 (registers/spill bytes) " + "; ".join(items[i:i + 6]))

    # ------------------------------------- 2. kernel against plain version
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err, shapes, merge_err, merge_rows = phase_assign(
        torch, dev, km, km_kernel, ops, ref, km_blocks, sms)

    # --------------------------------------------------------- 3. main path
    print("phase 3: main path (Pilot -> Mode-I cluster -> kmeans_fit)")
    pm = PilotManager(ResourceManager())
    try:
        pilot = pm.submit(PilotDescription(n_chips=1, name="hpc"))
        check(pilot.agent.lrm.info()["platform"] == "gpu",
              "pilot is not on the GPU")
        cluster = pilot.spawn_analytics_cluster(1)
        eng = cluster.engine
        home = cluster.devices[0]
        # checks first, so that their launches stay out of the main
        # path's count: kernel vs plain version through kmeans_fit.  One
        # iteration starts from the same centroids, so the costs differ
        # only by rounding (rel 1e-4).  After two they agree to rel 1e-4
        # unless a first-iteration near-tie went the other way: both
        # choices are right, but at k = 5000 a cluster holds ~2 points
        # and one flip moves its centroid visibly.
        plain_costs = {}
        for s, (name, (n, k)) in enumerate(km.PAPER_SCENARIOS.items()):
            eng.put(name, km.make_dataset(n, seed=10 + s, device=home))
            flips = first_iteration_flips(
                torch, km_kernel, ops, ref, eng.get(name).full(),
                km._init_centroids(eng.get(name), k, 0), km_blocks, sms)
            one = [km.kmeans_fit(eng, name, k, iters=1, use_kernel=uk)[1]
                   for uk in (True, False)]
            check(math.isclose(one[0], one[1], rel_tol=1e-4),
                  f"{name}: 1-iteration kernel cost {one[0]} vs plain "
                  f"{one[1]}")
            plain_costs[name] = (km.kmeans_fit(
                eng, name, k, iters=ITERS, use_kernel=False)[1], flips)
            print(f"  {name}: 1-iteration kernel vs plain cost rel diff "
                  f"{abs(one[0] - one[1]) / one[1]:.3e}; {flips} "
                  "first-iteration near-tie flips")
        # independent numpy reference on a small input
        eng.put("small", km.make_dataset(2_048, seed=7, device=home))
        init = km._init_centroids(eng.get("small"), 5, 0)
        _, small_cost = km.kmeans_fit(eng, "small", 5, iters=ITERS,
                                      use_kernel=True)
        np_cost = numpy_lloyd(eng.get("small").to_numpy(),
                              init.cpu().numpy(), ITERS)
        check(math.isclose(small_cost, np_cost, rel_tol=1e-4),
              f"small: kernel cost {small_cost} vs numpy {np_cost}")
        print(f"  small (2048 x 5): cost {small_cost:.6e}, numpy "
              f"{np_cost:.6e}")

        walls = {}
        ops.LAUNCHES = ops.MERGE_LAUNCHES = 0  # the main path's window
        for name, (n, k) in km.PAPER_SCENARIOS.items():
            n_blocks = len(eng.get(name).row_blocks())
            costs = {}
            for path in ("local", "global"):
                times = []
                for _ in range(REPS):
                    gfs0 = eng.data.moved_by_link(Link.GFS)
                    before = ops.LAUNCHES
                    t0 = time.perf_counter()
                    cent, cost = km.kmeans_fit(eng, name, k, iters=ITERS,
                                               data_path=path,
                                               use_kernel=True)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    check(ops.LAUNCHES - before == ITERS * n_blocks,
                          f"{name}/{path}: {ops.LAUNCHES - before} kernel "
                          f"launches, want {ITERS * n_blocks}")
                    gfs = eng.data.moved_by_link(Link.GFS) - gfs0
                    want = (2 * ITERS * eng.get(name).nbytes
                            if path == "global" else 0)
                    check(gfs == want, f"{name}/{path}: {gfs} GFS bytes, "
                          f"want {want}")
                    check(tuple(cent.shape) == (k, km.PAPER_DIM)
                          and bool(torch.isfinite(cent).all())
                          and math.isfinite(cost),
                          f"{name}/{path}: bad centroids or cost")
                costs[path] = cost
                walls[(name, path)] = statistics.median(times)
                print(f"  {name} {path}: cost {cost:.6e}, median wall "
                      f"{1e3 * walls[(name, path)]:.3f} ms over {REPS}")
            check(math.isclose(costs["local"], costs["global"], rel_tol=1e-5),
                  f"{name}: local {costs['local']} != global "
                  f"{costs['global']}")
            plain_cost, flips = plain_costs[name]
            rel = abs(costs["local"] - plain_cost) / plain_cost
            check(flips > 0 or rel <= 1e-4,
                  f"{name}: kernel cost {costs['local']} vs plain "
                  f"{plain_cost}")
            print(f"  {name}: kernel vs plain cost rel diff {rel:.3e} after "
                  f"{ITERS} iterations")
        cluster.shutdown()

        def gang_kmeans(mesh=None):
            g_eng = AnalyticsEngine(mesh, pilot.data)
            g_eng.put("gang-pts", km.make_dataset(
                100_000, seed=3, device=mesh.devices.flat[0]))
            return km.kmeans_fit(g_eng, "gang-pts", 500, iters=ITERS,
                                 use_kernel=True)[1]

        before = ops.LAUNCHES
        cu = pilot.submit(ComputeUnitDescription(
            fn=gang_kmeans, n_chips=1, gang=True, needs_mesh=True,
            tag="kmeans-gang"))
        gang_cost = cu.wait(600)
        check(cu.state is CUState.DONE and math.isfinite(gang_cost),
              f"gang CU ended {cu.state} with {gang_cost!r}")
        check(ops.LAUNCHES - before == ITERS,
              f"gang CU: {ops.LAUNCHES - before} launches, want {ITERS}")
        print(f"  gang CU {cu.uid}: cost {gang_cost:.6e}")
        launches, merge_launches = ops.LAUNCHES, ops.MERGE_LAUNCHES

        # ------------------------------------- 4. where the time goes
        print("phase 4: profile of one local kmeans_fit per scenario")
        eng = pilot.spawn_analytics_cluster(1).engine
        breakdown = {name: profile_fit(torch, km, eng, name, k)
                     for name, (_, k) in km.PAPER_SCENARIOS.items()}
    finally:
        pm.shutdown()

    check(launches > 0, "the main path launched no kmeans_assign kernel")
    check(merge_launches > 0, "the main path launched no kmeans_merge kernel")
    print(f"  main path: {launches} scan launches, {merge_launches} merge "
          "launches")

    # ---------------------- 8-10. Session, Raptor, recovery and resume
    t_phases = time.perf_counter()
    direct = {name: direct_fit(torch, km, dev, n, k, SESSION_SEED + s)
              for s, (name, (n, k)) in enumerate(km.PAPER_SCENARIOS.items())}
    ops.LAUNCHES = ops.MERGE_LAUNCHES = 0      # phase 8's window
    session_rows = phase_session(torch, dev, km, direct)
    session_launches = (ops.LAUNCHES, ops.MERGE_LAUNCHES)
    check(session_launches[0] > 0 and session_launches[1] > 0,
          f"phase 8 launched K1 {session_launches} (scan, merge) times")
    raptor = phase_raptor(torch, dev, km, ops)
    recovery = phase_recovery(torch, dev, km, ops,
                              direct["1m_points_50_clusters"])
    check(recovery["launches"] > 0, "phase 10 launched no K1")
    phases_s = time.perf_counter() - t_phases
    print(f"  phases 8-10: {phases_s:.3f} s wall")

    scan_err, scan_rows = phase_scan(torch, dev)
    attn_err, attn_rows = phase_attention(torch, dev)
    tuned_launches, tuned = phase_autotune(
        torch, dev, lambda p, c, label: compare_assign(torch, ops, ref, p, c,
                                                       label))
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    model_errs = phase_model_parity(torch, dev)
    ms_ops.LAUNCHES = 0                        # phase 11b's window
    serving = phase_serving(torch, dev)
    model_launches = ms_ops.LAUNCHES
    check(model_launches == sum(
        r["ssm_layers"] * (PREFILL_REPS + 1) for r in serving.values()),
        f"phase 11b launched K3 {model_launches} times")
    print(f"  phase 11b: K3 launched {model_launches} times")
    sublayers = hymba_sublayers(torch, dev, *SERVE_MODELS[0][1:3])
    torch.cuda.empty_cache()                   # phase 11's weights are gone
    ms_ops.LAUNCHES = 0                        # phase 12's window
    engine = phase_engine(torch, dev)
    engine_launches = ms_ops.LAUNCHES
    check(engine_launches > 0, "phase 12 launched no K3")
    print(f"  phase 12: K3 launched {engine_launches} times")
    t_train = time.perf_counter()
    bwd_err, train_scan_err, bwd_rows = phase_scan_bwd(torch, dev)
    ssm_err, ssm_sum_err, ssm_rows, ssm_ulps = phase_ssm_bwd(torch, dev)
    layer_grad_err = _mamba_layer_grads(
        torch, dev, torch.Generator(device=dev).manual_seed(131))
    training = phase_train(torch, dev, card)
    hybrid = phase_hybrid(torch, dev)
    train_s = time.perf_counter() - t_train
    print(f"  phase 13: {train_s:.3f} s wall")
    t_plan = time.perf_counter()
    plan_vs_plain = phase_plan_vs_plain(torch, dev, card, training)
    ep_combine = phase_ep_combine(torch, dev, card)
    plan_s = time.perf_counter() - t_plan
    print(f"  phase 14: {plan_s:.3f} s wall")
    t_roof = time.perf_counter()
    analytic_rec = phase_analytic(torch, dev, card, training, serving)
    stage_cost = phase_stage_cost(torch, dev, card)
    save_tp = phase_save_tp_out(torch, dev, card, training)
    print(f"phase 15c and 16b: the dry-run of {DRYRUN_CELL}")
    dryrun = phase_dryrun(card)
    dry_launches = [dryrun["kernel_launches"][k]
                    for k in ("mamba_scan", "mamba_ssm_bwd")]
    roof_s = time.perf_counter() - t_roof
    print(f"  phase 15: {roof_s:.3f} s wall")
    t_shard = time.perf_counter()
    ms_ops.LAUNCHES = 0                        # phase 16a's window
    serve_sharded = phase_serve_sharded(torch, dev, card,
                                        serving[SERVE_MODELS[0][0]])
    sharded_launches = ms_ops.LAUNCHES
    check(sharded_launches == PREFILL_REPS * serve_sharded[
        "k3_launches_per_prefill"],
        f"phase 16a launched K3 {sharded_launches} times")
    shard_s = time.perf_counter() - t_shard
    print(f"  phase 16a: K3 launched {sharded_launches} times; "
          f"{shard_s:.3f} s wall")
    t_elastic = time.perf_counter()
    quickstart = phase_quickstart(card)
    elastic = phase_elastic(torch, dev, km, ops, card)
    elastic_s = time.perf_counter() - t_elastic
    print(f"  phase 17: {elastic_s:.3f} s wall")
    t_bytes = sum(s["bytes"] for s in shapes) / HBM_BYTES_PER_S
    t_ops = sum(s["flops"] for s in shapes) / FP32_FLOP_PER_S
    record = {"kernels": [{
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/kmeans/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans/kmeans.py:47",
        "launches": launches, "max_abs_err": max_err,
        # one call at each of the paper's three shapes, summed
        "ms": sum(s["ms"] for s in shapes),
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(s["library_ms"] for s in shapes),
        "kernel_only_ms": sum(s["kernel_only_ms"] for s in shapes),
        "device_ms": sum(s["device_ms"] for s in shapes),
        "launches_autotune": tuned_launches["kmeans"],
        "launches_session": session_launches[0],
        "launches_raptor": raptor["launches"],
        "launches_recovery": recovery["launches"],
        "launches_elastic": elastic["k1_launches"],
        "ptxas": k1_ptxas, "shapes": shapes,
    }, kernel_entry(
        "kmeans_merge",
        "src/repro_torch/kernels/kmeans/csrc/kmeans_assign.cu",
        "src/repro/kernels/kmeans/kmeans.py:47", merge_launches, merge_err,
        merge_rows, library=False) | {
        "launches_session": session_launches[1],
        "launches_raptor": raptor["merge_launches"],
        "launches_recovery": recovery["merge_launches"],
        "launches_elastic": elastic["merge_launches"]}, kernel_entry(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:82",
        tuned_launches["flash_attention"], max(attn_err.values()),
        attn_rows, library=True) | {"max_abs_err_by_dtype": attn_err},
        kernel_entry(
        "mamba_scan", "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
        "src/repro/kernels/mamba_scan/mamba_scan.py:51",
        tuned_launches["mamba_scan"], max(scan_err, train_scan_err, *(
            e for k, e in model_errs.items()
            if k.endswith("K3 at serving shape"))), scan_rows,
        library=False) | {
        "launches_model": model_launches,
        "launches_engine": engine_launches,
        "launches_train": training["k3_launches"],
        "launches_hybrid": hybrid["k3_launches"],
        "launches_plain": plan_vs_plain["launches_plain"][0],
        "launches_save_tp_out": save_tp["launches"][0],
        "launches_dryrun": dry_launches[0],
        "launches_serve_sharded": sharded_launches}, kernel_entry(
        "mamba_scan_bwd",
        "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_bwd.cu",
        "src/repro/models/layers/mamba.py:62", training["k3_bwd_launches"],
        bwd_err, bwd_rows, library=False) | {
        "launches_hybrid": hybrid["k3_bwd_launches"]}, kernel_entry(
        "mamba_ssm_bwd",
        "src/repro_torch/kernels/mamba_scan/csrc/mamba_ssm_bwd.cu",
        "src/repro/models/layers/mamba.py:46", training["ssm_bwd_launches"],
        ssm_err, ssm_rows, library=False) | {
        "max_rel_err_sums": ssm_sum_err, "exp_max_ulp": ssm_ulps,
        "launches_hybrid": hybrid["ssm_bwd_launches"],
        "launches_plain": plan_vs_plain["launches_plain"][1],
        "launches_save_tp_out": save_tp["launches"][1],
        "launches_dryrun": dry_launches[1],
        "layer_grad_max_rel_err": layer_grad_err,
        "replaced_ms": sum(r["replaced_ms"] for r in ssm_rows)}],
        "main_path_wall_ms": {f"{n}/{p}": 1e3 * t
                              for (n, p), t in walls.items()},
        "autotune": {fam: {k: rec[k] for k in (
            "config", "default_config", "best_s", "default_s",
            "speedup_vs_default", "n_candidates", "wall_s")}
            for fam, rec in tuned.items()},
        "profile": breakdown, "session": session_rows, "raptor": raptor,
        "recovery": recovery, "phases_8_10_s": phases_s, "build_s": build_s,
        "model_parity_max_abs_err": model_errs, "serving": serving,
        "hymba_sublayer_ms": sublayers, "serving_engine": engine,
        "training": training, "hybrid_pipeline": hybrid,
        "phase_13_s": train_s, "plan_vs_plain": plan_vs_plain,
        "ep_combine": ep_combine, "phase_14_s": plan_s,
        "analytic": analytic_rec, "stage_cost": stage_cost,
        "dryrun": dryrun, "save_tp_out": save_tp, "phase_15_s": roof_s,
        "serve_sharded": serve_sharded, "phase_16_s": shard_s,
        "quickstart": quickstart, "elastic": elastic,
        "phase_17_s": elastic_s}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
