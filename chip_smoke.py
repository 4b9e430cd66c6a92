#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Builds the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
source, all started together) and drives fourteen paths: seven at the
paper's mnist width (d=780, 10 one-vs-rest heads), and the LM side (4,
8, 9, 11, 12, 13 and 14):

1. compile -> save/load -> ``SVMEngine`` for the maclaurin family, with
   rows scaled just out of the Eq 3.11 envelope so the exact fallback
   (kernel B2) runs beside the fast path (kernel B1);
2. ``compile_model`` over maclaurin, poly2 and dense fourier at f32 and
   int8 (kernels B1, B3, B4, B5), the winner saved, loaded and served,
   then each of the six (family, dtype) artifacts served with rows pushed
   out of the envelope, and a fourier artifact whose held-out verdict
   failed, which sends every row to B2;
3. training on the card (one-vs-rest LS-SVMs on 8192 rows, and a dual
   C-SVC with ``compress_support``), ``compile_model`` over every family
   with the Fastfood projection for fourier, and the Fastfood artifacts
   at f32 and int8 (kernels B6, B7) saved, loaded and served, beside
   copies whose held-out verdict failed;
4. ``smollm-135m`` at full width (30 layers, d_model 576, 9/3 GQA heads)
   from seeded random weights: bf16 prefill of 4 x 2048 tokens with
   blockwise attention, flash attention (kernel B9, one launch a layer)
   and the maclaurin backend (kernel B8, one launch a layer); f32 decode
   of a 1024-token prompt through an f32 and a bf16 KV cache, an int8 KV
   cache and the ``MacState``, held against the matching forward (B9 or
   B8 at f32) or the next wider cache; then 32 greedy tokens from the
   bf16, int8 and ``MacState`` caches;
5. the serving runtime (``repro_torch.serve.runtime``), after a check
   that ``SVMEngine.submit`` returns before the work queued ahead of it
   ends: path 1's maclaurin f32 and int8 artifacts published as two
   tenants of one ``Runtime`` and served to 8 client threads in
   coalesced steps (each request held against its artifact's direct
   submit, beside the same clients on direct submits), an overload burst
   shed with retry hints, three engine faults opening the breaker (the
   degraded requests through B2) and a probe closing it, a drift that
   ``DriftGuard`` heals (``compile_model`` on the live traffic, a canary,
   an alias flip), and a ``torch.profiler`` trace of one step, taken at
   the end of the script (the profiler slows every later launch of its
   process);
6. the HTTP front door (``repro_torch.serve.server``) over a runtime on
   the card, in the acts of ``examples/svm_http.py``: path 1's int8
   artifact POSTed as base64 ``.npz`` bytes and its f32 artifact
   published in process with the exact model; path 5's clients and
   requests over real localhost sockets (each answer held against the
   artifact's direct submit, the cost of the hop against path 5's
   in-process latency from the same run); typed refusals (401, tenant
   quota, overload) on a second, tenanted server, with client, telemetry
   and span counts conserved; and a ``/metrics`` scrape;
7. scale-out (``examples/svm_scaleout.py``'s acts) on meshes of 4 x the
   one card: path 1's f32 artifact behind a runtime with 1, 2 and 4
   replicas serving path 5's plan, a fault isolated to one replica of
   three, head-sharded engines (``head_mesh=``) for the six (family,
   dtype) artifacts at the mnist width and four at 4096 heads (d=32), and
   path 1's exact model with its SVs split (``mesh=``), each held against
   the unsharded engine (kernels B1-B7);
8. the LM families past dense at full width, depth cut (FAMILY_MODELS):
   qwen3-moe (4 of 48 layers), rwkv6 (4 of 32), zamba2 (12 of 54: two
   groups, each then the shared attention block) and llama-3.2-vision (5
   of 100: 4 self layers and a cross layer over 4096 random image
   embeddings), one at a time from seeded random weights: bf16 prefill of
   4 x 2048 tokens (2 x 2048 for the VLM) with blockwise, flash (B9) and
   maclaurin (B8) attention, one launch a self-attention application;
   f32 decode of a 128-token prompt through every cache the family has
   (f32, bf16 and, for the MoE, int8 KV; the ``MacState``; the RWKV6 and
   Mamba2 states), held against the forward or the next wider cache; 16
   greedy tokens from each; B8 and B9 held against their twins at the
   path's head widths 80 and 128;
9. training (``repro_torch.train``, ``launch.train``): B8's gradient
   (the kernel's forward, the plain twin's backward) against the twin's at
   (72, 2048, 64) and (128, 2048, 128); ``smollm-135m`` at full width and
   depth (remat on, bf16) trained on 8 x 2048-token batches from
   ``lm_token_batches``: 20 AdamW steps with the blockwise attention (no
   kernel), 10 with the maclaurin backend (B8 in each layer's forward and
   again where remat reruns it: 60 a step), four microbatches against one
   at f32, 15 steps of int8-compressed gradients, the launcher's failure
   drill (exit 42, then the resume from the committed checkpoint, its
   arrays restored bit for bit), flash attention refused under a gradient
   before any launch, and 16 greedy tokens from the trained weights;
10. the tuning table and placement: ``kernels/common/tuning_table.json``
   loads with no warning and holds this card's entries for B1-B7; engines
   of every artifact paths 1-3 serve run each bucket 32-1024 (and path 1's
   exact fallback, B2, at 32-256) with the tabled tiles, each held against
   its plain twin and timed in turns with the default tile; then
   qwen3-moe at path 8's depth cut is placed on a (data, model) mesh of
   2 x 2 slots of the card under three rule sets
   (``repro_torch.sharding``), every leaf gathered back bit for bit, and
   its embedding, LM head and first layer checkpointed and restored onto
   their shardings;
11. the rule-sharded LM steps (``launch.specs.build_cell``,
   ``repro_torch.sharding``) on a (data, model) mesh of 2 x 2 slots of
   the card at f32 (SHARD_*): qwen3-moe served and trained (B9 and B8 on
   head shards), smollm-135m trained and decoded, each against the
   one-device step (the served logits gathered from the positions where
   they stay, each block's place and the card's peak printed);
12. the same for the families past dense and MoE and the optimizer
   options (SHARD12_*): rwkv6, zamba2 and llama-vision served (B9 on
   zamba2's 16-head shards at d = 80 and llama-vision's 32-head shards at
   d = 128, bf16), rwkv6, zamba2 (B8 on its head shards) and musicgen
   trained, qwen3-moe trained with Adafactor, two microbatches and
   compressed gradients;
13. the same under the last two rule sets (SHARD13_*): SP_RULES (the
   residual cut along the sequence between blocks) for qwen3-moe's prefill
   (B9 on head shards; against DEFAULT_RULES' residual and peak) and
   training (B8), zamba2's and smollm-135m's training; EP_DP_RULES (the
   batch over both axes, the ffn dims gathered) for qwen3-moe's training
   (B8 on a position's row), prefill (B9) and decode;
14. the dry run (``launch.dryrun``: a cell traced on fake devices at one,
   two (and for training three) periods of layers and extrapolated, its
   ops counted by ``launch.op_cost``) held against the same cells run on
   the card under the same recorder (DRY_*): smollm-135m at full width
   and depth on a 1 x 1 mesh (path 9's training batch, a bf16 flash and a
   maclaurin prefill: flops and launches equal, the peak over the placed
   arguments within 15%, the median step against the roofline bound) and
   qwen3-moe on path 11's 2 x 2 slots (EP_DATA training, SP flash
   prefill: flops and every collective call equal), while smollm-135m's
   decode_32k cell is traced on the fake 16 x 16 production mesh in a
   process of its own. Path 5's profile act runs after it.

Each path is driven with the launch counts set to 0 just before it and
read just after (path 5 in two windows: its acts, and its profile at the
end; path 8 in one window a model). Each kernel is held against its
plain PyTorch twin at full width, and timed beside its twin, a library
call and the least time the card could take.

The model of paths 1 and 2 (16384 SVs) is random from a seed, shaped like
a trained one so that no constant swamps what the checks look at: each
head's ``alpha_y`` sums to 0 (the SVM dual's equality constraint), and
``b`` makes every head score 0 at z = 0, so the labels follow z. Path 3's
model is trained. Paths 4 and 8 take weights random from a seeded
``torch.Generator`` at the reference's scales.

Output: phase lines (each with its seconds), the card line from
nvidia-smi, one JSON line of kernels, and last ``{"ok": true, "device":
{...}}``. Exits non-zero, printing no result, on any failed phase,
without a card, or without the repo's ``src/`` beside it.
``python3 chip_smoke.py --eighth-path`` runs path 8 alone,
``--ninth-path`` path 9, ``--tenth-path`` path 10, ``--eleventh-path``
path 11, ``--twelfth-path`` path 12, ``--thirteenth-path`` path 13,
``--fourteenth-path`` path 14.
"""

from __future__ import annotations

import http.client
import inspect
import json
import math
import re
import shlex
import subprocess
import sys
import functools
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
K, N_SV = 10, 16384
REQUEST_ROWS = (1, 37, 256, 1024)
SCALED_ROWS = (0, 3, 8, 16)  # rows per request pushed out of the envelope
# Scaled rows land at msq * |z|^2 = OUTSIDE / (16 gamma^2): outside the
# bound by a margin no rounding closes, yet near enough to the SVs that
# their exact scores still differ from b (further out they equal b).
OUTSIDE = 1.25
EXACT_ROWS = 64

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit); the same
# table as ``launch.roofline``'s (PEAK_F32, PEAK_BF16, PEAK_F32_3XTF32,
# HBM_BW), which prices the dry run's cells.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989.4e12
# f32-accurate products from the tensor cores: 3xTF32 spends three TF32
# products (hi*hi + hi*lo + lo*hi) on one, at the 495 TFLOP/s dense TF32
# rate of NVIDIA's H100 SXM data sheet. The bound of every kernel whose work
# is f32 products, whatever implements it: B1-B5, B9 in f32, B8 by either
# route (its moments are products too) and B6/B7's readout. B6/B7's
# transforms, diagonals and cos are adds and multiplies of their own, bound
# at the fp32 rate.
PEAK_F32_3XTF32 = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12

# Tolerances: fp32 on both sides, sums taken in another order.
# B1: |delta| <= B1_REL * max|ref| + B1_ABS on the served artifact, and
# <= B1_REL * max|ref| alone on its quadratic term (c = v = b = 0), which
# the served scores hold only at ~1e-3 of their size at gamma = 1e-4.
B1_REL, B1_ABS, B1_ZSQ_REL = 1e-4, 1e-5, 1e-5
# B2: the K sums of 16384 terms cancel to ~1e-5 of their terms' size, so
# fp32 resolves them only to ~1e-4 absolute, and no tolerance relative to
# the output holds for either side. B2 may be at most B2_TWIN times as far
# from its fp32 twin as that twin is from the float64 answer, + B2_ABS.
B2_TWIN, B2_ABS = 4.0, 1e-6
MIN_AGREE_IN_ENVELOPE = 0.99
MAX_MODE_SHARE = 0.5  # reference labels must not be one class on most rows

# Second path: compile_model over every (family, dtype) candidate.
KERNEL_ROWS = (32, 1024)  # batch sizes the kernels are checked and timed at
FEATURES = (1024, 4096)  # fourier's default basis, and a wider one
# Mean |error| against the exact expansion within 5% of the mean |exact
# score| on the verification sample.
BUDGET = dict(max_err=0.05, metric="mean_abs", relative=True)
CELL_ROWS = (1, 1024)  # requests served through each (family, dtype) artifact
CELL_SCALED = (1, 16)  # rows of each pushed out of the envelope
# B3 is held to its twin as B1 is; its and the twin's distances from the
# twin in float64 on the same int8 codes are printed beside it (the card
# tests hold B3 to B2's rule there). B4/B5: the readout sums cancel as B2's
# do, so B2's rule: at most B45_TWIN times the f32 twin's distance from
# float64, + B45_ABS.
B45_TWIN, B45_ABS = 4.0, 1e-6

# Third path: K Gaussian classes at d=780 with means 3 N(0, I) apart (the
# reference suite's one-vs-rest recipe at the mnist width), LS-SVMs at
# gamma = 0.5 gamma_max(X) and reg_c = 10.
OVR_TRAIN, OVR_TEST = 8192, 2048
OVR_GAMMA_SHARE, OVR_REG_C = 0.5, 10.0
MIN_OVR_TRAIN_ACC = 0.9  # what the recipe reaches in the JAX suite
# The dual C-SVC: 4096 rows, 500 steps, C = 1, on make_dataset("mnist") at
# the spec gamma, and on class 0 against the rest of the OvR rows.
SVC_ROWS, SVC_STEPS, SVC_C = 4096, 500, 1.0
SVC_RTOL = SVC_ATOL = 1e-4  # compressed against dense decision values
# n_sv of the reference trainer (repro.svm.dual.train_svc) on the mnist
# task, from scripts/svc_reference_count.py: at gamma 1e-4 the kernel is
# nearly constant over these rows and every row stays a support vector.
SVC_MNIST_N_SV = 4096
FF_FEATURES = (4096, 1024)  # Fastfood basis served, and the default
# B6/B7: B4's rule, at most FF_TWIN times the twin's distance from float64.
FF_TWIN, FF_ABS = 4.0, 1e-6

# Fourth path: the LM side at full width, weights random from SEED.
LM_NAME = "smollm-135m"
LM_B, LM_T = 4, 2048  # prefill batch and tokens
LM_ATTN = (LM_B * 9, LM_T, 64, 64)  # (B*Hq, T, hd, hd) that B8/B9 see in prefill
ATTN_CASES = (  # (kernel, case, (bh, t, d, dv), dtype)
    ("flash_attention", "model bf16", LM_ATTN, "bfloat16"),
    ("flash_attention", "model f32", LM_ATTN, "float32"),
    ("maclaurin_attention", "model", LM_ATTN, "float32"),
    ("flash_attention", "ragged bf16", (LM_B * 9, 2000, 64, 64), "bfloat16"),
    ("flash_attention", "ragged f32", (LM_B * 9, 2000, 64, 64), "float32"),
    ("maclaurin_attention", "ragged", (LM_B * 9, 2000, 64, 64), "float32"),
    ("maclaurin_attention", "hd128", (8, 1024, 128, 128), "float32"),  # S2 8 MB a head
    # past T ~ 2 d dv, where the moments' count is ~6.8x below the quadratic
    # form's, yet the quadratic route is faster; and where the moments route is
    ("maclaurin_attention", "d16", (8, 4096, 16, 16), "float32"),
    ("maclaurin_attention", "long d16", (64, 8192, 16, 16), "float32"),
)
# ``--route-sweep``: B8's routes timed apart at these head counts and T.
SWEEP_HEADS = (1, 4, 16, 64, 256)
SWEEP_T = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
SWEEP_MS = 100.0
# B8/B9: at most ATTN_TWIN times the twin's distance from the float64
# quadratic-form oracle, + ATTN_ABS. B9 in bf16 is also held element by
# element against the twin's f32 value before rounding (the twin on the same
# inputs widened to f32, as the kernel widens them): the kernel rounds a
# value within the f32 rule's tolerance ``tol32`` of it, so each element may
# differ by half a bf16 step of itself, BF16_HALF_STEP |x|, + (1 +
# BF16_HALF_STEP) tol32. A control (the twin with the first key tile dropped
# for every later row) must fail that check.
ATTN_TWIN, ATTN_ABS = 4.0, 1e-6
BF16_HALF_STEP = 2.0**-8
# Logits against a reference run of the same weights, |delta| <= REL *
# max|ref logit|, each REL about twice the reading on an H100 80GB HBM3 at
# 700 W (chip_smoke.py's lm_prefill and lm_consistency lines): flash against
# blockwise prefill in bf16 0.0197 (each layer's attention differs by bf16
# rounding: blockwise rounds its softmax weights, flash keeps them f32); an
# f32 decode's bf16 KV cache against its f32 one 0.0068; the int8 KV cache
# against the bf16 one 0.0206. Top-1 must also agree wherever the
# reference's top-2 gap exceeds GAP * max|ref logit|, a fixed share above
# twice the reading (so no such position may flip at the measured error) and
# below twice REL (so the check is not implied by the max one). The
# maclaurin backend, another attention function, is the control: its logits
# must be further than every REL from the softmax ones.
PREFILL_REL, PREFILL_GAP = 0.04, 0.0625
BF16_CACHE_REL, BF16_CACHE_GAP = 0.015, 0.02
INT8_CACHE_REL, INT8_CACHE_GAP = 0.045, 0.06
CONS_B, CONS_T, GEN_STEPS = 2, 1024, 32  # f32 decode batch, prompt, generation
CONS_LAYERS = 10  # of 30: the decode is host bound, about 2 ms a layer a token
# Decode against the forward: the reference's own tolerance
# (tests/test_models.py:72-74), elementwise |delta| <= atol + rtol |ref|.
CONS_RTOL = CONS_ATOL = 2e-2

# Eighth path: the LM families past dense at full width, depth cut to fit
# one card and the time limit; weights random from SEED (f32 masters, cast
# per call as the reference casts them). (config, layers run, prefill
# batch): qwen3-moe 4 of 48 layers (3.1 B parameters, 12.4 GB f32);
# rwkv6 4 of 32 (1.4 B); zamba2 12 of 54, two groups of 6 Mamba layers
# each followed by the shared block (0.75 B); llama-3.2-vision 5 of 100,
# one superblock of 4 self layers and 1 cross layer (6.4 B, 25.5 GB f32
# before its bf16 cast), with 4096 random image embeddings a row. Arctic
# stays off the card: one full-width layer's experts alone are 13.4 B
# parameters, 53.5 GB at f32 (its dense residual is held in the tests).
FAMILY_MODELS = (
    ("qwen3-moe-30b-a3b", 4, 4),
    ("rwkv6-7b", 4, 4),
    ("zamba2-2.7b", 12, 4),
    ("llama-3.2-vision-90b", 5, 2),
)
FAM_T = 2048  # prefill tokens
# f32 decode batch and prompt (a multiple of the scans' chunk of 128: the
# RWKV6/Mamba2 forwards it is held against refuse other T), then greedy
# tokens from each cache.
FAM_CONS_B, FAM_CONS_T, FAM_GEN = 2, 128, 16
# Prefill gates. Path 4's rule (PREFILL_REL, PREFILL_GAP) holds flash
# against blockwise where both run at f32 (each model runs the pair at f32
# too). In bf16 the families past dense are far more sensitive
# than smollm: a Mamba2 chunk's log-decay cumsum reaches ~-1800, where bf16
# resolves 8, and MoE routing is a discontinuous function of its input, so
# rounding that differs between two runs moves a near-tie token to another
# of the 128 experts (and through the capacity may drop a later one). On
# an H100 80GB HBM3 at 700 W the bf16 flash-vs-blockwise logits of zamba2
# (12 layers) and qwen3-moe (4) differ by 0.69 and 1.09 of max|logit|, with
# 0.44 and 0.62 of positions within 0.04. So the bf16 pair is held to the
# larger of path 4's limit and twice the model's own bf16 error (blockwise
# bf16 against blockwise f32): the kernel may add no more than bf16
# rounding of the model itself does.
# An MoE's logit gates hold path 4's rule on a share of the positions:
# MOE_F32_SHARE for the f32 prefill pair, whose attentions differ by ~1e-6
# (it read 0.99988: one position of 8192 flipped; the limit allows 8), and
# MOE_SHARE for a narrower KV cache against the next wider one (qwen3-moe
# read 0.71 for bf16 against f32, 0.50 for int8 against bf16; the limit is
# a little over half the lower, far above a broken cache's ~0).
MOE_SHARE, MOE_F32_SHARE = 0.3, 0.999
# A narrower decode cache against the next wider one, f32 compute: path 4's
# rules, but for the hybrid. Its random 12-layer Mamba2 stack amplifies the
# bf16 KV cache's rounding in its two attention applications: zamba2 read
# 0.051 of max|logit| on an H100 80GB HBM3 at 700 W (smollm 0.0068), so
# its limit is about twice that, and its gap above twice the reading and
# below twice the limit, as path 4 sets them.
CACHE_RULES = {  # family -> {cache: (against, rel, gap)}
    "dense": {
        "bf16": ("f32", BF16_CACHE_REL, BF16_CACHE_GAP),
        "int8": ("bf16", INT8_CACHE_REL, INT8_CACHE_GAP),
    },
    "hybrid": {"bf16": ("f32", 0.1, 0.15)},
}
FAM_ATTN = {  # (B*Hq, T, hd, hd) that B8/B9 see in path 8's prefills
    "hd128": (4 * 32, FAM_T, 128, 128),  # qwen3-moe (4 x 32 heads), llama (2 x 64)
    "hd80": (4 * 32, FAM_T, 80, 80),  # zamba2's shared block (4 x 32 heads)
}
FAM_ATTN_CASES = tuple(
    case
    for label, shape in FAM_ATTN.items()
    for case in (
        ("flash_attention", f"{label} bf16", shape, "bfloat16"),
        ("flash_attention", f"{label} f32", shape, "float32"),
        ("maclaurin_attention", label, shape, "float32"),
    )
)

# Ninth path: LM training at full width and depth (LM_NAME: 30 layers,
# 162.8 M parameters, cfg.remat on, bf16 compute over f32 masters), random
# weights from SEED, batches from ``lm_token_batches``. Act 1 holds B8's
# gradient (``ChunkedMaclaurin``: the kernel's forward, the plain twin's
# backward) against the twin's own autograd at the training shape and at
# path 8's (128, 2048, 128), each within ATTN_TWIN times the twin's own
# distance from float64 + ATTN_ABS. The losses must fall as the
# reference's tests require (tests/test_train.py:45, :64, :128): the mean
# of the last 5 below that of the first 5 by TRAIN_DROP (AdamW, softmax),
# by COMPRESS_DROP (int8 error feedback) and at all (maclaurin); four
# microbatches within MICRO_TOL of one batch after a step at f32. The
# resume drill follows examples/elastic_restart.py through the launcher:
# the resumed run's loss at the first step after the restored one within
# RESUME_REL of the first run's (the card's atomic adds are not
# bit-deterministic), the restored arrays bit-equal to the checkpoint.
# Step counts: a step takes 1.7 s (softmax: the blockwise attention's f32
# score slabs) and 6.8 s (maclaurin: the twin's backward) on an H100 80GB
# HBM3 at 700 W, so the reference tests' 60 / 20 / 30 steps and a 30-step
# drill (461 s of path 9) are cut to fit the script's time: 20 / 10 / 15,
# a 16-step drill.
TRAIN_B, TRAIN_T = 8, 2048
TRAIN_LR, TRAIN_WARMUP = 3e-3, 5
TRAIN_STEPS, TRAIN_MAC_STEPS, TRAIN_COMPRESS_STEPS = 20, 10, 15
TRAIN_DROP, COMPRESS_DROP, MICRO_TOL, RESUME_REL = 0.3, 0.2, 5e-3, 1e-2
TRAIN_GRAD_CASES = ((TRAIN_B * 9, TRAIN_T, 64, 64), (128, 2048, 128, 128))
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 16, 5, 12
DRILL_ARGS = ("--arch", LM_NAME)  # the launcher's model (full width and depth)
TRAIN_GEN = 16  # greedy tokens from the trained weights

# Fifth path: the serving runtime. Deferred sync: a DEFER_ROWS-row submit
# behind ~DEFER_QUEUED_MS of B2 must return to the host before that work
# ends; DEFER_SUBMITS submits back to back cycle every staging buffer.
DEFER_ROWS, DEFER_QUEUED_MS, DEFER_REPEATS, DEFER_SUBMITS = 1024, 20.0, 5, 9
RT_OPTS = dict(min_bucket=32, max_batch=1024)
RT_WAIT_US = 500.0  # a lone request waits at most this long for company
RT_CLIENTS, RT_REQUESTS, RT_MAX_ROWS = 8, 40, 8  # clients x requests of 1-8 rows
RT_TOL = 2e-4  # coalesced against direct: rtol, and atol x max|score|
RT_QUEUE_ROWS = 256  # the admission bound
RT_BURST = (4, 40, 8)  # overload: threads x requests x rows, past the bound
RT_SLOW_STEP_S = 0.02  # the service time the fault injector pins in the burst
RT_BREAKER = dict(fail_threshold=3, reset_after_s=0.3)
# Sixth path: the HTTP front door over the runtime, at path 5's settings
# (RT_OPTS, RT_WAIT_US, RT_QUEUE_ROWS, RT_CLIENTS x RT_REQUESTS of 1 to
# RT_MAX_ROWS rows, RT_TOL). Refusals: a tenant whose request bucket holds
# HTTP_ACME_BURST tokens and refills ~never gets HTTP_ACME_REQUESTS; then
# HTTP_FLOOD (client threads x requests x rows, each thread one keep-alive
# connection) against RT_SLOW_STEP_S flushes, up to 512 rows in flight
# against the RT_QUEUE_ROWS bound.
HTTP_ACME_BURST, HTTP_ACME_REQUESTS = 3, 6
HTTP_FLOOD = (64, 4, 8)
# Drift: path 1's model scores b alone beyond its envelope (1/(16 gamma^2 msq)
# is ~2000x its rows' |z|^2 at the paper's gamma), so no family can heal a
# drift there. The drift act serves its own model at the same width: path
# 3's 10 Gaussian classes, DRIFT_N_SV SVs with each head's alpha the class
# indicator less its mean, gamma at DRIFT_GAMMA_SHARE of gamma_max (the
# envelope just covers the SVs); rows scaled by DRIFT_SCALE leave it. The
# heal's budget and basis are examples/svm_runtime.py's.
DRIFT_N_SV, DRIFT_GAMMA_SHARE, DRIFT_SCALE, DRIFT_ROWS = 16384, 0.8, 1.5, 512
DRIFT_BUDGET = dict(max_err=0.2, metric="mean_abs", relative=True)
DRIFT_FEATURES, DRIFT_THRESHOLD, DRIFT_AGREEMENT = 4096, 0.25, 0.9
# Seventh path: scale-out on the card. Path 1's f32 artifact published
# with SCALE_REPLICAS replicas on a runtime at path 5's settings, served
# path 5's plan; a scripted fault on one of 3 replicas; head-sharded and
# SV-sharded engines on a mesh of SCALE_SHARDS x the one card (a logical
# split: S launches and a gather against one launch). Extreme multiclass:
# the reference example's one-vs-rest model (EXTREME = K, d, n_sv, rows).
SCALE_REPLICAS = (1, 2, 4)
SCALE_FAULT_REQUESTS = 8
SCALE_SHARDS = 4
SCALE_FEATURES = 4096
EXTREME = (4096, 32, 64, 256)
EXTREME_FF_FEATURES = 64


# Tenth path: the tuning table on the card, and placement by the
# partitioning rules. The engine's buckets of paths 1-3 and B2's fallback
# buckets, the kernels the table must hold entries for, and qwen3-moe at
# path 8's depth cut placed on a (data, model) mesh of 2 x 2 slots of the
# card under three rule sets.
TUNED_BUCKETS = (32, 64, 128, 256, 512, 1024)
TUNED_B2_BUCKETS = (32, 64, 128, 256)
TUNED_KERNELS = ("quadform", "quadform_q8", "rbf_pred", "rff_score", "rff_score_q8", "fwht", "fwht_q8")
TUNED_WRAPPERS = (  # their wrappers' names in ``build.counts()``: B1-B7
    "quadform_heads",
    "quadform_heads_q8",
    "rbf_scores",
    "rff_score",
    "rff_score_q8",
    "fastfood_score",
    "fastfood_score_q8",
)
PLACE_MODEL = ("qwen3-moe-30b-a3b", 4)
PLACE_MESH = ((2, 2), ("data", "model"))
PLACE_RULES = ("DEFAULT_RULES", "TP_ONLY_RULES", "EP_DATA_RULES")
# Eleventh path: the rule-sharded LM steps (``launch.specs.build_cell``,
# ``repro_torch.sharding``) on a (data, model) mesh of 2 x 2 slots of the
# one card, at full width, each held against the one-device step of the
# same weights on the same card, at f32 (the comparisons' tolerance is f32
# reduction order, so both sides compute in f32; serving cells keep the
# reference's bf16 weights, and the one-device step runs on the same
# values). (model, layers): qwen3-moe 4 of 48 served (12.46 GB f32; flash,
# so B9 launches on each position's 16 of 32 heads) and 2 of 48 trained
# under DEFAULT and EP_DATA rules (parameters, gradients and two moments
# ~30 GB; maclaurin at T = 1024, so B8 launches on each head shard);
# smollm-135m at full depth trained under DP_ONLY and DEFAULT (576 q
# columns cut mid-head) and decoded under TP_ONLY (3 kv heads: the cache
# cut along its sequence).
SHARD_MESH = PLACE_MESH
SHARD_SERVE, SHARD_TRAIN = ("qwen3-moe-30b-a3b", 4), ("qwen3-moe-30b-a3b", 2)
SHARD_SMALL = (LM_NAME, 30)
SHARD_PREFILL = (2, 2048)  # global batch, tokens
SHARD_DECODE = (2, 64, 4)  # global batch, cache slots, greedy steps
SHARD_TRAIN_SHAPE = {"qwen3-moe-30b-a3b": (2, 1024), LM_NAME: (4, 1024)}
SHARD_TRAIN_RULES = {
    "qwen3-moe-30b-a3b": ("DEFAULT_RULES", "EP_DATA_RULES"),
    LM_NAME: ("DP_ONLY_RULES", "DEFAULT_RULES"),
}
SHARD_ATTN_CASES = (  # what one head shard gives B9 (prefill) and B8 (training)
    ("flash_attention", "head shard f32", (16, 2048, 128, 128), "float32"),
    ("maclaurin_attention", "head shard", (16, 1024, 128, 128), "float32"),
)
# Sharded against one device, both f32: logits within SHARD_REL of
# max|logit| (path 4's top-1 rule at SHARD_GAP; an MoE's on MOE_F32_SHARE
# of the positions, as path 8 holds its f32 pair); loss, its parts and
# the learning rate within SHARD_RTOL; the gradient norm within
# SHARD_NORM_RTOL; updated parameters within SHARD_ATOL + SHARD_RTOL |p|,
# but where the gradient's running RMS (AdamW's bias-corrected sqrt(v))
# is below SHARD_TINY_GRAD: there the update lr m / (sqrt(v) + eps) moves
# by lr times the gradient's relative rounding, which is large where the
# gradient is a cancellation near 0 (an H100 80GB HBM3 at 700 W read ~1000
# such elements of qwen3-moe's 1.9 B, up to 0.24 lr, each of gradient RMS
# below 2.5e-7, where typical gradient entries are ~1e-4). Every element
# within SHARD_LR_STEPS times the learning rate.
SHARD_REL, SHARD_GAP = 1e-4, 1e-3
SHARD_RTOL, SHARD_ATOL, SHARD_NORM_RTOL = 1e-5, 1e-6, 1e-4
SHARD_TINY_GRAD, SHARD_LR_STEPS = 1e-5, 2.0
# Twelfth path: the sharded steps of the families past dense and MoE and
# of the optimizer options, on path 11's 2 x 2 slots of the card, f32
# compute at published widths with the depth cut (SHARD12_DEPTH: layers
# run of the published depth), each held against the one-device step of
# the same weights on the same card at path 11's gates. rwkv6 2 of 32
# (0.97 B parameters); zamba2 6 of 54, one group of 6 Mamba2 layers and
# the shared attention block (0.51 B); llama-3.2-vision 5 of 100, one
# superblock of 4 self layers and 1 cross layer over 4096 random image
# tokens a row (6.4 B, 25.7 GB f32); musicgen 4 of 48 (0.16 B); qwen3-moe
# 2 of 48 (1.87 B). A cut model is small enough that ``choose_rules``
# would pick other rules than for the published one, so each cell names
# the published model's pick: DEFAULT for rwkv6, zamba2 and musicgen
# training and llama-vision serving, TP_ONLY for rwkv6 and zamba2
# serving; qwen3-moe trains under EP_DATA with Adafactor, two
# microbatches and compressed gradients, the options of arctic-480b's
# train cell.
SHARD12_DEPTH = {
    "rwkv6-7b": 2,
    "zamba2-2.7b": 6,
    "llama-3.2-vision-90b": 5,
    "musicgen-medium": 4,
    "qwen3-moe-30b-a3b": 2,
}
SHARD12_SERVE = (  # (model, rules, prefill dtype, batch, prefill tokens, decode slots, steps)
    ("rwkv6-7b", "TP_ONLY_RULES", "float32", 2, 256, 64, 4),
    ("zamba2-2.7b", "TP_ONLY_RULES", "float32", 2, 1024, 64, 4),
    ("llama-3.2-vision-90b", "DEFAULT_RULES", "bfloat16", 2, 1024, 64, 4),
)
SHARD12_TRAIN = (  # (model, rules, optimizer options, batch, tokens, config changes)
    ("rwkv6-7b", "DEFAULT_RULES", {}, 2, 256, {}),
    ("zamba2-2.7b", "DEFAULT_RULES", {}, 2, 1024, {"attention_backend": "maclaurin"}),
    ("musicgen-medium", "DEFAULT_RULES", {}, 4, 1024, {}),
    (
        "qwen3-moe-30b-a3b",
        "EP_DATA_RULES",
        {"name": "adafactor", "microbatches": 2, "compress_grads": True},
        4,
        512,
        {},
    ),
)
SHARD12_ATTN = {  # (B*Hq, T, hd, hd) one head shard gives B8/B9 on path 12
    "zamba2 shard": (16, 1024, 80, 80),  # one row a data shard, 16 of 32 heads
    "llama-vision shard": (32, 1024, 128, 128),  # one row, 32 of 64 heads
}
SHARD12_ATTN_CASES = tuple(
    case
    for label, shape in SHARD12_ATTN.items()
    for case in (
        ("flash_attention", f"{label} f32", shape, "float32"),
        ("flash_attention", f"{label} bf16", shape, "bfloat16"),
        ("maclaurin_attention", label, shape, "float32"),
    )
)
# A step beyond these gates (the gradient norm beyond SHARD_NORM_RTOL, or
# a parameter beyond the tolerance where its gradient is not tiny) is held
# instead against the model's own sensitivity to rounding
# (``one_device_f64``: the one-device step at float64 compute from the
# same state, no compressed gradients): the sharded norm within twice the
# one-device f32 norm's distance from it plus SHARD_NORM_RTOL, the
# parameters' max|delta| within twice the one-device f32 step's from it
# (plus SHARD_ATOL) and no more than twice as many beyond the tolerance.
# rwkv6's gradient is ill-conditioned: an H100 80GB HBM3 at 700 W read its
# one-device f32 norm 5.1e-4 of the norm off the float64-compute one, the
# sharded norm 7e-5 off it, and 27781 of 0.97 B parameters beyond the
# tolerance (up to 0.29 lr).
# Adafactor's update is no lr-sized step (u / max(1, RMS(u))), and an
# int8 code may flip at a rounding tie under compressed gradients (the
# CPU tests find a handful of such elements a leaf), so under those
# options at most SHARD12_OFF_SHARE of the parameters may lie beyond
# SHARD_ATOL + SHARD_RTOL |p|; under AdamW path 11's rule holds.
SHARD12_OFF_SHARE = 1e-4
# Thirteenth path: the last two rule sets on path 11's 2 x 2 slots, f32
# compute at published widths, each step held against the one-device step
# at path 11's gates. SP_RULES (DEFAULT with the residual cut along the
# sequence over "model" between blocks): qwen3-moe (2 of 48 layers) served
# as a 2 x 2048 flash prefill (B9 on 16-head shards), beside the same cell
# under DEFAULT_RULES for the residual a position and the peak, and
# trained at 2 x 1024 with the maclaurin backend (B8 on 16-head shards);
# zamba2 (6 of 54, one group) and smollm-135m (all 30 layers, 9 heads:
# the attention spread over the group by batch rows) trained. EP_DP_RULES
# (the batch over data and model, the experts over data, every ffn dim
# over model and gathered before its block): qwen3-moe trained at 4 x 1024, maclaurin (B8 on all
# 32 heads of one position's row), served as a 4 x 1024 flash prefill (B9
# there) and 4 greedy decode steps. Path 13's peak stays within
# SHARD13_PEAK, path 11's highest: EP_DP replicates the embedding and the
# LM head (2.5 GB at f32) with their moments and gradients on all four
# positions, and its training at 2 of 48 layers peaked at 73.7 GB (an
# H100 80GB HBM3 at 700 W), so it trains 1 of 48. Each prefill cell runs
# once before the timed one (the first sharded prefill of a process took
# 11.4 s there, the same cell again 0.18).
SHARD13_SERVE = ("qwen3-moe-30b-a3b", 2)  # model, layers
SHARD13_PREFILL = (  # (batch, tokens, rule sets)
    (2, 2048, ("SP_RULES", "DEFAULT_RULES")),
    (4, 1024, ("EP_DP_RULES",)),
)
SHARD13_DECODE = ("EP_DP_RULES", 4, 64, 4)  # rules, batch, cache slots, greedy steps
MACLAURIN = {"attention_backend": "maclaurin"}
SHARD13_TRAIN = (  # (model, layers, rules, batch, tokens, config changes)
    ("qwen3-moe-30b-a3b", 2, "SP_RULES", 2, 1024, MACLAURIN),
    ("qwen3-moe-30b-a3b", 1, "EP_DP_RULES", 4, 1024, MACLAURIN),
    ("zamba2-2.7b", 6, "SP_RULES", 2, 1024, MACLAURIN),
    (LM_NAME, 30, "SP_RULES", 4, 1024, {}),
)
SHARD13_ATTN_CASES = (  # what one EP_DP position gives B9 and B8: 32 heads of its row
    ("flash_attention", "EP_DP batch block f32", (32, 1024, 128, 128), "float32"),
    ("maclaurin_attention", "EP_DP batch block", (32, 1024, 128, 128), "float32"),
)
SHARD13_PEAK = 72e9
# Path 14: the dry run (``launch.dryrun``: the cell traced on fake devices
# at one and two periods of layers, extrapolated) held against the same
# cell run on the card under the same recorder (``launch.op_cost``). On a
# 1 x 1 mesh of the card, smollm-135m at full width and depth: path 9's
# training batch, a bf16 flash prefill (B9) and a maclaurin prefill (B8);
# flops and launches equal, the peak over the placed arguments within
# DRY_PEAK_REL, the median of DRY_TIMED steps after a warm-up against the
# roofline bound. On path 11's 2 x 2 slots, path 11's qwen3-moe EP_DATA
# training and path 13's SP flash prefill: flops and every collective call
# (kind, bytes, group, count) equal. On 1 x 4 slots, smollm-135m at full
# width (2 of 30 layers), whose 9 q heads do not divide model = 4: a bf16
# flash prefill 4 x 2048 and a DEFAULT_RULES training step, the attention
# spread over the group's members by batch rows (``spmd.Lockstep.spread``),
# so B9 launches once a member a layer. On 4 x 2 slots, DRY_CLASS: 8
# positions in 4 classes, so the dry run traces 4 and copies their counts
# to the others (``spmd.class_reps``), its totals over every position held
# equal to the real step's. On path 11's 2 x 2 slots, DRY_F11: smollm-135m's
# maclaurin decode under TP_ONLY, whose 3 kv heads do not divide model = 2
# (its ``MacState`` a replica over "model"), held against the one-device
# decode at path 11's f32 gate and against its dry run. And the production
# cells, DRY_CELLS, on the 16 x 16 and 2 x 16 x 16 meshes of fake devices,
# traced one after another by ``python -m repro_torch.launch.dryrun`` in a
# process group of their own while the card runs the rest (at most
# DRY_CELL_S; one at a time, so that their depth workers leave the main
# process cores); that group is stopped while a 1 x 1 step is timed, and
# each such step is timed again beside it.
DRY_SMALL = (  # (label, config changes, (shape name, T, B, kind))
    ("train", {}, ("path14_train", 2048, 8, "train")),
    ("flash prefill", {"attention_impl": "flash"}, ("path14_prefill", 2048, 4, "prefill")),
    ("maclaurin prefill", MACLAURIN, ("path14_prefill", 2048, 4, "prefill")),
)
DRY_SLOTS = (  # (label, model, layers, config changes, rules, (shape name, T, B, kind), mesh)
    ("qwen3-moe EP_DATA train", "qwen3-moe-30b-a3b", 2, dict(dtype="float32", **MACLAURIN),
     "EP_DATA_RULES", ("path14_train", 1024, 2, "train"), (2, 2)),
    ("qwen3-moe SP flash prefill", "qwen3-moe-30b-a3b", 2, dict(dtype="float32", attention_impl="flash"),
     "SP_RULES", ("path14_prefill", 2048, 2, "prefill"), (2, 2)),
    ("smollm 1x4 flash prefill", LM_NAME, 2, {"attention_impl": "flash"},
     "TP_ONLY_RULES", ("path14_prefill", 2048, 4, "prefill"), (1, 4)),
    ("smollm 1x4 DEFAULT train", LM_NAME, 2, {}, "DEFAULT_RULES", ("path14_train", 2048, 4, "train"), (1, 4)),
)
DRY_ATTN_CASES = (  # what B9 gets in the 1 x 4 prefill: one member's row of all 9 heads
    ("flash_attention", "spread row bf16", (9, 2048, 64, 64), "bfloat16"),
)
DRY_CLASS = ("qwen3-moe class-traced DEFAULT train", "qwen3-moe-30b-a3b", 1, dict(dtype="float32", **MACLAURIN),
             "DEFAULT_RULES", ("path14_train", 1024, 4, "train"), (4, 2))
DRY_F11 = ("smollm maclaurin TP_ONLY decode", 30, dict(dtype="float32", **MACLAURIN), "TP_ONLY_RULES",
           ("path14_decode", 64, 2, "decode"), 4)  # ..., greedy steps
DRY_PEAK_REL = 0.15
DRY_LEVEL = 0.01  # the most a position's predicted peak may lie above another's in a dry_slots cell
DRY_TIMED = 3
DRY_CELLS = (  # (arch, shape, on 2 x 16 x 16), traced in this order
    (LM_NAME, "train_4k", False),
    (LM_NAME, "decode_32k", False),
    (LM_NAME, "decode_32k", True),
)
DRY_CELL_S = 600
# PyTorch's caching allocator splits a cached block for a request only
# where more than 1 MiB would remain, so a shard may take up to this much
# more than its bytes: the card's allocated memory grows by the bytes
# placed, and by less than this a shard more.
ALLOC_SLACK = 1 << 20


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def phase(name: str, **fields) -> None:
    print(f"{name}: {json.dumps(fields, sort_keys=True)}", flush=True)


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 20) -> float:
    """Time of one call when the card, not the host, sets the pace: CUDA
    events around ``calls`` calls queued behind a kernel that spins for
    ~50 ms, so that no launch waits on the host. Where a call's kernels
    take less time than the host takes to launch them, ``time_ms`` reads
    the host's rate and this the card's (the card's own gaps between
    kernels included). No profiler: once started, ``torch.profiler`` slows
    every later launch of the process."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # clock cycles: ~50 ms, while the calls queue up
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_ms(fn, calls: int = 20) -> float:
    """Host time of one call, up to its return (no synchronize): the rate
    at which the host can launch it."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """Least time in ms for the work, and which of the two rates sets it
    (operations at ``peak``, fp32 unless stated)."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def quadform_work(n: int, k: int, d: int) -> tuple[float, float]:
    """(flops, bytes) of kernel B1: the K quadratic forms, the linear terms,
    |z|^2 and the epilogue; each input read once, each output written once."""
    flops = 2.0 * n * k * d * d + 2.0 * n * k * d + 2.0 * n * d + 6.0 * n * k
    nbytes = 4.0 * (n * d + k * d * d + k * d + 4 * k) + 4.0 * n * k + 4.0 * n + n * k
    return flops, nbytes


def rbf_work(n: int, m: int, k: int, d: int) -> tuple[float, float]:
    """(flops, bytes) of kernel B2: the distance products, both row norms,
    5 operations per distance (add, subtract, clamp, scale, exp) and the K
    accumulations."""
    flops = 2.0 * n * m * d + 2.0 * (n + m) * d + 5.0 * n * m + 2.0 * n * m * k
    nbytes = 4.0 * (n * d + m * d + k * m + k + 1) + 4.0 * n * k
    return flops, nbytes


def quadform_q8_work(n: int, k: int, d: int) -> tuple[float, float]:
    """(flops, bytes) of kernel B3: B1's work plus one scale multiply per
    (row, head, column), with the Hessian at 1 byte and the (K, d)
    column scales read once."""
    flops, _ = quadform_work(n, k, d)
    flops += 1.0 * n * k * d
    nbytes = 4.0 * (n * d + k * d + k * d + 4 * k) + 1.0 * k * d * d
    nbytes += 4.0 * n * k + 4.0 * n + n * k
    return flops, nbytes


def rff_work(n: int, f: int, k: int, d: int, w_bytes: int) -> tuple[float, float]:
    """(flops, bytes) of kernels B4 (``w_bytes`` 4) and B5 (1): the
    projection, one cos per (row, feature), the readout and the bias; W
    and the readout at ``w_bytes`` a value, B5's row and head scales f32."""
    flops = 2.0 * n * f * d + 2.0 * n * f * k + 1.0 * n * f + 1.0 * n * k
    nbytes = 4.0 * (n * d + f + k + n * k) + w_bytes * (f * d + k * f)
    if w_bytes == 1:
        nbytes += 4.0 * (f + k)
    return flops, nbytes


def fastfood_work(
    n: int, f: int, k: int, d: int, w_bytes: int
) -> tuple[float, float, float]:
    """(fp32 flops, f32-product flops, bytes) of kernels B6 (``w_bytes`` 4)
    and B7 (1). fp32: per row and stack two transforms of d' log2 d' adds,
    the three diagonals, the phase add and the cos (the gather is a move,
    not an operation), the bias (B7: the stack and head scales too).
    Products: the readout's 2 n F K, bound at the 3xTF32 rate. Bytes: Z, the
    O(F) operators (perm and phase 4 bytes in B6, 2 in B7), the readout, the
    scales and the output."""
    dd = 1 << max(1, (d - 1).bit_length())
    per_elem = 2.0 * (dd.bit_length() - 1) + 3.0 + 2.0
    flops = n * f * per_elem + 1.0 * n * k
    products = 2.0 * n * f * k
    small = 4 if w_bytes == 4 else 2
    nbytes = 4.0 * (n * d + k + n * k) + f * (3 * w_bytes + 2 * small) + w_bytes * k * f
    if w_bytes == 1:
        flops += 1.0 * n * f + 1.0 * n * k
        nbytes += 4.0 * (f // dd + k)
    return flops, products, nbytes


def fastfood_bound(n: int, f: int, k: int, d: int, w_bytes: int) -> tuple[float, str]:
    """B6/B7's least time in ms: their fp32 work at the fp32 rate plus their
    readout's products at the 3xTF32 rate, or their bytes, whichever is
    longer."""
    flops, products, nbytes = fastfood_work(n, f, k, d, w_bytes)
    t_ops = (flops / PEAK_FP32_FLOPS + products / PEAK_F32_3XTF32) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_args(art):
    """(plain twin, kernel wrapper, operands after Z) of the kernel that
    serves ``art``, for every family, projection and dtype."""
    from repro_torch.core.families import maclaurin
    from repro_torch.kernels.fwht import kernel as ff
    from repro_torch.kernels.quadform import kernel as qf
    from repro_torch.kernels.rff_score import kernel as rk

    a = art.arrays
    q8 = art.dtype == "int8"
    if art.meta["kind"] == "quadform":
        rest = (a["c"], a["b"], a["gamma"], a["msq"])
        if not q8:
            args = (a["M"], a["v"]) + rest
            return qf.quadform_heads_torch, qf.quadform_heads_cuda, args
        args = (a["M"], *maclaurin.q8_operands(art)) + rest
        return qf.quadform_heads_q8_torch, qf.quadform_heads_q8_cuda, args
    if art.meta["projection"] == "fastfood":
        ops = (a["ff_b"], a["ff_g"], a["ff_perm"], a["ff_scale"])
        if not q8:
            args = ops + (a["phase"], a["weights"], a["b"])
            return ff.fastfood_score_torch, ff.fastfood_score_cuda, args
        args = ops + (a["ff_stack_scale"], a["phase"], a["weights"])
        args += (a["weights_scale"], a["b"])
        return ff.fastfood_score_q8_torch, ff.fastfood_score_q8_cuda, args
    if not q8:
        args = (a["W"], a["phase"], a["weights"], a["b"])
        return rk.rff_score_torch, rk.rff_score_cuda, args
    args = (a["W"], a["W_scale"], a["phase"], a["weights"], a["weights_scale"])
    return rk.rff_score_q8_torch, rk.rff_score_q8_cuda, args + (a["b"],)


def twin_tol(twin, args, Zd, ratio: float, floor: float):
    """(twin scores, kernel tolerance, twin's distance from float64) for a
    fourier kernel: ``ratio`` times the twin's distance from its float64
    evaluation, + ``floor``; its readout sums cancel, so no tolerance
    relative to the output holds."""
    import torch

    out0 = twin(Zd, *args)
    d64 = [a if a.dtype == torch.int8 else a.double() for a in args]
    twin_err = max_err(out0, twin(Zd.double(), *d64))
    return out0, ratio * twin_err + floor, twin_err


def plain_scores(art, Zd):
    """The plain twin of ``art``'s kernel on the card: (scores, kernel
    tolerance)."""
    twin, _, args = kernel_args(art)
    if art.meta["kind"] == "quadform":
        s0 = twin(Zd, *args)[0]
        return s0, B1_REL * float(s0.abs().max()) + B1_ABS
    if art.meta["projection"] == "fastfood":
        return twin_tol(twin, args, Zd, FF_TWIN, FF_ABS)[:2]
    return twin_tol(twin, args, Zd, B45_TWIN, B45_ABS)[:2]


def exact64(model, dev):
    """``fn(Z) -> (float64 scores, B2 tolerance)`` for ``model``'s exact
    expansion on the rows of the numpy array ``Z``: the plain twin in
    float64, and B2_TWIN times the fp32 twin's distance from it + B2_ABS."""
    import torch

    from repro_torch.kernels.rbf_pred import kernel as rp

    X64, A64, b64 = model.X.double(), model.alpha_y.double(), model.b.double()
    g64 = float(model.gamma)

    def fn(Z):
        Zd = torch.from_numpy(Z).to(dev)
        ref = rp.rbf_scores_torch(Zd.double(), X64, A64, g64, b64)
        twin = rp.rbf_scores_torch(Zd, model.X, model.alpha_y, model.gamma, model.b)
        return ref.cpu().numpy(), B2_TWIN * max_err(twin, ref) + B2_ABS

    return fn


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def rms(x) -> float:
    return float(x.double().pow(2).mean().sqrt())


def median_request_ms(engine, Z, repeats: int = 10, exact: bool = False) -> float:
    """Median host time of ``engine.submit(Z)`` (``submit_exact`` with
    ``exact``) through labels on the host."""
    submit = engine.submit_exact if exact else engine.submit
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        submit(Z).labels
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_kernel_times(timings: dict) -> None:
    """One ``kernel_time`` line per (kernel, n, F) entry of ``timings``."""
    for (name, n, f), t in timings.items():
        bound_ms, bound_by = t["bound"]
        times = {k: v for k, v in t.items() if k.endswith("_ms") or k == "ms"}
        phase(
            "kernel_time",
            kernel=name,
            n=n,
            f=f,
            bound_ms=bound_ms,
            bound_by=bound_by,
            **times,
        )


def check_fourier_kernel(phase_name, launch, twin, args, Z, ratio, floor, **fields):
    """Hold a fourier kernel's wrapper ``launch`` (B4-B7) against its plain
    twin on ``Z``: max|Δ| within ``ratio`` times the twin's distance from
    float64 + ``floor``, and the same bits on a second launch. Prints the
    phase line and returns its results."""
    import torch

    out = launch(Z, *args)
    again = launch(Z, *args)
    out0, tol, twin_err = twin_tol(twin, args, Z, ratio, floor)
    torch.cuda.synchronize()
    err = max_err(out, out0)
    res = dict(
        max_abs_err=err,
        twin_max_abs_err_vs_float64=twin_err,
        tol=tol,
        max_abs_ref=float(out0.abs().max()),
        same_bits_again=bool(torch.equal(again, out)),
    )
    phase(phase_name, **fields, **res)
    what = " ".join(f"{k}={v}" for k, v in fields.items())
    check(err <= tol, f"{what}: {err} > {tol}")
    check(res["same_bits_again"], f"{what}: bits differ run to run")
    return res


def push_out(Z, msq: float, gamma: float):
    """Scale each row of ``Z`` to msq * |z|^2 = OUTSIDE / (16 gamma^2)."""
    zsq = (Z.astype(np.float64) ** 2).sum(1, keepdims=True)
    target = OUTSIDE * 0.0625 / (gamma * gamma * msq)
    return (Z * np.sqrt(target / zsq)).astype(np.float32)


_FUNCTION = re.compile(r"Function : (\S+)")
_OPCODE = re.compile(r"\b((?:HGMMA|HMMA|LDSM|LDGSTS)\.?[\w.]*)")
_USAGE = re.compile(r"Function ([^\s:]+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)")


def read_compiled(sass: str, usage: str) -> dict[str, dict]:
    """Per function of a ``cuobjdump -sass`` listing, the count of each
    tensor-core MMA (HMMA, HGMMA), ldmatrix (LDSM) and cp.async (LDGSTS)
    opcode; with its registers and its stack and local bytes (spills) from
    the ``cuobjdump -res-usage`` text."""
    kernels: dict[str, dict] = {}
    current = None
    for line in sass.splitlines():
        if m := _FUNCTION.search(line):
            current = kernels.setdefault(m.group(1), {}).setdefault("sass", {})
        elif current is not None:
            for op in _OPCODE.findall(line):
                current[op] = current.get(op, 0) + 1
    for name, regs, stack, local in _USAGE.findall(usage):
        kernels.setdefault(name, {}).update(
            registers=int(regs), stack_bytes=int(stack), local_bytes=int(local)
        )
    return kernels


# Per library: the name fragment of every function whose products must run
# on the tensor cores, of those that must not (none is left since B3 joined
# B1's template), and whether the tensor-core bodies must have no stack or
# local memory (B1/B3, B4/B5, B6/B7: every d' instantiation).
TENSOR_CORE_BODIES = {
    "fastfood-": ("fastfood_tile", None, True),
    "flash_attn-": ("attn_fwd", None, False),
    "maclaurin_attn-": ("attn_fwd", None, False),
    "quadform-": ("quadform_tf32", None, True),
    "rbf_pred-": ("rbf_tf32", None, False),
    "rff_score-": ("rff_tf32", None, True),
}


def compiled_bodies(
    lib: Path, cuobjdump: Path, mma_in: str, simt: str | None, spill_free: bool = False
) -> dict:
    """What nvcc made of a built library's kernel bodies (``read_compiled``)
    whose names hold ``mma_in`` or ``simt``; fails unless each ``mma_in``
    instantiation runs its products on the tensor cores (with ``spill_free``,
    with no stack or local bytes) and each ``simt`` one holds no tensor-core
    MMA."""
    sass, usage = (
        subprocess.run([str(cuobjdump), flag, str(lib)], capture_output=True, text=True, check=True).stdout
        for flag in ("-sass", "-res-usage")
    )
    found = read_compiled(sass, usage)
    bodies = {n: k for n, k in found.items() if mma_in in n or (simt and simt in n)}
    check(any(mma_in in n for n in bodies), f"{lib.name}: no {mma_in} instantiation in the SASS")
    for name, k in bodies.items():
        mma = sum(c for op, c in k.get("sass", {}).items() if "MMA" in op)
        if mma_in in name:
            check(mma > 0, f"{lib.name}: {name} holds no tensor-core MMA")
            if spill_free:
                spill = k.get("stack_bytes", 0) + k.get("local_bytes", 0)
                check(spill == 0, f"{lib.name}: {name} has {spill} stack/local bytes")
        else:
            check(mma == 0, f"{lib.name}: {name} holds a tensor-core MMA")
    return bodies


def route_sweep(dev, out_path: Path) -> None:
    """Time kernel B8's two routes apart (``force_route``) over head counts,
    lengths and widths, into ``out_path`` as JSON lines: the measurements
    ``maclaurin_attn.route``'s cost model is fitted to. Each (route, width,
    heads) series runs T upward until one call passes SWEEP_MS."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.maclaurin_attn import kernel as ma

    build.build_all(["maclaurin_attn.cu"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    widths = [(d, d) for d in ma.HEAD_DIMS] + [(16, 64), (32, 20), (64, 24), (64, 160), (128, 64)]
    with open(out_path, "w") as f:
        for d, dv in widths:
            for bh in SWEEP_HEADS:
                for taken in ma.ROUTES:
                    for t in SWEEP_T:
                        if 4 * bh * t * (2 * d + 2 * dv) > 8e9:
                            break
                        q, k = (torch.randn((bh, t, d), generator=gen, device=dev) for _ in range(2))
                        v = torch.randn((bh, t, dv), generator=gen, device=dev)
                        launch = lambda: ma.maclaurin_attention_cuda(q, k, v, force_route=taken)  # noqa: E731
                        once = time_ms(launch, iters=1, warm=1)
                        iters = max(1, min(10, int(SWEEP_MS / 2 / max(once, 1e-3))))
                        ms = time_ms(launch, iters=iters, warm=0) if iters > 1 else once
                        row = dict(route=taken, bh=bh, t=t, d=d, dv=dv, ms=ms)
                        f.write(json.dumps(row) + "\n")
                        phase("route_sweep", **row)
                        del q, k, v
                        if once > SWEEP_MS:
                            break
    torch.cuda.empty_cache()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside it", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--route-sweep"]:
        route_sweep(torch.device("cuda"), Path(sys.argv[2]))
        return 0
    attn = ("flash_attn.cu", "maclaurin_attn.cu")
    single = {  # flag: (the path, the sources it builds)
        "--eighth-path": (eighth_path, attn),
        "--ninth-path": (ninth_path, ("maclaurin_attn.cu",)),
        "--tenth-path": (tenth_path, ("quadform.cu", "rbf_pred.cu", "rff_score.cu", "fastfood.cu")),
        "--eleventh-path": (eleventh_path, attn),
        "--twelfth-path": (twelfth_path, attn),
        "--thirteenth-path": (thirteenth_path, attn),
        "--fourteenth-path": (fourteenth_path, attn),
    }
    if sys.argv[1:2] and sys.argv[1] in single:
        from repro_torch.kernels import build

        path, sources = single[sys.argv[1]]
        print(card_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build_all(list(sources))
        got = path(torch.device("cuda"))
        # path 10 returns its launches; the others (kernels, launches)
        print(json.dumps({"kernels": got[0]} if isinstance(got, tuple) else {"launches": got}), flush=True)
        return 0
    if sys.argv[1:2] == ["--submit-deferral"]:
        from repro_torch.core import families
        from repro_torch.kernels import build
        from repro_torch.serve import SVMEngine

        dev = torch.device("cuda")
        print(card_line(), flush=True)
        build.build_all(["quadform.cu", "rbf_pred.cu"])
        svm, X_te, _, _ = smoke_model(dev)
        engine = SVMEngine(families.maclaurin.compile(svm), svm, device=dev)
        phase("submit_deferral", **submit_deferral(dev, engine, svm, X_te))
        return 0
    card = card_line()
    kernels = run(torch.device("cuda"))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def smoke_model(dev, n_sv: int = N_SV):
    """The random mnist-width model of paths 1, 2 and 5: (svm, test rows,
    dataset spec, the generator its ``alpha_y`` was drawn from)."""
    from repro_torch import convert
    from repro_torch.data.synthetic import make_dataset

    X_tr, _, X_te, _, spec = make_dataset("mnist", scale=0.3, seed=SEED)
    rng = np.random.default_rng(SEED)
    X = X_tr[:n_sv]
    alpha_y = rng.standard_normal((K, n_sv))
    alpha_y = (alpha_y - alpha_y.mean(1, keepdims=True)).astype(np.float32)
    gamma = np.float32(spec.paper_gamma)
    sv_sq = (X.astype(np.float64) ** 2).sum(1)
    b = -(alpha_y.astype(np.float64) @ np.exp(-float(gamma) * sv_sq))
    svm = convert.svm_from_numpy(X, alpha_y, b.astype(np.float32), gamma, device=dev)
    return svm, X_te, spec, rng


def submit_deferral(dev, engine, svm, X_te) -> dict:
    """Deferred sync, held on the card: the host return of
    ``engine.submit`` for DEFER_ROWS rows queued behind ~DEFER_QUEUED_MS
    of kernel B2 (n=256 against the model's SVs), beside that queued work's
    device time and, as the control, the host return of a blocking copy
    of the same rows from pageable memory behind the same work. Then
    DEFER_SUBMITS submits of different rows back to back behind queued
    work, each result held bit for bit against the same rows submitted
    with nothing queued (a staging buffer reused while its copy is pending
    would corrupt one). Median of DEFER_REPEATS for each time."""
    import torch

    from repro_torch.kernels.rbf_pred import kernel as rp

    Zr = torch.from_numpy(X_te[:256].copy()).to(dev)
    X, A, g, bias = svm.X, svm.alpha_y, svm.gamma, svm.b
    one = time_ms(lambda: rp.rbf_scores_cuda(Zr, X, A, g, bias), iters=5)
    calls = max(1, round(DEFER_QUEUED_MS / one))
    Zs = np.ascontiguousarray(X_te[:DEFER_ROWS])
    engine.submit(Zs).labels  # warm: the bucket's config, staging buffers

    def behind_queued(fn):
        """(host ms of fn(), device ms of the work queued before it)."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        mid = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            rp.rbf_scores_cuda(Zr, X, A, g, bias)
        mid.record()
        t0 = time.perf_counter()
        out = fn()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return host, start.elapsed_time(mid), out

    submit, queued, pageable = [], [], []
    for _ in range(DEFER_REPEATS):
        h, q, r = behind_queued(lambda: engine.submit(Zs))
        r.labels
        submit.append(h)
        queued.append(q)
        pageable.append(behind_queued(lambda: torch.from_numpy(Zs).to(dev))[0])
    sets = [X_te[i : i + DEFER_ROWS].copy() for i in range(DEFER_SUBMITS)]
    want = [engine.submit(Zi).values for Zi in sets]
    got = behind_queued(lambda: [engine.submit(Zi) for Zi in sets])[2]
    equal = all(np.array_equal(r.values, w) for r, w in zip(got, want))
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return dict(
        rows=DEFER_ROWS,
        queued_b2_launches=calls,
        submit_host_ms=med(submit),
        device_ms=med(queued),
        pageable_copy_host_ms=med(pageable),
        submits_behind_queue=DEFER_SUBMITS,
        results_equal_unqueued=equal,
    )


def run_threads(target, args) -> None:
    """``target(*a)`` on one thread per entry of ``args``; fails the phase
    if any raised or is still running after 300 s."""
    import threading

    errors = []

    def body(*a):
        try:
            target(*a)
        except BaseException as e:  # surfaced after the join
            errors.append(e)

    threads = [threading.Thread(target=body, args=a) for a in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    if errors:
        raise errors[0]


def read(result) -> tuple:
    """(values, valid, labels) of an engine or runtime result, on the host."""
    return result.values, result.valid, result.labels


def nearest_rank(xs, q: float) -> float:
    """The q-th percentile of the sorted ``xs``, nearest rank (as the
    runtime's telemetry takes it)."""
    return xs[min(len(xs) - 1, max(0, int(np.ceil(q / 100 * len(xs))) - 1))]


def runtime_plan(rng, pool_rows: int) -> list[list[tuple]]:
    """Paths 5-7's traffic: RT_CLIENTS clients of RT_REQUESTS requests, each
    (alias, indices of 1 to RT_MAX_ROWS rows of a pool of ``pool_rows``),
    the alias one of path 5's two tenants, drawn from ``rng``."""
    return [
        [
            (
                ("mnist-f32", "mnist-int8")[int(rng.integers(0, 2))],
                rng.choice(pool_rows, size=int(rng.integers(1, RT_MAX_ROWS + 1))),
            )
            for _ in range(RT_REQUESTS)
        ]
        for _ in range(RT_CLIENTS)
    ]


def drive_clients(work, pool, fn):
    """Every client's requests of ``work`` through ``fn(alias, rows)``, one at
    a time per client thread: (results, sorted per-request host ms, wall
    seconds)."""
    import threading

    got = [[None] * len(w) for w in work]
    lat, lock = [], threading.Lock()

    def client(c):
        for k, (a, idx) in enumerate(work[c]):
            t = time.perf_counter()
            got[c][k] = read(fn(a, pool[idx]))
            with lock:
                lat.append((time.perf_counter() - t) * 1e3)

    t = time.perf_counter()
    run_threads(client, [(c,) for c in range(len(work))])
    return got, sorted(lat), time.perf_counter() - t


def hold_answers(work, pool, got, want, exact) -> tuple[float, int, float]:
    """Hold every answer of ``got`` against ``want`` (values within RT_TOL,
    equal labels and validity) and the rows out of the envelope against
    float64's labels: (worst |delta| / tolerance, rows out of the envelope,
    their label agreement)."""
    worst, far_rows, far_labels = 0.0, [], []
    for c, w in enumerate(work):
        for k, (_, idx) in enumerate(w):
            (v, ok, lab), (v0, ok0, lab0) = got[c][k], want[c][k]
            scale = max(1.0, float(np.abs(v0).max()))
            tol = RT_TOL * scale + RT_TOL * np.abs(v0)
            ratio = float((np.abs(v - v0) / tol).max())
            worst = max(worst, ratio)
            check(ratio <= 1.0, f"client {c} request {k}: values, x{ratio} tol")
            check(bool((lab == lab0).all()), f"client {c} request {k}: labels")
            check(bool((ok == ok0).all()), f"client {c} request {k}: valid")
            far_rows.append(pool[idx][~ok])
            far_labels.append(lab[~ok])
    far_rows, far_labels = np.concatenate(far_rows), np.concatenate(far_labels)
    check(len(far_rows) > 0, "no request carried a row out of the envelope")
    far_agree = float((far_labels == exact(far_rows)[0].argmax(-1)).mean())
    check(far_agree == 1.0, f"fallback rows' labels against float64: {far_agree}")
    return worst, len(far_rows), far_agree


def drift_model(dev):
    """The drift act's model and rows (see DRIFT_*): (svm, in-distribution
    rows, the same rows scaled out of the envelope)."""
    import torch

    from repro_torch import convert
    from repro_torch.core.bounds import gamma_max

    rng = np.random.default_rng(SEED + 3)
    mus = rng.standard_normal((K, 780)) * 3
    y = np.arange(DRIFT_N_SV + DRIFT_ROWS) % K
    X_all = (rng.standard_normal((len(y), 780)) + mus[y]).astype(np.float32)
    X, Z = X_all[:DRIFT_N_SV], X_all[DRIFT_N_SV:]
    ay = (y[None, :DRIFT_N_SV] == np.arange(K)[:, None]) - 1.0 / K
    ay = (ay / (DRIFT_N_SV / K)).astype(np.float32)
    gamma = DRIFT_GAMMA_SHARE * float(gamma_max(torch.from_numpy(X)))
    svm = convert.svm_from_numpy(X, ay, np.zeros(K, np.float32), gamma, device=dev)
    return svm, Z, (Z * DRIFT_SCALE).astype(np.float32)


def fifth_path(dev, svm, mac, X_te, requests, exact):
    """The serving runtime (``repro_torch.serve.runtime``) on the card, in
    the acts of ``examples/svm_runtime.py``: deferred sync held on the
    card; publish and coalesce (two tenants, 8 clients, each request held
    against its artifact's direct ``SVMEngine.submit``); overload; the
    breaker degrading to B2; drift healed by ``DriftGuard``. Its profile
    act (``runtime_profile``) runs last in the script.

    ``mac`` is path 1's f32 maclaurin artifact, ``requests`` its
    (rows, pushed-out mask) list, ``exact`` its float64 reference. Returns
    every kernel's launches on this path (read after the deferred-sync
    check, which launches B2 directly) and the path's numbers.
    """
    import threading

    import torch

    from repro_torch.core.families import Budget, maclaurin
    from repro_torch.kernels import build
    from repro_torch.serve import (
        DriftGuard,
        FaultInjector,
        PublishSpec,
        Runtime,
        RuntimeOverloaded,
        SVMEngine,
    )
    from repro_torch.serve.runtime import ENGINE_STEP, InjectedFault

    seconds, out = {}, {}
    t0 = time.perf_counter()
    arts = {"mnist-f32": mac, "mnist-int8": maclaurin.quantize_quadform_artifact(mac)}
    direct = {a: SVMEngine(art, svm, device=dev, **RT_OPTS) for a, art in arts.items()}
    for engine in direct.values():
        engine.warmup()

    # ----------------------------------------------- deferred sync (F4)
    defer = submit_deferral(dev, direct["mnist-f32"], svm, X_te)
    phase("submit_deferral", **defer)
    check(defer["results_equal_unqueued"], "a submit behind queued work changed")
    check(
        defer["submit_host_ms"] < defer["device_ms"],
        f"submit waited for the work queued ahead of it: {defer}",
    )
    out["submit_deferral"] = defer
    seconds["submit_deferral"] = time.perf_counter() - t0

    build.reset_counts()
    faults = FaultInjector(seed=SEED, slow_step_s=RT_SLOW_STEP_S)
    rt = Runtime(
        engine_opts=dict(device=dev, **RT_OPTS),
        max_wait_us=RT_WAIT_US,
        max_queue_rows=RT_QUEUE_ROWS,
        breaker=dict(RT_BREAKER),
        fault_injector=faults,
    )
    try:
        # ------------------------------------- act 1: publish and coalesce
        t0 = time.perf_counter()
        cpu_arts = {a: art.to("cpu") for a, art in arts.items()}  # engines copy
        digests = {
            a: rt.publish(a, art, PublishSpec(exact=svm)) for a, art in cpu_arts.items()
        }
        again = rt.publish("mnist-f32", cpu_arts["mnist-f32"], PublishSpec(exact=svm))
        check(again == digests["mnist-f32"], "publishing the same artifact again")
        check(len(set(digests.values())) == 2, "the two tenants share a digest")
        check(digests["mnist-f32"] == mac.digest(), "the registry's digest")
        for a in arts:
            rt.warmup(a)
        engines = {a: rt.registry.get_engine(a)[1] for a in arts}
        configs = {a: e.stats.compiled_steps for a, e in engines.items()}

        pool = np.concatenate([Z for Z, _ in requests])
        rng = np.random.default_rng(SEED + 5)
        work = runtime_plan(rng, len(pool))
        want = [[read(direct[a].submit(pool[i])) for a, i in w] for w in work]

        def clients(fn):
            return drive_clients(work, pool, fn)

        st0 = {a: rt.stats(a) for a in arts}
        got, lat, wall = clients(lambda a, Z: rt.submit(a, Z).result(timeout=60))
        _, lat_direct, wall_direct = clients(lambda a, Z: direct[a].submit(Z))
        st1 = {a: rt.stats(a) for a in arts}
        rows = sum(len(i) for w in work for _, i in w)
        worst, far_rows, far_agree = hold_answers(work, pool, got, want, exact)
        steps = sum(st1[a]["flushes"] - st0[a]["flushes"] for a in arts)
        reqs = sum(st1[a]["requests"] - st0[a]["requests"] for a in arts)
        recompiles = sum(engines[a].stats.compiled_steps - configs[a] for a in arts)
        act1 = dict(
            digests={a: d[:16] for a, d in digests.items()},
            requests=reqs,
            rows=rows,
            fallback_rows=far_rows,
            fallback_label_agree=far_agree,
            engine_steps=steps,
            coalescing_factor=reqs / max(1, steps),
            p50_ms=nearest_rank(lat, 50),
            p99_ms=nearest_rank(lat, 99),
            rows_per_s=rows / wall,
            direct_p50_ms=nearest_rank(lat_direct, 50),
            direct_p99_ms=nearest_rank(lat_direct, 99),
            direct_rows_per_s=rows / wall_direct,
            max_err_over_tol=worst,
            steady_state_recompiles=recompiles,
        )
        # where a request's time goes, from the runtime's own spans: time
        # queued, the flush's host dispatch, dispatch start to the first read
        tracer = rt.obs.tracer
        for name in ("request.queue_wait", "engine.step", "flush.sync"):
            ms = sorted(
                (sp["t_end"] - sp["t_start"]) * 1e3
                for d in digests.values()
                for sp in tracer.spans(d[:12], name)
            )
            act1[f"{name}_p50_ms"] = nearest_rank(ms, 50)
            act1[f"{name}_p99_ms"] = nearest_rank(ms, 99)
        phase("runtime_coalesce", **act1)
        check(reqs == RT_CLIENTS * RT_REQUESTS, f"requests admitted: {reqs}")
        check(recompiles == 0, f"{recompiles} new bucket configs after warm-up")
        out["coalesce"] = act1

        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        rt.registry.evict("mnist-int8")
        del engines["mnist-int8"]
        torch.cuda.synchronize()
        freed = held - torch.cuda.memory_allocated()
        phase(
            "runtime_evict",
            memory_allocated_before=held,
            memory_allocated_after=held - freed,
            artifact_bytes=arts["mnist-int8"].nbytes(),
        )
        check(freed > 0, "evicting an engine released no card memory")
        seconds["coalesce"] = time.perf_counter() - t0

        # ------------------------------------------------- act 2: overload
        t0 = time.perf_counter()
        n_threads, n_req, n_rows = RT_BURST
        faults.slow_next(ENGINE_STEP, 1000)  # pin each flush's service time
        shed, admitted, lock = [], [], threading.Lock()
        burst = [
            [pool[rng.choice(len(pool), size=n_rows)] for _ in range(n_req)]
            for _ in range(n_threads)
        ]

        def bursty(batches):
            for Z in batches:
                try:
                    f = rt.submit("mnist-f32", Z)
                except RuntimeOverloaded as e:
                    with lock:
                        shed.append(e.retry_after_s)
                else:
                    with lock:
                        admitted.append(f)

        st0 = rt.stats("mnist-f32")
        run_threads(bursty, [(b,) for b in burst])
        for f in admitted:
            f.result(timeout=60).labels
        faults.clear_scripts(ENGINE_STEP)
        st = rt.stats("mnist-f32")
        act2 = dict(
            submitted=n_threads * n_req,
            admitted=len(admitted),
            shed=len(shed),
            telemetry_shed=st["shed_requests"] - st0["shed_requests"],
            telemetry_admitted=st["requests"] - st0["requests"],
            retry_after_ms_min=1e3 * min(shed, default=0.0),
            retry_after_ms_max=1e3 * max(shed, default=0.0),
            queue_rows=st["queue_rows"],
            queue_high_water_rows=st["max_queue_rows"],
        )
        phase("runtime_overload", **act2)
        check(len(shed) > 0, "the burst shed nothing")
        check(min(shed) > 0.0, "a shed without a retry_after")
        check(len(shed) + len(admitted) == act2["submitted"], "admitted + shed")
        check(act2["telemetry_shed"] == len(shed), "telemetry's shed count")
        check(act2["telemetry_admitted"] == len(admitted), "telemetry's admitted")
        check(st["queue_rows"] == 0, "the queue did not drain")
        out["overload"] = act2
        seconds["overload"] = time.perf_counter() - t0

        # -------------------------------------------------- act 3: breaker
        t0 = time.perf_counter()
        Zb = pool[rng.choice(len(pool), size=16, replace=False)]
        faults.fail_next(ENGINE_STEP, RT_BREAKER["fail_threshold"])
        failures = 0
        for _ in range(RT_BREAKER["fail_threshold"]):
            try:
                rt.predict("mnist-f32", Zb)
            except InjectedFault:
                failures += 1
        opened = rt.stats("mnist-f32")["breaker"]
        b2 = build.counts()["rbf_scores"]
        res = rt.submit("mnist-f32", Zb).result(timeout=60)
        vals, valid, labels = res.values, res.valid, res.labels
        b2 = build.counts()["rbf_scores"] - b2
        ref, tol = exact(Zb)
        top2 = np.sort(ref, -1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * tol
        time.sleep(RT_BREAKER["reset_after_s"] + 0.05)
        rt.predict("mnist-f32", Zb)  # the half-open probe
        st = rt.stats("mnist-f32")
        done = (
            st["served_requests"]
            + st["failed_requests"]
            + st["deadline_timeouts"]
            + st["closed_requests"]
        )
        act3 = dict(
            failures=failures,
            state_after_faults=opened["state"],
            trips=opened["trips"],
            degraded_rows=st["breaker"]["degraded_rows"],
            degraded_b2_launches=b2,
            degraded_max_abs_err=float(np.abs(vals - ref).max()),
            degraded_tol=tol,
            degraded_label_agree=float((labels == ref.argmax(-1))[decided].mean()),
            degraded_rows_tied_in_fp32=int((~decided).sum()),
            state_after_probe=st["breaker"]["state"],
            probes=st["breaker"]["probes"],
            admitted=st["requests"],
            served_failed_expired_closed=done,
        )
        phase("runtime_breaker", **act3)
        check(failures == RT_BREAKER["fail_threshold"], "injected faults")
        check(opened["state"] == "open", "the breaker did not open")
        check(b2 > 0, "the degraded request did not launch B2")
        check(not valid.any(), "a degraded row claims the fast path")
        check(act3["degraded_max_abs_err"] <= tol, "degraded values against float64")
        check(act3["degraded_label_agree"] == 1.0, "degraded labels against float64")
        check(st["breaker"]["state"] == "closed", "the probe did not close the breaker")
        check(done == st["requests"], f"served + failed + expired + closed: {act3}")
        out["breaker"] = act3
        seconds["breaker"] = time.perf_counter() - t0

        # ---------------------------------------------------- act 4: drift
        t0 = time.perf_counter()
        dsvm, Z_in, Z_drift = drift_model(dev)
        rt.publish("ovr", maclaurin.compile(dsvm).to("cpu"), PublishSpec(exact=dsvm))
        guard = DriftGuard(
            rt,
            "ovr",
            exact=dsvm,
            budget=Budget(**DRIFT_BUDGET),
            threshold=DRIFT_THRESHOLD,
            min_rows=64,
            min_agreement=DRIFT_AGREEMENT,
            seed=SEED,
            compile_opts={"family_opts": {"fourier": {"num_features": DRIFT_FEATURES}}},
        ).attach()
        old = rt.registry.resolve("ovr")
        for i in range(0, len(Z_in), 8):
            rt.submit("ovr", Z_in[i : i + 8]).result(timeout=60).labels
        calm = guard.fallback_rate()
        check(not guard.check()["triggered"], f"in-distribution traffic: {calm}")
        for i in range(0, len(Z_drift), 8):
            rt.submit("ovr", Z_drift[i : i + 8]).result(timeout=60).labels
        drifted = guard.fallback_rate()
        before = build.counts()
        t_heal = time.perf_counter()
        verdict = guard.check()
        heal_s = time.perf_counter() - t_heal
        heal_launches = {k: v - before[k] for k, v in build.counts().items()}
        for i in range(0, len(Z_drift), 8):
            rt.submit("ovr", Z_drift[i : i + 8]).result(timeout=60).labels
        healed = guard.fallback_rate()
        act4 = dict(
            model=f"{K} Gaussian classes at d=780, n_sv={DRIFT_N_SV}, class-mean alpha",
            window_in_distribution=calm,
            window_drifted=drifted,
            healed=verdict.get("healed"),
            family=verdict.get("family"),
            dtype=verdict.get("dtype"),
            agreement=verdict.get("agreement"),
            canary_rows=verdict.get("canary_rows"),
            reason=verdict.get("reason"),
            heal_s=heal_s,
            heal_launches=heal_launches,
            old_digest=old[:16],
            new_digest=rt.registry.resolve("ovr")[:16],
            window_after_flip=healed,
        )
        phase("runtime_drift", **act4)
        check(drifted["rate"] > DRIFT_THRESHOLD, f"the drift did not trip: {drifted}")
        check(bool(verdict.get("healed")), f"the heal failed: {verdict}")
        check(verdict["agreement"] >= DRIFT_AGREEMENT, "canary agreement")
        check(rt.registry.resolve("ovr") != old, "the alias did not flip")
        check(healed["rows"] > 0 and healed["rate"] == 0.0, f"after the flip: {healed}")
        for name in ("quadform_heads", "quadform_heads_q8", "rbf_scores"):
            check(heal_launches[name] > 0, f"the heal did not launch {name}")
        check(heal_launches["rff_score"] + heal_launches["rff_score_q8"] > 0, "B4/B5")
        out["drift"] = act4
        seconds["drift"] = time.perf_counter() - t0

    finally:
        rt.close()
    launches = build.counts()
    phase("fifth_path_launches", **launches)
    for name in ("quadform_heads", "quadform_heads_q8", "rbf_scores"):
        check(launches[name] > 0, f"{name} never launched on the fifth path")
    phase("fifth_path_seconds", **seconds)
    return launches, out


def runtime_profile(dev, svm, mac, requests) -> None:
    """Path 5's last act, run at the end of the script: ``torch.profiler``
    slows every later launch of its process, and path 6 times the host.
    A ``Runtime.profile`` trace of one coalesced step of path 1's f32
    artifact must hold the step's range and B1's symbol."""
    from repro_torch.serve import PublishSpec, Runtime

    rows = np.concatenate([Z for Z, _ in requests])[:64]
    with Runtime(engine_opts=dict(device=dev, **RT_OPTS)) as rt:
        rt.publish("mnist-f32", mac.to("cpu"), PublishSpec(exact=svm))
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "step.json"
            rt.profile("mnist-f32", rows, trace)
            events = json.loads(trace.read_text())["traceEvents"]
            trace_bytes = trace.stat().st_size
    names = [e.get("name", "") for e in events]
    steps = sorted({n for n in names if n.startswith("svm_engine.step/")})
    b1 = sorted(set(re.findall(r"quadform_tf32<float[^>]*>", " ".join(names))))
    phase("runtime_profile", bytes=trace_bytes, events=len(events), steps=steps, b1=b1)
    check(any(n.startswith("svm_engine.step/maclaurin/") for n in steps), "the step")
    check(len(b1) > 0, "no launch of B1's symbol in the trace")


class HttpClient:
    """One keep-alive connection to a front door: JSON in and out, standard
    library only (a client knows nothing of the port)."""

    def __init__(self, handle):
        self.conn = http.client.HTTPConnection(handle.host, handle.port, timeout=60)

    def call(self, method: str, path: str, body=None, key: str | None = None):
        """(status, lower-cased headers, parsed JSON or raw bytes); ``body``
        is an object to encode, or bytes already encoded."""
        headers = {"content-type": "application/json"}
        if key is not None:
            headers["x-api-key"] = key
        if body is not None and not isinstance(body, bytes):
            body = json.dumps(body).encode()
        self.conn.request(method, path, body=body, headers=headers)
        resp = self.conn.getresponse()
        raw = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        if hdrs.get("content-type", "").startswith("application/json"):
            raw = json.loads(raw)
        return resp.status, hdrs, raw

    def close(self) -> None:
        self.conn.close()


def body_bytes(rows) -> bytes:
    """A ``:predict`` body: float32 rows as JSON numbers, which carry every
    float32 value exactly."""
    return json.dumps({"rows": rows.tolist()}).encode()


def sixth_path(dev, svm, mac, requests, exact, in_process_p50_ms: float) -> dict:
    """The HTTP front door (``repro_torch.serve.server``) over runtimes on the
    card, in the acts of ``examples/svm_http.py``: publish (int8 over the
    wire, f32 in process with its exact model), coalesce (path 5's clients
    and requests over localhost sockets, each answer held against its
    artifact's direct ``SVMEngine.submit``), refusals on a second, tenanted
    server, a ``/metrics`` scrape.

    ``mac`` is path 1's f32 maclaurin artifact, ``requests`` its (rows,
    pushed-out mask) list, ``exact`` its float64 reference,
    ``in_process_p50_ms`` path 5's coalesced p50 from this run. Returns every
    kernel's launches on this path.
    """
    import base64
    import hashlib
    import threading

    from repro_torch.core.families import maclaurin
    from repro_torch.kernels import build
    from repro_torch.serve import PublishSpec, Runtime, SVMEngine, create_app, serve
    from repro_torch.serve.runtime import MetricsRegistry, Observability

    t_path = time.perf_counter()
    seconds = {}
    q8 = maclaurin.quantize_quadform_artifact(mac)
    # the int8 tenant is published over the wire, where no exact model goes
    direct = {
        "mnist-f32": SVMEngine(mac, svm, device=dev, **RT_OPTS),
        "mnist-int8": SVMEngine(q8, None, device=dev, **RT_OPTS),
    }
    pool = np.concatenate([Z for Z, _ in requests])
    pushed = np.concatenate([s for _, s in requests])
    work = runtime_plan(np.random.default_rng(SEED + 5), len(pool))  # path 5's
    want = [[read(direct[a].submit(pool[i])) for a, i in w] for w in work]
    bodies = [[body_bytes(pool[i]) for _, i in w] for w in work]
    del direct
    seconds["setup"] = time.perf_counter() - t_path

    build.reset_counts()
    rt = Runtime(
        engine_opts=dict(device=dev, **RT_OPTS),
        max_wait_us=RT_WAIT_US,
        max_queue_rows=RT_QUEUE_ROWS,
        # its own metrics: path 5's runtime served the same digest, and the
        # process registry sums every runtime's counters
        obs=Observability(registry=MetricsRegistry()),
    )
    app = create_app(runtime=rt)
    handle = serve(app)
    admin = HttpClient(handle)
    try:
        # ----------------------------------------------- act 1: publish
        t0 = time.perf_counter()
        raw = q8.to_bytes()
        upload = {
            "artifact_b64": base64.b64encode(raw).decode(),
            "spec": {"alias": "mnist-int8"},
        }
        t = time.perf_counter()
        status, _, body = admin.call("POST", "/v1/models", upload)
        publish_ms = (time.perf_counter() - t) * 1e3
        check(status == 201, f"POST /v1/models: {status} {body}")
        digests = {"mnist-int8": body["digest"]}
        sha = hashlib.sha256(raw).hexdigest()
        check(body["digest"] == sha == q8.digest(), "the uploaded artifact's digest")
        f32_spec = PublishSpec(exact=svm)
        digests["mnist-f32"] = rt.publish("mnist-f32", mac.to("cpu"), f32_spec)
        check(digests["mnist-f32"] == mac.digest(), "the f32 artifact's digest")
        for a in digests:
            rt.warmup(a)
        engines = {a: rt.registry.get_engine(a)[1] for a in digests}
        exact_on = {a: e.exact_available for a, e in engines.items()}
        want_on = {"mnist-int8": False, "mnist-f32": True}
        check(exact_on == want_on, f"exact models: {exact_on}")
        configs = {a: e.stats.compiled_steps for a, e in engines.items()}
        phase(
            "http_publish",
            url=handle.url,
            status=status,
            artifact_bytes=len(raw),
            upload_body_bytes=len(json.dumps(upload)),
            publish_ms=publish_ms,
            digests={a: d[:16] for a, d in digests.items()},
            exact_available=exact_on,
        )
        seconds["publish"] = time.perf_counter() - t0

        # ---------------------------------------------- act 2: coalesce
        t0 = time.perf_counter()
        got = [[None] * RT_REQUESTS for _ in range(RT_CLIENTS)]
        lat, lock = [], threading.Lock()

        def client(c):
            conn = HttpClient(handle)
            try:
                for k, (a, _) in enumerate(work[c]):
                    t = time.perf_counter()
                    path = f"/v1/models/{a}:predict"
                    got[c][k] = conn.call("POST", path, bodies[c][k])
                    with lock:
                        lat.append((time.perf_counter() - t) * 1e3)
            finally:
                conn.close()

        st0 = {a: rt.stats(a) for a in digests}
        t = time.perf_counter()
        run_threads(client, [(c,) for c in range(RT_CLIENTS)])
        wall = time.perf_counter() - t
        st1 = {a: rt.stats(a) for a in digests}
        lat.sort()
        statuses = [g[0] for row in got for g in row]
        non_2xx = [s for s in statuses if not 200 <= s < 300]
        check(not non_2xx, f"non-2xx answers: {non_2xx[:5]}")
        worst, f32_far, f32_labels, q8_far = 0.0, [], [], 0
        for c in range(RT_CLIENTS):
            for k, (a, idx) in enumerate(work[c]):
                _, _, body = got[c][k]
                v0, ok0, lab0 = want[c][k]
                v = np.asarray(body["scores"], np.float32)
                ok = np.asarray(body["valid"], bool)
                lab = np.asarray(body["labels"])
                scale = max(1.0, float(np.abs(v0).max()))
                tol = RT_TOL * scale + RT_TOL * np.abs(v0)
                ratio = float((np.abs(v - v0) / tol).max())
                worst = max(worst, ratio)
                what = f"client {c} request {k} ({a})"
                check(ratio <= 1.0, f"{what}: values, x{ratio} tol")
                check(bool((lab == lab0).all()), f"{what}: labels")
                check(bool((ok == ok0).all()), f"{what}: valid")
                check(bool((ok == ~pushed[idx]).all()), f"{what}: valid != envelope")
                check(body["digest"] == digests[a], f"{what}: digest")
                check(body["dtype"] == engines[a].dtype, f"{what}: dtype")
                if a == "mnist-f32":
                    f32_far.append(pool[idx][~ok])
                    f32_labels.append(lab[~ok])
                else:
                    q8_far += int((~ok).sum())
        f32_far, f32_labels = np.concatenate(f32_far), np.concatenate(f32_labels)
        check(len(f32_far) > 0, "no f32 request carried a row out of the envelope")
        check(q8_far > 0, "no int8 request carried a row out of the envelope")
        far_agree = float((f32_labels == exact(f32_far)[0].argmax(-1)).mean())
        check(far_agree == 1.0, f"fallback rows' labels against float64: {far_agree}")
        steps = sum(st1[a]["flushes"] - st0[a]["flushes"] for a in digests)
        reqs = sum(st1[a]["requests"] - st0[a]["requests"] for a in digests)
        recompiles = sum(engines[a].stats.compiled_steps - configs[a] for a in digests)
        rows = sum(len(i) for w in work for _, i in w)
        p50 = nearest_rank(lat, 50)
        act2 = dict(
            requests=reqs,
            rows=rows,
            non_2xx=len(non_2xx),
            f32_fallback_rows=int(len(f32_far)),
            fallback_label_agree=far_agree,
            int8_rows_outside_unpatched=q8_far,
            engine_steps=steps,
            coalescing_factor=reqs / max(1, steps),
            p50_ms=p50,
            p99_ms=nearest_rank(lat, 99),
            rows_per_s=rows / wall,
            in_process_p50_ms=in_process_p50_ms,
            http_overhead_p50=p50 / in_process_p50_ms,
            max_err_over_tol=worst,
            steady_state_recompiles=recompiles,
        )
        # where a request's time goes inside the runtime (path 5's spans)
        for name in ("request.queue_wait", "engine.step", "flush.sync"):
            ms = sorted(
                (sp["t_end"] - sp["t_start"]) * 1e3
                for d in digests.values()
                for sp in rt.obs.tracer.spans(d[:12], name)
            )
            act2[f"{name}_p50_ms"] = nearest_rank(ms, 50)
            act2[f"{name}_p99_ms"] = nearest_rank(ms, 99)
        phase("http_coalesce", **act2)
        check(reqs == RT_CLIENTS * RT_REQUESTS, f"requests admitted: {reqs}")
        check(recompiles == 0, f"{recompiles} new bucket configs after warm-up")
        seconds["coalesce"] = time.perf_counter() - t0

        # ---------------------------------------------- act 3: refusals
        t0 = time.perf_counter()
        phase("http_refusals", **refusals(dev, mac, svm, pool))
        seconds["refusals"] = time.perf_counter() - t0

        # ------------------------------------------------ act 4: metrics
        t0 = time.perf_counter()
        status, hdrs, text = admin.call("GET", "/metrics")
        text = text.decode() if isinstance(text, bytes) else str(text)
        counted = [
            float(line.rsplit(" ", 1)[1])
            for line in text.splitlines()
            if line.startswith("repro_serve_requests_total")
        ]
        act4 = dict(
            status=status,
            content_type=hdrs.get("content-type"),
            lines=len(text.splitlines()),
            requests_total=sum(counted),
            requests_sent=RT_CLIENTS * RT_REQUESTS,
        )
        phase("http_metrics", **act4)
        check(status == 200, f"GET /metrics: {status}")
        check(act4["content_type"].startswith("text/plain"), "the metrics' type")
        check(sum(counted) == RT_CLIENTS * RT_REQUESTS, "repro_serve_requests_total")
        seconds["metrics"] = time.perf_counter() - t0
    finally:
        admin.close()
        handle.close()
        rt.close()
    launches = build.counts()
    phase("sixth_path_launches", **launches)
    for name in ("quadform_heads", "quadform_heads_q8", "rbf_scores"):
        check(launches[name] > 0, f"{name} never launched on the sixth path")
    seconds["path6_seconds"] = time.perf_counter() - t_path
    phase("sixth_path_seconds", **seconds)
    return launches


def refusals(dev, mac, svm, pool) -> dict:
    """Path 6's typed refusals on a tenanted front door over its own
    runtime (path 1's f32 artifact, flushes pinned at RT_SLOW_STEP_S for
    the flood): no key, a tenant past its bucket, a flood past the queue's
    bound; then the client's tally, the telemetry and the spans, which must
    agree."""
    import threading

    from repro_torch.serve import FaultInjector, PublishSpec, Runtime, create_app, serve
    from repro_torch.serve.runtime import ENGINE_STEP
    from repro_torch.serve.server import TenantConfig

    faults = FaultInjector(seed=SEED, slow_step_s=RT_SLOW_STEP_S)
    rt = Runtime(
        engine_opts=dict(device=dev, **RT_OPTS),
        max_wait_us=RT_WAIT_US,
        max_queue_rows=RT_QUEUE_ROWS,
        fault_injector=faults,
    )
    tenants = [
        TenantConfig("acme", api_key="acme-key", rate_rps=1e-6, burst=HTTP_ACME_BURST),
        TenantConfig("umbrella", api_key="umbrella-key"),
    ]
    app = create_app(runtime=rt, tenants=tenants)
    handle = serve(app)
    c = HttpClient(handle)
    try:
        digest = rt.publish("mnist-f32", mac.to("cpu"), PublishSpec(exact=svm))
        rt.warmup("mnist-f32")
        path = "/v1/models/mnist-f32:predict"
        one = body_bytes(pool[:1])
        status, _, body = c.call("POST", path, one)
        check(status == 401, f"no key: {status}")
        check(body["error"]["code"] == "unauthenticated", f"no key: {body}")
        acme = [
            c.call("POST", path, one, key="acme-key") for _ in range(HTTP_ACME_REQUESTS)
        ]
        acme_ok = sum(s == 200 for s, _, _ in acme)
        acme_shed = [(h, b) for s, h, b in acme if s == 429]
        check(acme_ok == HTTP_ACME_BURST, f"acme admitted {acme_ok}")
        check(acme_ok + len(acme_shed) == HTTP_ACME_REQUESTS, "acme: not 200 or 429")
        acme_retry = [h.get("retry-after", "") for h, _ in acme_shed]
        codes = {b["error"]["code"] for _, b in acme_shed}
        check(codes == {"tenant_quota"}, f"acme's codes: {codes}")
        check(all(r.isdigit() and int(r) >= 1 for r in acme_retry), f"{acme_retry}")

        n_threads, n_req, n_rows = HTTP_FLOOD
        rng = np.random.default_rng(SEED + 6)
        flood = [
            [body_bytes(pool[rng.choice(len(pool), n_rows)]) for _ in range(n_req)]
            for _ in range(n_threads)
        ]
        hits, lock = [], threading.Lock()
        barrier = threading.Barrier(n_threads)

        def flooder(i):
            conn = HttpClient(handle)
            try:
                barrier.wait(timeout=60)
                for b in flood[i]:
                    s, h, out = conn.call("POST", path, b, key="umbrella-key")
                    code = out.get("error", {}).get("code") if s != 200 else None
                    with lock:
                        hits.append((s, code, h.get("retry-after")))
            finally:
                conn.close()

        faults.slow_next(ENGINE_STEP, 1000)  # pin each flush's service time
        run_threads(flooder, [(i,) for i in range(n_threads)])
        faults.clear_scripts(ENGINE_STEP)
        flood_ok = sum(s == 200 for s, _, _ in hits)
        flood_shed = [(code, r) for s, code, r in hits if s == 429]
        st = rt.stats(digest)
        cons = rt.obs.tracer.conservation(digest[:12])
        _, _, tsnap = c.call("GET", "/v1/tenants")
        acme_row = next(t for t in tsnap["tenants"] if t["name"] == "acme")
        client_ok = acme_ok + flood_ok
        client_shed = len(acme_shed) + len(flood_shed)
        done = (
            st["served_requests"]
            + st["failed_requests"]
            + st["deadline_timeouts"]
            + st["closed_requests"]
        )
        out = dict(
            unauthenticated=status,
            acme_admitted=acme_ok,
            acme_shed=len(acme_shed),
            acme_retry_after_s=acme_retry[:1],
            flood_requests=len(hits),
            flood_served=flood_ok,
            flood_shed=len(flood_shed),
            flood_retry_after_s=sorted({r for _, r in flood_shed})[:3],
            client_ok=client_ok,
            client_shed=client_shed,
            telemetry_served=st["served_requests"],
            telemetry_shed=st["shed_requests"],
            telemetry_admitted=st["requests"],
            spans=cons,
            tenants_acme=dict(admitted=acme_row["admitted"], shed=acme_row["shed"]),
            queue_rows=st["queue_rows"],
            queue_high_water_rows=st["max_queue_rows"],
        )
        check(len(hits) == n_threads * n_req, "a flood request went unanswered")
        check(flood_ok + len(flood_shed) == len(hits), f"flood statuses: {out}")
        check(len(flood_shed) > 0, "the flood shed nothing")
        check(all(code == "overloaded" for code, _ in flood_shed), "flood code")
        check(all(r is not None and int(r) >= 1 for _, r in flood_shed), "Retry-After")
        check(st["served_requests"] == client_ok, f"served: {out}")
        check(st["shed_requests"] == client_shed, f"shed: {out}")
        check(done == st["requests"], f"served + failed + expired + closed: {out}")
        check(cons["unaccounted"] == 0, f"spans: {cons}")
        check(cons["served"] == client_ok and cons["shed"] == client_shed, f"{cons}")
        check(cons["submitted"] == client_ok + client_shed, f"submitted: {cons}")
        check(acme_row["admitted"] == acme_ok, "/v1/tenants: acme admitted")
        check(acme_row["shed"] == len(acme_shed), "/v1/tenants: acme shed")
        check(st["queue_rows"] == 0, "the queue did not drain")
        return out
    finally:
        c.close()
        handle.close()
        rt.close()


def replica_act(dev, svm, mac, pool, work, want, exact, replicas: int) -> dict:
    """Path 5's plan through a runtime serving ``mac`` with ``replicas``
    replicas on the card, held against direct submits (``want``)."""
    from repro_torch.serve import PublishSpec, Runtime
    from repro_torch.serve.runtime import MetricsRegistry, Observability

    rt = Runtime(
        engine_opts=dict(device=dev, **RT_OPTS),
        max_wait_us=RT_WAIT_US,
        max_queue_rows=RT_QUEUE_ROWS,
        obs=Observability(registry=MetricsRegistry()),
    )
    try:
        rt.publish("mnist-f32", mac.to("cpu"), PublishSpec(exact=svm, replicas=replicas))
        rt.warmup("mnist-f32")
        engines = rt.registry.get_engines("mnist-f32")[1]
        check(len(engines) == replicas, f"{len(engines)} engines for {replicas}")
        configs = sum(e.stats.compiled_steps for e in engines)
        got, lat, wall = drive_clients(
            work, pool, lambda _, Z: rt.submit("mnist-f32", Z).result(timeout=60)
        )
        st = rt.stats("mnist-f32")
        recompiles = sum(e.stats.compiled_steps for e in engines) - configs
    finally:
        rt.close()
    worst, far_rows, far_agree = hold_answers(work, pool, got, want, exact)
    per = st["replicas"]
    rows = sum(len(i) for w in work for _, i in w)
    out = dict(
        replicas=replicas,
        requests=st["requests"],
        rows=rows,
        fallback_rows=far_rows,
        fallback_label_agree=far_agree,
        engine_steps=st["flushes"],
        flushes_per_replica=[per[i]["flushes"] for i in sorted(per)],
        rows_per_replica=[per[i]["rows"] for i in sorted(per)],
        p50_ms=nearest_rank(lat, 50),
        p99_ms=nearest_rank(lat, 99),
        rows_per_s=rows / wall,
        max_err_over_tol=worst,
        failed=st["failed_requests"],
        shed=st["shed_requests"],
        steady_state_recompiles=recompiles,
    )
    phase("scaleout_replicas", **out)
    check(sorted(per) == [str(i) for i in range(replicas)], f"replicas: {sorted(per)}")
    check(min(out["flushes_per_replica"]) >= 1, f"an idle replica: {out}")
    check(sum(out["flushes_per_replica"]) == st["flushes"], "flushes conserved")
    check(sum(out["rows_per_replica"]) == st["rows"], "rows conserved")
    check(st["failed_requests"] == 0 == st["shed_requests"], "failed or shed requests")
    check(st["requests"] == RT_CLIENTS * RT_REQUESTS, f"requests: {st['requests']}")
    check(recompiles == 0, f"{recompiles} new bucket configs after warm-up")
    return out


def fault_act(dev, svm, mac, inside) -> dict:
    """``examples/svm_scaleout.py``'s act 2 on the card: 3 replicas, one
    scripted fault on replica 1 opening only its breaker, the siblings
    answering every other request on the fast path."""
    from repro_torch.serve import FaultInjector, PublishSpec, Runtime
    from repro_torch.serve.runtime import (
        ENGINE_STEP,
        InjectedFault,
        MetricsRegistry,
        Observability,
    )

    faults = FaultInjector(seed=SEED)
    rt = Runtime(
        engine_opts=dict(device=dev, **RT_OPTS),
        max_wait_us=RT_WAIT_US,
        max_queue_rows=RT_QUEUE_ROWS,
        breaker=dict(fail_threshold=1, reset_after_s=60.0),
        fault_injector=faults,
        obs=Observability(registry=MetricsRegistry()),
    )
    try:
        rt.publish("mnist-f32", mac.to("cpu"), PublishSpec(exact=svm, replicas=3))
        rt.predict("mnist-f32", inside[:2])  # warm flush -> replica 0
        faults.fail_next(FaultInjector.replica_site(ENGINE_STEP, 1), 1)
        failed, fast = 0, 0
        for i in range(SCALE_FAULT_REQUESTS):
            try:
                _, valid = rt.predict("mnist-f32", inside[4 * i : 4 * i + 4])
            except InjectedFault:
                failed += 1
            else:
                fast += int(valid.all())
        st = rt.stats("mnist-f32")
    finally:
        rt.close()
    per = st["replicas"]
    states = {i: per[i]["breaker_state"] for i in sorted(per)}
    out = dict(
        replicas=3,
        requests=SCALE_FAULT_REQUESTS,
        failed=failed,
        answered_fast=fast,
        breakers=states,
        flushes_per_replica=[per[i]["flushes"] for i in sorted(per)],
        degraded_requests=st["breaker"]["degraded_requests"],
    )
    phase("scaleout_fault", **out)
    check(failed == 1, f"{failed} requests failed, not 1")
    check(states == {"0": "closed", "1": "open", "2": "closed"}, f"breakers: {states}")
    check(fast == SCALE_FAULT_REQUESTS - 1, f"{fast} answered on the fast path")
    check(st["breaker"]["degraded_requests"] == 0, "the model degraded")
    return out


def extreme_model(dev):
    """``examples/svm_scaleout.py``'s ``make_model(7, k=4096, d=32)`` (EXTREME)
    and its rows: (svm, rows)."""
    import torch

    from repro_torch import convert
    from repro_torch.core.bounds import gamma_max

    k, d, n_sv, n = EXTREME
    rng = np.random.default_rng(7)
    X = rng.standard_normal((n_sv, d)).astype(np.float32) * 0.5
    gamma = 0.8 * float(gamma_max(torch.from_numpy(X)))
    ay = rng.standard_normal((k, n_sv)).astype(np.float32) * 0.5
    b = (rng.standard_normal(k) * 0.1).astype(np.float32)
    Z = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    return convert.svm_from_numpy(X, ay, b, gamma, device=dev), Z


def extreme_fastfood(dev, dtype: str):
    """A K = 4096 Fastfood artifact at d = 32, F = 64 built from arrays, as
    ``tests/test_scaleout.py``'s ``_synthetic_fastfood_artifact``."""
    import torch

    from repro_torch.core.families import CompiledArtifact, fourier
    from repro_torch.core.families.base import base_meta

    k, d = EXTREME[:2]
    rng = np.random.default_rng(SEED)
    arrays, f, proj = fourier._fastfood_arrays(rng, d, EXTREME_FF_FEATURES, 0.5)
    arrays = dict(arrays)
    arrays["phase"] = rng.uniform(0, 2 * np.pi, (f,)).astype(np.float32)
    arrays["weights"] = (rng.standard_normal((k, f)) * 0.05).astype(np.float32)
    arrays["b"] = (rng.standard_normal(k) * 0.1).astype(np.float32)
    meta = dict(kind="rff", validity="global", num_features=f, seed=SEED, **proj)
    art = CompiledArtifact(
        family="fourier",
        arrays={n: torch.from_numpy(a).to(dev) for n, a in arrays.items()},
        meta=base_meta(d=d, num_heads=k, multiclass=True, **meta),
    )
    return fourier.quantize_fastfood_artifact(art) if dtype == "int8" else art


def shard_parity(label, art, Z, mesh, dev, **engine_opts) -> dict:
    """Serve ``Z`` through ``art`` on an unsharded and a head-sharded engine
    (no exact model: the kernels' own scores): shapes, both engines' scores
    within the kernel's twin tolerance of the plain twin's on the same rows
    and of each other, finite scores, no label on a padding head, equal
    validity, equal labels but on rows whose top two scores lie within that
    tolerance (counted), and both engines' warmed submit times (host clock,
    median of 10)."""
    import torch

    from repro_torch.serve import SVMEngine

    ref = SVMEngine(art, device=dev, **engine_opts)
    shd = SVMEngine(art, head_mesh=mesh, **engine_opts)
    Zd = torch.from_numpy(Z).to(dev)
    s0, tol = plain_scores(art, Zd)
    s0 = s0.cpu().numpy()
    r_ref, r_shd = ref.submit(Z), shd.submit(Z)
    v0, v1 = r_ref.values, r_shd.values
    k = art.num_heads
    top2 = np.sort(v0, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > tol
    out = dict(
        cell=label,
        rows=int(Z.shape[0]),
        k=k,
        padded_heads=shd._serve_artifact.meta.get("padded_heads", k),
        max_abs_err=float(np.abs(v1 - v0).max()),
        max_abs_err_vs_plain=float(np.abs(v0 - s0).max()),
        sharded_max_abs_err_vs_plain=float(np.abs(v1 - s0).max()),
        tol=tol,
        max_abs_ref=float(np.abs(v0).max()),
        valid_rows=int(r_ref.valid.sum()),
        label_agree_decided=float((r_shd.labels == r_ref.labels)[decided].mean()),
        near_tie_rows=int((~decided).sum()),
        scores_finite=bool(np.isfinite(v1).all()),
        labels_on_real_heads=bool((r_shd.labels < k).all()),
        sharded_ms=median_request_ms(shd, Z),
        unsharded_ms=median_request_ms(ref, Z),
    )
    phase("head_sharded", **out)
    check(v1.shape == (Z.shape[0], k), f"{label}: scores {v1.shape}")
    check(out["max_abs_err"] <= tol, f"{label}: {out['max_abs_err']} > {tol}")
    for key in ("max_abs_err_vs_plain", "sharded_max_abs_err_vs_plain"):
        check(out[key] <= tol, f"{label}: {key} {out[key]} > {tol}")
    check(bool((r_shd.valid == r_ref.valid).all()), f"{label}: validity differs")
    check(out["label_agree_decided"] == 1.0, f"{label}: labels on decided rows")
    check(out["scores_finite"], f"{label}: a score is not finite")
    check(out["labels_on_real_heads"], f"{label}: a padding head won the argmax")
    return out


def seventh_path(dev, svm, mac, X_te, Zq, requests, exact) -> dict:
    """Scale-out on the card (``examples/svm_scaleout.py``): replicas of path
    1's f32 artifact behind one runtime (``scaleout_replicas``), a fault
    isolated to one replica (``scaleout_fault``), head-sharded engines at
    the mnist width for the six (family, dtype) artifacts and at K = 4096
    (``head_sharded``), and path 1's exact model with its SVs split
    (``sv_sharded``), every mesh ``SCALE_SHARDS`` x the one card.

    ``mac`` is path 1's f32 maclaurin artifact, ``Zq`` its kernel check rows
    (both sides of the envelope), ``requests`` its (rows, pushed-out mask)
    list, ``exact`` its float64 reference. Returns every kernel's launches
    on this path."""
    import torch

    from repro_torch.core.families import fourier, maclaurin
    from repro_torch.kernels import build
    from repro_torch.launch import make_mesh
    from repro_torch.serve import SVMEngine

    t_path = time.perf_counter()
    seconds = {}
    build.reset_counts()

    # ------------------------------------------------------------ replicas
    t0 = time.perf_counter()
    pool = np.concatenate([Z for Z, _ in requests])
    work = runtime_plan(np.random.default_rng(SEED + 5), len(pool))  # path 5's
    direct = SVMEngine(mac, svm, device=dev, **RT_OPTS)
    direct.warmup()
    want = [[read(direct.submit(pool[i])) for _, i in w] for w in work]
    for replicas in SCALE_REPLICAS:
        replica_act(dev, svm, mac, pool, work, want, exact, replicas)
    inside = np.concatenate([Z[~s] for Z, s in requests])
    fault_act(dev, svm, mac, inside)
    seconds["replicas"] = time.perf_counter() - t0

    # ---------------------------------------------------- head-sharded
    t0 = time.perf_counter()
    mesh = make_mesh((SCALE_SHARDS,), ("heads",), devices=[dev] * SCALE_SHARDS)
    Z = Zq.cpu().numpy()
    arts = {
        "maclaurin/float32": mac,
        "maclaurin/int8": maclaurin.quantize_quadform_artifact(mac),
    }
    for dt in ("float32", "int8"):
        for label, structured in (("fourier", False), ("fastfood", True)):
            arts[f"{label}/{dt}"] = fourier.compile(
                svm,
                num_features=SCALE_FEATURES,
                structured=structured,
                dtype=dt,
                seed=SEED,
            )
    for label, art in arts.items():
        shard_parity(label, art, Z, mesh, dev)
    seconds["head_sharded"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    big, Zb = extreme_model(dev)
    extreme = {
        "maclaurin/float32": maclaurin.compile(big),
        "maclaurin/int8": maclaurin.compile(big, dtype="int8", seed=SEED),
        "fastfood/float32": extreme_fastfood(dev, "float32"),
        "fastfood/int8": extreme_fastfood(dev, "int8"),
    }
    n = EXTREME[3]
    for label, art in extreme.items():
        label = f"K={EXTREME[0]} {label}"
        shard_parity(label, art, Zb, mesh, dev, min_bucket=n, max_batch=n)
    seconds["head_sharded_extreme"] = time.perf_counter() - t0

    # ------------------------------------------------------ SV-sharded
    t0 = time.perf_counter()
    sv_mesh = make_mesh((SCALE_SHARDS,), ("sv",), devices=[dev] * SCALE_SHARDS)
    ref = SVMEngine(mac, svm, device=dev)
    shd = SVMEngine(mac, svm, mesh=sv_mesh)
    for engine in (ref, shd):
        engine.warmup(list(REQUEST_ROWS))
    Zx = X_te[-EXACT_ROWS * 4 :]
    b2 = build.counts()["rbf_scores"]
    got = shd.submit_exact(Zx)
    got_values = got.values
    b2 = build.counts()["rbf_scores"] - b2
    want_x = ref.submit_exact(Zx).values
    ref64, tol = exact(Zx)
    top2 = np.sort(ref64, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * tol
    fallback_err, fallback_rows, fallback_agree = 0.0, 0, 0
    for Zr, scaled in requests:
        r = shd.submit(Zr)
        check(bool((r.valid == ~scaled).all()), "sv_sharded: valid != envelope")
        if scaled.any():
            far64, far_tol = exact(Zr[scaled])
            err = float(np.abs(r.values[scaled] - far64).max())
            check(err <= far_tol, f"sv_sharded fallback values: {err} > {far_tol}")
            fallback_err = max(fallback_err, err)
            fallback_rows += int(scaled.sum())
            fallback_agree += int((r.labels[scaled] == far64.argmax(-1)).sum())
    out = dict(
        shards=SCALE_SHARDS,
        svs_per_shard=shd._sv_rows,
        rows=int(Zx.shape[0]),
        b2_launches_a_call=b2,
        max_abs_err_vs_unsharded=float(np.abs(got_values - want_x).max()),
        max_abs_err_vs_float64=float(np.abs(got_values - ref64).max()),
        unsharded_max_abs_err_vs_float64=float(np.abs(want_x - ref64).max()),
        tol=tol,
        label_agree_decided=float((got.labels == ref64.argmax(-1))[decided].mean()),
        rows_tied_in_fp32=int((~decided).sum()),
        fallback_rows=fallback_rows,
        fallback_stat=shd.stats.fallback_instances,
        fallback_max_abs_err=fallback_err,
        fallback_label_agree=fallback_agree / max(1, fallback_rows),
        submit_exact_sharded_ms=median_request_ms(shd, Zx, exact=True),
        submit_exact_unsharded_ms=median_request_ms(ref, Zx, exact=True),
    )
    phase("sv_sharded", **out)
    check(b2 == SCALE_SHARDS, f"B2 launched {b2} times for {SCALE_SHARDS} shards")
    check(out["max_abs_err_vs_unsharded"] <= tol, f"sv_sharded against unsharded: {out}")
    check(out["max_abs_err_vs_float64"] <= tol, f"sv_sharded against float64: {out}")
    check(out["label_agree_decided"] == 1.0, "sv_sharded labels against float64")
    check(fallback_rows == shd.stats.fallback_instances > 0, "sv_sharded fallback rows")
    check(fallback_agree == fallback_rows, "sv_sharded fallback labels against float64")
    seconds["sv_sharded"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    launches = build.counts()
    phase("seventh_path_launches", **launches)
    path_kernels = (
        "quadform_heads",
        "rbf_scores",
        "quadform_heads_q8",
        "rff_score",
        "rff_score_q8",
        "fastfood_score",
        "fastfood_score_q8",
    )
    for name in path_kernels:
        check(launches[name] > 0, f"{name} never launched on the seventh path")
    seconds["path7_seconds"] = time.perf_counter() - t_path
    phase("seventh_path_seconds", **seconds)
    return launches


def run(dev) -> list[dict]:
    """Every phase on ``dev``; returns the ``kernels`` entries."""
    import torch

    from repro_torch.core import families
    from repro_torch.core.families import CompiledArtifact
    from repro_torch.kernels import build
    from repro_torch.kernels.quadform import kernel as qf
    from repro_torch.kernels.rbf_pred import kernel as rp
    from repro_torch.serve import SVMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    libs = build.build_all()
    phase("build", seconds=time.perf_counter() - t0, libs=[p.name for p in libs])
    for lib in libs:
        for prefix, (mma_in, simt, spill_free) in TENSOR_CORE_BODIES.items():
            if lib.name.startswith(prefix):
                cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
                bodies = compiled_bodies(lib, cuobjdump, mma_in, simt, spill_free)
                phase("compiled", lib=lib.name, **bodies)

    # ------------------------------------------------------------ main path
    seconds = {}
    t_phase = time.perf_counter()
    svm, X_te, spec, rng = smoke_model(dev)
    gamma, b = np.float32(spec.paper_gamma), svm.b.cpu().numpy()

    t0 = time.perf_counter()
    art = families.maclaurin.compile(svm)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        loaded = CompiledArtifact.load(art.save(str(Path(tmp) / "mnist.npz")), dev)
    check(loaded.digest() == art.digest(), "save/load changed the artifact digest")
    engine = SVMEngine(loaded, svm, device=dev)
    engine.warmup(list(REQUEST_ROWS))
    msq = float(loaded.arrays["msq"].max())

    requests, off = [], 0
    for n, n_scaled in zip(REQUEST_ROWS, SCALED_ROWS):
        Z = X_te[off : off + n].copy()
        off += n
        scaled = np.zeros(n, bool)
        scaled[rng.choice(n, size=n_scaled, replace=False)] = True
        Z[scaled] = push_out(Z[scaled], msq, float(gamma))
        requests.append((Z, scaled))
    Z_exact = X_te[off : off + EXACT_ROWS]

    build.reset_counts()
    served, request_ms = [], []
    for Z, _ in requests:
        t0 = time.perf_counter()
        r = engine.submit(Z)
        served.append((r.values, r.valid, r.labels))
        request_ms.append((time.perf_counter() - t0) * 1e3)
    rx = engine.submit_exact(Z_exact)
    exact_served = (rx.values, rx.valid, rx.labels)
    launches = build.counts()

    # Reference: the exact model in float64 through the plain twin, and the
    # fp32 twin's distance from it, which sets B2's tolerance.
    exact = exact64(svm, dev)

    n_scaled_total = int(sum(s.sum() for _, s in requests))
    agree_in, agree_out, n_in = 0, 0, 0
    ref_in_labels, margins = [], []
    fallback_err, fallback_tol, fallback_scale = 0.0, np.inf, 0.0
    for (Z, scaled), (vals, valid, labels) in zip(requests, served):
        check(bool((valid == ~scaled).all()), "valid mask != rows inside the envelope")
        ref = exact(Z)[0]
        ref_labels = ref.argmax(-1)
        agree_in += int((labels[~scaled] == ref_labels[~scaled]).sum())
        agree_out += int((labels[scaled] == ref_labels[scaled]).sum())
        n_in += int((~scaled).sum())
        ref_in_labels.append(ref_labels[~scaled])
        top2 = np.sort(ref[~scaled], -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if scaled.any():
            tol = exact(Z[scaled])[1]
            err = float(np.abs(vals[scaled] - ref[scaled]).max())
            fallback_err = max(fallback_err, err)
            fallback_tol = min(fallback_tol, tol)
            fallback_scale = max(fallback_scale, float(np.abs(ref[scaled] - b).max()))
            check(err <= tol, f"fallback values: {err} > {tol}")
    ref_in_labels = np.concatenate(ref_in_labels)
    mode_share = np.bincount(ref_in_labels, minlength=K).max() / len(ref_in_labels)
    ref_x, exact_tol = exact(Z_exact)
    exact_err = float(np.abs(exact_served[0] - ref_x).max())
    # fp32 resolves B2's scores only to ~exact_tol: rows whose float64 top
    # two lie closer than twice that are ties to fp32, and their label is
    # not checked.
    top2 = np.sort(ref_x, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * exact_tol
    exact_agree = exact_served[2][decided] == ref_x.argmax(-1)[decided]
    stats = engine.stats.snapshot()
    phase(
        "main_path",
        compile_s=compile_s,
        digest=loaded.digest()[:16],
        request_rows=list(REQUEST_ROWS),
        request_ms=request_ms,
        fallback_rows=stats["fallback_instances"],
        scaled_rows=n_scaled_total,
        agree_in_envelope=agree_in / n_in,
        agree_fallback=agree_out / n_scaled_total,
        ref_labels_used=int(np.unique(ref_in_labels).size),
        ref_mode_share=float(mode_share),
        ref_min_top2_margin=float(np.concatenate(margins).min()),
        fallback_max_abs_err=fallback_err,
        fallback_tol=fallback_tol,
        fallback_max_abs_ref_minus_b=fallback_scale,
        submit_exact_max_abs_err=exact_err,
        submit_exact_tol=exact_tol,
        submit_exact_label_agree=float((exact_served[2] == ref_x.argmax(-1)).mean()),
        submit_exact_rows_tied_in_fp32=int((~decided).sum()),
        launches=launches,
        buckets=engine.jit_cache_size(),
    )
    check(stats["fallback_instances"] == n_scaled_total > 0, "fallback count")
    check(mode_share <= MAX_MODE_SHARE, "reference labels nearly constant")
    check(agree_in / n_in >= MIN_AGREE_IN_ENVELOPE, "label agreement in envelope")
    check(agree_out == n_scaled_total, "label agreement on fallback rows")
    check(exact_err <= exact_tol, f"submit_exact values: {exact_err} > {exact_tol}")
    check(bool(exact_agree.all()), "submit_exact labels on rows fp32 can decide")
    check(launches["quadform_heads"] > 0, "quadform_heads never launched")
    check(launches["rbf_scores"] > 0, "rbf_scores never launched")

    seconds["main_path"] = time.perf_counter() - t_phase

    # ------------------------------------------ kernels against plain twins
    t_phase = time.perf_counter()
    a = loaded.arrays
    heads = (a["M"], a["v"], a["c"], a["b"], a["gamma"], a["msq"])
    zero = torch.zeros_like(a["c"])
    quad_only = (a["M"], torch.zeros_like(a["v"]), zero, zero) + heads[4:]
    Zq = X_te[:1024].copy()
    Zq[::37] = push_out(Zq[::37], msq, float(gamma))  # both sides of the envelope
    Zq = torch.from_numpy(Zq).to(dev)
    b1 = {}
    for n in (32, 1024):
        cases = (("all", heads, B1_ABS), ("quad", quad_only, 0.0))
        for terms, args, abs_tol in cases:
            s, zsq, v = qf.quadform_heads_cuda(Zq[:n], *args)
            s0, zsq0, v0 = qf.quadform_heads_torch(Zq[:n], *args)
            again = qf.quadform_heads_cuda(Zq[:n], *args)
            torch.cuda.synchronize()
            err, scale = max_err(s, s0), float(s0.abs().max())
            tol = B1_REL * scale + abs_tol
            zsq_rel = float(((zsq - zsq0).abs() / zsq0.abs().clamp(min=1e-30)).max())
            res = dict(max_abs_err=err, max_abs_ref=scale, tol=tol, zsq_rel_err=zsq_rel)
            res["masks_equal"] = bool((v == v0).all())
            res["same_bits_again"] = all(torch.equal(x, y) for x, y in zip(again, (s, zsq, v)))
            phase(
                "kernel_check",
                kernel="quadform_heads",
                terms=terms,
                n=n,
                k=K,
                d=spec.d,
                **res,
            )
            what = f"quadform_heads n={n} terms={terms}"
            check(err <= tol, f"{what}: {err} > {tol}")
            check(zsq_rel <= B1_ZSQ_REL, f"{what}: |z|^2 rel {zsq_rel}")
            check(res["masks_equal"], f"{what}: masks differ")
            check(res["same_bits_again"], f"{what}: bits differ run to run")
            b1[n, terms] = res

    Zr = torch.from_numpy(X_te[:256].copy()).to(dev)
    Xd, Ad = svm.X, svm.alpha_y
    bd, gd = svm.b, svm.gamma
    b64 = svm.b.double()
    X64, A64 = svm.X.double(), svm.alpha_y.double()
    for n in (16, 256):  # a request's fallback rows (BN=32), and a full tile (BN=128)
        Zn = Zr[:n]
        out = rp.rbf_scores_cuda(Zn, Xd, Ad, gd, bd)
        again = rp.rbf_scores_cuda(Zn, Xd, Ad, gd, bd)
        out0 = rp.rbf_scores_torch(Zn, Xd, Ad, gd, bd)
        out64 = rp.rbf_scores_torch(Zn.double(), X64, A64, float(gamma), b64)
        torch.cuda.synchronize()
        err, twin_err = max_err(out, out0), max_err(out0, out64)
        tol = B2_TWIN * twin_err + B2_ABS
        same = bool(torch.equal(again, out))
        phase(
            "kernel_check",
            kernel="rbf_scores",
            n=n,
            m=N_SV,
            k=K,
            d=spec.d,
            max_abs_err=err,
            max_abs_err_vs_float64=max_err(out, out64),
            twin_max_abs_err_vs_float64=twin_err,
            rms_err_vs_float64=rms(out - out64),
            twin_rms_err_vs_float64=rms(out0 - out64),
            max_abs_ref_minus_b=float((out64 - b64).abs().max()),
            tol=tol,
            same_bits_again=same,
        )
        check(err <= tol, f"rbf_scores n={n}: {err} > {tol}")
        check(same, f"rbf_scores n={n}: bits differ run to run")
    b2_err = err  # n = 256

    seconds["kernel_check"] = time.perf_counter() - t_phase

    # --------------------------------------------------------------- timing
    t_phase = time.perf_counter()
    Zt = Zq[:1024]
    q_ms = time_ms(lambda: qf.quadform_heads_cuda(Zt, *heads))
    q_dev = device_ms(lambda: qf.quadform_heads_cuda(Zt, *heads))
    q_plain = time_ms(lambda: qf.quadform_heads_torch(Zt, *heads))
    q_lib = time_ms(lambda: torch.einsum("ni,kij,nj->nk", Zt, a["M"], Zt))
    q_bound, q_by = bound(*quadform_work(1024, K, spec.d), peak=PEAK_F32_3XTF32)
    Z32 = Zq[:32]
    q32 = time_ms(lambda: qf.quadform_heads_cuda(Z32, *heads))
    q32_plain = time_ms(lambda: qf.quadform_heads_torch(Z32, *heads))
    q32_lib = time_ms(lambda: torch.einsum("ni,kij,nj->nk", Z32, a["M"], Z32))
    q32_bound, q32_by = bound(*quadform_work(32, K, spec.d), peak=PEAK_F32_3XTF32)
    phase(
        "quadform_heads_n32",
        ms=q32,
        device_ms=device_ms(lambda: qf.quadform_heads_cuda(Z32, *heads)),
        host_ms=host_ms(lambda: qf.quadform_heads_cuda(Z32, *heads)),
        plain_ms=q32_plain,
        library_ms=q32_lib,
        bound_ms=q32_bound,
        bound_by=q32_by,
    )
    r_ms = time_ms(lambda: rp.rbf_scores_cuda(Zr, Xd, Ad, gd, bd))
    r_dev = device_ms(lambda: rp.rbf_scores_cuda(Zr, Xd, Ad, gd, bd))
    r_plain = time_ms(lambda: rp.rbf_scores_torch(Zr, Xd, Ad, gd, bd))
    r_lib = time_ms(lambda: torch.cdist(Zr, Xd))
    r_bound, r_by = bound(*rbf_work(256, N_SV, K, spec.d), peak=PEAK_F32_3XTF32)
    Z16 = Zr[:16]  # a request's fallback rows
    phase(
        "rbf_scores_n16",
        ms=time_ms(lambda: rp.rbf_scores_cuda(Z16, Xd, Ad, gd, bd)),
        device_ms=device_ms(lambda: rp.rbf_scores_cuda(Z16, Xd, Ad, gd, bd)),
        host_ms=host_ms(lambda: rp.rbf_scores_cuda(Z16, Xd, Ad, gd, bd)),
        plain_ms=time_ms(lambda: rp.rbf_scores_torch(Z16, Xd, Ad, gd, bd)),
        library_ms=time_ms(lambda: torch.cdist(Z16, Xd)),
    )

    # End to end after warmup: host clock around submit -> labels on host.
    e2e = {
        f"rows_{n}": median_request_ms(engine, Z)
        for (Z, _), n in zip(requests, REQUEST_ROWS)
    }
    phase("serve_median_ms", **e2e)
    seconds["timing"] = time.perf_counter() - t_phase
    phase("first_path_seconds", **seconds)

    # ================================================= second path (B3-B5)
    kernels_q8_rff, launches2 = second_path(
        dev, svm, loaded, X_te, Zq, exact, msq, float(gamma)
    )
    # ================================================== third path (B6, B7)
    kernels_ff, launches3 = third_path(dev)
    # =================================================== fourth path (B8, B9)
    kernels_lm, launches4 = fourth_path(dev)
    # ======================== fifth path (the runtime; its profile act last)
    launches5, out5 = fifth_path(dev, svm, loaded, X_te, requests, exact)
    # ============================ sixth path (the HTTP front door, after 5)
    p50 = out5["coalesce"]["p50_ms"]
    launches6 = sixth_path(dev, svm, loaded, requests, exact, p50)
    # ================================ seventh path (scale-out on the card)
    launches7 = seventh_path(dev, svm, loaded, X_te, Zq, requests, exact)
    # ============================ eighth path (the LM families past dense)
    kernels_fam, launches8 = eighth_path(dev)
    # ============================================ ninth path (LM training)
    kernels_train, launches9 = ninth_path(dev)
    # ============== tenth path (the tuning table, placement by the rules)
    launches10 = tenth_path(dev)
    # ================================ eleventh path (the rule-sharded steps)
    kernels_shard, launches11 = eleventh_path(dev)
    # ============ twelfth path (the sharded steps past dense and MoE, options)
    kernels_shard12, launches12 = twelfth_path(dev)
    # ============== thirteenth path (the sharded steps under SP and EP_DP)
    kernels_shard13, launches13 = thirteenth_path(dev)
    # ==================== fourteenth path (the dry run against the card)
    kernels_dry, launches14 = fourteenth_path(dev)
    # ======================= path 5's profile act, last (it slows the host)
    t0 = time.perf_counter()
    build.reset_counts()
    runtime_profile(dev, svm, loaded, requests)
    profiled = build.counts()
    phase("runtime_profile_launches", seconds=time.perf_counter() - t0, **profiled)
    launches5 = {n: launches5[n] + profiled[n] for n in launches5}
    paths = (launches, launches2, launches3, launches4)
    paths += (launches5, launches6, launches7, launches8, launches9, launches10, launches11)
    paths += (launches12, launches13, launches14)
    per_path = {n: [p[n] for p in paths] for n in launches4}

    kernels = [
        {
            "name": "quadform_heads",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quadform.cu",
            "replaces": "src/repro/kernels/quadform/kernel.py:125",
            "launches": sum(per_path["quadform_heads"]),
            "launches_per_path": per_path["quadform_heads"],
            "max_abs_err": b1[1024, "all"]["max_abs_err"],
            "ms": q_ms,
            "device_ms": q_dev,
            "plain_ms": q_plain,
            "bound_ms": q_bound,
            "bound_by": q_by,
            "library_ms": q_lib,
        },
        {
            "name": "rbf_scores",
            "route": "cuda",
            "source": "src/repro_torch/csrc/rbf_pred.cu",
            "replaces": "src/repro/kernels/rbf_pred/kernel.py:114",
            "launches": sum(per_path["rbf_scores"]),
            "launches_per_path": per_path["rbf_scores"],
            "max_abs_err": b2_err,
            "ms": r_ms,
            "device_ms": r_dev,
            "plain_ms": r_plain,
            "bound_ms": r_bound,
            "bound_by": r_by,
            "library_ms": r_lib,
        },
    ]
    kernels += kernels_q8_rff + kernels_ff + kernels_lm + kernels_fam + kernels_train + kernels_shard
    kernels += kernels_shard12 + kernels_shard13 + kernels_dry
    for entry in kernels:
        entry["launches"] = sum(per_path[entry["name"]])
        entry["launches_per_path"] = per_path[entry["name"]]
    return kernels


def second_path(dev, svm, mac, X_te, Zq, exact, msq: float, gamma: float):
    """``compile_model`` over every (family, dtype) and kernels B3-B5.

    ``mac`` is the first path's f32 maclaurin artifact, ``Zq`` its kernel
    check rows (both sides of the envelope), ``exact`` its float64
    reference. Returns (the B3-B5 ``kernels`` entries, every kernel's
    launches on this path's serving phases).
    """
    import torch

    from repro_torch.core import families
    from repro_torch.core.families import Budget, CompiledArtifact, compile_model
    from repro_torch.core.families import quantize
    from repro_torch.kernels import build
    from repro_torch.kernels.quadform import kernel as qf
    from repro_torch.serve import SVMEngine

    d = svm.X.shape[1]
    seconds = {}

    # ------------------------------------------------- B3 against its twin
    t0 = time.perf_counter()
    q8 = families.maclaurin.quantize_quadform_artifact(mac)
    _, _, q8_heads = kernel_args(q8)
    M_q, col, v_deq, _, _, g, m = q8_heads
    zero = torch.zeros_like(g)
    q8_quad = (M_q, col, torch.zeros_like(v_deq), zero, zero, g, m)
    b3 = {}
    for n in KERNEL_ROWS:
        cases = (("all", q8_heads, B1_ABS), ("quad", q8_quad, 0.0))
        for terms, args, abs_tol in cases:
            s, zsq, v = qf.quadform_heads_q8_cuda(Zq[:n], *args)
            s0, zsq0, v0 = qf.quadform_heads_q8_torch(Zq[:n], *args)
            d64 = [x if x.dtype == torch.int8 else x.double() for x in args]
            s64 = qf.quadform_heads_q8_torch(Zq[:n].double(), *d64)[0]  # the same codes
            again = qf.quadform_heads_q8_cuda(Zq[:n], *args)[0]
            torch.cuda.synchronize()
            err, scale = max_err(s, s0), float(s0.abs().max())
            tol = B1_REL * scale + abs_tol
            zsq_rel = float(((zsq - zsq0).abs() / zsq0.abs().clamp(min=1e-30)).max())
            res = dict(max_abs_err=err, max_abs_ref=scale, tol=tol, zsq_rel_err=zsq_rel)
            res["max_abs_err_vs_float64"] = max_err(s, s64)
            res["twin_max_abs_err_vs_float64"] = max_err(s0, s64)
            res["rms_err_vs_float64"] = rms(s.double() - s64)
            res["twin_rms_err_vs_float64"] = rms(s0.double() - s64)
            res["masks_equal"] = bool((v == v0).all())
            res["same_bits_again"] = bool(torch.equal(again, s))
            phase(
                "kernel_check_q8",
                kernel="quadform_heads_q8",
                terms=terms,
                n=n,
                k=K,
                d=d,
                **res,
            )
            what = f"quadform_heads_q8 n={n} terms={terms}"
            check(err <= tol, f"{what}: {err} > {tol}")
            check(zsq_rel <= B1_ZSQ_REL, f"{what}: |z|^2 rel {zsq_rel}")
            check(res["masks_equal"], f"{what}: masks differ")
            check(res["same_bits_again"], f"{what}: bits differ run to run")
            b3[n, terms] = res
    seconds["kernel_check_q8"] = time.perf_counter() - t0

    # ---------------------------------------------- B4/B5 against their twins
    t0 = time.perf_counter()
    rff_arts = {
        (f, dt): families.fourier.compile(svm, num_features=f, dtype=dt, seed=SEED)
        for f in FEATURES
        for dt in quantize.DTYPES
    }
    Zf = torch.from_numpy(X_te[: max(KERNEL_ROWS)].copy()).to(dev)
    b45 = {}
    for (f, dt), art in rff_arts.items():
        twin, kernel, args = kernel_args(art)
        name = kernel.__name__.removesuffix("_cuda")
        W = art.arrays["W"].to(torch.float32)
        if dt == "int8":
            W = W * art.arrays["W_scale"][:, None]
        for n in KERNEL_ROWS:
            # the largest cos argument, less its phase
            proj = float((Zf[:n] @ W.T).abs().max())
            b45[name, n, f] = check_fourier_kernel(
                "kernel_check_rff",
                kernel,
                twin,
                args,
                Zf[:n],
                B45_TWIN,
                B45_ABS,
                kernel=name,
                n=n,
                k=K,
                d=d,
                f=f,
                max_abs_proj=proj,
            )
    seconds["kernel_check_rff"] = time.perf_counter() - t0

    # ---------------------------------------------------------------- timing
    t0 = time.perf_counter()
    timings = {}
    M_deq = M_q.to(torch.float32) * col[:, None, :]
    for n in KERNEL_ROWS:
        Zn = Zq[:n]
        timings["quadform_heads_q8", n, None] = dict(
            ms=time_ms(lambda: qf.quadform_heads_q8_cuda(Zn, *q8_heads)),
            device_ms=device_ms(lambda: qf.quadform_heads_q8_cuda(Zn, *q8_heads)),
            host_ms=host_ms(lambda: qf.quadform_heads_q8_cuda(Zn, *q8_heads)),
            plain_ms=time_ms(lambda: qf.quadform_heads_q8_torch(Zn, *q8_heads)),
            library_ms=time_ms(lambda: torch.einsum("ni,kij,nj->nk", Zn, M_deq, Zn)),
            bound=bound(*quadform_q8_work(n, K, d), peak=PEAK_F32_3XTF32),
        )
    for (f, dt), art in rff_arts.items():
        twin, kernel, args = kernel_args(art)
        name = kernel.__name__.removesuffix("_cuda")
        W = art.arrays["W"].to(torch.float32)
        if dt == "int8":
            W = W * art.arrays["W_scale"][:, None]
        w_bytes = 1 if dt == "int8" else 4
        for n in KERNEL_ROWS:
            Zn = Zf[:n]
            timings[name, n, f] = dict(
                ms=time_ms(lambda: kernel(Zn, *args)),
                device_ms=device_ms(lambda: kernel(Zn, *args)),
                plain_ms=time_ms(lambda: twin(Zn, *args)),
                library_ms=time_ms(lambda: torch.matmul(Zn, W.T)),
                bound=bound(*rff_work(n, f, K, d, w_bytes), peak=PEAK_F32_3XTF32),
            )
    phase_kernel_times(timings)
    seconds["kernel_time"] = time.perf_counter() - t0

    # --------------------------------------------------------- compile_model
    t0 = time.perf_counter()
    budget = Budget(**BUDGET)
    winner = compile_model(svm, budget, seed=SEED)
    report = winner.meta["compile_report"]
    for row in report["families"]:
        phase("compile_model_row", **row)
    summary = {k: v for k, v in report.items() if k != "families"}
    phase("compile_model", **summary)
    rows = {(r["family"], r["dtype"]): r for r in report["families"]}
    check(len(rows) == 6, f"compile_model report cells: {sorted(rows)}")
    chosen = rows[report["chosen"], report["chosen_dtype"]]
    check(chosen["meets_budget"], "compile_model chose a candidate over budget")
    seconds["compile_model"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    structured = compile_model(
        svm,
        budget,
        seed=SEED,
        families=("maclaurin", "fourier"),
        family_opts={"fourier": {"structured": True}},
    )
    for row in structured.meta["compile_report"]["families"]:
        phase("compile_model_structured_row", **row)
        if row["family"] == "fourier":  # measured (B6/B7) or pruned, not skipped
            reason = row.get("skipped")
            check(reason in (None, "pruned_by_cost"), f"structured fourier: {row}")
    seconds["compile_model_structured"] = time.perf_counter() - t0

    # ------------------------------------- serving: the winner and every cell
    t0 = time.perf_counter()
    sample = families.fourier.holdout_sample(svm, SEED, 256)
    cells = {
        (name, dt): families.get_family(name).compile(
            svm, dtype=dt, seed=SEED, holdout=sample
        )
        for name in ("maclaurin", "poly2", "fourier")
        for dt in quantize.DTYPES
    }
    with tempfile.TemporaryDirectory() as tmp:
        path = winner.save(str(Path(tmp) / "winner.npz"))
        won = CompiledArtifact.load(path, dev)
    check(won.digest() == winner.digest(), "save/load changed the winner's digest")
    failed = cells["fourier", "float32"].with_meta(valid_globally=False)
    served = [("winner", won)] + [(f"{n}/{dt}", a) for (n, dt), a in cells.items()]
    served.append(("fourier/float32, failed verdict", failed))

    rng = np.random.default_rng(SEED + 1)
    requests, off = [], 0
    for n, n_scaled in zip(CELL_ROWS, CELL_SCALED):
        Z = X_te[off : off + n].copy()
        off += n
        scaled = np.zeros(n, bool)
        scaled[rng.choice(n, size=n_scaled, replace=False)] = True
        Z[scaled] = push_out(Z[scaled], msq, gamma)
        requests.append((Z, scaled))
    refs = [exact(Z) for Z, _ in requests]
    engines = []
    for _, art in served:
        engine = SVMEngine(art, svm, device=dev)
        engine.warmup(list(CELL_ROWS))
        engines.append(engine)
    seconds["serve_setup"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    build.reset_counts()
    results = [[e.submit(Z) for Z, _ in requests] for e in engines]
    for per_engine in results:
        for r in per_engine:
            r.labels  # materialize: the fallback rows are scored here
    launches = build.counts()
    seconds["serve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for (label, art), engine, per_engine in zip(served, engines, results):
        fields = serve_cell_checks(
            label, art, engine, per_engine, requests, refs, exact, dev
        )
        row = rows.get((art.family, art.dtype), {})
        if "mean_abs" in row:
            fields["compile_mean_abs_err"] = row["mean_abs"]
            fields["budget_limit"] = report["limit"]
        phase("serve_cell", cell=label, **fields)
        if art.family == "maclaurin" and label != "winner":
            check(fields["decided_rows"] > 0, f"{label}: no decided rows")
            share = fields["ref_mode_share"]
            check(share <= MAX_MODE_SHARE, f"{label}: reference labels one class")
            agree = fields["label_agree"]
            check(agree >= MIN_AGREE_IN_ENVELOPE, f"{label}: label agreement {agree}")
    seconds["serve_checks"] = time.perf_counter() - t0

    # End to end after warmup, per cell: host clock around submit -> labels.
    t0 = time.perf_counter()
    for (label, _), engine in zip(served, engines):
        medians = {
            f"rows_{n}": median_request_ms(engine, Z)
            for (Z, _), n in zip(requests, CELL_ROWS)
        }
        phase("serve_cell_median_ms", cell=label, **medians)
    seconds["serve_timing"] = time.perf_counter() - t0
    phase("second_path_launches", **launches)
    path_kernels = ("quadform_heads", "quadform_heads_q8", "rbf_scores")
    for name in path_kernels + ("rff_score", "rff_score_q8"):
        check(launches[name] > 0, f"{name} never launched on the second path")
    phase("second_path_seconds", **seconds)

    n_t, f_t = max(KERNEL_ROWS), FEATURES[0]
    meta = {
        "quadform_heads_q8": (
            "quadform.cu",
            "src/repro/kernels/quadform/kernel.py:222",
            b3[n_t, "all"]["max_abs_err"],
            timings["quadform_heads_q8", n_t, None],
        ),
        "rff_score": (
            "rff_score.cu",
            "src/repro/kernels/rff_score/kernel.py:169",
            b45["rff_score", n_t, f_t]["max_abs_err"],
            timings["rff_score", n_t, f_t],
        ),
        "rff_score_q8": (
            "rff_score.cu",
            "src/repro/kernels/rff_score/kernel.py:121",
            b45["rff_score_q8", n_t, f_t]["max_abs_err"],
            timings["rff_score_q8", n_t, f_t],
        ),
    }
    entries = [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": t["ms"],
            **({"device_ms": t["device_ms"]} if "device_ms" in t else {}),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        }
        for name, (source, replaces, err, t) in meta.items()
    ]
    return entries, launches


def third_path(dev):
    """Training on the card, ``compile_model`` with the Fastfood projection
    and kernels B6/B7.

    Returns (the B6/B7 ``kernels`` entries, every kernel's launches on
    this path: training, ``compile_model`` and serving; the kernel checks
    and timings come after the count is read).
    """
    import torch

    from repro_torch import svm as training
    from repro_torch.core import backend, families, gamma_max
    from repro_torch.core.families import Budget, CompiledArtifact, compile_model
    from repro_torch.core.families import quantize
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.fwht import ref as ffref
    from repro_torch.serve import SVMEngine
    from repro_torch.svm import dual

    seconds = {}
    rng = np.random.default_rng(SEED + 2)
    X_mnist, y_mnist, Xm_te, ym_te, spec = make_dataset("mnist", scale=0.1, seed=SEED)
    d = spec.d
    mus = rng.standard_normal((K, d)) * 3
    y_all = np.arange(OVR_TRAIN + OVR_TEST) % K
    X_all = (rng.standard_normal((len(y_all), d)) + mus[y_all]).astype(np.float32)
    X_tr, y_tr = X_all[:OVR_TRAIN], y_all[:OVR_TRAIN]
    X_te, y_te = X_all[OVR_TRAIN:], y_all[OVR_TRAIN:]

    # ---------------------------------------------------------------- train
    build.reset_counts()
    t_train = t0 = time.perf_counter()
    Xd = torch.from_numpy(X_tr).to(dev)
    gamma = OVR_GAMMA_SHARE * float(gamma_max(Xd))
    ovr = training.train_one_vs_rest(
        Xd, torch.from_numpy(y_tr).to(dev), K, gamma, OVR_REG_C
    )
    torch.cuda.synchronize()
    ovr_s = time.perf_counter() - t0
    acc_tr = float((training.ovr_predict(ovr, X_tr).cpu().numpy() == y_tr).mean())
    acc_te = float((training.ovr_predict(ovr, X_te).cpu().numpy() == y_te).mean())
    phase(
        "train_one_vs_rest",
        seconds=ovr_s,
        n=OVR_TRAIN,
        d=d,
        k=K,
        gamma=gamma,
        reg_c=OVR_REG_C,
        train_acc=acc_tr,
        test_acc=acc_te,
        max_abs_alpha=float(ovr.alpha_y.abs().max()),
    )
    check(acc_tr > MIN_OVR_TRAIN_ACC, f"one-vs-rest train accuracy {acc_tr}")

    # The dual C-SVC, "class vs others": on mnist rows at the spec gamma, and
    # on class 0 of the one-vs-rest rows at their gamma.
    svc_tasks = {
        "mnist": (X_mnist, y_mnist, Xm_te, ym_te, spec.paper_gamma),
        "class0": (
            X_tr,
            np.where(y_tr == 0, 1.0, -1.0),
            X_te,
            np.where(y_te == 0, 1.0, -1.0),
            gamma,
        ),
    }
    svc_n_sv = {}
    for task, (Xs, ys, Xs_te, ys_te, g) in svc_tasks.items():
        t0 = time.perf_counter()
        Xs_d = torch.from_numpy(Xs[:SVC_ROWS]).to(dev)
        ys_d = torch.from_numpy(ys[:SVC_ROWS].astype(np.float32)).to(dev)
        model, mask = training.train_svc(Xs_d, ys_d, g, SVC_C, num_steps=SVC_STEPS)
        small = dual.compress_support(model, mask)
        torch.cuda.synchronize()
        svc_s = time.perf_counter() - t0
        Zs = torch.from_numpy(np.ascontiguousarray(Xs_te[:1024])).to(dev)

        def decide(m, Z):
            return backend.rbf_scores(Z, m.X, m.alpha_y, m.gamma, m.b)

        dense, comp = decide(model, Zs), decide(small, Zs)
        gap = float((comp - dense).abs().max())
        tol_ok = bool(
            ((comp - dense).abs() <= SVC_ATOL + SVC_RTOL * dense.abs()).all()
        )
        on_tr = torch.sign(decide(model, Xs_d)) == ys_d
        on_te = torch.sign(dense).cpu().numpy() == ys_te[:1024]
        svc_n_sv[task] = small.n_sv
        kept = model.alpha_y.abs()[mask]
        phase(
            "train_svc",
            task=task,
            seconds=svc_s,
            n=SVC_ROWS,
            steps=SVC_STEPS,
            c=SVC_C,
            gamma=float(g),
            n_sv=small.n_sv,
            min_kept_alpha_over_threshold=float(kept.min()) / (1e-6 * SVC_C),
            train_acc=float(on_tr.float().mean()),
            test_acc=float(on_te.mean()),
            compressed_max_abs_diff=gap,
        )
        check(tol_ok, f"svc {task}: compressed and dense differ by {gap}")
    # On the mnist rows the reference trainer keeps every row (its smallest
    # alpha is ~6e4 times the threshold, so no row is near the cut); the
    # class-0 task shows the sparsity.
    n_sv = svc_n_sv["mnist"]
    check(n_sv == SVC_MNIST_N_SV, f"svc mnist: n_sv {n_sv}, reference {SVC_MNIST_N_SV}")
    n_sv = svc_n_sv["class0"]
    check(0 < n_sv < SVC_ROWS, f"svc class0: n_sv {n_sv} of {SVC_ROWS}")
    seconds["train"] = time.perf_counter() - t_train

    # --------------------------------------------------------- compile_model
    t0 = time.perf_counter()
    budget = Budget(**BUDGET)
    ff_opts = {"structured": True, "num_features": FF_FEATURES[0]}
    winner = compile_model(ovr, budget, seed=SEED, family_opts={"fourier": ff_opts})
    report = winner.meta["compile_report"]
    for row in report["families"]:
        phase("compile_model_row", path=3, **row)
    summary = {k: v for k, v in report.items() if k != "families"}
    phase("compile_model", path=3, **summary)
    rows = {(r["family"], r["dtype"]): r for r in report["families"]}
    check(len(rows) == 6, f"compile_model report cells: {sorted(rows)}")
    for dt in quantize.DTYPES:
        row = rows["fourier", dt]
        reason = row.get("skipped")
        check(reason in (None, "pruned_by_cost"), f"structured fourier {dt}: {row}")
    seconds["compile_model"] = time.perf_counter() - t0

    # ------------------------------------ serve the Fastfood artifacts (B6/B7)
    t0 = time.perf_counter()
    sample = families.fourier.holdout_sample(ovr, SEED, 256)
    arts = {
        dt: training.compile_ovr(
            ovr, "fourier", dtype=dt, seed=SEED, holdout=sample, **ff_opts
        )
        for dt in quantize.DTYPES
    }
    served = []
    with tempfile.TemporaryDirectory() as tmp:
        for dt, art in arts.items():
            loaded = CompiledArtifact.load(art.save(str(Path(tmp) / f"{dt}.npz")), dev)
            check(loaded.digest() == art.digest(), f"save/load changed fastfood {dt}")
            served.append((f"fastfood/{dt}", loaded))
            failed = loaded.with_meta(valid_globally=False)
            served.append((f"fastfood/{dt}, failed verdict", failed))
    requests, off = [], 0
    for n in CELL_ROWS:
        requests.append((X_te[off : off + n].copy(), np.zeros(n, bool)))
        off += n
    exact = exact64(ovr, dev)
    refs = [exact(Z) for Z, _ in requests]
    engines = []
    for _, art in served:
        engine = SVMEngine(art, ovr, device=dev)
        engine.warmup(list(CELL_ROWS))
        engines.append(engine)
    results = [[e.submit(Z) for Z, _ in requests] for e in engines]
    for per_engine in results:
        for r in per_engine:
            r.labels  # materialize: the fallback rows are scored here
    launches = build.counts()
    seconds["serve"] = time.perf_counter() - t0
    phase("third_path_launches", **launches)
    for name in ("fastfood_score", "fastfood_score_q8", "rbf_scores"):
        check(launches[name] > 0, f"{name} never launched on the third path")

    for (label, art), engine, per_engine in zip(served, engines, results):
        fields = serve_cell_checks(
            label, art, engine, per_engine, requests, refs, exact, dev
        )
        fields["compile_mean_abs_err"] = rows["fourier", art.dtype].get("mean_abs")
        fields["budget_limit"] = report["limit"]
        phase("serve_cell", path=3, cell=label, **fields)
    for (label, _), engine in zip(served, engines):
        medians = {
            f"rows_{n}": median_request_ms(engine, Z)
            for (Z, _), n in zip(requests, CELL_ROWS)
        }
        phase("serve_cell_median_ms", path=3, cell=label, **medians)

    # --------------------------------- B6/B7 against their twins, and timed
    t0 = time.perf_counter()
    ff_arts = {(FF_FEATURES[0], dt): a.to(dev) for dt, a in arts.items()}
    for dt in quantize.DTYPES:
        opts = dict(ff_opts, num_features=FF_FEATURES[1])
        ff_arts[FF_FEATURES[1], dt] = training.compile_ovr(
            ovr, "fourier", dtype=dt, seed=SEED, holdout=sample, **opts
        )
    Zf = torch.from_numpy(X_te[: max(KERNEL_ROWS)].copy()).to(dev)
    eye = torch.eye(d, device=dev)
    checks, timings = {}, {}
    for (f, dt), art in ff_arts.items():
        twin, kernel, args = kernel_args(art)
        name = kernel.__name__.removesuffix("_cuda")
        for n in KERNEL_ROWS:
            checks[name, n, f] = check_fourier_kernel(
                "kernel_check_fastfood",
                kernel,
                twin,
                args,
                Zf[:n],
                FF_TWIN,
                FF_ABS,
                kernel=name,
                n=n,
                k=K,
                d=d,
                f=f,
            )
        # The dense (F, d) matrix the structured operator stands for: the
        # library yardstick is the one product that projects Z through it.
        a = art.arrays
        B, G, S = (a[k].to(torch.float32) for k in ("ff_b", "ff_g", "ff_scale"))
        if dt == "int8":
            S = S * a["ff_stack_scale"][:, None]
        W_eq = ffref.fastfood_project(eye, B, G, a["ff_perm"], S).T.contiguous()
        w_bytes = 1 if dt == "int8" else 4
        for n in KERNEL_ROWS:
            Zn = Zf[:n]
            timings[name, n, f] = dict(
                ms=time_ms(lambda: kernel(Zn, *args)),
                device_ms=device_ms(lambda: kernel(Zn, *args)),
                host_ms=host_ms(lambda: kernel(Zn, *args)),
                plain_ms=time_ms(lambda: twin(Zn, *args)),
                library_ms=time_ms(lambda: torch.matmul(Zn, W_eq.T)),
                bound=fastfood_bound(n, f, K, d, w_bytes),
            )
    phase_kernel_times(timings)
    seconds["kernel_checks"] = time.perf_counter() - t0
    phase("third_path_seconds", **seconds)

    n_t, f_t = max(KERNEL_ROWS), FF_FEATURES[0]
    entries = []
    for name, line in (("fastfood_score", 137), ("fastfood_score_q8", 198)):
        t = timings[name, n_t, f_t]
        entries.append(
            {
                "name": name,
                "route": "cuda",
                "source": "src/repro_torch/csrc/fastfood.cu",
                "replaces": f"src/repro/kernels/fwht/kernel.py:{line}",
                "launches": launches[name],
                "max_abs_err": checks[name, n_t, f_t]["max_abs_err"],
                "ms": t["ms"],
                "device_ms": t["device_ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1],
                "library_ms": t["library_ms"],
            }
        )
    return entries, launches


def lm_config(**changes):
    """The fourth path's model configuration: ``LM_NAME`` at full width."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_NAME), **changes)


def attention_entries(cases, checks, timings, launches) -> list:
    """The ``kernels`` entries of B8/B9 at ``cases``' shapes
    (``attention_kernel_checks``' checks and timings), with a path's
    launches."""
    entries = []
    for name, case, (bh, t, d, dv), _ in cases:
        source, line = ("maclaurin_attn", 137) if name == "maclaurin_attention" else ("flash_attn", 95)
        tm = timings[name, case]
        entries.append(
            {
                "name": name,
                "case": case,
                "shape": [bh, t, d, dv],
                "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}.cu",
                "replaces": f"src/repro/kernels/{source}/kernel.py:{line}",
                "launches": launches[name],
                "max_abs_err": checks[name, case]["max_abs_err"],
                "ms": tm["ms"],
                "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound"][0],
                "bound_by": tm["bound"][1],
                "library_ms": tm["library_ms"],
            }
        )
    return entries


def attention_kernel_checks(dev, cases=ATTN_CASES) -> tuple[dict, dict]:
    """B9 and B8 against their plain twins and float64 at the ``cases``'
    attention shapes, and timed; B8 by each of its routes, forced, and
    unforced by the one ``route`` picks, which must be the faster. Returns
    (checks, timings), keyed by (kernel, case), for B8 of the route taken."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.common import tuning
    from repro_torch.kernels.flash_attn import kernel as fa
    from repro_torch.kernels.maclaurin_attn import kernel as ma
    from repro_torch.kernels.maclaurin_attn.ref import (
        maclaurin_attention_ref,
        softmax_attention_ref,
    )
    from repro_torch.launch.op_cost import flash_work, maclaurin_work

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(bh, t, d, dv, dtype):
        q, k = (torch.randn((bh, t, d), generator=gen, device=dev) for _ in range(2))
        v = torch.randn((bh, t, dv), generator=gen, device=dev)
        return [x.to(dtype).contiguous() for x in (q, k, v)]

    def oracle(fn, q, k, v):
        """``fn`` in float64, a few heads at a time (it holds T x T weights)."""
        g = max(1, 2**28 // q.shape[1] ** 2)
        scale = q.shape[-1] ** -0.5
        parts = [
            fn(*(x[i : i + g].double() for x in (q, k, v)), scale=scale)
            for i in range(0, q.shape[0], g)
        ]
        return torch.cat(parts)

    checks, timings = {}, {}
    chunk = tuning.lookup("maclaurin_attn").chunk  # the model's, the one B8 chunk
    for name, case, (bh, t, d, dv), dtype in cases:
        is_flash = name == "flash_attention"
        dtype = getattr(torch, dtype)
        q, k, v = inputs(bh, t, d, dv, dtype)
        if is_flash:
            launches = {None: lambda: fa.flash_attention_cuda(q, k, v)}
            plain = lambda: fa.flash_attention_torch(q, k, v)  # noqa: E731
            exact_fn = softmax_attention_ref
            route = None
        else:
            width = next(w for w in ma.HEAD_DIMS if w >= d)  # the kernel pads d to it
            route = ma.route(bh, t, width, dv)
            launches = {
                r: (lambda r=r: ma.maclaurin_attention_cuda(q, k, v, force_route=r))
                for r in (route, *(r for r in ma.ROUTES if r != route))
            }
            plain = lambda: ma.maclaurin_attention_torch(q, k, v)  # noqa: E731
            exact_fn = maclaurin_attention_ref
        twin = plain()
        exact = oracle(exact_fn, q, k, v)
        twin_err = max_err(twin, exact)
        tol = ATTN_TWIN * twin_err + ATTN_ABS
        for r, launch in launches.items():
            out, again = launch(), launch()
            torch.cuda.synchronize()
            err = max_err(out, twin)
            res = dict(
                max_abs_err=err,
                twin_max_abs_err_vs_float64=twin_err,
                max_abs_err_vs_float64=max_err(out, exact),
                tol=tol,
                max_abs_ref=float(twin.double().abs().max()),
                same_bits_again=bool(torch.equal(again, out)),
            )
            if r == route and not is_flash:
                unforced = ma.maclaurin_attention_cuda(q, k, v)
                res["unforced_same_bits"] = bool(torch.equal(unforced, out))
            if dtype == torch.bfloat16:
                res.update(bf16_rounding_check(q, k, v, out, exact))
            phase(
                "kernel_check",
                kernel=name,
                case=case,
                bh=bh,
                t=t,
                d=d,
                dv=dv,
                dtype=str(dtype).removeprefix("torch."),
                chunk=None if is_flash else chunk,
                route=r,
                route_taken=route,
                **res,
            )
            what = f"{name} {case}" + (f" ({r} route)" if r else "")
            check(err <= tol, f"{what}: {err} > {tol}")
            if dtype == torch.bfloat16:
                check(res["bf16_worst_margin"] >= 0, f"{what}: beyond bf16 rounding of the f32 twin")
                check(res["control_bf16_worst_margin"] < 0, f"{what}: the dropped-tile control passed")
            check(res["same_bits_again"], f"{what}: bits differ run to run")
            check(res.get("unforced_same_bits", True), f"{what}: unforced, another route ran")
            check(bool(torch.isfinite(out).all()), f"{what}: not finite")
            if r == route:
                checks[name, case] = res
            del out, again
        del exact
        if t % 64:  # ragged cases are checked, not timed
            continue
        iters = 5 if is_flash else 3
        if is_flash:
            q4, k4, v4 = (x.view(1, bh, t, -1) for x in (q, k, v))
            library = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)  # noqa: E731
            work = flash_work(bh, t, d, dv, q.element_size())
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_3XTF32
        else:
            library = None  # no PyTorch call computes w(u) attention
            work = maclaurin_work(bh, t, d, dv, chunk)
            peak = PEAK_F32_3XTF32  # the card's f32-accurate product rate, whichever route
        route_ms = {r: time_ms(launch, iters=iters, warm=1) for r, launch in launches.items()}
        timings[name, case] = dict(
            ms=route_ms[route],
            plain_ms=time_ms(plain, iters=iters, warm=1),
            library_ms=time_ms(library, iters=iters, warm=1) if library else None,
            bound=bound(*work, peak=peak),
        )
        t_ = timings[name, case]
        for r, ms in route_ms.items():
            check(ms >= t_["bound"][0], f"{name} {case} ({r} route): faster than its bound")
        if not is_flash:
            other = min(ms for r, ms in route_ms.items() if r != route)
            check(t_["ms"] <= other, f"{name} {case}: the {route} route taken is the slower")
        phase(
            "kernel_time",
            kernel=name,
            case=case,
            route=route,
            route_ms={r: ms for r, ms in route_ms.items() if r},
            bound_ms=t_["bound"][0],
            bound_by=t_["bound"][1],
            **{k_: t_[k_] for k_ in ("ms", "plain_ms", "library_ms")},
        )
    return checks, timings


def bf16_rounding_check(q, k, v, out, exact) -> dict:
    """B9's bf16 output against the f32 twin's value before rounding, element
    by element (see BF16_HALF_STEP), and the same check of a control: the
    output with the last query tile's rows recomputed without the first key
    tile, the rows whose values are smallest and change least. Returns the
    worst margin of each (negative: the check fails) and the control's
    max|delta| (one bf16 step of max|out|, the limit this check replaced,
    would let it pass)."""
    import torch

    from repro_torch.kernels.common import tuning
    from repro_torch.kernels.flash_attn import kernel as fa

    twin32 = fa.flash_attention_torch(q.float(), k.float(), v.float()).double()
    tol32 = ATTN_TWIN * max_err(twin32, exact) + ATTN_ABS

    def margin(x):
        room = BF16_HALF_STEP * twin32.abs() + (1 + BF16_HALF_STEP) * tol32
        return float((room - (x.double() - twin32).abs()).min())

    tile = tuning.lookup("flash_attn").block_k  # the kernel's key tile
    rows = min(tile, q.shape[1] - tile)
    late = fa.flash_attention_torch(q[:, tile:], k[:, tile:], v[:, tile:])[:, -rows:]
    control = torch.cat([out[:, :-rows], late], dim=1)
    return dict(
        bf16_worst_margin=margin(out),
        bf16_tol32=tol32,
        control_bf16_worst_margin=margin(control),
        control_max_abs_err=max_err(control, twin32),
    )


def logit_gate(test, ref, rel: float, gap: float, against: str = "ref") -> dict:
    """``test`` logits against ``ref``: max|delta| within ``rel`` of
    max|ref|, and top-1 equal wherever ref's top-2 gap exceeds ``gap`` of
    max|ref| (see PREFILL_REL); and the share of positions whose own
    max|delta| is within that rule (see MOE_SHARE)."""
    test, ref = test.float(), ref.float()
    delta = float((test - ref).abs().max())
    scale = float(ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > gap * scale
    agree = test.argmax(-1) == ref.argmax(-1)
    within = (test - ref).abs().amax(-1) <= rel * scale
    return {
        f"max_abs_vs_{against}": delta,
        "max_abs_ref": scale,
        "rel": delta / scale,
        "rel_tol": rel,
        "max_ok": delta <= rel * scale,
        "positions_within_rel": float(within.float().mean()),
        "top1_agree": float(agree.float().mean()),
        "decided_positions": int(decided.sum()),
        "gap": gap,
        "top1_ok": bool(agree[decided].all()),
    }


def hold(gate: dict, share: float | None, what: str) -> list[tuple[bool, str]]:
    """The checks of a ``logit_gate``, as (ok, what) to ``check`` after its
    phase line: max|delta| and top-1 on decided positions; for an MoE,
    at least ``share`` of the positions within the rule (see MOE_SHARE)."""
    rel = gate["rel_tol"]
    if share is not None:
        got = gate["positions_within_rel"]
        what = f"{what}: {got} of positions within {rel}, want {share}"
        return [(got >= share, what)]
    return [
        (gate["max_ok"], f"{what}: beyond {rel} of max|logit|"),
        (gate["top1_ok"], f"{what}: top-1 on decided positions"),
    ]


def fourth_path(dev):
    """Path 4, the LM side (kernels B8, B9): ``LM_NAME`` at full width from
    seeded random weights. Prefill through ``make_prefill_step`` with the
    blockwise, flash and maclaurin attention; decode token by token through
    ``make_serve_step`` at f32 with an f32, a bf16 and an int8 KV cache and
    the ``MacState`` (on a CONS_LAYERS-deep model of the same width),
    held against the matching forward or the next wider cache; then
    ``greedy_generate`` from the filled caches. Returns (the
    B8/B9 ``kernels`` entries, every kernel's launches on this path)."""
    import dataclasses

    import torch

    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.serve.decode_step import (
        greedy_generate,
        make_prefill_step,
        make_serve_step,
    )

    seconds = {}
    t0 = time.perf_counter()
    checks, timings = attention_kernel_checks(dev)
    torch.cuda.empty_cache()
    seconds["lm_kernels"] = time.perf_counter() - t0

    # ---------------------------------------------------------- lm_prefill
    t0 = time.perf_counter()
    cfg = lm_config()
    params = tf.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_T), generator=gen, device=dev)
    prefill_cfgs = {
        "blockwise": lm_config(attention_impl="blockwise"),
        "flash": lm_config(attention_impl="flash"),
        "maclaurin": lm_config(attention_backend="maclaurin"),
    }
    want = {
        "blockwise": {},
        "flash": {"flash_attention": cfg.n_layers},
        "maclaurin": {"maclaurin_attention": cfg.n_layers},
    }
    build.reset_counts()
    logits, per_cfg = {}, {}
    for label, c in prefill_cfgs.items():
        before = build.counts()
        logits[label] = make_prefill_step(c)(params, tokens)
        torch.cuda.synchronize()
        after = build.counts()
        per_cfg[label] = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        check(
            per_cfg[label] == want[label],
            f"prefill {label}: launches {per_cfg[label]}, want {want[label]}",
        )
        check(bool(torch.isfinite(logits[label]).all()), f"prefill {label}: not finite")
    flash = logit_gate(logits["flash"], logits["blockwise"], PREFILL_REL, PREFILL_GAP)
    control = logit_gate(logits["maclaurin"], logits["blockwise"], PREFILL_REL, PREFILL_GAP)
    phase(
        "lm_prefill",
        model=cfg.name,
        params=n_params,
        dtype=cfg.dtype,
        batch=LM_B,
        tokens=LM_T,
        launches=per_cfg,
        flash_vs_blockwise=flash,
        control_maclaurin_vs_blockwise=control,
    )
    check(flash["max_ok"], f"flash vs blockwise logits beyond {PREFILL_REL} of max|logit|")
    check(flash["top1_ok"], "flash vs blockwise top-1 on decided positions")
    check(not control["max_ok"], "the maclaurin control passed the flash gate")
    del logits
    seconds["lm_prefill"] = time.perf_counter() - t0

    # ------------------------------------------------------ lm_consistency
    t0 = time.perf_counter()
    cfg32 = lm_config(dtype="float32", n_layers=CONS_LAYERS)
    cons = tf.init_params(cfg32, seed=SEED, device=dev)  # the decode's depth-cut model
    prompt = tokens[:CONS_B, :CONS_T]
    s_max = CONS_T + GEN_STEPS
    kinds = {  # config, and the KV cache's dtype where it has one
        "f32": (dataclasses.replace(cfg32, attention_impl="flash"), torch.float32),
        "bf16": (cfg32, torch.bfloat16),
        "int8": (dataclasses.replace(cfg32, kv_cache_dtype="int8"), None),
        "maclaurin": (dataclasses.replace(cfg32, attention_backend="maclaurin"), None),
    }
    full = {
        "f32": tf.forward(kinds["f32"][0], cons, prompt)[0],  # B9 at f32
        "maclaurin": tf.forward(kinds["maclaurin"][0], cons, prompt)[0],  # B8, chunk 64
    }
    caches, decoded, step_ms = {}, {}, {}
    for kind, (c, cache_dtype) in kinds.items():
        cache = tf.init_cache(c, CONS_B, s_max, dtype=cache_dtype, device=dev)
        step = make_serve_step(c)
        outs = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for pos in range(CONS_T):
            lg, cache = step(cons, prompt[:, pos : pos + 1], pos, cache)
            outs.append(lg)
        torch.cuda.synchronize()
        step_ms[kind] = (time.perf_counter() - t1) * 1e3 / CONS_T
        caches[kind], decoded[kind] = cache, torch.cat(outs, dim=1)
    gates = {}
    # the reference's consistency check: decode against the forward
    for kind in ("f32", "maclaurin"):
        dec, ref = decoded[kind], full[kind]
        err = (dec - ref).abs()
        over = float((err - (CONS_ATOL + CONS_RTOL * ref.abs())).max())
        gates[kind] = dict(
            max_abs_err_vs_forward=float(err.max()),
            max_abs_ref=float(ref.abs().max()),
            worst_margin_to_tol=-over,
            top1_agree=float((dec.argmax(-1) == ref.argmax(-1)).float().mean()),
        )
        check(over <= 0, f"{kind} decode vs forward beyond rtol=atol={CONS_RTOL}")
    # a narrower cache against the next wider one, and the control
    for kind, wider, rel, gap in (
        ("bf16", "f32", BF16_CACHE_REL, BF16_CACHE_GAP),
        ("int8", "bf16", INT8_CACHE_REL, INT8_CACHE_GAP),
    ):
        gates[kind] = logit_gate(decoded[kind], decoded[wider], rel, gap, against=wider)
        check(gates[kind]["max_ok"], f"{kind} cache vs {wider} beyond {rel} of max|logit|")
        check(gates[kind]["top1_ok"], f"{kind} cache top-1 on decided positions")
    rel = max(BF16_CACHE_REL, INT8_CACHE_REL)
    control = logit_gate(decoded["maclaurin"], decoded["f32"], rel, INT8_CACHE_GAP, against="f32")
    gates["control_maclaurin"] = control
    check(not control["max_ok"], "the maclaurin control passed the cache gates")
    phase(
        "lm_consistency",
        model=cfg32.name,
        layers=CONS_LAYERS,
        dtype="float32",
        batch=CONS_B,
        tokens=CONS_T,
        step_ms=step_ms,
        **gates,
    )
    next_tok = decoded["bf16"][:, -1:].argmax(-1).to(torch.int32)
    del full, decoded, dec, ref
    seconds["lm_consistency"] = time.perf_counter() - t0

    # --------------------------------------------------------- lm_generate
    t0 = time.perf_counter()
    generated = {}
    for kind in ("bf16", "int8", "maclaurin"):
        c = kinds[kind][0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, cache = greedy_generate(
            c, cons, next_tok, caches[kind], steps=GEN_STEPS, start_pos=CONS_T
        )
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / GEN_STEPS
        check(toks.shape == (CONS_B, GEN_STEPS), f"generate {kind}: shape {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < c.vocab_size)).all()), f"generate {kind}: token ids")
        generated[kind] = toks
        grown = tf.cache_bytes(tf.init_cache(c, CONS_B, 16 * s_max, device=dev))
        if kind == "maclaurin":
            check(grown == tf.cache_bytes(cache), "MacState bytes grew with the context")
        else:
            check(grown == 16 * tf.cache_bytes(cache), f"{kind} KV bytes not linear in S")
        phase(
            "lm_generate",
            cache=kind,
            steps=GEN_STEPS,
            start_pos=CONS_T,
            ms_per_token=ms,
            state_bytes=tf.cache_bytes(cache),
            state_bytes_at_16x_context=grown,
            first_tokens=toks[0, :8].tolist(),
        )
    same = float((generated["int8"] == generated["bf16"]).float().mean())
    phase("lm_generate_agreement", int8_vs_bf16_tokens=same)
    del cons, caches
    launches = build.counts()
    phase("fourth_path_launches", **launches)
    seconds["lm_generate"] = time.perf_counter() - t0

    # ---------------------------------------------------- prefill timings
    t0 = time.perf_counter()
    for label, c in prefill_cfgs.items():
        step = make_prefill_step(c)
        ms = time_ms(lambda: step(params, tokens), iters=3, warm=1)
        phase("lm_prefill_time", config=label, ms=ms, tokens_per_s=LM_B * LM_T / ms * 1e3)
    seconds["prefill_timing"] = time.perf_counter() - t0
    phase("fourth_path_seconds", **seconds)

    entries = []
    for name, source, line in (
        ("maclaurin_attention", "maclaurin_attn", 137),
        ("flash_attention", "flash_attn", 95),
    ):
        case = "model" if name == "maclaurin_attention" else "model bf16"
        t = timings[name, case]
        entries.append(
            {
                "name": name,
                "case": case,
                "shape": list(LM_ATTN),
                "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}.cu",
                "replaces": f"src/repro/kernels/{source}/kernel.py:{line}",
                "launches": launches[name],
                "max_abs_err": checks[name, case]["max_abs_err"],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1],
                "library_ms": t["library_ms"],
            }
        )
    return entries, launches


def family_config(name: str, layers: int, **changes):
    """Path 8's configuration: ``name`` at full width, ``layers`` deep."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), n_layers=layers, **changes)


def attention_applications(cfg) -> int:
    """Self-attention applications in one forward (each one B8 or B9
    launch): none for RWKV6, the shared block's for a hybrid, the self
    layers of a VLM."""
    from repro_torch.models import transformer as tf

    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "vlm":
        return tf.vlm_layout(cfg)[1]
    return cfg.n_layers


class maclaurin_cross:
    """Within it, the port's forward runs a VLM's cross-attention as the
    plain function its cross ``MacState`` reads out in decode: weights
    w(u) = 1 + u + u^2/2 over every image key, normalized, in f32. The
    reference's forward keeps softmax there (decode alone reads the
    state), so this is the forward a maclaurin decode is held against."""

    def __enter__(self):
        import torch

        from repro_torch.kernels.maclaurin_attn.ref import maclaurin_weights
        from repro_torch.models import transformer as tf

        def cross(params, x, ctx, *, n_heads, n_kv, head_dim):
            B, T, _ = x.shape
            N, g, f32 = ctx.shape[1], n_heads // n_kv, torch.float32
            q = (x @ params["w_q"]).reshape(B, T, n_kv, g, head_dim).to(f32)
            k = (ctx @ params["w_k"]).reshape(B, N, n_kv, head_dim).to(f32)
            v = (ctx @ params["w_v"]).reshape(B, N, n_kv, head_dim).to(f32)
            u = torch.einsum("bthgd,bshd->bhgts", q, k) / head_dim**0.5
            w = maclaurin_weights(u)
            out = torch.einsum("bhgts,bshd->bthgd", w, v)
            out = out / w.sum(-1).permute(0, 3, 1, 2)[..., None]
            return out.to(x.dtype).reshape(B, T, n_heads * head_dim) @ params["w_o"]

        self.tf, self.saved = tf, tf.cross_attention
        tf.cross_attention = cross
        return self

    def __exit__(self, *exc):
        self.tf.cross_attention = self.saved


def family_path(dev, name: str, layers: int, batch: int) -> tuple[dict, dict]:
    """One model of path 8: bf16 prefill (blockwise, flash: B9, maclaurin:
    B8; RWKV6 its one stack), f32 decode of a FAM_CONS_T-token prompt
    through each cache the family has, greedy tokens from each, then the
    prefill timed. Launch counts are set to 0 before the driven run and
    read after it (before the timing). Returns (those launches, summary)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.serve.decode_step import (
        greedy_generate,
        make_prefill_step,
        make_serve_step,
    )

    seconds = {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = family_config(name, layers)
    params = tf.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, FAM_T), generator=gen, device=dev)
    vlm, moe = cfg.family == "vlm", bool(cfg.moe_num_experts)
    img = None
    if vlm:
        shape = (batch, cfg.n_image_tokens, cfg.d_model)
        img = torch.randn(shape, generator=gen, device=dev)
    extra = (img,) if vlm else ()
    n_attn = attention_applications(cfg)
    prefill_cfgs = {"blockwise": family_config(name, layers)}
    if n_attn:
        prefill_cfgs["flash"] = family_config(name, layers, attention_impl="flash")
        prefill_cfgs["maclaurin"] = family_config(
            name, layers, attention_backend="maclaurin"
        )
        for impl in ("blockwise", "flash"):  # the pair at f32 (see MOE_SHARE)
            prefill_cfgs[f"{impl} f32"] = family_config(
                name, layers, dtype="float32", attention_impl=impl
            )
    want = {
        label: {"flash_attention": n_attn} if "flash" in label else {}
        for label in prefill_cfgs
    }
    want["maclaurin"] = {"maclaurin_attention": n_attn}
    seconds["init"] = time.perf_counter() - t0

    # ------------------------------------------------------ family_prefill
    t0 = time.perf_counter()
    build.reset_counts()
    logits, aux, per_cfg, holds = {}, {}, {}, []
    for label, c in prefill_cfgs.items():
        before = build.counts()
        logits[label], aux[label] = tf.forward(c, params, tokens, *extra)
        torch.cuda.synchronize()
        after = build.counts()
        got = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        per_cfg[label] = got
        what = f"{name} prefill {label}"
        holds += [
            (got == want[label], f"{what}: launches {got}, want {want[label]}"),
            (bool(torch.isfinite(logits[label]).all()), f"{what}: not finite"),
            (bool(torch.isfinite(aux[label])), f"{what}: aux not finite"),
            (moe or float(aux[label]) == 0.0, f"{what}: aux of no MoE"),
        ]
    fields = dict(
        model=name,
        layers=f"{layers} of {get_config(name).n_layers}",
        params=n_params,
        dtype=cfg.dtype,
        batch=batch,
        tokens=FAM_T,
        image_tokens=cfg.n_image_tokens if vlm else 0,
        launches=per_cfg,
        aux={label: float(a) for label, a in aux.items()},
    )
    if n_attn:
        gate = functools.partial(logit_gate, rel=PREFILL_REL, gap=PREFILL_GAP)
        flash = gate(logits["flash"], logits["blockwise"])
        own = gate(logits["blockwise"], logits["blockwise f32"], against="f32")
        flash32 = gate(logits["flash f32"], logits["blockwise f32"])
        control = gate(logits["maclaurin"], logits["blockwise"])
        fields.update(
            flash_vs_blockwise=flash,
            blockwise_bf16_vs_f32=own,
            f32_flash_vs_blockwise=flash32,
            maclaurin_vs_blockwise=control,
        )
        limit = max(PREFILL_REL * flash["max_abs_ref"], 2 * own["max_abs_vs_f32"])
        holds.append(
            (
                flash["max_abs_vs_ref"] <= limit,
                f"{name}: bf16 flash vs blockwise {flash['max_abs_vs_ref']} > {limit}",
            )
        )
        share = MOE_F32_SHARE if moe else None
        holds += hold(flash32, share, f"{name}: f32 flash vs blockwise")
    del logits
    phase("family_prefill", **fields)
    for ok, what in holds:
        check(ok, what)
    seconds["prefill"] = time.perf_counter() - t0

    # ---------------------------------------------------- family_consistency
    t0 = time.perf_counter()
    B, T = FAM_CONS_B, FAM_CONS_T
    prompt = tokens[:B, :T]
    img_c = img[:B] if vlm else None
    extra_c = (img_c,) if vlm else ()
    s_max = T + FAM_GEN

    def kind_cfg(**changes):
        return family_config(name, layers, dtype="float32", **changes)

    if cfg.family == "ssm":
        kinds = {"state": (kind_cfg(), torch.float32)}
    else:
        kinds = {
            "f32": (kind_cfg(attention_impl="flash"), torch.float32),
            "bf16": (kind_cfg(), torch.bfloat16),
            "maclaurin": (kind_cfg(attention_backend="maclaurin"), torch.float32),
        }
        if moe:
            kinds["int8"] = (kind_cfg(kv_cache_dtype="int8"), torch.bfloat16)
    full = {}
    if not moe:  # an MoE's forward drops over-capacity tokens, decode never
        for kind in ("f32", "state", "maclaurin"):
            if kind in kinds:
                swap = vlm and kind == "maclaurin"
                with maclaurin_cross() if swap else nullcontext():
                    full[kind] = tf.forward(kinds[kind][0], params, prompt, *extra_c)[0]
    caches, decoded, step_ms = {}, {}, {}
    for kind, (c, cache_dtype) in kinds.items():
        cache = tf.init_cache(
            c, B, s_max, image_embeds=img_c, params=params, dtype=cache_dtype,
            device=dev,
        )
        step = make_serve_step(c)
        outs = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for pos in range(T):
            lg, cache = step(params, prompt[:, pos : pos + 1], pos, cache, *extra_c)
            outs.append(lg)
        torch.cuda.synchronize()
        step_ms[kind] = (time.perf_counter() - t1) * 1e3 / T
        caches[kind], decoded[kind] = cache, torch.cat(outs, dim=1)
    holds = [
        (bool(torch.isfinite(dec).all()), f"{name} decode {kind}: not finite")
        for kind, dec in decoded.items()
    ]
    gates = {}
    for kind, ref in full.items():  # the reference's consistency check
        dec = decoded[kind]
        err = (dec - ref).abs()
        over = float((err - (CONS_ATOL + CONS_RTOL * ref.abs())).max())
        gates[kind] = dict(
            max_abs_err_vs_forward=float(err.max()),
            max_abs_ref=float(ref.abs().max()),
            worst_margin_to_tol=-over,
            top1_agree=float((dec.argmax(-1) == ref.argmax(-1)).float().mean()),
        )
        what = f"{name} {kind} decode vs forward beyond rtol=atol={CONS_RTOL}"
        holds.append((over <= 0, what))
    rules = CACHE_RULES.get(cfg.family, CACHE_RULES["dense"])
    for kind, (wider, rel, gap) in rules.items():
        if kind in decoded:
            gate = logit_gate(decoded[kind], decoded[wider], rel, gap, against=wider)
            gates[kind] = gate
            share = MOE_SHARE if moe else None
            holds += hold(gates[kind], share, f"{name} {kind} cache vs {wider}")
    if moe:  # another attention function: reported, held finite above
        mac = logit_gate(decoded["maclaurin"], decoded["f32"], 1.0, 1.0, against="f32")
        gates["maclaurin"] = mac
    fields = dict(model=name, dtype="float32", batch=B, tokens=T, step_ms=step_ms)
    phase("family_consistency", **fields, **gates)
    for ok, what in holds:
        check(ok, what)
    next_tok = decoded[next(iter(kinds))][:, -1:].argmax(-1).to(torch.int32)
    del full, decoded, outs
    seconds["consistency"] = time.perf_counter() - t0

    # -------------------------------------------------------- family_generate
    t0 = time.perf_counter()
    for kind, (c, cache_dtype) in kinds.items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, cache = greedy_generate(
            c, params, next_tok, caches[kind], steps=FAM_GEN, start_pos=T,
            image_embeds=img_c,
        )
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / FAM_GEN
        what = f"{name} generate {kind}"
        check(toks.shape == (B, FAM_GEN), f"{what}: shape {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < c.vocab_size)).all()), f"{what}: token ids")
        held = tf.cache_bytes(cache)
        longer = tf.init_cache(
            c, B, 16 * s_max, image_embeds=img_c, params=params, dtype=cache_dtype,
            device=dev,
        )
        grown = tf.cache_bytes(longer)
        del longer
        if kind in ("state", "maclaurin"):  # RWKV/Mamba states, MacStates
            check(grown == held, f"{name} {kind}: state bytes grew with the context")
        else:
            check(grown > held, f"{name} {kind}: KV bytes did not grow with context")
        phase(
            "family_generate",
            model=name,
            cache=kind,
            steps=FAM_GEN,
            start_pos=T,
            ms_per_token=ms,
            bytes_per_sequence=held // B,
            bytes_per_sequence_at_16x_context=grown // B,
            first_tokens=toks[0, :8].tolist(),
        )
    launches = build.counts()
    del caches, cache
    seconds["generate"] = time.perf_counter() - t0

    # ------------------------------------------------- prefill timings (off the count)
    t0 = time.perf_counter()
    prefill_ms = {}
    for label, c in prefill_cfgs.items():
        if c.dtype != cfg.dtype:
            continue  # the f32 pair is checked, not timed
        step = make_prefill_step(c)
        ms = time_ms(lambda: step(params, tokens, *extra), iters=2, warm=1)
        prefill_ms[label] = ms
        phase(
            "family_prefill_time",
            model=name,
            config=label,
            ms=prefill_ms[label],
            tokens_per_s=batch * FAM_T / prefill_ms[label] * 1e3,
        )
    seconds["prefill_timing"] = time.perf_counter() - t0
    del params, tokens, img, extra
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    fields = dict(model=name, max_memory_allocated=peak, launches=launches)
    phase("family_model", **fields, seconds=seconds)
    return launches, dict(prefill_ms=prefill_ms, peak_bytes=peak)


def eighth_path(dev):
    """Path 8, the LM families past dense (kernels B8, B9): B8 and B9 held
    against their plain twins and float64 at the path's new head widths
    (80 and 128) and timed beside SDPA and their bounds; then each of
    FAMILY_MODELS at full width from seeded random weights through
    ``family_path``, one at a time, each freed before the next. Returns (the
    B8/B9 ``kernels`` entries at the new widths, every kernel's launches
    on the path)."""
    import torch

    from repro_torch.kernels import build

    t_path = time.perf_counter()
    checks, timings = attention_kernel_checks(dev, FAM_ATTN_CASES)
    torch.cuda.empty_cache()
    kernel_s = time.perf_counter() - t_path
    launches = {n: 0 for n in build.counts()}
    failed = []
    for name, layers, batch in FAMILY_MODELS:
        try:  # every model runs; the path fails after them if one did
            got, _ = family_path(dev, name, layers, batch)
        except PhaseFailed as e:
            failed.append(str(e))
            torch.cuda.empty_cache()
            continue
        launches = {n: launches[n] + got[n] for n in launches}
    check(not failed, "; ".join(failed))
    phase("eighth_path_launches", **launches)
    phase("eighth_path_seconds", kernels=kernel_s, total=time.perf_counter() - t_path)

    # the rows keep the model's bf16 B9; its f32 cases are checked and timed only
    rows = [c for c in FAM_ATTN_CASES if not (c[0] == "flash_attention" and c[1].endswith("f32"))]
    return attention_entries(rows, checks, timings, launches), launches



def grad_checks(dev) -> tuple[dict, dict]:
    """Act 1 of path 9: B8 under a gradient. At each (BH, T, d, dv), f32,
    ``ChunkedMaclaurin`` (the kernel's forward, the twin's backward) against
    the twin's own autograd on the card: the output and dq, dk, dv within
    ATTN_TWIN times the twin's distance from float64 (the quadratic form's
    autograd) + ATTN_ABS. Times: B8's forward, the Function's backward, the
    twin's forward and its forward+backward. Returns (checks, timings) by
    shape."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.common import tuning
    from repro_torch.kernels.maclaurin_attn import kernel as ma
    from repro_torch.kernels.maclaurin_attn.ref import maclaurin_attention_ref
    from repro_torch.launch.op_cost import maclaurin_work
    from repro_torch.models import maclaurin_attention as mac

    config = tuning.lookup("maclaurin_attn")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    checks, timings = {}, {}
    for bh, t, d, dv in TRAIN_GRAD_CASES:
        t0 = time.perf_counter()
        q, k = (torch.randn((bh, t, d), generator=gen, device=dev) for _ in range(2))
        v = torch.randn((bh, t, dv), generator=gen, device=dev)
        w = torch.randn((bh, t, dv), generator=gen, device=dev)

        def by_groups(fn, dtype, group):
            """fn's output and its VJP against w, a group of heads at a time."""
            parts = []
            for i in range(0, bh, group):
                leaves = [x[i : i + group].to(dtype).requires_grad_(True) for x in (q, k, v)]
                out = fn(*leaves)
                grads = torch.autograd.grad(out, leaves, w[i : i + group].to(out.dtype))
                parts.append([out.detach(), *grads])
            return [torch.cat(xs) for xs in zip(*parts)]

        group = mac.backward_group(bh, t, d, dv, config.chunk)
        twin_fn = lambda *x: ma.maclaurin_attention_torch(*x, config=config)  # noqa: E731
        twin = by_groups(twin_fn, torch.float32, group)
        scale = d**-0.5
        ref_fn = lambda *x: maclaurin_attention_ref(*x, scale=scale)  # noqa: E731
        exact = by_groups(ref_fn, torch.float64, max(1, 2**28 // t**2))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = build.counts()["maclaurin_attention"]
        out = mac.ChunkedMaclaurin.apply(*leaves, None, config)
        grads = torch.autograd.grad(out, leaves, w, retain_graph=True)
        torch.cuda.synchronize()
        launched = build.counts()["maclaurin_attention"] - before
        res = {"launches": launched}
        for name, got, tw, ex in zip(("out", "dq", "dk", "dv"), (out.detach(), *grads), twin, exact):
            twin_err = max_err(tw, ex)
            tol = ATTN_TWIN * twin_err + ATTN_ABS
            err = max_err(got, tw)
            res[name] = dict(
                max_abs_err=err,
                twin_max_abs_err_vs_float64=twin_err,
                tol=tol,
                max_abs_ref=float(tw.abs().max()),
            )
            check(err <= tol, f"B8 gradient {name} at {(bh, t, d, dv)}: {err} > {tol}")
            check(bool(torch.isfinite(got).all()), f"B8 gradient {name}: not finite")
        check(launched == 1, f"B8 under a gradient launched {launched} times, want 1")
        del twin, exact
        tm = dict(
            ms=time_ms(lambda: ma.maclaurin_attention_cuda(q, k, v, config=config), iters=5, warm=1),
            backward_ms=time_ms(
                lambda: torch.autograd.grad(out, leaves, w, retain_graph=True), iters=2, warm=1
            ),
            plain_ms=time_ms(lambda: ma.maclaurin_attention_torch(q, k, v, config=config), 3, 1),
            twin_fwd_bwd_ms=time_ms(lambda: by_groups(twin_fn, torch.float32, group), 2, 1),
            bound=bound(*maclaurin_work(bh, t, d, dv, config.chunk), peak=PEAK_F32_3XTF32),
        )
        phase(
            "train_b8_grad",
            shape=[bh, t, d, dv],
            chunk=config.chunk,
            backward_head_group=group,
            seconds=time.perf_counter() - t0,
            **res,
            **{k_: v_ for k_, v_ in tm.items() if k_ != "bound"},
            bound_ms=tm["bound"][0],
            bound_by=tm["bound"][1],
        )
        checks[bh, t, d, dv], timings[bh, t, d, dv] = res, tm
        del out, grads, leaves, q, k, v, w
        torch.cuda.empty_cache()
    return checks, timings


def train_steps(cfg, ocfg, params, steps: int, dev, seed: int, counted: str | None = None):
    """``steps`` steps of ``make_train_step`` from fresh optimizer state, on
    ``lm_token_batches`` rows (TRAIN_B x TRAIN_T, ``seed``). Returns
    (params, losses, step ms from CUDA events around each step, launches of
    kernel ``counted`` each step)."""
    import torch

    from repro_torch.data.loader import lm_token_batches
    from repro_torch.kernels import build
    from repro_torch.train.train_step import init_opt_state, make_train_step

    state = init_opt_state(ocfg, params, device=dev)
    step_fn = make_train_step(cfg, ocfg)
    make = lm_token_batches(cfg.vocab_size, TRAIN_B, TRAIN_T, seed=seed)
    losses, ms, launches = [], [], []
    for s in range(steps):
        batch = {k: torch.from_numpy(x).to(dev) for k, x in make(s).items()}
        before = build.counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, metrics = step_fn(params, state, batch, s)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        if counted:
            launches.append(build.counts()[counted] - before[counted])
    del state
    return params, losses, ms, launches


def falls(losses, by: float) -> tuple[float, float, bool]:
    """(mean of the first 5, of the last 5, whether the last fall below the
    first by more than ``by``): the rule of tests/test_train.py:45."""
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    return first, last, last < first - by


def ninth_path(dev):
    """Path 9, LM training at full width (kernel B8): act 1 holds B8's
    gradient against the twin's (``grad_checks``); then, with the counts at
    0, ``LM_NAME`` trained at full width and depth from seeded random
    weights: AdamW with the softmax (blockwise) attention, the maclaurin
    backend (B8 in each layer's forward and again where remat reruns it),
    four microbatches against one at f32, int8-compressed gradients, the
    launcher's failure drill and resume in subprocesses, flash attention's
    refusal, and greedy decoding from the trained weights. Returns (the
    B8 ``kernels`` entries at the training shapes, every kernel's launches
    on the path)."""
    import copy
    import dataclasses
    import gc
    import os
    import shutil

    import torch

    from repro_torch.data.loader import lm_token_batches
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.serve.decode_step import greedy_generate, make_serve_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import OptimizerConfig, init_opt_state, make_train_step

    seconds = {}
    t_path = t0 = time.perf_counter()
    checks, timings = grad_checks(dev)
    seconds["b8_grad"] = time.perf_counter() - t0

    # ------------------------------------------- softmax training (AdamW)
    t0 = time.perf_counter()
    build.reset_counts()
    cfg = lm_config()
    ocfg = OptimizerConfig(peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    params = tf.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.reset_peak_memory_stats()
    trained, losses, ms, _ = train_steps(cfg, ocfg, params, TRAIN_STEPS, dev, seed=42)
    peak = torch.cuda.max_memory_allocated()
    first, last, fell = falls(losses, TRAIN_DROP)
    step_ms = float(np.median(ms[1:]))
    phase(
        "train_softmax",
        model=cfg.name,
        params=n_params,
        dtype=cfg.dtype,
        remat=cfg.remat,
        batch=TRAIN_B,
        tokens=TRAIN_T,
        steps=TRAIN_STEPS,
        loss_first5=first,
        loss_last5=last,
        losses=losses[:3] + losses[-3:],
        step_ms_median=step_ms,
        step_ms_first=ms[0],
        tokens_per_s=TRAIN_B * TRAIN_T / step_ms * 1e3,
        max_memory_allocated=peak,
        launches=build.counts(),
        seconds=time.perf_counter() - t0,
    )
    check(bool(np.isfinite(losses).all()), "softmax training: a loss is not finite")
    check(fell, f"softmax training: last-5 mean {last} not below first-5 {first} - {TRAIN_DROP}")
    check(not any(build.counts().values()), "softmax training launched a kernel")
    seconds["softmax"] = time.perf_counter() - t0

    # ------------------------------------------------- maclaurin training
    t0 = time.perf_counter()
    mcfg = cfg.with_backend("maclaurin")
    mocfg = dataclasses.replace(ocfg, total_steps=TRAIN_MAC_STEPS)
    params = tf.init_params(mcfg, seed=SEED, device=dev)
    torch.cuda.reset_peak_memory_stats()
    params, mlosses, mms, b8 = train_steps(
        mcfg, mocfg, params, TRAIN_MAC_STEPS, dev, seed=42, counted="maclaurin_attention"
    )
    mpeak = torch.cuda.max_memory_allocated()
    mfirst, mlast, mfell = falls(mlosses, 0.0)
    mstep = float(np.median(mms[1:]))
    want = 2 * mcfg.n_layers  # each layer's forward, and remat's rerun of it
    phase(
        "train_maclaurin",
        steps=TRAIN_MAC_STEPS,
        loss_first5=mfirst,
        loss_last5=mlast,
        step_ms_median=mstep,
        tokens_per_s=TRAIN_B * TRAIN_T / mstep * 1e3,
        b8_launches_per_step=sorted(set(b8)),
        max_memory_allocated=mpeak,
        seconds=time.perf_counter() - t0,
    )
    check(bool(np.isfinite(mlosses).all()), "maclaurin training: a loss is not finite")
    check(mfell, f"maclaurin training: last-5 mean {mlast} not below first-5 {mfirst}")
    check(set(b8) == {want}, f"maclaurin training: B8 launches a step {sorted(set(b8))}, want {want}")
    del params
    seconds["maclaurin"] = time.perf_counter() - t0

    # -------------------------------------------- microbatches, at f32
    t0 = time.perf_counter()
    cfg32 = lm_config(dtype="float32")
    base = OptimizerConfig(peak_lr=1e-3, warmup=0, total_steps=10)
    micro = dataclasses.replace(base, microbatches=4)
    params = tf.init_params(cfg32, seed=SEED + 1, device=dev)
    batch = {
        k: torch.from_numpy(x).to(dev)
        for k, x in lm_token_batches(cfg32.vocab_size, TRAIN_B, TRAIN_T, seed=7)(0).items()
    }
    got = {}
    for label, oc in (("one", base), ("four", micro)):
        p = copy.deepcopy(params)
        p, _, m = make_train_step(cfg32, oc)(p, init_opt_state(oc, p, device=dev), batch, 0)
        got[label] = (p, {k: float(v) for k, v in m.items()})
    diff = max(
        float((a - b).detach().abs().max())
        for a, b in zip(got["one"][0].parameters(), got["four"][0].parameters())
    )
    moved = max(
        float((a - b).detach().abs().max())
        for a, b in zip(got["one"][0].parameters(), params.parameters())
    )
    phase(
        "train_microbatches",
        dtype="float32",
        microbatches=4,
        max_abs_param_diff=diff,
        tol=MICRO_TOL,
        max_abs_step=moved,
        metrics_one=got["one"][1],
        metrics_four=got["four"][1],
        seconds=time.perf_counter() - t0,
    )
    check(diff < MICRO_TOL, f"microbatches: parameters differ by {diff} >= {MICRO_TOL}")
    check(moved > 0, "microbatches: the step moved no parameter")
    del params, got, batch, p
    seconds["microbatches"] = time.perf_counter() - t0

    # ------------------------------------------------ compressed gradients
    t0 = time.perf_counter()
    cocfg = dataclasses.replace(ocfg, compress_grads=True)
    params = tf.init_params(cfg, seed=SEED + 3, device=dev)
    params, closses, cms, _ = train_steps(cfg, cocfg, params, TRAIN_COMPRESS_STEPS, dev, seed=4)
    cfirst, clast, cfell = falls(closses, COMPRESS_DROP)
    cstep = float(np.median(cms[1:]))
    phase(
        "train_compressed",
        steps=TRAIN_COMPRESS_STEPS,
        loss_first5=cfirst,
        loss_last5=clast,
        step_ms_median=cstep,
        tokens_per_s=TRAIN_B * TRAIN_T / cstep * 1e3,
        seconds=time.perf_counter() - t0,
    )
    check(bool(np.isfinite(closses).all()), "compressed training: a loss is not finite")
    check(cfell, f"compressed training: last-5 {clast} not below first-5 {cfirst} - {COMPRESS_DROP}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    seconds["compressed"] = time.perf_counter() - t0

    # ------------------------------------------ entry point, resume drill
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="train_drill_")
    try:
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        cmd = [
            sys.executable, "-m", "repro_torch.launch.train", *DRILL_ARGS,
            "--steps", str(DRILL_STEPS), "--batch", str(TRAIN_B), "--seq", str(TRAIN_T),
            "--ckpt-every", str(DRILL_EVERY), "--log-every", "1", "--ckpt-dir", tmp,
            "--device", dev.type,
        ]
        run1 = subprocess.run(
            cmd + ["--simulate-failure", str(DRILL_FAIL)],
            env=env, capture_output=True, text=True, timeout=600,
        )
        tail = lambda r: (r.stdout[-1500:], r.stderr[-1500:])  # noqa: E731
        check(run1.returncode == 42, f"drill: first run exited {run1.returncode}: {tail(run1)}")
        n = ckpt.latest_step(tmp)
        committed = range(DRILL_EVERY, DRILL_FAIL + 1, DRILL_EVERY)
        check(n in committed[-2:], f"drill: LATEST is {n}")
        with np.load(os.path.join(tmp, f"step_{n}", "arrays.npz")) as data:
            saved = {key: data[key] for key in data.files}
        run2 = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
        check(run2.returncode == 0, f"drill: resumed run exited {run2.returncode}: {tail(run2)}")
        check(f"[train] resumed from step {n}\n" in run2.stdout, f"drill: no resume from {n}")
        check(run2.stdout.rstrip().endswith("[train] done"), "drill: no [train] done")
        pattern = re.compile(r"\[train\] step\s+(\d+) loss (\S+) gnorm \S+ lr \S+ \((\d+) tok/s\)")
        logged = [
            {int(m[1]): (float(m[2]), int(m[3])) for m in pattern.finditer(r.stdout)}
            for r in (run1, run2)
        ]
        l1, l2 = logged[0][n + 1][0], logged[1][n + 1][0]
        rel = abs(l1 - l2) / abs(l1)
        like_params = tf.init_params(cfg, seed=SEED + 5, device=dev)
        like = {"params": like_params, "opt": init_opt_state(ocfg, like_params, device=dev)}
        restored = ckpt.flatten(ckpt.restore(tmp, n, like, shardings=dev))
        same = sorted(restored) == sorted(saved) and all(
            restored[key].dtype == saved[key].dtype
            and restored[key].tobytes() == saved[key].tobytes()
            for key in saved
        )
        tok_s = [tok for s_, (_, tok) in logged[1].items() if s_ > n + 1]
        phase(
            "train_drill",
            first_exit=run1.returncode,
            committed=n,
            resumed_exit=run2.returncode,
            loss_first_run=l1,
            loss_resumed=l2,
            rel_diff=rel,
            restored_arrays=len(restored),
            restored_bytes=int(sum(a.nbytes for a in saved.values())),
            restored_bit_equal=same,
            launcher_tokens_per_s_median=float(np.median(tok_s)) if tok_s else None,
            disk_free_bytes=shutil.disk_usage(tmp).free,
            seconds=time.perf_counter() - t0,
        )
        check(rel <= RESUME_REL, f"drill: step {n + 1} loss {l2} vs {l1}, rel {rel}")
        check(same, "drill: restored arrays differ from the checkpoint")
        del like, like_params, restored, saved
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    seconds["drill"] = time.perf_counter() - t0

    # ------------------------------------------------------ flash refused
    t0 = time.perf_counter()
    fcfg = lm_config(attention_impl="flash")
    batch = {
        k: torch.from_numpy(x).to(dev)
        for k, x in lm_token_batches(cfg.vocab_size, TRAIN_B, TRAIN_T, seed=42)(0).items()
    }
    before = build.counts()["flash_attention"]
    refused = ""
    try:
        make_train_step(fcfg, ocfg)(trained, init_opt_state(ocfg, trained, device=dev), batch, 0)
    except RuntimeError as e:
        refused = str(e)
    b9 = build.counts()["flash_attention"] - before
    phase("train_flash_refused", error=refused, b9_launches=b9)
    check("flash_attention: the kernel has no backward" in refused, "flash training not refused")
    check(b9 == 0, f"flash training launched B9 {b9} times")
    seconds["flash_refused"] = time.perf_counter() - t0

    # ------------------------------------------- serve what was trained
    t0 = time.perf_counter()
    prompt = batch["tokens"][:2, :16]
    cache = tf.init_cache(cfg, 2, 16 + TRAIN_GEN, dtype=torch.float32, device=dev)
    step = make_serve_step(cfg)
    finite, graph = True, False
    for pos in range(prompt.shape[1]):
        logits, cache = step(trained, prompt[:, pos : pos + 1], pos, cache)
        finite &= bool(torch.isfinite(logits).all())
        graph |= logits.grad_fn is not None
    nxt = logits[:, -1:].argmax(-1).to(torch.int32)
    toks, _ = greedy_generate(cfg, trained, nxt, cache, steps=TRAIN_GEN, start_pos=16)
    in_range = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    phase(
        "train_serve",
        cache="float32",
        steps=TRAIN_GEN,
        finite=finite,
        graph=graph,
        tokens=toks[0].tolist(),
        seconds=time.perf_counter() - t0,
    )
    check(finite, "serving the trained weights: logits not finite")
    check(not graph, "serving recorded a graph")
    check(toks.shape == (2, TRAIN_GEN) and in_range, "serving the trained weights: tokens")
    launches = build.counts()
    del trained, cache, batch
    torch.cuda.empty_cache()
    seconds["serve"] = time.perf_counter() - t0
    phase("ninth_path_launches", **launches)
    phase("ninth_path_seconds", total=time.perf_counter() - t_path, **seconds)
    check(launches["maclaurin_attention"] == TRAIN_MAC_STEPS * 2 * cfg.n_layers, "B8 launches")

    entries = []
    for shape, res in checks.items():
        tm = timings[shape]
        entries.append(
            {
                "name": "maclaurin_attention",
                "case": "training" if shape == TRAIN_GRAD_CASES[0] else "training hd128",
                "shape": list(shape),
                "route": "cuda",
                "source": "src/repro_torch/csrc/maclaurin_attn.cu",
                "replaces": "src/repro/kernels/maclaurin_attn/kernel.py:137",
                "launches": launches["maclaurin_attention"],
                "max_abs_err": res["out"]["max_abs_err"],
                "ms": tm["ms"],
                "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound"][0],
                "bound_by": tm["bound"][1],
                "library_ms": None,  # no PyTorch call computes w(u) attention
                "backward_ms": tm["backward_ms"],
                "twin_fwd_bwd_ms": tm["twin_fwd_bwd_ms"],
            }
        )
    return entries, launches

def served_artifacts(svm) -> list:
    """(family module, artifact) of every artifact paths 1-3 serve, compiled
    from ``svm``: maclaurin at f32 and int8 (poly2 runs the same kernels at
    the same keys), dense fourier and Fastfood at FEATURES and f32/int8."""
    from repro_torch.core import families

    arts = [(families.maclaurin, families.maclaurin.compile(svm, dtype=dt)) for dt in ("float32", "int8")]
    for structured in (False, True):
        for f in FEATURES:
            for dt in ("float32", "int8"):
                art = families.fourier.compile(
                    svm, num_features=f, structured=structured, dtype=dt, seed=SEED
                )
                arts.append((families.fourier, art))
    return arts


def tuned_serving(dev, card: str) -> dict:
    """Path 10 (a): the checked-in table loads with no warning and holds
    entries under this card's ``platform()`` for B1-B7; engines of every
    artifact paths 1-3 serve (and path 1's exact fallback) run with the
    counts at 0, each bucket's config the tabled one; then every tabled
    (kernel, key) of those artifacts is held against its plain twin under
    its pick, and pick and default are timed in turns (``device_ms``).
    Returns the launches of the serving window."""
    import warnings

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.common import tuning
    from repro_torch.kernels.rbf_pred import kernel as rp
    from repro_torch.serve import SVMEngine

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a dropped entry fails the path
        table = tuning.load_table(tuning.TABLE_PATH)
    plat = tuning.platform()
    held = table["entries"].get(plat, {})
    counts = {k: len(held.get(k, {})) for k in TUNED_KERNELS}
    phase("tuning_table", platform=plat, entries=counts)
    check(all(counts.values()), f"the table holds no entry of {TUNED_KERNELS} for {plat!r}")

    svm, X_te, _, _ = smoke_model(dev)
    arts = served_artifacts(svm)
    engines = [(family, art, SVMEngine(art, svm, device=dev)) for family, art in arts]
    build.reset_counts()
    for _, _, engine in engines:
        for b in TUNED_BUCKETS:
            engine.submit(X_te[:b]).values
    mac_engine = engines[0][2]
    for b in TUNED_B2_BUCKETS:
        mac_engine.submit_exact(X_te[:b]).values
    torch.cuda.synchronize()
    launches = build.counts()
    for family, art, engine in engines:
        for b in TUNED_BUCKETS:
            kernel, key = family.tile_lookup(art, b)
            want = tuning.lookup(kernel, key, strict=True).clamp_block_n(b)
            check(
                engine.bucket_configs[b] == want,
                f"{kernel}/{key}: engine runs {engine.bucket_configs[b]}, table {want}",
            )
    phase("tuned_serving", seconds=time.perf_counter() - t0, engines=len(engines), **launches)

    # every tabled key of these artifacts: the pick against the twin, and
    # pick and default in turns (default, pick, pick, default)
    cases = []
    for family, art in arts:
        _, launch, args = kernel_args(art)
        for b in TUNED_BUCKETS:
            kernel, key = family.tile_lookup(art, b)
            cases.append((kernel, key, b, art, launch, args))
    X, A = svm.X, svm.alpha_y
    for b in TUNED_B2_BUCKETS:
        key = tuning.shape_key(d=X.shape[1], m=X.shape[0], n=b)
        cases.append(("rbf_pred", key, b, None, None, None))
    exact = exact64(svm, dev)
    for kernel, key, b, art, launch, args in cases:
        pick = tuning.lookup(kernel, key, strict=True)
        default = tuning.DEFAULTS[kernel].clamp_block_n(b)
        Zb = torch.from_numpy(X_te[:b].copy()).to(dev)
        if art is None:  # B2: its rule against its fp32 twin and float64
            def run(cfg, Zb=Zb):
                return rp.rbf_scores_cuda(Zb, X, A, svm.gamma, svm.b, config=cfg)

            out0 = rp.rbf_scores_torch(Zb, X, A, svm.gamma, svm.b)
            tol = exact(X_te[:b])[1]
        else:
            def run(cfg, Zb=Zb, launch=launch, args=args):
                return launch(Zb, *args, config=cfg)

            out0, tol = plain_scores(art, Zb)
        out = run(pick)
        out = out[0] if isinstance(out, tuple) else out
        err = max_err(out, out0)
        if pick == default:
            pick_ms = default_ms = device_ms(lambda: run(pick))
        else:
            turns = [device_ms(lambda c=c: run(c)) for c in (default, pick, pick, default)]
            default_ms, pick_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        phase(
            "tuning",
            kernel=kernel,
            key=key,
            pick={"block_n": pick.block_n, "splits": pick.splits},
            default={"block_n": default.block_n, "splits": default.splits},
            pick_ms=pick_ms,
            default_ms=default_ms,
            max_abs_err=err,
            tol=tol,
            card=card,
        )
        check(err <= tol, f"{kernel}/{key} under {pick}: {err} > {tol}")
    return launches


def placement(dev) -> None:
    """Path 10 (b): PLACE_MODEL at full width, depth cut, from seeded random
    weights, placed on a PLACE_MESH of slots of the one card under each of
    PLACE_RULES (``param_shardings``, ``sanitize``, ``device_put``): every
    shard the leaf cut along its spec, every leaf gathered back bit for bit,
    the card's allocated memory grown by the bytes placed; then the
    embedding, the LM head and the first layer saved and restored onto
    their shardings, bit for bit."""
    import gc

    import torch

    from repro_torch.launch import make_mesh
    from repro_torch.launch.specs import sanitize
    from repro_torch.models import transformer
    from repro_torch.sharding import partitioning as part
    from repro_torch.train import checkpoint as ckpt

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in leaves(v, path + (k,))]
        return [(path, tree)]

    t0 = time.perf_counter()
    name, layers = PLACE_MODEL
    cfg = family_config(name, layers)
    params = transformer.init_params(cfg, seed=SEED, device=dev)
    spec, tree = params.spec(), params.tree()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    whole = sum(x.numel() * x.element_size() for _, x in leaves(tree))
    mesh = make_mesh(*PLACE_MESH, devices=[dev] * math.prod(PLACE_MESH[0]))
    for rules_name in PLACE_RULES:
        t1 = time.perf_counter()
        rules = getattr(part, rules_name)
        shardings = sanitize(part.param_shardings(spec, rules, mesh), tree, mesh)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        placed = part.device_put(tree, shardings)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated(dev) - before
        per_position = [0] * mesh.size
        n_shards = 0
        for (path, leaf), (_, got) in zip(leaves(tree), leaves(placed)):
            cut = got.sharding.shard_shape(tuple(leaf.shape))
            check(all(tuple(s.shape) == cut for s in got.shards), f"{rules_name} {path}: shard shapes")
            check(torch.equal(got.gather(), leaf), f"{rules_name} {path}: gather differs")
            per_position = [a + b for a, b in zip(per_position, got.position_bytes())]
            n_shards += len(got.shards)
        held = sum(per_position)
        check(held <= grown < held + ALLOC_SLACK * n_shards, f"{rules_name}: {grown} B allocated for {held} B")
        phase(
            "placement",
            model=name,
            layers=layers,
            rules=rules_name,
            mesh=list(PLACE_MESH[0]),
            whole_bytes=whole,
            bytes_per_position=per_position,
            position_share=[x / whole for x in per_position],
            allocated_bytes=grown,
            seconds=time.perf_counter() - t1,
        )
        del placed
        torch.cuda.empty_cache()

    # a checkpoint of the embedding, the LM head and the first layer
    t1 = time.perf_counter()
    sub = {"embed": tree["embed"], "lm_head": tree["lm_head"], "layers": _first_layer(tree["layers"])}
    sub_spec = {k: spec[k] for k in sub}
    shardings = sanitize(part.param_shardings(sub_spec, part.DEFAULT_RULES, mesh), sub, mesh)
    by_path = dict(leaves(shardings))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(tmp, 0, sub)
        saved_s = time.perf_counter() - t1
        restored = ckpt.restore(tmp, 0, sub, shardings=shardings)
    for (path, leaf), (_, got) in zip(leaves(sub), leaves(restored)):
        check(got.sharding == by_path[path], f"checkpoint {path}: sharding")
        check(torch.equal(got.gather(), leaf), f"checkpoint {path}: restored bits differ")
    phase(
        "placement_checkpoint",
        rules="DEFAULT_RULES",
        bytes=sum(x.numel() * x.element_size() for _, x in leaves(sub)),
        save_s=saved_s,
        restore_s=time.perf_counter() - t1 - saved_s,
    )
    del tree, sub, restored
    gc.collect()
    torch.cuda.empty_cache()
    phase("placement_seconds", seconds=time.perf_counter() - t0)


def _first_layer(tree: dict) -> dict:
    """The first layer of a stacked layer tree, its layer axis kept (1, ...)."""
    return {k: _first_layer(v) if isinstance(v, dict) else v[:1] for k, v in tree.items()}


def tenth_path(dev) -> dict:
    """Path 10: the tuning table on the card (``tuned_serving``), then
    placement by the partitioning rules (``placement``). Returns every
    kernel's launches on the path (the serving window of (a))."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    launches = tuned_serving(dev, card)
    for kernel in TUNED_WRAPPERS:
        check(launches[kernel] > 0, f"{kernel} never launched on path 10")
    placement(dev)
    phase("tenth_path_launches", **launches)
    phase("tenth_path_seconds", seconds=time.perf_counter() - t0)
    return launches



class spy_kernels:
    """Within it, every launch of B8 and B9 (their ``*_cuda`` wrappers, as
    the models call them) is kept: inputs and output, to be held against
    the plain twin after the step (``held_against_twins``)."""

    def __init__(self, calls: dict):
        self.calls = calls

    def __enter__(self):
        from repro_torch.kernels.flash_attn import ops as fa_ops
        from repro_torch.models import maclaurin_attention as mac

        self.saved = (fa_ops.flash_attention_cuda, mac.maclaurin_attention_cuda)

        def flash(q, k, v, **kw):
            out = self.saved[0](q, k, v, **kw)
            self.calls.setdefault("flash_attention", []).append(((q, k, v), kw, out))
            return out

        def maclaurin(q, k, v, **kw):
            out = self.saved[1](q, k, v, **kw)
            self.calls.setdefault("maclaurin_attention", []).append(((q, k, v), kw, out))
            return out

        fa_ops.flash_attention_cuda, mac.maclaurin_attention_cuda = flash, maclaurin
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attn import ops as fa_ops
        from repro_torch.models import maclaurin_attention as mac

        fa_ops.flash_attention_cuda, mac.maclaurin_attention_cuda = self.saved


def held_against_twins(calls: dict, what: str) -> dict:
    import torch

    with torch.no_grad():
        return _held_against_twins(calls, what)


def _held_against_twins(calls: dict, what: str) -> dict:
    """Each kept B8/B9 output against its plain twin on the same inputs,
    within ATTN_TWIN times the twin's own distance from float64 (a few
    heads of the call, the oracle's) + ATTN_ABS. Returns per kernel the
    calls held and the largest error over tolerance."""
    import torch

    from repro_torch.kernels.flash_attn import kernel as fa
    from repro_torch.kernels.maclaurin_attn import kernel as ma
    from repro_torch.kernels.maclaurin_attn.ref import (
        maclaurin_attention_ref,
        softmax_attention_ref,
    )

    twins = {
        "flash_attention": (fa.flash_attention_torch, softmax_attention_ref),
        "maclaurin_attention": (ma.maclaurin_attention_torch, maclaurin_attention_ref),
    }
    out = {}
    for name, kept in calls.items():
        twin, oracle = twins[name]
        worst = 0.0
        for (q, k, v), kw, got in kept:
            want = twin(q, k, v, **{key: kw[key] for key in ("scale", "config") if key in kw})
            heads = slice(0, 2)  # the float64 oracle on two heads sets the tolerance
            scale = kw.get("scale") or q.shape[-1] ** -0.5
            exact = oracle(*(x[heads].double() for x in (q, k, v)), scale=scale)
            tol = ATTN_TWIN * max_err(want[heads], exact) + ATTN_ABS
            err = max_err(got, want)
            worst = max(worst, err / tol)
            check(err <= tol, f"{what}: {name} on a shard {tuple(q.shape)}: {err} > {tol}")
            check(bool(torch.isfinite(got).all()), f"{what}: {name} on a shard not finite")
        out[name] = {"calls": len(kept), "worst_err_over_tol": worst}
    calls.clear()
    return out


def placed_bytes(tree) -> dict:
    """Bytes each mesh position holds of a placed tree, and what the
    shardings say it holds (each leaf's shard shape)."""
    from repro_torch.sharding.spmd import flat

    held = placement = None
    shards = 0
    for leaf in flat(tree).values():
        leaves = leaf if isinstance(leaf, tuple) else (leaf,)
        for x in leaves:
            per = x.position_bytes()
            cut = math.prod(x.sharding.shard_shape(tuple(x.shape))) * x.shards[0].element_size()
            held = per if held is None else [a + b for a, b in zip(held, per)]
            placement = [cut] * len(per) if placement is None else [a + cut for a in placement]
            shards += len(per)
    return {"bytes_per_position": held, "placement_bytes_per_position": placement, "shards": shards}


def fill(placed, whole) -> None:
    """Copy ``whole``'s tensors (any device) into a placed tree's shards, in
    place, each its block."""
    from repro_torch.sharding.spmd import flat

    want = flat(whole)
    for path, leaf in flat(placed).items():
        for p, shard in enumerate(leaf.shards):
            shard.copy_(want[path][leaf.sharding.index(leaf.shape, p)])


def to_host(tree):
    import torch

    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree


def logit_blocks(logits, mesh, name: str, base: int, inputs: int) -> dict:
    """Where a sharded step left its logits (a ``Sharded``): each position's
    block shape, device and bytes, checked against its sharding's block
    and its own position's device; each device's peak allocated bytes
    since the last reset (the step's), beside the bytes allocated before
    the step (``base``) and the step's inputs (``inputs``)."""
    import torch

    block = logits.sharding.shard_shape(logits.shape)
    blocks = []
    for p, x in enumerate(logits.shards):
        own = torch.device(mesh.devices[p])
        check(x.device == own, f"{name}: position {p}'s logits on {x.device}, not {own}")
        check(tuple(x.shape) == block, f"{name}: position {p}'s logits {tuple(x.shape)}, not {block}")
        blocks.append({"position": p, "shape": list(x.shape), "device": str(x.device), "bytes": x.nbytes})
    devices = sorted({str(torch.device(d)) for d in mesh.devices})
    return dict(
        model=name,
        shape=list(logits.shape),
        spec=[list(a) if isinstance(a, tuple) else a for a in logits.sharding.spec],
        blocks=blocks,
        whole_bytes=math.prod(logits.shape) * logits.dtype.itemsize,
        peak_bytes_by_device={d: torch.cuda.max_memory_allocated(d) for d in devices},
        base_bytes=base,
        input_bytes=inputs,
    )


class Window:
    """Launch counts over the sharded steps only: each ``with`` window sets
    the counts to 0 and adds what it read to ``launches``; B8/B9 calls kept
    in ``calls``."""

    def __init__(self, launches: dict, calls: dict):
        self.launches, self.calls = launches, calls

    def __enter__(self):
        from repro_torch.kernels import build

        build.reset_counts()
        self.spy = spy_kernels(self.calls).__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        from repro_torch.kernels import build

        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.spy.__exit__(*exc)
        self.counts = build.counts()
        for name, n in self.counts.items():
            self.launches[name] += n


def shard_gate(got, want, share: float | None, what: str) -> dict:
    """``logit_gate`` at SHARD_REL, SHARD_GAP, checked."""
    gate = logit_gate(got, want, SHARD_REL, SHARD_GAP, against="one_device")
    for ok, msg in hold(gate, share, what):
        check(ok, msg)
    return gate


def sharded_serving(dev, mesh, launches, calls, name: str, layers: int, prefill: bool) -> dict:
    """``name`` at full width, ``layers`` deep, f32 compute on the bf16
    weights a serving cell holds: a prefill cell (flash) and a decode cell
    under the rules ``choose_rules`` picks, each held against the
    one-device step on the same card. Returns the phase fields."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import transformer as tf
    from repro_torch.serve import decode_step as ds
    from repro_torch.sharding.partitioning import device_put

    moe = name.startswith("qwen3-moe")
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = family_config(name, layers, dtype="float32", attention_impl="flash")
    params = tf.init_params(cfg, seed=SEED, device=dev)
    with torch.no_grad():
        for p in params.parameters():
            p.copy_(p.to(torch.bfloat16))  # the serving cell's weights, as f32
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"model": name, "layers": layers}
    share = MOE_F32_SHARE if moe else None
    earlier_peak = 0  # the peak before the prefill's reset
    if prefill:
        B, T = SHARD_PREFILL
        tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev, dtype=torch.int32)
        want = ds.make_prefill_step(cfg)(params, tokens)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        shape = ShapeConfig("path11_prefill", T, B, "prefill")
        cell = build_cell(cfg, shape, mesh, params=params)
        grown = torch.cuda.memory_allocated(dev) - before
        held = placed_bytes(cell.args[0])
        out.update(prefill_rules=cell_rules(cfg, shape), prefill_allocated_bytes=grown, **held)
        placed = sum(held["bytes_per_position"])
        check(placed == sum(held["placement_bytes_per_position"]), f"{name}: bytes held != the placement's")
        check(placed <= grown < placed + ALLOC_SLACK * held["shards"], f"{name}: {grown} B allocated for {placed} B")
        torch.cuda.synchronize()
        earlier_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with Window(launches, calls) as w:
            got = cell.step_fn(cell.args[0], tokens)
        phase("shard_logits", **logit_blocks(got, mesh, name, base, placed + tokens.nbytes))
        got = got.gather()
        gate = shard_gate(got, want, share, f"{name} sharded prefill")
        out.update(prefill_s=w.seconds, prefill=gate, prefill_twins=held_against_twins(calls, "prefill"))
        del cell, got, want
        gc.collect()
        torch.cuda.empty_cache()
    B, S, steps = SHARD_DECODE
    shape = ShapeConfig("path11_decode", S, B, "decode")
    cell = build_cell(cfg, shape, mesh, params=params)
    cache = device_put(tf.init_cache(cfg, B, S, dtype=torch.float32, device=dev), cell.in_shardings[3])
    want_cache = tf.init_cache(cfg, B, S, dtype=torch.float32, device=dev)
    step = ds.make_serve_step(cfg)
    tok = want_tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    gates, tokens, seconds = [], [], []
    for pos in range(steps):
        with Window(launches, calls) as w:
            logits, cache = cell.step_fn(cell.args[0], tok, pos, cache)
        seconds.append(w.seconds)
        logits = logits.gather()
        want, want_cache = step(params, want_tok, pos, want_cache)
        gates.append(shard_gate(logits, want, share, f"{name} sharded decode at {pos}")["rel"])
        tok = torch.argmax(logits, -1).to(torch.int32)
        want_tok = torch.argmax(want, -1).to(torch.int32)
        check(torch.equal(tok, want_tok), f"{name} sharded decode at {pos}: greedy tokens differ")
        tokens.append(tok[:, 0].tolist())
    kv = cache["kv"]
    out.update(
        decode_rules=cell_rules(cfg, shape),
        cache_spec=[list(x.sharding.spec) for x in kv],
        decode_rel=gates,
        decode_tokens=tokens,
        decode_s=seconds,
    )
    for x in kv:
        for g in x.replica_groups():
            check(all(torch.equal(x.local(p), x.local(g[0])) for p in g), f"{name}: cache replicas differ")
    out["peak_bytes"] = max(earlier_peak, torch.cuda.max_memory_allocated(dev))
    del cell, cache, want_cache, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cell_rules(cfg, shape) -> str:
    """The name of the rules a cell of ``shape`` runs under."""
    from repro_torch.launch import specs
    from repro_torch.sharding import spmd

    return spmd.rules_name(specs.choose_rules(specs.pick_backend(cfg, shape), shape, None))


def one_leaf(params, path: tuple):
    """Leaf ``path`` of ``params.tree()`` alone (a layer leaf stacked)."""
    import torch

    name = ".".join(path[1:])
    if path[0] == "layers":
        return torch.stack([dict(layer.named_parameters())[name].detach() for layer in params.layers])
    return dict(getattr(params, path[0]).named_parameters())[name].detach()


def sharded_training(dev, mesh, launches, calls, name: str, layers: int) -> list[dict]:
    """``name`` at full width, ``layers`` deep, f32 (maclaurin for the MoE,
    so that B8 launches from T = 1024), remat on: one one-device AdamW step
    leaves the state the compared step starts from; the one-device step
    from it is the reference, then the sharded cell of each of
    SHARD_TRAIN_RULES takes the same step from the same state (copied into
    the cell's placed arguments). Returns one phase's fields a rule set."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import partitioning as part
    from repro_torch.sharding.spmd import flat
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import OptimizerConfig, init_opt_state, make_train_step

    moe = name.startswith("qwen3-moe")
    changes = dict(dtype="float32")
    if moe:
        changes["attention_backend"] = "maclaurin"
    cfg = family_config(name, layers, **changes)
    ocfg = OptimizerConfig(warmup=2, total_steps=10)
    B, T = SHARD_TRAIN_SHAPE[name]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def batch():
        return {
            k: torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev, dtype=torch.int32)
            for k in ("tokens", "labels")
        }

    params = tf.init_params(cfg, seed=SEED, device=dev)
    step = make_train_step(cfg, ocfg)
    state = init_opt_state(ocfg, params, device=dev)
    params, state, _ = step(params, state, batch(), 2)
    start = to_host(params.tree(lambda p: p.detach()))
    start_state = to_host(state)
    b3 = batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, want = step(params, state, b3, 3)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    del state
    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    for rules_name in SHARD_TRAIN_RULES[name]:
        torch.cuda.reset_peak_memory_stats(dev)
        shape = ShapeConfig("path11_train", T, B, "train")
        cell = build_cell(cfg, shape, mesh, getattr(part, rules_name), ocfg, params=params)
        fill(cell.args[0], start)
        fill(cell.args[1], start_state)
        held = placed_bytes(cell.args[0])
        state_bytes = placed_bytes(cell.args[1])["bytes_per_position"]
        torch.cuda.synchronize()
        with Window(launches, calls) as w:
            got_p, got_state, got = cell.step_fn(cell.args[0], cell.args[1], b3, 3)
        cell.args = ()
        fields = dict(model=name, layers=layers, rules=rules_name, batch=[B, T], step_s=w.seconds,
                      one_device_step_s=one_s, **held, state_bytes_per_position=state_bytes)
        check(held["bytes_per_position"] == held["placement_bytes_per_position"], f"{name} {rules_name}: bytes")
        for key in ("loss", "xent", "aux", "lr"):
            fields[key] = [float(got[key]), float(want[key])]
            check(math.isclose(*fields[key], rel_tol=SHARD_RTOL, abs_tol=SHARD_ATOL), f"{name} {rules_name}: {key}")
        fields["grad_norm"] = [float(got["grad_norm"]), float(want["grad_norm"])]
        check(math.isclose(*fields["grad_norm"], rel_tol=SHARD_NORM_RTOL), f"{name} {rules_name}: grad norm")
        lr = float(want["lr"])
        b2 = inspect.signature(opt.adamw_update).parameters["b2"].default
        unbias = 1 - b2 ** int(got_state["count"].local(0))
        v = flat(got_state["v"])
        worst, beyond, total, beyond_rms = 0.0, 0, 0, 0.0
        for path, leaf in flat(got_p).items():
            ref = one_leaf(params, path)
            delta = (leaf.gather() - ref).abs()
            worst = max(worst, float(delta.max()))
            off = delta > SHARD_ATOL + SHARD_RTOL * ref.abs()
            if off.any():
                rms = (v[path].gather()[off] / unbias).sqrt()
                beyond_rms = max(beyond_rms, float(rms.max()))
            beyond += int(off.sum())
            total += ref.numel()
            for g in leaf.replica_groups():
                same = all(torch.equal(leaf.local(p), leaf.local(g[0])) for p in g)
                check(same, f"{name} {rules_name} {path}: replicas differ")
        fields.update(
            params_max_abs=worst,
            params_beyond=beyond,
            params_elements=total,
            beyond_max_grad_rms=beyond_rms,
            lr_steps=worst / lr,
        )
        fields["twins"] = held_against_twins(calls, f"{name} {rules_name} train")
        fields["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        phase("shard_train", **fields)
        what = f"{name} {rules_name}: a parameter beyond the tolerance"
        check(beyond_rms < SHARD_TINY_GRAD, f"{what} where the gradient's RMS is {beyond_rms}")
        check(worst <= SHARD_LR_STEPS * lr, f"{name} {rules_name}: a parameter moved {worst / lr} lr from one device's")
        rows.append(fields)
        del cell, got_p, got_state, got
        gc.collect()
        torch.cuda.empty_cache()
    del params, start, start_state
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def eleventh_path(dev) -> tuple[list, dict]:
    """Path 11: the rule-sharded LM steps on a (data, model) mesh of 2 x 2
    slots of the card (SHARD_* above): B8 and B9 checked and timed at the
    shapes one head shard gives them, then qwen3-moe served (prefill and
    decode) and trained (DEFAULT, EP_DATA), smollm-135m trained (DP_ONLY,
    DEFAULT) and decoded (TP_ONLY), each against one device's step; every
    B8/B9 launch of the sharded steps held against its twin. The launch
    counts are those of the sharded steps alone. Returns (the B8/B9
    ``kernels`` entries at the shard shapes, every kernel's launches)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import make_mesh

    t_path = time.perf_counter()
    torch.cuda.empty_cache()
    checks, timings = attention_kernel_checks(dev, SHARD_ATTN_CASES)
    kernel_s = time.perf_counter() - t_path
    mesh = make_mesh(*SHARD_MESH, devices=[dev] * math.prod(SHARD_MESH[0]))
    launches = {n: 0 for n in build.counts()}
    calls: dict = {}
    seconds = {"kernels": kernel_s}
    t0 = time.perf_counter()
    serve = sharded_serving(dev, mesh, launches, calls, *SHARD_SERVE, prefill=True)
    phase("shard_serve", **serve)
    seconds["qwen3_serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = sharded_training(dev, mesh, launches, calls, *SHARD_TRAIN)
    seconds["qwen3_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows += sharded_training(dev, mesh, launches, calls, *SHARD_SMALL)
    small = sharded_serving(dev, mesh, launches, calls, *SHARD_SMALL, prefill=False)
    phase("shard_serve", **small)
    seconds["smollm"] = time.perf_counter() - t0
    peak = max(x["peak_bytes"] for x in [serve, small, *rows])
    for kernel in ("flash_attention", "maclaurin_attention"):
        check(launches[kernel] > 0, f"{kernel} never launched on a head shard on path 11")
    phase("eleventh_path_launches", **launches)
    seconds["total"] = time.perf_counter() - t_path
    phase("eleventh_path_seconds", peak_bytes=peak, **seconds)
    return attention_entries(SHARD_ATTN_CASES, checks, timings, launches), launches


def image_embeds(cfg, dev, batch: int):
    """A VLM's random image embeddings (batch, N, d), f32, from SEED; ()
    for the other families (the steps' extra argument)."""
    import torch

    if cfg.family != "vlm":
        return ()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    dims = (batch, cfg.n_image_tokens, cfg.d_model)
    return (torch.randn(dims, generator=gen, device=dev),)


def family_serving(dev, mesh, launches, calls, name, rules, dtype, B, T, S, steps) -> dict:
    """``name`` at full width, SHARD12_DEPTH deep, on the bf16 weights a
    serving cell holds: a flash prefill cell at ``dtype`` and a decode cell
    at f32 under ``rules``, each held against the one-device step on the
    same card at f32 (a bf16 prefill within the larger of path 4's limit
    and twice the one-device bf16 prefill's own distance from f32, as
    path 8 holds its bf16 pairs; an MoE's logits on MOE_F32_SHARE of the
    positions). Returns the phase fields."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.serve import decode_step as ds
    from repro_torch.sharding import partitioning as part

    torch.cuda.reset_peak_memory_stats(dev)
    layers = SHARD12_DEPTH[name]
    cfg, params = serving_weights(name, layers, dev)
    share = MOE_F32_SHARE if cfg.moe_num_experts else None
    gen = torch.Generator(device=dev).manual_seed(SEED)
    extra = image_embeds(cfg, dev, B)
    out = {"model": name, "layers": layers, "rules": rules, "prefill_dtype": dtype}
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev, dtype=torch.int32)
    want = ds.make_prefill_step(cfg)(params, tokens, *extra)
    cfg_p = dataclasses.replace(cfg, dtype=dtype)
    if dtype == "float32":
        limit = None
    else:  # the model's own bf16 rounding sets the bf16 limit
        own = ds.make_prefill_step(cfg_p)(params, tokens, *extra)
        own_rel = logit_gate(own, want, PREFILL_REL, PREFILL_GAP)["rel"]
        limit = max(PREFILL_REL, 2 * own_rel)
        out.update(one_device_bf16_rel=own_rel, prefill_limit=limit)
        del own
    shape = ShapeConfig("path12_prefill", T, B, "prefill")
    cell = build_cell(cfg_p, shape, mesh, getattr(part, rules), params=params)
    out.update(prefill_batch=[B, T], **placed_bytes(cell.args[0]))
    with Window(launches, calls) as w:
        got = cell.step_fn(cell.args[0], tokens, *extra)
    got = got.gather()
    if limit is None:
        gate = shard_gate(got, want, share, f"{name} sharded prefill")
    else:
        gate = logit_gate(got, want, limit, PREFILL_GAP, against="one_device_f32")
        for ok, msg in hold(gate, share, f"{name} sharded bf16 prefill"):
            check(ok, msg)
    out.update(prefill_s=w.seconds, prefill=gate, prefill_twins=held_against_twins(calls, "prefill"))
    del cell, got, want
    gc.collect()
    torch.cuda.empty_cache()
    out.update(decode_cell(dev, mesh, launches, calls, cfg, params, rules, tokens, S, steps))
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serving_weights(name: str, layers: int, dev):
    """(config, weights): ``name`` at full width, ``layers`` deep, f32
    compute, flash prefill, its weights random from SEED and rounded to
    the bf16 values a serving cell holds."""
    import torch

    from repro_torch.models import transformer as tf

    cfg = family_config(name, layers, dtype="float32", attention_impl="flash")
    params = tf.init_params(cfg, seed=SEED, device=dev)
    with torch.no_grad():
        for p in params.parameters():
            p.copy_(p.to(torch.bfloat16))  # the serving cell's weights, as f32
    return cfg, params


def decode_cell(dev, mesh, launches, calls, cfg, params, rules, tokens, S, steps) -> dict:
    """A decode cell of ``cfg`` under ``rules`` (batch ``tokens.shape[0]``,
    ``S`` cache slots): ``steps`` greedy steps from ``tokens[:, :1]``
    through an f32 cache placed by the cell's shardings, each held against
    the one-device step (logits at SHARD_REL, an MoE's on MOE_F32_SHARE of
    the positions; greedy tokens equal), the cache's replicas bit-equal.
    Returns the phase fields."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import transformer as tf
    from repro_torch.serve import decode_step as ds
    from repro_torch.sharding import partitioning as part
    from repro_torch.sharding.partitioning import device_put
    from repro_torch.sharding.spmd import flat

    name, B = cfg.name, tokens.shape[0]
    share = MOE_F32_SHARE if cfg.moe_num_experts else None
    extra = image_embeds(cfg, dev, B)
    shape = ShapeConfig("decode", S, B, "decode")
    cell = build_cell(cfg, shape, mesh, getattr(part, rules), params=params)
    opts = dict(dtype=torch.float32, device=dev)
    if extra:
        opts.update(image_embeds=extra[0], params=params)
    cache = device_put(tf.init_cache(cfg, B, S, **opts), cell.in_shardings[3])
    want_cache = tf.init_cache(cfg, B, S, **opts)
    step = ds.make_serve_step(cfg)
    tok = want_tok = tokens[:, :1]
    rels, greedy, seconds = [], [], []
    counts = {}
    for pos in range(steps):
        with Window(launches, calls) as w:
            logits, cache = cell.step_fn(cell.args[0], tok, pos, cache, *extra)
        seconds.append(w.seconds)
        logits = logits.gather()
        counts = {k: counts.get(k, 0) + n for k, n in w.counts.items()}
        want, want_cache = step(params, want_tok, pos, want_cache, *extra)
        rels.append(shard_gate(logits, want, share, f"{name} sharded decode at {pos}")["rel"])
        tok = torch.argmax(logits, -1).to(torch.int32)
        want_tok = torch.argmax(want, -1).to(torch.int32)
        check(torch.equal(tok, want_tok), f"{name} sharded decode at {pos}: greedy tokens differ")
        greedy.append(tok[:, 0].tolist())
    specs_ = {}
    for path, leaf in flat(cache).items():
        for i, x in enumerate(leaf if isinstance(leaf, tuple) else (leaf,)):
            specs_["/".join(path) + f"[{i}]"] = list(x.sharding.spec)
            for g in x.replica_groups():
                same = all(torch.equal(x.local(p), x.local(g[0])) for p in g)
                check(same, f"{name}: cache replicas differ")
    out = dict(cache_spec=specs_, decode_rel=rels, decode_tokens=greedy, decode_s=seconds)
    out.update(decode_launches=counts, decode_twins=held_against_twins(calls, "decode"))
    del cell, cache, want_cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_training(
    dev, mesh, launches, calls, name, rules, options, B, T, changes, layers=None, label="shard12_train"
) -> dict:
    """``name`` at full width, ``layers`` (SHARD12_DEPTH's) deep, f32, remat on: one
    one-device step leaves the state the compared step starts from; the
    one-device step from it is the reference (kept on the host), then the
    cell under ``rules`` with the optimizer ``options`` takes the same step
    from the same state (copied into its placed arguments). Gates: path
    11's for AdamW, SHARD12_OFF_SHARE under Adafactor or compressed
    gradients. Returns the phase fields."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import partitioning as part
    from repro_torch.sharding.spmd import flat
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import OptimizerConfig, init_opt_state, make_train_step

    torch.cuda.reset_peak_memory_stats(dev)
    layers = layers or SHARD12_DEPTH[name]
    cfg = family_config(name, layers, dtype="float32", **changes)
    ocfg = OptimizerConfig(warmup=2, total_steps=10, **options)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    extra = image_embeds(cfg, dev, B)

    def batch():
        out = {
            k: torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev, dtype=torch.int32)
            for k in ("tokens", "labels")
        }
        if extra:
            out["image_embeds"] = extra[0]
        return out

    params = tf.init_params(cfg, seed=SEED, device=dev)
    step = make_train_step(cfg, ocfg)
    state = init_opt_state(ocfg, params, device=dev)
    params, state, _ = step(params, state, batch(), 2)
    start, start_state = to_host(params.tree(lambda p: p.detach())), to_host(state)
    b3 = batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, want = step(params, state, b3, 3)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    want = {k: float(v) for k, v in want.items()}
    ref = flat(to_host(params.tree(lambda p: p.detach())))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    shape = ShapeConfig("path12_train", T, B, "train")
    cell = build_cell(cfg, shape, mesh, getattr(part, rules), ocfg)
    fill(cell.args[0], start)
    fill(cell.args[1], start_state)
    held = placed_bytes(cell.args[0])
    state_bytes = placed_bytes(cell.args[1])["bytes_per_position"]
    torch.cuda.synchronize()
    with Window(launches, calls) as w:
        got_p, got_state, got = cell.step_fn(cell.args[0], cell.args[1], b3, 3)
    cell.args = ()
    what = f"{name} {rules} {ocfg.name}"
    fields = dict(
        model=name, layers=layers, rules=rules, optimizer=ocfg.name,
        microbatches=ocfg.microbatches, compress_grads=ocfg.compress_grads,
        batch=[B, T], step_s=w.seconds, one_device_step_s=one_s, **held,
        state_bytes_per_position=state_bytes, launches=w.counts,
    )
    fails = [(held["bytes_per_position"] == held["placement_bytes_per_position"], f"{what}: bytes")]
    for key in ("loss", "xent", "aux", "lr"):
        fields[key] = [float(got[key]), want[key]]
        ok = math.isclose(*fields[key], rel_tol=SHARD_RTOL, abs_tol=SHARD_ATOL)
        fails.append((ok, f"{what}: {key}"))
    norms = [float(got["grad_norm"]), want["grad_norm"]]
    fields["grad_norm"] = norms
    adamw = ocfg.name == "adamw" and not ocfg.compress_grads
    if adamw:
        b2 = inspect.signature(opt.adamw_update).parameters["b2"].default
        unbias = 1 - b2 ** int(got_state["count"].local(0))
        v = flat(got_state["v"])
    worst, beyond, total, beyond_rms = 0.0, 0, 0, 0.0
    for path, leaf in flat(got_p).items():
        want_leaf = ref[path].to(dev)
        delta = (leaf.gather() - want_leaf).abs()
        worst = max(worst, float(delta.max()))
        off = delta > SHARD_ATOL + SHARD_RTOL * want_leaf.abs()
        if adamw and off.any():
            rms = (v[path].gather()[off] / unbias).sqrt()
            beyond_rms = max(beyond_rms, float(rms.max()))
        beyond += int(off.sum())
        total += want_leaf.numel()
        for g in leaf.replica_groups():
            same = all(torch.equal(leaf.local(p), leaf.local(g[0])) for p in g)
            fails.append((same, f"{what} {path}: replicas differ"))
        del want_leaf, delta, off
    lr = want["lr"]
    fields.update(params_max_abs=worst, params_beyond=beyond, params_elements=total, lr_steps=worst / lr)
    if adamw:
        fields["beyond_max_grad_rms"] = beyond_rms
    fields["twins"] = held_against_twins(calls, f"{what} train")
    del cell, got_p, got_state, got
    gc.collect()
    torch.cuda.empty_cache()
    norm_ok = math.isclose(*norms, rel_tol=SHARD_NORM_RTOL)
    params_ok = beyond_rms < SHARD_TINY_GRAD if adamw else beyond <= SHARD12_OFF_SHARE * total
    if not (norm_ok and params_ok) and not ocfg.compress_grads:
        # how far the model's own rounding moves the step: the one-device
        # step at float64 compute from the same state (SHARD12_* above)
        norm64, params64 = one_device_f64(cfg, ocfg, start, start_state, b3, dev)
        own_max, own_beyond = 0.0, 0
        for path, leaf in params64.items():
            delta = (ref[path] - leaf).abs()
            own_max = max(own_max, float(delta.max()))
            own_beyond += int((delta > SHARD_ATOL + SHARD_RTOL * ref[path].abs()).sum())
        fields.update(
            grad_norm_f64=norm64,
            one_device_from_f64=dict(
                grad_norm=abs(norms[1] - norm64), params_max_abs=own_max, params_beyond=own_beyond
            ),
        )
        if not norm_ok:
            norm_ok = abs(norms[0] - norms[1]) <= 2 * abs(norms[1] - norm64) + SHARD_NORM_RTOL * norm64
        if not params_ok:
            params_ok = worst <= 2 * own_max + SHARD_ATOL and beyond <= 2 * own_beyond
        del params64
    fields["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    phase(label, **fields)
    for ok, msg in fails:
        check(ok, msg)
    check(norm_ok, f"{what}: grad norm")
    check(params_ok, f"{what}: {beyond} of {total} parameters beyond the tolerance, up to {worst}")
    if adamw:
        check(worst <= SHARD_LR_STEPS * lr, f"{what}: a parameter moved {worst / lr} lr from one device's")
    del ref, start, start_state
    gc.collect()
    torch.cuda.empty_cache()
    return fields


def one_device_f64(cfg, ocfg, start: dict, start_state: dict, batch: dict, dev):
    """The one-device step 3 of ``cfg`` from the weights ``start`` (the
    reference's tree) and the optimizer state ``start_state`` on
    ``batch``, at float64 compute (the norms, the loss and the optimizer
    stay f32 inside, as the port computes them): (its gradient norm, its
    updated parameters as f32 on the host, flat)."""
    import dataclasses

    from repro_torch.models import transformer as tf
    from repro_torch.sharding.partitioning import map_tree
    from repro_torch.sharding.spmd import flat
    from repro_torch.train.train_step import make_train_step

    cfg64 = dataclasses.replace(cfg, dtype="float64")
    params = tf.init_params(cfg, seed=SEED, device=dev).double().assign(start)
    state = map_tree(lambda x: x.to(dev), start_state)
    params, state, metrics = make_train_step(cfg64, ocfg)(params, state, batch, 3)
    out = {k: x.float().cpu() for k, x in flat(params.tree(lambda p: p.detach())).items()}
    return float(metrics["grad_norm"]), out


def twelfth_path(dev) -> tuple[list, dict]:
    """Path 12: the sharded steps of the families past dense and MoE and of
    the optimizer options on path 11's 2 x 2 slots of the card (SHARD12_*
    above): B8 and B9 checked and timed at the shapes one head shard of
    zamba2 and of llama-vision gives them, then rwkv6, zamba2 and
    llama-vision served (prefill and greedy decode), rwkv6, zamba2 and
    musicgen trained, and qwen3-moe trained with Adafactor, microbatches
    and compressed gradients, each against one device's step; every B8/B9
    launch of the sharded steps held against its twin. The launch counts
    are those of the sharded steps alone. Returns (the B8/B9 ``kernels``
    entries at the new shard shapes, every kernel's launches)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import make_mesh

    t_path = time.perf_counter()
    torch.cuda.empty_cache()
    cuts = {n: f"{k} of {get_config(n).n_layers} layers" for n, k in SHARD12_DEPTH.items()}
    phase("twelfth_path_cuts", **cuts)
    checks, timings = attention_kernel_checks(dev, SHARD12_ATTN_CASES)
    seconds = {"kernels": time.perf_counter() - t_path}
    mesh = make_mesh(*SHARD_MESH, devices=[dev] * math.prod(SHARD_MESH[0]))
    launches = {n: 0 for n in build.counts()}
    calls: dict = {}
    peaks = []
    for name, rules, dtype, B, T, S, steps in SHARD12_SERVE:
        t0 = time.perf_counter()
        row = family_serving(dev, mesh, launches, calls, name, rules, dtype, B, T, S, steps)
        phase("shard12_serve", **row)
        peaks.append(row["peak_bytes"])
        seconds[f"{name} serve"] = time.perf_counter() - t0
    for name, rules, options, B, T, changes in SHARD12_TRAIN:
        t0 = time.perf_counter()
        row = family_training(dev, mesh, launches, calls, name, rules, options, B, T, changes)
        peaks.append(row["peak_bytes"])
        seconds[f"{name} train"] = time.perf_counter() - t0
    for kernel in ("flash_attention", "maclaurin_attention"):
        check(launches[kernel] > 0, f"{kernel} never launched on a head shard on path 12")
    phase("twelfth_path_launches", **launches)
    seconds["total"] = time.perf_counter() - t_path
    phase("twelfth_path_seconds", peak_bytes=max(peaks), **seconds)
    return attention_entries(SHARD12_ATTN_CASES, checks, timings, launches), launches


class residual_blocks:
    """Within it, the (shape, bytes) of the largest residual block a mesh
    position holds entering a dense block of the sharded steps
    (``spmd.Lockstep.layer``)."""

    def __enter__(self):
        from repro_torch.sharding import spmd

        self.real, self.shape, self.bytes = spmd.Lockstep.layer, None, 0

        def layer(ctx, i, stacks, x, *rest, **kw):
            for xi in x:
                if xi.numel() * xi.element_size() > self.bytes:
                    self.shape, self.bytes = list(xi.shape), xi.numel() * xi.element_size()
            return self.real(ctx, i, stacks, x, *rest, **kw)

        spmd.Lockstep.layer = layer
        return self

    def __exit__(self, *exc):
        from repro_torch.sharding import spmd

        spmd.Lockstep.layer = self.real


def rule_serving(dev, mesh, launches, calls) -> list[dict]:
    """Path 13's serving cells (SHARD13_SERVE at f32 on its bf16 weights):
    each of SHARD13_PREFILL's flash prefills under each of its rule sets,
    held against the one-device prefill (timed once), with the residual
    block a position holds and the peak; then SHARD13_DECODE's greedy
    steps. Returns one phase's fields a cell."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.serve import decode_step as ds
    from repro_torch.sharding import partitioning as part

    name, layers = SHARD13_SERVE
    cfg, params = serving_weights(name, layers, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for B, T, rule_sets in SHARD13_PREFILL:
        tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev, dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ds.make_prefill_step(cfg)(params, tokens)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        for rules in rule_sets:
            torch.cuda.reset_peak_memory_stats(dev)
            shape = ShapeConfig("path13_prefill", T, B, "prefill")
            cell = build_cell(cfg, shape, mesh, getattr(part, rules), params=params)
            cell.step_fn(cell.args[0], tokens)  # warm, outside the counted window
            with residual_blocks() as res, Window(launches, calls) as w:
                got = cell.step_fn(cell.args[0], tokens)
            got = got.gather()
            what = f"{name} {rules} prefill"
            row = dict(model=name, layers=layers, rules=rules, prefill_batch=[B, T])
            row.update(prefill_s=w.seconds, one_device_prefill_s=one_s, launches=w.counts)
            row.update(residual_block=res.shape, residual_bytes_per_position=res.bytes)
            row.update(prefill=shard_gate(got, want, MOE_F32_SHARE, what), **placed_bytes(cell.args[0]))
            row.update(twins=held_against_twins(calls, what), peak_bytes=torch.cuda.max_memory_allocated(dev))
            rows.append(row)
            phase("shard13_serve", **row)
            del cell, got
            gc.collect()
            torch.cuda.empty_cache()
        del want
    rules, B, S, steps = SHARD13_DECODE
    torch.cuda.reset_peak_memory_stats(dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    row = dict(model=name, layers=layers, rules=rules, decode_batch=[B, S])
    row.update(decode_cell(dev, mesh, launches, calls, cfg, params, rules, tokens, S, steps))
    row.update(launches=row["decode_launches"], peak_bytes=torch.cuda.max_memory_allocated(dev))
    rows.append(row)
    phase("shard13_serve", **row)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def thirteenth_path(dev) -> tuple[list, dict]:
    """Path 13: the sharded steps under SP_RULES and EP_DP_RULES on path
    11's 2 x 2 slots of the card (SHARD13_* above): B8 and B9 checked and
    timed at the shape one EP_DP position gives them, then qwen3-moe served
    and trained under both sets, zamba2 and smollm-135m trained under SP,
    each against one device's step; every B8/B9 launch of the sharded
    steps held against its twin, and each kernel launched under each set.
    The launch counts are those of the sharded steps alone. Returns (the
    B8/B9 ``kernels`` entries at the new shape, every kernel's launches)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import make_mesh

    t_path = time.perf_counter()
    torch.cuda.empty_cache()
    cuts = {f"{SHARD13_SERVE[0]} serve": f"{SHARD13_SERVE[1]} of {get_config(SHARD13_SERVE[0]).n_layers} layers"}
    for name, layers, rules, *_ in SHARD13_TRAIN:
        cuts[f"{name} {rules} train"] = f"{layers} of {get_config(name).n_layers} layers"
    phase("thirteenth_path_cuts", **cuts)
    checks, timings = attention_kernel_checks(dev, SHARD13_ATTN_CASES)
    seconds = {"kernels": time.perf_counter() - t_path}
    mesh = make_mesh(*SHARD_MESH, devices=[dev] * math.prod(SHARD_MESH[0]))
    launches = {n: 0 for n in build.counts()}
    calls: dict = {}
    t0 = time.perf_counter()
    rows = rule_serving(dev, mesh, launches, calls)
    seconds["qwen3-moe serve"] = time.perf_counter() - t0
    for name, layers, rules, B, T, changes in SHARD13_TRAIN:
        t0 = time.perf_counter()
        args = (dev, mesh, launches, calls, name, rules, {}, B, T, changes)
        rows.append(family_training(*args, layers=layers, label="shard13_train"))
        seconds[f"{name} {rules} train"] = time.perf_counter() - t0
    by_rules = {}
    for row in rows:
        got = by_rules.setdefault(row["rules"], {})
        for kernel, n in row["launches"].items():
            got[kernel] = got.get(kernel, 0) + n
    for rules in ("SP_RULES", "EP_DP_RULES"):
        for kernel in ("flash_attention", "maclaurin_attention"):
            check(by_rules[rules][kernel] > 0, f"{kernel} never launched under {rules} on path 13")
    phase("thirteenth_path_launches", **launches, by_rules=by_rules)
    peak = max(row["peak_bytes"] for row in rows)
    check(peak <= SHARD13_PEAK, f"path 13's peak {peak} B > {SHARD13_PEAK}")
    seconds["total"] = time.perf_counter() - t_path
    phase("thirteenth_path_seconds", peak_bytes=peak, **seconds)
    return attention_entries(SHARD13_ATTN_CASES, checks, timings, launches), launches


def serve_cell_checks(
    label, art, engine, results, requests, refs, exact, dev
) -> dict:
    """Check one served artifact's results and return its phase fields
    (errors and tolerances listed per request that has such rows).

    Rows the artifact vouches for (inside the envelope for quadform
    families; all or none for fourier, by its held-out verdict) must
    carry the plain twin's scores within the kernel's tolerance; the
    others must fall back to the exact scores within B2's. Labels of
    vouched rows are compared with the float64 model's where fp32 can
    decide them (top-two gap over twice B2's tolerance, as for
    ``submit_exact``).
    """
    import torch

    quadform = art.meta["kind"] == "quadform"
    verdict = bool(art.meta.get("valid_globally", True))
    want_fallback, agree, decided_n, in_n = 0, 0, 0, 0
    score_err, score_tol, fb_err, fb_tol = [], [], [], []  # per request
    in_labels = []
    for (Z, scaled), r, (ref, ref_tol) in zip(requests, results, refs):
        want_valid = ~scaled if quadform else np.full(len(Z), verdict)
        check(bool((r.valid == want_valid).all()), f"{label}: valid mask")
        want_fallback += int((~want_valid).sum())
        v = r.valid
        if v.any():
            s0, tol = plain_scores(art, torch.from_numpy(Z[v]).to(dev))
            err = float(np.abs(r.values[v] - s0.cpu().numpy()).max())
            score_err.append(err)
            score_tol.append(tol)
            check(err <= tol, f"{label}: served scores {err} > {tol}")
            top2 = np.sort(ref[v], -1)[:, -2:]
            decided = top2[:, 1] - top2[:, 0] > 2 * ref_tol
            ref_labels = ref[v].argmax(-1)
            agree += int((r.labels[v][decided] == ref_labels[decided]).sum())
            decided_n += int(decided.sum())
            in_n += int(v.sum())
            in_labels.append(ref_labels)
        if (~v).any():
            tol = exact(Z[~v])[1]
            err = float(np.abs(r.values[~v] - ref[~v]).max())
            fb_err.append(err)
            fb_tol.append(tol)
            check(err <= tol, f"{label}: fallback scores {err} > {tol}")
    fallback = engine.stats.snapshot()["fallback_instances"]
    check(fallback == want_fallback, f"{label}: {fallback} rows fell back")
    fields = dict(
        family=art.family,
        dtype=art.dtype,
        valid_globally=verdict,
        fallback_rows=fallback,
        in_envelope_rows=in_n,
        decided_rows=decided_n,
        max_abs_err_vs_twin=score_err,
        tol_vs_twin=score_tol,
        fallback_max_abs_err=fb_err,
        fallback_tol=fb_tol,
    )
    if decided_n:
        labels = np.concatenate(in_labels)
        fields["label_agree"] = agree / decided_n
        fields["ref_mode_share"] = float(np.bincount(labels).max() / len(labels))
    for key in ("holdout_mean_abs_err", "quant_mean_abs_err"):
        if key in art.meta:
            fields[key] = art.meta[key]
    return fields


def tree_locals(tree):
    """Position 0's blocks of a placed tree: on a 1 x 1 mesh, the whole
    tensors."""
    from repro_torch.sharding.partitioning import Sharded, map_tree

    return map_tree(lambda x: x.local(0) if isinstance(x, Sharded) else x, tree)


def stopped(procs):
    """A context in which the process groups of ``procs`` (each started in
    a session of its own) are stopped (SIGSTOP), so that they take no CPU
    from a timing; continued (SIGCONT) after it."""
    import contextlib
    import os
    import signal

    @contextlib.contextmanager
    def frozen():
        running = [p for p in procs or () if p.poll() is None]
        for p in running:
            os.killpg(p.pid, signal.SIGSTOP)
        try:
            yield
        finally:
            for p in running:
                os.killpg(p.pid, signal.SIGCONT)

    return frozen()


def dry_against_card(dev, label, cfg, shape, mesh, rules, ocfg, beside=None) -> dict:
    """One cell's dry run on fake devices shaped as ``mesh`` against the
    cell run once on ``mesh`` (slots of the card) under the same recorder:
    flops, matmul flops by dtype, launches and collective calls equal. On
    a 1 x 1 mesh also the peak over the placed arguments within
    DRY_PEAK_REL and the median step against the roofline bound, timed
    with ``beside`` (processes tracing on the CPU) stopped, and again with
    them running; a prefill also through path 4's one-device entry point on
    the same weights and tokens. Returns the phase's fields."""
    import gc
    import statistics

    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import transformer as tf
    from repro_torch.serve.decode_step import make_prefill_step

    t0 = time.perf_counter()
    pred, _ = dryrun.predict(cfg, shape, dryrun.fake_mesh(mesh.sizes, mesh.axis_names), rules, ocfg)
    dry_s = time.perf_counter() - t0
    cell = build_cell(cfg, shape, mesh, rules, ocfg)
    args = cell.args
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    placed = sum(dryrun._placed_bytes(args, mesh.size))
    torch.cuda.reset_peak_memory_stats(dev)
    before = build.counts()
    got = dryrun.measure(cell.step_fn, *args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    after = build.counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    what = f"path 14 {label}"
    fields = dict(cell=label, model=cfg.name, layers=cfg.n_layers, shape=[shape.global_batch, shape.seq_len],
                  kind=shape.kind, rules=pred["rule_set"], dry_run_s=dry_s, trace_s=pred["trace_seconds"],
                  mesh=list(mesh.sizes), classes=pred["classes"], class_peaks=pred["class_peaks"])
    fields.update(flops=[pred["total"]["flops"], got["total"]["flops"]],
                  matmul_flops=[pred["total"]["matmul_flops"], got["total"]["matmul_flops"]],
                  launches=[pred["kernels"], launched], calls=[len(pred["calls"]), len(got["calls"])])
    check(pred["total"]["flops"] == got["total"]["flops"], f"{what}: flops {fields['flops']}")
    check(pred["total"]["matmul_flops"] == got["total"]["matmul_flops"], f"{what}: matmul flops")
    check(pred["kernels"] == got["kernels"] == launched, f"{what}: launches {fields['launches']}")
    check(pred["calls"] == got["calls"], f"{what}: collective calls differ")
    fields["collectives"] = {c["kind"]: 0 for c in got["calls"]}
    for c in got["calls"]:
        fields["collectives"][c["kind"]] += c["count"]
    if mesh.size == 1:
        want = pred["memory"]["peak_device_bytes"] - pred["memory"]["argument_bytes"]
        rel = abs(want - peak) / peak
        fields.update(peak_over_args=[want, peak], peak_rel=rel, placed_bytes=placed,
                      base_bytes=base, argument_bytes=pred["memory"]["argument_bytes"],
                      recorded_peak_on_card=got["peak"].get(str(args[0]["lm_head"]["w"].local(0).device)))
        check(rel <= DRY_PEAK_REL, f"{what}: peak {want} predicted, {peak} measured")

        def median_s(step, *step_args):
            def once():
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(*step_args)
                torch.cuda.synchronize()
                return time.perf_counter() - t

            once()
            return statistics.median(once() for _ in range(DRY_TIMED))

        with stopped(beside):
            step_s = median_s(cell.step_fn, *args)
        fields["step_ms_beside_trace"] = median_s(cell.step_fn, *args) * 1e3
        if shape.kind == "prefill":  # path 4's f32 parameters, holding the cell's weights
            tree, tokens = (tree_locals(a) for a in args)
            params = tf.init_params(cfg, seed=SEED, device=dev).assign(tree)
            with stopped(beside):
                fields["one_device_ms"] = median_s(make_prefill_step(cfg), params, tokens) * 1e3
            del params
        terms = {
            "compute": roofline.compute_seconds(pred["cost"]),
            "memory": pred["cost"]["bytes_accessed"] / roofline.HBM_BW,
            "collective": roofline.link_seconds(pred["collective_ops"]),
        }
        bound_s = max(terms.values())
        fields.update(step_ms=step_s * 1e3, bound_ms=bound_s * 1e3, terms_ms={k: v * 1e3 for k, v in terms.items()},
                      roofline_frac=bound_s / step_s, bound_by=max(terms, key=terms.get))
    del cell, args, got
    gc.collect()
    torch.cuda.empty_cache()
    return fields


def f11_decode(dev, mesh, launches, calls) -> dict:
    """DRY_F11 on ``mesh`` (2 x 2 slots of the card): ``decode_cell``'s
    greedy steps held against the one-device decode on the same bf16
    weights at SHARD_REL, the cache's replicas bit-equal. Returns its
    phase fields."""
    import torch

    from repro_torch.models import transformer as tf

    label, layers, changes, rules, (_, S, B, _), steps = DRY_F11
    cfg = family_config(LM_NAME, layers, **changes)
    params = tf.init_params(cfg, seed=SEED, device=dev)
    with torch.no_grad():
        for p in params.parameters():
            p.copy_(p.to(torch.bfloat16))  # the serving cell's weights, as f32
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    out = dict(cell=label, model=cfg.name, layers=layers, kv_heads=cfg.n_kv_heads, model_ways=mesh.shape["model"])
    out.update(decode_cell(dev, mesh, launches, calls, cfg, params, rules, tokens, S, steps))
    del params
    return out


def fourteenth_path(dev) -> tuple[list, dict]:
    """Path 14: the dry run held against the card (DRY_* above): the
    production cells DRY_CELLS traced on the CPU, each in a process of its
    own, while smollm-135m's three cells run on a 1 x 1 mesh of the card
    (those processes stopped while a step is timed, and timed again beside
    them), qwen3-moe's two on 2 x 2 slots, smollm-135m's two on 1 x 4 and
    DRY_CLASS on 4 x 2, each against its dry run, and DRY_F11's decode on
    2 x 2 slots against its dry run and the one-device decode; B9 held
    against its twins at the 1 x 4 prefill's shape (DRY_ATTN_CASES). Returns
    (its ``kernels`` entry, every kernel's launches)."""
    import dataclasses
    import os
    import signal

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun, make_mesh, roofline
    from repro_torch.sharding import partitioning as part
    from repro_torch.train.train_step import OptimizerConfig

    t_path = time.perf_counter()
    card = card_line()
    phase("fourteenth_path_torch", torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    checks, timings = attention_kernel_checks(dev, DRY_ATTN_CASES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = []
    for arch, shape_name, multi_pod in DRY_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape_name, "--force"]
        cmds.append(shlex.join(cmd + (["--multi-pod"] if multi_pod else [])))
    procs = [subprocess.Popen(["sh", "-c", "set -e; " + "; ".join(cmds)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)]
    seconds = {}
    try:
        torch.cuda.empty_cache()
        build.reset_counts()
        mesh = make_mesh((1, 1), ("data", "model"), devices=[dev])
        for label, changes, (name, T, B, kind) in DRY_SMALL:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_config(LM_NAME), **changes)
            row = dry_against_card(dev, label, cfg, ShapeConfig(name, T, B, kind), mesh, None, None, beside=procs)
            phase("dry_card", card=card, **row)
            seconds[label] = time.perf_counter() - t0
        slots = make_mesh(*SHARD_MESH, devices=[dev] * math.prod(SHARD_MESH[0]))
        for label, name, layers, changes, rules, (sname, T, B, kind), sizes in DRY_SLOTS + (DRY_CLASS,):
            t0 = time.perf_counter()
            mesh = make_mesh(sizes, SHARD_MESH[1], devices=[dev] * math.prod(sizes))
            cfg = family_config(name, layers, **changes)
            ocfg = OptimizerConfig(warmup=2, total_steps=10) if kind == "train" else None
            shape = ShapeConfig(sname, T, B, kind)
            row = dry_against_card(dev, label, cfg, shape, mesh, getattr(part, rules), ocfg)
            ways = mesh.shape["model"]
            if cfg.n_heads % ways and rules != "EP_DP_RULES":  # spread: B8/B9 once a member a layer
                want = {k: attention_applications(cfg) * mesh.size for k in row["launches"][1]}
                check(row["launches"][1] == want, f"path 14 {label}: launches {row['launches'][1]}, not {want}")
                row["spread"] = dict(heads=cfg.n_heads, model_ways=ways, launches_a_member=attention_applications(cfg))
            peaks = list(row["class_peaks"].values())  # every position does the same work
            row["class_peak_spread"] = max(peaks) / min(peaks) - 1
            check(row["class_peak_spread"] <= DRY_LEVEL, f"path 14 {label}: positions peak at {peaks}")
            phase("dry_slots", card=card, **row)
            seconds[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        label, layers, changes, rules, (sname, S, B, kind), _ = DRY_F11
        cfg = family_config(LM_NAME, layers, **changes)
        row = dry_against_card(dev, label, cfg, ShapeConfig(sname, S, B, kind), slots, getattr(part, rules), None)
        check(cfg.n_kv_heads % slots.shape["model"] != 0, "path 14: DRY_F11's kv heads divide the model axis")
        phase("dry_slots", card=card, **row)
        launches = build.counts()
        decoded = {n: 0 for n in launches}
        row = f11_decode(dev, slots, decoded, {})
        phase("dry_f11_decode", card=card, **row)
        for k, n in decoded.items():
            launches[k] = launches.get(k, 0) + n
        seconds[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = procs[0].communicate(timeout=max(1.0, DRY_CELL_S - (t0 - t_path)))[0]
        seconds["production cells wait"] = time.perf_counter() - t0
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    check(procs[0].returncode == 0, f"path 14: the production cells' dry run failed:\n{out[-3000:]}")
    done = [line for line in out.splitlines() if line.startswith("OK ")]
    check(len(done) == len(DRY_CELLS), f"path 14: {len(done)} production cells traced:\n{out[-3000:]}")
    for (arch, shape_name, multi_pod), summary in zip(DRY_CELLS, done):
        mesh_name = dryrun.mesh_name(multi_pod)
        what = f"path 14: the dry run of {arch} {shape_name} on {mesh_name}"
        tag = dryrun.cell_tag(arch, shape_name, multi_pod=multi_pod)
        with open(ROOT / dryrun.RESULTS_DIR / f"{tag}.json") as f:
            rec = json.load(f)
        mem, cost = rec["memory"], rec["cost"]
        numbers = [mem[k] for k in mem] + [cost["flops"], cost["bytes_accessed"]]
        check(all(math.isfinite(x) and x >= 0 for x in numbers), f"{what}: a number is not finite")
        n = 512 if multi_pod else 256
        check(rec["n_devices"] == n and rec["mesh"] == mesh_name, f"{what}: its mesh")
        check(sum(rec["classes"].values()) == n and len(rec["classes"]) == (8 if multi_pod else 4), f"{what}: classes")
        check(mem["peak_device_bytes"] >= mem["argument_bytes"] > 0 and cost["flops"] > 0, what)
        check(f" {shape_name} " in summary and f" {mesh_name} " in summary, f"{what}: {summary}")
        row = roofline.analyze_cell(rec)
        phase("dry_cell", card=card, summary=summary, arch=arch, shape=shape_name, mesh=mesh_name,
              position=rec["position"], trace_seconds=rec["trace_seconds"], classes=rec["classes"],
              memory=mem, cost=cost, collectives=rec["collectives"],
              roofline={k: v for k, v in row.items() if k != "collectives"},
              roofline_row=roofline.to_markdown([row]).splitlines()[-1])
    seconds["total"] = time.perf_counter() - t_path
    phase("fourteenth_path_launches", **launches)
    phase("fourteenth_path_seconds", card=card, **seconds)
    for kernel in ("flash_attention", "maclaurin_attention"):
        check(launches[kernel] > 0, f"{kernel} never launched on path 14")
    return attention_entries(DRY_ATTN_CASES, checks, timings, launches), launches


if __name__ == "__main__":
    sys.exit(main())
