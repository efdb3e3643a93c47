#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits nonzero:

1. build   — compile every kernel under src/repro_torch/kernels/csrc (one
             nvcc per source, all at once); print the card's name and
             power limit.
2. kernels — each kernel's wrapper against its plain PyTorch version on the
             card, at every cnn-vgg11 stage's shape at batch 256 (the direct
             conv with and without the mask; the im2col strip GEMMs, fc1 and
             fc2 on the matmul) plus a ragged case each.  Tolerance: max |kernel - plain| <=
             1e-4 * max(1, max |plain|) in f32 (sums in another order); the
             int8 mask must agree except at near-ties.  Each record names
             the kernel template the launch took (conv: the register kernel's
             pixel run and channel groups, or the simple kernel; matmul: the
             register or simple kernel and the split of its K loop); the
             conv1 forward (with its mask) and fc2 (split) are launched
             twice and must give the same bits.
3. forward — the planned cnn-vgg11 forward at full width, batch 256, with
             the default algorithm argmin, with every conv stage direct and
             with every conv stage im2col; logits against the plain forward
             at the phase-2 tolerance, launch counts against the plan.
4. bwd     — each backward kernel against its plain version at every
             backward shape of the cnn-vgg11 training step at batch 256
             (wgrad at conv0-3, the conv kernel as dgrad at conv1-3, the NT
             and TN matmuls at fc1/fc2) and the fused dX/dW kernel at
             fc1/fc2 at batch 128, plus a ragged case each; phase-2
             tolerance.  Each wgrad and NT record names its split of the
             contraction, each dgrad, TN and fused record its template (TN
             and fused: the register or simple kernel and the split of its
             M or N loop); wgrad at conv0 (split) and conv3, NT at fc1 dX
             (split), TN at fc1 dW, the fused fc1 and fc2 calls and the
             conv3 dgrad are launched twice and must give the same bits
             (phase ``determinism``).
5. train   — the main path of this slice: the launcher
             (``repro_torch.launch.train --arch cnn-vgg11 --batch 256
             --steps 3 --planned-kernels``) with its launch counts against
             what plan_training implies, and a batch-128 step that runs the
             fused dX/dW kernel (its step-1 gradients against the same step
             with the fused kernel's plain version); then, from one seeded
             state, the step-1
             loss and gradients per tensor at the phase-2 tolerance (a)
             against the same planned step with every backward kernel
             swapped for its plain version, and (b) against an independent
             plain step — cuDNN convolutions, cuBLAS matmuls, torch
             autograd — that takes its ReLU/max-pool decisions from the
             planned forward (the saved masks; the recompute values where
             a stage saves none; fc1's ReLU), since two f32 forwards can
             decide a near-tie differently and one such flip moves a whole
             gradient term.  Then 3 planned AdamW steps' losses against 3
             plain steps' (each within 1e-4 * max(1, |loss|)).
6. flash   — the flash-attention kernel against its plain version at the
             transformer's shape ([64, 2048, 64], causal, the planner's
             blocks), GQA 16/8 at D = 128, D = 32 (GQA 16/8) and D = 256
             (gemma3-4b's 8/4 heads, 32/32 blocks), a 512 window, ragged
             lengths (1000) and a case whose late rows see no key (q_len
             1000, kv_len 500, window 256): those rows must be exactly 0 in
             both.  Phase-2 tolerance.  The transformer's call is launched
             twice and must give the same bits.
7. transformer — the main path of the third slice: the launcher
             (``--arch qwen1.5-0.5b --batch 4 --seq 2048 --steps 3
             --planned-kernels``, full width and depth, f32) with its launch
             counts against what plan_training implies; then, from the same
             seeded state, the step-1 loss and every gradient at the
             phase-2 tolerance (a) against the same planned step with every
             kernel swapped for its plain version and (b) against an
             independent plain step (cuBLAS matmuls with TF32 off,
             attention_ref, torch autograd), and the launcher's 3 losses
             against 3 plain steps' (the port's plain path) at 1e-4
             relative.  Peak device memory of each step, one at a time.
8. times   — CUDA-event medians of each kernel at every forward and
             backward shape, beside its plain version, one library call and
             the bound, with bound_share = bound_ms / ms and, for the conv,
             the matmul, TN and the fused dX/dW kernel, the template (every
             main-path call must take the register kernel); each fused
             record also times two yardsticks, pair_library_ms (the two
             torch.matmul calls) and pair_port_ms (the port's NT + TN at
             the layer's direct blocks), and the device time of the call
             and of each yardstick by torch.profiler (each wgrad record
             also names the device kernels conv2d_weight runs, read with
             torch.profiler); the forward's and the training step's ms per batch
             and images/s; device time by kernel over a profiled forward
             and a profiled training step.  For the transformer: the flash
             kernel (the main call, GQA at D = 128, D = 32, D = 256 and the
             window) beside its plain version, scaled_dot_product_attention
             and its bound; matmul, NT and TN at the five GEMM shapes of the
             step beside torch.matmul (NT and TN at qkv, TN at wo (split)
             and the qkv forward launched twice first: the same bits); the
             step's ms and
             tokens/s, planned
             and plain; a profiled step.  The ``kernels`` line sums each
             kernel's calls over one planned training step — cnn-vgg11 at
             batch 256 (the fused dX/dW kernel: at batch 128), and for
             flash attention the qwen1.5-0.5b step — and gives its launches
             over every path.

The train-step knobs, each phase at full width (run between ``train`` and
``flash``, ``remat`` after ``transformer``, ``autotune`` last):

9.  accum    — cnn-vgg11 at batch 256 as [2, 128, 32, 32, 3] (the launcher
               passes --microbatch on without splitting a batch, as the JAX
               launcher does, so the script builds the accumulated batch):
               launches a step = 2 x plan_training(128), 4 of them the
               fused dX/dW kernel on its register template; step-1 loss
               and every gradient within TOL of the same accumulation with
               the backward kernels' plain versions; the largest relative
               difference from the batch-256 step (reported, not gated:
               near-tie pool flips); step ms of both.
10. int8_ef  — 3 AdamW steps at batch 256 with int8 error-feedback
               compression, planned against plain (same compression),
               losses within LOSS_TOL; every error buffer nonzero after
               step 1.
11. ckpt     — the launcher at batch 256: run A, 4 steps with --ckpt; run
               B, the same command with --ckpt-every 1 stopped before step
               2 (its data source raises, as a killed process stops), then
               run again, which resumes from step 1.  B's final params,
               moments and step equal A's bit for bit, and A's equal the
               same 4 steps run in process; a torn chunk fails verify_step
               and rolls restore_latest back a step; bytes a step, save and
               restore seconds.
12. remat    — qwen1.5-0.5b at 4 x 2048 through the launcher with --remat
               none, block and dots: launches a step (block adds each
               layer's 4 GEMMs and its flash call, dots its flash call),
               peak memory ordered none >= dots >= block with block below
               REMAT_PEAK_CUT of none, step ms; step-1 gradients of block
               and dots equal none's bit for bit.
13. autotune — policy tune over every cell of cnn-vgg11's plan_training(256)
               (top AUTOTUNE_TOPK candidates a cell): per cell the modeled
               argmin's and the winner's blocks, template and ms; then one
               step under cache-only with the stopwatch replaced by one
               that raises: launch counts of the tuned plan, every kernel
               handed its cached winner's blocks (a spy on the launches),
               loss within LOSS_TOL of the policy-off step.  (The check
               that a main-path call takes the register kernel belongs to
               the policy-off timings of phase 8.)

The serving slice (after ``remat``, before ``times``):

14. serve    — qwen1.5-0.5b at full width and depth, f32, served through the
               continuous-batching engine on the ladder (4, 256), (8, 512),
               (8, 1024) with max_seq 2048 and 8 KV slots, on the seed's
               weights plus seeded numpy noise scaled to each leaf's init
               std (the seed's alone repeat one token a stream; the CPU
               serving tests perturb theirs too).  Boot 1 warms
               under policy tune (the bucket cells timed on the matmul and
               flash-attention kernels: path ``serve_warmup``), boot 2
               under cache-only with the autotuner's timing path rigged to
               raise; each serves the same 24 seeded requests (prompts
               16-1000 tokens, 8-64 new tokens), all DONE, boot 2's streams
               equal to boot 1's, every tuned cell replayed, and no kernel
               launched at request time (serving runs plain PyTorch, as the
               JAX package's serving runs XLA).  Each tuned cell's winner
               runs on the tuner's synthesized operands, every launch held
               against its kernel's plain version within TOL x scale.
               Four requests' streams
               (longest, shortest, the first past each lower rung) against
               greedy_generate of the prompt alone: equal, or a divergence
               at a near-tie (the reference's top-2 gap below TOL x
               max(1, max |logit|)).  A 960-token prompt's 32 cached logits
               against no-cache forwards within TOL x max(1, max |ref|), on
               the served weights, beside the spread of two no-cache
               forwards one token apart (f32 rounding alone).
               Times: warmup seconds, prefill ms per bucket, slot-decode ms
               (CUDA events and profiled device time), a WallClock and a
               VirtualClock (the H100 model) load run, pool bytes and peak
               memory.

The tenth slice (after ``autotune``, once every earlier phase has freed
what it held):

15. moe_serve — qwen3-moe-235b-a22b at full width (d_model 4096, 64/4
               heads of 128 with qk-norm, 128 experts top-8 of d_ff 1536,
               capacity factor 1.25, vocab 151936, untied head), its depth
               cut from 94 layers to 4 (44.78 GB of f32 weights, drawn on
               the card from the seed and perturbed as phase serve's are),
               served through the engine exactly as phase serve serves
               qwen1.5-0.5b: boot 1 tunes (path ``moe_serve_warmup``),
               boot 2 replays cache-only with the timing path rigged to
               raise, 24 requests each, equal streams, no launch at request
               time; every tuned winner against its kernel's plain version
               (GQA 64/4 flash at D = 128, the qkv n 9216 and expert
               d_ff 1536 matmul cells), each distinct cell timed beside
               its plain version, one library call and its bound; 16
               cached logits of a 240-token prompt against no-cache
               forwards at capacity factor n_experts / top_k (no row
               dropped), beside the spread of two no-cache forwards.  The
               slot decode dispatches each slot alone.  Times: prefill ms
               per bucket, slot-decode ms (events and profiled device time
               by kernel) beside the bytes a step must read, the load runs,
               peak memory.
16. families — rwkv6-1.6b, zamba2-1.2b and seamless-m4t-medium at full
               width and depth (f32, weights drawn on the card): a seeded
               2 x 256 prompt (and 2 x 4096 x 1024 frames for the
               encoder-decoder), prefill, 16 cached greedy decode steps,
               each step's logits against one no-cache forward over the
               prompt and the generated tokens within TOL x
               max(1, max |logit|) (Zamba2's no-cache forward runs SSD
               chunks of 128, its decode the per-step recurrence: gated at
               max(TOL, SPREAD_GATE x the spread)), the spread of that
               forward against a longer one beside it;
               decode ms a step and peak memory.

The twelfth slice (after ``moe_serve``, once it has freed its weights):

18. dense    — the last dense configs at full width.  The flash kernel in
               two new cases against its plain version (GQA 64/8 at
               D = 128, 1 x 2048, qwen3-32b's and chameleon-34b's heads;
               gemma3-4b's 8/4 heads at D = 256 with its 1024 window over
               2048), timed beside SDPA where there is no window.  Then
               three planned training runs, each with its launches against
               plan_training's (remat included) and the attention cell
               planned and launched at the config's head dim of 128:
               qwen3-1.7b through the launcher at full width and depth
               (28 layers, 4 x 2048, 3 steps, cut to --remat block: at
               none the activations do not fit), and qwen3-32b and
               chameleon-34b at full width with the depth cut to 2 layers
               (1 x 2048, 2 steps through runtime.train.make_train_step,
               weights drawn on the card as phase moe_serve's, without
               its noise).  From the seed's weights, step 1 of each (for
               qwen3-1.7b the launcher's own weights): every distinct
               kernel call (kernel, shapes, blocks) held against its plain
               version on its own operands within TOL x scale and timed
               beside it, one library call and the bound; the loss and
               every gradient against the independent plain step (its
               layers checkpointed under remat) within LOSS_TOL and TOL x
               scale, leaf by leaf; one planned step's event and device
               ms; peak memory.  Then gemma3-4b at full width and depth
               (34 layers, 5 local layers of window 1024 to 1 global, D =
               256, vocab 262144; weights drawn on the card as phase
               moe_serve's), served as phase serve serves qwen1.5-0.5b on
               the ladder (4, 256), (2, 1024), (1, 2048) with max_seq 2048
               and 8 slots, prompts 16-1400 tokens: tune then cache-only
               boots (path ``dense_serve_warmup``), equal streams, no launch
               at request time, every tuned winner against its plain
               version, an 1100-token prompt's 8 cached logits against
               no-cache forwards (the window masks keys there); prefill and
               slot-decode times.

The eleventh slice (last):

17. paper    — the paper's analysis on the card.  One line of the paper's
               quoted numbers through the port's closed forms (Alg 1's CCR
               8.9, Delta_O 24/12, Alg 3's 541.4/540.6 as quoted beside Eq.
               10's 460.8/400.7, D_O <= 768/384, Alg 4/5's CCRs), each within
               0.05 of print.  Then ``conv_layer`` under alg1, alg2, alg3
               and strip at the running example (W_I 32, D_I = D_O = 128,
               F 3) at batch 1 and 256 and at every cnn-vgg11 conv at 256,
               and ``fc_layer`` at the paper's fc6 (B 32, 7 x 7 x 512 ->
               4096) and cnn-vgg11's fc1 and fc2 at 256: each output
               against its plain version (TF32 off) within TOL x scale, the
               blocks launched against the planned H100 schedule, launches
               counted on path ``paper`` (conv2d and matmul must both
               launch there), event ms and profiled device ms beside the
               schedule's modeled words, its H100 bound kind and roofline
               bound, and the Manticore closed form of the same layer
               (``conv_layer.traffic`` / ``fc_layer.traffic``: MACs,
               words, CCR, off-chip CCR, bound kind).  Alg 3 runs Alg 2's
               schedule on one device (checked); fc6's schedule words must
               equal Eqs. 12-13 at its block_n; a planner rejection is
               reported as one.

The thirteenth slice (after ``ckpt``):

19. mesh     — the multi-device half on R ranks (R = 2, then 4): processes
               that share the one card over ``gloo`` (a ``file://`` store
               under build/chip_smoke/mesh; gloo stages the CUDA tensors
               through host memory itself), each running the port on
               cuda:0.  These are not multi-chip or scaling numbers.  Against
               the 1-rank result on the card (planned, computed first by this
               process): (a) fc_layer_sharded at cnn-vgg11's fc1 ([256, 2048]
               x [2048, 4096]) and fc2 ([256, 4096] x [4096, 1000]) over a
               ``model`` axis of R under psum, ring and the planner's pick,
               forward and both gradients within TOL x scale, the ring's
               permutes a pass equal to ``schedule_sim.simulate_ring``'s
               hops; (b) the conv2d op's batch and stack partitions at
               conv1-conv3 of batch 256 within TOL x scale; (c) the
               cnn-vgg11 data-parallel step on a ``data`` axis of R at
               global batch 256, 3 planned AdamW steps through
               ``runtime.train`` (path ``mesh``): each rank's launches equal
               to the sharded plan's local schedules, losses within
               LOSS_TOL and parameters within TOL x scale of the 1-rank
               step, step-1 gradients (averaged over the ranks) within TOL
               x scale of the plain step that takes the ranks' planned
               forward decisions (gathered); each rank's step time by CUDA
               events and the collectives' host time apart (a step with
               every collective synchronized).  At R = 2 a probe records
               which ``gloo`` collectives take CUDA tensors.

The last line is the device record ``{"ok": true, "device": {...}}``.  With
no card, or outside a checkout, it prints no result and exits nonzero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 256
SEED = 0
TOL = 1e-4
NEAR_TIE = 1e-5
PEAK_F32 = 67e12  # H100 SXM, f32 on the CUDA cores (the kernels' FMAs)
HBM_BW = 3.35e12  # H100 SXM, bytes/s
PEAKS = "f32 CUDA cores 67 TFLOP/s, HBM3 3.35 TB/s (H100 SXM data sheet, 700 W)"
FUSED_BATCH = 128  # fc1/fc2 run the fused dX/dW kernel at batch <= 192
LOSS_TOL = 1e-4
STEPS = 3
REPLACES = {
    "matmul": "src/repro/kernels/matmul/matmul.py:32",
    "conv2d": "src/repro/kernels/conv2d/conv2d.py:49",
    "conv2d_wgrad": "src/repro/kernels/conv2d/bwd.py:519",
    "matmul_nt": "src/repro/kernels/matmul/bwd.py:59",
    "matmul_tn": "src/repro/kernels/matmul/bwd.py:222",
    "matmul_dx_dw": "src/repro/kernels/matmul/bwd.py:354",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:31",
}
SOURCES = {"matmul": "matmul", "conv2d": "conv2d", "conv2d_wgrad": "conv2d_wgrad",
           "matmul_nt": "matmul_bwd", "matmul_tn": "matmul_bwd",
           "matmul_dx_dw": "matmul_bwd", "flash_attention": "flash_attention"}
# The transformer path: qwen1.5-0.5b at full width and depth; batch and
# sequence cut from the train_4k cell's 256 x 4096 to what one card holds in
# f32 beside the independent plain step it is checked against.
TFM_ARCH = "qwen1.5-0.5b"
TFM_BATCH, TFM_SEQ = 4, 2048
TFM_PATH = f"train_{TFM_ARCH}"
TFM_CELLS = ("qkv", "wo", "mlp_up", "mlp_down", "logits")
# The train-step knobs of the eighth slice.
ACCUM = (2, 128)  # phase accum: batch 256 as 2 micro-batches of 128
CKPT_STEPS, CKPT_KILL = 4, 2  # phase ckpt: 4 steps; run B is stopped before step 2
REMATS = ("none", "block", "dots")
REMAT_PEAK_CUT = 0.9  # block's peak must be below this share of none's
AUTOTUNE_TOPK = 4  # candidates timed a cell (autotune.tune's default)
SCRATCH = ROOT / "build" / "chip_smoke"  # checkpoints and the winner caches
# The serving slice: qwen1.5-0.5b at full width and depth (the transformer
# phase's seed-0 weights), max_seq cut from the config's 32768 to 2048.
SERVE_LADDER = [(4, 256), (8, 512), (8, 1024)]
SERVE_MAX_SEQ = 2048
SERVE_SLOTS = 8
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 24, (16, 1000), (8, 64)  # a boot's requests
SERVE_CACHE_CHECK = (960, 32)  # prompt tokens, new tokens
SERVE_LOAD = dict(qps=50.0, n_requests=32, prompt_len=(16, 1000), new_tokens=(8, 64),
                  seed=SEED)
# The served weights: the seed's plus seeded numpy noise, as the CPU
# serving tests perturb theirs (greedy decoding on the seed's alone repeats
# a stream's first token), but scaled to each leaf: SERVE_PERTURB times the
# init std (1/sqrt(fan_in)) of every weight matrix but the embedding, and
# SERVE_PERTURB_ZEROS for the zero-init norm gains and biases: enough
# that no stream repeats one token, little enough that f32 rounding
# through the 24 layers stays well inside TOL (the cache check records
# that spread beside its error).
SERVE_PERTURB, SERVE_PERTURB_ZEROS = 1.75, 0.3
# The tenth slice.  Phase moe_serve: qwen3-moe-235b-a22b at full width, its
# depth cut from 94 layers to MOE_LAYERS (44.78 GB of f32 weights), served
# as phase serve serves qwen1.5-0.5b; its cache check: a prompt padded to
# the lowest rung, then decodes.  Phase families: rwkv6-1.6b, zamba2-1.2b and
# seamless-m4t-medium at full width and depth.
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 4
MOE_CACHE_CHECK = (240, 16)  # prompt tokens, new tokens
FAMILY_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b", "seamless-m4t-medium")
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_DECODE = 2, 256, 16
# Zamba2's gap is gated at max(TOL, SPREAD_GATE x the spread of its no-cache
# forward against a longer one): 38 layers on the perturbed weights put
# that spread itself at 1.02e-4 of scale on the card.
SPREAD_GATE = 2.0
# The eleventh slice.  Phase paper: the direct conv under the paper's
# strategies and the FC layer, each measured beside the closed forms of
# core/ccr.py.  The running example (Sec. 2) at batch 1 (the paper's layer)
# and PAPER_BATCH, then every cnn-vgg11 conv at BATCH; the paper's FC
# (VGG fc6, Sec. 3; benchmarks/run.py quotes it) and cnn-vgg11's fc1 and fc2.
PAPER_STRATEGIES = ("alg1", "alg2", "alg3", "strip")
PAPER_EXAMPLE = dict(W_I=32, D_I=128, D_O=128, F=3, S=1, P=1)
PAPER_BATCHES = (1, 256)
PAPER_FC = dict(W_I=7, D_I=512, D_O=4096, B=32)
PAPER_REPS = 10
# The twelfth slice.  Phase dense: the last dense configs, at full width.
# qwen3-1.7b trains through the launcher at full depth (28 layers), its
# batch x seq as the transformer phase's, cut to --remat block (at remat
# none its 28 layers keep about 130 GB of activations); qwen3-32b and
# chameleon-34b take DENSE_CUT_STEPS planned steps at full width with the
# depth cut to DENSE_CUT_LAYERS (2.53 B and 2.46 B parameters: weights,
# gradients, AdamW's moments and the update's new copies fill the card),
# batch 1 x 2048; gemma3-4b is served at full width and depth (34 layers),
# max_seq cut from 524288 to DENSE_SERVE_MAX_SEQ, with prompts past its
# 1024-token window.
DENSE_ARCH, DENSE_REMAT = "qwen3-1.7b", "block"
DENSE_CUT = ("qwen3-32b", "chameleon-34b")
DENSE_CUT_LAYERS, DENSE_CUT_BATCH, DENSE_CUT_STEPS = 2, 1, 2
DENSE_FLASH = [("gqa64/8-d128", 1, 64, 8, 2048, 2048, 128, None),
               ("gemma3-local", 1, 8, 4, 2048, 2048, 256, 1024)]
DENSE_SERVE_ARCH = "gemma3-4b"
DENSE_SERVE_LADDER = [(4, 256), (2, 1024), (1, 2048)]
DENSE_SERVE_MAX_SEQ = 2048
DENSE_SERVE_PROMPT = (16, 1400)
DENSE_CACHE_CHECK = (1100, 8)  # prompt tokens (past the window), new tokens

# Phase mesh: ranks sharing the one card over gloo.
MESH_RANKS = (2, 4)
MESH_TIMEOUT = 300  # seconds a rank process (and a gloo collective) may take
MESH_FC = {"fc1": (256, 2048, 4096), "fc2": (256, 4096, 1000)}  # m, k, n
MESH_CONVS = ("conv1", "conv2", "conv3")
MESH_STRATEGIES = ("psum", "ring", None)  # None: the planner's pick
MESH_NEAR_TIE_SHARE = 1e-3  # of a leaf's elements that a near-tie sign may move


def tfm_chunks() -> int:
    """The launcher's chunked cross-entropy chunks, which the checks plan with."""
    from repro_torch.launch.train import LOSS_CHUNKS

    return LOSS_CHUNKS


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def scale(want) -> float:
    return max(1.0, float(want.abs().max()))


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- the cases: every main-path shape of cnn-vgg11 at batch 256 ----------------


def conv_cases(torch, plans, cnn, cfg):
    """Direct-kernel launches: (label, args, kwargs) at every conv stage's
    shape with the all-direct plan's blocks, plus a ragged case."""
    from repro_torch.kernels.conv2d.ops import conv_out_extent

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for name, x_shape, w_shape in cnn._stage_geometry(cfg, BATCH):
        if not name.startswith("conv"):
            continue
        b = plans["direct"][name].block_dict()
        B, H, _, d_in = x_shape
        H_O = conv_out_extent(H, 1, 3, 1)
        n_h = -(-H_O // b["block_h"])
        pad_b = 1 + max(0, (n_h * b["block_h"] - 1) + 3 - (H + 2))
        x = torch.nn.functional.pad(
            torch.randn(x_shape, device="cuda", generator=g), (0, 0, 1, 1, 1, pad_b))
        f = torch.randn(w_shape, device="cuda", generator=g) / (9 * d_in) ** 0.5
        bias = torch.randn(w_shape[3], device="cuda", generator=g) * 0.1
        kw = dict(stride=1, block_h=b["block_h"], block_do=b["block_do"],
                  block_di=b["block_di"], H_O=H_O, W_O=H_O, relu=True, pool=2)
        out.append((name, (x.contiguous(), f, bias), kw))
    # ragged: odd channels (5 -> 13), stride 2, an odd 9x9 plane, strips of
    # 4 rows (the third strip runs past H_O on zero rows)
    x = torch.randn(3, 17, 17, 5, device="cuda", generator=g)
    pad_b = 1 + max(0, (3 * 4 - 1) * 2 + 3 - (17 + 2))
    x = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, pad_b)).contiguous()
    f = torch.randn(3, 3, 5, 13, device="cuda", generator=g)
    bias = torch.randn(13, device="cuda", generator=g)
    out.append(("ragged", (x, f, bias), dict(stride=2, block_h=4, block_do=16, block_di=8,
                                              H_O=9, W_O=9, relu=True, pool=1)))
    return out


def matmul_cases(torch, plans, cnn, cfg):
    """Matmul launches: the first im2col strip GEMM of every conv stage
    (the all-im2col plan's blocks) and fc1/fc2, plus a ragged case."""
    from repro_torch.kernels.conv2d.im2col import strip_patches
    from repro_torch.plan import pad_dim, round_up

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = []
    for name, x_shape, w_shape in cnn._stage_geometry(cfg, BATCH):
        conv = name.startswith("conv")
        b = (plans["im2col"] if conv else plans["default"])[name].block_dict()
        bm, bn, bk = b["block_m"], b["block_n"], b["block_k"]
        if conv:
            B, H, _, d_in = x_shape
            xp = torch.nn.functional.pad(torch.randn(x_shape, device="cuda", generator=g),
                                         (0, 0, 1, 1, 1, 1))
            a = strip_patches(xp, 0, min(b["block_h"], H), F=3, S=1, W_O=H)
            w = torch.randn(9 * d_in, w_shape[3], device="cuda", generator=g)
            w = w / (9 * d_in) ** 0.5
        else:
            a = torch.randn(x_shape, device="cuda", generator=g)
            w = torch.randn(w_shape, device="cuda", generator=g) / w_shape[0] ** 0.5
        m, k = a.shape
        n = w.shape[1]
        a = pad_dim(pad_dim(a, 0, round_up(m, bm)), 1, round_up(k, bk)).contiguous()
        w = pad_dim(pad_dim(w, 0, round_up(k, bk)), 1, round_up(n, bn)).contiguous()
        out.append((f"{name}.strip" if conv else name, (a, w),
                    dict(block_m=bm, block_n=bn, block_k=bk)))
    a = torch.randn(40, 304, device="cuda", generator=g)  # 37x300 padded to blocks
    w = torch.randn(304, 80, device="cuda", generator=g)
    a[37:], a[:, 300:], w[300:], w[:, 77:] = 0, 0, 0, 0
    out.append(("ragged", (a, w), dict(block_m=8, block_n=16, block_k=16)))
    return out


def stage_launches(name: str, s) -> dict:
    """Launches of each kernel that one stage's schedule makes."""
    if s.algorithm == "im2col":
        return {"conv2d": 0, "matmul": s.grid[0]}  # one GEMM per strip
    if name.startswith("conv"):
        return {"conv2d": 1, "matmul": 0}
    return {"conv2d": 0, "matmul": 1}


def expected_launches(plans: dict) -> dict:
    per_stage = [stage_launches(name, s) for name, s in plans.items()]
    return {k: sum(p[k] for p in per_stage) for k in ("conv2d", "matmul")}


def main_path_launches(plans: dict, kernel: str, label: str) -> int:
    """How often the default plan's forward makes this call (0: the call
    belongs to the all-direct or all-im2col forward only, or to the
    backward)."""
    stage, _, role = label.partition(".")
    s = plans["default"].get(stage)
    if s is None or role not in ("", "strip"):
        return 0
    return stage_launches(stage, s).get(kernel, 0)


def mask_disagreements(torch, plain_fn, args, kw, k_mask, p_mask):
    """(positions that differ, near-ties): a near-tie is a window whose two
    best candidates (the window's pre-ReLU values and 0, the ReLU
    threshold) differ by less than NEAR_TIE relative — where f32 sums in
    another order may pick the other one.  Every difference must be a
    near-tie."""
    pool = kw["pool"]
    y = plain_fn(*args, **{**kw, "pool": 1, "relu": False, "emit_mask": False})
    B, R, W, C = y.shape
    win = (y.reshape(B, R // pool, pool, W // pool, pool, C)
           .permute(0, 1, 3, 5, 2, 4).reshape(B, R // pool, W // pool, C, pool * pool))
    cand = torch.cat([win, torch.zeros_like(win[..., :1])], dim=-1)
    top2 = cand.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < NEAR_TIE * top2[..., 0].abs().clamp(min=1.0)
    diff = k_mask != p_mask
    check(bool((diff & ~near).sum() == 0), "mask differs away from near-ties")
    return int(diff.sum()), int(near.sum())


# -- the backward cases: every backward shape of the cnn-vgg11 training step -------


def train_calls(cnn, cl, cfg, plans, batch) -> dict:
    """Launches of each kernel that one planned training step makes, by
    call: {(kernel, label): count}.  conv0's dgrad never runs (the images
    need no gradient); a stage whose forward runs im2col saves no mask and
    recomputes its pre-epilogue activation with the planner's pool-free
    conv."""
    calls = {}

    def add(kernel, label, n=1):
        calls[(kernel, label)] = calls.get((kernel, label), 0) + n

    for i, (name, x_shape, w_shape) in enumerate(cnn._stage_geometry(cfg, batch)):
        s = plans[name]
        if name.startswith("conv"):
            convs = [(s, name)]
            if s.algorithm == "im2col":
                convs.append((cl.plan(x_shape, w_shape, stride=1, padding=1, pool=1),
                              f"{name}.recompute"))
            for c, label in convs:
                if c.algorithm == "im2col":
                    add("matmul", f"{name}.strip", c.grid[0])  # one GEMM per strip
                else:
                    add("conv2d", label)
            if i > 0:
                add("conv2d", f"{name}.dgrad")
            add("conv2d_wgrad", f"{name}.wgrad")
        else:
            add("matmul", name)
            if plans[f"{name}.dx"].algorithm == "fused_dxdw":
                add("matmul_dx_dw", f"{name}.dxdw")
            else:
                add("matmul_nt", f"{name}.dx")
                add("matmul_tn", f"{name}.dw")
    return calls


def per_kernel(calls: dict, kernels) -> dict:
    return {k: sum(n for (kk, _), n in calls.items() if kk == k) for k in kernels}


def bwd_cases(torch, cnn, cfg):
    """(kernel, label, args, kwargs, meta) of every backward call of the
    planned training step at batch 256 — the fused dX/dW kernel at batch
    128 — with the training plan's blocks, plus a ragged case per kernel.
    ``meta`` holds the call's operations and bytes (unpadded) and its
    library yardstick (None where no one PyTorch call computes it)."""
    from repro_torch.kernels.conv2d.bwd import dgrad_operands, wgrad_operands
    from repro_torch.plan import pad_dim, round_up

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def rand(*shape, s=1.0):
        return torch.randn(shape, device="cuda", generator=g) * s

    def padded(t, *sizes):
        for axis, size in enumerate(sizes):
            t = pad_dim(t, axis, size)
        return t.contiguous()

    def nchw(t):
        return t.permute(0, 3, 1, 2).contiguous()

    out = []
    for batch in (BATCH, FUSED_BATCH):
        plans = cnn.plan_training(cfg, batch)
        for i, (name, x_shape, w_shape) in enumerate(cnn._stage_geometry(cfg, batch)):
            if name.startswith("conv") and batch == BATCH:
                B, H, _, ci = x_shape
                co = w_shape[3]
                x, dy = rand(*x_shape), rand(B, H, H, co)
                f = rand(*w_shape, s=(9 * co) ** -0.5)
                flops = 2.0 * B * H * H * 9 * ci * co
                s_wg = plans[f"{name}.wgrad"]
                b = s_wg.block_dict()
                xp, gp, geo = wgrad_operands(x, dy, F=3, stride=1, padding=1,
                                             block_h=b["block_h"])
                x_n, dy_n = nchw(x), nchw(dy)
                out.append(("conv2d_wgrad", f"{name}.wgrad", (xp, gp),
                            dict(geo, block_do=b["block_do"], block_di=b["block_di"]),
                            dict(flops=flops,
                                 nbytes=4.0 * (x.numel() + dy.numel() + f.numel()),
                                 lib=lambda x_n=x_n, dy_n=dy_n, w=(co, ci, 3, 3):
                                 torch.nn.grad.conv2d_weight(x_n, w, dy_n, padding=1),
                                 schedule_words={"algorithm": s_wg.algorithm,
                                                 "loads": s_wg.loads,
                                                 "stores": s_wg.stores})))
                if i > 0:
                    b = plans[f"{name}.dgrad"].block_dict()
                    xq, ft, bias, geo = dgrad_operands(dy, f, stride=1, padding=1,
                                                       out_hw=(H, H), block_h=b["block_h"])
                    f_n = f.permute(3, 2, 0, 1).contiguous()
                    out.append(("conv2d", f"{name}.dgrad", (xq, ft, bias),
                                dict(geo, block_do=b["block_do"], block_di=b["block_di"]),
                                dict(flops=flops,
                                     nbytes=4.0 * (x.numel() + dy.numel() + f.numel()),
                                     lib=lambda dy_n=dy_n, f_n=f_n, xs=(B, ci, H, H):
                                     torch.nn.grad.conv2d_input(xs, f_n, dy_n, padding=1))))
            elif name.startswith("fc"):
                m, k = x_shape
                n = w_shape[1]
                x, w, gr = rand(m, k), rand(k, n, s=k ** -0.5), rand(m, n)
                flops, nbytes = 2.0 * m * n * k, 4.0 * (m * n + k * n + m * k)
                bx, bw = plans[f"{name}.dx"].block_dict(), plans[f"{name}.dw"].block_dict()
                if batch == FUSED_BATCH:
                    bm, bn, bk = bx["block_m"], bx["block_n"], bx["block_k"]
                    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
                    out.append(("matmul_dx_dw", f"{name}.dxdw",
                                (padded(gr, mp, np_), padded(w, kp, np_), padded(x, mp, kp)),
                                dict(block_m=bm, block_n=bn, block_k=bk),
                                dict(flops=2 * flops, nbytes=nbytes + 4.0 * (m * k + k * n),
                                     lib=None, pairs=fused_pairs(torch, x, w, gr, bw, padded))))
                    continue
                for kernel, b in (("matmul_nt", bx), ("matmul_tn", bw)):
                    bm, bn, bk = b["block_m"], b["block_n"], b["block_k"]
                    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
                    nt = kernel == "matmul_nt"
                    args = ((padded(gr, mp, np_), padded(w, kp, np_)) if nt
                            else (padded(x, mp, kp), padded(gr, mp, np_)))
                    lib = ((lambda gr=gr, w=w: torch.matmul(gr, w.t())) if nt
                           else (lambda x=x, gr=gr: torch.matmul(x.t(), gr)))
                    out.append((kernel, f"{name}.{'dx' if nt else 'dw'}", args,
                                dict(block_m=bm, block_n=bn, block_k=bk),
                                dict(flops=flops, nbytes=nbytes, lib=lib)))
    # ragged: odd channels (5 -> 13), stride 2, an odd 9x9 gradient plane,
    # strips of 4 rows (the last one past the plane)
    x, dy, f = rand(3, 17, 17, 5), rand(3, 9, 9, 13), rand(3, 3, 5, 13)
    xp, gp, geo = wgrad_operands(x, dy, F=3, stride=2, padding=1, block_h=4)
    out.append(("conv2d_wgrad", "ragged", (xp, gp), dict(geo, block_do=16, block_di=8), {}))
    xq, ft, bias, geo = dgrad_operands(dy, f, stride=2, padding=1, out_hw=(17, 17),
                                       block_h=4)
    out.append(("conv2d", "ragged.dgrad", (xq, ft, bias), dict(geo, block_do=8, block_di=8),
                {}))
    blocks = dict(block_m=8, block_n=16, block_k=16)  # 37 x 90 x 70 padded
    x, w, gr = rand(40, 96), rand(96, 80), rand(40, 80)
    x[37:], x[:, 90:], w[90:], w[:, 70:], gr[37:], gr[:, 70:] = 0, 0, 0, 0, 0, 0
    out.append(("matmul_nt", "ragged", (gr, w), blocks, {}))
    out.append(("matmul_tn", "ragged", (x, gr), blocks, {}))
    out.append(("matmul_dx_dw", "ragged", (gr, w, x), blocks, {}))
    return out


def fused_pairs(torch, x, w, gr, b_dw, padded) -> dict:
    """The two yardsticks of a fused dX/dW call: the two torch.matmul calls
    for the same pair of products, and the port's own NT + TN at the
    layer's direct blocks (what plan_bwd runs where the fused schedule does
    not fit)."""
    from repro_torch.core.machine import H100
    from repro_torch.kernels.matmul.bwd import matmul_nt_kernel, matmul_tn_kernel
    from repro_torch.plan import planner_for, round_up

    (m, k), n = x.shape, w.shape[1]
    b_dx = planner_for("matmul_dx", H100).plan(m=m, n=n, k=k, in_bytes=4).block_dict()
    nt, tn = ({key: b[key] for key in ("block_m", "block_n", "block_k")} for b in (b_dx, b_dw))
    g_nt = padded(gr, round_up(m, nt["block_m"]), round_up(n, nt["block_n"]))
    w_nt = padded(w, round_up(k, nt["block_k"]), round_up(n, nt["block_n"]))
    x_tn = padded(x, round_up(m, tn["block_m"]), round_up(k, tn["block_k"]))
    g_tn = padded(gr, round_up(m, tn["block_m"]), round_up(n, tn["block_n"]))
    return {"pair_library_ms": lambda: (torch.matmul(gr, w.t()), torch.matmul(x.t(), gr)),
            "pair_port_ms": lambda: (matmul_nt_kernel(g_nt, w_nt, **nt),
                                     matmul_tn_kernel(x_tn, g_tn, **tn))}


# -- phases -------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
             for name, log in reports.items()}
    emit(phase="build", ok=True, seconds=round(time.perf_counter() - t0, 3),
         sources=_build.sources(), ptxas=ptxas)


def phase_kernels(torch, plans, cnn, cfg, results):
    from repro_torch.kernels.conv2d.conv2d import conv2d_fused_plain, conv2d_kernel
    from repro_torch.kernels.matmul.matmul import matmul_kernel, matmul_plain

    for label, args, kw in conv_cases(torch, plans, cnn, cfg):
        for emit_mask in (False, True):
            got = conv2d_kernel(*args, **kw, emit_mask=emit_mask)
            want = conv2d_fused_plain(*args, **kw, emit_mask=emit_mask)
            torch.cuda.synchronize()
            n_diff = n_near = 0
            if emit_mask:
                (got, k_mask), (want, p_mask) = got, want
                n_diff, n_near = mask_disagreements(torch, conv2d_fused_plain, args, kw,
                                                    k_mask, p_mask)
            err = max_err(got, want)
            check(err <= TOL * scale(want), f"conv2d {label}: err {err}")
            results["conv2d"]["max_abs_err"] = max(results["conv2d"]["max_abs_err"], err)
            emit(phase="kernels", kernel="conv2d", case=label, emit_mask=emit_mask,
                 shape=list(args[0].shape), out=list(got.shape), max_abs_err=err,
                 max_abs_plain=float(want.abs().max()), mask_differs=n_diff,
                 near_ties=n_near, **template_record("conv2d", args, kw))
            if emit_mask and ("conv2d", label) in DETERMINISM:
                check_bit_identical(torch, "conv2d", label,
                                    lambda: conv2d_kernel(*args, **kw, emit_mask=True))
    for label, args, kw in matmul_cases(torch, plans, cnn, cfg):
        got = matmul_kernel(*args, **kw)
        want = matmul_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err <= TOL * scale(want), f"matmul {label}: err {err}")
        results["matmul"]["max_abs_err"] = max(results["matmul"]["max_abs_err"], err)
        emit(phase="kernels", kernel="matmul", case=label, shape=[list(a.shape) for a in args],
             blocks=kw, max_abs_err=err, max_abs_plain=float(want.abs().max()),
             **template_record("matmul", args, kw))
        if ("matmul", label) in DETERMINISM:
            check_bit_identical(torch, "matmul", label, lambda: matmul_kernel(*args, **kw))
    # the odd plane's tail pool runs after the kernel, at the op level
    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.kernels.conv2d.ref import conv2d_fused_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(2, 13, 13, 7, device="cuda", generator=g)
    f = torch.randn(3, 3, 7, 11, device="cuda", generator=g)
    bias = torch.randn(11, device="cuda", generator=g)
    got = conv2d(x, f, bias=bias, stride=2, padding=1, relu=True, pool=2, algorithm="direct")
    want = conv2d_fused_ref(x, f, bias, stride=2, padding=1, relu=True, pool=2)
    err = max_err(got, want)
    check(tuple(got.shape) == (2, 3, 3, 11) and err <= TOL * scale(want),
          f"conv2d tail pool: err {err}")
    emit(phase="kernels", kernel="conv2d", case="odd-plane-tail-pool", out=list(got.shape),
         max_abs_err=err)


def run_forward(torch, cnn, cfg, params, images, plans, kernels):
    zero_counts(kernels)
    logits = cnn.forward(cfg, params, images, schedules=plans)
    torch.cuda.synchronize()
    return logits, {name: k.launches for name, k in kernels.items()}


def phase_forward(torch, plans, cnn, cfg, params, images, kernels, results):
    with torch.no_grad():
        plain = cnn.forward(cfg, params, images, use_kernels=False)
        torch.cuda.synchronize()
        for alg in ("default", "direct", "im2col"):
            logits, launches = run_forward(torch, cnn, cfg, params, images, plans[alg], kernels)
            check(tuple(logits.shape) == (BATCH, cfg.vocab), f"{alg}: shape {logits.shape}")
            check(bool(torch.isfinite(logits).all()), f"{alg}: non-finite logits")
            err = max_err(logits, plain)
            check(err <= TOL * scale(plain), f"forward {alg}: err {err}")
            want = {name: 0 for name in kernels} | expected_launches(plans[alg])
            check(launches == want, f"forward {alg}: launches {launches} != plan {want}")
            if alg == "default":
                for name in kernels:
                    results[name]["launches_by_path"]["forward"] = launches[name]
            emit(phase="forward", conv_algorithm=alg, batch=BATCH, logits=list(logits.shape),
                 max_abs_err=err, max_abs_plain=float(plain.abs().max()), launches=launches,
                 schedules={n: {"algorithm": s.algorithm, "blocks": s.block_dict(),
                                "grid": list(s.grid), "smem_bytes": s.vmem_bytes}
                            for n, s in plans[alg].items()})


def split_record(kernel, args, kw) -> dict:
    """The launch's split of its contraction (wgrad: the (batch, strip)
    sweep; NT, TN and the forward matmul: the N, M or K loop; the fused
    dX/dW kernel: each k-block's n-blocks) and its partial-slab bytes
    (traffic the planner's modeled words do not count)."""
    from repro_torch.core.machine import h100_resident_blocks
    from repro_torch.kernels.conv2d import bwd as cb
    from repro_torch.kernels.matmul import bwd as mb
    from repro_torch.kernels.matmul.matmul import mm_partial_bytes, mm_split

    if kernel == "matmul":
        (m, k), n = args[0].shape, args[1].shape[1]
        blocks = {b: kw[b] for b in ("block_m", "block_n", "block_k")}
        split = mm_split(m=m, n=n, k=k, **blocks)
        return {"split": split, "partial_bytes": mm_partial_bytes(m=m, n=n, split=split)}
    if kernel == "matmul_nt":
        (m, n), k = args[0].shape, args[1].shape[0]
        blocks = {b: kw[b] for b in ("block_m", "block_n", "block_k")}
        split = mb.nt_split(m=m, n=n, k=k, **blocks)
        return {"split": split, "partial_bytes": mb.nt_partial_bytes(m=m, k=k, split=split)}
    if kernel == "matmul_tn":
        (m, k), n = args[0].shape, args[1].shape[1]
        blocks = {b: kw[b] for b in ("block_m", "block_n", "block_k")}
        split = mb.tn_split(m=m, n=n, k=k, **blocks)
        return {"split": split, "partial_bytes": mb.tn_partial_bytes(k=k, n=n, split=split)}
    if kernel == "matmul_dx_dw":
        (m, n), k = args[0].shape, args[1].shape[0]
        blocks = {b: kw[b] for b in ("block_m", "block_n", "block_k")}
        split = mb.dxdw_split(m=m, n=n, k=k, **blocks)
        return {"split": split, "partial_bytes": mb.nt_partial_bytes(m=m, k=k, split=split)}
    B = args[0].shape[0]
    d_in, d_out = (cb.wgrad_channels(t.shape[-1]) for t in args)
    smem = cb.wgrad_smem_bytes(block_h=kw["block_h"], block_do=kw["block_do"],
                               block_di=kw["block_di"], W_O=kw["W_O"], F=kw["F"],
                               S=kw["stride"])
    split = cb.wgrad_split(d_in=d_in, d_out=d_out, block_di=kw["block_di"],
                           block_do=kw["block_do"], batch=B,
                           n_h=args[1].shape[1] // kw["block_h"], smem_bytes=smem)
    return {"split": split, "channels": [d_in, d_out],
            "resident_blocks": h100_resident_blocks(smem),
            "partial_bytes": cb.wgrad_partial_bytes(F=kw["F"], d_in=d_in, d_out=d_out,
                                                    split=split)}


def template_record(kernel, args, kw) -> dict:
    """Which kernel template a conv2d, matmul, TN or fused dX/dW launch
    takes: the conv's register kernel with its pixel run and channel
    groups, or the simple kernel; the matmul's, TN's and the fused kernel's
    register or simple kernel and their K, M or N split.  All are the
    choices the wrappers pass to the C entry points, which dispatch on
    them."""
    from repro_torch.kernels.conv2d.conv2d import register_layout
    from repro_torch.kernels.matmul.bwd import dxdw_template, tn_template
    from repro_torch.kernels.matmul.matmul import template

    if kernel == "matmul_dx_dw":
        return dict(template=dxdw_template(kw["block_m"], kw["block_n"], kw["block_k"],
                                           args[0].shape[0]),
                    **split_record(kernel, args, kw))
    if kernel in ("matmul", "matmul_tn"):
        pick = template if kernel == "matmul" else tn_template
        return dict(template=pick(kw["block_m"], kw["block_n"], kw["block_k"]),
                    **split_record(kernel, args, kw))
    layout = register_layout(block_h=kw["block_h"], block_do=kw["block_do"],
                                block_di=kw["block_di"], W_O=kw["W_O"],
                                F=args[1].shape[0], S=kw["stride"])
    return dict(template="register" if layout else "simple", layout=layout)


# The calls whose two launches must give the same bits: a split and an
# unsplit call of each register kernel (wgrad, NT, TN, the forward matmul),
# both fused dX/dW calls (split 8 and 4), the direct conv's forward (with
# its mask) and dgrad, and flash attention.
DETERMINISM = {("conv2d_wgrad", "conv0.wgrad"), ("conv2d_wgrad", "conv3.wgrad"),
               ("matmul_nt", "fc1.dx"), ("matmul_nt", "qkv.dx"),
               ("matmul_tn", "wo.dw"), ("matmul_tn", "qkv.dw"), ("matmul_tn", "fc1.dw"),
               ("matmul_dx_dw", "fc1.dxdw"), ("matmul_dx_dw", "fc2.dxdw"),
               ("matmul", "fc2"), ("matmul", "qkv"),
               ("conv2d", "conv1"), ("conv2d", "conv3.dgrad"),
               ("flash_attention", "attn")}
DETERMINED: set = set()


def check_bit_identical(torch, kernel, label, fn, card=None) -> None:
    """Two launches on the same inputs give the same bits (fixed-order sums,
    no atomics)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    same = all(bool(torch.equal(x, y)) for x, y in pairs)
    emit(phase="determinism", kernel=kernel, case=label, bit_identical=same,
         **({"card": card} if card else {}))
    check(same, f"{kernel} {label}: two launches differ")
    DETERMINED.add((kernel, label))


def phase_bwd(torch, cnn, cfg, kernels, results):
    for kernel, label, args, kw, meta in bwd_cases(torch, cnn, cfg):
        k = kernels[kernel]
        got, want = k(*args, **kw), k.plain(*args, **kw)
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = max(max_err(a, b) for a, b in pairs)
        check(all(max_err(a, b) <= TOL * scale(b) for a, b in pairs),
              f"{kernel} {label}: err {err}")
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)
        extra = {}
        if kernel == "conv2d_wgrad":
            extra = dict(split_record(kernel, args, kw),
                         schedule_words=meta.get("schedule_words"))
        elif kernel == "matmul_nt":
            extra = split_record(kernel, args, kw)
        elif kernel in ("conv2d", "matmul_tn", "matmul_dx_dw"):
            extra = template_record(kernel, args, kw)
        emit(phase="bwd", kernel=kernel, case=label, shape=[list(a.shape) for a in args],
             blocks={b: v for b, v in kw.items() if b.startswith("block")}, max_abs_err=err,
             max_abs_plain=max(float(b.abs().max()) for _, b in pairs), **extra)
        if (kernel, label) in DETERMINISM:
            check_bit_identical(torch, kernel, label, lambda: k(*args, **kw))


def zero_counts(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


BWD_KERNELS = ("conv2d", "conv2d_wgrad", "matmul_nt", "matmul_tn", "matmul_dx_dw")


def planned_grads(torch, cfg, tr, tcfg, params, batch, kernels, *, plain):
    """Step-1 loss and gradients of the planned loss: the forward on the
    kernels, the backward with the kernels named in ``plain`` swapped for
    their plain versions (on the same CUDA tensors) — conv2d's only
    backward role at batch 256 is dgrad; the recompute GEMM stays on the
    kernel, so both backwards see the same ReLU/max-pool decisions."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = tr.make_loss_fn(cfg, tcfg)(leaves, batch)
    saved = {n: kernels[n].launch for n in plain}
    for n in plain:
        kernels[n].launch = lambda k, *a, **kw: k.plain(*a, **kw)
    try:
        got = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for n, fn in saved.items():
            kernels[n].launch = fn
    return float(loss.detach()), dict(zip(leaves, got))


def pool_windows(torch, y):
    """[B, R, W, C] -> [B, R/2, W/2, C, 5]: each 2x2 pool window's values
    in row-major order (the mask's encoding), then ReLU's 0 (index 4, a
    dead window)."""
    B, R, W, C = y.shape
    win = (y.reshape(B, R // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
           .reshape(B, R // 2, W // 2, C, 4))
    return torch.cat([win, torch.zeros_like(win[..., :1])], dim=-1)


def planned_decisions(torch, cfg, params, images, plans) -> dict:
    """The ReLU/max-pool decisions the planned step's backward takes, read
    off the planned forward: each conv stage's int8 epilogue mask, or —
    where a stage saves none (an im2col schedule) — the window argmax of
    the recompute conv's pre-epilogue values that its backward uses; and
    the liveness of fc1's ReLU."""
    from repro_torch.core.fc_layer import fc_layer
    from repro_torch.kernels.conv2d.ops import conv2d, conv2d_with_mask

    out, x = {}, images
    with torch.no_grad():
        for i in range(cfg.n_layers):
            f, b = params[f"conv{i}"], params[f"bias{i}"]
            y, mask = conv2d_with_mask(x, f, bias=b, stride=1, padding=1, pool=2,
                                       schedule=plans[f"conv{i}"])
            if mask is None:
                y0 = conv2d(x, f, bias=b, stride=1, padding=1, relu=False, pool=1,
                            schedule=plans.get(f"conv{i}.recompute"))
                mask = pool_windows(torch, y0).argmax(-1)
            out[f"conv{i}"], x = mask.long(), y
        h = fc_layer(x.reshape(x.shape[0], -1), params["fc1"], plans["fc1"])
        out["fc1"] = (h + params["fc1_b"]) > 0
    return out


def decided_plain_loss(torch, cfg, params, batch, decisions):
    """The plain step's loss — cuDNN convolutions, cuBLAS matmuls, torch
    autograd — with every ReLU/max-pool decision taken from ``decisions``
    instead of its own forward, so its gradients differ from the planned
    step's only by the order of their sums."""
    import torch.nn.functional as F

    x = batch["images"]
    for i in range(cfg.n_layers):
        f, b = params[f"conv{i}"], params[f"bias{i}"]
        y = F.conv2d(x.permute(0, 3, 1, 2), f.permute(3, 2, 0, 1), b, padding=1)
        win = pool_windows(torch, y.permute(0, 2, 3, 1))
        x = win.gather(-1, decisions[f"conv{i}"][..., None])[..., 0]
    x = x.reshape(x.shape[0], -1)
    h = (x @ params["fc1"] + params["fc1_b"]) * decisions["fc1"]
    return F.cross_entropy(h @ params["fc2"] + params["fc2_b"], batch["labels"].long())


def phase_train(torch, cnn, cfg, kernels, results):
    """The launcher at full width (the slice's main path) with its launch
    counts, then planned-vs-plain parity from one seeded state."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import conv_layer as cl
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.launch import train as launch
    from repro_torch.models.module import init_params
    from repro_torch.runtime import train as tr

    for batch, steps in ((BATCH, STEPS), (FUSED_BATCH, 1)):
        calls = train_calls(cnn, cl, cfg, cnn.plan_training(cfg, batch), batch)
        want = {k: steps * n for k, n in per_kernel(calls, kernels).items()}
        zero_counts(kernels)
        history = launch.main(["--arch", cfg.name, "--batch", str(batch), "--steps",
                               str(steps), "--planned-kernels", "--seed", str(SEED),
                               "--log-every", "1"])
        torch.cuda.synchronize()
        got = {name: k.launches for name, k in kernels.items()}
        check(got == want, f"train batch {batch}: launches {got} != plan {want}")
        check(all(math.isfinite(h["loss"]) for h in history), f"train batch {batch}: loss")
        path = f"train_b{batch}"
        for name in kernels:
            results[name]["launches_by_path"][path] = got[name]
        emit(phase="train", path=path, steps=steps, batch=batch, launches=got,
             launches_per_step={k: n // steps for k, n in got.items()},
             losses=[h["loss"] for h in history])

    kw = dict(param_dtype="float32", compute_dtype="float32", learning_rate=3e-4,
              warmup_steps=1, total_steps=STEPS, seed=SEED)
    tcfgs = {"planned": TrainConfig(**kw, planned_kernels=True),
             "plain": TrainConfig(**kw, planned_kernels=False)}
    params0 = init_params(cnn.param_defs(cfg), SEED)
    src = cnn.data_source(cfg, BATCH, ShardInfo(0, 1), seed=SEED)
    batches = [tr.batch_to(src(i), "cuda") for i in range(STEPS)]
    # (A) the kernels against their plain versions on the same forward: the
    # planned step's backward once with its kernels and once with each
    # backward kernel's plain version (same saved masks, same decisions).
    # (B) against the plain step (cuDNN/cuBLAS autograd, TF32 off) on the
    # planned forward's decisions.
    loss, got = planned_grads(torch, cfg, tr, tcfgs["planned"], params0, batches[0],
                              kernels, plain=())
    ref_loss, grads = {}, {}
    ref_loss["plain versions"], grads["plain versions"] = planned_grads(
        torch, cfg, tr, tcfgs["planned"], params0, batches[0], kernels, plain=BWD_KERNELS)
    plans = cnn.plan_training(cfg, BATCH)
    decisions = planned_decisions(torch, cfg, params0, batches[0]["images"], plans)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params0.items()}
    plain_loss = decided_plain_loss(torch, cfg, leaves, batches[0], decisions)
    ref_loss["decided plain step"] = float(plain_loss.detach())
    grads["decided plain step"] = dict(
        zip(leaves, torch.autograd.grad(plain_loss, list(leaves.values()))))
    grad_err = {}
    for k in params0:
        check(bool(torch.isfinite(got[k]).all()), f"grad {k}: non-finite")
        grad_err[k] = {ref: {"max_abs_err": max_err(got[k], g[k]), "scale": scale(g[k])}
                       for ref, g in grads.items()}
    emit(phase="train", check="step-1 gradients", batch=BATCH, grad_tolerance=TOL,
         loss_tolerance=LOSS_TOL, loss=loss, reference_losses=ref_loss,
         dead_windows={k: int((v == 4).sum()) for k, v in decisions.items()
                       if k.startswith("conv")},
         step1_grads=grad_err)
    for ref, e in ref_loss.items():
        check(abs(loss - e) <= LOSS_TOL * max(1.0, abs(e)), f"step-1 loss vs {ref}: {loss} {e}")
    for k, e in grad_err.items():
        for ref, r in e.items():
            check(r["max_abs_err"] <= TOL * r["scale"], f"step-1 grad {k} vs {ref}: {r}")
    fused_step_grads(torch, cnn, cfg, tr, tcfgs["planned"], params0, kernels)
    losses = {}
    for name, tc in tcfgs.items():
        step, state = tr.make_train_step(cfg, tc), tr.init_state(cfg, tc, params0)
        losses[name] = []
        for b in batches:
            state, m = step(state, b)
            losses[name].append(float(m["loss"]))
    for a, b in zip(losses["planned"], losses["plain"]):
        check(math.isfinite(a) and abs(a - b) <= LOSS_TOL * max(1.0, abs(b)),
              f"losses {losses}")
    emit(phase="train", check="planned vs plain", batch=BATCH, steps=STEPS,
         loss_tolerance=LOSS_TOL, losses=losses,
         max_loss_diff=max(abs(a - b) for a, b in zip(losses["planned"], losses["plain"])))
    return tcfgs, params0, batches


def fused_step_grads(torch, cnn, cfg, tr, tcfg, params0, kernels) -> None:
    """The batch-128 step, where fc1 and fc2 take the fused dX/dW kernel:
    its step-1 loss and gradients against the same step with the fused
    kernel swapped for its plain version (every other kernel and the
    forward's decisions the same), at the phase-2 tolerance."""
    from repro_torch.data.pipeline import ShardInfo

    batch = tr.batch_to(cnn.data_source(cfg, FUSED_BATCH, ShardInfo(0, 1), seed=SEED)(0),
                        "cuda")
    fused = kernels["matmul_dx_dw"]
    before = fused.launches
    loss, got = planned_grads(torch, cfg, tr, tcfg, params0, batch, kernels, plain=())
    launched = fused.launches - before
    ref_loss, want = planned_grads(torch, cfg, tr, tcfg, params0, batch, kernels,
                                   plain=("matmul_dx_dw",))
    errs = {k: {"max_abs_err": max_err(got[k], want[k]), "scale": scale(want[k])} for k in got}
    emit(phase="train", check="step-1 gradients, fused dX/dW vs its plain version",
         batch=FUSED_BATCH, fused_launches=launched, grad_tolerance=TOL, loss=loss,
         reference_loss=ref_loss, step1_grads=errs)
    check(launched == 2, f"batch {FUSED_BATCH} step: {launched} fused launches, not 2")
    check(abs(loss - ref_loss) <= LOSS_TOL * max(1.0, abs(ref_loss)),
          f"batch {FUSED_BATCH} step-1 loss: {loss} {ref_loss}")
    for k, r in errs.items():
        check(bool(torch.isfinite(got[k]).all()), f"batch {FUSED_BATCH} grad {k}: non-finite")
        check(r["max_abs_err"] <= TOL * r["scale"], f"batch {FUSED_BATCH} grad {k}: {r}")


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32, nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_times(torch, plans, cnn, cfg, params, images, card, results, kernels, train):
    import torch.nn.functional as F

    from repro_torch.core import conv_layer as cl
    from repro_torch.kernels.conv2d.conv2d import conv2d_fused_plain, conv2d_kernel
    from repro_torch.kernels.matmul.matmul import matmul_kernel, matmul_plain
    from repro_torch.runtime import train as tr

    steps = {b: train_calls(cnn, cl, cfg, cnn.plan_training(cfg, b), b)
             for b in (BATCH, FUSED_BATCH)}

    def record(name, label, fn, plain_fn, lib_fn, flops, nbytes, template=None, pairs=None):
        ms, plain_ms = median_ms(fn), median_ms(plain_fn)
        lib_ms = median_ms(lib_fn) if lib_fn is not None else None
        b_ms, b_by = bound_ms(flops, nbytes)
        batch = FUSED_BATCH if name == "matmul_dx_dw" else BATCH
        call = dict(case=label, per_forward=main_path_launches(plans, name, label),
                    per_step=steps[batch].get((name, label), 0), step_batch=batch, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    bound_share=b_ms / ms, **(template or {}), flops=flops, bytes=nbytes,
                    peaks=PEAKS)
        if pairs:  # the yardsticks, and each one's device time beside the call's
            call["device_ms"] = device_time_ms(torch, fn)
            for key, f in pairs.items():
                call[key] = median_ms(f)
                call[key.replace("_ms", "_device_ms")] = device_time_ms(torch, f)
        if template and (call["per_forward"] or call["per_step"]):
            check(template["template"] == "register",
                  f"{name} {label}: a main-path call runs the {template['template']} kernel")
        if name == "conv2d_wgrad":  # what algorithm the yardstick runs
            call["library_kernels"] = library_kernels(torch, lib_fn)
        results[name]["calls"].append(call)
        emit(phase="times", kernel=name, card=card, **call)

    for label, (x, f, bias), kw in conv_cases(torch, plans, cnn, cfg):
        if label == "ragged":
            continue
        B, H_in, W_in, d_in = x.shape
        d_out, H_O = f.shape[3], kw["H_O"]
        x_nchw = x[:, 1:H_O + 1, 1:H_O + 1].permute(0, 3, 1, 2).contiguous()
        w_oihw = f.permute(3, 2, 0, 1).contiguous()
        flops = 2.0 * B * H_O * H_O * 9 * d_in * d_out
        out_elems = B * (H_O // 2) ** 2 * d_out
        nbytes = 4.0 * (x.numel() + f.numel() + bias.numel() + out_elems)
        record("conv2d", label, lambda: conv2d_kernel(x, f, bias, **kw),
               lambda: conv2d_fused_plain(x, f, bias, **kw),
               lambda: F.max_pool2d(F.relu(F.conv2d(x_nchw, w_oihw, bias, padding=1)), 2),
               flops, nbytes, template_record("conv2d", (x, f, bias), kw))
    for label, (a, w), kw in matmul_cases(torch, plans, cnn, cfg):
        if label == "ragged":
            continue
        m, k = a.shape
        n = w.shape[1]
        record("matmul", label, lambda: matmul_kernel(a, w, **kw),
               lambda: matmul_plain(a, w, **kw), lambda: torch.matmul(a, w),
               2.0 * m * n * k, 4.0 * (m * k + k * n + m * n),
               template_record("matmul", (a, w), kw))
    for name, label, args, kw, meta in bwd_cases(torch, cnn, cfg):
        if label.startswith("ragged"):
            continue
        k = kernels[name]
        record(name, label, lambda: k(*args, **kw), lambda: k.plain(*args, **kw),
               meta["lib"], meta["flops"], meta["nbytes"],
               template_record(name, args, kw)
               if name in ("conv2d", "matmul_tn", "matmul_dx_dw") else None,
               meta.get("pairs"))

    with torch.no_grad():
        fwd = {alg: median_ms(lambda: cnn.forward(cfg, params, images, schedules=plans[alg]),
                              reps=10)
               for alg in ("default", "direct", "im2col")}
        plain_fwd = median_ms(lambda: cnn.forward(cfg, params, images, use_kernels=False), reps=10)
    emit(phase="times", forward_ms=fwd, plain_forward_ms=plain_fwd,
         images_per_s={alg: BATCH / (t / 1e3) for alg, t in fwd.items()}, batch=BATCH,
         card=card)
    profile(torch, "forward", lambda: cnn.forward(cfg, params, images, schedules=plans["default"]),
            card, grad=False)

    tcfgs, params0, batches = train
    run = {name: functools.partial(tr.make_train_step(cfg, tc),
                                   tr.init_state(cfg, tc, params0), batches[0])
           for name, tc in tcfgs.items()}
    step_ms = {name: median_ms(fn, reps=10) for name, fn in run.items()}
    emit(phase="times", train_step_ms=step_ms,
         train_images_per_s={k: BATCH / (t / 1e3) for k, t in step_ms.items()},
         batch=BATCH, card=card)
    profile(torch, "train_step", run["planned"], card, grad=True)


def device_kernels(torch, prof, reps: int = 1):
    """[(ms per call, kernel name, launches per call)] of the device-side
    events of a profile, largest first.  Device events only (kernels,
    copies): the aten ops that launched them carry the same device time and
    would count it twice."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == DeviceType.CUDA:
            rows.append((dev_us / reps / 1e3, ev.key, ev.count // reps))
    return sorted(rows, reverse=True)


def device_time_ms(torch, fn, reps: int = 5) -> float:
    """Device time of one call of ``fn``: its kernels' time by torch.profiler
    over ``reps`` calls, without the host time before each launch that a
    CUDA-event median of a single call includes."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ms for ms, _, _ in device_kernels(torch, prof, reps))


def library_kernels(torch, fn, top: int = 3) -> list:
    """The device kernels one call of a library function runs (by
    torch.profiler), so a record can say which algorithm the yardstick
    picked."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [{"kernel": k[:120], "ms": ms, "calls": c}
            for ms, k, c in device_kernels(torch, prof)[:top]]


def profile(torch, what, fn, card, *, grad: bool, reps: int = 5, batch=BATCH):
    """Device time by kernel name over a few calls of ``fn`` (torch.profiler),
    and the device's busy share of that window."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch.set_grad_enabled(grad):
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = device_kernels(torch, prof, reps)
    device_ms = sum(r[0] for r in rows) if rows else "not measured"
    emit(phase="profile", what=what, card=card, batch=batch, wall_ms_per_call=wall_ms,
         device_ms_per_call=device_ms,
         device_busy_share=device_ms / wall_ms if rows else "not measured",
         top=[{"kernel": k[:80], "ms": ms, "calls": c} for ms, k, c in rows[:16]])
    return device_ms


# -- the transformer slice: flash attention and the qwen1.5-0.5b training step ------


def no_key_rows(torch, q_len, kv_len, causal, window):
    """[q_len] bool: the rows whose mask admits no key."""
    q = torch.arange(q_len, device="cuda")
    hi = torch.clamp(q, max=kv_len - 1) if causal else torch.full_like(q, kv_len - 1)
    lo = torch.clamp(q - window + 1, min=0) if window is not None else torch.zeros_like(q)
    return hi < lo


def visible_pairs(q_len: int, kv_len: int, window) -> int:
    """The (q, k) pairs a causal mask admits, with ``window`` if given."""
    reach = kv_len if window is None else window
    return sum(max(0, min(q, kv_len - 1) - max(0, q - reach + 1) + 1) for q in range(q_len))


def flash_cases(torch, s_attn):
    """(label, (q, k, v), kwargs, meta): the transformer's attention call with
    the planner's blocks, then GQA at D = 128, D = 32 and D = 256 (gemma3-4b's
    8/4 heads), a window, ragged lengths and a case with rows that see no
    key; blocks from AttentionPlanner.  Padding rows are zero, as the op
    pads them."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    B, S, H, D = TFM_BATCH, TFM_SEQ, 16, 64
    # label, B, Hq, Hkv, q_len, kv_len, D, window
    specs = [("main", B, H, H, S, S, D, None), ("gqa16/8-d128", B, 16, 8, S, S, 128, None),
             ("gqa16/8-d32", B, 16, 8, S, S, 32, None), ("gqa8/4-d256", B, 8, 4, S, S, 256, None),
             ("window512", B, H, H, S, S, D, 512), ("ragged1000", 1, 16, 16, 1000, 1000, D, None),
             ("zero-rows", 1, 16, 8, 1000, 500, D, 256)]
    return [flash_case(torch, g, spec, s_attn if spec[0] == "main" else None)
            for spec in specs]


def flash_case(torch, g, spec, s=None):
    """(label, (q, k, v), kwargs, meta) of one flash spec (label, B, Hq, Hkv,
    q_len, kv_len, D, window) at the blocks of ``s``, else AttentionPlanner's."""
    from repro_torch.plan import AttentionPlanner, round_up

    label, b, hq, hkv, ql, kl, d, window = spec
    s = s or AttentionPlanner().plan(
        seq_q=ql, seq_kv=kl, head_dim=d, n_q_heads=hq, n_kv_heads=hkv, batch=b,
        in_bytes=4, causal=True, window=window)
    bq, bkv = s.block("block_q"), s.block("block_kv")
    sq, skv = round_up(ql, bq), round_up(kl, bkv)
    q = torch.zeros(b * hq, sq, d, device="cuda")
    k = torch.zeros(b * hkv, skv, d, device="cuda")
    v = torch.zeros(b * hkv, skv, d, device="cuda")
    q[:, :ql] = torch.randn(b * hq, ql, d, device="cuda", generator=g)
    k[:, :kl] = torch.randn(b * hkv, kl, d, device="cuda", generator=g)
    v[:, :kl] = torch.randn(b * hkv, kl, d, device="cuda", generator=g)
    kw = dict(block_q=bq, block_kv=bkv, scale=d ** -0.5, causal=True, window=window,
              q_len=ql, kv_len=kl)
    # FLOP the call needs: QK^T and PV over the (q, k) pairs the causal
    # and window masks admit, each operand read once and the output
    # written once.
    flops = 4.0 * b * hq * visible_pairs(ql, kl, window) * d
    nbytes = 4.0 * d * (2 * b * hq * ql + 2 * b * hkv * kl)
    return label, (q, k, v), kw, dict(flops=flops, nbytes=nbytes, b=b, hq=hq, hkv=hkv)


def check_flash_case(torch, case, results, phase: str) -> None:
    """One flash case against the plain version (rows with no visible key
    must be 0 in both); prints its record."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel

    label, (q, k, v), kw, _ = case
    got = flash_attention_kernel(q, k, v, **kw)
    want = flash_attention_kernel.plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check(err <= TOL * scale(want), f"flash_attention {label}: err {err}")
    none = no_key_rows(torch, kw["q_len"], kw["kv_len"], kw["causal"], kw["window"])
    n_zero = int(none.sum()) * q.shape[0]
    if n_zero:
        rows = torch.nonzero(none)[:, 0]
        check(float(got[:, rows].abs().max()) == 0.0
              and float(want[:, rows].abs().max()) == 0.0,
              f"flash_attention {label}: rows with no visible key are not 0")
    results["flash_attention"]["max_abs_err"] = max(
        results["flash_attention"]["max_abs_err"], err)
    emit(phase=phase, kernel="flash_attention", case=label,
         shape=[list(t.shape) for t in (q, k, v)],
         blocks={"block_q": kw["block_q"], "block_kv": kw["block_kv"]},
         causal=kw["causal"], window=kw["window"], q_len=kw["q_len"],
         kv_len=kw["kv_len"], max_abs_err=err, max_abs_plain=float(want.abs().max()),
         rows_without_key=n_zero)


def phase_flash(torch, s_attn, results):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel

    for case in flash_cases(torch, s_attn):
        check_flash_case(torch, case, results, "flash")
        label, (q, k, v), kw, _ = case
        if label == "main":
            check_bit_identical(torch, "flash_attention", "attn",
                                lambda: flash_attention_kernel(q, k, v, **kw))


def tfm_calls(tf, cfg, plans, batch: int = TFM_BATCH, seq: int = TFM_SEQ) -> dict:
    """Launches of each kernel that one planned transformer training step
    of ``cfg`` at ``batch`` x ``seq`` makes, by call: {(kernel, label): count}."""
    L = cfg.n_layers
    n_chunks = batch * seq // tf._chunk_m(batch, seq, tfm_chunks())
    calls = {("flash_attention", "attn"): L}
    for cell in TFM_CELLS:
        n = n_chunks if cell == "logits" else L
        calls[("matmul", cell)] = n
        if plans[f"{cell}.dx"].algorithm == "fused_dxdw":
            calls[("matmul_dx_dw", f"{cell}.dxdw")] = n
        else:
            calls[("matmul_nt", f"{cell}.dx")] = n
            calls[("matmul_tn", f"{cell}.dw")] = n
    return calls


def plain_transformer_loss(torch, cfg, params, batch, *, remat: bool = False):
    """The independent plain step's loss: cuBLAS matmuls (TF32 off), RMSNorm
    and RoPE written out here, the port's attention_ref, chunked
    cross-entropy with F.cross_entropy; no kernel or layer of the port.
    It takes the dense configs' features: qkv biases or qk-norm, GQA
    (attention_ref repeats the KV heads), the tied or untied head, SiLU or
    tanh-GELU, the scaled embedding and one window for every layer.  With
    ``remat`` each layer runs under torch.utils.checkpoint, which keeps
    only its input and recomputes the same operations backward."""
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.flash_attention.ref import attention_ref

    check(not cfg.global_every, "the plain step takes one window for every layer")
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    B, S = tokens.shape
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    act = {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh")}[cfg.act]
    layer = {k[len("layers/"):]: v.unbind(0) for k, v in params.items()
             if k.startswith("layers/")}
    half = Dh // 2
    inv_freq = cfg.rope_theta ** (-torch.arange(half, device=tokens.device) / half)
    ang = torch.arange(S, device=tokens.device)[:, None] * inv_freq[None, :]
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]  # [S, 1, half]

    def norm(x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + cfg.norm_eps) * (1.0 + w)

    def rotate(x):  # [B, S, H, Dh]: the two halves turned by the position's angle
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def block(x, p):
        h = norm(x, p["ln1"])

        def proj(name, heads):
            y = torch.matmul(h, p[f"attn/w{name}"].reshape(d, heads * Dh)).reshape(
                B, S, heads, Dh)
            return y + p[f"attn/b{name}"] if cfg.qkv_bias else y

        q, k, v = proj("q", Hq), proj("k", Hkv), proj("v", Hkv)
        if cfg.qk_norm:
            q, k = norm(q, p["attn/q_norm"]), norm(k, p["attn/k_norm"])
        q, k = rotate(q), rotate(k)
        o = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                          window=cfg.local_window)
        x = x + torch.matmul(o.transpose(1, 2).reshape(B, S, Hq * Dh),
                             p["attn/wo"].reshape(Hq * Dh, d))
        h = norm(x, p["ln2"])
        return x + torch.matmul(act(h @ p["mlp/w_gate"]) * (h @ p["mlp/w_up"]),
                                p["mlp/w_down"])

    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * math.sqrt(d)
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in layer.items()}
        x = checkpoint(block, x, p, use_reentrant=False) if remat else block(x, p)
    x = norm(x, params["final_norm"]).reshape(B * S, d)
    head = params["embed"].t() if cfg.tie_embeddings else params["w_out"]
    total = 0.0
    for xc, lc in zip(x.chunk(tfm_chunks()), labels.reshape(-1).chunk(tfm_chunks())):
        total = total + F.cross_entropy(xc @ head, lc, reduction="sum")
    return total / labels.numel()


def step1(torch, loss_fn, params0, batch, swap=()):
    """Step-1 loss, gradients and peak device memory of ``loss_fn`` from
    ``params0``, with the kernels in ``swap`` running their plain versions
    (forward and backward, on the same CUDA tensors)."""
    saved = {k: k.launch for k in swap}
    for k in swap:
        k.launch = lambda kern, *a, **kw: kern.plain(*a, **kw)
    torch.cuda.reset_peak_memory_stats()
    try:
        leaves = {k: v.detach().requires_grad_(True) for k, v in params0.items()}
        loss = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        torch.cuda.synchronize()
    finally:
        for k, fn in saved.items():
            k.launch = fn
    return float(loss.detach()), grads, torch.cuda.max_memory_allocated()


def phase_transformer(torch, kernels, results):
    """The launcher at full width and depth (the slice's main path) with its
    launch counts, then planned-vs-plain parity from the same seeded state."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as tf
    from repro_torch.models.module import count_params, init_params
    from repro_torch.models.registry import make_data_source
    from repro_torch.runtime import train as tr

    cfg = get_config(TFM_ARCH)
    plans = tf.plan_training(cfg, TFM_BATCH, TFM_SEQ, loss_chunks=tfm_chunks())
    per_step = per_kernel(tfm_calls(tf, cfg, plans), kernels)
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    history = launch.main(["--arch", TFM_ARCH, "--batch", str(TFM_BATCH), "--seq",
                           str(TFM_SEQ), "--steps", str(STEPS), "--planned-kernels",
                           "--seed", str(SEED), "--log-every", "1"])
    torch.cuda.synchronize()
    launcher_peak = torch.cuda.max_memory_allocated()
    got = {name: k.launches for name, k in kernels.items()}
    want = {k: STEPS * n for k, n in per_step.items()}
    check(got == want, f"transformer: launches {got} != plan {want}")
    losses = [h["loss"] for h in history]
    check(all(math.isfinite(x) for x in losses), f"transformer: losses {losses}")
    for name in kernels:
        results[name]["launches_by_path"][TFM_PATH] = got[name]
    emit(phase="transformer", path=TFM_PATH, arch=TFM_ARCH,
         params=count_params(tf.param_defs(cfg)), n_layers=cfg.n_layers,
         d_model=cfg.d_model, batch=TFM_BATCH, seq=TFM_SEQ, steps=STEPS, launches=got,
         launches_per_step={k: n // STEPS for k, n in got.items()}, losses=losses,
         step_seconds=[h["seconds"] for h in history], peak_memory_bytes=launcher_peak,
         schedules={n: {"algorithm": s.algorithm, "blocks": s.block_dict(),
                        "grid": list(s.grid), "smem_bytes": s.vmem_bytes}
                    for n, s in plans.items()})

    kw = dict(param_dtype="float32", compute_dtype="float32", learning_rate=3e-4,
              warmup_steps=min(100, STEPS // 10 + 1), total_steps=STEPS,
              loss_chunks=tfm_chunks(), seed=SEED, remat="none")
    tcfgs = {"planned": TrainConfig(**kw, planned_kernels=True),
             "plain": TrainConfig(**kw, planned_kernels=False)}
    params0 = init_params(tf.param_defs(cfg), SEED)
    src = make_data_source(cfg, TFM_BATCH, TFM_SEQ, ShardInfo(0, 1), seed=SEED)
    batches = [tr.batch_to(src(i), "cuda") for i in range(STEPS)]
    planned_loss = tr.make_loss_fn(cfg, tcfgs["planned"])
    loss, got, peak = step1(torch, planned_loss, params0, batches[0])
    ref_loss, peaks, grad_err = {}, {"planned": peak}, {k: {} for k in got}
    refs = (("plain versions", planned_loss, tuple(kernels.values())),
            ("plain step", lambda p, b: plain_transformer_loss(torch, cfg, p, b), ()))
    for ref, fn, swap in refs:
        ref_loss[ref], grads, peaks[ref] = step1(torch, fn, params0, batches[0], swap)
        for k, g in grads.items():
            check(bool(torch.isfinite(got[k]).all()), f"grad {k}: non-finite")
            grad_err[k][ref] = {"max_abs_err": max_err(got[k], g), "scale": scale(g)}
        del grads
        torch.cuda.empty_cache()
    del got
    torch.cuda.empty_cache()
    emit(phase="transformer", check="step-1 gradients", grad_tolerance=TOL,
         loss_tolerance=LOSS_TOL, loss=loss, reference_losses=ref_loss,
         peak_memory_bytes=peaks, tf32=torch.backends.cuda.matmul.allow_tf32,
         step1_grads=grad_err)
    for ref, e in ref_loss.items():
        check(abs(loss - e) <= LOSS_TOL * max(1.0, abs(e)), f"step-1 loss vs {ref}: {loss} {e}")
    for k, e in grad_err.items():
        for ref, r in e.items():
            check(r["max_abs_err"] <= TOL * r["scale"], f"step-1 grad {k} vs {ref}: {r}")
    step, state = tr.make_train_step(cfg, tcfgs["plain"]), tr.init_state(
        cfg, tcfgs["plain"], params0)
    plain = []
    for b in batches:
        state, m = step(state, b)
        plain.append(float(m["loss"]))
    del state
    torch.cuda.empty_cache()
    for a, b in zip(losses, plain):
        check(math.isfinite(b) and abs(a - b) <= LOSS_TOL * max(1.0, abs(b)),
              f"transformer losses: launcher {losses} plain {plain}")
    emit(phase="transformer", check="planned vs plain", steps=STEPS, loss_tolerance=LOSS_TOL,
         losses={"planned (launcher)": losses, "plain": plain},
         max_loss_diff=max(abs(a - b) for a, b in zip(losses, plain)))
    return cfg, tcfgs, params0, batches, plans


def phase_times_transformer(torch, card, results, kernels, tfm):
    """The flash kernel and the step's GEMMs per call, beside their plain
    versions, one library call and the bound; the training step's ms and
    tokens/s, planned and plain; a profiled planned step."""
    import torch.nn.functional as F

    from repro_torch.models import transformer as tf
    from repro_torch.plan import pad_dim, round_up
    from repro_torch.runtime import train as tr

    cfg, tcfgs, params0, batches, plans = tfm

    def padded(t, *sizes):
        for axis, size in enumerate(sizes):
            t = pad_dim(t, axis, size)
        return t.contiguous()
    calls = tfm_calls(tf, cfg, plans)
    step_batch = f"{TFM_BATCH}x{TFM_SEQ}"

    def record(name, label, fn, plain_fn, lib_fn, flops, nbytes, reps=10, template=None):
        # Each call is first held against its plain version on the same
        # operands: these are the step's own shapes, not the cnn's.
        outs, refs = fn(), plain_fn()
        torch.cuda.synchronize()
        pairs = list(zip(outs, refs)) if isinstance(outs, tuple) else [(outs, refs)]
        err = max(max_err(o, r) for o, r in pairs)
        tol = TOL * max(scale(r) for _, r in pairs)
        check(err <= tol, f"{name} {label} at {step_batch}: err {err} > {tol}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        del outs, refs, pairs
        ms, plain_ms = median_ms(fn, reps=reps), median_ms(plain_fn, reps=reps)
        lib_ms = median_ms(lib_fn, reps=reps) if lib_fn is not None else None
        b_ms, b_by = bound_ms(flops, nbytes)
        call = dict(case=label, per_step=calls.get((name, label), 0), step_batch=step_batch,
                    max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    bound_share=b_ms / ms, **(template or {}), flops=flops, bytes=nbytes,
                    peaks=PEAKS)
        if template and call["per_step"]:
            check(template["template"] == "register",
                  f"{name} {label}: a main-path call runs the {template['template']} kernel")
        results[name]["tfm_calls"].append(call)
        emit(phase="times", kernel=name, card=card, **call)

    fk = kernels["flash_attention"]
    for label, (q, k, v), kw, meta in flash_cases(torch, plans["attn"]):
        if label not in ("main", "window512", "gqa16/8-d128", "gqa16/8-d32", "gqa8/4-d256"):
            continue
        b, hq, hkv = meta["b"], meta["hq"], meta["hkv"]
        q4 = q.reshape(b, hq, *q.shape[1:])
        k4 = k.reshape(b, hkv, *k.shape[1:]).repeat_interleave(hq // hkv, 1)
        v4 = v.reshape(b, hkv, *v.shape[1:]).repeat_interleave(hq // hkv, 1)
        lib = None
        if kw["window"] is None:
            lib = lambda q4=q4, k4=k4, v4=v4: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True)
        record("flash_attention", "attn" if label == "main" else label,
               lambda q=q, k=k, v=v, kw=kw: fk(q, k, v, **kw),
               lambda q=q, k=k, v=v, kw=kw: fk.plain(q, k, v, **kw), lib,
               meta["flops"], meta["nbytes"])
        del q4, k4, v4

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    M = TFM_BATCH * TFM_SEQ
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    shapes = {"qkv": (M, d, (Hq + 2 * Hkv) * Dh), "wo": (M, Hq * Dh, d),
              "mlp_up": (M, d, 2 * ff), "mlp_down": (M, ff, d),
              "logits": (tf._chunk_m(TFM_BATCH, TFM_SEQ, tfm_chunks()), d, vocab)}
    for cell, (m, k, n) in shapes.items():
        x = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g) * k ** -0.5
        dy = torch.randn(m, n, device="cuda", generator=g)
        flops, nbytes = 2.0 * m * n * k, 4.0 * (m * k + k * n + m * n)
        s_dx = plans[f"{cell}.dx"]
        runs = [("matmul", cell, plans[cell], lambda: torch.matmul(x, w))]
        if s_dx.algorithm == "fused_dxdw":
            runs.append(("matmul_dx_dw", f"{cell}.dxdw", s_dx, None))
        else:
            runs += [("matmul_nt", f"{cell}.dx", s_dx, lambda: torch.matmul(dy, w.t())),
                     ("matmul_tn", f"{cell}.dw", plans[f"{cell}.dw"],
                      lambda: torch.matmul(x.t(), dy))]
        for name, label, sched, lib in runs:
            b = {key: sched.block(key) for key in ("block_m", "block_n", "block_k")}
            mp, np_, kp = (round_up(m, b["block_m"]), round_up(n, b["block_n"]),
                           round_up(k, b["block_k"]))
            xp, wp, gp = padded(x, mp, kp), padded(w, kp, np_), padded(dy, mp, np_)
            args = {"matmul": (xp, wp), "matmul_nt": (gp, wp), "matmul_tn": (xp, gp),
                    "matmul_dx_dw": (gp, wp, xp)}[name]
            kern = kernels[name]
            if (name, label) in DETERMINISM:
                check_bit_identical(torch, name, label,
                                    lambda kern=kern, args=args, b=b: kern(*args, **b), card)
            record(name, label, lambda kern=kern, args=args, b=b: kern(*args, **b),
                   lambda kern=kern, args=args, b=b: kern.plain(*args, **b), lib,
                   2 * flops if name == "matmul_dx_dw" else flops, nbytes,
                   reps=3 if cell == "logits" else 5,
                   template=(template_record(name, args, b)
                             if name in ("matmul", "matmul_tn", "matmul_dx_dw") else None))
            del xp, wp, gp, args
        del x, w, dy, runs
        torch.cuda.empty_cache()

    run = {name: functools.partial(tr.make_train_step(cfg, tc),
                                   tr.init_state(cfg, tc, params0), batches[0])
           for name, tc in tcfgs.items()}
    step_ms = {name: median_ms(fn, reps=3, warmup=1) for name, fn in run.items()}
    tokens = TFM_BATCH * TFM_SEQ
    emit(phase="times", arch=TFM_ARCH, train_step_ms=step_ms,
         train_tokens_per_s={k: tokens / (t / 1e3) for k, t in step_ms.items()},
         batch=TFM_BATCH, seq=TFM_SEQ, card=card)
    profile(torch, "transformer_train_step", run["planned"], card, grad=True, reps=2,
            batch=step_batch)


# -- the eighth slice: accumulation, int8 error feedback, checkpoints, remat, autotune -


def launcher_tcfg(steps: int, **knobs):
    """The TrainConfig ``launch.train`` builds for ``--steps steps`` (the
    learning-rate schedule spans the run)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.train import LOSS_CHUNKS

    return TrainConfig(param_dtype="float32", compute_dtype="float32", learning_rate=3e-4,
                       warmup_steps=min(100, steps // 10 + 1), total_steps=steps,
                       loss_chunks=LOSS_CHUNKS, seed=SEED, **knobs)


def accumulated_grads(torch, cfg, tr, tcfg, params0, acc, kernels, plain):
    """The reference for an accumulated step: each micro-batch's forward on
    the kernels and its backward with the kernels in ``plain`` on their
    plain versions (``planned_grads``), summed in f32 from zeros in order
    and divided by the count."""
    n = acc["images"].shape[0]
    gsum = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params0.items()}
    total = 0.0
    for i in range(n):
        loss, g = planned_grads(torch, cfg, tr, tcfg, params0, {k: v[i] for k, v in acc.items()},
                                kernels, plain=plain)
        gsum = {k: gsum[k] + g[k].float() for k in gsum}
        total += loss
    return total / n, {k: g / n for k, g in gsum.items()}


def phase_accum(torch, cnn, cfg, kernels, results, card):
    """Gradient accumulation over a leading dim: cnn-vgg11 at batch 256 as
    [2, 128, 32, 32, 3], the planned kernels.  The launcher passes
    --microbatch on and never splits a batch (as the JAX launcher), so the
    script builds the accumulated batch itself."""
    from repro_torch.core import conv_layer as cl
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.models.module import init_params
    from repro_torch.runtime import train as tr

    n, micro = ACCUM
    tcfg = launcher_tcfg(STEPS, planned_kernels=True)
    params0 = init_params(cnn.param_defs(cfg), SEED)
    src = cnn.data_source(cfg, BATCH, ShardInfo(0, 1), seed=SEED)
    full = [tr.batch_to(src(i), "cuda") for i in range(STEPS)]
    acc = [{k: v.reshape(n, micro, *v.shape[1:]) for k, v in b.items()} for b in full]
    micro_calls = train_calls(cnn, cl, cfg, cnn.plan_training(cfg, micro), micro)
    per_step = {k: n * c for k, c in per_kernel(micro_calls, kernels).items()}
    check(per_step["matmul_dx_dw"] == 4, f"accum: {per_step['matmul_dx_dw']} fused launches a "
          "step in the plan, not 4")
    step, state0 = tr.make_train_step(cfg, tcfg), tr.init_state(cfg, tcfg, params0)
    zero_counts(kernels)
    state, losses = state0, []
    for b in acc:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    got = {name: k.launches for name, k in kernels.items()}
    want = {k: STEPS * c for k, c in per_step.items()}
    check(got == want, f"accum: launches {got} != 2 x plan_training({micro}) x {STEPS} {want}")
    check(all(math.isfinite(x) for x in losses), f"accum: losses {losses}")
    for name in kernels:
        results[name]["launches_by_path"][f"accum_b{n}x{micro}"] = got[name]
    templates = {label: template_record("matmul_dx_dw", *fused_args(torch, cnn, cfg, micro,
                                                                    label))
                 for label in ("fc1", "fc2")}
    check(all(t["template"] == "register" for t in templates.values()),
          f"accum: a fused call runs the simple kernel: {templates}")
    loss_fn = tr.make_loss_fn(cfg, tcfg)
    loss, grads = tr.loss_and_grads(loss_fn, params0, acc[0])
    loss = float(loss)
    ref_loss, ref = accumulated_grads(torch, cfg, tr, tcfg, params0, acc[0], kernels,
                                      BWD_KERNELS)
    errs = {k: {"max_abs_err": max_err(grads[k], ref[k]), "scale": scale(ref[k])} for k in ref}
    loss256, g256 = tr.loss_and_grads(loss_fn, params0, full[0])
    rel256 = {k: max_err(grads[k], g256[k]) / scale(g256[k]) for k in g256}
    step_ms = {f"{n}x{micro}": median_ms(lambda: step(state0, acc[0]), reps=10),
               f"{BATCH}": median_ms(lambda: step(state0, full[0]), reps=10)}
    emit(phase="accum", arch=cfg.name, batch=[n, micro], steps=STEPS, launches=got,
         launches_per_step=per_step, fused_templates=templates, losses=losses,
         grad_tolerance=TOL, loss=loss, reference_loss=ref_loss, step1_grads=errs,
         loss_unaccumulated=float(loss256), max_rel_diff_unaccumulated=max(rel256.values()),
         rel_diff_unaccumulated=rel256, step_ms=step_ms, card=card)
    check(abs(loss - ref_loss) <= LOSS_TOL * max(1.0, abs(ref_loss)),
          f"accum step-1 loss: {loss} vs {ref_loss}")
    for k, r in errs.items():
        check(bool(torch.isfinite(grads[k]).all()), f"accum grad {k}: non-finite")
        check(r["max_abs_err"] <= TOL * r["scale"], f"accum grad {k}: {r}")


def fused_args(torch, cnn, cfg, batch, stage):
    """(args, blocks) of the fused dX/dW launch a stage's plan makes at
    ``batch``, on meta tensors (the template reads shapes only)."""
    from repro_torch.plan import round_up

    s = cnn.plan_training(cfg, batch)[f"{stage}.dx"]
    (m, k), (_, n) = next((x, w) for nm, x, w in cnn._stage_geometry(cfg, batch) if nm == stage)
    b = {key: s.block(key) for key in ("block_m", "block_n", "block_k")}
    mp, np_, kp = (round_up(m, b["block_m"]), round_up(n, b["block_n"]),
                   round_up(k, b["block_k"]))

    def meta(*shape):
        return torch.empty(shape, device="meta")
    return (meta(mp, np_), meta(kp, np_), meta(mp, kp)), b


def phase_int8_ef(torch, cnn, cfg, kernels, results):
    """3 AdamW steps of cnn-vgg11 at batch 256 with error-feedback int8
    gradient compression, planned against plain (the same compression)."""
    from repro_torch.core import conv_layer as cl
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.models.module import init_params
    from repro_torch.runtime import train as tr

    params0 = init_params(cnn.param_defs(cfg), SEED)
    src = cnn.data_source(cfg, BATCH, ShardInfo(0, 1), seed=SEED)
    batches = [tr.batch_to(src(i), "cuda") for i in range(STEPS)]
    per_step = per_kernel(train_calls(cnn, cl, cfg, cnn.plan_training(cfg, BATCH), BATCH),
                          kernels)
    losses, nonzero, states = {}, {}, {}
    for name in ("planned", "plain"):
        tcfg = launcher_tcfg(STEPS, planned_kernels=name == "planned",
                             grad_compression="int8_ef")
        step, state = tr.make_train_step(cfg, tcfg), tr.init_state(cfg, tcfg, params0)
        zero_counts(kernels)
        losses[name] = []
        for i, b in enumerate(batches):
            state, m = step(state, b)
            losses[name].append(float(m["loss"]))
            if i == 0:
                nonzero[name] = {k: int((e != 0).sum()) for k, e in state.err.items()}
        torch.cuda.synchronize()
        if name == "planned":
            got = {k: kk.launches for k, kk in kernels.items()}
            want = {k: STEPS * c for k, c in per_step.items()}
            check(got == want, f"int8_ef: launches {got} != plan {want}")
            for k in kernels:
                results[k]["launches_by_path"][f"int8_ef_b{BATCH}"] = got[k]
        states[name] = state
    emit(phase="int8_ef", arch=cfg.name, batch=BATCH, steps=STEPS, loss_tolerance=LOSS_TOL,
         losses=losses,
         max_loss_diff=max(abs(a - b) for a, b in zip(losses["planned"], losses["plain"])),
         error_buffer_nonzero_after_step1=nonzero["planned"],
         error_buffer_norm={k: float(e.norm()) for k, e in states["planned"].err.items()})
    for a, b in zip(losses["planned"], losses["plain"]):
        check(math.isfinite(a) and abs(a - b) <= LOSS_TOL * max(1.0, abs(b)),
              f"int8_ef losses {losses}")
    for k, c in nonzero["planned"].items():
        check(c > 0, f"int8_ef: error buffer {k} is zero after step 1")
    return states["planned"]


class Killed(Exception):
    """The launcher stopped between two steps, as a killed process stops."""


@contextlib.contextmanager
def killed_at(launch, step: int):
    """Make ``launch.main`` stop before ``step``: its data source raises."""
    real = launch.make_data_source

    def source(*args, **kwargs):
        src = real(*args, **kwargs)

        def at(i):
            if i == step:
                raise Killed(step)
            return src(i)
        return at

    launch.make_data_source = source
    try:
        yield
    finally:
        launch.make_data_source = real


def tear_chunk(step_dir: Path, name: str) -> Path:
    """Tear one chunk as a host dying mid-flush would: cut it to half its
    length and scribble on the tail."""
    victim = step_dir / name
    size = victim.stat().st_size
    with open(victim, "r+b") as f:
        f.truncate(size // 2)
        f.seek(size // 2 - 8)
        f.write(b"\xde\xad\xbe\xef" * 2)
    return victim


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir())


def same_state(torch, a, b) -> bool:
    """Bit for bit: every parameter, both moments, the error buffers and
    the step."""
    trees = [(a.params, b.params), (a.opt.m, b.opt.m), (a.opt.v, b.opt.v)]
    if a.err is not None or b.err is not None:
        trees.append((a.err, b.err))
    return a.opt.step == b.opt.step and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x) for x, y in trees)


def phase_ckpt(torch, cnn, cfg, kernels, results, ef_state, card):
    """Checkpoints through the launcher: run A trains 4 steps in one go;
    run B is stopped before step 2 (after its step-1 checkpoint) and run
    again, which resumes.  B's final state must equal A's bit for bit; a
    torn chunk must fail verification and roll restore back a step."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import conv_layer as cl
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.launch import train as launch
    from repro_torch.models.module import init_params
    from repro_torch.runtime import train as tr

    base = SCRATCH / "ckpt"
    shutil.rmtree(base, ignore_errors=True)
    dir_a, dir_b = base / "A", base / "B"
    argv = ["--arch", cfg.name, "--batch", str(BATCH), "--steps", str(CKPT_STEPS),
            "--planned-kernels", "--seed", str(SEED), "--log-every", "1"]
    per_step = per_kernel(train_calls(cnn, cl, cfg, cnn.plan_training(cfg, BATCH), BATCH),
                          kernels)
    zero_counts(kernels)
    hist_a = launch.main(argv + ["--ckpt", str(dir_a)])
    with killed_at(launch, CKPT_KILL):
        try:
            launch.main(argv + ["--ckpt", str(dir_b), "--ckpt-every", "1"])
            check(False, "ckpt: run B was not stopped")
        except Killed:
            pass
    check(ckpt.committed_steps(str(dir_b)) == [CKPT_KILL - 1],
          f"ckpt: run B committed {ckpt.committed_steps(str(dir_b))} before it stopped")
    hist_b = launch.main(argv + ["--ckpt", str(dir_b), "--ckpt-every", "1"])
    torch.cuda.synchronize()
    got = {k: kk.launches for k, kk in kernels.items()}
    want = {k: 2 * CKPT_STEPS * c for k, c in per_step.items()}
    check(got == want, f"ckpt: launches {got} != plan {want}")
    for k in kernels:
        results[k]["launches_by_path"][f"ckpt_b{BATCH}"] = got[k]
    check([h["step"] for h in hist_b] == list(range(CKPT_KILL, CKPT_STEPS)),
          f"ckpt: the resumed run ran steps {[h['step'] for h in hist_b]}")
    check([h["loss"] for h in hist_b] == [h["loss"] for h in hist_a[CKPT_KILL:]],
          f"ckpt: losses after the resume {hist_b} differ from run A's {hist_a}")

    tcfg = launcher_tcfg(CKPT_STEPS, planned_kernels=True)
    template = tr.init_state(cfg, tcfg, init_params(cnn.param_defs(cfg), SEED))
    final = CKPT_STEPS - 1
    t0 = time.perf_counter()
    state_a = ckpt.restore(str(dir_a), final, template, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state_b = ckpt.restore(str(dir_b), final, template, device="cuda")
    # An independent run of the same steps in this process, no checkpoint.
    step = tr.make_train_step(cfg, tcfg)
    src = cnn.data_source(cfg, BATCH, ShardInfo(0, 1), seed=SEED)
    state = template
    for i in range(CKPT_STEPS):
        state, _ = step(state, tr.batch_to(src(i), "cuda"))
    resumed_equal, direct_equal = same_state(torch, state_b, state_a), same_state(
        torch, state_a, state)

    step_dir = dir_b / f"step_{final:07d}"
    victim = tear_chunk(step_dir, "params_conv0.c00.npy")
    try:
        ckpt.verify_step(str(dir_b), final)
        torn_raises = False
    except ckpt.CheckpointCorruptError:
        torn_raises = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rolled, rolled_step = ckpt.restore_latest(str(dir_b), template, device="cuda")
    t0 = time.perf_counter()
    ckpt.save(str(base / "timing"), final, state_a)
    save_s = time.perf_counter() - t0
    ef_dir = Path(ckpt.save(str(base / "int8_ef"), 0, ef_state))
    emit(phase="ckpt", arch=cfg.name, batch=BATCH, steps=CKPT_STEPS, stopped_before=CKPT_KILL,
         launches=got, losses_a=[h["loss"] for h in hist_a],
         losses_b_resumed=[h["loss"] for h in hist_b],
         resumed_equals_uninterrupted=resumed_equal, uninterrupted_equals_in_process=direct_equal,
         torn_chunk=victim.name, torn_verify_raises=torn_raises,
         torn_restore_latest_step=rolled_step,
         torn_warnings=[str(w.message)[:160] for w in caught],
         bytes_per_step=dir_bytes(dir_a / f"step_{final:07d}"),
         bytes_per_step_int8_ef=dir_bytes(ef_dir), save_seconds=save_s,
         restore_seconds=restore_s, card=card)
    check(resumed_equal, "ckpt: the resumed run's final state differs from run A's")
    check(direct_equal, "ckpt: run A's final checkpoint differs from the same steps in process")
    check(torn_raises, "ckpt: verify_step passed a torn chunk")
    check(rolled_step == final - 1 and rolled.opt.step == final,
          f"ckpt: restore_latest after the tear gave step {rolled_step}")
    shutil.rmtree(base, ignore_errors=True)


def remat_extra(remat: str, cfg) -> dict:
    """Launches a step that ``remat`` adds to the planned qwen step: block
    runs each layer's four GEMMs and its flash call again in the backward
    pass, dots its flash call (the segments between GEMMs recompute)."""
    L = cfg.n_layers
    return {"none": {}, "block": {"matmul": 4 * L, "flash_attention": L},
            "dots": {"flash_attention": L}}[remat]


def phase_remat(torch, kernels, results, tfm, card):
    """qwen1.5-0.5b at full width and depth, 4 x 2048, through the launcher
    with --remat none, block and dots: launches a step, peak memory and
    step ms of each; then the step-1 gradients of block and dots against
    none's, bit for bit."""
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import train as tr

    cfg, _, params0, batches, plans = tfm
    base = per_kernel(tfm_calls(tf, cfg, plans), kernels)
    runs = {}
    for remat in REMATS:
        per_step = {k: n + remat_extra(remat, cfg).get(k, 0) for k, n in base.items()}
        zero_counts(kernels)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        history = launch.main(["--arch", TFM_ARCH, "--batch", str(TFM_BATCH), "--seq",
                               str(TFM_SEQ), "--steps", str(STEPS), "--planned-kernels",
                               "--seed", str(SEED), "--log-every", "1", "--remat", remat])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        got = {k: kk.launches for k, kk in kernels.items()}
        want = {k: STEPS * n for k, n in per_step.items()}
        check(got == want, f"remat {remat}: launches {got} != plan {want}")
        for k in kernels:
            results[k]["launches_by_path"][f"remat_{remat}"] = got[k]
        ms = [h["seconds"] * 1e3 for h in history]
        runs[remat] = dict(launches_per_step=per_step, peak_memory_bytes=peak,
                           step_ms=ms, step_ms_after_first=statistics.median(ms[1:]),
                           losses=[h["loss"] for h in history])
    grads = {}
    same = {}
    for remat in REMATS:
        tcfg = launcher_tcfg(STEPS, planned_kernels=True, remat=remat)
        loss, g, peak = step1(torch, tr.make_loss_fn(cfg, tcfg), params0, batches[0])
        runs[remat].update(step1_loss=loss, step1_peak_memory_bytes=peak)
        if remat == "none":
            grads = {k: v.cpu() for k, v in g.items()}
        else:
            same[remat] = (loss == runs["none"]["step1_loss"]
                           and all(torch.equal(g[k].cpu(), grads[k]) for k in grads))
        del g
        torch.cuda.empty_cache()
    emit(phase="remat", arch=TFM_ARCH, batch=TFM_BATCH, seq=TFM_SEQ, steps=STEPS, runs=runs,
         step1_grads_bit_identical_to_none=same, card=card)
    peaks = {r: runs[r]["peak_memory_bytes"] for r in REMATS}
    check(all(same.values()), f"remat: step-1 gradients differ from none's: {same}")
    check(peaks["none"] >= peaks["dots"] >= peaks["block"], f"remat: peaks {peaks}")
    check(peaks["block"] < REMAT_PEAK_CUT * peaks["none"], f"remat: block saves little {peaks}")


def cell_template(op: str, s, shape: dict) -> str:
    """The kernel template one cell's schedule launches (as the wrappers
    choose it)."""
    from repro_torch.kernels.conv2d.conv2d import register_layout
    from repro_torch.kernels.matmul.bwd import dxdw_template, tn_template
    from repro_torch.kernels.matmul.matmul import template

    b = s.block_dict()
    if s.algorithm == "im2col":
        return "im2col/" + template(b["block_m"], b["block_n"], b["block_k"])
    if op in ("conv2d", "conv2d_dgrad"):
        W_O = shape["W_I"] if op == "conv2d_dgrad" else shape["W_O"]
        H = shape["H_I"] if op == "conv2d_dgrad" else shape["H_O"]
        S = 1 if op == "conv2d_dgrad" else shape.get("S", 1)
        layout = register_layout(block_h=max(1, min(b["block_h"], H)), block_do=b["block_do"],
                                 block_di=b["block_di"], W_O=W_O, F=shape["F"], S=S)
        return "register" if layout else "simple"
    if op == "conv2d_wgrad":  # the C entry point's own test
        reg = (shape["F"] == 3 and b["block_di"] % 4 == 0
               and b["block_di"] * -(-b["block_do"] // 8) <= 256)
        return "register" if reg else "simple"
    mnk = (b["block_m"], b["block_n"], b["block_k"])
    if op == "matmul":
        return template(*mnk)
    if op == "matmul_dw":
        return tn_template(*mnk)
    if s.algorithm == "fused_dxdw":
        return "fused/" + dxdw_template(*mnk, shape["m"])
    return "register" if mnk == (64, 32, 128) else "simple"  # NT's register tile


def launched_blocks(cnn, cfg, plans, batch) -> set:
    """(kernel, blocks) of every launch a planned step makes under
    ``plans``, as the wrappers pass the blocks on."""
    def mnk(s):
        return (s.block("block_m"), s.block("block_n"), s.block("block_k"))

    def hdi(s, extent):
        return (max(1, min(s.block("block_h"), extent)), s.block("block_do"),
                s.block("block_di"))

    out = set()
    for i, (name, x_shape, _) in enumerate(cnn._stage_geometry(cfg, batch)):
        s = plans[name]
        if name.startswith("conv"):
            H = x_shape[1]
            out.add(("matmul", mnk(s)) if s.algorithm == "im2col" else ("conv2d", hdi(s, H)))
            if i > 0:
                out.add(("conv2d", hdi(plans[f"{name}.dgrad"], H)))
            out.add(("conv2d_wgrad", hdi(plans[f"{name}.wgrad"], H)))
            continue
        out.add(("matmul", mnk(s)))
        dx = plans[f"{name}.dx"]
        if dx.algorithm == "fused_dxdw":
            out.add(("matmul_dx_dw", mnk(dx)))
        else:
            out |= {("matmul_nt", mnk(dx)), ("matmul_tn", mnk(plans[f"{name}.dw"]))}
    return out


@contextlib.contextmanager
def on_launch(kernels, record):
    """Call ``record(kernel, args, kwargs, output)`` after every launch
    while the block runs."""
    saved = {name: k.launch for name, k in kernels.items()}

    def wrap(name, fn):
        def spy(kern, *args, **kw):
            out = fn(kern, *args, **kw)
            record(name, args, kw, out)
            return out
        return spy

    for name, k in kernels.items():
        k.launch = wrap(name, saved[name])
    try:
        yield
    finally:
        for name, fn in saved.items():
            kernels[name].launch = fn


def spy_blocks(kernels, seen: set):
    """Record (kernel, blocks) of every launch while the block runs."""
    def record(name, args, kw, out):
        keys = (("block_h", "block_do", "block_di") if "block_do" in kw
                else ("block_m", "block_n", "block_k"))
        seen.add((name, tuple(kw[b] for b in keys)))
    return on_launch(kernels, record)


def phase_autotune(torch, cnn, cfg, kernels, results, card):
    """Measured-time autotune over every cell of cnn-vgg11's
    plan_training(256), forward and backward (policy tune, the top
    AUTOTUNE_TOPK candidates a cell), beside each cell's modeled argmin;
    then one planned step under cache-only with the stopwatch replaced by
    one that raises: its launch counts, the blocks each kernel received
    and its loss against the policy-off step."""
    from repro_torch.core import conv_layer as cl
    from repro_torch.core.machine import H100
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.models.module import init_params
    from repro_torch.plan import autotune as at
    from repro_torch.plan import planner_for
    from repro_torch.runtime import train as tr

    path = SCRATCH / "autotune_h100.json"
    path.unlink(missing_ok=True)
    at.set_policy("tune", str(path), device="cuda")
    try:
        zero_counts(kernels)
        t0 = time.perf_counter()
        tuned = cnn.plan_training(cfg, BATCH)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        tune_launches = {k: kk.launches for k, kk in kernels.items()}
        cells = []
        for rec in at.get_cache().load().values():
            key = json.loads(rec["key"])
            op, shape = key[1], dict(key[2])
            planner = planner_for(op, H100)
            argmin = planner.plan(**shape)
            winner = at.lookup(op, shape)
            timed = {label: us for label, us, _ in rec["measured"]}
            a_ms = timed.get(at._label(argmin))
            cells.append(dict(
                op=op, shape=shape, candidates=len(planner.candidates(**shape)),
                timed=len(timed),
                argmin={"algorithm": argmin.algorithm, "blocks": argmin.block_dict(),
                        "template": cell_template(op, argmin, shape),
                        "ms": a_ms / 1e3 if a_ms is not None else "not measured"},
                winner={"algorithm": winner.algorithm, "blocks": winner.block_dict(),
                        "template": cell_template(op, winner, shape), "ms": rec["us"] / 1e3},
                winner_is_argmin=(winner.algorithm, winner.blocks) == (argmin.algorithm,
                                                                       argmin.blocks)))
        emit(phase="autotune", policy="tune", arch=cfg.name, batch=BATCH, topk=AUTOTUNE_TOPK,
             seconds=tune_s, cells_tuned=len(cells), launches_while_tuning=tune_launches,
             cells=cells, card=card)

        tcfg = launcher_tcfg(1, planned_kernels=True)
        params0 = init_params(cnn.param_defs(cfg), SEED)
        batch = tr.batch_to(cnn.data_source(cfg, BATCH, ShardInfo(0, 1), seed=SEED)(0), "cuda")
        at.set_policy("off")
        _, m_off = tr.make_train_step(cfg, tcfg)(tr.init_state(cfg, tcfg, params0), batch)
        loss_off = float(m_off["loss"])

        def stopwatch(*args, **kwargs):
            raise AssertionError("the cache-only policy timed a candidate")

        measure, at._measure = at._measure, stopwatch
        at.set_policy("cache-only")
        try:
            seen: set = set()
            zero_counts(kernels)
            with spy_blocks(kernels, seen):
                _, m = tr.make_train_step(cfg, tcfg)(tr.init_state(cfg, tcfg, params0), batch)
                loss = float(m["loss"])
            got = {k: kk.launches for k, kk in kernels.items()}
        finally:
            at._measure = measure
        want = per_kernel(train_calls(cnn, cl, cfg, tuned, BATCH), kernels)
        expected = launched_blocks(cnn, cfg, tuned, BATCH)
        for k in kernels:
            results[k]["launches_by_path"]["autotune_tune"] = tune_launches[k]
            results[k]["launches_by_path"][f"autotune_cache_only_b{BATCH}"] = got[k]
        emit(phase="autotune", policy="cache-only", launches=got, launches_planned=want,
             loss=loss, loss_policy_off=loss_off, loss_tolerance=LOSS_TOL,
             winners_received=sorted(map(list, expected & seen)),
             winners_missing=sorted(map(list, expected - seen)),
             other_launches=sorted(map(list, seen - expected)))
        check(got == want, f"autotune cache-only: launches {got} != plan {want}")
        check(expected <= seen, f"autotune: winners not launched {sorted(expected - seen)}")
        check(abs(loss - loss_off) <= LOSS_TOL * max(1.0, abs(loss_off)),
              f"autotune: cache-only loss {loss} vs off {loss_off}")
    finally:
        at.set_policy("off")


# -- the ninth slice: serving qwen1.5-0.5b through the continuous-batching engine ---


def serve_params(torch, cfg, params0):
    """The served weights: the seed's plus seeded numpy noise, its std
    SERVE_PERTURB times each weight matrix's init std (the embedding
    kept) and SERVE_PERTURB_ZEROS on the zero-init leaves."""
    import numpy as np

    from repro_torch.models import transformer as tf

    defs = tf.param_defs(cfg)
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for k, v in sorted(params0.items()):
        d = defs[k]
        if d.init == "normal":
            fan_in = d.shape[d.fan_in_axis] if len(d.shape) >= 2 else d.shape[-1]
            std = 0.0 if k == "embed" else SERVE_PERTURB * (d.scale or fan_in ** -0.5)
        else:
            std = SERVE_PERTURB_ZEROS
        out[k] = v + torch.from_numpy(rng.standard_normal(
            tuple(v.shape), dtype=np.float32) * np.float32(std)).cuda()
    return out


def top2_gap(torch, logits) -> tuple[float, float]:
    """(top-1 minus top-2 logit, max |logit|) of one [vocab] row."""
    top = torch.topk(logits.double(), 2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def serve_boot(torch, cfg, params, policy: str, cache_path: Path, *, ladder=SERVE_LADDER,
               max_seq: int = SERVE_MAX_SEQ, **engine_kw):
    """An engine on ``ladder`` (default SERVE_LADDER), warmed under ``policy``
    against the winner cache file; returns it, the cell sources and the
    warmup seconds."""
    from repro_torch.plan import autotune as at
    from repro_torch.serve import BucketLadder, Engine

    engine = Engine(cfg, params, BucketLadder(ladder, max_seq=max_seq),
                    n_slots=SERVE_SLOTS, **engine_kw)
    t0 = time.perf_counter()
    sources = engine.warmup(policy=policy, cache=at.AutotuneCache(str(cache_path)))
    torch.cuda.synchronize()
    return engine, sources, time.perf_counter() - t0


def serve_requests(torch, engine, spec):
    """Submit the spec's requests at once and run the engine until idle:
    (requests, seconds)."""
    from repro_torch.serve import make_requests

    reqs = [r for _, r in make_requests(spec, engine.cfg.vocab)]
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def straddlers(reqs) -> dict:
    """The requests the bucketed-vs-unbucketed check takes: the longest
    and the shortest prompt, and the shortest prompt past each of the two
    lower rungs (they pad up to the next rung)."""
    by_len = sorted(reqs, key=lambda r: len(r.prompt))
    out = {"longest": by_len[-1], "shortest": by_len[0]}
    for b in sorted({s for _, s in SERVE_LADDER})[:-1]:
        past = [r for r in by_len if len(r.prompt) > b]
        if past:
            out[f"past_{b}"] = past[0]
    return out


def cache_vs_no_cache(torch, cfg, params, check_shape=SERVE_CACHE_CHECK,
                      ladder=SERVE_LADDER, max_seq: int = SERVE_MAX_SEQ) -> dict:
    """A ``check_shape[0]``-token prompt through the engine's step builders
    at batch 1 (the bucket prefill at the ladder's longest rung, then slot
    decodes): the logits of each of ``check_shape[1]`` new tokens against
    a no-cache forward over the prompt and the tokens so far, read at the
    last position.  Beside it, the spread between two no-cache forwards
    whose sequences differ by one trailing token, read at the same
    position (the same function at another GEMM shape): what f32 rounding
    alone gives through the layers."""
    import numpy as np

    from repro_torch.models import transformer as tf
    from repro_torch.runtime import serve as sv

    n_prompt, n_new = check_shape
    prompt = torch.from_numpy(np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab, n_prompt).astype(np.int32)).cuda()
    prefill = sv.make_bucket_prefill_step(cfg, max_seq)
    decode = sv.make_slot_decode_step(cfg)
    padded = torch.zeros((1, max(s for _, s in ladder)), dtype=torch.int32, device="cuda")
    padded[0, :len(prompt)] = prompt
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
    cache, logits = prefill(params, padded, pos)
    seq, errs, spread, prev = prompt, [], [], None
    for step in range(n_new):
        with torch.no_grad():
            h, _ = tf.forward(cfg, params, seq[None, :])
            last2 = tf.logits(cfg, params, h[:, -2:])[0]
        ref = last2[1]
        if prev is not None:
            spread.append(max_err(last2[0], prev) / scale(prev))
        prev = ref
        errs.append((max_err(logits[0], ref), scale(ref)))
        nxt = torch.argmax(logits, -1).to(torch.int32)
        seq = torch.cat([seq, nxt])
        if step + 1 < n_new:
            cache, logits = decode(params, cache, nxt, pos)
            pos = pos + 1
    return dict(worst_err_over_scale=max(e / s for e, s in errs),
                no_cache_spread_over_scale=max(spread),
                max_abs_err=[e for e, _ in errs], scale=[s for _, s in errs],
                generated=seq[len(prompt):].tolist())


def serve_winner_checks(torch, kernels, results, cfg, ladder, tuned) -> dict:
    """Each (bucket, cell) boot 1 tuned, run through its op with the
    ladder's winner on autotune.synthesize operands at the cell's shape,
    as the tuner ran it: every kernel launch held against the kernel's
    plain version on the same (padded) inputs at TOL x scale.  Returns
    the worst error of each cell."""
    from repro_torch.plan import autotune as at
    from repro_torch.plan import get_op, local_schedule
    from repro_torch.serve.bucket import bucket_cells

    out = {}
    for b, cell in tuned:
        op, shape = bucket_cells(cfg, b, ladder.max_seq, ladder.in_bytes)[cell]
        sched = local_schedule(ladder.plans[b][cell])
        arrays, params = at.synthesize(op, shape, torch.float32, "cuda")
        calls: list = []
        with on_launch(kernels, lambda *call: calls.append(call)):
            get_op(op)(*arrays, schedule=sched, **params)
        check(bool(calls), f"serve: cell {b}:{cell} launched no kernel")
        worst = None
        for name, args, kw, got in calls:
            want = kernels[name].plain(*args, **kw)
            err, sc = max_err(got, want), scale(want)
            check(err <= TOL * sc, f"serve: {name} at cell {b.batch}x{b.seq}:{cell} "
                                   f"blocks {dict(sched.blocks)}: err {err} > {TOL} x {sc}")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            if worst is None or err / sc > worst["max_abs_err"] / worst["scale"]:
                worst = dict(kernel=name, max_abs_err=err, scale=sc,
                             shapes=[list(a.shape) for a in args])
        out[f"{b.batch}x{b.seq}:{cell}"] = dict(worst, blocks=dict(sched.blocks),
                                                launches=len(calls))
        del arrays, calls
    return out


def phase_serve(torch, kernels, results, tfm, card):
    """qwen1.5-0.5b at full width and depth served through the engine on
    the SERVE_LADDER: boot 1 tunes the bucket cells (the matmul and
    flash-attention kernels), boot 2 replays them cache-only with the
    timing path rigged to raise; the request path launches no kernel.
    The served weights are the seed's perturbed (SERVE_PERTURB).  Checks:
    every request DONE and boot 2's streams equal boot 1's, and no stream
    of one repeated token; each tuned winner against the kernels' plain
    versions at its cell's shape; four requests' engine streams against
    greedy_generate alone (near-ties reported); a long request's cached
    logits against no-cache forwards.  Times:
    warmup, prefill per bucket, slot decode (events and profiled), a
    WallClock and a VirtualClock load run, pool bytes and peak memory."""
    from repro_torch.models import transformer as tf
    from repro_torch.plan import autotune as at
    from repro_torch.runtime import serve as sv
    from repro_torch.serve import DONE, LoadSpec, VirtualClock, run_load
    from repro_torch.serve.loadgen import no_timing

    t_phase = time.perf_counter()
    cfg, seed_params = tfm[0], tfm[2]
    params = serve_params(torch, cfg, seed_params)
    path = SCRATCH / "serve_autotune_h100.json"
    path.unlink(missing_ok=True)
    spec = LoadSpec(qps=1.0, n_requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
                    new_tokens=SERVE_NEW, seed=SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # Boot 1: tune every bucket cell on the kernels, then serve.
    zero_counts(kernels)
    engine, src1, warm_tune = serve_boot(torch, cfg, params, "tune", path)
    tune_launches = {k: kk.launches for k, kk in kernels.items()}
    for k in kernels:
        results[k]["launches_by_path"]["serve_warmup"] = tune_launches[k]
    zero_counts(kernels)
    reqs1, serve1_s = serve_requests(torch, engine, spec)
    request_launches = {k: kk.launches for k, kk in kernels.items()}
    pool_bytes = sum(t.numel() * t.element_size() for t in engine.cache.values())
    stats1 = dict(engine.stats, padding_waste=engine.padding_waste())
    del engine
    torch.cuda.empty_cache()

    # Boot 2: cache-only, the timing path rigged to raise.
    with no_timing(at):
        engine, src2, warm_cached = serve_boot(torch, cfg, params, "cache-only", path)
        reqs2, serve2_s = serve_requests(torch, engine, spec)
    flat1 = {(b, c): s for b, cells in src1.items() for c, s in cells.items()}
    flat2 = {(b, c): s for b, cells in src2.items() for c, s in cells.items()}
    tuned = sorted(f"{b.batch}x{b.seq}:{c}" for (b, c), s in flat1.items() if s == "tuned")
    not_replayed = sorted(f"{b.batch}x{b.seq}:{c}" for (b, c), s in flat1.items()
                          if s == "tuned" and flat2[(b, c)] != "cached")
    streams1 = [list(r.tokens) for r in reqs1]
    streams2 = [list(r.tokens) for r in reqs2]
    distinct = len({tuple(t) for t in streams1})
    one_token = sum(len(set(t)) == 1 for t in streams1)
    emit(phase="serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         ladder=SERVE_LADDER, max_seq=SERVE_MAX_SEQ, slots=SERVE_SLOTS,
         weights=f"seed + N(0, {SERVE_PERTURB} x init std) on the matrices but the embedding, "
                 f"N(0, {SERVE_PERTURB_ZEROS}) on the norm gains and biases (numpy, seed {SEED + 7})",
         requests=len(reqs1),
         prompt_lens=[len(r.prompt) for r in reqs1],
         new_tokens=[r.max_new_tokens for r in reqs1],
         warmup_seconds={"tune": warm_tune, "cache-only": warm_cached},
         serve_seconds={"boot1": serve1_s, "boot2": serve2_s},
         cells=len(flat1), tuned=tuned, cached_boot2=sum(s == "cached" for s in flat2.values()),
         not_replayed=not_replayed, warmup_launches=tune_launches,
         request_launches=request_launches, stats_boot1=stats1,
         distinct_streams=distinct, single_token_streams=one_token,
         streams_equal=streams1 == streams2, card=card)
    check(all(r.state == DONE for r in reqs1 + reqs2),
          f"serve: unfinished {[(r.rid, r.state) for r in reqs1 + reqs2 if r.state != DONE]}")
    check(streams1 == streams2, "serve: boot 2's token streams differ from boot 1's")
    check(bool(tuned) and not not_replayed, f"serve: tuned {tuned}, not replayed {not_replayed}")
    check("tuned" not in flat2.values(), "serve: the cache-only boot tuned a cell")
    check(tune_launches["matmul"] > 0 and tune_launches["flash_attention"] > 0,
          f"serve: warmup tuning launched {tune_launches}")
    check(not any(request_launches.values()),
          f"serve: the request path launched kernels {request_launches}")
    check(distinct > 1 and not one_token,
          f"serve: vacuous streams ({distinct} distinct, {one_token} of one token)")

    # The tuned winners against the kernels' plain versions at the cells'
    # shapes.
    winners = serve_winner_checks(
        torch, kernels, results, cfg, engine.ladder,
        sorted((b, c) for (b, c), s in flat1.items() if s == "tuned"))
    emit(phase="serve", check="tuned winners vs plain", tolerance=TOL, cells=winners)

    # Bucketed against unbucketed: the engine's streams against
    # greedy_generate of each prompt alone.
    bucketed = {}
    for label, r in straddlers(reqs2).items():
        prompt = torch.from_numpy(r.prompt).cuda()[None, :]
        ref = sv.greedy_generate(cfg, params, prompt, steps=r.max_new_tokens,
                                 max_seq=SERVE_MAX_SEQ)[0].tolist()
        rec = dict(prompt_len=len(r.prompt), new_tokens=r.max_new_tokens,
                   bucket=str(engine.ladder.route(1, len(r.prompt))), equal=r.tokens == ref)
        if r.tokens != ref:
            t = next(i for i, (a, b) in enumerate(zip(r.tokens, ref)) if a != b)
            seq = torch.cat([prompt[0], torch.tensor(ref[:t], device="cuda",
                                                     dtype=prompt.dtype)])[None, :]
            with torch.no_grad():
                h, _ = tf.forward(cfg, params, seq)
                gap, top = top2_gap(torch, tf.logits(cfg, params, h[:, -1:])[0, 0])
            rec.update(first_divergence=t, engine_token=r.tokens[t], reference_token=ref[t],
                       reference_top2_gap=gap, gap_limit=TOL * max(1.0, top),
                       near_tie=gap < TOL * max(1.0, top))
        bucketed[label] = rec
    emit(phase="serve", check="bucketed vs greedy_generate", cases=bucketed,
         gap_from="a no-cache forward over the prompt and the reference's tokens")
    for label, rec in bucketed.items():
        check(rec["equal"] or rec["near_tie"], f"serve: {label} diverges: {rec}")
    del engine
    torch.cuda.empty_cache()

    # The cache against no cache, on the served weights.
    cache_check = cache_vs_no_cache(torch, cfg, params)
    emit(phase="serve", check="cached decode vs no-cache forward",
         prompt_len=SERVE_CACHE_CHECK[0], new_tokens=SERVE_CACHE_CHECK[1], tolerance=TOL,
         **cache_check)
    worst = cache_check["worst_err_over_scale"]
    check(worst <= TOL, f"serve: cached logits vs no-cache forward {worst} > {TOL}")
    check(len(set(cache_check["generated"])) > 1,
          "serve: the cache check's tokens repeat one token")

    # Times: prefill per bucket and the slot decode (a cache-only engine).
    engine, _, _ = serve_boot(torch, cfg, params, "cache-only", path)
    prefill_ms = {}
    for b in engine.ladder.buckets:
        zt = torch.zeros((b.batch, b.seq), dtype=torch.int32, device="cuda")
        zl = torch.full((b.batch,), b.seq, dtype=torch.int32, device="cuda")
        prefill_ms[f"{b.batch}x{b.seq}"] = median_ms(
            lambda b=b, zt=zt, zl=zl: engine._prefill[b](params, zt, zl), reps=5, warmup=1)
    tok = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")
    at_pos = torch.full((SERVE_SLOTS,), SERVE_MAX_SEQ // 2, dtype=torch.int32, device="cuda")
    decode_fn = lambda: engine._decode(params, engine.cache, tok, at_pos)  # noqa: E731
    decode_ms = median_ms(decode_fn, reps=20)
    decode_device_ms = profile(torch, "serve_slot_decode", decode_fn, card, grad=False,
                               batch=f"{SERVE_SLOTS} slots at position {SERVE_MAX_SEQ // 2}")
    del engine
    torch.cuda.empty_cache()

    # One load run on each clock.
    load = LoadSpec(**SERVE_LOAD)
    reports = {}
    for name, clock in (("wall", None), ("virtual_h100", VirtualClock())):
        engine, _, _ = serve_boot(torch, cfg, params, "cache-only", path, clock=clock)
        rep = run_load(engine, load)
        torch.cuda.synchronize()
        reports[name] = dataclasses.asdict(rep)
        check(rep.completed == load.n_requests, f"serve: {name} load run {rep}")
        del engine
        torch.cuda.empty_cache()
    emit(phase="serve", check="times", card=card, prefill_ms=prefill_ms,
         decode_ms_per_step=decode_ms, decode_device_ms_per_step=decode_device_ms,
         decode_slots=SERVE_SLOTS, decode_position=SERVE_MAX_SEQ // 2,
         load_spec=SERVE_LOAD, load=reports, pool_bytes=pool_bytes,
         kv_bytes_per_token=pool_bytes // (SERVE_SLOTS * SERVE_MAX_SEQ),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         phase_seconds=time.perf_counter() - t_phase)


# -- the tenth slice: the MoE served at full width, the other families on the card ---


def device_params(torch, defs, seed: int, *, noise: bool = True) -> dict:
    """Weights of the shape ``defs`` give, drawn on the card: each leaf from
    its own generator seeded by (seed, crc32 of its path), the seed's init
    (N(0, init std) for a matrix, zeros or ones for a gain) plus, with
    ``noise``, the noise serve_params adds (SERVE_PERTURB x init std on
    every matrix but the embedding, SERVE_PERTURB_ZEROS on the gains and
    biases).  numpy, which draws the CPU init, takes minutes for the MoE's
    11.2 B values; the card's Philox generator takes milliseconds.  The
    leaves come in the order of ``defs`` (the order AdamW updates them in:
    a large leaf updated last meets every new copy already made)."""
    import zlib

    out = {}
    for path, d in defs.items():
        g = torch.Generator(device="cuda").manual_seed((seed << 32) + zlib.crc32(path.encode()))
        fan_in = d.shape[d.fan_in_axis] if len(d.shape) >= 2 else d.shape[-1]
        if d.init == "normal":
            std = d.scale if d.scale is not None else fan_in ** -0.5
            w = torch.randn(d.shape, generator=g, device="cuda").mul_(std)
            sigma = 0.0 if path == "embed" else SERVE_PERTURB * std
        else:
            w = torch.full(d.shape, 0.0 if d.init == "zeros" else 1.0, device="cuda")
            sigma = SERVE_PERTURB_ZEROS
        if noise and sigma:
            rows = max(1, (1 << 28) // max(1, w[0].numel())) if w.dim() > 1 else w.shape[0]
            for part in w.split(rows):  # at most 1 GiB of noise at a time
                part.add_(torch.randn(part.shape, generator=g, device="cuda"), alpha=sigma)
        out[path] = w
    torch.cuda.synchronize()
    return out


def moe_config():
    """qwen3-moe-235b-a22b at full width: depth 94 -> MOE_LAYERS, max_seq
    32768 -> SERVE_MAX_SEQ."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS,
                               max_seq=SERVE_MAX_SEQ)


def cell_times(torch, kernels, cfg, ladder, cells) -> dict:
    """Each distinct tuned cell of a boot, run through its op with the
    ladder's winner on autotune.synthesize operands: CUDA-event medians of
    the op call, of its launches' plain versions and of one library call
    (torch.matmul; scaled_dot_product_attention on the KV heads repeated
    to the query heads), beside the bound of the call's work: each operand
    read once and the output written once; the matmul's 2mnk FLOP, the
    attention's 4 D FLOP per (q, k) pair its causal mask admits."""
    import torch.nn.functional as F

    from repro_torch.plan import autotune as at
    from repro_torch.plan import get_op, local_schedule
    from repro_torch.serve.bucket import bucket_cells

    out, seen = {}, set()
    for b, cell in cells:
        op, shape = bucket_cells(cfg, b, ladder.max_seq, ladder.in_bytes)[cell]
        key = (op, tuple(sorted(shape.items())))
        if key in seen:
            continue
        seen.add(key)
        sched = local_schedule(ladder.plans[b][cell])
        arrays, kw = at.synthesize(op, shape, torch.float32, "cuda")
        calls: list = []
        with on_launch(kernels, lambda *call: calls.append(call)):
            get_op(op)(*arrays, schedule=sched, **kw)
        call = lambda: get_op(op)(*arrays, schedule=sched, **kw)  # noqa: E731
        plain = lambda: [kernels[n].plain(*a, **k) for n, a, k, _ in calls]  # noqa: E731
        if op == "matmul":
            lib = lambda: torch.matmul(*arrays)  # noqa: E731
            flops = 2.0 * shape["m"] * shape["n"] * shape["k"]
            nbytes = 4.0 * (shape["m"] * shape["k"] + shape["k"] * shape["n"]
                            + shape["m"] * shape["n"])
        else:
            q, k, v = arrays
            g = q.shape[1] // k.shape[1]
            k4, v4 = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k4, v4, is_causal=kw["causal"])
            pairs = (visible_pairs(shape["seq_q"], shape["seq_kv"], kw["window"])
                     if kw["causal"] else shape["seq_q"] * shape["seq_kv"])
            flops = 4.0 * q.shape[0] * q.shape[1] * pairs * q.shape[-1]
            nbytes = 4.0 * (2 * q.numel() + k.numel() + v.numel())
        reps = 3 if max(t.numel() for t in arrays) > (1 << 28) else 10
        ms, plain_ms, lib_ms = (median_ms(f, reps=reps, warmup=1) for f in (call, plain, lib))
        b_ms, b_by = bound_ms(flops, nbytes)
        out[f"{b.batch}x{b.seq}:{cell}"] = dict(
            op=op, kernels=sorted({n for n, _, _, _ in calls}), launches=len(calls),
            blocks=dict(sched.blocks), shape=shape, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
            flops=flops, bytes=nbytes, peaks=PEAKS)
        del arrays, calls
        torch.cuda.empty_cache()
    return out


def decode_bytes(cfg) -> int:
    """The weight bytes one MoE decode step must read (f32): every layer's
    attention projections, router and all E experts' three matrices (the
    dispatch runs every expert on its capacity rows), and the untied head;
    the embedding rows, norms and the KV cache are small beside them."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    per_layer = d * (Hq + 2 * Hkv) * Dh + Hq * Dh * d + d * E + 3 * E * d * ff
    return 4 * (cfg.n_layers * per_layer + d * cfg.vocab)


def moe_cache_vs_no_cache(torch, cfg, params) -> dict:
    """A MOE_CACHE_CHECK[0]-token prompt through the engine's step builders
    at batch 1 (the bucket prefill padded to the lowest rung, then slot
    decodes) against a no-cache forward over the prompt and the tokens so
    far, read at the last position — under capacity factor n_experts /
    top_k, where cap = T and no row is dropped, so both paths compute one
    function (at 1.25 the drops depend on the tokens dispatched together,
    in both packages).  Beside it, the spread of two no-cache forwards one
    token apart, read at the same position."""
    import numpy as np

    from repro_torch.models import moe
    from repro_torch.runtime import serve as sv

    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    n_prompt, n_new = MOE_CACHE_CHECK
    prompt = torch.from_numpy(np.random.default_rng(SEED + 9).integers(
        0, cfg.vocab, n_prompt).astype(np.int32)).cuda()
    rung = min(s for _, s in SERVE_LADDER)
    padded = torch.zeros((1, rung), dtype=torch.int32, device="cuda")
    padded[0, :n_prompt] = prompt
    pos = torch.tensor([n_prompt], dtype=torch.int32, device="cuda")
    cache, logits = sv.make_bucket_prefill_step(nodrop, SERVE_MAX_SEQ)(params, padded, pos)
    decode = sv.make_slot_decode_step(nodrop)
    seq, errs, spread, prev = prompt, [], [], None
    for step in range(n_new):
        with torch.no_grad():
            h, _ = moe.forward(nodrop, params, seq[None, :])
            last2 = moe.logits(nodrop, params, h[:, -2:])[0]
        ref = last2[1]
        if prev is not None:
            spread.append(max_err(last2[0], prev) / scale(prev))
        prev = ref
        errs.append((max_err(logits[0], ref), scale(ref)))
        nxt = torch.argmax(logits, -1).to(torch.int32)
        seq = torch.cat([seq, nxt])
        if step + 1 < n_new:
            cache, logits = decode(params, cache, nxt, pos)
            pos = pos + 1
    return dict(capacity_factor=nodrop.capacity_factor,
                worst_err_over_scale=max(e / s for e, s in errs),
                no_cache_spread_over_scale=max(spread),
                max_abs_err=[e for e, _ in errs], scale=[s for _, s in errs],
                generated=seq[n_prompt:].tolist())


def phase_moe_serve(torch, kernels, results, card):
    """qwen3-moe-235b-a22b at full width (MOE_LAYERS of its 94 layers, f32)
    served through the engine on the SERVE_LADDER, as phase serve serves
    qwen1.5-0.5b: boot 1 tunes the bucket cells on the matmul and
    flash-attention kernels (path ``moe_serve_warmup``), boot 2 replays
    them cache-only with the timing path rigged to raise; the request path
    launches no kernel.  The slot decode dispatches each slot alone, as the
    JAX package's vmap of a batch-1 forward does.  Checks: every request
    DONE and boot 2's streams equal boot 1's; each tuned winner against the
    kernels' plain versions at its cell's shape (GQA 64/4 flash at D = 128;
    qkv n 9216 and the experts' d_ff 1536); cached logits against no-cache
    forwards under a capacity factor that cannot bind (n_experts / top_k:
    every expert takes every token).  Times: weight draw, warmup, prefill
    per bucket, slot decode (events and profiled device time by kernel),
    the tuned cells beside their plain versions, library calls and bounds,
    a WallClock and a VirtualClock load run, peak memory."""
    from repro_torch.models import moe
    from repro_torch.models.module import count_params
    from repro_torch.plan import autotune as at
    from repro_torch.serve import DONE, LoadSpec, VirtualClock, run_load
    from repro_torch.serve.loadgen import no_timing

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = moe_config()
    defs = moe.param_defs(cfg)
    t0 = time.perf_counter()
    params = device_params(torch, defs, SEED)
    draw_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    path = SCRATCH / "moe_serve_autotune_h100.json"
    path.unlink(missing_ok=True)
    spec = LoadSpec(qps=1.0, n_requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
                    new_tokens=SERVE_NEW, seed=SEED)

    zero_counts(kernels)
    engine, src1, warm_tune = serve_boot(torch, cfg, params, "tune", path)
    tune_launches = {k: kk.launches for k, kk in kernels.items()}
    for k in kernels:
        results[k]["launches_by_path"]["moe_serve_warmup"] = tune_launches[k]
    zero_counts(kernels)
    reqs1, serve1_s = serve_requests(torch, engine, spec)
    request_launches = {k: kk.launches for k, kk in kernels.items()}
    pool_bytes = sum(t.numel() * t.element_size() for t in engine.cache.values())
    stats1 = dict(engine.stats, padding_waste=engine.padding_waste())
    ladder = engine.ladder
    del engine
    torch.cuda.empty_cache()
    with no_timing(at):
        engine, src2, warm_cached = serve_boot(torch, cfg, params, "cache-only", path)
        reqs2, serve2_s = serve_requests(torch, engine, spec)
    del engine
    torch.cuda.empty_cache()
    flat1 = {(b, c): s for b, cells in src1.items() for c, s in cells.items()}
    flat2 = {(b, c): s for b, cells in src2.items() for c, s in cells.items()}
    tuned = sorted((b, c) for (b, c), s in flat1.items() if s == "tuned")
    not_replayed = sorted(f"{b.batch}x{b.seq}:{c}" for b, c in tuned if flat2[(b, c)] != "cached")
    streams1 = [list(r.tokens) for r in reqs1]
    streams2 = [list(r.tokens) for r in reqs2]
    emit(phase="moe_serve", arch=cfg.name, n_layers=cfg.n_layers, of_layers=94,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
         experts=[cfg.n_experts, cfg.moe_top_k, cfg.d_ff], capacity_factor=cfg.capacity_factor,
         vocab=cfg.vocab, params=count_params(defs), weight_bytes=weight_bytes,
         weight_draw_seconds=draw_s, ladder=SERVE_LADDER, max_seq=SERVE_MAX_SEQ,
         slots=SERVE_SLOTS, weights=f"drawn on the card from seed {SEED}: init + N(0, "
         f"{SERVE_PERTURB} x init std) on the matrices but the embedding, N(0, "
         f"{SERVE_PERTURB_ZEROS}) on the gains",
         requests=len(reqs1), prompt_lens=[len(r.prompt) for r in reqs1],
         new_tokens=[r.max_new_tokens for r in reqs1],
         warmup_seconds={"tune": warm_tune, "cache-only": warm_cached},
         serve_seconds={"boot1": serve1_s, "boot2": serve2_s}, cells=len(flat1),
         tuned=[f"{b.batch}x{b.seq}:{c}" for b, c in tuned],
         cached_boot2=sum(s == "cached" for s in flat2.values()), not_replayed=not_replayed,
         warmup_launches=tune_launches, request_launches=request_launches,
         stats_boot1=stats1, distinct_streams=len({tuple(t) for t in streams1}),
         single_token_streams=sum(len(set(t)) == 1 for t in streams1),
         streams_equal=streams1 == streams2, card=card)
    check(all(r.state == DONE for r in reqs1 + reqs2),
          f"moe_serve: unfinished {[(r.rid, r.state) for r in reqs1 + reqs2 if r.state != DONE]}")
    check(streams1 == streams2, "moe_serve: boot 2's token streams differ from boot 1's")
    check(bool(tuned) and not not_replayed, f"moe_serve: tuned {tuned}, not replayed "
                                            f"{not_replayed}")
    check("tuned" not in flat2.values(), "moe_serve: the cache-only boot tuned a cell")
    check(tune_launches["matmul"] > 0 and tune_launches["flash_attention"] > 0,
          f"moe_serve: warmup tuning launched {tune_launches}")
    check(not any(request_launches.values()),
          f"moe_serve: the request path launched kernels {request_launches}")

    winners = serve_winner_checks(torch, kernels, results, cfg, ladder, tuned)
    emit(phase="moe_serve", check="tuned winners vs plain", tolerance=TOL, cells=winners)
    emit(phase="moe_serve", check="cell times", card=card,
         cells=cell_times(torch, kernels, cfg, ladder, tuned))

    cache_check = moe_cache_vs_no_cache(torch, cfg, params)
    emit(phase="moe_serve", check="cached decode vs no-cache forward", tolerance=TOL,
         prompt_len=MOE_CACHE_CHECK[0], new_tokens=MOE_CACHE_CHECK[1], **cache_check)
    worst = cache_check["worst_err_over_scale"]
    check(worst <= TOL, f"moe_serve: cached logits vs no-cache forward {worst} > {TOL}")

    engine, _, _ = serve_boot(torch, cfg, params, "cache-only", path)
    prefill_ms = {}
    for b in engine.ladder.buckets:
        zt = torch.zeros((b.batch, b.seq), dtype=torch.int32, device="cuda")
        zl = torch.full((b.batch,), b.seq, dtype=torch.int32, device="cuda")
        prefill_ms[f"{b.batch}x{b.seq}"] = median_ms(
            lambda b=b, zt=zt, zl=zl: engine._prefill[b](params, zt, zl), reps=3, warmup=1)
    tok = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")
    at_pos = torch.full((SERVE_SLOTS,), SERVE_MAX_SEQ // 2, dtype=torch.int32, device="cuda")
    decode_fn = lambda: engine._decode(params, engine.cache, tok, at_pos)  # noqa: E731
    decode_ms = median_ms(decode_fn, reps=20)
    decode_device_ms = profile(torch, "moe_slot_decode", decode_fn, card, grad=False,
                               batch=f"{SERVE_SLOTS} slots at position {SERVE_MAX_SEQ // 2}")
    del engine
    torch.cuda.empty_cache()

    load = LoadSpec(**SERVE_LOAD)
    reports = {}
    for name, clock in (("wall", None), ("virtual_h100", VirtualClock())):
        engine, _, _ = serve_boot(torch, cfg, params, "cache-only", path, clock=clock)
        rep = run_load(engine, load)
        torch.cuda.synchronize()
        reports[name] = dataclasses.asdict(rep)
        check(rep.completed == load.n_requests, f"moe_serve: {name} load run {rep}")
        del engine
        torch.cuda.empty_cache()
    emit(phase="moe_serve", check="times", card=card, prefill_ms=prefill_ms,
         decode_ms_per_step=decode_ms, decode_device_ms_per_step=decode_device_ms,
         decode_slots=SERVE_SLOTS, decode_position=SERVE_MAX_SEQ // 2,
         decode_bytes_per_step=decode_bytes(cfg), decode_bound_ms=decode_bytes(cfg) / HBM_BW * 1e3,
         load_spec=SERVE_LOAD, load=reports, pool_bytes=pool_bytes,
         kv_bytes_per_token=pool_bytes // (SERVE_SLOTS * SERVE_MAX_SEQ),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         phase_seconds=time.perf_counter() - t_phase)
    del params
    torch.cuda.empty_cache()


def family_logits(torch, fam, cfg, params, seq, frames, positions) -> "torch.Tensor":
    """A no-cache forward over ``seq`` [B, S] (right-padded with token 0 to
    a multiple of the SSD chunk where the family has one: causal, so a
    position's logits see no pad), read at ``positions``: [B, P, vocab]."""
    from repro_torch.models import mamba2

    S = seq.shape[1]
    if cfg.family == "zamba2":
        S = -(-S // mamba2.CHUNK) * mamba2.CHUNK
        seq = torch.nn.functional.pad(seq, (0, S - seq.shape[1]))
    kw = {"frames": frames} if frames is not None else {}
    with torch.no_grad():
        h, _ = fam.forward(cfg, params, seq, **kw)
        return fam.logits(cfg, params, h[:, positions])


def phase_families(torch, card):
    """rwkv6-1.6b, zamba2-1.2b and seamless-m4t-medium at full width and
    depth, f32, each on weights drawn on the card (device_params): a
    seeded FAMILY_BATCH x FAMILY_PROMPT prompt (the encoder-decoder also
    takes FAMILY_BATCH x enc_seq x d_model seeded frames) through the
    prefill step, then FAMILY_DECODE cached greedy decode steps; each
    step's logits against one no-cache forward over the prompt and the
    generated tokens, read at the step's position, within TOL x
    max(1, max |logit|).  Beside the gap, the spread of that forward
    against one a chunk longer (Zamba2: one SSD chunk more of padding; the
    others: one more pad token), read at the same positions: f32 rounding
    of the same function at another shape.  Zamba2's decode (the per-step
    SSD recurrence) is other algebra than its chunked forward, so its gate
    is max(TOL, SPREAD_GATE x that spread).  Times: decode ms a step
    (events), peak memory, weight bytes."""
    import numpy as np

    from repro_torch.models import mamba2
    from repro_torch.models.module import count_params
    from repro_torch.models.registry import get_family
    from repro_torch.runtime import serve as sv

    out = {}
    for arch in FAMILY_ARCHS:
        t_arch = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = family_config(arch)
        fam = get_family(cfg.family)
        defs = fam.param_defs(cfg)
        params = device_params(torch, defs, SEED)
        rng = np.random.default_rng(SEED + 10)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (FAMILY_BATCH, FAMILY_PROMPT))
                                  .astype(np.int32)).cuda()
        frames = None
        batch = {"tokens": prompt}
        if cfg.family == "encdec":
            frames = torch.from_numpy(rng.standard_normal(
                (FAMILY_BATCH, cfg.enc_seq, cfg.d_model), dtype=np.float32)).cuda()
            batch["frames"] = frames
        max_seq = FAMILY_PROMPT + FAMILY_DECODE
        cache, logits = sv.make_prefill_step(cfg, max_seq, "float32", "float32")(params, batch)
        decode = sv.make_decode_step(cfg, "float32")
        toks, got = [], []
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        for step in range(FAMILY_DECODE):
            toks.append(nxt)
            cache, logits = decode(params, cache, nxt[:, None], FAMILY_PROMPT + step)
            got.append(logits[:, 0])
            nxt = torch.argmax(logits[:, 0], -1).to(torch.int32)
        seq = torch.cat([prompt, torch.stack(toks, 1)], 1)
        where = torch.arange(FAMILY_PROMPT, max_seq, device="cuda")
        want = family_logits(torch, fam, cfg, params, seq, frames, where)
        pad = mamba2.CHUNK if cfg.family == "zamba2" else 1
        longer = family_logits(torch, fam, cfg, params, torch.nn.functional.pad(seq, (0, pad)),
                               frames, where)
        got = torch.stack(got, 1)
        errs = [max_err(got[:, i], want[:, i]) / scale(want[:, i]) for i in range(FAMILY_DECODE)]
        spread = max(max_err(longer[:, i], want[:, i]) / scale(want[:, i])
                     for i in range(FAMILY_DECODE))
        # Zamba2's decode runs the per-step SSD recurrence and its no-cache
        # forward chunks of 128: other algebra for one function, gated on
        # the no-cache forward's own spread where that passes TOL.
        gate = max(TOL, SPREAD_GATE * spread) if cfg.family == "zamba2" else TOL
        tok = nxt[:, None]
        decode_ms = median_ms(lambda: decode(params, cache, tok, max_seq - 1), reps=10)
        rec = dict(arch=arch, family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
                   params=count_params(defs),
                   weight_bytes=sum(t.numel() * t.element_size() for t in params.values()),
                   batch=FAMILY_BATCH, prompt=FAMILY_PROMPT, decode_steps=FAMILY_DECODE,
                   frames=list(frames.shape) if frames is not None else None,
                   tolerance=gate, worst_err_over_scale=max(errs), err_over_scale=errs,
                   no_cache_spread_over_scale=spread,
                   generated_distinct=len(set(seq[:, FAMILY_PROMPT:].flatten().tolist())),
                   decode_ms_per_step=decode_ms,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   seconds=time.perf_counter() - t_arch, card=card)
        emit(phase="families", **rec)
        check(all(bool(torch.isfinite(t).all()) for t in (got, want)),
              f"families: {arch} non-finite logits")
        check(max(errs) <= gate, f"families: {arch} cached decode vs no-cache forward "
                                 f"{max(errs)} > {gate} (spread {spread})")
        out[arch] = rec
        del params, cache, logits, got, want, longer
        torch.cuda.empty_cache()
    return out


def family_config(arch: str):
    from repro_torch.configs import get_config

    return get_config(arch)


def paper_conv_cases(cnn, cfg):
    """(label, batch, ConvShape fields) of phase paper's conv cases."""
    out = [(f"example_b{b}", b, dict(PAPER_EXAMPLE)) for b in PAPER_BATCHES]
    for name, x_shape, w_shape in cnn._stage_geometry(cfg, BATCH):
        if name.startswith("conv"):
            out.append((name, BATCH, dict(W_I=x_shape[1], D_I=w_shape[2], D_O=w_shape[3],
                                          F=w_shape[0], S=1, P=w_shape[0] // 2)))
    return out


def paper_fc_cases(cnn, cfg):
    """(label, FCShape fields) of phase paper's FC cases: the paper's fc6,
    then cnn-vgg11's fc1 (its input the last conv stage's pooled plane)
    and fc2."""
    out = [("fc6", dict(PAPER_FC))]
    stages = list(cnn._stage_geometry(cfg, BATCH))
    _, last_x, last_w = [st for st in stages if st[0].startswith("conv")][-1]
    plane = last_x[1] // 2
    for name, x_shape, w_shape in stages:
        if name == "fc1":
            out.append((name, dict(W_I=plane, D_I=last_w[3], D_O=w_shape[1], B=x_shape[0])))
        elif name == "fc2":
            out.append((name, dict(W_I=1, D_I=w_shape[0], D_O=w_shape[1], B=x_shape[0])))
    return out


def paper_x_shape(d: dict, batch: int) -> tuple:
    hw = (d["W_I"], d["W_I"], d["D_I"])
    return hw if batch == 1 else (batch, *hw)


def paper_plan(cl, x_shape, f_shape, strategy: str, padding: int):
    """(the H100 schedule conv_layer runs under ``strategy``, None) or
    (None, the planner's rejection): the one error this phase reports
    instead of failing."""
    from repro_torch.plan.planners import PlanRejected

    try:
        return cl.plan(x_shape, f_shape, stride=1, padding=padding, strategy=strategy,
                       autotune="off"), None
    except PlanRejected as e:
        return None, str(e)


def paper_quotes(ccr, MANTICORE) -> dict:
    """The paper's quoted numbers through the port's closed forms (Secs.
    2.1.4, 2.2.2, 2.2.4, 2.3.2, 2.3.4, 3.1.2, 3.1.4, 3.2.4), each beside the
    number the paper prints."""
    s, fc = ccr.ConvShape(**PAPER_EXAMPLE), ccr.FCShape(**PAPER_FC)
    fc_at = lambda d_o: ccr.FCShape(W_I=7, D_I=512, D_O=d_o, B=32)
    got = {
        "alg1_ccr": (ccr.alg1_traffic(s).ccr, 8.9),
        "alg1_spflop_per_B": (ccr.alg1_traffic(s).flops_per_byte("sp"), 4.4),
        "alg2_delta_o_sp": (ccr.alg2_max_stack(s, MANTICORE, "sp"), 24),
        "alg2_delta_o_dp": (ccr.alg2_max_stack(s, MANTICORE, "dp"), 12),
        "alg2_ccr_sp": (ccr.alg2_traffic(s, 24).ccr, 141.8),
        "alg2_ccr_dp": (ccr.alg2_traffic(s, 12).ccr, 87.8),
        "alg3_delta_o_sp": (ccr.alg3_max_stack(s, MANTICORE, "sp"), 23),
        "alg3_delta_o_dp": (ccr.alg3_max_stack(s, MANTICORE, "dp"), 11),
        "alg3_ccr_offchip_as_quoted_sp": (ccr.alg3_ccr_offchip_as_quoted(s, 23), 541.4),
        "alg3_ccr_offchip_as_quoted_dp": (ccr.alg3_ccr_offchip_as_quoted(s, 11), 540.6),
        "alg3_ccr_offchip_eq10_sp": (ccr.alg3_traffic(s, 23).ccr_offchip, 460.8),
        "alg3_ccr_offchip_eq10_dp": (ccr.alg3_traffic(s, 11).ccr_offchip, 400.7),
        "alg45_max_d_o_sp": (ccr.alg45_max_stack(fc, MANTICORE, "sp"), 768),
        "alg45_max_d_o_dp": (ccr.alg45_max_stack(fc, MANTICORE, "dp"), 384),
        "alg4_ccr_sp": (ccr.alg4_ccr(fc_at(768)), 30.7),
        "alg4_ccr_dp": (ccr.alg4_ccr(fc_at(384)), 29.5),
        "alg5_ccr_sp": (ccr.alg5_ccr(fc, 768), 30.6),
        "alg5_ccr_dp": (ccr.alg5_ccr(fc, 384), 29.5),
    }
    return {k: {"port": v, "paper": q} for k, (v, q) in got.items()}


# The main kernel of each launch of the conv and matmul wrappers (a split
# matmul adds its slab sum, which the device time includes).
LAUNCH_MARKERS = ("conv_reg_kernel", "conv_simple_kernel", "mm_reg_kernel",
                  "mm_simple_kernel")


def paper_device_ms(torch, fn, launches: int, reps: int = 5):
    """(device ms per call, calls the profile captured) of ``fn``, which
    makes ``launches`` kernel launches a call: the device time of every
    kernel in the profile over the calls whose launches it holds.  A long
    process's profile can lose whole calls' events (after the earlier
    phases, one case's profile held none and the others' device times
    read 0.58 of a fresh process's), so the calls are counted from the
    launches seen, not assumed; (None, 0) when it holds none."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = device_kernels(torch, prof)
    calls = sum(c for _, k, c in rows if any(m in k for m in LAUNCH_MARKERS)) / launches
    if not calls:
        return None, 0
    return sum(ms for ms, _, _ in rows) / calls, calls


def manticore_record(ccr, t, machine) -> dict:
    return dict(macs=t.macs, words=t.main_words, intercluster=t.intercluster, ccr=t.ccr,
                ccr_offchip=t.ccr_offchip, bound_kind=ccr.bound_kind(t, machine, "sp"))


def phase_paper(torch, kernels, results, card):
    """The direct conv under Algs 1-3 and the strip, and the FC layer
    (Algs 4-5), through ``conv_layer`` / ``fc_layer`` on their planned H100
    schedules: each case's output against its plain version (TF32 off)
    within TOL x scale, its launches (path ``paper``: counts zeroed just
    before the one driven call of each case, read just after) and the
    blocks launched against the plan; event ms (median) and profiled
    device ms (per captured call) beside the schedule's modeled words, H100 bound kind and
    roofline bound; and the paper's closed form on Manticore for the same
    layer (one image; the FC with its batch).  Alg 3 runs Alg 2's kernel on
    one device (its ring needs a mesh): the two schedules must be equal.
    A planner rejection is reported as one; any other error fails."""
    from repro_torch.configs import get_config
    from repro_torch.core import ccr
    from repro_torch.core import conv_layer as cl
    from repro_torch.core import fc_layer as fl
    from repro_torch.core.machine import H100, MANTICORE
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.models import cnn
    from repro_torch.plan import to_roofline

    t_phase = time.perf_counter()
    cfg = get_config("cnn-vgg11")
    quotes = paper_quotes(ccr, MANTICORE)
    emit(phase="paper", what="quoted", quotes=quotes, card=card)
    for key, q in quotes.items():
        check(abs(q["port"] - q["paper"]) <= 0.05, f"paper quote {key}: {q}")
    path = {name: 0 for name in kernels}
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)

    def drive(fn, expected_blocks):
        """One counted call, its launched blocks held against the plan:
        (output, launches by kernel)."""
        seen = set()
        zero_counts(kernels)
        with spy_blocks(kernels, seen):
            out = fn()
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        for name, n in launches.items():
            path[name] += n
        check(seen == expected_blocks, f"paper: launched {seen}, planned {expected_blocks}")
        return out, {k: n for k, n in launches.items() if n}

    def timed(fn, plain_fn, s, err, want, launches):
        check(err <= TOL * scale(want), f"paper: err {err} > {TOL} x {scale(want)}")
        with torch.no_grad():
            ms = median_ms(fn, reps=PAPER_REPS)
            dev, calls = paper_device_ms(torch, fn, sum(launches.values()))
            plain_ms = median_ms(plain_fn, reps=PAPER_REPS)
        rf = to_roofline(s, machine=H100)
        b_ms = rf.t_bound * 1e3
        return dict(max_abs_err=err, scale=scale(want), ms=ms,
                    device_ms=dev if dev is not None else "not measured",
                    profiled_calls=calls, plain_ms=plain_ms,
                    schedule=dict(algorithm=s.algorithm,
                                                     blocks=s.block_dict(), grid=list(s.grid),
                                                     smem_bytes=s.vmem_bytes),
                    modeled_words=s.modeled_words, macs=s.macs,
                    arithmetic_intensity=s.arithmetic_intensity("sp"),
                    h100_bound_kind=s.bound_kind(H100, "sp"), roofline_bound_ms=b_ms,
                    roofline_bottleneck=rf.bottleneck, bound_share=b_ms / ms,
                    device_bound_share=b_ms / dev if dev is not None else "not measured")

    n_conv = 0
    for label, batch, d in paper_conv_cases(cnn, cfg):
        shape = ccr.ConvShape(**d)
        x_shape = paper_x_shape(d, batch)
        x = torch.randn(x_shape, device="cuda", generator=g)
        f = torch.randn((d["F"], d["F"], d["D_I"], d["D_O"]), device="cuda",
                        generator=g) / (d["F"] ** 2 * d["D_I"]) ** 0.5
        with torch.no_grad():
            want = conv2d_ref(x, f, stride=1, padding=d["P"])
        H_O = shape.W_O
        plans = {}
        for strategy in PAPER_STRATEGIES:
            rec = dict(phase="paper", kernel_path="conv_layer", case=label, batch=batch,
                       strategy=strategy, shape=d,
                       manticore=manticore_record(ccr, cl.traffic(shape, strategy), MANTICORE),
                       card=card)
            s, rejected = paper_plan(cl, x_shape, tuple(f.shape), strategy, d["P"])
            if rejected is not None:
                emit(**rec, rejected_by_planner=rejected)
                continue
            plans[strategy] = s
            b = s.block_dict()
            if s.algorithm == "im2col":
                blocks = {("matmul", (b["block_m"], b["block_n"], b["block_k"]))}
            else:
                blocks = {("conv2d", (min(b["block_h"], H_O), b["block_do"], b["block_di"]))}
            run = lambda: cl.conv_layer(x, f, 1, d["P"], strategy)
            with torch.no_grad():
                got, launches = drive(run, blocks)
            err = max_err(got, want)
            for name in launches:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            rec.update(launches=launches, **timed(
                run, lambda: conv2d_ref(x, f, stride=1, padding=d["P"]), s, err, want,
                launches))
            if strategy == "alg1":
                check(b["block_do"] == H100.lane, f"paper {label}: alg1 block_do {b}")
            if strategy == "alg3":
                same = plans.get("alg2") == s
                check(same, f"paper {label}: alg3 schedule differs from alg2's")
                rec["same_schedule_as_alg2"] = same
            emit(**rec)
            n_conv += 1
        del x, f, want

    n_fc = 0
    for label, d in paper_fc_cases(cnn, cfg):
        shape = ccr.FCShape(**d)
        m, k, n = d["B"], d["W_I"] ** 2 * d["D_I"], d["D_O"]
        x = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g) / k ** 0.5
        with torch.no_grad():
            want = torch.matmul(x, w)
        s = fl.plan((m, k), (k, n), autotune="off")
        check(s.fits(H100), f"paper {label}: fc schedule does not fit")
        bm, bn, bk = s.block("block_m"), s.block("block_n"), s.block("block_k")
        run = lambda: fl.fc_layer(x, w)
        with torch.no_grad():
            got, launches = drive(run, {("matmul", (bm, bn, bk))})
        err = max_err(got, want)
        results["matmul"]["max_abs_err"] = max(results["matmul"]["max_abs_err"], err)
        rec = dict(phase="paper", kernel_path="fc_layer", case=label, shape=d, m=m, k=k, n=n,
                   launches=launches,
                   **timed(run, lambda: torch.matmul(x, w), s, err, want, launches),
                   manticore={alg: manticore_record(ccr, fl.traffic(shape, alg), MANTICORE)
                              for alg in ("alg4", "alg5")},
                   eq11_alg4_ccr=ccr.alg4_ccr(shape),
                   eq14_alg5_ccr=ccr.alg5_ccr(
                       shape, max(1, min(ccr.alg45_max_stack(shape, MANTICORE, "sp"), n))),
                   card=card)
        # With one m-block over the whole batch (and no padding) the
        # blocked matmul's words are Alg 5's Eqs. (12)-(13) at stack block_n.
        covers = bm == m and n % bn == 0 and k % bk == 0
        rec["block_m_covers_batch"] = bm >= m
        if covers:
            eq = ccr.alg5_traffic(shape, bn)
            check((s.loads, s.stores) == (eq.main_loads, eq.main_stores),
                  f"paper {label}: schedule words {s.loads}+{s.stores} != Eqs. 12-13 "
                  f"{eq.main_loads}+{eq.main_stores}")
            rec["eq12_13_words_at_block_n"] = eq.main_words
        emit(**rec)
        n_fc += 1
        del x, w, want
    for name in kernels:
        results[name]["launches_by_path"]["paper"] = path[name]
    emit(phase="paper", conv_lines=n_conv, fc_lines=n_fc, launches=path,
         seconds=time.perf_counter() - t_phase, card=card)


# -- the twelfth slice: the last dense configs trained and served at full width ------


def hold_launches(torch, kernels, results, calls: dict):
    """While the block runs, hold the first launch of each distinct call
    (kernel, operand shapes, keywords) against the kernel's plain version
    on the same operands at TOL x scale, keep a copy of its operands for
    dense_call_times, and count the launches of each call in ``calls``."""
    def record(name, args, kw, out):
        key = (name, tuple(tuple(a.shape) for a in args), tuple(sorted(kw.items())))
        if key in calls:
            calls[key]["launches"] += 1
            return
        want = kernels[name].plain(*args, **kw)
        pairs = list(zip(out, want)) if isinstance(out, tuple) else [(out, want)]
        err = max(max_err(o, w) for o, w in pairs)
        sc = max(scale(w) for _, w in pairs)
        check(err <= TOL * sc, f"{name} at {key[1]} {kw}: err {err} > {TOL} x {sc}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        calls[key] = dict(kernel=name, shapes=[list(a.shape) for a in args], kw=dict(kw),
                          max_abs_err=err, scale=sc, launches=1,
                          args=[a.detach().clone() for a in args])
    return on_launch(kernels, record)


def dense_call_times(torch, kernels, calls: dict, hq: int, hkv: int) -> list:
    """Each distinct call kept by hold_launches: CUDA-event medians of the
    kernel, its plain version and one library call (torch.matmul;
    scaled_dot_product_attention on the KV heads repeated, where there is
    no window) on the same operands, beside the bound of the call's work
    (each operand read once, each output written once; 2mnk FLOP a GEMM,
    4 D FLOP a (q, k) pair the masks admit)."""
    import torch.nn.functional as F

    out = []
    for c in calls.values():
        name, args, kw = c["kernel"], c.pop("args"), c["kw"]
        kern, lib = kernels[name], None
        if name == "flash_attention":
            q, k, v = args
            b, d = q.shape[0] // hq, q.shape[-1]
            flops = 4.0 * b * hq * visible_pairs(kw["q_len"], kw["kv_len"], kw["window"]) * d
            nbytes = 4.0 * d * (2 * b * hq * kw["q_len"] + 2 * b * hkv * kw["kv_len"])
            if kw["window"] is None and (kw["q_len"], kw["kv_len"]) == (q.shape[1], k.shape[1]):
                q4 = q.reshape(b, hq, *q.shape[1:])
                k4, v4 = (t.reshape(b, hkv, *t.shape[1:]).repeat_interleave(hq // hkv, 1)
                          for t in (k, v))
                lib = lambda q4=q4, k4=k4, v4=v4: F.scaled_dot_product_attention(  # noqa: E731
                    q4, k4, v4, is_causal=kw["causal"])
        else:
            a, bb = args[0], args[1]
            m, k_, n = {"matmul": (a.shape[0], a.shape[1], bb.shape[1]),
                        "matmul_nt": (a.shape[0], bb.shape[0], a.shape[1]),
                        "matmul_tn": (a.shape[0], a.shape[1], bb.shape[1]),
                        "matmul_dx_dw": (a.shape[0], bb.shape[0], a.shape[1])}[name]
            flops = 2.0 * m * n * k_ * (2 if name == "matmul_dx_dw" else 1)
            words = m * k_ + k_ * n + m * n + (m * k_ + k_ * n if name == "matmul_dx_dw" else 0)
            nbytes = 4.0 * words
            lib = {"matmul": lambda a=a, bb=bb: torch.matmul(a, bb),
                   "matmul_nt": lambda a=a, bb=bb: torch.matmul(a, bb.t()),
                   "matmul_tn": lambda a=a, bb=bb: torch.matmul(a.t(), bb),
                   "matmul_dx_dw": lambda a=a, bb=bb, x=args[-1]: (
                       torch.matmul(a, bb.t()), torch.matmul(x.t(), a))}[name]
        ms = median_ms(lambda: kern(*args, **kw), reps=3, warmup=1)
        plain_ms = median_ms(lambda: kern.plain(*args, **kw), reps=3, warmup=1)
        lib_ms = median_ms(lib, reps=3, warmup=1) if lib is not None else None
        b_ms, b_by = bound_ms(flops, nbytes)
        out.append(dict({k: v for k, v in c.items() if k != "kw"},
                        blocks={k: v for k, v in kw.items() if k.startswith("block")},
                        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                        bound_by=b_by, bound_share=b_ms / ms, flops=flops, bytes=nbytes))
        del args, lib
    torch.cuda.empty_cache()
    return out


def dense_step_times(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler, timed by CUDA events around
    it: (event ms, device ms, the largest device kernels)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    rows = device_kernels(torch, prof)
    return dict(event_ms=start.elapsed_time(end),
                device_ms=sum(r[0] for r in rows) if rows else "not measured",
                top=[{"kernel": k[:80], "ms": ms, "calls": c} for ms, k, c in rows[:8]])


def dense_parity(torch, kernels, results, cfg, tcfg, plans, params0, batch0) -> dict:
    """Step 1 of the planned step from ``params0``: each distinct kernel call
    against its plain version (hold_launches), the attention launched at
    the config's head dim and the planned blocks, the loss and every
    gradient against the independent plain step (compared leaf by leaf),
    then the calls' and the step's times."""
    from repro_torch.runtime import train as tr

    planned_loss = tr.make_loss_fn(cfg, tcfg)
    calls: dict = {}
    with hold_launches(torch, kernels, results, calls):
        loss, got, planned_peak = step1(torch, planned_loss, params0, batch0)
    flash = [c for c in calls.values() if c["kernel"] == "flash_attention"]
    s_attn = plans["attn"]
    check(bool(flash) and all(
        c["shapes"][0][-1] == cfg.resolved_head_dim
        and (c["kw"]["block_q"], c["kw"]["block_kv"]) == (s_attn.block("block_q"),
                                                          s_attn.block("block_kv"))
        for c in flash), f"{cfg.name}: flash launched off its plan: "
                         f"{[(c['shapes'], c['kw']) for c in flash]}")
    plain = functools.partial(plain_transformer_loss, torch, cfg, remat=tcfg.remat != "none")
    ref_loss, ref, plain_peak = step1(torch, plain, params0, batch0)
    grad_err = {}
    for k in list(ref):
        g = ref.pop(k)
        check(bool(torch.isfinite(got[k]).all()), f"{cfg.name}: grad {k} is not finite")
        grad_err[k] = {"max_abs_err": max_err(got[k], g), "scale": scale(g)}
        del g
    del got, ref
    torch.cuda.empty_cache()
    check(abs(loss - ref_loss) <= LOSS_TOL * max(1.0, abs(ref_loss)),
          f"{cfg.name}: step-1 loss {loss} vs plain step {ref_loss}")
    for k, r in grad_err.items():
        check(r["max_abs_err"] <= TOL * r["scale"], f"{cfg.name}: step-1 grad {k}: {r}")
    times = dense_call_times(torch, kernels, calls, cfg.n_heads, cfg.n_kv_heads)
    step = dense_step_times(torch, lambda: step1(torch, planned_loss, params0, batch0))
    return dict(loss=loss, plain_loss=ref_loss, peak_memory_bytes={
        "planned": planned_peak, "plain step": plain_peak},
        worst_grad_err_over_scale=max(r["max_abs_err"] / r["scale"]
                                      for r in grad_err.values()),
        step1_grads=grad_err, calls=times, step=step)


def dense_train(torch, kernels, results, card, arch: str, *, layers, batch: int, seq: int,
                steps: int, remat: str, launcher: bool) -> dict:
    """One dense config's planned training at full width: the launcher
    (``launcher``) or the train step driven here (a config cut to
    ``layers``), with its launches against plan_training's, finite losses,
    and dense_parity from the seed's weights."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as tf
    from repro_torch.models.module import count_params, init_params
    from repro_torch.models.registry import make_data_source
    from repro_torch.plan import AttentionPlanner
    from repro_torch.runtime import train as tr

    t_arch = time.perf_counter()
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
    path = f"train_{arch}"
    plans = tf.plan_training(cfg, batch, seq, loss_chunks=tfm_chunks())
    Dh = cfg.resolved_head_dim
    check(plans["attn"] == AttentionPlanner().plan(
        seq_q=seq, seq_kv=seq, head_dim=Dh, n_q_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, batch=batch, in_bytes=4, causal=True),
        f"{arch}: the attention cell is not planned at head dim {Dh}")
    per_step = {k: n + remat_extra(remat, cfg).get(k, 0) for k, n in
                per_kernel(tfm_calls(tf, cfg, plans, batch, seq), kernels).items()}
    tcfg = launcher_tcfg(steps, planned_kernels=True, remat=remat)
    defs = tf.param_defs(cfg)
    batch0 = tr.batch_to(make_data_source(cfg, batch, seq, ShardInfo(0, 1), seed=SEED)(0),
                         "cuda")
    torch.cuda.empty_cache()
    memory_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if launcher:
        zero_counts(kernels)
        history = launch.main(["--arch", arch, "--batch", str(batch), "--seq", str(seq),
                               "--steps", str(steps), "--planned-kernels", "--seed", str(SEED),
                               "--log-every", "1", "--remat", remat])
        torch.cuda.synchronize()
        got = {k: kk.launches for k, kk in kernels.items()}
        train_peak = torch.cuda.max_memory_allocated()
        losses, step_ms = [h["loss"] for h in history], [h["seconds"] * 1e3 for h in history]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params0 = init_params(defs, SEED)  # the launcher's weights
    else:
        # Drawn on the card: numpy takes about 10 s for one 778 M-value
        # embedding.
        params0 = device_params(torch, defs, SEED, noise=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    parity = dense_parity(torch, kernels, results, cfg, tcfg, plans, params0, batch0)
    if not launcher:
        state = tr.init_state(cfg, tcfg, params0)
        step_fn = tr.make_train_step(cfg, tcfg)
        src = make_data_source(cfg, batch, seq, ShardInfo(0, 1), seed=SEED)
        del params0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        losses, step_ms = [], []
        for i in range(steps):
            b = tr.batch_to(src(i), "cuda")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, b)
            end.record()
            losses.append(float(m["loss"]))
            step_ms.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        got = {k: kk.launches for k, kk in kernels.items()}
        train_peak = torch.cuda.max_memory_allocated()
        del state
    else:
        del params0
    torch.cuda.empty_cache()
    want = {k: steps * n for k, n in per_step.items()}
    for k in kernels:
        results[k]["launches_by_path"][path] = got[k]
    rec = dict(phase="dense", path=path, arch=arch, trainer="launcher" if launcher else
               "runtime.train.make_train_step", params=count_params(defs),
               n_layers=cfg.n_layers, of_layers=full.n_layers, d_model=cfg.d_model,
               heads=[cfg.n_heads, cfg.n_kv_heads, Dh], d_ff=cfg.d_ff, vocab=cfg.vocab,
               batch=batch, seq=seq, steps=steps, remat=remat, launches=got,
               launches_per_step=per_step, losses=losses, step_ms=step_ms,
               train_peak_memory_bytes=train_peak, allocated_at_start=memory_at_start,
               init_params_seconds=init_s,
               attn_schedule={"head_dim": Dh, "blocks": plans["attn"].block_dict()},
               schedules={n: {"algorithm": sc.algorithm, "blocks": sc.block_dict(),
                              "smem_bytes": sc.vmem_bytes} for n, sc in plans.items()},
               card=card, grad_tolerance=TOL, loss_tolerance=LOSS_TOL,
               **{k: v for k, v in parity.items() if k != "step1_grads"})
    rec["arch_seconds"] = time.perf_counter() - t_arch
    emit(**rec)
    check(got == want, f"{arch}: launches {got} != plan {want}")
    check(all(math.isfinite(x) for x in losses), f"{arch}: losses {losses}")
    check(abs(losses[0] - parity["loss"]) <= LOSS_TOL * max(1.0, abs(parity["loss"])),
          f"{arch}: the run's step-1 loss {losses[0]} vs the parity step's {parity['loss']}")
    return rec


def phase_dense_serve(torch, kernels, results, card) -> None:
    """gemma3-4b at full width and depth served through the engine on the
    DENSE_SERVE_LADDER, as phase serve serves qwen1.5-0.5b (weights drawn
    on the card by device_params, as phase moe_serve's): boot 1 tunes the
    bucket cells on the matmul and flash-attention kernels (path
    ``dense_serve_warmup``: flash at D = 256, the logits at vocab 262144),
    boot 2 replays them cache-only with the timing path rigged to raise;
    the request path launches no kernel; the slot decode runs each layer's
    window (5 local layers of 1024 to 1 global).  Checks: every request
    DONE, boot 2's streams equal boot 1's, each tuned winner against the
    kernels' plain versions at its cell's shape, a prompt past the window
    decoded against no-cache forwards.  Times: prefill per bucket and the
    slot decode (events and profiled)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.module import count_params
    from repro_torch.plan import autotune as at
    from repro_torch.serve import DONE, LoadSpec
    from repro_torch.serve.loadgen import no_timing

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(DENSE_SERVE_ARCH), max_seq=DENSE_SERVE_MAX_SEQ)
    defs = tf.param_defs(cfg)
    t0 = time.perf_counter()
    params = device_params(torch, defs, SEED)
    draw_s = time.perf_counter() - t0
    path = SCRATCH / "dense_serve_autotune_h100.json"
    path.unlink(missing_ok=True)
    spec = LoadSpec(qps=1.0, n_requests=SERVE_REQUESTS, prompt_len=DENSE_SERVE_PROMPT,
                    new_tokens=SERVE_NEW, seed=SEED)
    boot = functools.partial(serve_boot, torch, cfg, params, ladder=DENSE_SERVE_LADDER,
                             max_seq=DENSE_SERVE_MAX_SEQ)

    zero_counts(kernels)
    engine, src1, warm_tune = boot("tune", path)
    tune_launches = {k: kk.launches for k, kk in kernels.items()}
    for k in kernels:
        results[k]["launches_by_path"]["dense_serve_warmup"] = tune_launches[k]
    zero_counts(kernels)
    reqs1, serve1_s = serve_requests(torch, engine, spec)
    request_launches = {k: kk.launches for k, kk in kernels.items()}
    pool_bytes = sum(t.numel() * t.element_size() for t in engine.cache.values())
    stats1 = dict(engine.stats, padding_waste=engine.padding_waste())
    ladder = engine.ladder
    del engine
    torch.cuda.empty_cache()
    with no_timing(at):
        engine, src2, warm_cached = boot("cache-only", path)
        reqs2, serve2_s = serve_requests(torch, engine, spec)
    flat1 = {(b, c): s for b, cells in src1.items() for c, s in cells.items()}
    flat2 = {(b, c): s for b, cells in src2.items() for c, s in cells.items()}
    tuned = sorted((b, c) for (b, c), s in flat1.items() if s == "tuned")
    not_replayed = sorted(f"{b.batch}x{b.seq}:{c}" for b, c in tuned if flat2[(b, c)] != "cached")
    streams1 = [list(r.tokens) for r in reqs1]
    streams2 = [list(r.tokens) for r in reqs2]
    lens = [len(r.prompt) for r in reqs1]
    emit(phase="dense", path="serve_" + DENSE_SERVE_ARCH, arch=cfg.name,
         n_layers=cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
         window=[cfg.local_window, cfg.global_every], vocab=cfg.vocab,
         params=count_params(defs), weight_draw_seconds=draw_s, ladder=DENSE_SERVE_LADDER,
         max_seq=DENSE_SERVE_MAX_SEQ, slots=SERVE_SLOTS, requests=len(reqs1),
         prompt_lens=lens, past_window=sum(n > cfg.local_window for n in lens),
         new_tokens=[r.max_new_tokens for r in reqs1],
         warmup_seconds={"tune": warm_tune, "cache-only": warm_cached},
         serve_seconds={"boot1": serve1_s, "boot2": serve2_s}, cells=len(flat1),
         tuned=[f"{b.batch}x{b.seq}:{c}" for b, c in tuned],
         cached_boot2=sum(s == "cached" for s in flat2.values()), not_replayed=not_replayed,
         warmup_launches=tune_launches, request_launches=request_launches,
         stats_boot1=stats1, distinct_streams=len({tuple(t) for t in streams1}),
         single_token_streams=sum(len(set(t)) == 1 for t in streams1),
         streams_equal=streams1 == streams2, card=card)
    check(all(r.state == DONE for r in reqs1 + reqs2),
          f"dense serve: unfinished {[(r.rid, r.state) for r in reqs1 + reqs2 if r.state != DONE]}")
    check(streams1 == streams2, "dense serve: boot 2's token streams differ from boot 1's")
    check(bool(tuned) and not not_replayed,
          f"dense serve: tuned {tuned}, not replayed {not_replayed}")
    check("tuned" not in flat2.values(), "dense serve: the cache-only boot tuned a cell")
    check(tune_launches["matmul"] > 0 and tune_launches["flash_attention"] > 0,
          f"dense serve: warmup tuning launched {tune_launches}")
    check(not any(request_launches.values()),
          f"dense serve: the request path launched kernels {request_launches}")
    check(any(n > cfg.local_window for n in lens), "dense serve: no prompt passes the window")

    winners = serve_winner_checks(torch, kernels, results, cfg, ladder, tuned)
    emit(phase="dense", check="tuned winners vs plain", tolerance=TOL, cells=winners)

    prefill_ms = {}
    for b in engine.ladder.buckets:
        zt = torch.zeros((b.batch, b.seq), dtype=torch.int32, device="cuda")
        zl = torch.full((b.batch,), b.seq, dtype=torch.int32, device="cuda")
        prefill_ms[f"{b.batch}x{b.seq}"] = median_ms(
            lambda b=b, zt=zt, zl=zl: engine._prefill[b](params, zt, zl), reps=2, warmup=0)
    tok = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")
    at_pos = torch.full((SERVE_SLOTS,), DENSE_SERVE_MAX_SEQ // 2, dtype=torch.int32,
                        device="cuda")
    decode_fn = lambda: engine._decode(params, engine.cache, tok, at_pos)  # noqa: E731
    decode_ms = median_ms(decode_fn, reps=10)
    # Greedy streams on random weights may repeat one token (gemma's scaled,
    # tied embedding dominates the residual): the checks above compare
    # whole streams and every logit, so they stand; the counts are reported.
    decode_device_ms = profile(torch, "dense_slot_decode", decode_fn, card, grad=False,
                               reps=3, batch=f"{SERVE_SLOTS} slots at position "
                                             f"{DENSE_SERVE_MAX_SEQ // 2}")
    del engine
    torch.cuda.empty_cache()

    cache_check = cache_vs_no_cache(torch, cfg, params, DENSE_CACHE_CHECK, DENSE_SERVE_LADDER,
                                    DENSE_SERVE_MAX_SEQ)
    weight_bytes = 4 * count_params(defs)
    emit(phase="dense", check="cached decode vs no-cache forward", arch=cfg.name,
         prompt_len=DENSE_CACHE_CHECK[0], new_tokens=DENSE_CACHE_CHECK[1], tolerance=TOL,
         **cache_check)
    emit(phase="dense", check="serve times", arch=cfg.name, card=card, prefill_ms=prefill_ms,
         decode_ms_per_step=decode_ms, decode_device_ms_per_step=decode_device_ms,
         decode_slots=SERVE_SLOTS, decode_position=DENSE_SERVE_MAX_SEQ // 2,
         weight_bytes=weight_bytes, decode_bound_ms=weight_bytes / HBM_BW * 1e3,
         pool_bytes=pool_bytes, kv_bytes_per_token=pool_bytes // (SERVE_SLOTS
                                                                  * DENSE_SERVE_MAX_SEQ),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         phase_seconds=time.perf_counter() - t_phase)
    worst = cache_check["worst_err_over_scale"]
    check(worst <= TOL, f"dense serve: cached logits vs no-cache forward {worst} > {TOL}")
    del params
    torch.cuda.empty_cache()


def phase_dense(torch, kernels, results, card) -> None:
    """The twelfth slice: the flash kernel in the two new configs' cases
    against its plain version (timed beside SDPA where there is no window);
    qwen3-1.7b through the launcher at full width and depth, qwen3-32b and
    chameleon-34b at full width cut to DENSE_CUT_LAYERS, each with its
    launches against plan_training's and its step-1 loss and gradients
    against the independent plain step; gemma3-4b served."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for spec in DENSE_FLASH:
        case = flash_case(torch, g, spec)
        check_flash_case(torch, case, results, "dense")
        label, (q, k, v), kw, meta = case
        b, hq, hkv = meta["b"], meta["hq"], meta["hkv"]
        lib = None
        if kw["window"] is None:
            q4 = q.reshape(b, hq, *q.shape[1:])
            k4, v4 = (t.reshape(b, hkv, *t.shape[1:]).repeat_interleave(hq // hkv, 1)
                      for t in (k, v))
            lib = lambda q4=q4, k4=k4, v4=v4: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, is_causal=True)
        ms = median_ms(lambda: flash_attention_kernel(q, k, v, **kw), reps=10)
        plain_ms = median_ms(lambda: flash_attention_kernel.plain(q, k, v, **kw), reps=5)
        lib_ms = median_ms(lib, reps=10) if lib is not None else None
        b_ms, b_by = bound_ms(meta["flops"], meta["nbytes"])
        emit(phase="dense", kernel="flash_attention", case=label, card=card, ms=ms,
             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
             bound_share=b_ms / ms, flops=meta["flops"], bytes=meta["nbytes"], peaks=PEAKS)
        del case, q, k, v, lib
    torch.cuda.empty_cache()
    dense_train(torch, kernels, results, card, DENSE_ARCH, layers=None, batch=TFM_BATCH,
                seq=TFM_SEQ, steps=STEPS, remat=DENSE_REMAT, launcher=True)
    for arch in DENSE_CUT:
        dense_train(torch, kernels, results, card, arch, layers=DENSE_CUT_LAYERS,
                    batch=DENSE_CUT_BATCH, seq=TFM_SEQ, steps=DENSE_CUT_STEPS, remat="none",
                    launcher=False)
    phase_dense_serve(torch, kernels, results, card)
    emit(phase="dense", phase_seconds=time.perf_counter() - t_phase)


# -- phase mesh: R ranks sharing the one card over gloo -------------------------------


def mesh_inputs(torch, cnn, cfg) -> dict:
    """The seeded operands of cases (a) and (b), drawn on the card: every
    rank and the 1-rank reference draw the same values."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def rand(*shape, s=1.0):
        return torch.randn(shape, device="cuda", generator=g) * s

    out = {}
    for name, (m, k, n) in MESH_FC.items():
        out[name] = (rand(m, k), rand(k, n, s=k ** -0.5), rand(m, n))
    for name, x_shape, w_shape in cnn._stage_geometry(cfg, BATCH):
        if name in MESH_CONVS:
            ci, co = w_shape[2], w_shape[3]
            out[name] = (rand(*x_shape), rand(*w_shape, s=(9 * ci) ** -0.5), rand(co, s=0.1))
    return out


def mesh_batches(torch, cnn, cfg) -> list:
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.runtime import train as tr

    src = cnn.data_source(cfg, BATCH, ShardInfo(0, 1), seed=SEED)
    return [tr.batch_to(src(i), "cuda") for i in range(STEPS)]


def mesh_tcfg():
    from repro_torch.configs import TrainConfig

    return TrainConfig(param_dtype="float32", compute_dtype="float32", learning_rate=3e-4,
                       warmup_steps=1, total_steps=STEPS, seed=SEED, planned_kernels=True)


def mesh_reference(torch, cnn, cfg) -> dict:
    """The 1-rank results on the card: the planned fc_layer's output and
    gradients, the planned conv2d op's output, and 3 planned AdamW steps of
    cnn-vgg11 at batch 256 (losses and final parameters), all on the CPU."""
    from repro_torch.core.fc_layer import fc_layer
    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.models.module import init_params
    from repro_torch.runtime import train as tr

    ref, inputs = {}, mesh_inputs(torch, cnn, cfg)
    for name in MESH_FC:
        x, w, gy = inputs[name]
        x, w = x.requires_grad_(True), w.requires_grad_(True)
        y = fc_layer(x, w)
        gx, gw = torch.autograd.grad((y * gy).sum(), (x, w))
        ref[name] = {"y": y.detach().cpu(), "gx": gx.cpu(), "gw": gw.cpu()}
    for name in MESH_CONVS:
        x, f, b = inputs[name]
        ref[name] = conv2d(x, f, bias=b, stride=1, padding=1, relu=True, pool=2).cpu()
    tcfg = mesh_tcfg()
    step = tr.make_train_step(cfg, tcfg)
    params0 = init_params(cnn.param_defs(cfg), SEED)
    batches = mesh_batches(torch, cnn, cfg)
    _, grads = tr.loss_and_grads(tr.make_loss_fn(cfg, tcfg), params0, batches[0])
    state = tr.init_state(cfg, tcfg, params0)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    ref["dp"] = {"losses": losses, "params": {k: v.cpu() for k, v in state.params.items()},
                 "step1_grads": {k: g.cpu() for k, g in grads.items()}}
    torch.cuda.synchronize()
    return ref


def gloo_cuda_probe(torch) -> dict:
    """Which gloo collectives take CUDA tensors (a record, not a path; the
    transport uses these four).  Point-to-point is left out: gloo's send of
    a CUDA tensor aborts the process (gloo::IoException from writev)."""
    import datetime

    import torch.distributed as dist

    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=30))
    n = dist.get_world_size()
    t = torch.ones(4, device="cuda")
    probes = {
        "all_reduce": lambda: dist.all_reduce(t.clone(), group=group),
        "broadcast": lambda: dist.broadcast(t.clone(), 0, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(n)], t,
                                              group=group),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(4 * n, device="cuda"), torch.ones(4 * n, device="cuda"),
            group=group),
    }
    out = {}
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except Exception as e:  # noqa: BLE001 - the probe records the refusal
            out[name] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def mesh_cases(torch, rank: int, world: int, work: Path) -> dict:
    """One rank's cases (a)-(c) (see the module docstring), checked against
    the reference the parent saved; returns this rank's record."""
    from repro_torch.configs import get_config
    from repro_torch.core import conv_layer as cl
    from repro_torch.core.fc_layer import fc_layer_sharded
    from repro_torch.core.schedule_sim import simulate_ring
    from repro_torch.kernels.conv2d.bwd import conv2d_wgrad_kernel
    from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
    from repro_torch.kernels.matmul.bwd import (
        matmul_dxdw_kernel, matmul_nt_kernel, matmul_tn_kernel,
    )
    from repro_torch.kernels.matmul.matmul import matmul_kernel
    from repro_torch.models import cnn
    from repro_torch.models.module import init_params
    from repro_torch.plan import get_op
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime import train as tr
    from repro_torch.runtime.parallel import ParallelCtx

    kernels = {"conv2d": conv2d_kernel, "matmul": matmul_kernel,
               "conv2d_wgrad": conv2d_wgrad_kernel, "matmul_nt": matmul_nt_kernel,
               "matmul_tn": matmul_tn_kernel, "matmul_dx_dw": matmul_dxdw_kernel}
    cfg = get_config("cnn-vgg11")
    ref = torch.load(work.parent / "ref.pt")
    inputs = mesh_inputs(torch, cnn, cfg)
    rec = {"rank": rank, "fc": {}, "conv": {}}
    failed = []

    def err(got, want, what: str) -> dict:
        if tuple(got.shape) != tuple(want.shape):
            failed.append(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
            return {"shape": list(got.shape), "want_shape": list(want.shape)}
        e, sc = max_err(got.cpu(), want), scale(want)
        if not e <= TOL * sc:
            failed.append(f"{what}: err {e} > {TOL} x {sc}")
        return {"max_abs_err": e, "scale": sc}

    # (a) fc_layer_sharded over a model axis of R, and (b) the conv partitions.
    zero_counts(kernels)
    model = coll.Mesh((world,), ("model",))
    mm = get_op("matmul")
    for name, (m, k, n) in MESH_FC.items():
        x0, w0, gy = inputs[name]
        hops = simulate_ring(m=m, n=n, k=k, devices=world).intercluster // (m * k // world)
        for st in MESH_STRATEGIES:
            picked = mm.plan_sharded(x0, w0, mesh=model, axis="model", strategy=st).strategy
            x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
            coll.STATS.reset()
            y = fc_layer_sharded(x, w, model, axis="model", strategy=st)
            fwd = dict(coll.STATS.calls)
            gx, gw = torch.autograd.grad((y * gy).sum(), (x, w))
            tag = f"{name}.{st or 'auto'}"
            r = {"strategy": picked, "y": err(y.detach(), ref[name]["y"], f"{tag} y"),
                 "gx": err(gx, ref[name]["gx"], f"{tag} gx"),
                 "gw": err(gw, ref[name]["gw"], f"{tag} gw"),
                 "collectives": dict(coll.STATS.calls)}
            if picked == "ring":
                r["ppermutes_fwd"] = fwd.get("ppermute", 0)
                r["simulate_ring_hops"] = hops // world
                check(r["ppermutes_fwd"] == hops // world == world - 1,
                      f"rank {rank} {name}: ring permutes {fwd} vs simulate_ring {hops}")
            rec["fc"][tag] = r
    conv = get_op("conv2d")
    for name in MESH_CONVS:
        x, f, b = inputs[name]
        for st in ("batch", "stack"):
            ss = conv.plan_sharded(x, f, b, mesh=model, axis="model", strategy=st,
                                   padding=1, pool=2)
            out = conv.sharded(x, f, b, schedule=ss, mesh=model, padding=1, relu=True, pool=2)
            rec["conv"][f"{name}.{st}"] = dict(err(out, ref[name], f"{name}.{st}"),
                                               algorithm=ss.algorithm,
                                               local_blocks=dict(ss.schedule.blocks),
                                               shapes=[list(t.shape) for t in (x, f, b)])
    torch.cuda.synchronize()
    rec["case_launches"] = {n: k.launches for n, k in kernels.items()}

    # (c) the data-parallel cnn-vgg11 step on a data axis of R.
    ctx = ParallelCtx(mesh=coll.Mesh((world,), ("data",)), dp_axes=("data",))
    tcfg = mesh_tcfg()
    plan = cnn.plan_training(cfg, BATCH, mesh=ctx.plan_mesh(), shard_axis="data",
                             shard_strategy="batch")
    local = {k: s.schedule for k, s in plan.items()}
    calls = train_calls(cnn, cl, cfg, local, BATCH // world)
    want = {k: STEPS * n for k, n in per_kernel(calls, kernels).items()}
    params0 = init_params(cnn.param_defs(cfg), SEED)
    batches = mesh_batches(torch, cnn, cfg)
    step = tr.make_train_step(cfg, tcfg, parallel=ctx)
    state = tr.init_state(cfg, tcfg, params0)
    zero_counts(kernels)
    coll.STATS.reset()
    losses, ms = [], []
    for b in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, b)
        end.record()
        end.synchronize()
        losses.append(float(m["loss"]))
        ms.append(start.elapsed_time(end))
    got = {n: k.launches for n, k in kernels.items()}
    check(got == want, f"rank {rank}: mesh launches {got} != sharded plan {want}")
    stats = coll.STATS.as_dict()
    for a, b in zip(losses, ref["dp"]["losses"]):
        if not abs(a - b) <= LOSS_TOL * max(1.0, abs(b)):
            failed.append(f"losses {losses} vs {ref['dp']['losses']}")

    # One more step with every collective synchronized: its host time apart.
    coll.STATS.reset(sync=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    step(state, batches[0])
    end.record()
    end.synchronize()
    synced = dict(coll.STATS.as_dict(), step_ms=start.elapsed_time(end))
    coll.STATS.reset()

    # Step-1 gradients against the plain step on the ranks' own decisions.
    shard = tr.shard_batch(cfg, ctx, batches[0])
    loss1, grads = tr.loss_and_grads(tr.make_loss_fn(cfg, tcfg, ctx), params0, shard)
    loss1, grads = tr.all_reduce_mean(ctx, loss1, grads)
    mine = planned_decisions(torch, cfg, params0, shard["images"], local)
    decisions = {k: coll.all_gather(v.to(torch.uint8) if v.dtype == torch.bool else v,
                                    ctx.mesh, "data", 0) for k, v in mine.items()}
    decisions["fc1"] = decisions["fc1"].bool()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params0.items()}
    plain = decided_plain_loss(torch, cfg, leaves, batches[0], decisions)
    pgrads = dict(zip(leaves, torch.autograd.grad(plain, list(leaves.values()))))
    plain_loss = float(plain.detach())
    if not abs(float(loss1) - plain_loss) <= LOSS_TOL * max(1.0, abs(plain_loss)):
        failed.append(f"step-1 loss {float(loss1)} vs {plain_loss}")
    step1 = {k: err(g, pgrads[k].cpu(), f"step-1 grad {k}") for k, g in grads.items()}
    # The parameters after 3 steps against the 1-rank planned step's.  Its
    # forward decides near-tie pools apart from the ranks' (each of the two
    # steps' gradients is held against a plain step on its own decisions),
    # so step-1 gradients differ by up to D a leaf, and AdamW's first update
    # is about lr x sign(g): an element whose step-1 gradient lies within D
    # of zero may take the other sign.  Such elements may differ past
    # TOL x scale, and no more than MESH_NEAR_TIE_SHARE of a leaf; every
    # other element must agree within it.
    params = {}
    for k, v in state.params.items():
        want, got_p = ref["dp"]["params"][k].double(), v.cpu().double()
        g1 = ref["dp"]["step1_grads"][k].double()
        d = float((grads[k].cpu().double() - g1).abs().max())
        off = (got_p - want).abs() > TOL * scale(want)
        away = off & (g1.abs() > d)
        params[k] = {"max_abs_err": max_err(got_p, want), "scale": scale(want),
                     "step1_grad_diff": d, "n_past_tol": int(off.sum()),
                     "n_past_tol_away_from_ties": int(away.sum()), "numel": want.numel()}
        if away.any() or off.sum() > max(2, MESH_NEAR_TIE_SHARE * want.numel()):
            failed.append(f"params {k}: {params[k]}")
    rec["dp"] = {"losses": losses, "reference_losses": ref["dp"]["losses"], "step_ms": ms,
                 "params_after_3": params, "step1_grads": step1, "launches": got,
                 "launches_per_step": {k: n // STEPS for k, n in got.items()},
                 "collectives": stats, "synced_step": synced,
                 "local_batch": BATCH // world,
                 "plan_words": {"hbm": sum(s.hbm_words for s in plan.values()),
                                "ici": sum(s.ici_words for s in plan.values())}}
    if world == 2:
        rec["gloo_cuda_probe"] = gloo_cuda_probe(torch)
    rec["failed"] = failed
    return rec


def mesh_rank(rank: int, world: int, work: Path) -> int:
    """The entry of one rank process (``chip_smoke.py --mesh-rank``)."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        rec = mesh_cases(torch, rank, world, work)
    finally:
        dist.destroy_process_group()
    (work / f"rank{rank}.json").write_text(json.dumps(rec))
    check(not rec["failed"], f"rank {rank}: {rec['failed']}")
    return 0


def phase_mesh(torch, cnn, cfg, kernels, results, card) -> set:
    """Cases (a)-(c) on R ranks sharing the card; the 1-rank reference
    first, in this process.  Returns the kernels the data-parallel plan
    launches."""
    from repro_torch.core import conv_layer as cl

    t0 = time.perf_counter()
    base = SCRATCH / "mesh"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    torch.save(mesh_reference(torch, cnn, cfg), base / "ref.pt")
    zero_counts(kernels)
    for name in kernels:
        results[name]["launches_by_path"].setdefault("mesh", 0)
        results[name]["launches_by_path"].setdefault("mesh_cases", 0)
    for world in MESH_RANKS:
        work = base / f"r{world}"
        work.mkdir()
        t_ranks = time.perf_counter()
        logs = [open(work / f"rank{r}.log", "w") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                                   str(r), str(world), str(work)],
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(world)]
        deadline = time.monotonic() + MESH_TIMEOUT
        try:
            # A rank that fails leaves the others waiting in a collective:
            # stop them all at the first failure (or at the deadline).
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        recs = [json.loads((work / f"rank{r}.json").read_text())
                for r in range(world) if (work / f"rank{r}.json").exists()]
        bad = [(r, p.returncode, (work / f"rank{r}.log").read_text()[-3000:])
               for r, p in enumerate(procs) if p.returncode]
        if bad:
            emit(phase="mesh", ranks=world, failed=True, ranks_records=recs)
        check(not bad, f"mesh ranks failed (or outlived {MESH_TIMEOUT} s): {bad}")
        for name in kernels:
            results[name]["launches_by_path"]["mesh"] += sum(
                r["dp"]["launches"].get(name, 0) for r in recs)
            results[name]["launches_by_path"]["mesh_cases"] += sum(
                r["case_launches"].get(name, 0) for r in recs)
        emit(phase="mesh", ranks=world, card=card,
             setup=f"{world} processes sharing one H100 over gloo (which stages CUDA "
                   "tensors through host memory); not multi-chip or scaling numbers",
             seconds=time.perf_counter() - t_ranks, tolerance=TOL, loss_tolerance=LOSS_TOL,
             ranks_records=recs)
    shutil.rmtree(base, ignore_errors=True)
    emit(phase="mesh", seconds=time.perf_counter() - t0)
    # The kernels the data-parallel plan launches (the same set at every R).
    local = {k: v.schedule for k, v in cnn.plan_training(
        cfg, BATCH, mesh={"data": MESH_RANKS[0]}, shard_axis="data",
        shard_strategy="batch").items()}
    calls = train_calls(cnn, cl, cfg, local, BATCH // MESH_RANKS[0])
    return {k for k, n in per_kernel(calls, kernels).items() if n}


def main() -> int:
    t_script = time.perf_counter()
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of phase mesh
        return mesh_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.conv2d.bwd import conv2d_wgrad_kernel
    from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul.bwd import (
        matmul_dxdw_kernel, matmul_nt_kernel, matmul_tn_kernel,
    )
    from repro_torch.kernels.matmul.matmul import matmul_kernel
    from repro_torch.models import cnn
    from repro_torch.models.module import count_params, init_params

    # The plain versions are f32 references only with TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    phase_build()
    print(card, flush=True)

    cfg = get_config("cnn-vgg11")
    plans = {alg: cnn.plan_forward(cfg, BATCH, conv_algorithm=None if alg == "default" else alg)
             for alg in ("default", "direct", "im2col")}
    kernels = {"conv2d": conv2d_kernel, "matmul": matmul_kernel,
               "conv2d_wgrad": conv2d_wgrad_kernel, "matmul_nt": matmul_nt_kernel,
               "matmul_tn": matmul_tn_kernel, "matmul_dx_dw": matmul_dxdw_kernel,
               "flash_attention": flash_attention_kernel}
    results = {name: {"max_abs_err": 0.0, "launches_by_path": {}, "calls": [],
                      "tfm_calls": []}
               for name in kernels}

    phase_kernels(torch, plans, cnn, cfg, results)
    phase_bwd(torch, cnn, cfg, kernels, results)

    defs = cnn.param_defs(cfg)
    params = init_params(defs, SEED)
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.standard_normal((BATCH, cnn.IMG, cnn.IMG, cnn.IN_CH), dtype=np.float32)).cuda()
    emit(phase="model", config=cfg.name, params=count_params(defs), batch=BATCH, seed=SEED)
    phase_forward(torch, plans, cnn, cfg, params, images, kernels, results)
    train = phase_train(torch, cnn, cfg, kernels, results)
    phase_accum(torch, cnn, cfg, kernels, results, card)
    ef_state = phase_int8_ef(torch, cnn, cfg, kernels, results)
    phase_ckpt(torch, cnn, cfg, kernels, results, ef_state, card)
    del ef_state
    for name in phase_mesh(torch, cnn, cfg, kernels, results, card):
        check(results[name]["launches_by_path"]["mesh"] > 0,
              f"{name}: no launch on the mesh path")

    from repro_torch.models import transformer as tf

    tcfg = get_config(TFM_ARCH)
    s_attn = tf.plan_forward(tcfg, TFM_BATCH, TFM_SEQ, loss_chunks=tfm_chunks())["attn"]
    phase_flash(torch, s_attn, results)
    tfm = phase_transformer(torch, kernels, results)
    phase_remat(torch, kernels, results, tfm, card)
    phase_serve(torch, kernels, results, tfm, card)
    paths = {"conv2d": "forward", "matmul": "forward", "conv2d_wgrad": f"train_b{BATCH}",
             "matmul_nt": f"train_b{BATCH}", "matmul_tn": f"train_b{BATCH}",
             "matmul_dx_dw": f"train_b{FUSED_BATCH}", "flash_attention": TFM_PATH}
    for name, r in results.items():
        check(r["launches_by_path"][paths[name]] > 0,
              f"{name}: no launch on the {paths[name]} path")

    phase_times(torch, plans, cnn, cfg, params, images, card, results, kernels, train)
    del train
    torch.cuda.empty_cache()
    phase_times_transformer(torch, card, results, kernels, tfm)
    del tfm
    torch.cuda.empty_cache()
    phase_autotune(torch, cnn, cfg, kernels, results, card)
    del params, images, plans
    phase_moe_serve(torch, kernels, results, card)
    for name in ("matmul", "flash_attention"):
        check(results[name]["launches_by_path"]["moe_serve_warmup"] > 0,
              f"{name}: no launch on the moe_serve_warmup path")
    phase_dense(torch, kernels, results, card)
    for dense_path in [f"train_{a}" for a in (DENSE_ARCH, *DENSE_CUT)] + ["dense_serve_warmup"]:
        for name in ("matmul", "flash_attention"):
            check(results[name]["launches_by_path"][dense_path] > 0,
                  f"{name}: no launch on the {dense_path} path")
    phase_families(torch, card)
    phase_paper(torch, kernels, results, card)
    for name in ("conv2d", "matmul"):
        check(results[name]["launches_by_path"]["paper"] > 0,
              f"{name}: no launch on the paper path")

    def step_sums(calls):
        total = {key: sum(c[key] * c["per_step"] for c in calls)
                 for key in ("ms", "plain_ms", "bound_ms")}
        libs = [c["library_ms"] for c in calls]
        total["library_ms"] = (None if any(v is None for v in libs)
                               else sum(c["library_ms"] * c["per_step"] for c in calls))
        total["bound_by"] = max(calls, key=lambda c: c["bound_ms"])["bound_by"]
        for key in ("device_ms", "pair_library_ms", "pair_library_device_ms", "pair_port_ms",
                    "pair_port_device_ms"):
            if all(key in c for c in calls):
                total[key] = sum(c[key] * c["per_step"] for c in calls)
        return total

    check(DETERMINED == DETERMINISM, f"determinism checks run: {sorted(DETERMINED)}")
    entries = []
    for name, r in results.items():
        # One training step's calls: cnn-vgg11's, or the transformer's for a
        # kernel only that step runs.
        cnn_calls = [c for c in r["calls"] if c["per_step"]]
        tfm_step = [c for c in r["tfm_calls"] if c["per_step"]]
        calls = cnn_calls or tfm_step
        check(bool(calls), f"{name}: no timed call of a training step")
        entry = dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{SOURCES[name]}.cu",
            replaces=REPLACES[name], launches=sum(r["launches_by_path"].values()),
            launches_by_path=r["launches_by_path"], max_abs_err=r["max_abs_err"],
            **step_sums(calls), per_step_of=cfg.name if cnn_calls else TFM_ARCH,
            per_step_batch=calls[0]["step_batch"])
        if cnn_calls and tfm_step:
            entry[f"{TFM_ARCH}_step"] = dict(step_sums(tfm_step),
                                             per_step_batch=tfm_step[0]["step_batch"])
        entries.append(entry)
    emit(script_seconds=time.perf_counter() - t_script)
    emit(kernels=entries)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
