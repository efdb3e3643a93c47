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

The last line is the device record ``{"ok": true, "device": {...}}``.  With
no card, or outside a checkout, it prints no result and exits nonzero.
"""

from __future__ import annotations

import contextlib
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
SCRATCH = ROOT / "build" / "chip_smoke"  # checkpoints and the winner cache


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
    device_ms = sum(r[0] for r in rows)
    emit(phase="profile", what=what, card=card, batch=batch, wall_ms_per_call=wall_ms,
         device_ms_per_call=device_ms if rows else "not measured",
         device_busy_share=device_ms / wall_ms if rows else "not measured",
         top=[{"kernel": k[:80], "ms": ms, "calls": c} for ms, k, c in rows[:16]])


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
    from repro_torch.plan import AttentionPlanner, round_up

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    B, S, H, D = TFM_BATCH, TFM_SEQ, 16, 64
    # label, B, Hq, Hkv, q_len, kv_len, D, window
    specs = [("main", B, H, H, S, S, D, None), ("gqa16/8-d128", B, 16, 8, S, S, 128, None),
             ("gqa16/8-d32", B, 16, 8, S, S, 32, None), ("gqa8/4-d256", B, 8, 4, S, S, 256, None),
             ("window512", B, H, H, S, S, D, 512), ("ragged1000", 1, 16, 16, 1000, 1000, D, None),
             ("zero-rows", 1, 16, 8, 1000, 500, D, 256)]
    out = []
    for label, b, hq, hkv, ql, kl, d, window in specs:
        s = s_attn if label == "main" else AttentionPlanner().plan(
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
        out.append((label, (q, k, v), kw, dict(flops=flops, nbytes=nbytes, b=b, hq=hq, hkv=hkv)))
    return out


def phase_flash(torch, s_attn, results):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel

    for label, (q, k, v), kw, _ in flash_cases(torch, s_attn):
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
        emit(phase="flash", kernel="flash_attention", case=label,
             shape=[list(t.shape) for t in (q, k, v)],
             blocks={"block_q": kw["block_q"], "block_kv": kw["block_kv"]},
             causal=kw["causal"], window=kw["window"], q_len=kw["q_len"],
             kv_len=kw["kv_len"], max_abs_err=err, max_abs_plain=float(want.abs().max()),
             rows_without_key=n_zero)
        if label == "main":
            check_bit_identical(torch, "flash_attention", "attn",
                                lambda: flash_attention_kernel(q, k, v, **kw))


def tfm_calls(tf, cfg, plans) -> dict:
    """Launches of each kernel that one planned transformer training step
    makes, by call: {(kernel, label): count}."""
    L = cfg.n_layers
    n_chunks = TFM_BATCH * TFM_SEQ // tf._chunk_m(TFM_BATCH, TFM_SEQ, tfm_chunks())
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


def plain_transformer_loss(torch, cfg, params, batch):
    """The independent plain step's loss: cuBLAS matmuls (TF32 off), RMSNorm
    and RoPE written out here, the port's attention_ref, chunked
    cross-entropy with F.cross_entropy; no kernel or layer of the port."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_ref

    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    B, S = tokens.shape
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
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

    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in layer.items()}
        h = norm(x, p["ln1"])

        def proj(w, b, heads):
            return (torch.matmul(h, w.reshape(d, heads * Dh)).reshape(B, S, heads, Dh) + b)

        q = rotate(proj(p["attn/wq"], p["attn/bq"], Hq))
        k = rotate(proj(p["attn/wk"], p["attn/bk"], Hkv))
        v = proj(p["attn/wv"], p["attn/bv"], Hkv)
        o = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
        x = x + torch.matmul(o.transpose(1, 2).reshape(B, S, Hq * Dh),
                             p["attn/wo"].reshape(Hq * Dh, d))
        h = norm(x, p["ln2"])
        x = x + torch.matmul(F.silu(h @ p["mlp/w_gate"]) * (h @ p["mlp/w_up"]), p["mlp/w_down"])
    x = norm(x, params["final_norm"]).reshape(B * S, d)
    total = 0.0
    for xc, lc in zip(x.chunk(tfm_chunks()), labels.reshape(-1).chunk(tfm_chunks())):
        total = total + F.cross_entropy(xc @ params["embed"].t(), lc, reduction="sum")
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
def spy_blocks(kernels, seen: set):
    """Record (kernel, blocks) of every launch while the block runs."""
    saved = {name: k.launch for name, k in kernels.items()}

    def wrap(name, fn):
        def spy(kern, *args, **kw):
            keys = (("block_h", "block_do", "block_di") if "block_do" in kw
                    else ("block_m", "block_n", "block_k"))
            seen.add((name, tuple(kw[b] for b in keys)))
            return fn(kern, *args, **kw)
        return spy

    for name, k in kernels.items():
        k.launch = wrap(name, saved[name])
    try:
        yield
    finally:
        for name, fn in saved.items():
            kernels[name].launch = fn


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


def main() -> int:
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

    from repro_torch.models import transformer as tf

    tcfg = get_config(TFM_ARCH)
    s_attn = tf.plan_forward(tcfg, TFM_BATCH, TFM_SEQ, loss_chunks=tfm_chunks())["attn"]
    phase_flash(torch, s_attn, results)
    tfm = phase_transformer(torch, kernels, results)
    phase_remat(torch, kernels, results, tfm, card)
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
    emit(kernels=entries)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
