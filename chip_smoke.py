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
             int8 mask must agree except at near-ties.
3. forward — the planned cnn-vgg11 forward at full width, batch 256, with
             the default algorithm argmin, with every conv stage direct and
             with every conv stage im2col; logits against the plain forward
             at the phase-2 tolerance, launch counts against the plan.
4. times   — CUDA-event medians of each kernel at every stage's shape,
             beside its plain version, one library call and the bound; the
             whole forward's ms per batch and images/s; device time by
             kernel over a profiled window.  The ``kernels`` line sums each
             kernel's calls over one default-plan forward.

The last line is the device record ``{"ok": true, "device": {...}}``.  With
no card, or outside a checkout, it prints no result and exits nonzero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 256
SEED = 0
TOL = 1e-4
NEAR_TIE = 1e-5
PEAK_F32 = 67e12  # H100 SXM, f32 on the CUDA cores (the kernels' FMAs)
HBM_BW = 3.35e12  # H100 SXM, bytes/s
PEAKS = "f32 CUDA cores 67 TFLOP/s, HBM3 3.35 TB/s (H100 SXM data sheet, 700 W)"
REPLACES = {
    "matmul": "src/repro/kernels/matmul/matmul.py:32",
    "conv2d": "src/repro/kernels/conv2d/conv2d.py:49",
}


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
    belongs to the all-direct or all-im2col forward only)."""
    stage = label.split(".")[0]
    s = plans["default"].get(stage)
    return stage_launches(stage, s)[kernel] if s is not None else 0


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
                 near_ties=n_near)
    for label, args, kw in matmul_cases(torch, plans, cnn, cfg):
        got = matmul_kernel(*args, **kw)
        want = matmul_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err <= TOL * scale(want), f"matmul {label}: err {err}")
        results["matmul"]["max_abs_err"] = max(results["matmul"]["max_abs_err"], err)
        emit(phase="kernels", kernel="matmul", case=label, shape=[list(a.shape) for a in args],
             blocks=kw, max_abs_err=err, max_abs_plain=float(want.abs().max()))
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
    for k in kernels.values():
        k.launches = 0
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
            want = expected_launches(plans[alg])
            check(launches == want, f"forward {alg}: launches {launches} != plan {want}")
            if alg == "default":
                for name in kernels:
                    results[name]["launches"] = launches[name]
            emit(phase="forward", conv_algorithm=alg, batch=BATCH, logits=list(logits.shape),
                 max_abs_err=err, max_abs_plain=float(plain.abs().max()), launches=launches,
                 schedules={n: {"algorithm": s.algorithm, "blocks": s.block_dict(),
                                "grid": list(s.grid), "smem_bytes": s.vmem_bytes}
                            for n, s in plans[alg].items()})


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32, nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_times(torch, plans, cnn, cfg, params, images, card, results):
    import torch.nn.functional as F

    from repro_torch.kernels.conv2d.conv2d import conv2d_fused_plain, conv2d_kernel
    from repro_torch.kernels.matmul.matmul import matmul_kernel, matmul_plain

    def record(name, label, fn, plain_fn, lib_fn, flops, nbytes):
        ms, plain_ms, lib_ms = median_ms(fn), median_ms(plain_fn), median_ms(lib_fn)
        b_ms, b_by = bound_ms(flops, nbytes)
        call = dict(case=label, per_forward=main_path_launches(plans, name, label), ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    flops=flops, bytes=nbytes, peaks=PEAKS)
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
               flops, nbytes)
    for label, (a, w), kw in matmul_cases(torch, plans, cnn, cfg):
        if label == "ragged":
            continue
        m, k = a.shape
        n = w.shape[1]
        record("matmul", label, lambda: matmul_kernel(a, w, **kw),
               lambda: matmul_plain(a, w, **kw), lambda: torch.matmul(a, w),
               2.0 * m * n * k, 4.0 * (m * k + k * n + m * n))

    with torch.no_grad():
        fwd = {alg: median_ms(lambda: cnn.forward(cfg, params, images, schedules=plans[alg]),
                              reps=10)
               for alg in ("default", "direct", "im2col")}
        plain_fwd = median_ms(lambda: cnn.forward(cfg, params, images, use_kernels=False), reps=10)
    emit(phase="times", forward_ms=fwd, plain_forward_ms=plain_fwd,
         images_per_s={alg: BATCH / (t / 1e3) for alg, t in fwd.items()}, batch=BATCH,
         card=card)
    profile_forward(torch, cnn, cfg, params, images, plans["default"], card)


def profile_forward(torch, cnn, cfg, params, images, plans, card):
    """Device time by kernel name over a few default-plan forwards
    (torch.profiler), and the device's busy share of that window."""
    from torch.profiler import ProfilerActivity, profile

    reps = 5
    with torch.no_grad():
        cnn.forward(cfg, params, images, schedules=plans)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                cnn.forward(cfg, params, images, schedules=plans)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    from torch.autograd import DeviceType

    # Device-side events only (kernels, copies): the aten ops that launched
    # them carry the same device time and would count it twice.
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == DeviceType.CUDA:
            rows.append((dev_us / reps / 1e3, ev.key, ev.count // reps))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    emit(phase="profile", card=card, wall_ms_per_forward=wall_ms,
         device_ms_per_forward=device_ms if rows else "not measured",
         device_busy_share=device_ms / wall_ms if rows else "not measured",
         top=[{"kernel": k[:80], "ms": ms, "calls": c} for ms, k, c in rows[:12]])


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
    from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
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
    kernels = {"conv2d": conv2d_kernel, "matmul": matmul_kernel}
    results = {name: {"max_abs_err": 0.0, "launches": 0, "calls": []} for name in kernels}

    phase_kernels(torch, plans, cnn, cfg, results)

    defs = cnn.param_defs(cfg)
    params = init_params(defs, SEED)
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.standard_normal((BATCH, cnn.IMG, cnn.IMG, cnn.IN_CH), dtype=np.float32)).cuda()
    emit(phase="model", config=cfg.name, params=count_params(defs), batch=BATCH, seed=SEED)
    phase_forward(torch, plans, cnn, cfg, params, images, kernels, results)
    for name, r in results.items():
        check(r["launches"] > 0, f"{name}: no launch on the main path")

    phase_times(torch, plans, cnn, cfg, params, images, card, results)

    entries = []
    for name, r in results.items():
        calls = [c for c in r["calls"] if c["per_forward"]]  # the default forward's calls
        total = {key: sum(c[key] * c["per_forward"] for c in calls)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        entries.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=REPLACES[name], launches=r["launches"], max_abs_err=r["max_abs_err"],
            ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
            bound_by=max(calls, key=lambda c: c["bound_ms"])["bound_by"],
            library_ms=total["library_ms"]))
    emit(kernels=entries)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
