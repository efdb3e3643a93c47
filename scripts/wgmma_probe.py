"""Probe the bf16 GEMMs (the forward matmul, NT and TN) and flash
attention on the tensor cores (``csrc/gemm_sm90.cuh``,
``csrc/flash_attention.cu``) and variants of them, on the card.

    python3 scripts/wgmma_probe.py [VARIANT ...]

With no VARIANT it builds the checkout's kernels; a VARIANT builds a copy
of ``csrc/`` (under the system's temporary directory) with one change to
a source and loads it in place of the checkout's libraries:

* ``promote-none``: the GEMMs' tensor cores sum the whole contraction (no
  promotion to the CUDA cores' register tile);
* ``promote-32``: promotion every 32 steps instead of 8;
* ``order-swapped``: each GEMM walks its grid in the other order (the
  forward and TN their output columns fastest, NT its rows);
* ``tn-order-swapped``: TN alone walks its dW columns fastest;
* ``wait-c-loop``: the barrier wait as a loop in C around one try_wait
  (ptxas then injects a ``warpgroup.wait``, its C7517 note);
* ``p-one-term``: flash multiplies V by P rounded to bf16 (one wgmma a key
  step) instead of P_hi + P_lo.

Each variant runs the sections it changes (the checkout all of them).
"gemm": one JSON line per check: the forward (bf16 out) at the
qwen1.5-0.5b step's shapes and a few small ones, its largest distance from
plain in bf16 ulps at max(|plain|, 2^-8 max|plain|); NT (f32 dX) and TN
(f32 dW) at the same shapes, each's largest error from plain beside
chip_smoke.py's gate (1e-5 of scale, times sqrt(K / 8192) past a
contraction K of 8192) and from the f64 product, beside plain's own; whether
two launches gave the same bits. Then one JSON line per shape with each
kernel's ms (CUDA events, the mean of 20 calls after one, 5 at the logits)
beside ``torch.matmul``'s (cuBLAS bf16) and the TFLOP/s. "flash": one JSON
line per case of chip_smoke.py's phase ``bf16_dense`` (a) (its
``BF16_FLASH``, at the planner's bf16 blocks): the kernel's template, its
largest distance from plain in bf16 ulps (chip_smoke.py's ``ulp_check``),
two launches' bits, its ms (median of 10 after 2, CUDA events) beside bf16
SDPA's. Every line carries the card's name and power limit. Each process
builds what it loads; run each variant in a process of its own, as the
command line does.
"""

from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

ASM_WAIT = '''  asm volatile(
      "{\\n"
      ".reg .pred p;\\n"
      "WAIT:\\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\\n"
      "@!p bra WAIT;\\n"
      "}\\n" ::"r"(bar),
      "r"(parity)
      : "memory");'''
C_WAIT = '''  uint32_t done;
  do {
    asm volatile("{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
                 " selp.u32 %0, 1, 0, p;\\n}\\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);'''
PROMOTE = "constexpr int kPromote = 8;"
ORDER = "constexpr bool kRowsFastest[3] = {true, false, true};  // forward, NT, TN"
HEADER, FLASH = "gemm_sm90.cuh", "flash_attention.cu"
# name -> (the source it edits, its (old, new) edits, the sections it runs)
VARIANTS = {
    "promote-none": (HEADER, [(PROMOTE, "constexpr int kPromote = 1 << 30;")], ("gemm",)),
    "promote-32": (HEADER, [(PROMOTE, "constexpr int kPromote = 32;")], ("gemm",)),
    "order-swapped": (HEADER, [(ORDER, ORDER.replace("true, false, true", "false, true, false"))],
                      ("gemm",)),
    "tn-order-swapped": (HEADER, [(ORDER, ORDER.replace("false, true}", "false, false}"))],
                         ("gemm",)),
    "wait-c-loop": (HEADER, [(ASM_WAIT, C_WAIT)], ("gemm",)),
    "p-one-term": (FLASH, [("constexpr int kPTerms = 2;", "constexpr int kPTerms = 1;")],
                   ("flash",)),
}
LIBS = ("matmul", "matmul_bwd", "flash_attention")

# (kind, m, k, n): forward X[m, k] . W[k, n]; NT dY[m, n] . W[k, n]^T; TN
# X[m, k]^T . dY[m, n] (dW[k, n], the contraction m)
CHECKS = [("fwd", 64, 32, 128), ("fwd", 192, 96, 384), ("fwd", 8192, 1024, 3072),
          ("fwd", 256, 4096, 1024), ("fwd", 8192, 2816, 1024), ("fwd", 2048, 1024, 151936),
          ("nt", 64, 128, 32), ("nt", 192, 384, 96), ("nt", 8192, 1024, 3072),
          ("nt", 256, 1024, 4096), ("nt", 8192, 2816, 1024), ("nt", 8192, 1024, 5632),
          ("nt", 2048, 1024, 151936),
          ("tn", 32, 64, 128), ("tn", 96, 192, 384), ("tn", 8192, 1024, 3072),
          ("tn", 8192, 1024, 1024), ("tn", 8192, 1024, 5632), ("tn", 8192, 2816, 1024),
          ("tn", 2048, 1024, 151936)]
# (m, k, n) of the qwen1.5-0.5b step: qkv, wo, mlp_up, mlp_down, a logits chunk
TIMED = [(8192, 1024, 3072), (8192, 1024, 1024), (8192, 1024, 5632), (8192, 2816, 1024),
         (2048, 1024, 151936)]


def load_variant(name: str) -> dict:
    """Build csrc/ with the variant's edits and load it in place of the
    checkout's libraries; the compilers' C7517 notes."""
    from repro_torch.kernels import _build

    source, edits, _ = VARIANTS[name]
    d = Path(tempfile.mkdtemp(prefix=f"wgmma_{name}_"))
    shutil.copytree(_build.CSRC, d / "csrc")
    path = d / "csrc" / source
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: {source} no longer has {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    procs = {lib: subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{lib}.so"),
                                    str(d / "csrc" / f"{lib}.cu")],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for lib in LIBS}
    notes = {}
    for lib, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed for {lib}:\n{log}")
        notes[lib] = [ln.strip() for ln in log.splitlines() if "C7517" in ln]
        so = ctypes.CDLL(str(d / f"{lib}.so"))
        so.repro_error_string.argtypes = [ctypes.c_int]
        so.repro_error_string.restype = ctypes.c_char_p
        _build._LIBS[lib] = so
    return notes


def f32_check(torch, got, again, want, exact, contraction) -> dict:
    """An f32 output (NT's dX, TN's dW) against plain (f64 ``want``) at
    chip_smoke.py's gate, and both against the f64 product."""
    err = float((got.double() - want).abs().max())
    gate = (1e-5 * max(1.0, math.sqrt(contraction / 8192))
            * max(1.0, float(want.abs().max())))
    return dict(max_abs_err=err, gate=gate, err_over_gate=err / gate,
                err_from_f64=float((got.double() - exact).abs().max()),
                plain_err_from_f64=float((want - exact).abs().max()),
                same_bits=bool(torch.equal(got, again)), ok=err <= gate)


def check(torch, kind, m, k, n) -> dict:
    from repro_torch.kernels.matmul.bwd import matmul_nt_kernel, matmul_tn_kernel
    from repro_torch.kernels.matmul.matmul import matmul_kernel

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    if kind == "tn":
        x = torch.randn(m, k, device="cuda", generator=g).to(bf)
        dy = (torch.randn(m, n, device="cuda", generator=g) * m ** -0.5).to(bf)
        kw = dict(block_m=32, block_n=128, block_k=64)
        got, again = matmul_tn_kernel(x, dy, **kw), matmul_tn_kernel(x, dy, **kw)
        return f32_check(torch, got, again, matmul_tn_kernel.plain(x, dy, **kw).double(),
                         torch.matmul(x.double().t(), dy.double()), m)
    w = (torch.randn(k, n, device="cuda", generator=g) * k ** -0.5).to(bf)
    if kind == "fwd":
        x = torch.randn(m, k, device="cuda", generator=g).to(bf)
        kw = dict(block_m=64, block_n=128, block_k=32)
        got, again = matmul_kernel(x, w, **kw), matmul_kernel(x, w, **kw)
        want = matmul_kernel.plain(x, w, **kw).float()
        a = want.abs().clamp(min=max(2.0 ** -8 * float(want.abs().max()), 2.0 ** -126))
        ulps = float(((got.float() - want).abs()
                      / torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8)).max())
        return dict(max_ulps=ulps, same_bits=bool(torch.equal(got, again)), ok=ulps <= 1.0)
    dy = torch.randn(m, n, device="cuda", generator=g).to(bf)
    kw = dict(block_m=64, block_n=32, block_k=128)
    got, again = matmul_nt_kernel(dy, w, **kw), matmul_nt_kernel(dy, w, **kw)
    return f32_check(torch, got, again, matmul_nt_kernel.plain(dy, w, **kw).double(),
                     torch.matmul(dy.double(), w.double().t()), n)


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    z.synchronize()
    return a.elapsed_time(z) / reps


def gemm_section(torch, variant: str, card: str) -> bool:
    from repro_torch.kernels.matmul.bwd import matmul_nt_kernel, matmul_tn_kernel
    from repro_torch.kernels.matmul.matmul import matmul_kernel

    ok = True
    for kind, m, k, n in CHECKS:
        rec = check(torch, kind, m, k, n)
        ok &= rec["ok"] and rec["same_bits"]
        print(json.dumps(dict(variant=variant, kind=kind, m=m, k=k, n=n, **rec, card=card)),
              flush=True)
        torch.cuda.empty_cache()
    bf = torch.bfloat16
    for m, k, n in TIMED:
        x = torch.randn(m, k, device="cuda").to(bf)
        w = torch.randn(k, n, device="cuda").to(bf)
        dy = torch.randn(m, n, device="cuda").to(bf)
        reps = 5 if n > 100_000 else 20
        t = {"fwd_ms": time_ms(torch, lambda: matmul_kernel(x, w, block_m=64, block_n=128,
                                                               block_k=32), reps),
             "fwd_cublas_ms": time_ms(torch, lambda: torch.matmul(x, w), reps),
             "nt_ms": time_ms(torch, lambda: matmul_nt_kernel(dy, w, block_m=64, block_n=32,
                                                                 block_k=128), reps),
             "nt_cublas_ms": time_ms(torch, lambda: torch.matmul(dy, w.t()), reps),
             "tn_ms": time_ms(torch, lambda: matmul_tn_kernel(x, dy, block_m=32, block_n=128,
                                                                 block_k=64), reps),
             "tn_cublas_ms": time_ms(torch, lambda: torch.matmul(x.t(), dy), reps)}
        flop = 2.0 * m * k * n
        print(json.dumps(dict(variant=variant, m=m, k=k, n=n, **t,
                              fwd_tflops=flop / t["fwd_ms"] / 1e9,
                              nt_tflops=flop / t["nt_ms"] / 1e9,
                              tn_tflops=flop / t["tn_ms"] / 1e9, card=card)), flush=True)
        del x, w, dy
        torch.cuda.empty_cache()
    return ok


def flash_section(torch, variant: str, card: str) -> bool:
    """Each phase bf16_dense (a) case through chip_smoke.py's own helpers."""
    import statistics

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 42)
    ok = True
    for spec in cs.BF16_FLASH:
        label, (q, k, v), kw, lib = cs.bf16_flash_case(torch, g, spec)
        got = flash_attention_kernel(q, k, v, **kw)
        again = flash_attention_kernel(q, k, v, **kw)
        want = flash_attention_kernel.plain(q, k, v, **kw)
        gate = cs.ulp_check(torch, got[:, :kw["q_len"]], want[:, :kw["q_len"]])
        same = bool(torch.equal(got, again))
        ok &= gate["max_ulps"] <= 1.0 and same
        ms = {}
        for name, fn in (("ms", lambda: flash_attention_kernel(q, k, v, **kw)),
                         ("sdpa_bf16_ms", lib)):
            for _ in range(2):
                fn()
            times = []
            for _ in range(10):
                a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                z.record()
                z.synchronize()
                times.append(a.elapsed_time(z))
            ms[name] = statistics.median(times)
        print(json.dumps(dict(variant=variant, kind="flash", case=label,
                              blocks=[kw["block_q"], kw["block_kv"]],
                              **cs.template_record("flash_attention", (q, k, v), kw),
                              max_ulps=gate["max_ulps"], differ=gate["differ"],
                              same_bits=same, **ms, card=card)), flush=True)
        del q, k, v, got, again, want, lib
        torch.cuda.empty_cache()
    return ok


def run(variant: str) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    if variant == "checkout":
        reports = _build.build_all(list(LIBS))
        notes = {lib: [ln.strip() for ln in log.splitlines() if "C7517" in ln]
                 for lib, log in reports.items()}
        sections = ("gemm", "flash")
    else:
        notes = load_variant(variant)
        sections = VARIANTS[variant][2]
    print(json.dumps(dict(variant=variant, c7517=notes, card=card)), flush=True)
    ok = True
    if "gemm" in sections:
        ok &= gemm_section(torch, variant, card)
    if "flash" in sections:
        ok &= flash_section(torch, variant, card)
    return 0 if ok else 1


def main(argv: list[str]) -> int:
    if len(argv) == 1 and (argv[0] == "checkout" or argv[0] in VARIANTS):
        return run(argv[0])
    names = argv or ["checkout"]
    unknown = [v for v in names if v != "checkout" and v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: checkout, {', '.join(VARIANTS)}")
    worst = 0
    for name in names:
        worst = max(worst, subprocess.run([sys.executable, __file__, name]).returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
