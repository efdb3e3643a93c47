"""Time the flash-attention kernel's bf16 route on the CUDA cores (the
"fma" kernel, which serves the bf16 blocks the wgmma kernel does not take;
at the planner's blocks, which the wgmma kernel takes, it runs its
instantiation for blocks below its maxima) at each row-group count (``RG``)
its template admits, on the card, to pick the one
``csrc/flash_attention.cu`` instantiates.

    python3 scripts/flash_rg.py

For each (head dim, RG) it rewrites the bf16 entry point's ``case D`` line
of a copy of the source, builds the copy with the port's nvcc flags into
``build/flash_rg/`` (all builds at once), and calls it through ``ctypes``
at the planner's bf16 blocks on the shapes below: every output is held
within one bf16 ulp of the plain version, and each call is timed (median
of 20 after 3 warm-ups, CUDA events).  Prints one JSON line per case and
RG, each with the card's name and power limit, and a last line with the
fastest RG per head dim.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

# Head dim -> the row-group counts the template's static_assert admits at
# the planner's bf16 blocks (OC = D / 4 / (32 / RG) >= 1).
ADMITTED = {32: (4,), 128: (1, 2, 4), 256: (1, 2, 4)}
# label, B, Hq, Hkv, S, D, window (causal): qwen3-1.7b's cell, the GQA
# 64/8 cell of the dense phase, gemma3-4b's global and local cells, a D = 32 cell.
CASES = [("qwen3-1.7b-d128", 4, 16, 8, 2048, 128, None),
         ("gqa64/8-d128", 1, 64, 8, 2048, 128, None),
         ("gemma3-global-d256", 4, 8, 4, 2048, 256, None),
         ("gemma3-local-d256-w1024", 4, 8, 4, 2048, 256, 1024),
         ("gqa16/8-d32", 4, 16, 8, 2048, 32, None)]


def variant(src: str, d: int, rg: int) -> str:
    """The source with the bf16 entry point's ``case d`` at ``rg``."""
    head, _, tail = src.partition("int repro_flash_attention_bf16(")
    pat = re.compile(rf"(case {d}:\s*return launch<bf16, {d}, \d+, \d+, )\d+>")
    tail, n = pat.subn(rf"\g<1>{rg}>", tail)
    if n != 1:
        raise RuntimeError(f"no bf16 case {d} in the source")
    return head + "int repro_flash_attention_bf16(" + tail


def build(work: Path) -> dict:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    work.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for d, rgs in ADMITTED.items():
        for rg in rgs:
            cu = work / f"fa_d{d}_rg{rg}.cu"
            cu.write_text(variant(src, d, rg))
            so = cu.with_suffix(".so")
            jobs[d, rg] = (so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (d, rg), (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for D {d} RG {rg}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.repro_flash_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        libs[d, rg] = (fn, ptxas_report(log, d))
    return libs


def ptxas_report(log: str, d: int) -> list:
    """ptxas's register and spill lines of the bf16 kernels at head dim d."""
    out, mine = [], False
    for line in log.splitlines():
        if "entry function" in line:
            mine = f"I13__nv_bfloat16Li{d}E" in line
        elif mine and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def main() -> int:
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        FLASH_TEMPLATES, MAX_BLOCKS_BF16, flash_attention_plain,
    )
    from repro_torch.plan import AttentionPlanner

    if not torch.cuda.is_available():
        print("flash_rg.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    libs = build(ROOT / "build" / "flash_rg")
    best: dict = {}
    for label, b, hq, hkv, s, d, window in CASES:
        plan = AttentionPlanner().plan(seq_q=s, seq_kv=s, head_dim=d, n_q_heads=hq,
                                       n_kv_heads=hkv, batch=b, in_bytes=2, causal=True,
                                       window=window)
        bq, bkv = plan.block("block_q"), plan.block("block_kv")
        if (bq, bkv) != MAX_BLOCKS_BF16[d]:
            raise AssertionError(f"{label}: planner's bf16 blocks {(bq, bkv)}")
        g = torch.Generator(device="cuda").manual_seed(13)
        q, k, v = (torch.randn(b * h, s, d, device="cuda", generator=g).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        kw = dict(block_q=bq, block_kv=bkv, scale=d ** -0.5, causal=True, window=window,
                  q_len=s, kv_len=s)
        want = flash_attention_plain(q, k, v, **kw).float()
        ulp = torch.ldexp(torch.ones_like(want),
                          torch.frexp(want.abs().clamp(min=2.0 ** -8 * float(want.abs().max())))
                          .exponent - 8)
        for rg in ADMITTED[d]:
            fn, ptxas = libs[d, rg]
            o = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * hq,
                         b * hkv, s, s, d, bq, bkv, s, s, 1, -1 if window is None else window,
                         0, FLASH_TEMPLATES.index("fma"), ctypes.c_float(d ** -0.5),
                         ctypes.c_void_p(stream))
                if err:
                    raise RuntimeError(f"{label} RG {rg}: launch error {err}")

            call()
            torch.cuda.synchronize()
            max_ulps = float(((o.float() - want).abs() / ulp).max())
            if max_ulps > 1.0:
                raise AssertionError(f"{label} RG {rg}: {max_ulps} ulps from plain")
            for _ in range(3):
                call()
            ms = []
            for _ in range(20):
                a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                z.record()
                z.synchronize()
                ms.append(a.elapsed_time(z))
            t = sorted(ms)[len(ms) // 2]
            best.setdefault(d, {}).setdefault(rg, 0.0)
            best[d][rg] += t
            print(json.dumps({"case": label, "head_dim": d, "rg": rg, "blocks": [bq, bkv],
                              "ms": t, "max_ulps": max_ulps, "ptxas": ptxas, "card": card}),
                  flush=True)
    print(json.dumps({"fastest_rg": {d: min(t, key=t.get) for d, t in best.items()},
                      "summed_ms": best, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
