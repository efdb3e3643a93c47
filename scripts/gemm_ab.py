"""Hold the GEMM kernels of one checkout against another's, on the card:
the same seeded operands through each tree's own matmul, NT, TN and fused
dX/dW kernels (built from its own ``csrc/matmul*.cu``), each call timed.

    python3 scripts/gemm_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one, or a copy of
another commit unpacked under ``build/``).  The trees run in the order
given, each in a process of its own with ``PYTHONPATH=TREE/src``; give the
two trees as A B B A so that a drift of the card's clocks shows.  Two kinds
of case:

* "bits": f32 operands (the qwen1.5-0.5b step's register tiles with and
  without a split, TN's among them, the fused kernel at the CNN's fc1 at
  batch 128, each simple kernel at a small tile), the CNN's bf16 x f32
  routes (the forward to bf16 and to f32, NT; the planner's tiles, split
  and not; TN has none: it takes X and dY, of one dtype) and bf16 TN off
  its tile (the simple kernel): every tree must give the same bits;
* "plain": bf16 x bf16 forward, NT and TN at the qwen1.5-0.5b step's qkv
  and logits shapes, on the tensor cores in a tree that has them: each
  tree's output is held against its plain version (the forward's bf16
  output within one bf16 ulp at max(|plain|, 2^-8 max|plain|), NT's f32 dX
  and TN's f32 dW within 1e-5 of scale, times sqrt(K / 8192) past a
  contraction K of 8192), since the trees' kernels sum in other orders.

Prints one JSON line per tree (each case's median ms over 10 calls after 2
warm-ups, by CUDA events, and each "plain" case's check) and a last line
with, per "bits" case, whether every tree gave the same bits, and per
"plain" case whether every tree passed.  Exits 1 when either fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

# label, kernel, operand shapes, (block_m, block_n, block_k), operand dtypes,
# the output dtype the caller names (None: the kernel's own), kind
F, B = "float32", "bfloat16"
CASES = [
    ("mm-qkv", "matmul", ((8192, 1024), (1024, 3072)), (64, 128, 32), (F, F), None, "bits"),
    ("mm-logits-split", "matmul", ((256, 4096), (4096, 1024)), (64, 128, 32), (F, F), None,
     "bits"),
    ("mm-simple", "matmul", ((40, 96), (96, 80)), (8, 16, 16), (F, F), None, "bits"),
    ("nt-mlp_down", "matmul_nt", ((8192, 1024), (2816, 1024)), (64, 32, 128), (F, F), None,
     "bits"),
    ("nt-simple", "matmul_nt", ((40, 80), (96, 80)), (8, 16, 16), (F, F), None, "bits"),
    ("tn-wo-split", "matmul_tn", ((8192, 1024), (8192, 1024)), (32, 128, 64), (F, F), None,
     "bits"),
    ("tn-qkv", "matmul_tn", ((8192, 1024), (8192, 3072)), (32, 128, 64), (F, F), None,
     "bits"),
    ("tn-simple", "matmul_tn", ((40, 96), (40, 80)), (8, 16, 16), (F, F), None, "bits"),
    ("bf16-tn-simple", "matmul_tn", ((40, 96), (40, 80)), (8, 16, 16), (B, B), None, "bits"),
    ("dxdw-fc1", "matmul_dx_dw", ((128, 4096), (2048, 4096), (128, 2048)), (64, 32, 128),
     (F, F, F), None, "bits"),
    ("dxdw-simple", "matmul_dx_dw", ((40, 80), (96, 80), (40, 96)), (8, 16, 16), (F, F, F),
     None, "bits"),
    # the CNN's bf16 x f32 routes: fc1 at batch 256 (K split 2), an im2col strip
    ("mixed-mm-fc1-bf16", "matmul", ((256, 2048), (2048, 4096)), (64, 128, 32), (B, F), None,
     "bits"),
    ("mixed-mm-strip-f32", "matmul", ((4096, 2304), (2304, 512)), (64, 128, 32), (B, F), F,
     "bits"),
    ("mixed-mm-simple-f32", "matmul", ((40, 96), (96, 80)), (8, 16, 16), (B, F), F, "bits"),
    ("mixed-nt-fc1", "matmul_nt", ((256, 4096), (2048, 4096)), (64, 32, 128), (B, F), None,
     "bits"),
    ("mixed-nt-simple", "matmul_nt", ((40, 80), (96, 80)), (8, 16, 16), (B, F), None, "bits"),
    # bf16 x bf16 at the qwen1.5-0.5b step's qkv and logits (chunk of 2048 rows)
    ("bf16-mm-qkv", "matmul", ((8192, 1024), (1024, 3072)), (64, 128, 32), (B, B), None,
     "plain"),
    ("bf16-mm-logits", "matmul", ((2048, 1024), (1024, 151936)), (64, 128, 32), (B, B), None,
     "plain"),
    ("bf16-nt-qkv", "matmul_nt", ((8192, 3072), (1024, 3072)), (64, 32, 128), (B, B), None,
     "plain"),
    ("bf16-nt-logits", "matmul_nt", ((2048, 151936), (1024, 151936)), (64, 32, 128), (B, B),
     None, "plain"),
    ("bf16-tn-qkv", "matmul_tn", ((8192, 1024), (8192, 3072)), (32, 128, 64), (B, B), None,
     "plain"),
    ("bf16-tn-logits", "matmul_tn", ((2048, 1024), (2048, 151936)), (32, 128, 64), (B, B),
     None, "plain"),
]

RUN = r"""
import json, math, torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels.matmul.bwd import matmul_dxdw_kernel, matmul_nt_kernel, matmul_tn_kernel
from repro_torch.kernels.matmul.matmul import matmul_kernel
KERNELS = {"matmul": matmul_kernel, "matmul_nt": matmul_nt_kernel,
           "matmul_tn": matmul_tn_kernel, "matmul_dx_dw": matmul_dxdw_kernel}


def plain_check(name, got, want, contraction):
    if got.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        a = w.abs().clamp(min=max(2.0 ** -8 * float(w.abs().max()), 2.0 ** -126))
        ulp = torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8)
        ulps = float(((g - w).abs() / ulp).max())
        return {"max_ulps": ulps, "ok": ulps <= 1.0}
    err = float((got.double() - want.double()).abs().max())
    tol = 1e-5 * max(1.0, math.sqrt(contraction / 8192)) * max(1.0, float(want.abs().max()))
    return {"max_abs_err": err, "tolerance": tol, "ok": err <= tol}


out, times, checks = {}, {}, {}
for label, name, shapes, (bm, bn, bk), dtypes, out_dtype, kind in CASES:
    g = torch.Generator(device="cuda").manual_seed(11)
    args = [(torch.randn(s, device="cuda", generator=g) * s[-1] ** -0.5).to(getattr(torch, d))
            for s, d in zip(shapes, dtypes)]
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    if out_dtype:
        kw["out_dtype"] = getattr(torch, out_dtype)
    fn = lambda: KERNELS[name](*args, **kw)
    for _ in range(2):
        fn()
    ms = []
    for _ in range(10):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        o = fn()
        z.record()
        z.synchronize()
        ms.append(a.elapsed_time(z))
    times[label] = sorted(ms)[len(ms) // 2]
    if kind == "bits":
        out[label] = [t.cpu() for t in (o if isinstance(o, tuple) else (o,))]
    else:
        contraction = shapes[0][0] if name == "matmul_tn" else shapes[0][1]
        checks[label] = plain_check(name, o, KERNELS[name].plain(*args, **kw), contraction)
    del args, o
    torch.cuda.empty_cache()
torch.save(out, OUT)
print(json.dumps({"times_ms": times, "plain_checks": checks}))
"""


def main(trees: list[str], cases=CASES, run: str = RUN, prefix: str = "gemm_ab_") -> int:
    """Run ``run`` (which reads CASES and writes OUT) in each tree in turn,
    print each tree's times (and its "plain" checks, where ``run`` makes
    them), then whether every tree gave the same bits; 1 when they differ
    or a check fails.  ``scripts/conv_ab.py`` runs the conv kernels through
    it."""
    work = Path(tempfile.mkdtemp(prefix=prefix))
    runs, checks = [], {}
    for i, tree in enumerate(trees):
        root = Path(tree).resolve()
        out = work / f"run{i}.pt"
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        script = f"CASES = {cases!r}\nOUT = {str(out)!r}\n" + run
        proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=root,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 2
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec.update(tree=str(tree), run=i)
        print(json.dumps(rec), flush=True)
        runs.append(out)
        for label, c in rec.get("plain_checks", {}).items():
            checks[label] = checks.get(label, True) and c["ok"]
    import torch

    outs = [torch.load(p) for p in runs]
    same = {label: all(all(torch.equal(a, b) for a, b in zip(o[label], outs[0][label]))
                       for o in outs[1:])
            for label in outs[0]}
    print(json.dumps({"bit_identical": same, "within_plain": checks, "trees": trees}),
          flush=True)
    return 0 if all(same.values()) and all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
