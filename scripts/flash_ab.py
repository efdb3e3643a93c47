"""Hold the flash-attention kernel of one checkout against another's, on
the card: the same seeded operands through each tree's own kernel (built
from its own ``csrc/flash_attention.cu``), the f32 outputs compared bit for
bit, the bf16 output held within one bf16 ulp of the tree's plain version
(max(|plain|, 2^-8 max|plain|); the trees' bf16 kernels may sum in other
orders: the tensor cores since the wgmma kernel), and each call timed.

    python3 scripts/flash_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one, or a copy of
another commit unpacked under ``build/``).  The trees run in the order
given, each in a process of its own with ``PYTHONPATH=TREE/src``; give
the two trees as A B B A so that a drift of the card's clocks shows.  The
kernel is called without a query offset, so a tree that predates
``q_off`` runs the same call.  Prints one JSON line per tree (each case's
median ms over 20 calls after 3 warm-ups, by CUDA events) and a last line
with, per f32 case, whether every tree gave the same bits, and per bf16
case whether every tree passed.  Exits 1 when either fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

# label, B, Hq, Hkv, S, D, window, dtype: the transformer's call and the
# other head dims of phase ``flash`` of chip_smoke.py in f32, and the bf16
# route at D = 64 (phase ``bf16``'s call), causal, at the blocks
# AttentionPlanner picks on the H100 at the operands' element size.
CASES = [("main-d64", 4, 16, 16, 2048, 64, None, "float32"),
         ("gqa16/8-d128", 4, 16, 8, 2048, 128, None, "float32"),
         ("gqa16/8-d32", 4, 16, 8, 2048, 32, None, "float32"),
         ("gqa8/4-d256", 4, 8, 4, 2048, 256, None, "float32"),
         ("window512-d64", 4, 16, 16, 2048, 64, 512, "float32"),
         ("gemma3-d256-w1024", 1, 8, 4, 2048, 256, 1024, "float32"),
         ("bf16-main-d64", 4, 16, 16, 2048, 64, None, "bfloat16")]

RUN = r"""
import json, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro_torch.plan import AttentionPlanner
out, times, checks = {}, {}, {}
for label, b, hq, hkv, s, d, window, dtype in CASES:
    g = torch.Generator(device="cuda").manual_seed(11)
    dt = getattr(torch, dtype)
    plan = AttentionPlanner().plan(seq_q=s, seq_kv=s, head_dim=d, n_q_heads=hq,
                                   n_kv_heads=hkv, batch=b, in_bytes=dt.itemsize,
                                   causal=True, window=window)
    q = torch.randn(b * hq, s, d, device="cuda", generator=g).to(dt)
    k = torch.randn(b * hkv, s, d, device="cuda", generator=g).to(dt)
    v = torch.randn(b * hkv, s, d, device="cuda", generator=g).to(dt)
    kw = dict(block_q=plan.block("block_q"), block_kv=plan.block("block_kv"),
              scale=d ** -0.5, causal=True, window=window, q_len=s, kv_len=s)
    fn = lambda: flash_attention_kernel(q, k, v, **kw)
    for _ in range(3):
        fn()
    ms = []
    for _ in range(20):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        o = fn()
        z.record()
        z.synchronize()
        ms.append(a.elapsed_time(z))
    if dt == torch.bfloat16:
        want = flash_attention_kernel.plain(q, k, v, **kw).float()
        a = want.abs().clamp(min=max(2.0 ** -8 * float(want.abs().max()), 2.0 ** -126))
        ulp = torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8)
        ulps = float(((o.float() - want).abs() / ulp).max())
        checks[label] = {"max_ulps": ulps, "ok": ulps <= 1.0}
    else:
        out[label] = o.cpu()
    times[label] = sorted(ms)[len(ms) // 2]
torch.save(out, OUT)
print(json.dumps({"times_ms": times, "plain_checks": checks}))
"""


def main(trees: list[str]) -> int:
    work = Path(tempfile.mkdtemp(prefix="flash_ab_"))
    runs, checks = [], {}
    for i, tree in enumerate(trees):
        root = Path(tree).resolve()
        out = work / f"run{i}.pt"
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        script = f"CASES = {CASES!r}\nOUT = {str(out)!r}\n" + RUN
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
    same = {label: all(torch.equal(o[label], outs[0][label]) for o in outs[1:])
            for label in outs[0]}
    print(json.dumps({"bit_identical": same, "within_plain": checks, "trees": trees}),
          flush=True)
    return 0 if all(same.values()) and all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
