"""Hold the f32 GEMM kernels of one checkout against another's, on the
card: the same seeded f32 operands through each tree's own matmul, NT, TN
and fused dX/dW kernels (built from its own ``csrc/matmul*.cu``), the
outputs compared bit for bit and each call timed.

    python3 scripts/gemm_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one, or a copy of
another commit unpacked under ``build/``).  The trees run in the order
given, each in a process of its own with ``PYTHONPATH=TREE/src``; give the
two trees as A B B A so that a drift of the card's clocks shows.  The
cases are the qwen1.5-0.5b step's register tiles (with and without a
split), the fused kernel at the CNN's fc1 at batch 128 and each simple
kernel at a small tile.  Prints one JSON line per tree (each case's median
ms over 10 calls after 2 warm-ups, by CUDA events) and a last line with,
per case, whether every tree gave the same bits.  Exits 1 when the outputs
differ.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

# label, kernel, operand shapes, (block_m, block_n, block_k)
CASES = [
    ("mm-qkv", "matmul", ((8192, 1024), (1024, 3072)), (64, 128, 32)),
    ("mm-logits-split", "matmul", ((256, 4096), (4096, 1024)), (64, 128, 32)),
    ("mm-simple", "matmul", ((40, 96), (96, 80)), (8, 16, 16)),
    ("nt-mlp_down", "matmul_nt", ((8192, 1024), (2816, 1024)), (64, 32, 128)),
    ("nt-simple", "matmul_nt", ((40, 80), (96, 80)), (8, 16, 16)),
    ("tn-wo-split", "matmul_tn", ((8192, 1024), (8192, 1024)), (32, 128, 64)),
    ("tn-simple", "matmul_tn", ((40, 96), (40, 80)), (8, 16, 16)),
    ("dxdw-fc1", "matmul_dx_dw", ((128, 4096), (2048, 4096), (128, 2048)), (64, 32, 128)),
    ("dxdw-simple", "matmul_dx_dw", ((40, 80), (96, 80), (40, 96)), (8, 16, 16)),
]

RUN = r"""
import json, torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels.matmul.bwd import matmul_dxdw_kernel, matmul_nt_kernel, matmul_tn_kernel
from repro_torch.kernels.matmul.matmul import matmul_kernel
KERNELS = {"matmul": matmul_kernel, "matmul_nt": matmul_nt_kernel,
           "matmul_tn": matmul_tn_kernel, "matmul_dx_dw": matmul_dxdw_kernel}
out, times = {}, {}
for label, name, shapes, (bm, bn, bk) in CASES:
    g = torch.Generator(device="cuda").manual_seed(11)
    args = [torch.randn(s, device="cuda", generator=g) * s[-1] ** -0.5 for s in shapes]
    fn = lambda: KERNELS[name](*args, block_m=bm, block_n=bn, block_k=bk)
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
    out[label] = [t.cpu() for t in (o if isinstance(o, tuple) else (o,))]
    times[label] = sorted(ms)[len(ms) // 2]
torch.save(out, OUT)
print(json.dumps({"times_ms": times}))
"""


def main(trees: list[str], cases=CASES, run: str = RUN, prefix: str = "gemm_ab_") -> int:
    """Run ``run`` (which reads CASES and writes OUT) in each tree in turn,
    print each tree's times, then whether every tree gave the same bits;
    1 when they differ.  ``scripts/conv_ab.py`` runs the conv kernels
    through it."""
    work = Path(tempfile.mkdtemp(prefix=prefix))
    runs = []
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
    import torch

    outs = [torch.load(p) for p in runs]
    same = {label: all(all(torch.equal(a, b) for a, b in zip(o[label], outs[0][label]))
                       for o in outs[1:])
            for label in outs[0]}
    print(json.dumps({"bit_identical": same, "trees": trees}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
