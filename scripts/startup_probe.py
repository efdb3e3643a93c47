#!/usr/bin/env python3
"""Where a rank process's first seconds go on the card's host.

    python3 scripts/startup_probe.py [--ranks 1 4] [--importtime]

For each count R in ``--ranks``, starts R processes at once, as a mesh phase
of ``chip_smoke.py`` starts its ranks, and each prints the seconds since its
start at each mark: ``import torch``, the port's modules, the card's
context, gloo's process group (a file store), the first cuBLAS call, the
first launch of the matmul, NT, TN and flash kernels (a build of the
kernels comes first, outside the marks), an 8 GiB allocation, two 256 MB
all-reduces of a CUDA tensor over gloo and a few other ops.  With
``--importtime``, also ``python -X importtime -c "import torch"``'s total
and its largest modules by their own time.  Needs the card.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rank(r: int, world: int, work: str) -> None:
    t0 = time.perf_counter()
    marks = []

    def mark(name):
        if "torch" in sys.modules and sys.modules["torch"].cuda.is_initialized():
            sys.modules["torch"].cuda.synchronize()
        marks.append((name, round(time.perf_counter() - t0, 3)))

    import torch

    mark("import torch")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.launch.train  # noqa: F401
    import repro_torch.runtime.serve  # noqa: F401

    mark("import port")
    torch.cuda.set_device(0)
    torch.empty(1, device="cuda")
    mark("context")
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=r,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    mark("gloo init")
    a = torch.randn(2048, 2048, device="cuda")
    a @ a
    mark("first cublas")
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul.bwd import matmul_nt_kernel, matmul_tn_kernel
    from repro_torch.kernels.matmul.matmul import matmul_kernel

    x = torch.randn(1024, 1024, device="cuda")
    w = torch.randn(1024, 1024, device="cuda")
    matmul_kernel(x, w, block_m=64, block_n=128, block_k=32)
    mark("first matmul kernel")
    matmul_kernel(x, w, block_m=64, block_n=128, block_k=32)
    mark("second matmul kernel")
    matmul_nt_kernel(x, w, block_m=64, block_n=32, block_k=128)
    mark("first nt")
    matmul_tn_kernel(x, w, block_m=32, block_n=128, block_k=64)
    mark("first tn")
    q = torch.randn(16, 2048, 64, device="cuda")
    flash_attention_kernel(q, q, q, block_q=128, block_kv=128, scale=0.125, causal=True,
                           window=None, q_len=2048, kv_len=2048)
    mark("first flash")
    big = torch.empty(8 << 30, dtype=torch.uint8, device="cuda")
    mark("alloc 8 GiB")
    del big
    g = torch.ones(64 << 20, device="cuda")
    dist.all_reduce(g)
    mark("first allreduce 256MB cuda")
    dist.all_reduce(g)
    mark("second allreduce 256MB cuda")
    y = torch.nn.functional.gelu(torch.randn(1000, 1000, device="cuda")).sum()
    y = y + torch.softmax(torch.randn(100, 100, device="cuda"), -1).mean()
    mark("a few torch ops")
    dist.destroy_process_group()
    print(r, marks, flush=True)


def importtime(top: int = 12) -> None:
    out = subprocess.run([sys.executable, "-X", "importtime", "-c", "import torch"],
                         capture_output=True, text=True).stderr
    rows = []
    for line in out.splitlines():
        if not line.startswith("import time:") or "self [us]" in line:
            continue
        own, total, name = line[len("import time:"):].split("|")
        rows.append((int(own), int(total), name.strip()))
    whole = max(rows, key=lambda row: row[1])
    print(f"import torch {whole[1] / 1e6:.3f} s over {len(rows)} modules")
    for own, total, name in sorted(rows, reverse=True)[:top]:
        print(f"  {own / 1e6:.3f} s own, {total / 1e6:.3f} s with imports: {name}")


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--importtime", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.2f} s", flush=True)
    for world in args.ranks:
        with tempfile.TemporaryDirectory() as work:
            procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), str(world),
                                       work]) for r in range(world)]
            if any(p.wait() for p in procs):
                return 1
    if args.importtime:
        importtime()
    return 0


if __name__ == "__main__":
    sys.exit(main())
