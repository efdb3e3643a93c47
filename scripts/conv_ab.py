"""Hold the f32 conv kernels of one checkout against another's, on the
card: the same seeded f32 operands through each tree's own direct conv
(forward with its mask, and dgrad) and wgrad kernels (built from its own
``csrc/conv2d*.cu``), the outputs compared bit for bit and each call timed.

    python3 scripts/conv_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one, or a copy of
another commit unpacked under ``build/``), run as ``scripts/gemm_ab.py``
runs them (give two trees as A B B A).  The cases are every direct conv,
dgrad and wgrad call of the f32 cnn-vgg11 training step at batch 256 with
its planned blocks (the register kernels) and each simple kernel at a
ragged stride-2 case.  Prints one JSON line per tree (each case's median
ms over 10 calls after 2 warm-ups, by CUDA events) and a last line with,
per case, whether every tree gave the same bits.  Exits 1 when the
outputs differ.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import gemm_ab  # noqa: E402

CASES = ["cnn-vgg11 batch 256", "ragged"]

RUN = r"""
import json, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.kernels.conv2d.bwd import conv2d_wgrad_kernel, dgrad_operands, wgrad_operands
from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
from repro_torch.models import cnn

g = torch.Generator(device="cuda").manual_seed(12)
calls = []
cfg = get_config("cnn-vgg11")
plans = cnn.plan_training(cfg, 256)
for i, (name, x_shape, w_shape) in enumerate(cnn._stage_geometry(cfg, 256)):
    if not name.startswith("conv"):
        continue
    B, H, _, ci = x_shape
    co = w_shape[3]
    x = torch.randn(x_shape, device="cuda", generator=g)
    dy = torch.randn(B, H, H, co, device="cuda", generator=g)
    f = torch.randn(w_shape, device="cuda", generator=g) * (9 * ci) ** -0.5
    bias = torch.randn(co, device="cuda", generator=g) * 0.1
    if plans[name].algorithm != "im2col":
        b = plans[name].block_dict()
        n_h = -(-H // b["block_h"])
        pad_b = 1 + max(0, (n_h * b["block_h"] - 1) + 3 - (H + 2))
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, pad_b)).contiguous()
        calls.append((name, conv2d_kernel, (xp, f, bias), dict(
            stride=1, block_h=b["block_h"], block_do=b["block_do"], block_di=b["block_di"],
            H_O=H, W_O=H, relu=True, pool=2, emit_mask=True)))
    b = plans[name + ".wgrad"].block_dict()
    xq, gq, geo = wgrad_operands(x, dy, F=3, stride=1, padding=1, block_h=b["block_h"])
    calls.append((name + ".wgrad", conv2d_wgrad_kernel, (xq, gq),
                  dict(geo, block_do=b["block_do"], block_di=b["block_di"])))
    if i > 0:
        b = plans[name + ".dgrad"].block_dict()
        xq, ft, zb, geo = dgrad_operands(dy, f, stride=1, padding=1, out_hw=(H, H),
                                         block_h=b["block_h"])
        calls.append((name + ".dgrad", conv2d_kernel, (xq, ft, zb),
                      dict(geo, block_do=b["block_do"], block_di=b["block_di"])))
x = torch.randn(3, 17, 17, 5, device="cuda", generator=g)
dy = torch.randn(3, 9, 9, 13, device="cuda", generator=g)
f = torch.randn(3, 3, 5, 13, device="cuda", generator=g)
xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 7)).contiguous()
calls.append(("ragged", conv2d_kernel, (xp, f, torch.randn(13, device="cuda", generator=g)),
              dict(stride=2, block_h=4, block_do=16, block_di=8, H_O=9, W_O=9, relu=True,
                   pool=1, emit_mask=True)))
xq, gq, geo = wgrad_operands(x, dy, F=3, stride=2, padding=1, block_h=4)
calls.append(("ragged.wgrad", conv2d_wgrad_kernel, (xq, gq),
              dict(geo, block_do=16, block_di=8)))
xq, ft, zb, geo = dgrad_operands(dy, f, stride=2, padding=1, out_hw=(17, 17), block_h=4)
calls.append(("ragged.dgrad", conv2d_kernel, (xq, ft, zb), dict(geo, block_do=8, block_di=8)))
out, times = {}, {}
for label, kernel, args, kw in calls:
    fn = lambda: kernel(*args, **kw)
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


if __name__ == "__main__":
    sys.exit(gemm_ab.main(sys.argv[1:], cases=CASES, run=RUN, prefix="conv_ab_"))
