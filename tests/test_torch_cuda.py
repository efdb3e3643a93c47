"""The port's CUDA kernels against their plain versions, on the card —
forward, planned backward and the transformer's flash attention — and the
serving engine on the card (its tokens, and the kernels its warmup tunes).

Every test here is marked ``cuda`` and skips where there is no GPU; the
file imports neither JAX nor ``repro``, so it runs on a machine with a card
and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance (f32): max |kernel - plain| <= 1e-4 * max(1, max |plain|) — sums
in another order over up to a few thousand terms.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.conv_layer import conv_block, conv_layer
from repro_torch.core.fc_layer import fc_layer, plan_bwd as fc_plan_bwd
from repro_torch.kernels.conv2d.bwd import (
    conv2d_dgrad, conv2d_wgrad, conv2d_wgrad_kernel,
)
from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
from repro_torch.kernels.conv2d.ops import conv2d, conv2d_with_mask
from repro_torch.kernels.matmul import fc_matmul, matmul_kernel
from repro_torch.kernels.matmul.bwd import (
    matmul_dw, matmul_dx, matmul_dx_dw, matmul_dxdw_kernel, matmul_nt_kernel,
    matmul_tn_kernel,
)

TOL = 1e-4

# (B, H, d_in, d_out, F, S, P, pool, block_h), as in test_torch_kernels.py
CONV_CASES = [
    (2, 8, 3, 8, 3, 1, 1, 2, None),
    (2, 9, 5, 7, 3, 1, 1, 1, 4),
    (1, 12, 8, 16, 3, 2, 0, 1, None),
    (2, 13, 6, 10, 3, 2, 1, 2, None),
    (3, 10, 4, 9, 3, 1, 1, 2, 4),
    (1, 8, 3, 5, 5, 1, 2, 2, None),
    (2, 7, 17, 3, 1, 1, 0, 1, None),
]


def assert_close(got, want, tol=TOL):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    # the plain versions are f32 references only with TF32 off
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(37, 90, 70), (256, 2048, 4096)])
def test_matmul_kernel_matches_plain_on_card(cuda, m, k, n):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, m, k), _rand(rng, k, n)
    before = matmul_kernel.launches
    got = fc_matmul(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert matmul_kernel.launches == before + 1
    assert_close(got, x.double() @ w.double())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_kernel_matches_plain_on_card(cuda, case):
    B, H, di, do, Fk, S, P, pool, hb = case
    rng = np.random.default_rng(0)
    x = _rand(rng, B, H, H, di).to(cuda)
    f = _rand(rng, Fk, Fk, di, do, scale=1 / Fk).to(cuda)
    b = _rand(rng, do).to(cuda)
    got = conv2d(x, f, bias=b, stride=S, padding=P, relu=True, pool=pool,
                 block_h=hb, algorithm="direct")
    want = conv2d(x.cpu(), f.cpu(), bias=b.cpu(), stride=S, padding=P, relu=True,
                  pool=pool, block_h=hb, algorithm="direct")
    assert_close(got, want)


@pytest.mark.cuda
def test_kernel_refuses_tensors_requiring_grad(cuda):
    x = torch.ones(8, 8, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="not differentiable by itself"):
        fc_matmul(x, torch.ones(8, 8, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [1, 2])
def test_mask_matches_plain_on_card(cuda, pool):
    """Integer operands sum exactly in f32, so ties and dead windows are
    real and the kernel's mask must equal the plain version's everywhere."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-2, 3, (2, 10, 10, 5)).astype(np.float32))
    f = torch.from_numpy(rng.integers(-1, 2, (3, 3, 5, 12)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-1, 2, (12,)).astype(np.float32))
    out, mask = conv2d_with_mask(x.to(cuda), f.to(cuda), bias=b.to(cuda), padding=1,
                                 pool=pool)
    want_out, want_mask = conv2d_with_mask(x, f, bias=b, padding=1, pool=pool)
    assert torch.equal(out.cpu(), want_out)
    assert torch.equal(mask.cpu(), want_mask)


# (m, k, n, blocks): the register tile at fc1 (K split 2), fc2 (split 8),
# conv3's im2col strip and two transformer shapes (unsplit); the simple
# kernel at conv0's im2col tile and a ragged 8/16/16 one.
MM_DISPATCH = [
    (256, 2048, 4096, (64, 128, 32)),
    (256, 4096, 1024, (64, 128, 32)),
    (4096, 2304, 512, (64, 128, 32)),
    (8192, 1024, 3072, (64, 128, 32)),
    (8192, 2816, 1024, (64, 128, 32)),
    (4096, 32, 64, (64, 64, 32)),
    (40, 96, 80, (8, 16, 16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,blocks", MM_DISPATCH)
def test_matmul_templates_match_plain_and_repeat_bit_for_bit(cuda, m, k, n, blocks):
    from repro_torch.kernels.matmul.matmul import matmul_plain

    bm, bn, bk = blocks
    rng = np.random.default_rng(11)
    x, w = _rand(rng, m, k).to(cuda), _rand(rng, k, n, scale=k ** -0.5).to(cuda)
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    got = _launched(matmul_kernel, lambda: matmul_kernel(x, w, **kw))
    assert torch.equal(got, matmul_kernel(x, w, **kw))
    want = matmul_plain(x, w, **kw)
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err


# (B, H, d_in, d_out, block_h, block_do, block_di, stride, pool, dgrad,
# template): the main-path geometries at batch 2 with the planner's blocks —
# conv0-2 forward (runs of 16, 8 and 4 pixels; conv0's 3 channels by 4-byte
# copies), the all-direct plan's conv3, the dgrad of conv1-3 (conv3's 4 x 4
# plane: 8 channel groups) — then ragged channels on the register kernel
# (12 -> 20 over stacks of 16: 16-byte copies; 5 -> 7: 4-byte copies) and
# two shapes that take the simple kernel (stride 2; an odd 9-wide plane).
CONV_DISPATCH = [
    (2, 32, 3, 64, 16, 64, 8, 1, 2, False, "register"),
    (2, 16, 64, 128, 16, 64, 16, 1, 2, False, "register"),
    (2, 8, 128, 256, 8, 64, 16, 1, 2, False, "register"),
    (2, 4, 256, 512, 4, 64, 16, 1, 2, False, "register"),
    (2, 16, 64, 128, 16, 64, 16, 1, 1, True, "register"),
    (2, 8, 128, 256, 8, 64, 16, 1, 1, True, "register"),
    (2, 4, 256, 512, 4, 64, 16, 1, 1, True, "register"),
    (3, 8, 12, 20, 4, 16, 8, 1, 2, False, "register"),
    (2, 8, 5, 7, 8, 8, 4, 1, 1, False, "register"),
    (3, 17, 5, 13, 4, 16, 8, 2, 1, False, "simple"),
    (2, 9, 5, 7, 4, 8, 8, 1, 1, False, "simple"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_DISPATCH)
def test_conv_templates_match_plain_bit_for_bit(cuda, case):
    """Small-integer operands sum exactly in f32, so the kernel's output and
    mask (ties and dead windows included) must equal the plain version's on
    the CPU bit for bit, and two launches must agree too."""
    from repro_torch.kernels.conv2d.bwd import dgrad_operands
    from repro_torch.kernels.conv2d.conv2d import conv2d_kernel, register_layout

    B, H, di, do, hb, bdo, bdi, S, pool, dgrad, want_template = case
    rng = np.random.default_rng(12)

    def ints(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi + 1, shape).astype(np.float32))

    if dgrad:
        dy, f = ints(-2, 2, B, H, H, do), ints(-1, 1, 3, 3, di, do)
        *args, kw = dgrad_operands(dy, f, stride=1, padding=1, out_hw=(H, H), block_h=hb)
        kw = dict(kw, block_do=bdo, block_di=bdi)
    else:
        H_O = (H - 1) // S + 1
        n_h = -(-H_O // hb)
        pad_b = 1 + max(0, (n_h * hb - 1) * S + 3 - (H + 2))
        x = torch.nn.functional.pad(ints(-2, 2, B, H, H, di), (0, 0, 1, 1, 1, pad_b))
        args = [x.contiguous(), ints(-1, 1, 3, 3, di, do), ints(-1, 1, do)]
        kw = dict(stride=S, block_h=hb, block_do=bdo, block_di=bdi, H_O=H_O, W_O=H_O,
                  relu=True, pool=pool, emit_mask=True)
    layout = register_layout(block_h=kw["block_h"], block_do=bdo, block_di=bdi,
                             W_O=kw["W_O"], F=3, S=kw["stride"])
    assert ("register" if layout else "simple") == want_template
    on_card = [a.to(cuda) for a in args]
    got = _launched(conv2d_kernel, lambda: conv2d_kernel(*on_card, **kw))
    again = conv2d_kernel(*on_card, **kw)
    want = conv2d_kernel.plain(*args, **kw)
    got, again, want = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, again, want))
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert torch.equal(g.cpu(), w)


# -- planned backward ---------------------------------------------------------------

# (B, H, d_in, d_out, F, S, P, block_h): odd channels, strides, ragged strips
BWD_CASES = [
    (2, 8, 3, 8, 3, 1, 1, None),
    (2, 9, 5, 7, 3, 1, 1, 4),
    (1, 12, 8, 16, 3, 2, 0, None),
    (2, 13, 6, 10, 3, 2, 1, 3),
    (3, 10, 17, 9, 3, 1, 1, 4),
    (2, 16, 64, 128, 3, 1, 1, None),
]


def _launched(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches > before
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
def test_wgrad_kernel_matches_plain_on_card(cuda, case):
    B, H, di, do, Fk, S, P, hb = case
    rng = np.random.default_rng(1)
    x = _rand(rng, B, H, H, di)
    H_O = (H + 2 * P - Fk) // S + 1
    dy = _rand(rng, B, H_O, H_O, do)
    got = _launched(conv2d_wgrad_kernel, lambda: conv2d_wgrad(
        x.to(cuda), dy.to(cuda), F=Fk, stride=S, padding=P, block_h=hb))
    want = conv2d_wgrad(x, dy, F=Fk, stride=S, padding=P, block_h=hb)
    assert_close(got, want)


# (B, H, d_in, d_out, S, block_h, block_do, block_di): pinned blocks that
# reach each wgrad template -- the register kernel (F = 3, block_di a
# multiple of 4, at most 256 thread items): conv0's 3 channels padded to 4,
# a ragged stride-2 case (5 -> 13 channels, padded to 8 and 16), the
# CNN's 16/64 blocks; the simple kernel: block_di 3, and 16 x 256/8 = 512
# items.  Each runs a split sweep (one (d_i, d_o) pair, many steps).
WGRAD_DISPATCH = [
    (4, 16, 3, 64, 1, 8, 64, 8),
    (3, 17, 5, 13, 2, 4, 16, 8),
    (2, 16, 64, 128, 1, 4, 64, 16),
    (2, 9, 5, 7, 1, 4, 8, 3),
    (2, 8, 16, 256, 1, 4, 256, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGRAD_DISPATCH)
def test_wgrad_templates_match_plain_and_repeat_bit_for_bit(cuda, case):
    from repro_torch.kernels.conv2d.bwd import wgrad_operands

    B, H, di, do, S, hb, bdo, bdi = case
    rng = np.random.default_rng(9)
    x, dy = _rand(rng, B, H, H, di), _rand(rng, B, (H - 1) // S + 1, (H - 1) // S + 1, do)
    xp, gp, geo = wgrad_operands(x, dy, F=3, stride=S, padding=1, block_h=hb)
    kw = dict(geo, block_do=bdo, block_di=bdi)
    got = _launched(conv2d_wgrad_kernel,
                    lambda: conv2d_wgrad_kernel(xp.to(cuda), gp.to(cuda), **kw))
    again = conv2d_wgrad_kernel(xp.to(cuda), gp.to(cuda), **kw)
    assert got.shape == (3, 3, di, do)
    assert torch.equal(got, again)
    assert_close(got, conv2d_wgrad_kernel(xp, gp, **kw))


# (m, n, k, blocks): the register NT tile with a split N loop (one block,
# eight steps), without one (a 132-block grid), and the simple kernel's
# 8/16/16 blocks with a split.
NT_DISPATCH = [
    (64, 256, 128, (64, 32, 128)),
    (768, 96, 1408, (64, 32, 128)),
    (40, 80, 96, (8, 16, 16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,blocks", NT_DISPATCH)
def test_nt_templates_match_plain_and_repeat_bit_for_bit(cuda, m, n, k, blocks):
    bm, bn, bk = blocks
    rng = np.random.default_rng(10)
    g, w = _rand(rng, m, n), _rand(rng, k, n, scale=n ** -0.5)
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    got = _launched(matmul_nt_kernel, lambda: matmul_nt_kernel(g.to(cuda), w.to(cuda), **kw))
    assert torch.equal(got, matmul_nt_kernel(g.to(cuda), w.to(cuda), **kw))
    assert_close(got, g.double() @ w.double().t())


# (m, n, k, blocks): the register TN tile with a split M loop (a 2 x 2
# grid, eight M steps), without one (a 12 x 12 = 144-block grid), and the
# simple kernel's 8/16/16 blocks with a split.
TN_DISPATCH = [
    (256, 256, 128, (32, 128, 64)),
    (96, 1536, 768, (32, 128, 64)),
    (40, 80, 96, (8, 16, 16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,blocks", TN_DISPATCH)
def test_tn_templates_match_plain_and_repeat_bit_for_bit(cuda, m, n, k, blocks):
    from repro_torch.kernels.matmul.bwd import tn_split

    bm, bn, bk = blocks
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    assert (tn_split(m=m, n=n, k=k, **kw) > 1) == (m != 96)
    rng = np.random.default_rng(11)
    x, g = _rand(rng, m, k), _rand(rng, m, n, scale=m ** -0.5)
    got = _launched(matmul_tn_kernel, lambda: matmul_tn_kernel(x.to(cuda), g.to(cuda), **kw))
    assert torch.equal(got, matmul_tn_kernel(x.to(cuda), g.to(cuda), **kw))
    assert_close(got, x.double().t() @ g.double())


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
def test_dgrad_matches_plain_on_card(cuda, case):
    from repro_torch.kernels.conv2d.conv2d import conv2d_kernel

    B, H, di, do, Fk, S, P, hb = case
    rng = np.random.default_rng(2)
    H_O = (H + 2 * P - Fk) // S + 1
    dy = _rand(rng, B, H_O, H_O, do)
    f = _rand(rng, Fk, Fk, di, do, scale=1 / Fk)
    got = _launched(conv2d_kernel, lambda: conv2d_dgrad(
        dy.to(cuda), f.to(cuda), stride=S, padding=P, out_hw=(H, H), block_h=hb))
    want = conv2d_dgrad(dy, f, stride=S, padding=P, out_hw=(H, H), block_h=hb)
    assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(37, 90, 70), (256, 4096, 1000), (256, 2048, 4096)])
def test_matmul_bwd_kernels_match_plain_on_card(cuda, m, k, n):
    rng = np.random.default_rng(3)
    x, w, g = _rand(rng, m, k), _rand(rng, k, n), _rand(rng, m, n)
    dx = _launched(matmul_nt_kernel, lambda: matmul_dx(g.to(cuda), w.to(cuda)))
    dw = _launched(matmul_tn_kernel, lambda: matmul_dw(x.to(cuda), g.to(cuda)))
    assert_close(dx, g.double() @ w.double().t())
    assert_close(dw, x.double().t() @ g.double())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(37, 90, 70), (128, 4096, 1000), (128, 2048, 4096)])
def test_fused_dxdw_kernel_matches_plain_on_card(cuda, m, k, n):
    rng = np.random.default_rng(4)
    x, w, g = _rand(rng, m, k), _rand(rng, k, n), _rand(rng, m, n)
    dx, dw = _launched(matmul_dxdw_kernel,
                       lambda: matmul_dx_dw(g.to(cuda), w.to(cuda), x.to(cuda)))
    assert_close(dx, g.double() @ w.double().t())
    assert_close(dw, x.double().t() @ g.double())


# (m, n, k, blocks): the register fused kernel at one, two and three
# m-blocks (fc1 at batch 64 and 192, split 8), fc1 and fc2 at batch 128
# (splits 8 and 4), a 132-k-block grid without a split, and the simple
# kernel's 8/16/16 blocks with a split.
DXDW_DISPATCH = [
    (64, 4096, 2048, (64, 32, 128)),
    (128, 4096, 2048, (64, 32, 128)),
    (128, 1024, 4096, (64, 32, 128)),
    (192, 4096, 2048, (64, 32, 128)),
    (128, 256, 16896, (64, 32, 128)),
    (40, 80, 96, (8, 16, 16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,blocks", DXDW_DISPATCH)
def test_dxdw_templates_match_plain_and_repeat_bit_for_bit(cuda, m, n, k, blocks):
    from repro_torch.kernels.matmul.bwd import dxdw_split, dxdw_template

    bm, bn, bk = blocks
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    assert (dxdw_template(bm, bn, bk, m) == "register") == (bm == 64)
    assert (dxdw_split(m=m, n=n, k=k, **kw) > 1) == (k != 16896)
    rng = np.random.default_rng(12)
    x, w, g = _rand(rng, m, k), _rand(rng, k, n, scale=k ** -0.5), _rand(rng, m, n)
    args = (g.to(cuda), w.to(cuda), x.to(cuda))
    dx, dw = _launched(matmul_dxdw_kernel, lambda: matmul_dxdw_kernel(*args, **kw))
    dx2, dw2 = matmul_dxdw_kernel(*args, **kw)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert_close(dx, g.double() @ w.double().t())
    assert_close(dw, x.double().t() @ g.double())


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [1, 2])
def test_conv_block_grads_on_card(cuda, pool):
    """conv_block's planned backward (mask scatter + dgrad + wgrad) on the
    card against the same layer's backward on the CPU."""
    rng = np.random.default_rng(5)
    x, f, b = _rand(rng, 2, 10, 10, 6), _rand(rng, 3, 3, 6, 16, scale=1 / 3), _rand(rng, 16)
    g = _rand(rng, 2, 10 // pool, 10 // pool, 16)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_(True) for t in (x, f, b)]
        out = conv_block(*leaves, 1, 1, pool, "strip")
        grads.append(torch.autograd.grad(out, leaves, g.to(dev)))
    for got, want in zip(*grads):
        assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["alg1", "alg2", "alg3", "strip"])
def test_conv_layer_strategies_at_the_running_example_on_card(cuda, strategy):
    """conv_layer under each paper strategy at the running example (W_I 32,
    D_I = D_O = 128, F 3, P 1): one direct conv launch, within TOL of the
    same layer on the CPU (the kernel's plain version, the same blocks)."""
    rng = np.random.default_rng(11)
    x, f = _rand(rng, 32, 32, 128), _rand(rng, 3, 3, 128, 128, scale=1 / 34)
    before = conv2d_kernel.launches
    got = conv_layer(x.to(cuda), f.to(cuda), 1, 1, strategy)
    torch.cuda.synchronize()
    assert conv2d_kernel.launches == before + 1
    assert_close(got, conv_layer(x, f, 1, 1, strategy))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [96, 256])
def test_fc_layer_grads_on_card(cuda, m):
    """fc_layer's planned backward on the card (fused at m=96, the dX/dW
    pair at m=256) against autograd of the plain product."""
    rng = np.random.default_rng(6)
    x, w, g = _rand(rng, m, 512), _rand(rng, 512, 300), _rand(rng, m, 300)
    sd = fc_plan_bwd((m, 512), (512, 300))
    assert (sd["dx"].algorithm == "fused_dxdw") == (m == 96)
    xc, wc = x.to(cuda).requires_grad_(True), w.to(cuda).requires_grad_(True)
    dx, dw = torch.autograd.grad(fc_layer(xc, wc, None, sd), (xc, wc), g.to(cuda))
    assert_close(dx, g.double() @ w.double().t())
    assert_close(dw, x.double().t() @ g.double())


# (B, Hq, Hkv, Sq, Skv, D, causal, window) — blocks from the H100 planner
FLASH_CASES = [
    (2, 4, 4, 256, 256, 64, True, None),
    (1, 4, 2, 200, 200, 128, True, None),
    (1, 4, 4, 300, 300, 64, True, 64),
    (2, 2, 1, 100, 180, 64, False, None),
    (1, 4, 2, 300, 150, 64, True, 32),  # rows 181.. see no key
    (2, 4, 2, 256, 256, 32, True, None),  # D = 32, the smoke configs' 4/2 heads
    (1, 4, 2, 100, 100, 32, True, 40),  # 104/104 blocks: P in chunks of 64 and 40
    (1, 8, 4, 300, 300, 256, True, None),  # D = 256, gemma3-4b's 8/4 heads: 32/32 blocks
    (1, 8, 4, 200, 200, 256, False, None),
    (2, 4, 4, 1, 512, 64, True, None),  # a slot decode's cell: one query, block_q 8
    (2, 4, 2, 64, 512, 64, True, None),  # a bucket prefill's: queries short of the cache
    (1, 64, 8, 256, 256, 128, True, None),  # qwen3-32b's and chameleon-34b's GQA 64/8
    (1, 8, 4, 2048, 2048, 256, True, 1024),  # gemma3-4b's local layers: window 1024
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, case):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_kernel

    B, Hq, Hkv, Sq, Skv, D, causal, window = case
    rng = np.random.default_rng(7)
    q, k, v = _rand(rng, B, Hq, Sq, D), _rand(rng, B, Hkv, Skv, D), _rand(rng, B, Hkv, Skv, D)
    got = _launched(flash_attention_kernel, lambda: flash_attention(
        q.to(cuda), k.to(cuda), v.to(cuda), causal=causal, window=window))
    want = flash_attention(q, k, v, causal=causal, window=window)
    assert_close(got, want)
    if window == 32:
        assert torch.all(got[:, :, 181:].cpu() == 0) and torch.all(want[:, :, 181:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_kernel_repeats_bit_for_bit(cuda, d):
    """Two launches on the same inputs give the same bits, at each head dim's
    instantiation and the planner's blocks."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(12)
    q, k, v = _rand(rng, 1, 4, 256, d), _rand(rng, 1, 2, 256, d), _rand(rng, 1, 2, 256, d)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    a = flash_attention(q, k, v, causal=True, window=None)
    b = flash_attention(q, k, v, causal=True, window=None)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_planned_transformer_grads_on_card(cuda):
    """The planned smoke-transformer loss and every gradient on the card
    (matmul, NT/TN and flash kernels; head_dim 64) against the same step on
    the CPU."""
    import dataclasses

    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.module import init_params
    from repro_torch.runtime import train as tr

    cfg = dataclasses.replace(smoke_config("qwen1.5-0.5b"), n_layers=2, n_heads=2,
                              n_kv_heads=2, head_dim=64)
    params = init_params(tf.param_defs(cfg), 0, device="cpu")
    rng = np.random.default_rng(8)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32))
             for k in ("tokens", "labels")}
    loss_fn = tr.make_loss_fn(cfg, TrainConfig(planned_kernels=True, loss_chunks=4))
    out = []
    for dev in (cuda, torch.device("cpu")):
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, {k: v.to(dev) for k, v in batch.items()})
        out.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    (loss_c, grads_c), (loss_p, grads_p) = out
    assert_close(loss_c, loss_p)
    for got, want in zip(grads_c, grads_p):
        assert_close(got, want)


@pytest.mark.cuda
def test_autotune_measures_with_cuda_events_on_card(cuda, tmp_path, monkeypatch):
    """The stopwatch times a launch with CUDA events on the card, and a
    tuned matmul cell's winner replays from the cache and runs."""
    from repro_torch.plan import autotune as at

    monkeypatch.setattr(at, "_POLICY", "off")
    rng = np.random.default_rng(13)
    x, w = _rand(rng, 64, 64).to(cuda), _rand(rng, 64, 128).to(cuda)
    us = at._measure(lambda: matmul_kernel(x, w, block_m=64, block_n=128, block_k=32),
                     iters=3, warmup=1, device=x.device)
    assert 0.0 < us < 1e6
    cache = at.AutotuneCache(str(tmp_path / "autotune.json"))
    shape = dict(m=64, n=256, k=128, in_bytes=4)
    rep = at.tune("matmul", cache=cache, topk=3, device=cuda, **shape)
    assert not rep.cached and all(t > 0 for _, t, _ in rep.measurements)
    replay = at.tune("matmul", cache=cache, topk=3, device=cuda, **shape)
    assert replay.cached and replay.schedule.blocks == rep.schedule.blocks
    xs, ws = _rand(rng, 64, 128).to(cuda), _rand(rng, 128, 256).to(cuda)
    assert_close(fc_matmul(xs, ws, schedule=replay.schedule), xs @ ws)


@pytest.mark.cuda
def test_checkpoint_of_card_tensors_restores_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import TrainState

    rng = np.random.default_rng(14)
    params = {"w": _rand(rng, 9, 4).to(cuda), "b": _rand(rng, 4).to(cuda),
              "h": _rand(rng, 5, 3).to(cuda).to(torch.bfloat16)}
    state = TrainState(params, adamw.AdamWState(3, {k: v.float() * 2 for k, v in params.items()},
                                                {k: v.float() ** 2 for k, v in params.items()}))
    ckpt.save_async(str(tmp_path), 3, state, n_chunks=2).join()
    out = ckpt.restore(str(tmp_path), 3, state, device=cuda)
    assert out.opt.step == 3
    for a, b in ((out.params, state.params), (out.opt.m, state.opt.m), (out.opt.v, state.opt.v)):
        for k in b:
            assert a[k].device.type == "cuda" and a[k].dtype == b[k].dtype
            assert torch.equal(a[k], b[k])


@pytest.mark.cuda
def test_remat_gradients_are_bit_identical_on_card(cuda):
    """The planned smoke transformer (head_dim 64) on the card: the
    gradients under remat "block" and "dots" are the bits of "none"."""
    import dataclasses

    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.module import init_params
    from repro_torch.runtime import train as tr

    cfg = dataclasses.replace(smoke_config("qwen1.5-0.5b"), n_layers=2, n_heads=2,
                              n_kv_heads=2, head_dim=64)
    params = init_params(tf.param_defs(cfg), 0, device=cuda)
    rng = np.random.default_rng(15)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)).to(cuda)
             for k in ("tokens", "labels")}
    out = {}
    for remat in ("none", "block", "dots"):
        loss_fn = tr.make_loss_fn(cfg, TrainConfig(planned_kernels=True, loss_chunks=4,
                                                   remat=remat))
        out[remat] = tr.loss_and_grads(loss_fn, params, batch)
    for remat in ("block", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for k in params:
            assert torch.equal(out[remat][1][k], out["none"][1][k]), (remat, k)


@pytest.mark.cuda
def test_serving_engine_matches_greedy_generate_on_card(cuda):
    """The smoke qwen3-1.7b served on the card through the bucketed engine
    gives each request the tokens of the port's greedy_generate on the
    card (ragged prompts across both rungs of the ladder)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.module import init_params
    from repro_torch.runtime.serve import greedy_generate
    from repro_torch.serve import DONE, BucketLadder, Engine

    cfg = smoke_config("qwen3-1.7b")
    params = init_params(tf.param_defs(cfg), 0, device=cuda)
    rng = np.random.default_rng(16)
    # Perturbed so the greedy streams vary (as the CPU serving tests do).
    params = {k: v + torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.5).to(cuda)
        for k, v in params.items()}
    engine = Engine(cfg, params, BucketLadder([(2, 8), (4, 24)], max_seq=32))
    engine.warmup(policy="off")
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (3, 8, 11, 17, 5, 24)]
    reqs = [engine.submit(prompt=p, max_new_tokens=6) for p in prompts]
    engine.run_until_idle()
    assert all(r.state == DONE for r in reqs)
    assert engine.cache["k"].device.type == "cuda"
    for r, p in zip(reqs, prompts):
        ref = greedy_generate(cfg, params, torch.from_numpy(p)[None, :].to(cuda), steps=6,
                              max_seq=32)[0]
        assert r.tokens == ref.tolist(), (len(p), r.tokens, ref.tolist())
    assert len({tuple(r.tokens) for r in reqs}) > 1


@pytest.mark.cuda
def test_serving_warmup_tunes_on_the_kernels_and_replays(cuda, tmp_path, monkeypatch):
    """A policy-tune warmup of a small ladder times the bucket cells on the
    matmul and flash-attention kernels (their launch counts move); a second
    ladder on the same cache file replays every cell cache-only, with the
    autotuner's timing path rigged to raise."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
    from repro_torch.plan import autotune as at
    from repro_torch.serve import BucketLadder

    cfg = smoke_config("qwen3-1.7b")
    kernels = {"matmul": matmul_kernel, "flash_attention": flash_attention_kernel}
    for k in kernels.values():
        monkeypatch.setattr(k, "launches", 0)
    path = str(tmp_path / "serve.json")
    tuned = BucketLadder([(2, 8), (4, 16)], max_seq=24).warmup(
        cfg, policy="tune", cache=at.AutotuneCache(path), device=cuda)
    assert {s for cells in tuned.values() for s in cells.values()} <= {"tuned", "cached"}
    assert all(k.launches > 0 for k in kernels.values()), {
        n: k.launches for n, k in kernels.items()}

    def _no_timing(*a, **kw):
        raise AssertionError("the cache-only warmup timed a candidate")

    monkeypatch.setattr(at, "_measure", _no_timing)
    monkeypatch.setattr(at, "tune", _no_timing)
    ladder = BucketLadder([(2, 8), (4, 16)], max_seq=24)
    replayed = ladder.warmup(cfg, policy="cache-only", cache=at.AutotuneCache(path),
                             device=cuda)
    assert {s for cells in replayed.values() for s in cells.values()} == {"cached"}


@pytest.mark.cuda
def test_moe_slot_decode_dispatches_per_row_on_card(cuda):
    """The smoke MoE on the card, its router zeroed so that every slot
    picks experts 0 and 1: the batched slot decode gives each slot the
    logits of a batch-1 call at its position (each slot dispatches
    alone), and the card's logits equal the CPU's."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    from repro_torch.models.module import init_params
    from repro_torch.runtime import serve as sv

    cfg = smoke_config("qwen3-moe-235b-a22b")
    cpu = init_params(moe.param_defs(cfg), 0, device="cpu")
    cpu["layers/moe/router"].zero_()
    params = {k: v.to(cuda) for k, v in cpu.items()}
    lens = torch.tensor([4, 11, 7], dtype=torch.int32)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 12)).astype(np.int32))
    pre, dec = sv.make_bucket_prefill_step(cfg, 24), sv.make_slot_decode_step(cfg)
    cache, logits = pre(params, tok.to(cuda), lens.to(cuda))
    ccache, clogits = pre(cpu, tok, lens)
    assert_close(logits, clogits)
    nxt = torch.argmax(clogits, -1)
    rows = [{k: v[:, i:i + 1].clone() for k, v in cache.items()} for i in range(3)]
    cache, logits = dec(params, cache, nxt.to(cuda), lens.to(cuda))
    _, clogits = dec(cpu, ccache, nxt, lens)
    assert_close(logits, clogits)
    for i in range(3):
        _, li = dec(params, rows[i], nxt[i:i + 1].to(cuda), lens[i:i + 1].to(cuda))
        assert_close(logits[i], li[0])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b", "rwkv6-1.6b",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_family_cached_decode_matches_forward_on_card(cuda, arch):
    """Each new family's smoke config on the card: a prefill and 4 cached
    decode steps against a no-cache forward over the same tokens (Zamba2's
    right-padded to its SSD chunk), and the card's logits against the
    CPU's; capacity factor 16 for the MoE (no row dropped)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import mamba2
    from repro_torch.models.module import init_params
    from repro_torch.models.registry import get_family
    from repro_torch.runtime import serve as sv

    cfg = dataclasses.replace(smoke_config(arch), capacity_factor=16.0)
    fam = get_family(cfg.family)
    cpu = init_params(fam.param_defs(cfg), 0, device="cpu")
    params = {k: v.to(cuda) for k, v in cpu.items()}
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = _rand(rng, 2, cfg.enc_seq, cfg.d_model)
    cache, logits = sv.make_prefill_step(cfg, 24, "float32", "float32")(
        params, {k: v.to(cuda) for k, v in batch.items()})
    _, clogits = sv.make_prefill_step(cfg, 24, "float32", "float32")(cpu, batch)
    assert_close(logits, clogits)
    dec = sv.make_decode_step(cfg, "float32")
    seq, got = batch["tokens"].to(cuda), []
    for step in range(4):
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        seq = torch.cat([seq, nxt], 1)
        cache, logits = dec(params, cache, nxt, 16 + step)
        got.append(logits[:, 0])
    full = seq
    if cfg.family == "zamba2":
        full = torch.nn.functional.pad(seq, (0, mamba2.CHUNK - seq.shape[1]))
    kw = {"frames": batch["frames"].to(cuda)} if "frames" in batch else {}
    with torch.no_grad():
        h, _ = fam.forward(cfg, params, full, **kw)
        want = fam.logits(cfg, params, h[:, 16:20])
    for i in range(4):
        assert_close(got[i], want[:, i])


# ---------------------------------------------------------------------------
# The multi-device half: gloo ranks sharing the one card
# ---------------------------------------------------------------------------


def _ranks_helper():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _torch_ranks

    return _torch_ranks


@pytest.mark.cuda
def test_sharded_layers_on_card_ranks_sharing_one_device(cuda, tmp_path):
    """2 gloo ranks on one card (CUDA tensors staged through the host):
    fc_layer_sharded under psum, ring, tp, batch and the planner's pick
    (forward and both gradients), ring_matmul, the conv2d op's batch and
    stack partitions and int8_psum, against plain references on the CPU."""
    from repro_torch.kernels.conv2d.ref import conv2d_fused_ref

    _ranks_helper().run_ranks("fc", 2, tmp_path, {"device": "cuda"}, timeout=300)
    ranks = [dict(np.load(tmp_path / f"fc_rank{r}.npz")) for r in range(2)]
    rng = np.random.default_rng(3)
    x, w = rng.standard_normal((8, 64)), rng.standard_normal((64, 40))
    y = x @ w
    want = {"y": y, "gx": 2 * y @ w.T, "gw": x.T @ (2 * y)}
    rng = np.random.default_rng(2)
    x2, w2 = rng.standard_normal((16, 32)), rng.standard_normal((32, 24))
    rng = np.random.default_rng(4)
    xc, fc, bc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((8, 8, 8, 3), (3, 3, 3, 8), (8,)))
    conv = conv2d_fused_ref(xc, fc, bc, padding=1, relu=True, pool=2)
    for r in ranks:
        for st in ("psum", "ring", "tp", "batch", "auto"):
            for part, v in want.items():
                assert_close(torch.from_numpy(r[f"{st}.{part}"]), torch.from_numpy(v))
        assert int(r["ring.fwd_ppermutes"]) == 1
        assert_close(torch.from_numpy(r["ring_matmul.y"]), torch.from_numpy(x2 @ w2))
        for st in ("batch", "stack"):
            assert_close(torch.from_numpy(r[f"conv.{st}"]), conv, tol=2e-4)


@pytest.mark.cuda
def test_data_parallel_cnn_step_on_card_ranks_sharing_one_device(cuda, tmp_path):
    """3 planned data-parallel AdamW steps of the smoke CNN on 2 gloo ranks
    sharing the card (plain, accumulated, int8_ef) against the plain
    single-device step on the CPU from the same weights and batches."""
    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.models import cnn
    from repro_torch.models.module import init_params
    from repro_torch.runtime import train as tr

    cfg = smoke_config("cnn-vgg11")
    params = init_params(cnn.param_defs(cfg), 0, device="cpu")
    src = cnn.data_source(cfg, 8, ShardInfo(0, 1), seed=0)
    batches = [src(i) for i in range(3)]
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in params.items()})
    np.savez(tmp_path / "batches.npz",
             **{f"{k}{i}": v for i, b in enumerate(batches) for k, v in b.items()})
    _ranks_helper().run_ranks("dp", 2, tmp_path, {"mesh": [2], "steps": 3,
                                                  "device": "cuda"}, timeout=300)
    ranks = [dict(np.load(tmp_path / f"dp_rank{r}.npz")) for r in range(2)]
    for variant in ("planned", "accum", "int8_ef"):
        tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                           learning_rate=3e-4, warmup_steps=1, total_steps=3,
                           grad_compression="int8_ef" if variant == "int8_ef" else "none")
        step, state = tr.make_train_step(cfg, tcfg), tr.init_state(cfg, tcfg, params)
        losses = []
        for b in batches:
            b = tr.batch_to(b, "cpu")
            if variant == "accum":
                b = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:]) for k, v in b.items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        for r in ranks:
            assert_close(torch.from_numpy(r[f"{variant}.losses"]), torch.tensor(losses))
            for k, v in state.params.items():
                got = torch.from_numpy(r[f"{variant}.{k}"])
                if variant == "int8_ef":  # rounding ties: one quantum apart
                    off = (got - v).abs() > TOL * max(1.0, float(v.abs().max()))
                    assert int(off.sum()) <= max(2, int(1e-3 * v.numel())), k
                else:
                    assert_close(got, v)
