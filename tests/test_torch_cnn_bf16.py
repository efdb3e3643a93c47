"""The CNN's bf16 route (``compute_dtype="bfloat16"``, the JAX package's
default) against the JAX package's, on the CPU: bf16 activations against
the f32 filters and weights through the conv, dgrad, wgrad, im2col and FC
kernels, as ``repro``'s type promotion runs them.

* The repaired faults: the plain bf16 forward rounds each conv stage to the
  input's dtype and promotes fc1 to f32 (``repro``'s ``conv2d_fused_ref``
  and ``@``); the conv backward keeps dY's dtype into the kernels.
* Each route's plain version against its ``repro`` oracle at ragged
  shapes: the conv forward against ``conv2d_fused_ref``, dgrad and wgrad
  against ``conv2d_dgrad_ref``/``conv2d_wgrad_ref`` and ``epilogue_scatter``,
  the forward matmul, NT and the fused dX/dW against the Pallas kernels
  interpreted on bf16 x f32 operands.
* The dtype route of the planned bf16 step, kernel by kernel.
* The planned bf16 smoke-CNN step (``runtime/train.py::make_loss_fn``)
  against ``jax.grad`` of ``repro``'s loss built from its public pieces:
  ``conv2d_fused_ref`` for the conv stages (``repro``'s direct conv and
  wgrad cannot run here: ``pl.unblocked``), ``repro.core.fc_layer`` with
  ``repro``'s schedules (its kernels interpreted), the loss of
  ``repro/models/cnn.py::make_loss_fn``.
* The plan at two bytes an element, and the full-width ``cnn-vgg11`` step
  at batch 256 and 128 through the kernels' ``meta`` route.

Tolerances (those of tests/test_torch_bf16.py where they apply):
* bf16 outputs: within one bf16 ulp of ``repro``'s, the ulp taken at
  max(|ref|, 2^-8 max|ref|) (two f32 sums in another order, rounded once);
* f32 outputs of bf16 x f32 operands: F32_TOL = 1e-5 * max(1, max|ref|);
* the plain bf16 forward: 1e-5 of scale (3.3e-7 measured: both packages
  round each stage's f32 sums once; a stage kept in f32 lies about 4e-3
  of scale away);
* the planned bf16 step: the loss within LOSS_RTOL = 1e-3 relative, every
  gradient within GRAD_TOL = 3e-2 * max(1, max|ref|) (bf16 activations
  rounded where XLA and PyTorch round them).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import machine as jm
from repro.core.fc_layer import fc_layer as jfc_layer
from repro.kernels.conv2d import bwd as jcb
from repro.kernels.conv2d.ref import conv2d_fused_ref as jconv_fused_ref
from repro.kernels.matmul.bwd import matmul_dx_dw_pallas, matmul_nt_pallas
from repro.kernels.matmul.matmul import matmul_pallas
from repro.models import cnn as jcnn
from repro.models.module import init_params as jax_init_params
from repro_torch.configs import TrainConfig, get_config, smoke_config
from repro_torch.convert import params_from_repro
from repro_torch.core import conv_layer as cl
from repro_torch.core import machine as tm
from repro_torch.kernels.conv2d import bwd as cb
from repro_torch.kernels.conv2d.ops import conv2d, conv2d_with_mask
from repro_torch.kernels.conv2d.ref import conv2d_fused_ref, conv2d_ref
from repro_torch.kernels.matmul import bwd as mb
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.models import cnn
from repro_torch.plan import get_op
from repro_torch.runtime import train as tr

ck = importlib.import_module("repro_torch.kernels.conv2d.conv2d")

BF, F32 = torch.bfloat16, torch.float32
B = 8
F32_TOL = 1e-5
PLAIN_TOL = 1e-5
GRAD_TOL = 3e-2
LOSS_RTOL = 1e-3


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32), np.float64)


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers (8 significant bits) at |a|."""
    return np.ldexp(1.0, np.frexp(np.maximum(np.abs(a), 2.0 ** -126))[1] - 8)


def assert_within_ulp(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    floor = 2.0 ** -8 * float(np.abs(want).max())
    err = np.abs(got - want)
    assert bool((err <= bf16_ulp(np.maximum(np.abs(want), floor))).all()), float(err.max())


def assert_close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _pair(rng, *shape, scale=1.0, dtype=BF):
    """The same numbers for both packages: (torch tensor, jnp array), bf16
    activations or f32 weights."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    t = torch.from_numpy(a).to(dtype)
    j = jnp.asarray(t.float().numpy())
    return t, (j.astype(jnp.bfloat16) if dtype == BF else j)


@pytest.fixture(scope="module")
def smoke():
    """repro's smoke CNN weights (f32), the port's copy, a bf16 batch."""
    jcfg, cfg = jax_smoke_config("cnn-vgg11"), smoke_config("cnn-vgg11")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(
        jcnn.param_defs(jcfg), jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, cnn.IMG, cnn.IMG, cnn.IN_CH)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, B).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, tree=tree, images=images, labels=labels)


# -- the repaired faults ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [BF, F32])
def test_plain_forward_matches_repro(smoke, dtype):
    """cnn.forward(use_kernels=False) on bf16 images within 1e-5 of scale of
    repro's: each conv stage rounded to bf16 as repro's conv2d_fused_ref
    rounds it (kept in f32 it lies about 4e-3 of scale away), fc1 the
    promoted f32 product; and at f32."""
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    want = jcnn.forward(smoke["jcfg"], smoke["tree"],
                        jnp.asarray(smoke["images"]).astype(jdt), use_kernels=False)
    got = cnn.forward(smoke["cfg"], params_from_repro(smoke["tree"], device="cpu"),
                      torch.from_numpy(smoke["images"]).to(dtype), use_kernels=False)
    assert got.dtype == F32 and want.dtype == jnp.float32
    assert_close(got, want, PLAIN_TOL)


@pytest.mark.parametrize("out_dtype", [None, F32])
def test_conv_refs_return_repros_dtype(out_dtype):
    """conv2d_ref and conv2d_fused_ref compute in f32 and return out_dtype
    or x's dtype, as repro's do: the f32 result rounded once."""
    rng = np.random.default_rng(1)
    (x, jx), (f, jf) = _pair(rng, 2, 9, 9, 5), _pair(rng, 3, 3, 5, 7, scale=0.3, dtype=F32)
    b, jb = _pair(rng, 7, dtype=F32)
    jout = None if out_dtype is None else jnp.float32
    got = conv2d_fused_ref(x, f, b, padding=1, relu=True, pool=2, out_dtype=out_dtype)
    want = jconv_fused_ref(jx, jf, jb, padding=1, relu=True, pool=2, out_dtype=jout)
    assert got.dtype == (out_dtype or BF) and str(want.dtype) == str(got.dtype).split(".")[1]
    assert torch.equal(got, conv2d_fused_ref(x.float(), f, b, padding=1, relu=True,
                                             pool=2).to(got.dtype))
    if out_dtype is None:
        assert_within_ulp(got, want)
    else:
        assert_close(got, want, F32_TOL)
    plain = conv2d_ref(x, f, stride=2, out_dtype=out_dtype)
    assert plain.dtype == (out_dtype or BF)


@pytest.mark.parametrize("pool", [1, 2])
def test_epilogue_scatter_keeps_dy_dtype(pool):
    """The epilogue VJP routes a bf16 dY in bf16 (nothing rounds): equal to
    repro's f32 scatter of the same values."""
    rng = np.random.default_rng(2)
    g, jg = _pair(rng, 2, 4, 5, 6)
    hi = 2 if pool == 1 else pool * pool + 1
    mask = rng.integers(0, hi, g.shape).astype(np.int8)
    got = cb.epilogue_scatter(g, torch.from_numpy(mask), pool)
    want = jcb.epilogue_scatter(jg, jnp.asarray(mask), pool)
    assert got.dtype == BF
    assert np.array_equal(_np(got), _np(want))


@pytest.mark.parametrize("algorithm", ["direct", "im2col"])
def test_conv_backward_keeps_dy_dtype(monkeypatch, algorithm):
    """conv_block's backward hands dY to dgrad and wgrad in its own dtype
    (bf16), takes f32 dX and dW from them and casts dX to x's dtype and dW
    to f's; the bias gradient is the f32 sum of the full-rate dY.  With an
    im2col forward (no mask) the recompute conv writes f32."""
    seen = []
    for name in ("conv2d_dgrad", "conv2d_wgrad", "conv2d"):
        real = getattr(cl, name)

        def spy(a, b, *args, real=real, name=name, **kw):
            out = real(a, b, *args, **kw)
            seen.append((name, a.dtype, b.dtype, out.dtype))
            return out
        monkeypatch.setattr(cl, name, spy)
    rng = np.random.default_rng(3)
    x = _pair(rng, 2, 8, 8, 5)[0].requires_grad_(True)
    f = _pair(rng, 3, 3, 5, 8, scale=0.3, dtype=F32)[0].requires_grad_(True)
    b = _pair(rng, 8, scale=0.1, dtype=F32)[0].requires_grad_(True)
    sched = get_op("conv2d").plan(x, f, b, padding=1, relu=True, pool=2,
                                  algorithm=algorithm)
    y = cl.conv_block(x, f, b, 1, 1, 2, "strip", sched)
    assert y.dtype == BF
    g = _pair(rng, *y.shape)[0]
    dx, df, db = torch.autograd.grad(y, (x, f, b), g)
    assert (dx.dtype, df.dtype, db.dtype) == (BF, F32, F32)
    bwd = [s for s in seen if s[0] != "conv2d"]
    assert bwd == [("conv2d_dgrad", BF, F32, F32), ("conv2d_wgrad", BF, BF, F32)]
    recompute = [s for s in seen if s[0] == "conv2d"]
    assert recompute == ([("conv2d", BF, F32, F32)] if algorithm == "im2col" else [])


# -- each route's plain version against its repro oracle ------------------------------

# (B, H, d_in, d_out, S, P, pool, block_h)
CONV_CASES = [(2, 8, 3, 8, 1, 1, 2, None), (2, 9, 5, 7, 1, 1, 1, 4),
              (2, 13, 6, 10, 2, 1, 1, 3), (3, 10, 17, 9, 1, 1, 2, 4)]


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_forward_plain_matches_repro(case):
    """The conv forward at bf16 x, f32 filters and bias (direct and im2col):
    bf16 out within one ulp of repro's conv2d_fused_ref; the mask equal to
    the one taken on the f32 sums."""
    Bn, H, di, do, S, P, pool, hb = case
    rng = np.random.default_rng(4)
    (x, jx), (f, jf) = _pair(rng, Bn, H, H, di), _pair(rng, 3, 3, di, do, scale=0.3,
                                                         dtype=F32)
    b, jb = _pair(rng, do, scale=0.1, dtype=F32)
    want = jconv_fused_ref(jx, jf, jb, stride=S, padding=P, relu=True, pool=pool)
    for alg in ("direct", "im2col"):
        got = conv2d(x, f, bias=b, stride=S, padding=P, relu=True, pool=pool, block_h=hb,
                     algorithm=alg)
        assert got.dtype == BF
        assert_within_ulp(got, want)
    if S == 1:
        s = get_op("conv2d").plan(x, f, b, stride=S, padding=P, relu=True, pool=pool,
                                  algorithm="direct")
        out, mask = conv2d_with_mask(x, f, bias=b, stride=S, padding=P, pool=pool,
                                     schedule=s)
        f32_out, f32_mask = conv2d_with_mask(x.float(), f, bias=b, stride=S, padding=P,
                                             pool=pool, schedule=s)
        assert torch.equal(out, f32_out.to(BF)) and torch.equal(mask, f32_mask)


@pytest.mark.parametrize("case", CONV_CASES)
def test_dgrad_wgrad_plain_match_repro(case):
    """dgrad of a bf16 dY against f32 filters and wgrad of bf16 x and dY
    (each with and without the mask): f32 within F32_TOL of repro's
    oracles on the scattered dY."""
    Bn, H, di, do, S, P, pool, hb = case
    rng = np.random.default_rng(5)
    H_O = (H + 2 * P - 3) // S + 1
    (x, jx), (f, jf) = _pair(rng, Bn, H, H, di), _pair(rng, 3, 3, di, do, scale=0.3,
                                                         dtype=F32)
    dy, jdy = _pair(rng, Bn, H_O, H_O, do)
    dx = cb.conv2d_dgrad(dy, f, stride=S, padding=P, out_hw=(H, H), block_h=hb)
    dw = cb.conv2d_wgrad(x, dy, F=3, stride=S, padding=P, block_h=hb)
    assert dx.dtype == dw.dtype == F32
    assert_close(dx, jcb.conv2d_dgrad_ref(jdy, jf, stride=S, padding=P, out_hw=(H, H)),
                 F32_TOL)
    assert_close(dw, jcb.conv2d_wgrad_ref(jx, jdy, F=3, stride=S, padding=P), F32_TOL)
    if S == 1 and H_O % pool == 0:
        g, jg = _pair(rng, Bn, H_O // pool, H_O // pool, do)
        hi = 2 if pool == 1 else pool * pool + 1
        mask = rng.integers(0, hi, g.shape).astype(np.int8)
        full = jcb.epilogue_scatter(jg, jnp.asarray(mask), pool)
        mdx = cb.conv2d_dgrad(g, f, padding=P, out_hw=(H, H), mask=torch.from_numpy(mask),
                              pool=pool)
        mdw = cb.conv2d_wgrad(x, g, F=3, padding=P, mask=torch.from_numpy(mask), pool=pool)
        assert_close(mdx, jcb.conv2d_dgrad_ref(full, jf, padding=P, out_hw=(H, H)), F32_TOL)
        assert_close(mdw, jcb.conv2d_wgrad_ref(jx, full, F=3, padding=P), F32_TOL)


# (m, k, n, (block_m, block_n, block_k))
GEMM_CASES = [(64, 96, 128, (32, 64, 32)), (48, 160, 80, (16, 80, 32)),
              (128, 64, 64, (64, 32, 64))]


@pytest.mark.parametrize("m,k,n,blocks", GEMM_CASES)
def test_gemm_plains_match_pallas_at_bf16_x_f32(m, k, n, blocks):
    """The forward matmul (bf16 out, and f32 out as the im2col conv asks),
    NT and the fused dX/dW kernel at bf16 activations against f32 weights,
    against repro's Pallas kernels interpreted on the same operands."""
    rng = np.random.default_rng(6)
    (x, jx), (w, jw) = _pair(rng, m, k), _pair(rng, k, n, scale=k ** -0.5, dtype=F32)
    g, jg = _pair(rng, m, n)
    bm, bn, bk = blocks
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    y = mm.matmul_plain(x, w, **kw)
    assert y.dtype == BF
    assert_within_ulp(y, matmul_pallas(jx, jw, **kw, interpret=True))
    y32 = mm.matmul_plain(x, w, **kw, out_dtype=F32)
    assert y32.dtype == F32
    assert_close(y32, matmul_pallas(jx, jw, **kw, out_dtype=jnp.float32, interpret=True),
                 F32_TOL)
    jkw = dict(kw, out_dtype=jnp.float32, interpret=True)
    assert_close(mb.matmul_nt_plain(g, w, **kw), matmul_nt_pallas(jg, jw, **jkw), F32_TOL)
    dx, dw = mb.matmul_dxdw_plain(g, w, x, **kw)
    jdx, jdw = matmul_dx_dw_pallas(jg, jw, jx, **jkw)
    assert dx.dtype == dw.dtype == F32
    assert_close(dx, jdx, F32_TOL)
    assert_close(dw, jdw, F32_TOL)


def test_plain_versions_round_the_f32_product_once():
    """Each plain version at mixed operands is the f32 product of its
    operands rounded once to its output dtype; the f32 route unchanged."""
    rng = np.random.default_rng(7)
    x, f, b = (_pair(rng, 2, 10, 10, 8)[0], _pair(rng, 3, 3, 8, 16, dtype=F32)[0],
               _pair(rng, 16, dtype=F32)[0])
    kw = dict(stride=1, block_h=4, block_do=8, block_di=8, H_O=8, W_O=8, relu=True, pool=2)
    out, mask = ck.conv2d_fused_plain(x, f, b, **kw, emit_mask=True)
    o32, m32 = ck.conv2d_fused_plain(x.float(), f, b, **kw, emit_mask=True)
    assert out.dtype == BF and torch.equal(out, o32.to(BF)) and torch.equal(mask, m32)
    assert torch.equal(ck.conv2d_fused_plain(x, f, b, **kw, out_dtype=F32), o32)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)).contiguous()
    dy = _pair(rng, 2, 10, 10, 16)[0]
    wkw = dict(F=3, stride=1, block_h=5, block_do=16, block_di=8, H_O=10, W_O=10)
    dw = cb.conv2d_wgrad_plain(xp, dy, **wkw)
    assert dw.dtype == F32 and torch.equal(dw, cb.conv2d_wgrad_plain(xp.float(), dy.float(),
                                                                     **wkw))
    a, w = _pair(rng, 16, 24)[0], _pair(rng, 24, 32, dtype=F32)[0]
    mkw = dict(block_m=8, block_n=8, block_k=8)
    assert torch.equal(mm.matmul_plain(a, w, **mkw), (a.float() @ w).to(BF))
    assert torch.equal(mm.matmul_plain(a, w, **mkw, out_dtype=F32), a.float() @ w)
    g = _pair(rng, 16, 32)[0]
    assert torch.equal(mb.matmul_nt_plain(g, w, **mkw), g.float() @ w.t())
    dx, dw2 = mb.matmul_dxdw_plain(g, w, a, **mkw)
    assert torch.equal(dx, g.float() @ w.t()) and torch.equal(dw2, a.float().t() @ g.float())


def test_other_dtype_mixes_raise():
    """Only bf16 activations against f32 weights are a mixed route: bf16
    filters, f32 x against bf16 weights, activations of two dtypes and a
    bf16 matmul writing f32 raise, on the CPU and on meta."""
    for dev in ("cpu", "meta"):
        x = torch.zeros(2, 10, 10, 8, dtype=BF, device=dev)
        f = torch.zeros(3, 3, 8, 16, device=dev)
        b = torch.zeros(16, device=dev)
        kw = dict(stride=1, block_h=4, block_do=8, block_di=8, H_O=8, W_O=8)
        with pytest.raises(ValueError, match="bfloat16 x against float32 f"):
            ck.conv2d_kernel(x, f.to(BF), b, **kw)
        with pytest.raises(ValueError, match="bfloat16 x against float32 f"):
            ck.conv2d_kernel(x.float(), f, b, **kw, out_dtype=BF)
        with pytest.raises(ValueError, match="of one dtype"):
            cb.conv2d_wgrad_kernel(x, torch.zeros(2, 8, 8, 16, device=dev), F=3, stride=1,
                                   block_h=4, block_do=16, block_di=8, H_O=8, W_O=8)
        a, w = torch.zeros(64, 64, device=dev), torch.zeros(64, 64, device=dev)
        mkw = dict(block_m=32, block_n=32, block_k=32)
        with pytest.raises(ValueError, match="of one dtype"):
            mm.matmul_kernel(a, w.to(BF), **mkw)
        with pytest.raises(ValueError, match="float32 from bfloat16 x and float32 w"):
            mm.matmul_kernel(a.to(BF), w.to(BF), **mkw, out_dtype=F32)
        with pytest.raises(ValueError, match="of one dtype"):
            mb.matmul_nt_kernel(a, w.to(BF), **mkw)
        with pytest.raises(ValueError, match="of one dtype"):
            mb.matmul_tn_kernel(a.to(BF), w, **mkw)
        with pytest.raises(ValueError, match="of one dtype"):
            mb.matmul_dxdw_kernel(a.to(BF), w, a, **mkw)


def test_meta_routes_allocate_the_routes_outputs():
    """On meta each mixed route runs its launch's checks and allocates its
    outputs' dtypes (no launch is counted)."""
    d = "meta"
    x = torch.empty(2, 10, 10, 8, dtype=BF, device=d)
    f, b = torch.empty(3, 3, 8, 16, device=d), torch.empty(16, device=d)
    kw = dict(stride=1, block_h=4, block_do=8, block_di=8, H_O=8, W_O=8, relu=True, pool=2)
    before = ck.conv2d_kernel.launches
    out, mask = ck.conv2d_kernel(x, f, b, **kw, emit_mask=True)
    assert (out.dtype, mask.dtype) == (BF, torch.int8)
    assert ck.conv2d_kernel(x, f, b, **kw, out_dtype=F32).dtype == F32
    assert ck.conv2d_kernel.launches == before
    a, w, g = (torch.empty(64, 96, dtype=BF, device=d), torch.empty(96, 64, device=d),
               torch.empty(64, 64, dtype=BF, device=d))
    mkw = dict(block_m=32, block_n=32, block_k=32)
    assert mm.matmul_kernel(a, w, **mkw).dtype == BF
    assert mm.matmul_kernel(a, w, **mkw, out_dtype=F32).dtype == F32
    assert mb.matmul_nt_kernel(g, w, **mkw).dtype == F32
    assert mb.matmul_tn_kernel(a, g, **mkw).dtype == F32
    assert [t.dtype for t in mb.matmul_dxdw_kernel(g, w, a, **mkw)] == [F32, F32]


@pytest.mark.parametrize("m,want", [(64, "simple"), (128, "register"), (192, "simple"),
                                    (256, "simple")])
def test_mixed_fused_launch_takes_the_register_kernel_at_two_m_blocks(m, want):
    """The fused kernel's bf16 x f32 route is built with its register
    kernel for two m-blocks alone (fc1 at batch 128): the launch passes the
    simple kernel's choice at any other count, the one-dtype routes keep
    one to three."""

    class Sink:
        argtypes = mb.matmul_dxdw_kernel.argtypes
        operand_dtype = mb.matmul_dxdw_kernel.operand_dtype

        def run(self, *args, dtype):
            self.args, self.dtype = args, dtype

    blocks = dict(block_m=64, block_n=32, block_k=128)
    g, x = torch.zeros(m, 64, dtype=BF), torch.zeros(m, 256, dtype=BF)
    sink = Sink()
    mb._launch_dxdw(sink, g, torch.zeros(256, 64), x, **blocks)
    assert sink.dtype == (BF, F32, BF)
    assert sink.args[-1] == int(want == "register")
    assert mb.dxdw_template(64, 32, 128, m, mixed=True) == want
    assert mb.dxdw_template(64, 32, 128, m) == ("register" if m <= 192 else "simple")


def test_costs_read_each_operands_size():
    """CudaKernel.cost at the mixed routes: bf16 activations at 2 bytes,
    f32 weights and bias at 4, each output at its own dtype's size."""
    d = "meta"
    x = torch.empty(2, 10, 10, 8, dtype=BF, device=d)
    f, b = torch.empty(3, 3, 8, 16, device=d), torch.empty(16, device=d)
    kw = dict(stride=1, block_h=4, block_do=8, block_di=8, H_O=8, W_O=8, relu=True, pool=2)
    base = 2 * x.numel() + 4 * (f.numel() + b.numel())
    out = 2 * 4 * 4 * 16
    assert ck.conv2d_kernel.cost(x, f, b, **kw)[1] == base + 2 * out
    assert ck.conv2d_kernel.cost(x, f, b, **kw, emit_mask=True)[1] == base + 3 * out
    assert ck.conv2d_kernel.cost(x, f, b, **kw, out_dtype=F32)[1] == base + 4 * out
    m, k, n = 64, 96, 32
    a, w, g = (torch.empty(m, k, dtype=BF, device=d), torch.empty(k, n, device=d),
               torch.empty(m, n, dtype=BF, device=d))
    mkw = dict(block_m=32, block_n=32, block_k=32)
    assert mm.matmul_kernel.cost(a, w, **mkw)[1] == 2 * m * k + 4 * k * n + 2 * m * n
    assert mm.matmul_kernel.cost(a, w, **mkw, out_dtype=F32)[1] == (2 * m * k + 4 * k * n
                                                                     + 4 * m * n)
    assert mb.matmul_nt_kernel.cost(g, w, **mkw)[1] == 2 * m * n + 4 * k * n + 4 * m * k
    assert mb.matmul_dxdw_kernel.cost(g, w, a, **mkw)[1] == (
        2 * m * n + 4 * k * n + 2 * m * k + 4 * (m * k + k * n))


# -- the planned bf16 step ------------------------------------------------------------


def _plans(cfg, batch, algorithm):
    """plan_training at two bytes an element; with ``algorithm="im2col"``
    every conv stage on the im2col GEMM and fc1's backward on NT + TN."""
    plans = cnn.plan_training(cfg, batch, in_bytes=2, conv_algorithm=algorithm)
    if algorithm == "im2col":
        _, x_shape, w_shape = list(cnn._stage_geometry(cfg, batch))[-2]
        plans["fc1.dx"] = get_op("matmul_dx").planner_for(tm.H100).plan(
            m=x_shape[0], n=w_shape[1], k=w_shape[0], in_bytes=2)
    return plans


ROUTES = {
    None: {("conv2d", (BF, F32, F32), (BF, torch.int8)), ("conv2d", (BF, F32, F32), (F32,)),
           ("conv2d_wgrad", (BF, BF), (F32,)), ("matmul", (BF, F32), (BF,)),
           ("matmul", (F32, F32), (F32,)), ("matmul_dx_dw", (BF, F32, BF), (F32, F32)),
           ("matmul_dx_dw", (F32, F32, F32), (F32, F32))},
    "im2col": {("matmul", (BF, F32), (F32,)), ("conv2d", (BF, F32, F32), (F32,)),
               ("conv2d_wgrad", (BF, BF), (F32,)), ("matmul", (BF, F32), (BF,)),
               ("matmul", (F32, F32), (F32,)), ("matmul_nt", (BF, F32), (F32,)),
               ("matmul_tn", (BF, BF), (F32,)),
               ("matmul_dx_dw", (F32, F32, F32), (F32, F32))},
}


@pytest.mark.parametrize("algorithm", [None, "im2col"])
def test_planned_step_dtype_route(smoke, monkeypatch, algorithm):
    """Every kernel call of the planned bf16 step (forward and backward),
    by the operand and output dtypes its plain version sees: the contract
    of the CNN's bf16 route — conv forward bf16 x / f32 f and bias to bf16
    and the int8 mask, dgrad (and the im2col stage's recompute conv) to
    f32, wgrad bf16 x bf16 to f32, fc1 bf16 x f32 to bf16, the im2col GEMM
    to f32, fc1's backward bf16 dY and X against f32 W, fc2 all f32."""
    from repro_torch.kernels.matmul.matmul import matmul_kernel

    seen = set()
    kernels = [ck.conv2d_kernel, cb.conv2d_wgrad_kernel, matmul_kernel, mb.matmul_nt_kernel,
               mb.matmul_tn_kernel, mb.matmul_dxdw_kernel]
    for k in kernels:
        def spy(*a, real=k.plain, name=k.name, **kw):
            out = real(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            seen.add((name, tuple(t.dtype for t in a), tuple(o.dtype for o in outs)))
            return out
        monkeypatch.setattr(k, "plain", spy)
    cfg = smoke["cfg"]
    params = {k: v.requires_grad_(True)
              for k, v in params_from_repro(smoke["tree"], device="cpu").items()}
    images = torch.from_numpy(smoke["images"]).to(BF)
    out = cnn.forward(cfg, params, images, schedules=_plans(cfg, B, algorithm))
    assert out.dtype == F32
    torch.autograd.grad(out.square().sum(), list(params.values()))
    assert seen == ROUTES[algorithm]


def test_fc_calls_dtypes_are_repros(smoke, monkeypatch):
    """The dtypes of x and w at each fc_layer call of the planned bf16
    forward equal repro's planned bf16 forward's (its im2col plan, which
    runs interpreted here): bf16 x f32 for fc1, f32 x f32 for fc2."""
    calls = {"repro": [], "port": []}
    real_j, real_t = jcnn.fc_layer, cnn.fc_layer

    def spy_j(x, w, *a):
        calls["repro"].append((str(x.dtype), str(w.dtype)))
        return real_j(x, w, *a)

    def spy_t(x, w, *a):
        calls["port"].append((str(x.dtype).removeprefix("torch."),
                              str(w.dtype).removeprefix("torch.")))
        return real_t(x, w, *a)
    monkeypatch.setattr(jcnn, "fc_layer", spy_j)
    monkeypatch.setattr(cnn, "fc_layer", spy_t)
    images = smoke["images"][:2]
    jcnn.forward(smoke["jcfg"], smoke["tree"], jnp.asarray(images).astype(jnp.bfloat16),
                 use_kernels=True, schedules=jcnn.plan_forward(
                     smoke["jcfg"], 2, in_bytes=2, conv_algorithm="im2col"))
    cnn.forward(smoke["cfg"], params_from_repro(smoke["tree"], device="cpu"),
                torch.from_numpy(images).to(BF),
                schedules=cnn.plan_forward(smoke["cfg"], 2, in_bytes=2))
    assert calls["port"] == calls["repro"] == [("bfloat16", "float32"),
                                               ("float32", "float32")]


@pytest.fixture(scope="module")
def jax_step(smoke):
    """jax.value_and_grad of repro's planned bf16 CNN loss, built from its
    public pieces (conv2d_fused_ref stages, fc_layer with repro's
    schedules, the loss of repro/models/cnn.py::make_loss_fn)."""
    jcfg, tree = smoke["jcfg"], smoke["tree"]
    sched = jcnn.plan_training(jcfg, B, in_bytes=2)

    def loss(p, images, labels):
        x = images.astype(jnp.bfloat16)
        for i in range(jcfg.n_layers):
            x = jconv_fused_ref(x, p[f"conv{i}"], p[f"bias{i}"], stride=1, padding=1,
                                relu=True, pool=2)
        x = x.reshape(x.shape[0], -1)
        x = jax.nn.relu(jfc_layer(x, p["fc1"], sched["fc1"], jcnn._bwd_for(sched, "fc1"))
                        + p["fc1_b"])
        out = (jfc_layer(x, p["fc2"], sched["fc2"], jcnn._bwd_for(sched, "fc2"))
               + p["fc2_b"]).astype(jnp.float32)
        lse = jax.nn.logsumexp(out, -1)
        tgt = jnp.take_along_axis(out, labels[:, None], -1)[:, 0]
        return (lse - tgt).mean()

    value, grads = jax.value_and_grad(loss)(
        tree, jnp.asarray(smoke["images"]), jnp.asarray(smoke["labels"]))
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("algorithm", [None, "im2col"])
def test_planned_bf16_step_matches_repro(smoke, jax_step, algorithm):
    """TrainConfig(compute_dtype="bfloat16", planned_kernels=True) through
    runtime/train.py::make_loss_fn (the plan at two bytes an element, and
    with every conv stage on im2col and fc1's backward on NT + TN): the
    loss within LOSS_RTOL and every gradient, f32, within GRAD_TOL of
    jax.grad of repro's loss (a conv that requires one dtype of its images
    and filters raises here)."""
    cfg = smoke["cfg"]
    jloss, jgrads = jax_step
    params = {k: v.requires_grad_(True)
              for k, v in params_from_repro(smoke["tree"], device="cpu").items()}
    batch = {"images": torch.from_numpy(smoke["images"]),
             "labels": torch.from_numpy(smoke["labels"])}
    tcfg = TrainConfig(compute_dtype="bfloat16", planned_kernels=True)
    if algorithm is None:
        loss = tr.make_loss_fn(cfg, tcfg)(params, batch)
    else:
        out = cnn.forward(cfg, params, batch["images"].to(BF),
                          schedules=_plans(cfg, B, algorithm)).float()
        loss = torch.nn.functional.cross_entropy(out, batch["labels"].long())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
    for k, g in zip(params, grads):
        assert g.dtype == F32, k
        assert_close(g, jgrads[k], GRAD_TOL)


# -- the plan at two bytes an element ---------------------------------------------------


@pytest.mark.parametrize("machine", ["MANTICORE", "TPU_V5E"])
@pytest.mark.parametrize("batch", [8, 256])
def test_plan_training_bf16_matches_repro(machine, batch):
    """Off the H100 the CNN's bf16 plan is repro's, field for field (fc2
    included)."""
    cfg, jcfg = get_config("cnn-vgg11"), jax_smoke_config("cnn-vgg11")
    if batch == 8:
        cfg = smoke_config("cnn-vgg11")
    else:
        from repro.configs.registry import get_config as jax_config
        jcfg = jax_config("cnn-vgg11")
    got = cnn.plan_training(cfg, batch, in_bytes=2, machine=getattr(tm, machine))
    want = jcnn.plan_training(jcfg, batch, in_bytes=2, machine=getattr(jm, machine))
    assert set(got) == set(want)
    for k in want:
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k]), k


@pytest.mark.parametrize("batch,fc2_dx", [(256, "direct"), (128, "fused_dxdw")])
def test_h100_plans_fc2_at_its_operands_bytes(batch, fc2_dx):
    """On the H100 fc2 is planned at 4 bytes an element (its operands are
    f32 on the bf16 route): NT + TN at batch 256 (repro's 2-byte charge
    picks a fused tile of 262,144 bytes at f32, past the 232,448 one block
    holds), the fused kernel at 128; fc1 keeps the fused kernel at both
    (221,184 bytes at 256 with its f32 W tile)."""
    plans = cnn.plan_training(get_config("cnn-vgg11"), batch, in_bytes=2)
    assert plans["fc2.dx"].algorithm == fc2_dx
    assert plans["fc2"] == cnn.plan_training(get_config("cnn-vgg11"), batch)["fc2"]
    assert plans["fc1.dx"].algorithm == "fused_dxdw"
    assert mb.smem_bytes_dxdw(256, 64, 32, 128, 4) == 262_144 > tm.H100.local_mem_bytes
    assert mb.smem_bytes_dxdw(256, 64, 32, 128, 2, 4) == 221_184 <= tm.H100.local_mem_bytes


@pytest.mark.parametrize("batch", [256, 128])
def test_full_width_bf16_step_runs_on_meta(batch):
    """The planned bf16 cnn-vgg11 step at full width through the kernels'
    meta route: every launch's checks pass (each tile fits one block's
    shared memory at its operands' sizes), the gradients are f32.  Planned
    at fc2's 2 bytes, as repro plans it, the fused fc2 launch raises."""
    cfg = get_config("cnn-vgg11")
    params = {k: torch.empty(d.shape, device="meta").requires_grad_(True)
              for k, d in cnn.param_defs(cfg).items()}
    batch_t = {"images": torch.empty(batch, cnn.IMG, cnn.IMG, cnn.IN_CH, device="meta"),
               "labels": torch.zeros(batch, dtype=torch.int32, device="meta")}
    loss = tr.make_loss_fn(cfg, TrainConfig(compute_dtype="bfloat16",
                                            planned_kernels=True))(params, batch_t)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert all(g.dtype == F32 and g.device.type == "meta" for g in grads)
    if batch == 256:
        s = get_op("matmul_dx").planner_for(tm.H100).plan(m=256, n=1000, k=4096, in_bytes=2,
                                                          algorithm="fused_dxdw")
        g, w = torch.empty(256, 1000, device="meta"), torch.empty(4096, 1000, device="meta")
        with pytest.raises(ValueError, match="does not take blocks"):
            mb.matmul_dx_dw(g, w, torch.empty(256, 4096, device="meta"), schedule=s)
