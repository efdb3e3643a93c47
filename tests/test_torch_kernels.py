"""The port's kernel modules against the JAX package, on the CPU.

CPU tensors run each kernel's plain version behind the same wrappers
(padding, strips, slicing) the card runs, so these tests hold everything
around the kernels against ``repro`` on the same numpy inputs:

* ``fc_matmul`` against ``repro``'s Pallas ``fc_matmul`` in interpret mode;
* ``conv2d`` / ``conv_block`` against ``repro``'s ``conv2d_fused_ref`` (the
  Pallas direct conv cannot run interpreted under jax 0.9.0);
* the int8 epilogue mask against a numpy re-derivation of its encoding;
* the im2col forward against ``repro``'s ``conv2d_im2col`` in interpret mode.

Tolerance (f32): max |port - repro| <= 1e-5 * max(1, max |repro|) per op —
the two sum in different orders.  (``test_torch_cuda.py`` holds the kernels
themselves against their plain versions on the card.)
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d.im2col import conv2d_im2col as jax_im2col
from repro.kernels.conv2d.ref import conv2d_fused_ref as jax_fused_ref
from repro.kernels.conv2d.ref import conv2d_ref as jax_conv_ref
from repro.kernels.matmul.ops import fc_matmul as jax_fc_matmul
from repro_torch.core.conv_layer import conv_block, conv_layer
from repro_torch.kernels.conv2d import conv2d_im2col, conv2d_kernel, conv2d_with_mask
from repro_torch.kernels.conv2d.ops import conv2d
from repro_torch.kernels.matmul import fc_matmul, matmul_kernel
from repro_torch.plan.registry import CudaKernel

TOL = 1e-5
ck = importlib.import_module("repro_torch.kernels.conv2d.conv2d")
mm = importlib.import_module("repro_torch.kernels.matmul.matmul")


def assert_close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- matmul ---------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (37, 90, 70), (1, 17, 300),
                                   (130, 257, 129), (5, 3, 2)])
def test_fc_matmul_matches_repro(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    x, w = _rand(rng, m, k), _rand(rng, k, n)
    want = jax_fc_matmul(jnp.asarray(x), jnp.asarray(w))
    assert_close(fc_matmul(torch.from_numpy(x), torch.from_numpy(w)), want)


def test_fc_matmul_flattens_leading_dims():
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 2, 3, 40), _rand(rng, 40, 24)
    got = fc_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == (2, 3, 24)
    assert_close(got, x @ w)


def test_matmul_kernel_rejects_unsupported_blocks():
    x, w = torch.zeros(16, 16), torch.zeros(16, 16)
    with pytest.raises(ValueError, match="does not take blocks"):
        matmul_kernel(x, w, block_m=16, block_n=12, block_k=16)
    with pytest.raises(ValueError, match="multiple of the blocks"):
        matmul_kernel(x[:10], w, block_m=16, block_n=16, block_k=16)


# -- direct conv ----------------------------------------------------------------

# (B, H, d_in, d_out, F, S, P, pool, block_h): stride 1/2, padding, pool 1/2,
# odd channels, ragged strips (block_h not dividing H_O) and odd planes
# (ragged tail pool).
CONV_CASES = [
    (2, 8, 3, 8, 3, 1, 1, 2, None),
    (2, 9, 5, 7, 3, 1, 1, 1, 4),      # odd plane, odd channels, ragged strip
    (1, 12, 8, 16, 3, 2, 0, 1, None),  # stride 2, no padding
    (2, 13, 6, 10, 3, 2, 1, 2, None),  # stride 2, odd H_O -> tail pool
    (3, 10, 4, 9, 3, 1, 1, 2, 4),      # ragged strip at pool 2
    (1, 8, 3, 5, 5, 1, 2, 2, None),    # large filter, deep padding
    (2, 7, 17, 3, 1, 1, 0, 1, None),   # 1x1
]


def _conv_operands(case, seed=0):
    B, H, di, do, Fk, *_ = case
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, H, H, di), _rand(rng, Fk, Fk, di, do, scale=1 / Fk),
            _rand(rng, do))


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_block_matches_repro_ref(case):
    B, H, di, do, Fk, S, P, pool, hb = case
    x, f, b = _conv_operands(case)
    want = jax_fused_ref(jnp.asarray(x), jnp.asarray(f), jnp.asarray(b),
                         stride=S, padding=P, relu=True, pool=pool)
    got = conv2d(torch.from_numpy(x), torch.from_numpy(f), bias=torch.from_numpy(b),
                 stride=S, padding=P, relu=True, pool=pool, block_h=hb)
    assert_close(got, want)
    got = conv_block(torch.from_numpy(x), torch.from_numpy(f), torch.from_numpy(b),
                     S, P, pool)
    assert_close(got, want)


@pytest.mark.parametrize("strategy", ["alg1", "alg2", "strip"])
@pytest.mark.parametrize("case", CONV_CASES[1:4])
def test_conv_layer_matches_repro_ref(case, strategy):
    B, H, di, do, Fk, S, P, *_ = case
    x, f, _ = _conv_operands(case, seed=1)
    want = jax_conv_ref(jnp.asarray(x), jnp.asarray(f), stride=S, padding=P)
    got = conv_layer(torch.from_numpy(x), torch.from_numpy(f), S, P, strategy)
    assert_close(got, want)


def test_conv_unbatched_input():
    x, f, b = _conv_operands(CONV_CASES[1])
    want = jax_fused_ref(jnp.asarray(x[0]), jnp.asarray(f), jnp.asarray(b),
                         padding=1, relu=True)
    got = conv2d(torch.from_numpy(x[0]), torch.from_numpy(f),
                 bias=torch.from_numpy(b), padding=1, relu=True)
    assert_close(got, want)


# -- the epilogue mask ----------------------------------------------------------


def _numpy_mask(y: np.ndarray, pool: int) -> np.ndarray:
    """conv2d.py's flush encoding, re-derived in numpy from the post-ReLU
    pre-pool activations: the flattened argmax position in [0, pool^2) of
    the surviving window (first occurrence on ties, by overwriting in
    descending position order), pool^2 for a dead window; with pool == 1
    the ReLU liveness bit (0 alive, 1 dead)."""
    if pool == 1:
        return np.where(y > 0, 0, 1).astype(np.int8)
    B, H, W, C = y.shape
    win = y[:, : H - H % pool, : W - W % pool].reshape(
        B, H // pool, pool, W // pool, pool, C)
    out = win.max(axis=(2, 4))
    idx = np.full(out.shape, pool * pool, np.int32)
    for pos in reversed(range(pool * pool)):
        py, px = divmod(pos, pool)
        v = win[:, :, py, :, px, :]
        idx = np.where((v == out) & (out > 0), pos, idx)
    return idx.astype(np.int8)


@pytest.mark.parametrize("B,H,di,do,S,pool,hb", [
    (2, 8, 3, 8, 1, 2, None), (2, 8, 4, 9, 1, 2, 2), (1, 12, 5, 6, 2, 1, None),
    (2, 9, 3, 7, 1, 1, 4)])
def test_mask_matches_numpy_encoding(B, H, di, do, S, pool, hb):
    """Small integer operands make exact ties and dead windows common."""
    rng = np.random.default_rng(7)
    x = rng.integers(-2, 3, (B, H, H, di)).astype(np.float32)
    f = rng.integers(-1, 2, (3, 3, di, do)).astype(np.float32)
    b = rng.integers(-1, 2, (do,)).astype(np.float32)
    y = np.asarray(jax_conv_ref(jnp.asarray(x), jnp.asarray(f), stride=S, padding=1))
    y = np.maximum(y + b, 0.0)
    want = _numpy_mask(y, pool)
    sched = None
    if hb is not None:
        from repro_torch.kernels.conv2d.ops import conv2d_op

        sched = conv2d_op.plan(torch.from_numpy(x), torch.from_numpy(f),
                               torch.from_numpy(b), stride=S, padding=1, relu=True,
                               pool=pool, block_h=hb, algorithm="direct")
    out, mask = conv2d_with_mask(torch.from_numpy(x), torch.from_numpy(f),
                                 bias=torch.from_numpy(b), stride=S, padding=1,
                                 pool=pool, schedule=sched)
    assert mask is not None and mask.dtype == torch.int8
    np.testing.assert_array_equal(mask.numpy(), want)
    ties = (want < pool * pool) if pool > 1 else (want == 0)
    assert ties.any() and (~ties).any()  # both live and dead entries occur
    assert_close(out, jax_fused_ref(jnp.asarray(x), jnp.asarray(f), jnp.asarray(b),
                                    stride=S, padding=1, relu=True, pool=pool))


def test_mask_absent_on_ragged_pool_and_im2col():
    x, f, b = _conv_operands(CONV_CASES[3])
    xt, ft, bt = map(torch.from_numpy, (x, f, b))
    assert conv2d_with_mask(xt, ft, bias=bt, stride=2, padding=1, pool=2)[1] is None
    x, f, b = _conv_operands(CONV_CASES[0])
    xt, ft, bt = map(torch.from_numpy, (x, f, b))
    from repro_torch.kernels.conv2d.ops import conv2d_op

    sched = conv2d_op.plan(xt, ft, bt, padding=1, relu=True, pool=2,
                           algorithm="im2col")
    out, mask = conv2d_with_mask(xt, ft, bias=bt, padding=1, pool=2, schedule=sched)
    assert mask is None
    assert_close(out, jax_fused_ref(jnp.asarray(x), jnp.asarray(f), jnp.asarray(b),
                                    padding=1, relu=True, pool=2))


# -- im2col -----------------------------------------------------------------------


@pytest.mark.parametrize("H,di,do,Fk,S,P,pool", [
    (9, 5, 7, 3, 1, 1, 1), (12, 8, 16, 3, 2, 0, 1), (8, 4, 6, 3, 1, 1, 2)])
def test_im2col_matches_repro(H, di, do, Fk, S, P, pool):
    rng = np.random.default_rng(H + di)
    x, f, b = _rand(rng, 2, H, H, di), _rand(rng, Fk, Fk, di, do, scale=1 / Fk), _rand(rng, do)
    want = jax_im2col(jnp.asarray(x), jnp.asarray(f), bias=jnp.asarray(b),
                      stride=S, padding=P, relu=True, pool=pool)
    got = conv2d_im2col(torch.from_numpy(x), torch.from_numpy(f),
                        bias=torch.from_numpy(b), stride=S, padding=P, relu=True,
                        pool=pool)
    assert_close(got, want)
    # the conv2d op runs the same GEMM when the im2col family is pinned
    got = conv2d(torch.from_numpy(x), torch.from_numpy(f), bias=torch.from_numpy(b),
                 stride=S, padding=P, relu=True, pool=pool, algorithm="im2col")
    assert_close(got, want)


# -- dispatch -------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    before = (matmul_kernel.launches, conv2d_kernel.launches)
    x, f, b = _conv_operands(CONV_CASES[0])
    conv2d(torch.from_numpy(x), torch.from_numpy(f), bias=torch.from_numpy(b),
           padding=1, relu=True, pool=2)
    fc_matmul(torch.ones(4, 8), torch.ones(8, 8))
    assert (matmul_kernel.launches, conv2d_kernel.launches) == before


def test_kernel_refuses_other_devices_and_mixed_operands():
    """CPU tensors run the plain version, ``meta`` tensors the launch's
    checks and allocations with nothing launched (the dry run's route);
    any other device and mixed operands raise; nothing counts a launch."""
    import types

    k = CudaKernel("probe", source="matmul", symbol="none", argtypes=[],
                   launch=lambda kernel, *a, **kw: (kernel.run(), "launch")[1],
                   plain=lambda *a, **kw: "plain", cost=lambda *a, **kw: (0.0, 0.0))
    assert k(torch.zeros(1)) == "plain"
    assert k(torch.zeros(1, device="meta")) == "launch"
    other = types.SimpleNamespace(device=torch.device("xpu"), requires_grad=False)
    with pytest.raises(ValueError, match="no kernel for device"):
        k(other)
    with pytest.raises(ValueError, match="more than one device"):
        k(torch.zeros(1), torch.zeros(1, device="meta"))
    assert k.launches == 0


# -- the register kernels: layouts, the forward split, the launch arguments ------

# (m, n, k) of forward matmul calls at the H100 pick (64, 128, 32): the split
# of the K loop.  cnn-vgg11's fc1 and fc2 at batch 256 run 128 and 32 blocks,
# under one wave of 132 SMs; conv3's im2col strip (batch 256 x 4 x 4 rows,
# K = 9 x 256) and the transformer's shapes fill one wave or more.
MM_SPLITS = [
    ((256, 4096, 2048), 2),     # fc1
    ((256, 1024, 4096), 8),     # fc2 (N = 1000 padded to 1024)
    ((4096, 512, 2304), 1),     # conv3 im2col strip
    ((8192, 3072, 1024), 1),    # qkv
    ((8192, 1024, 1024), 1),    # wo
    ((8192, 5632, 1024), 1),    # mlp_up
    ((8192, 1024, 2816), 1),    # mlp_down
    ((2048, 151936, 1024), 1),  # logits chunk
    ((64, 128, 64), 2),         # one block, two K steps
]


@pytest.mark.parametrize("mnk,want", MM_SPLITS)
def test_mm_split_fills_one_wave_and_is_fixed_by_shapes(mnk, want):
    from repro_torch.core import machine as tm

    m, n, k = mnk
    kw = dict(m=m, n=n, k=k, block_m=64, block_n=128, block_k=32)
    assert mm.mm_split(**kw) == want == mm.mm_split(**kw)
    grid = (m // 64) * (n // 128)
    assert tm.h100_resident_blocks(mm.smem_bytes(64, 128, 32)) == 2
    assert want == 1 or (grid < tm.H100.units and grid * want <= 2 * tm.H100.units)
    assert want <= k // 32
    assert mm.mm_partial_bytes(m=m, n=n, split=want) == (4 * want * m * n if want > 1 else 0)


def _main_path_forward_picks():
    """(label, schedule, x_shape) of every forward matmul and direct conv
    and every dgrad schedule of both training steps and the CNN's forward
    plans (default and all-direct)."""
    from repro_torch.configs import get_config
    from repro_torch.models import cnn
    from repro_torch.models import transformer as tf

    cfg = get_config("cnn-vgg11")
    geo = {n: x for n, x, _ in cnn._stage_geometry(cfg, 256)}
    picks = []
    for tag, plans in (("train", cnn.plan_training(cfg, 256)),
                       ("default", cnn.plan_forward(cfg, 256)),
                       ("direct", cnn.plan_forward(cfg, 256, conv_algorithm="direct"))):
        for key, s in plans.items():
            stage, _, role = key.partition(".")
            if role in ("", "dgrad"):
                picks.append((f"{tag}:{key}", s, geo[stage]))
    for key, s in tf.plan_training(get_config("qwen1.5-0.5b"), 4, 2048,
                                   loss_chunks=4).items():
        if "." not in key and key != "attn":
            picks.append((f"qwen:{key}", s, None))
    return picks


def test_main_path_picks_take_the_register_kernels_at_the_charged_bytes():
    """Every forward matmul, direct conv and dgrad pick of the main paths runs
    a register kernel whose shared memory is exactly the planner's
    vmem_bytes; the conv layouts fill all 256 threads."""

    picks = _main_path_forward_picks()
    assert len(picks) == 27
    for label, s, x_shape in picks:
        b = s.block_dict()
        if "block_m" in b:
            blocks = (b["block_m"], b["block_n"], b["block_k"])
            assert mm.smem_bytes(*blocks) == s.vmem_bytes, label
            assert mm.template(*blocks) == "register", label
            continue
        geo = dict(block_h=b["block_h"], block_do=b["block_do"], block_di=b["block_di"],
                   W_O=x_shape[2], F=3, S=1)
        assert ck.smem_bytes(**geo) == s.vmem_bytes, label
        layout = ck.register_layout(**geo)
        assert layout is not None, label
        assert layout["items"] * layout["groups"] == 256, label


@pytest.mark.parametrize("geo,want", [
    (dict(block_h=4, block_do=64, block_di=16, W_O=4), dict(run=4, items=32, groups=8)),
    (dict(block_h=8, block_do=64, block_di=16, W_O=8), dict(run=4, items=128, groups=2)),
    (dict(block_h=16, block_do=64, block_di=16, W_O=16), dict(run=8, items=256, groups=1)),
    (dict(block_h=16, block_do=64, block_di=8, W_O=32), dict(run=16, items=256, groups=1)),
])
def test_register_layout_at_the_cnn_geometries(geo, want):
    """conv3 dgrad's 4 x 4 plane: 32 items x 8 channel groups fill the block;
    conv2 2 groups; conv1 and conv0 one item a thread."""

    assert ck.register_layout(**geo, F=3, S=1) == want


@pytest.mark.parametrize("geo", [
    dict(block_h=4, block_do=64, block_di=16, W_O=4, F=3, S=2),    # stride 2
    dict(block_h=4, block_do=64, block_di=16, W_O=4, F=5, S=1),    # F = 5
    dict(block_h=4, block_do=8, block_di=8, W_O=9, F=3, S=1),      # odd width
    dict(block_h=4, block_do=64, block_di=12, W_O=4, F=3, S=1),    # bdi not 4 * 2^j
    dict(block_h=4, block_do=12, block_di=16, W_O=4, F=3, S=1),    # stack not 8k
    dict(block_h=64, block_do=64, block_di=16, W_O=64, F=3, S=1),  # 2048 items
])
def test_other_geometries_take_the_simple_conv_kernel(geo):

    assert ck.register_layout(**geo) is None


class _ArgSink:
    """Stands in for a CudaKernel: records the C arguments a launch wrapper
    passes to ``run`` (the stream is appended by ``run`` itself)."""

    def __init__(self, kernel):
        self.argtypes, self.args, self.dtype = kernel.argtypes, None, None
        self.operand_dtype = kernel.operand_dtype

    def run(self, *args, dtype=torch.float32):
        self.args, self.dtype = args, dtype


@pytest.mark.parametrize("m,k,n,blocks,split,reg", [
    (256, 4096, 1024, (64, 128, 32), 8, 1),
    (768, 64, 1408, (64, 128, 32), 1, 1),
    (64, 64, 128, (32, 64, 32), 2, 0),  # the simple kernel's tile
])
def test_matmul_launch_passes_its_split_and_slabs(m, k, n, blocks, split, reg):
    """The wrapper alone picks the kernel: the C entry point gets the
    template's choice (1 register, 0 simple) and mm_split's split."""

    sink = _ArgSink(matmul_kernel)
    bm, bn, bk = blocks
    out = mm._launch(sink, torch.zeros(m, k), torch.zeros(k, n), block_m=bm, block_n=bn,
                     block_k=bk)
    assert tuple(out.shape) == (m, n)
    assert len(sink.args) == len(sink.argtypes) - 1
    assert sink.args[4:] == (m, n, k, bm, bn, bk, split, reg)
    assert reg == (mm.template(*blocks) == "register")
    assert (sink.args[3].value is not None) == (split > 1)


@pytest.mark.parametrize("m,k,n,blocks,split,reg", [
    (8192, 1024, 1024, (32, 128, 64), 2, 1),  # wo: the register tile, split
    (256, 2048, 4096, (32, 128, 64), 1, 1),   # fc1
    (64, 32, 64, (32, 64, 32), 2, 0),         # the simple kernel's tile
])
def test_tn_launch_passes_its_template_split_and_slabs(m, k, n, blocks, split, reg):
    """The TN wrapper alone picks the kernel: the C entry point gets
    tn_template's choice (1 register, 0 simple), tn_split's split and a
    slab buffer exactly when it splits."""
    from repro_torch.kernels.matmul import bwd as mb

    sink = _ArgSink(mb.matmul_tn_kernel)
    bm, bn, bk = blocks
    out = mb._launch_tn(sink, torch.zeros(m, k), torch.zeros(m, n), block_m=bm,
                        block_n=bn, block_k=bk)
    assert tuple(out.shape) == (k, n)
    assert len(sink.args) == len(sink.argtypes) - 1
    assert sink.args[4:] == (m, n, k, bm, bn, bk, split, reg)
    assert reg == (mb.tn_template(*blocks) == "register")
    assert (sink.args[3].value is not None) == (split > 1)


@pytest.mark.parametrize("m,k,n,blocks,split,reg", [
    (128, 2048, 4096, (64, 32, 128), 8, 1),   # fc1 at batch 128
    (128, 4096, 1024, (64, 32, 128), 4, 1),   # fc2 at batch 128
    (192, 2048, 4096, (64, 32, 128), 8, 1),   # three m-blocks
    (128, 16896, 256, (64, 32, 128), 1, 1),   # a grid of one wave: no split
    (40, 96, 80, (8, 16, 16), 5, 0),          # the simple kernel's blocks
])
def test_dxdw_launch_passes_its_template_split_and_slabs(m, k, n, blocks, split, reg):
    """The fused wrapper alone picks the kernel: the C entry point gets
    dxdw_template's choice (1 register, 0 simple), dxdw_split's split and
    a slab buffer exactly when it splits."""
    from repro_torch.kernels.matmul import bwd as mb

    sink = _ArgSink(mb.matmul_dxdw_kernel)
    bm, bn, bk = blocks
    dx, dw = mb._launch_dxdw(sink, torch.zeros(m, n), torch.zeros(k, n), torch.zeros(m, k),
                             block_m=bm, block_n=bn, block_k=bk)
    assert tuple(dx.shape) == (m, k) and tuple(dw.shape) == (k, n)
    assert len(sink.args) == len(sink.argtypes) - 1
    assert sink.args[6:] == (m, n, k, bm, bn, bk, split, reg)
    assert reg == (mb.dxdw_template(bm, bn, bk, m) == "register")
    assert (sink.args[5].value is not None) == (split > 1)


@pytest.mark.parametrize("W_O,stride,run", [(8, 1, 4), (16, 1, 8), (9, 1, 0), (8, 2, 0)])
def test_conv_launch_passes_the_register_run(W_O, stride, run):

    extent = (W_O - 1) * stride + 3
    x = torch.zeros(1, extent, extent, 16)
    sink = _ArgSink(conv2d_kernel)
    out = ck._launch(sink, x, torch.zeros(3, 3, 16, 64), torch.zeros(64), stride=stride,
                     block_h=W_O, block_do=64, block_di=16, H_O=W_O, W_O=W_O, relu=True)
    assert tuple(out.shape) == (1, W_O, W_O, 64)
    assert len(sink.args) == len(sink.argtypes) - 1
    assert sink.args[-1] == run
