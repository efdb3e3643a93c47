"""The port's planned backward against the JAX package's, on the CPU.

* Planners: ConvDgradPlanner, ConvWgradPlanner, MatmulDxPlanner (with the
  fused_dxdw re-model) and MatmulDwPlanner equal field for field to
  ``repro``'s on MANTICORE and TPU_V5E, and ``cnn.plan_training`` too.  The
  H100 picks get pins of their own.
* Ops: the epilogue scatter, dgrad and wgrad against ``repro``'s oracles;
  dX, dW and the fused pair against the interpreted Pallas kernels.
* Gradients of the layers and of the smoke CNN against ``jax.grad`` of
  ``repro``'s plain functions, and the dispatch of a planned backward.

Tolerance (f32): max |port - repro| <= 1e-4 * max(1, max |repro|) — the
same sums in another order (over at most a few thousand terms).
"""

import dataclasses
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import ccr as jccr
from repro.core import conv_layer as jcl
from repro.core import fc_layer as jfl
from repro.core import machine as jm
from repro.kernels.conv2d import bwd as jcb
from repro.kernels.conv2d.ref import conv2d_fused_ref as jconv_fused_ref
from repro.kernels.conv2d.ref import conv2d_ref as jconv_ref
from repro.kernels.matmul import bwd as jmb
from repro.models import cnn as jcnn
from repro.models.module import init_params as jax_init_params
from repro.plan import planners as jp
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_repro
from repro_torch.core import ccr as tccr
from repro_torch.core import conv_layer as cl
from repro_torch.core import fc_layer as fl
from repro_torch.core import machine as tm
from repro_torch.kernels.conv2d import bwd as cb
from repro_torch.kernels.matmul import bwd as mb
from repro_torch.models import cnn
from repro_torch.plan import planners as tp

conv_kernel_mod = importlib.import_module("repro_torch.kernels.conv2d.conv2d")

TOL = 1e-4
MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]
MACHINE_IDS = ["manticore", "tpu_v5e"]


def _same(jax_sched, torch_sched):
    assert dataclasses.asdict(torch_sched) == dataclasses.asdict(jax_sched)


def assert_close(got, want, tol=TOL):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(want))) if want.size else 1.0), err


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# -- closed forms and planners -----------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(H_I=32, d_in=64, block_h=16, block_do=64, batch=256),
    dict(H_I=9, d_in=5, block_h=4, block_do=8, batch=3)])
def test_dgrad_fused_steps_match_repro(kw):
    assert tccr.conv_dgrad_fused_steps(**kw) == jccr.conv_dgrad_fused_steps(**kw)


@pytest.mark.parametrize("pipelined", [False, True])
def test_wgrad_steps_and_scatter_traffic_match_repro(pipelined):
    kw = dict(H_O=16, d_in=64, d_out=128, block_h=8, block_di=16, block_do=64,
              batch=4, pipelined=pipelined)
    assert tccr.conv_wgrad_steps(**kw) == jccr.conv_wgrad_steps(**kw)
    sk = dict(H_O=16, W_O=16, d_out=128, pool=2, batch=4, in_bytes=4)
    got, want = tccr.epilogue_scatter_traffic(**sk), jccr.epilogue_scatter_traffic(**sk)
    assert (got.macs, got.main_loads, got.main_stores) == (
        want.macs, want.main_loads, want.main_stores)


CONV_BWD_SHAPES = [
    dict(H_O=32, W_O=32, F=3, S=1, d_in=3, d_out=64, batch=256, padding=1, H_I=32, W_I=32),
    dict(H_O=16, W_O=16, F=3, S=1, d_in=64, d_out=128, batch=256, padding=1, H_I=16, W_I=16),
    dict(H_O=4, W_O=4, F=3, S=1, d_in=256, d_out=512, batch=256, padding=1, H_I=4, W_I=4),
    dict(H_O=32, W_O=32, F=3, S=1, d_in=128, d_out=128, batch=1, padding=1, H_I=32, W_I=32),
    dict(H_O=7, W_O=7, F=3, S=2, d_in=5, d_out=7, batch=3, padding=1, H_I=13, W_I=13),
    dict(H_O=9, W_O=9, F=3, S=1, d_in=17, d_out=9, batch=2, padding=1, H_I=9, W_I=9,
         block_h=4),
]


@pytest.mark.parametrize("alg", [None, "direct", "pipelined"])
@pytest.mark.parametrize("shape", CONV_BWD_SHAPES)
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
@pytest.mark.parametrize("word", [4, 8])
def test_wgrad_planner_matches_repro(machines, shape, alg, word):
    jmach, tmach = machines
    kw = dict(shape, in_bytes=word, algorithm=alg)
    _same(jp.ConvWgradPlanner(jmach).plan(**kw), tp.ConvWgradPlanner(tmach).plan(**kw))


@pytest.mark.parametrize("alg", [None, "direct", "fused_epilogue"])
@pytest.mark.parametrize("shape", CONV_BWD_SHAPES)
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_dgrad_planner_matches_repro(machines, shape, alg):
    jmach, tmach = machines
    kw = {("P" if k == "padding" else k): v for k, v in shape.items()}
    kw.update(in_bytes=4, algorithm=alg, pool=2 if alg != "direct" else None)
    if alg is None:
        kw["pool"] = None if shape["H_O"] % 2 else 2
    _same(jp.ConvDgradPlanner(jmach).plan(**kw), tp.ConvDgradPlanner(tmach).plan(**kw))


@pytest.mark.parametrize("m,n,k,word", [
    (32, 4096, 25088, 4), (256, 4096, 2048, 4), (256, 1000, 4096, 4),
    (128, 1000, 4096, 4), (37, 70, 90, 2), (4096, 16384, 8192, 2)])
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_matmul_bwd_planners_match_repro(machines, m, n, k, word):
    jmach, tmach = machines
    kw = dict(m=m, n=n, k=k, in_bytes=word)
    for alg in (None, "direct", "fused_dxdw"):
        _same(jp.MatmulDxPlanner(jmach).plan(**kw, algorithm=alg),
              tp.MatmulDxPlanner(tmach).plan(**kw, algorithm=alg))
    _same(jp.MatmulDwPlanner(jmach).plan(**kw), tp.MatmulDwPlanner(tmach).plan(**kw))


@pytest.mark.parametrize("arch_batch", [("full", 256), ("full", 32), ("smoke", 3)])
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_plan_training_matches_repro(machines, arch_batch):
    jmach, tmach = machines
    which, batch = arch_batch
    jcfg = jax_config("cnn-vgg11") if which == "full" else jax_smoke_config("cnn-vgg11")
    tcfg = get_config("cnn-vgg11") if which == "full" else smoke_config("cnn-vgg11")
    want = jcnn.plan_training(jcfg, batch, machine=jmach)
    got = cnn.plan_training(tcfg, batch, machine=tmach)
    assert set(got) == set(want)
    for key in want:
        _same(want[key], got[key])


# -- H100 pins ---------------------------------------------------------------------

# (algorithm, blocks) of every backward schedule of cnn-vgg11 at batch 256 on
# the H100 (conv0.dgrad is planned but never runs: images need no gradient).
H100_BWD_PICKS = {
    "conv0.wgrad": ("pipelined", dict(block_di=8, block_do=64, block_h=8)),
    "conv0.dgrad": ("fused_epilogue", dict(block_di=16, block_do=8, block_h=32)),
    "conv1.wgrad": ("pipelined", dict(block_di=16, block_do=64, block_h=16)),
    "conv1.dgrad": ("fused_epilogue", dict(block_di=16, block_do=64, block_h=16)),
    "conv2.wgrad": ("pipelined", dict(block_di=16, block_do=64, block_h=8)),
    "conv2.dgrad": ("fused_epilogue", dict(block_di=16, block_do=64, block_h=8)),
    "conv3.wgrad": ("pipelined", dict(block_di=16, block_do=64, block_h=4)),
    "conv3.dgrad": ("fused_epilogue", dict(block_di=16, block_do=64, block_h=4)),
    "fc1.dx": ("direct", dict(block_k=128, block_m=64, block_n=32)),
    "fc1.dw": ("direct", dict(block_k=64, block_m=32, block_n=128)),
    "fc2.dx": ("direct", dict(block_k=128, block_m=64, block_n=32)),
    "fc2.dw": ("direct", dict(block_k=64, block_m=32, block_n=128)),
}


def test_h100_vgg11_backward_picks():
    plans = cnn.plan_training(get_config("cnn-vgg11"), 256)
    bwd = {k: s for k, s in plans.items() if "." in k}
    assert set(bwd) == set(H100_BWD_PICKS)
    for key, sched in bwd.items():
        assert (sched.algorithm, sched.block_dict()) == H100_BWD_PICKS[key], key
        assert sched.machine == "h100" and sched.fits(tm.H100), key


@pytest.mark.parametrize("fc", ["fc1", "fc2"])
def test_h100_fc_falls_back_from_fused_at_batch_256(fc):
    """The fused kernel's whole-M dX strip: 114,688 B of double-buffered
    streams + a 256 x 128 f32 strip (131,072 B) + the 16,384 B dW tile =
    262,144 B > 232,448 B at batch 256; at batch 128 it fits and wins."""
    geo = {n: (x, w) for n, x, w in cnn._stage_geometry(get_config("cnn-vgg11"), 256)}
    x_shape, w_shape = geo[fc]
    k, n = w_shape
    fused = tp.MatmulDxPlanner(tm.H100).plan(m=256, n=n, k=k, in_bytes=4,
                                            algorithm="fused_dxdw")
    assert fused.vmem_bytes == 114_688 + 131_072 + 16_384 == 262_144
    assert not fused.fits(tm.H100) and tm.H100.usable_for_working_set(2) == 232_448
    assert fl.plan_bwd(x_shape, w_shape)["dx"].algorithm == "direct"
    small = fl.plan_bwd((128, k), w_shape)["dx"]
    assert small.algorithm == "fused_dxdw" and small.fits(tm.H100)
    assert mb.supported_blocks("matmul_dx_dw", m=128, **small.block_dict())


def _bwd_schedules(batch):
    cfg = get_config("cnn-vgg11")
    plans = cnn.plan_training(cfg, batch)
    geo = {n: (x, w) for n, x, w in cnn._stage_geometry(cfg, batch)}
    return [(k, s, geo[k.split(".")[0]]) for k, s in plans.items() if "." in k]


@pytest.mark.parametrize("batch", [256, 128, 192, 7])
def test_h100_backward_schedules_run_on_their_kernels(batch):
    """Every H100 backward schedule of cnn-vgg11 is taken by its kernel's
    supported_blocks, and the kernel's shared memory equals the schedule's
    vmem_bytes."""
    for key, s, (x_shape, w_shape) in _bwd_schedules(batch):
        b = s.block_dict()
        role = key.split(".")[1]
        if role == "wgrad":
            geo = dict(block_h=b["block_h"], block_do=b["block_do"],
                       block_di=b["block_di"], W_O=x_shape[2], F=3, S=1)
            assert cb.wgrad_supported_blocks(**geo), key
            assert cb.wgrad_smem_bytes(**geo) == s.vmem_bytes, key
        elif role == "dgrad":  # the conv kernel on the transposed geometry
            geo = dict(block_h=b["block_h"], block_do=b["block_do"],
                       block_di=b["block_di"], W_O=x_shape[2], F=3, S=1)
            assert conv_kernel_mod.supported_blocks(**geo, pool=1), key
            assert conv_kernel_mod.smem_bytes(**geo) == s.vmem_bytes, key
        elif s.algorithm == "fused_dxdw":
            m = -(-batch // b["block_m"]) * b["block_m"]
            assert mb.supported_blocks("matmul_dx_dw", m=m, **b), key
            assert mb.smem_bytes_dxdw(m, b["block_m"], b["block_n"], b["block_k"]) \
                == s.vmem_bytes, key
        else:
            kernel = "matmul_nt" if role == "dx" else "matmul_tn"
            smem = mb.smem_bytes_nt if role == "dx" else mb.smem_bytes_tn
            assert mb.supported_blocks(kernel, **b), key
            assert smem(b["block_m"], b["block_n"], b["block_k"]) == s.vmem_bytes, key


# conv0..conv3 at batch 256 on the H100 picks: (d_in, d_out, bdi, bdo, hb,
# W_O, n_h), the resident blocks a SM their shared memory allows, and the
# split: (d_i, d_o) pairs x split fills resident x 132 block slots, never
# more than the sweep's 256 * n_h steps.
WGRAD_SPLITS = [
    ((3, 64, 8, 64, 8, 32, 4), 1, 132),
    ((64, 128, 16, 64, 16, 16, 1), 1, 16),
    ((128, 256, 16, 64, 8, 8, 1), 2, 8),
    ((256, 512, 16, 64, 4, 4, 1), 2, 2),
]


@pytest.mark.parametrize("shape,resident,want", WGRAD_SPLITS)
def test_wgrad_split_covers_the_card_and_is_fixed_by_shapes(shape, resident, want):
    d_in, d_out, bdi, bdo, hb, W_O, n_h = shape
    smem = cb.wgrad_smem_bytes(block_h=hb, block_do=bdo, block_di=bdi, W_O=W_O, F=3, S=1)
    assert tm.h100_resident_blocks(smem) == resident
    kw = dict(d_in=cb.wgrad_channels(d_in), d_out=d_out, block_di=bdi, block_do=bdo,
              batch=256, n_h=n_h, smem_bytes=smem)
    split = cb.wgrad_split(**kw)
    assert split == want == cb.wgrad_split(**kw)
    pairs = -(-d_in // bdi) * -(-d_out // bdo)
    assert pairs * split <= resident * tm.H100.units
    assert split <= 256 * n_h


def test_wgrad_split_never_exceeds_the_sweep():
    assert cb.wgrad_split(d_in=3, d_out=8, block_di=8, block_do=8, batch=2, n_h=3,
                          smem_bytes=4096) == 6
    assert tm.h100_resident_blocks(232_448) == 1 and tm.h100_resident_blocks(1024) == 2
    assert cb.wgrad_partial_bytes(F=3, d_in=3, d_out=64, split=132) == 4 * 132 * 9 * 3 * 64
    assert cb.wgrad_partial_bytes(F=3, d_in=256, d_out=512, split=1) == 0


@pytest.mark.parametrize("d,want", [(3, 4), (4, 4), (5, 8), (13, 16), (64, 64)])
def test_wgrad_channels_pad_to_whole_16_byte_copies(d, want):
    assert cb.wgrad_channels(d) == want
    x, dy = torch.ones(1, 4, 4, d), torch.ones(1, 2, 2, d)
    xk, gk = cb.wgrad_pad_channels(x, dy)
    assert xk.shape[-1] == gk.shape[-1] == want
    assert xk.is_contiguous() and gk.is_contiguous()
    assert float(xk[..., d:].abs().sum()) == 0 and torch.equal(xk[..., :d], x)
    if d == want:  # no copy when the channels already are whole copies
        assert xk.data_ptr() == x.data_ptr()


# (m, n, k) of NT calls at the H100 dX pick (64, 32, 128): the split of the
# N loop.  cnn-vgg11's fc1/fc2 dX at batch 256 run 64 and 128 blocks, under
# one wave of 132 SMs; the transformer's shapes fill several waves.
NT_SPLITS = [
    ((256, 4096, 2048), 4),   # fc1 dX
    ((256, 1024, 4096), 2),   # fc2 dX (N = 1000 padded to 1024)
    ((8192, 3072, 1024), 1),  # qkv
    ((8192, 1024, 1024), 1),  # wo
    ((8192, 5632, 1024), 1),  # mlp_up
    ((8192, 1024, 2816), 1),  # mlp_down (K padded to 2816 = 22 x 128)
    ((2048, 151936, 1024), 1),  # logits chunk
    ((64, 64, 128), 2),       # one block, two N steps
]


@pytest.mark.parametrize("mnk,want", NT_SPLITS)
def test_nt_split_fills_one_wave_and_is_fixed_by_shapes(mnk, want):
    m, n, k = mnk
    kw = dict(m=m, n=n, k=k, block_m=64, block_n=32, block_k=128)
    assert mb.nt_split(**kw) == want == mb.nt_split(**kw)
    grid = (m // 64) * (k // 128)
    assert tm.h100_resident_blocks(mb.smem_bytes_nt(64, 32, 128)) == 2
    assert want == 1 or grid * want <= 2 * tm.H100.units
    assert want <= n // 32
    assert mb.nt_partial_bytes(m=m, k=k, split=want) == (4 * want * m * k if want > 1 else 0)


def test_h100_nt_pick_is_the_register_kernels_tile():
    """Every NT schedule of both training steps is the (64, 32, 128) tile the
    register kernel is built for."""
    from repro_torch.models import transformer as tf

    plans = dict(cnn.plan_training(get_config("cnn-vgg11"), 256))
    plans.update(tf.plan_training(get_config("qwen1.5-0.5b"), 4, 2048, loss_chunks=4))
    dx = [s for key, s in plans.items() if key.endswith(".dx")]
    assert len(dx) == 7
    for s in dx:
        assert s.algorithm == "direct"
        assert s.block_dict() == dict(block_m=64, block_n=32, block_k=128)
        assert s.vmem_bytes == mb.smem_bytes_nt(64, 32, 128) == 81_920


# (m, n, k) of TN calls at the H100 dW pick (32, 128, 64): the split of the
# M loop.  Of the seven TN shapes of both steps only the transformer's wo
# (an 8 x 16 = 128-block grid) is under one wave of 132 SMs.
TN_SPLITS = [
    ((256, 4096, 2048), 1),   # fc1 dW
    ((256, 1024, 4096), 1),   # fc2 dW (N = 1000 padded to 1024)
    ((8192, 3072, 1024), 1),  # qkv
    ((8192, 1024, 1024), 2),  # wo
    ((8192, 5632, 1024), 1),  # mlp_up
    ((8192, 1024, 2816), 1),  # mlp_down (K = 2816 = 44 x 64)
    ((2048, 151936, 1024), 1),  # logits chunk
    ((64, 128, 64), 2),       # one block, two M steps
]


@pytest.mark.parametrize("mnk,want", TN_SPLITS)
def test_tn_split_fills_one_wave_and_is_fixed_by_shapes(mnk, want):
    m, n, k = mnk
    kw = dict(m=m, n=n, k=k, block_m=32, block_n=128, block_k=64)
    assert mb.tn_split(**kw) == want == mb.tn_split(**kw)
    grid = (n // 128) * (k // 64)
    assert tm.h100_resident_blocks(mb.smem_bytes_tn(32, 128, 64)) == 2
    assert want == 1 or grid * want <= 2 * tm.H100.units
    assert want <= m // 32
    assert mb.tn_partial_bytes(k=k, n=n, split=want) == (4 * want * k * n if want > 1 else 0)
    if mnk == (8192, 1024, 1024):
        assert mb.tn_partial_bytes(k=k, n=n, split=want) == 8 * 2 ** 20


def test_h100_tn_pick_is_the_register_kernels_tile():
    """Every TN schedule of both training steps is the (32, 128, 64) tile the
    register kernel is built for, and the kernel's shared memory is the
    schedule's vmem_bytes."""
    from repro_torch.models import transformer as tf

    plans = dict(cnn.plan_training(get_config("cnn-vgg11"), 256))
    plans.update(tf.plan_training(get_config("qwen1.5-0.5b"), 4, 2048, loss_chunks=4))
    dw = [s for key, s in plans.items() if key.endswith(".dw")]
    assert len(dw) == 7
    for s in dw:
        b = s.block_dict()
        assert s.algorithm == "direct"
        assert (b["block_m"], b["block_n"], b["block_k"]) == mb.TN_REGISTER_TILE
        assert mb.tn_template(**b) == "register"
        assert s.vmem_bytes == mb.smem_bytes_tn(**b) == 81_920
    assert mb.tn_template(block_m=8, block_n=16, block_k=16) == "simple"


# (m, n, k) of fused calls at the H100 fused_dxdw pick (64, 32, 128): the
# split of each k-block's n-blocks.  One block a SM (163,840 to 229,376 B),
# so the K/128 grid (fc1 16, fc2 32) takes 132 // grid parts; a K of 132
# k-blocks fills one wave alone.
DXDW_SPLITS = [
    ((128, 4096, 2048), 8),   # fc1 at batch 128
    ((128, 1024, 4096), 4),   # fc2 at batch 128 (N = 1000 padded to 1024)
    ((192, 4096, 2048), 8),   # fc1 at batch 192
    ((192, 1024, 4096), 4),   # fc2 at batch 192
    ((64, 4096, 2048), 8),    # fc1 at batch 64
    ((128, 256, 16896), 1),   # 132 k-blocks: one wave
    ((64, 64, 128), 2),       # one k-block, two n-blocks
]


@pytest.mark.parametrize("mnk,want", DXDW_SPLITS)
def test_dxdw_split_fills_one_wave_and_is_fixed_by_shapes(mnk, want):
    m, n, k = mnk
    kw = dict(m=m, n=n, k=k, block_m=64, block_n=32, block_k=128)
    assert mb.dxdw_split(**kw) == want == mb.dxdw_split(**kw)
    grid = k // 128
    assert tm.h100_resident_blocks(mb.smem_bytes_dxdw(m, 64, 32, 128)) == 1
    assert want == 1 or grid * want <= tm.H100.units
    assert want <= n // 32
    slabs = mb.nt_partial_bytes(m=m, k=k, split=want)
    assert slabs == (4 * want * m * k if want > 1 else 0)
    if m == 128 and k in (2048, 4096):
        assert slabs == 8_388_608


@pytest.mark.parametrize("blocks,m,want", [
    ((64, 32, 128), 64, "register"),
    ((64, 32, 128), 128, "register"),
    ((64, 32, 128), 192, "register"),
    ((64, 32, 128), 256, "simple"),   # four m-blocks: more than a thread holds
    ((64, 32, 128), 100, "simple"),   # not whole m-blocks
    ((32, 32, 128), 32, "simple"),    # the pick at batch 32
    ((8, 32, 128), 8, "simple"),      # the pick at batch 1-8
    ((8, 16, 16), 40, "simple"),      # the ragged case's blocks
])
def test_dxdw_template_takes_the_register_tile_up_to_three_m_blocks(blocks, m, want):
    assert mb.dxdw_template(*blocks, m) == want


@pytest.mark.parametrize("batch", [64, 96, 128, 192])
def test_h100_fused_pick_is_the_register_kernels_tile(batch):
    """Every fused schedule of cnn-vgg11 from batch 33 to 192 is the
    (64, 32, 128) tile the register kernel is built for, at one to three
    m-blocks, and the kernel's shared memory is the schedule's
    vmem_bytes."""
    cfg = get_config("cnn-vgg11")
    plans = cnn.plan_training(cfg, batch)
    for fc in ("fc1", "fc2"):
        s = plans[f"{fc}.dx"]
        b = s.block_dict()
        m = -(-batch // b["block_m"]) * b["block_m"]
        assert s.algorithm == "fused_dxdw"
        assert (b["block_m"], b["block_n"], b["block_k"]) == mb.DXDW_REGISTER_TILE
        assert mb.dxdw_template(b["block_m"], b["block_n"], b["block_k"], m) == "register"
        assert s.vmem_bytes == mb.smem_bytes_dxdw(m, **{k: b[k] for k in b})
    assert mb.tn_template(block_m=32, block_n=64, block_k=128) == "simple"


# -- op parity -------------------------------------------------------------------


@pytest.mark.parametrize("pool", [1, 2, 3])
def test_epilogue_scatter_matches_repro(pool):
    rng = np.random.default_rng(pool)
    g = _np(rng, 2, 4, 5, 6)
    hi = 2 if pool == 1 else pool * pool + 1  # dead index included
    mask = rng.integers(0, hi, g.shape).astype(np.int8)
    want = np.asarray(jcb.epilogue_scatter(jnp.asarray(g), jnp.asarray(mask), pool))
    assert_close(cb.epilogue_scatter(_t(g), _t(mask), pool), want, tol=0.0)


# (B, H, d_in, d_out, F, S, P, block_h)
CONV_CASES = [
    (2, 8, 3, 8, 3, 1, 1, None),
    (2, 9, 5, 7, 3, 1, 1, 4),
    (1, 12, 8, 16, 3, 2, 0, None),
    (2, 13, 6, 10, 3, 2, 1, 3),
    (3, 10, 17, 9, 3, 1, 1, 4),
    (1, 8, 3, 5, 5, 1, 2, None),
    (2, 7, 17, 3, 1, 1, 0, None),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_dgrad_matches_repro_oracle(case):
    B, H, di, do, Fk, S, P, hb = case
    rng = np.random.default_rng(11)
    H_O = (H + 2 * P - Fk) // S + 1
    dy, f = _np(rng, B, H_O, H_O, do), _np(rng, Fk, Fk, di, do)
    want = np.asarray(jcb.conv2d_dgrad_ref(jnp.asarray(dy), jnp.asarray(f), stride=S,
                                           padding=P, out_hw=(H, H)))
    got = cb.conv2d_dgrad(_t(dy), _t(f), stride=S, padding=P, out_hw=(H, H), block_h=hb)
    assert_close(got, want)
    assert_close(cb.conv2d_dgrad_ref(_t(dy), _t(f), stride=S, padding=P, out_hw=(H, H)),
                 want)


@pytest.mark.parametrize("case", CONV_CASES)
def test_wgrad_matches_repro_oracle(case):
    B, H, di, do, Fk, S, P, hb = case
    rng = np.random.default_rng(12)
    H_O = (H + 2 * P - Fk) // S + 1
    x, dy = _np(rng, B, H, H, di), _np(rng, B, H_O, H_O, do)
    want = np.asarray(jcb.conv2d_wgrad_ref(jnp.asarray(x), jnp.asarray(dy), F=Fk,
                                           stride=S, padding=P))
    got = cb.conv2d_wgrad(_t(x), _t(dy), F=Fk, stride=S, padding=P, block_h=hb)
    assert_close(got, want)
    assert_close(cb.conv2d_wgrad_ref(_t(x), _t(dy), F=Fk, stride=S, padding=P), want)


@pytest.mark.parametrize("pool", [1, 2])
def test_masked_dgrad_wgrad_match_scattered(pool):
    """The mask path (pooled dY + mask) equals the ops on the scattered
    full-rate dY, and repro's oracle on it."""
    rng = np.random.default_rng(13)
    x, f = _np(rng, 2, 8, 8, 5), _np(rng, 3, 3, 5, 9)
    g = _np(rng, 2, 8 // pool, 8 // pool, 9)
    hi = 2 if pool == 1 else pool * pool + 1
    mask = rng.integers(0, hi, g.shape).astype(np.int8)
    full = np.asarray(jcb.epilogue_scatter(jnp.asarray(g), jnp.asarray(mask), pool))
    dx = cb.conv2d_dgrad(_t(g), _t(f), padding=1, out_hw=(8, 8), mask=_t(mask), pool=pool)
    dw = cb.conv2d_wgrad(_t(x), _t(g), F=3, padding=1, mask=_t(mask), pool=pool)
    assert_close(dx, jcb.conv2d_dgrad_ref(jnp.asarray(full), jnp.asarray(f), padding=1))
    assert_close(dw, jcb.conv2d_wgrad_ref(jnp.asarray(x), jnp.asarray(full), F=3, padding=1))


@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (16, 24, 32, 8, 8, 16), (64, 128, 96, 32, 64, 32), (24, 40, 16, 8, 8, 8)])
def test_bwd_kernels_match_interpreted_pallas(m, k, n, bm, bk, bn):
    """The NT, TN and fused kernels' plain versions against
    matmul_nt_pallas / matmul_tn_pallas / matmul_dx_dw_pallas (interpret
    mode), on block-multiple operands with the same blocks."""
    rng = np.random.default_rng(14)
    x, w, g = _np(rng, m, k), _np(rng, k, n), _np(rng, m, n)
    blocks = dict(block_m=bm, block_k=bk, block_n=bn)
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)
    assert_close(mb.matmul_nt_kernel(_t(g), _t(w), **blocks),
                 jmb.matmul_nt_pallas(jg, jw, **blocks, interpret=True))
    assert_close(mb.matmul_tn_kernel(_t(x), _t(g), **blocks),
                 jmb.matmul_tn_pallas(jx, jg, **blocks, interpret=True))
    jdx, jdw = jmb.matmul_dx_dw_pallas(jg, jw, jx, **blocks, interpret=True)
    dx, dw = mb.matmul_dxdw_kernel(_t(g), _t(w), _t(x), **blocks)
    assert_close(dx, jdx)
    assert_close(dw, jdw)


@pytest.mark.parametrize("m,k,n", [(3, 29, 17), (37, 90, 70), (130, 300, 200)])
def test_bwd_ops_match_repro(m, k, n):
    """The padded ops (planner blocks, zero padding, slicing) against
    repro's matmul_dx / matmul_dw / matmul_dx_dw in interpret mode."""
    rng = np.random.default_rng(15)
    x, w, g = _np(rng, m, k), _np(rng, k, n), _np(rng, m, n)
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)
    assert_close(mb.matmul_dx(_t(g), _t(w)), jmb.matmul_dx(jg, jw, interpret=True))
    assert_close(mb.matmul_dw(_t(x), _t(g)), jmb.matmul_dw(jx, jg, interpret=True))
    jdx, jdw = jmb.matmul_dx_dw(jg, jw, jx, interpret=True)
    dx, dw = mb.matmul_dx_dw(_t(g), _t(w), _t(x))
    assert_close(dx, jdx)
    assert_close(dw, jdw)
    assert_close(mb.matmul_dx_ref(_t(g), _t(w)), jmb.matmul_dx_ref(jg, jw))
    assert_close(mb.matmul_dw_ref(_t(x), _t(g)), jmb.matmul_dw_ref(jx, jg))


# -- gradients against jax.grad ---------------------------------------------------


def _grads(fn, leaves, g):
    leaves = [_t(a).requires_grad_(True) for a in leaves]
    return torch.autograd.grad(fn(*leaves), leaves, _t(g))


@pytest.mark.parametrize("case", CONV_CASES[:5])
@pytest.mark.parametrize("pool", [1, 2])
def test_conv_block_grads_match_jax(case, pool):
    B, H, di, do, Fk, S, P, hb = case
    rng = np.random.default_rng(16)
    x, f, b = _np(rng, B, H, H, di), _np(rng, Fk, Fk, di, do, scale=0.5), _np(rng, do)
    fwd = lambda x, f, b: jconv_fused_ref(x, f, b, stride=S, padding=P, relu=True,
                                          pool=pool)
    out, vjp = jax.vjp(fwd, jnp.asarray(x), jnp.asarray(f), jnp.asarray(b))
    g = _np(rng, *out.shape)
    want = vjp(jnp.asarray(g))
    got = _grads(lambda x, f, b: cl.conv_block(x, f, b, S, P, pool, "strip"), (x, f, b), g)
    for a, w in zip(got, want):
        assert_close(a, w)


@pytest.mark.parametrize("case", CONV_CASES[:4])
def test_conv_layer_grads_match_jax(case):
    B, H, di, do, Fk, S, P, hb = case
    rng = np.random.default_rng(17)
    x, f = _np(rng, B, H, H, di), _np(rng, Fk, Fk, di, do)
    out, vjp = jax.vjp(lambda x, f: jconv_ref(x, f, stride=S, padding=P),
                       jnp.asarray(x), jnp.asarray(f))
    g = _np(rng, *out.shape)
    want = vjp(jnp.asarray(g))
    got = _grads(lambda x, f: cl.conv_layer(x, f, S, P, "strip"), (x, f), g)
    for a, w in zip(got, want):
        assert_close(a, w)


@pytest.mark.parametrize("m,k,n", [(3, 29, 17), (96, 200, 70), (300, 64, 40)])
def test_fc_layer_grads_match_jax(m, k, n):
    rng = np.random.default_rng(18)
    x, w, g = _np(rng, m, k), _np(rng, k, n), _np(rng, m, n)
    _, vjp = jax.vjp(lambda x, w: x @ w, jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    for sd in (None, fl.plan_bwd((m, k), (k, n))):
        got = _grads(lambda x, w: fl.fc_layer(x, w, None, sd), (x, w), g)
        for a, wt in zip(got, want):
            assert_close(a, wt)


def _repro_weights(cfg, seed=0):
    params = jax_init_params(jcnn.param_defs(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    return {k: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                if k.startswith("bias") or k.endswith("_b") else 0)
            for k, v in params.items()}


@pytest.mark.parametrize("batch", [3, 8])
def test_smoke_cnn_grads_match_jax_grad(batch):
    """Grads of a loss through the planned forward + backward
    (plan_training schedules) against jax.grad of repro's plain forward."""
    cfg = jax_smoke_config("cnn-vgg11")
    np_params = _repro_weights(cfg)
    rng = np.random.default_rng(19)
    images = _np(rng, batch, cnn.IMG, cnn.IMG, cnn.IN_CH)
    probe = _np(rng, batch, cfg.vocab)

    def jloss(p):
        return jnp.sum(jcnn.forward(cfg, p, jnp.asarray(images), use_kernels=False)
                       * jnp.asarray(probe))

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in np_params.items()})
    tcfg = smoke_config("cnn-vgg11")
    params = {k: v.requires_grad_(True)
              for k, v in params_from_repro(np_params, device="cpu").items()}
    logits = cnn.forward(tcfg, params, _t(images),
                         schedules=cnn.plan_training(tcfg, batch))
    got = torch.autograd.grad((logits * _t(probe)).sum(), list(params.values()))
    for (name, _), gr in zip(params.items(), got):
        assert_close(gr, want[name])


# -- dispatch ---------------------------------------------------------------------


def _spy(monkeypatch, module, names, calls):
    for name in names:
        orig = getattr(module, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls.append((_name, k.get("schedule")))
            return _orig(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


def test_grad_runs_planned_kernels_with_pinned_schedules(monkeypatch):
    """Autograd through the planned smoke CNN reaches the dgrad, wgrad, dX
    and dW ops with exactly plan_training's schedules; conv0 (images need
    no gradient) runs no dgrad."""
    calls = []
    _spy(monkeypatch, cl, ["conv2d_dgrad", "conv2d_wgrad"], calls)
    _spy(monkeypatch, fl, ["matmul_dx", "matmul_dw", "matmul_dx_dw"], calls)
    cfg = smoke_config("cnn-vgg11")
    batch = 5
    plans = cnn.plan_training(cfg, batch)
    # the smoke widths are narrow enough for fc2's fused kernel; pin fc1 to
    # the direct pair so both FC paths run
    geo = {n: w for n, _, w in cnn._stage_geometry(cfg, batch)}
    k, n = geo["fc1"]
    plans["fc1.dx"] = tp.MatmulDxPlanner(tm.H100).plan(m=batch, n=n, k=k, in_bytes=4)
    assert plans["fc2.dx"].algorithm == "fused_dxdw"
    params = {k: v.requires_grad_(True)
              for k, v in params_from_repro(_repro_weights(jax_smoke_config("cnn-vgg11")),
                                            device="cpu").items()}
    images = _t(_np(np.random.default_rng(20), batch, cnn.IMG, cnn.IMG, cnn.IN_CH))
    cnn.forward(cfg, params, images, schedules=plans).sum().backward()
    want = {("conv2d_dgrad", plans["conv1.dgrad"]), ("conv2d_wgrad", plans["conv0.wgrad"]),
            ("conv2d_wgrad", plans["conv1.wgrad"]), ("matmul_dx", plans["fc1.dx"]),
            ("matmul_dw", plans["fc1.dw"]), ("matmul_dx_dw", plans["fc2.dx"])}
    assert set(calls) == want and len(calls) == len(want), calls


def test_fc_bwd_dispatches_fused_dxdw(monkeypatch):
    calls = []
    _spy(monkeypatch, fl, ["matmul_dx", "matmul_dw", "matmul_dx_dw"], calls)
    rng = np.random.default_rng(21)
    x, w, g = _np(rng, 16, 40), _np(rng, 40, 24), _np(rng, 16, 24)
    sd = fl.plan_bwd((16, 40), (40, 24))
    assert sd["dx"].algorithm == "fused_dxdw"
    got = _grads(lambda x, w: fl.fc_layer(x, w, None, sd), (x, w), g)
    assert [c[0] for c in calls] == ["matmul_dx_dw"]
    assert_close(got[0], g @ w.T)
    assert_close(got[1], x.T @ g)


def test_mask_path_skips_recompute_conv(monkeypatch):
    """With the mask residual saved, the conv_block backward launches no
    recompute conv; the ragged-pool geometry (no mask) still does."""
    calls = []
    orig_conv, orig_sc = cl.conv2d, cl.epilogue_scatter
    monkeypatch.setattr(cl, "conv2d", lambda *a, **k: (calls.append("conv2d"),
                                                        orig_conv(*a, **k))[1])
    monkeypatch.setattr(cl, "epilogue_scatter", lambda *a, **k: (
        calls.append("scatter"), orig_sc(*a, **k))[1])
    rng = np.random.default_rng(22)
    f, b = _t(_np(rng, 3, 3, 3, 4)), _t(_np(rng, 4))

    def run(H):
        x = _t(_np(rng, 1, H, H, 3))
        leaves = [t.clone().requires_grad_(True) for t in (x, f, b)]
        out = cl.conv_block(*leaves, 1, 1, 2, "strip")
        calls.clear()
        torch.autograd.grad(out, leaves, torch.ones_like(out))
        return list(calls)

    even = run(8)  # mask residual: scatter, no recompute conv
    assert "scatter" in even and "conv2d" not in even, even
    ragged = run(9)  # no mask: the recompute path
    assert "conv2d" in ragged and "scatter" not in ragged, ragged


def test_primal_only_call_emits_no_mask(monkeypatch):
    """Under no_grad (or with no input requiring grad) conv_block runs the
    plain kernel call and never asks for the mask."""
    calls = []
    orig = cl.conv2d_with_mask
    monkeypatch.setattr(cl, "conv2d_with_mask", lambda *a, **k: (
        calls.append("mask"), orig(*a, **k))[1])
    rng = np.random.default_rng(23)
    x, f, b = (_t(_np(rng, 1, 8, 8, 3)), _t(_np(rng, 3, 3, 3, 4)), _t(_np(rng, 4)))
    with torch.no_grad():
        cl.conv_block(x, f, b.requires_grad_(True), 1, 1, 2, "strip")
    cl.conv_block(x, f, b.detach(), 1, 1, 2, "strip")
    assert calls == []
    cl.conv_block(x, f.clone().requires_grad_(True), b.detach(), 1, 1, 2, "strip")
    assert calls == ["mask"]


def test_unfit_pinned_schedule_warns_once_and_falls_back(monkeypatch):
    """On CPU tensors an unfit pinned schedule warns once per cell and its
    blocks still run, on the kernels' plain versions."""
    monkeypatch.setattr(cl, "_WARNED_SCHEDULES", set())
    rng = np.random.default_rng(24)
    x, w, g = _np(rng, 8, 16), _np(rng, 16, 8), _np(rng, 8, 8)
    huge = dataclasses.replace(fl.plan_bwd((8, 16), (16, 8))["dw"], vmem_bytes=10**9)
    sd = dict(fl.plan_bwd((8, 16), (16, 8)), dw=huge)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(2):
            got = _grads(lambda x, w: fl.fc_layer(x, w, None, sd), (x, w), g)
    assert sum("overflows local memory" in str(r.message) for r in rec) == 1
    assert_close(got[0], g @ w.T)
    assert_close(got[1], x.T @ g)


def test_unfit_schedule_raises_on_the_card(monkeypatch):
    """The fit gate has no fallback on the card: an unfit schedule raises
    (and warns nothing); a fitting one passes on every device."""
    monkeypatch.setattr(cl, "_WARNED_SCHEDULES", set())
    fit = fl.plan_bwd((8, 16), (16, 8))["dw"]
    huge = dataclasses.replace(fit, vmem_bytes=10**9)
    with pytest.raises(ValueError, match="local memory"):
        cl.admit_schedule("dw", huge, on_card=True)
    assert cl._WARNED_SCHEDULES == set()
    for on_card in (True, False):
        cl.admit_schedule("dw", fit, on_card=on_card)


def test_warned_set_is_the_ports_own():
    assert cl._WARNED_SCHEDULES is not jcl._WARNED_SCHEDULES
    assert fl.admit_schedule is cl.admit_schedule
    assert jfl.warn_unfit_schedule is jcl.warn_unfit_schedule


def test_with_reference_vjp_passes_needs_to_bwd_fn():
    """bwd_fn sees which differentiable arguments want a gradient
    (ctx.needs_input_grad); the trailing non-differentiable args ride as
    plain values."""
    from repro_torch.plan import with_reference_vjp

    seen = []

    def bwd(x, w, g, k, *, needs):
        seen.append(needs)
        return (g @ w.T * k if needs[0] else None), (x.T @ g * k if needs[1] else None)

    op = with_reference_vjp(lambda x, w, k: (x @ w) * k, bwd_fn=bwd,
                            nondiff_argnums=(2,))
    rng = np.random.default_rng(25)
    x, w, g = _np(rng, 4, 6), _np(rng, 6, 3), _np(rng, 4, 3)
    got = _grads(lambda x, w: op(x, w, 2.0), (x, w), g)
    assert_close(got[0], 2.0 * g @ w.T)
    assert_close(got[1], 2.0 * x.T @ g)
    wt = _t(w).requires_grad_(True)
    (dw,) = torch.autograd.grad(op(_t(x), wt, 2.0), [wt], _t(g))
    assert_close(dw, 2.0 * x.T @ g)
    assert seen == [(True, True), (False, True)]


def test_conv_dgrad_beyond_f_minus_1_runs_both_grads():
    """padding > F - 1, where ``repro`` takes XLA's reference VJP: a
    backward that needs dX runs the cropped dgrad and no longer raises;
    one that needs only dW (a model's images) runs the wgrad alone."""
    rng = np.random.default_rng(26)
    x, f = _np(rng, 2, 6, 6, 3), _np(rng, 1, 1, 3, 4)
    out, vjp = jax.vjp(lambda x, f: jconv_ref(x, f, stride=1, padding=1),
                       jnp.asarray(x), jnp.asarray(f))
    g = _np(rng, *out.shape)
    want = vjp(jnp.asarray(g))
    got = _grads(lambda x, f: cl.conv_layer(x, f, 1, 1, "strip"), (x, f), g)
    assert_close(got[0], want[0], tol=1e-5)
    assert_close(got[1], want[1], tol=1e-5)
    ft = _t(f).requires_grad_(True)
    (dw,) = torch.autograd.grad(cl.conv_layer(_t(x), ft, 1, 1, "strip"), [ft], _t(g))
    assert_close(dw, want[1])


# (F, P, S): padding F and 2F - 1 at F = 1 and 3, strides 1 and 2
WIDE_PAD_CASES = [(Fk, P, S) for Fk, P in ((1, 1), (3, 3), (3, 5)) for S in (1, 2)]


@pytest.mark.parametrize("case", WIDE_PAD_CASES, ids=lambda c: "F%d-P%d-S%d" % c)
def test_conv_grads_beyond_f_minus_1_match_repro(case):
    """dX and dW at padding > F - 1 against ``repro``'s XLA oracles and
    ``jax.grad`` of the XLA conv (batch 2; at stride 2 a ragged input),
    within 1e-5 of scale, through the conv layer and the conv block."""
    Fk, P, S = case
    rng = np.random.default_rng(27 + 7 * Fk + P + S)
    H = 8
    x, f, b = _np(rng, 2, H, H, 3), _np(rng, Fk, Fk, 3, 5), _np(rng, 5)
    out, vjp = jax.vjp(lambda x, f: jconv_ref(x, f, stride=S, padding=P),
                       jnp.asarray(x), jnp.asarray(f))
    g = _np(rng, *out.shape)
    want = vjp(jnp.asarray(g))
    dg = cb.conv2d_dgrad(cb.dilate_crop(_t(g), S, P - Fk + 1, (H, H), Fk), _t(f), stride=1,
                         padding=Fk - 1, out_hw=(H, H))
    assert_close(dg, jcb.conv2d_dgrad_ref(jnp.asarray(g), jnp.asarray(f), stride=S,
                                          padding=P, out_hw=(H, H)), tol=1e-5)
    assert_close(want[1], jcb.conv2d_wgrad_ref(jnp.asarray(x), jnp.asarray(g), F=Fk,
                                               stride=S, padding=P), tol=1e-5)
    got = _grads(lambda x, f: cl.conv_layer(x, f, S, P, "strip"), (x, f), g)
    assert_close(got[0], want[0], tol=1e-5)
    assert_close(got[1], want[1], tol=1e-5)

    def block(x, f, b):
        return jnp.maximum(jconv_ref(x, f, stride=S, padding=P) + b, 0.0)

    out, vjp = jax.vjp(block, jnp.asarray(x), jnp.asarray(f), jnp.asarray(b))
    g = _np(rng, *out.shape)
    want = vjp(jnp.asarray(g))
    got = _grads(lambda x, f, b: cl.conv_block(x, f, b, S, P, 1), (x, f, b), g)
    for gi, wi in zip(got, want):
        assert_close(gi, wi, tol=1e-5)
