"""The port's plan layer against the JAX package's.

On MANTICORE and TPU_V5E the port's MatmulPlanner, ConvPlanner and
Im2colConvPlanner must return Schedules equal field for field to
``repro``'s — the paper's Delta_O <= 24/12 and D_O <= 768/384 picks
included.  The H100 picks of every cnn-vgg11 stage at batch 256 get pins
of their own: each must fit the H100 budget and use only blocks the CUDA
kernels take.
"""

import dataclasses
import importlib

import pytest

from repro.core import machine as jm
from repro.plan import planners as jp
from repro_torch.core import machine as tm
from repro_torch.configs import get_config
from repro_torch.models import cnn
from repro_torch.plan import planners as tp

# The kernel modules (their packages re-export same-named functions).
conv_kernel_mod = importlib.import_module("repro_torch.kernels.conv2d.conv2d")
mm_kernel_mod = importlib.import_module("repro_torch.kernels.matmul.matmul")

MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]
MACHINE_IDS = ["manticore", "tpu_v5e"]


def _same(jax_sched, torch_sched):
    assert dataclasses.asdict(torch_sched) == dataclasses.asdict(jax_sched)


def test_machine_models_match_repro():
    """MANTICORE and TPU_V5E are carried across unchanged."""
    for jmach, tmach in MACHINES:
        for field in dataclasses.fields(jmach):
            assert getattr(tmach, field.name) == getattr(jmach, field.name)
        assert tmach.block_caps == ()


@pytest.mark.parametrize("prec,word,want", [("sp", 4, 24), ("dp", 8, 12)])
def test_paper_delta_o(prec, word, want):
    """The full-plane strip on MANTICORE: Delta_O = 24 (sp) / 12 (dp)."""
    shape = dict(H_O=32, W_O=32, F=3, S=1, d_in=128, d_out=128, in_bytes=word,
                 padding=1, H_I=32, W_I=32, block_h=32)
    got = tp.ConvPlanner(tm.MANTICORE).plan(**shape)
    assert got.block("block_do") == want and got.fits(tm.MANTICORE)
    _same(jp.ConvPlanner(jm.MANTICORE).plan(**shape), got)


@pytest.mark.parametrize("word,want", [(4, 768), (8, 384)])
def test_paper_fc_stack(word, want):
    """Alg 5's D_O <= 768 (sp) / 384 (dp) at B = 32 on MANTICORE."""
    shape = dict(m=32, n=4096, k=7 * 7 * 512, in_bytes=word)
    got = tp.MatmulPlanner(tm.MANTICORE).plan(**shape)
    assert got.block("block_n") == want
    _same(jp.MatmulPlanner(jm.MANTICORE).plan(**shape), got)


CONV_SHAPES = [
    dict(H_O=32, W_O=32, F=3, S=1, d_in=128, d_out=256, in_bytes=4, block_di=128),
    dict(H_O=32, W_O=32, F=3, S=1, d_in=64, d_out=512, in_bytes=2, pool=2),
    dict(H_O=112, W_O=112, F=7, S=2, d_in=3, d_out=64, in_bytes=4),
    dict(H_O=16, W_O=16, F=5, S=1, d_in=8, d_out=16, in_bytes=4),
    dict(H_O=15, W_O=15, F=5, S=1, d_in=7, d_out=40, in_bytes=4),
    dict(H_O=7, W_O=7, F=1, S=2, d_in=512, d_out=256, in_bytes=4),
    dict(H_O=9, W_O=9, F=3, S=1, d_in=5, d_out=7, in_bytes=4, padding=1,
         H_I=9, W_I=9, block_h=4),
]


@pytest.mark.parametrize("alg", [None, "direct", "im2col"])
@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_conv_planner_matches_repro(machines, shape, alg):
    jmach, tmach = machines
    if alg is not None and shape.get("block_di"):
        shape = {k: v for k, v in shape.items() if k != "block_di"}
    _same(jp.ConvPlanner(jmach).plan(**shape, algorithm=alg),
          tp.ConvPlanner(tmach).plan(**shape, algorithm=alg))


@pytest.mark.parametrize("shape", CONV_SHAPES[2:5])
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_im2col_planner_matches_repro(machines, shape):
    jmach, tmach = machines
    _same(jp.Im2colConvPlanner(jmach).plan(**shape),
          tp.Im2colConvPlanner(tmach).plan(**shape))


@pytest.mark.parametrize("m,n,k,word", [
    (4096, 16384, 8192, 2), (128, 256, 512, 4), (32, 4096, 25088, 4),
    (1, 300, 17, 4), (37, 70, 90, 2), (256, 1000, 4096, 4)])
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_matmul_planner_matches_repro(machines, m, n, k, word):
    jmach, tmach = machines
    shape = dict(m=m, n=n, k=k, in_bytes=word)
    _same(jp.MatmulPlanner(jmach).plan(**shape),
          tp.MatmulPlanner(tmach).plan(**shape))


@pytest.mark.parametrize("alg", [None, "direct", "im2col"])
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_vgg11_plan_matches_repro(machines, alg):
    """Every cnn-vgg11 stage at batch 256, through each package's own
    stage geometry, plans identically."""
    from repro.configs.registry import get_config as jax_config
    from repro.models import cnn as jcnn

    jmach, tmach = machines
    want = {}
    for name, x_shape, w_shape in jcnn._stage_geometry(jax_config("cnn-vgg11"), 256):
        if name.startswith("conv"):
            H = x_shape[1]
            want[name] = jp.ConvPlanner(jmach).plan(
                H_O=H, W_O=H, F=3, S=1, d_in=x_shape[3], d_out=w_shape[3],
                in_bytes=4, pool=2, batch=256, padding=1, H_I=H, W_I=H,
                algorithm=alg)
        else:
            want[name] = jp.MatmulPlanner(jmach).plan(
                m=256, n=w_shape[1], k=w_shape[0], in_bytes=4)
    got = cnn.plan_forward(get_config("cnn-vgg11"), 256, machine=tmach,
                           conv_algorithm=alg)
    assert set(got) == set(want)
    for name in want:
        _same(want[name], got[name])


# -- H100 ---------------------------------------------------------------------

# (algorithm, blocks) of every cnn-vgg11 stage at batch 256 on the H100.
H100_PICKS = {
    None: {
        "conv0": ("direct", dict(block_di=8, block_do=64, block_h=16)),
        "conv1": ("direct", dict(block_di=16, block_do=64, block_h=16)),
        "conv2": ("direct", dict(block_di=16, block_do=64, block_h=8)),
        "conv3": ("im2col", dict(block_h=4, block_k=32, block_m=64, block_n=128)),
    },
    "direct": {
        "conv0": ("direct", dict(block_di=8, block_do=64, block_h=16)),
        "conv1": ("direct", dict(block_di=16, block_do=64, block_h=16)),
        "conv2": ("direct", dict(block_di=16, block_do=64, block_h=8)),
        "conv3": ("direct", dict(block_di=16, block_do=64, block_h=4)),
    },
    "im2col": {
        "conv0": ("im2col", dict(block_h=32, block_k=32, block_m=64, block_n=64)),
        "conv1": ("im2col", dict(block_h=16, block_k=32, block_m=64, block_n=128)),
        "conv2": ("im2col", dict(block_h=8, block_k=32, block_m=64, block_n=128)),
        "conv3": ("im2col", dict(block_h=4, block_k=32, block_m=64, block_n=128)),
    },
}
FC_PICK = ("direct", dict(block_k=32, block_m=64, block_n=128))


def _kernel_takes(name, sched, x_shape):
    """Does the CUDA kernel that runs ``sched`` accept its blocks?"""
    b = sched.block_dict()
    if sched.algorithm == "im2col" or name.startswith("fc"):
        return mm_kernel_mod.supported_blocks(b["block_m"], b["block_n"], b["block_k"])
    return conv_kernel_mod.supported_blocks(
        block_h=b["block_h"], block_do=b["block_do"], block_di=b["block_di"],
        W_O=x_shape[2], F=3, S=1, pool=2)


@pytest.mark.parametrize("alg", [None, "direct", "im2col"])
def test_h100_vgg11_picks(alg):
    cfg = get_config("cnn-vgg11")
    plans = cnn.plan_forward(cfg, 256, conv_algorithm=alg)
    geometry = {name: x for name, x, _ in cnn._stage_geometry(cfg, 256)}
    for name, sched in plans.items():
        want = H100_PICKS[alg].get(name, FC_PICK)
        assert (sched.algorithm, sched.block_dict()) == want, name
        assert sched.machine == "h100"
        assert sched.fits(tm.H100), name
        assert _kernel_takes(name, sched, geometry[name]), name


@pytest.mark.parametrize("m,n,k", [
    (1, 1, 1), (10, 10, 64), (37, 70, 90), (256, 4096, 2048), (256, 1000, 4096),
    (65536, 256, 1152), (3, 5000, 7), (1024, 8, 9999)])
def test_h100_matmul_plans_only_supported_blocks(m, n, k):
    s = tp.MatmulPlanner(tm.H100).plan(m=m, n=n, k=k, in_bytes=4)
    assert s.fits(tm.H100)
    assert mm_kernel_mod.smem_bytes(s.block("block_m"), s.block("block_n"),
                                    s.block("block_k")) == s.vmem_bytes
    assert mm_kernel_mod.supported_blocks(s.block("block_m"), s.block("block_n"),
                                          s.block("block_k"))


@pytest.mark.parametrize("H,d_in,d_out,S,pool", [
    (32, 3, 64, 1, 2), (9, 5, 7, 1, 1), (33, 16, 40, 2, 1), (64, 128, 256, 1, 2),
    (7, 513, 9, 1, 1), (224, 3, 64, 2, 1)])
def test_h100_conv_plans_only_supported_blocks(H, d_in, d_out, S, pool):
    W_O = (H + 2 - 3) // S + 1
    s = tp.ConvPlanner(tm.H100).plan(
        H_O=W_O, W_O=W_O, F=3, S=S, d_in=d_in, d_out=d_out, in_bytes=4,
        pool=pool, padding=1, H_I=H, W_I=H, algorithm="direct")
    b = s.block_dict()
    assert s.fits(tm.H100)
    assert conv_kernel_mod.smem_bytes(
        block_h=b["block_h"], block_do=b["block_do"], block_di=b["block_di"],
        W_O=W_O, F=3, S=S) == s.vmem_bytes
    assert conv_kernel_mod.supported_blocks(
        block_h=b["block_h"], block_do=b["block_do"], block_di=b["block_di"],
        W_O=W_O, F=3, S=S, pool=pool)


def test_one_device_mesh_degenerates_and_more_devices_raise():
    from repro_torch.plan import MeshSpec

    shape = dict(m=256, n=1000, k=4096, in_bytes=4)
    local = tp.MatmulPlanner(tm.H100).plan(**shape)
    ss = tp.MatmulPlanner(tm.H100, MeshSpec((("model", 1),))).plan(**shape)
    assert ss.schedule == local and ss.strategy == "single"
    assert ss.modeled_words == local.modeled_words
    # Four devices plan the matmul's partitions (tests/test_torch_mesh.py);
    # the MoE's wait for the token families' sharding and raise.
    ss4 = tp.MatmulPlanner(tm.H100, MeshSpec((("model", 4),))).plan(**shape)
    assert ss4.devices == 4 and ss4.strategy in ("batch", "psum", "ring", "tp")
    with pytest.raises(NotImplementedError, match="5b"):
        tp.MoeFfnPlanner(tm.H100, MeshSpec((("model", 4),))).plan(
            tokens=64, d_model=32, d_ff=64, n_experts=4)
