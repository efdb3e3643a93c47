"""The port's analysis hooks against the JAX package's: ``conv_layer.traffic``
and ``fc_layer.traffic`` for every strategy, the ``Schedule`` methods
(``traffic``, ``bound_kind``, ``arithmetic_intensity``, ``evolve``) and
``to_roofline`` / ``Roofline``, field for field on MANTICORE and TPU_V5E.

The port's ``Roofline`` takes its peaks from a machine (a stated divergence:
``repro`` divides by TPU v5e constants whatever the schedule); on TPU_V5E
its terms equal ``repro``'s, on H100 they use 67 TFLOP/s and 3.35 TB/s.
The last tests pin what phase ``paper`` of ``chip_smoke.py`` reports on
the card: the H100 schedules of its conv and FC cases, Alg 3 planning as
Alg 2, im2col taking a full plane that does not fit, and the planner's
rejection of Alg 1 where no strip fits.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

from repro.analysis import roofline as jr
from repro.core import ccr as jc
from repro.core import conv_layer as jcl
from repro.core import fc_layer as jfl
from repro.core import machine as jm
from repro.plan import planners as jp
from repro.plan import schedule as js
from repro_torch.analysis import roofline as tr
from repro_torch.configs import get_config
from repro_torch.core import ccr as tc
from repro_torch.core import conv_layer as tcl
from repro_torch.core import fc_layer as tfl
from repro_torch.core import machine as tm
from repro_torch.models import cnn
from repro_torch.plan import planners as tp
from repro_torch.plan import schedule as ts
from repro_torch.plan.planners import PlanRejected

REL = 1e-12
MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]
MACHINE_IDS = ["manticore", "tpu_v5e"]
CONV_SHAPES = [
    dict(W_I=32, D_I=128, D_O=128, F=3, S=1, P=1),  # the running example
    dict(W_I=32, D_I=3, D_O=64, F=3, S=1, P=1),  # cnn-vgg11 conv0
    dict(W_I=8, D_I=128, D_O=256, F=3, S=1, P=1),  # cnn-vgg11 conv2
    dict(W_I=13, D_I=7, D_O=11, F=5, S=1, P=2),
]
FC_SHAPES = [
    dict(W_I=7, D_I=512, D_O=4096, B=32),  # the paper's fc6
    dict(W_I=2, D_I=512, D_O=4096, B=256),  # cnn-vgg11 fc1
    dict(W_I=3, D_I=5, D_O=77, B=9),
]

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)  # stdlib only at import: no card needed


def _same_traffic(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ccr == pytest.approx(want.ccr, rel=REL)
    assert got.ccr_offchip == pytest.approx(want.ccr_offchip, rel=REL)


# -- the layers' traffic hooks ----------------------------------------------


@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
@pytest.mark.parametrize("precision", ["sp", "dp"])
@pytest.mark.parametrize("strategy", ["alg1", "alg2", "alg3", "strip"])
@pytest.mark.parametrize("d", CONV_SHAPES, ids=[str(i) for i in range(len(CONV_SHAPES))])
def test_conv_layer_traffic_equals_repro(d, strategy, precision, machines):
    jmach, tmach = machines
    want = jcl.traffic(jc.ConvShape(**d), strategy, precision, jmach)
    got = tcl.traffic(tc.ConvShape(**d), strategy, precision, tmach)
    _same_traffic(got, want)


@pytest.mark.parametrize("h_block", [1, 4, 32])
def test_conv_layer_strip_traffic_at_a_strip_equals_repro(h_block):
    d = CONV_SHAPES[0]
    want = jcl.traffic(jc.ConvShape(**d), "strip", h_block=h_block)
    _same_traffic(tcl.traffic(tc.ConvShape(**d), "strip", h_block=h_block), want)


def test_layer_traffic_defaults_to_manticore():
    d, f = CONV_SHAPES[0], FC_SHAPES[0]
    _same_traffic(tcl.traffic(tc.ConvShape(**d)), jcl.traffic(jc.ConvShape(**d)))
    _same_traffic(tfl.traffic(tc.FCShape(**f)), jfl.traffic(jc.FCShape(**f)))
    assert tcl.traffic(tc.ConvShape(**d), "alg2").main_words == tc.alg2_traffic(
        tc.ConvShape(**d), 24).main_words  # Delta_O = 24 on Manticore, sp
    with pytest.raises(ValueError):
        tcl.traffic(tc.ConvShape(**d), "alg9")
    with pytest.raises(ValueError):
        tfl.traffic(tc.FCShape(**f), "alg6")


@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
@pytest.mark.parametrize("precision", ["sp", "dp"])
@pytest.mark.parametrize("strategy,clusters", [("alg4", 128), ("alg5", 128), ("alg5", 16)])
@pytest.mark.parametrize("d", FC_SHAPES, ids=["fc6", "fc1", "small"])
def test_fc_layer_traffic_equals_repro(d, strategy, clusters, precision, machines):
    jmach, tmach = machines
    want = jfl.traffic(jc.FCShape(**d), strategy, precision, jmach, clusters)
    _same_traffic(tfl.traffic(tc.FCShape(**d), strategy, precision, tmach, clusters), want)


# -- Schedule methods ---------------------------------------------------------


def _planned(machines):
    """Schedules of both packages from the same planner calls."""
    jmach, tmach = machines
    calls = [
        ("ConvPlanner", dict(H_O=32, W_O=32, F=3, S=1, d_in=128, d_out=128, in_bytes=4,
                             padding=1, H_I=32, W_I=32, block_h=32)),
        ("ConvPlanner", dict(H_O=16, W_O=16, F=3, S=1, d_in=64, d_out=128, in_bytes=4,
                             padding=1, H_I=16, W_I=16, pool=2, batch=8)),
        ("MatmulPlanner", dict(m=32, n=4096, k=25088, in_bytes=4)),
        ("MatmulPlanner", dict(m=256, n=1000, k=4096, in_bytes=2)),
        ("ConvWgradPlanner", dict(H_O=16, W_O=16, F=3, S=1, d_in=64, d_out=128, in_bytes=4,
                                  batch=4, padding=1, H_I=16, W_I=16)),
    ]
    return [(getattr(jp, p)(jmach).plan(**kw), getattr(tp, p)(tmach).plan(**kw))
            for p, kw in calls]


@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_schedule_methods_equal_repro(machines):
    for want, got in _planned(machines):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        _same_traffic(got.traffic, want.traffic)
        for jmach, tmach in MACHINES:
            for prec in ("sp", "dp", "bf16"):
                assert got.bound_kind(tmach, prec) == want.bound_kind(jmach, prec)
        for prec in ("sp", "dp", "bf16"):
            assert got.arithmetic_intensity(prec) == pytest.approx(
                want.arithmetic_intensity(prec), rel=REL)
        assert got.bound_kind(tm.H100) in ("compute-bound", "memory-bound")
        name = sorted(got.block_dict())[0]
        for upd in ({name: 8}, {name: 8, "block_zz": 3}, {}):
            assert dataclasses.asdict(got.evolve(**upd)) == dataclasses.asdict(
                want.evolve(**upd))


def test_evolve_keeps_the_model_fields():
    s = ts.Schedule(op="matmul", grid=(1,), blocks=(("block_m", 8),), macs=5, loads=7,
                    stores=3)
    e = s.evolve(block_n=16, block_m=4)
    assert e.blocks == (("block_m", 4), ("block_n", 16))
    assert (e.macs, e.loads, e.stores, e.grid) == (5, 7, 3, (1,))


# -- to_roofline and Roofline -----------------------------------------------------


@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
@pytest.mark.parametrize("precision,chips", [("sp", 1), ("dp", 1), ("bf16", 4)])
def test_to_roofline_equals_repro(machines, precision, chips):
    for want_s, got_s in _planned(machines):
        want = js.to_roofline(want_s, precision=precision, chips=chips)
        got = ts.to_roofline(got_s, precision=precision, chips=chips,
                             machine=tm.TPU_V5E)
        for f in ("flops", "bytes_hbm", "bytes_coll", "chips", "model_flops"):
            assert getattr(got, f) == getattr(want, f)
        # repro divides by TPU v5e constants: so does the port on TPU_V5E
        for f in ("t_compute", "t_memory", "t_collective", "t_bound", "useful_ratio",
                  "roofline_fraction"):
            assert getattr(got, f) == pytest.approx(getattr(want, f), rel=REL)
        assert got.bottleneck == want.bottleneck
        d, w = got.as_dict(), want.as_dict()
        assert d.pop("machine") == "tpu_v5e"
        assert d.pop("bottleneck") == w.pop("bottleneck")
        assert d == pytest.approx(w, rel=REL)


def test_to_roofline_takes_the_schedules_machine():
    """Peaks from the machine the schedule was planned against: 67 TFLOP/s
    and 3.35 TB/s on the H100 (the bound column of PERF.md)."""
    s = tp.MatmulPlanner(tm.H100).plan(m=32, n=4096, k=25088, in_bytes=4)
    r = ts.to_roofline(s)
    assert r.machine is tm.H100
    assert r.t_compute == pytest.approx(2.0 * s.macs / 67e12, rel=REL)
    assert r.t_memory == pytest.approx(4.0 * s.modeled_words / 3.35e12, rel=REL)
    assert r.t_collective == 0.0
    assert r.bottleneck == "memory" and s.bound_kind(tm.H100) == "memory-bound"
    man = tp.MatmulPlanner(tm.MANTICORE).plan(m=32, n=4096, k=25088, in_bytes=4)
    assert ts.to_roofline(man).machine is tm.MANTICORE
    assert ts.to_roofline(man, machine=tm.H100).machine is tm.H100


@pytest.mark.parametrize("flops,hbm,coll,chips", [(1e12, 1e9, 0.0, 1), (1e9, 1e12, 0.0, 2),
                                                  (1e9, 1e9, 1e12, 4), (0.0, 0.0, 0.0, 1)])
def test_roofline_terms_equal_repro_on_tpu(flops, hbm, coll, chips):
    want = jr.Roofline(flops, hbm, coll, chips, model_flops=flops / 2)
    got = tr.Roofline(flops, hbm, coll, chips, model_flops=flops / 2, machine=tm.TPU_V5E)
    for f in ("t_compute", "t_memory", "t_collective", "t_bound", "useful_ratio",
              "roofline_fraction"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=REL)
    if flops or hbm or coll:
        assert got.bottleneck == want.bottleneck


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_repro(kind):
    assert tr.model_flops(kind, 463_987_712, 4 * 2048) == jr.model_flops(
        kind, 463_987_712, 4 * 2048)


# -- the planner at the paper's shapes --------------------------------------------


@pytest.mark.parametrize("prec,word,stack", [("sp", 4, 24), ("dp", 8, 12)])
def test_conv_planner_reproduces_eq7_on_manticore(prec, word, stack):
    """examples/quickstart.py's check through the port: the full-plane
    ConvPlanner on MANTICORE picks Delta_O = 24 (sp) / 12 (dp) and models
    exactly Eq. (7)'s words."""
    s = tp.ConvPlanner(tm.MANTICORE).plan(
        H_O=32, W_O=32, F=3, S=1, d_in=128, d_out=128, in_bytes=word, padding=1,
        H_I=32, W_I=32, block_h=32)
    shape = tc.ConvShape(W_I=32, D_I=128, D_O=128, F=3, S=1, P=1)
    assert s.block("block_do") == stack
    assert s.modeled_words == tc.alg2_traffic(shape, stack).main_words
    assert s.traffic == tc.alg2_traffic(shape, stack)


@pytest.mark.parametrize("strategy", ["alg1", "alg2", "alg3", "strip"])
def test_conv_plan_strategies_equal_repro_on_manticore(strategy):
    """conv_layer.plan maps the strategies as repro's does (Alg 3 pins the
    full plane, as Alg 2) on MANTICORE, whose lane is one channel."""
    kw = dict(stride=1, padding=1, pool=2, in_bytes=4, strategy=strategy, autotune="off")
    want = jcl.plan((2, 32, 32, 128), (3, 3, 128, 128), machine=jm.MANTICORE, **kw)
    got = tcl.plan((2, 32, 32, 128), (3, 3, 128, 128), machine=tm.MANTICORE, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("strategy", ["alg2", "alg3", "strip"])
def test_conv_plan_strategies_equal_repro_on_tpu(strategy):
    kw = dict(stride=1, padding=1, in_bytes=4, strategy=strategy, autotune="off")
    want = jcl.plan((8, 16, 16, 64), (3, 3, 64, 128), machine=jm.TPU_V5E, **kw)
    got = tcl.plan((8, 16, 16, 64), (3, 3, 64, 128), machine=tm.TPU_V5E, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_paper_phase_cases_are_the_stated_shapes():
    cfg = get_config("cnn-vgg11")
    conv = chip_smoke.paper_conv_cases(cnn, cfg)
    assert [c[:2] for c in conv] == [("example_b1", 1), ("example_b256", 256), ("conv0", 256),
                                     ("conv1", 256), ("conv2", 256), ("conv3", 256)]
    assert conv[0][2] == dict(W_I=32, D_I=128, D_O=128, F=3, S=1, P=1)
    assert conv[-1][2] == dict(W_I=4, D_I=256, D_O=512, F=3, S=1, P=1)
    assert chip_smoke.paper_fc_cases(cnn, cfg) == [
        ("fc6", dict(W_I=7, D_I=512, D_O=4096, B=32)),
        ("fc1", dict(W_I=2, D_I=512, D_O=4096, B=256)),
        ("fc2", dict(W_I=1, D_I=4096, D_O=1000, B=256))]


def _paper_conv_plans():
    cfg = get_config("cnn-vgg11")
    for label, batch, d in chip_smoke.paper_conv_cases(cnn, cfg):
        x_shape = chip_smoke.paper_x_shape(d, batch)
        f_shape = (d["F"], d["F"], d["D_I"], d["D_O"])
        yield label, d, {s: chip_smoke.paper_plan(tcl, x_shape, f_shape, s, d["P"])
                         for s in chip_smoke.PAPER_STRATEGIES}


# The family the two-level argmin picks for each strategy at the phase's
# shapes: Alg 1's one-lane stack pins the direct kernel; Algs 2-3 pin only the
# full plane and the strip pins nothing, so im2col competes, and at conv3
# (a 4 x 4 plane at batch 256) its GEMM models fewer words.
PAPER_ALGORITHMS = {"conv3": dict(alg1="direct", alg2="im2col", alg3="im2col",
                                  strip="im2col")}


@pytest.mark.parametrize("label", ["example_b1", "example_b256", "conv0", "conv1", "conv2",
                                   "conv3"])
def test_paper_phase_conv_plans_on_h100(label):
    """Every strategy plans a schedule that fits one block's shared memory
    at the phase's shapes (no rejection there); Alg 1 runs one lane of 8
    channels; Alg 2 and Alg 3 pin the full plane and are one schedule."""
    (_, d, plans), = [p for p in _paper_conv_plans() if p[0] == label]
    want = PAPER_ALGORITHMS.get(label, dict.fromkeys(chip_smoke.PAPER_STRATEGIES, "direct"))
    for strategy, (s, rejected) in plans.items():
        assert rejected is None, rejected
        assert s.algorithm == want[strategy] and s.fits(tm.H100) and s.machine == "h100"
    assert plans["alg1"][0].block("block_do") == tm.H100.lane
    assert plans["alg2"][0].block("block_h") == tc.ConvShape(**d).W_O
    assert plans["alg3"][0] == plans["alg2"][0]


@pytest.mark.parametrize("W", [64, 112])
def test_full_plane_that_does_not_fit_goes_to_im2col(W):
    """A full W x W plane at 128 channels leaves no lane-aligned stack in
    227 KB: under Algs 2-3 the argmin hands the plane to the im2col GEMM
    (as ``repro``'s does on its machines), which fits."""
    x_shape, f_shape = (W, W, 128), (3, 3, 128, 128)
    for strategy in ("alg2", "alg3"):
        s, rejected = chip_smoke.paper_plan(tcl, x_shape, f_shape, strategy, 1)
        assert rejected is None and s.algorithm == "im2col" and s.fits(tm.H100)
        assert s.block("block_h") == W
        direct = tp.ConvPlanner(tm.H100).plan(
            H_O=W, W_O=W, F=3, S=1, d_in=128, d_out=128, in_bytes=4, padding=1, H_I=W,
            W_I=W, block_h=W, algorithm="direct")
        assert not direct.fits(tm.H100)


@pytest.mark.parametrize("W,d_in", [(1024, 64), (2048, 16)])
def test_alg1_that_does_not_fit_is_rejected_by_the_planner(W, d_in):
    """Alg 1 pins the direct kernel (block_do = one lane): where not even a
    one-row strip of the plane fits 227 KB, the phase's planning call
    reports PlanRejected with the bytes asked for."""
    x_shape, f_shape = (W, W, d_in), (3, 3, d_in, 64)
    s, rejected = chip_smoke.paper_plan(tcl, x_shape, f_shape, "alg1", 1)
    assert s is None and rejected.startswith("conv2d: strategy 'alg1'")
    assert "more than the 232448 B one block holds" in rejected
    with pytest.raises(PlanRejected):
        tcl.plan(x_shape, f_shape, padding=1, strategy="alg1", autotune="off")


def test_paper_phase_fc6_degenerates_to_eqs_12_13():
    """At the paper's fc6 the H100 schedule's block_m covers the batch of 32
    and nothing pads, so its words are Alg 5's Eqs. (12)-(13) at the stack
    block_n; cnn-vgg11's fc1 at batch 256 re-streams the weights per
    m-block instead."""
    cfg = get_config("cnn-vgg11")
    for label, d in chip_smoke.paper_fc_cases(cnn, cfg):
        m, k, n = d["B"], d["W_I"] ** 2 * d["D_I"], d["D_O"]
        s = tfl.plan((m, k), (k, n), autotune="off")
        assert s.fits(tm.H100)
        bm, bn, bk = s.block("block_m"), s.block("block_n"), s.block("block_k")
        eq = tc.alg5_traffic(tc.FCShape(**d), bn)
        if label == "fc6":
            assert bm == m and n % bn == 0 and k % bk == 0
            assert (s.loads, s.stores) == (eq.main_loads, eq.main_stores)
        else:
            assert bm < m and s.loads > eq.main_loads


def test_paper_phase_quotes():
    """The quoted line of phase paper: every number within 0.05 of print."""
    quotes = chip_smoke.paper_quotes(tc, tm.MANTICORE)
    assert len(quotes) == 18
    for key, q in quotes.items():
        assert abs(q["port"] - q["paper"]) <= 0.05, key
