"""The port's analysis layer (``core/ccr.py``, ``core/schedule_sim.py``)
against the JAX package's.

Every public name of ``repro.core.ccr`` and ``repro.core.schedule_sim`` has
a counterpart in the port with the same parameters and equal results:
integers (MACs, words, stacks) exactly, CCR and flop/B values within 1e-12
relative.  The paper's quoted numbers (Secs. 2.1-3.2) are reproduced
through the port, and every walker of the port equals the port's closed
form and ``repro``'s walker.

Property tests draw with ``derandomize=True`` (the same examples every
run, so the pass count cannot move) and build Alg 3's ``D_I`` as
``16 * k`` instead of filtering for it.
"""

import dataclasses
import inspect

import pytest
from _hyp import given, settings, st

from repro.core import ccr as jc
from repro.core import machine as jm
from repro.core import schedule_sim as jsim
from repro_torch.core import ccr as tc
from repro_torch.core import machine as tm
from repro_torch.core import schedule_sim as tsim
from repro_torch.plan import AttentionPlanner

REL = 1e-12
PRECISIONS = ("sp", "dp", "bf16")
HYP = dict(deadline=None, derandomize=True)

# The paper's running conv example (W_I = W_O = 32, F = 3, D_I = D_O = 128)
# and its FC example (VGG fc6: W_I = 7, D_I = 512, D_O = 4096, B = 32).
CONV = tc.ConvShape(W_I=32, D_I=128, D_O=128, F=3, S=1, P=1)
FC = tc.FCShape(W_I=7, D_I=512, D_O=4096, B=32)

CONV_SHAPES = [
    dict(W_I=32, D_I=128, D_O=128, F=3, S=1, P=1),  # the running example
    dict(W_I=16, D_I=64, D_O=128, F=3, S=1, P=1),  # cnn-vgg11 conv1
    dict(W_I=4, D_I=256, D_O=512, F=3, S=1, P=1),  # cnn-vgg11 conv3
    dict(W_I=17, D_I=33, D_O=70, F=5, S=1, P=2),
    dict(W_I=9, D_I=5, D_O=13, F=3, S=2, P=0),
    dict(W_I=6, D_I=16, D_O=9, F=1, S=1, P=0),
]
FC_SHAPES = [
    dict(W_I=7, D_I=512, D_O=4096, B=32),  # the paper's fc6
    dict(W_I=2, D_I=512, D_O=4096, B=256),  # cnn-vgg11 fc1
    dict(W_I=1, D_I=4096, D_O=1000, B=256),  # cnn-vgg11 fc2
    dict(W_I=3, D_I=5, D_O=77, B=9),
]
MACHINES = {"manticore": (jm.MANTICORE, tm.MANTICORE), "tpu_v5e": (jm.TPU_V5E, tm.TPU_V5E)}


def _jconv(d):
    return jc.ConvShape(**d)


def _jfc(d):
    return jc.FCShape(**d)


def _to_port(v):
    """The port's counterpart of one argument given in ``repro``'s terms."""
    if isinstance(v, jc.ConvShape):
        return tc.ConvShape(**dataclasses.asdict(v))
    if isinstance(v, jc.FCShape):
        return tc.FCShape(**dataclasses.asdict(v))
    if isinstance(v, jc.Traffic):
        return tc.Traffic(**dataclasses.asdict(v))
    if isinstance(v, jm.MachineModel):
        return tm.MACHINES[v.name]
    return v


def _assert_same(got, want):
    """Field for field: ints exactly, floats within REL, traffic with its
    derived CCRs and flop/B."""
    if isinstance(want, jc.Traffic):
        assert isinstance(got, tc.Traffic)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.main_words == want.main_words
        if want.main_words:
            assert got.ccr == pytest.approx(want.ccr, rel=REL)
            assert got.ccr_offchip == pytest.approx(want.ccr_offchip, rel=REL)
            for prec in PRECISIONS:
                for off in (False, True):
                    assert got.flops_per_byte(prec, off) == pytest.approx(
                        want.flops_per_byte(prec, off), rel=REL)
    elif isinstance(want, (jc.ConvShape, jc.FCShape)):
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    elif isinstance(want, float):
        assert isinstance(got, float) and got == pytest.approx(want, rel=REL)
    else:
        assert type(got) is type(want) and got == want


def _public(mod):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and getattr(v, "__module__", None) == mod.__name__)


def _cases():
    """(name, args, kwargs) calls of every public ccr function, in
    ``repro``'s terms."""
    out = []
    add = lambda name, *a, **k: out.append((name, a, k))
    for d in CONV_SHAPES:
        s = _jconv(d)
        for name in ("conv_macs", "alg1_traffic", "alg1_ccr", "alg1_ccr_approx",
                     "alg1_space_words"):
            add(name, s)
        for stack in (1, 7, 24, 200):
            add("alg2_traffic", s, stack)
            add("alg2_space_words", s, stack)
            add("alg3_space_words", s, stack)
            add("alg3_ccr_offchip_as_quoted", s, stack)
            for group in (16, 4):
                add("alg3_traffic", s, stack, group)
            add("alg3_ccr_offchip_as_quoted", s, stack, 4)
            for hb in sorted({1, 3, s.W_O}):
                add("alg2_strip_traffic", s, stack, hb)
                add("alg2_strip_space_words", s, stack, hb)
                add("conv_wgrad_traffic", s, stack, hb, 8, 3)
                add("conv_sharded_traffic", s, stack, hb, devices=2, strategy="batch", batch=4)
                if s.P <= s.F - 1:
                    add("conv_dgrad_traffic", s, stack, hb, batch=2)
            if s.D_O % 2 == 0:
                add("conv_sharded_traffic", s, stack, 2, devices=2, strategy="stack", batch=3)
        if s.P <= s.F - 1:
            add("conv_dgrad_shape", s)
        for mach, _ in MACHINES.values():
            for prec in PRECISIONS:
                add("alg2_max_stack", s, mach, prec)
                add("alg3_max_stack", s, mach, prec)
                add("alg2_strip_max_stack", s, mach, prec, 2)
                for t in (jc.alg1_traffic(s), jc.alg2_traffic(s, 24), jc.alg3_traffic(s, 23)):
                    add("bound_kind", t, mach, prec)
    for d in FC_SHAPES:
        s = _jfc(d)
        for name in ("fc_macs", "alg4_ccr", "alg4_space_words"):
            add(name, s)
        for clusters in (128, 16, 1):
            add("alg4_traffic", s, clusters)
            for stack in (1, 96, 768, 5000):
                add("alg5_traffic", s, stack, clusters)
        for stack in (1, 96, 768, 5000):
            add("alg5_ccr", s, stack)
            add("alg5_space_words", s, stack)
        for mach, _ in MACHINES.values():
            for prec in PRECISIONS:
                add("alg45_max_stack", s, mach, prec)
                add("bound_kind", jc.alg5_traffic(s, 96), mach, prec)
    for n in (1, 2, 3, 16, 127, 128):
        add("tree_reduce_words", n, 1000)
    mm = [dict(m=256, n=4096, k=2048, block_m=64, block_n=128, block_k=32),
          dict(m=37, n=77, k=300, block_m=8, block_n=16, block_k=16),
          dict(m=32, n=4096, k=25088, block_m=32, block_n=768, block_k=512)]
    for kw in mm:
        add("matmul_block_traffic", **kw)
        add("fc_psum_traffic", devices=4, **{**kw, "k": kw["k"] * 4})
        add("tp_matmul_traffic", devices=4, **{**kw, "n": kw["n"] * 4})
    for devices in (1, 2, 4, 8):
        add("ring_traffic", m=8, n=64, k=128, devices=devices)
        add("moe_all_to_all_words", tokens=64, d_model=32, top_k=2, n_experts=8, devices=devices)
    for pool, batch in ((1, 1), (2, 3)):
        add("conv_im2col_traffic", H_O=16, W_O=16, F=3, S=1, d_in=64, d_out=128, block_h=8,
            block_m=64, block_n=128, block_k=32, pool=pool, batch=batch)
        add("conv_im2col_traffic", H_O=9, W_O=9, F=5, S=2, d_in=5, d_out=13, block_h=4,
            block_m=8, block_n=16, block_k=16, pool=pool, batch=batch)
        add("epilogue_scatter_traffic", H_O=16, W_O=16, d_out=64, pool=pool, batch=batch)
        add("epilogue_scatter_traffic", H_O=8, W_O=8, d_out=5, pool=pool, batch=batch,
            in_bytes=2)
    for grid in ((), (3,), (2, 5, 7), (256, 1, 4, 8)):
        add("grid_steps", grid)
    for kw in (dict(H_I=32, d_in=64, block_h=16, block_do=64, batch=2),
               dict(H_I=9, d_in=13, block_h=4, block_do=8)):
        add("conv_dgrad_fused_steps", **kw)
    for pipelined in (False, True):
        add("conv_wgrad_steps", H_O=16, d_in=64, d_out=128, block_h=8, block_di=16,
            block_do=64, batch=3, pipelined=pipelined)
    return out


CASES = _cases()


@pytest.mark.parametrize("name", _public(jc))
def test_public_name_has_counterpart(name):
    """Same name, same kind, same parameters (dataclasses: same fields)."""
    j, t = getattr(jc, name), getattr(tc, name)
    if dataclasses.is_dataclass(j):
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        assert {n for n in vars(j) if not n.startswith("_")} <= set(dir(t))
    else:
        assert list(inspect.signature(t).parameters) == list(inspect.signature(j).parameters)


def test_every_function_is_called():
    called = {name for name, _, _ in CASES}
    classes = {n for n in _public(jc) if inspect.isclass(getattr(jc, n))}
    assert set(_public(jc)) - classes - called == set()


@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CASES)])
def test_closed_form_equals_repro(name, args, kwargs):
    want = getattr(jc, name)(*args, **kwargs)
    got = getattr(tc, name)(*map(_to_port, args),
                            **{k: _to_port(v) for k, v in kwargs.items()})
    _assert_same(got, want)


@pytest.mark.parametrize("name,kw", [
    ("ring_traffic", dict(m=8, n=64, k=130, devices=4)),
    ("fc_psum_traffic", dict(m=8, n=64, k=130, devices=4, block_m=8, block_n=8, block_k=8)),
    ("tp_matmul_traffic", dict(m=8, n=66, k=64, devices=4, block_m=8, block_n=8, block_k=8)),
    ("moe_all_to_all_words", dict(tokens=64, d_model=32, top_k=2, n_experts=6, devices=4)),
    ("moe_all_to_all_words", dict(tokens=63, d_model=32, top_k=2, n_experts=8, devices=4)),
    ("moe_all_to_all_words", dict(tokens=8, d_model=32, top_k=1, n_experts=16, devices=2)),
])
def test_mesh_forms_refuse_what_repro_refuses(name, kw):
    with pytest.raises(ValueError):
        getattr(jc, name)(**kw)
    with pytest.raises(ValueError):
        getattr(tc, name)(**kw)


@pytest.mark.parametrize("d", [dict(W_I=3, D_I=1, D_O=1, F=7, S=1, P=1),
                               dict(W_I=8, D_I=0, D_O=1, F=3, S=1, P=1),
                               dict(W_I=8, D_I=1, D_O=1, F=3, S=1, P=-1)])
def test_conv_shape_validation_matches(d):
    with pytest.raises(ValueError):
        jc.ConvShape(**d).validate()
    with pytest.raises(ValueError):
        tc.ConvShape(**d).validate()


def test_shape_errors_match():
    with pytest.raises(ValueError):
        tc.ConvShape(W_I=8, D_I=1, D_O=1, F=3, S=2, P=0).W_O  # (8-3) % 2
    with pytest.raises(ValueError):
        tc.conv_dgrad_shape(tc.ConvShape(W_I=8, D_I=1, D_O=1, F=3, S=1, P=3))
    with pytest.raises(ValueError):
        tc.FCShape(W_I=1, D_I=1, D_O=0, B=1).validate()
    with pytest.raises(ValueError):
        tc.conv_sharded_traffic(CONV, 8, 8, devices=3, strategy="batch", batch=4)
    with pytest.raises(ValueError):
        tc.conv_sharded_traffic(CONV, 8, 8, devices=2, strategy="ring")
    with pytest.raises(ValueError):
        tm.word_bytes("fp8")


@pytest.mark.parametrize("prec", sorted(jm.WORD_BYTES))
def test_word_bytes_match(prec):
    assert tm.word_bytes(prec) == jm.word_bytes(prec)
    assert tm.WORD_BYTES == jm.WORD_BYTES


# ---------------------------------------------------------------------------
# The paper's quoted numbers, through the port
# ---------------------------------------------------------------------------


class TestPaperConvClaims:
    def test_output_width(self):
        assert CONV.W_O == 32  # S=1, P=1, F=3 -> same size

    def test_alg1_ccr_8p9(self):
        """Sec. 2.1.4: CCR ca. 8.9 MAC/word; 4.4 spflop/B; 2.2 dpflop/B."""
        t = tc.alg1_traffic(CONV)
        assert t.ccr == pytest.approx(8.9, abs=0.05)
        assert t.ccr == pytest.approx(tc.alg1_ccr(CONV))
        assert t.flops_per_byte("sp") == pytest.approx(4.4, abs=0.05)
        assert t.flops_per_byte("dp") == pytest.approx(2.2, abs=0.05)

    def test_alg1_ccr_approx_F_squared(self):
        """Eq. (6): CCR ~= F^2 for typical shapes."""
        assert tc.alg1_ccr_approx(CONV) == 9.0
        assert tc.alg1_ccr(CONV) == pytest.approx(9.0, rel=0.02)

    def test_alg1_space(self):
        """Sec. 2.1.2: 2057 words; <8.1 KiB sp, <16.1 KiB dp."""
        words = tc.alg1_space_words(CONV)
        assert words == 2057
        assert words * 4 / 1024 < 8.1
        assert words * 8 / 1024 < 16.1

    def test_alg2_max_stack(self):
        """Sec. 2.2.2: Delta_O <= 24 (sp), <= 12 (dp) for W_O = 32."""
        assert tc.alg2_max_stack(CONV, tm.MANTICORE, "sp") == 24
        assert tc.alg2_max_stack(CONV, tm.MANTICORE, "dp") == 12

    def test_alg2_ccr(self):
        """Sec. 2.2.4: 141.8 MAC/word (70.9 spflop/B) sp; 87.8 (21.9) dp."""
        t_sp = tc.alg2_traffic(CONV, stack=24)
        assert t_sp.ccr == pytest.approx(141.8, abs=0.05)
        assert t_sp.flops_per_byte("sp") == pytest.approx(70.9, abs=0.05)
        t_dp = tc.alg2_traffic(CONV, stack=12)
        assert t_dp.ccr == pytest.approx(87.8, abs=0.05)
        assert t_dp.flops_per_byte("dp") == pytest.approx(21.9, abs=0.05)

    def test_alg2_becomes_compute_bound_on_manticore(self):
        """Sec. 2.2.4: stacking flips Alg 1's memory-bound into compute-bound."""
        assert tc.bound_kind(tc.alg1_traffic(CONV), tm.MANTICORE, "sp") == "memory-bound"
        assert tc.bound_kind(tc.alg2_traffic(CONV, 24), tm.MANTICORE, "sp") == "compute-bound"

    def test_alg3_max_stack(self):
        """Sec. 2.3.2: Delta_O <= 23 (sp), <= 11 (dp)."""
        assert tc.alg3_max_stack(CONV, tm.MANTICORE, "sp") == 23
        assert tc.alg3_max_stack(CONV, tm.MANTICORE, "dp") == 11

    def test_alg3_quoted_ccr(self):
        """Sec. 2.3.4 quoted: 541.4 MAC/word (270.7 spflop/B) sp, 540.6
        (135.2) dp, through the reconstructed (slipped) formula."""
        q_sp = tc.alg3_ccr_offchip_as_quoted(CONV, stack=23)
        assert q_sp == pytest.approx(541.4, abs=0.05)
        assert q_sp * 2 / 4 == pytest.approx(270.7, abs=0.05)
        q_dp = tc.alg3_ccr_offchip_as_quoted(CONV, stack=11)
        assert q_dp == pytest.approx(540.6, abs=0.05)
        assert q_dp * 2 / 8 == pytest.approx(135.2, abs=0.05)

    def test_alg3_eq10_faithful(self):
        """Eq. (10) evaluated faithfully: 460.8 (sp) / 400.7 (dp)."""
        assert tc.alg3_traffic(CONV, stack=23).ccr_offchip == pytest.approx(460.8, abs=0.05)
        assert tc.alg3_traffic(CONV, stack=11).ccr_offchip == pytest.approx(400.67, abs=0.05)

    def test_alg3_overall_ccr_unchanged(self):
        """Sec. 2.3.4: the *overall* CCR equals Alg 2's (same total words)."""
        assert tc.alg3_traffic(CONV, 23).ccr == pytest.approx(tc.alg2_traffic(CONV, 23).ccr)

    def test_alg2_no_extra_macs(self):
        """Sec. 2.2.1: Alg 2 adds no MACs vs Alg 1."""
        assert tc.alg2_traffic(CONV, 24).macs == tc.alg1_traffic(CONV).macs


class TestPaperFCClaims:
    def test_alg4_space(self):
        """Sec. 3.1.2: 132689 words; ~519 KiB sp; ~1037 KiB dp."""
        words = tc.alg4_space_words(FC)
        assert words == 132689
        assert words * 4 / 1024 == pytest.approx(519, abs=1)
        assert words * 8 / 1024 == pytest.approx(1037, abs=1)

    def test_alg4_max_do(self):
        """Sec. 3.1.2: D_O <= 768 (sp), <= 384 (dp) at B = 32, W_I = 7."""
        assert tc.alg45_max_stack(FC, tm.MANTICORE, "sp") == 768
        assert tc.alg45_max_stack(FC, tm.MANTICORE, "dp") == 384

    def test_alg4_ccr(self):
        """Sec. 3.1.4: CCR 30.7 (15.4 spflop/B) sp; 29.5 (7.4 dpflop/B) dp."""
        sp = tc.alg4_ccr(tc.FCShape(W_I=7, D_I=512, D_O=768, B=32))
        assert sp == pytest.approx(30.7, abs=0.05)
        assert sp * 2 / 4 == pytest.approx(15.4, abs=0.05)
        dp = tc.alg4_ccr(tc.FCShape(W_I=7, D_I=512, D_O=384, B=32))
        assert dp == pytest.approx(29.5, abs=0.05)
        assert dp * 2 / 8 == pytest.approx(7.4, abs=0.05)

    def test_alg5_ccr(self):
        """Sec. 3.2.4: CCR 30.6 (sp, Delta=768) / 29.5 (dp, Delta=384)."""
        assert tc.alg5_ccr(FC, stack=768) == pytest.approx(30.6, abs=0.05)
        assert tc.alg5_ccr(FC, stack=384) == pytest.approx(29.5, abs=0.05)

    def test_alg4_tree_reduction_words(self):
        """Sec. 3.1.3: 127 * D_O * B words over 128 clusters."""
        assert tc.alg4_traffic(FC, clusters=128).intercluster == 127 * FC.D_O * FC.B

    def test_alg5_no_extra_macs(self):
        assert tc.alg5_traffic(FC, 768).macs == tc.alg4_traffic(FC).macs


# ---------------------------------------------------------------------------
# Closed forms over drawn shapes (hypothesis, derandomized)
# ---------------------------------------------------------------------------

conv_dicts = st.fixed_dictionaries(dict(
    W_I=st.integers(4, 40), D_I=st.integers(1, 96), D_O=st.integers(1, 96),
    F=st.sampled_from([1, 3, 5, 7]), S=st.just(1), P=st.integers(0, 3),
)).filter(lambda d: d["F"] <= d["W_I"] + 2 * d["P"])
# Alg 3's Eqs. (9)-(10) assume each quadrant cycles whole slices: exact when
# 16 | D_I, so D_I is built as 16 * k (no filter to starve).
alg3_dicts = st.builds(lambda d, k: {**d, "D_I": 16 * k}, conv_dicts, st.integers(1, 6))
fc_dicts = st.fixed_dictionaries(dict(
    W_I=st.integers(1, 12), D_I=st.integers(1, 48), D_O=st.integers(1, 300),
    B=st.integers(1, 48)))


@settings(max_examples=40, **HYP)
@given(conv_dicts, st.integers(1, 32), st.integers(1, 8))
def test_conv_closed_forms_equal_repro_drawn(d, stack, hb):
    j, t = _jconv(d), tc.ConvShape(**d)
    hb = min(hb, j.W_O)
    _assert_same(tc.alg1_traffic(t), jc.alg1_traffic(j))
    _assert_same(tc.alg1_ccr(t), jc.alg1_ccr(j))
    _assert_same(tc.alg2_traffic(t, stack), jc.alg2_traffic(j, stack))
    _assert_same(tc.alg3_traffic(t, stack), jc.alg3_traffic(j, stack))
    _assert_same(tc.alg2_strip_traffic(t, stack, hb), jc.alg2_strip_traffic(j, stack, hb))
    _assert_same(tc.conv_wgrad_traffic(t, stack, hb, 4, 2),
                 jc.conv_wgrad_traffic(j, stack, hb, 4, 2))
    for (jmach, tmach) in MACHINES.values():
        for prec in ("sp", "dp"):
            _assert_same(tc.alg2_max_stack(t, tmach, prec), jc.alg2_max_stack(j, jmach, prec))
            _assert_same(tc.alg3_max_stack(t, tmach, prec), jc.alg3_max_stack(j, jmach, prec))


@settings(max_examples=40, **HYP)
@given(fc_dicts, st.integers(1, 512))
def test_fc_closed_forms_equal_repro_drawn(d, stack):
    j, t = _jfc(d), tc.FCShape(**d)
    _assert_same(tc.alg4_traffic(t), jc.alg4_traffic(j))
    _assert_same(tc.alg5_traffic(t, stack), jc.alg5_traffic(j, stack))
    _assert_same(tc.alg4_ccr(t), jc.alg4_ccr(j))
    _assert_same(tc.alg5_ccr(t, stack), jc.alg5_ccr(j, stack))


@settings(max_examples=30, **HYP)
@given(conv_dicts, st.integers(1, 31))
def test_stacking_monotone_improves_ccr(d, stack):
    """A larger stack never lowers the CCR (Delta_O reuse is monotone)."""
    s = tc.ConvShape(**d)
    assert tc.alg2_traffic(s, stack + 1).ccr >= tc.alg2_traffic(s, stack).ccr - 1e-9


@settings(max_examples=30, **HYP)
@given(conv_dicts)
def test_space_bounds_are_respected(d):
    """The Delta_O chooser's pick fits the budget, and +1 never does."""
    s = tc.ConvShape(**d)
    budget = tm.MANTICORE.usable_for_working_set(2)
    for prec, wb in (("sp", 4), ("dp", 8)):
        cap = tc.alg2_max_stack(s, tm.MANTICORE, prec)
        if cap >= 1:
            assert cap * s.W_O**2 * wb <= budget
        assert (cap + 1) * s.W_O**2 * wb > budget


# ---------------------------------------------------------------------------
# The walkers: port walker == port closed form == repro walker
# ---------------------------------------------------------------------------


def test_every_walker_has_counterpart():
    names = _public(jsim)
    assert set(names) <= set(_public(tsim))
    for name in names:
        assert (list(inspect.signature(getattr(tsim, name)).parameters)
                == list(inspect.signature(getattr(jsim, name)).parameters))


def _walk(name, *args, **kw):
    """(port walker, repro walker) on the same arguments."""
    got = getattr(tsim, name)(*map(_to_port, args), **kw)
    want = getattr(jsim, name)(*args, **kw)
    _assert_same(got, want)
    return got


def _conv_walkers(d, stack, hb):
    j, t = _jconv(d), tc.ConvShape(**d)
    hb = min(hb, j.W_O)
    assert _walk("simulate_alg1", j) == tc.alg1_traffic(t)
    assert _walk("simulate_alg2", j, stack) == tc.alg2_traffic(t, stack)
    assert _walk("simulate_alg2_strip", j, stack, hb) == tc.alg2_strip_traffic(t, stack, hb)
    assert (_walk("simulate_conv_wgrad", j, stack, hb, di_block=4, batch=2)
            == tc.conv_wgrad_traffic(t, stack, hb, 4, 2))
    if j.P <= j.F - 1:
        assert (_walk("simulate_conv_dgrad", j, stack, hb, batch=2)
                == tc.conv_dgrad_traffic(t, stack, hb, batch=2))
    assert (_walk("simulate_sharded_conv_strip", j, stack, hb, devices=2, strategy="batch",
                  batch=2) == tc.conv_sharded_traffic(t, stack, hb, devices=2, batch=2))
    assert _walk("n_stacks", j.D_O, stack) == -(-j.D_O // stack)


@pytest.mark.parametrize("d", CONV_SHAPES, ids=[str(i) for i in range(len(CONV_SHAPES))])
@pytest.mark.parametrize("stack,hb", [(1, 1), (24, 8), (64, 32)])
def test_conv_walkers(d, stack, hb):
    _conv_walkers(d, stack, hb)


@settings(max_examples=25, **HYP)
@given(conv_dicts, st.integers(1, 32), st.integers(1, 8))
def test_conv_walkers_drawn(d, stack, hb):
    _conv_walkers(d, stack, hb)


@pytest.mark.parametrize("d", [CONV_SHAPES[0], CONV_SHAPES[1], CONV_SHAPES[5]],
                         ids=["example", "conv1", "1x1"])
@pytest.mark.parametrize("stack,group", [(23, 16), (11, 16), (8, 4)])
def test_alg3_walker(d, stack, group):
    j = _jconv(d)
    assert _walk("simulate_alg3", j, stack, group) == tc.alg3_traffic(_to_port(j), stack, group)


@settings(max_examples=25, **HYP)
@given(alg3_dicts, st.integers(1, 32))
def test_alg3_walker_drawn(d, stack):
    j = _jconv(d)
    assert _walk("simulate_alg3", j, stack) == tc.alg3_traffic(_to_port(j), stack)


@pytest.mark.parametrize("d", FC_SHAPES[:1] + FC_SHAPES[3:], ids=["fc6", "small"])
@pytest.mark.parametrize("stack,clusters", [(768, 128), (384, 128), (5, 16)])
def test_fc_walkers(d, stack, clusters):
    j = _jfc(d)
    t = _to_port(j)
    assert _walk("simulate_alg4", j, clusters) == tc.alg4_traffic(t, clusters)
    assert _walk("simulate_alg5", j, stack, clusters) == tc.alg5_traffic(t, stack, clusters)


@settings(max_examples=25, **HYP)
@given(fc_dicts, st.integers(1, 512))
def test_fc_walkers_drawn(d, stack):
    j = _jfc(d)
    t = _to_port(j)
    assert _walk("simulate_alg4", j) == tc.alg4_traffic(t)
    got = _walk("simulate_alg5", j, stack)
    assert got == tc.alg5_traffic(t, stack)
    assert got.macs / got.main_loads == pytest.approx(tc.alg5_ccr(t, stack), rel=REL)


@pytest.mark.parametrize("m,n,k,bm,bn,bk", [(256, 4096, 2048, 64, 128, 32),
                                            (37, 77, 300, 8, 16, 16), (8, 8, 8, 8, 8, 8)])
def test_matmul_walker(m, n, k, bm, bn, bk):
    got = _walk("simulate_matmul_blocks", m, n, k, bm, bn, bk)
    assert got == tc.matmul_block_traffic(m=m, n=n, k=k, block_m=bm, block_n=bn, block_k=bk)


@pytest.mark.parametrize("pool,batch", [(1, 1), (2, 2)])
@pytest.mark.parametrize("geom", [dict(H_O=16, W_O=16, F=3, S=1, d_in=8, d_out=16),
                                  dict(H_O=9, W_O=9, F=5, S=2, d_in=5, d_out=13)])
def test_im2col_and_scatter_walkers(geom, pool, batch):
    kw = dict(geom, block_h=4, block_m=16, block_n=16, block_k=16, pool=pool, batch=batch)
    assert _walk("simulate_conv_im2col", **kw) == tc.conv_im2col_traffic(**kw)
    if geom["H_O"] % pool == 0:  # the fused epilogue's contract: the pool tiles the plane
        sc = dict(H_O=geom["H_O"], W_O=geom["W_O"], d_out=geom["d_out"], pool=pool,
                  batch=batch)
        assert _walk("simulate_epilogue_scatter", **sc) == tc.epilogue_scatter_traffic(**sc)


@pytest.mark.parametrize("devices", [1, 2, 4, 8])
def test_mesh_walkers(devices):
    mm = dict(m=8, n=64, k=128, devices=devices)
    blocks = dict(block_m=8, block_n=8, block_k=8)
    assert _walk("simulate_ring", **mm) == tc.ring_traffic(**mm)
    assert _walk("simulate_fc_psum", **mm, **blocks) == tc.fc_psum_traffic(**mm, **blocks)
    assert _walk("simulate_tp_matmul", **mm, **blocks) == tc.tp_matmul_traffic(**mm, **blocks)
    moe = dict(tokens=64, d_model=32, top_k=2, n_experts=8, devices=devices)
    assert _walk("simulate_moe_all_to_all", **moe) == tc.moe_all_to_all_words(**moe)
    j = _jconv(CONV_SHAPES[1])
    assert (_walk("simulate_sharded_conv_strip", j, 16, 4, devices=devices, strategy="stack",
                  batch=2) == tc.conv_sharded_traffic(_to_port(j), 16, 4, devices=devices,
                                                      strategy="stack", batch=2))


@pytest.mark.parametrize("grid", [(), (3,), (2, 5, 7)])
def test_step_walkers(grid):
    assert _walk("simulate_grid_steps", grid) == tc.grid_steps(grid)
    dg = dict(H_I=16, d_in=24, block_h=4, block_do=8, batch=len(grid) + 1)
    assert _walk("simulate_conv_dgrad_fused_steps", **dg) == tc.conv_dgrad_fused_steps(**dg)
    for pipelined in (False, True):
        wg = dict(H_O=16, d_in=24, d_out=40, block_h=4, block_di=8, block_do=16,
                  batch=len(grid) + 1, pipelined=pipelined)
        assert _walk("simulate_conv_wgrad_steps", **wg) == tc.conv_wgrad_steps(**wg)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 64),
                                           (False, 33)])
def test_attention_walker_equals_the_port_planner(causal, window):
    """The attention walker's closed form is the AttentionPlanner's model."""
    kw = dict(seq_q=120, seq_kv=200, head_dim=32, n_q_heads=2, n_kv_heads=1, batch=2)
    sched = AttentionPlanner(tm.TPU_V5E).plan(**kw, in_bytes=4, block_q=32, block_kv=48,
                                              causal=causal, window=window)
    got = _walk("simulate_attention_blocks", **kw, block_q=sched.block("block_q"),
                block_kv=sched.block("block_kv"), causal=causal, window=window)
    assert (got.main_loads, got.main_stores, got.macs) == (sched.loads, sched.stores, sched.macs)
