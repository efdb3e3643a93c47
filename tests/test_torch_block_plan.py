"""The transformer block planner as a planner, against the JAX package's:
``TransformerBlockPlanner`` is a ``ShardablePlanner`` with ``op =
"transformer_block"``, ``plan`` and ``candidates`` (dicts by cell), and a
``strategy=`` pin passed through to its cells; ``PLANNERS`` lists it, so
``planner_for("transformer_block")`` works; ``Planner`` is the protocol.

Ports ``tests/test_transformer_plan.py``'s ``TestBlockPlannerDelegation``
and ``test_block_planner_quadrant_picks`` and holds each result against
``repro``'s field for field (words exact) on MANTICORE and TPU_V5E, on one
device and on the paper's 16-cluster quadrant ``MeshSpec((("cluster",
16),))``, the MoE cell on a mesh included (its "batch"/"ep" partitions;
on the H100 a cell with no fitting candidate is a ``PlanRejected``); the
launched head dim (``head_dim=``) stays.
"""

from __future__ import annotations

import dataclasses

import pytest

from repro.core import machine as jm
from repro.plan import planners as jp
from repro.plan import sharded as js
from repro_torch.core import machine as tm
from repro_torch.plan import planners as tp
from repro_torch.plan import sharded as ts

QUAD = (("cluster", 16),)
MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]
MACHINE_IDS = ["manticore", "tpu_v5e"]
SHAPE = dict(batch=2, seq=64, d_model=128, n_heads=4, d_ff=256, in_bytes=4)
QUAD_SHAPE = dict(batch=4, seq=128, d_model=256, n_heads=8, d_ff=1024, vocab=1024,
                  in_bytes=4)
SHAPES = [SHAPE, QUAD_SHAPE, dict(SHAPE, n_kv_heads=2, vocab=512)]


def _fields(s):
    return dataclasses.asdict(s)


def _pair(machines, mesh=None, axis="model", strategy=None):
    jmach, tmach = machines
    return (jp.TransformerBlockPlanner(jmach, None if mesh is None else js.MeshSpec(mesh),
                                       axis, strategy),
            tp.TransformerBlockPlanner(tmach, None if mesh is None else ts.MeshSpec(mesh),
                                       axis, strategy))


@pytest.mark.parametrize("shape", SHAPES, ids=["small", "quad", "gqa"])
@pytest.mark.parametrize("mesh,axis", [(None, "model"), (QUAD, "cluster")],
                         ids=["local", "quad16"])
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_block_plan_and_candidates_equal_repro(machines, mesh, axis, shape):
    jpl, tpl = _pair(machines, mesh, axis)
    want, got = jpl.plan(**shape), tpl.plan(**shape)
    assert list(got) == list(want)
    for cell in want:
        assert _fields(got[cell]) == _fields(want[cell]), cell
    wc, gc = jpl.candidates(**shape), tpl.candidates(**shape)
    assert list(gc) == list(wc)
    for cell in wc:
        assert [_fields(c) for c in gc[cell]] == [_fields(c) for c in wc[cell]], cell


def _outcome(fn):
    try:
        return fn(), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("strategy", ["batch", "ring", "psum", "tp"])
def test_strategy_pin_passes_through_to_the_cells(strategy):
    """A pin binds every cell's planner; a cell with no such partition
    refuses it as ``repro``'s does, word for word."""
    jpl, tpl = _pair(MACHINES[0], QUAD, "cluster", strategy)
    cells = tpl.cell_planners(**SHAPE)
    assert {planner.strategy for planner, _ in cells.values()} == {strategy}
    assert _outcome(lambda: tpl.plan(**SHAPE))[1] == _outcome(lambda: jpl.plan(**SHAPE))[1]
    jcells = jpl.cell_planners(**SHAPE)
    for cell, (planner, kw) in cells.items():
        got, gerr = _outcome(lambda: planner.plan(**kw))
        want, werr = _outcome(lambda: jcells[cell][0].plan(**jcells[cell][1]))
        assert gerr == werr, cell
        if want is not None:
            assert got.strategy == want.strategy == strategy
            assert _fields(got) == _fields(want), cell


def test_block_planner_quadrant_picks():
    """The whole block's per-cell joint algorithm-and-partitioning argmin
    on the quadrant, pinned with its word counts (``repro``'s numbers)."""
    tb = tp.TransformerBlockPlanner(tm.MANTICORE, ts.MeshSpec(QUAD), "cluster")
    plans = tb.plan(**QUAD_SHAPE)
    picks = {name: (getattr(s, "strategy", None), s.modeled_words)
             for name, s in plans.items()}
    assert picks == {
        "qkv": ("ring", 2686976),
        "attn": ("single", 8388608),
        "wo": ("batch", 1310720),
        "mlp_up": ("ring", 3670016),
        "mlp_down": ("batch", 4849664),
        "logits": ("ring", 2883584),
    }


class TestBlockPlannerDelegation:
    """The compound planner delegates exactly as Im2colConvPlanner does
    its GEMM core: each cell is its sub-planner's own plan."""

    def test_cells_match_delegated_planners(self):
        tb = tp.TransformerBlockPlanner(tm.MANTICORE)
        plans = tb.plan(**SHAPE)
        assert set(plans) == {"qkv", "attn", "wo", "mlp_up", "mlp_down"}
        mm = tp.MatmulPlanner(tm.MANTICORE)
        m = 2 * 64
        assert plans["qkv"] == mm.plan(m=m, n=3 * 128, k=128, in_bytes=4)
        assert plans["mlp_up"] == mm.plan(m=m, n=2 * 256, k=128, in_bytes=4)
        assert plans["attn"].op == "flash_attention"

    def test_moe_replaces_mlp_cells(self):
        for mod, mach in ((tp, tm.MANTICORE), (jp, jm.MANTICORE)):
            plans = mod.TransformerBlockPlanner(mach).plan(**SHAPE, n_experts=8, top_k=2)
            assert "moe" in plans and "mlp_up" not in plans
            assert plans["moe"].op == "moe_ffn"

    def test_candidates_are_per_cell(self):
        tb = tp.TransformerBlockPlanner(tm.MANTICORE, ts.MeshSpec(QUAD), "cluster")
        cands = tb.candidates(**SHAPE)
        assert set(cands) == {"qkv", "attn", "wo", "mlp_up", "mlp_down"}
        strategies = {c.strategy for c in cands["qkv"]}
        assert {"tp", "batch"} <= strategies

    def test_moe_cell_on_a_mesh_raises(self):
        """The MoE cell on a mesh plans its partitions, equal to the JAX
        package's; on the H100 only an unfit cell raises, and then
        ``PlanRejected``, never ``NotImplementedError``."""
        got = tp.TransformerBlockPlanner(tm.MANTICORE, ts.MeshSpec(QUAD), "cluster").plan(
            **SHAPE, n_experts=8, top_k=2)
        want = jp.TransformerBlockPlanner(jm.MANTICORE, js.MeshSpec(QUAD), "cluster").plan(
            **SHAPE, n_experts=8, top_k=2)
        assert got["moe"].strategy == want["moe"].strategy
        assert got["moe"].modeled_words == want["moe"].modeled_words
        h100 = tp.TransformerBlockPlanner(tm.H100, ts.MeshSpec(QUAD), "cluster")
        assert h100.plan(**SHAPE, n_experts=8, top_k=2)["moe"].devices == 16
        with pytest.raises(tp.PlanRejected):
            tp.MoeFfnPlanner(tm.H100, ts.MeshSpec(QUAD), "cluster").candidates(
                tokens=64, d_model=8192, d_ff=8192, n_experts=16, top_k=2, block_n=8192)


@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_planner_for_transformer_block(machines):
    jmach, tmach = machines
    got = tp.planner_for("transformer_block", tmach, QUAD, "cluster")
    want = jp.planner_for("transformer_block", jmach, QUAD, "cluster")
    assert isinstance(got, tp.TransformerBlockPlanner) and isinstance(got, tp.Planner)
    assert got.op == want.op == "transformer_block"
    assert (got.mesh.axes, got.shard_axis) == (want.mesh.axes, want.shard_axis)
    assert sorted(tp.PLANNERS) == sorted(jp.PLANNERS)
    assert {k: v.op for k, v in tp.PLANNERS.items()} == {k: v.op for k, v in jp.PLANNERS.items()}
    for name, cls in tp.PLANNERS.items():
        assert isinstance(cls(tmach), tp.Planner), name


def test_head_dim_stays_and_none_equals_repro():
    """``head_dim=`` plans the launched head dim; without it the cells
    equal ``repro``'s field for field."""
    tb = tp.TransformerBlockPlanner(tm.TPU_V5E)
    jb = jp.TransformerBlockPlanner(jm.TPU_V5E)
    plain, want = tb.plan(**SHAPE), jb.plan(**SHAPE)
    for cell in want:
        assert _fields(plain[cell]) == _fields(want[cell])
    named = tb.plan(**SHAPE, head_dim=64)
    assert named["attn"] != plain["attn"]
    assert named["qkv"].macs == 2 * plain["qkv"].macs  # (4 + 2 * 4) heads of 64, not 32
