"""The MoE expert FFN's mesh partitions, against the JAX package's planner.

``MoeFfnPlanner._shard_candidates`` offers ``repro``'s "batch" (tokens
sharded, every device streams every expert) and "ep" (experts sharded, the
routed rows an all-to-all of ``ccr.moe_all_to_all_words``) under its
conditions.  Held field for field against ``repro`` on MANTICORE and
TPU_V5E, on the paper's 16-cluster quadrant, on (2, 4) meshes over either
axis and on 2- and 4-device model axes: the candidates, every strategy pin
and the unpinned argmin, ``candidates()``, and the block planner's MoE cell
(``TransformerBlockPlanner`` with ``n_experts``).  Ports the "ep" cases of
``tests/test_transformer_plan.py`` (the quadrant's words pinned), holds the
"ep" words against the dispatch walker ``schedule_sim.simulate_moe_all_to_all``,
and on the H100 keeps only fitting candidates (an empty list is a
``PlanRejected``; no MoE cell raises ``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses

import pytest

from repro.core import machine as jm
from repro.plan import planners as jp
from repro.plan import sharded as js
from repro_torch.core import ccr
from repro_torch.core import machine as tm
from repro_torch.core import schedule_sim as sim
from repro_torch.plan import planners as tp
from repro_torch.plan import sharded as ts

QUAD16 = (("cluster", 16),)
MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]
MACHINE_IDS = ["manticore", "tpu_v5e"]
MESHES = [(QUAD16, "cluster"), ((("model", 2),), "model"), ((("model", 4),), "model"),
          ((("data", 2), ("model", 4)), "model"), ((("data", 2), ("model", 4)), "data")]
MESH_IDS = ["quad16", "2", "4", "2x4-model", "2x4-data"]
MOE = dict(tokens=4096, d_model=512, d_ff=2048, n_experts=16, top_k=2, in_bytes=4)
SHAPES = [MOE,
          dict(tokens=512, d_model=256, d_ff=256, n_experts=8, top_k=2, in_bytes=4),
          dict(tokens=64, d_model=128, d_ff=256, n_experts=4, top_k=2, in_bytes=4,
               capacity_factor=1.25),
          dict(tokens=6, d_model=32, d_ff=64, n_experts=3, top_k=1, in_bytes=4)]
SHAPE_IDS = ["quadrant", "e8", "smoke", "odd"]
PINS = [None, "single", "batch", "ep"]


def _pair(machines, mesh, axis, strategy=None):
    jmach, tmach = machines
    return (jp.MoeFfnPlanner(jmach, js.MeshSpec(mesh), axis, strategy),
            tp.MoeFfnPlanner(tmach, ts.MeshSpec(mesh), axis, strategy))


def _outcome(fn):
    try:
        return fn(), None
    except ValueError as e:
        return None, type(e)


def _same(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hbm_words, got.ici_words, got.devices, got.modeled_words) == (
        want.hbm_words, want.ici_words, want.devices, want.modeled_words)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("mesh,axis", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_moe_partitions_equal_repro(machines, mesh, axis, shape):
    """The candidates, every pin, the argmin and ``candidates()``."""
    jpl, tpl = _pair(machines, mesh, axis)
    group = tpl.shard_group
    assert group == jpl.shard_group
    assert ([dataclasses.asdict(c) for c in tpl._shard_candidates(group, **shape)]
            == [dataclasses.asdict(c) for c in jpl._shard_candidates(group, **shape)])
    for pin in PINS:
        jpl, tpl = _pair(machines, mesh, axis, pin)
        want, jerr = _outcome(lambda: jpl.plan(**shape))
        got, terr = _outcome(lambda: tpl.plan(**shape))
        assert (terr is None) == (jerr is None), (pin, jerr, terr)
        if want is not None:
            _same(got, want)
    jpl, tpl = _pair(machines, mesh, axis)
    wc, gc = jpl.candidates(**shape), tpl.candidates(**shape)
    assert len(gc) == len(wc)
    for g, w in zip(gc, wc):
        _same(g, w)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=SHAPE_IDS[:3])
@pytest.mark.parametrize("mesh,axis", [(QUAD16, "cluster"),
                                       ((("data", 2), ("model", 4)), "model")],
                         ids=["quad16", "2x4"])
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_block_planner_moe_cell_equals_repro(machines, mesh, axis, shape):
    """The block planner's cells with experts, on a mesh: the MoE cell at
    ``tokens = batch x seq`` among the delegated ones."""
    block = dict(batch=2, seq=shape["tokens"] // 2, d_model=shape["d_model"], n_heads=4,
                 d_ff=shape["d_ff"], vocab=512, n_experts=shape["n_experts"],
                 top_k=shape["top_k"], capacity_factor=shape.get("capacity_factor", 1.0),
                 in_bytes=4)
    jmach, tmach = machines
    want = jp.TransformerBlockPlanner(jmach, js.MeshSpec(mesh), axis).plan(**block)
    got = tp.TransformerBlockPlanner(tmach, ts.MeshSpec(mesh), axis).plan(**block)
    assert list(got) == list(want) and "moe" in got and "mlp_up" not in got
    for cell in want:
        _same(got[cell], want[cell])


def test_quadrant_ep_vs_batch_words():
    """``tests/test_transformer_plan.py``'s ep-vs-batch case: ep streams
    each expert's FFN weights once and pays the all-to-all; batch
    re-streams all 16 experts on every cluster's token shard."""
    mo = tp.MoeFfnPlanner(tm.MANTICORE, ts.MeshSpec(QUAD16), "cluster")
    by = {c.strategy: c for c in mo.candidates(**MOE)}
    assert by["ep"].modeled_words == 428212224
    assert (by["ep"].hbm_words, by["ep"].ici_words) == (420347904, 7864320)
    assert by["batch"].modeled_words == 622854144
    assert mo.plan(**MOE).strategy == "ep"
    assert by["ep"].partition == (("cluster", None), ("cluster", None, None),
                                  ("cluster", None))


@pytest.mark.parametrize("devices", [2, 4, 16])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=SHAPE_IDS[:3])
def test_ep_words_equal_the_dispatch_walker(shape, devices):
    mo = tp.MoeFfnPlanner(tm.MANTICORE, ts.MeshSpec((("model", devices),)), "model")
    eps = [c for c in mo._shard_candidates(devices, **shape) if c.strategy == "ep"]
    kw = {k: shape[k] for k in ("tokens", "d_model", "top_k", "n_experts")}
    walk = _outcome(lambda: sim.simulate_moe_all_to_all(devices=devices, **kw))[0]
    if not eps:  # ep needs tokens, experts and the local routed rows to divide
        assert _outcome(lambda: ccr.moe_all_to_all_words(devices=devices, **kw))[0] is None
        return
    assert eps[0].ici_words == walk == ccr.moe_all_to_all_words(devices=devices, **kw)


@pytest.mark.parametrize("mesh,axis", MESHES, ids=MESH_IDS)
def test_h100_keeps_fitting_candidates_and_never_raises_not_implemented(mesh, axis):
    mo = tp.MoeFfnPlanner(tm.H100, ts.MeshSpec(mesh), axis)
    for shape in SHAPES:
        cands = mo.candidates(**shape)
        assert cands and all(c.fits(tm.H100) for c in cands)
        assert mo.plan(**shape).devices == mo.shard_group
    with pytest.raises(tp.PlanRejected):
        mo.candidates(**dict(MOE, d_model=8192, d_ff=8192, block_n=8192))
