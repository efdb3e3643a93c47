"""The port's mesh planning against the JAX package's, in process.

``MeshSpec`` is device-free in both packages, so every mesh-aware pick is
held field for field against ``repro``'s on MANTICORE and TPU_V5E without a
process group: each planner's ``_shard_candidates``, ``plan_sharded`` under
every pin and ``candidates()`` over meshes of 1, 2, 4 and (2, 4) devices;
``cnn.plan_training(mesh=...)`` entry for entry (``hbm_words`` and
``ici_words`` included); ``partition_specs``, ``validate_sharded_plan``,
``MeshSpec.shrink_to``/``with_axis`` and ``production_mesh_spec``; the
spec functions of ``runtime/parallel.py`` against ``repro``'s
``ParallelCtx`` on a stub mesh; the launcher's ``parse_mesh`` and its
refusals.
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import numpy as np
import pytest

from repro.configs import registry as jcfg
from repro.core import machine as jm
from repro.launch import mesh as jmesh
from repro.launch import train as jlaunch
from repro.models import cnn as jcnn
from repro.plan import planners as jp
from repro.plan import sharded as js
from repro.runtime import parallel as jpar
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import machine as tm
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.models import cnn as tcnn
from repro_torch.plan import planners as tp
from repro_torch.plan import sharded as ts
from repro_torch.runtime import parallel as tpar
from repro_torch.runtime.collectives import Mesh

MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]
MACHINE_IDS = ["manticore", "tpu_v5e"]
MESHES = [((("model", 1),), "model"), ((("model", 2),), "model"),
          ((("model", 4),), "model"), ((("data", 2), ("model", 4)), "model"),
          ((("data", 2), ("model", 4)), "data")]
MESH_IDS = ["1", "2", "4", "2x4-model", "2x4-data"]

CONV = [dict(H_O=32, W_O=32, F=3, S=1, d_in=3, d_out=64, in_bytes=4, pool=2, batch=256,
             padding=1, H_I=32, W_I=32),
        dict(H_O=8, W_O=8, F=3, S=1, d_in=128, d_out=256, in_bytes=4, pool=2, batch=8,
             padding=1, H_I=8, W_I=8),
        dict(H_O=9, W_O=9, F=3, S=2, d_in=5, d_out=14, in_bytes=4, batch=6, padding=1,
             H_I=17, W_I=17)]
WGRAD = [dict(H_O=32, W_O=32, F=3, S=1, d_in=3, d_out=64, in_bytes=4, batch=256,
              padding=1, H_I=32, W_I=32),
         dict(H_O=8, W_O=8, F=3, S=1, d_in=128, d_out=256, in_bytes=4, batch=8,
              padding=1, H_I=8, W_I=8)]
DGRAD = [dict(H_O=16, W_O=16, F=3, S=1, P=1, d_in=64, d_out=128, in_bytes=4, batch=256,
              H_I=16, W_I=16, pool=2),
         dict(H_O=8, W_O=8, F=3, S=1, P=1, d_in=128, d_out=256, in_bytes=4, batch=6,
              H_I=8, W_I=8)]
MM = [dict(m=256, n=4096, k=2048, in_bytes=4), dict(m=256, n=1000, k=4096, in_bytes=4),
      dict(m=8, n=40, k=64, in_bytes=4), dict(m=6, n=10, k=12, in_bytes=2)]
DX = [dict(s, algorithm="fused_dxdw") for s in MM[:2]] + MM
OPS = {"conv2d": CONV, "conv2d_im2col": CONV[:2], "conv2d_dgrad": DGRAD,
       "conv2d_wgrad": WGRAD, "matmul": MM, "matmul_dx": DX, "matmul_dw": MM}


def _same(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _planners(op, machines, mesh, axis, strategy=None):
    jmach, tmach = machines
    return (jp.planner_for(op, jmach, js.MeshSpec(mesh), axis, strategy),
            tp.planner_for(op, tmach, ts.MeshSpec(mesh), axis, strategy))


def _outcome(fn):
    try:
        return fn(), None
    except ValueError as e:
        return None, type(e)


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("mesh,axis", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_sharded_picks_equal_repro(machines, mesh, axis, op):
    """_shard_candidates, plan_sharded under every pin and the unpinned
    argmin, and candidates(), field for field."""
    for shape in OPS[op]:
        jpl, tpl = _planners(op, machines, mesh, axis)
        group = tpl.shard_group
        assert group == jpl.shard_group
        jc = jpl._shard_candidates(group, **shape)
        tc = tpl._shard_candidates(group, **shape)
        assert [dataclasses.asdict(c) for c in tc] == [dataclasses.asdict(c) for c in jc]
        for pin in [None, "single", "batch", "stack", "psum", "ring", "tp"]:
            jpl, tpl = _planners(op, machines, mesh, axis, pin)
            want, jerr = _outcome(lambda: jpl.plan(**shape))
            got, terr = _outcome(lambda: tpl.plan(**shape))
            assert (terr is None) == (jerr is None), (pin, shape, jerr, terr)
            if want is not None:
                assert isinstance(got, ts.ShardedSchedule)
                _same(got, want)
                assert (got.hbm_words, got.ici_words, got.devices) == (
                    want.hbm_words, want.ici_words, want.devices)
                assert dataclasses.asdict(got.traffic) == dataclasses.asdict(want.traffic)
                assert ts.partition_specs(got) == tuple(
                    tuple(s) for s in js.partition_specs(want))
        jpl, tpl = _planners(op, machines, mesh, axis)
        for g, w in zip(tpl.candidates(**shape), jpl.candidates(**shape), strict=True):
            _same(g, w)


def _trees_equal(port: dict, ref: dict):
    assert list(port) == list(ref)
    for k in ref:
        _same(port[k], ref[k])


@pytest.mark.parametrize("batch,smoke", [(256, False), (8, True)], ids=["vgg11", "smoke"])
@pytest.mark.parametrize("mesh,axis", [((("data", 2),), "data"),
                                       ((("data", 4), ("model", 2)), "data"),
                                       ((("data", 2), ("model", 4)), "model"),
                                       ((("data", 1), ("model", 2)), "data")],
                         ids=["2", "4x2", "2x4-model", "1x2"])
@pytest.mark.parametrize("machines", MACHINES, ids=MACHINE_IDS)
def test_cnn_plan_training_on_a_mesh_equals_repro(machines, mesh, axis, batch, smoke):
    jmach, tmach = machines
    name = "cnn-vgg11"
    jc = jcfg.smoke_config(name) if smoke else jcfg.get_config(name)
    tc = smoke_config(name) if smoke else get_config(name)
    want = jcnn.plan_training(jc, batch, machine=jmach, mesh=js.MeshSpec(mesh),
                              shard_axis=axis)
    got = tcnn.plan_training(tc, batch, machine=tmach, mesh=ts.MeshSpec(mesh),
                             shard_axis=axis)
    _trees_equal(got, want)
    for k in want:
        assert (got[k].hbm_words, got[k].ici_words) == (want[k].hbm_words,
                                                        want[k].ici_words)
    assert ts.validate_sharded_plan(got, ts.MeshSpec(mesh)) == js.validate_sharded_plan(
        want, js.MeshSpec(mesh))


def test_data_parallel_plan_pins_batch_on_every_stage():
    """The plan the data-parallel step runs: every stage's "batch"
    partition, its local schedules the meshless plan at the shard's batch,
    its ici_words the wgrad/dW all-reduce alone."""
    cfg = get_config("cnn-vgg11")
    ms = ts.MeshSpec((("data", 2), ("model", 1)))
    got = tcnn.plan_training(cfg, 256, mesh=ms, shard_axis="data", shard_strategy="batch")
    local = tcnn.plan_training(cfg, 128)
    assert list(got) == list(local)
    for k, s in got.items():
        assert s.strategy == "batch" and s.schedule == local[k], k
        assert (s.ici_words > 0) == (k.endswith(".wgrad") or k.endswith(".dw")), k
    assert ts.validate_sharded_plan(got, ms, tm.H100) == len(got)


def test_validate_sharded_plan_rejects_what_repro_rejects():
    ms = ((("data", 2),), "data")
    jplan = jcnn.plan_training(jcfg.smoke_config("cnn-vgg11"), 8, machine=jm.TPU_V5E,
                               mesh=js.MeshSpec(ms[0]), shard_axis="data")
    tplan = tcnn.plan_training(smoke_config("cnn-vgg11"), 8, machine=tm.TPU_V5E,
                               mesh=ts.MeshSpec(ms[0]), shard_axis="data")
    cases = [
        lambda p, S: ({**p, "qkv": next(iter(p.values()))}, S((("data", 2),))),  # mixed
        lambda p, S: ({**p, "conv0": next(iter(p.values())).schedule}, S((("data", 2),))),
        lambda p, S: (p, S((("data", 4),))),  # stale mesh
        lambda p, S: (p, S((("data", 2), ("model", 1)))),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            js.validate_sharded_plan(*case(jplan, js.MeshSpec))
        with pytest.raises(ValueError):
            ts.validate_sharded_plan(*case(tplan, ts.MeshSpec))
    unfit = {"fc1": dataclasses.replace(
        tplan["fc1"], schedule=dataclasses.replace(tplan["fc1"].schedule,
                                                   vmem_bytes=10**9))}
    with pytest.raises(ValueError, match="exceeds"):
        ts.validate_sharded_plan(unfit, ts.MeshSpec(ms[0]), tm.TPU_V5E)


@pytest.mark.parametrize("axes", [(("data", 16), ("model", 16)),
                                  (("pod", 2), ("data", 16), ("model", 16)),
                                  (("data", 6), ("model", 4)), (("data", 3),)])
def test_mesh_spec_shrink_and_resize_equal_repro(axes):
    jms, tms = js.MeshSpec(axes), ts.MeshSpec(axes)
    for n in range(0, 2 * tms.devices + 1):
        for preserve in [("model",), (), ("data",)]:
            want, jerr = _outcome(lambda: jms.shrink_to(n, preserve))
            got, terr = _outcome(lambda: tms.shrink_to(n, preserve))
            assert (jerr is None) == (terr is None), (n, preserve)
            if want is not None:
                assert got.axes == want.axes
    for name, _ in axes:
        assert tms.with_axis(name, 5).axes == jms.with_axis(name, 5).axes
    with pytest.raises(KeyError):
        tms.with_axis("nope", 2)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_spec_equals_repro(multi_pod):
    assert tmesh.production_mesh_spec(multi_pod=multi_pod).axes == (
        jmesh.production_mesh_spec(multi_pod=multi_pod).axes)
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_production_mesh(multi_pod=multi_pod)  # one process, no group


def test_mesh_spec_of_a_live_mesh():
    mesh = Mesh((1, 1), ("data", "model"))
    assert ts.mesh_spec(mesh) == ts.MeshSpec((("data", 1), ("model", 1)))
    assert mesh.axis_index("model") == 0 and mesh.group("data") is None
    assert ts.mesh_spec({"data": 2}) == ts.mesh_spec([("data", 2)])
    with pytest.raises(RuntimeError, match="process group"):
        Mesh((2,), ("data",))


class _Stub:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


STUBS = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
         {"data": 2, "model": 4}, {"data": 1, "model": 8}]


@pytest.mark.parametrize("shape", STUBS, ids=lambda s: "x".join(map(str, s.values())))
def test_parallel_specs_equal_repro(shape):
    mesh = _Stub(shape)
    dp = ("pod", "data") if "pod" in shape else ("data",)
    jctx = jpar.ParallelCtx(mesh=mesh, dp_axes=dp)
    tctx = tpar.ParallelCtx(mesh=mesh, dp_axes=dp)
    assert (tctx.dp_size, tctx.tp_size) == (jctx.dp_size, jctx.tp_size)
    assert tctx.plan_mesh().axes == jctx.plan_mesh().axes
    for b in (1, 2, 3, 8, 32, 64, 256):
        assert tctx.batch_axes(b) == jctx.batch_axes(b)
        assert tctx.spare_dp_axes(b) == jctx.spare_dp_axes(b)
        for nd in (1, 2, 4):
            assert tpar.batch_spec(tctx, b, nd) == tuple(jpar.batch_spec(jctx, b, nd))
        for cache in [(4, b, 2048, 8, 128), (4, b, 64, 2, 80), (2, b, 1, 16, 64)]:
            assert tpar.kv_cache_spec(tctx, cache) == tuple(jpar.kv_cache_spec(jctx, cache))
        for st in [(4, b, 32, 64, 16), (3, b, 7), (2, b, 48, 5)]:
            assert tpar.state_spec(tctx, st) == tuple(jpar.state_spec(jctx, st))
        tree = {"k": np.zeros((2, b, 64, 4, 16)), "h": {"s": np.zeros((2, b, 4, 16, 64)),
                                                          "c": np.zeros((2, b, 3, 32))}}
        want = jpar.cache_specs(jctx, tree)
        got = tpar.cache_specs(tctx, tree)
        assert jax.tree_util.tree_map(tuple, want, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)) == got
    for sizes, n in [([(0, 8), (1, 3)], 4), ([(0, 3), (2, 12)], 4), ([(1, 2)], 4)]:
        assert tpar.first_divisible(sizes, n) == jpar.first_divisible(sizes, n)


def test_data_axis_takes_one_data_axis():
    assert tpar.data_axis(tpar.ParallelCtx(_Stub({"data": 4, "model": 2}))) == "data"
    one = tpar.ParallelCtx(_Stub({"pod": 1, "data": 1, "model": 2}), dp_axes=("pod", "data"))
    assert tpar.data_axis(one) == "data"
    two = tpar.ParallelCtx(_Stub({"pod": 2, "data": 2, "model": 1}), dp_axes=("pod", "data"))
    with pytest.raises(NotImplementedError, match="5b"):
        tpar.data_axis(two)


@pytest.mark.parametrize("spec", ["1x1", "2x4", "16x16", "2x16x16", "4", "1x2x3x4"])
def test_parse_mesh_equals_repro(spec):
    want, jerr = _outcome(lambda: jlaunch.parse_mesh(spec))
    got, terr = _outcome(lambda: tlaunch.parse_mesh(spec))
    assert got == want and terr == jerr


def test_launcher_mesh_for_a_token_family_raises():
    with pytest.raises(NotImplementedError, match="5b"):
        tlaunch.main(["--family", "transformer", "--device", "cpu", "--steps", "1",
                      "--mesh", "2x1"])


def test_op_plan_sharded_keys_autotune_by_strategy(tmp_path):
    """``CudaOp.plan_sharded`` plans through the mesh-bound planner; the
    autotune key carries mesh, axis and strategy (a cached winner replays
    its strategy), and timing a multi-device candidate raises."""
    import torch

    from repro_torch.plan import autotune as at
    from repro_torch.plan import get_op

    x, w = torch.zeros(256, 2048), torch.zeros(2048, 4096)
    ms = ts.MeshSpec((("model", 2),))
    op = get_op("matmul")
    got = op.plan_sharded(x, w, mesh=ms, axis="model", autotune="off")
    assert got == tp.planner_for("matmul", tm.H100, ms, "model").plan(
        **op.shape_args(x, w))
    shape = {k: v for k, v in op.shape_args(x, w).items() if v is not None}
    keys = {at.cache_key("matmul", shape, torch.float32, tm.H100, ms, "model", st)[1]
            for st in (None, "psum", "ring")}
    assert len(keys) == 3
    cache = at.AutotuneCache(str(tmp_path / "cache.json"))
    readable, digest = at.cache_key("matmul", shape, torch.float32, tm.H100, ms, "model",
                                    "psum")
    cache.put(digest, readable, {"op": "matmul", "strategy": "psum", "algorithm": "direct",
                                 "blocks": dict(got.schedule.blocks), "us": 1.0})
    hit = at.lookup("matmul", shape, machine=tm.H100, mesh=ms, axis="model",
                    strategy="psum", cache=cache, dtype=torch.float32)
    assert hit.strategy == "psum"
    with pytest.raises(NotImplementedError, match="5b"):
        at.tune("matmul", machine=tm.H100, mesh=ms, axis="model", cache=cache,
                device="cpu", **shape)


def test_port_imports_no_jax_for_the_mesh_modules():
    for name in ("repro_torch.runtime.collectives", "repro_torch.core.ring",
                 "repro_torch.runtime.parallel", "repro_torch.launch.mesh"):
        mod = sys.modules.get(name) or __import__(name, fromlist=["x"])
        src = open(mod.__file__).read()
        assert "import jax" not in src and "from repro." not in src, name
