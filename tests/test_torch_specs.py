"""The port's sharding specs against the JAX package's, in process, with no
ranks: every arch's ``param_specs``, ``param_counts`` and
``default_train_config`` at full config (abstract only: nothing is
allocated); ``fsdp_specs`` and ``zero1_specs`` on the meshes (1, 1), (2, 1),
(2, 2), (16, 16) and (2, 16, 16); ``head_axis_spec``, ``ff_spec`` and
``shard_extra_axis`` over a grid of sizes; the transformer's
``plan_forward``/``plan_training(mesh=)`` field for field on MANTICORE and
TPU_V5E; ``layers.layer_norm`` on seeded inputs at 1e-6.  Every entry must
equal ``repro``'s.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jcfg
from repro.core import machine as jm
from repro.launch import specs as jspecs
from repro.models import layers as jll
from repro.models import module as jmod
from repro.models import transformer as jtf
from repro.models.registry import get_family as jfamily
from repro.optim import adamw as jadamw
from repro.plan import sharded as js
from repro.runtime.parallel import ParallelCtx as JCtx
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.core import machine as tm
from repro_torch.launch import specs as tspecs
from repro_torch.models import layers as tll
from repro_torch.models import module as tmod
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import get_family as tfamily
from repro_torch.optim import adamw as tadamw
from repro_torch.plan import sharded as ts
from repro_torch.runtime.parallel import ParallelCtx as TCtx

MESHES = [(1, 1), (2, 1), (2, 2), (16, 16), (2, 16, 16)]
MESH_IDS = ["1x1", "2x1", "2x2", "16x16", "2x16x16"]


class _Mesh:
    """A mesh's shape alone: what the spec functions of both packages read."""

    def __init__(self, dims):
        self.axis_names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
        self.shape = dict(zip(self.axis_names, dims))


def _ctxs(dims):
    mesh = _Mesh(dims)
    dp = mesh.axis_names[:-1]
    return (JCtx(mesh=mesh, dp_axes=dp, tp_axis="model"),
            TCtx(mesh=mesh, dp_axes=dp, tp_axis="model"))


def _flat(tree, prefix=""):
    """A nested dict of the JAX package flattened to ``{"a/b": leaf}``."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v
    return out


def _specs(tree) -> dict:
    return {k: tuple(v) for k, v in tree.items()}


def _defs(arch):
    jc, tc = jcfg.get_config(arch), get_config(arch)
    return jc, tc, jfamily(jc.family).param_defs(jc), tfamily(tc.family).param_defs(tc)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_repro(arch):
    _, _, jdefs, tdefs = _defs(arch)
    want = _specs(_flat(jmod.param_specs(jdefs)))
    got = _specs(tmod.param_specs(tdefs))
    assert got == want
    shapes = {k: tuple(v.shape) for k, v in tmod.abstract_params(tdefs).items()}
    assert shapes == {k: tuple(v.shape) for k, v in _flat(jmod.abstract_params(jdefs)).items()}
    assert all(v.device.type == "meta" for v in tmod.abstract_params(tdefs).values())
    assert dict(tmod.flatten_defs(tdefs)).keys() == dict(jmod.flatten_defs(jdefs)).keys()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_repro(arch):
    jc, tc, jdefs, tdefs = _defs(arch)
    assert tspecs.param_counts(tc, tdefs) == jspecs.param_counts(jc, jdefs)


@pytest.mark.parametrize("dims", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_train_config_equals_repro(arch, dims):
    jc, tc = jcfg.get_config(arch), get_config(arch)
    jctx, tctx = _ctxs(dims)
    for batch in (8, 256, 4096):
        want = jspecs.default_train_config(jc, batch, jctx)
        got = tspecs.default_train_config(tc, batch, tctx)
        for field in ("param_dtype", "microbatch", "remat", "loss_chunks"):
            assert getattr(got, field) == getattr(want, field), (field, batch)


@pytest.mark.parametrize("dims", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_and_zero1_specs_equal_repro(arch, dims):
    _, _, jdefs, tdefs = _defs(arch)
    jctx, tctx = _ctxs(dims)
    jabs, tabs = jmod.abstract_params(jdefs, jnp.float32), tmod.abstract_params(tdefs)
    jsp, tsp = jmod.param_specs(jdefs), tmod.param_specs(tdefs)
    want = _specs(_flat(jspecs.fsdp_specs(jsp, jabs, jctx)))
    assert _specs(tspecs.fsdp_specs(tsp, tabs, tctx)) == want
    jz = jadamw.zero1_specs(jsp, jabs, jctx.dp_axes, jctx.mesh.shape)
    tz = tadamw.zero1_specs(tsp, tabs, tctx.dp_axes, tctx.mesh.shape)
    assert tuple(tz.step) == tuple(jz.step)
    for part in ("m", "v"):
        assert _specs(getattr(tz, part)) == _specs(_flat(getattr(jz, part)))
    st = tadamw.abstract_state(tabs)
    assert st.step == 0 and {k: tuple(v.shape) for k, v in st.m.items()} == {
        k: tuple(v.shape) for k, v in tabs.items()}
    assert all(v.dtype == torch.float32 and v.device.type == "meta" for v in st.v.values())


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
def test_head_and_ff_specs_equal_repro(tp):
    for n in (1, 2, 3, 4, 8, 12, 16, 24, 32, 40, 64, 96):
        for dh in (32, 64, 128):
            assert tll.head_axis_spec(n, dh, tp) == jll.head_axis_spec(n, dh, tp)
    for ff in (64, 96, 256, 2816, 5632, 8192, 11008, 24576, 32768, 1000):
        assert tll.ff_spec(ff, tp) == jll.ff_spec(ff, tp)
    assert tll.head_axis_spec(16, 64) == jll.head_axis_spec(16, 64)
    assert tll.ff_spec(2816) == jll.ff_spec(2816)
    assert tll.MODEL_AXIS == jll.MODEL_AXIS


@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
def test_shard_extra_axis_equals_repro(axes):
    from jax.sharding import PartitionSpec as JP

    mesh_shapes = [{"pod": 2, "data": 2, "model": 2}, {"pod": 1, "data": 16, "model": 16},
                   {"pod": 2, "data": 3, "model": 1}]
    shapes = [(16,), (6, 16), (3, 5), (24, 1024, 16, 64), (7, 12, 2), (0, 8)]
    specs = [(), (None,), ("model",), (None, "model"), ("model", None, None),
             (None, None, "model", None)]
    for ms in mesh_shapes:
        for shape in shapes:
            for spec in specs:
                if len(spec) > len(shape):
                    continue
                want = jspecs.shard_extra_axis(JP(*spec), shape, axes, ms)
                got = tspecs.shard_extra_axis(ts.P(*spec), shape, axes, ms)
                assert tuple(got) == tuple(want), (ms, shape, spec)


def test_layer_norm_equals_repro():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    for eps in (1e-6, 1e-5):
        want = np.asarray(jll.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps))
        got = tll.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             eps).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]


@pytest.mark.parametrize("mesh,axis", [((("data", 2), ("model", 2)), "data"),
                                       ((("data", 1), ("model", 2)), "data"),
                                       ((("data", 2), ("model", 1)), "data"),
                                       ((("pod", 2), ("data", 2), ("model", 2)), "data")],
                         ids=["2x2", "1x2", "2x1", "2x2x2"])
@pytest.mark.parametrize("machines", MACHINES, ids=["manticore", "tpu_v5e"])
@pytest.mark.parametrize("arch,batch,seq,smoke", [("qwen1.5-0.5b", 4, 2048, False),
                                                  ("qwen1.5-0.5b", 4, 64, True)],
                         ids=["full", "smoke"])
def test_transformer_plans_on_a_mesh_equal_repro(arch, batch, seq, smoke, machines, mesh,
                                                 axis):
    """plan_forward/plan_training(mesh=) are ShardedSchedules equal to
    ``repro``'s entry for entry (at a head dim both plan alike)."""
    jmach, tmach = machines
    jc = jcfg.smoke_config(arch) if smoke else jcfg.get_config(arch)
    tc = smoke_config(arch) if smoke else get_config(arch)
    assert tc.resolved_head_dim == tc.d_model // tc.n_heads
    for jfn, tfn in ((jtf.plan_forward, ttf.plan_forward),
                     (jtf.plan_training, ttf.plan_training)):
        want = jfn(jc, batch, seq, loss_chunks=4, machine=jmach, mesh=js.MeshSpec(mesh),
                   shard_axis=axis)
        got = tfn(tc, batch, seq, loss_chunks=4, machine=tmach, mesh=ts.MeshSpec(mesh),
                  shard_axis=axis)
        assert list(got) == list(want)
        for k in want:
            assert isinstance(got[k], ts.ShardedSchedule)
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k]), k
            assert (got[k].hbm_words, got[k].ici_words) == (want[k].hbm_words,
                                                            want[k].ici_words)
        assert ts.validate_sharded_plan(got, ts.MeshSpec(mesh)) == js.validate_sharded_plan(
            want, js.MeshSpec(mesh))
