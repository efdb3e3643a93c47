"""The MoE family trained and served on a mesh, against the JAX package on
the same mesh, on CPU ranks (as ``test_torch_token_mesh.py``).

Two smoke configs, each on 1x2 and 2x2: ``qwen3-moe-235b-a22b``'s with 16
experts (the expert-parallel branch: ``E % 16 == 0``) and ``grok-1-314b``'s
(4 experts: TP-within-expert).  The port's ranks are ``gloo`` processes
(``tests/_torch_ranks.py``, case ``moe_mesh``) from ``repro``'s seeded
weights; ``repro`` runs in a JAX subprocess a mesh on forced host devices.
Capacity couples the tokens of one dispatch and a data shard dispatches
alone, so every reference is ``repro`` on the same mesh, never one device:

* the FSDP step's step-1 loss and every gradient within 1e-4 x max(1,
  max|g|) of ``jax.grad`` of ``repro``'s loss under its ``parallel``;
* the launcher's 3 AdamW losses within 1e-5 relative of ``repro``'s
  launcher on the mesh;
* the four serving step builders' logits (whole) and each rank's piece of
  the caches within 1e-4 of scale of ``repro``'s builders under its
  ``parallel``.  ``repro``'s slot decode cannot run over a data axis above
  1 (its ``shard_map`` splits each batch-1 slot over ``data``); every slot
  dispatches alone, so on 2x2 the port's is held against ``repro``'s on a
  (1, 2) mesh.

Every part starts at once.  The rank groups keep the 120 s timeout of
the other rank files; a JAX reference (the launcher's jitted steps, then
eager ``shard_map``s) runs single-threaded under REF_TIMEOUT, since the
suite's other workers share the cores with its four processes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_ranks import SERVE_MAX_SEQ, run_ranks  # noqa: E402
from test_torch_token_mesh import (  # noqa: E402
    LOSS_TOL, TIMEOUT, TOL, close, repro_init, run_all,
)
from test_torch_sharded import ROOT, join  # noqa: E402

CONFIGS = {"ep": ("qwen3-moe-235b-a22b", {"n_experts": 16}), "tpe": ("grok-1-314b", {})}
MESHES = ["1x2", "2x2"]
BUILDERS = ("prefill", "decode", "bucket", "slot")
REF_TIMEOUT = 300.0  # seconds a JAX reference may take (about 30 alone)

REPRO = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.core.shard_compat import make_auto_mesh
from repro.data.pipeline import ShardInfo
from repro.launch import train as jlaunch
from repro.models.module import init_params
from repro.models.registry import get_family, make_data_source
from repro.runtime import serve as jsv
from repro.runtime import train as jrt
from repro.runtime.parallel import ParallelCtx
from repro_torch.convert import flatten_tree
sys.path.insert(0, TESTS)
from _torch_ranks import serve_builders
cfg = dataclasses.replace(smoke_config(ARCH), **CHANGES)
real_smoke = jlaunch.smoke_config
jlaunch.smoke_config = lambda arch: dataclasses.replace(real_smoke(arch), **CHANGES)
seen = []
real = jrt.run_elastic
def spy(*a, **kw):
    state, hist = real(*a, **kw)
    seen.extend(hist)
    return state, hist
jrt.run_elastic = spy
sys.argv = ["train", "--arch", ARCH, "--smoke", "--mesh", MESH, "--steps", "3", "--batch",
            "4", "--seq", "32", "--log-every", "1"]
jlaunch.main()
out = {"losses": np.array([h["loss"] for h in seen])}
dims = tuple(int(x) for x in MESH.split("x"))
mesh = make_auto_mesh(dims, ("data", "model"))
ctx = ParallelCtx(mesh=mesh, dp_axes=("data",), tp_axis="model")
tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                   remat="none")
params = init_params(get_family("moe").param_defs(cfg), jax.random.PRNGKey(0), jnp.float32)
toks = make_data_source(cfg, 4, 32, ShardInfo(0, 1), seed=0)(0)
with mesh:
    loss, g = jax.value_and_grad(jrt.make_loss_fn(cfg, tcfg, ctx))(
        params, {k: jnp.asarray(v) for k, v in toks.items()})
out["loss1"] = np.asarray(loss)
for k, v in flatten_tree(jax.tree.map(np.asarray, g)).items():
    out[f"grad.{k}"] = v

class Slots:  # the slot decode over a (1, model) mesh where data > 1
    def __init__(self, sv):
        self.sv = sv
    def __getattr__(self, name):
        fn = getattr(self.sv, name)
        if name != "make_slot_decode_step" or dims[0] == 1:
            return fn
        sub = make_auto_mesh((1, dims[1]), ("data", "model"))
        sctx = ParallelCtx(mesh=sub, dp_axes=("data",), tp_axis="model")
        def build(*a, parallel=None, **kw):
            step = fn(*a, parallel=sctx, **kw)
            def run(*b):
                b = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), b)
                with sub:
                    return step(*b)
            return run
        return build

with mesh:
    out.update(serve_builders(Slots(jsv), cfg, params, toks["tokens"], ctx, lift=jnp.asarray))
np.savez(OUT, **out)
"""


def _world(mesh: str) -> int:
    return int(np.prod([int(x) for x in mesh.split("x")]))


def _run_repro(script: str, devices: int):
    """A JAX reference on ``devices`` forced host devices, single-threaded."""
    import os
    import subprocess

    flags = (f"--xla_force_host_platform_device_count={devices} "
             "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    return subprocess.Popen([sys.executable, "-c", script], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    base = tmp_path_factory.mktemp("moe_mesh")
    tests = str(Path(__file__).resolve().parent)
    jobs = {}
    for tag, (arch, changes) in CONFIGS.items():
        init = repro_init(arch, "moe", **changes)
        for mesh in MESHES:
            d = base / f"{tag}_{mesh}"
            d.mkdir()
            np.savez(d / "init.npz", **init)
            script = (f"OUT = {str(d / 'repro.npz')!r}\nARCH = {arch!r}\nCHANGES = "
                      f"{changes!r}\nMESH = {mesh!r}\nTESTS = {tests!r}\n" + REPRO)

            def ref(script=script, mesh=mesh):
                join(_run_repro(script, devices=_world(mesh)), timeout=REF_TIMEOUT)

            jobs[f"repro_{tag}_{mesh}"] = ref
            jobs[f"{tag}_{mesh}"] = (lambda d=d, arch=arch, changes=changes, mesh=mesh:
                                     run_ranks("moe_mesh", _world(mesh), d,
                                               {"arch": arch, "changes": changes,
                                                "mesh": mesh}, timeout=TIMEOUT))
    return base, run_all(jobs)


def _part(results, tag: str, mesh: str):
    """(repro's references, each rank's results) of one config and mesh."""
    base, errors = results
    for key in (f"repro_{tag}_{mesh}", f"{tag}_{mesh}"):
        if errors[key] is not None:
            raise errors[key]
    d = base / f"{tag}_{mesh}"
    ranks = [dict(np.load(d / f"moe_rank{r}.npz")) for r in range(_world(mesh))]
    return dict(np.load(d / "repro.npz")), ranks


CASES = [(tag, mesh) for tag in CONFIGS for mesh in MESHES]


@pytest.mark.parametrize("tag,mesh", CASES)
def test_step1_loss_and_grads_equal_jax_grad_on_the_same_mesh(results, tag, mesh):
    want, ranks = _part(results, tag, mesh)
    names = sorted(k[len("grad."):] for k in want if k.startswith("grad."))
    for got in ranks:
        close(got["loss1"], want["loss1"], TOL)
        assert names == sorted(k[len("grad."):] for k in got if k.startswith("grad."))
        for k in names:
            close(got[f"grad.{k}"], want[f"grad.{k}"], TOL)


@pytest.mark.parametrize("tag,mesh", CASES)
def test_launcher_losses_equal_repro_on_the_same_mesh(results, tag, mesh):
    want, ranks = _part(results, tag, mesh)
    w, g = want["losses"], ranks[0]["losses"]
    assert len(w) == len(g) == 3
    for a, b in zip(g, w):
        assert abs(a - b) <= LOSS_TOL * abs(b), (g, w)


def _scaled_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1e-30, np.abs(want).max()), err


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("tag,mesh", CASES)
def test_serving_builders_equal_repro_under_its_parallel(results, tag, mesh, builder):
    want, ranks = _part(results, tag, mesh)
    for got in ranks:
        _scaled_close(got[f"{builder}.logits"], want[f"{builder}.logits"])
        r0, rn = (int(x) for x in got["rows"])
        h0, hn = (int(x) for x in got["heads"])
        for kv in ("k", "v"):
            whole = want[f"{builder}.cache.{kv}"]
            assert whole.shape[2] == SERVE_MAX_SEQ
            _scaled_close(got[f"{builder}.cache.{kv}"],
                          whole[:, r0:r0 + rn, :, h0:h0 + hn])


def test_rank_pieces_cover_the_batch_and_the_heads(results):
    """On 2x2 the ranks' cache rows split the batch over ``data``; the
    smoke configs' one KV head stays whole on every model rank."""
    for tag in CONFIGS:
        _, ranks = _part(results, tag, "2x2")
        rows = sorted({tuple(int(x) for x in r["rows"]) for r in ranks})
        assert rows == [(0, 2), (2, 2)]
        assert {tuple(int(x) for x in r["heads"]) for r in ranks} == {(0, 1)}


class _Stub:
    """A mesh's shape, seen from the rank at ``coords``."""

    def __init__(self, coords: dict, **shape):
        self.shape, self.axis_names, self.coords = dict(shape), tuple(shape), coords

    def axis_size(self, names):
        return int(np.prod([self.shape[a] for a in (names if isinstance(names, tuple)
                                                    else (names,))]))

    def axis_index(self, names):
        i = 0
        for a in names if isinstance(names, tuple) else (names,):
            i = i * self.shape[a] + self.coords[a]
        return i


@pytest.mark.parametrize("arch,want", [("qwen3-moe-235b-a22b", [(0, 2), (2, 2)]),
                                       ("grok-1-314b", [(0, 4), (4, 4)])])
def test_full_configs_cache_their_kv_heads_split_over_model(arch, want):
    """At full width the KV heads split evenly: each model rank caches the
    ones its query heads read, as ``kv_cache_spec`` places them."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ll
    from repro_torch.runtime.parallel import ParallelCtx, kv_cache_spec

    cfg = get_config(arch)
    got = [ll.cache_heads(cfg, ParallelCtx(mesh=_Stub({"data": 0, "model": r}, data=2,
                                                      model=2))) for r in (0, 1)]
    assert got == want
    ctx = ParallelCtx(mesh=_Stub({"data": 0, "model": 0}, data=2, model=2))
    spec = kv_cache_spec(ctx, (cfg.n_layers, 8, 2048, cfg.n_kv_heads, cfg.resolved_head_dim))
    assert tuple(spec) == (None, "data", None, "model", None)


def test_a_batch_1_cache_splits_its_sequence_over_the_idle_data_axis():
    """A batch-1 cache on 2x2 spreads its sequence over the idle data axis
    (``kv_cache_spec``): the rank at data 1 holds positions 32..63 of 64
    (``tests/test_torch_long_mesh.py`` serves on it against ``repro``);
    4 rows split over ``data`` instead.  A cache whose spec gives the
    sequence to the model axis (one KV head, a head dim of 32 and 63
    positions on a model axis of 3) raises and names ROADMAP queue 3."""
    import dataclasses

    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    from repro_torch.runtime import serve as sv
    from repro_torch.runtime.parallel import ParallelCtx

    cfg = smoke_config("qwen3-moe-235b-a22b")
    ctx = ParallelCtx(mesh=_Stub({"data": 1, "model": 0}, data=2, model=2))
    mesh = sv._Mesh(cfg, ctx)
    split = mesh.kv_split(moe, 1)
    assert split.axes == ("data",) and (split.n, split.start(32)) == (2, 32)
    cache = mesh.init_cache(moe, 1, 64, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: (cfg.n_layers, 1, 32, 1, 32) for k in ("k", "v")}
    assert mesh.kv_split(moe, 4) is None
    cache = mesh.init_cache(moe, 4, 64, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: (cfg.n_layers, 2, 64, 1, 32) for k in ("k", "v")}
    ctx3 = ParallelCtx(mesh=_Stub({"data": 0, "model": 0}, data=1, model=3))
    with pytest.raises(NotImplementedError, match="queue 3"):
        sv._Mesh(dataclasses.replace(cfg, n_heads=3), ctx3).init_cache(
            moe, 1, 63, torch.float32, "cpu")


def test_recurrent_families_build_their_slot_decode_over_a_model_axis():
    """The recurrent families served over a model axis above 1 raised until
    #5c's recurrent part: building the slot decode raises nothing now, and
    a rank's state holds half the heads
    (``tests/test_torch_families_mesh.py`` runs the builders and holds them
    against ``repro``)."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models.registry import get_family
    from repro_torch.runtime import serve as sv
    from repro_torch.runtime.parallel import ParallelCtx

    ctx = ParallelCtx(mesh=_Stub({"data": 0, "model": 1}, data=1, model=2))
    for arch, leaf in (("rwkv6-1.6b", "wkv"), ("zamba2-1.2b", "mamba/ssd")):
        cfg = smoke_config(arch)
        sv.make_slot_decode_step(cfg, parallel=ctx)
        cache = sv._Mesh(cfg, ctx).init_cache(get_family(cfg.family), 4, 64, torch.float32,
                                              "cpu")
        whole = get_family(cfg.family).init_cache(cfg, 4, 64, torch.float32, device="cpu")
        assert cache[leaf].shape[2] * 2 == whole[leaf].shape[2]
