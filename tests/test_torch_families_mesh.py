"""The recurrent and encoder-decoder families on a model axis, and int8_ef
on FSDP shards, against the JAX package, on CPU ranks (as
``test_torch_token_mesh.py`` and ``test_torch_moe_mesh.py``).

The port's ranks are ``gloo`` processes (``tests/_torch_ranks.py``, case
``families_mesh``, one group a mesh) from ``repro``'s seeded weights; the
references run in JAX subprocesses on forced host devices: one on a
single device (``jax.grad`` and the encoder-decoder's train step) and one
a mesh (the launcher and the serving builders under ``parallel``).  For
the smoke ``rwkv6``, ``zamba2`` and ``encdec`` on meshes 1x2, 2x2 and
2x2x1:

* the FSDP step's step-1 loss and every gradient within 1e-4 x max(1,
  max|g|) of ``jax.grad`` (the encoder-decoder on a frames batch);
* RWKV-6's and Zamba2's 3 launcher losses within 1e-5 relative of
  ``repro``'s launcher on the same mesh; the encoder-decoder's 3 losses of
  the FSDP train step on frames batches (its launcher raises in both
  packages for want of frames) within 1e-5 relative of ``repro``'s train
  step;
* on (1, 2) and (2, 2), the serving step builders' logits and the cache
  gathered whole within 1e-5 of scale of ``repro``'s builders on the same
  mesh, and their greedy tokens equal (the encoder-decoder has no bucket
  prefill: no frames reach it in either package); on (1, 2) the weights
  are placed by ``serve.serving_param_specs`` (the leaves every model rank
  uses whole held whole), on (2, 2) by their specs (gathered at each step);
* a Zamba2 variant whose SSD state has H >= hd (heads of 16 over a head
  dim of 16), so that ``cache_specs`` takes it for a KV cache, and an
  encoder-decoder whose vocab of 250 does not divide by 16 (its embedding
  stored split over d_model, gathered whole, then split by vocab, as
  seamless-m4t-medium's), on 1x2;
* the dense family's launcher under ``--grad-compression int8_ef`` on 2x2
  against ``repro``'s.

Every part starts at once: each rank group under the 120 s timeout of the
other rank files, and the JAX references, single-threaded, one process a
config and mesh, each under REF_TIMEOUT.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_ranks import run_ranks  # noqa: E402
from test_torch_moe_mesh import _run_repro, _world  # noqa: E402
from test_torch_token_mesh import (  # noqa: E402
    LOSS_TOL, TIMEOUT, TOL, close, repro_init, run_all,
)
from test_torch_sharded import join  # noqa: E402

SERVE_TOL = 1e-5
REF_TIMEOUT = 600.0  # seconds a JAX reference may take (5-45 alone, single-threaded)
# tag: (arch, config changes)
CONFIGS = {
    "rwkv6": ("rwkv6-1.6b", {}),
    "zamba2": ("zamba2-1.2b", {}),
    "encdec": ("seamless-m4t-medium", {}),
    "zamba2_kv": ("zamba2-1.2b", {"ssm_head_dim": 16}),  # SSD state [L, B, 16, 16, 16]
    # 250 rows do not divide by 16: the embedding is stored split over d_model
    # (seamless-m4t-medium's 256206), gathered whole, then split by vocab.
    "encdec_v250": ("seamless-m4t-medium", {"vocab": 250}),
    "dense": ("qwen1.5-0.5b", {}),
}
MESHES = ["1x2", "2x2", "2x2x1"]
SERVE_MESHES = ["1x2", "2x2"]
TRAINED = ("rwkv6", "zamba2", "encdec")


def _parts(mesh: str) -> list:
    """The ``[tag, arch, changes, what]`` parts of one mesh's rank group."""
    out = []
    for tag in TRAINED:
        arch, changes = CONFIGS[tag]
        out.append([tag, arch, changes, "frames" if tag == "encdec" else "launcher"])
        out.append([tag, arch, changes, "grads"])
        if mesh in SERVE_MESHES:
            out.append([tag, arch, changes, "serve"])
    if mesh == "1x2":
        for tag in ("zamba2_kv", "encdec_v250"):
            arch, changes = CONFIGS[tag]
            out += [[tag, arch, changes, "grads"], [tag, arch, changes, "serve"]]
    if mesh == "2x2":
        arch, changes = CONFIGS["dense"]
        out.append(["dense", arch, changes, "int8_ef"])
    return out


REPRO = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.core.shard_compat import make_auto_mesh
from repro.launch import train as jlaunch
from repro.models.module import init_params
from repro.models.registry import get_family
from repro.runtime import serve as jsv
from repro.runtime import train as jrt
from repro.runtime.parallel import ParallelCtx
from repro_torch.convert import flatten_tree
sys.path.insert(0, TESTS)
from _torch_ranks import (ENCDEC_STEPS, family_serve, frames_batch, frames_tcfg,
                          serve_builders, serve_inputs)
real_smoke, real_run = jlaunch.smoke_config, jrt.run_elastic
out = {}
mesh = ctx = None
if MESH is not None:
    dims = tuple(int(x) for x in MESH.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    mesh = make_auto_mesh(dims, axes)
    ctx = ParallelCtx(mesh=mesh, dp_axes=axes[:-1], tp_axis="model")
lift = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
for tag, arch, changes, what in PARTS:
    cfg = dataclasses.replace(smoke_config(arch), **changes)
    params = init_params(get_family(cfg.family).param_defs(cfg), jax.random.PRNGKey(0),
                         jnp.float32)
    if what in ("launcher", "int8_ef"):
        seen = []
        def spy(*a, seen=seen, **kw):
            state, hist = real_run(*a, **kw)
            seen.extend(hist)
            return state, hist
        jrt.run_elastic = spy
        jlaunch.smoke_config = lambda a, changes=changes: dataclasses.replace(real_smoke(a),
                                                                              **changes)
        sys.argv = ["train", "--arch", arch, "--smoke", "--mesh", MESH, "--steps", "3",
                    "--batch", "4", "--seq", "32", "--log-every", "1"]
        if what == "int8_ef":
            sys.argv += ["--grad-compression", "int8_ef"]
        jlaunch.main()
        out[f"{tag}.{what}.losses"] = np.array([h["loss"] for h in seen])
    elif what == "grads":
        tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                           remat="none")
        batch = frames_batch(cfg, 0) if cfg.family == "encdec" else serve_inputs(cfg)
        loss, g = jax.value_and_grad(jrt.make_loss_fn(cfg, tcfg))(params, lift(batch))
        out[f"{tag}.loss1"] = np.asarray(loss)
        for k, v in flatten_tree(jax.tree.map(np.asarray, g)).items():
            out[f"{tag}.grad.{k}"] = v
    elif what == "frames":
        tcfg = frames_tcfg(TrainConfig)
        step = jax.jit(jrt.make_train_step(cfg, tcfg))
        state, losses = jrt.init_state(cfg, tcfg, params), []
        for i in range(ENCDEC_STEPS):
            state, metrics = step(state, lift(frames_batch(cfg, i)))
            losses.append(float(metrics["loss"]))
        out[f"{tag}.frames.losses"] = np.array(losses)
    else:  # serve, under parallel on the mesh
        toks = serve_inputs(cfg)["tokens"]
        flat = lambda cache: flatten_tree(jax.tree.map(np.asarray, cache))
        with mesh:
            if cfg.family == "encdec":
                got = family_serve(jsv, cfg, params, toks, frames_batch(cfg, 0)["frames"], ctx,
                                   lift=jnp.asarray, whole=flat)
            else:
                got = serve_builders(jsv, cfg, params, toks, ctx, lift=jnp.asarray, whole=flat)
        out.update({f"{tag}.{k}": v for k, v in got.items()})
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    base = tmp_path_factory.mktemp("families_mesh")
    tests = str(Path(__file__).resolve().parent)
    inits = {tag: repro_init(arch, _family(tag), **changes)
             for tag, (arch, changes) in CONFIGS.items()}
    jobs = {}
    refs = {}  # (mesh or None, tag) -> parts: one JAX process each
    for mesh in MESHES:
        d = base / mesh
        d.mkdir()
        for tag, init in inits.items():
            np.savez(d / f"init_{tag}.npz", **init)
        parts = _parts(mesh)
        for p in parts:  # the grads and the frames steps: one device's function
            key = (None, p[0]) if p[3] in ("grads", "frames") else (mesh, p[0])
            if p not in refs.setdefault(key, []):
                refs[key].append(p)
        args = {"mesh": mesh, "parts": parts, "serving_specs": mesh == "1x2"}
        jobs[mesh] = (lambda d=d, mesh=mesh, args=args: run_ranks(
            "families_mesh", _world(mesh), d, args, timeout=TIMEOUT))
    for (mesh, tag), parts in refs.items():
        out = base / f"repro_{mesh or 'one'}_{tag}.npz"
        script = (f"OUT = {str(out)!r}\nMESH = {mesh!r}\nPARTS = {parts!r}\n"
                  f"TESTS = {tests!r}\n" + REPRO)
        jobs[f"repro_{mesh or 'one'}_{tag}"] = (
            lambda script=script, mesh=mesh: join(
                _run_repro(script, devices=_world(mesh) if mesh else 1), timeout=REF_TIMEOUT))
    return base, run_all(jobs)


def _family(tag: str) -> str:
    from repro_torch.configs import smoke_config

    return smoke_config(CONFIGS[tag][0]).family


def _part(results, mesh: str, tag: str, one: bool = False):
    """(the JAX references of ``tag``: the mesh's, or the one device's; the
    mesh's rank 0 results), after re-raising what failed of them."""
    base, errors = results
    key = f"repro_{'one' if one else mesh}_{tag}"
    for k in (key, mesh):
        if errors[k] is not None:
            raise errors[k]
    return dict(np.load(base / f"{key}.npz")), dict(np.load(base / mesh / f"families_{mesh}.npz"))


GRAD_CASES = ([(m, t) for m in MESHES for t in TRAINED]
              + [("1x2", "zamba2_kv"), ("1x2", "encdec_v250")])


@pytest.mark.parametrize("mesh,tag", GRAD_CASES)
def test_step1_loss_and_grads_equal_jax_grad(results, mesh, tag):
    want, got = _part(results, mesh, tag, one=True)
    close(got[f"{tag}.loss1"], want[f"{tag}.loss1"], TOL)
    names = sorted(k[len(tag) + 6:] for k in want if k.startswith(f"{tag}.grad."))
    assert names == sorted(k[len(tag) + 6:] for k in got if k.startswith(f"{tag}.grad."))
    for k in names:
        close(got[f"{tag}.grad.{k}"], want[f"{tag}.grad.{k}"], TOL)


def _scaled_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1e-30, np.abs(want).max()), err


def _losses_close(g, w):
    assert len(w) == len(g) == 3
    for a, b in zip(g, w):
        assert abs(a - b) <= LOSS_TOL * abs(b), (g, w)


@pytest.mark.parametrize("mesh,tag", [(m, t) for m in MESHES for t in ("rwkv6", "zamba2")])
def test_launcher_losses_equal_repro_on_the_same_mesh(results, mesh, tag):
    want, got = _part(results, mesh, tag)
    _losses_close(got[f"{tag}.launcher.losses"], want[f"{tag}.launcher.losses"])


@pytest.mark.parametrize("mesh", MESHES)
def test_encdec_frames_steps_equal_repro_train_step(results, mesh):
    want, got = _part(results, mesh, "encdec", one=True)
    _losses_close(got["encdec.frames.losses"], want["encdec.frames.losses"])


def test_int8_ef_on_fsdp_shards_launcher_losses_equal_repro(results):
    want, got = _part(results, "2x2", "dense")
    _losses_close(got["dense.int8_ef.losses"], want["dense.int8_ef.losses"])


SERVE_CASES = ([(m, t, b) for m in SERVE_MESHES for t in TRAINED
                for b in (("prefill", "decode", "slot") if t == "encdec"
                          else ("prefill", "decode", "bucket", "slot"))]
               + [("1x2", "zamba2_kv", b) for b in ("prefill", "decode", "bucket", "slot")]
               + [("1x2", "encdec_v250", b) for b in ("prefill", "decode", "slot")])


@pytest.mark.parametrize("mesh,tag,builder", SERVE_CASES)
def test_serving_builders_equal_repro_on_the_same_mesh(results, mesh, tag, builder):
    """Logits and every cache leaf (gathered whole) within 1e-5 of scale;
    the greedy tokens equal."""
    want, got = _part(results, mesh, tag)
    key = f"{tag}.{builder}"
    _scaled_close(got[f"{key}.logits"], want[f"{key}.logits"], SERVE_TOL)
    assert (np.argmax(got[f"{key}.logits"], -1) == np.argmax(want[f"{key}.logits"], -1)).all()
    leaves = sorted(k[len(key) + 7:] for k in want if k.startswith(f"{key}.cache."))
    assert leaves and leaves == sorted(k[len(key) + 7:] for k in got
                                       if k.startswith(f"{key}.cache."))
    for leaf in leaves:
        _scaled_close(got[f"{key}.cache.{leaf}"], want[f"{key}.cache.{leaf}"], SERVE_TOL)


@pytest.mark.parametrize("arch,whole", [
    ("rwkv6-1.6b", {"layers/cm/wr"}),
    ("zamba2-1.2b", {"mamba/w_in", "mamba/conv_w", "mamba/conv_b"}),
    ("seamless-m4t-medium", {"embed"}),  # vocab 256206: stored split over d_model
    ("qwen1.5-0.5b", set()),
])
def test_serving_param_specs_hold_whole_what_every_model_rank_uses_whole(arch, whole):
    """``serving_param_specs`` takes the model axis out of exactly the
    leaves the blocks gather whole over it, and leaves every other spec as
    ``param_specs`` gives it."""
    from repro_torch.configs import get_config
    from repro_torch.models.module import param_specs
    from repro_torch.models.registry import get_family
    from repro_torch.runtime import serve as sv

    cfg = get_config(arch)
    specs = param_specs(get_family(cfg.family).param_defs(cfg))
    got = sv.serving_param_specs(cfg)
    assert got.keys() == specs.keys()
    assert {k for k in specs if got[k] != specs[k]} == whole
    for k in whole:
        assert "model" in tuple(specs[k]) and tuple(got[k]) == (None,) * len(specs[k])


def _stub_ctx(data: int, model: int, rank: int = 0):
    from test_torch_moe_mesh import _Stub

    from repro_torch.runtime.parallel import ParallelCtx

    return ParallelCtx(mesh=_Stub({"data": 0, "model": rank}, data=data, model=model))


@pytest.mark.parametrize("arch,changes", [("zamba2-1.2b", {}),
                                          ("zamba2-1.2b", {"ssm_head_dim": 16})])
def test_ssd_state_keeps_its_heads_whatever_the_shape_heuristic(arch, changes):
    """At zamba2-1.2b width the SSD state is [L, B, 64, 64, 64] and the
    smoke variant's [L, B, 16, 16, 16]: ``cache_specs`` (as ``repro``'s)
    takes either for a KV cache and splits its head dim over ``model``;
    the port's rank holds its heads (and no sequence split is refused)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import zamba2
    from repro_torch.runtime import serve as sv
    from repro_torch.runtime.parallel import cache_specs

    cfg = dataclasses.replace((smoke_config if changes else get_config)(arch), **changes)
    ctx = _stub_ctx(1, 2)
    whole = zamba2.init_cache(cfg, 2, 64, torch.float32, device="meta")
    _, H, hd, N = whole["mamba/ssd"].shape[1:]
    assert H >= hd
    assert tuple(cache_specs(ctx, whole)["mamba/ssd"]) == (None, "data", None, "model", None)
    cache = sv._Mesh(cfg, ctx).init_cache(zamba2, 2, 64, torch.float32, "meta")
    assert tuple(cache["mamba/ssd"].shape[2:]) == (H // 2, hd, N)


def test_sequence_split_cache_raises_with_its_roadmap_item():
    """A batch-1 Zamba2 cache on 2x2 spreads its KV sequence over the idle
    data axis (a rank holds 32 of 64 positions; ``tests/test_torch_long_mesh.py``
    serves on it); a sequence that does not split evenly over that axis
    raises and names ROADMAP queue 3 #22; the recurrent states alone never
    split."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import rwkv6, zamba2
    from repro_torch.runtime import serve as sv

    ctx = _stub_ctx(2, 2)
    mesh = sv._Mesh(smoke_config("zamba2-1.2b"), ctx)
    cache = mesh.init_cache(zamba2, 1, 64, torch.float32, "meta")
    assert cache["k"].shape[2] == 32 and cache["mamba/ssd"].shape[1] == 1
    with pytest.raises(NotImplementedError, match="queue 3 #22"):
        mesh.init_cache(zamba2, 1, 63, torch.float32, "meta")
    cache = sv._Mesh(smoke_config("rwkv6-1.6b"), ctx).init_cache(rwkv6, 1, 64, torch.float32,
                                                                 "meta")
    assert tuple(cache["wkv"].shape[1:3]) == (1, 2)
