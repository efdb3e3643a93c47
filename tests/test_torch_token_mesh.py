"""The dense token family trained on a mesh, against the JAX package, on
CPU ranks.

The port's ranks are ``gloo`` processes (``tests/_torch_ranks.py``, case
``tokens``); the references run in JAX subprocesses with forced host
devices, one a mesh: ``repro``'s launcher on the mesh (its ``run_elastic``
spied for the history), and in one of them ``jax.grad`` of its loss on one
device.  The weights are
``repro``'s seeded init carried across by ``repro_torch.convert``.  For the
smoke dense config, plain and planned, on meshes 2x1, 1x2, 2x2 and 2x2x1
(a batch over two dp axes at once): the FSDP step's step-1 loss and every
gradient within 1e-4 x max(1, max|g|) of ``jax.grad``, and the launcher's
3 AdamW losses within 1e-5 relative of ``repro``'s launcher on the same
mesh.  Every part runs at once, each under its own timeout.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_ranks import run_ranks  # noqa: E402
from test_torch_sharded import join, run_repro  # noqa: E402

TOL = 1e-4
LOSS_TOL = 1e-5
TIMEOUT = 120.0
ARCH = "qwen1.5-0.5b"
MESHES = ["2x1", "1x2", "2x2", "2x2x1"]
VARIANTS = ["plain", "planned"]

# The JAX package's references: its launcher on every mesh of RUNS, and
# jax.grad of its loss at the seeded init on step 0's batch (GRADS).
REPRO = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.data.pipeline import ShardInfo
from repro.launch import train as jlaunch
from repro.models.module import init_params
from repro.models.registry import get_family, make_data_source
from repro.runtime import train as jrt
from repro_torch.convert import flatten_tree
out = {}
real = jrt.run_elastic
for family, mesh in RUNS:
    seen = []
    def spy(*a, seen=seen, **kw):
        state, hist = real(*a, **kw)
        seen.extend(hist)
        return state, hist
    jrt.run_elastic = spy
    sys.argv = ["train", "--family", family, "--mesh", mesh, "--steps", "3", "--batch", "4",
                "--seq", "32", "--log-every", "1"]
    jlaunch.main()
    out[f"{family}.{mesh}.losses"] = np.array([h["loss"] for h in seen])
for tag, family, arch, changes in GRADS:
    cfg = dataclasses.replace(smoke_config(arch), family=family, **changes)
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                       remat="none")
    params = init_params(get_family(family).param_defs(cfg), jax.random.PRNGKey(0),
                         jnp.float32)
    src = make_data_source(cfg, 4, 32, ShardInfo(0, 1), seed=0)
    batch = {k: jnp.asarray(v) for k, v in src(0).items()}
    loss, g = jax.value_and_grad(jrt.make_loss_fn(cfg, tcfg))(params, batch)
    out[f"{tag}.loss1"] = np.asarray(loss)
    for k, v in flatten_tree(jax.tree.map(np.asarray, g)).items():
        out[f"{tag}.grad.{k}"] = v
np.savez(OUT, **out)
"""


def repro_init(arch: str, family: str, **changes) -> dict:
    """``repro``'s seeded weights of a smoke config, flat."""
    import dataclasses

    from repro.configs.registry import smoke_config
    from repro.models.module import init_params
    from repro.models.registry import get_family
    from repro_torch.convert import flatten_tree

    cfg = dataclasses.replace(smoke_config(arch), **changes)
    tree = init_params(get_family(family).param_defs(cfg), jax.random.PRNGKey(0), jnp.float32)
    return flatten_tree(jax.tree.map(np.asarray, tree))


def run_all(jobs: dict) -> dict:
    """Run every part at once; a part's exception comes back in its slot."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(fn) for k, fn in jobs.items()}
    out = {}
    for k, f in futs.items():
        try:
            f.result()
            out[k] = None
        except BaseException as e:  # re-raised in the tests that read the part
            out[k] = e
    return out


def repro_job(script: str, out: Path, runs: list, grads: list, devices: int = 4,
              prelude: str = ""):
    """The JAX references of ``script`` (launcher ``runs``, ``grads`` as
    (tag, family, arch, config changes)) in a subprocess on ``devices``
    forced host devices, after ``prelude``; written to ``out``."""
    def job():
        proc = run_repro(f"OUT = {str(out)!r}\nRUNS = {runs!r}\n"
                         f"GRADS = {grads!r}\n" + prelude + script, devices=devices)
        join(proc, timeout=TIMEOUT)
    return job


def references(base: Path, errors: dict, part: str) -> dict:
    """Every JAX reference file under ``base`` merged, after re-raising
    what failed of the references and of ``part``."""
    for key in [k for k in errors if k.startswith("repro")] + [part]:
        if errors[key] is not None:
            raise errors[key]
    out = {}
    for f in sorted(base.glob("repro*.npz")):
        out.update(np.load(f))
    return out


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    base = tmp_path_factory.mktemp("tokens")
    init = repro_init(ARCH, "transformer")
    jobs = {f"repro_{m}": repro_job(
        REPRO, base / f"repro_{m}.npz", [("transformer", m)],
        [("transformer", "transformer", ARCH, {})] if m == MESHES[0] else [],
        devices=int(np.prod([int(x) for x in m.split("x")]))) for m in MESHES}
    for mesh in MESHES:
        d = base / mesh
        d.mkdir()
        np.savez(d / "init.npz", **init)
        world = int(np.prod([int(x) for x in mesh.split("x")]))
        jobs[mesh] = (lambda d=d, mesh=mesh, world=world: run_ranks(
            "tokens", world, d, {"family": "transformer", "arch": ARCH, "mesh": mesh,
                                 "variants": VARIANTS}, timeout=TIMEOUT))
    errors = run_all(jobs)
    return base, errors


def _part(results, key):
    base, errors = results
    return references(base, errors, key), dict(np.load(base / key / f"tokens_{key}.npz"))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_step1_loss_and_grads_equal_jax_grad(results, mesh, variant):
    want, got = _part(results, mesh)
    close(got[f"{variant}.loss1"], want["transformer.loss1"], TOL)
    names = [k[len("transformer.grad."):] for k in want if k.startswith("transformer.grad.")]
    assert sorted(names) == sorted(k[len(variant) + 6:] for k in got
                                   if k.startswith(f"{variant}.grad."))
    for k in names:
        close(got[f"{variant}.grad.{k}"], want[f"transformer.grad.{k}"], TOL)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_launcher_losses_equal_repro_on_the_same_mesh(results, mesh, variant):
    want, got = _part(results, mesh)
    w, g = want[f"transformer.{mesh}.losses"], got[f"{variant}.losses"]
    assert len(w) == len(g) == 3
    for a, b in zip(g, w):
        assert abs(a - b) <= LOSS_TOL * abs(b), (g, w)
