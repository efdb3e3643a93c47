"""The port's multi-device half against the JAX package, on CPU ranks.

The port's ranks are processes in a ``gloo`` group (``tests/_torch_ranks.py``,
a ``file://`` store under ``tmp_path``, every rank under a timeout); the
JAX references that need a mesh run in a subprocess with forced host
devices, as ``tests/test_distributed.py`` runs them, and hand their results
over as ``.npz`` files.  Gates: fc_layer_sharded under psum, ring, tp, batch
and the planner's pick and ring_matmul (forward and gradients against
``jax.grad`` through ``repro``'s fc_layer_sharded, 1e-4); the conv
partitions against ``conv2d_fused_ref``; ``int8_psum`` against ``repro``'s;
the data-parallel CNN step (3 AdamW steps on (2,) and (2, 2), also
accumulated and under int8_ef) against ``repro``'s single-device step; the
launcher's ``--mesh 1x2`` losses against ``repro``'s launcher.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_ranks import ROOT, run_ranks  # noqa: E402

TOL = 1e-4
TIMEOUT = 120.0


def run_repro(script: str, devices: int, timeout: float = TIMEOUT) -> subprocess.Popen:
    """Start a JAX reference script on ``devices`` forced host devices."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.Popen([sys.executable, "-c", script], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def join(proc: subprocess.Popen, timeout: float = TIMEOUT) -> None:
    try:
        log = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"the JAX reference outlived its {timeout} s timeout") from None
    assert proc.returncode == 0, log


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------------------------
# fc_layer_sharded, the ring, the conv partitions, int8_psum: 4 ranks
# ---------------------------------------------------------------------------

REPRO_FC = """
import jax, jax.numpy as jnp, numpy as np
from repro.core.shard_compat import make_auto_mesh
from repro.core.fc_layer import fc_layer_sharded
from repro.core.ring import ring_matmul
from repro.optim.compression import int8_psum
mesh = make_auto_mesh((4,), ("model",))
out = {}
rng = np.random.default_rng(3)
x = jnp.asarray(rng.standard_normal((8, 64)).astype(np.float32))
w = jnp.asarray(rng.standard_normal((64, 40)).astype(np.float32))
for st in ("psum", "ring", "tp", "batch", None):
    def loss(x, w, st=st):
        with mesh:
            y = fc_layer_sharded(x, w, mesh, axis="model", strategy=st)
        return (y ** 2).sum(), y
    (_, y), (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(x, w)
    tag = st or "auto"
    out[tag + ".y"], out[tag + ".gx"], out[tag + ".gw"] = map(np.asarray, (y, gx, gw))
rng = np.random.default_rng(2)
x = jnp.asarray(rng.standard_normal((16, 32)).astype(np.float32))
w = jnp.asarray(rng.standard_normal((32, 24)).astype(np.float32))
with mesh:
    out["ring_matmul.y"] = np.asarray(ring_matmul(x, w, mesh, axis="model"))
base = np.random.default_rng(6).standard_normal((5, 7)).astype(np.float32)
with mesh:
    out["int8.same"] = np.asarray(int8_psum(jnp.asarray(base), mesh, "model"))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def fc_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("fc")
    ref = run_repro(f"OUT = {str(out / 'repro.npz')!r}\n" + REPRO_FC, devices=4)
    try:
        run_ranks("fc", 4, out, timeout=TIMEOUT)
    finally:
        join(ref)
    ranks = [dict(np.load(out / f"fc_rank{r}.npz")) for r in range(4)]
    return ranks, dict(np.load(out / "repro.npz"))


@pytest.mark.parametrize("strategy", ["psum", "ring", "tp", "batch", "auto"])
def test_fc_layer_sharded_forward_and_grads_equal_repro(fc_results, strategy):
    ranks, want = fc_results
    for r in ranks:  # the global result on every rank
        for part in ("y", "gx", "gw"):
            close(r[f"{strategy}.{part}"], want[f"{strategy}.{part}"])
    rng = np.random.default_rng(3)
    x, w = rng.standard_normal((8, 64)), rng.standard_normal((64, 40))
    close(ranks[0][f"{strategy}.y"], x @ w)


def test_ring_permutes_as_simulate_ring_walks(fc_results):
    """Alg 3's P-1 hops forward, and the reverse ring's P-1 in the backward;
    the planner picks the ring at these shapes."""
    from repro_torch.core.schedule_sim import simulate_ring

    ranks, _ = fc_results
    walk = simulate_ring(m=8, n=40, k=64, devices=4)
    hops = walk.intercluster // (8 * 64 // 4) // 4  # one device's sends
    for r in ranks:
        assert int(r["ring.fwd_ppermutes"]) == hops == 3
        assert int(r["ring.all_ppermutes"]) == 2 * hops
        assert int(r["auto.fwd_ppermutes"]) == hops  # the argmin's pick is the ring
        assert int(r["psum.all_ppermutes"]) == 0


def test_ppermute_and_its_inverse_backward(fc_results):
    """``ppermute`` sends along the permutation (zeros where no rank
    sends, as ``jax.lax.ppermute``) and its backward sends the cotangent
    back along the inverse."""
    ranks, _ = fc_results
    for r, rec in enumerate(ranks):
        np.testing.assert_array_equal(rec["ppermute.y"], np.full(3, (r - 1) % 4 + 1.0))
        np.testing.assert_array_equal(rec["ppermute.g"], np.full(3, 10.0 + (r + 1) % 4))
        np.testing.assert_array_equal(rec["ppermute.partial"],
                                      np.full(3, 1.0 if r == 1 else 0.0))


def test_ring_matmul_equals_repro(fc_results):
    ranks, want = fc_results
    rng = np.random.default_rng(2)
    x, w = rng.standard_normal((16, 32)), rng.standard_normal((32, 24))
    for r in ranks:
        close(r["ring_matmul.y"], want["ring_matmul.y"])
        close(r["ring_matmul.y"], x @ w)


@pytest.mark.parametrize("strategy", ["batch", "stack"])
def test_conv_partitions_equal_the_xla_oracle(fc_results, strategy):
    from repro.kernels.conv2d.ref import conv2d_fused_ref

    ranks, _ = fc_results
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    f = rng.standard_normal((3, 3, 3, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    want = np.asarray(conv2d_fused_ref(jnp.asarray(x), jnp.asarray(f), jnp.asarray(b),
                                       padding=1, relu=True, pool=2))
    for r in ranks:
        close(r[f"conv.{strategy}"], want, tol=2e-4)


def test_int8_psum_equals_repro(fc_results):
    """The same shared scale as ``repro``'s (every rank holding one x, as
    its replicated input does) and sums within one quantum times R; ranks
    holding their own x sum their int8 payloads at the pmax scale."""
    ranks, want = fc_results
    base = np.random.default_rng(6).standard_normal((5, 7)).astype(np.float32)
    scale = np.abs(base).max() / 127.0
    for r in ranks:
        assert np.abs(r["int8.same"] - want["int8.same"]).max() <= 4 * scale
        close(r["int8.same"], 4 * base, tol=4 * scale)
    xs = [base * (1.0 + 0.25 * k) for k in range(4)]
    s = max(np.abs(x).max() for x in xs) / 127.0
    model = sum(np.clip(np.round(x / s), -127, 127) for x in xs) * s
    for r in ranks:
        np.testing.assert_allclose(r["int8.mine"], model, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The data-parallel CNN step
# ---------------------------------------------------------------------------

STEPS, BATCH = 3, 8


def _repro_cnn():
    from repro.configs.registry import smoke_config
    from repro.models.module import init_params
    from repro.models.registry import get_family

    cfg = smoke_config("cnn-vgg11")
    params = init_params(get_family(cfg.family).param_defs(cfg), jax.random.PRNGKey(0),
                         jnp.float32)
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _repro_trajectory(cfg, params, batches, variant):
    from repro.configs.base import TrainConfig
    from repro.runtime import train as jtr

    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", learning_rate=3e-4,
                       warmup_steps=1, total_steps=STEPS, planned_kernels=False,
                       grad_compression="int8_ef" if variant == "int8_ef" else "none")
    step = jax.jit(jtr.make_train_step(cfg, tcfg))
    state = jtr.init_state(cfg, tcfg, jax.tree_util.tree_map(jnp.asarray, params))
    losses = []
    for b in batches:
        b = {k: jnp.asarray(v) for k, v in b.items()}
        if variant == "accum":
            b = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:]) for k, v in b.items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.mark.parametrize("mesh", [(2,), (2, 2)], ids=["2", "2x2"])
def test_data_parallel_cnn_step_equals_repro_single_device(tmp_path, mesh):
    """3 AdamW steps of the planned data-parallel step (each rank its half
    of the batch, gradients averaged by one psum) against ``repro``'s
    single-device step (``planned_kernels=False``) from the same weights
    on the same batches: plain, with 2 accumulated micro-batches and under
    int8_ef; every rank ends with the same parameters."""
    from repro.data.pipeline import ShardInfo, SyntheticImageSource

    cfg, params = _repro_cnn()
    src = SyntheticImageSource(32, 3, cfg.vocab, BATCH, ShardInfo(0, 1), seed=0)
    batches = [src(i) for i in range(STEPS)]
    np.savez(tmp_path / "init.npz", **params)
    np.savez(tmp_path / "batches.npz",
             **{f"{k}{i}": v for i, b in enumerate(batches) for k, v in b.items()})
    world = int(np.prod(mesh))
    run_ranks("dp", world, tmp_path, {"mesh": list(mesh), "steps": STEPS}, timeout=TIMEOUT)
    ranks = [dict(np.load(tmp_path / f"dp_rank{r}.npz")) for r in range(world)]
    for variant in ("planned", "accum", "int8_ef"):
        losses, want = _repro_trajectory(cfg, params, batches, variant)
        for r in ranks:
            close(r[f"{variant}.losses"], np.array(losses))
            for k, v in want.items():
                if variant == "int8_ef":
                    # An element within an ulp of a rounding tie quantizes one
                    # quantum apart in the two packages (ROADMAP's watch list).
                    got = r[f"{variant}.{k}"]
                    off = np.abs(got - v) > TOL * max(1.0, np.abs(v).max())
                    assert off.sum() <= max(2, int(1e-3 * v.size)), (k, off.sum())
                else:
                    close(r[f"{variant}.{k}"], v)
            for k in want:
                np.testing.assert_array_equal(r[f"{variant}.{k}"], ranks[0][f"{variant}.{k}"])


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

REPRO_LAUNCH = """
import sys, json
import jax, jax.numpy as jnp, numpy as np
from repro.launch import train as jlaunch
from repro.runtime import train as jrt
seen = []
real = jrt.run_elastic
def spy(*a, **kw):
    state, history = real(*a, **kw)
    seen.extend(history)
    return state, history
jrt.run_elastic = spy
sys.argv = ["train"] + ARGV
jlaunch.main()
open(OUT, "w").write(json.dumps([h["loss"] for h in seen]))
"""


def test_launcher_mesh_1x2_losses_equal_repro(tmp_path):
    """``--family cnn --smoke --mesh 1x2`` in both launchers from ``repro``'s
    seeded weights (carried across) on the same batches: ``repro``'s under
    2 forced devices on its XLA path (its Pallas conv cannot run
    interpreted on this jax), the port's on 2 gloo ranks with
    ``--planned-kernels`` (the kernels' plain versions on CPU tensors)."""
    argv = ["--family", "cnn", "--smoke", "--mesh", "1x2", "--steps", "3", "--batch",
            str(BATCH), "--log-every", "1"]
    ref = run_repro(f"ARGV = {argv!r}\nOUT = {str(tmp_path / 'repro.json')!r}\n"
                    + REPRO_LAUNCH, devices=2)
    _, params = _repro_cnn()
    np.savez(tmp_path / "init.npz", **params)
    try:
        run_ranks("launcher", 2, tmp_path,
                  {"argv": argv + ["--device", "cpu", "--dist-backend", "gloo",
                                   "--planned-kernels"]}, timeout=TIMEOUT)
    finally:
        join(ref)
    want = json.loads((tmp_path / "repro.json").read_text())
    for r in range(2):
        got = json.loads((tmp_path / f"launcher_rank{r}.json").read_text())
        assert len(got) == len(want) == 3
        close(got, want)


def test_launcher_starts_its_own_ranks(tmp_path):
    """Without a process group the launcher starts one process a rank over
    a ``file://`` store; ``--mesh 2x1`` (data-parallel over 2 ranks) gives
    the single-device run's losses, and prints the sharded plan."""
    from repro_torch.launch import train as launch

    argv = ["--family", "cnn", "--steps", "2", "--batch", "4", "--planned-kernels",
            "--device", "cpu", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv,
                           "--mesh", "2x1", "--dist-backend", "gloo"], env=env, text=True,
                          capture_output=True, timeout=TIMEOUT, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "sharded plan: 12 kernels | modeled step words hbm=" in proc.stdout
    got = [float(line.split("loss ")[1].split()[0]) for line in proc.stdout.splitlines()
           if line.startswith("step ")]
    want = [h["loss"] for h in launch.main(argv)]
    assert len(got) == 2
    close(got, want, tol=1e-3)  # the log prints 4 decimals


def test_one_device_mesh_degenerates_to_the_local_path():
    """A 1-device mesh needs no process group: fc_layer_sharded and
    ring_matmul run the plain per-device path (no collective)."""
    from repro_torch.core.fc_layer import fc_layer_sharded
    from repro_torch.core.ring import ring_matmul
    from repro_torch.runtime import collectives as coll

    mesh = coll.Mesh((1,), ("model",))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    calls = dict(coll.STATS.calls)
    a = fc_layer_sharded(torch.from_numpy(x), torch.from_numpy(w), mesh, axis="model")
    b = ring_matmul(torch.from_numpy(x), torch.from_numpy(w), mesh, axis="model")
    close(a.numpy(), x @ w)
    close(b.numpy(), x @ w)
    assert coll.STATS.calls == calls
