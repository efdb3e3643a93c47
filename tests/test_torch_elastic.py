"""The elastic runtime across processes: the port's ``run_elastic`` run
once in each ``gloo`` rank (``tests/_torch_ranks.py``, a ``file://`` store
under ``tmp_path``, every rank under a timeout), against ``repro``'s
single-controller loop on forced host devices in a JAX subprocess.

Gates: ``tests/test_chaos.py``'s ELASTIC_SCRIPT on 4 ranks (``kill@5`` on
a (data 2, model 2) mesh of the smoke CNN: the incarnations, the executed
steps, the replayed tail and the final state bit for bit against a clean
2-rank run from committed step 4, and the final state within 1e-4 of scale
of ``repro``'s run); the launcher's chaos run (``--mesh 2x2 --chaos
kill@5``) on 4 ranks from ``repro``'s weights (bit for bit against the
launcher's clean run from step 4 on ``--mesh 1x2``, within 1e-4 of scale
of ``repro``'s launcher) and as the CLI fault smoke; a stale heartbeat
through the CLI; and two verdicts only one rank reaches (a stale host, a
watchdog trip), agreed so that both ranks act at the same step.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_ranks import ROOT, run_ranks  # noqa: E402

TOL = 1e-4
TIMEOUT = 120.0
GROUP_TIMEOUT = 60  # seconds a collective of a re-formed group may wait
CHAOS_ARGV = ["--arch", "cnn-vgg11", "--smoke", "--mesh", "2x2", "--steps", "8", "--batch",
              "8", "--ckpt-every", "2", "--log-every", "1", "--chaos", "kill@5",
              "--max-recoveries", "2"]

REPRO = """
import json, sys
sys.path.insert(0, TESTS)
from repro.checkpoint import checkpoint as ckpt
from test_chaos import ELASTIC_SCRIPT
exec(ELASTIC_SCRIPT)
ckpt.save(OUT + "/elastic", 7, state, n_chunks=1)
open(OUT + "/elastic.json", "w").write(json.dumps([h["loss"] for h in hist]))
from repro.launch import train as jlaunch
sys.argv = ["train"] + ARGV + ["--ckpt", OUT + "/launcher"]
jlaunch.main()
"""


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _run(argv, cwd, timeout=TIMEOUT, env=None) -> subprocess.CompletedProcess:
    proc = subprocess.run([sys.executable, *argv], env=env or _env(), text=True,
                          capture_output=True, timeout=timeout, cwd=cwd)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc


def _port_template():
    from repro.configs.registry import smoke_config
    from repro.models import cnn as jcnn
    from repro.models.module import init_params

    from repro_torch.configs import TrainConfig
    from repro_torch.configs import smoke_config as port_smoke
    from repro_torch.convert import params_from_repro
    from repro_torch.runtime import train as tr

    cfg = smoke_config("cnn-vgg11")
    init = jax.tree.map(np.asarray, init_params(jcnn.param_defs(cfg), jax.random.PRNGKey(0),
                                                jnp.float32))
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32")
    state = tr.init_state(port_smoke("cnn-vgg11"), tcfg, params_from_repro(init, device="cpu"))
    return init, state


def _restore(path: Path, step: int, template):
    from repro_torch.checkpoint import checkpoint as ckpt

    return ckpt.restore(str(path), step, template, device="cpu")


def _flat(state) -> dict:
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"m/{k}": v for k, v in state.opt.m.items()})
    out.update({f"v/{k}": v for k, v in state.opt.v.items()})
    return {k: v.numpy() for k, v in out.items()}


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything at once (each part under its own timeout): the JAX
    references, the elastic and launcher rank cases, the two CLI runs and
    the verdicts.  A part that failed re-raises in the tests that read it."""
    base = tmp_path_factory.mktemp("elastic")
    init, template = _port_template()
    dirs = {k: base / k for k in ("repro", "elastic", "launcher", "cli", "stale", "verdicts")}
    for d in dirs.values():
        d.mkdir()
    for k in ("elastic", "launcher"):
        np.savez(dirs[k] / "init.npz", **init)
    stale_hb = dirs["stale"] / "ckpt" / "hb"
    stale_hb.mkdir(parents=True)
    (stale_hb / "hb_host1.json").write_text(json.dumps({"step": 0, "time": 0.0}))
    port_flags = ["--device", "cpu", "--dist-backend", "gloo"]
    env = dict(_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = (f"TESTS = {str(ROOT / 'tests')!r}\nOUT = {str(dirs['repro'])!r}\n"
              f"ARGV = {CHAOS_ARGV!r}\n" + REPRO)
    jobs = {
        "repro": lambda: _run(["-c", script], dirs["repro"], timeout=240, env=env),
        "elastic": lambda: run_ranks("elastic", 4, dirs["elastic"],
                                     {"timeout": GROUP_TIMEOUT}, timeout=TIMEOUT),
        "launcher": lambda: run_ranks(
            "launcher_elastic", 4, dirs["launcher"],
            {"argv": CHAOS_ARGV + port_flags + ["--planned-kernels", "--ckpt",
                                                str(dirs["launcher"] / "ckpt")],
             "shrunk": "1x2"}, timeout=TIMEOUT),
        "cli": lambda: _run(["-m", "repro_torch.launch.train", "--family", "cnn", "--mesh",
                             "2x2", "--steps", "8", "--batch", "8", "--ckpt",
                             str(dirs["cli"] / "ckpt"), "--ckpt-every", "2", "--log-every",
                             "1", "--chaos", "kill@5", "--max-recoveries", "2",
                             *port_flags], dirs["cli"]),
        "stale": lambda: _run(["-m", "repro_torch.launch.train", "--family", "cnn", "--mesh",
                               "1x2", "--steps", "3", "--batch", "8", "--ckpt",
                               str(dirs["stale"] / "ckpt"), "--ckpt-every", "1",
                               "--log-every", "1", *port_flags], dirs["stale"]),
        "verdicts": lambda: run_ranks("verdicts", 2, dirs["verdicts"],
                                      {"timeout": GROUP_TIMEOUT}, timeout=TIMEOUT),
    }
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        done = {}
        for k, f in futures.items():
            try:
                done[k] = f.result()
            except BaseException as e:  # noqa: BLE001 - re-raised by the reading test
                done[k] = e
    return dirs, done, template


def _part(runs, *names):
    dirs, done, template = runs
    for n in names:
        if isinstance(done[n], BaseException):
            raise done[n]
    return dirs, done, template


def _ranks(d: Path, stem: str, world: int) -> list[dict]:
    return [json.loads((d / f"{stem}_rank{r}.json").read_text()) for r in range(world)]


def test_elastic_script_recovers_on_the_survivors_bit_for_bit(runs):
    """``kill@5`` on (data 2, model 2): host1's ranks leave at step 5, the
    survivors re-form a (data 1, model 2) group, resume from committed step
    4, and end bit for bit where a clean 2-rank run from step 4 ends."""
    dirs, _, _ = _part(runs, "elastic")
    recs = _ranks(dirs["elastic"], "elastic", 4)
    for r in (2, 3):
        assert recs[r] == {"left": True, "failed_at": 5, "dead": ["host1"]}
    for r in (0, 1):
        rec = recs[r]
        assert rec["new_rank"] == r
        assert rec["built"] == [[4, {"data": 2, "model": 2}, 0], [2, {"data": 1, "model": 2}, 5]]
        assert rec["steps"] == list(range(8))
        assert rec["losses"][-3:] == rec["ref_losses"]  # bit for bit
        assert rec["same_state"]
        assert any("[recover #1] host failure: dead=['host1'] -> rebuilding on 2 device(s)"
                   in line for line in rec["logs"])
    a, b = (dict(np.load(dirs["elastic"] / f"elastic_rank{r}.npz")) for r in (0, 1))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_elastic_script_final_state_equals_repro(runs):
    """The same function of the global batch: ``repro`` shards parameters
    FSDP-style, the port replicates them."""
    dirs, _, template = _part(runs, "elastic", "repro")
    want = _flat(_restore(dirs["repro"] / "elastic", 7, template))
    got = dict(np.load(dirs["elastic"] / "elastic_rank0.npz"))
    assert int(got.pop("step")) == 8
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])
    losses = json.loads((dirs["repro"] / "elastic.json").read_text())
    ported = _ranks(dirs["elastic"], "elastic", 4)[0]["losses"]
    close(ported, losses)


def test_launcher_chaos_run_bit_for_bit_and_equal_to_repro(runs):
    """The launcher on 4 ranks from ``repro``'s weights: its tail and final
    checkpoint equal, bit for bit, the launcher's clean ``--mesh 1x2`` run
    from a copy of step 4; its final state is ``repro``'s launcher's
    within 1e-4 of scale."""
    dirs, _, template = _part(runs, "launcher", "repro")
    recs = _ranks(dirs["launcher"], "launcher", 4)
    assert [r["left"] for r in recs] == [False, False, True, True]
    for r in recs[:2]:
        assert r["steps"] == list(range(8)) and r["ref_steps"] == [5, 6, 7]
        assert r["losses"][-3:] == r["ref_losses"]
    a, b = dirs["launcher"] / "ckpt" / "step_0000007", dirs["launcher"] / "clean" / "step_0000007"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    got = _flat(_restore(dirs["launcher"] / "ckpt", 7, template))
    want = _flat(_restore(dirs["repro"] / "launcher", 7, template))
    for k in want:
        close(got[k], want[k])


def test_launcher_fault_smoke(runs):
    """``tests/test_chaos.py``'s fault smoke through the port's CLI, which
    starts its own 4 ranks: recovered onto a 1x2 mesh without operator
    input."""
    dirs, done, _ = _part(runs, "cli")
    out = done["cli"].stdout
    for line in ("[recover #1]", "resumed from step 4", "degraded", "sharded plan",
                 "done: 8 steps executed", "chaos: kill@5x1 (seed 0)",
                 "mesh {'data': 1, 'model': 2} (2 devices, degraded)"):
        assert line in out, (line, out)
    assert out.count("killed at step 5") == 2
    from repro_torch.checkpoint import checkpoint as ckpt

    # retain(keep=3) runs beside each write, before it commits.
    assert ckpt.committed_steps(str(dirs["cli"] / "ckpt")) == [2, 4, 6, 7]


def test_a_stale_heartbeat_rebuilds_and_is_evicted(runs):
    """A stale ``hb_host1.json`` (a host outside the 1x2 mesh, left by the
    test): both ranks see it at step 0, rebuild on the same 2 devices, and
    its beat is evicted, so the run goes on."""
    dirs, done, _ = _part(runs, "stale")
    out = done["stale"].stdout
    assert "[recover #1] host failure: dead=['host1'] -> rebuilding on 2 device(s)" in out
    assert "done: 3 steps executed" in out and "[recover #2]" not in out
    assert sorted(os.listdir(dirs["stale"] / "ckpt" / "hb")) == ["hb_host0.json"]


def test_a_verdict_one_rank_reaches_is_agreed(runs):
    """(a) Only rank 1 reads host2 stale; (b) only rank 1's watchdog trips.
    Both ranks act at the same step: (a) a same-size rebuild and the same
    log; (b) host1 evicted at step 2, rank 0 finishing alone."""
    dirs, _, _ = _part(runs, "verdicts")
    r0, r1 = _ranks(dirs["verdicts"], "verdicts", 2)
    for r in (r0, r1):
        assert r["stale"]["record"] == [2, 2] and r["stale"]["v"] == 4
        assert r["stale"]["steps"] == [0, 1, 2, 3]
    masked = [[re.sub(r"\d+\.\d\ds", "<t>s", line) for line in r["stale"]["logs"]]
              for r in (r0, r1)]
    assert masked[0] == masked[1]
    assert any("host failure: dead=['host2'] -> rebuilding on 2 device(s)" in line
               for line in r0["stale"]["logs"])
    assert r1["straggle"] == {"record": [2], "left_at": 2, "dead": ["host1"],
                              "logs": r1["straggle"]["logs"]}
    assert r0["straggle"]["record"] == [2, 1] and r0["straggle"]["world"] == 1
    assert r0["straggle"]["v"] == 4 and r0["straggle"]["steps"][-4:] == [0, 1, 2, 3]
    assert any("[watchdog] step 1" in line for line in r0["straggle"]["logs"])
    assert any("host failure: dead=['host1'] -> rebuilding on 1 device(s)" in line
               for line in r0["straggle"]["logs"])
