"""The port's elastic runtime against the JAX package's, in one process on
the CPU: ``runtime/chaos.py`` (the spec grammar and its messages, the
seeded victims, the bursts, the torn chunk on checkpoints each package
wrote of one state), ``runtime/fault_tolerance.py`` (torn heartbeats, the
watchdog, the shrink), and ``run_elastic``'s state machine: every scripted
scenario of ``tests/test_chaos.py`` run through both packages'
``run_elastic`` with the same counting ``build`` gives the same build
record, the same history and the same log lines (step times masked); and
the smoke cnn's NaN burst over a torn checkpoint: the port's replayed
tail bit for bit against its own clean run, and losses and parameters
within 1e-4 (relative, and of scale) of ``repro``'s run of the same
scenario from the same weights.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import cnn as jcnn
from repro.models.module import init_params as jax_init_params
from repro.runtime import chaos as jchaos
from repro.runtime import fault_tolerance as jft
from repro.runtime import train as jtr
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import TrainConfig, smoke_config
from repro_torch.convert import params_from_repro
from repro_torch.data.pipeline import ShardInfo, SyntheticImageSource
from repro_torch.optim import adamw
from repro_torch.runtime import chaos
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import train as tr

TOL = 1e-4


def fake_source(step):
    return {"x": np.zeros((1,), np.float32)}


def _raises(fn):
    """The exception ``fn`` raises, as (type name, message)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares what each raises
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# runtime/chaos.py
# ---------------------------------------------------------------------------

SPECS = ["kill@5x2, straggle@3x0.25, corrupt@10, nan@7x3", "kill@5", "nan@4x2,corrupt@3",
         "straggle@9x0.2", "", "  ,kill@0 ,", "corrupt@0"]
BAD_SPECS = ["explode@3", "kill", "kill@x", "nan@2xq", "@3", "kill@5,boom@1"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 11])
def test_chaos_config_parses_and_prints_as_repro(spec, seed):
    got = chaos.ChaosConfig.parse(spec, seed=seed)
    want = jchaos.ChaosConfig.parse(spec, seed=seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)
    if str(got) != "none":  # the banner round-trips (an empty schedule prints "none")
        assert chaos.ChaosConfig.parse(str(got), seed=seed) == got


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_chaos_config_rejects_as_repro(spec):
    got = _raises(lambda: chaos.ChaosConfig.parse(spec))
    assert got is not None and got == _raises(lambda: jchaos.ChaosConfig.parse(spec))


@pytest.mark.parametrize("kill_hosts,dph,n", [(1, 2, 8), (2, 2, 8), (1, 1, 4), (3, 4, 16),
                                              (2, 2, 4), (1, 2, 2), (4, 1, 4)])
def test_host_death_survivor_math_equals_repro(kill_hosts, dph, n):
    cfg = dict(kill_at_step=3, kill_hosts=kill_hosts)
    got = chaos.ChaosMonkey(chaos.ChaosConfig(**cfg), devices_per_host=dph)
    want = jchaos.ChaosMonkey(jchaos.ChaosConfig(**cfg), devices_per_host=dph)
    assert got.host_death(2, n) is None and want.host_death(2, n) is None
    g, w = _raises(lambda: got.host_death(3, n)), _raises(lambda: want.host_death(3, n))
    assert g == w
    if g is None:  # fired: a second call at the step is a replay, and clean
        assert got.host_death(3, n) is None


def test_host_death_refuses_zero_survivors():
    m = chaos.ChaosMonkey(chaos.ChaosConfig(kill_at_step=0, kill_hosts=2), devices_per_host=2)
    with pytest.raises(ValueError, match="no survivors"):
        m.host_death(0, 4)
    dead, survivors = chaos.ChaosMonkey(chaos.ChaosConfig(kill_at_step=3),
                                        devices_per_host=2).host_death(3, 8)
    assert (dead, survivors) == (["host3"], 6)


@pytest.mark.parametrize("at,n", [(4, 2), (0, 1), (2, 3)])
def test_poison_loss_bursts_as_repro(at, n):
    got = chaos.ChaosMonkey(chaos.ChaosConfig(nan_at_step=at, nan_steps=n))
    want = jchaos.ChaosMonkey(jchaos.ChaosConfig(nan_at_step=at, nan_steps=n))
    walk = [0, 1, 2, 3, 4, 5, 6, 7, 4, 5, 2]  # replays after a rollback stay clean
    seq = [(got.poison_loss(s, 1.0), want.poison_loss(s, 1.0)) for s in walk]
    assert [math.isnan(a) for a, _ in seq] == [math.isnan(b) for _, b in seq]
    assert sum(math.isnan(a) for a, _ in seq) == n


def _jax_cnn_state():
    jcfg = jax_smoke_config("cnn-vgg11")
    tcfg = JaxTrainConfig(param_dtype="float32", compute_dtype="float32",
                          learning_rate=1e-3, warmup_steps=1, total_steps=3)
    params = jax_init_params(jcnn.param_defs(jcfg), jax.random.PRNGKey(0), jnp.float32)
    state = jtr.init_state(jcfg, tcfg, params)
    batch = SyntheticImageSource(32, 3, jcfg.vocab, 4, seed=0)(0)
    state, _ = jax.jit(jtr.make_train_step(jcfg, tcfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state


def _port_state(jstate):
    def flat(tree):
        return params_from_repro(jax.tree.map(np.asarray, tree), device="cpu")

    return tr.TrainState(flat(jstate.params),
                         adamw.AdamWState(int(jstate.opt.step), flat(jstate.opt.m),
                                          flat(jstate.opt.v)))


@pytest.fixture(scope="module")
def carried_state():
    jstate = _jax_cnn_state()
    return jstate, _port_state(jstate)


@pytest.mark.parametrize("step,seed,n_chunks", [(3, 0, 2), (4, 0, 4), (3, 7, 1), (10, 3, 8)])
def test_corrupt_chunk_tears_the_same_file_with_the_same_bytes(tmp_path, carried_state,
                                                               step, seed, n_chunks):
    """The same state saved by each package with the same ``n_chunks``:
    ``corrupt_chunk`` picks the same victim and leaves the same bytes."""
    jstate, pstate = carried_state
    a, b = tmp_path / "repro", tmp_path / "port"
    jckpt.save(str(a), step, jstate, n_chunks=n_chunks)
    ckpt.save(str(b), step, pstate, n_chunks=n_chunks)
    va = jchaos.corrupt_chunk(str(a), step, seed=seed)
    vb = chaos.corrupt_chunk(str(b), step, seed=seed)
    assert os.path.relpath(va, a) == os.path.relpath(vb, b)
    da, db = a / f"step_{step:07d}", b / f"step_{step:07d}"
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    for name in os.listdir(da):
        assert (da / name).read_bytes() == (db / name).read_bytes(), name
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_step(str(b), step)


# ---------------------------------------------------------------------------
# runtime/fault_tolerance.py
# ---------------------------------------------------------------------------

TORN = {"torn": '{"step": 0, "ti', "empty": "", "list": "[1, 2]",
        "no_time": '{"step": 3}', "str_time": '{"step": 3, "time": "now"}'}


@pytest.mark.parametrize("kind", sorted(TORN))
def test_monitor_reads_a_torn_heartbeat_as_stale(tmp_path, kind):
    got_dir, want_dir = tmp_path / "port", tmp_path / "repro"
    for d, mod in ((got_dir, ft), (want_dir, jft)):
        d.mkdir()
        mod.Heartbeat("host0", str(d)).beat(5)
        (d / "hb_host1.json").write_text(TORN[kind])
        old = {"step": 1, "time": time.time() - 3600}
        (d / "hb_host2.json").write_text(json.dumps(old))
    got, want = ft.Monitor(str(got_dir), timeout=60), jft.Monitor(str(want_dir), timeout=60)
    assert got.stale_hosts() == want.stale_hosts() == ["host1", "host2"]
    assert got.live_hosts() == want.live_hosts() == ["host0"]
    beat = json.loads((got_dir / "hb_host0.json").read_text())
    assert beat["step"] == 5 and isinstance(beat["time"], float)
    assert not [f for f in os.listdir(got_dir) if f.endswith(".tmp")]


def test_host_failure_message_equals_repro():
    got, want = ft.HostFailure(["host1"], 6), jft.HostFailure(["host1"], 6)
    assert str(got) == str(want) and (got.dead, got.survivors) == (want.dead, want.survivors)


@pytest.mark.parametrize("times", [
    [0.01] * 7 + [0.5],
    [0.01] * 8 + [0.5, 0.01, 0.04],
    [0.1, 0.2] * 20 + [0.61, 0.59],
    [0.01 * (i % 5 + 1) for i in range(40)] + [1.0],
])
@pytest.mark.parametrize("factor,window", [(2.0, 32), (3.0, 8), (3.0, 32)])
def test_straggler_watchdog_equals_repro(times, factor, window):
    got, want = ft.StragglerWatchdog(factor, window), jft.StragglerWatchdog(factor, window)
    assert [got.observe(t) for t in times] == [want.observe(t) for t in times]


@pytest.mark.parametrize("n,model,pod", [(480, 16, 2), (496, 16, 2), (240, 16, None),
                                         (2, 2, None), (4, 2, None), (8, 2, 2), (6, 2, 2),
                                         (250, 16, None), (7, 2, None)])
def test_shrink_mesh_shape_equals_repro(n, model, pod):
    got = _raises(lambda: ft.shrink_mesh_shape(n, model=model, pod=pod))
    assert got == _raises(lambda: jft.shrink_mesh_shape(n, model=model, pod=pod))
    if got is None:
        assert ft.shrink_mesh_shape(n, model=model, pod=pod) == jft.shrink_mesh_shape(
            n, model=model, pod=pod)
    assert ft.shrink_mesh_shape(480, model=16, pod=2) == (2, 15, 16)


# ---------------------------------------------------------------------------
# run_elastic's state machine: both packages, one counting build
# ---------------------------------------------------------------------------


def counting_build(mod, record, start_from=0, **run_kw):
    """``tests/test_chaos.py``'s build, for either package's ``train``
    module: the state counts committed steps, and recovery resets it."""

    def build(n_devices):
        n = 4 if n_devices is None else n_devices
        record.append(n)

        def step_fn(state, batch):
            return {"v": state["v"] + 1}, {"loss": 1.0}

        return mod.ElasticRun(step_fn=step_fn, state={"v": 0}, start=start_from,
                              n_devices=n, devices_per_host=2, **run_kw)

    return build


class ScriptedWatchdog:
    def __init__(self, verdicts):
        self.verdicts = list(verdicts)

    def observe(self, dt):
        return self.verdicts.pop(0) if self.verdicts else False


class FailingHandle:
    def __init__(self, step):
        self.step = step

    def join(self, timeout=None):
        raise RuntimeError(f"disk full writing step {self.step}")


def _slow_build(ft_mod, mod, record):
    wd = ft_mod.StragglerWatchdog(factor=3.0)

    def build(n_devices):
        n = 4 if n_devices is None else n_devices
        record.append(n)
        evicted = len(record) > 1

        def step_fn(state, batch):
            time.sleep(0.25 if not evicted and state["v"] >= 8 else 0.01)
            return {"v": state["v"] + 1}, {"loss": 1.0}

        return mod.ElasticRun(step_fn=step_fn, state={"v": 0}, start=0, n_devices=n,
                              devices_per_host=2, watchdog=wd)

    return build


def _scenario(name, pkg, tmp):
    """(build, steps, run_elastic kwargs, saves) of one scripted scenario
    of ``tests/test_chaos.py`` for one package."""
    mod, ch, ftm, ck = pkg
    record, saves = [], []
    kw = {}
    if name == "host_death":
        build, steps = counting_build(mod, record), 6
        kw["chaos"] = ch.ChaosMonkey(ch.ChaosConfig(kill_at_step=3), devices_per_host=2)
    elif name == "recovery_cap":
        hb = ftm.Heartbeat("host0", tmp)
        with open(os.path.join(tmp, "hb_dead.json"), "w") as f:
            f.write('{"step": 0, "ti')
        build, steps = counting_build(mod, record, heartbeat=hb,
                                      monitor=ftm.Monitor(tmp, timeout=60)), 6
        kw["policy"] = mod.RecoveryPolicy(max_recoveries=2)
    elif name in ("nonfinite_rollback", "nonfinite_skip"):
        n, patience = (2, 2) if name == "nonfinite_rollback" else (1, 3)
        build, steps = counting_build(mod, record), 6
        kw["chaos"] = ch.ChaosMonkey(ch.ChaosConfig(nan_at_step=2, nan_steps=n))
        kw["policy"] = mod.RecoveryPolicy(nonfinite_patience=patience)
    elif name == "straggler_injection":
        build = counting_build(mod, record, watchdog=ftm.StragglerWatchdog(factor=3.0))
        steps = 12
        kw["chaos"] = ch.ChaosMonkey(ch.ChaosConfig(straggle_at_step=9, straggle_seconds=0.2))
    elif name == "patience_zero":
        build, steps = counting_build(mod, record, watchdog=ScriptedWatchdog([True] * 6)), 6
    elif name == "escalates":
        build, steps = counting_build(
            mod, record, watchdog=ScriptedWatchdog([False, True, True, True])), 6
        kw["policy"] = mod.RecoveryPolicy(straggler_patience=3)
    elif name == "clean_step_resets":
        build, steps = counting_build(
            mod, record, watchdog=ScriptedWatchdog([True, False, True, False, True])), 6
        kw["policy"] = mod.RecoveryPolicy(straggler_patience=2)
    elif name == "perpetually_slow":
        build, steps = _slow_build(ftm, mod, record), 12
        kw["policy"] = mod.RecoveryPolicy(straggler_patience=2)
    elif name == "writer_failure":
        def save(step, st):
            saves.append(step)
            return FailingHandle(step)
        build, steps = counting_build(mod, record, save=save, ckpt_every=1), 5
    elif name == "async_saves":
        def save(step, st):
            saves.append(step)
            return ck.save_async(tmp, step, st, n_chunks=1)
        build, steps = counting_build(mod, record, save=save, ckpt_every=2, ckpt_dir=tmp), 5
    elif name == "sync_saves":
        def save(step, st):
            saves.append((step, st["v"]))
        build, steps = counting_build(mod, record, save=save, ckpt_every=2), 5
    else:
        raise KeyError(name)
    return build, steps, kw, record, saves


SCENARIOS = ["host_death", "recovery_cap", "nonfinite_rollback", "nonfinite_skip",
             "straggler_injection", "patience_zero", "escalates", "clean_step_resets",
             "perpetually_slow", "writer_failure", "async_saves", "sync_saves"]
TIMES = re.compile(r"\d+\.\d\ds")
WALL_CLOCK = {"straggler_injection", "perpetually_slow"}  # the real watchdog on real sleeps


def _drive(name, pkg, tmp):
    build, steps, kw, record, saves = _scenario(name, pkg, tmp)
    logs = []
    try:
        state, hist = pkg[0].run_elastic(build, fake_source, steps, log=logs.append, **kw)
        out = {"v": int(state["v"]), "history": [(h["step"], str(h["loss"]), h["skipped"])
                                                 for h in hist]}
    except RuntimeError as e:
        out = {"raised": str(e)}
    committed = pkg[3].committed_steps(tmp) if name == "async_saves" else None
    return dict(out, record=record, saves=saves, committed=committed,
                logs=[TIMES.sub("<t>s", line) for line in logs])


@pytest.mark.parametrize("name", SCENARIOS)
def test_scripted_scenario_equals_repro(tmp_path, name):
    """The same build record, history, log lines, saves and commits."""
    want_dir, got_dir = tmp_path / "repro", tmp_path / "port"
    want_dir.mkdir()
    got_dir.mkdir()
    want = _drive(name, (jtr, jchaos, jft, jckpt), str(want_dir))
    got = _drive(name, (tr, chaos, ft, ckpt), str(got_dir))
    if name in WALL_CLOCK:
        # Real step times: a busy machine may trip the watchdog on another
        # step in either run, so compare what the scenario fixes.
        for run in (got, want):
            assert any("[watchdog] step 9" in line or "dead=['straggler']" in line
                       for line in run.pop("logs"))
            run.pop("history")
    assert got == want
    # The scenario's own assertions (tests/test_chaos.py), on the port.
    expect = {
        "host_death": dict(record=[4, 2], v=6),
        "recovery_cap": dict(record=[4, 2, 2]),
        "nonfinite_rollback": dict(record=[4, 4], v=6),
        "nonfinite_skip": dict(record=[4], v=5),
        "patience_zero": dict(record=[4], v=6),
        "escalates": dict(record=[4, 2], v=6),
        "clean_step_resets": dict(record=[4], v=6),
        "perpetually_slow": dict(record=[4, 2], v=12),
        "writer_failure": dict(saves=[1]),
        "async_saves": dict(committed=[2, 4], v=5),
        "sync_saves": dict(saves=[(2, 3), (4, 5), (4, 5)]),
    }.get(name, {})
    for k, v in expect.items():
        assert got[k] == v, (k, got[k])
    if name == "recovery_cap":
        assert "giving up after 2" in got["raised"]


def test_agree_is_the_identity_on_one_process():
    """``ElasticRun.agree`` sees each step's verdict; a loop given one
    that returns it unchanged runs the JAX package's machine unchanged."""
    seen = []

    def agree(stale, survivors, trips):
        seen.append((list(stale), survivors, list(trips)))
        return stale, survivors, trips

    record, logs = [], []
    build = counting_build(tr, record, watchdog=ScriptedWatchdog([False, True, True, True]),
                           agree=agree)
    state, hist = tr.run_elastic(build, fake_source, 6,
                                 policy=tr.RecoveryPolicy(straggler_patience=3),
                                 log=logs.append)
    assert record == [4, 2] and state["v"] == 6
    assert seen[:4] == [([], 0, []), ([], 0, ["straggler"]), ([], 0, ["straggler"]),
                        ([], 0, ["straggler"])]


def test_a_stopped_run_keeps_its_last_commit(tmp_path):
    """A run stopped by an error between two steps leaves its in-flight
    write committed (the launcher's resume reads it at once)."""
    d = str(tmp_path)

    class Stop(Exception):
        pass

    def source(step):
        if step == 3:
            raise Stop
        return fake_source(step)

    build = counting_build(tr, [], save=lambda s, st: ckpt.save_async(d, s, st),
                           ckpt_every=2, ckpt_dir=d)
    with pytest.raises(Stop):
        tr.run_elastic(build, source, 6, log=lambda *_: None)
    assert ckpt.committed_steps(d) == [2]


# ---------------------------------------------------------------------------
# The smoke cnn: a NaN burst over a torn checkpoint, end to end
# ---------------------------------------------------------------------------

SCEN = dict(corrupt_at_step=3, nan_at_step=4, nan_steps=2, seed=0)


def _tcfg(mod_cfg):
    return mod_cfg(param_dtype="float32", compute_dtype="float32", learning_rate=1e-3,
                   warmup_steps=1, total_steps=6, loss_chunks=2, seed=0)


def _port_build(cfg, tcfg, d, starts, init):
    def build(n_devices):
        state = tr.init_state(cfg, tcfg, params_from_repro(init, device="cpu"))
        start = 0
        restored, last = ckpt.restore_latest(d, state, device="cpu")
        if restored is not None:
            state, start = restored, last + 1
        starts.append(start)

        def save(step, st):
            ckpt.save(d, step, st, n_chunks=2)

        return tr.ElasticRun(step_fn=tr.make_train_step(cfg, tcfg), state=state,
                             start=start, save=save, ckpt_dir=d, ckpt_every=1,
                             log_every=100)

    return build


def _jax_build(cfg, tcfg, d, starts):
    def build(n_devices):
        params = jax_init_params(jcnn.param_defs(cfg), jax.random.PRNGKey(0), jnp.float32)
        state = jtr.init_state(cfg, tcfg, params)
        start = 0
        restored, last = jckpt.restore_latest(
            d, jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state))
        if restored is not None:
            state, start = restored, last + 1
        starts.append(start)

        def save(step, st):
            jckpt.save(d, step, st, n_chunks=2)

        return jtr.ElasticRun(step_fn=jax.jit(jtr.make_train_step(cfg, tcfg)), state=state,
                              start=start, save=save, ckpt_dir=d, ckpt_every=1,
                              log_every=100)

    return build


def test_cnn_nan_rollback_past_a_torn_chunk_bit_for_bit_and_equal_to_repro(tmp_path):
    """``tests/test_chaos.py``'s acceptance scenario on the port: the torn
    step 3 falls back to step 2 (warned), the poisoned updates are
    skipped, and the replayed tail equals a clean run from step 2 bit for
    bit; against ``repro``'s run from the same weights within 1e-4."""
    cfg, jcfg = smoke_config("cnn-vgg11"), jax_smoke_config("cnn-vgg11")
    tcfg, jtcfg = _tcfg(TrainConfig), _tcfg(JaxTrainConfig)
    init = jax.tree.map(np.asarray, jax_init_params(jcnn.param_defs(jcfg),
                                                    jax.random.PRNGKey(0), jnp.float32))
    source = SyntheticImageSource(32, 3, cfg.vocab, 4, ShardInfo(0, 1), seed=0)
    from repro.data.pipeline import SyntheticImageSource as JaxSource

    jsource = JaxSource(32, 3, jcfg.vocab, 4, seed=0)
    for i in range(6):
        for k, v in source(i).items():
            np.testing.assert_array_equal(v, jsource(i)[k])

    runs = {}
    for name, build_of in (("port", lambda d, s: _port_build(cfg, tcfg, d, s, init)),
                           ("repro", lambda d, s: _jax_build(jcfg, jtcfg, d, s))):
        d, starts = str(tmp_path / name), []
        pkg_tr, pkg_chaos = (tr, chaos) if name == "port" else (jtr, jchaos)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, hist = pkg_tr.run_elastic(
                build_of(d, starts), source, 6,
                policy=pkg_tr.RecoveryPolicy(nonfinite_patience=2),
                chaos=pkg_chaos.ChaosMonkey(pkg_chaos.ChaosConfig(**SCEN)),
                log=lambda s: None)
        assert starts == [0, 3], (name, starts)
        assert [h["step"] for h in hist if h["skipped"]] == [4, 5]
        assert any("corrupt" in str(w.message) for w in caught), name
        runs[name] = (state, hist, d)

    state, hist, d = runs["port"]
    ref = ckpt.restore(d, 2, tr.init_state(cfg, tcfg, params_from_repro(init, device="cpu")),
                       device="cpu")
    step_fn, ref_losses = tr.make_train_step(cfg, tcfg), []
    for i in range(3, 6):
        ref, m = step_fn(ref, tr.batch_to(source(i), "cpu"))
        ref_losses.append(float(m["loss"]))
    replay = [h["loss"] for h in hist if not h["skipped"]][-3:]
    assert replay == ref_losses  # bit for bit
    assert state.opt.step == ref.opt.step
    for tree, rtree in ((state.params, ref.params), (state.opt.m, ref.opt.m),
                        (state.opt.v, ref.opt.v)):
        for k in tree:
            assert torch.equal(tree[k], rtree[k]), k

    jstate, jhist, _ = runs["repro"]
    got = [h["loss"] for h in hist if not h["skipped"]]
    want = [h["loss"] for h in jhist if not h["skipped"]]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (got, want)
    jparams = params_from_repro(jax.tree.map(np.asarray, jstate.params), device="cpu")
    for k, v in state.params.items():
        w = jparams[k].double()
        assert (v.double() - w).abs().max() <= TOL * max(1.0, float(w.abs().max())), k
