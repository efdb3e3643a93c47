"""The port's trainer against the JAX package's, on the CPU: the data
source, the AdamW rule, the 3-step trajectory of the smoke CNN and the
launcher.

Tolerances (f32):
* data: bit-identical (both packages draw the batches with numpy);
* one AdamW update on the same numbers: 1e-6 * max(1, max |param|);
* trajectory: losses within 1e-4 * max(1, |loss|), parameters within
  1e-3 absolute after 3 steps — AdamW divides each gradient by its own
  running RMS, so a near-zero gradient summed in another order becomes an
  lr-sized (3e-3) step either way; 1e-3 is a third of one such step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import FAMILY_DEFAULT_ARCH as JAX_FAMILY_DEFAULT_ARCH
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.data.pipeline import ShardInfo as JaxShardInfo
from repro.data.pipeline import SyntheticImageSource as JaxImageSource
from repro.models import cnn as jcnn
from repro.models.module import init_params as jax_init_params
from repro.optim import adamw as jadamw
from repro.runtime import train as jtr
from repro_torch.configs import FAMILY_DEFAULT_ARCH, TrainConfig, smoke_config
from repro_torch.convert import params_from_repro
from repro_torch.data.pipeline import ShardInfo, SyntheticImageSource
from repro_torch.launch import train as launch
from repro_torch.models import cnn
from repro_torch.models.registry import get_family, make_data_source
from repro_torch.optim import adamw
from repro_torch.runtime import train as tr


def test_train_config_matches_repro():
    """Every knob the port reads is one of repro's, with repro's default —
    except compute, which is f32 (the port's kernels are f32)."""
    ours, theirs = dataclasses.asdict(TrainConfig()), dataclasses.asdict(JaxTrainConfig())
    assert set(ours) <= set(theirs)
    assert {k: v for k, v in ours.items() if k != "compute_dtype"} == {
        k: theirs[k] for k in ours if k != "compute_dtype"}
    assert ours["compute_dtype"] == "float32"
    assert FAMILY_DEFAULT_ARCH["cnn"] == JAX_FAMILY_DEFAULT_ARCH["cnn"]


@pytest.mark.parametrize("step,shard", [(0, (0, 1)), (5, (1, 2))])
def test_image_source_is_bit_identical(step, shard):
    ours = SyntheticImageSource(32, 3, 10, 8, ShardInfo(*shard), seed=3)(step)
    theirs = JaxImageSource(32, 3, 10, 8, JaxShardInfo(*shard), seed=3)(step)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    src = make_data_source(smoke_config("cnn-vgg11"), 4, 32, ShardInfo(0, 1), seed=1)
    assert src(0)["images"].shape == (4, cnn.IMG, cnn.IMG, cnn.IN_CH)


def test_family_registry():
    assert get_family("cnn") is cnn
    with pytest.raises(ValueError, match="unknown model family"):
        get_family("rwkv6")


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 5000, 20000])
def test_lr_schedule_matches_repro(step):
    cfg = TrainConfig(warmup_steps=100, total_steps=10000)
    want = float(jadamw.lr_schedule(JaxTrainConfig(warmup_steps=100, total_steps=10000),
                                    jnp.asarray(step)))
    assert abs(adamw.lr_schedule(cfg, step) - want) <= 1e-6 * max(want, 1e-12) + 1e-12


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_repro(grad_clip):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10, grad_clip=grad_clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jadamw.init(jp)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = adamw.init(tp)
    for _ in range(2):
        jp, jstate, jm = jadamw.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate, JaxTrainConfig(**kw))
        tp, tstate, tm = adamw.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in grads.items()}, tstate, TrainConfig(**kw))
    assert tstate.step == int(jstate.step) == 2
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
    for k in params:
        got, want = tp[k].numpy(), np.asarray(jp[k])
        assert np.max(np.abs(got - want)) <= 1e-6 * max(1.0, np.max(np.abs(want)))


def _shared_start(batch):
    cfg = jax_smoke_config("cnn-vgg11")
    np_params = {k: np.asarray(v) for k, v in
                 jax_init_params(jcnn.param_defs(cfg), jax.random.PRNGKey(0)).items()}
    kw = dict(param_dtype="float32", compute_dtype="float32", learning_rate=3e-3,
              warmup_steps=1, total_steps=3)
    return cfg, np_params, kw


@pytest.mark.parametrize("planned", [True, False])
def test_three_step_trajectory_matches_repro(planned):
    """3 AdamW steps of the smoke CNN — the port's step (planned kernels'
    plain versions, or the plain forward) against repro's
    make_train_step(planned_kernels=False, compute_dtype="float32"), from
    shared weights on bit-identical batches."""
    batch = 8
    jcfg, np_params, kw = _shared_start(batch)
    jkw = dict(kw, remat="none", loss_chunks=4)
    jstep = jax.jit(jtr.make_train_step(jcfg, JaxTrainConfig(**jkw, planned_kernels=False)))
    jstate = jtr.init_state(jcfg, JaxTrainConfig(**jkw),
                            {k: jnp.asarray(v) for k, v in np_params.items()})
    tcfg = smoke_config("cnn-vgg11")
    tt = TrainConfig(**kw, planned_kernels=planned)
    step = tr.make_train_step(tcfg, tt)
    state = tr.init_state(tcfg, tt, params_from_repro(np_params, device="cpu"))
    jsrc = JaxImageSource(cnn.IMG, cnn.IN_CH, jcfg.vocab, batch, seed=0)
    src = cnn.data_source(tcfg, batch, ShardInfo(0, 1), seed=0)
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jsrc(i).items()})
        state, m = step(state, tr.batch_to(src(i), "cpu"))
        want = float(jm["loss"])
        assert np.isfinite(float(m["loss"]))
        assert abs(float(m["loss"]) - want) <= 1e-4 * max(1.0, abs(want)), (i, m, jm)
    assert state.opt.step == 3
    for k, v in state.params.items():
        assert np.max(np.abs(v.numpy() - np.asarray(jstate.params[k]))) <= 1e-3, k


@pytest.mark.parametrize("knob", ["zero1"])
def test_unported_knobs_are_absent(knob):
    """A knob the trainer does not read is not offered: setting one fails
    loudly instead of doing nothing."""
    assert knob in {f.name for f in dataclasses.fields(JaxTrainConfig)}
    with pytest.raises(TypeError):
        TrainConfig(**{knob: 1})


def test_launcher_trains_the_family_on_cpu(capsys):
    history = launch.main(["--family", "cnn", "--device", "cpu", "--steps", "2",
                           "--planned-kernels", "--batch", "4"])
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    out = capsys.readouterr().out
    assert "float32 compute" in out and "cnn-vgg11-smoke" in out and "done: 2 steps" in out


def test_launcher_needs_an_arch_or_family():
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu", "--steps", "1"])
