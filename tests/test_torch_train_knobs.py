"""The train-step knobs of the port against the JAX package's, on the CPU:
the TrainConfig fields, int8 error-feedback compression, microbatch
gradient accumulation, rematerialization and the launcher's checkpoint
resume.

Tolerances (f32):
* compression: each decompressed element within one quantum (the tensor's
  scale / 127 ... the scale itself) of repro's, the error buffer likewise;
* trajectories: losses within 1e-4 * max(1, |loss|), parameters within
  1e-3 absolute after 3 steps (as tests/test_torch_train.py: AdamW turns a
  near-zero gradient summed in another order into an lr-sized step); under
  int8 error feedback an element whose gradient sits within an ulp of a
  rounding tie quantizes one quantum apart, so at most 0.1 % of a tensor's
  elements (or 2) may differ by more, by at most 3 lr-sized steps;
* remat and the launcher's resume: bit for bit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticImageSource as JaxImageSource
from repro.data.pipeline import SyntheticSource as JaxSource
from repro.models import cnn as jcnn
from repro.models import transformer as jtf
from repro.models.module import init_params as jax_init_params
from repro.optim import compression as jcomp
from repro.runtime import train as jtr
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import TrainConfig, smoke_config
from repro_torch.convert import flatten_tree, params_from_repro
from repro_torch.data.pipeline import ShardInfo
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro_torch.kernels.matmul.matmul import matmul_kernel
from repro_torch.launch import train as launch
from repro_torch.models import cnn
from repro_torch.models import transformer as tf
from repro_torch.models.module import init_params
from repro_torch.optim import compression
from repro_torch.runtime import train as tr

B, S = 4, 16  # smoke batch (the transformer's sequence length S)


@pytest.mark.parametrize("knob", ["microbatch", "remat", "grad_compression"])
def test_ported_knobs_match_repro(knob):
    """Each knob this slice ports is repro's field with repro's default."""
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert ours[knob] == theirs[knob]


# -- compression -------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale,seed", [((7,), 1.0, 0), ((33, 5), 1e-3, 1),
                                              ((4, 4, 3, 8), 50.0, 2), ((1000,), 1.0, 3)])
def test_compress_decompress_matches_repro(shape, scale, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    err = (rng.standard_normal(shape) * scale * 1e-2).astype(np.float32)
    jdeq, jerr = jcomp.compress_decompress(jnp.asarray(g), jnp.asarray(err))
    deq, new_err = compression.compress_decompress(torch.from_numpy(g), torch.from_numpy(err))
    quantum = max(np.max(np.abs(g + err)), 1e-12) / 127.0
    assert np.max(np.abs(deq.numpy() - np.asarray(jdeq))) <= quantum
    assert np.max(np.abs(new_err.numpy() - np.asarray(jerr))) <= quantum
    # the error buffer carries exactly what the int8 grid dropped
    np.testing.assert_allclose(deq.numpy() + new_err.numpy(), g + err, rtol=0, atol=1e-6 * quantum * 127)


def test_compression_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5])  # scale 1: the ties
    deq, _ = compression.compress_decompress(g, torch.zeros(5))
    jdeq, _ = jcomp.compress_decompress(jnp.asarray(g.numpy()), jnp.zeros(5))
    assert deq.tolist() == [127.0, 0.0, 2.0, 2.0, -0.0] == np.asarray(jdeq).tolist()


def test_compress_tree_and_error_buffers():
    params = {"a": torch.ones(3, 2), "b": torch.ones(4)}
    errs = compression.init_error_buffers(params)
    assert all(e.dtype == torch.float32 and not e.any() for e in errs.values())
    grads = {"a": torch.arange(6.0).reshape(3, 2), "b": torch.full((4,), 0.3)}
    deq, new = compression.compress_tree(grads, errs)
    for k in grads:
        want = compression.compress_decompress(grads[k], errs[k])
        assert torch.equal(deq[k], want[0]) and torch.equal(new[k], want[1])


# -- trajectories against repro's make_train_step ------------------------------------


def _cnn_setup(batch_size):
    jcfg = jax_smoke_config("cnn-vgg11")
    tree = {k: np.asarray(v) for k, v in
            jax_init_params(jcnn.param_defs(jcfg), jax.random.PRNGKey(0)).items()}
    jsrc = JaxImageSource(cnn.IMG, cnn.IN_CH, jcfg.vocab, batch_size, seed=0)
    return jcfg, smoke_config("cnn-vgg11"), tree, jsrc


def _tfm_setup(batch_size):
    jcfg = jax_smoke_config("qwen1.5-0.5b")
    tree = jax.tree.map(np.asarray, jax_init_params(jtf.param_defs(jcfg), jax.random.PRNGKey(0)))
    jsrc = JaxSource(jcfg.vocab, S, batch_size, seed=0)
    return jcfg, smoke_config("qwen1.5-0.5b"), tree, jsrc


def _accumulated(batch: dict, n: int) -> dict:
    """[B, ...] -> [n, B/n, ...] (the leading accumulation dim)."""
    return {k: np.asarray(v).reshape(n, -1, *np.shape(v)[1:]) for k, v in batch.items()}


KNOBS = {"accum": dict(), "int8_ef": dict(grad_compression="int8_ef"),
         "accum+int8_ef": dict(grad_compression="int8_ef")}


@pytest.mark.parametrize("family", ["cnn", "transformer"])
@pytest.mark.parametrize("planned", [True, False])
@pytest.mark.parametrize("knob", list(KNOBS))
def test_three_step_trajectory_with_knobs_matches_repro(family, planned, knob):
    """3 AdamW steps with microbatch accumulation ([2, B/2, ...] batches)
    and/or int8 error feedback: the port's step (planned kernels' plain
    versions, or the plain forward) against repro's
    make_train_step(planned_kernels=False) with the same knobs, from shared
    weights on bit-identical batches."""
    jcfg, cfg, tree, jsrc = (_cnn_setup if family == "cnn" else _tfm_setup)(B)
    kw = dict(param_dtype="float32", compute_dtype="float32", learning_rate=3e-3,
              warmup_steps=1, total_steps=3, loss_chunks=4, **KNOBS[knob])
    jtc = JaxTrainConfig(**kw, remat="none", planned_kernels=False)
    jstep = jax.jit(jtr.make_train_step(jcfg, jtc))
    jstate = jtr.init_state(jcfg, jtc, jax.tree_util.tree_map(jnp.asarray, tree))
    tc = TrainConfig(**kw, remat="none", planned_kernels=planned)
    step = tr.make_train_step(cfg, tc)
    state = tr.init_state(cfg, tc, params_from_repro(tree, device="cpu"))
    accum = knob.startswith("accum")
    for i in range(3):
        batch = _accumulated(jsrc(i), 2) if accum else jsrc(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, tr.batch_to(batch, "cpu"))
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-4 * max(1.0, abs(want)), (i, m, jm)
    assert state.opt.step == 3
    jparams = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    for k, v in state.params.items():
        diff = np.abs(v.numpy() - jparams[k])
        if "int8_ef" not in knob:
            assert np.max(diff) <= 1e-3, k
            continue
        # An element whose f32 gradient lies within an ulp of a rounding tie
        # quantizes one quantum apart in the two packages; AdamW turns that
        # into at most one lr-sized step a step for that element alone.
        flips = int((diff > 1e-3).sum())
        assert flips <= max(2, diff.size // 1000), (k, flips)
        assert np.max(diff) <= 3 * kw["learning_rate"], k
    if "int8_ef" in knob:
        jerr = flatten_tree(jax.tree.map(np.asarray, jstate.err))
        assert state.err.keys() == jerr.keys()
        assert any(bool(e.any()) for e in state.err.values())
    else:
        assert state.err is None


def test_accumulated_step_averages_the_micro_batches():
    """loss_and_grads over [2, B/2, ...] is the mean of the two micro-batch
    passes, summed in f32 in order."""
    cfg = smoke_config("cnn-vgg11")
    params = init_params(cnn.param_defs(cfg), 0, device="cpu")
    batch = tr.batch_to(cnn.data_source(cfg, B, ShardInfo(0, 1), seed=0)(0), "cpu")
    acc = {k: v.reshape(2, B // 2, *v.shape[1:]) for k, v in batch.items()}
    loss_fn = tr.make_loss_fn(cfg, TrainConfig(planned_kernels=True))
    loss, grads = tr.loss_and_grads(loss_fn, params, acc)
    parts = [tr.loss_and_grads(loss_fn, params, {k: v[i] for k, v in acc.items()})
             for i in range(2)]
    assert torch.equal(loss, (parts[0][0] + parts[1][0]) / 2)
    for k in params:
        want = (torch.zeros_like(params[k]) + parts[0][1][k] + parts[1][1][k]) / 2
        assert torch.equal(grads[k], want), k


def test_cnn_plans_at_the_micro_batch(monkeypatch):
    """An accumulated CNN step plans its kernels at the micro-batch's size."""
    cfg = smoke_config("cnn-vgg11")
    seen = []
    real = cnn.plan_training

    def spy(cfg, batch, **kw):
        seen.append(batch)
        return real(cfg, batch, **kw)

    monkeypatch.setattr(cnn, "plan_training", spy)
    tc = TrainConfig(planned_kernels=True)
    params = init_params(cnn.param_defs(cfg), 0, device="cpu")
    batch = tr.batch_to(cnn.data_source(cfg, 8, ShardInfo(0, 1), seed=0)(0), "cpu")
    step = tr.make_train_step(cfg, tc)
    step(tr.init_state(cfg, tc, params), {k: v.reshape(4, 2, *v.shape[1:])
                                          for k, v in batch.items()})
    assert seen == [2]


# -- remat ------------------------------------------------------------------------


def _tfm_case():
    cfg = smoke_config("qwen1.5-0.5b")
    params = init_params(tf.param_defs(cfg), 0, device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    return cfg, params, batch


@pytest.mark.parametrize("planned", [True, False])
@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_gradients_are_bit_identical(planned, remat):
    """Non-reentrant checkpointing keeps the autograd graph: block and dots
    give the loss and every gradient of none, bit for bit."""
    cfg, params, batch = _tfm_case()
    out = {}
    for r in ("none", remat):
        loss_fn = tr.make_loss_fn(cfg, TrainConfig(planned_kernels=planned, loss_chunks=4,
                                                   remat=r))
        out[r] = tr.loss_and_grads(loss_fn, params, batch)
    assert torch.equal(out[remat][0], out["none"][0])
    for k in params:
        assert torch.equal(out[remat][1][k], out["none"][1][k]), k


@pytest.mark.parametrize("remat,extra_mm,extra_fa", [("none", 0, 0), ("block", 4, 1),
                                                     ("dots", 0, 1)])
def test_remat_reruns_the_planned_forward_kernels(monkeypatch, remat, extra_mm, extra_fa):
    """Calls of each kernel (their plain versions on the CPU) in one planned
    step: block runs each layer's four GEMMs and its attention call again
    in the backward pass, dots its attention call; the logits GEMMs never."""
    cfg, params, batch = _tfm_case()
    calls = {"mm": 0, "fa": 0}
    for kern, key in ((matmul_kernel, "mm"), (flash_attention_kernel, "fa")):
        def counting(*a, _plain=kern.plain, _key=key, **kw):
            calls[_key] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(kern, "plain", counting)
    loss_fn = tr.make_loss_fn(cfg, TrainConfig(planned_kernels=True, loss_chunks=4,
                                               remat=remat))
    tr.loss_and_grads(loss_fn, params, batch)
    L = cfg.n_layers
    assert calls == {"mm": 4 * L + 4 + extra_mm * L, "fa": L + extra_fa * L}


def test_remat_name_is_checked():
    cfg, params, batch = _tfm_case()
    with pytest.raises(ValueError, match="remat"):
        tf.forward(cfg, params, batch["tokens"], remat="everything")


@pytest.mark.parametrize("remat", ["none", "block", "dots"])
def test_remat_trajectory_matches_repro(remat):
    """3 AdamW steps of the smoke transformer under each remat against
    repro's plain step with the same remat."""
    jcfg, cfg, tree, jsrc = _tfm_setup(B)
    kw = dict(param_dtype="float32", compute_dtype="float32", learning_rate=3e-3,
              warmup_steps=1, total_steps=3, loss_chunks=4, remat=remat)
    jtc = JaxTrainConfig(**kw, planned_kernels=False)
    jstep = jax.jit(jtr.make_train_step(jcfg, jtc))
    jstate = jtr.init_state(jcfg, jtc, jax.tree_util.tree_map(jnp.asarray, tree))
    tc = TrainConfig(**kw, planned_kernels=True)
    step = tr.make_train_step(cfg, tc)
    state = tr.init_state(cfg, tc, params_from_repro(tree, device="cpu"))
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jsrc(i).items()})
        state, m = step(state, tr.batch_to(jsrc(i), "cpu"))
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-4 * max(1.0, abs(want)), (i, m, jm)


# -- the launcher -------------------------------------------------------------------


class _Killed(Exception):
    pass


def _stop_before(monkeypatch, step):
    """The launcher's data source raises before ``step``, as a killed
    process stops between steps."""
    real = launch.make_data_source

    def source(*args, **kwargs):
        src = real(*args, **kwargs)

        def at(i):
            if i == step:
                raise _Killed(step)
            return src(i)
        return at

    monkeypatch.setattr(launch, "make_data_source", source)


@pytest.mark.parametrize("extra", [[], ["--grad-compression", "int8_ef"]])
def test_launcher_resume_is_bit_identical(tmp_path, monkeypatch, extra):
    """4 steps in one go equal 2 steps, a stop, and a resume of 2, bit for
    bit: the same final checkpoint bytes and the same losses.  (The
    schedule spans --steps, so both runs are --steps 4.)"""
    base = ["--family", "cnn", "--device", "cpu", "--planned-kernels", "--batch", "4",
            "--steps", "4", "--log-every", "1"] + extra
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    hist_a = launch.main(base + ["--ckpt", a])
    with monkeypatch.context() as m:
        _stop_before(m, 2)
        with pytest.raises(_Killed):
            launch.main(base + ["--ckpt", b, "--ckpt-every", "1"])
    assert ckpt.committed_steps(b) == [1]
    hist_b = launch.main(base + ["--ckpt", b, "--ckpt-every", "1"])
    assert [h["step"] for h in hist_b] == [2, 3]
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist_a[2:]]
    assert ckpt.committed_steps(b) == [1, 2, 3]
    da, db = os.path.join(a, "step_0000003"), os.path.join(b, "step_0000003")
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    for name in os.listdir(da):
        with open(os.path.join(da, name), "rb") as fa, open(os.path.join(db, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    with open(os.path.join(da, "index.json")) as f:
        names = set(json.load(f)["leaves"])
    assert ("err/conv0" in names) == bool(extra)


def test_launcher_passes_the_knobs_on(monkeypatch, capsys):
    """--remat, --microbatch and --grad-compression reach TrainConfig; as in
    repro, --microbatch does not split the launcher's batch."""
    seen = {}
    real = tr.make_train_step

    def spy(cfg, tcfg):
        seen["tcfg"] = tcfg
        step = real(cfg, tcfg)

        def wrapped(state, batch):
            seen["ndim"] = batch["tokens"].ndim
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(tr, "make_train_step", spy)
    launch.main(["--family", "transformer", "--device", "cpu", "--steps", "1", "--batch", "2",
                 "--seq", "16", "--planned-kernels", "--remat", "dots", "--microbatch", "1",
                 "--grad-compression", "int8_ef"])
    t = seen["tcfg"]
    assert (t.remat, t.microbatch, t.grad_compression) == ("dots", 1, "int8_ef")
    assert seen["ndim"] == 2
    assert "done: 1 steps" in capsys.readouterr().out


def test_launcher_sets_the_autotune_policy(tmp_path, monkeypatch, capsys):
    from repro_torch.plan import autotune as at

    monkeypatch.setattr(at, "_POLICY", "off")
    monkeypatch.setattr(at, "_CACHE_PATH", None)
    monkeypatch.setattr(at, "_DEVICE", "cuda")
    path = str(tmp_path / "cache.json")
    launch.main(["--family", "cnn", "--device", "cpu", "--steps", "1", "--batch", "2",
                 "--planned-kernels", "--autotune", "cache-only", "--autotune-cache", path])
    assert at.get_policy() == "cache-only" and at._CACHE_PATH == path and at._DEVICE == "cpu"
    assert f"autotune: policy=cache-only cache={path}" in capsys.readouterr().out
