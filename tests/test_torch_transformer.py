"""The port's dense transformer against the JAX package's, on the CPU: the
parameter tree, the plain and planned forwards, the loss and every
gradient, the chunked cross-entropy, the token source, the plan and a
3-step AdamW trajectory, from the same weights (carried across with
``convert``) on the same numpy batches.

Tolerances (f32):
* forwards, losses and gradients: 1e-4 * max(1, max |ref|) — the same
  function with the sums in another order;
* data: bit-identical (both packages draw with numpy);
* trajectory: losses within 1e-4 * max(1, |loss|), parameters within 1e-3
  absolute after 3 steps (AdamW's near-zero-gradient steps, as in
  test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import FAMILY_DEFAULT_ARCH as JAX_FAMILY_DEFAULT_ARCH
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import machine as jm
from repro.data.pipeline import ShardInfo as JaxShardInfo
from repro.data.pipeline import SyntheticSource as JaxSource
from repro.models import transformer as jtf
from repro.models.module import init_params as jax_init_params
from repro.runtime import train as jtr
from repro_torch.configs import FAMILY_DEFAULT_ARCH, TrainConfig, get_config, smoke_config
from repro_torch.convert import flatten_tree, params_from_repro
from repro_torch.core import machine as tm
from repro_torch.data.pipeline import ShardInfo, SyntheticSource
from repro_torch.launch import train as launch
from repro_torch.models import transformer as tf
from repro_torch.models.module import count_params
from repro_torch.models.registry import get_family, make_data_source
from repro_torch.plan import TransformerBlockPlanner
from repro_torch.runtime import train as tr

TOL = 1e-4
B, S = 2, 64


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _cfgs(n_layers=2):
    """The smoke qwen1.5-0.5b of both packages, cut to ``n_layers``."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen1.5-0.5b"), family="transformer",
                               n_layers=n_layers)
    cfg = dataclasses.replace(smoke_config("qwen1.5-0.5b"), family="transformer",
                              n_layers=n_layers)
    return jcfg, cfg


def _weights(jcfg, seed=0):
    tree = jax_init_params(jtf.param_defs(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab[0, -3:] = -1  # masked positions
    return {"tokens": tok, "labels": lab}


def test_configs_and_family_match_repro():
    assert dataclasses.asdict(get_config("qwen1.5-0.5b")) == dataclasses.asdict(
        jax_get_config("qwen1.5-0.5b"))
    assert dataclasses.asdict(smoke_config("qwen1.5-0.5b")) == dataclasses.asdict(
        jax_smoke_config("qwen1.5-0.5b"))
    for fam in ("dense", "transformer"):
        assert FAMILY_DEFAULT_ARCH[fam] == JAX_FAMILY_DEFAULT_ARCH[fam]
        assert get_family(fam) is tf


def test_param_defs_match_repro():
    """Flat paths, shapes and init of the full config equal repro's tree;
    463,987,712 parameters."""
    jdefs = flatten_tree(jtf.param_defs(jax_get_config("qwen1.5-0.5b")))
    defs = tf.param_defs(get_config("qwen1.5-0.5b"))
    assert set(defs) == set(jdefs)
    for k, d in defs.items():
        assert (d.shape, d.init, d.scale, d.fan_in_axis) == (
            jdefs[k].shape, jdefs[k].init, jdefs[k].scale, jdefs[k].fan_in_axis), k
    assert count_params(defs) == 463_987_712


def test_params_from_repro_flattens_nested_trees():
    jcfg, cfg = _cfgs()
    tree = _weights(jcfg)
    got = params_from_repro(tree, device="cpu")
    assert set(got) == set(tf.param_defs(cfg))
    for path, value in flatten_tree(tree).items():
        assert got[path].dtype == torch.float32 and tuple(got[path].shape) == value.shape
        np.testing.assert_array_equal(got[path].numpy(), value)


@pytest.mark.parametrize("planned", [False, True])
def test_forward_matches_repro(planned):
    """Hidden states and logits against repro's forward(use_kernels=False);
    the planned forward also against repro's _forward_planned, its Pallas
    kernels interpreted."""
    jcfg, cfg = _cfgs()
    tree = _weights(jcfg)
    tok = _batch(cfg)["tokens"]
    jh, _ = jtf.forward(jcfg, tree, jnp.asarray(tok), compute_dtype=jnp.float32)
    params = params_from_repro(tree, device="cpu")
    sched = tf.plan_forward(cfg, B, S) if planned else None
    h, cache = tf.forward(cfg, params, torch.from_numpy(tok), use_kernels=planned,
                          schedules=sched)
    assert cache is None
    assert_close(h.numpy(), np.asarray(jh))
    if planned:
        jhp, _ = jtf.forward(jcfg, tree, jnp.asarray(tok), compute_dtype=jnp.float32,
                             use_kernels=True, schedules=jtf.plan_forward(jcfg, B, S))
        assert_close(h.numpy(), np.asarray(jhp))
    jl = jtf.logits(jcfg, tree, jh)
    assert_close(tf.logits(cfg, params, h, schedules=sched).numpy(), np.asarray(jl))


@pytest.mark.parametrize("planned", [False, True])
def test_loss_and_grads_match_repro(planned):
    """The loss and every gradient against jax.value_and_grad of repro's
    loss (planned: its Pallas kernels interpreted)."""
    jcfg, cfg = _cfgs()
    tree = _weights(jcfg)
    batch = _batch(cfg)
    kw = dict(param_dtype="float32", compute_dtype="float32", planned_kernels=planned,
              loss_chunks=4)
    jloss, jgrads = jax.value_and_grad(jtr.make_loss_fn(jcfg, JaxTrainConfig(
        **kw, remat="none")))(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    params = {k: v.requires_grad_(True)
              for k, v in params_from_repro(tree, device="cpu").items()}
    loss = tr.make_loss_fn(cfg, TrainConfig(**kw))(
        params, tr.batch_to(batch, "cpu"))
    grads = torch.autograd.grad(loss, list(params.values()))
    assert_close(float(loss.detach()), float(jloss))
    jgrads = flatten_tree(jgrads)
    for k, g in zip(params, grads):
        assert_close(g.numpy(), np.asarray(jgrads[k]))


@pytest.mark.parametrize("n_chunks", [1, 3, 4])
def test_chunked_ce_matches_repro(n_chunks):
    jcfg, cfg = _cfgs(1)
    tree = _weights(jcfg)
    batch = _batch(cfg)
    h = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want = jtr.chunked_ce(jcfg, jtf, tree, jnp.asarray(h), jnp.asarray(batch["labels"]),
                          n_chunks)
    params = params_from_repro(tree, device="cpu")
    got = tr.chunked_ce(cfg, tf, params, torch.from_numpy(h),
                        torch.from_numpy(batch["labels"]), n_chunks)
    assert_close(float(got), float(want))
    sched = tf.plan_forward(cfg, B, S, loss_chunks=n_chunks)
    planned = tr.chunked_ce(cfg, tf, params, torch.from_numpy(h),
                            torch.from_numpy(batch["labels"]), n_chunks, schedules=sched,
                            head=tf.head_weight(cfg, params))
    assert_close(float(planned), float(want))


@pytest.mark.parametrize("family", ["dense", "transformer", "cnn"])
def test_make_loss_fn_is_the_family_hook(monkeypatch, family):
    """runtime.train.make_loss_fn builds every family's loss through the
    family's own make_loss_fn hook."""
    from repro_torch.models import registry

    fam = registry.FAMILIES[family]
    sentinel = object()
    monkeypatch.setattr(fam, "make_loss_fn", lambda cfg, tcfg: (sentinel, cfg, tcfg))
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, family=family)
    tcfg = TrainConfig(loss_chunks=4)
    assert tr.make_loss_fn(cfg, tcfg) == (sentinel, cfg, tcfg)


@pytest.mark.parametrize("seq,chunks,want", [(64, 4, 4), (30, 4, 3), (7, 8, 7), (5, 0, 1)])
def test_ce_chunks_is_the_largest_divisor(seq, chunks, want):
    """chunked_ce and the logits cell's planned M share one chunk rule."""
    from repro_torch.models.layers import ce_chunks

    assert ce_chunks(seq, chunks) == want
    assert tf._chunk_m(3, seq, chunks) == 3 * seq // want


def test_tied_head_gradient_reaches_embed_twice():
    """The head weight is one contiguous copy of embed^T; embed's gradient
    sums the head's and the lookup's."""
    _, cfg = _cfgs(1)
    params = {k: v.requires_grad_(True) for k, v in
              params_from_repro(_weights(_cfgs(1)[0]), device="cpu").items()}
    head = tf.head_weight(cfg, params)
    assert head.is_contiguous() and tuple(head.shape) == (cfg.d_model, cfg.vocab)
    g_head = torch.autograd.grad(head.sum(), params["embed"])[0]
    assert torch.equal(g_head, torch.ones_like(g_head))


@pytest.mark.parametrize("step,shard", [(0, (0, 1)), (3, (1, 2))])
def test_token_source_is_bit_identical(step, shard):
    ours = SyntheticSource(1000, 32, 4, ShardInfo(*shard), seed=3)(step)
    theirs = JaxSource(1000, 32, 4, JaxShardInfo(*shard), seed=3)(step)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    _, cfg = _cfgs()
    src = make_data_source(cfg, 2, 48, ShardInfo(0, 1), seed=1)
    assert src(0)["tokens"].shape == (2, 48)


def test_plan_training_keys_and_schedules():
    """Every GEMM cell gets dx/dw pins, attention none; the logits cell is
    planned at chunked_ce's chunk M; on TPU_V5E every cell equals repro's."""
    jcfg, cfg = _cfgs()
    sched = tf.plan_training(cfg, B, S, loss_chunks=4, machine=tm.TPU_V5E)
    want = jtf.plan_training(jcfg, B, S, loss_chunks=4, machine=jm.TPU_V5E)
    cells = {"qkv", "attn", "wo", "mlp_up", "mlp_down", "logits"}
    assert set(sched) == set(want) == cells | {
        f"{c}.{g}" for c in cells - {"attn"} for g in ("dx", "dw")}
    for k in want:
        assert dataclasses.asdict(sched[k]) == dataclasses.asdict(want[k]), k
    assert sched["logits"] == tf.plan_forward(cfg, B, S, loss_chunks=4,
                                              machine=tm.TPU_V5E)["logits"]
    assert tf._chunk_m(B, S, 4) == B * S // 4 and tf._chunk_m(2, 30, 4) == 2 * 10


def test_plan_training_h100_picks_for_qwen():
    """The main path's H100 plan: 128/128 flash blocks (230,400 B), the
    matmul kernels' blocks, NT+TN everywhere (the fused dX/dW strip does
    not fit at M = 8192 or at the logits chunk M = 2048)."""
    cfg = get_config("qwen1.5-0.5b")
    sched = tf.plan_training(cfg, 4, 2048, loss_chunks=4)
    assert sched["attn"].block_dict() == {"block_q": 128, "block_kv": 128}
    assert sched["attn"].vmem_bytes == 230_400
    for cell in ("qkv", "wo", "mlp_up", "mlp_down", "logits"):
        assert sched[cell].block_dict() == {"block_m": 64, "block_n": 128, "block_k": 32}
        assert sched[f"{cell}.dx"].algorithm == "direct"
        assert sched[f"{cell}.dx"].fits(tm.H100) and sched[f"{cell}.dw"].fits(tm.H100)
    assert sched["logits"].grid == (32, 1187, 32)


def test_planned_shapes_are_the_launched_shapes(monkeypatch):
    """The block planner plans the head dim the forward launches,
    resolved_head_dim (repro plans d_model // n_heads: the two agree for
    qwen1.5-0.5b (64) and the smoke config (32), not for the smoke width
    at head_dim 64): every fc_layer call of a planned step runs the shape
    its schedule was planned for, and every flash call the attention
    cell's schedule at the launched head dim."""
    from repro_torch.plan import AttentionPlanner, MatmulPlanner, local_schedule

    for cfg in (get_config("qwen1.5-0.5b"), _cfgs()[1]):
        assert cfg.d_model // cfg.n_heads == cfg.resolved_head_dim
    wide = tuple(dataclasses.replace(c, head_dim=64) for c in _cfgs())
    for jcfg, cfg in (wide, _cfgs()):
        sched = tf.plan_training(cfg, B, S, loss_chunks=4)
        seen, attn = [], []
        real, real_flash = tf.fc_layer, tf.flash_attention

        def spy(x, w, schedule, bwd, real=real):
            seen.append((x.shape[0], x.shape[1], w.shape[1], schedule))
            return real(x, w, schedule, bwd)

        def spy_flash(q, k, v, schedule, real_flash=real_flash, **kw):
            attn.append((q.shape[-1], schedule))
            return real_flash(q, k, v, schedule=schedule, **kw)

        monkeypatch.setattr(tf, "fc_layer", spy)
        monkeypatch.setattr(tf, "flash_attention", spy_flash)
        tcfg = TrainConfig(planned_kernels=True, loss_chunks=4, remat="none")
        tf.make_loss_fn(cfg, tcfg)(params_from_repro(_weights(jcfg), device="cpu"),
                                   tr.batch_to(_batch(cfg), "cpu"))
        monkeypatch.undo()
        dh = cfg.resolved_head_dim
        for m, k, n, s in seen:
            assert s == MatmulPlanner(tm.H100).plan(m=m, n=n, k=k, in_bytes=4), (m, k, n)
        assert len(seen) == 4 * cfg.n_layers + 4
        cells = TransformerBlockPlanner(tm.H100).cell_planners(
            batch=B, seq=S, d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
            n_kv_heads=cfg.n_kv_heads, head_dim=dh)
        planned = {(kw["m"], kw["k"], kw["n"]) for name, (_, kw) in cells.items()
                   if name != "attn"}
        planned.add((tf._chunk_m(B, S, 4), cfg.d_model, cfg.vocab))
        assert {(m, k, n) for m, k, n, _ in seen} == planned
        assert (B * S, cfg.d_model, (cfg.n_heads + 2 * cfg.n_kv_heads) * dh) in planned
        want = AttentionPlanner(tm.H100).plan(**cells["attn"][1])
        assert cells["attn"][1]["head_dim"] == dh and sched["attn"] == want
        assert attn == [(dh, local_schedule(want))] * cfg.n_layers


def test_planned_forward_refuses_mixed_windows():
    """The planned forward once refused per-layer windows (``global_every``),
    as repro's still does; it now runs each layer at its own window and
    RoPE base: with a window shorter than the sequence and a second RoPE
    base on the global layers, its hidden states equal the plain
    forward's within TOL (the kernels' plain versions here)."""
    jcfg, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, local_window=16, global_every=2, rope_theta_global=1e6)
    params = params_from_repro(_weights(jcfg), device="cpu")
    tok = torch.from_numpy(_batch(cfg)["tokens"])
    want, _ = tf.forward(cfg, params, tok)
    got, _ = tf.forward(cfg, params, tok, use_kernels=True,
                        schedules=tf.plan_forward(cfg, B, S))
    assert_close(got, want, TOL)


@pytest.mark.parametrize("planned", [True, False])
def test_three_step_trajectory_matches_repro(planned):
    """3 AdamW steps of the smoke transformer — the port's step (planned
    kernels' plain versions, or the plain forward) against repro's
    make_train_step(planned_kernels=False, compute_dtype="float32"), from
    shared weights on bit-identical batches."""
    jcfg, cfg = _cfgs()
    tree = _weights(jcfg)
    kw = dict(param_dtype="float32", compute_dtype="float32", learning_rate=3e-3,
              warmup_steps=1, total_steps=3, loss_chunks=4)
    jtc = JaxTrainConfig(**kw, remat="none", planned_kernels=False)
    jstep = jax.jit(jtr.make_train_step(jcfg, jtc))
    jstate = jtr.init_state(jcfg, jtc, jax.tree_util.tree_map(jnp.asarray, tree))
    tc = TrainConfig(**kw, planned_kernels=planned)
    step = tr.make_train_step(cfg, tc)
    state = tr.init_state(cfg, tc, params_from_repro(tree, device="cpu"))
    jsrc = JaxSource(cfg.vocab, S, B, seed=0)
    src = make_data_source(cfg, B, S, ShardInfo(0, 1), seed=0)
    for i in range(3):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in jsrc(i).items()})
        state, m = step(state, tr.batch_to(src(i), "cpu"))
        want = float(jm_["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-4 * max(1.0, abs(want)), (i, m, jm_)
    jparams = flatten_tree(jstate.params)
    for k, v in state.params.items():
        assert np.max(np.abs(v.numpy() - np.asarray(jparams[k]))) <= 1e-3, k


def test_launcher_trains_the_transformer_on_cpu(capsys):
    history = launch.main(["--family", "transformer", "--device", "cpu", "--steps", "2",
                           "--planned-kernels", "--batch", "2", "--seq", "32"])
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    out = capsys.readouterr().out
    assert "qwen1.5-0.5b-smoke" in out and "planned kernels True" in out
    assert "done: 2 steps" in out
