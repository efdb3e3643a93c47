"""The last dense configs (gemma3-4b, qwen3-32b, chameleon-34b) and the
shape cells against the JAX package, on the CPU: configs and smoke
configs field for field, the shape cells of every arch, the parameter
trees, smoke logits, the loss and every gradient (plain for all three;
planned for qwen3-32b and chameleon-34b, ``repro``'s matmul and flash
kernels interpreted), gemma3's mixed local and global windows through
the forward, the cached decode and the serving engine, the launcher, the
memmap token source, and the block planner at the launched head dim.

Tolerances (f32): logits 1e-5 * max(1, max |ref|); losses and gradients
1e-4 * max(1, max |ref|) (the same function with the sums in another
order); tokens, batches, configs, cells and schedules equal.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import machine as jm
from repro.data import pipeline as jpipe
from repro.models import transformer as jtf
from repro.models.module import init_params as jax_init_params
from repro.plan import planners as jp
from repro.runtime import serve as jsv
from repro.runtime import train as jtr
from repro_torch import configs as tcfgs
from repro_torch.configs import TrainConfig, get_config, smoke_config
from repro_torch.convert import flatten_tree, params_from_repro
from repro_torch.core import machine as tm
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as launch
from repro_torch.models import transformer as tf
from repro_torch.models.module import count_params
from repro_torch.plan import planners as tp
from repro_torch.runtime import serve as sv
from repro_torch.runtime import train as tr
from repro_torch.serve import DONE, BucketLadder, Engine, VirtualClock

TOL, TOL_GRAD = 1e-5, 1e-4
ARCHS = ("gemma3-4b", "qwen3-32b", "chameleon-34b")
PLANNED = ("qwen3-32b", "chameleon-34b")  # gemma3's global_every raises there
PARAMS = {"gemma3-4b": 3_879_925_248, "qwen3-32b": 32_762_123_264,
          "chameleon-34b": 34_293_436_416}
MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]
B, S = 2, 32
# gemma3 with both window kinds inside the smoke depth: layers 0 and 2
# local (a window shorter than the sequences), 1 and 3 global.
WINDOW, GLOBAL_EVERY = 16, 2
LADDER, MAX_SEQ, GEN = [(2, 8), (4, 24)], 32, 6
LENS = [3, 8, 11, 17, 5, 24, 6]


def assert_close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _weights(jcfg, seed=0, noise=0.0):
    """repro's seeded init (plus seeded noise, so greedy streams vary), as
    numpy."""
    tree = jax_init_params(jtf.param_defs(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda l: np.asarray(l) + noise * rng.standard_normal(l.shape).astype(np.float32),
        tree)


def _cfgs(arch, **changes):
    return (dataclasses.replace(jreg.smoke_config(arch), **changes),
            dataclasses.replace(smoke_config(arch), **changes))


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lab = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lab[0, -3:] = -1  # masked positions
    return {"tokens": tok, "labels": lab}


# ---------------------------------------------------------------------------
# Configs, shape cells, parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_smoke_configs_equal_repro(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jreg.get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(
        jreg.smoke_config(arch))


def test_gemma3_smoke_keeps_its_cadence_with_window_64():
    cfg = smoke_config("gemma3-4b")
    assert (cfg.local_window, cfg.global_every) == (64, 6)


def test_arch_ids_equal_repro_in_order():
    assert tcfgs.ARCH_IDS == jreg.ARCH_IDS


def test_shapes_and_run_config_equal_repro():
    assert {k: dataclasses.asdict(v) for k, v in tcfgs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert list(tcfgs.SHAPES) == list(jbase.SHAPES)
    for ours, theirs in ((tcfgs.ShapeConfig, jbase.ShapeConfig),
                         (tcfgs.RunConfig, jbase.RunConfig)):
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(theirs)]
    run = tcfgs.RunConfig(get_config("qwen3-32b"), TrainConfig(), tcfgs.get_shape("train_4k"))
    assert run.shape is tcfgs.SHAPES["train_4k"] and run.model.n_layers == 64


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_shape_cells_equal_repro(arch):
    assert tcfgs.cells(arch) == jreg.cells(arch)
    for name in tcfgs.cells(arch):
        assert dataclasses.asdict(tcfgs.get_shape(name)) == dataclasses.asdict(
            jreg.get_shape(name))
    assert (arch in tcfgs.LONG_CONTEXT_OK) == (arch in jreg.LONG_CONTEXT_OK)
    assert (arch in tcfgs.CNN_ARCHS) == (arch in jreg.CNN_ARCHS)
    assert tcfgs.LONG_CONTEXT_OK == jreg.LONG_CONTEXT_OK
    assert tcfgs.CNN_ARCHS == jreg.CNN_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_equal_repro(arch):
    """Flat paths, shapes and init of the full config equal repro's tree
    (defs only, no tensors)."""
    jdefs = flatten_tree(jtf.param_defs(jreg.get_config(arch)))
    defs = tf.param_defs(get_config(arch))
    assert set(defs) == set(jdefs)
    for k, d in defs.items():
        assert (d.shape, d.init, d.scale, d.fan_in_axis) == (
            jdefs[k].shape, jdefs[k].init, jdefs[k].scale, jdefs[k].fan_in_axis), k
    assert count_params(defs) == PARAMS[arch]


# ---------------------------------------------------------------------------
# Forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_logits_match_repro(arch):
    jcfg, cfg = _cfgs(arch)
    tree = _weights(jcfg, noise=0.1)
    tok = _batch(cfg.vocab)["tokens"]
    jh, _ = jtf.forward(jcfg, tree, jnp.asarray(tok), compute_dtype=jnp.float32)
    params = params_from_repro(tree, device="cpu")
    h, _ = tf.forward(cfg, params, torch.from_numpy(tok))
    assert_close(h, jh)
    assert_close(tf.logits(cfg, params, h), jtf.logits(jcfg, tree, jh))


def _loss_and_grads(jcfg, cfg, planned, jax_planned=None):
    tree = _weights(jcfg)
    batch = _batch(cfg.vocab)
    kw = dict(param_dtype="float32", compute_dtype="float32", planned_kernels=planned,
              loss_chunks=4)
    jkw = dict(kw, planned_kernels=planned if jax_planned is None else jax_planned)
    jloss, jgrads = jax.value_and_grad(jtr.make_loss_fn(jcfg, JaxTrainConfig(
        **jkw, remat="none")))(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    params = {k: v.requires_grad_(True)
              for k, v in params_from_repro(tree, device="cpu").items()}
    loss = tr.make_loss_fn(cfg, TrainConfig(**kw))(params, tr.batch_to(batch, "cpu"))
    grads = torch.autograd.grad(loss, list(params.values()))
    assert_close(float(loss.detach()), float(jloss), TOL_GRAD)
    jgrads = flatten_tree(jgrads)
    for k, g in zip(params, grads):
        assert_close(g, jgrads[k], TOL_GRAD)


@pytest.mark.parametrize("arch,planned", [(a, False) for a in ARCHS]
                         + [(a, True) for a in PLANNED])
def test_loss_and_grads_match_repro(arch, planned):
    """The loss and every gradient against jax.value_and_grad of repro's
    loss at 2 layers (planned: repro's Pallas kernels interpreted)."""
    _loss_and_grads(*_cfgs(arch, n_layers=2), planned)


def test_gemma3_mixed_windows_loss_and_grads_match_repro():
    """Local and global layers with their own RoPE bases, a window shorter
    than the sequence, the scaled embedding and the tied head."""
    _loss_and_grads(*_cfgs("gemma3-4b", local_window=WINDOW, global_every=GLOBAL_EVERY),
                    False)


def test_planned_gemma3_raises_in_both_packages():
    """repro's planned forward refuses gemma3's mixed windows (its scanned
    block would carry them traced); the port's, which once refused them
    too, runs each layer at its own window and RoPE base: its planned loss
    and every gradient against jax.value_and_grad of repro's plain loss."""
    jcfg, _ = _cfgs("gemma3-4b", n_layers=2)
    tok = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="global_every"):
        jtf.forward(jcfg, {}, jnp.asarray(tok), use_kernels=True)
    _loss_and_grads(*_cfgs("gemma3-4b", local_window=WINDOW, global_every=GLOBAL_EVERY),
                    True, jax_planned=False)


# ---------------------------------------------------------------------------
# gemma3's windows through the forward, the cache and the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma3():
    jcfg, cfg = _cfgs("gemma3-4b", local_window=WINDOW, global_every=GLOBAL_EVERY)
    tree = _weights(jcfg, noise=0.5)
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree), params_from_repro(
        tree, device="cpu")


def test_gemma3_layer_meta_equals_repro(gemma3):
    jcfg, cfg, _, _ = gemma3
    jmeta, meta = jtf.layer_meta(jcfg), tf.layer_meta(cfg)
    for k in ("window", "theta"):
        np.testing.assert_array_equal(meta[k].numpy(), np.asarray(jmeta[k]))
    assert meta["window"].tolist() == [WINDOW, -1, WINDOW, -1]


def test_gemma3_forward_with_windows_matches_repro(gemma3):
    jcfg, cfg, jparams, params = gemma3
    tok = _batch(cfg.vocab, seed=4)["tokens"]
    jh, _ = jtf.forward(jcfg, jparams, jnp.asarray(tok), compute_dtype=jnp.float32)
    h, _ = tf.forward(cfg, params, torch.from_numpy(tok))
    assert_close(h, jh)
    # The window bites: the full-attention forward differs.
    h_full, _ = tf.forward(dataclasses.replace(cfg, local_window=None, global_every=0),
                           params, torch.from_numpy(tok))
    assert float((h_full - h).abs().max()) > 1e-3


def test_gemma3_cached_decode_matches_full_forward_and_repro(gemma3):
    """A 12-token prefill, then decodes past the window (16): each step's
    logits against a no-cache forward over the whole sequence and
    against repro's step builders."""
    jcfg, cfg, jparams, params = gemma3
    rng = np.random.default_rng(11)
    tok = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jcache, jlogits = jsv.make_prefill_step(jcfg, MAX_SEQ, "float32", "float32")(
        jparams, {"tokens": jnp.asarray(tok)})
    cache, logits = sv.make_prefill_step(cfg, MAX_SEQ, "float32", "float32")(
        params, {"tokens": torch.from_numpy(tok)})
    assert_close(logits, jlogits)
    jdec, dec = jsv.make_decode_step(jcfg, "float32"), sv.make_decode_step(cfg, "float32")
    seq = torch.from_numpy(tok)
    for pos in range(12, WINDOW + 4):
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        seq = torch.cat([seq, nxt], 1)
        jcache, jlogits = jdec(jparams, jcache, jnp.asarray(nxt.numpy()), pos)
        cache, logits = dec(params, cache, nxt, pos)
        assert_close(logits, jlogits)
        h, _ = tf.forward(cfg, params, seq)
        assert_close(logits[:, -1], tf.logits(cfg, params, h[:, -1:])[:, 0], TOL_GRAD)
    assert seq.shape[1] > WINDOW + 3


def test_gemma3_engine_tokens_equal_repro_engine(gemma3):
    jcfg, cfg, jparams, params = gemma3
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in LENS]
    jengine = jserve.Engine(jcfg, jparams,
                            jserve.BucketLadder(LADDER, max_seq=MAX_SEQ, machine=jm.TPU_V5E),
                            machine=jm.TPU_V5E, clock=jserve.VirtualClock(), queue_depth=32)
    jengine.warmup(policy="off")
    jreqs = [jengine.submit(prompt=p, max_new_tokens=GEN) for p in prompts]
    jengine.run_until_idle()
    engine = Engine(cfg, params, BucketLadder(LADDER, max_seq=MAX_SEQ, machine=tm.TPU_V5E),
                    clock=VirtualClock(), queue_depth=32)
    engine.warmup(policy="off")
    reqs = [engine.submit(prompt=p, max_new_tokens=GEN) for p in prompts]
    engine.run_until_idle()
    assert all(r.state == DONE for r in reqs)
    assert all(r.state == jserve.DONE for r in jreqs)
    got, want = [list(r.tokens) for r in reqs], [list(r.tokens) for r in jreqs]
    assert got == want
    assert len({tuple(t) for t in got}) > 1  # the streams vary: not vacuous
    assert max(len(p) for p in prompts) + GEN > WINDOW  # the window masks keys


def test_gemma3_bucket_cells_at_head_dim_256():
    from repro_torch.serve import Bucket, bucket_cells

    cfg = get_config("gemma3-4b")
    cells = bucket_cells(cfg, Bucket(8, 1024), 2048)
    assert cells == jserve.bucket_cells(jreg.get_config("gemma3-4b"),
                                        jserve.Bucket(8, 1024), 2048)
    assert cells["prefill.attn"][1]["head_dim"] == 256
    assert cells["prefill.qkv"][1]["n"] == (8 + 2 * 4) * 256


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_planned_qwen3_32b_smoke_losses_equal_repro(monkeypatch):
    """``--arch qwen3-32b --smoke --planned-kernels`` in both launchers,
    from repro's seeded init (carried across), on the same batches."""
    from repro.launch import train as jlaunch
    from repro.runtime import train as jrt

    argv = ["--arch", "qwen3-32b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
            "--planned-kernels", "--log-every", "1"]
    seen = []
    real = jrt.run_elastic

    def spy(*args, **kw):
        state, history = real(*args, **kw)
        seen.extend(history)
        return state, history

    monkeypatch.setattr(jrt, "run_elastic", spy)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jlaunch.main()
    want = [h["loss"] for h in seen]

    def carried(defs, seed, *, device=None, dtype=torch.float32):
        tree = jax_init_params(jtf.param_defs(jreg.smoke_config("qwen3-32b")),
                               jax.random.PRNGKey(seed), jnp.float32)
        out = params_from_repro(jax.tree_util.tree_map(np.asarray, tree), device=device)
        assert set(out) == set(defs)
        return out

    monkeypatch.setattr(launch, "init_params", carried)
    history = launch.main(argv + ["--device", "cpu"])
    got = [h["loss"] for h in history]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a - b) <= TOL_GRAD * max(1.0, abs(b)), (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_takes_the_new_archs(arch, capsys):
    history = launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
                           "--batch", "1", "--seq", "16"])
    assert np.isfinite(history[0]["loss"])
    assert f"{arch}-smoke" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The memmap token source
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("shard,step", [((0, 1), 0), ((0, 1), 5), ((1, 2), 3)])
def test_memmap_source_is_bit_identical(tmp_path, dtype, shard, step):
    tokens = np.random.default_rng(9).integers(0, 60000, 4097)
    path = str(tmp_path / "tokens.bin")
    tpipe.write_token_file(path, tokens, dtype)
    with open(path, "rb") as f:
        assert f.read() == np.asarray(tokens, dtype).tobytes()
    ours = tpipe.MemmapSource(path, 50000, 64, 8, tpipe.ShardInfo(*shard), dtype)(step)
    theirs = jpipe.MemmapSource(path, 50000, 64, 8, jpipe.ShardInfo(*shard), dtype)(step)
    assert set(ours) == set(theirs) == {"tokens", "labels"}
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == (8 // shard[1], 64)
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_memmap_source_too_small_raises_in_both(tmp_path):
    path = str(tmp_path / "small.bin")
    tpipe.write_token_file(path, np.arange(100))
    for mod in (tpipe, jpipe):
        with pytest.raises(ValueError, match="too small"):
            mod.MemmapSource(path, 256, 64, 8)


# ---------------------------------------------------------------------------
# The block planner at the launched head dim
# ---------------------------------------------------------------------------


def _fields(s):
    return dataclasses.asdict(s)


def _launched_cells(cfg, batch, seq):
    """The shapes the planned forward launches: the GEMMs at the config's
    resolved head dim, the attention cell at it."""
    Hq, Hkv, Dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    m = batch * seq
    return {
        "qkv": ("matmul", dict(m=m, n=(Hq + 2 * Hkv) * Dh, k=d, in_bytes=4)),
        "attn": ("flash_attention", dict(seq_q=seq, seq_kv=seq, head_dim=Dh, n_q_heads=Hq,
                                         n_kv_heads=Hkv, batch=batch, in_bytes=4,
                                         causal=True)),
        "wo": ("matmul", dict(m=m, n=d, k=Hq * Dh, in_bytes=4)),
        "mlp_up": ("matmul", dict(m=m, n=2 * cfg.d_ff, k=d, in_bytes=4)),
        "mlp_down": ("matmul", dict(m=m, n=d, k=cfg.d_ff, in_bytes=4)),
    }


HEAD_DIM_CASES = [
    ("smoke-hd64", 2, 64),  # the qwen3-32b smoke config at head_dim 64 != 128 / 4
    ("qwen3-32b", 1, 2048),
    ("chameleon-34b", 1, 2048),  # 8192 / 64 = 128: the two head dims agree
    ("gemma3-4b", 1, 2048),
]


def _head_dim_cfg(name):
    if name == "smoke-hd64":
        return dataclasses.replace(smoke_config("qwen3-32b"), head_dim=64)
    return get_config(name)


@pytest.mark.parametrize("machines", MACHINES, ids=["manticore", "tpu_v5e"])
@pytest.mark.parametrize("name,batch,seq", HEAD_DIM_CASES)
def test_planned_cells_equal_repro_planners_at_launched_shapes(machines, name, batch, seq):
    """Every cell of plan_forward and plan_training equals repro's
    MatmulPlanner / AttentionPlanner (and plan_bwd) called at the shape the
    planned step launches."""
    jmach, tmach = machines
    cfg = _head_dim_cfg(name)
    assert (cfg.resolved_head_dim == cfg.d_model // cfg.n_heads) == (name == "chameleon-34b")
    sched = tf.plan_training(cfg, batch, seq, loss_chunks=4, machine=tmach)
    planners = {"matmul": jp.MatmulPlanner(jmach), "flash_attention": jp.AttentionPlanner(jmach)}
    for cell, (op, shape) in _launched_cells(cfg, batch, seq).items():
        assert _fields(sched[cell]) == _fields(planners[op].plan(**shape)), cell
    from repro.core import fc_layer as jfl

    m = batch * seq
    Hq, Hkv, Dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    for cell, (k, n) in {"qkv": (d, (Hq + 2 * Hkv) * Dh), "wo": (Hq * Dh, d)}.items():
        want = jfl.plan_bwd((m, k), (k, n), in_bytes=4, machine=jmach)
        for g, s in want.items():
            assert _fields(sched[f"{cell}.{g}"]) == _fields(s), (cell, g)


@pytest.mark.parametrize("machines", MACHINES, ids=["manticore", "tpu_v5e"])
def test_cell_planners_without_head_dim_equal_repro(machines):
    jmach, tmach = machines
    cfg = _head_dim_cfg("smoke-hd64")
    shape = dict(batch=2, seq=64, d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
                 n_kv_heads=cfg.n_kv_heads, vocab=cfg.vocab)
    want = jp.TransformerBlockPlanner(jmach).cell_planners(**shape)
    got = tp.TransformerBlockPlanner(tmach).cell_planners(**shape)
    assert set(got) == set(want)
    for cell in want:
        assert got[cell][1] == want[cell][1], cell
        assert _fields(got[cell][0].plan(**got[cell][1])) == _fields(
            want[cell][0].plan(**want[cell][1])), cell
    named = tp.TransformerBlockPlanner(tmach).cell_planners(**shape, head_dim=64)
    assert named["attn"][1]["head_dim"] == 64 and got["attn"][1]["head_dim"] == 32


def test_qwen3_32b_attention_cell_is_planned_at_d128_on_the_h100():
    cfg = get_config("qwen3-32b")
    sched = tf.plan_forward(cfg, 1, 2048, loss_chunks=4)
    want = tp.AttentionPlanner(tm.H100).plan(**_launched_cells(cfg, 1, 2048)["attn"][1])
    assert _fields(sched["attn"]) == _fields(want)
    assert sched["attn"].grid[0] == 64  # batch x query heads
    assert sched["qkv"] == tp.MatmulPlanner(tm.H100).plan(m=2048, n=10240, k=5120, in_bytes=4)
    assert sched["wo"] == tp.MatmulPlanner(tm.H100).plan(m=2048, n=5120, k=8192, in_bytes=4)
    with pytest.raises(tp.PlanRejected):  # the head dim the JAX package plans
        tp.AttentionPlanner(tm.H100).candidates(
            **{**_launched_cells(cfg, 1, 2048)["attn"][1], "head_dim": 80})


def test_init_params_draws_each_leaf_from_its_own_generator():
    """The leaves draw on a thread pool; each equals a serial draw from
    its own (seed, crc32(path)) generator, so the thread count changes no
    bit."""
    import math
    import zlib

    from repro_torch.models.module import init_params

    defs = tf.param_defs(smoke_config("qwen3-32b"))
    params = init_params(defs, 3, device="cpu")
    assert list(params) == list(defs)
    for path, d in defs.items():
        if d.init in ("zeros", "ones"):
            assert torch.equal(params[path], torch.full(d.shape, float(d.init == "ones")))
            continue
        fan_in = d.shape[d.fan_in_axis] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        want = np.random.default_rng([3, zlib.crc32(path.encode())]).standard_normal(
            d.shape, dtype=np.float32) * np.float32(scale)
        np.testing.assert_array_equal(params[path].numpy(), want)
