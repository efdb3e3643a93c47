"""The port's serving stack (``repro_torch.runtime.serve``,
``repro_torch.serve``) against the JAX package's, on the CPU: bucket
cells, the ladder's routing and warmup, the slot pool, the step builders'
logits and caches, greedy tokens, the engine's tokens, the batched slot
decode against one batch-1 call per slot, the never-tune-at-request-time
contract, queue and deadline degradation, the load generator and its
virtual-clock report, and the serve smoke CLI.

The smoke qwen3-1.7b (qk-norm, GQA 4/2) and qwen1.5-0.5b (qkv bias, MHA)
run from the same weights in both packages: ``repro``'s seeded init
perturbed as ``tests/test_serve.py`` does (so greedy streams vary), carried
across with ``convert``.  The smoke qwen3-moe-235b-a22b (4 experts, top-2,
capacity factor 1.25) runs the same step-builder, greedy and engine
checks, with rows dropped in its bucket prefills; its slot decode
dispatches each slot alone, as ``repro``'s vmap of a batch-1 forward does
(a bucketed engine's MoE tokens need not equal ``greedy_generate``'s:
which rows an expert drops depends on the tokens dispatched with them).
The mesh case of ``tests/test_serve.py`` is ported: a ladder on a mesh
resolves ShardedSchedules, with ``repro``'s strategies and modeled words
(serving on gloo ranks is ``tests/test_torch_moe_mesh.py``).

Tolerances (f32): logits and caches within 1e-5 * max(1, max |ref|) (the
same function with the sums in another order; the MoE's within 1e-4, as
its expert FFN amplifies rounding on the perturbed weights: each package
lies up to 8e-6 of scale from an f64 run); a batched call against
batch-1 calls within 1e-4 * max(1, max |ref|) (GEMMs of another row count
take other BLAS kernels, and the perturbed weights amplify their rounding
through the layers); tokens, routing, cells and the virtual-clock report
equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core.machine import TPU_V5E as JAX_TPU_V5E
from repro.models.module import init_params as jax_init_params
from repro.models.registry import get_family as jax_get_family
from repro.runtime import serve as jsv
from repro import serve as jserve
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.convert import flatten_tree, params_from_repro
from repro_torch.core.machine import H100, TPU_V5E
from repro_torch.models import layers as ll
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.module import init_params
from repro_torch.models.registry import init_cache_slots
from repro_torch.plan import MeshSpec, Schedule, autotune
from repro_torch.runtime import serve as sv
from repro_torch.serve import (
    DONE, QUEUED, SHED, TIMEOUT,
    Bucket, BucketLadder, Engine, LoadSpec, Request, RequestQueue,
    VirtualClock, bucket_cells, make_requests, run_load,
)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
TOL_SHAPES = 1e-4  # a batched call against batch-1 calls
TOL_MOE = 1e-4  # the MoE's step builders against repro's
ARCHS = ("qwen3-1.7b", "qwen1.5-0.5b")
MOE = "qwen3-moe-235b-a22b"
# The engine parity run: ragged lengths that straddle both seq rungs and
# both batch rungs (as tests/test_serve.py's bit-identity case).
LADDER, MAX_SEQ = [(2, 8), (4, 24)], 32
LENS, GEN = [3, 8, 11, 17, 5, 24, 6], 6
LOAD = LoadSpec(qps=50_000.0, n_requests=10, prompt_len=(3, 14), new_tokens=(2, 4), seed=1)


def assert_close(got, want, tol=TOL):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


@dataclasses.dataclass
class Model:
    jcfg: object
    cfg: object
    jparams: dict
    params: dict


def _model(arch: str) -> Model:
    """One smoke arch in both packages from the same perturbed weights."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    base = jax_init_params(jax_get_family(jcfg.family).param_defs(jcfg),
                           jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(7)
    tree = jax.tree_util.tree_map(
        lambda l: np.asarray(l) + rng.standard_normal(l.shape).astype(np.float32) * 0.5,
        base)
    return Model(jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                 params_from_repro(tree, device="cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def moe_model():
    return _model(MOE)


@pytest.fixture(scope="module", params=ARCHS + (MOE,))
def slot_model(request):
    """The dense models, and the MoE with its router zeroed: every
    token's expert probabilities tie, so every slot picks experts 0 and 1
    (ties go to the lower index) and the slots collide in one dispatch."""
    m = _model(request.param)
    if request.param == MOE:
        m.params["layers/moe/router"].zero_()
    return m


@pytest.fixture(scope="module")
def qwen3():
    """The config ``tests/test_serve.py`` runs, for the cases it has once."""
    return _model("qwen3-1.7b")


def _prompts(vocab, lens=LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _boot(cfg, params, buckets, max_seq, *, policy="off", machine=H100, **kw):
    kw.setdefault("queue_depth", 32)
    engine = Engine(cfg, params, BucketLadder(buckets, max_seq=max_seq, machine=machine), **kw)
    engine.warmup(policy=policy)
    return engine


def _drive(engine, prompts):
    """The virtual-clock load run, then the ragged prompts through the
    same engine (their slots are backfilled after the load run's)."""
    report = run_load(engine, LOAD)
    reqs = [engine.submit(prompt=p, max_new_tokens=GEN) for p in prompts]
    engine.run_until_idle()
    return report, reqs


@pytest.fixture(scope="module")
def repro_engine_run(model):
    """``repro``'s engine on TPU_V5E under a VirtualClock: its load report
    and its tokens for the ragged prompts."""
    engine = jserve.Engine(model.jcfg, model.jparams,
                           jserve.BucketLadder(LADDER, max_seq=MAX_SEQ, machine=JAX_TPU_V5E),
                           machine=JAX_TPU_V5E, clock=jserve.VirtualClock(), queue_depth=32)
    engine.warmup(policy="off")
    report, reqs = _drive(engine, _prompts(model.cfg.vocab))
    assert all(r.state == jserve.DONE for r in reqs)
    return report, [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def moe_engine_runs(moe_model):
    """repro's engine and the port's on the smoke MoE (capacity factor
    1.25): their load reports, their tokens for the ragged prompts, and
    the rows the port's dispatches dropped."""
    engine = jserve.Engine(moe_model.jcfg, moe_model.jparams,
                           jserve.BucketLadder(LADDER, max_seq=MAX_SEQ, machine=JAX_TPU_V5E),
                           machine=JAX_TPU_V5E, clock=jserve.VirtualClock(), queue_depth=32)
    engine.warmup(policy="off")
    want = _drive(engine, _prompts(moe_model.cfg.vocab))
    dropped, route = [], moe._route

    def spy(*args):
        out = route(*args)
        dropped.append(int((~out[1]).sum()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "_route", spy)
        engine = _boot(moe_model.cfg, moe_model.params, LADDER, MAX_SEQ, machine=TPU_V5E,
                       clock=VirtualClock())
        got = _drive(engine, _prompts(moe_model.cfg.vocab))
    return want, got, dropped


@pytest.fixture(scope="module")
def port_engine_run(model):
    engine = _boot(model.cfg, model.params, LADDER, MAX_SEQ, machine=TPU_V5E,
                   clock=VirtualClock())
    report, reqs = _drive(engine, _prompts(model.cfg.vocab))
    assert all(r.state == DONE for r in reqs)
    return report, [list(r.tokens) for r in reqs]


# ---------------------------------------------------------------------------
# The config and the cells
# ---------------------------------------------------------------------------


def test_qwen3_config_matches_repro():
    assert "qwen3-1.7b" in ARCH_IDS
    assert dataclasses.asdict(get_config("qwen3-1.7b")) == dataclasses.asdict(
        jax_get_config("qwen3-1.7b"))
    assert dataclasses.asdict(smoke_config("qwen3-1.7b")) == dataclasses.asdict(
        jax_smoke_config("qwen3-1.7b"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bucket,max_seq", [((2, 8), 32), ((4, 256), 2048), ((8, 1024), 2048)])
def test_bucket_cells_equal_repro(arch, bucket, max_seq):
    for cfg_of in ((get_config, jax_get_config), (smoke_config, jax_smoke_config)):
        cfg, jcfg = cfg_of[0](arch), cfg_of[1](arch)
        assert bucket_cells(cfg, Bucket(*bucket), max_seq) == jserve.bucket_cells(
            jcfg, jserve.Bucket(*bucket), max_seq)


# ---------------------------------------------------------------------------
# BucketLadder: rungs, routing, warmup resolution (as tests/test_serve.py)
# ---------------------------------------------------------------------------


class TestBucketLadder:
    def test_rungs_sorted_and_deduped(self):
        lad = BucketLadder([(4, 16), (2, 8), Bucket(2, 8)], max_seq=32)
        assert lad.buckets == (Bucket(2, 8), Bucket(4, 16))
        assert lad.max_batch == 4 and lad.max_prompt == 16

    def test_validation(self):
        with pytest.raises(ValueError, match="at least one bucket"):
            BucketLadder([], max_seq=32)
        with pytest.raises(ValueError, match="exceeds max_seq"):
            BucketLadder([(2, 64)], max_seq=32)
        with pytest.raises(ValueError, match=">= 1"):
            Bucket(0, 8)

    @pytest.mark.parametrize("n,plen", [(1, 5), (2, 8), (1, 9), (3, 5), (7, 12), (9, 10),
                                        (1, 17), (4, 16), (8, 16)])
    def test_route_equals_repro(self, n, plen):
        for rungs in ([(2, 8), (4, 16), (8, 16)], [(2, 8), (4, 16)]):
            got = BucketLadder(rungs, max_seq=32).route(n, plen)
            want = jserve.BucketLadder(rungs, max_seq=32).route(n, plen)
            assert (got is None and want is None) or (got.batch, got.seq) == (
                want.batch, want.seq)

    def test_route_picks_smallest_covering_rung(self):
        lad = BucketLadder([(2, 8), (4, 16), (8, 16)], max_seq=32)
        assert lad.route(1, 5) == Bucket(2, 8)
        assert lad.route(2, 8) == Bucket(2, 8)
        assert lad.route(1, 9) == Bucket(4, 16)
        assert lad.route(3, 5) == Bucket(4, 16)
        assert lad.route(7, 12) == Bucket(8, 16)

    def test_route_widest_when_no_rung_has_enough_rows(self):
        lad = BucketLadder([(2, 8), (4, 16)], max_seq=32)
        assert lad.route(9, 10) == Bucket(4, 16)

    def test_route_none_for_oversize_prompt(self):
        lad = BucketLadder([(2, 8), (4, 16)], max_seq=32)
        assert lad.route(1, 17) is None

    def test_bucket_cells_shapes(self):
        cfg = smoke_config("qwen3-1.7b")
        cells = bucket_cells(cfg, Bucket(2, 8), max_seq=32)
        assert set(cells) == {f"{p}.{c}" for p in ("prefill", "decode")
                              for c in ("qkv", "attn", "mlp", "logits")}
        op, shp = cells["prefill.qkv"]
        assert op == "matmul" and shp["m"] == 2 * 8 and shp["k"] == cfg.d_model
        op, shp = cells["decode.attn"]
        assert op == "flash_attention"
        assert shp["seq_q"] == 1 and shp["seq_kv"] == 32 and shp["causal"]
        assert cells["prefill.logits"][1]["m"] == 2

    def test_warmup_resolves_plans_and_model(self):
        cfg = smoke_config("qwen3-1.7b")
        lad = BucketLadder([(2, 8), (4, 16)], max_seq=24)
        with pytest.raises(RuntimeError, match="warmup"):
            lad.modeled_words(Bucket(2, 8), "prefill")
        sources = lad.warmup(cfg, policy="off")
        assert lad.planned
        for b in lad.buckets:
            assert all(isinstance(p, Schedule) for p in lad.plans[b].values())
            assert set(sources[b].values()) <= {"modeled"}  # policy off
            for phase in ("prefill", "decode"):
                assert lad.modeled_words(b, phase) > 0
                assert lad.modeled_seconds(b, phase) > 0
        assert (lad.modeled_words(Bucket(4, 16), "prefill")
                > lad.modeled_words(Bucket(4, 16), "decode"))

    def test_modeled_words_equal_repro_on_tpu_v5e(self):
        cfg, jcfg = smoke_config("qwen3-1.7b"), jax_smoke_config("qwen3-1.7b")
        lad = BucketLadder([(2, 8), (4, 16)], max_seq=24, machine=TPU_V5E)
        jlad = jserve.BucketLadder([(2, 8), (4, 16)], max_seq=24, machine=JAX_TPU_V5E)
        lad.warmup(cfg, policy="off")
        jlad.warmup(jcfg, policy="off")
        for b, jb in zip(lad.buckets, jlad.buckets):
            for phase in ("prefill", "decode"):
                assert lad.modeled_words(b, phase) == jlad.modeled_words(jb, phase)
                assert lad.modeled_seconds(b, phase) == jlad.modeled_seconds(jb, phase)

    def test_mesh_of_more_than_one_device_raises(self):
        """A mesh of more than one device no longer raises: its cells
        resolve to ShardedSchedules, and on TPU_V5E each strategy and the
        modeled words equal ``repro``'s (``test_warmup_on_mesh_resolves_
        sharded_schedules`` of ``tests/test_serve.py``)."""
        from repro.plan import MeshSpec as JMeshSpec
        from repro.plan import ShardedSchedule as JSharded
        from repro_torch.plan import ShardedSchedule

        cfg, jcfg = smoke_config("qwen3-1.7b"), jax_smoke_config("qwen3-1.7b")
        lad = BucketLadder([(2, 8)], max_seq=16, mesh=MeshSpec((("model", 4),)),
                           machine=TPU_V5E)
        jlad = jserve.BucketLadder([(2, 8)], max_seq=16, mesh=JMeshSpec((("model", 4),)),
                                   machine=JAX_TPU_V5E)
        lad.warmup(cfg, policy="off")
        jlad.warmup(jcfg, policy="off")
        plans, jplans = lad.plans[Bucket(2, 8)], jlad.plans[jlad.buckets[0]]
        assert all(isinstance(p, ShardedSchedule) for p in plans.values())
        assert all(isinstance(p, JSharded) for p in jplans.values())
        assert {k: (p.strategy, p.modeled_words) for k, p in plans.items()} == {
            k: (p.strategy, p.modeled_words) for k, p in jplans.items()}
        for phase in ("prefill", "decode"):
            assert lad.modeled_words(Bucket(2, 8), phase) == jlad.modeled_words(
                jlad.buckets[0], phase)


# ---------------------------------------------------------------------------
# The slot pool: family-dispatched allocation
# ---------------------------------------------------------------------------


class TestInitCacheSlots:
    def test_dense_slot_axis_contract(self):
        cfg = smoke_config("qwen3-1.7b")
        cache = init_cache_slots(cfg, n_slots=3, max_seq=16, dtype=torch.float32,
                                 device="cpu")
        want = jax_get_family("dense").init_cache(jax_smoke_config("qwen3-1.7b"), 3, 16,
                                                  jnp.float32)
        for name, leaf in cache.items():
            assert leaf.shape[1] == 3  # slots on axis 1 of every leaf
            assert tuple(leaf.shape) == want[name].shape and not leaf.any()

    @pytest.mark.parametrize("arch", [MOE, "rwkv6-1.6b", "zamba2-1.2b", "seamless-m4t-medium"])
    def test_every_family_slot_axis_contract(self, arch):
        """Every token family's cache: repro's leaves (flattened), zeros,
        the slot on axis 1."""
        cache = init_cache_slots(smoke_config(arch), n_slots=3, max_seq=16,
                                 dtype=torch.float32, device="cpu")
        jcfg = jax_smoke_config(arch)
        want = flatten_tree(jax_get_family(jcfg.family).init_cache(jcfg, 3, 16, jnp.float32))
        assert set(cache) == set(want)
        for name, leaf in cache.items():
            assert leaf.shape[1] == 3 and not leaf.any()
            assert tuple(leaf.shape) == want[name].shape and leaf.dtype == torch.float32 or (
                name in ("wkv", "mamba/ssd"))

    def test_family_without_cache_raises(self):
        with pytest.raises(ValueError, match="cnn"):
            init_cache_slots(smoke_config("cnn-vgg11"), n_slots=2, max_seq=16,
                             dtype=torch.float32, device="cpu")


# ---------------------------------------------------------------------------
# The step builders against repro's: logits and cache contents
# ---------------------------------------------------------------------------


def _np_cache(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


def _prefill_and_decode_match(model, tol=TOL):
    rng = np.random.default_rng(11)
    tok = rng.integers(0, model.cfg.vocab, (2, 7)).astype(np.int32)
    jcache, jlogits = jsv.make_prefill_step(model.jcfg, 16, "float32", "float32")(
        model.jparams, {"tokens": jnp.asarray(tok)})
    cache, logits = sv.make_prefill_step(model.cfg, 16, "float32", "float32")(
        model.params, {"tokens": torch.from_numpy(tok)})
    assert_close(logits, jlogits, tol)
    for k, v in _np_cache(jcache).items():
        assert_close(cache[k], v, tol)
    jdec, dec = jsv.make_decode_step(model.jcfg, "float32"), sv.make_decode_step(
        model.cfg, "float32")
    nxt = np.argmax(np.asarray(jlogits)[:, -1], -1).astype(np.int32)[:, None]
    for pos in (7, 8):
        jcache, jlogits = jdec(model.jparams, jcache, jnp.asarray(nxt), pos)
        cache, logits = dec(model.params, cache, torch.from_numpy(nxt), pos)
        assert_close(logits, jlogits, tol)
        for k, v in _np_cache(jcache).items():
            assert_close(cache[k], v, tol)
        nxt = np.argmax(np.asarray(jlogits)[:, -1], -1).astype(np.int32)[:, None]


def test_prefill_and_decode_match_repro(model):
    _prefill_and_decode_match(model)


def _bucket_prefill_and_slot_decode_match(model, tol=TOL):
    rng = np.random.default_rng(12)
    lens = np.array([5, 12, 1], np.int32)
    tok = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        tok[i, :n] = rng.integers(0, model.cfg.vocab, n)
    jcache, jlogits = jsv.make_bucket_prefill_step(model.jcfg, 20)(
        model.jparams, jnp.asarray(tok), jnp.asarray(lens))
    cache, logits = sv.make_bucket_prefill_step(model.cfg, 20)(
        model.params, torch.from_numpy(tok), torch.from_numpy(lens))
    assert logits.shape == (3, model.cfg.vocab)
    assert_close(logits, jlogits, tol)
    for k, v in _np_cache(jcache).items():
        assert_close(cache[k], v, tol)
    jdec, dec = jsv.make_slot_decode_step(model.jcfg), sv.make_slot_decode_step(model.cfg)
    pos = lens.copy()
    nxt = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    for _ in range(3):  # each slot at its own position
        jcache, jlogits = jdec(model.jparams, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        cache, logits = dec(model.params, cache, torch.from_numpy(nxt), torch.from_numpy(pos))
        assert_close(logits, jlogits, tol)
        for k, v in _np_cache(jcache).items():
            assert_close(cache[k], v, tol)
        nxt = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
        pos += 1


def test_bucket_prefill_and_slot_decode_match_repro(model):
    _bucket_prefill_and_slot_decode_match(model)


def test_moe_step_builders_match_repro(moe_model):
    """The MoE through the four step builders: the whole-batch prefill and
    decode dispatch every row together, the slot decode each slot alone
    (repro's vmap), the bucket prefill every padded token together.  At
    TOL_MOE: on the perturbed weights the expert FFN amplifies f32
    rounding, and both packages' caches lie up to 8e-6 of scale from an
    f64 run of the same prefill."""
    _prefill_and_decode_match(moe_model, TOL_MOE)
    _bucket_prefill_and_slot_decode_match(moe_model, TOL_MOE)


def _greedy_generate_equal(model):
    prompt = _prompts(model.cfg.vocab, lens=[9], seed=13)[0][None, :]
    want = np.asarray(jsv.greedy_generate(model.jcfg, model.jparams, jnp.asarray(prompt),
                                          steps=GEN, max_seq=MAX_SEQ))
    got = sv.greedy_generate(model.cfg, model.params, torch.from_numpy(prompt), steps=GEN,
                             max_seq=MAX_SEQ)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_greedy_generate_equals_repro(model):
    _greedy_generate_equal(model)


def test_moe_greedy_generate_equals_repro(moe_model):
    _greedy_generate_equal(moe_model)


def test_cache_write_clamps_like_dynamic_update_slice(qwen3):
    """A block written past the cache's end lands at Smax - S, per row too,
    as ``jax.lax.dynamic_update_slice`` clamps its start."""
    rng = np.random.default_rng(14)
    k = torch.from_numpy(rng.standard_normal((2, 3, 2, 4)).astype(np.float32))
    for pos0, starts in ((7, (5, 5)), (torch.tensor([1, 9]), (1, 5))):
        cache = (torch.zeros(2, 8, 2, 4), torch.zeros(2, 8, 2, 4))
        ll.write_cache(cache, k, -k, pos0)
        for b, s in enumerate(starts):
            want = jax.lax.dynamic_update_slice(jnp.zeros((8, 2, 4)), k[b].numpy(), (s, 0, 0))
            assert torch.equal(cache[0][b], torch.from_numpy(np.array(want)))
            assert torch.equal(cache[1][b], -cache[0][b])


def test_cached_decode_equals_no_cache_forward_in_f64(monkeypatch):
    """The bucket prefill and slot decodes against a no-cache forward over
    the prompt and the tokens so far, on a 24-layer smoke qwen1.5-0.5b with
    the perturbed weights, computed in float64 throughout (the layers' f32
    upcasts made f64): the two paths are the same function to 1e-10 of
    scale.  (In f32 a flat N(0, 0.5) on every leaf of a 24-layer network
    amplifies rounding to well past 1e-5; the card's check serves noise
    scaled to each leaf's init std.)"""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    cfg = dataclasses.replace(smoke_config("qwen1.5-0.5b"), n_layers=24)
    rng = np.random.default_rng(7)
    params = {k: (v + torch.from_numpy(rng.standard_normal(tuple(v.shape)) * 0.5)).double()
              for k, v in sorted(init_params(tf.param_defs(cfg), 0, device="cpu").items())}
    prompt = torch.from_numpy(_prompts(cfg.vocab, lens=[60], seed=17)[0])
    prefill = sv.make_bucket_prefill_step(cfg, 96, torch.float64, torch.float64)
    decode = sv.make_slot_decode_step(cfg, torch.float64)
    padded = torch.zeros((1, 64), dtype=torch.int32)
    padded[0, :60] = prompt
    pos = torch.tensor([60], dtype=torch.int32)
    cache, logits = prefill(params, padded, pos)
    seq = prompt
    for _ in range(6):
        with torch.no_grad():
            h, _ = tf.forward(cfg, params, seq[None], compute_dtype=torch.float64)
            ref = tf.logits(cfg, params, h[:, -1:])[0, 0]
        assert_close(logits[0], ref.numpy(), 1e-10)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        seq = torch.cat([seq, nxt])
        cache, logits = decode(params, cache, nxt, pos)
        pos = pos + 1
    assert len(set(seq[60:].tolist())) > 1


@pytest.mark.parametrize("remat", ["block", "dots"])
def test_cached_forward_under_remat_equals_none(qwen3, remat):
    """Under remat the cached forward wraps the same segments, as the JAX
    package checkpoints its cached scan body: the same hidden states and
    cache bits as without it."""
    tok = torch.from_numpy(_prompts(qwen3.cfg.vocab, lens=[6], seed=15)[0][None, :])
    out = {}
    for r in ("none", remat):
        cache = tf.init_cache(qwen3.cfg, 1, 12, torch.float32, device="cpu")
        with torch.no_grad():
            out[r] = tf.forward(qwen3.cfg, qwen3.params, tok, pos0=2, cache=cache, remat=r)
    assert torch.equal(out["none"][0], out[remat][0])
    for k in ("k", "v"):
        assert torch.equal(out["none"][1][k], out[remat][1][k])


# ---------------------------------------------------------------------------
# The engine: tokens against repro's engine and against greedy_generate
# ---------------------------------------------------------------------------


def test_engine_tokens_equal_repro_engine(repro_engine_run, port_engine_run):
    want, got = repro_engine_run[1], port_engine_run[1]
    assert got == want
    assert len({tuple(t) for t in got}) > 1  # the streams vary: not vacuous


def test_virtual_clock_load_report_equals_repro_on_tpu_v5e(repro_engine_run,
                                                           port_engine_run):
    want, got = repro_engine_run[0], port_engine_run[0]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.completed == LOAD.n_requests


def test_moe_engine_tokens_equal_repro_engine(moe_engine_runs):
    """At capacity factor 1.25, where the bucket prefills drop rows, the
    port's engine gives repro's tokens and its virtual-clock report."""
    (jreport, jreqs), (report, reqs), dropped = moe_engine_runs
    assert all(r.state == DONE for r in reqs) and all(r.state == jserve.DONE for r in jreqs)
    got, want = [list(r.tokens) for r in reqs], [list(r.tokens) for r in jreqs]
    assert got == want
    assert len({tuple(t) for t in got}) > 1
    assert sum(dropped) > 0
    assert dataclasses.asdict(report) == dataclasses.asdict(jreport)


class TestBitIdentity:
    def test_bucketed_engine_matches_greedy_generate(self, model, port_engine_run):
        for p, toks in zip(_prompts(model.cfg.vocab), port_engine_run[1]):
            ref = sv.greedy_generate(model.cfg, model.params, torch.from_numpy(p)[None, :],
                                     steps=GEN, max_seq=MAX_SEQ)[0]
            assert toks == ref.tolist(), f"len {len(p)}: engine {toks} != reference {ref}"

    def test_slot_backfill_keeps_identity(self, qwen3):
        """Retire-and-backfill: a second wave lands in freed slots whose
        cache rows still hold the first wave's state."""
        engine = _boot(qwen3.cfg, qwen3.params, [(2, 16)], 24)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, qwen3.cfg.vocab, n).astype(np.int32)
                   for n in (4, 9, 13, 6)]
        reqs = [engine.submit(prompt=p, max_new_tokens=3 + i)
                for i, p in enumerate(prompts)]
        engine.run_until_idle()
        assert all(r.state == DONE for r in reqs)
        for r, p in zip(reqs, prompts):
            ref = sv.greedy_generate(qwen3.cfg, qwen3.params, torch.from_numpy(p)[None, :],
                                     steps=r.max_new_tokens, max_seq=24)[0]
            assert r.tokens == ref.tolist()

    def test_batched_slot_decode_equals_batch1_per_slot(self, slot_model):
        """One batched decode at a position per slot gives each slot the
        logits, tokens and cache row of a batch-1 call at its position.
        For the MoE (router zeroed: every slot picks experts 0 and 1) this
        holds because each slot dispatches alone; one dispatch over the
        slots would drop the third slot's rows (cap 2), and does here."""
        model = slot_model
        n_slots, max_seq = 3, 24
        pre = sv.make_bucket_prefill_step(model.cfg, max_seq)
        dec = sv.make_slot_decode_step(model.cfg)
        lens = np.array([4, 11, 7], np.int32)
        tok = np.zeros((n_slots, 12), np.int32)
        for i, p in enumerate(_prompts(model.cfg.vocab, lens=lens.tolist(), seed=16)):
            tok[i, :len(p)] = p
        cache, logits = pre(model.params, torch.from_numpy(tok), torch.from_numpy(lens))
        rows = [{k: v[:, i:i + 1].clone() for k, v in cache.items()} for i in range(n_slots)]
        nxt, pos = torch.argmax(logits, -1), torch.from_numpy(lens)
        if model.cfg.family == "moe":
            with torch.no_grad():
                h, _ = moe.forward(model.cfg, model.params, nxt[:, None].to(torch.int32),
                                   pos0=pos, cache={k: v.clone() for k, v in cache.items()})
                coupled = moe.logits(model.cfg, model.params, h)[:, 0]
        for step in range(4):
            cache, logits = dec(model.params, cache, nxt, pos)
            if step == 0 and model.cfg.family == "moe":
                assert_close(coupled[:2], logits[:2].numpy())
                assert not torch.allclose(coupled[2], logits[2])
            for i in range(n_slots):
                rows[i], li = dec(model.params, rows[i], nxt[i:i + 1], pos[i:i + 1])
                assert torch.argmax(li, -1).item() == torch.argmax(logits[i]).item()
                assert_close(logits[i], li[0].numpy(), TOL_SHAPES)
                for k in cache:
                    assert_close(cache[k][:, i], rows[i][k][:, 0].numpy(), TOL_SHAPES)
            nxt, pos = torch.argmax(logits, -1), pos + 1


# ---------------------------------------------------------------------------
# Acceptance: a warmed engine never calls the autotuner's timing path at
# request time (cache-only boot, timing path rigged to raise)
# ---------------------------------------------------------------------------


class TestNeverTuneAtRequestTime:
    def test_cache_only_engine_with_timing_path_disabled(self, qwen3, tmp_path,
                                                         monkeypatch):
        cache_path = str(tmp_path / "serve_cache.json")
        buckets, max_seq = [(2, 8), (4, 16)], 24

        e1 = Engine(qwen3.cfg, qwen3.params, BucketLadder(buckets, max_seq=max_seq))
        src1 = e1.warmup(policy="tune", cache=autotune.AutotuneCache(cache_path))
        assert any(s == "tuned" for cells in src1.values() for s in cells.values())

        def _no_timing(*a, **k):
            raise AssertionError("autotuner timing path hit after warmup")

        monkeypatch.setattr(autotune, "_measure", _no_timing)
        monkeypatch.setattr(autotune, "tune", _no_timing)

        e2 = Engine(qwen3.cfg, qwen3.params, BucketLadder(buckets, max_seq=max_seq))
        src2 = e2.warmup(policy="cache-only", cache=autotune.AutotuneCache(cache_path))
        flat = [s for cells in src2.values() for s in cells.values()]
        assert "tuned" not in flat
        assert "cached" in flat  # winners replayed, not re-modeled

        rng = np.random.default_rng(5)
        reqs = [e2.submit(prompt=rng.integers(0, qwen3.cfg.vocab, n).astype(np.int32),
                          max_new_tokens=4)
                for n in (3, 10, 7, 14, 5)]
        e2.run_until_idle()
        assert all(r.state == DONE for r in reqs)


# ---------------------------------------------------------------------------
# Graceful degradation: queue bound, oversize prompts, deadlines
# ---------------------------------------------------------------------------


class TestQueueAndDeadlines:
    def test_queue_sheds_on_overflow(self):
        q = RequestQueue(max_depth=2)
        rs = [Request(rid=f"r{i}", prompt=np.zeros(2, np.int32),
                      max_new_tokens=1) for i in range(3)]
        assert q.submit(rs[0], now=0.0) and q.submit(rs[1], now=0.0)
        assert not q.submit(rs[2], now=0.0)
        assert rs[2].state == SHED and len(q) == 2
        assert rs[0].state == QUEUED

    def test_queue_expires_deadlines(self):
        q = RequestQueue()
        r1 = Request(rid="a", prompt=np.zeros(2, np.int32), max_new_tokens=1, deadline=1.0)
        r2 = Request(rid="b", prompt=np.zeros(2, np.int32), max_new_tokens=1)
        q.submit(r1, now=0.0)
        q.submit(r2, now=0.0)
        dead = q.expire(now=2.0)
        assert [r.rid for r in dead] == ["a"] and r1.state == TIMEOUT
        assert len(q) == 1

    def test_engine_sheds_oversize_and_overflow(self, qwen3):
        engine = _boot(qwen3.cfg, qwen3.params, [(2, 8)], 16, queue_depth=3)
        too_long = engine.submit(prompt=np.zeros(9, np.int32), max_new_tokens=2)
        assert too_long.state == SHED
        subs = [engine.submit(prompt=np.zeros(4, np.int32), max_new_tokens=2)
                for _ in range(5)]
        states = [r.state for r in subs]
        assert states.count(SHED) == 2 and states.count(QUEUED) == 3
        assert len(engine.rejected) == 3
        engine.run_until_idle()
        assert all(r.state == DONE for r in subs if r not in engine.rejected)

    def test_deadline_expires_mid_generation(self, qwen3):
        clock = VirtualClock()
        engine = _boot(qwen3.cfg, qwen3.params, [(2, 8)], 16, clock=clock)
        r = engine.submit(prompt=np.arange(4, dtype=np.int32), max_new_tokens=50,
                          deadline=1.0)
        info = engine.step()
        assert r.state == "active" and info.prefills
        clock.advance(2.0)
        info = engine.step()
        assert r.rid in info.timed_out
        assert r.state == TIMEOUT and r.slot is None
        assert engine.idle

    def test_modeled_step_seconds_drives_virtual_clock(self, qwen3):
        clock = VirtualClock()
        engine = _boot(qwen3.cfg, qwen3.params, [(2, 8)], 16, clock=clock)
        engine.submit(prompt=np.arange(4, dtype=np.int32), max_new_tokens=3)
        t0 = clock.now()
        info = engine.step()
        dt = engine.modeled_step_seconds(info)
        assert dt > 0
        clock.advance(dt)
        assert clock.now() == t0 + dt

    def test_engine_requires_warmup(self, qwen3):
        engine = Engine(qwen3.cfg, qwen3.params, BucketLadder([(2, 8)], max_seq=16))
        with pytest.raises(RuntimeError, match="warmup"):
            engine.submit(prompt=np.zeros(3, np.int32))
        with pytest.raises(RuntimeError, match="warmup"):
            engine.step()


# ---------------------------------------------------------------------------
# Load generator: seeded arrivals, deterministic virtual-clock reports
# ---------------------------------------------------------------------------


class TestLoadgen:
    def test_make_requests_seeded_and_equal_to_repro(self):
        spec = LoadSpec(qps=100.0, n_requests=8, seed=3)
        a, b = make_requests(spec, 256), make_requests(spec, 256)
        j = jserve.make_requests(jserve.LoadSpec(qps=100.0, n_requests=8, seed=3), 256)
        assert [t for t, _ in a] == [t for t, _ in b] == [t for t, _ in j]
        for (_, ra), (_, rb), (_, rj) in zip(a, b, j):
            assert np.array_equal(ra.prompt, rb.prompt) and np.array_equal(ra.prompt, rj.prompt)
            assert ra.max_new_tokens == rb.max_new_tokens == rj.max_new_tokens
        assert len({len(r.prompt) for _, r in a}) > 1  # ragged

    def test_virtual_clock_run_is_deterministic(self, qwen3):
        def once():
            engine = _boot(qwen3.cfg, qwen3.params, [(2, 8), (4, 16)], 24,
                           clock=VirtualClock())
            return run_load(engine, LOAD)

        a, b = once(), once()
        assert a == b
        assert a.completed == LOAD.n_requests
        assert a.p99_s >= a.p50_s > 0
        assert a.tokens_per_sec > 0
        assert 0.0 <= a.padding_waste < 1.0


def test_serve_smoke_cli_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_AUTOTUNE_CACHE": str(tmp_path / "autotune.json")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.serve", "--smoke", "--device",
                          "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "serve smoke ok on cpu" in out.stdout
    assert "boot2 policy=cache-only" in out.stdout and "tuned=0" in out.stdout
