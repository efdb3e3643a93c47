"""The port's measured-time autotuner (repro_torch.plan.autotune) against
the JAX package's, on the CPU: the single-device contract of
``tests/test_autotune.py`` (cache-key stability across processes, schema
invalidation, a corrupt cache, cache-only never times, candidate
enumeration, the tuned winner reaching the kernel, backward cells that
tune and replay), the candidate lists equal to ``repro``'s on MANTICORE and
TPU_V5E, the H100 lists holding only what the port's kernels launch, and
kernel errors that propagate instead of degrading.

Timing runs through scripted stopwatches (``_fake_measure``) except where a
test says otherwise; CPU tensors run the kernels' plain versions.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.machine import MANTICORE as J_MANTICORE
from repro.core.machine import TPU_V5E as J_TPU_V5E
from repro.plan import autotune as jat
from repro.plan import planner_for as j_planner_for
from repro_torch.core.machine import H100, MANTICORE, TPU_V5E
from repro_torch.plan import autotune as at
from repro_torch.plan import planner_for
from repro_torch.plan.planners import PlanRejected
from repro_torch.plan.registry import _OPS, get_op

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_MM = dict(m=16, n=256, k=64, in_bytes=4)
TINY_CONV = dict(H_O=8, W_O=8, F=3, S=1, d_in=8, d_out=16, in_bytes=4,
                 padding=1, batch=2, pool=2)
TINY_DGRAD = dict(H_O=8, W_O=8, F=3, S=1, P=1, d_in=8, d_out=16, in_bytes=4, batch=2)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Never read or write the user's real winner cache; tune on the CPU."""
    monkeypatch.setattr(at, "_CACHE_PATH", str(tmp_path / "global.json"))
    monkeypatch.setattr(at, "_POLICY", "off")
    monkeypatch.setattr(at, "_DEVICE", "cpu")
    monkeypatch.setattr(at, "_WARNED_CELLS", set())


@pytest.fixture
def cache(tmp_path):
    return at.AutotuneCache(str(tmp_path / "autotune.json"))


def _fake_measure(times):
    """A deterministic stopwatch: pops the next scripted microsecond value
    instead of running the kernel."""
    seq = list(times)

    def m(fn, iters=3, warmup=1, **kw):
        del fn, iters, warmup, kw
        return seq.pop(0)

    return m


# -- the cache key --------------------------------------------------------------------


_KEY_SCRIPT = """
import sys
sys.path.insert(0, {root!r} + "/src")
from repro_torch.core.machine import H100
from repro_torch.plan import autotune as at
readable, digest = at.cache_key("matmul", dict(m=256, n=4096, k=2048, in_bytes=4,
                                               block_n=None), "float32", H100)
print(digest)
"""


class TestCacheKey:
    def test_stable_across_processes(self):
        digests = [subprocess.run([sys.executable, "-c", _KEY_SCRIPT.format(root=ROOT)],
                                  capture_output=True, text=True, check=True,
                                  timeout=120).stdout.strip() for _ in range(2)]
        _, here = at.cache_key("matmul", dict(m=256, n=4096, k=2048, in_bytes=4,
                                              block_n=None), "float32", H100)
        assert digests[0] == digests[1] == here

    def test_none_valued_knobs_do_not_split_cells(self):
        _, a = at.cache_key("matmul", dict(TINY_MM), "float32", H100)
        _, b = at.cache_key("matmul", dict(TINY_MM, block_n=None, block_m=None),
                            torch.float32, H100)
        assert a == b

    def test_discriminates_every_key_component(self):
        _, d0 = at.cache_key("matmul", dict(TINY_MM), "float32", H100)
        for v in (("matmul_dx", dict(TINY_MM), "float32", H100),
                  ("matmul", dict(TINY_MM, m=32), "float32", H100),
                  ("matmul", dict(TINY_MM), "bfloat16", H100),
                  ("matmul", dict(TINY_MM), "float32", TPU_V5E),
                  ("matmul", dict(TINY_MM), "float32", MANTICORE)):
            assert at.cache_key(*v)[1] != d0, v

    def test_schema_version_enters_the_key(self, monkeypatch):
        _, d0 = at.cache_key("matmul", dict(TINY_MM), "float32", H100)
        monkeypatch.setattr(at, "SCHEMA_VERSION", at.SCHEMA_VERSION + 1)
        assert at.cache_key("matmul", dict(TINY_MM), "float32", H100)[1] != d0

    @pytest.mark.parametrize("machine,jmachine", [(MANTICORE, J_MANTICORE),
                                                  (TPU_V5E, J_TPU_V5E)])
    def test_key_is_repros_for_the_same_cell(self, machine, jmachine):
        """Same cell, same machine name: the same readable key and digest
        (an h100 cell is a cell no TPU run ever wrote)."""
        assert at.cache_key("conv2d", dict(TINY_CONV), "float32", machine) == \
            jat.cache_key("conv2d", dict(TINY_CONV), "float32", jmachine)


# -- the cache file -------------------------------------------------------------------


class TestCacheFile:
    def test_winner_persists_and_replays(self, cache, monkeypatch):
        monkeypatch.setattr(at, "_measure", _fake_measure([3.0, 1.0, 2.0] * 4))
        rep = at.tune("matmul", cache=cache, topk=3, **TINY_MM)
        assert not rep.cached and os.path.exists(cache.path)
        fresh = at.AutotuneCache(cache.path)
        rep2 = at.tune("matmul", cache=fresh, topk=3, **TINY_MM)
        assert rep2.cached
        assert rep2.schedule.blocks == rep.schedule.blocks
        assert rep2.schedule.grid == rep.schedule.grid

    def test_schema_mismatch_invalidates_file(self, cache, monkeypatch):
        monkeypatch.setattr(at, "_measure", _fake_measure([1.0] * 8))
        at.tune("matmul", cache=cache, topk=2, **TINY_MM)
        with open(cache.path) as fh:
            data = json.load(fh)
        data["schema"] = at.SCHEMA_VERSION - 1
        with open(cache.path, "w") as fh:
            json.dump(data, fh)
        fresh = at.AutotuneCache(cache.path)
        assert len(fresh) == 0
        assert at.lookup("matmul", dict(TINY_MM), cache=fresh) is None

    def test_corrupt_file_is_empty_not_fatal(self, cache, monkeypatch):
        with open(cache.path, "w") as fh:
            fh.write("{definitely not json")
        with pytest.warns(UserWarning, match="unreadable"):
            assert at.lookup("matmul", dict(TINY_MM), cache=cache) is None
        s = at.resolve("matmul", dict(TINY_MM), policy="cache-only",
                       cache=at.AutotuneCache(cache.path))
        assert s == planner_for("matmul", H100).plan(**TINY_MM)
        monkeypatch.setattr(at, "_measure", _fake_measure([1.0] * 8))
        rewrite = at.AutotuneCache(cache.path)
        with pytest.warns(UserWarning, match="unreadable"):
            rep = at.tune("matmul", cache=rewrite, topk=2, **TINY_MM)
        assert not rep.cached
        with open(cache.path) as fh:
            assert json.load(fh)["schema"] == at.SCHEMA_VERSION

    def test_cache_only_never_times(self, cache, monkeypatch):
        def boom(fn, iters=3, warmup=1, **kw):
            raise AssertionError("cache-only policy measured a candidate")

        monkeypatch.setattr(at, "_measure", boom)
        s = at.resolve("matmul", dict(TINY_MM), policy="cache-only", cache=cache)
        assert s == planner_for("matmul", H100).plan(**TINY_MM)
        assert len(cache) == 0 and not os.path.exists(cache.path)

    def test_policy_is_checked(self):
        with pytest.raises(ValueError, match="policy"):
            at.set_policy("sometimes")
        assert at.recovery_policy("tune") == "cache-only"
        assert at.recovery_policy("off") == "off"

    def test_default_cache_lives_under_repro_torch(self, monkeypatch):
        monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
        assert at.default_cache_path().endswith(
            os.path.join(".cache", "repro_torch", "autotune.json"))
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "/x/y.json")
        assert at.default_cache_path() == "/x/y.json"


# -- candidates -----------------------------------------------------------------------

CELLS = [
    ("conv2d", TINY_CONV),
    ("conv2d", dict(H_O=32, W_O=32, F=3, S=1, d_in=3, d_out=64, in_bytes=4, pool=2,
                    batch=256, padding=1, H_I=32, W_I=32)),
    ("conv2d", dict(H_O=7, W_O=7, F=1, S=2, d_in=512, d_out=256, in_bytes=4)),
    ("conv2d_im2col", TINY_CONV),
    ("conv2d_dgrad", TINY_DGRAD),
    ("conv2d_dgrad", dict(TINY_DGRAD, pool=2)),
    ("conv2d_dgrad", dict(H_O=16, W_O=16, F=3, S=1, P=1, d_in=64, d_out=128, in_bytes=4,
                          batch=256, H_I=16, W_I=16, pool=2)),
    ("conv2d_wgrad", {k: v for k, v in TINY_CONV.items() if k != "pool"}),
    ("conv2d_wgrad", dict(H_O=16, W_O=16, F=3, S=1, d_in=64, d_out=128, in_bytes=4,
                          batch=256, padding=1, H_I=16, W_I=16)),
    ("matmul", TINY_MM),
    ("matmul", dict(m=32, n=4096, k=25088, in_bytes=4)),
    ("matmul_dx", TINY_MM),
    ("matmul_dx", dict(m=128, n=4096, k=2048, in_bytes=4)),
    ("matmul_dx", dict(m=256, n=4096, k=2048, in_bytes=4, algorithm="fused_dxdw")),
    ("matmul_dw", TINY_MM),
    ("matmul_dw", dict(m=8192, n=3072, k=1024, in_bytes=4)),
    ("flash_attention", dict(seq_q=2048, seq_kv=2048, head_dim=64, n_q_heads=16,
                             n_kv_heads=16, batch=4, in_bytes=4, causal=True)),
    ("flash_attention", dict(seq_q=100, seq_kv=100, head_dim=96, in_bytes=4, window=32)),
]


def _key(s):
    return (s.algorithm, s.blocks, s.grid, s.loads, s.stores, s.vmem_bytes,
            s.critical_path_steps)


@pytest.mark.parametrize("machine,jmachine", [(MANTICORE, J_MANTICORE),
                                              (TPU_V5E, J_TPU_V5E)])
@pytest.mark.parametrize("op,shape", CELLS)
def test_candidates_equal_repros(op, shape, machine, jmachine):
    """The same blocks, modeled words and order as repro's enumeration."""
    ours = planner_for(op, machine).candidates(**shape)
    theirs = j_planner_for(op, jmachine).candidates(**shape)
    assert [_key(s) for s in ours] == [_key(s) for s in theirs]


@pytest.mark.parametrize("op,shape", [c for c in CELLS if c[0] not in ("conv2d_dgrad",)])
@pytest.mark.parametrize("machine", [TPU_V5E, H100])
def test_local_first_candidate_is_the_argmin(op, shape, machine):
    """The list is sorted by modeled words, its head is plan()'s pick
    wherever plan() fits, and (on the H100) every entry fits.  (A dgrad
    cell with a mask ranks its direct variant first: the fused variant is
    charged the scatter.)"""
    p = planner_for(op, machine)
    try:
        cands = p.candidates(**shape)
    except PlanRejected:
        assert machine is H100
        return
    argmin = p.plan(**shape)
    words = [c.modeled_words for c in cands]
    assert words == sorted(words)
    if argmin.fits(machine):
        # plan()'s stack can pad N past a smaller stack's words (repro's
        # rule too), so the head is never worse and, on the tiny cells, is it
        assert cands[0].modeled_words <= argmin.modeled_words
        if shape in (TINY_MM, TINY_CONV):
            assert cands[0].blocks == argmin.blocks
    if machine is H100:
        assert all(c.fits(H100) for c in cands)


def test_h100_flash_candidates_are_the_kernels_blocks():
    """On the H100 the flash cell offers only blocks the kernel is built for
    at its head_dim (MAX_BLOCKS); a head_dim it is not built for has none."""
    from repro_torch.kernels.flash_attention.flash_attention import MAX_BLOCKS

    for d, (mq, mkv) in MAX_BLOCKS.items():
        cands = planner_for("flash_attention", H100).candidates(
            seq_q=2048, seq_kv=2048, head_dim=d, batch=1, in_bytes=4, causal=True)
        assert cands and all(c.block("block_q") <= mq and c.block("block_kv") <= mkv
                             for c in cands)
    with pytest.raises(PlanRejected, match="head_dim 96"):
        planner_for("flash_attention", H100).candidates(seq_q=100, seq_kv=100,
                                                        head_dim=96, in_bytes=4)


def test_h100_drops_what_does_not_fit():
    """repro's fused ladder falls back to an unfit argmin (which its
    interpreter runs); on the H100 a cell with no fitting candidate is a
    planner rejection, and the fitting ones stay."""
    big = dict(m=8192, n=4096, k=2048, in_bytes=4, algorithm="fused_dxdw")
    assert not planner_for("matmul_dx", TPU_V5E).plan(**big).fits(H100)
    with pytest.raises(PlanRejected, match="fits"):
        planner_for("matmul_dx", H100).candidates(**big)
    cands = planner_for("matmul_dx", H100).candidates(
        m=256, n=4096, k=2048, in_bytes=4, algorithm="fused_dxdw")
    assert cands and all(c.algorithm == "fused_dxdw" and c.fits(H100) for c in cands)


# -- tuned winners reach the kernels ----------------------------------------------------


class TestWinnerExecution:
    def test_tuned_winner_reaches_the_kernel(self, cache, monkeypatch):
        """Under cache-only policy the schedule handed to the op's impl is
        the *measured* winner, not the modeled argmin."""
        argmin = planner_for("matmul", H100).plan(**TINY_MM)
        n = len(planner_for("matmul", H100).candidates(**TINY_MM))
        assert n >= 2, "need a real choice for this test"
        monkeypatch.setattr(at, "_measure", _fake_measure([float(n - i) for i in range(n)]))
        rep = at.tune("matmul", cache=cache, topk=n, **TINY_MM)
        assert rep.schedule.blocks != argmin.blocks

        monkeypatch.setattr(at, "_CACHE_PATH", cache.path)
        op = get_op("matmul")
        seen = {}
        orig = op.impl

        def spy_impl(*tensors, schedule, **kw):
            seen["schedule"] = schedule
            return orig(*tensors, schedule=schedule, **kw)

        monkeypatch.setitem(_OPS, "matmul", dataclasses.replace(op, impl=spy_impl))
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
        out = _OPS["matmul"](x, w, autotune="cache-only")
        assert seen["schedule"].blocks == rep.schedule.blocks != argmin.blocks
        np.testing.assert_allclose(out.numpy(), x.numpy() @ w.numpy(), rtol=1e-4, atol=1e-4)

    def test_backward_cells_tune_and_replay(self, cache, monkeypatch):
        """dX (direct and fused), dW and dgrad cells tune, cache and replay,
        and the FC layer's plan_bwd resolves the cached winners."""
        monkeypatch.setattr(at, "_measure", _fake_measure([2.0, 1.0] * 20))
        fused = dict(TINY_MM, algorithm="fused_dxdw")
        for op, shape in (("matmul_dx", TINY_MM), ("matmul_dx", fused),
                          ("matmul_dw", TINY_MM), ("conv2d_dgrad", TINY_DGRAD)):
            rep = at.tune(op, cache=cache, topk=2, **shape)
            rep2 = at.tune(op, cache=cache, topk=2, **shape)
            assert rep2.cached and rep2.schedule.blocks == rep.schedule.blocks
            assert rep.schedule.blocks != planner_for(op, H100).plan(**shape).blocks, op

        from repro_torch.core import fc_layer as fl

        monkeypatch.setattr(at, "_CACHE_PATH", cache.path)
        bwd = fl.plan_bwd((16, 64), (64, 256), autotune="cache-only")
        want_dx = at.lookup("matmul_dx", fused, cache=cache)
        assert bwd["dx"].algorithm == "fused_dxdw" and bwd["dx"].blocks == want_dx.blocks
        assert bwd["dw"].blocks == at.lookup("matmul_dw", dict(TINY_MM), cache=cache).blocks

    def test_plan_helpers_off_policy_unchanged(self):
        from repro_torch.core import conv_layer as cl
        from repro_torch.core import fc_layer as fl

        x_shape, f_shape = (2, 8, 8, 8), (3, 3, 8, 16)
        assert cl.plan(x_shape, f_shape, padding=1, pool=2) == cl.plan(
            x_shape, f_shape, padding=1, pool=2, autotune="off")
        assert fl.plan_bwd((16, 64), (64, 256)) == fl.plan_bwd((16, 64), (64, 256),
                                                               autotune="off")

    def test_cnn_step_replays_every_cached_winner(self, tmp_path, monkeypatch):
        """plan_training under tune caches a winner per cell (scripted: the
        last-ranked candidate wins); a planned step under cache-only then
        hands each kernel its cached winner's blocks, and never times."""
        from repro_torch.configs import TrainConfig, smoke_config
        from repro_torch.data.pipeline import ShardInfo
        from repro_torch.kernels.conv2d.bwd import conv2d_wgrad_kernel
        from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
        from repro_torch.kernels.matmul.bwd import (
            matmul_dxdw_kernel, matmul_nt_kernel, matmul_tn_kernel,
        )
        from repro_torch.kernels.matmul.matmul import matmul_kernel
        from repro_torch.models import cnn
        from repro_torch.models.module import init_params
        from repro_torch.runtime import train as tr

        cfg, batch = smoke_config("cnn-vgg11"), 4
        calls = iter(range(1, 10_000))
        monkeypatch.setattr(at, "_measure",
                            lambda fn, iters=3, warmup=1, **kw: 1.0 / next(calls))
        at.set_policy("tune", str(tmp_path / "w.json"), device="cpu")
        tuned = cnn.plan_training(cfg, batch)
        argmin = cnn.plan_training(cfg, batch, autotune="off")
        assert any(tuned[k].blocks != argmin[k].blocks for k in tuned)

        def boom(*a, **k):
            raise AssertionError("cache-only timed a candidate")

        monkeypatch.setattr(at, "_measure", boom)
        at.set_policy("cache-only")
        seen = set()
        kernels = {"conv2d": conv2d_kernel, "matmul": matmul_kernel,
                   "conv2d_wgrad": conv2d_wgrad_kernel, "matmul_nt": matmul_nt_kernel,
                   "matmul_tn": matmul_tn_kernel, "matmul_dx_dw": matmul_dxdw_kernel}
        for name, kern in kernels.items():
            def spy(*a, _n=name, _p=kern.plain, **kw):
                seen.add((_n, tuple(v for b, v in sorted(kw.items()) if b.startswith("block"))))
                return _p(*a, **kw)
            monkeypatch.setattr(kern, "plain", spy)
        tc = TrainConfig(planned_kernels=True)
        params = init_params(cnn.param_defs(cfg), 0, device="cpu")
        data = tr.batch_to(cnn.data_source(cfg, batch, ShardInfo(0, 1), seed=0)(0), "cpu")
        tr.make_train_step(cfg, tc)(tr.init_state(cfg, tc, params), data)
        for name, s in tuned.items():
            if name.startswith("conv") and "." not in name and s.algorithm == "direct":
                b = s.block_dict()
                assert ("conv2d", (b["block_di"], b["block_do"], b["block_h"])) in seen, name
            if name.endswith(".wgrad"):
                b = s.block_dict()
                assert ("conv2d_wgrad", (b["block_di"], b["block_do"], b["block_h"])) in seen
            if name in ("fc1", "fc2"):
                b = s.block_dict()
                assert ("matmul", (b["block_k"], b["block_m"], b["block_n"])) in seen, name


# -- errors: only the planner's rejection degrades -------------------------------------


def test_kernel_error_during_tune_raises(cache, monkeypatch):
    """A candidate whose kernel fails raises out of tune and out of a
    "tune"-policy resolution — it never degrades to the argmin."""
    from repro_torch.kernels.matmul.matmul import matmul_kernel

    def broken(*a, **kw):
        raise ValueError("matmul kernel does not take blocks")

    monkeypatch.setattr(matmul_kernel, "plain", broken)
    with pytest.raises(ValueError, match="does not take blocks"):
        at.tune("matmul", cache=cache, topk=2, **TINY_MM)
    with pytest.raises(ValueError, match="does not take blocks"):
        at.resolve("matmul", dict(TINY_MM), policy="tune", cache=cache)
    assert len(cache) == 0


def test_planner_rejection_degrades_once_with_the_cell(cache):
    """A cell the H100 planner rejects (flash at head_dim 96) resolves to
    the modeled argmin under "tune", with one warning naming the cell."""
    shape = dict(seq_q=100, seq_kv=100, head_dim=96, in_bytes=4)
    with pytest.warns(UserWarning, match="head_dim 96"):
        s = at.resolve("flash_attention", shape, policy="tune", cache=cache)
    assert s == planner_for("flash_attention", H100).plan(**shape)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        at.resolve("flash_attention", shape, policy="tune", cache=cache)


def test_stale_cached_pin_degrades(cache, monkeypatch):
    monkeypatch.setattr(at, "_measure", _fake_measure([1.0] * 8))
    rep = at.tune("conv2d", cache=cache, topk=2, **TINY_CONV)
    digest = rep.key
    entries = cache.load()
    entries[digest] = dict(entries[digest], algorithm="winograd")
    with pytest.warns(UserWarning, match="unusable"):
        assert at.lookup("conv2d", dict(TINY_CONV), cache=cache) is None


@pytest.mark.parametrize("op,shape,alg", [("conv2d_dgrad", dict(TINY_DGRAD, pool=2), "direct"),
                                          ("conv2d_wgrad", {k: v for k, v in TINY_CONV.items()
                                                            if k != "pool"}, "direct"),
                                          ("conv2d", TINY_CONV, "im2col")])
def test_winner_replays_with_its_algorithm(cache, monkeypatch, op, shape, alg):
    """A winner of a non-default variant replays as that variant (a direct
    dgrad winner of a masked cell, whose default is fused_epilogue; a
    direct wgrad winner, whose default is pipelined) — same blocks, grid
    and tag."""
    cands = planner_for(op, H100).candidates(**shape)
    assert planner_for(op, H100).plan(**shape).algorithm != alg
    pick = next(i for i, c in enumerate(cands) if c.algorithm == alg)
    monkeypatch.setattr(at, "_measure", _fake_measure(
        [0.5 if i == pick else 2.0 for i in range(len(cands))]))
    rep = at.tune(op, cache=cache, topk=len(cands), **shape)
    assert rep.schedule.algorithm == alg
    got = at.lookup(op, dict(shape), cache=at.AutotuneCache(cache.path))
    assert (got.algorithm, got.blocks, got.grid) == (alg, rep.schedule.blocks,
                                                     rep.schedule.grid)


def test_warm_reports_each_cells_source(cache, monkeypatch):
    monkeypatch.setattr(at, "_measure", _fake_measure([1.0] * 20))
    cells = {"a": ("matmul", dict(TINY_MM)), "b": ("conv2d", dict(TINY_CONV))}
    _, sources = at.warm(cells, policy="cache-only", cache=cache)
    assert sources == {"a": "modeled", "b": "modeled"}
    _, sources = at.warm(cells, policy="tune", cache=cache)
    assert sources == {"a": "tuned", "b": "tuned"}
    plans, sources = at.warm(cells, policy="cache-only", cache=cache)
    assert sources == {"a": "cached", "b": "cached"}
    assert plans["a"] == at.lookup("matmul", dict(TINY_MM), cache=cache)


def test_tune_times_on_the_cpu_with_a_host_timer(cache):
    """Unscripted: the plain versions run and a host timer measures."""
    rep = at.tune("matmul", cache=cache, topk=2, iters=1, warmup=0, device="cpu", **TINY_MM)
    assert len(rep.measurements) == 2 and all(us > 0 for _, us, _ in rep.measurements)


def test_dx_op_times_a_fused_candidate(cache):
    """A fused candidate of the dX cell runs the fused kernel on a zero X
    (its dX half equals the direct kernel's)."""
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal((16, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    op = get_op("matmul_dx")
    fused = planner_for("matmul_dx", H100).plan(**TINY_MM, algorithm="fused_dxdw")
    np.testing.assert_allclose(op(g, w, schedule=fused).numpy(), (g @ w.T).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_smoke_cli_on_the_cpu(capsys):
    """The CLI's tune-then-replay smoke: the conv cell's candidates span
    both families of the two-level argmin, and every winner replays."""
    assert at.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "autotune smoke ok (3 cached cells)" in out
    labels = [ln.split(",")[0] for ln in out.splitlines() if ln.startswith("conv2d:")]
    assert any(lbl.startswith("conv2d:im2col:") for lbl in labels)
    assert any(lbl.startswith("conv2d:{") for lbl in labels)
