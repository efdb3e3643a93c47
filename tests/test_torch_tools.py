"""The port's tools against ``repro``'s: the cost analysis of a traced step
(``analysis/hlo_cost.py`` against ``repro``'s HLO analyzer of the jitted
counterpart), ``collective_bytes`` on gloo ranks, ``from_compiled`` on
TPU_V5E, ``report.py``'s tables, and the kernels' ``meta`` route.

Tolerances: a dot's FLOPs and bytes are exact (2·M·N·K; operands and
result); so are the dot FLOPs of the 16-chunk loss (every trip counted),
of the smoke dense forward and of the smoke train step.  The totals of
the forward, the loss and the train step differ by the elementwise ops
XLA's simplifier rewrites (FLOPs within 1 %) and by the copies each
program materializes (bytes within 50 %: the port makes attention's
transposes and RoPE's halves contiguous, XLA copies the optimizer
state); ``PERF.md`` §6 (PR 31) lists the gaps.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo_cost as jhc
from repro.analysis import report as jreport
from repro.analysis import roofline as jrl
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models.module import init_params as jax_init_params
from repro.models.registry import get_family as jax_family
from repro.runtime import train as jtr
from repro_torch.analysis import hlo_cost, report, roofline
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.convert import params_from_repro
from repro_torch.core.machine import H100, TPU_V5E
from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
from repro_torch.kernels.flash_attention.flash_attention import (
    admitted_pairs, flash_attention_kernel,
)
from repro_torch.kernels.matmul.bwd import matmul_dxdw_kernel, matmul_nt_kernel, matmul_tn_kernel
from repro_torch.kernels.matmul.matmul import matmul_kernel
from repro_torch.models.registry import get_family
from repro_torch.runtime import train as ttr

from _torch_ranks import run_ranks

ARCH = "qwen1.5-0.5b"
B, S = 2, 64


def _jax_cost(fn, *args):
    return jhc.analyze(jax.jit(fn).lower(*args).compile().as_text())


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jp = jax_init_params(jax_family(jcfg.family).param_defs(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, params_from_repro(jp, device="cpu"), tokens, labels


def _close(got, want, rel):
    assert abs(got - want) <= rel * abs(want), (got, want)


# -- the cost analysis against repro's ------------------------------------------------


@pytest.mark.parametrize("mnk", [(64, 48, 96), (128, 256, 32)])
def test_one_matmul_costs_what_repro_charges(mnk):
    m, n, k = mnk
    x, w = np.ones((m, k), np.float32), np.ones((k, n), np.float32)
    want = _jax_cost(jnp.dot, x, w)
    got = hlo_cost.analyze(torch.mm, torch.from_numpy(x), torch.from_numpy(w))
    assert (got.flops, got.bytes) == (want.flops, want.bytes) == (2.0 * m * n * k,
                                                                  4.0 * (m * k + k * n + m * n))
    assert got.by_op == {"dot": [want.flops, want.bytes]}
    assert got.unknown_trip_whiles == want.unknown_trip_whiles == 0


def test_chunked_loss_counts_every_trip(smoke):
    """The 16-chunk cross-entropy: ``repro``'s scan carries a known trip
    count; the port's loop runs 16 times.  The dots agree exactly."""
    jcfg, cfg, jp, tp, _, labels = smoke
    h = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want = _jax_cost(lambda p, h, l: jtr.chunked_ce(jcfg, jax_family(jcfg.family), p, h, l, 16),
                     jp, h, labels)
    got = hlo_cost.analyze(lambda p, h, l: ttr.chunked_ce(cfg, get_family(cfg.family), p, h, l,
                                                          16),
                           tp, torch.from_numpy(h), torch.from_numpy(labels))
    assert got.by_op["dot"] == want.by_op["dot"]
    assert got.by_op["dot"][0] == 16 * 2.0 * B * (S // 16) * cfg.d_model * cfg.vocab
    _close(got.flops, want.flops, 0.01)


def test_plain_forward_of_the_dense_smoke_config(smoke):
    jcfg, cfg, jp, tp, tokens, _ = smoke
    want = _jax_cost(lambda p, t: jax_family(jcfg.family).forward(
        jcfg, p, t, compute_dtype=jnp.float32)[0], jp, tokens)
    got = hlo_cost.analyze(lambda p, t: get_family(cfg.family).forward(
        cfg, p, t, compute_dtype=torch.float32)[0], tp, torch.from_numpy(tokens))
    assert got.by_op["dot"] == want.by_op["dot"]
    _close(got.flops, want.flops, 0.01)
    _close(got.bytes, want.bytes, 0.5)


def test_smoke_train_step_totals(smoke):
    """The whole step (forward, backward, AdamW) on one device: dots
    exact, FLOPs within 1 %, bytes within 50 % (module docstring)."""
    jcfg, cfg, jp, tp, tokens, labels = smoke
    jt = JaxTrainConfig(compute_dtype="float32", loss_chunks=4, remat="none")
    tt = TrainConfig(loss_chunks=4, remat="none")
    batch = {"tokens": tokens, "labels": labels}
    want = _jax_cost(jtr.make_train_step(jcfg, jt), jtr.init_state(jcfg, jt, jp), batch)
    got = hlo_cost.analyze(ttr.make_train_step(cfg, tt), ttr.init_state(cfg, tt, tp),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.by_op["dot"][0] == want.by_op["dot"][0]
    _close(got.flops, want.flops, 0.01)
    _close(got.bytes, want.bytes, 0.5)
    assert got.unknown_trip_whiles == 0 and not any(got.coll.values())


def test_recorder_memory_follows_storages():
    """Arguments count once, the output's storage is the output size,
    and the peak holds every temporary alive at once."""
    x = torch.zeros(64, 64)

    def fn(x):
        a = x + 1.0  # 16 KiB
        b = a * 2.0  # 16 KiB, a still alive
        return (a + b).sum()

    _, rec = hlo_cost.trace(fn, x)
    mem = rec.memory
    assert mem["argument_size_in_bytes"] == 64 * 64 * 4
    assert mem["output_size_in_bytes"] == 4
    assert mem["temp_size_in_bytes"] >= 3 * 64 * 64 * 4


def _meta_ops(x, y):
    """Elementwise ops on ``meta`` operands of several dtypes, the
    recorder's fast path and PyTorch's meta functions alike."""
    return [torch.exp(x), torch.sqrt(x), torch.sigmoid(x), torch.clamp(x, 0.5, 2.5),
            torch.nn.functional.softplus(x), x + y, x * 2.5, torch.where(x > 0, x, y),
            torch.where(x > 0, y, 1.5), x < y, torch.maximum(x, y), torch.erf(x)]


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.int32, torch.int32),
                                    (torch.int64, torch.float32), (torch.float32, torch.float64),
                                    (torch.bool, torch.int32), (torch.float16, torch.float32)],
                         ids=lambda d: f"{d[0]}-{d[1]}".replace("torch.", ""))
def test_fast_meta_results_have_pytorchs_dtypes(dtypes):
    """Under the recorder every elementwise result on ``meta`` has the
    shape and dtype PyTorch's own meta function gives, and an in-place op
    whose result does not cast to its operand raises as it does outside."""
    x = torch.empty(4, 3, dtype=dtypes[0], device="meta")
    y = torch.empty(3, dtype=dtypes[1], device="meta")
    want = [(t.shape, t.dtype) for t in _meta_ops(x, y)]
    with hlo_cost.record():
        got = [(t.shape, t.dtype) for t in _meta_ops(x, y)]
    assert got == want
    for op in (lambda: x.add_(y), lambda: x.mul_(2.5), lambda: x.exp_()):
        try:
            op()
            raised = None
        except RuntimeError as e:
            raised = type(e)
        with hlo_cost.record():
            try:
                op()
                under = None
            except RuntimeError as e:
                under = type(e)
        assert under == raised


# -- collective_bytes on gloo ranks ------------------------------------------------------


def test_collective_bytes_are_result_bytes_on_gloo_ranks(tmp_path):
    """psum, all-gather, reduce-scatter and ppermute of a [6, 4] f32 on
    2 gloo ranks: each category holds its result's bytes, as ``repro``'s
    ``collective_bytes`` reads an HLO collective's result shape."""
    run_ranks("collective_bytes", 2, tmp_path)
    for r in range(2):
        got = json.loads((tmp_path / f"coll{r}.json").read_text())
        assert got["collectives"] == {"all-reduce": 96.0 + 96.0, "all-gather": 192.0,
                                      "reduce-scatter": 48.0, "all-to-all": 0.0,
                                      "collective-permute": 96.0}
        assert got["calls"] == [["all-reduce", [6, 4]], ["all-reduce", [6, 4]],
                                ["all-gather", [12, 4]], ["reduce-scatter", [3, 4]],
                                ["collective-permute", [6, 4]]]
        assert got["flops"] == 0.0  # the transports' own copies are not charged


# -- from_compiled and the report ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_from_compiled_on_tpu_v5e_equals_repro(kind):
    """The same program's numbers through both: ``repro``'s
    ``from_compiled`` of a compiled jit, and the port's of that program's
    cost (its per-device FLOPs, bytes and collectives, the entry's
    argument and output bytes) on TPU_V5E."""
    x, w = np.ones((256, 128), np.float32), np.ones((128, 512), np.float32)
    compiled = jax.jit(lambda x, w: jnp.tanh(x @ w).sum(0)).lower(x, w).compile()
    want = jrl.from_compiled(compiled, kind, 1_000_000, 4096, 16).as_dict()
    c = jhc.analyze(compiled.as_text())
    cost = hlo_cost.Cost(flops=c.flops, bytes=c.bytes, coll=dict(c.coll))
    mem = compiled.memory_analysis()
    io = mem.argument_size_in_bytes + mem.output_size_in_bytes
    got = roofline.from_compiled(cost, kind, 1_000_000, 4096, 16, io_bytes=io,
                                 machine=TPU_V5E).as_dict()
    assert got.pop("machine") == TPU_V5E.name
    assert got == want
    h100 = roofline.from_compiled(cost, kind, 1_000_000, 4096, 16, io_bytes=io)
    assert h100.t_compute == want["flops"] / (16 * H100.peak_flops)
    assert roofline.collective_bytes(cost) == jrl.collective_bytes(compiled.as_text())


def _records() -> dict:
    roof = jrl.Roofline(flops=3.2e15, bytes_hbm=4.1e13, bytes_coll=7.5e11, chips=256,
                        model_flops=2.9e15).as_dict()
    recs = {
        "qwen1.5-0.5b|train_4k|16x16": dict(
            arch="qwen1.5-0.5b", shape="train_4k", mesh="16x16", chips=256,
            compile_seconds=97.9, bytes_per_device=1.8e9, roofline=roof, ok=True),
        "gemma3-4b|long_500k|16x16": dict(
            arch="gemma3-4b", shape="long_500k", mesh="16x16", ok=False,
            error="NotImplementedError: a KV cache of 1 rows ... (ROADMAP queue 3 #22)"),
        "qwen3-32b|decode_32k|2x16x16": dict(
            arch="qwen3-32b", shape="decode_32k", mesh="2x16x16", chips=512,
            compile_seconds=12.5, bytes_per_device=3.3e10, roofline=dict(roof, chips=512),
            ok=True),
    }
    return recs


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_report_tables_equal_repro(mesh, tmp_path):
    recs = _records()
    assert report.dryrun_table(recs, mesh) == jreport.dryrun_table(recs, mesh)
    assert report.roofline_table(recs, mesh) == jreport.roofline_table(recs, mesh)
    assert [report.fmt_bytes(b) for b in (0, 1023, 5e9, 3e18)] == [
        jreport.fmt_bytes(b) for b in (0, 1023, 5e9, 3e18)]
    per_device = report.device_table(recs, mesh)
    rf = recs["qwen1.5-0.5b|train_4k|16x16"]["roofline"]
    if mesh == "16x16":
        assert f"| qwen1.5-0.5b | train_4k | {rf['flops'] / 256:.3e} |" in per_device
        assert "| gemma3-4b | long_500k | FAIL: NotImplementedError" in per_device
    else:
        assert per_device.count("| qwen3-32b | decode_32k |") == 1
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    keys = sorted(recs)
    a.write_text(json.dumps({k: recs[k] for k in keys[:2]}))
    b.write_text(json.dumps({k: recs[k] for k in keys[2:]}))
    assert report.load([str(a), str(b)]) == recs


# -- the kernels' meta route -----------------------------------------------------------------


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


META_CALLS = [
    ("matmul", matmul_kernel, (_m(128, 64), _m(64, 256)),
     dict(block_m=64, block_n=128, block_k=32), [(128, 256)]),
    ("matmul_nt", matmul_nt_kernel, (_m(128, 256), _m(64, 256)),
     dict(block_m=64, block_n=64, block_k=32), [(128, 64)]),
    ("matmul_tn", matmul_tn_kernel, (_m(128, 64), _m(128, 256)),
     dict(block_m=32, block_n=64, block_k=32), [(64, 256)]),
    ("matmul_dx_dw", matmul_dxdw_kernel, (_m(64, 256), _m(128, 256), _m(64, 128)),
     dict(block_m=64, block_n=64, block_k=32), [(64, 128), (128, 256)]),
    ("conv2d", conv2d_kernel, (_m(2, 10, 10, 8), _m(3, 3, 8, 16), _m(16)),
     dict(stride=1, block_h=8, block_do=8, block_di=8, H_O=8, W_O=8, relu=True, pool=2,
          emit_mask=True), [(2, 4, 4, 16), (2, 4, 4, 16)]),
    ("flash_attention", flash_attention_kernel, (_m(8, 128, 64), _m(4, 128, 64),
                                                 _m(4, 128, 64)),
     dict(block_q=64, block_kv=64, scale=0.125, causal=True, window=None, q_len=100,
          kv_len=100), [(8, 128, 64)]),
]


@pytest.mark.parametrize("case", META_CALLS, ids=[c[0] for c in META_CALLS])
def test_meta_route_checks_allocates_and_counts_no_launch(case):
    """A kernel on ``meta`` returns the launch's output shapes and dtypes,
    bumps no launch count, and reports one call with its cost."""
    name, kernel, args, kw, shapes = case
    before = kernel.launches
    with hlo_cost.record() as rec:
        out = kernel(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(o.device.type == "meta" for o in outs)
    assert kernel.launches == before
    assert rec.kernel_calls == {name: 1}
    flops, nbytes = kernel.cost(*args, **kw)
    assert rec.cost.by_op == {name: [flops, nbytes]}
    assert (rec.cost.flops, rec.cost.bytes) == (flops, nbytes)


def test_meta_route_refuses_what_the_launch_refuses():
    """The launch's own checks run on ``meta``: blocks the kernel does
    not take, operands of two dtypes (other than the CNN's bf16 x against
    f32 W), a dtype (float16, float64) or layout it does not take, a head
    dim it is not built for, gradients; a bf16 pair passes them with
    outputs of the launch's dtypes."""
    kw = dict(block_m=64, block_n=128, block_k=32)
    with pytest.raises(ValueError, match="not a multiple of the blocks"):
        matmul_kernel(_m(100, 64), _m(64, 256), **kw)
    with pytest.raises(ValueError, match="of one dtype"):
        matmul_kernel(_m(128, 64), _m(64, 256, dtype=torch.bfloat16), **kw)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="contiguous float32 or bfloat16"):
            matmul_kernel(_m(128, 64, dtype=dt), _m(64, 256, dtype=dt), **kw)
        with pytest.raises(ValueError, match="contiguous float32 or bfloat16"):
            flash_attention_kernel(*(_m(8, 128, 64, dtype=dt),) * 3, block_q=64,
                                   block_kv=64, scale=1.0, causal=True, window=None,
                                   q_len=128, kv_len=128)
    with pytest.raises(ValueError, match="contiguous float32"):
        matmul_kernel(_m(64, 128).t(), _m(64, 256), **kw)
    bf = torch.bfloat16
    assert matmul_kernel(_m(128, 64, dtype=bf), _m(64, 256, dtype=bf), **kw).dtype == bf
    dx, dw = matmul_dxdw_kernel(_m(64, 256, dtype=bf), _m(128, 256, dtype=bf),
                                _m(64, 128, dtype=bf), block_m=64, block_n=64, block_k=32)
    assert (dx.dtype, dw.dtype) == (torch.float32, torch.float32)
    assert flash_attention_kernel(*(_m(8, 128, 64, dtype=bf),) * 3, block_q=64,
                                  block_kv=64, scale=1.0, causal=True, window=None,
                                  q_len=128, kv_len=128).dtype == bf
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_kernel(_m(8, 128, 48), _m(8, 128, 48), _m(8, 128, 48), block_q=64,
                               block_kv=64, scale=1.0, causal=True, window=None, q_len=128,
                               kv_len=128)
    with pytest.raises(NotImplementedError, match="not differentiable"):
        matmul_kernel(_m(128, 64).requires_grad_(True), _m(64, 256), **kw)
    # the plain version on the CPU takes what the launch refuses
    assert matmul_kernel(torch.zeros(64, 128).t(), torch.zeros(64, 256), **kw).shape == (
        128, 256)


def test_cpu_route_is_charged_as_the_kernel():
    """On CPU tensors the plain version runs; the recorder charges the
    kernel's cost once, not the plain version's aten ops."""
    x, w = torch.ones(128, 64), torch.ones(64, 256)
    kw = dict(block_m=64, block_n=128, block_k=32)
    with hlo_cost.record() as rec:
        y = matmul_kernel(x, w, **kw)
    assert torch.equal(y, x @ w)
    assert rec.cost.by_op == {"matmul": list(matmul_kernel.cost(x, w, **kw))}


@pytest.mark.parametrize("q_len,kv_len,causal,window,q_off", [
    (100, 100, True, None, 0), (64, 128, True, 16, 64), (50, 70, False, None, 0),
    (32, 96, True, None, 40), (10, 5, True, None, 0)])
def test_admitted_pairs_count_the_plain_mask(q_len, kv_len, causal, window, q_off):
    q = torch.arange(q_len)[:, None] + q_off
    k = torch.arange(kv_len)[None, :]
    mask = (k < kv_len) & (q >= q_off)
    if causal:
        mask &= k <= q
    if window is not None:
        mask &= q - k < window
    assert admitted_pairs(q_len, kv_len, causal, window, q_off) == int(mask.sum())
