"""The port's bf16 route on the planned dense path against the JAX
package's, on the CPU: the repaired faults, each kernel's plain version at
bf16 against ``repro``'s Pallas kernel run interpreted on the same bf16
numpy operands, the dtype at every GEMM and attention call of the planned
forward, the planned forward, loss and every gradient of the smoke
qwen1.5-0.5b at ``compute_dtype="bfloat16"`` against ``repro``'s planned
bf16 step (its kernels interpreted), and ``plan_training(in_bytes=2)``.

Tolerances, each with the measurement behind it:
* bf16 kernel outputs (the forward matmul, flash): within one bf16 ulp of
  ``repro``'s, elementwise, the ulp taken at max(|ref|, 2^-8 max|ref|):
  both are f32 sums rounded once, in two orders that differ by about
  2^-18 max|ref| at these K, so only below that floor can two correct
  roundings lie further apart;
* f32 kernel outputs (dX, dW): 1e-5 * max(1, max |ref|), f32 sums of bf16
  products in another order;
* hidden states and logits: 2e-2 * max(1, max |ref|) of ``repro``'s planned
  bf16 forward (4.8e-3 measured on the plain path, 4.8e-3 planned: bf16
  activations rounded where XLA and PyTorch round them);
* the loss within 1e-3 relative (4.8e-4 measured planned), every gradient
  within 3e-2 * max(1, max |ref|) of ``jax.grad`` (1.23e-2 measured;
  ``repro``'s own bf16 gradients lie 1.30e-2 from its f32 ones).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import machine as jm
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.matmul.bwd import (
    matmul_dx_dw_pallas, matmul_nt_pallas, matmul_tn_pallas,
)
from repro.kernels.matmul.matmul import matmul_pallas
from repro.models import transformer as jtf
from repro.models.module import init_params as jax_init_params
from repro.runtime import train as jtr
from repro_torch.configs import TrainConfig, get_config, smoke_config
from repro_torch.convert import flatten_tree, params_from_repro
from repro_torch.core import fc_layer as fl
from repro_torch.core import machine as tm
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain
from repro_torch.kernels.matmul import bwd as mb
from repro_torch.kernels.matmul.matmul import matmul_plain
from repro_torch.models import transformer as tf
from repro_torch.runtime import train as tr

B, S, LAYERS, CHUNKS = 2, 64, 2, 4
BF = torch.bfloat16
F32_TOL = 1e-5
FWD_TOL = 2e-2
GRAD_TOL = 3e-2
LOSS_RTOL = 1e-3


def _np(t) -> np.ndarray:
    return np.asarray(t.float().detach().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32), np.float64)


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers (8 significant bits) at |a|."""
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return np.ldexp(1.0, np.frexp(a)[1] - 8)


def assert_within_ulp(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    floor = 2.0 ** -8 * float(np.abs(want).max())
    err = np.abs(got - want)
    assert bool((err <= bf16_ulp(np.maximum(np.abs(want), floor))).all()), float(err.max())


def assert_close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _bf16(rng, *shape, scale=1.0):
    """The same bf16 numbers for both packages: (torch bf16, jnp bf16)."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    t = torch.from_numpy(a).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# -- the repaired faults ----------------------------------------------------------


def test_flash_plain_returns_q_dtype():
    """flash_attention_plain writes q's dtype, as _fa_kernel writes
    ``q.dtype``: the f32 result rounded once."""
    rng = np.random.default_rng(0)
    q, k, v = (_bf16(rng, 4, 64, 64)[0] for _ in range(3))
    kw = dict(block_q=32, block_kv=32, scale=0.125, causal=True, window=None, q_len=64,
              kv_len=64)
    got = flash_attention_plain(q, k, v, **kw)
    assert got.dtype == BF
    assert torch.equal(got, flash_attention_plain(q.float(), k.float(), v.float(), **kw)
                       .to(BF))


def test_fc_backward_keeps_dy_dtype(monkeypatch):
    """fc_layer's backward hands dY to the dX and dW kernels in its own dtype
    (bf16, planned at two bytes an element) and casts their f32 outputs to
    x's and w's dtypes, as repro's _fc_bwd does."""
    seen = []
    for name in ("matmul_dx", "matmul_dw"):
        real = getattr(fl, name)

        def spy(a, b, *, schedule, real=real, name=name):
            out = real(a, b, schedule=schedule)
            seen.append((name, a.dtype, b.dtype, out.dtype))
            return out
        monkeypatch.setattr(fl, name, spy)
    rng = np.random.default_rng(1)
    x = _bf16(rng, 96, 64)[0].requires_grad_(True)
    w = _bf16(rng, 64, 80, scale=0.125)[0].requires_grad_(True)
    y = fl.fc_layer(x, w)
    assert y.dtype == BF
    dx, dw = torch.autograd.grad(y.float().square().sum(), (x, w))
    assert (dx.dtype, dw.dtype) == (BF, BF)
    assert seen == [("matmul_dx", BF, BF, torch.float32),
                    ("matmul_dw", BF, BF, torch.float32)]
    g = (2 * y.float()).to(BF)
    assert torch.equal(dx, (g.float() @ w.float().t()).to(BF))
    assert torch.equal(dw, (x.float().t() @ g.float()).to(BF))


@pytest.mark.parametrize("kernel", ["matmul", "matmul_nt", "matmul_tn", "matmul_dx_dw"])
def test_plain_versions_round_the_f32_product_once(kernel):
    """Each GEMM's plain version at bf16 is the f32 product of its operands
    rounded once to the output dtype: bf16 for the forward matmul, f32 for
    dX and dW; two activation dtypes, or bf16 weights against f32
    activations, raise (f32 weights against bf16 activations are the CNN's
    mixed route, tests/test_torch_cnn_bf16.py)."""
    rng = np.random.default_rng(2)
    a, b, c = _bf16(rng, 32, 48)[0], _bf16(rng, 40, 48)[0], _bf16(rng, 32, 40)[0]
    kw = dict(block_m=8, block_n=8, block_k=8)
    if kernel == "matmul":
        got, want = matmul_plain(c, b, **kw), (c.float() @ b.float()).to(BF)
        bad = (c.float(), b)
    elif kernel == "matmul_nt":
        got, want = mb.matmul_nt_plain(a, b, **kw), a.float() @ b.float().t()
        bad = (a.float(), b)
    elif kernel == "matmul_tn":
        got, want = mb.matmul_tn_plain(c, a, **kw), c.float().t() @ a.float()
        bad = (c.float(), a)
    else:
        got = mb.matmul_dxdw_plain(a, b, c, **kw)
        want = (a.float() @ b.float().t(), c.float().t() @ a.float())
        bad = (a, b, c.float())
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    plain = {"matmul": matmul_plain, "matmul_nt": mb.matmul_nt_plain,
             "matmul_tn": mb.matmul_tn_plain, "matmul_dx_dw": mb.matmul_dxdw_plain}[kernel]
    with pytest.raises(ValueError, match="of one dtype"):
        plain(*bad, **kw)


# -- each plain version against repro's Pallas kernel, interpreted ----------------

# (m, k, n, (block_m, block_n, block_k)): the forward roles of the FC layer
GEMM_CASES = [(64, 96, 128, (32, 64, 32)), (48, 160, 80, (16, 80, 32)),
              (128, 64, 64, (64, 32, 64))]


@pytest.mark.parametrize("m,k,n,blocks", GEMM_CASES)
def test_matmul_plain_matches_pallas_at_bf16(m, k, n, blocks):
    rng = np.random.default_rng(3)
    (x, jx), (w, jw) = _bf16(rng, m, k), _bf16(rng, k, n, scale=k ** -0.5)
    bm, bn, bk = blocks
    want = matmul_pallas(jx, jw, block_m=bm, block_n=bn, block_k=bk, interpret=True)
    got = matmul_plain(x, w, block_m=bm, block_n=bn, block_k=bk)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_within_ulp(got, want)


@pytest.mark.parametrize("m,k,n,blocks", GEMM_CASES)
def test_backward_plains_match_pallas_at_bf16(m, k, n, blocks):
    """NT, TN and the fused kernel at bf16 with repro's FC backward's
    out_dtype=f32."""
    rng = np.random.default_rng(4)
    (x, jx), (w, jw) = _bf16(rng, m, k), _bf16(rng, k, n, scale=k ** -0.5)
    g, jg = _bf16(rng, m, n)
    bm, bn, bk = blocks
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    jkw = dict(kw, out_dtype=jnp.float32, interpret=True)
    dx = mb.matmul_nt_plain(g, w, **kw)
    dw = mb.matmul_tn_plain(x, g, **kw)
    assert dx.dtype == dw.dtype == torch.float32
    assert_close(dx, matmul_nt_pallas(jg, jw, **jkw), F32_TOL)
    assert_close(dw, matmul_tn_pallas(jx, jg, **jkw), F32_TOL)
    fdx, fdw = mb.matmul_dxdw_plain(g, w, x, **kw)
    jdx, jdw = matmul_dx_dw_pallas(jg, jw, jx, **jkw)
    assert_close(fdx, jdx, F32_TOL)
    assert_close(fdw, jdw, F32_TOL)


# (BHq, BHkv, S, D, causal, window, block_q, block_kv)
FLASH_CASES = [(4, 2, 64, 64, True, None, 32, 32), (2, 2, 96, 64, True, 40, 32, 16),
               (4, 4, 64, 32, False, None, 64, 32)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_at_bf16(case):
    bhq, bhkv, s, d, causal, window, bq, bkv = case
    rng = np.random.default_rng(5)
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, bhq, s, d), _bf16(rng, bhkv, s, d),
                                 _bf16(rng, bhkv, s, d))
    kw = dict(block_q=bq, block_kv=bkv, scale=d ** -0.5, causal=causal, window=window,
              q_len=s, kv_len=s)
    want = flash_attention_pallas(jq, jk, jv, **kw, interpret=True)
    got = flash_attention_plain(q, k, v, **kw)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_within_ulp(got, want)


# -- the planned bf16 step against repro's ------------------------------------------


def _cfgs():
    jcfg = dataclasses.replace(jax_smoke_config("qwen1.5-0.5b"), family="transformer",
                               n_layers=LAYERS)
    cfg = dataclasses.replace(smoke_config("qwen1.5-0.5b"), family="transformer",
                              n_layers=LAYERS)
    return jcfg, cfg


def _kw(remat):
    return dict(param_dtype="float32", compute_dtype="bfloat16", planned_kernels=True,
                loss_chunks=CHUNKS, remat=remat)


@pytest.fixture(scope="module")
def ref():
    """repro's side, computed once: weights, a batch, the planned bf16
    forward (hidden, logits, the dtype at every fc_layer and attention-cell
    call it traces) and jax.value_and_grad of its planned bf16 loss at
    remat none and block."""
    jcfg, cfg = _cfgs()
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(
        jtf.param_defs(jcfg), jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][0, -3:] = -1
    calls = []
    real_fc, real_attn = jtf.fc_layer, jtf._attn_vjp

    def spy_fc(x, w, *a):
        calls.append(("fc", str(x.dtype), str(w.dtype)))
        return real_fc(x, w, *a)

    def spy_attn(q, k, v, *a):
        calls.append(("attn", str(q.dtype), str(k.dtype), str(v.dtype)))
        return real_attn(q, k, v, *a)

    sched = jtf.plan_forward(jcfg, B, S, in_bytes=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtf, "fc_layer", spy_fc)
        mp.setattr(jtf, "_attn_vjp", spy_attn)
        h, _ = jtf.forward(jcfg, tree, jnp.asarray(batch["tokens"]),
                           compute_dtype=jnp.bfloat16, use_kernels=True, schedules=sched)
        logits = jtf.logits(jcfg, tree, h, schedules=sched)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = {}
    for remat in ("none", "block"):
        loss, g = jax.value_and_grad(jtr.make_loss_fn(jcfg, JaxTrainConfig(**_kw(remat))))(
            tree, jb)
        grads[remat] = (float(loss), flatten_tree(g))
    return dict(tree=tree, batch=batch, calls=calls, hidden=h, logits=logits, grads=grads,
                cfg=cfg)


def test_planned_forward_dtype_route_is_repros(ref, monkeypatch):
    """The dtype of x and w at every fc_layer call and of q, k, v at every
    attention cell of the port's planned bf16 forward and head, in order,
    equals repro's (its scanned layer body traced once, so its calls
    repeat once per layer; the head's GEMM last)."""
    cfg = ref["cfg"]
    calls = []
    real_fc, real_attn = tf.fc_layer, tf._attn_vjp

    def name(dt):
        return str(dt).removeprefix("torch.")

    def spy_fc(x, w, *a):
        calls.append(("fc", name(x.dtype), name(w.dtype)))
        return real_fc(x, w, *a)

    def spy_attn(q, k, v, *a):
        calls.append(("attn", name(q.dtype), name(k.dtype), name(v.dtype)))
        return real_attn(q, k, v, *a)

    monkeypatch.setattr(tf, "fc_layer", spy_fc)
    monkeypatch.setattr(tf, "_attn_vjp", spy_attn)
    params = params_from_repro(ref["tree"], device="cpu")
    sched = tf.plan_forward(cfg, B, S, in_bytes=2)
    h, _ = tf.forward(cfg, params, torch.from_numpy(ref["batch"]["tokens"]),
                      compute_dtype=BF, use_kernels=True, schedules=sched)
    tf.logits(cfg, params, h, schedules=sched)
    body, head = ref["calls"][:-1], ref["calls"][-1:]
    assert calls == body * LAYERS + head
    assert all(dt == "bfloat16" for c in calls for dt in c[1:])


@pytest.mark.parametrize("planned", [True, False])
def test_bf16_forward_matches_repro_planned(ref, planned):
    """The port's planned and plain bf16 forwards: hidden states and logits
    in bf16, within FWD_TOL of repro's planned bf16 forward."""
    cfg = ref["cfg"]
    params = params_from_repro(ref["tree"], device="cpu")
    sched = tf.plan_forward(cfg, B, S, in_bytes=2) if planned else None
    h, _ = tf.forward(cfg, params, torch.from_numpy(ref["batch"]["tokens"]),
                      compute_dtype=BF, use_kernels=planned, schedules=sched)
    logits = tf.logits(cfg, params, h, schedules=sched)
    assert h.dtype == logits.dtype == BF
    assert_close(h, ref["hidden"], FWD_TOL)
    assert_close(logits, ref["logits"], FWD_TOL)


@pytest.mark.parametrize("remat", ["none", "block"])
def test_bf16_loss_and_grads_match_repro_planned(ref, remat):
    """TrainConfig(compute_dtype="bfloat16", planned_kernels=True) through
    runtime/train.py::make_loss_fn: the loss within LOSS_RTOL and every
    gradient within GRAD_TOL of jax.grad of repro's planned bf16 loss."""
    cfg = ref["cfg"]
    jloss, jgrads = ref["grads"][remat]
    params = {k: v.requires_grad_(True)
              for k, v in params_from_repro(ref["tree"], device="cpu").items()}
    loss = tr.make_loss_fn(cfg, TrainConfig(**_kw(remat)))(
        params, tr.batch_to(ref["batch"], "cpu"))
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
    for k, g in zip(params, grads):
        assert g.dtype == torch.float32, k
        assert_close(g, jgrads[k], GRAD_TOL)


# -- the plan at two bytes an element ------------------------------------------------


@pytest.mark.parametrize("machine", ["MANTICORE", "TPU_V5E"])
def test_plan_training_bf16_matches_repro(machine):
    jcfg, cfg = _cfgs()
    sched = tf.plan_training(cfg, B, S, loss_chunks=CHUNKS, in_bytes=2,
                             machine=getattr(tm, machine))
    want = jtf.plan_training(jcfg, B, S, loss_chunks=CHUNKS, in_bytes=2,
                             machine=getattr(jm, machine))
    assert set(sched) == set(want)
    for k in want:
        assert dataclasses.asdict(sched[k]) == dataclasses.asdict(want[k]), k


def test_plan_training_bf16_h100_picks_for_qwen():
    """The main path's H100 plan at in_bytes=2 keeps the f32 blocks: matmul
    64/128/32, NT 64/32/128, TN 32/128/64 (57,344 B each: the f32
    accumulator and two bf16 stages), flash 128/128 (132,096 B)."""
    sched = tf.plan_training(get_config("qwen1.5-0.5b"), 4, 2048, loss_chunks=4,
                             in_bytes=2)
    assert sched["attn"].block_dict() == {"block_q": 128, "block_kv": 128}
    assert sched["attn"].vmem_bytes == 132_096
    for cell in ("qkv", "wo", "mlp_up", "mlp_down", "logits"):
        assert sched[cell].block_dict() == {"block_m": 64, "block_n": 128, "block_k": 32}
        assert sched[f"{cell}.dx"].block_dict() == {"block_m": 64, "block_n": 32,
                                                     "block_k": 128}
        assert sched[f"{cell}.dx"].algorithm == "direct"
        assert sched[f"{cell}.dw"].block_dict() == {"block_m": 32, "block_n": 128,
                                                     "block_k": 64}
        for part in ("", ".dx", ".dw"):
            assert sched[cell + part].vmem_bytes == 57_344


# -- costs at the operands' and outputs' element sizes ----------------------------


def test_kernel_costs_read_each_element_size():
    """CudaKernel.cost charges each operand and output at its own element
    size: the bf16 forward matmul writes bf16, dX and dW are f32, flash
    writes q's dtype; f32 costs are unchanged."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul.matmul import matmul_kernel

    m, k, n = 64, 96, 128
    kw = dict(block_m=32, block_n=64, block_k=32)
    for dt, e in ((torch.float32, 4), (BF, 2)):
        x, w, g = (torch.empty(s, dtype=dt, device="meta") for s in ((m, k), (k, n), (m, n)))
        assert matmul_kernel.cost(x, w, **kw) == (2.0 * m * n * k, e * (m * k + k * n + m * n))
        assert mb.matmul_nt_kernel.cost(g, w, **kw) == (2.0 * m * n * k,
                                                           e * (m * n + k * n) + 4 * m * k)
        assert mb.matmul_tn_kernel.cost(x, g, **kw) == (2.0 * m * n * k,
                                                       e * (m * k + m * n) + 4 * k * n)
        assert mb.matmul_dxdw_kernel.cost(g, w, x, **kw) == (
            4.0 * m * n * k, e * (m * n + k * n + m * k) + 4 * (m * k + k * n))
        q = torch.empty(8, 64, 64, dtype=dt, device="meta")
        kv = torch.empty(4, 64, 64, dtype=dt, device="meta")
        fkw = dict(block_q=32, block_kv=32, scale=0.125, causal=False, window=None,
                   q_len=64, kv_len=64)
        flops, nbytes = flash_attention_kernel.cost(q, kv, kv, **fkw)
        assert (flops, nbytes) == (4.0 * 8 * 64 * 64 * 64, e * 64 * (2 * 8 * 64 + 2 * 4 * 64))
        out = flash_attention_kernel(q, kv, kv, **fkw) if dt == BF else None
        assert out is None or out.dtype == BF
