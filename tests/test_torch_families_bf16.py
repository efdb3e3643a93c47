"""The bf16 route of the port's MoE, RWKV-6, Mamba-2/Zamba2 and
encoder-decoder families against the JAX package's, on the CPU: the
repaired rounding points, the dtype of every matrix product, one block
op by op, the whole smoke forward, loss and every gradient, and the dtypes
of a bf16 decode's recurrent state and KV cache.

The oracle is ``repro`` run op by op (``jax.disable_jit()``): every
primitive of its jaxpr rounds to its dtype, which is the function its
source states.  ``repro`` under ``jax.jit`` is XLA-CPU's fusion of that
jaxpr, which skips roundings the jaxpr states (a bf16 convert pair inside
a fusion), and a TPU fuses differently again, so a jitted forward is one
compiler's answer and not the function: on one layer it lies 0.085-0.278
of the elements more than one bf16 ulp from the op-by-op forward (PERF.md,
section 6).

Both packages run from the same weights (``tests/test_torch_families.py``'s
``_model``: ``repro``'s seeded init with its constant leaves perturbed) on
the same numpy inputs.  The one-block and whole-forward checks run the
port under :class:`XlaDot`, which computes each bf16 product as XLA's CPU
dot does (the f32 product of the upcast operands, rounded once): PyTorch's
CPU bf16 GEMM sums the same f32 products in another order (4 of 24,576
outputs of a 64 x 128 x 384 product one ulp apart), which the
encoder-decoder's non-causal attention carries from one flipped element
to a whole head (0.146 of its hidden state past one ulp without it, 0.065
with it).  On the card cuBLAS sums in its own order either way.

Tolerances, each with the measurement behind it:
* activations: equal to ``jax.nn``'s op by op at every bf16 input whose
  intermediates are normal numbers (XLA flushes subnormals to zero);
* one block, op by op: the share of hidden-state elements more than one
  bf16 ulp apart, the ulp at max(|ref|, 2^-8 max|ref|), at most
  :data:`SHARE_BOUND` (measured 0.000 for the MoE and Zamba2, 0.001 for
  RWKV-6, 0.065 for the encoder-decoder; the dense family's was 0.054
  before the activations' repair, and every bound stays below twice that);
* the whole smoke forward (logits), loss and every gradient against
  ``jax.value_and_grad`` of ``repro``'s bf16 loss op by op: within the
  larger of ``tests/test_torch_bf16.py``'s tolerance (2e-2 of scale, 1e-3
  relative, 3e-2 of scale) and twice ``repro``'s own distance from its f32
  loss, leaf by leaf (measured at most 0.39 of that tolerance, the
  encoder-decoder's dec/attn/wq; grok-1's are equal bit for bit, and
  RWKV-6's logits lie 1.2e-2 of scale from the op-by-op forward against
  0.33 from the jitted one).
"""

import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.extend import core as jcore
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.runtime import train as jtr
from repro_torch.configs import TrainConfig
from repro_torch.convert import flatten_tree
from repro_torch.models import layers as ll
from repro_torch.runtime import train as tr
from test_torch_families import _model

ARCHS = ("qwen3-moe-235b-a22b", "grok-1-314b", "rwkv6-1.6b", "zamba2-1.2b",
         "seamless-m4t-medium")
B, S = 2, 32
BF = torch.bfloat16
SHARE_BOUND = {"qwen3-moe-235b-a22b": 0.01, "grok-1-314b": 0.01, "rwkv6-1.6b": 0.01,
               "zamba2-1.2b": 0.01, "seamless-m4t-medium": 0.1}
FWD_TOL, LOSS_RTOL, GRAD_TOL = 2e-2, 1e-3, 3e-2
OWN_RATIO = 2.0


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32), np.float64)


def _past_one_ulp(got, want) -> float:
    """The share of elements of ``got`` more than one bf16 ulp from
    ``want``, the ulp at max(|want|, 2^-8 max|want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    a = np.maximum(np.abs(want), 2.0 ** -8 * np.abs(want).max())
    ulp = np.ldexp(1.0, np.frexp(np.maximum(a, 2.0 ** -126))[1] - 8)
    return float(np.mean(np.abs(got - want) > ulp))


def _dist(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _one_layer(arch: str):
    over = {"n_layers": 1}
    if arch == "seamless-m4t-medium":
        over["n_enc_layers"] = 1
    return _model(arch, **over)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][0, -3:] = -1
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _repro_logits(m, batch, dtype):
    kw = {"frames": jnp.asarray(batch["frames"])} if "frames" in batch else {}
    h = m.jfam.forward(m.jcfg, m.jparams, jnp.asarray(batch["tokens"]), compute_dtype=dtype,
                       **kw)[0]
    return m.jfam.logits(m.jcfg, m.jparams, h)


def _port_logits(m, batch):
    kw = {"frames": torch.from_numpy(batch["frames"])} if "frames" in batch else {}
    h, _ = m.fam.forward(m.cfg, m.params, torch.from_numpy(batch["tokens"]),
                         compute_dtype=BF, **kw)
    return h, m.fam.logits(m.cfg, m.params, h)


class XlaDot(TorchDispatchMode):
    """Each bf16 x bf16 ``mm``/``bmm`` computed as XLA's CPU dot computes
    it: the f32 product of the upcast operands, rounded once to bf16."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm)
                and all(a.dtype == BF for a in args[:2])):
            return func(args[0].float(), args[1].float()).to(BF)
        return func(*args, **(kwargs or {}))


# -- the repaired rounding points ---------------------------------------------------


def _normal_inside(x: np.ndarray) -> np.ndarray:
    """The inputs at which every intermediate of the three activations is a
    normal number, where XLA's flushing of subnormals to zero cannot act:
    |x| >= 2^-60 (the products) and x > -87 (1 / (1 + exp(-x)))."""
    return (np.abs(x) >= 2.0 ** -60) & (x > -87)


def _all_bf16() -> np.ndarray:
    """Every finite bf16 number, as f32."""
    x = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return x[np.isfinite(x)]


@pytest.mark.parametrize("name", ["silu", "gelu", "sigmoid"])
def test_activation_rounds_as_repro_at_bf16(name):
    """silu, gelu and sigmoid at every finite bf16 input equal ``jax.nn``'s
    op by op (XLA's logistic is 1 / (1 + exp(-x)) rounded at each op;
    jax.nn.silu rounds the sigmoid before its product, gelu rounds each
    step and its constants), wherever XLA's output is normal."""
    port, ref = getattr(ll, name), getattr(jax.nn, name)
    x = _all_bf16()
    with jax.disable_jit():
        want = np.asarray(ref(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = port(torch.from_numpy(x).to(BF)).float().numpy()
    bad = _normal_inside(x) & (got != want)
    assert not bad.any(), (int(bad.sum()), x[bad][:5], got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_activations_keep_f32_and_f64_bits(dtype):
    """Above bf16 the helpers are PyTorch's fused functions, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096) * 6).to(dtype)
    assert torch.equal(ll.silu(x), F.silu(x))
    assert torch.equal(ll.gelu(x), F.gelu(x, approximate="tanh"))
    assert torch.equal(ll.sigmoid(x), torch.sigmoid(x))
    assert ll._ACT["silu"] is ll.silu and ll._ACT["gelu"] is ll.gelu


def test_bf16_sigmoid_gradient_is_repros_rule():
    """The bf16 sigmoid's gradient is jax.nn.sigmoid's rule g * (y * (1 - y))
    op by op (equal to ``jax.vjp``'s wherever no intermediate is
    subnormal), finite where exp(-x) overflows."""
    x = _all_bf16()
    g = np.random.default_rng(1).standard_normal(x.size).astype(np.float32)
    with jax.disable_jit():
        xj, gj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
        want = np.asarray(jax.vjp(jax.nn.sigmoid, xj)[1](gj)[0].astype(jnp.float32))
    xt = torch.from_numpy(x).to(BF).requires_grad_(True)
    (got,) = torch.autograd.grad(ll.sigmoid(xt), xt, torch.from_numpy(g).to(BF))
    got = got.float().numpy()
    assert np.isfinite(got).all()
    inside = _normal_inside(x)
    assert np.array_equal(got[inside], want[inside])


def test_grok1_smoke_bf16_lies_where_repros_lies():
    """grok-1's smoke forward in bf16 (4 layers, tanh-GELU experts) lies as
    far from repro's f32 logits as repro's own op-by-op bf16 forward,
    within 25 % (both 1.42e-2 of scale measured).  With a GELU that rounded
    once the port lay 5.29e-2 away, 3.7 times as far: the two packages
    agree at two layers (1.86e-2 each) and part over the last two, where
    repro's GELU rounds at every step of its jaxpr, its constants too."""
    m = _model("grok-1-314b")
    batch = _batch(m.cfg)
    ref = jax.jit(lambda: _repro_logits(m, batch, jnp.float32))()
    with jax.disable_jit():
        own = _repro_logits(m, batch, jnp.bfloat16)
    with torch.no_grad():
        _, got = _port_logits(m, batch)
    assert _dist(got, ref) <= 1.25 * _dist(own, ref), (_dist(got, ref), _dist(own, ref))


# -- the dtype of every matrix product ---------------------------------------------

_SHAPE_OPS = {"reshape", "transpose", "broadcast_in_dim", "squeeze", "expand_dims", "copy",
              "copy_p", "slice", "dynamic_slice", "concatenate"}


def _sub_jaxprs(eqn):
    for p in eqn.params.values():
        for sub in (p if isinstance(p, (tuple, list)) else (p,)):
            j = sub if isinstance(sub, jcore.Jaxpr) else getattr(sub, "jaxpr", None)
            if isinstance(j, jcore.Jaxpr):
                yield j


def _repro_products(jaxpr, up=frozenset(), reps=1, out=None) -> list:
    """(lhs, rhs, result) dtypes of every ``dot_general`` that contracts a
    dimension, in order (a scan's body ``length`` times).  An f32 operand
    upcast from bf16 (through shape-only ops) counts as bf16: its values
    are bf16's, as a ``preferred_element_type=f32`` dot's are.  A
    dot_general that contracts nothing is an elementwise product (PyTorch's
    einsum multiplies there)."""
    out = [] if out is None else out
    up = set(up)
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        ins = [v for v in eqn.invars if isinstance(v, jcore.Var)]
        if name == "convert_element_type":
            if str(eqn.invars[0].aval.dtype) == "bfloat16" and eqn.params["new_dtype"] == jnp.float32:
                up.add(eqn.outvars[0])
        elif name in _SHAPE_OPS and ins and all(v in up for v in ins):
            up.update(eqn.outvars)
        elif name == "dot_general":
            (lc, rc), _ = eqn.params["dimension_numbers"]
            if lc:
                out.extend([tuple("bfloat16" if isinstance(v, jcore.Var) and v in up
                                  else str(v.aval.dtype) for v in eqn.invars)
                            + (str(eqn.outvars[0].aval.dtype),)] * reps)
            continue
        n = eqn.params.get("length", 1) if name == "scan" else 1
        for sub in _sub_jaxprs(eqn):
            inner = {iv for ov, iv in zip(eqn.invars, sub.invars)
                     if isinstance(ov, jcore.Var) and ov in up}
            _repro_products(sub, inner, reps * n, out)
    return out


_VIEWS = {"view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand",
          "unsqueeze", "squeeze", "clone", "contiguous", "as_strided", "alias", "slice",
          "select", "_reshape_alias", "unbind", "split", "split_with_sizes", "detach"}


class ProductSpy(TorchDispatchMode):
    """Records (lhs, rhs, result) dtypes of every ``mm``/``bmm``/``addmm``,
    an f32 operand upcast from bf16 (through views) counting as bf16."""

    def __init__(self):
        super().__init__()
        self.seen, self._up = [], {}

    def _is_up(self, t) -> bool:
        ref = self._up.get(id(t))
        return ref is not None and ref() is t

    def _mark(self, out):
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self._up[id(t)] = weakref.ref(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        first = args[0] if args else None
        if name in ("_to_copy", "to") and isinstance(first, torch.Tensor):
            if first.dtype == BF and out.dtype == torch.float32:
                self._mark(out)
        elif name in _VIEWS and isinstance(first, torch.Tensor) and self._is_up(first):
            self._mark(out)
        elif name in ("mm", "bmm", "addmm"):
            a, b = args[-2:]
            self.seen.append(tuple("bfloat16" if self._is_up(t) else
                                   str(t.dtype).removeprefix("torch.") for t in (a, b))
                             + (str(out.dtype).removeprefix("torch."),))
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_product_dtypes_match_repro(arch):
    """The (lhs, rhs, result) dtypes of every matrix product of the one-layer
    bf16 forward and its logits, in order, equal repro's (the
    ``dot_general`` equations of its jaxpr)."""
    m = _one_layer(arch)
    batch = _batch(m.cfg)
    kw = {"frames": jnp.asarray(batch["frames"])} if "frames" in batch else {}

    def fwd(p, t, **k):
        h = m.jfam.forward(m.jcfg, p, t, compute_dtype=jnp.bfloat16, **k)[0]
        return m.jfam.logits(m.jcfg, p, h)

    want = _repro_products(jax.make_jaxpr(fwd)(m.jparams, jnp.asarray(batch["tokens"]),
                                               **kw).jaxpr)
    with torch.no_grad(), ProductSpy() as spy:
        _port_logits(m, batch)
    assert spy.seen == want
    assert ("bfloat16", "bfloat16", "bfloat16") in want


# -- one block, op by op -------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_one_block_matches_repro_op_by_op(arch):
    """The one-layer bf16 forward's hidden state against repro's op by op:
    at most SHARE_BOUND of its elements more than one bf16 ulp apart
    (before the activations' repair: 0.070 MoE, 0.046 grok-1, 0.326
    RWKV-6, 0.343 Zamba2, 0.146 encoder-decoder)."""
    m = _one_layer(arch)
    batch = _batch(m.cfg)
    kw = {"frames": jnp.asarray(batch["frames"])} if "frames" in batch else {}
    with jax.disable_jit():
        want = m.jfam.forward(m.jcfg, m.jparams, jnp.asarray(batch["tokens"]),
                              compute_dtype=jnp.bfloat16, **kw)[0]
    with torch.no_grad(), XlaDot():
        got, _ = _port_logits(m, batch)
    assert got.dtype == BF
    assert _past_one_ulp(got, want) <= SHARE_BOUND[arch]


# -- the whole smoke forward, loss and gradients ---------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_bf16_loss_and_grads_match_repro(arch):
    """The smoke config's bf16 logits, generic loss and every gradient
    against jax.value_and_grad of repro's bf16 loss op by op, each within
    the larger of test_torch_bf16.py's tolerance and OWN_RATIO times
    repro's own distance from its f32 loss (under jit)."""
    m = _model(arch)
    batch = _batch(m.cfg)
    kw = dict(param_dtype="float32", planned_kernels=False, loss_chunks=2, remat="none")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = {}
    for dt in ("bfloat16", "float32"):
        vg = jax.value_and_grad(jtr.make_loss_fn(m.jcfg, JaxTrainConfig(**kw, compute_dtype=dt)))
        logits = functools.partial(_repro_logits, m, batch, getattr(jnp, dt))
        if dt == "bfloat16":
            with jax.disable_jit():
                (loss, grads), logits = vg(m.jparams, jb), logits()
        else:
            (loss, grads), logits = jax.jit(vg)(m.jparams, jb), jax.jit(logits)()
        ref[dt] = (float(loss), flatten_tree(jax.tree_util.tree_map(np.asarray, grads)),
                   logits)
    (l16, g16, y16), (l32, g32, y32) = ref["bfloat16"], ref["float32"]
    params = {k: v.clone().requires_grad_(True) for k, v in m.params.items()}
    with XlaDot():
        with torch.no_grad():
            _, logits = _port_logits(m, batch)
        loss = tr.make_loss_fn(m.cfg, TrainConfig(**kw, compute_dtype="bfloat16"))(
            params, tr.batch_to(batch, "cpu"))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert logits.dtype == BF
    assert _dist(logits, y16) <= max(FWD_TOL, OWN_RATIO * _dist(y16, y32))
    loss = float(loss.detach())
    assert abs(loss - l16) <= max(LOSS_RTOL, OWN_RATIO * abs(l16 - l32) / abs(l32)) * abs(l16)
    for k, g in grads.items():
        assert g.dtype == torch.float32
        assert _dist(g, g16[k]) <= max(GRAD_TOL, OWN_RATIO * _dist(g16[k], g32[k])), k


# -- the dtypes of a bf16 decode's state -------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_state_keeps_repros_dtypes(arch):
    """init_cache at bf16 gives repro's leaves, shapes and dtypes (RWKV-6's
    tm_x/cm_x bf16 and wkv f32, Zamba2's conv bf16 and ssd f32, KV caches
    bf16), and a bf16 prefill and one decode step keep them."""
    m = _one_layer(arch)
    batch = _batch(m.cfg)
    max_seq = S + 8
    want = flatten_tree(jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        m.jfam.init_cache(m.jcfg, B, max_seq, jnp.bfloat16)))
    cache = m.fam.init_cache(m.cfg, B, max_seq, BF, device="cpu")
    leaves = lambda c: {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))  # noqa: E731
                        for k, v in flatten_tree(c).items()}
    assert leaves(cache) == want
    kw = {"frames": torch.from_numpy(batch["frames"])} if "frames" in batch else {}
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        h, cache = m.fam.forward(m.cfg, m.params, tokens, cache=cache, compute_dtype=BF, **kw)
        h2, cache = m.fam.forward(m.cfg, m.params, tokens[:, :1], pos0=S, cache=cache,
                                  compute_dtype=BF)
    assert h.dtype == h2.dtype == BF and bool(torch.isfinite(h2.float()).all())
    assert leaves(cache) == want
