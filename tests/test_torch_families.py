"""The port's MoE, RWKV-6, Mamba-2/Zamba2 and encoder-decoder families
against the JAX package's, on the CPU: the registries and configs, the
parameter trees, the forwards, the loss and every gradient, the cached
decode against the full forward, the SSD scan, the MoE planner and the
MoE cell of the block planner, and the launcher.

Both packages run from the same weights (``repro``'s seeded init, its
zero- and one-initialized leaves perturbed so that every term is live,
carried across with ``convert``) on the same numpy inputs.

Tolerances (f32 unless stated):
* logits and caches: 1e-5 * max(1, max |ref|) (the same function with the
  sums in another order);
* the loss and every gradient: 1e-4 * max(1, max |ref|);
* decode against the full forward: the JAX package's own tests' 1e-3
  (1e-4 for the MoE where no row is dropped);
* f64 runs: 1e-10 * max(1, max |ref|);
* planners, configs, segments and parameter counts: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.registry import FAMILY_DEFAULT_ARCH as JAX_FAMILY_DEFAULT_ARCH
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import machine as jm
from repro.models import mamba2 as jmamba2
from repro.models import zamba2 as jzamba2
from repro.models.module import init_params as jax_init_params
from repro.models.registry import FAMILIES as JAX_FAMILIES
from repro.models.registry import get_family as jax_get_family
from repro.plan import planners as jp
from repro.runtime import train as jtr
from repro_torch.configs import (
    ARCH_IDS, FAMILY_DEFAULT_ARCH, TrainConfig, get_config, smoke_config,
)
from repro_torch.convert import flatten_tree, params_from_repro
from repro_torch.core import machine as tm
from repro_torch.launch import train as launch
from repro_torch.models import mamba2, moe, zamba2
from repro_torch.models.module import count_params
from repro_torch.models.registry import FAMILIES, get_family
from repro_torch.plan import planners as tp
from repro_torch.runtime import train as tr

TOL, TOL_GRAD, TOL_F64 = 1e-5, 1e-4, 1e-10
ARCHS = ("qwen3-moe-235b-a22b", "grok-1-314b", "rwkv6-1.6b", "zamba2-1.2b",
         "seamless-m4t-medium")
NOT_PORTED = set()
B = 2
MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]


def assert_close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def seq_len(cfg) -> int:
    """Two SSD chunks for Zamba2 (the inter-chunk recurrence runs); 32
    tokens elsewhere."""
    return 2 * mamba2.CHUNK if cfg.family == "zamba2" else 32


@dataclasses.dataclass
class Model:
    jcfg: object
    cfg: object
    jfam: object
    fam: object
    tree: dict  # repro's params as numpy
    params: dict  # the same, carried across

    @property
    def jparams(self):
        return jax.tree_util.tree_map(jnp.asarray, self.tree)


def _gains_perturbed(tree: dict, seed: int) -> dict:
    """The init with seeded N(0, 0.3) noise on the leaves it sets to zeros
    or ones (norm gains, RWKV-6's token-shift lerps, bonus and decay base,
    Mamba-2's A_log, D, dt bias and conv bias), so that every term of the
    families' math is live; the matrices keep their init."""
    rng = np.random.default_rng(seed + 100)

    def leaf(x):
        x = np.asarray(x)
        if np.all(x == x.flat[0]):
            return (x + rng.standard_normal(x.shape) * 0.3).astype(np.float32)
        return x
    return jax.tree_util.tree_map(leaf, tree)


def _model(arch: str, seed: int = 0, **overrides) -> Model:
    jcfg = dataclasses.replace(jax_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(smoke_config(arch), **overrides)
    jfam = jax_get_family(jcfg.family)
    tree = _gains_perturbed(jax_init_params(jfam.param_defs(jcfg), jax.random.PRNGKey(seed),
                                            jnp.float32), seed)
    return Model(jcfg, cfg, jfam, get_family(cfg.family), tree,
                 params_from_repro(tree, device="cpu"))


def _inputs(cfg, S=None, seed=1):
    """Tokens [B, S], labels with masked positions, and (encdec) seeded
    frames [B, enc_seq, d]."""
    rng = np.random.default_rng(seed)
    S = S or seq_len(cfg)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][0, -3:] = -1
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jkw(batch):
    return {"frames": jnp.asarray(batch["frames"])} if "frames" in batch else {}


def _tkw(batch):
    return {"frames": torch.from_numpy(batch["frames"])} if "frames" in batch else {}


def _jit_forward(m: Model):
    """repro's forward under jit (its eager dispatch of the layer loops is
    slow): (params, tokens, **kw) -> (hidden, cache)."""
    return jax.jit(lambda p, t, pos0=0, cache=None, **kw: m.jfam.forward(
        m.jcfg, p, t, pos0=pos0, cache=cache, compute_dtype=jnp.float32, **kw))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def repro_forward(model):
    """repro's hidden states and logits on the model's inputs, computed
    once per arch for every test that reads them."""
    batch = _inputs(model.cfg)
    jh, _ = _jit_forward(model)(model.jparams, jnp.asarray(batch["tokens"]), **_jkw(batch))
    return batch, np.asarray(jh), np.asarray(model.jfam.logits(model.jcfg, model.jparams, jh))


# ---------------------------------------------------------------------------
# Registries, configs, parameter trees
# ---------------------------------------------------------------------------


def test_registries_hold_every_repro_family_and_arch():
    assert set(FAMILIES) == set(JAX_FAMILIES)
    assert FAMILY_DEFAULT_ARCH == JAX_FAMILY_DEFAULT_ARCH
    assert not NOT_PORTED and ARCH_IDS == list(JAX_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_and_smoke_configs_equal_repro(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(jax_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_repro(arch):
    """The full config's flat paths, shapes and init equal repro's tree."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jdefs = flatten_tree(jax_get_family(jcfg.family).param_defs(jcfg))
    defs = get_family(cfg.family).param_defs(cfg)
    assert set(defs) == set(jdefs)
    for k, d in defs.items():
        assert (d.shape, d.init, d.scale, d.fan_in_axis) == (
            jdefs[k].shape, jdefs[k].init, jdefs[k].scale, jdefs[k].fan_in_axis), k


@pytest.mark.parametrize("arch,n_layers,want", [
    ("qwen3-moe-235b-a22b", 4, 11_195_683_840),
    ("qwen3-moe-235b-a22b", 1, 3_732_418_816),
    ("grok-1-314b", 1, 6_530_598_912),
    ("rwkv6-1.6b", 24, 1_583_941_632),
    ("zamba2-1.2b", 38, 1_104_937_856),
    ("seamless-m4t-medium", 12, 716_451_840),
])
def test_card_sizes(arch, n_layers, want):
    """The parameter counts behind the card's configurations, equal to
    repro's (f32, 4 bytes each): qwen3-moe at 4 of its 94 layers is
    44.78 GB, 2.488 B parameters a layer; grok-1 is 26.12 GB at one."""
    from repro.models.module import count_params as jax_count_params

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    jcfg = dataclasses.replace(jax_get_config(arch), n_layers=n_layers)
    got = count_params(get_family(cfg.family).param_defs(cfg))
    assert got == jax_count_params(jax_get_family(jcfg.family).param_defs(jcfg)) == want


def test_params_carry_across(model):
    assert set(model.params) == set(model.fam.param_defs(model.cfg))
    for path, value in flatten_tree(model.tree).items():
        assert tuple(model.params[path].shape) == value.shape


# ---------------------------------------------------------------------------
# Forward, loss and gradients
# ---------------------------------------------------------------------------


def test_forward_logits_match_repro(model, repro_forward):
    batch, jh, jl = repro_forward
    with torch.no_grad():
        h, cache = model.fam.forward(model.cfg, model.params, torch.from_numpy(batch["tokens"]),
                                     **_tkw(batch))
        logits = model.fam.logits(model.cfg, model.params, h)
    assert cache is None
    assert_close(h, jh)
    assert_close(logits, jl)


def test_loss_and_grads_match_repro(model):
    """The loss and every gradient against jax.value_and_grad of repro's
    generic loss (forward + chunked cross-entropy)."""
    batch = _inputs(model.cfg, S=32, seed=2)
    kw = dict(param_dtype="float32", compute_dtype="float32", loss_chunks=4, remat="none")
    jloss, jgrads = jax.jit(jax.value_and_grad(jtr.make_loss_fn(model.jcfg, JaxTrainConfig(**kw))))(
        model.jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss = tr.make_loss_fn(model.cfg, TrainConfig(**kw))(params, tr.batch_to(batch, "cpu"))
    grads = torch.autograd.grad(loss, list(params.values()))
    assert_close(float(loss.detach()), float(jloss), TOL_GRAD)
    jgrads = flatten_tree(jgrads)
    for k, g in zip(params, grads):
        assert_close(g, jgrads[k], TOL_GRAD)
    assert sum(bool(g.any()) for g in grads) > 0.9 * len(grads)


def test_remat_block_keeps_the_gradients(model):
    """remat="block" recomputes in the backward pass: the same gradients."""
    batch = tr.batch_to(_inputs(model.cfg, S=16 if model.cfg.family != "zamba2" else 32,
                                seed=3), "cpu")
    grads = {}
    for remat in ("none", "block"):
        loss_fn = tr.make_loss_fn(model.cfg, TrainConfig(loss_chunks=2, remat=remat))
        params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
        grads[remat] = torch.autograd.grad(loss_fn(params, batch), list(params.values()))
    for a, b in zip(grads["none"], grads["block"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------


def test_moe_dispatch_drops_rows_and_matches_repro(monkeypatch):
    """At the smoke config's capacity factor 1.25 the dispatch of one
    layer drops rows, and the layer still equals repro's: the same rows
    dropped, the same positions within each expert."""
    from repro.models import moe as jmoe

    m = _model("qwen3-moe-235b-a22b")
    layer0 = {k: v[0] for k, v in m.tree["layers"]["moe"].items()}
    # Tokens leaning toward expert 0, so that its capacity binds.
    r0 = layer0["router"][:, 0]
    x = np.random.default_rng(4).standard_normal((2, 48, m.cfg.d_model)) + 10 * r0 / np.linalg.norm(r0)
    x = x.astype(np.float32)
    want = np.asarray(jmoe.apply_moe_ffn({k: jnp.asarray(v) for k, v in layer0.items()},
                                         jnp.asarray(x), m.jcfg))
    dropped, route = [], moe._route

    def spy(*args):
        out = route(*args)
        dropped.append(int((~out[1]).sum()))  # rows past their expert's capacity
        return out

    monkeypatch.setattr(moe, "_route", spy)
    with torch.no_grad():
        got = moe.apply_moe_ffn({k: torch.tensor(v) for k, v in layer0.items()},
                                torch.from_numpy(x), m.cfg)
    assert_close(got, want)
    assert dropped and dropped[0] > 0


def test_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, idx = moe._top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_per_row_dispatch_is_one_dispatch_per_row():
    """per_row_dispatch gives each row what a dispatch of that row alone
    gives it, bit for bit on the CPU (the einsums see the same rows)."""
    m = _model("qwen3-moe-235b-a22b")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 24, m.cfg.d_model)).astype(np.float32))
    mp = {k: torch.tensor(v[1]) for k, v in m.tree["layers"]["moe"].items()}
    with torch.no_grad():
        rows = moe.apply_moe_ffn(mp, x, m.cfg, per_row_dispatch=True)
        for i in range(3):
            assert_close(rows[i], moe.apply_moe_ffn(mp, x[i:i + 1], m.cfg)[0].numpy(), 1e-6)
        assert not torch.allclose(rows, moe.apply_moe_ffn(mp, x, m.cfg))  # capacity couples


# ---------------------------------------------------------------------------
# Decode against the full forward (repro's tests, as parity tests)
# ---------------------------------------------------------------------------


def _decode_vs_full(pkg, m, toks, kw, S):
    """repro's ``test_decode_matches_full_forward`` procedure in either
    package: the full forward's last logits, and a prefill of S-1 tokens
    followed by one decode step.  Returns (full, decoded, cache after the
    prefill) as numpy."""
    if pkg == "repro":
        cfg, fam, p, fwd = m.jcfg, m.jfam, m.jparams, _jit_forward(m)
        t = jnp.asarray(toks)
        h, _ = fwd(p, t, **kw)
        full = fam.logits(cfg, p, h)[:, -1]
        cache = fam.init_cache(cfg, B, 64, jnp.float32)
        _, cache = fwd(p, t[:, :S - 1], pos0=0, cache=cache, **kw)
        pre = {k: np.asarray(v) for k, v in flatten_tree(cache).items()}
        h, _ = fwd(p, t[:, S - 1:], pos0=S - 1, cache=cache)
        return np.asarray(full), np.asarray(fam.logits(cfg, p, h)[:, 0]), pre
    cfg, fam, p = m.cfg, m.fam, m.params
    t = torch.from_numpy(toks)
    with torch.no_grad():
        h, _ = fam.forward(cfg, p, t, **kw)
        full = fam.logits(cfg, p, h)[:, -1]
        cache = fam.init_cache(cfg, B, 64, torch.float32, device="cpu")
        fam.forward(cfg, p, t[:, :S - 1], pos0=0, cache=cache, **kw)
        pre = {k: v.clone().numpy() for k, v in cache.items()}
        h, _ = fam.forward(cfg, p, t[:, S - 1:], pos0=S - 1, cache=cache)
        return full.numpy(), fam.logits(cfg, p, h)[:, 0].numpy(), pre


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b", "seamless-m4t-medium"])
def test_decode_matches_full_forward(arch):
    """repro's test in both packages (B 2, S 16, seed 1, frames 0.1): the
    port's decoded logits equal repro's within 1e-5, its prefill caches
    too, and they match its own full forward as repro's test requires."""
    m = _model(arch, seed=1)
    S = 16
    toks = np.random.default_rng(1).integers(0, m.cfg.vocab, (B, S)).astype(np.int32)
    frames = np.full((B, m.cfg.enc_seq, m.cfg.d_model), 0.1, np.float32)
    enc = m.cfg.family == "encdec"
    jfull, jdec, jpre = _decode_vs_full("repro", m, toks,
                                        {"frames": jnp.asarray(frames)} if enc else {}, S)
    full, dec, pre = _decode_vs_full("port", m, toks,
                                     {"frames": torch.from_numpy(frames)} if enc else {}, S)
    assert_close(full, jfull)
    assert_close(dec, jdec)
    assert set(pre) == set(jpre)
    for k in pre:
        assert_close(pre[k], jpre[k])
    np.testing.assert_allclose(dec, full, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ["grok-1-314b", "qwen3-moe-235b-a22b"])
def test_moe_decode_matches_when_no_drops(arch):
    """repro's test at capacity factor 64 (no row dropped) in both
    packages: the decoded logits agree with repro's within 1e-5 and with
    the full forward within repro's 1e-4."""
    m = _model(arch, seed=1, capacity_factor=64.0)
    S = 16
    toks = np.random.default_rng(1).integers(0, m.cfg.vocab, (B, S)).astype(np.int32)
    jfull, jdec, _ = _decode_vs_full("repro", m, toks, {}, S)
    full, dec, _ = _decode_vs_full("port", m, toks, {}, S)
    assert_close(full, jfull)
    assert_close(dec, jdec)
    np.testing.assert_allclose(dec, full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,leaf", [("rwkv6-1.6b", "wkv"), ("zamba2-1.2b", "mamba/ssd")])
def test_recurrent_state_absorbs_bucket_padding_in_both_packages(arch, leaf):
    """A fault of the reference, mirrored: the bucket prefill pads prompts
    on the right, and a recurrent state runs on through the pad tokens
    (a KV cache does not: decode overwrites the positions past the prompt).
    Both packages leave the same state after a padded prefill, within 1e-5,
    and it is not the state of the prompt alone."""
    from repro.runtime import serve as jsv
    from repro_torch.runtime import serve as sv

    m = _model(arch)
    rng = np.random.default_rng(10)
    tok = np.zeros((2, 8), np.int32)
    tok[:, :5] = rng.integers(1, m.cfg.vocab, (2, 5))
    lens = np.array([5, 5], np.int32)
    jprefill = jax.jit(jsv.make_bucket_prefill_step(m.jcfg, 16))
    jcache, _ = jprefill(m.jparams, jnp.asarray(tok), jnp.asarray(lens))
    padded, _ = sv.make_bucket_prefill_step(m.cfg, 16)(m.params, torch.from_numpy(tok),
                                                       torch.from_numpy(lens))
    alone, _ = sv.make_bucket_prefill_step(m.cfg, 16)(m.params, torch.from_numpy(tok[:, :5]),
                                                      torch.from_numpy(lens))
    jcache = flatten_tree(jcache)
    for k in padded:
        assert_close(padded[k], np.asarray(jcache[k]))
    assert not torch.allclose(padded[leaf], alone[leaf])


def test_encdec_needs_frames_or_a_cache():
    """Neither frames nor a cache: repro's forward asserts, the port's
    raises."""
    m = _model("seamless-m4t-medium")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(AssertionError, match="cross K/V"):
        m.jfam.forward(m.jcfg, m.jparams, jnp.asarray(toks), compute_dtype=jnp.float32)
    with pytest.raises(ValueError, match="cross K/V"):
        m.fam.forward(m.cfg, m.params, torch.from_numpy(toks))


# ---------------------------------------------------------------------------
# Mamba-2: the SSD scan
# ---------------------------------------------------------------------------


def _ssd_inputs(S, seed=6, H=4, P=8, N=16, Bb=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((Bb, S, H, P)).astype(dtype),
        dt=np.log1p(np.exp(rng.standard_normal((Bb, S, H)))).astype(dtype),
        A_log=(rng.standard_normal(H) * 0.5).astype(dtype),
        B=rng.standard_normal((Bb, S, N)).astype(dtype),
        C=rng.standard_normal((Bb, S, N)).astype(dtype),
        D=rng.standard_normal(H).astype(dtype),
        state=rng.standard_normal((Bb, H, P, N)).astype(dtype))


@pytest.mark.parametrize("S", [16, 256])
def test_ssd_chunked_matches_repro(S):
    """One chunk and two (the inter-chunk recurrence), from a nonzero
    carried state: the output and the new state."""
    a = _ssd_inputs(S)
    jy, js = jmamba2.ssd_chunked(*(jnp.asarray(a[k]) for k in a))
    y, s = mamba2.ssd_chunked(*(torch.from_numpy(a[k]) for k in a))
    assert_close(y, np.asarray(jy))
    assert_close(s, np.asarray(js))


def test_ssd_chunked_equals_per_step_recurrence_in_f64(monkeypatch):
    """Two chunks of 128 against 256 decode steps of one token each (the
    per-step recurrence): the same function to 1e-10 in f64."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    a = {k: torch.from_numpy(v) for k, v in _ssd_inputs(256, dtype=np.float64).items()}
    y, s = mamba2.ssd_chunked(**a)
    state, ys = a["state"], []
    for t in range(256):
        yt, state = mamba2.ssd_chunked(a["x"][:, t:t + 1], a["dt"][:, t:t + 1], a["A_log"],
                                       a["B"][:, t:t + 1], a["C"][:, t:t + 1], a["D"], state)
        ys.append(yt)
    assert_close(torch.cat(ys, 1), y.numpy(), TOL_F64)
    assert_close(state, s.numpy(), TOL_F64)


def test_ssd_gradients_through_the_segsum_mask_are_finite():
    """_segsum masks with -inf before the exp: no NaN reaches a gradient,
    and every gradient equals jax.grad of repro's scan."""
    a = _ssd_inputs(256, seed=7)
    g = np.random.default_rng(8).standard_normal(a["x"].shape).astype(np.float32)

    def jloss(*args):
        y, s = jmamba2.ssd_chunked(*args)
        return jnp.sum(y * g) + jnp.sum(s)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(*(jnp.asarray(a[k]) for k in a))
    leaves = [torch.from_numpy(a[k]).requires_grad_(True) for k in a]
    y, s = mamba2.ssd_chunked(*leaves)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum() + s.sum(), leaves)
    for gt, w in zip(got, want):
        assert torch.isfinite(gt).all()
        assert_close(gt, np.asarray(w), TOL_GRAD)
    seg = torch.zeros(2, 8, requires_grad=True)
    (gs,) = torch.autograd.grad(torch.exp(mamba2._segsum(seg)).sum(), [seg])
    assert torch.isfinite(gs).all()


def test_zamba2_cached_decode_equals_chunked_forward_in_f64(monkeypatch):
    """A 128-token prefill (one chunk) then 8 decode steps (per-step SSD)
    against one no-cache forward over the prompt and the generated tokens,
    right-padded to two chunks (causal: position t sees tokens <= t),
    read at each step's position: 1e-10 in f64."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    m = _model("zamba2-1.2b")
    rng = np.random.default_rng(9)
    params = {k: (v.double() + torch.from_numpy(rng.standard_normal(tuple(v.shape)) * 0.1))
              for k, v in m.params.items()}
    cfg = m.cfg
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 128)).astype(np.int32))
    cache = {k: v.double() for k, v in zamba2.init_cache(cfg, 1, 160, device="cpu").items()}
    got = []
    with torch.no_grad():
        h, _ = zamba2.forward(cfg, params, toks, cache=cache, compute_dtype=torch.float64)
        seq = [toks[0]]
        for t in range(8):
            lg = zamba2.logits(cfg, params, h[:, -1:])[0, 0]
            got.append(lg)
            nxt = torch.argmax(lg).reshape(1, 1).to(torch.int32)
            seq.append(nxt[0])
            h, _ = zamba2.forward(cfg, params, nxt, pos0=128 + t, cache=cache,
                                  compute_dtype=torch.float64)
        full = torch.cat(seq + [torch.zeros(256 - 136, dtype=torch.int32)])[None]
        hf, _ = zamba2.forward(cfg, params, full, compute_dtype=torch.float64)
        want = zamba2.logits(cfg, params, hf[:, 127:135])[0]
    for t in range(8):
        assert_close(got[t], want[t].numpy(), TOL_F64)


def test_zamba2_segments_equal_repro():
    for n_layers, every in [(38, 6), (5, 2), (4, 2), (7, 0), (6, 6)]:
        jcfg = dataclasses.replace(jax_get_config("zamba2-1.2b"), n_layers=n_layers,
                                   shared_attn_every=every)
        cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=n_layers,
                                  shared_attn_every=every)
        assert zamba2._segments(cfg) == jzamba2._segments(jcfg)
        assert zamba2.n_shared_applications(cfg) == jzamba2.n_shared_applications(jcfg)


# ---------------------------------------------------------------------------
# Planners: MoeFfnPlanner and the MoE cell
# ---------------------------------------------------------------------------


def _same(want, got):
    assert (got.op, got.grid, got.blocks, got.halo, got.macs, got.loads, got.stores,
            got.vmem_bytes, got.machine, got.critical_path_steps) == (
        want.op, want.grid, want.blocks, want.halo, want.macs, want.loads, want.stores,
        want.vmem_bytes, want.machine, want.critical_path_steps)


MOE_SHAPES = [
    dict(tokens=8, d_model=4096, d_ff=1536, n_experts=128, top_k=8, capacity_factor=1.25),
    dict(tokens=8192, d_model=4096, d_ff=1536, n_experts=128, top_k=8, capacity_factor=1.25),
    dict(tokens=4096, d_model=6144, d_ff=32768, n_experts=8, top_k=2, capacity_factor=1.25),
    dict(tokens=128, d_model=128, d_ff=256, n_experts=4, top_k=2, capacity_factor=1.25),
    dict(tokens=100, d_model=128, d_ff=256, n_experts=4, top_k=2, capacity_factor=16.0),
    dict(tokens=32, d_model=64, d_ff=96, n_experts=4, top_k=1),
]


@pytest.mark.parametrize("machines", MACHINES, ids=["manticore", "tpu_v5e"])
@pytest.mark.parametrize("shape", MOE_SHAPES)
def test_moe_ffn_planner_matches_repro(machines, shape):
    jmach, tmach = machines
    for kw in (dict(shape, in_bytes=4), dict(shape, in_bytes=2)):
        _same(jp.MoeFfnPlanner(jmach).plan(**kw), tp.MoeFfnPlanner(tmach).plan(**kw))
        want = jp.MoeFfnPlanner(jmach).candidates(**kw)
        got = tp.MoeFfnPlanner(tmach).candidates(**kw)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            _same(w, g)
    cap = (shape["tokens"], shape["n_experts"], shape["top_k"],
           shape.get("capacity_factor", 1.0))
    assert tp.MoeFfnPlanner.expert_capacity(*cap) == jp.MoeFfnPlanner.expert_capacity(*cap)


MOE_BLOCKS = [
    dict(batch=8, seq=1, d_model=4096, n_heads=64, d_ff=1536, n_kv_heads=4, vocab=151936,
         n_experts=128, top_k=8, capacity_factor=1.25),
    dict(batch=2, seq=64, d_model=128, n_heads=4, d_ff=256, n_kv_heads=2, n_experts=4,
         top_k=2, capacity_factor=1.25),
    dict(batch=4, seq=256, d_model=6144, n_heads=48, d_ff=32768, n_kv_heads=8, n_experts=8),
]


@pytest.mark.parametrize("machines", MACHINES, ids=["manticore", "tpu_v5e"])
@pytest.mark.parametrize("shape", MOE_BLOCKS)
def test_moe_block_cells_match_repro(machines, shape):
    jmach, tmach = machines
    want = jp.TransformerBlockPlanner(jmach).cell_planners(**shape)
    got = tp.TransformerBlockPlanner(tmach).cell_planners(**shape)
    assert set(got) == set(want) and "moe" in got and "mlp_up" not in got
    for cell in want:
        assert got[cell][1] == want[cell][1]
        _same(want[cell][0].plan(**want[cell][1]), got[cell][0].plan(**got[cell][1]))


def test_moe_planner_is_registered():
    assert isinstance(tp.planner_for("moe_ffn"), tp.MoeFfnPlanner)
    assert tp.planner_for("moe_ffn").machine is tm.H100


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["moe", "rwkv6", "zamba2"])
def test_launcher_trains_the_family_on_cpu(family, capsys):
    history = launch.main(["--family", family, "--device", "cpu", "--steps", "2",
                           "--batch", "2", "--seq", "16"])
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    out = capsys.readouterr().out
    assert f"{FAMILY_DEFAULT_ARCH[family]}-smoke" in out and "done: 2 steps" in out


def test_launcher_encdec_raises_as_repro_does(monkeypatch):
    """The token-only data source gives the encoder-decoder no frames: in
    repro the forward asserts inside the first step, in the port it
    raises."""
    import sys

    from repro.launch import train as jlaunch

    monkeypatch.setattr(sys, "argv", ["train", "--family", "encdec", "--steps", "1",
                                      "--batch", "2", "--seq", "16"])
    with pytest.raises(AssertionError, match="cross K/V"):
        jlaunch.main()
    with pytest.raises(ValueError, match="cross K/V"):
        launch.main(["--family", "encdec", "--device", "cpu", "--steps", "1", "--batch",
                     "2", "--seq", "16"])
