"""RWKV-6 "Finch" (attention-free, data-dependent decay): the JAX
package's ``models/rwkv6.py`` on one device.

Time mix (token shift, r/k/v/g projections, the per-channel
*data-dependent* decay ``w_t = exp(-exp(w0 + lora(x)))``, the bonus u, a
per-head WKV state in R^{Dk x Dv}, a head-wise RMS group norm, the gate)
and channel mix (token shift, squared-ReLU FFN with a receptance gate), with
the JAX package's simplification: static per-channel token-shift lerps.

The WKV recurrence is a loop over time in plain PyTorch (the JAX package's
``lax.scan``; no Pallas kernel there either).  The recurrent state —
``tm_x``, ``cm_x`` (each layer's last input) and the f32 ``wkv`` state,
each with the slot on axis 1 — is O(1) in sequence length; with a cache,
``forward`` writes each layer's new state into it in place and returns
the same dict.

On a mesh (``parallel=``, a ParallelCtx whose model axis is above 1) the
blocks run tensor-parallel over the model axis, rank-local code for what
the JAX package's specs ask of GSPMD:

* the time mix takes this rank's H / tp heads: its columns of
  ``wr``/``wk``/``wv``/``wg`` and ``w_lora_b`` (and of ``w0``), its heads
  of ``u`` and its channels of ``gn``, so the WKV recurrence and the
  head-wise group norm are local; ``wo`` is row-parallel, one psum;
* the channel mix splits ``wk`` by columns and ``wv`` by rows over d_ff,
  one psum; the receptance ``sigmoid(xr @ wr)`` gates the whole summed
  output, so ``wr`` (whose output columns the specs split) is gathered
  whole and every rank computes it alike;
* the token-shift inputs and the residual stream stay replicated, and
  enter a split region through ``parallel.tp_enter`` (the mixing vectors
  and ``w_lora_a`` too: each rank's gradient of them is a part).

A rank's recurrent state is its heads of ``wkv``; ``tm_x``/``cm_x`` stay
whole (:func:`init_cache` with ``parallel``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models.module import ParamDef, prefixed, unstack
from repro_torch.models.transformer import _check_remat, _layer
from repro_torch.runtime import parallel as par

# The leaves a model rank uses whole where the specs split them (the
# receptance ``wr`` of the channel mix); ``runtime.serve.serving_param_specs``
# keeps them whole on a serving rank.
WHOLE_OVER_MODEL = ("layers/cm/wr",)

_LORA = 64


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.ssm_head_dim
    return cfg.d_model // hd, hd


def param_defs(cfg: ModelConfig) -> dict:
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, hd = _heads(cfg)
    hs = ll.head_axis_spec(H, hd)
    ds = ll.MODEL_AXIS if d % 16 == 0 else None
    ffs = ll.ff_spec(ff)
    vec = lambda: ParamDef((L, d), init="zeros")  # noqa: E731
    tm = {
        **{f"maa_{c}": vec() for c in "rkvwg"},
        "w0": vec(),
        "w_lora_a": ParamDef((L, d, _LORA), fan_in_axis=1),
        "w_lora_b": ParamDef((L, _LORA, d), (None, None, ds), scale=0.01, fan_in_axis=1),
        "u": ParamDef((L, H, hd), (None,) + hs, init="zeros"),
        **{w: ParamDef((L, d, d), (None, None, ds), fan_in_axis=1)
           for w in ("wr", "wk", "wv", "wg")},
        "wo": ParamDef((L, d, d), (None, ds, None), fan_in_axis=1),
        "gn": vec(),
    }
    cm = {
        "maa_k": vec(),
        "maa_r": vec(),
        "wk": ParamDef((L, d, ff), (None, None, ffs), fan_in_axis=1),
        "wv": ParamDef((L, ff, d), (None, ffs, None), fan_in_axis=1),
        "wr": ParamDef((L, d, d), (None, None, ds), fan_in_axis=1),
    }
    return {
        **ll.embed_defs(cfg),
        "layers/ln1": vec(),
        "layers/ln2": vec(),
        **prefixed("layers/tm", tm),
        **prefixed("layers/cm", cm),
    }


def _shift(x, last):
    """Token shift: x_{t-1}, with ``last`` filling t = 0.  x: [B, S, d]."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _wkv(r, k, v, w, u, state):
    """The WKV6 recurrence, one step a token.  r/k/w: [B, S, H, Dk];
    v: [B, S, H, Dv]; u: [H, Dk]; state: [B, H, Dk, Dv].  Returns
    (y [B, S, H, Dv], state)."""
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        a = kt[..., :, None] * vt[..., None, :]  # [B, H, Dk, Dv]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, state + u[None, :, :, None] * a))
        state = wt[..., :, None] * state + a
    return torch.stack(ys, 1), state


def _local_heads(H: int, parallel) -> int:
    tp = par.tp_size(parallel)
    if H % tp:
        raise ValueError(f"{H} RWKV-6 heads do not split over a model axis of {tp}")
    return H // tp


def local_time_mix_params(p: dict, H: int, hd: int, parallel) -> dict:
    """The time mix's parameters for this model rank's heads: its columns
    of the r/k/v/g projections, ``w_lora_b`` and ``w0``, its heads of
    ``u``, its channels of ``gn`` and its rows of ``wo``; the mixing
    vectors and ``w_lora_a``, which every rank uses whole, through
    ``tp_enter``."""
    d = H * hd
    out = {}
    for name, w in p.items():
        if name in ("wr", "wk", "wv", "wg", "w_lora_b"):
            out[name] = par.tp_local(w, 1, d, parallel)
        elif name in ("w0", "gn", "wo"):
            out[name] = par.tp_local(w, 0, d, parallel)
        elif name == "u":
            out[name] = par.tp_local(w, 0, H, parallel)
        else:  # maa_*, w_lora_a
            out[name] = par.tp_enter(w, parallel)
    return out


def _time_mix(p, x, H, hd, last_x, wkv_state, parallel=None):
    split = par.tp_size(parallel) > 1
    if split:
        p, x = local_time_mix_params(p, H, hd, parallel), par.tp_enter(x, parallel)
        H = _local_heads(H, parallel)
    B, S, _ = x.shape
    cd = x.dtype
    xx = _shift(x, last_x) - x
    mix = lambda m: x + xx * p[m].to(cd)  # noqa: E731
    r = (mix("maa_r") @ p["wr"].to(cd)).reshape(B, S, H, hd)
    k = (mix("maa_k") @ p["wk"].to(cd)).reshape(B, S, H, hd)
    v = (mix("maa_v") @ p["wv"].to(cd)).reshape(B, S, H, hd)
    g = ll.silu(mix("maa_g") @ p["wg"].to(cd))
    # The data-dependent decay (the Finch feature): w in (0, 1).
    f32 = ll.at_least_f32
    xw = f32(mix("maa_w"))
    dec = f32(p["w0"]) + torch.tanh(xw @ f32(p["w_lora_a"])) @ f32(p["w_lora_b"])
    w = torch.exp(-torch.exp(dec)).reshape(B, S, H, hd)

    y, wkv_state = _wkv(f32(r), f32(k), f32(v), w, f32(p["u"]), f32(wkv_state))
    # Head-wise group norm (per-channel RMS over the head dim).
    y = y * torch.rsqrt(torch.mean(y * y, -1, keepdim=True) + 1e-5)
    y = y.reshape(B, S, H * hd) * (1.0 + f32(p["gn"]))
    out = (y.to(cd) * g) @ p["wo"].to(cd)
    return (par.tp_exit(out, parallel) if split else out), x[:, -1, :], wkv_state


def _channel_mix(p, x, last_x, d_ff: int, parallel=None):
    cd = x.dtype
    xx = _shift(x, last_x) - x
    xk = x + xx * p["maa_k"].to(cd)
    xr = x + xx * p["maa_r"].to(cd)
    wk, wv, wr = p["wk"], p["wv"], p["wr"]
    split = ll.mlp_split(d_ff, parallel)
    if split:  # column-parallel wk, row-parallel wv over d_ff
        wk, wv = par.tp_local(wk, 1, d_ff, parallel), par.tp_local(wv, 0, d_ff, parallel)
        xk = par.tp_enter(xk, parallel)
    if par.tp_size(parallel) > 1:
        # The receptance gates the whole (summed) output: every rank
        # computes it alike, from the whole wr.
        wr = par.tp_whole(wr, 1, x.shape[-1], parallel)
    k = torch.square(F.relu(xk @ wk.to(cd)))
    kv = k @ wv.to(cd)
    if split:
        kv = par.tp_exit(kv, parallel)
    return ll.sigmoid(xr @ wr.to(cd)) * kv, x[:, -1, :]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None, parallel=None) -> dict:
    """The recurrent state, zeros, on ``device`` (default: the card):
    ``tm_x``/``cm_x`` [L, B, d] in ``dtype`` and ``wkv`` [L, B, H, hd, hd]
    in f32 (f64 for an f64 ``dtype``) (with ``parallel``, this model rank's H / tp heads).
    ``max_seq`` does not enter: the state is O(1) in length."""
    del max_seq
    H, hd = _heads(cfg)
    if par.tp_size(parallel) > 1:
        H = _local_heads(H, parallel)
    L, d = cfg.n_layers, cfg.d_model
    device = torch.device("cuda" if device is None else device)
    return {
        "tm_x": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "cm_x": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.promote_types(dtype, torch.float32),
                           device=device),
    }


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, pos0=0,
            cache: dict | None = None, compute_dtype=torch.float32, remat: str = "none",
            parallel=None):
    """Returns (hidden [B, S, d], cache).  Without a cache the state starts
    at zero; with one, each layer starts from and writes back its slice.
    ``pos0`` does not enter (the model has no positions).  With
    ``parallel`` the tokens are this rank's data shard and the blocks run
    over the model axis (a cache is this rank's piece: its heads of
    ``wkv``)."""
    del pos0
    _check_remat(remat)
    B, _ = tokens.shape
    H, hd = _heads(cfg)
    x = ll.embed_tokens(params, tokens, cfg, compute_dtype, parallel)
    state = cache if cache is not None else init_cache(
        cfg, B, 0, compute_dtype, device=x.device, parallel=parallel)

    def body(x, lp, tm_x, cm_x, wkv_s):
        h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, tm_x2, wkv_s2 = _time_mix(lp["tm"], h, H, hd, tm_x, wkv_s, parallel)
        x = x + h
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        h, cm_x2 = _channel_mix(lp["cm"], h, cm_x, cfg.d_ff, parallel)
        return x + h, tm_x2, cm_x2, wkv_s2

    for i, lp in enumerate(unstack(params, "layers", cfg.n_layers)):
        x, *new = _layer(body, remat)(x, lp, state["tm_x"][i], state["cm_x"][i],
                                      state["wkv"][i])
        if cache is not None:
            for name, t in zip(("tm_x", "cm_x", "wkv"), new):
                cache[name][i] = t.to(cache[name].dtype)
    return x, cache


def logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
           parallel=None) -> torch.Tensor:
    """Hidden -> logits [B, S, V] (this rank's vocab columns under a vocab
    split over ``parallel``'s model axis)."""
    return ll.logits_from_hidden(params, hidden, cfg, parallel)


def layer_meta(cfg: ModelConfig) -> dict:
    return {}
