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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models.module import ParamDef, prefixed, unstack
from repro_torch.models.transformer import _check_remat, _layer

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


def _time_mix(p, x, H, hd, last_x, wkv_state):
    B, S, d = x.shape
    cd = x.dtype
    xx = _shift(x, last_x) - x
    mix = lambda m: x + xx * p[m].to(cd)  # noqa: E731
    r = (mix("maa_r") @ p["wr"].to(cd)).reshape(B, S, H, hd)
    k = (mix("maa_k") @ p["wk"].to(cd)).reshape(B, S, H, hd)
    v = (mix("maa_v") @ p["wv"].to(cd)).reshape(B, S, H, hd)
    g = F.silu(mix("maa_g") @ p["wg"].to(cd))
    # The data-dependent decay (the Finch feature): w in (0, 1).
    xw = mix("maa_w").float()
    dec = p["w0"].float() + torch.tanh(xw @ p["w_lora_a"].float()) @ p["w_lora_b"].float()
    w = torch.exp(-torch.exp(dec)).reshape(B, S, H, hd)

    y, wkv_state = _wkv(r.float(), k.float(), v.float(), w, p["u"].float(), wkv_state.float())
    # Head-wise group norm (per-channel RMS over the head dim).
    y = y * torch.rsqrt(torch.mean(y * y, -1, keepdim=True) + 1e-5)
    y = y.reshape(B, S, d) * (1.0 + p["gn"].float())
    out = (y.to(cd) * g) @ p["wo"].to(cd)
    return out, x[:, -1, :], wkv_state


def _channel_mix(p, x, last_x):
    cd = x.dtype
    xx = _shift(x, last_x) - x
    xk = x + xx * p["maa_k"].to(cd)
    xr = x + xx * p["maa_r"].to(cd)
    k = torch.square(F.relu(xk @ p["wk"].to(cd)))
    return torch.sigmoid(xr @ p["wr"].to(cd)) * (k @ p["wv"].to(cd)), x[:, -1, :]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """The recurrent state, zeros, on ``device`` (default: the card):
    ``tm_x``/``cm_x`` [L, B, d] in ``dtype`` and ``wkv`` [L, B, H, hd, hd]
    in f32.  ``max_seq`` does not enter: the state is O(1) in length."""
    del max_seq
    H, hd = _heads(cfg)
    L, d = cfg.n_layers, cfg.d_model
    device = torch.device("cuda" if device is None else device)
    return {
        "tm_x": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "cm_x": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32, device=device),
    }


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, pos0=0,
            cache: dict | None = None, compute_dtype=torch.float32, remat: str = "none"):
    """Returns (hidden [B, S, d], cache).  Without a cache the state starts
    at zero; with one, each layer starts from and writes back its slice.
    ``pos0`` does not enter (the model has no positions)."""
    del pos0
    _check_remat(remat)
    B, _ = tokens.shape
    H, hd = _heads(cfg)
    x = ll.embed_tokens(params, tokens, cfg, compute_dtype)
    state = cache if cache is not None else init_cache(
        cfg, B, 0, compute_dtype, device=x.device)

    def body(x, lp, tm_x, cm_x, wkv_s):
        h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, tm_x2, wkv_s2 = _time_mix(lp["tm"], h, H, hd, tm_x, wkv_s)
        x = x + h
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        h, cm_x2 = _channel_mix(lp["cm"], h, cm_x)
        return x + h, tm_x2, cm_x2, wkv_s2

    for i, lp in enumerate(unstack(params, "layers", cfg.n_layers)):
        x, *new = _layer(body, remat)(x, lp, state["tm_x"][i], state["cm_x"][i],
                                      state["wkv"][i])
        if cache is not None:
            for name, t in zip(("tm_x", "cm_x", "wkv"), new):
                cache[name][i] = t.to(cache[name].dtype)
    return x, cache


def logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return ll.logits_from_hidden(params, hidden, cfg)


def layer_meta(cfg: ModelConfig) -> dict:
    return {}
