"""Mamba-2 (SSD) block: the JAX package's ``models/mamba2.py`` on one
device.

The selective scan runs the SSD chunked algorithm: quadratic matmuls inside
each chunk of ``CHUNK`` tokens and a recurrence over the per-chunk states
(the paper's Alg 2 insight — keep a block resident, stream the sequence —
applied to SSMs).  One B/C group; a causal depthwise conv of width
``cfg.conv_width`` over the x/B/C streams, whose last ``W - 1`` inputs
carry across calls.  Plain PyTorch, as the JAX package computes it with
XLA and no Pallas kernel.  A decode step (S = 1) is one chunk of one
token: the per-step recurrence, other algebra than a long sequence's
chunks for the same function.

On a mesh (``parallel=``, a ParallelCtx whose model axis is above 1) a
block runs over the model axis on this rank's H / tp heads.  The JAX
package's specs split ``w_in``'s fused ``[z, x, B, C, dt]`` columns (and
the conv's ``[x, B, C]`` channels) contiguously over ``model``, so a shard
boundary may fall inside ``x`` (zamba2-1.2b: 8384 columns).  A rank needs
its heads' ``z``/``x``/``dt`` columns and the whole ``B``/``C`` (one
group): it gathers those leaves whole and takes its pieces
(``parallel.tp_take``), leaving the stored tree the JAX package's.  The
SSD scan runs on its heads (``A_log``, ``D``, ``dt_bias`` sliced by
head), the gated RMS norm over all of d_inner adds the ranks' sums of
squares (one psum), and ``w_out`` is row-parallel (one psum).  A rank's
state: its heads of ``ssd``, and its ``x`` channels plus the whole
``B``/``C`` of ``conv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models.attention import at_least_f32
from repro_torch.models.module import ParamDef
from repro_torch.runtime import parallel as par

CHUNK = 128
# A block's leaves a model rank gathers whole to take its pieces from
# (:func:`local_block_params`).
WHOLE_OVER_MODEL = ("w_in", "conv_w", "conv_b")


def dims(cfg: ModelConfig):
    """(d_inner, heads, head dim, state size)."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state


def block_defs(cfg: ModelConfig, L: int) -> dict:
    d = cfg.d_model
    d_in, H, _, N = dims(cfg)
    ds = "model" if d_in % 16 == 0 else None
    conv_ch = d_in + 2 * N
    return {
        "ln": ParamDef((L, d), init="zeros"),
        # in_proj -> [z, x, B, C, dt]
        "w_in": ParamDef((L, d, 2 * d_in + 2 * N + H), (None, None, ds), fan_in_axis=1),
        "conv_w": ParamDef((L, cfg.conv_width, conv_ch), (None, None, ds), scale=0.5,
                           fan_in_axis=1),
        "conv_b": ParamDef((L, conv_ch), (None, ds), init="zeros"),
        "A_log": ParamDef((L, H), init="zeros"),
        "D": ParamDef((L, H), init="ones"),
        "dt_bias": ParamDef((L, H), init="zeros"),
        "gn": ParamDef((L, d_in), (None, ds), init="zeros"),
        "w_out": ParamDef((L, d_in, d), (None, ds, None), fan_in_axis=1),
    }


def _depthwise_conv(x, w, b, state):
    """Causal depthwise conv1d.  x: [B, S, C]; w: [W, C]; state: [B, W-1, C]
    (the previous call's trailing inputs).  Returns (y, new_state)."""
    W = w.shape[0]
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # [B, S+W-1, C]
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    return ll.silu(y + b), new_state


def _segsum(a):
    """a: [..., Q] -> L[i, j] = sum_{j<t<=i} a_t on and below the diagonal,
    -inf above it (so its exp is 0 there)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.tensor(-torch.inf, dtype=diff.dtype, device=a.device))


def ssd_chunked(x, dt, A_log, B, C, D, state):
    """The SSD forward.

    x: [B, S, H, P]; dt: [B, S, H] (after softplus); A_log: [H];
    B, C: [B, S, N]; D: [H]; state: [B, H, P, N], carried across calls.
    Returns (y [B, S, H, P] in f32, or f64 for f64 inputs, new_state).  S must be a multiple of
    ``min(CHUNK, S)``.
    """
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(CHUNK, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: sequence {S} is not a multiple of the chunk {Q}")
    nc = S // Q

    a = -torch.exp(at_least_f32(A_log))[None, None, :] * dt  # [B, S, H] (< 0)
    xr = at_least_f32((x * dt[..., None]).reshape(Bb, nc, Q, H, P))
    ar = a.reshape(Bb, nc, Q, H)
    Br = at_least_f32(B.reshape(Bb, nc, Q, N))
    Cr = at_least_f32(C.reshape(Bb, nc, Q, N))

    # Inside each chunk (quadratic): Y_diag = (C B^T * L) @ x.
    Lmat = torch.exp(_segsum(ar.permute(0, 1, 3, 2)))  # [B, nc, H, Q, Q]
    G = torch.einsum("bcqn,bckn->bcqk", Cr, Br)  # [B, nc, Q, Q]
    Y = torch.einsum("bchqk,bckhp->bcqhp", G[:, :, None] * Lmat, xr)

    # Each chunk's input state and decays.
    a_cum = torch.cumsum(ar, 2)  # [B, nc, Q, H]
    a_tail = a_cum[:, :, -1:, :] - a_cum  # the decay from t to the chunk's end
    states = torch.einsum("bckn,bckh,bckhp->bchpn", Br, torch.exp(a_tail), xr)

    # The recurrence over the chunk states.
    a_tot = a_cum[:, :, -1, :]  # [B, nc, H]
    s = at_least_f32(state)
    s_in = []
    for c in range(nc):
        s_in.append(s)  # the state entering chunk c
        s = s * torch.exp(a_tot[:, c])[..., None, None] + states[:, c]
    s_in = torch.stack(s_in, 1)  # [B, nc, H, P, N]

    # The entering state's contribution at each position.
    Y = Y + torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cr, torch.exp(a_cum), s_in)
    Y = Y.reshape(Bb, S, H, P) + D[None, None, :, None] * at_least_f32(x)
    return Y, s


def local_dims(cfg: ModelConfig, parallel=None):
    """(d_inner, heads) of this model rank: its share of both."""
    d_in, H, _, _ = dims(cfg)
    tp = par.tp_size(parallel)
    if H % tp:
        raise ValueError(f"{H} Mamba-2 heads do not split over a model axis of {tp}")
    return d_in // tp, H // tp


def local_block_params(p: dict, cfg: ModelConfig, parallel) -> dict:
    """One block's parameters for this model rank's heads: ``w_in``'s
    columns ``[z, x, B, C, dt]`` of its heads (B and C whole), the conv's
    channels ``[x, B, C]`` of its heads, its heads of ``A_log``/``D``/
    ``dt_bias``, its channels of ``gn`` and its rows of ``w_out``."""
    d_in, H, _, N = dims(cfg)
    n, h = local_dims(cfg, parallel)
    r = par.tp_rank(parallel)
    width = 2 * d_in + 2 * N + H
    cols = [(r * n, n), (d_in + r * n, n), (2 * d_in, 2 * N), (2 * d_in + 2 * N + r * h, h)]
    chans = [(r * n, n), (d_in, 2 * N)]
    out = {
        "w_in": par.tp_take(par.tp_whole(p["w_in"], -1, width, parallel), -1, cols, parallel),
        "w_out": par.tp_local(p["w_out"], 0, d_in, parallel),
        "gn": par.tp_local(p["gn"], 0, d_in, parallel),
    }
    for name in ("conv_w", "conv_b"):
        whole = par.tp_whole(p[name], -1, d_in + 2 * N, parallel)
        out[name] = par.tp_take(whole, -1, chans, parallel)
    for name in ("A_log", "D", "dt_bias"):
        out[name] = par.tp_local(p[name], 0, H, parallel)
    return out


def apply_block(p, x, cfg: ModelConfig, state, parallel=None):
    """One Mamba-2 block.  x: [B, S, d]; state: {"conv", "ssd"}.  Returns
    (out [B, S, d], new state).  With ``parallel`` (a model axis above 1)
    the block runs on this rank's heads and ``state`` is this rank's."""
    Bb, S, _ = x.shape
    d_in, H, hd, N = dims(cfg)
    split = par.tp_size(parallel) > 1
    if split:
        p, x = local_block_params(p, cfg, parallel), par.tp_enter(x, parallel)
        d_loc, H = local_dims(cfg, parallel)
    else:
        d_loc = d_in
    cd = x.dtype

    proj = x @ p["w_in"].to(cd)  # [B, S, 2*d_loc + 2N + H]
    z, xc, Bc, Cc, dt = torch.split(proj, [d_loc, d_loc, N, N, H], -1)

    conv_in = torch.cat([xc, Bc, Cc], -1)
    conv_out, conv_state = _depthwise_conv(conv_in, p["conv_w"].to(cd), p["conv_b"].to(cd),
                                           state["conv"])
    xc, Bc, Cc = torch.split(conv_out, [d_loc, N, N], -1)

    dt = F.softplus(at_least_f32(dt) + at_least_f32(p["dt_bias"]))
    y, ssd_state = ssd_chunked(xc.reshape(Bb, S, H, hd), dt, p["A_log"], Bc, Cc, p["D"],
                               state["ssd"])
    y = y.reshape(Bb, S, d_loc).to(cd)
    y = y * ll.silu(z)
    # Gated RMS norm (f32, or f64 in an f64 run), over all of d_inner.
    yf = at_least_f32(y)
    if split:
        ms = par.tp_reduce((yf * yf).sum(-1, keepdim=True), parallel) / d_in
    else:
        ms = torch.mean(yf * yf, -1, keepdim=True)
    yf = yf * torch.rsqrt(ms + cfg.norm_eps)
    y = (yf * (1.0 + at_least_f32(p["gn"]))).to(cd)
    out = y @ p["w_out"].to(cd)
    return (par.tp_exit(out, parallel) if split else out), {"conv": conv_state,
                                                            "ssd": ssd_state}


def init_block_state(cfg: ModelConfig, L: int, batch: int, dtype=torch.bfloat16, *,
                     device=None, parallel=None) -> dict:
    """Zero states of L blocks on ``device`` (default: the card): the conv's
    trailing inputs [L, B, W-1, C] in ``dtype``, the SSD state
    [L, B, H, P, N] in f32 (f64 for an f64 ``dtype``).  With ``parallel`` (a model axis above 1),
    this rank's: its heads, and C its x channels plus B and C."""
    d_in, H, hd, N = dims(cfg)
    if par.tp_size(parallel) > 1:
        d_in, H = local_dims(cfg, parallel)
    device = torch.device("cuda" if device is None else device)
    return {
        "conv": torch.zeros((L, batch, cfg.conv_width - 1, d_in + 2 * N), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((L, batch, H, hd, N), dtype=torch.promote_types(dtype, torch.float32),
                           device=device),
    }
