"""Flash attention's bf16 route on Hopper's tensor cores (the "wgmma"
kernel of ``csrc/flash_attention.cu``), on the CPU: which kernel each
dtype, head dim and block names, the code a launch passes to the C entry
point, the shared memory the wgmma launch takes against the H100
planner's bf16 budget at the head dim of every config with attention, and
the kernel's arithmetic emulated in plain PyTorch (:func:`emulate_wgmma`:
S from bf16 operands in f32, the base-2 online softmax from -1e30, P split
into bf16 hi + lo terms) against ``repro``'s Pallas flash kernel run
interpreted on the same bf16 numpy operands.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``-k "wgmma or flash"``).  Tolerance: bf16 outputs within one bf16 ulp of
``repro``'s at max(|ref|, 2^-8 max|ref|), the floor chip_smoke.py's
``ulp_check`` uses (two f32 computations of the same function rounded once
to bf16 may fall on either side of a rounding boundary; below the floor,
sums of terms of either sign differ more in relative terms).  ``repro``
has no query offset, so the emulation at ``q_off`` > 0 is held against the
port's plain version at the same tolerance.  Sizes are small: this file
runs on one xdist worker.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import machine as tm
from repro_torch.plan import planners as tp
from test_torch_kernels import _ArgSink

fa = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")

BF, F32 = torch.bfloat16, torch.float32
LOG2E = 1.4426950408889634
NEG = -1e30


def emulate_wgmma(q, k, v, *, block_q, block_kv, scale, causal, window, q_len, kv_len,
                  q_off=0, p_terms=2):
    """The wgmma kernel's function step for step in plain PyTorch (f32):
    per KV block the f32 scores of the bf16 operands, the masks (query row
    ``i`` at ``q_off + i``), base 2 with log2(e) in the scale, masked scores
    at -inf and the running max from -1e30, l summed from the f32 P, and O
    rescaled by alpha and added P_hi·V + P_lo·V, P_hi = bf16(P), P_lo =
    bf16(P - P_hi) (``p_terms`` 1: P_hi alone); O / l rounded once to bf16,
    0 where l == 0.  Blocks the kernel skips leave every row as it was, so
    every block is visited."""
    del block_q
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    group = bhq // bhkv
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(group, 0) for t in (k, v))
    sl2 = torch.tensor(scale, dtype=F32) * torch.tensor(LOG2E, dtype=F32)
    rows = torch.arange(sq)[:, None]
    q_ids = rows + q_off
    m = torch.full((bhq, sq, 1), NEG)
    l = torch.zeros((bhq, sq, 1))
    o = torch.zeros((bhq, sq, d))
    for k0 in range(0, skv, block_kv):
        cols = torch.arange(k0, k0 + block_kv)[None, :]
        mask = (rows < q_len) & (cols < kv_len)
        if causal:
            mask &= cols <= q_ids
        if window is not None:
            mask &= q_ids - cols < window
        s = torch.matmul(qf, kf[:, k0:k0 + block_kv].transpose(1, 2))
        s = torch.where(mask, s * sl2, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(BF).float()
        o = o * alpha + torch.matmul(hi, vf[:, k0:k0 + block_kv])
        if p_terms == 2:
            o = o + torch.matmul((p - hi).to(BF).float(), vf[:, k0:k0 + block_kv])
        m = m_new
    return torch.where(l == 0, torch.zeros_like(o), o / torch.where(l == 0, 1.0, l)).to(BF)


def assert_within_ulp(got, want):
    g, w = got.float().numpy().astype(np.float64), np.asarray(want, np.float64)
    floor = 2.0 ** -8 * float(np.abs(w).max())
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(w), floor))[1] - 8)
    assert bool((np.abs(g - w) <= ulp).all()), float((np.abs(g - w) / ulp).max())


# -- which kernel each dtype, head dim and block names ---------------------------------


@pytest.mark.parametrize("d,bq,bkv,dtype,want", [
    (32, 128, 128, BF, "wgmma"), (64, 128, 128, BF, "wgmma"),
    (128, 128, 64, BF, "wgmma"), (256, 64, 32, BF, "wgmma"),   # the planner's bf16 picks
    (64, 64, 32, BF, "wgmma"), (128, 64, 16, BF, "wgmma"),     # smaller multiples of 64 / 16
    (32, 128, 48, BF, "wgmma"), (256, 64, 16, BF, "wgmma"),
    (64, 128, 128, F32, "fma"), (128, 64, 64, F32, "fma"),     # f32 stays on the CUDA cores
    (32, 64, 40, BF, "fma"), (128, 96, 64, BF, "fma"),         # not a multiple of 16 / 64
    (256, 32, 16, BF, "fma"), (256, 128, 32, BF, "fma"),       # below 64 rows; past the maxima
    (128, 128, 128, BF, "fma"), (96, 64, 16, BF, "fma"),       # past bkv's maximum; no such D
])
def test_flash_template_per_dtype_head_dim_and_blocks(d, bq, bkv, dtype, want):
    assert fa.flash_template(bq, bkv, d, dtype) == want
    assert fa.FLASH_TEMPLATES.index(want) == {"fma": 0, "wgmma": 1}[want]


def test_flash_template_defaults_to_f32():
    assert fa.flash_template(128, 128, 64) == "fma"


@pytest.mark.parametrize("dtype,bq,bkv,code", [(BF, 128, 128, 1), (BF, 64, 32, 1),
                                               (BF, 64, 40, 0), (F32, 128, 128, 0)])
def test_flash_launch_passes_its_template(dtype, bq, bkv, code):
    """The wrapper alone picks the kernel: the C entry point gets
    flash_template's code after the query offset, and its route's symbol."""
    d = 64
    q = torch.zeros(2, 2 * bq, d, dtype=dtype)
    kv = torch.zeros(1, 2 * bkv, d, dtype=dtype)
    sink = _ArgSink(fa.flash_attention_kernel)
    fa._launch(sink, q, kv, kv, block_q=bq, block_kv=bkv, scale=0.125, causal=True,
               window=None, q_len=2 * bq, kv_len=2 * bkv, q_off=3)
    assert len(sink.args) == len(sink.argtypes) - 1
    assert sink.args[4:17] == (2, 1, 2 * bq, 2 * bkv, d, bq, bkv, 2 * bq, 2 * bkv, 1, -1, 3,
                               code)
    assert sink.dtype == dtype


# -- shared memory: the planner's bf16 bytes ---------------------------------------------


ATTN_ARCHS = [a for a in ARCH_IDS if get_config(a).n_heads > 0]


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_wgmma_launch_takes_the_planners_bytes(arch):
    """At the head dim of every config with attention, AttentionPlanner(H100)
    at in_bytes=2 picks blocks the wgmma kernel takes, and the bytes its
    launch allocates (smem_bytes at two bytes an element, the C launch's
    formula) equal the schedule's vmem_bytes; the kernel's own layout (Q,
    two stages of K and V, three barriers, a 1024-byte alignment) fits in
    them, and so does its padded output stage in Q's, K's and V's room."""
    cfg = get_config(arch)
    d = cfg.resolved_head_dim
    s = tp.AttentionPlanner(tm.H100).plan(seq_q=2048, seq_kv=2048, head_dim=d,
                                          n_q_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                                          batch=1, in_bytes=2, causal=True)
    bq, bkv = s.block("block_q"), s.block("block_kv")
    assert (bq, bkv) == fa.MAX_BLOCKS_BF16[d]
    assert fa.flash_template(bq, bkv, d, BF) == "wgmma"
    assert fa.smem_bytes(bq, bkv, d, 2) == s.vmem_bytes <= tm.H100.local_mem_bytes
    tiles = 2 * (bq * d + 4 * bkv * d)
    assert 1024 + tiles + 3 * 8 <= s.vmem_bytes
    assert 2 * bq * (d + 8) <= tiles
    assert s.vmem_bytes == {32: 66_560, 64: 132_096, 128: 197_632, 256: 197_120}[d]


# -- the kernel's arithmetic against repro's Pallas kernel --------------------------------


def _operands(rng, bhq, bhkv, sq, skv, d, q_len, kv_len):
    def bf16(n, s, length):
        a = np.zeros((n, s, d), np.float32)
        a[:, :length] = rng.standard_normal((n, length, d))
        t = torch.from_numpy(a).to(BF)
        return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)

    return bf16(bhq, sq, q_len), bf16(bhkv, skv, kv_len), bf16(bhkv, skv, kv_len)


# (D, block_q, block_kv, BHq, BHkv, Sq, Skv, q_len, kv_len, window): each head dim at its
# planned blocks, causal; a window; GQA 4/2 and 8/1; ragged lengths; a smaller wgmma block.
EMULATED = [(32, 128, 128, 2, 1, 256, 256, 256, 256, None),
            (64, 128, 128, 2, 2, 256, 256, 256, 256, 96),
            (128, 128, 64, 4, 2, 256, 256, 200, 200, None),
            (256, 64, 32, 8, 1, 128, 128, 128, 128, 40),
            (64, 64, 32, 4, 2, 192, 192, 190, 190, 64),
            (128, 64, 16, 2, 1, 128, 128, 100, 128, None)]


@pytest.mark.parametrize("case", EMULATED, ids=[f"d{c[0]}-{c[1]}x{c[2]}" for c in EMULATED])
def test_emulated_wgmma_arithmetic_matches_pallas(case):
    d, bq, bkv, bhq, bhkv, sq, skv, q_len, kv_len, window = case
    assert fa.flash_template(bq, bkv, d, BF) == "wgmma"
    rng = np.random.default_rng(36)
    (q, jq), (k, jk), (v, jv) = _operands(rng, bhq, bhkv, sq, skv, d, q_len, kv_len)
    kw = dict(block_q=bq, block_kv=bkv, scale=d ** -0.5, causal=True, window=window,
              q_len=q_len, kv_len=kv_len)
    got = emulate_wgmma(q, k, v, **kw)
    want = np.asarray(jnp.asarray(flash_attention_pallas(jq, jk, jv, interpret=True, **kw),
                                  jnp.float32))
    assert got.dtype == BF
    assert_within_ulp(got[:, :q_len], want[:, :q_len])
    assert bool((got[:, q_len:] == 0).all())


@pytest.mark.parametrize("d,bq,bkv,q_off,window", [(64, 128, 128, 200, None),
                                                   (128, 128, 64, 1000, 1024),
                                                   (256, 64, 32, 1536, None)])
def test_emulated_wgmma_at_an_offset_matches_plain(d, bq, bkv, q_off, window):
    """A 128-row query slice at ``q_off`` of a causal sequence (GQA 4/2):
    the emulation against the port's plain version, which holds the offset
    (``repro`` has none)."""
    rng = np.random.default_rng(37)
    skv = q_off + 128
    (q, _), (k, _), (v, _) = _operands(rng, 4, 2, 128, skv + (-skv) % bkv, d, 128, skv)
    kw = dict(block_q=bq, block_kv=bkv, scale=d ** -0.5, causal=True, window=window,
              q_len=128, kv_len=skv, q_off=q_off)
    got = emulate_wgmma(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert_within_ulp(got, want.float().numpy())


def test_emulated_rows_with_no_visible_key_are_zero():
    """A window of 16 past the key sequence's end: query rows 160.. see no
    key, and the emulation (as the kernel) writes them 0."""
    rng = np.random.default_rng(38)
    (q, _), (k, _), (v, _) = _operands(rng, 2, 1, 256, 128, 64, 256, 128)
    kw = dict(block_q=128, block_kv=128, scale=0.125, causal=True, window=16, q_len=256,
              kv_len=128)
    got = emulate_wgmma(q, k, v, **kw)
    assert bool((got[:, 143:] == 0).all()) and bool((got[:, :128] != 0).any())
    assert_within_ulp(got, fa.flash_attention_plain(q, k, v, **kw).float().numpy())
