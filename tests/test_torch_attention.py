"""The port's attention against the JAX package's, on the CPU: the flash
op (CPU tensors run the kernel's plain version) against ``repro``'s Pallas
flash kernel run interpreted, the reference, the planners and the
attention cell's autograd.

Tolerance (f32): 1e-4 * max(1, max |ref|) — the same function with the
sums in another order (dense softmax against blockwise online softmax).
Planners are held field for field.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import machine as jm
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import attention as jax_model_attention
from repro.plan import planners as jp
from repro_torch.core import machine as tm
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_kernel
from repro_torch.kernels.flash_attention.flash_attention import smem_bytes, supported_blocks
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import transformer as tf
from repro_torch.models.attention import attention as model_attention
from repro_torch.plan import planners as tp
from test_torch_kernels import _ArgSink

TOL = 1e-4
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
MACHINES = [(jm.MANTICORE, tm.MANTICORE), (jm.TPU_V5E, tm.TPU_V5E)]


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _qkv(B, Hq, Hkv, Sq, Skv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


# (B, Hq, Hkv, Sq, Skv, D, causal, window, block_q, block_kv)
FLASH_CASES = [
    (1, 4, 4, 48, 48, 16, True, None, 16, 16),     # causal, three q blocks
    (1, 4, 4, 40, 56, 16, False, None, 16, 16),    # non-causal, ragged kv
    (1, 4, 2, 64, 64, 32, True, 24, 16, 16),       # GQA 4/2 with a window
    (2, 8, 1, 37, 37, 16, True, None, 16, 16),     # GQA 8/1, ragged lengths
    (1, 4, 4, 45, 45, 16, True, 12, 8, 16),        # window narrower than a block
    (1, 4, 2, 40, 40, 32, True, None, 16, 16),     # D = 32 (the smoke configs'), GQA 4/2
    (1, 2, 1, 40, 40, 256, True, None, 8, 8),      # D = 256 (gemma3-4b's), GQA 2/1
    (1, 4, 2, 48, 20, 16, True, 8, 16, 16),        # rows past kv_len + 7 see no key
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_op_matches_interpreted_pallas(case):
    """The port's flash op (the kernel's plain version on the CPU) against
    repro's Pallas kernel in interpret mode at the same blocks, rows with
    no visible key included (both write 0)."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, bq, bkv = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, D)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     window=window, block_q=bq, block_kv=bkv, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window, block_q=bq, block_kv=bkv,
                          machine=tm.TPU_V5E)
    assert_close(got.numpy(), np.asarray(want))
    if case == FLASH_CASES[-1]:
        assert np.all(got.numpy()[:, :, 27:] == 0) and np.all(np.asarray(want)[:, :, 27:] == 0)


@pytest.mark.parametrize("case", FLASH_CASES[:5])
def test_attention_ref_matches_repro(case):
    B, Hq, Hkv, Sq, Skv, D, causal, window, _, _ = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, D, seed=1)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, window=window)
    assert_close(got.numpy(), np.asarray(want))


def test_flash_plain_version_writes_zero_rows_and_checks_its_contract():
    """The kernel's plain version: padding rows and rows with no visible
    key are 0; operands that are not whole blocks are refused."""
    q, k, v = (torch.from_numpy(t[0]) for t in _qkv(1, 4, 2, 32, 16, 16))
    out = flash_attention_kernel(q, k, v, block_q=16, block_kv=16, scale=0.25, causal=True,
                                 window=4, q_len=30, kv_len=10)
    # rows 13.. see no key (q - k < 4 with k <= 9); rows 30, 31 are padding
    assert torch.all(out[:, 13:] == 0) and torch.all(out[:, :13].abs().amax(-1) > 0)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        flash_attention_kernel(q[:, :30], k, v, block_q=16, block_kv=16, scale=0.25,
                               causal=True, window=None, q_len=30, kv_len=10)


# (D, the H100 planner's blocks at S = 2048): the kernel's head dims, each
# at its instantiation's maxima; the blocks one step past them are refused.
FLASH_HEAD_DIMS = [(32, (128, 128)), (64, (128, 128)), (128, (64, 64)), (256, (32, 32))]


@pytest.mark.parametrize("d,blocks", FLASH_HEAD_DIMS)
def test_flash_kernel_takes_the_planners_blocks_at_its_head_dims(d, blocks):
    bq, bkv = blocks
    s = tp.AttentionPlanner(tm.H100).plan(seq_q=2048, seq_kv=2048, head_dim=d, n_q_heads=8,
                                          n_kv_heads=4, in_bytes=4, causal=True)
    assert (s.block("block_q"), s.block("block_kv")) == blocks
    assert s.vmem_bytes == smem_bytes(bq, bkv, d) <= tm.H100.local_mem_bytes
    assert supported_blocks(bq, bkv, d) and supported_blocks(8, 8, d)
    assert supported_blocks(bq - 8, bkv - 8, d)
    assert not supported_blocks(bq + 8, bkv, d) and not supported_blocks(bq, bkv + 8, d)
    assert not supported_blocks(bq - 4, bkv, d)  # not a multiple of 8
    # the launch wrapper hands these to the kernel ...
    q = torch.zeros(2, bq, d)
    kv = torch.zeros(1, bkv, d)
    sink = _ArgSink(flash_attention_kernel)
    out = fa_mod._launch(sink, q, kv, kv, block_q=bq, block_kv=bkv, scale=d ** -0.5,
                         causal=True, window=None, q_len=bq, kv_len=bkv)
    assert out.shape == q.shape and len(sink.args) == len(sink.argtypes) - 1
    assert sink.args[4:11] == (2, 1, bq, bkv, d, bq, bkv)


@pytest.mark.parametrize("d", [16, 48, 96, 512])
def test_flash_kernel_refuses_other_head_dims(d):
    """Any other head dim raises before a launch; the plain version, which
    CPU tensors run, takes it."""
    assert not supported_blocks(8, 8, d)
    q = torch.zeros(1, 16, d)
    sink = _ArgSink(flash_attention_kernel)
    kw = dict(block_q=8, block_kv=8, scale=0.5, causal=True, window=None, q_len=16,
              kv_len=16)
    with pytest.raises(ValueError, match="head_dim"):
        fa_mod._launch(sink, q, q, q, **kw)
    assert sink.args is None
    assert flash_attention_kernel(q, q, q, **kw).shape == q.shape


# (B, Sq, Hq, Hkv, D, causal, window): the plain forward's attention, direct
# (up to 4M scores per head) and blockwise (above, chunked 512 x 1024).
MODEL_CASES = [
    (2, 40, 4, 2, 16, True, None),
    (1, 48, 4, 1, 16, True, 7),
    (1, 3072, 1, 1, 8, True, None),
    (1, 3072, 1, 1, 8, True, 700),
]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_model_attention_matches_repro(case):
    """models/attention.attention (the plain path: GQA folded into the
    query axis, direct or blockwise) against repro's on [B, S, H, D]."""
    B, S, Hq, Hkv, D, causal, window = case
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    pos = np.arange(S, dtype=np.int32)
    want = jax_model_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                               causal=causal, window=window)
    got = model_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          q_pos=torch.from_numpy(pos), k_pos=torch.from_numpy(pos),
                          causal=causal, window=window)
    assert_close(got.numpy(), np.asarray(want))


# -- planners ----------------------------------------------------------------------

ATTN_SHAPES = [
    dict(seq_q=2048, seq_kv=2048, head_dim=64, n_q_heads=16, n_kv_heads=16, batch=4,
         causal=True),
    dict(seq_q=2048, seq_kv=2048, head_dim=128, n_q_heads=16, n_kv_heads=8, batch=4,
         causal=True),
    dict(seq_q=1000, seq_kv=500, head_dim=64, n_q_heads=16, n_kv_heads=8, causal=True,
         window=256),
    dict(seq_q=300, seq_kv=300, head_dim=32, causal=False),
    dict(seq_q=4096, seq_kv=4096, head_dim=256, n_q_heads=8, n_kv_heads=4, causal=True,
         window=1024),
    dict(seq_q=64, seq_kv=64, head_dim=64, block_q=16, block_kv=32, causal=True),
]


def _same(jax_sched, torch_sched):
    assert dataclasses.asdict(torch_sched) == dataclasses.asdict(jax_sched)


@pytest.mark.parametrize("machines", MACHINES, ids=["manticore", "tpu_v5e"])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("in_bytes", [2, 4])
def test_attention_planner_matches_repro(machines, shape, in_bytes):
    jmach, tmach = machines
    _same(jp.AttentionPlanner(jmach).plan(**shape, in_bytes=in_bytes),
          tp.AttentionPlanner(tmach).plan(**shape, in_bytes=in_bytes))


@pytest.mark.parametrize("q0", [0, 128, 640, 1920])
@pytest.mark.parametrize("window", [None, 1, 127, 128, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bkv", [(128, 128), (64, 128), (128, 32)])
def test_kv_blocks_run_matches_repro(q0, window, causal, bq, bkv):
    args = (q0, bq, bkv, 2048 // bkv, causal, window)
    assert tp.AttentionPlanner.kv_blocks_run(*args) == jp.AttentionPlanner.kv_blocks_run(*args)


# (D, the H100 planner's blocks at two bytes an element, shared memory): the
# bf16 route's instantiations; at D = 128 and 256 the q block doubles.
FLASH_HEAD_DIMS_BF16 = [(32, (128, 128), 66_560), (64, (128, 128), 132_096),
                        (128, (128, 64), 197_632), (256, (64, 32), 197_120)]


@pytest.mark.parametrize("d,blocks,smem", FLASH_HEAD_DIMS_BF16)
@pytest.mark.parametrize("window", [None, 1024])
def test_flash_bf16_takes_the_planners_blocks_at_its_head_dims(d, blocks, smem, window):
    """AttentionPlanner(H100) at in_bytes=2 picks, at every head dim the
    kernel is built for, blocks within MAX_BLOCKS_BF16 (its maxima, at
    the kernel's shared memory), and every candidate it hands the
    autotuner is one the bf16 route takes; a head dim it is not built for
    has none."""
    bq, bkv = blocks
    shape = dict(seq_q=2048, seq_kv=2048, head_dim=d, n_q_heads=16, n_kv_heads=8, batch=4,
                 in_bytes=2, causal=True, window=window)
    planner = tp.AttentionPlanner(tm.H100)
    s = planner.plan(**shape)
    assert (s.block("block_q"), s.block("block_kv")) == blocks == fa_mod.MAX_BLOCKS_BF16[d]
    assert s.vmem_bytes == smem_bytes(bq, bkv, d, 2) == smem <= tm.H100.local_mem_bytes
    cands = planner.local_candidates(**shape)
    assert cands and all(supported_blocks(c.block("block_q"), c.block("block_kv"), d,
                                          torch.bfloat16) for c in cands)
    assert not supported_blocks(bq + 8, bkv, d, torch.bfloat16)
    assert not supported_blocks(bq, bkv + 8, d, torch.bfloat16)
    with pytest.raises(tp.PlanRejected, match="head_dim 96"):
        planner.local_candidates(**dict(shape, head_dim=96))


@pytest.mark.parametrize("shape,blocks", [
    (ATTN_SHAPES[0], (128, 128)), (ATTN_SHAPES[1], (64, 64)), (ATTN_SHAPES[2], (128, 128)),
])
def test_attention_planner_h100_picks(shape, blocks):
    """On the H100 the planner's working set is exactly the kernel's shared
    memory, and its picks are blocks the kernel takes (230,400 B at the
    transformer's shape)."""
    s = tp.AttentionPlanner(tm.H100).plan(**shape, in_bytes=4)
    bq, bkv = s.block("block_q"), s.block("block_kv")
    assert (bq, bkv) == blocks
    assert s.vmem_bytes == smem_bytes(bq, bkv, shape["head_dim"]) <= tm.H100.local_mem_bytes
    assert supported_blocks(bq, bkv, shape["head_dim"])
    if shape is ATTN_SHAPES[0]:
        assert s.vmem_bytes == 230_400


@pytest.mark.parametrize("bq,bkv,d", [(128, 128, 64), (64, 64, 128), (64, 128, 64),
                                      (16, 8, 64), (40, 48, 128), (128, 128, 32),
                                      (32, 32, 256), (24, 16, 256)])
def test_kernel_smem_is_the_planner_budget(bq, bkv, d):
    assert smem_bytes(bq, bkv, d) == tp.AttentionPlanner(tm.H100)._vmem_bytes(bq, bkv, d, 4)


TB_SHAPES = [
    dict(batch=4, seq=2048, d_model=1024, n_heads=16, d_ff=2816, n_kv_heads=16,
         vocab=151936),
    dict(batch=2, seq=64, d_model=128, n_heads=4, d_ff=256, n_kv_heads=2),
]


@pytest.mark.parametrize("machines", MACHINES, ids=["manticore", "tpu_v5e"])
@pytest.mark.parametrize("shape", TB_SHAPES)
def test_transformer_block_planner_matches_repro(machines, shape):
    jmach, tmach = machines
    want = {n: p.plan(**kw) for n, (p, kw) in
            jp.TransformerBlockPlanner(jmach).cell_planners(**shape).items()}
    got = {n: p.plan(**kw) for n, (p, kw) in
           tp.TransformerBlockPlanner(tmach).cell_planners(**shape).items()}
    assert set(got) == set(want)
    for cell in want:
        _same(want[cell], got[cell])


def test_attention_planner_registry_and_moe_cell():
    """The MoE cell replaces the MLP cells with one MoeFfnPlanner cell, as
    in repro (tests/test_torch_families.py holds it field for field)."""
    assert isinstance(tp.planner_for("flash_attention"), tp.AttentionPlanner)
    cells = tp.TransformerBlockPlanner().cell_planners(**TB_SHAPES[1], n_experts=4)
    jcells = jp.TransformerBlockPlanner().cell_planners(**TB_SHAPES[1], n_experts=4)
    assert set(cells) == set(jcells) == {"qkv", "attn", "wo", "moe"}
    assert isinstance(cells["moe"][0], tp.MoeFfnPlanner) and cells["moe"][1] == jcells["moe"][1]


# -- the attention cell's autograd -------------------------------------------------


@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[2], FLASH_CASES[3]])
def test_attention_cell_grads_match_jax(case):
    """The planned attention cell (flash forward, backward through autograd
    of attention_ref) against jax.grad of repro's attention_ref."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, _, _ = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, D, seed=2)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_attention_ref(q, k, v, causal=causal, window=window) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = tf._attn_vjp(*leaves, causal, window, None)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert_close(a.numpy(), np.asarray(b))


def test_attention_cell_skips_unneeded_grads():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 2, 16, 16, 16, seed=4))
    q.requires_grad_(True)
    out = tf._attn_vjp(q, k, v, True, None, None)
    (gq,) = torch.autograd.grad(out.sum(), [q])
    assert gq.shape == q.shape and torch.isfinite(gq).all()
