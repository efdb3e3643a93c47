"""The bf16 forward matmul, NT and TN on Hopper's tensor cores (``wgmma``),
on the CPU: which kernel each dtype route and tile names, the shared memory
its launch takes against the H100 planner's budget, the splits (unchanged
from the FMA kernels'), the C entry point a bf16 launch reaches, and each
kernel's plain version at the planner's tile against ``repro``'s Pallas
kernel run interpreted on the same bf16 numpy operands.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``-k wgmma``).  Tolerances: the forward's bf16 output within one bf16 ulp
of ``repro``'s (two f32 sums rounded once; the ulp taken at
max(|ref|, 2^-8 max|ref|)), NT's f32 dX and TN's f32 dW within
1e-5 * max(1, max |ref|) (f32 sums of bf16 products in another order), as
tests/test_torch_bf16.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.bwd import matmul_nt_pallas, matmul_tn_pallas
from repro.kernels.matmul.matmul import matmul_pallas
from repro_torch.configs import get_config
from repro_torch.core import fc_layer as fl
from repro_torch.kernels.matmul import bwd as mb
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.models import transformer as tf

BF, F32 = torch.bfloat16, torch.float32
FWD_TILE, NT_TILE, TN_TILE = mm.REGISTER_TILE, mb.NT_REGISTER_TILE, mb.TN_REGISTER_TILE
CELLS = ("qkv", "wo", "mlp_up", "mlp_down", "logits")


class _ArgSink:
    """Stands in for a CudaKernel: records the C arguments and the route a
    launch wrapper passes to ``run``."""

    def __init__(self, kernel):
        self.kernel, self.argtypes, self.args, self.dtype = kernel, kernel.argtypes, None, None
        self.operand_dtype = kernel.operand_dtype

    def run(self, *args, dtype=F32):
        self.args, self.dtype = args, dtype

    @property
    def symbol(self) -> str:
        return self.kernel.symbols[self.dtype]


# -- which kernel each route and tile names -----------------------------------------


@pytest.mark.parametrize("blocks,dtypes,want", [
    (FWD_TILE, (BF, BF), "wgmma"),
    (FWD_TILE, (F32, F32), "register"),
    (FWD_TILE, (BF, F32), "register"),   # the CNN's bf16 x f32 routes keep the FMA kernel
    ((32, 64, 32), (BF, BF), "simple"),
    ((64, 128, 64), (BF, BF), "simple"),
    ((8, 16, 16), (F32, F32), "simple"),
])
def test_forward_template_per_route_and_tile(blocks, dtypes, want):
    assert mm.template(*blocks, dtypes) == want
    assert mm.TEMPLATES.index(want) == {"simple": 0, "register": 1, "wgmma": 2}[want]


@pytest.mark.parametrize("blocks,dtypes,want", [
    (NT_TILE, (BF, BF), "wgmma"),
    (NT_TILE, (F32, F32), "register"),
    (NT_TILE, (BF, F32), "register"),
    ((64, 32, 64), (BF, BF), "simple"),
    ((8, 16, 16), (BF, BF), "simple"),
])
def test_nt_template_per_route_and_tile(blocks, dtypes, want):
    assert mb.nt_template(*blocks, dtypes) == want


@pytest.mark.parametrize("blocks,dtypes,want", [
    (TN_TILE, (BF, BF), "wgmma"),
    (TN_TILE, (F32, F32), "register"),
    (TN_TILE, (BF, F32), "register"),
    ((32, 64, 32), (BF, BF), "simple"),
    ((64, 128, 32), (BF, BF), "simple"),  # the forward's tile is not TN's
    ((8, 16, 16), (BF, BF), "simple"),
])
def test_tn_template_per_route_and_tile(blocks, dtypes, want):
    assert mb.tn_template(*blocks, dtypes) == want
    assert mb.TN_TEMPLATES.index(want) == {"simple": 0, "register": 1, "wgmma": 2}[want]


def test_templates_default_to_f32():
    """Callers that name no dtypes (the f32 phases) keep the register kernels."""
    assert mm.template(*FWD_TILE) == "register"
    assert mb.nt_template(*NT_TILE) == "register"
    assert mb.tn_template(*TN_TILE) == "register"


# -- shared memory: the planner's bytes ---------------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-1.7b"])
def test_wgmma_launch_takes_the_planners_bytes(arch):
    """At every GEMM of the planned bf16 step the forward and NT schedules
    sit on the wgmma tile, and the bytes the launch allocates
    (smem_bytes at two bytes an element, which the C launch computes by
    the same formula) equal the schedule's vmem_bytes: 57,344 B, which
    holds the kernel's four 12,288 B stages, a 1024-byte alignment and
    the barriers."""
    plans = tf.plan_training(get_config(arch), 4, 2048, loss_chunks=4, in_bytes=2)
    ring = 4 * (64 * 32 + 32 * 128) * 2 + 1024 + 4 * 8
    for cell in CELLS:
        fwd, dx = plans[cell], plans[f"{cell}.dx"]
        fb = tuple(fwd.block(b) for b in ("block_m", "block_n", "block_k"))
        nb = tuple(dx.block(b) for b in ("block_m", "block_n", "block_k"))
        assert mm.template(*fb, (BF, BF)) == "wgmma", cell
        assert dx.algorithm == "direct" and mb.nt_template(*nb, (BF, BF)) == "wgmma", cell
        assert mm.smem_bytes(*fb, in_bytes=2) == fwd.vmem_bytes == 57_344
        assert mb.smem_bytes_nt(*nb, in_bytes=2) == dx.vmem_bytes == 57_344
        assert ring <= 57_344


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-1.7b"])
def test_tn_wgmma_launch_takes_the_planners_bytes(arch):
    """Every dW cell of the planned bf16 step sits on TN's tile, which names
    the wgmma kernel for bf16 operands, and the bytes TN's launch allocates
    (smem_bytes_tn at two bytes an element, the C launch's formula) equal
    MatmulDwPlanner's vmem_bytes: 57,344 B, the forward's ring again (the
    kernel's four 12,288 B stages of a [32][64] X box and two [32][64] dY
    halves, a 1024-byte alignment and the barriers)."""
    plans = tf.plan_training(get_config(arch), 4, 2048, loss_chunks=4, in_bytes=2)
    ring = 4 * (32 * 64 + 32 * 128) * 2 + 1024 + 4 * 8
    dws = [c for c in plans if c.endswith(".dw")]
    assert sorted(dws) == sorted(f"{cell}.dw" for cell in CELLS)
    for cell in dws:
        dw = plans[cell]
        blocks = tuple(dw.block(b) for b in ("block_m", "block_n", "block_k"))
        assert blocks == TN_TILE, cell
        assert mb.tn_template(*blocks, (BF, BF)) == "wgmma", cell
        assert mb.smem_bytes_tn(*blocks, in_bytes=2) == dw.vmem_bytes == 57_344, cell
        assert ring <= 57_344


def test_fc_plan_bwd_at_bf16_names_the_nt_tile():
    """The FC layer's bf16 dX plan at the transformer's shapes (a direct NT)
    takes the tile the wgmma kernel serves, at the same bytes."""
    for m, k, n in ((8192, 1024, 3072), (8192, 2816, 1024), (2048, 1024, 151936)):
        dx = fl.plan_bwd((m, k), (k, n), in_bytes=2)["dx"]
        assert dx.algorithm == "direct"
        nb = tuple(dx.block(b) for b in ("block_m", "block_n", "block_k"))
        assert nb == NT_TILE and dx.vmem_bytes == 57_344


# -- splits: a function of the shapes and the bytes, unchanged -----------------------


# (m, k, n, forward split, NT split) at the planner's tiles, f32 and bf16 alike:
# the qwen1.5-0.5b step's shapes (one wave or more: no split), the CNN's fc
# shapes (padded to the tiles) and the fused kernel's batch.
SPLITS = [(8192, 1024, 3072, 1, 1), (8192, 1024, 1024, 1, 1), (8192, 1024, 5632, 1, 1),
          (8192, 2816, 1024, 1, 1), (2048, 1024, 151936, 1, 1), (256, 2048, 4096, 2, 4),
          (256, 4096, 1024, 8, 2), (128, 2048, 4096, 4, 8)]


@pytest.mark.parametrize("m,k,n,fwd,nt", SPLITS)
@pytest.mark.parametrize("in_bytes", [4, 2])
def test_splits_are_unchanged(m, k, n, fwd, nt, in_bytes):
    assert mm.mm_split(m=m, n=n, k=k, block_m=64, block_n=128, block_k=32,
                       in_bytes=in_bytes) == fwd
    assert mb.nt_split(m=m, n=n, k=k, block_m=64, block_n=32, block_k=128,
                       in_bytes=in_bytes) == nt


# -- the C entry point a launch reaches ----------------------------------------------


@pytest.mark.parametrize("x_dtype,w_dtype,symbol,code", [
    (BF, BF, "repro_matmul_bf16", 2),
    (F32, F32, "repro_matmul_f32", 1),
    (BF, F32, "repro_matmul_bf16xf32_bf16", 1),
])
@pytest.mark.parametrize("m,k,n,split", [(256, 4096, 1024, 8), (768, 64, 1408, 1)])
def test_forward_launch_reaches_its_entry_point(x_dtype, w_dtype, symbol, code, m, k, n,
                                                split):
    """A launch at the planner's tile passes the template's code (2 wgmma
    for bf16 operands, 1 the FMA register kernel) to its route's entry
    point, with mm_split's split and a slab buffer exactly when it splits."""
    sink = _ArgSink(mm.matmul_kernel)
    bm, bn, bk = FWD_TILE
    out = mm._launch(sink, torch.zeros(m, k, dtype=x_dtype), torch.zeros(k, n, dtype=w_dtype),
                     block_m=bm, block_n=bn, block_k=bk)
    assert out.dtype == x_dtype and tuple(out.shape) == (m, n)
    assert sink.symbol == symbol
    assert sink.args[4:] == (m, n, k, bm, bn, bk, split, code)
    assert (sink.args[3].value is not None) == (split > 1)


@pytest.mark.parametrize("g_dtype,w_dtype,symbol", [
    (BF, BF, "repro_matmul_nt_bf16"),
    (F32, F32, "repro_matmul_nt_f32"),
    (BF, F32, "repro_matmul_nt_bf16xf32"),
])
@pytest.mark.parametrize("m,n,k,split", [(256, 4096, 1024, 8), (128, 151936, 1024, 16),
                                         (768, 96, 1408, 1)])
def test_nt_launch_reaches_its_entry_point(g_dtype, w_dtype, symbol, m, n, k, split):
    """NT's launch at its tile reaches the route's entry point (the C side
    picks the wgmma kernel from the tile and bf16 operands) with nt_split's
    split and a slab buffer exactly when it splits; dX is f32."""
    sink = _ArgSink(mb.matmul_nt_kernel)
    bm, bn, bk = NT_TILE
    out = mb._launch_nt(sink, torch.zeros(m, n, dtype=g_dtype),
                        torch.zeros(k, n, dtype=w_dtype), block_m=bm, block_n=bn, block_k=bk)
    assert out.dtype == F32 and tuple(out.shape) == (m, k)
    assert sink.symbol == symbol
    assert sink.args[4:] == (m, n, k, bm, bn, bk, split)
    assert (sink.args[3].value is not None) == (split > 1)


@pytest.mark.parametrize("x_dtype,symbol,code", [
    (BF, "repro_matmul_tn_bf16", 2),
    (F32, "repro_matmul_tn_f32", 1),
])
@pytest.mark.parametrize("m,k,n,split", [(8192, 1024, 1024, 2), (256, 2048, 4096, 1),
                                         (8192, 1024, 3072, 1), (256, 1024, 1024, 2)])
def test_tn_launch_reaches_its_entry_point(x_dtype, symbol, code, m, k, n, split):
    """TN's launch at its tile passes the template's code (2 wgmma for bf16
    operands, 1 the FMA register kernel) to its route's entry point, with
    tn_split's split (the same at both element sizes) and a slab buffer
    exactly when it splits; dW is f32."""
    sink = _ArgSink(mb.matmul_tn_kernel)
    bm, bn, bk = TN_TILE
    out = mb._launch_tn(sink, torch.zeros(m, k, dtype=x_dtype),
                        torch.zeros(m, n, dtype=x_dtype), block_m=bm, block_n=bn, block_k=bk)
    assert out.dtype == F32 and tuple(out.shape) == (k, n)
    assert sink.symbol == symbol
    assert sink.args[4:] == (m, n, k, bm, bn, bk, split, code)
    assert (sink.args[3].value is not None) == (split > 1)


# -- the plain versions at the wgmma tile against repro's kernels ---------------------


def _bf16(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    t = torch.from_numpy(a).to(BF)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32), np.float64)


@pytest.mark.parametrize("m,k,n", [(64, 32, 128), (128, 96, 256), (192, 64, 384)])
def test_forward_at_the_wgmma_tile_matches_pallas(m, k, n):
    rng = np.random.default_rng(35)
    (x, jx), (w, jw) = _bf16(rng, m, k), _bf16(rng, k, n, scale=k ** -0.5)
    bm, bn, bk = FWD_TILE
    got = mm.matmul_kernel(x, w, block_m=bm, block_n=bn, block_k=bk)
    want = _np(matmul_pallas(jx, jw, block_m=bm, block_n=bn, block_k=bk, interpret=True))
    assert got.dtype == BF
    g = _np(got)
    floor = 2.0 ** -8 * float(np.abs(want).max())
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(want), floor))[1] - 8)
    assert bool((np.abs(g - want) <= ulp).all())


@pytest.mark.parametrize("m,n,k", [(64, 32, 128), (128, 96, 256), (192, 64, 384)])
def test_nt_at_the_wgmma_tile_matches_pallas(m, n, k):
    rng = np.random.default_rng(36)
    (g, jg), (w, jw) = _bf16(rng, m, n), _bf16(rng, k, n, scale=n ** -0.5)
    bm, bn, bk = NT_TILE
    got = mb.matmul_nt_kernel(g, w, block_m=bm, block_n=bn, block_k=bk)
    want = _np(matmul_nt_pallas(jg, jw, block_m=bm, block_n=bn, block_k=bk,
                                out_dtype=jnp.float32, interpret=True))
    assert got.dtype == F32
    assert float(np.abs(_np(got) - want).max()) <= 1e-5 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("m,k,n", [(32, 64, 128), (96, 128, 256), (256, 192, 384)])
def test_tn_at_the_wgmma_tile_matches_pallas(m, k, n):
    rng = np.random.default_rng(37)
    (x, jx), (g, jg) = _bf16(rng, m, k), _bf16(rng, m, n, scale=m ** -0.5)
    bm, bn, bk = TN_TILE
    got = mb.matmul_tn_kernel(x, g, block_m=bm, block_n=bn, block_k=bk)
    want = _np(matmul_tn_pallas(jx, jg, block_m=bm, block_n=bn, block_k=bk,
                                out_dtype=jnp.float32, interpret=True))
    assert got.dtype == F32
    assert float(np.abs(_np(got) - want).max()) <= 1e-5 * max(1.0, float(np.abs(want).max()))
