"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; the
file imports neither JAX nor ``repro``, so it runs on a machine with a card
and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance (f32): max |kernel - plain| <= 1e-4 * max(1, max |plain|) — sums
in another order over up to a few thousand terms.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.conv2d.ops import conv2d, conv2d_with_mask
from repro_torch.kernels.matmul import fc_matmul, matmul_kernel

TOL = 1e-4

# (B, H, d_in, d_out, F, S, P, pool, block_h), as in test_torch_kernels.py
CONV_CASES = [
    (2, 8, 3, 8, 3, 1, 1, 2, None),
    (2, 9, 5, 7, 3, 1, 1, 1, 4),
    (1, 12, 8, 16, 3, 2, 0, 1, None),
    (2, 13, 6, 10, 3, 2, 1, 2, None),
    (3, 10, 4, 9, 3, 1, 1, 2, 4),
    (1, 8, 3, 5, 5, 1, 2, 2, None),
    (2, 7, 17, 3, 1, 1, 0, 1, None),
]


def assert_close(got, want, tol=TOL):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    # the plain versions are f32 references only with TF32 off
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(37, 90, 70), (256, 2048, 4096)])
def test_matmul_kernel_matches_plain_on_card(cuda, m, k, n):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, m, k), _rand(rng, k, n)
    before = matmul_kernel.launches
    got = fc_matmul(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert matmul_kernel.launches == before + 1
    assert_close(got, x.double() @ w.double())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_kernel_matches_plain_on_card(cuda, case):
    B, H, di, do, Fk, S, P, pool, hb = case
    rng = np.random.default_rng(0)
    x = _rand(rng, B, H, H, di).to(cuda)
    f = _rand(rng, Fk, Fk, di, do, scale=1 / Fk).to(cuda)
    b = _rand(rng, do).to(cuda)
    got = conv2d(x, f, bias=b, stride=S, padding=P, relu=True, pool=pool,
                 block_h=hb, algorithm="direct")
    want = conv2d(x.cpu(), f.cpu(), bias=b.cpu(), stride=S, padding=P, relu=True,
                  pool=pool, block_h=hb, algorithm="direct")
    assert_close(got, want)


@pytest.mark.cuda
def test_kernel_refuses_tensors_requiring_grad(cuda):
    x = torch.ones(8, 8, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        fc_matmul(x, torch.ones(8, 8, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [1, 2])
def test_mask_matches_plain_on_card(cuda, pool):
    """Integer operands sum exactly in f32, so ties and dead windows are
    real and the kernel's mask must equal the plain version's everywhere."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-2, 3, (2, 10, 10, 5)).astype(np.float32))
    f = torch.from_numpy(rng.integers(-1, 2, (3, 3, 5, 12)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-1, 2, (12,)).astype(np.float32))
    out, mask = conv2d_with_mask(x.to(cuda), f.to(cuda), bias=b.to(cuda), padding=1,
                                 pool=pool)
    want_out, want_mask = conv2d_with_mask(x, f, bias=b, padding=1, pool=pool)
    assert torch.equal(out.cpu(), want_out)
    assert torch.equal(mask.cpu(), want_mask)
