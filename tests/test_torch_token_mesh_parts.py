"""Sequence-parallel attention and the other token families on a mesh,
against the JAX package, on CPU ranks (as ``test_torch_token_mesh.py``).

* Sequence-parallel attention (3 query heads over a model axis of 2): the
  op's forward and gradients against ``repro``'s ``attention(parallel=)``
  on 2 forced devices, with no collective inside the softmax; and the
  plain dense model of that config on 1x2, its FSDP step's step-1 loss and
  every gradient against ``jax.grad``.
* The smoke MoE and RWKV-6 on 2x1: the launcher's 3 losses against
  ``repro``'s launcher on 2 devices (capacity couples the tokens of one
  dispatch, so the MoE's reference is ``repro`` on the same mesh), and
  RWKV-6's step-1 gradients against ``jax.grad``.
* The recurrent and encoder-decoder families over a model axis of 2 build
  their step (``tests/test_torch_families_mesh.py`` holds them against
  ``repro``); the planned forward with query heads that do not split
  raises and names ROADMAP queue 1 #5c (the MoE over a model axis is
  ``tests/test_torch_moe_mesh.py``).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_ranks import run_ranks  # noqa: E402
from test_torch_token_mesh import (  # noqa: E402
    LOSS_TOL, REPRO, TIMEOUT, TOL, close, references, repro_init, repro_job, run_all,
)

ARCH = "qwen1.5-0.5b"
SEQP = {"n_heads": 3, "n_kv_heads": 1}
FAMILIES = {"moe": "qwen3-moe-235b-a22b", "rwkv6": "rwkv6-1.6b"}

ATTN = """
from repro.core.shard_compat import make_auto_mesh
from repro.models.attention import attention
from repro.runtime.parallel import ParallelCtx
import jax, jax.numpy as jnp, numpy as np
mesh = make_auto_mesh((1, 2), ("data", "model"))
ctx = ParallelCtx(mesh=mesh, dp_axes=("data",), tp_axis="model")
d = np.load(ATTN_IN)
q, k, v, c = (jnp.asarray(d[n]) for n in ("q", "k", "v", "c"))
pos = jnp.arange(q.shape[1], dtype=jnp.int32)
def f(q, k, v):
    with mesh:
        y = attention(q, k, v, q_pos=pos, k_pos=pos, causal=True, window=None, parallel=ctx)
    return (y * c).sum(), y
(_, y), (gq, gk, gv) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(q, k, v)
np.savez(ATTN_OUT, y=np.asarray(y), gq=np.asarray(gq), gk=np.asarray(gk), gv=np.asarray(gv))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    base = tmp_path_factory.mktemp("token_parts")
    rng = np.random.default_rng(11)
    seqp = base / "seqp"
    seqp.mkdir()
    attn = {"q": rng.standard_normal((2, 16, 3, 32)), "k": rng.standard_normal((2, 16, 1, 32)),
            "v": rng.standard_normal((2, 16, 1, 32)), "c": rng.standard_normal((2, 16, 3, 32))}
    np.savez(seqp / "attn.npz", **{k: v.astype(np.float32) for k, v in attn.items()})
    np.savez(seqp / "init_seqp.npz", **repro_init(ARCH, "transformer", **SEQP))
    prelude = (f"ATTN_IN = {str(seqp / 'attn.npz')!r}\n"
               f"ATTN_OUT = {str(base / 'attn.npz')!r}\n" + ATTN)
    jobs = {
        "repro_moe": repro_job(REPRO, base / "repro_moe.npz", [("moe", "2x1")], [],
                               devices=2),
        "repro_rwkv6": repro_job(REPRO, base / "repro_rwkv6.npz", [("rwkv6", "2x1")],
                                 [("rwkv6", "rwkv6", FAMILIES["rwkv6"], {})], devices=2),
        "repro_seqp": repro_job(REPRO, base / "repro_seqp.npz", [],
                                [("seqp", "transformer", ARCH, SEQP)], devices=2,
                                prelude=prelude),
        "seqp": lambda: run_ranks("seqp", 2, seqp, {"window": None, "heads": SEQP},
                                  timeout=TIMEOUT),
    }
    for family, arch in FAMILIES.items():
        d = base / family
        d.mkdir()
        np.savez(d / "init.npz", **repro_init(arch, family))
        jobs[family] = (lambda d=d, family=family, arch=arch: run_ranks(
            "tokens", 2, d, {"family": family, "arch": arch, "mesh": "2x1",
                             "variants": ["plain"]}, timeout=TIMEOUT))
    return base, run_all(jobs)


def _ref(results, part):
    base, errors = results
    return base, references(base, errors, part)


@pytest.mark.parametrize("rank", [0, 1])
def test_sequence_parallel_attention_equals_repro(results, rank):
    base, _ = _ref(results, "seqp")
    want = dict(np.load(base / "attn.npz"))
    got = dict(np.load(base / "seqp" / f"seqp_rank{rank}.npz"))
    for k in ("y", "gq", "gk", "gv"):
        close(got[k], want[k], TOL)
    # One gather of the query slices' outputs; no collective in the softmax.
    assert int(got["fwd_gathers"]) == 1 and int(got["fwd_psums"]) == 0


@pytest.mark.parametrize("block,split", [("attn_heads", "heads"), ("attn_seq", "seq"),
                                         ("mlp", "True")])
def test_tensor_parallel_blocks_equal_the_whole_block(results, block, split):
    """``layers.apply_attention``/``apply_mlp`` over the model axis: the
    output and every gradient equal the block run whole on one rank."""
    base, _ = _ref(results, "seqp")
    for rank in (0, 1):
        got = dict(np.load(base / "seqp" / f"seqp_rank{rank}.npz"))
        assert str(got[f"{block}.split"]) == split
        assert float(got[f"{block}.err"]) <= TOL


def test_sequence_parallel_model_grads_equal_jax_grad(results):
    base, want = _ref(results, "seqp")
    got = dict(np.load(base / "seqp" / "seqp_rank0.npz"))
    close(got["loss1"], want["seqp.loss1"], TOL)
    names = [k[len("seqp.grad."):] for k in want if k.startswith("seqp.grad.")]
    assert sorted(names) == sorted(k[len("grad."):] for k in got if k.startswith("grad."))
    for k in names:
        close(got[f"grad.{k}"], want[f"seqp.grad.{k}"], TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_launcher_losses_on_2x1_equal_repro(results, family):
    base, want = _ref(results, family)
    got = dict(np.load(base / family / "tokens_2x1.npz"))
    w, g = want[f"{family}.2x1.losses"], got["plain.losses"]
    assert len(w) == len(g) == 3
    for a, b in zip(g, w):
        assert abs(a - b) <= LOSS_TOL * abs(b), (g, w)


def test_rwkv6_step1_grads_on_2x1_equal_jax_grad(results):
    base, want = _ref(results, "rwkv6")
    got = dict(np.load(base / "rwkv6" / "tokens_2x1.npz"))
    close(got["plain.loss1"], want["rwkv6.loss1"], TOL)
    names = [k[len("rwkv6.grad."):] for k in want if k.startswith("rwkv6.grad.")]
    assert len(names) == sum(k.startswith("plain.grad.") for k in got)
    for k in names:
        close(got[f"plain.grad.{k}"], want[f"rwkv6.grad.{k}"], TOL)


class _Stub:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _ctx(data: int, model: int):
    from repro_torch.runtime.parallel import ParallelCtx

    return ParallelCtx(mesh=_Stub({"data": data, "model": model}))


@pytest.mark.parametrize("family", ["rwkv6", "zamba2", "encdec"])
def test_other_families_over_a_model_axis_raise_5c(family):
    """These families raised over a model axis above 1 until #5c's
    recurrent and encoder-decoder part: building the step raises nothing
    now, with ``int8_ef`` on the shards too
    (``tests/test_torch_families_mesh.py`` runs the steps and holds them
    against ``repro``)."""
    from repro_torch.configs import FAMILY_DEFAULT_ARCH, TrainConfig, smoke_config
    from repro_torch.runtime import train as tr

    cfg = dataclasses.replace(smoke_config(FAMILY_DEFAULT_ARCH[family]), family=family)
    for knob in ("none", "int8_ef"):
        tr.make_train_step(cfg, TrainConfig(grad_compression=knob), parallel=_ctx(1, 2),
                           grad_specs={})


def test_planned_forward_with_undividable_heads_raises_5c():
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.module import init_params

    cfg = dataclasses.replace(smoke_config(ARCH), **SEQP)
    params = init_params(tf.param_defs(cfg), 0, device="cpu")
    tokens = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="5c"):
        tf.forward(cfg, params, tokens, use_kernels=True, parallel=_ctx(1, 2))
