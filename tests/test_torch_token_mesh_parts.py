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
  their step and run it on a stub mesh (``tests/test_torch_families_mesh.py``
  holds them against ``repro``); the planned forward with query heads that
  do not split takes the sequence-parallel attention where the sequence
  splits, and raises where it does not (the MoE over a model axis is
  ``tests/test_torch_moe_mesh.py``).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

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
    """A mesh's shape seen from its first rank, with no process group: each
    collective over an axis of it returns this rank's tensor as it is (a
    psum of one term), so a step runs through every code path of the model
    axis without other ranks (the numbers are not the mesh's)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def axes(self, names):
        return (names,) if isinstance(names, str) else tuple(names)

    def axis_size(self, names):
        return int(np.prod([self.shape[a] for a in self.axes(names)]))

    def axis_index(self, names):
        return 0

    def group(self, names):
        return None


def _ctx(data: int, model: int):
    from repro_torch.runtime.parallel import ParallelCtx

    return ParallelCtx(mesh=_Stub({"data": data, "model": model}))


@pytest.mark.parametrize("family", ["rwkv6", "zamba2", "encdec"])
def test_other_families_build_and_run_a_step_over_a_model_axis(family):
    """The recurrent and encoder-decoder families over a model axis of 2:
    the step builds and one AdamW step runs on the stub mesh to a finite
    loss, with ``int8_ef`` on the shards too
    (``tests/test_torch_families_mesh.py`` runs the steps on ranks and
    holds them against ``repro``)."""
    import torch

    from repro_torch.configs import FAMILY_DEFAULT_ARCH, TrainConfig, smoke_config
    from repro_torch.models.module import init_params
    from repro_torch.models.registry import get_family
    from repro_torch.plan.sharded import P
    from repro_torch.runtime import train as tr

    cfg = dataclasses.replace(smoke_config(FAMILY_DEFAULT_ARCH[family]), family=family)
    params = init_params(get_family(family).param_defs(cfg), 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)))
    batch = {"tokens": tokens[:, :8], "labels": tokens[:, 1:]}
    if family == "encdec":
        batch["frames"] = torch.zeros((2, 16, cfg.d_model))
    whole = {k: P() for k in params}
    for knob in ("none", "int8_ef"):
        tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                           grad_compression=knob, loss_chunks=4)
        step = tr.make_train_step(cfg, tcfg, parallel=_ctx(1, 2), grad_specs=whole)
        _, metrics = step(tr.init_state(cfg, tcfg, params), batch)
        assert np.isfinite(float(metrics["loss"]))


def test_planned_forward_with_undividable_heads_splits_the_sequence():
    """3 query heads on a model axis of 2 run the planned attention
    sequence-parallel where the sequence splits (16 rows a rank, a GQA
    block of 48 rows); a sequence that splits neither way raises and names
    ROADMAP queue 3 (``tests/test_torch_long_mesh.py`` runs the
    sequence-parallel step on ranks against ``repro``)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import layers as ll
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(smoke_config(ARCH), **SEQP)
    assert ll.attention_split(cfg, 32, _ctx(1, 2)) == "seq"
    assert tf.attn_rows(cfg, 32, _ctx(1, 2)) == 16
    tf.check_planned_heads(cfg, 2, 32)
    with pytest.raises(NotImplementedError, match="queue 3"):
        tf.check_planned_heads(cfg, 2, 15)
