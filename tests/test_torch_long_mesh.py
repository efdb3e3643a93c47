"""The batch-1 decode over a sequence-split KV cache and the planned
sequence-parallel attention, against the JAX package, on CPU ranks (as
``test_torch_moe_mesh.py``).

* The sequence-split KV cache: batch 1 on (2, 2) and (2, 1) leaves the
  data axis idle, so every KV cache spreads its sequence over it (a rank
  holds 16 of 32 positions; the encoder-decoder's cross K/V 32 of its 64
  frames).  For the smoke dense, MoE, Zamba2 and encoder-decoder configs
  and the smoke gemma3 at a window of 8 (where a rank's piece falls wholly
  outside a decode's window), the port's ranks (``tests/_torch_ranks.py``,
  case ``long_mesh``) run ``make_prefill_step`` on a prompt of 20 tokens
  (past the ranks' boundary at 16), 4 greedy decodes and one decode at 35,
  past ``max_seq``, where the write's start clamps: the logits, and the
  caches gathered whole, within 1e-5 of scale of ``repro``'s builders on
  the same mesh (one JAX subprocess a mesh on forced host devices), and
  the greedy tokens equal.  ``repro``'s MoE cannot run a batch of 1 over a
  data axis above 1 (its ``shard_map`` splits the batch over every data
  axis); the rows replicate there and each data rank dispatches alone, so
  the MoE's reference is ``repro`` on a (1, model) mesh.  The bucket
  prefill and the slot decode are held against the port's own one-device
  run (``repro``'s slot decode cannot run over a data axis above 1).
* The flash kernel's plain version at a query offset: rows ``[q_off,
  q_off + n)`` of ``repro``'s ``attention_ref`` over the whole queries,
  within 1e-6.
* The planned forward with 3 query heads on a model axis of 2 (case
  ``long_planned``): the attention cell sequence-parallel on the flash
  kernel's plain version at offsets 0 and 16; the FSDP step's loss and
  every gradient within 1e-4 x max(1, max|g|) of ``jax.grad`` of
  ``repro``'s planned loss (its Pallas kernels interpreted); and
  ``AttentionPlanner`` at the rank's shapes (S / tp query rows against S
  keys) field for field against ``repro``'s on MANTICORE and TPU_V5E.

Every part starts at once, each rank group under a 120 s timeout.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_ranks import LONG_MAX_SEQ, run_ranks  # noqa: E402
from test_torch_moe_mesh import REF_TIMEOUT, _run_repro  # noqa: E402
from test_torch_sharded import join  # noqa: E402
from test_torch_token_mesh import TIMEOUT, TOL, close, repro_init, run_all  # noqa: E402

SERVE_TOL = 1e-5
FLASH_TOL = 1e-6
MESHES = ["2x2", "2x1"]
# tag: (arch, config changes)
PARTS = {"dense": ("qwen1.5-0.5b", {}),
         "gemma3": ("gemma3-4b", {"local_window": 8, "global_every": 2}),
         "moe": ("qwen3-moe-235b-a22b", {}),
         "zamba2": ("zamba2-1.2b", {}),
         "encdec": ("seamless-m4t-medium", {})}
FAMILY = {"dense": "transformer", "gemma3": "transformer", "moe": "moe", "zamba2": "zamba2",
          "encdec": "encdec"}
PLANNED_ARCH = "qwen1.5-0.5b"
SEQP = {"n_heads": 3, "n_kv_heads": 1}  # as tests/test_torch_token_mesh_parts.py

REPRO = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import smoke_config
from repro.core.shard_compat import make_auto_mesh
from repro.models.module import init_params
from repro.models.registry import get_family
from repro.runtime import serve as jsv
from repro.runtime.parallel import ParallelCtx
from repro_torch.convert import flatten_tree
sys.path.insert(0, TESTS)
from _torch_ranks import long_builders, long_inputs
dims = tuple(int(x) for x in MESH.split("x"))

class Jitted:  # the builders' steps jitted, as repro's engine runs them
    def __getattr__(self, name):
        return lambda *a, **kw: jax.jit(getattr(jsv, name)(*a, **kw))

out = {}
for tag, arch, family, changes in PARTS:
    # repro's MoE shard_map splits the batch over every data axis, which a
    # batch of 1 cannot fill: its rows replicate there, so each data rank
    # dispatches alone, as on a (1, model) mesh.
    shape = (1, dims[1]) if family == "moe" else dims
    mesh = make_auto_mesh(shape, ("data", "model"))
    ctx = ParallelCtx(mesh=mesh, dp_axes=("data",), tp_axis="model")
    cfg = dataclasses.replace(smoke_config(arch), **changes)
    params = init_params(get_family(family).param_defs(cfg), jax.random.PRNGKey(0),
                         jnp.float32)
    with mesh:
        got = long_builders(Jitted(), cfg, params, long_inputs(cfg), ctx, lift=jnp.asarray,
                            whole=flatten_tree)
    out.update({f"{tag}.{k}": v for k, v in got.items()})
np.savez(OUT, **out)
"""

PLANNED = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.data.pipeline import ShardInfo
from repro.models.module import init_params
from repro.models.registry import get_family, make_data_source
from repro.runtime import train as jrt
from repro_torch.convert import flatten_tree
cfg = dataclasses.replace(smoke_config(ARCH), **CHANGES)
tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                   remat="none", planned_kernels=True)
params = init_params(get_family("transformer").param_defs(cfg), jax.random.PRNGKey(0),
                     jnp.float32)
batch = {k: jnp.asarray(v) for k, v in
         make_data_source(cfg, 4, 32, ShardInfo(0, 1), seed=0)(0).items()}
loss, g = jax.value_and_grad(jrt.make_loss_fn(cfg, tcfg))(params, batch)
out = {"loss1": np.asarray(loss)}
out.update({f"grad.{k}": v for k, v in flatten_tree(jax.tree.map(np.asarray, g)).items()})
np.savez(OUT, **out)
"""


def _world(mesh: str) -> int:
    return int(np.prod([int(x) for x in mesh.split("x")]))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    base = tmp_path_factory.mktemp("long_mesh")
    tests = str(Path(__file__).resolve().parent)
    parts = [[tag, arch, changes] for tag, (arch, changes) in PARTS.items()]
    jparts = [(tag, arch, FAMILY[tag], changes) for tag, (arch, changes) in PARTS.items()]
    inits = {tag: repro_init(arch, FAMILY[tag], **changes)
             for tag, (arch, changes) in PARTS.items()}
    jobs = {}
    for mesh in MESHES:
        d = base / mesh
        d.mkdir()
        for tag, init in inits.items():
            np.savez(d / f"init_{tag}.npz", **init)
        script = (f"OUT = {str(d / 'repro.npz')!r}\nMESH = {mesh!r}\nTESTS = {tests!r}\n"
                  f"PARTS = {jparts!r}\n" + REPRO)
        jobs[f"repro_{mesh}"] = (lambda script=script, mesh=mesh: join(
            _run_repro(script, devices=_world(mesh)), timeout=REF_TIMEOUT))
        jobs[mesh] = (lambda d=d, mesh=mesh: run_ranks(
            "long_mesh", _world(mesh), d, {"mesh": mesh, "parts": parts}, timeout=TIMEOUT))
    d = base / "planned"
    d.mkdir()
    np.savez(d / "init.npz", **repro_init(PLANNED_ARCH, "transformer", **SEQP))
    script = (f"OUT = {str(d / 'repro.npz')!r}\nARCH = {PLANNED_ARCH!r}\n"
              f"CHANGES = {SEQP!r}\n" + PLANNED)
    jobs["repro_planned"] = lambda: join(_run_repro(script, devices=1), timeout=REF_TIMEOUT)
    jobs["planned"] = lambda: run_ranks("long_planned", 2, d,
                                        {"arch": PLANNED_ARCH, "heads": SEQP, "mesh": "1x2"},
                                        timeout=TIMEOUT)
    return base, run_all(jobs)


def _part(results, key: str):
    """(``repro``'s results, the port's) of one mesh, or of "planned"."""
    base, errors = results
    for k in (f"repro_{key}", key):
        if errors[k] is not None:
            raise errors[k]
    d = base / key
    got = (dict(np.load(d / f"long_{key}.npz")) if key in MESHES
           else [dict(np.load(d / f"planned_rank{r}.npz")) for r in (0, 1)])
    return dict(np.load(d / "repro.npz")), got


def _scaled_close(got, want, tol=SERVE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1e-30, np.abs(want).max()), err


def _caches(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


CASES = [(mesh, tag) for mesh in MESHES for tag in PARTS]


@pytest.mark.parametrize("mesh,tag", CASES)
def test_prefill_and_greedy_decodes_equal_repro_on_the_same_mesh(results, mesh, tag):
    want, got = _part(results, mesh)
    np.testing.assert_array_equal(got[f"{tag}.greedy"], want[f"{tag}.greedy"])
    for step in ("prefill", "decode"):
        _scaled_close(got[f"{tag}.{step}.logits"], want[f"{tag}.{step}.logits"])
    caches = _caches(want, f"{tag}.prefill.cache.")
    assert sorted(caches) == sorted(_caches(got, f"{tag}.prefill.cache."))
    for name, w in caches.items():
        if name in ("k", "v"):
            assert w.shape[2] == LONG_MAX_SEQ
        _scaled_close(got[f"{tag}.prefill.cache.{name}"], w)


@pytest.mark.parametrize("mesh,tag", CASES)
def test_decode_past_max_seq_clamps_its_write_as_repro(results, mesh, tag):
    """A decode at 35 of a 32-position cache: the write's start clamps to
    31 for the whole sequence, which lies in the last rank's piece."""
    want, got = _part(results, mesh)
    _scaled_close(got[f"{tag}.clamp.logits"], want[f"{tag}.clamp.logits"])
    for name, w in _caches(want, f"{tag}.clamp.cache.").items():
        _scaled_close(got[f"{tag}.clamp.cache.{name}"], w)
    k = want[f"{tag}.clamp.cache.k"]
    assert np.abs(k[:, :, LONG_MAX_SEQ - 1]).max() > 0


@pytest.mark.parametrize("mesh,tag", CASES)
def test_bucket_prefill_and_slot_decode_equal_one_device(results, mesh, tag):
    _, got = _part(results, mesh)
    steps = ["slot"] if tag == "encdec" else ["bucket", "slot"]
    for step in steps:
        prefix = f"{tag}.{step}."
        want = {k[len(f"{tag}.alone.{step}."):]: v for k, v in got.items()
                if k.startswith(f"{tag}.alone.{step}.")}
        assert want and sorted(want) == sorted(k[len(prefix):] for k in got
                                               if k.startswith(prefix))
        for name, w in want.items():
            _scaled_close(got[prefix + name], w)


def test_gemma3_window_leaves_the_first_rank_without_a_visible_key():
    """At the decodes past position 24 a window of 8 lies wholly in the
    second half of a 32-position cache: the first data rank's piece adds
    exactly zero weight (what the tests above hold against ``repro``)."""
    from _torch_ranks import LONG_CLAMP, LONG_PROMPT

    window, half = PARTS["gemma3"][1]["local_window"], LONG_MAX_SEQ // 2
    for pos in (LONG_PROMPT + 3, min(LONG_CLAMP, LONG_MAX_SEQ - 1)):
        assert pos - window + 1 >= half


@pytest.mark.parametrize("q_off,n,window", [(0, 8, None), (16, 16, None), (5, 12, None),
                                            (24, 8, 6), (13, 7, 4)])
def test_flash_plain_at_an_offset_equals_repro_rows(q_off, n, window):
    import jax.numpy as jnp
    import torch
    from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain

    rng = np.random.default_rng(q_off + n)
    S, D, hq, hkv = 32, 16, 4, 2
    q = rng.standard_normal((1, hq, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, hkv, S, D)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=True,
                                        window=window))[:, :, q_off:q_off + n]
    got = flash_attention_plain(
        torch.from_numpy(q[:, :, q_off:q_off + n]).reshape(hq, n, D).contiguous(),
        torch.from_numpy(k).reshape(hkv, S, D), torch.from_numpy(v).reshape(hkv, S, D),
        block_q=n, block_kv=8, scale=D ** -0.5, causal=True, window=window, q_len=n,
        kv_len=S, q_off=q_off)
    close(got.reshape(1, hq, n, D).numpy(), want, FLASH_TOL)


def test_planned_sequence_parallel_grads_equal_jax_grad_of_repros_planned_loss(results):
    want, ranks = _part(results, "planned")
    names = sorted(k[len("grad."):] for k in want if k.startswith("grad."))
    for got in ranks:
        close(got["loss1"], want["loss1"], TOL)
        assert names == sorted(k[len("grad."):] for k in got if k.startswith("grad."))
        for k in names:
            close(got[f"grad.{k}"], want[f"grad.{k}"], TOL)


def test_planned_sequence_parallel_flash_runs_at_each_ranks_offset(results):
    """Each rank's flash calls (one a layer) take its 16 query rows at
    offset rank * 16."""
    from repro_torch.configs import smoke_config

    _, ranks = _part(results, "planned")
    layers = smoke_config(PLANNED_ARCH).n_layers
    for r, got in enumerate(ranks):
        assert got["offsets"].tolist() == [16 * r]
        assert int(got["flash_calls"]) == layers


@pytest.mark.parametrize("machine", ["MANTICORE", "TPU_V5E"])
def test_attention_planner_at_a_ranks_shapes_equals_repro(machine):
    """The planned step's attention cell on a model axis of 2 where 3 query
    heads do not split: S / 2 query rows against S keys, the whole heads,
    through ``plan_training``'s ``seq_q`` and ``TransformerBlockPlanner``
    alike; each pick field for field against ``repro``'s AttentionPlanner
    at those shapes."""
    from repro.core import machine as jm
    from repro.plan import planners as jp

    from repro_torch.configs import smoke_config
    from repro_torch.core import machine as tm
    from repro_torch.models import transformer as tf
    from repro_torch.plan import planners as tp

    cfg = dataclasses.replace(smoke_config(PLANNED_ARCH), **SEQP)
    jmach, tmach = getattr(jm, machine), getattr(tm, machine)
    for seq in (32, 2048):
        shape = dict(seq_q=seq // 2, seq_kv=seq, head_dim=cfg.resolved_head_dim,
                     n_q_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, batch=4, in_bytes=4,
                     causal=True)
        want = jp.AttentionPlanner(jmach).plan(**shape)
        got = tp.AttentionPlanner(tmach).plan(**shape)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        cells = tp.TransformerBlockPlanner(tmach).cell_planners(
            batch=4, seq=seq, d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim, seq_q=seq // 2)
        planner, kw = cells["attn"]
        assert dataclasses.asdict(planner.plan(**kw)) == dataclasses.asdict(want)
        plan = tf.plan_training(cfg, 4, seq, loss_chunks=4, machine=tmach, seq_q=seq // 2)
        assert dataclasses.asdict(plan["attn"]) == dataclasses.asdict(want)
