"""A sharded token-family state saved and restored onto other meshes, and
the launcher's elastic shrink of the dense family, on CPU ranks.

* ``token_ckpt`` (4 ranks, 2x2): one FSDP step of the smoke dense model,
  then the sharded state gathered whole and written by rank 0.  Restored
  onto 1x2 (each rank reading only the chunks its pieces overlap), 2x2 and
  1x1, the pieces put together equal the gathered state bit for bit, and
  ``repro``'s ``restore`` reads the same bits.
* ``token_elastic`` (4 ranks): ``--chaos kill@3`` on 2x2 over 6 steps with
  a checkpoint every 2; host1's ranks leave, the survivors re-form a 1x2
  mesh, restore step 2 onto it and finish.  Their tail and their final
  checkpoint equal, bit for bit, a clean 1x2 run restored from the same
  checkpoint.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_ranks import run_ranks  # noqa: E402
from test_torch_token_mesh import TIMEOUT, repro_init, run_all  # noqa: E402

ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    base = tmp_path_factory.mktemp("token_ckpt")
    init = repro_init(ARCH, "transformer")
    for part in ("ckpt", "elastic"):
        (base / part).mkdir()
        np.savez(base / part / "init.npz", **init)
    errors = run_all({
        "ckpt": lambda: run_ranks("token_ckpt", 4, base / "ckpt", timeout=TIMEOUT),
        "elastic": lambda: run_ranks("token_elastic", 4, base / "elastic", timeout=TIMEOUT),
    })
    return base, errors


def _part(results, key) -> Path:
    base, errors = results
    if errors[key] is not None:
        raise errors[key]
    return base / key


class _View:
    """One rank's view of a mesh (its shape and this rank's coordinates),
    which is all a restore reads of it."""

    def __init__(self, dims, axes, rank):
        self.shape = dict(zip(axes, dims))
        self.axis_names = axes
        self.coords = {}
        for a, n in reversed(list(zip(axes, dims))):
            self.coords[a] = rank % n
            rank //= n

    def axis_size(self, names):
        return int(np.prod([self.shape[a] for a in names]))

    def axis_index(self, names):
        i = 0
        for a in names:
            i = i * self.shape[a] + self.coords[a]
        return i


def _template_and_specs(dims):
    from repro_torch.configs import smoke_config
    from repro_torch.launch.specs import fsdp_specs
    from repro_torch.models import transformer as tf
    from repro_torch.models.module import abstract_params, param_specs
    from repro_torch.optim import adamw
    from repro_torch.plan.sharded import P
    from repro_torch.runtime import train as tr
    from repro_torch.runtime.parallel import ParallelCtx

    defs = tf.param_defs(smoke_config(ARCH))
    aparams = abstract_params(defs)
    template = tr.TrainState(params=aparams, opt=adamw.abstract_state(aparams))
    view = _View(dims, ("data", "model"), 0)
    pspecs = fsdp_specs(param_specs(defs), aparams, ParallelCtx(mesh=view))
    specs = tr.TrainState(params=pspecs, opt=adamw.AdamWState(step=P(), m=pspecs, v=pspecs))
    return template, specs


def _flat(state) -> dict:
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"m/{k}": v for k, v in state.opt.m.items()})
    out.update({f"v/{k}": v for k, v in state.opt.v.items()})
    return out


@pytest.mark.parametrize("dims", [(1, 2), (2, 2), (1, 1)], ids=["1x2", "2x2", "1x1"])
def test_sharded_checkpoint_restores_onto_a_mesh_bit_for_bit(results, dims):
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.runtime.parallel import local_index

    d = _part(results, "ckpt")
    whole = dict(np.load(d / "whole.npz"))
    template, specs = _template_and_specs(dims)
    n = int(np.prod(dims))
    pieces = [ckpt.restore(str(d / "ckpt"), 0, template, device="cpu", specs=specs,
                           mesh=_View(dims, ("data", "model"), r)) for r in range(n)]
    assert all(p.opt.step == int(whole["step"]) for p in pieces)
    flat_specs = _flat(specs)
    for name, want in whole.items():
        if name == "step":
            continue
        put = np.zeros_like(want)
        for r, p in enumerate(pieces):
            got = _flat(p)[name].numpy()
            idx = local_index(want.shape, flat_specs[name], _View(dims, ("data", "model"), r))
            assert got.shape == put[idx].shape, name
            put[idx] = got
        assert np.array_equal(put, want), name
    if dims == (2, 2):  # the ranks held exactly these shapes
        shapes = json.loads((d / "ckpt_rank0.json").read_text())["shapes"]
        assert shapes == {k: list(v.shape) for k, v in pieces[0].params.items()}


def test_sharded_checkpoint_reads_in_repro(results):
    import jax.numpy as jnp

    from repro.checkpoint import checkpoint as jckpt
    from repro.configs.base import TrainConfig
    from repro.configs.registry import smoke_config
    from repro.models import transformer as jtf
    from repro.models.module import abstract_params
    from repro.optim import adamw as jadamw
    from repro.runtime import train as jtr
    from repro_torch.convert import flatten_tree

    d = _part(results, "ckpt")
    whole = dict(np.load(d / "whole.npz"))
    aparams = abstract_params(jtf.param_defs(smoke_config(ARCH)), jnp.float32)
    astate = jtr.TrainState(params=aparams, opt=jadamw.abstract_state(aparams), err=None)
    got = jckpt.restore(str(d / "ckpt"), 0, astate)
    del TrainConfig
    assert int(got.opt.step) == int(whole["step"])
    for prefix, tree in (("params", got.params), ("m", got.opt.m), ("v", got.opt.v)):
        for k, v in flatten_tree(jax.tree.map(np.asarray, tree)).items():
            assert np.array_equal(v, whole[f"{prefix}/{k}"]), (prefix, k)


def _same_files(a: Path, b: Path) -> bool:
    return (sorted(f.name for f in a.iterdir()) == sorted(f.name for f in b.iterdir())
            and all((a / f.name).read_bytes() == (b / f.name).read_bytes()
                    for f in a.iterdir()))


@pytest.mark.parametrize("rank", range(4))
def test_chaos_kill_on_2x2_shrinks_to_1x2(results, rank):
    d = _part(results, "elastic")
    rec = json.loads((d / f"token_elastic_rank{rank}.json").read_text())
    if rank >= 2:  # host1's ranks leave the run
        assert rec == {"left": True}
        return
    assert rec["new_rank"] == rank
    assert rec["steps"] == list(range(6))
    assert rec["ref_steps"] == [3, 4, 5]
    assert rec["losses"][3:] == rec["ref_losses"]  # bit for bit
    final = "step_0000005"
    assert _same_files(d / "ckpt" / final, d / "clean" / final)
    assert torch.isfinite(torch.tensor(rec["losses"])).all()
