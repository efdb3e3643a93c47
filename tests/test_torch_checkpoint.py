"""The port's checkpointing against the JAX package's, on the CPU: the
contract of ``tests/test_checkpoint.py`` on CPU tensors (chunk digests,
torn and missing chunks, the fallback to the previous committed step,
mismatch errors naming the leaf and both shapes, retain, async error
propagation, bf16 across chunks), and the shared on-disk layout: a
checkpoint of the smoke CNN's and the smoke transformer's TrainState
written by either package restores into the other leaf for leaf, and both
packages write the same bytes for the same state.

Tolerance: none — every comparison is bit for bit.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import cnn as jcnn
from repro.models import transformer as jtf
from repro.models.module import init_params as jax_init_params
from repro.runtime import train as jtr
from repro.runtime.chaos import corrupt_chunk
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import CheckpointCorruptError, CheckpointMismatchError
from repro_torch.convert import flatten_tree, params_from_repro
from repro_torch.optim import adamw
from repro_torch.runtime import train as tr


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def tree_eq(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


class TestIntegrity:
    def test_save_records_chunk_digests(self, tmp_path):
        path = ckpt.save(str(tmp_path), 1, {"w": _t(np.arange(12.0).reshape(6, 2))},
                         n_chunks=3)
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        chunks = index["leaves"]["w"]["chunks"]
        assert len(chunks) == 3
        assert all(len(c["sha256"]) == 64 for c in chunks)
        ckpt.verify_step(str(tmp_path), 1)  # intact -> no raise

    def test_torn_chunk_fails_verification_and_restore(self, tmp_path):
        d = str(tmp_path)
        tree = {"w": _t(np.arange(64.0).reshape(8, 8))}
        ckpt.save(d, 2, tree, n_chunks=4)
        torn = corrupt_chunk(d, 2, seed=3)
        assert os.path.exists(torn)
        with pytest.raises(CheckpointCorruptError, match="sha256"):
            ckpt.verify_step(d, 2)
        with pytest.raises(CheckpointCorruptError):
            ckpt.restore(d, 2, tree, device="cpu")

    def test_missing_chunk_is_corrupt(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, {"w": torch.ones(4, 2)}, n_chunks=2)
        step_dir = os.path.join(d, "step_0000001")
        victim = [f for f in os.listdir(step_dir) if f.endswith(".npy")][0]
        os.remove(os.path.join(step_dir, victim))
        with pytest.raises(CheckpointCorruptError, match="missing"):
            ckpt.verify_step(d, 1)

    def test_restore_latest_falls_back_to_previous_committed_step(self, tmp_path):
        d = str(tmp_path)
        for s in (1, 2, 3):
            ckpt.save(d, s, {"w": torch.full((4,), float(s))}, n_chunks=2)
        corrupt_chunk(d, 3, seed=0)
        with pytest.warns(UserWarning, match="corrupt"):
            tree, step = ckpt.restore_latest(d, {"w": torch.empty(4)}, device="cpu")
        assert step == 2
        assert torch.equal(tree["w"], torch.full((4,), 2.0))

    def test_restore_latest_no_checkpoints(self, tmp_path):
        tree, step = ckpt.restore_latest(str(tmp_path), {"w": torch.empty(1)}, device="cpu")
        assert tree is None and step is None

    def test_restore_latest_does_not_mask_mismatch(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, {"w": torch.ones(4)})
        ckpt.save(d, 2, {"w": torch.ones(4)})
        with pytest.raises(CheckpointMismatchError):
            ckpt.restore_latest(d, {"w": torch.empty(5)}, device="cpu")

    def test_mismatch_error_names_leaf_and_shapes(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, {"a": {"w": torch.ones(8, 4)}})
        with pytest.raises(CheckpointMismatchError) as ei:
            ckpt.restore(d, 1, {"a": {"w": torch.empty(8, 5)}}, device="cpu")
        msg = str(ei.value)
        assert "a/w" in msg and "(8, 4)" in msg and "(8, 5)" in msg

    def test_missing_leaf_is_mismatch(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, {"w": torch.ones(2)})
        with pytest.raises(CheckpointMismatchError, match="nope"):
            ckpt.restore(d, 1, {"nope": torch.empty(2)}, device="cpu")

    def test_pre_digest_checkpoints_still_verify(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, {"w": torch.arange(4.0)})
        idx_path = os.path.join(d, "step_0000001", "index.json")
        with open(idx_path) as f:
            index = json.load(f)
        for meta in index["leaves"].values():
            for ch in meta["chunks"]:
                ch.pop("sha256")
        with open(idx_path, "w") as f:
            json.dump(index, f)
        ckpt.verify_step(d, 1)
        out = ckpt.restore(d, 1, {"w": torch.empty(4)}, device="cpu")
        assert torch.equal(out["w"], torch.arange(4.0))

    def test_meta_tensors_serve_as_the_template(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, {"w": torch.arange(6.0).reshape(3, 2)})
        out = ckpt.restore(d, 1, {"w": torch.empty(3, 2, device="meta")}, device="cpu")
        assert torch.equal(out["w"], torch.arange(6.0).reshape(3, 2))


class TestRobustListing:
    def test_latest_step_skips_unreadable_index(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 3, {"x": torch.ones(3)})
        bad = os.path.join(d, "step_0000009")
        os.makedirs(bad)
        with open(os.path.join(bad, "COMMIT"), "w") as f:
            f.write("ok")
        with open(os.path.join(bad, "index.json"), "w") as f:
            f.write('{"step": 9, "leaves": {tru')  # torn mid-write
        assert ckpt.latest_step(d) == 3
        assert ckpt.committed_steps(d) == [3]

    def test_retain_prunes_oldest_keeps_newest(self, tmp_path):
        d = str(tmp_path)
        for s in (1, 2, 5, 8, 9):
            ckpt.save(d, s, {"x": torch.ones(2)})
        ckpt.retain(d, keep=2)
        assert ckpt.committed_steps(d) == [8, 9]
        out = ckpt.restore(d, 8, {"x": torch.empty(2)}, device="cpu")
        assert torch.equal(out["x"], torch.ones(2))


class TestAsyncSave:
    def test_join_reraises_background_failure(self, tmp_path):
        blocker = tmp_path / "ckpt"
        blocker.write_text("x")  # a FILE where the dir must go
        handle = ckpt.save_async(str(blocker), 1, {"x": torch.ones(2)})
        with pytest.raises(OSError):
            handle.join()

    def test_join_returns_path_on_success(self, tmp_path):
        d = str(tmp_path)
        handle = ckpt.save_async(d, 4, {"x": torch.arange(3)})
        assert handle.join() == os.path.join(d, "step_0000004")
        assert ckpt.latest_step(d) == 4
        assert not handle.is_alive()

    def test_save_async_copies_before_returning(self, tmp_path):
        """The host copy is taken on the caller thread: a later in-place
        write to the tensor does not reach the file."""
        x = torch.ones(1000)
        handle = ckpt.save_async(str(tmp_path), 1, {"x": x})
        x.zero_()
        handle.join()
        out = ckpt.restore(str(tmp_path), 1, {"x": torch.empty(1000)}, device="cpu")
        assert torch.equal(out["x"], torch.ones(1000))


class TestRoundTrips:
    def test_bf16_bits_view_roundtrip_multichunk(self, tmp_path):
        rng = np.random.default_rng(0)
        tree = {"w": torch.from_numpy(rng.standard_normal((9, 4)).astype(np.float32)).to(
            torch.bfloat16), "s": torch.tensor(0.5, dtype=torch.bfloat16)}
        d = str(tmp_path)
        ckpt.save(d, 1, tree, n_chunks=3)
        with open(os.path.join(d, "step_0000001", "index.json")) as f:
            index = json.load(f)
        assert index["leaves"]["w"]["bits"] is True
        assert index["leaves"]["w"]["dtype"] == "bfloat16"
        out = ckpt.restore(d, 1, tree, device="cpu")
        tree_eq(out, tree)

    def test_bf16_reads_back_in_repro(self, tmp_path):
        """The port's bf16 bits view is repro's: repro restores it."""
        rng = np.random.default_rng(1)
        w = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)).to(torch.bfloat16)
        d = str(tmp_path)
        ckpt.save(d, 1, {"w": w}, n_chunks=2)
        out = jckpt.restore(d, 1, {"w": jax.ShapeDtypeStruct((5, 3), jnp.bfloat16)})
        np.testing.assert_array_equal(np.asarray(out["w"], np.float32), w.float().numpy())

    def test_more_chunks_than_rows_degrades(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, {"w": torch.arange(2.0)}, n_chunks=8)
        out = ckpt.restore(d, 1, {"w": torch.empty(2)}, device="cpu")
        assert torch.equal(out["w"], torch.arange(2.0))

    def test_step_is_an_int32_scalar_read_back_as_int(self, tmp_path):
        d = str(tmp_path)
        state = tr.TrainState({"w": torch.ones(2)},
                              adamw.AdamWState(7, {"w": torch.zeros(2)}, {"w": torch.zeros(2)}))
        ckpt.save(d, 7, state)
        with open(os.path.join(d, "step_0000007", "index.json")) as f:
            meta = json.load(f)["leaves"]["opt/step"]
        assert meta["shape"] == [] and meta["dtype"] == "int32"
        out = ckpt.restore(d, 7, state, device="cpu")
        assert out.opt.step == 7 and isinstance(out.opt.step, int)


# -- the shared layout: the smoke CNN's and transformer's TrainState ---------------


@functools.lru_cache(maxsize=None)
def _jax_state(family: str, compression: str):
    """repro's TrainState of a smoke config after one plain AdamW step
    (nonzero moments and, under int8_ef, error buffers)."""
    if family == "cnn":
        jcfg = jax_smoke_config("cnn-vgg11")
        defs = jcnn.param_defs(jcfg)
        from repro.data.pipeline import SyntheticImageSource

        batch = SyntheticImageSource(32, 3, jcfg.vocab, 4, seed=0)(0)
    else:
        jcfg = jax_smoke_config("qwen1.5-0.5b")
        defs = jtf.param_defs(jcfg)
        from repro.data.pipeline import SyntheticSource

        batch = SyntheticSource(jcfg.vocab, 16, 2, seed=0)(0)
    kw = dict(param_dtype="float32", compute_dtype="float32", learning_rate=3e-3,
              warmup_steps=1, total_steps=3, loss_chunks=4, grad_compression=compression)
    jtc = JaxTrainConfig(**kw, remat="none")
    params = jax_init_params(defs, jax.random.PRNGKey(0))
    state = jtr.init_state(jcfg, jtc, params)
    state, _ = jax.jit(jtr.make_train_step(jcfg, jtc))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state


def _port_state(jstate, compression):
    """The same state as the port holds it: flat ``"a/b/c"`` keys, a Python
    int step."""
    def flat(tree):
        return params_from_repro(jax.tree.map(np.asarray, tree), device="cpu")

    err = flat(jstate.err) if compression == "int8_ef" else None
    return tr.TrainState(flat(jstate.params),
                         adamw.AdamWState(int(jstate.opt.step), flat(jstate.opt.m),
                                          flat(jstate.opt.v)), err)


def _abstract(jstate):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)


FAMILY_CASES = [("cnn", "none"), ("cnn", "int8_ef"), ("transformer", "none"),
                ("transformer", "int8_ef")]


@pytest.mark.parametrize("family,compression", FAMILY_CASES)
def test_repro_checkpoint_restores_into_port(tmp_path, family, compression):
    jstate = _jax_state(family, compression)
    jckpt.save(str(tmp_path), 1, jstate)
    want = _port_state(jstate, compression)
    got = ckpt.restore(str(tmp_path), 1, want, device="cpu")
    assert got.opt.step == want.opt.step == 1
    tree_eq(got.params, want.params)
    tree_eq(got.opt.m, want.opt.m)
    tree_eq(got.opt.v, want.opt.v)
    if compression == "int8_ef":
        tree_eq(got.err, want.err)
    else:
        assert got.err is None


@pytest.mark.parametrize("family,compression", FAMILY_CASES)
def test_port_checkpoint_restores_into_repro(tmp_path, family, compression):
    jstate = _jax_state(family, compression)
    ckpt.save(str(tmp_path), 1, _port_state(jstate, compression))
    got = jckpt.restore(str(tmp_path), 1, _abstract(jstate))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("family,compression", FAMILY_CASES)
def test_both_packages_write_the_same_bytes(tmp_path, family, compression):
    """The same state saved by each package: the same files, the same
    index.json and the same chunk bytes (so the same digests)."""
    jstate = _jax_state(family, compression)
    a, b = tmp_path / "repro", tmp_path / "port"
    jckpt.save(str(a), 1, jstate, n_chunks=2)
    ckpt.save(str(b), 1, _port_state(jstate, compression), n_chunks=2)
    da, db = a / "step_0000001", b / "step_0000001"
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    for name in os.listdir(da):
        assert (da / name).read_bytes() == (db / name).read_bytes(), name


def test_leaf_names_follow_the_nested_tree():
    """The port's flat keys name the leaves as repro's nested tree does."""
    jstate = _jax_state("transformer", "int8_ef")
    names = [p for p, _ in jckpt._leaf_paths(jstate)]
    assert [p for p, _ in ckpt._leaf_paths(_port_state(jstate, "int8_ef"))] == names
    assert "params/layers/attn/wq" in names and "opt/step" in names
    assert "err/layers/mlp/w_down" in names
    assert set(flatten_tree(jax.tree.map(np.asarray, jstate.params))) == {
        p[len("params/"):] for p in names if p.startswith("params/")}
