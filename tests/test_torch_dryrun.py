"""The port's dry run against ``repro``'s: ``launch/specs.py::build_cell``
for all 34 (arch x shape) cells on the 16x16 mesh (global shapes, ``P``
specs and ``meta`` equal ``repro``'s; local shapes equal
``NamedSharding.shard_shape`` where the port places a leaf as the spec
does), ``dryrun.run_cell`` on smoke configs on a fake 2x4 group for
train and decode, ``diagnose`` on one cell, and the CLI's record layout.

``repro``'s cells are built in a subprocess with 512 forced host devices
(as ``tests/test_dryrun_small.py`` runs its mesh); the port's in a
subprocess as rank 0 of a fake process group of 256 ranks.  The in-process
tests form a fake group of 8 and tear it down.

Where the port places a leaf otherwise than ``repro``'s spec (stated in
ROADMAP queue 3), its local shape is the port's, and the test checks the
stated placement instead:

  * the cnn's parameters and moments stay whole on every rank (#4);
  * a KV cache keeps each rank's KV heads whole where ``kv_cache_spec``
    would split the head dim instead (#20); a recurrent state holds its
    heads' slice, whatever ``cache_specs``' shape rule says (#21).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_CELLS = r"""
import dataclasses, json, sys, jax
from repro.configs.registry import ARCH_IDS, cells
from repro.launch.mesh import make_ctx
from repro.launch.specs import build_cell

def keyname(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)

def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]

ctx = make_ctx()
out = {}
for arch in ARCH_IDS:
    for shape in cells(arch):
        cell = build_cell(arch, shape, ctx)
        leaves = jax.tree_util.tree_flatten_with_path(cell.args)[0]
        shards = jax.tree_util.tree_leaves(cell.in_shardings)
        rec = {}
        for (path, a), s in zip(leaves, shards):
            rec["/".join(keyname(k) for k in path)] = dict(
                shape=list(a.shape), spec=spec(s.spec), local=list(s.shard_shape(a.shape)))
        meta = {k: v for k, v in cell.meta.items() if k != "tcfg"}
        if "tcfg" in cell.meta:
            meta["tcfg"] = dataclasses.asdict(cell.meta["tcfg"])
        out[f"{arch}|{shape}"] = dict(leaves=rec, meta=meta)
json.dump(out, sys.stdout)
"""

PORT_CELLS = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs.registry import ARCH_IDS, cells
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import make_ctx
from repro_torch.launch.specs import build_cell
from repro_torch.plan.sharded import P

def flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, path + (str(k),))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from flat(getattr(tree, f.name), path + (f.name,))
    elif isinstance(tree, tuple) and not isinstance(tree, P) and not all(
            isinstance(x, int) for x in tree):  # a shape is a leaf
        for i, v in enumerate(tree):
            yield from flat(v, path + (str(i),))
    else:
        yield "/".join(path), tree

def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]

out = {}
with fake_group(256):
    ctx = make_ctx()
    for arch in ARCH_IDS:
        for shape in cells(arch):
            cell = build_cell(arch, shape, ctx)
            args = {k: v for k, v in flat(cell.args) if isinstance(v, torch.Tensor)}
            specs = dict(flat(cell.in_shardings))
            shapes = dict(flat(cell.shapes))
            rec = {k: dict(shape=list(shapes[k]), spec=spec(specs[k]), local=list(t.shape),
                           dtype=str(t.dtype), device=t.device.type)
                   for k, t in args.items()}
            meta = {k: v for k, v in cell.meta.items() if k != "tcfg"}
            if "tcfg" in cell.meta:
                meta["tcfg"] = dataclasses.asdict(cell.meta["tcfg"])
            out[f"{arch}|{shape}"] = dict(leaves=rec, meta=meta, family=cell.cfg.family)
json.dump(out, sys.stdout)
"""


def _run(script: str, env_extra: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), TF_CPP_MIN_LOG_LEVEL="2",
               OMP_NUM_THREADS="1", **env_extra)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       env=env, timeout=580)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout[-3000:]}\nSTDERR:\n{r.stderr[-3000:]}"
    return json.loads(r.stdout)


@pytest.fixture(scope="module")
def both_cells():
    """(repro's cells, the port's cells), each from its own subprocess,
    started together."""
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(2) as pool:
        jax_cells = pool.submit(_run, JAX_CELLS, {
            "XLA_FLAGS": "--xla_force_host_platform_device_count=512",
            "JAX_PLATFORMS": "cpu"})
        port_cells = pool.submit(_run, PORT_CELLS, {})
        return jax_cells.result(), port_cells.result()


def _cell_ids():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.registry import ARCH_IDS, cells

    return [f"{a}|{s}" for a in ARCH_IDS for s in cells(a)]


CELL_IDS = _cell_ids()


def _pad(spec, ndim):
    return list(spec) + [None] * (ndim - len(spec))


def test_thirty_four_cells():
    assert len(CELL_IDS) == 34


@pytest.mark.parametrize("cell", CELL_IDS)
def test_build_cell_equals_repro(both_cells, cell):
    jax_cells, port_cells = both_cells
    want, got = jax_cells[cell], port_cells[cell]
    # AdamW's step counter: a 0-d leaf in repro, a Python int in the port.
    jleaves = {k: v for k, v in want["leaves"].items() if not k.endswith("opt/step")}
    assert set(got["leaves"]) == set(jleaves)
    for path, w in jleaves.items():
        g = got["leaves"][path]
        assert g["shape"] == w["shape"], path
        assert _pad(g["spec"], len(w["shape"])) == _pad(w["spec"], len(w["shape"])), path
        assert g["device"] == "meta" and g["dtype"] in ("torch.float32", "torch.int32"), path
        if g["local"] == w["local"]:
            continue
        # the port's stated placements (module docstring)
        if got["family"] == "cnn":
            assert path.split("/")[1] in ("params", "opt") and g["local"] == g["shape"], path
        else:
            leaf = path.split("/")[-1]
            assert path.startswith("1/"), path  # a cache leaf of a decode cell
            assert _port_cache_piece(cell, leaf, w, g), (path, w, g)
    jmeta, meta = want["meta"], got["meta"]
    assert meta["counts"] == jmeta["counts"]
    assert (meta["kind"], meta["tokens"]) == (jmeta["kind"], jmeta["tokens"])
    if "tcfg" in jmeta:
        jt, t = jmeta["tcfg"], meta["tcfg"]
        for k in t:
            if k == "compute_dtype":
                continue  # the port computes f32 (ROADMAP queue 3 #3)
            assert t[k] == jt[k], k
        assert set(jt) - set(t) == {"zero1"}
    else:
        assert "tcfg" not in meta


def _port_cache_piece(cell, leaf, want, got) -> bool:
    """A decode cache leaf the port places otherwise than ``cache_specs``:
    the same rows and positions as the spec's piece, with the KV heads (or
    a recurrent state's heads) whole or split over ``model`` by the port's
    own rule (ROADMAP queue 3 #20-#21)."""
    shape, wl, gl = want["shape"], want["local"], got["local"]
    if len(shape) != len(gl):
        return False
    # the batch dim and, for a KV leaf, the sequence dim are the spec's
    same_rows = gl[1] == wl[1] if len(shape) > 1 else True
    if leaf in ("k", "v", "xk", "xv"):
        same_rows = same_rows and gl[2] == wl[2]
        heads, dh = shape[3], shape[4]
        return same_rows and gl[4] == dh and heads % gl[3] == 0
    return same_rows and all(s % g == 0 for s, g in zip(shape, gl))


# -- run_cell and diagnose on a fake 2x4 group ---------------------------------------------


SMALL = {"train": ("train_4k", "train", 64, 16), "decode": ("decode_32k", "decode", 64, 8),
         "long": ("long_500k", "decode", 128, 1)}


@pytest.fixture
def group2x4(monkeypatch):
    """A fake group of 8 ranks, the smoke shapes cut to CPU size; torn
    down after the test."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_ctx, make_test_mesh

    small = {v[0]: ShapeConfig(*v) for v in SMALL.values()}
    monkeypatch.setattr(specs, "get_shape", lambda name: small[name])
    with dryrun.fake_group(8):
        yield make_ctx(make_test_mesh((2, 4)))


RECORD_KEYS = {"arch", "shape", "mesh", "chips", "compile_seconds", "params_total",
               "params_active_body", "memory", "bytes_per_device", "collectives",
               "roofline", "ok"}


@pytest.mark.parametrize("arch,kind", [("qwen1.5-0.5b", "train"), ("qwen1.5-0.5b", "decode"),
                                       ("gemma3-4b", "long"), ("cnn-vgg11", "train")])
def test_run_cell_on_a_fake_2x4_group(group2x4, arch, kind):
    """``repro``'s record layout (plus ``kernel_calls``); the roofline
    terms are ``from_compiled`` of the traced cost; the collectives are
    the step's: FSDP's gathers and reduce-scatters and the gradient psum
    in training, the weights' gathers and the TP psums in a decode."""
    from repro_torch.analysis import hlo_cost
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import dryrun

    shape = SMALL[kind][0]
    rec = dryrun.run_cell(arch, shape, False, ctx=group2x4, cfg=smoke_config(arch))
    assert set(rec) == RECORD_KEYS | {"kernel_calls"}
    assert rec["ok"] and rec["mesh"] == "2x4" and rec["chips"] == 8
    assert rec["kernel_calls"] == {}  # the plain path: no planned kernel
    rf, coll = rec["roofline"], rec["collectives"]
    assert tuple(coll) == hlo_cost.COLLECTIVES
    assert rf["bytes_coll"] == pytest.approx(8 * sum(coll.values()))
    assert rf["flops"] > 0 and rf["bytes_hbm"] > 0 and rf["chips"] == 8
    mem = rec["memory"]
    assert rec["bytes_per_device"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    if arch == "cnn-vgg11":  # replicated: one psum of the gradients, no gather
        assert coll["all-reduce"] > 0 and coll["all-gather"] == 0
    elif kind == "train":
        assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
    else:
        assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert rf["model_flops"] == rl.model_flops(
        kind if kind == "train" else "decode", rec["params_active_body"],
        (16 * 64) if kind == "train" else SMALL[kind][3])


def test_run_cell_counts_the_same_step_twice(group2x4):
    """Two traces of one cell give the same cost, to the byte."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import dryrun

    a, b = (dryrun.run_cell("zamba2-1.2b", "decode_32k", False, ctx=group2x4,
                            cfg=smoke_config("zamba2-1.2b")) for _ in range(2))
    assert a["roofline"] == b["roofline"] and a["collectives"] == b["collectives"]


def test_diagnose_reports_one_cell(group2x4):
    from repro_torch.analysis import hlo_cost
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import diagnose
    from repro_torch.launch.specs import build_cell

    cell = build_cell("qwen3-1.7b", "train_4k", group2x4, cfg=smoke_config("qwen3-1.7b"))
    _, rec = hlo_cost.trace(cell.step_fn, *cell.args)
    lines = diagnose.report(cell, rec, "2x4")
    text = "\n".join(lines)
    assert lines[0] == "== qwen3-1.7b train_4k (2x4) per-device =="
    for part in ("-- by op (top bytes) --", "  dot ", "-- by collective --", "all-gather",
                 "reduce-scatter", "-- largest collective calls (shapes) --", "-- memory: args"):
        assert part in text, part
    assert f"flops {rec.cost.flops:.3e}" in lines[1]


def test_dryrun_cli_caches_and_renders(tmp_path, monkeypatch):
    """``main`` on the fake 16x16 group: a cell that raises is recorded
    ``ok: false`` with its error, a cached cell is skipped, the group is
    torn down after; ``report`` renders the file."""
    import torch.distributed as dist

    from repro_torch.analysis import report
    from repro_torch.launch import dryrun

    calls = []

    def fake_run_cell(arch, shape, multi_pod, **kw):
        calls.append((arch, shape, multi_pod, dist.get_world_size()))
        if shape == "decode_32k":
            raise NotImplementedError("refused (ROADMAP queue 3 #22)")
        return {"arch": arch, "shape": shape, "mesh": "16x16", "chips": 256,
                "compile_seconds": 1.0, "bytes_per_device": 1.0, "ok": True,
                "roofline": {"flops": 1.0, "bytes_hbm": 2.0, "bytes_coll": 3.0,
                             "t_compute": 0.1, "t_memory": 0.2, "t_collective": 0.3,
                             "bottleneck": "collective", "model_flops": 1.0,
                             "useful_ratio": 1.0, "roofline_fraction": 0.5}}

    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    out = tmp_path / "d.json"
    dryrun.main(["--arch", "qwen3-1.7b", "--out", str(out)])
    assert not dist.is_initialized()
    res = json.loads(out.read_text())
    assert [c[:2] for c in calls] == [("qwen3-1.7b", s) for s in
                                      ("train_4k", "prefill_32k", "decode_32k")]
    assert {c[3] for c in calls} == {256}
    assert res["qwen3-1.7b|decode_32k|16x16"]["ok"] is False
    assert "queue 3 #22" in res["qwen3-1.7b|decode_32k|16x16"]["error"]
    calls.clear()
    dryrun.main(["--arch", "qwen3-1.7b", "--out", str(out)])
    assert [c[1] for c in calls] == ["decode_32k"]  # the cached cells are skipped
    table = report.dryrun_table(res, "16x16")
    assert "| qwen3-1.7b | decode_32k | FAIL |" in table
    assert "| qwen3-1.7b | train_4k | 1.0 |" in table
