"""Rank processes for the port's multi-process tests (``test_torch_sharded.py``).

Run as ``python tests/_torch_ranks.py CASE RANK WORLD OUT ARGS_JSON``: the
process joins a ``gloo`` group through a ``file://`` store under ``OUT``
(never a TCP port), runs one case on CPU tensors (or, with ``"device":
"cuda"`` in ARGS, on the card, every rank on one device) and writes its results
under ``OUT`` as ``.npz``/``.json``.  It imports ``torch`` and the port
only; the JAX references run in the test process or in their own
subprocess.  :func:`run_ranks` starts the ranks and fails on any non-zero
exit or on the timeout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_ranks(case: str, world: int, out: Path, args: dict | None = None,
              timeout: float = 120.0) -> None:
    """Start ``world`` ranks of ``case`` and wait for all of them; a rank
    that fails, or any still running at ``timeout`` seconds (then all are
    killed), fails the calling test."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(out), json.dumps(args or {})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(0.1, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{case}: a rank outlived its {timeout} s timeout") from None
    bad = [(r, p.returncode, log) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode]
    assert not bad, "\n".join(f"rank {r} exited {rc}:\n{log}" for r, rc, log in bad)


# -- the cases (rank side) ------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _device(args: dict, rank: int):
    import torch

    if args.get("device", "cpu") == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def case_fc(rank: int, world: int, out: Path, args: dict) -> None:
    """fc_layer_sharded under every strategy, ring_matmul, the conv2d op's
    batch and stack partitions and int8_psum on a ("model",) mesh."""
    import numpy as np
    import torch

    from repro_torch.core.fc_layer import fc_layer_sharded
    from repro_torch.core.ring import ring_matmul
    from repro_torch.optim.compression import int8_psum
    from repro_torch.plan import get_op
    from repro_torch.runtime import collectives as coll

    dev = _device(args, rank)
    mesh = coll.Mesh((world,), ("model",))
    res = {}
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((8, 64)).astype(np.float32)
    w0 = rng.standard_normal((64, 40)).astype(np.float32)
    for st in ("psum", "ring", "tp", "batch", None):
        x = torch.from_numpy(x0).to(dev).requires_grad_(True)
        w = torch.from_numpy(w0).to(dev).requires_grad_(True)
        coll.STATS.reset()
        y = fc_layer_sharded(x, w, mesh, axis="model", strategy=st)
        fwd_calls = dict(coll.STATS.calls)
        gx, gw = torch.autograd.grad((y ** 2).sum(), (x, w))
        tag = st or "auto"
        res[f"{tag}.y"], res[f"{tag}.gx"], res[f"{tag}.gw"] = _np(y), _np(gx), _np(gw)
        res[f"{tag}.fwd_ppermutes"] = np.array(fwd_calls.get("ppermute", 0))
        res[f"{tag}.all_ppermutes"] = np.array(coll.STATS.calls.get("ppermute", 0))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32)).to(dev)
    res["ring_matmul.y"] = _np(ring_matmul(x, w, mesh, axis="model"))
    op = get_op("conv2d")
    rng = np.random.default_rng(4)
    xc = torch.from_numpy(rng.standard_normal((8, 8, 8, 3)).astype(np.float32)).to(dev)
    fc = torch.from_numpy(rng.standard_normal((3, 3, 3, 8)).astype(np.float32)).to(dev)
    bc = torch.from_numpy(rng.standard_normal((8,)).astype(np.float32)).to(dev)
    for st in ("batch", "stack"):
        ss = op.plan_sharded(xc, fc, bc, mesh=mesh, axis="model", strategy=st,
                             padding=1, pool=2)
        assert ss.strategy == st and ss.ici_words == 0, ss
        res[f"conv.{st}"] = _np(op.sharded(xc, fc, bc, schedule=ss, mesh=mesh,
                                           padding=1, relu=True, pool=2))
    # ppermute one hop up the ring; each rank's loss weighs what it got by
    # its own c, so the gradient of what it sent is its destination's c.
    t = torch.full((3,), rank + 1.0, device=dev, requires_grad=True)
    got = coll.ppermute(t, mesh, "model", [(j, (j + 1) % world) for j in range(world)])
    (gt,) = torch.autograd.grad((got * (10.0 + rank)).sum(), (t,))
    res["ppermute.y"], res["ppermute.g"] = _np(got), _np(gt)
    half = coll.ppermute(t.detach(), mesh, "model", [(0, 1)])  # rank 0 -> 1 only
    res["ppermute.partial"] = _np(half)
    base = np.random.default_rng(6).standard_normal((5, 7)).astype(np.float32)
    res["int8.same"] = _np(int8_psum(torch.from_numpy(base).to(dev), mesh, "model"))
    mine = base * (1.0 + 0.25 * rank)
    res["int8.mine"] = _np(int8_psum(torch.from_numpy(mine).to(dev), mesh, "model"))
    np.savez(out / f"fc_rank{rank}.npz", **res)


def _ctx(world: int, shape: list):
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime.parallel import ParallelCtx

    axes = ("data",) if len(shape) == 1 else ("data", "model")
    assert len(shape) == len(axes) and world == int(__import__("math").prod(shape))
    return ParallelCtx(mesh=coll.Mesh(shape, axes), dp_axes=("data",), tp_axis="model")


def case_dp(rank: int, world: int, out: Path, args: dict) -> None:
    """3 data-parallel AdamW steps of the smoke CNN from the carried
    initial parameters on the carried batches: planned, accumulated
    (2 micro-batches) and under int8_ef."""
    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.convert import params_from_repro
    from repro_torch.runtime import train as tr

    dev = _device(args, rank)
    ctx = _ctx(world, args["mesh"])
    cfg = smoke_config("cnn-vgg11")
    init = dict(np.load(out / "init.npz"))
    data = np.load(out / "batches.npz")
    steps = int(args["steps"])
    batches = [{"images": torch.from_numpy(data[f"images{i}"]).to(dev),
                "labels": torch.from_numpy(data[f"labels{i}"]).to(dev)}
               for i in range(steps)]
    res = {}
    for variant in ("planned", "accum", "int8_ef"):
        tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                           learning_rate=3e-4, warmup_steps=1, total_steps=steps,
                           planned_kernels=True,
                           grad_compression="int8_ef" if variant == "int8_ef" else "none")
        step = tr.make_train_step(cfg, tcfg, parallel=ctx)
        state = tr.init_state(cfg, tcfg, params_from_repro(init, device=dev))
        losses = []
        for b in batches:
            if variant == "accum":
                b = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:]) for k, v in b.items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        res[f"{variant}.losses"] = np.array(losses)
        for k, v in state.params.items():
            res[f"{variant}.{k}"] = _np(v)
    np.savez(out / f"dp_rank{rank}.npz", **res)


def case_launcher(rank: int, world: int, out: Path, args: dict) -> None:
    """The launcher's mesh path in this rank's group, from the carried
    initial parameters."""
    import numpy as np

    from repro_torch.convert import params_from_repro
    from repro_torch.launch import train as launch

    init = dict(np.load(out / "init.npz"))
    launch.init_params = lambda defs, seed, *, device=None, dtype=None: (
        params_from_repro(init, device=device))
    history = launch.main(args["argv"])
    (out / f"launcher_rank{rank}.json").write_text(json.dumps([h["loss"] for h in history]))


CASES = {"fc": case_fc, "dp": case_dp, "launcher": case_launcher}


def main() -> int:
    case, rank, world, out, args = sys.argv[1:6]
    rank, world, out = int(rank), int(world), Path(out)
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{out / f'{case}.store'}",
                            rank=rank, world_size=world)
    try:
        CASES[case](rank, world, out, json.loads(args))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
