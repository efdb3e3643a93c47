"""Rank processes for the port's multi-process tests (``test_torch_sharded.py``,
``test_torch_elastic.py``, ``test_torch_token_mesh*.py``, ``test_torch_moe_mesh.py``,
``test_torch_families_mesh.py``, ``test_torch_long_mesh.py``).

Run as ``python tests/_torch_ranks.py CASE RANK WORLD OUT ARGS_JSON``: the
process joins a ``gloo`` group through a ``file://`` store under ``OUT``
(never a TCP port), runs one case on CPU tensors (or, with ``"device":
"cuda"`` in ARGS, on the card, every rank on one device) and writes its results
under ``OUT`` as ``.npz``/``.json``.  It imports ``torch`` and the port
only; the JAX references run in the test process or in their own
subprocess.  :func:`run_ranks` starts the ranks and fails on any non-zero
exit or on the timeout.  A rank that leaves an elastic run (its host
failed) tears its group down and exits 0.
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
    from repro_torch.kernels.matmul.matmul import matmul_kernel
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
    im2col = get_op("conv2d_im2col")
    for st in ("batch", "stack"):
        ss = im2col.plan_sharded(xc, fc, bc, mesh=mesh, axis="model", strategy=st,
                                 padding=1, pool=2)
        assert ss.strategy == st and ss.ici_words == 0, ss
        calls = _count_plain(matmul_kernel)
        res[f"im2col.{st}"] = _np(im2col.sharded(xc, fc, bc, schedule=ss, mesh=mesh,
                                                 padding=1, relu=True, pool=2))
        matmul_kernel.plain = calls.real
        local = ss.schedule
        res[f"im2col.{st}.calls"] = np.array(calls.blocks)
        res[f"im2col.{st}.local"] = np.array(
            [-(-8 // local.block("block_h")), local.block("block_m"), local.block("block_n"),
             local.block("block_k")])
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


class _count_plain:
    """Record each call of ``kernel``'s plain version (what a CPU tensor
    runs where the card launches the kernel) with its blocks."""

    def __init__(self, kernel):
        self.real, self.blocks = kernel.plain, []

        def plain(*tensors, **kw):
            self.blocks.append([kw["block_m"], kw["block_n"], kw["block_k"]])
            return self.real(*tensors, **kw)

        kernel.plain = plain


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


# -- the elastic runtime ------------------------------------------------------------


class _Left(Exception):
    """This rank's host failed and it left the run."""


def _save_state(path: Path, state, **extra) -> None:
    import numpy as np

    leaves = {f"params/{k}": _np(v) for k, v in state.params.items()}
    leaves.update({f"m/{k}": _np(v) for k, v in state.opt.m.items()})
    leaves.update({f"v/{k}": _np(v) for k, v in state.opt.v.items()})
    np.savez(path, step=np.array(state.opt.step), **leaves, **extra)


def case_elastic(rank: int, world: int, out: Path, args: dict) -> None:
    """``tests/test_chaos.py``'s ELASTIC_SCRIPT on 4 ranks: ``kill@5`` on a
    (data 2, model 2) mesh of the smoke CNN, the group re-formed over the
    2 survivors, a checkpoint every 2 steps; the survivors then run a clean
    2-rank run from committed step 4 on the shrunk mesh."""
    import numpy as np

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.convert import params_from_repro
    from repro_torch.data.pipeline import ShardInfo, SyntheticImageSource
    from repro_torch.launch.mesh import ElasticGroup
    from repro_torch.models import cnn
    from repro_torch.plan.sharded import validate_sharded_plan
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime import train as tr
    from repro_torch.runtime.chaos import ChaosConfig, ChaosMonkey
    from repro_torch.runtime.fault_tolerance import shrink_mesh_shape
    from repro_torch.runtime.parallel import ParallelCtx

    cfg = smoke_config("cnn-vgg11")
    batch, steps, model = 8, 8, 2
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", learning_rate=1e-3,
                       warmup_steps=1, total_steps=steps, loss_chunks=2, seed=0,
                       planned_kernels=True)
    init = dict(np.load(out / "init.npz"))
    source = SyntheticImageSource(32, 3, cfg.vocab, batch, ShardInfo(0, 1), seed=0)
    group = ElasticGroup(devices_per_host=model, timeout=float(args["timeout"]))
    d = str(out / "ckpt")
    built, logs = [], []

    def ctx_of(n):
        shape = shrink_mesh_shape(n, model=model)
        return shape, ParallelCtx(mesh=coll.Mesh(shape, ("data", "model"),
                                                 timeout=group.timeout),
                                  dp_axes=("data",), tp_axis="model")

    def build(n_devices):
        n = 4 if n_devices is None else n_devices
        if not group.shrink(n):
            raise _Left
        shape, ctx = ctx_of(n)
        ms = ctx.plan_mesh()
        splan = cnn.plan_training(cfg, batch, mesh=ms, shard_axis="data",
                                  shard_strategy="batch")
        assert validate_sharded_plan(splan, ms) == len(splan) > 0
        assert all(s.mesh.axis_size("data") == shape[0] for s in splan.values())
        state = tr.init_state(cfg, tcfg, params_from_repro(init, device="cpu"))
        group.barrier()
        start = 0
        restored, last = ckpt.restore_latest(d, state, device="cpu")
        if restored is not None:
            state, start = restored, last + 1
        built.append([n, dict(ctx.mesh.shape), start])
        save = None
        if group.rank == 0:
            def save(step, st):
                ckpt.save(d, step, st, n_chunks=4)
        return tr.ElasticRun(step_fn=tr.make_train_step(cfg, tcfg, parallel=ctx),
                             state=state, start=start, n_devices=n, save=save, ckpt_dir=d,
                             ckpt_every=2, devices_per_host=model, log_every=100,
                             agree=tr.agree_verdict, on_failure=group.on_failure)

    chaos = ChaosMonkey(ChaosConfig(kill_at_step=5, kill_hosts=1, seed=0),
                        devices_per_host=model)
    try:
        state, hist = tr.run_elastic(build, source, steps, chaos=chaos, log=logs.append)
    except _Left:
        (out / f"elastic_rank{rank}.json").write_text(json.dumps(
            {"left": True, "failed_at": group.failed_at, "dead": group.dead}))
        return
    # The clean run from the same committed step on the same shrunk mesh.
    _, ctx = ctx_of(group.world)
    ref = ckpt.restore(d, 4, tr.init_state(cfg, tcfg, params_from_repro(init, device="cpu")),
                       device="cpu")
    step_fn, ref_losses = tr.make_train_step(cfg, tcfg, parallel=ctx), []
    for i in range(5, steps):
        ref, m = step_fn(ref, tr.batch_to(source(i), "cpu"))
        ref_losses.append(float(m["loss"]))
    same = all(torch_equal(a, b) for a, b in _leaves(state, ref))
    (out / f"elastic_rank{rank}.json").write_text(json.dumps({
        "left": False, "new_rank": group.rank, "built": built,
        "steps": [h["step"] for h in hist], "losses": [h["loss"] for h in hist],
        "ref_losses": ref_losses, "same_state": same, "logs": logs}))
    _save_state(out / f"elastic_rank{rank}.npz", state)


def torch_equal(a, b) -> bool:
    import torch

    return torch.equal(a, b)


def _leaves(a, b):
    assert a.opt.step == b.opt.step
    for x, y in ((a.params, b.params), (a.opt.m, b.opt.m), (a.opt.v, b.opt.v)):
        assert x.keys() == y.keys()
        for k in x:
            yield x[k], y[k]


def case_launcher_elastic(rank: int, world: int, out: Path, args: dict) -> None:
    """The launcher's chaos run in this rank's group, from the carried
    initial parameters; the survivors then run the launcher again from a
    copy of committed step 4 alone (a clean run on the shrunk mesh)."""
    import shutil

    import numpy as np
    import torch.distributed as dist

    from repro_torch.convert import params_from_repro
    from repro_torch.launch import train as launch

    init = dict(np.load(out / "init.npz"))
    launch.init_params = lambda defs, seed, *, device=None, dtype=None: (
        params_from_repro(init, device=device))
    history = launch.main(args["argv"])
    if not dist.is_initialized():  # this rank's host failed
        (out / f"launcher_rank{rank}.json").write_text(json.dumps({"left": True}))
        return
    clean = out / "clean"
    if dist.get_rank() == 0:
        os.makedirs(clean)
        shutil.copytree(out / "ckpt" / "step_0000004", clean / "step_0000004")
    dist.barrier()
    argv = list(args["argv"])
    argv[argv.index("--ckpt") + 1] = str(clean)
    argv[argv.index("--mesh") + 1] = args["shrunk"]
    argv = argv[:argv.index("--chaos")] + argv[argv.index("--chaos") + 2:]
    ref = launch.main(argv)
    (out / f"launcher_rank{rank}.json").write_text(json.dumps({
        "left": False, "new_rank": dist.get_rank(), "steps": [h["step"] for h in history],
        "losses": [h["loss"] for h in history], "ref_steps": [h["step"] for h in ref],
        "ref_losses": [h["loss"] for h in ref]}))


def case_verdicts(rank: int, world: int, out: Path, args: dict) -> None:
    """Two verdicts that one rank reaches alone, on 2 ranks of a data
    axis (a host a rank): (a) rank 1's monitor reads a stale heartbeat of
    a host2 that rank 0's does not see; (b) rank 1's watchdog trips twice
    at straggler patience 2.  Each is agreed, so both ranks act on it at
    the same step: (a) a same-size rebuild that evicts host2's beat, (b)
    host1 evicted, rank 0 going on alone."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import ElasticGroup
    from repro_torch.runtime import train as tr
    from repro_torch.runtime.fault_tolerance import Heartbeat, Monitor

    group = ElasticGroup(devices_per_host=1, timeout=float(args["timeout"]))
    rec = {}

    class Scripted:
        def __init__(self, verdicts):
            self.verdicts = list(verdicts)

        def observe(self, dt):
            return self.verdicts.pop(0) if self.verdicts else False

    def step_fn(state, batch):
        # A collective every step: a rank that left it would hang the other.
        t = torch.ones(1)
        if group.world > 1:
            dist.all_reduce(t)
        return {"v": state["v"] + 1}, {"loss": float(t)}

    for case in ("stale", "straggle"):
        hb_dir, view = out / case / "hb", out / case / f"view{rank}"
        hb_dir.mkdir(parents=True, exist_ok=True)
        view.mkdir()
        if case == "stale" and rank == 1:  # what rank 1 alone reads
            for h, t in (("host0", time.time()), ("host1", time.time()), ("host2", 0.0)):
                (view / f"hb_{h}.json").write_text(json.dumps({"step": 0, "time": t}))
        record, logs = [], []

        def build(n_devices, case=case, hb_dir=hb_dir, view=view, record=record):
            n = 2 if n_devices is None else n_devices
            if not group.shrink(n):
                raise _Left
            record.append(n)
            for host in group.dead:  # the failed hosts' beats are evicted
                (view / f"hb_{host}.json").unlink(missing_ok=True)
            watchdog = Scripted([False, True, True] if case == "straggle" and rank == 1
                                else [])
            return tr.ElasticRun(
                step_fn=step_fn, state={"v": 0}, start=0, n_devices=n, devices_per_host=1,
                heartbeat=Heartbeat(group.host(), str(hb_dir)),
                monitor=Monitor(str(view if case == "stale" and rank == 1 else hb_dir),
                                timeout=600),
                watchdog=watchdog, agree=tr.agree_verdict, on_failure=group.on_failure,
                log_every=1)

        try:
            state, hist = tr.run_elastic(
                build, lambda step: {}, 4, log=logs.append,
                policy=tr.RecoveryPolicy(straggler_patience=2, max_recoveries=2))
            rec[case] = {"record": record, "v": state["v"], "logs": logs,
                         "steps": [h["step"] for h in hist], "world": group.world}
        except _Left:
            rec[case] = {"record": record, "left_at": group.failed_at, "dead": group.dead,
                         "logs": logs}
            break
        group.dead = []
    (out / f"verdicts_rank{rank}.json").write_text(json.dumps(rec))


# -- the token families on a mesh ----------------------------------------------------

TOKEN_ARGV = ["--device", "cpu", "--dist-backend", "gloo", "--steps", "3", "--batch", "4",
              "--seq", "32", "--log-every", "1"]


def _carry_init(launch, out: Path, name: str = "init.npz") -> None:
    """The launcher's ``init_params`` replaced by the JAX package's seeded
    weights (``name`` under ``out``)."""
    import numpy as np

    from repro_torch.convert import params_from_repro

    init = dict(np.load(out / name))
    launch.init_params = lambda defs, seed, *, device=None, dtype=None: (
        params_from_repro(init, device=device))


def _mesh_ctx(mesh: str):
    from repro_torch.launch.train import parse_mesh
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime.parallel import ParallelCtx

    dims, axes = parse_mesh(mesh)
    return ParallelCtx(mesh=coll.Mesh(dims, axes), dp_axes=axes[:-1], tp_axis="model")


def _step1(cfg, tcfg, ctx, params: dict, batch: dict) -> tuple:
    """The FSDP step's loss and gradients at ``params`` on ``batch``,
    each gradient gathered whole."""
    from repro_torch.launch.specs import fsdp_specs
    from repro_torch.models.module import abstract_params, param_specs
    from repro_torch.models.registry import get_family
    from repro_torch.runtime import parallel as par
    from repro_torch.runtime import train as tr

    defs = get_family(cfg.family).param_defs(cfg)
    specs = fsdp_specs(param_specs(defs), abstract_params(defs), ctx)
    shards = {k: par.shard_tensor(v, specs[k], ctx.mesh) for k, v in params.items()}
    loss, grads = tr.fsdp_loss_and_grads(tr.make_loss_fn(cfg, tcfg, ctx), ctx, specs, shards,
                                         tr.shard_batch(cfg, ctx, batch))
    return float(loss), {k: _np(par.gather_tensor(g, specs[k], ctx.mesh))
                         for k, g in grads.items()}


def case_tokens(rank: int, world: int, out: Path, args: dict) -> None:
    """The launcher on ``args["mesh"]`` for ``args["family"]`` from the
    carried weights, plain and (the dense family) planned: 3 losses each;
    and the FSDP step's step-1 loss and gradients."""
    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.convert import params_from_repro
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.launch import train as launch
    from repro_torch.models.registry import make_data_source
    from repro_torch.runtime import train as tr

    _carry_init(launch, out)
    family, mesh = args["family"], args["mesh"]
    res = {}
    for variant in args["variants"]:
        argv = ["--family", family, "--mesh", mesh, *TOKEN_ARGV]
        if variant == "planned":
            argv.append("--planned-kernels")
        res[f"{variant}.losses"] = np.array([h["loss"] for h in launch.main(argv)])
        cfg = smoke_config(args["arch"])
        tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                           remat="none", planned_kernels=variant == "planned")
        source = make_data_source(cfg, 4, 32, ShardInfo(0, 1), seed=0)
        params = params_from_repro(dict(np.load(out / "init.npz")), device="cpu")
        loss, grads = _step1(cfg, tcfg, _mesh_ctx(mesh), params,
                             tr.batch_to(source(0), torch.device("cpu")))
        res[f"{variant}.loss1"] = np.array(loss)
        res.update({f"{variant}.grad.{k}": g for k, g in grads.items()})
    if rank == 0:
        np.savez(out / f"tokens_{mesh}.npz", **res)


def case_seqp(rank: int, world: int, out: Path, args: dict) -> None:
    """Sequence-parallel attention on a (data 1, model 2) mesh: the
    attention op, forward and gradients, on the carried inputs; and the
    plain dense forward of a config whose query heads do not split (loss
    and every gradient of the FSDP step)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.convert import params_from_repro
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.models import attention as att
    from repro_torch.models.registry import make_data_source
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime import train as tr

    ctx = _mesh_ctx("1x2")
    data = np.load(out / "attn.npz")
    q, k, v = (torch.from_numpy(data[n]).requires_grad_(True) for n in "qkv")
    S = q.shape[1]
    pos = torch.arange(S, dtype=torch.int32)
    coll.STATS.reset()
    y = att.attention(q, k, v, q_pos=pos, k_pos=pos, causal=True, window=args["window"],
                      parallel=ctx)
    calls = dict(coll.STATS.calls)
    gq, gk, gv = torch.autograd.grad((y * torch.from_numpy(data["c"])).sum(), (q, k, v))
    res = {"y": _np(y), "gq": _np(gq), "gk": _np(gk), "gv": _np(gv),
           "fwd_gathers": np.array(calls.get("all_gather", 0)),
           "fwd_psums": np.array(calls.get("all_reduce_sum", 0))}
    res.update(_tp_blocks(ctx, args["heads"]))
    cfg = dataclasses.replace(smoke_config("qwen1.5-0.5b"), **args["heads"])
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                       remat="none")
    source = make_data_source(cfg, 4, 32, ShardInfo(0, 1), seed=0)
    params = params_from_repro(dict(np.load(out / "init_seqp.npz")), device="cpu")
    loss, grads = _step1(cfg, tcfg, ctx, params, tr.batch_to(source(0), torch.device("cpu")))
    res["loss1"] = np.array(loss)
    res.update({f"grad.{k}": g for k, g in grads.items()})
    np.savez(out / f"seqp_rank{rank}.npz", **res)


def _tp_blocks(ctx, seqp_heads: dict) -> dict:
    """``layers.apply_attention`` (head-parallel with GQA, and
    sequence-parallel) and ``layers.apply_mlp`` over the model axis against
    the same blocks whole on this rank: the largest difference of the
    output and of each gradient, over its scale."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import layers as ll
    from repro_torch.models.module import init_params

    base = smoke_config("qwen1.5-0.5b")
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.standard_normal((2, 16, base.d_model)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((2, 16, base.d_model)).astype(np.float32))
    res = {}

    def rel(a, b):
        return float((a - b).abs().max() / max(1.0, float(b.abs().max())))

    blocks = {"attn_heads": {"n_heads": 4, "n_kv_heads": 2}, "attn_seq": seqp_heads,
              "mlp": {}}
    for tag, heads in blocks.items():
        cfg = dataclasses.replace(base, **heads)
        if tag == "mlp":
            defs = {k: dataclasses.replace(d, shape=d.shape[1:], spec=d.spec[1:],
                                           fan_in_axis=0)
                    for k, d in ll.mlp_defs(cfg, 1).items()}
        else:
            defs = ll.attn_defs(cfg, 0, layers_prefix=False)
        params = init_params(defs, 3, device="cpu")
        outs = []
        for par in (None, ctx):
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            x = x0.clone().requires_grad_(True)
            if tag == "mlp":
                y = ll.apply_mlp(p, x, cfg.act, par, d_ff=cfg.d_ff)
            else:
                y, _ = ll.apply_attention(p, x, cfg, parallel=par)
            grads = torch.autograd.grad((y * c).sum(), [x, *p.values()])
            outs.append([y.detach(), *grads])
        res[f"{tag}.err"] = np.array(max(rel(a, b) for a, b in zip(outs[1], outs[0])))
        res[f"{tag}.split"] = np.array(
            ll.attention_split(cfg, 16, ctx) if tag != "mlp" else str(ll.mlp_split(cfg.d_ff,
                                                                                ctx)))
    return res


def case_token_ckpt(rank: int, world: int, out: Path, args: dict) -> None:
    """One FSDP step of the smoke dense model on a 2x2 mesh, then the
    sharded state saved (gathered whole, rank 0 writing); rank 0 also dumps
    the gathered state for the test to hold restores against."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.convert import params_from_repro
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.launch.specs import fsdp_specs
    from repro_torch.models import transformer as tf
    from repro_torch.models.module import abstract_params, param_specs
    from repro_torch.models.registry import make_data_source
    from repro_torch.optim import adamw
    from repro_torch.plan.sharded import P
    from repro_torch.runtime import parallel as par
    from repro_torch.runtime import train as tr

    cfg = smoke_config("qwen1.5-0.5b")
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                       remat="none", warmup_steps=1, total_steps=3)
    ctx = _mesh_ctx("2x2")
    defs = tf.param_defs(cfg)
    pspecs = fsdp_specs(param_specs(defs), abstract_params(defs), ctx)
    specs = tr.TrainState(params=pspecs, opt=adamw.AdamWState(step=P(), m=pspecs, v=pspecs))
    params = params_from_repro(dict(np.load(out / "init.npz")), device="cpu")
    state = tr.init_state(cfg, tcfg, {k: par.shard_tensor(v, pspecs[k], ctx.mesh)
                                      for k, v in params.items()})
    source = make_data_source(cfg, 4, 32, ShardInfo(0, 1), seed=0)
    step = tr.make_train_step(cfg, tcfg, parallel=ctx, grad_specs=pspecs)
    state, _ = step(state, tr.batch_to(source(0), torch.device("cpu")))
    whole = ckpt.gather_state(state, specs, ctx.mesh)
    if rank == 0:
        ckpt.save(str(out / "ckpt"), 0, whole, n_chunks=3)
        _save_state(out / "whole.npz", whole)
    shapes = {k: list(v.shape) for k, v in state.params.items()}
    (out / f"ckpt_rank{rank}.json").write_text(json.dumps(
        {"shapes": shapes, "specs": {k: [list(e) if isinstance(e, tuple) else e for e in s]
                                     for k, s in pspecs.items()}}))


def case_token_elastic(rank: int, world: int, out: Path, args: dict) -> None:
    """The launcher's chaos run of the smoke dense model on 2x2 (kill@3,
    6 steps, a checkpoint every 2); the survivors then run the launcher
    again on 1x2 from a copy of committed step 2 alone."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch import train as launch

    _carry_init(launch, out)
    argv = ["--family", "transformer", "--mesh", "2x2", "--device", "cpu", "--dist-backend",
            "gloo", "--steps", "6", "--batch", "4", "--seq", "32", "--log-every", "1",
            "--ckpt", str(out / "ckpt"), "--ckpt-every", "2", "--max-recoveries", "2"]
    history = launch.main(argv + ["--chaos", "kill@3"])
    if not dist.is_initialized():  # this rank's host failed
        (out / f"token_elastic_rank{rank}.json").write_text(json.dumps({"left": True}))
        return
    clean = out / "clean"
    if dist.get_rank() == 0:
        os.makedirs(clean)
        shutil.copytree(out / "ckpt" / "step_0000002", clean / "step_0000002")
    dist.barrier()
    argv[argv.index("--ckpt") + 1] = str(clean)
    argv[argv.index("--mesh") + 1] = "1x2"
    ref = launch.main(argv)
    (out / f"token_elastic_rank{rank}.json").write_text(json.dumps({
        "left": False, "new_rank": dist.get_rank(), "steps": [h["step"] for h in history],
        "losses": [h["loss"] for h in history], "ref_steps": [h["step"] for h in ref],
        "ref_losses": [h["loss"] for h in ref]}))


# -- the MoE on a mesh ---------------------------------------------------------------

SERVE_LENGTHS = [16, 9, 3, 12]  # the bucket prefill's true prompt lengths (of 16)
SERVE_MAX_SEQ = 32


def serve_inputs(cfg) -> dict:
    """The serving builders' inputs: step 0's tokens of the seeded source."""
    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.models.registry import make_data_source

    return make_data_source(cfg, 4, 32, ShardInfo(0, 1), seed=0)(0)


def serve_builders(sv, cfg, params, toks, parallel, lift=lambda x: x,
                   whole=lambda cache: cache) -> dict:
    """The four step builders on ``toks`` [4, 17+]: prefill of 16 tokens,
    a decode at 16, a bucket prefill of SERVE_LENGTHS, a slot decode at
    those lengths; each one's logits and cache (as ``whole`` gives it),
    copied to numpy as it came back (the port writes a cache in place;
    ``lift`` puts an input where the builders take it)."""
    import numpy as np

    out = {}

    def keep(tag, cache, logits):
        out[f"{tag}.logits"] = np.array(logits)
        out.update({f"{tag}.cache.{k}": np.array(v) for k, v in whole(cache).items()})
        return cache

    cache = keep("prefill", *sv.make_prefill_step(
        cfg, SERVE_MAX_SEQ, "float32", "float32", parallel=parallel)(
        params, {"tokens": lift(toks[:, :16])}))
    keep("decode", *sv.make_decode_step(cfg, "float32", parallel=parallel)(
        params, cache, lift(toks[:, 16:17]), 16))
    lengths = lift(SERVE_LENGTHS)
    cache = keep("bucket", *sv.make_bucket_prefill_step(cfg, SERVE_MAX_SEQ, parallel=parallel)(
        params, lift(toks[:, :16]), lengths))
    keep("slot", *sv.make_slot_decode_step(cfg, parallel=parallel)(
        params, cache, lift(toks[:, 16]), lengths))
    return out


def case_moe_mesh(rank: int, world: int, out: Path, args: dict) -> None:
    """A MoE config (``args["arch"]``'s smoke config with ``args["changes"]``)
    on ``args["mesh"]`` from the carried weights: the launcher's 3 losses,
    the FSDP step's step-1 loss and gradients, and the four serving step
    builders on parameters placed by their specs' model axis (each rank's
    logits whole, its cache piece with the rows and KV heads it holds)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.convert import params_from_repro
    from repro_torch.launch import train as launch
    from repro_torch.models import layers as ll
    from repro_torch.models.module import param_specs
    from repro_torch.models.registry import get_family
    from repro_torch.runtime import parallel as par
    from repro_torch.runtime import serve as sv
    from repro_torch.runtime import train as tr

    _carry_init(launch, out)
    changes, mesh = args["changes"], args["mesh"]
    real = launch.smoke_config
    launch.smoke_config = lambda arch: dataclasses.replace(real(arch), **changes)
    argv = ["--arch", args["arch"], "--smoke", "--mesh", mesh, *TOKEN_ARGV]
    res = {"losses": np.array([h["loss"] for h in launch.main(argv)])}
    cfg = dataclasses.replace(smoke_config(args["arch"]), **changes)
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                       remat="none")
    ctx = _mesh_ctx(mesh)
    params = params_from_repro(dict(np.load(out / "init.npz")), device="cpu")
    toks = serve_inputs(cfg)
    loss, grads = _step1(cfg, tcfg, ctx, params, tr.batch_to(toks, torch.device("cpu")))
    res["loss1"] = np.array(loss)
    res.update({f"grad.{k}": g for k, g in grads.items()})
    specs = param_specs(get_family(cfg.family).param_defs(cfg))
    placed = {k: par.shard_tensor(v, specs[k], ctx.mesh, axes=(ctx.tp_axis,))
              for k, v in params.items()}
    res.update(serve_builders(sv, cfg, placed, torch.from_numpy(toks["tokens"]), ctx))
    rows = ctx.batch_axes(4)
    n = ctx.mesh.axis_size(rows) if rows else 1
    i = ctx.mesh.axis_index(rows) if rows else 0
    res["rows"] = np.array([i * (4 // n), 4 // n])
    res["heads"] = np.array(ll.cache_heads(cfg, ctx))
    np.savez(out / f"moe_rank{rank}.npz", **res)


# -- the recurrent and encoder-decoder families on a mesh ----------------------------

ENCDEC_STEPS = 3


def frames_batch(cfg, step: int):
    """The encoder-decoder's training batch of ``step``: the seeded
    source's tokens and labels, and seeded frames [4, T_enc, d]."""
    import numpy as np

    from repro_torch.data.pipeline import ShardInfo
    from repro_torch.models.registry import make_data_source

    batch = make_data_source(cfg, 4, 32, ShardInfo(0, 1), seed=0)(step)
    rng = np.random.default_rng(100 + step)
    batch["frames"] = rng.standard_normal((4, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def frames_tcfg(config_cls):
    """The encoder-decoder's train config: the launcher's at 3 steps."""
    return config_cls(param_dtype="float32", compute_dtype="float32", learning_rate=3e-4,
                      warmup_steps=min(100, ENCDEC_STEPS // 10 + 1),
                      total_steps=ENCDEC_STEPS, loss_chunks=4, seed=0, remat="none")


def family_serve(sv, cfg, params, toks, frames, parallel, lift=lambda x: x,
                 whole=lambda cache: cache) -> dict:
    """:func:`serve_builders` for the encoder-decoder, whose prefill takes
    ``frames`` and which has no bucket prefill (no frames there, in either
    package): prefill of 16 tokens, a decode at 16, then a slot decode of
    token 16 at 16 on the decoded cache."""
    import numpy as np

    out = {}

    def keep(tag, cache, logits):
        out[f"{tag}.logits"] = np.array(logits)
        out.update({f"{tag}.cache.{k}": np.array(v) for k, v in whole(cache).items()})
        return cache

    cache = keep("prefill", *sv.make_prefill_step(
        cfg, SERVE_MAX_SEQ, "float32", "float32", parallel=parallel)(
        params, {"tokens": lift(toks[:, :16]), "frames": lift(frames)}))
    cache = keep("decode", *sv.make_decode_step(cfg, "float32", parallel=parallel)(
        params, cache, lift(toks[:, 16:17]), 16))
    keep("slot", *sv.make_slot_decode_step(cfg, parallel=parallel)(
        params, cache, lift(toks[:, 16]), lift(np.full(4, 16, np.int32))))
    return out


def whole_cache(cfg, cache: dict, ctx, batch: int = 4) -> dict:
    """A rank's serving cache of ``batch`` rows put together whole: its rows
    gathered over the data axes, and a KV leaf's positions over the data
    axes the batch leaves idle (the sequence-split cache); over the model
    axis its heads of RWKV-6's ``wkv`` and Mamba-2's ``ssd``, its ``x``
    channels of ``conv`` (B/C whole on every rank), and its KV heads where
    the heads split (each rank then holds an even share of them, or every
    KV head)."""
    import torch

    from repro_torch.models import layers as ll
    from repro_torch.models import mamba2
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime.serve import KV_LEAVES

    mesh, tp = ctx.mesh, ctx.tp_size
    spare = ctx.spare_dp_axes(batch)
    out = {}
    for name, t in cache.items():
        t = t.detach()
        if tp > 1:
            if name in ("wkv", "mamba/ssd"):
                t = coll._all_gather(t.contiguous(), mesh, ctx.tp_axis, 2)
            elif name == "mamba/conv":
                n = mamba2.local_dims(cfg, ctx)[0]
                x = coll._all_gather(t[..., :n].contiguous(), mesh, ctx.tp_axis, 3)
                t = torch.cat([x, t[..., n:]], -1)
            elif name in KV_LEAVES and ll.attention_split(cfg, 1, ctx, cached=True) == "heads":
                if t.shape[3] * tp == cfg.n_kv_heads:
                    t = coll._all_gather(t.contiguous(), mesh, ctx.tp_axis, 3)
                else:
                    assert t.shape[3] == cfg.n_kv_heads, "KV heads shared unevenly"
        if name in KV_LEAVES and spare:
            t = coll._all_gather(t.contiguous(), mesh, spare, 2)
        rows = ctx.batch_axes(batch)
        if rows:
            t = coll._all_gather(t.contiguous(), mesh, rows, 1)
        out[name] = t
    return out


def case_families_mesh(rank: int, world: int, out: Path, args: dict) -> None:
    """The recurrent and encoder-decoder families on ``args["mesh"]`` from
    the carried weights (``init_{tag}.npz``), each ``args["parts"]``
    entry ``[tag, arch, changes, what]``: "launcher" (3 losses),
    "grads" (the FSDP step-1 loss and every gradient, gathered whole),
    "frames" (3 steps of the FSDP train step on frames batches), "serve"
    (the step builders on parameters placed by the model axis of
    ``serve.serving_param_specs`` where ``args["serving_specs"]``, else of
    their specs, each cache gathered whole), "int8_ef" (the launcher under
    ``--grad-compression int8_ef``).  Rank 0 writes
    ``families_{mesh}.npz``."""
    import dataclasses
    import functools

    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.convert import params_from_repro
    from repro_torch.launch import train as launch
    from repro_torch.launch.specs import fsdp_specs
    from repro_torch.models.module import abstract_params, param_specs
    from repro_torch.models.registry import get_family
    from repro_torch.runtime import parallel as par
    from repro_torch.runtime import serve as sv
    from repro_torch.runtime import train as tr

    mesh = args["mesh"]
    ctx = _mesh_ctx(mesh)
    real = launch.smoke_config
    res = {}
    for tag, arch, changes, what in args["parts"]:
        cfg = dataclasses.replace(smoke_config(arch), **changes)
        init = f"init_{tag}.npz"
        params = params_from_repro(dict(np.load(out / init)), device="cpu")
        if what in ("launcher", "int8_ef"):
            _carry_init(launch, out, init)
            launch.smoke_config = lambda a, changes=changes: dataclasses.replace(real(a),
                                                                                 **changes)
            argv = ["--arch", arch, "--smoke", "--mesh", mesh, *TOKEN_ARGV]
            if what == "int8_ef":
                argv += ["--grad-compression", "int8_ef"]
            res[f"{tag}.{what}.losses"] = np.array([h["loss"] for h in launch.main(argv)])
            launch.smoke_config = real
        elif what == "grads":
            tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                               remat="none")
            batch = frames_batch(cfg, 0) if cfg.family == "encdec" else serve_inputs(cfg)
            loss, grads = _step1(cfg, tcfg, ctx, params, tr.batch_to(batch, "cpu"))
            res[f"{tag}.loss1"] = np.array(loss)
            res.update({f"{tag}.grad.{k}": g for k, g in grads.items()})
        elif what == "frames":
            tcfg = frames_tcfg(TrainConfig)
            defs = get_family(cfg.family).param_defs(cfg)
            specs = fsdp_specs(param_specs(defs), abstract_params(defs), ctx)
            state = tr.init_state(cfg, tcfg, {k: par.shard_tensor(v, specs[k], ctx.mesh)
                                              for k, v in params.items()})
            step = tr.make_train_step(cfg, tcfg, parallel=ctx, grad_specs=specs)
            losses = []
            for i in range(ENCDEC_STEPS):
                state, metrics = step(state, tr.batch_to(frames_batch(cfg, i), "cpu"))
                losses.append(float(metrics["loss"]))
            res[f"{tag}.frames.losses"] = np.array(losses)
        else:  # serve
            specs = (sv.serving_param_specs(cfg) if args.get("serving_specs")
                     else param_specs(get_family(cfg.family).param_defs(cfg)))
            placed = {k: par.shard_tensor(v, specs[k], ctx.mesh, axes=(ctx.tp_axis,))
                      for k, v in params.items()}
            toks = torch.from_numpy(serve_inputs(cfg)["tokens"])
            whole = functools.partial(whole_cache, cfg, ctx=ctx)
            if cfg.family == "encdec":
                frames = torch.from_numpy(frames_batch(cfg, 0)["frames"])
                got = family_serve(sv, cfg, placed, toks, frames, ctx, whole=whole)
            else:
                got = serve_builders(sv, cfg, placed, toks, ctx, whole=whole)
            res.update({f"{tag}.{k}": v for k, v in got.items()})
    if rank == 0:
        np.savez(out / f"families_{mesh}.npz", **res)


# -- the batch-1 decode over a sequence-split KV cache -------------------------------

LONG_MAX_SEQ = 32  # the ranks' boundary at 16 on a data axis of 2
LONG_PROMPT = 20  # crosses the boundary
LONG_DECODES = 4  # greedy, at 20..23
LONG_CLAMP = 35  # a decode past max_seq: the write's start clamps to 31
LONG_BUCKET = 24  # the bucket prefill pads the prompt to this


def long_inputs(cfg) -> dict:
    """Batch-1 inputs: seeded tokens [1, LONG_BUCKET] and (the
    encoder-decoder's) frames [1, T_enc, d]."""
    import numpy as np

    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (1, LONG_BUCKET)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((1, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def long_builders(sv, cfg, params, inputs: dict, parallel, lift=lambda x: x,
                  whole=lambda cache: cache, steps: str = "greedy") -> dict:
    """Batch 1 through the step builders.  ``steps="greedy"``: a prefill of
    LONG_PROMPT tokens at max_seq LONG_MAX_SEQ, LONG_DECODES greedy decodes
    from its argmax, then one decode at LONG_CLAMP (past max_seq: the
    write's start clamps); each one's logits, the cache (as ``whole``
    gives it) after the prefill and after the clamped decode, and the
    greedy tokens.  ``steps="slots"``: the bucket prefill of the prompt
    padded to LONG_BUCKET (the encoder-decoder, which has none, the
    prefill) and a slot decode at LONG_PROMPT."""
    import numpy as np

    out = {}

    def keep(tag, cache, logits):
        out[f"{tag}.logits"] = np.array(logits)
        out.update({f"{tag}.cache.{k}": np.array(v) for k, v in whole(cache).items()})
        return cache

    toks = inputs["tokens"]
    prompt = {"tokens": lift(toks[:, :LONG_PROMPT])}
    if "frames" in inputs:
        prompt["frames"] = lift(inputs["frames"])
    if steps == "slots":
        if cfg.family == "encdec":
            cache, _ = sv.make_prefill_step(cfg, LONG_MAX_SEQ, "float32", "float32",
                                            parallel=parallel)(params, prompt)
        else:
            cache = keep("bucket", *sv.make_bucket_prefill_step(
                cfg, LONG_MAX_SEQ, parallel=parallel)(
                params, lift(toks), lift(np.array([LONG_PROMPT], np.int32))))
        keep("slot", *sv.make_slot_decode_step(cfg, parallel=parallel)(
            params, cache, lift(toks[:, LONG_PROMPT]),
            lift(np.array([LONG_PROMPT], np.int32))))
        return out
    cache, logits = sv.make_prefill_step(cfg, LONG_MAX_SEQ, "float32", "float32",
                                         parallel=parallel)(params, prompt)
    keep("prefill", cache, logits)
    decode = sv.make_decode_step(cfg, "float32", parallel=parallel)
    greedy, steps_logits = [], []
    for i in range(LONG_DECODES + 1):
        nxt = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)
        greedy.append(nxt)
        pos = LONG_PROMPT + i if i < LONG_DECODES else LONG_CLAMP
        cache, logits = decode(params, cache, lift(nxt[:, None]), pos)
        steps_logits.append(np.array(logits))
    out["greedy"] = np.stack(greedy, 1)
    out["decode.logits"] = np.stack(steps_logits[:-1])
    keep("clamp", cache, steps_logits[-1])
    return out


def case_long_mesh(rank: int, world: int, out: Path, args: dict) -> None:
    """Batch 1 on ``args["mesh"]`` (the data axes idle: each KV cache split
    over the sequence), each ``args["parts"]`` entry ``[tag, arch,
    changes]`` from the carried weights (``init_{tag}.npz``), placed by
    the model axis of their specs: :func:`long_builders`' greedy steps
    (every cache gathered whole), and its slot steps on the mesh and on
    this rank alone (one device, the whole weights).  Rank 0 writes
    ``long_{mesh}.npz``."""
    import dataclasses
    import functools

    import numpy as np
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.convert import params_from_repro
    from repro_torch.models.module import param_specs
    from repro_torch.models.registry import get_family
    from repro_torch.runtime import parallel as par
    from repro_torch.runtime import serve as sv

    mesh = args["mesh"]
    ctx = _mesh_ctx(mesh)
    res = {}
    for tag, arch, changes in args["parts"]:
        cfg = dataclasses.replace(smoke_config(arch), **changes)
        params = params_from_repro(dict(np.load(out / f"init_{tag}.npz")), device="cpu")
        specs = param_specs(get_family(cfg.family).param_defs(cfg))
        placed = {k: par.shard_tensor(v, specs[k], ctx.mesh, axes=(ctx.tp_axis,))
                  for k, v in params.items()}
        inputs = long_inputs(cfg)
        lift = torch.as_tensor
        whole = functools.partial(whole_cache, cfg, ctx=ctx, batch=1)
        got = long_builders(sv, cfg, placed, inputs, ctx, lift=lift, whole=whole)
        got.update(long_builders(sv, cfg, placed, inputs, ctx, lift=lift, whole=whole,
                                 steps="slots"))
        alone = long_builders(sv, cfg, params, inputs, None, lift=lift, steps="slots")
        res.update({f"{tag}.{k}": v for k, v in got.items()})
        res.update({f"{tag}.alone.{k}": v for k, v in alone.items()})
    if rank == 0:
        np.savez(out / f"long_{mesh}.npz", **res)


def case_long_planned(rank: int, world: int, out: Path, args: dict) -> None:
    """The planned forward of a config whose query heads do not split over
    the model axis of ``args["mesh"]``: the FSDP step's step-1 loss and
    every gradient (the attention cell sequence-parallel on the flash
    kernel's plain version at each rank's query offset), and the flash
    launches' offsets.  Each rank writes ``planned_rank{rank}.npz``."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.convert import params_from_repro
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
    from repro_torch.runtime import train as tr

    cfg = dataclasses.replace(smoke_config(args["arch"]), **args["heads"])
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32", loss_chunks=4,
                       remat="none", planned_kernels=True)
    offsets = []
    real = flash_attention_kernel.plain

    def plain(*tensors, **kw):
        offsets.append(kw.get("q_off", 0))
        return real(*tensors, **kw)

    flash_attention_kernel.plain = plain
    params = params_from_repro(dict(np.load(out / "init.npz")), device="cpu")
    loss, grads = _step1(cfg, tcfg, _mesh_ctx(args["mesh"]), params,
                         tr.batch_to(serve_inputs(cfg), "cpu"))
    res = {"loss1": np.array(loss), "offsets": np.array(sorted(set(offsets))),
           "flash_calls": np.array(len(offsets))}
    res.update({f"grad.{k}": g for k, g in grads.items()})
    np.savez(out / f"planned_rank{rank}.npz", **res)


def case_tune_agree(rank: int, world: int, out: Path, args: dict) -> None:
    """``autotune.tune`` of multi-device matmul cells on a ("model",) mesh
    with stopwatches that disagree (rank 0's times fall candidate by
    candidate, the others' rise), through the per-device proxies and on
    the live mesh (every candidate's ``op.sharded`` run once: a
    collective); the same cell again (a cache hit), and a BucketLadder of
    the smoke MoE warmed under "tune" on the mesh.  Every rank shares one
    cache file and writes what it took."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core.machine import H100
    from repro_torch.plan import autotune as at
    from repro_torch.plan.sharded import MeshSpec, local_schedule
    from repro_torch.runtime import collectives as coll
    from repro_torch.serve.bucket import BucketLadder

    mesh = coll.Mesh((world,), ("model",))
    ms = MeshSpec((("model", world),))
    cache = at.AutotuneCache(str(out / "cache.json"))
    seen = []

    def stopwatch(fn, iters=3, warmup=1, device=None):
        del iters, warmup, device
        fn()
        seen.append(len(seen))
        return float(100 - len(seen)) if rank == 0 else float(len(seen))

    at._measure = stopwatch

    def pick(s):
        return [s.strategy, dict(local_schedule(s).blocks)]

    rec = {}
    for tag, run_mesh, shape in (("proxy", None, dict(m=16, n=64, k=32, in_bytes=4)),
                                 ("live", mesh, dict(m=32, n=64, k=32, in_bytes=4))):
        rep = at.tune("matmul", machine=H100, mesh=ms, axis="model", cache=cache,
                      run_mesh=run_mesh, device="cpu", **shape)
        again = at.tune("matmul", machine=H100, mesh=ms, axis="model", cache=cache,
                        run_mesh=run_mesh, device="cpu", **shape)
        rec[tag] = {"winner": pick(rep.schedule), "cached": [rep.cached, again.cached],
                    "again": pick(again.schedule),
                    "measured": [list(m) for m in rep.measurements]}
    cfg = dataclasses.replace(smoke_config("qwen3-moe-235b-a22b"), n_layers=1)
    ladder = BucketLadder([(2, 8)], max_seq=16, mesh=ms)
    sources = ladder.warmup(cfg, policy="tune", cache=cache, device="cpu", run_mesh=mesh)
    b = ladder.buckets[0]
    rec["ladder"] = {"plans": {k: pick(v) for k, v in sorted(ladder.plans[b].items())},
                     "sources": dict(sorted(sources[b].items())),
                     "words": [ladder.modeled_words(b, "prefill"),
                               ladder.modeled_words(b, "decode")]}
    rec["timed"] = len(seen)
    (out / f"tune_rank{rank}.json").write_text(json.dumps(rec))


def case_collective_bytes(rank: int, world: int, out: Path, args: dict) -> None:
    """psum, pmax, all-gather, reduce-scatter and ppermute of a [6, 4] f32
    under the cost recorder: each category's result bytes."""
    import torch

    from repro_torch.analysis import hlo_cost, roofline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime import collectives as coll

    mesh = make_test_mesh((world,), ("data",))
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4) + rank
    with hlo_cost.record() as rec:
        coll.psum(x, mesh, "data")
        coll.pmax(x, mesh, "data")
        coll.all_gather(x, mesh, "data", 0)
        coll.reduce_scatter(x, mesh, "data", 0)
        coll.ppermute(x, mesh, "data", [(i, (i + 1) % world) for i in range(world)])
    (out / f"coll{rank}.json").write_text(json.dumps({
        "collectives": roofline.collective_bytes(rec.cost),
        "calls": [[c, list(shape)] for c, shape, _, _ in rec.collective_calls],
        "flops": rec.cost.flops}))


CASES = {"fc": case_fc, "dp": case_dp, "launcher": case_launcher, "elastic": case_elastic,
         "launcher_elastic": case_launcher_elastic, "verdicts": case_verdicts,
         "tokens": case_tokens, "seqp": case_seqp, "token_ckpt": case_token_ckpt,
         "token_elastic": case_token_elastic, "moe_mesh": case_moe_mesh,
         "tune_agree": case_tune_agree,
         "collective_bytes": case_collective_bytes, "families_mesh": case_families_mesh,
         "long_mesh": case_long_mesh, "long_planned": case_long_planned}


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
        if dist.is_initialized():  # a rank that left an elastic run has none
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
