"""Training launcher: config -> mesh -> params -> data -> AdamW steps
through the family's loss, in the elastic loop, with checkpoints,
heartbeats, a straggler watchdog and resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch cnn-vgg11 \
        --batch 256 --steps 3 --planned-kernels
    PYTHONPATH=src python -m repro_torch.launch.train --family cnn \
        --device cpu --steps 2 --planned-kernels
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --batch 4 --seq 2048 --steps 3 --planned-kernels --remat block
    PYTHONPATH=src python -m repro_torch.launch.train --family transformer \
        --device cpu --steps 2 --planned-kernels
    PYTHONPATH=src python -m repro_torch.launch.train --family cnn \
        --device cpu --steps 4 --ckpt /tmp/run1 --ckpt-every 1
    # run the same command again after killing it: it resumes from the
    # last intact committed checkpoint.
    PYTHONPATH=src python -m repro_torch.launch.train --family cnn \
        --mesh 2x1 --device cpu --dist-backend gloo --steps 2 --planned-kernels
    PYTHONPATH=src python -m repro_torch.launch.train --family cnn \
        --mesh 2x2 --device cpu --dist-backend gloo --steps 8 --batch 8 \
        --ckpt /tmp/run2 --ckpt-every 2 --chaos kill@5
    # host1's two ranks leave at step 5; the survivors re-form a 1x2 mesh,
    # re-plan, restore step 4 and finish.
    PYTHONPATH=src python -m repro_torch.launch.train --family transformer \
        --mesh 2x2 --device cpu --dist-backend gloo --steps 3 --batch 4 --seq 32 \
        --planned-kernels
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --mesh 2x2 --dist-backend gloo --planned-kernels --batch 4 --seq 2048 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --family moe \
        --mesh 2x2 --device cpu --dist-backend gloo --steps 3 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --family zamba2 \
        --mesh 1x2 --device cpu --dist-backend gloo --steps 3 --batch 4 --seq 32

``--planned-kernels`` runs the family's planned kernels forward and
backward, every Schedule from ``plan_training`` (the cnn: the fused conv +
dgrad/wgrad + dX/dW matmul kernels; the transformer: every block GEMM and
the logits head on the matmul + dX/dW kernels, attention on the
flash-attention kernel); without it the step runs the plain PyTorch
forward under autograd.  Token families train on ``--seq``-token
sequences with the cross-entropy in ``LOSS_CHUNKS`` token chunks, as the
JAX launcher does.  ``--device`` defaults to the card; CPU runs every
kernel's plain version.  Compute is float32 at every size: the port's
kernels are f32 (the JAX launcher computes non-smoke configs in bf16).

``--remat`` (the transformer), ``--grad-compression int8_ef``,
``--autotune``/``--autotune-cache`` and ``--ckpt``/``--ckpt-every`` are the
JAX launcher's flags.  ``--microbatch`` is passed into ``TrainConfig`` as
the JAX launcher passes it, and, as there, the launcher does not split the
batch by it: a step accumulates only a batch that carries a leading
accumulation dim (``runtime.train.make_train_step``).  On start the run
resumes from the newest intact committed checkpoint under ``--ckpt``;
every ``--ckpt-every`` steps and at the end it saves one in the
background (keeping the newest 3).  The learning-rate schedule spans
``--steps``, so a resumed run matches an uninterrupted one only under the
same ``--steps``.

``--mesh DxM`` (or ``PxDxM``) trains on a mesh of ``torch.distributed``
ranks, one rank a device, axes ``(data, model)`` (``(pod, data, model)``);
every rank draws the same global batch and runs the step on its shard of
the data axes (``runtime.train``).  The cnn trains data-parallel: the
gradients are averaged with one psum, the parameters stay replicated and
the model axis replicates the step.  The token families train FSDP-style,
as the JAX launcher shards them: each rank holds its shard of the
parameters and of AdamW's moments under ``launch.specs.fsdp_specs``, the
step gathers them over the data axes and reduce-scatters the gradients;
every token family runs tensor-parallel over the model axis: the dense
family its heads, d_ff and vocab, the MoE its experts too (expert-parallel,
or each expert's d_ff split: ``models/moe.py``), RWKV-6 and Mamba-2/Zamba2
their heads (``models/rwkv6.py``, ``models/mamba2.py``).
``--grad-compression int8_ef`` compresses each rank's gradient shards at
their whole tensors' scales, its error buffers sharded like the
parameters.  The dense family's planned path with query heads that do not
split over the model axis runs its attention sequence-parallel, each rank
its slice of the queries on the flash kernel at the slice's offset.  A
checkpoint of a
sharded state is gathered whole and written by rank 0; a restore reads
each rank's piece onto whatever mesh the run has now.  The process group
comes from the environment
``torchrun`` sets, or the launcher starts the ranks itself (one process a
rank over a file store in a temporary directory: loopback only).
``--dist-backend`` names the group's backend (``nccl`` by default on the
card, ``gloo`` with ``--device cpu``); on the card each rank takes device
``rank mod device count``.  The launcher prints the JAX launcher's
``sharded plan`` line after ``validate_sharded_plan``: for the cnn the plan
its step runs (every stage's "batch" partition over the data axis), for
the dense family the unpinned plan over the data axis, as the JAX launcher
prints it (its step runs the "batch" partition at each rank's shapes).

Elastic restart (DESIGN.md Sec. 7): the steps run through
``runtime.train.run_elastic``.  On a detected host failure the loop
aborts the step, shrinks the mesh to the survivors
(``fault_tolerance.shrink_mesh_shape`` — the model/TP extent is
preserved), re-plans every ShardedSchedule against the new MeshSpec
(autotune cache-only on the degraded cell, modeled argmin on miss),
restores the last *intact* committed checkpoint, and resumes — bounded by
``--max-recoveries``.  ``--chaos "kill@5,corrupt@4,nan@7"`` injects
deterministic seeded faults to exercise exactly that path
(``runtime/chaos.py``).  Each rank runs the loop: the ranks of a failed
host leave the run (a line says so, and the process exits 0), the
survivors tear the process group down and form a new one of the survivors
over a prefix of the first group's store (``launch.mesh.ElasticGroup``),
and every verdict a rank reaches alone (a stale heartbeat, its own step
time) is agreed across the ranks before any rank acts on it.  Rank 0 alone
writes checkpoints; every rank restores after a barrier that follows its
pending write.  Every group the launcher forms times out after
``DIST_TIMEOUT`` seconds, so a rank that misses a collective fails the
others instead of hanging them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import importlib
import json
import math
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import FAMILY_DEFAULT_ARCH, TrainConfig, get_config, smoke_config
from repro_torch.data.pipeline import ShardInfo
from repro_torch.launch.specs import fsdp_specs
from repro_torch.models.module import abstract_params, count_params, init_params, param_specs
from repro_torch.optim import adamw
from repro_torch.plan.sharded import P
from repro_torch.models.registry import FAMILIES, get_family, make_data_source
from repro_torch.launch.mesh import ElasticGroup
from repro_torch.plan import autotune as at
from repro_torch.runtime import train as tr
from repro_torch.runtime.chaos import ChaosConfig, ChaosMonkey
from repro_torch.runtime.collectives import BACKENDS, Mesh
from repro_torch.runtime.fault_tolerance import (
    Heartbeat, Monitor, StragglerWatchdog, shrink_mesh_shape,
)
from repro_torch.runtime.parallel import ParallelCtx, data_axis, fit_spec, shard_tensor

# Chunks per sequence of the token families' chunked cross-entropy.
LOSS_CHUNKS = 4
# Seconds a collective of a group the launcher forms may wait (the first
# step waits for every rank's kernel builds).
DIST_TIMEOUT = 300.0


class _LeftRun(Exception):
    """This rank's host failed: it leaves the run (its group torn down)."""

    def __init__(self, group):
        super().__init__(group.dead)
        self.rank, self.step, self.dead = group.rank, group.failed_at, group.dead


def parse_mesh(spec: str):
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 3:
        return dims, ("pod", "data", "model")
    if len(dims) == 2:
        return dims, ("data", "model")
    raise ValueError(f"--mesh must be DxM or PxDxM, got {spec!r}")


def _rank_entry(rank: int, argv: list, world: int, backend: str, store_path: str,
                out_path: str) -> None:
    """One rank of a mesh the launcher started itself: join the group,
    train, and (rank 0 of the last group) write the history for the
    parent.  A rank whose host failed leaves the run and exits 0."""
    # The store outlives every group the run forms (each keyed by a prefix).
    store = dist.FileStore(store_path, -1)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    try:
        history = main(argv)
        if dist.is_initialized() and dist.get_rank() == 0:
            with open(out_path, "w") as f:
                json.dump(history, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(argv: list, world: int, backend: str) -> list[dict]:
    """Start ``world`` ranks of this launcher as processes over a
    file store and return the history of the last group's rank 0; a rank
    that fails raises here (a rank that left the run exits 0)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "history.json")
        # By module name: under ``python -m`` this module is ``__main__``,
        # which the spawned ranks cannot import by that name.
        entry = importlib.import_module("repro_torch.launch.train")._rank_entry
        mp.start_processes(entry, args=(argv, world, backend, os.path.join(tmp, "store"),
                                        out),
                           nprocs=world, start_method="spawn", join=True)
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--family", default=None, choices=sorted(FAMILIES),
                    help="train a model family's reference arch (reduced "
                         "smoke config) instead of naming an --arch")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM ranks, one a device (see the module docstring)")
    ap.add_argument("--dist-backend", default=None, choices=BACKENDS,
                    help="the process group's backend (default: nccl on the card, "
                         "gloo with --device cpu)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--planned-kernels", action="store_true",
                    help="run the family's planned kernels forward AND "
                         "backward in the train step (cnn: fused conv + "
                         "dgrad/wgrad + dX/dW matmul; transformer: GEMMs + "
                         "flash attention + dX/dW)")
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default: the card)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "block"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--autotune", default="off", choices=["off", "cache-only", "tune"],
                    help="schedule resolution policy: cached measured-time "
                         "winners override the planners' modeled argmin "
                         "('tune' additionally measures top-k candidates on "
                         "a cache miss; see repro_torch.plan.autotune)")
    ap.add_argument("--autotune-cache", default=None,
                    help="autotune winner-cache file (default: "
                         "$REPRO_AUTOTUNE_CACHE or ~/.cache/repro_torch/"
                         "autotune.json)")
    ap.add_argument("--chaos", default=None,
                    help="seeded fault injection, e.g. "
                         "'kill@5,straggle@3x0.2,corrupt@4,nan@7x3' "
                         "(runtime/chaos.py)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--max-recoveries", type=int, default=3,
                    help="consecutive elastic recoveries before giving up")
    ap.add_argument("--recovery-backoff", type=float, default=0.0,
                    help="base seconds between recoveries (doubles each)")
    ap.add_argument("--nonfinite-patience", type=int, default=3,
                    help="consecutive non-finite losses skipped before "
                         "rolling back to the last good checkpoint")
    args = ap.parse_args(argv)
    dims, axes = parse_mesh(args.mesh)
    world = math.prod(dims)
    backend = args.dist_backend or ("gloo" if args.device == "cpu" else "nccl")

    if args.arch is None:
        if args.family is None:
            ap.error("one of --arch or --family is required")
        args.arch = FAMILY_DEFAULT_ARCH[args.family]
        args.smoke = True  # family mode trains the reduced reference config
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.family is not None:
        if FAMILIES[args.family] is not FAMILIES[cfg.family]:
            ap.error(f"--family {args.family} does not match arch {args.arch} "
                     f"(family {cfg.family!r})")
        cfg = dataclasses.replace(cfg, family=args.family)
    fam = get_family(cfg.family)
    # The token families hold an FSDP-sharded state on a mesh; the cnn a
    # replicated one.
    fsdp = not hasattr(fam, "batch_shard_specs")
    if args.planned_kernels and hasattr(fam, "check_planned_heads"):
        fam.check_planned_heads(cfg, dims[-1], args.seq)  # before any rank starts
    if world > 1 and not dist.is_initialized():
        if "RANK" not in os.environ:  # start the ranks here
            return _spawn_ranks(list(argv) if argv is not None else sys.argv[1:],
                                world, backend)
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    # The ranks, and the group the elastic run re-forms over survivors.
    group = (ElasticGroup(devices_per_host=dims[-1], timeout=DIST_TIMEOUT)
             if world > 1 else None)

    def say(*a) -> None:
        if group is None or group.rank == 0:
            print(*a, flush=True)

    if args.autotune != "off" or args.autotune_cache:
        at.set_policy(args.autotune, args.autotune_cache, device=args.device)
        say(f"autotune: policy={args.autotune} "
            f"cache={at.get_cache().path} ({len(at.get_cache())} cells)")

    tcfg = TrainConfig(
        param_dtype="float32", compute_dtype="float32", learning_rate=args.lr,
        warmup_steps=min(100, args.steps // 10 + 1), total_steps=args.steps,
        loss_chunks=LOSS_CHUNKS, seed=args.seed, remat=args.remat,
        microbatch=args.microbatch, grad_compression=args.grad_compression,
        planned_kernels=args.planned_kernels,
    )
    device = torch.device(args.device)
    if world > 1 and device.type == "cuda":
        device = torch.device("cuda", group.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    defs = fam.param_defs(cfg)
    say(f"params: {count_params(defs) / 1e6:.1f}M | arch {cfg.name} "
        f"| {tcfg.compute_dtype} compute | device {device} "
        f"| planned kernels {tcfg.planned_kernels}")

    # Every rank draws the same global batch; the step takes its shard.
    source = make_data_source(cfg, args.batch, args.seq, ShardInfo(0, 1),
                              seed=tcfg.seed)

    def build(n_devices: int | None) -> tr.ElasticRun:
        """One incarnation of the run for a device count: the process group
        (re-formed over the survivors), the mesh, the re-planned sharded
        step, and the state restored from the last intact committed
        checkpoint.  ``None`` is the initial full mesh; an explicit count
        is an elastic recovery onto the survivors."""
        degraded = n_devices is not None
        n_dev = world if n_devices is None else n_devices
        info = {"n_devices": n_dev, "degraded": degraded}
        t0 = time.perf_counter()
        if world > 1:
            if not group.shrink(n_dev):
                raise _LeftRun(group)
            info["group_s"] = time.perf_counter() - t0
        shape = dims if n_dev == world else shrink_mesh_shape(
            n_dev, model=dims[-1], pod=dims[0] if len(dims) == 3 else None)
        ctx = None
        if n_dev > 1:
            ctx = ParallelCtx(mesh=Mesh(shape, axes, timeout=group.timeout),
                              dp_axes=tuple(a for a in axes if a != "model"),
                              tp_axis="model")
        if world > 1:
            say(f"mesh {dict(zip(axes, shape))} ({n_dev} devices"
                f"{', degraded' if degraded else ''})")
        if degraded and args.autotune != "off":
            # Never measure while recovering: a cache miss takes the
            # modeled argmin.
            at.set_policy(at.recovery_policy(args.autotune), device=device)
        t1 = time.perf_counter()
        if ctx is not None and hasattr(fam, "plan_training"):
            # Re-plan the step against THIS mesh (the ring/psum argmin can
            # flip at the new count).  The cnn: every stage's "batch"
            # partition over the data axis, its ici_words the gradient
            # all-reduce; the dense family: the unpinned plan.
            from repro_torch.plan.sharded import validate_sharded_plan

            tune = at.recovery_policy(args.autotune) if degraded else args.autotune
            if fsdp:
                splan = fam.plan_training(cfg, args.batch, args.seq,
                                          loss_chunks=tcfg.loss_chunks,
                                          mesh=ctx.plan_mesh(),
                                          shard_axis=ctx.dp_axes[-1], autotune=tune)
            else:
                splan = fam.plan_training(cfg, args.batch, mesh=ctx.plan_mesh(),
                                          shard_axis=data_axis(ctx), shard_strategy="batch",
                                          autotune=tune)
            validate_sharded_plan(splan, ctx.plan_mesh())
            hbm = sum(s.hbm_words for s in splan.values())
            ici = sum(s.ici_words for s in splan.values())
            say(f"sharded plan: {len(splan)} kernels | modeled step words "
                f"hbm={hbm} ici={ici}")
        pdt = getattr(torch, tcfg.param_dtype)
        specs = None  # the state's specs, where it is sharded
        if ctx is not None and fsdp:
            aparams = abstract_params(defs, pdt)
            pspecs = {k: fit_spec(s, aparams[k].shape, ctx.mesh)
                      for k, s in fsdp_specs(param_specs(defs), aparams, ctx).items()}
            specs = tr.TrainState(params=pspecs,
                                  opt=adamw.AdamWState(step=P(), m=pspecs, v=pspecs),
                                  err=pspecs if tcfg.grad_compression == "int8_ef" else None)
        if ctx is None:
            step_fn = tr.make_train_step(cfg, tcfg)
        else:
            step_fn = tr.make_train_step(cfg, tcfg, parallel=ctx,
                                         grad_specs=specs.params if specs else None)
        info["plan_s"] = time.perf_counter() - t1

        t2 = time.perf_counter()
        params = init_params(defs, tcfg.seed, device=device, dtype=pdt)
        if specs is not None:  # this rank's shards
            params = {k: shard_tensor(v, specs.params[k], ctx.mesh)
                      for k, v in params.items()}
        state = tr.init_state(cfg, tcfg, params)
        info["init_s"] = time.perf_counter() - t2
        hb_dir = os.path.join(args.ckpt, "hb") if args.ckpt else None
        if world > 1:
            if hb_dir and group.rank == 0:
                # The failed hosts are evicted: the monitor no longer
                # counts their heartbeats.
                for host in group.dead:
                    with contextlib.suppress(FileNotFoundError):
                        os.remove(os.path.join(hb_dir, f"hb_{host}.json"))
            # Rank 0 alone writes; run_elastic joined its pending write
            # before this build, so after the barrier every rank restores
            # the same newest intact step.
            group.barrier()
        t3 = time.perf_counter()
        start = 0
        if args.ckpt:
            # Resume from the newest *intact* committed step (a corrupt step
            # falls back to the one before, with a logged warning).  A
            # sharded state reads this rank's pieces on the mesh it has now.
            if specs is None:
                restored, last = ckpt.restore_latest(args.ckpt, state, device=device)
            else:
                aparams = abstract_params(defs, pdt)
                template = tr.TrainState(
                    params=aparams, opt=adamw.abstract_state(aparams),
                    err=aparams if tcfg.grad_compression == "int8_ef" else None)
                restored, last = ckpt.restore_latest(args.ckpt, template, device=device,
                                                     specs=specs, mesh=ctx.mesh)
            if restored is not None:
                state, start = restored, last + 1
                info["restored_step"] = last
                step_dir = os.path.join(args.ckpt, f"step_{last:07d}")
                info["restore_bytes"] = sum(
                    os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
                say(f"resumed from step {last} ({args.ckpt})")
        info["restore_s"] = time.perf_counter() - t3
        info.update(start=start, mesh=dict(zip(axes, shape)))

        hb = mon = save = None
        if args.ckpt:
            os.makedirs(hb_dir, exist_ok=True)
            rank = group.rank if world > 1 else 0
            hb = Heartbeat(f"host{rank // dims[-1]}", hb_dir)
            mon = Monitor(hb_dir, timeout=600)
            if rank == 0 or specs is not None:
                # Rank 0 alone writes; a sharded state is first gathered
                # whole, by every rank.

                def save(step, st):
                    # Async commit: run_elastic joins this handle before the
                    # next save / a restore / the end, so writer failures
                    # surface there; retain only touches committed step dirs
                    # (the in-flight write lives under a .tmp name).
                    if specs is not None:
                        st = ckpt.gather_state(st, specs, ctx.mesh)
                        if rank:
                            return None
                    handle = ckpt.save_async(args.ckpt, step, st,
                                             n_chunks=max(1, min(8, n_dev)))
                    ckpt.retain(args.ckpt, keep=3)
                    return handle

        writer = world == 1 or group.rank == 0  # the rank that tears a chunk under chaos
        return tr.ElasticRun(
            step_fn=step_fn, state=state, start=start, n_devices=n_dev, save=save,
            ckpt_dir=args.ckpt if writer else None,
            ckpt_every=args.ckpt_every if args.ckpt else 0,
            devices_per_host=dims[-1], heartbeat=hb, monitor=mon,
            watchdog=StragglerWatchdog(factor=3.0), log_every=args.log_every,
            agree=tr.agree_verdict if world > 1 else None,
            on_failure=group.on_failure if world > 1 else None, device=device, info=info)

    chaos = None
    if args.chaos:
        ccfg = ChaosConfig.parse(args.chaos, seed=args.chaos_seed)
        chaos = ChaosMonkey(ccfg, devices_per_host=dims[-1])
        say(f"chaos: {ccfg} (seed {ccfg.seed})")

    policy = tr.RecoveryPolicy(max_recoveries=args.max_recoveries,
                               backoff_seconds=args.recovery_backoff,
                               nonfinite_patience=args.nonfinite_patience)
    try:
        state, history = tr.run_elastic(build, source, args.steps, policy=policy,
                                        chaos=chaos, log=say)
    except _LeftRun as left:
        print(f"rank {left.rank}: killed at step {left.step} (dead hosts {left.dead}); "
              "left the run", flush=True)
        return []
    if args.ckpt:
        say(f"final checkpoint: step {args.steps - 1}")
    say(f"done: {len(history)} steps executed, final loss "
        f"{history[-1]['loss']:.4f}" if history else "done")
    return history

if __name__ == "__main__":
    main()
