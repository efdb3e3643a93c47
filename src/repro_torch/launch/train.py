"""Training launcher: config -> mesh -> params -> data -> AdamW steps
through the family's loss, with checkpoints and resume.

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

``--mesh DxM`` (or ``PxDxM``) trains the cnn data-parallel on a mesh of
``torch.distributed`` ranks, one rank a device, axes ``(data, model)``
(``(pod, data, model)``): every rank draws the same global batch, runs the
planned step on its shard of the data axis, and the gradients are averaged
with one psum (``runtime.train``); parameters stay replicated, so the model
axis replicates the step.  The process group comes from the environment
``torchrun`` sets, or the launcher starts the ranks itself (one process a
rank, a ``file://`` store in a temporary directory: loopback only).
``--dist-backend`` names the group's backend (``nccl`` by default on the
card, ``gloo`` with ``--device cpu``); on the card each rank takes device
``rank mod device count``.  The launcher prints the JAX launcher's
``sharded plan`` line for the plan the step runs (every stage's "batch"
partition over the data axis), after ``validate_sharded_plan``.  A token
family on more than one device raises: its FSDP specs, sequence-parallel
attention and expert parallelism wait for ROADMAP queue 1 #5b, and
``zero1`` with them; the chaos and heartbeat flags wait for the elastic
runtime (#6).
"""

from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.models.module import count_params, init_params
from repro_torch.models.registry import FAMILIES, get_family, make_data_source
from repro_torch.runtime import train as tr
from repro_torch.runtime.collectives import BACKENDS, Mesh
from repro_torch.runtime.parallel import ParallelCtx, data_axis

# Chunks per sequence of the token families' chunked cross-entropy.
LOSS_CHUNKS = 4


def parse_mesh(spec: str):
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 3:
        return dims, ("pod", "data", "model")
    if len(dims) == 2:
        return dims, ("data", "model")
    raise ValueError(f"--mesh must be DxM or PxDxM, got {spec!r}")


def _rank_entry(rank: int, argv: list, world: int, backend: str, init_method: str,
                out_path: str) -> None:
    """One rank of a mesh the launcher started itself: join the group,
    train, and (rank 0) write the history for the parent."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        history = main(argv)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(history, f)
    finally:
        dist.destroy_process_group()


def _spawn_ranks(argv: list, world: int, backend: str) -> list[dict]:
    """Start ``world`` ranks of this launcher as processes over a
    ``file://`` store and return rank 0's history; a rank that fails
    raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "history.json")
        # By module name: under ``python -m`` this module is ``__main__``,
        # which the spawned ranks cannot import by that name.
        entry = importlib.import_module("repro_torch.launch.train")._rank_entry
        mp.start_processes(entry, args=(argv, world, backend,
                                        f"file://{os.path.join(tmp, 'store')}", out),
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
    if world > 1 and not hasattr(fam, "batch_shard_specs"):
        raise NotImplementedError(
            f"--mesh {args.mesh} for the {cfg.family!r} family: the token families on "
            "a mesh (FSDP specs, sequence-parallel attention, expert parallelism, "
            "zero1) wait for ROADMAP queue 1 #5b")
    if world > 1 and not dist.is_initialized():
        if "RANK" not in os.environ:  # start the ranks here
            return _spawn_ranks(list(argv) if argv is not None else sys.argv[1:],
                                world, backend)
        dist.init_process_group(backend, init_method="env://")
    rank = dist.get_rank() if world > 1 else 0

    def say(*a) -> None:
        if rank == 0:
            print(*a, flush=True)

    if args.autotune != "off" or args.autotune_cache:
        from repro_torch.plan import autotune as at

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
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    defs = fam.param_defs(cfg)
    say(f"params: {count_params(defs) / 1e6:.1f}M | arch {cfg.name} "
        f"| {tcfg.compute_dtype} compute | device {device} "
        f"| planned kernels {tcfg.planned_kernels}")

    ctx = None
    if world > 1:
        mesh = Mesh(dims, axes)
        ctx = ParallelCtx(mesh=mesh, dp_axes=tuple(a for a in axes if a != "model"),
                          tp_axis="model")
        say(f"mesh {mesh.shape} ({world} ranks, {backend})")
        # The plan the data-parallel step runs, against this mesh: every
        # stage's "batch" partition over the data axis, its ici_words the
        # gradient all-reduce.
        from repro_torch.plan.sharded import validate_sharded_plan

        splan = fam.plan_training(cfg, args.batch, mesh=ctx.plan_mesh(),
                                  shard_axis=data_axis(ctx), shard_strategy="batch",
                                  autotune=args.autotune)
        validate_sharded_plan(splan, ctx.plan_mesh())
        hbm = sum(s.hbm_words for s in splan.values())
        ici = sum(s.ici_words for s in splan.values())
        say(f"sharded plan: {len(splan)} kernels | modeled step words hbm={hbm} ici={ici}")

    params = init_params(defs, tcfg.seed, device=device,
                         dtype=getattr(torch, tcfg.param_dtype))
    state = tr.init_state(cfg, tcfg, params)
    start = 0
    if args.ckpt:
        # Resume from the newest *intact* committed step (a corrupt step
        # falls back to the one before, with a logged warning).
        restored, last = ckpt.restore_latest(args.ckpt, state, device=device)
        if restored is not None:
            state, start = restored, last + 1
            say(f"resumed from step {last} ({args.ckpt})")
    step_fn = (tr.make_train_step(cfg, tcfg) if ctx is None
               else tr.make_train_step(cfg, tcfg, parallel=ctx))
    # Every rank draws the same global batch; the step takes its shard.
    source = make_data_source(cfg, args.batch, args.seq, ShardInfo(0, 1),
                              seed=tcfg.seed)

    pending = None  # the in-flight background save

    def commit(at_step: int) -> None:
        # Join the previous write first, so a writer failure surfaces here;
        # retain only touches committed step dirs (the in-flight write
        # lives under a .tmp name), so pruning now is safe.
        nonlocal pending
        if pending is not None:
            pending.join()
        pending = ckpt.save_async(args.ckpt, at_step, state)
        ckpt.retain(args.ckpt, keep=3)

    history = []
    try:
        for step in range(start, args.steps):
            batch = tr.batch_to(source(step), device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # synchronizes with the device
            rec = {"step": step, "loss": loss, "lr": metrics["lr"],
                   "grad_norm": float(metrics["grad_norm"]),
                   "seconds": time.perf_counter() - t0}
            history.append(rec)
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step}: loss {loss:.4f} | grad_norm "
                    f"{rec['grad_norm']:.4f} | lr {rec['lr']:.3e} | "
                    f"{rec['seconds'] * 1e3:.1f} ms")
            # Ranks hold the same state: rank 0 alone writes checkpoints.
            if (args.ckpt and rank == 0 and args.ckpt_every and step
                    and step % args.ckpt_every == 0):
                commit(step)
        if args.ckpt and rank == 0:
            commit(args.steps - 1)
            say(f"final checkpoint: step {args.steps - 1}")
    finally:
        if pending is not None:
            pending.join()
    say(f"done: {len(history)} steps executed, final loss "
        f"{history[-1]['loss']:.4f}" if history else "done")
    return history


if __name__ == "__main__":
    main()
