"""Training launcher, single device: config -> params -> data -> AdamW
steps through the family's loss, with checkpoints and resume.

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
same ``--steps``.  Mesh, chaos and heartbeat flags wait for the sharded
and elastic trainer.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import FAMILY_DEFAULT_ARCH, TrainConfig, get_config, smoke_config
from repro_torch.data.pipeline import ShardInfo
from repro_torch.models.module import count_params, init_params
from repro_torch.models.registry import FAMILIES, get_family, make_data_source
from repro_torch.runtime import train as tr

# Chunks per sequence of the token families' chunked cross-entropy.
LOSS_CHUNKS = 4


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--family", default=None, choices=sorted(FAMILIES),
                    help="train a model family's reference arch (reduced "
                         "smoke config) instead of naming an --arch")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
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

    if args.autotune != "off" or args.autotune_cache:
        from repro_torch.plan import autotune as at

        at.set_policy(args.autotune, args.autotune_cache, device=args.device)
        print(f"autotune: policy={args.autotune} "
              f"cache={at.get_cache().path} ({len(at.get_cache())} cells)", flush=True)

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
    tcfg = TrainConfig(
        param_dtype="float32", compute_dtype="float32", learning_rate=args.lr,
        warmup_steps=min(100, args.steps // 10 + 1), total_steps=args.steps,
        loss_chunks=LOSS_CHUNKS, seed=args.seed, remat=args.remat,
        microbatch=args.microbatch, grad_compression=args.grad_compression,
        planned_kernels=args.planned_kernels,
    )
    device = torch.device(args.device)
    fam = get_family(cfg.family)
    defs = fam.param_defs(cfg)
    print(f"params: {count_params(defs) / 1e6:.1f}M | arch {cfg.name} "
          f"| {tcfg.compute_dtype} compute | device {device} "
          f"| planned kernels {tcfg.planned_kernels}", flush=True)

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
            print(f"resumed from step {last} ({args.ckpt})", flush=True)
    step_fn = tr.make_train_step(cfg, tcfg)
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
                print(f"step {step}: loss {loss:.4f} | grad_norm "
                      f"{rec['grad_norm']:.4f} | lr {rec['lr']:.3e} | "
                      f"{rec['seconds'] * 1e3:.1f} ms", flush=True)
            if args.ckpt and args.ckpt_every and step and step % args.ckpt_every == 0:
                commit(step)
        if args.ckpt:
            commit(args.steps - 1)
            print(f"final checkpoint: step {args.steps - 1}", flush=True)
    finally:
        if pending is not None:
            pending.join()
    print(f"done: {len(history)} steps executed, final loss "
          f"{history[-1]['loss']:.4f}" if history else "done", flush=True)
    return history


if __name__ == "__main__":
    main()
