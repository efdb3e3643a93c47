"""Training launcher, single device: config -> params -> data -> AdamW
steps through the family's loss.

    PYTHONPATH=src python -m repro_torch.launch.train --arch cnn-vgg11 \
        --batch 256 --steps 3 --planned-kernels
    PYTHONPATH=src python -m repro_torch.launch.train --family cnn \
        --device cpu --steps 2 --planned-kernels
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --batch 4 --seq 2048 --steps 3 --planned-kernels
    PYTHONPATH=src python -m repro_torch.launch.train --family transformer \
        --device cpu --steps 2 --planned-kernels

``--planned-kernels`` runs the family's planned kernels forward and
backward, every Schedule from ``plan_training`` (the cnn: the fused conv +
dgrad/wgrad + dX/dW matmul kernels; the transformer: every block GEMM and
the logits head on the matmul + dX/dW kernels, attention on the
flash-attention kernel); without it the step runs the plain PyTorch
forward under autograd.  Token families train on ``--seq``-token
sequences with the cross-entropy in ``LOSS_CHUNKS`` token chunks, as the
JAX launcher does.  ``--device`` defaults to the
card; CPU runs every kernel's plain version.  Compute is float32 at every
size: the port's kernels are f32 (the JAX launcher computes non-smoke
configs in bf16).  Mesh, checkpoint, chaos and autotune flags are not
ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

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
    args = ap.parse_args(argv)

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
        loss_chunks=LOSS_CHUNKS, seed=args.seed,
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
    step_fn = tr.make_train_step(cfg, tcfg)
    source = make_data_source(cfg, args.batch, args.seq, ShardInfo(0, 1),
                              seed=tcfg.seed)

    history = []
    for step in range(args.steps):
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
    print(f"done: {len(history)} steps executed, final loss "
          f"{history[-1]['loss']:.4f}" if history else "done", flush=True)
    return history


if __name__ == "__main__":
    main()
