"""Multi-pod dry run: trace every (arch x shape) cell of the production
meshes on ``meta`` tensors and record memory/cost/roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch.json

The JAX package compiles each cell for 256 (512) forced host devices and
reads the partitioned HLO.  Here the process runs as rank 0 of a *fake*
process group of 256 (512) ranks (``torch.distributed``'s ``fake``
backend: every collective returns at once and moves nothing), builds the
cell's operands at rank 0's local shapes on ``meta``
(``launch/specs.py::build_cell``), and runs the port's own step on them
under the cost recorder (``analysis/hlo_cost.py``): nothing is computed,
allocated or launched, and no card or compiler is needed.  The group is
formed in :func:`main` and torn down after it, never at import.

Results are cached incrementally in a JSON file keyed by
``arch|shape|mesh``; re-runs skip completed cells unless ``--force``.  The
records have the JAX package's layout (``analysis/report.py`` renders
either file), with these readings: ``compile_seconds`` is the trace's
wall time, ``memory`` the recorder's argument, output and peak temporary
sizes, and ``kernel_calls`` (added) the port's kernel calls of the step.
A cell that raises is recorded ``ok: false`` with its error; the port's
stated refusals (ROADMAP queue 3 #22) are expected there.
``--cell-timeout`` bounds each cell's trace (a cell past it is recorded
``ok: false``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import time
import traceback

import torch.distributed as dist


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_group(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks, torn down on leaving."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, ctx=None, cfg=None) -> dict:
    """One cell's record, traced in the process group in force (``ctx``:
    another mesh's context, ``cfg``: another config of ``arch``)."""
    from repro_torch.analysis import hlo_cost
    from repro_torch.analysis import roofline as rl
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.specs import build_cell

    ctx = ctx if ctx is not None else make_ctx(multi_pod=multi_pod)
    chips = ctx.mesh.size
    cell = build_cell(arch, shape_name, ctx, cfg=cfg)

    t0 = time.time()
    _, rec = hlo_cost.trace(cell.step_fn, *cell.args)
    t1 = time.time()

    mem_info = rec.memory
    counts = cell.meta["counts"]
    roof = rl.from_compiled(
        rec.cost, cell.meta["kind"], counts["active"], cell.meta["tokens"], chips,
        io_bytes=mem_info["argument_size_in_bytes"] + mem_info["output_size_in_bytes"])
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(d) for d in ctx.mesh.dims),
        "chips": chips,
        "compile_seconds": round(t1 - t0, 1),
        "params_total": counts["total"],
        "params_active_body": counts["active"],
        "memory": mem_info,
        "bytes_per_device": (mem_info.get("argument_size_in_bytes", 0)
                             + mem_info.get("temp_size_in_bytes", 0)),
        "collectives": rl.collective_bytes(rec.cost),
        "kernel_calls": dict(rec.kernel_calls),
        "roofline": roof.as_dict(),
        "ok": True,
    }


class CellTimeout(Exception):
    pass


@contextlib.contextmanager
def _deadline(seconds: float | None):
    if not seconds:
        yield
        return

    def ring(signum, frame):
        raise CellTimeout(f"traced past the {seconds:g} s limit")

    old = signal.signal(signal.SIGALRM, ring)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="seconds a cell may trace before it is recorded as failed")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import ARCH_IDS, cells

    targets: list[tuple[str, str, bool]] = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        for a in archs:
            for s in (cells(a) if not args.shape else [args.shape]):
                targets.append((a, s, mp))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    for mp in meshes:
        with fake_group(512 if mp else 256):
            for arch, shape, _ in [t for t in targets if t[2] == mp]:
                key = f"{arch}|{shape}|{mesh_name(mp)}"
                if key in results and results[key].get("ok") and not args.force:
                    print(f"[skip] {key} (cached)", flush=True)
                    continue
                print(f"[run ] {key} ...", flush=True)
                try:
                    with _deadline(args.cell_timeout):
                        res = run_cell(arch, shape, mp)
                    r = res["roofline"]
                    print(
                        f"[ ok ] {key}: trace={res['compile_seconds']}s "
                        f"flops={r['flops']:.3e} hbmB={r['bytes_hbm']:.3e} "
                        f"collB={r['bytes_coll']:.3e} bound={r['bottleneck']} "
                        f"frac={r['roofline_fraction']:.3f}",
                        flush=True,
                    )
                except Exception as e:  # a failing cell is recorded
                    res = {"arch": arch, "shape": shape, "mesh": mesh_name(mp),
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"[FAIL] {key}: {res['error']}", flush=True)
                results[key] = res
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"done: {n_ok}/{len(results)} cells ok -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
