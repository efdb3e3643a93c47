"""Per-cell diagnosis for the perf loop: per-op FLOPs/bytes attribution and
the largest collective calls with their shapes.

    PYTHONPATH=src python -m repro_torch.launch.diagnose gemma3-4b prefill_32k

The cell is traced on ``meta`` as the dry run traces it
(``launch/dryrun.py``: rank 0 of a fake group of 256, or 512 with
``--multi-pod``); the time terms divide by the H100's peaks.
"""

from __future__ import annotations

import sys


def report(cell, rec, mesh: str, machine=None) -> list[str]:
    """The diagnosis of one traced cell, as lines."""
    from repro_torch.core.machine import H100

    m = machine or H100
    c = rec.cost
    coll = sum(c.coll.values())
    lines = [
        f"== {cell.arch} {cell.shape} ({mesh}) per-device ==",
        f"flops {c.flops:.3e}  bytes {c.bytes:.3e}  coll {coll:.3e}",
        f"t_compute {c.flops / m.peak_flops:.2f}s  t_memory {c.bytes / m.main_mem_bw:.2f}s  "
        f"t_coll {coll / m.link_bw:.2f}s  ({m.name})",
        "-- by op (top bytes) --",
    ]
    for op, (f, b) in sorted(c.by_op.items(), key=lambda kv: -kv[1][1])[:10]:
        lines.append(f"  {op:22s} flops={f:.3e} bytes={b:.3e}")
    lines.append("-- by collective --")
    for k, v in sorted(c.coll.items(), key=lambda kv: -kv[1]):
        if v:
            lines.append(f"  {k:22s} {v:.3e}")
    lines.append("-- largest collective calls (shapes) --")
    seen: dict = {}
    for op, shape, dtype, b in rec.collective_calls:
        key = (op, f"{dtype.replace('torch.', '')}{list(shape)}")
        seen[key] = (seen.get(key, (0, 0))[0] + 1, b)
    for (op, shp), (n, b) in sorted(seen.items(), key=lambda kv: -kv[1][1])[:12]:
        lines.append(f"  {op:20s} x{n:3d}  {b / 1e6:9.1f}MB  {shp}")
    mem = rec.memory
    lines.append(f"-- memory: args {mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
                 f"out {mem['output_size_in_bytes'] / 2**30:.2f}GiB "
                 f"temp {mem['temp_size_in_bytes'] / 2**30:.2f}GiB")
    return lines


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    arch, shape = argv[0], argv[1]
    multi = "--multi-pod" in argv
    from repro_torch.analysis import hlo_cost
    from repro_torch.launch.dryrun import fake_group, mesh_name
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.specs import build_cell

    with fake_group(512 if multi else 256):
        cell = build_cell(arch, shape, make_ctx(multi_pod=multi))
        _, rec = hlo_cost.trace(cell.step_fn, *cell.args)
        print("\n".join(report(cell, rec, mesh_name(multi))))


if __name__ == "__main__":
    main()
