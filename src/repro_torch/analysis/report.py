"""Render the roofline/dry-run tables from a dry run's JSON.

    PYTHONPATH=src python -m repro_torch.analysis.report experiments/dryrun_torch.json

Several files may be named: their cells are merged (a later file's cell
replaces an earlier one's).  The records are those of
``launch/dryrun.py``, in the JAX package's layout, so either package's
file renders; in the port's, "compile s" is the trace's wall time.
"""

from __future__ import annotations

import json
import sys


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def dryrun_table(results: dict, mesh: str) -> str:
    lines = [
        "| arch | shape | compile s | bytes/device (args+temp) | HLO FLOPs | HBM bytes | collective bytes |",
        "|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        r = results[key]
        if r.get("mesh") != mesh:
            continue
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | FAIL | {r.get('error','')[:60]} | | | |")
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compile_seconds']} | "
            f"{fmt_bytes(r['bytes_per_device'])} | {rf['flops']:.3e} | "
            f"{rf['bytes_hbm']:.3e} | {rf['bytes_coll']:.3e} |"
        )
    return "\n".join(lines)


def roofline_table(results: dict, mesh: str = "16x16") -> str:
    lines = [
        "| arch | shape | t_compute s | t_memory s | t_collective s | bound | MODEL_FLOPS | useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        r = results[key]
        if not r.get("ok") or r.get("mesh") != mesh:
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['t_compute']:.3e} | "
            f"{rf['t_memory']:.3e} | {rf['t_collective']:.3e} | "
            f"**{rf['bottleneck']}** | {rf['model_flops']:.2e} | "
            f"{rf['useful_ratio']:.3f} | {rf['roofline_fraction']:.4f} |"
        )
    return "\n".join(lines)


def device_table(results: dict, mesh: str = "16x16") -> str:
    """Per device: the traced FLOPs, main-memory and collective bytes
    (the totals over ``chips``), the bound and its term, the port's kernel
    calls.  The port's own table: ``repro``'s renderer has none."""
    lines = [
        "| arch | shape | FLOPs/device | HBM bytes/device | collective bytes/device | bound s | bound by | kernel calls |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        r = results[key]
        if r.get("mesh") != mesh:
            continue
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | FAIL: {r.get('error', '')[:80]} | | | | | |")
            continue
        rf, n = r["roofline"], r["chips"]
        bound = max(rf["t_compute"], rf["t_memory"], rf["t_collective"])
        calls = ", ".join(f"{k} {v}" for k, v in sorted(r.get("kernel_calls", {}).items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['flops'] / n:.3e} | {rf['bytes_hbm'] / n:.3e} | "
            f"{rf['bytes_coll'] / n:.3e} | {bound:.3e} | {rf['bottleneck']} | {calls or 'none'} |")
    return "\n".join(lines)


def load(paths: list[str]) -> dict:
    """The cells of every file, merged in order."""
    results: dict = {}
    for path in paths:
        with open(path) as f:
            results.update(json.load(f))
    return results


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    results = load(argv or ["experiments/dryrun_torch.json"])
    print("## Dry-run (single-pod 16x16 = 256 chips)\n")
    print(dryrun_table(results, "16x16"))
    print("\n## Dry-run (multi-pod 2x16x16 = 512 chips)\n")
    print(dryrun_table(results, "2x16x16"))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(results, "16x16"))
    print("\n## Per device (single-pod)\n")
    print(device_table(results, "16x16"))


if __name__ == "__main__":
    main()
