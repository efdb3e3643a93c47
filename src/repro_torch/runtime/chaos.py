"""Deterministic, seeded fault injection for the elastic training loop.

Production failure modes the Manticore many-cluster story must survive —
a host dying mid-run, a straggling cluster, a checkpoint chunk torn by a
mid-write death, a non-finite loss — injected on a fixed schedule so the
recovery state machine (runtime/train.py ``run_elastic``) can be tested
end to end and *reproducibly*: the same ``ChaosConfig`` (spec + seed)
always injects the same faults at the same steps, which is what lets the
fault smoke assert bit-for-bit recovery parity.  The module is the JAX
package's ``runtime/chaos.py`` line for line (it imports neither JAX nor
torch): the same spec, the same seeded victims, and, since the checkpoint
layout is shared byte for byte, the same torn file and bytes.  On a mesh
of ranks every rank holds its own monkey on the same config, so every rank
reaches the same verdict at the same step.

Spec grammar (``launch/train.py --chaos``), comma-separated events:

    kill@K        host death detected at step K (before the step runs)
    kill@KxH      ... H host groups die at once
    straggle@K    the step at K sleeps (watchdog fodder)
    straggle@KxS  ... for S seconds
    corrupt@K     the checkpoint committed at step K gets one chunk torn
    nan@K         the loss at step K comes back non-finite
    nan@KxN       ... for N consecutive steps

Every event fires at most once (its configured burst), so a recovered run
replaying the same step numbers is not re-killed — exactly the semantics
of a real one-off hardware failure.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """The injection schedule.  ``None`` step means "never"."""

    seed: int = 0
    kill_at_step: int | None = None
    kill_hosts: int = 1  # data-parallel host groups lost at once
    straggle_at_step: int | None = None
    straggle_seconds: float = 0.05
    corrupt_at_step: int | None = None  # tear a chunk of the ckpt saved here
    nan_at_step: int | None = None
    nan_steps: int = 1  # consecutive non-finite losses

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "ChaosConfig":
        """Parse the ``--chaos`` grammar above (``"kill@5,nan@7x3"``)."""
        kw: dict = {"seed": seed}
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            name, _, rest = tok.partition("@")
            if not rest:
                raise ValueError(f"chaos event {tok!r}: expected NAME@STEP")
            at, _, extra = rest.partition("x")
            step = int(at)
            if name == "kill":
                kw["kill_at_step"] = step
                if extra:
                    kw["kill_hosts"] = int(extra)
            elif name == "straggle":
                kw["straggle_at_step"] = step
                if extra:
                    kw["straggle_seconds"] = float(extra)
            elif name == "corrupt":
                kw["corrupt_at_step"] = step
            elif name == "nan":
                kw["nan_at_step"] = step
                if extra:
                    kw["nan_steps"] = int(extra)
            else:
                raise ValueError(
                    f"unknown chaos event {name!r} "
                    "(have kill/straggle/corrupt/nan)")
        return cls(**kw)

    def __str__(self) -> str:
        parts = []
        if self.kill_at_step is not None:
            parts.append(f"kill@{self.kill_at_step}x{self.kill_hosts}")
        if self.straggle_at_step is not None:
            parts.append(f"straggle@{self.straggle_at_step}"
                         f"x{self.straggle_seconds}")
        if self.corrupt_at_step is not None:
            parts.append(f"corrupt@{self.corrupt_at_step}")
        if self.nan_at_step is not None:
            parts.append(f"nan@{self.nan_at_step}x{self.nan_steps}")
        return ",".join(parts) or "none"


def corrupt_chunk(ckpt_dir: str, step: int, seed: int = 0) -> str:
    """Tear one chunk of a committed checkpoint step, the way a host dying
    mid-flush would: truncate the file part-way and scribble on the tail.
    The victim chunk is chosen by the seeded rng (deterministic per
    (seed, step)).  Returns the path torn."""
    import json

    step_dir = os.path.join(ckpt_dir, f"step_{step:07d}")
    with open(os.path.join(step_dir, "index.json")) as f:
        index = json.load(f)
    files = sorted(ch["file"] for meta in index["leaves"].values()
                   for ch in meta["chunks"])
    if not files:
        raise ValueError(f"step {step}: no chunks to corrupt")
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    victim = os.path.join(step_dir, files[int(rng.integers(len(files)))])
    size = os.path.getsize(victim)
    keep = max(1, size // 2)
    with open(victim, "r+b") as f:
        f.truncate(keep)
        f.seek(max(0, keep - 8))
        f.write(rng.integers(0, 256, size=8, dtype=np.uint8).tobytes())
    return victim


class ChaosMonkey:
    """Stateful runner of one ChaosConfig: the elastic loop calls the
    hooks below each step; each event fires its configured burst exactly
    once across the whole run (recoveries replay step numbers)."""

    def __init__(self, cfg: ChaosConfig, devices_per_host: int = 1):
        self.cfg = cfg
        self.devices_per_host = devices_per_host
        self._fired: set[str] = set()
        self._nan_left = cfg.nan_steps

    def on_step_start(self, step: int) -> None:
        """Straggler injection: this step runs slow."""
        c = self.cfg
        if (c.straggle_at_step == step and "straggle" not in self._fired):
            self._fired.add("straggle")
            time.sleep(c.straggle_seconds)

    def host_death(self, step: int, n_devices: int):
        """At the kill step: the dead host names and the surviving device
        count, else None.  Raising is the caller's job (the loop turns
        this into fault_tolerance.HostFailure)."""
        c = self.cfg
        if c.kill_at_step != step or "kill" in self._fired:
            return None
        self._fired.add("kill")
        dead = [f"host{n_devices // self.devices_per_host - 1 - i}"
                for i in range(c.kill_hosts)]
        survivors = n_devices - c.kill_hosts * self.devices_per_host
        if survivors <= 0:
            raise ValueError(
                f"chaos kill@{step} leaves no survivors "
                f"({c.kill_hosts} hosts x {self.devices_per_host} devices "
                f"from {n_devices})")
        return dead, survivors

    def poison_loss(self, step: int, loss: float) -> float:
        """Non-finite-loss injection for ``nan_steps`` consecutive steps."""
        c = self.cfg
        if (c.nan_at_step is not None and self._nan_left > 0
                and step >= c.nan_at_step):
            self._nan_left -= 1
            return math.nan
        return loss

    def after_save(self, ckpt_dir: str, step: int) -> str | None:
        """Corrupt-chunk injection, right after the commit of step's
        checkpoint (the torn-write window)."""
        c = self.cfg
        if c.corrupt_at_step != step or "corrupt" in self._fired:
            return None
        self._fired.add("corrupt")
        return corrupt_chunk(ckpt_dir, step, seed=c.seed)
