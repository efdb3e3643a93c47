"""Fault tolerance: heartbeats, straggler detection, elastic re-mesh.

Every worker sees liveness through the heartbeat files (one per host on
shared storage) and drives the restart protocol below.  The JAX package
runs it in one process; here each rank of the ``torch.distributed`` group
is a process, the ranks of a host (``rank // devices_per_host``) write its
one heartbeat, and the elastic loop agrees on each step's verdict across
the ranks before it acts (``runtime.train.run_elastic``).

Restart protocol (launch/train.py):
  1. every worker writes ``hb_<host>.json`` (step, walltime) each step;
  2. the monitor flags a host stale after ``timeout`` seconds;
  3. surviving hosts abort the step, a new mesh is built from the
     remaining host count (``shrink_mesh_shape``: the data axis shrinks,
     the model axis is preserved — TP groups must stay intact), over a
     process group re-formed from the survivors;
  4. the last committed checkpoint restores (parameters are replicated,
     so no reshard is needed), and training resumes.

Straggler mitigation: per-step wall-clock watchdog against a rolling
median; every trip is logged, and after
``RecoveryPolicy.straggler_patience`` consecutive trips the elastic loop
escalates to :class:`HostFailure` so the slow host is actually evicted
(shrink + re-plan + restore).  ``straggler_patience=0`` keeps the
report-only behavior (step skipping is never silent either way).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time


@dataclasses.dataclass
class Heartbeat:
    host: str
    dir: str

    def beat(self, step: int) -> None:
        path = os.path.join(self.dir, f"hb_{self.host}.json")
        # One temporary name a writer: the ranks of one host beat the same
        # file, and the last replace wins.
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        os.replace(tmp, path)


class HostFailure(RuntimeError):
    """A host (data-parallel group) died mid-run.  The elastic loop
    (runtime/train.py run_elastic) catches this, shrinks the mesh to the
    survivors, re-plans every ShardedSchedule, and restores the last
    committed checkpoint with the new shardings."""

    def __init__(self, dead: list[str], survivors: int):
        super().__init__(f"dead hosts {dead}; {survivors} devices survive")
        self.dead = list(dead)
        self.survivors = survivors


class Monitor:
    def __init__(self, dir: str, timeout: float = 60.0):
        self.dir, self.timeout = dir, timeout

    def _read(self, fn: str) -> dict | None:
        """One heartbeat, or None if unreadable.  A host that dies mid-write
        leaves a torn/empty hb_*.json — that's evidence of failure, so it
        must read as *stale*, never crash the coordinator with a
        JSONDecodeError."""
        try:
            with open(os.path.join(self.dir, fn)) as f:
                hb = json.load(f)
            if not isinstance(hb.get("time"), (int, float)):
                return None
            return hb
        except (OSError, json.JSONDecodeError, AttributeError):
            return None

    def _hosts(self, now: float | None):
        now = now if now is not None else time.time()
        for fn in sorted(os.listdir(self.dir)):
            if fn.startswith("hb_") and fn.endswith(".json"):
                hb = self._read(fn)
                alive = hb is not None and now - hb["time"] <= self.timeout
                yield fn[3:-5], alive

    def stale_hosts(self, now: float | None = None) -> list[str]:
        return [h for h, alive in self._hosts(now) if not alive]

    def live_hosts(self, now: float | None = None) -> list[str]:
        return [h for h, alive in self._hosts(now) if alive]


class StragglerWatchdog:
    """Rolling-median step-time watchdog."""

    def __init__(self, factor: float = 2.0, window: int = 32):
        self.factor, self.window = factor, window
        self.times: list[float] = []

    def observe(self, step_seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.times.append(step_seconds)
        self.times = self.times[-self.window :]
        if len(self.times) < 8:
            return False
        med = sorted(self.times)[len(self.times) // 2]
        return step_seconds > self.factor * med


def shrink_mesh_shape(n_devices: int, model: int = 16, pod: int | None = None):
    """Largest (data, model) [or (pod, data, model)] mesh from survivors;
    the model (TP) extent is preserved, data shrinks."""
    if n_devices % model:
        raise ValueError(f"survivors ({n_devices}) not divisible by model={model}")
    rest = n_devices // model
    if pod:
        if rest % pod:
            pod = 1
        return (pod, rest // pod, model)
    return (rest, model)
