"""Load generator for the serving engine: seeded Poisson arrivals at an
offered QPS, driven against either clock — the JAX package's
``serve/loadgen.py`` on one device.

  * ``WallClock`` — real time; what the serve smoke and the card's serving
    phase use.
  * ``VirtualClock`` — the loop advances time by the ladder's *modeled*
    step seconds (schedule words over machine bandwidth), so arrival
    interleaving, batching composition, padding waste, and latency
    percentiles are deterministic.

CLI: ``python -m repro_torch.serve --smoke [--device cpu]`` boots the
engine twice against one autotune cache — the first boot tunes the bucket
cells, the second must replay every tuned winner cache-only with the
autotuner's timing path disabled — pushes a handful of ragged requests
through a 2-bucket ladder each time, and asserts all complete with
identical tokens.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from repro_torch.serve.engine import DONE, SHED, TIMEOUT, Engine, Request

# Re-exported for callers configuring the engine clock.
from repro_torch.serve.engine import VirtualClock, WallClock  # noqa: F401


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One offered-load experiment: ``n_requests`` Poisson arrivals at
    ``qps``, ragged prompts/gen lengths drawn from the given inclusive
    ranges, all from ``seed``."""

    qps: float
    n_requests: int = 32
    prompt_len: tuple = (4, 24)
    new_tokens: tuple = (4, 8)
    deadline_s: float | None = None
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """What one load run measured, in the driving clock's seconds."""

    offered_qps: float
    n_requests: int
    completed: int
    shed: int
    timed_out: int
    p50_s: float
    p99_s: float
    ttft_p50_s: float
    tokens_per_sec: float
    padding_waste: float
    clock_seconds: float
    engine_steps: int
    generated_tokens: int


def make_requests(spec: LoadSpec, vocab: int, start: float = 0.0):
    """Seeded ``[(arrival_time, Request)]`` — identical across runs, and
    the JAX package's draws for the same spec."""
    rng = np.random.default_rng(spec.seed)
    gaps = rng.exponential(1.0 / spec.qps, spec.n_requests)
    arrivals = start + np.cumsum(gaps)
    out = []
    for i in range(spec.n_requests):
        plen = int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1))
        gen = int(rng.integers(spec.new_tokens[0], spec.new_tokens[1] + 1))
        req = Request(
            rid=f"load{i}",
            prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new_tokens=gen,
            deadline=(None if spec.deadline_s is None
                      else float(arrivals[i]) + spec.deadline_s))
        out.append((float(arrivals[i]), req))
    return out


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def run_load(engine: Engine, spec: LoadSpec, *,
             max_steps: int = 200_000) -> LoadReport:
    """Drive ``engine`` through ``spec``: submit arrivals as the engine's
    clock passes them, step until every request resolves.  On a
    ``VirtualClock`` each step advances time by the engine's modeled step
    seconds (deterministic); on a ``WallClock`` time just passes."""
    clock = engine.clock
    t0 = clock.now()
    pending = make_requests(spec, engine.cfg.vocab, start=t0)
    reqs = [r for _, r in pending]
    i, steps = 0, 0
    while True:
        now = clock.now()
        while i < len(pending) and pending[i][0] <= now:
            engine.submit(pending[i][1])
            i += 1
        if engine.idle:
            if i >= len(pending):
                break
            clock.advance_to(pending[i][0])
            continue
        info = engine.step()
        if clock.virtual:
            clock.advance(engine.modeled_step_seconds(info))
        steps += 1
        if steps > max_steps:
            raise RuntimeError(f"load run not drained after {max_steps} steps")
    elapsed = max(clock.now() - t0, 1e-12)
    done = [r for r in reqs if r.state == DONE]
    lat = [r.latency for r in done if r.latency is not None]
    ttft = [r.ttft for r in done if r.ttft is not None]
    gen = sum(len(r.tokens) for r in reqs)
    return LoadReport(
        offered_qps=spec.qps,
        n_requests=len(reqs),
        completed=len(done),
        shed=sum(r.state == SHED for r in reqs),
        timed_out=sum(r.state == TIMEOUT for r in reqs),
        p50_s=_pct(lat, 50), p99_s=_pct(lat, 99),
        ttft_p50_s=_pct(ttft, 50),
        tokens_per_sec=gen / elapsed,
        padding_waste=engine.padding_waste(),
        clock_seconds=elapsed,
        engine_steps=steps,
        generated_tokens=gen,
    )


# ---------------------------------------------------------------------------
# CLI: the two-boot serve smoke
# ---------------------------------------------------------------------------


def _boot(cfg, params, *, policy: str, cache) -> tuple[Engine, dict]:
    from repro_torch.serve.bucket import BucketLadder

    ladder = BucketLadder([(2, 8), (4, 16)], max_seq=24)
    engine = Engine(cfg, params, ladder, queue_depth=16)
    sources = engine.warmup(policy=policy, cache=cache)
    return engine, sources


@contextlib.contextmanager
def no_timing(autotune):
    """The autotuner's timing path (``_measure`` and ``tune``) replaced by
    functions that raise, for a boot that must replay the cache alone."""
    def _raise(*args, **kwargs):
        raise AssertionError("the autotuner's timing path ran on a cache-only boot")

    saved = autotune._measure, autotune.tune
    autotune._measure = autotune.tune = _raise
    try:
        yield
    finally:
        autotune._measure, autotune.tune = saved


def _smoke(device: str) -> int:
    """Boot the engine on the smoke config against one autotune cache
    ($REPRO_AUTOTUNE_CACHE when set, else a throwaway file): the first
    boot tunes the 2-bucket ladder's cells on ``device``, the second must
    replay every tuned winner from the cache with the timing path
    disabled; both boots push the same handful of ragged requests and must
    complete all of them with identical tokens."""
    import os
    import tempfile

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models.module import init_params
    from repro_torch.models.registry import get_family
    from repro_torch.plan import autotune

    cfg = smoke_config("qwen3-1.7b")
    fam = get_family(cfg.family)
    params = init_params(fam.param_defs(cfg), 0, device=device)
    cache_path = (os.environ.get("REPRO_AUTOTUNE_CACHE")
                  or os.path.join(tempfile.mkdtemp(), "autotune.json"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in (3, 7, 12, 5, 9, 15)]

    outputs = []
    for boot, policy in ((1, "tune"), (2, "cache-only")):
        # A fresh cache object per boot: boot 2 must replay from *disk*.
        cache = autotune.AutotuneCache(cache_path)
        with no_timing(autotune) if boot == 2 else contextlib.nullcontext():
            engine, sources = _boot(cfg, params, policy=policy, cache=cache)
            flat = {(b, c): s for b, cells in sources.items()
                    for c, s in cells.items()}
            counts = {s: sum(v == s for v in flat.values())
                      for s in ("cached", "tuned", "modeled")}
            print(f"boot{boot} policy={policy} cells={len(flat)} "
                  f"cached={counts['cached']} tuned={counts['tuned']} "
                  f"modeled={counts['modeled']}")
            if boot == 1:
                tuned = {k for k, v in flat.items() if v == "tuned"}
                if not tuned:
                    raise AssertionError("first boot tuned nothing — smoke is vacuous")
            else:
                missed = {k for k in tuned if flat[k] != "cached"}
                if missed:
                    raise AssertionError(
                        f"winners not replayed on the cache-only boot: {missed}")
                if counts["tuned"]:
                    raise AssertionError("cache-only boot must never tune")
            reqs = [engine.submit(prompt=p, max_new_tokens=5) for p in prompts]
            engine.run_until_idle()
        if not all(r.state == DONE for r in reqs):
            raise AssertionError(
                f"unfinished requests: {[(r.rid, r.state) for r in reqs]}")
        outputs.append([tuple(r.tokens) for r in reqs])
        print(f"boot{boot} completed={len(reqs)} "
              f"pad_waste={engine.padding_waste():.3f} "
              f"steps={engine.stats['steps']}")
    if outputs[0] != outputs[1]:
        raise AssertionError(
            "token streams diverged between the tuned and cache-only boots")
    print(f"serve smoke ok on {device} (winners replayed from {cache_path})")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="2-boot engine smoke against one autotune cache")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs and the cells are tuned "
                         "(default: the card; cpu runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.device)
    ap.error("--smoke required")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
