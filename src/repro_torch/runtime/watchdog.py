"""Step-time watchdog: straggler detection and a heartbeat file (the JAX
package's ``runtime/watchdog.py``).

A straggling step shows up as a step-time outlier: the watchdog keeps a
running median and flags steps slower than ``threshold`` x the median, and
calls ``on_straggler`` (the train loop's recovery hook: checkpoint, then
reset the offload channels). The heartbeat file lets an outside supervisor
detect a hung process; a failed heartbeat write (full or read-only disk) is
counted in ``stats`` and never fails the training step.
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable

import numpy as np


def percentiles(xs, qs=(50, 95, 99)) -> dict | None:
    """Tail summary of a sample list: count/mean/max plus p50/p95/p99.
    Returns None for an empty sample (callers report 'no data', not zeros).
    (The JAX package's ``telemetry.metrics.percentiles``, until the port has
    its telemetry package, ROADMAP.md A.4.)"""
    xs = list(xs)
    if not xs:
        return None
    a = np.asarray(xs, np.float64)
    out = {"count": int(a.size), "mean": float(a.mean()), "max": float(a.max())}
    for q in qs:
        out[f"p{q}"] = float(np.percentile(a, q))
    return out


class WatchdogError(RuntimeError):
    """Watchdog API misuse (e.g. end_step without a matching start_step)."""


class Watchdog:
    def __init__(self, window: int = 50, threshold: float = 3.0,
                 heartbeat_path: str | None = None,
                 on_straggler: Callable[[int, float, float], None] | None = None,
                 telemetry=None):
        if telemetry is not None:
            raise NotImplementedError(
                f"Watchdog(telemetry={telemetry!r}) is not ported yet "
                "(ROADMAP.md A.4)")
        self.window = window
        self.threshold = threshold
        self.heartbeat_path = heartbeat_path
        self.on_straggler = on_straggler
        self.durations: collections.deque[float] = collections.deque(maxlen=window)
        self.stragglers: list[tuple[int, float, float]] = []
        self.stats = {"steps": 0, "heartbeats": 0, "heartbeat_failures": 0}
        self._t0: float | None = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> float:
        if self._t0 is None:
            raise WatchdogError(
                "end_step() called without a matching start_step()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.stats["steps"] += 1
        med = self.median()
        if med is not None and len(self.durations) >= 10 and dt > self.threshold * med:
            self.stragglers.append((step, dt, med))
            if self.on_straggler:
                self.on_straggler(step, dt, med)
        self.durations.append(dt)
        if self.heartbeat_path:
            try:
                tmp = self.heartbeat_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"step": step, "time": time.time(), "dt": dt}, f)
                os.replace(tmp, self.heartbeat_path)
                self.stats["heartbeats"] += 1
            except OSError:
                # disk full / path gone / read-only fs: a missed heartbeat is
                # an observability gap, not a training failure
                self.stats["heartbeat_failures"] += 1
        return dt

    def median(self) -> float | None:
        if not self.durations:
            return None
        s = sorted(self.durations)
        return s[len(s) // 2]

    def summary(self) -> dict:
        """Step-time health over the sliding window: counters plus tail
        percentiles (``step_s`` is None until a step completes)."""
        out = dict(self.stats)
        out["stragglers"] = len(self.stragglers)
        out["median_s"] = self.median()
        out["step_s"] = percentiles(self.durations)
        return out

    def brief(self) -> dict:
        """Compact record for periodic logging (TrainLoop's metrics.jsonl)."""
        p = percentiles(self.durations)
        return {"steps": self.stats["steps"],
                "stragglers": len(self.stragglers),
                "heartbeat_failures": self.stats["heartbeat_failures"],
                "median_s": self.median(),
                "p95_s": p["p95"] if p else None}
