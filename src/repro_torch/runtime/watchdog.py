"""Step-time watchdog: straggler detection and a heartbeat file (the JAX
package's ``runtime/watchdog.py``).

A straggling step shows up as a step-time outlier: the watchdog keeps a
running median and flags steps slower than ``threshold`` x the median, and
calls ``on_straggler`` (the train loop's recovery hook: checkpoint, then
reset the offload channels). The heartbeat file lets an outside supervisor
detect a hung process; a failed heartbeat write (full or read-only disk) is
counted in ``stats`` and never fails the training step. With ``telemetry``:
the ``train.step_s`` histogram, a ``step`` record a step, and a
``straggler`` record and postmortem for each straggler.
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable

from repro_torch.telemetry.metrics import percentiles


class WatchdogError(RuntimeError):
    """Watchdog API misuse (e.g. end_step without a matching start_step)."""


class Watchdog:
    def __init__(self, window: int = 50, threshold: float = 3.0,
                 heartbeat_path: str | None = None,
                 on_straggler: Callable[[int, float, float], None] | None = None,
                 telemetry=None):
        self.window = window
        self.threshold = threshold
        self.heartbeat_path = heartbeat_path
        self.on_straggler = on_straggler
        self.durations: collections.deque[float] = collections.deque(maxlen=window)
        self.stragglers: list[tuple[int, float, float]] = []
        self.stats = {"steps": 0, "heartbeats": 0, "heartbeat_failures": 0}
        self._t0: float | None = None
        # observational: step-time histogram + a per-step breadcrumb ring so
        # a straggler postmortem shows the steps leading up to the outlier
        self.tm = telemetry if telemetry else None

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
        if self.tm is not None:
            self.tm.registry.histogram("train.step_s").observe(dt)
            self.tm.record("train", 0, "step", step=step, dt=dt)
        if med is not None and len(self.durations) >= 10 and dt > self.threshold * med:
            self.stragglers.append((step, dt, med))
            if self.tm is not None:
                self.tm.record("train", 0, "straggler", step=step, dt=dt,
                               median=med)
                self.tm.dump("train", 0,
                             f"straggler step {step}: {dt:.4f}s > "
                             f"{self.threshold:g}x median {med:.4f}s")
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
