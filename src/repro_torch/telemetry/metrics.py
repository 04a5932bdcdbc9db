"""Metric registry: counters, gauges and fixed-bucket histograms (a copy of
the JAX package's ``telemetry/metrics.py``: plain Python and numpy, it never
touches a tensor).

One registry absorbs every stat dict in the stack under namespaced metric
names (``serve.*``, ``store.*``, ``channel.*``, ``pager.*``, ``train.*``) and
exposes them three ways:

- ``snapshot()``      — one flat dict (histograms summarised with count/sum/
                        min/max and p50/p95/p99), JSON-serialisable;
- ``emit()``          — append the snapshot as one JSONL record to a stream
                        opened with ``stream_to(path)``;
- ``to_prometheus()`` — Prometheus text exposition (histograms as cumulative
                        ``_bucket{le=...}`` series plus ``_sum``/``_count``).

Histograms hold fixed log-spaced buckets (so memory is O(buckets), never
O(observations)) plus a bounded ring of raw samples: tail percentiles are
exact while the ring covers every observation and bucket-interpolated beyond
that — means hide tail latency, which is the whole point of this module.

A registry built with ``enabled=False`` hands out shared null metrics whose
methods are no-ops and snapshots empty: the disabled path is an attribute
check and a no-op call, cheap enough to leave instrumentation permanently in
hot paths (guarded by tests/test_torch_telemetry.py).
"""
from __future__ import annotations

import bisect
import collections
import json
import re
import time

import numpy as np

# log-spaced 1/2.5/5 per decade, 1us .. 100s: wide enough for a decode tick
# (~ms), a prefill chunk (~10ms) and an offloaded fit round (~s) on one scale
DEFAULT_TIME_BUCKETS: tuple[float, ...] = tuple(
    m * 10.0 ** e for e in range(-6, 3) for m in (1.0, 2.5, 5.0))


def percentiles(xs, qs=(50, 95, 99)) -> dict | None:
    """Tail summary of a sample list: count/mean/max plus p50/p95/p99.
    Returns None for an empty sample (callers report 'no data', not zeros)."""
    xs = list(xs)
    if not xs:
        return None
    a = np.asarray(xs, np.float64)
    out = {"count": int(a.size), "mean": float(a.mean()), "max": float(a.max())}
    for q in qs:
        out[f"p{q}"] = float(np.percentile(a, q))
    return out


class Counter:
    """Monotonic count. ``set`` exists for mirroring an external stat dict
    (absorb) — the source is the monotonic authority, not this object."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram with a bounded raw-sample ring.

    ``buckets`` are upper bounds (ascending); observations beyond the last
    bound land in the implicit +Inf bucket. Percentiles are exact while the
    ring (``sample_cap`` most recent values) still holds every observation,
    and linearly interpolated from bucket counts beyond that.
    """

    __slots__ = ("buckets", "counts", "count", "sum", "min", "max", "_ring")

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
                 sample_cap: int = 4096):
        self.buckets = tuple(float(b) for b in buckets)
        assert list(self.buckets) == sorted(self.buckets), "buckets ascending"
        self.counts = np.zeros(len(self.buckets) + 1, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._ring = collections.deque(maxlen=sample_cap)

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._ring.append(v)

    def percentile(self, q: float) -> float | None:
        """q in [0, 100]. Exact over the sample ring when it is complete,
        bucket-interpolated otherwise."""
        if self.count == 0:
            return None
        if self.count <= self._ring.maxlen:
            return float(np.percentile(np.asarray(self._ring, np.float64), q))
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                frac = (target - cum) / max(c, 1)
                return float(lo + frac * (hi - lo))
            cum += c
        return float(self.max)

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {"count": int(self.count), "sum": float(self.sum),
                "mean": float(self.sum / self.count),
                "min": float(self.min), "max": float(self.max),
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class _NullMetric:
    """Shared no-op stand-in for every metric kind on a disabled registry."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float):
        return None

    def summary(self) -> dict:
        return {"count": 0}


NULL_METRIC = _NullMetric()


class MetricRegistry:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, object] = {}
        self._stream_path: str | None = None

    # -- access / creation -------------------------------------------------
    def _get(self, name: str, kind):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind()
        assert isinstance(m, kind), f"{name} already registered as {type(m)}"
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter) if self.enabled else NULL_METRIC

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge) if self.enabled else NULL_METRIC

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        if not self.enabled:
            return NULL_METRIC
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(buckets)
        return m

    # -- absorption of legacy stat dicts -----------------------------------
    def absorb(self, namespace: str, stats: dict) -> None:
        """Mirror a component's stat dict under ``namespace.*``: ints become
        counters (set to the source value — the dict stays the authority),
        floats/bools become gauges; nested dicts recurse dotted."""
        if not self.enabled:
            return
        for k, v in stats.items():
            name = f"{namespace}.{k}"
            if isinstance(v, dict):
                self.absorb(name, v)
            elif isinstance(v, bool):
                self.gauge(name).set(int(v))
            elif isinstance(v, (int, np.integer)):
                self.counter(name).set(int(v))
            elif isinstance(v, (float, np.floating)):
                self.gauge(name).set(float(v))
            elif v is None:
                continue
            else:   # strings and other non-numerics have no metric shape
                continue

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        out: dict = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out

    def stream_to(self, path: str) -> None:
        self._stream_path = path

    def emit(self, **extra) -> None:
        """Append one JSONL record {ts, **extra, metrics: snapshot()}."""
        if not self.enabled or self._stream_path is None:
            return
        rec = {"ts": time.time(), **extra, "metrics": self.snapshot()}
        with open(self._stream_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    @staticmethod
    def _prom_name(name: str) -> str:
        return re.sub(r"[^a-zA-Z0-9_]", "_", name)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape's worth)."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pn = self._prom_name(name)
            if isinstance(m, Counter):
                lines += [f"# TYPE {pn} counter", f"{pn} {m.value}"]
            elif isinstance(m, Gauge):
                lines += [f"# TYPE {pn} gauge", f"{pn} {m.value}"]
            else:
                lines.append(f"# TYPE {pn} histogram")
                cum = 0
                for b, c in zip(m.buckets, m.counts[:-1]):
                    cum += int(c)
                    lines.append(f'{pn}_bucket{{le="{b:g}"}} {cum}')
                lines.append(f'{pn}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pn}_sum {m.sum}")
                lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")
