"""Unified telemetry for the FTaaS stack: metric registry, span tracing and
the flight recorder behind one facade (the JAX package's ``telemetry``
package, ported).

Three pillars:

- **Metrics** (`metrics.MetricRegistry`): counters/gauges/fixed-bucket
  histograms under namespaced names (``serve.*``, ``store.*``, ``channel.*``,
  ``pager.*``, ``train.*``) with one ``snapshot()``, a JSONL streamer and a
  Prometheus text exporter. The components' stat dicts keep working and are
  absorbed into the registry.
- **Tracing** (`tracing.Tracer`): Chrome-trace-event (Perfetto-loadable)
  spans — per-tick serve spans and per-user offload-round spans carrying the
  channel's seq ids in their args. Read back with
  ``python -m repro_torch.trace_summary``.
- **Flight recorder** (`recorder.FlightRecorder`): bounded per-user/per-slot
  rings of recent events, frozen into postmortem files on quarantine,
  validation rollback, PagerError or a watchdog straggler.

Usage: build one ``Telemetry`` and hand it to the components you want
observed (``ServeEngine(telemetry=tm)``, ``ColaSession(telemetry=tm)``,
``TrainLoop(telemetry=tm)``, ...). Components accept ``telemetry=None``
(the default): the disabled path is one attribute check per site and MUST
stay a no-op. Telemetry only ever *reads host-side values* (Python and
numpy scalars, never a tensor) between the points where the code already
waits for the card, so it adds no device sync and generated tokens are
bit-identical telemetry-on vs. off (guarded by tests/test_torch_telemetry.py
and ``chip_smoke.py``). Spans and histograms measure host wall time.

One rename against the JAX package: its ``jax_annotations=`` /
``enable_jax_annotations`` (``jax.profiler.TraceAnnotation``) are
``profiler_annotations=`` / ``enable_profiler_annotations`` here, and
``annotate(name)`` opens a ``torch.profiler.record_function(name)``.
"""
from __future__ import annotations

import contextlib

from repro_torch.telemetry.metrics import (DEFAULT_TIME_BUCKETS,
                                           MetricRegistry, percentiles)
from repro_torch.telemetry.recorder import FlightRecorder
from repro_torch.telemetry.tracing import Tracer, validate_trace

__all__ = ["Telemetry", "MetricRegistry", "Tracer", "FlightRecorder",
           "validate_trace", "percentiles", "annotate", "NULL_CONTEXT",
           "DEFAULT_TIME_BUCKETS"]

# one shared reusable no-op context: the entire cost of a disabled span
NULL_CONTEXT = contextlib.nullcontext()

# module-global switch for torch-profiler annotations around hot dispatches
_ANNOTATE = False


def enable_profiler_annotations(on: bool) -> None:
    global _ANNOTATE
    _ANNOTATE = bool(on)


def annotate(name: str):
    """Optional ``torch.profiler.record_function`` around a hot-path dispatch
    (decode tick, offloaded fit). Off by default — the disabled path returns
    the shared null context. Enable via ``Telemetry(profiler_annotations=
    True)`` when profiling with ``torch.profiler``; the annotation names the
    host dispatch slice in that timeline. The profiler records the thread
    that started it: a fit on ``call_with_timeout``'s worker thread
    (``RetryPolicy(timeout_s=...)``) is not seen."""
    if not _ANNOTATE:
        return NULL_CONTEXT
    from torch.profiler import record_function
    return record_function(name)


class Telemetry:
    """Facade tying the registry, tracer and flight recorder together.

    Parameters
    ----------
    enabled              : master switch. ``Telemetry(enabled=False)`` is
                           indistinguishable from passing ``telemetry=None``.
    trace                : collect Chrome-trace spans (off by default — spans
                           accumulate in memory until ``export_trace``).
    recorder_capacity    : events retained per flight-recorder key.
    out_dir              : where postmortem files land (None = in-memory only).
    profiler_annotations : arm ``annotate()`` hooks around hot dispatches.
    """

    def __init__(self, *, enabled: bool = True, trace: bool = False,
                 recorder_capacity: int = 64, out_dir: str | None = None,
                 profiler_annotations: bool = False):
        self.enabled = bool(enabled)
        self.registry = MetricRegistry(enabled=self.enabled)
        self.tracer = Tracer() if (self.enabled and trace) else None
        self.recorder = (FlightRecorder(capacity=recorder_capacity,
                                        out_dir=out_dir)
                         if self.enabled else None)
        if self.enabled and profiler_annotations:
            enable_profiler_annotations(True)

    def __bool__(self) -> bool:
        return self.enabled

    # -- tracing -----------------------------------------------------------
    def span(self, name: str, cat: str = "serve", tid: int = 0, **args):
        if self.tracer is None:
            return NULL_CONTEXT
        return self.tracer.span(name, cat=cat, tid=tid, **args)

    def name_thread(self, tid: int, name: str) -> None:
        if self.tracer is not None:
            self.tracer.name_thread(tid, name)

    def export_trace(self, path: str) -> str | None:
        return self.tracer.export(path) if self.tracer is not None else None

    # -- flight recorder ---------------------------------------------------
    def record(self, scope: str, key, kind: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.record(scope, key, kind, **fields)

    def dump(self, scope: str, key, reason: str) -> dict | None:
        if self.recorder is not None:
            return self.recorder.dump(scope, key, reason)
        return None

    # -- metrics -----------------------------------------------------------
    def snapshot(self) -> dict:
        return self.registry.snapshot()
