"""Read back a Chrome-trace-event file exported by ``repro_torch.telemetry``
(the JAX package's ``trace_summary.py``, on the port's telemetry).

    PYTHONPATH=src python -m repro_torch.trace_summary trace.json
    PYTHONPATH=src python -m repro_torch.trace_summary trace.json --metrics snap.json

Validates the document against the trace-event schema (well-formed,
non-empty, spans properly nested per lane — the same check the tier-1 test
runs), then prints per-span-name latency stats (count, total, mean, p50/p95/
p99, max) and the slowest individual spans. With ``--metrics`` it also pretty-
prints a metrics snapshot JSON (``ServeEngine.telemetry_snapshot()`` /
``MetricRegistry.snapshot()`` output) next to the trace.

Open the same file in https://ui.perfetto.dev (or chrome://tracing) for the
interactive timeline.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.telemetry.metrics import percentiles
from repro_torch.telemetry.tracing import validate_trace


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def span_table(doc: dict) -> list[dict]:
    """Aggregate complete events by name: count/total/mean/percentiles (ms)."""
    by_name: dict[str, list[float]] = {}
    for ev in doc.get("traceEvents", []):
        if isinstance(ev, dict) and ev.get("ph") == "X":
            by_name.setdefault(ev["name"], []).append(float(ev["dur"]) / 1e3)
    rows = []
    for name, durs in sorted(by_name.items()):
        p = percentiles(durs)
        rows.append({"name": name, "count": p["count"],
                     "total_ms": float(sum(durs)), "mean_ms": p["mean"],
                     "p50_ms": p["p50"], "p95_ms": p["p95"],
                     "p99_ms": p["p99"], "max_ms": p["max"]})
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def slowest(doc: dict, n: int = 5) -> list[dict]:
    evs = [ev for ev in doc.get("traceEvents", [])
           if isinstance(ev, dict) and ev.get("ph") == "X"]
    evs.sort(key=lambda ev: -float(ev["dur"]))
    return [{"name": ev["name"], "dur_ms": float(ev["dur"]) / 1e3,
             "ts_ms": float(ev["ts"]) / 1e3, "args": ev.get("args", {})}
            for ev in evs[:n]]


def summarize(doc: dict, report=print) -> int:
    problems = validate_trace(doc)
    if problems:
        for p in problems:
            report(f"INVALID: {p}")
        return 1
    rows = span_table(doc)
    n_events = sum(r["count"] for r in rows)
    report(f"valid trace-event JSON: {n_events} spans, "
           f"{len(rows)} distinct names")
    hdr = f"{'span':<20} {'count':>6} {'total_ms':>10} {'mean_ms':>9} " \
          f"{'p50_ms':>8} {'p95_ms':>8} {'p99_ms':>8} {'max_ms':>8}"
    report(hdr)
    for r in rows:
        report(f"{r['name']:<20} {r['count']:>6} {r['total_ms']:>10.2f} "
               f"{r['mean_ms']:>9.3f} {r['p50_ms']:>8.3f} {r['p95_ms']:>8.3f} "
               f"{r['p99_ms']:>8.3f} {r['max_ms']:>8.3f}")
    report("slowest spans:")
    for s in slowest(doc):
        args = f" {s['args']}" if s["args"] else ""
        report(f"  {s['name']:<20} {s['dur_ms']:.3f}ms @ {s['ts_ms']:.1f}ms"
               f"{args}")
    return 0


def summarize_metrics(path: str, report=print) -> None:
    with open(path) as f:
        snap = json.load(f)
    # a raw registry snapshot or a JSONL emit record ({"metrics": {...}})
    metrics = snap.get("metrics", snap) if isinstance(snap, dict) else snap
    report(f"metrics snapshot: {len(metrics)} series")
    for name, v in sorted(metrics.items()):
        if isinstance(v, dict):
            if v.get("count", 0) == 0:
                report(f"  {name}: (no samples)")
            else:
                report(f"  {name}: count={v['count']} mean={v['mean']:.6f} "
                       f"p50={v['p50']:.6f} p95={v['p95']:.6f} "
                       f"p99={v['p99']:.6f} max={v['max']:.6f}")
        else:
            report(f"  {name}: {v}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.trace_summary", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("trace", help="Chrome-trace-event JSON file")
    p.add_argument("--metrics", default=None,
                   help="metrics snapshot JSON to pretty-print alongside")
    args = p.parse_args(argv)
    rc = summarize(load(args.trace))
    if args.metrics:
        summarize_metrics(args.metrics)
    return rc


if __name__ == "__main__":
    sys.exit(main())
