"""Span tracing with Chrome-trace-event JSON export (a copy of the JAX
package's ``telemetry/tracing.py``).

``Tracer.span(...)`` is a context manager that appends one complete ("ph":
"X") trace event per exit — name, category, microsecond timestamp + duration
relative to the tracer's epoch, and free-form ``args`` (user ids, channel seq
ids, tick numbers). The exported document::

    {"traceEvents": [...], "displayTimeUnit": "ms"}

loads directly in Perfetto / chrome://tracing. Events on one ``tid`` lane
nest by construction (a child span enters after and exits before its parent),
which ``validate_trace`` checks — the tier-1 schema test and the
``repro_torch.trace_summary`` reader both run it.

Lanes (tid) are a convention, not a mechanism: the serve engine emits on the
"serve" lane, the train loop + offload channels on "offload" lanes. Metadata
("M") events name them for the viewer.
"""
from __future__ import annotations

import contextlib
import json
import os
import time


class Tracer:
    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._pid = os.getpid()
        self.events: list[dict] = []
        self._named_tids: set[int] = set()

    # -- emission ----------------------------------------------------------
    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def name_thread(self, tid: int, name: str) -> None:
        """Label a tid lane in the viewer (idempotent)."""
        if tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self.events.append({"name": "thread_name", "ph": "M", "pid": self._pid,
                            "tid": tid, "args": {"name": name}})

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "serve", tid: int = 0, **args):
        t0 = self.now_us()
        try:
            yield
        finally:
            t1 = self.now_us()
            ev = {"name": name, "cat": cat, "ph": "X", "pid": self._pid,
                  "tid": tid, "ts": t0, "dur": t1 - t0}
            if args:
                ev["args"] = args
            self.events.append(ev)

    def instant(self, name: str, cat: str = "serve", tid: int = 0, **args):
        ev = {"name": name, "cat": cat, "ph": "i", "pid": self._pid,
              "tid": tid, "ts": self.now_us(), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- export ------------------------------------------------------------
    def to_doc(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_doc(), f)
            f.write("\n")
        return path


# ---------------------------------------------------------------------------
# trace-event schema validation (tier-1 test + trace_summary both run this)
# ---------------------------------------------------------------------------

_REQUIRED = ("name", "ph", "pid", "tid")


def validate_trace(doc: dict) -> list[str]:
    """Validate a Chrome-trace-event document. Returns a list of problems
    (empty = valid): well-formed container, required event fields, and — for
    complete events sharing a (pid, tid) lane — proper span nesting: a span
    that starts inside another must also end inside it."""
    problems: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not a {'traceEvents': [...]} object"]
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["traceEvents is empty or not a list"]
    lanes: dict[tuple, list[tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            problems.append(f"event {i} missing fields {missing}")
            continue
        if ev["ph"] == "M":
            continue                       # metadata carries no timestamp
        if "ts" not in ev or not isinstance(ev["ts"], (int, float)):
            problems.append(f"event {i} ({ev['name']}) has no numeric ts")
            continue
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({ev['name']}) has bad dur {dur!r}")
                continue
            lanes.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(dur), ev["name"]))
    if not lanes:
        problems.append("no complete ('X') span events in trace")
    eps = 1e-3   # us; guards float round-trip through JSON
    for lane, spans in lanes.items():
        # sort by start asc, end desc: parents come before their children
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list[tuple[float, float, str]] = []
        for ts, end, name in spans:
            while stack and ts >= stack[-1][1] - eps:
                stack.pop()
            if stack and end > stack[-1][1] + eps:
                problems.append(
                    f"lane {lane}: span '{name}' [{ts:.1f}, {end:.1f}] "
                    f"overlaps parent '{stack[-1][2]}' ending {stack[-1][1]:.1f}")
            stack.append((ts, end, name))
    return problems
