"""Flight recorder: bounded rings of recent structured events + postmortems
(a copy of the JAX package's ``telemetry/recorder.py``, with its file names
and layout).

Every instrumented component appends small structured events to a per-key
ring (key = ``(scope, id)``: ``("user", 3)`` for an offload channel,
``("slot", 2)`` for a serve slot, ``("train", 0)`` for the train loop). Rings
are bounded (``capacity`` most recent events), so steady-state cost is O(1)
per event and memory is O(keys x capacity) — black-box style.

When something terminal happens — quarantine, validation rollback, a
``PagerError``, a watchdog straggler — ``dump`` freezes that key's ring into
a *postmortem*: an in-memory record (``recorder.postmortems``) and, when the
recorder has an ``out_dir``, a JSON file::

    postmortem-<scope>-<id>-<n>.json
    {"scope": ..., "key": ..., "reason": ..., "dumped_at": ...,
     "events": [{"t": <unix time>, "kind": ..., ...}, ...]}

so a dead-lettered update or a quarantined user is explainable after the
fact without re-running under fault injection.
"""
from __future__ import annotations

import collections
import json
import os
import re
import time


class FlightRecorder:
    def __init__(self, capacity: int = 64, out_dir: str | None = None,
                 clock=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.out_dir = out_dir
        self._clock = clock
        self._rings: dict[tuple, collections.deque] = {}
        self.postmortems: list[dict] = []

    # -- event ingestion ---------------------------------------------------
    def record(self, scope: str, key, kind: str, **fields) -> None:
        ring = self._rings.get((scope, key))
        if ring is None:
            ring = self._rings[(scope, key)] = collections.deque(
                maxlen=self.capacity)
        ring.append({"t": self._clock(), "kind": kind, **fields})

    def events(self, scope: str, key) -> list[dict]:
        return list(self._rings.get((scope, key), ()))

    def keys(self) -> list[tuple]:
        return sorted(self._rings, key=repr)

    # -- postmortems -------------------------------------------------------
    def dump(self, scope: str, key, reason: str) -> dict:
        """Freeze a key's ring into a postmortem record (and a JSON file when
        ``out_dir`` is set). Returns the record; ``record["path"]`` carries
        the file path (None when in-memory only)."""
        pm = {"scope": scope, "key": key, "reason": reason,
              "dumped_at": self._clock(),
              "events": self.events(scope, key), "path": None}
        if self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            safe = re.sub(r"[^a-zA-Z0-9_-]", "_", f"{scope}-{key}")
            pm["path"] = os.path.join(
                self.out_dir,
                f"postmortem-{safe}-{len(self.postmortems):03d}.json")
            with open(pm["path"], "w") as f:
                json.dump({k: v for k, v in pm.items() if k != "path"}, f,
                          indent=2, default=str)
                f.write("\n")
        self.postmortems.append(pm)
        return pm
