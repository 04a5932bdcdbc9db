"""Trace-time flags (module-global, context-managed): the JAX package's
``flags.py`` with its ``get`` and ``override``, and none of its keys.

Neither of JAX's keys has anything to set in the port:

- ``unroll_scans`` exists there because XLA's cost analysis counts a
  while-loop body once whatever its trip count. The port's layer, chunk and
  loss loops are Python loops, and an eager count
  (``launch/dryrun.py``) sees every iteration.
- ``dense_sdpa`` makes JAX's ``ref.sdpa`` skip its query-block loop. The
  port's blocked path runs every block against the whole key axis, so it
  issues the same products as the dense path, and the dry-run counts the
  blocked path as it stands.

A key goes in ``_FLAGS`` when code of the port reads it.
"""
from __future__ import annotations

import contextlib

_FLAGS: dict[str, bool] = {}


def get(name: str) -> bool:
    return _FLAGS[name]


@contextlib.contextmanager
def override(**kw):
    old = {k: _FLAGS[k] for k in kw}
    _FLAGS.update(kw)
    try:
        yield
    finally:
        _FLAGS.update(old)
