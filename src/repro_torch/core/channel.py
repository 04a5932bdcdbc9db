"""Fault-tolerant offload channel: the reliability layer between the server
and one user's fit device (paper Fig. 1, the FTaaS deployment), as in the
JAX package's ``core/channel.py``.

``OffloadChannel`` wraps an ``Offloader`` behind an optional
``FaultInjector`` and a ``RetryPolicy`` and keeps four invariants:

1. **Exactly-once payload delivery.** Every pushed payload carries a sequence
   id and a checksum; duplicates are discarded, corrupt or NaN copies are
   nacked and re-sent with exponential backoff, and payloads whose retries
   are exhausted land in the dead-letter queue instead of a buffer.
2. **Versioned adapter banks.** Every committed fit bumps ``version``;
   readers (merged training, the serve engine) hot-swap on version bumps and
   never see a half-applied update.
3. **Validated commits only.** A returned bank is committed only if every
   leaf is finite and its update norm against the last-good bank is bounded;
   anything else is retried (the refit is deterministic) and finally rolled
   back, so ``offloader.adapters`` always holds a validated bank.
4. **Per-user quarantine.** A user whose fit rounds keep failing is
   quarantined: the bank stays at the last-good version and later payloads
   are refused, so one poisoned user never perturbs a healthy peer.
   ``reset()`` (the watchdog's recovery hook) lifts it.

The checks run where the tensors live: each is a handful of reductions on
the leaves' device (per-leaf sums and the update norm in float64, finiteness)
read back to the host with one sync, where the JAX package pulls every leaf
to the host. Each reduction reads a payload leaf once.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.runtime.faults import (DeadLetter, Delivery, FaultInjector,
                                        FitTimeout, RetryPolicy,
                                        call_with_timeout)
from repro_torch.telemetry import NULL_CONTEXT
from repro_torch.utils import sorted_leaves


def _leaf_finite(t: torch.Tensor) -> torch.Tensor:
    """Whether every entry of one leaf is finite, as a 0-d bool tensor on its
    device. It comes from the leaf's min and max (NaN propagates), without a
    bool copy of the leaf."""
    if t.numel() == 0:
        return torch.ones((), dtype=torch.bool, device=t.device)
    lo, hi = torch.aminmax(t.detach())
    return torch.isfinite(lo) & torch.isfinite(hi)


def _leaf_stats(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(float64 sum, finite) of one leaf, as 0-d tensors on its device. The
    sum is taken along the last axis in float32 (bf16 widened on the fly),
    then in float64 across those rows: ``torch.sum(t, dtype=torch.float64)``
    would first copy the whole leaf to float64."""
    t = t.detach()
    if t.numel() == 0:
        return (torch.zeros((), dtype=torch.float64, device=t.device),
                _leaf_finite(t))
    rows = t.reshape(-1, t.shape[-1]) if t.dim() else t.reshape(1, 1)
    acc = torch.float64 if t.dtype == torch.float64 else torch.float32
    total = torch.sum(rows, dim=1, dtype=acc).sum(dtype=torch.float64)
    return total, _leaf_finite(t)


def _tree_stats(tree) -> tuple[bool, tuple[float, ...]]:
    """(every leaf finite, per-leaf float64 sums: the transfer checksum),
    with one host sync."""
    leaves = sorted_leaves(tree)
    if not leaves:
        return True, ()
    dev = leaves[0].device
    stats = [_leaf_stats(t) for t in leaves]
    finite = torch.stack([f.to(dev) for _, f in stats]).all()
    out = torch.stack([s.to(dev) for s, _ in stats]
                      + [finite.to(torch.float64)]).tolist()
    return bool(out[-1]), tuple(out[:-1])


def _bank_stats(new, old) -> tuple[bool, float]:
    """(every leaf of ``new`` finite, the float64 norm of new - old), with
    one host sync."""
    pairs = list(zip(sorted_leaves(new), sorted_leaves(old)))
    if not pairs:
        return True, 0.0
    dev = pairs[0][0].device
    sq = torch.stack([torch.sum(torch.square(
        a.detach().double() - b.detach().to(a.device).double())).to(dev)
        for a, b in pairs]).sum()
    finite = torch.stack([_leaf_finite(a).to(dev) for a, _ in pairs]
                         ).all().to(torch.float64)
    fin, norm = torch.stack([finite, torch.sqrt(sq)]).tolist()
    return bool(fin), float(norm)


def _checksums_match(got: tuple[float, ...], want: tuple[float, ...]) -> bool:
    if len(got) != len(want):
        return False
    return all(g == w or abs(g - w) <= 1e-6 * max(1.0, abs(w))
               for g, w in zip(got, want))


class OffloadChannel:
    """Reliable transport and validation around one user's ``Offloader``.
    With ``telemetry``: ``channel.push`` / ``channel.fit_round`` spans on the
    "offload" lane, the ``channel.fit_round_s`` histogram, a record of each
    delivery, commit, error (by kind), quarantine and reset in the user's
    flight-recorder ring, and a postmortem on every rollback."""

    def __init__(self, offloader, *, user: int = 0,
                 injector: FaultInjector | None = None,
                 policy: RetryPolicy | None = None,
                 max_update_norm: float = 1e4,
                 quarantine_after: int = 2,
                 on_commit=None, telemetry=None):
        self.offloader = offloader
        self.user = user
        self.injector = injector
        self.policy = policy or RetryPolicy()
        self.max_update_norm = max_update_norm
        self.quarantine_after = quarantine_after
        # publication hook: on_commit(user, version, adapters) after every
        # validated commit (e.g. ServeEngine.install_adapters); it only ever
        # sees committed banks
        self.on_commit = on_commit
        # telemetry is observational: every record/span reads values already
        # computed for the reliability protocol, never perturbs it
        self.tm = telemetry if telemetry else None
        if self.tm:
            self.tm.name_thread(1, "offload")
        # the last failure seen (reason and offending seq), in health()
        self.last_error: str | None = None
        self.last_error_seq: int | None = None

        self.version = 0
        self.last_good: dict = offloader.adapters   # validated by construction
        self.quarantined = False
        self.dead_letters: list[DeadLetter] = []
        self._seq = 0
        self._seen: set[int] = set()
        self._fail_streak = 0
        self._rng = np.random.default_rng(np.random.SeedSequence((1337, user)))
        self.health_counters = {
            "pushes": 0, "delivered": 0, "send_retries": 0,
            "dup_discarded": 0, "corrupt_rejected": 0, "nan_rejected": 0,
            "late_deliveries": 0, "late_dropped": 0, "refused_quarantined": 0,
            "dead_letters": 0, "fit_attempts": 0, "fits_committed": 0,
            "fit_timeouts": 0, "fit_errors": 0, "fit_rejected": 0,
            "rollbacks": 0, "backoff_s": 0.0,
        }

    # -- convenience -------------------------------------------------------
    @property
    def adapters(self) -> dict:
        """The user's bank. Invariant: only ever a validated, committed bank."""
        return self.offloader.adapters

    def health(self) -> dict:
        out = dict(self.health_counters)
        out.update(version=self.version, quarantined=self.quarantined,
                   fail_streak=self._fail_streak,
                   dead_letter_count=len(self.dead_letters),
                   last_error=self.last_error,
                   last_error_seq=self.last_error_seq)
        return out

    def health_brief(self) -> dict:
        """Compact health record for periodic logging (TrainLoop's
        metrics.jsonl): the fields that flag a degrading user."""
        h = self.health_counters
        return {"version": self.version, "quarantined": self.quarantined,
                "fail_streak": self._fail_streak,
                "dead_letters": len(self.dead_letters),
                "fits_committed": h["fits_committed"],
                "rollbacks": h["rollbacks"],
                "last_error": self.last_error,
                "last_error_seq": self.last_error_seq}

    # -- telemetry ----------------------------------------------------------
    def _span(self, name: str, **args):
        if self.tm is None:
            return NULL_CONTEXT
        return self.tm.span(name, cat="offload", tid=1, **args)

    def _record(self, kind: str, **fields) -> None:
        if self.tm is not None:
            self.tm.record("user", self.user, kind, **fields)

    def round_span(self):
        """The ``session.offload_round`` span of one user round (push and
        fit), which the sessions open; the channel's ``channel.push`` and
        ``channel.fit_round`` spans, carrying the seq ids, nest inside."""
        if self.tm is None:
            return NULL_CONTEXT
        return self.tm.span("session.offload_round", cat="offload", tid=1,
                            user=self.user, seq=self._seq)

    def _note_error(self, kind: str, reason: str, seq: int) -> None:
        self.last_error = reason
        self.last_error_seq = seq
        self._record(kind, reason=reason, seq=seq)

    # -- transport: server -> offload device -------------------------------
    def _transmit(self, kind: str, obj) -> list[Delivery]:
        if self.injector is None:
            return [Delivery(obj)]
        return self.injector.transmit(self.user, kind, obj)

    def push(self, data: dict[str, tuple]) -> bool:
        """Ship one batch of adaptation data, retrying transit faults.

        Returns True when exactly one clean copy reached the offload
        buffers; False when the user is quarantined or retries were
        exhausted (the payload is then dead-lettered, not silently lost).
        """
        with self._span("channel.push", user=self.user, seq=self._seq):
            return self._push(data)

    def _push(self, data: dict[str, tuple]) -> bool:
        h = self.health_counters
        h["pushes"] += 1
        if self.quarantined:
            h["refused_quarantined"] += 1
            self._note_error("push_refused", "quarantined", self._seq)
            return False
        seq = self._seq
        self._seq += 1
        sent = _tree_stats(data)     # reused for every unmangled copy
        want = sent[1]
        for attempt in range(1, self.policy.max_attempts + 1):
            accepted = False
            for d in self._transmit("payload", data):
                if d.late_ticks > self.policy.timeout_ticks:
                    h["late_dropped"] += 1    # arrives after the resend window
                    continue
                if d.late_ticks:
                    h["late_deliveries"] += 1
                if seq in self._seen:         # duplicate of an acked payload
                    h["dup_discarded"] += 1
                    accepted = True
                    continue
                finite, got = sent if d.obj is data else _tree_stats(d.obj)
                if not finite:
                    h["nan_rejected"] += 1
                    self._note_error("payload_nack", "non-finite payload", seq)
                    continue
                if not _checksums_match(got, want):
                    h["corrupt_rejected"] += 1
                    self._note_error("payload_nack",
                                     "payload checksum mismatch", seq)
                    continue
                self._seen.add(seq)
                self.offloader.push(d.obj)
                accepted = True
            if accepted:
                h["delivered"] += 1
                self._record("delivered", seq=seq, attempts=attempt)
                return True
            h["send_retries"] += 1
            h["backoff_s"] += self.policy.wait(attempt, self._rng)
        self.dead_letters.append(DeadLetter(
            self.user, seq, "payload", "send retries exhausted",
            self.policy.max_attempts, data))
        h["dead_letters"] += 1
        self._note_error("dead_letter", "send retries exhausted", seq)
        return False

    # -- fit round: offload device -> server --------------------------------
    def _snapshot(self):
        off = self.offloader
        return (off.adapters, off.opt_state,
                {k: list(v) for k, v in off.buffers.items()}, off._pushes)

    def _restore(self, snap) -> None:
        off = self.offloader
        off.adapters, off.opt_state = snap[0], snap[1]
        off.buffers.clear()
        off.buffers.update({k: list(v) for k, v in snap[2].items()})
        off._pushes = snap[3]

    def _validate_bank(self, bank) -> str | None:
        finite, norm = _bank_stats(bank, self.last_good)
        if not finite:
            return "non-finite adapter update"
        if norm > self.max_update_norm:
            return f"update norm {norm:.3g} > {self.max_update_norm:.3g}"
        return None

    def fit_round(self) -> dict | None:
        """Run the offloaded fit (if due) under timeout, retry and
        validation.

        Returns the newly committed bank, or None (not due, or the round
        failed: the offloader is then rolled back to the last-good bank and,
        after ``quarantine_after`` failed rounds in a row, the user is
        quarantined).
        """
        if self.quarantined or not self.offloader.ready:
            return None
        t0 = time.perf_counter()
        with self._span("channel.fit_round", user=self.user, seq=self._seq,
                        version=self.version):
            out = self._fit_round(t0)
        if self.tm is not None:
            self.tm.registry.histogram("channel.fit_round_s").observe(
                time.perf_counter() - t0)
        return out

    def _fit_round(self, t0: float) -> dict | None:
        h = self.health_counters
        snap = self._snapshot()
        failure = "unknown"
        for attempt in range(1, self.policy.max_attempts + 1):
            h["fit_attempts"] += 1
            try:
                new = call_with_timeout(self.offloader.maybe_fit,
                                        self.policy.timeout_s)
            except FitTimeout:
                h["fit_timeouts"] += 1
                failure = "fit timeout"
                self._note_error("fit_timeout", failure, self._seq)
                self._restore(snap)
                h["backoff_s"] += self.policy.wait(attempt, self._rng)
                continue
            except Exception as e:  # numerical failure on the fit device
                h["fit_errors"] += 1
                failure = f"fit error: {e}"
                self._note_error("fit_error", failure, self._seq)
                self._restore(snap)
                h["backoff_s"] += self.policy.wait(attempt, self._rng)
                continue
            if new is None:       # raced interval gating; nothing due
                return None
            delivered = None
            for d in self._transmit("adapters", new):
                if d.late_ticks > self.policy.timeout_ticks:
                    h["late_dropped"] += 1
                    continue
                if d.late_ticks:
                    h["late_deliveries"] += 1
                delivered = d.obj if delivered is None else delivered
            if delivered is None:
                failure = "adapter return dropped"
                h["send_retries"] += 1
                self._note_error("fit_nack", failure, self._seq)
                self._restore(snap)    # the refit is deterministic
                h["backoff_s"] += self.policy.wait(attempt, self._rng)
                continue
            reason = self._validate_bank(delivered)
            if reason is not None:
                h["fit_rejected"] += 1
                failure = reason
                self._note_error("fit_rejected", failure, self._seq)
                self._restore(snap)
                h["backoff_s"] += self.policy.wait(attempt, self._rng)
                continue
            # commit: bump version, snapshot last-good
            self.offloader.adapters = delivered
            self.version += 1
            self.last_good = delivered
            self._fail_streak = 0
            h["fits_committed"] += 1
            self._record("commit", version=self.version, attempts=attempt,
                         fit_s=time.perf_counter() - t0)
            if self.on_commit is not None:
                self.on_commit(self.user, self.version, delivered)
            return delivered
        # round failed: roll back to last-good, drop the round's data
        self._restore(snap)
        self.offloader.buffers.clear()
        self.dead_letters.append(DeadLetter(
            self.user, self._seq, "fit", failure, self.policy.max_attempts))
        h["dead_letters"] += 1
        h["rollbacks"] += 1
        self._fail_streak += 1
        self._note_error("rollback", failure, self._seq)
        if self.tm is not None:
            if self._fail_streak >= self.quarantine_after:
                # quarantine is terminal for the user: freeze the evidence
                self._record("quarantine", reason=failure,
                             fail_streak=self._fail_streak)
                self.tm.dump("user", self.user,
                             f"quarantined after {self._fail_streak} failed "
                             f"fit rounds: {failure}")
            else:
                self.tm.dump("user", self.user, f"fit rollback: {failure}")
        if self._fail_streak >= self.quarantine_after:
            self.quarantined = True
        return None

    # -- recovery (watchdog hook) -------------------------------------------
    def reset(self) -> None:
        """Channel reset after external recovery (a straggler or hang
        checkpoint): drop in-flight buffers, restore the last-good bank, lift
        quarantine. Re-asserting the last-good bank also fences off a zombie
        fit: a timed-out ``maybe_fit`` keeps running on its abandoned worker
        thread and may have changed the offloader after the rollback."""
        self.offloader.buffers.clear()
        self.offloader.adapters = self.last_good
        self.quarantined = False
        self._fail_streak = 0
        self._record("reset", version=self.version)
