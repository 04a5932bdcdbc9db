"""Deterministic fault injection and the retry policy of the FTaaS offload
channel (the JAX package's ``runtime/faults.py``).

ColA offloads the gradient fit to low-cost devices, which drop, delay,
corrupt and duplicate payloads. This module models that transport so the
``OffloadChannel`` (``repro_torch.core.channel``) can be driven through
every failure mode reproducibly:

- ``FaultProfile``  : per-user fault probabilities (drop / delay / corrupt /
                      duplicate / NaN-poison), applied to tap payloads and to
                      returned adapter banks.
- ``FaultInjector`` : seeded per-user numpy streams, drawn with the same calls
                      in the same order as the JAX package's, so a seed gives
                      the same faults and the same counters in both packages
                      (on f32 leaves; see ``_poison_tree`` for bf16).
- ``RetryPolicy``   : bounded retries with exponential backoff and jitter, a
                      wall-clock timeout for offloaded fit calls and a virtual
                      ``timeout_ticks`` horizon for delayed deliveries.
- ``DeadLetter``    : record of a payload whose retries were exhausted.

Transit latency is virtual (ticks, so nothing sleeps); compute hangs are
wall-clock: a hung fit is cut off by running it on a worker thread with a
timeout.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.utils import replace_sorted_leaf, sorted_leaves


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Per-user fault probabilities for one direction of the channel.

    Probabilities are evaluated in order drop -> delay -> duplicate; corrupt
    and NaN-poison then (independently) mangle whatever is delivered.
    """
    drop: float = 0.0          # payload lost in transit (no ack)
    delay: float = 0.0         # payload arrives ``delay_ticks`` late
    delay_ticks: int = 1       # lateness of a delayed payload (virtual ticks)
    duplicate: float = 0.0     # payload delivered twice (same sequence id)
    corrupt: float = 0.0       # payload values scrambled in transit
    nan: float = 0.0           # payload poisoned with NaNs
    corrupt_scale: float = 1e6  # magnitude of corruption noise
    targets: tuple[str, ...] = ("payload", "adapters")

    def faulty(self) -> bool:
        return any(p > 0 for p in
                   (self.drop, self.delay, self.duplicate, self.corrupt,
                    self.nan))


# canonical single-fault profiles for the chaos matrix
SINGLE_FAULTS = {
    "drop": FaultProfile(drop=0.4),
    "delay": FaultProfile(delay=0.5, delay_ticks=1),
    "corrupt": FaultProfile(corrupt=0.4),
    "duplicate": FaultProfile(duplicate=0.5),
    "nan": FaultProfile(nan=0.4),
}


@dataclasses.dataclass
class Delivery:
    """One copy of a transmitted object as it arrives at the far end."""
    obj: Any
    late_ticks: int = 0        # 0 = on time


def _poison_tree(tree, rng: np.random.Generator, scale: float | None):
    """Corrupt (scale is not None) or NaN-poison (scale is None) one random
    leaf of a payload tree: a flipped page or a bad DMA, not noise over every
    tensor. The leaf is picked by its index in ``jax.tree.leaves`` order and
    its positions come from the same numpy draws as in the JAX package.

    The mangled leaf is a copy on the leaf's device; the sender's tensor is
    never written, so a resend and the checksum it is held to see clean data.
    Every floating leaf is mangled, bf16 included: the JAX package skips
    bf16 leaves (numpy does not count ``ml_dtypes.bfloat16`` as floating), so
    there its draws stop early and a bf16 "corrupt" or "nan" is a no-op."""
    leaves = sorted_leaves(tree)
    idx = int(rng.integers(len(leaves)))
    leaf = leaves[idx]
    if not torch.is_floating_point(leaf):
        return tree
    bad = leaf.detach().clone(memory_format=torch.contiguous_format)
    flat = bad.view(-1)
    n = max(1, flat.numel() // 8)
    pos = torch.from_numpy(rng.choice(flat.numel(), size=n, replace=False))
    pos = pos.to(flat.device)
    if scale is None:
        flat[pos] = float("nan")
    else:
        flat[pos] = torch.from_numpy(rng.standard_normal(n) * scale).to(
            device=flat.device, dtype=flat.dtype)
    return replace_sorted_leaf(tree, idx, bad)


class FaultInjector:
    """Seeded, per-user fault injection on channel transmissions.

    ``transmit(user, kind, obj)`` returns the list of ``Delivery`` copies
    that reach the far end for this attempt (empty = dropped, two =
    duplicated, possibly mangled). ``kind`` is "payload" (server -> offload
    device) or "adapters" (offload device -> server); a profile only applies
    to kinds listed in its ``targets``. User k's faults are a pure function
    of (seed, k, transmission index), so a faulted user never perturbs a
    healthy one's draws. With ``telemetry``, each injected fault leaves a
    ``fault_injected`` record in the target user's flight-recorder ring.
    """

    def __init__(self, profiles: dict[int, FaultProfile] | None = None, *,
                 default: FaultProfile | None = None, seed: int = 0,
                 telemetry=None):
        self.profiles = dict(profiles or {})
        self.default = default or FaultProfile()
        self.seed = seed
        self._rngs: dict[int, np.random.Generator] = {}
        self.injected = {"drop": 0, "delay": 0, "duplicate": 0, "corrupt": 0,
                         "nan": 0}
        # a chaos run's postmortems then show the injected cause right next
        # to the channel's reaction; the numpy draws are untouched, so seeded
        # replays stay exact
        self.tm = telemetry if telemetry else None

    def _note(self, user: int, kind: str, fault: str) -> None:
        if self.tm is not None:
            self.tm.record("user", user, "fault_injected", target=kind,
                           fault=fault)

    def profile(self, user: int) -> FaultProfile:
        return self.profiles.get(user, self.default)

    def _rng(self, user: int) -> np.random.Generator:
        if user not in self._rngs:
            self._rngs[user] = np.random.default_rng(
                np.random.SeedSequence((self.seed, user)))
        return self._rngs[user]

    def transmit(self, user: int, kind: str, obj: Any) -> list[Delivery]:
        prof = self.profile(user)
        if kind not in prof.targets or not prof.faulty():
            return [Delivery(obj)]
        rng = self._rng(user)
        r = rng.random()
        if r < prof.drop:
            self.injected["drop"] += 1
            self._note(user, kind, "drop")
            return []
        late = 0
        if r < prof.drop + prof.delay:
            self.injected["delay"] += 1
            self._note(user, kind, "delay")
            late = prof.delay_ticks
        copies = 1
        if rng.random() < prof.duplicate:
            self.injected["duplicate"] += 1
            self._note(user, kind, "duplicate")
            copies = 2
        if rng.random() < prof.corrupt:
            self.injected["corrupt"] += 1
            self._note(user, kind, "corrupt")
            obj = _poison_tree(obj, rng, prof.corrupt_scale)
        if rng.random() < prof.nan:
            self.injected["nan"] += 1
            self._note(user, kind, "nan")
            obj = _poison_tree(obj, rng, None)
        return [Delivery(obj, late_ticks=late) for _ in range(copies)]


# ---------------------------------------------------------------------------
# retry policy + dead letters
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeadLetter:
    user: int
    seq: int
    kind: str          # "payload" | "fit"
    reason: str
    attempts: int
    payload: Any = None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff + jitter.

    ``timeout_s`` bounds one offloaded *fit* call (wall clock; the call runs
    on a worker thread and is abandoned on timeout). ``timeout_ticks`` bounds
    how late a delayed *delivery* may arrive and still be accepted. Backoff
    sleeps go through ``sleep``, which tests replace with a no-op.
    """
    max_attempts: int = 4
    timeout_s: float | None = None
    timeout_ticks: int = 4
    backoff_base: float = 0.01
    backoff_mult: float = 2.0
    backoff_max: float = 1.0
    jitter: float = 0.25
    seed: int = 0
    sleep: Callable[[float], None] | None = None

    def backoff(self, attempt: int, rng: np.random.Generator) -> float:
        """Backoff (seconds) before retry ``attempt`` (1-based)."""
        base = min(self.backoff_base * self.backoff_mult ** (attempt - 1),
                   self.backoff_max)
        return float(base * (1.0 + self.jitter * rng.random()))

    def wait(self, attempt: int, rng: np.random.Generator) -> float:
        dt = self.backoff(attempt, rng)
        if self.sleep is not None:
            self.sleep(dt)
        return dt


class FitTimeout(Exception):
    """An offloaded fit exceeded RetryPolicy.timeout_s."""


_EXECUTOR: concurrent.futures.ThreadPoolExecutor | None = None


def call_with_timeout(fn: Callable[[], Any], timeout_s: float | None):
    """Run ``fn`` bounded by ``timeout_s`` (None = unbounded, same thread).

    A timed-out fit keeps running on its worker thread (threads cannot be
    killed) but the channel stops waiting: the hung-RPC pattern. On the card
    the worker's kernels go to its current stream, the device's default
    stream, as the caller's do, so whatever the caller enqueues after the
    result is ordered after the fit; the fit must not move to a side stream.
    """
    if timeout_s is None:
        return fn()
    global _EXECUTOR
    if _EXECUTOR is None:
        _EXECUTOR = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="offload-fit")
    fut = _EXECUTOR.submit(fn)
    try:
        return fut.result(timeout=timeout_s)
    except concurrent.futures.TimeoutError as e:
        fut.cancel()
        raise FitTimeout(f"offloaded fit exceeded {timeout_s}s") from e
