"""Tiered adapter store: a host tier of every user's adapters and an LRU bank
of R resident rows on the card.

A dense stacked bank (``stack_user_adapters``) holds every user on the card,
so the number of users served is capped by device memory. The store
decouples the two:

- **Host tier** (the system of record): one adapter tree per user, as
  contiguous CPU tensors in f32, or int8 codes with per-row f32 scales
  (``kernels.multi_lora.quant_rows``, as ``quantize_bank`` stores them), each
  with a version: the level that ``publish_banks`` installs.
- **Device tier**: a bank of ``R`` rows (R << U) in the layout the
  ``multi_lora`` kernels read, leaves ``(L, R, d, r)`` with the row axis after
  the layer axis, allocated once, plus a user -> resident-row map. Batches
  index adapters by resident row, never by user id, so the bank's memory and
  the kernels' index range are bounded by R.

Residency, as ``ServeEngine`` drives it:

- ``acquire(user)`` pins a user before admission; a pinned user's row is
  never evicted. It refuses when the distinct pinned users would need more
  than R rows, and admission then waits.
- ``ensure_resident(users)`` fetches on admission: a hit touches the LRU
  clock; a miss takes a free row (else evicts the least recently used
  unpinned row) and writes the host entry into it in place, one
  host -> device copy per leaf on the current stream, so the copy queues
  behind any step already enqueued that still reads the row. The bank is
  never rebuilt or restacked, and every leaf stays contiguous.
- ``release(user)`` unpins when a request completes (counted: a user may
  hold several slots).

On top of it, task-similarity clustering: ``build_clusters`` puts users whose
adapters are cosine-similar (float64, on the host) onto one shared entry,
``shared`` (the first member's adapters) or ``merged`` (the members' mean,
``core.merge.merge_adapter_pytrees``), which takes one resident row. The map
is copy-on-write: a member's own ``install`` splits them off onto a private
entry and leaves the cluster's row and its other members as they were.

A multi-LoRA row's result depends only on its own x row and its adapter, so
serving through R resident rows gives the tokens of the all-resident engine.

Ported from the JAX package's ``runtime/adapter_store.py``, with its
telemetry: the ``store.fetch_s`` histogram and a ``store_fetch`` record a
fetch (host time of the row write; no sync is added to make it device time).
"""
from __future__ import annotations

import time
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.kernels import multi_lora as ml
from repro_torch.utils import resolve_device

UserKey = tuple  # ("user", uid) | ("cluster", cid)


# ---------------------------------------------------------------------------
# host-tier encoding
# ---------------------------------------------------------------------------

def _to_host(tree: dict) -> dict:
    """f32 contiguous CPU copies of an adapter tree's leaves (copies: the
    caller's tensors may change later, the host tier must not)."""
    return {tap: {n: l.detach().to("cpu", torch.float32, copy=True)
                  .contiguous() for n, l in leaves.items()}
            for tap, leaves in tree.items()}


def _quantize_host(tree: dict) -> dict:
    """f32 per-user tree -> int8 host entry (codes + per-row scales)."""
    out = {}
    for tap, leaves in _to_host(tree).items():
        entry = {}
        for name, leaf in leaves.items():
            entry[f"{name}_q"], entry[f"{name}_scale"] = ml.quant_rows(leaf)
        out[tap] = entry
    return out


def _dequantize_host(entry: dict) -> dict:
    """int8 host entry -> f32 tree (for similarity vectors and merging)."""
    return {tap: {name: ml.dequant_rows(leaves[f"{name}_q"],
                                        leaves[f"{name}_scale"])
                  for name in sorted({n.rsplit("_", 1)[0] for n in leaves})}
            for tap, leaves in entry.items()}


def _structure(adapters: dict) -> dict:
    return {tap: {n: tuple(l.shape) for n, l in sorted(leaves.items())}
            for tap, leaves in adapters.items()}


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 and nb == 0.0:
        return 1.0          # two untrained (all-zero-delta) users are alike
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def _nbytes(tree: dict) -> int:
    return sum(l.numel() * l.element_size()
               for leaves in tree.values() for l in leaves.values())


class AdapterStore:
    """Host-tier adapter bank with an LRU cache of R resident rows on
    ``device`` (default the card; ``cuda`` raises without one)."""

    def __init__(self, resident: int, *, store: str = "f32", telemetry=None,
                 device="cuda"):
        if resident < 1:
            raise ValueError(f"resident slot count must be >= 1, got {resident}")
        if store not in ("f32", "int8"):
            raise ValueError(f"store={store!r}")
        self.device = resolve_device(device)
        self.resident = int(resident)
        self.store = store
        # observational only: fetch-latency histogram + per-user residency
        # breadcrumbs; `counters` stays the always-on authority
        self.tm = telemetry if telemetry else None
        # host tier: key -> tree of CPU tensors; users route to a key
        self._host: dict[UserKey, dict] = {}
        self._route: dict[int, UserKey] = {}
        self._versions: dict[int, int] = {}
        self._members: dict[int, set[int]] = {}   # cluster id -> member uids
        self._template: dict | None = None        # f32 structure signature
        # device tier
        self.bank: dict | None = None
        self._slot_key: list[UserKey | None] = [None] * self.resident
        self._key_slot: dict[UserKey, int] = {}
        self._last_used: list[int] = [0] * self.resident
        self._clock = 0
        self._pins: dict[int, int] = {}           # uid -> live/queued count
        self.counters = {
            "hits": 0, "misses": 0, "evictions": 0, "fetches": 0,
            "fetch_time": 0.0, "registered": 0, "installs": 0, "splits": 0,
        }

    @classmethod
    def from_users(cls, user_adapters: Sequence[dict], *, resident: int,
                   store: str = "f32", telemetry=None,
                   device="cuda") -> "AdapterStore":
        st = cls(resident, store=store, telemetry=telemetry, device=device)
        for uid, adapters in enumerate(user_adapters):
            st.register(uid, adapters)
        return st

    # -- host tier ---------------------------------------------------------
    def _encode(self, adapters: dict) -> dict:
        return (_to_host(adapters) if self.store == "f32"
                else _quantize_host(adapters))

    def _f32_entry(self, key: UserKey) -> dict:
        entry = self._host[key]
        return entry if self.store == "f32" else _dequantize_host(entry)

    def register(self, user: int, adapters: dict, version: int = 0) -> None:
        """Add (or reset) one user's adapters in the host tier: the entry
        point of a user new to serving. The tree's structure must match the
        store's template (the first user's)."""
        user = int(user)
        struct = _structure(adapters)
        if self._template is None:
            self._template = struct
            self._init_bank(adapters)
        elif struct != self._template:
            raise ValueError(
                f"user {user} adapter structure does not match the store "
                f"template: got {struct}, want {self._template}")
        key: UserKey = ("user", user)
        self._host[key] = self._encode(adapters)
        self._route[user] = key
        self._versions[user] = int(version)
        self.counters["registered"] += 1
        slot = self._key_slot.get(key)
        if slot is not None:     # re-registration of a resident user
            self._write_row(slot, self._host[key])

    def knows(self, user: int) -> bool:
        return int(user) in self._route

    def version(self, user: int) -> int:
        return self._versions[int(user)]

    def users(self) -> list[int]:
        return sorted(self._route)

    def cluster_of(self, user: int) -> int | None:
        key = self._route[int(user)]
        return key[1] if key[0] == "cluster" else None

    # -- device tier -------------------------------------------------------
    def _init_bank(self, adapters: dict) -> None:
        """Allocate the R-row bank once, zeroed, in ``stack_user_adapters``'
        layout: the row axis after a leading layer axis."""
        bank = {}
        for tap, leaves in self._encode(adapters).items():
            entry = {}
            for name, leaf in leaves.items():
                axis = 1 if leaf.dim() > 2 else 0
                shape = leaf.shape[:axis] + (self.resident,) + leaf.shape[axis:]
                entry[name] = torch.zeros(shape, dtype=leaf.dtype,
                                          device=self.device)
            bank[tap] = entry
        self.bank = bank

    def _write_row(self, slot: int, entry: dict) -> None:
        """Write one host entry into resident row ``slot`` in place: one
        host -> device copy per leaf, on the current stream (queued behind
        any enqueued step that still reads the row)."""
        for tap, leaves in self.bank.items():
            for name, leaf in leaves.items():
                row = leaf[:, slot] if leaf.dim() > 3 else leaf[slot]
                row.copy_(entry[tap][name])

    def _pinned_keys(self) -> set[UserKey]:
        return {self._route[u] for u in self._pins}

    def acquire(self, user: int) -> bool:
        """Pin a user ahead of admission. False when the user is unknown or
        pinning them would need more distinct resident rows than exist:
        admission must wait for live requests to complete."""
        user = int(user)
        if user not in self._route:
            return False
        if user in self._pins:
            self._pins[user] += 1
            return True
        pinned = self._pinned_keys()
        if self._route[user] not in pinned and len(pinned) >= self.resident:
            return False
        self._pins[user] = 1
        return True

    def release(self, user: int) -> None:
        user = int(user)
        n = self._pins.get(user, 0)
        if n <= 1:
            self._pins.pop(user, None)
        else:
            self._pins[user] = n - 1

    def pinned_count(self) -> int:
        return len(self._pins)

    def resident_index(self, user: int) -> int | None:
        return self._key_slot.get(self._route[int(user)])

    def ensure_resident(self, users: Iterable[int]) -> np.ndarray:
        """Make every user's adapters resident and return their resident rows
        (int32), evicting least recently used unpinned rows as needed. Raises
        RuntimeError only if every row is pinned by some other user (the
        engine's ``acquire`` gate prevents that)."""
        users = [int(u) for u in users]
        idx = np.zeros(len(users), np.int32)
        for j, user in enumerate(users):
            key = self._route[user]
            slot = self._key_slot.get(key)
            if slot is None:
                slot = self._fetch(key)
            else:
                self.counters["hits"] += 1
            self._clock += 1
            self._last_used[slot] = self._clock
            idx[j] = slot
        return idx

    def _fetch(self, key: UserKey) -> int:
        self.counters["misses"] += 1
        slot = next((s for s, k in enumerate(self._slot_key) if k is None),
                    None)
        evicted = None
        if slot is None:
            pinned = self._pinned_keys()
            victims = [(self._last_used[s], s)
                       for s, k in enumerate(self._slot_key)
                       if k not in pinned]
            if not victims:
                raise RuntimeError(
                    "adapter store: no evictable resident row (all "
                    f"{self.resident} rows pinned by live users)")
            _, slot = min(victims)
            evicted = self._slot_key[slot]
            del self._key_slot[evicted]
            self.counters["evictions"] += 1
        t0 = time.perf_counter()
        self._write_row(slot, self._host[key])
        dt = time.perf_counter() - t0
        self.counters["fetch_time"] += dt
        self.counters["fetches"] += 1
        if self.tm is not None:
            self.tm.registry.histogram("store.fetch_s").observe(dt)
            self.tm.record("user", key[1], "store_fetch", row=int(slot),
                           evicted=str(evicted) if evicted else None,
                           fetch_s=dt)
        self._slot_key[slot] = key
        self._key_slot[key] = slot
        return slot

    # -- adapter updates (train -> serve) ----------------------------------
    def install(self, user: int, adapters: dict, version: int) -> None:
        """Commit one user's new adapters into the host tier (and their
        resident row, if any). A clustered user is split off their cluster
        first (copy-on-write): the cluster entry and every other member are
        untouched. Version and finiteness gating is the caller's job
        (``ServeEngine.install_adapters``); the structure is checked here."""
        user = int(user)
        if user not in self._route:
            self.register(user, adapters, version=version)
            return
        struct = _structure(adapters)
        if struct != self._template:
            raise ValueError(
                f"user {user} install structure does not match the store "
                f"template: got {struct}, want {self._template}")
        if self._route[user][0] == "cluster":
            self.split(user)
        key = self._route[user]
        self._host[key] = self._encode(adapters)
        self._versions[user] = int(version)
        self.counters["installs"] += 1
        slot = self._key_slot.get(key)
        if slot is not None:
            self._write_row(slot, self._host[key])

    def split(self, user: int) -> None:
        """Copy-on-write split: route a cluster member back onto their own
        host entry. The cluster's row (and its other members' serving) is
        untouched; the user's residency re-resolves at their next admission
        or install."""
        user = int(user)
        key = self._route[user]
        if key[0] != "cluster":
            return
        self._members[key[1]].discard(user)
        own: UserKey = ("user", user)
        if own not in self._host:
            # the member's own entry was kept as their copy-on-write base; a
            # user first registered into a cluster copies the cluster's entry
            self._host[own] = {tap: dict(leaves)
                               for tap, leaves in self._host[key].items()}
        self._route[user] = own
        self.counters["splits"] += 1

    # -- task-similarity clustering ----------------------------------------
    def _flat_vector(self, user: int) -> np.ndarray:
        entry = self._f32_entry(("user", int(user)))
        return np.concatenate([entry[tap][name].numpy().astype(np.float64)
                               .ravel()
                               for tap in sorted(entry)
                               for name in sorted(entry[tap])])

    def build_clusters(self, threshold: float, mode: str = "shared"
                       ) -> dict[int, list[int]]:
        """Greedy cosine clustering of users' adapters: each user joins the
        first cluster whose representative has similarity >= threshold.
        Clusters of two or more get one shared host entry (``shared``: the
        representative's adapters; ``merged``: the members' mean) and so one
        resident row. Returns {cluster id: members} of those clusters."""
        if mode not in ("shared", "merged"):
            raise ValueError(f"mode={mode!r}")
        if self._pins:
            raise RuntimeError("cannot re-cluster while users are pinned "
                               "(live or queued requests hold rows)")
        from repro_torch.core.merge import merge_adapter_pytrees
        users = sorted(u for u, k in self._route.items() if k[0] == "user")
        vectors = {u: self._flat_vector(u) for u in users}
        groups: list[list[int]] = []
        reps: list[np.ndarray] = []
        for u in users:
            for ci, rep in enumerate(reps):
                if _cosine(vectors[u], rep) >= threshold:
                    groups[ci].append(u)
                    break
            else:
                groups.append([u])
                reps.append(vectors[u])
        next_cid = max(self._members, default=-1) + 1
        out: dict[int, list[int]] = {}
        for members in groups:
            if len(members) < 2:
                continue
            cid, next_cid = next_cid, next_cid + 1
            ckey: UserKey = ("cluster", cid)
            if mode == "shared":
                entry = {tap: dict(leaves) for tap, leaves
                         in self._host[("user", members[0])].items()}
            else:
                entry = self._encode(merge_adapter_pytrees(
                    [self._f32_entry(("user", u)) for u in members]))
            self._host[ckey] = entry
            self._members[cid] = set(members)
            for u in members:
                self._route[u] = ckey
            out[cid] = list(members)
        return out

    # -- metrics -----------------------------------------------------------
    def resident_bytes(self) -> int:
        return 0 if self.bank is None else _nbytes(self.bank)

    def host_bytes(self) -> int:
        return sum(_nbytes(entry) for entry in self._host.values())

    def metrics(self) -> dict:
        out = dict(self.counters)
        touches = out["hits"] + out["misses"]
        out["hit_rate"] = out["hits"] / touches if touches else 0.0
        out["pinned"] = len(self._pins)
        out["resident_users"] = sum(k is not None for k in self._slot_key)
        out["resident_bytes"] = self.resident_bytes()
        out["host_users"] = len(self._route)
        out["host_bytes"] = self.host_bytes()
        out["clusters"] = sum(1 for m in self._members.values() if len(m) > 1)
        return out

    def reset_counters(self) -> None:
        for k, v in self.counters.items():
            self.counters[k] = 0 if isinstance(v, int) else 0.0
