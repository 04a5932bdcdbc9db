"""Paged KV cache block pager: host-side pool accounting for the serving
engine's ``kv_layout="paged"`` cache.

The dense slot cache allocates ``slots x max_len`` KV positions per layer up
front, so HBM scales with the *horizon*, not with the tokens actually held.
The paged layout instead stores KV in a fixed pool of ``n_blocks`` blocks of
``block_size`` positions (one pool row per block, shared by every slot), and
each slot owns an ordered list of blocks covering positions
``[0, len(owned) * block_size)``. The device sees only:

- the per-layer pools ``(L, n_blocks, block_size, K, Dh)`` (model cache leaves;
  every layer stack indexes the *same* block ids along its pool axis), and
- one ``(slots, max_blocks)`` int32 **block table** mapping
  ``(slot, position // block_size) -> pool block id``, copied to the card
  when it changes and read there by the paged decode kernel (and by the
  gather of a chunk round).

The pager itself is pure host bookkeeping (numpy lists and counters), so
allocation never sits on the decode hot path: the engine calls ``ensure``
before launching a tick and only the (tiny) table array crosses to the device.

A copy of the JAX package's ``runtime/kv_pager.py`` (the port imports nothing
of that package), with its flight-recorder hooks (``kv_reserve``,
``kv_reserve_fail``, ``kv_release``, and a postmortem before a
``PagerError``).

Invariants (guarded here and by tests/test_torch_serving_scale.py):

- **Reservation-backed admission.** ``reserve(slot, n)`` claims capacity for a
  request's worst case (prompt + chunk padding + decode horizon) at admission;
  it fails — and the engine keeps the request queued — rather than letting a
  mid-flight ``ensure`` run the pool dry. Allocation draws down the slot's
  reservation, so concurrent slots can never over-commit the pool.
- **Refcounted frees.** Every block carries a refcount (1 while owned; the
  hook for future prefix sharing). ``release`` decrements and returns blocks
  to the free list at zero; a double free or a foreign free raises instead of
  corrupting the free list.
- **No leaks.** ``blocks_in_use == sum(owned)`` always; after every slot is
  released the pool is whole again (``assert_empty``).
- **Live-mask interaction.** Unallocated table entries point at block 0 (a
  valid pool row): reads are masked by position (causality never touches
  positions beyond a slot's allocated prefix) and dead rows' *writes* are
  dropped at the index level (``models.attention.kv_write_plan`` keeps only
  live rows' in-range positions), so a shared pool needs no revert.
"""
from __future__ import annotations

import numpy as np


class PagerError(RuntimeError):
    """Pool accounting violation (double free, foreign free, leak)."""


class BlockPager:
    """Host-side block pool accounting + the device-shippable block table."""

    def __init__(self, n_blocks: int, block_size: int, slots: int,
                 max_len: int, telemetry=None):
        if n_blocks < 1 or block_size < 1:
            raise ValueError(f"need n_blocks >= 1 and block_size >= 1, got "
                             f"{n_blocks}, {block_size}")
        # observational only (flight-recorder breadcrumbs + postmortems on
        # accounting violations); the pager never blocks on it
        self.tm = telemetry if telemetry else None
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.slots = slots
        self.max_blocks = -(-max_len // block_size)   # table width (per slot)
        self._free: list[int] = list(range(n_blocks - 1, -1, -1))
        self._owned: list[list[int]] = [[] for _ in range(slots)]
        self._reserved = np.zeros(slots, np.int64)
        self._refcount = np.zeros(n_blocks, np.int32)
        # unallocated entries point at block 0: always a valid pool row, and
        # never *read* thanks to position masking (see module docstring).
        self.table = np.zeros((slots, self.max_blocks), np.int32)
        self.stats = {"allocs": 0, "frees": 0, "in_use": 0, "peak_in_use": 0,
                      "reserve_failures": 0}

    # -- telemetry ---------------------------------------------------------
    def _record(self, slot: int, kind: str, **fields) -> None:
        if self.tm is not None:
            self.tm.record("slot", slot, kind, **fields)

    def _raise(self, slot, msg: str) -> None:
        """Freeze the offending slot's flight-recorder ring into a postmortem
        before raising — a PagerError is a terminal accounting violation and
        the events leading up to it are the evidence."""
        if self.tm is not None:
            self.tm.record("slot", slot, "pager_error", message=msg)
            self.tm.dump("slot", slot, f"PagerError: {msg}")
        raise PagerError(msg)

    # -- capacity ----------------------------------------------------------
    def blocks_for(self, n_positions: int) -> int:
        """Blocks needed to hold positions [0, n_positions)."""
        return -(-max(n_positions, 0) // self.block_size)

    def free_unreserved(self) -> int:
        return len(self._free) - int(self._reserved.sum())

    def capacity(self, slot: int) -> int:
        """Positions currently backed by allocated blocks for ``slot``."""
        return len(self._owned[slot]) * self.block_size

    # -- reservation -------------------------------------------------------
    def reserve(self, slot: int, n_positions: int) -> bool:
        """Claim capacity for ``n_positions`` total positions on ``slot``
        (on top of blocks it already owns). Returns False — claiming nothing —
        when the pool cannot guarantee it, so admission can wait FIFO."""
        need = self.blocks_for(n_positions) - len(self._owned[slot])
        need = max(need - int(self._reserved[slot]), 0)
        if need > self.free_unreserved():
            self.stats["reserve_failures"] += 1
            self._record(slot, "kv_reserve_fail", need=need,
                         free_unreserved=self.free_unreserved())
            return False
        self._reserved[slot] += need
        self._record(slot, "kv_reserve", blocks=need)
        return True

    # -- alloc / free ------------------------------------------------------
    def ensure(self, slot: int, upto_pos: int) -> bool:
        """Allocate blocks so ``slot`` can hold positions [0, upto_pos].
        Draws down the slot's reservation first; allocation beyond it only
        succeeds while unreserved blocks remain. Returns whether the slot now
        has the capacity."""
        owned = self._owned[slot]
        while self.capacity(slot) <= upto_pos:
            if not self._free:
                return False
            if self._reserved[slot] > 0:
                self._reserved[slot] -= 1
            elif self.free_unreserved() <= 0:
                return False   # every free block is promised to another slot
            blk = self._free.pop()
            self._refcount[blk] += 1
            self.table[slot, len(owned)] = blk
            owned.append(blk)
            self.stats["allocs"] += 1
            self.stats["in_use"] += 1
            self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                            self.stats["in_use"])
        return True

    def release(self, slot: int) -> None:
        """Retire a slot: unref every owned block (freeing at refcount zero)
        and drop any unused reservation. Double/foreign frees raise."""
        for blk in self._owned[slot]:
            if self._refcount[blk] <= 0:
                self._raise(slot, f"double free of block {blk} (slot {slot})")
            self._refcount[blk] -= 1
            if self._refcount[blk] == 0:
                self._free.append(blk)
                self.stats["frees"] += 1
                self.stats["in_use"] -= 1
        self._record(slot, "kv_release", blocks=len(self._owned[slot]))
        self._owned[slot] = []
        self._reserved[slot] = 0
        self.table[slot, :] = 0

    # -- introspection -----------------------------------------------------
    def blocks_in_use(self) -> int:
        return self.stats["in_use"]

    def owned(self, slot: int) -> tuple[int, ...]:
        return tuple(self._owned[slot])

    def assert_empty(self) -> None:
        """Raise unless the pool is whole (no leaked or still-owned blocks)."""
        owned = sum(len(o) for o in self._owned)
        if owned or self.stats["in_use"] != 0:
            self._raise("pool", f"leaked blocks: {owned} still owned, "
                        f"in_use={self.stats['in_use']}")
        if len(self._free) != self.n_blocks:
            self._raise("pool", f"free list holds {len(self._free)} of "
                        f"{self.n_blocks} blocks")
        if int(self._refcount.sum()) != 0:
            self._raise("pool", "nonzero refcounts on an empty pool")
