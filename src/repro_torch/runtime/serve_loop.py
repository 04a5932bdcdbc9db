"""Batched serving engine with continuous batching and multi-user adapters:
the inference half of FTaaS. One base model, K users' adapters applied per
request inside one batch (multi-LoRA, the ``multi_lora`` kernel's job).

Fixed decode slots. Each slot holds (request, user, position). Admission
drains up to ``admit_batch`` waiting requests per tick into free slots and
prefills them as one right-padded batch through ``model.prefill`` (per-row
user-id adapter routing), scattering each row's KV into its slot
(``model.scatter_prefill_cache``). The first generated token comes from the
prompt's own logits. Every tick then decodes one token for all live slots,
with a (slots,) ``live`` mask so that no step touches another slot's KV.

``prefill_mode="reference"`` feeds prompts token by token through the
live-masked decode step; it is the oracle of the batched path.

Serving at scale:

- ``prefill_chunk=C``: admission only assigns slots; prompts then stream in
  one C-token chunk round per tick, interleaved with decode (Sarathi-style),
  through the multi-token decode step. A request's first token comes from
  its last chunk's logits, and decode bursts are capped at 1 while any slot
  is prefilling.
- Recurrent state (the ssm and hybrid plans, ``model.has_recurrent_state``)
  folds in every input token, so padding must never reach it: the
  unchunked prefill runs each prompt at its exact length (one forward a
  prompt), and a chunk round groups its rows by exact width ``min(C,
  remaining)``, one device call a group in ascending width. Admission
  zeroes a slot's state (its K/V is left alone), which the chunked and the
  reference prefills start from (JAX's engine starts them from the slot's
  last request's state).
- ``kv_layout="paged"`` (requires ``prefill_chunk``): KV lives in a shared
  pool of ``kv_blocks`` blocks of ``kv_block`` positions, addressed through
  the ``BlockPager``'s per-slot block table. Admission reserves a request's
  worst case (or waits, FIFO), ``ensure`` allocates before each device call,
  and retirement releases the slot's blocks. ``max_len`` becomes a virtual
  horizon. The pairs plan's local stack keeps a per-slot ring of
  ``local_window + prefill_chunk - 1`` positions instead of pool blocks.
  Recurrent state is the same in both layouts: on the ssm plan the paged
  layout is bookkeeping only, on the hybrid plan (zamba2) the shared
  block's K/V lives in the pool beside the Mamba2 layers' state.
- ``bank_store="int8"``: the adapter bank is held as int8 codes with per-row
  f32 scales (``quantize_bank``) and dequantised on load in the kernel.
- ``resident_slots=R``: the tiered adapter store (``runtime/adapter_store``)
  holds every user on the host and R rows on the card. Admission pins the
  request's user (or waits when R distinct users are pinned) and makes them
  resident before any device call; every device call routes slots by
  resident row (``_dispatch_bank`` / ``_dispatch_idx``), never by user id.
  ``cluster_threshold`` / ``cluster_mode`` put similar users on one row.

``install_adapters`` hot-swaps one user's adapters (a validated version
bump): in place in the dense bank, or into the store's host tier with a
copy-on-write split off the user's cluster; ``publish_banks`` installs every
channel's newer bank.

Telemetry (``telemetry=Telemetry(...)``): the ``serve.ttft_s``,
``serve.latency_s``, ``serve.decode_tick_s``, ``serve.prefill_chunk_s`` and
``serve.prefill_call_s`` histograms; ``serve.tick`` spans holding
``serve.admit`` / ``serve.prefill_chunk`` / ``serve.decode``, and
``serve.prefill`` / ``serve.bank_install``; per-slot ``admit`` /
``first_token`` / ``retire`` records and per-user ``bank_install`` records;
``telemetry_snapshot()``. Each device span closes after the host has read
the call's tokens back (the sync the tick already has), so it measures the
device work too, not only its launch; telemetry adds no sync of its own.

Ported from the JAX package's ``runtime/serve_loop.py``: the jitted steps
become plain methods, and the ``lax.scan`` burst a host loop that emits the
same tokens.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import gl
from repro_torch.core import taps as taps_lib
from repro_torch.kernels import multi_lora as ml
from repro_torch.models import model as model_lib
from repro_torch.runtime.adapter_store import AdapterStore
from repro_torch.runtime.kv_pager import BlockPager, PagerError
from repro_torch.telemetry import NULL_CONTEXT, annotate
from repro_torch.telemetry.metrics import NULL_METRIC, percentiles
from repro_torch.utils import all_finite, cdiv, resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    user: int
    prompt: np.ndarray          # (P,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # "queued" -> "done" | "rejected: <reason>"
    status: str = "queued"
    # lifecycle timestamps (perf_counter seconds), filled by the engine
    t_submit: float | None = None
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None

    @property
    def ttft(self) -> float | None:
        """Time to first token, from submission."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def latency(self) -> float | None:
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit


def stack_user_adapters(adapter_list: list[dict]) -> dict:
    """K per-user adapter pytrees {tap: {"A": (L?, d, r), "B": ...}} -> multi
    bank {tap: {"A": (L?, U, d, r), ...}} (user axis after any layer axis)."""
    if not adapter_list:
        raise ValueError("stack_user_adapters: need at least one per-user "
                         "adapter pytree, got an empty list")

    def _struct(a: dict) -> dict:
        return {tap: {n: tuple(l.shape) for n, l in sorted(leaves.items())}
                for tap, leaves in a.items()}

    want = _struct(adapter_list[0])
    for u, a in enumerate(adapter_list[1:], start=1):
        got = _struct(a)
        if got != want:
            raise ValueError(
                f"stack_user_adapters: user {u} adapter structure {got} does "
                f"not match user 0 structure {want} (all users must share the "
                "same tap set and leaf shapes)")
    out: dict[str, Any] = {}
    for tap in adapter_list[0]:
        leaves = {}
        for name in adapter_list[0][tap]:
            stacked = torch.stack([a[tap][name] for a in adapter_list], dim=0)
            if adapter_list[0][tap][name].dim() > 2:   # (L, d, r) -> (L, U, d, r)
                stacked = stacked.movedim(0, 1).contiguous()
            leaves[name] = stacked
        out[tap] = leaves
    return out


def quantize_bank(bank: dict) -> dict:
    """f32 multi-user bank -> int8-stored bank: every leaf ``name`` becomes
    ``name_q`` (int8 codes) + ``name_scale`` (per-row f32 scales). The serve
    path then dequantises on load in the kernel (``multi_lora_q8``) and never
    holds a f32 copy of the bank: a quarter of the f32 bank's memory."""
    out: dict[str, Any] = {}
    for tap, leaves in bank.items():
        entry = {}
        for name, leaf in leaves.items():
            q, scale = ml.quant_rows(leaf)
            entry[f"{name}_q"] = q
            entry[f"{name}_scale"] = scale
        out[tap] = entry
    return out


def publish_banks(engine: "ServeEngine", channels) -> int:
    """Install every channel's bank that carries a version bump into the
    engine (the train -> serve hot-swap). A channel is anything with
    ``.user``, ``.version`` and ``.adapters``. With an adapter store, a user
    the engine has never seen is registered into the host tier; without
    one, users outside the dense bank are skipped and counted in
    ``stats["bank_unknown_user"]``. Returns the number of banks installed
    (registrations included)."""
    installed = 0
    for ch in channels:
        if engine.store is not None:
            st = engine.store
            if ((not st.knows(ch.user) or ch.version > st.version(ch.user))
                    and engine.install_adapters(ch.user, ch.adapters,
                                                ch.version)):
                installed += 1
            continue
        if engine.bank_versions is None:
            break
        if not 0 <= ch.user < engine.n_users:
            engine.stats["bank_unknown_user"] += 1
            continue
        if ch.version > int(engine.bank_versions[ch.user]):
            if engine.install_adapters(ch.user, ch.adapters, ch.version):
                installed += 1
    return installed


def _bucket(n: int, floor: int = 8) -> int:
    """Round up to a power of two (>= floor), so prefill batches come in few
    shapes."""
    b = floor
    while b < n:
        b *= 2
    return b


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *, slots: int = 8,
                 max_len: int = 512, user_adapters: list[dict] | None = None,
                 taps: str = "qv", scale: float = 1.0,
                 prefill_mode: str = "batched", admit_batch: int | None = None,
                 bank_store: str = "f32", decode_burst: int = 1,
                 resident_slots: int | None = None,
                 cluster_threshold: float | None = None,
                 cluster_mode: str = "shared",
                 prefill_chunk: int | None = None, kv_layout: str = "dense",
                 kv_block: int = 16, kv_blocks: int | None = None,
                 max_prompt: int | None = None, telemetry=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if cfg.n_codebooks or cfg.embed_input:
            raise ValueError(
                f"{cfg.name}: the engine serves (P,) token prompts, as the "
                "JAX engine does; codebook and embedding inputs go through "
                "model.prefill and model.decode_step")
        if prefill_mode not in ("batched", "reference"):
            raise ValueError(f"prefill_mode={prefill_mode!r}")
        if bank_store not in ("f32", "int8"):
            raise ValueError(f"bank_store={bank_store!r}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout={kv_layout!r}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk={prefill_chunk}")
            if prefill_mode != "batched":
                raise ValueError("chunked prefill requires prefill_mode="
                                 "'batched' (the reference mode exists to "
                                 "oracle the unchunked path)")
        if kv_layout == "paged" and prefill_chunk is None:
            raise ValueError("kv_layout='paged' requires prefill_chunk: the "
                             "unchunked prefill scatters a dense cache, only "
                             "the chunk path writes through the block table")
        if params["embed"]["emb"].device != self.device:
            raise ValueError(f"params live on {params['embed']['emb'].device}, "
                             f"the engine runs on {self.device}")
        # Telemetry is strictly observational: it only reads host-side values
        # after the tick's own device sync, so generated tokens are
        # bit-identical telemetry-on vs. off. The disabled path is
        # `self.tm is None` checks plus NULL_METRIC no-ops.
        self.tm = telemetry if telemetry else None
        _reg = self.tm.registry if self.tm else None
        _hist = (_reg.histogram if _reg is not None
                 else (lambda name: NULL_METRIC))
        self._h_ttft = _hist("serve.ttft_s")
        self._h_latency = _hist("serve.latency_s")
        self._h_decode_tick = _hist("serve.decode_tick_s")
        self._h_prefill_chunk = _hist("serve.prefill_chunk_s")
        self._h_prefill_call = _hist("serve.prefill_call_s")
        if self.tm:
            self.tm.name_thread(0, "serve")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.prefill_mode = prefill_mode
        self.prefill_chunk = prefill_chunk
        # a prompt occupies [0, P) and one decode position must remain below
        # the horizon, so max_prompt can never exceed max_len - 1
        self.max_prompt = (int(max_prompt) if max_prompt is not None
                           else max_len - 1)
        if not 1 <= self.max_prompt <= max_len - 1:
            raise ValueError(f"max_prompt={self.max_prompt} with max_len={max_len}")
        self.admit_batch = admit_batch if admit_batch is not None else slots
        # Burst decoding: up to ``decode_burst`` chained decode ticks per host
        # round trip. Bursts only run when no live slot could complete inside
        # one, so tokens are identical to decode_burst=1.
        self.decode_burst = max(1, int(decode_burst))
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.active: list[Request | None] = [None] * slots
        self.positions = np.zeros(slots, np.int32)
        self.users = np.zeros(slots, np.int32)
        ring_len = None
        self.pager: BlockPager | None = None
        if kv_layout == "paged":
            if kv_blocks is None:   # the dense-equivalent pool
                kv_blocks = slots * cdiv(max_len, kv_block)
            self.pager = BlockPager(kv_blocks, kv_block, slots, max_len,
                                    telemetry=self.tm)
            if model_lib.layer_plan(cfg)[0] == "pairs":
                # local-window ring: the window plus a full chunk's in-flight
                # writes (see models/attention.attention_decode)
                ring_len = (cfg.local_window or max_len) + prefill_chunk - 1
        self.cache = model_lib.init_cache(cfg, slots, max_len,
                                          kv_layout=kv_layout,
                                          kv_blocks=kv_blocks,
                                          kv_block=kv_block, ring_len=ring_len,
                                          device=self.device)
        self._recurrent = model_lib.has_recurrent_state(cfg)
        # the block table on the card, copied again only when it changes
        self._table_host: np.ndarray | None = None
        self._table_dev: torch.Tensor | None = None
        self.spec = None
        self.bank = None
        self.store: AdapterStore | None = None
        self.res_idx = np.zeros(slots, np.int32)   # per-slot resident row
        self.n_users = 0
        self.bank_versions: np.ndarray | None = None
        if user_adapters:
            self.spec = taps_lib.make_spec(family="multi_lowrank",
                                           taps=gl.select_taps(cfg, taps),
                                           scale=scale)
            self.n_users = len(user_adapters)
            if resident_slots is not None:
                # host tier of every user, R rows on the card
                self.store = AdapterStore.from_users(
                    user_adapters, resident=resident_slots, store=bank_store,
                    telemetry=self.tm, device=self.device)
                if cluster_threshold is not None:
                    self.store.build_clusters(cluster_threshold,
                                              mode=cluster_mode)
            else:
                bank = stack_user_adapters(user_adapters)
                if bank_store == "int8":
                    bank = quantize_bank(bank)
                self.bank = {tap: {n: leaf.to(self.device).contiguous()
                                   for n, leaf in e.items()}
                             for tap, e in bank.items()}
                self.bank_versions = np.zeros(self.n_users, np.int64)
        elif resident_slots is not None:
            raise ValueError("resident_slots requires user_adapters (the "
                             "store template comes from the first user)")
        self._decode_tick_s: collections.deque = collections.deque(maxlen=4096)
        self._prefill_s: collections.deque = collections.deque(maxlen=4096)
        self.stats = {"ticks": 0, "tokens": 0, "decode_tokens": 0,
                      "completed": 0, "admitted": 0,
                      "prefill_calls": 0, "prefill_tokens": 0,
                      "prefill_chunks": 0, "chunk_rounds": 0,
                      "decode_time": 0.0, "prefill_time": 0.0, "rejected": 0,
                      "bank_installs": 0, "bank_rejected": 0,
                      "bank_unknown_user": 0,
                      "kv_blocks_in_use": 0, "kv_blocks_peak": 0,
                      "kv_allocs": 0, "kv_frees": 0, "kv_reserve_failures": 0,
                      "store_hits": 0, "store_misses": 0, "store_evictions": 0,
                      "store_hit_rate": 0.0, "store_pinned": 0,
                      "store_resident_bytes": 0, "store_fetch_time": 0.0}

    # -- telemetry ---------------------------------------------------------
    def _span(self, name: str, **args):
        """A serve-lane trace span, or the shared null context when tracing
        is off — cheap enough to leave inline in the tick path."""
        if self.tm is None:
            return NULL_CONTEXT
        return self.tm.span(name, cat="serve", tid=0, **args)

    def _record(self, scope: str, key, kind: str, **fields) -> None:
        if self.tm is not None:
            self.tm.record(scope, key, kind, **fields)

    def telemetry_snapshot(self) -> dict:
        """Sync the stat dicts, absorb them into the metric registry under
        ``serve.*`` / ``store.*`` / ``pager.*`` and return the registry
        snapshot. Empty dict when telemetry is disabled — ``engine.stats``
        stays the always-on authority."""
        if self.tm is None:
            return {}
        self._sync_store_stats()
        self._sync_pager_stats()
        reg = self.tm.registry
        # store_*/kv_* keys are mirrors of the store/pager dicts; absorb the
        # originals under their own namespaces instead of duplicating them
        reg.absorb("serve", {k: v for k, v in self.stats.items()
                             if not k.startswith(("store_", "kv_"))})
        if self.store is not None:
            reg.absorb("store", self.store.metrics())
        if self.pager is not None:
            reg.absorb("pager", self.pager.stats)
        return reg.snapshot()

    # -- device steps --------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _cola_vars(self, users: torch.Tensor) -> dict | None:
        """The multi-LoRA variables of one device call: the dispatch bank and
        ``users``, its row of each batch row."""
        bank = self._dispatch_bank()
        if bank is None:
            return None
        vars_ = {}
        for tap, leaves in bank.items():
            entry = dict(leaves)
            a = leaves["A"] if "A" in leaves else leaves["A_q"]   # int8: A_q
            # stacked (L, U, d, r): idx carries the layer axis too
            entry["idx"] = (users.expand(a.shape[0], -1) if a.dim() == 4
                            else users)
            vars_[tap] = entry
        return {"adapters": vars_}

    def _table(self) -> torch.Tensor | None:
        """The pager's block table on the card; copied only when it changed
        since the last copy (at most once per device call, never per layer)."""
        if self.pager is None:
            return None
        if (self._table_host is None
                or not np.array_equal(self._table_host, self.pager.table)):
            self._table_host = self.pager.table.copy()
            self._table_dev = self._tensor(self._table_host)
        return self._table_dev

    def _step_logits(self, tokens, positions, users, live, lens=None
                     ) -> torch.Tensor:
        """One multi-token decode step for every slot (c == 1: a decode tick;
        c > 1: a chunk round), updating the cache in place. Returns each
        slot's next-token logits (slots, V): at its last position, or with
        ``lens`` at its last real chunk position ``lens - 1``."""
        batch = {"tokens": tokens, "positions": positions}
        logits, self.cache = model_lib.decode_step(
            self.cfg, self.params, batch, self.cache, self.spec,
            self._cola_vars(users), live=live, block_table=self._table())
        if lens is None:
            return logits[:, -1]
        rows = torch.arange(logits.shape[0], device=logits.device)
        return logits[rows, (lens.long() - 1).clamp(min=0)]

    def _decode(self, tokens, positions, users, live) -> torch.Tensor:
        """One decode tick for every slot; returns each slot's argmax token
        (on the device) and updates the slot cache in place."""
        return self._step_logits(tokens, positions, users, live).argmax(
            dim=-1).to(torch.int32)

    def _chunk(self, tokens, positions, users, live, lens) -> torch.Tensor:
        """One prefill chunk round: a (slots, C) token batch through the
        multi-token decode step. ``lens[i]`` is row i's real chunk length
        (the rest is padding, whose cache writes are dropped or later
        overwritten); returns each row's argmax at its last real position,
        which is the request's first token when its prompt just completed."""
        return self._step_logits(tokens, positions, users, live,
                                 lens).argmax(dim=-1).to(torch.int32)

    def _decode_burst(self, tokens, positions, users, live, n: int
                      ) -> torch.Tensor:
        """``n`` chained decode ticks: each feeds its argmax token back as the
        next input and advances live rows' positions. Dead rows keep their
        token and position. Returns the (n, slots) token trace."""
        trace = []
        for _ in range(n):
            nxt = self._decode(tokens, positions, users, live)
            tokens = torch.where(live, nxt, tokens[:, 0])[:, None]
            positions = positions + live.to(positions.dtype)
            trace.append(nxt)
        return torch.stack(trace)

    def _prefill(self, tokens, users, slot_ids: np.ndarray, lengths
                 ) -> torch.Tensor:
        """A padded (J, P) prompt batch through full-sequence prefill; each
        row's KV goes to its slot and its first token (argmax at its true last
        position) is returned. Padding rows carry slot id == slots and are
        dropped by the scatter."""
        logits, pre = model_lib.prefill(self.cfg, self.params,
                                        {"tokens": tokens}, self.spec,
                                        self._cola_vars(users), lengths=lengths)
        model_lib.scatter_prefill_cache(self.cache, pre, slot_ids)
        return logits[:, -1].argmax(dim=-1).to(torch.int32)

    # -- dispatch routing --------------------------------------------------
    # With a store, device calls get the R-row resident bank and resident
    # rows; without one, the dense bank and user ids.
    def _dispatch_bank(self) -> dict | None:
        return self.store.bank if self.store is not None else self.bank

    def _dispatch_idx(self) -> np.ndarray:
        """Every slot's bank row, checked on the host (no device sync) to lie
        inside the bank: the multi-LoRA kernels clamp a row past the end to
        the last one and take a negative one as padding, so a wrong row
        would serve another user's adapters, or none, without an error."""
        if self.store is not None:
            idx, rows = self.res_idx, self.store.resident
        else:
            idx, rows = self.users, self.n_users
        if self._dispatch_bank() is not None:
            bad = np.flatnonzero((idx < 0) | (idx >= rows))
            if bad.size:
                i = int(bad[0])
                raise RuntimeError(f"slot {i}: bank row {int(idx[i])} is "
                                   f"outside the bank's {rows} rows")
        return idx

    # -- engine ------------------------------------------------------------
    def _validate(self, req: Request) -> str | None:
        if len(req.prompt) == 0:
            return "empty prompt"
        if len(req.prompt) > self.max_prompt:
            return (f"prompt length {len(req.prompt)} > max_prompt "
                    f"{self.max_prompt} (horizon max_len={self.max_len})")
        if req.max_new <= 0:
            return f"max_new must be positive, got {req.max_new}"
        if self.store is not None:
            if not self.store.knows(req.user):
                return (f"unknown user {req.user} (store has "
                        f"{len(self.store.users())})")
        elif self.bank is not None and not 0 <= req.user < self.n_users:
            return f"unknown user {req.user} (bank has {self.n_users})"
        return None

    def submit(self, req: Request) -> None:
        """Queue a request, or reject it with a terminal status (a bad
        request never crashes a tick or occupies a slot)."""
        req.t_submit = time.perf_counter()
        reason = self._validate(req)
        if reason is not None:
            req.status = f"rejected: {reason}"
            req.done = True
            req.t_done = req.t_submit
            self.stats["rejected"] += 1
            self.finished.append(req)
            return
        self.queue.append(req)

    # -- adapter bank lifecycle ---------------------------------------------
    def install_adapters(self, user: int, adapters: dict, version: int) -> bool:
        with self._span("serve.bank_install", user=user, version=version):
            ok = self._install_adapters(user, adapters, version)
        self._record("user", user, "bank_install", version=version, ok=ok)
        return ok

    def _install_adapters(self, user: int, adapters: dict, version: int
                          ) -> bool:
        """Hot-swap one user's adapters into the serving bank. Takes only a
        validated version bump: the version must exceed the user's installed
        one, every leaf must be finite and the tree must have the bank's
        taps, leaves and shapes; anything else is rejected and the user keeps
        serving their last good adapters. Returns whether it was installed.

        The dense bank's row is written in place (on the current stream, so
        behind any step already enqueued). With a store, the commit lands in
        the host tier (registering a user new to it); a clustered user is
        split off their cluster (copy-on-write) without touching the other
        members, and a resident user's row is refreshed in place."""
        if self.store is not None:
            return self._install_store(user, adapters, version)
        if self.bank is None or not 0 <= user < self.n_users:
            self.stats["bank_rejected"] += 1
            return False
        if version <= int(self.bank_versions[user]):
            self.stats["bank_rejected"] += 1   # stale or replayed update
            return False
        if not all_finite(adapters) or set(adapters) != set(self.bank):
            self.stats["bank_rejected"] += 1   # poisoned, or the wrong taps
            return False
        writes = []
        for tap, entry in self.bank.items():
            for name, leaf in adapters[tap].items():
                leaf = leaf.detach()
                if f"{name}_q" in entry:       # int8 bank: codes and scales
                    q, scale = ml.quant_rows(leaf)
                    pairs = ((f"{name}_q", q), (f"{name}_scale", scale))
                else:
                    pairs = ((name, leaf),)
                for key, new in pairs:
                    stacked = entry.get(key)
                    row = (None if stacked is None else stacked[:, user]
                           if stacked.dim() > 3 else stacked[user])
                    if row is None or new.shape != row.shape:
                        self.stats["bank_rejected"] += 1   # wrong leaves
                        return False
                    writes.append((row, new))
        for row, new in writes:   # every leaf checked first: all or nothing
            row.copy_(new)
        self.bank_versions[user] = version
        self.stats["bank_installs"] += 1
        return True

    def _install_store(self, user: int, adapters: dict, version: int) -> bool:
        """The store's install: a host-tier commit and an in-place refresh of
        the user's resident row. An unknown user is registered; a known user
        needs a version bump. Every leaf must be finite."""
        st = self.store
        if not all_finite(adapters):
            self.stats["bank_rejected"] += 1   # poisoned bank
            return False
        try:
            if not st.knows(user):
                st.register(user, adapters, version=version)
            else:
                if version <= st.version(user):
                    self.stats["bank_rejected"] += 1   # stale or replayed
                    return False
                st.install(user, adapters, version)
        except ValueError:   # the wrong taps or leaf shapes for this store
            self.stats["bank_rejected"] += 1
            return False
        self.stats["bank_installs"] += 1
        # A split moves the user onto a new host entry while their live slots
        # still point at the cluster's row: re-resolve residency now if a row
        # is free or evictable, else their requests in flight finish on the
        # old adapters and residency is refreshed at the next admission.
        live = [i for i, r in enumerate(self.active)
                if r is not None and r.user == user]
        if live:
            try:
                row = st.ensure_resident([user])[0]
            except RuntimeError:
                pass
            else:
                for i in live:
                    self.res_idx[i] = row
        return True

    def _admit(self) -> None:
        """Admit up to ``admit_batch`` waiting requests into free slots and
        prefill them (one padded batch, or token by token in reference mode).
        Each request's first token comes from its prompt's own logits."""
        admitted: list[int] = []
        now = time.perf_counter()
        for i in range(self.slots):
            if len(admitted) >= self.admit_batch or not self.queue:
                break
            if self.active[i] is not None:
                continue
            req = self.queue[0]
            if (self.pager is not None
                    and not self.pager.reserve(i, self._reserve_len(req))):
                # pool pressure: admission waits (FIFO) until retirements
                # return enough blocks to back this request's worst case
                break
            if self.store is not None and not self.store.acquire(req.user):
                # every resident row is pinned by a distinct live user:
                # admission waits (FIFO) until a request completes
                if self.pager is not None:
                    self.pager.release(i)   # roll back the reservation
                break
            self.queue.pop(0)
            req.t_admit = now
            req._consumed = 0
            self.active[i] = req
            self.users[i] = req.user
            self.positions[i] = 0
            admitted.append(i)
        if not admitted:
            return
        if self._recurrent:
            # a reused slot still holds its last request's recurrent state,
            # which the chunked and the token-by-token prefills would start
            # from: a new request starts from zeros. Only the state leaves:
            # a K/V leaf's axis 1 is a pool's block, which another slot may
            # own, and a dense slot's stale K/V is never read (a request
            # writes position p before it attends to it)
            for leaves in self.cache.values():
                for name, leaf in leaves.items():
                    if name in ("conv", "ssm"):
                        for i in admitted:
                            leaf[:, i].zero_()
        if self.store is not None:
            # fetch on admission: resident before any device call reads it
            rows = self.store.ensure_resident(
                [self.active[i].user for i in admitted])
            self.res_idx[admitted] = rows
        self.stats["admitted"] += len(admitted)
        for i in admitted:
            r = self.active[i]
            self._record("slot", i, "admit", rid=r.rid, user=r.user,
                         prompt_len=len(r.prompt))
        if self.prefill_chunk is not None:
            return   # chunk rounds (one per tick) do the prefill work
        rows = [(i, np.asarray(self.active[i].prompt, np.int32))
                for i in admitted]
        t0 = time.perf_counter()
        if self.prefill_mode == "reference":
            for i, feed in rows:
                nxt = 0
                for t, tok in enumerate(feed):
                    nxt = self._feed(i, int(tok), t)
                self._first_token(i, nxt, time.perf_counter())
        else:
            # the span closes after _prefill_batch has read the first tokens
            # back to the host: it holds the device work, not just its launch
            with self._span("serve.prefill", rows=len(rows)):
                self._prefill_batch(rows)
        dt = time.perf_counter() - t0
        self.stats["prefill_time"] += dt
        self._prefill_s.append(dt)
        self._h_prefill_call.observe(dt)
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += sum(len(f) for _, f in rows)
        now = time.perf_counter()
        for i, _ in rows:
            if self.active[i] is not None:
                self._maybe_finish(i, now)

    def _prefill_batch(self, rows: list[tuple[int, np.ndarray]]) -> None:
        if self._recurrent:
            # recurrent state folds in every token, so a right-padded batch
            # would pollute the shorter rows' state: one exact-length
            # forward a prompt
            idx = self._dispatch_idx()
            for i, feed in rows:
                nxt = self._prefill(self._tensor(feed[None, :]),
                                    self._tensor(idx[i:i + 1]),
                                    np.array([i], np.int32),
                                    self._tensor(np.array([len(feed)],
                                                          np.int32)))
                self._first_token(i, int(nxt.cpu()[0]), time.perf_counter())
            return
        # Pad-token KV beyond a row's true length is safe (decode overwrites
        # position p before attending; causality hides > p), so shapes are
        # bucketed to powers of two. The bucket never exceeds max_len.
        pmax = min(_bucket(max(len(feed) for _, feed in rows)), self.max_len)
        j = _bucket(len(rows), floor=1)
        toks = np.zeros((j, pmax), np.int32)
        users = np.zeros((j,), np.int32)
        lengths = np.ones((j,), np.int32)
        slot_ids = np.full((j,), self.slots, np.int32)   # padding -> dropped
        idx = self._dispatch_idx()
        for r, (i, feed) in enumerate(rows):
            toks[r, :len(feed)] = feed
            users[r] = idx[i]
            slot_ids[r] = i
            lengths[r] = len(feed)
        nxt = self._prefill(self._tensor(toks), self._tensor(users), slot_ids,
                            self._tensor(lengths)).cpu().numpy()
        now = time.perf_counter()
        for r, (i, _) in enumerate(rows):
            self._first_token(i, int(nxt[r]), now)

    def _feed(self, slot: int, token: int, pos: int) -> int:
        """Reference single-row prefill step: decode one prompt token into one
        slot's cache (the live mask confines the write to ``slot``) and return
        the argmax token."""
        toks = np.zeros((self.slots, 1), np.int32)
        toks[slot, 0] = token
        positions = np.zeros((self.slots,), np.int32)
        positions[slot] = pos
        live = np.zeros((self.slots,), bool)
        live[slot] = True
        nxt = self._decode(self._tensor(toks), self._tensor(positions),
                           self._tensor(self._dispatch_idx()),
                           self._tensor(live))
        return int(nxt[slot])

    def _first_token(self, i: int, tok: int, now: float) -> None:
        """Record a request's first generated token and arm the slot for
        decode: the next tick feeds this token at position P."""
        req = self.active[i]
        req.t_first = now
        req.out.append(tok)
        req._last = tok
        req._consumed = len(req.prompt)   # prompt fully in cache: decode-live
        self.positions[i] = len(req.prompt)
        self.stats["tokens"] += 1
        self._h_ttft.observe(now - req.t_submit)
        self._record("slot", i, "first_token", rid=req.rid, user=req.user,
                     ttft=now - req.t_submit)

    def _maybe_finish(self, i: int, now: float) -> None:
        req = self.active[i]
        if (len(req.out) >= req.max_new
                or self.positions[i] >= self.max_len - 1):
            self._retire(i, now)

    def _retire(self, i: int, now: float) -> None:
        req = self.active[i]
        req.done = True
        req.status = "done"
        req.t_done = now
        self.stats["completed"] += 1
        if req.latency is not None:
            self._h_latency.observe(req.latency)
        self._record("slot", i, "retire", rid=req.rid, user=req.user,
                     new_tokens=len(req.out))
        self.finished.append(req)
        self.active[i] = None
        self.positions[i] = 0
        if self.pager is not None:
            self.pager.release(i)
        if self.store is not None:
            self.store.release(req.user)

    def _reserve_len(self, req: Request) -> int:
        """Worst-case positions ``req`` can ever write on its slot: the
        chunk-padded prompt (chunk rounds write width-C tails) or the decode
        horizon, whichever is larger, clipped to max_len. Reserving this at
        admission means a mid-flight ``ensure`` never fails."""
        P = len(req.prompt)
        C = self.prefill_chunk or P
        padded = -(-P // C) * C
        return min(self.max_len, max(padded, P + req.max_new))

    def _chunk_round(self) -> list[int]:
        """Advance every mid-prefill slot by one chunk (exactly one round per
        tick, so a long prompt costs each decode tick at most one chunk of
        extra model work): as one width-C padded group, or, with recurrent
        state, one group of each exact width ``min(C, remaining)`` in
        ascending order, so padding never reaches the state. Returns the
        slots that were mid-prefill at entry."""
        pend = [i for i, r in enumerate(self.active)
                if r is not None and r._consumed < len(r.prompt)]
        if not pend:
            return pend
        C = self.prefill_chunk
        t0 = time.perf_counter()
        if self._recurrent:
            groups: dict[int, list[int]] = {}
            for i in pend:
                req = self.active[i]
                groups.setdefault(min(C, len(req.prompt) - req._consumed),
                                  []).append(i)
            todo = sorted(groups.items())
        else:
            todo = [(C, pend)]
        for width, group in todo:
            self._chunk_group(width, group)
        self.stats["chunk_rounds"] += 1
        dt = time.perf_counter() - t0
        self.stats["prefill_time"] += dt
        self._prefill_s.append(dt)
        self._h_prefill_chunk.observe(dt)
        return pend

    def _chunk_group(self, width: int, group: list[int]) -> None:
        """One device call of a chunk round: the next ``width`` (or fewer)
        prompt tokens of every slot in ``group``; a slot whose prompt
        completes gets its first token."""
        toks = np.zeros((self.slots, width), np.int32)
        lens = np.ones((self.slots,), np.int32)
        live = np.zeros((self.slots,), bool)
        pos = np.zeros((self.slots,), np.int32)
        for i in group:
            req = self.active[i]
            c = min(width, len(req.prompt) - req._consumed)
            toks[i, :c] = req.prompt[req._consumed:req._consumed + c]
            lens[i] = c
            live[i] = True
            pos[i] = req._consumed
            if self.pager is not None and not self.pager.ensure(
                    i, min(req._consumed + width - 1, self.max_len - 1)):
                raise PagerError(f"slot {i}: its admission reservation does "
                                 "not cover its prompt")
        nxt = self._chunk(self._tensor(toks), self._tensor(pos),
                          self._tensor(self._dispatch_idx()),
                          self._tensor(live), self._tensor(lens)).cpu().numpy()
        now = time.perf_counter()
        for i in group:
            req = self.active[i]
            c = min(width, len(req.prompt) - req._consumed)
            req._consumed += c
            self.stats["prefill_tokens"] += c
            if req._consumed >= len(req.prompt):
                self._first_token(i, int(nxt[i]), now)
                self._maybe_finish(i, now)
        self.stats["prefill_chunks"] += len(group)

    def _burst_len(self, live_idx: list[int]) -> int:
        """Largest safe burst: no live slot may complete inside a burst.
        Powers of two."""
        if self.decode_burst <= 1:
            return 1
        bound = self.decode_burst
        for i in live_idx:
            req = self.active[i]
            remaining = min(req.max_new - len(req.out),
                            self.max_len - 1 - int(self.positions[i]))
            bound = min(bound, remaining)
        if bound <= 1:
            return 1
        n = 1
        while n * 2 <= bound:
            n *= 2
        return n

    def tick(self) -> int:
        """One engine iteration: admit, advance mid-prefill slots by one chunk
        (chunked mode), then decode one token (or a burst) for every slot
        whose prompt is fully in cache; bursts are capped at 1 while any slot
        is prefilling. Returns the number of tokens decoded."""
        with self._span("serve.tick", tick=self.stats["ticks"]):
            return self._tick_inner()

    def _tick_inner(self) -> int:
        if self.queue:
            with self._span("serve.admit", queued=len(self.queue)):
                self._admit()
        prefilling: list[int] = []
        if self.prefill_chunk is not None and any(
                r is not None and r._consumed < len(r.prompt)
                for r in self.active):
            # the span closes after the round's tokens are on the host
            with self._span("serve.prefill_chunk"):
                prefilling = self._chunk_round()
        live_idx = [i for i, r in enumerate(self.active)
                    if r is not None and r._consumed >= len(r.prompt)]
        if not live_idx:
            if prefilling:
                self.stats["ticks"] += 1
            self._sync_store_stats()
            self._sync_pager_stats()
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        live = np.zeros((self.slots,), bool)
        for i in live_idx:
            toks[i, 0] = self.active[i]._last
            live[i] = True
        n = 1 if prefilling else self._burst_len(live_idx)
        for i in live_idx if self.pager is not None else ():
            if not self.pager.ensure(
                    i, min(int(self.positions[i]) + n - 1, self.max_len - 1)):
                raise PagerError(f"slot {i}: its admission reservation does "
                                 "not cover its decode horizon")
        args = (self._tensor(toks), self._tensor(self.positions),
                self._tensor(self._dispatch_idx()), self._tensor(live))
        t0 = time.perf_counter()
        # the span and the annotation hold the sync that reads the tokens
        # back: CUDA launches return before the device is done
        with self._span("serve.decode", live=len(live_idx), burst=n), \
                annotate("serve.decode"):
            if n <= 1:
                trace = self._decode(*args)[None]
            else:
                trace = self._decode_burst(*args, n=n)
            trace = trace.cpu().numpy()                      # (n, slots)
        now = time.perf_counter()
        self.stats["decode_time"] += now - t0
        # one sample per tick decoded: a burst's dispatch wall is split evenly
        # so percentiles stay comparable across decode_burst settings
        self._decode_tick_s.append((now - t0) / trace.shape[0])
        self._h_decode_tick.observe((now - t0) / trace.shape[0])
        for step in range(trace.shape[0]):
            for i in live_idx:
                req = self.active[i]
                tok = int(trace[step, i])
                req.out.append(tok)
                req._last = tok
                self.positions[i] += 1
        for i in live_idx:
            self._maybe_finish(i, now)
        self.stats["ticks"] += trace.shape[0]
        self.stats["tokens"] += trace.shape[0] * len(live_idx)
        self.stats["decode_tokens"] += trace.shape[0] * len(live_idx)
        self._sync_store_stats()
        self._sync_pager_stats()
        return trace.shape[0] * len(live_idx)

    def run_until_idle(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.active):
                break
            self.tick()

    # -- stats -------------------------------------------------------------
    def _sync_store_stats(self) -> None:
        """Mirror the adapter store's counters into ``engine.stats``."""
        if self.store is None:
            return
        m = self.store.metrics()
        self.stats["store_hits"] = m["hits"]
        self.stats["store_misses"] = m["misses"]
        self.stats["store_evictions"] = m["evictions"]
        self.stats["store_hit_rate"] = m["hit_rate"]
        self.stats["store_pinned"] = m["pinned"]
        self.stats["store_resident_bytes"] = m["resident_bytes"]
        self.stats["store_fetch_time"] = m["fetch_time"]

    def _sync_pager_stats(self) -> None:
        """Mirror the KV block pool's counters into ``engine.stats``."""
        if self.pager is None:
            return
        p = self.pager.stats
        self.stats["kv_blocks_in_use"] = p["in_use"]
        self.stats["kv_blocks_peak"] = p["peak_in_use"]
        self.stats["kv_allocs"] = p["allocs"]
        self.stats["kv_frees"] = p["frees"]
        self.stats["kv_reserve_failures"] = p["reserve_failures"]

    def kv_cache_bytes(self) -> int:
        """Decode-cache bytes attributable to current load. Dense: every leaf
        in full (the slot cache is the footprint, occupied or not). Paged:
        the pool leaves are charged per block in use, plus the block table,
        and the other leaves (the pairs plan's rings, recurrent state) in
        full, as JAX does; the pools themselves are allocated in full at
        construction."""
        total = pool = 0
        for leaves in self.cache.values():
            for name, leaf in leaves.items():
                nbytes = leaf.numel() * leaf.element_size()
                total += nbytes
                if (self.pager is not None and name in ("k", "v")
                        and leaf.shape[1] == self.pager.n_blocks
                        and leaf.shape[2] == self.pager.block_size):
                    pool += nbytes
        if self.pager is None:
            return total
        per_block = pool // max(self.pager.n_blocks, 1)
        return ((total - pool) + per_block * self.pager.blocks_in_use()
                + self.pager.table.nbytes)

    def request_stats(self) -> list[dict]:
        """Per-completed-request latency metrics (seconds)."""
        return [{"rid": r.rid, "user": r.user, "prompt_len": len(r.prompt),
                 "new_tokens": len(r.out), "ttft": r.ttft,
                 "latency": r.latency} for r in self.finished]

    def throughput(self) -> dict:
        """Aggregate throughput (decode tokens/s excludes prefill) with tail
        percentiles of TTFT, latency and per-dispatch durations."""
        dt = self.stats["decode_time"]
        pt = self.stats["prefill_time"]
        reqs = self.request_stats()
        ttfts = [r["ttft"] for r in reqs if r["ttft"] is not None]
        lats = [r["latency"] for r in reqs if r["latency"] is not None]
        self._sync_store_stats()
        self._sync_pager_stats()
        out = {
            "decode_tok_per_s": (self.stats["decode_tokens"] / dt
                                 if dt else 0.0),
            "prefill_tok_per_s": (self.stats["prefill_tokens"] / pt
                                  if pt else 0.0),
            "mean_ttft": float(np.mean(ttfts)) if ttfts else None,
            "ttft": percentiles(ttfts),
            "latency": percentiles(lats),
            "decode_tick": percentiles(self._decode_tick_s),
            "prefill": percentiles(self._prefill_s),
            "completed": self.stats["completed"],
        }
        if self.store is not None:
            out["store"] = self.store.metrics()
        if self.pager is not None:
            out["kv_blocks_in_use"] = self.pager.blocks_in_use()
            out["kv_blocks_peak"] = self.pager.stats["peak_in_use"]
        return out
