"""LM assembly: embedding -> a Python loop over the stacked pre-norm blocks
(where JAX has ``lax.scan``) -> final norm -> tied head.

Layer plans (``layer_plan``, as in the JAX package):
- "uniform": one stack of identical blocks ("layers.*" taps), e.g.
  ``smollm-135m``, ``gpt2-small``, the mistrals, and the MoE configs
  ``qwen3-moe-30b-a3b`` (QK-norm) and ``dbrx-132b``, whose blocks route to
  experts and add the switch aux loss to the training loss;
- "pairs": gemma2's alternating local/global layers, two stacks
  ("layers_a.*" local with ``window=local_window``, "layers_b.*" global),
  walked pair by pair; under the paged KV layout the local stack keeps a
  per-slot ring cache instead of pool blocks. Both plans serve and train
  (ColA's taps and deltas on every stack).
Still to be ported (ROADMAP.md A.2-A.4; ``_require_ported`` raises for
each): the SSM plan (A.2), the hybrid plan (A.3), codebooks, ``embed_input``
and an untied head (A.4).

Parameters are the JAX package's pytree as nested dicts of tensors, layer
leaves stacked on a leading (n,) axis per stack.

Entry points: init, forward, loss_fn, prefill, decode_step, init_cache,
scatter_prefill_cache, tap_sites, delta_shape.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.taps import ColaSpec, TapSite
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.utils import (canonical_dtype, cdiv, resolve_device,
                               tree_leaves)


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig):
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        starts = list(range(0, cfg.n_layers, every))
        segs = [(s, min(s + every, cfg.n_layers) - s) for s in starts]
        return ("hybrid", segs)
    if cfg.family == "dense" and cfg.attn_pattern == "local_global":
        return ("pairs", cfg.n_layers // 2)
    kind = "ssm" if cfg.family == "ssm" else "attn"
    return ("uniform", kind)


def _require_ported(cfg: ModelConfig) -> tuple:
    """The plan of ``cfg`` (``layer_plan``) when the port runs it: the
    uniform-attention plan (dense or MoE blocks) and gemma2's local/global
    pairs. Every other plan and architecture feature raises, naming the
    ROADMAP item that ports it, instead of running half-supported."""
    plan = layer_plan(cfg)
    missing = [(f, "A.4") for f in ("n_codebooks", "embed_input")
               if getattr(cfg, f)]
    if plan[0] == "hybrid":
        missing.append(("the hybrid plan", "A.3"))
    elif plan == ("uniform", "ssm"):
        missing.append(("the ssm plan", "A.2"))
    if not cfg.tie_embeddings:
        missing.append(("an untied head", "A.4"))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: " + ", ".join(f"{f} (ROADMAP.md {item})"
                                        for f, item in missing)
            + " not ported yet")
    return plan


def _stacks(cfg: ModelConfig) -> dict[str, int]:
    """The plan's layer stacks and their depths: "layers" for the uniform
    plan, "layers_a" (local) and "layers_b" (global) for the pairs plan."""
    plan = _require_ported(cfg)
    if plan[0] == "pairs":
        return {"layers_a": plan[1], "layers_b": plan[1]}
    return {"layers": cfg.n_layers}


def _walk(cfg: ModelConfig):
    """(stack, layer index, attention window) in the order the layers run:
    the uniform plan's layers in turn; the pairs plan's pairs, layer a with
    ``window=local_window``, then layer b with no window (JAX's
    ``_scan_pairs``)."""
    plan = _require_ported(cfg)
    if plan[0] == "pairs":
        for i in range(plan[1]):
            yield "layers_a", i, cfg.local_window
            yield "layers_b", i, None
    else:
        for i in range(cfg.n_layers):
            yield "layers", i, None


def _layer(tree, i: int):
    """Layer i of a pytree whose leaves carry a leading (L,) axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _subvars(d: dict | None, prefix: str) -> dict:
    if not d:
        return {}
    return {k: v for k, v in d.items() if k.startswith(prefix + ".")}


def _checkpointed(cfg: ModelConfig, fn, needs_grad: bool):
    """``cfg.remat`` for one layer: "full" recomputes the layer in the
    backward (``torch.utils.checkpoint``, non-reentrant), "none" keeps its
    activations. Without autograd there is nothing to recompute."""
    if not needs_grad or cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    raise NotImplementedError(f"remat={cfg.remat!r} is not ported (no config "
                              "uses it)")


# ---------------------------------------------------------------------------
# tap sites
# ---------------------------------------------------------------------------

def delta_shape(cfg: ModelConfig, site: TapSite, batch: int, seq: int
                ) -> tuple:
    """Shape of the Mode-A injected delta of one tap; stacked sites carry the
    layer axis."""
    base = (batch, seq, site.d_out)
    return (site.stacked,) + base if site.stacked else base


def tap_sites(cfg: ModelConfig) -> dict[str, TapSite]:
    """Every tappable Dense site, "<stack>.<site>", stacked over its stack's
    depth: the attention projections, and the gated MLP's where the config
    has one (``d_ff``; the experts carry no taps)."""
    sites = {}
    for prefix, n in _stacks(cfg).items():
        named = [
            ("attn.q", cfg.d_model, cfg.n_heads * cfg.d_head),
            ("attn.k", cfg.d_model, cfg.n_kv_heads * cfg.d_head),
            ("attn.v", cfg.d_model, cfg.n_kv_heads * cfg.d_head),
            ("attn.o", cfg.n_heads * cfg.d_head, cfg.d_model),
        ]
        if cfg.d_ff:
            named += [("mlp.gate", cfg.d_model, cfg.d_ff),
                      ("mlp.up", cfg.d_model, cfg.d_ff),
                      ("mlp.down", cfg.d_ff, cfg.d_model)]
        for nm, din, dout in named:
            sites[f"{prefix}.{nm}"] = TapSite(f"{prefix}.{nm}", din, dout, n)
    return sites


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters with the JAX package's shapes, scales and dtypes,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from ``jax.random``'s; tests carry JAX weights across with
    ``convert.params_from_numpy`` instead). Expert leaves are drawn a layer
    at a time (``normal_by_layer``); every other leaf in one draw."""
    stacks = _stacks(cfg)
    dev = resolve_device(device)
    dt = canonical_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * std).to(dt)

    def normal_by_layer(shape, std):
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            out[i] = torch.randn(shape[1:], generator=gen, device=dev,
                                 dtype=torch.float32).mul_(std)
        return out

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=dt, device=dev)}

    d = cfg.d_model
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head

    def stack(n):
        def dense(d_in, d_out):
            return {"w": normal((n, d_in, d_out), d_in ** -0.5)}

        attn = {"q": dense(d, hq), "k": dense(d, hkv), "v": dense(d, hkv),
                "o": dense(hq, d)}
        if cfg.qk_norm:
            attn["q_norm"] = ones(n, cfg.d_head)
            attn["k_norm"] = ones(n, cfg.d_head)
        p = {"ln1": ones(n, d), "attn": attn, "ln2": ones(n, d)}
        if cfg.n_experts:
            p["moe"] = M.moe_init(n, d, cfg.n_experts, cfg.d_expert,
                                  normal=normal,
                                  normal_by_layer=normal_by_layer)
        else:
            p["mlp"] = {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                        "down": dense(cfg.d_ff, d)}
        if cfg.post_norm:
            p["post_ln1"] = ones(n, d)
            p["post_ln2"] = ones(n, d)
        return p

    params = {"embed": {"emb": normal((cfg.vocab_size, d), 0.02)}}
    for prefix, n in stacks.items():
        params[prefix] = stack(n)
    params["final_norm"] = ones(d)
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Token embeddings in the compute dtype; with ``embed_scale`` times
    sqrt(d_model) rounded to that dtype first (59.75 in bf16 at gemma2's
    3584), as JAX's ``jnp.asarray(d_model ** 0.5, cdt)``."""
    _require_ported(cfg)
    x = L.embed(params["embed"], batch["tokens"]).to(
        canonical_dtype(cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def head_logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied head: h (..., d) -> logits (..., V), in h's dtype (so bf16 at
    full width); ``final_softcap`` takes the tanh in f32 and casts back."""
    logits = h @ params["embed"]["emb"].to(h.dtype).T
    if cfg.final_softcap:
        logits = L.softcap(logits.to(torch.float32),
                           cfg.final_softcap).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------

def _block(cfg: ModelConfig, prefix: str, window: int | None, lp: dict,
           x: torch.Tensor, positions: torch.Tensor, spec, ad_l: dict,
           de_l: dict):
    """One layer of stack ``prefix``; returns (x, the MoE aux loss or None,
    (k, v), {tap: hidden input x} collected)."""
    aux: dict = {}
    x, moe_aux, kv = B.attn_block(cfg, lp, x, positions, window=window,
                                  tap_prefix=prefix,
                                  tap_ctx=(spec, ad_l, de_l, aux))
    return x, moe_aux, kv, aux


def hidden_states(cfg: ModelConfig, params: dict, batch: dict,
                  spec: ColaSpec | None = None, cola_vars: dict | None = None,
                  *, collect_kv: bool = False):
    """Embedding + all layers + final norm. Returns (h, aux):
    aux["moe_aux"] is the layers' mean MoE aux loss (0 without experts);
    aux["collected"] holds each collected tap's hidden inputs stacked per
    layer of its stack, {tap: (n, B, S, d_in)}; with ``collect_kv``
    aux["stacked"] holds every layer's k, v per stack,
    {stack: {"k", "v": (n, B, S, K, Dh)}}, written into one tensor as the
    layers run (never a list and a stacked copy at once)."""
    stacks = _stacks(cfg)
    ad = {p: _subvars((cola_vars or {}).get("adapters", {}), p) for p in stacks}
    de = {p: _subvars((cola_vars or {}).get("deltas", {}), p) for p in stacks}
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves([params, cola_vars or {}]))
    layer = _checkpointed(cfg, _block, needs_grad)
    x = embed_tokens(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    kv_out: dict[str, dict] = {}
    collected: dict[str, list] = {}
    moe_aux = []
    for prefix, i, window in _walk(cfg):
        x, layer_aux, (k, v), got = layer(cfg, prefix, window, _layer(params[prefix], i),
                               x, positions, spec, _layer(ad[prefix], i),
                               _layer(de[prefix], i))
        for tap, xin in got.items():
            collected.setdefault(tap, []).append(xin)
        if layer_aux is not None:
            moe_aux.append(layer_aux)
        if collect_kv:
            if prefix not in kv_out:
                kv_out[prefix] = {n: t.new_empty((stacks[prefix],) + t.shape)
                                  for n, t in (("k", k), ("v", v))}
            kv_out[prefix]["k"][i] = k
            kv_out[prefix]["v"][i] = v
    aux: dict[str, Any] = {
        "moe_aux": (torch.stack(moe_aux).mean() if moe_aux else
                    torch.zeros((), dtype=torch.float32, device=x.device)),
        "collected": {t: torch.stack(xs) for t, xs in collected.items()}}
    if collect_kv:
        aux["stacked"] = kv_out
    return L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps,
                     plus_one=cfg.norm_plus_one), aux


def forward(cfg: ModelConfig, params: dict, batch: dict,
            spec: ColaSpec | None = None, cola_vars: dict | None = None):
    h, aux = hidden_states(cfg, params, batch, spec, cola_vars)
    return head_logits(cfg, params, h), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _ce(logits: torch.Tensor, labels: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of CE and count over valid (label >= 0) positions. f32 math."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    valid = labels >= 0
    ce = torch.where(valid, lse - ll, torch.zeros_like(lse))
    return ce.sum(), valid.sum().to(torch.float32)


def lm_loss(cfg: ModelConfig, params: dict, h: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """CE from hidden states; with ``cfg.loss_chunk`` the sequence is taken
    in chunks, so the full (B, S, V) logits tensor never exists at once."""
    S = h.shape[1]
    c = cfg.loss_chunk
    if c and S % c == 0 and S > c:
        tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, S, c):
            s, n = _ce(head_logits(cfg, params, h[:, i:i + c]),
                       labels[:, i:i + c])
            tot, cnt = tot + s, cnt + n
        return tot / cnt.clamp(min=1.0)
    s, n = _ce(head_logits(cfg, params, h), labels)
    return s / n.clamp(min=1.0)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            spec: ColaSpec | None = None, cola_vars: dict | None = None):
    """(mean next-token CE, plus ``aux_loss_coef`` times the MoE aux loss
    where the config has experts; aux) of one batch {"tokens", "labels"}."""
    h, aux = hidden_states(cfg, params, batch, spec, cola_vars)
    loss = lm_loss(cfg, params, h, batch["labels"])
    if cfg.n_experts:
        loss = loss + cfg.aux_loss_coef * aux["moe_aux"]
    return loss, aux


def prefill(cfg: ModelConfig, params: dict, batch: dict,
            spec: ColaSpec | None = None, cola_vars: dict | None = None,
            *, lengths: torch.Tensor | None = None):
    """Full-sequence prefill; returns (logits (B, 1, V), cache) with the
    cache holding every layer's K/V of the processed sequence, per stack.

    ``lengths``: optional (B,) valid prompt lengths of a right-padded batch;
    logits are then taken at position ``lengths - 1`` of each row. Causal
    masking makes every position < lengths[b] independent of the padding.
    """
    h, aux = hidden_states(cfg, params, batch, spec, cola_vars,
                           collect_kv=True)
    if lengths is None:
        h_last = h[:, -1:]
    else:
        idx = (lengths.to(device=h.device, dtype=torch.long) - 1).clamp(min=0)
        h_last = h[torch.arange(h.shape[0], device=h.device), idx][:, None]
    logits = head_logits(cfg, params, h_last)
    return logits, aux["stacked"]


# ---------------------------------------------------------------------------
# caches / decode
# ---------------------------------------------------------------------------

def _ring_stack(cfg: ModelConfig, prefix: str, paged: bool) -> bool:
    """Under the paged layout the pairs plan's local stack keeps rings."""
    return paged and prefix == "layers_a" and layer_plan(cfg)[0] == "pairs"


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, *,
                kv_layout: str = "dense", kv_blocks: int | None = None,
                kv_block: int = 16, ring_len: int | None = None) -> dict:
    """Decode-cache leaf (shape, dtype), per stack.

    ``kv_layout="dense"``: every stack gets an (n, batch, max_len, K, Dh)
    slot cache; memory scales with the horizon.

    ``kv_layout="paged"``: KV lives in a shared block pool
    (n, kv_blocks, kv_block, K, Dh) addressed through a per-slot block table
    (owned by the engine's ``runtime.kv_pager.BlockPager`` and passed to
    ``decode_step(block_table=)``); memory scales with kv_blocks and
    ``max_len`` only sizes the table. ``kv_blocks`` defaults to the
    dense-equivalent pool. The pairs plan's local stack instead gets a
    per-slot ring (half, batch, ring_len, K, Dh) of the last ring_len
    positions; ``ring_len`` (default ``local_window`` or ``max_len``) must be
    >= local_window + chunk - 1 for the chunk widths the caller uses.
    """
    stacks = _stacks(cfg)
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"kv_layout={kv_layout!r}")
    cdt = canonical_dtype(cfg.compute_dtype)
    paged = kv_layout == "paged"
    if paged and kv_blocks is None:
        kv_blocks = batch * cdiv(max_len, kv_block)
    out = {}
    for prefix, n in stacks.items():
        if _ring_stack(cfg, prefix, paged):
            w = ring_len if ring_len is not None else (cfg.local_window
                                                       or max_len)
            shape = (n, batch, w, cfg.n_kv_heads, cfg.d_head)
        elif paged:
            shape = (n, kv_blocks, kv_block, cfg.n_kv_heads, cfg.d_head)
        else:
            shape = (n, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        out[prefix] = {"k": (shape, cdt), "v": (shape, cdt)}
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               kv_layout: str = "dense", kv_blocks: int | None = None,
               kv_block: int = 16, ring_len: int | None = None,
               device="cuda") -> dict:
    dev = resolve_device(device)
    specs = cache_specs(cfg, batch, max_len, kv_layout=kv_layout,
                        kv_blocks=kv_blocks, kv_block=kv_block,
                        ring_len=ring_len)
    return {stack: {n: torch.zeros(shape, dtype=dt, device=dev)
                    for n, (shape, dt) in leaves.items()}
            for stack, leaves in specs.items()}


def decode_step(cfg: ModelConfig, params: dict, batch: dict, cache: dict,
                spec: ColaSpec | None = None, cola_vars: dict | None = None,
                *, live: torch.Tensor | None = None,
                block_table: torch.Tensor | None = None):
    """One incremental step. batch: {"tokens": (B, c), "positions": (B,)}:
    c == 1 is the decode tick, c > 1 one chunk of a chunked prefill (the
    chunk attends to every earlier chunk through the cache). Returns
    (logits (B, c, V), cache).

    The cache is updated in place and returned (the JAX version returns a new
    cache). ``live``: optional (B,) bool mask; non-live slots' cache writes
    are dropped (their logits carry no meaning). ``block_table``:
    (B, max_blocks) int32 selects the paged layout (the cache must come from
    ``init_cache(kv_layout="paged")``): pool stacks are read through the
    table, and the pairs plan's local stack through its per-slot rings, with
    the table's horizon (max_blocks * kv_block) as the rings' virtual one.
    """
    stacks = _stacks(cfg)
    ad = {p: _subvars((cola_vars or {}).get("adapters", {}), p) for p in stacks}
    de = {p: _subvars((cola_vars or {}).get("deltas", {}), p) for p in stacks}
    positions = batch["positions"]
    x = embed_tokens(cfg, params, batch)
    c = x.shape[1]
    # each stack's layout and write plan; one plan per layout and step, never
    # one per layer
    plans: dict[tuple, tuple] = {}
    layouts = {}
    for prefix in stacks:
        width = cache[prefix]["k"].shape[2]   # Smax, W_ring or kv_block
        table = horizon = None
        if _ring_stack(cfg, prefix, block_table is not None):
            kind, kw = "ring", dict(ring=width)
            horizon = block_table.shape[1] * cache["layers_b"]["k"].shape[2]
        elif block_table is not None:
            kind, kw = "paged", dict(block_table=block_table, block=width)
            table = block_table
        else:
            kind, kw = "dense", dict(smax=width)
        if (kind, width) not in plans:
            plans[kind, width] = A.kv_write_plan(positions, c, live, **kw)
        layouts[prefix] = (table, horizon, plans[kind, width])
    for prefix, i, window in _walk(cfg):
        table, horizon, write = layouts[prefix]
        tap_ctx = (spec, _layer(ad[prefix], i), _layer(de[prefix], i), {})
        x = B.attn_block_decode(cfg, _layer(params[prefix], i), x,
                                cache[prefix]["k"][i], cache[prefix]["v"][i],
                                positions, window=window, tap_prefix=prefix,
                                tap_ctx=tap_ctx, live=live, block_table=table,
                                kv_write=write, ring_horizon=horizon)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps,
                  plus_one=cfg.norm_plus_one)
    return head_logits(cfg, params, x), cache


def scatter_prefill_cache(cache: dict, pre: dict, slot_ids) -> dict:
    """Write a prefill cache (rows 0..J-1, sequence length P) into slot
    positions [0, P) of a serving slot cache, in place; returns ``cache``.

    ``slot_ids`` (J,) maps prefill row j -> slot. Out-of-range ids are
    dropped (the JAX ``mode="drop"``), which is how padding rows of a
    bucketed prefill batch are discarded: they are skipped on the host.
    Each kept row is copied on its own, so no gathered copy of the whole
    prefill cache is ever made. Positions >= a row's true prompt length
    receive pad-token KV, which is safe: decode at position p writes the real
    KV at p before attending, and causal masking hides positions > p.
    """
    ids = [int(i) for i in torch.as_tensor(slot_ids).cpu()]
    for stack, leaves in cache.items():
        for name, c in leaves.items():
            p = pre[stack][name]
            for j, slot in enumerate(ids):
                if 0 <= slot < c.shape[1]:
                    c[:, slot, :p.shape[2]].copy_(p[:, j])
    return cache
