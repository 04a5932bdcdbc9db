"""LM assembly for the uniform-attention layer plan (the dense family, e.g.
``smollm-135m``): embedding -> a Python loop over the stacked pre-norm blocks
(where JAX has ``lax.scan``) -> final norm -> tied head.

Parameters are the JAX package's pytree as nested dicts of tensors, layer
leaves stacked on a leading (L,) axis. The other layer plans (``pairs``,
``hybrid``, SSM) are still to be ported (ROADMAP.md).

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


def _require_uniform_attn(cfg: ModelConfig) -> None:
    """The port runs the llama-style uniform-attention plan; every other plan
    and architecture feature raises instead of running half-supported."""
    plan = layer_plan(cfg)
    if plan[0] != "uniform" or plan[1] != "attn":
        raise NotImplementedError(f"{cfg.name}: layer plan {plan[0]}/{plan[1]} "
                                  "is not ported yet (see ROADMAP.md)")
    extras = [f for f in ("n_codebooks", "embed_input", "qk_norm", "post_norm",
                          "norm_plus_one", "embed_scale", "final_softcap",
                          "attn_softcap") if getattr(cfg, f)]
    if extras or not cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: {extras or 'untied head'} "
                                  "not ported yet (see ROADMAP.md)")


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
    _require_uniform_attn(cfg)
    sites = {}
    n = cfg.n_layers
    for nm, din, dout in [
        ("attn.q", cfg.d_model, cfg.n_heads * cfg.d_head),
        ("attn.k", cfg.d_model, cfg.n_kv_heads * cfg.d_head),
        ("attn.v", cfg.d_model, cfg.n_kv_heads * cfg.d_head),
        ("attn.o", cfg.n_heads * cfg.d_head, cfg.d_model),
        ("mlp.gate", cfg.d_model, cfg.d_ff),
        ("mlp.up", cfg.d_model, cfg.d_ff),
        ("mlp.down", cfg.d_ff, cfg.d_model),
    ]:
        sites[f"layers.{nm}"] = TapSite(f"layers.{nm}", din, dout, n)
    return sites


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters with the JAX package's shapes, scales and dtypes,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from ``jax.random``'s; tests carry JAX weights across with
    ``convert.params_from_numpy`` instead)."""
    _require_uniform_attn(cfg)
    dev = resolve_device(device)
    dt = canonical_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * std).to(dt)

    def dense(d_in, d_out):
        return {"w": normal((cfg.n_layers, d_in, d_out), d_in ** -0.5)}

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=dt, device=dev)}

    d, n = cfg.d_model, cfg.n_layers
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    return {
        "embed": {"emb": normal((cfg.vocab_size, d), 0.02)},
        "layers": {
            "ln1": ones(n, d),
            "attn": {"q": dense(d, hq), "k": dense(d, hkv),
                     "v": dense(d, hkv), "o": dense(hq, d)},
            "ln2": ones(n, d),
            "mlp": {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                    "down": dense(cfg.d_ff, d)},
        },
        "final_norm": ones(d),
    }


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    _require_uniform_attn(cfg)
    return L.embed(params["embed"], batch["tokens"]).to(
        canonical_dtype(cfg.compute_dtype))


def head_logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied head: h (..., d) -> logits (..., V), in h's dtype (so bf16 at
    full width)."""
    return h @ params["embed"]["emb"].to(h.dtype).T


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------

def _block(cfg: ModelConfig, lp: dict, x: torch.Tensor,
           positions: torch.Tensor, spec, ad_l: dict, de_l: dict):
    """One layer; returns (x, (k, v), {tap: hidden input x} collected)."""
    aux: dict = {}
    x, kv = B.attn_block(cfg, lp, x, positions, window=None,
                         tap_prefix="layers", tap_ctx=(spec, ad_l, de_l, aux))
    return x, kv, aux


def hidden_states(cfg: ModelConfig, params: dict, batch: dict,
                  spec: ColaSpec | None = None, cola_vars: dict | None = None,
                  *, collect_kv: bool = False):
    """Embedding + all layers + final norm. Returns (h, aux):
    aux["collected"] holds each collected tap's hidden inputs stacked per
    layer, {tap: (L, B, S, d_in)}; with ``collect_kv`` aux["stacked"] holds
    every layer's k, v (L, B, S, K, Dh)."""
    ad = _subvars((cola_vars or {}).get("adapters", {}), "layers")
    de = _subvars((cola_vars or {}).get("deltas", {}), "layers")
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves([params, cola_vars or {}]))
    layer = _checkpointed(cfg, _block, needs_grad)
    x = embed_tokens(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    ks, vs = [], []
    collected: dict[str, list] = {}
    for i in range(cfg.n_layers):
        x, (k, v), got = layer(cfg, _layer(params["layers"], i), x, positions,
                               spec, _layer(ad, i), _layer(de, i))
        for tap, xin in got.items():
            collected.setdefault(tap, []).append(xin)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    aux: dict[str, Any] = {"collected": {t: torch.stack(xs) for t, xs
                                         in collected.items()}}
    if collect_kv:
        aux["stacked"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps), aux


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
    """(mean next-token CE, aux) of one batch {"tokens", "labels"}."""
    h, aux = hidden_states(cfg, params, batch, spec, cola_vars)
    return lm_loss(cfg, params, h, batch["labels"]), aux


def prefill(cfg: ModelConfig, params: dict, batch: dict,
            spec: ColaSpec | None = None, cola_vars: dict | None = None,
            *, lengths: torch.Tensor | None = None):
    """Full-sequence prefill; returns (logits (B, 1, V), cache) with the
    cache holding every layer's K/V of the processed sequence.

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
    return logits, {"layers": aux["stacked"]}


# ---------------------------------------------------------------------------
# caches / decode
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_len: int, *,
                kv_layout: str = "dense", kv_blocks: int | None = None,
                kv_block: int = 16) -> dict:
    """Decode-cache leaf (shape, dtype).

    ``kv_layout="dense"``: every layer gets a (L, batch, max_len, K, Dh) slot
    cache; memory scales with the horizon.

    ``kv_layout="paged"``: KV lives in a shared block pool
    (L, kv_blocks, kv_block, K, Dh) addressed through a per-slot block table
    (owned by the engine's ``runtime.kv_pager.BlockPager`` and passed to
    ``decode_step(block_table=)``); memory scales with kv_blocks and
    ``max_len`` only sizes the table. ``kv_blocks`` defaults to the
    dense-equivalent pool. The pairs plan's ring caches for its local layers
    are still to be ported (ROADMAP.md).
    """
    _require_uniform_attn(cfg)
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"kv_layout={kv_layout!r}")
    cdt = canonical_dtype(cfg.compute_dtype)
    if kv_layout == "paged":
        if kv_blocks is None:
            kv_blocks = batch * cdiv(max_len, kv_block)
        shape = (cfg.n_layers, kv_blocks, kv_block, cfg.n_kv_heads, cfg.d_head)
    else:
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"layers": {"k": (shape, cdt), "v": (shape, cdt)}}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               kv_layout: str = "dense", kv_blocks: int | None = None,
               kv_block: int = 16, device="cuda") -> dict:
    dev = resolve_device(device)
    specs = cache_specs(cfg, batch, max_len, kv_layout=kv_layout,
                        kv_blocks=kv_blocks, kv_block=kv_block)
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
    ``init_cache(kv_layout="paged")``).
    """
    ad = _subvars((cola_vars or {}).get("adapters", {}), "layers")
    de = _subvars((cola_vars or {}).get("deltas", {}), "layers")
    positions = batch["positions"]
    x = embed_tokens(cfg, params, batch)
    kc, vc = cache["layers"]["k"], cache["layers"]["v"]
    # one write plan for every layer: the kept (row, position) pairs
    if block_table is None:
        write = A.kv_write_plan(positions, x.shape[1], live, smax=kc.shape[2])
    else:
        write = A.kv_write_plan(positions, x.shape[1], live,
                                block_table=block_table, block=kc.shape[2])
    for i in range(cfg.n_layers):
        tap_ctx = (spec, _layer(ad, i), _layer(de, i), {})
        x = B.attn_block_decode(cfg, _layer(params["layers"], i), x, kc[i],
                                vc[i], positions, window=None,
                                tap_prefix="layers", tap_ctx=tap_ctx,
                                live=live, block_table=block_table,
                                kv_write=write)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return head_logits(cfg, params, x), cache


def scatter_prefill_cache(cache: dict, pre: dict, slot_ids) -> dict:
    """Write a prefill cache (rows 0..J-1, sequence length P) into slot
    positions [0, P) of a serving slot cache, in place; returns ``cache``.

    ``slot_ids`` (J,) maps prefill row j -> slot. Out-of-range ids are
    dropped (the JAX ``mode="drop"``), which is how padding rows of a
    bucketed prefill batch are discarded: they are removed before the
    ``index_copy_``. Positions >= a row's true prompt length receive pad-token
    KV, which is safe: decode at position p writes the real KV at p before
    attending, and causal masking hides positions > p.
    """
    ids = torch.as_tensor(slot_ids).cpu().long()   # host-side filtering
    for stack, leaves in cache.items():
        for name, c in leaves.items():
            p = pre[stack][name]
            keep = ((ids >= 0) & (ids < c.shape[1])).nonzero().squeeze(1)
            c.narrow(2, 0, p.shape[2]).index_copy_(
                1, ids[keep].to(c.device), p.index_select(1, keep.to(p.device)))
    return cache
