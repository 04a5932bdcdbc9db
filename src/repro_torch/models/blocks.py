"""Residual blocks: the pre-norm attention block (llama / mistral style) with
a gated-MLP FFN, or a routed-expert FFN where the config has experts
(qwen3-moe, dbrx; ``models/moe.py``); gemma2's post-norms, (1 + scale)
norms and attention logit softcap, and QK-norm, when the config asks for
them. The SSM blocks are still to be ported (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def _norm(cfg: ModelConfig, p, x):
    return L.rmsnorm(p, x, eps=cfg.norm_eps, plus_one=cfg.norm_plus_one)


def _attn_kwargs(cfg: ModelConfig, window, tap_prefix, tap_ctx) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta, window=window,
                softcap=cfg.attn_softcap or None, qk_norm=cfg.qk_norm,
                tap_prefix=f"{tap_prefix}.attn", tap_ctx=tap_ctx)


def _ffn_half(cfg: ModelConfig, params: dict, x: torch.Tensor, h, *,
              tap_prefix: str, tap_ctx):
    """Residual add of the attention output (post-normed under
    ``post_norm``), then the FFN half likewise: the routed experts where
    the config has them (no taps: JAX puts none on the experts), else the
    gated MLP. Returns (x, the MoE aux loss, or None without experts)."""
    if cfg.post_norm:
        h = _norm(cfg, params["post_ln1"], h)
    x = x + h
    h = _norm(cfg, params["ln2"], x)
    aux = None
    if cfg.n_experts:
        h, aux = M.moe_block(params["moe"], h, top_k=cfg.moe_top_k,
                             impl=cfg.moe_impl, group=cfg.moe_group,
                             capacity_factor=cfg.capacity_factor)
    else:
        h = L.mlp(params["mlp"], h, act=cfg.act,
                  tap_prefix=f"{tap_prefix}.mlp", tap_ctx=tap_ctx)
    if cfg.post_norm:
        h = _norm(cfg, params["post_ln2"], h)
    return x + h, aux


def attn_block(cfg: ModelConfig, params: dict, x: torch.Tensor,
               positions: torch.Tensor, *, window: int | None,
               tap_prefix: str, tap_ctx: tuple | None):
    """Full-sequence block (prefill, training). Returns (x, the layer's MoE
    aux loss or None, (k, v))."""
    h, k, v = A.attention_prefill(params["attn"], _norm(cfg, params["ln1"], x),
                                  positions, **_attn_kwargs(cfg, window,
                                                            tap_prefix, tap_ctx))
    x, aux = _ffn_half(cfg, params, x, h, tap_prefix=tap_prefix,
                       tap_ctx=tap_ctx)
    return x, aux, (k, v)


def attn_block_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      positions: torch.Tensor, *, window: int | None,
                      tap_prefix: str, tap_ctx: tuple | None,
                      kv_write: tuple[torch.Tensor, torch.Tensor],
                      live: torch.Tensor | None = None,
                      block_table: torch.Tensor | None = None,
                      ring_horizon: int | None = None) -> torch.Tensor:
    """Decode-tick (or prefill-chunk) block; writes the new tokens' K/V into
    the caches in place (see attention.attention_decode). The MoE aux loss
    is dropped, as JAX's decode drops it."""
    h = A.attention_decode(params["attn"], _norm(cfg, params["ln1"], x),
                           k_cache, v_cache, positions, live=live,
                           block_table=block_table, kv_write=kv_write,
                           ring_horizon=ring_horizon,
                           **_attn_kwargs(cfg, window, tap_prefix, tap_ctx))
    return _ffn_half(cfg, params, x, h, tap_prefix=tap_prefix,
                     tap_ctx=tap_ctx)[0]
