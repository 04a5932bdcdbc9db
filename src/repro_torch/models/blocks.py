"""Residual blocks: the pre-norm attention + gated-MLP block (llama / mistral
style), with gemma2's post-norms, (1 + scale) norms and attention logit
softcap when the config asks for them. MoE and SSM blocks are still to be
ported (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _require_mlp(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are not ported yet "
                                  "(ROADMAP.md A.5.3)")


def _norm(cfg: ModelConfig, p, x):
    return L.rmsnorm(p, x, eps=cfg.norm_eps, plus_one=cfg.norm_plus_one)


def _attn_kwargs(cfg: ModelConfig, window, tap_prefix, tap_ctx) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta, window=window,
                softcap=cfg.attn_softcap or None,
                tap_prefix=f"{tap_prefix}.attn", tap_ctx=tap_ctx)


def _mlp_half(cfg: ModelConfig, params: dict, x: torch.Tensor, h, *,
              tap_prefix: str, tap_ctx) -> torch.Tensor:
    """Residual add of the attention output (post-normed under
    ``post_norm``), then the gated-MLP half likewise."""
    if cfg.post_norm:
        h = _norm(cfg, params["post_ln1"], h)
    x = x + h
    h = L.mlp(params["mlp"], _norm(cfg, params["ln2"], x), act=cfg.act,
              tap_prefix=f"{tap_prefix}.mlp", tap_ctx=tap_ctx)
    if cfg.post_norm:
        h = _norm(cfg, params["post_ln2"], h)
    return x + h


def attn_block(cfg: ModelConfig, params: dict, x: torch.Tensor,
               positions: torch.Tensor, *, window: int | None,
               tap_prefix: str, tap_ctx: tuple | None):
    """Full-sequence block (prefill). Returns (x, (k, v))."""
    _require_mlp(cfg)
    h, k, v = A.attention_prefill(params["attn"], _norm(cfg, params["ln1"], x),
                                  positions, **_attn_kwargs(cfg, window,
                                                            tap_prefix, tap_ctx))
    x = _mlp_half(cfg, params, x, h, tap_prefix=tap_prefix, tap_ctx=tap_ctx)
    return x, (k, v)


def attn_block_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      positions: torch.Tensor, *, window: int | None,
                      tap_prefix: str, tap_ctx: tuple | None,
                      kv_write: tuple[torch.Tensor, torch.Tensor],
                      live: torch.Tensor | None = None,
                      block_table: torch.Tensor | None = None,
                      ring_horizon: int | None = None) -> torch.Tensor:
    """Decode-tick (or prefill-chunk) block; writes the new tokens' K/V into
    the caches in place (see attention.attention_decode)."""
    _require_mlp(cfg)
    h = A.attention_decode(params["attn"], _norm(cfg, params["ln1"], x),
                           k_cache, v_cache, positions, live=live,
                           block_table=block_table, kv_write=kv_write,
                           ring_horizon=ring_horizon,
                           **_attn_kwargs(cfg, window, tap_prefix, tap_ctx))
    return _mlp_half(cfg, params, x, h, tap_prefix=tap_prefix, tap_ctx=tap_ctx)
