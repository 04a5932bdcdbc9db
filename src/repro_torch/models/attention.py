"""GQA attention with RoPE (window and logit softcap reach the kernels).
Two modes: prefill (full causal, returns K/V for the cache) and decode (one
new token against a dense slot cache). The inner attention goes through
``kernels.ops`` so the CUDA kernels replace the plain versions on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L


def _project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                 n_heads: int, n_kv: int, d_head: int, rope_theta: float,
                 tap_prefix: str, tap_ctx: tuple | None):
    B, S, _ = x.shape
    q = L.dense(params["q"], x, tap=f"{tap_prefix}.q", tap_ctx=tap_ctx)
    k = L.dense(params["k"], x, tap=f"{tap_prefix}.k", tap_ctx=tap_ctx)
    v = L.dense(params["v"], x, tap=f"{tap_prefix}.v", tap_ctx=tap_ctx)
    q = q.reshape(B, S, n_heads, d_head)
    k = k.reshape(B, S, n_kv, d_head)
    v = v.reshape(B, S, n_kv, d_head)
    q = L.apply_rope(q, positions, rope_theta)
    k = L.apply_rope(k, positions, rope_theta)
    return q, k, v


def attention_prefill(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                      n_heads: int, n_kv: int, d_head: int,
                      rope_theta: float = 1e4, window: int | None = None,
                      softcap: float | None = None, tap_prefix: str = "attn",
                      tap_ctx: tuple | None = None):
    """Full-sequence causal attention; also returns (k, v) to seed the
    decode cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, positions, n_heads=n_heads, n_kv=n_kv,
                           d_head=d_head, rope_theta=rope_theta,
                           tap_prefix=tap_prefix, tap_ctx=tap_ctx)
    o = kernel_ops.sdpa(q, k, v, q_positions=positions,
                        kv_positions=positions, causal=True, window=window,
                        softcap=softcap)
    o = o.reshape(B, S, n_heads * d_head)
    y = L.dense(params["o"], o, tap=f"{tap_prefix}.o", tap_ctx=tap_ctx)
    return y, k, v


def attention_decode(params: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor, *,
                     n_heads: int, n_kv: int, d_head: int,
                     rope_theta: float = 1e4, window: int | None = None,
                     softcap: float | None = None, tap_prefix: str = "attn",
                     tap_ctx: tuple | None = None,
                     live: torch.Tensor | None = None) -> torch.Tensor:
    """Decode tick on the dense layout: write the new token's K/V into the
    slot cache (B, Smax, K, Dh) at ``positions`` (B,), then attend causally
    against everything written so far. x: (B, 1, d_model).

    The cache is updated in place (the JAX version returns a new cache); the
    caller (``model.decode_step``) restores the rows of non-live slots.
    Multi-token chunks (chunked prefill) and the paged / ring layouts are
    still to be ported (ROADMAP.md).
    """
    B, c, _ = x.shape
    if c != 1:
        raise NotImplementedError("multi-token decode chunks (chunked "
                                  "prefill) are not ported yet (see ROADMAP.md)")
    q, k, v = _project_qkv(params, x, positions[:, None], n_heads=n_heads,
                           n_kv=n_kv, d_head=d_head, rope_theta=rope_theta,
                           tap_prefix=tap_prefix, tap_ctx=tap_ctx)
    # clamped into the cache like the JAX dynamic_update_slice
    rows = torch.arange(B, device=x.device)
    pos = positions.long().clamp(0, k_cache.shape[1] - 1)
    k_cache[rows, pos] = k[:, 0]
    v_cache[rows, pos] = v[:, 0]
    o = kernel_ops.sdpa_decode(q, k_cache, v_cache, positions, live=live,
                               window=window, softcap=softcap)
    o = o.reshape(B, c, n_heads * d_head)
    return L.dense(params["o"], o, tap=f"{tap_prefix}.o", tap_ctx=tap_ctx)
