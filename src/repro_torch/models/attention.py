"""GQA attention with RoPE and optional QK-norm (window and logit softcap
reach the kernels). Two modes: prefill (full causal, returns K/V for the
cache) and decode (c new tokens per row against a dense slot cache, a paged
block pool or a per-slot ring: c == 1 is the decode tick, c > 1 a chunk of a
chunked prefill). The inner attention goes through ``kernels.ops`` so the
CUDA kernels replace the plain versions on the card. Under a step's plan
that splits the attention over "model" (``distributed.tensor_parallel``), a
rank's prefill computes its q / k / v columns, attends over its own query
heads with the KV heads they read, and computes its output columns of o
over the gathered heads (under the step's sequence split the input is
gathered over the sequence and the output columns turned into the rank's
rows); its decode tick gathers q / k / v to every head,
attends its block of a cache split by sequence (``CacheSplit``) and merges
the ranks' blocks, and computes its output columns of o over the merged
heads.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L

# QK-norm's eps: the JAX package's ``_project_qkv`` default, which its
# callers never override with the config's ``norm_eps``
QK_NORM_EPS = 1e-6


def _project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                 n_heads: int, n_kv: int, d_head: int, rope_theta: float,
                 qk_norm: bool, tap_prefix: str, tap_ctx: tuple | None,
                 whole_heads: bool = False):
    """q, k, v per head, RoPE applied; with ``qk_norm`` q and k are
    RMS-normed over d_head first (at ``QK_NORM_EPS``). Under a plan that
    splits the attention, the rank's heads (``n_heads`` / ``n_kv`` are then
    the rank's), or with ``whole_heads`` the rank's product columns gathered
    to every head (the norm and RoPE run per head after the gather); under
    its sequence split ``x`` is the rank's rows, gathered over the sequence
    first (``Plan.seq_in``)."""
    plan = tp.attention()
    if plan is not None:
        x = plan.seq_in(x)
    B, S, _ = x.shape
    q = L.dense(params["q"], x, tap=f"{tap_prefix}.q", tap_ctx=tap_ctx)
    k = L.dense(params["k"], x, tap=f"{tap_prefix}.k", tap_ctx=tap_ctx)
    v = L.dense(params["v"], x, tap=f"{tap_prefix}.v", tap_ctx=tap_ctx)
    if plan is not None and whole_heads:
        q, k, v = (plan.whole_heads(t) for t in (q, k, v))
    elif plan is not None:
        k, v = plan.kv_heads(k, d_head), plan.kv_heads(v, d_head)
    q = q.reshape(B, S, n_heads, d_head)
    k = k.reshape(B, S, n_kv, d_head)
    v = v.reshape(B, S, n_kv, d_head)
    if qk_norm:
        q = L.rmsnorm(params["q_norm"], q, eps=QK_NORM_EPS)
        k = L.rmsnorm(params["k_norm"], k, eps=QK_NORM_EPS)
    q = L.apply_rope(q, positions, rope_theta)
    k = L.apply_rope(k, positions, rope_theta)
    return q, k, v


def attention_prefill(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                      n_heads: int, n_kv: int, d_head: int,
                      rope_theta: float = 1e4, window: int | None = None,
                      softcap: float | None = None, qk_norm: bool = False,
                      tap_prefix: str = "attn", tap_ctx: tuple | None = None):
    """Full-sequence causal attention; also returns (k, v) to seed the
    decode cache (under a plan that splits the attention, the rank's query
    heads and the KV heads they read). Under a step's sequence split ``x``
    and the output are the rank's rows of the sequence; k and v are the
    whole sequence's."""
    plan = tp.attention()
    if plan is not None:
        n_heads, n_kv = plan.attn.heads, plan.attn.kv_heads
    else:   # replicated over "model": the whole sequence on every rank
        x = tp.replicated_in(x)
    B, S = x.shape[0], positions.shape[-1]
    q, k, v = _project_qkv(params, x, positions, n_heads=n_heads, n_kv=n_kv,
                           d_head=d_head, rope_theta=rope_theta,
                           qk_norm=qk_norm, tap_prefix=tap_prefix,
                           tap_ctx=tap_ctx)
    o = kernel_ops.sdpa(q, k, v, q_positions=positions,
                        kv_positions=positions, causal=True, window=window,
                        softcap=softcap)
    o = o.reshape(B, S, n_heads * d_head)
    if plan is None:
        y = tp.replicated_out(L.dense(params["o"], o, tap=f"{tap_prefix}.o",
                                      tap_ctx=tap_ctx))
    else:
        y = plan.seq_out(L.dense(params["o"], plan.gather_cols(o),
                                 tap=f"{tap_prefix}.o", tap_ctx=tap_ctx))
    return y, k, v


def kv_write_plan(positions: torch.Tensor, c: int,
                  live: torch.Tensor | None, *, smax: int | None = None,
                  block_table: torch.Tensor | None = None,
                  block: int | None = None, ring: int | None = None,
                  seq_block: tuple[int, int] | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Where the K/V of a step's c new tokens per row go: (src, dst), flat
    indices into the (B * c) new rows and into the cache viewed as rows of
    (K, Dh). Only kept writes are listed. One plan serves every layer of a
    stack in a step, so it is computed once per step and layout.

    - dense (``smax``): cache (B, Smax, K, Dh); row b's token i goes to
      position positions[b] + i. A single token (c == 1) is clamped into the
      cache like JAX's ``dynamic_update_slice``; a chunk's tail at or past
      Smax is dropped, never clamped back over real KV. ``seq_block``
      (offset, size): the cache is a rank's block of positions [offset,
      offset + size) of the Smax (B, size, K, Dh), and only the writes
      that land in it are kept, at position - offset (the clamp stays
      Smax's).
    - paged (``block_table`` (B, max_blocks), ``block``): pool
      (n_blocks, block, K, Dh); position p goes to pool row
      ``block_table[b, p // block]``, offset ``p % block``; positions at or
      past max_blocks * block are dropped.
    - ring (``ring`` = W_ring): cache (B, W_ring, K, Dh); position p of row b
      goes to ring row ``b * W_ring + p % W_ring``; every position is kept
      (a ring has no horizon), as JAX's ring scatter writes them all.

    Dead rows' writes (``live`` False) are dropped in every layout. Torch has
    no scatter with ``mode="drop"``, so dropped writes are filtered out here
    rather than sent to a clamped in-range row, where two rows could race.
    """
    B = positions.shape[0]
    dev = positions.device
    pos = positions.long()[:, None] + torch.arange(c, device=dev)[None]
    if ring is not None:
        ok = torch.ones_like(pos, dtype=torch.bool)
        dst = torch.arange(B, device=dev)[:, None] * ring + pos % ring
    elif block_table is None:
        if c == 1:
            pos = pos.clamp(0, smax - 1)
        ok = pos < smax
        width = smax
        if seq_block is not None:
            pos, width = pos - seq_block[0], seq_block[1]
            ok = ok & (pos >= 0) & (pos < width)
        dst = torch.arange(B, device=dev)[:, None] * width + pos
    else:
        nb = block_table.shape[1]
        ok = pos < nb * block
        blk = block_table.long().gather(1, (pos // block).clamp(max=nb - 1))
        dst = blk * block + pos % block
    if live is not None:
        ok = ok & live[:, None]
    src = ok.flatten().nonzero().squeeze(1)
    return src, dst.flatten()[src]


def attention_decode(params: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor, *,
                     n_heads: int, n_kv: int, d_head: int,
                     rope_theta: float = 1e4, window: int | None = None,
                     softcap: float | None = None, qk_norm: bool = False,
                     tap_prefix: str = "attn", tap_ctx: tuple | None = None,
                     kv_write: tuple[torch.Tensor, torch.Tensor],
                     live: torch.Tensor | None = None,
                     block_table: torch.Tensor | None = None,
                     ring_horizon: int | None = None,
                     seq_split: tp.CacheSplit | None = None) -> torch.Tensor:
    """Incremental step: write c new tokens per row into the cache, then
    attend causally against everything written so far. x: (B, c, d_model);
    positions: (B,) each row's first position (tokens already in its cache).
    c == 1 is the decode tick; c > 1 one chunk of a chunked prefill.

    Layouts: dense, k/v_cache (B, Smax, K, Dh); paged (``block_table``
    (B, max_blocks) given), k/v_cache the shared pool (n_blocks, bs, K, Dh);
    ring (``ring_horizon`` given: the pairs plan's local stack under the
    paged layout), k/v_cache (B, W_ring, K, Dh) holding the last W_ring
    positions, position p at ``p % W_ring``, with W_ring >= window + c - 1;
    ``ring_horizon`` is the virtual horizon of the slots' positions, which
    sizes the decode kernel's splits as the dense cache's length would.
    ``kv_write`` is the step's ``kv_write_plan``: dead rows' writes and
    out-of-range chunk tails are dropped. The cache is updated in place (the
    JAX version returns a new cache); dead rows' attention output is zero.

    Under the serve step's plan every rank computes every head (q / k / v
    gathered from the split products); ``seq_split``: the dense cache is
    the rank's block of positions (``kv_write`` then lists only the writes
    that fall in it), attended at positions shifted by its offset and
    merged with the other ranks' blocks.
    """
    B, c, _ = x.shape
    pos2d = positions[:, None] + torch.arange(c, dtype=positions.dtype,
                                              device=x.device)[None]
    plan = tp.attention()
    q, k, v = _project_qkv(params, x, pos2d, n_heads=n_heads, n_kv=n_kv,
                           d_head=d_head, rope_theta=rope_theta,
                           qk_norm=qk_norm, tap_prefix=tap_prefix,
                           tap_ctx=tap_ctx, whole_heads=True)
    src, dst = kv_write
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache.view(-1, n_kv, d_head).index_copy_(
            0, dst, new.reshape(B * c, n_kv, d_head).index_select(0, src))
    if seq_split is not None and seq_split.n > 1:
        o, lse = kernel_ops.sdpa_decode(q, k_cache, v_cache,
                                        positions - seq_split.offset,
                                        live=live, window=window,
                                        softcap=softcap, return_lse=True)
        o = tp.current().merge_blocks(o, lse, seq_split).to(q.dtype)
    elif ring_horizon is not None:
        o = kernel_ops.sdpa_decode_ring(q, k_cache, v_cache, positions,
                                        live=live, window=window,
                                        softcap=softcap, horizon=ring_horizon)
    elif block_table is None:
        o = kernel_ops.sdpa_decode(q, k_cache, v_cache, positions, live=live,
                                   window=window, softcap=softcap)
    else:
        o = kernel_ops.sdpa_decode_paged(q, k_cache, v_cache, positions,
                                         block_table, live=live, window=window,
                                         softcap=softcap)
    o = o.reshape(B, c, n_heads * d_head)
    y = L.dense(params["o"], o, tap=f"{tap_prefix}.o", tap_ctx=tap_ctx)
    return y if plan is None else plan.gather_out(y)
