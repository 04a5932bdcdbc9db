"""Residual blocks: the pre-norm attention block (llama / mistral style) with
a gated-MLP FFN, or a routed-expert FFN where the config has experts
(qwen3-moe, dbrx; ``models/moe.py``); gemma2's post-norms, (1 + scale)
norms and attention logit softcap, and QK-norm, when the config asks for
them; and the Mamba2 block of the SSM plan (mamba2-370m): a pre-norm
``ln`` and the SSD mixer of ``models/ssm.py``, with no FFN.

Under a step's sequence split (``distributed.tensor_parallel``) a block's
input and output are the rank's rows of the sequence: the norms and the
residual adds run on them, the attention, the dense MLP, a Mamba2 mixer
split by heads and an MoE FFN split by experts gather the sequence
themselves, and a mixer or an MoE FFN replicated over "model" takes the
whole sequence and keeps the rank's rows of its output.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


def _norm(cfg: ModelConfig, p, x):
    return L.rmsnorm(p, x, eps=cfg.norm_eps, plus_one=cfg.norm_plus_one)


def _attn_kwargs(cfg: ModelConfig, window, tap_prefix, tap_ctx) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta, window=window,
                softcap=cfg.attn_softcap or None, qk_norm=cfg.qk_norm,
                tap_prefix=f"{tap_prefix}.attn", tap_ctx=tap_ctx)


def _ffn_half(cfg: ModelConfig, params: dict, x: torch.Tensor, h, *,
              tap_prefix: str, tap_ctx, closes: bool = False):
    """Residual add of the attention output (post-normed under
    ``post_norm``), then the FFN half likewise: the routed experts where
    the config has them (no taps: JAX puts none on the experts), else the
    gated MLP. Returns (x, the MoE aux loss, or None without experts).
    ``closes``: the block ends a checkpointed unit, so without a post-norm
    the down product only feeds the closing residual add and remat "dots"
    does not keep it."""
    if cfg.post_norm:
        h = _norm(cfg, params["post_ln1"], h)
    x = x + h
    h = _norm(cfg, params["ln2"], x)
    aux = None
    if cfg.n_experts:
        # the rank's experts on its batch rank's tokens, or every expert
        # (replicated over "model"); the dispatch groups and capacities are
        # the whole (micro)batch's either way
        h, aux = M.moe_block(params["moe"], tp.moe_in(h),
                             top_k=cfg.moe_top_k, impl=cfg.moe_impl,
                             group=cfg.moe_group,
                             capacity_factor=cfg.capacity_factor,
                             split=tp.moe_split())
        h = tp.moe_out(h)
    else:
        h = L.mlp(params["mlp"], h, act=cfg.act,
                  tap_prefix=f"{tap_prefix}.mlp", tap_ctx=tap_ctx,
                  keep_out=cfg.post_norm or not closes)
    if cfg.post_norm:
        h = _norm(cfg, params["post_ln2"], h)
    return x + h, aux


def attn_block(cfg: ModelConfig, params: dict, x: torch.Tensor,
               positions: torch.Tensor, *, window: int | None,
               tap_prefix: str, tap_ctx: tuple | None, closes: bool = False):
    """Full-sequence block (prefill, training). Returns (x, the layer's MoE
    aux loss or None, (k, v)). ``closes``: as ``_ffn_half``'s."""
    h, k, v = A.attention_prefill(params["attn"], _norm(cfg, params["ln1"], x),
                                  positions, **_attn_kwargs(cfg, window,
                                                            tap_prefix, tap_ctx))
    x, aux = _ffn_half(cfg, params, x, h, tap_prefix=tap_prefix,
                       tap_ctx=tap_ctx, closes=closes)
    return x, aux, (k, v)


def attn_block_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      positions: torch.Tensor, *, window: int | None,
                      tap_prefix: str, tap_ctx: tuple | None,
                      kv_write: tuple[torch.Tensor, torch.Tensor],
                      live: torch.Tensor | None = None,
                      block_table: torch.Tensor | None = None,
                      ring_horizon: int | None = None,
                      seq_split=None) -> torch.Tensor:
    """Decode-tick (or prefill-chunk) block; writes the new tokens' K/V into
    the caches in place (see attention.attention_decode; ``seq_split``: the
    caches are the rank's block of positions). The MoE aux loss is dropped,
    as JAX's decode drops it."""
    h = A.attention_decode(params["attn"], _norm(cfg, params["ln1"], x),
                           k_cache, v_cache, positions, live=live,
                           block_table=block_table, kv_write=kv_write,
                           ring_horizon=ring_horizon, seq_split=seq_split,
                           **_attn_kwargs(cfg, window, tap_prefix, tap_ctx))
    return _ffn_half(cfg, params, x, h, tap_prefix=tap_prefix,
                     tap_ctx=tap_ctx)[0]


# ---------------------------------------------------------------------------
# the Mamba2 block (the ssm plan)
# ---------------------------------------------------------------------------

def ssm_block_init(cfg: ModelConfig, n: int, *, normal, uniform, full) -> dict:
    """A stack of ``n`` Mamba2 blocks: the pre-norm ``ln`` and the mixer
    (``ssm.ssm_init``, which says what the draw callables are)."""
    return {"ln": {"scale": full((n, cfg.d_model), 1.0)},
            "ssm": S.ssm_init(n, cfg.d_model, normal=normal, uniform=uniform,
                              full=full, expand=cfg.ssm_expand,
                              headdim=cfg.ssm_headdim, state=cfg.ssm_state,
                              d_conv=cfg.ssm_conv)}


def _ssm_kwargs(cfg: ModelConfig, tap_prefix: str, tap_ctx) -> dict:
    return dict(d_model=cfg.d_model, expand=cfg.ssm_expand,
                headdim=cfg.ssm_headdim, state=cfg.ssm_state,
                norm_eps=cfg.norm_eps, tap_prefix=f"{tap_prefix}.ssm",
                tap_ctx=tap_ctx)


def ssm_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
              tap_prefix: str, tap_ctx: tuple | None, closes: bool = False):
    """Full-sequence block (prefill, training). Returns (x, the layer's
    final {"conv", "ssm"} state: under a plan that splits the heads, the
    rank's heads of the SSM state). The scan runs over the whole sequence:
    a mixer split by heads takes it through ``seq_in`` and gives its output
    columns through ``seq_out``; a replicated one gathers it and keeps its
    rows. ``closes``: the block ends a checkpointed unit, so remat "dots"
    does not keep the out projection, which only feeds the residual
    add."""
    h = _norm(cfg, params["ln"], x)
    plan = tp.ssm()
    y, st = S.ssm_block(params["ssm"],
                        tp.replicated_in(h) if plan is None
                        else plan.seq_in(h),
                        chunk=cfg.ssd_chunk, keep_out=not closes,
                        **_ssm_kwargs(cfg, tap_prefix, tap_ctx))
    return x + (tp.replicated_out(y) if plan is None
                else plan.seq_out(y)), st


def ssm_block_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                     conv_state: torch.Tensor, ssm_state: torch.Tensor, *,
                     tap_prefix: str, tap_ctx: tuple | None):
    """Incremental block. x: (B, 1, d) runs the one-token recurrence;
    x: (B, c, d) runs one prefill chunk through the full-sequence block with
    both states carried in and out, exact length, so no padding ever reaches
    the recurrent state. Returns (x, conv_state, ssm_state); the caches are
    not touched. Under a plan that splits the heads the conv state in and
    out has every channel and the SSM state is the rank's heads', and the
    mixer's output columns are gathered (``seq_out``: the serve step holds
    no sequence split)."""
    h = _norm(cfg, params["ln"], x)
    kw = _ssm_kwargs(cfg, tap_prefix, tap_ctx)
    plan = tp.ssm()
    if plan is not None:
        h = plan.seq_in(h)
    if x.shape[1] > 1:
        y, st = S.ssm_block(params["ssm"], h, chunk=cfg.ssd_chunk,
                            init_state=ssm_state, conv_state=conv_state, **kw)
        conv_state, ssm_state = st["conv"], st["ssm"]
    else:
        y, conv_state, ssm_state = S.ssm_decode_step(
            params["ssm"], h, conv_state, ssm_state, **kw)
    if plan is not None:
        y = plan.seq_out(y)
    return x + y, conv_state, ssm_state
