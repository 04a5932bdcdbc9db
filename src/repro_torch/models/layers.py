"""Primitive layers: plain functions over dicts of tensors.

- Dense weights are stored as (d_in, d_out) in ``param_dtype``; compute
  happens in the activation dtype.
- Every Dense call may carry a *tap name* (see ``core.taps``). ``tap_ctx`` is
  the 4-tuple ``(spec, adapters, deltas, aux)`` threaded by the model; ``aux``
  is a dict the caller owns.
- Under a step's tensor-parallel plan (``distributed.tensor_parallel``) the
  tap name also gives the tap's Mode-A blocks over "model".
- Under remat "dots" a Dense call's products are kept for the backward
  (``models.remat``) unless ``keep`` is False.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import taps as taps_lib
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import remat


def dense(params: dict, x: torch.Tensor, *, tap: str | None = None,
          tap_ctx: tuple | None = None, keep: bool = True) -> torch.Tensor:
    """y = x @ W (+ ColA tap application). ``keep`` False: y only feeds the
    residual add that closes a checkpointed unit, so remat "dots" keeps
    neither this product nor the tap adapter's last one."""
    y = remat.matmul(x, params["w"].to(x.dtype), keep)
    if tap is not None and tap_ctx is not None:
        spec, adapters, deltas, aux = tap_ctx
        y, collected = taps_lib.apply_tap(spec, tap, x, y, adapters, deltas,
                                          layout=tp.tap_layout(tap),
                                          keep=keep)
        aux.update(collected)
    return y


def embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``ids`` (over a vocab split, the rank's range summed over
    "model": ``tensor_parallel.embed_lookup``)."""
    return tp.embed_lookup(params["emb"], ids)


def rmsnorm(params: dict, x: torch.Tensor, *, eps: float = 1e-5,
            plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype. ``plus_one``: gemma's
    (1 + scale), added in f32."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = params["scale"].to(torch.float32)
    if plus_one:
        scale = 1.0 + scale
    return (x * scale).to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """cap * tanh(x / cap); no-op without a (positive) cap."""
    if cap is None or cap <= 0:
        return x
    return torch.tanh(x / cap) * cap


def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). Rotates the
    split halves of Dh (not interleaved pairs), as the JAX package does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (Dh/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(params: dict, x: torch.Tensor, *, act: str = "silu",
        tap_prefix: str | None = None, tap_ctx: tuple | None = None,
        keep_out: bool = True) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU); split over "model" under a plan that
    splits it: gate / up by columns, down by output columns over the
    gathered hidden. Under a step's sequence split ``x`` and the output are
    the rank's rows; the products run on the whole sequence (``seq_in`` /
    ``seq_out``, or gathered and kept where the MLP is replicated).
    ``keep_out``: the down product's ``dense(keep=)``."""
    t = (lambda s: f"{tap_prefix}.{s}") if tap_prefix else (lambda s: None)
    plan = tp.mlp()
    x = tp.replicated_in(x) if plan is None else plan.seq_in(x)
    g = dense(params["gate"], x, tap=t("gate"), tap_ctx=tap_ctx)
    u = dense(params["up"], x, tap=t("up"), tap_ctx=tap_ctx)
    if act == "silu":
        h = F.silu(g) * u
    elif act == "gelu":
        h = F.gelu(g, approximate="tanh") * u
    else:
        raise ValueError(act)
    if plan is None:
        return tp.replicated_out(dense(params["down"], h, tap=t("down"),
                                       tap_ctx=tap_ctx, keep=keep_out))
    return plan.seq_out(dense(params["down"], plan.gather_cols(h),
                              tap=t("down"), tap_ctx=tap_ctx, keep=keep_out))
