"""Kernel entry points the models call.

Each call is routed by the device of its tensors, not by a global switch:
CPU tensors take the plain PyTorch version, CUDA tensors launch the
hand-written kernel, which raises for a shape or dtype it does not take.
There is no fallback from a CUDA tensor to the plain version. Attention that
autograd must see through goes through ``FlashAttention``, whose backward is
the flash backward kernels on the card (the plain backward on the CPU); the
other kernels have no backward and raise on CUDA inputs that require grad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cola_fit as cf
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import multi_lora as ml
from repro_torch.kernels import ref


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         q_positions: torch.Tensor, kv_positions: torch.Tensor,
         causal: bool = True, window: int | None = None,
         softcap: float | None = None, scale: float | None = None
         ) -> torch.Tensor:
    """Attention entry point (see ref.sdpa for semantics). The CUDA kernels
    take per-row positions, so any positions are exact on either device."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return fa.FlashAttention.apply(q, k, v, q_positions, kv_positions,
                                       causal, window, softcap, scale)
    if q.device.type == "cpu":   # the plain forward, without the lse
        return ref.sdpa(q, k, v, q_positions=q_positions,
                        kv_positions=kv_positions, causal=causal,
                        window=window, softcap=softcap, scale=scale)
    o, _ = fa.flash_attention(q, k, v, q_positions=q_positions,
                              kv_positions=kv_positions, causal=causal,
                              window=window, softcap=softcap, scale=scale)
    return o


def sdpa_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                positions: torch.Tensor, *, live: torch.Tensor | None = None,
                window: int | None = None, softcap: float | None = None,
                scale: float | None = None) -> torch.Tensor:
    """Incremental attention against a dense slot KV cache (see
    ref.sdpa_decode). On the card only the single-query decode tick has a
    kernel; multi-token chunks belong to chunked prefill (ROADMAP.md)."""
    return da.decode_attention(q, k_cache, v_cache, positions, live=live,
                               window=window, softcap=softcap, scale=scale)


def cola_fit_lowrank(x: torch.Tensor, grad_h: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, scale: float = 1.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Low-rank fit gradient (dA, dB) (see ref.cola_fit_lowrank); takes a
    leading layer axis, so one call fits a tap for every layer."""
    return cf.cola_fit_lowrank(x, grad_h, A, B, scale=scale)


def multi_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               idx: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Per-token adapter-indexed low-rank apply (see ref.multi_lora)."""
    return ml.multi_lora(x, A, B, idx, scale=scale)
