"""Kernel entry points the models call.

Each call is routed by the device of its tensors, not by a global switch:
CPU tensors take the plain PyTorch version, CUDA tensors launch the
hand-written kernel, which raises for a shape or dtype it does not take.
There is no fallback from a CUDA tensor to the plain version. Attention that
autograd must see through goes through ``FlashAttention``, whose backward is
the flash backward kernels on the card (the plain backward on the CPU); the
other kernels have no backward and raise on CUDA inputs that require grad.
The SSD scan of the Mamba2 block (``ssd``, ``ssd_decode_step``) has no
kernel on either device, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cola_fit as cf
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import multi_lora as ml
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan


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
                scale: float | None = None, return_lse: bool = False):
    """Incremental attention against a dense slot KV cache (see
    ref.sdpa_decode): Sq == 1 is the decode tick (the decode kernel), Sq > 1
    one chunk of a chunked prefill, which on the card runs the flash forward
    kernel (the JAX package has no Pallas kernel for chunks).
    ``return_lse`` (a tick only): (o in f32, lse (B, H) f32), for a merge
    of cache blocks (``decode_attention.decode_attention``)."""
    if q.shape[1] == 1:
        return da.decode_attention(q, k_cache, v_cache, positions, live=live,
                                   window=window, softcap=softcap, scale=scale,
                                   return_lse=return_lse)
    if return_lse:
        raise ValueError(f"return_lse is a tick's (Sq == 1), got Sq="
                         f"{q.shape[1]}")
    if q.device.type == "cpu":
        return ref.sdpa_decode(q, k_cache, v_cache, positions, live=live,
                               window=window, softcap=softcap, scale=scale)
    return _chunk_attention(q, k_cache, v_cache, positions, live=live,
                            window=window, softcap=softcap, scale=scale)


def sdpa_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, positions: torch.Tensor,
                      block_table: torch.Tensor, *,
                      live: torch.Tensor | None = None,
                      window: int | None = None, softcap: float | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Incremental attention against a paged KV pool (see
    ref.sdpa_decode_paged): Sq == 1 is the paged decode kernel, which reads
    the pool through the table; a chunk (Sq > 1) gathers the rows' blocks
    into a dense view, as JAX does for chunks on every backend, and on the
    card runs the flash forward kernel over it."""
    if q.shape[1] == 1:
        return da.decode_attention_paged(q, k_pool, v_pool, positions,
                                         block_table, live=live, window=window,
                                         softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return ref.sdpa_decode_paged(q, k_pool, v_pool, positions, block_table,
                                     live=live, window=window, softcap=softcap,
                                     scale=scale)
    table = block_table.long()
    return _chunk_attention(q, k_pool[table].flatten(1, 2),
                            v_pool[table].flatten(1, 2), positions, live=live,
                            window=window, softcap=softcap, scale=scale)


def sdpa_decode_ring(q: torch.Tensor, k_ring: torch.Tensor,
                     v_ring: torch.Tensor, positions: torch.Tensor, *,
                     live: torch.Tensor | None = None,
                     window: int | None = None, softcap: float | None = None,
                     scale: float | None = None, horizon: int | None = None
                     ) -> torch.Tensor:
    """Incremental attention against per-slot rings (see
    ref.sdpa_decode_ring): Sq == 1 is the decode kernel in its ring mode,
    with ``horizon`` the slots' virtual horizon; a chunk (Sq > 1) gathers
    each ring in position order and on the card runs the flash forward
    kernel over it with per-row kv positions."""
    if q.shape[1] == 1:
        return da.decode_attention_ring(q, k_ring, v_ring, positions,
                                        horizon=horizon, live=live,
                                        window=window, softcap=softcap,
                                        scale=scale)
    if q.device.type == "cpu":
        return ref.sdpa_decode_ring(q, k_ring, v_ring, positions, live=live,
                                    window=window, softcap=softcap,
                                    scale=scale)
    ring_idx, kv_pos = ref.ring_order(positions + q.shape[1] - 1,
                                      k_ring.shape[1])
    rows = torch.arange(q.shape[0], device=q.device)[:, None]
    idx = ring_idx.long()
    return _chunk_attention(q, k_ring[rows, idx], v_ring[rows, idx], positions,
                            kv_positions=kv_pos, live=live, window=window,
                            softcap=softcap, scale=scale)


def _chunk_attention(q, k, v, positions, *, kv_positions=None, live, window,
                     softcap, scale):
    """A chunk of c queries per row at positions + arange(c) against a
    (B, Sk, K, Dh) cache at ``kv_positions`` (default arange(Sk): a dense
    view), causal, through the flash forward kernel; dead rows give
    zeros."""
    ar = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    q_pos = positions.to(torch.int32)[:, None] + ar[None]
    kv_pos = (torch.arange(k.shape[1], dtype=torch.int32, device=q.device)[None]
              if kv_positions is None else kv_positions)
    o, _ = fa.flash_attention(q.contiguous(), k, v, q_positions=q_pos,
                              kv_positions=kv_pos, causal=True, window=window,
                              softcap=softcap, scale=scale)
    if live is not None:
        o = o.masked_fill(~live[:, None, None, None], 0)
    return o


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


def multi_lora_q8(x: torch.Tensor, A_q: torch.Tensor, A_scale: torch.Tensor,
                  B_q: torch.Tensor, B_scale: torch.Tensor, idx: torch.Tensor,
                  scale: float = 1.0) -> torch.Tensor:
    """Multi-LoRA apply from an int8 bank, dequantised on load (see
    ref.multi_lora_q8)."""
    return ml.multi_lora_q8(x, A_q, A_scale, B_q, B_scale, idx, scale=scale)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor,
        init_state: torch.Tensor | None = None, *, chunk: int = 128
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of a Mamba2 block (see ref.ssd): up to ``chunk``
    positions the quadratic form at once, longer sequences the chunked scan
    (``ssd_scan.ssd_chunked``). Plain PyTorch on every device, with no
    kernel behind it, because the JAX package has none: its ``ops.ssd`` is
    jnp on every backend. This is not a fallback from a kernel."""
    if x.shape[1] <= chunk:
        return ref.ssd(x, dt, a, B, C, D, init_state)
    return ssd_scan.ssd_chunked(x, dt, a, B, C, D, init_state, chunk=chunk)


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One token of the SSD recurrence (see ref.ssd_decode_step). Plain
    PyTorch on every device, as in the JAX package, which has no kernel for
    it: not a fallback from a kernel."""
    return ref.ssd_decode_step(x, dt, a, B, C, D, state)
