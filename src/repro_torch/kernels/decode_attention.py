"""Single-query decode attention: the CUDA kernel ``csrc/decode_attention.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:_kernel``
(entry ``decode_attention``). The paged variant (``_kernel_paged``) is still
to be ported (ROADMAP.md).
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)

plain = ref.sdpa_decode


def _fn():
    fn = _build.load("decode_attention").decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor, *,
                     live: torch.Tensor | None = None, window: int | None = None,
                     softcap: float | None = None, scale: float | None = None
                     ) -> torch.Tensor:
    """q: (B, 1, H, Dh); caches: (B, Smax, K, Dh); positions: (B,) int;
    live: (B,) bool or None (all live). Returns (B, 1, H, Dh). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, positions, live=live, window=window,
                     softcap=softcap, scale=scale)
    B, Sq, H, Dh = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = Dh ** -0.5

    name = "decode_attention"
    req = partial(_build.require, kernel=name)
    req(q.is_cuda and k_cache.device == q.device and v_cache.device == q.device,
        what="q and caches must be CUDA tensors on one device")
    req(q.dtype in _build.DTYPE_CODES and k_cache.dtype == q.dtype
        and v_cache.dtype == q.dtype,
        what=f"dtype {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    req(Sq == 1, what=f"one query per slot, got Sq={Sq}")
    req(Dh in HEAD_DIMS, what=f"head dim {Dh} not in {HEAD_DIMS}")
    req(k_cache.shape == v_cache.shape and k_cache.shape[0] == B
        and k_cache.shape[3] == Dh and H % K == 0,
        what=f"shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)}")
    req(q.is_contiguous() and k_cache.is_contiguous()
        and v_cache.is_contiguous(), what="q and caches must be contiguous")
    _build.require_no_grad(name, q, k_cache, v_cache)
    req(positions.shape == (B,), what=f"positions shape {tuple(positions.shape)}")
    pos = positions.to(device=q.device, dtype=torch.int32).contiguous()
    if live is not None:
        req(live.shape == (B,) and live.dtype == torch.bool
            and live.device == q.device, what="live must be a (B,) bool CUDA tensor")
        live = live.contiguous()

    o = torch.empty_like(q)
    rc = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               pos.data_ptr(), None if live is None else live.data_ptr(),
               o.data_ptr(), B, Smax, H, K, Dh, _build.DTYPE_CODES[q.dtype],
               float(scale), int(window or 0), float(softcap or 0.0),
               _build.stream_ptr(q.device))
    _build.check_launch(rc, name)
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
