"""Flash-attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:_fwd_kernel``
(entry ``flash_attention``). The kernel takes per-row positions, so unlike the
TPU kernel it is exact for non-uniform positions too. Forward only: the
backward kernels come with the training slice (ROADMAP.md).
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)

# The plain version: o and the per-row lse, from the dense reference.
plain = partial(ref.sdpa, with_lse=True)


def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, K, Dh); positions (1|B, Sq) and
    (1|B, Sk), default ``arange``. Returns (o (B, Sq, H, Dh) in q's dtype,
    lse (B, H, Sq) f32). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if scale is None:
        scale = Dh ** -0.5
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=q.device)[None]
    if kv_positions is None:
        kv_positions = torch.arange(Sk, dtype=torch.int32, device=q.device)[None]
    if q.device.type == "cpu":
        return plain(q, k, v, q_positions=q_positions, kv_positions=kv_positions,
                     causal=causal, window=window, softcap=softcap, scale=scale)

    name = "flash_attention"
    req = partial(_build.require, kernel=name)
    req(q.is_cuda and k.device == q.device and v.device == q.device,
        what="q, k, v must be CUDA tensors on one device")
    req(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
        and v.dtype == q.dtype, what=f"dtype {q.dtype}/{k.dtype}/{v.dtype}")
    req(Dh in HEAD_DIMS, what=f"head dim {Dh} not in {HEAD_DIMS}")
    req(k.shape == v.shape and k.shape[0] == B and k.shape[3] == Dh
        and H % K == 0, what=f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
        f"v {tuple(v.shape)}")
    req(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
        what="q, k, v must be contiguous")
    qp = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    kp = kv_positions.to(device=q.device, dtype=torch.int32).contiguous()
    req(qp.dim() == 2 and qp.shape[0] in (1, B) and qp.shape[1] == Sq,
        what=f"q_positions shape {tuple(qp.shape)}")
    req(kp.dim() == 2 and kp.shape[0] in (1, B) and kp.shape[1] == Sk,
        what=f"kv_positions shape {tuple(kp.shape)}")

    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
               kp.data_ptr(), o.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, K,
               Dh, _build.DTYPE_CODES[q.dtype],
               Sq if qp.shape[0] > 1 else 0, Sk if kp.shape[0] > 1 else 0,
               float(scale), int(causal), int(window or 0),
               float(softcap or 0.0), _build.stream_ptr(q.device))
    _build.check_launch(rc, name)
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
