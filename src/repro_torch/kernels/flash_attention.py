"""Flash attention: the CUDA forward kernel ``csrc/flash_attention.cu``, the
two backward kernels ``csrc/flash_attention_bwd.cu`` (dq; dk and dv), their
plain PyTorch versions, and ``FlashAttention``, the autograd Function that
ties them together.

Replaces the TPU kernels ``src/repro/kernels/flash_attention.py:_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (entry ``flash_attention``, a
``jax.custom_vjp``). The kernels take per-row positions, so unlike the TPU
kernels they are exact for non-uniform positions too.
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from repro_torch.kernels import _build, ref

# head dims the kernels take; gemma2's 256 has its own tilings in the
# forward and in the backward (csrc/flash_attention_bwd.cu), zamba2's 112
# takes those of 16-128
FWD_HEAD_DIMS = (16, 32, 64, 112, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 112, 128, 256)

# The plain versions: o and the per-row lse, from the dense reference; and
# (dq, dk, dv) from (q, k, v, o, lse, do).
plain = partial(ref.sdpa, with_lse=True)
plain_bwd = ref.sdpa_bwd


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
    req(Dh in FWD_HEAD_DIMS, what=f"head dim {Dh} not in {FWD_HEAD_DIMS}")
    req(k.shape == v.shape and k.shape[0] == B and k.shape[3] == Dh
        and H % K == 0, what=f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
        f"v {tuple(v.shape)}")
    req(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
        what="q, k, v must be contiguous")
    _build.require_no_grad(name, q, k, v)   # differentiable: FlashAttention
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


# -- backward ----------------------------------------------------------------

def _bwd_fn(name: str):
    fn = getattr(_build.load("flash_attention_bwd"), name)
    n_ptr = 9 if name.endswith("_dq") else 10
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bwd_launch(name: str, outs, q, k, v, do, lse, delta, q_positions,
                kv_positions, causal, window, softcap, scale) -> None:
    """Checks the backward kernels' inputs and launches one of them."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    req = partial(_build.require, kernel=name)
    # first: a head dim the backward does not take raises by name
    req(Dh in BWD_HEAD_DIMS, what=f"head dim {Dh} not in {BWD_HEAD_DIMS}")
    req(all(t.is_cuda and t.device == q.device
            for t in (k, v, do, lse, delta, q_positions, kv_positions)),
        what="inputs must be CUDA tensors on one device")
    req(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
        and v.dtype == q.dtype and do.dtype == q.dtype,
        what=f"dtype {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
    req(k.shape == v.shape and k.shape[0] == B and k.shape[3] == Dh
        and H % K == 0 and do.shape == q.shape,
        what=f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
        f"v {tuple(v.shape)} do {tuple(do.shape)}")
    req(lse.shape == (B, H, Sq) and delta.shape == (B, H, Sq)
        and lse.dtype == torch.float32 and delta.dtype == torch.float32,
        what="lse and delta must be (B, H, Sq) f32")
    req(q_positions.dtype == torch.int32 and q_positions.dim() == 2
        and q_positions.shape[0] in (1, B) and q_positions.shape[1] == Sq
        and kv_positions.dtype == torch.int32 and kv_positions.dim() == 2
        and kv_positions.shape[0] in (1, B) and kv_positions.shape[1] == Sk,
        what="positions must be int32 (1|B, S)")
    req(all(t.is_contiguous() for t in (q, k, v, do, lse, delta, q_positions,
                                        kv_positions)),
        what="inputs must be contiguous")
    rc = _bwd_fn(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), q_positions.data_ptr(),
        kv_positions.data_ptr(), *(t.data_ptr() for t in outs), B, Sq, Sk, H,
        K, Dh, _build.DTYPE_CODES[q.dtype],
        Sq if q_positions.shape[0] > 1 else 0,
        Sk if kv_positions.shape[0] > 1 else 0, float(scale), int(causal),
        int(window or 0), float(softcap or 0.0), _build.stream_ptr(q.device))
    _build.check_launch(rc, name)


def bwd_dq(q, k, v, do, lse, delta, *, q_positions, kv_positions,
           causal=True, window=None, softcap=None, scale=None) -> torch.Tensor:
    """The dq kernel on CUDA tensors (``flash_attention_bwd`` is the entry
    that routes by device). delta = rowsum(do * o) as (B, H, Sq) f32;
    positions int32 (1|B, S). Returns dq in q's dtype."""
    dq = torch.empty_like(q)
    _bwd_launch("flash_attention_bwd_dq", (dq,), q, k, v, do, lse, delta,
                q_positions, kv_positions, causal, window, softcap,
                q.shape[-1] ** -0.5 if scale is None else scale)
    bwd_dq.launches += 1
    return dq


def bwd_dkv(q, k, v, do, lse, delta, *, q_positions, kv_positions,
            causal=True, window=None, softcap=None, scale=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel on CUDA tensors: (dk, dv) in k's dtype, summed over
    the q heads of each kv head inside the kernel. Arguments as ``bwd_dq``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkv", (dk, dv), q, k, v, do, lse, delta,
                q_positions, kv_positions, causal, window, softcap,
                q.shape[-1] ** -0.5 if scale is None else scale)
    bwd_dkv.launches += 1
    return dk, dv


bwd_dq.launches = 0
bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, q_positions, kv_positions,
                        causal=True, window=None, softcap=None, scale=None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's o and lse. CPU tensors take the plain
    version; CUDA tensors launch the dq and dk/dv kernels or raise."""
    kw = dict(q_positions=q_positions, kv_positions=kv_positions,
              causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return plain_bwd(q, k, v, o, lse, do, **kw)
    kw["q_positions"] = q_positions.to(device=q.device,
                                       dtype=torch.int32).contiguous()
    kw["kv_positions"] = kv_positions.to(device=q.device,
                                         dtype=torch.int32).contiguous()
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable attention through the flash kernels: the forward saves
    q, k, v, o, lse and the positions (with ``save_for_backward``, so
    ``torch.utils.checkpoint`` may drop and recompute them), the backward
    runs ``flash_attention_bwd``. Returns o only. The JAX counterpart is the
    ``custom_vjp`` of ``src/repro/kernels/flash_attention.py``."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window,
                softcap, scale):
        o, lse = flash_attention(q, k, v, q_positions=q_positions,
                                 kv_positions=kv_positions, causal=causal,
                                 window=window, softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse, q_positions, kv_positions)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, qp, kp = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, q_positions=qp,
                                         kv_positions=kp, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None
