"""Multi-LoRA apply: the CUDA kernel ``csrc/multi_lora.cu`` (BGMV: each token
row gathers its own adapter) and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/multi_lora.py:_kernel`` (entry
``multi_lora``). The int8-bank variant (``_q8_kernel``) is still to be ported
(ROADMAP.md).
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from repro_torch.kernels import _build, ref

MAX_RANK = 256

plain = ref.multi_lora


def _fn():
    fn = _build.load("multi_lora").multi_lora
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def multi_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               idx: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """y[t] = scale * (x[t] @ A[idx[t]]) @ B[idx[t]]; rows with idx < 0 are
    exact zeros. x: (T, d_in) bf16|f32; A: (U, d_in, r) f32; B: (U, r, d_out)
    f32; idx: (T,) int. Output in x's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return plain(x, A, B, idx, scale=scale)
    T, d_in = x.shape
    U, _, r = A.shape
    d_out = B.shape[-1]

    name = "multi_lora"
    req = partial(_build.require, kernel=name)
    req(x.is_cuda and A.device == x.device and B.device == x.device
        and idx.device == x.device, what="x, A, B, idx must be CUDA tensors "
        "on one device")
    req(x.dtype in _build.DTYPE_CODES, what=f"x dtype {x.dtype}")
    req(A.dtype == torch.float32 and B.dtype == torch.float32,
        what=f"bank dtype {A.dtype}/{B.dtype} (f32 banks only)")
    req(A.shape == (U, d_in, r) and B.shape == (U, r, d_out)
        and idx.shape == (T,) and 1 <= r <= MAX_RANK,
        what=f"shapes x {tuple(x.shape)} A {tuple(A.shape)} "
        f"B {tuple(B.shape)} idx {tuple(idx.shape)}")
    req(x.is_contiguous() and A.is_contiguous() and B.is_contiguous(),
        what="x, A, B must be contiguous")
    _build.require_no_grad(name, x, A, B)

    y = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    ix = idx.to(torch.int32).contiguous()
    rc = _fn()(x.data_ptr(), A.data_ptr(), B.data_ptr(), ix.data_ptr(),
               y.data_ptr(), T, U, d_in, r, d_out, _build.DTYPE_CODES[x.dtype],
               float(scale), _build.stream_ptr(x.device))
    _build.check_launch(rc, name)
    multi_lora.launches += 1
    return y


multi_lora.launches = 0
