"""ColA fit gradient of the low-rank family: the CUDA kernel
``csrc/cola_fit.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/cola_fit.py:_kernel`` (entry
``cola_fit_lowrank``). Where the JAX package vmaps the kernel over the layer
axis (``core/gl.py:fit_grads``), this kernel takes the layer axis itself: one
launch fits one tap for every layer.
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from repro_torch.kernels import _build, ref
from repro_torch.utils import cdiv, round_up

plain = ref.cola_fit_lowrank

SMEM_LIMIT = 232448      # bytes of shared memory a block may use on Hopper
ROW_TILES = (16, 8, 4, 2, 1)


def _lib():
    lib = _build.load("cola_fit")
    lib.cola_fit.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                             + [ctypes.c_float, ctypes.c_void_p])
    lib.cola_fit.restype = ctypes.c_int
    lib.cola_fit_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.cola_fit_smem_bytes.restype = ctypes.c_size_t
    lib.cola_fit_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    lib.cola_fit_blocks_per_sm.restype = ctypes.c_int
    return lib


def plan(lib, device: torch.device, L: int, T: int, d_in: int, d_out: int,
         r: int) -> tuple[int, int, int]:
    """(row tile, rows per chunk, chunks): the largest row tile whose shared
    memory fits, and T split into as many chunks as the card holds blocks at
    once over the L layers (one wave; at least 64 rows a chunk). Depends on
    the shapes and the card alone, so a refit reduces in the same order."""
    tt = next((t for t in ROW_TILES
               if lib.cola_fit_smem_bytes(d_in, d_out, r, t) <= SMEM_LIMIT), 0)
    _build.require(tt > 0, "cola_fit", f"dims {d_in} + {d_out} at rank {r} "
                   "do not fit in shared memory")
    per_sm = lib.cola_fit_blocks_per_sm(d_in, d_out, r, tt)
    _build.require(per_sm > 0, "cola_fit", "occupancy query failed")
    resident = per_sm * torch.cuda.get_device_properties(
        device).multi_processor_count
    n_chunks = max(1, min(cdiv(T, 64), resident // L))
    rows_per = round_up(cdiv(T, n_chunks), tt)
    return tt, rows_per, cdiv(T, rows_per)


def cola_fit_lowrank(x: torch.Tensor, grad_h: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, scale: float = 1.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dA, dB) = (s x^T (g B^T), s (x A)^T g) in f32. x: ([L,] T, d_in);
    grad_h: ([L,] T, d_out); A: ([L,] d_in, r); B: ([L,] r, d_out). CPU
    tensors take the plain version; CUDA tensors (f32) launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return plain(x, grad_h, A, B, scale=scale)
    if x.dim() == 2:
        dA, dB = cola_fit_lowrank(x[None], grad_h[None], A[None], B[None],
                                  scale=scale)
        return dA[0], dB[0]
    L, T, d_in = x.shape
    r, d_out = B.shape[-2], B.shape[-1]

    name = "cola_fit"
    req = partial(_build.require, kernel=name)
    req(all(t.is_cuda and t.device == x.device for t in (grad_h, A, B)),
        what="x, grad_h, A, B must be CUDA tensors on one device")
    req(all(t.dtype == torch.float32 for t in (x, grad_h, A, B)),
        what=f"dtypes {x.dtype}/{grad_h.dtype}/{A.dtype}/{B.dtype} (f32 only)")
    req(grad_h.shape == (L, T, d_out) and A.shape == (L, d_in, r)
        and B.shape == (L, r, d_out),
        what=f"shapes x {tuple(x.shape)} grad_h {tuple(grad_h.shape)} "
        f"A {tuple(A.shape)} B {tuple(B.shape)}")
    _build.require_no_grad(name, x, grad_h, A, B)
    x, grad_h, A, B = (t.contiguous() for t in (x, grad_h, A, B))

    dA = torch.empty((L, d_in, r), dtype=torch.float32, device=x.device)
    dB = torch.empty((L, r, d_out), dtype=torch.float32, device=x.device)
    if T == 0:
        return dA.zero_(), dB.zero_()
    lib = _lib()
    tt, rows_per, n_chunks = plan(lib, x.device, L, T, d_in, d_out, r)
    part = torch.empty(L * n_chunks * (d_in + d_out) * r, dtype=torch.float32,
                       device=x.device)
    rc = lib.cola_fit(x.data_ptr(), grad_h.data_ptr(), A.data_ptr(),
                      B.data_ptr(), part.data_ptr(), dA.data_ptr(),
                      dB.data_ptr(), L, T, d_in, d_out, r, n_chunks, rows_per,
                      tt, float(scale), _build.stream_ptr(x.device))
    _build.check_launch(rc, name)
    cola_fit_lowrank.launches += 1
    return dA, dB


cola_fit_lowrank.launches = 0
