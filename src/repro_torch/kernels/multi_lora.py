"""Multi-LoRA apply: the CUDA kernels ``csrc/multi_lora.cu`` (BGMV: each token
row gathers its own adapter, from a f32 bank or from an int8 bank dequantised
on load) and their plain PyTorch versions, and the per-row int8 quantisation
of adapter banks. ``plan`` cuts a launch into tiles of rows and slices of
output columns; the kernels sum in one order whatever the plan, so a row's
bits do not depend on it.

Replaces the TPU kernels ``src/repro/kernels/multi_lora.py:_kernel`` (entry
``multi_lora``) and ``_q8_kernel`` (entry ``multi_lora_q8``).
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from repro_torch.kernels import _build, ref

MAX_RANK = 256
MAX_WARPS = 8       # a row's shrink group: min(8, ceil(d_in / 128)) warps
TILES = (32, 16, 8, 4, 2)   # rows a block takes, largest first
BLOCKS = 256        # blocks a launch aims at: about two an SM of the H100's 132
SLICE_QUADS = 32    # output quads (4 columns each) a block takes at a tick
MAX_SMEM = 232448   # bytes of shared memory a block can have

plain = ref.multi_lora
plain_q8 = ref.multi_lora_q8


def shrink_warps(d_in: int) -> int:
    """Warps that take one row's shrink (``csrc/multi_lora.cu``): the d axis
    in quads of 4, thread t owning quads t, t + 32 warps, ..."""
    return min(MAX_WARPS, -(-d_in // 128))


def smem_bytes(tile: int, d_in: int, r: int, x_bytes: int) -> int:
    """Shared memory of a block of ``tile`` rows: a zero quad, the warps'
    partial sums, xa and the adapter ids in f32 / int32 (16-byte aligned),
    then the x tile with rows padded to quads."""
    floats = -(-(4 + tile * ((shrink_warps(d_in) + 1) * r + 1)) // 4) * 4
    return 4 * floats + tile * 4 * -(-d_in // 4) * x_bytes


def plan(T: int, d_in: int, d_out: int, r: int, x_bytes: int) -> tuple[int, int]:
    """(tile rows, slice quads) of one launch. A tile takes consecutive rows
    and a slice takes consecutive output quads of 4 columns; the grid is
    ceil(T / tile) x ceil(ceil(d_out / 4) / slice quads). The largest tile
    that still gives ``BLOCKS`` blocks (and fits in shared memory) reads each
    adapter run once a tile; with tiles of one row (a decode tick) the columns
    are cut into slices of ``SLICE_QUADS`` quads, as many as it takes to reach
    ``BLOCKS`` blocks, so a few rows still spread over the card."""
    tile = next((t for t in TILES if -(-T // t) >= BLOCKS
                 and smem_bytes(t, d_in, r, x_bytes) <= MAX_SMEM), 1)
    nq = -(-d_out // 4)
    slices = 1 if tile > 1 else max(1, min(-(-nq // SLICE_QUADS),
                                           -(-BLOCKS // T)))
    return tile, -(-nq // slices)


def _fn(name: str = "multi_lora"):
    fn = getattr(_build.load("multi_lora"), name)
    n_ptr = 7 if name.endswith("_q8") else 5   # + the two scale arrays
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def quant_rows(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric int8 quantisation of an adapter leaf:
    scale = max |w| / 127 (at least 1e-12), codes = round(w / scale) clipped
    to [-127, 127], rounding half to even as JAX does. Returns (codes int8,
    scale f32 with a trailing axis of 1). The same bits on every device: the
    divisor is a tensor on w's device, because CUDA divides by a Python
    scalar as a multiplication by its reciprocal, which can move a scale by
    one ulp."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-1, keepdim=True)
    scale = (amax / amax.new_tensor(127.0)).clamp(min=1e-12)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequant_rows(q: torch.Tensor, scale: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quant_rows`` (codes * scale in f32), for tests and host
    reads; the serving path never calls it: the kernel dequantises on load."""
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def _check(name: str, x, A, B, idx) -> None:
    """Device, dtype and shape checks shared by both wrappers: x (T, d_in)
    bf16|f32, A (U, d_in, r), B (U, r, d_out), idx (T,), all contiguous."""
    req = partial(_build.require, kernel=name)
    req(x.is_cuda and A.device == x.device and B.device == x.device
        and idx.device == x.device, what="x, the bank and idx must be CUDA "
        "tensors on one device")
    req(x.dtype in _build.DTYPE_CODES, what=f"x dtype {x.dtype}")
    T, d_in = x.shape
    U, _, r = A.shape
    req(A.shape == (U, d_in, r) and B.dim() == 3 and B.shape[:2] == (U, r)
        and idx.shape == (T,) and 1 <= r <= MAX_RANK,
        what=f"shapes x {tuple(x.shape)} A {tuple(A.shape)} "
        f"B {tuple(B.shape)} idx {tuple(idx.shape)}")
    req(x.is_contiguous() and A.is_contiguous() and B.is_contiguous(),
        what="x and the bank must be contiguous")


def multi_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               idx: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """y[t] = scale * (x[t] @ A[idx[t]]) @ B[idx[t]]; rows with idx < 0 are
    exact zeros. x: (T, d_in) bf16|f32; A: (U, d_in, r) f32; B: (U, r, d_out)
    f32; idx: (T,) int. Output in x's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return plain(x, A, B, idx, scale=scale)
    name = "multi_lora"
    _check(name, x, A, B, idx)
    req = partial(_build.require, kernel=name)
    req(A.dtype == torch.float32 and B.dtype == torch.float32,
        what=f"bank dtype {A.dtype}/{B.dtype} (f32 banks only)")
    _build.require_no_grad(name, x, A, B)
    T, d_out = x.shape[0], B.shape[-1]
    U, d_in, r = A.shape

    y = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    ix = idx.to(torch.int32).contiguous()
    rc = _fn()(x.data_ptr(), A.data_ptr(), B.data_ptr(), ix.data_ptr(),
               y.data_ptr(), T, U, d_in, r, d_out, _build.DTYPE_CODES[x.dtype],
               float(scale), *plan(T, d_in, d_out, r, x.element_size()),
               _build.stream_ptr(x.device))
    _build.check_launch(rc, name)
    multi_lora.launches += 1
    return y


multi_lora.launches = 0


def multi_lora_q8(x: torch.Tensor, A_q: torch.Tensor, A_scale: torch.Tensor,
                  B_q: torch.Tensor, B_scale: torch.Tensor, idx: torch.Tensor,
                  scale: float = 1.0) -> torch.Tensor:
    """``multi_lora`` from an int8 bank: A_q (U, d_in, r) int8 with per-row
    scales A_scale (U, d_in, 1) f32, B_q (U, r, d_out) int8 with B_scale
    (U, r, 1) f32 (``quant_rows``). Rows with idx < 0 are exact zeros; output
    in x's dtype. CPU tensors take the plain version (which dequantises only
    the gathered rows); CUDA tensors launch the kernel, which reads the codes
    and scales and dequantises on load, or raise."""
    if x.device.type == "cpu":
        return plain_q8(x, A_q, A_scale, B_q, B_scale, idx, scale=scale)
    name = "multi_lora_q8"
    _check(name, x, A_q, B_q, idx)
    T, d_out = x.shape[0], B_q.shape[-1]
    U, d_in, r = A_q.shape
    req = partial(_build.require, kernel=name)
    req(A_q.dtype == torch.int8 and B_q.dtype == torch.int8,
        what=f"code dtype {A_q.dtype}/{B_q.dtype} (int8 only)")
    req(A_scale.dtype == torch.float32 and B_scale.dtype == torch.float32
        and A_scale.shape == (U, d_in, 1) and B_scale.shape == (U, r, 1)
        and A_scale.device == x.device and B_scale.device == x.device
        and A_scale.is_contiguous() and B_scale.is_contiguous(),
        what=f"scales must be contiguous f32 (U, d_in, 1) and (U, r, 1) on "
        f"the card, got {tuple(A_scale.shape)} {A_scale.dtype} and "
        f"{tuple(B_scale.shape)} {B_scale.dtype}")
    _build.require_no_grad(name, x, A_scale, B_scale)

    y = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    ix = idx.to(torch.int32).contiguous()
    rc = _fn(name)(x.data_ptr(), A_q.data_ptr(), A_scale.data_ptr(),
                   B_q.data_ptr(), B_scale.data_ptr(), ix.data_ptr(),
                   y.data_ptr(), T, U, d_in, r, d_out,
                   _build.DTYPE_CODES[x.dtype], float(scale),
                   *plan(T, d_in, d_out, r, x.element_size()),
                   _build.stream_ptr(x.device))
    _build.check_launch(rc, name)
    multi_lora_q8.launches += 1
    return y


multi_lora_q8.launches = 0
