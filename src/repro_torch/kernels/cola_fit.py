"""ColA fit gradient of the low-rank family: the CUDA kernel
``csrc/cola_fit.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/cola_fit.py:_kernel`` (entry
``cola_fit_lowrank``). Where the JAX package vmaps the kernel over the layer
axis (``core/gl.py:fit_grads``), this kernel takes the layer axis itself: one
launch fits one tap for every layer.

The launch is planned here, by pure functions of the shapes and the card
(``config``, ``grid``, ``layer_chunks``), so the CPU tests can check the
plan: which instantiation runs, how the L x ceil(T / tile) row tiles are cut
into one wave of chunks, and which chunks' partials each layer adds.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.kernels import _build, ref
from repro_torch.utils import cdiv

plain = ref.cola_fit_lowrank

SMEM_LIMIT = 232448      # bytes of shared memory a block may use on Hopper
STAGES = 4               # ring stages of the register kernel (csrc STAGES)
# register kernel (csrc/cola_fit.cu fit_reg_kernel<RB, CPT, TT>): for each rank
# block, its (columns a thread, rows a tile, most threads), fewest columns first
REG_KERNELS = {4: ((6, 8, 384),), 8: ((3, 8, 384), (6, 4, 352)),
               16: ((3, 8, 384),)}
# shared-memory kernel (fit_smem_kernel<8>): 4 x warps + 4 g warps
SMEM_RB, SMEM_THREADS, SMEM_TILE = 8, 256, 16


@dataclass(frozen=True)
class Config:
    """One launch's instantiation and block shape."""
    variant: int      # 0: accumulators in registers; 1: in shared memory
    rb: int           # rank block (ranks padded up to it)
    cpt: int          # columns a thread (register kernel)
    threads: int
    wx: int           # warps on x columns (the rest on g columns)
    tt: int           # rows a tile
    smem: int         # bytes of dynamic shared memory
    n_rb: int         # rank blocks
    n_split: int      # column slices (shared-memory kernel)
    slice: int        # columns a slice


GRID_Y = 65535           # blocks the grid's second axis may hold


def takes(d_in: int, d_out: int, r: int) -> bool:
    """The shapes the kernel takes: every width and rank whose plan fits the
    launch. ``config`` routes a shape to the register kernel or else to the
    shared-memory kernel with its columns split over the grid's second axis,
    whose blocks (rank blocks x column slices) may number ``GRID_Y``; a
    layer's (d_in + d_out) r accumulators are indexed in 32 bits. That takes
    every shape JAX's kernel takes (``supported``: d_in and d_out up to 8192,
    r up to 256), gemma2's and mistral-nemo's q taps among them."""
    if min(d_in, d_out, r) < 1 or (d_in + d_out) * r >= 2 ** 31:
        return False
    c = config(d_in, d_out, r)
    return c.n_rb * c.n_split <= GRID_Y


def _reg_smem(tt: int, d: int, warps: int, rb: int) -> int:
    """Bytes of the register kernel's shared memory: the ring, the warps'
    partials of two tiles and the two tiles' xa and gb."""
    return 4 * (-(-STAGES * tt * d // 4) * 4 + (2 * warps + 4) * tt * rb)


def config(d_in: int, d_out: int, r: int) -> Config:
    """The register kernel where an instantiation holds the widths in its
    threads and its ring fits shared memory; else the shared-memory kernel,
    its columns split so that each slice's accumulators fit."""
    rb = next((b for b in REG_KERNELS if r <= b), 16)
    n_rb = cdiv(r, rb)
    for cpt, tt, most in REG_KERNELS[rb]:
        wx, wg = cdiv(d_in, 32 * cpt), cdiv(d_out, 32 * cpt)
        if 32 * (wx + wg) > most:
            continue
        smem = _reg_smem(tt, d_in + d_out, wx + wg, rb)
        if smem <= SMEM_LIMIT:
            return Config(0, rb, cpt, 32 * (wx + wg), wx, tt, smem, n_rb, 1, 0)
    rb, tt, nw = SMEM_RB, SMEM_TILE, SMEM_THREADS // 32
    fixed = (nw + 2) * tt * rb
    cols = (SMEM_LIMIT // 4 - fixed) // rb
    n_split = cdiv(d_in + d_out, cols)
    slc = cdiv(d_in + d_out, n_split)
    return Config(1, rb, 0, SMEM_THREADS, nw // 2, tt, 4 * (slc * rb + fixed),
                  cdiv(r, rb), n_split, slc)


def grid(L: int, T: int, tile: int, per_sm: int, sms: int, n_y: int = 1
         ) -> tuple[int, int]:
    """(chunks, tiles a layer): the L x ceil(T / tile) row tiles cut into as
    many chunks as the card holds blocks at once beside the n_y blocks of the
    second grid axis (one wave), and never more chunks than tiles."""
    n_tiles = cdiv(T, tile)
    return max(1, min(L * n_tiles, per_sm * sms // n_y)), n_tiles


def chunk_tiles(b: int, L: int, n_tiles: int, G: int) -> tuple[int, int]:
    """Chunk b's flattened (layer, tile) indices [f0, f1), as the kernel
    cuts them: equal within one tile."""
    work = L * n_tiles
    return b * work // G, (b + 1) * work // G


def layer_chunks(l: int, L: int, n_tiles: int, G: int) -> tuple[int, int]:
    """(b1, b2): the first and last chunk whose tiles meet layer l, as the
    reduction kernel computes them; layer l's partials are slots b + l."""
    work = L * n_tiles
    lo, hi = l * n_tiles, (l + 1) * n_tiles
    return ((lo + 1) * G - 1) // work, (hi * G - 1) // work


def _lib():
    lib = _build.load("cola_fit")
    lib.cola_fit.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                             + [ctypes.c_void_p, ctypes.c_float,
                                ctypes.c_void_p])
    lib.cola_fit.restype = ctypes.c_int
    lib.cola_fit_blocks_per_sm.argtypes = [ctypes.c_int] * 5
    lib.cola_fit_blocks_per_sm.restype = ctypes.c_int
    return lib


def plan(lib, device: torch.device, L: int, T: int, d_in: int, d_out: int,
         r: int) -> tuple[Config, int]:
    """(config, chunks) of one launch. Depends on the shapes and the card
    alone, so a refit adds the same partials in the same order."""
    _build.require(takes(d_in, d_out, r), "cola_fit", f"dims {d_in} + "
                   f"{d_out} at rank {r} do not fit the launch")
    cfg = config(d_in, d_out, r)
    per_sm = lib.cola_fit_blocks_per_sm(cfg.variant, cfg.rb, cfg.cpt,
                                        cfg.threads, cfg.smem)
    _build.require(per_sm > 0, "cola_fit", f"occupancy query gave {per_sm} "
                   f"for {cfg}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    G, _ = grid(L, T, cfg.tt, per_sm, sms, cfg.n_rb * cfg.n_split)
    return cfg, G


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
    if T == 0 or L == 0:
        return dA.zero_(), dB.zero_()
    lib = _lib()
    cfg, G = plan(lib, x.device, L, T, d_in, d_out, r)
    vec = (d_in % 4 == 0 and d_out % 4 == 0 and x.data_ptr() % 16 == 0
           and grad_h.data_ptr() % 16 == 0)
    args = (ctypes.c_int * 12)(cfg.variant, cfg.rb, cfg.cpt, cfg.threads,
                               cfg.wx, cfg.tt, cfg.smem, G, cfg.n_rb,
                               cfg.n_split, cfg.slice, int(vec))
    part = torch.empty((G + L - 1) * (d_in + d_out) * r, dtype=torch.float32,
                       device=x.device)
    rc = lib.cola_fit(x.data_ptr(), grad_h.data_ptr(), A.data_ptr(),
                      B.data_ptr(), part.data_ptr(), dA.data_ptr(),
                      dB.data_ptr(), L, T, d_in, d_out, r, args, float(scale),
                      _build.stream_ptr(x.device))
    _build.check_launch(rc, name)
    cola_fit_lowrank.launches += 1
    return dA, dB


cola_fit_lowrank.launches = 0
