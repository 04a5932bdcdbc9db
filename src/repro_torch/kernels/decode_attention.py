"""Single-query decode attention: the CUDA kernel ``csrc/decode_attention.cu``
(a dense slot cache, a paged block pool read through a block table, and the
pairs plan's per-slot rings) and its plain PyTorch versions.

Replaces the TPU kernels ``src/repro/kernels/decode_attention.py:_kernel``
(entry ``decode_attention``) and ``_kernel_paged`` (entry
``decode_attention_paged``); ``decode_attention_ring`` is the paged kernel
with the table lookup replaced by ``t % W_ring`` (JAX runs its ring op as
plain jnp on every backend).

The kernel splits each (slot, kv head)'s walk over the cache into splits of
``SPLIT`` positions, one block each, and merges the splits in the same launch:
each block of a slot with more than one live split writes its partial
(m, l, acc) to an f32 workspace that the wrapper allocates on every call, and
the last block to arrive, told by an int32 counter per (slot, kv head), merges
them in split order. The counters are kept per device, made zero once (anew
when ``B * KH`` grows), and every launch leaves them at zero.

``decode_attention(..., return_lse=True)`` also gives each head's
log-sum-exp (B, H) f32 and o in f32: the partials of a cache split by
position over ranks, each rank's block attended with its positions shifted
by the block's offset and merged by ``distributed.tensor_parallel.merge``.
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 112, 128, 256)
SPLIT = 128   # positions per block; csrc/decode_attention.cu's DECODE_SPLIT

_COUNTERS: dict[torch.device, torch.Tensor] = {}

plain = ref.sdpa_decode
plain_paged = ref.sdpa_decode_paged
plain_ring = ref.sdpa_decode_ring


def _fn(name: str = "decode_attention"):
    fn = getattr(_build.load("decode_attention"), name)
    paged = name.endswith("_paged")   # + block_table; + bs
    ring = name.endswith("_ring")     # + w_ring
    # the dense entry's ninth pointer is lse, the paged one's block_table
    fn.argtypes = ([ctypes.c_void_p] * (8 if ring else 9)
                   + [ctypes.c_int] * (8 if paged or ring else 7)
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _scratch(q: torch.Tensor, Smax: int, K: int):
    """The launch's f32 workspace for the splits' partials (from the caching
    allocator, no launch) and the device's zeroed (B * K,) int32 counters."""
    B, _, H, Dh = q.shape
    n_split = -(-Smax // SPLIT)
    ws = torch.empty(B * H * n_split * (Dh + 2) if n_split > 1 else 1,
                     dtype=torch.float32, device=q.device)
    cnt = _COUNTERS.get(q.device)
    if cnt is None or cnt.numel() < B * K:
        cnt = _COUNTERS[q.device] = torch.zeros(B * K, dtype=torch.int32,
                                                device=q.device)
    return ws, cnt


def _check_common(name: str, q, k, v, positions, live):
    """Checks shared by the dense and paged wrappers; returns the positions
    as int32 and ``live`` on the card (or None)."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    req = partial(_build.require, kernel=name)
    req(q.is_cuda and k.device == q.device and v.device == q.device,
        what="q and caches must be CUDA tensors on one device")
    req(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
        and v.dtype == q.dtype, what=f"dtype {q.dtype}/{k.dtype}/{v.dtype}")
    req(Sq == 1, what=f"one query per slot, got Sq={Sq}")
    req(Dh in HEAD_DIMS, what=f"head dim {Dh} not in {HEAD_DIMS}")
    req(k.shape == v.shape and k.dim() == 4 and k.shape[3] == Dh
        and H % K == 0,
        what=f"shapes q {tuple(q.shape)} cache {tuple(k.shape)}")
    req(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
        what="q and caches must be contiguous")
    req(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
        what="caches must be 16-byte aligned")
    _build.require_no_grad(name, q, k, v)
    req(positions.shape == (B,), what=f"positions shape {tuple(positions.shape)}")
    pos = positions.to(device=q.device, dtype=torch.int32).contiguous()
    if live is not None:
        req(live.shape == (B,) and live.dtype == torch.bool
            and live.device == q.device, what="live must be a (B,) bool CUDA tensor")
        live = live.contiguous()
    return pos, live


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor, *,
                     live: torch.Tensor | None = None, window: int | None = None,
                     softcap: float | None = None, scale: float | None = None,
                     return_lse: bool = False):
    """q: (B, 1, H, Dh); caches: (B, Smax, K, Dh); positions: (B,) int;
    live: (B,) bool or None (all live). Returns (B, 1, H, Dh); with
    ``return_lse``, (o in f32, lse (B, H) f32), an empty slot's o 0 and lse
    -inf. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, positions, live=live, window=window,
                     softcap=softcap, scale=scale, return_lse=return_lse)
    B, _, H, Dh = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = Dh ** -0.5
    name = "decode_attention"
    pos, live = _check_common(name, q, k_cache, v_cache, positions, live)
    _build.require(k_cache.shape[0] == B, name,
                   f"cache batch {k_cache.shape[0]} != {B}")

    o = torch.empty_like(q, dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    ws, cnt = _scratch(q, Smax, K)
    rc = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               pos.data_ptr(), None if live is None else live.data_ptr(),
               o.data_ptr(), None if lse is None else lse.data_ptr(),
               ws.data_ptr(), cnt.data_ptr(), B, Smax, H, K, Dh,
               _build.DTYPE_CODES[q.dtype], SPLIT, float(scale),
               int(window or 0), float(softcap or 0.0),
               _build.stream_ptr(q.device))
    _build.check_launch(rc, name)
    decode_attention.launches += 1
    return (o, lse) if return_lse else o


decode_attention.launches = 0


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, positions: torch.Tensor,
                           block_table: torch.Tensor, *,
                           live: torch.Tensor | None = None,
                           window: int | None = None,
                           softcap: float | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, Dh); pools: (n_blocks, bs, K, Dh) shared by all slots;
    block_table: (B, max_blocks) int32, position p of slot b at pool row
    ``block_table[b, p // bs]``, offset ``p % bs`` (every entry must index the
    pool; unallocated entries point at block 0); positions: (B,) int; live:
    (B,) bool or None. bs must be a multiple of 8. Returns (B, 1, H, Dh). CPU
    tensors take the plain version (a gather into a dense view); CUDA tensors
    launch the kernel, which reads the pool through the table, or raise."""
    if q.device.type == "cpu":
        return plain_paged(q, k_pool, v_pool, positions, block_table,
                           live=live, window=window, softcap=softcap,
                           scale=scale)
    B, _, H, Dh = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    if scale is None:
        scale = Dh ** -0.5
    name = "decode_attention_paged"
    pos, live = _check_common(name, q, k_pool, v_pool, positions, live)
    req = partial(_build.require, kernel=name)
    req(bs % 8 == 0, what=f"block size {bs} is not a multiple of 8")
    req(block_table.dim() == 2 and block_table.shape[0] == B
        and block_table.dtype == torch.int32
        and block_table.device == q.device and block_table.is_contiguous(),
        what=f"block_table must be a contiguous (B, max_blocks) int32 CUDA "
        f"tensor, got {tuple(block_table.shape)} {block_table.dtype}")

    o = torch.empty_like(q)
    ws, cnt = _scratch(q, block_table.shape[1] * bs, K)
    rc = _fn(name)(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   pos.data_ptr(), None if live is None else live.data_ptr(),
                   block_table.data_ptr(), o.data_ptr(), ws.data_ptr(),
                   cnt.data_ptr(), B, block_table.shape[1], bs, H, K, Dh,
                   _build.DTYPE_CODES[q.dtype], SPLIT, float(scale),
                   int(window or 0), float(softcap or 0.0),
                   _build.stream_ptr(q.device))
    _build.check_launch(rc, name)
    decode_attention_paged.launches += 1
    return o


decode_attention_paged.launches = 0


def decode_attention_ring(q: torch.Tensor, k_ring: torch.Tensor,
                          v_ring: torch.Tensor, positions: torch.Tensor, *,
                          horizon: int | None = None,
                          live: torch.Tensor | None = None,
                          window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, Dh); rings: (B, W_ring, K, Dh), position t of slot b at
    ring row ``t % W_ring``; positions: (B,) int; live: (B,) bool or None.
    ``horizon``: the slots' virtual horizon (the dense cache's length), which
    sets the kernel's splits, so a ring tick gives the bits of a dense tick
    with the same window; the window must lie in [1, W_ring]. Returns
    (B, 1, H, Dh). CPU tensors take the plain version (JAX's position-ordered
    gather, ``ref.sdpa_decode_ring``); CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return plain_ring(q, k_ring, v_ring, positions, live=live,
                          window=window, softcap=softcap, scale=scale)
    B, _, H, Dh = q.shape
    W, K = k_ring.shape[1], k_ring.shape[2]
    if scale is None:
        scale = Dh ** -0.5
    name = "decode_attention_ring"
    pos, live = _check_common(name, q, k_ring, v_ring, positions, live)
    req = partial(_build.require, kernel=name)
    req(k_ring.shape[0] == B, what=f"ring batch {k_ring.shape[0]} != {B}")
    req(horizon is not None and horizon >= 1,
        what="the slots' virtual horizon is required (it sets the splits)")
    req(window is not None and 1 <= window <= W,
        what=f"window {window} must lie in [1, W_ring={W}]: the ring holds "
        "only the last W_ring positions")

    o = torch.empty_like(q)
    ws, cnt = _scratch(q, horizon, K)
    rc = _fn(name)(q.data_ptr(), k_ring.data_ptr(), v_ring.data_ptr(),
                   pos.data_ptr(), None if live is None else live.data_ptr(),
                   o.data_ptr(), ws.data_ptr(), cnt.data_ptr(), B, horizon, W,
                   H, K, Dh, _build.DTYPE_CODES[q.dtype], SPLIT, float(scale),
                   int(window), float(softcap or 0.0),
                   _build.stream_ptr(q.device))
    _build.check_launch(rc, name)
    decode_attention_ring.launches += 1
    return o


decode_attention_ring.launches = 0
