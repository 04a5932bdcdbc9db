"""Plain PyTorch versions of the kernels on the serving and training paths.

These are the semantics of the kernels (ported from the JAX package's
``kernels/ref.py``): the CPU path of every wrapper, and the yardstick each
CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
# query rows a block of ``sdpa`` and ``sdpa_bwd`` where Sq is large
Q_BLOCK = 512


# ---------------------------------------------------------------------------
# scaled dot-product attention (flash_attention oracle)
# ---------------------------------------------------------------------------

def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         q_positions: torch.Tensor, kv_positions: torch.Tensor,
         causal: bool = True, window: int | None = None,
         softcap: float | None = None, scale: float | None = None,
         with_lse: bool = False):
    """Reference GQA attention. Runs query blocks one at a time when Sq is
    large, so the full (Sq, Sk) score matrix is never materialised.

    q: (B, Sq, H, Dh); k, v: (B, Sk, K, Dh) with H = K * G.
    q_positions: (B, Sq) or (1, Sq); kv_positions: (B, Sk) or (1, Sk).
    Masking: causal -> kv_pos <= q_pos; window -> kv_pos > q_pos - window.
    ``with_lse`` also returns the per-row log-sum-exp (B, H, Sq) in f32
    (NEG_INF for a fully masked row), as the flash kernel does.
    """
    B, Sq = q.shape[0], q.shape[1]
    if Sq > 2 * Q_BLOCK and Sq % Q_BLOCK == 0:
        qp = q_positions.expand(B, Sq)
        outs = [_sdpa_dense(q[:, i:i + Q_BLOCK], k, v,
                            q_positions=qp[:, i:i + Q_BLOCK],
                            kv_positions=kv_positions, causal=causal,
                            window=window, softcap=softcap, scale=scale,
                            with_lse=with_lse)
                for i in range(0, Sq, Q_BLOCK)]
        if with_lse:
            return (torch.cat([o for o, _ in outs], dim=1),
                    torch.cat([l for _, l in outs], dim=2))
        return torch.cat(outs, dim=1)
    return _sdpa_dense(q, k, v, q_positions=q_positions,
                       kv_positions=kv_positions, causal=causal, window=window,
                       softcap=softcap, scale=scale, with_lse=with_lse)


def _sdpa_dense(q, k, v, *, q_positions, kv_positions, causal=True,
                window=None, softcap=None, scale=None, with_lse=False):
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = Dh ** -0.5
    # f32 math for bf16 and f32 inputs; f64 inputs stay f64 (a reference for
    # the f32 kernels' gradients)
    ct = torch.promote_types(q.dtype, torch.float32)
    qp = q_positions.to(torch.int32)[:, None, :, None]    # (B,1,Sq,1)
    kp = kv_positions.to(torch.int32)[:, None, None, :]   # (B,1,1,Sk)
    mask = torch.ones((1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None and window > 0:
        mask = mask & (kp > qp - window)
    mask = mask.expand(B, 1, Sq, Sk)

    # Grouped form: q heads (K, G) against the K kv heads, so KV is never
    # repeated in memory. Products accumulate in f32 like the MXU's.
    qg = q.reshape(B, Sq, K, G, Dh).to(ct)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(ct)) * scale
    s = s.reshape(B, H, Sq, Sk)
    if softcap is not None and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # rows with no valid key (fully masked) produce uniform p; zero them out.
    any_valid = mask.any(dim=-1, keepdim=True)
    p = torch.where(any_valid, p, torch.zeros_like(p))
    pg = p.to(q.dtype).to(ct).reshape(B, K, G, Sq, Sk)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg, v.to(ct)).reshape(B, Sq, H, Dh)
    o = o.to(q.dtype)
    if not with_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(any_valid[..., 0], lse, torch.full_like(lse, NEG_INF))
    return o, lse


def sdpa_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
             q_positions: torch.Tensor, kv_positions: torch.Tensor,
             causal: bool = True, window: int | None = None,
             softcap: float | None = None, scale: float | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of attention from the forward's o and lse
    (B, H, Sq) f32, the math of the JAX package's ``flash_attention._bwd``:
    delta = rowsum(do * o), p = exp(s - lse) under the mask,
    ds = p * (dp - delta) (times 1 - tanh^2 under softcap); dk and dv are
    summed over the G q-heads of each kv head. f32 math; each gradient in
    its input's dtype. Shapes and masking as ``sdpa``. Where Sq is large it
    runs query blocks one at a time, as ``sdpa`` does (dk and dv summed over
    the blocks in f32, in block order), so the (Sq, Sk) score matrix is
    never materialised.
    """
    kw = dict(kv_positions=kv_positions, causal=causal, window=window,
              softcap=softcap, scale=scale)
    B, Sq = q.shape[0], q.shape[1]
    if Sq > 2 * Q_BLOCK and Sq % Q_BLOCK == 0:
        qp = q_positions.expand(B, Sq)
        dq, dk, dv = [], None, None
        for i in range(0, Sq, Q_BLOCK):
            blk = slice(i, i + Q_BLOCK)
            dq_i, dk_i, dv_i = _sdpa_bwd_dense(
                q[:, blk], k, v, o[:, blk], lse[:, :, blk], do[:, blk],
                q_positions=qp[:, blk], **kw)
            dq.append(dq_i)
            dk = dk_i if dk is None else dk + dk_i
            dv = dv_i if dv is None else dv + dv_i
        dq = torch.cat(dq, dim=1)
    else:
        dq, dk, dv = _sdpa_bwd_dense(q, k, v, o, lse, do,
                                     q_positions=q_positions, **kw)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _sdpa_bwd_dense(q, k, v, o, lse, do, *, q_positions, kv_positions,
                    causal, window, softcap, scale):
    """``sdpa_bwd`` over the whole of q at once; the gradients in f32."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = Dh ** -0.5
    f32 = torch.float32
    qp = q_positions.to(torch.int32)[:, None, None, :, None]    # (B,1,1,Sq,1)
    kp = kv_positions.to(torch.int32)[:, None, None, None, :]   # (B,1,1,1,Sk)
    mask = torch.ones((1, 1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None and window > 0:
        mask = mask & (kp > qp - window)

    qg = q.reshape(B, Sq, K, G, Dh).to(f32)
    dog = do.reshape(B, Sq, K, G, Dh).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    delta = (dog * o.reshape(B, Sq, K, G, Dh).to(f32)).sum(-1)   # (B,Sq,K,G)
    delta = delta.permute(0, 2, 3, 1)[..., None]                 # (B,K,G,Sq,1)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    dcap = None
    if softcap is not None and softcap > 0:
        t = torch.tanh(s / softcap)
        s = t * softcap
        dcap = 1.0 - t * t
    lse_g = lse.to(f32).reshape(B, K, G, Sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), torch.zeros_like(s))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - delta)
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, Sq, H, Dh) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return dq, dk, dv


def sdpa_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                positions: torch.Tensor, *, live: torch.Tensor | None = None,
                window: int | None = None, softcap: float | None = None,
                scale: float | None = None, return_lse: bool = False):
    """Incremental attention against a slot KV cache (fused-kernel oracle).
    q: (B, Sq, H, Dh); caches: (B, Smax, K, Dh); positions: (B,) each row's
    first query position (query i sits at positions + i; the cache is valid at
    kv_pos <= that query's position). ``live``: (B,) bool; non-live slots
    return zeros.

    ``return_lse`` (a tick, Sq == 1): (o in f32, lse (B, H) f32), a row with
    no key it may see (dead, or every position masked: a cache block past
    its query) o 0 and lse -inf. Positions may be negative or past Smax: a
    block [c S_b, (c + 1) S_b) of a longer cache is attended at positions -
    c S_b (``tensor_parallel.merge`` joins the blocks).
    """
    B, Sq = q.shape[0], q.shape[1]
    Smax = k_cache.shape[1]
    ar_q = torch.arange(Sq, dtype=torch.int32, device=q.device)
    q_pos = positions.to(torch.int32)[:, None] + ar_q[None]
    kv_pos = torch.arange(Smax, dtype=torch.int32, device=q.device)[None]
    dead = None if live is None else ~live[:, None, None, None]
    if return_lse:
        if Sq != 1:
            raise ValueError(f"return_lse is a tick's (Sq == 1), got Sq={Sq}")
        o, lse = sdpa(q, k_cache, v_cache, q_positions=q_pos,
                      kv_positions=kv_pos, causal=True, window=window,
                      softcap=softcap, scale=scale, with_lse=True)
        o, lse = o.to(torch.float32), lse[..., 0].to(torch.float32)
        empty = lse <= NEG_INF / 2
        if dead is not None:
            o = o.masked_fill(dead, 0.0)
            empty = empty | dead[:, 0, :, 0]
        return o, lse.masked_fill(empty, float("-inf"))
    o = sdpa(q, k_cache, v_cache, q_positions=q_pos, kv_positions=kv_pos,
             causal=True, window=window, softcap=softcap, scale=scale)
    if dead is not None:
        o = torch.where(dead, torch.zeros_like(o), o)
    return o


def sdpa_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, positions: torch.Tensor,
                      block_table: torch.Tensor, *,
                      live: torch.Tensor | None = None,
                      window: int | None = None, softcap: float | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Paged-KV incremental attention (the paged kernel's oracle).
    q: (B, Sq, H, Dh); pools: (n_blocks, bs, K, Dh) shared by all slots;
    block_table: (B, max_blocks) int, position p of row b lives in pool block
    ``block_table[b, p // bs]`` at offset ``p % bs``. Gathers each row's
    blocks into a dense (B, max_blocks * bs, K, Dh) view and defers to
    ``sdpa_decode``; unallocated entries point at block 0, whose foreign
    contents sit at positions beyond the row's allocated prefix and are
    masked by position.
    """
    kd = k_pool[block_table.long()].flatten(1, 2)   # (B, nb * bs, K, Dh)
    vd = v_pool[block_table.long()].flatten(1, 2)
    return sdpa_decode(q, kd, vd, positions, live=live, window=window,
                       softcap=softcap, scale=scale)


def ring_order(last: torch.Tensor, w_ring: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ring rows of each slot in ascending position order, and their
    positions: (ring_idx, kv_pos), both (B, W_ring) int. ``last`` (B,) is
    each slot's last written position P. Wrapped (P >= W_ring - 1): ordered
    index j is ring row (P + 1 + j) % W_ring, holding position
    P - W_ring + 1 + j. Not wrapped: ring row j holds position j (rows past
    P are unwritten and masked by position)."""
    last = last.to(torch.int32)[:, None]
    j = torch.arange(w_ring, dtype=torch.int32, device=last.device)[None]
    wrapped = last >= w_ring - 1
    ring_idx = torch.where(wrapped, (last + 1 + j) % w_ring, j)
    kv_pos = torch.where(wrapped, last - w_ring + 1 + j, j)
    return ring_idx, kv_pos


def sdpa_decode_ring(q: torch.Tensor, k_ring: torch.Tensor,
                     v_ring: torch.Tensor, positions: torch.Tensor, *,
                     live: torch.Tensor | None = None,
                     window: int | None = None, softcap: float | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Rolling-window (ring) incremental attention (JAX's
    ``ref.sdpa_decode_ring``): the pairs plan's local layers under the paged
    layout keep only the last W_ring positions of a slot, position p at ring
    row ``p % W_ring``. q: (B, Sq, H, Dh); rings (B, W_ring, K, Dh);
    positions: (B,) first query position; the caller has written the chunk,
    so the last written position is positions + Sq - 1. The ring is gathered
    in ascending position order (``ring_order``), so the sums run in the
    dense layout's order, and attended with per-row kv positions. Requires
    W_ring >= window + Sq - 1. ``live``: non-live slots return zeros.
    """
    B, Sq = q.shape[0], q.shape[1]
    ring_idx, kv_pos = ring_order(positions + Sq - 1, k_ring.shape[1])
    rows = torch.arange(B, device=q.device)[:, None]
    kd, vd = k_ring[rows, ring_idx.long()], v_ring[rows, ring_idx.long()]
    q_pos = (positions.to(torch.int32)[:, None]
             + torch.arange(Sq, dtype=torch.int32, device=q.device)[None])
    o = sdpa(q, kd, vd, q_positions=q_pos, kv_positions=kv_pos, causal=True,
             window=window, softcap=softcap, scale=scale)
    if live is not None:
        o = torch.where(live[:, None, None, None], o, torch.zeros_like(o))
    return o


# ---------------------------------------------------------------------------
# cola_fit oracle: fused low-rank adapter fit gradient (the offloaded GL step)
# ---------------------------------------------------------------------------

def cola_fit_lowrank(x: torch.Tensor, grad_h: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, scale: float = 1.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient of the paper's quadratic fit loss (Eq. 6) at w = w_t for the
    low-rank family; by Prop 1 it equals the true loss gradient.

      dB = scale * (x A)^T grad_h        dA = scale * x^T (grad_h B^T)

    x: (..., T, d_in); grad_h: (..., T, d_out); A: (..., d_in, r);
    B: (..., r, d_out), with any leading (layer) axes shared by all four.
    f32 math; returns (dA, dB) in f32.
    """
    f32 = torch.float32
    xf, gf, Af, Bf = (t.to(f32) for t in (x, grad_h, A, B))
    xa = xf @ Af                                       # (..., T, r)
    dB = scale * (xa.transpose(-1, -2) @ gf)           # (..., r, d_out)
    dA = scale * (xf.transpose(-1, -2) @ (gf @ Bf.transpose(-1, -2)))
    return dA, dB


# ---------------------------------------------------------------------------
# multi_lora oracle: per-token adapter-indexed low-rank apply (FTaaS serving)
# ---------------------------------------------------------------------------

def multi_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               idx: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """y[t] = scale * (x[t] @ A[idx[t]]) @ B[idx[t]].

    x: (T, d_in); A: (U, d_in, r); B: (U, r, d_out); idx: (T,) int in [0, U).
    Rows with idx < 0 are padding and contribute exactly zero.
    """
    safe = idx.long().clamp(0, A.shape[0] - 1)
    a = A[safe].to(torch.float32)                  # (T, d_in, r)
    b = B[safe].to(torch.float32)                  # (T, r, d_out)
    xa = torch.einsum("td,tdr->tr", x.to(torch.float32), a)
    y = torch.einsum("tr,tro->to", xa, b)
    y = torch.where((idx >= 0)[:, None], y, torch.zeros_like(y))
    return (scale * y).to(x.dtype)


def multi_lora_q8(x: torch.Tensor, A_q: torch.Tensor, A_scale: torch.Tensor,
                  B_q: torch.Tensor, B_scale: torch.Tensor, idx: torch.Tensor,
                  scale: float = 1.0) -> torch.Tensor:
    """``multi_lora`` from an int8 bank: A_q (U, d_in, r) int8 with per-row
    scales A_scale (U, d_in, 1), likewise B. Dequantises only the T gathered
    per-token adapters, never a f32 copy of the whole bank. Rows with
    idx < 0 are padding and contribute exactly zero."""
    safe = idx.long().clamp(0, A_q.shape[0] - 1)
    a = A_q[safe].to(torch.float32) * A_scale[safe].to(torch.float32)
    b = B_q[safe].to(torch.float32) * B_scale[safe].to(torch.float32)
    xa = torch.einsum("td,tdr->tr", x.to(torch.float32), a)
    y = torch.einsum("tr,tro->to", xa, b)
    y = torch.where((idx >= 0)[:, None], y, torch.zeros_like(y))
    return (scale * y).to(x.dtype)


# ---------------------------------------------------------------------------
# ssd oracle: mamba2 state-space duality (quadratic within-chunk form)
# ---------------------------------------------------------------------------

def _segsum(log_decay: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: seg[i, j] = sum_{k=j+1..i} log_decay_k (j <= i).

    Each column j is accumulated directly from position j + 1: log_decay is
    masked to the strict lower triangle and summed along i. The naive
    ``cum_i - cum_j`` differences two global prefix sums whose magnitude
    grows with S while the segment sum stays small, so f32 cancellation
    corrupts exactly the nearby decays that matter.

    log_decay: (b, S, H) -> (b, S, S, H) with axis 1 = i, axis 2 = j.
    """
    S = log_decay.shape[1]
    strict = torch.ones(S, S, dtype=torch.bool,
                        device=log_decay.device).tril(-1)      # i > j
    terms = torch.where(strict[None, :, :, None], log_decay[:, :, None, :],
                        0.0)                                    # (b,i,j,H)
    return terms.cumsum(dim=1)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor,
        init_state: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference SSD (the O(S^2) masked form of the Mamba2 paper).

    x : (b, S, H, P)   inputs per head
    dt: (b, S, H)      positive step sizes (already softplus'ed)
    a : (H,)           negative decay rate per head (A = -exp(A_log))
    B : (b, S, N)      input projections (one group)
    C : (b, S, N)      output projections
    D : (H,)           skip connection
    init_state: (b, H, P, N) or None (then no init terms at all)
    Returns (y: (b, S, H, P) in x's dtype, final_state: (b, H, P, N) f32).
    Every sum is in f32.
    """
    S = x.shape[1]
    f32 = torch.float32
    xf, dtf, Bf, Cf = x.to(f32), dt.to(f32), B.to(f32), C.to(f32)
    log_decay = dtf * a.to(f32)[None, None, :]              # (b,S,H) < 0
    cum = log_decay.cumsum(dim=1)                           # (b,S,H)
    seg = _segsum(log_decay)                                # (b,Sq,Sk,H)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    Lmat = torch.where(causal[None, :, :, None], seg.exp(), 0.0)
    cb = torch.einsum("bin,bjn->bij", Cf, Bf)               # (b,S,S)
    w = cb[:, :, :, None] * Lmat                            # (b,Sq,Sk,H)
    y = torch.einsum("bijh,bjhp->bihp", w * dtf[:, None], xf)
    if init_state is not None:
        sf = init_state.to(f32)                             # (b,H,P,N)
        y = y + torch.einsum("bin,bhpn,bih->bihp", Cf, sf, cum.exp())
    # final state: sum_j exp(sum_{k=j+1..S} log_decay_k) dt_j B_j x_j, the
    # decay to the end being seg's last row (+ the carried state)
    decay_to_end = seg[:, -1].exp()                          # (b,S,H)
    state = torch.einsum("bjhp,bjn->bhpn",
                         xf * (decay_to_end * dtf)[..., None], Bf)
    if init_state is not None:
        state = state + init_state.to(f32) * cum[:, -1].exp()[:, :, None, None]
    y = y + xf * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence. x: (b, H, P); dt: (b, H); B, C: (b, N);
    state: (b, H, P, N) f32. Returns (y (b, H, P) in x's dtype, state)."""
    f32 = torch.float32
    xf, dtf, Bf, Cf = x.to(f32), dt.to(f32), B.to(f32), C.to(f32)
    decay = (dtf * a.to(f32)[None, :]).exp()                 # (b,H)
    state = (state * decay[:, :, None, None]
             + torch.einsum("bhp,bn->bhpn", xf * dtf[..., None], Bf))
    y = (torch.einsum("bhpn,bn->bhp", state, Cf)
         + xf * D.to(f32)[None, :, None])
    return y.to(x.dtype), state
