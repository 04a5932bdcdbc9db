"""The port's kernel plain versions (what the CUDA kernels are held to on the
card) against the JAX Pallas kernels run in interpret mode, on the same numpy
inputs. Tolerance: f32, rtol = atol = 1e-5 (two f32 implementations of one
formula, summing in different orders)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import multi_lora as jml  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import multi_lora as ml  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("H,K,window,softcap", [
    (3, 3, None, None),      # G = 1
    (6, 2, None, None),      # G = 3
    (6, 2, 48, None),        # local window
    (6, 2, None, 20.0),      # tanh softcap
    (6, 2, 48, 20.0),
])
def test_flash_forward_matches_pallas(H, K, window, softcap):
    rng = np.random.default_rng(0)
    B, S, D = 2, 128, 64
    q, k, v = (_normal(rng, B, S, n, D) for n in (H, K, K))
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=D ** -0.5, causal=True, window=window,
                          softcap=softcap, q_offset=0, interpret=True)
    launches = fa.flash_attention.launches
    o_t, lse_t = fa.flash_attention(_t(q), _t(k), _t(v), window=window,
                                    softcap=softcap)
    assert fa.flash_attention.launches == launches   # CPU: plain version
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


def test_flash_forward_takes_non_uniform_positions():
    """The port's attention is exact for per-row positions (the TPU kernel
    assumed q starts at 0 and kv at 0); held to the JAX oracle."""
    rng = np.random.default_rng(1)
    B, S, H, K, D = 2, 40, 6, 2, 64
    q, k, v = (_normal(rng, B, S, n, D) for n in (H, K, K))
    qp = np.stack([np.arange(S) + 7, rng.permutation(S)]).astype(np.int32)
    kp = np.stack([np.arange(S), np.arange(S) * 2]).astype(np.int32)
    want = jref.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp))
    got = ops.sdpa(_t(q), _t(k), _t(v), q_positions=_t(qp), kv_positions=_t(kp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("positions,live", [
    ([5, 77, 0, 127], [True, False, True, True]),   # live mask + position 0
    ([127, 127, 126, 0], None),                     # full cache
])
@pytest.mark.parametrize("window,softcap", [(None, None), (32, 20.0)])
def test_decode_attention_matches_pallas(positions, live, window, softcap):
    rng = np.random.default_rng(2)
    B, Smax, H, K, D = 4, 128, 6, 2, 64
    q = _normal(rng, B, 1, H, D)
    kc, vc = _normal(rng, B, Smax, K, D), _normal(rng, B, Smax, K, D)
    pos = np.asarray(positions, np.int32)
    lv = None if live is None else np.asarray(live)
    o_j = jda.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(pos),
                               live=None if lv is None else jnp.asarray(lv),
                               window=window, softcap=softcap, interpret=True)
    o_t = da.decode_attention(_t(q), _t(kc), _t(vc), _t(pos),
                              live=None if lv is None else _t(lv),
                              window=window, softcap=softcap)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    if lv is not None:
        assert np.all(o_t.numpy()[~lv] == 0.0)


@pytest.mark.parametrize("T,U", [(64, 3), (8, 20)])   # U > T: the decode case
def test_multi_lora_matches_pallas(T, U):
    rng = np.random.default_rng(3)
    din, r, dout = 96, 8, 48
    x = _normal(rng, T, din)
    A, B = _normal(rng, U, din, r), _normal(rng, U, r, dout)
    idx = rng.integers(0, U, T).astype(np.int32)
    idx[::5] = -1                                     # padding rows
    y_j = jml.multi_lora(jnp.asarray(x), jnp.asarray(A), jnp.asarray(B),
                         jnp.asarray(idx), scale=0.5, interpret=True)
    y_t = ml.multi_lora(_t(x), _t(A), _t(B), _t(idx), scale=0.5)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-4)
    assert np.all(y_t.numpy()[idx < 0] == 0.0)


def test_multi_lora_rows_depend_only_on_their_adapter():
    """Each output row is a function of its own x row and its own adapter:
    serving from a bank that holds only the used adapters gives equal bits."""
    rng = np.random.default_rng(4)
    T, U, din, r, dout = 16, 10, 32, 4, 24
    x = _t(_normal(rng, T, din))
    A, B = _t(_normal(rng, U, din, r)), _t(_normal(rng, U, r, dout))
    idx = _t(rng.choice([2, 7], T).astype(np.int32))
    full = ml.multi_lora(x, A, B, idx)
    sub = torch.tensor([2, 7])
    remap = torch.where(idx == 2, 0, 1).to(torch.int32)
    part = ml.multi_lora(x, A[sub], B[sub], remap)
    assert torch.equal(full, part)


def test_wrappers_raise_for_tensors_they_cannot_launch():
    """Only CPU tensors take the plain version: any other tensor goes to the
    kernel's checks, which raise rather than fall back (meta tensors stand in
    for what the kernel does not take)."""
    q = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


# -- the decode kernel's split walk, written out in plain torch f32 ----------

def _split_walk(q, k, v, pos, live, window, softcap, table=None):
    """The CUDA decode kernel's arithmetic: each (slot, kv head)'s positions
    [lo, hi] cut into splits of ``da.SPLIT``; a block whose split holds no
    position of [lo, hi] exits; each live split's partial (m, l, acc) in f32;
    the partials merged in split order. ``table`` given: k and v are pools
    (n_blocks, bs, K, Dh) read through it, else dense caches (B, Smax, K, Dh).
    """
    L = da.SPLIT
    B, _, H, D = q.shape
    K = k.shape[2]
    G = H // K
    Smax = table.shape[1] * k.shape[1] if table is not None else k.shape[1]
    n_split = -(-Smax // L)
    o = torch.zeros(B, 1, H, D)
    for b in range(B):
        p = int(pos[b])
        hi = min(p, Smax - 1)
        lo = max(0, p - window + 1) if window else 0
        if (live is not None and not live[b]) or hi < lo:
            continue
        s_lo, s_hi = lo // L, hi // L
        n_live = s_hi - s_lo + 1
        t_all = torch.arange(lo, hi + 1)
        if table is None:
            rows_k, rows_v = k[b, t_all], v[b, t_all]
        else:
            bs = k.shape[1]
            blk = table[b, t_all // bs].long()
            rows_k, rows_v = k[blk, t_all % bs], v[blk, t_all % bs]
        for kh in range(K):
            qg = q[b, 0, kh * G:(kh + 1) * G].float()            # (G, D)
            parts = []
            for s in range(n_split):
                if s < s_lo or s > s_hi:      # the block exits at once
                    continue
                sel = (t_all >= max(lo, s * L)) & (t_all <= min(hi, s * L + L - 1))
                assert sel.any()              # every live split holds a position
                kk, vv = rows_k[sel, kh].float(), rows_v[sel, kh].float()
                sc = (qg @ kk.T) * D ** -0.5
                if softcap:
                    sc = torch.tanh(sc / softcap) * softcap
                m = sc.max(-1).values
                e = torch.exp(sc - m[:, None])
                parts.append((m, e.sum(-1), e @ vv))
            assert len(parts) == n_live       # the merging block sees them all
            M = torch.stack([m for m, _, _ in parts]).max(0).values
            acc, l_sum = torch.zeros(G, D), torch.zeros(G)
            for m, l_s, a_s in parts:         # split order
                w = torch.exp(m - M)
                acc = acc + w[:, None] * a_s
                l_sum = l_sum + w * l_s
            o[b, 0, kh * G:(kh + 1) * G] = acc / l_sum[:, None]
    return o


def _edge_positions(Smax):
    """Slots at the split edges L - 1, L, L + 1, 2L - 1 and at Smax - 1, and
    a dead slot (the last)."""
    L = da.SPLIT
    pos = np.asarray([L - 1, L, L + 1, 2 * L - 1, Smax - 1, 5], np.int32)
    live = np.ones(len(pos), bool)
    live[-1] = False
    return pos, live


def _split_window(Smax):
    """A window whose floor for the slot at Smax - 1 is the split edge L."""
    return Smax - 1 - da.SPLIT + 1


@pytest.mark.parametrize("G", [1, 3, 4, 12])
@pytest.mark.parametrize("variant", ["full", "window on a split edge",
                                     "window 1"])
def test_decode_split_walk_matches_pallas(G, variant):
    """The split walk (the CUDA kernel's index arithmetic and merge) against
    the TPU kernel in interpret mode and the plain version, at the split
    edges, with Smax not a multiple of the split."""
    rng = np.random.default_rng(20 + G)
    L = da.SPLIT
    Smax, K, D = 2 * L + L // 2, 2, 64
    H = G * K
    pos, lv = _edge_positions(Smax)
    B = len(pos)
    window, softcap = {"full": (None, None),
                       "window on a split edge": (_split_window(Smax), 20.0),
                       "window 1": (1, None)}[variant]
    q = _normal(rng, B, 1, H, D)
    kc, vc = _normal(rng, B, Smax, K, D), _normal(rng, B, Smax, K, D)
    o_j = jda.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(pos), live=jnp.asarray(lv),
                               window=window, softcap=softcap, interpret=True)
    o_w = _split_walk(_t(q), _t(kc), _t(vc), pos, lv, window, softcap)
    o_p = da.decode_attention(_t(q), _t(kc), _t(vc), _t(pos), live=_t(lv),
                              window=window, softcap=softcap)
    np.testing.assert_allclose(o_w.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(o_w.numpy(), o_p.numpy(), **TOL)
    assert np.all(o_w.numpy()[~lv] == 0.0)


@pytest.mark.parametrize("G", [1, 3, 4, 12])
@pytest.mark.parametrize("window", [None, "split edge"])
def test_decode_split_walk_paged_matches_pallas(G, window):
    """The same walk through a block table of blocks of 24: splits straddle
    table entries; held to the paged TPU kernel in interpret mode and the
    plain version. Unallocated entries point at block 0."""
    rng = np.random.default_rng(40 + G)
    L = da.SPLIT
    bs, K, D = 24, 2, 64
    nb = -(-(2 * L + L // 2) // bs)
    Smax, H = bs * nb, G * K
    pos, lv = _edge_positions(Smax)
    B = len(pos)
    window = _split_window(Smax) if window else None
    n_blocks = B * nb + 1
    q = _normal(rng, B, 1, H, D)
    kp, vp = _normal(rng, n_blocks, bs, K, D), _normal(rng, n_blocks, bs, K, D)
    perm = iter(rng.permutation(np.arange(1, n_blocks)).tolist())
    table = np.zeros((B, nb), np.int32)
    for b, p in enumerate(pos.tolist()):
        for j in range(p // bs + 1):
            table[b, j] = next(perm)
    o_j = jda.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pos),
        jnp.asarray(table), live=jnp.asarray(lv), window=window, interpret=True)
    o_w = _split_walk(_t(q), _t(kp), _t(vp), pos, lv, window, None,
                      table=_t(table))
    o_p = da.decode_attention_paged(_t(q), _t(kp), _t(vp), _t(pos), _t(table),
                                    live=_t(lv), window=window)
    np.testing.assert_allclose(o_w.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(o_w.numpy(), o_p.numpy(), **TOL)
    assert np.all(o_w.numpy()[~lv] == 0.0)


# -- the multi-LoRA kernels' summation order, written out in plain torch f32 --

def _fma(a, b, c):
    """fmaf in torch: the f32 product is exact in f64, and one rounding to
    f32 follows (after the f64 sum's own, which a tolerance test tolerates)."""
    return (a.double() * b.double() + c.double()).float()


def _lora_order(x, A, B, idx, scale):
    """The CUDA kernels' arithmetic (``csrc/multi_lora.cu``): a row's shrink
    over ``shrink_warps(d_in)`` warps, the d axis in quads of 4, thread t
    owning quads t, t + 32 warps, ... and chaining fmaf over its d in
    ascending order; each warp's lanes combined by the butterfly with masks
    16, 8, 4, 2, 1; the warps' sums added in warp order; the expand chaining
    fmaf over j in ascending order, then the scale. Padding rows (idx < 0)
    are exact zeros, idx >= U clamps."""
    T, d_in = x.shape
    U, _, r = A.shape
    nw = ml.shrink_warps(d_in)
    ns, nq = 32 * nw, -(-d_in // 4)
    safe = idx.long().clamp(0, U - 1)
    a, b = A[safe].float(), B[safe].float()             # (T, d_in, r), (T, r, d_out)
    xf = x.float()
    th = torch.arange(ns)
    part = torch.zeros(T, ns, r)
    for k in range(-(-nq // ns)):                       # a thread's quads, ascending
        for e in range(4):
            d = 4 * (th + ns * k) + e
            ok = d < d_in
            dd = d.clamp(max=d_in - 1)
            step = _fma(xf[:, dd, None], a[:, dd], part)
            part = torch.where(ok[None, :, None], step, part)
    lanes = part.view(T, nw, 32, r)
    lane = torch.arange(32)
    for m in (16, 8, 4, 2, 1):                           # the warp's butterfly
        lanes = lanes + lanes[:, :, lane ^ m]
    xa = lanes[:, 0, 0]
    for w in range(1, nw):                               # the warps in order
        xa = xa + lanes[:, w, 0]
    acc = torch.zeros(T, B.shape[-1])
    for j in range(r):                                   # the expand, j ascending
        acc = _fma(xa[:, j:j + 1], b[:, j], acc)
    y = torch.where((idx >= 0)[:, None], scale * acc, torch.zeros_like(acc))
    return y.to(x.dtype)


@pytest.mark.parametrize("T,U,din,dout,r", [
    (8, 3, 96, 48, 8),        # one warp a row
    (6, 2, 576, 192, 8),      # the v tap: 5 warps, the last half idle
    (5, 20, 576, 576, 16),    # U > T, rank 16
    (7, 2, 300, 20, 5),       # a generic rank, d_in in quads
    (4, 2, 1100, 24, 4)])     # d_in past 8 warps' quads: the quads wrap
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_multi_lora_order_matches_ref_and_pallas(T, U, din, dout, r, q8):
    """The kernels' summation order (``_lora_order``) against the plain
    version and the TPU kernel in interpret mode, with padding rows, at the
    tolerance of ``test_multi_lora_matches_pallas``; int8 through the same
    order on the dequantised bank (``a = code * scale`` rounded once, as the
    kernel does)."""
    rng = np.random.default_rng(30 + T)
    x = _normal(rng, T, din)
    A, B = _normal(rng, U, din, r), _normal(rng, U, r, dout)
    idx = rng.integers(0, U, T).astype(np.int32)
    idx[1::3] = -1
    if q8:
        (Aq, As), (Bq, Bs) = jml.quant_rows(jnp.asarray(A)), jml.quant_rows(
            jnp.asarray(B))
        y_j = jml.multi_lora_q8(jnp.asarray(x), Aq, As, Bq, Bs,
                                jnp.asarray(idx), scale=0.5, interpret=True)
        bank = [_t(a) for a in (Aq, As, Bq, Bs)]
        y_p = ml.multi_lora_q8(_t(x), *bank, _t(idx), scale=0.5)
        At, Bt = ml.dequant_rows(*bank[:2]), ml.dequant_rows(*bank[2:])
    else:
        y_j = jml.multi_lora(jnp.asarray(x), jnp.asarray(A), jnp.asarray(B),
                             jnp.asarray(idx), scale=0.5, interpret=True)
        At, Bt = _t(A), _t(B)
        y_p = ml.multi_lora(_t(x), At, Bt, _t(idx), scale=0.5)
    y_o = _lora_order(_t(x), At, Bt, _t(idx), 0.5)
    np.testing.assert_allclose(y_o.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(y_o.numpy(), y_p.numpy(), rtol=1e-5, atol=1e-4)
    assert np.all(y_o.numpy()[idx < 0] == 0.0)


@pytest.mark.parametrize("T", [1, 5, 16, 37, 255, 256, 511, 512, 2048, 2053,
                               8192, 8229, 20000])
@pytest.mark.parametrize("din,dout,r,x_bytes", [
    (576, 576, 8, 2), (576, 192, 8, 2), (576, 576, 8, 4), (300, 20, 5, 4),
    (64, 96, 256, 2), (1100, 9000, 16, 4), (40000, 8, 256, 4)])
def test_multi_lora_plan_covers_rows_and_columns_once(T, din, dout, r, x_bytes):
    """The plan's row tiles cover [0, T) exactly once and its column slices
    [0, d_out) exactly once, within the kernels' limits (tiles of 1-32 rows,
    a block's shared memory, grid.y); a tick (T 16) at the path's widths
    spreads over 80 blocks of up to 128 columns, a prefill (T 8192) takes
    tiles of 32 rows and every column, a chunk round (T 2048) tiles of 8."""
    tile, sq = ml.plan(T, din, dout, r, x_bytes)
    assert 1 <= tile <= 32 and sq >= 1
    assert ml.smem_bytes(tile, din, r, x_bytes) <= ml.MAX_SMEM
    rows = torch.zeros(T, dtype=torch.int32)
    for b in range(-(-T // tile)):
        rows[b * tile:min(T, (b + 1) * tile)] += 1
    assert bool((rows == 1).all())
    nq = -(-dout // 4)
    slices = -(-nq // sq)
    assert slices <= 65535 and (slices - 1) * sq < nq
    cols = torch.zeros(dout, dtype=torch.int32)
    for s in range(slices):
        cols[4 * s * sq:min(dout, 4 * (s + 1) * sq)] += 1
    assert bool((cols == 1).all())
    if (din, dout, r, x_bytes) == (576, 576, 8, 2):
        want = {16: (1, 29), 8192: (32, 144), 2048: (8, 144)}
        assert want.get(T, (tile, sq)) == (tile, sq)
        if T == 16:
            assert T * slices == 80


# ---------------------------------------------------------------------------
# d_head 256 (gemma2): 2 kv heads, G = 2, short sequences, window and softcap
# ---------------------------------------------------------------------------

D256_MASKS = [(None, None), (24, 50.0)]


@pytest.mark.parametrize("window,softcap", D256_MASKS)
def test_d256_flash_forward_matches_pallas(window, softcap):
    rng = np.random.default_rng(10)
    B, S, H, K, D = 2, 64, 4, 2, 256
    q, k, v = (_normal(rng, B, S, n, D) for n in (H, K, K))
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=D ** -0.5, causal=True, window=window,
                          softcap=softcap, q_offset=0, interpret=True)
    o_t, lse_t = fa.flash_attention(_t(q), _t(k), _t(v), window=window,
                                    softcap=softcap)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)
    got = ops.sdpa(_t(q), _t(k), _t(v), q_positions=_t(np.arange(S)[None]),
                   kv_positions=_t(np.arange(S)[None]), window=window,
                   softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(o_j), **TOL)


@pytest.mark.parametrize("window,softcap", D256_MASKS)
def test_d256_decode_dense_and_paged_match_pallas(window, softcap):
    """Dense and paged (a shuffled table of 8-position blocks) against the
    Pallas kernels in interpret mode, one dead row."""
    rng = np.random.default_rng(11)
    B, Smax, H, K, D, bs = 3, 64, 4, 2, 256, 8
    q = _normal(rng, B, 1, H, D)
    kc, vc = _normal(rng, B, Smax, K, D), _normal(rng, B, Smax, K, D)
    pos = np.array([5, 63, 40], np.int32)
    lv = np.array([True, True, False])
    kw = dict(window=window, softcap=softcap)
    o_j = jda.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, pos)),
                               live=jnp.asarray(lv), interpret=True, **kw)
    o_t = da.decode_attention(*(_t(a) for a in (q, kc, vc, pos)),
                              live=_t(lv), **kw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    nb = Smax // bs
    table = rng.permutation(B * nb).reshape(B, nb).astype(np.int32)
    kp = np.zeros((B * nb, bs, K, D), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):            # the dense rows, scattered through the table
        kp[table[b]] = kc[b].reshape(nb, bs, K, D)
        vp[table[b]] = vc[b].reshape(nb, bs, K, D)
    p_j = jda.decode_attention_paged(
        *(jnp.asarray(a) for a in (q, kp, vp, pos, table)),
        live=jnp.asarray(lv), interpret=True, **kw)
    p_t = da.decode_attention_paged(*(_t(a) for a in (q, kp, vp, pos, table)),
                                    live=_t(lv), **kw)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **TOL)
    np.testing.assert_allclose(p_t.numpy(), o_t.numpy(), **TOL)
    assert np.all(o_t.numpy()[2] == 0) and np.all(p_t.numpy()[2] == 0)


@pytest.mark.parametrize("sq", [1, 4])
def test_d256_ring_matches_jax(sq):
    """The ring (W_ring = 24 + 4 - 1 = 27) through ``ops.sdpa_decode_ring``
    against JAX's ring op, rows wrapped and not; window 24, softcap 50."""
    rng = np.random.default_rng(12 + sq)
    B, W, H, K, D = 3, 27, 4, 2, 256
    q = _normal(rng, B, sq, H, D)
    k, v = _normal(rng, B, W, K, D), _normal(rng, B, W, K, D)
    pos = np.array([4, 50, 27 - sq], np.int32)
    lv = np.array([True, True, False])
    kw = dict(window=24, softcap=50.0)
    want = jref.sdpa_decode_ring(*(jnp.asarray(a) for a in (q, k, v, pos)),
                                 live=jnp.asarray(lv), **kw)
    got = ops.sdpa_decode_ring(*(_t(a) for a in (q, k, v, pos)), live=_t(lv),
                               horizon=64, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[2] == 0)


def test_d256_plain_ring_tick_equals_dense_tick():
    """The plain ring tick against the plain dense tick with the same window
    over the same positions (the ring holds the dense cache's last W_ring
    positions): within 1e-5 (f32; the card holds the two kernels to equal
    bits)."""
    rng = np.random.default_rng(14)
    B, Smax, W, H, K, D = 3, 64, 27, 4, 2, 256
    q = _t(_normal(rng, B, 1, H, D))
    kc, vc = _t(_normal(rng, B, Smax, K, D)), _t(_normal(rng, B, Smax, K, D))
    pos = torch.tensor([3, 40, 63], dtype=torch.int32)
    ring_k = torch.zeros(B, W, K, D)
    ring_v = torch.zeros(B, W, K, D)
    for b, p in enumerate(pos.tolist()):
        for t in range(max(0, p - W + 1), p + 1):
            ring_k[b, t % W], ring_v[b, t % W] = kc[b, t], vc[b, t]
    dense = da.decode_attention(q, kc, vc, pos, window=24, softcap=50.0)
    ring = da.decode_attention_ring(q, ring_k, ring_v, pos, horizon=Smax,
                                    window=24, softcap=50.0)
    np.testing.assert_allclose(ring.numpy(), dense.numpy(), **TOL)
