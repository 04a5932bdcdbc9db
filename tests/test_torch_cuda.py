"""The CUDA kernels against their plain versions on the card, over the shapes
and options the full-width run of ``chip_smoke.py`` does not reach: every
head dim the kernels take, ragged lengths, non-uniform per-row positions,
window and softcap, dead slots, padding rows, ranks up to 256; the flash
forward and the flash backward (dq; dk/dv) at the tile edges of their bf16
tensor-core kernels (lengths 1, 15, 17, 65, 257, Sq != Sk, chunk-round
positions with a dead row, G 1 / 3 / 4 at every head dim, window + softcap)
and their determinism; cola_fit over every instantiation (ranks 1-32,
odd widths, unaligned bases, T of one row, more layers than one wave, the
shared-memory accumulators with and without a column split); gradients through ``ops.sdpa`` on the card
against an f64 reference (the plain path in f64 on the CPU); kernels without
a backward refusing inputs that require grad; the split-KV decode kernel,
dense and paged, at the split edges (slots at 0, L - 1, L, L + 1, 2L - 1 and
Smax - 1 of a cache that is no multiple of the split L, a window floor
inside a later split, window 1, G 1 / 3 / 4 / 12 at every head dim (d_head
112's idle lanes a row among them), dead
slots, two launches giving the same bits) and its merge counters (grown
with B * KH, left at zero by every launch); the paged decode kernel over
block sizes and shuffled tables (and that it reads only the blocks the table
names), the f32 and int8 multi-LoRA kernels at the decode and chunk shapes,
over ranks 4 / 8 / 16 and generic ranks, odd widths, ragged row tiles and
adapter runs with padding, with a row's bits independent of the launch (T,
tile, slice, instantiation) and int8 equal to the f32 kernel on the
dequantised bank,
``quant_rows`` on the card against the CPU's, chunk rounds through the
flash forward kernel, and the adapter store's engine (R resident rows of 6
users, f32 and int8 banks) against the all-resident engine on the card.

Marked ``cuda``; skipped without a card. On the H100 (whose Python has no
JAX, which the tests' conftest imports):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances: f32 1e-5 and bf16 2^-7, each times (1 + max |plain|), as in
``chip_smoke.py``. The bf16 flash kernels run on the tensor cores: the
forward rounds P to bf16 before P V, which adds at most ~2^-9 max |v| to o;
the backward rounds P and dS to bf16 before dV += P^T dO, dK += dS^T Q and
dQ += dS K, a relative 2^-9 on each term before the sums (about half of
the tolerance with both sides' output rounding on top;
``tests/test_torch_training.py::
test_bf16_rounding_of_p_and_ds_fits_the_card_tolerance`` sizes it on the
CPU). Both stay inside the bf16 tolerance, which stays as it is. The
decode kernel merges its splits' f32 partials in another order than the
plain version's one softmax, within the f32 tolerance.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import multi_lora as ml  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    tol = TOL[dtype] * (1 + float(want.float().abs().max()))
    assert err <= tol, (err, tol)


def _rnd(gen, dev, dtype, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,K,D,window,softcap", [
    (2, 100, 4, 2, 64, None, None),     # ragged last q / kv tile
    (1, 130, 4, 1, 32, 16, 30.0),       # MQA, window + softcap
    (1, 64, 2, 2, 16, None, None),
    (1, 200, 4, 2, 128, 50, None),
    (3, 257, 9, 3, 64, None, None),     # the smollm head layout
    # tile edges of the bf16 tensor-core kernel (16-row warp slabs, 64-row
    # q and kv tiles), over G 1 / 3 / 4 and every head dim
    (1, 1, 4, 2, 64, None, None),
    (2, 15, 4, 4, 32, None, None),      # G = 1
    (1, 17, 6, 2, 16, None, None),      # G = 3
    (2, 65, 8, 2, 128, None, None),     # G = 4
    (1, 257, 3, 3, 32, 40, 20.0),       # window + softcap, G = 1
    (2, 257, 12, 3, 128, 100, 30.0),    # window + softcap, G = 4
    # zamba2's d_head 112: G 1, its tile edges, window + softcap, G 4
    (1, 1, 4, 4, 112, None, None),
    (2, 65, 8, 8, 112, None, None),
    (1, 257, 4, 4, 112, 40, 20.0),
    (2, 130, 8, 2, 112, None, None),
])
def test_flash_forward_kernel(dev, dtype, B, S, H, K, D, window, softcap):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_rnd(gen, dev, dtype, B, S, n, D) for n in (H, K, K))
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    assert fa.flash_attention.launches == before + 1
    pos = torch.arange(S, device=dev)[None]
    o2, lse2 = fa.plain(q, k, v, q_positions=pos, kv_positions=pos,
                        window=window, softcap=softcap)
    _close(o, o2, dtype)
    _close(lse, lse2, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk", [(1, 257), (15, 65), (17, 1), (65, 17),
                                   (257, 15), (100, 64)])
def test_flash_forward_kernel_ragged_lengths(dev, dtype, Sq, Sk):
    """Sq != Sk at the tile edges: the queries sit at the end of the keys
    (positions Sk - Sq + arange(Sq)) when Sq < Sk, at arange(Sq) otherwise."""
    gen = torch.Generator(device=dev).manual_seed(12)
    B, H, K, D = 2, 6, 2, 64
    q = _rnd(gen, dev, dtype, B, Sq, H, D)
    k, v = (_rnd(gen, dev, dtype, B, Sk, K, D) for _ in range(2))
    qp = (max(0, Sk - Sq) + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
    kp = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
    o, lse = fa.flash_attention(q, k, v, q_positions=qp, kv_positions=kp)
    o2, lse2 = fa.plain(q, k, v, q_positions=qp, kv_positions=kp)
    _close(o, o2, dtype)
    _close(lse, lse2, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,softcap", [(None, None), (256, 30.0)])
def test_flash_forward_kernel_chunk_positions(dev, dtype, window, softcap):
    """A chunk round's shape: per-row q positions offset into a 1,024-position
    kv range (starts 0, 300 and 924, a ragged 100 queries), and a dead row
    whose positions see no key (o 0, lse -1e30)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    B, Sq, Sk, H, K, D = 4, 100, 1024, 9, 3, 64
    q = _rnd(gen, dev, dtype, B, Sq, H, D)
    k, v = (_rnd(gen, dev, dtype, B, Sk, K, D) for _ in range(2))
    starts = torch.tensor([0, 300, 924, -500], device=dev, dtype=torch.int32)
    qp = starts[:, None] + torch.arange(Sq, device=dev, dtype=torch.int32)[None]
    kp = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
    kw = dict(q_positions=qp, kv_positions=kp, window=window, softcap=softcap)
    o, lse = fa.flash_attention(q, k, v, **kw)
    o2, lse2 = fa.plain(q, k, v, **kw)
    _close(o, o2, dtype)
    _close(lse, lse2, torch.float32)
    assert bool((o[3] == 0).all()) and bool((lse[3] == -1e30).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_forward_kernel_is_deterministic(dev, dtype):
    """Two launches on the same inputs give the same bits (no atomics, a
    fixed order of tiles and sums)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    B, S, H, K, D = 2, 512, 9, 3, 64
    q, k, v = (_rnd(gen, dev, dtype, B, S, n, D) for n in (H, K, K))
    a, b = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_forward_kernel_per_row_positions(dev, dtype):
    """Non-uniform, per-row q and kv positions (including rows that see no
    key, whose output is 0 and lse -1e30)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    B, S, H, K, D = 2, 150, 6, 2, 64
    q, k, v = (_rnd(gen, dev, dtype, B, S, n, D) for n in (H, K, K))
    qp = torch.stack([torch.arange(S) + 7,
                      torch.randperm(S, generator=torch.Generator().manual_seed(0))
                      - 5]).to(dev, torch.int32)
    kp = torch.stack([torch.arange(S), torch.arange(S) * 2]).to(dev, torch.int32)
    for window in (None, 20):
        o, lse = fa.flash_attention(q, k, v, q_positions=qp, kv_positions=kp,
                                    window=window)
        o2, lse2 = fa.plain(q, k, v, q_positions=qp, kv_positions=kp,
                            window=window)
        _close(o, o2, dtype)
        _close(lse, lse2, torch.float32)
    assert (lse == -1e30).any()


def _split_edges(pos, Smax):
    """Put slots 1-4 at the split edges L - 1, L, L + 1 and 2L - 1 (below
    Smax); slot 0 stays at 0 and the last slot at Smax - 1."""
    L = da.SPLIT
    for i, t in enumerate((L - 1, L, L + 1, 2 * L - 1)):
        pos[1 + i] = min(t, Smax - 1)


def _decode_options(live):
    """The options every decode case runs with: live slots, window +
    softcap, none, a window whose floor lies inside a later split for the
    slots past 2L, and window 1."""
    return (dict(live=live), dict(window=40, softcap=20.0), {},
            dict(window=da.SPLIT // 2 + 3, live=live), dict(window=1))


# split edges: 6 slots at 0, L - 1, L, L + 1, 2L - 1 and Smax - 1 of a cache
# of 300 positions (not a multiple of the split), G 1 / 3 / 4 / 12 at every
# head dim
EDGE_ROWS = [(6, 300, 2 * G, 2, D, True) for G in (1, 3, 4, 12)
             for D in (16, 32, 64, 112, 128)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Smax,H,K,D,edges", [
    (16, 1024, 9, 3, 64, False), (4, 128, 4, 2, 32, False),
    (3, 64, 6, 1, 128, False), (5, 100, 8, 8, 16, False),
    (8, 1024, 32, 32, 112, False),   # zamba2's serving tick (G 1, d_head 112)
    *EDGE_ROWS])
def test_decode_attention_kernel(dev, dtype, B, Smax, H, K, D, edges):
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _rnd(gen, dev, dtype, B, 1, H, D)
    kc, vc = (_rnd(gen, dev, dtype, B, Smax, K, D) for _ in range(2))
    pos = torch.randint(0, Smax, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, Smax - 1
    if edges:
        _split_edges(pos, Smax)
    live = torch.arange(B, device=dev) % 3 != 1
    for kw in _decode_options(live):
        before = da.decode_attention.launches
        o = da.decode_attention(q, kc, vc, pos, **kw)
        assert da.decode_attention.launches == before + 1
        _close(o, da.plain(q, kc, vc, pos, **kw), dtype)
        assert torch.equal(o, da.decode_attention(q, kc, vc, pos, **kw))
    o = da.decode_attention(q, kc, vc, pos, live=live)
    assert bool((o[~live] == 0).all())
    assert torch.equal(o, da.decode_attention(q, kc, vc, pos, live=live))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,U,din,dout,r", [(8192, 4, 576, 576, 8),
                                            (16, 4, 576, 192, 8),
                                            (37, 3, 64, 96, 12),
                                            (5, 2, 300, 20, 256)])
def test_multi_lora_kernel(dev, dtype, T, U, din, dout, r):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = _rnd(gen, dev, dtype, T, din)
    A = _rnd(gen, dev, torch.float32, U, din, r)
    Bm = _rnd(gen, dev, torch.float32, U, r, dout)
    idx = torch.randint(-1, U + 1, (T,), generator=gen, device=dev,
                        dtype=torch.int32)          # -1 pads, U clamps
    before = ml.multi_lora.launches
    y = ml.multi_lora(x, A, Bm, idx, 0.5)
    assert ml.multi_lora.launches == before + 1
    _close(y, ml.plain(x, A, Bm, idx, 0.5), dtype)
    assert bool((y[idx < 0] == 0).all())
    assert torch.equal(y, ml.multi_lora(x, A, Bm, idx, 0.5))


def _lora_bank(gen, dev, q8, U, din, r, dout):
    """(kernel, plain) of one bank as functions of (x, idx): f32, or int8
    codes of the same draw; for int8 also the f32 kernel on the dequantised
    bank, which must give the same bits."""
    A = _rnd(gen, dev, torch.float32, U, din, r) / r ** 0.5
    Bm = _rnd(gen, dev, torch.float32, U, r, dout) * 0.05
    if not q8:
        return (lambda x, i: ml.multi_lora(x, A, Bm, i, 0.5),
                lambda x, i: ml.plain(x, A, Bm, i, 0.5), None)
    (Aq, As), (Bq, Bs) = ml.quant_rows(A), ml.quant_rows(Bm)
    Ad, Bd = ml.dequant_rows(Aq, As), ml.dequant_rows(Bq, Bs)
    return (lambda x, i: ml.multi_lora_q8(x, Aq, As, Bq, Bs, i, 0.5),
            lambda x, i: ml.plain_q8(x, Aq, As, Bq, Bs, i, 0.5),
            lambda x, i: ml.multi_lora(x, Ad, Bd, i, 0.5))


def _runs(gen, dev, T, U, run):
    """Adapter ids in runs of ``run`` rows (a prompt, a chunk) whose
    boundaries fall inside the kernel's row tiles, every seventh run padding
    (-1), and a few padding rows and clamped ids (U) inside runs."""
    n = -(-T // run)
    ids = torch.randint(0, U, (n,), generator=gen, device=dev, dtype=torch.int32)
    ids[6::7] = -1
    idx = ids.repeat_interleave(run)[:T].clone()
    idx[3::97] = -1
    idx[5::131] = U
    return idx


def _check_lora(kernel, plain, dequant, x, idx, dtype):
    counter = ml.multi_lora_q8 if dequant is not None else ml.multi_lora
    before = counter.launches
    y = kernel(x, idx)
    assert counter.launches == before + 1
    _close(y, plain(x, idx), dtype)
    assert bool((y[idx < 0] == 0).all())
    assert torch.equal(y, kernel(x, idx))
    if dequant is not None:
        assert torch.equal(y, dequant(x, idx))
    return y


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("T,U,din,dout,r,run", [
    (16, 4, 576, 576, 4, 1), (16, 4, 576, 576, 16, 1),     # ranks 4, 16
    (16, 4, 576, 192, 8, 1),                               # the v tap
    (1, 3, 576, 576, 8, 1), (1, 2, 300, 20, 8, 1),         # one row
    (5, 2, 300, 96, 12, 2), (37, 3, 300, 20, 5, 3),        # generic ranks
    (2053, 4, 576, 576, 8, 128), (2053, 4, 576, 192, 4, 100),  # ragged tile
    (517, 3, 300, 96, 16, 29), (8192 + 37, 4, 576, 576, 8, 512),
    (300, 5, 1100, 96, 8, 7),                              # quads past 8 warps
    (64, 2, 64, 20, 33, 5)])
def test_multi_lora_kernels_ranks_widths_and_runs(dev, dtype, q8, T, U, din,
                                                 dout, r, run):
    """Both banks over ranks 4, 8, 16 and generic ranks, odd widths, T of one
    row and T no multiple of the row tile, runs of one adapter whose edges
    fall inside a tile with padding rows among them; int8 equals the f32
    kernel on the dequantised bank, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(21)
    kernel, plain, dequant = _lora_bank(gen, dev, q8, U, din, r, dout)
    x = _rnd(gen, dev, dtype, T, din)
    _check_lora(kernel, plain, dequant, x, _runs(gen, dev, T, U, run), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("T,din,dout,r", [(8192, 576, 576, 8),
                                          (2048, 576, 192, 8),
                                          (2048, 300, 20, 4),
                                          (700, 64, 96, 12)])
def test_multi_lora_rows_do_not_depend_on_the_launch(dev, dtype, q8, T, din,
                                                    dout, r):
    """A row's output is the same bits in a call of T rows (tiles of up to
    32 rows) and in a tick-sized call of 16 rows (one row a block, columns in
    slices), among other neighbours and at another offset in its tile; and in
    the generic kernel (a misaligned x) as in the rank-specialised one."""
    gen = torch.Generator(device=dev).manual_seed(22)
    U = 4
    kernel, plain, dequant = _lora_bank(gen, dev, q8, U, din, r, dout)
    x = _rnd(gen, dev, dtype, T + 1, din)
    idx = _runs(gen, dev, T, U, 128)
    big = _check_lora(kernel, plain, dequant, x[:T], idx, dtype)
    rows = torch.tensor([0, 1, 31, 32, 33, 127, 128, 200, 511, 512, 700 % T,
                         T // 2 + 3, T - 33, T - 17, T - 2, T - 1], device=dev)
    small = kernel(x[rows].contiguous(), idx[rows])
    assert torch.equal(small, big[rows])
    rev = rows.flip(0)
    assert torch.equal(kernel(x[rev].contiguous(), idx[rev]), big[rev])
    # x one element off 16-byte alignment: the generic instantiation
    off = x.view(-1)[1:1 + T * din].view(T, din)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(kernel(off, idx), kernel(off.clone(), idx))


def test_wrappers_raise_for_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 2, 48, device=dev)        # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(4, 8, device=dev, dtype=torch.float16)
    A, B = torch.zeros(1, 8, 2, device=dev), torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        ml.multi_lora(x, A, B, torch.zeros(4, dtype=torch.int32, device=dev))


# -- the training path: flash backward, cola_fit, gradients through ops ------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,K,D,window,softcap", [
    (32, 128, 9, 3, 64, None, None),    # the training path's shape
    (2, 100, 4, 2, 64, None, None),     # ragged last q / kv tile
    (1, 130, 4, 1, 32, 16, 30.0),       # MQA, window + softcap
    (1, 64, 2, 2, 16, None, None),      # G = 1
    (1, 200, 4, 2, 128, 50, None),
    # tile edges of the bf16 tensor-core kernels (16-row warp slabs, 64-row
    # q and kv tiles, dk/dv's 32-column q halves at d_head 128)
    (1, 1, 4, 2, 64, None, None),
    (2, 15, 4, 4, 32, None, None),      # G = 1
    (1, 17, 6, 2, 16, None, None),      # G = 3
    (2, 65, 8, 2, 128, None, None),     # G = 4
    (1, 257, 3, 3, 32, 40, 20.0),       # window + softcap, G = 1
    (2, 257, 12, 3, 128, 100, 30.0),    # window + softcap, G = 4
    (2, 512, 9, 3, 64, None, None),     # dk/dv walks 3 heads x 8 q tiles
    # dk/dv summed over G = 1, 3, 4 q heads at every head dim, a ragged
    # third tile
    *[(2, 150, 2 * G, 2, D, None, None) for G in (1, 3, 4)
      for D in (16, 32, 64, 112, 128, 256)],
    # zamba2's d_head 112 (G 1) at its tile edges, window + softcap
    *[(1, S, 2, 2, 112, None, None) for S in (1, 17, 65)],
    (2, 257, 4, 4, 112, 40, 20.0),
    # d_head 256's own tilings: gemma2's heads (G 2) with window + softcap,
    # G 1 / 2 / 4, the 16-row slabs (1, 16, 17 rows), dq's 32-row kv halves
    # (31, 32, 33), the 64-row tiles (64, 65, a ragged 100) and the f32
    # kernels' 32-row tiles and four threads a row (the same edges)
    (1, 300, 16, 8, 256, 100, 50.0),
    (1, 257, 2, 2, 256, 40, 20.0),      # window + softcap, G = 1
    (2, 100, 8, 2, 256, 24, 50.0),      # window + softcap, G = 4
    *[(1, S, 4, 2, 256, None, None) for S in (1, 16, 17, 31, 32, 33, 64, 65)],
    (2, 100, 2, 2, 256, None, None),    # G = 1, ragged
])
def test_flash_backward_kernels(dev, dtype, B, S, H, K, D, window, softcap):
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v, do = (_rnd(gen, dev, dtype, B, S, n, D) for n in (H, K, K, H))
    kw = dict(q_positions=torch.arange(S, dtype=torch.int32, device=dev)[None],
              kv_positions=torch.arange(S, dtype=torch.int32, device=dev)[None],
              window=window, softcap=softcap)
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v, **kw)   # bf16: the tensor-core kernel
    assert fa.flash_attention.launches == before + 1
    launches = (fa.bwd_dq.launches, fa.bwd_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert (fa.bwd_dq.launches, fa.bwd_dkv.launches) == (launches[0] + 1,
                                                         launches[1] + 1)
    for g, w in zip(got, fa.plain_bwd(q, k, v, o, lse, do, **kw)):
        assert g.dtype == dtype
        _close(g, w, dtype)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_backward_kernels_per_row_positions(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S, H, K, D = 2, 150, 6, 2, 64
    q, k, v, do = (_rnd(gen, dev, dtype, B, S, n, D) for n in (H, K, K, H))
    qp = torch.stack([torch.arange(S) + 7,
                      torch.randperm(S, generator=torch.Generator().manual_seed(0))
                      - 5]).to(dev, torch.int32)
    kp = torch.stack([torch.arange(S), torch.arange(S) * 2]).to(dev, torch.int32)
    for window in (None, 20):
        kw = dict(q_positions=qp, kv_positions=kp, window=window)
        o, lse = fa.flash_attention(q, k, v, **kw)
        for g, w in zip(fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                        fa.plain_bwd(q, k, v, o, lse, do, **kw)):
            _close(g, w, dtype)


def _bwd_close(dtype, q, k, v, do, **kw):
    """The backward kernels against the plain version; returns (dq, dk, dv)."""
    o, lse = fa.flash_attention(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, fa.plain_bwd(q, k, v, o, lse, do, **kw)):
        assert g.dtype == dtype
        _close(g, w, dtype)
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk", [(1, 257), (15, 65), (17, 1), (65, 17),
                                   (257, 15), (100, 64)])
def test_flash_backward_kernels_ragged_lengths(dev, dtype, Sq, Sk):
    """Sq != Sk at the tile edges, positions as in the forward's test."""
    gen = torch.Generator(device=dev).manual_seed(16)
    B, H, K, D = 2, 6, 2, 64
    q, do = (_rnd(gen, dev, dtype, B, Sq, H, D) for _ in range(2))
    k, v = (_rnd(gen, dev, dtype, B, Sk, K, D) for _ in range(2))
    qp = (max(0, Sk - Sq) + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
    kp = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
    _bwd_close(dtype, q, k, v, do, q_positions=qp, kv_positions=kp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,softcap", [(None, None), (256, 30.0)])
def test_flash_backward_kernels_chunk_positions(dev, dtype, window, softcap):
    """Per-row q positions offset into a 1,024-position kv range (a chunk
    round's shape, a ragged 100 queries) and a dead row, whose queries see
    no key: its dq is exactly 0 and it adds nothing to dk and dv."""
    gen = torch.Generator(device=dev).manual_seed(17)
    B, Sq, Sk, H, K, D = 4, 100, 1024, 9, 3, 64
    q, do = (_rnd(gen, dev, dtype, B, Sq, H, D) for _ in range(2))
    k, v = (_rnd(gen, dev, dtype, B, Sk, K, D) for _ in range(2))
    starts = torch.tensor([0, 300, 924, -500], device=dev, dtype=torch.int32)
    qp = starts[:, None] + torch.arange(Sq, device=dev, dtype=torch.int32)[None]
    kp = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
    dq, dk, dv = _bwd_close(dtype, q, k, v, do, q_positions=qp,
                            kv_positions=kp, window=window, softcap=softcap)
    assert bool((dq[3] == 0).all())
    assert bool((dk[3] == 0).all()) and bool((dv[3] == 0).all())


def test_gradients_flow_through_ops_sdpa_on_the_card(dev):
    """The card's f32 autograd through ops.sdpa (FlashAttention: the forward
    and the two backward kernels) against an f64 reference: ``ref.sdpa`` on
    the CPU under autograd, on the same inputs cast to f64. The CPU's own f32
    path runs too and launches no kernel; it is held to the same reference
    by ``test_torch_training.py::
    test_plain_sdpa_gradients_match_an_f64_reference``, not here, because on
    the machine with the card its f32 CPU matmuls were seen off by more than
    f32 rounding now and then."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(6)
    B, S, H, K, D = 2, 96, 6, 2, 64
    qkv = [torch.randn(B, S, n, D, generator=gen) for n in (H, K, K)]
    do = torch.randn(B, S, H, D, generator=gen)
    pos = torch.arange(S, dtype=torch.int32)[None]
    ins64 = [t.double().requires_grad_() for t in qkv]
    ref.sdpa(*ins64, q_positions=pos, kv_positions=pos).backward(do.double())
    grads = {}
    for d in ("cpu", dev):
        ins = [t.detach().to(d).requires_grad_() for t in qkv]
        before = fa.flash_attention.launches
        o = ops.sdpa(*ins, q_positions=pos.to(d), kv_positions=pos.to(d))
        assert o.grad_fn is not None
        o.backward(do.to(d))
        grads[str(d)] = [t.grad.cpu() for t in ins]
        assert (fa.flash_attention.launches > before) == (d != "cpu")
    for got, want in zip(grads[str(dev)], ins64):
        assert got.dtype == torch.float32
        _close(got, want.grad, torch.float32)


def test_server_step_recomputes_through_the_kernels(dev):
    """Mode A's server step on the card with remat "full": the forward kernel
    runs twice per layer (the recompute), each backward kernel once, and the
    result equals the CPU's."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core import gl
    from repro_torch.models import model
    from repro_torch.utils import tree_map

    cfg = registry.reduced_config("smollm-135m").replace(
        n_layers=2, d_head=64, remat="full")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=4)
    spec = gl.make_spec(cfg, cc)
    params = model.init(cfg, seed=0, device="cpu")
    ad = gl.init_adapters(cfg, cc, torch.Generator().manual_seed(1))
    tok = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator()
                        .manual_seed(2))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    out = {}
    for d in ("cpu", dev):
        counts = (fa.flash_attention.launches, fa.bwd_dq.launches,
                  fa.bwd_dkv.launches)
        loss, data, _ = gl.server_step_a(
            cfg, spec, *(tree_map(lambda a: a.to(d), t) for t in (params, ad,
                                                                  batch)))
        out[str(d)] = (loss.cpu(), {t: (x.cpu(), g.cpu())
                                    for t, (x, g) in data.items()})
        if d != "cpu":
            assert (fa.flash_attention.launches - counts[0],
                    fa.bwd_dq.launches - counts[1],
                    fa.bwd_dkv.launches - counts[2]) == (4, 2, 2)
    _close(out[str(dev)][0], out["cpu"][0], torch.float32)
    for tap, (x, g) in out["cpu"][1].items():
        _close(out[str(dev)][1][tap][0], x, torch.float32)
        _close(out[str(dev)][1][tap][1], g, torch.float32)


def _check_cola_fit(x, g, A, Bm):
    """One launch a call, within the f32 tolerance of the plain version, the
    same bits on a refit, and a 2-D call equal to its layer of the 3-D one."""
    from repro_torch.kernels import cola_fit as cf
    before = cf.cola_fit_lowrank.launches
    got = cf.cola_fit_lowrank(x, g, A, Bm, scale=0.5)
    assert cf.cola_fit_lowrank.launches == before + 1
    for a, w in zip(got, cf.plain(x, g, A, Bm, scale=0.5)):
        _close(a, w, torch.float32)
    again = cf.cola_fit_lowrank(x, g, A, Bm, scale=0.5)   # refits: same bits
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    one = cf.cola_fit_lowrank(x[0], g[0], A[0], Bm[0], scale=0.5)
    _close(one[0], got[0][0], torch.float32)


@pytest.mark.parametrize("L,T,din,dout,r", [
    (30, 8192, 576, 576, 8), (30, 8192, 576, 192, 8),   # the path's taps
    (1, 7, 16, 12, 4), (3, 300, 96, 48, 8),
    (2, 1000, 1536, 576, 8),           # 6 columns a thread, 3 stages
    (1, 64, 576, 1536, 16),            # accumulators in shared memory
    (2, 333, 99, 37, 8),               # odd widths: the scalar copies
    (2, 300, 576, 576, 4), (2, 300, 576, 576, 16),
    (2, 300, 576, 576, 6),             # a generic rank, padded to 8
    (2, 300, 576, 576, 32),            # two rank blocks of 16
    (3, 5, 64, 32, 8),                 # T below one tile
    (3, 1, 576, 192, 8),               # T of one row
    (300, 16, 64, 48, 8),              # L above one wave: chunks span layers
    (1, 40, 9000, 5000, 1),            # shared memory, columns split in two
    (2, 50, 2501, 301, 3),             # shared memory, odd width, rank 3
    (2, 300, 3584, 4096, 8),           # gemma2-9b's q tap: split in two
    (2, 300, 3584, 2048, 8),           # its v tap
    (1, 64, 8192, 8192, 8)])           # JAX's widest: split in three
def test_cola_fit_kernel(dev, L, T, din, dout, r):
    gen = torch.Generator(device=dev).manual_seed(7)
    x, g = (_rnd(gen, dev, torch.float32, L, T, d) for d in (din, dout))
    A = _rnd(gen, dev, torch.float32, L, din, r)
    Bm = _rnd(gen, dev, torch.float32, L, r, dout)
    _check_cola_fit(x, g, A, Bm)


@pytest.mark.parametrize("L,T,din,dout,r", [(2, 300, 576, 576, 8),
                                            (2, 300, 576, 1536, 16)])
def test_cola_fit_kernel_unaligned_bases(dev, L, T, din, dout, r):
    """x and g one float past a 16-byte boundary take the scalar copies."""
    gen = torch.Generator(device=dev).manual_seed(8)
    x, g = (_rnd(gen, dev, torch.float32, L * T * d + 1)[1:].view(L, T, d)
            for d in (din, dout))
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    A = _rnd(gen, dev, torch.float32, L, din, r)
    Bm = _rnd(gen, dev, torch.float32, L, r, dout)
    _check_cola_fit(x, g, A, Bm)


def test_kernels_without_backward_raise_on_inputs_that_require_grad(dev):
    q = torch.zeros(2, 1, 4, 32, device=dev, requires_grad=True)
    kc = torch.zeros(2, 16, 2, 32, device=dev)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no backward"):
        da.decode_attention(q, kc, kc, pos)
    x = torch.zeros(4, 8, device=dev, requires_grad=True)
    A, B = torch.zeros(1, 8, 2, device=dev), torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="no backward"):
        ml.multi_lora(x, A, B, torch.zeros(4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="no backward"):
        fa.flash_attention(torch.zeros(1, 8, 2, 32, device=dev,
                                       requires_grad=True),
                           torch.zeros(1, 8, 2, 32, device=dev),
                           torch.zeros(1, 8, 2, 32, device=dev))
    with torch.no_grad():   # without autograd the kernels take them
        da.decode_attention(q, kc, kc, pos)


# -- serving at scale: the paged decode kernel, the int8 multi-LoRA kernel,
# -- chunk rounds through the flash forward kernel ---------------------------

def _paged_case(gen, dev, dtype, B, H, K, D, bs, max_len, n_blocks,
                edges=False):
    """q, pools, a shuffled block table covering each row's [0, position],
    positions (including 0 and the last position of the table, and with
    ``edges`` the split edges)."""
    q = _rnd(gen, dev, dtype, B, 1, H, D)
    kp, vp = (_rnd(gen, dev, dtype, n_blocks, bs, K, D) for _ in range(2))
    nb = max_len // bs
    pos = torch.randint(0, max_len, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, max_len - 1
    if edges:
        _split_edges(pos, max_len)
    perm = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(B))
    table = torch.zeros(B, nb, dtype=torch.int32)
    it = iter(perm.tolist())
    for b, p in enumerate(pos.tolist()):
        for j in range(p // bs + 1):
            table[b, j] = next(it)
    return q, kp, vp, pos, table.to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,K,D,bs,max_len,edges", [
    (16, 9, 3, 64, 16, 1024, False),     # the serving shape
    (4, 4, 2, 32, 8, 128, False),
    (3, 6, 1, 128, 32, 256, False),      # MQA
    (5, 8, 8, 16, 8, 64, False),         # G = 1
    (4, 4, 2, 64, 24, 96, False),        # a block size that is no power of two
    # split edges (as the dense kernel's) over tables of about 300 positions
    # in blocks of 8, 16, 24 and 32 (splits straddle table entries), G 1 /
    # 3 / 4 / 12 at every head dim
    *[(6, 2 * G, 2, D, bs, bs * -(-300 // bs), True)
      for G, bs in ((1, 8), (3, 16), (4, 24), (12, 32))
      for D in (16, 32, 64, 112, 128)],
    (8, 32, 32, 112, 16, 1024, False),   # zamba2's paged tick
])
def test_decode_attention_paged_kernel(dev, dtype, B, H, K, D, bs, max_len,
                                       edges):
    gen = torch.Generator(device=dev).manual_seed(8)
    n_blocks = B * (max_len // bs) + 3
    q, kp, vp, pos, table = _paged_case(gen, dev, dtype, B, H, K, D, bs,
                                        max_len, n_blocks, edges)
    live = torch.arange(B, device=dev) % 3 != 1
    for kw in (*_decode_options(live), dict(live=live, window=7)):
        before = da.decode_attention_paged.launches
        o = da.decode_attention_paged(q, kp, vp, pos, table, **kw)
        assert da.decode_attention_paged.launches == before + 1
        _close(o, da.plain_paged(q, kp, vp, pos, table, **kw), dtype)
        assert torch.equal(o, da.decode_attention_paged(q, kp, vp, pos, table,
                                                        **kw))
    o = da.decode_attention_paged(q, kp, vp, pos, table, live=live)
    assert bool((o[~live] == 0).all())
    assert torch.equal(o, da.decode_attention_paged(q, kp, vp, pos, table,
                                                    live=live))


def test_decode_attention_paged_reads_only_the_tables_blocks(dev):
    """Poisoning every pool block that no row's table names up to its
    position (block 0 included) changes nothing: the kernel reads through
    the table, position by position, and never past a row's position."""
    gen = torch.Generator(device=dev).manual_seed(9)
    B, H, K, D, bs, max_len = 6, 4, 2, 64, 16, 256
    n_blocks = B * (max_len // bs) + 1
    q, kp, vp, pos, table = _paged_case(gen, dev, torch.float32, B, H, K, D,
                                        bs, max_len, n_blocks)
    used = {int(table[b, j]) for b, p in enumerate(pos.tolist())
            for j in range(p // bs + 1)}
    o = da.decode_attention_paged(q, kp, vp, pos, table)
    for blk in set(range(n_blocks)) - used:
        kp[blk] = float("nan")
        vp[blk] = float("nan")
    assert torch.equal(da.decode_attention_paged(q, kp, vp, pos, table), o)


def test_decode_attention_counters_grow_and_are_left_at_zero(dev):
    """Launches in a row with B * KH growing, then shrinking, on one device,
    every slot over several splits: each matches the plain version, the
    merge counters grow to the largest B * KH, and every launch, dense or
    paged, leaves them at zero."""
    gen = torch.Generator(device=dev).manual_seed(11)
    Smax = 4 * 104     # the pool's 4 blocks of 104 a slot
    da._COUNTERS.clear()
    for B, K, want in ((2, 2, 4), (16, 3, 48), (3, 1, 48)):
        q = _rnd(gen, dev, torch.float32, B, 1, 3 * K, 64)
        kc, vc = (_rnd(gen, dev, torch.float32, B, Smax, K, 64)
                  for _ in range(2))
        pos = torch.full((B,), Smax - 1, dtype=torch.int32, device=dev)
        _close(da.decode_attention(q, kc, vc, pos),
               da.plain(q, kc, vc, pos), torch.float32)
        table = torch.arange(B * 4, dtype=torch.int32, device=dev).view(B, 4)
        pool_k, pool_v = (c.reshape(B * 4, 104, K, 64) for c in (kc, vc))
        _close(da.decode_attention_paged(q, pool_k, pool_v, pos, table),
               da.plain(q, kc, vc, pos), torch.float32)
        torch.cuda.synchronize()
        cnt = da._COUNTERS[q.device]
        assert cnt.numel() == want and not bool(cnt.any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,U,din,dout,r", [(16, 4, 576, 576, 8),     # decode
                                            (16, 4, 576, 192, 8),
                                            (2048, 4, 576, 576, 8),   # chunk
                                            (37, 3, 64, 96, 12),
                                            (5, 2, 300, 20, 256)])
def test_multi_lora_q8_kernel(dev, dtype, T, U, din, dout, r):
    gen = torch.Generator(device=dev).manual_seed(10)
    x = _rnd(gen, dev, dtype, T, din)
    Aq, As = ml.quant_rows(_rnd(gen, dev, torch.float32, U, din, r))
    Bq, Bs = ml.quant_rows(_rnd(gen, dev, torch.float32, U, r, dout))
    idx = torch.randint(-1, U + 1, (T,), generator=gen, device=dev,
                        dtype=torch.int32)          # -1 pads, U clamps
    before = ml.multi_lora_q8.launches
    y = ml.multi_lora_q8(x, Aq, As, Bq, Bs, idx, 0.5)
    assert ml.multi_lora_q8.launches == before + 1
    _close(y, ml.plain_q8(x, Aq, As, Bq, Bs, idx, 0.5), dtype)
    assert bool((y[idx < 0] == 0).all())
    assert torch.equal(y, ml.multi_lora_q8(x, Aq, As, Bq, Bs, idx, 0.5))
    # the f32 kernel on the dequantised bank computes the same products
    _close(y, ml.multi_lora(x, ml.dequant_rows(Aq, As), ml.dequant_rows(Bq, Bs),
                            idx, 0.5), dtype)


def test_quant_rows_on_the_card_equals_the_cpu(dev):
    """The int8 bank the card's engine quantises is the CPU's (and JAX's) to
    the bit: codes and scales."""
    w = torch.randn(30, 4, 576, 8, generator=torch.Generator().manual_seed(12))
    for got, want in zip(ml.quant_rows(w.to(dev)), ml.quant_rows(w)):
        assert torch.equal(got.cpu(), want)


def test_paged_and_q8_wrappers_raise(dev):
    q = torch.zeros(2, 1, 4, 32, device=dev)
    pool = torch.zeros(8, 16, 2, 32, device=dev)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    table = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no backward"):
        da.decode_attention_paged(q.clone().requires_grad_(), pool, pool, pos,
                                  table)
    with pytest.raises(ValueError, match="multiple of 8"):
        da.decode_attention_paged(q, pool[:, :12].contiguous(),
                                  pool[:, :12].contiguous(), pos, table)
    with pytest.raises(ValueError, match="block_table"):
        da.decode_attention_paged(q, pool, pool, pos, table.long())
    with pytest.raises(ValueError, match="one query"):
        da.decode_attention_paged(torch.zeros(2, 3, 4, 32, device=dev), pool,
                                  pool, pos, table)
    x = torch.zeros(4, 8, device=dev)
    Aq = torch.zeros(1, 8, 2, dtype=torch.int8, device=dev)
    Bq = torch.zeros(1, 2, 8, dtype=torch.int8, device=dev)
    As, Bs = torch.ones(1, 8, 1, device=dev), torch.ones(1, 2, 1, device=dev)
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no backward"):
        ml.multi_lora_q8(x.clone().requires_grad_(), Aq, As, Bq, Bs, idx)
    with pytest.raises(ValueError, match="int8"):
        ml.multi_lora_q8(x, Aq.float(), As, Bq, Bs, idx)
    with pytest.raises(ValueError, match="scales"):
        ml.multi_lora_q8(x, Aq, As[:, :4], Bq, Bs, idx)
    with pytest.raises(ValueError, match="dtype"):
        ml.multi_lora_q8(x.half(), Aq, As, Bq, Bs, idx)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,c,max_len,starts,window", [
    (4, 16, 128, (0, 40, 100, 112), 24),
    # the serving chunk round: 16 rows of 128 queries at chunk starts
    (16, 128, 1024, (0, 128, 256, 384) * 4, None),
])
@pytest.mark.parametrize("paged", [False, True])
def test_chunk_rounds_run_the_flash_kernel(dev, paged, dtype, B, c, max_len,
                                           starts, window):
    """ops.sdpa_decode(_paged) with Sq > 1 on the card: the flash forward
    kernel (one launch, no decode kernel), equal to the plain version, dead
    rows zero."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(11)
    H, K, D, bs = 9, 3, 64, 16
    q = _rnd(gen, dev, dtype, B, c, H, D)
    pos = torch.tensor(starts, dtype=torch.int32, device=dev)
    live = torch.arange(B, device=dev) % 4 != 2
    if paged:
        _, kp, vp, _, table = _paged_case(gen, dev, dtype, B, H, K, D, bs,
                                          max_len, B * max_len // bs)
        args, fn, plain = (kp, vp, pos, table), ops.sdpa_decode_paged, \
            ref.sdpa_decode_paged
    else:
        kc, vc = (_rnd(gen, dev, dtype, B, max_len, K, D) for _ in range(2))
        args, fn, plain = (kc, vc, pos), ops.sdpa_decode, ref.sdpa_decode
    counts = (fa.flash_attention.launches, da.decode_attention.launches,
              da.decode_attention_paged.launches)
    o = fn(q, *args, live=live, window=window)
    assert (fa.flash_attention.launches - counts[0],
            da.decode_attention.launches - counts[1],
            da.decode_attention_paged.launches - counts[2]) == (1, 0, 0)
    _close(o, plain(q, *args, live=live, window=window), dtype)
    assert bool((o[~live] == 0).all())


@pytest.mark.parametrize("bank_store", ["f32", "int8"])
def test_store_engine_matches_all_resident_on_the_card(dev, bank_store):
    """6 users through R = 2 resident rows and 3 slots on the card (rows
    evicted mid-flight, admission waiting on pins): tokens equal to the
    all-resident card engine's, the multi-LoRA kernel of the bank launched,
    every pin released and the bank R rows."""
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    cfg = registry.reduced_config("smollm-135m").replace(n_layers=2,
                                                         d_head=64)
    params = model.init(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(3)
    sites = model.tap_sites(cfg)
    banks = [{tap: {"A": torch.randn(s.stacked, s.d_in, 8, generator=gen),
                    "B": 0.05 * torch.randn(s.stacked, 8, s.d_out,
                                            generator=gen)}
              for tap, s in ((t, sites[t]) for t in ("layers.attn.q",
                                                    "layers.attn.v"))}
             for _ in range(6)]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(3, 40, 12)]
    users = [(5 * i) % 6 for i in range(12)]
    kernel = ml.multi_lora_q8 if bank_store == "int8" else ml.multi_lora
    outs = {}
    for resident in (None, 2):
        eng = ServeEngine(cfg, params, slots=3, max_len=64, device=dev,
                          user_adapters=banks, bank_store=bank_store,
                          resident_slots=resident)
        reqs = [Request(rid=i, user=u, prompt=p, max_new=6)
                for i, (u, p) in enumerate(zip(users, prompts))]
        before = kernel.launches
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        assert kernel.launches > before
        assert all(r.status == "done" for r in reqs)
        outs[resident] = [r.out for r in reqs]
    assert outs[2] == outs[None]
    st = eng.stats
    assert st["store_evictions"] > 0 and st["store_pinned"] == 0
    assert all(leaf.is_cuda and leaf.is_contiguous() and leaf.shape[1] == 2
               for e in eng.store.bank.values() for leaf in e.values())


# -- d_head 256 (gemma2): the flash forward's and the decode kernel's own
# -- tiling, the ring addressing mode, and the backward's refusal -----------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,K,window,softcap", [
    (2, 100, 4, 2, None, None),     # ragged last q / kv tile
    (1, 257, 16, 8, 40, 50.0),      # gemma2's heads, window + softcap
    (2, 65, 4, 4, None, None),      # G = 1
    (1, 1, 4, 2, None, None),
])
def test_d256_flash_forward_kernel(dev, dtype, B, S, H, K, window, softcap):
    gen = torch.Generator(device=dev).manual_seed(20)
    q, k, v = (_rnd(gen, dev, dtype, B, S, n, 256) for n in (H, K, K))
    o, lse = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    pos = torch.arange(S, device=dev)[None]
    o2, lse2 = fa.plain(q, k, v, q_positions=pos, kv_positions=pos,
                        window=window, softcap=softcap)
    _close(o, o2, dtype)
    _close(lse, lse2, torch.float32)
    o3, lse3 = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    assert torch.equal(o, o3) and torch.equal(lse, lse3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_d256_decode_kernels_dense_and_paged(dev, dtype):
    """Split edges of a 300-position cache, G = 2, every decode option;
    dense and paged (blocks of 16, shuffled) against the plain versions,
    two launches the same bits."""
    gen = torch.Generator(device=dev).manual_seed(21)
    B, Smax, H, K, D = 6, 304, 16, 8, 256
    q = _rnd(gen, dev, dtype, B, 1, H, D)
    kc, vc = (_rnd(gen, dev, dtype, B, Smax, K, D) for _ in range(2))
    pos = torch.randint(0, Smax, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, Smax - 1
    _split_edges(pos, Smax)
    live = torch.arange(B, device=dev) % 3 != 1
    for kw in _decode_options(live):
        o = da.decode_attention(q, kc, vc, pos, **kw)
        _close(o, da.plain(q, kc, vc, pos, **kw), dtype)
        assert torch.equal(o, da.decode_attention(q, kc, vc, pos, **kw))
    q, kp, vp, pos, table = _paged_case(gen, dev, dtype, B, H, K, D, 16, Smax,
                                        B * Smax // 16 + 3, edges=True)
    for kw in _decode_options(live):
        o = da.decode_attention_paged(q, kp, vp, pos, table, **kw)
        _close(o, da.plain_paged(q, kp, vp, pos, table, **kw), dtype)
        assert torch.equal(o, da.decode_attention_paged(q, kp, vp, pos, table,
                                                        **kw))


def _ring_of(kc, vc, pos, w_ring):
    """Each slot's last w_ring positions of a dense cache, position t at
    ring row t % w_ring (older rows: garbage the window never reaches)."""
    B = kc.shape[0]
    rk = torch.randn((B, w_ring) + kc.shape[2:], device=kc.device).to(kc.dtype)
    rv = torch.randn_like(rk)
    for b, p in enumerate(pos.tolist()):
        t = torch.arange(max(0, p - w_ring + 1), p + 1, device=kc.device)
        rk[b, t % w_ring], rv[b, t % w_ring] = kc[b, t], vc[b, t]
    return rk, rv


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,H,K,window", [(256, 16, 8, 4096), (256, 4, 2, 100),
                                          (64, 4, 4, 40), (128, 8, 2, 130),
                                          (112, 4, 4, 40)])
def test_ring_tick_equals_dense_tick_bit_for_bit(dev, dtype, D, H, K, window):
    """The decode kernel's ring mode walks the dense tick's positions in the
    dense tick's splits (the horizon, not W_ring, sets them): equal bits,
    softcap on, dead rows zero; within tolerance of the plain ring op."""
    gen = torch.Generator(device=dev).manual_seed(22)
    B, Smax = 8, 6144 if window == 4096 else 512
    w_ring = window + 127
    q = _rnd(gen, dev, dtype, B, 1, H, D)
    kc, vc = (_rnd(gen, dev, dtype, B, Smax, K, D) for _ in range(2))
    pos = torch.randint(0, Smax, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[1], pos[-1] = 0, w_ring - 1, Smax - 1
    live = torch.arange(B, device=dev) % 4 != 3
    rk, rv = _ring_of(kc, vc, pos, w_ring)
    kw = dict(live=live, window=window, softcap=50.0)
    before = da.decode_attention_ring.launches
    ring = da.decode_attention_ring(q, rk, rv, pos, horizon=Smax, **kw)
    assert da.decode_attention_ring.launches == before + 1
    dense = da.decode_attention(q, kc, vc, pos, **kw)
    assert torch.equal(ring, dense)
    assert bool((ring[~live] == 0).all())
    _close(ring, da.plain_ring(q.cpu(), rk.cpu(), rv.cpu(), pos.cpu(),
                               live=live.cpu(), window=window,
                               softcap=50.0).to(dev), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ring_chunk_runs_the_flash_kernel(dev, dtype):
    """A chunk against rings through ``ops.sdpa_decode_ring``: the flash
    forward kernel over the position-ordered gather, against the plain ring
    op; dead rows zero."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(23)
    B, c, H, K, D, window = 4, 128, 16, 8, 256, 300
    w_ring = window + c - 1
    q = _rnd(gen, dev, dtype, B, c, H, D)
    rk, rv = (_rnd(gen, dev, dtype, B, w_ring, K, D) for _ in range(2))
    pos = torch.tensor([0, 256, 1000, 5000], dtype=torch.int32, device=dev)
    live = torch.tensor([True, True, False, True], device=dev)
    before = fa.flash_attention.launches
    o = ops.sdpa_decode_ring(q, rk, rv, pos, live=live, window=window,
                             softcap=50.0, horizon=6144)
    assert fa.flash_attention.launches == before + 1
    _close(o, ref.sdpa_decode_ring(q, rk, rv, pos, live=live, window=window,
                                   softcap=50.0), dtype)
    assert bool((o[~live] == 0).all())


def test_d256_backward_and_bad_rings_raise_on_the_card(dev):
    """The flash backward takes d_head 256 on the card (one launch of each
    kernel; zero inputs give zero gradients); a head dim no kernel takes
    (48) raises by name; so do rings the decode kernel does not take."""
    pos = dict(q_positions=torch.arange(8, device=dev)[None],
               kv_positions=torch.arange(8, device=dev)[None])
    q = torch.zeros(1, 8, 2, 256, device=dev)
    k = torch.zeros(1, 8, 1, 256, device=dev)
    o, lse = fa.flash_attention(q, k, k)
    launches = (fa.bwd_dq.launches, fa.bwd_dkv.launches)
    grads = fa.flash_attention_bwd(q, k, k, o, lse, q, **pos)
    assert (fa.bwd_dq.launches, fa.bwd_dkv.launches) == (launches[0] + 1,
                                                         launches[1] + 1)
    assert all(bool((g == 0).all()) for g in grads)
    q48 = torch.zeros(1, 8, 2, 48, device=dev)
    k48 = torch.zeros(1, 8, 1, 48, device=dev)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention_bwd(q48, k48, k48, q48, lse, q48, **pos)
    qd = torch.zeros(2, 1, 2, 256, device=dev)
    ring = torch.zeros(2, 19, 1, 256, device=dev)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="window"):
        da.decode_attention_ring(qd, ring, ring, pos, horizon=64, window=20)
    with pytest.raises(ValueError, match="horizon"):
        da.decode_attention_ring(qd, ring, ring, pos, window=16)
