"""The port's training path against the JAX package on the CPU: the flash
backward (plain version and the autograd Function) and the cola_fit plain
version against the Pallas kernels in interpret mode, the cola_fit kernel's
launch plan (instantiation, chunks, reduction order) and its summation order
written out in torch, then the GL steps, the
optimizers and the data on the reduced f32 smollm-135m (2 layers), with
JAX's weights and adapters carried across by ``repro_torch.convert`` and the
same numpy batches fed to both (``ColaSession`` is in test_torch_session.py).

Tolerances (f32): kernels rtol = atol = 1e-5 (one formula, sums in another
order); model-level losses and gradients rtol = 1e-4 with an atol of 1e-4 of
the largest entry (XLA's CPU matmuls and PyTorch's through 2 layers and the
head). The port-internal
copies of ``tests/test_gl_equivalence.py`` keep that file's tolerances.
"""
import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig, TrainConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.core import merge as jmerge  # noqa: E402
from repro.core import offload as joffload  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels import cola_fit as jcf  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core import offload as toffload  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.kernels import cola_fit as cf  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as toptim  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

KTOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tnp(tree):
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _close(got, want, rtol=1e-4, what=""):
    """Trees of arrays agree within rtol, with atol = rtol * max |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], rtol, f"{what}.{k}")
        return
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1e-6, float(np.abs(want).max())),
                               err_msg=what)


# ---------------------------------------------------------------------------
# kernels: flash backward, cola_fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap", [(None, None), (48, None),
                                            (None, 20.0)])
def test_flash_backward_matches_pallas_vjp(window, softcap):
    """ref.sdpa_bwd and the autograd Function (plain versions on the CPU)
    against jax.vjp of the Pallas flash kernel in interpret mode."""
    rng = np.random.default_rng(0)
    B, S, H, K, D = 1, 128, 4, 2, 64
    q, k, v, do = (rng.standard_normal((B, S, n, D)).astype(np.float32)
                   for n in (H, K, K, H))
    o_j, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, window=window, softcap=softcap, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    pos = torch.arange(S, dtype=torch.int32)[None]
    o, lse = fa.flash_attention(_t(q), _t(k), _t(v), window=window,
                                softcap=softcap)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **KTOL)
    got = ref.sdpa_bwd(_t(q), _t(k), _t(v), o, lse, _t(do), q_positions=pos,
                       kv_positions=pos, window=window, softcap=softcap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KTOL)

    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = ops.sdpa(qt, kt, vt, q_positions=pos, kv_positions=pos,
                   window=window, softcap=softcap)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    out.backward(_t(do))
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KTOL)


def test_flash_backward_takes_non_uniform_positions():
    """Per-row positions (the TPU kernel assumed uniform ones): the port's
    backward against jax.vjp of the JAX oracle ``ref.sdpa``."""
    rng = np.random.default_rng(1)
    B, S, H, K, D = 2, 40, 6, 2, 64
    q, k, v, do = (rng.standard_normal((B, S, n, D)).astype(np.float32)
                   for n in (H, K, K, H))
    qp = np.stack([np.arange(S) + 7, rng.permutation(S)]).astype(np.int32)
    kp = np.stack([np.arange(S), np.arange(S) * 2]).astype(np.int32)
    kw = dict(causal=True, window=24, softcap=None)
    _, vjp = jax.vjp(lambda a, b, c: jref.sdpa(
        a, b, c, q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp),
        **kw), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    ops.sdpa(qt, kt, vt, q_positions=_t(qp), kv_positions=_t(kp),
             **kw).backward(_t(do))
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KTOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (700, 20.0)])
def test_plain_backward_by_query_blocks_equals_the_whole(window, softcap):
    """``ref.sdpa_bwd`` at S 2048 runs four query blocks of 512 (dk and dv
    summed over the blocks in f32): dq bit for bit ``_sdpa_bwd_dense``'s
    over the whole of q, dk and dv within f32 rounding of its largest
    entry, non-uniform rows."""
    rng = np.random.default_rng(3)
    B, S, H, K, D = 2, 2048, 4, 2, 16
    q, k, v, do = (_t(rng.standard_normal((B, S, n, D)).astype(np.float32))
                   for n in (H, K, K, H))
    pos = torch.stack([torch.arange(S), torch.arange(S) + 5]).to(torch.int32)
    kw = dict(q_positions=pos, kv_positions=pos, window=window,
              softcap=softcap)
    o, lse = ref.sdpa(q, k, v, with_lse=True, **kw)
    blocked = ref.sdpa_bwd(q, k, v, o, lse, do, **kw)
    whole = [g.to(q.dtype) for g in ref._sdpa_bwd_dense(
        q, k, v, o, lse, do, causal=True, scale=None, **kw)]
    assert torch.equal(blocked[0], whole[0])
    for a, b in zip(blocked[1:], whole[1:]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_plain_sdpa_gradients_match_an_f64_reference():
    """The CPU's f32 gradients through ops.sdpa (the plain forward and
    backward behind the autograd Function) against ``ref.sdpa`` in f64 under
    autograd, at the f32 tolerance the card's gradients are held to,
    1e-5 (1 + max |reference|), on the inputs of
    ``test_torch_cuda.py::test_gradients_flow_through_ops_sdpa_on_the_card``."""
    gen = torch.Generator().manual_seed(6)
    B, S, H, K, D = 2, 96, 6, 2, 64
    qkv = [torch.randn(B, S, n, D, generator=gen) for n in (H, K, K)]
    do = torch.randn(B, S, H, D, generator=gen)
    pos = torch.arange(S, dtype=torch.int32)[None]
    ins64 = [t.double().requires_grad_() for t in qkv]
    ref.sdpa(*ins64, q_positions=pos, kv_positions=pos).backward(do.double())
    ins = [t.clone().requires_grad_() for t in qkv]
    ops.sdpa(*ins, q_positions=pos, kv_positions=pos).backward(do)
    for got, want in zip(ins, ins64):
        assert got.grad.dtype == torch.float32
        assert want.grad.dtype == torch.float64
        err = float((got.grad.double() - want.grad).abs().max())
        assert err <= 1e-5 * (1 + float(want.grad.abs().max())), err


def _sdpa_bwd_rounding_p_ds(q, k, v, o, lse, do, *, q_positions, kv_positions,
                            window, softcap, round_to=None):
    """``ref.sdpa_bwd``'s math in f32 (causal, default scale), with P and dS
    cast to ``round_to`` (and back) before the products they feed, as the
    bf16 tensor-core backward kernels round them."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G, scale = H // K, D ** -0.5
    rnd = (lambda t: t) if round_to is None else (
        lambda t: t.to(round_to).float())
    qp = q_positions[:, None, None, :, None]
    kp = kv_positions[:, None, None, None, :]
    mask = kp <= qp
    if window:
        mask = mask & (kp > qp - window)
    qg, dog = q.reshape(B, Sq, K, G, D), do.reshape(B, Sq, K, G, D)
    delta = (dog * o.reshape(B, Sq, K, G, D)).sum(-1).permute(0, 2, 3, 1)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    dcap = 1.0
    if softcap:
        t = torch.tanh(s / softcap)
        s, dcap = t * softcap, 1.0 - t * t
    p = torch.where(mask, torch.exp(s - lse.reshape(B, K, G, Sq)[..., None]),
                    torch.zeros_like(s))
    dv = torch.einsum("bkgqs,bqkgd->bskd", rnd(p), dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v)
    ds = rnd(p * (dp - delta[..., None]) * dcap)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k).reshape(B, Sq, H, D) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return dq, dk, dv


@pytest.mark.parametrize("window,softcap", [(None, None), (48, 20.0)])
def test_bf16_rounding_of_p_and_ds_fits_the_card_tolerance(window, softcap):
    """The bf16 backward kernels round P and dS to bf16 before their
    products. On bf16-valued inputs with a ragged tile (S 100), that
    rounding moves each gradient by less than the bf16 tolerance the card's
    checks use, 2^-7 (1 + max |plain|), with room left for both sides'
    rounding of the output to bf16 (2^-9 max |plain| each)."""
    rng = np.random.default_rng(7)
    B, S, H, K, D = 2, 100, 6, 2, 64
    q, k, v, do = (_t(rng.standard_normal((B, S, n, D)).astype(np.float32)
                      ).to(torch.bfloat16).float() for n in (H, K, K, H))
    pos = torch.arange(S, dtype=torch.int32)[None]
    kw = dict(q_positions=pos, kv_positions=pos, window=window,
              softcap=softcap)
    o, lse = fa.flash_attention(q, k, v, **kw)
    o = o.to(torch.bfloat16).float()     # the bf16 forward's o feeds delta
    exact = _sdpa_bwd_rounding_p_ds(q, k, v, o, lse, do, **kw)
    for a, b in zip(exact, ref.sdpa_bwd(q, k, v, o, lse, do, **kw)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **KTOL)
    rounded = _sdpa_bwd_rounding_p_ds(q, k, v, o, lse, do, **kw,
                                      round_to=torch.bfloat16)
    for name, r, e in zip(("dq", "dk", "dv"), rounded, exact):
        top = float(e.abs().max())
        gap = float((r - e).abs().max())
        assert 0.0 < gap, name                       # the rounding is seen
        assert gap + 2 * 2.0 ** -9 * top <= 2.0 ** -7 * (1 + top), (
            name, gap, top)


@pytest.mark.parametrize("L", [0, 3])
def test_cola_fit_matches_pallas(L):
    """Port cola_fit_lowrank (plain version on the CPU) against the Pallas
    kernel in interpret mode; L = 0 is one (T, d) fit, L = 3 a stack of
    layers (the JAX kernel vmapped)."""
    rng = np.random.default_rng(2)
    lead = (L,) if L else ()
    T, d_in, d_out, r = 256, 96, 48, 8
    x = rng.standard_normal(lead + (T, d_in)).astype(np.float32)
    g = rng.standard_normal(lead + (T, d_out)).astype(np.float32)
    A = rng.standard_normal(lead + (d_in, r)).astype(np.float32)
    B = rng.standard_normal(lead + (r, d_out)).astype(np.float32)

    def jfit(*a):
        return jcf.cola_fit_lowrank(*a, scale=0.5, interpret=True)

    want = (jax.vmap(jfit) if L else jfit)(*map(jnp.asarray, (x, g, A, B)))
    got = ops.cola_fit_lowrank(_t(x), _t(g), _t(A), _t(B), scale=0.5)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


# (L, T, tile, blocks a SM, SMs, blocks on the second grid axis): the path's
# q tap (one block an SM) and v tap (two), ragged T, T below one tile, one
# row, L above the card's resident blocks, rank blocks, a small card
PLANS = [(30, 8192, 8, 1, 132, 1), (30, 8192, 8, 2, 132, 1),
         (3, 1001, 8, 1, 132, 1), (2, 5, 8, 1, 132, 1), (4, 1, 8, 2, 132, 1),
         (300, 16, 8, 1, 132, 1), (1000, 3, 4, 2, 132, 1),
         (7, 300, 16, 1, 132, 2), (5, 77, 8, 1, 4, 3)]


@pytest.mark.parametrize("L,T,tile,per_sm,sms,n_y", PLANS)
def test_cola_fit_chunks_cover_every_row_once(L, T, tile, per_sm, sms, n_y):
    """The kernel's chunks fill one wave, are equal within a tile, and cover
    every layer's rows [0, T) exactly once; the reduction's closed form
    (``layer_chunks``) names exactly the chunks that meet each layer, and the
    partial slots chunk + layer never collide."""
    G, n_tiles = cf.grid(L, T, tile, per_sm, sms, n_y)
    work = L * n_tiles
    assert n_tiles == -(-T // tile)
    assert G == max(1, min(work, per_sm * sms // n_y))   # one wave, no idle
    spans = [cf.chunk_tiles(b, L, n_tiles, G) for b in range(G)]
    assert spans[0][0] == 0 and spans[-1][1] == work
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = {f1 - f0 for f0, f1 in spans}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    slots = set()
    for l in range(L):
        rows = torch.zeros(T, dtype=torch.int64)
        meets = []
        for b, (f0, f1) in enumerate(spans):
            lo, hi = max(f0, l * n_tiles), min(f1, (l + 1) * n_tiles)
            if lo < hi:
                meets.append(b)
                t0, t1 = (lo - l * n_tiles) * tile, (hi - l * n_tiles) * tile
                rows[t0:min(t1, T)] += 1
                assert b + l not in slots
                slots.add(b + l)
        assert bool((rows == 1).all()), (l, rows)
        b1, b2 = cf.layer_chunks(l, L, n_tiles, G)
        assert meets == list(range(b1, b2 + 1))
    assert max(slots) < G + L - 1


@pytest.mark.parametrize("d_in,d_out,r,want", [
    (576, 576, 8, (0, 8, 3, 384, 6, 8, 1, 1)),       # the path: q tap
    (576, 192, 8, (0, 8, 3, 256, 6, 8, 1, 1)),       # v tap
    (576, 576, 4, (0, 4, 6, 192, 3, 8, 1, 1)),
    (576, 576, 16, (0, 16, 3, 384, 6, 8, 1, 1)),
    (576, 576, 6, (0, 8, 3, 384, 6, 8, 1, 1)),       # padded to 8
    (576, 576, 32, (0, 16, 3, 384, 6, 8, 2, 1)),     # two rank blocks
    (99, 37, 8, (0, 8, 3, 96, 2, 8, 1, 1)),
    (1536, 576, 8, (0, 8, 6, 352, 8, 4, 1, 1)),      # wider: 6 columns
    (1800, 200, 4, (1, 8, 0, 256, 4, 16, 1, 1)),     # ring too large
    (576, 1536, 16, (1, 8, 0, 256, 4, 16, 2, 1)),    # too many threads
    (9000, 5000, 1, (1, 8, 0, 256, 4, 16, 1, 2)),    # and columns split
])
def test_cola_fit_config(d_in, d_out, r, want):
    """Which instantiation a shape runs and its block shape; every config
    fits a block's shared memory and covers the widths and the rank."""
    c = cf.config(d_in, d_out, r)
    assert (c.variant, c.rb, c.cpt, c.threads, c.wx, c.tt, c.n_rb,
            c.n_split) == want
    assert cf.takes(d_in, d_out, r) and c.smem <= cf.SMEM_LIMIT
    assert c.n_rb * c.rb >= r and c.tt % (32 // c.rb) == 0
    if c.variant == 0:
        wg = c.threads // 32 - c.wx
        most = {k[:2]: k[2] for k in cf.REG_KERNELS[c.rb]}[(c.cpt, c.tt)]
        assert c.threads <= most
        assert 32 * c.cpt * c.wx >= d_in and 32 * c.cpt * wg >= d_out
    else:
        assert c.n_split * c.slice >= d_in + d_out


@pytest.mark.parametrize("d_in,d_out,r", [
    (6000, 450, 8), (6000, 460, 8),     # the first kernel's edge, both sides
    (29000, 50, 1), (29100, 10, 1),
    (100, 100, 256), (200, 200, 256),
    (3584, 4096, 8), (3584, 2048, 8),   # gemma2-9b's q and v taps
    (5120, 4096, 8),                    # mistral-nemo-12b's q tap
    (8192, 8192, 256), (8192, 8192, 1), (1, 1, 1),   # JAX's bounds
])
def test_cola_fit_takes_the_first_kernels_shapes(d_in, d_out, r):
    """The kernel takes every shape the first kernel took (its accumulators
    and one row of x and g in one block's shared memory) and every shape
    JAX's kernel takes (``supported``: d_in, d_out <= 8192, r <= 256), each
    planned within a block's shared memory and the grid's second axis, its
    columns and ranks covered."""
    assert cf.takes(d_in, d_out, r)
    c = cf.config(d_in, d_out, r)
    assert c.smem <= cf.SMEM_LIMIT and c.n_rb * c.n_split <= cf.GRID_Y
    assert c.n_rb * c.rb >= r
    assert c.variant == 0 or c.n_split * c.slice >= d_in + d_out
    if max(d_in, d_out) <= 8192 and r <= 256:
        shapes = [types.SimpleNamespace(shape=s)
                  for s in ((64, d_in), (64, d_out), (d_in, r), (r, d_out))]
        assert jcf.supported(*shapes)


def test_cola_fit_refuses_only_what_no_launch_holds():
    """Empty widths or ranks, and accumulators past 32-bit indexing, raise."""
    assert not cf.takes(0, 8, 8) and not cf.takes(8, 0, 8)
    assert not cf.takes(8, 8, 0)
    assert not cf.takes(2 ** 20, 2 ** 20, 1024)


def _chunk_order_fit(x, g, A, B, scale, tile, G):
    """cola_fit in the kernel's summation order, in torch: each chunk's
    partial adds its tiles in order; each layer's result adds the partials of
    the chunks that meet it (``layer_chunks``) in chunk order, then scales."""
    L, T, _ = x.shape
    n_tiles = -(-T // tile)
    parts = {}
    for b in range(G):
        f0, f1 = cf.chunk_tiles(b, L, n_tiles, G)
        for f in range(f0, f1):
            l, t = divmod(f, n_tiles)
            xs, gs = x[l, t * tile:(t + 1) * tile], g[l, t * tile:(t + 1) * tile]
            pa, pb = parts.get((b, l), (0.0, 0.0))
            parts[(b, l)] = (pa + xs.T @ (gs @ B[l].T), pb + (xs @ A[l]).T @ gs)
    out = []
    for l in range(L):
        b1, b2 = cf.layer_chunks(l, L, n_tiles, G)
        sa, sb = parts[(b1, l)]
        for b in range(b1 + 1, b2 + 1):
            sa, sb = sa + parts[(b, l)][0], sb + parts[(b, l)][1]
        out.append((scale * sa, scale * sb))
    return torch.stack([a for a, _ in out]), torch.stack([b for _, b in out])


@pytest.mark.parametrize("L,T,tile,G", [(3, 256, 8, 5), (3, 250, 8, 7),
                                        (2, 5, 8, 1), (5, 40, 16, 4),
                                        (4, 64, 8, 32)])
def test_cola_fit_chunk_order_matches_ref_and_pallas(L, T, tile, G):
    """The kernel's decomposition (chunks that span layer boundaries, ragged
    last tiles, partials added in chunk order) against the plain version and
    the Pallas kernel in interpret mode, at test_cola_fit_matches_pallas's
    tolerance."""
    rng = np.random.default_rng(3)
    d_in, d_out, r = 96, 48, 8
    x = rng.standard_normal((L, T, d_in)).astype(np.float32)
    g = rng.standard_normal((L, T, d_out)).astype(np.float32)
    A = rng.standard_normal((L, d_in, r)).astype(np.float32)
    B = rng.standard_normal((L, r, d_out)).astype(np.float32)
    G = min(G, L * -(-T // tile))
    got = _chunk_order_fit(*map(_t, (x, g, A, B)), 0.5, tile, G)
    want_ref = ref.cola_fit_lowrank(*map(_t, (x, g, A, B)), scale=0.5)
    want_pallas = jax.vmap(functools.partial(
        jcf.cola_fit_lowrank, scale=0.5, interpret=True))(
            *map(jnp.asarray, (x, g, A, B)))
    for a, w, p in zip(got, want_ref, want_pallas):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(p), rtol=1e-5,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the GL core on the reduced model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = registry.reduced_config("smollm-135m").replace(n_layers=2)
    tcfg = tregistry.reduced_config("smollm-135m").replace(n_layers=2)
    params = M.init(cfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    stream = jpipeline.SyntheticLM(cfg, batch=2, seq=16, seed=3)
    batches = [stream.batch_at(i) for i in range(4)]
    return cfg, tcfg, params, tparams, batches


def _jit(fn, *static):
    """The JAX function compiled once (eager JAX runs op by op, slowly)."""
    return jax.jit(functools.partial(fn, *static))


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _adapters(cfg, family, *, noise=0.02, rank=4, hidden=16):
    """JAX-initialised adapters plus noise (so B != 0 and dA is informative),
    as numpy, for both packages."""
    cc = ColaConfig(mode="faithful_offload", family=family, taps="qv",
                    rank=rank, hidden=hidden)
    ad = gl.init_adapters(cfg, cc, jax.random.PRNGKey(2))
    ad = jax.tree.map(lambda a: a + noise * jax.random.normal(
        jax.random.PRNGKey(7), a.shape), ad)
    return cc, _np(ad)


def _specs(cfg, tcfg, cc):
    tcc = tbase.ColaConfig(**dataclasses.asdict(cc))
    return gl.make_spec(cfg, cc), tgl.make_spec(tcfg, tcc)


@pytest.mark.parametrize("merged", [False, True])
def test_server_step_a_matches_jax(setup, merged):
    """Loss and per-tap (x, grad_h) of Mode A's server step."""
    cfg, tcfg, params, tparams, batches = setup
    cc, ad = _adapters(cfg, "lowrank")
    cc = dataclasses.replace(cc, merged=merged)
    spec, tspec = _specs(cfg, tcfg, cc)
    tad = convert.adapters_from_numpy(ad, device="cpu")
    jp, tp, jin, tin = params, tparams, ad, tad
    if merged:
        fams = dict(gl.make_spec(cfg, dataclasses.replace(cc, merged=False))
                    .families)
        jp = jmerge.merged_params(cfg, params, fams, ad, cc.scale)
        tp = tmerge.merged_params(tcfg, tparams, fams, tad, cc.scale)
        jin, tin = {}, {}
    loss, data, _ = _jit(gl.server_step_a, cfg, spec)(jp, jin, batches[0])
    tloss, tdata, _ = tgl.server_step_a(tcfg, tspec, tp, tin, _tb(batches[0]))
    _close(float(tloss), float(loss), what="loss")
    assert set(tdata) == set(data) == set(gl.select_taps(cfg, "qv"))
    for tap in data:
        assert tdata[tap][0].shape == data[tap][0].shape   # (L, B, S, d_in)
        _close(tdata[tap][0].numpy(), data[tap][0], what=f"{tap} x")
        _close(tdata[tap][1].numpy(), data[tap][1], what=f"{tap} grad_h")


@pytest.mark.parametrize("family", ["lowrank", "linear", "mlp"])
def test_fit_grads_match_jax(setup, family):
    cfg, tcfg, params, tparams, batches = setup
    cc, ad = _adapters(cfg, family)
    spec, tspec = _specs(cfg, tcfg, cc)
    _, data, _ = _jit(gl.server_step_a, cfg, spec)(params, ad, batches[0])
    want = _jit(gl.fit_grads, spec)(ad, data)
    tdata = {t: (_t(x), _t(g)) for t, (x, g) in _np(data).items()}
    got = tgl.fit_grads(tspec, convert.adapters_from_numpy(ad, device="cpu"),
                        tdata)
    _close(_tnp(got), _np(want), rtol=1e-5, what=family)


def test_train_step_b_and_ft_match_jax(setup):
    cfg, tcfg, params, tparams, batches = setup
    cc, ad = _adapters(cfg, "lowrank")
    spec, tspec = _specs(cfg, tcfg, dataclasses.replace(cc, mode="fused_fit"))
    loss, grads, _ = _jit(gl.train_step_b, cfg, spec)(params, ad, batches[1])
    tloss, tgrads, _ = tgl.train_step_b(
        tcfg, tspec, tparams, convert.adapters_from_numpy(ad, device="cpu"),
        _tb(batches[1]))
    _close(float(tloss), float(loss), what="loss b")
    _close(_tnp(tgrads), _np(grads), what="grads b")
    loss, grads, _ = _jit(gl.train_step_ft, cfg)(params, batches[1])
    tloss, tgrads, _ = tgl.train_step_ft(tcfg, tparams, _tb(batches[1]))
    _close(float(tloss), float(loss), what="loss ft")
    _close(_tnp(tgrads), _np(grads), what="grads ft")


def test_remat_full_gives_the_same_gradients(setup):
    """remat="full" (torch.utils.checkpoint per layer) recomputes the layers
    in the backward, and remat="dots" replays the products it kept; neither
    changes a number."""
    cfg, tcfg, params, tparams, batches = setup
    cc, ad = _adapters(cfg, "lowrank")
    _, tspec = _specs(cfg, tcfg, cc)
    out = {}
    for remat in ("none", "full", "dots"):
        c = tcfg.replace(remat=remat)
        out[remat] = tgl.server_step_a(c, tspec, tparams,
                                       convert.adapters_from_numpy(
                                           ad, device="cpu"),
                                       _tb(batches[0]))[:2]
    for remat in ("full", "dots"):
        assert torch.equal(out["none"][0], out[remat][0])
        for tap, (x, g) in out["none"][1].items():
            assert torch.equal(x, out[remat][1][tap][0])
            assert torch.equal(g, out[remat][1][tap][1])


def test_tap_and_merge_helpers_match_jax(setup):
    """The spec helpers, zero deltas, adapter shapes and the adapter-soup
    merge against the JAX package's."""
    from repro.core import adapters as jadapters
    from repro.core import taps as jtaps
    from repro_torch.core import adapters as tadapters
    from repro_torch.core import taps as ttaps
    cfg, tcfg, _, _, _ = setup
    cc, ad = _adapters(cfg, "lowrank")
    spec, tspec = _specs(cfg, tcfg, dataclasses.replace(cc, merged=True))
    assert tspec.tap_names() == spec.tap_names()
    assert tspec.with_adapters_only() == ttaps.ColaSpec(
        **{**dataclasses.asdict(tspec), "collect": (), "inject": ()})
    zj = jtaps.zero_delta_vars(spec, M.tap_sites(cfg), (2, 5))
    zt = ttaps.zero_delta_vars(tspec, TM.tap_sites(tcfg), (2, 5), device="cpu")
    assert {t: tuple(z.shape) for t, z in zt.items()} == {
        t: z.shape for t, z in zj.items()}
    assert {t: tuple(z.shape) for t, z in tgl.zero_deltas(
        tcfg, tspec, 2, 5, device="cpu").items()} == {
        t: z.shape for t, z in gl.zero_deltas(cfg, spec, 2, 5).items()}
    for fam in ("lowrank", "linear", "mlp"):
        assert tadapters.shapes(fam, 6, 4, rank=2, hidden=3) == \
            jadapters.shapes(fam, 6, 4, rank=2, hidden=3)
        assert tadapters.is_mergeable(fam) == jadapters.is_mergeable(fam)
    _, ad2 = _adapters(cfg, "lowrank", noise=0.5)
    want = jmerge.merge_adapter_pytrees([ad, ad2], [0.25, 0.75])
    got = tmerge.merge_adapter_pytrees([convert.adapters_from_numpy(
        a, device="cpu") for a in (ad, ad2)], [0.25, 0.75])
    _close(_tnp(got), _np(want), rtol=1e-6)
    with pytest.raises(ValueError, match="not mergeable"):
        tadapters.merge_delta("mlp", {}, 1.0)


# ---------------------------------------------------------------------------
# optimizers, schedules, data, offload compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd_nesterov"])
def test_optimizer_updates_match_jax(name):
    rng = np.random.default_rng(4)
    params = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
              "b": rng.standard_normal((7,)).astype(np.float32)}
    sched = jsched.linear_warmup_decay(1e-2, 20)
    tsch = tsched.linear_warmup_decay(1e-2, 20)
    if name == "adamw":
        jo = joptim.adamw(sched, weight_decay=5e-4)
        to = toptim.adamw(tsch, weight_decay=5e-4)
    else:
        nest = name == "sgd_nesterov"
        jo = joptim.sgd(sched, momentum=0.9, nesterov=nest)
        to = toptim.sgd(tsch, momentum=0.9, nesterov=nest)
    jp, tp = params, {"a": {"w": _t(params["a"]["w"])}, "b": _t(params["b"])}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(4):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        tg = {"a": {"w": _t(g["a"]["w"])}, "b": _t(g["b"])}
        ju, js = jo.update(g, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp = joptim.apply_updates(jp, ju)
        tp = toptim.apply_updates(tp, tu)
    _close(_tnp(tp), _np(jp), rtol=1e-6, what=name)
    assert int(js["step"]) == ts["step"] == 4
    tclip = toptim.clip_by_global_norm(tp, 0.5)
    _close(_tnp(tclip), _np(joptim.clip_by_global_norm(jp, 0.5)), rtol=1e-6)


@pytest.mark.parametrize("name", ["linear", "cosine", "const"])
def test_schedules_match_jax(name):
    j, t = jsched.make(name, 3e-4, 50), tsched.make(name, 3e-4, 50)
    steps = [0, 1, 2, 3, 10, 49, 50, 60]
    np.testing.assert_allclose([float(t(s)) for s in steps],
                               [float(j(s)) for s in steps], rtol=1e-6)


def test_synthetic_stream_and_configs_match_jax(setup):
    cfg, tcfg, _, _, _ = setup
    assert dataclasses.asdict(tbase.TrainConfig()) == dataclasses.asdict(
        TrainConfig())
    assert dataclasses.asdict(tbase.ColaConfig()) == dataclasses.asdict(
        ColaConfig())
    js = jpipeline.SyntheticLM(cfg, batch=4, seq=32, seed=5, users=3)
    ts = tpipeline.SyntheticLM(tcfg, batch=4, seq=32, seed=5, users=3,
                               device="cpu")
    for step in (0, 7):
        got, want = ts.batch_at(step), js.batch_at(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_int8_offload_compression_matches_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 3, 5, 16)) * 3).astype(np.float32)
    q, s = joffload.quant_int8(jnp.asarray(x))
    tq, ts = toffload.quant_int8(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-7)
    np.testing.assert_allclose(toffload.dequant_int8(tq, ts).numpy(),
                               np.asarray(joffload.dequant_int8(q, s)),
                               rtol=1e-7)


# ---------------------------------------------------------------------------
# the paper's claims, port-internal (copies of tests/test_gl_equivalence.py)
# ---------------------------------------------------------------------------

def _torch_setup(setup, family="lowrank", scale=1.0):
    cfg, tcfg, _, tparams, batches = setup
    cc, ad = _adapters(cfg, family)
    tcc = tbase.ColaConfig(**{**dataclasses.asdict(cc), "scale": scale})
    return tcfg, tcc, tparams, convert.adapters_from_numpy(ad, device="cpu"), \
        _tb(batches[2])


def test_prop1_mode_a_equals_mode_b(setup):
    tcfg, tcc, tparams, tad, batch = _torch_setup(setup)
    spec_a = tgl.make_spec(tcfg, tcc)
    spec_b = tgl.make_spec(tcfg, dataclasses.replace(tcc, mode="fused_fit"))
    loss_a, data, _ = tgl.server_step_a(tcfg, spec_a, tparams, tad, batch)
    ga = tgl.fit_grads(spec_a, tad, data)
    loss_b, gb, _ = tgl.train_step_b(tcfg, spec_b, tparams, tad, batch)
    assert np.allclose(float(loss_a), float(loss_b), rtol=1e-6)
    for tap in gb:
        for leaf in gb[tap]:
            np.testing.assert_allclose(ga[tap][leaf].numpy(),
                                       gb[tap][leaf].numpy(), rtol=2e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_prop1_merged_server_pass(setup, scale):
    tcfg, tcc, tparams, tad, batch = _torch_setup(setup, scale=scale)
    spec_m = tgl.make_spec(tcfg, dataclasses.replace(tcc, merged=True))
    spec_fit = tgl.make_spec(tcfg, tcc)
    pm = tmerge.merged_params(tcfg, tparams, spec_fit, tad)
    _, data_m, _ = tgl.server_step_a(tcfg, spec_m, pm, {}, batch)
    gm = tgl.fit_grads(spec_fit, tad, data_m)
    spec_b = tgl.make_spec(tcfg, dataclasses.replace(tcc, mode="fused_fit"))
    _, gb, _ = tgl.train_step_b(tcfg, spec_b, tparams, tad, batch)
    for tap in gb:
        for leaf in gb[tap]:
            np.testing.assert_allclose(gm[tap][leaf].numpy(),
                                       gb[tap][leaf].numpy(), rtol=5e-3,
                                       atol=1e-5)
    back = tmerge.unmerge_adapters(tcfg, pm, spec_fit.family_map, tad, scale)
    _close(_tnp(back), _tnp(tparams), rtol=1e-6)


def test_linear_adapter_equals_full_ft_gradients(setup):
    """ColA(Linear) gradient == d loss / d W of the tapped base weight."""
    tcfg, tcc, tparams, tad, batch = _torch_setup(setup, family="linear")
    spec = tgl.make_spec(tcfg, dataclasses.replace(tcc, mode="fused_fit"))
    zero = {t: {"W": torch.zeros_like(w["W"])} for t, w in tad.items()}
    _, g_ad, _ = tgl.train_step_b(tcfg, spec, tparams, zero, batch)
    _, g_ft, _ = tgl.train_step_ft(tcfg, tparams, batch)
    for site in ("q", "v"):
        np.testing.assert_allclose(
            g_ad[f"layers.attn.{site}"]["W"].numpy(),
            g_ft["layers"]["attn"][site]["w"].numpy(), rtol=2e-4, atol=1e-7)


def test_fit_loss_gradient_matches_fit_grads(setup):
    tcfg, tcc, tparams, tad, batch = _torch_setup(setup)
    spec = tgl.make_spec(tcfg, tcc)
    _, data, _ = tgl.server_step_a(tcfg, spec, tparams, tad, batch)
    spec_fit = tgl.make_spec(tcfg, dataclasses.replace(tcc, mode="fused_fit"))
    g1 = tgl.fit_grads(spec_fit, tad, data)
    w = {t: {n: a.clone().requires_grad_() for n, a in e.items()}
         for t, e in tad.items()}
    loss = tgl.fit_loss(spec_fit, w, data, tad)
    loss.backward()
    for tap in g1:
        for leaf in g1[tap]:
            np.testing.assert_allclose(g1[tap][leaf].numpy(),
                                       w[tap][leaf].grad.numpy(), rtol=5e-3,
                                       atol=1e-6)
