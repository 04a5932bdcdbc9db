"""The CUDA kernels against their plain versions on the card, over the shapes
and options the full-width run of ``chip_smoke.py`` does not reach: every
head dim the kernels take, ragged lengths, non-uniform per-row positions,
window and softcap, dead slots, padding rows, ranks up to 256.

Marked ``cuda``; skipped without a card. On the H100 (whose Python has no
JAX, which the tests' conftest imports):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances: f32 1e-5 and bf16 2^-7, each times (1 + max |plain|), as in
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Smax,H,K,D", [(16, 1024, 9, 3, 64), (4, 128, 4, 2, 32),
                                          (3, 64, 6, 1, 128), (5, 100, 8, 8, 16)])
def test_decode_attention_kernel(dev, dtype, B, Smax, H, K, D):
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _rnd(gen, dev, dtype, B, 1, H, D)
    kc, vc = (_rnd(gen, dev, dtype, B, Smax, K, D) for _ in range(2))
    pos = torch.randint(0, Smax, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, Smax - 1
    live = torch.arange(B, device=dev) % 3 != 1
    for kw in (dict(live=live), dict(window=40, softcap=20.0), {}):
        o = da.decode_attention(q, kc, vc, pos, **kw)
        _close(o, da.plain(q, kc, vc, pos, **kw), dtype)
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
    y = ml.multi_lora(x, A, Bm, idx, 0.5)
    _close(y, ml.plain(x, A, Bm, idx, 0.5), dtype)
    assert bool((y[idx < 0] == 0).all())
    assert torch.equal(y, ml.multi_lora(x, A, Bm, idx, 0.5))


def test_wrappers_raise_for_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 2, 48, device=dev)        # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(4, 8, device=dev, dtype=torch.float16)
    A, B = torch.zeros(1, 8, 2, device=dev), torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        ml.multi_lora(x, A, B, torch.zeros(4, dtype=torch.int32, device=dev))
