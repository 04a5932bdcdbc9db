"""Serving at scale in the port: chunked prefill, the paged KV layout and int8
adapter banks, against the JAX package on the reduced f32 smollm-135m
(2 layers) with the same weights (carried by ``repro_torch.convert``) and
numpy inputs from a seed, plus the port's own invariants (chunked ==
unchunked, paged == dense, int8 == its dequantised f32 bank, pool
accounting). Tolerances are stated per test: f32 sums in another order.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import multi_lora as jml  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.runtime import kv_pager as jpager  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.kernels import multi_lora as tml  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import kv_pager as tpager  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

# f32 through 2 layers, sums in another order than XLA's
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = registry.reduced_config("smollm-135m").replace(n_layers=2)
    tcfg = tregistry.reduced_config("smollm-135m").replace(n_layers=2)
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    banks = []
    for u in range(2):   # both users' B nonzero (user 0's B is zero at init)
        ad = gl.init_adapters(cfg, cc, jax.random.fold_in(key, 1 + u))
        banks.append(jax.tree.map(lambda a: a + 0.3 * jax.random.normal(
            jax.random.fold_in(key, 10 + u), a.shape), ad))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                        device="cpu")
    tbanks = [convert.adapters_from_numpy(jax.tree.map(np.asarray, b),
                                          device="cpu") for b in banks]
    return (cfg, params, banks), (tcfg, tparams, tbanks)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p in lens]


def _run(lib, cfg, params, banks, prompts, *, max_new, **kw):
    eng = lib.ServeEngine(cfg, params, user_adapters=banks, **kw)
    reqs = [lib.Request(rid=i, user=i % 2, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert all(r.status == "done" for r in reqs)
    return [r.out for r in reqs], eng


# ---------------------------------------------------------------------------
# the pager: a copy of JAX's, held to the same tables and stats
# ---------------------------------------------------------------------------

def test_pager_matches_jax_on_one_sequence():
    pagers = [lib.BlockPager(n_blocks=10, block_size=4, slots=3, max_len=24)
              for lib in (jpager, tpager)]
    steps = [("reserve", 0, 9), ("ensure", 0, 6), ("reserve", 1, 16),
             ("reserve", 2, 12), ("ensure", 1, 11), ("ensure", 0, 8),
             ("release", 0), ("reserve", 2, 12), ("ensure", 2, 3),
             ("ensure", 1, 15), ("release", 1), ("ensure", 2, 11),
             ("release", 2)]
    for op, *args in steps:
        got = [getattr(p, op)(*args) for p in pagers]
        assert got[0] == got[1], (op, args)
        assert np.array_equal(pagers[0].table, pagers[1].table), (op, args)
        assert pagers[0].stats == pagers[1].stats, (op, args)
        assert pagers[0].free_unreserved() == pagers[1].free_unreserved()
    pagers[1].assert_empty()


def test_pager_double_free_raises_and_assert_empty_detects_a_leak():
    pg = tpager.BlockPager(n_blocks=4, block_size=4, slots=2, max_len=16)
    assert pg.ensure(0, 5)
    blk = pg.owned(0)[0]
    pg.release(0)
    pg._owned[0] = [blk]                 # a corrupted retire
    with pytest.raises(tpager.PagerError, match="double free"):
        pg.release(0)
    pg = tpager.BlockPager(n_blocks=4, block_size=4, slots=2, max_len=16)
    assert pg.ensure(1, 0)
    with pytest.raises(tpager.PagerError, match="leaked"):
        pg.assert_empty()
    pg.release(1)
    pg.assert_empty()


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap", [(None, None), (9, 10.0)])
def test_paged_plain_matches_pallas_kernel(window, softcap):
    """Rows at scattered positions, a shuffled block assignment, a dead slot;
    tolerance 1e-5 (f32)."""
    rng = np.random.default_rng(0)
    B, H, K, Dh = 4, 8, 2, 64
    bs, nb_pool, nb_tab = 8, 16, 6
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    k_pool = rng.normal(size=(nb_pool, bs, K, Dh)).astype(np.float32)
    v_pool = rng.normal(size=(nb_pool, bs, K, Dh)).astype(np.float32)
    positions = np.array([3, 10, 21, 40], np.int32)
    table = np.zeros((B, nb_tab), np.int32)
    it = iter(rng.permutation(nb_pool))
    for b in range(B):
        for j in range(positions[b] // bs + 1):
            table[b, j] = next(it)
    live = np.array([True, True, False, True])
    want = jda.decode_attention_paged(
        *(jnp.asarray(a) for a in (q, k_pool, v_pool, positions, table)),
        live=jnp.asarray(live), window=window, softcap=softcap,
        interpret=True)
    got = tref.sdpa_decode_paged(
        *(torch.as_tensor(a) for a in (q, k_pool, v_pool, positions, table)),
        live=torch.as_tensor(live), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.numpy()[2] == 0)


def test_q8_plain_matches_pallas_kernel():
    """int8 bank, 3 users, padding rows (idx < 0); tolerance 1e-5 (f32)."""
    rng = np.random.default_rng(1)
    T, U, din, dout, r = 32, 3, 64, 48, 8
    x = rng.normal(size=(T, din)).astype(np.float32)
    A = rng.normal(size=(U, din, r)).astype(np.float32)
    B = rng.normal(size=(U, r, dout)).astype(np.float32)
    idx = rng.integers(-1, U, size=T).astype(np.int32)
    idx[:2] = -1
    Aq, As = jml.quant_rows(jnp.asarray(A))
    Bq, Bs = jml.quant_rows(jnp.asarray(B))
    want = jml.multi_lora_q8(jnp.asarray(x), Aq, As, Bq, Bs, jnp.asarray(idx),
                             scale=0.5, interpret=True)
    got = tref.multi_lora_q8(torch.as_tensor(x), *(torch.tensor(
        np.asarray(a)) for a in (Aq, As, Bq, Bs)), torch.as_tensor(idx),
        scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.numpy()[idx < 0] == 0)


def test_quant_rows_codes_equal_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(2, 3, 40, 8)).astype(np.float32)
    w[0, 0, 0] = 0.0                      # an all-zero row: scale floor
    # scale 2^-4 exactly, codes at halves: round half to even
    w[1, 2, 5] = np.array([127, 0.5, 1.5, -2.5, 2.5, -0.5, 3.5, 4.5]) / 16
    jq, js = jml.quant_rows(jnp.asarray(w))
    tq, ts = tml.quant_rows(torch.as_tensor(w))
    assert tq[1, 2, 5].tolist() == [127, 0, 2, -2, 2, 0, 4, 4]
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tml.dequant_rows(tq, ts).numpy(), np.asarray(jml.dequant_rows(jq, js)))


# ---------------------------------------------------------------------------
# decode_step with c > 1: dense and paged, against JAX's logits and cache
# ---------------------------------------------------------------------------

def _prefilled(setup, slots, max_len, toks, slot_ids):
    (cfg, params, _), (tcfg, tparams, _) = setup
    _, pre = M.prefill(cfg, params, {"tokens": jnp.asarray(toks)})
    cache = M.scatter_prefill_cache(M.init_cache(cfg, slots, max_len), pre,
                                    jnp.asarray(slot_ids))
    _, tpre = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    tcache = TM.scatter_prefill_cache(
        TM.init_cache(tcfg, slots, max_len, device="cpu"), tpre, slot_ids)
    return cache, tcache


def test_chunk_step_dense_matches_jax_and_drops_the_tail(setup):
    """A 4-token chunk per row over a 16-position cache: row 0's tail
    crosses the horizon (positions 14..17: 16 and 17 dropped, never clamped
    over real KV), row 2 is dead (its rows untouched)."""
    (cfg, params, _), (tcfg, tparams, _) = setup
    rng = np.random.default_rng(3)
    slots, max_len, c = 3, 16, 4
    toks = rng.integers(0, cfg.vocab_size, (2, 14)).astype(np.int32)
    cache, tcache = _prefilled(setup, slots, max_len, toks,
                               np.array([0, 1], np.int32))
    before = {n: tcache["layers"][n].clone() for n in ("k", "v")}
    step = {"tokens": rng.integers(0, cfg.vocab_size, (slots, c)).astype(np.int32),
            "positions": np.array([14, 6, 3], np.int32)}
    live = np.array([True, True, False])
    lg, cache = M.decode_step(cfg, params, jax.tree.map(jnp.asarray, step),
                              cache, live=jnp.asarray(live))
    tlg, tcache = TM.decode_step(tcfg, tparams, {k: torch.as_tensor(v) for k, v
                                                 in step.items()},
                                 tcache, live=torch.as_tensor(live))
    np.testing.assert_allclose(tlg.numpy()[live], np.asarray(lg)[live], **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][n].numpy(),
                                   np.asarray(cache["layers"][n]), **TOL)
        assert torch.equal(tcache["layers"][n][:, 2], before[n][:, 2])
        # row 0 kept its prompt's KV below position 14
        assert torch.equal(tcache["layers"][n][:, 0, :14],
                           before[n][:, 0, :14])


def test_chunk_step_paged_matches_jax(setup):
    """The same chunk through a shuffled block table: pool and logits match
    JAX; positions past the table are dropped, a dead row writes nothing."""
    (cfg, params, _), (tcfg, tparams, _) = setup
    rng = np.random.default_rng(4)
    slots, max_len, bs, n_blocks, c = 3, 16, 4, 12, 4
    table = np.zeros((slots, max_len // bs), np.int32)
    perm = rng.permutation(n_blocks)
    table[0] = perm[:4]
    table[1, :3] = perm[4:7]
    table[2, :2] = perm[7:9]
    pool_k = rng.normal(size=(cfg.n_layers, n_blocks, bs, cfg.n_kv_heads,
                              cfg.d_head)).astype(np.float32)
    pool_v = rng.normal(size=pool_k.shape).astype(np.float32)
    step = {"tokens": rng.integers(0, cfg.vocab_size, (slots, c)).astype(np.int32),
            "positions": np.array([14, 6, 3], np.int32)}
    live = np.array([True, True, False])
    cache = {"layers": {"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)}}
    tcache = {"layers": {"k": torch.tensor(pool_k), "v": torch.tensor(pool_v)}}
    lg, cache = M.decode_step(cfg, params, jax.tree.map(jnp.asarray, step),
                              cache, live=jnp.asarray(live),
                              block_table=jnp.asarray(table))
    tlg, tcache = TM.decode_step(tcfg, tparams, {k: torch.as_tensor(v) for k, v
                                                 in step.items()}, tcache,
                                 live=torch.as_tensor(live),
                                 block_table=torch.as_tensor(table))
    np.testing.assert_allclose(tlg.numpy()[live], np.asarray(lg)[live], **TOL)
    for n, pool in (("k", pool_k), ("v", pool_v)):
        got = tcache["layers"][n].numpy()
        np.testing.assert_allclose(got, np.asarray(cache["layers"][n]), **TOL)
        # blocks no live row writes to (the dead row's, the unowned) are intact
        written = set(table[0]) | set(table[1, 1:3])
        for blk in range(n_blocks):
            if blk not in written:
                assert np.array_equal(got[:, blk], pool[:, blk]), blk


def test_dead_rows_leave_the_pool_untouched(setup):
    """A decode tick with every row dead writes nothing to the pool, and a
    dead row's output carries no KV of its own into the pool."""
    _, (tcfg, tparams, _) = setup
    slots, bs, n_blocks = 4, 8, 8
    gen = torch.Generator().manual_seed(0)
    shape = (tcfg.n_layers, n_blocks, bs, tcfg.n_kv_heads, tcfg.d_head)
    cache = {"layers": {n: torch.randn(shape, generator=gen)
                        for n in ("k", "v")}}
    before = {n: t.clone() for n, t in cache["layers"].items()}
    table = torch.arange(slots * 2, dtype=torch.int32).reshape(slots, 2)
    for c in (1, 3):
        batch = {"tokens": torch.ones((slots, c), dtype=torch.int32),
                 "positions": torch.tensor([0, 5, 9, 12], dtype=torch.int32)}
        TM.decode_step(tcfg, tparams, batch, cache,
                       live=torch.zeros(slots, dtype=torch.bool),
                       block_table=table)
        for n in ("k", "v"):
            assert torch.equal(cache["layers"][n], before[n])


# ---------------------------------------------------------------------------
# the engine against the JAX engine, option by option and all together
# ---------------------------------------------------------------------------

ENGINE_OPTIONS = {
    "chunked": dict(prefill_chunk=4),
    "paged": dict(prefill_chunk=4, kv_layout="paged", kv_block=8),
    "int8": dict(bank_store="int8"),
    "all": dict(prefill_chunk=4, kv_layout="paged", kv_block=8,
                bank_store="int8"),
}


@pytest.mark.parametrize("opts", sorted(ENGINE_OPTIONS))
def test_engine_options_match_jax(setup, opts):
    """Prompt lengths 1..21 with S % C != 0 tails, more requests than slots;
    greedy tokens equal to the JAX engine's."""
    (cfg, params, banks), (tcfg, tparams, tbanks) = setup
    prompts = _prompts(cfg.vocab_size, (1, 5, 11, 9, 21, 6), seed=5)
    kw = dict(slots=4, max_len=48, max_new=6, **ENGINE_OPTIONS[opts])
    want, jeng = _run(jserve, cfg, params, banks, prompts, **kw)
    got, eng = _run(tserve, tcfg, tparams, tbanks, prompts, device="cpu", **kw)
    assert got == want
    for key in ("prefill_chunks", "chunk_rounds", "kv_allocs", "kv_frees",
                "kv_blocks_peak"):
        assert eng.stats[key] == jeng.stats[key], key
    if eng.pager is not None:
        eng.pager.assert_empty()
        assert eng.stats["kv_allocs"] == eng.stats["kv_frees"] > 0


@pytest.mark.parametrize("opts", ["paged", "all"])
def test_paged_throughput_reports_blocks_as_jax(setup, opts):
    """Under ``kv_layout="paged"``, ``throughput()`` carries
    ``kv_blocks_in_use`` and ``kv_blocks_peak`` equal to the JAX engine's
    after every tick (blocks held mid-flight, all freed at the end); the
    dense engine's carries neither key, as JAX's."""
    (cfg, params, banks), (tcfg, tparams, tbanks) = setup
    prompts = _prompts(cfg.vocab_size, (1, 5, 11, 9, 21, 6), seed=6)
    kw = dict(slots=4, max_len=48, **ENGINE_OPTIONS[opts])
    engs = [jserve.ServeEngine(cfg, params, user_adapters=banks, **kw),
            tserve.ServeEngine(tcfg, tparams, user_adapters=tbanks,
                               device="cpu", **kw)]
    for lib, eng in zip((jserve, tserve), engs):
        for i, p in enumerate(prompts):
            eng.submit(lib.Request(rid=i, user=i % 2, prompt=p, max_new=6))
    keys = ("kv_blocks_in_use", "kv_blocks_peak")
    seen = []
    while engs[0].queue or any(r is not None for r in engs[0].active):
        for eng in engs:
            eng.tick()
        got = [{k: e.throughput()[k] for k in keys} for e in engs]
        assert got[1] == got[0]
        seen.append(got[1]["kv_blocks_in_use"])
    assert max(seen) > 0 and seen[-1] == 0
    assert got[1]["kv_blocks_peak"] >= max(seen) > 0   # peaks inside a tick
    dense = [lib.ServeEngine(c, p, user_adapters=b, slots=4, max_len=48,
                             **extra).throughput()
             for lib, c, p, b, extra in ((jserve, cfg, params, banks, {}),
                                         (tserve, tcfg, tparams, tbanks,
                                          dict(device="cpu")))]
    assert not any(k in tp for tp in dense for k in keys)


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------

def _chunk_logits(tcfg, tparams, prompt, cache, *, C, slot, slots, table=None,
                  pager=None):
    """Drive decode_step chunk by chunk as the engine does (padded width-C
    rounds); returns the last real token's logits."""
    consumed, last = 0, None
    while consumed < len(prompt):
        c = min(C, len(prompt) - consumed)
        toks = np.zeros((slots, C), np.int32)
        toks[slot, :c] = prompt[consumed:consumed + c]
        pos = np.zeros(slots, np.int32)
        pos[slot] = consumed
        live = np.zeros(slots, bool)
        live[slot] = True
        kw = {}
        if pager is not None:
            assert pager.ensure(slot, consumed + C - 1)
            kw["block_table"] = torch.as_tensor(pager.table)
        lg, cache = TM.decode_step(tcfg, tparams, {
            "tokens": torch.as_tensor(toks), "positions": torch.as_tensor(pos)},
            cache, live=torch.as_tensor(live), **kw)
        last = lg[slot, c - 1]
        consumed += c
    return last


def test_chunked_matches_unchunked_and_paged_matches_dense(setup):
    """An 11-token prompt in 4-token chunks: logits within 1e-5 of the
    unchunked prefill's (f32 sums in another order), same argmax; the paged
    run's logits equal the dense chunked run's within 1e-6."""
    _, (tcfg, tparams, _) = setup
    prompt = _prompts(tcfg.vocab_size, (11,), seed=6)[0]
    full, _ = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(prompt[None])})
    full = full[0, 0]
    slots, max_len, s = 3, 32, 1
    dense = _chunk_logits(tcfg, tparams, prompt,
                          TM.init_cache(tcfg, slots, max_len, device="cpu"),
                          C=4, slot=s, slots=slots)
    torch.testing.assert_close(dense, full, rtol=0, atol=1e-5)
    assert int(dense.argmax()) == int(full.argmax())
    pager = tpager.BlockPager(n_blocks=16, block_size=8, slots=slots,
                              max_len=max_len)
    assert pager.reserve(s, len(prompt))
    paged = _chunk_logits(tcfg, tparams, prompt,
                          TM.init_cache(tcfg, slots, max_len, kv_layout="paged",
                                        kv_blocks=16, kv_block=8, device="cpu"),
                          C=4, slot=s, slots=slots, pager=pager)
    torch.testing.assert_close(paged, dense, rtol=0, atol=1e-6)


def test_engine_chunked_paged_int8_match_their_plain_counterparts(setup):
    """Port-internal: chunked == unchunked and paged == dense (equal tokens),
    int8 == the f32 engine on the explicitly dequantised bank (equal tokens),
    whose stored bank is int8 codes + f32 scales."""
    _, (tcfg, tparams, tbanks) = setup
    prompts = _prompts(tcfg.vocab_size, (3, 13, 7, 10, 18), seed=7)
    kw = dict(slots=3, max_len=40, max_new=5, device="cpu")
    base, _ = _run(tserve, tcfg, tparams, tbanks, prompts, **kw)
    chunked, _ = _run(tserve, tcfg, tparams, tbanks, prompts, prefill_chunk=4,
                      **kw)
    assert chunked == base
    paged, eng = _run(tserve, tcfg, tparams, tbanks, prompts, prefill_chunk=4,
                      kv_layout="paged", kv_block=8, decode_burst=4, **kw)
    assert paged == base
    eng.pager.assert_empty()

    q8, e8 = _run(tserve, tcfg, tparams, tbanks, prompts, bank_store="int8",
                  **kw)
    deq = [{tap: {n: tml.dequant_rows(*tml.quant_rows(a))
                  for n, a in leaves.items()} for tap, leaves in b.items()}
           for b in tbanks]
    f32, _ = _run(tserve, tcfg, tparams, deq, prompts, **kw)
    assert q8 == f32
    for leaves in e8.bank.values():
        assert sorted(leaves) == ["A_q", "A_scale", "B_q", "B_scale"]
        assert leaves["A_q"].dtype == leaves["B_q"].dtype == torch.int8
        assert leaves["A_scale"].dtype == torch.float32


def test_paged_engine_admits_prompt_beyond_dense_horizon(setup):
    """With a 40-block pool a paged engine serves a 97-token prompt under a
    max_len=256 virtual horizon, which the dense max_len=64 engine rejects."""
    _, (tcfg, tparams, _) = setup
    prompt = _prompts(tcfg.vocab_size, (97,), seed=8)[0]
    dense = tserve.ServeEngine(tcfg, tparams, slots=4, max_len=64, device="cpu")
    rej = tserve.Request(rid=0, user=0, prompt=prompt, max_new=4)
    dense.submit(rej)
    assert rej.done and "prompt length 97" in rej.status
    eng = tserve.ServeEngine(tcfg, tparams, slots=4, max_len=256,
                             prefill_chunk=8, kv_layout="paged", kv_block=8,
                             kv_blocks=40, device="cpu")
    r = tserve.Request(rid=1, user=0, prompt=prompt, max_new=4)
    eng.submit(r)
    eng.run_until_idle()
    assert r.status == "done" and len(r.out) == 4
    eng.pager.assert_empty()
    assert eng.stats["kv_blocks_peak"] <= eng.pager.blocks_for(97 + 8)


def test_max_prompt_boundary_and_rejection_reason(setup):
    _, (tcfg, tparams, _) = setup
    eng = tserve.ServeEngine(tcfg, tparams, slots=2, max_len=64, max_prompt=20,
                             prefill_chunk=8, kv_layout="paged", device="cpu")
    ok = tserve.Request(rid=0, user=0, prompt=_prompts(tcfg.vocab_size, (20,))[0],
                        max_new=2)
    bad = tserve.Request(rid=1, user=0,
                         prompt=_prompts(tcfg.vocab_size, (21,))[0], max_new=2)
    eng.submit(ok)
    eng.submit(bad)
    assert not ok.done
    assert bad.done and bad.status.startswith("rejected: ")
    assert "prompt length 21 > max_prompt 20" in bad.status
    assert "max_len=64" in bad.status
    eng.run_until_idle()
    assert ok.status == "done"
    assert tserve.ServeEngine(tcfg, tparams, slots=2, max_len=64,
                              device="cpu").max_prompt == 63


def test_queued_request_waits_for_pool_capacity(setup):
    """6 blocks of 8 positions; each request reserves 28 positions (4
    blocks), so the second waits, FIFO, until the first retires."""
    _, (tcfg, tparams, _) = setup
    eng = tserve.ServeEngine(tcfg, tparams, slots=2, max_len=64,
                             prefill_chunk=4, kv_layout="paged", kv_block=8,
                             kv_blocks=6, device="cpu")
    reqs = [tserve.Request(rid=i, user=0, max_new=2,
                           prompt=_prompts(tcfg.vocab_size, (26,), seed=i)[0])
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.tick()
    assert sum(r is not None for r in eng.active) == 1 and len(eng.queue) == 1
    assert eng.stats["kv_reserve_failures"] >= 1
    eng.run_until_idle()
    assert all(r.status == "done" and len(r.out) == 2 for r in reqs)
    assert reqs[0].t_admit < reqs[1].t_admit
    eng.pager.assert_empty()


def test_kv_cache_bytes_affine_in_blocks_in_use(setup):
    """Paged: affine in blocks in use (the block table is the intercept) and
    far below the dense footprint at the same max_len."""
    _, (tcfg, tparams, _) = setup
    eng = tserve.ServeEngine(tcfg, tparams, slots=4, max_len=256,
                             prefill_chunk=8, kv_layout="paged", kv_block=8,
                             kv_blocks=64, device="cpu")
    dense = tserve.ServeEngine(tcfg, tparams, slots=4, max_len=256,
                               device="cpu")
    assert eng.kv_cache_bytes() == eng.pager.table.nbytes
    assert eng.kv_cache_bytes() < dense.kv_cache_bytes() / 100
    per_block = 2 * tcfg.n_layers * 8 * tcfg.n_kv_heads * tcfg.d_head * 4
    r = tserve.Request(rid=0, user=0, max_new=8,
                       prompt=_prompts(tcfg.vocab_size, (33,), seed=3)[0])
    eng.submit(r)
    counts = set()
    while not r.done:
        eng.tick()
        n = eng.stats["kv_blocks_in_use"]
        counts.add(n)
        assert eng.kv_cache_bytes() == eng.pager.table.nbytes + n * per_block
    assert max(counts) == eng.pager.blocks_for(33 + 8 - 1)
    assert eng.kv_cache_bytes() == eng.pager.table.nbytes
    eng.pager.assert_empty()
