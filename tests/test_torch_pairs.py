"""gemma2's local/global pairs plan in the port, against the JAX package on
the reduced f32 gemma2-9b (2 pairs, local window 16) with the same weights
(carried by ``repro_torch.convert``) and numpy inputs from a seed: forward,
loss and prefill; decode steps dense and paged + ring, chunks and ticks,
logits and caches; the ring oracle; the engines' tokens and
``kv_cache_bytes``; embed_scale, (1 + scale) norms and the final softcap;
and the port's own invariants (chunked == unchunked, paged + ring ==
dense). Tolerances are stated per test: f32 sums in another order.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import kv_pager as tpager  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

# f32 through 4 layers (2 pairs), sums in another order than XLA's; the
# K/V of the later layers (values up to ~5) carry that noise through the
# (1 + scale) norms, which double every row, so their floor is 5e-5
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_KV = dict(rtol=1e-4, atol=5e-5)
ENGINE_KW = dict(slots=3, max_len=64, max_new=5)
ENGINES = {"dense": {},
           "paged": dict(prefill_chunk=4, kv_layout="paged", kv_block=8,
                         bank_store="int8")}
PROMPT_LENS = (3, 21, 9, 33, 17)   # two past the local window of 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p in lens]


def _run(lib, cfg, params, banks, prompts, *, max_new, **kw):
    eng = lib.ServeEngine(cfg, params, user_adapters=banks, **kw)
    reqs = [lib.Request(rid=i, user=i % 2, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    seen = []
    while eng.queue or any(r is not None for r in eng.active):
        eng.tick()
        seen.append(eng.kv_cache_bytes())
    assert all(r.status == "done" for r in reqs)
    return [r.out for r in reqs], seen, eng


@pytest.fixture(scope="module")
def setup():
    cfg = registry.reduced_config("gemma2-9b")
    tcfg = tregistry.reduced_config("gemma2-9b")
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    banks = []
    for u in range(2):   # both users' B nonzero (user 0's B is zero at init)
        ad = gl.init_adapters(cfg, cc, jax.random.fold_in(key, 1 + u))
        banks.append(jax.tree.map(lambda a: a + 0.3 * jax.random.normal(
            jax.random.fold_in(key, 10 + u), a.shape), ad))
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    tbanks = [convert.adapters_from_numpy(_np(b), device="cpu") for b in banks]
    return (cfg, params, banks), (tcfg, tparams, tbanks)


@pytest.fixture(scope="module")
def jax_engines(setup):
    """The JAX engine's tokens and kv_cache_bytes after every tick, per
    option set (its compiles dominate this file, so they run once)."""
    (cfg, params, banks), _ = setup
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    return {name: _run(jserve, cfg, params, banks, prompts, **ENGINE_KW,
                       **opts)[:2] for name, opts in ENGINES.items()}


# ---------------------------------------------------------------------------
# structure: configs, parameters, taps
# ---------------------------------------------------------------------------

def test_pairs_pytree_crosses_whole(setup):
    """The JAX pairs pytree (layers_a, layers_b, post_ln*) crosses
    ``convert`` leaf for leaf, and the port's own init has the same
    structure, shapes and dtypes."""
    (cfg, params, _), (tcfg, tparams, _) = setup
    assert set(tparams) == {"embed", "layers_a", "layers_b", "final_norm"}
    assert {"post_ln1", "post_ln2"} <= set(tparams["layers_a"])
    jleaves = jax.tree_util.tree_leaves_with_path(params)
    mine = TM.init(tcfg, seed=0, device="cpu")
    for path, leaf in jleaves:
        keys = [p.key for p in path]
        got, own = tparams, mine
        for k in keys:
            got, own = got[k], own[k]
        assert tuple(got.shape) == leaf.shape == tuple(own.shape), keys
        assert np.array_equal(got.numpy(), np.asarray(leaf)), keys
        assert own.dtype == torch.float32
    assert len(jleaves) == len(tree_leaves(tparams)) == len(tree_leaves(mine))


def test_tap_sites_and_layer_plan_match_jax(setup):
    (cfg, _, _), (tcfg, _, _) = setup
    assert TM.layer_plan(tcfg) == M.layer_plan(cfg) == ("pairs", 2)
    js, ts = M.tap_sites(cfg), TM.tap_sites(tcfg)
    assert list(ts) == list(js)
    for n in js:
        assert (ts[n].d_in, ts[n].d_out, ts[n].stacked) == \
            (js[n].d_in, js[n].d_out, js[n].stacked), n


# ---------------------------------------------------------------------------
# the full sequence
# ---------------------------------------------------------------------------

def test_forward_loss_and_prefill_match_jax(setup):
    """24 tokens (past the local window of 16): logits, the CE loss, and
    prefill's last-position logits and per-stack K/V (TOL, TOL_KV)."""
    (cfg, params, _), (tcfg, tparams, _) = setup
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab_size, (2, 24)).astype(np.int32)
    lg, _ = M.forward(cfg, params, {"tokens": jnp.asarray(toks)})
    tlg, _ = TM.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    batch = {"tokens": toks, "labels": labels}
    loss, _ = M.loss_fn(cfg, params, jax.tree.map(jnp.asarray, batch))
    tloss, _ = TM.loss_fn(tcfg, tparams, _t(batch))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    lengths = np.array([24, 17], np.int32)
    plg, pre = M.prefill(cfg, params, {"tokens": jnp.asarray(toks)},
                         lengths=jnp.asarray(lengths))
    tplg, tpre = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)},
                            lengths=torch.as_tensor(lengths))
    np.testing.assert_allclose(tplg.numpy(), np.asarray(plg), **TOL)
    assert set(tpre) == set(pre) == {"layers_a", "layers_b"}
    for stack in pre:
        for n in ("k", "v"):
            np.testing.assert_allclose(tpre[stack][n].numpy(),
                                       np.asarray(pre[stack][n]), **TOL_KV)


def test_gemma2_flavors_change_output(setup):
    """Port of tests/test_models_smoke.py::test_gemma2_flavors_change_output:
    the softcaps change the logits; so do the post-norms and the local
    window, each on its own."""
    _, (tcfg, tparams, _) = setup
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (1, 32)).astype(np.int32))
    base, _ = TM.forward(tcfg, tparams, {"tokens": toks})
    for over in (dict(attn_softcap=0.0, final_softcap=0.0),
                 dict(local_window=0)):
        other, _ = TM.forward(tcfg.replace(**over), tparams, {"tokens": toks})
        assert not torch.allclose(base, other), over
    no_post = {k: v for k, v in tparams.items()}
    for s in ("layers_a", "layers_b"):
        no_post[s] = {k: v for k, v in tparams[s].items()
                      if not k.startswith("post_")}
    other, _ = TM.forward(tcfg.replace(post_norm=False), no_post,
                          {"tokens": toks})
    assert not torch.allclose(base, other)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_norm_plus_one_and_final_softcap_match_jax(dtype):
    """At gemma2's full width (d_model 3584; a 16-token vocabulary): the
    embedding scale is sqrt(3584) rounded to the compute dtype first (59.75
    in bf16), equal to JAX's bit for bit; the (1 + scale) RMSNorm and the
    final softcap's f32 tanh equal JAX's within one rounding of the dtype."""
    cfg = registry.get_config("gemma2-9b").replace(
        vocab_size=16, compute_dtype=dtype, param_dtype=dtype)
    tcfg = tregistry.get_config("gemma2-9b").replace(
        vocab_size=16, compute_dtype=dtype, param_dtype=dtype)
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(16, 3584)).astype(np.float32)
    jp = {"embed": {"emb": jnp.asarray(emb, dtype)}}
    tp = convert.params_from_numpy(tcfg, {"embed": {"emb": emb}}, device="cpu")
    toks = rng.integers(0, 16, (2, 5)).astype(np.int32)
    x = M.embed_tokens(cfg, jp, {"tokens": jnp.asarray(toks)})
    tx = TM.embed_tokens(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    assert np.array_equal(tx.float().numpy(), np.asarray(x, np.float32))
    ones = TM.embed_tokens(tcfg, {"embed": {"emb": torch.ones(
        16, 3584, dtype=tx.dtype)}}, {"tokens": torch.zeros(1, 1, dtype=torch.int32)})
    assert float(ones[0, 0, 0]) == (59.75 if dtype == "bfloat16"
                                    else float(np.float32(3584 ** 0.5)))
    # (1 + scale) norm
    scale = rng.normal(size=(3584,)).astype(np.float32)
    y = JL.rmsnorm({"scale": jnp.asarray(scale, dtype)}, x, eps=cfg.norm_eps,
                   plus_one=True)
    ty = TL.rmsnorm({"scale": torch.as_tensor(scale).to(tx.dtype)}, tx,
                    eps=tcfg.norm_eps, plus_one=True)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(y, np.float32),
                               rtol=ulp, atol=ulp)
    # the final softcap on the tied head
    lg = M.head_logits(cfg, jp, y)
    tlg = TM.head_logits(tcfg, tp, ty)
    assert tlg.dtype == tx.dtype
    assert float(tlg.float().abs().max()) <= 30.0
    np.testing.assert_allclose(tlg.float().numpy(), np.asarray(lg, np.float32),
                               rtol=2 * ulp, atol=30 * 2 * ulp)


# ---------------------------------------------------------------------------
# decode steps: dense, and paged + ring
# ---------------------------------------------------------------------------

def _steps(setup, cache, tcache, steps, **layout):
    (cfg, params, _), (tcfg, tparams, _) = setup
    for toks, pos, live in steps:
        batch = {"tokens": toks, "positions": pos}
        lg, cache = M.decode_step(cfg, params, jax.tree.map(jnp.asarray, batch),
                                  cache, live=jnp.asarray(live),
                                  **{k: jnp.asarray(v) for k, v in layout.items()})
        tlg, tcache = TM.decode_step(tcfg, tparams, _t(batch), tcache,
                                     live=torch.as_tensor(live),
                                     **{k: torch.as_tensor(v)
                                        for k, v in layout.items()})
        np.testing.assert_allclose(tlg.numpy()[live], np.asarray(lg)[live], **TOL)
        for stack in cache:
            for n in ("k", "v"):
                np.testing.assert_allclose(tcache[stack][n].numpy(),
                                           np.asarray(cache[stack][n]), **TOL_KV)
    return tcache


def _step_inputs(vocab, rng, rows):
    """(tokens (3, c), positions, live) per step: row 2 dead."""
    live = np.array([True, True, False])
    return [(rng.integers(0, vocab, (3, c)).astype(np.int32),
             np.array(pos, np.int32), live) for c, pos in rows]


def test_decode_step_dense_matches_jax(setup):
    """A prefilled dense cache of both stacks, then a 4-token chunk and two
    ticks past the local window: logits and both stacks' caches; the dead
    row's rows untouched."""
    (cfg, params, _), (tcfg, tparams, _) = setup
    rng = np.random.default_rng(3)
    slots, max_len = 3, 32
    toks = rng.integers(0, cfg.vocab_size, (2, 18)).astype(np.int32)
    ids = np.array([0, 1], np.int32)
    _, pre = M.prefill(cfg, params, {"tokens": jnp.asarray(toks)})
    cache = M.scatter_prefill_cache(M.init_cache(cfg, slots, max_len), pre,
                                    jnp.asarray(ids))
    _, tpre = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    tcache = TM.scatter_prefill_cache(
        TM.init_cache(tcfg, slots, max_len, device="cpu"), tpre, ids)
    before = {s: {n: t.clone() for n, t in e.items()} for s, e in tcache.items()}
    steps = _step_inputs(cfg.vocab_size, rng, [(4, [18, 9, 3]), (1, [22, 13, 5]),
                                               (1, [23, 14, 5])])
    tcache = _steps(setup, cache, tcache, steps)
    for s in tcache:
        for n in ("k", "v"):
            assert torch.equal(tcache[s][n][:, 2], before[s][n][:, 2])


def test_decode_step_paged_ring_matches_jax(setup):
    """The pool stack through a shuffled block table and the local stack's
    rings of local_window + 4 - 1 = 19 positions, random contents: a chunk
    that wraps row 0's ring, then ticks; logits, the pool and the rings
    equal JAX's; the dead row's ring and blocks no live row owns are
    intact."""
    (cfg, params, _), (tcfg, tparams, _) = setup
    rng = np.random.default_rng(4)
    slots, max_len, bs, n_blocks, C = 3, 48, 8, 16, 4
    ring_len = cfg.local_window + C - 1
    table = np.zeros((slots, max_len // bs), np.int32)
    perm = rng.permutation(n_blocks)
    table[0] = perm[:6]
    table[1, :3] = perm[6:9]
    table[2, :2] = perm[9:11]
    half, K, D = cfg.n_layers // 2, cfg.n_kv_heads, cfg.d_head
    leaves = {"layers_a": (half, slots, ring_len, K, D),
              "layers_b": (half, n_blocks, bs, K, D)}
    init = {s: {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
            for s, shape in leaves.items()}
    cache = jax.tree.map(jnp.asarray, init)
    tcache = {s: {n: torch.tensor(a) for n, a in e.items()} for s, e in init.items()}
    steps = _step_inputs(cfg.vocab_size, rng, [(4, [30, 6, 3]), (1, [34, 10, 7]),
                                               (1, [35, 11, 7])])
    tcache = _steps(setup, cache, tcache, steps, block_table=table)
    for n in ("k", "v"):
        assert np.array_equal(tcache["layers_a"][n][:, 2].numpy(),
                              init["layers_a"][n][:, 2])
        written = set(table[0, 3:5]) | set(table[1, :2])
        for blk in range(n_blocks):
            if blk not in written:
                assert np.array_equal(tcache["layers_b"][n][:, blk].numpy(),
                                      init["layers_b"][n][:, blk]), blk


@pytest.mark.parametrize("sq,positions", [
    (1, [3, 40, 18]),        # not wrapped, wrapped, just wrapped (P = W - 1)
    (4, [0, 37, 15]),
])
def test_ring_oracle_matches_jax(sq, positions):
    """ref.sdpa_decode_ring against JAX's (window 16, softcap 30, W_ring
    19, 2 kv heads, G = 2, one dead row): within 1e-5 (f32), zeros for the
    dead row."""
    rng = np.random.default_rng(sq)
    B, W, K, G, D = 3, 19, 2, 2, 32
    q = rng.normal(size=(B, sq, K * G, D)).astype(np.float32)
    k = rng.normal(size=(B, W, K, D)).astype(np.float32)
    v = rng.normal(size=(B, W, K, D)).astype(np.float32)
    pos = np.array(positions, np.int32)
    live = np.array([True, True, False])
    kw = dict(window=16, softcap=30.0)
    want = jref.sdpa_decode_ring(*(jnp.asarray(a) for a in (q, k, v, pos)),
                                 live=jnp.asarray(live), **kw)
    got = tref.sdpa_decode_ring(*(torch.as_tensor(a) for a in (q, k, v, pos)),
                                live=torch.as_tensor(live), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.numpy()[2] == 0)


# ---------------------------------------------------------------------------
# engines against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_matches_jax(setup, jax_engines, name):
    """Five requests (two prompts past the local window), three slots:
    greedy tokens equal the JAX engine's, and ``kv_cache_bytes`` equals
    JAX's after every tick (paged: the pool per block in use, the rings in
    full)."""
    (cfg, _, _), (tcfg, tparams, tbanks) = setup
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    got, seen, eng = _run(tserve, tcfg, tparams, tbanks, prompts, device="cpu",
                          **ENGINE_KW, **ENGINES[name])
    want, jseen = jax_engines[name]
    assert got == want
    assert seen == jseen
    if eng.pager is not None:
        eng.pager.assert_empty()
        assert eng.cache["layers_a"]["k"].shape[2] == cfg.local_window + 4 - 1
        assert eng.pager.n_blocks == eng.cache["layers_b"]["k"].shape[1]


# ---------------------------------------------------------------------------
# the port's own invariants: JAX's plan-sweep case for gemma2
# ---------------------------------------------------------------------------

def _chunk_run(tcfg, tparams, prompt, cache, *, C, slot, slots, pager=None):
    """decode_step chunk by chunk as the engine drives it (padded width-C
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
        lg, cache = TM.decode_step(tcfg, tparams, _t({"tokens": toks,
                                                      "positions": pos}),
                                   cache, live=torch.as_tensor(live), **kw)
        last = lg[slot, c - 1]
        consumed += c
    return last


def test_chunked_matches_prefill_and_ring_matches_dense():
    """tests/test_paged_kv.py's gemma2 case (C 4, P 13, local window 6) in
    the port: chunked logits within 1e-5 of the full prefill's (JAX's own
    differ in the last bit), paged + ring within 1e-5 of dense chunked;
    equal argmax throughout."""
    tcfg = tregistry.reduced_config("gemma2-9b").replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=128, local_window=6)
    tparams = TM.init(tcfg, seed=0, device="cpu")
    C, P, slots, max_len, s = 4, 13, 3, 32, 1
    prompt = _prompts(tcfg.vocab_size, (P,), seed=1)[0]
    full, _ = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(prompt[None])})
    full = full[0, 0]
    dense = _chunk_run(tcfg, tparams, prompt,
                       TM.init_cache(tcfg, slots, max_len, device="cpu"),
                       C=C, slot=s, slots=slots)
    np.testing.assert_allclose(dense.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(dense.argmax()) == int(full.argmax())
    pager = tpager.BlockPager(n_blocks=16, block_size=8, slots=slots,
                              max_len=max_len)
    assert pager.reserve(s, P)
    cache_p = TM.init_cache(tcfg, slots, max_len, kv_layout="paged",
                            kv_blocks=16, kv_block=8,
                            ring_len=tcfg.local_window + C - 1, device="cpu")
    assert cache_p["layers_a"]["k"].shape[2] == 9
    paged = _chunk_run(tcfg, tparams, prompt, cache_p, C=C, slot=s,
                       slots=slots, pager=pager)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(paged.argmax()) == int(dense.argmax())


# ---------------------------------------------------------------------------
# the store, the hot-swap and telemetry under the pairs plan's tap names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [{}, ENGINES["paged"]], ids=["dense", "paged"])
def test_store_hot_swap_and_telemetry_take_the_pairs_taps(setup, opts):
    """The adapter store (2 resident rows for 2 users), ``install_adapters``
    and telemetry run unchanged on the layers_a.* / layers_b.* taps: the
    store engine's tokens equal the all-resident engine's, telemetry on
    gives the same tokens, and a hot-swapped user serves the new bank
    (its tokens equal a one-user engine's on it)."""
    from repro_torch.telemetry import Telemetry
    _, (tcfg, tparams, tbanks) = setup
    prompts = _prompts(tcfg.vocab_size, PROMPT_LENS, seed=6)
    kw = dict(device="cpu", **ENGINE_KW, **opts)
    base, _, _ = _run(tserve, tcfg, tparams, tbanks, prompts, **kw)
    store, _, eng = _run(tserve, tcfg, tparams, tbanks, prompts,
                         resident_slots=1, **kw)
    assert store == base and eng.store.metrics()["evictions"] > 0
    tm = Telemetry(trace=True)
    traced, _, teng = _run(tserve, tcfg, tparams, tbanks, prompts,
                           telemetry=tm, **kw)
    assert traced == base
    assert teng.telemetry_snapshot()["serve.completed"] == len(prompts)
    assert sorted(eng.store.bank) == sorted(tbanks[0]) == [
        "layers_a.attn.q", "layers_a.attn.v", "layers_b.attn.q",
        "layers_b.attn.v"]
    new = {t: {n: a * 1.5 for n, a in e.items()} for t, e in tbanks[1].items()}
    for e in (teng, eng):
        assert e.install_adapters(1, new, version=1)
        assert not e.install_adapters(1, new, version=1)   # stale
    solo, _, _ = _run(tserve, tcfg, tparams, [new, new], prompts, **kw)
    again = []
    for e in (teng, eng):
        reqs = [tserve.Request(rid=i, user=1, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        e.run_until_idle()
        again.append([r.out for r in reqs])
    assert again[0] == again[1] == solo
