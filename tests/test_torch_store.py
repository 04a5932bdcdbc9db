"""The port's tiered adapter store and the engine's adapter hot-swap against
the JAX package's, on JAX's tiny config (2 layers, d_model 64, rank 4): the
same banks (carried by ``repro_torch.convert``), the same requests, equal
greedy tokens and equal store counters (the LRU is deterministic, so hits,
misses, evictions, fetches and splits must agree on one request sequence),
equal cluster maps; and the port's own invariants: R resident rows ==
all resident (f32 and int8) under eviction churn, burst == tick, reference
prefill == batched, chunked + paged + store == dense + store.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.core.merge import merge_adapter_pytrees as jmerge  # noqa: E402
from repro.kernels import multi_lora as jml  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.runtime import adapter_store as jstore  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core.merge import merge_adapter_pytrees as tmerge  # noqa: E402
from repro_torch.kernels import multi_lora as tml  # noqa: E402
from repro_torch.runtime import adapter_store as tstore  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

COUNTERS = ("hits", "misses", "evictions", "fetches", "splits", "registered",
            "installs")
_CC = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
_CC8 = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=8)


@pytest.fixture(scope="module")
def tiny():
    over = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                d_ff=128, vocab_size=128)
    cfg = registry.reduced_config("smollm-135m").replace(**over)
    tcfg = tregistry.reduced_config("smollm-135m").replace(**over)
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                        device="cpu")
    return types.SimpleNamespace(cfg=cfg, tcfg=tcfg, params=params,
                                 tparams=tparams, key=key)


def _bank(cfg, key, seed, jitter=0.1):
    ad = gl.init_adapters(cfg, _CC, jax.random.fold_in(key, seed))
    return jax.tree.map(lambda a: a + jitter * jax.random.normal(
        jax.random.fold_in(key, 1000 + seed), a.shape), ad)


def _banks(t, n):
    return [_bank(t.cfg, t.key, u) for u in range(n)]


def _t(tree):
    """A JAX adapter tree -> the port's (CPU tensors)."""
    return convert.adapters_from_numpy(jax.tree.map(np.asarray, tree),
                                       device="cpu")


def _prompts(t, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, t.cfg.vocab_size, size=p).astype(np.int32)
            for p in lens]


def _serve(lib, eng, prompts, users, max_new=5):
    reqs = [lib.Request(rid=i, user=u, prompt=p, max_new=max_new)
            for i, (u, p) in enumerate(zip(users, prompts))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [r.out for r in reqs]


def _engines(t, banks, **kw):
    """The JAX engine and the port's (on the CPU) on the same banks."""
    return (jserve.ServeEngine(t.cfg, t.params, user_adapters=banks, **kw),
            tserve.ServeEngine(t.tcfg, t.tparams,
                               user_adapters=[_t(b) for b in banks],
                               device="cpu", **kw))


def _both(t, banks, prompts, users, *, max_new=5, **kw):
    """Serve one request list through both engines; their tokens must be
    equal, and so must their stores' counters. Returns (tokens, port
    engine)."""
    je, te = _engines(t, banks, **kw)
    want = _serve(jserve, je, prompts, users, max_new)
    got = _serve(tserve, te, prompts, users, max_new)
    assert got == want
    if te.store is not None:
        assert _counters(te.store) == _counters(je.store)
    return got, te


def _counters(st):
    return {k: st.counters[k] for k in COUNTERS}


def _stores(t, n, **kw):
    banks = _banks(t, n)
    return (jstore.AdapterStore.from_users(banks, **kw),
            tstore.AdapterStore.from_users([_t(b) for b in banks],
                                           device="cpu", **kw))


# ---------------------------------------------------------------------------
# stack_user_adapters input validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["empty", "mismatched"])
def test_stack_user_adapters_rejects_bad_input(tiny, case):
    if case == "empty":
        with pytest.raises(ValueError, match="empty list"):
            tserve.stack_user_adapters([])
        return
    a1 = gl.init_adapters(tiny.cfg, _CC8, tiny.key)   # rank 8: other shapes
    with pytest.raises(ValueError, match="user 1 adapter structure"):
        tserve.stack_user_adapters([_t(_bank(tiny.cfg, tiny.key, 0)), _t(a1)])


# ---------------------------------------------------------------------------
# the store alone, step by step against JAX's
# ---------------------------------------------------------------------------

def test_store_lru_eviction_order_and_counters(tiny):
    stores = _stores(tiny, 4, resident=2)
    st = stores[1]
    for users in ([0], [0], [1], [2], [1, 3], [0, 2, 0], [3]):
        rows = [s.ensure_resident(users).tolist() for s in stores]
        assert rows[0] == rows[1], users
        assert ([stores[0].resident_index(u) for u in range(4)]
                == [st.resident_index(u) for u in range(4)]), users
        assert _counters(stores[0]) == _counters(st), users
        if users == [2]:   # 0 was least recently used: 2 evicted 0, not 1
            assert st.resident_index(0) is None
            assert st.resident_index(1) is not None
    assert st.counters["evictions"] == 5 and st.counters["hits"] == 3
    m = st.metrics()
    assert m["resident_users"] == 2 and m["host_users"] == 4
    assert 0.0 < m["hit_rate"] < 1.0
    assert m["fetch_time"] > 0.0


def test_store_resident_bytes_bounded_by_R(tiny):
    banks = _banks(tiny, 16)
    dense = tserve.stack_user_adapters([_t(b) for b in banks])
    dense_bytes = sum(l.numel() * l.element_size()
                      for e in dense.values() for l in e.values())
    for store in ("f32", "int8"):
        j, p = _stores(tiny, 16, resident=2, store=store)
        assert p.resident_bytes() == j.resident_bytes()
        assert p.host_bytes() == j.host_bytes()
        if store == "f32":
            assert p.resident_bytes() == dense_bytes * 2 // 16
        else:
            assert p.resident_bytes() < dense_bytes * 2 // 16
        # every bank leaf is contiguous and R rows along the user axis
        for e in p.bank.values():
            for leaf in e.values():
                assert leaf.is_contiguous() and leaf.shape[1] == 2


def test_store_pinned_rows_never_evicted(tiny):
    stores = _stores(tiny, 5, resident=2)
    # (op, user, what the port's store must return); a second pin fills
    # both rows, so a third distinct user is refused until one is released;
    # pins are counted, so two acquires need two releases
    ops = [("acquire", 0, True), ("ensure", 0, None), ("ensure", 1, None),
           ("ensure", 2, None), ("ensure", 3, None), ("ensure", 4, None),
           ("acquire", 1, True), ("acquire", 2, False), ("release", 0, None),
           ("acquire", 2, True), ("acquire", 2, True), ("pinned", None, 2),
           ("release", 2, None), ("pinned", None, 2), ("release", 2, None),
           ("pinned", None, 1)]
    row0 = None
    for op, u, want in ops:
        out = []
        for st in stores:
            if op == "ensure":
                out.append(int(st.ensure_resident([u])[0]))
            elif op == "pinned":
                out.append(st.pinned_count())
            else:
                out.append(getattr(st, op)(u))
        assert out[0] == out[1], (op, u)
        if want is not None:
            assert out[1] == want, (op, u)
        if op == "ensure" and u == 0:
            row0 = out[1]
        elif op == "ensure":   # user 0's row survives every eviction
            assert stores[1].resident_index(0) == row0


def test_store_all_rows_pinned_raises_on_fetch(tiny):
    _, st = _stores(tiny, 3, resident=1)
    assert st.acquire(0)
    st.ensure_resident([0])
    with pytest.raises(RuntimeError, match="pinned"):
        st._fetch(("user", 1))


@pytest.mark.parametrize("bad", ["structure", "resident", "store",
                                 "telemetry"])
def test_store_rejects_bad_arguments(tiny, bad):
    if bad == "structure":
        _, st = _stores(tiny, 2, resident=2)
        with pytest.raises(ValueError, match="store\\s+template"):
            st.register(7, _t(gl.init_adapters(tiny.cfg, _CC8, tiny.key)))
        assert not st.knows(7)
    elif bad == "resident":
        with pytest.raises(ValueError, match=">= 1"):
            tstore.AdapterStore(0, device="cpu")
    elif bad == "store":
        with pytest.raises(ValueError, match="store="):
            tstore.AdapterStore(2, store="f16", device="cpu")
    else:   # a Telemetry is taken (no longer refused): the same rows
        from repro_torch.telemetry import Telemetry
        tm = Telemetry()
        rows = []
        for telemetry in (None, tm):
            st = tstore.AdapterStore.from_users(
                [_t(b) for b in _banks(tiny, 3)], resident=2,
                telemetry=telemetry, device="cpu")
            rows.append([st.ensure_resident(u).tolist()
                         for u in ([0], [1, 0], [2], [1])])
        assert rows[0] == rows[1]
        assert tm.snapshot()["store.fetch_s"]["count"] == st.counters["fetches"]


# ---------------------------------------------------------------------------
# the engine: R << U serving against JAX's and against all-resident
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bank_store", ["f32", "int8"])
def test_store_serving_under_churn_matches_jax_and_all_resident(tiny,
                                                                bank_store):
    """U = 12 users through R = 4 resident rows and 3 slots: users repeat,
    rows are evicted mid-flight; tokens equal JAX's store engine (with equal
    counters) and the port's all-resident engine, and the resident bank's
    bytes scale with R, not U."""
    banks = _banks(tiny, 12)
    prompts = _prompts(tiny, [5 + (i % 7) for i in range(24)])
    users = [(5 * i) % 12 for i in range(24)]
    kw = dict(slots=3, max_len=64, bank_store=bank_store)
    got, te = _both(tiny, banks, prompts, users, resident_slots=4, **kw)
    full = tserve.ServeEngine(tiny.tcfg, tiny.tparams, device="cpu",
                              user_adapters=[_t(b) for b in banks], **kw)
    assert _serve(tserve, full, prompts, users) == got
    st = te.stats
    assert st["store_evictions"] > 0 and st["store_misses"] > 0
    assert st["store_fetch_time"] > 0.0
    full_bytes = sum(l.numel() * l.element_size()
                     for e in full.bank.values() for l in e.values())
    assert st["store_resident_bytes"] == full_bytes * 4 // 12
    assert st["store_pinned"] == 0
    tp = te.throughput()["store"]
    assert tp["hit_rate"] >= 0.0 and tp["evictions"] == st["store_evictions"]


def test_store_admission_waits_when_all_rows_pinned(tiny):
    """R == slots and every request a distinct user: admission stalls (never
    evicting a live user's row) and still drains the queue."""
    banks = _banks(tiny, 6)
    prompts = _prompts(tiny, [6] * 6)
    outs, te = _both(tiny, banks, prompts, list(range(6)), max_new=4,
                     slots=2, max_len=64, resident_slots=2)
    assert te.stats["completed"] == 6 and all(len(o) == 4 for o in outs)
    ref = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=2, max_len=64,
                             user_adapters=[_t(b) for b in banks],
                             device="cpu")
    assert outs == _serve(tserve, ref, prompts, list(range(6)), max_new=4)


def test_store_reference_prefill_mode_matches_batched(tiny):
    banks = _banks(tiny, 8)
    prompts = _prompts(tiny, (1, 5, 9, 13))
    outs = {mode: _both(tiny, banks, prompts, [1, 7, 3, 1], slots=2,
                        max_len=64, resident_slots=3, prefill_mode=mode)[0]
            for mode in ("batched", "reference")}
    assert outs["batched"] == outs["reference"]


def test_store_burst_decode_matches_tick_at_a_time(tiny):
    banks = _banks(tiny, 8)
    prompts = _prompts(tiny, (5, 9, 13))
    kw = dict(slots=3, max_len=64, resident_slots=4, max_new=17)
    one, _ = _both(tiny, banks, prompts, [0, 5, 0], **kw)
    kw.pop("max_new")
    eng8 = tserve.ServeEngine(tiny.tcfg, tiny.tparams, device="cpu",
                              user_adapters=[_t(b) for b in banks],
                              decode_burst=8, **kw)
    assert _serve(tserve, eng8, prompts, [0, 5, 0], max_new=17) == one
    assert eng8.stats["ticks"] < 17 * 3


@pytest.mark.parametrize("bank_store", ["f32", "int8"])
def test_store_chunked_paged_matches_dense(tiny, bank_store):
    """chunked + paged + store == dense + store (port), both equal to JAX's
    chunked + paged + store engine, R < slots so admission also waits (and
    its block reservation is rolled back); the pool is whole at the end."""
    banks = _banks(tiny, 6)
    prompts = _prompts(tiny, [3 + 5 * (i % 4) for i in range(10)], seed=3)
    users = [(5 * i) % 6 for i in range(10)]
    kw = dict(slots=3, max_len=64, resident_slots=2, bank_store=bank_store)
    paged, te = _both(tiny, banks, prompts, users, prefill_chunk=4,
                      kv_layout="paged", kv_block=4, **kw)
    dense = tserve.ServeEngine(tiny.tcfg, tiny.tparams, device="cpu",
                               user_adapters=[_t(b) for b in banks], **kw)
    assert _serve(tserve, dense, prompts, users) == paged
    assert te.stats["store_evictions"] > 0 and te.stats["store_pinned"] == 0
    te.pager.assert_empty()


def test_store_refusal_rolls_back_the_block_reservation(tiny):
    """When ``acquire`` refuses (R distinct users pinned), the block
    reservation admission just made is released: after every tick no idle
    slot holds a reservation, though admission waited."""
    banks = _banks(tiny, 4)
    eng = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=3, max_len=32,
                             user_adapters=[_t(b) for b in banks],
                             resident_slots=2, prefill_chunk=4,
                             kv_layout="paged", kv_block=4, device="cpu")
    for i, p in enumerate(_prompts(tiny, (6, 9, 5, 7), seed=5)):
        eng.submit(tserve.Request(i, i, p, max_new=4))
    waited = False
    while eng.queue or any(r is not None for r in eng.active):
        eng.tick()
        idle = [i for i, r in enumerate(eng.active) if r is None]
        waited |= bool(eng.queue) and bool(idle)
        assert all(eng.pager._reserved[i] == 0 for i in idle)
    assert waited and eng.stats["completed"] == 4
    eng.pager.assert_empty()


def test_corrupted_resident_row_raises_before_the_device_call(tiny):
    banks = _banks(tiny, 3)
    eng = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=2, max_len=32,
                             user_adapters=[_t(b) for b in banks],
                             resident_slots=2, device="cpu")
    eng.submit(tserve.Request(0, 1, np.arange(4, dtype=np.int32), max_new=8))
    eng.tick()
    assert eng.active[0] is not None
    eng.res_idx[0] = 2          # a row past the 2-row bank
    with pytest.raises(RuntimeError, match="slot 0"):
        eng.tick()
    eng.res_idx[0] = -1
    with pytest.raises(RuntimeError, match="slot 0"):
        eng.tick()


# ---------------------------------------------------------------------------
# task-similarity clustering and copy-on-write splits
# ---------------------------------------------------------------------------

def _clustered_banks(t):
    base = jax.tree.map(lambda a: a + 0.2, _bank(t.cfg, t.key, 0, jitter=0.0))
    return base, [base,                                  # users 0, 1: one task
                  jax.tree.map(lambda a: a * 1.01, base),
                  _bank(t.cfg, t.key, 2, jitter=0.3),    # users 2, 3 distinct
                  _bank(t.cfg, t.key, 3, jitter=0.4)]


_CLUSTER = dict(slots=2, max_len=64, resident_slots=3, cluster_threshold=0.95)


@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["shared", "merged"])
def test_cluster_maps_match_jax(tiny, mode, store):
    _, banks = _clustered_banks(tiny)
    banks = banks + [_bank(tiny.cfg, tiny.key, 9, jitter=0.0),   # B == 0
                     jax.tree.map(jnp.zeros_like, banks[2])]     # all zero
    j, p = (lib.AdapterStore.from_users(b, resident=3, store=store, **kw)
            for lib, b, kw in ((jstore, banks, {}),
                               (tstore, [_t(b) for b in banks],
                                dict(device="cpu"))))
    for threshold in (0.95, 0.5, -1.0):
        want = j.build_clusters(threshold, mode=mode)
        got = p.build_clusters(threshold, mode=mode)
        assert got == want, threshold
        assert ([p.cluster_of(u) for u in p.users()]
                == [j.cluster_of(u) for u in j.users()])
    for key, entry in p._host.items():   # merged entries: JAX's values
        for tap, leaves in entry.items():
            for name, leaf in leaves.items():
                np.testing.assert_allclose(
                    leaf.numpy(), np.asarray(j._host[key][tap][name]),
                    rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["shared", "merged"])
def test_clustering_maps_similar_users_to_one_row(tiny, mode):
    _, banks = _clustered_banks(tiny)
    p = _prompts(tiny, (7,))[0]
    outs, te = _both(tiny, banks, [p, p], [0, 1], cluster_mode=mode,
                     **_CLUSTER)
    st = te.store
    cid = st.cluster_of(0)
    assert cid is not None and st.cluster_of(1) == cid
    assert st.cluster_of(2) is None and st.cluster_of(3) is None
    assert outs[0] == outs[1]
    assert st.resident_index(0) == st.resident_index(1)
    assert te.stats["store_hits"] >= 1   # the second member's touch is a hit


def test_cow_split_does_not_perturb_cluster_members(tiny):
    base, banks = _clustered_banks(tiny)
    je, te = _engines(tiny, banks, **_CLUSTER)
    prompts = _prompts(tiny, (7,))
    new = jax.tree.map(lambda a: a - 0.3, base)
    outs = {}
    for lib, eng, adapters in ((jserve, je, new), (tserve, te, _t(new))):
        before = [_serve(lib, eng, prompts, [u])[0] for u in (0, 1)]
        assert eng.install_adapters(1, adapters, version=1)
        after = [_serve(lib, eng, prompts, [u])[0] for u in (0, 1)]
        outs[lib] = before + after
    assert outs[tserve] == outs[jserve]
    before0, before1, after0, after1 = outs[tserve]
    st = te.store
    assert before0 == before1
    assert st.cluster_of(1) is None and st.cluster_of(0) is not None
    assert _counters(st) == _counters(je.store) and st.counters["splits"] == 1
    assert after0 == before0, "cluster member perturbed by a peer's split"
    assert after1 != before1, "split user still serving the cluster adapter"
    solo = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=1, max_len=64,
                              user_adapters=[_t(new)], device="cpu")
    assert after1 == _serve(tserve, solo, prompts, [0])[0]


def test_cow_split_repoints_live_slots(tiny):
    """An install during a member's live request re-points its slot at the
    user's new row, as JAX's engine does; tokens and counters equal JAX's."""
    base, banks = _clustered_banks(tiny)
    new = jax.tree.map(lambda a: a - 0.3, base)
    prompts = _prompts(tiny, (7, 7))
    outs = {}
    for lib, eng, adapters in zip((jserve, tserve), _engines(tiny, banks,
                                                            **_CLUSTER),
                                  (new, _t(new))):
        reqs = [lib.Request(rid=i, user=u, prompt=p, max_new=8)
                for i, (u, p) in enumerate(zip((0, 1), prompts))]
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.tick()
        assert eng.install_adapters(1, adapters, version=1)
        assert eng.res_idx[1] == eng.store.resident_index(1)
        assert eng.res_idx[0] != eng.res_idx[1]
        eng.run_until_idle()
        outs[lib] = ([r.out for r in reqs], _counters(eng.store))
    assert outs[tserve] == outs[jserve]


def test_merged_cluster_serves_member_mean(tiny):
    _, banks = _clustered_banks(tiny)
    prompts = _prompts(tiny, (7,))
    got, _ = _both(tiny, banks, prompts, [0], cluster_mode="merged",
                   **_CLUSTER)
    merged = tmerge([_t(banks[0]), _t(banks[1])])
    solo = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=1, max_len=64,
                              user_adapters=[merged], device="cpu")
    assert got[0] == _serve(tserve, solo, prompts, [0])[0]
    jmerged = jmerge([banks[0], banks[1]])
    for tap, leaves in merged.items():
        for name, leaf in leaves.items():
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(jmerged[tap][name]),
                                       rtol=1e-6, atol=1e-7)


def test_merge_adapter_pytrees_units():
    a = {"t": {"A": torch.full((2, 2), 1.0)}}
    b = {"t": {"A": torch.full((2, 2), 3.0)}}
    assert torch.equal(tmerge([a, b])["t"]["A"], torch.full((2, 2), 2.0))
    w = tmerge([a, b], weights=[0.75, 0.25])
    assert torch.equal(w["t"]["A"], torch.full((2, 2), 1.5))
    with pytest.raises(ValueError, match="at least one"):
        tmerge([])
    with pytest.raises(ValueError, match="structures differ"):
        tmerge([a, {"t": {"B": torch.zeros(2, 2)}}])
    with pytest.raises(ValueError, match="shapes differ"):
        tmerge([a, {"t": {"A": torch.zeros(2, 3)}}])


@pytest.mark.parametrize("a,b", [
    ([0, 0, 0], [0, 0, 0]),          # both zero: alike (1.0)
    ([0, 0, 0], [1, 1, 1]),          # one zero: unlike (0.0)
    ([1, 2, 3], [0, 0, 0]),
    ([1, 1, 1], [1, 1, 1]),
    ([1, 2, 3], [-1, -2, -3]),
    ([1, 0, 0], [0, 1, 0]),
    ([1e-30, 0, 0], [1, 1e-8, 0]),
    ([0.3, -0.7, 2.5], [0.31, -0.69, 2.45]),
])
def test_cosine_matches_jax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert tstore._cosine(a, b) == jstore._cosine(a, b)


def test_dequant_rows_roundtrip_matches_jax():
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    q, s = tml.quant_rows(torch.as_tensor(x))
    jq, js = jml.quant_rows(jnp.asarray(x))
    back = tml.dequant_rows(q, s)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jml.dequant_rows(jq, js)))
    np.testing.assert_allclose(back.numpy(), x, atol=float(s.max()) + 1e-6)


# ---------------------------------------------------------------------------
# install_adapters / publish_banks
# ---------------------------------------------------------------------------

def _channel(user, version, adapters):
    return types.SimpleNamespace(user=user, version=version, adapters=adapters)


@pytest.mark.parametrize("bank_store", ["f32", "int8"])
def test_publish_banks_dense_bank_matches_jax(tiny, bank_store):
    """Without a store: users outside the dense bank are skipped and counted;
    an installed bank is written in place and serves JAX's tokens."""
    banks = _banks(tiny, 2)
    good = jax.tree.map(lambda a: a + 0.1, banks[0])
    je, te = _engines(tiny, banks, slots=2, max_len=32, bank_store=bank_store)
    prompts = _prompts(tiny, (6, 9))
    for lib, eng, g in ((jserve, je, good), (tserve, te, _t(good))):
        chans = [_channel(5, 3, g), _channel(-1, 3, g), _channel(1, 3, g)]
        assert lib.publish_banks(eng, chans) == 1
        assert eng.stats["bank_unknown_user"] == 2
        assert eng.stats["bank_installs"] == 1
        assert eng.bank_versions.tolist() == [0, 3]
        assert lib.publish_banks(eng, chans[2:]) == 0      # a replay
    assert (_serve(tserve, te, prompts, [1, 0])
            == _serve(jserve, je, prompts, [1, 0]))
    for e in te.bank.values():
        assert all(leaf.is_contiguous() for leaf in e.values())


def test_dense_install_rejects_bad_banks(tiny):
    banks = _banks(tiny, 2)
    eng = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=2, max_len=32,
                             user_adapters=[_t(b) for b in banks],
                             device="cpu")
    before = {t: {n: l.clone() for n, l in e.items()}
              for t, e in eng.bank.items()}
    bad = [(0, jax.tree.map(lambda a: a * np.nan, banks[0]), 1),   # NaN
           (0, banks[1], 0),                                        # stale
           (2, banks[1], 1),                                        # no user
           (0, gl.init_adapters(tiny.cfg, _CC8, tiny.key), 1),     # rank 8
           (0, {"layers.attn.q": banks[1]["layers.attn.q"]}, 1)]   # one tap
    for user, adapters, version in bad:
        assert not eng.install_adapters(user, _t(adapters), version)
    assert eng.stats["bank_rejected"] == len(bad)
    assert eng.bank_versions.tolist() == [0, 0]
    for t, e in eng.bank.items():
        assert all(torch.equal(l, before[t][n]) for n, l in e.items())


def test_publish_banks_registers_unknown_users_into_store(tiny):
    banks = _banks(tiny, 2)
    je, te = _engines(tiny, banks, slots=2, max_len=64, resident_slots=2)
    newcomer = _bank(tiny.cfg, tiny.key, 7)
    prompts = _prompts(tiny, (6,))
    outs = {}
    for lib, eng, n in ((jserve, je, newcomer), (tserve, te, _t(newcomer))):
        r = lib.Request(rid=0, user=7, prompt=np.arange(5) % 128, max_new=3)
        eng.submit(r)
        assert r.status.startswith("rejected: unknown user")
        assert lib.publish_banks(eng, [_channel(7, 0, n)]) == 1
        assert eng.store.knows(7) and eng.store.version(7) == 0
        outs[lib] = _serve(lib, eng, prompts, [7])[0]
        assert lib.publish_banks(eng, [_channel(7, 2, n)]) == 1
        assert lib.publish_banks(eng, [_channel(7, 2, n)]) == 0   # a replay
    assert outs[tserve] == outs[jserve]
    assert _counters(te.store) == _counters(je.store)
    solo = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=1, max_len=64,
                              user_adapters=[_t(newcomer)], device="cpu")
    assert outs[tserve] == _serve(tserve, solo, prompts, [0])[0]


def test_store_install_rejects_nonfinite_and_stale(tiny):
    banks = _banks(tiny, 2)
    eng = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=2, max_len=64,
                             user_adapters=[_t(b) for b in banks],
                             resident_slots=2, device="cpu")
    poisoned = jax.tree.map(lambda a: a * np.nan, banks[0])
    assert not eng.install_adapters(0, _t(poisoned), version=1)
    assert not eng.install_adapters(0, _t(banks[0]), version=0)   # stale
    assert eng.stats["bank_rejected"] == 2
    assert not eng.install_adapters(
        0, _t(gl.init_adapters(tiny.cfg, _CC8, tiny.key)), 5)
    assert eng.stats["bank_rejected"] == 3
    assert eng.store.version(0) == 0 and eng.stats["bank_installs"] == 0
