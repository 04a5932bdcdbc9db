"""zamba2-7b's hybrid plan in the port, against the JAX package on the CPU:
segments of Mamba2 layers, each led by one call of the shared attention
block, whose one parameter set and one adapter serve every call while each
call gets its own Mode-A delta and collected input. The model is JAX's
``registry.reduced_config("zamba2-7b")`` (7 layers, a shared block every 3:
segments of 3 / 3 / 1, so 3 calls; d_head 32, MHA; ssm_headdim 16, state
16, chunk 32), JAX's weights carried across by ``repro_torch.convert``,
numpy inputs from a seed fed to both. JAX's attention at d_head 32 takes its
plain ``ref`` path. Every JAX run of the file sits in a module-scoped
fixture or under ``jax.jit``.

Covered: tap sites, delta shapes, the zero deltas and ``select_taps``; the
init tree and ``convert``'s dtypes; forward, loss and prefill (logits and
both cache stacks); a chunk step and a tick, dense and paged, with a dead
row (logits and caches); Mode A's server step, merged and not (loss, x and
grad_h of both shared taps at every call); fit gradients of three families
(one adapter, the calls' gradients summed); Mode B, LoRA and full-FT
gradients and Prop 1; ``ColaSession`` in five modes (at 4 layers: two
calls); the dense engine's
tokens and ``kv_cache_bytes`` against JAX's engine, the chunked and paged +
int8 engines' against JAX's greedy decoding by full forwards (a reused slot
starts from JAX's chunked engine's last state, ROADMAP.md C.8) and their
``kv_cache_bytes`` against JAX's same engine; a paged engine's admission
into a reused slot leaving every other slot's K/V untouched; the adapter
store on the shared taps; JAX's plan-sweep zamba2 case; the zamba2 cases of
tests/test_models_smoke.py; and one reduced case at d_head 112 through
forward and a tick (the plain path of the tiling the card's kernels gained).

Tolerances (f32, sums in another order; ``_close``'s atol is its rtol times
the largest entry): logits, caches, x, grad_h and model gradients 1e-4, as
tests/test_models_smoke.py:55-67 holds prefill to the forward; losses rtol
1e-5; fit gradients 1e-5 (the same contraction); Prop 1 at
test_gl_equivalence.py's rtol 2e-4 / atol 1e-6 (5e-3 through the merged
pass, as test_torch_training.py); sessions at test_torch_session.py's (losses
1e-4, banks 1e-3, 5e-3 with int8 transfer under SGD); chunked against
unchunked logits atol 1e-3, as JAX's own sweep; tokens equal.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.core import merge as jmerge  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.core import taps as jtaps  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.core import taps as ttaps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime import kv_pager as tpager  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from tests.conftest import make_batch  # noqa: E402

NAME = "zamba2-7b"
QV = ("shared.attn.q", "shared.attn.v")
FAMILIES = ("lowrank", "linear", "mlp")
MODES = {   # ColaSession's five modes, as test_torch_session.py runs them
    "offload-merged": dict(mode="faithful_offload", merged=True, interval=2),
    "offload-int8": dict(mode="faithful_offload", compress="int8"),
    "fused_fit": dict(mode="fused_fit", interval=2),
    "lora": dict(mode="lora"),
    "ft": dict(mode="ft"),
}
INT8_RTOL = 5e-3   # int8 transfer under SGD (test_torch_pairs_train.py)
ENGINE_KW = dict(slots=3, max_len=64)
ENGINES = {"dense": {},
           "chunked": dict(prefill_chunk=4),
           "paged": dict(prefill_chunk=4, kv_layout="paged", kv_block=8,
                         bank_store="int8")}
PROMPT_LENS = (3, 21, 9, 33, 17)
MAX_NEW = 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _tnp(tree):
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _close(got, want, rtol=1e-4, what=""):
    """Trees of arrays agree within rtol, with atol = rtol * max |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], rtol, f"{what}.{k}")
        return
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(1e-6, float(np.abs(want).max())),
                               err_msg=what)


def _jit(fn, *static):
    return jax.jit(functools.partial(fn, *static))


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p in lens]


def _pair(**over):
    cfg = registry.reduced_config(NAME).replace(**over)
    tcfg = tregistry.reduced_config(NAME).replace(**over)
    params = M.init(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, convert.params_from_numpy(tcfg, _np(params),
                                                        device="cpu")


@pytest.fixture(scope="module")
def hybrid():
    return _pair()


def _adapters(cfg, family, *, noise=0.02, rank=4, hidden=16):
    """JAX-initialised adapters plus noise (B != 0, so dA is informative)."""
    cc = ColaConfig(mode="faithful_offload", family=family, taps="qv",
                    rank=rank, hidden=hidden)
    ad = gl.init_adapters(cfg, cc, jax.random.PRNGKey(2))
    ad = jax.tree.map(lambda a: a + noise * jax.random.normal(
        jax.random.PRNGKey(7), a.shape), ad)
    return cc, _np(ad)


def _tspec(tcfg, cc):
    return tgl.make_spec(tcfg, tbase.ColaConfig(**dataclasses.asdict(cc)))


# ---------------------------------------------------------------------------
# structure: the plan, taps, deltas, the init tree, convert
# ---------------------------------------------------------------------------

def test_require_ported_takes_the_hybrid_plan():
    """zamba2-7b runs: its plan is JAX's 14 segments (the last of 3 layers);
    the reduced config's 3 / 3 / 1."""
    full = tregistry.get_config(NAME)
    plan = TM._require_ported(full)
    assert plan == M.layer_plan(registry.get_config(NAME))
    assert plan[0] == "hybrid" and len(plan[1]) == 14
    assert plan[1][-1] == (78, 3)
    assert TM._require_ported(tregistry.reduced_config(NAME))[1] == \
        [(0, 3), (3, 3), (6, 1)]
    assert TM._stacks(full) == {"layers": 81, "shared": 0}
    walk = list(TM._walk(tregistry.reduced_config(NAME)))
    assert walk == [("shared", 0, None), ("layers", 0, None),
                    ("layers", 1, None), ("layers", 2, None),
                    ("shared", 1, None), ("layers", 3, None),
                    ("layers", 4, None), ("layers", 5, None),
                    ("shared", 2, None), ("layers", 6, None)]


def test_tap_sites_delta_shapes_and_zero_deltas_match_jax(hybrid):
    """JAX's sites in JAX's order (the Mamba2 layers' stacked 7, the shared
    block's unstacked); the delta of a shared site has one slot a call;
    ``select_taps("qv")`` picks the shared q and v; the zero deltas of
    ``gl`` and ``taps`` carry the call axis (JAX's ``zero_delta_vars`` has
    none; its ``zero_deltas``, which the server step uses, has it)."""
    cfg, tcfg, _, _ = hybrid
    js, ts = M.tap_sites(cfg), TM.tap_sites(tcfg)
    assert list(ts) == list(js)
    for n in js:
        assert (ts[n].d_in, ts[n].d_out, ts[n].stacked) == \
            (js[n].d_in, js[n].d_out, js[n].stacked), n
        assert TM.delta_shape(tcfg, ts[n], 2, 5) == \
            M.delta_shape(cfg, js[n], 2, 5), n
    assert ts["shared.attn.q"].calls == 3 and ts["layers.ssm.in"].calls == 0
    assert tgl.select_taps(tcfg, "qv") == gl.select_taps(cfg, "qv") == QV
    assert tgl.select_taps(tcfg, "ssm") == gl.select_taps(cfg, "ssm")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="all",
                    rank=4)
    spec, tspec = gl.make_spec(cfg, cc), _tspec(tcfg, cc)
    want = {t: z.shape for t, z in gl.zero_deltas(cfg, spec, 2, 5).items()}
    assert {t: tuple(z.shape) for t, z in tgl.zero_deltas(
        tcfg, tspec, 2, 5, device="cpu").items()} == want
    assert {t: tuple(z.shape) for t, z in ttaps.zero_delta_vars(
        tspec, ts, (2, 5), device="cpu").items()} == want
    assert want["shared.attn.q"] == (3, 2, 5, 128)
    assert jtaps.zero_delta_vars(spec, js, (2, 5))["shared.attn.q"].shape \
        == (2, 5, 128)
    full = TM.tap_sites(tregistry.get_config(NAME))
    assert [(s.d_in, s.d_out, s.stacked, s.calls) for s in full.values()] \
        == [(3584, 14576, 81, 0), (7168, 3584, 81, 0)] + \
        [(3584, 3584, 0, 14)] * 4 + [(3584, 14336, 0, 14)] * 2 + \
        [(14336, 3584, 0, 14)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_and_convert_dtypes_match_jax(dtype):
    """The port's init has JAX's tree, shapes and dtypes leaf for leaf (the
    shared block unstacked, the 7 Mamba2 blocks stacked, dt_bias / A_log /
    D f32 in bf16); ``convert`` carries JAX's tree across with the same
    dtypes and values. The full config's 6,636,442,832 parameters on the
    meta device."""
    cfg = registry.reduced_config(NAME).replace(param_dtype=dtype)
    tcfg = tregistry.reduced_config(NAME).replace(param_dtype=dtype)
    jp = M.init(cfg, jax.random.PRNGKey(0))
    mine = TM.init(tcfg, seed=0, device="cpu")
    conv = convert.params_from_numpy(tcfg, _np(jp), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(tree_leaves(mine)) == len(tree_leaves(conv))
    for path, leaf in jleaves:
        got, carried = mine, conv
        for p in path:
            got, carried = got[p.key], carried[p.key]
        assert tuple(got.shape) == leaf.shape, path
        assert str(got.dtype).replace("torch.", "") == str(leaf.dtype), path
        assert carried.dtype == got.dtype, path
        np.testing.assert_array_equal(carried.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert tuple(mine["shared"]["attn"]["q"]["w"].shape) == (128, 128)
    assert tuple(mine["layers"]["ssm"]["in_proj"]["w"].shape)[0] == 7
    for k in ("dt_bias", "A_log", "D"):
        assert mine["layers"]["ssm"][k].dtype == torch.float32
    meta = TM.init(tregistry.get_config(NAME), device="meta")
    assert sum(t.numel() for t in tree_leaves(meta)) == 6_636_442_832


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill, decode
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_jax(hybrid):
    """Logits at S 45 (a chunk and a tail through every Mamba2 layer, three
    calls of the shared block), the moe aux of 0, and the loss."""
    cfg, tcfg, params, tparams = hybrid
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 45)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab_size, (2, 45)).astype(np.int32)
    lg, aux = _jit(M.forward, cfg)(params, {"tokens": jnp.asarray(toks)})
    tlg, taux = TM.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    _close(_tnp(tlg), lg, 1e-4, "logits")
    assert float(taux["moe_aux"]) == float(aux["moe_aux"]) == 0.0
    batch = {"tokens": toks, "labels": labels}
    loss, _ = _jit(M.loss_fn, cfg)(params, jax.tree.map(jnp.asarray, batch))
    tloss, _ = TM.loss_fn(tcfg, tparams, _t(batch))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)


def _paged_pool(dense_kv, pager, slot_ids, P, n_blocks, bs):
    """A (n, n_blocks, bs, K, Dh) pool holding each prefill row j's first P
    positions in the blocks ``pager`` gave slot ``slot_ids[j]``."""
    n, _, _, K, Dh = dense_kv.shape
    pool = np.zeros((n, n_blocks, bs, K, Dh), np.float32)
    for j, s in enumerate(slot_ids):
        for t in range(P):
            pool[:, pager.table[s, t // bs], t % bs] = dense_kv[:, j, t]
    return pool


def test_prefill_then_decode_dense_and_paged_match_jax(hybrid):
    """prefill (S 37): logits and both stacks ({"layers": conv, ssm},
    {"shared": k, v (3, B, S, K, Dh)}) against JAX's; its rows written into
    two of three slots, a 3-token chunk and a tick with the third row dead:
    logits and every cache leaf against JAX's, dense and through a shuffled
    pool of 8-position blocks; the dead row's state, and its K/V (dense) or
    the pool blocks no live slot owns (paged), unchanged bit for bit."""
    cfg, tcfg, params, tparams = hybrid
    rng = np.random.default_rng(2)
    S, slots, max_len, bs = 37, 3, 64, 8
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    lg, pre = _jit(M.prefill, cfg)(params, {"tokens": jnp.asarray(toks)})
    tlg, tpre = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    _close(_tnp(tlg), lg, 1e-4, "prefill logits")
    assert {k: set(v) for k, v in tpre.items()} == \
        {"layers": {"conv", "ssm"}, "shared": {"k", "v"}}
    for st in pre:
        for n in pre[st]:
            assert tuple(tpre[st][n].shape) == pre[st][n].shape, (st, n)
            _close(_tnp(tpre[st][n]), pre[st][n], 1e-4, f"prefill {st}.{n}")
    ids = np.array([0, 1], np.int32)
    live = np.array([True, True, False])
    steps = [{"tokens": rng.integers(0, cfg.vocab_size, (3, c)).astype(
        np.int32), "positions": np.array(pos, np.int32)}
        for c, pos in ((3, [S, S, 0]), (1, [S + 3, S + 3, 0]))]
    for layout in ("dense", "paged"):
        if layout == "dense":
            cache = M.scatter_prefill_cache(M.init_cache(cfg, slots, max_len),
                                            pre, jnp.asarray(ids))
            tcache = TM.scatter_prefill_cache(
                TM.init_cache(tcfg, slots, max_len, device="cpu"), tpre, ids)
            table = None
        else:
            n_blocks = slots * max_len // bs
            pager = tpager.BlockPager(n_blocks, bs, slots, max_len)
            # a shuffled pool: slot 2 (dead) takes blocks first
            assert pager.ensure(2, 2 * bs - 1)
            for s in ids:
                assert pager.ensure(int(s), S + 3)
            table = pager.table.copy()
            kw = dict(kv_layout="paged", kv_blocks=n_blocks, kv_block=bs)
            cache = M.init_cache(cfg, slots, max_len, **kw)
            cache["layers"] = M.scatter_prefill_cache(
                {"layers": cache["layers"]}, {"layers": pre["layers"]},
                jnp.asarray(ids))["layers"]
            cache["shared"] = {n: jnp.asarray(_paged_pool(
                np.asarray(pre["shared"][n]), pager, ids, S, n_blocks, bs))
                for n in ("k", "v")}
            tcache = {st: {n: _t(np.asarray(v)) for n, v in leaves.items()}
                      for st, leaves in cache.items()}
        # the dead row: random state, and random K/V in its slot or blocks
        for n in ("conv", "ssm"):
            dead = rng.normal(size=tcache["layers"][n][:, 2].shape)
            tcache["layers"][n][:, 2] = torch.as_tensor(dead)
            cache["layers"][n] = cache["layers"][n].at[:, 2].set(dead)
        own = set() if table is None else {int(b) for b in table[:2].ravel()}
        for n in ("k", "v"):
            if table is None:
                dead = rng.normal(size=tcache["shared"][n][:, 2].shape)
                tcache["shared"][n][:, 2] = torch.as_tensor(dead)
                cache["shared"][n] = cache["shared"][n].at[:, 2].set(dead)
        before = {st: {n: v.clone() for n, v in leaves.items()}
                  for st, leaves in tcache.items()}
        for step in steps:
            kw = {} if table is None else {"block_table": jnp.asarray(table)}
            lg, cache = _jit(M.decode_step, cfg)(
                params, jax.tree.map(jnp.asarray, step), cache,
                live=jnp.asarray(live), **kw)
            tkw = {} if table is None else {"block_table": _t(table)}
            tlg, tcache = TM.decode_step(tcfg, tparams, _t(step), tcache,
                                         live=torch.as_tensor(live), **tkw)
            c = step["tokens"].shape[1]
            _close(_tnp(tlg)[live], np.asarray(lg)[live], 1e-4,
                   f"{layout} c {c} logits")
            for st in cache:
                for n in cache[st]:
                    _close(_tnp(tcache[st][n]), cache[st][n], 1e-4,
                           f"{layout} c {c} {st}.{n}")
        for n in ("conv", "ssm"):
            assert torch.equal(tcache["layers"][n][:, 2],
                               before["layers"][n][:, 2])
        for n in ("k", "v"):
            if table is None:
                assert torch.equal(tcache["shared"][n][:, 2],
                                   before["shared"][n][:, 2])
            else:
                others = [b for b in range(tcache["shared"][n].shape[1])
                          if b not in own]
                assert torch.equal(tcache["shared"][n][:, others],
                                   before["shared"][n][:, others])


def test_cache_specs_match_jax(hybrid):
    """Both layouts' cache leaves, shapes and dtypes (bf16 compute), as
    JAX's: the Mamba2 layers' state, the shared block's K/V a call."""
    cfg, tcfg, _, _ = hybrid
    for layout in ("dense", "paged"):
        js = M.cache_specs(cfg.replace(compute_dtype="bfloat16"), 3, 64,
                           kv_layout=layout)
        ts = TM.cache_specs(tcfg.replace(compute_dtype="bfloat16"), 3, 64,
                            kv_layout=layout)
        assert {st: {n: (tuple(s.shape), str(s.dtype)) for n, s in
                     leaves.items()} for st, leaves in js.items()} == \
            {st: {n: (sh, str(dt).replace("torch.", "")) for n, (sh, dt) in
                  leaves.items()} for st, leaves in ts.items()}
    full = TM.cache_specs(tregistry.get_config(NAME), 8, 1024)
    nbytes = {st: sum(int(np.prod(sh)) * (4 if dt == torch.float32 else 2)
                      for sh, dt in leaves.values())
              for st, leaves in full.items()}
    assert nbytes == {"layers": 1_217_452_032, "shared": 1_644_167_168}


# ---------------------------------------------------------------------------
# ColA training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batches(hybrid):
    stream = jpipeline.SyntheticLM(hybrid[0], batch=2, seq=40, seed=3)
    return [stream.batch_at(i) for i in range(3)]


@pytest.fixture(scope="module")
def jax_steps(hybrid, batches):
    """Mode A's server step (unmerged and merged), the fit gradients of each
    family on the unmerged step's data (any (x, grad_h) serves to hold the
    fit to JAX's), Mode B's and full FT's gradients."""
    cfg, _, params, _ = hybrid
    cc, ad = _adapters(cfg, "lowrank")
    out = {"adapters": ad}
    for merged in (False, True):
        c = dataclasses.replace(cc, merged=merged)
        p, a = params, ad
        if merged:
            fams = dict(gl.make_spec(cfg, cc).families)
            p, a = jmerge.merged_params(cfg, params, fams, ad, cc.scale), {}
        loss, data, _ = _jit(gl.server_step_a, cfg, gl.make_spec(cfg, c))(
            p, a, batches[0])
        out[("a", merged)] = (float(loss), _np(data))
    data = out[("a", False)][1]
    for family in FAMILIES:
        c, a = _adapters(cfg, family)
        spec = gl.make_spec(cfg, c)
        out[("fit", family)] = (a, data,
                                _np(_jit(gl.fit_grads, spec)(a, data)))
    spec_b = gl.make_spec(cfg, dataclasses.replace(cc, mode="fused_fit"))
    loss, grads, _ = _jit(gl.train_step_b, cfg, spec_b)(params, ad, batches[1])
    out["b"] = (float(loss), _np(grads))
    loss, grads, _ = _jit(gl.train_step_ft, cfg)(params, batches[1])
    out["ft"] = (float(loss), _np(grads))
    return out


@pytest.mark.parametrize("merged", [False, True])
def test_server_step_a_matches_jax(hybrid, batches, jax_steps, merged):
    """The loss, and x and grad_h of both shared taps at every one of the
    three calls, (3, B, S, d), against JAX's (``collected_shared``); every
    call's grad_h non-zero."""
    cfg, tcfg, _, tparams = hybrid
    loss, data = jax_steps[("a", merged)]
    cc, _ = _adapters(cfg, "lowrank")
    tspec = _tspec(tcfg, dataclasses.replace(cc, merged=merged))
    tad = convert.adapters_from_numpy(jax_steps["adapters"], device="cpu")
    tp, tin = tparams, tad
    if merged:
        fams = dict(gl.make_spec(cfg, cc).families)
        tp, tin = tmerge.merged_params(tcfg, tparams, fams, tad, cc.scale), {}
    tloss, tdata, _ = tgl.server_step_a(tcfg, tspec, tp, tin, _t(batches[0]))
    np.testing.assert_allclose(float(tloss), loss, rtol=1e-5)
    assert tuple(sorted(tdata)) == tuple(sorted(data)) == QV
    for tap in QV:
        for k, what in ((0, "x"), (1, "grad_h")):
            assert tuple(tdata[tap][k].shape) == data[tap][k].shape == \
                (3, 2, 40, 128)
            _close(_tnp(tdata[tap][k]), data[tap][k], what=f"{tap} {what}")
        assert all(np.abs(data[tap][1][i]).max() > 0 for i in range(3))


@pytest.mark.parametrize("family", FAMILIES)
def test_fit_grads_sum_over_calls_match_jax(hybrid, jax_steps, family):
    """One adapter, three calls' data: the fit gradient is the sum of the
    calls' gradients, as JAX's shared branch takes it."""
    cfg, tcfg, _, _ = hybrid
    ad, data, want = jax_steps[("fit", family)]
    cc, _ = _adapters(cfg, family)
    tspec = _tspec(tcfg, cc)
    tad = convert.adapters_from_numpy(ad, device="cpu")
    tdata = {t: (_t(x), _t(g)) for t, (x, g) in data.items()}
    got = tgl.fit_grads(tspec, tad, tdata)
    assert tuple(sorted(got)) == QV
    _close(_tnp(got), want, rtol=1e-5, what=family)
    # the sum over calls, call by call
    parts = [tgl.fit_grads(tspec, tad, {t: (x[i], g[i])
                                        for t, (x, g) in tdata.items()})
             for i in range(3)]
    for tap in QV:
        for leaf in got[tap]:
            _close(sum(p[tap][leaf] for p in parts).numpy(),
                   got[tap][leaf].numpy(), rtol=1e-5, what=f"{tap}.{leaf}")


def test_fit_loss_on_shared_taps_matches_jax(hybrid, jax_steps):
    """Eq. 6's objective at the shared taps (the unstacked adapter
    broadcast over the calls) against JAX's."""
    cfg, tcfg, _, _ = hybrid
    ad, data, _ = jax_steps[("fit", "lowrank")]
    cc, _ = _adapters(cfg, "lowrank")
    spec = gl.make_spec(cfg, cc)
    ad2 = jax.tree.map(lambda a: a * 1.1, ad)
    want = float(jax.jit(functools.partial(gl.fit_loss, spec))(ad2, data, ad))
    got = float(tgl.fit_loss(_tspec(tcfg, cc),
                             convert.adapters_from_numpy(ad2, device="cpu"),
                             {t: (_t(x), _t(g)) for t, (x, g) in data.items()},
                             convert.adapters_from_numpy(ad, device="cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_mode_b_lora_and_ft_gradients_match_jax(hybrid, batches, jax_steps):
    """Mode B and LoRA (one adapter applied at three calls: autograd sums
    the calls' gradients; LoRA's spec is Mode B's in both packages, so both
    are held to JAX's Mode B step) and full fine-tuning (the shared block's
    unstacked leaves among them) against JAX's."""
    cfg, tcfg, _, tparams = hybrid
    cc, _ = _adapters(cfg, "lowrank")
    tad = convert.adapters_from_numpy(jax_steps["adapters"], device="cpu")
    assert gl.make_spec(cfg, dataclasses.replace(cc, mode="lora")) == \
        gl.make_spec(cfg, dataclasses.replace(cc, mode="fused_fit"))
    for mode in ("fused_fit", "lora"):
        tloss, tgrads, _ = tgl.train_step_b(
            tcfg, _tspec(tcfg, dataclasses.replace(cc, mode=mode)), tparams,
            tad, _t(batches[1]))
        loss, grads = jax_steps["b"]
        np.testing.assert_allclose(float(tloss), loss, rtol=1e-5)
        _close(_tnp(tgrads), grads, what=f"grads {mode}")
    tloss, tgrads, _ = tgl.train_step_ft(tcfg, tparams, _t(batches[1]))
    loss, grads = jax_steps["ft"]
    np.testing.assert_allclose(float(tloss), loss, rtol=1e-5)
    _close(_tnp(tgrads), grads, what="grads ft")
    assert tuple(tgrads["shared"]["attn"]["q"]["w"].shape) == (128, 128)


def test_prop1_mode_a_equals_mode_b():
    """JAX's test_prop1_mode_a_equals_mode_b[zamba2-7b] in the port (the
    reduced config, batch 2 x 16, its tolerances), and through the merged
    pass."""
    cfg = registry.reduced_config(NAME)
    tcfg = tregistry.reduced_config(NAME)
    key = jax.random.PRNGKey(1)
    params = M.init(cfg, key)
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=4)
    ad = _np(jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.PRNGKey(7), a.shape),
        gl.init_adapters(cfg, cc, key)))
    batch = _t(_np(make_batch(cfg, 2, 16, jax.random.fold_in(key, 3))))
    tad = convert.adapters_from_numpy(ad, device="cpu")
    spec_a = _tspec(tcfg, cc)
    loss_a, data, _ = tgl.server_step_a(tcfg, spec_a, tparams, tad, batch)
    loss_b, gb, _ = tgl.train_step_b(
        tcfg, _tspec(tcfg, dataclasses.replace(cc, mode="fused_fit")),
        tparams, tad, batch)
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-6)
    pm = tmerge.merged_params(tcfg, tparams, spec_a, tad)
    _, data_m, _ = tgl.server_step_a(
        tcfg, _tspec(tcfg, dataclasses.replace(cc, merged=True)), pm, {},
        batch)
    assert sorted(gb) == list(QV)
    for d, rtol in ((data, 2e-4), (data_m, 5e-3)):
        ga = tgl.fit_grads(spec_a, tad, d)
        for tap in gb:
            for leaf in gb[tap]:
                np.testing.assert_allclose(ga[tap][leaf].numpy(),
                                           gb[tap][leaf].numpy(), rtol=rtol,
                                           atol=1e-6, err_msg=f"{tap}.{leaf}")
    # merge -> unmerge at the shared taps round-trips (f32)
    back = tmerge.unmerge_adapters(tcfg, pm, spec_a.family_map, tad,
                                   spec_a.scale)
    for tap in QV:
        name = tap.split(".")[-1]
        w0 = tparams["shared"]["attn"][name]["w"]
        assert not torch.equal(pm["shared"]["attn"][name]["w"], w0)
        torch.testing.assert_close(back["shared"]["attn"][name]["w"], w0,
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def short():
    """The sessions' model: the reduced config at 4 layers (segments of 3
    and 1: two calls of the shared block), three batches of 2 x 16."""
    cfg, tcfg, params, tparams = _pair(n_layers=4)
    stream = jpipeline.SyntheticLM(cfg, batch=2, seq=16, seed=3)
    return cfg, tcfg, params, tparams, [stream.batch_at(i) for i in range(3)]


@pytest.fixture(scope="module")
def jax_sessions(short):
    """Each mode's JAX session over the three batches: its initial adapters,
    losses, final adapters and eval loss."""
    cfg, _, params, _, batches = short
    out = {}
    for name, kw in MODES.items():
        cc = ColaConfig(family="lowrank", taps="qv", rank=4, **kw)
        lr = 1e-3 if cc.mode == "ft" else 1e-2
        opt = jopt.sgd(lr) if cc.compress == "int8" else None
        js = jsession.ColaSession(cfg, cc, params, jax.random.PRNGKey(3),
                                  optimizer=opt, lr=lr)
        init = None if cc.mode == "ft" else _np(js.adapters)
        losses = [js.step(b) for b in batches]
        out[name] = (cc, lr, init, losses,
                     None if cc.mode == "ft" else _np(js.adapters),
                     js.eval_loss(batches[0]))
    return out


@pytest.mark.parametrize("name", list(MODES))
def test_session_trajectory_matches_jax(short, jax_sessions, name):
    _, tcfg, _, tparams, batches = short
    cc, lr, init, losses, final, eval_loss = jax_sessions[name]
    opt = topt.sgd(lr) if cc.compress == "int8" else None
    ts = tsession.ColaSession(tcfg, tbase.ColaConfig(**dataclasses.asdict(cc)),
                              tparams, optimizer=opt, lr=lr, device="cpu")
    if init is not None:   # start from JAX's adapters
        ad = convert.adapters_from_numpy(init, device="cpu")
        ts.adapters = ad
        if cc.mode == "lora":
            ts.opt_state = ts.optimizer.init(ad)
        else:
            ts.offloader.adapters = ts.channel.last_good = ad
    got = [ts.step(b) for b in batches]
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    assert len({round(x, 6) for x in losses}) > 1   # training moved the loss
    if final is not None:
        assert tuple(sorted(ts.adapters)) == QV
        _close(_tnp(ts.adapters), final,
               rtol=INT8_RTOL if cc.compress == "int8" else 1e-3, what=name)
    np.testing.assert_allclose(ts.eval_loss(batches[0]), eval_loss, rtol=1e-4)


# ---------------------------------------------------------------------------
# the zamba2 cases of tests/test_models_smoke.py and tests/test_paged_kv.py
# ---------------------------------------------------------------------------

def test_smoke_forward_and_train_step():
    """JAX's test_smoke_forward_and_train_step[zamba2-7b] in the port: the
    forward's (2, 32, vocab) logits, no NaN, and one Mode B step with a
    finite loss and finite adapter grads, each held to JAX's numbers."""
    cfg = registry.reduced_config(NAME)
    tcfg = tregistry.reduced_config(NAME)
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    batch = make_batch(cfg, 2, 32, key)
    logits, _ = _jit(M.forward, cfg)(params, batch)
    tlogits, _ = TM.forward(tcfg, tparams, _t(_np(batch)))
    assert tuple(tlogits.shape) == (2, 32, tcfg.vocab_size)
    assert not torch.isnan(tlogits).any()
    _close(_tnp(tlogits), logits, what="logits")
    cc = ColaConfig(mode="fused_fit", family="lowrank", taps="qv", rank=4)
    adapters = gl.init_adapters(cfg, cc, key)
    loss, grads, _ = _jit(gl.train_step_b, cfg, gl.make_spec(cfg, cc))(
        params, adapters, batch)
    tloss, tgrads, _ = tgl.train_step_b(
        tcfg, _tspec(tcfg, cc), tparams,
        convert.adapters_from_numpy(_np(adapters), device="cpu"),
        _t(_np(batch)))
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    for leaf in tree_leaves(tgrads):
        assert torch.isfinite(leaf).all()
    _close(_tnp(tgrads), _np(grads), what="grads")


def test_prefill_decode_matches_forward():
    """tests/test_models_smoke.py::test_prefill_decode_matches_forward
    [zamba2-7b] in the port (B 2, S 16): prefill's logits equal the
    forward's at S - 1, and a tick from the prefill's cache grafted into a
    longer one (the state whole, K/V at [0, S)) equals the forward's at S,
    at that test's tolerances; the forward against JAX's."""
    cfg = registry.reduced_config(NAME)
    tcfg = tregistry.reduced_config(NAME)
    key = jax.random.PRNGKey(1)
    params = M.init(cfg, key)
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    B, S = 2, 16
    toks = np.array(jax.random.randint(key, (B, S + 1), 0, cfg.vocab_size),
                    np.int32)
    full, _ = TM.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    pre, cache = TM.prefill(tcfg, tparams,
                            {"tokens": torch.as_tensor(toks[:, :S])})
    np.testing.assert_allclose(pre[:, 0].numpy(), full[:, S - 1].numpy(),
                               rtol=1e-4, atol=1e-4)
    cache2 = TM.init_cache(tcfg, B, S + 8, device="cpu")
    TM.scatter_prefill_cache(cache2, cache, np.arange(B))
    assert torch.equal(cache2["shared"]["k"][:, :, :S], cache["shared"]["k"])
    assert torch.equal(cache2["layers"]["ssm"], cache["layers"]["ssm"])
    step = {"tokens": torch.as_tensor(toks[:, S:S + 1]),
            "positions": torch.full((B,), S, dtype=torch.int32)}
    dec, cache3 = TM.decode_step(tcfg, tparams, step, cache2)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, S].numpy(),
                               rtol=1e-4, atol=2e-4)
    assert {k: set(v) for k, v in cache3.items()} == \
        {"layers": {"conv", "ssm"}, "shared": {"k", "v"}}
    want, _ = M.forward(cfg, params, {"tokens": jnp.asarray(toks)})
    _close(full.numpy(), want, what="forward")


def _chunk_run(tcfg, tparams, prompt, cache, *, C, slot, slots, pager=None):
    """decode_step chunk by chunk as the engine drives a recurrent plan
    (exact-width tails); returns the last real token's logits."""
    consumed, last = 0, None
    while consumed < len(prompt):
        c = min(C, len(prompt) - consumed)
        toks = np.zeros((slots, c), np.int32)
        toks[slot] = prompt[consumed:consumed + c]
        pos = np.zeros(slots, np.int32)
        pos[slot] = consumed
        live = np.zeros(slots, bool)
        live[slot] = True
        kw = {}
        if pager is not None:
            assert pager.ensure(slot, consumed + c - 1)
            kw["block_table"] = torch.as_tensor(pager.table)
        lg, cache = TM.decode_step(tcfg, tparams, _t({"tokens": toks,
                                                      "positions": pos}),
                                   cache, live=torch.as_tensor(live), **kw)
        last = lg[slot, c - 1]
        consumed += c
    return last


def test_chunked_matches_prefill_and_paged_matches_dense():
    """The zamba2 case (C 4, P 11, ssm_headdim / state 16) of
    tests/test_paged_kv.py::test_chunked_matches_prefill_and_paged_matches_
    dense in the port, on that test's tiny widths: chunked logits within its
    atol 1e-3 of the full prefill's and the same argmax; paged (the shared
    block's K/V in a pool) equal to dense chunked, bit for bit."""
    over = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                d_ff=128, vocab_size=128, ssm_headdim=16, ssm_state=16)
    tcfg = tregistry.reduced_config(NAME).replace(**over)
    tparams = TM.init(tcfg, seed=0, device="cpu")
    C, P, slots, max_len, s = 4, 11, 3, 32, 1
    prompt = _prompts(tcfg.vocab_size, (P,), seed=1)[0]
    full, _ = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(prompt[None])})
    full = full[0, 0]
    dense = _chunk_run(tcfg, tparams, prompt,
                       TM.init_cache(tcfg, slots, max_len, device="cpu"),
                       C=C, slot=s, slots=slots)
    np.testing.assert_allclose(dense.numpy(), full.numpy(), atol=1e-3)
    assert int(dense.argmax()) == int(full.argmax())
    pager = tpager.BlockPager(n_blocks=16, block_size=8, slots=slots,
                              max_len=max_len)
    assert pager.reserve(s, P)
    cache_p = TM.init_cache(tcfg, slots, max_len, kv_layout="paged",
                            kv_blocks=16, kv_block=8, device="cpu")
    paged = _chunk_run(tcfg, tparams, prompt, cache_p, C=C, slot=s,
                       slots=slots, pager=pager)
    assert torch.equal(paged, dense)


def test_d_head_112_forward_and_tick_match_jax():
    """zamba2's d_head 112 (reduced: 2 heads of 112) through the forward
    and, from a prefill, a tick with a dead row, against JAX's (its kernels
    take no 112, so JAX runs ``ref``; the port's plain path, which its CPU
    tensors take)."""
    cfg, tcfg, params, tparams = _pair(n_heads=2, n_kv_heads=2, d_head=112)
    assert TM.tap_sites(tcfg)["shared.attn.q"].d_out == 224
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    lg, _ = _jit(M.forward, cfg)(params, {"tokens": jnp.asarray(toks)})
    tlg, _ = TM.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    _close(_tnp(tlg), lg, what="forward")
    lg, pre = _jit(M.prefill, cfg)(params, {"tokens": jnp.asarray(toks)})
    _, tpre = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    ids = np.array([0, 2], np.int32)
    cache = M.scatter_prefill_cache(M.init_cache(cfg, 3, 32), pre,
                                    jnp.asarray(ids))
    tcache = TM.scatter_prefill_cache(TM.init_cache(tcfg, 3, 32, device="cpu"),
                                      tpre, ids)
    live = np.array([True, False, True])
    step = {"tokens": np.array([[5], [0], [7]], np.int32),
            "positions": np.array([20, 0, 20], np.int32)}
    lg, cache = _jit(M.decode_step, cfg)(params, jax.tree.map(jnp.asarray,
                                                              step), cache,
                                         live=jnp.asarray(live))
    tlg, tcache = TM.decode_step(tcfg, tparams, _t(step), tcache,
                                 live=torch.as_tensor(live))
    _close(_tnp(tlg)[live], np.asarray(lg)[live], what="tick")
    _close(_tnp(tcache["shared"]), _np(cache["shared"]), what="tick k/v")


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _banks(cfg, n=2):
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    key = jax.random.PRNGKey(0)
    out = []
    for u in range(n):   # every user's B nonzero (B is zero at init)
        ad = gl.init_adapters(cfg, cc, jax.random.fold_in(key, 1 + u))
        out.append(_np(jax.tree.map(lambda a: a + 0.3 * jax.random.normal(
            jax.random.fold_in(key, 10 + u), a.shape), ad)))
    return out


def _run(lib, cfg, params, banks, prompts, **kw):
    eng = lib.ServeEngine(cfg, params, user_adapters=banks, **kw)
    reqs = [lib.Request(rid=i, user=i % 2, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    bytes_seen = [eng.kv_cache_bytes()]
    while eng.queue or any(r is not None for r in eng.active):
        eng.tick()
        bytes_seen.append(eng.kv_cache_bytes())
    assert all(r.status == "done" for r in reqs)
    return [r.out for r in reqs], eng, bytes_seen


def _greedy(cfg, params, bank, prompts, users):
    """JAX's greedy decoding by full forwards: every request a row of one
    right-padded batch with its user's multi-LoRA adapters at the shared
    taps, the next token the argmax at the row's last real position (a
    causal model: padding to its right is not seen)."""
    spec = jtaps.make_spec(family="multi_lowrank",
                           taps=gl.select_taps(cfg, "qv"), scale=1.0)
    seqs = [list(p) for p in prompts]
    width = max(map(len, seqs)) + MAX_NEW
    idx = jnp.asarray(users, jnp.int32)
    vars_ = {"adapters": {t: {**{n: jnp.asarray(a) for n, a in e.items()},
                              "idx": idx} for t, e in bank.items()}}
    fwd = jax.jit(lambda toks: M.forward(cfg, params, {"tokens": toks}, spec,
                                         vars_)[0])
    outs = [[] for _ in seqs]
    for _ in range(MAX_NEW):
        toks = np.zeros((len(seqs), width), np.int32)
        for j, s in enumerate(seqs):
            toks[j, :len(s)] = s
        lg = np.asarray(fwd(jnp.asarray(toks)))
        for j, s in enumerate(seqs):
            t = int(np.argmax(lg[j, len(s) - 1]))
            s.append(t)
            outs[j].append(t)
    return outs


@pytest.fixture(scope="module")
def jax_outputs(hybrid):
    """JAX's engine with two users' adapters at the shared q and v taps,
    dense and paged + chunked + int8: tokens and kv_cache_bytes after every
    tick; and JAX's greedy tokens by full forwards from the f32 bank and
    from the int8 bank dequantised (``quantize_bank``, as the int8 engine
    stores it)."""
    cfg, _, params, _ = hybrid
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    banks = [jax.tree.map(jnp.asarray, b) for b in _banks(cfg)]
    engines = {}
    for name in ("dense", "paged"):
        opts = ENGINES[name]
        out, _, seen = _run(jserve, cfg, params, banks, prompts, **ENGINE_KW,
                            **opts)
        engines[name] = (out, seen)
    bank = jserve.stack_user_adapters(banks)
    q8 = jserve.quantize_bank(bank)
    deq = {t: {n: np.asarray(e[f"{n}_q"], np.float32) * np.asarray(
        e[f"{n}_scale"]) for n in ("A", "B")} for t, e in q8.items()}
    users = [i % 2 for i in range(len(prompts))]
    return engines, {"f32": _greedy(cfg, params, bank, prompts, users),
                     "int8": _greedy(cfg, params, deq, prompts, users)}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_matches_jax(hybrid, jax_outputs, name):
    """Five requests (3-33 tokens, tails narrower than the chunk) of two
    users with adapters at the shared taps, to three slots, so two
    requests reuse a slot. Every engine emits JAX's greedy tokens by full
    forwards (the f32 bank, or the int8 bank dequantised) and JAX's
    engine's kv_cache_bytes after every tick in the same layout (the
    state and dense K/V in full, the shared block's pool per block in
    use); the dense and chunked engines JAX's dense engine's tokens too.
    JAX's chunked engines start a reused slot from its last request's
    state (ROADMAP.md C.8): its paged engine agrees on the requests in
    fresh slots. The pool ends whole."""
    cfg, tcfg, _, tparams = hybrid
    engines, greedy = jax_outputs
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    tbanks = [convert.adapters_from_numpy(b, device="cpu") for b in _banks(cfg)]
    out, eng, seen = _run(tserve, tcfg, tparams, tbanks, prompts,
                          device="cpu", **ENGINE_KW, **ENGINES[name])
    assert out == greedy["int8" if name == "paged" else "f32"]
    jout, jseen = engines["paged" if name == "paged" else "dense"]
    if name == "chunked":   # more ticks; the dense layout's bytes are fixed
        assert set(seen) == set(jseen) == {jseen[0]}
    else:
        assert seen == jseen
    slots = ENGINE_KW["slots"]
    assert out[:slots] == jout[:slots]
    if name != "paged":
        assert out == jout
    if name != "dense":
        assert eng.stats["chunk_rounds"] > 0
        assert eng.stats["prefill_chunks"] > eng.stats["chunk_rounds"]
    if eng.pager is not None:
        eng.pager.assert_empty()
        assert seen[-1] == sum(
            leaf.numel() * leaf.element_size()
            for leaf in eng.cache["layers"].values()) + eng.pager.table.nbytes


def test_reference_engine_matches_dense(hybrid, jax_outputs):
    """The port's reference prefill (token by token through the live-masked
    decode step, from a zeroed state in a reused slot) emits the dense
    engine's tokens."""
    cfg, tcfg, _, tparams = hybrid
    engines, _ = jax_outputs
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    tbanks = [convert.adapters_from_numpy(b, device="cpu") for b in _banks(cfg)]
    out, _, _ = _run(tserve, tcfg, tparams, tbanks, prompts, device="cpu",
                     prefill_mode="reference", **ENGINE_KW)
    assert out == engines["dense"][0]


def test_paged_admission_leaves_other_slots_kv_alone(hybrid):
    """A paged hybrid engine admits a request into a reused slot while the
    other slot decodes: the admission zeroes the reused slot's state and
    leaves every pool block (the other slot's among them) and the other
    slot's state bit for bit; the other slot's tokens equal an engine that
    served it alone."""
    cfg, tcfg, _, tparams = hybrid
    # b's 3-token chunk goes first (exact-width groups in ascending width),
    # so b's slot 1 takes pool block 0 and a's slot 0 block 1; b finishes
    # after a's three chunk rounds, while a decodes
    a, b, c = _prompts(cfg.vocab_size, (12, 3, 9), seed=6)
    kw = dict(slots=2, max_len=64, prefill_chunk=4, kv_layout="paged",
              kv_block=8, device="cpu")
    alone = tserve.ServeEngine(tcfg, tparams, **kw)
    ra = tserve.Request(rid=0, user=0, prompt=a, max_new=24)
    alone.submit(ra)
    alone.run_until_idle()
    eng = tserve.ServeEngine(tcfg, tparams, **kw)
    reqs = [tserve.Request(rid=0, user=0, prompt=a, max_new=24),
            tserve.Request(rid=1, user=0, prompt=b, max_new=5),
            tserve.Request(rid=2, user=0, prompt=c, max_new=4)]
    for r in reqs:
        eng.submit(r)
    while eng.active[1] is None or eng.active[1].rid != 2:
        if reqs[1].done and eng.active[1] is None:
            # slot 1 is free again and request 2 waits: admit it alone
            pool = {n: eng.cache["shared"][n].clone() for n in ("k", "v")}
            state = {n: eng.cache["layers"][n][:, 0].clone()
                     for n in ("conv", "ssm")}
            # the pool block the slot's index names is the other slot's
            assert 1 in eng.pager.owned(0)
            eng._admit()
            assert eng.active[1].rid == 2
            for n in ("k", "v"):
                assert torch.equal(eng.cache["shared"][n], pool[n])
            for n in ("conv", "ssm"):
                assert torch.equal(eng.cache["layers"][n][:, 0], state[n])
                assert not eng.cache["layers"][n][:, 1].any()
            break
        eng.tick()
    assert reqs[0]._consumed == len(a) and len(reqs[0].out) > 1
    assert not reqs[0].done
    eng.run_until_idle()
    assert all(r.status == "done" for r in reqs)
    assert reqs[0].out == ra.out
    eng.pager.assert_empty()


def test_adapter_store_on_the_shared_taps(hybrid):
    """The tiered adapter store on the shared taps' unstacked (U, d, r)
    entries: three users through one resident row emit the all-resident
    engine's tokens, dense + f32 and paged + int8."""
    cfg, tcfg, _, tparams = hybrid
    prompts = _prompts(cfg.vocab_size, (7, 12, 5), seed=8)
    tbanks = [convert.adapters_from_numpy(b, device="cpu")
              for b in _banks(cfg, 3)]
    for opts in ({}, ENGINES["paged"]):
        outs = []
        for extra in ({}, dict(resident_slots=1)):
            eng = tserve.ServeEngine(tcfg, tparams, user_adapters=tbanks,
                                     slots=2, max_len=32, device="cpu",
                                     **opts, **extra)
            reqs = [tserve.Request(rid=i, user=i, prompt=p, max_new=4)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            assert all(r.status == "done" for r in reqs)
            outs.append([r.out for r in reqs])
            if extra:
                assert eng.store.bank["shared.attn.q"][
                    "A" if not opts else "A_q"].shape[0] == 1
        assert outs[0] == outs[1]
