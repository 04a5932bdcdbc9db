"""musicgen-medium's codebooks and untied head and pixtral-12b's embedding
input in the port, against the JAX package on the CPU: the reduced f32
configs (4 codebooks of 512 with an untied head; precomputed embeddings
with a separate ``unembed`` head), JAX's weights carried across by
``repro_torch.convert``, numpy inputs from a seed fed to both. The init
tree at full size (shapes, dtypes, parameter counts) and ``convert``'s
dtypes; forward; the loss with masked labels, chunked and not; prefill
with ``lengths``, a 4-wide chunk and a tick, dense and paged, with an f32
and an int8 multi-LoRA bank (logits and caches); Mode A's server step and
fit gradients, Mode B; one ``ColaSession`` step in Mode A (merged) and
Mode B; ``SyntheticLM``'s batches bit for bit; the engine refusing both
configs; ports of JAX's smoke tests for both.

Tolerances (f32, sums in another order): logits rtol 1e-4 / atol 1e-5 and
caches atol 5e-5, as test_torch_configs.py and test_torch_moe.py; losses
rtol 1e-5; gradients rtol 1e-4 with an atol of 1e-4 of the largest entry;
the session's adapters after a step rtol 1e-3 of the largest entry, as
test_torch_session.py; JAX's own tolerances in its ported tests.
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
from repro.core import session as jsession  # noqa: E402
from repro.core import taps as jtaps  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.core import taps as ttaps  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from tests.conftest import make_batch  # noqa: E402

NAMES = ("musicgen-medium", "pixtral-12b")
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_KV = dict(rtol=1e-4, atol=5e-5)
TAPS = ("layers.attn.q", "layers.attn.v")
# parameters of the full configs (JAX's eval_shape of M.init)
N_PARAMS = {"musicgen-medium": 1_837_254_144, "pixtral-12b": 11_576_693_760}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


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
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(1e-6, float(np.abs(want).max())),
                               err_msg=what)


def _jit(fn, *static):
    return jax.jit(functools.partial(fn, *static))


def _pair(name, **over):
    cfg = registry.reduced_config(name).replace(**over)
    tcfg = tregistry.reduced_config(name).replace(**over)
    params = M.init(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, convert.params_from_numpy(tcfg, _np(params),
                                                        device="cpu")


@pytest.fixture(scope="module", params=NAMES)
def model_pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module", params=NAMES)
def short_pair(request):
    """Two layers, for the decode, GL-step and session tests."""
    return _pair(request.param, n_layers=2)


def _inputs(cfg, rng, B, S) -> dict:
    """The model input of a batch: tokens (B, S, CB) or embeds (B, S, d)."""
    if cfg.embed_input:
        return {"embeds": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S, cfg.n_codebooks))
            .astype(np.int32)}


def _labels(cfg, rng, B, S) -> np.ndarray:
    """Labels (B, S) or (B, S, CB) with masked (-1) entries: the first five
    positions of row 0, and with codebooks one codebook alone at (1, 3)."""
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    y = rng.integers(0, cfg.vocab_size, (B, S) + cb).astype(np.int32)
    y[0, :5] = -1
    if cb:
        y[1, 3, 1] = -1
    return y


# ---------------------------------------------------------------------------
# init, convert, forward, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_init_tree_matches_jax(name):
    """The full config's tree on the meta device: JAX's leaves (musicgen
    ``embed.emb`` (4, 2048, 1536) and ``lm_head.w`` (1536, 8192); pixtral
    ``unembed.emb`` (131072, 5120) and no ``embed``), shapes and dtypes,
    and JAX's parameter count; then ``convert`` carries a reduced bf16
    tree across with every leaf in bf16 and JAX's values."""
    cfg, tcfg = registry.get_config(name), tregistry.get_config(name)
    want = jax.eval_shape(lambda: M.init(cfg, jax.random.PRNGKey(0)))
    got = TM.init(tcfg, device="meta")
    flat_w = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(flat_g) == sorted(flat_w)
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == w.shape, k
        assert str(flat_g[k].dtype) == f"torch.{w.dtype}", k
    assert sum(t.numel() for t in tree_leaves(got)) == N_PARAMS[name]
    if cfg.n_codebooks:
        assert got["embed"]["emb"].shape == (4, 2048, 1536)
        assert got["lm_head"]["w"].shape == (1536, 4 * 2048)
    else:
        assert "embed" not in got and "lm_head" not in got
        assert got["unembed"]["emb"].shape == (131072, 5120)

    rcfg = registry.reduced_config(name).replace(param_dtype="bfloat16")
    params = _np(M.init(rcfg, jax.random.PRNGKey(0)))
    tparams = convert.params_from_numpy(
        tregistry.reduced_config(name).replace(param_dtype="bfloat16"),
        params, device="cpu")
    for p, w in jax.tree_util.tree_flatten_with_path(params)[0]:
        t = functools.reduce(lambda d, k: d[k.key], p, tparams)
        assert t.dtype == torch.bfloat16, p
        assert np.array_equal(t.float().numpy(), np.asarray(w, np.float32)), p


def test_forward_matches_jax(model_pair):
    """Logits (2, 24, 4, V) from the summed codebooks through the untied
    head, or (2, 24, V) from embeddings through ``unembed``."""
    cfg, tcfg, params, tparams = model_pair
    x = _inputs(cfg, np.random.default_rng(1), 2, 24)
    lg, _ = _jit(M.forward, cfg)(params, jax.tree.map(jnp.asarray, x))
    tlg, _ = TM.forward(tcfg, tparams, _t(x))
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert tuple(tlg.shape) == (2, 24) + cb + (cfg.vocab_size,)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunk", [0, 8])
def test_loss_matches_jax(name, chunk):
    """The mean CE over valid (position, codebook) pairs with masked labels,
    whole and with ``loss_chunk`` 8 (three chunks of 24 positions, the
    labels' codebook axis kept): equal to JAX's, and the chunked loss to
    the whole one."""
    cfg, tcfg, params, tparams = _pair(name, n_layers=2, loss_chunk=chunk)
    rng = np.random.default_rng(2)
    batch = {**_inputs(cfg, rng, 2, 24), "labels": _labels(cfg, rng, 2, 24)}
    loss, _ = _jit(M.loss_fn, cfg)(params, jax.tree.map(jnp.asarray, batch))
    tloss, _ = TM.loss_fn(tcfg, tparams, _t(batch))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    whole, _ = TM.loss_fn(tcfg.replace(loss_chunk=0), tparams, _t(batch))
    np.testing.assert_allclose(float(tloss), float(whole), rtol=1e-6)


# ---------------------------------------------------------------------------
# prefill, chunk and tick with a multi-LoRA bank
# ---------------------------------------------------------------------------

def _user_banks(cfg):
    """Two users' rank-4 qv adapters with B != 0, as numpy."""
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    key = jax.random.PRNGKey(5)
    return [_np(jax.tree.map(lambda a: a + 0.3 * jax.random.normal(
        jax.random.fold_in(key, 10 + u), a.shape),
        gl.init_adapters(cfg, cc, jax.random.fold_in(key, u))))
        for u in range(2)]


def _cola_vars(cfg, tcfg, store):
    """(JAX's and the port's multi-LoRA spec, and a function of the users
    giving each package's cola_vars), the bank stacked as each engine
    stacks it, int8 through each package's ``quantize_bank``."""
    banks = _user_banks(cfg)
    jbank = jserve.stack_user_adapters([jax.tree.map(jnp.asarray, b)
                                        for b in banks])
    tbank = tserve.stack_user_adapters([convert.adapters_from_numpy(
        b, device="cpu") for b in banks])
    if store == "int8":
        jbank, tbank = jserve.quantize_bank(jbank), tserve.quantize_bank(tbank)
    jspec = jtaps.make_spec(family="multi_lowrank",
                            taps=gl.select_taps(cfg, "qv"), scale=1.0)
    tspec = ttaps.make_spec(family="multi_lowrank",
                            taps=tgl.select_taps(tcfg, "qv"), scale=1.0)

    def vars_(users):
        j = {tap: dict(e, idx=jnp.broadcast_to(jnp.asarray(users),
                                               (cfg.n_layers, len(users))))
             for tap, e in jbank.items()}
        t = {tap: dict(e, idx=torch.as_tensor(users).expand(
            tcfg.n_layers, -1)) for tap, e in tbank.items()}
        return {"adapters": j}, {"adapters": t}

    return jspec, tspec, vars_


def _step_input(cfg, rng, c, positions) -> dict:
    x = _inputs(cfg, rng, len(positions), c)
    return {**x, "positions": np.array(positions, np.int32)}


def _compare_steps(pair, jspec, tspec, vars_, cache, tcache, steps, **layout):
    """Each (batch, live, users) of ``steps`` through JAX's and the port's
    ``decode_step``: live rows' logits and the whole cache."""
    cfg, tcfg, params, tparams = pair
    for batch, live, users in steps:
        jv, tv = vars_(users)
        lg, cache = jax.jit(functools.partial(M.decode_step, cfg,
                                              spec=jspec))(
            params, jax.tree.map(jnp.asarray, batch), cache, cola_vars=jv,
            live=jnp.asarray(live),
            **{k: jnp.asarray(v) for k, v in layout.items()})
        tlg, tcache = TM.decode_step(tcfg, tparams, _t(batch), tcache, tspec,
                                     tv, live=torch.as_tensor(live),
                                     **{k: torch.as_tensor(v)
                                        for k, v in layout.items()})
        np.testing.assert_allclose(tlg.numpy()[live], np.asarray(lg)[live],
                                   **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache["layers"][n].numpy(),
                                       np.asarray(cache["layers"][n]),
                                       **TOL_KV)
    return tcache


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_prefill_chunk_tick_dense_match_jax(short_pair, store):
    """A right-padded prefill of two rows with ``lengths`` (16, 11) for
    users (0, 1): logits at each row's last position and the K/V; scattered
    into slots 0 and 2 of a 3-slot dense cache, then a 4-wide chunk and a
    tick with slot 1 dead: logits and the cache, slot 1 left zero."""
    cfg, tcfg, params, tparams = short_pair
    jspec, tspec, vars_ = _cola_vars(cfg, tcfg, store)
    rng = np.random.default_rng(3)
    x = _inputs(cfg, rng, 2, 16)
    lengths = np.array([16, 11], np.int32)
    jv, tv = vars_(np.array([0, 1], np.int32))
    lg, pre = jax.jit(functools.partial(M.prefill, cfg, spec=jspec))(
        params, jax.tree.map(jnp.asarray, x), cola_vars=jv,
        lengths=jnp.asarray(lengths))
    tlg, tpre = TM.prefill(tcfg, tparams, _t(x), tspec, tv,
                           lengths=torch.as_tensor(lengths))
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert tuple(tlg.shape) == (2, 1) + cb + (cfg.vocab_size,)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpre["layers"][n].numpy(),
                                   np.asarray(pre["layers"][n]), **TOL_KV)
    ids = np.array([0, 2], np.int32)
    cache = M.scatter_prefill_cache(M.init_cache(cfg, 3, 32), pre,
                                    jnp.asarray(ids))
    tcache = TM.scatter_prefill_cache(TM.init_cache(tcfg, 3, 32, device="cpu"),
                                      tpre, ids)
    live = np.array([True, False, True])
    users = np.array([0, 1, 1], np.int32)
    steps = [(_step_input(cfg, rng, 4, [16, 0, 11]), live, users),
             (_step_input(cfg, rng, 1, [20, 0, 15]), live, users)]
    tcache = _compare_steps(short_pair, jspec, tspec, vars_, cache, tcache,
                            steps)
    for n in ("k", "v"):
        assert not tcache["layers"][n][:, 1].any()


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_chunk_tick_paged_match_jax(short_pair, store):
    """A pool of 12 blocks of 8 with random contents through a shuffled
    table: a 4-wide chunk at positions (13, 0, 5), then a tick, slot 1
    dead: logits and the pool equal JAX's, and blocks no live row writes
    are left as they were."""
    cfg, tcfg, params, tparams = short_pair
    jspec, tspec, vars_ = _cola_vars(cfg, tcfg, store)
    rng = np.random.default_rng(4)
    slots, max_len, bs, n_blocks = 3, 32, 8, 12
    table = np.zeros((slots, max_len // bs), np.int32)
    perm = rng.permutation(n_blocks)
    table[0, :3] = perm[:3]
    table[1, :2] = perm[3:5]
    table[2, :2] = perm[5:7]
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.d_head)
    init = {"layers": {n: rng.normal(size=shape).astype(np.float32)
                       for n in ("k", "v")}}
    cache = jax.tree.map(jnp.asarray, init)
    tcache = _t(init)
    live = np.array([True, False, True])
    users = np.array([1, 0, 0], np.int32)
    steps = [(_step_input(cfg, rng, 4, [13, 0, 5]), live, users),
             (_step_input(cfg, rng, 1, [17, 0, 9]), live, users)]
    tcache = _compare_steps(short_pair, jspec, tspec, vars_, cache, tcache,
                            steps, block_table=table)
    written = {table[0, 1], table[0, 2], table[2, 0], table[2, 1]}
    for n in ("k", "v"):
        for blk in set(range(n_blocks)) - written:
            assert np.array_equal(tcache["layers"][n][:, blk].numpy(),
                                  init["layers"][n][:, blk]), blk


# ---------------------------------------------------------------------------
# the GL steps and the session
# ---------------------------------------------------------------------------

def _adapters(cfg):
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=4)
    ad = gl.init_adapters(cfg, cc, jax.random.PRNGKey(2))
    ad = jax.tree.map(lambda a: a + 0.02 * jax.random.normal(
        jax.random.PRNGKey(7), a.shape), ad)
    return cc, _np(ad)


def test_server_step_a_fit_grads_and_mode_b_match_jax(short_pair):
    """Mode A (unmerged) on a batch of tokens or embeddings: the loss,
    (x, grad_h) at both taps with grad_h (L, B, S, d_out) whatever the
    input, the fit gradients; Mode B's loss and adapter gradients."""
    cfg, tcfg, params, tparams = short_pair
    cc, ad = _adapters(cfg)
    rng = np.random.default_rng(6)
    batch = {**_inputs(cfg, rng, 2, 16), "labels": _labels(cfg, rng, 2, 16)}
    spec = gl.make_spec(cfg, cc)
    loss, data, _ = _jit(gl.server_step_a, cfg, spec)(
        params, jax.tree.map(jnp.asarray, ad), jax.tree.map(jnp.asarray, batch))
    fit = _jit(gl.fit_grads, spec)(jax.tree.map(jnp.asarray, ad), data)
    tcc = tbase.ColaConfig(**dataclasses.asdict(cc))
    tspec = tgl.make_spec(tcfg, tcc)
    tad = convert.adapters_from_numpy(ad, device="cpu")
    tloss, tdata, _ = tgl.server_step_a(tcfg, tspec, tparams, tad, _t(batch))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    assert tuple(sorted(tdata)) == TAPS
    for tap in TAPS:
        d_out = TM.tap_sites(tcfg)[tap].d_out
        assert tuple(tdata[tap][1].shape) == (tcfg.n_layers, 2, 16, d_out)
        _close(tdata[tap][0].numpy(), data[tap][0], what=f"{tap} x")
        _close(tdata[tap][1].numpy(), data[tap][1], what=f"{tap} grad_h")
        assert np.abs(np.asarray(data[tap][1])).max() > 0
    _close(_tnp(tgl.fit_grads(tspec, tad, tdata)), _np(fit), what="fit")

    spec_b = gl.make_spec(cfg, dataclasses.replace(cc, mode="fused_fit"))
    loss_b, grads_b, _ = _jit(gl.train_step_b, cfg, spec_b)(
        params, jax.tree.map(jnp.asarray, ad), jax.tree.map(jnp.asarray, batch))
    tloss_b, tgrads_b, _ = tgl.train_step_b(
        tcfg, tgl.make_spec(tcfg, dataclasses.replace(tcc, mode="fused_fit")),
        tparams, tad, _t(batch))
    np.testing.assert_allclose(float(tloss_b), float(loss_b), rtol=1e-5)
    _close(_tnp(tgrads_b), _np(grads_b), what="mode b")


@pytest.mark.parametrize("mode,merged", [("faithful_offload", True),
                                         ("fused_fit", False)])
def test_session_step_matches_jax(short_pair, mode, merged):
    """One ``ColaSession`` step (interval 1, AdamW) on a ``SyntheticLM``
    batch of codebook tokens or embeddings, both sessions from JAX's
    adapters: the loss and the adapters after the step."""
    cfg, tcfg, params, tparams = short_pair
    cc = ColaConfig(mode=mode, family="lowrank", taps="qv", rank=4,
                    merged=merged, interval=1)
    batch = jpipeline.SyntheticLM(cfg, batch=2, seq=16, seed=3).batch_at(0)
    js = jsession.ColaSession(cfg, cc, params, jax.random.PRNGKey(3), lr=1e-2)
    ts = tsession.ColaSession(tcfg, tbase.ColaConfig(**dataclasses.asdict(cc)),
                              tparams, lr=1e-2, device="cpu")
    ad = convert.adapters_from_numpy(_np(js.adapters), device="cpu")
    ts.adapters = ts.offloader.adapters = ts.channel.last_good = ad
    np.testing.assert_allclose(ts.step(batch), js.step(batch), rtol=1e-5)
    assert ts.offloader.stats["fits"] == 1 or mode == "fused_fit"
    _close(_tnp(ts.adapters), _np(js.adapters), rtol=1e-3, what=mode)


# ---------------------------------------------------------------------------
# data and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_synthetic_lm_matches_jax_bit_for_bit(name):
    """Four codebook streams drawn in turn and stacked last, or f32 stub
    embeddings and uniform labels, then user ids: equal to JAX's batches,
    at three steps and two hosts' shares."""
    cfg, tcfg = registry.reduced_config(name), tregistry.reduced_config(name)
    for host in (0, 1):
        kw = dict(batch=4, seq=12, seed=7, users=3, host_id=host, n_hosts=2)
        js = jpipeline.SyntheticLM(cfg, **kw)
        ts = tpipeline.SyntheticLM(tcfg, device="cpu", **kw)
        for step in range(3):
            want, got = js.batch_at(step), ts.numpy_batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), k
            tb = ts.batch_at(step)
            assert all(np.array_equal(tb[k].numpy(), want[k]) for k in want)
    x = "embeds" if cfg.embed_input else "tokens"
    cb = () if cfg.embed_input else (cfg.n_codebooks,)
    assert want[x].shape == (2, 12) + ((cfg.d_model,) if cfg.embed_input
                                       else cb)
    assert want["labels"].shape == (2, 12) + cb


@pytest.mark.parametrize("name", NAMES)
def test_engine_refuses_codebooks_and_embeddings(name):
    """The engine serves (P,) token prompts, as JAX's: both configs are
    refused at construction, before any device call."""
    tcfg = tregistry.reduced_config(name).replace(n_layers=1)
    tparams = TM.init(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match=r"serves \(P,\) token prompts"):
        tserve.ServeEngine(tcfg, tparams, slots=2, max_len=16, device="cpu")


# ---------------------------------------------------------------------------
# JAX's smoke tests, ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_smoke_forward_and_train_step(name):
    """tests/test_models_smoke.py::test_smoke_forward_and_train_step for
    musicgen-medium and pixtral-12b in the port: logits (2, 32, 4, V) or
    (2, 32, V) without NaN equal to JAX's, and one Mode B step with a
    finite loss and finite adapter grads equal to JAX's."""
    cfg, tcfg, params, tparams = _pair(name)
    key = jax.random.PRNGKey(0)
    batch = make_batch(cfg, 2, 32, key)
    logits, _ = _jit(M.forward, cfg)(params, batch)
    tb = _t(_np(batch))
    tlogits, _ = TM.forward(tcfg, tparams, tb)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert tuple(tlogits.shape) == (2, 32) + cb + (cfg.vocab_size,)
    assert not torch.isnan(tlogits).any()
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), **TOL)
    cc = ColaConfig(mode="fused_fit", family="lowrank", taps="qv", rank=4)
    adapters = gl.init_adapters(cfg, cc, key)
    loss, grads, _ = _jit(gl.train_step_b, cfg, gl.make_spec(cfg, cc))(
        params, adapters, batch)
    tcc = tbase.ColaConfig(**dataclasses.asdict(cc))
    tloss, tgrads, _ = tgl.train_step_b(
        tcfg, tgl.make_spec(tcfg, tcc), tparams,
        convert.adapters_from_numpy(_np(adapters), device="cpu"), tb)
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    for leaf in tree_leaves(tgrads):
        assert torch.isfinite(leaf).all()
    _close(_tnp(tgrads), _np(grads), what=f"{name} grads")


def test_musicgen_prefill_decode_matches_forward():
    """tests/test_models_smoke.py::test_prefill_decode_matches_forward
    [musicgen-medium] in the port (reduced config, B 2, S 16, 4 codebooks):
    prefill's logits equal the forward's at S - 1 (rtol / atol 1e-4), and
    a tick from the prefill's K/V grafted into a longer cache equals the
    forward's at S (rtol 1e-4, atol 2e-4); the forward also against
    JAX's."""
    cfg, tcfg, params, tparams = _pair("musicgen-medium")
    key = jax.random.PRNGKey(1)
    B, S = 2, 16
    toks = np.array(jax.random.randint(key, (B, S + 1, cfg.n_codebooks), 0,
                                       cfg.vocab_size))
    want, _ = _jit(M.forward, cfg)(params, {"tokens": jnp.asarray(toks)})
    full, _ = TM.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)
    pre, cache = TM.prefill(tcfg, tparams,
                            {"tokens": torch.as_tensor(toks[:, :S])})
    np.testing.assert_allclose(pre[:, 0].numpy(), full[:, S - 1].numpy(),
                               rtol=1e-4, atol=1e-4)
    cache2 = TM.scatter_prefill_cache(
        TM.init_cache(tcfg, B, S + 8, device="cpu"), cache, np.arange(B))
    step = {"tokens": torch.as_tensor(toks[:, S:S + 1]),
            "positions": torch.full((B,), S, dtype=torch.int32)}
    dec, cache3 = TM.decode_step(tcfg, tparams, step, cache2)
    assert tuple(dec.shape) == (B, 1, cfg.n_codebooks, cfg.vocab_size)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, S].numpy(),
                               rtol=1e-4, atol=2e-4)
    assert {s: sorted(e) for s, e in cache3.items()} == \
        {s: sorted(e) for s, e in cache2.items()}
