"""The MoE blocks and QK-norm in the port, against the JAX package on the
CPU: the reduced f32 qwen3-moe-30b-a3b (8 experts, top 2, QK-norm) and
dbrx-132b (8 experts, top 2), JAX's weights carried across by
``repro_torch.convert``, numpy inputs from a seed fed to both. The router
(weights, experts, aux loss); each dispatch (einsum in row groups and in
groups that span rows, sort, dense) at the configs' capacity factor 1.25,
where tokens are dropped, and dropless at 8.0, outputs and gradients;
QK-norm attention at prefill and decode; forward, the loss with the aux,
prefill -> decode; Mode A's server step and fit gradients, Mode B, Prop 1;
the dense and the paged + chunked + int8 engines' tokens; the moe case of
JAX's plan sweep; ports of JAX's MoE smoke tests; tap sites and the init
tree. Every JAX engine run sits in a module-scoped fixture.

Tolerances (f32, sums in another order): the MoE function and its
gradients rtol 1e-5 with an atol of 1e-5 of the largest entry; model
logits rtol 1e-4 / atol 1e-5 and caches atol 5e-5, as in
test_torch_pairs.py; losses rtol 1e-5; server-step and Mode B gradients
rtol 1e-4 with an atol of 1e-4 of the largest entry, as in
test_torch_pairs_train.py; Prop 1 at test_gl_equivalence.py's rtol 2e-4 /
atol 1e-6; chunked against unchunked logits atol 1e-3, as JAX's own sweep.
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
from repro.models import attention as JA  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.runtime import kv_pager as tpager  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from tests.conftest import make_batch  # noqa: E402

MOE = ("qwen3-moe-30b-a3b", "dbrx-132b")
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_KV = dict(rtol=1e-4, atol=5e-5)
TAPS = ("layers.attn.q", "layers.attn.v")
IMPLS = ("einsum", "sort", "dense")
ENGINE_KW = dict(slots=3, max_len=64, max_new=5)
ENGINES = {"dense": {},
           "paged": dict(prefill_chunk=4, kv_layout="paged", kv_block=8,
                         bank_store="int8")}
PROMPT_LENS = (3, 21, 9, 33, 17)


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


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p in lens]


def _pair(name, **over):
    cfg = registry.reduced_config(name).replace(**over)
    tcfg = tregistry.reduced_config(name).replace(**over)
    params = M.init(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, convert.params_from_numpy(tcfg, _np(params),
                                                        device="cpu")


@pytest.fixture(scope="module", params=MOE)
def model_pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def qwen3():
    return _pair("qwen3-moe-30b-a3b")


# ---------------------------------------------------------------------------
# the MoE function: router and dispatches
# ---------------------------------------------------------------------------

E, K, D, DE = 8, 2, 128, 64


@pytest.fixture(scope="module")
def moe_params():
    p = _np(JMOE.moe_init(jax.random.PRNGKey(5), D, E, DE, jnp.float32))
    x = np.random.default_rng(5).normal(size=(2, 24, D)).astype(np.float32)
    return p, x


def test_route_matches_jax(moe_params):
    """Renormalised top-k weights, expert ids (in JAX's descending order)
    and the switch aux loss."""
    p, x = moe_params
    w, idx, aux = JMOE._route(p, jnp.asarray(x), K)
    tw, tidx, taux = TMOE._route(_t(p), _t(x), K)
    assert np.array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


def _dropped(idx: np.ndarray, C: int, group: int | None) -> int:
    """Choices past their expert's capacity C: counted choice by choice per
    group of ``group`` tokens (einsum), or over all tokens (sort)."""
    flat = idx.reshape(-1, idx.shape[-1])
    groups = ([flat] if group is None else
              [flat[i:i + group] for i in range(0, len(flat), group)])
    out = 0
    for g in groups:
        counts = np.bincount(g.T.reshape(-1), minlength=E)
        out += int(np.maximum(counts - C, 0).sum())
    return out


# (impl, group): the einsum dispatch in row groups (48 tokens do not fill
# 512) and in groups of 16 that span the two 24-token rows
CASES = [("einsum", 512), ("einsum", 16), ("sort", None), ("dense", None)]


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("impl,group", CASES)
def test_dispatch_matches_jax(moe_params, impl, group, cf):
    """Output, aux, and the gradients of sum(out * r) + aux with respect to
    x and the router (through the softmax's weights and the aux's mean
    probabilities; the one-hots carry none) and the experts. At 1.25 the
    einsum and sort dispatches drop tokens (asserted, and the output
    differs from the dropless one); at 8.0 none are dropped."""
    p, x = moe_params
    r = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    kw = dict(top_k=K, impl=impl, capacity_factor=cf)
    if group:
        kw["group"] = group

    def jloss(pp, xx):
        out, aux = JMOE.moe_block(pp, xx, **kw)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p),
                                              jnp.asarray(x))
    tp = {k: ({n: a.requires_grad_() for n, a in v.items()}
              if isinstance(v, dict) else v.requires_grad_())
          for k, v in _t(p).items()}
    tx = _t(x).requires_grad_()
    tout, taux = TMOE.moe_block(tp, tx, **kw)
    (tout * _t(r)).sum().add(taux).backward()
    _close(tout.detach().numpy(), out, 1e-5, f"{impl} out")
    np.testing.assert_allclose(float(taux.detach()), float(aux), rtol=1e-5)
    _close(tx.grad.numpy(), gx, 1e-5, f"{impl} dx")
    _close({k: ({n: a.grad.numpy() for n, a in v.items()}
                if isinstance(v, dict) else v.grad.numpy())
            for k, v in tp.items()}, _np(gp), 1e-5, f"{impl} dparams")
    assert np.abs(np.asarray(gp["router"]["w"])).max() > 0

    if impl == "dense":
        return
    _, idx, _ = TMOE._route(_t(p), _t(x), K)
    T = x.shape[0] * x.shape[1]
    G = (group if T % group == 0 else x.shape[1]) if group else None
    C = max(K, -(-int((G or T) * K * cf) // E))
    dropped = _dropped(idx.numpy(), C, G)
    if cf == 8.0:
        assert dropped == 0
    else:
        assert dropped > 0, (impl, group, C)
        free, _ = TMOE.moe_block(_t(p), _t(x), **{**kw, "capacity_factor": 8.0})
        assert not torch.allclose(tout.detach(), free)


def test_qk_norm_attention_matches_jax():
    """QK-norm (RMS over d_head at eps 1e-6, before RoPE) in the prefill
    and the decode path: outputs and the cache's K/V equal JAX's."""
    cfg = registry.reduced_config("qwen3-moe-30b-a3b")
    assert cfg.qk_norm
    rng = np.random.default_rng(8)
    H, Kv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = _np(JA.attn_init(jax.random.PRNGKey(8), cfg.d_model, H, Kv, Dh,
                         jnp.float32, qk_norm=True))
    p["q_norm"]["scale"] = rng.normal(size=Dh).astype(np.float32)
    p["k_norm"]["scale"] = rng.normal(size=Dh).astype(np.float32)
    kw = dict(n_heads=H, n_kv=Kv, d_head=Dh, rope_theta=cfg.rope_theta,
              qk_norm=True)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)[None]
    y, k, v = jax.jit(functools.partial(JA.attention_prefill, **kw))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos))
    ty, tk, tv = TA.attention_prefill(_t(p), _t(x), _t(pos), **kw)
    for got, want in ((ty, y), (tk, k), (tv, v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # without the norm the outputs differ
    y0, _, _ = TA.attention_prefill(_t(p), _t(x), _t(pos),
                                    **{**kw, "qk_norm": False})
    assert not torch.allclose(y0, ty)
    # a tick after the prefill, into a dense cache of 16
    kc = np.zeros((2, 16, Kv, Dh), np.float32)
    kc[:, :12], vc = np.asarray(k), np.zeros_like(kc)
    vc[:, :12] = np.asarray(v)
    xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    positions = np.array([12, 12], np.int32)
    yd, kd, vd = jax.jit(functools.partial(JA.attention_decode, **kw))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(xt), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(positions))
    tkc, tvc = _t(kc), _t(vc)
    write = TA.kv_write_plan(_t(positions), 1, None, smax=16)
    tyd = TA.attention_decode(_t(p), _t(xt), tkc, tvc, _t(positions),
                              kv_write=write, **kw)
    np.testing.assert_allclose(tyd.numpy(), np.asarray(yd), **TOL)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(kd), **TOL_KV)
    np.testing.assert_allclose(tvc.numpy(), np.asarray(vd), **TOL_KV)


# ---------------------------------------------------------------------------
# structure: configs, parameters, taps
# ---------------------------------------------------------------------------

def test_init_tree_shapes_and_dtypes_match_jax(model_pair):
    """JAX's MoE pytree (router, experts, q_norm / k_norm, no "mlp")
    crosses ``convert`` leaf for leaf; the port's own init has the same
    tree, shapes and dtypes (bf16 too, at the config's own dtype)."""
    cfg, tcfg, params, tparams = model_pair
    assert set(tparams["layers"]) == {"ln1", "attn", "ln2", "moe"}
    assert set(tparams["layers"]["moe"]) == {"router", "gate", "up", "down"}
    assert ({"q_norm", "k_norm"} <= set(tparams["layers"]["attn"])) == cfg.qk_norm
    for tc, jc in ((tcfg, cfg), (tcfg.replace(param_dtype="bfloat16"),
                                 cfg.replace(param_dtype="bfloat16"))):
        jp = jax.eval_shape(lambda: M.init(jc, jax.random.PRNGKey(0)))
        mine = TM.init(tc, seed=0, device="cpu")
        jleaves = jax.tree_util.tree_leaves_with_path(jp)
        assert len(jleaves) == len(tree_leaves(mine))
        for path, leaf in jleaves:
            got = mine
            for p in path:
                got = got[p.key]
            assert tuple(got.shape) == leaf.shape, path
            assert str(got.dtype).replace("torch.", "") == str(leaf.dtype), path
    w = TM.init(tcfg, seed=0, device="cpu")["layers"]["moe"]["gate"]
    assert abs(float(w.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05


def test_tap_sites_match_jax_without_mlp_sites(model_pair):
    cfg, tcfg, _, _ = model_pair
    js, ts = M.tap_sites(cfg), TM.tap_sites(tcfg)
    assert list(ts) == list(js) == ["layers.attn.q", "layers.attn.k",
                                    "layers.attn.v", "layers.attn.o"]
    for n in js:
        assert (ts[n].d_in, ts[n].d_out, ts[n].stacked) == \
            (js[n].d_in, js[n].d_out, js[n].stacked), n


def test_require_ported_takes_moe_and_names_the_rest():
    """The MoE configs run; the rest still raise, naming the current
    ROADMAP item."""
    for name in MOE:
        assert TM._require_ported(tregistry.get_config(name)) == \
            ("uniform", "attn")
    for name, item in (("mamba2-370m", "A.2"), ("zamba2-7b", "A.3"),
                       ("musicgen-medium", "A.4"), ("pixtral-12b", "A.4")):
        cfg = tbase.ModelConfig(**dataclasses.asdict(registry.get_config(name)))
        with pytest.raises(NotImplementedError, match=rf"ROADMAP.md {item}\)"):
            TM._require_ported(cfg)


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill -> decode
# ---------------------------------------------------------------------------

def test_forward_loss_and_prefill_decode_match_jax(model_pair):
    """Logits, the mean aux, the loss with aux_loss_coef times it;
    prefill's last logits and K/V, then a 4-token chunk and a tick from the
    prefilled dense cache (a dead row): logits and caches."""
    cfg, tcfg, params, tparams = model_pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab_size, (2, 24)).astype(np.int32)
    lg, aux = _jit(M.forward, cfg)(params, {"tokens": jnp.asarray(toks)})
    tlg, taux = TM.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    np.testing.assert_allclose(float(taux["moe_aux"]), float(aux["moe_aux"]),
                               rtol=1e-5)
    assert float(taux["moe_aux"]) > 0
    batch = {"tokens": toks, "labels": labels}
    loss, _ = _jit(M.loss_fn, cfg)(params, jax.tree.map(jnp.asarray, batch))
    tloss, _ = TM.loss_fn(tcfg, tparams, _t(batch))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    ce = TM.lm_loss(tcfg, tparams, TM.hidden_states(tcfg, tparams,
                                                    _t(batch))[0], _t(labels))
    np.testing.assert_allclose(float(tloss - ce),
                               tcfg.aux_loss_coef * float(taux["moe_aux"]),
                               rtol=1e-4)

    slots, max_len, S = 3, 40, 18
    _, pre = _jit(M.prefill, cfg)(params, {"tokens": jnp.asarray(toks[:, :S])})
    _, tpre = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks[:, :S])})
    for n in ("k", "v"):
        np.testing.assert_allclose(tpre["layers"][n].numpy(),
                                   np.asarray(pre["layers"][n]), **TOL_KV)
    ids = np.array([0, 1], np.int32)
    cache = M.scatter_prefill_cache(M.init_cache(cfg, slots, max_len), pre,
                                    jnp.asarray(ids))
    tcache = TM.scatter_prefill_cache(
        TM.init_cache(tcfg, slots, max_len, device="cpu"), tpre, ids)
    live = np.array([True, True, False])
    for c, pos in ((4, [S, S, 0]), (1, [S + 4, S + 4, 0])):
        step = {"tokens": rng.integers(0, cfg.vocab_size, (3, c)).astype(np.int32),
                "positions": np.array(pos, np.int32)}
        lg, cache = _jit(M.decode_step, cfg)(
            params, jax.tree.map(jnp.asarray, step), cache,
            live=jnp.asarray(live))
        tlg, tcache = TM.decode_step(tcfg, tparams, _t(step), tcache,
                                     live=torch.as_tensor(live))
        np.testing.assert_allclose(tlg.numpy()[live], np.asarray(lg)[live],
                                   **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache["layers"][n].numpy(),
                                       np.asarray(cache["layers"][n]), **TOL_KV)


# ---------------------------------------------------------------------------
# JAX's MoE smoke tests, ported
# ---------------------------------------------------------------------------

def test_moe_dispatch_impls_agree():
    """tests/test_models_smoke.py::test_moe_dispatch_impls_agree in the
    port: at capacity factor 8.0 the einsum, sort and dense impls give the
    same logits (its atol 2e-5), and the same as JAX's."""
    cfg, tcfg, params, tparams = _pair("qwen3-moe-30b-a3b",
                                       capacity_factor=8.0)
    batch = make_batch(cfg, 2, 32, jax.random.PRNGKey(2))
    want, _ = _jit(M.forward, cfg)(params, batch)
    tb = _t(_np(batch))
    out = {impl: TM.forward(tcfg.replace(moe_impl=impl), tparams, tb)[0]
           for impl in IMPLS}
    for impl in ("sort", "dense"):
        np.testing.assert_allclose(out["einsum"].numpy(), out[impl].numpy(),
                                   atol=2e-5)
    np.testing.assert_allclose(out["einsum"].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", MOE)
def test_smoke_forward_and_train_step(name):
    """tests/test_models_smoke.py::test_smoke_forward_and_train_step for the
    MoE configs in the port: logits (2, 32, V) without NaN equal to JAX's,
    and one Mode B step with a finite loss and finite adapter grads equal
    to JAX's."""
    cfg, tcfg, params, tparams = _pair(name)
    key = jax.random.PRNGKey(0)
    batch = make_batch(cfg, 2, 32, key)
    logits, _ = _jit(M.forward, cfg)(params, batch)
    tb = _t(_np(batch))
    tlogits, _ = TM.forward(tcfg, tparams, tb)
    assert tuple(tlogits.shape) == (2, 32, cfg.vocab_size)
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


# ---------------------------------------------------------------------------
# the GL steps
# ---------------------------------------------------------------------------

def _adapters(cfg):
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=4)
    ad = gl.init_adapters(cfg, cc, jax.random.PRNGKey(2))
    ad = jax.tree.map(lambda a: a + 0.02 * jax.random.normal(
        jax.random.PRNGKey(7), a.shape), ad)
    return cc, _np(ad)


def test_server_step_a_fit_grads_and_mode_b_match_jax(qwen3):
    """At the config's capacity factor 1.25: Mode A's loss (the aux
    included) and (x, grad_h) at both taps, the fit gradients, and Mode B's
    loss and adapter gradients, against JAX's."""
    cfg, tcfg, params, tparams = qwen3
    cc, ad = _adapters(cfg)
    batch = _np(make_batch(cfg, 2, 24, jax.random.PRNGKey(3)))
    spec = gl.make_spec(cfg, cc)
    loss, data, _ = _jit(gl.server_step_a, cfg, spec)(
        params, jax.tree.map(jnp.asarray, ad), jax.tree.map(jnp.asarray, batch))
    fit = _jit(gl.fit_grads, spec)(jax.tree.map(jnp.asarray, ad), data)
    tcc = tbase.ColaConfig(**dataclasses.asdict(cc))
    tspec = tgl.make_spec(tcfg, tcc)
    tad = convert.adapters_from_numpy(ad, device="cpu")
    tloss, tdata, _ = tgl.server_step_a(tcfg, tspec, tparams, tad, _t(batch))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    assert tuple(sorted(tdata)) == tuple(sorted(data)) == TAPS
    for tap in TAPS:
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


def test_prop1_mode_a_equals_mode_b():
    """The qwen3 case of tests/test_gl_equivalence.py::
    test_prop1_mode_a_equals_mode_b in the port (capacity factor 8.0,
    batch 2 x 16, its tolerances)."""
    cfg, tcfg, _, tparams = _pair("qwen3-moe-30b-a3b", capacity_factor=8.0)
    cc, ad = _adapters(cfg)
    batch = _t(_np(make_batch(cfg, 2, 16, jax.random.fold_in(
        jax.random.PRNGKey(1), 3))))
    tcc = tbase.ColaConfig(**dataclasses.asdict(cc))
    tad = convert.adapters_from_numpy(ad, device="cpu")
    spec_a = tgl.make_spec(tcfg, tcc)
    loss_a, data, _ = tgl.server_step_a(tcfg, spec_a, tparams, tad, batch)
    ga = tgl.fit_grads(spec_a, tad, data)
    loss_b, gb, _ = tgl.train_step_b(
        tcfg, tgl.make_spec(tcfg, dataclasses.replace(tcc, mode="fused_fit")),
        tparams, tad, batch)
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-6)
    for tap in gb:
        for leaf in gb[tap]:
            np.testing.assert_allclose(ga[tap][leaf].numpy(),
                                       gb[tap][leaf].numpy(), rtol=2e-4,
                                       atol=1e-6, err_msg=f"{tap}.{leaf}")


# ---------------------------------------------------------------------------
# engines against the JAX engine
# ---------------------------------------------------------------------------

def _banks(cfg):
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    key = jax.random.PRNGKey(0)
    out = []
    for u in range(2):   # both users' B nonzero (B is zero at init)
        ad = gl.init_adapters(cfg, cc, jax.random.fold_in(key, 1 + u))
        out.append(_np(jax.tree.map(lambda a: a + 0.3 * jax.random.normal(
            jax.random.fold_in(key, 10 + u), a.shape), ad)))
    return out


def _run(lib, cfg, params, banks, prompts, *, max_new, **kw):
    eng = lib.ServeEngine(cfg, params, user_adapters=banks, **kw)
    reqs = [lib.Request(rid=i, user=i % 2, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert all(r.status == "done" for r in reqs)
    return [r.out for r in reqs], eng


@pytest.fixture(scope="module")
def jax_engines(qwen3):
    cfg, _, params, _ = qwen3
    banks = [jax.tree.map(jnp.asarray, b) for b in _banks(cfg)]
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    return {name: _run(jserve, cfg, params, banks, prompts, **ENGINE_KW,
                       **opts)[0] for name, opts in ENGINES.items()}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_matches_jax(qwen3, jax_engines, name):
    """Five requests to three slots at the config's capacity factor 1.25:
    greedy tokens equal the JAX engine's, dense and paged + chunks of 4 +
    int8 bank."""
    cfg, tcfg, _, tparams = qwen3
    tbanks = [convert.adapters_from_numpy(b, device="cpu") for b in _banks(cfg)]
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    got, eng = _run(tserve, tcfg, tparams, tbanks, prompts, device="cpu",
                    **ENGINE_KW, **ENGINES[name])
    assert got == jax_engines[name]
    if eng.pager is not None:
        eng.pager.assert_empty()


# ---------------------------------------------------------------------------
# the port's own invariants: JAX's plan-sweep case for the MoE plan
# ---------------------------------------------------------------------------

def _tiny():
    """tests/test_paged_kv.py's qwen3 case: _tiny's widths at capacity
    factor 8.0 (its d_ff of 128 stays in the config, as there)."""
    return tregistry.reduced_config("qwen3-moe-30b-a3b").replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=128, capacity_factor=8.0)


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


def test_chunked_matches_prefill_and_paged_matches_dense():
    """The moe case (C 4, P 9, capacity factor 8.0) of
    tests/test_paged_kv.py::test_chunked_matches_prefill_and_paged_matches_dense
    in the port: chunked logits within its atol 1e-3 of the full prefill's
    and the same argmax; paged equal to dense chunked."""
    tcfg = _tiny()
    tparams = TM.init(tcfg, seed=0, device="cpu")
    C, P, slots, max_len, s = 4, 9, 3, 32, 1
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


def test_engine_chunked_and_paged_match_unchunked():
    """The moe case of tests/test_paged_kv.py::
    test_engine_chunked_and_paged_match_unchunked in the port: batched,
    chunked and paged engines emit the same tokens; the pool ends whole."""
    tcfg = _tiny()
    tparams = TM.init(tcfg, seed=0, device="cpu")
    prompts = _prompts(tcfg.vocab_size, (1, 5, 9, 14))
    kw = dict(device="cpu", slots=4, max_len=64)

    def run(**opts):
        eng = tserve.ServeEngine(tcfg, tparams, **kw, **opts)
        reqs = [tserve.Request(rid=i, user=0, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        assert all(r.status == "done" for r in reqs)
        return [r.out for r in reqs], eng

    base, _ = run(prefill_mode="batched")
    chunked, _ = run(prefill_chunk=4)
    paged, eng = run(prefill_chunk=4, kv_layout="paged", kv_block=8)
    assert chunked == base and paged == base
    eng.pager.assert_empty()
