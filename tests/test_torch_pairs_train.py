"""ColA training on gemma2's local/global pairs plan in the port, against the
JAX package on the CPU: the reduced f32 gemma2-9b (2 pairs, d_model 128,
local window 16, softcaps 50 / 30), JAX's weights and adapters carried
across by ``repro_torch.convert``, the same numpy batches (seq 32, so the
local window masks) fed to both. Mode A's server step (merged and not: the
loss, x and grad_h at the four taps of both stacks), the fit gradients,
Mode B's and full fine-tuning's gradients, ``ColaSession`` in all five
modes, a K = 2 ``CollabSession`` step (its row masks over both stacks), Prop
1 on the pairs plan, and the port of JAX's
``test_smoke_forward_and_train_step[gemma2-9b]``; and gemma2's d_head 256
in the flash backward (plain version and the autograd Function) against
``jax.vjp`` of the Pallas kernel in interpret mode. Every JAX run sits in a
module-scoped fixture.

Tolerances (f32): the flash backward rtol = atol = 1e-5 (one formula, sums
in another order); model-level losses and gradients rtol = 1e-4 with an
atol of 1e-4 of the largest entry (XLA's CPU matmuls and PyTorch's through
4 layers, the softcaps and the head), as in test_torch_training.py; session
losses rtol 1e-4 and banks 1e-3 (5e-3 with int8 transfer, under SGD:
``INT8_RTOL`` says why), as in test_torch_session.py; Prop 1 at
test_gl_equivalence.py's rtol 2e-4 (5e-3 through the merged pass, as in
test_torch_training.py).
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
from repro.core import collab as jcollab  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.core import merge as jmerge  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import collab as tcollab  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from tests.conftest import make_batch  # noqa: E402

KTOL = dict(rtol=1e-5, atol=1e-5)
TAPS = ("layers_a.attn.q", "layers_a.attn.v", "layers_b.attn.q",
        "layers_b.attn.v")
FAMILIES = ("lowrank", "linear", "mlp")
MODES = {   # ColaSession's five modes, as test_torch_session.py runs them
    "offload-merged": dict(mode="faithful_offload", merged=True, interval=2),
    # int8 transfer, under SGD (see INT8_RTOL)
    "offload-int8": dict(mode="faithful_offload", compress="int8"),
    "fused_fit": dict(mode="fused_fit", interval=2),
    "lora": dict(mode="lora"),
    "ft": dict(mode="ft"),
}
D256_MASKS = [(None, None), (24, 50.0)]
# int8 transfer: grad_h agrees with JAX's to 2e-7, but a code half-way
# between two steps rounds either way, which moves that entry by 1/127 of its
# row's max (~1 % of the q taps' rows differ by a code). AdamW's first steps
# follow the gradient's sign, so there a flipped sign moves an entry by 2 lr;
# the int8 mode runs SGD at the same lr, whose update is linear in the
# gradient: its banks measured within 3.2e-3 of the largest entry of JAX's,
# inside test_torch_session.py's int8 tolerance
INT8_RTOL = 5e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


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


def _jit(fn, *static):
    return jax.jit(functools.partial(fn, *static))


def _adapters(cfg, family, *, noise=0.02, rank=4, hidden=16):
    """JAX-initialised adapters plus noise (B != 0, so dA is informative),
    as numpy, for both packages."""
    cc = ColaConfig(mode="faithful_offload", family=family, taps="qv",
                    rank=rank, hidden=hidden)
    ad = gl.init_adapters(cfg, cc, jax.random.PRNGKey(2))
    ad = jax.tree.map(lambda a: a + noise * jax.random.normal(
        jax.random.PRNGKey(7), a.shape), ad)
    return cc, _np(ad)


def _tspec(tcfg, cc):
    return tgl.make_spec(tcfg, tbase.ColaConfig(**dataclasses.asdict(cc)))


@pytest.fixture(scope="module")
def setup():
    cfg = registry.reduced_config("gemma2-9b")
    tcfg = tregistry.reduced_config("gemma2-9b")
    assert cfg.attn_pattern == "local_global" and cfg.local_window == 16
    params = M.init(cfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    stream = jpipeline.SyntheticLM(cfg, batch=2, seq=32, seed=3)
    batches = [stream.batch_at(i) for i in range(3)]
    return cfg, tcfg, params, tparams, batches


# ---------------------------------------------------------------------------
# the JAX package's runs, once each
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(setup):
    """Mode A's server step (unmerged and merged; x and grad_h per tap), the
    fit gradients of each family, Mode B's and full FT's gradients."""
    cfg, _, params, _, batches = setup
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
    for family in FAMILIES:
        c, a = _adapters(cfg, family)
        spec = gl.make_spec(cfg, c)
        _, data, _ = _jit(gl.server_step_a, cfg, spec)(params, a, batches[0])
        out[("fit", family)] = (a, _np(data),
                                _np(_jit(gl.fit_grads, spec)(a, data)))
    spec_b = gl.make_spec(cfg, dataclasses.replace(cc, mode="fused_fit"))
    loss, grads, _ = _jit(gl.train_step_b, cfg, spec_b)(params, ad, batches[1])
    out["b"] = (float(loss), _np(grads))
    loss, grads, _ = _jit(gl.train_step_ft, cfg)(params, batches[1])
    out["ft"] = (float(loss), _np(grads))
    return out


@pytest.fixture(scope="module")
def jax_sessions(setup):
    """Each mode's JAX session over the three batches: its initial adapters,
    losses, final adapters and eval loss."""
    cfg, _, params, _, batches = setup
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


COLLAB = dict(mode="faithful_offload", family="lowrank", taps="qv", rank=4,
              merged=True, interval=1, users=2)


def _collab_batches(cfg):
    data = jpipeline.SyntheticLM(cfg, batch=4, seq=32, seed=2, users=2)
    return [data.batch_at(i) for i in range(2)]


@pytest.fixture(scope="module")
def jax_collab(setup):
    """A K = 2 merged CollabSession, two steps: initial banks, losses, banks."""
    cfg, _, params, _, _ = setup
    js = jcollab.CollabSession(cfg, ColaConfig(**COLLAB), params,
                               jax.random.PRNGKey(4), optimizer=jopt.sgd(0.1))
    init = [_np(o.adapters) for o in js.offloaders]
    losses = []
    for b in _collab_batches(cfg):
        b = dict(b)
        uid = b.pop("user_id")
        losses.append(js.train_step({k: jnp.asarray(v) for k, v in b.items()},
                                    jnp.asarray(uid)))
    return init, losses, [_np(ch.adapters) for ch in js.channels]


@pytest.fixture(scope="module")
def jax_flash_d256():
    """jax.vjp of the Pallas flash kernel (interpret mode) at d_head 256,
    2 x 64, 4 / 2 heads, per (window, softcap) of D256_MASKS."""
    rng = np.random.default_rng(10)
    B, S, H, K, D = 2, 64, 4, 2, 256
    ins = tuple(rng.standard_normal((B, S, n, D)).astype(np.float32)
                for n in (H, K, K, H))
    out = {}
    for window, softcap in D256_MASKS:
        o_j, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
            a, b, c, window=window, softcap=softcap, interpret=True),
            *(jnp.asarray(a) for a in ins[:3]))
        out[window, softcap] = (np.asarray(o_j),
                                _np(vjp(jnp.asarray(ins[3]))))
    return ins, out


@pytest.fixture(scope="module")
def jax_smoke(setup):
    """JAX's test_smoke_forward_and_train_step[gemma2-9b]: its batch,
    logits, and Mode B step (loss and adapter grads)."""
    cfg = setup[0]
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    batch = make_batch(cfg, 2, 32, key)
    logits, _ = M.forward(cfg, params, batch)
    cc = ColaConfig(mode="fused_fit", family="lowrank", taps="qv", rank=4)
    spec = gl.make_spec(cfg, cc)
    adapters = gl.init_adapters(cfg, cc, key)
    loss, grads, _ = gl.train_step_b(cfg, spec, params, adapters, batch)
    return (_np(params), _np(batch), np.asarray(logits), _np(adapters),
            float(loss), _np(grads))


# ---------------------------------------------------------------------------
# the flash backward at d_head 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap", D256_MASKS)
def test_d256_flash_backward_matches_pallas_vjp(jax_flash_d256, window,
                                                softcap):
    """ref.sdpa_bwd and FlashAttention (plain versions on the CPU) at
    gemma2's d_head 256, with and without window 24 + softcap 50."""
    (q, k, v, do), out = jax_flash_d256
    o_j, want = out[window, softcap]
    S = q.shape[1]
    pos = torch.arange(S, dtype=torch.int32)[None]
    assert 256 in fa.BWD_HEAD_DIMS
    o, lse = fa.flash_attention(_t(q), _t(k), _t(v), window=window,
                                softcap=softcap)
    np.testing.assert_allclose(o.numpy(), o_j, **KTOL)
    got = ref.sdpa_bwd(_t(q), _t(k), _t(v), o, lse, _t(do), q_positions=pos,
                       kv_positions=pos, window=window, softcap=softcap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **KTOL)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    o = ops.sdpa(qt, kt, vt, q_positions=pos, kv_positions=pos,
                 window=window, softcap=softcap)
    assert "FlashAttention" in type(o.grad_fn).__name__
    o.backward(_t(do))
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), w, **KTOL)


# ---------------------------------------------------------------------------
# the GL steps on the pairs plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merged", [False, True])
def test_server_step_a_matches_jax(setup, jax_steps, merged):
    """Loss and (x, grad_h) at all four taps (q and v of both stacks)."""
    cfg, tcfg, _, tparams, batches = setup
    loss, data = jax_steps[("a", merged)]
    ad = jax_steps["adapters"]
    cc, _ = _adapters(cfg, "lowrank")
    tspec = _tspec(tcfg, dataclasses.replace(cc, merged=merged))
    tad = convert.adapters_from_numpy(ad, device="cpu")
    tp, tin = tparams, tad
    if merged:
        fams = dict(gl.make_spec(cfg, cc).families)
        tp, tin = tmerge.merged_params(tcfg, tparams, fams, tad, cc.scale), {}
    tloss, tdata, _ = tgl.server_step_a(tcfg, tspec, tp, tin,
                                        _tb(batches[0]))
    _close(float(tloss), loss, what="loss")
    assert tuple(sorted(tdata)) == tuple(sorted(data)) == TAPS
    for tap in TAPS:
        assert tuple(tdata[tap][0].shape) == data[tap][0].shape
        assert tuple(tdata[tap][1].shape) == data[tap][1].shape
        _close(tdata[tap][0].numpy(), data[tap][0], what=f"{tap} x")
        _close(tdata[tap][1].numpy(), data[tap][1], what=f"{tap} grad_h")
        assert np.abs(data[tap][1]).max() > 0   # every tap gets a gradient


@pytest.mark.parametrize("family", FAMILIES)
def test_fit_grads_match_jax(setup, jax_steps, family):
    _, tcfg, _, _, _ = setup
    ad, data, want = jax_steps[("fit", family)]
    cc, _ = _adapters(setup[0], family)
    got = tgl.fit_grads(_tspec(tcfg, cc),
                        convert.adapters_from_numpy(ad, device="cpu"),
                        {t: (_t(x), _t(g)) for t, (x, g) in data.items()})
    assert tuple(sorted(got)) == TAPS
    _close(_tnp(got), want, rtol=1e-5, what=family)


def test_train_step_b_and_ft_match_jax(setup, jax_steps):
    cfg, tcfg, _, tparams, batches = setup
    cc, _ = _adapters(cfg, "lowrank")
    tad = convert.adapters_from_numpy(jax_steps["adapters"], device="cpu")
    tloss, tgrads, _ = tgl.train_step_b(
        tcfg, _tspec(tcfg, dataclasses.replace(cc, mode="fused_fit")),
        tparams, tad, _tb(batches[1]))
    loss, grads = jax_steps["b"]
    _close(float(tloss), loss, what="loss b")
    _close(_tnp(tgrads), grads, what="grads b")
    tloss, tgrads, _ = tgl.train_step_ft(tcfg, tparams, _tb(batches[1]))
    loss, grads = jax_steps["ft"]
    _close(float(tloss), loss, what="loss ft")
    _close(_tnp(tgrads), grads, what="grads ft")
    assert {"layers_a", "layers_b"} <= set(tgrads)


def test_prop1_mode_a_equals_mode_b_on_both_stacks(setup, jax_steps):
    """Port-internal: Mode A's fit gradients equal Mode B's adapter
    gradients at every tap of both stacks, unmerged and merged."""
    cfg, tcfg, _, tparams, batches = setup
    cc, _ = _adapters(cfg, "lowrank")
    tad = convert.adapters_from_numpy(jax_steps["adapters"], device="cpu")
    batch = _tb(batches[2])
    spec_a = _tspec(tcfg, cc)
    _, gb, _ = tgl.train_step_b(
        tcfg, _tspec(tcfg, dataclasses.replace(cc, mode="fused_fit")),
        tparams, tad, batch)
    _, data, _ = tgl.server_step_a(tcfg, spec_a, tparams, tad, batch)
    pm = tmerge.merged_params(tcfg, tparams, spec_a, tad)
    _, data_m, _ = tgl.server_step_a(
        tcfg, _tspec(tcfg, dataclasses.replace(cc, merged=True)), pm, {},
        batch)
    for d, rtol in ((data, 2e-4), (data_m, 5e-3)):
        ga = tgl.fit_grads(spec_a, tad, d)
        assert tuple(sorted(ga)) == TAPS
        for tap in TAPS:
            for leaf in gb[tap]:
                np.testing.assert_allclose(ga[tap][leaf].numpy(),
                                           gb[tap][leaf].numpy(), rtol=rtol,
                                           atol=1e-6, err_msg=tap)


# ---------------------------------------------------------------------------
# sessions: ColaSession in five modes, K = 2 collaboration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODES))
def test_session_trajectory_matches_jax(setup, jax_sessions, name):
    _, tcfg, _, tparams, batches = setup
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
        assert tuple(sorted(ts.adapters)) == TAPS
        _close(_tnp(ts.adapters), final,
               rtol=INT8_RTOL if cc.compress == "int8" else 1e-3, what=name)
    np.testing.assert_allclose(ts.eval_loss(batches[0]), eval_loss, rtol=1e-4)


def test_collab_step_matches_jax(setup, jax_collab):
    """K = 2 merged collaboration on the pairs plan: the losses and both
    users' banks after two steps, from JAX's initial banks; and the row
    masks of both stacks split the merged fit exactly."""
    cfg, tcfg, _, tparams, _ = setup
    init, losses, banks = jax_collab
    ts = tcollab.CollabSession(tcfg, tbase.ColaConfig(**COLLAB), tparams,
                               optimizer=topt.sgd(0.1), device="cpu")
    for off, ch, ad in zip(ts.offloaders, ts.channels, init):
        ad = convert.adapters_from_numpy(ad, device="cpu")
        off.adapters = ch.last_good = ad
        off.opt_state = off.optimizer.init(ad)
    got = []
    for b in _collab_batches(cfg):
        b = dict(b)
        got.append(ts.train_step(b, b.pop("user_id")))
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    for k, want in enumerate(banks):
        _close(_tnp(ts.channels[k].adapters), want, rtol=1e-3, what=f"user {k}")

    spec = tgl.make_spec(tcfg, tbase.ColaConfig(**{**COLLAB, "merged": False}))
    ad = convert.adapters_from_numpy(init[0], device="cpu")
    b = _tb(_collab_batches(cfg)[0])
    users = b.pop("user_id")
    _, d_all, _ = tgl.server_step_a(tcfg, spec, tparams, ad, b)
    g = tgl.fit_grads(spec, ad, d_all)
    parts = [tgl.fit_grads(spec, ad, tcollab.mask_user_rows(d_all, users, k))
             for k in range(2)]
    assert tuple(sorted(g)) == TAPS
    for tap in TAPS:
        for leaf in g[tap]:
            np.testing.assert_allclose(
                (parts[0][tap][leaf] + parts[1][tap][leaf]).numpy(),
                g[tap][leaf].numpy(), rtol=1e-4, atol=1e-6, err_msg=tap)


def test_smoke_forward_and_train_step(setup, jax_smoke):
    """The port of JAX's test_smoke_forward_and_train_step[gemma2-9b]: the
    forward's logits of (2, 32, vocab), no NaN, and one Mode B step with a
    finite loss and finite adapter grads; each held to JAX's numbers."""
    tcfg = setup[1]
    params, batch, logits, adapters, loss, grads = jax_smoke
    tparams = convert.params_from_numpy(tcfg, params, device="cpu")
    tbatch = _tb(batch)
    tlogits, _ = TM.forward(tcfg, tparams, tbatch)
    assert tuple(tlogits.shape) == (2, 32, tcfg.vocab_size)
    assert not torch.isnan(tlogits).any()
    _close(tlogits.numpy(), logits, what="logits")
    cc = tbase.ColaConfig(mode="fused_fit", family="lowrank", taps="qv",
                          rank=4)
    tloss, tgrads, _ = tgl.train_step_b(
        tcfg, tgl.make_spec(tcfg, cc), tparams,
        convert.adapters_from_numpy(adapters, device="cpu"), tbatch)
    assert np.isfinite(float(tloss))
    _close(float(tloss), loss, what="loss")
    for tap, w in tgrads.items():
        for leaf, gr in w.items():
            assert torch.isfinite(gr).all(), (tap, leaf)
    _close(_tnp(tgrads), grads, what="grads")
