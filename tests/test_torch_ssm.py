"""The SSM plan in the port (mamba2-370m's Mamba2 blocks), against the JAX
package on the CPU: the SSD oracle and the chunked scan, the Mamba2 block
and its decode step, the model (forward, loss, prefill -> decode), tap
sites, the init tree and ``convert``'s dtypes, ColA's Mode A step with its
fit gradients and Prop 1, JAX's plan-sweep case, and the engines. The model
is the reduced mamba2-370m (ssm_headdim 16, ssm_state 16, chunk 32) at two
layers, JAX's weights carried across by ``repro_torch.convert``, numpy
inputs from a seed fed to both. Every JAX engine run sits in a
module-scoped fixture.

JAX's engine cannot serve ssm-tap adapters: its ``ssm_decode_step`` hands a
(B, d) input to the multi-LoRA tap, which reshapes it as (B, S, d) and
raises. So the engines with adapters are held to JAX's greedy decoding by
full forwards (a causal model: the logits at a row's last real position do
not see the right padding), and the JAX engine itself is run without
adapters.

Tolerances (f32, sums in another order; ``_close``'s atol is its rtol
times the largest entry): the SSD oracle and scan rtol 1e-4, as
tests/test_kernels.py holds the scan to the oracle; one recurrence step
1e-5; the block, the model, their states and Mode A 1e-4; bf16 blocks
2e-2 (bf16 roundings of the conv, projections and the norm); losses rtol
1e-5; softplus 2 ulp; Prop 1 at test_gl_equivalence.py's rtol 2e-4 /
atol 1e-6; chunked against unchunked logits atol 1e-3, as JAX's own
sweep; tokens equal.
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
from repro.core import taps as jtaps  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_scan as jscan  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tscan  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.runtime import kv_pager as tpager  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from tests.conftest import make_batch  # noqa: E402

NAME = "mamba2-370m"
TAPS = ("layers.ssm.in", "layers.ssm.out")
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
    over = {"n_layers": 2, **over}
    cfg = registry.reduced_config(NAME).replace(**over)
    tcfg = tregistry.reduced_config(NAME).replace(**over)
    params = M.init(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, convert.params_from_numpy(tcfg, _np(params),
                                                        device="cpu")


@pytest.fixture(scope="module")
def mamba():
    return _pair()


# ---------------------------------------------------------------------------
# the SSD oracle and the chunked scan
# ---------------------------------------------------------------------------

def _ssd_inputs(b, S, H, P, N, seed, D_zero=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(b, S, H)))).astype(f)
    a = -np.exp(rng.normal(size=(H,)) * 0.1).astype(f)
    B = rng.normal(size=(b, S, N)).astype(f)
    C = rng.normal(size=(b, S, N)).astype(f)
    D = (np.zeros if D_zero else np.ones)((H,), f)
    return x, dt, a, B, C, D


@pytest.mark.parametrize("S,chunk", [(256, 64), (96, 32), (512, 128),
                                     (200, 64), (130, 128)])
def test_ssd_and_chunked_scan_match_jax(S, chunk):
    """tests/test_kernels.py's (S, chunk) grid: the port's oracle and its
    chunked scan against JAX's, each (y and the final state), with and
    without a carried state; and the port's scan against its own oracle.
    ``ops.ssd`` takes the oracle up to ``chunk`` positions, the scan past."""
    args = _ssd_inputs(2, S, 4, 16, 8, seed=S + chunk)
    s0 = np.random.default_rng(3).normal(size=(2, 4, 16, 8)).astype(np.float32)
    ja = [jnp.asarray(a) for a in args]
    ta = [_t(a) for a in args]
    for init in (None, s0):
        ji = None if init is None else jnp.asarray(init)
        ti = None if init is None else _t(init)
        y1, st1 = jax.jit(jref.ssd)(*ja, init_state=ji)
        y2, st2 = jax.jit(functools.partial(jscan.ssd_chunked, chunk=chunk))(
            *ja, init_state=ji)
        ty1, tst1 = tref.ssd(*ta, init_state=ti)
        ty2, tst2 = tscan.ssd_chunked(*ta, init_state=ti, chunk=chunk)
        for got, want, what in ((ty1, y1, "ref y"), (tst1, st1, "ref state"),
                                (ty2, y2, "chunked y"),
                                (tst2, st2, "chunked state"),
                                (ty2, ty1, "port chunked vs oracle y"),
                                (tst2, tst1, "port chunked vs oracle state")):
            _close(_tnp(got) if torch.is_tensor(got) else got,
                   _tnp(want) if torch.is_tensor(want) else want, 1e-4,
                   f"S {S} chunk {chunk} init {init is not None} {what}")
        assert tst2.dtype == torch.float32
        ty3, tst3 = tops.ssd(*ta, init_state=ti, chunk=chunk)
        assert torch.equal(ty3, ty2) and torch.equal(tst3, tst2)
    # up to a chunk: the oracle itself, and without a state no init terms
    x, dt, a, B, C, D = (t[:, :chunk] if t.dim() > 1 else t for t in ta)
    y_short, st_short = tops.ssd(x, dt, a, B, C, D, chunk=chunk)
    y_ref, st_ref = tref.ssd(x, dt, a, B, C, D)
    assert torch.equal(y_short, y_ref) and torch.equal(st_short, st_ref)


@pytest.mark.parametrize("S,chunk", [(200, 64), (37, 32), (300, 128)])
def test_chunked_tail_state_matches_decode(S, chunk):
    """tests/test_kernels.py:326 in the port: a tail narrower than the
    chunk is sliced exactly, so the scan's state is the state after
    position S of the step-by-step recurrence (and JAX's scan's)."""
    args = _ssd_inputs(2, S, 3, 8, 4, seed=9)
    ta = [_t(a) for a in args]
    x, dt, a, B, C, D = ta
    y_c, s_c = tscan.ssd_chunked(*ta, chunk=chunk)
    state = torch.zeros(2, 3, 8, 4)
    ys = []
    for t in range(S):
        y, state = tref.ssd_decode_step(x[:, t], dt[:, t], a, B[:, t], C[:, t],
                                        D, state)
        ys.append(y)
    _close(_tnp(s_c), _tnp(state), 1e-4, "state")
    _close(_tnp(y_c), _tnp(torch.stack(ys, 1)), 1e-4, "y")
    _, js = jax.jit(functools.partial(jscan.ssd_chunked, chunk=chunk))(
        *[jnp.asarray(v) for v in args])
    _close(_tnp(s_c), js, 1e-4, "state vs JAX")


def test_ssd_decode_matches_sequence_and_jax():
    """tests/test_kernels.py:352 in the port (the recurrence equals the
    full-sequence oracle), and each decode step equals JAX's."""
    args = _ssd_inputs(1, 8, 2, 4, 8, seed=6, D_zero=True)
    x, dt, a, B, C, D = (_t(v) for v in args)
    jx, jdt, ja, jB, jC, jD = (jnp.asarray(v) for v in args)
    y_full, s_full = tref.ssd(x, dt, a, B, C, D)
    state, jstate = torch.zeros(1, 2, 4, 8), jnp.zeros((1, 2, 4, 8))
    ys = []
    for t in range(8):
        y, state = tref.ssd_decode_step(x[:, t], dt[:, t], a, B[:, t], C[:, t],
                                        D, state)
        jy, jstate = jref.ssd_decode_step(jx[:, t], jdt[:, t], ja, jB[:, t],
                                          jC[:, t], jD, jstate)
        _close(_tnp(y), jy, 1e-5, f"y {t}")
        _close(_tnp(state), jstate, 1e-5, f"state {t}")
        ys.append(y)
    _close(_tnp(torch.stack(ys, 1)), _tnp(y_full), 1e-4, "y vs sequence")
    _close(_tnp(state), _tnp(s_full), 1e-4, "state vs sequence")
    assert torch.equal(tops.ssd_decode_step(x[:, 0], dt[:, 0], a, B[:, 0],
                                            C[:, 0], D, torch.zeros(1, 2, 4, 8))[1],
                       tref.ssd_decode_step(x[:, 0], dt[:, 0], a, B[:, 0],
                                            C[:, 0], D, torch.zeros(1, 2, 4, 8))[1])


def test_softplus_agrees_with_jax_in_f32():
    """``F.softplus`` (threshold 20) against ``jax.nn.softplus`` in f32 at
    the block's step-size inputs (projections plus dt_bias, |x| < 10) and
    past the threshold, within 2 ulp."""
    x = np.concatenate([np.random.default_rng(4).normal(size=4096) * 4,
                        np.linspace(-30, 30, 601)]).astype(np.float32)
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def _block_kw(cfg):
    return dict(d_model=cfg.d_model, expand=cfg.ssm_expand,
                headdim=cfg.ssm_headdim, state=cfg.ssm_state,
                norm_eps=cfg.norm_eps)


def _layer0(params, dtype):
    """Layer 0's mixer parameters, in ``dtype`` except the f32 leaves."""
    p = jax.tree.map(lambda a: a[0], params["layers"]["ssm"])
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in ("dt_bias", "A_log", "D")
        else a.astype(dtype), p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_matches_jax(mamba, dtype):
    """The full-sequence block (S 45: one chunk of 32 and a tail) and its
    final conv and ssm state, against JAX's, in f32 (1e-4) and in bf16
    (2e-2 of the largest entry)."""
    cfg, tcfg, params, _ = mamba
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    p = _layer0(params, jdt)
    tp = convert.params_from_numpy(tcfg.replace(param_dtype=dtype),
                                   {"layers": {"ssm": _np(p)}},
                                   device="cpu")["layers"]["ssm"]
    assert tp["dt_bias"].dtype == torch.float32
    u = np.random.default_rng(11).normal(size=(2, 45, cfg.d_model)).astype(
        np.float32)
    kw = _block_kw(cfg)
    y, st = jax.jit(functools.partial(JS.ssm_block, chunk=cfg.ssd_chunk,
                                      return_state=True, **kw))(
        p, jnp.asarray(u, jdt))
    ty, tst = TS.ssm_block(tp, _t(u).to(getattr(torch, dtype)),
                           chunk=tcfg.ssd_chunk, **kw)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert ty.dtype == getattr(torch, dtype) and tst["ssm"].dtype == torch.float32
    assert tst["conv"].dtype == getattr(torch, dtype)
    _close(_tnp(ty), np.asarray(y, np.float32), tol, "y")
    _close(_tnp(tst["ssm"]), np.asarray(st["ssm"], np.float32), tol, "ssm")
    _close(_tnp(tst["conv"]), np.asarray(st["conv"], np.float32), tol, "conv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,split,S", [(32, 32, 45), (32, 64, 70),
                                           (2, 2, 7)])
def test_ssm_block_split_is_bit_identical(mamba, dtype, chunk, split, S):
    """Inside the port: a block split at a chunk boundary, with the conv and
    ssm state carried across, gives the unsplit call's output and states
    bit for bit (JAX's docstring's promise). The (2, 2, 7) case splits at
    S < W - 1 (the first call's conv tail is zero-padded) with chunks of
    2."""
    cfg, tcfg, _, tparams = mamba
    dt = getattr(torch, dtype)
    tp = {k: (v.to(dt) if k not in ("dt_bias", "A_log", "D")
              and not isinstance(v, dict) else v)
          for k, v in TM._layer(tparams["layers"]["ssm"], 0).items()}
    tp["in_proj"] = {"w": tp["in_proj"]["w"].to(dt)}
    tp["out_proj"] = {"w": tp["out_proj"]["w"].to(dt)}
    tp["norm"] = {"scale": tp["norm"]["scale"].to(dt)}
    u = _t(np.random.default_rng(12).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)).to(dt)
    kw = dict(chunk=chunk, **_block_kw(tcfg))
    full, st = TS.ssm_block(tp, u, **kw)
    a, st_a = TS.ssm_block(tp, u[:, :split], **kw)
    if split < 3:
        assert torch.equal(st_a["conv"][:, :3 - split],
                           torch.zeros_like(st_a["conv"][:, :3 - split]))
    b, st_b = TS.ssm_block(tp, u[:, split:], init_state=st_a["ssm"],
                           conv_state=st_a["conv"], **kw)
    assert torch.equal(torch.cat([a, b], 1), full)
    assert torch.equal(st_b["ssm"], st["ssm"])
    assert torch.equal(st_b["conv"], st["conv"])
    # a zero conv state reproduces the zero-padded start bit for bit
    z, _ = TS.ssm_block(tp, u[:, :split], conv_state=torch.zeros_like(
        st_a["conv"]), init_state=None, **kw)
    assert torch.equal(z, a)


def test_ssm_decode_step_matches_jax(mamba):
    """One token from a carried (conv, ssm) state: output and both new
    states against JAX's."""
    cfg, tcfg, params, tparams = mamba
    p = _layer0(params, jnp.float32)
    tp = TM._layer(tparams["layers"]["ssm"], 0)
    rng = np.random.default_rng(13)
    sh = TS.ssm_state_shapes(cfg.d_model, 3, expand=cfg.ssm_expand,
                             headdim=cfg.ssm_headdim, state=cfg.ssm_state)
    u = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=sh["conv"]).astype(np.float32)
    st = rng.normal(size=sh["ssm"]).astype(np.float32)
    kw = _block_kw(cfg)
    y, c2, s2 = jax.jit(functools.partial(JS.ssm_decode_step, **kw))(
        p, jnp.asarray(u), jnp.asarray(conv), jnp.asarray(st))
    ty, tc2, ts2 = TS.ssm_decode_step(tp, _t(u), _t(conv), _t(st), **kw)
    for got, want, what in ((ty, y, "y"), (tc2, c2, "conv"), (ts2, s2, "ssm")):
        _close(_tnp(got), want, 1e-4, what)


# ---------------------------------------------------------------------------
# structure: configs, parameters, taps, convert
# ---------------------------------------------------------------------------

def test_tap_sites_match_jax(mamba):
    cfg, tcfg, _, _ = mamba
    js, ts = M.tap_sites(cfg), TM.tap_sites(tcfg)
    assert list(ts) == list(js) == list(TAPS)
    for n in js:
        assert (ts[n].d_in, ts[n].d_out, ts[n].stacked) == \
            (js[n].d_in, js[n].d_out, js[n].stacked), n
    assert tgl.select_taps(tcfg, "qv") == gl.select_taps(cfg, "qv") == TAPS
    full = TM.tap_sites(tregistry.get_config(NAME))
    assert [(s.d_in, s.d_out, s.stacked) for s in full.values()] == \
        [(1024, 4384, 48), (2048, 1024, 48)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_shapes_and_dtypes_match_jax(dtype):
    """The port's init has JAX's tree, shapes and dtypes (dt_bias, A_log
    and D f32 in a bf16 model too); its scales: in_proj's std d^-0.5,
    conv_b zeros, A = -1, D = 1, dt = softplus(dt_bias) in [0.001, 0.1]."""
    cfg = registry.reduced_config(NAME).replace(param_dtype=dtype)
    tcfg = tregistry.reduced_config(NAME).replace(param_dtype=dtype)
    jp = jax.eval_shape(lambda: M.init(cfg, jax.random.PRNGKey(0)))
    mine = TM.init(tcfg, seed=0, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(tree_leaves(mine))
    for path, leaf in jleaves:
        got = mine
        for p in path:
            got = got[p.key]
        assert tuple(got.shape) == leaf.shape, path
        assert str(got.dtype).replace("torch.", "") == str(leaf.dtype), path
    s = mine["layers"]["ssm"]
    for k in ("dt_bias", "A_log", "D"):
        assert s[k].dtype == torch.float32
    assert abs(float(s["in_proj"]["w"].float().std()) * tcfg.d_model ** 0.5
               - 1.0) < 0.05
    assert not s["conv_b"].any() and bool((s["A_log"] == 0).all())
    assert bool((s["D"] == 1).all())
    dt = torch.nn.functional.softplus(s["dt_bias"])
    assert float(dt.min()) >= 0.001 * 0.999 and float(dt.max()) <= 0.1 * 1.001


@functools.lru_cache(maxsize=None)
def _init_f32(name):
    return M.init(registry.reduced_config(name), jax.random.PRNGKey(0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["smollm-135m", "gemma2-9b",
                                  "qwen3-moe-30b-a3b", NAME])
def test_convert_gives_each_leaf_jax_init_dtype(name, dtype):
    """``convert.params_from_numpy`` gives every leaf the dtype of JAX's
    init: ``param_dtype`` everywhere on smollm, gemma2 and qwen3-moe
    (their converted trees unchanged), and f32 for mamba2's dt_bias, A_log
    and D in a bf16 model; values carried exactly at f32 and to bf16. JAX's
    init draws in f32 and casts each leaf to its dtype, so its bf16 tree is
    the f32 tree cast leaf by leaf to the dtypes of ``jax.eval_shape``."""
    cfg = registry.reduced_config(name).replace(param_dtype=dtype)
    tcfg = tregistry.reduced_config(name).replace(param_dtype=dtype)
    shapes = jax.eval_shape(lambda: M.init(cfg, jax.random.PRNGKey(0)))
    params = jax.tree.map(lambda a, sh: jnp.asarray(a, sh.dtype),
                          _init_f32(name), shapes)
    conv = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = conv
        for p in path:
            got = got[p.key]
        want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        if path[-1].key in ("dt_bias", "A_log", "D"):
            want = torch.float32
        assert got.dtype == want, path
        assert str(got.dtype).replace("torch.", "") == str(leaf.dtype), path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_require_ported_takes_the_ssm_plan():
    """mamba2-370m runs, and so does the hybrid plan (zamba2-7b), whose
    Mamba2 layers carry recurrent state too."""
    assert TM._require_ported(tregistry.get_config(NAME)) == ("uniform", "ssm")
    assert TM.has_recurrent_state(tregistry.get_config(NAME))
    assert not TM.has_recurrent_state(tregistry.get_config("smollm-135m"))
    zamba2 = tregistry.get_config("zamba2-7b")
    assert TM._require_ported(zamba2)[0] == "hybrid"
    assert TM.has_recurrent_state(zamba2)


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill -> decode
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_jax(mamba):
    """Logits (S 45: a chunk and a tail through every layer), the moe aux
    of 0, and the loss."""
    cfg, tcfg, params, tparams = mamba
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


def test_prefill_then_decode_matches_jax(mamba):
    """prefill (S 37) -> its states scattered into two of three slots ->
    a 3-token chunk and a tick with the third row dead: logits and both
    states per layer against JAX's, the dead row's state unchanged bit for
    bit."""
    cfg, tcfg, params, tparams = mamba
    rng = np.random.default_rng(2)
    S, slots = 37, 3
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    lg, pre = _jit(M.prefill, cfg)(params, {"tokens": jnp.asarray(toks)})
    tlg, tpre = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    _close(_tnp(tlg), lg, 1e-4, "prefill logits")
    for n in ("conv", "ssm"):
        _close(_tnp(tpre["layers"][n]), pre["layers"][n], 1e-4, f"prefill {n}")
    ids = np.array([0, 1], np.int32)
    cache = M.scatter_prefill_cache(M.init_cache(cfg, slots, 64), pre,
                                    jnp.asarray(ids))
    tcache = TM.scatter_prefill_cache(
        TM.init_cache(tcfg, slots, 64, device="cpu"), tpre, ids)
    dead = {n: torch.randn(tcache["layers"][n][:, 2].shape)
            for n in ("conv", "ssm")}
    for n, v in dead.items():
        tcache["layers"][n][:, 2] = v
    cache = {"layers": {n: cache["layers"][n].at[:, 2].set(dead[n].numpy())
                        for n in ("conv", "ssm")}}
    live = np.array([True, True, False])
    for c, pos in ((3, [S, S, 0]), (1, [S + 3, S + 3, 0])):
        step = {"tokens": rng.integers(0, cfg.vocab_size, (3, c)).astype(np.int32),
                "positions": np.array(pos, np.int32)}
        lg, cache = _jit(M.decode_step, cfg)(
            params, jax.tree.map(jnp.asarray, step), cache,
            live=jnp.asarray(live))
        tlg, tcache = TM.decode_step(tcfg, tparams, _t(step), tcache,
                                     live=torch.as_tensor(live))
        _close(_tnp(tlg)[live], np.asarray(lg)[live], 1e-4, f"c {c} logits")
        for n in ("conv", "ssm"):
            _close(_tnp(tcache["layers"][n]), cache["layers"][n], 1e-4,
                   f"c {c} {n}")
            assert torch.equal(tcache["layers"][n][:, 2], dead[n])


def test_cache_specs_and_scatter_write_state_whole(mamba):
    """The ssm cache is {"conv" (L, B, W-1, C) compute dtype, "ssm"
    (L, B, H, P, N) f32} in both layouts, as JAX's; ``scatter_prefill_cache``
    writes a prefill row's states whole into its slot, drops an
    out-of-range id and leaves every other slot as it was."""
    cfg, tcfg, params, tparams = mamba
    for layout in ("dense", "paged"):
        js = M.cache_specs(cfg.replace(compute_dtype="bfloat16"), 3, 64,
                           kv_layout=layout)
        ts = TM.cache_specs(tcfg.replace(compute_dtype="bfloat16"), 3, 64,
                            kv_layout=layout)
        assert {n: (tuple(s.shape), str(s.dtype)) for n, s in
                js["layers"].items()} == \
            {n: (sh, str(dt).replace("torch.", "")) for n, (sh, dt) in
             ts["layers"].items()}
        assert set(ts) == {"layers"}
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 5))
    _, pre = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    cache = TM.init_cache(tcfg, 4, 64, device="cpu")
    for n in ("conv", "ssm"):
        cache["layers"][n].fill_(7.0)
    TM.scatter_prefill_cache(cache, pre, np.array([2, 4], np.int32))
    for n in ("conv", "ssm"):
        assert torch.equal(cache["layers"][n][:, 2], pre["layers"][n][:, 0])
        for s in (0, 1, 3):
            assert bool((cache["layers"][n][:, s] == 7.0).all())


# ---------------------------------------------------------------------------
# ColA training
# ---------------------------------------------------------------------------

def _adapters(cfg):
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=4)
    ad = gl.init_adapters(cfg, cc, jax.random.PRNGKey(2))
    ad = jax.tree.map(lambda a: a + 0.02 * jax.random.normal(
        jax.random.PRNGKey(7), a.shape), ad)
    return cc, _np(ad)


def test_server_step_a_and_fit_grads_match_jax(mamba):
    """Mode A (taps "qv" fall back to the ssm projections): the loss, each
    tap's (x, grad_h) and the fit gradients against JAX's."""
    cfg, tcfg, params, tparams = mamba
    cc, ad = _adapters(cfg)
    batch = _np(make_batch(cfg, 2, 40, jax.random.PRNGKey(3)))
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
        _close(_tnp(tdata[tap][0]), data[tap][0], what=f"{tap} x")
        _close(_tnp(tdata[tap][1]), data[tap][1], what=f"{tap} grad_h")
        assert np.abs(np.asarray(data[tap][1])).max() > 0
    _close(_tnp(tgl.fit_grads(tspec, tad, tdata)), _np(fit), what="fit")


def test_prop1_mode_a_equals_mode_b():
    """The mamba2 case of tests/test_gl_equivalence.py::
    test_prop1_mode_a_equals_mode_b in the port (the reduced config at its
    four layers, batch 2 x 16, its tolerances)."""
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
    tcc = tbase.ColaConfig(**dataclasses.asdict(cc))
    tad = convert.adapters_from_numpy(ad, device="cpu")
    spec_a = tgl.make_spec(tcfg, tcc)
    loss_a, data, _ = tgl.server_step_a(tcfg, spec_a, tparams, tad, batch)
    ga = tgl.fit_grads(spec_a, tad, data)
    loss_b, gb, _ = tgl.train_step_b(
        tcfg, tgl.make_spec(tcfg, dataclasses.replace(tcc, mode="fused_fit")),
        tparams, tad, batch)
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-6)
    assert sorted(gb) == list(TAPS)
    for tap in gb:
        for leaf in gb[tap]:
            np.testing.assert_allclose(ga[tap][leaf].numpy(),
                                       gb[tap][leaf].numpy(), rtol=2e-4,
                                       atol=1e-6, err_msg=f"{tap}.{leaf}")


# ---------------------------------------------------------------------------
# the port's own invariants: JAX's plan-sweep case for the ssm plan
# ---------------------------------------------------------------------------

def _tiny():
    """tests/test_paged_kv.py's mamba2 case: its _tiny's widths."""
    return tregistry.reduced_config(NAME).replace(
        n_layers=2, d_model=64, vocab_size=128, ssm_headdim=16, ssm_state=16)


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
    """The mamba2 case (C 4, P 11) of tests/test_paged_kv.py::
    test_chunked_matches_prefill_and_paged_matches_dense in the port:
    chunked logits within its atol 1e-3 of the full prefill's and the same
    argmax; paged equal to dense chunked, bit for bit."""
    tcfg = _tiny()
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


# ---------------------------------------------------------------------------
# engines against the JAX package
# ---------------------------------------------------------------------------

def test_batched_prefill_matches_reference_ssm():
    """tests/test_serving.py::test_batched_prefill_matches_reference_ssm in
    the port: prompts of 3, 6 and 11 tokens, batched (one exact-length
    prefill a prompt) == reference (token by token) tokens, both equal to
    JAX's engine on the same weights."""
    cfg = registry.reduced_config(NAME).replace(n_layers=2, d_model=64,
                                                vocab_size=128)
    tcfg = tregistry.reduced_config(NAME).replace(n_layers=2, d_model=64,
                                                  vocab_size=128)
    params = M.init(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    prompts = _prompts(cfg.vocab_size, (3, 6, 11))
    outs = {}
    for lib, p, kw in ((jserve, params, {}), (tserve, tparams,
                                              {"device": "cpu"})):
        for mode in ("batched", "reference"):
            eng = lib.ServeEngine(cfg if lib is jserve else tcfg, p, slots=3,
                                  max_len=32, prefill_mode=mode, **kw)
            reqs = [lib.Request(rid=i, user=0, prompt=q, max_new=4)
                    for i, q in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            outs[lib.__name__, mode] = [r.out for r in reqs]
    assert len({str(v) for v in outs.values()}) == 1, outs


def _banks(cfg):
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    key = jax.random.PRNGKey(0)
    out = []
    for u in range(2):   # both users' B nonzero (B is zero at init)
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
    right-padded batch with its user's multi-LoRA adapters, the next token
    the argmax at the row's last real position (causal: padding to its
    right is not seen)."""
    spec = jtaps.make_spec(family="multi_lowrank",
                           taps=gl.select_taps(cfg, "qv"), scale=1.0)
    seqs = [list(p) for p in prompts]
    width = max(map(len, seqs)) + MAX_NEW
    idx = jnp.asarray(users, jnp.int32)
    vars_ = {"adapters": {t: {**{n: jnp.asarray(a) for n, a in e.items()},
                              "idx": jnp.broadcast_to(idx, (cfg.n_layers,
                                                            len(users)))}
                          for t, e in bank.items()}}
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
def jax_outputs(mamba):
    """JAX's engine without adapters in each mode: tokens and
    kv_cache_bytes after every tick; and JAX's greedy tokens with the
    users' ssm-tap adapters from the f32 bank and from the int8 bank
    dequantised (``quantize_bank``, as the int8 engine stores it)."""
    cfg, _, params, _ = mamba
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    plain = {}
    for name, opts in ENGINES.items():
        opts = {k: v for k, v in opts.items() if k != "bank_store"}
        out, _, seen = _run(jserve, cfg, params, None, prompts, **ENGINE_KW,
                            **opts)
        plain[name] = (out, seen)
    bank = jserve.stack_user_adapters([jax.tree.map(jnp.asarray, b)
                                       for b in _banks(cfg)])
    q8 = jserve.quantize_bank(bank)
    deq = {t: {n: np.asarray(e[f"{n}_q"], np.float32) * np.asarray(
        e[f"{n}_scale"]) for n in ("A", "B")} for t, e in q8.items()}
    users = [i % 2 for i in range(len(prompts))]
    return plain, {"f32": _greedy(cfg, params, bank, prompts, users),
                   "int8": _greedy(cfg, params, deq, prompts, users)}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_matches_jax(mamba, jax_outputs, name):
    """Five requests (3-33 tokens, tails narrower than the chunk) to three
    slots, so two requests reuse a slot. Without adapters the port's engine
    emits the tokens of JAX's unchunked engine, with JAX's kv_cache_bytes
    after every tick in the same mode (recurrent state in full in both
    layouts); with two users' ssm-tap adapters (the f32 bank, or the int8
    bank) it emits JAX's greedy tokens; the pool ends whole."""
    cfg, tcfg, _, tparams = mamba
    plain, greedy = jax_outputs
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    opts = {k: v for k, v in ENGINES[name].items() if k != "bank_store"}
    out, eng, seen = _run(tserve, tcfg, tparams, None, prompts, device="cpu",
                          **ENGINE_KW, **opts)
    assert out == plain["dense"][0]
    assert seen == plain[name][1]
    if name != "dense":
        assert eng.stats["chunk_rounds"] > 0
        assert eng.stats["prefill_chunks"] > eng.stats["chunk_rounds"]
    tbanks = [convert.adapters_from_numpy(b, device="cpu") for b in _banks(cfg)]
    out, eng, _ = _run(tserve, tcfg, tparams, tbanks, prompts, device="cpu",
                       **ENGINE_KW, **ENGINES[name])
    assert out == greedy["int8" if name == "paged" else "f32"]
    assert out != plain["dense"][0]   # the adapters change the tokens
    if eng.pager is not None:
        eng.pager.assert_empty()


def test_reused_slot_starts_from_zero_state(mamba, jax_outputs):
    """A request admitted into a slot that served another one prefills from
    zero state: the port's reference engine (token by token) emits the
    unchunked engine's tokens. JAX's chunked engine does not (its fault:
    the fifth request, in a reused slot, starts from the slot's last
    request's state), while its first requests, in fresh slots, agree."""
    cfg, tcfg, _, tparams = mamba
    plain, _ = jax_outputs
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=5)
    out, _, _ = _run(tserve, tcfg, tparams, None, prompts, device="cpu",
                     prefill_mode="reference", **ENGINE_KW)
    assert out == plain["dense"][0]
    dense, chunked = plain["dense"][0], plain["chunked"][0]
    assert chunked[:ENGINE_KW["slots"]] == dense[:ENGINE_KW["slots"]]
    assert chunked != dense
