"""remat "dots" in the port (``repro_torch.models.remat``) on the CPU, at
reduced configs:

- (a) "none", "full" and "dots" give the same numbers bit for bit: Mode A's
  loss and every tap's (x, grad_h), Mode B's and full FT's gradients, on
  the uniform, pairs, MoE (einsum, sort and dense dispatch), SSM and
  hybrid plans;
- (b) the port at "dots" against the JAX package at "dots" on the same
  numpy weights and batches (rtol 1e-4 with an atol of 1e-4 of the largest
  entry, ``tests/test_torch_training.py``'s ``_close``);
- (c) the products the port keeps a unit (their numel and last dim)
  against the residuals JAX's ``saved_residuals`` lists under "dots" less
  those under "full", reduced smollm and qwen3-moe, in Mode A, Mode B and
  full FT;
- (d) the products kept are the only ones not recomputed: under
  ``FlopCounterMode`` FLOPs("full") - FLOPs("dots") equals their forward
  FLOPs exactly, and FLOPs("dots") >= FLOPs("none"); the dry-run's count
  (``launch/dryrun.count_step``) the same, its ``saved_product_bytes`` the
  kept products' bytes, its collectives those of "full";
- (e) the pairs plan checkpoints a (local, global) pair as one unit, as
  JAX's ``_scan_pairs`` does: ``layer_input_meter`` sees one input a
  pair.
"""
import collections
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
# the public jax.ad_checkpoint of JAX 0.9 has print_saved_residuals only
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import remat  # noqa: E402

PLANS = {
    "uniform": ("smollm-135m", dict(n_layers=2)),
    "pairs": ("gemma2-9b", dict(n_layers=4)),
    "moe-einsum": ("qwen3-moe-30b-a3b", dict(n_layers=2, moe_impl="einsum",
                                             moe_group=16)),
    "moe-sort": ("qwen3-moe-30b-a3b", dict(n_layers=2, moe_impl="sort")),
    "moe-dense": ("qwen3-moe-30b-a3b", dict(n_layers=2, moe_impl="dense")),
    "ssm": ("mamba2-370m", dict(n_layers=2)),
    "hybrid": ("zamba2-7b", dict(n_layers=4, shared_attn_every=2)),
}
STEPS = ("mode_a", "mode_b", "ft")
B, S, RANK = 2, 16, 4


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
                               atol=rtol * float(np.abs(want).max() or 1.0),
                               err_msg=what)


def _tcfg(plan, **kw):
    name, over = PLANS[plan]
    return tregistry.reduced_config(name).replace(**over, **kw)


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _cc(mode):
    return tbase.ColaConfig(mode=mode, family="lowrank", taps="qv",
                            rank=RANK)


def _port_adapters(cfg):
    """Seeded adapters with B drawn too (B = 0 leaves dA = 0)."""
    g = torch.Generator().manual_seed(0)
    ad = tgl.init_adapters(cfg, _cc("faithful_offload"), g, device="cpu")
    for w in ad.values():
        w["B"] = torch.randn(w["B"].shape, generator=g) * 0.02
    return ad


def _step(cfg, step, params, ad, batch):
    """(the loss, the step's data or gradients) of one port step."""
    if step == "mode_a":
        spec = tgl.make_spec(cfg, _cc("faithful_offload"))
        loss, data, _ = tgl.server_step_a(cfg, spec, params, ad, batch)
        return loss, data
    if step == "mode_b":
        spec = tgl.make_spec(cfg, _cc("fused_fit"))
        loss, grads, _ = tgl.train_step_b(cfg, spec, params, ad, batch)
        return loss, grads
    loss, grads, _ = tgl.train_step_ft(cfg, params, batch)
    return loss, grads


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module", params=list(PLANS))
def runs(request):
    """Each step of the plan under each remat, its FLOPs and the products
    kept ({(step, remat): (loss, out, flops, meter)})."""
    plan = request.param
    cfg = _tcfg(plan)
    params = TM.init(cfg, seed=1, device="cpu")
    ad = _port_adapters(cfg)
    batch = _tb(_batch(cfg))
    out = {}
    for step in STEPS:
        for r in remat.REMATS:
            with (FlopCounterMode(display=False) as flops,
                  remat.saved_product_meter() as kept):
                loss, res = _step(cfg.replace(remat=r), step, params, ad,
                                  batch)
            out[step, r] = (loss, res, flops.get_total_flops(), kept)
    return plan, out


def test_every_remat_gives_the_same_numbers(runs):
    """(a) Recomputing a unit, or replaying its kept products, changes no
    bit of the loss, the taps' (x, grad_h) or the gradients."""
    plan, out = runs
    for step in STEPS:
        loss, res = out[step, "none"][:2]
        want = _leaves(res)
        assert want and all(torch.isfinite(t).all() for t in want), plan
        for r in ("full", "dots"):
            got = out[step, r]
            assert torch.equal(got[0], loss), (plan, step, r)
            got = _leaves(got[1])
            assert len(got) == len(want)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                plan, step, r)


def test_dots_recomputes_all_but_the_kept_products(runs):
    """(d) Under FlopCounterMode, which sits below the checkpoint's own
    mode, a replayed product is not counted again: "full" - "dots" is the
    kept products' forward FLOPs exactly, and "dots" still recomputes the
    rest (attention, the MoE's experts, the SSD scan), so it counts at
    least "none"'s."""
    plan, out = runs
    for step in STEPS:
        kept = out[step, "dots"][3]
        assert kept.shapes and kept.flops > 0, (plan, step)
        for r in ("none", "full"):
            assert out[step, r][3].shapes == [], (plan, step, r)
        full, dots, none = (out[step, r][2] for r in ("full", "dots",
                                                      "none"))
        assert full - dots == kept.flops, (plan, step, full, dots,
                                           kept.flops)
        assert dots >= none, (plan, step)


def test_pairs_checkpoint_a_pair_at_a_time():
    """(e) gemma2's local and global layers run as one checkpointed unit a
    pair (``model._units``), so the unit inputs kept are one a pair."""
    cfg = _tcfg("pairs", remat="full")
    assert [tuple(p for p, _, _ in u) for u in TM._units(cfg)] == [
        ("layers_a", "layers_b")] * 2
    assert [w for u in TM._units(cfg) for _, _, w in u] == [
        cfg.local_window, None] * 2
    params = TM.init(cfg, seed=1, device="cpu")
    batch = _tb(_batch(cfg))
    for r in ("full", "dots"):
        with TM.layer_input_meter() as seen:
            _step(cfg.replace(remat=r), "ft", params, {}, batch)
        assert seen.shapes == [(B, S, cfg.d_model)] * 2, (r, seen.shapes)
    # the hybrid plan's shared block stays a unit of its own (ROADMAP C.13)
    h = _tcfg("hybrid")
    assert [len(u) for u in TM._units(h)] == [1] * (h.n_layers + 2)


def test_unknown_remat_raises():
    cfg = _tcfg("uniform", remat="everything")
    params = TM.init(cfg, seed=1, device="cpu")
    with pytest.raises(ValueError, match="none, full, dots"):
        _step(cfg, "ft", params, {}, _tb(_batch(cfg)))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

JAX_PLANS = ("uniform", "pairs")


def _jax_setup(plan):
    name, over = PLANS[plan]
    cfg = registry.reduced_config(name).replace(**over, remat="dots")
    tcfg = _tcfg(plan, remat="dots")
    params = M.init(cfg, jax.random.PRNGKey(1))
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=RANK)
    ad = gl.init_adapters(cfg, cc, jax.random.PRNGKey(2))
    ad = jax.tree.map(lambda a: a + 0.02 * jax.random.normal(
        jax.random.PRNGKey(7), a.shape), ad)
    batch = jpipeline.SyntheticLM(cfg, batch=B, seq=S, seed=3).batch_at(0)
    return cfg, tcfg, params, _np(ad), batch, cc


@pytest.mark.parametrize("plan", JAX_PLANS)
def test_dots_matches_jax_dots(plan):
    """(b) Mode A's loss and (x, grad_h), Mode B's and full FT's losses and
    gradients at "dots" against JAX's at "dots"."""
    cfg, tcfg, params, ad, batch, cc = _jax_setup(plan)
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    tad = convert.adapters_from_numpy(ad, device="cpu")
    tb = _tb(batch)

    def jit(fn, *static):
        return jax.jit(functools.partial(fn, *static))

    spec = gl.make_spec(cfg, cc)
    loss, data, _ = jit(gl.server_step_a, cfg, spec)(params, ad, batch)
    tloss, tdata = _step(tcfg, "mode_a", tparams, tad, tb)
    _close(float(tloss), float(loss), what=f"{plan} loss a")
    assert set(tdata) == set(data)
    for tap, (x, g) in data.items():
        _close(tdata[tap][0].numpy(), x, what=f"{plan} {tap} x")
        _close(tdata[tap][1].numpy(), g, what=f"{plan} {tap} grad_h")
    spec = gl.make_spec(cfg, dataclasses.replace(cc, mode="fused_fit"))
    loss, grads, _ = jit(gl.train_step_b, cfg, spec)(params, ad, batch)
    tloss, tgrads = _step(tcfg, "mode_b", tparams, tad, tb)
    _close(float(tloss), float(loss), what=f"{plan} loss b")
    _close(_tnp(tgrads), _np(grads), what=f"{plan} grads b")
    loss, grads, _ = jit(gl.train_step_ft, cfg)(params, batch)
    tloss, tgrads = _step(tcfg, "ft", tparams, tad, tb)
    _close(float(tloss), float(loss), what=f"{plan} loss ft")
    _close(_tnp(tgrads), _np(grads), what=f"{plan} grads ft")


def _jax_kept(cfg, step, params, ad, batch, cc) -> collections.Counter:
    """The residuals JAX saves under "dots" less those under "full", each
    as (numel of one layer, last dim): every one is a stacked (L, ...)
    scan output."""
    def shapes(remat_):
        c = cfg.replace(remat=remat_)
        if step == "mode_a":
            spec = gl.make_spec(c, cc)
            d0 = gl.zero_deltas(c, spec, B, S)
            res = saved_residuals(lambda d: M.loss_fn(
                c, params, batch, spec, {"adapters": ad, "deltas": d})[0], d0)
        elif step == "mode_b":
            spec = gl.make_spec(c, dataclasses.replace(cc, mode="fused_fit"))
            res = saved_residuals(lambda a: M.loss_fn(
                c, params, batch, spec, {"adapters": a})[0], ad)
        else:
            res = saved_residuals(lambda p: M.loss_fn(c, p, batch)[0],
                                  params)
        return collections.Counter(tuple(aval.shape) for aval, _ in res)

    extra = shapes("dots") - shapes("full")
    L = cfg.n_layers
    assert all(s[0] == L for s in extra), extra
    return collections.Counter({(int(np.prod(s[1:])), s[-1]): n
                                for s, n in extra.items()})


@pytest.mark.parametrize("plan", ["uniform", "moe-einsum"])
@pytest.mark.parametrize("step", STEPS)
def test_kept_products_match_jax_saved_residuals(plan, step):
    """(c) Per unit, the port keeps the products JAX's "dots" saves beyond
    "full": q, k, v, o, gate and up (not down: its output only feeds the
    residual add that closes the unit, and JAX's backward reads nothing of
    it), the router's logits on the MoE plan, and each adapted tap's
    ``(x A) B``; ``x A`` only where B takes a gradient (Mode B). No
    difference is left to pin."""
    cfg, tcfg, params, ad, batch, cc = _jax_setup(plan)
    want = _jax_kept(cfg, step, params, ad, batch, cc)
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    with remat.saved_product_meter() as kept:
        _step(tcfg, step, tparams, convert.adapters_from_numpy(
            ad, device="cpu"), _tb(batch))
    got = collections.Counter((int(np.prod(s)), s[-1]) for s in kept.shapes)
    L = cfg.n_layers
    assert got == collections.Counter({k: n * L for k, n in want.items()}), (
        step, got, want)
    assert kept.bytes == 4 * sum(n * k[0] for k, n in got.items())


# ---------------------------------------------------------------------------
# the dry-run's count
# ---------------------------------------------------------------------------

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=128, vocab_size=128, microbatches=2)


@pytest.mark.parametrize("world, shape", [(1, (1, 1)), (8, (2, 4))])
def test_dry_run_counts_dots(world, shape):
    """(d) The dry-run's modes sit below the checkpoint's: "full" - "dots"
    is the kept products' FLOPs in its count too, at world size 1 and at 8
    (the attention and MLP split over 4 "model" ranks); ``saved_product_bytes``
    is their bytes; "dots" issues the same collectives as "full", in the
    same order, recompute included."""
    cfg = tregistry.reduced_config("mistral-nemo-12b").replace(**SMALL)
    cc = tbase.ColaConfig(mode="faithful_offload", family="lowrank",
                          taps="qv", rank=RANK)
    got = {}
    with dryrun.fake_world(world):
        mesh = make_mesh(*shape, device_type="cpu")
        for r in ("full", "dots"):
            with remat.saved_product_meter() as kept:
                got[r] = (dryrun.count_step(cfg.replace(remat=r), cc,
                                            "train", 8, S, mesh), kept)
    (full, none_kept), (dots, kept) = got["full"], got["dots"]
    assert none_kept.shapes == [] and full["saved_product_bytes"] == 0
    assert kept.flops > 0
    assert full["flops"] - dots["flops"] == kept.flops
    assert dots["saved_product_bytes"] == kept.bytes > 0
    assert [(r["op"], r["bytes"]) for r in dots["collective_records"]] == [
        (r["op"], r["bytes"]) for r in full["collective_records"]]
    assert (full["collective_bytes"] > 0) == (world > 1)
    assert dots["memory"]["peak_bytes_per_device"] >= full["memory"][
        "peak_bytes_per_device"]


# ---------------------------------------------------------------------------
# the hybrid plan's shared block: a unit of its own in the port, outside any
# checkpoint in JAX (``_run_hybrid``): ROADMAP C.13
# ---------------------------------------------------------------------------

# reduced zamba2-7b (7 Mamba2 layers, a shared block every 3: 3 calls), full
# FT at B 2 x S 16, f32, a call of the shared block: the FLOPs its
# recompute costs under "full" (its forward but the closing down product,
# which the recompute stops before) and under "dots" (the attention), the
# bytes of its products kept under "dots", and the bytes of the
# activations autograd keeps for it outside a checkpoint (parameters
# excluded) where the unit keeps its 16,384-byte input
SHARED_CALL = {"flops": 8650752, "dots_flops": 262144, "kept": 131072,
               "unchecked": 316224}


def test_hybrid_shared_block_stays_a_unit_of_its_own(monkeypatch):
    """The port checkpoints each call of the shared block: under "full" it
    keeps the call's (B, S, d) input and recomputes its forward in the
    backward, under "dots" it keeps its products too and recomputes the
    rest; JAX runs the block outside any checkpoint, keeping what autograd
    saves for it and recomputing nothing. Counted here by running the
    port's calls of the shared block unchecked, as JAX does."""
    from repro_torch.utils import tree_leaves

    cfg = tregistry.reduced_config("zamba2-7b")
    calls = len(TM.layer_plan(cfg)[1])
    assert (cfg.n_layers, calls) == (7, 3)
    params = TM.init(cfg, seed=1, device="cpu")
    batch = _tb(_batch(cfg))
    own = {p.untyped_storage().data_ptr() for p in tree_leaves(params)}
    orig = remat.checkpointed
    unchecked = []

    def jax_units(r, fn, needs_grad):
        ck = orig(r, fn, needs_grad)

        def run(c, unit, *args):
            if unit[0][0] != "shared":
                return ck(c, unit, *args)
            seen = {}

            def pack(t):
                st = t.untyped_storage()
                if st.data_ptr() not in own:
                    seen[st.data_ptr()] = st.nbytes()
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                out = fn(c, unit, *args)
            unchecked.append(sum(seen.values()))
            return out
        return run

    got = {}
    for r in ("full", "dots"):
        c = cfg.replace(remat=r)
        for how in ("port", "jax"):
            if how == "jax":
                monkeypatch.setattr(remat, "checkpointed", jax_units)
            with (FlopCounterMode(display=False) as flops,
                  remat.saved_product_meter() as kept):
                loss, _ = _step(c, "ft", params, {}, batch)
            monkeypatch.setattr(remat, "checkpointed", orig)
            got[r, how] = (float(loss), flops.get_total_flops(), kept.bytes)
    assert len({v[0] for v in got.values()}) == 1   # the same loss
    call = SHARED_CALL
    assert got["full", "port"][1] - got["full", "jax"][1] == (
        calls * call["flops"])
    assert got["dots", "port"][1] - got["dots", "jax"][1] == (
        calls * call["dots_flops"])
    assert got["dots", "port"][2] - got["dots", "jax"][2] == (
        calls * call["kept"])
    assert unchecked == [call["unchecked"]] * 2 * calls
    assert call["unchecked"] > B * S * cfg.d_model * 4 + call["kept"]
