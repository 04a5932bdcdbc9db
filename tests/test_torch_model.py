"""The port's model against ``repro.models.model`` on the reduced f32
smollm-135m (2 layers), with JAX's weights carried across by
``repro_torch.convert``. Tolerance: f32, rtol = atol = 1e-4 (XLA's CPU matmuls
and PyTorch's sum in different orders through 2 layers and the head)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.core import taps as jtaps  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.runtime.serve_loop import stack_user_adapters as jstack  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.core import taps as ttaps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.serve_loop import stack_user_adapters  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    cfg = registry.reduced_config("smollm-135m").replace(n_layers=2)
    tcfg = tregistry.reduced_config("smollm-135m").replace(n_layers=2)
    params = M.init(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                        device="cpu")
    return cfg, tcfg, params, tparams


def _bank(cfg, users=2):
    """Both users' B nonzero, so every user's adapter moves the logits."""
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    key = jax.random.PRNGKey(7)
    out = []
    for u in range(users):
        ad = gl.init_adapters(cfg, cc, jax.random.fold_in(key, u))
        out.append(jax.tree.map(lambda a: a + 0.2 * jax.random.normal(
            jax.random.fold_in(key, 100 + u), a.shape), ad))
    return out


def _cola(bank_list, users, *, torch_side):
    if torch_side:
        bank = stack_user_adapters([convert.adapters_from_numpy(
            jax.tree.map(np.asarray, b), device="cpu") for b in bank_list])
        u = torch.as_tensor(users)
        return {"adapters": {t: {**e, "idx": u.expand(e["A"].shape[0], -1)}
                             for t, e in bank.items()}}
    bank = jstack(bank_list)
    u = jnp.asarray(users)
    return {"adapters": {t: {**e, "idx": jnp.broadcast_to(
        u, (e["A"].shape[0],) + u.shape)} for t, e in bank.items()}}


def test_config_and_taps_match_jax(setup):
    cfg, tcfg, _, _ = setup
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(tregistry.get_config("smollm-135m")) == \
        dataclasses.asdict(registry.get_config("smollm-135m"))
    assert tgl.select_taps(tcfg, "qv") == gl.select_taps(cfg, "qv")
    assert {n: (s.d_in, s.d_out, s.stacked) for n, s in
            TM.tap_sites(tcfg).items()} == {
        n: (s.d_in, s.d_out, s.stacked) for n, s in M.tap_sites(cfg).items()}


def test_params_carry_shapes_and_dtypes():
    """Full-size smollm-135m: the port's init has the JAX tree's structure,
    shapes and dtypes (bf16 at full width), and convert keeps bf16."""
    cfg = registry.get_config("smollm-135m").replace(n_layers=2,
                                                    vocab_size=1024)
    tcfg = tregistry.get_config("smollm-135m").replace(n_layers=2,
                                                      vocab_size=1024)
    shapes = jax.eval_shape(lambda: M.init(cfg, jax.random.PRNGKey(0)))
    tparams = TM.init(tcfg, seed=0, device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            _flat(shapes).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in
           _flat(tparams).items()}
    assert got == want
    small = jax.tree.map(lambda s: np.ones(s.shape, s.dtype), shapes)
    conv = convert.params_from_numpy(tcfg, small, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in _flat(conv).values())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("with_adapters", [False, True])
def test_prefill_logits_and_cache_match_jax(setup, with_adapters):
    cfg, tcfg, params, tparams = setup
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    lengths = np.array([16, 9, 1], np.int32)
    users = np.array([1, 0, 1], np.int32)
    bank = _bank(cfg) if with_adapters else None
    spec = tspec = jv = tv = None
    if bank:
        spec = jtaps.make_spec(family="multi_lowrank",
                               taps=gl.select_taps(cfg, "qv"))
        tspec = ttaps.make_spec(family="multi_lowrank",
                                taps=tgl.select_taps(tcfg, "qv"))
        jv, tv = _cola(bank, users, torch_side=False), _cola(bank, users,
                                                             torch_side=True)
    lg, cache = M.prefill(cfg, params, {"tokens": jnp.asarray(toks)}, spec, jv,
                          lengths=jnp.asarray(lengths))
    tlg, tcache = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)},
                             tspec, tv, lengths=torch.as_tensor(lengths))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][n].numpy(),
                                   np.asarray(cache["layers"][n]), **TOL)


def test_decode_step_matches_jax_and_keeps_dead_rows(setup):
    """Scatter a prefill into a slot cache, then one live-masked decode tick:
    logits and the whole cache match JAX, and dead slots' rows are kept."""
    cfg, tcfg, params, tparams = setup
    rng = np.random.default_rng(1)
    slots, max_len = 4, 32
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    slot_ids = np.array([2, 0], np.int32)
    _, pre = M.prefill(cfg, params, {"tokens": jnp.asarray(toks)})
    cache = M.scatter_prefill_cache(M.init_cache(cfg, slots, max_len), pre,
                                    jnp.asarray(slot_ids))
    _, tpre = TM.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    tcache = TM.scatter_prefill_cache(
        TM.init_cache(tcfg, slots, max_len, device="cpu"), tpre, slot_ids)
    before = {n: tcache["layers"][n].clone() for n in ("k", "v")}
    step = {"tokens": rng.integers(0, cfg.vocab_size, (slots, 1)).astype(np.int32),
            "positions": np.array([8, 3, 8, 0], np.int32)}
    live = np.array([True, False, True, False])
    lg, cache = M.decode_step(cfg, params, jax.tree.map(jnp.asarray, step),
                              cache, live=jnp.asarray(live))
    tlg, tcache = TM.decode_step(tcfg, tparams, {k: torch.as_tensor(v) for k, v
                                                 in step.items()},
                                 tcache, live=torch.as_tensor(live))
    np.testing.assert_allclose(tlg.numpy()[live], np.asarray(lg)[live], **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][n].numpy(),
                                   np.asarray(cache["layers"][n]), **TOL)
        dead = ~live
        assert torch.equal(tcache["layers"][n][:, dead], before[n][:, dead])


def test_scatter_prefill_drops_out_of_range_slots(setup):
    cfg, tcfg, _, tparams = setup
    slots, max_len = 3, 16
    pre = {"layers": {n: torch.randn(2, 4, 5, 2, 32) for n in ("k", "v")}}
    cache = TM.init_cache(tcfg, slots, max_len, device="cpu")
    TM.scatter_prefill_cache(cache, pre, np.array([1, 3, -1, 0], np.int32))
    k = cache["layers"]["k"]
    assert torch.equal(k[:, 1, :5], pre["layers"]["k"][:, 0])
    assert torch.equal(k[:, 0, :5], pre["layers"]["k"][:, 3])
    assert torch.count_nonzero(k[:, 2]) == 0 and torch.count_nonzero(
        k[:, :, 5:]) == 0
