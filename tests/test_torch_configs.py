"""The port's registered configs (gpt2-small, smollm-135m, the two mistrals,
gemma2-9b, qwen3-moe-30b-a3b and dbrx-132b) against the JAX package's, field for field, full and
reduced; the reduced uniform-plan configs through ``forward`` and a short
engine run against the JAX package with the same weights (f32, logits
within rtol 1e-4 / atol 1e-5: sums in another order; equal greedy tokens).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

PORTED = ("gpt2-small", "smollm-135m", "mistral-nemo-12b",
          "mistral-large-123b", "gemma2-9b", "qwen3-moe-30b-a3b", "dbrx-132b")
UNIFORM = ("gpt2-small", "mistral-nemo-12b", "mistral-large-123b")


def test_registry_lists_the_ported_configs():
    assert sorted(tregistry.ARCH_MODULES) == sorted(PORTED)
    assert set(PORTED) <= set(registry.ARCH_MODULES)


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax_field_for_field(name, reduced):
    get = "reduced_config" if reduced else "get_config"
    want = dataclasses.asdict(getattr(registry, get)(name))
    got = dataclasses.asdict(getattr(tregistry, get)(name))
    assert got == want


def test_full_moe_configs_match_assignment():
    """The MoE lines of tests/test_models_smoke.py::
    test_full_configs_match_assignment, on the port's registry."""
    c = tregistry.get_config("qwen3-moe-30b-a3b")
    assert (c.n_experts, c.moe_top_k, c.d_expert, c.vocab_size) == \
        (128, 8, 768, 151936)
    c = tregistry.get_config("dbrx-132b")
    assert (c.n_experts, c.moe_top_k, c.d_expert) == (16, 4, 10752)


def test_reduced_gpt2_small_is_mha_with_the_odd_vocabulary_cut():
    """G = 1 (n_kv_heads == n_heads) and vocab 50257 -> 512, as JAX's."""
    cfg = tregistry.reduced_config("gpt2-small")
    assert cfg.n_heads == cfg.n_kv_heads == 4 and cfg.vocab_size == 512
    assert tregistry.get_config("gpt2-small").vocab_size == 50257


def _pair(name):
    cfg = registry.reduced_config(name).replace(n_layers=2)
    tcfg = tregistry.reduced_config(name).replace(n_layers=2)
    key = jax.random.PRNGKey(1)
    params = M.init(cfg, key)
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                        device="cpu")
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    banks, tbanks = [], []
    for u in range(2):   # B nonzero (it is zero at init)
        ad = gl.init_adapters(cfg, cc, jax.random.fold_in(key, 1 + u))
        ad = jax.tree.map(lambda a: a + 0.3 * jax.random.normal(
            jax.random.fold_in(key, 10 + u), a.shape), ad)
        banks.append(ad)
        tbanks.append(convert.adapters_from_numpy(
            jax.tree.map(np.asarray, ad), device="cpu"))
    return (cfg, params, banks), (tcfg, tparams, tbanks)


@pytest.mark.parametrize("name", UNIFORM)
def test_reduced_uniform_configs_forward_and_serve_like_jax(name):
    (cfg, params, banks), (tcfg, tparams, tbanks) = _pair(name)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    lg, _ = M.forward(cfg, params, {"tokens": jnp.asarray(toks)})
    tlg, _ = TM.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), rtol=1e-4,
                               atol=1e-5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 13, 2)]
    outs = []
    for lib, c, p, b, kw in ((jserve, cfg, params, banks, {}),
                             (tserve, tcfg, tparams, tbanks,
                              dict(device="cpu"))):
        eng = lib.ServeEngine(c, p, slots=2, max_len=32, user_adapters=b, **kw)
        reqs = [lib.Request(rid=i, user=i % 2, prompt=pr, max_new=4)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        assert all(r.status == "done" for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[1] == outs[0]
