"""The port's ServeEngine against the JAX ServeEngine on the reduced f32
smollm-135m (2 layers): same weights (carried by ``repro_torch.convert``),
same requests, two users' adapter banks with nonzero B. Greedy tokens must be
equal. One case runs the JAX side under ``ops.set_backend("pallas_interpret")``
at d_head = 64, so the slice is held against the Pallas kernels themselves."""
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402


def _setup(**over):
    cfg = registry.reduced_config("smollm-135m").replace(n_layers=2, **over)
    tcfg = tregistry.reduced_config("smollm-135m").replace(n_layers=2, **over)
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    banks = []
    for u in range(2):   # both users' B nonzero (user 0's B is zero at init)
        ad = gl.init_adapters(cfg, cc, jax.random.fold_in(key, 1 + u))
        banks.append(jax.tree.map(lambda a: a + 0.3 * jax.random.normal(
            jax.random.fold_in(key, 10 + u), a.shape), ad))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                        device="cpu")
    tbanks = [convert.adapters_from_numpy(jax.tree.map(np.asarray, b), device="cpu")
              for b in banks]
    return (cfg, params, banks), (tcfg, tparams, tbanks)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p in lens]


def _run(lib, cfg, params, banks, prompts, *, max_new, **kw):
    eng = lib.ServeEngine(cfg, params, user_adapters=banks, **kw)
    reqs = [lib.Request(rid=i, user=i % 2, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [r.out for r in reqs], eng


@pytest.mark.parametrize("mode", ["batched", "reference"])
def test_engine_tokens_match_jax(mode):
    (cfg, params, banks), (tcfg, tparams, tbanks) = _setup()
    prompts = _prompts(cfg.vocab_size, (1, 5, 12, 9, 20))
    kw = dict(slots=4, max_len=48, prefill_mode=mode, max_new=6)
    want, _ = _run(jserve, cfg, params, banks, prompts, **kw)
    got, eng = _run(tserve, tcfg, tparams, tbanks, prompts, device="cpu", **kw)
    assert got == want
    assert eng.stats["completed"] == len(prompts)
    assert all(len(o) == 6 for o in got)


def test_engine_matches_pallas_kernels_at_head_dim_64():
    (cfg, params, banks), (tcfg, tparams, tbanks) = _setup(
        n_heads=2, n_kv_heads=1, d_head=64)
    prompts = _prompts(cfg.vocab_size, (5, 9, 3), seed=1)
    kw = dict(slots=4, max_len=32, max_new=4)
    jops.set_backend("pallas_interpret")
    try:
        want, _ = _run(jserve, cfg, params, banks, prompts, **kw)
    finally:
        jops.set_backend("ref")
    got, _ = _run(tserve, tcfg, tparams, tbanks, prompts, device="cpu", **kw)
    assert got == want


def test_burst_decode_matches_tick_at_a_time():
    _, (tcfg, tparams, tbanks) = _setup()
    prompts = _prompts(tcfg.vocab_size, (4, 11, 7), seed=2)
    kw = dict(slots=4, max_len=40, max_new=9, device="cpu")
    one, _ = _run(tserve, tcfg, tparams, tbanks, prompts, **kw)
    burst, eng = _run(tserve, tcfg, tparams, tbanks, prompts, decode_burst=4,
                      **kw)
    assert burst == one
    assert eng.stats["ticks"] < 9 * len(prompts)


def test_submit_rejects_bad_requests_and_reports_stats():
    _, (tcfg, tparams, tbanks) = _setup()
    eng = tserve.ServeEngine(tcfg, tparams, slots=2, max_len=16,
                             user_adapters=tbanks, device="cpu")
    bad = [tserve.Request(0, 0, np.zeros(0, np.int32)),
           tserve.Request(1, 0, np.zeros(16, np.int32)),
           tserve.Request(2, 5, np.ones(3, np.int32)),
           tserve.Request(3, 0, np.ones(3, np.int32), max_new=0)]
    for r in bad:
        eng.submit(r)
    assert all(r.done and r.status.startswith("rejected") for r in bad)
    assert eng.stats["rejected"] == 4 and not eng.queue
    ok = tserve.Request(4, 1, np.ones(3, np.int32), max_new=3)
    eng.submit(ok)
    eng.run_until_idle()
    tp = eng.throughput()
    assert ok.status == "done" and len(ok.out) == 3
    assert tp["completed"] == 1 and tp["ttft"]["count"] == 1


def test_unported_options_raise():
    """``telemetry=`` is taken and gives the tokens of ``telemetry=None``
    (the name dates from before the port had telemetry); an empty bank list
    still raises."""
    from repro_torch.telemetry import Telemetry
    _, (tcfg, tparams, tbanks) = _setup()
    prompts = _prompts(tcfg.vocab_size, (3, 9, 5))
    outs = [_run(tserve, tcfg, tparams, tbanks, prompts, max_new=4, slots=2,
                 max_len=32, device="cpu", telemetry=tm)
            for tm in (None, Telemetry(trace=True))]
    assert outs[0][0] == outs[1][0]
    assert outs[1][1].telemetry_snapshot()["serve.completed"] == 3
    with pytest.raises(ValueError):
        tserve.stack_user_adapters([])


def test_session_telemetry_raises():
    """``ColaSession(telemetry=...)`` is taken, not dropped: its channel
    records the rounds, and the losses equal those without it. (The name
    dates from before the port had telemetry.)"""
    from repro_torch.configs.base import ColaConfig as TColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import optimizers
    from repro_torch.telemetry import Telemetry
    _, (tcfg, tparams, _) = _setup()
    batch = SyntheticLM(tcfg, batch=2, seq=8, seed=0,
                        device="cpu").batch_at(0)
    losses = []
    tm = Telemetry(trace=True)
    for telemetry in (None, tm):
        sess = ColaSession(tcfg, TColaConfig(mode="faithful_offload", rank=4),
                           tparams, optimizer=optimizers.sgd(0.1),
                           device="cpu", telemetry=telemetry)
        losses.append([sess.step(batch) for _ in range(2)])
    assert losses[0] == losses[1]
    assert sess.channel.tm is tm
    assert [e["kind"] for e in tm.recorder.events("user", 0)] == [
        "delivered", "commit"] * 2


def test_store_options_take_jax_defaults():
    """``cluster_threshold`` and ``cluster_mode`` exist with JAX's defaults,
    and the defaults, passed explicitly, construct an engine."""
    _, (tcfg, tparams, tbanks) = _setup()
    sigs = [inspect.signature(lib.ServeEngine.__init__).parameters
            for lib in (jserve, tserve)]
    for name in ("resident_slots", "cluster_threshold", "cluster_mode"):
        assert sigs[0][name].default == sigs[1][name].default, name
    eng = tserve.ServeEngine(tcfg, tparams, user_adapters=tbanks, device="cpu",
                             cluster_threshold=None, cluster_mode="shared")
    assert eng.pager is None and eng.bank


@pytest.mark.parametrize("n,floor,want", [(1, 8, 8), (9, 8, 16), (3, 1, 4),
                                          (64, 8, 64)])
def test_bucket_matches_jax(n, floor, want):
    assert tserve._bucket(n, floor) == jserve._bucket(n, floor) == want
