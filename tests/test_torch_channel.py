"""The port's fault-tolerant offload channel and fault injector against the
JAX package's (ports of ``tests/test_faults.py``), on JAX's tiny config
(2 layers, d_model 64, f32): the same weights and initial banks (carried by
``repro_torch.convert``), the same batches and the same injector seeds.

The health counters depend only on the injector's draws and on accept /
reject outcomes, so they must equal JAX's key for key (``backoff_s`` within
float rounding). Losses agree within rtol 1e-4 and banks within rtol 1e-3
of the largest entry of JAX's (XLA's CPU matmuls and PyTorch's sum in other
orders). Inside the port the reference's bit-identity invariants hold
exactly: recovered faults reproduce the fault-free run, and a poisoned peer
never perturbs a healthy user.
"""
import collections
import dataclasses
import json
import os
import time
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import channel as jchannel  # noqa: E402
from repro.core import collab as jcollab  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import collab as tcollab  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime import faults as tfaults  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402
from repro_torch.telemetry import Telemetry as TTelemetry  # noqa: E402
from repro_torch.utils import sorted_leaves  # noqa: E402

STEPS = 8
_OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=128, vocab_size=128)


def _policy(lib, **kw):
    """tests/test_faults.py's virtual-time policy: no sleeps, 6 attempts."""
    kw = {"max_attempts": 6, "timeout_ticks": 2, "backoff_base": 0.0,
          "sleep": lambda s: None, **kw}
    return lib.RetryPolicy(**kw)


def _profile(p):
    """A JAX FaultProfile as the port's."""
    return tfaults.FaultProfile(**dataclasses.asdict(p))


def _injectors(profiles, tms=(None, None)):
    if profiles is None:
        return None, None
    return (jfaults.FaultInjector(profiles, seed=0, telemetry=tms[0]),
            tfaults.FaultInjector({u: _profile(p) for u, p in profiles.items()},
                                  seed=0, telemetry=tms[1]))


def _t(tree):
    return convert.adapters_from_numpy(jax.tree.map(np.asarray, tree),
                                       device="cpu")


def _tnp(tree):
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    return tree.detach().numpy()


@pytest.fixture(scope="module")
def tiny():
    cfg = registry.reduced_config("smollm-135m").replace(**_OVER)
    tcfg = tregistry.reduced_config("smollm-135m").replace(**_OVER)
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                        device="cpu")
    return types.SimpleNamespace(cfg=cfg, tcfg=tcfg, params=params,
                                 tparams=tparams, key=key)


def _run_both(t, profiles=None, *, users=2, steps=STEPS, all_rows_user0=False,
              optimizer="sgd", out_dir=None):
    """The same K-user run through JAX's CollabSession and the port's, the
    port starting from JAX's initial banks; with ``out_dir``, each with a
    tracing ``Telemetry`` (postmortems under ``out_dir``/jax and /torch)
    handed to its injector and session (``session.tm``). Returns (jax
    session, port session, jax losses, port losses)."""
    kw = dict(mode="faithful_offload", family="lowrank", taps="qv", rank=4,
              merged=True, users=users)
    tms = ((JTelemetry(trace=True, out_dir=os.path.join(out_dir, "jax")),
            TTelemetry(trace=True, out_dir=os.path.join(out_dir, "torch")))
           if out_dir is not None else (None, None))
    jinj, tinj = _injectors(profiles, tms)
    jopt_, topt_ = ((jopt.sgd(0.1), topt.sgd(0.1)) if optimizer == "sgd"
                    else (jopt.adamw(1e-2), topt.adamw(1e-2)))
    js = jcollab.CollabSession(t.cfg, ColaConfig(**kw), t.params, t.key,
                               optimizer=jopt_, injector=jinj,
                               policy=_policy(jfaults), telemetry=tms[0])
    ts = tcollab.CollabSession(t.tcfg, tbase.ColaConfig(**kw), t.tparams,
                               optimizer=topt_, injector=tinj,
                               policy=_policy(tfaults), device="cpu",
                               telemetry=tms[1])
    for off, ch, joff in zip(ts.offloaders, ts.channels, js.offloaders):
        ad = _t(joff.adapters)
        off.adapters = ch.last_good = ad
        off.opt_state = off.optimizer.init(ad)
    data = SyntheticLM(t.cfg, batch=4, seq=16, seed=2, users=users)
    jl, tl = [], []
    for step in range(steps):
        b = data.batch_at(step)
        uid = np.zeros(4, np.int32) if all_rows_user0 else b.pop("user_id")
        b.pop("user_id", None)
        jl.append(js.train_step({k: jnp.asarray(v) for k, v in b.items()},
                                jnp.asarray(uid)))
        tl.append(ts.train_step(b, uid))
    return js, ts, jl, tl


def _banks(sess):
    return [_tnp(ch.adapters) for ch in sess.channels]


def _bit_equal(a, b) -> bool:
    return all(np.array_equal(x, y)
               for x, y in zip(sorted_leaves(a), sorted_leaves(b)))


def _close(got, want, rtol=1e-3):
    for g, w in zip(sorted_leaves(got), sorted_leaves(jax.tree.map(
            np.asarray, want))):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()))


def _same_health(ts, js):
    """Every user's health dict equal to JAX's, key for key."""
    for k, (tch, jch) in enumerate(zip(ts.channels, js.channels)):
        th, jh = tch.health(), jch.health()
        assert set(th) == set(jh)
        assert th.pop("backoff_s") == pytest.approx(jh.pop("backoff_s"))
        assert th == jh, f"user {k}"
        assert tch.health_brief() == jch.health_brief()


def _check_against_jax(js, ts, jl, tl):
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _same_health(ts, js)
    for tch, jch in zip(ts.channels, js.channels):
        _close(_tnp(tch.adapters), jch.adapters)
    if ts.channels[0].injector is not None:
        assert (ts.channels[0].injector.injected
                == js.channels[0].injector.injected)


@pytest.fixture(scope="module")
def runs(tiny, tmp_path_factory):
    """``_run_both`` once per module for each set of arguments: every JAX
    run happens here, whichever tests share it. ``telemetry=True`` gives
    both sessions a ``Telemetry`` writing under a fresh directory."""
    cache = {}

    def get(profiles=None, telemetry=False, **kw):
        key = (repr(profiles), telemetry, tuple(sorted(kw.items())))
        if key not in cache:
            out_dir = (str(tmp_path_factory.mktemp("postmortems"))
                       if telemetry else None)
            cache[key] = _run_both(tiny, profiles, out_dir=out_dir, **kw)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def ref_mixed(runs):
    """The fault-free K = 2 run with mixed user rows, both packages."""
    return runs()


@pytest.fixture(scope="module")
def ref_user0_only(runs):
    """The fault-free run with every row belonging to user 0."""
    return runs(all_rows_user0=True)


# ---------------------------------------------------------------------------
# the single-fault chaos matrix
# ---------------------------------------------------------------------------

def test_fault_free_collab_matches_jax(ref_mixed):
    _check_against_jax(*ref_mixed)
    assert all(v == STEPS for v in ref_mixed[1].bank_versions())


@pytest.mark.parametrize("fault", sorted(jfaults.SINGLE_FAULTS))
def test_single_fault_matches_jax(runs, ref_mixed, fault):
    """Under each fault profile on user 1's channel every round completes,
    the health counters equal JAX's, and the port's run equals its own
    fault-free run bit for bit wherever every fault was recovered."""
    js, ts, jl, tl = runs({1: jfaults.SINGLE_FAULTS[fault]})
    _check_against_jax(js, ts, jl, tl)
    assert sum(ts.channels[1].injector.injected.values()) > 0
    h0, h1 = ts.channels[0].health(), ts.channels[1].health()
    assert not h0["quarantined"] and h0["version"] == STEPS
    assert h0["send_retries"] == 0 and h0["rollbacks"] == 0
    assert h1["version"] + h1["rollbacks"] + h1["refused_quarantined"] == STEPS
    if h1["rollbacks"] == 0:
        for got, want in zip(_banks(ts), _banks(ref_mixed[1])):
            assert _bit_equal(got, want), f"{fault}: bank diverged"
        assert tl == ref_mixed[3]


@pytest.mark.parametrize("fault", ["drop", "delay", "duplicate"])
def test_recoverable_faults_are_bit_exact(runs, ref_mixed, fault):
    """Resend, dedup and late delivery are lossless: faults fired, nothing
    rolled back, and banks and losses equal the fault-free run's bits."""
    _, ts, _, tl = runs({1: jfaults.SINGLE_FAULTS[fault]})
    assert ts.channels[1].injector.injected[fault] > 0
    assert ts.channels[1].health()["rollbacks"] == 0
    for got, want in zip(_banks(ts), _banks(ref_mixed[1])):
        assert _bit_equal(got, want)
    assert tl == ref_mixed[3]


def test_poisoned_peer_quarantined_healthy_user_bit_exact(tiny, runs,
                                                          ref_user0_only):
    """Every adapter return of user 1 is NaN-poisoned: each is rejected,
    user 1 is rolled back to its initial bank and quarantined, and user 0's
    training equals the fault-free run bit for bit; only validated version
    bumps reach a serve engine."""
    js, ts, jl, tl = runs(
        {1: jfaults.FaultProfile(nan=1.0, targets=("adapters",))},
        all_rows_user0=True)
    _check_against_jax(js, ts, jl, tl)
    ch0, ch1 = ts.channels
    assert ch1.quarantined and not ch0.quarantined
    assert ch1.version == 0 and ch0.version == STEPS
    assert ch1.health()["fit_rejected"] > 0 and ch1.health()["rollbacks"] >= 2
    assert len(ch1.dead_letters) >= 2 and ch1.health()["refused_quarantined"] > 0
    assert not ch1.offloader.buffers
    ref = ref_user0_only[1]
    for got, want in zip(_banks(ts), _banks(ref)):
        assert _bit_equal(got, want)
    assert tl == ref_user0_only[3]

    init = [_t(j.adapters) for j in ref_user0_only[0].offloaders]
    eng = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=2, max_len=32,
                             user_adapters=init, device="cpu")
    before = {t: {n: l.clone() for n, l in e.items()}
              for t, e in eng.bank.items()}
    assert tserve.publish_banks(eng, ts.channels) == 1
    assert eng.bank_versions.tolist() == [STEPS, 0]
    for tap, e in eng.bank.items():
        for name, leaf in e.items():
            assert torch.equal(leaf[:, 1], before[tap][name][:, 1])


# ---------------------------------------------------------------------------
# K = 4: the chip smoke's runtime maps (b) and (c), at the tiny size
# ---------------------------------------------------------------------------

_K4_ZERO = ("send_retries", "late_deliveries", "dup_discarded", "rollbacks",
            "corrupt_rejected", "nan_rejected", "late_dropped", "dead_letters",
            "fit_rejected", "refused_quarantined", "fit_timeouts", "fit_errors")


def _zero_but(h, **want):
    for k in _K4_ZERO:
        assert h[k] == want.get(k, 0), (k, h[k])


def test_k4_recoverable_map_counters(runs):
    """Drop on user 1, delay on 2, duplicate on 3, AdamW, 6 steps: JAX's
    counters (drop 12, delay 4, duplicate 8 injected; 12 send retries, 4
    late deliveries, 4 duplicates discarded), every user at version 6."""
    f = jfaults.SINGLE_FAULTS
    js, ts, jl, tl = runs({1: f["drop"], 2: f["delay"], 3: f["duplicate"]},
                          users=4, steps=6, optimizer="adamw")
    _check_against_jax(js, ts, jl, tl)
    assert ts.channels[0].injector.injected == {
        "drop": 12, "delay": 4, "duplicate": 8, "corrupt": 0, "nan": 0}
    hs = ts.channel_health()
    _zero_but(hs[0])
    _zero_but(hs[1], send_retries=12)
    _zero_but(hs[2], late_deliveries=4)
    _zero_but(hs[3], dup_discarded=4)
    assert ts.bank_versions() == [6, 6, 6, 6]
    ref = runs(users=4, steps=6, optimizer="adamw")[1]
    for got, want in zip(_banks(ts), _banks(ref)):
        assert _bit_equal(got, want)


def test_k4_poisoned_peer_counters(runs):
    """Every row to user 0, user 1's returns NaN-poisoned: quarantined at
    version 0 with 2 rollbacks, 12 rejected fits, 4 refused pushes and 2
    dead letters; the others at version 6."""
    js, ts, jl, tl = runs(
        {1: jfaults.FaultProfile(nan=1.0, targets=("adapters",))},
        users=4, steps=6, all_rows_user0=True, optimizer="adamw")
    _check_against_jax(js, ts, jl, tl)
    h1 = ts.channel_health()[1]
    _zero_but(h1, rollbacks=2, fit_rejected=12, refused_quarantined=4,
              dead_letters=2)
    assert h1["quarantined"] and len(ts.channels[1].dead_letters) == 2
    assert ts.bank_versions() == [6, 0, 6, 6]


# ---------------------------------------------------------------------------
# the quarantine postmortem (tests/test_faults.py), against JAX's
# ---------------------------------------------------------------------------

def _postmortems(tm):
    return [(p["scope"], p["key"], p["reason"],
             [e["kind"] for e in p["events"]],
             [e.get("seq") for e in p["events"]]) for p in tm.recorder.postmortems]


def test_quarantine_postmortem_names_failing_seq(runs, ref_user0_only):
    """A chaos quarantine run freezes a flight-recorder postmortem for the
    poisoned user whose ring names the failing channel seq ids: injected
    fault, rejection, rollback and the final quarantine. The port's
    postmortems equal JAX's: reasons, event kinds and seq ids."""
    js, ts, jl, tl = runs(
        {1: jfaults.FaultProfile(nan=1.0, targets=("adapters",))},
        all_rows_user0=True, telemetry=True)
    _check_against_jax(js, ts, jl, tl)
    # telemetry on changes nothing: the fault map's run without it
    plain = runs({1: jfaults.FaultProfile(nan=1.0, targets=("adapters",))},
                 all_rows_user0=True)
    assert tl == plain[3]
    for got, want in zip(_banks(ts), _banks(plain[1])):
        assert _bit_equal(got, want)
    tm = ts.tm
    assert _postmortems(tm) == _postmortems(js.tm)
    ch1 = ts.channels[1]
    assert ch1.quarantined
    h = ch1.health()
    assert h["last_error"] == "quarantined" or "adapter" in h["last_error"] \
        or "finite" in h["last_error"]
    assert isinstance(h["last_error_seq"], int)

    pms = [p for p in tm.recorder.postmortems
           if p["scope"] == "user" and p["key"] == 1]
    assert pms, "quarantine run must dump user-1 postmortems"
    q = [p for p in pms if p["reason"].startswith("quarantined after")]
    assert len(q) == 1, "exactly one quarantine postmortem for the user"
    pm = q[0]
    kinds = [e["kind"] for e in pm["events"]]
    assert "fault_injected" in kinds
    assert "fit_rejected" in kinds
    assert "rollback" in kinds and "quarantine" in kinds
    failing = [e["seq"] for e in pm["events"]
               if e["kind"] in ("fit_rejected", "rollback") and "seq" in e]
    assert failing and all(isinstance(s, int) for s in failing)
    assert h["last_error_seq"] in failing
    assert pm["path"] and os.path.exists(pm["path"])
    assert os.path.basename(pm["path"]) == os.path.basename(
        [p for p in js.tm.recorder.postmortems
         if p["reason"].startswith("quarantined after")][0]["path"])
    with open(pm["path"]) as f:
        on_disk = json.load(f)
    assert on_disk["reason"] == pm["reason"]
    assert [e["kind"] for e in on_disk["events"]] == kinds
    assert not any(p["key"] == 0 for p in tm.recorder.postmortems
                   if p["scope"] == "user")
    # the spans: one offload round a user a step, the same as JAX's
    names = [collections.Counter(e["name"] for e in t.tracer.events
                                 if e["ph"] == "X") for t in (tm, js.tm)]
    assert names[0] == names[1]
    assert names[0]["session.offload_round"] == 2 * STEPS


# ---------------------------------------------------------------------------
# the injector: JAX's draws, leaf order, copies, bf16
# ---------------------------------------------------------------------------

def _payload_np(seed=0):
    rng = np.random.default_rng(seed)
    # keys out of sorted order: the leaf index must follow jax.tree.leaves
    return {"layers.attn.v": (rng.standard_normal((2, 3, 8)).astype(np.float32),
                              rng.standard_normal((2, 3, 4)).astype(np.float32)),
            "layers.attn.q": (rng.standard_normal((2, 3, 8)).astype(np.float32),
                              rng.standard_normal((2, 3, 8)).astype(np.float32))}


def _torch_payload(p):
    return {k: tuple(torch.from_numpy(a.copy()) for a in v)
            for k, v in p.items()}


@pytest.mark.parametrize("scale", [1e6, None], ids=["corrupt", "nan"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_poison_tree_matches_jax_draw_for_draw(scale, seed):
    """At f32 the port mangles the same leaf at the same positions with the
    same values as JAX, and leaves the sender's tensors untouched."""
    p = _payload_np()
    tp = _torch_payload(p)
    clean = {k: tuple(a.clone() for a in v) for k, v in tp.items()}
    want = jfaults._poison_tree(p, np.random.default_rng(seed), scale)
    got = tfaults._poison_tree(tp, np.random.default_rng(seed), scale)
    assert list(got) == list(tp)
    for g, w in zip(sorted_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert _bit_equal(_tnp_tuple(tp), _tnp_tuple(clean))


def _tnp_tuple(tree):
    return {k: tuple(a.numpy() for a in v) for k, v in tree.items()}


def test_reference_skips_bf16_leaves_the_port_poisons_them():
    """JAX's mangle skips a leaf numpy does not call floating, and
    ``ml_dtypes.bfloat16`` is not (src/repro/runtime/faults.py:87): a
    corrupt bf16 leaf passes through unchanged there. The port corrupts it."""
    x = np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)
    jbf = jnp.asarray(x, jnp.bfloat16)
    want = jfaults.FaultInjector(
        {0: jfaults.FaultProfile(corrupt=1.0)}, seed=0).transmit(
            0, "payload", {"x": jbf})[0].obj
    assert np.array_equal(np.asarray(want["x"], np.float32),
                          np.asarray(jbf, np.float32))
    tbf = torch.from_numpy(x).to(torch.bfloat16)
    got = tfaults.FaultInjector(
        {0: tfaults.FaultProfile(corrupt=1.0)}, seed=0).transmit(
            0, "payload", {"x": tbf})[0].obj
    assert got["x"].dtype == torch.bfloat16
    assert not torch.equal(got["x"], tbf)
    assert int((got["x"] != tbf).sum()) == 64 // 8
    assert torch.equal(tbf, torch.from_numpy(x).to(torch.bfloat16))


def test_injector_is_deterministic_per_user():
    prof = tfaults.FaultProfile(drop=0.5, corrupt=0.3)
    a = tfaults.FaultInjector({1: prof}, seed=7)
    b = tfaults.FaultInjector({1: prof}, seed=7)
    j = jfaults.FaultInjector({1: jfaults.FaultProfile(drop=0.5, corrupt=0.3)},
                              seed=7)
    obj, jobj = _torch_payload(_payload_np()), _payload_np()

    def outcomes(inj, o):
        return [len(inj.transmit(1, "payload", o)) for _ in range(50)]

    assert outcomes(a, obj) == outcomes(b, obj) == outcomes(j, jobj)
    assert a.injected == b.injected == j.injected
    # healthy users draw from their own stream
    assert len(a.transmit(0, "payload", obj)) == 1
    assert a.injected == b.injected


def test_telemetry_is_not_ported_yet():
    """The injector and the channel take a ``Telemetry`` and give the same
    results as with None: the same draws, the same acceptances, the same
    health. (The name dates from before the port had telemetry.)"""
    prof = jfaults.FaultProfile(drop=0.3, delay=0.2, duplicate=0.3,
                                corrupt=0.2, nan=0.2)
    out = []
    for tm in (None, TTelemetry()):
        inj = tfaults.FaultInjector({0: _profile(prof)}, seed=5, telemetry=tm)
        ch = tchannel.OffloadChannel(StubOffloader(), injector=inj,
                                     policy=_policy(tfaults), telemetry=tm)
        pushed = [ch.push(_payload(float(i + 1))) for i in range(6)]
        fits = [ch.fit_round() is not None for _ in range(2)]
        out.append((pushed, fits, ch.health(), dict(inj.injected),
                    float(ch.adapters["w"][0])))
        if tm is not None:
            kinds = [e["kind"] for e in tm.recorder.events("user", 0)]
            assert kinds.count("fault_injected") == sum(inj.injected.values())
            assert "delivered" in kinds
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# channel mechanics against a stub offloader (no model, milliseconds)
# ---------------------------------------------------------------------------

class StubOffloader:
    """Duck-typed Offloader: a fit adds ``fit_delta`` to the single weight."""

    def __init__(self, fit_s: float = 0.0, fit_delta: float = 1.0):
        self.adapters = {"w": torch.zeros(3)}
        self.opt_state = {}
        self.buffers: dict[str, list] = {}
        self._pushes = 0
        self.interval = 1
        self.fit_s = fit_s
        self.fit_delta = fit_delta
        self.fits = 0

    @property
    def ready(self):
        return self._pushes > 0 and bool(self.buffers)

    def push(self, data):
        self.buffers.setdefault("t", []).append(data)
        self._pushes += 1

    def maybe_fit(self):
        if not self.ready:
            return None
        if self.fit_s:
            time.sleep(self.fit_s)
        self.adapters = {"w": self.adapters["w"] + self.fit_delta}
        self.buffers.clear()
        self.fits += 1
        return self.adapters


def _payload(v=1.0):
    return {"t": (torch.full((4,), v), torch.full((4,), 2 * v))}


def _channel(profile=None, seed=0, **kw):
    injector = (tfaults.FaultInjector({0: profile}, seed=seed)
                if profile is not None else None)
    return tchannel.OffloadChannel(StubOffloader(), injector=injector,
                                   policy=kw.pop("policy", _policy(tfaults)),
                                   **kw)


def test_duplicates_are_deduped():
    ch = _channel(tfaults.FaultProfile(duplicate=1.0))
    for i in range(5):
        assert ch.push(_payload(i + 1))
    assert ch.offloader._pushes == 5          # exactly-once delivery
    assert ch.health()["dup_discarded"] == 5


def test_corrupt_payload_is_never_buffered():
    ch = _channel(tfaults.FaultProfile(corrupt=1.0))
    data = _payload()
    assert not ch.push(data)          # every copy corrupt -> dead letter
    h = ch.health()
    assert ch.offloader._pushes == 0
    assert h["corrupt_rejected"] == 6
    assert h["dead_letter_count"] == 1
    assert ch.dead_letters[0].kind == "payload"
    assert torch.equal(data["t"][0], torch.ones(4))   # the sender's is clean


def test_nan_payload_rejected_at_source_too():
    """A NaN gradient made by the server is caught by payload validation
    instead of poisoning the offload buffers."""
    ch = _channel(None)
    bad = {"t": (torch.full((4,), float("nan")), torch.ones(4))}
    assert not ch.push(bad)
    assert ch.offloader._pushes == 0
    assert ch.health()["nan_rejected"] == 6


def test_delay_within_window_is_late_but_delivered():
    ch = _channel(tfaults.FaultProfile(delay=1.0, delay_ticks=2))
    assert ch.push(_payload())
    h = ch.health()
    assert h["late_deliveries"] == 1 and h["late_dropped"] == 0


def test_delay_beyond_window_times_out():
    ch = _channel(tfaults.FaultProfile(delay=1.0, delay_ticks=10))
    assert not ch.push(_payload())
    h = ch.health()
    assert h["late_dropped"] == 6
    assert h["dead_letter_count"] == 1


def test_fit_timeout_rolls_back_and_quarantines():
    off = StubOffloader(fit_s=0.25)
    policy = tfaults.RetryPolicy(max_attempts=2, timeout_s=0.02,
                                 backoff_base=0.0, sleep=lambda s: None)
    ch = tchannel.OffloadChannel(off, policy=policy, quarantine_after=1)
    ch.push(_payload())
    assert ch.fit_round() is None
    h = ch.health()
    assert h["fit_timeouts"] == 2 and h["rollbacks"] == 1
    assert ch.quarantined and ch.version == 0
    # the abandoned fits keep running on their worker threads; once they
    # land, reset() fences them off by re-asserting the last-good bank
    time.sleep(0.6)
    ch.reset()
    assert not ch.quarantined and not ch.offloader.buffers
    assert torch.equal(ch.adapters["w"], torch.zeros(3))


def test_fit_on_a_worker_thread_gives_the_same_bank():
    """A fit under ``timeout_s`` (on the worker thread) commits the same bank
    as the same fit on the caller's thread."""
    banks = []
    for timeout_s in (None, 60.0):
        ch = tchannel.OffloadChannel(StubOffloader(), policy=_policy(
            tfaults, timeout_s=timeout_s))
        ch.push(_payload())
        banks.append(ch.fit_round())
    assert torch.equal(banks[0]["w"], banks[1]["w"])


def test_update_norm_guard_rejects_exploding_bank():
    off = StubOffloader(fit_delta=1e9)
    ch = tchannel.OffloadChannel(off, policy=_policy(tfaults),
                                 max_update_norm=1e3, quarantine_after=1)
    ch.push(_payload())
    assert ch.fit_round() is None
    h = ch.health()
    assert h["fit_rejected"] == 6 and h["rollbacks"] == 1
    assert torch.equal(ch.adapters["w"], torch.zeros(3))
    assert "update norm" in ch.dead_letters[-1].reason


def test_commit_bumps_version_and_snapshots_last_good():
    ch = _channel(None)
    for i in range(3):
        ch.push(_payload(i + 1))
        assert ch.fit_round() is not None
    assert ch.version == 3
    assert torch.equal(ch.last_good["w"], torch.full((3,), 3.0))


def test_backoff_schedule_and_accounting():
    policy = tfaults.RetryPolicy(max_attempts=4, backoff_base=1.0,
                                 backoff_mult=2.0, backoff_max=100.0,
                                 jitter=0.0, sleep=lambda s: None)
    rng = np.random.default_rng(0)
    assert [policy.backoff(a, rng) for a in (1, 2, 3)] == [1.0, 2.0, 4.0]
    ch = tchannel.OffloadChannel(
        StubOffloader(), injector=tfaults.FaultInjector(
            {0: tfaults.FaultProfile(drop=1.0)}), policy=policy)
    assert not ch.push(_payload())
    assert ch.health()["backoff_s"] == pytest.approx(1.0 + 2.0 + 4.0 + 8.0)


@pytest.mark.parametrize("case", ["dedup", "corrupt", "nan", "late",
                                  "timeout", "norm"])
def test_stub_health_matches_jax(case):
    """The stub mechanics give JAX's health dicts, key for key."""
    class JStub(StubOffloader):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.adapters = {"w": np.zeros(3, np.float32)}

        def maybe_fit(self):
            if not self.ready:
                return None
            self.adapters = {"w": self.adapters["w"] + self.fit_delta}
            self.buffers.clear()
            return self.adapters

    prof = {"dedup": dict(duplicate=1.0), "corrupt": dict(corrupt=0.5),
            "nan": dict(nan=0.5), "late": dict(delay=0.5, delay_ticks=3)
            }.get(case)
    out = []
    for lib, stub, pay in (
            (jfaults, JStub, lambda v: {"t": (np.full(4, v, np.float32),
                                              np.full(4, 2 * v, np.float32))}),
            (tfaults, StubOffloader, _payload)):
        chlib = jchannel if lib is jfaults else tchannel
        off = stub(fit_delta=1e9 if case == "norm" else 1.0)
        inj = (lib.FaultInjector({0: lib.FaultProfile(**prof)}, seed=3)
               if prof else None)
        ch = chlib.OffloadChannel(off, injector=inj, policy=_policy(lib),
                                  max_update_norm=1e3)
        for i in range(6):
            ch.push(pay(float(i + 1)))
            ch.fit_round()
        h = ch.health()
        out.append((h.pop("backoff_s"), h))
    assert out[0][1] == out[1][1]
    assert out[0][0] == pytest.approx(out[1][0])


# ---------------------------------------------------------------------------
# the channel's on_commit hook drives the serve engine's hot-swap
# ---------------------------------------------------------------------------

class _BankOffloader:
    """Duck-typed Offloader whose bank is a real engine-shaped adapter tree;
    every fit nudges each leaf (so commits are validated version bumps)."""

    def __init__(self, adapters):
        self.adapters = adapters
        self.opt_state = {}
        self.buffers: dict[str, list] = {}
        self._pushes = 0

    @property
    def ready(self):
        return bool(self.buffers)

    def push(self, data):
        self.buffers.setdefault("t", []).append(data)
        self._pushes += 1

    def maybe_fit(self):
        if not self.ready:
            return None
        self.adapters = {t: {n: a + 0.01 for n, a in e.items()}
                         for t, e in self.adapters.items()}
        self.buffers.clear()
        return self.adapters


def _serve(eng, prompt, user):
    r = tserve.Request(rid=0, user=user, prompt=prompt, max_new=5)
    eng.submit(r)
    eng.run_until_idle()
    return r.out


def test_channel_on_commit_pushes_into_serving(tiny):
    """The push-based publication path: a validated commit lands in the
    engine's store through on_commit, with no publish_banks sweep."""
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    bank = _t(jax.tree.map(lambda a: a + 0.1 * jax.random.normal(
        jax.random.fold_in(tiny.key, 1000), a.shape),
        gl.init_adapters(tiny.cfg, cc, jax.random.fold_in(tiny.key, 0))))
    eng = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=1, max_len=64,
                             user_adapters=[bank], resident_slots=1,
                             device="cpu")
    seen = []

    def commit(user, version, adapters):
        seen.append((user, version))
        assert eng.install_adapters(user, adapters, version)

    ch = tchannel.OffloadChannel(_BankOffloader(bank), user=0,
                                 on_commit=commit)
    ch.push({"t": (torch.ones(4), torch.ones(4))})
    committed = ch.fit_round()
    assert committed is not None and seen == [(0, 1)]
    assert eng.store.version(0) == 1 and eng.stats["bank_installs"] == 1
    prompt = np.random.default_rng(0).integers(0, 128, 6).astype(np.int32)
    solo = tserve.ServeEngine(tiny.tcfg, tiny.tparams, slots=1, max_len=64,
                              user_adapters=[committed], device="cpu")
    assert _serve(eng, prompt, 0) == _serve(solo, prompt, 0)


# ---------------------------------------------------------------------------
# ColaSession through the channel; the watchdog's recovery hook
# ---------------------------------------------------------------------------

def _session(tiny, **kw):
    cc = tbase.ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                          rank=4)
    return tsession.ColaSession(tiny.tcfg, cc, tiny.tparams,
                                optimizer=topt.sgd(0.1), device="cpu", **kw)


def test_session_rejects_a_nan_payload_through_the_channel(tiny):
    """A NaN in the server's adaptation data is refused by the channel's
    payload check (dead-lettered after its retries); the bank stays."""
    sess = _session(tiny, policy=_policy(tfaults))
    data = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=3,
                                 device="cpu")
    sess.step(data.batch_at(0))
    bank = _tnp(sess.adapters)
    # a diverged server: NaN activations and gradients at every tap
    sess.base_params = {**sess.base_params, "final_norm": {
        "scale": sess.base_params["final_norm"]["scale"] * float("nan")}}
    assert np.isnan(sess.step(data.batch_at(1)))
    h = sess.channel_health()[0]
    assert h["nan_rejected"] == 6 and h["dead_letters"] == 1
    assert h["version"] == 1
    assert _bit_equal(_tnp(sess.adapters), bank)


def test_straggler_recovery_checkpoints_and_resets_channels(tiny, tmp_path):
    sess = _session(tiny)
    data = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=3,
                                 device="cpu")
    loop = ttrain.TrainLoop(sess, data, str(tmp_path), ckpt_every=100,
                            recover_on_straggler=True)
    loop.run(2, resume=False)
    # a hung offload round: quarantined channel and stale buffers
    sess.channel.quarantined = True
    sess.offloader.buffers["junk"] = [object()]
    loop._on_straggler(2, dt=9.9, med=0.1)
    assert loop.recoveries == 1
    assert not sess.channel.quarantined
    assert not sess.offloader.buffers
    loop.ckpt.wait()
    assert loop.ckpt.latest_step() is not None
    summary = loop.run(3, resume=False)
    assert "channel_health" in summary and 0 in summary["channel_health"]
    assert summary["heartbeat_failures"] == 0
