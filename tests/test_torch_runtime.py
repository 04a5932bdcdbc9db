"""The port's training runtime against the JAX package's (ports of
``tests/test_runtime.py``, the collab tests of
``tests/test_session_offload.py`` and ``tests/test_offload_int8.py``), on
JAX's tiny config (2 layers, d_model 64, f32) and the quickstart's:
checkpoints that restore across the two packages both ways (bf16 included),
train-loop restart bit for bit inside the port and within tolerance of JAX
(also resuming a checkpoint JAX wrote), the watchdog, ``ByteCorpus``, K-user
row masking and collaboration, the int8 transfer, and the 30-step loss
trajectory of ``examples/quickstart.py``.

Tolerances (f32): losses rtol 1e-4 over a few steps and 1e-3 over the
quickstart's 30 (XLA's CPU matmuls and PyTorch's sum in other orders; Adam
follows the sign of small gradients); adapters rtol 1e-3 of the largest entry.
"""
import dataclasses
import json
import os
import shutil
import time
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import offload as joffload  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro.telemetry.metrics import percentiles as jpercentiles  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import collab as tcollab  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.core import offload as toffload  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime import checkpoint as tckpt  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402
from repro_torch.runtime import watchdog as twatch  # noqa: E402
from repro_torch.utils import sorted_leaves  # noqa: E402

_OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=128, vocab_size=128)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.adapters_from_numpy(_np(tree), device="cpu")


def _tnp(tree):
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _bit_equal(a, b) -> bool:
    return all(np.array_equal(x, y)
               for x, y in zip(sorted_leaves(a), sorted_leaves(b)))


def _close(got, want, rtol=1e-3):
    for g, w in zip(sorted_leaves(got), sorted_leaves(_np(want))):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()))


@pytest.fixture(scope="module")
def tiny():
    cfg = registry.reduced_config("smollm-135m").replace(**_OVER)
    tcfg = tregistry.reduced_config("smollm-135m").replace(**_OVER)
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    return types.SimpleNamespace(cfg=cfg, tcfg=tcfg, params=params,
                                 tparams=tparams, key=key)


# ---------------------------------------------------------------------------
# checkpoints, and across the two packages
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_retention(tmp_path):
    cm = tckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)},
            "step": 7}
    for s in (1, 2, 3):
        cm.save(s, tree)
    assert cm.steps() == [2, 3]
    step, back = cm.restore()
    assert step == 3
    assert back["a"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["a"]["w"], tree["a"]["w"])
    assert int(back["step"]) == 7


def test_checkpoint_async_and_atomic(tmp_path):
    cm = tckpt.CheckpointManager(str(tmp_path), keep=3)
    w = torch.ones((128, 128))
    cm.save_async(10, {"w": w})
    w.add_(1.0)                  # the host copy was taken before the return
    cm.wait()
    assert cm.latest_step() == 10
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    assert torch.equal(cm.restore()[1]["w"], torch.ones((128, 128)))


def _mixed_tree(rng):
    x = rng.standard_normal((3, 5)).astype(np.float32)
    return {"layers.attn.q": {"A": x, "B": x[:2] * 3},
            "bf": {"w": x.astype(np.float32)},
            "step": np.asarray(9, np.int32)}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """Keys, values and dtypes of a JAX-written checkpoint (f32, bf16, int32)
    come back in the port as CPU tensors."""
    tree = _mixed_tree(np.random.default_rng(0))
    jtree = {**jax.tree.map(jnp.asarray, tree),
             "bf": {"w": jnp.asarray(tree["bf"]["w"], jnp.bfloat16)}}
    jckpt.CheckpointManager(str(tmp_path)).save(5, jtree)
    step, back = tckpt.CheckpointManager(str(tmp_path)).restore()
    assert step == 5
    assert back["bf"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["bf"]["w"].float().numpy(),
                                  np.asarray(jtree["bf"]["w"], np.float32))
    for tap in ("A", "B"):
        got = back["layers.attn.q"][tap]
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), tree["layers.attn.q"][tap])
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 9


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = _mixed_tree(np.random.default_rng(1))
    ttree = {"layers.attn.q": {k: torch.from_numpy(v) for k, v in
                               tree["layers.attn.q"].items()},
             "bf": {"w": torch.from_numpy(tree["bf"]["w"]).to(torch.bfloat16)},
             "step": 9}
    cm = tckpt.CheckpointManager(str(tmp_path))
    cm.save_async(4, ttree)
    cm.wait()
    step, back = jckpt.CheckpointManager(str(tmp_path)).restore()
    assert step == 4
    assert back["bf"]["w"].dtype == np.dtype("bfloat16")
    np.testing.assert_array_equal(np.asarray(back["bf"]["w"], np.float32),
                                  ttree["bf"]["w"].float().numpy())
    for tap in ("A", "B"):
        assert back["layers.attn.q"][tap].dtype == np.float32
        np.testing.assert_array_equal(back["layers.attn.q"][tap],
                                      tree["layers.attn.q"][tap])
    assert int(back["step"]) == 9


# ---------------------------------------------------------------------------
# train-loop restart
# ---------------------------------------------------------------------------

_LORA = dict(mode="lora", family="lowrank", taps="qv", rank=4)
_MODE_A = dict(mode="faithful_offload", family="lowrank", taps="qv", rank=4)


def _jax_session(t, kw, optimizer):
    return jsession.ColaSession(t.cfg, ColaConfig(**kw), t.params, t.key,
                                optimizer=optimizer)


def _port_session(t, kw, optimizer, start):
    """The port's session from JAX's initial adapters ``start``."""
    s = tsession.ColaSession(t.tcfg, tbase.ColaConfig(**kw), t.tparams,
                             optimizer=optimizer, device="cpu")
    ad = _t(start)
    s.adapters = ad
    if kw["mode"] == "lora":
        s.opt_state = s.optimizer.init(ad)
    else:
        s.offloader.adapters = s.channel.last_good = ad
        s.offloader.opt_state = s.optimizer.init(ad)
    return s


@pytest.fixture(scope="module")
def jax_restart(tiny, tmp_path_factory):
    """JAX's TrainLoop: 8 uninterrupted steps (lora, SGD) and 8 (Mode A,
    AdamW), and a Mode A run stopped at step 4 whose checkpoint the port
    resumes."""
    d = tmp_path_factory.mktemp("jax_restart")
    data = jpipeline.SyntheticLM(tiny.cfg, batch=4, seq=16, seed=3)
    out = {}
    for name, kw, mk in (("lora", _LORA, lambda: jopt.sgd(0.05)),
                         ("mode_a", _MODE_A, lambda: jopt.adamw(1e-2))):
        sess = _jax_session(tiny, kw, mk())
        start = _np(sess.adapters)
        jtrain.TrainLoop(sess, data, str(d / name), ckpt_every=2).run(
            8, resume=False)
        out[name] = (start, _np(sess.adapters), _np(
            sess.offloader.opt_state if kw["mode"] != "lora"
            else sess.opt_state))
    half = _jax_session(tiny, _MODE_A, jopt.adamw(1e-2))
    jtrain.TrainLoop(half, data, str(d / "half"), ckpt_every=2).run(
        4, resume=False)
    out["half"] = str(d / "half")
    return out


@pytest.mark.parametrize("name", ["lora", "mode_a"])
def test_train_loop_restart_is_bit_exact_and_matches_jax(tiny, jax_restart,
                                                         tmp_path, name):
    """8 uninterrupted steps, against 4 steps and a new loop and session that
    resume to 8: adapters and optimizer state equal bit for bit, and within
    tolerance of JAX's 8 steps."""
    kw, mk = ((_LORA, lambda: topt.sgd(0.05)) if name == "lora"
              else (_MODE_A, lambda: topt.adamw(1e-2)))
    start, want, want_opt = jax_restart[name]
    data = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=3,
                                 device="cpu")

    def loop(sub):
        return ttrain.TrainLoop(_port_session(tiny, kw, mk(), start), data,
                                str(tmp_path / sub), ckpt_every=2)

    full = loop("a")
    full.run(8, resume=False)
    loop("b").run(4, resume=False)
    resumed = loop("b")
    resumed.run(8, resume=True)
    assert resumed.session.step_count == 8
    assert full.losses[4:] == resumed.losses
    assert _bit_equal(_tnp(full.session.adapters),
                      _tnp(resumed.session.adapters))
    opt = (resumed.session.opt_state if name == "lora"
           else resumed.session.offloader.opt_state)
    ref_opt = (full.session.opt_state if name == "lora"
               else full.session.offloader.opt_state)
    assert type(opt["step"]) is int and opt["step"] == ref_opt["step"]
    assert _bit_equal(_tnp({k: v for k, v in opt.items() if k != "step"}),
                      _tnp({k: v for k, v in ref_opt.items() if k != "step"}))
    _close(_tnp(resumed.session.adapters), want)
    assert opt["step"] == int(want_opt["step"])
    with open(tmp_path / "b" / "metrics.jsonl") as f:
        rec = json.loads([line for line in f if line.strip()][-1])
    assert set(rec) == {"step", "loss", "dt", "watchdog", "channel_health"}
    assert (set(rec["channel_health"]) == ({"0"} if name == "mode_a"
                                           else set()))


def test_port_resumes_a_checkpoint_jax_wrote(tiny, jax_restart, tmp_path):
    """JAX's Mode A run stopped at step 4 (AdamW, a 0-d int32 step in the
    checkpoint); the port resumes it to 8 and lands within tolerance of
    JAX's 8 uninterrupted steps, its optimizer step a Python int."""
    start, want, _ = jax_restart["mode_a"]
    data = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=3,
                                 device="cpu")
    shutil.copytree(os.path.join(jax_restart["half"], "ckpt"),
                    tmp_path / "ckpt")
    sess = _port_session(tiny, _MODE_A, topt.adamw(1e-2), start)
    loop = ttrain.TrainLoop(sess, data, str(tmp_path), ckpt_every=100)
    loop.run(8, resume=True)
    assert sess.step_count == 8
    assert type(sess.offloader.opt_state["step"]) is int
    assert sess.offloader.opt_state["step"] == 8
    assert _bit_equal(_tnp(sess.channel.last_good), _tnp(sess.adapters))
    _close(_tnp(sess.adapters), want)


# ---------------------------------------------------------------------------
# watchdog and data
# ---------------------------------------------------------------------------

def test_watchdog_flags_stragglers():
    events = []
    wd = twatch.Watchdog(threshold=3.0, on_straggler=lambda *a: events.append(a))
    for step in range(12):
        wd.start_step()
        time.sleep(0.001)
        wd.end_step(step)
    wd.start_step()
    time.sleep(0.05)
    wd.end_step(99)
    assert wd.stragglers and wd.stragglers[-1][0] == 99
    assert events
    assert wd.summary()["stragglers"] == len(wd.stragglers)
    assert set(wd.brief()) == {"steps", "stragglers", "heartbeat_failures",
                               "median_s", "p95_s"}


def test_watchdog_end_step_without_start_raises():
    wd = twatch.Watchdog()
    with pytest.raises(twatch.WatchdogError, match="without a matching"):
        wd.end_step(0)
    assert not issubclass(twatch.WatchdogError, AssertionError)


def test_watchdog_heartbeat_survives_disk_errors(tmp_path):
    good = twatch.Watchdog(heartbeat_path=str(tmp_path / "hb.json"))
    good.start_step()
    good.end_step(0)
    assert good.stats == {"steps": 1, "heartbeats": 1, "heartbeat_failures": 0}
    bad = twatch.Watchdog(heartbeat_path=str(tmp_path / "no_such_dir" / "hb"))
    for step in range(3):
        bad.start_step()
        assert bad.end_step(step) >= 0.0
    assert bad.stats == {"steps": 3, "heartbeats": 0, "heartbeat_failures": 3}


@pytest.mark.parametrize("xs", [[], [0.5], [3.0, 1.0, 2.0, 10.0, 0.25]])
def test_percentiles_match_jax(xs):
    assert twatch.percentiles(xs) == jpercentiles(xs)


def test_byte_corpus_matches_jax(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(b"hello world, this is a tiny corpus for byte-level lm " * 20)
    want = jpipeline.ByteCorpus(str(p), batch=2, seq=32, seed=3)
    got = tpipeline.ByteCorpus(str(p), batch=2, seq=32, seed=3, device="cpu")
    for step in (0, 5):
        b, w = got.batch_at(step), want.batch_at(step)
        assert b["tokens"].shape == (2, 32)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k].numpy(), w[k])
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError, match="too small"):
        tpipeline.ByteCorpus(str(p), batch=2, seq=4096, device="cpu")


def _with_telemetry(tiny, tmp_path, cls, tm):
    """What ``cls`` gives with ``telemetry=tm``: the losses and the banks of
    a 2-user collab run, the losses and the adapters of a 3-step train loop,
    or the watchdog's counters and stragglers."""
    if cls == "CollabSession":
        cc = tbase.ColaConfig(mode="faithful_offload", family="lowrank",
                              taps="qv", rank=4, merged=True, users=2)
        sess = tcollab.CollabSession(tiny.tcfg, cc, tiny.tparams,
                                     optimizer=topt.sgd(0.1), device="cpu",
                                     telemetry=tm)
        data = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=2,
                                     users=2, device="cpu")
        losses = []
        for step in range(2):
            b = data.batch_at(step)
            losses.append(sess.train_step(b, b.pop("user_id")))
        assert tm is None or tm.snapshot()["channel.fit_round_s"]["count"] == 4
        return losses, [_tnp(ch.adapters) for ch in sess.channels]
    if cls == "TrainLoop":
        sess = tsession.ColaSession(
            tiny.tcfg, tbase.ColaConfig(**_MODE_A), tiny.tparams,
            optimizer=topt.sgd(0.1), device="cpu", telemetry=tm)
        data = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=3,
                                     device="cpu")
        d = tmp_path / ("on" if tm else "off")
        loop = ttrain.TrainLoop(sess, data, str(d), telemetry=tm)
        out = loop.run(3, resume=False)
        assert os.path.exists(d / "telemetry.jsonl") == bool(tm)
        return loop.losses, [_tnp(sess.adapters)], out["watchdog"]["steps"]
    # 2 ms steps, then one of 0.3 s: a straggler past 50x the median only
    wd = twatch.Watchdog(window=20, threshold=50.0, telemetry=tm)
    for step in range(12):
        wd.start_step()
        time.sleep(0.3 if step == 11 else 0.002)
        wd.end_step(step)
    return wd.stats, [], [s for s, _, _ in wd.stragglers]


@pytest.mark.parametrize("cls", ["CollabSession", "TrainLoop", "Watchdog"])
def test_telemetry_is_not_ported_yet(tiny, tmp_path, cls):
    """Each takes a ``Telemetry`` and gives the same result as with None
    (bit for bit where it trains). (The name dates from before the port had
    telemetry.)"""
    from repro_torch.telemetry import Telemetry

    tm = Telemetry(out_dir=str(tmp_path / "pm"))
    off = _with_telemetry(tiny, tmp_path, cls, None)
    on = _with_telemetry(tiny, tmp_path, cls, tm)
    assert on[0] == off[0] and on[2:] == off[2:]
    assert len(on[1]) == len(off[1])
    for got, want in zip(on[1], off[1]):
        assert _bit_equal(got, want)
    if cls == "Watchdog":
        assert on[2] == [11]
        assert [p["key"] for p in tm.recorder.postmortems] == [0]
        assert tm.snapshot()["train.step_s"]["count"] == 12


# ---------------------------------------------------------------------------
# K-user collaboration (tests/test_session_offload.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["lowrank", "linear"])
def test_user_row_masking_exact(tiny, family):
    """Masked fits decompose the merged gradient exactly, for the fused
    lowrank kernel path and the generic VJP path (linear)."""
    cc = tbase.ColaConfig(mode="faithful_offload", family=family, taps="qv",
                          rank=4)
    spec = tgl.make_spec(tiny.tcfg, cc)
    adapters = tgl.init_adapters(tiny.tcfg, cc, torch.Generator().manual_seed(0))
    batch = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=1,
                                  device="cpu").batch_at(0)
    users = torch.tensor([0, 1, 0, 1])
    _, d_all, _ = tgl.server_step_a(tiny.tcfg, spec, tiny.tparams, adapters,
                                    batch)
    g0 = tgl.fit_grads(spec, adapters, tcollab.mask_user_rows(d_all, users, 0))
    g1 = tgl.fit_grads(spec, adapters, tcollab.mask_user_rows(d_all, users, 1))
    g = tgl.fit_grads(spec, adapters, d_all)
    for tap in g:
        for leaf in g[tap]:
            np.testing.assert_allclose((g0[tap][leaf] + g1[tap][leaf]).numpy(),
                                       g[tap][leaf].numpy(), rtol=1e-4,
                                       atol=1e-6)


def test_collab_gradient_isolation_mixed_families(tiny):
    """Merged training with mixed families (lowrank + linear): a user whose
    rows never appear keeps a bit-identical bank, the active user's trains."""
    cc = tbase.ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                          rank=4, merged=True, users=2)
    collab = tcollab.CollabSession(tiny.tcfg, cc, tiny.tparams,
                                   optimizer=topt.sgd(0.1),
                                   families=["lowrank", "linear"], device="cpu")
    init = [_tnp(o.adapters) for o in collab.offloaders]
    data = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=2, users=2,
                                 device="cpu")
    for step in range(3):
        b = data.batch_at(step)
        collab.train_step(b, torch.zeros(4, dtype=torch.int32))
    assert _bit_equal(init[1], _tnp(collab.offloaders[1].adapters))
    assert not _bit_equal(init[0], _tnp(collab.offloaders[0].adapters))
    assert collab.bank_versions() == [3, 3]


def test_collab_session_runs_and_merges(tiny):
    cc = tbase.ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                          rank=4, merged=True, users=2)
    collab = tcollab.CollabSession(tiny.tcfg, cc, tiny.tparams,
                                   optimizer=topt.sgd(0.1),
                                   families=["lowrank", "linear"], device="cpu")
    data = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=2, users=2,
                                 device="cpu")
    losses = []
    for step in range(4):
        b = data.batch_at(step)
        losses.append(collab.train_step(b, b.pop("user_id")))
    assert all(np.isfinite(losses))
    b = data.batch_at(9)
    b.pop("user_id")
    loss, _ = tmodel.loss_fn(tiny.tcfg, collab.merged_model(), b)
    assert np.isfinite(float(loss))
    collab.channels[1].quarantined = True
    collab.reset_channels()
    assert not any(ch.quarantined for ch in collab.channels)


def test_collab_banks_come_from_seed_and_user():
    """User k's initial bank is drawn from a CPU generator seeded by
    (seed, k): the same on every call, another for every user."""
    cfg = tregistry.reduced_config("smollm-135m").replace(**_OVER)
    params = tmodel.init(cfg, device="cpu")
    cc = tbase.ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                          rank=4, merged=True, users=3)
    a, b = (tcollab.CollabSession(cfg, cc, params, seed=5, device="cpu")
            for _ in range(2))
    banks = [_tnp(o.adapters) for o in a.offloaders]
    assert all(_bit_equal(x, _tnp(o.adapters))
               for x, o in zip(banks, b.offloaders))
    assert not _bit_equal(banks[0], banks[1])
    assert not _bit_equal(banks[1], banks[2])


# ---------------------------------------------------------------------------
# int8 transfer compression (tests/test_offload_int8.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 33), (2, 4, 16, 64)])
def test_int8_roundtrip_error_bound(shape):
    """|x - dq(q(x))| <= scale / 2 elementwise, exact at each row's max."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape)
                         .astype(np.float32) * 3.0)
    q, scale = toffload.quant_int8(x)
    assert q.dtype == torch.int8 and scale.shape == shape[:-1] + (1,)
    back = toffload.dequant_int8(q, scale)
    assert bool(((back - x).abs() <= scale / 2.0 + 1e-7).all())
    rows, drows = x.reshape(-1, shape[-1]), back.reshape(-1, shape[-1])
    idx = rows.abs().argmax(dim=-1)
    ar = torch.arange(len(rows))
    np.testing.assert_allclose(drows[ar, idx].numpy(), rows[ar, idx].numpy(),
                               rtol=1e-5)


def test_int8_zero_and_tiny_rows_are_safe():
    x = torch.stack([torch.zeros(16), torch.full((16,), 1e-30), torch.ones(16)])
    out = toffload.dequant_int8(*toffload.quant_int8(x))
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out[0], torch.zeros(16))


def test_pushed_bytes_accounting_matches_jax(tiny):
    """int8 books 1 byte an element and 4 a row scale, "none" the raw bytes;
    the port's counts equal JAX's on the same payload."""
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=4)
    tcc = tbase.ColaConfig(**dataclasses.asdict(cc))
    batch = jpipeline.SyntheticLM(tiny.cfg, batch=4, seq=16, seed=0).batch_at(0)
    from repro.core import gl as jgl
    ad = jgl.init_adapters(tiny.cfg, cc, tiny.key)
    _, payload, _ = jgl.server_step_a(tiny.cfg, jgl.make_spec(tiny.cfg, cc),
                                      tiny.params, ad, batch)
    tpayload = {t: tuple(torch.from_numpy(np.array(a)) for a in v)
                for t, v in payload.items()}
    sizes = {}
    for compress in ("none", "int8"):
        joff = joffload.Offloader(jgl.make_spec(tiny.cfg, cc), ad,
                                  jopt.sgd(0.1), compress=compress)
        toff = toffload.Offloader(tgl.make_spec(tiny.tcfg, tcc), _t(ad),
                                  topt.sgd(0.1), compress=compress,
                                  device="cpu")
        joff.push(payload)
        toff.push(tpayload)
        assert toff.stats["pushed_bytes"] == joff.stats["pushed_bytes"]
        sizes[compress] = toff.stats["pushed_bytes"]
    assert sizes["int8"] < sizes["none"] / 3


def test_int8_fit_close_to_exact(tiny):
    data = tpipeline.SyntheticLM(tiny.tcfg, batch=4, seq=16, seed=1,
                                 device="cpu")
    banks = {}
    for compress in ("none", "int8"):
        cc = tbase.ColaConfig(mode="faithful_offload", family="lowrank",
                              taps="qv", rank=4, compress=compress)
        sess = tsession.ColaSession(tiny.tcfg, cc, tiny.tparams,
                                    optimizer=topt.sgd(0.1), device="cpu")
        for step in range(4):
            sess.step(data.batch_at(step))
        assert sess.channel_health()[0]["fits_committed"] == 4
        banks[compress] = np.concatenate(
            [a.ravel() for a in sorted_leaves(_tnp(sess.adapters))])
    exact, quant = banks["none"], banks["int8"]
    assert np.corrcoef(exact, quant)[0, 1] > 0.995
    assert np.linalg.norm(exact - quant) / np.linalg.norm(exact) < 0.1


# ---------------------------------------------------------------------------
# the quickstart's 30 steps (examples/quickstart.py)
# ---------------------------------------------------------------------------

def test_quickstart_loss_trajectory_matches_jax():
    """examples/quickstart.py's setup (reduced smollm-135m at 2 layers,
    merged Mode A, rank 8, interval 2, AdamW 3e-3, batch 8 x 64), the port
    starting from JAX's weights and adapters: every one of the 30 losses
    within rtol 1e-3 of JAX's (the largest gap measured when this test was
    written: 4.6e-7 relative)."""
    cfg = registry.reduced_config("smollm-135m").replace(n_layers=2)
    tcfg = tregistry.reduced_config("smollm-135m").replace(n_layers=2)
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    kw = dict(mode="faithful_offload", family="lowrank", rank=8, taps="qv",
              merged=True, interval=2)
    js = jsession.ColaSession(cfg, ColaConfig(**kw), params, key,
                              optimizer=jopt.adamw(3e-3))
    ts = tsession.ColaSession(tcfg, tbase.ColaConfig(**kw),
                              convert.params_from_numpy(tcfg, _np(params),
                                                        device="cpu"),
                              optimizer=topt.adamw(3e-3), device="cpu")
    ad = _t(js.adapters)
    ts.adapters = ts.offloader.adapters = ts.channel.last_good = ad
    ts.offloader.opt_state = ts.optimizer.init(ad)
    data = jpipeline.SyntheticLM(cfg, batch=8, seq=64, seed=0)
    jl, tl = [], []
    for step in range(30):
        b = data.batch_at(step)
        jl.append(js.step(b))
        tl.append(ts.step(b))
    gap = np.max(np.abs(np.array(tl) - np.array(jl)) / np.abs(jl))
    print(f"quickstart: largest relative loss gap over 30 steps {gap:.3e}")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert jl[-1] < jl[0]
    assert ts.channel_health()[0]["fits_committed"] == 15
