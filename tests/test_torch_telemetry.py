"""The port's telemetry (metric registry, span tracing, flight recorder,
``trace_summary``) against the JAX package's, and the ported suite of
``tests/test_telemetry.py`` on its tiny config (2 layers, d_model 64, f32,
2 users, chunks of 4, paged blocks of 8).

- The units are plain Python and numpy on both sides, so their outputs must
  equal JAX's exactly (the tracer and recorder on one fake clock).
- Telemetry only reads host-side values: the port's tokens are bit-identical
  with telemetry on and off, and no tensor ever reaches a record, a span
  argument or a metric.
- On the same run the port's engine must fill the registry key for key like
  JAX's, with equal counters (the timing series excepted), the same event
  kinds in every recorder ring and the same spans with the same arguments.
"""
import collections
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import trace_summary as jsummary  # noqa: E402
from repro import telemetry as jtel  # noqa: E402
from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import gl  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro.telemetry import metrics as jmetrics  # noqa: E402
from repro.telemetry import recorder as jrecorder  # noqa: E402
from repro.telemetry import tracing as jtracing  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch import trace_summary as tsummary  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import collab as tcollab  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime import faults as tfaults  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402
from repro_torch.telemetry import metrics as tmetrics  # noqa: E402
from repro_torch.telemetry import recorder as trecorder  # noqa: E402
from repro_torch.telemetry import tracing as ttracing  # noqa: E402

_OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=128, vocab_size=128)
_LENS = (5, 11, 7, 4)
# test_telemetry.py's attention plan, and a dense engine on a one-row
# adapter store (the store's hooks) with a hot-swap after the run
PLANS = {
    "paged-chunked": dict(prefill_chunk=4, kv_layout="paged", kv_block=8),
    "dense-store": dict(resident_slots=1),
}


@pytest.fixture(scope="module")
def tiny():
    cfg = registry.reduced_config("smollm-135m").replace(**_OVER)
    tcfg = tregistry.reduced_config("smollm-135m").replace(**_OVER)
    key = jax.random.PRNGKey(0)
    params = M.init(cfg, key)
    cc = ColaConfig(mode="lora", family="lowrank", taps="qv", rank=4)
    banks = [gl.init_adapters(cfg, cc, jax.random.fold_in(key, u))
             for u in range(2)]
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(cfg=cfg, tcfg=tcfg, key=key, params=params, banks=banks,
                tparams=convert.params_from_numpy(tcfg, np_tree(params),
                                                  device="cpu"),
                tbanks=[convert.adapters_from_numpy(np_tree(b), device="cpu")
                        for b in banks])


def _prompts(lens=_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=p) for p in lens]


def _serve(t, lib, telemetry=None, max_new=6, slots=2, install=False, **kw):
    """test_telemetry.py's run through the JAX engine (``lib`` = jserve) or
    the port's; with ``install``, user 1's bank is hot-swapped in after it
    (a version bump). Returns (engine, tokens)."""
    port = lib is tserve
    eng = lib.ServeEngine(t["tcfg" if port else "cfg"],
                          t["tparams" if port else "params"], slots=slots,
                          max_len=32, telemetry=telemetry,
                          user_adapters=t["tbanks" if port else "banks"],
                          **({"device": "cpu"} if port else {}), **kw)
    reqs = [lib.Request(rid=i, user=i % 2, prompt=p, max_new=max_new)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    if install:
        bank = t["tbanks" if port else "banks"][0]
        assert eng.install_adapters(1, bank, version=1)
    return eng, [r.out for r in reqs]


@pytest.fixture(scope="module")
def jax_serve(tiny, tmp_path_factory):
    """Every JAX engine run of this file, with telemetry (trace on)."""
    out = {}
    for plan, kw in PLANS.items():
        tm = jtel.Telemetry(trace=True, out_dir=str(tmp_path_factory.mktemp(
            f"jax-{plan}")))
        eng, outs = _serve(tiny, jserve, tm, install=plan == "dense-store",
                           **kw)
        out[plan] = (tm, eng.telemetry_snapshot(), outs)
    return out


@pytest.fixture(scope="module")
def port_serve(tiny, tmp_path_factory):
    out = {}
    for plan, kw in PLANS.items():
        tm = ttel.Telemetry(trace=True, out_dir=str(tmp_path_factory.mktemp(
            f"port-{plan}")))
        eng, outs = _serve(tiny, tserve, tm, install=plan == "dense-store",
                           **kw)
        out[plan] = (tm, eng, outs)
    return out


def _assert_no_tensors(tm):
    """Every recorded field, span argument and metric value is a Python or
    numpy scalar, a str or None (a histogram summary: a dict of those)."""
    def scalar(v):
        assert not isinstance(v, torch.Tensor), v
        if isinstance(v, dict):
            for x in v.values():
                scalar(x)
            return
        assert v is None or isinstance(v, (bool, int, float, str,
                                           np.generic)), type(v)

    for key in tm.recorder.keys():
        for ev in tm.recorder.events(*key):
            for v in ev.values():
                scalar(v)
    for pm in tm.recorder.postmortems:
        for ev in pm["events"]:
            for v in ev.values():
                scalar(v)
    if tm.tracer is not None:
        for ev in tm.tracer.events:
            for v in ev.get("args", {}).values():
                scalar(v)
    for v in tm.snapshot().values():
        scalar(v)


# ---------------------------------------------------------------------------
# units against the JAX package's, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xs", [[], [0.5], [1.0, 2.0, 3.0, 4.0],
                                list(np.random.default_rng(0).exponential(
                                    size=1000))])
def test_percentiles_match_jax(xs):
    assert tmetrics.percentiles(xs) == jmetrics.percentiles(xs)
    assert ttel.percentiles is tmetrics.percentiles


@pytest.mark.parametrize("n", [4, 8, 200], ids=["exact", "full-ring",
                                                 "past-the-ring"])
def test_histogram_summaries_match_jax(n):
    """Exact over the ring while it holds every sample, bucket-interpolated
    past it; values past the last bound land in +Inf."""
    rng = np.random.default_rng(n)
    xs = list(rng.exponential(3.0, size=n)) + [100.0]
    hs = [lib.Histogram(buckets=(1.0, 2.0, 4.0, 8.0), sample_cap=8)
          for lib in (jmetrics, tmetrics)]
    for h in hs:
        for v in xs:
            h.observe(v)
    assert hs[1].summary() == hs[0].summary()
    assert [hs[1].percentile(q) for q in (0, 10, 50, 90, 99, 100)] == [
        hs[0].percentile(q) for q in (0, 10, 50, 90, 99, 100)]
    assert np.array_equal(hs[1].counts, hs[0].counts)
    assert hs[1].counts.sum() == hs[1].count == n + 1
    s = tmetrics.Histogram().summary()
    assert s == jmetrics.Histogram().summary() == {"count": 0}


def _fill(reg):
    reg.absorb("serve", {"ticks": 7, "decode_time": 0.5, "ok": True,
                         "label": "skipped", "missing": None,
                         "n": np.int64(3), "x": np.float32(0.25),
                         "store": {"hits": 3}})
    reg.absorb("serve", {"ticks": 9})
    reg.counter("serve.extra").inc(2)
    reg.gauge("serve.g").set(1.5)
    h = reg.histogram("serve.ttft_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    reg.histogram("train.step_s").observe(0.01)


@pytest.mark.parametrize("enabled", [True, False])
def test_registry_absorb_snapshot_and_prometheus_match_jax(enabled):
    regs = [lib.MetricRegistry(enabled=enabled) for lib in (jmetrics, tmetrics)]
    for reg in regs:
        _fill(reg)
    assert regs[1].snapshot() == regs[0].snapshot()
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    if enabled:
        snap = regs[1].snapshot()
        assert snap["serve.ticks"] == 9 and snap["serve.ok"] == 1
        assert "serve.label" not in snap and "serve.missing" not in snap
        assert 'serve_ttft_s_bucket{le="1"} 2' in regs[1].to_prometheus()
    else:
        assert regs[1].snapshot() == {} and regs[1].to_prometheus() == ""
        assert regs[1].counter("a") is tmetrics.NULL_METRIC
        assert regs[1].histogram("c") is tmetrics.NULL_METRIC


def test_registry_emit_jsonl_matches_jax(tmp_path):
    recs = []
    for lib in (jmetrics, tmetrics):
        reg = lib.MetricRegistry()
        path = str(tmp_path / f"{lib.__name__}.jsonl")
        reg.emit(step=-1)               # no stream yet: nothing, no crash
        reg.stream_to(path)
        _fill(reg)
        reg.emit(step=3)
        reg.emit(step=4, note="x")
        recs.append([json.loads(line) for line in open(path)])
    for r in recs[0] + recs[1]:
        assert isinstance(r.pop("ts"), float)
    assert recs[1] == recs[0] and len(recs[1]) == 2
    assert recs[1][1]["metrics"]["train.step_s"]["count"] == 1


class _Clock:
    """A deterministic clock: 0, 1, 2, ... seconds."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _trace(lib):
    tr = lib.Tracer(clock=_Clock())
    tr.name_thread(0, "serve")
    tr.name_thread(0, "serve")          # idempotent
    with tr.span("outer", tid=0, tick=1):
        with tr.span("inner", tid=0):
            tr.instant("mark", tid=0, seq=2)
    with tr.span("offload", cat="offload", tid=1, seq=7):
        pass
    return tr


def test_tracer_docs_match_jax(tmp_path):
    docs = [_trace(lib).to_doc() for lib in (jtracing, ttracing)]
    assert docs[1] == docs[0]
    assert ttracing.validate_trace(docs[1]) == []
    spans = [e for e in docs[1]["traceEvents"] if e["ph"] == "X"]
    assert [s["name"] for s in spans] == ["inner", "outer", "offload"]
    path = _trace(ttracing).export(str(tmp_path / "t.json"))
    assert json.load(open(path)) == docs[0]


_BAD_DOCS = {
    "not-a-doc": {},
    "empty": {"traceEvents": []},
    "missing-fields": {"traceEvents": [{"name": "x"}]},
    "not-an-object": {"traceEvents": [3, {"name": "a", "ph": "X", "pid": 1,
                                          "tid": 0, "ts": 0.0, "dur": 1.0}]},
    "no-ts": {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0}]},
    "negative-dur": {"traceEvents": [{"name": "x", "ph": "X", "pid": 1,
                                      "tid": 0, "ts": 0.0, "dur": -1.0}]},
    "metadata-only": {"traceEvents": [{"name": "thread_name", "ph": "M",
                                       "pid": 1, "tid": 0}]},
    "overlap": {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": 0.0, "dur": 10.0},
        {"name": "b", "ph": "X", "pid": 1, "tid": 0, "ts": 5.0, "dur": 10.0}]},
    "two-lanes": {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": 0.0, "dur": 10.0},
        {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 5.0, "dur": 10.0}]},
}


@pytest.mark.parametrize("case", sorted(_BAD_DOCS))
def test_validate_trace_matches_jax(case):
    doc = _BAD_DOCS[case]
    got = ttracing.validate_trace(doc)
    assert got == jtracing.validate_trace(doc)
    assert (got == []) == (case == "two-lanes")


def test_recorder_ring_postmortem_and_capacity_match_jax(tmp_path):
    pms = []
    for lib in (jrecorder, trecorder):
        rec = lib.FlightRecorder(capacity=4, out_dir=str(tmp_path / lib.__name__),
                                 clock=_Clock())
        for i in range(10):
            rec.record("user", 1, "push", seq=i)
        rec.record("slot", 0, "admit", rid=3)
        assert rec.keys() == [("slot", 0), ("user", 1)]
        assert [e["seq"] for e in rec.events("user", 1)] == [6, 7, 8, 9]
        pm = rec.dump("user", 1, "quarantined after 2 failed fit rounds")
        empty = rec.dump("slot", 99, "no such ring")
        assert empty["events"] == []
        with open(pm["path"]) as f:
            disk = json.load(f)
        pms.append((os.path.basename(pm["path"]),
                    os.path.basename(empty["path"]),
                    {k: v for k, v in pm.items() if k != "path"}, disk))
        with pytest.raises(ValueError):
            lib.FlightRecorder(capacity=0)
    assert pms[1] == pms[0]
    assert pms[1][0] == "postmortem-user-1-000.json"
    assert pms[1][3] == pms[1][2]


# ---------------------------------------------------------------------------
# the disabled path: identity, not timing
# ---------------------------------------------------------------------------

def test_disabled_paths_share_null_singletons(tiny):
    tm_off = ttel.Telemetry(enabled=False)
    assert not tm_off and tm_off.tracer is None and tm_off.recorder is None
    assert tm_off.span("x") is ttel.NULL_CONTEXT
    assert tm_off.registry.counter("a") is tmetrics.NULL_METRIC
    assert tm_off.snapshot() == {}
    assert tm_off.export_trace("/nonexistent/never-written") is None
    tm_off.record("user", 0, "kind")
    assert tm_off.dump("user", 0, "r") is None
    # Telemetry(enabled=False) and telemetry=None are indistinguishable
    for tm in (None, tm_off):
        eng = tserve.ServeEngine(tiny["tcfg"], tiny["tparams"], slots=2,
                                 max_len=32, telemetry=tm, device="cpu")
        assert eng.tm is None
        assert eng._span("serve.tick") is ttel.NULL_CONTEXT
        assert eng._h_ttft is tmetrics.NULL_METRIC
        assert eng.telemetry_snapshot() == {}
    # enabled-without-trace still has no tracer: spans stay free
    tm_plain = ttel.Telemetry()
    assert tm_plain and tm_plain.span("x") is ttel.NULL_CONTEXT
    assert ttel.annotate("serve.decode") is ttel.NULL_CONTEXT


def test_disabled_span_overhead_bounded():
    """100k disabled span entries must be pure-python cheap (no allocation,
    no syscalls): an absolute wall bound, generous enough for shared CI."""
    tm_off = ttel.Telemetry(enabled=False)
    t0 = time.perf_counter()
    for _ in range(100_000):
        with tm_off.span("serve.tick"):
            pass
    assert time.perf_counter() - t0 < 2.0


def test_profiler_annotations_name_the_decode_and_the_fit(tiny):
    """``Telemetry(profiler_annotations=True)`` arms ``annotate``: a
    ``torch.profiler`` run sees ``serve.decode`` and ``offload.fit``."""
    from torch.profiler import ProfilerActivity, profile

    try:
        ttel.Telemetry(profiler_annotations=True)
        eng = tserve.ServeEngine(tiny["tcfg"], tiny["tparams"], slots=2,
                                 max_len=32, user_adapters=tiny["tbanks"],
                                 device="cpu")
        eng.submit(tserve.Request(rid=0, user=1, prompt=_prompts()[0],
                                  max_new=3))
        eng.tick()                       # admission + prefill
        sess = tsession.ColaSession(
            tiny["tcfg"], tbase.ColaConfig(mode="faithful_offload", rank=4,
                                           interval=1),
            tiny["tparams"], optimizer=topt.sgd(0.1), device="cpu")
        batch = tpipeline.SyntheticLM(tiny["tcfg"], batch=2, seq=8, seed=1,
                                      device="cpu").batch_at(0)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.tick()
            sess.step(batch)
        names = {e.name for e in prof.events()}
        assert {"serve.decode", "offload.fit"} <= names
    finally:
        ttel.enable_profiler_annotations(False)
    assert ttel.annotate("serve.decode") is ttel.NULL_CONTEXT


# ---------------------------------------------------------------------------
# the serve engine: JAX's suite, ported
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_tiny():
    """test_telemetry.py's mamba2 case: reduced mamba2-370m at _tiny's
    widths (ssm_headdim 16, ssm_state 16), no adapters (bankless)."""
    over = dict(n_layers=2, d_model=64, vocab_size=128, ssm_headdim=16,
                ssm_state=16)
    cfg = registry.reduced_config("mamba2-370m").replace(**over)
    tcfg = tregistry.reduced_config("mamba2-370m").replace(**over)
    params = M.init(cfg, jax.random.PRNGKey(0))
    return dict(tcfg=tcfg, tbanks=None, tparams=convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))


@pytest.mark.parametrize("plan", ["paged-chunked", "dense-batched",
                                  "mamba2-chunked"])
def test_tokens_bit_identical_telemetry_on_off(tiny, plan, tmp_path, request):
    """test_telemetry.py's cases: the attention plan (paged + chunked, and
    dense and batched), and the ssm plan chunked (mamba2-370m, bankless,
    chunks of 4, two slots: slots are reused)."""
    t = request.getfixturevalue("mamba_tiny") if plan == "mamba2-chunked" \
        else tiny
    kw = dict(prefill_chunk=4) if plan == "mamba2-chunked" else \
        PLANS.get(plan, {})
    _, ref_outs = _serve(t, tserve, None, **kw)
    tm = ttel.Telemetry(trace=True, out_dir=str(tmp_path))
    eng, outs = _serve(t, tserve, tm, **kw)
    assert outs == ref_outs, "telemetry must never perturb generated tokens"
    snap = eng.telemetry_snapshot()
    assert snap["serve.completed"] == len(ref_outs)
    assert snap["serve.ttft_s"]["count"] == len(ref_outs)
    assert ttel.validate_trace(tm.tracer.to_doc()) == []
    assert tm.recorder.postmortems == []


def test_counters_agree_across_engine_modes(tiny):
    """Token/request counters agree between the batched baseline and the
    chunked + paged + burst engine on the same workload (tick and dispatch
    counters legitimately differ)."""
    base_eng, base_outs = _serve(tiny, tserve, ttel.Telemetry())
    burst_eng, burst_outs = _serve(tiny, tserve, ttel.Telemetry(),
                                   decode_burst=4, **PLANS["paged-chunked"])
    assert base_outs == burst_outs
    a, b = base_eng.telemetry_snapshot(), burst_eng.telemetry_snapshot()
    for key in ("serve.tokens", "serve.decode_tokens", "serve.prefill_tokens",
                "serve.completed", "serve.admitted", "serve.rejected"):
        assert a[key] == b[key], f"{key}: {a[key]} != {b[key]}"
    assert a["serve.tokens"] == base_eng.stats["tokens"]
    assert b["serve.decode_tokens"] == burst_eng.stats["decode_tokens"]
    for k, v in burst_eng.pager.stats.items():
        assert b[f"pager.{k}"] == v
    burst_eng.pager.assert_empty()


def test_throughput_percentiles_always_on(tiny):
    """The tail percentiles of throughput() ride the always-on rings:
    present without telemetry, shaped {count, mean, max, p50, p95, p99}."""
    eng, outs = _serve(tiny, tserve, None)
    tp = eng.throughput()
    for key in ("ttft", "latency", "decode_tick", "prefill"):
        p = tp[key]
        assert p is not None and p["count"] > 0
        assert set(p) == {"count", "mean", "max", "p50", "p95", "p99"}
        assert p["p50"] <= p["p95"] <= p["p99"] <= p["max"]
    assert tp["ttft"]["count"] == len(outs)
    assert tp["mean_ttft"] == pytest.approx(tp["ttft"]["mean"])


def test_serve_trace_schema_and_summary(port_serve, tmp_path, capsys):
    """A chunked + paged run exports valid Chrome-trace JSON with the serve
    span vocabulary, and ``python -m repro_torch.trace_summary`` parses both
    files as JAX's reader does."""
    tm, eng, _ = port_serve["paged-chunked"]
    doc = tm.tracer.to_doc()
    assert ttel.validate_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"serve.tick", "serve.admit", "serve.prefill_chunk",
            "serve.decode"} <= names
    decodes = [e for e in doc["traceEvents"]
               if e.get("ph") == "X" and e["name"] == "serve.decode"]
    assert decodes and all(
        e["args"]["live"] >= 1 and e["args"]["burst"] >= 1 for e in decodes)
    assert any(e["ph"] == "M" and e["args"]["name"] == "serve"
               for e in doc["traceEvents"])

    trace_path = tm.export_trace(str(tmp_path / "serve_trace.json"))
    snap_path = str(tmp_path / "serve_metrics.json")
    with open(snap_path, "w") as f:
        json.dump(eng.telemetry_snapshot(), f)
    capsys.readouterr()
    assert tsummary.main([trace_path, "--metrics", snap_path]) == 0
    ours = capsys.readouterr().out
    assert jsummary.main([trace_path, "--metrics", snap_path]) == 0
    assert ours == capsys.readouterr().out
    table = tsummary.span_table(json.load(open(trace_path)))
    assert table == jsummary.span_table(json.load(open(trace_path)))
    assert any(row["name"] == "serve.tick" for row in table)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"traceEvents": []}, f)
    assert tsummary.main([bad]) == 1


def test_flight_recorder_scopes_serve(port_serve):
    tm, _, _ = port_serve["paged-chunked"]
    keys = tm.recorder.keys()
    assert any(s == "slot" for s, _ in keys)
    slot_kinds = {e["kind"] for s, k in keys if s == "slot"
                  for e in tm.recorder.events(s, k)}
    assert {"admit", "first_token", "retire", "kv_reserve",
            "kv_release"} <= slot_kinds
    assert tm.recorder.postmortems == []
    tm, _, _ = port_serve["dense-store"]
    user_kinds = {e["kind"] for s, k in tm.recorder.keys() if s == "user"
                  for e in tm.recorder.events(s, k)}
    assert {"store_fetch", "bank_install"} <= user_kinds


def test_pager_error_dumps_a_postmortem(tmp_path):
    from repro_torch.runtime import kv_pager as tpager

    tm = ttel.Telemetry(out_dir=str(tmp_path))
    pg = tpager.BlockPager(n_blocks=4, block_size=4, slots=2, max_len=16,
                           telemetry=tm)
    assert pg.reserve(0, 6) and pg.ensure(0, 5)
    blk = pg.owned(0)[0]
    pg.release(0)
    pg._owned[0] = [blk]                 # a corrupted retire
    with pytest.raises(tpager.PagerError, match="double free"):
        pg.release(0)
    (pm,) = tm.recorder.postmortems
    assert pm["reason"].startswith("PagerError: double free")
    assert [e["kind"] for e in pm["events"]] == ["kv_reserve", "kv_release",
                                                 "pager_error"]
    assert os.path.exists(pm["path"])


# ---------------------------------------------------------------------------
# parity with the JAX engine on the same run
# ---------------------------------------------------------------------------

def _timing(name: str) -> bool:
    return "time" in name or name.endswith("_s")


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_registry_snapshot_matches_jax_engine(jax_serve, port_serve, plan):
    """Key for key; value for value on every counter and gauge, and on
    every histogram's count (the timing values excepted)."""
    _, want, jouts = jax_serve[plan]
    tm, eng, outs = port_serve[plan]
    assert outs == jouts
    got = eng.telemetry_snapshot()
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        if isinstance(v, dict):
            assert got[name]["count"] == v["count"], name
        elif not _timing(name):
            assert got[name] == v, name
    _assert_no_tensors(tm)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_recorder_kinds_match_jax_engine(jax_serve, port_serve, plan):
    jtm = jax_serve[plan][0]
    tm = port_serve[plan][0]
    assert tm.recorder.keys() == jtm.recorder.keys()
    for key in tm.recorder.keys():
        kinds = [e["kind"] for e in tm.recorder.events(*key)]
        assert kinds == [e["kind"] for e in jtm.recorder.events(*key)], key
    assert tm.recorder.postmortems == jtm.recorder.postmortems == []


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_spans_match_jax_engine(jax_serve, port_serve, plan):
    """The same spans with the same arguments, in the same order."""
    def spans(tm):
        return [(e["name"], e.get("args", {})) for e in tm.tracer.events
                if e["ph"] == "X"]

    want, got = spans(jax_serve[plan][0]), spans(port_serve[plan][0])
    assert collections.Counter(n for n, _ in got) == collections.Counter(
        n for n, _ in want)
    assert got == want


# ---------------------------------------------------------------------------
# the training side
# ---------------------------------------------------------------------------

_MODE_A = dict(mode="faithful_offload", family="lowrank", taps="qv", rank=4,
               merged=True)


@pytest.fixture(scope="module")
def jax_trainloop(tiny, tmp_path_factory):
    """test_telemetry.py's train loop, through the JAX package."""
    d = tmp_path_factory.mktemp("jax-trainloop")
    tm = jtel.Telemetry(out_dir=str(d))
    sess = jsession.ColaSession(tiny["cfg"], ColaConfig(**_MODE_A),
                                tiny["params"], tiny["key"],
                                optimizer=jopt.sgd(0.05), telemetry=tm)
    data = jpipeline.SyntheticLM(tiny["cfg"], batch=2, seq=16, seed=3)
    out = jtrain.TrainLoop(sess, data, str(d / "run"), log_every=2,
                           telemetry=tm).run(4, resume=False)
    recs = [json.loads(line) for line in open(d / "run" / "telemetry.jsonl")]
    return out, recs


def test_trainloop_records_watchdog_and_channel_health(tiny, jax_trainloop,
                                                       tmp_path):
    tm = ttel.Telemetry(out_dir=str(tmp_path))
    sess = tsession.ColaSession(tiny["tcfg"], tbase.ColaConfig(**_MODE_A),
                                tiny["tparams"], optimizer=topt.sgd(0.05),
                                device="cpu", telemetry=tm)
    data = tpipeline.SyntheticLM(tiny["tcfg"], batch=2, seq=16, seed=3,
                                 device="cpu")
    loop = ttrain.TrainLoop(sess, data, str(tmp_path / "run"), log_every=2,
                            telemetry=tm)
    out = loop.run(4, resume=False)

    recs = [json.loads(line)
            for line in open(str(tmp_path / "run" / "metrics.jsonl"))]
    assert recs, "metrics.jsonl must have records"
    for rec in recs:
        wd = rec["watchdog"]
        assert wd["steps"] >= 1 and "median_s" in wd and "p95_s" in wd
        ch = rec["channel_health"]["0"]
        assert ch["version"] >= 0 and not ch["quarantined"]
        assert "last_error" in ch and "last_error_seq" in ch
    assert out["watchdog"]["steps"] == 4
    assert out["watchdog"]["step_s"]["count"] == 4

    t_recs = [json.loads(line)
              for line in open(str(tmp_path / "run" / "telemetry.jsonl"))]
    m = t_recs[-1]["metrics"]
    assert m["train.step"] == 3 and m["train.watchdog.steps"] == 4
    assert m["train.step_s"]["count"] == 4
    assert m["channel.u0.version"] == 4 and m["channel.u0.quarantined"] == 0
    # the same records, key for key, as JAX's loop; equal counters
    jout, j_recs = jax_trainloop
    assert [r["step"] for r in t_recs] == [r["step"] for r in j_recs]
    for got, want in zip(t_recs, j_recs):
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for name, v in want["metrics"].items():
            if isinstance(v, dict):
                assert got["metrics"][name]["count"] == v["count"], name
            elif isinstance(v, int):
                assert got["metrics"][name] == v, name
    kinds = [e["kind"] for e in tm.recorder.events("train", 0)]
    assert kinds == ["step"] * 4
    assert [e["kind"] for e in tm.recorder.events("user", 0)] == [
        "delivered", "commit"] * 4
    _assert_no_tensors(tm)


def test_chaos_run_records_no_tensors(tiny, tmp_path):
    """K = 2, user 1's returns NaN-poisoned: the quarantine postmortem,
    the spans and the metrics hold only host values."""
    tm = ttel.Telemetry(trace=True, out_dir=str(tmp_path))
    inj = tfaults.FaultInjector(
        {1: tfaults.FaultProfile(nan=1.0, targets=("adapters",))}, seed=0,
        telemetry=tm)
    cc = tbase.ColaConfig(mode="faithful_offload", family="lowrank",
                          taps="qv", rank=4, merged=True, users=2)
    sess = tcollab.CollabSession(
        tiny["tcfg"], cc, tiny["tparams"], optimizer=topt.sgd(0.1),
        injector=inj, device="cpu", telemetry=tm,
        policy=tfaults.RetryPolicy(max_attempts=3, backoff_base=0.0,
                                   sleep=lambda s: None))
    data = tpipeline.SyntheticLM(tiny["tcfg"], batch=4, seq=16, seed=2,
                                 users=2, device="cpu")
    for step in range(3):
        b = data.batch_at(step)
        b.pop("user_id")
        sess.train_step(b, np.zeros(4, np.int32))
    assert sess.channels[1].quarantined
    assert [p["reason"].split(":")[0] for p in tm.recorder.postmortems] == [
        "fit rollback", "quarantined after 2 failed fit rounds"]
    names = collections.Counter(e["name"] for e in tm.tracer.events
                                if e["ph"] == "X")
    # 3 rounds a user; user 1's third push is refused and skips its fit
    assert names == {"session.offload_round": 6, "channel.push": 6,
                     "channel.fit_round": 5}
    assert tm.snapshot()["channel.fit_round_s"]["count"] == 5
    assert ttel.validate_trace(tm.tracer.to_doc()) == []
    _assert_no_tensors(tm)
