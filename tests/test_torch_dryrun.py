"""The port's dry-run (``repro_torch.launch.dryrun``) and perf probe on the
CPU: fake process groups, fake tensors, no card, no JAX.

- Reduced cells: for each layer plan (uniform, pairs, MoE, SSM, hybrid)
  and each ``--mode``, at world sizes 1 and 8 on a fake group, the counted
  FLOPs of one rank's train step equal a count written out from the
  config's widths, product by product (``tests/torch_flops.py``; at 8 on
  (2, 4) the attention, the dense MLP, the head and the Mamba2 mixer's
  SSD heads are split over the 4 "model" ranks); so do a prefill and a
  serve tick's (the uniform plan's).
- The count is the plain path's and data-dependent sizes take their bound:
  a serve tick lists the KV write plan's ``nonzero`` in ``bounded_ops``,
  and the frozen mode (no adapters) counts a forward only.
- ``count_by_layers`` (three depths, interpolated) equals the eager count
  at full depth, for each step ``chip_smoke.py``'s ``[roofline]`` counts,
  and, for the hybrid plan (three depths of whole periods of the shared
  block with the depth's tail), a reduced zamba2's train step at a fourth
  depth, at world sizes 1 and 8: FLOPs, bytes, collectives by op and by
  label, inputs and outputs, exactly.
- The memory term (``roofline.bytes_moved``) grows by exactly the bytes of
  the leaves a step gathers layer by layer (a reduced prefill at world
  size 8: each leaf's compute layout once, the tied embedding twice), and
  by none at world size 1.
- One production cell: smollm-135m x decode_32k on the 16 x 16 fake mesh,
  with JAX's record keys, ``model_flops`` and the roofline terms, its KV
  cache the rank's block of positions, updated in place and never moved;
  a MoE cell that ``steps._check_groups`` refuses fails with the step's
  text.
- No serve tick of any plan, at world sizes 1 and 8, moves a KV leaf or an
  SSM state leaf: the only collectives labelled with a cache leaf are the
  conv state's gathers over "model", one layer at a time, where the SSD
  heads split.
- ``perf_probe --breakdown`` writes a record with every JAX key the port
  keeps and prints every collective.
- No test leaves a process group behind.

The real steps' FLOPs and collective breakdowns in gloo groups, against
the dry-run's, are in ``tests/test_torch_distributed.py``.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import torch_flops  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ColaConfig  # noqa: E402
from repro_torch.analysis import collectives as tcoll  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.launch import dryrun, perf_probe  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=128, vocab_size=128, microbatches=2)
PLANS = {
    "uniform": ("mistral-nemo-12b", SMALL),
    "pairs": ("gemma2-9b", dict(SMALL, local_window=8)),
    "moe": ("qwen3-moe-30b-a3b", dict(SMALL, moe_group=32)),
    "ssm": ("mamba2-370m", dict(n_layers=2, d_model=64, vocab_size=128,
                                microbatches=2)),
    "hybrid": ("zamba2-7b", dict(SMALL, n_kv_heads=4, shared_attn_every=1)),
}
MODES = ("fused_fit", "faithful_offload", "ft", "frozen")
B, SEQ, RANK = 8, 16, 4
WORLDS = ((1, (1, 1)), (8, (2, 4)))


def _cfg(plan):
    name, kw = PLANS[plan]
    return registry.reduced_config(name).replace(**kw)


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the count written out from the widths (``torch_flops``)
# ---------------------------------------------------------------------------

_lin = torch_flops.lin
_Count = torch_flops.Count


def _train_flops(plan, cfg, mode, rows, n=1):
    """One rank's train step: M microbatches of ``rows`` rows (ft: one batch
    of M * rows), split over ``n`` ranks along "model"."""
    return torch_flops.train_flops(plan, cfg, mode, rows, SEQ, RANK, n)


def _prefill_flops(plan, cfg, b, s):
    """A prefill: forward products only, no adapters, the head on the last
    position."""
    c = _Count(cfg, "frozen", b, s, RANK)
    for _ in range(cfg.n_layers):
        c.attn_block("moe" if plan == "moe" else "mlp")
    c.T = b
    c.head()
    return c.flops


@pytest.mark.parametrize("plan", list(PLANS))
def test_reduced_train_cells_count_the_written_out_flops(plan):
    cfg = _cfg(plan)
    for world, shape in WORLDS:
        with dryrun.fake_world(world):
            mesh = make_mesh(*shape, device_type="cpu")
            for mode in MODES:
                cc = ColaConfig(mode=mode, family="lowrank", taps="qv",
                                rank=RANK)
                got = dryrun.count_step(cfg, cc, "train", B, SEQ, mesh)
                rows = B // cfg.microbatches // (2 if world == 8 else 1)
                assert got["flops"] == _train_flops(
                    plan, cfg, mode, rows, shape[1]), (plan, world, mode)
                assert got["bounded_ops"] == []
                assert (got["collective_bytes"] > 0) == (world > 1)
                m = got["memory"]
                assert m["peak_bytes_per_device"] >= (
                    m["argument_size_in_bytes"] + m["output_size_in_bytes"]
                    - m["alias_size_in_bytes"]) > 0


def test_prefill_and_serve_tick_count_the_written_out_flops():
    """The uniform plan's prefill (the head on the last position) and a
    serve tick; the tick's KV write plan takes its bound."""
    cfg = _cfg("uniform")
    c = cfg
    with dryrun.fake_world(1):
        mesh = make_mesh(1, 1, device_type="cpu")
        cc = ColaConfig()
        pre = dryrun.count_step(cfg, cc, "prefill", B, SEQ, mesh)
        tick = dryrun.count_step(cfg, cc, "decode", B, 64, mesh)
    assert pre["flops"] == _prefill_flops("uniform", cfg, B, SEQ)
    assert pre["bounded_ops"] == []
    # a tick: every dense on B tokens, attention of one query against the
    # cache's 64 positions, the head on B tokens
    d, hq, hkv = c.d_model, c.n_heads * c.d_head, c.n_kv_heads * c.d_head
    per_layer = (_lin(B, d, hq) + 2 * _lin(B, d, hkv) + _lin(B, hq, d)
                 + 3 * _lin(B, d, c.d_ff) + 2 * 2 * B * 64 * hq)
    assert tick["flops"] == c.n_layers * per_layer + _lin(B, d, c.vocab_size)
    assert "aten.nonzero.default" in tick["bounded_ops"]


# the (mode, kind) of each step that ``chip_smoke.py``'s ``[roofline]``
# counts by layers: Mode A, Mode B, the prefill step and a serve tick
ROOFLINE_STEPS = (("faithful_offload", "train"), ("fused_fit", "train"),
                  ("fused_fit", "prefill"), ("fused_fit", "decode"))


@pytest.mark.parametrize("mode,kind,world",
                         [(m, k, 1) for m, k in ROOFLINE_STEPS]
                         + [("faithful_offload", "train", 8)])
def test_count_by_layers_equals_the_eager_count(mode, kind, world):
    """At world size 1, as ``[roofline]`` counts, and Mode A at 8: Mode A's
    bytes carry the L^2 term, a stacked leaf of one layer is placed
    otherwise at 8, and a tick's KV write plan takes its bound. One
    microbatch: the depth is what is extrapolated."""
    cfg = _cfg("uniform").replace(n_layers=5, microbatches=1)
    cc = ColaConfig(mode=mode, family="lowrank", taps="qv", rank=8)
    with dryrun.fake_world(world):
        mesh = make_mesh(*dict(WORLDS)[world], device_type="cpu")
        eager = dryrun.count_step(cfg, cc, kind, B, SEQ, mesh)
        three = dryrun.count_by_layers(cfg, cc, kind, B, SEQ, mesh)
        with pytest.raises(ValueError, match="uniform and hybrid"):
            dryrun.count_by_layers(_cfg("pairs"), cc, kind, B, SEQ, mesh)
    for k in ("flops", "bytes_accessed", "collective_bytes"):
        assert three[k] == eager[k], k
    assert three["flops"] > 0
    for k in three["memory"]:
        assert three["memory"][k] == eager["memory"][k], k
    assert roofline.bytes_moved(three["memory"]) == \
        roofline.bytes_moved(eager["memory"]) > 0


@pytest.mark.parametrize("world", [1, 8])
def test_count_by_layers_by_segments_of_the_hybrid_plan(world):
    """Reduced zamba2 (a shared block every 2 layers, d_model 64: 8 SSD
    heads over 4 "model" ranks at 8) at 11 layers = 5 periods and a tail of
    1, from its three depths of 2, 3 and 4 periods with the same tail (5, 7
    and 9 layers: ``layer_points``), against the eager count at 11: Mode B's
    train step, one microbatch. Every count equals the eager one exactly;
    the peak is given only where the three depths' peaks grow linearly, and
    then equals it too."""
    cfg = _cfg("hybrid").replace(n_layers=11, shared_attn_every=2,
                                 microbatches=1)
    assert dryrun.layer_points(cfg) == ((5, 7, 9), 5)
    assert dryrun.layer_points(registry.get_config("zamba2-7b")) == \
        ((15, 21, 27), 13)
    cc = ColaConfig(mode="fused_fit", family="lowrank", taps="qv", rank=8)
    with dryrun.fake_world(world):
        mesh = make_mesh(*dict(WORLDS)[world], device_type="cpu")
        eager = dryrun.count_step(cfg, cc, "train", B, SEQ, mesh)
        three = dryrun.count_by_layers(cfg, cc, "train", B, SEQ, mesh)
    assert three["depths"] == (5, 7, 9)
    for k in ("flops", "bytes_accessed", "collective_bytes",
              "gathered_leaf_bytes", "layer_input_bytes"):
        assert three[k] == eager[k], k
    assert three["flops"] > 0
    for k in three["memory"]:
        assert three["memory"][k] == eager["memory"][k], k
    recs = eager["collective_records"]
    assert three["collectives"] == tcoll.bytes_by_op(recs)
    assert three["labelled"] == tcoll.by_leaf(recs)
    assert bool(three["labelled"]) == (world > 1)
    if three["peak"] is not None:
        assert three["peak"] == eager["memory"]["peak_bytes_per_device"]


# ---------------------------------------------------------------------------
# production cells
# ---------------------------------------------------------------------------

JAX_KEYS = {"arch", "shape", "mesh", "mode", "kind", "memory", "flops",
            "bytes_accessed", "collective_bytes", "devices", "exact_costs",
            "t_compute", "t_memory", "t_collective", "bottleneck",
            "roofline_s", "roofline_fraction", "model_flops", "useful_ratio"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes", "temp_size_in_bytes",
               "peak_bytes_per_device"}


def test_memory_term_counts_the_gathered_leaves():
    """Reduced nemo's prefill on (2, 4): every leaf a gather reaches is
    read once a use in its compute layout (the whole leaf, or its quarter
    where the product keeps "model" split): the lookup and the tied head
    use the embedding, each layer its slice of every stack."""
    cfg = _cfg("uniform").replace(microbatches=1)
    for world, shape in WORLDS:
        with dryrun.fake_world(world):
            mesh = make_mesh(*shape, device_type="cpu")
            got = dryrun.count_step(cfg, ColaConfig(), "prefill", B, SEQ,
                                    mesh)
            shaped = steps.shaped_params(cfg)
            ps = sh.params_shardings(mesh, shaped)
            plan = tp.Plan(cfg, mesh, "2d", param_specs=ps)
        flat = {}
        sh._map(lambda p, x: flat.__setitem__(sh._path_str(p), x), shaped)
        sp = {}
        sh._map(lambda p, x: sp.__setitem__(sh._path_str(p), x), ps)
        want = 0
        for path, leaf in flat.items():
            r = plan.recipes[path]
            if not (r.steps or r.swap):
                continue
            kept = ("model" in {a for e in sp[path] for a in sh._entry_axes(e)}
                    and "model" not in {a for _, a in r.steps})
            uses = 2 if path == "embed.emb" else 1
            want += (uses * leaf.numel() * leaf.element_size()
                     // (shape[1] if kept else 1))
        m, gathered = got["memory"], got["gathered_leaf_bytes"]
        assert gathered == want and (want > 0) == (world > 1)
        assert roofline.bytes_moved(m, gathered) == (
            m["argument_size_in_bytes"] + m["output_size_in_bytes"]
            - m["alias_size_in_bytes"] + want)
        assert roofline.roofline_terms(got)["t_memory"] == \
            roofline.bytes_moved(m, want) / roofline.HBM_BW


@pytest.mark.parametrize("plan", list(PLANS))
def test_no_serve_tick_moves_a_kv_leaf(plan):
    """A tick of 8 rows against 64 positions at world sizes 1 and 8: no
    collective is labelled with a KV leaf or an SSM state leaf (the cache is
    the rank's block of positions, the state its block of heads, updated in
    place: their bytes are the in-place outputs); the conv state's gathers
    over "model", one layer at a time, are the only cache collectives at 8
    (8 rows' W - 1 positions of every channel, a layer)."""
    cfg = _cfg(plan)
    cache = model.cache_specs(cfg, B, 64)
    held = sum(_numel(leaf[0]) * leaf[1].itemsize
               for st in cache.values() for n, leaf in st.items()
               if n in ("k", "v", "ssm", "conv"))
    for world, shape in WORLDS:
        with dryrun.fake_world(world):
            mesh = make_mesh(*shape, device_type="cpu")
            got = dryrun.count_step(cfg, ColaConfig(), "decode", B, 64, mesh)
        moved = tcoll.by_leaf(got["collective_records"], "cache.")
        mamba = plan in ("ssm", "hybrid") and world > 1
        assert set(moved) == ({"cache.layers.conv"} if mamba else set()), \
            (plan, world, moved)
        if mamba:
            conv = cache["layers"]["conv"]
            # each layer's (4 rows, W - 1, C) whole, in f32
            assert moved["cache.layers.conv"] == {
                "all-gather": _numel(conv[0]) // 2 * conv[1].itemsize}
        # the rank's blocks: rows over "data" (2), positions, heads and
        # channels over "model" (4)
        share = 1 if world == 1 else 8
        assert got["memory"]["alias_size_in_bytes"] == held // share, plan


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def test_production_cell_smollm_decode_32k_on_16x16():
    """smollm-135m's serve tick at 128 slots of 32768 on the 16 x 16 fake
    mesh (train_4k takes ~22 s of host time here: ``--all`` counts it)."""
    rec = dryrun.lower_cell("smollm-135m", "decode_32k", verbose=False)
    assert JAX_KEYS <= set(rec) and MEMORY_KEYS == set(rec["memory"])
    assert rec["mesh"] == "pod16x16" and rec["devices"] == 256
    cfg = registry.get_config("smollm-135m")
    spec = registry.SHAPES["decode_32k"]
    assert rec["model_flops"] == roofline.model_flops(cfg, spec) == \
        2.0 * roofline.param_count(cfg)[1] * 128
    # 8 slots a rank (128 over "data"); the 16 ranks of "model" split the
    # MLP and the head, and each attends its 2,048 positions of 32,768 for
    # the 9 heads, which it computes whole (9 does not divide over 16)
    assert 1 / 16 < rec["useful_ratio"] < 1
    # the cache stays the rank's block (8 slots x 2,048 positions), updated
    # in place and never gathered: no collective moves a cache leaf, the
    # peak holds the block and at most the tree gathered beside it
    whole = sum(t.numel() * t.element_size()
                for t in tree_leaves(model.init(cfg, device="meta")))
    kv = 2 * cfg.n_layers * 8 * (spec.seq // 16) * cfg.n_kv_heads \
        * cfg.d_head * 2
    m = rec["memory"]
    assert m["alias_size_in_bytes"] >= kv and rec["cache_collectives"] == {}
    assert kv < m["argument_size_in_bytes"] < kv + whole / 16
    assert m["peak_bytes_per_device"] < m["argument_size_in_bytes"] + whole
    assert m["peak_bytes_per_device"] < 2e9
    assert set(rec["collectives"]) == {"all-gather", "all-reduce",
                                       "all-to-all"}
    assert rec["collective_bytes"] == sum(rec["collectives"].values()) < kv
    assert "aten.nonzero.default" in rec["bounded_ops"]
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["t_collective_nic"] == pytest.approx(9 * rec["t_collective"],
                                                    rel=1e-12)


def test_moe_cell_refused_by_the_group_check_fails_with_its_text():
    cfg = _cfg("moe").replace(moe_group=64)
    with dryrun.fake_world(8):
        mesh = make_mesh(2, 4, device_type="cpu")
        with pytest.raises(ValueError, match="dispatch groups of 64"):
            dryrun.count_step(cfg, ColaConfig(rank=RANK), "train", B, SEQ,
                              mesh)


def test_perf_probe_breakdown_writes_a_record(tmp_path, capsys):
    out = tmp_path / "probe.jsonl"
    assert perf_probe.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                            "--override", "n_layers=2,ssd_chunk=64",
                            "--tag", "t", "--breakdown",
                            "--out", str(out)]) == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert JAX_KEYS <= set(rec) and MEMORY_KEYS == set(rec["memory"])
    assert rec["tag"] == "t"
    assert rec["overrides"] == {"n_layers": 2, "ssd_chunk": 64}
    text = capsys.readouterr().out
    rows = [line for line in text.splitlines() if " GB  x" in line]
    assert "[collective breakdown" in text and 0 < len(rows) <= 15
    # the leaves' gathers, out_proj's rows turned to columns, the conv
    # state's gathers and the vocab argmax's
    assert all(any(f" {op} " in r for op in ("all-gather", "all-reduce",
                                               "all-to-all")) for r in rows)
    assert sum(int(r.split(" x")[1].split()[0]) for r in rows) <= len(
        rec["collective_records"])
