"""The port's flags, roofline and collective analyses
(``repro_torch.flags``, ``repro_torch.analysis``) against the JAX
package's, on the CPU.

- Flags: none of JAX's keys (the port reads neither), ``get`` and
  ``override`` as JAX's, ``override`` restoring its flags after an
  exception.
- ``ref.sdpa``: the blocked path equals the dense one (the port of
  ``test_kernels.py::test_blocked_sdpa_equals_dense``: S 2048, within
  1e-5), the port's dense path (``ref._sdpa_dense``) equals JAX's dense
  ``ref.sdpa`` on the same numpy inputs within 1e-5, and both paths count
  the same FLOPs.
- ``param_count`` and ``model_flops`` equal JAX's for all eleven configs
  and every shape cell, exactly; ``roofline_terms`` and ``memory_record``
  on hand-made numbers.
- Collectives: the breakdown of hand-made records equals JAX's breakdown
  of the same collectives in HLO text; the recorder under a fake process
  group of 8 sees DTensor's all-gathers and ``dist.all_reduce``.
- ``StepCounter``: bytes accessed and the live peak of a hand-counted op
  sequence.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import flags as jflags  # noqa: E402
from repro.analysis import collectives as jcoll  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import flags as tflags  # noqa: E402
from repro_torch.analysis import collectives as tcoll  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

def test_flags_hold_no_key_the_port_does_not_read():
    """JAX's two keys have nothing to set here (the module's docstring);
    ``get`` and ``override`` refuse an unknown key as JAX's do."""
    assert set(jflags._FLAGS) == {"unroll_scans", "dense_sdpa"}
    assert tflags._FLAGS == {}
    for key in jflags._FLAGS:
        with pytest.raises(KeyError):
            tflags.get(key)
        with pytest.raises(KeyError):
            with tflags.override(**{key: True}):
                pass
    assert tflags._FLAGS == {}


def test_flags_override_restores_after_an_exception(monkeypatch):
    monkeypatch.setattr(tflags, "_FLAGS", {"a": False, "b": True})
    with pytest.raises(RuntimeError, match="inside"):
        with tflags.override(a=True, b=False):
            assert tflags.get("a") and not tflags.get("b")
            raise RuntimeError("inside")
    assert tflags._FLAGS == {"a": False, "b": True}
    with pytest.raises(KeyError):
        with tflags.override(no_such_flag=True):
            pass
    assert tflags._FLAGS == {"a": False, "b": True}


# ---------------------------------------------------------------------------
# blocked and dense sdpa
# ---------------------------------------------------------------------------

def _qkv(S, H, K, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, h, D)).astype(np.float32)
            for h in (H, K, K)]


def test_blocked_sdpa_equals_dense_and_counts_the_same_flops():
    from torch.utils.flop_counter import FlopCounterMode

    S, H, K, D = 2048, 2, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _qkv(S, H, K, D, 7))
    pos = torch.arange(S)[None]
    counts = {}
    with FlopCounterMode(display=False) as fc:
        blocked = tref.sdpa(q, k, v, q_positions=pos, kv_positions=pos)
    counts["blocked"] = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        dense = tref._sdpa_dense(q, k, v, q_positions=pos, kv_positions=pos)
    counts["dense"] = fc.get_total_flops()
    np.testing.assert_allclose(blocked.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    # two products of 2 * S * S * H * D each, whichever path
    assert counts["blocked"] == counts["dense"] == 2 * 2 * S * S * H * D


def test_dense_sdpa_equals_jax_on_the_same_inputs():
    S, H, K, D = 2048, 4, 2, 64
    q, k, v = _qkv(S, H, K, D, 11)
    pos = np.arange(S)[None]
    got = tref._sdpa_dense(*(torch.from_numpy(a) for a in (q, k, v)),
                           q_positions=torch.from_numpy(pos),
                           kv_positions=torch.from_numpy(pos))
    with jflags.override(dense_sdpa=True):
        want = jref.sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                         q_positions=jnp.asarray(pos),
                         kv_positions=jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_param_count_and_model_flops_equal_jax_for_every_config():
    for name in tregistry.ARCH_MODULES:
        tcfg, jcfg = tregistry.get_config(name), jregistry.get_config(name)
        assert troof.param_count(tcfg) == jroof.param_count(jcfg), name
        for cell in tregistry.applicable_shapes(tcfg):
            assert troof.model_flops(tcfg, tregistry.SHAPES[cell]) == \
                jroof.model_flops(jcfg, jregistry.SHAPES[cell]), (name, cell)
    # JAX's values (total, active)
    want = {"mistral-nemo-12b": (11_576_279_040, 11_576_279_040),
            "pixtral-12b": (11_576_279_040, 11_576_279_040),
            "musicgen-medium": (1_837_105_152, 1_837_105_152),
            "zamba2-7b": (6_632_579_072, 9_304_350_720),
            "qwen3-moe-30b-a3b": (30_220_746_752, 3_041_656_832)}
    for name, counts in want.items():
        assert troof.param_count(tregistry.get_config(name)) == counts, name


def _mem(argument, output, alias):
    return troof.memory_record(argument, output, alias,
                               peak=argument + output)


def test_roofline_terms_on_a_hand_made_record():
    """The memory term is the bytes the step must move (inputs + outputs -
    in-place outputs); the unfused bytes stand beside it and set
    nothing."""
    rec = {"flops": 2 * troof.PEAK_FLOPS,
           "memory": _mem(troof.HBM_BW, 0.5 * troof.HBM_BW,
                          0.5 * troof.HBM_BW),
           "bytes_accessed": 100 * troof.HBM_BW,
           "collective_bytes": 0.5 * troof.LINK_BW}
    assert troof.bytes_moved(rec["memory"]) == troof.HBM_BW
    t = troof.roofline_terms(rec)
    assert (t["t_compute"], t["t_memory"], t["t_collective"]) == (2.0, 1.0, 0.5)
    # the unfused term and the NIC term (9 x NVLink's) are reported and set
    # nothing
    assert t["t_memory_unfused"] == 100.0
    assert t["t_collective_nic"] == 0.5 * troof.LINK_BW / troof.NIC_BW == 4.5
    assert t["bottleneck"] == "compute" and t["roofline_s"] == 2.0
    assert t["roofline_fraction"] == 1.0
    rec["memory"] = _mem(8 * troof.HBM_BW, 0, 0)
    t = troof.roofline_terms(rec)
    assert t["bottleneck"] == "memory" and t["roofline_s"] == 8.0
    assert t["roofline_fraction"] == 0.25
    assert troof.roofline_terms({"flops": 0.0, "memory": _mem(0, 0, 0),
                                 "bytes_accessed": 0.0,
                                 "collective_bytes": 0.0})[
        "roofline_fraction"] == 0.0
    # the H100 SXM data sheet's peaks
    assert (troof.PEAK_FLOPS, troof.PEAK_FLOPS_F32, troof.HBM_BW,
            troof.LINK_BW, troof.NIC_BW) == (989e12, 67e12, 3.35e12, 450e9,
                                              50e9)


def test_memory_record_keeps_jax_identity():
    m = troof.memory_record(argument=100, output=30, alias=20, peak=500)
    assert m == {"argument_size_in_bytes": 100, "output_size_in_bytes": 30,
                 "alias_size_in_bytes": 20, "temp_size_in_bytes": 390,
                 "peak_bytes_per_device": 500}
    assert m["peak_bytes_per_device"] == (
        m["argument_size_in_bytes"] + m["output_size_in_bytes"]
        + m["temp_size_in_bytes"] - m["alias_size_in_bytes"])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def test_breakdown_equals_jax_on_the_same_collectives():
    records = ([{"op": "all-gather", "shapes": ["bf16[16,4096]"],
                 "bytes": 16 * 4096 * 2}] * 3
               + [{"op": "all-reduce", "shapes": ["f32[1024]"],
                   "bytes": 4096}] * 5
               + [{"op": "reduce-scatter", "shapes": ["f32[8,128]"],
                   "bytes": 4096}])
    hlo = "\n".join(
        ["  %ag.1 = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} %p), "
         "dimensions={0}"] * 3
        + ["  %ar.2 = f32[1024]{0} all-reduce(f32[1024]{0} %g), to_apply=%sum"]
        * 5
        + ["  %rs.3 = f32[8,128]{1,0} reduce-scatter(f32[64,128]{1,0} %h), "
           "dimensions={0}"])
    for top in (15, 2):
        assert tcoll.breakdown(records, top) == jcoll.breakdown(hlo, top)
    assert tcoll.total_bytes(records) == jroof.collective_bytes(hlo) == \
        3 * 16 * 4096 * 2 + 2 * 5 * 4096 + 4096
    assert tcoll.bytes_by_op(records) == {"all-gather": 3 * 16 * 4096 * 2,
                                          "all-reduce": 2 * 5 * 4096.0,
                                          "reduce-scatter": 4096.0}
    lines = []
    tcoll.print_breakdown(records, report=lines.append)
    jlines = []
    jcoll.print_breakdown(hlo, report=jlines.append)
    assert lines[:-1] == jlines[:-1] and len(lines) == 4


def test_recorder_sees_dtensor_gathers_and_dist_all_reduce():
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    with dryrun.fake_world(8):
        mesh = make_mesh(2, 4, device_type="cpu")
        x = torch.zeros(4, 6, dtype=torch.bfloat16)
        d = DTensor.from_local(x, mesh, (Shard(0), Shard(1)), run_check=False)
        g = torch.zeros(10, dtype=torch.float32)
        rec = tcoll.CollectiveRecorder()
        with rec:
            full = d.full_tensor()
            dist.all_reduce(g, group=mesh.get_group("data"))
        assert tuple(full.shape) == (8, 24)
    assert not dist.is_initialized()
    ops = [(r["op"], r["shapes"], r["bytes"]) for r in rec.records]
    assert ops[-1] == ("all-reduce", ["f32[10]"], 40)
    # "model" (4 ranks) first, gathered along dim 0 and then re-laid out,
    # then "data" (2 ranks): each result the gathered tensor
    assert ops[:-1] == [("all-gather", ["bf16[16,6]"], 16 * 6 * 2),
                        ("all-gather", ["bf16[8,24]"], 8 * 24 * 2)]
    assert tcoll.total_bytes(rec.records) == (16 * 6 + 8 * 24) * 2 + 2 * 40


def test_step_counter_counts_bytes_and_the_live_peak():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    from repro_torch.launch.dryrun import StepCounter

    with FakeTensorMode(shape_env=ShapeEnv()):
        x = torch.empty(1024, dtype=torch.float32)        # 4 KiB held
        w = torch.empty(1024, 256, dtype=torch.float32)   # 1 MiB held
        c = StepCounter([x, w])
        with c:
            y = x.exp()                # 4 + 4 KiB moved; 4 KiB more live
            v = y.view(32, 32)         # a view: nothing
            z = v @ v                  # 4 + 4 + 4 KiB; 8 KiB more live
            del y, v                   # 4 KiB more live
            t = z.reshape(1, 1024) @ w   # 4 + 1024 + 1 KiB; 5 KiB more
            del z
        assert c.argument == (1024 + 1024 * 256) * 4
        kib = 1024
        assert c.bytes_accessed == (8 + 12 + 4 + 1024 + 1) * kib
        assert c.peak == c.argument + 8 * kib
        assert c.storage_bytes([t]) == kib
        assert c.bounded_ops == set()
        mask = torch.zeros(6, dtype=torch.bool)
        with c:
            idx = mask.nonzero()
        assert "aten.nonzero.default" in c.bounded_ops
        assert c.storage_bytes([idx]) == 6 * 8     # at the bound: 6 int64
