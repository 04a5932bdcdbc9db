"""The distribution layer in the port (``repro_torch.distributed``,
``launch/mesh.py``, the registry's input specs and ``MeshConfig``) against
the JAX package's, on the CPU.

- The rules: for every leaf of all eleven configs at full size (meta
  trees against ``jax.eval_shape``), the port's parameter and adapter specs
  equal JAX's on meshes (16, 16), (2, 16, 16) and (2, 4) under both
  policies; so do the batch, cache and delta specs of every shape cell, and
  the input specs. JAX's rules run on an ``AbstractMesh`` (a mesh's shape
  without devices).
- The steps: JAX's ``steps.make_*`` on a (1, 1) mesh with ``Auto`` axes
  (JAX 0.9's ``jax.make_mesh`` gives ``Explicit`` ones, which its
  ``constrain`` refuses) are the oracle for the port's at world size 1, on
  reduced f32 configs (mistral-nemo-12b, qwen3-moe-30b-a3b with MoE groups
  of 32 tokens, mamba2-370m), weights and inputs carried across as numpy:
  Mode A and Mode B with two microbatches, LoRA with one, full FT, prefill
  and the serve step (tokens and logits). Labels are masked unevenly across
  rows (one row wholly), so a wrong microbatch grouping or a mean of means
  fails. The port's steps run in spawned gloo groups
  (``tests/torch_dist_worker.py``): world size 1, and world size 8 on
  (2, 4) and (2, 2, 2) (and (2, 4) under "dp"), whose results must equal
  world size 1's; every rank's block of every placed leaf must be its slice
  under the rule.
- Tensor parallelism over "model": at world size 8 rank 0's counted FLOPs
  of nemo's train and prefill steps are at most 0.2 of world size 1's (the
  rows split over the batch ranks and the attention, MLP and head over
  "model"); a nemo with 6 heads on (2, 4) (heads that do not divide over 4
  ranks: its attention is gathered and replicated over "model") and nemo's
  Mode B and full-FT steps under ``remat="full"`` (the recompute gathers
  again) and Mode B under ``remat="dots"`` (the kept products replayed,
  the rest recomputed) equal world size 1 too; the vocab-parallel CE on each rank's
  vocab columns equals ``_ce`` on the whole logits, whole and in chunks, in
  value, count and gradient.
- Sequence parallelism between blocks: under "2d" at S 16 on (2, 4) and
  (2, 2, 2) every train and prefill step holds the residual stream as the
  rank's (b, S / n, d) rows (rank 0's layer inputs, what remat saves, and
  its "seq.*" collectives), every case above included; mamba's steps (its
  Mamba2 blocks replicated), gemma2's pairs plan and zamba2's hybrid plan
  on (2, 4) equal world size 1 under it; at S 18 (4 does not divide it),
  under "dp" and at world size 1 the stream is whole and no such
  collective is issued.
- Expert parallelism (qwen's 8 experts over the "model" ranks): every
  qwen step on (2, 4) and (2, 2, 2), full FT on (2, 2, 2) (against JAX at
  world size 1), equals world size 1, and so do the batches whose dispatch
  groups span batch ranks (Mode A at 8 rows on (2, 2, 2)), the sort
  dispatch's prefill on (2, 4) and Mode A on (2, 2, 2) (the ranks' expert
  counts exchanged), a 6-expert qwen on (2, 4) (the experts do not divide:
  the FFN replicated) and a prefill at S 18 (no sequence split); rank 0's
  expert leaves arrive as its E / n block, gathered over "data" only, its
  FLOPs of the train and prefill steps are at most 0.2 of world size 1's,
  and its MoE collectives carry their labels.
- The dry-run (``repro_torch.launch.dryrun.count_step``, rank 0 of a fake
  group at the same world size and mesh) counts the same FLOPs and the same
  collective breakdown as rank 0's real step in the gloo groups, exactly,
  for every step that runs (the serve step with its default greedy
  tokens).

Bounds: the loss within 1e-5 relative; gradients and Mode A data rtol 5e-3
/ atol 1e-5 against JAX (JAX's own sharded-step test's bounds); logits and
caches 1e-5; tokens equal. World size 8 against 1: rtol 1e-5, atol 1e-6
(sums over ranks in another order). The vocab-parallel CE: its sum within
1e-6 relative, its count equal, its gradient within 1e-6 of its largest
entry (max-shifted exponentials summed over ranks in another order).
"""
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch_flops  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core import gl as jgl  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.distributed import steps as jsteps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed import steps as tsteps  # noqa: E402
from repro_torch.analysis import collectives as tcoll  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

HERE = os.path.dirname(__file__)
WORKER = os.path.join(HERE, "torch_dist_worker.py")
MESHES = ((16, 16, 1), (16, 16, 2), (2, 4, 1))
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=128, vocab_size=128)
CONFIGS = {
    "nemo": ("mistral-nemo-12b", SMALL),
    # 6 heads (G 3): on 4 "model" ranks the heads do not divide
    "nemo6": ("mistral-nemo-12b", dict(SMALL, n_heads=6)),
    "qwen": ("qwen3-moe-30b-a3b", dict(SMALL, moe_group=32)),
    # 6 experts: on 4 "model" ranks they do not divide, so the MoE FFN is
    # replicated over "model"
    "qwen6e": ("qwen3-moe-30b-a3b", dict(SMALL, moe_group=32, n_experts=6)),
    # 8 SSD heads of 16 (d_inner 128): they divide over 4 and 2 "model"
    # ranks; the conv's 160 channels (x | B | C = 128 | 16 | 16) split in
    # blocks of 40 or 80, across the rank's heads' x channels (32 or 64)
    "mamba": ("mamba2-370m", dict(n_layers=2, d_model=64, vocab_size=128)),
    # 2 SSD heads of 64: on 4 "model" ranks the heads do not divide, so the
    # mixer is replicated (and the serve step's state moved to the rows)
    "mamba2h": ("mamba2-370m", dict(n_layers=2, d_model=64, vocab_size=128,
                                    ssm_headdim=64)),
    # 4 SSD heads of 32, served at 3 rows on (2, 4) (as long_500k's one
    # row): the rows do not divide, the state's heads split over "model"
    # and the conv's 160 channels over "data" and "model" (20 a rank)
    "mamba4h": ("mamba2-370m", dict(n_layers=2, d_model=64, vocab_size=128,
                                    ssm_headdim=32)),
    # the pairs plan (post-norms, softcaps, a window that bites at S 16)
    # and the hybrid plan (a shared attention block before each 2 Mamba2
    # layers)
    "gemma2": ("gemma2-9b", dict(SMALL, local_window=8)),
    "zamba2": ("zamba2-7b", dict(SMALL, n_layers=4, n_kv_heads=4,
                                 shared_attn_every=2)),
}
B_TRAIN, S_TRAIN, B_DEC, S_PRE, MAX_LEN = 16, 16, 8, 16, 32
# a sequence that 4 "model" ranks do not divide: the stream stays whole
S_ODD = 18
# (step, mode, microbatches); the serve step with and without greedy
STEPS = (("train", "faithful_offload", 2), ("train", "fused_fit", 2),
         ("train", "lora", 1), ("train", "ft", 1), ("prefill", None, 1),
         ("serve", True, 1), ("serve", False, 1))
W1_STEPS = {"nemo": STEPS, "qwen": STEPS[:2] + STEPS[3:],
            "mamba": STEPS[:2] + STEPS[4:]}
W8 = (("nemo", (2, 4, 1)), ("nemo", (2, 2, 2)), ("qwen", (2, 4, 1)),
      ("qwen", (2, 2, 2)))


def _w8_steps(key, mesh):
    """W1_STEPS[key] as world size 8 runs them on ``mesh``: qwen's full FT
    (the one step that trains the router and the expert leaves) on (2, 2, 2)
    alone."""
    return tuple(s for s in W1_STEPS[key]
                 if not (key == "qwen" and s[1] == "ft" and mesh != (2, 2, 2)))


# qwen's MoE cases at world sizes 1 and 8 (name, step, mode, microbatches,
# mesh, overrides, inputs): Mode A at 8 rows on (2, 2, 2), a microbatch's
# 16 tokens a rank against groups of 32 (each group spans two batch ranks);
# the sort dispatch's prefill on (2, 4) and Mode A on (2, 2, 2); 6 experts
# on (2, 4), Mode A; a prefill at S_ODD on (2, 4)
MOE_CASES = (
    ("qwen:misaligned", "train", "faithful_offload", 2, (2, 2, 2), {},
     "small"),
    ("qwen:sort", "prefill", None, 1, (2, 4, 1), {"moe_impl": "sort"}, None),
    ("qwen:train:faithful_offload:sort", "train", "faithful_offload", 2,
     (2, 2, 2), {"moe_impl": "sort"}, None),
    (None, "train", "faithful_offload", 2, (2, 4, 1), {}, "qwen6e"),
    (None, "prefill", None, 1, (2, 4, 1), {}, "odd"))
# steps of the head-fallback config, at world sizes 1 and 8 (on (2, 4))
FALLBACK = (("train", "faithful_offload", 2), ("train", "fused_fit", 2),
            ("prefill", None, 1))
# steps run under remat "full" or "dots" on (2, 4), against world size 1's
# without
REMAT = (("train", "fused_fit", 2, "full"), ("train", "ft", 1, "full"),
         ("train", "fused_fit", 2, "dots"))


def _remat_tag(remat):
    """A case name's remat suffix: ":remat" for "full", ":remat-dots"."""
    return ":remat" if remat == "full" else f":remat-{remat}"
# mamba's steps on (2, 4) and (2, 2, 2) (the SSD heads split over "model"),
# mamba2h's at world sizes 1 and 8 (on (2, 4): the mixer replicated), and
# nemo's at S_ODD at world sizes 1 and 8 (on (2, 4))
SSM_W8 = (("train", "faithful_offload", 2), ("train", "fused_fit", 2),
          ("prefill", None, 1), ("serve", True, 1))
SSM_MESHES = ((2, 4, 1), (2, 2, 2))
SSM_FALLBACK = (("train", "fused_fit", 2), ("prefill", None, 1),
                ("serve", True, 1))
ODD = (("train", "fused_fit", 2), ("prefill", None, 1))
# the greedy serve step fed by a prefill step's cache for TICKS ticks
# (mamba, at world size 1 and on (2, 4))
TICKS = 3
# the pairs and hybrid plans under the sequence split, at world sizes 1
# and 8 (on (2, 4))
PLAN_W8 = tuple((k, s) for k in ("gemma2", "zamba2")
                for s in (("train", "fused_fit", 2), ("prefill", None, 1)))


# ---------------------------------------------------------------------------
# the rules at full size
# ---------------------------------------------------------------------------

def _abstract(mesh):
    data, model, pods = mesh
    if pods > 1:
        return AbstractMesh((pods, data, model), ("pod", "data", "model"))
    return AbstractMesh((data, model), ("data", "model"))


def _meshcfg(mesh):
    data, model, pods = mesh
    return tbase.MeshConfig(data=data, model=model, pods=pods)


def _jflat(tree):
    """{dotted path: leaf} of a JAX tree (NamedShardings are leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {jsh._path_str(p): v for p, v in flat}


def _tflat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, path + (k,)))
        return out
    return {".".join(map(str, path)): tree}


def _equal_specs(tspecs, jshardings, what):
    t, j = _tflat(tspecs), _jflat(jshardings)
    assert set(t) == set(j), what
    for k in j:
        assert t[k] == tuple(j[k].spec), (what, k, t[k], j[k].spec)


@pytest.fixture(scope="module")
def trees():
    """Every config's parameter and adapter trees at full size: the port's
    on the meta device, JAX's by eval_shape (taps "all", three families)."""
    out = {}
    key = jax.random.PRNGKey(0)
    for name in tregistry.ARCH_MODULES:
        tcfg, jcfg = tregistry.get_config(name), jregistry.get_config(name)
        t = {"params": TM.init(tcfg, device="meta")}
        j = {"params": jax.eval_shape(lambda: JM.init(jcfg, key))}
        for fam in ("lowrank", "linear", "mlp"):
            tcc = tbase.ColaConfig(family=fam, taps="all")
            jcc = jbase.ColaConfig(family=fam, taps="all")
            t[fam] = tsteps.shaped_adapters(tcfg, tcc)
            j[fam] = jax.eval_shape(
                lambda c=jcc: jgl.init_adapters(jcfg, c, key))
        out[name] = (t, j)
    return out


@pytest.mark.parametrize("policy", ["2d", "dp"])
@pytest.mark.parametrize("mesh", MESHES)
def test_param_and_adapter_specs_equal_jax(trees, mesh, policy):
    for name, (t, j) in trees.items():
        for kind in ("params", "lowrank", "linear", "mlp"):
            adapter = kind != "params"
            _equal_specs(
                tsh.params_shardings(_meshcfg(mesh), t[kind], adapter=adapter,
                                     policy=policy),
                jsh.params_shardings(_abstract(mesh), j[kind],
                                     adapter=adapter, policy=policy),
                (name, kind, mesh, policy))


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_cache_delta_specs_equal_jax(mesh):
    tm, jm = _meshcfg(mesh), _abstract(mesh)
    for name in tregistry.ARCH_MODULES:
        tcfg, jcfg = tregistry.get_config(name), jregistry.get_config(name)
        for cell in tregistry.applicable_shapes(tcfg):
            spec = tregistry.SHAPES[cell]
            for policy in ("2d", "dp"):
                _equal_specs(
                    tsh.batch_shardings(
                        tm, tregistry.input_specs(tcfg, cell), policy),
                    jsh.batch_shardings(
                        jm, jregistry.input_specs(jcfg, cell), policy),
                    (name, cell, policy))
            if spec.kind == "decode":
                _equal_specs(
                    tsh.cache_shardings(tm, TM.cache_specs(tcfg, spec.batch,
                                                           spec.seq)),
                    jsh.cache_shardings(jm, JM.cache_specs(jcfg, spec.batch,
                                                           spec.seq)),
                    (name, cell, "cache"))
                tsteps_specs = tsteps.serve_shardings(tcfg, tm, spec.batch,
                                                      spec.seq)
                jsteps_specs = jsteps.serve_shardings(jcfg, jm, spec.batch,
                                                      spec.seq)
                for a, b in zip(tsteps_specs, jsteps_specs):
                    _equal_specs(a, b, (name, cell, "serve"))
            else:
                tl, tc = tsteps.prefill_out_shardings(tcfg, tm, spec.batch,
                                                      spec.seq)
                jl, jc = jsteps.prefill_out_shardings(jcfg, jm, spec.batch,
                                                      spec.seq)
                assert tl == tuple(jl.spec), (name, cell)
                _equal_specs(tc, jc, (name, cell, "prefill cache"))
            tsites, jsites = TM.tap_sites(tcfg), JM.tap_sites(jcfg)
            tdeltas = {n: (TM.delta_shape(tcfg, s, spec.batch, spec.seq),
                           torch.float32) for n, s in tsites.items()}
            jdeltas = {n: jax.ShapeDtypeStruct(
                JM.delta_shape(jcfg, s, spec.batch, spec.seq), jnp.float32)
                for n, s in jsites.items()}
            _equal_specs(tsh.delta_shardings(tm, tdeltas),
                         jsh.delta_shardings(jm, jdeltas),
                         (name, cell, "deltas"))
            _equal_specs(tsh.replicated(tm, tdeltas),
                         jsh.replicated(jm, jdeltas),
                         (name, cell, "replicated"))


def _sds(t):
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


@pytest.mark.parametrize("name", list(tregistry.ARCH_MODULES))
def test_input_specs_equal_jax(name):
    tcfg, jcfg = tregistry.get_config(name), jregistry.get_config(name)
    for cell in tregistry.applicable_shapes(tcfg):
        t = tregistry.input_specs(tcfg, cell)
        j = jregistry.input_specs(jcfg, cell)
        assert {k: _sds(v) for k, v in t.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in j.items()}, cell
        assert all(v.device.type == "meta" for v in t.values())
    for b in (1, 8):
        t, j = tregistry.decode_token_specs(tcfg, b), \
            jregistry.decode_token_specs(jcfg, b)
        assert {k: _sds(v) for k, v in t.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in j.items()}
    spec = tregistry.SHAPES["train_4k"]
    assert tregistry.batch_specs(tcfg, spec.batch, spec.seq).keys() == \
        jregistry.batch_specs(jcfg, spec.batch, spec.seq).keys()


def test_param_shardings_divisibility(trees):
    """Every assigned arch's rules give valid placements on a (2, 4) mesh:
    each split dim divides (the port of test_distributed.py's case)."""
    mesh = tbase.MeshConfig(data=2, model=4)
    shape = tsh.mesh_shape(mesh)
    for arch in tregistry.ASSIGNED:
        params = trees[arch][0]["params"]
        specs = _tflat(tsh.params_shardings(mesh, params))
        for path, leaf in _tflat(params).items():
            for dim, entry in zip(leaf.shape, specs[path]):
                if entry is None:
                    continue
                axes = (entry,) if isinstance(entry, str) else entry
                n = 1
                for a in axes:
                    n *= shape[a]
                assert dim % n == 0, (arch, path, leaf.shape, specs[path])


def test_mesh_config_and_mesh_builders():
    assert tbase.MeshConfig().devices == 256
    assert tbase.MeshConfig(pods=2).devices == 512
    assert tsh.mesh_shape(tbase.MeshConfig(2, 4, 2)) == \
        {"pod": 2, "data": 2, "model": 4}
    if not torch.distributed.is_initialized():
        for build in (lambda: tmesh.make_mesh(1, 1, device_type="cpu"),
                      lambda: tmesh.single_device_mesh(),
                      lambda: tmesh.make_production_mesh(device_type="cpu")):
            with pytest.raises(RuntimeError, match="process group"):
                build()


def test_constrain_and_batch_reductions_outside_a_split():
    x = torch.randn(4, 6)
    assert tsh.constrain(x, "batch", "model") is x
    with tsh.activation_rules(tbase.MeshConfig(2, 4)) as r:
        assert r.batch_axes == ("data",) and r.model_axis == "model"
        assert tsh.constrain(x, "batch", "model") is x
        assert tsh.batch_sum(x) is x
        assert torch.equal(tsh.batch_mean(x), x.mean(dim=0))
    with tsh.activation_rules(tbase.MeshConfig(2, 4), "dp") as r:
        assert r.batch_axes == ("data", "model") and r.model_axis is None
    assert tsh.current_rules() is None
    with pytest.raises(ValueError, match="DeviceMesh"):
        with tsh.activation_rules(tbase.MeshConfig(2, 4), local_rows=True):
            pass


# ---------------------------------------------------------------------------
# the steps: world sizes 1 and 8 against JAX
# ---------------------------------------------------------------------------

def _configs(key, m):
    name, kw = CONFIGS[key]
    return (jregistry.reduced_config(name).replace(**kw, microbatches=m),
            dict(kw, microbatches=m))


def _labels(rng, vocab, B, S):
    lab = rng.integers(0, vocab, (B, S)).astype(np.int32)
    for r in range(B):
        lab[r, :(r * 5) % (S + 1)] = -1
    lab[3] = -1
    return lab


def _inputs(key):
    jcfg, _ = _configs(key, 1)
    rng = np.random.default_rng(7)
    params = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    cc = jbase.ColaConfig(mode="fused_fit", family="lowrank", taps="qv",
                          rank=4)
    adapters = jax.tree.map(np.asarray, jgl.init_adapters(
        jcfg, cc, jax.random.PRNGKey(1)))
    for w in adapters.values():   # B != 0, so dA != 0
        w["B"] = (rng.standard_normal(w["B"].shape) * 0.1).astype(np.float32)
    V = jcfg.vocab_size
    train = {"tokens": rng.integers(0, V, (B_TRAIN, S_TRAIN)).astype(np.int32),
             "labels": _labels(rng, V, B_TRAIN, S_TRAIN)}
    pre = {"tokens": rng.integers(0, V, (B_DEC, S_PRE)).astype(np.int32)}
    odd = {"train": {
        "tokens": rng.integers(0, V, (B_TRAIN, S_ODD)).astype(np.int32),
        "labels": _labels(rng, V, B_TRAIN, S_ODD)},
        "prefill": {"tokens": rng.integers(0, V, (B_DEC, S_ODD))
                    .astype(np.int32)}}
    cache = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.5).astype(s.dtype),
        JM.cache_specs(jcfg, B_DEC, MAX_LEN))
    dec = {"tokens": rng.integers(0, V, (B_DEC, 1)).astype(np.int32),
           "positions": rng.integers(0, MAX_LEN - 1, B_DEC).astype(np.int32)}
    return {"params": params, "adapters": adapters, "train": train,
            "prefill": pre, "cache": cache, "decode": dec, "odd": odd}


def _case_name(key, step, mode, mesh=None):
    tail = "" if mesh is None else f"@{'x'.join(map(str, mesh))}"
    return f"{key}:{step}:{mode}{tail}"


def _case(key, step, mode, m, mesh, inputs, policy=None, batch=None,
          remat=None, odd=False):
    """One worker case; ``odd``: at S_ODD positions (named ":s18")."""
    _, kw = _configs(key, m)
    if policy:
        kw = dict(kw, shard_policy=policy)
    if remat:
        kw = dict(kw, remat=remat)
    named = f"{mode}:s{S_ODD}" if odd else mode
    c = {"name": _case_name(key, step, named, mesh) + (f":{policy}"
                                                       if policy else "")
         + (_remat_tag(remat) if remat else ""),
         "config": CONFIGS[key][0], "overrides": kw, "mesh": mesh,
         "weights": key, "step": step}
    src = inputs["odd"] if odd else inputs
    if odd:
        c["seq"] = S_ODD
    if step == "train":
        c.update(mode=mode, batch=batch or src["train"])
    elif step == "prefill":
        c.update(batch=src["prefill"])
    else:
        c.update(greedy=mode, batch=inputs["decode"], cache=inputs["cache"],
                 max_len=MAX_LEN)
    return c


def _spawn(tmp, world, cases, weights):
    src = os.path.join(tmp, f"in{world}.pkl")
    dst = os.path.join(tmp, f"out{world}.pkl")
    with open(src, "wb") as f:
        pickle.dump({"weights": weights, "cases": cases}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, WORKER, src, dst, str(world)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    return proc, dst


def _collect(proc, dst):
    out, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawned groups, started together: world size 1 on (1, 1) for
    every W1_STEPS case; world size 8 for every W8 case, nemo's fused_fit on
    (2, 4) under "dp"; qwen's MOE_CASES at both sizes; the FALLBACK steps of
    nemo6 at both sizes, the REMAT steps of nemo on (2, 4) and the
    vocab-parallel CE case at world size 8. Returns
    the inputs, JAX's outputs and both runs' outputs, each run's with the
    dry-run's counts of its cases (``"dry"``), made while the groups
    run."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    inputs = {k: _inputs(k) for k in CONFIGS}
    weights = {k: {"params": v["params"], "adapters": v["adapters"]}
               for k, v in inputs.items()}
    one = [_case(k, s, mo, m, (1, 1, 1), inputs[k])
           for k, steps in W1_STEPS.items() for s, mo, m in steps]
    eight = [_case(k, s, mo, m, mesh, inputs[k])
             for k, mesh in W8 for s, mo, m in _w8_steps(k, mesh)]
    eight.append(_case("nemo", "train", "fused_fit", 2, (2, 4, 1),
                       inputs["nemo"], policy="dp"))
    for mesh, run in (((1, 1, 1), one), (None, eight)):
        run += [_moe_case(c, mesh, inputs) for c in MOE_CASES]
    for s, mo, m in FALLBACK:
        one.append(_case("nemo6", s, mo, m, (1, 1, 1), inputs["nemo6"]))
        eight.append(_case("nemo6", s, mo, m, (2, 4, 1), inputs["nemo6"]))
    eight += [_case("nemo", s, mo, m, (2, 4, 1), inputs["nemo"],
                    remat=r) for s, mo, m, r in REMAT]
    eight += [_case("mamba", s, mo, m, mesh, inputs["mamba"])
              for mesh in SSM_MESHES for s, mo, m in SSM_W8]
    for s, mo, m in SSM_FALLBACK:
        one.append(_case("mamba2h", s, mo, m, (1, 1, 1), inputs["mamba2h"]))
        eight.append(_case("mamba2h", s, mo, m, (2, 4, 1),
                           inputs["mamba2h"]))
    one.append(_ticks_case((1, 1, 1), inputs["mamba"]))
    eight.append(_ticks_case((2, 4, 1), inputs["mamba"]))
    for mesh, run in (((1, 1, 1), one), ((2, 4, 1), eight)):
        run.append(_three_rows(_case("mamba4h", "serve", True, 1, mesh,
                                     inputs["mamba4h"])))
    for k, (s, mo, m) in PLAN_W8:
        one.append(_case(k, s, mo, m, (1, 1, 1), inputs[k]))
        eight.append(_case(k, s, mo, m, (2, 4, 1), inputs[k]))
    for s, mo, m in ODD:
        one.append(_case("nemo", s, mo, m, (1, 1, 1), inputs["nemo"],
                         odd=True))
        eight.append(_case("nemo", s, mo, m, (2, 4, 1), inputs["nemo"],
                           odd=True))
    eight.append(_ce_case())
    p1, d1 = _spawn(tmp, 1, one, weights)
    p8, d8 = _spawn(tmp, 8, eight, weights)
    try:
        oracles = _oracles(inputs)
        dry1, dry8 = _dry_counts(1, one), _dry_counts(8, eight)
        out1, out8 = _collect(p1, d1), _collect(p8, d8)
        out1["dry"], out8["dry"] = dry1, dry8
        return inputs, oracles, out1, out8
    finally:
        for p in (p1, p8):
            if p.poll() is None:
                p.kill()
                p.communicate()


def _moe_case(c, mesh, inputs):
    """MOE_CASES' case ``c`` on ``mesh`` (None: its own)."""
    name, step, mode, m, own, overrides, which = c
    key = "qwen6e" if which == "qwen6e" else "qwen"
    mesh = mesh or own
    batch = ({k: v[:8] for k, v in inputs["qwen"]["train"].items()}
             if which == "small" else None)
    case = _case(key, step, mode, m, mesh, inputs[key], batch=batch,
                 odd=which == "odd")
    case["overrides"] = dict(case["overrides"], **overrides)
    if name:
        case["name"] = f"{name}@{'x'.join(map(str, mesh))}"
    return case


def _three_rows(case):
    """A serve case at the first 3 of its 8 rows (named ":3rows")."""
    case = dict(case, name=case["name"].replace("@", ":3rows@"))
    case["batch"] = {k: v[:3] for k, v in case["batch"].items()}
    case["cache"] = {st: {n: v[:, :3] for n, v in leaves.items()}
                     for st, leaves in case["cache"].items()}
    return case


def _ticks_case(mesh, inputs):
    return {"name": _case_name("mamba", "ticks", TICKS, mesh),
            "config": CONFIGS["mamba"][0],
            "overrides": _configs("mamba", 1)[1], "mesh": mesh,
            "weights": "mamba", "step": "ticks", "ticks": TICKS,
            "prefill": inputs["prefill"]["tokens"],
            "batch": inputs["prefill"]}


def _ce_case():
    """Whole logits (4 x 8 x 128, O(3)) and labels with masked positions,
    for the vocab-parallel CE on (2, 4)."""
    rng = np.random.default_rng(11)
    V = SMALL["vocab_size"]
    labels = rng.integers(0, V, (4, 8)).astype(np.int64)
    labels[0, :3] = -1
    labels[2] = -1
    return {"name": "nemo:ce@2x4x1", "config": CONFIGS["nemo"][0],
            "overrides": SMALL, "mesh": (2, 4, 1), "weights": "nemo",
            "step": "ce", "labels": labels,
            "logits": (rng.standard_normal((4, 8, V)) * 3).astype(np.float32)}


def _dry_counts(world, cases):
    """The dry-run's count of each case that runs a step (the serve step
    greedy), as rank 0 of a fake group of ``world`` ranks on the case's
    mesh: {case name: {"flops", "breakdown"}}."""
    out = {}
    with dryrun.fake_world(world):
        meshes = {}
        for c in cases:
            if c.get("greedy") is False or c["step"] in ("ce", "ticks"):
                continue
            key = tuple(c["mesh"])
            if key not in meshes:
                meshes[key] = tmesh.make_mesh(key[0], key[1], key[2],
                                              device_type="cpu")
            cfg = tregistry.reduced_config(c["config"]).replace(
                **c["overrides"])
            cc = tbase.ColaConfig(mode=c.get("mode") or "fused_fit",
                                  family="lowrank", taps="qv", rank=4)
            if c["step"] == "train":
                args = ("train", len(c["batch"]["tokens"]),
                        c.get("seq", S_TRAIN))
            elif c["step"] == "prefill":
                args = ("prefill", len(c["batch"]["tokens"]),
                        c.get("seq", S_PRE))
            else:
                args = ("decode", len(c["batch"]["positions"]), MAX_LEN)
            count = dryrun.count_step(cfg, cc, *args, meshes[key])
            out[c["name"]] = {"flops": count["flops"],
                              "breakdown": tcoll.breakdown(
                                  count["collective_records"], top=None)}
    return out


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _oracles(inputs):
    """JAX's step builders on the (1, 1) Auto mesh, per W1_STEPS case:
    {case name: {"loss"?, "out": {path: array}}}."""
    mesh = _jmesh()
    out = {}
    for key, steps in W1_STEPS.items():
        inp = inputs[key]
        params, adapters = _jnp(inp["params"]), _jnp(inp["adapters"])
        logits = None
        for step, mode, m in steps:
            jcfg, _ = _configs(key, m)
            name = _case_name(key, step, mode, (1, 1, 1))
            if step == "train":
                cc = jbase.ColaConfig(mode=mode, family="lowrank", taps="qv",
                                      rank=4)
                fn, _, _ = jsteps.make_train_step(jcfg, cc, mesh)
                batch = _jnp(inp["train"])
                if mode == "ft":
                    loss, res = jax.jit(fn)(params, batch)
                else:
                    loss, res = jax.jit(fn)(params, adapters, batch)
                out[name] = {"loss": float(loss), "out": _paths(res)}
            elif step == "prefill":
                fn, _ = jsteps.make_prefill_step(jcfg, mesh)
                lg, cache = jax.jit(fn)(params, _jnp(inp["prefill"]))
                out[name] = {"out": _paths({"logits": lg, "cache": cache})}
            else:
                if logits is None:
                    fn, _ = jsteps.make_serve_step(jcfg, mesh, greedy=False)
                    logits, cache = jax.jit(fn)(params, _jnp(inp["cache"]),
                                                _jnp(inp["decode"]))
                res = (jnp.argmax(logits, axis=-1).astype(jnp.int32)
                       if mode else logits)
                out[name] = {"out": _paths({"out": res, "cache": cache})}
    return out


def _paths(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, path + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, path + (i,)))
        return out
    return {path: np.asarray(tree)}


def _agree(got, want, rtol, atol, what):
    """Equal paths and shapes; integer leaves equal, float ones within
    rtol / atol."""
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape, (what, k)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", [
    _case_name(k, s, mo, (1, 1, 1)) for k, steps in W1_STEPS.items()
    for s, mo, _ in steps])
def test_world1_steps_match_jax(runs, name):
    _, oracles, one, _ = runs
    got, want = one["results"][name], oracles[name]
    assert "raised" not in got and "error" not in got, got
    if "loss" in want:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    step = name.split(":")[1]
    rtol, atol = (5e-3, 1e-5) if step == "train" else (1e-5, 1e-5)
    _agree(got["out"], want["out"], rtol, atol, name)
    if step == "train":
        assert all(np.abs(v).max() > 0 for v in got["out"].values()), name


def test_world1_placements_and_no_failures(runs):
    _, _, one, _ = runs
    assert one["bad"] == []


def _moe_names(mesh=None):
    """The names of MOE_CASES on ``mesh`` (None: each on its own)."""
    names = []
    for c in MOE_CASES:
        on = mesh or c[4]
        tail = "x".join(map(str, on))
        if c[0]:
            names.append(f"{c[0]}@{tail}")
        else:
            key = "qwen6e" if c[6] == "qwen6e" else "qwen"
            mode = f"{c[2]}:s{S_ODD}" if c[6] == "odd" else c[2]
            names.append(_case_name(key, c[1], mode, on))
    return names


@pytest.mark.parametrize("name", [
    _case_name(k, s, mo, mesh) for k, mesh in W8
    for s, mo, _ in _w8_steps(k, mesh)]
    + ["nemo:train:fused_fit@2x4x1:dp"] + _moe_names()
    + [_case_name("nemo6", s, mo, (2, 4, 1)) for s, mo, _ in FALLBACK]
    + [_case_name("nemo", s, mo, (2, 4, 1)) + _remat_tag(r)
       for s, mo, _, r in REMAT]
    + [_case_name("mamba", s, mo, mesh) for mesh in SSM_MESHES
       for s, mo, _ in SSM_W8]
    + [_case_name("mamba2h", s, mo, (2, 4, 1)) for s, mo, _ in SSM_FALLBACK]
    + ["mamba4h:serve:True:3rows@2x4x1"]
    + [_case_name(k, s, mo, (2, 4, 1)) for k, (s, mo, _) in PLAN_W8]
    + [_case_name("nemo", s, f"{mo}:s{S_ODD}", (2, 4, 1))
       for s, mo, _ in ODD])
def test_world8_matches_world1(runs, name):
    _, _, one, eight = runs
    got = eight["results"][name]
    assert "raised" not in got and "error" not in got, got
    want = one["results"][name.split("@")[0] + "@1x1x1"]
    if "loss" in want:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _agree(got["out"], want["out"], 1e-5, 1e-6, name)


@pytest.mark.parametrize("name", [
    _case_name(k, s, mo, mesh) for k in ("nemo", "qwen")
    for mesh in ((2, 4, 1), (2, 2, 2))
    for s, mo, _ in _w8_steps(k, mesh) if s in ("train", "prefill")])
def test_world8_splits_the_products_over_model(runs, name):
    """Rank 0 of 8 computes at most 0.2 of world size 1's FLOPs: its rows
    (a half or a quarter) and its share over "model" (a quarter or a half)
    of the attention, the MLP or the experts, and the head; data
    parallelism alone gave 0.5 on (2, 4), and qwen's MoE FFN replicated
    over "model" 0.39."""
    _, _, one, eight = runs
    got = eight["results"][name]["count"]["flops"]
    want = one["results"][name.split("@")[0] + "@1x1x1"]["count"]["flops"]
    assert 0 < got <= 0.2 * want, (name, got / want)


def test_fallback_splits_the_mlp_and_head_only(runs):
    """nemo with 6 heads on (2, 4): the attention's products stay whole on
    every rank of a row block; the MLP and the head split over 4."""
    _, _, one, eight = runs
    name = _case_name("nemo6", "prefill", None, (2, 4, 1))
    got = eight["results"][name]["count"]["flops"]
    want = one["results"][name.split("@")[0] + "@1x1x1"]["count"]["flops"]
    assert 0.125 < got / want < 0.5, got / want


# rank 0's layer inputs (rows, positions, d_model): a train step's M = 2
# microbatches of 8 rows, a prefill's 8 rows; on (2, 4) 2 row blocks and 4
# "model" ranks, on (2, 2, 2) 4 row blocks and 2 "model" ranks, under "dp"
# 8 row blocks
LAYER_INPUTS = {
    "nemo:train:fused_fit@1x1x1": (8, 16, 64),
    "nemo:train:fused_fit@2x4x1": (4, 4, 64),
    "nemo:train:fused_fit@2x4x1:remat": (4, 4, 64),
    "nemo:train:ft@2x4x1:remat": (8, 4, 64),
    "nemo:train:fused_fit@2x4x1:remat-dots": (4, 4, 64),
    "nemo:prefill:None@2x4x1": (4, 4, 64),
    "nemo:train:fused_fit@2x2x2": (2, 8, 64),
    "qwen:train:fused_fit@2x4x1": (4, 4, 64),
    "nemo6:train:fused_fit@2x4x1": (4, 4, 64),
    "mamba:train:fused_fit@2x4x1": (4, 4, 64),
    "mamba:prefill:None@2x4x1": (4, 4, 64),
    "gemma2:train:fused_fit@2x4x1": (4, 4, 64),
    "zamba2:prefill:None@2x4x1": (4, 4, 64),
    f"nemo:train:fused_fit:s{S_ODD}@2x4x1": (4, S_ODD, 64),
    f"nemo:prefill:None:s{S_ODD}@2x4x1": (4, S_ODD, 64),
    "nemo:train:fused_fit@2x4x1:dp": (1, 16, 64),
}


@pytest.mark.parametrize("name", list(LAYER_INPUTS))
def test_residual_stream_is_split_by_sequence(runs, name):
    """Under "2d" with n "model" ranks dividing S, every layer's input (what
    remat="full" saves) is rank 0's (b, S / n, d) rows, and the step issues
    the sequence split's collectives ("seq.*"); at S = 18 on 4 ranks, under
    "dp" and at world size 1 it is the whole (b, S, d) and none is issued."""
    _, _, one, eight = runs
    run = one if name.endswith("@1x1x1") else eight
    count = run["results"][name]["count"]
    assert count["layer_inputs"] == [LAYER_INPUTS[name]], name
    whole = S_ODD if f":s{S_ODD}" in name else S_TRAIN   # S_PRE alike
    split = LAYER_INPUTS[name][1] < whole
    assert bool(count["seq_moves"]) == split, (name, count["seq_moves"])
    if split:
        # the vocab-split embedding's reduce-scatter; the split parts' entry
        # and exit (the MoE FFN's gather); the head's gather (a prefill's
        # last positions instead)
        want = {"seq.embed", "seq.in", "seq.out"}
        want |= {"seq.head"} if ":train:" in name else {"seq.pick"}
        assert want <= set(count["seq_moves"]), (name, count["seq_moves"])
        # a replicated part gathers the rows (nemo6's attention); the
        # Mamba2 mixers split their heads, the MoE FFN its experts
        assert ("seq.gather" in count["seq_moves"]) == name.startswith(
            "nemo6"), (name, count["seq_moves"])
        assert set(count["seq_moves"].get("seq.out", {"all-to-all": 0})) \
            == {"all-to-all"}, count["seq_moves"]


@pytest.mark.parametrize("chunk", [0, 4])
def test_vocab_parallel_ce_equals_ce_on_the_gathered_logits(runs, chunk):
    """Rank 0's ``_ce`` on its 32 vocab columns of 128, under the step's
    plan on (2, 4), against ``_ce`` on the whole logits (every rank checks
    its own; a gap past the bounds is in the run's failures)."""
    _, _, _, eight = runs
    got = eight["results"]["nemo:ce@2x4x1"][chunk]
    np.testing.assert_allclose(got["sum"], got["want_sum"], rtol=1e-6)
    assert got["count"] == got["want_count"] == 21.0
    assert got["grad_gap"] <= 1e-6 * got["grad_scale"]
    assert got["grad_scale"] > 0.1
    assert not [b for b in eight["bad"] if "ce@" in b]


def test_world8_placements_and_misaligned_moe_groups(runs):
    """Every rank's blocks are their slices; a batch whose dispatch groups
    span batch ranks and the sort dispatch's prefill equal world size 1
    (one device's groups and capacities)."""
    _, _, one, eight = runs
    assert eight["bad"] == []
    for name in ("qwen:misaligned@2x2x2", "qwen:sort@2x4x1"):
        got = eight["results"][name]
        assert "error" not in got, got
        want = one["results"][name.split("@")[0] + "@1x1x1"]
        if "loss" in want:
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        _agree(got["out"], want["out"], 1e-5, 1e-6, name)


# the experts of rank 0's expert leaves as it gathered them (d_model 64
# gathered over "data", d_expert 64): its E / n block of qwen's 8 over 4 or
# 2 "model" ranks; all 6 of qwen6e's, which do not divide over 4; none
# gathered at world size 1
EXPERT_BLOCKS = {
    "qwen:train:fused_fit@2x4x1": 2, "qwen:train:fused_fit@2x2x2": 4,
    "qwen:train:ft@2x2x2": 4, "qwen:serve:True@2x4x1": 2,
    "qwen:misaligned@2x2x2": 4, "qwen6e:train:faithful_offload@2x4x1": 6,
    "qwen:train:fused_fit@1x1x1": None}


@pytest.mark.parametrize("name", list(EXPERT_BLOCKS))
def test_rank_gathers_its_experts_over_fsdp_only(runs, name):
    """Each expert leaf reaches rank 0 as its block of experts, whole over
    d_model (its "data" block gathered, a layer at a time) and never
    gathered over "model" where the experts split over it."""
    _, _, one, eight = runs
    run = one if name.endswith("@1x1x1") else eight
    got = run["results"][name]["count"]["experts"]
    E = EXPERT_BLOCKS[name]
    assert got == ({} if E is None else {
        f"layers.moe.{w}": [(E, 64, 64)] for w in ("gate", "up", "down")}), \
        (name, got)


_EP = {"moe.in": {"all-gather", "reduce-scatter"},
       "moe.out": {"reduce-scatter", "all-gather"}}
# rank 0's MoE collectives by label and op: the input gathered over the
# sequence (its gradient reduce-scattered) and the experts' shares
# reduce-scattered (the gradient gathered); without the sequence split (S
# 18, the serve step) a prefill's and a tick's shares all-reduced; the
# batch ranks' expert counts where the groups span them and under the sort
# dispatch; none where the FFN is replicated
MOE_LABELS = {
    "qwen:train:fused_fit@2x4x1": _EP, "qwen:train:ft@2x2x2": _EP,
    "qwen:misaligned@2x2x2": dict(_EP, **{"moe.counts": {"all-gather"}}),
    "qwen:train:faithful_offload:sort@2x2x2": dict(
        _EP, **{"moe.counts": {"all-gather"}}),
    "qwen:sort@2x4x1": {"moe.in": {"all-gather"},
                        "moe.out": {"reduce-scatter"},
                        "moe.counts": {"all-gather"}},
    f"qwen:prefill:None:s{S_ODD}@2x4x1": {"moe.out": {"all-reduce"}},
    "qwen:serve:True@2x4x1": {"moe.out": {"all-reduce"}},
    "qwen6e:train:faithful_offload@2x4x1": {}}


@pytest.mark.parametrize("name", list(MOE_LABELS))
def test_moe_collectives_by_label(runs, name):
    _, _, _, eight = runs
    got = eight["results"][name]["count"]["moe_moves"]
    assert {k: set(v) for k, v in got.items()} == MOE_LABELS[name], got


def test_lm_loss_is_its_sum_over_its_count():
    """The factored sum and count give lm_loss's value bit for bit, whole
    and in chunks."""
    cfg = tregistry.reduced_config("mistral-nemo-12b").replace(**SMALL)
    params = TM.init(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 16, cfg.d_model, generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    labels[0, :5] = -1
    for chunk in (0, 4):
        c = cfg.replace(loss_chunk=chunk)
        s, n = TM.lm_loss_sum(c, params, h, labels)
        assert torch.equal(TM.lm_loss(c, params, h, labels),
                           s / n.clamp(min=1.0))
        assert float(n) == 27.0


@pytest.mark.parametrize("world", [1, 8])
def test_dry_run_counts_equal_the_real_steps(runs, world):
    """Rank 0's FLOPs and collective breakdown of every step, real (gloo)
    and counted (fake group, fake tensors)."""
    _, _, one, eight = runs
    run = one if world == 1 else eight
    dry = run["dry"]
    assert len(dry) == (16 + len(FALLBACK) + len(ODD) + len(PLAN_W8)
                        + len(SSM_FALLBACK) + len(MOE_CASES) if world == 1
                        else 23 + len(FALLBACK) + len(REMAT)
                        + len(SSM_MESHES) * len(SSM_W8) + len(SSM_FALLBACK)
                        + len(ODD) + len(PLAN_W8) + len(MOE_CASES))
    for name, want in dry.items():
        got = run["results"][name]["count"]
        assert got["flops"] == want["flops"] > 0, name
        assert list(got["breakdown"]) == list(want["breakdown"]), name
        assert bool(want["breakdown"]) == (world > 1), name


# ---------------------------------------------------------------------------
# the Mamba2 heads over "model"
# ---------------------------------------------------------------------------

# the head count of every SSD scan or recurrence step rank 0 runs: mamba's
# and zamba2's 8 heads split over 4 or 2 "model" ranks; mamba2h's 2 heads
# do not divide over 4, so they stay whole
SSD_HEADS = {
    **{_case_name("mamba", s, mo, (1, 1, 1)): 8
       for s, mo, _ in W1_STEPS["mamba"]},
    **{_case_name("mamba", s, mo, (2, 4, 1)): 2 for s, mo, _ in SSM_W8},
    **{_case_name("mamba", s, mo, (2, 2, 2)): 4 for s, mo, _ in SSM_W8},
    **{_case_name("mamba2h", s, mo, mesh): 2 for s, mo, _ in SSM_FALLBACK
       for mesh in ((1, 1, 1), (2, 4, 1))},
    **{_case_name("zamba2", s, mo, (2, 4, 1)): 2 for s, mo, _ in
       (x for k, x in PLAN_W8 if k == "zamba2")},
}


@pytest.mark.parametrize("name", list(SSD_HEADS))
def test_ssd_scans_the_ranks_heads(runs, name):
    """Rank 0's SSD scans (train, prefill) and recurrence steps (serve) run
    H / n heads where the heads divide over n "model" ranks, all H where
    they do not (the mixer replicated)."""
    _, _, one, eight = runs
    run = one if name.endswith("@1x1x1") else eight
    assert run["results"][name]["count"]["ssd_heads"] == [SSD_HEADS[name]]


@pytest.mark.parametrize("mesh", SSM_MESHES)
def test_serve_step_keeps_the_ssm_state_as_the_ranks_block(runs, mesh):
    """mamba's greedy tick at world size 8: every rank's SSM state block
    (its rows and heads) and conv block (its rows and channels) is the
    input's storage, updated in place; no collective is labelled with the
    state, and the conv state is gathered over "model" one layer at a time
    (2 layers of 4 or 2 rows, W - 1 = 3 positions, 160 channels, f32).
    mamba2h's state, which ``cache_shardings`` splits by its head dim P (its
    2 heads do not divide over 4), is taken to the rows and placed anew."""
    _, _, _, eight = runs
    got = eight["results"][_case_name("mamba", "serve", True, mesh)]
    assert got["in_place"] == {"layers.conv": True, "layers.ssm": True}
    rows = 8 // (2 if mesh == (2, 4, 1) else 4)
    assert got["count"]["cache_moves"] == {
        "cache.layers.conv": {"all-gather": 2 * rows * 3 * 160 * 4.0}}
    fallback = eight["results"][_case_name("mamba2h", "serve", True,
                                           (2, 4, 1))]
    assert set(fallback["count"]["cache_moves"]) == {"cache.layers.conv",
                                                     "cache.layers.ssm"}


def test_serve_step_at_rows_that_do_not_divide(runs):
    """mamba4h's tick at 3 rows on (2, 4): every rank computes the 3 rows,
    scans its 1 of the 4 heads against its heads block of the state, and
    holds the conv state's 20 channels of 160, split over "data" and
    "model": gathered over both a layer at a time (2 layers of 3 rows, W
    - 1 = 3 positions, 160 channels, f32), the block written back in
    place; equal to world size 1 (``test_world8_matches_world1``)."""
    _, _, one, eight = runs
    got = eight["results"]["mamba4h:serve:True:3rows@2x4x1"]
    assert got["in_place"] == {"layers.conv": True, "layers.ssm": True}
    assert got["count"]["ssd_heads"] == [1]
    assert got["count"]["cache_moves"] == {
        "cache.layers.conv": {"all-gather": 2 * 3 * 3 * (80 + 160) * 4.0}}
    assert one["results"]["mamba4h:serve:True:3rows@1x1x1"]["count"][
        "ssd_heads"] == [4]


@pytest.mark.parametrize("mesh", SSM_MESHES)
def test_world8_splits_the_ssd_heads(runs, mesh):
    """Rank 0's counted FLOPs of mamba's Mode B step (M = 2) are its rows'
    share with the SSD heads, out_proj and the head split over the "model"
    ranks (in_proj, C B^T and the adapters' x @ A whole), and world size
    1's the whole step's, both as ``torch_flops.train_flops`` writes them
    out from the widths: on (2, 4) 4 rows a microbatch over 4 ranks, on
    (2, 2, 2) 2 rows over 2, against 8 rows at world size 1."""
    _, _, one, eight = runs
    name = _case_name("mamba", "train", "fused_fit", mesh)
    got = eight["results"][name]["count"]["flops"]
    want = one["results"][name.split("@")[0] + "@1x1x1"]["count"]["flops"]
    cfg = tregistry.reduced_config("mamba2-370m").replace(
        **_configs("mamba", 2)[1])
    n = mesh[1]
    rows = B_TRAIN // 2 // (mesh[0] * mesh[2])
    assert want == torch_flops.train_flops("ssm", cfg, "fused_fit",
                                           B_TRAIN // 2, S_TRAIN, 4)
    assert got == torch_flops.train_flops("ssm", cfg, "fused_fit", rows,
                                          S_TRAIN, 4, n)
    assert got / want < 1 / mesh[0] / mesh[2], got / want


def test_conv_state_after_three_ticks_equals_world1(runs):
    """mamba's prefill step (8 x 16) feeds the greedy serve step, then three
    ticks, each token fed back, on (2, 4) and at world size 1. The conv
    state, whose 40-channel block on a rank is not its heads' 32 x
    channels, equals world size 1's bit for bit after the three ticks; the
    tokens are equal and the SSM state within the step bounds. The
    prefill's cache arrives at the serve step's placement: no tick moves a
    state leaf (only the per-layer conv gathers), every rank's blocks keep
    their storage through the three ticks, and each tick's SSD steps run 2
    heads."""
    _, _, one, eight = runs
    got = eight["results"][_case_name("mamba", "ticks", TICKS, (2, 4, 1))]
    want = one["results"][_case_name("mamba", "ticks", TICKS, (1, 1, 1))]
    assert "error" not in got and "error" not in want, (got, want)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    conv = ("cache", "layers", "conv")
    np.testing.assert_array_equal(got["out"][conv], want["out"][conv])
    _agree(got["out"], want["out"], 1e-5, 1e-6, "ticks")
    assert got["in_place"] == {"layers.conv": True, "layers.ssm": True}
    assert got["cache_moves"] == {
        "cache.layers.conv": {"all-gather": TICKS * 2 * 4 * 3 * 160 * 4.0}}
    assert got["ssd_heads"] == [2] and want["ssd_heads"] == [8]
