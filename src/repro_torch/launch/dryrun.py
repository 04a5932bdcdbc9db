"""Dry-run of every (architecture x input-shape) cell on the production
meshes, on the host: the JAX package's ``launch/dryrun.py`` under its
arguments and record keys, counting instead of compiling.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out out.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
      --shape train_4k --override shard_policy=dp --tag dp_only --breakdown
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-7b \
      --shape train_4k --mesh both --by-layers --jobs 3

``--tag`` writes the tag and the overrides into each record; ``--breakdown``
prints each cell's collectives as the step issued them (``launch/perf_probe``
is this with JAX's perf-probe defaults).

JAX lowers and compiles each cell's HLO and reads XLA's cost and memory
analyses. The port runs the cell's real step builder
(``repro_torch.distributed.steps``) once, on fake tensors (no storage, no
device), as rank 0 of a fake process group at the mesh's world size (256
for 16 x 16, 512 for 2 x 16 x 16), and counts what it runs:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``, one rank's. It
  counts the products only (mm, bmm, einsum, sdpa), not elementwise work,
  reductions or softmax.
- ``collective_bytes`` and ``collectives``: every collective the step
  issues (``analysis.collectives.CollectiveRecorder``), an all-reduce
  counted twice, and the bytes by op; ``cache_collectives``, a serve
  step's: the bytes by op of each cache leaf it moves ({"cache.<stack>.<leaf>":
  {op: bytes}}; a KV leaf split by sequence and an SSM state split by heads
  are never moved, so only the conv state's per-layer gathers, and leaves
  placed otherwise, appear);
  ``seq_collectives``, a train or prefill step's under its sequence split:
  the bytes by op of each "seq.<part>" label (``tensor_parallel``: "seq.in"
  a split part's input gathered and its gradient reduce-scattered,
  "seq.out" its output columns to rows and back, "seq.gather" /
  "seq.keep" a replicated part's input gathered and its output rows'
  gradients gathered, "seq.embed", "seq.head", "seq.pick");
  ``ssm_collectives``, the Mamba2 mixer's under a split of its heads
  ("ssm.norm": the rank's columns of ``y * silu(z)`` gathered for the norm,
  the gradient reduce-scattered); ``moe_collectives``, the MoE FFN's
  ("moe.in" its input gathered and its gradient summed where a rank runs
  its experts, "moe.out" the experts' shares summed, "moe.counts" the
  batch ranks' expert counts where a rank's rows do not hold whole
  dispatch groups, or under the sort dispatch).
- ``layer_input_bytes``: the bytes of every layer's input as
  ``hidden_states`` passes it (``model.layer_input_meter``): what
  ``remat="full"`` saves for the recompute, the rank's (b, S / n, d) rows
  under a sequence split; counted in ``peak`` as they live.
- ``memory``: the bytes rank 0 holds live, its inputs' local blocks
  included, at the most (``peak_bytes_per_device``), in JAX's keys
  (``roofline.memory_record``); ``gathered_leaf_bytes``: the bytes of the
  leaves it gathers a layer at a time (every gather's result).
- ``bytes_accessed``: computed, unfused: each op's tensor inputs plus its
  outputs, views, allocations and collectives excluded. A fused kernel
  reads and writes less, so the memory term reads the bytes the step must
  move instead (``roofline.bytes_moved``: inputs + outputs - in-place
  outputs + gathered leaves) and these stand beside it as
  ``t_memory_unfused``.
- ``model_flops``, ``useful_ratio`` and the roofline terms, as JAX has them.

What the count is of:

- The plain path. Fake tensors are CPU tensors, since ``kernels/ops.py``
  sends CUDA tensors to the compiled kernels, which cannot take a fake
  tensor; so attention runs ``kernels.ref``'s blocked path. The card's
  flash kernels never hold the blocked path's score blocks, so the peak
  over-counts attention's working set. No number is computed and no tensor
  reaches a device.
- Data-dependent sizes take their bound. The KV write plan's ``nonzero``
  (``models/attention.py``, every decode step) gets an unbacked size under
  ``FakeTensorMode(shape_env=ShapeEnv())``, counted at its upper bound,
  every write kept (B * c); the record lists such ops in ``bounded_ops``.
- Rank 0 only; its rows come from the steps' ``_Rows``, its share of the
  products over "model" from the steps' ``tensor_parallel.Plan``, which
  gathers the leaves a layer at a time: a rank's peak holds its blocks of
  the tree and one layer's gathered leaves.
- Every Python loop (layers, chunks, microbatches, the loss, the SSD scan)
  runs in full, so one eager pass counts everything and there is no
  ``--no-cost-pass``. ``--by-layers`` (``count_by_layers``) instead counts
  three depths of the uniform or hybrid plan and extrapolates, exactly,
  for a cell whose eager count outlasts its host time (zamba2-7b's
  train_4k: over an hour at 81 layers); ``--jobs 3`` counts the depths
  side by side. Such a record gives its peak only where the depths' peaks
  grow linearly.

"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import collectives, roofline
from repro_torch.configs import registry
from repro_torch.configs.base import ColaConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import steps
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.utils import canonical_dtype


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks with this process as
    rank 0: collectives return at once and move nothing. Destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already started; the dry-run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ops that move no bytes of their own (allocations, waits)
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided",
               "_c10d_functional::wait_tensor"}


def _tensors(xs):
    """The tensors among an op's arguments or results (tensors and lists or
    tuples of them: an aten op nests no deeper)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (y for y in x if isinstance(y, torch.Tensor))


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


class StepCounter(TorchDispatchMode):
    """Counts, for every op run under it, the bytes of its tensor inputs and
    outputs (``bytes_accessed``; views, allocations, collectives and
    metadata queries move none), and the bytes of the storages live at
    once (``peak``), from ``hold``'s tensors (the inputs) on. A
    data-dependent size counts at its bound; the ops that gave one are kept
    in ``bounded_ops``."""

    def __init__(self, hold=()):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.bounded_ops: set[str] = set()
        self._storages: dict[int, int] = {}
        self.argument = self._hold(hold)
        self.peak = self.live

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def _hold(self, tensors) -> int:
        """Track the storages of ``tensors`` while they live; the bytes of
        those not tracked before."""
        new = 0
        for t in tensors:
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = collectives.size_bound(st.nbytes())
            self._storages[key] = n
            weakref.finalize(st, self._free, key)
            self.live += n
            new += n
        return new

    def storage_bytes(self, tensors) -> int:
        """Bytes of the distinct tracked storages that ``tensors`` hold."""
        keys = {id(_local(t).untyped_storage()) for t in tensors}
        return sum(self._storages.get(k, 0) for k in keys)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors((out,)))
        if any(isinstance(d, torch.SymInt) for t in outs for d in t.shape):
            self.bounded_ops.add(str(func))
        # no tensor out: a metadata query (``prim.device``, sizes)
        if outs and not (func.is_view or collectives.collective_name(func)
                         or func.overloadpacket._qualified_op_name
                         in _NO_TRAFFIC):
            ins = list(_tensors(args)) + list(_tensors(kwargs.values()))
            self.bytes_accessed += sum(
                collectives.size_bound(_local(t).numel()) * t.element_size()
                for t in ins + outs)
        self._hold(outs)
        self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------------------
# one step, counted
# ---------------------------------------------------------------------------

def _fake(leaf) -> torch.Tensor:
    """A fake CPU tensor of a meta tensor's or a (shape, dtype) pair's shape
    and dtype (under the active FakeTensorMode)."""
    if isinstance(leaf, torch.Tensor):
        shape, dtype = leaf.shape, leaf.dtype
    else:
        shape, dtype = leaf
    return torch.empty(tuple(shape), dtype=canonical_dtype(dtype), device="cpu")


def _leaves(tree) -> list:
    out: list = []
    sh._map(lambda _, x: out.append(x), tree)
    return out


def _placed(mesh, specs_tree, shardings) -> dict:
    """Fake tensors of ``specs_tree``'s leaves placed at ``shardings``."""
    return sh.map_with_specs(lambda leaf, s: sh.place(mesh, _fake(leaf), s),
                             specs_tree, shardings)


def count_step(cfg, cc: ColaConfig, kind: str, batch: int, seq: int,
               mesh) -> dict:
    """Run the step builder of ``kind`` ("train" in ``cc.mode``, "prefill",
    "decode" against a cache of ``seq`` positions) once on ``mesh`` (of a
    started process group, real or fake) on fake tensors of ``batch`` x
    ``seq``, and count it. The step is the one JAX's ``_compile_cell``
    picks; the inputs are placed as its ``in_shardings`` place them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    t0 = time.perf_counter()
    with FakeTensorMode(shape_env=ShapeEnv()):
        shaped = steps.shaped_params(cfg)
        P = _placed(mesh, shaped, sh.params_shardings(
            mesh, shaped, policy=cfg.shard_policy))
        if kind == "train":
            specs = registry.batch_specs(cfg, batch, seq)
            X = _placed(mesh, specs, sh.batch_shardings(
                mesh, specs, policy=cfg.shard_policy))
            fn, (_, ash) = steps.make_train_step(cfg, cc, mesh)
            if cc.mode == "ft":
                inputs = (P, X)
            else:
                inputs = (P, _placed(mesh, steps.shaped_adapters(cfg, cc),
                                     ash), X)
        elif kind == "prefill":
            # a prefill takes its tokens (or embeddings) and no labels
            specs = {k: v for k, v in registry.batch_specs(cfg, batch,
                                                           seq).items()
                     if k != "labels"}
            fn, _ = steps.make_prefill_step(cfg, mesh)
            inputs = (P, _placed(mesh, specs,
                                 sh.batch_shardings(mesh, specs)))
        else:
            fn, _ = steps.make_serve_step(cfg, mesh)
            cache_sh, tok_sh = steps.serve_shardings(cfg, mesh, batch, seq)
            inputs = (P, _placed(mesh, model_lib.cache_specs(cfg, batch, seq),
                                 cache_sh),
                      _placed(mesh, registry.decode_token_specs(cfg, batch),
                              tok_sh))
        held = _leaves(inputs)
        counter = StepCounter(held)
        recorder = collectives.CollectiveRecorder()
        flops = FlopCounterMode(display=False)
        with (flops, recorder, counter, tp.gather_meter() as gathered,
              model_lib.layer_input_meter() as saved):
            out = fn(*inputs)
        outs = _leaves(out)
        output = counter.storage_bytes(outs)
        inputs_at = {id(_local(h).untyped_storage()) for h in held}
        alias = counter.storage_bytes(
            [t for t in outs if id(_local(t).untyped_storage()) in inputs_at])
        memory = roofline.memory_record(counter.argument, output, alias,
                                        counter.peak)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(counter.bytes_accessed),
            "collective_bytes": collectives.total_bytes(recorder.records),
            "collective_records": recorder.records,
            "memory": memory,
            "gathered_leaf_bytes": gathered.bytes,
            "layer_input_bytes": saved.bytes,
            "bounded_ops": sorted(counter.bounded_ops),
            "count_s": time.perf_counter() - t0}


def layer_points(cfg) -> tuple[tuple[int, int, int], int]:
    """The three depths ``count_by_layers`` counts and the number of periods
    it extrapolates to. A period is one layer of the uniform plan, and
    ``shared_attn_every`` layers of the hybrid plan (its shared block runs
    once a period, and once more before a tail of fewer layers); the depths
    are 2, 3 and 4 periods with ``cfg.n_layers``' tail (81 = 13 x 6 + 3:
    15, 21 and 27 layers, and 13 periods)."""
    plan = model_lib.layer_plan(cfg)[0]
    if plan == "uniform":
        every = 1
    elif plan == "hybrid":
        every = cfg.shared_attn_every
    else:
        raise ValueError(f"{cfg.name}: layer extrapolation takes the uniform "
                         f"and hybrid plans only")
    k, tail = divmod(cfg.n_layers, every)
    return tuple(j * every + tail for j in (2, 3, 4)), k


_MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes")
_COUNT_KEYS = ("flops", "bytes_accessed", "collective_bytes",
               "gathered_leaf_bytes", "layer_input_bytes")


def _numbers(count: dict) -> dict:
    """``count_step``'s counts that grow with the depth, as integers: its
    ``_COUNT_KEYS``, its memory's bytes and peak, and its collectives' bytes
    by op and by label and op."""
    out = {k: round(count[k]) for k in _COUNT_KEYS}
    out.update({("memory", k): count["memory"][k]
                for k in _MEMORY_KEYS + ("peak_bytes_per_device",)})
    recs = count["collective_records"]
    out.update({("op", op): round(b)
                for op, b in collectives.bytes_by_op(recs).items()})
    out.update({("of", label, op): round(b)
                for label, ops in collectives.by_leaf(recs).items()
                for op, b in ops.items()})
    out["bounded_ops"] = count["bounded_ops"]
    out["count_s"] = count["count_s"]
    return out


def _point(cfg, cc, kind, batch, seq, mesh_shape, n) -> dict:
    """``_numbers`` of one depth, counted in a fake group of its own (a
    worker process's)."""
    world = 1
    for v in mesh_shape.values():
        world *= v
    with fake_world(world):
        mesh = make_mesh(mesh_shape["data"], mesh_shape["model"],
                         mesh_shape.get("pod", 1), device_type="cpu")
        return _numbers(count_step(cfg.replace(n_layers=n), cc, kind, batch,
                                   seq, mesh))


def count_by_layers(cfg, cc: ColaConfig, kind: str, batch: int, seq: int,
                    mesh, jobs: int = 1) -> dict:
    """``count_step``'s counts of ``cfg`` at its depth from counts at three
    depths (``layer_points``: 2, 3 and 4 layers of the uniform plan, or
    periods of the hybrid plan with the depth's tail), through the
    quadratic on those three points: exact, since every period runs the
    same ops and the embedding, head, loss and tail run once. FLOPs,
    collectives, inputs and outputs grow linearly in the periods; the bytes
    accessed also carry a quadratic term (each layer's backward through its
    view of a tap's stacked (L, ...) delta or adapter leaf fills and adds a
    gradient of the whole stack). One period is not a point: a stacked leaf
    of one layer may be placed otherwise. JAX's dry-run extrapolates from
    two depths for the same reason of time.

    Returns the flops, bytes_accessed, collective_bytes,
    gathered_leaf_bytes and layer_input_bytes; ``memory``, the inputs',
    outputs' and in-place outputs' bytes in ``memory_record``'s keys;
    ``collectives``, the bytes by op, and ``labelled``, by label and op
    (``collectives.by_leaf``); ``peak``, the peak where the three points'
    peaks grow linearly (the checkpointed layer inputs, one a layer), else
    None; the ``depths`` counted, their ``bounded_ops`` and ``count_s``.
    ``jobs`` > 1 counts the depths side by side, each in a spawned process
    with a fake group of its own (``mesh``'s shape)."""
    depths, k = layer_points(cfg)
    if jobs > 1:
        import concurrent.futures
        import multiprocessing

        shape = sh.mesh_shape(mesh)
        with concurrent.futures.ProcessPoolExecutor(
                min(jobs, 3), mp_context=multiprocessing.get_context(
                    "spawn")) as ex:
            pts = list(ex.map(_point, *zip(*[
                (cfg, cc, kind, batch, seq, shape, n) for n in depths])))
    else:
        pts = [_numbers(count_step(cfg.replace(n_layers=n), cc, kind, batch,
                                   seq, mesh)) for n in depths]
    f2, f3, f4 = pts
    keys = (set(f2) | set(f3) | set(f4)) - {"bounded_ops", "count_s"}
    # Lagrange on 2, 3, 4 in integers (each product of two consecutive
    # integers is even)
    at = {key: (f2.get(key, 0) * (k - 3) * (k - 4) // 2
                - f3.get(key, 0) * (k - 2) * (k - 4)
                + f4.get(key, 0) * (k - 2) * (k - 3) // 2)
          for key in keys}
    peak = ("memory", "peak_bytes_per_device")
    linear = f3[peak] - f2[peak] == f4[peak] - f3[peak]
    keyed = sorted(key for key in keys if isinstance(key, tuple))
    labelled: dict = {}
    for key in keyed:
        if key[0] == "of":
            labelled.setdefault(key[1], {})[key[2]] = float(at[key])
    return {**{key: at[key] for key in _COUNT_KEYS},
            "memory": {key: at[("memory", key)] for key in _MEMORY_KEYS},
            "collectives": {key[1]: float(at[key]) for key in keyed
                            if key[0] == "op"},
            "labelled": labelled,
            "peak": at[peak] if linear else None,
            "depths": depths,
            "bounded_ops": sorted(set().union(*(p["bounded_ops"]
                                                for p in pts))),
            "count_s": sum(p["count_s"] for p in pts)}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               cola_mode: str = "fused_fit", overrides: dict | None = None,
               verbose: bool = True, by_layers: bool = False,
               jobs: int = 1) -> dict:
    """Count one (arch, shape) cell on a fake production mesh; return the
    §Dry-run / §Roofline record (``collective_records`` holds every
    collective as issued). ``by_layers``: extrapolate from three depths
    (``count_by_layers``, ``jobs`` of them side by side): the record then
    holds no ``collective_records``, its ``by_layers`` the depths counted,
    and its peak only where the depths' peaks grow linearly (else None)."""
    cfg = registry.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    spec = registry.SHAPES[shape_name]
    cc = ColaConfig(mode=cola_mode, family="lowrank", taps="qv", rank=16)
    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        count = (count_by_layers if by_layers else count_step)(
            cfg, cc, spec.kind, spec.batch, spec.seq, mesh,
            **({"jobs": jobs} if by_layers else {}))
    if by_layers:
        labelled = count["labelled"]
        mem = dict(count["memory"])
        peak = count["peak"]
        mem.update(roofline.memory_record(
            mem["argument_size_in_bytes"], mem["output_size_in_bytes"],
            mem["alias_size_in_bytes"], peak) if peak is not None
            else {"temp_size_in_bytes": None, "peak_bytes_per_device": None})
        count = dict(count, memory=mem, collective_records=[])
        by_op = count["collectives"]
    else:
        labelled = collectives.by_leaf(count["collective_records"])
        by_op = collectives.bytes_by_op(count["collective_records"])
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "mode": cola_mode,
        "kind": spec.kind,
        "count_s": round(count["count_s"], 1),
        "memory": count["memory"],
        "gathered_leaf_bytes": count["gathered_leaf_bytes"],
        "flops": count["flops"],
        "flops_counted": "products only (mm, bmm, einsum, sdpa)",
        "bytes_accessed": count["bytes_accessed"],
        "bytes_accessed_counted": "computed, unfused: each op's inputs plus "
                                  "outputs on the plain path",
        "collective_bytes": count["collective_bytes"],
        "collectives": by_op,
        "cache_collectives": {k: v for k, v in labelled.items()
                              if k.startswith("cache.")},
        "seq_collectives": {k: v for k, v in labelled.items()
                            if k.startswith("seq.")},
        "ssm_collectives": {k: v for k, v in labelled.items()
                            if k.startswith("ssm.")},
        "moe_collectives": {k: v for k, v in labelled.items()
                            if k.startswith("moe.")},
        "layer_input_bytes": count["layer_input_bytes"],
        "collective_records": count["collective_records"],
        "bounded_ops": count["bounded_ops"],
        "devices": world,
        "exact_costs": True,
    }
    if by_layers:
        rec["by_layers"] = list(count["depths"])
    rec.update(roofline.roofline_terms(rec))
    rec["model_flops"] = roofline.model_flops(cfg, spec)
    # flops are one rank's; model_flops is the whole step's
    rec["useful_ratio"] = (rec["model_flops"] / (rec["flops"] * rec["devices"])
                           if rec["flops"] else 0.0)
    if verbose:
        moved = roofline.bytes_moved(rec["memory"], rec["gathered_leaf_bytes"])
        print(f"[dryrun] {arch} x {shape_name} ({rec['mesh']}, {cola_mode}) "
              f"counted in {rec['count_s']}s"
              + (f" (by layers: depths {rec['by_layers']})" if by_layers
                 else ""))
        print("  memory:", json.dumps(rec["memory"]))
        print(f"  flops={rec['flops']:.3e} "
              f"moved={moved:.3e} "
              f"unfused={rec['bytes_accessed']:.3e} "
              f"collective={rec['collective_bytes']:.3e} "
              f"{json.dumps(rec['collectives'])}")
        if rec["seq_collectives"]:
            print(f"  sequence split: layer inputs "
                  f"{rec['layer_input_bytes']:.3e} B, collectives "
                  f"{json.dumps(rec['seq_collectives'])}")
        for key in ("cache_collectives", "ssm_collectives",
                    "moe_collectives"):
            if rec[key]:
                print(f"  {key}: {json.dumps(rec[key])}")
        print(f"  terms(s): compute={rec['t_compute']:.4e} "
              f"memory={rec['t_memory']:.4e} collective={rec['t_collective']:.4e}"
              f" (unfused {rec['t_memory_unfused']:.4e}, NIC "
              f"{rec['t_collective_nic']:.4e})"
              f" -> bottleneck={rec['bottleneck']}")
    return rec


def parse_overrides(text: str | None) -> dict:
    """``k=v,k=v`` model-config overrides: ints, floats, else strings."""
    overrides = {}
    if text:
        for kv in text.split(","):
            k, v = kv.split("=")
            try:
                overrides[k] = int(v)
            except ValueError:
                try:
                    overrides[k] = float(v)
                except ValueError:
                    overrides[k] = v
    return overrides


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    p.add_argument("--mode", default="fused_fit",
                   choices=["fused_fit", "faithful_offload", "ft", "frozen"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default=None, help="append JSON records to file")
    p.add_argument("--override", default=None,
                   help="comma k=v model-config overrides (ints/floats/strs)")
    p.add_argument("--skip-done", action="store_true",
                   help="skip cells already present in --out")
    p.add_argument("--tag", default=None,
                   help="write this tag and the overrides into each record")
    p.add_argument("--breakdown", action="store_true",
                   help="print each cell's collectives as the step issued "
                        "them, one rank's")
    p.add_argument("--by-layers", action="store_true",
                   help="extrapolate each cell from three depths "
                        "(count_by_layers: the uniform and hybrid plans)")
    p.add_argument("--jobs", type=int, default=1,
                   help="with --by-layers, count the depths side by side in "
                        "this many processes (at most 3)")
    args = p.parse_args(argv)
    # DTensor warns at every leaf gathered from a strided placement (two
    # all-gathers where one would do); the records count both
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    overrides = parse_overrides(args.override)
    cells: list[tuple[str, str]]
    if args.all:
        cells = registry.all_cells()
    else:
        if not (args.arch and args.shape):
            p.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    done = set()
    if args.skip_done and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass
    records, failures = [], []
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            if (arch, shape, "pod2x16x16" if mp else "pod16x16") in done:
                continue
            try:
                rec = lower_cell(arch, shape, multi_pod=mp, cola_mode=args.mode,
                                 overrides=overrides or None,
                                 by_layers=args.by_layers, jobs=args.jobs)
                if args.tag is not None:
                    rec.update(tag=args.tag, overrides=overrides)
                if args.breakdown:
                    print("[collective breakdown — every collective as the "
                          "step issued it, one rank's]")
                    collectives.print_breakdown(rec["collective_records"],
                                                report=print)
                records.append(rec)
                if args.out:   # flush per cell (crash-safe)
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
            except Exception as e:  # noqa: BLE001 — report every cell
                traceback.print_exc()
                failures.append({"arch": arch, "shape": shape,
                                 "multi_pod": mp, "error": repr(e)})
    if args.out and failures:
        with open(args.out + ".failures", "a") as f:
            for r in failures:
                f.write(json.dumps(r) + "\n")
    print(f"\n[dryrun] {len(records)} cells OK, {len(failures)} failed in "
          f"{time.perf_counter() - t0:.1f} s of host time")
    for f_ in failures:
        print("  FAILED:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
