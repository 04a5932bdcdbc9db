"""Runs the port's distributed step builders in a spawned gloo process
group on the CPU, for ``tests/test_torch_distributed.py``; imports no JAX.

    python tests/torch_dist_worker.py IN.pkl OUT.pkl WORLD

IN.pkl holds {"weights": {key: {"params", "adapters"}}, "cases": [...]}
with numpy leaves; each case names its config (a reduced config and its
overrides), its mesh (data, model, pods), its step ("train" with a ColA
mode, "prefill", "serve") and its inputs. Every rank places the weights
with ``sharding.distribute`` and the batch at ``batch_shardings``, runs the
step and checks that its local block of every placed leaf (weights and
outputs) is its slice under the rule (and, once a mesh, ``constrain``); rank 0 writes each case's outputs,
gathered whole, and every rank's failed checks to OUT.pkl. Each step runs under
``FlopCounterMode`` and the dry-run's ``CollectiveRecorder``: rank 0's
FLOPs, collective breakdown, sequence-split and MoE collectives by label,
the shapes of the layer inputs it saw and of the expert leaves it gathered
go with its outputs (``"count"``). A "ce"
case holds whole logits and labels instead of a step: each rank runs
``model._ce`` on its vocab columns under the step's plan, whole and in
chunks, against ``_ce`` on the whole logits (value, count, and the
gradient's block), and rank 0 writes the largest gaps.

A "ticks" case makes a cache with the prefill step and runs the greedy
serve step on it for a few ticks, each token fed back: the tokens, the
cache after the last tick, whether each rank's cache blocks kept their
storage, the cache leaves' moves and the SSD head counts. A serve case
also records, leaf by leaf, whether each rank's new cache block is the
input's own storage; every step records the head counts its SSD calls see.

A "tp_serve" case runs the serve step twice on one cache (greedy tokens,
then logits), the cache placed at ``serve_shardings`` or, with "prefill",
made by the prefill step from those tokens at ``prefill_out_shardings``; it
records, leaf by leaf, whether each rank's new cache block is the input's
own storage (updated in place, no move), and the collectives labelled with
a cache leaf. An "argmax" case holds whole logits: each rank takes
``vocab_argmax`` of its vocab columns under the step's plan, against
``torch.argmax`` of the whole rows.
"""
from __future__ import annotations

import logging
import os
import pickle
import socket
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.analysis import collectives  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ColaConfig  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402


def _config(case):
    return registry.reduced_config(case["config"]).replace(**case["overrides"])


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, sh.Spec):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _flat(tree) -> dict:
    return dict(_leaves(tree))


def _check(mesh, placed, specs, whole, what, bad):
    """Each placed leaf's local block equals its slice under its spec, and
    gathers back to ``whole`` (when given)."""
    sp = _flat(specs)
    wh = _flat(whole) if whole is not None else None
    for path, d in _leaves(placed):
        full = d.full_tensor()
        if wh is not None and not torch.equal(full, wh[path]):
            bad.append(f"{what} {path}: gathers to another tensor")
        want = sh.local_slice(mesh, full, sp[path])
        if not torch.equal(d.to_local(), want):
            bad.append(f"{what} {path} spec {sp[path]}: local block "
                       f"{tuple(d.to_local().shape)} is not its slice")


def _whole(tree):
    out = {}
    for path, d in _leaves(tree):
        out[path] = d.full_tensor().numpy()
    return out


def _constrain(mesh, what, bad):
    """``constrain`` redistributes a DTensor to the rule's placements inside
    ``activation_rules`` and leaves it (and any plain tensor) alone
    outside."""
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    d = sh.place(mesh, x, sh.Spec((None, None)))
    if sh.constrain(d, "batch", "model") is not d:
        bad.append(f"{what}: constrain moved a DTensor outside the rules")
    with sh.activation_rules(mesh) as r:
        y = sh.constrain(d, "batch", "model")
        if sh.constrain(x, "batch", "model") is not x:
            bad.append(f"{what}: constrain moved a plain tensor")
    spec = sh.Spec((r.batch_axes if len(r.batch_axes) > 1
                    else r.batch_axes[0], "model"))
    if tuple(y.placements) != sh.placements(mesh, spec):
        bad.append(f"{what}: constrain gave {y.placements}")
    if not torch.equal(y.full_tensor(), x) or not torch.equal(
            y.to_local(), sh.local_slice(mesh, x, spec)):
        bad.append(f"{what}: constrain changed the values or the blocks")


class _SsdHeads:
    """While active, the head counts of every SSD scan and recurrence step
    this rank runs (``kernels.ops.ssd`` / ``ssd_decode_step``, which the
    Mamba2 mixer calls through the module)."""

    def __init__(self):
        self.heads: set[int] = set()

    def __enter__(self) -> "_SsdHeads":
        from repro_torch.kernels import ops

        self._ops, self._saved = ops, (ops.ssd, ops.ssd_decode_step)
        ssd, step = self._saved

        def ssd_seen(x, *a, **k):
            self.heads.add(x.shape[2])
            return ssd(x, *a, **k)

        def step_seen(x, *a, **k):
            self.heads.add(x.shape[1])
            return step(x, *a, **k)

        ops.ssd, ops.ssd_decode_step = ssd_seen, step_seen
        return self

    def __exit__(self, *exc) -> None:
        self._ops.ssd, self._ops.ssd_decode_step = self._saved


def _counted(fn, *args):
    """fn(*args), and its FLOPs, collective breakdown, moves of cache
    leaves and the sequence split's and the MoE FFN's collectives by label
    (``collectives.by_leaf``), layer inputs' shapes
    (``model.layer_input_meter``: what remat saves), SSD head counts and
    the shapes the expert leaves were gathered to
    (``tensor_parallel.gather_meter``) on this rank."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import model

    flops, rec = FlopCounterMode(display=False), collectives.CollectiveRecorder()
    with flops, rec, model.layer_input_meter() as saved, _SsdHeads() as ssd, \
            tp.gather_meter() as leaves:
        out = fn(*args)
    return out, {"flops": flops.get_total_flops(),
                 "breakdown": collectives.breakdown(rec.records, top=None),
                 "cache_moves": collectives.by_leaf(rec.records, "cache."),
                 "seq_moves": collectives.by_leaf(rec.records, "seq."),
                 "moe_moves": collectives.by_leaf(rec.records, "moe."),
                 "layer_inputs": sorted(set(saved.shapes)),
                 "ssd_heads": sorted(ssd.heads),
                 "experts": {p: sorted(v) for p, v in leaves.shapes.items()
                             if ".moe." in f".{p}"}}


def _storages(tree) -> dict:
    return {".".join(p): d.to_local().untyped_storage().data_ptr()
            for p, d in _leaves(tree)}


def _ticks(cfg, mesh, case, params, what, bad):
    """A prefill step's cache (at ``prefill_out_shardings``) fed to the
    greedy serve step, then ``case["ticks"]`` ticks, each token fed back:
    each tick's tokens, the cache after the last, whether every rank's
    cache blocks kept their storage through every tick, and the cache
    leaves' moves of every tick."""
    pre, ps = steps.make_prefill_step(cfg, mesh)
    P = sh.distribute(mesh, params, ps)
    toks = {"tokens": torch.from_numpy(np.array(case["prefill"]))}
    _, cache = pre(P, sh.distribute(mesh, toks, sh.batch_shardings(
        mesh, toks, policy=cfg.shard_policy)))
    B, S = case["prefill"].shape
    cspec, tspec = steps.serve_shardings(cfg, mesh, B, S)
    _check(mesh, cache, cspec, None, f"{what} prefill cache", bad)
    fn, _ = steps.make_serve_step(cfg, mesh)
    before = _storages(cache)
    tok = torch.from_numpy(np.array(case["prefill"][:, -1:]))
    tokens, moves, heads = [], {}, set()
    for t in range(case["ticks"]):
        batch = {"tokens": tok,
                 "positions": torch.full((B,), S + t, dtype=torch.int32)}
        (out, cache), count = _counted(fn, P, cache, sh.distribute(
            mesh, batch, sh.batch_shardings(mesh, batch,
                                            policy=cfg.shard_policy)))
        for k, ops in count["cache_moves"].items():
            for op, b in ops.items():
                moves.setdefault(k, {}).setdefault(op, 0.0)
                moves[k][op] += b
        heads |= set(count["ssd_heads"])
        tok = out.full_tensor()
        tokens.append(tok.numpy())
    _check(mesh, cache, cspec, None, f"{what} cache out", bad)
    after = _storages(cache)
    return {"tokens": np.stack(tokens), "out": _whole({"cache": cache}),
            "in_place": {k: after[k] == before[k] for k in before},
            "cache_moves": moves, "ssd_heads": sorted(heads)}


def _ce_sum(logits, labels, chunk):
    """``model._ce``'s sum and count over the sequence, in chunks of
    ``chunk`` positions (0: whole), as ``lm_loss_sum`` takes them."""
    from repro_torch.models import model

    if not chunk:
        return model._ce(logits, labels)
    tot = cnt = 0.0
    for i in range(0, logits.shape[1], chunk):
        s, n = model._ce(logits[:, i:i + chunk], labels[:, i:i + chunk])
        tot, cnt = tot + s, cnt + n
    return tot, cnt


def _vocab_ce(cfg, mesh, case, bad):
    """The vocab-parallel CE against ``_ce`` on the whole logits."""
    from repro_torch.distributed import tensor_parallel as tp

    ps = sh.params_shardings(mesh, steps.shaped_params(cfg))
    plan = tp.Plan(cfg, mesh, cfg.shard_policy, param_specs=ps)
    if plan.head is None:
        bad.append(f"{case['name']}: the plan splits no vocab")
        return {}
    lo, size = plan.head
    logits = torch.from_numpy(case["logits"])
    labels = torch.from_numpy(case["labels"])
    out = {}
    for chunk in (0, 4):
        whole = logits.clone().requires_grad_()
        s, n = _ce_sum(whole, labels, chunk)
        s.backward()
        mine = logits[..., lo:lo + size].clone().requires_grad_()
        with sh.activation_rules(mesh, cfg.shard_policy, plan=plan):
            s_l, n_l = _ce_sum(mine, labels, chunk)
        s_l.backward()
        want = whole.grad[..., lo:lo + size]
        out[chunk] = {"sum": float(s_l), "want_sum": float(s),
                      "count": float(n_l), "want_count": float(n),
                      "grad_gap": float((mine.grad - want).abs().max()),
                      "grad_scale": float(want.abs().max())}
        if (abs(float(s_l) - float(s)) > 1e-6 * abs(float(s))
                or float(n_l) != float(n)
                or out[chunk]["grad_gap"] > 1e-6 * out[chunk]["grad_scale"]):
            bad.append(f"{case['name']} chunk {chunk}: {out[chunk]}")
    return out


def _vocab_argmax(cfg, mesh, case, bad):
    """``vocab_argmax`` on this rank's vocab columns against the whole
    rows' ``torch.argmax``."""
    from repro_torch.distributed import tensor_parallel as tp

    ps = sh.params_shardings(mesh, steps.shaped_params(cfg))
    plan = tp.Plan(cfg, mesh, cfg.shard_policy, param_specs=ps)
    lo, size = plan.head
    logits = torch.from_numpy(case["logits"])
    got = tp.vocab_argmax(plan, logits[..., lo:lo + size].contiguous())
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    if not torch.equal(got, want):
        bad.append(f"{case['name']}: {got.tolist()} != {want.tolist()}")
    return {"tokens": got.numpy()}


def _copy_cache(mesh, cache, specs):
    """A copy of a placed cache: every rank's block cloned, same specs."""
    return sh.map_with_specs(
        lambda d, s: sh.wrap(mesh, d.to_local().clone(), s, d.shape),
        cache, specs)


def _tp_serve(cfg, mesh, case, params, pbatch, what, bad):
    """The serve step's greedy tokens and logits on one cache (see the
    module docstring)."""
    B = case["batch"]["positions"].shape[0]
    max_len = case["max_len"]
    cspec, _ = steps.serve_shardings(cfg, mesh, B, max_len)
    if case.get("prefill") is not None:
        pre, ps = steps.make_prefill_step(cfg, mesh)
        P = sh.distribute(mesh, params, ps)
        toks = {"tokens": torch.from_numpy(np.array(case["prefill"]))}
        _, C = pre(P, sh.distribute(mesh, toks, sh.batch_shardings(
            mesh, toks, policy=cfg.shard_policy)))
    else:
        _, ps = steps.make_serve_step(cfg, mesh)
        P = sh.distribute(mesh, params, ps)
        C = sh.distribute(mesh, _tensors(case["cache"]), cspec)
    _check(mesh, C, cspec, None, f"{what} cache in", bad)
    res, kept = {}, {}
    for greedy in (True, False):
        fn, _ = steps.make_serve_step(cfg, mesh, greedy=greedy)
        cin = _copy_cache(mesh, C, cspec) if greedy else C
        before = {p: d.to_local().untyped_storage().data_ptr()
                  for p, d in _leaves(cin)}
        (out, new), count = _counted(fn, P, cin, pbatch)
        ospec = sh.batch_shardings(mesh, {"out": out},
                                   policy=cfg.shard_policy)
        _check(mesh, {"out": out, "cache": new},
               {"out": ospec["out"], "cache": cspec}, None,
               f"{what} out", bad)
        for p, d in _leaves(new):
            same = d.to_local().untyped_storage().data_ptr() == before[p]
            kept[".".join(p)] = kept.get(".".join(p), True) and same
        res["tokens" if greedy else "logits"] = out
        res["cache"] = new
        if greedy:
            res["count"] = count
    return {"out": _whole({k: res[k] for k in ("tokens", "logits", "cache")}),
            "count": res["count"], "in_place": kept}


def _run_case(case, weights, meshes, bad):
    cfg = _config(case)
    key = tuple(case["mesh"])
    if key not in meshes:
        data, model, pods = key
        meshes[key] = make_mesh(data, model, pods, device_type="cpu")
        _constrain(meshes[key], f"constrain on {key}", bad)
    mesh = meshes[key]
    if case["step"] == "ce":
        return _vocab_ce(cfg, mesh, case, bad)
    if case["step"] == "argmax":
        return _vocab_argmax(cfg, mesh, case, bad)
    w = weights[case["weights"]]
    params = convert.params_from_numpy(cfg, w["params"], device="cpu")
    what = f"{case['name']} on {key}"
    if case["step"] == "ticks":
        return _ticks(cfg, mesh, case, params, what, bad)
    batch = _tensors(case["batch"])
    bspec = sh.batch_shardings(mesh, batch, policy=cfg.shard_policy)
    pbatch = sh.distribute(mesh, batch, bspec)
    _check(mesh, pbatch, bspec, batch, f"{what} batch", bad)
    if case["step"] == "tp_serve":
        return _tp_serve(cfg, mesh, case, params, pbatch, what, bad)
    if case["step"] == "train":
        cc = ColaConfig(mode=case["mode"], family="lowrank", taps="qv",
                        rank=4)
        fn, (ps, ash) = steps.make_train_step(cfg, cc, mesh)
        P = sh.distribute(mesh, params, ps)
        _check(mesh, P, ps, params, f"{what} params", bad)
        if cc.mode == "ft":
            (loss, out), count = _counted(fn, P, pbatch)
            _check(mesh, out, ps, None, f"{what} grads", bad)
        else:
            adapters = convert.adapters_from_numpy(w["adapters"],
                                                   device="cpu")
            A = sh.distribute(mesh, adapters, ash)
            _check(mesh, A, ash, adapters, f"{what} adapters", bad)
            (loss, out), count = _counted(fn, P, A, pbatch)
            if cc.mode == "faithful_offload":
                specs = sh.delta_shardings(mesh, out)
            else:
                specs = ash
            _check(mesh, out, specs, None, f"{what} outputs", bad)
        return {"loss": float(loss), "out": _whole(out), "count": count}
    if case["step"] == "prefill":
        fn, ps = steps.make_prefill_step(cfg, mesh)
        P = sh.distribute(mesh, params, ps)
        (logits, cache), count = _counted(fn, P, pbatch)
        B, S = batch["tokens"].shape[:2]
        lspec, cspec = steps.prefill_out_shardings(cfg, mesh, B, S)
        _check(mesh, {"logits": logits, "cache": cache},
               {"logits": lspec, "cache": cspec}, None, f"{what} out", bad)
        return {"out": _whole({"logits": logits, "cache": cache}),
                "count": count}
    # serve
    fn, ps = steps.make_serve_step(cfg, mesh, greedy=case["greedy"])
    P = sh.distribute(mesh, params, ps)
    B = batch["positions"].shape[0]
    cache = _tensors(case["cache"])
    max_len = case["max_len"]
    cspec, tspec = steps.serve_shardings(cfg, mesh, B, max_len)
    C = sh.distribute(mesh, cache, cspec)
    _check(mesh, C, cspec, cache, f"{what} cache", bad)
    before = _storages(C)
    (out, new_cache), count = _counted(fn, P, C, pbatch)
    ospec = sh.batch_shardings(mesh, {"out": out}, policy=cfg.shard_policy)
    _check(mesh, {"out": out, "cache": new_cache},
           {"out": ospec["out"], "cache": cspec}, None, f"{what} out", bad)
    after = _storages(new_cache)
    return {"out": _whole({"out": out, "cache": new_cache}), "count": count,
            "in_place": {k: after[k] == before[k] for k in before}}


def _worker(rank: int, world: int, port: int, src: str, dst: str) -> None:
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    with open(src, "rb") as f:
        spec = pickle.load(f)
    results, bad, meshes = {}, [], {}
    for case in spec["cases"]:
        try:
            results[case["name"]] = _run_case(case, spec["weights"], meshes,
                                              bad)
        except Exception:   # noqa: BLE001 -- reported to the test
            bad.append(f"{case['name']} rank {rank}: "
                       f"{traceback.format_exc()}")
            results[case["name"]] = {"error": traceback.format_exc()}
    every = [None] * world
    dist.all_gather_object(every, bad)
    if rank == 0:
        with open(dst, "wb") as f:
            pickle.dump({"results": results,
                         "bad": [b for r in every for b in r]}, f)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    src, dst, world = sys.argv[1], sys.argv[2], int(sys.argv[3])
    mp.spawn(_worker, args=(world, _free_port(), src, dst), nprocs=world)
