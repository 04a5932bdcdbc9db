"""Step builders on a mesh: the train step of every ColA mode, the serve
(decode) step and the prefill step, the JAX package's
``distributed/steps.py`` under its names. Each wraps the same
``repro_torch.core.gl`` / ``models.model`` math as one device: the
distribution layer adds placements and never changes the numbers.

Execution, as this port runs it:

- **Data parallel over the batch axes** (``sharding.batch_axes(mesh,
  cfg.shard_policy)``). A step takes the whole batch (plain tensors, or
  DTensors, which it gathers); each rank computes its block of every
  (micro)batch's rows. Where the rows do not divide over the batch ranks,
  every rank computes them all, as JAX replicates a batch that does not
  divide.
- **Tensor parallel over "model"** under "2d", by the call's
  ``tensor_parallel.Plan``: a rank computes its columns of the attention's
  and the dense MLP's products (o and down by output columns over their
  gathered inputs), attends over its own query heads, and holds its vocab
  range of the embedding, the head and the CE. Where a split does not fit,
  that part is replicated over "model". The
  train and prefill steps hold the residual stream between blocks as the
  rank's (b, S / n, d) rows where the n "model" ranks divide S (sequence
  parallelism, ``Plan.seq``: the norms and adds on the rows, the split
  parts' inputs gathered over the sequence and their output columns turned
  into rows by an all-to-all; the whole stream where S does not divide).
  The Mamba2 mixer scans the rank's SSD heads where they divide, and the
  MoE FFN runs the rank's E / n experts where they divide (each rank
  routing its batch rank's tokens, the experts' shares summed over
  "model"). The serve
  step computes every attention head on every rank (q / k / v gathered)
  against its block of a KV cache that the rules split by sequence, the
  ranks' blocks merged (``tensor_parallel.merge``), and keeps the SSM state
  as the rank's heads block.
- **Parameters, adapters, caches** come as DTensors at the rules' placements
  (``sharding.distribute``, or ``sharding.wrap`` of a rank's blocks) or as
  plain tensors (whole: the rank's block is copied out). The model takes
  each layer's leaves through the plan just before the layer runs,
  gathered over their FSDP axis (and over "model" where the product keeps
  no split), and drops them after it; at one rank it runs on the tensors
  themselves, with no copy.
- **Outputs** go back as DTensors at the rules' placements: Mode B, LoRA and
  full-FT gradients, each rank's block summed over the ranks its gradient
  is partial over (``Plan.finish``; the gathers' backward reduce-scatters
  the rest); Mode A's data by ``delta_shardings`` with a leading
  microbatch axis, each rank's block as the model collected it; tokens or
  logits by ``batch_shardings`` (a prefill's logits the rank's vocab
  columns); caches by ``cache_shardings`` (a prefill's K and V made whole
  over the KV heads a layer at a time; the serve step's KV blocks updated
  in place and wrapped as they are). The loss is a plain scalar, the whole
  batch's, on every rank.
- **The loss over split rows** is the whole batch's masked mean: the CE
  sums and counts (and the MoE router's statistics) are reduced over the
  batch ranks inside ``activation_rules(local_rows=True)``, and each rank
  backpropagates its own share, so its grad_h rows and the reduced
  gradients are one device's.

``cfg.microbatches`` (M) splits a train step's batch as JAX's
``split_micro`` does: microbatch i is global rows [i B / M, (i + 1) B / M),
whose rows are then split across the batch ranks. Mode A returns the mean
of the M microbatches' losses and each microbatch's own (x, grad_h),
stacked (M, L?, b, S, d), to stream to the offloader as M pushes; Mode B
and LoRA sum the gradients over the microbatches and divide by M; full FT
takes no microbatches.

A MoE call's dispatch groups and expert capacities are its whole
(micro)batch's, as one device forms them, however its rows split over the
batch ranks: where a rank's rows do not hold whole groups, or under the
sort dispatch, the ranks' expert counts are exchanged
(``tensor_parallel``, ``models.moe.Split``).
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.analysis import collectives
from repro_torch.configs.base import ColaConfig, ModelConfig
from repro_torch.core import gl
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import model as model_lib
from repro_torch.utils import tree_map


# ---------------------------------------------------------------------------
# shape-only param / adapter trees (meta device: no memory)
# ---------------------------------------------------------------------------

def shaped_params(cfg: ModelConfig) -> dict:
    return model_lib.init(cfg, device="meta")


def shaped_adapters(cfg: ModelConfig, cc: ColaConfig) -> dict:
    if cc.mode in ("ft", "frozen"):
        return {}
    return gl.init_adapters(cfg, cc, torch.Generator(), dtype=torch.float32,
                            device="meta")


# ---------------------------------------------------------------------------
# rows: which rows of a batch this rank computes
# ---------------------------------------------------------------------------

class _Rows:
    """Rows [start(i), start(i) + rows) of the whole batch that this rank
    computes for microbatch i of ``m``. ``split``: the rows divide over the
    ``n`` > 1 batch ranks; else every rank computes every row."""

    def __init__(self, mesh: DeviceMesh, policy: str, batch: int, m: int = 1):
        if batch % m:
            raise ValueError(f"batch {batch} does not split into {m} "
                             f"microbatches")
        self.axes = sh.batch_axes(mesh, policy)
        shape = sh.mesh_shape(mesh)
        self.n = 1
        for a in self.axes:
            self.n *= shape[a]
        self.micro = batch // m
        self.split = self.n > 1 and self.micro % self.n == 0
        self.rows = self.micro // self.n if self.split else self.micro
        self.index = 0
        if self.split:
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            for a in self.axes:
                self.index = self.index * shape[a] + coord[a]

    def start(self, i: int) -> int:
        return i * self.micro + self.index * self.rows

    def take(self, batch: dict, i: int = 0) -> dict:
        s = self.start(i)
        return {k: v[s:s + self.rows] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# moving leaves between the rules' placements and the compute layout
# ---------------------------------------------------------------------------

def _use(tree):
    """Every leaf whole (``sharding.gathered``): the batch's."""
    return tree_map(sh.gathered, tree)


def _block(mesh: DeviceMesh, x, spec) -> torch.Tensor:
    """A leaf's block on this rank under ``spec``: a DTensor's local tensor
    (itself where it comes at the spec's placements, else redistributed
    first), a plain (whole) tensor's block copied out (``sharding.place``;
    at one rank the tensor itself)."""
    if not isinstance(x, DTensor):
        return sh.place(mesh, x, spec).to_local()
    want = sh.placements(mesh, spec)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    return x.to_local()


def _blocks(mesh: DeviceMesh, tree, specs) -> dict:
    """``_block`` of every leaf of ``tree`` at its spec in ``specs``."""
    return sh.map_with_specs(lambda x, s: _block(mesh, x, s), tree, specs)


def _plan(cfg: ModelConfig, mesh: DeviceMesh, rows: "_Rows", ps, ash=None,
          seq: int | None = None, ssm: bool = True) -> tp.Plan:
    """The call's tensor-parallel plan: gradients partial over the batch
    axes where the rows are split (the MoE dispatch's groups formed across
    them); ``seq``: the sequence length of a train
    or prefill step, whose residual stream the plan holds by sequence where
    "model"'s ranks divide it (the serve step passes none); ``ssm``: whether
    the Mamba2 heads may split."""
    return tp.Plan(cfg, mesh, cfg.shard_policy,
                   partial=rows.axes if rows.split else (), param_specs=ps,
                   adapter_specs=ash, sites=model_lib.tap_sites(cfg),
                   seq=seq, ssm=ssm)


def _compute_placements(mesh: DeviceMesh, rows: _Rows, bdim: int,
                        mdim: int | None = None) -> tuple:
    """Shard(bdim) on the batch axes where the rows are split, Shard(mdim) on
    "model" where the rank holds a block of dim ``mdim``, else
    replicated."""
    axes = rows.axes if rows.split else ()
    return tuple(Shard(bdim) if a in axes else
                 Shard(mdim) if a == "model" and mdim is not None else
                 Replicate() for a in mesh.mesh_dim_names)


def _rows_of(mesh: DeviceMesh, x, rows: _Rows, bdim: int) -> torch.Tensor:
    """This rank's rows of a per-row leaf (all its entries on every other
    dim): a DTensor redistributed to the compute layout (its own tensor when
    nothing moves), a plain tensor (the whole leaf) sliced."""
    if isinstance(x, DTensor):
        want = _compute_placements(mesh, rows, bdim)
        if tuple(x.placements) != want and mesh.size() > 1:
            x = x.redistribute(mesh, want)
        return x.to_local()
    if not rows.split:
        return x
    return x.narrow(bdim, rows.start(0), rows.rows)


def _place_rows(mesh: DeviceMesh, local: torch.Tensor, spec: tuple,
                rows: _Rows, bdim: int | None,
                mdim: int | None = None) -> DTensor:
    """This rank's computed rows (dim ``bdim``; None: the whole tensor) as a
    DTensor at ``spec``; ``mdim``: the dim of which it holds its block over
    "model" (None: all of it)."""
    if (bdim is None or not rows.split) and mdim is None:
        return sh.place(mesh, local, spec)   # ``local`` is the whole tensor
    d = DTensor.from_local(local, mesh,
                           _compute_placements(mesh, rows, bdim, mdim),
                           run_check=False)
    return d.redistribute(mesh, sh.placements(mesh, spec))


def _wrap_tree(mesh, local, specs, shaped):
    """Blocks of leaves at their specs as DTensors of ``shaped``'s shapes."""
    flat_s, flat_w = {}, {}
    sh._map(lambda p, s: flat_s.__setitem__(p, s), specs)
    sh._map(lambda p, w: flat_w.__setitem__(p, w.shape), shaped)
    return sh._map(lambda p, x: sh.wrap(mesh, x, flat_s[p], flat_w[p]),
                   local)


def _batch_rows(batch: dict) -> tuple[int, int]:
    x = batch.get("tokens", batch.get("embeds"))
    return x.shape[0], x.shape[1]


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, cc: ColaConfig, mesh: DeviceMesh):
    """Returns (fn, (param specs, adapter specs or None)); fn's signature
    depends on the mode:
      fused_fit / lora : fn(params, adapters, batch) -> (loss, adapter_grads)
      faithful_offload : fn(params, adapters, batch) -> (loss, adaptation_data)
      ft               : fn(params, batch) -> (loss, param_grads)
    """
    policy = cfg.shard_policy
    shaped = shaped_params(cfg)
    ps = sh.params_shardings(mesh, shaped, policy=policy)

    def rules(rows, plan):
        return sh.activation_rules(mesh, policy, local_rows=rows.split,
                                   plan=plan)

    def rows_of(batch, m=1):
        return _Rows(mesh, policy, _batch_rows(batch)[0], m)

    if cc.mode == "ft":
        def fn_ft(params, batch):
            batch = _use(batch)
            rows = rows_of(batch)
            plan = _plan(cfg, mesh, rows, ps, seq=_batch_rows(batch)[1])
            with rules(rows, plan):
                loss, grads, _ = gl.train_step_ft(
                    cfg, _blocks(mesh, params, ps), rows.take(batch))
            return loss, _wrap_tree(mesh, plan.finish(grads), ps, shaped)

        return fn_ft, (ps, None)

    spec = gl.make_spec(cfg, cc)
    shaped_a = shaped_adapters(cfg, cc)
    ash = sh.params_shardings(mesh, shaped_a, adapter=True, policy=policy)
    sites = model_lib.tap_sites(cfg)
    m = cfg.microbatches

    def setup(params, adapters, batch):
        batch = _use(batch)
        rows = rows_of(batch, m)
        plan = _plan(cfg, mesh, rows, ps, ash, seq=_batch_rows(batch)[1])
        return (_blocks(mesh, params, ps), _blocks(mesh, adapters, ash),
                batch, rows, plan)

    if cc.mode == "faithful_offload":
        def fn_a(params, adapters, batch):
            p, a, batch, rows, plan = setup(params, adapters, batch)
            if m == 1:
                with rules(rows, plan):
                    loss, data, _ = gl.server_step_a(cfg, spec, p, a,
                                                     rows.take(batch))
            else:
                tot = data = None
                for i in range(m):
                    with rules(rows, plan):
                        loss_i, data_i, _ = gl.server_step_a(
                            cfg, spec, p, a, rows.take(batch, i))
                    # data leaves (M, L?, b, S, d): per-microbatch adaptation
                    # data, streamed to the offloader as M pushes
                    if data is None:
                        tot = torch.zeros((), dtype=loss_i.dtype,
                                          device=loss_i.device)
                        data = {t: tuple(v.new_empty((m,) + v.shape)
                                         for v in xg)
                                for t, xg in data_i.items()}
                    tot = tot + loss_i
                    for t, xg in data_i.items():
                        for dst, src in zip(data[t], xg):
                            dst[i].copy_(src)
                    del data_i
                loss = tot / m
            # each leaf holds this rank's rows and, where its last dim is
            # split over "model", this rank's block of it
            wide = {t: (sites[t].d_in, sites[t].d_out) for t in data}
            dspec = sh.delta_shardings(mesh, {
                t: tuple(_global_shape(v, rows, v.dim() - 3, w)
                         for v, w in zip(xg, wide[t]))
                for t, xg in data.items()})
            return loss, sh.map_with_specs(
                lambda x, s: _place_rows(
                    mesh, x, s, rows, x.dim() - 3,
                    x.dim() - 1 if s[-1] == "model" and plan.n > 1
                    else None),
                data, dspec)

        return fn_a, (ps, ash)

    def fn_b(params, adapters, batch):
        p, a, batch, rows, plan = setup(params, adapters, batch)
        if m == 1:
            with rules(rows, plan):
                loss, grads, _ = gl.train_step_b(cfg, spec, p, a,
                                                 rows.take(batch))
        else:
            tot = acc = None
            for i in range(m):
                with rules(rows, plan):
                    loss_i, g_i, _ = gl.train_step_b(cfg, spec, p, a,
                                                     rows.take(batch, i))
                if acc is None:
                    tot = torch.zeros((), dtype=loss_i.dtype,
                                      device=loss_i.device)
                    acc = tree_map(torch.zeros_like, g_i)
                tot = tot + loss_i
                acc = tree_map(torch.add, acc, g_i)
            loss = tot / float(m)
            grads = tree_map(lambda g: g / float(m), acc)
        return loss, _wrap_tree(mesh, plan.finish(grads), ash, shaped_a)

    return fn_b, (ps, ash)


# ---------------------------------------------------------------------------
# serve step (decode)
# ---------------------------------------------------------------------------

def _cache_split(mesh: DeviceMesh, rows: _Rows, spec,
                 whole: int) -> tp.CacheSplit | None:
    """The rank's block of a KV leaf (n, B, S, K, Dh) at ``spec`` as a
    sequence split: its rows are the rows the rank computes and no dim but
    the sequence splits otherwise. None where the placement is not one (the
    sequence unsplit and another dim split, or rows split over other axes,
    as under "dp")."""
    shape = sh.mesh_shape(mesh)

    def axes(entry):
        return tuple(a for a in sh._entry_axes(entry) if shape[a] > 1)

    want_rows = tuple(a for a in rows.axes if shape[a] > 1) if rows.split \
        else ()
    if axes(spec[1]) != want_rows or any(axes(spec[d]) for d in (0, 3, 4)):
        return None
    seq = axes(spec[2])
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    n, idx = 1, 0
    for a in seq:
        idx, n = idx * shape[a] + coord[a], n * shape[a]
    size = whole // n
    return tp.CacheSplit(seq, n, idx * size, size, whole)


def _held_block(mesh: DeviceMesh, rows: _Rows, spec,
                dim: int) -> tuple[str, ...] | None:
    """The axes (major first) over which a per-row state leaf (n, B, ...) at
    ``spec`` splits dim ``dim``, where on this rank it is the rows the rank
    computes and its block of dim ``dim``, no other dim split; else None.
    The serve step's SSM state by heads (dim 2, over "model" alone: the
    heads the rank scans), its conv state by channels (dim 3)."""
    shape = sh.mesh_shape(mesh)

    def axes(entry):
        return tuple(a for a in sh._entry_axes(entry) if shape[a] > 1)

    want_rows = tuple(a for a in rows.axes if shape[a] > 1) if rows.split \
        else ()
    if axes(spec[1]) != want_rows or any(
            axes(e) for d, e in enumerate(spec) if d not in (1, dim)):
        return None
    return axes(spec[dim])


def make_serve_step(cfg: ModelConfig, mesh: DeviceMesh, greedy: bool = True):
    """fn(params, cache, batch) -> (tokens | logits, new cache). The
    parameters are gathered a layer at a time and the products split over
    "model" as in the prefill (q / k / v then gathered to every head, the
    vocab split for the embedding, the head and the greedy argmax). A KV
    leaf that ``cache_shardings`` places with its sequence split (and its
    rows the rank's computed rows) stays the rank's block: updated in place
    and returned at its spec, never gathered; the ranks' attention over
    their blocks is merged. Where every SSM state leaf is the rank's rows
    and heads block, the Mamba2 heads split as in the prefill and the state
    stays that block, updated in place and never moved; its conv state, if
    the rank's channel block, is gathered one layer at a time inside the
    tick and only the block written back. Any other cache leaf (the state
    where the heads stay replicated, a KV leaf split otherwise) is taken to
    the rank's rows whole and placed anew."""
    policy = cfg.shard_policy
    ps = sh.params_shardings(mesh, shaped_params(cfg), policy=policy)

    def fn(params, cache, batch):
        batch = _use(batch)
        B = batch["positions"].shape[0]
        rows = _Rows(mesh, policy, B)
        cspec = sh.cache_shardings(mesh, cache)
        states = [st for st, leaves in cache.items() if "ssm" in leaves]
        plan = _plan(cfg, mesh, rows, ps,
                     ssm=all(_held_block(mesh, rows, cspec[st]["ssm"], 2)
                             == ("model",) for st in states))
        held: dict[str, set] = {}
        for st in states:
            if plan.ssm is not None:
                held[st] = {"ssm"}
                conv = _held_block(mesh, rows, cspec[st]["conv"], 3)
                if conv is not None:
                    held[st].add("conv")
                    plan.conv_blocks[st] = conv
        local = {}
        for stack, leaves in cache.items():
            split = (_cache_split(mesh, rows, cspec[stack]["k"],
                                  leaves["k"].shape[2])
                     if "k" in leaves else None)
            if split is not None:
                plan.cache_splits[stack] = split
                held[stack] = set(leaves)
            local[stack] = {}
            for n, c in leaves.items():
                if n in held.get(stack, ()):
                    local[stack][n] = _block(mesh, c, cspec[stack][n])
                    continue
                with collectives.labelled(f"cache.{stack}.{n}"):
                    local[stack][n] = _rows_of(mesh, c, rows, 1)
        with sh.activation_rules(mesh, policy, local_rows=rows.split,
                                 plan=plan):
            logits, local = model_lib.decode_step(
                cfg, _blocks(mesh, params, ps), rows.take(batch), local)
        vocab = plan.head is not None
        if greedy:
            out = (tp.vocab_argmax(plan, logits) if vocab else
                   torch.argmax(logits, dim=-1).to(torch.int32))
        else:
            out = logits
        mdim = out.dim() - 1 if vocab and not greedy else None
        ospec = sh.batch_shardings(mesh, {"out": _global_shape(out, rows)},
                                   policy=policy)["out"]
        new = {}
        for stack, leaves in local.items():
            new[stack] = {
                n: (sh.wrap(mesh, x, cspec[stack][n], cache[stack][n].shape)
                    if n in held.get(stack, ()) else
                    _place_rows(mesh, x, cspec[stack][n], rows, 1))
                for n, x in leaves.items()}
        return _place_rows(mesh, out, ospec, rows, 0, mdim), new

    return fn, ps


def _global_shape(x: torch.Tensor, rows: _Rows, bdim: int = 0,
                  last: int | None = None):
    """(shape, dtype) of the whole batch's tensor of which ``x`` holds this
    rank's computed rows (dim ``bdim``), its last dim ``last`` wide where
    given."""
    shape = list(x.shape)
    if rows.split:
        shape[bdim] *= rows.n
    if last is not None:
        shape[-1] = last
    return (tuple(shape), x.dtype)


def serve_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int):
    from repro_torch.configs import registry

    cache_sh = sh.cache_shardings(mesh, model_lib.cache_specs(cfg, batch,
                                                              max_len))
    tok = sh.batch_shardings(mesh, registry.decode_token_specs(cfg, batch),
                             policy=cfg.shard_policy)
    return cache_sh, tok


# ---------------------------------------------------------------------------
# prefill step
# ---------------------------------------------------------------------------

def _place_kv(mesh, local: torch.Tensor, spec, rows: _Rows, plan: tp.Plan,
              n_kv: int) -> DTensor:
    """A prefill's K or V (n, b, S, Kl, Dh), the rank's rows and KV heads,
    at the cache's ``spec``: each layer's heads made whole and the rank's
    block of it kept, one layer at a time."""
    # the rows are the rank's already where the spec splits them
    layer = sh.Spec((None if rows.split else spec[1],) + tuple(spec[2:]))
    out = None
    for i in range(local.shape[0]):
        blk = sh.local_slice(mesh, plan.whole_kv_heads(local[i]), layer)
        if out is None:
            out = blk.new_empty((local.shape[0],) + tuple(blk.shape))
        out[i] = blk
    shape = list(local.shape)
    shape[1] *= rows.n if rows.split else 1
    shape[3] = n_kv
    return sh.wrap(mesh, out, spec, shape)


def make_prefill_step(cfg: ModelConfig, mesh: DeviceMesh):
    """fn(params, batch) -> (logits, cache) at ``prefill_out_shardings`` of
    the batch's (B, S)."""
    policy = cfg.shard_policy
    ps = sh.params_shardings(mesh, shaped_params(cfg), policy=policy)

    def fn(params, batch):
        batch = _use(batch)
        B, S = _batch_rows(batch)
        rows = _Rows(mesh, policy, B)
        plan = _plan(cfg, mesh, rows, ps, seq=S)
        with sh.activation_rules(mesh, policy, local_rows=rows.split,
                                 plan=plan):
            logits, cache = model_lib.prefill(cfg, _blocks(mesh, params, ps),
                                              rows.take(batch))
        lspec, cspec = prefill_out_shardings(cfg, mesh, B, S)
        flat = {}
        sh._map(lambda p, s: flat.__setitem__(p, s), cspec)

        def place(path, x):
            if plan.attn is not None and path[-1] in ("k", "v"):
                return _place_kv(mesh, x, flat[path], rows, plan,
                                 cfg.n_kv_heads)
            # a split mixer's final state is the rank's heads; its conv tail
            # has every channel
            heads = 2 if plan.ssm is not None and path[-1] == "ssm" else None
            return _place_rows(mesh, x, flat[path], rows, 1, heads)

        return (_place_rows(mesh, logits, lspec, rows, 0,
                            logits.dim() - 1 if plan.head else None),
                sh._map(place, cache))

    return fn, ps


def prefill_out_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """Logits over batch and vocab; the cache placed like the decode cache,
    so the prefill's output feeds the serve step without a move."""
    logits_shape = ((batch, 1, cfg.n_codebooks, cfg.vocab_size)
                    if cfg.n_codebooks else (batch, 1, cfg.vocab_size))
    ba = sh.batch_axes(mesh)
    shape = sh.mesh_shape(mesh)
    nb = 1
    for a in ba:
        nb *= shape[a]
    lspec: list = [None] * len(logits_shape)
    if batch % nb == 0:
        lspec[0] = ba
    if logits_shape[-1] % shape.get("model", 1) == 0:
        lspec[-1] = "model"
    cache_sh = sh.cache_shardings(mesh, model_lib.cache_specs(cfg, batch,
                                                              max_len))
    return sh._spec(*lspec), cache_sh
