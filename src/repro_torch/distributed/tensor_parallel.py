"""Tensor-parallel compute over "model" and the layer-at-a-time gather of
the step builders (``distributed/steps.py``). The JAX package jits its
steps with the rules' shardings and XLA splits the products; the port splits
them by hand, Megatron-style, on the leaves the rules already place.

A step makes one ``Plan`` a call and runs the model inside
``sharding.activation_rules(..., plan=plan)``. The model takes its leaves
through the plan one layer at a time (``take``, ``take_layer``) and asks it
how each product is laid out (``current``, ``tap_layout``):

- **The gather.** Every leaf comes as the rank's block under the rules. A
  layer's leaves are all-gathered just before it runs, over every axis that
  splits them but "model" where the product keeps that split, one layer's
  slice at a time (never the stack), and dropped after it; under remat
  "full" or "dots" the gather runs inside the checkpointed layer, so the
  recompute gathers again. The backward of a gather is a reduce-scatter
  over each gathered axis along which the ranks' rows differ (the gradient
  is partial there) and the rank's own block over any other. Axes over
  which a gradient is partial but which no gather spans are summed once the
  backward is done (``finish``).
- **Attention** (``attn``, where the heads divide over "model" and a rank's
  query heads read whole KV heads): a rank computes its columns of q / k /
  v (the rules' blocks) and attends over its own query heads with the KV
  heads they read. Where K % n == 0 its k / v block is its KV heads; where
  n % K == 0 a KV head is shared by n / K ranks, so the k / v outputs are
  all-gathered over "model" (reduce-scatter in the backward) and the rank
  keeps its head.
- **The dense MLP** (``mlp``): gate / up by columns.
- **o and down by output columns.** The rules place o / down by rows. A
  rank all-gathers the product's input over "model" (the heads, the MLP's
  hidden; reduce-scatter in the backward), turns its weight's row block
  into a column block with an all-to-all over "model", computes its output
  columns and all-gathers them. So every output element is one rank's whole
  sum, in one device's order: a row-parallel product's partial sums, added
  over "model", would round otherwise (by up to 1.5e-6 at the reduced
  configs' O(1) activations, past the tests' 1e-6).
- **Vocab** (``embed``, ``head``): the embedding lookup is the rank's vocab
  range, zero elsewhere, summed over "model"; the logits are the rank's
  vocab columns, and the CE (``vocab_ce``) takes the max and the sum of
  exponentials over "model" and the label's logit from the rank that holds
  it.
- **The Mamba2 mixer** (``ssm``, where its SSD heads divide over "model"
  and so does d_model, as JAX's ``constrain(xh, "batch", None, "model",
  None)``): a split part, its input ``seq_in``'s and its output columns
  ``seq_out``'s. ``in_proj`` is computed whole on every rank (the rules
  leave its leaf whole over "model"); the rank takes its heads' columns of z, x
  and dt and the shared B and C, convolves its x channels and B, C, and
  scans its own heads with its slices of ``dt_bias``, ``A_log`` and ``D``.
  ``y * silu(z)`` is gathered by columns (``gather_cols``), the norm runs
  over the whole d_inner, and ``out_proj`` (placed by rows) by output
  columns, as o is. Every leaf the mixer uses whole or sliced (``in_proj``,
  the conv, ``dt_bias``, ``A_log``, ``D``, the norm's scale) has a gradient
  partial over "model"; so do the ``ssm.in`` tap's adapters and its Mode-A
  delta, whose layout stays a whole part's (``TapLayout.summed``). The
  serve step keeps the SSM state as the rank's (b, H / n, P, N) heads
  block, updated in place and never moved; the conv state's channel block
  does not line up with the rank's heads, so it is gathered one layer at a
  time inside the tick (``conv_state``, labelled "cache.<stack>.conv") and
  only the rank's block of the new state is written back
  (``own_channels``).
- **The MoE FFN by experts** (``moe``, where the experts divide over
  "model" and the rules place ``moe.gate`` / ``up`` / ``down`` by experts
  over it, as JAX's ``constrain(h, "batch", "model", None, None)`` on the
  dispatched (groups, E, C, d) activations): Megatron's all-gather
  dispatcher. The part's input is ``seq_in``'s (the stream's rows gathered
  over the sequence; backward a reduce-scatter) or ``copy_in``, so every
  rank of a "model" group holds its batch rank's tokens; each routes them
  all (the router and the accounting whole, ``router.w``'s gradient
  partial over "model"), dispatches them into its own E / n experts'
  slots, runs those experts (their leaves the rank's expert block,
  gathered over FSDP only) and combines its experts' share of every
  token's output, which the output sums over "model" (a reduce-scatter
  over the sequence, else an all-reduce). Every collective keeps a static
  shape and a slot has one source token; a token's k expert terms are
  added in another order than one device's (the last bit). The aux loss,
  which every rank of the group computes on the same tokens, takes its
  gradient from "model" rank 0 alone. The collectives are labelled
  "moe.in" / "moe.out".
- **MoE groups across batch ranks** (every MoE step, split over "model"
  or not): a call's dispatch groups and capacities are its whole
  (micro)batch's, over the batch axes that split its rows (``partial``),
  as one device forms them. Where a rank's
  rows do not hold whole groups (or under the sort dispatch, whose order
  is the call's), its per-expert counts are all-gathered over the batch
  axes ("moe.counts", small ints) and each rank counts the others' into
  its positions (``models.moe.Split``).
- **Megatron's f.** A split region's input is ``copy_in`` (the identity,
  its gradient summed over "model"); its output is ``gather_out`` (the
  columns all-gathered, the gradient's own columns kept).
- **Sequence parallelism between blocks** (``Plan.seq``: the train and
  prefill steps, where "model" splits the products and its n ranks divide
  the sequence S, as JAX's ``constrain(x, "batch", "model", None)`` at every
  block boundary; else the stream stays whole, as ``constrain`` replicates
  a dim that does not divide). A rank holds its (b, S / n, d) rows of the
  residual stream and runs every norm and residual add on them; remat
  saves those rows. A split part's input is all-gathered over the sequence
  (``seq_in``; backward: a reduce-scatter of the ranks' partial
  gradients) and its output columns (b, S, d / n) turn into the rank's rows
  (b, S / n, d) by an all-to-all (``seq_out``; backward: the inverse), so
  every element stays one rank's whole sum. A part replicated over "model"
  (an attention, MLP or Mamba2 mixer that does not split, every MoE FFN,
  a head that keeps the whole vocab) gathers its input (``gather_rows``;
  backward: the rank's own rows, every rank's gradient being the same) and
  keeps its rows of the output (``keep_rows``; backward: the rows'
  gradients all-gathered). The vocab-split embedding's sum is a
  reduce-scatter over the sequence (``scatter_rows``), the loss and the
  head see the whole sequence (``whole_sequence``), and a prefill takes
  its last positions from the rank that holds them (``take_positions``).
  A norm scale's gradient is then partial over "model". The collectives
  carry ``analysis.collectives.labelled("seq.<part>")``.
- **Decode** (the serve step): q / k / v come from the split products and
  are all-gathered to every head (a tick's B x H x d_head is small, so no
  head count need divide over "model"). A KV cache whose sequence the rules
  split (``cache_shardings``: over "model", or the batch axes and "model"
  where the rows do not divide) stays the rank's block (``CacheSplit``):
  the rank writes the new token's K / V only where its block holds the
  position, attends its block for every head (the decode kernel at
  positions shifted by the block's offset, with its log-sum-exp), and the
  ranks' (o, lse) are all-gathered over the split's axes and merged
  (``merge``): every rank merges the same tensors in rank order, so all get
  the same bits. The merged heads feed the o product whole. The greedy
  token is the argmax across the vocab ranks (``vocab_argmax``).
- **Adapters and taps** (``tap_layout``): every tap of a split part applies
  ``x A B_rank`` to its own output columns (B's columns are split as its
  product's). A Mode-A delta and a collected input are always the rank's
  block under ``delta_shardings`` (last dim over "model" where it
  divides), so the data leaves the step without a move.

Where a split does not fit (the heads, d_model or the vocab do not divide,
a split cuts a head or a GQA group, codebooks; the SSD heads or d_model do
not divide, or the serve step's SSM state is not the rank's heads block),
the part's leaves are gathered over "model" too and its compute is
replicated over "model"; so is an MoE FFN's where the experts do not divide
over "model", under the "dp" policy or with ``moe_impl="dense"``. With one
rank
on every axis nothing is gathered or split: the model runs on the tensors
themselves.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re

import torch
import torch.distributed as dist

from repro_torch.analysis import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.models import moe as M

# all_gather_single / reduce_scatter_single are the newer names of
# all_gather_into_tensor / reduce_scatter_tensor
_all_gather_into = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)

# the expert leaves, each (L, E, d_in, d_out) with its experts on dim -3
_EXPERTS = re.compile(r"\.moe\.(gate|up|down)$")
# the weights that the rules place by rows and a split part uses by columns
_ROW_PLACED = (".attn.o.w", ".mlp.down.w", ".ssm.out_proj.w")
# the Mamba2 mixer's input tap: computed whole on every rank, its gradient
# partial over "model"
_SSM_IN = ".ssm.in"
# the norm scales applied to the residual stream's rows (their gradient is
# partial over "model" under a sequence split)
_ROW_WISE = re.compile(r"(^|\.)(ln|ln1|ln2|post_ln1|post_ln2|final_norm)"
                       r"\.scale$")
_METERS: list["gather_meter"] = []


# ---------------------------------------------------------------------------
# collectives along a dim
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``x`` concatenated along ``dim`` in rank
    order."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    _all_gather_into(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the ranks' ``x`` summed."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    _reduce_scatter(out, xt, group=group)
    return out.movedim(0, dim)


def _own(x: torch.Tensor, dim: int, n: int, c: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, c * size, size)


def _swap(x: torch.Tensor, split: int, whole: int, group, n: int
          ) -> torch.Tensor:
    """``x`` holds this rank's block along dim ``split`` and all of dim
    ``whole``; returns all of ``split`` and this rank's block along
    ``whole`` (an all-to-all: block j of ``whole`` goes to rank j)."""
    xt = x.movedim(whole, 0)
    xt = xt.reshape((n, xt.shape[0] // n) + tuple(xt.shape[1:])).contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    # out[i]: rank i's block of ``split`` for this rank's block of ``whole``
    return torch.cat([out[i].movedim(0, whole) for i in range(n)], dim=split)


class _Take(torch.autograd.Function):
    """A leaf's gathers (``Recipe.steps``) and swap; backward: the swap
    undone, then a reduce-scatter over each gathered axis in ``partial``,
    the own block over the others."""

    @staticmethod
    def forward(ctx, x, plan, recipe, path):
        ctx.plan, ctx.recipe = plan, recipe
        return plan._gather(x, recipe, path)

    @staticmethod
    def backward(ctx, g):
        plan, recipe = ctx.plan, ctx.recipe
        if recipe.swap is not None:
            g = _swap(g, recipe.swap[1], recipe.swap[0], plan.group, plan.n)
        for dim, axis in reversed(recipe.steps):
            n = plan.shape[axis]
            if axis in recipe.partial:
                g = _scatter_sum(g, dim, plan.mesh.get_group(axis), n)
            else:
                g = _own(g, dim, n, plan.coord[axis])
        return g, None, None, None


class _CopyIn(torch.autograd.Function):
    """Megatron's f: the identity; the gradient summed over the group
    (under ``label``, where given)."""

    @staticmethod
    def forward(ctx, x, group, label=None):
        ctx.group, ctx.label = group, label
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        with _label(ctx.label):
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _PadScatter(torch.autograd.Function):
    """The rank's block of a delta's columns padded to the whole width; the
    gradient, each rank's partial of the whole width, reduce-scattered:
    the rank's block of the sum."""

    @staticmethod
    def forward(ctx, d, lo, width, group):
        ctx.group, ctx.n = group, width // d.shape[-1]
        return torch.nn.functional.pad(d, (lo, width - lo - d.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, -1, ctx.group, ctx.n), None, None, None


class _ReduceOut(torch.autograd.Function):
    """Partial sums summed over the group (in place); the gradient passed as
    it is."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _label(name: str | None):
    return contextlib.nullcontext() if name is None else \
        collectives.labelled(name)


class _GatherCols(torch.autograd.Function):
    """The ranks' blocks of the last dim gathered; the gradient
    reduce-scattered (both under ``label``, where given)."""

    @staticmethod
    def forward(ctx, x, group, n, label):
        ctx.group, ctx.n, ctx.label = group, n, label
        with _label(label):
            return _all_gather(x, -1, group, n)

    @staticmethod
    def backward(ctx, g):
        with _label(ctx.label):
            return _scatter_sum(g, -1, ctx.group, ctx.n), None, None, None


class _GatherOut(torch.autograd.Function):
    """The ranks' output columns gathered; every rank's gradient is the
    same, and each keeps its own columns of it."""

    @staticmethod
    def forward(ctx, x, group, n, c):
        ctx.n, ctx.c = n, c
        return _all_gather(x, -1, group, n)

    @staticmethod
    def backward(ctx, g):
        return _own(g, -1, ctx.n, ctx.c), None, None, None


# the sequence dim of the residual stream (b, S, d)
_SEQ = 1


class _SeqGather(torch.autograd.Function):
    """The ranks' rows gathered over the sequence; the gradient
    reduce-scattered (``summed``: each rank's is a partial) or the own rows
    kept (every rank's is the same)."""

    @staticmethod
    def forward(ctx, x, plan, summed, label):
        ctx.plan, ctx.summed, ctx.label = plan, summed, label
        return plan._seq_gather(x, label)

    @staticmethod
    def backward(ctx, g):
        p = ctx.plan
        if not ctx.summed:
            return _own(g, _SEQ, p.n, p.c), None, None, None
        with collectives.labelled(ctx.label):
            return _scatter_sum(g, _SEQ, p.group, p.n), None, None, None


class _SeqKeep(torch.autograd.Function):
    """The rank's own rows of a tensor every rank holds whole; the rows'
    gradients all-gathered."""

    @staticmethod
    def forward(ctx, y, plan):
        ctx.plan = plan
        return _own(y, _SEQ, plan.n, plan.c).clone()   # not a view of y

    @staticmethod
    def backward(ctx, g):
        return ctx.plan._seq_gather(g, "seq.keep"), None


class _SeqScatter(torch.autograd.Function):
    """The ranks' partial sums, the rank's rows of their sum (a
    reduce-scatter over the sequence); the gradient all-gathered (both under
    ``label``)."""

    @staticmethod
    def forward(ctx, x, plan, label):
        ctx.plan, ctx.label = plan, label
        return plan._seq_scatter(x, label)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan._seq_gather(g, ctx.label), None, None


class _ColsToRows(torch.autograd.Function):
    """A split part's output columns (b, S, d / n) as the rank's rows (b,
    S / n, d), by an all-to-all; backward: the inverse."""

    @staticmethod
    def forward(ctx, y, plan):
        ctx.plan = plan
        return plan._cols_to_rows(y)

    @staticmethod
    def backward(ctx, g):
        p = ctx.plan
        with collectives.labelled("seq.out"):
            return _swap(g, _SEQ, -1, p.group, p.n), None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Recipe:
    """How a leaf reaches its compute layout: ``steps`` are the all-gathers
    (dim counted from the end, so a layer's slice takes its stack's recipe;
    axis), minor axis first; ``swap`` (split dim, whole dim): then its block
    over "model" moves from the first dim to the second (``_swap``);
    ``partial`` the axes over which its gradient is partial."""
    steps: tuple[tuple[int, str], ...] = ()
    partial: tuple[str, ...] = ()
    swap: tuple[int, int] | None = None


@dataclasses.dataclass(frozen=True)
class Attn:
    """A rank's share of the attention: its query heads and the KV heads
    they read; ``shared`` > 1 where n / K ranks share one KV head (the k /
    v outputs are gathered over "model" and ``kv_head`` kept)."""
    heads: int
    kv_heads: int
    shared: int = 1
    kv_head: int = 0


@dataclasses.dataclass(frozen=True)
class Ssm:
    """A rank's share of a Mamba2 mixer: ``heads`` SSD heads from head
    ``first`` on."""
    heads: int
    first: int


@dataclasses.dataclass(frozen=True)
class TapLayout:
    """One tap's Mode-A blocks on this rank: ``x_block``, (lo, hi) of x kept
    for collection (None: all of it); ``delta_block``, (lo, hi, width) of
    y's columns where the rank's delta block goes (None: all of y, which is
    the rank's output columns in a split part); ``summed``: the group over
    which the delta's gradient is partial (a whole y whose gradient each
    rank gives its share of, the ``ssm.in`` tap's), summed there: the
    rank's block of the summed whole, or the whole delta's summed
    gradient where the block is all of y."""
    x_block: tuple[int, int] | None
    delta_block: tuple[int, int, int] | None
    summed: object = None

    def collected(self, x: torch.Tensor) -> torch.Tensor:
        if self.x_block is None:
            return x
        lo, hi = self.x_block
        return x[..., lo:hi].contiguous()   # not a view of the whole x

    def place_delta(self, d: torch.Tensor) -> torch.Tensor:
        if self.delta_block is None:
            # every rank's delta is the whole one: its gradient summed
            if self.summed is not None and _differentiable(d):
                return _CopyIn.apply(d, self.summed)
            return d
        lo, hi, width = self.delta_block
        if self.summed is not None and _differentiable(d):
            return _PadScatter.apply(d, lo, width, self.summed)
        return torch.nn.functional.pad(d, (lo, width - hi))


@dataclasses.dataclass(frozen=True)
class CacheSplit:
    """A stack's KV cache as the rank holds it in the serve step: positions
    [offset, offset + size) of a ``whole``-position cache, for the rows it
    computes; the sequence split over ``axes`` (major first, ``n`` ranks in
    all)."""
    axes: tuple[str, ...]
    n: int
    offset: int
    size: int
    whole: int


def merge(o: torch.Tensor, lse: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The n blocks' attention merged in rank order: o (n, B, 1, H, Dh) and
    lse (n, B, H) f32 each block's normalised output and log-sum-exp;
    lse = logsumexp_c lse_c and o = sum_c e^(lse_c - M) o_c / sum_c
    e^(lse_c - M), M the largest lse_c. A block at -inf (no key it may see)
    weighs zero; a row empty in every block gives o = 0, lse = -inf, no
    NaN."""
    m = lse.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)          # (n, B, H): 0 at -inf, 1 at the largest
    s = w.sum(dim=0)                # >= 1, or 0 where every block is empty
    out = (w[:, :, None, :, None] * o).sum(dim=0)
    return out / s.clamp(min=1.0)[:, None, :, None], m + torch.log(s)


def _model_major(entry) -> bool:
    axes = sh._entry_axes(entry)
    return bool(axes) and axes[0] == "model"


class Plan:
    """One step call's layout over ``mesh`` (see the module docstring).

    ``partial``: the batch axes over which this call's rows are split (a
    gradient is partial over them); ``param_specs`` / ``adapter_specs``: the
    rules' specs of the parameter and adapter trees; ``sites``: the model's
    tap sites; ``seq``: the call's sequence length where the step may hold
    the residual stream by sequence (train and prefill; ``self.seq`` says
    whether it does); ``ssm``: whether the call may split the Mamba2 heads
    (the serve step does where its SSM state is the rank's heads block);
    ``cache_splits``: the serve step's KV caches held by sequence block, by
    stack, and ``conv_blocks``: the stacks whose conv state it holds as the
    rank's channel block, with the axes (major first) that split the
    channels (set by the step)."""

    def __init__(self, cfg, mesh, policy: str, *, partial=(),
                 param_specs=None, adapter_specs=None, sites=None,
                 seq: int | None = None, ssm: bool = True):
        self.mesh = mesh
        self.shape = sh.mesh_shape(mesh)
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.partial = tuple(a for a in partial if self.shape[a] > 1)
        n = self.shape.get("model", 1)
        tp = policy != "dp" and n > 1
        self.n = n if tp else 1
        self.c = self.coord.get("model", 0) if tp else 0
        self.group = mesh.get_group("model") if tp else None
        # the residual stream between blocks as the rank's (b, S / n, d)
        self.seq = tp and bool(seq) and seq % n == 0
        self.sites = sites or {}
        flat = {}
        for specs in (param_specs, adapter_specs):
            if specs is not None:
                sh._map(lambda p, s: flat.__setitem__(sh._path_str(p), s),
                        specs)
        self.cache_splits: dict[str, CacheSplit] = {}
        self.conv_blocks: dict[str, tuple[str, ...]] = {}
        self.attn = self._attn(cfg, flat) if tp else None
        self.ssm = self._ssm(cfg, flat) if tp and ssm else None
        self.mlp = tp and self._mlp(cfg, flat)
        self.moe = self._moe(cfg, flat) if tp else None
        self.embed = self._vocab(cfg, flat, "embed") if tp else None
        self.head = self._vocab(cfg, flat, "head") if tp else None
        self._layouts: dict[str, TapLayout | None] = {}
        self.recipes = {p: self._recipe(p, s) for p, s in flat.items()}

    # -- which parts split ---------------------------------------------------

    def _splits(self, flat, suffix: str, dim: int) -> bool:
        """Every leaf of the stacks ending in ``suffix`` has "model" (alone)
        on ``dim``."""
        hits = [s for p, s in flat.items() if p.endswith(suffix)]
        return bool(hits) and all(s[dim] == "model" for s in hits)

    def _attn(self, cfg, flat) -> Attn | None:
        H, K, n = cfg.n_heads, cfg.n_kv_heads, self.n
        if (not H or H % n or cfg.d_model % n
                or not (K % n == 0 or n % K == 0)):
            return None
        if not (all(self._splits(flat, f"attn.{w}.w", -1) for w in "qkv")
                and self._splits(flat, "attn.o.w", -2)):
            return None
        if K % n == 0:
            return Attn(H // n, K // n)
        shared = n // K
        return Attn(H // n, 1, shared, self.c // shared)

    def _mlp(self, cfg, flat) -> bool:
        return (bool(cfg.d_ff) and not cfg.n_experts
                and cfg.d_model % self.n == 0
                and self._splits(flat, "mlp.gate.w", -1)
                and self._splits(flat, "mlp.up.w", -1)
                and self._splits(flat, "mlp.down.w", -2))

    def _ssm(self, cfg, flat) -> Ssm | None:
        """The rank's SSD heads, where they and d_model divide over "model"
        and the rules place ``out_proj`` by rows over it."""
        if not cfg.ssm_state:
            return None
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
        if heads % self.n or cfg.d_model % self.n or not self._splits(
                flat, "ssm.out_proj.w", -2):
            return None
        return Ssm(heads // self.n, self.c * (heads // self.n))

    def _moe(self, cfg, flat) -> tuple[int, int] | None:
        """(experts a rank, the first) of the rank's experts, where they
        divide over "model", the rules place every expert leaf by experts
        over it and the dispatch forms slots (einsum, sort)."""
        E = cfg.n_experts
        if not E or E % self.n or cfg.moe_impl == "dense" or not all(
                self._splits(flat, f"moe.{w}", -3)
                for w in ("gate", "up", "down")):
            return None
        return (E // self.n, self.c * (E // self.n))

    def _vocab(self, cfg, flat, use: str) -> tuple[int, int] | None:
        """(first id, ids) of this rank's vocab range for the embedding or
        the head, where its leaf holds the vocab split over "model" (the
        major axis): never with codebooks."""
        if cfg.n_codebooks:
            return None
        if use == "embed":
            path, dim = ("embed.emb", -2)
        elif cfg.embed_input:
            path, dim = ("unembed.emb", -2)
        elif cfg.tie_embeddings:
            path, dim = ("embed.emb", -2)
        else:
            path, dim = ("lm_head.w", -1)
        if path not in flat or not _model_major(flat[path][dim]):
            return None
        size = cfg.vocab_size // self.n
        return (self.c * size, size)

    def _kept(self, path: str) -> int | None:
        """The dim (from the end) a leaf keeps split over "model" for its
        product (a row-placed weight's rows, which ``_recipe`` swaps to
        columns), or None."""
        if self._part(path) is not None and re.search(
                r"\.(q|k|v|o|gate|up|down|out_proj)\.w$", f".{path}"):
            return -2 if f".{path}".endswith(_ROW_PLACED) else -1
        if self.moe and _EXPERTS.search(f".{path}"):
            return -3
        if path == "embed.emb" and self.embed:
            return -2
        if path == "unembed.emb" and self.head:
            return -2
        if path == "lm_head.w" and self.head:
            return -1
        tap, _, leaf = path.rpartition(".")
        if (self._part(tap) is not None and leaf in ("B", "W", "W2")
                and not f".{tap}".endswith(_SSM_IN)):
            return -1
        return None

    def _part(self, name: str) -> str | None:
        """"attn", "mlp", "ssm" or "moe" where the tap or leaf ``name`` lies
        in a split part."""
        for part, on in (("attn", self.attn is not None), ("mlp", self.mlp),
                         ("ssm", self.ssm is not None),
                         ("moe", self.moe is not None)):
            if on and f".{part}." in f".{name}":
                return part
        return None

    def _recipe(self, path: str, spec) -> Recipe:
        kept = self._kept(path)
        nd = len(spec)
        steps = []
        for d, entry in enumerate(spec):
            axes = sh._entry_axes(entry)
            if d - nd == kept and axes and axes[0] != "model":
                raise ValueError(f"{path}: spec {spec} does not hold "
                                 f"\"model\" as the major axis of dim {d}")
            for a in reversed(axes):
                if self.shape[a] > 1 and not (a == "model"
                                              and d - nd == kept):
                    steps.append((d - nd, a))
        partial = self.partial
        # a leaf used inside a split part and not kept split over "model"
        # sees only this rank's share of the part's gradient
        if kept is None and self._part(path) is not None:
            partial = partial + ("model",)
        # a norm scale applied to the rank's rows of the stream
        elif self.seq and _ROW_WISE.search(path):
            partial = partial + ("model",)
        swap = (-2, -1) if kept == -2 and f".{path}".endswith(_ROW_PLACED) \
            else None
        return Recipe(tuple(steps), partial, swap)

    # -- leaves ----------------------------------------------------------------

    def _gather(self, x: torch.Tensor, recipe: Recipe, path: str
                ) -> torch.Tensor:
        for dim, axis in recipe.steps:
            x = _all_gather(x, dim, self.mesh.get_group(axis),
                            self.shape[axis])
        if recipe.swap is not None:
            x = _swap(x, *recipe.swap, self.group, self.n)
        for m in _METERS:
            m.saw(path, x)
        return x

    def take(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """Leaf ``path`` (its stack's path for a layer's slice) in its
        compute layout."""
        recipe = self.recipes.get(path)
        if recipe is None or not (recipe.steps or recipe.swap):
            return x
        if _differentiable(x):
            return _Take.apply(x, self, recipe, path)
        return self._gather(x, recipe, path)

    def take_tree(self, prefix: str, tree):
        if isinstance(tree, dict):
            return {k: self.take_tree(f"{prefix}.{k}" if prefix else k, v)
                    for k, v in tree.items()}
        return self.take(prefix, tree)

    def finish(self, grads: dict) -> dict:
        """Gradients of the rank's leaves (in their blocks) summed over each
        axis they are partial over and no gather of theirs reduced, in
        place."""
        def one(p, g):
            r = self.recipes[sh._path_str(p)]
            gathered = {a for _, a in r.steps}
            for a in r.partial:
                if a not in gathered:
                    dist.all_reduce(g, group=self.mesh.get_group(a))
            return g

        return sh._map(one, grads)

    # -- activations -----------------------------------------------------------

    def copy_in(self, x: torch.Tensor, label: str | None = None
                ) -> torch.Tensor:
        return (_CopyIn.apply(x, self.group, label) if _differentiable(x)
                else x)

    def reduce_out(self, x: torch.Tensor, label: str | None = None
                   ) -> torch.Tensor:
        with _label(label):
            if _differentiable(x):
                return _ReduceOut.apply(x, self.group)
            dist.all_reduce(x, group=self.group)
            return x

    def gather_cols(self, x: torch.Tensor, label: str | None = None
                    ) -> torch.Tensor:
        """The ranks' blocks of x's last dim, gathered (the gradient
        reduce-scattered: each rank's is a partial), both under ``label``
        where given."""
        if _differentiable(x):
            return _GatherCols.apply(x, self.group, self.n, label)
        with _label(label):
            return _all_gather(x, -1, self.group, self.n)

    def gather_out(self, y: torch.Tensor) -> torch.Tensor:
        """A split part's output columns, gathered (the gradient's own
        columns kept: every rank's is the same)."""
        if _differentiable(y):
            return _GatherOut.apply(y, self.group, self.n, self.c)
        return _all_gather(y, -1, self.group, self.n)

    # -- the residual stream by sequence (``seq``) -----------------------------

    def _seq_gather(self, x: torch.Tensor, label: str) -> torch.Tensor:
        with collectives.labelled(label):
            return _all_gather(x, _SEQ, self.group, self.n)

    def _seq_scatter(self, x: torch.Tensor, label: str) -> torch.Tensor:
        with collectives.labelled(label):
            return _scatter_sum(x, _SEQ, self.group, self.n)

    def _cols_to_rows(self, y: torch.Tensor) -> torch.Tensor:
        with collectives.labelled("seq.out"):
            return _swap(y, -1, _SEQ, self.group, self.n)

    def _gathered(self, x: torch.Tensor, summed: bool, label: str
                  ) -> torch.Tensor:
        """The rank's rows gathered over the sequence (``_SeqGather``)."""
        if _differentiable(x):
            return _SeqGather.apply(x, self, summed, label)
        return self._seq_gather(x, label)

    def seq_in(self, x: torch.Tensor) -> torch.Tensor:
        """A split part's input: under ``seq`` the rank's rows all-gathered
        over the sequence (the gradient reduce-scattered: each rank's
        columns give a partial), else ``copy_in``."""
        if not self.seq:
            return self.copy_in(x)
        return self._gathered(x, True, "seq.in")

    def seq_out(self, y: torch.Tensor) -> torch.Tensor:
        """A split part's output columns: under ``seq`` the rank's rows of
        every column (an all-to-all), else ``gather_out``."""
        if not self.seq:
            return self.gather_out(y)
        if _differentiable(y):
            return _ColsToRows.apply(y, self)
        return self._cols_to_rows(y)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated part's input: under ``seq`` the rank's rows
        all-gathered over the sequence (the gradient's own rows kept: every
        rank's is the same), else ``x``."""
        return self._gathered(x, False, "seq.gather") if self.seq else x

    def keep_rows(self, y: torch.Tensor) -> torch.Tensor:
        """A replicated part's (whole) output: under ``seq`` the rank's rows
        (the rows' gradients all-gathered), else ``y``."""
        if not self.seq:
            return y
        if _differentiable(y):
            return _SeqKeep.apply(y, self)
        return _own(y, _SEQ, self.n, self.c)

    def scatter_rows(self, x: torch.Tensor, label: str = "seq.embed"
                     ) -> torch.Tensor:
        """Partial sums over "model" (the vocab-split embedding's lookups,
        the experts' shares of the MoE output): under ``seq`` the rank's
        rows of the sum (a reduce-scatter over the sequence, the gradient
        all-gathered, both under ``label``), else all of it
        (``reduce_out``)."""
        if not self.seq:
            return self.reduce_out(x)
        if _differentiable(x):
            return _SeqScatter.apply(x, self, label)
        return self._seq_scatter(x, label)

    # -- the MoE FFN -------------------------------------------------------------

    def moe_in(self, x: torch.Tensor) -> torch.Tensor:
        """The MoE FFN's input: its batch rank's tokens on every rank of
        "model" (``seq_in``'s under the sequence split, else ``copy_in``);
        the gradient, each rank's experts' partial, summed."""
        if self.moe is None:
            return self.gather_rows(x)
        if self.seq:
            return self._gathered(x, True, "moe.in")
        return self.copy_in(x, "moe.in")

    def moe_out(self, y: torch.Tensor) -> torch.Tensor:
        """The MoE FFN's output, each rank's experts' share: summed over
        "model" (the rank's rows under the sequence split)."""
        if self.moe is None:
            return self.keep_rows(y)
        if not self.seq:
            return self.reduce_out(y, "moe.out")
        return self.scatter_rows(y, "moe.out")

    def moe_split(self) -> M.Split | None:
        """The MoE call's place across ranks (``models.moe.Split``): the
        batch ranks over which its rows are split (``partial``, major axis
        first) and this rank's index among them, and its experts; None
        where the rank holds every row and every expert."""
        if not self.partial and self.moe is None:
            return None
        ranks, index = 1, 0
        for a in self.partial:
            ranks, index = ranks * self.shape[a], index * self.shape[a] \
                + self.coord[a]
        return M.Split(ranks=ranks, index=index,
                       gather=self._batch_gather if self.partial else None,
                       expert0=self.moe[1] if self.moe else 0,
                       aux_grad=self.moe is None or self.c == 0)

    def _batch_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of every batch rank, stacked on a new dim 0 in their order
        (the minor axis gathered first)."""
        t = t[None]
        with collectives.labelled("moe.counts"):
            for a in reversed(self.partial):
                t = _all_gather(t, 0, self.mesh.get_group(a), self.shape[a])
        return t

    def kv_heads(self, y: torch.Tensor, d_head: int) -> torch.Tensor:
        """The k or v product's columns of this rank's KV heads (its own
        block, or a copy of the shared head's out of the gathered columns:
        the kernels take contiguous K and V)."""
        a = self.attn
        if a.shared == 1:
            return y
        return self.gather_cols(y).narrow(-1, a.kv_head * d_head,
                                          d_head).contiguous()

    def whole_kv_heads(self, t: torch.Tensor) -> torch.Tensor:
        """A prefill's (..., Kl, Dh) local K or V with every KV head, for the
        cache's placement (no gradient)."""
        t = _all_gather(t, -2, self.group, self.n)
        if self.attn.shared > 1:
            t = t[..., ::self.attn.shared, :]
        return t

    def whole_heads(self, y: torch.Tensor) -> torch.Tensor:
        """A decode tick's q, k or v product (the rank's columns under a
        split attention) with every head's columns."""
        return y if self.attn is None else self.gather_cols(y)

    def merge_blocks(self, o: torch.Tensor, lse: torch.Tensor,
                     split: CacheSplit) -> torch.Tensor:
        """Every rank's (o, lse) of its cache block, all-gathered over the
        split's axes (the minor first, so block c lands at c) and merged
        (``merge``): the whole cache's attention, o in f32."""
        o, lse = o[None], lse[None]
        for a in reversed(split.axes):
            n, g = self.shape[a], self.mesh.get_group(a)
            if n > 1:
                o, lse = _all_gather(o, 0, g, n), _all_gather(lse, 0, g, n)
        return merge(o, lse)[0]

    def tap_layout(self, tap: str) -> TapLayout | None:
        """The tap's Mode-A blocks where the plan splits over "model"."""
        if self.n == 1:
            return None
        if tap not in self._layouts:
            self._layouts[tap] = self._tap_layout(tap)
        return self._layouts[tap]

    def _block(self, width: int) -> tuple[int, int] | None:
        if width % self.n:
            return None
        size = width // self.n
        return (self.c * size, (self.c + 1) * size)

    def _tap_layout(self, tap: str) -> TapLayout:
        site = self.sites[tap]
        x_block = self._block(site.d_in)
        part = self._part(tap)
        if part is not None and not f".{tap}".endswith(_SSM_IN):
            return TapLayout(x_block, None)   # y is this rank's block already
        out = self._block(site.d_out)
        return TapLayout(x_block, out and (out[0], out[1], site.d_out),
                         self.group if part is not None else None)

    def delta_width(self, width: int) -> int:
        """A Mode-A delta's last dim on this rank: its block under
        ``delta_shardings``."""
        if width % self.n:
            return width
        return width // self.n


class gather_meter:
    """While active, ``bytes`` counts every leaf gather's result: the
    gathered leaves a step's products read; ``shapes``, {leaf path: the
    shapes it was gathered to}, and ``by_leaf``, {leaf path: bytes}."""

    def __init__(self):
        self.bytes = 0
        self.shapes: dict[str, set] = {}
        self.by_leaf: dict[str, int] = {}

    def saw(self, path: str, x: torch.Tensor) -> None:
        n = x.numel() * x.element_size()
        self.bytes += n
        self.by_leaf[path] = self.by_leaf.get(path, 0) + n
        self.shapes.setdefault(path, set()).add(tuple(x.shape))

    def __enter__(self) -> "gather_meter":
        _METERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _METERS.remove(self)


# ---------------------------------------------------------------------------
# what the model asks
# ---------------------------------------------------------------------------

def current() -> Plan | None:
    r = sh.current_rules()
    return r.plan if r is not None else None


def take(path: str, x: torch.Tensor) -> torch.Tensor:
    p = current()
    return x if p is None else p.take(path, x)


def take_layer(prefix: str, params: dict, adapters: dict
               ) -> tuple[dict, dict]:
    """One layer's parameters (of stack ``prefix``) and adapters ({tap:
    leaves}) in their compute layouts."""
    p = current()
    if p is None:
        return params, adapters
    return p.take_tree(prefix, params), p.take_tree("", adapters)


def tap_layout(tap: str | None) -> TapLayout | None:
    p = current()
    return None if p is None or tap is None else p.tap_layout(tap)


def attention() -> Plan | None:
    """The plan where the attention is split over "model", else None."""
    p = current()
    return p if p is not None and p.attn is not None else None


def mlp() -> Plan | None:
    p = current()
    return p if p is not None and p.mlp else None


def embed_lookup(emb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``emb[ids]`` (``emb`` in its compute layout): over a vocab split, the
    rank's range looked up, zero elsewhere, summed over "model" (exact: one
    term is not zero). Under a sequence split, the rank's rows of it."""
    p = current()
    if p is None:
        return emb[ids.long()]
    if p.embed is None:
        return p.keep_rows(emb[ids.long()])
    lo, size = p.embed
    idx = ids.long() - lo
    mine = (idx >= 0) & (idx < size)
    x = emb[idx.clamp(0, size - 1)].masked_fill(~mine[..., None], 0)
    return p.scatter_rows(x)


def moe_in(x: torch.Tensor) -> torch.Tensor:
    """The MoE FFN's input (``Plan.moe_in``), or ``x`` without a plan."""
    p = current()
    return x if p is None else p.moe_in(x)


def moe_out(y: torch.Tensor) -> torch.Tensor:
    p = current()
    return y if p is None else p.moe_out(y)


def moe_split() -> M.Split | None:
    p = current()
    return None if p is None else p.moe_split()


def replicated_in(x: torch.Tensor) -> torch.Tensor:
    """The input of a part that every rank of "model" computes whole: the
    whole sequence (``Plan.gather_rows``)."""
    p = current()
    return x if p is None else p.gather_rows(x)


def replicated_out(y: torch.Tensor) -> torch.Tensor:
    """The output of such a part, or any tensor every rank holds whole: the
    rank's rows (``Plan.keep_rows``)."""
    p = current()
    return y if p is None else p.keep_rows(y)


def whole_sequence(h: torch.Tensor) -> torch.Tensor:
    """The final norm's output for the head and the loss, which see the
    whole sequence: under a sequence split the rank's rows all-gathered
    (the gradient reduce-scattered where the head splits the vocab, each
    rank's columns giving a partial; the own rows kept where every rank
    computes the whole head), else ``h``."""
    p = current()
    if p is None or not p.seq:
        return h
    return p._gathered(h, p.head is not None, "seq.head")


def take_positions(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, 1, d): row b's hidden state at whole-sequence position idx[b].
    Under a sequence split ``h`` is the rank's rows: each rank takes the
    positions its block holds, zero elsewhere, summed over "model" (exact:
    one term is not zero)."""
    rows = torch.arange(h.shape[0], device=h.device)
    p = current()
    if p is None or not p.seq:
        return h[rows, idx][:, None]
    size = h.shape[_SEQ]
    j = idx - p.c * size
    mine = (j >= 0) & (j < size)
    x = h[rows, j.clamp(0, size - 1)].masked_fill(~mine[:, None], 0)
    with collectives.labelled("seq.pick"):
        return p.reduce_out(x[:, None])


def head_input(h: torch.Tensor) -> torch.Tensor:
    """The head's input: ``copy_in`` where the logits are the rank's vocab
    columns (under a sequence split ``whole_sequence`` has reduced the
    gradient already)."""
    p = current()
    return h if p is None or p.head is None or p.seq else p.copy_in(h)


def ssm() -> Plan | None:
    """The plan where the Mamba2 mixer's heads are split over "model", else
    None."""
    p = current()
    return p if p is not None and p.ssm is not None else None


def conv_state(stack: str, conv: torch.Tensor) -> torch.Tensor:
    """A Mamba2 layer's conv state (b, W - 1, C) with every channel: where
    the serve step holds the rank's channel block of stack ``stack``'s, the
    ranks' blocks gathered over the axes that split them, the minor first
    (labelled "cache.<stack>.conv"), else ``conv`` itself."""
    p = current()
    axes = () if p is None else p.conv_blocks.get(stack, ())
    with collectives.labelled(f"cache.{stack}.conv"):
        for a in reversed(axes):
            conv = _all_gather(conv, -1, p.mesh.get_group(a), p.shape[a])
    return conv


def own_channels(stack: str, conv: torch.Tensor) -> torch.Tensor:
    """The rank's block of a whole conv state where ``conv_state`` gathered
    it, else ``conv``."""
    p = current()
    axes = () if p is None else p.conv_blocks.get(stack, ())
    n, idx = 1, 0
    for a in axes:
        idx, n = idx * p.shape[a] + p.coord[a], n * p.shape[a]
    return _own(conv, -1, n, idx) if n > 1 else conv


def vocab_head() -> Plan | None:
    p = current()
    return p if p is not None and p.head is not None else None


def cache_split(stack: str) -> CacheSplit | None:
    """Stack ``stack``'s cache split by sequence in the serve step, else
    None."""
    p = current()
    return None if p is None else p.cache_splits.get(stack)


def vocab_argmax(p: Plan, logits: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(logits, -1)`` of the whole vocab, int32, from ``logits``
    (..., V / n) the rank's columns: each rank's largest value and its first
    index, all-gathered over "model"; the first rank holding the largest
    value gives the index (the whole row's first, as ``torch.argmax``)."""
    lo, _ = p.head
    val, idx = logits.amax(dim=-1), logits.argmax(dim=-1)
    vals = _all_gather(val[None], 0, p.group, p.n)
    idxs = _all_gather((idx + lo).to(torch.int32)[None], 0, p.group, p.n)
    first = (vals == vals.amax(dim=0)).to(torch.int8).argmax(dim=0)
    return idxs.gather(0, first[None])[0]


def vocab_ce(p: Plan, lf: torch.Tensor, labels: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``model._ce`` over logits split by vocab over "model": ``lf`` (...,
    V / n) f32 the rank's columns. The max and the sum of exponentials are
    taken over "model"; the label's logit comes from the rank that holds it.
    The value is the whole vocab's, on every rank; the gradient is this
    rank's columns'."""
    lo, size = p.head
    m = lf.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=p.group)
    se = p.reduce_out(torch.exp(lf - m[..., None]).sum(dim=-1))
    lse = torch.log(se) + m
    idx = labels.long() - lo
    mine = (idx >= 0) & (idx < size)
    ll = torch.gather(lf, -1, idx.clamp(0, size - 1)[..., None])[..., 0]
    ll = p.reduce_out(torch.where(mine, ll, torch.zeros_like(ll)))
    valid = labels >= 0
    ce = torch.where(valid, lse - ll, torch.zeros_like(lse))
    return ce.sum(), valid.sum().to(torch.float32)
