"""Top-k routed Mixture-of-Experts (qwen3-moe, dbrx), a port of the JAX
package's ``models/moe.py`` under its names.

Dispatches (``moe_impl``):

- ``einsum``: GShard's one-hot dispatch and combine einsums over groups of
  ``group`` tokens, with per-group expert capacity; both MoE configs' impl.
- ``sort``: tokens argsorted by expert id, gathered into an (E, C, d)
  buffer, run through the experts and summed back per token.
- ``dense``: every expert on every token, weighted by the router (a debug
  path for tiny configs).

All three share the router (f32 logits, softmax, top-k, renormalised) and
the switch-style load-balancing aux loss. The products are plain PyTorch
(the JAX package computes them outside any Pallas kernel); the JAX
package's sharding constraints are the identity on one card and are left
out. The aux loss's two means over tokens go through
``sharding.batch_mean``: ``mean(dim=0)`` on one device, the whole batch's
when a distributed step splits the rows over ranks.

In a distributed step (``Split``, from ``distributed.tensor_parallel``)
the einsum and sort dispatches form their groups and capacities over the
call's whole (micro)batch, as one device does, however its rows split over
the batch ranks, and a rank of an expert-parallel step fills and runs only
its own experts' slots. Routing and accounting (``gshard_combine``,
``sort_slots``) are one code path for both; without a ``Split`` (one
device) they count over the whole call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.utils import cdiv


def moe_init(n: int, d_model: int, n_experts: int, d_expert: int, *,
             normal, normal_by_layer) -> dict:
    """One stack's MoE parameters, layer leaves on a leading (n,) axis: the
    router as a dense layer, each expert leaf (n, E, d_in, d_out) at scale
    d_in^-0.5. ``normal(shape, std)`` draws a leaf; ``normal_by_layer``
    draws it a layer at a time into a tensor already in the parameter dtype
    (an expert leaf's f32 draw at once does not fit beside the rest)."""
    def experts(d_in, d_out):
        return normal_by_layer((n, n_experts, d_in, d_out), d_in ** -0.5)

    return {
        "router": {"w": normal((n, d_model, n_experts), d_model ** -0.5)},
        "gate": experts(d_model, d_expert),
        "up": experts(d_model, d_expert),
        "down": experts(d_expert, d_model),
    }


def _route(params: dict, x: torch.Tensor, top_k: int):
    """x: (..., d). Returns (weights (..., k) f32, expert ids (..., k), the
    aux loss): f32 router logits, softmax, top-k, renormalised; the aux is
    E * sum_e (mean router probability of e) * (share of choices to e) over
    all tokens (the whole batch's, when a distributed step splits its rows
    over ranks)."""
    logits = x.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    E = logits.shape[-1]
    me = sharding.batch_mean(probs.reshape(-1, E))
    one_hot = F.one_hot(idx.reshape(-1, top_k), E).float()
    ce = sharding.batch_mean(one_hot.sum(dim=1)) / top_k
    return w, idx, E * (me * ce).sum()


def _expert_ffn(params: dict, h: torch.Tensor) -> torch.Tensor:
    """h: (..., E, C, d) -> (..., E, C, d) through each expert's gated
    MLP."""
    g = torch.einsum("...ecd,edf->...ecf", h, params["gate"].to(h.dtype))
    u = torch.einsum("...ecd,edf->...ecf", h, params["up"].to(h.dtype))
    return torch.einsum("...ecf,efd->...ecd", F.silu(g) * u,
                        params["down"].to(h.dtype))


# ---------------------------------------------------------------------------
# where a call's tokens and experts lie across ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """One MoE call's place in a distributed step (``tensor_parallel.Plan``
    makes it; None: one device's call, every token and expert here).

    ``ranks``: the batch ranks over which the call's (micro)batch rows are
    split, each holding as many, this one the ``index``-th block;
    ``gather``: all-gathers a small tensor over them, (...) -> (ranks, ...)
    in their order (None where ``ranks`` is 1); ``expert0``: the first
    expert this rank runs (it runs as many as its expert leaves hold);
    ``aux_grad``: whether the aux loss's gradient flows from this rank,
    where several compute it on the same tokens (one of them counts it)."""
    ranks: int = 1
    index: int = 0
    gather: Callable | None = None
    expert0: int = 0
    aux_grad: bool = True

    def before_and_all(self, local: torch.Tensor):
        """Every batch rank's ``local`` (this rank's counts) gathered: the
        sum over the ranks before this one and over all of them."""
        every = self.gather(local)
        return every[:self.index].sum(dim=0), every.sum(dim=0)


def _local(params: dict, split: Split | None) -> tuple[int, int]:
    """(the first expert this call runs, how many): its expert leaves'."""
    return (0 if split is None else split.expert0,
            params["gate"].shape[-3])


def _aux(aux: torch.Tensor, split: Split | None) -> torch.Tensor:
    return aux if split is None or split.aux_grad else aux.detach()


# ---------------------------------------------------------------------------
# einsum (GShard) dispatch
# ---------------------------------------------------------------------------

def einsum_combine(w: torch.Tensor, idx: torch.Tensor, *, C: int,
                   expert0: int, experts: int, before=None, others=None
                   ) -> torch.Tensor:
    """The combine weights (NG, G, experts, C) f32 of groups of G tokens
    into experts [expert0, expert0 + experts): w, idx (NG, G, k) each
    token's weights and expert ids (id -1: a padding token, routed
    nowhere). Positions in an expert are counted choice by choice (choice 0
    of every token of the group before choice 1), GShard's order; a choice
    at position C or past it is dropped. ``before`` / ``others`` (NG, k,
    experts): where a group spans batch ranks, its choices of each expert
    on the ranks before this one, and on every other rank."""
    NG, G, k = idx.shape
    dev = idx.device
    ex = torch.arange(expert0, expert0 + experts, device=dev)
    slots = torch.arange(C, device=dev)
    combine = torch.zeros((NG, G, experts, C), dtype=torch.float32,
                          device=dev)
    prev_counts = torch.zeros((NG, 1, experts), dtype=torch.float32,
                              device=dev)
    for j in range(k):
        mask_j = (idx[..., j, None] == ex).float()                  # (B, S, E)
        pos_j = torch.cumsum(mask_j, dim=1) - mask_j + prev_counts  # (B, S, E)
        prev_counts = prev_counts + mask_j.sum(dim=1, keepdim=True)
        if before is not None:
            pos_j = pos_j + before[:, None, j]
            prev_counts = prev_counts + others[:, None, j]
        in_cap = (pos_j < C).float() * mask_j
        # a position at or past C matches no slot: the token is dropped
        # (F.one_hot would raise there)
        pos_oh = (pos_j.long()[..., None] == slots).float()
        combine = combine + (w[..., j, None, None] * in_cap[..., None] * pos_oh)
    return combine


def gshard_combine(w: torch.Tensor, idx: torch.Tensor, *, G: int, C: int,
                   expert0: int, experts: int, split: Split | None = None
                   ) -> tuple[torch.Tensor, int]:
    """(combine, pad): ``einsum_combine`` of this rank's n tokens (w, idx
    (n, k)) in the call's groups of G tokens, the rank's tokens from
    position ``pad`` of its first group. Under a ``split`` whose batch
    ranks share a group the rank's groups are zero-padded around its tokens
    (id -1), and every rank's choices of each expert of its groups are
    all-gathered, so a position counts the other ranks' choices as one
    device does."""
    n, k = idx.shape
    ranks, index = (1, 0) if split is None else (split.ranks, split.index)
    first = index * n
    g0 = first // G
    NG = cdiv(first + n, G) - g0
    pad = first - g0 * G
    tail = NG * G - pad - n
    before = others = None
    if pad or tail:
        w = torch.cat([w.new_zeros((pad, k)), w, w.new_zeros((tail, k))])
        idx = torch.cat([idx.new_full((pad, k), -1), idx,
                         idx.new_full((tail, k), -1)])
        ex = torch.arange(expert0, expert0 + experts, device=idx.device)
        mine = (idx.reshape(NG, G, k, 1) == ex).float().sum(dim=1)
        local = mine.new_zeros((ranks * n // G, k, experts))
        local[g0:g0 + NG] = mine
        before, total = split.before_and_all(local)
        before, others = before[g0:g0 + NG], total[g0:g0 + NG] - mine
    return einsum_combine(w.reshape(NG, G, k), idx.reshape(NG, G, k), C=C,
                          expert0=expert0, experts=experts, before=before,
                          others=others), pad


def moe_einsum(params: dict, x: torch.Tensor, *, top_k: int,
               capacity_factor: float = 1.25, group: int = 512,
               split: Split | None = None):
    """x: (B, S, d) -> ((B, S, d), aux). Tokens are dispatched in groups of
    ``group`` when the call's tokens divide into them (a group may then
    span rows), else a row at a time; each expert takes at most
    C = max(top_k, ceil(int(G * top_k * capacity_factor) / E)) tokens of a
    group (``einsum_combine``). Under a ``split`` the groups and C are the
    whole call's (``gshard_combine``): the slots of the other batch ranks'
    tokens stay zero rows of this rank's buffer (the expert MLP is
    row-wise, so they give zero output and gradient), and it runs its own
    experts only, the output its experts' share of every token's."""
    Bz0, S0, d = x.shape
    n = Bz0 * S0
    E = params["router"]["w"].shape[-1]
    T = n * (1 if split is None else split.ranks)
    G = group if T % group == 0 else S0
    C = max(top_k, cdiv(int(G * top_k * capacity_factor), E))
    e0, El = _local(params, split)
    w, idx, aux = _route(params, x, top_k)            # (B, S, k)
    combine, pad = gshard_combine(w.reshape(n, top_k), idx.reshape(n, top_k),
                                  G=G, C=C, expert0=e0, experts=El,
                                  split=split)
    NG = combine.shape[0]
    x = x.reshape(n, d)
    if NG * G > n:
        x = torch.cat([x.new_zeros((pad, d)), x,
                       x.new_zeros((NG * G - pad - n, d))])
    x = x.reshape(NG, G, d)
    dispatch = (combine > 0).to(x.dtype)                             # (B, S, E, C)

    h = torch.einsum("bsec,bsd->becd", dispatch, x)                  # (B, E, C, d)
    y = _expert_ffn(params, h)
    out = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), y)
    out = out.reshape(NG * G, d)[pad:pad + n]
    return out.reshape(Bz0, S0, d), _aux(aux, split)


# ---------------------------------------------------------------------------
# sort-based dispatch
# ---------------------------------------------------------------------------

def sort_slots(idx: torch.Tensor, *, E: int, C: int, expert0: int,
               experts: int, split: Split | None = None):
    """idx (n, k): this rank's n tokens' expert ids. Returns (sort_idx,
    slot): the n k choices in expert order (stably: token, then choice)
    and each one's row of the (experts, C) buffer of experts [expert0,
    expert0 + experts), its position in its expert counted in that order;
    ``experts * C`` for a choice of another expert or at position C or
    past it (dropped). Under a ``split`` the order is the whole call's:
    every batch rank's choices of each expert are all-gathered, the ranks
    before this one's counted first."""
    flat_e = idx.reshape(-1)                          # (T k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    # the counts by a scatter, not bincount: its size is E whatever the ids
    counts = torch.zeros(E, dtype=torch.long, device=idx.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(0) - counts
    pos = torch.arange(flat_e.shape[0], device=idx.device) - offsets[sorted_e]
    if split is not None and split.ranks > 1:
        pos = pos + split.before_and_all(counts)[0][sorted_e]
    keep = ((pos >= 0) & (pos < C) & (sorted_e >= expert0)
            & (sorted_e < expert0 + experts))
    slot = torch.where(keep, (sorted_e - expert0) * C + pos, experts * C)
    return sort_idx, slot


def moe_sort(params: dict, x: torch.Tensor, *, top_k: int,
             capacity_factor: float = 1.25, split: Split | None = None):
    """x: (B, S, d) -> ((B, S, d), aux). The T * k choices sorted by expert
    id (stably), each expert's first C = max(top_k, ceil(int(T * top_k *
    capacity_factor) / E)) kept; the rest are dropped (``sort_slots``). A
    token's k weighted expert outputs are summed in choice order, never by
    atomics, so the bits are the same in every run (and in a layer's
    recompute). Under a ``split`` T and the order are the whole call's, and
    the rank fills and runs the (E / n, C, d) buffer of its own experts,
    the output its experts' share of every token's."""
    Bz, S, d = x.shape
    E = params["router"]["w"].shape[-1]
    n = Bz * S
    T = n * (1 if split is None else split.ranks)
    C = max(top_k, cdiv(int(T * top_k * capacity_factor), E))
    e0, El = _local(params, split)
    xf = x.reshape(n, d)
    w, idx, aux = _route(params, xf, top_k)           # (T, k)

    dev = x.device
    sort_idx, slot = sort_slots(idx, E=E, C=C, expert0=e0, experts=El,
                                split=split)
    keep = slot < El * C
    token_id = sort_idx // top_k                      # source token per slot

    # each buffer row's source token (n: a zero row); only the dropped
    # choices share an index, the discarded sentinel El C
    src = torch.full((El * C + 1,), n, dtype=torch.long, device=dev)
    src[slot] = token_id
    buf = torch.cat([xf, xf.new_zeros((1, d))])[src[:El * C]]
    y = _expert_ffn(params, buf.reshape(El, C, d)).reshape(El * C, d)
    contrib = y[slot.clamp(max=El * C - 1)] * torch.where(
        keep, w.reshape(-1)[sort_idx], 0.0)[:, None].to(x.dtype)
    # back to (token, choice) order through the inverse permutation
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(n * top_k, device=dev)
    out = contrib[inv].reshape(n, top_k, d).sum(dim=1)
    return out.reshape(Bz, S, d), _aux(aux, split)


def moe_block(params: dict, x: torch.Tensor, *, top_k: int,
              impl: str = "sort", capacity_factor: float = 1.25,
              group: int = 512, split: Split | None = None):
    """x: (B, S, d) -> ((B, S, d), aux) through the dispatch ``impl``
    (``split``: the call's place in a distributed step; the dense path
    forms no groups or capacities and takes every expert)."""
    if impl == "einsum":
        return moe_einsum(params, x, top_k=top_k,
                          capacity_factor=capacity_factor, group=group,
                          split=split)
    if impl == "sort":
        return moe_sort(params, x, top_k=top_k,
                        capacity_factor=capacity_factor, split=split)
    if impl == "dense":   # debug: every expert on every token (tiny configs)
        w, idx, aux = _route(params, x, top_k)
        E = params["router"]["w"].shape[-1]
        experts = torch.arange(E, device=x.device)
        hw = torch.zeros(x.shape[:-1] + (E,), dtype=torch.float32,
                         device=x.device)
        for j in range(top_k):
            hw = hw + w[..., j, None] * (idx[..., j, None] == experts).float()
        g = torch.einsum("bsd,edf->bsef", x, params["gate"].to(x.dtype))
        u = torch.einsum("bsd,edf->bsef", x, params["up"].to(x.dtype))
        y = torch.einsum("bsef,efd->bsed", F.silu(g) * u,
                         params["down"].to(x.dtype))
        return torch.einsum("bsed,bse->bsd", y, hw.to(x.dtype)), aux
    raise ValueError(f"unknown moe impl {impl!r}")
