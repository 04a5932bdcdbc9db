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
out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    all tokens."""
    logits = x.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    E = logits.shape[-1]
    me = probs.reshape(-1, E).mean(dim=0)
    one_hot = F.one_hot(idx.reshape(-1, top_k), E).float()
    ce = one_hot.sum(dim=1).mean(dim=0) / top_k
    return w, idx, E * (me * ce).sum()


def _expert_ffn(params: dict, h: torch.Tensor) -> torch.Tensor:
    """h: (..., E, C, d) -> (..., E, C, d) through each expert's gated
    MLP."""
    g = torch.einsum("...ecd,edf->...ecf", h, params["gate"].to(h.dtype))
    u = torch.einsum("...ecd,edf->...ecf", h, params["up"].to(h.dtype))
    return torch.einsum("...ecf,efd->...ecd", F.silu(g) * u,
                        params["down"].to(h.dtype))


# ---------------------------------------------------------------------------
# einsum (GShard) dispatch
# ---------------------------------------------------------------------------

def moe_einsum(params: dict, x: torch.Tensor, *, top_k: int,
               capacity_factor: float = 1.25, group: int = 512):
    """x: (B, S, d) -> ((B, S, d), aux). Tokens are dispatched in groups of
    ``group`` when the B * S tokens divide into them (a group may then span
    rows), else a row at a time; each expert takes at most
    C = max(top_k, ceil(int(S * top_k * capacity_factor) / E)) tokens of a
    group. Positions in an expert are counted choice by choice (choice 0 of
    every token of the group before choice 1); a token past an expert's
    capacity is dropped from it."""
    Bz0, S0, d = x.shape
    T = Bz0 * S0
    G = group if T % group == 0 else S0
    x = x.reshape(T // G, G, d)
    Bz, S, _ = x.shape
    E = params["router"]["w"].shape[-1]
    C = max(top_k, cdiv(int(S * top_k * capacity_factor), E))
    w, idx, aux = _route(params, x, top_k)            # (B, S, k)

    experts = torch.arange(E, device=x.device)
    slots = torch.arange(C, device=x.device)
    combine = torch.zeros((Bz, S, E, C), dtype=torch.float32, device=x.device)
    prev_counts = torch.zeros((Bz, 1, E), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        mask_j = (idx[..., j, None] == experts).float()             # (B, S, E)
        pos_j = torch.cumsum(mask_j, dim=1) - mask_j + prev_counts  # (B, S, E)
        prev_counts = prev_counts + mask_j.sum(dim=1, keepdim=True)
        in_cap = (pos_j < C).float() * mask_j
        # a position at or past C matches no slot: the token is dropped
        # (F.one_hot would raise there)
        pos_oh = (pos_j.long()[..., None] == slots).float()
        combine = combine + (w[..., j, None, None] * in_cap[..., None] * pos_oh)
    dispatch = (combine > 0).to(x.dtype)                             # (B, S, E, C)

    h = torch.einsum("bsec,bsd->becd", dispatch, x)                  # (B, E, C, d)
    y = _expert_ffn(params, h)
    out = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), y)
    return out.reshape(Bz0, S0, d), aux


# ---------------------------------------------------------------------------
# sort-based dispatch
# ---------------------------------------------------------------------------

def moe_sort(params: dict, x: torch.Tensor, *, top_k: int,
             capacity_factor: float = 1.25):
    """x: (B, S, d) -> ((B, S, d), aux). The T * k choices sorted by expert
    id (stably), each expert's first C = max(top_k, ceil(int(T * top_k *
    capacity_factor) / E)) kept; the rest are dropped. A token's k weighted
    expert outputs are summed in choice order, never by atomics, so the
    bits are the same in every run (and in a layer's recompute)."""
    Bz, S, d = x.shape
    E = params["router"]["w"].shape[-1]
    T = Bz * S
    C = max(top_k, cdiv(int(T * top_k * capacity_factor), E))
    xf = x.reshape(T, d)
    w, idx, aux = _route(params, xf, top_k)           # (T, k)

    dev = x.device
    flat_e = idx.reshape(-1)                          # (T k,)
    flat_w = w.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    token_id = sort_idx // top_k                      # source token per slot

    counts = torch.bincount(flat_e, minlength=E)
    offsets = counts.cumsum(0) - counts
    pos = torch.arange(T * top_k, device=dev) - offsets[sorted_e]
    valid = pos < C
    slot = torch.where(valid, sorted_e * C + pos, E * C)   # E C: dropped

    # each buffer row's source token (T: a zero row); only the dropped
    # choices share an index, the discarded sentinel E C
    src = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    src[slot] = token_id
    buf = torch.cat([xf, xf.new_zeros((1, d))])[src[:E * C]]
    y = _expert_ffn(params, buf.reshape(E, C, d)).reshape(E * C, d)
    contrib = y[slot.clamp(max=E * C - 1)] * torch.where(
        valid, flat_w[sort_idx], 0.0)[:, None].to(x.dtype)
    # back to (token, choice) order through the inverse permutation
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(T * top_k, device=dev)
    out = contrib[inv].reshape(T, top_k, d).sum(dim=1)
    return out.reshape(Bz, S, d), aux


def moe_block(params: dict, x: torch.Tensor, *, top_k: int,
              impl: str = "sort", capacity_factor: float = 1.25,
              group: int = 512):
    """x: (B, S, d) -> ((B, S, d), aux) through the dispatch ``impl``."""
    if impl == "einsum":
        return moe_einsum(params, x, top_k=top_k,
                          capacity_factor=capacity_factor, group=group)
    if impl == "sort":
        return moe_sort(params, x, top_k=top_k,
                        capacity_factor=capacity_factor)
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
