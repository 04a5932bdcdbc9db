"""Auxiliary models g_w (the paper's model-agnostic adapters).

Families
--------
- ``lowrank``       : g(x) = (x @ A) @ B            (== LoRA; mergeable, Prop 2)
- ``linear``        : g(x) = x @ W                  (== full delta-W; mergeable)
- ``mlp``           : g(x) = relu(x @ W1 + b1) @ W2  (not mergeable: nonlinear in x)
- ``multi_lowrank`` : FTaaS serving, one adapter per request inside one batch
  (multi-LoRA through ``kernels.ops.multi_lora``).

Adapters are dicts of tensors. Stacked taps carry a leading (L,) axis on every
leaf; ``apply`` takes one layer's slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import remat

MERGEABLE = {"lowrank": True, "linear": True, "mlp": False,
             "multi_lowrank": False}
FAMILIES = tuple(MERGEABLE)


def init(family: str, gen: torch.Generator, d_in: int, d_out: int, *,
         rank: int = 8, hidden: int = 128, dtype=torch.float32,
         lead: tuple[int, ...] = (), device=None) -> dict:
    """Adapter params with g(x) == 0 at t = 0 (paper Alg. 1 init), drawn from
    ``gen`` on its own device and moved to ``device`` (default: the
    generator's). ``lead`` prepends axes (the layer axis of a stacked tap) to
    every leaf. The draws differ from ``jax.random``'s; tests carry JAX
    adapters across with ``convert.adapters_from_numpy``. On the meta device
    nothing is drawn (shapes and dtypes only)."""
    device = gen.device if device is None else device

    def normal(*shape, fan):
        if torch.device(device).type == "meta":
            return torch.empty(lead + shape, dtype=dtype, device="meta")
        w = torch.randn(lead + shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w / fan ** 0.5).to(device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    if family == "lowrank":
        return {"A": normal(d_in, rank, fan=rank), "B": zeros(rank, d_out)}
    if family == "linear":
        return {"W": zeros(d_in, d_out)}
    if family == "mlp":
        return {"W1": normal(d_in, hidden, fan=d_in), "b1": zeros(hidden),
                "W2": zeros(hidden, d_out)}
    raise ValueError(f"unknown adapter family: {family!r}")


def apply(family: str, w: dict, x: torch.Tensor, *, keep: bool = True
          ) -> torch.Tensor:
    """g_w(x). x: (..., d_in) -> (..., d_out). Computes in x.dtype. Under
    remat "dots" (``models.remat``) the last product is kept where
    ``keep``, lowrank's ``x @ A`` where ``B`` takes a gradient (the
    backward reads it for dB only) and mlp's ``x @ W1`` always (relu's
    backward reads it)."""
    if family == "lowrank":
        xa = remat.matmul(x, w["A"].to(x.dtype), w["B"].requires_grad)
        return remat.matmul(xa, w["B"].to(x.dtype), keep)
    if family == "linear":
        return remat.matmul(x, w["W"].to(x.dtype), keep)
    if family == "mlp":
        h = torch.relu(remat.matmul(x, w["W1"].to(x.dtype))
                       + w["b1"].to(x.dtype))
        return remat.matmul(h, w["W2"].to(x.dtype), keep)
    if family == "multi_lowrank":
        # w: {"A": (U, d_in, r), "B": (U, r, d_out), "idx": (B,)}; x: (B, S, d).
        # int8-stored banks carry {"A_q", "A_scale", "B_q", "B_scale"}
        # instead and dequantise on load (never a f32 copy of the bank).
        Bz, S = x.shape[0], x.shape[1]
        flat = x.reshape(Bz * S, x.shape[-1])
        idx = w["idx"].to(torch.int32).repeat_interleave(S)
        if "A_q" in w:
            y = kernel_ops.multi_lora_q8(flat, w["A_q"], w["A_scale"],
                                         w["B_q"], w["B_scale"], idx)
        else:
            y = kernel_ops.multi_lora(flat, w["A"], w["B"], idx)
        return y.reshape(Bz, S, -1)
    raise ValueError(f"unknown adapter family: {family!r}")


def merge_delta(family: str, w: dict, scale: float) -> torch.Tensor:
    """The delta-W with base_W + delta == merged weights (Prop 2). Only for
    families linear in x; keeps stacked leading layer axes."""
    if family == "lowrank":
        return scale * (w["A"] @ w["B"])
    if family == "linear":
        return scale * w["W"]
    raise ValueError(f"adapter family {family!r} is not mergeable (Prop 2: "
                     "merging requires g linear in its input)")


def is_mergeable(family: str) -> bool:
    return MERGEABLE[family]


def shapes(family: str, d_in: int, d_out: int, *, rank: int = 8,
           hidden: int = 128) -> dict[str, tuple[int, ...]]:
    if family == "lowrank":
        return {"A": (d_in, rank), "B": (rank, d_out)}
    if family == "linear":
        return {"W": (d_in, d_out)}
    if family == "mlp":
        return {"W1": (d_in, hidden), "b1": (hidden,), "W2": (hidden, d_out)}
    raise ValueError(family)
