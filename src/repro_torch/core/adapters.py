"""Auxiliary models g_w (the paper's adapters), as far as serving needs them.

- ``lowrank``       : g(x) = (x @ A) @ B  (== LoRA)
- ``multi_lowrank`` : FTaaS serving, one adapter per request inside one batch
  (multi-LoRA through ``kernels.ops.multi_lora``).

The other families of the JAX package (``linear``, ``mlp``) and int8-stored
banks are still to be ported (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kernel_ops


def apply(family: str, w: dict, x: torch.Tensor) -> torch.Tensor:
    """g_w(x). x: (..., d_in) -> (..., d_out). Computes in x.dtype."""
    if family == "lowrank":
        return (x @ w["A"].to(x.dtype)) @ w["B"].to(x.dtype)
    if family == "multi_lowrank":
        # w: {"A": (U, d_in, r), "B": (U, r, d_out), "idx": (B,)}; x: (B, S, d)
        if "A_q" in w:
            raise NotImplementedError("int8-stored adapter banks are not "
                                      "ported yet (see ROADMAP.md)")
        Bz, S = x.shape[0], x.shape[1]
        flat = x.reshape(Bz * S, x.shape[-1])
        idx = w["idx"].to(torch.int32).repeat_interleave(S)
        y = kernel_ops.multi_lora(flat, w["A"], w["B"], idx)
        return y.reshape(Bz, S, -1)
    raise NotImplementedError(f"adapter family {family!r} is not ported yet "
                              "(see ROADMAP.md)")
