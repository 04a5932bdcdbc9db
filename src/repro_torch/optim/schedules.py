"""LR schedules: linear warmup + {linear, cosine, const} decay (paper Table 5
uses linear decay with 5% warmup). Each returns fn(step) -> f32 scalar
tensor, computed in f32 as the JAX package's ``optim/schedules.py`` does."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def linear_warmup_decay(base_lr: float, total_steps: int,
                        warmup_frac: float = 0.05):
    warmup = max(1, int(total_steps * warmup_frac))

    def fn(step):
        step = torch.as_tensor(step, dtype=F32)
        w = torch.clamp(step / warmup, max=1.0)
        decay = torch.clamp((total_steps - step) / max(1, total_steps - warmup),
                            0.0, 1.0)
        return base_lr * w * decay

    return fn


def cosine_warmup(base_lr: float, total_steps: int, warmup_frac: float = 0.05,
                  final_frac: float = 0.0):
    warmup = max(1, int(total_steps * warmup_frac))

    def fn(step):
        step = torch.as_tensor(step, dtype=F32)
        w = torch.clamp(step / warmup, max=1.0)
        t = torch.clamp((step - warmup) / max(1, total_steps - warmup), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * w * cos

    return fn


def const(base_lr: float):
    return lambda step: torch.as_tensor(base_lr, dtype=F32)


def make(name: str, base_lr: float, total_steps: int, warmup_frac: float = 0.05):
    if name == "linear":
        return linear_warmup_decay(base_lr, total_steps, warmup_frac)
    if name == "cosine":
        return cosine_warmup(base_lr, total_steps, warmup_frac)
    if name == "const":
        return const(base_lr)
    raise ValueError(name)
