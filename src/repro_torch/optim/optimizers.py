"""Optimizers with the JAX package's functional API, over nested dicts of
tensors (``torch.optim`` would not match the JAX update step for step):

    opt = adamw(lr=..., ...)          # lr: a float or a schedule fn(step)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

State is f32 (m, v, momentum) beside an integer step count; the math is the
JAX package's ``optim/optimizers.py``, in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils import tree_leaves, tree_map

PyTree = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]


def _lr_at(lr, step: int):
    return lr(step) if callable(lr) else lr


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A python or tensor scalar as an f32 tensor on ``like``'s device, so
    every product below rounds as JAX's f32 arrays do."""
    return torch.as_tensor(x, dtype=F32, device=like.device)


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * factor).to(g.dtype), grads)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        state = {"step": 0}
        if momentum:
            state["mu"] = tree_map(lambda p: torch.zeros_like(p, dtype=F32),
                                   params)
        return state

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.to(F32),
                          state["mu"], grads)
            if nesterov:
                upd = tree_map(lambda m, g: -(_f32(lr_t, m) * (
                    momentum * m + g.to(F32))), mu, grads)
            else:
                upd = tree_map(lambda m: -_f32(lr_t, m) * m, mu)
            return upd, {"step": step, "mu": mu}
        upd = tree_map(lambda g: -_f32(lr_t, g) * g.to(F32), grads)
        return upd, {"step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=F32)
        return {"step": 0, "m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(F32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(F32)),
                     state["v"], grads)

        def upd(m_, v_, p):
            bc1 = 1 - _f32(b1, m_) ** step
            bc2 = 1 - _f32(b2, m_) ** step
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            u = u + weight_decay * p.to(F32)
            return -_f32(lr_t, m_) * u

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p.to(F32) + u).to(p.dtype), params, updates)


def make(name: str, lr, *, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
         momentum=0.9) -> Optimizer:
    if name == "adamw":
        return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if name == "sgd":
        return sgd(lr, momentum=momentum)
    raise ValueError(name)
