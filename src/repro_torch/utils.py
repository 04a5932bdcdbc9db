"""Shared utilities: dtype names, shape math, device checks and maps over
nested dicts of tensors (the port's pytrees)."""
from __future__ import annotations

import torch

_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "f32": torch.float32,
    "float32": torch.float32,
    "f16": torch.float16,
}


def canonical_dtype(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[name]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default everywhere)
    raises when no GPU is present: the port never drops quietly to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if device.index is None:   # "cuda" -> "cuda:<current>", comparable
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts that share one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def all_finite(tree) -> bool:
    """Whether every tensor leaf of nested dicts is finite (one host sync a
    leaf)."""
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def sorted_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, tuples and
    lists in order. Where a leaf's index must mean the same leaf as in the
    JAX package (the fault injector's draws), walk with this, not
    ``tree_leaves``."""
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in sorted_leaves(v)]
    return [tree]


def replace_sorted_leaf(tree, index: int, new):
    """A copy of ``tree``'s containers with leaf ``index`` (in
    ``sorted_leaves`` order) replaced by ``new``; every other leaf is shared."""
    count = [0]

    def walk(t):
        if isinstance(t, dict):   # counted in sorted order, kept in t's
            done = {k: walk(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        i, count[0] = count[0], count[0] + 1
        return new if i == index else t

    return walk(tree)


def flatten_dict(d: dict, prefix: str = "", sep: str = ".") -> dict:
    """Nested dicts -> one dict of ``sep``-joined key paths."""
    out: dict = {}
    for k, v in d.items():
        kk = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, kk, sep))
        else:
            out[kk] = v
    return out


def unflatten_dict(d: dict, sep: str = ".") -> dict:
    """The inverse of ``flatten_dict``."""
    out: dict = {}
    for k, v in d.items():
        parts = k.split(sep)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out
