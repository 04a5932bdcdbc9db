"""Carry weights across from the JAX package, as numpy arrays.

The JAX package's parameter and adapter pytrees are nested dicts; turn each
leaf into numpy (``jax.tree.map(np.asarray, tree)``) and hand the tree here.
numpy has no bfloat16 of its own: a bf16 leaf arrives either as an
``ml_dtypes`` bfloat16 array or as float32, and goes through float32 into a
torch bfloat16 tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model
from repro_torch.utils import canonical_dtype, resolve_device, tree_map


def _leaf(a, float_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    is_float = a.dtype.kind == "f" or a.dtype.name == "bfloat16"
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a))   # a writable, contiguous copy
    return t.to(device=device, dtype=float_dtype if is_float else t.dtype)


def _tree(tree, dtypes, device: torch.device, fallback=None):
    """``dtypes``: one dtype for every float leaf, or a tree of dtypes by
    path; a leaf the tree of dtypes lacks takes ``fallback``."""
    if isinstance(tree, dict):
        return {k: _tree(v, (dtypes.get(k, fallback)
                             if isinstance(dtypes, dict) else dtypes),
                         device, fallback)
                for k, v in tree.items()}
    return _leaf(tree, fallback if isinstance(dtypes, dict) else dtypes,
                 device)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The JAX parameter pytree (numpy leaves, or any part of it) -> the
    port's parameters. Each float leaf takes the dtype the port's
    ``model.init`` gives it, which is JAX's: ``cfg.param_dtype``, except the
    Mamba2 blocks' ``dt_bias``, ``A_log`` and ``D``, which are f32 in any
    ``param_dtype``."""
    # the dtypes of the port's init tree, built on the meta device (no
    # memory, no draws)
    dtypes = tree_map(lambda t: t.dtype, model.init(cfg, device="meta"))
    return _tree(tree, dtypes, resolve_device(device),
                 fallback=canonical_dtype(cfg.param_dtype))


def adapters_from_numpy(tree: dict, device="cuda", dtype="float32") -> dict:
    """An adapter pytree {tap: {leaf: array}} of any family (lowrank
    {"A", "B"}, linear {"W"}, mlp {"W1", "b1", "W2"}; stacked leaves keep
    their leading (L,) axis), numpy leaves -> torch tensors in ``dtype``
    (f32, as JAX initialises adapters and as the f32 bank stores them)."""
    return _tree(tree, canonical_dtype(dtype), resolve_device(device))
