"""Parameter merging (paper §3.2 "Parameter merging", Prop 2, Alg. 1 l.3/8).

Merging folds every mergeable adapter's delta-W into the matching base weight;
unmerging subtracts it. Deltas are computed in f32, so merge -> unmerge
round-trips exactly in f32 parameters and to ~1 ulp in bf16. Functional: the
returned params share every untouched leaf with the input.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters as adapters_lib
from repro_torch.core.taps import ColaSpec
from repro_torch.utils import tree_leaves, tree_map

# tap-name suffix -> path inside a block's param dict (final key is "w")
_SITE_PATHS = {
    "attn.q": ("attn", "q"),
    "attn.k": ("attn", "k"),
    "attn.v": ("attn", "v"),
    "attn.o": ("attn", "o"),
    "mlp.gate": ("mlp", "gate"),
    "mlp.up": ("mlp", "up"),
    "mlp.down": ("mlp", "down"),
    "ssm.in": ("ssm", "in_proj"),
    "ssm.out": ("ssm", "out_proj"),
}


def _tap_path(tap: str) -> tuple[str, ...]:
    prefix, suffix = tap.split(".", 1)
    return (prefix,) + _SITE_PATHS[suffix] + ("w",)


def _update_at(params: dict, path: tuple[str, ...], fn) -> dict:
    """Functional deep update of a nested dict."""
    new = dict(params)
    new[path[0]] = (fn(params[path[0]]) if len(path) == 1
                    else _update_at(params[path[0]], path[1:], fn))
    return new


def merge_adapters(cfg: ModelConfig, params: dict, families: dict[str, str],
                   adapters: dict, scale: float, sign: float = 1.0) -> dict:
    """Return params with sign * scale * delta_W(adapter) added at every tap."""
    for tap, w in adapters.items():
        fam = families[tap]
        if not adapters_lib.is_mergeable(fam):
            raise ValueError(
                f"adapter family {fam!r} at {tap} is not mergeable (Prop 2)")
        delta = adapters_lib.merge_delta(
            fam, tree_map(lambda a: a.to(torch.float32), w), scale)

        def add(base, delta=delta):
            return (base.to(torch.float32) + sign * delta).to(base.dtype)

        params = _update_at(params, _tap_path(tap), add)
    return params


def unmerge_adapters(cfg: ModelConfig, params: dict, families: dict[str, str],
                     adapters: dict, scale: float) -> dict:
    return merge_adapters(cfg, params, families, adapters, scale, sign=-1.0)


def merge_adapter_pytrees(banks: list[dict], weights: list[float] | None = None
                          ) -> dict:
    """Weighted average of per-user adapter trees ("adapter soup"), in f32.
    Exactly the mean delta-W for ``linear``; the standard rank-preserving
    approximation for ``lowrank``. All banks must share one structure and
    leaf shapes."""
    if not banks:
        raise ValueError("merge_adapter_pytrees: need at least one bank")
    if weights is None:
        weights = [1.0 / len(banks)] * len(banks)
    if len(weights) != len(banks):
        raise ValueError(f"got {len(banks)} banks but {len(weights)} weights")
    structs = {str(tree_map(lambda _: None, b)) for b in banks}
    if len(structs) != 1:
        raise ValueError(f"bank structures differ: {structs}")
    shapes = {tuple(tuple(l.shape) for l in tree_leaves(b)) for b in banks}
    if len(shapes) != 1:
        raise ValueError(f"bank leaf shapes differ: {shapes}")
    out = tree_map(lambda l: weights[0] * l.to(torch.float32), banks[0])
    for w, b in zip(weights[1:], banks[1:]):
        out = tree_map(lambda acc, l, w=w: acc + w * l.to(torch.float32),
                       out, b)
    return out


def merged_params(cfg: ModelConfig, params: dict, spec_or_families,
                  adapters: dict, scale: float | None = None) -> dict:
    if isinstance(spec_or_families, ColaSpec):
        families = spec_or_families.family_map
        scale = spec_or_families.scale if scale is None else scale
    else:
        families = spec_or_families
        if scale is None:
            raise ValueError("merged_params: a family map needs a scale")
    return merge_adapters(cfg, params, families, adapters, scale)
