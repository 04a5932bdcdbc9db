"""Tap machinery: the named Dense sites ``y = x @ W`` where ColA may

  (1) apply an adapter:   y += scale * g_w(x)
  (2) inject a delta:     y += delta
  (3) record the hidden input x.

``ColaSpec`` is static (hashable). The matching vars are
{"adapters": {tap: w}, "deltas": {tap: tensor}}. Taps inside the layer stack
are named ``layers.<site>`` and their vars carry a leading (L,) axis, which
the model's layer loop slices. zamba2's shared block ("shared.<site>") is
one unstacked site called once a segment: its adapter is used whole at
every call, and its deltas and collected inputs carry a leading call axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.core import adapters as adapters_lib


@dataclasses.dataclass(frozen=True)
class TapSite:
    """Static description of one tappable Dense site."""
    name: str          # e.g. "layers.attn.q"
    d_in: int
    d_out: int
    stacked: int = 0   # number of stacked layers (0 = unstacked)
    # calls of an unstacked site a pass (zamba2's shared block: one a
    # segment, each with its own Mode-A delta); 0 = one call
    calls: int = 0

    def lead(self) -> tuple[int, ...]:
        """The leading axis of the site's deltas and collected inputs: the
        layer axis, the call axis, or none."""
        n = self.stacked or self.calls
        return (n,) if n else ()


@dataclasses.dataclass(frozen=True)
class ColaSpec:
    """Static ColA call configuration."""
    families: tuple[tuple[str, str], ...] = ()  # (tap_name, family)
    collect: tuple[str, ...] = ()               # taps whose hidden input to record
    inject: tuple[str, ...] = ()                # taps with delta injection
    scale: float = 1.0
    rank: int = 8
    hidden: int = 128

    @property
    def family_map(self) -> dict[str, str]:
        return dict(self.families)

    def tap_names(self) -> tuple[str, ...]:
        seen = dict.fromkeys([n for n, _ in self.families])
        for n in self.collect + self.inject:
            seen.setdefault(n)
        return tuple(seen)

    def with_adapters_only(self) -> "ColaSpec":
        return dataclasses.replace(self, collect=(), inject=())


def make_spec(*, family: str | None = None,
              families: Mapping[str, str] | None = None,
              taps: tuple[str, ...] = (), collect: tuple[str, ...] = (),
              inject: tuple[str, ...] = (), scale: float = 1.0, rank: int = 8,
              hidden: int = 128) -> ColaSpec:
    fam: dict[str, str] = dict(families or {})
    if family is not None:
        for t in taps:
            fam.setdefault(t, family)
    return ColaSpec(families=tuple(sorted(fam.items())), collect=tuple(collect),
                    inject=tuple(inject), scale=scale, rank=rank, hidden=hidden)


def init_adapter_vars(spec: ColaSpec, sites: Mapping[str, TapSite],
                      gen: torch.Generator, dtype=torch.float32,
                      device=None) -> dict:
    """{tap: w} for every adapted tap of ``spec``, drawn from ``gen`` in the
    order of ``spec.families``. Stacked sites get a leading (L,) axis on
    every adapter leaf."""
    out: dict[str, Any] = {}
    for name, family in spec.families:
        site = sites[name]
        lead = (site.stacked,) if site.stacked else ()
        out[name] = adapters_lib.init(family, gen, site.d_in, site.d_out,
                                      rank=spec.rank, hidden=spec.hidden,
                                      dtype=dtype, lead=lead, device=device)
    return out


def zero_delta_vars(spec: ColaSpec, sites: Mapping[str, TapSite],
                    batch_shape: tuple[int, ...], dtype=torch.float32,
                    device="cuda") -> dict:
    """Zero deltas {tap: (L?, *batch_shape, d_out)} for grad extraction
    (Mode A); L is the layer axis of a stacked site or the call axis of a
    shared one (``TapSite.lead``)."""
    return {name: torch.zeros(sites[name].lead() + batch_shape
                              + (sites[name].d_out,), dtype=dtype,
                              device=device)
            for name in spec.inject}


def apply_tap(spec: ColaSpec | None, name: str, x: torch.Tensor,
              y: torch.Tensor, adapters: Mapping[str, Any] | None = None,
              deltas: Mapping[str, Any] | None = None, layout=None,
              keep: bool = True
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Apply adapter/injection at a tap; returns (y', collected_aux).
    ``adapters``/``deltas`` hold the per-call (already layer-sliced) vars.
    ``layout``: the tap's ``tensor_parallel.TapLayout`` under a step's plan
    (the delta and the collected x are then the rank's blocks), or None.
    ``keep``: the adapter's ``apply(keep=)`` (its last product kept under
    remat "dots")."""
    if spec is None:
        return y, {}
    aux: dict[str, torch.Tensor] = {}
    if name in spec.collect:
        aux[name] = x if layout is None else layout.collected(x)
    fam = spec.family_map.get(name)
    if fam is not None and adapters and name in adapters:
        g = adapters_lib.apply(fam, adapters[name], x, keep=keep)
        # the scale is rounded to y's dtype first, as jnp.asarray(scale, dt)
        s = float(torch.tensor(spec.scale, dtype=y.dtype))
        y = y + s * g.to(y.dtype)
    if deltas and name in deltas and name in spec.inject:
        d = deltas[name].to(y.dtype)
        y = y + (d if layout is None else layout.place_delta(d))
    return y, aux
