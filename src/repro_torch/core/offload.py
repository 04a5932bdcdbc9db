"""Gradient Offloading (paper Fig. 1): the adaptation-data buffers, the
adaptation interval I, int8 transfer compression, and the offloaded fit +
optimizer.

The Offloader owns everything the paper moves off the server device: the
buffers (I batches accumulate to an effective batch of B * I), the adapter
parameters between rounds, and the adapter optimizer with its state (as in
ZeRO-Offload, which the paper cites).

Where the fit runs: ``device`` defaults to the card, like every entry point
of the port. The JAX package defaults it to the host CPU; on a one-card
machine the card stands in for the paper's low-cost fit device, and
``device="cpu"`` gives the paper's deployment (buffers and fit on the host).
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core import gl
from repro_torch.core.taps import ColaSpec
from repro_torch.optim import optimizers as optim_lib
from repro_torch.telemetry import annotate
from repro_torch.utils import resolve_device, tree_map


# ---------------------------------------------------------------------------
# int8 row-scaled transfer compression
# ---------------------------------------------------------------------------

def quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-dim) symmetric int8 quantisation: (codes, f32 scales)."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = scale.clamp(min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequant_int8(q: torch.Tensor, scale: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Offloader:
    """Buffers + offloaded fit for one adapter bank.

    spec      : ColaSpec whose ``families`` describe the adapters to fit
                (the *adapter* spec, also when the server runs merged).
    adapters  : initial adapters {tap: w}.
    optimizer : a ``repro_torch.optim`` Optimizer (its state lives here).
    interval  : adaptation interval I (fit every I pushed batches).
    compress  : "none" | "int8": compress (x, grad_h) for the transfer.
    device    : where buffers, adapters, optimizer state and the fit live.
    """

    def __init__(self, spec: ColaSpec, adapters: dict, optimizer, *,
                 interval: int = 1, compress: str = "none", device="cuda"):
        if compress not in ("none", "int8"):
            raise ValueError(f"compress={compress!r}")
        self.spec = spec
        self.optimizer = optimizer
        self.interval = int(interval)
        self.compress = compress
        self.device = resolve_device(device)
        self.adapters = tree_map(lambda a: a.to(self.device), adapters)
        self.opt_state = optimizer.init(self.adapters)
        self.buffers: dict[str, list] = collections.defaultdict(list)
        self._pushes = 0
        self.stats = {"pushed_bytes": 0, "fits": 0}

    # -- transfer ----------------------------------------------------------
    def push(self, data: dict[str, tuple]) -> None:
        """Enqueue one batch of adaptation data {tap: (x, grad_h)}."""
        for tap, (x, gh) in data.items():
            if self.compress == "int8":
                payload = (quant_int8(x), quant_int8(gh))
                nbytes = sum(_nbytes(*p) for p in payload)
            else:
                payload = (x, gh)
                nbytes = _nbytes(x, gh)
            # server device -> fit device (a no-op when they are one device)
            self.buffers[tap].append(_to(payload, self.device))
            self.stats["pushed_bytes"] += nbytes
        self._pushes += 1

    def _materialise(self) -> dict[str, tuple]:
        out = {}
        for tap, items in self.buffers.items():
            if self.compress == "int8":
                xs = [dequant_int8(*qx) for qx, _ in items]
                ghs = [dequant_int8(*qg) for _, qg in items]
            else:
                xs = [x for x, _ in items]
                ghs = [g for _, g in items]
            axis = xs[0].dim() - 3   # batch axis: (L?, B, S, d)
            out[tap] = (torch.cat(xs, dim=axis), torch.cat(ghs, dim=axis))
        return out

    @property
    def ready(self) -> bool:
        """True when I batches have accumulated and a fit is due."""
        return (self._pushes > 0 and self._pushes % self.interval == 0
                and bool(self.buffers))

    # -- fit ----------------------------------------------------------------
    def _fit(self, n: int) -> dict:
        grads = gl.fit_grads(self.spec, self.adapters, self._materialise())
        # average over the n buffered batches (effective batch B * n)
        grads = tree_map(lambda g: g / float(n), grads)
        updates, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.adapters)
        self.adapters = optim_lib.apply_updates(self.adapters, updates)
        self.buffers.clear()
        self.stats["fits"] += 1
        return self.adapters

    def maybe_fit(self) -> dict | None:
        """Run the offloaded fit if I batches have accumulated. Returns the new
        adapters (to be sent back to the server / merged) or None."""
        if not self.ready:
            return None
        with annotate("offload.fit"):
            return self._fit(self.interval)

    def force_fit(self) -> dict | None:
        """Fit on whatever is buffered, averaging over the batches held."""
        if not self.buffers:
            return None
        return self._fit(len(next(iter(self.buffers.values()))))


def _to(payload, device):
    if isinstance(payload, tuple):
        return tuple(_to(p, device) for p in payload)
    return payload.to(device)
