"""What a checkpointed unit keeps for its backward (``ModelConfig.remat``),
as the JAX package's ``jax.checkpoint`` policies (``models/model.py``):

- "none": no checkpoint; autograd keeps every activation it needs.
- "full" (``nothing_saveable``): the unit keeps its input and recomputes
  everything in the backward (``torch.utils.checkpoint``, non-reentrant).
- "dots" (``dots_with_no_batch_dims_saveable``): the unit also keeps the
  outputs of its products with no batch dimension and recomputes the rest
  (selective checkpointing, ``dots_context``). Kept: every dense ``x @ W``
  (``layers.dense``, a rank's shard of one too), the router, the dense
  MoE's ``bsd,edf->bsef`` and the adapters' products. Recomputed: the
  batched products (attention's plain path, the MoE's dispatch, combine
  and experts, the SSD scan), norms, rope, softcaps, collectives and
  gathers, and the flash kernels, which launch inside autograd Functions
  through ``ctypes`` where no dispatch mode sees them, as JAX reruns its
  ``pallas_call``.

An op's name does not say whether a product has a batch dimension:
``einsum("bsd,edf->bsef")`` reaches ``aten.bmm`` with a batch of one, as a
real batch of one does. So the call sites say it: a product run through
``matmul`` or ``einsum`` here with ``keep`` is kept. In a "dots" unit's
forward such a call keeps its product's output; in the unit's recompute
the same call runs under a dispatch mode (``_Replay``), below autograd,
whose product op returns the kept output in its place, while autograd
records the op and saves its inputs as in the forward. This is selective
checkpointing (``torch.utils.checkpoint``'s
``create_selective_checkpoint_contexts``) with the dispatch mode scoped
to the kept products' recompute: a mode over the whole unit dispatches
every op of its forward and recompute through Python, which cost
mistral-nemo-12b's Mode A step 54 % on the H100 (PERF.md §6).

JAX keeps a saveable value only where its backward reads it; a unit here
keeps every output it marks. So a call site does not mark a product whose
output nothing in the backward reads: the last product of a unit whose
output only feeds the residual add that closes the unit (its last down or
out projection, and that tap's adapter's last product), and an adapter's
``x @ A`` where ``B`` takes no gradient. Both are recomputed in the
backward if the recompute reaches them (JAX's is pruned to what the
backward reads, the port's reruns the unit in order up to its last saved
tensor).
"""
from __future__ import annotations

import collections
import contextvars
from functools import partial

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

REMATS = ("none", "full", "dots")

# (replay, the kept outputs in order) of the "dots" unit running, if any
_UNIT = contextvars.ContextVar("remat_unit", default=None)
_METERS: list["saved_product_meter"] = []
_aten = torch.ops.aten
# the product ops a marked call reaches: x @ W (2-D, or folded to 2-D, or
# batched where the rows do not fold), an einsum's batched form
_PRODUCTS = (_aten.mm.default, _aten.bmm.default)


def _keep(kept: collections.deque, out: torch.Tensor, k: int) -> None:
    """Keeps ``out``, a product's output over a contraction of ``k``, as a
    new tensor on its storage (autograd sets the history of ``out`` alone,
    so the kept tensor holds no graph), and meters it."""
    kept.append(out.detach())
    for m in _METERS:
        m.saw(tuple(out.shape), out.dtype, 2 * k)


class _Keep(TorchDispatchMode):
    """An einsum's product op in a "dots" unit's forward: its output is
    kept (the einsum's output is a permuted view of it)."""

    def __init__(self, kept: collections.deque):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _PRODUCTS:
            _keep(self.kept, out, args[0].shape[-1])
        return out


class _Replay(TorchDispatchMode):
    """A kept product in a "dots" unit's recompute: the product op returns
    the next kept output in its own shape (a view: a kept output is the
    op's, or a view of it in the op's layout), and autograd records the op
    and saves its inputs as in the forward."""

    def __init__(self, kept: collections.deque):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _aten.mm.default:
            return self.kept.popleft().view(args[0].shape[0],
                                            args[1].shape[1])
        if func is _aten.bmm.default:
            return self.kept.popleft().view(*args[0].shape[:2],
                                            args[1].shape[2])
        return func(*args, **(kwargs or {}))


def matmul(a: torch.Tensor, b: torch.Tensor, keep: bool = True
           ) -> torch.Tensor:
    """``a @ b``, its output kept in a "dots" unit when ``keep``."""
    unit = _UNIT.get()
    if not keep or unit is None:
        return a @ b
    replay, kept = unit
    if replay:
        with _Replay(kept):
            return a @ b
    out = a @ b
    _keep(kept, out, a.shape[-1])
    return out


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor, keep: bool = True
           ) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` for a product with no batch dimension
    (no index of both operands stays in the output), kept as ``matmul``."""
    unit = _UNIT.get()
    if not keep or unit is None:
        return torch.einsum(eq, a, b)
    replay, kept = unit
    with (_Replay if replay else _Keep)(kept):
        return torch.einsum(eq, a, b)


class _Phase:
    """The forward (``replay`` False) or the recompute of a "dots" unit."""

    def __init__(self, replay: bool, kept: collections.deque):
        self.unit = (replay, kept)

    def __enter__(self):
        self._token = _UNIT.set(self.unit)

    def __exit__(self, *exc):
        _UNIT.reset(self._token)


def dots_context():
    """``context_fn`` of a "dots" checkpoint: its forward and its
    recompute, sharing the unit's kept outputs."""
    kept: collections.deque = collections.deque()
    return _Phase(False, kept), _Phase(True, kept)


def checkpointed(remat: str, fn, needs_grad: bool):
    """``fn`` under ``remat`` (``REMATS``; any other raises ``ValueError``);
    without autograd, or under "none", ``fn`` itself (nothing to
    recompute)."""
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}: one of {', '.join(REMATS)}")
    if not needs_grad or remat == "none":
        return fn
    if remat == "full":
        return partial(torch.utils.checkpoint.checkpoint, fn,
                       use_reentrant=False)
    return partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False,
                   context_fn=dots_context)


class saved_product_meter:
    """While active, records every product output a "dots" unit keeps in
    its forward: ``shapes`` (the product op's output, e.g. (B S, d_out) for
    ``x @ W``), ``bytes`` and ``flops`` (2 m k n, the forward's) summed."""

    def __init__(self):
        self.shapes: list[tuple[int, ...]] = []
        self.bytes = 0
        self.flops = 0

    def saw(self, shape: tuple[int, ...], dtype, per_out: int) -> None:
        n = 1
        for s in shape:
            n *= s
        self.shapes.append(tuple(shape))
        self.bytes += n * dtype.itemsize
        self.flops += n * per_out

    def __enter__(self) -> "saved_product_meter":
        _METERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _METERS.remove(self)
