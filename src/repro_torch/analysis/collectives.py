"""Collective-op breakdown of a step, the JAX package's
``analysis/collectives.py`` under its names: which collectives, what shapes,
how many bytes. JAX parses them from the compiled HLO; the port records the
collectives a step issues as it runs (``CollectiveRecorder``).

A record is one issued collective: ``op`` in XLA's words (``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``, ``broadcast``),
``shapes`` the result's as ``dtype[d0,d1,...]`` strings, and
``bytes`` the result's size on this rank. An all-gather's result is the
whole gathered tensor, the bytes a ring all-gather moves through each
rank's links; an all-reduce moves about twice its size (reduce-scatter +
all-gather), which ``total_bytes`` and ``breakdown`` count, as JAX does.
A record issued inside ``labelled(name)`` also carries ``"of": name`` (the
serve step labels its moves of cache leaves "cache.<stack>.<leaf>"; the
train and prefill steps' sequence split labels its collectives
"seq.<part>"), which ``by_leaf`` sums.
"""
from __future__ import annotations

import collections
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64",
}

# XLA's words for torch's collective ops, by op name: the functional ops of
# DTensor's redistribute and full_tensor (``_c10d_functional``), and the
# ops of torch.distributed's calls (``c10d``; ``dist.all_reduce`` is
# ``allreduce_``)
_XLA_NAMES = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


_LABELS: list[str] = []


@contextlib.contextmanager
def labelled(name: str):
    """Collectives recorded while active carry ``"of": name``: the leaf a
    step moves."""
    _LABELS.append(name)
    try:
        yield
    finally:
        _LABELS.pop()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def size_bound(n) -> int:
    """A size as an int: its value, or for a data-dependent size of a fake
    tensor (an unbacked symbol: the dry-run's inputs have static shapes, so
    no other symbol arises) the upper bound its shape environment holds."""
    if not isinstance(n, torch.SymInt):
        return int(n)
    node = n.node
    return int(node.shape_env.bound_sympy(node.expr).upper)


def _sig(t: torch.Tensor) -> str:
    dims = ",".join(str(size_bound(d)) for d in t.shape)
    return f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype))}[{dims}]"


def collective_name(func) -> str | None:
    """XLA's word for a torch collective op, None for any other op (the
    functional ops' ``wait_tensor`` included: it moves nothing)."""
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    return _XLA_NAMES.get(func.overloadpacket.__name__)


class CollectiveRecorder(TorchDispatchMode):
    """Keeps every collective issued under it in ``records``, in order. A
    c10d op works in place on its tensors, so their shapes are its result's;
    a functional op's result is its return value."""

    def __init__(self):
        super().__init__()
        self.records: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = collective_name(func)
        if op is not None:
            res = list(_tensors(args[0] if func.namespace == "c10d" else out))
            rec = {"op": op, "shapes": [_sig(t) for t in res],
                   "bytes": sum(size_bound(t.numel()) * t.element_size()
                                for t in res)}
            if _LABELS:
                rec["of"] = _LABELS[-1]
            self.records.append(rec)
        return out


def _factor(op: str) -> float:
    return 2.0 if op == "all-reduce" else 1.0


def total_bytes(records: list[dict]) -> float:
    """Bytes the recorded collectives move through one rank's links."""
    return float(sum(_factor(r["op"]) * r["bytes"] for r in records))


def bytes_by_op(records: list[dict]) -> dict[str, float]:
    out: dict[str, float] = {}
    for r in records:
        out[r["op"]] = out.get(r["op"], 0.0) + _factor(r["op"]) * r["bytes"]
    return out


def by_leaf(records: list[dict], prefix: str = ""
            ) -> dict[str, dict[str, float]]:
    """{label: {op: bytes}} of the labelled records (``labelled``) whose
    label starts with ``prefix``."""
    out: dict[str, dict[str, float]] = {}
    for r in records:
        if "of" in r and r["of"].startswith(prefix):
            ops = out.setdefault(r["of"], {})
            ops[r["op"]] = ops.get(r["op"], 0.0) + _factor(r["op"]) * r["bytes"]
    return out


def breakdown(records: list[dict], top: int | None = 15
              ) -> list[tuple[str, int, float]]:
    """Returns [(op shapes, count, total_bytes)] sorted by bytes desc, ties
    by name, so the rows do not depend on the order of issue (all rows when
    ``top`` is None)."""
    agg: dict[tuple[str, str], list] = collections.defaultdict(lambda: [0, 0.0])
    for r in records:
        key = (r["op"], ",".join(r["shapes"]))
        agg[key][0] += 1
        agg[key][1] += _factor(r["op"]) * r["bytes"]
    rows = [(f"{op} {sig}", c, b) for (op, sig), (c, b) in agg.items()]
    rows.sort(key=lambda r: (-r[2], r[0]))
    return rows if top is None else rows[:top]


def print_breakdown(records: list[dict], top: int = 15, report=print) -> None:
    total = 0.0
    for name, count, nbytes in breakdown(records, top):
        report(f"  {nbytes/2**30:8.3f} GB  x{count:<4d} {name}")
        total += nbytes
    report(f"  (top-{top} total {total/2**30:.2f} GB per rank, every "
           f"collective as issued)")
