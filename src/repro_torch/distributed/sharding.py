"""Sharding rules on ``torch.distributed``: DP (pod + data), FSDP (params
over data), TP (model), EP (experts over model), SP (long sequences over
model), with the divisibility-guarded fallbacks of the JAX package's
``distributed/sharding.py``, rule for rule.

A rule gives a *spec*: a tuple with one entry per dim, each an axis name, a
tuple of names (split major to minor in that order) or None, the contents
of JAX's ``PartitionSpec``. The rules read only the mesh's shape, so they
take a ``DeviceMesh`` or a ``MeshConfig`` and can be checked at 256 or 512
ranks without a process. On a ``DeviceMesh``:

- ``placements`` turns a spec into DTensor placements (``Shard(dim)`` on
  each mesh dim of the entry; where an entry names its axes against the
  mesh's order, the more major dims are ``_StridedShard``, so a rank holds
  the block JAX gives it);
- ``distribute`` places a tree, each leaf built from the rank's slice;
  ``wrap`` makes a DTensor of a rank's block as it is;
- ``gathered`` gives a leaf back whole (the step builders gather only the
  batch so; parameters and adapters reach compute a layer at a time through
  ``distributed.tensor_parallel``).

The activation side: ``activation_rules`` holds the mesh, the policy and a
step's ``tensor_parallel.Plan`` (``plan``), which the model reads while it
runs; ``constrain`` (the identity on a plain tensor and outside
``activation_rules``), and ``batch_sum`` / ``batch_mean``, through which the
loss and the MoE router's statistics become the whole batch's when each
rank holds only its own rows (``activation_rules(local_rows=True)``): the
value is the batch's, the gradient the rank's own share, so a sum of the
ranks' gradients is one device's.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch.configs.base import MeshConfig

PyTree = Any


class Spec(tuple):
    """One leaf's spec: a tuple of entries, one a dim (JAX's
    ``PartitionSpec``); a leaf, not a container, in a tree of specs."""

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} in the mesh's order, of a ``DeviceMesh`` or a
    ``MeshConfig``."""
    if isinstance(mesh, MeshConfig):
        if mesh.pods > 1:
            return {"pod": mesh.pods, "data": mesh.data, "model": mesh.model}
        return {"data": mesh.data, "model": mesh.model}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _spec(*entries) -> Spec:
    """A spec from its entries, as JAX's ``PartitionSpec`` holds them: a
    tuple of one axis name becomes the name, an empty one None."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = None if not e else (e[0] if len(e) == 1 else tuple(e))
        out.append(e)
    return Spec(out)


def _size(shape: dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


# ---------------------------------------------------------------------------
# activation constraints and batch reductions
# ---------------------------------------------------------------------------

_RULES: list["ActivationRules"] = []


class ActivationRules:
    """The active mesh and policy. ``local_rows``: the computation holds only
    this rank's rows of the batch (a ``DeviceMesh`` is then required), so
    ``batch_sum`` / ``batch_mean`` reduce over the batch axes of more than
    one rank (``reduce_axes``). ``plan``: the step's
    ``tensor_parallel.Plan`` (how the model takes its leaves and splits its
    products), or None (leaves used as they are)."""

    def __init__(self, mesh, policy: str = "2d", *, local_rows: bool = False,
                 plan=None):
        self.mesh = mesh
        self.plan = plan
        self.shape = mesh_shape(mesh)
        if policy == "dp":
            self.batch_axes = tuple(a for a in ("pod", "data", "model")
                                    if a in self.shape)
            self.model_axis = None
        else:
            self.batch_axes = tuple(a for a in ("pod", "data")
                                    if a in self.shape)
            self.model_axis = "model" if "model" in self.shape else None
        self.reduce_axes = ()
        if local_rows:
            if not isinstance(mesh, DeviceMesh):
                raise ValueError("local_rows needs a DeviceMesh")
            self.reduce_axes = tuple(a for a in self.batch_axes
                                     if self.shape[a] > 1)
        self.reduce_size = _size(self.shape, self.reduce_axes)

    def axis_size(self, axes) -> int:
        return _size(self.shape, axes)


@contextlib.contextmanager
def activation_rules(mesh, policy: str = "2d", *, local_rows: bool = False,
                     plan=None):
    _RULES.append(ActivationRules(mesh, policy, local_rows=local_rows,
                                  plan=plan))
    try:
        yield _RULES[-1]
    finally:
        _RULES.pop()


def current_rules() -> ActivationRules | None:
    return _RULES[-1] if _RULES else None


def constrain(x: torch.Tensor, *dims: str | None) -> torch.Tensor:
    """Constrain x's placement. dims entries: "batch", "model", None. Dims
    that don't divide are replicated. The identity on a plain tensor and
    outside an activation_rules context; a DTensor is redistributed."""
    r = current_rules()
    if r is None or not isinstance(x, DTensor):
        return x
    spec: list = [None] * x.dim()
    for i, (d, size) in enumerate(zip(dims, x.shape)):
        if (d == "batch" and r.batch_axes and size > 0
                and size % r.axis_size(r.batch_axes) == 0):
            spec[i] = r.batch_axes
        elif (d == "model" and r.model_axis and size > 0
              and size % r.axis_size(r.model_axis) == 0):
            spec[i] = r.model_axis
    return x.redistribute(r.mesh, placements(r.mesh, _spec(*spec)))


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch ranks of the active rules
    (``reduce_axes``): the value is the total, the gradient ``x``'s own.
    ``x`` itself (the same tensor) when no rules are active or the rows are
    not split over more than one rank."""
    r = current_rules()
    if r is None or not r.reduce_axes:
        return x
    tot = x.detach().clone()
    for a in r.reduce_axes:
        dist.all_reduce(tot, group=r.mesh.get_group(a))
    return tot + (x - x.detach())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over dim 0 of ``x`` across every batch rank's rows (each
    rank holds as many), with the gradient of this rank's share;
    ``x.mean(dim=0)`` when ``batch_sum`` reduces nothing."""
    r = current_rules()
    if r is None or not r.reduce_axes:
        return x.mean(dim=0)
    return batch_sum(x.sum(dim=0)) / float(x.shape[0] * r.reduce_size)


# ---------------------------------------------------------------------------
# parameter shardings (path-pattern rules)
# ---------------------------------------------------------------------------

def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _axis(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _pick(mesh, size: int, *candidates):
    """First candidate axis (or axis tuple) that divides ``size``."""
    shape = mesh_shape(mesh)
    for cand in candidates:
        if cand is None:
            continue
        axes = (cand,) if isinstance(cand, str) else tuple(cand)
        if all(a in shape for a in axes):
            k = 1
            for a in axes:
                k *= shape[a]
            if _div(size, k):
                return cand
    return None


def _param_spec(mesh, path: str, shape: tuple[int, ...],
                policy: str = "2d") -> Spec:
    """Sharding rule for one parameter leaf, identified by its dotted path."""
    nd = len(shape)
    if policy == "dp":
        fs = ("data", "model")   # pure-DP: FSDP over both axes, no TP
        mdl = None
    else:
        fs = "data"   # FSDP axis (within-pod; pods replicate frozen base params)
        mdl = "model"

    def spec_nd(*tail):
        """Pad with leading Nones for stacked (L, ...) leaves."""
        lead = nd - len(tail)
        return _spec(*([None] * lead + list(tail)))

    # embeddings / heads ----------------------------------------------------
    if re.search(r"(embed|unembed)\.emb$", path):
        v = shape[-2]
        return spec_nd(_pick(mesh, v, (mdl, fs), mdl, fs), None)
    if path.endswith("lm_head.w"):
        return spec_nd(_pick(mesh, shape[-2], fs), _pick(mesh, shape[-1], mdl))
    # attention ---------------------------------------------------------------
    if re.search(r"attn\.(q|k|v)\.w$", path):
        return spec_nd(_pick(mesh, shape[-2], fs), _pick(mesh, shape[-1], mdl))
    if path.endswith("attn.o.w"):
        return spec_nd(_pick(mesh, shape[-2], mdl), _pick(mesh, shape[-1], fs))
    # dense mlp ---------------------------------------------------------------
    if re.search(r"mlp\.(gate|up)\.w$", path):
        return spec_nd(_pick(mesh, shape[-2], fs), _pick(mesh, shape[-1], mdl))
    if path.endswith("mlp.down.w"):
        return spec_nd(_pick(mesh, shape[-2], mdl), _pick(mesh, shape[-1], fs))
    # moe ---------------------------------------------------------------------
    if path.endswith("router.w"):
        return spec_nd(None, None)
    if re.search(r"moe\.(gate|up)$", path):
        return spec_nd(_pick(mesh, shape[-3], mdl), _pick(mesh, shape[-2], fs),
                       None)
    if path.endswith("moe.down"):
        return spec_nd(_pick(mesh, shape[-3], mdl), None,
                       _pick(mesh, shape[-1], fs))
    # ssm ---------------------------------------------------------------------
    if path.endswith("ssm.in_proj.w"):
        return spec_nd(_pick(mesh, shape[-2], fs), None)
    if path.endswith("ssm.out_proj.w"):
        return spec_nd(_pick(mesh, shape[-2], mdl), _pick(mesh, shape[-1], fs))
    # everything small (norms, conv, biases, A_log, D) ------------------------
    return _spec(*[None] * nd)


def _adapter_spec(mesh, path: str, shape: tuple[int, ...],
                  policy: str = "2d") -> Spec:
    nd = len(shape)
    if policy == "dp":
        fs, mdl = ("data", "model"), None
    else:
        fs, mdl = "data", "model"

    def spec_nd(*tail):
        lead = nd - len(tail)
        return _spec(*([None] * lead + list(tail)))

    if path.endswith(".A"):        # (L?, d_in, r)
        return spec_nd(_pick(mesh, shape[-2], fs), None)
    if path.endswith(".B"):        # (L?, r, d_out)
        return spec_nd(None, _pick(mesh, shape[-1], mdl))
    if path.endswith(".W"):        # linear (L?, d_in, d_out)
        return spec_nd(_pick(mesh, shape[-2], fs), _pick(mesh, shape[-1], mdl))
    if path.endswith(".W1"):
        return spec_nd(_pick(mesh, shape[-2], fs), None)
    if path.endswith(".W2"):
        return spec_nd(None, _pick(mesh, shape[-1], mdl))
    return _spec(*[None] * nd)


def _path_str(key_path) -> str:
    return ".".join(str(k) for k in key_path)


def _is_leaf_spec(t) -> bool:
    """A (shape, dtype) pair, as ``model.cache_specs`` gives a leaf."""
    return (isinstance(t, tuple) and len(t) == 2
            and isinstance(t[0], (tuple, torch.Size))
            and isinstance(t[1], torch.dtype))


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, tuples and lists; a leaf is a
    tensor, a (shape, dtype) pair or a ``Spec``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if (isinstance(tree, (tuple, list)) and not isinstance(tree, Spec)
            and not _is_leaf_spec(tree)):
        return type(tree)(_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf[0]) if _is_leaf_spec(leaf) else tuple(leaf.shape)


def params_shardings(mesh, params_shapes: PyTree, adapter: bool = False,
                     policy: str = "2d") -> PyTree:
    """Specs for a params(-shaped) tree; its leaves may be tensors on any
    device, the meta device's included."""
    rule = _adapter_spec if adapter else _param_spec
    return _map(lambda p, leaf: rule(mesh, _path_str(p), _shape(leaf), policy),
                params_shapes)


# ---------------------------------------------------------------------------
# batch / cache / delta shardings
# ---------------------------------------------------------------------------

def batch_axes(mesh, policy: str = "2d") -> tuple[str, ...]:
    names = ("pod", "data", "model") if policy == "dp" else ("pod", "data")
    shape = mesh_shape(mesh)
    return tuple(a for a in names if a in shape)


def batch_shardings(mesh, specs: PyTree, policy: str = "2d") -> PyTree:
    ba = batch_axes(mesh, policy)
    nb = _size(mesh_shape(mesh), ba)

    def one(_, leaf):
        shape = _shape(leaf)
        first = ba if shape and _div(shape[0], nb) else None
        return _spec(first, *[None] * (len(shape) - 1))

    return _map(one, specs)


def cache_shardings(mesh, cache_specs: PyTree) -> PyTree:
    """KV caches (L, B, S, K, dh) / ssm states (L, B, H, P, N) / conv states.

    Rule: shard B over batch axes when divisible; otherwise shard the longest
    remaining dim (sequence for KV, heads for SSM) over model (+ data if batch
    could not be used) — sequence-parallel decode."""
    ba = batch_axes(mesh)
    nb = _size(mesh_shape(mesh), ba)
    nm = _axis(mesh, "model")

    def one(_, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        spec: list = [None] * nd
        used_batch = False
        if nd >= 2 and _div(shape[1], nb):
            spec[1] = ba
            used_batch = True
        # the best dim for "model": dim 2 first (the seq / heads axis)
        for i in (2, 3, 4):
            if i < nd and spec[i] is None:
                if not used_batch and _div(shape[i], nm * nb):
                    spec[i] = tuple(list(ba) + ["model"])
                    break
                if _div(shape[i], nm):
                    spec[i] = "model"
                    break
        return _spec(*spec)

    return _map(one, cache_specs)


def delta_shardings(mesh, delta_specs: PyTree) -> PyTree:
    """Mode-A deltas (L?, B, S, d_out): batch over (pod,data), d_out over model."""
    ba = batch_axes(mesh)
    nb = _size(mesh_shape(mesh), ba)
    nm = _axis(mesh, "model")

    def one(_, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        spec: list = [None] * nd
        b_axis = nd - 3
        if _div(shape[b_axis], nb):
            spec[b_axis] = ba
        if _div(shape[-1], nm):
            spec[-1] = "model"
        return _spec(*spec)

    return _map(one, delta_specs)


def replicated(mesh, tree: PyTree) -> PyTree:
    return _map(lambda _, leaf: _spec(*[None] * len(_shape(leaf))), tree)


# ---------------------------------------------------------------------------
# placing tensors (a DeviceMesh)
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_split(mesh, spec: Spec) -> bool:
    """Whether ``spec`` splits a dim over more than one rank."""
    shape = mesh_shape(mesh)
    return any(_size(shape, _entry_axes(e)) > 1 for e in spec)


def placements(mesh: DeviceMesh, spec: Spec) -> tuple:
    """DTensor placements, one a mesh dim, of ``spec``. A dim split over a
    tuple of axes is ``Shard(dim)`` on each of their mesh dims; where the
    tuple names an axis before one that precedes it in the mesh (JAX's
    ("model", "data") on a ("data", "model") mesh), that axis's mesh dim is
    ``_StridedShard`` over the product of those later axes' sizes, so the
    rank's block is the one JAX's major-to-minor order gives it."""
    names = list(mesh.mesh_dim_names)
    shape = mesh_shape(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        for j, a in enumerate(axes):
            k = names.index(a)
            split = 1
            for b in axes[:j]:
                if names.index(b) > k:
                    split *= shape[b]
            out[k] = (_StridedShard(dim, split_factor=split) if split > 1
                      else Shard(dim))
    return tuple(out)


def local_slice(mesh: DeviceMesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The block of the whole tensor ``x`` that this rank holds under
    ``spec``: along a dim split over axes (a1, ..., an), block index
    c(a1) * |a2| ... |an| + ... + c(an), of len / (|a1| ... |an|) entries
    (a view)."""
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n, idx = 1, 0
        for a in axes:
            idx = idx * shape[a] + coord[a]
            n *= shape[a]
        if n > 1:
            step = x.shape[dim] // n
            x = x.narrow(dim, idx * step, step)
    return x


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def place(mesh: DeviceMesh, x: torch.Tensor, spec: Spec) -> DTensor:
    """The whole tensor ``x`` (the same on every rank) as a DTensor at
    ``spec``. Unsplit, it is wrapped as it is (no copy); split, the rank's
    block is copied, so ``x`` can be freed once the caller drops it."""
    pl = placements(mesh, spec)
    if not is_split(mesh, spec):
        return DTensor.from_local(x, mesh, pl, run_check=False)
    local = local_slice(mesh, x, spec).contiguous().clone()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=x.shape,
                              stride=_contiguous_stride(x.shape))


def wrap(mesh: DeviceMesh, local: torch.Tensor, spec: Spec,
         shape) -> DTensor:
    """This rank's block ``local`` of a whole tensor of ``shape`` placed at
    ``spec``, as a DTensor (no copy, no move)."""
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def map_with_specs(fn, tree: PyTree, specs: PyTree) -> PyTree:
    """``fn(leaf, spec)`` over the leaves of ``tree``, each with its spec in
    ``specs`` (a tree of the same structure)."""
    flat = {}
    _map(lambda p, s: flat.__setitem__(p, s), specs)
    return _map(lambda p, x: fn(x, flat[p]), tree)


def distribute(mesh: DeviceMesh, tree: PyTree, specs: PyTree) -> PyTree:
    """``place`` every leaf of ``tree`` at its spec in ``specs``, one leaf at
    a time."""
    return map_with_specs(lambda x, s: place(mesh, x, s), tree, specs)


def gathered(x):
    """A leaf whole: a DTensor split over more than one rank is gathered
    (``full_tensor``), any other DTensor gives its local tensor (no copy); a
    plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if any(not isinstance(p, Replicate) and mesh.size(k) > 1
           for k, p in enumerate(x.placements)):
        return x.full_tensor()
    return x.to_local()
