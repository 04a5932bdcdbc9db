"""Gradient Learning (GL): the paper's core algorithm, in PyTorch.

Two equivalent executions of the same math (Prop 1):

- **Mode A, faithful_offload** (paper Alg. 1): the server step runs forward +
  backward *with respect to injected deltas only* (``torch.autograd.grad``
  of the loss w.r.t. zero deltas at the taps), exporting adaptation data
  ``{tap: (x, grad_h)}``. ``fit_grads`` then evaluates the gradient of the
  quadratic fit loss (Eq. 6) anywhere, with no access to the base model.
- **Mode B, fused_fit**: the adapter gradients come from the same backward
  pass (``train_step_b``), which by Prop 1 gives the same numbers.

Also here: the baselines the paper compares against (LoRA == Mode B with an
on-device optimizer; full fine-tuning) and tap selection.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ColaConfig, ModelConfig
from repro_torch.core import adapters as adapters_lib
from repro_torch.core import taps as taps_lib
from repro_torch.core.taps import ColaSpec
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import model as model_lib
from repro_torch.utils import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# tap selection
# ---------------------------------------------------------------------------

def select_taps(cfg: ModelConfig, taps: str) -> tuple[str, ...]:
    sites = model_lib.tap_sites(cfg)
    if taps == "qv":
        names = [n for n in sites
                 if n.endswith("attn.q") or n.endswith("attn.v")]
        if not names:   # attention-free (mamba2): tap the SSM projections
            names = [n for n in sites if ".ssm." in n]
    elif taps == "all_attn":
        names = [n for n in sites if ".attn." in n]
    elif taps == "mlp":
        names = [n for n in sites if ".mlp." in n]
    elif taps == "ssm":
        names = [n for n in sites if ".ssm." in n]
    elif taps == "all":
        names = list(sites)
    else:
        names = [n for n in sites if n in taps.split(",")]
        if not names:
            raise ValueError(f"no taps matched {taps!r}")
    return tuple(sorted(names))


def make_spec(cfg: ModelConfig, cc: ColaConfig) -> ColaSpec:
    taps = select_taps(cfg, cc.taps)
    if cc.mode in ("ft", "frozen"):
        return taps_lib.make_spec()
    collect = inject = ()
    families = {t: cc.family for t in taps}
    if cc.mode == "faithful_offload":
        collect, inject = taps, taps
        if cc.merged:
            # merged server pass: adapters folded into the base weights, only
            # injection + collection live in the graph (zero adapter FLOPs)
            families = {}
    return taps_lib.ColaSpec(families=tuple(sorted(families.items())),
                             collect=collect, inject=inject, scale=cc.scale,
                             rank=cc.rank, hidden=cc.hidden)


def init_adapters(cfg: ModelConfig, cc: ColaConfig, gen: torch.Generator,
                  dtype=torch.float32, device=None) -> dict:
    """Initial adapters {tap: w} (g(x) == 0), drawn from ``gen``."""
    taps = select_taps(cfg, cc.taps)
    spec = taps_lib.make_spec(family=cc.family, taps=taps, rank=cc.rank,
                              hidden=cc.hidden, scale=cc.scale)
    return taps_lib.init_adapter_vars(spec, model_lib.tap_sites(cfg), gen,
                                      dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Mode A: server step (grad of hidden representations only) + offloaded fit
# ---------------------------------------------------------------------------

def zero_deltas(cfg: ModelConfig, spec: ColaSpec, batch: int, seq: int,
                dtype=torch.float32, device="cuda") -> dict:
    sites = model_lib.tap_sites(cfg)
    return {name: torch.zeros(model_lib.delta_shape(cfg, sites[name], batch,
                                                    seq),
                              dtype=dtype, device=device)
            for name in spec.inject}


def server_step_a(cfg: ModelConfig, spec: ColaSpec, params: dict,
                  adapters: dict, batch: dict):
    """Paper Alg. 1 lines 4-9: one forward + backward on the base device,
    giving the loss and adaptation data {tap: (x (L, B, S, d_in),
    grad_h (L, B, S, d_out) f32)}. Only the zero deltas are differentiated;
    base params and adapters are not.

    ``params`` should already be merged in merged mode (then
    ``spec.families`` is empty and adapters are not applied in the graph).
    The batch holds "tokens" or, with ``embed_input``, "embeds"; B and S
    are its first two axes either way.
    """
    tok = batch.get("tokens", batch.get("embeds"))
    deltas = {t: d.requires_grad_() for t, d in zero_deltas(
        cfg, spec, tok.shape[0], tok.shape[1], device=tok.device).items()}
    loss, aux = model_lib.loss_fn(cfg, params, batch, spec,
                                  {"adapters": adapters, "deltas": deltas})
    grads = torch.autograd.grad(loss, [deltas[t] for t in spec.inject])
    collected = aux["collected"]
    data = {t: (collected[t].detach(), g) for t, g in zip(spec.inject, grads)}
    return loss.detach(), data, aux


def _fit_stack(fam: str, w: dict, x: torch.Tensor, g: torch.Tensor) -> dict:
    """Fit gradient of one tap for a stack of layers: every leaf of ``w`` and
    x (L, T, d_in), g (L, T, d_out) carry the layer axis. lowrank goes
    through the cola_fit kernel, which takes the layer axis itself; other
    families take the VJP of the adapter per layer."""
    if fam == "lowrank":
        dA, dB = kernel_ops.cola_fit_lowrank(x, g, w["A"], w["B"])
        return {"A": dA, "B": dB}

    def one(w_l, x_l, g_l):
        _, vjp = torch.func.vjp(
            lambda ww: adapters_lib.apply(fam, ww, x_l), w_l)
        return vjp(g_l)[0]

    return torch.func.vmap(one)(w, x, g)


def fit_grads(spec: ColaSpec, adapters: dict, data: dict[str, tuple]) -> dict:
    """Gradient of the quadratic fit loss (Eq. 6) evaluated at w_t.

    By Prop 1, dl/dw at w_t = (dg/dw)^T grad_h: a VJP of the adapter alone,
    for any family. ``data``: {tap: (x, grad_h)} with x (L?, B, S, d_in).
    Returns {tap: grads} matching ``adapters``, in f32.
    """
    out = {}
    fam_map = spec.family_map
    for tap, (x, gh) in data.items():
        fam = fam_map[tap]
        w = adapters[tap]
        stacked = tree_leaves(w)[0].dim() > 2   # leading layer axis present?
        ghs = (gh * spec.scale).to(torch.float32)
        xs = x.to(torch.float32)
        if xs.dim() == 4:
            n = xs.shape[0]
            xs = xs.reshape(n, -1, xs.shape[-1])
            ghs = ghs.reshape(n, -1, ghs.shape[-1])
            if stacked:
                out[tap] = _fit_stack(fam, w, xs, ghs)
            else:
                # shared site: one adapter, per-invocation data; grads sum
                rep = tree_map(lambda a: a.expand(n, *a.shape), w)
                out[tap] = tree_map(lambda a: a.sum(0),
                                    _fit_stack(fam, rep, xs, ghs))
        else:
            xr = xs.reshape(1, -1, xs.shape[-1])
            gr = ghs.reshape(1, -1, ghs.shape[-1])
            out[tap] = tree_map(lambda a: a[0], _fit_stack(
                fam, tree_map(lambda a: a[None], w), xr, gr))
    return out


def fit_loss(spec: ColaSpec, adapters: dict, data: dict[str, tuple],
             adapters_t: dict) -> torch.Tensor:
    """The literal quadratic objective of Eq. 6:
    1/2 || g_w(x) - (dh_t - grad_h) ||^2 summed over taps, with
    ``adapters_t`` the w_t snapshot that defines dh_t."""
    terms = []
    fam_map = spec.family_map
    for tap, (x, gh) in data.items():
        fam = fam_map[tap]
        xr = x.to(torch.float32)
        ghr = (gh * spec.scale).to(torch.float32)
        stacked = tree_leaves(adapters[tap])[0].dim() > 2

        def g_apply(w, xx, fam=fam):
            return adapters_lib.apply(fam, w, xx)

        if stacked and xr.dim() == 4:
            dh_t = torch.func.vmap(g_apply)(adapters_t[tap], xr)
            pred = torch.func.vmap(g_apply)(adapters[tap], xr)
        else:   # unstacked: one adapter, broadcast over any leading axes
            dh_t = g_apply(adapters_t[tap], xr)
            pred = g_apply(adapters[tap], xr)
        terms.append(0.5 * torch.sum((pred - (dh_t - ghr)) ** 2))
    return torch.stack(terms).sum()


# ---------------------------------------------------------------------------
# Mode B: fused fit (and the LoRA baseline, which shares its math)
# ---------------------------------------------------------------------------

def _requiring_grad(tree: dict) -> dict:
    return tree_map(lambda a: a.detach().requires_grad_(), tree)


def _grads_like(loss: torch.Tensor, tree: dict) -> dict:
    """Gradients of ``loss`` shaped as ``tree``; an empty tree (the frozen
    mode's adapters) has none, as JAX's ``value_and_grad`` of one."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    it = iter(torch.autograd.grad(loss, leaves))
    return tree_map(lambda _: next(it), tree)


def train_step_b(cfg: ModelConfig, spec: ColaSpec, params: dict,
                 adapters: dict, batch: dict):
    """Loss + adapter gradients in one backward pass. Base params are not
    differentiated (frozen). Returns (loss, grads, aux)."""
    ad = _requiring_grad(adapters)
    loss, aux = model_lib.loss_fn(cfg, params, batch, spec, {"adapters": ad})
    return loss.detach(), _grads_like(loss, ad), aux


def train_step_ft(cfg: ModelConfig, params: dict, batch: dict):
    """Full fine-tuning baseline: gradients of every base parameter."""
    p = _requiring_grad(params)
    loss, aux = model_lib.loss_fn(cfg, p, batch)
    return loss.detach(), _grads_like(loss, p), aux
