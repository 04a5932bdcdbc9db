"""LM assembly: embedding -> a Python loop over the stacked pre-norm blocks
(where JAX has ``lax.scan``) -> final norm -> tied head.

Layer plans (``layer_plan``, as in the JAX package):
- "uniform": one stack of identical blocks ("layers.*" taps), e.g.
  ``smollm-135m``, ``gpt2-small``, the mistrals, ``musicgen-medium`` and
  ``pixtral-12b``, and the MoE configs ``qwen3-moe-30b-a3b`` (QK-norm) and
  ``dbrx-132b``, whose blocks route to experts and add the switch aux loss
  to the training loss;
- "pairs": gemma2's alternating local/global layers, two stacks
  ("layers_a.*" local with ``window=local_window``, "layers_b.*" global),
  walked pair by pair; under the paged KV layout the local stack keeps a
  per-slot ring cache instead of pool blocks;
- the SSM plan: "uniform" over Mamba2 blocks (``mamba2-370m``, taps
  "layers.ssm.in" / "layers.ssm.out"), whose decode cache is each layer's
  recurrent state ({"conv", "ssm"}, the same in both KV layouts) instead
  of K/V;
- "hybrid": zamba2-7b's segments of ``shared_attn_every`` Mamba2 layers
  ("layers.*"), each led by one call of the shared attention block
  ("shared.*": one unstacked parameter set and adapter used at every
  call, a Mode-A delta and a collected input a call); its cache holds the
  Mamba2 layers' recurrent state and the shared block's K/V a call (dense,
  or a paged pool).
Every plan serves and trains (ColA's taps and deltas on every stack).

Inputs and head (``embed_tokens``, ``head_logits``): token ids (B, S) and a
tied head, logits (..., V); musicgen's ``n_codebooks`` streams (B, S, CB),
their embeddings summed, and an untied ``lm_head`` giving (..., CB, V),
labels (B, S, CB); pixtral's ``embed_input``, precomputed embeddings
{"embeds": (B, S, d)} and a separate ``unembed`` head. B, S and a step's c
come from the embedded input, whichever key the batch holds.

Parameters are the JAX package's pytree as nested dicts of tensors, layer
leaves stacked on a leading (n,) axis per stack (the shared block's
unstacked).

Entry points: init, forward, loss_fn, prefill, decode_step, init_cache,
scatter_prefill_cache, tap_sites, delta_shape.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.taps import ColaSpec, TapSite
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import remat
from repro_torch.models import ssm as S
from repro_torch.utils import (canonical_dtype, cdiv, resolve_device,
                               tree_leaves)


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig):
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        starts = list(range(0, cfg.n_layers, every))
        segs = [(s, min(s + every, cfg.n_layers) - s) for s in starts]
        return ("hybrid", segs)
    if cfg.family == "dense" and cfg.attn_pattern == "local_global":
        return ("pairs", cfg.n_layers // 2)
    kind = "ssm" if cfg.family == "ssm" else "attn"
    return ("uniform", kind)


def _require_ported(cfg: ModelConfig) -> tuple:
    """The plan of ``cfg`` (``layer_plan``): the port runs every registered
    architecture, so none raises."""
    return layer_plan(cfg)


def _stacks(cfg: ModelConfig) -> dict[str, int]:
    """The plan's layer stacks and their depths: "layers" for the uniform
    plan, "layers_a" (local) and "layers_b" (global) for the pairs plan,
    "layers" and the unstacked "shared" (depth 0, as ``TapSite.stacked``)
    for the hybrid plan."""
    plan = _require_ported(cfg)
    if plan[0] == "pairs":
        return {"layers_a": plan[1], "layers_b": plan[1]}
    if plan[0] == "hybrid":
        return {"layers": cfg.n_layers, "shared": 0}
    return {"layers": cfg.n_layers}


def _calls(cfg: ModelConfig, prefix: str) -> int:
    """How many times a pass runs stack ``prefix``: its depth, or for the
    hybrid plan's shared block its number of segments."""
    n = _stacks(cfg)[prefix]
    return n if n else len(layer_plan(cfg)[1])


def _units(cfg: ModelConfig):
    """The checkpointed units in the order they run, each a tuple of its
    layers' (stack, index, attention window): the uniform plan's layers
    one a unit; the pairs plan's pairs, layer a with
    ``window=local_window`` and then layer b with no window, as JAX's
    ``_scan_pairs`` checkpoints its body; the hybrid plan's segments, each
    the shared block (its index the call, JAX's ``_run_hybrid``) and then
    the segment's Mamba2 layers, one a unit (JAX runs the shared block
    outside any checkpoint: ROADMAP C.13)."""
    plan = _require_ported(cfg)
    if plan[0] == "pairs":
        for i in range(plan[1]):
            yield (("layers_a", i, cfg.local_window), ("layers_b", i, None))
    elif plan[0] == "hybrid":
        for i, (start, n) in enumerate(plan[1]):
            yield (("shared", i, None),)
            for j in range(start, start + n):
                yield (("layers", j, None),)
    else:
        for i in range(cfg.n_layers):
            yield (("layers", i, None),)


def _walk(cfg: ModelConfig):
    """(stack, index, attention window) in the order the layers run: the
    units' layers in turn."""
    for unit in _units(cfg):
        yield from unit


def _layer(tree, i: int):
    """Layer i of a pytree whose leaves carry a leading (L,) axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _subvars(d: dict | None, prefix: str) -> dict:
    if not d:
        return {}
    return {k: v for k, v in d.items() if k.startswith(prefix + ".")}


def _site_vars(prefix: str, i: int, params: dict, ad: dict, de: dict
               ) -> tuple[dict, dict, dict]:
    """(parameters, adapters, deltas) of index i of stack ``prefix``: layer
    i of a stacked one; the shared block's call i takes its parameters and
    adapters whole and its own delta of each tap."""
    if prefix == "shared":
        return (params["shared"], ad["shared"],
                {t: d[i] for t, d in de["shared"].items()})
    return (_layer(params[prefix], i), _layer(ad[prefix], i),
            _layer(de[prefix], i))


# ---------------------------------------------------------------------------
# tap sites
# ---------------------------------------------------------------------------

def delta_shape(cfg: ModelConfig, site: TapSite, batch: int, seq: int
                ) -> tuple:
    """Shape of the Mode-A injected delta of one tap; stacked sites carry the
    layer axis, the hybrid plan's shared sites one delta a call (so each
    call gets its own gradient, JAX's ``delta_shape``). Under a step's
    tensor-parallel plan the last dim is the rank's block under
    ``delta_shardings``."""
    plan = tp.current()
    width = site.d_out if plan is None else plan.delta_width(site.d_out)
    return site.lead() + (batch, seq, width)


def tap_sites(cfg: ModelConfig) -> dict[str, TapSite]:
    """Every tappable Dense site, "<stack>.<site>", stacked over its stack's
    depth: a Mamba2 block's in and out projections (the ssm plan's, the
    hybrid plan's "layers"), else the attention projections and the gated
    MLP's where the config has one (``d_ff``; the experts carry no taps).
    The hybrid plan's shared block is unstacked and called once a
    segment."""
    sites = {}
    for prefix, n in _stacks(cfg).items():
        if _mamba_stack(cfg, prefix):
            dims = S.ssm_dims(cfg.d_model, expand=cfg.ssm_expand,
                              headdim=cfg.ssm_headdim, state=cfg.ssm_state)
            named = [("ssm.in", cfg.d_model, S.d_in_proj(dims)),
                     ("ssm.out", dims["d_inner"], cfg.d_model)]
        else:
            named = [
                ("attn.q", cfg.d_model, cfg.n_heads * cfg.d_head),
                ("attn.k", cfg.d_model, cfg.n_kv_heads * cfg.d_head),
                ("attn.v", cfg.d_model, cfg.n_kv_heads * cfg.d_head),
                ("attn.o", cfg.n_heads * cfg.d_head, cfg.d_model),
            ]
            if cfg.d_ff:
                named += [("mlp.gate", cfg.d_model, cfg.d_ff),
                          ("mlp.up", cfg.d_model, cfg.d_ff),
                          ("mlp.down", cfg.d_ff, cfg.d_model)]
        for nm, din, dout in named:
            sites[f"{prefix}.{nm}"] = TapSite(
                f"{prefix}.{nm}", din, dout, n,
                calls=0 if n else _calls(cfg, prefix))
    return sites


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters with the JAX package's shapes, scales and dtypes,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from ``jax.random``'s; tests carry JAX weights across with
    ``convert.params_from_numpy`` instead). Expert leaves are drawn a layer
    at a time (``normal_by_layer``); every other leaf in one draw. The
    Mamba2 blocks' ``dt_bias``, ``A_log`` and ``D`` are f32 in any
    ``param_dtype``, as in JAX. The input and head leaves are JAX's: with
    codebooks ``embed.emb`` (CB, V, d) and ``lm_head.w`` (d, CB * V); with
    ``embed_input`` only ``unembed.emb`` (V, d); else ``embed.emb`` (V, d),
    and ``lm_head.w`` (d, V) where the head is untied."""
    stacks = _stacks(cfg)
    dev = resolve_device(device)
    dt = canonical_dtype(cfg.param_dtype)
    # the meta device (shapes and dtypes only) takes no generator
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))

    def normal(shape, std):
        # scaled in place: one f32 draw at a time (zamba2's 81 in_proj
        # weights are 4.2 G elements)
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return w.mul_(std).to(dt)

    def normal_by_layer(shape, std):
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            out[i] = torch.randn(shape[1:], generator=gen, device=dev,
                                 dtype=torch.float32).mul_(std)
        return out

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=dt, device=dev)}

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    d = cfg.d_model
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head

    def stack(n):
        """n attention blocks stacked, or one unstacked block for n == 0
        (the hybrid plan's shared block)."""
        lead = (n,) if n else ()

        def dense(d_in, d_out):
            return {"w": normal(lead + (d_in, d_out), d_in ** -0.5)}

        attn = {"q": dense(d, hq), "k": dense(d, hkv), "v": dense(d, hkv),
                "o": dense(hq, d)}
        if cfg.qk_norm:
            attn["q_norm"] = ones(*lead, cfg.d_head)
            attn["k_norm"] = ones(*lead, cfg.d_head)
        p = {"ln1": ones(*lead, d), "attn": attn, "ln2": ones(*lead, d)}
        if cfg.n_experts:
            p["moe"] = M.moe_init(n, d, cfg.n_experts, cfg.d_expert,
                                  normal=normal,
                                  normal_by_layer=normal_by_layer)
        else:
            p["mlp"] = {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                        "down": dense(cfg.d_ff, d)}
        if cfg.post_norm:
            p["post_ln1"] = ones(*lead, d)
            p["post_ln2"] = ones(*lead, d)
        return p

    V = cfg.vocab_size
    if cfg.n_codebooks:
        params = {"embed": {"emb": normal((cfg.n_codebooks, V, d), 0.02)},
                  "lm_head": {"w": normal((d, cfg.n_codebooks * V),
                                          d ** -0.5)}}
    elif cfg.embed_input:
        params = {"unembed": {"emb": normal((V, d), 0.02)}}
    else:
        params = {"embed": {"emb": normal((V, d), 0.02)}}
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": normal((d, V), d ** -0.5)}
    for prefix, n in stacks.items():
        params[prefix] = (B.ssm_block_init(cfg, n, normal=normal,
                                           uniform=uniform, full=full)
                          if _mamba_stack(cfg, prefix) else stack(n))
    params["final_norm"] = ones(d)
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """The input (B, S, d) in the compute dtype: ``batch["embeds"]`` cast
    with ``embed_input``; with codebooks the CB streams' embeddings of
    ``batch["tokens"]`` (B, S, CB) added to zeros in the compute dtype one
    codebook at a time, 0 first (JAX's order: in bf16 each add rounds);
    else the tokens' embeddings. With ``embed_scale`` times sqrt(d_model)
    rounded to that dtype first (59.75 in bf16 at gemma2's 3584), as JAX's
    ``jnp.asarray(d_model ** 0.5, cdt)``. Under a step's plan the table is
    taken in its compute layout (``tensor_parallel.take``); under its
    sequence split (``Plan.seq``) the result is the rank's (B, S / n, d)
    rows."""
    cdt = canonical_dtype(cfg.compute_dtype)
    if cfg.embed_input:
        x = tp.replicated_out(batch["embeds"].to(cdt))
    elif cfg.n_codebooks:
        toks = batch["tokens"].long()
        emb = tp.take("embed.emb", params["embed"]["emb"])
        x = torch.zeros(toks.shape[:2] + (cfg.d_model,), dtype=cdt,
                        device=emb.device)
        for cb in range(cfg.n_codebooks):
            x = x + emb[cb][toks[..., cb]].to(cdt)
        x = tp.replicated_out(x)
    else:
        emb = {"emb": tp.take("embed.emb", params["embed"]["emb"])}
        x = L.embed(emb, batch["tokens"]).to(cdt)
    if cfg.embed_scale:
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def head_weight(cfg: ModelConfig, params: dict) -> torch.Tensor:
    """The head's (d, V) weight in its compute layout: the tied embedding's
    or ``unembed``'s (``embed_input``) transpose, or an untied ``lm_head``
    (under a vocab split, the rank's vocab columns)."""
    if cfg.embed_input:
        return tp.take("unembed.emb", params["unembed"]["emb"]).T
    if cfg.n_codebooks or not cfg.tie_embeddings:
        return tp.take("lm_head.w", params["lm_head"]["w"])
    return tp.take("embed.emb", params["embed"]["emb"]).T


def head_logits(cfg: ModelConfig, params: dict, h: torch.Tensor,
                w: torch.Tensor | None = None) -> torch.Tensor:
    """h (..., d) -> logits (..., V) in h's dtype (so bf16 at full width):
    through ``head_weight`` (or ``w``, its result); with codebooks (..., CB,
    V), column cb * V + v of ``lm_head`` being codebook cb's token v.
    ``final_softcap`` takes the tanh in f32 and casts back. Under a vocab
    split, the rank's vocab columns."""
    if w is None:
        w = head_weight(cfg, params)
    logits = tp.head_input(h) @ w.to(h.dtype)
    if cfg.n_codebooks:
        logits = logits.reshape(h.shape[:-1] + (cfg.n_codebooks,
                                                cfg.vocab_size))
    if cfg.final_softcap:
        logits = L.softcap(logits.to(torch.float32),
                           cfg.final_softcap).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------

def _seq_len(batch: dict) -> int:
    """The sequence length S of a batch's tokens or embeddings."""
    return batch.get("tokens", batch.get("embeds")).shape[1]


_INPUT_METERS: list["layer_input_meter"] = []


class layer_input_meter:
    """While active, ``shapes`` and ``bytes`` record every unit input that
    ``hidden_states`` passes to a checkpointed unit (``_units``: a layer, or
    a pair of the pairs plan; the tensor ``remat`` "full" and "dots" save
    for the unit's recompute): its shape, and its bytes summed."""

    def __init__(self):
        self.shapes: list[tuple[int, ...]] = []
        self.bytes = 0

    def saw(self, x: torch.Tensor) -> None:
        self.shapes.append(tuple(x.shape))
        self.bytes += x.numel() * x.element_size()

    def __enter__(self) -> "layer_input_meter":
        _INPUT_METERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _INPUT_METERS.remove(self)


def _block(cfg: ModelConfig, prefix: str, window: int | None, lp: dict,
           x: torch.Tensor, positions: torch.Tensor, spec, ad_l: dict,
           de_l: dict, closes: bool):
    """One layer of stack ``prefix``; returns (x, the MoE aux loss or None,
    the layer's cache leaves ({"k", "v"}, or a Mamba2 block's final
    {"conv", "ssm"} state), {tap: hidden input x} collected). Under a step's
    plan the layer's leaves are gathered here, inside the checkpointed
    function, so a recompute gathers them again and nothing keeps them.
    ``closes``: the layer ends its unit (the blocks' ``closes``)."""
    lp, ad_l = tp.take_layer(prefix, lp, ad_l)
    aux: dict = {}
    tap_ctx = (spec, ad_l, de_l, aux)
    if "ssm" in lp:
        x, st = B.ssm_block(cfg, lp, x, tap_prefix=prefix, tap_ctx=tap_ctx,
                            closes=closes)
        return x, None, st, aux
    x, moe_aux, (k, v) = B.attn_block(cfg, lp, x, positions, window=window,
                                      tap_prefix=prefix, tap_ctx=tap_ctx,
                                      closes=closes)
    return x, moe_aux, {"k": k, "v": v}, aux


def _unit(cfg: ModelConfig, unit: tuple, x: torch.Tensor,
          positions: torch.Tensor, spec, site_vars: list):
    """The layers of one unit (``_units``) in turn, ``site_vars`` each one's
    (parameters, adapters, deltas); returns (x, each layer's ``_block``
    results but x)."""
    out = []
    for n, ((prefix, _, window), (lp, ad_l, de_l)) in enumerate(
            zip(unit, site_vars)):
        x, *rest = _block(cfg, prefix, window, lp, x, positions, spec, ad_l,
                          de_l, closes=n == len(unit) - 1)
        out.append(rest)
    return x, out


def hidden_states(cfg: ModelConfig, params: dict, batch: dict,
                  spec: ColaSpec | None = None, cola_vars: dict | None = None,
                  *, collect_kv: bool = False):
    """Embedding + all layers + final norm. Returns (h, aux):
    aux["moe_aux"] is the layers' mean MoE aux loss (0 without experts);
    aux["collected"] holds each collected tap's hidden inputs stacked per
    layer of its stack, {tap: (n, B, S, d_in)} (the hybrid plan's shared
    taps per call, (n_seg, B, S, d_in): JAX's ``collected_shared``); with
    ``collect_kv`` aux["stacked"] holds every layer's cache leaves per
    stack, {stack: {"k", "v": (n, B, S, K, Dh)}} (on the ssm plan the final
    {"conv": (n, B, W-1, C), "ssm": (n, B, H, P, N)} state; on the hybrid
    plan both, "shared" one K/V a call), written into one tensor as the
    layers run (never a list and a stacked copy at once).

    Each unit (``_units``) runs under ``cfg.remat``
    (``remat.checkpointed``) when a tensor of ``params`` or ``cola_vars``
    takes a gradient. Under a step's sequence split
    (``tensor_parallel.Plan.seq``) the residual stream between blocks, each
    unit's (checkpointed) input and the returned h are the rank's (B, S /
    n, d) rows; K / V, states and collected inputs are the whole
    sequence's, as without it."""
    stacks = _stacks(cfg)
    ad = {p: _subvars((cola_vars or {}).get("adapters", {}), p) for p in stacks}
    de = {p: _subvars((cola_vars or {}).get("deltas", {}), p) for p in stacks}
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves([params, cola_vars or {}]))
    run = remat.checkpointed(cfg.remat, _unit, needs_grad)
    x = embed_tokens(cfg, params, batch)
    positions = torch.arange(_seq_len(batch), dtype=torch.int32,
                             device=x.device)[None, :]
    kv_out: dict[str, dict] = {}
    collected: dict[str, list] = {}
    moe_aux = []
    for unit in _units(cfg):
        site_vars = [_site_vars(prefix, i, params, ad, de)
                     for prefix, i, _ in unit]
        for m in _INPUT_METERS:
            m.saw(x)
        x, outs = run(cfg, unit, x, positions, spec, site_vars)
        for (prefix, i, _), (layer_aux, leaves, got) in zip(unit, outs):
            for tap, xin in got.items():
                collected.setdefault(tap, []).append(xin)
            if layer_aux is not None:
                moe_aux.append(layer_aux)
            if collect_kv:
                if prefix not in kv_out:
                    kv_out[prefix] = {n: t.new_empty((_calls(cfg, prefix),)
                                                     + t.shape)
                                      for n, t in leaves.items()}
                for n, t in leaves.items():
                    kv_out[prefix][n][i] = t
    aux: dict[str, Any] = {
        "moe_aux": (torch.stack(moe_aux).mean() if moe_aux else
                    torch.zeros((), dtype=torch.float32, device=x.device)),
        "collected": {t: torch.stack(xs) for t, xs in collected.items()}}
    if collect_kv:
        aux["stacked"] = kv_out
    return L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps,
                     plus_one=cfg.norm_plus_one), aux


def forward(cfg: ModelConfig, params: dict, batch: dict,
            spec: ColaSpec | None = None, cola_vars: dict | None = None):
    h, aux = hidden_states(cfg, params, batch, spec, cola_vars)
    return head_logits(cfg, params, tp.whole_sequence(h)), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _ce(logits: torch.Tensor, labels: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of CE and count over valid (label >= 0) positions (with
    codebooks, (position, codebook) pairs). f32 math. Under a vocab split
    the logits are the rank's columns (``tensor_parallel.vocab_ce``)."""
    lf = logits.to(torch.float32)
    plan = tp.vocab_head()
    if plan is not None:
        return tp.vocab_ce(plan, lf, labels)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    valid = labels >= 0
    ce = torch.where(valid, lse - ll, torch.zeros_like(lse))
    return ce.sum(), valid.sum().to(torch.float32)


def lm_loss_sum(cfg: ModelConfig, params: dict, h: torch.Tensor,
                labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of CE, count of valid labels) from hidden states against labels
    (B, S) or, with codebooks, (B, S, CB); with ``cfg.loss_chunk`` the
    sequence is taken in chunks, so the full (B, S, V) logits tensor never
    exists at once. Under a sequence split ``h`` is the rank's rows, made
    whole first (``tensor_parallel.whole_sequence``)."""
    h = tp.whole_sequence(h)
    S = h.shape[1]
    c = cfg.loss_chunk
    w = head_weight(cfg, params)
    if c and S % c == 0 and S > c:
        tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, S, c):
            s, n = _ce(head_logits(cfg, params, h[:, i:i + c], w),
                       labels[:, i:i + c])
            tot, cnt = tot + s, cnt + n
        return tot, cnt
    return _ce(head_logits(cfg, params, h, w), labels)


def lm_loss(cfg: ModelConfig, params: dict, h: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The masked mean CE (``lm_loss_sum``'s sum over its count). Under
    ``activation_rules(local_rows=True)`` both are the whole batch's, summed
    over the batch ranks, and the gradient is this rank's share."""
    s, n = lm_loss_sum(cfg, params, h, labels)
    s, n = sharding.batch_sum(s), sharding.batch_sum(n)
    return s / n.clamp(min=1.0)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            spec: ColaSpec | None = None, cola_vars: dict | None = None):
    """(mean next-token CE, plus ``aux_loss_coef`` times the MoE aux loss
    where the config has experts; aux) of one batch {"tokens" or "embeds",
    "labels"}."""
    h, aux = hidden_states(cfg, params, batch, spec, cola_vars)
    loss = lm_loss(cfg, params, h, batch["labels"])
    if cfg.n_experts:
        loss = loss + cfg.aux_loss_coef * aux["moe_aux"]
    return loss, aux


def prefill(cfg: ModelConfig, params: dict, batch: dict,
            spec: ColaSpec | None = None, cola_vars: dict | None = None,
            *, lengths: torch.Tensor | None = None):
    """Full-sequence prefill of {"tokens"} or {"embeds"}; returns (logits
    (B, 1, V), or (B, 1, CB, V) with codebooks, cache) with the
    cache holding every layer's K/V of the processed sequence, per stack
    (a Mamba2 layer's final conv and ssm state instead, which folds in
    every input token: such rows must be prefilled at their exact length;
    the hybrid plan's cache is {"layers": {"conv", "ssm"}, "shared": {"k",
    "v": (n_seg, B, S, K, Dh)}}).

    ``lengths``: optional (B,) valid prompt lengths of a right-padded batch;
    logits are then taken at position ``lengths - 1`` of each row. Causal
    masking makes every position < lengths[b] independent of the padding.
    """
    h, aux = hidden_states(cfg, params, batch, spec, cola_vars,
                           collect_kv=True)
    ends = (torch.full((h.shape[0],), _seq_len(batch), dtype=torch.long,
                       device=h.device) if lengths is None
            else lengths.to(device=h.device, dtype=torch.long))
    # under a sequence split h is the rank's rows (take_positions)
    h_last = tp.take_positions(h, (ends - 1).clamp(min=0))
    logits = head_logits(cfg, params, h_last)
    return logits, aux["stacked"]


# ---------------------------------------------------------------------------
# caches / decode
# ---------------------------------------------------------------------------

def has_recurrent_state(cfg: ModelConfig) -> bool:
    """Whether the decode cache holds recurrent (conv / ssm) state, which,
    unlike attention KV, cannot be seeded from a right-padded prefill batch
    (the final state folds in the pad tokens)."""
    plan = layer_plan(cfg)
    return plan[0] == "hybrid" or plan == ("uniform", "ssm")


def _mamba_stack(cfg: ModelConfig, prefix: str) -> bool:
    """Whether stack ``prefix`` holds Mamba2 blocks: the ssm plan's one
    stack and the hybrid plan's "layers"."""
    return prefix == "layers" and has_recurrent_state(cfg)


def _ring_stack(cfg: ModelConfig, prefix: str, paged: bool) -> bool:
    """Under the paged layout the pairs plan's local stack keeps rings."""
    return paged and prefix == "layers_a" and layer_plan(cfg)[0] == "pairs"


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, *,
                kv_layout: str = "dense", kv_blocks: int | None = None,
                kv_block: int = 16, ring_len: int | None = None) -> dict:
    """Decode-cache leaf (shape, dtype), per stack.

    ``kv_layout="dense"``: every attention stack gets an (n, batch,
    max_len, K, Dh) slot cache; memory scales with the horizon.

    ``kv_layout="paged"``: KV lives in a shared block pool
    (n, kv_blocks, kv_block, K, Dh) addressed through a per-slot block table
    (owned by the engine's ``runtime.kv_pager.BlockPager`` and passed to
    ``decode_step(block_table=)``); memory scales with kv_blocks and
    ``max_len`` only sizes the table. ``kv_blocks`` defaults to the
    dense-equivalent pool. The pairs plan's local stack instead gets a
    per-slot ring (half, batch, ring_len, K, Dh) of the last ring_len
    positions; ``ring_len`` (default ``local_window`` or ``max_len``) must be
    >= local_window + chunk - 1 for the chunk widths the caller uses.

    A stack of Mamba2 blocks (the ssm plan's, the hybrid plan's "layers")
    keeps every layer's recurrent state, the same in both layouts:
    {"conv": (n, batch, W-1, C) in the compute dtype, "ssm": (n, batch, H,
    P, N) f32}. The hybrid plan's shared block has one K/V a call (n the
    number of segments), dense or in a pool.
    """
    stacks = _stacks(cfg)
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"kv_layout={kv_layout!r}")
    cdt = canonical_dtype(cfg.compute_dtype)
    paged = kv_layout == "paged"
    if paged and kv_blocks is None:
        kv_blocks = batch * cdiv(max_len, kv_block)
    out = {}
    for prefix in stacks:
        n = _calls(cfg, prefix)
        if _mamba_stack(cfg, prefix):
            sh = S.ssm_state_shapes(cfg.d_model, batch, expand=cfg.ssm_expand,
                                    headdim=cfg.ssm_headdim,
                                    state=cfg.ssm_state, d_conv=cfg.ssm_conv)
            out[prefix] = {"conv": ((n,) + sh["conv"], cdt),
                           "ssm": ((n,) + sh["ssm"], torch.float32)}
            continue
        if _ring_stack(cfg, prefix, paged):
            w = ring_len if ring_len is not None else (cfg.local_window
                                                       or max_len)
            shape = (n, batch, w, cfg.n_kv_heads, cfg.d_head)
        elif paged:
            shape = (n, kv_blocks, kv_block, cfg.n_kv_heads, cfg.d_head)
        else:
            shape = (n, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        out[prefix] = {"k": (shape, cdt), "v": (shape, cdt)}
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               kv_layout: str = "dense", kv_blocks: int | None = None,
               kv_block: int = 16, ring_len: int | None = None,
               device="cuda") -> dict:
    dev = resolve_device(device)
    specs = cache_specs(cfg, batch, max_len, kv_layout=kv_layout,
                        kv_blocks=kv_blocks, kv_block=kv_block,
                        ring_len=ring_len)
    return {stack: {n: torch.zeros(shape, dtype=dt, device=dev)
                    for n, (shape, dt) in leaves.items()}
            for stack, leaves in specs.items()}


def decode_step(cfg: ModelConfig, params: dict, batch: dict, cache: dict,
                spec: ColaSpec | None = None, cola_vars: dict | None = None,
                *, live: torch.Tensor | None = None,
                block_table: torch.Tensor | None = None):
    """One incremental step. batch: {"tokens": (B, c) or with codebooks
    (B, c, CB), or "embeds": (B, c, d); "positions": (B,)}: c == 1 is the
    decode tick, c > 1 one chunk of a chunked prefill (the chunk attends to
    every earlier chunk through the cache). Returns (logits (B, c, V), or
    (B, c, CB, V) with codebooks, cache).

    The cache is updated in place and returned (the JAX version returns a new
    cache). ``live``: optional (B,) bool mask; non-live slots' cache writes
    are dropped (their logits carry no meaning). ``block_table``:
    (B, max_blocks) int32 selects the paged layout (the cache must come from
    ``init_cache(kv_layout="paged")``): pool stacks are read through the
    table, and the pairs plan's local stack through its per-slot rings, with
    the table's horizon (max_blocks * kv_block) as the rings' virtual one.

    A Mamba2 layer (the ssm plan's, the hybrid plan's "layers") runs its
    block on its carried conv and ssm state (c == 1 the recurrence, c > 1
    the full-sequence block over the chunk, exact length), with no KV
    write plan; non-live rows keep their state bit for bit (JAX's
    ``_mask_cache_rows``). On the ssm plan ``positions`` and
    ``block_table`` are not read. Each attention stack gets one KV write
    plan a step (the hybrid plan's shared block one for all its calls),
    never one a layer.

    Under the serve step's plan a stack may hold its cache split by
    sequence (``tensor_parallel.cache_split``): its leaves are the rank's
    block of positions, its write plan keeps only the writes in that block,
    and its attention merges the ranks' blocks.
    """
    stacks = _stacks(cfg)
    ad = {p: _subvars((cola_vars or {}).get("adapters", {}), p) for p in stacks}
    de = {p: _subvars((cola_vars or {}).get("deltas", {}), p) for p in stacks}
    positions = batch["positions"]
    x = embed_tokens(cfg, params, batch)
    c = x.shape[1]
    # each attention stack's layout and write plan; one plan per layout and
    # step, never one per layer
    plans: dict[tuple, tuple] = {}
    layouts = {}
    for prefix in stacks:
        if _mamba_stack(cfg, prefix):
            continue
        width = cache[prefix]["k"].shape[2]   # Smax, W_ring or kv_block
        table = horizon = None
        split = tp.cache_split(prefix)
        if split is not None:
            kind, kw = "dense", dict(smax=split.whole,
                                     seq_block=(split.offset, split.size))
        elif _ring_stack(cfg, prefix, block_table is not None):
            kind, kw = "ring", dict(ring=width)
            horizon = block_table.shape[1] * cache["layers_b"]["k"].shape[2]
        elif block_table is not None:
            kind, kw = "paged", dict(block_table=block_table, block=width)
            table = block_table
        else:
            kind, kw = "dense", dict(smax=width)
        key = (kind, width, split)
        if key not in plans:
            plans[key] = A.kv_write_plan(positions, c, live, **kw)
        layouts[prefix] = (table, horizon, plans[key], split)
    for prefix, i, window in _walk(cfg):
        lp, ad_l, de_l = _site_vars(prefix, i, params, ad, de)
        lp, ad_l = tp.take_layer(prefix, lp, ad_l)
        tap_ctx = (spec, ad_l, de_l, {})
        if _mamba_stack(cfg, prefix):
            x = _ssm_decode(cfg, lp, x, cache[prefix], i, tap_ctx, live)
            continue
        table, horizon, write, split = layouts[prefix]
        x = B.attn_block_decode(cfg, lp, x, cache[prefix]["k"][i],
                                cache[prefix]["v"][i], positions,
                                window=window, tap_prefix=prefix,
                                tap_ctx=tap_ctx, live=live, block_table=table,
                                kv_write=write, ring_horizon=horizon,
                                seq_split=split)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps,
                  plus_one=cfg.norm_plus_one)
    return head_logits(cfg, params, x), cache


def _ssm_decode(cfg: ModelConfig, lp: dict, x: torch.Tensor, cache: dict,
                i: int, tap_ctx: tuple, live: torch.Tensor | None
                ) -> torch.Tensor:
    """Mamba2 layer i of a decode step (parameters ``lp``), its state
    written back into ``cache`` in place; rows where ``live`` is False get
    their old state back (a select against the old state, no host sync).
    Under the serve step's plan the SSM state may be the rank's heads block
    and the conv state its channel block, gathered for the layer
    (``tensor_parallel.conv_state``) and written back as the block."""
    conv, st = cache["conv"][i], cache["ssm"][i]
    x, new_conv, new_st = B.ssm_block_decode(cfg, lp, x,
                                             tp.conv_state("layers", conv),
                                             st, tap_prefix="layers",
                                             tap_ctx=tap_ctx)
    new_conv = tp.own_channels("layers", new_conv)
    if live is not None:
        new_conv = torch.where(live[:, None, None], new_conv, conv)
        new_st = torch.where(live[:, None, None, None], new_st, st)
    conv.copy_(new_conv)
    st.copy_(new_st)
    return x


def scatter_prefill_cache(cache: dict, pre: dict, slot_ids) -> dict:
    """Write a prefill cache (rows 0..J-1, sequence length P) into slot
    positions [0, P) of a serving slot cache, in place; returns ``cache``.

    ``slot_ids`` (J,) maps prefill row j -> slot. Out-of-range ids are
    dropped (the JAX ``mode="drop"``), which is how padding rows of a
    bucketed prefill batch are discarded: they are skipped on the host.
    Each kept row is copied on its own, so no gathered copy of the whole
    prefill cache is ever made. Positions >= a row's true prompt length
    receive pad-token KV, which is safe: decode at position p writes the real
    KV at p before attending, and causal masking hides positions > p.
    State leaves (the Mamba2 layers' conv and ssm state) have the slot cache's
    trailing shape and are written whole. Recurrent state folds in every
    token, padding included, so such rows must come from an exact-length
    prefill (``has_recurrent_state``).
    """
    ids = [int(i) for i in torch.as_tensor(slot_ids).cpu()]
    for stack, leaves in cache.items():
        for name, c in leaves.items():
            p = pre[stack][name]
            for j, slot in enumerate(ids):
                if 0 <= slot < c.shape[1]:
                    c[:, slot, :p.shape[2]].copy_(p[:, j])
    return cache
