"""Mamba2 (SSD) block: fused in_proj -> causal depthwise conv -> SSD ->
gated norm -> out_proj. The full-sequence path runs the chunked SSD scan;
the decode path carries (conv_state, ssm_state).

ColA taps: ``<prefix>.in`` (d_model -> d_in_proj) and ``<prefix>.out``
(d_inner -> d_model), plain Dense sites, mergeable per Prop 2.

A port of the JAX package's ``models/ssm.py`` under its names. The decode
step keeps the token axis of its input through both Dense sites, so that a
multi-LoRA tap (which takes (B, S, d)) applies there as it does in the
full-sequence block.

Under a step's plan that splits the heads over "model"
(``distributed.tensor_parallel``, JAX's ``constrain(xh, "batch", None,
"model", None)``) the input is the whole sequence and ``in_proj`` is
computed whole; the rank convolves its heads' x channels and B, C, scans its
own heads, gathers ``y * silu(z)`` by columns for the norm over the whole
d_inner, and computes its output columns of ``out_proj``. The conv state in
and out is every channel's; the SSM state in and out is the rank's heads'.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L


def ssm_dims(d_model: int, *, expand: int = 2, headdim: int = 64,
             state: int = 128) -> dict:
    d_inner = expand * d_model
    return dict(d_inner=d_inner, nheads=d_inner // headdim, headdim=headdim,
                state=state)


def d_in_proj(dims: dict) -> int:
    """Width of the fused input projection: [z, x, B, C, dt]."""
    return 2 * dims["d_inner"] + 2 * dims["state"] + dims["nheads"]


def ssm_init(n: int, d_model: int, *, normal, uniform, full,
             expand: int = 2, headdim: int = 64, state: int = 128,
             d_conv: int = 4) -> dict:
    """A stack of ``n`` blocks' parameters with JAX's shapes, scales and
    dtypes. ``normal(shape, std)`` draws into the parameter dtype,
    ``uniform(shape)`` draws f32 in [0, 1) and ``full(shape, value,
    dtype=None)`` fills, in the parameter dtype unless given one:
    ``dt_bias``, ``A_log`` and ``D`` are f32 whatever that dtype is. ``dt``
    is log-uniform in [0.001, 0.1] and ``dt_bias`` its inverse softplus;
    A = -exp(A_log) = -1."""
    dims = ssm_dims(d_model, expand=expand, headdim=headdim, state=state)
    di, H = dims["d_inner"], dims["nheads"]
    conv_ch = di + 2 * dims["state"]
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(uniform((n, H)) * (hi - lo) + lo)
    return {
        "in_proj": {"w": normal((n, d_model, d_in_proj(dims)),
                                d_model ** -0.5)},
        "out_proj": {"w": normal((n, di, d_model), di ** -0.5)},
        "conv_w": normal((n, d_conv, conv_ch), d_conv ** -0.5),
        "conv_b": full((n, conv_ch), 0.0),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": full((n, H), 0.0, torch.float32),
        "D": full((n, H), 1.0, torch.float32),
        "norm": {"scale": full((n, di), 1.0)},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv, summed in f32 over i = 0..W-1 with shift
    W-1-i, the bias added in f32, then cast to x's dtype. x: (B, S, C);
    w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    out = torch.zeros_like(xf)
    for i in range(W):
        xi = F.pad(xf, (0, 0, W - 1 - i, 0))[:, :S]
        out = out + xi * wf[i]
    return (out + b.to(torch.float32)).to(x.dtype)


def _split_proj(zxbcdt: torch.Tensor, di: int, N: int):
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    Bm = zxbcdt[..., 2 * di:2 * di + N]
    Cm = zxbcdt[..., 2 * di + N:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, x, Bm, Cm, dt


def _gated_norm(params: dict, y: torch.Tensor, z: torch.Tensor,
                eps: float, plan=None) -> torch.Tensor:
    """rmsnorm(y * silu(z)), silu in f32 cast to y's dtype; no plus-one.
    Under a plan that splits the heads, y and z are the rank's columns and
    the product is gathered for the norm over every column, laid out as one
    device's (a strided row would be summed in another order)."""
    g = y * F.silu(z.to(torch.float32)).to(y.dtype)
    if plan is not None:
        g = plan.gather_cols(g, "ssm.norm").contiguous()
    return L.rmsnorm(params["norm"], g, eps=eps)


class _Heads:
    """The per-head slices a rank's share of the mixer uses: the whole
    mixer's where ``plan`` is None, else the rank's heads' columns of z, x
    and dt, its x channels and the shared B, C of the conv, and its entries
    of ``D`` and of the step sizes and decay rates (``dt_a``)."""

    def __init__(self, params: dict, di: int, H: int, P: int, plan):
        self.params, self.whole_di = params, di
        self.split = plan is not None
        first, self.H = (plan.ssm.first, plan.ssm.heads) if self.split \
            else (0, H)
        self.first, self.lo, self.di = first, first * P, self.H * P
        self.conv_w, self.conv_b, self.D = (
            self.channels(params["conv_w"]), self.channels(params["conv_b"]),
            self.heads(params["D"]))

    def dt_a(self, dt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """softplus(dt + dt_bias) (dt: every head's raw columns) and A =
        -exp(A_log), in f32, the rank's heads of each: both are computed
        over every head first, since an elementwise op rounds its
        vectorised body and its scalar tail differently, so that the
        rank's entries are the whole's bit for bit."""
        p = self.params
        dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
        return self.heads(dt), self.heads(-torch.exp(p["A_log"]))

    def cols(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's d_inner columns (z)."""
        return t.narrow(-1, self.lo, self.di) if self.split else t

    def heads(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's head entries (dt, dt_bias, A_log, D)."""
        return t.narrow(-1, self.first, self.H) if self.split else t

    def channels(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's conv channels of [x, B, C] (the last dim): its x
        columns and B, C."""
        if not self.split:
            return t
        return torch.cat([t.narrow(-1, self.lo, self.di),
                          t[..., self.whole_di:]], dim=-1)


def ssm_block(params: dict, u: torch.Tensor, *, d_model: int, expand: int = 2,
              headdim: int = 64, state: int = 128, norm_eps: float = 1e-5,
              chunk: int = 128, tap_prefix: str = "ssm",
              tap_ctx: tuple | None = None,
              init_state: torch.Tensor | None = None,
              conv_state: torch.Tensor | None = None, keep_out: bool = True):
    """Full-sequence Mamba2 block. u: (B, S, d_model). Returns (out,
    {"conv": (B, W-1, C) raw-input tail in u's dtype, "ssm": (B, H, P, N)
    f32 final state}).

    ``conv_state`` / ``init_state`` carry the previous chunk's state into a
    chunked prefill: the conv then runs over [conv_state ; this chunk] and
    keeps this chunk's outputs, so every position sums the same W raw inputs
    in the same order as one full-sequence call (a zero conv_state gives the
    zero-padded start bit for bit), and the SSD scan folds the carried state
    in through ``init_state``. ``keep_out``: the out projection's
    ``layers.dense(keep=)``.
    """
    dims = ssm_dims(d_model, expand=expand, headdim=headdim, state=state)
    di, H, P, N = dims["d_inner"], dims["nheads"], headdim, state
    plan = tp.ssm()
    Bsz, S, _ = u.shape
    zxbcdt = L.dense(params["in_proj"], u, tap=f"{tap_prefix}.in",
                     tap_ctx=tap_ctx)
    z, x, Bm, Cm, dt = _split_proj(zxbcdt, di, N)
    hs = _Heads(params, di, H, P, plan)
    xbc_raw = torch.cat([x, Bm, Cm], dim=-1)
    W = params["conv_w"].shape[0]
    if conv_state is not None:
        hist = torch.cat([conv_state.to(xbc_raw.dtype), xbc_raw], dim=1)
        tail = hist[:, -(W - 1):]
        xbc = F.silu(_causal_conv(hs.channels(hist), hs.conv_w,
                                  hs.conv_b)[:, W - 1:])
    else:
        # the raw inputs of the last W-1 positions, left-padded with zeros
        # when S < W-1: the decode conv state after a prefill
        tail = xbc_raw[:, -(W - 1):]
        if tail.shape[1] < W - 1:
            tail = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
        xbc = F.silu(_causal_conv(hs.channels(xbc_raw), hs.conv_w,
                                  hs.conv_b))
    di, H = hs.di, hs.H
    x, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt, a = hs.dt_a(dt)                                       # (B, S, H)
    y, final_state = kernel_ops.ssd(x.reshape(Bsz, S, H, P), dt, a, Bm, Cm,
                                    hs.D, init_state, chunk=chunk)
    y = _gated_norm(params, y.reshape(Bsz, S, di), hs.cols(z), norm_eps,
                    plan)
    out = L.dense(params["out_proj"], y, tap=f"{tap_prefix}.out",
                  tap_ctx=tap_ctx, keep=keep_out)
    return out, {"conv": tail, "ssm": final_state}


def ssm_decode_step(params: dict, u: torch.Tensor, conv_state: torch.Tensor,
                    ssm_state: torch.Tensor, *, d_model: int, expand: int = 2,
                    headdim: int = 64, state: int = 128,
                    norm_eps: float = 1e-5, tap_prefix: str = "ssm",
                    tap_ctx: tuple | None = None):
    """One-token decode. u: (B, 1, d_model); conv_state: (B, W-1, C);
    ssm_state: (B, H, P, N) f32. Returns (out (B, 1, d_model), conv_state,
    ssm_state). The conv here is an f32 sum over [conv_state ; xbc] plus the
    bias, silu in f32, then the cast to u's dtype."""
    dims = ssm_dims(d_model, expand=expand, headdim=headdim, state=state)
    di, H, P, N = dims["d_inner"], dims["nheads"], headdim, state
    plan = tp.ssm()
    Bsz = u.shape[0]
    zxbcdt = L.dense(params["in_proj"], u, tap=f"{tap_prefix}.in",
                     tap_ctx=tap_ctx)[:, 0]                  # (B, d_in_proj)
    z, x, Bm, Cm, dt = _split_proj(zxbcdt, di, N)
    hs = _Heads(params, di, H, P, plan)
    xbc = torch.cat([x, Bm, Cm], dim=-1)                     # (B, C)
    hist = torch.cat([conv_state.to(torch.float32),
                      xbc.to(torch.float32)[:, None]], dim=1)   # (B, W, C)
    conv = (torch.einsum("bwc,wc->bc", hs.channels(hist),
                         hs.conv_w.to(torch.float32))
            + hs.conv_b.to(torch.float32))
    conv = F.silu(conv).to(u.dtype)
    new_conv_state = hist[:, 1:].to(conv_state.dtype)
    di, H = hs.di, hs.H
    x, Bm, Cm = conv[..., :di], conv[..., di:di + N], conv[..., di + N:]
    dt, a = hs.dt_a(dt)                                       # (B, H)
    y, ssm_state = kernel_ops.ssd_decode_step(
        x.reshape(Bsz, H, P), dt, a, Bm, Cm, hs.D, ssm_state)
    y = _gated_norm(params, y.reshape(Bsz, 1, di), hs.cols(z)[:, None],
                    norm_eps, plan)
    out = L.dense(params["out_proj"], y, tap=f"{tap_prefix}.out",
                  tap_ctx=tap_ctx)
    return out, new_conv_state, ssm_state


def ssm_state_shapes(d_model: int, batch: int, *, expand: int = 2,
                     headdim: int = 64, state: int = 128,
                     d_conv: int = 4) -> dict:
    dims = ssm_dims(d_model, expand=expand, headdim=headdim, state=state)
    di, H, P, N = dims["d_inner"], dims["nheads"], headdim, state
    return {"conv": (batch, d_conv - 1, di + 2 * N), "ssm": (batch, H, P, N)}
