"""One rank's FLOPs of a reduced train step, written out from the config's
widths product by product, as ``torch.utils.flop_counter`` counts the
port's plain path (mm, bmm, einsum, sdpa; no elementwise work). Shared by
``tests/test_torch_dryrun.py`` (the dry-run's count) and
``tests/test_torch_distributed.py`` (the real steps' count in gloo groups).
If a count drifts, the model's products changed: re-derive, never loosen.
"""
from repro_torch.models import ssm as S


def lin(T, i, o):
    return 2 * T * i * o


def dense(T, i, o, x_grad, w_grad):
    """x @ W: the product, dX where x needs a gradient, dW where W does."""
    return lin(T, i, o) * (1 + x_grad + w_grad)


def adapter(T, i, o, r, x_grad, w_grad):
    """(x @ A) @ B: both products; d(xA) where x or A needs a gradient,
    dB and dA where the adapter does, dx where x does."""
    f = lin(T, i, r) + lin(T, r, o)
    f += lin(T, r, o) * ((x_grad or w_grad) + w_grad)
    f += lin(T, i, r) * (x_grad + w_grad)
    return f


class Count:
    """Products of one rank's (micro)batch of b rows x s on the plain path,
    forward and backward, layer by layer; ``live``: whether the residual
    stream needs a gradient. ``n``: the ranks along "model" over which the
    attention, the dense MLP, the head, the Mamba2 mixer's heads and the
    experts are split (the reduced widths divide, the mixer's heads where
    ``H % n == 0``, the experts where ``E % n == 0``): a rank computes its
    output columns of every product of those parts (o, down and out_proj
    over their gathered inputs), attends over its own heads, scans its own
    SSD heads and dispatches to, runs and combines its own experts; the
    router, the mixer's in_proj and C B^T, and the adapters' x @ A stay
    whole. The MoE groups are those of the rank's b rows (the cells held
    here hold whole groups)."""

    def __init__(self, cfg, mode, b, s, r, n=1):
        self.cfg, self.b, self.s, self.r, self.T = cfg, b, s, r, b * s
        self.n = n
        self.ft = mode == "ft"
        self.tapped = mode in ("fused_fit", "faithful_offload")
        self.fit = mode == "fused_fit"
        self.live = self.ft            # the embedding needs a gradient in ft
        self.flops = 0

    def attn_block(self, ffn="mlp"):
        c, T, b, s, n = self.cfg, self.T, self.b, self.s, self.n
        d, hq, hkv = c.d_model, c.n_heads * c.d_head, c.n_kv_heads * c.d_head
        x, w = self.live, self.ft
        f = dense(T, d, hq // n, x, w) + 2 * dense(T, d, hkv // n, x, w)
        if self.tapped:    # taps q and v: adapters, and Mode A's deltas
            f += adapter(T, d, hq // n, self.r, x, self.fit)
            f += adapter(T, d, hkv // n, self.r, x, self.fit)
        qkv = x or w or self.tapped
        core = 2 * b * s * s * c.n_heads * c.d_head // n
        f += 2 * core + (5 * core if qkv else 0)   # sdpa; the plain backward
        f += dense(T, hq, d // n, qkv, w)
        self.live = x = self.live or qkv
        if ffn == "mlp":
            F = c.d_ff
            f += (2 * dense(T, d, F // n, x, w)
                  + dense(T, F, d // n, x or w, w))
        else:
            E, k, F = c.n_experts, c.moe_top_k, c.d_expert
            El = E // n if E % n == 0 else E    # the rank's experts
            G = c.moe_group if T % c.moe_group == 0 else s
            C = max(k, -(-int(G * k * c.capacity_factor) // E))
            g = x or w                          # router logits, combine
            f += dense(T, d, E, x, w)           # router
            f += lin(T, El * C, d) * (1 + x)    # dispatch (one-hot, x)
            f += 2 * dense(T // G * El * C, d, F, x, w)   # experts' gate, up
            f += dense(T // G * El * C, F, d, x or w, w)  # down
            f += lin(T, El * C, d) * (1 + g + g)  # combine (weights, y)
        self.flops += f

    def ssm_block(self, taps):
        c, T, b, s, r = self.cfg, self.T, self.b, self.s, self.r
        dims = S.ssm_dims(c.d_model, expand=c.ssm_expand,
                          headdim=c.ssm_headdim, state=c.ssm_state)
        d, di, H = c.d_model, dims["d_inner"], dims["nheads"]
        P, N, dip = c.ssm_headdim, c.ssm_state, S.d_in_proj(dims)
        # the heads split over "model" where they (and d_model) divide
        m = self.n if H % self.n == 0 and d % self.n == 0 else 1
        x, w = self.live, self.ft
        tapped = taps and self.tapped
        f = dense(T, d, dip, x, w)
        if tapped:
            f += adapter(T, d, dip, r, x, self.fit)
        g = x or w or tapped
        # SSD in one chunk (s <= ssd_chunk): C B^T (whole on every rank),
        # (w dt) x and the final state (unused by the loss: no backward) of
        # the rank's heads
        cb, y = 2 * b * s * s * N, 2 * b * (H // m) * s * s * P
        f += cb + y + 2 * b * (H // m) * P * N * s + (2 * cb + 2 * y if g
                                                     else 0)
        f += dense(T, di, d // m, g, w)
        if tapped:
            f += adapter(T, di, d // m, r, g, self.fit)
        self.live = self.live or g
        self.flops += f

    def head(self):
        c = self.cfg
        self.flops += dense(self.T, c.d_model,
                            c.vocab_size * (c.n_codebooks or 1) // self.n,
                            self.live, self.ft)


def train_flops(plan, cfg, mode, rows, seq, rank, n=1):
    """One rank's train step: M microbatches of ``rows`` rows of ``seq``
    positions (ft: one batch of M * rows), rank-``rank`` adapters on taps
    "qv", split over ``n`` ranks along "model"."""
    m = 1 if mode == "ft" else cfg.microbatches
    b = rows if mode != "ft" else rows * cfg.microbatches
    c = Count(cfg, mode, b, seq, rank, n)
    if plan == "ssm":
        for _ in range(cfg.n_layers):
            c.ssm_block(taps=True)
    elif plan == "hybrid":
        for start in range(0, cfg.n_layers, cfg.shared_attn_every):
            c.attn_block()
            for _ in range(min(cfg.shared_attn_every,
                               cfg.n_layers - start)):
                c.ssm_block(taps=False)
    else:
        for _ in range(cfg.n_layers):
            c.attn_block("moe" if plan == "moe" else "mlp")
    c.head()
    return m * c.flops
