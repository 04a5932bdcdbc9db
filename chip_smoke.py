#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repo root on a machine with one NVIDIA H100 (and the CUDA
toolkit): ``python3 chip_smoke.py``. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel) and runs
four phases, exiting non-zero on any failure:

1. Kernels against their plain PyTorch versions, on the card, at the
   full-width smollm-135m shapes of the serving path, in bf16 and f32:
   max error, and median times of the kernel, the plain version and the
   library call (``F.scaled_dot_product_attention`` for the two attention
   kernels; none for multi_lora), with each kernel's bound on this card.
2. Serving at full width: ``ServeEngine`` on smollm-135m (30 layers, bf16)
   with 4 users' rank-8 ``qv`` adapters, 16 slots, max_len 1024 and 32
   requests (prompts 32-512 tokens, 32 new tokens each), run to completion
   with every kernel's launch count reset just before and read just after.
3. Engine against the plain path: a full-width f32 engine on the card and
   the same engine on the CPU (plain versions) must emit equal greedy tokens.
4. The last lines: the card's name and power limit, one JSON line with every
   kernel's numbers, and ``{"ok": true, "device": {...}}`` last.

Without a card (``torch.cuda.is_available()`` false) it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerance of a kernel against its plain version: max |kernel - plain| <=
# TOL[dtype] * (1 + max |plain|). bf16: two roundings of a bf16 output
# (2^-8 each) where the kernel keeps f32 that the plain version rounds;
# f32: the same sums in another order.
TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of single calls, L2 flushed before each (the
    serving path finds every layer's operands cold)."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def median_ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(cfg, dtype, dev, gen):
    """Inputs of each kernel at the shapes phase 2's serving path gives it.
    Yields (name, kernel fn, plain fn, library fn | None, nbytes, flops)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multi_lora as ml

    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    # prefill: 16 prompts padded to the 512 bucket
    J, P = 16, 512
    q, k, v = rnd(J, P, H, D), rnd(J, P, K, D), rnd(J, P, K, D)
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = int((pos[0][None, :] <= pos[0][:, None]).sum())
    yield ("flash_attention",
           lambda: fa.flash_attention(q, k, v, q_positions=pos, kv_positions=pos),
           lambda: fa.plain(q, k, v, q_positions=pos, kv_positions=pos),
           lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True),
           nbytes(q, k, v, q) + J * H * P * 4 + 2 * P * 4,
           4 * D * pairs * J * H)

    # decode tick: 16 slots against a 1024-position cache
    B, Smax = 16, 1024
    qd = rnd(B, 1, H, D)
    kc, vc = rnd(B, Smax, K, D), rnd(B, Smax, K, D)
    posd = torch.randint(32, 545, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    n_kv = int((posd.clamp(max=Smax - 1) + 1).sum())
    mask = (torch.arange(Smax, device=dev)[None, :] <= posd[:, None])[:, None, None]
    qdt, kct, vct = (t.transpose(1, 2).contiguous() for t in (qd, kc, vc))
    yield ("decode_attention",
           lambda: da.decode_attention(qd, kc, vc, posd, live=live),
           lambda: da.plain(qd, kc, vc, posd, live=live),
           lambda: F.scaled_dot_product_attention(qdt, kct, vct, attn_mask=mask,
                                                  enable_gqa=True),
           2 * nbytes(qd) + 2 * n_kv * K * D * qd.element_size() + B * 5,
           4 * D * H * n_kv)

    # adapted tap q at prefill: 8192 token rows, 4 users, rank 8
    U, r, d = 4, 8, cfg.d_model
    x = rnd(J * P, d)
    A = rnd(U, d, r, dt=torch.float32) / r ** 0.5
    Bm = rnd(U, r, H * D, dt=torch.float32) * 0.05
    idx = (torch.arange(J, device=dev, dtype=torch.int32) % U).repeat_interleave(P)
    yield ("multi_lora",
           lambda: ml.multi_lora(x, A, Bm, idx),
           lambda: ml.plain(x, A, Bm, idx),
           None,
           nbytes(x, idx, A, Bm) + J * P * H * D * x.element_size(),
           2 * J * P * (d * r + r * H * D))


def phase_kernels(cfg, dev) -> dict:
    timer = Timer(dev)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for name, fn, plain, lib, nb, flops in kernel_cases(cfg, dtype, dev, gen):
            got, want = fn(), plain()
            if isinstance(got, tuple):   # flash: (o, lse)
                err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want))
                scale = float(want[0].float().abs().max())
            else:
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
            torch.cuda.synchronize()
            tol = TOL[dtype] * (1 + scale)
            check(err <= tol, f"{name} {dtype}: max |kernel - plain| = {err:.3g}"
                  f" > {tol:.3g}")
            ms, plain_ms = timer.median_ms(fn), timer.median_ms(plain, iters=5)
            lib_ms = timer.median_ms(lib) if lib is not None else None
            b_ms, b_by = bound(nb, flops, dtype)
            dt = str(dtype).replace("torch.", "")
            print(f"[kernels] {name:16s} {dt:8s} max_abs_err {err:.3e} "
                  f"(tol {tol:.2e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                  f"  library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
                  f"  bound {b_ms:.4f} ms ({b_by})", flush=True)
            if dtype == torch.bfloat16:   # the serving path's dtype
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return rows


# ---------------------------------------------------------------------------
# phases 2 and 3: the serving path
# ---------------------------------------------------------------------------

def user_banks(cfg, n_users: int, device, seed: int) -> list[dict]:
    """Rank-8 ``qv`` adapters, B nonzero, on the CPU generator for
    reproducibility across devices."""
    from repro_torch.core import gl
    from repro_torch.models import model

    gen = torch.Generator().manual_seed(seed)
    sites = model.tap_sites(cfg)
    out = []
    for _ in range(n_users):
        bank = {}
        for tap in gl.select_taps(cfg, "qv"):
            s = sites[tap]
            bank[tap] = {
                "A": torch.randn((s.stacked, s.d_in, 8), generator=gen) / 8 ** 0.5,
                "B": torch.randn((s.stacked, 8, s.d_out), generator=gen) * 0.05}
        out.append({t: {n: a.to(device) for n, a in e.items()}
                    for t, e in bank.items()})
    return out


def serve(cfg, params, banks, prompts, device, *, slots, max_len, max_new):
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    eng = ServeEngine(cfg, params, slots=slots, max_len=max_len,
                      user_adapters=banks, device=device)
    reqs = [Request(rid=i, user=i % len(banks), prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return eng, reqs


def phase_serving(cfg, dev) -> dict:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multi_lora as ml
    from repro_torch.models import model

    wrappers = {"flash_attention": fa.flash_attention,
                "decode_attention": da.decode_attention,
                "multi_lora": ml.multi_lora}
    params = model.init(cfg, seed=SEED, device=dev)
    banks = user_banks(cfg, 4, dev, SEED)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(32, 513, 32)]
    # warm-up (library handles, allocator); its launches are not counted
    serve(cfg, params, banks, prompts[:2], dev, slots=16, max_len=1024,
          max_new=2)
    torch.cuda.synchronize()

    for w in wrappers.values():
        w.launches = 0
    eng, reqs = serve(cfg, params, banks, prompts, dev, slots=16,
                      max_len=1024, max_new=32)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}

    check(all(r.status == "done" and len(r.out) == 32 for r in reqs),
          "not every request finished with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
          "a token outside the vocabulary")
    for n, c in launches.items():
        check(c > 0, f"kernel {n} was never launched on the serving path")
    tp = eng.throughput()
    print(f"[serve] smollm-135m bf16, 30 layers, 16 slots, 4 users: "
          f"{tp['completed']} requests, decode {tp['decode_tok_per_s']:.1f} tok/s,"
          f" prefill {tp['prefill_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{tp['ttft']['p50'] * 1e3:.1f} ms p99 {tp['ttft']['p99'] * 1e3:.1f} ms,"
          f" decode tick p50 {tp['decode_tick']['p50'] * 1e3:.2f} ms,"
          f" prefill calls {eng.stats['prefill_calls']}", flush=True)
    print(f"[serve] launches on the serving path: {launches}", flush=True)
    return launches


def phase_engine_vs_plain(cfg, dev) -> None:
    from repro_torch.models import model

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params_cpu = model.init(cfg32, seed=SEED + 1, device="cpu")
    params_gpu = {k: _to(v, dev) for k, v in params_cpu.items()}
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
               for _ in range(4)]
    outs, logits = {}, {}
    for device, params in (("cpu", params_cpu), (dev, params_gpu)):
        banks = user_banks(cfg32, 4, device, SEED + 1)
        eng, reqs = serve(cfg32, params, banks, prompts, device, slots=4,
                          max_len=128, max_new=8)
        outs[str(device)] = [r.out for r in reqs]
        users = torch.arange(4, dtype=torch.int32, device=device)
        lg, _ = model.prefill(cfg32, params,
                              {"tokens": torch.as_tensor(np.stack(prompts),
                                                         device=device)},
                              eng.spec, eng._cola_vars(users))
        logits[str(device)] = lg.float().cpu()
    diff = float((logits["cpu"] - logits[str(dev)]).abs().max())
    print(f"[engine-vs-plain] f32 full width: card tokens == CPU tokens: "
          f"{outs['cpu'] == outs[str(dev)]}; prefill logits max |diff| "
          f"{diff:.3e} (max |logit| {float(logits['cpu'].abs().max()):.3f})",
          flush=True)
    check(outs["cpu"] == outs[str(dev)],
          f"greedy tokens differ: cpu {outs['cpu']} card {outs[str(dev)]}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {sorted(built)} built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    cfg = registry.get_config("smollm-135m")
    t0 = time.perf_counter()
    rows = phase_kernels(cfg, dev)
    print(f"[kernels] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = phase_serving(cfg, dev)
    print(f"[serve] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_engine_vs_plain(cfg, dev)
    print(f"[engine-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    replaces = {
        "flash_attention": "src/repro/kernels/flash_attention.py:61",
        "decode_attention": "src/repro/kernels/decode_attention.py:62",
        "multi_lora": "src/repro/kernels/multi_lora.py:64",
    }
    kernels = [dict(name=n, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{n}.cu",
                    replaces=replaces[n], launches=launches[n], **rows[n])
               for n in replaces]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
