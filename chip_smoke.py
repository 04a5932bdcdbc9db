#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repo root on a machine with one NVIDIA H100 (and the CUDA
toolkit): ``python3 chip_smoke.py``. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel) and runs
seventeen phases, exiting non-zero on any failure:

1. Kernels against their plain PyTorch versions, on the card, at the
   full-width smollm-135m shapes of the serving and training paths, in bf16
   and f32 (cola_fit in f32, the only dtype the fit runs in), the flash
   forward at the prefill shape (16 x 512), at the training shape (32 x 128,
   run 60 times a training step) and at the chunk-round shape through
   ``ops.sdpa_decode`` and ``ops.sdpa_decode_paged`` (16 rows of 128 queries
   at chunk starts inside the prompts, dead rows, a shuffled table); the
   bf16 flash forward and backward (dq; dk/dv) are tensor-core kernels,
   whose registers and spills per head dim the build lines before report
   from ptxas (no spill at the path's d_head 64), as they do for the
   split-KV decode kernel per dtype and head dim (no spill in bf16 at
   d_head 64): max error, and median
   device times (L2 flushed, the host run ahead behind a device sleep) of
   the kernel, the plain version and the library call
   (``F.scaled_dot_product_attention`` for the attention kernels, over the
   gathered dense view for paged decode; its backward for the flash backward
   kernels, also timed as a pair, ``flash_attention_bwd[pair]``, against
   that one backward with the summed bound; the ``torch.matmul`` chain for
   cola_fit; the gather (+ dequantise) + two ``torch.bmm`` chain for
   multi_lora and multi_lora_q8), with each kernel's bound on this card,
   and for cola_fit and the multi-LoRA prefill and chunk rows the time
   PyTorch takes to move the same bytes (``stream``).
   Paged decode also runs with window, softcap and dead rows, and dense
   decode with all 16 slots at position 1023, the engine's horizon
   (``decode_attention[full 1024]``, every split of every slot live);
   multi_lora at the prefill and the decode-tick shape (``[tick 16]``, the
   q and the v tap) and at the tick with every row padding (``[tick 16,
   padding]``: the launch floor of the tick's grid), multi_lora_q8 at the
   decode and chunk shapes; cola_fit at both taps of the fit (q: 576 -> 576,
   ``[attn.v]``: 576 -> 192); the build lines report the registers and
   spills of each cola_fit and multi-LoRA instantiation too (no spill at the
   path's rank 8). A second launch of the flash backward, cola_fit, dense and
   paged decode and both multi-LoRA kernels (bf16 and f32) must give the
   same bits; rows of the multi-LoRA prefill (T 8192) and chunk-round
   (T 2048) calls must equal the same rows in a T 16 call, and int8 the f32
   kernel on the dequantised bank, bit for bit. Then, in bf16 and f32, the
   rows of the other registered configs (``model_cases``): gemma2-9b's
   d_head 256 in the flash forward (2 x 4608 with window 4096 and softcap
   50, and without either; a chunk round of 8 x 128 against a 6144 cache)
   and in decode (8 slots up to 6143, window 4096, softcap 50, dead rows:
   dense, paged, and the ring tick, which must equal the dense tick bit for
   bit), G 1 at d_head 64 (gpt2-small) and G 4 at d_head 128
   (mistral-nemo-12b), G 8 and G 6 at d_head 128 (qwen3-moe-30b-a3b,
   dbrx-132b), and multi_lora / multi_lora_q8 at the q and v taps of
   gemma2-9b, mistral-nemo-12b, mistral-large-123b (d_in 12288),
   qwen3-moe-30b-a3b (2048) and dbrx-132b (6144); qwen3-moe's training
   shape in the flash backward (1 x 2048, 32 / 4 heads) and its fit
   (cola_fit f32, L 48, T 2048: q 2048 -> 4096, v 2048 -> 512);
   gemma2's training shape in the flash backward (dq and dk/dv at 1 x 4608,
   16 / 8 heads, d_head 256, with window 4096 + softcap 50 and with neither;
   the row with neither also against the library's whole backward) and its
   fit (cola_fit f32 at q 3584 -> 4096, the shared-memory kernel with its
   columns split in two, and v 3584 -> 2048; L 21, T 4608, rank 8); each
   launched twice to the same bits. A softcap row has no library time (no
   library call takes a softcap); the row without one has it. The build
   lines report the registers and spills of every d_head 256 instantiation
   (the flash backward's too, which must not spill, nor may
   ``fit_smem_kernel<8>``).
2. Serving at full width: ``ServeEngine`` on smollm-135m (30 layers, bf16)
   with 4 users' rank-8 ``qv`` adapters, 16 slots, max_len 1024 and 32
   requests (prompts 32-512 tokens, 32 new tokens each), run to completion
   with every kernel's launch count reset just before and read just after.
3. Engine against the plain path: a full-width f32 engine on the card and
   the same engine on the CPU (plain versions) must emit equal greedy tokens.
4. Training at full width: ``ColaSession`` Mode A on smollm-135m (30 layers,
   bf16, remat "full"), merged rank-8 ``qv`` adapters, interval 2, AdamW at
   TrainConfig's lr and weight decay, SyntheticLM batches of 32 x 128: a
   warm-up step, then 6 measured steps (3 fits) with the launch counts reset
   just before and read just after. The payloads and banks go through the
   session's ``OffloadChannel``: 3 fits committed, no rollback, dead letter
   or resend; the host time of the channel's checks a step is printed.
5. Training against the plain path: one f32 full-width ``server_step_a`` +
   ``fit_grads`` on the card and on the CPU (plain versions) must agree, and
   on the card Mode A's fit gradients must equal Mode B's (Prop 1).
6. Serving at scale: phase 2's requests and adapters through
   ``ServeEngine(kv_layout="paged", kv_block=16, prefill_chunk=128,
   bank_store="int8")``, with the launch counts reset just before and read
   just after: paged decode, int8 multi-LoRA and the flash forward (the
   chunk rounds) must run, the dense decode and f32 multi-LoRA kernels must
   not, and the block pool must be whole again at the end.
7. Serving at scale against the plain path, f32 full width, 8 requests: the
   card's paged + chunked + int8 engine against the CPU's (equal greedy
   tokens), and on the card paged == dense and int8 == the f32 engine on the
   explicitly dequantised bank (equal tokens); the largest logit gap of each.
8. The tiered adapter store (``[store]``), phase 2's weights and prompts,
   request i to user (5 i) mod 24, with the launch counts reset just before
   and read just after: (a) 24 users through 8 resident rows
   (``resident_slots=8``) and 16 slots, dense KV and an f32 bank, and
   (b) the same with paged KV, chunks of 128 and an int8 bank, each against
   the all-resident engine with the same options: equal tokens, rows
   evicted, admission waiting on pins, every pin released, the resident
   bank a third of the dense one; (c) clustering at threshold 0.95, shared
   and merged: two near-identical users share one row and their tokens; an
   ``install_adapters`` on one splits it off (copy-on-write), the other's
   tokens stay, the split user's equal a one-user engine on the new bank,
   and a merged member's a one-user engine on the members' mean.
9. The fault-tolerant training runtime (``[runtime]``), smollm-135m at full
   width (30 layers, bf16, remat "full"), with the launch counts reset just
   before and read just after (cola_fit, both flash backward kernels, the
   flash forward, multi_lora and dense decode must run): a K = 4
   ``CollabSession`` (merged Mode A, rank-8 ``qv``, interval 1, AdamW at
   TrainConfig's settings, SyntheticLM 32 x 128 with 4 users, 6 steps,
   ``RetryPolicy(max_attempts=6, timeout_ticks=2)`` without sleeps):
   (a) two fault-free runs give equal banks and losses, bit for bit;
   (b) drop / delay / duplicate on users 1 / 2 / 3 (injector seed 0) are all
   recovered: banks and losses equal (a)'s and the counters equal the JAX
   package's for the same map (12 drops, 4 delays, 8 duplicates injected;
   12 resends, 4 late deliveries, 4 duplicates discarded); (c) with every
   row to user 0 and user 1's returns NaN-poisoned, user 1 is quarantined
   at version 0 (2 rollbacks, 12 rejected fits, 4 refused pushes, 2 dead
   letters), the others reach version 6 and user 0 equals the fault-free
   run bit for bit; ``publish_banks`` into a 16-slot engine on the initial
   banks installs 3, and user 1 serves its initial bank (its tokens equal a
   one-user engine's); (d) ``TrainLoop`` over a Mode A ``ColaSession``:
   2 steps and a resume to 4 equal 4 uninterrupted steps (adapters and
   AdamW state), the straggler hook checkpoints and lifts a quarantine, and
   a fit on the worker thread (``timeout_s``) equals the same-thread fit.
   Prints the collab step, the fit round, the channel's checks and the
   checkpoint's save and restore times.
10. Telemetry (``[telemetry]``), with the launch counts reset just before
   and read just after (all eight kernels must run): (a) phase 2's 32
   requests and (b) phase 6's, each with ``Telemetry(trace=True)``: the
   tokens of the telemetry-off phase, bit for bit, a valid trace, 32
   completed and 32 TTFT samples, no postmortem, (b)'s ``pager.*`` equal to
   the pager's stats and the pool whole; (c) phase 9 (c)'s chaos run with
   the telemetry handed to the injector and the ``CollabSession``: banks and
   losses equal the telemetry-off run's, exactly one quarantine postmortem
   (user 1) whose ring holds the injected fault, the rejected fits, the
   rollback and the quarantine and names ``last_error_seq``, round-tripped
   from disk, none for user 0; (d) a ``TrainLoop`` over Mode A writes
   ``telemetry.jsonl``. No record, span argument or metric holds a tensor.
   Under ``torch.cuda.set_sync_debug_mode("warn")`` one workload makes as
   many synchronising calls with telemetry as without. Prints each path's
   span table (host wall time), the decode-tick and prefill p50 with
   telemetry off and on in turns (three runs each, a reading), and checks
   that a ``torch.profiler`` run sees the ``serve.decode`` and
   ``offload.fit`` annotations of ``Telemetry(profiler_annotations=True)``.
11. gemma2-9b's pairs plan at full width and depth (``[gemma2]``): 42
   layers, bf16, seeded random weights, 4 users' rank-8 qv adapters, 8
   slots, max_len 6144, 12 requests of 256-4800 tokens (two past the 4096
   window), 16 new tokens each, with the launch counts reset just before
   and read just after each run: (a) dense KV and an f32 bank (the flash
   forward, dense decode and multi_lora must run), (b) paged KV in blocks
   of 16, chunks of 128, rings for the local stack and an int8 bank (the
   flash forward, paged decode in its pool and ring modes and
   multi_lora_q8 must run, dense decode must not); every request completes
   and the pool is whole at the end.
12. gemma2-9b against the plain path (``[gemma2-vs-plain]``), f32 at full
   width with the depth cut to 4 layers (2 pairs), three requests of 200 /
   1500 / 4400 tokens, 8 new tokens: the card's dense engine and its paged
   + chunked + ring + int8 engine each against the CPU's same engine, and
   paged + ring against dense on the card: equal greedy tokens.
13. gemma2-9b's ColA training (``[gemma2-train]``): (a) full width and depth
   (42 layers, bf16, remat "full", seeded random weights), ``ColaSession``
   Mode A merged rank-8 ``qv`` on both stacks, interval 1, AdamW at
   TrainConfig's settings, SyntheticLM 1 x 4608 (past the 4096 window), a
   warm-up step and 4 measured steps with a fit each, the offloader on the
   card through the channel, the launch counts reset just before and read
   just after: 84 flash forwards (42 and their recomputes), 42 dq, 42 dk/dv
   a step and 4 cola_fit launches a fit (a tap of each stack); every loss
   finite, every tap's x and grad_h finite and grad_h non-zero, the bank
   moved at every fit, every fit committed; prints the server step p50, the
   fit ms, training tokens/s, the channel's checks and the peak memory.
   (b) f32 at full width, depth cut to 4 layers (2 pairs), 1 x 4608: one
   step of the merged session (server step, fit, AdamW) on the card and on
   the CPU, losses within 1e-5, each tap's grad_h and fit gradients within
   1e-3 of the largest entry (as phase 5), the bank after AdamW within 1e-3
   of its largest entry wherever both devices see the gradient's sign (2 lr
   elsewhere); on the card the unmerged server step's loss and fit
   gradients against the CPU's, and its fit gradients equal to Mode B's
   (Prop 1).
14. The other registered configs (``[configs]``), 8 requests of 32-512
   tokens, 16 new tokens, 8 slots: gpt2-small at full size in f32, its card
   tokens equal to the CPU's; mistral-nemo-12b at full width and depth in
   bf16; mistral-large-123b at full width, depth cut to 2 layers, bf16.
15. The MoE blocks and QK-norm (``[moe]``), with the launch counts reset
   just before and read just after each run: (a) qwen3-moe-30b-a3b at full
   width and depth (48 layers, 128 experts top 8, QK-norm, bf16, seeded
   random weights, init drawn a layer of experts at a time, its peak memory
   printed), phase 14's load (4 users' rank-8 qv adapters, 8 slots,
   max_len 1024, 8 requests of 32-512 tokens, 16 new) with dense KV and an
   f32 bank, then paged KV, chunks of 128 and an int8 bank (the flash
   forward, the layout's decode kernel and the bank's multi-LoRA kernel
   must run, the others not); (b) ColA training on it: a warm-up step and
   2 measured steps, Mode A merged rank-8 qv, interval 1, AdamW, remat
   "full", SyntheticLM 1 x 2048, launches exactly 96 flash forwards, 48 dq
   and 48 dk/dv a step and 2 cola_fit a fit, losses (the aux included)
   finite, grad_h non-zero, the bank moved; (c) dbrx-132b at full width
   with the depth cut to 4 layers, served as in phase 14.
16. The MoE path against the plain path (``[moe-vs-plain]``): qwen3-moe in
   f32 at full width cut to 2 layers, capacity factor 1.25, the dense and
   the paged + chunked + int8 engines on the card and on the CPU (prefill
   and chunk calls route in 512-token groups): equal greedy tokens, and
   how many routing decisions differ between the devices with the smallest
   CPU top-k margin among them; one merged session step at 1 x 1024, card
   against CPU: losses within 1e-5, grad_h and the fit gradients within
   1e-3 of their largest entry.
17. The last lines: the card's name and power limit, one JSON line with every
   kernel's numbers, and ``{"ok": true, "device": {...}}`` last.

Without a card (``torch.cuda.is_available()`` false) it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import re
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
    serving path finds every layer's operands cold). A device-side sleep
    after the flush lets the host enqueue the call before the start event
    runs, so the time is the device's alone: without it, a wrapper's host
    work (checks, allocation, the ctypes call) longer than the flush reads
    as device time."""

    SLEEP_CYCLES = 2_000_000   # ~1 ms at the H100's clocks

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def once_ms(self, fn) -> float:
        self.flush.zero_()
        torch.cuda._sleep(self.SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def median_ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        return statistics.median(self.once_ms(fn) for _ in range(iters))

    def median_diff_ms(self, fn, part, iters: int = 20, warmup: int = 3) -> float:
        """Median over iterations of fn's time less part's, the two timed in
        turns in each iteration: two separate medians drift apart by more
        than the difference itself now and then."""
        for _ in range(warmup):
            fn()
            part()
        return statistics.median(self.once_ms(fn) - self.once_ms(part)
                                 for _ in range(iters))


def ptxas_report(name: str, kernel: str) -> list[str]:
    """Registers and spills of each instantiation of ``kernel`` by its
    template arguments (``<64>``, ``<bf16,64>``, ``<8,3>``), from the
    ``-Xptxas -v`` log of ``csrc/<name>.cu``."""
    from repro_torch.kernels import _build

    out, tag, spills = [], None, ""
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"{kernel}I((?:f|13__nv_bfloat16|Li\d+E|Lb[01]E)+)E",
                          line)
            # a bool template argument names the decode kernel's ring mode
            tag = m and ",".join(
                n or ("ring" if ring == "1" else "bf16" if bf else "f32")
                for n, ring, bf in re.findall(
                    r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)|f", m.group(1))
                if ring != "0")
        elif tag and "spill stores" in line:
            spills = line.strip()
        elif tag and (m := re.search(r"Used (\d+) registers", line)):
            out.append(f"{kernel}<{tag}>: {m.group(1)} registers; {spills}")
            tag = None
    return out


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
    """Inputs of each kernel at the shapes the serving (phase 2) and training
    (phase 4) paths give it. Yields dicts: name, fn (the kernel), plain, lib
    (one library call, or a pair (call, part) whose time difference is the
    library time, or None), nbytes and flops (for the bound), with_lse for
    a flash forward that returns (o, lse), and for a kernel bound by the
    bytes it streams, stream (PyTorch moving the same bytes once: the rate
    the card reaches, printed beside the bound)."""
    import torch.nn.functional as F

    from repro_torch.kernels import cola_fit as cf
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multi_lora as ml
    from repro_torch.kernels import ops, ref

    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    # prefill: 16 prompts padded to the 512 bucket
    J, P = 16, 512
    q, k, v = rnd(J, P, H, D), rnd(J, P, K, D), rnd(J, P, K, D)
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = int((pos[0][None, :] <= pos[0][:, None]).sum())
    yield dict(
        name="flash_attention", with_lse=True,
        fn=lambda: fa.flash_attention(q, k, v, q_positions=pos, kv_positions=pos),
        plain=lambda: fa.plain(q, k, v, q_positions=pos, kv_positions=pos),
        lib=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True),
        nbytes=nbytes(q, k, v, q) + J * H * P * 4 + 2 * P * 4,
        flops=4 * D * pairs * J * H)

    # training: the flash backward at TrainConfig's batch 32 x seq 128
    Bt, S = 32, 128
    q, k, v, do = rnd(Bt, S, H, D), rnd(Bt, S, K, D), rnd(Bt, S, K, D), \
        rnd(Bt, S, H, D)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    o, lse = fa.flash_attention(q, k, v, q_positions=pos, kv_positions=pos)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(q_positions=pos, kv_positions=pos)
    pairs = int((pos[0][None, :] <= pos[0][:, None]).sum()) * Bt * H
    stats = 2 * nbytes(lse) + 2 * S * 4    # lse, delta, positions
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), (qt, kt, vt), dot)

    # the forward at the training shape: 60 launches a step with remat "full"
    yield dict(
        name="flash_attention[train 32 x 128]", with_lse=True,
        fn=lambda: fa.flash_attention(q, k, v, **kw),
        plain=lambda: fa.plain(q, k, v, **kw),
        lib=sdpa_fwd,
        nbytes=nbytes(q, k, v, q) + nbytes(lse) + 2 * S * 4,
        flops=4 * D * pairs)

    yield dict(
        name="flash_attention_bwd_dq",
        fn=lambda: fa.bwd_dq(q, k, v, do, lse, delta, **kw),
        plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw)[0],
        lib=(sdpa_fwd_bwd, sdpa_fwd),
        nbytes=nbytes(q, k, v, do, q) + stats, flops=6 * D * pairs)
    yield dict(
        name="flash_attention_bwd_dkv",
        fn=lambda: fa.bwd_dkv(q, k, v, do, lse, delta, **kw),
        plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw)[1:],
        lib=(sdpa_fwd_bwd, sdpa_fwd),
        nbytes=nbytes(q, k, v, do, k, v) + stats, flops=8 * D * pairs)
    # the pair in one window against the library's whole backward, with the
    # summed bound: the like-for-like comparison
    yield dict(
        name="flash_attention_bwd[pair]",
        fn=lambda: (fa.bwd_dq(q, k, v, do, lse, delta, **kw),
                    *fa.bwd_dkv(q, k, v, do, lse, delta, **kw)),
        plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw),
        lib=(sdpa_fwd_bwd, sdpa_fwd),
        nbytes=nbytes(q, k, v, do, q) + nbytes(q, k, v, do, k, v) + 2 * stats,
        flops=14 * D * pairs)

    # the fit (f32 only): 30 layers, T = interval 2 x 32 x 128 rows, rank 8
    if dtype == torch.float32:
        Lf, T, r, d = cfg.n_layers, 2 * Bt * S, 8, cfg.d_model
        for tap, d_out in (("", H * D), ("[attn.v]", K * D)):
            x, g = rnd(Lf, T, d), rnd(Lf, T, d_out)
            A, Bm = rnd(Lf, d, r) / r ** 0.5, rnd(Lf, r, d_out) * 0.05
            yield dict(
                name="cola_fit" + tap,
                fn=lambda x=x, g=g, A=A, Bm=Bm: cf.cola_fit_lowrank(x, g, A, Bm),
                plain=lambda x=x, g=g, A=A, Bm=Bm: cf.plain(x, g, A, Bm),
                lib=lambda x=x, g=g, A=A, Bm=Bm: (
                    torch.matmul((x @ A).transpose(1, 2), g),
                    torch.matmul(x.transpose(1, 2), g @ Bm.transpose(1, 2))),
                # the rate the card streams x and g at: one reduction each
                stream=lambda x=x, g=g: (x.sum(), g.sum()),
                nbytes=nbytes(x, g, A, Bm, A, Bm),
                flops=4 * r * (d + d_out) * T * Lf)

    # decode tick: 16 slots against a 1024-position cache
    B, Smax = 16, 1024
    qd = rnd(B, 1, H, D)
    kc, vc = rnd(B, Smax, K, D), rnd(B, Smax, K, D)
    posd = torch.randint(32, 545, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    mask = (torch.arange(Smax, device=dev)[None, :] <= posd[:, None])[:, None, None]
    qdt, kct, vct = (t.transpose(1, 2).contiguous() for t in (qd, kc, vc))
    # the tick, and every slot at the horizon (position 1023: all splits live)
    full = torch.full((B,), Smax - 1, dtype=torch.int32, device=dev)
    for tag, p in (("", posd), ("[full 1024]", full)):
        n_kv = int((p.clamp(max=Smax - 1) + 1).sum())
        pmask = (torch.arange(Smax, device=dev)[None, :] <= p[:, None])[:, None, None]
        yield dict(
            name="decode_attention" + tag,
            fn=lambda p=p: da.decode_attention(qd, kc, vc, p, live=live),
            plain=lambda p=p: da.plain(qd, kc, vc, p, live=live),
            lib=lambda pmask=pmask: F.scaled_dot_product_attention(
                qdt, kct, vct, attn_mask=pmask, enable_gqa=True),
            nbytes=2 * nbytes(qd) + 2 * n_kv * K * D * qd.element_size() + B * 5,
            flops=4 * D * H * n_kv)
    n_kv = int((posd.clamp(max=Smax - 1) + 1).sum())

    # the same decode tick on the paged layout: a pool of 16 x 64 blocks of
    # 16 positions, each row's blocks drawn from a shuffled pool
    bs = 16
    nb = Smax // bs
    perm = torch.randperm(B * nb, generator=torch.Generator().manual_seed(SEED))
    table = torch.zeros(B, nb, dtype=torch.int32)
    kp, vp = rnd(B * nb, bs, K, D), rnd(B * nb, bs, K, D)
    it = iter(perm.tolist())
    for b, p in enumerate(posd.tolist()):
        for j in range(p // bs + 1):
            table[b, j] = next(it)
    table = table.to(dev)
    kg, vg = (t[table.long()].flatten(1, 2).transpose(1, 2).contiguous()
              for t in (kp, vp))
    n_tab = int((posd // bs + 1).sum())
    for tag, kw in (("", {}), ("[window 256, softcap 30, dead rows]",
                               dict(window=256, softcap=30.0,
                                    live=torch.arange(B, device=dev) % 4 != 3))):
        wmask = mask if not kw else mask & (
            torch.arange(Smax, device=dev)[None, :]
            > posd[:, None] - 256)[:, None, None]
        n_read = n_kv if not kw else int(
            (kw["live"] * (posd.clamp(max=255) + 1)).sum())
        yield dict(
            name="decode_attention_paged" + tag,
            fn=lambda kw=kw: da.decode_attention_paged(qd, kp, vp, posd, table,
                                                       **kw),
            plain=lambda kw=kw: da.plain_paged(qd, kp, vp, posd, table, **kw),
            lib=lambda wmask=wmask: F.scaled_dot_product_attention(
                qdt, kg, vg, attn_mask=wmask, enable_gqa=True),
            nbytes=(2 * nbytes(qd) + 2 * n_read * K * D * qd.element_size()
                    + n_tab * 4 + B * 5),
            flops=4 * D * H * n_read)

    # a chunk round as the engine's ops calls run it (the flash forward
    # kernel; for paged, after a gather of the rows' blocks): 16 rows of 128
    # queries at chunk starts inside the prompts, a quarter of the rows dead,
    # against the dense cache and against the pool through a shuffled table
    C = 128
    qc = rnd(B, C, H, D)
    posc = C * torch.randint(0, 4, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
    livec = torch.arange(B, device=dev) % 4 != 3
    tablec = torch.zeros(B, nb, dtype=torch.int32)
    it = iter(perm.tolist())
    for b, p in enumerate(posc.tolist()):
        for j in range((p + C - 1) // bs + 1):
            tablec[b, j] = next(it)
    tablec = tablec.to(dev)
    qpos = posc[:, None] + torch.arange(C, device=dev)[None]
    cmask = (torch.arange(Smax, device=dev)[None, None, :]
             <= qpos[:, :, None])[:, None]
    qct = qc.transpose(1, 2).contiguous()
    kgc, vgc = (t[tablec.long()].flatten(1, 2).transpose(1, 2).contiguous()
                for t in (kp, vp))
    n_read = int((livec * (posc + C)).sum())
    pairs = int((livec[:, None] * (qpos + 1)).sum())
    n_tabc = int((livec * ((posc + C - 1) // bs + 1)).sum())
    for tag, fn, plain, kk, vv, tab_bytes in (
            ("[chunk 16 x 128, dense]",
             lambda: ops.sdpa_decode(qc, kc, vc, posc, live=livec),
             lambda: ref.sdpa_decode(qc, kc, vc, posc, live=livec),
             kct, vct, 0),
            ("[chunk 16 x 128, paged]",
             lambda: ops.sdpa_decode_paged(qc, kp, vp, posc, tablec,
                                           live=livec),
             lambda: ref.sdpa_decode_paged(qc, kp, vp, posc, tablec,
                                           live=livec),
             kgc, vgc, n_tabc * 4)):
        yield dict(
            name="flash_attention" + tag, fn=fn, plain=plain,
            lib=lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
                qct, kk, vv, attn_mask=cmask, enable_gqa=True),
            nbytes=(2 * nbytes(qc) + 2 * n_read * K * D * qc.element_size()
                    + tab_bytes + B * 5),
            flops=4 * D * H * pairs)

    # adapted taps, 4 users, rank 8: q at prefill (8192 token rows), and at a
    # decode tick (16 slots, one row each), where it runs most often, q and v;
    # the tick with every row padding: the launch floor of the tick's grid
    U, r, d = 4, 8, cfg.d_model
    A = rnd(U, d, r, dt=torch.float32) / r ** 0.5
    Bq = rnd(U, r, H * D, dt=torch.float32) * 0.05
    Bv = rnd(U, r, K * D, dt=torch.float32) * 0.05
    for tag, T, per_user, Bm in (("", J * P, P, Bq), ("[tick 16]", B, 1, Bq),
                                 ("[tick 16, 576 -> 192]", B, 1, Bv),
                                 ("[tick 16, padding]", B, 0, Bq)):
        x = rnd(T, d)
        idx = ((torch.arange(T // per_user, device=dev, dtype=torch.int32)
                % U).repeat_interleave(per_user) if per_user else
               torch.full((T,), -1, dtype=torch.int32, device=dev))
        d_out = Bm.shape[-1]
        yield dict(
            name="multi_lora" + tag,
            fn=lambda x=x, idx=idx, Bm=Bm: ml.multi_lora(x, A, Bm, idx),
            plain=lambda x=x, idx=idx, Bm=Bm: ml.plain(x, A, Bm, idx),
            lib=None if not per_user else lambda x=x, idx=idx, Bm=Bm: torch.bmm(
                torch.bmm(x.float()[:, None], A[idx.long()]), Bm[idx.long()]),
            # at prefill, the rate the card moves x into a y-sized tensor
            **(dict(stream=lambda x=x, out=torch.empty_like(x): out.copy_(x))
               if T > B else {}),
            nbytes=(nbytes(x, idx, A, Bm) if per_user else nbytes(idx))
            + T * d_out * x.element_size(),
            flops=2 * T * (d * r + r * d_out) if per_user else 0)

    # the int8 bank: a decode tick (16 slots) and a chunk round (16 x 128)
    for tag, T, d_out in (("", B, H * D), ("[576 -> 192]", B, K * D),
                          ("[T 2048]", B * 128, H * D)):
        x = rnd(T, d)
        Aq, As = ml.quant_rows(rnd(U, d, r, dt=torch.float32) / r ** 0.5)
        Bq, Bs = ml.quant_rows(rnd(U, r, d_out, dt=torch.float32) * 0.05)
        ix = (torch.arange(B, device=dev, dtype=torch.int32) % U
              ).repeat_interleave(T // B)
        yield dict(
            name="multi_lora_q8" + tag,
            **(dict(stream=lambda x=x, out=torch.empty_like(x): out.copy_(x))
               if T > B else {}),
            fn=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix:
                ml.multi_lora_q8(x, Aq, As, Bq, Bs, ix),
            plain=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix:
                ml.plain_q8(x, Aq, As, Bq, Bs, ix),
            lib=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix: torch.bmm(
                torch.bmm(x.float()[:, None],
                          Aq[ix.long()].float() * As[ix.long()]),
                Bq[ix.long()].float() * Bs[ix.long()]),
            nbytes=nbytes(x, ix, Aq, As, Bq, Bs) + T * d_out * x.element_size(),
            flops=2 * T * (d * r + r * d_out))


SOFTCAP_NOTE = ("no library call takes a softcap: the library time is on "
                "the row without one")


def _causal_pairs(q_pos, k_len: int, window: int | None = None) -> int:
    """(query, key) pairs a causal (windowed) attention sees: keys at
    positions 0..k_len-1, queries at q_pos (a 1-D tensor of positions)."""
    hi = q_pos.clamp(max=k_len - 1) + 1
    lo = (q_pos - window + 1).clamp(min=0) if window else torch.zeros_like(q_pos)
    return int((hi - lo).clamp(min=0).sum())


def _ring_of(kc, vc, pos, w_ring):
    """Each slot's ring of its last ``w_ring`` positions of a dense cache,
    position t at ring row t % w_ring (rows older than that stay zero)."""
    rk = torch.zeros((kc.shape[0], w_ring) + kc.shape[2:], dtype=kc.dtype,
                     device=kc.device)
    rv = torch.zeros_like(rk)
    for b, p in enumerate(pos.tolist()):
        t = torch.arange(max(0, p - w_ring + 1), p + 1, device=kc.device)
        rk[b, t % w_ring], rv[b, t % w_ring] = kc[b, t], vc[b, t]
    return rk, rv


def model_cases(dtype, dev, gen):
    """Phase-1 rows at the other registered configs' shapes, in ``dtype``
    (names carry it): gemma2-9b's d_head 256 (16 q heads, 8 kv heads, G 2;
    local window 4096, attention softcap 50) in the flash forward (2 x 4608
    with and without window and softcap; a chunk round of 8 rows x 128
    queries against a 6144 cache) and in decode (8 slots up to position
    6143, window 4096, softcap 50, dead rows: dense, paged through a
    shuffled table, and the ring tick, which must equal the dense tick bit
    for bit: ``tick`` names the two); G 1 at d_head 64 (gpt2-small), G 4
    (mistral-nemo-12b), G 8 (qwen3-moe-30b-a3b) and G 6 (dbrx-132b) at
    d_head 128 in both; qwen3-moe's training shape in the flash backward (1
    x 2048) and its fit (cola_fit f32, L 48, T 2048: q 2048 -> 4096, v 2048
    -> 512); and multi_lora (f32 bank, a tick of 8 slots) and multi_lora_q8
    (int8 bank, a chunk round of 8 x 128 rows) at the q and v taps of
    gemma2-9b (3584 -> 4096 / 2048), mistral-nemo-12b (5120 -> 4096 / 1024),
    mistral-large-123b (12288 -> 12288 / 1024), qwen3-moe-30b-a3b (2048 ->
    4096 / 512) and dbrx-132b (6144 -> 6144 / 1024)."""
    import torch.nn.functional as F

    from repro_torch.kernels import cola_fit as cf
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multi_lora as ml
    from repro_torch.kernels import ops, ref

    dt = "bf16" if dtype == torch.bfloat16 else "f32"

    def rnd(*shape, d=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(d)

    def flash(tag, B, S, H, K, D, window=None, softcap=None):
        q, k, v = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        kw = dict(q_positions=pos, kv_positions=pos, window=window,
                  softcap=softcap)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = None
        if softcap is None and window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        return dict(
            name=f"flash_attention[{tag} {dt}]", with_lse=True,
            fn=lambda: fa.flash_attention(q, k, v, **kw),
            plain=lambda: fa.plain(q, k, v, **kw), lib=lib,
            **({} if lib or softcap is None else dict(note=SOFTCAP_NOTE)),
            nbytes=nbytes(q, k, v, q) + B * H * S * 4 + 2 * S * 4,
            flops=4 * D * B * H * _causal_pairs(pos[0], S, window))

    def decode(tag, B, Smax, H, K, D, pos, window=None, softcap=None,
               live=None):
        q = rnd(B, 1, H, D)
        kc, vc = rnd(B, Smax, K, D), rnd(B, Smax, K, D)
        kw = dict(live=live, window=window, softcap=softcap)
        qt, kct, vct = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
        ar = torch.arange(Smax, device=dev)[None, :]
        mask = ar <= pos[:, None]
        if window:
            mask = mask & (ar > pos[:, None] - window)
        lib = None
        if softcap is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kct, vct, attn_mask=mask[:, None, None], enable_gqa=True)
        alive = live if live is not None else torch.ones_like(pos, dtype=torch.bool)
        n_read = int(sum(_causal_pairs(p[None], Smax, window)
                         for p, a in zip(pos, alive) if a))
        return (q, kc, vc, kw), dict(
            name=f"decode_attention[{tag} {dt}]",
            fn=lambda: da.decode_attention(q, kc, vc, pos, **kw),
            plain=lambda: da.plain(q, kc, vc, pos, **kw), lib=lib,
            **({} if lib else dict(note=SOFTCAP_NOTE)),
            nbytes=2 * nbytes(q) + 2 * n_read * K * D * q.element_size() + B * 5,
            flops=4 * D * H * n_read)

    def flash_bwd(tag, B, S, H, K, D, window=None, softcap=None):
        """The dq and dk/dv rows of one backward shape; the library's whole
        backward (``scaled_dot_product_attention``'s) on a row with neither
        window nor softcap, as in kernel_cases."""
        q, k, v, do = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D), \
            rnd(B, S, H, D)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        kw = dict(q_positions=pos, kv_positions=pos, window=window,
                  softcap=softcap)
        o, lse = fa.flash_attention(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        pairs = B * H * _causal_pairs(pos[0], S, window)
        stats = 2 * nbytes(lse) + 2 * S * 4    # lse, delta, positions
        extra = dict(lib=None, note=SOFTCAP_NOTE)
        if softcap is None and window is None:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa_fwd():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)

            def sdpa_fwd_bwd():
                return torch.autograd.grad(F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), (qt, kt, vt),
                    dot)

            extra = dict(lib=(sdpa_fwd_bwd, sdpa_fwd))
        yield dict(extra,
                   name=f"flash_attention_bwd_dq[{tag} {dt}]",
                   fn=lambda: fa.bwd_dq(q, k, v, do, lse, delta, **kw),
                   plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw)[0],
                   nbytes=nbytes(q, k, v, do, q) + stats, flops=6 * D * pairs)
        yield dict(extra,
                   name=f"flash_attention_bwd_dkv[{tag} {dt}]",
                   fn=lambda: fa.bwd_dkv(q, k, v, do, lse, delta, **kw),
                   plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw)[1:],
                   nbytes=nbytes(q, k, v, do, k, v) + stats,
                   flops=8 * D * pairs)

    # gemma2-9b's attention: d_head 256, 16 q heads, 8 kv heads
    H, K, D, W, CAP = 16, 8, 256, 4096, 50.0
    yield flash("gemma2 d256: 2 x 4608, window 4096, softcap 50", 2, 4608, H,
                K, D, window=W, softcap=CAP)
    yield flash("gemma2 d256: 2 x 4608, no window, no softcap", 2, 4608, H, K,
                D)
    # its training shape in the backward ([gemma2-train]: 1 x 4608, 42 dq
    # and 42 dk/dv launches a step), with the local stack's window and
    # softcap and with neither
    yield from flash_bwd("gemma2 d256: 1 x 4608, window 4096, softcap 50", 1,
                         4608, H, K, D, window=W, softcap=CAP)
    yield from flash_bwd("gemma2 d256: 1 x 4608, no window, no softcap", 1,
                         4608, H, K, D)
    # and its fit (f32 only): one stack's 21 layers of each tap, T = 1 x 4608
    # rows, rank 8; q's 3584 + 4096 columns take the shared-memory kernel
    # with its columns split in two, v's 3584 + 2048 one slice
    if dtype == torch.float32:
        L, T, r, d_in = 21, 4608, 8, 3584
        for d_out in (4096, 2048):
            x, g = rnd(L, T, d_in), rnd(L, T, d_out)
            A, Bm = rnd(L, d_in, r) / r ** 0.5, rnd(L, r, d_out) * 0.05
            yield dict(
                name=f"cola_fit[gemma2 {d_in} -> {d_out}: L {L}, T {T} {dt}]",
                fn=lambda x=x, g=g, A=A, Bm=Bm: cf.cola_fit_lowrank(x, g, A, Bm),
                plain=lambda x=x, g=g, A=A, Bm=Bm: cf.plain(x, g, A, Bm),
                lib=lambda x=x, g=g, A=A, Bm=Bm: (
                    torch.matmul((x @ A).transpose(1, 2), g),
                    torch.matmul(x.transpose(1, 2), g @ Bm.transpose(1, 2))),
                stream=lambda x=x, g=g: (x.sum(), g.sum()),
                nbytes=nbytes(x, g, A, Bm, A, Bm),
                flops=4 * r * (d_in + d_out) * T * L)

    # a chunk round of the global stack: 8 rows x 128 queries at chunk
    # starts inside 6144-position prompts against the dense cache, softcap
    # 50, a quarter of the rows dead
    B, Smax, C = 8, 6144, 128
    qc = rnd(B, C, H, D)
    kc, vc = rnd(B, Smax, K, D), rnd(B, Smax, K, D)
    posc = C * torch.randint(0, Smax // C, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
    livec = torch.arange(B, device=dev) % 4 != 3
    qpos = posc[:, None] + torch.arange(C, device=dev)[None]
    pairs = sum(_causal_pairs(qpos[b], Smax) for b in range(B) if livec[b])
    n_read = int((livec * (posc + C)).sum())
    yield dict(
        name=f"flash_attention[gemma2 d256: chunk 8 x 128 against 6144, "
             f"softcap 50 {dt}]",
        fn=lambda: ops.sdpa_decode(qc, kc, vc, posc, live=livec, softcap=CAP),
        plain=lambda: ref.sdpa_decode(qc, kc, vc, posc, live=livec,
                                      softcap=CAP),
        lib=None, note=SOFTCAP_NOTE,
        nbytes=2 * nbytes(qc) + 2 * n_read * K * D * qc.element_size() + B * 5,
        flops=4 * D * H * pairs)
    del qc, kc, vc

    # decode: 8 slots up to position 6143, window 4096, softcap 50, dead rows
    pos = torch.randint(0, Smax, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[1], pos[2] = Smax - 1, W + 200, 100
    live = torch.arange(B, device=dev) % 4 != 3
    tag = "gemma2 d256: 8 slots to 6143, window 4096, softcap 50, dead rows"
    (q, kc, vc, kw), case = decode(tag, B, Smax, H, K, D, pos, window=W,
                                   softcap=CAP, live=live)
    yield dict(case, tick="dense")
    # the same tick through a shuffled pool of 16-position blocks ...
    bs = 16
    nb = Smax // bs
    perm = torch.randperm(B * nb, generator=torch.Generator().manual_seed(SEED))
    table = perm.reshape(B, nb).to(device=dev, dtype=torch.int32)
    kp = torch.empty((B * nb, bs, K, D), dtype=dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[table.long()] = kc.reshape(B, nb, bs, K, D)
    vp[table.long()] = vc.reshape(B, nb, bs, K, D)
    yield dict(case, name=f"decode_attention_paged[{tag} {dt}]",
               fn=lambda: da.decode_attention_paged(q, kp, vp, pos, table, **kw),
               plain=lambda: da.plain_paged(q, kp, vp, pos, table, **kw),
               nbytes=case["nbytes"] + nbytes(table))
    # ... and through the rings of the last 4096 + 127 positions
    rk, rv = _ring_of(kc, vc, pos, W + 127)
    yield dict(case, tick="ring",
               name=f"decode_attention_paged[ring {tag}, W_ring 4223 {dt}]",
               fn=lambda: da.decode_attention_ring(q, rk, rv, pos,
                                                   horizon=Smax, **kw),
               plain=lambda: da.plain_ring(q, rk, rv, pos, **kw))
    del kc, vc

    # gpt2-small (G 1, d_head 64), mistral-nemo-12b (G 4, d_head 128), and
    # the MoE configs' attention: qwen3-moe-30b-a3b (G 8, d_head 128; its
    # serving path's 8 x 512 prefill) and dbrx-132b (G 6, d_head 128)
    for tag, H, K, D in (("gpt2 G 1 d64", 12, 12, 64),
                         ("nemo G 4 d128", 32, 8, 128),
                         ("qwen3 G 8 d128", 32, 4, 128),
                         ("dbrx G 6 d128", 48, 8, 128)):
        yield flash(f"{tag}: 8 x 512", 8, 512, H, K, D)
        pos = torch.randint(32, 1024, (8,), generator=gen, device=dev,
                            dtype=torch.int32)
        yield decode(f"{tag}: 8 slots of 1024", 8, 1024, H, K, D, pos)[1]

    # qwen3-moe-30b-a3b's training shape ([moe] (b): 1 x 2048, 48 dq and 48
    # dk/dv launches a step) and its fit (f32): 48 layers of each tap, T = 1
    # x 2048 rows, rank 8, q 2048 -> 4096 and v 2048 -> 512
    yield from flash_bwd("qwen3 G 8 d128: 1 x 2048", 1, 2048, 32, 4, 128)
    if dtype == torch.float32:
        L, T, r, d_in = 48, 2048, 8, 2048
        for d_out in (4096, 512):
            x, g = rnd(L, T, d_in), rnd(L, T, d_out)
            A, Bm = rnd(L, d_in, r) / r ** 0.5, rnd(L, r, d_out) * 0.05
            yield dict(
                name=f"cola_fit[qwen3 {d_in} -> {d_out}: L {L}, T {T} {dt}]",
                fn=lambda x=x, g=g, A=A, Bm=Bm: cf.cola_fit_lowrank(x, g, A, Bm),
                plain=lambda x=x, g=g, A=A, Bm=Bm: cf.plain(x, g, A, Bm),
                lib=lambda x=x, g=g, A=A, Bm=Bm: (
                    torch.matmul((x @ A).transpose(1, 2), g),
                    torch.matmul(x.transpose(1, 2), g @ Bm.transpose(1, 2))),
                stream=lambda x=x, g=g: (x.sum(), g.sum()),
                nbytes=nbytes(x, g, A, Bm, A, Bm),
                flops=4 * r * (d_in + d_out) * T * L)

    # the adapted taps of the five configs, 4 users, rank 8
    U, r = 4, 8
    for model, d_in, outs in (("gemma2", 3584, (4096, 2048)),
                              ("nemo", 5120, (4096, 1024)),
                              ("large", 12288, (12288, 1024)),
                              ("qwen3", 2048, (4096, 512)),
                              ("dbrx", 6144, (6144, 1024))):
        for d_out in outs:
            A = rnd(U, d_in, r, d=torch.float32) / r ** 0.5
            Bm = rnd(U, r, d_out, d=torch.float32) * 0.05
            x = rnd(8, d_in)
            idx = torch.arange(8, device=dev, dtype=torch.int32) % U
            yield dict(
                name=f"multi_lora[{model} {d_in} -> {d_out}: tick 8 {dt}]",
                fn=lambda x=x, A=A, Bm=Bm, idx=idx: ml.multi_lora(x, A, Bm, idx),
                plain=lambda x=x, A=A, Bm=Bm, idx=idx: ml.plain(x, A, Bm, idx),
                lib=lambda x=x, A=A, Bm=Bm, idx=idx: torch.bmm(
                    torch.bmm(x.float()[:, None], A[idx.long()]), Bm[idx.long()]),
                nbytes=nbytes(x, idx, A, Bm) + 8 * d_out * x.element_size(),
                flops=2 * 8 * (d_in * r + r * d_out))
            Aq, As = ml.quant_rows(A)
            Bq, Bs = ml.quant_rows(Bm)
            T = 8 * 128
            x = rnd(T, d_in)
            ix = (torch.arange(8, device=dev, dtype=torch.int32) % U
                  ).repeat_interleave(128)
            yield dict(
                name=f"multi_lora_q8[{model} {d_in} -> {d_out}: T 1024 {dt}]",
                fn=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix:
                    ml.multi_lora_q8(x, Aq, As, Bq, Bs, ix),
                plain=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix:
                    ml.plain_q8(x, Aq, As, Bq, Bs, ix),
                lib=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix: torch.bmm(
                    torch.bmm(x.float()[:, None],
                              Aq[ix.long()].float() * As[ix.long()]),
                    Bq[ix.long()].float() * Bs[ix.long()]),
                nbytes=nbytes(x, ix, Aq, As, Bq, Bs) + T * d_out * x.element_size(),
                flops=2 * T * (d_in * r + r * d_out))


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) over a tensor or a tuple of them."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    return err, max(float(w.float().abs().max()) for w in want)


def measure(c, dtype, timer) -> dict:
    """One phase-1 row: the kernel against its plain version (within
    TOL[dtype] * (1 + max |plain|)), and the median device times of the
    kernel, the plain version and the library call, beside the bound."""
    name = c["name"]
    got, want = c["fn"](), c["plain"]()
    if c.get("with_lse"):   # (o, lse): scale by o's values
        err = max(max_err(g, w)[0] for g, w in zip(got, want))
        scale = max_err(got[0], want[0])[1]
    else:
        err, scale = max_err(got, want)
    torch.cuda.synchronize()
    tol = TOL[dtype] * (1 + scale)
    check(err <= tol, f"{name} {dtype}: max |kernel - plain| = {err:.3g}"
          f" > {tol:.3g}")
    ms = timer.median_ms(c["fn"])
    plain_ms = timer.median_ms(c["plain"], iters=5)
    lib = c["lib"]
    if isinstance(lib, tuple):   # (call, part): library time of the rest
        lib_ms = timer.median_diff_ms(*lib)
    else:
        lib_ms = timer.median_ms(lib) if lib is not None else None
    b_ms, b_by = bound(c["nbytes"], c["flops"], dtype)
    dt = str(dtype).replace("torch.", "")
    stream = (f"  stream {timer.median_ms(c['stream']):.4f} ms"
              if "stream" in c else "")
    note = f"  ({c['note']})" if "note" in c else ""
    print(f"[kernels] {name:24s} {dt:8s} max_abs_err {err:.3e} "
          f"(tol {tol:.2e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f"  library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
          f"  bound {b_ms:.4g} ms ({b_by}){stream}{note}", flush=True)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms)
    if "note" in c:
        row["note"] = c["note"]
    return row


def phase_kernels(cfg, dev) -> dict:
    """Rows of the JSON line, in the dtype each kernel runs in on its path:
    bf16, and f32 for cola_fit; then the rows of the other registered
    configs' shapes (``model_cases``) in both dtypes."""
    timer = Timer(dev)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for c in kernel_cases(cfg, dtype, dev, gen):
            row = measure(c, dtype, timer)
            if dtype == torch.bfloat16 or c["name"] not in rows:
                rows[c["name"]] = row
    # a second launch of the flash backward, cola_fit, dense and paged decode
    # and both multi-LoRA kernels (all their rows) gives the same bits
    for dtype, names in ((torch.float32, ("flash_attention_bwd", "cola_fit",
                                          "decode_attention", "multi_lora")),
                         (torch.bfloat16, ("flash_attention_bwd",
                                           "decode_attention", "multi_lora"))):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        for c in kernel_cases(cfg, dtype, dev, gen):
            if c["name"].startswith(names):
                a, b = c["fn"](), c["fn"]()
                a, b = (a,) if isinstance(a, torch.Tensor) else a, \
                    (b,) if isinstance(b, torch.Tensor) else b
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      f"{c['name']} {dtype}: two launches on the same inputs "
                      "differ")
    multi_lora_rows(cfg, dev)
    # the pairs plan's d_head 256 and the other configs' head layouts and
    # tap widths, each row launched twice to the same bits
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        outs = {}
        for c in model_cases(dtype, dev, gen):
            rows[c["name"]] = measure(c, dtype, timer)
            a, b = c["fn"](), c["fn"]()
            a, b = (a,) if isinstance(a, torch.Tensor) else a, \
                (b,) if isinstance(b, torch.Tensor) else b
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{c['name']}: two launches on the same inputs differ")
            if "tick" in c:
                outs[c["tick"]] = a[0]
        check(torch.equal(outs["ring"], outs["dense"]),
              f"d_head 256 {dtype}: the ring tick differs from the dense tick")
        print(f"[kernels] d_head 256 {dtype}: the ring tick equals the dense "
              "tick with the same window, bit for bit", flush=True)
    return rows


def multi_lora_rows(cfg, dev) -> None:
    """A row's bits do not depend on the launch: rows of the prefill call
    (T 8192, tiles of 32 rows, f32 bank) and of the chunk-round call (T 2048,
    int8 bank) equal the same rows computed in a tick-sized call of 16 rows
    (one row a block, columns in slices), among other neighbours; and the int8
    kernel equals the f32 kernel on the dequantised bank, in bf16 and f32."""
    from repro_torch.kernels import multi_lora as ml

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    U, r, d, d_out = 4, 8, cfg.d_model, cfg.n_heads * cfg.d_head
    A = torch.randn(U, d, r, generator=gen, device=dev) / r ** 0.5
    Bm = torch.randn(U, r, d_out, generator=gen, device=dev) * 0.05
    (Aq, As), (Bq, Bs) = ml.quant_rows(A), ml.quant_rows(Bm)
    Ad, Bd = ml.dequant_rows(Aq, As), ml.dequant_rows(Bq, Bs)
    for dtype in (torch.bfloat16, torch.float32):
        for name, T, run, fn in (
                ("multi_lora", 16 * 512, 512,
                 lambda x, i: ml.multi_lora(x, A, Bm, i)),
                ("multi_lora_q8", 16 * 128, 128,
                 lambda x, i: ml.multi_lora_q8(x, Aq, As, Bq, Bs, i))):
            x = torch.randn(T, d, generator=gen, device=dev).to(dtype)
            idx = (torch.arange(T // run, device=dev, dtype=torch.int32) % U
                   ).repeat_interleave(run)
            idx[T // 3:T // 3 + 40] = -1
            rows = torch.randperm(T, generator=gen, device=dev)[:16]
            big = fn(x, idx)
            small = fn(x[rows].contiguous(), idx[rows])
            check(torch.equal(small, big[rows]),
                  f"{name} {dtype}: rows of a T {T} call differ from the same "
                  "rows in a T 16 call")
            if name == "multi_lora_q8":
                check(torch.equal(big, ml.multi_lora(x, Ad, Bd, idx)),
                      f"{name} {dtype}: int8 differs from the f32 kernel on the "
                      "dequantised bank")
    torch.cuda.synchronize()
    print("[kernels] multi_lora rows: T 8192 (f32 bank) and T 2048 (int8) "
          "rows == the same rows in T 16 calls; int8 == f32 on the dequantised "
          "bank (bf16, f32)", flush=True)


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


def serve(cfg, params, banks, prompts, device, *, slots, max_len, max_new,
          engine=None, users=None, **options):
    """Serve ``prompts`` to completion (user ``users[i]``, by default
    i % len(banks), for request i); ``options`` go to ``ServeEngine``.
    Returns (engine, requests, the largest ``kv_cache_bytes()`` seen after a
    tick)."""
    from repro_torch.runtime.serve_loop import ServeEngine

    eng = (engine or ServeEngine)(cfg, params, slots=slots, max_len=max_len,
                                  user_adapters=banks, device=device, **options)
    if users is None:
        users = [i % len(banks) for i in range(len(prompts))]
    return (eng, *drive(eng, prompts, users, max_new))


def drive(eng, prompts, users, max_new) -> tuple[list, int]:
    """Submit request i (``prompts[i]`` for ``users[i]``) to ``eng`` and tick
    until it is idle. Returns (requests, the largest ``kv_cache_bytes()``
    seen after a tick)."""
    from repro_torch.runtime.serve_loop import Request

    reqs = [Request(rid=i, user=u, prompt=p, max_new=max_new)
            for i, (u, p) in enumerate(zip(users, prompts))]
    for r in reqs:
        eng.submit(r)
    peak_bytes = eng.kv_cache_bytes()
    for _ in range(10_000):
        if not eng.queue and all(r is None for r in eng.active):
            break
        eng.tick()
        peak_bytes = max(peak_bytes, eng.kv_cache_bytes())
    return reqs, peak_bytes


def serving_setup(cfg, dev):
    """Phase 2's weights, 4 users' adapters and 32 prompts of 32-512 tokens."""
    from repro_torch.models import model

    params = model.init(cfg, seed=SEED, device=dev)
    banks = user_banks(cfg, 4, dev, SEED)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(32, 513, 32)]
    return params, banks, prompts


def phase_serving(cfg, dev, setup) -> tuple[dict, list]:
    """Phase 2; returns the launch counts and the tokens of the measured
    run."""
    params, banks, prompts = setup
    # warm-up (library handles, allocator); its launches are not counted
    serve(cfg, params, banks, prompts[:2], dev, slots=16, max_len=1024,
          max_new=2)
    torch.cuda.synchronize()

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    eng, reqs, _ = serve(cfg, params, banks, prompts, dev, slots=16,
                         max_len=1024, max_new=32)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}

    check(all(r.status == "done" and len(r.out) == 32 for r in reqs),
          "not every request finished with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
          "a token outside the vocabulary")
    for n in ("flash_attention", "decode_attention", "multi_lora"):
        check(launches[n] > 0, f"kernel {n} was never launched on the serving "
              "path")
    tp = eng.throughput()
    print(f"[serve] smollm-135m bf16, 30 layers, 16 slots, 4 users: "
          f"{tp['completed']} requests, decode {tp['decode_tok_per_s']:.1f} tok/s,"
          f" prefill {tp['prefill_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{tp['ttft']['p50'] * 1e3:.1f} ms p99 {tp['ttft']['p99'] * 1e3:.1f} ms,"
          f" decode tick p50 {tp['decode_tick']['p50'] * 1e3:.2f} ms,"
          f" prefill calls {eng.stats['prefill_calls']}", flush=True)
    print(f"[serve] launches on the serving path: {launches}", flush=True)
    return launches, [r.out for r in reqs]


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
        eng, reqs, _ = serve(cfg32, params, banks, prompts, device, slots=4,
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


SCALE = dict(kv_layout="paged", kv_block=16, prefill_chunk=128,
             bank_store="int8")


def phase_serving_at_scale(cfg, dev, setup) -> tuple[dict, list]:
    """Phase 2's requests through paged KV, chunked prefill and an int8 bank;
    returns the launch counts and the tokens of the measured run."""
    from repro_torch.models import model

    params, banks, prompts = setup
    # warm-up with the same options; its launches are not counted
    serve(cfg, params, banks, prompts[:2], dev, slots=16, max_len=1024,
          max_new=2, **SCALE)
    torch.cuda.synchronize()

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    eng, reqs, peak_bytes = serve(cfg, params, banks, prompts, dev, slots=16,
                                  max_len=1024, max_new=32, **SCALE)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}

    check(all(r.status == "done" and len(r.out) == 32 for r in reqs),
          "serving at scale: not every request finished with 32 tokens")
    for n in ("decode_attention_paged", "multi_lora_q8", "flash_attention"):
        check(launches[n] > 0, f"kernel {n} was never launched serving at scale")
    for n in ("decode_attention", "multi_lora"):
        check(launches[n] == 0, f"kernel {n} ran {launches[n]} times serving at "
              "scale (paged KV and an int8 bank must not reach it)")
    for tap, leaves in eng.bank.items():
        check(sorted(leaves) == ["A_q", "A_scale", "B_q", "B_scale"]
              and all(leaves[n].dtype == torch.int8 for n in ("A_q", "B_q"))
              and all(leaves[n].dtype == torch.float32
                      for n in ("A_scale", "B_scale"))
              and all(t.is_cuda for t in leaves.values()),
              f"bank {tap}: {[(n, t.dtype, t.device) for n, t in leaves.items()]}")
    st = eng.stats
    check(st["kv_allocs"] == st["kv_frees"] > 0,
          f"kv allocs {st['kv_allocs']} != frees {st['kv_frees']}")
    eng.pager.assert_empty()

    dense_bytes = sum(int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
                      for leaves in model.cache_specs(cfg, 16, 1024).values()
                      for shape, dt in leaves.values())
    pool_bytes = sum(leaf.numel() * leaf.element_size()
                     for stack in eng.cache.values() for leaf in stack.values())
    tp = eng.throughput()
    decode_calls = tp["decode_tick"]["count"]   # one sample per decode call
    print(f"[scale] smollm-135m bf16, 30 layers, 16 slots, 4 users, paged KV "
          f"(blocks of 16), chunks of 128, int8 bank: {tp['completed']} "
          f"requests, decode {tp['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{tp['prefill_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{tp['ttft']['p50'] * 1e3:.1f} ms p99 {tp['ttft']['p99'] * 1e3:.1f} ms,"
          f" decode tick p50 {tp['decode_tick']['p50'] * 1e3:.2f} ms, chunk "
          f"round p50 {tp['prefill']['p50'] * 1e3:.2f} ms", flush=True)
    print(f"[scale] kv_blocks_peak {st['kv_blocks_peak']} of "
          f"{eng.pager.n_blocks}; kv_cache_bytes at peak {peak_bytes} against "
          f"the dense engine's {dense_bytes} ({peak_bytes / dense_bytes:.3f}: "
          f"the share the traffic used); pool allocated {pool_bytes} bytes "
          f"({pool_bytes / dense_bytes:.3f} of dense); "
          f"ticks {st['ticks']}, chunk rounds {st['chunk_rounds']}, decode "
          f"calls {decode_calls}", flush=True)
    print(f"[scale] launches: {launches}; per chunk round: flash "
          f"{launches['flash_attention'] / st['chunk_rounds']:.1f}; per decode "
          f"call: decode_attention_paged "
          f"{launches['decode_attention_paged'] / decode_calls:.1f}; "
          f"multi_lora_q8 per call (chunk rounds + decode calls) "
          f"{launches['multi_lora_q8'] / (st['chunk_rounds'] + decode_calls):.1f}",
          flush=True)
    return launches, [r.out for r in reqs]


def phase_scale_vs_plain(cfg, dev) -> None:
    """f32 full width, 8 requests: the card's paged + chunked + int8 engine
    against the CPU's, paged against dense and int8 against the dequantised
    f32 bank on the card. Equal greedy tokens; prints the largest gap of the
    next-token logits of live rows across each pair's steps."""
    from repro_torch.kernels import multi_lora as ml
    from repro_torch.models import model
    from repro_torch.runtime.serve_loop import ServeEngine

    class Recording(ServeEngine):
        """Keeps every step's next-token logits of the rows it ran for."""

        def _step_logits(self, tokens, positions, users, live, lens=None):
            out = super()._step_logits(tokens, positions, users, live, lens)
            self.logits.append(out[live].float().cpu())
            return out

        def __init__(self, *a, **kw):
            self.logits = []
            super().__init__(*a, **kw)

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params_cpu = model.init(cfg32, seed=SEED + 1, device="cpu")
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(20, 151, 8)]
    kw = dict(slots=4, max_len=256, max_new=8, engine=Recording,
              prefill_chunk=32, bank_store="int8")
    banks_cpu = user_banks(cfg32, 4, "cpu", SEED + 1)
    banks_gpu = [_to(b, dev) for b in banks_cpu]
    deq = [{t: {n: ml.dequant_rows(*ml.quant_rows(a)).to(dev)
                for n, a in e.items()} for t, e in b.items()} for b in banks_cpu]
    runs = {
        "card": (params_gpu, banks_gpu, dev, dict(kw, kv_layout="paged")),
        "cpu": (params_cpu, banks_cpu, "cpu", dict(kw, kv_layout="paged")),
        "card dense": (params_gpu, banks_gpu, dev, kw),
        "card f32 dequantised": (params_gpu, deq, dev,
                                 dict(kw, kv_layout="paged", bank_store="f32")),
    }
    out = {}
    for name, (params, banks, device, opts) in runs.items():
        eng, reqs, _ = serve(cfg32, params, banks, prompts, device, **opts)
        check(all(r.status == "done" and len(r.out) == 8 for r in reqs),
              f"{name}: not every request finished")
        if eng.pager is not None:
            eng.pager.assert_empty()
        out[name] = ([r.out for r in reqs], eng.logits)
    for other in ("cpu", "card dense", "card f32 dequantised"):
        (toks, lg), (toks_o, lg_o) = out["card"], out[other]
        check(len(lg) == len(lg_o), f"card vs {other}: {len(lg)} steps vs "
              f"{len(lg_o)}")
        gap = max(float((a - b).abs().max()) for a, b in zip(lg, lg_o))
        top = max(float(a.abs().max()) for a in lg)
        print(f"[scale-vs-plain] f32 full width, paged + chunked + int8 on the "
              f"card vs {other}: tokens equal {toks == toks_o}; largest "
              f"next-token logit gap {gap:.3e} (max |logit| {top:.3f}) over "
              f"{len(lg)} steps", flush=True)
        check(toks == toks_o, f"greedy tokens differ, card vs {other}: "
              f"{toks} vs {toks_o}")


STORE_USERS, STORE_ROWS = 24, 8


def _bank_bytes(bank: dict) -> int:
    return sum(l.numel() * l.element_size()
               for leaves in bank.values() for l in leaves.values())


def _store_vs_resident(cfg, params, prompts, banks, dev, tag, **options):
    """Phase 2's requests, request i to user (5 i) mod 24 (users repeat),
    through ``resident_slots=8`` and through the all-resident engine with the
    same options: equal tokens, rows evicted, every pin released, the bank a
    third of the dense one, admission waiting on pins. Prints the store's
    counters and both engines' serving figures."""
    users = [(5 * i) % STORE_USERS for i in range(len(prompts))]
    kw = dict(slots=16, max_len=1024, max_new=32, users=users, **options)
    store, s_reqs, _ = serve(cfg, params, banks, prompts, dev,
                             resident_slots=STORE_ROWS, **kw)
    full, f_reqs, _ = serve(cfg, params, banks, prompts, dev, **kw)
    torch.cuda.synchronize()
    for name, reqs in (("store", s_reqs), ("all-resident", f_reqs)):
        check(all(r.status == "done" and len(r.out) == 32 for r in reqs),
              f"[store] {tag} {name}: not every request finished")
    same = [r.out for r in s_reqs] == [r.out for r in f_reqs]
    st, m = store.stats, store.store.metrics()
    dense = _bank_bytes(full.bank)
    # the first 16 requests are 16 distinct users: all-resident admits them
    # in one round, 8 rows pin at most 8 of them at a time
    rounds = [len({r.t_admit for r in reqs[:16]}) for reqs in (s_reqs, f_reqs)]
    tp = {n: e.throughput() for n, e in (("store", store), ("all", full))}
    print(f"[store] {tag}: U {STORE_USERS}, R {STORE_ROWS}, 16 slots; tokens "
          f"equal to the all-resident engine: {same}; admission rounds of the "
          f"first 16 requests {rounds[0]} (all-resident {rounds[1]}); hits "
          f"{m['hits']} misses {m['misses']} evictions {m['evictions']} "
          f"fetches {m['fetches']}, fetch_time per fetch "
          f"{m['fetch_time'] / max(m['fetches'], 1) * 1e3:.3f} ms (host time "
          f"around the row copies, from pageable host memory: they return "
          f"when done); resident bytes {st['store_resident_bytes']} (dense "
          f"bank {dense}), host bytes {m['host_bytes']}; pinned at the end "
          f"{st['store_pinned']}", flush=True)
    print(f"[store] {tag}: store vs all-resident: decode tick p50 "
          f"{tp['store']['decode_tick']['p50'] * 1e3:.2f} vs "
          f"{tp['all']['decode_tick']['p50'] * 1e3:.2f} ms, TTFT p50 "
          f"{tp['store']['ttft']['p50'] * 1e3:.1f} vs "
          f"{tp['all']['ttft']['p50'] * 1e3:.1f} ms, decode "
          f"{tp['store']['decode_tok_per_s']:.1f} vs "
          f"{tp['all']['decode_tok_per_s']:.1f} tok/s; {card_line()}",
          flush=True)
    check(same, f"[store] {tag}: tokens differ from the all-resident engine")
    check(st["store_evictions"] > 0, f"[store] {tag}: no row was evicted")
    check(st["store_pinned"] == 0, f"[store] {tag}: {st['store_pinned']} "
          "users still pinned")
    check(st["store_resident_bytes"] == dense * STORE_ROWS // STORE_USERS,
          f"[store] {tag}: resident bytes {st['store_resident_bytes']} != "
          f"{dense} * {STORE_ROWS} // {STORE_USERS}")
    check(rounds[0] > 1 and rounds[1] == 1, f"[store] {tag}: admission rounds "
          f"{rounds}: admission never waited on pins")
    for eng in (store, full):
        if eng.pager is not None:
            eng.pager.assert_empty()


def _one_user(cfg, params, bank, prompts, dev, max_new=32) -> list:
    eng, reqs, _ = serve(cfg, params, [bank], prompts, dev, slots=16,
                         max_len=1024, max_new=max_new)
    return [r.out for r in reqs]


def _clustering(cfg, params, prompts, dev) -> None:
    """Four users, 1 a near copy of 0 (cosine 1 >= 0.95), 2 and 3 their own:
    0 and 1 share one resident row and serve the same tokens. ``shared``: an
    install on 1 splits it off (copy-on-write); 0's tokens stay, 1's equal a
    one-user engine on the new bank. ``merged``: a member's tokens equal a
    one-user engine on the members' mean."""
    from repro_torch.core.merge import merge_adapter_pytrees
    from repro_torch.runtime.serve_loop import ServeEngine

    b0, b2, b3 = user_banks(cfg, 3, dev, SEED + 2)
    banks = [b0, {t: {n: a * 1.01 for n, a in e.items()}
                  for t, e in b0.items()}, b2, b3]
    new = user_banks(cfg, 1, dev, SEED + 3)[0]
    for mode in ("shared", "merged"):
        eng = ServeEngine(cfg, params, slots=16, max_len=1024,
                          user_adapters=banks, resident_slots=3,
                          cluster_threshold=0.95, cluster_mode=mode,
                          device=dev)
        st = eng.store
        check(st.cluster_of(0) is not None
              and st.cluster_of(0) == st.cluster_of(1)
              and st.cluster_of(2) is None and st.cluster_of(3) is None,
              f"[store] {mode}: clusters "
              f"{[st.cluster_of(u) for u in range(4)]}")

        def tokens(user):
            reqs, _ = drive(eng, prompts, [user] * len(prompts), 32)
            return [r.out for r in reqs]

        t0, t1 = tokens(0), tokens(1)
        check(t0 == t1 and st.resident_index(0) == st.resident_index(1),
              f"[store] {mode}: the cluster's members differ")
        if mode == "shared":
            check(eng.install_adapters(1, new, version=1),
                  "[store] shared: the install was rejected")
            a0, a1 = tokens(0), tokens(1)
            solo = _one_user(cfg, params, new, prompts, dev)
            print(f"[store] shared: splits {st.counters['splits']}; after "
                  f"the split 0's tokens unchanged {a0 == t0}, 1's changed "
                  f"{a1 != t1} and equal to a one-user engine on the new bank "
                  f"{a1 == solo}", flush=True)
            check(st.counters["splits"] == 1 and st.cluster_of(1) is None,
                  f"[store] shared: splits {st.counters['splits']}")
            check(a0 == t0, "[store] shared: a split perturbed the cluster")
            check(a1 != t1 and a1 == solo, "[store] shared: the split user "
                  "does not serve the new bank")
        else:
            mean = merge_adapter_pytrees([_to(b, "cpu") for b in banks[:2]])
            solo = _one_user(cfg, params, _to(mean, dev), prompts, dev)
            print(f"[store] merged: a member's tokens equal a one-user engine "
                  f"on the members' mean {t0 == solo}", flush=True)
            check(t0 == solo, "[store] merged: tokens differ from the mean's")


def phase_store(cfg, dev, setup) -> dict:
    """The tiered adapter store at full width (phase 2's weights and
    prompts): (a) dense KV and an f32 bank, (b) paged KV, chunks of 128 and
    an int8 bank, each against the all-resident engine with the same
    options, (c) clustering and the copy-on-write hot-swap. Returns the
    launch counts of the phase."""
    params, _, prompts = setup
    banks = user_banks(cfg, STORE_USERS, dev, SEED)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    _store_vs_resident(cfg, params, prompts, banks, dev, "(a) dense, f32")
    _store_vs_resident(cfg, params, prompts, banks, dev,
                       "(b) paged, chunks of 128, int8", **SCALE)
    _clustering(cfg, params, prompts[:4], dev)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}
    print(f"[store] launches: {launches}", flush=True)
    for n in ("flash_attention", "decode_attention", "decode_attention_paged",
              "multi_lora", "multi_lora_q8"):
        check(launches[n] > 0, f"kernel {n} was never launched in [store]")
    return launches


def wrappers() -> dict:
    """Every kernel wrapper of the port, by the kernel's name; each counts
    its own launches."""
    from repro_torch.kernels import cola_fit as cf
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multi_lora as ml

    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd_dq": fa.bwd_dq,
            "flash_attention_bwd_dkv": fa.bwd_dkv,
            "cola_fit": cf.cola_fit_lowrank,
            "decode_attention": da.decode_attention,
            "decode_attention_paged": da.decode_attention_paged,
            "multi_lora": ml.multi_lora,
            "multi_lora_q8": ml.multi_lora_q8}


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "cola_fit")


def _measured_steps(sess, batches, dev) -> dict:
    """A warm-up step of ``sess`` on ``batches[0]`` (its launches are not
    counted), then a step on each later batch with every kernel's launch
    count reset just before and read just after, the peak memory read from
    a reset, each fit timed between syncs and the channel's checks timed
    (``time_channel_checks``). Checks that every fit moved the bank.
    Returns the losses, step / server / fit ms, the checks' ms, the launch
    counts and the peak memory."""
    from repro_torch.utils import tree_leaves

    off = sess.offloader
    fit_ms: list[float] = []
    inner = off.maybe_fit

    def timed_fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner()
        torch.cuda.synchronize()
        fit_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    off.maybe_fit = timed_fit
    sess.step(batches[0])
    torch.cuda.synchronize()
    fit_ms.clear()
    check_ms, untimed = time_channel_checks()

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, server_ms, losses = [], [], []
    for b in batches[1:]:
        before = [t.clone() for t in tree_leaves(sess.adapters)]
        n_fits = len(fit_ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(sess.step(b))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        server_ms.append(step_ms[-1] - sum(fit_ms[n_fits:]))
        if len(fit_ms) > n_fits:
            check(any(not torch.equal(a, t) for a, t
                      in zip(before, tree_leaves(sess.adapters))),
                  f"step {sess.step_count}: the fit left the adapters as they were")
    launches = {n: w.launches for n, w in ws.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    untimed()
    off.maybe_fit = inner
    return dict(losses=losses, step_ms=step_ms, server_ms=server_ms,
                fit_ms=fit_ms, check_ms=check_ms, launches=launches, peak=peak)


def phase_training(cfg, dev) -> dict:
    """Six Mode A steps of ColaSession at full width; returns the launch
    counts of the measured steps."""
    from repro_torch.configs.base import ColaConfig, TrainConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.optim import optimizers
    from repro_torch.profile_train import SETUPS

    tc = TrainConfig()
    batch, seq, interval = SETUPS[cfg.name]
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=interval)
    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16",
          f"training config {cfg.remat}/{cfg.param_dtype}")
    sess = ColaSession(cfg, cc, model.init(cfg, seed=SEED, device=dev),
                       seed=SEED, device=dev, optimizer=optimizers.adamw(
                           tc.lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
                           weight_decay=tc.weight_decay))
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=SEED, device=dev)
    m = _measured_steps(sess, [data.batch_at(i) for i in range(7)], dev)
    losses, step_ms, fit_ms = m["losses"], m["step_ms"], m["fit_ms"]
    launches = m["launches"]
    off = sess.offloader
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(len(fit_ms) == 3 and off.stats["fits"] == 3,
          f"{len(fit_ms)} fits in the measured steps, {off.stats['fits']} in all")
    health = sess.channel_health()[0]
    check(health["fits_committed"] == 3 and all(
        health[k] == 0 for k in ("rollbacks", "dead_letters", "send_retries")),
        f"offload rounds failed: {health}")
    for n in TRAIN_KERNELS:
        check(launches[n] > 0, f"kernel {n} was never launched in training")
    n_steps = len(step_ms)
    tokens = n_steps * batch * seq
    print(f"[train] smollm-135m bf16, 30 layers, remat full, Mode A merged "
          f"rank-8 qv, interval {interval}, batch {batch} x {seq}: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"[train] step ms {[round(t, 2) for t in step_ms]}; server step p50 "
          f"{statistics.median(m['server_ms']):.2f} ms; fit ms "
          f"{[round(t, 2) for t in fit_ms]} (p50 {statistics.median(fit_ms):.2f});"
          f" {checks_line(m['check_ms'], n_steps)}; "
          f"{tokens / (sum(step_ms) / 1e3):.1f} training tokens/s; peak memory "
          f"{m['peak'] / 2**30:.3f} GiB", flush=True)
    print(f"[train] launches in {n_steps} steps: {launches}; per step "
          f"{ {n: c / n_steps for n, c in launches.items()} }", flush=True)
    return launches


def phase_training_vs_plain(cfg, dev) -> None:
    """f32 full width, batch 2 x 128: the card's Mode A server step and fit
    against the CPU's (plain versions), and on the card Mode A == Mode B."""
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core import gl
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8)
    spec_a = gl.make_spec(cfg32, cc)
    spec_b = gl.make_spec(cfg32, ColaConfig(mode="fused_fit", family="lowrank",
                                            taps="qv", rank=8))
    params = model.init(cfg32, seed=SEED + 2, device="cpu")
    gen = torch.Generator().manual_seed(SEED + 2)
    adapters = gl.init_adapters(cfg32, cc, gen, device="cpu")
    for w in adapters.values():   # B != 0, so dA carries information
        w["B"] = torch.randn(w["B"].shape, generator=gen) * 0.02
    batch = SyntheticLM(cfg32, batch=2, seq=128, seed=SEED + 2,
                        device="cpu").batch_at(0)
    out = {}
    for device in ("cpu", dev):
        p, ad, b = (_to(t, device) for t in (params, adapters, batch))
        loss, data, _ = gl.server_step_a(cfg32, spec_a, p, ad, b)
        out[str(device)] = (float(loss), gl.fit_grads(spec_a, ad, data))
    loss_cpu, g_cpu = out["cpu"]
    loss_gpu, g_gpu = out[str(dev)]
    # f32 sums in other orders through 30 layers and a 49152-way softmax
    loss_diff = abs(loss_gpu - loss_cpu)
    check(loss_diff <= 1e-5 * abs(loss_cpu),
          f"loss card {loss_gpu} vs CPU {loss_cpu}")
    worst = 0.0
    for tap, w in g_cpu.items():
        for leaf, a in w.items():
            err, scale = max_err(g_gpu[tap][leaf].cpu(), a)
            worst = max(worst, err / scale)
            check(err <= 1e-3 * scale, f"fit grad {tap}.{leaf}: card vs CPU "
                  f"max |diff| {err:.3g} > 1e-3 x {scale:.3g}")
    # Prop 1 on the card, at test_gl_equivalence.py's tolerance
    ad = _to(adapters, dev)
    loss_b, g_b, _ = gl.train_step_b(cfg32, spec_b, _to(params, dev), ad,
                                     _to(batch, dev))
    prop1 = 0.0   # max |A - B| / (atol + rtol |B|): allclose when <= 1
    for tap, w in g_b.items():
        for leaf, b in w.items():
            a = g_gpu[tap][leaf]
            ratio = float(((a - b).abs() / (1e-6 + 2e-4 * b.abs())).max())
            prop1 = max(prop1, ratio)
            check(ratio <= 1, f"Prop 1 on the card: {tap}.{leaf} Mode A vs "
                  f"Mode B beyond rtol 2e-4, atol 1e-6 ({ratio:.3g} x)")
    check(abs(float(loss_b) - loss_gpu) <= 1e-6 * abs(loss_gpu),
          f"Mode B loss {float(loss_b)} vs Mode A {loss_gpu}")
    print(f"[train-vs-plain] f32 full width, batch 2 x 128: loss card "
          f"{loss_gpu:.7f} CPU {loss_cpu:.7f} (|diff| {loss_diff:.3e}); fit "
          f"grads max |card - CPU| / max |CPU| {worst:.3e} (tol 1e-3); Prop 1 on "
          f"the card: max |A - B| / (1e-6 + 2e-4 |B|) = {prop1:.3f} (<= 1)",
          flush=True)


def time_channel_checks():
    """Time every check of ``OffloadChannel`` (a payload's checksums and
    finiteness, a returned bank's finiteness and update norm): host time
    from a sync before the check to its result, so it reads the check alone
    and not the device work queued before it. Returns (the times in ms by
    kind, "payload" and "bank", a function that removes the timing)."""
    from repro_torch.core import channel

    ms: dict[str, list[float]] = {"payload": [], "bank": []}
    originals = {"payload": channel._tree_stats, "bank": channel._bank_stats}

    def timed(fn, into):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    channel._tree_stats = timed(originals["payload"], ms["payload"])
    channel._bank_stats = timed(originals["bank"], ms["bank"])

    def untimed():
        channel._tree_stats = originals["payload"]
        channel._bank_stats = originals["bank"]

    return ms, untimed


def checks_line(ms: dict, steps: int) -> str:
    """The channel's checks: host ms a step, and each kind's p50 a check."""
    total = sum(sum(v) for v in ms.values())
    kinds = ", ".join(f"{k} p50 {statistics.median(v):.3f} ms x {len(v)}"
                      for k, v in ms.items() if v)
    return (f"channel checks {total / steps:.3f} ms of host time a step "
            f"({kinds})")


# ---------------------------------------------------------------------------
# phase 9: the fault-tolerant training runtime
# ---------------------------------------------------------------------------

RUNTIME_STEPS = 6
RUNTIME_ZERO = ("send_retries", "late_deliveries", "dup_discarded",
                "rollbacks", "corrupt_rejected", "nan_rejected", "late_dropped",
                "dead_letters", "fit_rejected", "refused_quarantined",
                "fit_timeouts", "fit_errors")
RUNTIME_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv", "cola_fit", "multi_lora",
                   "decode_attention")


def _adamw():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import optimizers

    tc = TrainConfig()
    return optimizers.adamw(tc.lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
                            weight_decay=tc.weight_decay)


def _policy(**kw):
    from repro_torch.runtime.faults import RetryPolicy

    return RetryPolicy(**{"max_attempts": 6, "timeout_ticks": 2,
                          "backoff_base": 0.0, "sleep": lambda s: None, **kw})


def _collab_run(cfg, params, batches, dev, *, injector=None, user0=False,
                fit_ms=None, telemetry=None):
    """Six steps of a K = 4 merged ``CollabSession`` (rank-8 ``qv``,
    interval 1, AdamW at TrainConfig's settings). With ``fit_ms``, every fit
    round is timed between syncs into it. Returns (session, losses, step
    ms)."""
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.collab import CollabSession

    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1, users=4)
    sess = CollabSession(cfg, cc, params, seed=SEED, optimizer=_adamw(),
                         injector=injector, policy=_policy(), device=dev,
                         telemetry=telemetry)
    if fit_ms is not None:
        for ch in sess.channels:
            def timed(fn=ch.fit_round):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                fit_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            ch.fit_round = timed
    losses, step_ms = [], []
    for b in batches:
        b = dict(b)
        uid = b.pop("user_id")
        if user0:
            uid = torch.zeros_like(uid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(sess.train_step(b, uid))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return sess, losses, step_ms


def _bank_leaves(sess) -> list[list]:
    from repro_torch.utils import sorted_leaves

    return [[t.clone() for t in sorted_leaves(ch.adapters)]
            for ch in sess.channels]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _runtime_collab(cfg, params, dev) -> dict:
    """(a) determinism, (b) recoverable faults, (c) a poisoned peer and its
    banks served. Returns the figures to print."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.faults import (SINGLE_FAULTS, FaultInjector,
                                            FaultProfile)
    from repro_torch.runtime.serve_loop import ServeEngine, publish_banks

    data = SyntheticLM(cfg, batch=32, seq=128, users=4, seed=SEED, device=dev)
    batches = [data.batch_at(i) for i in range(RUNTIME_STEPS)]

    # (a) two fault-free runs: equal bits; the second times its fit rounds
    # and the channel's checks
    ref, ref_losses, step_ms = _collab_run(cfg, params, batches, dev)
    ref_banks = _bank_leaves(ref)
    fit_ms: list[float] = []
    check_ms, untimed = time_channel_checks()
    try:
        again, losses, _ = _collab_run(cfg, params, batches, dev,
                                       fit_ms=fit_ms)
    finally:
        untimed()
    check(losses == ref_losses, f"[runtime] (a) losses of two fault-free "
          f"runs differ: {ref_losses} vs {losses}")
    check(all(_equal(a, b) for a, b in zip(_bank_leaves(again), ref_banks)),
          "[runtime] (a) banks of two fault-free runs differ")
    check(ref.bank_versions() == [RUNTIME_STEPS] * 4,
          f"[runtime] (a) versions {ref.bank_versions()}")
    del again
    print(f"[runtime] (a) K 4, {RUNTIME_STEPS} steps, batch 32 x 128: two "
          f"fault-free runs equal bit for bit; losses "
          f"{[round(x, 4) for x in ref_losses]}", flush=True)

    # (b) drop, delay and duplicate: recovered, bit for bit, JAX's counters
    inj = FaultInjector({1: SINGLE_FAULTS["drop"], 2: SINGLE_FAULTS["delay"],
                         3: SINGLE_FAULTS["duplicate"]}, seed=0)
    sess, losses, _ = _collab_run(cfg, params, batches, dev, injector=inj)
    hs = sess.channel_health()
    want = {1: {"send_retries": 12}, 2: {"late_deliveries": 4},
            3: {"dup_discarded": 4}}
    got = {k: {c: hs[k][c] for c in RUNTIME_ZERO if hs[k][c]} for k in hs}
    check(inj.injected == {"drop": 12, "delay": 4, "duplicate": 8,
                           "corrupt": 0, "nan": 0},
          f"[runtime] (b) injected {inj.injected}")
    check(got == {k: want.get(k, {}) for k in range(4)},
          f"[runtime] (b) counters {got}")
    check(sess.bank_versions() == [RUNTIME_STEPS] * 4,
          f"[runtime] (b) versions {sess.bank_versions()}")
    check(losses == ref_losses and all(
        _equal(a, b) for a, b in zip(_bank_leaves(sess), ref_banks)),
        "[runtime] (b) recovered faults changed the banks or losses")
    print(f"[runtime] (b) drop/delay/duplicate on users 1/2/3: injected "
          f"{inj.injected}; counters {got}; banks and losses equal (a)'s",
          flush=True)
    del sess

    # (c) user 1's returns poisoned, every row to user 0
    clean, clean_losses, _ = _collab_run(cfg, params, batches, dev, user0=True)
    inj = FaultInjector({1: FaultProfile(nan=1.0, targets=("adapters",))},
                        seed=0)
    sess, losses, _ = _collab_run(cfg, params, batches, dev, injector=inj,
                                  user0=True)
    h1 = sess.channel_health()[1]
    got1 = {c: h1[c] for c in RUNTIME_ZERO if h1[c]}
    check(h1["quarantined"] and h1["version"] == 0 and got1 == {
        "rollbacks": 2, "fit_rejected": 12, "refused_quarantined": 4,
        "dead_letters": 2} and len(sess.channels[1].dead_letters) == 2,
        f"[runtime] (c) user 1: {h1}")
    check(sess.bank_versions() == [RUNTIME_STEPS, 0, RUNTIME_STEPS,
                                   RUNTIME_STEPS],
          f"[runtime] (c) versions {sess.bank_versions()}")
    check(losses == clean_losses and _equal(_bank_leaves(sess)[0],
                                            _bank_leaves(clean)[0]),
          "[runtime] (c) the poisoned peer perturbed user 0")
    del clean

    # the committed banks into a 16-slot f32-bank engine on the initial ones
    # (those of a session that has taken no step)
    init = [off.adapters for off in _collab_run(cfg, params, [], dev)[0]
            .offloaders]
    eng = ServeEngine(cfg, params, slots=16, max_len=1024, user_adapters=init,
                      device=dev)
    installed = publish_banks(eng, sess.channels)
    check(installed == 3 and eng.bank_versions.tolist() == [
        RUNTIME_STEPS, 0, RUNTIME_STEPS, RUNTIME_STEPS],
        f"[runtime] (c) installed {installed}, versions "
        f"{eng.bank_versions.tolist()}")
    for tap, e in eng.bank.items():
        for name, leaf in e.items():
            check(torch.equal(leaf[:, 1], init[1][tap][name]),
                  f"[runtime] (c) user 1's row of {tap}.{name} changed")
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (24, 57, 130)]
    tokens = {}
    for u in range(4):
        reqs, _ = drive(eng, prompts, [u] * len(prompts), 8)
        check(all(r.status == "done" and len(r.out) == 8 for r in reqs),
              f"[runtime] (c) user {u}'s requests did not finish")
        tokens[u] = [r.out for r in reqs]
    solo = _one_user(cfg, params, init[1], prompts, dev, max_new=8)
    check(tokens[1] == solo, "[runtime] (c) user 1's tokens differ from a "
          "one-user engine on its initial bank")
    print(f"[runtime] (c) nan on user 1's returns, rows to user 0: user 1 "
          f"quarantined at version 0, {got1}; user 0 equal to the fault-free "
          f"run; publish_banks installed {installed}, bank_versions "
          f"{eng.bank_versions.tolist()}, user 1 serves its initial bank "
          f"(tokens equal a one-user engine)", flush=True)
    return {"step_ms": step_ms, "fit_ms": fit_ms, "check_ms": check_ms}


def _runtime_restart(cfg, params, dev) -> dict:
    """(d) TrainLoop over a Mode A ColaSession: 4 steps against 2 + a resume
    to 4, the straggler hook, a fit on the worker thread. Returns the
    checkpoint's save and restore ms."""
    import tempfile

    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.train_loop import TrainLoop
    from repro_torch.utils import sorted_leaves

    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1)
    data = SyntheticLM(cfg, batch=32, seq=128, seed=SEED, device=dev)

    def session(**kw):
        return ColaSession(cfg, cc, params, seed=SEED, optimizer=_adamw(),
                           device=dev, **kw)

    def state(sess):
        off = sess.offloader
        return ([t.clone() for t in sorted_leaves(off.adapters)]
                + [t.clone() for t in sorted_leaves(
                    {k: v for k, v in off.opt_state.items() if k != "step"})],
                off.opt_state["step"])

    with tempfile.TemporaryDirectory() as d:
        full = TrainLoop(session(), data, f"{d}/a", ckpt_every=2)
        full.run(4, resume=False)
        TrainLoop(session(), data, f"{d}/b", ckpt_every=2).run(2, resume=False)
        resumed = TrainLoop(session(), data, f"{d}/b", ckpt_every=2)
        resumed.run(4, resume=True)
        (want, want_step), (got, got_step) = state(full.session), state(
            resumed.session)
        check(resumed.session.step_count == 4 and got_step == want_step == 4
              and type(got_step) is int and _equal(got, want)
              and resumed.losses == full.losses[2:],
              "[runtime] (d) the resumed run differs from the uninterrupted")

        sess = full.session
        sess.channel.quarantined = True
        full._on_straggler(4, 9.9, 0.1)
        full.ckpt.wait()
        check(full.ckpt.latest_step() == 4 and not sess.channel.quarantined
              and full.recoveries == 1,
              "[runtime] (d) the straggler hook did not checkpoint and reset")

        save_ms, restore_ms = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full.ckpt.save(5, full._state())
            save_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            step, tree = full.ckpt.restore(5)
            full._load_state(tree)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        check(_equal(state(sess)[0], want), "[runtime] (d) a restore changed "
              "the state")

    # one fit on the worker thread (timeout_s) against the same thread
    banks = []
    for policy in (None, _policy(timeout_s=60.0)):
        s = session(policy=policy)
        s.step(data.batch_at(0))
        banks.append([t.clone() for t in sorted_leaves(s.adapters)])
    check(_equal(*banks), "[runtime] (d) the worker-thread fit differs")
    print(f"[runtime] (d) TrainLoop over Mode A: 2 steps + a resume to 4 equal "
          f"4 uninterrupted (adapters, AdamW state, step {got_step}); the "
          f"straggler hook checkpointed and lifted the quarantine; the fit on "
          f"the worker thread equals the same-thread fit", flush=True)
    return {"save_ms": save_ms, "restore_ms": restore_ms}


def phase_runtime(cfg, dev) -> dict:
    """Phase 9 at full width; returns the launch counts of the phase."""
    from repro_torch.models import model

    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16",
          f"runtime config {cfg.remat}/{cfg.param_dtype}")
    params = model.init(cfg, seed=SEED, device=dev)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    figs = _runtime_collab(cfg, params, dev)
    figs.update(_runtime_restart(cfg, params, dev))
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}
    print(f"[runtime] launches: {launches}", flush=True)
    for n in RUNTIME_KERNELS:
        check(launches[n] > 0, f"kernel {n} was never launched in [runtime]")
    fit = figs["fit_ms"]
    print(f"[runtime] collab step p50 {statistics.median(figs['step_ms']):.2f} "
          f"ms (K 4; steps {[round(t, 2) for t in figs['step_ms']]}); fit round "
          f"p50 {statistics.median(fit):.3f} ms a user ({len(fit)} rounds, "
          f"{sum(fit) / RUNTIME_STEPS:.3f} ms a step); "
          f"{checks_line(figs['check_ms'], RUNTIME_STEPS)}; checkpoint save p50 "
          f"{statistics.median(figs['save_ms']):.2f} ms, restore p50 "
          f"{statistics.median(figs['restore_ms']):.2f} ms; {card_line()}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 10: telemetry through the serving paths and the training runtime
# ---------------------------------------------------------------------------

NAN_USER1 = dict(nan=1.0, targets=("adapters",))


def _host_values_only(tm) -> None:
    """No tensor reaches a record, a span argument or a metric (it would
    sync when a postmortem prints it, and keep device memory alive)."""
    def walk(v):
        check(not isinstance(v, torch.Tensor),
              f"[telemetry] a tensor in the telemetry: {v!r}")
        if isinstance(v, (dict, list)):
            for x in (v.values() if isinstance(v, dict) else v):
                walk(x)

    walk([tm.recorder.events(*k) for k in tm.recorder.keys()])
    walk([p["events"] for p in tm.recorder.postmortems])
    walk([ev.get("args", {}) for ev in (tm.tracer.events if tm.tracer else ())])
    walk(tm.snapshot())


def _span_table(tag: str, tm, names) -> dict:
    """Print the trace's rows of ``names`` (ms, host wall time) and return
    them by name; every name must have spans."""
    from repro_torch import trace_summary
    from repro_torch.telemetry import validate_trace

    doc = tm.tracer.to_doc()
    problems = validate_trace(doc)
    check(problems == [], f"[telemetry] {tag}: invalid trace {problems[:3]}")
    rows = {r["name"]: r for r in trace_summary.span_table(doc)}
    for n in names:
        check(n in rows, f"[telemetry] {tag}: no {n} span ({sorted(rows)})")
        r = rows[n]
        print(f"[telemetry] {tag} span {n}: count {r['count']}, total "
              f"{r['total_ms']:.2f} ms, mean {r['mean_ms']:.3f}, p50 "
              f"{r['p50_ms']:.3f}, p99 {r['p99_ms']:.3f}, max "
              f"{r['max_ms']:.3f} ms", flush=True)
    return rows


def count_syncs(fn) -> "collections.Counter":
    """Synchronising calls ``fn`` makes, as ``torch.cuda``'s sync debug mode
    reports them (one warning each), by the Python line that made them."""
    import collections
    import gc
    import warnings

    gc.collect()            # no finalizer of an earlier run's objects inside
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def _telemetry_serving(cfg, dev, setup, want, tag, d, **options):
    """Phase 2's (or 6's) 32 requests with telemetry: the tokens of the
    telemetry-off run, a valid trace, JAX's counters, no postmortem."""
    from repro_torch.telemetry import Telemetry

    params, banks, prompts = setup
    tm = Telemetry(trace=True, out_dir=d)
    eng, reqs, _ = serve(cfg, params, banks, prompts, dev, slots=16,
                         max_len=1024, max_new=32, telemetry=tm, **options)
    check([r.out for r in reqs] == want,
          f"[telemetry] {tag}: tokens differ from the telemetry-off run's")
    snap = eng.telemetry_snapshot()
    check(snap["serve.completed"] == 32 and snap["serve.ttft_s"]["count"] == 32,
          f"[telemetry] {tag}: completed {snap['serve.completed']}, ttft "
          f"count {snap['serve.ttft_s']['count']}")
    check(tm.recorder.postmortems == [],
          f"[telemetry] {tag}: postmortems {tm.recorder.postmortems[:1]}")
    _host_values_only(tm)
    return tm, eng, snap


def _telemetry_chaos(cfg, params, dev, d) -> None:
    """Phase 9 (c)'s chaos run with telemetry: the same banks and losses,
    one quarantine postmortem (user 1) that names the failing seq ids. Runs
    off, on, on, off, so that the step times compare in turns."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.faults import FaultInjector, FaultProfile
    from repro_torch.telemetry import Telemetry

    data = SyntheticLM(cfg, batch=32, seq=128, users=4, seed=SEED, device=dev)
    batches = [data.batch_at(i) for i in range(RUNTIME_STEPS)]
    runs, step_ms = [], {False: [], True: []}
    for on, d_run in ((False, None), (True, d), (True, f"{d}-2"),
                      (False, None)):
        tm = Telemetry(trace=True, out_dir=d_run) if on else None
        sess, losses, ms = _collab_run(
            cfg, params, batches, dev, user0=True, telemetry=tm,
            injector=FaultInjector({1: FaultProfile(**NAN_USER1)}, seed=0,
                                   telemetry=tm))
        runs.append((_bank_leaves(sess), losses, sess if len(runs) == 1
                     else None, tm))
        step_ms[on].append(statistics.median(ms))
        del sess
    for banks, losses, _, _ in runs[1:]:
        check(losses == runs[0][1] and all(
            _equal(a, b) for a, b in zip(banks, runs[0][0])),
            "[telemetry] (c) telemetry changed the chaos run's banks or "
            "losses")
    sess, tm = runs[1][2], runs[1][3]
    pms = tm.recorder.postmortems
    quar = [p for p in pms if p["reason"].startswith("quarantined after")]
    check(len(quar) == 1 and (quar[0]["scope"], quar[0]["key"]) == ("user", 1),
          f"[telemetry] (c) quarantine postmortems {[p['reason'] for p in pms]}")
    pm = quar[0]
    kinds = [e["kind"] for e in pm["events"]]
    check({"fault_injected", "fit_rejected", "rollback", "quarantine"}
          <= set(kinds), f"[telemetry] (c) the postmortem's kinds {kinds}")
    failing = {e["seq"] for e in pm["events"]
               if e["kind"] in ("fit_rejected", "rollback")}
    last = sess.channels[1].health()["last_error_seq"]
    check(last in failing, f"[telemetry] (c) last_error_seq {last} not in "
          f"the postmortem's failing seqs {sorted(failing)}")
    with open(pm["path"]) as f:
        disk = json.load(f)
    check(disk["reason"] == pm["reason"]
          and [e["kind"] for e in disk["events"]] == kinds,
          "[telemetry] (c) the postmortem on disk differs")
    check(not any(p["scope"] == "user" and p["key"] == 0 for p in pms),
          "[telemetry] (c) a postmortem for user 0")
    _host_values_only(tm)
    print(f"[telemetry] (c) chaos K 4 (user 1 NaN-poisoned): banks and "
          f"losses of off, on, on, off equal; postmortems "
          f"{[(p['key'], p['reason'][:40]) for p in pms]}; the quarantine's "
          f"ring {len(kinds)} events, failing seqs {sorted(failing)}, "
          f"last_error_seq {last}; collab step p50 ms off "
          f"{[round(x, 2) for x in step_ms[False]]}, on "
          f"{[round(x, 2) for x in step_ms[True]]} (off, on, on, off)",
          flush=True)
    rows = _span_table("(c)", tm, ("session.offload_round", "channel.push",
                                   "channel.fit_round"))
    print(f"[telemetry] (c) offload rounds "
          f"{rows['session.offload_round']['total_ms'] / RUNTIME_STEPS:.2f} "
          f"ms a step, of the on-run's collab step p50 "
          f"{step_ms[True][0]:.2f} ms", flush=True)


def _telemetry_train_loop(cfg, params, dev, d):
    """(d) a TrainLoop over Mode A with telemetry writes telemetry.jsonl.
    Returns the session (its next step is profiled)."""
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.train_loop import TrainLoop
    from repro_torch.telemetry import Telemetry

    tm = Telemetry(out_dir=d)
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1)
    sess = ColaSession(cfg, cc, params, seed=SEED, optimizer=_adamw(),
                       device=dev, telemetry=tm)
    data = SyntheticLM(cfg, batch=32, seq=128, seed=SEED, device=dev)
    TrainLoop(sess, data, f"{d}/loop", telemetry=tm).run(2, resume=False)
    with open(f"{d}/loop/telemetry.jsonl") as f:
        recs = [json.loads(line) for line in f]
    m = recs[-1]["metrics"]
    check(m["train.step_s"]["count"] == 2 and m["channel.u0.version"] == 2,
          f"[telemetry] (d) last telemetry.jsonl record {m}")
    _host_values_only(tm)
    print(f"[telemetry] (d) TrainLoop over Mode A, 2 steps: telemetry.jsonl "
          f"{len(recs)} records, train.step_s count "
          f"{m['train.step_s']['count']}, p50 {m['train.step_s']['p50'] * 1e3:.2f} "
          f"ms, channel.u0.version {m['channel.u0.version']}", flush=True)
    return sess, data.batch_at(2)


def _overhead(cfg, dev, setup) -> None:
    """Decode-tick and prefill p50 with telemetry off and on, in turns, three
    runs each (a reading, not a gate)."""
    from repro_torch.telemetry import Telemetry

    params, banks, prompts = setup
    p50 = {False: {"decode_tick": [], "prefill": []},
           True: {"decode_tick": [], "prefill": []}}
    for on in (False, True) * 3:
        eng, _, _ = serve(cfg, params, banks, prompts, dev, slots=16,
                          max_len=1024, max_new=16,
                          telemetry=Telemetry(trace=True) if on else None)
        tp = eng.throughput()
        for k in p50[on]:
            p50[on][k].append(tp[k]["p50"] * 1e3)
    for k in ("decode_tick", "prefill"):
        off, on = p50[False][k], p50[True][k]
        print(f"[telemetry] overhead {k} p50 ms (32 requests, 16 new tokens; "
              f"off, on in turns): off {[round(x, 2) for x in off]} median "
              f"{statistics.median(off):.2f} spread {max(off) - min(off):.2f}; "
              f"on {[round(x, 2) for x in on]} median "
              f"{statistics.median(on):.2f} spread {max(on) - min(on):.2f}",
              flush=True)


def _annotations(cfg, dev, setup, sess, batch) -> None:
    """``Telemetry(profiler_annotations=True)``: a torch.profiler run of one
    tick and one fit sees ``serve.decode`` and ``offload.fit``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve_loop import Request, ServeEngine
    from repro_torch.telemetry import Telemetry, enable_profiler_annotations

    params, banks, prompts = setup
    try:
        tm = Telemetry(profiler_annotations=True)
        eng = ServeEngine(cfg, params, slots=16, max_len=1024,
                          user_adapters=banks, device=dev, telemetry=tm)
        for i in range(2):
            eng.submit(Request(rid=i, user=i, prompt=prompts[i], max_new=4))
        eng.tick()                       # admission and prefill
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.tick()
            sess.step(batch)             # Mode A: push and fit, this thread
            torch.cuda.synchronize()
    finally:
        enable_profiler_annotations(False)
    names = {e.name for e in prof.events()}
    check({"serve.decode", "offload.fit"} <= names,
          f"[telemetry] profiler annotations missing: "
          f"{sorted(n for n in names if '.' in n and '::' not in n)[:20]}")
    print("[telemetry] torch.profiler sees serve.decode and offload.fit",
          flush=True)


def phase_telemetry(cfg, dev, setup, serve_tokens, scale_tokens) -> dict:
    """Phase 10 at full width; returns the launch counts of the phase."""
    import tempfile

    from repro_torch.models import model

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as d:
        # (a) dense serving, f32 bank
        tm, eng, _ = _telemetry_serving(cfg, dev, setup, serve_tokens, "(a)",
                                        f"{d}/a")
        print("[telemetry] (a) dense serving: tokens equal phase 2's; valid "
              "trace; serve.completed 32, serve.ttft_s count 32; no "
              "postmortem", flush=True)
        _span_table("(a)", tm, ("serve.tick", "serve.admit", "serve.decode",
                                "serve.prefill"))
        # (b) paged + chunked + int8
        tm, eng, snap = _telemetry_serving(cfg, dev, setup, scale_tokens,
                                           "(b)", f"{d}/b", **SCALE)
        pager = {k: snap[f"pager.{k}"] for k in eng.pager.stats}
        check(pager == eng.pager.stats, f"[telemetry] (b) pager.* {pager}")
        eng.pager.assert_empty()
        print(f"[telemetry] (b) paged + chunks of 128 + int8: tokens equal "
              f"phase 6's; pager.* == pager.stats {pager}; pool whole",
              flush=True)
        _span_table("(b)", tm, ("serve.tick", "serve.prefill_chunk",
                                "serve.decode"))
        # (c), (d)
        train_params = model.init(cfg, seed=SEED, device=dev)
        _telemetry_chaos(cfg, train_params, dev, f"{d}/c")
        sess, batch = _telemetry_train_loop(cfg, train_params, dev, f"{d}/d")

        # no sync added: one workload, off and on in turns, under sync debug
        # mode, after a counted warm-up (the first run under the mode made
        # one more call, at torch/cuda/__init__.py, telemetry off)
        from repro_torch.telemetry import Telemetry
        params, banks, prompts = setup

        def workload(on):
            serve(cfg, params, banks, prompts[:8], dev, slots=16,
                  max_len=1024, max_new=8,
                  telemetry=Telemetry(trace=True, out_dir=f"{d}/s")
                  if on else None)

        warm = count_syncs(lambda: workload(False))
        syncs = [count_syncs(lambda: workload(on))
                 for on in (False, True, False, True)]
        totals = [sum(c.values()) for c in syncs]
        check(syncs[0] == syncs[1] == syncs[2] == syncs[3] and totals[0] > 0,
              f"[telemetry] synchronising calls off, on, off, on {totals}: "
              f"off - on {syncs[0] - syncs[1]}, on - off {syncs[1] - syncs[0]}")
        print(f"[telemetry] synchronising calls (8 requests, 8 new tokens, "
              f"sync debug mode; off, on, off, on): {totals} (warm-up "
              f"{sum(warm.values())}, {dict(warm - syncs[0])} more), by line "
              f"{dict(syncs[1])}", flush=True)

        _overhead(cfg, dev, setup)
        _annotations(cfg, dev, setup, sess, batch)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}
    print(f"[telemetry] launches: {launches}; {card_line()}", flush=True)
    for n, c in launches.items():
        check(c > 0, f"kernel {n} was never launched in [telemetry]")
    return launches


# ---------------------------------------------------------------------------
# phases 11-14: gemma2's pairs plan (serving, training) and the other
# registered configs
# ---------------------------------------------------------------------------

GEMMA2_PAGED = dict(kv_layout="paged", kv_block=16, prefill_chunk=128,
                    bank_store="int8")


def _free() -> None:
    """Give the caching allocator's blocks back before the next model."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _gemma2_prompts(cfg, n: int, lo: int, hi: int, seed: int, long=()):
    """``n`` seeded prompts of ``lo``-``hi`` tokens; ``long`` sets the
    lengths of the first few (prompts past the local window)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    lens[:len(long)] = long
    return [rng.integers(0, cfg.vocab_size, int(m)).astype(np.int32)
            for m in lens]


def _counted(fn) -> tuple:
    """Run ``fn`` with every kernel's launch count (the ring decode's too)
    reset just before and read just after; returns (fn's result, counts)."""
    from repro_torch.kernels import decode_attention as da

    ws = dict(wrappers(), decode_attention_ring=da.decode_attention_ring)
    for w in ws.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: w.launches for n, w in ws.items()}


def phase_gemma2(dev) -> dict:
    """gemma2-9b at full width and depth (42 layers, d_model 3584, bf16,
    seeded random weights), 4 users' rank-8 qv adapters, 8 slots, max_len
    6144, 12 requests of 256-4800 tokens (two past the 4096 window, so the
    local window masks and the rings wrap), 16 new tokens each: (a) dense KV
    and an f32 bank, (b) paged KV in blocks of 16, chunks of 128, rings for
    the local stack and an int8 bank. Returns the launch counts of both."""
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.utils import tree_leaves

    cfg = registry.get_config("gemma2-9b")
    params = model.init(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    banks = user_banks(cfg, 4, dev, SEED)
    prompts = _gemma2_prompts(cfg, 12, 256, 4800, SEED, long=(4800, 4400))
    total = {}
    for tag, opts, ran, idle in (
            ("(a) dense KV, f32 bank", {},
             ("flash_attention", "decode_attention", "multi_lora"),
             ("decode_attention_paged", "decode_attention_ring",
              "multi_lora_q8")),
            ("(b) paged KV + rings, chunks of 128, int8 bank", GEMMA2_PAGED,
             ("flash_attention", "decode_attention_paged",
              "decode_attention_ring", "multi_lora_q8"),
             ("decode_attention", "multi_lora"))):
        torch.cuda.reset_peak_memory_stats(dev)
        (eng, reqs, peak_bytes), launches = _counted(lambda: serve(
            cfg, params, banks, prompts, dev, slots=8, max_len=6144,
            max_new=16, **opts))
        check(all(r.status == "done" and len(r.out) == 16 for r in reqs),
              f"[gemma2] {tag}: not every request finished with 16 tokens")
        check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
              f"[gemma2] {tag}: a token outside the vocabulary")
        for n in ran:
            check(launches[n] > 0, f"[gemma2] {tag}: {n} never launched")
        for n in idle:
            check(launches[n] == 0, f"[gemma2] {tag}: {n} ran {launches[n]} "
                  "times")
        cache = {s: tuple(e["k"].shape) for s, e in eng.cache.items()}
        cache_bytes = sum(l.numel() * l.element_size()
                          for e in eng.cache.values() for l in e.values())
        if eng.pager is not None:
            st = eng.stats
            check(st["kv_allocs"] == st["kv_frees"] > 0,
                  f"[gemma2] {tag}: kv allocs {st['kv_allocs']} != frees "
                  f"{st['kv_frees']}")
            eng.pager.assert_empty()
        tp = eng.throughput()
        print(f"[gemma2] {tag}: gemma2-9b bf16, 42 layers, {n_params} "
              f"parameters, 8 slots, 4 users, 12 requests (prompts "
              f"{sorted(len(p) for p in prompts)}): {tp['completed']} "
              f"completed, decode {tp['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{tp['ttft']['p50'] * 1e3:.1f} ms, decode tick p50 "
              f"{tp['decode_tick']['p50'] * 1e3:.2f} ms, prefill calls "
              f"{eng.stats['prefill_calls']}, chunk rounds "
              f"{eng.stats['chunk_rounds']}, prefill call / chunk round p50 "
              f"{tp['prefill']['p50'] * 1e3:.2f} ms; {card_line()}", flush=True)
        print(f"[gemma2] {tag}: cache {cache} = {cache_bytes} bytes, "
              f"kv_cache_bytes at peak {peak_bytes}; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"launches {launches}", flush=True)
        total = {n: total.get(n, 0) + c for n, c in launches.items()}
        del eng, reqs
        _free()
    del params, banks
    _free()
    return total


def _recording_engine():
    """A ServeEngine that keeps every step's next-token logits of the rows
    it ran for (on the host)."""
    from repro_torch.runtime.serve_loop import ServeEngine

    class Recording(ServeEngine):
        def __init__(self, *a, **kw):
            self.logits = []
            super().__init__(*a, **kw)

        def _step_logits(self, tokens, positions, users, live, lens=None):
            out = super()._step_logits(tokens, positions, users, live, lens)
            self.logits.append(out[live].float().cpu())
            return out

    return Recording


def phase_gemma2_vs_plain(dev) -> None:
    """gemma2-9b in f32 at full width with the depth cut to 4 layers (2
    pairs; ~6.8 GB of parameters, the CPU runs every engine too), three
    requests of 200 / 1500 / 4400 tokens (the last past the 4096 window),
    8 new tokens, 2 slots: the card's dense engine against the CPU's, the
    card's paged + chunks of 128 + rings + int8 engine against the CPU's
    same engine, and on the card paged + rings against dense with the same
    chunks and int8 bank (the KV layout alone differs): equal greedy
    tokens; prints the largest next-token logit gap of each."""
    from repro_torch.configs import registry
    from repro_torch.models import model

    cfg = registry.get_config("gemma2-9b").replace(
        n_layers=4, param_dtype="float32", compute_dtype="float32")
    params_cpu = model.init(cfg, seed=SEED + 1, device="cpu")
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (200, 1500, 4400)]
    banks_cpu = user_banks(cfg, 2, "cpu", SEED + 1)
    banks_gpu = [_to(b, dev) for b in banks_cpu]
    kw = dict(slots=2, max_len=4608, max_new=8, engine=_recording_engine())
    runs = {"card dense": (params_gpu, banks_gpu, dev, {}),
            "cpu dense": (params_cpu, banks_cpu, "cpu", {}),
            "card paged": (params_gpu, banks_gpu, dev, GEMMA2_PAGED),
            "cpu paged": (params_cpu, banks_cpu, "cpu", GEMMA2_PAGED),
            "card dense, chunks of 128, int8": (
                params_gpu, banks_gpu, dev,
                dict(prefill_chunk=128, bank_store="int8"))}
    out = {}
    for name, (params, banks, device, opts) in runs.items():
        t0 = time.perf_counter()
        eng, reqs, _ = serve(cfg, params, banks, prompts, device, **kw, **opts)
        check(all(r.status == "done" and len(r.out) == 8 for r in reqs),
              f"[gemma2-vs-plain] {name}: not every request finished")
        if eng.pager is not None:
            eng.pager.assert_empty()
        out[name] = ([r.out for r in reqs], eng.logits)
        print(f"[gemma2-vs-plain] {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        del eng
    for a, b in (("card dense", "cpu dense"), ("card paged", "cpu paged"),
                 ("card paged", "card dense, chunks of 128, int8")):
        (toks, lg), (toks_o, lg_o) = out[a], out[b]
        steps = min(len(lg), len(lg_o))
        gap = (max(float((x - y).abs().max()) for x, y in zip(lg, lg_o))
               if len(lg) == len(lg_o) else None)
        top = max(float(x.abs().max()) for x in lg[:steps])
        print(f"[gemma2-vs-plain] f32, 4 layers at full width: {a} vs {b}: "
              f"tokens equal {toks == toks_o}; largest next-token logit gap "
              f"{gap if gap is None else f'{gap:.3e}'} (max |logit| {top:.3f})"
              f" over {len(lg)} / {len(lg_o)} steps", flush=True)
        check(toks == toks_o, f"[gemma2-vs-plain] greedy tokens differ, {a} "
              f"vs {b}: {toks} vs {toks_o}")
    del params_gpu, banks_gpu
    _free()


GEMMA2_TRAIN_STEPS = 4


def _tap_stats(sess) -> list:
    """Wrap the session's channel push so that every pushed payload leaves,
    per tap, device flags (x finite, grad_h finite, grad_h non-zero), read
    after the steps: no sync inside a step."""
    flags = []
    push = sess.channel.push

    def pushed(data):
        flags.append({t: torch.stack([x.isfinite().all(), g.isfinite().all(),
                                      (g != 0).any()])
                      for t, (x, g) in data.items()})
        return push(data)

    sess.channel.push = pushed
    return flags


def _gemma2_train_full(dev) -> dict:
    """(a): gemma2-9b at full width and depth, bf16, remat "full", Mode A
    merged rank-8 qv, interval 1, AdamW, 1 x 4608, a warm-up step then the
    measured steps, each with its fit (``_measured_steps``); every step's
    taps checked (``_tap_stats``). Returns the launch counts."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.profile_train import SETUPS

    cfg = registry.get_config("gemma2-9b")
    batch, seq, interval = SETUPS[cfg.name]   # 1 x 4608: past the 4096 window
    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16"
          and cfg.loss_chunk == 512, f"gemma2 training config {cfg.remat}/"
          f"{cfg.param_dtype}/{cfg.loss_chunk}")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=interval)
    sess = ColaSession(cfg, cc, model.init(cfg, seed=SEED, device=dev),
                       seed=SEED, device=dev, optimizer=_adamw())
    taps = sorted(sess.adapters)
    check(taps == ["layers_a.attn.q", "layers_a.attn.v", "layers_b.attn.q",
                   "layers_b.attn.v"], f"[gemma2-train] taps {taps}")
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=SEED, device=dev)
    flags = _tap_stats(sess)
    m = _measured_steps(sess, [data.batch_at(i) for i in
                               range(GEMMA2_TRAIN_STEPS + 1)], dev)
    losses, step_ms, fit_ms = m["losses"], m["step_ms"], m["fit_ms"]
    launches = m["launches"]

    n = GEMMA2_TRAIN_STEPS
    check(all(np.isfinite(losses)), f"[gemma2-train] non-finite loss: {losses}")
    check(len(fit_ms) == n, f"[gemma2-train] {len(fit_ms)} fits in {n} steps")
    bad = [(i, t) for i, f in enumerate(flags) for t, v in f.items()
           if not bool(v.all())]
    check(len(flags) == n + 1 and not bad, f"[gemma2-train] a tap's x or "
          f"grad_h not finite, or grad_h all zero (step, tap): {bad}")
    health = sess.channel_health()[0]
    check(health["fits_committed"] == n + 1 and all(
        health[k] == 0 for k in ("rollbacks", "dead_letters", "send_retries")),
        f"[gemma2-train] offload rounds failed: {health}")
    # a step: 42 forwards and their 42 recomputes, 42 of each backward
    # kernel; a fit: one cola_fit launch per tap of each stack
    want = {"flash_attention": 84 * n, "flash_attention_bwd_dq": 42 * n,
            "flash_attention_bwd_dkv": 42 * n, "cola_fit": 4 * n}
    check(all(launches[k] == v for k, v in want.items()),
          f"[gemma2-train] launches {launches}, want {want}")
    tokens = n * batch * seq
    print(f"[gemma2-train] (a) gemma2-9b bf16, 42 layers, remat full, Mode A "
          f"merged rank-8 qv on both stacks, interval {interval}, AdamW, batch "
          f"{batch} x {seq}: losses {[round(x, 5) for x in losses]}; every "
          f"tap's x and grad_h finite, grad_h non-zero; the bank moved at "
          f"every fit", flush=True)
    print(f"[gemma2-train] (a) step ms {[round(t, 1) for t in step_ms]}; server "
          f"step p50 {statistics.median(m['server_ms']):.1f} ms; fit ms "
          f"{[round(t, 2) for t in fit_ms]} (p50 {statistics.median(fit_ms):.2f})"
          f"; {checks_line(m['check_ms'], n)}; "
          f"{tokens / (sum(step_ms) / 1e3):.1f} training tokens/s; peak memory "
          f"{m['peak'] / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); {card_line()}", flush=True)
    print(f"[gemma2-train] (a) launches in {n} steps: {launches}", flush=True)
    del sess
    _free()
    return launches


def _session_step(cfg, cc, params, batch, device, tag) -> dict:
    """One step of a merged ``ColaSession`` on ``device`` (the merged server
    step, the push through the channel, the fit and AdamW) from ``params``
    and a bank whose B is drawn != 0 the same way on every device (so dA
    carries information). Returns the session, the bank before and after,
    the loss, each tap's grad_h, the fit gradients (``gl.fit_grads`` on the
    pushed payload and the bank before, as the offloader's fit computes
    them) and the seconds the step took."""
    from repro_torch.core import gl
    from repro_torch.core.session import ColaSession

    sess = ColaSession(cfg, cc, params, seed=SEED + 2, device=device,
                       optimizer=_adamw())
    gen = torch.Generator().manual_seed(SEED + 2)
    for tap in sorted(sess.adapters):
        B = torch.randn(sess.adapters[tap]["B"].shape, generator=gen) * 0.02
        # in place: the offloader and its channel hold these tensors too
        sess.adapters[tap]["B"].copy_(B)
        sess.offloader.adapters[tap]["B"].copy_(B)
    bank0 = {t: {k: v.clone() for k, v in w.items()}
             for t, w in sess.adapters.items()}
    pushed = []
    push = sess.channel.push
    sess.channel.push = lambda data: (pushed.append(data), push(data))[1]
    t0 = time.perf_counter()
    loss = sess.step(_to(batch, device))
    secs = time.perf_counter() - t0
    check(sess.offloader.stats["fits"] == 1
          and sess.channel_health()[0]["fits_committed"] == 1,
          f"{tag} on {device}: the fit did not commit")
    (data,) = pushed
    grads = gl.fit_grads(sess.offloader.spec, bank0, data)
    return dict(sess=sess, bank0=bank0, loss=loss, secs=secs,
                grad_h={t: g.cpu() for t, (_, g) in data.items()},
                fit=_to(grads, "cpu"), bank=_to(sess.adapters, "cpu"))


def _gemma2_train_vs_plain(dev) -> None:
    """(b): gemma2-9b in f32 at full width, depth cut to 4 layers (2 pairs),
    at (a)'s batch shape: one step of a merged rank-8 qv ``ColaSession``
    (``_session_step``) on the card and on the CPU (plain versions):
    the losses within 1e-5; each tap's grad_h and fit gradients within
    phase 5's 1e-3 of the largest entry; the bank after the fit and AdamW
    within 1e-3 of its largest entry wherever the CPU's gradient is larger
    than the card-vs-CPU gap of that gradient (so both devices see its
    sign), and within AdamW's step, 2 lr, elsewhere (its first step is
    lr g / (|g| + eps), the sign of a gradient the two devices do not
    resolve there). Then on the card the unmerged Mode A server step: its
    loss and fit gradients against the CPU's merged ones, and its fit
    gradients against Mode B's adapter gradients (Prop 1) at
    test_gl_equivalence.py's tolerance."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig, TrainConfig
    from repro_torch.core import gl
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.profile_train import SETUPS

    batch_size, seq, _ = SETUPS["gemma2-9b"]
    cfg = registry.get_config("gemma2-9b").replace(
        n_layers=4, param_dtype="float32", compute_dtype="float32")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1)
    params = model.init(cfg, seed=SEED + 2, device="cpu")
    batch = SyntheticLM(cfg, batch=batch_size, seq=seq, seed=SEED + 2,
                        device="cpu").batch_at(0)
    cpu = _session_step(cfg, cc, params, batch, "cpu", "[gemma2-train] (b)")
    del cpu["sess"]
    gpu = _session_step(cfg, cc, params, batch, dev, "[gemma2-train] (b)")
    loss_diff = abs(gpu["loss"] - cpu["loss"])
    check(loss_diff <= 1e-5 * abs(cpu["loss"]),
          f"[gemma2-train] loss card {gpu['loss']} vs CPU {cpu['loss']}")
    worst = {"grad_h": 0.0, "fit": 0.0, "bank": 0.0}
    gaps = {}
    for tap in sorted(cpu["grad_h"]):
        pairs = [("grad_h", f"{tap} grad_h", gpu["grad_h"][tap],
                  cpu["grad_h"][tap])]
        pairs += [("fit", f"{tap}.{leaf}", gpu["fit"][tap][leaf], a)
                  for leaf, a in cpu["fit"][tap].items()]
        for kind, what, got, want in pairs:
            err, scale = max_err(got, want)
            check(scale > 0 and err <= 1e-3 * scale, f"[gemma2-train] {what}: "
                  f"card vs CPU max |diff| {err:.3g} > 1e-3 x {scale:.3g}")
            worst[kind] = max(worst[kind], err / scale)
            gaps[what] = err
    lr = TrainConfig().lr
    unresolved = total = 0
    for tap, w in cpu["bank"].items():
        for leaf, want in w.items():
            got = gpu["bank"][tap][leaf]
            check(bool((got != gpu["bank0"][tap][leaf].cpu()).any()),
                  f"[gemma2-train] the card's fit left {tap}.{leaf} as it was")
            sure = cpu["fit"][tap][leaf].abs() > gaps[f"{tap}.{leaf}"]
            diff = (got - want).abs()
            scale = float(want.abs().max())
            err = float(diff[sure].max())
            rest = float(diff[~sure].max()) if bool((~sure).any()) else 0.0
            check(err <= 1e-3 * scale and rest <= 2 * lr * (1 + 1e-3),
                  f"[gemma2-train] bank {tap}.{leaf} after AdamW: card vs CPU "
                  f"max |diff| {err:.3g} (tol 1e-3 x {scale:.3g}) where the "
                  f"gradient's sign is resolved, {rest:.3g} (tol 2 lr) "
                  f"elsewhere")
            worst["bank"] = max(worst["bank"], err / scale)
            unresolved += int((~sure).sum())
            total += sure.numel()

    # the unmerged server step on the card, and Mode B (Prop 1)
    sess = gpu.pop("sess")
    bank0, b = gpu["bank0"], _to(batch, dev)
    spec_a = gl.make_spec(cfg, ColaConfig(mode="faithful_offload",
                                          family="lowrank", taps="qv", rank=8))
    loss_a, data, _ = gl.server_step_a(cfg, spec_a, sess.base_params, bank0,
                                       b)
    g_a = gl.fit_grads(sess.offloader.spec, bank0, data)
    del data
    check(abs(float(loss_a) - cpu["loss"]) <= 1e-5 * abs(cpu["loss"]),
          f"[gemma2-train] unmerged loss card {float(loss_a)} vs merged CPU "
          f"{cpu['loss']}")
    unmerged = 0.0
    for tap, w in cpu["fit"].items():
        for leaf, want in w.items():
            err, scale = max_err(g_a[tap][leaf].cpu(), want)
            check(err <= 1e-3 * scale, f"[gemma2-train] unmerged fit grad "
                  f"{tap}.{leaf}: card vs the CPU's merged step max |diff| "
                  f"{err:.3g} > 1e-3 x {scale:.3g}")
            unmerged = max(unmerged, err / scale)
    spec_b = gl.make_spec(cfg, ColaConfig(mode="fused_fit", family="lowrank",
                                          taps="qv", rank=8))
    loss_b, g_b, _ = gl.train_step_b(cfg, spec_b, sess.base_params, bank0, b)
    prop1 = 0.0   # max |A - B| / (atol + rtol |B|): allclose when <= 1
    for tap, w in g_b.items():
        for leaf, gb in w.items():
            ga = g_a[tap][leaf]
            ratio = float(((ga - gb).abs() / (1e-6 + 2e-4 * gb.abs())).max())
            prop1 = max(prop1, ratio)
            check(ratio <= 1, f"[gemma2-train] Prop 1 on the card: {tap}.{leaf}"
                  f" Mode A vs Mode B beyond rtol 2e-4, atol 1e-6 ({ratio:.3g} x)")
    check(abs(float(loss_b) - float(loss_a)) <= 1e-6 * abs(float(loss_a)),
          f"[gemma2-train] Mode B loss {float(loss_b)} vs Mode A "
          f"{float(loss_a)}")
    print(f"[gemma2-train] (b) f32, 4 layers at full width, {batch_size} x "
          f"{seq}, merged session step: loss card {gpu['loss']:.7f} CPU "
          f"{cpu['loss']:.7f} (|diff| {loss_diff:.3e}); max |card - CPU| / "
          f"max |CPU| over the 4 taps: grad_h {worst['grad_h']:.3e}, fit "
          f"grads {worst['fit']:.3e} (tol 1e-3), the bank after AdamW "
          f"{worst['bank']:.3e} (tol 1e-3; {unresolved} of {total} entries "
          f"where the devices do not resolve the gradient's sign, within 2 "
          f"lr); unmerged on the card: loss {float(loss_a):.7f}, fit grads "
          f"{unmerged:.3e} of the CPU's merged; Prop 1 on the card: max "
          f"|A - B| / (1e-6 + 2e-4 |B|) = {prop1:.3f} (<= 1); session step "
          f"{cpu['secs']:.1f} s on the CPU, {gpu['secs']:.2f} s on the card",
          flush=True)
    del sess, gpu, g_a, g_b
    _free()


def phase_gemma2_train(dev) -> dict:
    """gemma2-9b's ColA training on the card: (a) full width and depth, (b)
    against the plain path and Mode B at 4 layers. Returns (a)'s launch
    counts."""
    launches = _gemma2_train_full(dev)
    _gemma2_train_vs_plain(dev)
    return launches


def phase_configs(dev) -> dict:
    """Short ServeEngine runs of the other registered configs (8 requests
    of 32-512 tokens, 16 new tokens, 8 slots, 4 users' rank-8 qv adapters):
    gpt2-small at full size in f32 (its config's dtype: the f32 kernels),
    its card tokens equal to the CPU's; mistral-nemo-12b at full width and
    depth, bf16; mistral-large-123b at full width with its depth cut to 2
    layers, bf16 (the 88 layers do not fit one 80 GB card). Returns the
    launch counts of the card runs."""
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.utils import tree_leaves

    total = {}
    for name, depth in (("gpt2-small", None), ("mistral-nemo-12b", None),
                        ("mistral-large-123b", 2)):
        cfg = registry.get_config(name)
        if depth:
            cfg = cfg.replace(n_layers=depth)
        params = model.init(cfg, seed=SEED, device=dev)
        n_params = sum(t.numel() for t in tree_leaves(params))
        banks = user_banks(cfg, 4, dev, SEED)
        rng = np.random.default_rng(SEED + 2)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in rng.integers(32, 513, 8)]
        (eng, reqs, _), launches = _counted(lambda: serve(
            cfg, params, banks, prompts, dev, slots=8, max_len=1024,
            max_new=16))
        check(all(r.status == "done" and len(r.out) == 16 for r in reqs),
              f"[configs] {name}: not every request finished")
        for n in ("flash_attention", "decode_attention", "multi_lora"):
            check(launches[n] > 0, f"[configs] {name}: {n} never launched")
        tp = eng.throughput()
        same = ""
        if name == "gpt2-small":
            cpu, cpu_reqs, _ = serve(cfg, _to(params, "cpu"),
                                     [_to(b, "cpu") for b in banks], prompts,
                                     "cpu", slots=8, max_len=1024, max_new=16)
            same = [r.out for r in reqs] == [r.out for r in cpu_reqs]
            check(same, f"[configs] {name}: card tokens differ from the CPU's")
            same = "; card tokens == CPU tokens: True"
        print(f"[configs] {name} {cfg.param_dtype}, {cfg.n_layers} layers, "
              f"{n_params} parameters: {tp['completed']} completed, decode "
              f"{tp['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{tp['ttft']['p50'] * 1e3:.1f} ms, decode tick p50 "
              f"{tp['decode_tick']['p50'] * 1e3:.2f} ms{same}; launches "
              f"{launches}", flush=True)
        total = {n: total.get(n, 0) + c for n, c in launches.items()}
        del eng, reqs, params, banks
        _free()
    return total


# ---------------------------------------------------------------------------
# phases 15 and 16: the MoE blocks and QK-norm (qwen3-moe-30b-a3b, dbrx-132b)
# ---------------------------------------------------------------------------

MOE_TRAIN_STEPS = 2
# (label, options, kernels that must run, kernels that must not)
MOE_RUNS = (("dense KV, f32 bank", {},
             ("flash_attention", "decode_attention", "multi_lora"),
             ("decode_attention_paged", "decode_attention_ring",
              "multi_lora_q8")),
            ("paged KV, chunks of 128, int8 bank", SCALE,
             ("flash_attention", "decode_attention_paged", "multi_lora_q8"),
             ("decode_attention", "decode_attention_ring", "multi_lora")))


def _moe_serve(cfg, params, dev, tag, runs) -> dict:
    """phase 14's load on a MoE config: 4 users' rank-8 qv adapters, 8
    slots, max_len 1024, 8 requests of 32-512 tokens (one prefill of 8 x
    512: eight 512-token routing groups), 16 new tokens each, once per
    entry of ``runs`` with the launch counts reset just before and read
    just after. Returns the launch counts of all runs."""
    from repro_torch.utils import tree_leaves

    n_params = sum(t.numel() for t in tree_leaves(params))
    banks = user_banks(cfg, 4, dev, SEED)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(32, 513, 8)]
    total = {}
    for label, opts, ran, idle in runs:
        torch.cuda.reset_peak_memory_stats(dev)
        (eng, reqs, _), launches = _counted(lambda: serve(
            cfg, params, banks, prompts, dev, slots=8, max_len=1024,
            max_new=16, **opts))
        check(all(r.status == "done" and len(r.out) == 16 for r in reqs),
              f"{tag} {label}: not every request finished with 16 tokens")
        check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
              f"{tag} {label}: a token outside the vocabulary")
        for n in ran:
            check(launches[n] > 0, f"{tag} {label}: {n} never launched")
        for n in idle:
            check(launches[n] == 0, f"{tag} {label}: {n} ran {launches[n]} "
                  "times")
        if eng.pager is not None:
            eng.pager.assert_empty()
        tp = eng.throughput()
        print(f"{tag} {cfg.name} {cfg.param_dtype}, {cfg.n_layers} layers, "
              f"{n_params} parameters, {label}: {tp['completed']} completed, "
              f"decode {tp['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{tp['ttft']['p50'] * 1e3:.1f} ms, decode tick p50 "
              f"{tp['decode_tick']['p50'] * 1e3:.2f} ms, prefill calls "
              f"{eng.stats['prefill_calls']}, chunk rounds "
              f"{eng.stats['chunk_rounds']}, prefill call / chunk round p50 "
              f"{tp['prefill']['p50'] * 1e3:.2f} ms; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"{card_line()}", flush=True)
        print(f"{tag} {label}: launches {launches}", flush=True)
        total = {n: total.get(n, 0) + c for n, c in launches.items()}
        del eng, reqs
        _free()
    return total


def _moe_train(cfg, params, dev) -> dict:
    """(b): a ColA warm-up step and MOE_TRAIN_STEPS measured steps on
    qwen3-moe at full width and depth (bf16, remat "full"), Mode A merged
    rank-8 qv, interval 1, AdamW, SyntheticLM 1 x 2048, each step with its
    fit (``_measured_steps``); every step's taps checked (``_tap_stats``).
    Returns the launch counts."""
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.profile_train import SETUPS

    batch, seq, interval = SETUPS[cfg.name]
    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16",
          f"[moe] training config {cfg.remat}/{cfg.param_dtype}")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=interval)
    sess = ColaSession(cfg, cc, params, seed=SEED, device=dev,
                       optimizer=_adamw())
    check(sorted(sess.adapters) == ["layers.attn.q", "layers.attn.v"],
          f"[moe] (b) taps {sorted(sess.adapters)}")
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=SEED, device=dev)
    flags = _tap_stats(sess)
    m = _measured_steps(sess, [data.batch_at(i) for i in
                               range(MOE_TRAIN_STEPS + 1)], dev)
    losses, step_ms, fit_ms = m["losses"], m["step_ms"], m["fit_ms"]
    launches, n = m["launches"], MOE_TRAIN_STEPS
    check(all(np.isfinite(losses)), f"[moe] (b) non-finite loss: {losses}")
    check(len(fit_ms) == n, f"[moe] (b) {len(fit_ms)} fits in {n} steps")
    bad = [(i, t) for i, f in enumerate(flags) for t, v in f.items()
           if not bool(v.all())]
    check(len(flags) == n + 1 and not bad, f"[moe] (b) a tap's x or grad_h "
          f"not finite, or grad_h all zero (step, tap): {bad}")
    health = sess.channel_health()[0]
    check(health["fits_committed"] == n + 1 and all(
        health[k] == 0 for k in ("rollbacks", "dead_letters", "send_retries")),
        f"[moe] (b) offload rounds failed: {health}")
    # a step: 48 forwards and their 48 recomputes, 48 of each backward
    # kernel; a fit: one cola_fit launch a tap
    L = cfg.n_layers
    want = {"flash_attention": 2 * L * n, "flash_attention_bwd_dq": L * n,
            "flash_attention_bwd_dkv": L * n, "cola_fit": 2 * n}
    check(all(launches[k] == v for k, v in want.items()),
          f"[moe] (b) launches {launches}, want {want}")
    tokens = n * batch * seq
    print(f"[moe] (b) {cfg.name} bf16, {L} layers, remat full, Mode A merged "
          f"rank-8 qv, interval {interval}, AdamW, batch {batch} x {seq}: "
          f"losses (CE + {cfg.aux_loss_coef} x the MoE aux) "
          f"{[round(x, 5) for x in losses]}; every tap's x and grad_h finite, "
          f"grad_h non-zero; the bank moved at every fit", flush=True)
    print(f"[moe] (b) step ms {[round(t, 1) for t in step_ms]} (p50 "
          f"{statistics.median(step_ms):.1f}); server step p50 "
          f"{statistics.median(m['server_ms']):.1f} ms; fit ms "
          f"{[round(t, 2) for t in fit_ms]} (p50 {statistics.median(fit_ms):.2f})"
          f"; {checks_line(m['check_ms'], n)}; "
          f"{tokens / (sum(step_ms) / 1e3):.1f} training tokens/s; peak memory "
          f"{m['peak'] / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"{card_line()}", flush=True)
    print(f"[moe] (b) launches in {n} steps: {launches}", flush=True)
    del sess
    _free()
    return launches


def phase_moe(dev) -> dict:
    """qwen3-moe-30b-a3b at full width and depth (48 layers, 128 experts
    top 8, QK-norm, bf16, seeded random weights; init drawn a layer of
    experts at a time, its peak memory printed): (a) phase 14's serving load
    with dense KV and an f32 bank, then paged KV, chunks of 128 and an int8
    bank; (b) ColA training (``_moe_train``); then (c) dbrx-132b at full
    width with the depth cut to 4 layers, served as in phase 14 (dense KV,
    f32 bank). Returns the launch counts of all runs."""
    from repro_torch.configs import registry
    from repro_torch.models import model

    cfg = registry.get_config("qwen3-moe-30b-a3b")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"[moe] qwen3-moe-30b-a3b init at full depth in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB of parameters, "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); {card_line()}", flush=True)
    total = _moe_serve(cfg, params, dev, "[moe] (a)", MOE_RUNS)
    train = _moe_train(cfg, params, dev)
    del params
    _free()

    cfg = registry.get_config("dbrx-132b").replace(n_layers=4)
    params = model.init(cfg, seed=SEED, device=dev)
    dbrx = _moe_serve(cfg, params, dev, "[moe] (c)", MOE_RUNS[:1])
    del params
    _free()
    return {n: total[n] + train.get(n, 0) + dbrx[n] for n in total}


def _routing_recorder():
    """Wrap ``moe._route`` so that every call also keeps, on the host, its
    expert ids and the router's k + 1 largest probabilities (one sync a
    call: for the comparison runs only). Returns (the records, a function
    that restores ``_route``)."""
    from repro_torch.models import moe

    inner = moe._route
    records = []

    def route(params, x, top_k):
        w, idx, aux = inner(params, x, top_k)
        probs = torch.softmax(x.float() @ params["router"]["w"].float(), -1)
        top = torch.topk(probs, top_k + 1, dim=-1).values
        records.append((idx.reshape(-1, top_k).cpu(),
                        top.reshape(-1, top_k + 1).cpu()))
        return w, idx, aux

    moe._route = route
    return records, lambda: setattr(moe, "_route", inner)


def _routing_gaps(card, cpu) -> str:
    """How many tokens' routing decisions (their top-k experts, in order)
    differ between the card's calls and the CPU's, and the smallest CPU
    top-k margin (gap between neighbours among the k + 1 largest
    probabilities) among them and among all."""
    check(len(card) == len(cpu), f"[moe-vs-plain] {len(card)} routing calls "
          f"on the card, {len(cpu)} on the CPU")
    n = differ = 0
    least_all = least_differ = float("inf")
    for (ia, _), (ib, pb) in zip(card, cpu):
        check(ia.shape == ib.shape, "[moe-vs-plain] routing call shapes differ")
        margin = (pb[:, :-1] - pb[:, 1:]).min(dim=-1).values
        bad = (ia != ib).any(dim=-1)
        n += ia.shape[0]
        differ += int(bad.sum())
        least_all = min(least_all, float(margin.min()))
        if bool(bad.any()):
            least_differ = min(least_differ, float(margin[bad].min()))
    among = f"among them {least_differ:.3e}; " if differ else ""
    return (f"{differ} of {n} routing decisions differ (smallest CPU top-k "
            f"margin {among}among all {least_all:.3e})")


def phase_moe_vs_plain(dev) -> None:
    """qwen3-moe-30b-a3b in f32 at full width, depth cut to 2 layers (~6.2
    GB a device), at the config's capacity factor 1.25, against the CPU's
    plain path: (a) the dense engine and the paged + chunks of 128 + int8
    engine, 4 slots, 6 requests of 400 / 96 / 120 / 64 / 200 / 50 tokens, 8
    new tokens (the first prefill routes its 4 x 512 tokens in 512-token
    groups, the second its 2 x 256 in one group across both rows, and
    every chunk round 4 x 128 in one group): equal greedy tokens, and the
    routing decisions that differ between the devices with the smallest CPU
    top-k margin among them (reported, never hidden); (b) one merged
    rank-8 qv session step (server step, fit, AdamW) at 1 x 1024, card
    against CPU: losses within 1e-5, each tap's grad_h and fit gradients
    within 1e-3 of the largest entry (as phase 13 (b))."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model

    cfg = registry.get_config("qwen3-moe-30b-a3b").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    params_cpu = model.init(cfg, seed=SEED + 1, device="cpu")
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (400, 96, 120, 64, 200, 50)]
    banks_cpu = user_banks(cfg, 2, "cpu", SEED + 1)
    banks_gpu = [_to(b, dev) for b in banks_cpu]
    kw = dict(slots=4, max_len=1024, max_new=8, engine=_recording_engine())
    for label, opts in (("dense", {}), ("paged, chunks of 128, int8", SCALE)):
        out = {}
        for where, params, banks, device in (
                ("card", params_gpu, banks_gpu, dev),
                ("cpu", params_cpu, banks_cpu, "cpu")):
            records, restore = _routing_recorder()
            t0 = time.perf_counter()
            try:
                eng, reqs, _ = serve(cfg, params, banks, prompts, device, **kw,
                                     **opts)
            finally:
                restore()
            check(all(r.status == "done" and len(r.out) == 8 for r in reqs),
                  f"[moe-vs-plain] {label} on the {where}: not every request "
                  "finished")
            if eng.pager is not None:
                eng.pager.assert_empty()
            out[where] = ([r.out for r in reqs], eng.logits, records,
                          dict(eng.stats), time.perf_counter() - t0)
            del eng
        (toks, lg, rec, st, secs), (toks_c, lg_c, rec_c, _, secs_c) = \
            out["card"], out["cpu"]
        gap = (max(float((x - y).abs().max()) for x, y in zip(lg, lg_c))
               if len(lg) == len(lg_c) else None)
        print(f"[moe-vs-plain] f32, 2 layers at full width, {label}: prefill "
              f"calls {st['prefill_calls']}, chunk rounds {st['chunk_rounds']}"
              f"; tokens card == CPU: {toks == toks_c}; largest next-token "
              f"logit gap {gap if gap is None else f'{gap:.3e}'} (max |logit| "
              f"{max(float(x.abs().max()) for x in lg_c):.3f}); "
              f"{_routing_gaps(rec, rec_c)}; {secs:.1f} s on the card, "
              f"{secs_c:.1f} s on the CPU", flush=True)
        check(toks == toks_c, f"[moe-vs-plain] {label}: greedy tokens differ, "
              f"card {toks} vs CPU {toks_c}")
    del banks_gpu
    _free()

    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1)
    batch = SyntheticLM(cfg, batch=1, seq=1024, seed=SEED + 2,
                        device="cpu").batch_at(0)
    tag = "[moe-vs-plain] (b)"
    cpu = _session_step(cfg, cc, params_cpu, batch, "cpu", tag)
    del cpu["sess"]
    gpu = _session_step(cfg, cc, params_gpu, batch, dev, tag)
    del gpu["sess"]
    loss_diff = abs(gpu["loss"] - cpu["loss"])
    check(loss_diff <= 1e-5 * abs(cpu["loss"]),
          f"{tag} loss card {gpu['loss']} vs CPU {cpu['loss']}")
    worst = {"grad_h": 0.0, "fit": 0.0}
    for t in sorted(cpu["grad_h"]):
        pairs = [("grad_h", f"{t} grad_h", gpu["grad_h"][t], cpu["grad_h"][t])]
        pairs += [("fit", f"{t}.{leaf}", gpu["fit"][t][leaf], a)
                  for leaf, a in cpu["fit"][t].items()]
        for kind, what, got, want in pairs:
            err, scale = max_err(got, want)
            check(scale > 0 and err <= 1e-3 * scale, f"{tag} {what}: card vs "
                  f"CPU max |diff| {err:.3g} > 1e-3 x {scale:.3g}")
            worst[kind] = max(worst[kind], err / scale)
    bank = max(max_err(gpu["bank"][t][leaf], w)[0] / max_err(w, w)[1]
               for t, e in cpu["bank"].items() for leaf, w in e.items())
    print(f"{tag} f32, 2 layers at full width, merged session step at 1 x "
          f"1024: loss card {gpu['loss']:.7f} CPU {cpu['loss']:.7f} (|diff| "
          f"{loss_diff:.3e}); max |card - CPU| / max |CPU| over both taps: "
          f"grad_h {worst['grad_h']:.3e}, fit grads {worst['fit']:.3e} (tol "
          f"1e-3); the bank after AdamW {bank:.3e} (not held to a bound); "
          f"session step {cpu['secs']:.1f} s on the CPU, {gpu['secs']:.2f} s "
          f"on the card", flush=True)
    del params_gpu, gpu
    _free()


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
    # registers and spills of every instantiation: the tensor-core kernels
    # at every head dim, the decode kernel per dtype too, cola_fit's by rank
    # block, columns a thread and rows a tile, multi-LoRA's by x dtype, bank
    # (0 f32, 1 int8) and rank; at the path's shapes (bf16 d_head 64; the
    # fit's rank 8, 3 columns a thread; multi-LoRA's rank 8) they must not
    # spill
    # (and d_head 256's own tilings: flash_fwd_tc_kernel<256>,
    # flash_fwd_f32_kernel<256>, decode_split_kernel<*,256> and its ring
    # mode <*,*,ring>, printed beside the others)
    for name, kernel, n, paths in (
            ("flash_attention", "flash_fwd_tc_kernel", 5, ("64",)),
            ("flash_attention", "flash_fwd_f32_kernel", 5, ()),
            ("flash_attention_bwd", "flash_bwd_dq_tc_kernel", 5, ("64", "256")),
            ("flash_attention_bwd", "flash_bwd_dkv_tc_kernel", 5,
             ("64", "256")),
            ("flash_attention_bwd", "flash_bwd_dq_f32_kernel", 5, ("256",)),
            ("flash_attention_bwd", "flash_bwd_dkv_f32_kernel", 5, ("256",)),
            ("decode_attention", "decode_split_kernel", 20, ("bf16,64",)),
            ("cola_fit", "fit_reg_kernel", 4, ("8,3,8",)),
            ("cola_fit", "fit_smem_kernel", 1, ("8",)),
            ("multi_lora", "multi_lora_vec_kernel", 12,
             ("bf16,0,8", "bf16,1,8", "f32,0,8", "f32,1,8")),
            ("multi_lora", "multi_lora_any_kernel", 4, ())):
        report = ptxas_report(name, kernel)
        check(len(report) == n, f"no ptxas report of {kernel}: {report}")
        for line in report:
            print(f"[build] {line}", flush=True)
        for path in paths:
            at = [x for x in report if x.startswith(f"{kernel}<{path}>:")]
            check(len(at) == 1 and "0 bytes spill stores" in at[0]
                  and "0 bytes spill loads" in at[0],
                  f"{kernel} spills at the path's <{path}>: {at}")

    cfg = registry.get_config("smollm-135m")
    t0 = time.perf_counter()
    rows = phase_kernels(cfg, dev)
    print(f"[kernels] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    setup = serving_setup(cfg, dev)
    launches, serve_tokens = phase_serving(cfg, dev, setup)
    print(f"[serve] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_engine_vs_plain(cfg, dev)
    print(f"[engine-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    train = phase_training(cfg, dev)
    print(f"[train] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_training_vs_plain(cfg, dev)
    print(f"[train-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    scale, scale_tokens = phase_serving_at_scale(cfg, dev, setup)
    print(f"[scale] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_scale_vs_plain(cfg, dev)
    print(f"[scale-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    store = phase_store(cfg, dev, setup)
    print(f"[store] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runtime = phase_runtime(cfg, dev)
    print(f"[runtime] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tele = phase_telemetry(cfg, dev, setup, serve_tokens, scale_tokens)
    del setup
    print(f"[telemetry] done in {time.perf_counter() - t0:.1f} s", flush=True)
    _free()
    t0 = time.perf_counter()
    gemma2 = phase_gemma2(dev)
    print(f"[gemma2] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_gemma2_vs_plain(dev)
    print(f"[gemma2-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    gemma2_train = phase_gemma2_train(dev)
    print(f"[gemma2-train] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    configs = phase_configs(dev)
    print(f"[configs] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    moe = phase_moe(dev)
    print(f"[moe] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_moe_vs_plain(dev)
    print(f"[moe-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    replaces = {
        "flash_attention": "src/repro/kernels/flash_attention.py:61",
        "flash_attention_bwd_dq": "src/repro/kernels/flash_attention.py:152",
        "flash_attention_bwd_dkv": "src/repro/kernels/flash_attention.py:200",
        "cola_fit": "src/repro/kernels/cola_fit.py:40",
        "decode_attention": "src/repro/kernels/decode_attention.py:62",
        "decode_attention_paged": "src/repro/kernels/decode_attention.py:157",
        "multi_lora": "src/repro/kernels/multi_lora.py:64",
        "multi_lora_q8": "src/repro/kernels/multi_lora.py:176",
    }
    sources = {"flash_attention_bwd_dq": "flash_attention_bwd",
               "flash_attention_bwd_dkv": "flash_attention_bwd",
               "decode_attention_paged": "decode_attention",
               "multi_lora_q8": "multi_lora"}
    # launches: the serving, training, serving-at-scale, store, runtime,
    # telemetry, gemma2, gemma2-train, configs and moe runs' together
    # (flash_attention runs on all ten paths; the ring ticks count as the
    # paged decode kernel's, of
    # which they are the ring addressing mode); the top-level numbers are
    # the kernel's first row, "rows" holds every phase-1 row of the kernel
    # (both cola_fit taps, multi_lora at a tick, the d_head 256 rows and the
    # other configs' shapes)
    for extra in (gemma2, configs, moe):
        extra["decode_attention_paged"] += extra.pop("decode_attention_ring")
    kernels = [dict(name=n, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{sources.get(n, n)}.cu",
                    replaces=replaces[n],
                    launches=(launches[n] + train[n] + scale[n] + store[n]
                              + runtime[n] + tele[n] + gemma2[n]
                              + gemma2_train[n] + configs[n] + moe[n]),
                    **rows[n],
                    rows={k: v for k, v in rows.items()
                          if k == n or k.startswith(n + "[")})
               for n in replaces]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
