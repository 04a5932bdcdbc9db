"""Where the serving path's time goes on the card.

Runs the ``chip_smoke.py`` serving setup (full-width smollm-135m, bf16, 4
users' rank-8 ``qv`` adapters, 16 slots, max_len 1024, prompts of 32-512
tokens; ``--config``, ``--slots``, ``--max-len`` and ``--prompts`` set
another registered model and load), fills every slot and profiles the
prefill, then a window of decode ticks, with ``torch.profiler``.
Unchunked, the prefill is one batched prefill call; with ``--prefill-chunk
C`` it is the first chunk round (one C-token chunk of every prompt), and the
decode window starts once every prompt is in cache.
``--kv-layout paged`` (blocks of ``--kv-block``; needs ``--prefill-chunk``)
and ``--bank-store int8`` select the serving-at-scale paths. Prints, per
phase, the host wall time, the device busy time (sum of kernel times), the
idle share, and the top device kernels and host ops.

Run on a machine with a CUDA card, from the repo root:
``PYTHONPATH=src python -m repro_torch.profile_serve [--prefill-chunk 128
--kv-layout paged --bank-store int8]``; gemma2-9b as ``chip_smoke.py``'s
``[gemma2]`` drives it: ``--config gemma2-9b --slots 8 --max-len 6144
--prompts 256 4800``; mamba2-370m as ``[ssm]`` (a): ``--config mamba2-370m
--slots 8 --max-len 1024`` (the taps "qv" fall back to its ssm
projections); zamba2-7b as ``[hybrid]`` (a): ``--config zamba2-7b --slots 8
--max-len 1024`` (the taps "qv" are the shared block's q and v, one
adapter at every call).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _summary(prof, wall_s: float, label: str, top: int = 12) -> None:
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    idle = 1.0 - busy_us / 1e6 / wall_s if wall_s else float("nan")
    print(f"[{label}] host wall {wall_s * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, device idle share {idle:.3f}")
    print(f"[{label}] top device kernels (total ms, calls):")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} {e.count:6d}  {e.key[:90]}")
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    print(f"[{label}] top host ops by self CPU (total ms, calls):")
    for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} {e.count:6d}  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--kv-layout", choices=("dense", "paged"), default="dense")
    ap.add_argument("--kv-block", type=int, default=16)
    ap.add_argument("--bank-store", choices=("f32", "int8"), default="f32")
    ap.add_argument("--config", default="smollm-135m")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--prompts", type=int, nargs=2, default=(32, 512),
                    metavar=("MIN", "MAX"), help="prompt lengths drawn from")
    args = ap.parse_args(argv)
    ticks = args.ticks
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.core import gl
    from repro_torch.models import model
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    dev = torch.device("cuda")
    cfg = registry.get_config(args.config)
    params = model.init(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(0)
    sites = model.tap_sites(cfg)

    def lead(t):   # a stacked site's adapter has the layer axis
        return (sites[t].stacked,) if sites[t].stacked else ()

    banks = [{t: {"A": torch.randn(lead(t) + (sites[t].d_in, 8),
                                   generator=gen).to(dev) / 8 ** 0.5,
                  "B": torch.randn(lead(t) + (8, sites[t].d_out),
                                   generator=gen).to(dev) * 0.05}
              for t in gl.select_taps(cfg, "qv")} for _ in range(4)]
    rng = np.random.default_rng(0)

    def engine_with_requests():
        eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                          user_adapters=banks, device=dev,
                          prefill_chunk=args.prefill_chunk,
                          kv_layout=args.kv_layout, kv_block=args.kv_block,
                          bank_store=args.bank_store)
        lo, hi = args.prompts
        for i, n in enumerate(rng.integers(lo, hi + 1, args.slots)):
            eng.submit(Request(rid=i, user=i % 4, max_new=ticks + 8,
                               prompt=rng.integers(0, cfg.vocab_size, n)))
        return eng

    warm = engine_with_requests()          # library handles, allocator
    warm.tick()
    warm.tick()
    del warm                                # its cache, before the next one's
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    eng = engine_with_requests()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng._admit()      # unchunked: one batched prefill of every slot
        if args.prefill_chunk is not None:
            eng._chunk_round()              # the first chunk round
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _summary(prof, wall, "prefill" if args.prefill_chunk is None
             else "chunk round")
    eng.tick()                              # one tick outside the window
    while any(r is not None and r._consumed < len(r.prompt)
              for r in eng.active):         # the rest of the chunk rounds
        eng.tick()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _summary(prof, wall, f"decode x{ticks}")
    print(f"[decode] {wall / ticks * 1e3:.2f} ms per tick (profiled)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
