"""Split length and warp count of the split-KV decode kernel, measured.

Builds ``kernels/csrc/decode_attention.cu`` once per variant (``SPLIT`` x
warps, set by ``-DDECODE_SPLIT`` / ``-DDECODE_WARPS``; one nvcc each, all
started together) into ``build/decode_sweep/``, prints each variant's
registers and spills from ptxas, holds each against the plain version (bf16
and f32, dense and paged, slots at the split edges, dead slots, window +
softcap; two launches must give the same bits), and prints the median
device time of each variant (L2 flushed and the host run ahead behind a
device sleep, as ``chip_smoke.py`` times) at the serving shape (16 slots,
1024 positions, 9 / 3 heads, d_head 64, bf16):

- ``tick``: positions 32-544, as ``chip_smoke.py``'s decode row;
- ``horizon``: every slot at 1023;
- ``paged tick``: the tick through a shuffled table of blocks of 16;
- ``paged window``: the same with window 256, softcap 30, a quarter dead;
- ``all dead``, ``one split`` (every slot at 10), ``two splits`` (at 200):
  probes of the fixed cost and of the merge.

The variants are timed in turns, first to last and then last to first.

Run on a machine with a CUDA card, from the repo root:
``PYTHONPATH=src python -m repro_torch.sweep_decode [--variants 64x4,128x8]``
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys

import torch

TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}   # as chip_smoke.py


def _median_ms(fn, flush, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _build(variants):
    """{variant: library path}, after printing each one's ptxas lines."""
    from repro_torch.kernels import _build as b

    out_dir = b.BUILD_DIR.parent / "decode_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for split, warps in variants:
        lib = out_dir / f"decode_attention-{split}x{warps}.so"
        cmd = [b._nvcc(), *b.NVCC_FLAGS, f"-DDECODE_SPLIT={split}",
               f"-DDECODE_WARPS={warps}", "-I", str(b.CSRC), "-o", str(lib),
               str(b.CSRC / "decode_attention.cu")]
        jobs[(split, warps)] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        libs[v] = lib
        tag, spills = None, ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"decode_split_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                              line)
                tag = m and f"{'f32' if m.group(1) == 'f' else 'bf16'},{m.group(2)}"
            elif tag and "spill stores" in line:
                spills = line.strip()
            elif tag and (m := re.search(r"Used (\d+) registers", line)):
                print(f"[ptxas] {v[0]}x{v[1]} <{tag}>: {m.group(1)} registers; "
                      f"{spills}", flush=True)
                tag = None
    return libs


def _use(variant, lib):
    from repro_torch.kernels import _build as b
    from repro_torch.kernels import decode_attention as da

    da.SPLIT = variant[0]
    b._LIBS["decode_attention"] = ctypes.CDLL(str(lib))


def _inputs(dtype, dev, seed=0):
    """The serving shape: q, dense caches, pools of blocks of 16 with a
    shuffled table covering the horizon, the tick's positions."""
    B, Smax, H, K, D, bs = 16, 1024, 9, 3, 64, 16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, kc, vc = rnd(B, 1, H, D), rnd(B, Smax, K, D), rnd(B, Smax, K, D)
    kp, vp = rnd(B * Smax // bs, bs, K, D), rnd(B * Smax // bs, bs, K, D)
    perm = torch.randperm(B * Smax // bs,
                          generator=torch.Generator().manual_seed(seed))
    table = perm.view(B, Smax // bs).to(dev, torch.int32)
    pos = torch.randint(32, 545, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    return q, kc, vc, kp, vp, table, pos


def _check(variant, dev) -> None:
    from repro_torch.kernels import decode_attention as da

    L = variant[0]
    for dtype in (torch.bfloat16, torch.float32):
        q, kc, vc, kp, vp, table, pos = _inputs(dtype, dev, seed=1)
        for i, t in enumerate((0, L - 1, L, L + 1, 2 * L - 1, 1023, 2000)):
            pos[i] = t
        live = torch.arange(16, device=dev) % 4 != 3
        for kw in ({}, dict(live=live), dict(window=L // 2 + 3, softcap=30.0),
                   dict(window=1, live=live)):
            for fn, plain in ((da.decode_attention, da.plain),
                              (da.decode_attention_paged, da.plain_paged)):
                args = (q, kc, vc, pos) if fn is da.decode_attention else (
                    q, kp, vp, pos, table)
                got, again, want = fn(*args, **kw), fn(*args, **kw), \
                    plain(*args, **kw)
                err = float((got.float() - want.float()).abs().max())
                tol = TOL[dtype] * (1 + float(want.float().abs().max()))
                if err > tol or not torch.equal(got, again):
                    raise RuntimeError(f"{variant} {fn.__name__} {dtype} {kw}: "
                                       f"err {err:.3g} > {tol:.3g} or two "
                                       "launches differ")
    print(f"[check] {variant[0]}x{variant[1]}: every case within tolerance, "
          "two launches equal", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="32x4,64x4,128x4,128x8,256x8",
                    help="SPLITxWARPS, comma separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_decode: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import decode_attention as da

    variants = [tuple(int(x) for x in v.split("x"))
                for v in args.variants.split(",")]
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[card] {card}; torch {torch.__version__}", flush=True)
    libs = _build(variants)
    for v in variants:
        _use(v, libs[v])
        _check(v, dev)

    q, kc, vc, kp, vp, table, pos = _inputs(torch.bfloat16, dev)
    live = torch.arange(16, device=dev) % 4 != 3
    full, p10, p200 = (torch.full((16,), t, dtype=torch.int32, device=dev)
                       for t in (1023, 10, 200))
    rows = {
        "tick": lambda: da.decode_attention(q, kc, vc, pos),
        "horizon": lambda: da.decode_attention(q, kc, vc, full),
        "paged tick": lambda: da.decode_attention_paged(q, kp, vp, pos, table),
        "paged window": lambda: da.decode_attention_paged(
            q, kp, vp, pos, table, window=256, softcap=30.0, live=live),
        "all dead": lambda: da.decode_attention(q, kc, vc, pos,
                                                live=torch.zeros_like(live)),
        "one split": lambda: da.decode_attention(q, kc, vc, p10),
        "two splits": lambda: da.decode_attention(q, kc, vc, p200),
    }
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = {name: {} for name in rows}
    for order in (variants, variants[::-1]):
        for v in order:
            _use(v, libs[v])
            for name, fn in rows.items():
                times[name].setdefault(f"{v[0]}x{v[1]}", []).append(
                    round(_median_ms(fn, flush), 4))
    for name, by_variant in times.items():
        print(f"[time] {name:12s} ms " + "  ".join(
            f"{v}: {t[0]:.4f} / {t[1]:.4f}" for v, t in by_variant.items()),
            flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
