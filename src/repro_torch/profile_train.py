"""Where the training path's time goes on the card.

Runs a ``chip_smoke.py`` training setup: full width, bf16, remat "full",
``ColaSession`` Mode A with merged rank-8 ``qv`` adapters, AdamW, and the
config's batch, sequence and fit interval from ``SETUPS`` (smollm-135m:
TrainConfig's 32 x 128, a fit every 2 steps, as ``[train]``; gemma2-9b: 1 x
4608, a fit every step, as ``[gemma2-train]``; qwen3-moe-30b-a3b: 1 x 2048,
a fit every step, as ``[moe]`` (b); mamba2-370m: 4 x 2048, a fit every
step, as ``[ssm]`` (b); zamba2-7b: 2 x 2048, a fit every step, as
``[hybrid]`` (b); musicgen-medium: 4 x 2048 of 4 codebooks, a fit every
step, as ``[musicgen]`` (b); pixtral-12b: 1 x 2048 stub embeddings, a fit
every step, as ``[pixtral]`` (b)). Takes two warm-up steps
(the second fits), then profiles with ``torch.profiler`` two more steps,
each labelled by whether it ran the offloaded fit. Prints, per step, the
host wall time, the device busy time (sum of kernel times), the idle share,
and the top device kernels and host ops.

Run on a machine with a CUDA card, from the repo root:
``PYTHONPATH=src python -m repro_torch.profile_train [--config NAME]``
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import TrainConfig
from repro_torch.profile_serve import _summary

# (batch, seq, fit interval) of each config's training setup, shared with
# chip_smoke.py's training phases
SETUPS = {"smollm-135m": (TrainConfig.batch, TrainConfig.seq, 2),
          "gemma2-9b": (1, 4608, 1),
          "qwen3-moe-30b-a3b": (1, 2048, 1),
          "mamba2-370m": (4, 2048, 1),
          "zamba2-7b": (2, 2048, 1),
          "musicgen-medium": (4, 2048, 1),
          "pixtral-12b": (1, 2048, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="smollm-135m", choices=sorted(SETUPS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.optim import optimizers

    dev = torch.device("cuda")
    cfg = registry.get_config(args.config)
    batch, seq, interval = SETUPS[args.config]
    tc = TrainConfig()
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=interval)
    sess = ColaSession(cfg, cc, model.init(cfg, seed=0, device=dev), seed=0,
                       device=dev, optimizer=optimizers.adamw(
                           tc.lr, weight_decay=tc.weight_decay))
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=0, device=dev)
    batches = [data.batch_at(i) for i in range(4)]
    for b in batches[:2]:                   # warm-up, including one fit
        sess.step(b)
    torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for b in batches[2:]:
        fits = sess.offloader.stats["fits"]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            sess.step(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        fit = sess.offloader.stats["fits"] > fits
        _summary(prof, wall, f"{args.config}: server step"
                 + (" + fit" if fit else ""), top=20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
