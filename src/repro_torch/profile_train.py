"""Where the training path's time goes on the card.

Runs the ``chip_smoke.py`` training setup (full-width smollm-135m, bf16,
remat "full", ``ColaSession`` Mode A with merged rank-8 ``qv`` adapters,
interval 2, AdamW, SyntheticLM batches of 32 x 128), takes two warm-up steps
(the second fits), then profiles with ``torch.profiler`` one step without a
fit (the server step alone) and one with the offloaded fit. Prints, per
step, the host wall time, the device busy time (sum of kernel times), the
idle share, and the top device kernels and host ops.

Run on a machine with a CUDA card, from the repo root:
``PYTHONPATH=src python -m repro_torch.profile_train``
"""
from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.profile_serve import _summary


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig, TrainConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.optim import optimizers

    dev = torch.device("cuda")
    cfg = registry.get_config("smollm-135m")
    tc = TrainConfig()
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=2)
    sess = ColaSession(cfg, cc, model.init(cfg, seed=0, device=dev), seed=0,
                       device=dev, optimizer=optimizers.adamw(
                           tc.lr, weight_decay=tc.weight_decay))
    data = SyntheticLM(cfg, batch=tc.batch, seq=tc.seq, seed=0, device=dev)
    batches = [data.batch_at(i) for i in range(4)]
    for b in batches[:2]:                   # warm-up, including one fit
        sess.step(b)
    torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for b, label in ((batches[2], "server step"),
                     (batches[3], "server step + fit")):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            sess.step(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _summary(prof, wall, label, top=20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
