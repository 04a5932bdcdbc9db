"""Gradient Learning, as far as serving needs it: tap selection. The GL
training steps are still to be ported (ROADMAP.md)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


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
