"""Architecture registry: full configs and reduced smoke variants. Only the
architectures the port runs are listed (see ROADMAP.md for the rest): the
uniform-attention plan with dense blocks (gpt2-small, smollm-135m, the two
mistrals) and with MoE blocks (qwen3-moe-30b-a3b, dbrx-132b), and gemma2's
local/global pairs plan."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_MODULES = {
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "gpt2-small": "repro_torch.configs.gpt2_small",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(ARCH_MODULES[name])
    return mod.get_config()


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests (the JAX package's
    ``registry.reduced_config``, field for field)."""
    cfg = get_config(name)
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        vocab_size=min(cfg.vocab_size, 512),
        param_dtype="float32", compute_dtype="float32", remat="none",
        loss_chunk=0,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, d_head=32,
                  n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4)
    if cfg.d_ff:
        kw.update(d_ff=256)
    if cfg.n_experts:
        kw.update(n_experts=8, moe_top_k=2, d_expert=64)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16, ssd_chunk=32)
    if cfg.shared_attn_every:
        kw.update(n_layers=7, shared_attn_every=3)
    if cfg.attn_pattern == "local_global":
        kw.update(local_window=16)
    return cfg.replace(**kw)
