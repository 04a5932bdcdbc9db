"""Architecture registry: full configs, reduced smoke variants and the shape
cells, as in the JAX package's ``configs/registry.py``. Every one of its
eleven configs is listed: the uniform-attention plan with dense blocks
(gpt2-small, smollm-135m, the two mistrals, and musicgen-medium's four
codebooks with an untied head and pixtral-12b's embedding input) and with
MoE blocks (qwen3-moe-30b-a3b, dbrx-132b), gemma2's local/global pairs
plan, the attention-free SSM plan of Mamba2 blocks (mamba2-370m), and the
hybrid plan of Mamba2 segments with a shared attention block (zamba2-7b).
The input specs are tensors on the meta device (shape and dtype, no
memory), the counterpart of JAX's ``ShapeDtypeStruct`` stand-ins."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import canonical_dtype

ARCH_MODULES = {
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "gpt2-small": "repro_torch.configs.gpt2_small",
}

ASSIGNED = tuple(k for k in ARCH_MODULES if k != "gpt2-small")


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


# ---------------------------------------------------------------------------
# shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Skip rules: long_500k only for sub-quadratic (SSM / hybrid) archs."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")
    return shapes


def all_cells() -> list[tuple[str, str]]:
    return [(arch, s) for arch in ASSIGNED
            for s in applicable_shapes(get_config(arch))]


def skipped_cells() -> list[tuple[str, str, str]]:
    return [(arch, "long_500k",
             "full quadratic attention; 500k ctx requires sub-quadratic")
            for arch in ASSIGNED if not get_config(arch).sub_quadratic]


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins: no allocation)
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=canonical_dtype(dtype), device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Training / prefill batch input specs for one model: token ids, 4
    codebooks' ids, or embeddings in ``compute_dtype``, and the labels."""
    if cfg.embed_input:
        return {
            "embeds": _sds((batch, seq, cfg.d_model), cfg.compute_dtype),
            "labels": _sds((batch, seq), torch.int32),
        }
    if cfg.n_codebooks:
        return {
            "tokens": _sds((batch, seq, cfg.n_codebooks), torch.int32),
            "labels": _sds((batch, seq, cfg.n_codebooks), torch.int32),
        }
    return {
        "tokens": _sds((batch, seq), torch.int32),
        "labels": _sds((batch, seq), torch.int32),
    }


def decode_token_specs(cfg: ModelConfig, batch: int) -> dict:
    if cfg.embed_input:
        tok = {"embeds": _sds((batch, 1, cfg.d_model), cfg.compute_dtype)}
    elif cfg.n_codebooks:
        tok = {"tokens": _sds((batch, 1, cfg.n_codebooks), torch.int32)}
    else:
        tok = {"tokens": _sds((batch, 1), torch.int32)}
    tok["positions"] = _sds((batch,), torch.int32)
    return tok


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-tensor stand-ins for every model input of a shape cell. A decode
    cell's cache specs come from ``repro_torch.models.model.cache_specs``."""
    spec = SHAPES[shape_name]
    if spec.kind in ("train", "prefill"):
        return batch_specs(cfg, spec.batch, spec.seq)
    return decode_token_specs(cfg, spec.batch)
