"""gpt2-small analogue — the paper's own CLM base model family (Table 6/12).
12L d_model=768 12H MHA d_ff=3072 vocab=50257. Used by the paper-table
benchmarks; not part of the assigned 10-arch pool.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gpt2-small", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
        d_ff=3072, vocab_size=50257, rope_theta=1e4,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
