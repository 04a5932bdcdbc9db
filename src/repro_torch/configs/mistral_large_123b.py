"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768, head_dim=128. [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense",
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
        d_ff=28672, vocab_size=32768, rope_theta=1e6,
        microbatches=8,
    )
