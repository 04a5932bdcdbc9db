"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152,
llama-arch small, head_dim=64. [hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_head=64,
        d_ff=1536, vocab_size=49152, rope_theta=1e4,
    )
