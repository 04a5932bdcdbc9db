"""pixtral-12b [vlm]: pixtral-ViT frontend (STUBBED: batches carry
precomputed patch embeddings, "embeds") + mistral-nemo backbone: 40L
d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. [hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab_size=131072, rope_theta=1e6,
        embed_input=True,
        microbatches=8,
    )
