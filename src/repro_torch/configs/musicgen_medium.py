"""musicgen-medium [audio]: decoder-only over EnCodec tokens.
48L d_model=1536 24H (GQA kv=24 == MHA) d_ff=6144 vocab=2048, 4 codebooks.
[arXiv:2306.05284; hf] — modality frontend stubbed: the backbone consumes the
4 EnCodec token streams directly (summed codebook embeddings, 4 output heads).
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="dense",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_head=64,
        d_ff=6144, vocab_size=2048, n_codebooks=4,
        rope_theta=1e4, tie_embeddings=False,
        microbatches=4,
    )
