"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free), vocab=50280,
ssm_state=128, headdim=64, expand=2 (d_inner=2048, 32 SSD heads).
SSD = state-space duality. [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
        ssd_chunk=128, tie_embeddings=True,
        microbatches=2,
    )
