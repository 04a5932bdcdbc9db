"""zamba2-7b [hybrid]: 81 Mamba2 layers d_model=3584 + shared attention block
(32H kv=32 MHA, d_ff=14336) applied every 6 layers, vocab=32000, ssm_state=64.
[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=112,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
        shared_attn_every=6, ssd_chunk=128,
        microbatches=8,
    )
