"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) per-expert d_ff=10752,
vocab=100352, MoE 16 experts top-4 fine-grained, head_dim=128.
[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=0, vocab_size=100352, rope_theta=5e5,
        n_experts=16, moe_top_k=4, d_expert=10752, moe_impl="einsum",
        microbatches=8,
    )
