"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) per-expert
d_ff=768, vocab=151936, MoE 128 experts top-8, head_dim=128, QK-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
        d_ff=0, vocab_size=151936, qk_norm=True, rope_theta=1e6,
        n_experts=128, moe_top_k=8, d_expert=768, moe_impl="einsum",
        microbatches=4,
    )
