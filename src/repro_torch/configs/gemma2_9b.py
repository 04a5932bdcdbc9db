"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
local(4096)+global alternating, attn softcap 50 / final softcap 30, GeGLU,
pre+post norms, head_dim=256. [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
        d_ff=14336, vocab_size=256000,
        attn_pattern="local_global", local_window=4096,
        attn_softcap=50.0, final_softcap=30.0, act="gelu",
        post_norm=True, norm_plus_one=True, embed_scale=True,
        rope_theta=1e4, loss_chunk=512,
        microbatches=4,
    )
