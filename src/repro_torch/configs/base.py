"""ModelConfig: the architecture description (a frozen dataclass, so it is
hashable). A copy of the JAX package's ``configs/base.py:ModelConfig``; the
port keeps its own so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    # attention
    rope_theta: float = 1e4
    qk_norm: bool = False
    attn_pattern: str = "global"   # "global" | "local_global" (alternating pairs)
    local_window: int = 4096
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    act: str = "silu"              # "silu" | "gelu"
    post_norm: bool = False        # gemma2 post-layernorms
    norm_plus_one: bool = False    # gemma-style (1+scale) rmsnorm
    embed_scale: bool = False      # gemma-style sqrt(d_model) embedding scaling
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    moe_impl: str = "einsum"
    capacity_factor: float = 1.25
    moe_group: int = 512
    aux_loss_coef: float = 0.01
    # ssm (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssd_chunk: int = 128
    shared_attn_every: int = 0
    # modality stubs
    n_codebooks: int = 0
    embed_input: bool = False
    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"
    loss_chunk: int = 0
    microbatches: int = 1
    shard_policy: str = "2d"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
