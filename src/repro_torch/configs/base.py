"""ModelConfig (the architecture), ColaConfig (how ColA attaches to it),
TrainConfig (optimizer and batch) and MeshConfig (the device mesh's shape):
frozen dataclasses, so they are hashable.
Copies of the JAX package's ``configs/base.py``; the port keeps its own so
that it imports nothing of the JAX package.
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
    remat: str = "full"            # "none" | "full" | "dots" (models/remat.py)
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


@dataclass(frozen=True)
class ColaConfig:
    """How ColA is attached to a model (static)."""
    mode: str = "fused_fit"        # "faithful_offload" (Mode A) | "fused_fit" (Mode B)
                                   # | "lora" (classic PEFT baseline) | "ft" | "frozen"
    family: str = "lowrank"        # adapter family for all taps ("lowrank"|"linear"|"mlp")
    taps: str = "qv"               # "qv" | "all_attn" | "mlp" | "all" | "ssm"
    rank: int = 8
    hidden: int = 128
    scale: float = 1.0
    merged: bool = False           # parameter merging during training (Alg.1 l.3/8)
    interval: int = 1              # adaptation interval I
    users: int = 1                 # K collaborative users
    compress: str = "none"         # "none" | "int8" (offload compression)


@dataclass(frozen=True)
class TrainConfig:
    batch: int = 32
    seq: int = 128
    lr: float = 3e-4
    weight_decay: float = 5e-4
    warmup: float = 0.05
    steps: int = 100
    optimizer: str = "adamw"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "linear"       # "linear" | "cosine" | "const"
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """A mesh's shape without its devices: ("data", "model"), or ("pod",
    "data", "model") when ``pods`` > 1. The sharding rules take one in place
    of a ``DeviceMesh`` (``repro_torch.distributed.sharding``)."""
    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def devices(self) -> int:
        return self.data * self.model * self.pods
