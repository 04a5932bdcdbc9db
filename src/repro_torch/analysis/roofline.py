"""Roofline terms of a dry-run record (no card), the JAX package's
``analysis/roofline.py`` under its names, on one NVIDIA H100.

Terms per (arch, mesh), each one rank's:
    compute term    = flops / PEAK_FLOPS
    memory term     = bytes_moved / HBM_BW
    collective term = collective_bytes / LINK_BW

``bytes_moved`` is what the step must move at least: its inputs read once
and its outputs written once, an output that is an input (a cache updated
in place) once, as ``memory_record``'s argument + output - alias, and the
leaves it gathers a layer at a time read once a gather (the record's
``gathered_leaf_bytes``: a rank's inputs hold only its blocks). JAX's
memory term reads XLA's ``bytes_accessed``, the fused program's traffic;
the port's ``bytes_accessed`` is the plain path's, every op's inputs plus
outputs unfused, which a fused kernel never moves. So it is kept beside
the terms as ``t_memory_unfused`` and takes no part in ``bottleneck``.

Hardware constants: the H100 SXM data sheet (dense, no sparsity, at the
700 W limit): 989e12 FLOP/s in bf16 on the tensor cores, 67e12 in f32
outside them, 3.35e12 B/s of HBM. The collective term takes NVLink 4's
450e9 B/s a direction a card (in place of the TPU's 50 GB/s a link of ICI).
A 16 x 16 or 2 x 16 x 16 mesh spans 32 or 64 hosts of 8 cards, so every
record also carries ``t_collective_nic``, the same bytes at a 400 Gb/s
NIC's 50e9 B/s; ``bottleneck`` is the largest of the compute, memory and
NVLink collective terms, and neither the NIC term nor the unfused one
takes part in it.

Left out, with no torch counterpart: ``collective_bytes`` and
``cpu_bf16_emulation_bytes`` parse XLA's HLO text. The port's collective
bytes come from the collectives a step issues
(``analysis/collectives.py``); its peak comes from the tensors a step holds
live, with no compiler copies to subtract.
"""
from __future__ import annotations

from typing import Any

PEAK_FLOPS = 989e12        # bf16 FLOP/s a card (tensor cores, dense)
PEAK_FLOPS_F32 = 67e12     # f32 FLOP/s a card, outside the tensor cores
HBM_BW = 3.35e12           # bytes/s a card
LINK_BW = 450e9            # bytes/s a card a direction (NVLink 4)
NIC_BW = 50e9              # bytes/s a card through a 400 Gb/s NIC


def memory_record(argument: int, output: int, alias: int,
                  peak: int) -> dict:
    """JAX's memory keys from a step's counted bytes: ``argument`` held by
    its inputs, ``output`` by its outputs, ``alias`` by outputs that are
    inputs (a cache updated in place), ``peak`` the most live at once. The
    temporaries are what the peak holds beyond those, so that JAX's
    identity peak = argument + output + temp - alias holds."""
    return {
        "argument_size_in_bytes": int(argument),
        "output_size_in_bytes": int(output),
        "alias_size_in_bytes": int(alias),
        "temp_size_in_bytes": int(peak - argument - output + alias),
        "peak_bytes_per_device": int(peak),
    }


def bytes_moved(memory: dict, gathered: int = 0) -> int:
    """The bytes a step must move at least, from ``memory_record``'s keys:
    its inputs read once, its outputs written once, an in-place output
    once; and ``gathered``, the bytes of the leaves it gathers a layer at a
    time (a record's ``gathered_leaf_bytes``), each read once a gather."""
    return (memory["argument_size_in_bytes"] + memory["output_size_in_bytes"]
            - memory["alias_size_in_bytes"] + gathered)


def roofline_terms(rec: dict[str, Any]) -> dict[str, float]:
    """rec carries one rank's flops, memory (``memory_record``'s keys),
    gathered_leaf_bytes (none where absent), bytes_accessed and
    collective_bytes, so the terms are a card's, with no division by the
    rank count."""
    t_compute = rec["flops"] / PEAK_FLOPS
    t_memory = bytes_moved(rec["memory"],
                           rec.get("gathered_leaf_bytes", 0)) / HBM_BW
    t_coll = rec["collective_bytes"] / LINK_BW
    terms = {"t_compute": t_compute, "t_memory": t_memory,
             "t_collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    total = max(terms.values())
    return {**terms,
            "t_memory_unfused": rec["bytes_accessed"] / HBM_BW,
            "t_collective_nic": rec["collective_bytes"] / NIC_BW,
            "bottleneck": bottleneck.replace("t_", ""),
            "roofline_s": total,
            "roofline_fraction": (t_compute / total) if total > 0 else 0.0}


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); decode uses D=new tokens
# ---------------------------------------------------------------------------

def param_count(cfg) -> tuple[int, int]:
    """(total, active) parameter counts, analytic: the JAX package's formula
    line for line, which leaves out the norms and the SSM's small leaves
    (conv, dt_bias, A_log, D), so it is not the init's leaf count."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    emb = V * d * (cfg.n_codebooks or 1)
    head = 0 if cfg.tie_embeddings and not cfg.n_codebooks else (
        d * V * (cfg.n_codebooks or 1))
    per_attn = d * (cfg.n_heads * cfg.d_head) * 2 + \
        d * (cfg.n_kv_heads * cfg.d_head) * 2 if cfg.n_heads else 0
    per_mlp = 3 * d * cfg.d_ff if cfg.d_ff else 0
    per_moe_total = per_moe_active = 0
    if cfg.n_experts:
        per_e = 3 * d * cfg.d_expert
        per_moe_total = cfg.n_experts * per_e + d * cfg.n_experts
        per_moe_active = cfg.moe_top_k * per_e + d * cfg.n_experts
    per_ssm = 0
    if cfg.ssm_state:
        di = cfg.ssm_expand * d
        nh = di // cfg.ssm_headdim
        d_in_proj = 2 * di + 2 * cfg.ssm_state + nh
        per_ssm = d * d_in_proj + di * d

    if cfg.family == "ssm":
        body_t = body_a = L * per_ssm
    elif cfg.family == "hybrid":
        n_seg = len(range(0, L, cfg.shared_attn_every))
        shared = per_attn + per_mlp
        body_t = L * per_ssm + shared
        body_a = L * per_ssm + n_seg * shared   # shared block runs n_seg times
    elif cfg.n_experts:
        body_t = L * (per_attn + per_moe_total)
        body_a = L * (per_attn + per_moe_active)
    else:
        body_t = body_a = L * (per_attn + per_mlp)
    return emb + head + body_t, emb + head + body_a


def model_flops(cfg, shape_spec) -> float:
    """Useful model FLOPs for the cell: 6*N_active*tokens for train (fwd+bwd),
    2*N_active*tokens for prefill/decode (fwd only). A train cell keeps 6 N
    as the JAX package has it, although ColA's server step skips the base's
    weight gradients (forward, recompute and the data gradients: about
    6 N with remat "full")."""
    _, active = param_count(cfg)
    if shape_spec.kind == "train":
        tokens = shape_spec.batch * shape_spec.seq
        return 6.0 * active * tokens
    if shape_spec.kind == "prefill":
        tokens = shape_spec.batch * shape_spec.seq
        return 2.0 * active * tokens
    tokens = shape_spec.batch  # one new token per row
    return 2.0 * active * tokens
