"""Operation and byte counts of the benchmark's cells, computed from shapes,
and the published peaks they are held against.

Every count here is what the algorithm needs for the call: each input byte
read once, each output byte written once, causal attention counted over the
lower triangle.  So no share computed from these counts can pass 100 %
unless the time measured leaves out part of the work.  The functions take
the configuration file's keys (``hidden_size`` ...), never the program's
objects, so the program cannot move its own yardstick.
"""

from __future__ import annotations

from typing import Dict

#: NVIDIA H100 SXM data sheet, dense rates: bf16 tensor-core FLOP/s and HBM3
#: bytes/s.  Both assume the full 700 W power limit; the harness records the
#: card's limit beside every reading.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def dims(cfg: Dict) -> Dict[str, int]:
    """The widths of a configuration file, by short names."""
    hq = cfg["num_attention_heads"]
    return {
        "e": cfg["hidden_size"],
        "f": cfg["intermediate_size"],
        "hq": hq,
        "hkv": cfg["num_key_value_heads"],
        "d": cfg.get("head_dim") or cfg["hidden_size"] // hq,
        "l": cfg["num_hidden_layers"],
        "v": cfg["vocab_size"],
        "ne": cfg.get("num_local_experts", 0),
        "k": cfg.get("num_experts_per_tok", 0),
    }


def matmul_params(cfg: Dict, active: bool = True) -> int:
    """Parameters that take part in a token's matrix products: attention
    projections, the MLP (with experts, the router and the ``k`` routed
    experts when ``active``, every expert otherwise) and the head."""
    g = dims(cfg)
    e, f = g["e"], g["f"]
    attn = e * g["hq"] * g["d"] * 2 + 2 * e * g["hkv"] * g["d"]
    if g["ne"]:
        ffn = (g["k"] if active else g["ne"]) * 3 * e * f + e * g["ne"]
    else:
        ffn = 3 * e * f
    return g["l"] * (attn + ffn) + e * g["v"]


def model_flops_per_token(cfg: Dict, seq: int) -> float:
    """Training FLOPs a token: 3 x (2 x matmul parameters + causal
    attention), recompute excluded (the MFU convention).  A copy of the
    port's ``workload/goodput.py::model_flops_per_token`` over the
    configuration file's keys; an MoE counts its router and active
    experts."""
    g = dims(cfg)
    attn = 2 * seq * g["hq"] * g["d"] * g["l"]  # 4 s hq d / 2 a layer, causal
    return 3.0 * (2.0 * matmul_params(cfg) + attn)


def flash_fwd_flops(b: int, s: int, hq: int, d: int) -> float:
    """One causal flash forward launch: QK^T and PV over the lower
    triangle."""
    return 2 * (2.0 * b * hq * s * s * d) / 2


def flash_bwd_flops(b: int, s: int, hq: int, d: int) -> float:
    """One causal flash backward (the dQ and dK/dV kernels together): five
    products (S again, dP, dV, dQ, dK) over the lower triangle."""
    return 5 * (2.0 * b * hq * s * s * d) / 2
