"""Int8/int4 WEIGHT quality gate: the port of ``tools/int4_gate_1b.py``.

Trains on the int8 gate's corpus with its training half
(:func:`tpu_nexus_torch.tools.int8_gate_1b.train`), then measures
held-out perplexity of the full-precision, int8 and packed-int4
(group-wise scales) weight trees

* through ``make_eval_step`` (teacher-forced forward);
* through the DECODE path, with a full-precision cache throughout so the
  delta is pure weight error.

Bars: int8 < 1 % relative perplexity change, int4 < 2 %.

``NEXUS_GATE_MODEL`` picks the tier: ``nexus_1b`` (default) and
``nexus_moe`` for the card, ``small`` (hidden 256) and ``tiny`` for the
host.  Group-wise int4 noise on a contraction of width K scales like
1/sqrt(K): tiny's hidden 64 cannot meet the bar at any group size, so
``small`` is the host's int4 tier and ``tiny`` only a smoke tier.
``NEXUS_QUANT_GROUP`` sets the int4 group (0 = the default 64),
``NEXUS_GATE_STEPS`` the training steps (default 300), ``NEXUS_DEVICE``
the device (default ``cuda``).  ``--with-int8-gate`` also runs the int8
gate's measurements on the same trained params (one training for both
gates).  Prints one JSON line per measurement:

    python -m tpu_nexus_torch.tools.int4_gate_1b
    NEXUS_GATE_MODEL=small NEXUS_QUANT_GROUP=32 NEXUS_DEVICE=cpu python -m tpu_nexus_torch.tools.int4_gate_1b
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch

from tpu_nexus_torch.models.quant import quantize_params
from tpu_nexus_torch.tools import int8_gate_1b as gate8
from tpu_nexus_torch.workload.harness import resolve_device

GATE_INT8 = gate8.GATE_WEIGHTS
GATE_INT4 = 0.02


def measure(
    params, tier: gate8.GateTier, path: str, device: torch.device, steps: int, group: int = 0, *,
    eval_batches: int = 8, decode_batches: int = 2, decode_seq: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """The int4 gate's measuring half over trained ``params``: the forward
    gate's and the decode gate's JSON lines, each with its ``pass``.
    Raises when the model did not train."""
    cfg = tier.cfg
    q8 = quantize_params(params, mode="int8")
    q4 = quantize_params(params, mode="int4", group=group)
    rel = gate8.rel_delta  # (a - b) / b
    batches = gate8.heldout(tier, path, device, batch=tier.batch, seq=tier.seq, seed=99, count=eval_batches)
    ppl_full = gate8.forward_ppl(params, cfg, batches)
    ppl_int8 = gate8.forward_ppl(q8, cfg, batches)
    ppl_int4 = gate8.forward_ppl(q4, cfg, batches)
    gate8.check_trained(ppl_full)
    forward = {
        "phase": "gate_forward", "model": tier.model, "steps": steps, "support": gate8.SUPPORT,
        "int4_group": group, "ppl_bf16": round(ppl_full, 4),
        "ppl_int8w": round(ppl_int8, 4), "ppl_int4w": round(ppl_int4, 4),
        "rel_delta_int8": round(rel(ppl_int8, ppl_full), 6), "rel_delta_int4": round(rel(ppl_int4, ppl_full), 6),
        "gate_int8_lt": GATE_INT8, "gate_int4_lt": GATE_INT4,
        "pass": bool(abs(rel(ppl_int8, ppl_full)) < GATE_INT8 and abs(rel(ppl_int4, ppl_full)) < GATE_INT4),
    }
    dec_seq = decode_seq or min(1024, cfg.max_seq_len)
    dec = gate8.heldout(tier, path, device, batch=8, seq=dec_seq, seed=7, count=decode_batches)
    d_full = gate8.decode_ppl(params, cfg, dec)
    d_int8 = gate8.decode_ppl(q8, cfg, dec)
    d_int4 = gate8.decode_ppl(q4, cfg, dec)
    decode = {
        "phase": "gate_decode", "model": tier.model, "seq": dec_seq,
        "int4_group": group, "ppl_bf16": round(d_full, 4),
        "ppl_int8w": round(d_int8, 4), "ppl_int4w": round(d_int4, 4),
        "rel_delta_int8": round(rel(d_int8, d_full), 6), "rel_delta_int4": round(rel(d_int4, d_full), 6),
        "gate_int8_lt": GATE_INT8, "gate_int4_lt": GATE_INT4,
        "pass": bool(abs(rel(d_int8, d_full)) < GATE_INT8 and abs(rel(d_int4, d_full)) < GATE_INT4),
    }
    return [forward, decode]


def main(argv: Optional[Sequence[str]] = None, env: Optional[Mapping[str, str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--with-int8-gate", action="store_true",
                        help="also run the int8 gate's measurements on the same trained params")
    args = parser.parse_args(argv)
    e = os.environ if env is None else env
    steps = int(e.get("NEXUS_GATE_STEPS", "300"))
    model = e.get("NEXUS_GATE_MODEL", "nexus_1b")
    group = int(e.get("NEXUS_QUANT_GROUP", "0") or 0)
    tier = gate8.gate_tier(model, cpu_tiers=True)
    device = resolve_device(e.get("NEXUS_DEVICE", "cuda"))
    path = gate8.write_corpus(f"gate4_corpus_{model}.npy", tier.n_tokens)
    params = gate8.train(tier, steps, path, device)
    lines = []
    if args.with_int8_gate:
        lines += gate8.measure(params, tier, path, device, steps)
    lines += measure(params, tier, path, device, steps, group)
    for line in lines:
        gate8.emit(line)
    return 0 if all(line["pass"] for line in lines) else 1


if __name__ == "__main__":
    raise SystemExit(main())
