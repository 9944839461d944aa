"""Deployment-scale int8 quality gate: the port of ``tools/int8_gate_1b.py``.

Trains a model on a synthetic corpus for a few hundred steps, then
measures held-out perplexity

* through ``make_eval_step`` (teacher-forced forward): full precision vs
  int8 weight-only;
* through the DECODE path (prefill + ``decode_step``, the code serving
  runs): full-precision cache vs int8 KV cache vs int8 weights + int8 KV.

Bars: int8 weights < 1 % relative perplexity change, int8 KV < 1 %, both
together < 2 %.  The module is split in two halves that the int4 gate
(:mod:`tpu_nexus_torch.tools.int4_gate_1b`) shares: :func:`train` returns
trained params, :func:`measure` judges a params tree.

The corpus is a noisy affine bigram chain over a 512-token support of the
32k vocabulary, ``t[i] = (31 t[i-1] + 7 + noise[i]) mod 512`` with the
noise from ``numpy.random.default_rng(0)``: learnable in minutes, which
is all a quantization delta needs to mean something, and the same tokens
as the JAX package's tool.

Knobs: ``NEXUS_GATE_MODEL`` (``nexus_1b``, default, or ``nexus_moe``),
``NEXUS_GATE_STEPS`` (default 300), ``NEXUS_DEVICE`` (default ``cuda``;
``cpu`` to run on the host).  Prints one JSON line per measurement:

    python -m tpu_nexus_torch.tools.int8_gate_1b
    NEXUS_GATE_MODEL=nexus_moe NEXUS_GATE_STEPS=500 python -m tpu_nexus_torch.tools.int8_gate_1b
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from tpu_nexus_torch.models.generate import teacher_forced_decode_ce
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.models.moe import MoeConfig
from tpu_nexus_torch.models.quant import quantize_params
from tpu_nexus_torch.workload.data import token_file_batches, write_token_npy
from tpu_nexus_torch.workload.harness import resolve_device
from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, make_eval_step, make_train_step

#: tokens of the corpus's support; the model trained when its perplexity
#: is under half of it (uniform over the support is 512)
SUPPORT = 512
#: the corpus's train / held-out split point, as a share of its length
SPLIT = 0.98
#: relative perplexity bars
GATE_WEIGHTS = 0.01
GATE_KV = 0.01
GATE_BOTH = 0.02


@dataclasses.dataclass(frozen=True)
class GateTier:
    """One gate configuration: the model, its training batch and the
    corpus length."""

    model: str
    cfg: Any
    batch: int = 16
    seq: int = 2048
    n_tokens: int = 8 * 1024 * 1024


def gate_tier(model: str, *, cpu_tiers: bool = False) -> GateTier:
    """``NEXUS_GATE_MODEL`` → its tier.  ``nexus_1b`` and ``nexus_moe`` are
    the card's; ``cpu_tiers`` (the int4 gate) adds ``small`` (hidden 256,
    the narrowest width at which int4's bar can be met) and ``tiny``."""
    if model == "nexus_1b":
        return GateTier(model, LlamaConfig.nexus_1b())
    if model == "nexus_moe":
        # the MoE preset trains ~3x faster per token: a wider batch, same minutes
        return GateTier(model, MoeConfig.nexus_moe(), batch=32)
    if cpu_tiers and model == "small":
        cfg = LlamaConfig(
            vocab_size=1024, hidden=256, n_layers=2, n_heads=8, n_kv_heads=4,
            head_dim=32, intermediate=512, max_seq_len=256, remat=False,
        )
        return GateTier(model, cfg, batch=8, seq=128, n_tokens=1024 * 1024)
    if cpu_tiers and model == "tiny":
        return GateTier(model, LlamaConfig.tiny(vocab_size=1024), batch=8, seq=256, n_tokens=1024 * 1024)
    known = "nexus_1b, nexus_moe" + (", small, tiny" if cpu_tiers else "")
    raise ValueError(f"unknown NEXUS_GATE_MODEL {model!r}; use one of {known}")


def corpus_tokens(n: int) -> np.ndarray:
    """The gate corpus: ``n`` tokens of the noisy affine bigram chain."""
    noise = np.random.default_rng(0).integers(0, 16, size=n).tolist()
    out = [1] * n
    prev = 1
    for i in range(1, n):
        prev = (prev * 31 + 7 + noise[i]) % SUPPORT
        out[i] = prev
    return np.asarray(out, dtype=np.int32)


def write_corpus(name: str, n: int) -> str:
    """The corpus as a token file under the temporary directory."""
    return write_token_npy(os.path.join(tempfile.gettempdir(), name), corpus_tokens(n))


def _split(tier: GateTier) -> int:
    return int(tier.n_tokens * SPLIT)


def emit(line: Dict[str, Any]) -> None:
    print(json.dumps(line), flush=True)


def train(
    tier: GateTier, steps: int, path: str, device: torch.device, *, log: Callable[[Dict[str, Any]], None] = emit,
):
    """The training half: ``steps`` adamw steps (lr 1e-3, 20 warm-up
    steps, cosine to ``steps``) from seed 0 on the corpus's training
    range; a JSON line every 50 steps.  Returns the trained params."""
    tcfg = TrainConfig(warmup_steps=20, total_steps=max(steps, 2), learning_rate=1e-3)
    state = init_train_state(torch.Generator(device=device).manual_seed(0), tier.cfg, tcfg, device)
    step_fn = make_train_step(tier.cfg, tcfg)
    data = token_file_batches(path, batch=tier.batch, seq_len=tier.seq, seed=1, end=_split(tier))
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = step_fn(state, torch.from_numpy(next(data)).to(device=device, dtype=torch.long))
        if (i + 1) % 50 == 0:
            log({"phase": "train", "step": i + 1, "loss": round(float(metrics["loss"]), 4),
                 "elapsed_s": round(time.perf_counter() - t0, 1)})
    return state["params"]


def heldout(tier: GateTier, path: str, device: torch.device, *, batch: int, seq: int, seed: int, count: int):
    """``count`` batches of the held-out range, on ``device``."""
    stream = token_file_batches(path, batch=batch, seq_len=seq, seed=seed, start=_split(tier))
    return [torch.from_numpy(next(stream)).to(device=device, dtype=torch.long) for _ in range(count)]


def forward_ppl(params, cfg: Any, batches: List[torch.Tensor]) -> float:
    """Perplexity of the teacher-forced forward (``make_eval_step``'s
    cross-entropy, averaged over the batches)."""
    eval_fn = make_eval_step(cfg, TrainConfig())
    ces = [float(eval_fn({"params": params}, b)["ce_loss"]) for b in batches]
    return float(np.exp(np.mean(ces)))


@torch.no_grad()
def decode_ppl(params, cfg: Any, batches: List[torch.Tensor], kv_quant: str = "") -> float:
    """Perplexity scored through the decode path
    (``teacher_forced_decode_ce``)."""
    return float(np.exp(np.mean([float(teacher_forced_decode_ce(params, b, cfg, kv_quant=kv_quant))
                                 for b in batches])))


def check_trained(ppl: float) -> None:
    """Raise unless the full-precision model learned the corpus."""
    if not ppl < SUPPORT / 2:
        raise RuntimeError(f"model did not train (ppl {ppl} vs {SUPPORT}-support uniform {SUPPORT})")


def rel_delta(a: float, b: float) -> float:
    return (a - b) / b


def measure(
    params, tier: GateTier, path: str, device: torch.device, steps: int, *,
    eval_batches: int = 8, decode_batches: int = 2, decode_seq: int = 1024,
) -> List[Dict[str, Any]]:
    """The int8 gate's measuring half over trained ``params``: the
    forward gate's and the decode gate's JSON lines, each with its
    ``pass``.  Raises when the model did not train."""
    cfg = tier.cfg
    qparams = quantize_params(params, mode="int8")
    batches = heldout(tier, path, device, batch=tier.batch, seq=tier.seq, seed=99, count=eval_batches)
    ppl_full = forward_ppl(params, cfg, batches)
    ppl_int8 = forward_ppl(qparams, cfg, batches)
    check_trained(ppl_full)
    forward = {
        "phase": "gate_forward", "model": tier.model, "steps": steps,
        "ppl_bf16": round(ppl_full, 4), "ppl_int8w": round(ppl_int8, 4), "support": SUPPORT,
        "rel_delta": round(rel_delta(ppl_int8, ppl_full), 6),
        "gate_lt": GATE_WEIGHTS, "pass": bool(abs(rel_delta(ppl_int8, ppl_full)) < GATE_WEIGHTS),
    }
    dec = heldout(tier, path, device, batch=8, seq=decode_seq, seed=7, count=decode_batches)
    d_full = decode_ppl(params, cfg, dec)
    d_kv8 = decode_ppl(params, cfg, dec, kv_quant="int8")
    d_both = decode_ppl(qparams, cfg, dec, kv_quant="int8")
    decode = {
        "phase": "gate_decode", "model": tier.model, "seq": decode_seq,
        "ppl_bf16": round(d_full, 4), "ppl_int8kv": round(d_kv8, 4), "ppl_int8w_int8kv": round(d_both, 4),
        "rel_delta_kv": round(rel_delta(d_kv8, d_full), 6), "rel_delta_both": round(rel_delta(d_both, d_full), 6),
        "gate_kv_lt": GATE_KV, "gate_both_lt": GATE_BOTH,
        "pass": bool(abs(rel_delta(d_kv8, d_full)) < GATE_KV and abs(rel_delta(d_both, d_full)) < GATE_BOTH),
    }
    return [forward, decode]


def main(env: Optional[Mapping[str, str]] = None) -> int:
    e = os.environ if env is None else env
    steps = int(e.get("NEXUS_GATE_STEPS", "300"))
    tier = gate_tier(e.get("NEXUS_GATE_MODEL", "nexus_1b"))
    device = resolve_device(e.get("NEXUS_DEVICE", "cuda"))
    path = write_corpus("gate1b_corpus.npy", tier.n_tokens)
    params = train(tier, steps, path, device)
    lines = measure(params, tier, path, device, steps)
    for line in lines:
        emit(line)
    return 0 if all(line["pass"] for line in lines) else 1


if __name__ == "__main__":
    raise SystemExit(main())
