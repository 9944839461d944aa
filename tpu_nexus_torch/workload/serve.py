"""Serving workload: supervised batch inference, the port of
``tpu_nexus/workload/serve.py``'s lockstep loop (``NEXUS_MODE=serve``).

Same ledger protocol as the reference (RUNNING → heartbeats with per-chip
progress → COMPLETED) and the same returned summary; the inner loop is
KV-cache batch decoding (models/generate.py) on one CUDA device, or on the
CPU when the caller asks for it (``NEXUS_DEVICE=cpu``).  A CUDA request on
a machine without a card raises: it never carries on on the CPU.

Quantized serving: ``NEXUS_QUANTIZE=int8|int4`` (with
``NEXUS_QUANT_GROUP`` for int4) quantizes the matmul weights after init, so
each decode step's weight products run through the dequant-matmul kernels
(ops/quant_matmul.py); ``NEXUS_QUANTIZE_KV=int8`` keeps the KV cache int8.
Bad values fail at parse with the reference's wording.

The MoE presets serve through the same loop (``models/generate.py``
decodes them with scatter dispatch at a dropless capacity);
``NEXUS_QUANTIZE`` with an MoE preset raises at parse (quantized expert
stacks are ROADMAP.md item A5b).

Knobs of the reference that this slice does not port raise at parse,
naming the ROADMAP.md item that brings them: ``NEXUS_CHECKPOINT_DIR``,
fault injection, and every engine-only knob set to a non-default value.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from tpu_nexus_torch.checkpoint.store import CheckpointStore
from tpu_nexus_torch.models.generate import DECODE_IMPLS, generate
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.models.moe import MoeConfig
from tpu_nexus_torch.models.quant import DEFAULT_INT4_GROUP, quantize_params, quantized_bytes
from tpu_nexus_torch.models.registry import LlamaAdapter, MoeAdapter, adapter_for, get_adapter
from tpu_nexus_torch.parallel.distributed import ProcessContext, initialize_distributed
from tpu_nexus_torch.workload.harness import LedgerReporter, resolve_device
from tpu_nexus_torch.workload.harness import sync as _sync

logger = logging.getLogger(__name__)


def _flag(v: str) -> bool:
    return v not in ("", "0")


#: env keys of the continuous-batching engine (NEXUS_MODE=serve-engine) and
#: the fleet controller, with their parsers and defaults: a non-default
#: value is refused at parse until the serve-engine slice is ported
ENGINE_ONLY_ENV = {
    "NEXUS_DEADLINE_S": (float, 0.0),
    "NEXUS_QUEUE_LIMIT": (int, 0),
    "NEXUS_DRAIN_GRACE_S": (float, 5.0),
    "NEXUS_PAGE_SIZE": (int, 0),
    "NEXUS_KV_BLOCKS": (int, 0),
    "NEXUS_SPEC_K": (int, 0),
    "NEXUS_SPEC_DRAFTER": (str, "ngram"),
    "NEXUS_SPEC_DRAFT_PRESET": (str, ""),
    "NEXUS_SERVE_MESH": (str, ""),
    "NEXUS_RELOAD_CHECK_S": (float, 0.0),
    "NEXUS_TRACE": (lambda v: v != "0", True),
    "NEXUS_TRACE_DIR": (str, ""),
    "NEXUS_OVERLAP": (_flag, False),
    "NEXUS_DECODE_STEPS": (int, 1),
    "NEXUS_STOP_TOKEN": (int, -1),
    "NEXUS_SLO_TTFT_S": (float, 0.0),
    "NEXUS_SLO_TPOT_S": (float, 0.0),
    "NEXUS_SLO_SHED_RATE": (float, 0.0),
    "NEXUS_SLO_SHORT_N": (int, 4),
    "NEXUS_SLO_LONG_N": (int, 12),
    "NEXUS_ROUTER_POLICY": (str, "pressure"),
    "NEXUS_AUTOSCALE_MIN": (int, 0),
    "NEXUS_AUTOSCALE_MAX": (int, 0),
    "NEXUS_SCALE_UP_N": (int, 3),
    "NEXUS_SCALE_DOWN_N": (int, 12),
    "NEXUS_SCALE_COOLDOWN_S": (float, 60.0),
}


@dataclass(frozen=True)
class ServeConfig:
    model: Any = field(default_factory=LlamaConfig.tiny)
    batch_size: int = 8
    prompt_len: int = 32
    gen_tokens: int = 32
    rounds: int = 10
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    heartbeat_every: int = 2
    checkpoint_dir: str = ""
    seed: int = 0
    #: weight-only quantization of the matmul weights: "" | "int8" | "int4"
    #: (NEXUS_QUANTIZE)
    quantize: str = ""
    #: int4 group size, 0 = the default 64 (NEXUS_QUANT_GROUP)
    quant_group: int = 0
    #: KV-cache quantization: "" | "int8" (NEXUS_QUANTIZE_KV)
    quantize_kv: str = ""
    #: decode-attention dispatch: "auto" (the CUDA decode kernel on the
    #: card, the plain einsum on the CPU) | "plain" (NEXUS_DECODE_KERNEL)
    decode_kernel: str = "auto"
    #: where the model runs: "cuda" (default), "cuda:N" or "cpu" (NEXUS_DEVICE)
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.checkpoint_dir:
            raise NotImplementedError(
                "checkpoint_dir (NEXUS_CHECKPOINT_DIR): restoring tensor "
                "checkpoints is not ported yet (ROADMAP.md: tensor checkpoints "
                "and hot reload)"
            )
        if self.quantize not in ("", "int8", "int4"):
            raise ValueError(f"unknown quantize mode {self.quantize!r}; use 'int8' or 'int4'")
        if self.quantize and isinstance(getattr(self.model, "config", self.model), MoeConfig):
            raise NotImplementedError(
                f"quantize={self.quantize!r} (NEXUS_QUANTIZE) with an MoE model: quantized "
                "expert stacks are not ported yet (ROADMAP.md: A5b quantized MoE serving)"
            )
        if self.quant_group < 0:
            raise ValueError(
                f"quant_group (NEXUS_QUANT_GROUP) must be >= 0, got {self.quant_group}"
            )
        if self.quant_group and self.quantize != "int4":
            # a group size silently ignored under int8/full precision would
            # let a typo'd NEXUS_QUANTIZE ship the wrong width unnoticed
            raise ValueError(
                f"quant_group (NEXUS_QUANT_GROUP={self.quant_group}) only "
                f"applies to quantize='int4', got quantize={self.quantize!r}"
            )
        if self.quantize == "int4":
            group = self.quant_group or DEFAULT_INT4_GROUP
            if group % 2:
                raise ValueError(
                    f"quant_group (NEXUS_QUANT_GROUP) must be even (two "
                    f"nibbles pack per byte within a group), got {group}"
                )
            model_cfg = getattr(self.model, "config", self.model)
            widths = []
            hidden = getattr(model_cfg, "hidden", None)
            if hidden is not None:
                widths.append((hidden, "hidden (wq/wk/wv/w_gate/w_up contraction)"))
            inter = getattr(model_cfg, "intermediate", None)
            if inter is not None:
                widths.append((inter, "intermediate (w_down contraction)"))
            hq = getattr(model_cfg, "n_heads", None)
            hd = getattr(model_cfg, "head_dim", None)
            if hq is not None and hd is not None:
                widths.append((hq * hd, "n_heads*head_dim (wo contraction)"))
            for width, what in widths:
                if width % group:
                    raise ValueError(
                        f"quant_group (NEXUS_QUANT_GROUP={group}) does not "
                        f"divide the model's {width} {what} — every "
                        "quantized contraction width must be a whole "
                        "number of groups"
                    )
        if self.quantize_kv not in ("", "int8"):
            raise ValueError(f"unknown quantize_kv mode {self.quantize_kv!r}; use 'int8'")
        if self.decode_kernel not in DECODE_IMPLS:
            raise ValueError(
                f"unknown decode_kernel mode {self.decode_kernel!r}; use "
                f"{', '.join(DECODE_IMPLS)}"
            )
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p {self.top_p} outside (0, 1]")
        if (self.top_k or self.top_p < 1.0) and self.temperature == 0.0:
            raise ValueError("top_k/top_p truncation requires temperature > 0")
        for field_name in ("batch_size", "prompt_len", "gen_tokens", "rounds"):
            if getattr(self, field_name) < 1:
                raise ValueError(
                    f"{field_name} must be >= 1, got {getattr(self, field_name)}"
                )

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "ServeConfig":
        import os

        e = os.environ if env is None else env
        for key, (parse, default) in ENGINE_ONLY_ENV.items():
            if key in e and parse(e[key]) != default:
                raise NotImplementedError(
                    f"{key}={e[key]!r} configures the continuous-batching engine "
                    "(NEXUS_MODE=serve-engine), which is not ported yet "
                    "(ROADMAP.md: serve-engine slice)"
                )
        if e.get("NEXUS_FAULT_MODE", ""):
            raise NotImplementedError(
                "NEXUS_FAULT_MODE: fault injection (workload/faults.py) is not "
                "ported yet (ROADMAP.md: serve-engine slice)"
            )
        return ServeConfig(
            model=get_adapter(e.get("NEXUS_MODEL_PRESET", "tiny")),
            batch_size=int(e.get("NEXUS_BATCH", "8")),
            prompt_len=int(e.get("NEXUS_PROMPT_LEN", "32")),
            gen_tokens=int(e.get("NEXUS_GEN_TOKENS", "32")),
            rounds=int(e.get("NEXUS_STEPS", "10")),
            temperature=float(e.get("NEXUS_TEMPERATURE", "0.0")),
            top_k=int(e.get("NEXUS_TOP_K", "0")),
            top_p=float(e.get("NEXUS_TOP_P", "1.0")),
            heartbeat_every=int(e.get("NEXUS_HEARTBEAT_EVERY", "2")),
            checkpoint_dir=e.get("NEXUS_CHECKPOINT_DIR", ""),
            seed=int(e.get("NEXUS_SEED", "0")),
            quantize=e.get("NEXUS_QUANTIZE", ""),
            quant_group=int(e.get("NEXUS_QUANT_GROUP", "0") or 0),
            quantize_kv=e.get("NEXUS_QUANTIZE_KV", ""),
            decode_kernel=e.get("NEXUS_DECODE_KERNEL", "auto"),
            device=e.get("NEXUS_DEVICE", "cuda"),
        )


def _load_serving_params(cfg: ServeConfig, ctx: ProcessContext, device: torch.device):
    """Resolve the LM adapter (llama or moe), init its params on ``device`` from
    ``cfg.seed`` and, under ``cfg.quantize``, quantize the matmul weights.
    Returns ``(adapter, model_cfg, params, restored_from)``;
    ``restored_from`` is None (checkpoint restore is a later slice)."""
    adapter = adapter_for(cfg.model)
    if not isinstance(adapter, (LlamaAdapter, MoeAdapter)):
        raise ValueError(f"serving requires an LM adapter (llama/moe), got {adapter.name!r}")
    logger.info("serving %s/%s: model %s on %s", ctx.algorithm, ctx.run_id, adapter.name, device)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    params = adapter.init(generator, device)
    if cfg.quantize:
        params = quantize_params(params, mode=cfg.quantize, group=cfg.quant_group)
        logger.info(
            "serving with %s weight-only quantization: %d weight bytes", cfg.quantize, quantized_bytes(params)
        )
    return adapter, adapter.config, params, None


@torch.inference_mode()
def run_serving(
    cfg: ServeConfig,
    store: Optional[CheckpointStore] = None,
    ctx: Optional[ProcessContext] = None,
    prompts: Optional[Any] = None,
) -> Dict[str, Any]:
    """Run the batch-decode loop under the ledger protocol; returns summary
    metrics (rounds, decoded tokens/s).  ``prompts`` is an injectable
    iterator of int32 ``[B, prompt_len]`` arrays (tests); default is the
    synthetic token stream."""
    device = resolve_device(cfg.device)
    ctx = initialize_distributed(ctx)
    reporter = LedgerReporter(store, ctx, local_devices=1)
    adapter, mcfg, params, restored_from = _load_serving_params(cfg, ctx, device)

    if prompts is None:
        prompts = adapter.data(cfg.batch_size, cfg.prompt_len, seed=cfg.seed + 101)
    sampler = torch.Generator(device=device).manual_seed(cfg.seed)

    def gen_fn(batch):
        return generate(
            params, torch.as_tensor(batch, device=device), mcfg,
            max_new_tokens=cfg.gen_tokens, temperature=cfg.temperature,
            top_k=cfg.top_k, top_p=cfg.top_p,
            generator=sampler if cfg.temperature > 0.0 else None,
            kv_quant=cfg.quantize_kv, decode_kernel=cfg.decode_kernel,
        )

    reporter.running()
    # untimed warmup: the first call builds the CUDA kernels and warms the
    # allocator, which would otherwise dominate the throughput metric
    gen_fn(next(prompts))
    _sync(device)
    t0 = time.perf_counter()
    tokens_done = 0
    last = None
    for r in range(cfg.rounds):
        last = gen_fn(next(prompts))
        tokens_done += last.numel()
        if cfg.heartbeat_every and (r + 1) % cfg.heartbeat_every == 0:
            _sync(device)
            reporter.heartbeat(r + 1)
            logger.info("round %d: %d tokens decoded", r + 1, tokens_done)
    _sync(device)
    elapsed = time.perf_counter() - t0
    reporter.heartbeat(cfg.rounds)
    if ctx.is_coordinator:
        reporter.completed()
    calls = cfg.rounds + 1  # the warmup included
    return {
        "rounds": cfg.rounds,
        "restored_from": restored_from,
        "elapsed_s": elapsed,
        "decoded_tokens_per_second": tokens_done / elapsed if elapsed > 0 else 0.0,
        "last_tokens_shape": tuple(last.shape) if last is not None else None,
        "device": str(device),
        "prefill_calls": calls,
        "decode_steps": calls * (cfg.gen_tokens - 1),
    }
