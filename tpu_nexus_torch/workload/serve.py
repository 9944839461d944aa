"""Serving workload: supervised batch inference, the port of
``tpu_nexus/workload/serve.py`` — the lockstep loop (``NEXUS_MODE=serve``,
:func:`run_serving`) and the continuous-batching engine
(``NEXUS_MODE=serve-engine``, :func:`run_serve_engine`, tpu_nexus_torch/
serving: per-request admission, slot refill every iteration, the paged KV
cache with shared-prefix reuse, speculative decoding, overlapped and
multi-step dispatch, fault isolation and graceful drain).

Same ledger protocol as the reference (RUNNING → heartbeats with per-chip
progress → COMPLETED, or PREEMPTED after a drain) and the same returned
summaries; the inner loop runs on one CUDA device, or on the CPU when the
caller asks for it (``NEXUS_DEVICE=cpu``).  A CUDA request on a machine
without a card raises: it never carries on on the CPU.

Quantized serving: ``NEXUS_QUANTIZE=int8|int4`` (with
``NEXUS_QUANT_GROUP`` for int4) quantizes the matmul weights after init, so
each decode step's weight products run through the dequant-matmul kernels
(ops/quant_matmul.py); ``NEXUS_QUANTIZE_KV=int8`` keeps the KV cache int8.
Bad values fail at parse with the reference's wording.

The MoE presets serve through the same loop (``models/generate.py``
decodes them with scatter dispatch at a dropless capacity), quantized too:
the expert stacks ``[L, E, K, N]`` keep per-expert scales and are
dequantized before their einsum, while the attention projections of a
decode step take the dequant-matmul kernels.

``NEXUS_PROFILE_DIR`` (serve-engine) arms the device profiler over engine
iterations ``[NEXUS_PROFILE_START, NEXUS_PROFILE_START +
NEXUS_PROFILE_STEPS)`` (``serving/tracing.py::DeviceProfiler``).

Engine knobs (``NEXUS_PAGE_SIZE``, ``NEXUS_KV_BLOCKS``, ``NEXUS_SPEC_K``,
``NEXUS_SPEC_DRAFTER``, ``NEXUS_OVERLAP``, ``NEXUS_DECODE_STEPS``,
``NEXUS_STOP_TOKEN``, ``NEXUS_DEADLINE_S``, ``NEXUS_QUEUE_LIMIT``,
``NEXUS_DRAIN_GRACE_S``, ``NEXUS_TRACE*``, ``NEXUS_SLO_*``) and the serving
fault modes (``NEXUS_FAULT_MODE``, workload/faults.py) parse and validate
with the reference's wording, as do the fleet's ``NEXUS_ROUTER_POLICY``,
``NEXUS_AUTOSCALE_MIN``/``_MAX``, ``NEXUS_SCALE_UP_N``/``_DOWN_N`` and
``NEXUS_SCALE_COOLDOWN_S``, which :func:`build_fleet_supervisor` reads
(with ``NEXUS_SLO_*`` and ``NEXUS_KV_BLOCKS``) into a ``ServingFleet`` and
the ``FleetSupervisor`` that reconciles it.

Sharded serving (serve-engine): ``NEXUS_SERVE_MESH="tp=2"`` (or any
axes of ``parallel/mesh.py``'s AXIS_ORDER: ``"ep=2,tp=2"``,
``"dp=2,tp=2"``; pp, dp, fsdp and sp replicate, as in the reference)
parses and validates with the reference's checks and words
(``serving/sharded.py``), against the cards torch sees times the launched
processes — one card a rank — or, with ``NEXUS_RANK_DEVICE_MAP=shared``,
every rank on ``NEXUS_DEVICE`` (the one-device rehearsal over gloo, asked
for explicitly).  :func:`run_serve_engine` then starts the replica's shard
workers itself (``spawn``), drives the unchanged engine over a sharded
executor, and stops them at the end; a lost worker fails the run
(``ShardLost``: the row FAILED, the container non-zero) within the process
group's timeout (``NEXUS_DIST_TIMEOUT_S``).

A launched world of processes (``NEXUS_NUM_PROCESSES`` > 1, the JobSet's
``NEXUS_PROCESS_ID`` and ``NEXUS_COORDINATOR_ADDRESS``): every process
writes RUNNING and heartbeats its own ``host<p>/chip<i>`` keys, and only
the coordinator writes the terminal row.  Without a serve mesh each
process serves its own copy on its own device (the lockstep loop never
reads the mesh, as the reference's); the processes meet only at a
rendezvous at start, as the reference's ``jax.distributed.initialize``.
With a serve mesh the replica spans the processes: process 0 leads it,
the others run their ranks' worker loops (heartbeating the leader's engine
iterations, which each call's header carries) until the leader stops
them; a SIGTERM there is recorded and the worker serves on through the
leader's drain.

Checkpoints: ``NEXUS_CHECKPOINT_DIR`` serves the params of the training
run's newest VERIFIED step (read-only: a torn or corrupt step is skipped,
never quarantined; steps that exist but none verify refuse to serve fresh
weights).  ``NEXUS_RELOAD_CHECK_S`` (serve-engine) polls that directory
and hot-swaps each newer verified step into the running engine through
the quiesce seam — in-flight requests finish on the old weights.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_nexus_torch.checkpoint.store import CheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext, setup_signal_context
from tpu_nexus_torch.models.generate import DECODE_IMPLS, generate
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.models.quant import DEFAULT_INT4_GROUP, quantize_params, quantized_bytes
from tpu_nexus_torch.models.registry import LlamaAdapter, MoeAdapter, adapter_for, get_adapter
from tpu_nexus_torch.ops.decode_attention import MAX_DECODE_Q_LEN
from tpu_nexus_torch.parallel import distributed
from tpu_nexus_torch.parallel.distributed import RANK_MAPS, ProcessContext
from tpu_nexus_torch.serving.loadstats import SloTargets
from tpu_nexus_torch.serving.router import ROUTER_POLICIES, AutoscaleConfig
from tpu_nexus_torch.serving.speculative import DRAFTERS
from tpu_nexus_torch.workload.faults import FaultPlan, maybe_inject
from tpu_nexus_torch.workload.harness import LedgerReporter, resolve_device
from tpu_nexus_torch.workload.harness import sync as _sync
from tpu_nexus_torch.workload.tensor_checkpoint import CheckpointError, TensorCheckpointer

logger = logging.getLogger(__name__)


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
    #: engine mode only — per-request latency budget in seconds; requests
    #: that outlive it (queued OR decoding) retire EVICTED with cause
    #: "deadline exceeded"; 0 = no deadline (NEXUS_DEADLINE_S)
    deadline_s: float = 0.0
    #: engine mode only — bounded admission queue: submits beyond this are
    #: SHED (serving.shed counter); 0 = unbounded (NEXUS_QUEUE_LIMIT)
    queue_limit: int = 0
    #: engine mode only — graceful-drain grace budget after SIGTERM: in-flight
    #: requests get this many seconds to finish before being evicted with an
    #: honest cause (NEXUS_DRAIN_GRACE_S)
    drain_grace_s: float = 5.0
    #: engine mode only — KV paging: > 0 switches the engine to the paged
    #: executor with this many tokens per KV block (block-table decode
    #: through the kernel's paged mode, ref-counted shared-prefix reuse,
    #: copy-on-write).  0 = contiguous whole-row slots (NEXUS_PAGE_SIZE)
    page_size: int = 0
    #: engine mode only, paged only — physical KV block count (``kv_blocks
    #: × page_size`` cache rows + 1 scratch block); 0 = full occupancy
    #: (NEXUS_KV_BLOCKS)
    kv_blocks: int = 0
    #: engine mode only — speculative decoding: > 0 proposes this many draft
    #: tokens per slot per step and verifies them in ONE q_len = spec_k+1
    #: call (the kernel's q_starts mode).  Greedy-only.  0 = off (NEXUS_SPEC_K)
    spec_k: int = 0
    #: engine mode only — "ngram" (prompt lookup) or "model" (a draft model
    #: through a second executor; NEXUS_SPEC_DRAFT_PRESET names its preset,
    #: empty = self-draft with the serving params) (NEXUS_SPEC_DRAFTER)
    spec_drafter: str = "ngram"
    #: draft-model preset for spec_drafter="model" (NEXUS_SPEC_DRAFT_PRESET)
    spec_draft_preset: str = ""
    #: engine mode only — overlapped dispatch: step N+1 dispatches while
    #: step N's tokens are still on the device; results materialize one
    #: step late (NEXUS_OVERLAP)
    overlap_dispatch: bool = False
    #: engine mode only — decode steps per dispatch, with stop detection on
    #: the device and per-row early freeze (NEXUS_DECODE_STEPS)
    decode_steps: int = 1
    #: engine mode only — stop-token id; -1 = disabled (NEXUS_STOP_TOKEN)
    stop_token: int = -1
    #: engine mode only — request-span tracing + flight recorder, DEFAULT ON;
    #: NEXUS_TRACE=0 opts out
    trace_enabled: bool = True
    #: where flight-recorder artifacts land; "" = NEXUS_TRACE_DIR else
    #: <tmpdir>/tpu-nexus-traces (NEXUS_TRACE_DIR)
    trace_dir: str = ""
    #: SLO targets for the pressure plane (serving/loadstats.py): TTFT/TPOT
    #: p99 ceilings in seconds and a shed-rate ceiling; all 0 disables the
    #: monitor (NEXUS_SLO_TTFT_S / NEXUS_SLO_TPOT_S / NEXUS_SLO_SHED_RATE)
    slo_ttft_s: float = 0.0
    slo_tpot_s: float = 0.0
    slo_shed_rate: float = 0.0
    #: burn windows in OBSERVATIONS (serve loop: heartbeat intervals;
    #: fleet: reconciles) — short detects, long confirms; validated
    #: short <= long (NEXUS_SLO_SHORT_N / NEXUS_SLO_LONG_N)
    slo_short_window: int = 4
    slo_long_window: int = 12
    #: engine mode only — train-to-serve continuous deployment: every N
    #: seconds, check ``checkpoint_dir`` for a newer VERIFIED step and
    #: hot-swap it in (quiesce → swap_params → resume).  0 = off
    #: (NEXUS_RELOAD_CHECK_S; requires NEXUS_CHECKPOINT_DIR)
    reload_check_interval_s: float = 0.0
    #: fleet mode — how the fleet router ranks candidate replicas
    #: (serving/router.py): "pressure" (SLO grade tier -> shared-prefix
    #: affinity -> load score) or "round-robin" (the plain rotation, kept
    #: as the bench baseline).  Validated against
    #: serving.router.ROUTER_POLICIES at parse (NEXUS_ROUTER_POLICY)
    router_policy: str = "pressure"
    #: fleet mode — supervisor-driven autoscaling bounds: both 0 disables
    #: (a fixed fleet); both > 0 enables with min <= live replicas <= max.
    #: Requires NEXUS_SLO_* targets — the scale decisions are SloMonitor
    #: grades mapped through the SCALE_DECISIONS table, so without a
    #: monitor the autoscaler would silently never act (an explicitly
    #: requested feature must run or refuse).
    #: (NEXUS_AUTOSCALE_MIN / NEXUS_AUTOSCALE_MAX)
    autoscale_min: int = 0
    autoscale_max: int = 0
    #: fleet mode — autoscale hysteresis: consecutive reconciles the
    #: scale verdict must hold before acting (scale-down additionally
    #: requires the fleet idle), and the cooldown between actions
    #: (NEXUS_SCALE_UP_N / NEXUS_SCALE_DOWN_N / NEXUS_SCALE_COOLDOWN_S)
    scale_up_after: int = 3
    scale_down_after: int = 12
    scale_cooldown_s: float = 60.0
    #: engine mode only — tensor/expert-parallel serving: comma-separated
    #: ``axis=size`` pairs over parallel/mesh.py's AXIS_ORDER, e.g. "tp=2"
    #: ("" = one device; pp/dp/fsdp/sp replicate).  Validated at parse;
    #: the lockstep loop does not read it (NEXUS_SERVE_MESH)
    serve_mesh: str = ""
    #: where the mesh's ranks run: "" = one card a rank (nccl); "shared" =
    #: every rank on ``device`` over gloo, the one-device rehearsal
    #: (NEXUS_RANK_DEVICE_MAP)
    rank_map: str = ""

    def __post_init__(self) -> None:
        if self.quantize not in ("", "int8", "int4"):
            raise ValueError(f"unknown quantize mode {self.quantize!r}; use 'int8' or 'int4'")
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
        self._validate_engine()

    def _validate_engine(self) -> None:
        """The reference's validation of the engine knobs, same wording."""
        for field_name in (
            "deadline_s",
            "queue_limit",
            "drain_grace_s",
            "page_size",
            "kv_blocks",
            "spec_k",
            "reload_check_interval_s",
        ):
            if getattr(self, field_name) < 0:
                raise ValueError(
                    f"{field_name} must be >= 0, got {getattr(self, field_name)}"
                )
        if self.decode_steps < 1:
            raise ValueError(
                f"decode_steps (NEXUS_DECODE_STEPS) must be >= 1, got "
                f"{self.decode_steps}"
            )
        if self.stop_token < -1:
            raise ValueError(
                f"stop_token (NEXUS_STOP_TOKEN) must be -1 (disabled) or a "
                f"token id >= 0, got {self.stop_token}"
            )
        if self.spec_k and (self.overlap_dispatch or self.decode_steps > 1):
            # the speculative acceptance rule runs on host — exactly the
            # per-step readback overlap/multi-step exist to hide
            raise ValueError(
                "speculative decoding (NEXUS_SPEC_K > 0) is mutually "
                "exclusive with NEXUS_OVERLAP/NEXUS_DECODE_STEPS > 1 until "
                "in-device acceptance lands"
            )
        if self.spec_k and self.stop_token >= 0:
            raise ValueError(
                "stop_token (NEXUS_STOP_TOKEN) with speculative decoding is "
                "not composed yet — the acceptance rule would emit past an "
                "accepted stop token"
            )
        if self.spec_k:
            if self.spec_k + 1 > MAX_DECODE_Q_LEN:
                raise ValueError(
                    f"spec_k {self.spec_k} exceeds the decode kernel's "
                    f"verify width (spec_k + 1 <= {MAX_DECODE_Q_LEN})"
                )
            if self.temperature > 0.0:
                raise ValueError(
                    "speculative decoding (NEXUS_SPEC_K > 0) is greedy-only "
                    "for now: temperature > 0 requires rejection sampling"
                )
            if self.spec_drafter not in DRAFTERS:
                raise ValueError(
                    f"unknown spec_drafter {self.spec_drafter!r}; use one "
                    f"of {sorted(DRAFTERS)}"
                )
            if self.spec_draft_preset and self.spec_drafter != "model":
                raise ValueError(
                    "spec_draft_preset (NEXUS_SPEC_DRAFT_PRESET) only "
                    "applies to spec_drafter='model'"
                )
        if self.rank_map not in RANK_MAPS:
            raise ValueError(
                f"unknown rank_map (NEXUS_RANK_DEVICE_MAP) {self.rank_map!r}; use 'shared' or leave it unset"
            )
        if self.serve_mesh:
            from tpu_nexus_torch.serving.sharded import parse_serve_mesh, validate_serve_mesh

            # parse + validate the WHOLE mesh contract here, as the
            # reference does: axes, sizes, the device count and the
            # model's divisibility fail before any device work starts
            axes = parse_serve_mesh(self.serve_mesh)
            model_cfg = getattr(self.model, "config", self.model)
            validate_serve_mesh(
                axes, model_cfg, n_devices=self._mesh_devices(axes),
                quantize=self.quantize, quant_group=self.quant_group,
            )
        if self.rank_map and not self.serve_mesh:
            raise ValueError(
                "rank_map (NEXUS_RANK_DEVICE_MAP) places the ranks of a serve mesh: it needs NEXUS_SERVE_MESH"
            )
        if self.reload_check_interval_s and not self.checkpoint_dir:
            raise ValueError(
                "reload_check_interval_s (NEXUS_RELOAD_CHECK_S) requires "
                "checkpoint_dir (NEXUS_CHECKPOINT_DIR) — there is no "
                "directory to watch for new verified steps"
            )
        if self.kv_blocks and not self.page_size:
            raise ValueError(
                "kv_blocks (NEXUS_KV_BLOCKS) requires page_size "
                "(NEXUS_PAGE_SIZE) > 0 — the block budget is meaningless "
                "without paging"
            )
        if self.kv_blocks == 1:
            raise ValueError(
                "kv_blocks must be 0 (full occupancy) or >= 2 "
                "(scratch block 0 + one usable), got 1"
            )
        # SloTargets owns the window/burn/target invariants: building one
        # at parse is the validation, so a bad NEXUS_SLO_* env dies here
        # in both the serve loop and the fleet controller
        if self.router_policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router_policy (NEXUS_ROUTER_POLICY) "
                f"{self.router_policy!r}; use one of {ROUTER_POLICIES}"
            )
        if (self.autoscale_min > 0) != (self.autoscale_max > 0):
            raise ValueError(
                "autoscale bounds come as a pair: set BOTH "
                "NEXUS_AUTOSCALE_MIN and NEXUS_AUTOSCALE_MAX > 0 (enabled) "
                f"or neither (disabled), got min={self.autoscale_min} "
                f"max={self.autoscale_max}"
            )
        # AutoscaleConfig owns the bounds/streak/cooldown invariants —
        # constructing one at parse IS the validation (the SloTargets
        # discipline), so a bad NEXUS_AUTOSCALE_*/NEXUS_SCALE_* dies here
        if self.autoscale_config() is not None and self.slo_targets() is None:
            raise ValueError(
                "autoscaling (NEXUS_AUTOSCALE_MIN/MAX) requires NEXUS_SLO_* "
                "targets — scale decisions are SLO-monitor grades, and "
                "without a monitor the autoscaler would never act"
            )
        if self.slo_targets() is not None and not self.heartbeat_every:
            raise ValueError(
                "NEXUS_SLO_* targets require a heartbeat cadence "
                "(NEXUS_HEARTBEAT_EVERY > 0) — the SLO monitor observes "
                "at heartbeat intervals and would otherwise never grade"
            )

    def _mesh_devices(self, axes: Dict[str, int]) -> int:
        """The devices a serve mesh may take: the cards torch sees in each
        launched process (one a rank) times ``NEXUS_NUM_PROCESSES`` (the
        reference's global ``jax.device_count()``), one on the CPU — or,
        under the rehearsal map, as many as the mesh has ranks, all on one
        device."""
        import os

        if self.rank_map == "shared":
            size = 1
            for v in axes.values():
                size *= v
            return size
        if torch.device(self.device).type == "cpu":
            return 1
        return torch.cuda.device_count() * int(os.environ.get(distributed.ENV_NUM_PROCESSES, "1"))

    def slo_targets(self) -> Optional[SloTargets]:
        """The validated :class:`SloTargets`, or None when every target is
        0 (monitor disabled)."""
        if not (self.slo_ttft_s or self.slo_tpot_s or self.slo_shed_rate):
            return None
        return SloTargets(
            ttft_p99_s=self.slo_ttft_s,
            tpot_p99_s=self.slo_tpot_s,
            shed_rate=self.slo_shed_rate,
            short_window=self.slo_short_window,
            long_window=self.slo_long_window,
        )

    def autoscale_config(self) -> Optional[AutoscaleConfig]:
        """The validated :class:`AutoscaleConfig`, or None when the bounds
        are 0 (disabled)."""
        if not self.autoscale_min and not self.autoscale_max:
            return None
        return AutoscaleConfig(
            min_replicas=self.autoscale_min,
            max_replicas=self.autoscale_max,
            scale_up_after=self.scale_up_after,
            scale_down_after=self.scale_down_after,
            cooldown_s=self.scale_cooldown_s,
        )

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "ServeConfig":
        import os

        e = os.environ if env is None else env
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
            deadline_s=float(e.get("NEXUS_DEADLINE_S", "0")),
            queue_limit=int(e.get("NEXUS_QUEUE_LIMIT", "0")),
            drain_grace_s=float(e.get("NEXUS_DRAIN_GRACE_S", "5.0")),
            page_size=int(e.get("NEXUS_PAGE_SIZE", "0")),
            kv_blocks=int(e.get("NEXUS_KV_BLOCKS", "0")),
            spec_k=int(e.get("NEXUS_SPEC_K", "0")),
            spec_drafter=e.get("NEXUS_SPEC_DRAFTER", "ngram"),
            spec_draft_preset=e.get("NEXUS_SPEC_DRAFT_PRESET", ""),
            trace_enabled=e.get("NEXUS_TRACE", "1") != "0",
            trace_dir=e.get("NEXUS_TRACE_DIR", ""),
            overlap_dispatch=e.get("NEXUS_OVERLAP", "") not in ("", "0"),
            decode_steps=int(e.get("NEXUS_DECODE_STEPS", "1")),
            stop_token=int(e.get("NEXUS_STOP_TOKEN", "-1")),
            slo_ttft_s=float(e.get("NEXUS_SLO_TTFT_S", "0")),
            slo_tpot_s=float(e.get("NEXUS_SLO_TPOT_S", "0")),
            slo_shed_rate=float(e.get("NEXUS_SLO_SHED_RATE", "0")),
            slo_short_window=int(e.get("NEXUS_SLO_SHORT_N", "4")),
            slo_long_window=int(e.get("NEXUS_SLO_LONG_N", "12")),
            reload_check_interval_s=float(e.get("NEXUS_RELOAD_CHECK_S", "0")),
            router_policy=e.get("NEXUS_ROUTER_POLICY", "pressure"),
            autoscale_min=int(e.get("NEXUS_AUTOSCALE_MIN", "0")),
            autoscale_max=int(e.get("NEXUS_AUTOSCALE_MAX", "0")),
            scale_up_after=int(e.get("NEXUS_SCALE_UP_N", "3")),
            scale_down_after=int(e.get("NEXUS_SCALE_DOWN_N", "12")),
            scale_cooldown_s=float(e.get("NEXUS_SCALE_COOLDOWN_S", "60")),
            serve_mesh=e.get("NEXUS_SERVE_MESH", ""),
            rank_map=e.get("NEXUS_RANK_DEVICE_MAP", ""),
        )


def build_fleet_supervisor(
    cfg: ServeConfig,
    client: Any,
    store: CheckpointStore,
    namespace: str,
    jobset_name: str,
    algorithm: str,
    replica_factory: Any,
    **supervisor_kwargs: Any,
):
    """The serving fleet and its reconciler as ``cfg`` configures them:
    a ``ServingFleet`` routing by ``cfg.router_policy``, and a
    ``FleetSupervisor`` over the JobSet ``jobset_name`` whose SLO monitor
    (``cfg.slo_targets()``; the router grades candidates off the same
    one), autoscaler (``cfg.autoscale_config()``) and starting KV budget
    (``cfg.kv_blocks``, None when 0) come from the config.
    ``supervisor_kwargs`` go to ``FleetSupervisor`` as they are (source,
    watcher, grace_s, missing_after_s, ...).  The fleet is
    ``supervisor.fleet``; adopt the JobSet's pods with
    ``supervisor.adopt_pods`` once its informers have synced."""
    from tpu_nexus_torch.serving.fleet import FleetSupervisor, ServingFleet
    from tpu_nexus_torch.serving.loadstats import SloMonitor

    targets = cfg.slo_targets()
    fleet = ServingFleet(policy=cfg.router_policy)
    return FleetSupervisor(
        client, store, namespace, fleet, jobset_name, algorithm, replica_factory,
        kv_blocks=cfg.kv_blocks or None,
        slo=SloMonitor(targets) if targets is not None else None,
        autoscale=cfg.autoscale_config(),
        **supervisor_kwargs,
    )


def _load_serving_params(cfg: ServeConfig, ctx: ProcessContext, device: torch.device):
    """Shared serving preamble for both loops: resolve the LM adapter (llama
    or moe), restore the params of the newest verified step of
    ``cfg.checkpoint_dir`` onto ``device`` (params only, template-free) or
    else init them from ``cfg.seed``, and, under ``cfg.quantize``, quantize
    the matmul weights.  Returns ``(adapter, model_cfg, params,
    restored_from)``."""
    adapter = adapter_for(cfg.model)
    if not isinstance(adapter, (LlamaAdapter, MoeAdapter)):
        raise ValueError(f"serving requires an LM adapter (llama/moe), got {adapter.name!r}")
    logger.info("serving %s/%s: model %s on %s", ctx.algorithm, ctx.run_id, adapter.name, device)
    params = None
    restored_from: Optional[int] = None
    if cfg.checkpoint_dir:
        ckpt = TensorCheckpointer(cfg.checkpoint_dir)
        # verified restore, read-only flavor: a torn/corrupt latest step is
        # skipped (rolled back) but NOT quarantined — the training run owns
        # mutation of its checkpoint directory, serving only reads it
        latest = ckpt.latest_verified_step(quarantine=False)
        for event in ckpt.rollbacks:
            logger.warning(
                "serving restore rolled past unverifiable checkpoint step "
                "%(step)s (%(cause)s): %(detail)s", event,
            )
        if latest is not None:
            # params-only, template-free: serve must not assume the training
            # run's TrainConfig (its opt-state structure is irrelevant here)
            params = ckpt.restore_params(latest, device=device)
            restored_from = latest
            logger.info("restored verified tensor checkpoint at step %d", latest)
        elif ckpt.rollbacks:
            # steps exist but NONE verify: falling back to fresh weights
            # would start a healthy-looking engine that serves garbage
            causes = ", ".join(f"step {e['step']}: {e['cause']}" for e in ckpt.rollbacks)
            raise CheckpointError(
                f"{cfg.checkpoint_dir} has checkpoint steps but none verify "
                f"({causes}); refusing to serve freshly-initialized weights. "
                "Pre-durability checkpoints need `python -m "
                "tpu_nexus_torch.workload.durability adopt` first (docs/RUNBOOK.md §11)."
            )
    if params is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        params = adapter.init(generator, device)
    if cfg.quantize:
        params = quantize_params(params, mode=cfg.quantize, group=cfg.quant_group)
        logger.info(
            "serving with %s weight-only quantization: %d weight bytes", cfg.quantize, quantized_bytes(params)
        )
    return adapter, adapter.config, params, restored_from


def _reload_if_newer(
    engine: Any,
    latest: Optional[int],
    checkpoint_dir: str,
    current_step: Optional[int],
    quantize: str,
    grace_s: float,
) -> Optional[int]:
    """One reload decision (``reload_check_interval_s`` cadence):
    ``latest`` is the watcher's newest VERIFIED step — when it is newer
    than ``current_step``, hot-swap it into the running engine — quiesce
    (in-flight requests finish on the OLD weights, grace-bounded),
    ``swap_params``, resume.  Returns the step now serving.

    ``quantize`` is the serving config's weight-only quantization mode
    (``""`` for none).  The restored tree is handed over plain and the
    engine's ``swap_params`` applies its executor's quantization, so a
    ``quantize`` that differs from the executor's is refused: the candidate
    would not be served the way the caller configured.  The params land on
    the executor's device.

    Trust anchors, in order: the watcher's ``latest_verified_step`` only
    sees steps with a commit marker (a torn save does not exist here), and
    ``restore_params`` deep-verifies manifest + checksums at load time — a
    candidate that rotted between poll and load is skipped with the engine
    untouched (still serving the old verified weights), never half-loaded.
    A candidate that verifies but does not FIT (model config changed) is
    likewise skipped with the engine resumed on its old weights; the caller
    remembers the bad step so a failed candidate costs one attempt, not one
    per poll."""
    if latest is None or (current_step is not None and latest <= current_step):
        return current_step
    serving_quantize = getattr(engine.executor, "quantize", quantize)
    if serving_quantize != quantize:
        logger.error(
            "reload check: candidate step %d asked for quantize=%r but the engine "
            "serves quantize=%r; keeping current weights (step %s)",
            latest, quantize, serving_quantize, current_step,
        )
        return current_step
    ckpt = TensorCheckpointer(checkpoint_dir)
    try:
        try:
            if getattr(engine.executor, "swaps_from_checkpoint", False):
                # a sharded replica: each rank reads its own slice
                new_params = ckpt.params_ref(latest)
            else:
                new_params = ckpt.restore_params(latest, device=engine.executor.device)
        except (CheckpointError, ValueError) as exc:  # noqa: BLE001 - classified Checkpoint* verdict (failed load-time verification): keep serving the OLD verified weights — the honest alternative to serving torn tensors
            logger.warning(
                "reload check: candidate step %d failed verification/"
                "transform (%s); keeping current weights (step %s)",
                latest, exc, current_step,
            )
            return current_step
        summary = engine.quiesce(grace_s)
        try:
            engine.swap_params(new_params)
        except ValueError as exc:  # noqa: BLE001 - tree spec mismatch (training changed the model config — a config fact): resume on the OLD weights instead of crashing the serving loop with admission paused
            engine.resume_admission()
            logger.error(
                "reload check: candidate step %d verified but its params do "
                "not fit this engine (%s); keeping current weights (step %s)",
                latest, exc, current_step,
            )
            return current_step
        engine.resume_admission()
        logger.info(
            "hot-reloaded verified checkpoint step %s -> %d (%s)",
            current_step, latest, summary,
        )
        return latest
    finally:
        ckpt.close()


@contextlib.contextmanager
def _launched_processes(ctx: ProcessContext):
    """The launched processes' rendezvous at the start of a serving loop
    (``distributed.process_rendezvous``); their group is left on the way
    out.  Nothing else waits on it: each process's copy ends on its own."""
    met = distributed.process_rendezvous(ctx, distributed.timeout_from_env())
    try:
        yield
    finally:
        if met:
            import torch.distributed as dist

            dist.destroy_process_group()


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
    synthetic token stream.  Each launched process serves on its own
    device; ``cfg.serve_mesh`` is not read here (the reference's loop
    never reads it)."""
    device = resolve_device(cfg.device)
    if cfg.serve_mesh:
        logger.info("the lockstep loop does not read NEXUS_SERVE_MESH=%s: serving on %s", cfg.serve_mesh, device)
    ctx = ctx or distributed.process_context_from_env()
    reporter = LedgerReporter(store, ctx, local_devices=distributed.local_devices(cfg.device))
    plan = FaultPlan.from_env()
    with _launched_processes(ctx):
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
        # untimed warmup: the first call builds the CUDA kernels and warms
        # the allocator, which would otherwise dominate the throughput metric
        gen_fn(next(prompts))
        _sync(device)
        t0 = time.perf_counter()
        tokens_done = 0
        last = None
        for r in range(cfg.rounds):
            maybe_inject(plan, r)
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


def _sharded_param_source(cfg: ServeConfig, ctx: ProcessContext):
    """The sharded counterpart of :func:`_load_serving_params`: the adapter
    and config, and WHERE each rank reads its slice — the newest verified
    step of ``cfg.checkpoint_dir`` (``CheckpointParams``) or the init of
    ``cfg.seed`` (``SeedParams``); the leader loads nothing whole.
    Returns ``(adapter, model_cfg, source, restored_from)``."""
    from tpu_nexus_torch.serving.sharded import CheckpointParams, SeedParams

    adapter = adapter_for(cfg.model)
    if not isinstance(adapter, (LlamaAdapter, MoeAdapter)):
        raise ValueError(f"serving requires an LM adapter (llama/moe), got {adapter.name!r}")
    logger.info("serving %s/%s: model %s over %s", ctx.algorithm, ctx.run_id, adapter.name, cfg.serve_mesh)
    if cfg.checkpoint_dir:
        ckpt = TensorCheckpointer(cfg.checkpoint_dir)
        try:
            latest = ckpt.latest_verified_step(quarantine=False)
            if latest is not None:
                return adapter, adapter.config, CheckpointParams(cfg.checkpoint_dir, latest), latest
            if ckpt.rollbacks:
                causes = ", ".join(f"step {e['step']}: {e['cause']}" for e in ckpt.rollbacks)
                raise CheckpointError(
                    f"{cfg.checkpoint_dir} has checkpoint steps but none verify "
                    f"({causes}); refusing to serve freshly-initialized weights."
                )
        finally:
            ckpt.close()
    return adapter, adapter.config, SeedParams(cfg.seed), None


def run_serve_engine(
    cfg: ServeConfig,
    store: Optional[CheckpointStore] = None,
    ctx: Optional[ProcessContext] = None,
    prompts: Optional[Any] = None,
    lifecycle: Optional[LifecycleContext] = None,
    pool: Any = None,
) -> Dict[str, Any]:
    """Continuous-batching serving under the SAME ledger protocol as
    :func:`run_serving` (``NEXUS_MODE=serve-engine``): RUNNING →
    per-iteration heartbeats → COMPLETED, with ``FaultPlan`` injection
    keyed on engine iterations.

    Traffic shape mirrors the lockstep loop: ``rounds * batch_size``
    requests of ``prompt_len`` prompt tokens and ``gen_tokens`` generated
    tokens each, over ``batch_size`` KV slots — but admission is
    per-request and per-iteration, so slots refill the moment a request
    retires.  Returns the reference's summary (TTFT/TPOT p50/p99 beside
    throughput) plus the device it ran on.

    Fault isolation: step faults are classified and recovered inside the
    engine (transient → retry, fatal → per-request FAILED); SIGTERM/SIGINT
    cancels ``lifecycle`` and triggers the graceful drain — stop admission,
    finish what fits in ``cfg.drain_grace_s``, evict the rest, and land the
    ledger row PREEMPTED with the per-cause retirement counts.
    ``lifecycle`` is injectable for tests; by default signal handlers
    install when running on the main thread (and are restored on exit).

    ``cfg.serve_mesh``: the replica's shard workers are started here and
    stopped on the way out, unless the caller hands in a running
    ``pool`` (``serving/sharded.py::RankPool``, kept running): then the
    replica's executor stays up too, returned as ``summary["replica"]``
    for the caller to drive further and close.  In a launched world of
    processes the replica spans them: process 0 leads it (its summary is
    the engine's), every other process serves its ranks until the leader
    stops them (:func:`_serve_mesh_worker`).  Without a mesh each process
    serves its own copy."""
    import signal as _signal
    import threading

    device = resolve_device(cfg.device)
    ctx = ctx or distributed.process_context_from_env()
    plan = None
    if cfg.serve_mesh and pool is None and ctx.num_processes > 1:
        from tpu_nexus_torch.parallel.mesh import AXIS_ORDER
        from tpu_nexus_torch.serving.sharded import parse_serve_mesh

        axes = parse_serve_mesh(cfg.serve_mesh)
        plan = distributed.rank_plan(ctx, [axes.get(a, 1) for a in AXIS_ORDER], str(device), cfg.rank_map)
    reporter = LedgerReporter(store, ctx, local_devices=plan.local if plan else distributed.local_devices(cfg.device))
    fault_plan = FaultPlan.from_env()
    restore_handlers = {}
    if lifecycle is None:
        on_main = threading.current_thread() is threading.main_thread()
        if on_main:
            restore_handlers = {s: _signal.getsignal(s) for s in (_signal.SIGINT, _signal.SIGTERM)}
        lifecycle = setup_signal_context(install=on_main)
    own_pool = None
    try:
        if plan is not None and not ctx.is_coordinator:
            return _serve_mesh_worker(cfg, ctx, plan, reporter, lifecycle)
        if cfg.serve_mesh and pool is None:
            from tpu_nexus_torch.serving.sharded import RankPool, parse_serve_mesh

            if plan is not None:
                # process 0 of a replica across the launched processes: its
                # local ranks are spawned here, the others' join its group
                pool = own_pool = RankPool(plan=plan)
            else:
                size = 1
                for v in parse_serve_mesh(cfg.serve_mesh).values():
                    size *= v
                # this container is one replica: its shard workers are
                # local ranks, started here and stopped on the way out
                pool = own_pool = RankPool(size, device=str(device), rank_map=cfg.rank_map)
        # a replica's processes meet in its pool; without a mesh, at their own rendezvous
        with contextlib.nullcontext() if cfg.serve_mesh else _launched_processes(ctx):
            summary = _serve_engine_loop(cfg, ctx, prompts, lifecycle, reporter, fault_plan, device,
                                         pool if cfg.serve_mesh else None)
        if own_pool is not None:
            summary.pop("replica")  # stopped with its pool below
        return summary
    except Exception as exc:
        from tpu_nexus_torch.serving.sharded import ShardLost

        if isinstance(exc, ShardLost) and ctx.is_coordinator:
            # never carry on with fewer ranks: the row ends FAILED here,
            # naming the ranks that stopped answering, and the container
            # exits non-zero
            lost = pool.lost_ranks() if pool is not None else []
            named = f"rank(s) {lost} stopped answering; " if lost else ""
            reporter.failed(cause=f"sharded serving lost a rank: {named}{exc}")
        raise
    finally:
        if own_pool is not None:
            own_pool.close()
        for sig, handler in restore_handlers.items():
            _signal.signal(sig, handler)


def _serve_mesh_worker(
    cfg: ServeConfig, ctx: ProcessContext, plan: Any, reporter: LedgerReporter, lifecycle: LifecycleContext
) -> Dict[str, Any]:
    """Process ``ctx.process_id`` > 0 of a replica across the launched
    processes: RUNNING, then its ranks' worker loops
    (``serving/sharded.py::serve_launched_ranks``) until the leader stops
    them, heartbeating its keys at the leader's engine iterations (each
    call's header carries one), every ``cfg.heartbeat_every``, as the
    leader does.  A SIGTERM (a JobSet preemption signals every pod) is
    recorded and changes nothing: the
    ranks keep answering the leader's drain, and the process returns once
    the leader stops them.  The terminal row is the coordinator's."""
    from tpu_nexus_torch.serving.sharded import serve_launched_ranks

    reporter.running()
    seen = 0

    def beat(iteration: int) -> None:
        nonlocal seen
        if iteration > seen:
            seen = iteration
            if cfg.heartbeat_every and iteration % cfg.heartbeat_every == 0:
                reporter.heartbeat(iteration)

    first = ctx.process_id * plan.local
    logger.info("serving ranks %d..%d of a replica over %s led by process 0",
                first, first + plan.local - 1, cfg.serve_mesh)
    t0 = time.perf_counter()
    serve_launched_ranks(plan, ctx.process_id, distributed.timeout_from_env(), on_call=beat)
    if lifecycle.cancelled:
        logger.warning("%s: served on through the leader's drain", lifecycle.reason or "shutdown requested")
    return {
        "process_id": ctx.process_id,
        "ranks": list(range(first, first + plan.local)),
        "engine_iterations": seen,
        "elapsed_s": time.perf_counter() - t0,
        "drained": lifecycle.cancelled,
        "device": str(plan.devices[0]),
    }


def _serve_engine_loop(
    cfg: ServeConfig,
    ctx: ProcessContext,
    prompts: Optional[Any],
    lifecycle: LifecycleContext,
    reporter: LedgerReporter,
    plan: FaultPlan,
    device: torch.device,
    pool: Any = None,
) -> Dict[str, Any]:
    from tpu_nexus_torch.core.telemetry import StatsdClient
    from tpu_nexus_torch.serving import (
        EngineTracer,
        FifoScheduler,
        FlightRecorder,
        ModelDrafter,
        ModelExecutor,
        NGramDrafter,
        NullTracer,
        PagedModelExecutor,
        QueueFull,
        RequestState,
        SchedulerConfig,
        ServingEngine,
        ServingMetrics,
    )
    from tpu_nexus_torch.serving.tracing import DeviceProfiler
    from tpu_nexus_torch.workload.faults import wrap_executor

    # live DogStatsD emission, fire-and-forget: an absent agent drops
    # datagrams, never raises into the serving loop
    statsd = StatsdClient(
        "tpu_nexus.workload",  # metric names carry their own serving. prefix
        static_tags={"algorithm": ctx.algorithm, "run_id": ctx.run_id},
    )
    if pool is None:
        adapter, mcfg, params, restored_from = _load_serving_params(cfg, ctx, device)
    else:
        adapter, mcfg, params, restored_from = _sharded_param_source(cfg, ctx)
    if prompts is None:
        prompts = adapter.data(cfg.batch_size, cfg.prompt_len, seed=cfg.seed + 101)

    executor_kwargs = dict(
        num_slots=cfg.batch_size,
        max_len=cfg.prompt_len + cfg.gen_tokens,
        kv_quant=cfg.quantize_kv,
        # weight-only quantization is an EXECUTOR property: it re-applies it
        # at every swap_params (idempotent over the tree loaded here)
        quantize=cfg.quantize,
        quant_group=cfg.quant_group,
        decode_kernel=cfg.decode_kernel,
        temperature=cfg.temperature,
        top_k=cfg.top_k,
        top_p=cfg.top_p,
        seed=cfg.seed,
        decode_steps=cfg.decode_steps,
        stop_token=cfg.stop_token,
    )
    # a draft preset over another vocab is refused before any device work
    draft_adapter, draft_cfg = None, mcfg
    if cfg.spec_k and cfg.spec_drafter == "model" and cfg.spec_draft_preset:
        draft_adapter = adapter_for(get_adapter(cfg.spec_draft_preset))
        draft_cfg = draft_adapter.config
        if draft_cfg.vocab_size != mcfg.vocab_size:
            raise ValueError(
                f"spec_draft_preset {cfg.spec_draft_preset!r} vocab "
                f"{draft_cfg.vocab_size} != serving model vocab "
                f"{mcfg.vocab_size}"
            )
    if pool is not None:
        # tensor/expert-parallel serving: the same engine over a sharded
        # executor whose shard workers each read their own slice
        from tpu_nexus_torch.serving.sharded import (
            ShardedModelExecutor,
            ShardedPagedModelExecutor,
            parse_serve_mesh,
        )

        mesh = pool.mesh(parse_serve_mesh(cfg.serve_mesh))
        device = mesh.device
        if cfg.page_size:
            executor = ShardedPagedModelExecutor(
                params, mcfg, mesh=mesh, page_size=cfg.page_size, num_blocks=cfg.kv_blocks, **executor_kwargs,
            )
        else:
            executor = ShardedModelExecutor(params, mcfg, mesh=mesh, **executor_kwargs)
        logger.info("serving sharded over %s: %d ranks (%s)", cfg.serve_mesh, mesh.size, pool.backend)
    elif cfg.page_size:
        # paged KV: block-table decode + ref-counted shared-prefix reuse;
        # NEXUS_KV_BLOCKS caps the physical pool
        executor = PagedModelExecutor(
            params, mcfg, page_size=cfg.page_size, num_blocks=cfg.kv_blocks, **executor_kwargs,
        )
    else:
        executor = ModelExecutor(params, mcfg, **executor_kwargs)
    drafter = None
    if cfg.spec_k:
        # speculative decoding (greedy-only, validated at parse): ngram needs
        # no weights; the model drafter runs a contiguous executor over the
        # draft preset's weights (empty preset = self-draft).  Beside a
        # sharded executor the draft is a plain one-device executor on the
        # leader's device, as in the JAX package: a self-draft loads the
        # whole tree there from the replica's ParamSource (quantized as the
        # one-device loop serves it), while the serving slices stay on
        # their ranks
        if cfg.spec_drafter == "ngram":
            drafter = NGramDrafter(cfg.batch_size)
        else:
            if draft_adapter is not None:
                draft_params = draft_adapter.init(torch.Generator(device=device).manual_seed(cfg.seed), device)
            elif pool is not None:
                draft_params = params.whole(mcfg, device)
                if cfg.quantize:
                    draft_params = quantize_params(draft_params, mode=cfg.quantize, group=cfg.quant_group)
            else:
                draft_params = params
            draft_executor = ModelExecutor(
                draft_params, draft_cfg,
                # the draft runs full precision: its budget is acceptance
                **dict(executor_kwargs, kv_quant="", quantize="", quant_group=0),
            )
            drafter = ModelDrafter(draft_executor)
    # observability, DEFAULT ON — NEXUS_TRACE=0 swaps in the NullTracer
    tracer = (
        EngineTracer(recorder=FlightRecorder(dump_dir=cfg.trace_dir or None))
        if cfg.trace_enabled
        else NullTracer()
    )
    engine = ServingEngine(
        executor,
        scheduler=FifoScheduler(SchedulerConfig(max_queue=cfg.queue_limit)),
        spec_k=cfg.spec_k,
        drafter=drafter,
        overlap=cfg.overlap_dispatch,
        tracer=tracer,
    )

    reporter.running()
    # untimed warmup: one short request builds the CUDA kernels and warms
    # the allocator, which would otherwise dominate small-run throughput
    warm = np.asarray(next(prompts))
    engine.submit(warm[0], min(2, cfg.gen_tokens), request_id="warmup-0")
    engine.run_until_drained()
    _sync(device)
    n_warm = len(engine.retired)
    engine.metrics = metrics = ServingMetrics(statsd)  # drop warmup samples
    # chaos seam AFTER warmup, so NEXUS_FAULT_STEP counts served decode
    # steps on the same zero base as the iteration counter below
    engine.executor = wrap_executor(plan, executor)

    # on-demand device profiling: NEXUS_PROFILE_DIR arms a torch.profiler
    # capture around engine steps [NEXUS_PROFILE_START, NEXUS_PROFILE_START
    # + NEXUS_PROFILE_STEPS): host and (on the card) kernel activity
    profiler = DeviceProfiler.from_env(cuda=device.type == "cuda")

    # the pressure plane (NEXUS_SLO_*): grade this engine as a fleet-of-one
    # every heartbeat interval; observation reads materialized host state
    slo_monitor = None
    slo_targets = cfg.slo_targets()
    if slo_targets is not None:
        from tpu_nexus_torch.serving.loadstats import FleetSnapshot, SloMonitor

        slo_monitor = SloMonitor(slo_targets, metrics=statsd)

        def observe_slo() -> None:
            snap = engine.load_snapshot(replica="engine")
            for tr in slo_monitor.observe(FleetSnapshot.aggregate({"engine": snap})):
                logger.warning(
                    "serving pressure transition: %s %s -> %s (%s)",
                    tr["scope"], tr["from"], tr["to"],
                    tr.get("violated", tr.get("cause", "")),
                )
                if "dump" in tr["action"] and tr["scope"] == "engine":
                    engine.dump_pressure(f"slo-{tr['to']}:engine")
    else:

        def observe_slo() -> None:
            return None

    t0 = time.perf_counter()
    deadline_s = cfg.deadline_s or None
    # iteration counter from 0, NOT engine.steps (warmup already advanced
    # it): NEXUS_FAULT_STEP keys off the same zero-based count
    it = 0

    # train-to-serve continuous deployment: watch checkpoint_dir for newly
    # COMMITTED steps and hot-reload them through the quiesce seam.  The
    # watcher is an interval gate over a fingerprint-cached verified-step
    # poll (a steady-state check is a listdir + stats, not a re-hash)
    reload_watcher = None
    serving_step = restored_from
    if cfg.reload_check_interval_s:
        from tpu_nexus_torch.serving.fleet import CheckpointWatcher

        reload_watcher = CheckpointWatcher(cfg.checkpoint_dir, interval_s=cfg.reload_check_interval_s)

    # (step, poller scan count) of a candidate that failed its load/fit:
    # shunned while the directory is unchanged, re-earned ONE attempt by
    # any commit/quarantine (scan count bump) — a step RE-committed after
    # a quarantine-and-retrain cycle must not be refused forever
    bad_reload: Optional[tuple] = None

    def pump() -> None:
        nonlocal it, serving_step, bad_reload
        maybe_inject(plan, it, executor_faults_handled=True)
        if reload_watcher is not None:
            latest = reload_watcher.check()
            scans = reload_watcher.poller.scans
            if bad_reload is not None and (latest, scans) == bad_reload:
                latest = None  # known-bad candidate, directory unchanged
            reloaded = _reload_if_newer(
                engine, latest, cfg.checkpoint_dir, serving_step, cfg.quantize, cfg.drain_grace_s,
            )
            if reloaded != serving_step:
                serving_step = reloaded
            elif latest is not None and (serving_step is None or latest > serving_step):
                # a newer candidate was offered but NOT adopted: it failed
                # verification or did not fit — remember it so the reload
                # check does not pay a failed load (or a quiesce) per poll
                bad_reload = (latest, scans)
        if profiler is not None:
            profiler.tick(it)
        if pool is not None:
            executor.iteration = it + 1  # the shard workers' heartbeats count it too
        engine.step()
        it += 1
        if cfg.heartbeat_every and it % cfg.heartbeat_every == 0:
            reporter.heartbeat(it)
            observe_slo()

    for _ in range(cfg.rounds):
        if lifecycle.cancelled:
            break  # admission stops the moment shutdown is requested
        for row in np.asarray(next(prompts)):
            while not lifecycle.cancelled:
                try:
                    engine.submit(row, cfg.gen_tokens, deadline_s=deadline_s)
                    break
                except QueueFull:  # noqa: BLE001 - backpressure IS the handled outcome: every rejection is counted on serving.shed, then this closed-loop client retries after pumping the engine
                    if not engine.has_work:
                        break  # nothing to pump — drop rather than spin
                    pump()
    while engine.has_work and not lifecycle.cancelled:
        pump()
    if profiler is not None:
        profiler.stop()  # close a capture the run finished inside of
    _sync(device)
    elapsed = time.perf_counter() - t0

    drain_summary: Dict[str, Any] = {}
    if lifecycle.cancelled:
        # graceful drain: finish what fits in the grace budget, evict the
        # rest with honest causes, then report PREEMPTED + per-cause counts
        drain_summary = engine.drain(cfg.drain_grace_s)
        it += drain_summary["drain_steps"]
        _sync(device)
        elapsed = time.perf_counter() - t0
        cause = f"serving drain: {lifecycle.reason or 'shutdown requested'}"
        logger.warning(
            "%s — %s; retirement causes: %s", cause, drain_summary, metrics.retired_causes,
        )
        reporter.heartbeat(it)
        if ctx.is_coordinator:
            details = {
                "retired_states": metrics.retired,
                "retired_causes": metrics.retired_causes,
                "load_snapshot": engine.load_snapshot().to_dict(),
                **drain_summary,
            }
            if tracer.enabled:
                details["flight_recorder"] = tracer.recorder.summary()
            if slo_monitor is not None:
                details["pressure"] = slo_monitor.summary()
            reporter.preempted(cause=cause, details=json.dumps(details, sort_keys=True))
    else:
        reporter.heartbeat(it)
        if ctx.is_coordinator:
            details = {"load_snapshot": engine.load_snapshot().to_dict()}
            if slo_monitor is not None:
                details["pressure"] = slo_monitor.summary()
            reporter.completed(details=json.dumps(details, sort_keys=True))

    done = engine.retired[n_warm:]
    finished = [r for r in done if r.state == RequestState.FINISHED]
    tokens_done = sum(len(r.output_tokens) for r in finished)
    sharded: Dict[str, Any] = {}
    if pool is not None:
        # every rank's launches, collectives and peak memory; the replica
        # stays up until its pool's owner closes it
        sharded["shard_stats"] = executor.shard_stats()
        sharded["replica"] = executor
    return {
        **sharded,
        "requests": len(done),
        "finished": len(finished),
        "spec_k": cfg.spec_k,
        "restored_from": restored_from,
        "serving_step": serving_step,
        "weight_reloads": engine.weight_swaps,
        "engine_steps": it,
        "elapsed_s": elapsed,
        "decoded_tokens_per_second": tokens_done / elapsed if elapsed > 0 else 0.0,
        "drained": lifecycle.cancelled,
        "load_snapshot": engine.load_snapshot().to_dict(),
        "pressure": slo_monitor.summary() if slo_monitor is not None else None,
        "flight_recorder": tracer.recorder.summary() if tracer.enabled else None,
        # the profiler window's outcome, so a drill can read it from the
        # summary without walking the trace directory
        "profiler": profiler.summary() if profiler is not None else None,
        "device": str(device),
        **drain_summary,
        **metrics.summary(),
    }
