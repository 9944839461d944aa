"""Continuous-batching serving engine (iteration-level scheduling): the
port of ``tpu_nexus/serving``, ``NEXUS_MODE=serve-engine``.

Layering (each module imports only downward), as in the JAX package:

* ``request``        — Request + the total lifecycle state machine
* ``cache_manager``  — slot free-list, the paged layer (ref-counted KV
                       block allocator, radix-style prefix index,
                       copy-on-write, composed by PagedCacheManager) and
                       the int8-aware cache buffers on a torch device
* ``scheduler``      — FIFO admission, prefill-token budget, starvation
                       guard, bounded queue, deadline sweep, block gate
* ``metrics``        — TTFT/TPOT/queue-depth/occupancy/shed/fault counters
* ``loadstats``      — the pressure plane: LoadSnapshot/FleetSnapshot and
                       the windowed burn-rate SloMonitor
* ``speculative``    — drafters and the verify-k acceptance oracle
* ``router``         — fleet admission + autoscale policy: pressure/
                       affinity/load candidate ranking, shed-and-retry
                       elsewhere by the ROUTE_ELIGIBILITY table;
                       SCALE_DECISIONS and AutoscaleConfig, which the
                       fleet supervisor acts on
* ``handoff``        — the KV handoff payload protocol between prefill
                       and decode replicas (host form: CPU tensors of the
                       pool's dtype, CRC over their raw bytes)
* ``recovery``       — taxonomy-classified step-fault retry/retire policy
* ``tracing``        — per-request span timelines and the flight recorder
* ``overlap``        — deferred-dispatch bookkeeping
* ``engine``         — ModelExecutor / PagedModelExecutor (PyTorch, the
                       CUDA kernels on the card; the paged one also
                       extracts and installs handed-off KV blocks) +
                       ServingEngine (host loop)
* ``fleet``          — ServingFleet: replicas behind the router,
                       disaggregated prefill/decode with the KV handoff,
                       zero-drop rolling weight updates; CheckpointWatcher;
                       FleetSupervisor, the Kubernetes reconciler
                       (taxonomy-classified pod recovery, missing-pod
                       sweep, checkpoint-driven rollout, autoscaling)

Every module but ``engine``, ``sharded`` and the cache buffers of
``cache_manager`` is a copy of the JAX package's host code with its
imports changed (``handoff`` also takes the port's host form of a leaf).
``sharded`` (tensor/expert-parallel executors over ``torch.distributed``
ranks) is imported from its module, not from this package.
Comments in the copies that name nxlint rules (NX005, NX014, ...) describe
the JAX package's static gates: nxlint scans ``tpu_nexus/`` only.
"""

from tpu_nexus_torch.serving.cache_manager import (
    SCRATCH_BLOCK,
    AdmitPlan,
    BlockError,
    KVBlockManager,
    KVSlotManager,
    PagedCacheManager,
    PrefixIndex,
    SlotError,
    init_cache,
    init_paged_cache,
)
from tpu_nexus_torch.serving.engine import (
    RETIREMENT_ACTIONS,
    ModelExecutor,
    PagedModelExecutor,
    ServingEngine,
)
from tpu_nexus_torch.serving.fleet import (
    CAUSE_REPLICA_LOST,
    CheckpointWatcher,
    EngineReplica,
    FleetError,
    FleetSupervisor,
    ServingFleet,
)
from tpu_nexus_torch.serving.handoff import (
    HANDOFF_CAUSE_ACTIONS,
    HANDOFF_DECISIONS,
    HANDOFF_FAULT_CAUSES,
    REPLICA_ROLES,
    ROLE_DECODE,
    ROLE_FUSED,
    ROLE_PREFILL,
    DisaggConfig,
    HandoffAction,
    HandoffError,
    HandoffExhausted,
    HandoffPolicy,
    KVHandoffPayload,
    PayloadCorrupt,
    PeerLost,
    TransferDropped,
    handoff_cause_action,
    handoff_decision,
    validate_payload,
)
from tpu_nexus_torch.serving.loadstats import (
    PRESSURE_ACTIONS,
    PRESSURE_DOWN,
    PRESSURE_HEALTHY,
    PRESSURE_PRESSURED,
    PRESSURE_SATURATED,
    PRESSURE_SEVERITY,
    PRESSURE_STATES,
    FleetSnapshot,
    LoadSnapshot,
    SloMonitor,
    SloTargets,
    emit_fleet_snapshot,
    emit_load_snapshot,
    worst_pressure,
)
from tpu_nexus_torch.serving.metrics import RollingQuantile, ServingMetrics, percentile
from tpu_nexus_torch.serving.router import (
    ELIGIBILITY_RANK,
    ROUTE_ELIGIBILITY,
    ROUTER_POLICIES,
    ROUTER_PRESSURE,
    ROUTER_ROUND_ROBIN,
    SCALE_DECISIONS,
    SCALE_DOWN_WHEN_IDLE,
    SCALE_HOLD,
    SCALE_UP,
    AutoscaleConfig,
    FleetRouter,
    load_score,
)
from tpu_nexus_torch.serving.overlap import DispatchPipeline, PendingStep, PipelineError
from tpu_nexus_torch.serving.speculative import (
    DRAFTERS,
    Drafter,
    ModelDrafter,
    NGramDrafter,
    accept_tokens,
)
from tpu_nexus_torch.serving.recovery import DeviceStateLost, StepFault, StepFaultPolicy
from tpu_nexus_torch.serving.request import (
    ACTIVE_STATES,
    TERMINAL_STATES,
    TRANSITIONS,
    IllegalTransition,
    Request,
    RequestState,
)
from tpu_nexus_torch.serving.scheduler import FifoScheduler, QueueFull, SchedulerConfig
from tpu_nexus_torch.serving.tracing import (
    DeviceProfiler,
    EngineTracer,
    FlightRecorder,
    NullTracer,
    RequestTrace,
)

__all__ = [
    "ACTIVE_STATES",
    "AdmitPlan",
    "AutoscaleConfig",
    "BlockError",
    "CAUSE_REPLICA_LOST",
    "CheckpointWatcher",
    "DRAFTERS",
    "DeviceProfiler",
    "DeviceStateLost",
    "DisaggConfig",
    "DispatchPipeline",
    "Drafter",
    "ELIGIBILITY_RANK",
    "EngineReplica",
    "EngineTracer",
    "FifoScheduler",
    "FleetError",
    "FleetRouter",
    "FleetSnapshot",
    "FleetSupervisor",
    "FlightRecorder",
    "HANDOFF_CAUSE_ACTIONS",
    "HANDOFF_DECISIONS",
    "HANDOFF_FAULT_CAUSES",
    "HandoffAction",
    "HandoffError",
    "HandoffExhausted",
    "HandoffPolicy",
    "IllegalTransition",
    "KVBlockManager",
    "KVHandoffPayload",
    "KVSlotManager",
    "LoadSnapshot",
    "ModelDrafter",
    "ModelExecutor",
    "NGramDrafter",
    "NullTracer",
    "PRESSURE_ACTIONS",
    "PRESSURE_DOWN",
    "PRESSURE_HEALTHY",
    "PRESSURE_PRESSURED",
    "PRESSURE_SATURATED",
    "PRESSURE_SEVERITY",
    "PRESSURE_STATES",
    "PagedCacheManager",
    "PagedModelExecutor",
    "PayloadCorrupt",
    "PeerLost",
    "PendingStep",
    "PipelineError",
    "PrefixIndex",
    "QueueFull",
    "REPLICA_ROLES",
    "RETIREMENT_ACTIONS",
    "ROLE_DECODE",
    "ROLE_FUSED",
    "ROLE_PREFILL",
    "ROUTER_POLICIES",
    "ROUTER_PRESSURE",
    "ROUTER_ROUND_ROBIN",
    "ROUTE_ELIGIBILITY",
    "Request",
    "RequestState",
    "RequestTrace",
    "RollingQuantile",
    "SCALE_DECISIONS",
    "SCALE_DOWN_WHEN_IDLE",
    "SCALE_HOLD",
    "SCALE_UP",
    "SCRATCH_BLOCK",
    "SchedulerConfig",
    "ServingEngine",
    "ServingFleet",
    "ServingMetrics",
    "SloMonitor",
    "SloTargets",
    "SlotError",
    "StepFault",
    "StepFaultPolicy",
    "TERMINAL_STATES",
    "TRANSITIONS",
    "TransferDropped",
    "accept_tokens",
    "emit_fleet_snapshot",
    "emit_load_snapshot",
    "handoff_cause_action",
    "handoff_decision",
    "init_cache",
    "init_paged_cache",
    "load_score",
    "percentile",
    "validate_payload",
    "worst_pressure",
]
