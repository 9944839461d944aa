"""The workload run loop: the port of ``tpu_nexus/workload/harness.py`` —
train, heartbeat, checkpoint, die honestly — on one device or on a
training mesh of ranks across launched processes.

Cooperation contract with the supervisor, as the reference's:

* on start: transition the ledger row to RUNNING (first-writer-wins);
* every ``heartbeat_every`` steps: write this process's per-chip step
  counters into ``per_chip_steps`` (ledger merge, not overwrite);
* every ``checkpoint_every`` steps: save the train state with the data
  cursor, run the durability barrier (``commit()``: manifest + read-back)
  and only THEN record ``tensor_checkpoint_uri`` — the ledger never points
  at an uncommitted or unverified step (nxlint NX007);
* on restore: verify the manifest first; a torn/corrupt latest step rolls
  back to the newest verifiable one, quarantined + cause recorded to
  metrics and the ledger, instead of crashing or loading garbage;
* on a health anomaly: roll back to the newest verified step before the
  poisoned window, skip the window on the data cursor, and go on;
* on SIGTERM/SIGINT (preemption): stop at the next step boundary, cut an
  emergency checkpoint within ``emergency_grace_s`` (skipped when the
  same step is already durable), publish it, and land the row PREEMPTED
  with the saved step and the goodput in the details;
* on clean exit: COMPLETED with the goodput accounting and any rollback
  evidence in the details (only if not already terminal — a cancelled
  run stays CANCELLED);
* on crash: raise, with a failure-trace artifact written and its
  reference both in the ledger (``hlo_trace_ref``) and in the raised text,
  where the supervisor's taxonomy classifies the cause.  A CUDA
  out-of-memory error is re-raised in the taxonomy's HBM-OOM wording.

The train step writes the state in place (``workload/train.py``), unlike
the reference's pure step.  So the step-hang watchdog's emergency save
cannot take an immutable snapshot: the loop holds ``state_lock`` while a
step writes the state (from the step call until the cursor snapshot of
its end is recorded), and the hang handler saves only if it can take that
lock — a hang inside the window saves nothing (``emergency_step: null``).

``NEXUS_PROFILE_DIR`` arms the device profiler
(``serving/tracing.py::DeviceProfiler``, the serving stack's hook) over
train steps ``[NEXUS_PROFILE_START, NEXUS_PROFILE_START +
NEXUS_PROFILE_STEPS)``; the first iteration (kernel build, allocator
warm-up) is never in the window.

A mesh (``NEXUS_MESH``, default ``fsdp=-1`` over every rank, rules
``LOGICAL_RULES_FSDP_TP``) of more than one rank trains on ranks: this
process runs ``local`` of them (``parallel/distributed.py::
rank_plan``), the first in this process, the others spawned
(:func:`_local_rank`), all running this loop on their shards
(``workload/train.py``).  As in the reference:

* data: in the batch-rows mode each process draws its ``B / P`` rows with
  seed ``seed + process_id``; when a non-batch axis spans processes
  (:func:`_nonbatch_axis_spans_processes`) every process draws the whole
  global batch with the base seed.  Each rank keeps its rows (``to_rank``);
* ``sync_flags``: cancel and anomaly are max-reduced over the world at
  one loop point, so every rank stops, or rolls back, together;
* the process's first rank writes the heartbeats of all its ranks
  (``host<p>/chip<j>``); quarantines, rollback counters and the terminal
  row are the coordinator's (global rank 0) alone, the terminal row after
  every process's final heartbeat and a barrier;
* checkpoints: every rank takes part in a save (its shards gathered
  whole), the coordinator writes the one-device layout and commits; every
  rank restores its slice;
* a local rank that dies fails the container non-zero (the next
  collective fails, or times out at ``NEXUS_DIST_TIMEOUT_S``).

A mesh with ``pp > 1`` trains through the pipeline (``NEXUS_PP_MICROBATCHES``,
0 = the reference's auto pick); as in the reference its rule table then
cuts the layer stacks over ``pp``.  Every stage draws the same global
batch (``pp`` spans the processes, so the replicated mode), a rank keeps
its share of every microbatch (``train.batch_rows``), and the loss, the
goodput and the completion barrier are the same on every stage (the last
stage's loss is broadcast).  On a mesh the step-hang watchdog's
emergency save is skipped: it would need collectives of wedged peers.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from dataclasses import dataclass, field, replace
from datetime import datetime, timezone
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import CheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext, setup_signal_context
from tpu_nexus_torch.core.telemetry import Metrics, StatsdClient
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.parallel.distributed import ProcessContext, RankPlan, process_context_from_env, rank_plan
from tpu_nexus_torch.parallel.mesh import AXIS_ORDER, MeshSpec, mesh_coords
from tpu_nexus_torch.parallel.sharding import LOGICAL_RULES_FSDP_TP, RuleTable, batch_axes
from tpu_nexus_torch.workload import durability
from tpu_nexus_torch.workload.faults import (
    FaultPlan,
    checkpoint_fault_hook,
    maybe_inject,
    wrap_data_stream,
)
from tpu_nexus_torch.workload.goodput import (
    BUCKET_CKPT,
    BUCKET_DATA,
    BUCKET_EMERGENCY,
    BUCKET_EVAL,
    BUCKET_INIT,
    BUCKET_OTHER,
    BUCKET_RECOVERY,
    BUCKET_STEP,
    build_meter,
)
from tpu_nexus_torch.workload.health import (
    CAUSE_NUMERIC_NAN,
    CAUSE_STEP_HANG,
    STEP_HANG_EXIT_CODE,
    Anomaly,
    HealthConfig,
    HealthMonitor,
    HealthPolicy,
    StepWatchdog,
    classified_failure_text,
    hang_cause,
)
from tpu_nexus_torch.workload.tensor_checkpoint import CheckpointError, TensorCheckpointer
from tpu_nexus_torch.workload.train import TrainConfig, default_rules

logger = logging.getLogger(__name__)


def resolve_device(name: str) -> torch.device:
    """``NEXUS_DEVICE`` → a torch device; ``cuda`` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested (NEXUS_DEVICE) but torch sees no CUDA "
            "device; set NEXUS_DEVICE=cpu to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}; use cuda[:N] or cpu")
    return device


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rollback_record(events) -> list:
    """Ledger-details shape of restore-time rollback events: bounded detail
    strings (the ledger column is not a log sink)."""
    return [dict(e, detail=str(e.get("detail", ""))[:200]) for e in events]


class LedgerReporter:
    """Writes the run's lifecycle + heartbeats via COLUMN-level writes (N
    hosts may report one run concurrently, so whole-row upserts would
    clobber each other's columns).  ``local_devices`` is the number of
    CUDA devices this process drives: one heartbeat key per device."""

    def __init__(
        self, store: Optional[CheckpointStore], ctx: ProcessContext, local_devices: int = 1
    ) -> None:
        self.store = store
        self.ctx = ctx
        self.local_devices = local_devices

    def _guarded_update(self, fields: Dict[str, Any]) -> None:
        """Update columns unless the run is already terminal (IsFinished
        guard: never resurrect/mutate a cancelled or finished run)."""
        if self.store is None:
            return
        cp = self.store.read_checkpoint(self.ctx.algorithm, self.ctx.run_id)
        if cp is None:
            cp = CheckpointedRequest(algorithm=self.ctx.algorithm, id=self.ctx.run_id)
            self.store.upsert_checkpoint(cp)
        elif cp.is_finished():
            return
        fields = dict(fields, last_modified=datetime.now(timezone.utc))
        self.store.update_fields(self.ctx.algorithm, self.ctx.run_id, fields)

    def running(self) -> None:
        if self.store is None:
            return
        cp = self.store.read_checkpoint(self.ctx.algorithm, self.ctx.run_id)
        stage = cp.lifecycle_stage if cp else LifecycleStage.NEW
        if cp is not None and cp.is_finished():
            return
        if LifecycleStage.can_transition(stage, LifecycleStage.RUNNING):
            self._guarded_update({"lifecycle_stage": LifecycleStage.RUNNING})

    def _chip_steps(self, step: int) -> Dict[str, int]:
        return {self.ctx.chip_key(i): int(step) for i in range(self.local_devices)}

    def heartbeat(self, step: int) -> None:
        # per-key merge, NOT a row RMW: each host owns only its own chip keys
        if self.store is None:
            return
        cp = self.store.read_checkpoint(self.ctx.algorithm, self.ctx.run_id)
        if cp is None or cp.is_finished():
            return  # IsFinished guard: no heartbeats onto terminal rows
        self.store.merge_chip_steps(self.ctx.algorithm, self.ctx.run_id, self._chip_steps(step))

    def tensor_checkpoint(self, uri: str, step: int) -> None:
        """Publish a checkpoint pointer; callers hold the durability
        barrier (the URI names a committed, verified step)."""
        self._guarded_update({"tensor_checkpoint_uri": uri})
        self.heartbeat(step)

    def checkpoint_rollback(self, uri: str, step: int, events) -> None:
        """Restore-time rollback: repoint the ledger at the step actually
        restored and record why in the details column."""
        details = json.dumps({"ckpt_rollback": _rollback_record(events)})
        self._guarded_update(
            {"tensor_checkpoint_uri": uri, "algorithm_failure_details": details}
        )
        self.heartbeat(step)

    def health_rollback(self, uri: str, step: int, details: str) -> None:
        self._guarded_update(
            {"tensor_checkpoint_uri": uri, "algorithm_failure_details": details}
        )
        self.heartbeat(step)

    def failed(self, cause: str, details: str = "") -> None:
        """Workload-side terminal failure with a classified cause."""
        fields: Dict[str, Any] = {"lifecycle_stage": LifecycleStage.FAILED}
        if cause:
            fields["algorithm_failure_cause"] = cause
        if details:
            fields["algorithm_failure_details"] = details
        self._guarded_update(fields)

    def completed(self, result_uri: str = "", details: str = "") -> None:
        """Terminal COMPLETED; ``details`` (JSON) lands in the details
        column when given."""
        fields: Dict[str, Any] = {
            "lifecycle_stage": LifecycleStage.COMPLETED,
            "result_uri": result_uri,
        }
        if details:
            fields["algorithm_failure_details"] = details
        self._guarded_update(fields)

    def preempted(self, cause: str = "", details: str = "") -> None:
        """Workload-side preemption report (PREEMPTED is non-terminal)."""
        fields: Dict[str, Any] = {"lifecycle_stage": LifecycleStage.PREEMPTED}
        if cause:
            fields["algorithm_failure_cause"] = cause
        if details:
            fields["algorithm_failure_details"] = details
        self._guarded_update(fields)

    def hlo_trace(self, uri: str) -> None:
        """Record the failure-time trace artifact ref."""
        self._guarded_update({"hlo_trace_ref": uri})


# -- the training run loop ------------------------------------------------------


def _nonbatch_axis_spans_processes(sizes: Dict[str, int], rules: RuleTable, local: int) -> bool:
    """True when a mesh axis other than the batch axes (whatever the rule
    table maps the logical "batch" axis to) places its ranks in more than
    one process (``local`` ranks a process, in rank order) — e.g. an sp
    ring whose hops cross processes.  A process's rows are then not a
    contiguous row block of the global batch."""
    batch = set(batch_axes(rules))
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    coords = [mesh_coords(r, shape) for r in range(math.prod(shape))]
    for i, name in enumerate(AXIS_ORDER):
        if name in batch or sizes[name] == 1:
            continue
        groups: Dict[tuple, set] = {}
        for r, c in enumerate(coords):
            groups.setdefault(c[:i] + c[i + 1:], set()).add(r // local)
        if any(len(procs) > 1 for procs in groups.values()):
            return True
    return False


@dataclass(frozen=True)
class WorkloadConfig:
    #: a model config (LlamaConfig, MnistConfig) or a ModelAdapter — resolved
    #: through the model registry, so any zoo model runs this harness
    model: Any = field(default_factory=LlamaConfig.tiny)
    train: TrainConfig = field(default_factory=TrainConfig)
    #: the training mesh over every rank of the launched world (one
    #: ``-1`` axis inferred) and its rule table
    mesh: MeshSpec = field(default_factory=lambda: MeshSpec(fsdp=-1))
    rules: RuleTable = field(default_factory=lambda: dict(LOGICAL_RULES_FSDP_TP))
    #: "" (one card a rank) or "shared" (every rank on one device over
    #: gloo: the rehearsal map; NEXUS_RANK_DEVICE_MAP)
    rank_map: str = ""
    batch_size: int = 8
    seq_len: int = 128
    steps: int = 20
    heartbeat_every: int = 5
    checkpoint_every: int = 0  # 0 = disabled
    checkpoint_dir: str = ""
    seed: int = 0
    #: path to a 1-D integer .npy token corpus (workload/data.py
    #: token_file_batches); empty = the adapter's synthetic stream.  LM
    #: adapters only (token batches [B, S]).
    data_path: str = ""
    #: every N train steps, run `eval_steps` loss-only batches on a
    #: held-out stream (disjoint seed) and log/report eval_loss; 0 = off
    eval_every: int = 0
    eval_steps: int = 4
    #: preemption grace budget (seconds) for the emergency checkpoint cut on
    #: SIGTERM/SIGINT, and the join timeout of the step-hang watchdog's
    #: emergency save.  The save is attempted regardless and its duration
    #: reported honestly.
    emergency_grace_s: float = 30.0
    #: numerical-health sentinel + step-hang watchdog knobs
    #: (workload/health.py; NEXUS_HEALTH*/NEXUS_STEP_TIMEOUT_S env contract)
    health: HealthConfig = field(default_factory=HealthConfig)
    #: goodput/MFU accounting (workload/goodput.py); NEXUS_GOODPUT=0 opts out
    goodput: bool = True
    #: where the run trains: "cuda" (default), "cuda:N" or "cpu" (NEXUS_DEVICE)
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got {self.checkpoint_every}")
        for name in ("batch_size", "seq_len", "steps"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "WorkloadConfig":
        """The launcher env contract, parsed in ONE place."""
        import os

        from tpu_nexus_torch.models.registry import get_adapter

        e = os.environ if env is None else env
        # NEXUS_MESH: "sp=2,fsdp=2" etc. — axis sizes for MeshSpec
        # (-1 = infer); absent -> shard everything over fsdp
        mesh_env = e.get("NEXUS_MESH", "")
        if mesh_env:
            mesh = MeshSpec(
                **{k.strip(): int(v) for k, v in
                   (pair.split("=") for pair in mesh_env.split(",") if pair.strip())}
            )
        else:
            mesh = MeshSpec(fsdp=-1)
        steps = int(e.get("NEXUS_STEPS", "100"))
        return WorkloadConfig(
            model=get_adapter(e.get("NEXUS_MODEL_PRESET", "tiny")),
            train=TrainConfig(
                warmup_steps=int(e.get("NEXUS_WARMUP_STEPS", "10")),
                total_steps=max(steps, 2),
                # sequence-parallel attention strategy: ring (default) or
                # ulysses (required for pp x sp meshes)
                sp_attn=e.get("NEXUS_SP_ATTN", "ring"),
                pp_microbatches=int(e.get("NEXUS_PP_MICROBATCHES", "0")),
                optimizer=e.get("NEXUS_OPTIMIZER", "adamw"),
            ),
            mesh=mesh,
            rank_map=e.get("NEXUS_RANK_DEVICE_MAP", ""),
            batch_size=int(e.get("NEXUS_BATCH", "8")),
            # default inside the default (tiny) preset's max_seq_len window
            seq_len=int(e.get("NEXUS_SEQ_LEN", "256")),
            steps=steps,
            heartbeat_every=int(e.get("NEXUS_HEARTBEAT_EVERY", "10")),
            checkpoint_every=int(e.get("NEXUS_CHECKPOINT_EVERY", "0")),
            checkpoint_dir=e.get("NEXUS_CHECKPOINT_DIR", ""),
            seed=int(e.get("NEXUS_SEED", "0")),
            data_path=e.get("NEXUS_DATA_PATH", ""),
            eval_every=int(e.get("NEXUS_EVAL_EVERY", "0")),
            eval_steps=int(e.get("NEXUS_EVAL_STEPS", "4")),
            emergency_grace_s=float(e.get("NEXUS_EMERGENCY_GRACE_S", "30")),
            health=HealthConfig.from_env(e),
            goodput=e.get("NEXUS_GOODPUT", "1") != "0",
            device=e.get("NEXUS_DEVICE", "cuda"),
        )


class _HostCopy(dict):
    """A step's metrics copied to the host without waiting for the step:
    the copies are queued behind the step's kernels, and reading a value
    waits only for them (one event), not for work queued after them."""

    def __init__(self, metrics: Dict[str, torch.Tensor], device: torch.device) -> None:
        super().__init__({k: v.detach().to("cpu", non_blocking=True) for k, v in metrics.items()})
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()

    def _wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def __getitem__(self, key):
        self._wait()
        return super().__getitem__(key)

    def get(self, key, default=None):
        return self[key] if key in self else default

    def items(self):
        self._wait()
        return super().items()


def classified_error_text(exc: BaseException) -> str:
    """The failure's text as the supervisor's taxonomy should read it: a
    CUDA out-of-memory error ("CUDA out of memory. Tried to allocate ...")
    matches none of its signatures, so it is prefixed with the HBM-OOM
    wording it does match; everything else keeps its text."""
    if isinstance(exc, torch.OutOfMemoryError):
        return f"RESOURCE_EXHAUSTED: device memory exhausted (CUDA out of memory): {exc}"
    return str(exc)


def _dump_failure_trace(cfg: WorkloadConfig, ctx: ProcessContext, step: int, exc: BaseException) -> str:
    """Write the failure-time trace artifact (traceback + device context) and
    return its URI (``file://...hlo``: the suffix the supervisor's trace-ref
    extractor matches).  Best-effort: a failing dump never masks the
    original error."""
    import os
    import tempfile
    import traceback

    try:
        base = cfg.checkpoint_dir or tempfile.gettempdir()
        os.makedirs(base, exist_ok=True)  # a run that fails before its first save has no directory yet
        path = f"{base}/hlo_trace_{ctx.run_id}_host{ctx.process_id}_step{step}.hlo"
        device = torch.device(cfg.device)
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(f"run={ctx.run_id} algorithm={ctx.algorithm} host={ctx.process_id} step={step}\n")
            fh.write(f"device={device} name={name} torch={torch.__version__} cuda={torch.version.cuda}\n")
            fh.write(f"model={cfg.model}\n\n")
            fh.write("".join(traceback.format_exception(exc)))
        return f"file://{path}"
    except (OSError, RuntimeError):  # pragma: no cover - trace dir unwritable / device gone
        logger.exception("failed to write failure trace")
        return ""


def _restore_train_state(
    ckpt: TensorCheckpointer, state: Dict[str, Any], step: int
) -> Dict[str, Any]:
    """Restore ``step`` into the current state template, migrating
    PRE-HEALTH checkpoints on the way: a checkpoint written before the
    state grew its ``health`` subtree (sentinel EMA scalars) fails the
    template restore with a structure mismatch; on that mismatch, restore
    the legacy structure and seed fresh sentinel state (the EMA re-warms
    over ``warmup_steps`` applied steps)."""
    from tpu_nexus_torch.workload.health import health_init

    try:
        return ckpt.restore(state, step)
    except (ValueError, KeyError, TypeError) as exc:
        if "health" not in state:
            raise
        legacy_template = {k: v for k, v in state.items() if k != "health"}
        try:
            restored = ckpt.restore(legacy_template, step)
        except (CheckpointError, OSError, ValueError, KeyError, TypeError):
            # the probe shares restore's failure surface; whichever fires,
            # surface the ORIGINAL structure error, not the probe's
            raise exc from None
        logger.info(
            "restored pre-health checkpoint at step %d (sentinel state reseeded)",
            step,
        )
        return {**restored, "health": health_init(state["step"].device)}


def _make_hang_handler(
    cfg: WorkloadConfig,
    reporter: LedgerReporter,
    ctx: ProcessContext,
    telemetry: Metrics,
    evidence: Optional[Callable[[], Dict[str, Any]]] = None,
    ckpt: Optional[TensorCheckpointer] = None,
    latest_ref: Optional[Dict[str, Any]] = None,
    state_lock: Optional[threading.Lock] = None,
):
    """Build the StepWatchdog's on_hang callback.

    Runs on the watchdog thread while the main thread is wedged mid-step;
    it never returns.  Protocol, as the reference's:

    1. with a checkpointer, attempt the emergency save of the newest
       COMPLETED state (``latest_ref["snap"]``: the state and the cursor
       state of the step's end).  The state is updated in place, so the
       save runs only when ``state_lock`` is free — the main thread holds
       it while a step writes the state — and keeps it, so a step that
       wakes up cannot write under the save.  A hang inside the window
       saves nothing.  The save runs on a helper thread with the emergency
       grace budget as a join timeout: its device-to-host copies queue
       behind the wedged step's kernels and may never finish.
    2. write the ledger row FAILED with the classified ``step-hang`` cause
       and the save outcome in the details.
    3. ``os._exit(STEP_HANG_EXIT_CODE)``: the wedged main thread cannot
       unwind, so a raw exit is the only way off the box; nonzero so the
       JobSet never mistakes the wedge for success.
    """
    import os as _os

    def _on_hang(step: int, timeout_s: float) -> None:
        # everything best-effort inside try/finally: a failing save or
        # ledger write must never skip the exit and leave the wedged
        # process alive
        try:
            _hang_protocol(step, timeout_s)
        finally:
            _os._exit(STEP_HANG_EXIT_CODE)

    def _hang_protocol(step: int, timeout_s: float) -> None:
        cause = hang_cause(step, timeout_s)
        if ctx.is_coordinator:
            telemetry.count("train.anomaly", tags={"cause": CAUSE_STEP_HANG})
        logger.error("%s — emergency save + classified exit", cause)
        info: Dict[str, Any] = {
            "hang_step": step,
            "deadline_s": timeout_s,
            "emergency_step": None,
        }
        if ckpt is not None and state_lock.acquire(blocking=False):
            # the lock stays held: the process exits below
            state, cursor_state = latest_ref["snap"]
            saved: Dict[str, Any] = {}

            def _save() -> None:
                try:
                    final_step = int(state["step"])
                    if final_step <= 0:
                        return
                    if ckpt.last_committed_step != final_step:
                        ckpt.save(final_step, state)
                        # the cursor state of the same step's end, never the
                        # live cursor: the wedge may sit after a draw
                        ckpt.save_cursor(final_step, cursor_state)
                        uri = ckpt.commit(final_step)
                        reporter.tensor_checkpoint(uri, final_step)
                    saved["step"] = final_step
                except Exception:  # noqa: BLE001 - best-effort: a wedged device hangs or fails the save; the exit below still records the hang honestly
                    logger.exception("emergency save during step-hang failed")

            t0 = time.perf_counter()
            saver = threading.Thread(target=_save, daemon=True)
            saver.start()
            saver.join(timeout=cfg.emergency_grace_s)
            info["emergency_step"] = saved.get("step")
            info["emergency_save_s"] = time.perf_counter() - t0
            telemetry.count(
                "train.emergency_save",
                tags={"skipped": "false" if saved.get("step") else "failed"},
            )
        elif ckpt is not None:
            logger.error("step-hang inside the state-write window: no consistent state to save")
        # re-merge the run's earlier recovery evidence: the details column
        # is rewritten wholesale
        payload = {**(evidence() if evidence is not None else {}), **info}
        reporter.failed(cause, details=json.dumps(payload))

    return _on_hang


def run_workload(
    cfg: WorkloadConfig,
    store: Optional[CheckpointStore] = None,
    ctx: Optional[ProcessContext] = None,
    data: Optional[Iterator[Any]] = None,
    lifecycle: Optional[LifecycleContext] = None,
    telemetry: Optional[Metrics] = None,
) -> Dict[str, Any]:
    """Run the training loop; returns summary metrics.

    ``store``/``ctx``/``data``/``lifecycle``/``telemetry`` are injectable
    for tests; production wiring reads env (launcher contract).
    ``lifecycle`` carries the preemption protocol: on SIGTERM/SIGINT the
    loop stops, cuts an emergency checkpoint inside
    ``cfg.emergency_grace_s`` (skipping a duplicate of an already-committed
    step), and lands the ledger row PREEMPTED with the saved step in the
    details.  By default signal handlers install on the main thread and
    are restored on exit."""
    restore_handlers = {}
    if lifecycle is None:
        import signal as _signal

        on_main = threading.current_thread() is threading.main_thread()
        if on_main:
            restore_handlers = {
                s: _signal.getsignal(s) for s in (_signal.SIGINT, _signal.SIGTERM)
            }
        lifecycle = setup_signal_context(install=on_main)
    try:
        ctx = ctx or process_context_from_env()
        # a pp-bearing mesh with layer stacks replicated would waste the pp
        # axis: the table is upgraded to stage-shard them, as the reference's
        cfg = replace(cfg, rules=default_rules(cfg.mesh.pp, cfg.rules))
        plan = rank_plan(ctx, cfg.mesh.sizes(), cfg.device, cfg.rank_map)
        if plan.world == 1:
            # a mesh that wants more ranks than the plan has is refused, as
            # the reference refuses it against its devices (under the
            # rehearsal map a -1 axis means one rank a process)
            cfg.mesh.resolve(plan.world)
            return _workload_loop(cfg, store, ctx, data, lifecycle, telemetry)
        if data is not None:
            raise ValueError("an injected data stream trains on one device; a mesh draws its own")
        return _run_ranks(cfg, store, ctx, plan, lifecycle, telemetry)
    finally:
        if restore_handlers:
            import signal as _signal

            for sig, handler in restore_handlers.items():
                _signal.signal(sig, handler)


@dataclass(frozen=True)
class _Rank:
    """One training rank of a launched world: its index among this
    process's ``plan.local`` ranks and its global rank."""

    plan: RankPlan
    local_index: int
    rank: int

    @property
    def device(self) -> str:
        return str(self.plan.devices[self.local_index])


def _run_ranks(
    cfg: WorkloadConfig,
    store: Optional[CheckpointStore],
    ctx: ProcessContext,
    plan: RankPlan,
    lifecycle: LifecycleContext,
    telemetry: Optional[Metrics],
) -> Dict[str, Any]:
    """This process's ranks: local ranks ``1..local-1`` spawned (each its
    own process, running :func:`_local_rank`), rank 0 here.  A local rank
    that exits non-zero fails the run."""
    import torch.multiprocessing as mp

    spawn = mp.get_context("spawn")
    procs = []
    for j in range(1, plan.local):
        proc = spawn.Process(target=_local_rank, args=(cfg, ctx, plan, j, logger.getEffectiveLevel()), daemon=True)
        proc.start()
        logger.info("started local rank %d (global %d) pid %d on %s", j, plan.global_rank(ctx, j), proc.pid,
                    plan.devices[j])
        procs.append(proc)
    import torch.distributed as dist

    from tpu_nexus_torch.parallel.distributed import timeout_from_env

    ok = False
    try:
        summary = _workload_loop(cfg, store, ctx, None, lifecycle, telemetry, rank=_Rank(plan, 0, plan.global_rank(ctx, 0)))
        ok = True
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        # a failed first rank takes its local ranks down at once (they
        # would wait in a collective until the timeout)
        deadline = time.monotonic() + (timeout_from_env() if ok else 0.0)
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
            if proc.is_alive():
                proc.kill()
                proc.join(5.0)
    failed = {j + 1: p.exitcode for j, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"local training rank(s) exited non-zero: {failed} (local index: exit code)")
    return summary


def _local_rank(cfg: WorkloadConfig, ctx: ProcessContext, plan: RankPlan, j: int, log_level: int) -> None:
    """A spawned local rank: the training loop on its shards, no ledger
    writes of its own (the process's first rank heartbeats its key), the
    preemption signals installed as in the first rank."""
    import sys

    logging.basicConfig(level=log_level, stream=sys.stderr)
    lifecycle = setup_signal_context(install=True)
    from tpu_nexus_torch.core.telemetry import NullMetrics

    _workload_loop(cfg, None, ctx, None, lifecycle, NullMetrics(), rank=_Rank(plan, j, plan.global_rank(ctx, j)))


def _workload_loop(
    cfg: WorkloadConfig,
    store: Optional[CheckpointStore],
    ctx: Optional[ProcessContext],
    data: Optional[Iterator[Any]],
    lifecycle: LifecycleContext,
    telemetry: Optional[Metrics],
    rank: Optional[_Rank] = None,
) -> Dict[str, Any]:
    from tpu_nexus_torch.models.registry import adapter_for
    from tpu_nexus_torch.workload.data import DataCursor
    from tpu_nexus_torch.workload.train import init_train_state, make_eval_step, make_train_step, train_layout

    ctx = ctx or process_context_from_env()
    mesh = None
    if rank is None:
        device = resolve_device(cfg.device)
    else:
        from tpu_nexus_torch.parallel import collectives
        from tpu_nexus_torch.parallel.distributed import start_process_group, timeout_from_env
        from tpu_nexus_torch.parallel.mesh import TrainMesh

        device = resolve_device(rank.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:  # ranks sharing the host's cores: a share each
            import os

            torch.set_num_threads(max(1, (os.cpu_count() or 1) // rank.plan.local))
        start_process_group(rank.plan.init_method, rank.rank, rank.plan.world, rank.plan.backend, timeout_from_env())
        backend = "gloo" if rank.plan.backend == "gloo" else "nccl"
        mesh = TrainMesh(cfg.mesh, backend=backend)
        if rank.plan.rank_map == "shared" and device.type == "cuda":
            # gloo's point-to-point has no device path (it reads the buffer
            # from the host): the ring's hops go through host memory; the
            # collectives gloo refuses on the card's tensors too
            found = collectives.probe(device)
            refused = sorted({k.split("/")[0] for k, v in found.items() if v != "ok"})
            if refused:
                raise RuntimeError(f"gloo refuses collectives of the train step on {device}: "
                                   f"{ {k: v for k, v in found.items() if v != 'ok'} }")
            collectives.stage_through_host(["send_recv"])
            if rank.rank == 0:
                logger.warning("rehearsal map over gloo on %s: send_recv staged through host memory", device)
    # the ledger's writers: each process's first rank heartbeats all of its
    # ranks' keys; the terminal row, quarantines and counters are the
    # coordinator's (global rank 0)
    first_local = rank is None or rank.local_index == 0
    coordinator = ctx.is_coordinator and first_local
    reporter = LedgerReporter(store if first_local else None, ctx,
                              local_devices=1 if rank is None else rank.plan.local)
    plan = FaultPlan.from_env()
    if telemetry is None:
        # live DogStatsD emission, fire-and-forget — an absent agent drops
        # datagrams, never raises
        telemetry = StatsdClient(
            "tpu_nexus.workload",
            static_tags={"algorithm": ctx.algorithm, "run_id": ctx.run_id},
        )
    adapter = adapter_for(cfg.model)
    # goodput accounting: one stopwatch, every wall second attributed to a
    # named bucket at the phase boundaries below
    meter = build_meter(cfg.goodput, adapter.config, cfg.seq_len, device, cards=_cards(device, mesh))
    meter.start()
    logger.info("workload %s/%s: model %s on %s%s", ctx.algorithm, ctx.run_id, adapter.name, device,
                f", rank {rank.rank} of mesh {mesh.describe()}" if mesh is not None else "")

    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    state = init_train_state(generator, adapter, cfg.train, device, mesh=mesh, rules=cfg.rules)
    shard = None
    if mesh is not None:
        from tpu_nexus_torch.workload.tensor_checkpoint import StateShard
        from tpu_nexus_torch.workload.train import param_leaves

        shard = StateShard(train_layout(adapter, mesh, cfg.rules),
                           [n for n, _ in param_leaves(state["params"])], writer=mesh.rank == 0)
    ckpt: Optional[TensorCheckpointer] = None
    start_step = 0
    resumed_from: Optional[int] = None
    rollback_events: list = []
    fault_hook = checkpoint_fault_hook(plan)
    if cfg.checkpoint_every and cfg.checkpoint_dir:
        ckpt = TensorCheckpointer(cfg.checkpoint_dir, fault_hook=fault_hook, shard=shard)
        # durability barrier before anything restores or re-publishes: the
        # newest VERIFIED step, quarantining torn/corrupt ones on the way
        # (one quarantine writer per run; every rank lands on the same step)
        latest = ckpt.latest_verified_step(quarantine=coordinator)
        _barrier(mesh)
        if latest is not None:
            state = _restore_train_state(ckpt, state, latest)
            start_step = latest
            resumed_from = latest
            logger.info("restored verified tensor checkpoint at step %d", latest)
        if ckpt.rollbacks:
            # corruption-tolerant restore: record WHY we are not at the
            # newest on-disk step — metrics tag per cause, ledger details,
            # and the ledger pointer repointed at the step actually restored
            rollback_events = list(ckpt.rollbacks)
            if coordinator:
                for event in rollback_events:
                    telemetry.count("train.ckpt_rollback", tags={"cause": event["cause"]})
                reporter.checkpoint_rollback(
                    ckpt.uri_for(latest) if latest is not None else "",
                    latest or 0,
                    rollback_events,
                )
    step_fn = make_train_step(adapter, cfg.train, health=cfg.health, mesh=mesh, rules=cfg.rules)

    def make_stream(batch: int, seed: int, part: str = "train"):
        """The corpus file when configured (NEXUS_DATA_PATH), else the
        adapter's synthetic data.  With a corpus AND eval enabled, the file
        splits deterministically: train windows draw from the head, eval
        from the held-out tail 2% (min one window)."""
        if cfg.data_path:
            if adapter.batch_axes() != ("batch", "seq"):
                raise ValueError(
                    "data_path requires a token-batch (LM) adapter; "
                    f"{adapter.name!r} has batch axes {adapter.batch_axes()!r}"
                )
            from tpu_nexus_torch.workload.data import token_corpus_len, token_file_batches

            start, end = 0, None
            if cfg.eval_every:
                n = token_corpus_len(cfg.data_path)
                split = min(int(n * 0.98), n - cfg.seq_len)
                if split < cfg.seq_len:
                    raise ValueError(
                        f"corpus {cfg.data_path} too small ({n} tokens) to "
                        f"hold both a train and an eval window of {cfg.seq_len}"
                    )
                start, end = (split, None) if part == "eval" else (0, split)
            return token_file_batches(
                cfg.data_path, batch, cfg.seq_len, seed=seed, start=start, end=end
            )
        return adapter.data(batch, cfg.seq_len, seed=seed)

    # cfg.batch_size is GLOBAL.  Two multi-process data modes, as the
    # reference's: batch-rows (each process draws its B / P rows, seed +
    # process_id) and replicated (a non-batch axis spans processes: every
    # process draws the whole global batch with the base seed)
    processes = ctx.num_processes if mesh is not None else 1
    replicated = processes > 1 and _nonbatch_axis_spans_processes(mesh.sizes, cfg.rules, rank.plan.local)
    stream_batch = cfg.batch_size if processes == 1 or replicated else cfg.batch_size // processes
    if data is None:
        if processes > 1 and not replicated and cfg.batch_size % processes:
            raise ValueError(f"batch {cfg.batch_size} not divisible by {processes} processes")
        data = make_stream(stream_batch, seed=cfg.seed + (0 if replicated else ctx.process_id))

    rows = None
    if mesh is not None:
        from tpu_nexus_torch.workload.train import batch_rows, take_rows

        rows = batch_rows(cfg.batch_size, mesh, cfg.train, cfg.rules)
        if stream_batch != cfg.batch_size:  # the process's rows start at its first rank's
            rows = rows - ctx.process_id * stream_batch

    def to_rank(raw: Any) -> Any:
        """This rank's rows of a drawn batch (the whole batch on one device)."""
        return raw if rows is None else take_rows(raw, rows)

    # chaos seam: data fault modes (nan-grads/loss-spike) poison batches at
    # the draw boundary, UNDER the cursor so draw indices line up with the
    # cursor's skip-window space
    poison = wrap_data_stream(plan, data)
    data_faults_handled = poison is not data
    # restart-from-step must also restart-from-*data*: the cursor replays
    # the stream to the draw position the restored step's sidecar recorded
    # (health-rollback skip windows included); a step without a sidecar
    # falls back to the step-count fast-forward
    if start_step:
        cursor_state = (ckpt.load_cursor(start_step) if ckpt else None) or {
            "position": start_step
        }
        cursor = DataCursor.restore(poison, cursor_state)
    else:
        cursor = DataCursor(poison)

    eval_fn = None
    eval_data = None
    eval_loss: Optional[float] = None
    if cfg.eval_every:
        eval_fn = make_eval_step(adapter, cfg.train, mesh=mesh, rules=cfg.rules)
        # held-out stream: a seed offset no training stream uses, disjoint
        # per process in the batch-rows mode
        eval_seed = cfg.seed + 7919 + (0 if replicated else ctx.process_id)
        eval_data = make_stream(stream_batch, seed=eval_seed, part="eval")

    def sync_flags(anomaly_local: bool) -> "tuple[bool, bool]":
        """(cancelled, anomaly), the same on every rank: SIGTERM reaches the
        ranks milliseconds apart, and a rank that breaks for the emergency
        save while another enters the next step's collectives would leave
        both waiting.  Every rank contributes both flags at one loop point."""
        if mesh is None:
            return lifecycle.cancelled, bool(anomaly_local)
        import torch.distributed as dist

        flags = torch.tensor([int(lifecycle.cancelled), int(bool(anomaly_local))], dtype=torch.int32)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX)
        return bool(flags[0]), bool(flags[1])

    def cancel_requested() -> bool:
        return sync_flags(False)[0]

    # -- self-healing machinery (workload/health.py) ---------------------------
    health_cfg = cfg.health
    monitor = HealthMonitor(health_cfg, metrics=telemetry) if health_cfg.enabled else None
    policy = HealthPolicy(health_cfg)
    health_events: list = []

    def _evidence() -> Dict[str, Any]:
        # ONE details payload carrying every recovery story this run owns —
        # each write rewrites the column wholesale, so later writers (the
        # rollback repoint, the hang handler, preempted(), completed())
        # re-merge the earlier evidence
        details: Dict[str, Any] = {}
        if health_events:
            details["health_rollback"] = list(health_events)
        if rollback_events:
            details["ckpt_rollback"] = _rollback_record(rollback_events)
        return details

    def _health_details() -> str:
        return json.dumps(_evidence())

    def _health_recover(anomaly: Anomaly, current_state: Dict[str, Any]):
        """Rollback-and-skip: restore the newest VERIFIED checkpoint from
        before the poisoned window, skip the window on the data cursor, and
        resume — or raise a classified terminal failure when recovery
        cannot help (no pre-window checkpoint, recurrence, budget)."""
        limit = anomaly.step + 1  # checkpoints <= the flagged step predate the window
        target = ckpt.latest_verified_step(quarantine=coordinator, before=limit) if ckpt is not None else None
        _barrier(mesh)
        # the before-scan may have quarantined steps that rotted SINCE the
        # startup scan — fold the fresh events into the run's evidence
        if ckpt is not None and len(ckpt.rollbacks) > len(rollback_events):
            fresh = ckpt.rollbacks[len(rollback_events):]
            rollback_events.extend(fresh)
            if coordinator:
                for event in fresh:
                    telemetry.count("train.ckpt_rollback", tags={"cause": event["cause"]})
        verdict, why = policy.decide(anomaly, target)
        if coordinator:
            telemetry.count("train.anomaly", tags={"cause": anomaly.kind})
        if verdict == "fail":
            raise RuntimeError(classified_failure_text(anomaly, why))
        # newer steps are healthy bytes on the ABANDONED trajectory: the
        # retrained run re-commits the same step numbers with different
        # weights, so set them aside (never quarantine-as-corrupt — a
        # postmortem must tell divergence recovery from bit rot)
        abandoned = [
            durability.abandon_step(cfg.checkpoint_dir, s)
            for s in durability.list_steps(cfg.checkpoint_dir)
            if s > target and coordinator
        ]
        _barrier(mesh)
        restored = _restore_train_state(ckpt, current_state, target)
        sidecar = ckpt.load_cursor(target) or {"position": target}
        window = [int(sidecar.get("position", target)), int(cursor.position)]
        cursor.skip_window(window[0], window[1])
        record = {
            "cause": anomaly.kind,
            "flagged_step": anomaly.step,
            "restored_step": target,
            "skipped_window": window,
            "detail": str(anomaly.detail)[:200],
        }
        policy.record(record)
        health_events.append(record)
        if monitor is not None:
            monitor.reset()  # pending flags belong to the abandoned trajectory
        logger.warning(
            "health rollback (%s): flagged step %d, restored verified step %d, "
            "skipped data window [%d, %d), abandoned %d newer checkpoint(s)",
            anomaly.kind, anomaly.step, target, window[0], window[1], len(abandoned),
        )
        if coordinator:
            telemetry.count("train.rollback", tags={"cause": anomaly.kind})
            reporter.health_rollback(ckpt.uri_for(target), target, _health_details())
        return restored, target

    # the hang handler's snapshot: the state and the cursor state of the
    # same step's end, assigned as ONE tuple.  The state is the live,
    # in-place one; state_lock marks the window in which a step writes it
    latest_ref: Dict[str, Any] = {"snap": (state, cursor.state())}
    state_lock = threading.Lock()
    watchdog: Optional[StepWatchdog] = None
    if health_cfg.enabled and health_cfg.step_timeout_s > 0:
        watchdog = StepWatchdog(
            health_cfg.step_timeout_s,
            _make_hang_handler(
                cfg, reporter, ctx, telemetry, evidence=_evidence,
                # on a mesh the save would need the wedged peers' collectives
                ckpt=ckpt if mesh is None else None, latest_ref=latest_ref, state_lock=state_lock,
            ),
        )
        watchdog.start()

    # on-demand device profiling: NEXUS_PROFILE_DIR arms a torch.profiler
    # capture around train steps [NEXUS_PROFILE_START, NEXUS_PROFILE_START +
    # NEXUS_PROFILE_STEPS); strictly best-effort, failures counted
    from tpu_nexus_torch.serving.tracing import DeviceProfiler

    profiler = DeviceProfiler.from_env(cuda=device.type == "cuda")

    reporter.running()
    launches_at_start = _attention_launches()
    gmm_at_start = _grouped_matmul_launches()
    if mesh is not None:
        from tpu_nexus_torch.parallel import collectives

        collectives.STATS.reset()
    metrics: Dict[str, Any] = {}
    m: Dict[str, Any] = {}
    t0 = time.perf_counter()
    # everything up to here — state init, verified restore, step
    # construction — is startup
    meter.lap(BUCKET_INIT)
    tokens_done = 0
    step = start_step
    pending_anomaly: Optional[Anomaly] = None
    warmup_pending = True  # the first step builds the kernels and warms the allocator
    try:
        while True:
            if step >= cfg.steps and pending_anomaly is None and monitor is not None:
                # the sentinel reads flags one step delayed — the FINAL
                # step's verdict is still pending when the loop drains
                pending_anomaly = monitor.drain()
            cancelled, anomaly_flag = sync_flags(pending_anomaly is not None)
            if cancelled:
                break  # preemption: the grace window belongs to the emergency save
            if anomaly_flag:
                # a peer's flag without a local anomaly should be impossible
                # (the flags derive from the same global scalars): fail safe
                # to the same window if it ever happens
                anomaly = pending_anomaly or Anomaly(CAUSE_NUMERIC_NAN, max(step - 1, start_step), "peer rank flagged")
                pending_anomaly = None
                with state_lock:
                    state, step = _health_recover(anomaly, state)
                    latest_ref["snap"] = (state, cursor.state())
                meter.lap(BUCKET_RECOVERY)
                continue
            if step >= cfg.steps:
                break
            # the first iteration (kernel build, allocator warm-up) runs
            # unarmed; the armed window covers the fault seam, the batch
            # draw, the step and the sentinel's delayed readback
            armed = watchdog is not None and not warmup_pending
            if armed:
                watchdog.arm(step)
            if profiler is not None and not warmup_pending:
                # profile steady-state steps: the first iteration's kernel
                # build would drown the window
                profiler.tick(step)
            maybe_inject(
                plan,
                step,
                checkpoint_faults_handled=ckpt is not None,
                data_faults_handled=data_faults_handled,
                hang_watchdog_armed=armed,
            )
            meter.lap(BUCKET_OTHER)
            raw = next(cursor)
            batch = adapter.to_device(to_rank(raw), device)
            meter.lap(BUCKET_DATA)
            with state_lock:
                state, step_metrics = step_fn(state, batch)
                # the step's end: its kernels are queued, so a copy queued
                # after this point reads the state this cursor state matches
                latest_ref["snap"] = (state, cursor.state())
            m = _HostCopy(step_metrics, device)
            # global items: the process's draw times the processes that draw apart
            items = adapter.items_in(raw) * (processes if stream_batch != cfg.batch_size else 1)
            tokens_done += items
            meter.note_step(items)
            if monitor is not None:
                # one-step-delayed readback: reads the PREVIOUS step's
                # verdict; the step already gated a condemned update, so
                # acting a step late loses nothing irreversible
                pending_anomaly = monitor.push(step, m)
            meter.lap(BUCKET_INIT if warmup_pending else BUCKET_STEP)
            if cfg.heartbeat_every and (step + 1) % cfg.heartbeat_every == 0:
                metrics = {k: float(v) for k, v in m.items()}
                meter.lap(BUCKET_STEP)
                reporter.heartbeat(step + 1)
                logger.info("step %d loss %.4f", step + 1, metrics.get("loss", float("nan")))
                if "loss" in metrics:
                    telemetry.gauge("train.loss", metrics["loss"])
                if "grad_norm" in metrics:
                    telemetry.gauge("train.grad_norm", metrics["grad_norm"])
                if coordinator:
                    meter.gauges(telemetry)
            if watchdog is not None:
                watchdog.disarm()
            warmup_pending = False
            if eval_fn and (step + 1) % cfg.eval_every == 0:
                losses = [
                    eval_fn(state, adapter.to_device(to_rank(next(eval_data)), device))["loss"]
                    for _ in range(cfg.eval_steps)
                ]
                eval_loss = float(sum(losses)) / max(len(losses), 1)
                meter.lap(BUCKET_EVAL)
                logger.info("step %d eval_loss %.4f", step + 1, eval_loss)
            if ckpt and (step + 1) % cfg.checkpoint_every == 0:
                # publish-after-durability: save() writes the step, the
                # cursor sidecar stages before commit() so the manifest
                # covers it, and only commit()'s URI reaches the ledger
                # (nxlint NX007)
                # (nxlint NX007).  Every rank takes part in the save (its
                # shards gathered whole); one writer, the coordinator, commits
                ckpt.save(step + 1, state)
                if coordinator:
                    ckpt.save_cursor(step + 1, cursor.state())
                    uri = ckpt.commit(step + 1)
                    reporter.tensor_checkpoint(uri, step + 1)
                meter.lap(BUCKET_CKPT)
            step += 1
    except Exception as exc:  # noqa: BLE001 - annotate, record, re-raise
        # failure-time trace artifact, its ref in the ledger (hlo_trace_ref)
        # AND in the raised message so the event text carries it to the
        # supervisor's extractor; the text is the taxonomy's wording
        text = classified_error_text(exc)
        uri = _dump_failure_trace(cfg, ctx, step, exc)
        if uri:
            reporter.hlo_trace(uri)
            raise RuntimeError(f"{text} [hlo_trace: {uri}]") from exc
        if text != str(exc):
            raise RuntimeError(text) from exc
        raise
    finally:
        if watchdog is not None:
            watchdog.stop()
        if profiler is not None:
            profiler.stop()  # close a capture the loop exited inside of
    sync(device)
    elapsed = time.perf_counter() - t0
    # draining the queued step chain is train time surfacing late
    meter.lap(BUCKET_STEP)
    preempted = cancel_requested()
    emergency: Dict[str, Any] = {}
    if preempted:
        emergency = _emergency_save(cfg, ckpt, state, reporter, lifecycle, telemetry, cursor=cursor,
                                    coordinator=coordinator)
        meter.lap(BUCKET_EMERGENCY)
    if ckpt:
        ckpt.close()
    if coordinator and fault_hook is not None and not preempted and fault_hook.fired["count"] == 0:
        # vacuous-drill guard, commit-protocol flavor: a checkpoint fault
        # was configured but its step never matched a commit boundary, so
        # nothing was injected — exiting 0 would read as a passed drill
        # (`not preempted` spares a run a REAL preemption stopped early)
        raise RuntimeError(
            f"chaos drill injected nothing: fault mode {plan.mode!r} targets "
            f"checkpoint step {plan.step}, but that step never committed "
            f"(checkpoint_every={cfg.checkpoint_every}, steps={cfg.steps})"
        )
    if coordinator and data_faults_handled and not preempted and poison.fired["count"] == 0:
        # same guard, data-poison flavor: the fault draw index was never
        # reached (or a rollback skip-window swallowed it before it fired)
        raise RuntimeError(
            f"chaos drill injected nothing: fault mode {plan.mode!r} targets "
            f"batch draw {plan.step}, but only {cursor.position} draws happened "
            f"(steps={cfg.steps})"
        )
    if coordinator and plan.mode == "step-hang" and not preempted:
        # reachable only if the fault step was never hit: a fired step-hang
        # exits the process through the watchdog (exit code 70)
        raise RuntimeError(
            f"chaos drill injected nothing: fault mode 'step-hang' targets "
            f"step {plan.step}, but the run completed {cfg.steps} steps "
            "without wedging"
        )
    # close the goodput books: residual host time lands in host_other, so
    # the buckets sum to elapsed exactly
    meter.stop()
    if meter.enabled and coordinator:
        logger.info("%s", meter.table())
    metrics = {k: float(v) for k, v in m.items()} if m else metrics
    final_step = int(state["step"])
    # completion protocol: every process lands its final heartbeat, THEN a
    # barrier across the world, THEN only the coordinator commits the
    # terminal row — a fast process's terminal write would make the
    # IsFinished guard drop a slower one's last heartbeat
    reporter.heartbeat(final_step)
    _barrier(mesh)
    if coordinator:
        goodput = {"goodput": meter.summary()} if meter.enabled else {}
        if preempted:
            # PREEMPTED is non-terminal: the supervisor's restart path
            # resumes from the emergency step in the details; the details
            # keep every recovery story of the run beside it
            reporter.preempted(
                cause=f"signal:{lifecycle.reason or 'cancelled'}",
                details=json.dumps({**emergency, **_evidence(), **goodput}),
            )
        else:
            # COMPLETED details carry the goodput accounting AND the
            # run's rollback evidence (health_rollback / ckpt_rollback)
            details = {**_evidence(), **goodput}
            reporter.completed(details=json.dumps(details, sort_keys=True) if details else "")
    return {
        "final_step": final_step,
        "resumed_from": resumed_from,
        "elapsed_s": elapsed,
        "tokens_per_second": tokens_done / elapsed if elapsed > 0 else 0.0,
        "device": str(device),
        # this run's launches of the flash kernels (#1-#3) on this rank
        "attention_launches": {k: v - launches_at_start[k] for k, v in _attention_launches().items()},
        "grouped_matmul_launches": {k: v - gmm_at_start[k] for k, v in _grouped_matmul_launches().items()},
        **({"mesh": mesh.describe(), "rank": rank.rank, "collectives": _collectives_summary()}
           if mesh is not None else {}),
        **({"goodput": meter.summary()} if meter.enabled else {}),
        **({"eval_loss": eval_loss} if eval_loss is not None else {}),
        **({"preempted": True, **emergency} if preempted else {}),
        **({"ckpt_rollbacks": rollback_events} if rollback_events else {}),
        **({"health_rollbacks": health_events} if health_events else {}),
        **({"health_skips": monitor.skips_observed} if monitor and monitor.skips_observed else {}),
        # the profiler window's outcome, as the serve-engine summary gives it
        **({"profiler": profiler.summary()} if profiler is not None else {}),
        **metrics,
    }


def _attention_launches() -> Dict[str, int]:
    """The flash kernels' launch counters (#1 forward, #2 dQ, #3 dK/dV)."""
    from tpu_nexus_torch.ops import flash_attention as fa

    return {f.__name__: f.launches for f in (fa.flash_attention, fa.flash_attention_bwd_dq,
                                             fa.flash_attention_bwd_dkv)}


def _grouped_matmul_launches() -> Dict[str, int]:
    """The grouped-matmul kernels' launch counters (#7 gmm, #8 tgmm)."""
    from tpu_nexus_torch.ops import grouped_matmul as gm

    return {"nexus_gmm": gm.gmm_kernel_call.launches, "nexus_tgmm": gm.tgmm_kernel_call.launches}


def _collectives_summary() -> Dict[str, Any]:
    """The run's collectives on this rank: calls and bytes by name."""
    from tpu_nexus_torch.parallel import collectives

    stats = collectives.STATS.to_dict()
    return {"calls": stats["calls"], "bytes": stats["bytes"], "staged": sorted(collectives.STAGED)}


def _barrier(mesh: Any) -> None:
    """Every rank of a training world meets here (a no-op on one device)."""
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()


def _cards(device: torch.device, mesh: Any) -> int:
    """Distinct cards under the world's ranks (the MFU's peak counts each
    once: ranks sharing a card under the rehearsal map do not multiply it)."""
    if device.type != "cuda":
        return 1
    name = str(torch.cuda.get_device_properties(device).uuid)
    if mesh is None:
        return 1
    import torch.distributed as dist

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, name)
    return len(set(names))


def _emergency_save(
    cfg: WorkloadConfig,
    ckpt: Optional[TensorCheckpointer],
    state: Dict[str, Any],
    reporter: LedgerReporter,
    lifecycle: LifecycleContext,
    telemetry: Metrics,
    cursor: Optional[Any] = None,
    coordinator: bool = True,
) -> Dict[str, Any]:
    """Preemption → saved step: cut a final checkpoint inside the grace
    window, skipping when the interrupted loop already committed this exact
    step (a SIGTERM landing mid-save-window must not double-save), and
    publish it only after the durability barrier.  Best-effort by design: a
    failing emergency save still reports PREEMPTED honestly — the restart
    then resumes from the last periodic commit."""
    info: Dict[str, Any] = {
        "reason": lifecycle.reason or "cancelled",
        "grace_s": cfg.emergency_grace_s,
    }
    if ckpt is None:
        return info
    step = int(state["step"])
    if step <= 0:
        return info  # nothing trained yet — nothing worth saving
    if ckpt.last_saved_step == step:
        # the loop already wrote this exact step; a barrier that somehow
        # did not finish completes here without a fresh save
        if coordinator and ckpt.last_committed_step != step:
            uri = ckpt.commit(step)
            reporter.tensor_checkpoint(uri, step)
        logger.info("emergency save: step %d already committed; skipping", step)
        telemetry.count("train.emergency_save", tags={"skipped": "true"})
        info.update(emergency_step=step, emergency_skipped=True, emergency_save_s=0.0)
        return info
    t0 = time.perf_counter()
    try:
        ckpt.save(step, state)  # every rank of a mesh: the save gathers the shards
        if not coordinator:
            info.update(emergency_step=step, emergency_skipped=False)
            return info
        if cursor is not None:
            # restart-from-*data*: the emergency step's sidecar carries the
            # cursor (incl. any health-rollback skip windows)
            ckpt.save_cursor(step, cursor.state())
        uri = ckpt.commit(step)  # durability barrier before publish (NX007)
    except Exception:  # noqa: BLE001 - best-effort: a failing emergency save must not mask the preemption report; the run restarts from the last committed step
        logger.exception("emergency save at step %d failed", step)
        telemetry.count("train.emergency_save_failed")
        info.update(emergency_step=None, emergency_skipped=False)
        return info
    save_s = time.perf_counter() - t0
    reporter.tensor_checkpoint(uri, step)
    info.update(emergency_step=step, emergency_skipped=False, emergency_save_s=save_s)
    if save_s > cfg.emergency_grace_s:
        logger.warning(
            "emergency save took %.2fs, over the %.2fs grace budget — the "
            "runtime may have killed the process mid-save",
            save_s, cfg.emergency_grace_s,
        )
    telemetry.count("train.emergency_save", tags={"skipped": "false"})
    return info
