"""The workload run loop: the port of ``tpu_nexus/workload/harness.py`` for
one process on one device.

Cooperation contract with the supervisor, as the reference's:

* on start: transition the ledger row to RUNNING (first-writer-wins);
* every ``heartbeat_every`` steps: write this process's per-chip step
  counters into ``per_chip_steps`` (ledger merge, not overwrite);
* on SIGTERM/SIGINT (preemption): stop at the next step boundary and land
  the row PREEMPTED with the signal in the cause and the goodput in the
  details (the emergency checkpoint comes with tensor checkpoints,
  ROADMAP.md A2);
* on clean exit: COMPLETED with the goodput accounting in the details
  (only if not already terminal — a cancelled run stays CANCELLED);
* on crash: raise, with a failure-trace artifact written and its
  reference both in the ledger (``hlo_trace_ref``) and in the raised text,
  where the supervisor's taxonomy classifies the cause.  A CUDA
  out-of-memory error is re-raised in the taxonomy's HBM-OOM wording.

Not ported in this slice, refused at parse naming the ROADMAP.md item
that brings each: tensor checkpoints (``NEXUS_CHECKPOINT_EVERY``/
``NEXUS_CHECKPOINT_DIR``, A2), fault injection into training
(``NEXUS_FAULT_MODE``: its checkpoint and data seams are A2),
multi-device meshes, sequence-parallel attention and pipeline
microbatches (``NEXUS_MESH``, ``NEXUS_SP_ATTN``,
``NEXUS_PP_MICROBATCHES``, A6), and the device profiler
(``NEXUS_PROFILE_DIR``).  Health rollback needs a checkpoint, so without
one an anomaly ends the run with the reference's classified failure.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import CheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext, setup_signal_context
from tpu_nexus_torch.core.telemetry import Metrics, StatsdClient
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.parallel.distributed import ProcessContext, initialize_distributed
from tpu_nexus_torch.workload.goodput import (
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
from tpu_nexus_torch.workload.train import TrainConfig

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


def _parse_mesh(mesh_env: str) -> Dict[str, int]:
    return {
        k.strip(): int(v)
        for k, v in (pair.split("=") for pair in mesh_env.split(",") if pair.strip())
    }


@dataclass(frozen=True)
class WorkloadConfig:
    #: a model config (LlamaConfig, MnistConfig) or a ModelAdapter — resolved
    #: through the model registry, so any zoo model runs this harness
    model: Any = field(default_factory=LlamaConfig.tiny)
    train: TrainConfig = field(default_factory=TrainConfig)
    batch_size: int = 8
    seq_len: int = 128
    steps: int = 20
    heartbeat_every: int = 5
    #: tensor checkpoints are a later slice (ROADMAP.md A2): 0 / "" only
    checkpoint_every: int = 0
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
    #: preemption grace budget (seconds), reported in the PREEMPTED details
    emergency_grace_s: float = 30.0
    #: numerical-health sentinel + step-hang watchdog knobs
    #: (workload/health.py; NEXUS_HEALTH*/NEXUS_STEP_TIMEOUT_S env contract)
    health: HealthConfig = field(default_factory=HealthConfig)
    #: goodput/MFU accounting (workload/goodput.py); NEXUS_GOODPUT=0 opts out
    goodput: bool = True
    #: where the run trains: "cuda" (default), "cuda:N" or "cpu" (NEXUS_DEVICE)
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.checkpoint_every or self.checkpoint_dir:
            raise NotImplementedError(
                "checkpoint_every/checkpoint_dir (NEXUS_CHECKPOINT_EVERY, "
                "NEXUS_CHECKPOINT_DIR): tensor checkpoints are not ported yet "
                "(ROADMAP.md: A2 tensor checkpoints and hot reload)"
            )
        for name in ("batch_size", "seq_len", "steps"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "WorkloadConfig":
        """The launcher env contract, parsed in ONE place."""
        import os

        from tpu_nexus_torch.models.registry import get_adapter

        e = os.environ if env is None else env
        if e.get("NEXUS_FAULT_MODE", ""):
            raise NotImplementedError(
                "NEXUS_FAULT_MODE: fault injection into training (the checkpoint "
                "and data-stream seams of workload/faults.py) is not ported yet "
                "(ROADMAP.md: A2 tensor checkpoints and hot reload)"
            )
        mesh = _parse_mesh(e.get("NEXUS_MESH", ""))
        if any(size > 1 for size in mesh.values()):
            raise NotImplementedError(
                f"NEXUS_MESH={e['NEXUS_MESH']!r}: multi-device meshes are not "
                "ported yet (ROADMAP.md: A6 multi-GPU)"
            )
        for key in ("NEXUS_SP_ATTN", "NEXUS_PP_MICROBATCHES"):
            if e.get(key, "") not in ("", "0"):
                raise NotImplementedError(
                    f"{key}={e[key]!r}: sequence/pipeline parallelism is not "
                    "ported yet (ROADMAP.md: A6 multi-GPU)"
                )
        if e.get("NEXUS_PROFILE_DIR", ""):
            raise NotImplementedError(
                "NEXUS_PROFILE_DIR: the device profiler hook is not ported yet "
                "(chip_smoke.py --phases build,profile traces serving on the card)"
            )
        steps = int(e.get("NEXUS_STEPS", "100"))
        return WorkloadConfig(
            model=get_adapter(e.get("NEXUS_MODEL_PRESET", "tiny")),
            train=TrainConfig(
                warmup_steps=int(e.get("NEXUS_WARMUP_STEPS", "10")),
                total_steps=max(steps, 2),
                optimizer=e.get("NEXUS_OPTIMIZER", "adamw"),
            ),
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
    import tempfile
    import traceback

    try:
        base = cfg.checkpoint_dir or tempfile.gettempdir()
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


def _make_hang_handler(
    cfg: WorkloadConfig,
    reporter: LedgerReporter,
    ctx: ProcessContext,
    telemetry: Metrics,
    evidence: Optional[Callable[[], Dict[str, Any]]] = None,
):
    """Build the StepWatchdog's on_hang callback.

    Runs on the watchdog thread while the main thread is wedged mid-step;
    it never returns: write the ledger row FAILED with the classified
    ``step-hang`` cause, then ``os._exit(STEP_HANG_EXIT_CODE)`` — the
    wedged main thread cannot unwind, so a raw exit is the only way off the
    box, nonzero so the JobSet never mistakes the wedge for success.  With
    no checkpointer in this slice there is no emergency save
    (``emergency_step`` is None in the details)."""
    import os as _os

    def _on_hang(step: int, timeout_s: float) -> None:
        # everything best-effort inside try/finally: a failing ledger write
        # must never skip the exit and leave the wedged process alive
        try:
            cause = hang_cause(step, timeout_s)
            if ctx.is_coordinator:
                telemetry.count("train.anomaly", tags={"cause": CAUSE_STEP_HANG})
            logger.error("%s — classified exit", cause)
            info = {"hang_step": step, "deadline_s": timeout_s, "emergency_step": None}
            payload = {**(evidence() if evidence is not None else {}), **info}
            reporter.failed(cause, details=json.dumps(payload))
        finally:
            _os._exit(STEP_HANG_EXIT_CODE)

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
    loop stops and lands the ledger row PREEMPTED.  By default signal
    handlers install on the main thread and are restored on exit."""
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
        return _workload_loop(cfg, store, ctx, data, lifecycle, telemetry)
    finally:
        if restore_handlers:
            import signal as _signal

            for sig, handler in restore_handlers.items():
                _signal.signal(sig, handler)


def _workload_loop(
    cfg: WorkloadConfig,
    store: Optional[CheckpointStore],
    ctx: Optional[ProcessContext],
    data: Optional[Iterator[Any]],
    lifecycle: LifecycleContext,
    telemetry: Optional[Metrics],
) -> Dict[str, Any]:
    from tpu_nexus_torch.models.registry import adapter_for
    from tpu_nexus_torch.workload.data import DataCursor
    from tpu_nexus_torch.workload.train import init_train_state, make_eval_step, make_train_step

    device = resolve_device(cfg.device)
    ctx = initialize_distributed(ctx)
    reporter = LedgerReporter(store, ctx, local_devices=1)
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
    meter = build_meter(cfg.goodput, adapter.config, cfg.seq_len, device)
    meter.start()
    logger.info("workload %s/%s: model %s on %s", ctx.algorithm, ctx.run_id, adapter.name, device)

    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    state = init_train_state(generator, adapter, cfg.train, device)
    step_fn = make_train_step(adapter, cfg.train, health=cfg.health)

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

    if data is None:
        data = make_stream(cfg.batch_size, seed=cfg.seed)
    cursor = DataCursor(data)

    eval_fn = None
    eval_data = None
    eval_loss: Optional[float] = None
    if cfg.eval_every:
        eval_fn = make_eval_step(adapter, cfg.train)
        # held-out stream: a seed offset no training stream uses
        eval_data = make_stream(cfg.batch_size, seed=cfg.seed + 7919, part="eval")

    # -- self-healing machinery (workload/health.py) ---------------------------
    health_cfg = cfg.health
    monitor = HealthMonitor(health_cfg, metrics=telemetry) if health_cfg.enabled else None
    policy = HealthPolicy(health_cfg)
    health_events: list = []

    def _evidence() -> Dict[str, Any]:
        return {"health_rollback": list(health_events)} if health_events else {}

    def _health_recover(anomaly: Anomaly) -> None:
        """Rollback-and-skip needs the newest verified checkpoint from before
        the poisoned window; this slice has no checkpointer, so the policy's
        verdict is the reference's terminal, classified failure."""
        verdict, why = policy.decide(anomaly, None)
        telemetry.count("train.anomaly", tags={"cause": anomaly.kind})
        raise RuntimeError(classified_failure_text(anomaly, why))

    watchdog: Optional[StepWatchdog] = None
    if health_cfg.enabled and health_cfg.step_timeout_s > 0:
        watchdog = StepWatchdog(
            health_cfg.step_timeout_s,
            _make_hang_handler(cfg, reporter, ctx, telemetry, evidence=_evidence),
        )
        watchdog.start()

    reporter.running()
    metrics: Dict[str, Any] = {}
    m: Dict[str, Any] = {}
    t0 = time.perf_counter()
    # everything up to here — state init, step construction — is startup
    meter.lap(BUCKET_INIT)
    tokens_done = 0
    step = 0
    pending_anomaly: Optional[Anomaly] = None
    warmup_pending = True  # the first step builds the kernels and warms the allocator
    try:
        while True:
            if step >= cfg.steps and pending_anomaly is None and monitor is not None:
                # the sentinel reads flags one step delayed — the FINAL
                # step's verdict is still pending when the loop drains
                pending_anomaly = monitor.drain()
            if lifecycle.cancelled:
                break  # preemption: stop consuming batches now
            if pending_anomaly is not None:
                anomaly, pending_anomaly = pending_anomaly, None
                meter.lap(BUCKET_RECOVERY)
                _health_recover(anomaly)
            if step >= cfg.steps:
                break
            armed = watchdog is not None and not warmup_pending
            if armed:
                watchdog.arm(step)
            meter.lap(BUCKET_OTHER)
            raw = next(cursor)
            batch = adapter.to_device(raw, device)
            meter.lap(BUCKET_DATA)
            state, step_metrics = step_fn(state, batch)
            m = _HostCopy(step_metrics, device)
            items = adapter.items_in(raw)
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
                meter.gauges(telemetry)
            if watchdog is not None:
                watchdog.disarm()
            warmup_pending = False
            if eval_fn and (step + 1) % cfg.eval_every == 0:
                losses = [
                    eval_fn(state, adapter.to_device(next(eval_data), device))["loss"]
                    for _ in range(cfg.eval_steps)
                ]
                eval_loss = float(sum(losses)) / max(len(losses), 1)
                meter.lap(BUCKET_EVAL)
                logger.info("step %d eval_loss %.4f", step + 1, eval_loss)
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
    sync(device)
    elapsed = time.perf_counter() - t0
    # draining the queued step chain is train time surfacing late
    meter.lap(BUCKET_STEP)
    preempted = lifecycle.cancelled
    emergency: Dict[str, Any] = {}
    if preempted:
        emergency = _emergency_save(cfg, lifecycle)
        meter.lap(BUCKET_EMERGENCY)
    meter.stop()
    if meter.enabled:
        logger.info("%s", meter.table())
    metrics = {k: float(v) for k, v in m.items()} if m else metrics
    final_step = int(state["step"])
    reporter.heartbeat(final_step)
    if ctx.is_coordinator:
        goodput = {"goodput": meter.summary()} if meter.enabled else {}
        if preempted:
            reporter.preempted(
                cause=f"signal:{lifecycle.reason or 'cancelled'}",
                details=json.dumps({**emergency, **_evidence(), **goodput}),
            )
        else:
            details = {**_evidence(), **goodput}
            reporter.completed(details=json.dumps(details, sort_keys=True) if details else "")
    return {
        "final_step": final_step,
        "resumed_from": None,
        "elapsed_s": elapsed,
        "tokens_per_second": tokens_done / elapsed if elapsed > 0 else 0.0,
        "device": str(device),
        **({"goodput": meter.summary()} if meter.enabled else {}),
        **({"eval_loss": eval_loss} if eval_loss is not None else {}),
        **({"preempted": True, **emergency} if preempted else {}),
        **({"health_skips": monitor.skips_observed} if monitor and monitor.skips_observed else {}),
        **metrics,
    }


def _emergency_save(cfg: WorkloadConfig, lifecycle: LifecycleContext) -> Dict[str, Any]:
    """Preemption → the grace info of the reference's emergency save.
    Without a checkpointer (tensor checkpoints are ROADMAP.md A2) nothing is
    saved, exactly as the reference returns when it has none."""
    return {"reason": lifecycle.reason or "cancelled", "grace_s": cfg.emergency_grace_s}
