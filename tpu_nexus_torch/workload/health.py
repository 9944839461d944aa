"""Self-healing training: the port of ``tpu_nexus/workload/health.py``.

A training run that is *alive and sick* — NaN/Inf loss, exploding
gradients, a step wedged on the device — burns its deadline producing
garbage with no cause ever recorded.  Three layers close that gap:

* **on-device sentinel** (:func:`health_init` / :func:`sentinel_update`) —
  finite-flags for loss/``grad_norm`` plus an EMA-based spike detector,
  computed as tensor ops inside the train step.  The step gates the
  optimizer update on the verdict (``applied``, a ``torch.where`` select),
  so a poisoned update never lands even though the host learns about it a
  step later.  The flags ride the metrics dict as device scalars; nothing
  here reads a value back to the host.

* **host-side readback + policy** (:class:`HealthMonitor` /
  :class:`HealthPolicy`) — the monitor reads each step's flags one step
  *delayed*: when step N has been launched it reads step N-1's verdict,
  so host run-ahead shrinks to one step but no *new* per-step sync is
  introduced.  Graded recovery: a spike skips the update on the device
  (bounded ``skip_budget``); NaN/Inf — or a spike streak past the budget —
  calls for a rollback to the newest verified checkpoint, and without one
  (tensor checkpoints are a later slice of the port) the run fails with a
  cause the supervisor taxonomy classifies (NUMERIC_NAN / LOSS_SPIKE).

* **step-hang watchdog** (:class:`StepWatchdog`) — a thread arming a
  per-step wall-clock deadline.  The handler writes the ledger a
  classified ``step-hang`` cause and exits with
  :data:`STEP_HANG_EXIT_CODE` instead of hanging until the k8s deadline.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

ENV_HEALTH = "NEXUS_HEALTH"
ENV_HEALTH_EMA_BETA = "NEXUS_HEALTH_EMA_BETA"
ENV_HEALTH_SPIKE_FACTOR = "NEXUS_HEALTH_SPIKE_FACTOR"
ENV_HEALTH_WARMUP = "NEXUS_HEALTH_WARMUP"
ENV_HEALTH_SKIP_BUDGET = "NEXUS_HEALTH_SKIP_BUDGET"
ENV_HEALTH_MAX_ROLLBACKS = "NEXUS_HEALTH_MAX_ROLLBACKS"
ENV_STEP_TIMEOUT_S = "NEXUS_STEP_TIMEOUT_S"

#: machine cause tokens — recorded in metrics tags and ledger details, and
#: embedded in raised/exit messages so ``classify_tpu_failure`` maps them to
#: the matching DecisionAction (supervisor/taxonomy.py)
CAUSE_NUMERIC_NAN = "numeric-nan"
CAUSE_LOSS_SPIKE = "loss-spike"
CAUSE_STEP_HANG = "step-hang"

#: distinctive exit code for the watchdog's hang exit (EX_SOFTWARE): the
#: process MUST die nonzero — a hang exit that looks like success would
#: read as a completed run to the JobSet controller
STEP_HANG_EXIT_CODE = 70

#: metric keys the train step publishes the sentinel verdict under (device
#: scalars in the step metrics dict; 1.0 = flag set)
FLAG_NONFINITE = "health_nonfinite"
FLAG_SPIKE = "health_spike"
FLAG_APPLIED = "health_applied"


@dataclass(frozen=True)
class HealthConfig:
    """Knobs for the sentinel + recovery policy (launcher env contract)."""

    #: master switch: disabled = pre-health behavior (every update applies,
    #: no flags, no watchdog) — the escape hatch for A/B'ing the sentinel
    enabled: bool = True
    #: EMA smoothing for the loss/grad baselines (per APPLIED step)
    ema_beta: float = 0.9
    #: a step whose loss or grad_norm exceeds ``factor x EMA`` is a spike
    spike_factor: float = 4.0
    #: applied steps before the spike detector arms — early training loss
    #: moves fast and the EMA is still meaningless
    warmup_steps: int = 5
    #: consecutive on-device skips tolerated before the spike escalates to the
    #: rollback path (a landscape that never stops spiking is divergence,
    #: not noise)
    skip_budget: int = 3
    #: total rollback-and-skip recoveries tolerated per run; recurrence at
    #: the SAME window fails earlier regardless
    max_rollbacks: int = 3
    #: per-step wall-clock deadline for the hang watchdog; 0 disables it
    step_timeout_s: float = 0.0

    def __post_init__(self) -> None:
        if not 0.0 < self.ema_beta < 1.0:
            raise ValueError(f"ema_beta must be in (0, 1), got {self.ema_beta}")
        if self.spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1 (it multiplies the EMA), got {self.spike_factor}"
            )
        if self.warmup_steps < 1 or self.skip_budget < 1 or self.max_rollbacks < 1:
            raise ValueError(
                "warmup_steps, skip_budget and max_rollbacks must be >= 1"
            )
        if self.step_timeout_s < 0:
            raise ValueError(f"step_timeout_s must be >= 0, got {self.step_timeout_s}")

    @staticmethod
    def from_env(env: Optional[Mapping[str, str]] = None) -> "HealthConfig":
        import os

        e = os.environ if env is None else env
        return HealthConfig(
            enabled=e.get(ENV_HEALTH, "1") not in ("0", "false", "off"),
            ema_beta=float(e.get(ENV_HEALTH_EMA_BETA, "0.9")),
            spike_factor=float(e.get(ENV_HEALTH_SPIKE_FACTOR, "4.0")),
            warmup_steps=int(e.get(ENV_HEALTH_WARMUP, "5")),
            skip_budget=int(e.get(ENV_HEALTH_SKIP_BUDGET, "3")),
            max_rollbacks=int(e.get(ENV_HEALTH_MAX_ROLLBACKS, "3")),
            step_timeout_s=float(e.get(ENV_STEP_TIMEOUT_S, "0")),
        )


# -- on-device sentinel (tensor code; runs inside the train step) -------------


def health_init(device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """Device-side sentinel state carried in the train state."""
    return {
        "ema_loss": torch.zeros((), dtype=torch.float32, device=device),
        "ema_grad": torch.zeros((), dtype=torch.float32, device=device),
        #: APPLIED updates so far — the EMA warmup clock (skipped/sick steps
        #: must not advance it, or a NaN streak would "warm up" the detector
        #: on garbage)
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def sentinel_update(
    health: Dict[str, torch.Tensor],
    loss: torch.Tensor,
    grad_norm: torch.Tensor,
    *,
    ema_beta: float,
    spike_factor: float,
    warmup_steps: int,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One sentinel step: classify (loss, grad_norm) against the EMA
    baselines and advance them.  Returns ``(new_health, flags)`` where
    ``flags`` are 0/1 f32 device scalars (:data:`FLAG_NONFINITE` /
    :data:`FLAG_SPIKE` / :data:`FLAG_APPLIED`) for the metrics dict.

    Tensor ops only — nothing here reads a value back to the host, so the
    step never waits on the device for it.  The EMA advances only on
    APPLIED steps: a spike or NaN must never drag its own baseline up and
    launder the next one.
    """
    loss32 = loss.float()
    grad32 = grad_norm.float()
    finite = torch.isfinite(loss32) & torch.isfinite(grad32)
    warm = health["count"] >= warmup_steps
    # a "spike_factor x baseline" threshold is only meaningful over a
    # POSITIVE baseline: with a negative EMA (log-likelihood-style losses)
    # every finite step would sit above factor x EMA and the sentinel would
    # veto a healthy run.  Negative-loss objectives keep NaN/Inf protection
    # and the grad-norm spike (norms are nonnegative by construction).
    loss_spike = warm & (health["ema_loss"] > 0) & (loss32 > health["ema_loss"] * spike_factor)
    grad_spike = warm & (health["ema_grad"] > 0) & (grad32 > health["ema_grad"] * spike_factor)
    spike = finite & (loss_spike | grad_spike)
    applied = finite & ~spike

    def ema(prev: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        seeded = torch.where(
            health["count"] == 0, value, ema_beta * prev + (1.0 - ema_beta) * value
        )
        return torch.where(applied, seeded, prev)

    new_health = {
        "ema_loss": ema(health["ema_loss"], loss32),
        "ema_grad": ema(health["ema_grad"], grad32),
        "count": health["count"] + applied.to(torch.int32),
    }
    flags = {
        FLAG_NONFINITE: (~finite).float(),
        FLAG_SPIKE: spike.float(),
        FLAG_APPLIED: applied.float(),
    }
    return new_health, flags


def gate_update(applied: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Element-select ``new`` where the sentinel applied the update, ``old``
    where it skipped.  ``torch.where`` is a select, never arithmetic over
    the rejected branch: a skipped step leaves the old values bit-untouched
    and NaNs in the rejected update cannot propagate.  Applied per leaf
    (the optimizers write the selected value in place)."""
    return torch.where(applied, new, old)


# -- host-side readback --------------------------------------------------------


@dataclass(frozen=True)
class Anomaly:
    """One host-visible health verdict.  ``step`` is the FIRST step of the
    offending window (the spike streak start, or the NaN step) — rollback
    must land on a checkpoint covering only draws before it."""

    kind: str  # CAUSE_NUMERIC_NAN | CAUSE_LOSS_SPIKE
    step: int
    detail: str = ""


class HealthMonitor:
    """One-step-delayed sentinel readback.

    ``push(step, metrics)`` stores the CURRENT step's device flags and
    materializes the PREVIOUS step's — by the time step N is dispatched,
    step N-1 has retired on device, so the tiny scalar copies block on
    nothing new (host run-ahead shrinks to one step; the device pipeline
    stays full).  The delayed verdict is safe because the step already
    gated the update: a condemned step's params never landed, so acting
    one step late loses nothing irreversible.

    ``metrics`` (optional, coordinator-only) receives a ``train.skip``
    count per observed on-device skip so budgeted skips are visible in statsd
    before any rollback fires.
    """

    def __init__(self, cfg: HealthConfig, metrics: Optional[Any] = None) -> None:
        self.cfg = cfg
        self._metrics = metrics
        self._pending: Optional[Tuple[int, Dict[str, Any]]] = None
        self._streak = 0
        self._streak_start: Optional[int] = None
        self.skips_observed = 0

    def push(self, step: int, step_metrics: Mapping[str, Any]) -> Optional[Anomaly]:
        """Record step ``step``'s flags; classify the previous step's.  The
        mapping is kept as given and read only when classified, so a
        mapping whose reads wait for their step's device copy (the
        harness's) costs nothing here."""
        if FLAG_NONFINITE not in step_metrics:
            return None  # sentinel disabled in this train step
        prev = self._pending
        self._pending = (step, step_metrics)
        if prev is None:
            return None
        return self._classify(*prev)

    def drain(self) -> Optional[Anomaly]:
        """Flush the final pending verdict (the last step's flags are still
        unread when the loop exhausts)."""
        prev = self._pending
        self._pending = None
        if prev is None:
            return None
        return self._classify(*prev)

    def reset(self) -> None:
        """Post-rollback: the pending flags and the spike streak belong to
        the abandoned trajectory."""
        self._pending = None
        self._streak = 0
        self._streak_start = None

    def _classify(self, step: int, vals: Mapping[str, Any]) -> Optional[Anomaly]:
        # reading these scalars waits only for step `step`'s results
        nonfinite = bool(float(vals[FLAG_NONFINITE]))
        if nonfinite:
            detail = (
                f"loss={float(vals.get('loss', float('nan')))} "
                f"grad_norm={float(vals.get('grad_norm', float('nan')))}"
            )
            return Anomaly(CAUSE_NUMERIC_NAN, step, detail)
        spike = bool(float(vals[FLAG_SPIKE]))
        if spike:
            self.skips_observed += 1
            if self._streak == 0:
                self._streak_start = step
            self._streak += 1
            if self._metrics is not None:
                self._metrics.count("train.skip", tags={"cause": CAUSE_LOSS_SPIKE})
            logger.warning(
                "health sentinel skipped the step-%d update (loss/grad spike, "
                "streak %d/%d)", step, self._streak, self.cfg.skip_budget,
            )
            if self._streak > self.cfg.skip_budget:
                start = self._streak_start if self._streak_start is not None else step
                return Anomaly(
                    CAUSE_LOSS_SPIKE,
                    start,
                    f"loss spike streak of {self._streak} skipped steps "
                    f"exceeded the skip budget ({self.cfg.skip_budget})",
                )
        else:
            self._streak = 0
            self._streak_start = None
        return None


class HealthPolicy:
    """Rollback bookkeeping: how many recoveries this run has spent and
    whether a new anomaly is a RECURRENCE of an already-recovered window —
    the signal that skipping data cannot heal this run."""

    def __init__(self, cfg: HealthConfig) -> None:
        self.cfg = cfg
        self.rollbacks: List[Dict[str, Any]] = []

    def decide(self, anomaly: Anomaly, restore_step: Optional[int]) -> Tuple[str, str]:
        """``("rollback", reason)`` or ``("fail", reason)``.

        RECURRENCE means the sickness came back inside a span a previous
        rollback already retrained past its skip window: same restore
        target AND the new anomaly flagged at or before the previous
        flagged step — skipping data demonstrably did not heal it, so the
        cause is not the data.  A LATER anomaly that merely resolves to
        the same restore target (fresh poison arriving before the next
        commit boundary) is new-window material and retries, bounded by
        ``max_rollbacks``."""
        if restore_step is None:
            return "fail", "no verified checkpoint to roll back to"
        if any(
            r["restored_step"] == restore_step and anomaly.step <= r["flagged_step"]
            for r in self.rollbacks
        ):
            return "fail", (
                f"recurred after a rollback to step {restore_step} already "
                "skipped this window"
            )
        if len(self.rollbacks) >= self.cfg.max_rollbacks:
            return "fail", (
                f"rollback budget exhausted ({self.cfg.max_rollbacks} recoveries)"
            )
        return "rollback", ""

    def record(self, record: Dict[str, Any]) -> None:
        self.rollbacks.append(record)


def classified_failure_text(anomaly: Anomaly, why: str) -> str:
    """Terminal-failure wording, phrased so ``classify_tpu_failure`` maps it
    to the matching taxonomy decision (NUMERIC_NAN / LOSS_SPIKE)."""
    if anomaly.kind == CAUSE_NUMERIC_NAN:
        head = (
            "numeric health sentinel: non-finite loss/grad_norm at "
            f"step {anomaly.step}"
        )
    else:
        head = f"numeric health sentinel: loss spike at step {anomaly.step}"
    detail = f" ({anomaly.detail})" if anomaly.detail else ""
    return f"{head}{detail}; {why} — training cannot self-heal [cause: {anomaly.kind}]"


# -- step-hang watchdog --------------------------------------------------------


class StepWatchdog:
    """Per-step wall-clock deadline on a daemon thread.

    The harness arms it around each iteration's STEP work (batch draw,
    dispatch, the sentinel's delayed readback — which blocks on the
    previous step's completion, so a wedged device freezes the loop inside
    ONE armed window) and disarms
    for the phases whose duration legitimately dwarfs a step: the first
    iteration's kernel build and warm-up, the eval block, and the checkpoint
    save/commit — ``timeout_s`` is sized to steady-state step time, and a
    deadline that also had to absorb a multi-minute compile would be
    useless against real hangs.  ``on_hang(step, timeout_s)`` runs on the
    watchdog thread and is expected not to return (emergency save +
    classified exit); if it does return, the watchdog stops — one shot,
    never a second kill racing the first.
    """

    def __init__(
        self,
        timeout_s: float,
        on_hang: Callable[[int, float], None],
        poll_s: Optional[float] = None,
    ) -> None:
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self._on_hang = on_hang
        self._poll_s = poll_s if poll_s is not None else min(timeout_s / 4.0, 0.25)
        self._lock = threading.Lock()
        self._armed: Optional[Tuple[int, float]] = None  # (step, deadline)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="nexus-step-watchdog", daemon=True
            )
            self._thread.start()

    def arm(self, step: int) -> None:
        with self._lock:
            self._armed = (step, time.monotonic() + self.timeout_s)

    def disarm(self) -> None:
        with self._lock:
            self._armed = None

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                armed = self._armed
            if armed is None:
                continue
            step, deadline = armed
            if time.monotonic() < deadline:
                continue
            with self._lock:
                # published under the lock so the harness thread observing
                # `fired` after a join-timeout sees it together with the
                # armed-state it was derived from
                self.fired = True
            logger.error(
                "step-hang watchdog: step %d exceeded its %.3gs deadline",
                step, self.timeout_s,
            )
            try:
                self._on_hang(step, self.timeout_s)
            finally:
                return  # one shot — the handler owns the process from here


def hang_cause(step: int, timeout_s: float) -> str:
    """The classified cause string for a watchdog exit — wording matched by
    the taxonomy's STEP_HANG signature."""
    return f"{CAUSE_STEP_HANG}: step {step} exceeded its {timeout_s:g}s step deadline"
