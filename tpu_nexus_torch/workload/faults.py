"""Fault-injection hooks: the port of ``tpu_nexus/workload/faults.py``.

Process modes, fired by :func:`maybe_inject` at the configured loop step
(the reference's table):

==============  =====================================================
mode            effect / classified as
==============  =====================================================
``oom``         os._exit(137) — container OOMKilled → FATAL (exit-code parity
                with the reference's PodFailurePolicy 137 note,
                services/supervisor.go:310-313)
``fatal``       os._exit(255) — unknown fatal → FATAL
``preempt``     SIGTERM to self — TPU preemption path → PREEMPTED/restart
``xla-abort``   raise RuntimeError("XLA compilation aborted...") → XLA_COMPILE_ABORT
``hbm-oom``     raise the XLA RESOURCE_EXHAUSTED wording → HBM_OOM
``ici``         raise the ICI link wording → ICI_LINK_FAILURE
``hang``        sleep forever — stuck-in-running, caught by missing heartbeats
==============  =====================================================

Configured by env (read once at loop entry): ``NEXUS_FAULT_MODE``,
``NEXUS_FAULT_STEP``.

Serving-engine fault modes (the chaos harness) exercise the engine's
fault-ISOLATION layer instead of killing the process, so they inject at
the executor boundary (:func:`wrap_executor` around ``ModelExecutor``) or
the iteration loop rather than raising into ``run_serve_engine`` itself:

===============  ==============================================================
mode             effect / expected engine behavior
===============  ==============================================================
``step-hbm-oom`` executor raises the HBM RESOURCE_EXHAUSTED wording at the
                 configured call → implicated request retires FAILED
                 (cause ``hbm-oom``), batch keeps serving
``step-ici``     executor raises the ICI wording for ``times`` consecutive
                 calls → transient: bounded retry with backoff heals it,
                 no request harmed (exhausted retries → FAILED)
``slow-step``    executor sleeps ``NEXUS_FAULT_SLOW_S`` per decode step from
                 the configured call on → per-request deadlines trip and
                 retire EVICTED ``deadline exceeded``
``drain-sigterm`` SIGTERM to self at the configured engine iteration (no
                 sleep-forever — unlike ``preempt``, the drain protocol is
                 expected to CATCH it): admission stops, grace drain runs,
                 ledger lands PREEMPTED with per-cause retirement counts
===============  ==============================================================

Disaggregated-serving handoff modes inject at the
same executor boundary, targeting the KV handoff entry points
(``extract_blocks`` on a prefill replica / ``install_blocks`` on a decode
replica).  Both count on the SAME step counter as ``step``/``verify``, so
``NEXUS_FAULT_STEP`` targets the Nth dispatch in disaggregated mode exactly
like fused mode:

===================  ==========================================================
mode                 effect / expected fleet behavior
===================  ==========================================================
``handoff-drop``     the targeted handoff dispatch raises ``TransferDropped``
                     (transient) → the fleet's HandoffPolicy retries in place
                     with backoff; past the budget the hop layer takes over
``handoff-corrupt``  one byte of a SEALED payload leaf is flipped before the
                     install — the RECEIVER's CRC validation must catch it
                     (``PayloadCorrupt``); the decision tables hop the request
                     (next decode replica / re-prefill) and exhaustion
                     degrades to fused serving.  Install-seam only: a
                     pre-seal extract corruption would be CRC-blessed — the
                     exact silent-corruption class the drill exists to catch.
``kill-mid-handoff`` the targeted handoff dispatch raises ``PeerLost`` — a
                     replica died mid-transfer; a dead decode peer retries
                     the next decode replica, a dead prefill peer re-prefills
                     elsewhere, every hop recorded with cause
===================  ==========================================================

``NEXUS_FAULT_STEP`` counts executor *step* calls (or engine iterations for
``drain-sigterm``), ``NEXUS_FAULT_REQUEST`` counts ``begin`` calls — so a
fault can target iteration N or the Nth admitted request.
``NEXUS_FAULT_TIMES`` repeats the fault (default 1; how ``step-ici``
exercises retry-then-succeed vs retries-exhausted).

Checkpoint-durability fault modes inject inside the ``TensorCheckpointer``
commit protocol (:func:`checkpoint_fault_hook` wired as its
``fault_hook``); for these, ``NEXUS_FAULT_STEP`` names the **checkpoint
step being committed**, not a loop iteration:

=======================  ======================================================
mode                     effect / expected recovery
=======================  ======================================================
``ckpt-crash-mid-save``  ``os._exit(1)`` between the manifest temp write and
                         the commit-marker rename — the torn-save window.  The
                         restart resumes from the last *committed* step and
                         quarantines the torn directory; the ledger never saw
                         the torn URI (publish happens only after ``commit()``).
``ckpt-bitflip``         flips one byte of a committed tensor file AFTER the
                         marker is published — silent media corruption.  The
                         next restore detects the checksum mismatch,
                         quarantines the step and rolls back one step, cause
                         recorded.
``preempt-sigterm``      SIGTERM to self during the save window (pre-commit).
                         The harness's signal handler catches it; the commit
                         completes, the loop drains, and the emergency-save
                         path skips the duplicate same-step save and exits
                         PREEMPTED with the saved step in the ledger details.
=======================  ======================================================

Training-health fault modes exercise the on-device numerical sentinel and
the rollback-and-skip recovery (workload/health.py).  The data modes
inject at the BATCH boundary (:func:`wrap_data_stream` around the training
stream — where real data poison arrives); ``NEXUS_FAULT_STEP`` names the
batch **draw index** and ``NEXUS_FAULT_TIMES`` the window width:

==============  ==============================================================
mode            effect / expected recovery
==============  ==============================================================
``nan-grads``   float batch leaves become NaN for the window → the sentinel
                flags non-finite, the update is skipped on the device, and
                the harness rolls back to the newest verified pre-window
                checkpoint, skipping the poisoned draws via the data cursor
                (run ends COMPLETED; recurrence → classified FAILED).
``loss-spike``  float batch leaves scaled x1e4 for the window → loss/grad
                spike vs the EMA baseline; each spiking step's update is
                skipped on the device (bounded skip budget), a streak past
                the budget escalates to the same rollback-and-skip path.
``step-hang``   the training loop wedges at the fault step (sleep-forever —
                a stand-in for a hung device).  The step-hang watchdog
                (NEXUS_STEP_TIMEOUT_S) must fire: emergency save, classified
                ``step-hang`` cause on the ledger, exit code 70 — never a
                silent wedge (the unwatched variant of this is ``hang``).
==============  ==============================================================

Both data modes require an adapter with float batch leaves (the mnist
preset); poisoning an int token batch cannot produce NaN grads, so the
wrapper raises instead of running a vacuous drill.

The handoff modes fire on the real dispatches of the paged executor's
KV handoff seam (``extract_blocks`` on a prefill replica,
``install_blocks`` on a decode replica); ``handoff-corrupt`` flips a byte
of the payload's host form (a CPU tensor of the pool's dtype) in the bytes
its CRC covers.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)

ENV_FAULT_MODE = "NEXUS_FAULT_MODE"
ENV_FAULT_STEP = "NEXUS_FAULT_STEP"
ENV_FAULT_REQUEST = "NEXUS_FAULT_REQUEST"
ENV_FAULT_TIMES = "NEXUS_FAULT_TIMES"
ENV_FAULT_SLOW_S = "NEXUS_FAULT_SLOW_S"

#: modes injected at the EXECUTOR boundary by :func:`wrap_executor`
#: (serve-engine only) — :func:`maybe_inject` deliberately no-ops on them
#: so the engine's recovery layer, not the loop, sees the fault
EXECUTOR_FAULT_MODES = frozenset({"step-hbm-oom", "step-ici", "slow-step"})

#: KV-handoff modes, injected by :class:`FaultyExecutor` at the
#: disaggregated entry points (``extract_blocks``/``install_blocks``) on the
#: SAME step counter as the decode dispatches — same ownership contract as
#: :data:`EXECUTOR_FAULT_MODES` (the loop's :func:`maybe_inject` stays
#: silent when the executor is wrapped)
HANDOFF_FAULT_MODES = frozenset(
    {"handoff-drop", "handoff-corrupt", "kill-mid-handoff"}
)

#: modes injected inside the CHECKPOINT commit protocol by
#: :func:`checkpoint_fault_hook` (train harness) — same ownership contract
#: as the executor modes: the loop's :func:`maybe_inject` stays silent when
#: a checkpointer carries the hook, and raises in loops that would make the
#: drill vacuous (no checkpointer configured)
CHECKPOINT_FAULT_MODES = frozenset(
    {"ckpt-crash-mid-save", "ckpt-bitflip", "preempt-sigterm"}
)

#: modes injected at the DATA boundary by :func:`wrap_data_stream` (train
#: harness) — same ownership contract: the loop's :func:`maybe_inject` stays
#: silent when the stream is wrapped, and raises in loops that would make
#: the drill vacuous (no wrapped stream)
DATA_FAULT_MODES = frozenset({"nan-grads", "loss-spike"})

#: loss-spike poison: float batch leaves scaled by this factor
LOSS_SPIKE_SCALE = 1e4

#: message wordings recognized by the supervisor's classifier
#: (tpu_nexus_torch.supervisor.taxonomy) — injection uses the same strings so the
#: end-to-end path is honest
MSG_XLA_ABORT = "XLA compilation aborted: INTERNAL: Mosaic failed to compile module"
MSG_HBM_OOM = "RESOURCE_EXHAUSTED: Attempting to allocate 9.54G. That was not possible. There are 2.1G free."
MSG_ICI = "ICI link failure detected on interconnect 3: neighbor chip unreachable"


@dataclass(frozen=True)
class FaultPlan:
    mode: Optional[str]
    step: int
    #: serving extensions (defaults keep every existing call site valid):
    #: target the Nth ``begin`` call instead of the Nth step (None = step-
    #: targeted), repeat the fault ``times`` consecutive calls, and the
    #: per-step delay for ``slow-step``
    request: Optional[int] = None
    times: int = 1
    slow_s: float = 0.05

    @staticmethod
    def from_env(env=None) -> "FaultPlan":
        e = os.environ if env is None else env
        raw_request = e.get(ENV_FAULT_REQUEST, "")
        return FaultPlan(
            mode=e.get(ENV_FAULT_MODE) or None,
            step=int(e.get(ENV_FAULT_STEP, "0")),
            request=int(raw_request) if raw_request else None,
            times=int(e.get(ENV_FAULT_TIMES, "1")),
            slow_s=float(e.get(ENV_FAULT_SLOW_S, "0.05")),
        )


def maybe_inject(
    plan: FaultPlan,
    step: int,
    executor_faults_handled: bool = False,
    checkpoint_faults_handled: bool = False,
    data_faults_handled: bool = False,
    hang_watchdog_armed: bool = False,
) -> None:
    """Called once per training step / engine iteration; fires the
    configured fault at its step.  Executor-boundary modes
    (:data:`EXECUTOR_FAULT_MODES`) are owned by :func:`wrap_executor` —
    the serve-engine loop passes ``executor_faults_handled=True`` and this
    hook stays silent so the engine's recovery layer sees the fault;
    checkpoint-commit modes (:data:`CHECKPOINT_FAULT_MODES`) likewise
    belong to :func:`checkpoint_fault_hook` (the train loop passes
    ``checkpoint_faults_handled=True`` when its checkpointer carries the
    hook), and data modes (:data:`DATA_FAULT_MODES`) to
    :func:`wrap_data_stream`.  A loop that did NOT wire the corresponding
    seam raises at the fault step instead: a chaos drill that injects
    nothing and reports success is worse than no drill.  ``step-hang``
    additionally demands an ARMED step-hang watchdog
    (``hang_watchdog_armed``) — wedging a loop nothing watches is the
    pre-existing ``hang`` drill, not this one."""
    if plan.mode is None or step != plan.step:
        return
    if plan.mode in EXECUTOR_FAULT_MODES or plan.mode in HANDOFF_FAULT_MODES:
        if executor_faults_handled:
            return
        raise ValueError(
            f"fault mode {plan.mode!r} injects at the serving-executor "
            "boundary; this loop has no wrapped executor — use "
            "NEXUS_MODE=serve-engine for this drill"
        )
    if plan.mode in CHECKPOINT_FAULT_MODES:
        if checkpoint_faults_handled:
            return
        raise ValueError(
            f"fault mode {plan.mode!r} injects inside the checkpoint commit "
            "protocol; this loop has no checkpointer (set "
            "NEXUS_CHECKPOINT_EVERY/NEXUS_CHECKPOINT_DIR) — the drill would "
            "inject nothing"
        )
    if plan.mode in DATA_FAULT_MODES:
        if data_faults_handled:
            return
        raise ValueError(
            f"fault mode {plan.mode!r} injects at the training-data "
            "boundary; this loop has no wrapped data stream — the drill "
            "would inject nothing"
        )
    if plan.mode == "step-hang":
        if not hang_watchdog_armed:
            raise ValueError(
                "fault mode 'step-hang' wedges the training step; no armed "
                "step-hang watchdog covers this step (set "
                "NEXUS_STEP_TIMEOUT_S, and note the first iteration's jit "
                "compile window runs unarmed — target a later step) — the "
                "drill would hang silently instead of proving recovery"
            )
        logger.warning(
            "injecting step-hang at step %d: wedging until the watchdog kills us",
            step,
        )
        while True:  # pragma: no cover - the watchdog exits the process
            time.sleep(3600)
    logger.warning("injecting fault %r at step %d", plan.mode, step)
    if plan.mode == "oom":
        os._exit(137)
    if plan.mode == "fatal":
        os._exit(255)
    if plan.mode == "preempt":
        # HARD preemption: the runtime kills without grace.  Restore the
        # default disposition first so the harness's emergency-save handler
        # (which would turn this into a graceful drain) cannot catch it —
        # the graceful variant is the separate 'preempt-sigterm' mode
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(60)  # wait for the handler/runtime to take us down
        os._exit(143)
    if plan.mode == "drain-sigterm":
        # the graceful-preemption drill: SIGTERM with NO sleep-forever —
        # the serve-engine drain protocol is expected to CATCH it, finish
        # in-flight work under the grace budget and land an honest
        # PREEMPTED ledger row (train/serve loops without a handler die
        # with the default SIGTERM disposition, same as a real preemption)
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if plan.mode == "xla-abort":
        raise RuntimeError(MSG_XLA_ABORT)
    if plan.mode == "hbm-oom":
        raise RuntimeError(MSG_HBM_OOM)
    if plan.mode == "ici":
        raise RuntimeError(MSG_ICI)
    if plan.mode == "hang":
        while True:  # pragma: no cover - unbounded by design
            time.sleep(3600)
    raise ValueError(f"unknown fault mode {plan.mode!r}")


class FaultyExecutor:
    """Executor wrapper injecting serving faults at the jitted-dispatch
    boundary — exactly where a real XLA/HBM fault surfaces, so the engine's
    recovery layer (classify → retry/retire) is exercised end to end.

    ``at_step`` counts ``step()`` calls, ``at_begin`` counts ``begin()``
    calls (both zero-based, matching the zero-based NEXUS_FAULT_STEP
    contract); ``times`` consecutive calls fault before the executor heals
    (``slow-step`` never heals — slowness is a condition, not an event).
    """

    def __init__(
        self,
        inner,
        mode: str,
        *,
        at_step: Optional[int] = None,
        at_begin: Optional[int] = None,
        times: int = 1,
        slow_s: float = 0.05,
        sleep=time.sleep,
    ) -> None:
        if mode not in EXECUTOR_FAULT_MODES and mode not in HANDOFF_FAULT_MODES:
            raise ValueError(
                f"unknown executor fault mode {mode!r}; use one of "
                f"{sorted(EXECUTOR_FAULT_MODES | HANDOFF_FAULT_MODES)}"
            )
        self.inner = inner
        self.mode = mode
        self.at_step = at_step
        self.at_begin = at_begin
        self.times = times
        self.slow_s = slow_s
        self._sleep = sleep
        self.step_calls = 0
        self.begin_calls = 0
        self.injected = 0

    # the engine reads these through the executor contract
    @property
    def num_slots(self):
        return self.inner.num_slots

    @property
    def max_len(self):
        return self.inner.max_len

    def __getattr__(self, name):
        # everything else falls through to the wrapped executor so the
        # wrapper stays transparent to executor-surface growth — the paged
        # engine reads page_size/num_blocks/prefilled_tokens through it
        if name == "inner":  # guard: never recurse during __init__
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _in_window(self, count: int, target: Optional[int]) -> bool:
        if target is None:
            return False
        if self.mode == "slow-step":
            return count >= target  # a slow device stays slow
        return target <= count < target + self.times

    def _fire(self) -> None:
        self.injected += 1
        if self.mode == "step-hbm-oom":
            raise RuntimeError(MSG_HBM_OOM)
        if self.mode == "step-ici":
            raise RuntimeError(MSG_ICI)
        # slow-step: delay, then proceed normally
        self._sleep(self.slow_s)

    def begin(self, slot, prompt, **kwargs):
        # kwargs pass through untouched: the paged executor's table_row/
        # tail_start/copies ride the same fault-injection boundary
        count = self.begin_calls
        self.begin_calls += 1
        if self._in_window(count, self.at_begin):
            self._fire()
        return self.inner.begin(slot, prompt, **kwargs)

    def step(self, tokens, cursors, *args):
        # *args pass through untouched: the paged engine's block tables
        count = self.step_calls
        self.step_calls += 1
        if self._in_window(count, self.at_step):
            self._fire()
        return self.inner.step(tokens, cursors, *args)

    def step_scan(self, *args, **kwargs):
        # the overlapped/multi-step decode dispatch: counts on
        # the SAME step counter as step()/verify(), so NEXUS_FAULT_STEP
        # targets the Nth decode DISPATCH whether the engine is
        # synchronous, multi-step, or overlapped.  Firing here raises at
        # dispatch time; the engine HOLDS the fault on the pending record
        # and surfaces it at the deferred materialization — one step late,
        # same one-fault-one-request contract (the chaos tests pin it).
        count = self.step_calls
        self.step_calls += 1
        if self._in_window(count, self.at_step):
            self._fire()
        return self.inner.step_scan(*args, **kwargs)

    def verify(self, tokens, cursors, drafts, *args, **kwargs):
        # the speculative engine's decode dispatch: drafts —
        # and the paged table operand — pass through UNCHANGED, and the
        # call counts on the SAME step counter as step(), so
        # NEXUS_FAULT_STEP targets the Nth decode dispatch whether the
        # engine speculates or not (a spec-on chaos drill needs no new
        # env contract)
        count = self.step_calls
        self.step_calls += 1
        if self._in_window(count, self.at_step):
            self._fire()
        return self.inner.verify(tokens, cursors, drafts, *args, **kwargs)

    def _fire_handoff(self, point: str, payload=None) -> None:
        """Inject one handoff fault at ``point`` (``extract``/``install``).
        Drop and peer-loss raise the typed handoff faults with the
        classifier's wordings; corruption flips one byte of the SEALED
        payload and lets the receiver's CRC validation — the product code
        under drill — do the catching."""
        from tpu_nexus_torch.serving.handoff import PeerLost, TransferDropped

        if self.mode == "handoff-drop":
            self.injected += 1
            raise TransferDropped(
                "kv handoff transfer dropped in transit (injected)"
            )
        if self.mode == "kill-mid-handoff":
            self.injected += 1
            raise PeerLost(
                f"serving replica died mid kv-handoff at {point} "
                "(injected kill)"
            )
        # handoff-corrupt
        if point != "install" or payload is None:
            raise ValueError(
                "fault mode 'handoff-corrupt' corrupts a SEALED payload at "
                "the install seam; an extract-side corruption would happen "
                "before seal() and be blessed by the CRC — a silent-"
                "corruption drill that can never fire.  Target an install "
                "dispatch (the decode replica's NEXUS_FAULT_STEP)."
            )
        import copy

        from tpu_nexus_torch.serving.handoff import leaf_bytes

        self.injected += 1
        name = sorted(payload.blocks)[0]
        # the flip lands in the bytes the CRC covers (for a bf16 leaf, its
        # 2-byte patterns), in a copy: the sender's leaf stays intact
        arr = copy.deepcopy(payload.blocks[name])
        flat = leaf_bytes(arr)
        flat[flat.shape[0] // 2] ^= 0xFF
        payload.blocks[name] = arr
        logger.warning(
            "injecting handoff-corrupt: flipped one byte of sealed leaf %r "
            "for request %s", name, payload.request_id,
        )

    def extract_blocks(self, block_ids):
        # disaggregated prefill-side handoff dispatch: counts on
        # the SAME step counter as step()/verify(), so NEXUS_FAULT_STEP
        # targets the Nth dispatch in disaggregated mode exactly like
        # fused mode.  Executor modes (_fire) and handoff modes
        # (_fire_handoff) share the window discipline.
        count = self.step_calls
        self.step_calls += 1
        if self._in_window(count, self.at_step):
            if self.mode in HANDOFF_FAULT_MODES:
                self._fire_handoff("extract")
            else:
                self._fire()
        return self.inner.extract_blocks(block_ids)

    def install_blocks(self, payload, block_ids):
        # disaggregated decode-side handoff dispatch: same shared step
        # counter.  handoff-corrupt mutates the payload then PROCEEDS —
        # the inner executor's validate_payload is what must catch it.
        count = self.step_calls
        self.step_calls += 1
        if self._in_window(count, self.at_step):
            if self.mode in HANDOFF_FAULT_MODES:
                self._fire_handoff("install", payload)
            else:
                self._fire()
        return self.inner.install_blocks(payload, block_ids)


def flip_committed_leaf(step_dir: str) -> str:
    """Flip one byte of a committed payload file — silent media corruption
    the manifest checksums must catch.  Prefers the tensor files
    (``tensors/<n>.pt``) over the index and sidecars so the drill corrupts
    an actual tensor leaf: the middle byte of the first sorted one, which
    lies in its tensor data.  Public: the reload tests corrupt candidate
    checkpoints with the same primitive the checkpoint drills use."""
    from tpu_nexus_torch.workload import durability
    from tpu_nexus_torch.workload.tensor_checkpoint import TENSOR_DIR

    files = durability.manifest_files(step_dir)
    leaves = [f for f in files if f.startswith(TENSOR_DIR + "/")] or files
    if not leaves:
        raise ValueError(f"ckpt-bitflip: no payload files under {step_dir}")
    target = os.path.join(step_dir, sorted(leaves)[0])
    size = os.path.getsize(target)
    with open(target, "r+b") as fh:
        fh.seek(size // 2)
        byte = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([byte[0] ^ 0xFF]))
    return target


def checkpoint_fault_hook(plan: FaultPlan):
    """``TensorCheckpointer.fault_hook`` wired from the fault plan; None
    when no checkpoint-commit mode is configured (hook-free fast path).

    ``NEXUS_FAULT_STEP`` names the checkpoint step being committed;
    ``NEXUS_FAULT_TIMES`` repeats the fault for consecutive matching
    commits (bitflip drills corrupting more than one step)."""
    if plan.mode not in CHECKPOINT_FAULT_MODES:
        return None
    fired = {"count": 0}

    def hook(point: str, step: int, step_dir: str) -> None:
        if step != plan.step or fired["count"] >= plan.times:
            return
        if plan.mode == "ckpt-crash-mid-save" and point == "pre-commit":
            fired["count"] += 1
            logger.warning(
                "injecting ckpt-crash-mid-save: dying between manifest temp "
                "write and commit marker for step %d", step,
            )
            os._exit(1)
        elif plan.mode == "preempt-sigterm" and point == "pre-commit":
            fired["count"] += 1
            logger.warning(
                "injecting preempt-sigterm during the save window of step %d", step
            )
            # the harness's handler sets the cancellation flag; THIS commit
            # still completes, so the emergency-save path must detect the
            # already-durable same-step save and skip the duplicate
            os.kill(os.getpid(), signal.SIGTERM)
        elif plan.mode == "ckpt-bitflip" and point == "post-commit":
            fired["count"] += 1
            target = flip_committed_leaf(step_dir)
            logger.warning(
                "injecting ckpt-bitflip: corrupted %s after commit of step %d",
                target, step,
            )

    # exposed so the harness can tell a completed drill from a VACUOUS one
    # (NEXUS_FAULT_STEP naming a step that is never a commit boundary fires
    # nothing — the run must not exit 0 looking like a passed drill)
    hook.fired = fired
    return hook


def _poison_tree(batch, poison_leaf):
    """Map ``poison_leaf`` over float ndarray leaves of a plain batch pytree
    (dict/tuple/list/ndarray — the numpy batches adapters yield).  Returns
    ``(new_batch, n_poisoned)``."""
    import numpy as np

    count = 0

    def walk(node):
        nonlocal count
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            mapped = [walk(v) for v in node]
            return type(node)(mapped) if isinstance(node, tuple) else mapped
        arr = np.asarray(node)
        if np.issubdtype(arr.dtype, np.floating):
            count += 1
            return poison_leaf(arr)
        return node

    return walk(batch), count


class PoisonedDataStream:
    """Training-stream wrapper injecting numeric poison at the batch
    boundary — exactly where real data corruption arrives, so the on-device
    sentinel + rollback-and-skip recovery is exercised end to end.

    ``at_draw`` counts batches drawn from the underlying stream (the
    DataCursor's draw-index space, so a recorded skip window lines up with
    the poisoned window 1:1); ``times`` consecutive draws are poisoned.
    ``fired`` is the vacuous-drill observable: a run that completes with
    ``fired["count"] == 0`` must raise, not exit 0 looking like a passed
    drill (same contract as :func:`checkpoint_fault_hook`)."""

    def __init__(self, inner, mode: str, at_draw: int, times: int = 1) -> None:
        if mode not in DATA_FAULT_MODES:
            raise ValueError(
                f"unknown data fault mode {mode!r}; use one of {sorted(DATA_FAULT_MODES)}"
            )
        self.inner = inner
        self.mode = mode
        self.at_draw = at_draw
        self.times = times
        self.draws = 0
        self.fired = {"count": 0}

    def __iter__(self) -> "PoisonedDataStream":
        return self

    def __next__(self):
        import numpy as np

        batch = next(self.inner)
        index = self.draws
        self.draws += 1
        if not self.at_draw <= index < self.at_draw + self.times:
            return batch
        if self.mode == "nan-grads":
            poison = lambda arr: np.full_like(arr, np.nan)  # noqa: E731
        else:  # loss-spike
            poison = lambda arr: arr * LOSS_SPIKE_SCALE  # noqa: E731
        batch, poisoned = _poison_tree(batch, poison)
        if poisoned == 0:
            raise ValueError(
                f"fault mode {self.mode!r} found no float leaves in the batch "
                "(int token batches cannot carry NaN) — use a float-batch "
                "adapter (mnist preset) for this drill"
            )
        self.fired["count"] += 1
        logger.warning(
            "injecting %s into batch draw %d (%d float leaves poisoned)",
            self.mode, index, poisoned,
        )
        return batch


def wrap_data_stream(plan: FaultPlan, stream):
    """Wrap the training batch stream per the fault plan; pass-through for
    non-data modes.  ``NEXUS_FAULT_STEP`` names the batch draw index,
    ``NEXUS_FAULT_TIMES`` the poisoned-window width."""
    if plan.mode not in DATA_FAULT_MODES:
        return stream
    logger.warning(
        "training chaos: poisoning data stream with %r (draw=%d times=%d)",
        plan.mode, plan.step, plan.times,
    )
    return PoisonedDataStream(stream, plan.mode, at_draw=plan.step, times=plan.times)


def wrap_executor(plan: FaultPlan, executor):
    """Wrap ``executor`` per the fault plan; pass-through for non-executor
    modes (including no fault).  ``NEXUS_FAULT_REQUEST`` targets the Nth
    prefill, otherwise ``NEXUS_FAULT_STEP`` targets the Nth decode step."""
    if plan.mode not in EXECUTOR_FAULT_MODES and plan.mode not in HANDOFF_FAULT_MODES:
        return executor
    logger.warning(
        "serving chaos: wrapping executor with %r (step=%s request=%s times=%d)",
        plan.mode, plan.step, plan.request, plan.times,
    )
    if plan.request is not None:
        return FaultyExecutor(
            executor, plan.mode, at_begin=plan.request,
            times=plan.times, slow_s=plan.slow_s,
        )
    return FaultyExecutor(
        executor, plan.mode, at_step=plan.step, times=plan.times, slow_s=plan.slow_s
    )
