"""Request-span tracing, engine flight recorder, on-demand device profiling.

The paper's supervisor exists to explain deaths the workload cannot explain
itself — it captures failure causes and HLO trace refs into the checkpoint
store (``supervisor/taxonomy.extract_hlo_trace_ref``).  The serving stack
that arbiter now guards (paged + speculative + overlapped + tensor-parallel)
emitted only aggregate statsd counters and terminal ledger rows: when a
request was slow, retired, or implicated one-step-late by the overlap
pipeline, there was no per-request timeline and no record of what the
engine was doing in the steps before the incident.  This module is that
layer — host-side, NX014-clean (it never touches a device array; every
value it records is a host int/float the engine already owned):

* :class:`RequestTrace` — one request's monotonic-clock span timeline,
  BOUNDED (``max_events`` with a ``dropped`` counter; the terminal event is
  always recorded).  Attached to ``Request.trace`` so the timeline rides
  the engine's retirement log and the fleet's cross-incarnation history.
* :class:`EngineTracer` — the engine-facing hook surface.  Default-ON:
  ``ServingEngine`` constructs one unless handed :class:`NullTracer`.
  Span summaries (TTFT/TPOT in the terminal event) are computed from the
  SAME ``Request`` timestamps ``ServingMetrics`` reads, so tracing and
  metrics can never disagree about a latency.
* :class:`FlightRecorder` — a fixed-size ring of per-step engine records
  (batch composition, queue depth, block-pool levels, deferred lanes,
  dispatch latency, fault/retry markers) that serializes to a JSON
  artifact at the incident seams (StepFault escalation, DeviceStateLost,
  drain/SIGTERM, fleet replica-lost) with the implicated requests' full
  timelines inside.  ``python -m tools.nxtrace dump.json`` converts a dump
  to Chrome trace-event format (perfetto-loadable).
* :class:`DeviceProfiler` — ``NEXUS_PROFILE_DIR`` arms a
  ``torch.profiler`` capture over a window of engine or train steps
  (``NEXUS_PROFILE_START``, ``NEXUS_PROFILE_STEPS``): host activity and,
  on the card, its kernels, written as one Chrome trace JSON.

A copy of ``tpu_nexus/serving/tracing.py`` apart from the profiler's
backend (``torch.profiler`` in place of ``jax.profiler``).

Everything here is best-effort by contract: a full ring, an unwritable
dump directory, or a broken profiler must never take down the serving loop
(the same fire-and-forget discipline as ``core/telemetry.StatsdClient``) —
failures are counted, never raised.  Schemas and drill commands:
docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

# -- span event names (the schema tools/nxtrace and the tests key off) ---------

EV_SUBMIT = "submit"
EV_ADMITTED = "admitted"
EV_PREFILL_DISPATCH = "prefill_dispatch"
EV_PREFILL_COMPLETE = "prefill_complete"
#: one decode dispatch covering this request (sync mode: readback is
#: immediate; overlap mode: results materialize one step late — the
#: DISTINCT :data:`EV_MATERIALIZE` event is what makes the deferral
#: visible on a timeline)
EV_DECODE_DISPATCH = "decode_dispatch"
EV_MATERIALIZE = "materialize"
EV_SPEC_PROPOSE = "spec_propose"
EV_SPEC_ACCEPT = "spec_accept"
EV_FAULT = "fault"
#: the fleet router retried this request on another replica after a
#: per-replica refusal — attrs carry the ordered ``tried`` list of
#: ``replica:cause`` hops, so a request's timeline shows its whole
#: admission path, not just the replica that finally took it
EV_ROUTER_RETRY = "router_retry"
#: disaggregated serving: prefilled KV blocks installed on the
#: DECODE replica — attrs carry block count, the source replica, and the
#: payload's accumulated ``stage:replica:cause`` hop log, so the landing
#: replica's timeline shows the request's whole cross-replica journey
EV_HANDOFF_INSTALL = "handoff_install"
#: one recorded handoff hop (retry / next-decode / re-prefill) — attrs
#: name the faulted stage, replica, cause token, and the decision taken
EV_HANDOFF_HOP = "handoff_hop"
#: handoff budgets spent (or no live prefill pool): the request degraded
#: to FUSED serving on this replica — recorded, never silently shed
EV_DISAGG_FALLBACK = "disagg_fallback"
#: terminal event: retirement state/action/cause + the TTFT/TPOT summary
#: (computed from the same Request timestamps ServingMetrics histograms)
EV_RETIRED = "retired"


def default_trace_dir() -> str:
    """Where incident dumps land when nothing is configured:
    ``NEXUS_TRACE_DIR``, else ``<tmp>/tpu-nexus-traces``."""
    return os.environ.get("NEXUS_TRACE_DIR") or os.path.join(
        tempfile.gettempdir(), "tpu-nexus-traces"
    )


class RequestTrace:
    """One request's bounded span timeline (module doc).  Events are
    ``(t_monotonic, name, attrs-or-None)`` tuples — appending one is the
    whole per-event cost, which is what lets tracing default on."""

    __slots__ = ("request_id", "events", "dropped", "max_events")

    def __init__(self, request_id: str, max_events: int = 256) -> None:
        if max_events < 8:
            # submit + admitted + prefill pair + terminal need room even
            # on the tightest configuration
            raise ValueError(f"max_events must be >= 8, got {max_events}")
        self.request_id = request_id
        self.events: List[Tuple[float, str, Optional[Dict[str, Any]]]] = []
        self.dropped = 0
        self.max_events = max_events

    def add(
        self,
        t: float,
        name: str,
        attrs: Optional[Dict[str, Any]] = None,
        force: bool = False,
    ) -> None:
        """Append one span event; past ``max_events`` the event is counted
        in ``dropped`` instead (``force`` bypasses the cap — the terminal
        event must always land, or a long generation's timeline would end
        mid-air with no cause)."""
        if len(self.events) >= self.max_events and not force:
            self.dropped += 1
            return
        self.events.append((t, name, attrs))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "request_id": self.request_id,
            "dropped_events": self.dropped,
            "events": [
                {"t": t, "name": name, **({"attrs": attrs} if attrs else {})}
                for t, name, attrs in self.events
            ],
        }


class FlightRecorder:
    """Fixed-size ring of per-step engine records + the incident-dump
    writer (module doc).  ``capacity`` bounds memory; ``max_dumps`` bounds
    disk (a crash-looping engine must not fill the volume with artifacts);
    write failures are counted in ``dump_failures``, never raised."""

    #: PROCESS-global artifact sequence: filenames embed pid + this, so
    #: two recorders in one process (a fleet of replicas, a recreated
    #: engine whose fresh recorder would restart a per-instance counter)
    #: can never os.replace() each other's incident artifacts
    _seq_counter = itertools.count(1)

    def __init__(
        self,
        capacity: int = 256,
        dump_dir: Optional[str] = None,
        max_dumps: int = 16,
        max_implicated: int = 32,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_dumps < 0:
            raise ValueError(f"max_dumps must be >= 0, got {max_dumps}")
        self.capacity = capacity
        self.dump_dir = dump_dir if dump_dir is not None else default_trace_dir()
        self.max_dumps = max_dumps
        #: per-dump cap on implicated timelines serialized into the
        #: artifact (a 1000-request drain must not write a 1000-timeline
        #: JSON; the count of what was elided is recorded honestly)
        self.max_implicated = max_implicated
        self.records: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        #: ``{"path", "reason", "step", "causes"}`` per written artifact —
        #: what the serve loop / fleet controller merge into ledger details
        self.dumps: List[Dict[str, Any]] = []
        self.dump_failures = 0

    def record(self, **fields: Any) -> None:
        """Append one per-step record (the engine calls this from its
        ``_finish_step`` tail with plain host ints — see
        docs/OBSERVABILITY.md for the field schema)."""
        self.records.append(fields)

    def dump(
        self,
        reason: str,
        implicated: Sequence[Any] = (),
        extra: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Serialize the ring + the implicated requests' timelines to a
        JSON artifact; returns the path, or None when the dump budget is
        spent or the write failed (counted).  ``implicated`` is a sequence
        of ``Request``-shaped objects (``request_id``/``state``/``cause``/
        ``trace``); their terminal events already carry the retirement
        cause, so the artifact names the same cause the ledger row does."""
        if len(self.dumps) >= self.max_dumps:
            self.dump_failures += 1
            return None
        shown = list(implicated)[: self.max_implicated]
        causes: Dict[str, int] = {}
        for req in implicated:
            cause = getattr(req, "cause", "") or getattr(req, "state", "")
            causes[cause] = causes.get(cause, 0) + 1
        payload = {
            "schema": "tpu-nexus-flight-recorder-v1",
            "reason": reason,
            "wall_time": time.time(),
            "monotonic_time": time.monotonic(),
            "records": list(self.records),
            "implicated": [
                {
                    "request_id": getattr(req, "request_id", "?"),
                    "state": getattr(req, "state", ""),
                    "cause": getattr(req, "cause", ""),
                    "output_tokens": len(getattr(req, "output_tokens", ())),
                    "timeline": (
                        req.trace.to_dict()
                        if getattr(req, "trace", None) is not None
                        else None
                    ),
                }
                for req in shown
            ],
            "implicated_total": len(list(implicated)),
            "implicated_elided": max(0, len(list(implicated)) - len(shown)),
            **(extra or {}),
        }
        seq = next(FlightRecorder._seq_counter)
        slug = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)[:48]
        path = os.path.join(
            self.dump_dir, f"nxtrace-{os.getpid()}-{seq:03d}-{slug}.json"
        )
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = f"{path}.tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=1, default=str)
            os.replace(tmp, path)  # readers never see a torn artifact
        except OSError:  # noqa: BLE001 - best-effort observability: an unwritable dump dir must never take down the serving loop; counted, and the engine's serving.trace_dumps metric simply stays flat
            self.dump_failures += 1
            return None
        entry = {
            "path": path,
            "reason": reason,
            "step": self.records[-1].get("step") if self.records else None,
            "causes": causes,
        }
        self.dumps.append(entry)
        return path

    def summary(self) -> Dict[str, Any]:
        """Compact dump inventory for ledger details: paths + reasons +
        per-cause counts (never the record payloads — details columns stay
        small; the artifact holds the weight)."""
        return {
            "dumps": list(self.dumps),
            "dump_failures": self.dump_failures,
            "ring_depth": len(self.records),
        }


class EngineTracer:
    """The engine-facing hook surface: span events onto ``Request.trace``
    plus the per-step :class:`FlightRecorder` ring (module doc).  Methods
    take the ``Request`` itself — the trace lives ON the request, so a
    retired request's timeline survives in ``engine.retired`` / the fleet
    history with no second index to leak or desync."""

    enabled = True

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        max_events_per_request: int = 256,
        recorder: Optional[FlightRecorder] = None,
    ) -> None:
        self._clock = clock
        self.max_events = max_events_per_request
        self.recorder = recorder if recorder is not None else FlightRecorder()
        #: span events counted out per-request past the bound (mirrors the
        #: per-trace ``dropped`` fields; one number for the summary line)
        self.events_dropped = 0

    # -- span events -----------------------------------------------------------

    def begin(self, req: Any) -> None:
        """Install the trace and record the submit span event."""
        req.trace = RequestTrace(req.request_id, self.max_events)
        req.trace.add(
            self._clock(),
            EV_SUBMIT,
            {
                "prompt_len": req.prompt_len,
                "max_new_tokens": req.max_new_tokens,
                **({"deadline_s": req.deadline_s} if req.deadline_s else {}),
            },
        )

    def event(
        self, req: Any, name: str, attrs: Optional[Dict[str, Any]] = None
    ) -> None:
        trace = getattr(req, "trace", None)
        if trace is None:
            return  # request entered outside submit() (tests constructing raw Requests)
        before = trace.dropped
        trace.add(self._clock(), name, attrs)
        self.events_dropped += trace.dropped - before

    def terminal(self, req: Any, action: str) -> None:
        """Record the terminal span event: state/action/cause plus the
        TTFT / mean-TPOT summary computed from the SAME ``Request``
        timestamps ``ServingMetrics`` histograms — by construction the
        tracer and the metrics pipeline cannot disagree about a latency."""
        trace = getattr(req, "trace", None)
        if trace is None:
            return
        attrs: Dict[str, Any] = {
            "state": req.state,
            "action": action,
            "tokens_out": len(req.output_tokens),
        }
        if req.cause:
            attrs["cause"] = req.cause
        if req.first_token_at is not None:
            attrs["ttft_s"] = req.first_token_at - req.submitted_at
        if (
            req.last_token_at is not None
            and req.first_token_at is not None
            and len(req.output_tokens) > 1
        ):
            attrs["tpot_mean_s"] = (req.last_token_at - req.first_token_at) / (
                len(req.output_tokens) - 1
            )
        trace.add(self._clock(), EV_RETIRED, attrs, force=True)

    # -- flight recorder -------------------------------------------------------

    def record_step(self, **fields: Any) -> None:
        self.recorder.record(**fields)

    def dump(
        self,
        reason: str,
        implicated: Sequence[Any] = (),
        extra: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        return self.recorder.dump(reason, implicated, extra)

    @property
    def last_dump(self) -> Optional[Dict[str, Any]]:
        """The most recent incident artifact (path/reason/causes) — what
        the fleet controller merges into its ledger incident record."""
        return self.recorder.dumps[-1] if self.recorder.dumps else None


class NullTracer:
    """Tracing disabled (``NEXUS_TRACE=0`` / the bench's tracer-off side):
    the same surface as :class:`EngineTracer`, every hook a no-op, so the
    engine carries exactly one ``if`` worth of difference — the call
    itself.  Requests keep ``trace=None``."""

    enabled = False

    def __init__(self) -> None:
        self.recorder = FlightRecorder(capacity=1, max_dumps=0)
        self.events_dropped = 0

    def begin(self, req: Any) -> None:
        pass

    def event(self, req: Any, name: str, attrs: Optional[Dict[str, Any]] = None) -> None:
        pass

    def terminal(self, req: Any, action: str) -> None:
        pass

    def record_step(self, **fields: Any) -> None:
        pass

    def dump(self, reason: str, implicated: Sequence[Any] = (), extra=None) -> None:
        return None

    @property
    def last_dump(self) -> None:
        return None


# -- on-demand device profiling ------------------------------------------------

class _TorchTrace:
    """``torch.profiler`` behind the ``start_trace(dir)`` / ``stop_trace()``
    pair that :class:`DeviceProfiler` drives (the calls of the reference's
    ``jax.profiler``).  The capture records host activity and, when
    ``cuda``, the card's kernels and copies; stopping it writes one Chrome
    trace JSON (perfetto-loadable) under the directory given at start."""

    def __init__(self, cuda: bool) -> None:
        self.cuda = cuda
        self._prof: Any = None
        self._dir = ""

    def start_trace(self, log_dir: str) -> None:
        from torch import profiler

        activities = [profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(profiler.ProfilerActivity.CUDA)
        prof = profiler.profile(activities=activities)
        prof.start()
        self._prof, self._dir = prof, log_dir

    def stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(self._dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class DeviceProfiler:
    """Step-windowed ``torch.profiler`` capture (module doc): arm with a
    directory and a ``[start_step, start_step + num_steps)`` window, call
    :meth:`tick` once per engine/train step, and the window's host
    activity (and the card's, when ``cuda``) lands as a Chrome trace JSON
    under ``profile_dir``.  Strictly best-effort: profiler start/stop
    failures are counted and disable further attempts — a broken profiler
    build must never take down the workload it was meant to explain."""

    IDLE, ACTIVE, DONE = "idle", "active", "done"

    def __init__(
        self, profile_dir: str, start_step: int = 0, num_steps: int = 10, cuda: bool = False
    ) -> None:
        if not profile_dir:
            raise ValueError("profile_dir must be non-empty")
        if start_step < 0:
            raise ValueError(f"start_step must be >= 0, got {start_step}")
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.num_steps = num_steps
        #: record the card's activity too (the run is on a CUDA device)
        self.cuda = cuda
        self.state = self.IDLE
        self.failures = 0
        self._trace: Optional[_TorchTrace] = None

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None, cuda: bool = False) -> Optional["DeviceProfiler"]:
        """``NEXUS_PROFILE_DIR`` arms the capture; ``NEXUS_PROFILE_START``
        (default 0) and ``NEXUS_PROFILE_STEPS`` (default 10) shape the
        window.  None when unarmed — the caller skips the tick entirely.
        Malformed window values DISARM with a warning instead of raising:
        the best-effort contract starts at parse — an observability knob
        must never take down the workload it was meant to explain."""
        e = os.environ if env is None else env
        profile_dir = e.get("NEXUS_PROFILE_DIR", "")
        if not profile_dir:
            return None
        try:
            return DeviceProfiler(
                profile_dir,
                start_step=int(e.get("NEXUS_PROFILE_START", "0")),
                num_steps=int(e.get("NEXUS_PROFILE_STEPS", "10")),
                cuda=cuda,
            )
        except ValueError as exc:  # noqa: BLE001 - best-effort contract: a malformed NEXUS_PROFILE_* value disarms profiling (logged), never kills the serving/training run it rides in
            import logging

            logging.getLogger(__name__).warning(
                "device profiling disarmed: bad NEXUS_PROFILE_* value (%s)", exc
            )
            return None

    def _profiler(self) -> _TorchTrace:
        if self._trace is None:
            self._trace = _TorchTrace(self.cuda)
        return self._trace

    def summary(self) -> Dict[str, Any]:
        """The window's outcome for a run summary: where, how it ended, and
        the counted failures."""
        return {"dir": self.profile_dir, "state": self.state, "failures": self.failures}

    def tick(self, step: int) -> None:
        """Call once per step with the zero-based step number about to
        run; starts capture entering the window and stops it leaving."""
        if self.state == self.IDLE and step >= self.start_step:
            try:
                os.makedirs(self.profile_dir, exist_ok=True)
                self._profiler().start_trace(self.profile_dir)
                self.state = self.ACTIVE
            except Exception:  # noqa: BLE001 - best-effort profiling: a profiler that cannot start (no CUPTI, unwritable dir) is counted and disabled, never a serving/training outage
                self.failures += 1
                self.state = self.DONE
        elif self.state == self.ACTIVE and step >= self.start_step + self.num_steps:
            self.stop()

    def stop(self) -> None:
        """Close an in-flight capture (window end, or end-of-run cleanup
        when the loop finished inside the window)."""
        if self.state != self.ACTIVE:
            return
        try:
            self._profiler().stop_trace()
        except Exception:  # noqa: BLE001 - best-effort profiling: a stop failure loses the capture, not the workload; counted for the summary line
            self.failures += 1
        self.state = self.DONE
