"""Fleet pressure plane: load snapshots + windowed SLO grading.

The paper's supervisor acts only on *observed* state — events classified
into a decision taxonomy.  The serving stack had per-request observability
(the spans + flight recorder) but no machine-readable view of the
SYSTEM: replica load lived only as fire-and-forget statsd datagrams, and
"is this replica keeping its SLOs" was a dashboard question, not a signal
a control loop could consume.  This module is that signal layer — the
prerequisite ROADMAP item 4 (least-loaded routing, autoscaling) names:

* :class:`LoadSnapshot` — one engine's load state as a plain host-int/float
  dataclass (:meth:`ServingEngine.load_snapshot`): queue depth, live
  requests, slot/block occupancy, deferred lanes, weight swaps, and
  *windowed* TTFT/TPOT/queue-wait percentiles
  (:meth:`~tpu_nexus_torch.serving.metrics.ServingMetrics.slo_window`).
  NX014-clean by construction: every field is materialized host state the
  engine already owned — taking a snapshot never touches a device array.
* :class:`FleetSnapshot` — :meth:`ServingFleet.snapshot`'s aggregate: one
  ``LoadSnapshot`` per replica (a DOWN replica is *reported* as down with
  its cause — never silently dropped) plus fleet-level sums.
* :class:`SloMonitor` — grades each replica and the fleet over short/long
  rolling windows into the total pressure taxonomy
  ``HEALTHY / PRESSURED / SATURATED / DOWN`` with burn-rate escalation
  (multiwindow alerting: the short window detects a burn, the long window
  confirms it is sustained before escalating — a one-observation blip can
  reach PRESSURED, only a sustained burn reaches SATURATED).
  ``FleetSupervisor`` consumes it each reconcile: transitions land as
  cause+details JSON on the fleet's RUNNING ledger row and as tagged
  metrics, and SATURATED triggers a flight-recorder dump at the existing
  incident seam (``ServingEngine.dump_pressure``) so a saturation incident
  gets the same drill-down as a fault.

Static contracts (nxlint NX016): the grading tables
(:data:`PRESSURE_SEVERITY`, :data:`PRESSURE_ACTIONS`) are TOTAL over
:data:`PRESSURE_STATES` (the NX001 fails-closed pattern), and every
numeric ``LoadSnapshot``/``FleetSnapshot`` field has a matching
``core/telemetry.METRIC_NAMES`` row under the ``load.`` /  ``fleet.load.``
prefixes — two-way, like NX015 — so a field a dashboard cannot chart (or a
documented gauge no snapshot carries) cannot ship.  Schemas and pressure
semantics: docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from tpu_nexus_torch.core.telemetry import Metrics, NullMetrics

# -- the pressure taxonomy ------------------------------------------------------

PRESSURE_HEALTHY = "healthy"
PRESSURE_PRESSURED = "pressured"
PRESSURE_SATURATED = "saturated"
PRESSURE_DOWN = "down"

#: the total pressure state space — every grading table below must cover
#: EXACTLY these states (nxlint NX016, the NX001 taxonomy-totality pattern)
PRESSURE_STATES: Tuple[str, ...] = (
    PRESSURE_HEALTHY,
    PRESSURE_PRESSURED,
    PRESSURE_SATURATED,
    PRESSURE_DOWN,
)

#: pressure grade -> severity rank, TOTAL over PRESSURE_STATES (NX016).
#: Ordering is the fleet-grade aggregation rule: the fleet is as pressured
#: as its worst live replica.
PRESSURE_SEVERITY: Dict[str, int] = {
    PRESSURE_HEALTHY: 0,
    PRESSURE_PRESSURED: 1,
    PRESSURE_SATURATED: 2,
    PRESSURE_DOWN: 3,
}

#: pressure grade ENTERED -> supervisor consequence, TOTAL over
#: PRESSURE_STATES (NX016).  Every transition is recorded (ledger cause +
#: details, tagged metric); "record+dump" additionally serializes the
#: replica's flight recorder at the saturation incident seam; "record"
#: into DOWN is deliberate — pod recovery (SERVING_POD_RECOVERY) owns the
#: replica itself, the pressure plane only observes the capacity loss.
PRESSURE_ACTIONS: Dict[str, str] = {
    PRESSURE_HEALTHY: "record",
    PRESSURE_PRESSURED: "record",
    PRESSURE_SATURATED: "record+dump",
    PRESSURE_DOWN: "record",
}


def worst_pressure(grades: "list[str]") -> str:
    """The most severe grade of a non-empty list — indexing through
    :data:`PRESSURE_SEVERITY`, so an unknown grade fails loudly instead of
    sorting arbitrarily."""
    return max(grades, key=lambda g: PRESSURE_SEVERITY[g])


# -- snapshots ------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class LoadSnapshot:
    """One engine's load state, all plain host ints/floats (module doc).

    Every NUMERIC field here has a ``load.<field>`` row in
    ``core/telemetry.METRIC_NAMES`` and a matching literal gauge in
    :func:`emit_load_snapshot` — nxlint NX016/NX015 hold the three-way
    parity.  ``queue_depth`` IS the queued-request count (requests
    admitted by ``submit`` but not yet holding a slot); ``live_requests``
    are the in-flight (slot-holding) ones.  ``blocks_*`` are 0 on a
    non-paged engine; ``blocks_reclaimable`` is the SAMPLED prefix-trie
    walk (the flight recorder's cadence — never a per-snapshot full
    walk).  The six percentile fields are the RECENT-window view
    (``ServingMetrics.slo_window``), not whole-run statistics."""

    replica: str = ""
    #: replica lifecycle state ("serving" / "reloading" / "down") — filled
    #: by the fleet; a bare engine snapshot reports "serving"
    state: str = "serving"
    #: why a DOWN replica went down (empty otherwise)
    down_cause: str = ""
    queue_depth: int = 0
    live_requests: int = 0
    slots_used: int = 0
    slots_free: int = 0
    deferred_slots: int = 0
    token_occupancy: float = 0.0
    blocks_used: int = 0
    blocks_free: int = 0
    blocks_reclaimable: int = 0
    #: stored weight-tree bytes at the executor's serving width (packed
    #: int8/int4 counted at their quantized size) — the replicas-per-chip
    #: headroom weight quantization buys, visible per fleet snapshot
    weight_bytes: int = 0
    weight_swaps: int = 0
    shed_total: int = 0
    requests_retired: int = 0
    tokens_out: int = 0
    engine_steps: int = 0
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    tpot_p50_s: float = 0.0
    tpot_p99_s: float = 0.0
    queue_wait_p50_s: float = 0.0
    queue_wait_p99_s: float = 0.0

    @staticmethod
    def down(replica: str, cause: str = "") -> "LoadSnapshot":
        """The DOWN placeholder: a dead replica's engine is gone, but the
        fleet snapshot must still REPORT it (never silently drop it) —
        zeros for load, the lifecycle state and cause carried."""
        return LoadSnapshot(replica=replica, state=PRESSURE_DOWN, down_cause=cause)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, float):
                value = round(value, 6)
            if value or f.name in ("replica", "state"):
                out[f.name] = value
        return out


@dataclass(frozen=True, slots=True)
class FleetSnapshot:
    """The fleet aggregate: per-replica :class:`LoadSnapshot` (down
    replicas included, as DOWN) plus fleet-level sums over the LIVE
    replicas.  Numeric fields mirror into ``fleet.load.<field>`` registry
    rows exactly like the per-replica ones (NX016)."""

    replicas: Dict[str, LoadSnapshot] = field(default_factory=dict)
    replicas_total: int = 0
    replicas_serving: int = 0
    replicas_reloading: int = 0
    replicas_down: int = 0
    queue_depth: int = 0
    live_requests: int = 0
    shed_total: int = 0
    tokens_out: int = 0

    @staticmethod
    def aggregate(replicas: Dict[str, LoadSnapshot]) -> "FleetSnapshot":
        # one pass over the replicas — this runs per pressure observation
        # (every engine step in the bench's conservative-ceiling regime)
        serving = reloading = down = 0
        queue_depth = live_requests = shed_total = tokens_out = 0
        for s in replicas.values():
            if s.state == PRESSURE_DOWN:
                down += 1
                continue
            if s.state == "serving":
                serving += 1
            elif s.state == "reloading":
                reloading += 1
            queue_depth += s.queue_depth
            live_requests += s.live_requests
            shed_total += s.shed_total
            tokens_out += s.tokens_out
        return FleetSnapshot(
            replicas=dict(replicas),
            replicas_total=len(replicas),
            replicas_serving=serving,
            replicas_reloading=reloading,
            replicas_down=down,
            queue_depth=queue_depth,
            live_requests=live_requests,
            shed_total=shed_total,
            tokens_out=tokens_out,
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "replicas"
        }
        out["replicas"] = {
            name: snap.to_dict() for name, snap in self.replicas.items()
        }
        return out


def numeric_fields(cls) -> Tuple[str, ...]:
    """The snapshot fields the metric registry must mirror (NX016's
    runtime twin — the tests cross-check this against the static rule):
    every dataclass field annotated ``int`` or ``float``."""
    return tuple(
        f.name for f in dataclasses.fields(cls) if f.type in ("int", "float")
    )


def emit_load_snapshot(
    metrics: Metrics, snap: LoadSnapshot, replica: str = ""
) -> None:
    """Gauge every numeric field of one replica snapshot, tagged by
    replica.  One LITERAL call per field — the registry (NX015) cannot
    vouch for names computed at runtime, and NX016's field parity keeps
    this list complete: a new snapshot field without its gauge (or row)
    fails the lint, not the dashboard."""
    tags = {"replica": replica or snap.replica or "engine"}
    metrics.gauge("load.queue_depth", snap.queue_depth, tags=tags)
    metrics.gauge("load.live_requests", snap.live_requests, tags=tags)
    metrics.gauge("load.slots_used", snap.slots_used, tags=tags)
    metrics.gauge("load.slots_free", snap.slots_free, tags=tags)
    metrics.gauge("load.deferred_slots", snap.deferred_slots, tags=tags)
    metrics.gauge("load.token_occupancy", snap.token_occupancy, tags=tags)
    metrics.gauge("load.blocks_used", snap.blocks_used, tags=tags)
    metrics.gauge("load.blocks_free", snap.blocks_free, tags=tags)
    metrics.gauge("load.blocks_reclaimable", snap.blocks_reclaimable, tags=tags)
    metrics.gauge("load.weight_bytes", snap.weight_bytes, tags=tags)
    metrics.gauge("load.weight_swaps", snap.weight_swaps, tags=tags)
    metrics.gauge("load.shed_total", snap.shed_total, tags=tags)
    metrics.gauge("load.requests_retired", snap.requests_retired, tags=tags)
    metrics.gauge("load.tokens_out", snap.tokens_out, tags=tags)
    metrics.gauge("load.engine_steps", snap.engine_steps, tags=tags)
    metrics.gauge("load.ttft_p50_s", snap.ttft_p50_s, tags=tags)
    metrics.gauge("load.ttft_p99_s", snap.ttft_p99_s, tags=tags)
    metrics.gauge("load.tpot_p50_s", snap.tpot_p50_s, tags=tags)
    metrics.gauge("load.tpot_p99_s", snap.tpot_p99_s, tags=tags)
    metrics.gauge("load.queue_wait_p50_s", snap.queue_wait_p50_s, tags=tags)
    metrics.gauge("load.queue_wait_p99_s", snap.queue_wait_p99_s, tags=tags)


def emit_fleet_snapshot(metrics: Metrics, snap: FleetSnapshot) -> None:
    """Gauge the fleet aggregates + every live replica's snapshot.  Down
    replicas emit nothing numeric (their zeros would read as 'idle', the
    opposite of the truth) — capacity loss shows on
    ``fleet.load.replicas_down``."""
    metrics.gauge("fleet.load.replicas_total", snap.replicas_total)
    metrics.gauge("fleet.load.replicas_serving", snap.replicas_serving)
    metrics.gauge("fleet.load.replicas_reloading", snap.replicas_reloading)
    metrics.gauge("fleet.load.replicas_down", snap.replicas_down)
    metrics.gauge("fleet.load.queue_depth", snap.queue_depth)
    metrics.gauge("fleet.load.live_requests", snap.live_requests)
    metrics.gauge("fleet.load.shed_total", snap.shed_total)
    metrics.gauge("fleet.load.tokens_out", snap.tokens_out)
    for name, rep_snap in snap.replicas.items():
        if rep_snap.state != PRESSURE_DOWN:
            emit_load_snapshot(metrics, rep_snap, replica=name)


# -- SLO targets + the monitor --------------------------------------------------


@dataclass(frozen=True)
class SloTargets:
    """The graded SLOs, validated at construction (the ServeConfig parse
    path, so a bad ``NEXUS_SLO_*`` env fails before any device work).

    A target of 0 disables that dimension; at least one must be enabled —
    a monitor with nothing to grade is a config bug, not a quiet day.
    ``shed_rate`` grades the fraction of outcomes that were admission
    sheds between consecutive observations (sheds / (sheds + retirements));
    the latency targets grade the snapshot's recent-window p99s."""

    ttft_p99_s: float = 0.0
    tpot_p99_s: float = 0.0
    shed_rate: float = 0.0
    #: burn windows, in OBSERVATIONS (supervisor reconciles): the short
    #: window detects a burn, the long one confirms it is sustained
    short_window: int = 4
    long_window: int = 12
    #: fraction of the short window that must violate to leave HEALTHY
    pressured_burn: float = 0.5
    #: fraction of the FULL long window that must violate (on top of a
    #: burning short window) to escalate PRESSURED -> SATURATED
    saturated_burn: float = 0.5

    def __post_init__(self) -> None:
        for name in ("ttft_p99_s", "tpot_p99_s", "shed_rate"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
        if self.shed_rate > 1.0:
            raise ValueError(
                f"shed_rate is a fraction in [0, 1], got {self.shed_rate}"
            )
        if not (self.ttft_p99_s or self.tpot_p99_s or self.shed_rate):
            raise ValueError(
                "SloTargets with every target disabled grades nothing — "
                "set at least one of ttft_p99_s / tpot_p99_s / shed_rate"
            )
        if self.short_window < 1 or self.long_window < 1:
            raise ValueError(
                f"windows must be >= 1 observation, got short={self.short_window} "
                f"long={self.long_window}"
            )
        if self.short_window > self.long_window:
            raise ValueError(
                f"short_window {self.short_window} must not exceed "
                f"long_window {self.long_window} — the long window is the "
                "confirmation the short one escalates through"
            )
        for name in ("pressured_burn", "saturated_burn"):
            if not 0.0 < getattr(self, name) <= 1.0:
                raise ValueError(
                    f"{name} is a burn fraction in (0, 1], got {getattr(self, name)}"
                )


class SloMonitor:
    """Windowed pressure grading with burn-rate escalation (module doc).

    Feed it one :class:`FleetSnapshot` per control-loop tick
    (:meth:`observe`); it grades every replica and the fleet, returns the
    TRANSITIONS that tick caused, and keeps ``grades`` current.  Grading
    rules, per replica:

    * ``DOWN`` — the snapshot reports the replica down.  Its burn history
      clears: a recreated replica restarts its grading from scratch (a
      fresh engine inherits nothing from the incarnation that died).
    * one burn sample per observation: ``True`` iff ANY enabled target is
      violated (recent-window p99 over target; shed fraction over target).
    * ``PRESSURED`` — burn over the short window >= ``pressured_burn``.
    * ``SATURATED`` — PRESSURED *and* the long window is FULL with burn
      >= ``saturated_burn``.  By design a replica cannot saturate before
      ``long_window`` observations exist: burn-rate escalation needs its
      confirmation window, otherwise one bad first sample would page.
    * ``HEALTHY`` — otherwise (burns below threshold age violations out
      of the windows; recovery is a recorded transition like any other).

    The fleet grade is :func:`worst_pressure` over the LIVE replicas,
    bumped to at least PRESSURED while any replica is down (lost capacity
    is pressure even when the survivors are meeting their SLOs), and DOWN
    when nothing is live.  All dispatch goes through the TOTAL tables
    above — an unknown grade is a loud KeyError, not a silent skip."""

    FLEET = "fleet"

    def __init__(
        self,
        targets: SloTargets,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
        transitions_limit: int = 1024,
    ) -> None:
        self.targets = targets
        self._m = metrics or NullMetrics()
        self._clock = clock
        #: current grade per scope (replica names + FLEET)
        self.grades: Dict[str, str] = {}
        self._burn: Dict[str, Deque[bool]] = {}
        #: last (shed_total, requests_retired) per replica for the
        #: shed-rate delta
        self._last_counts: Dict[str, Tuple[int, int]] = {}
        #: bounded transition log (front-trimmed) — what the supervisor
        #: records; tests audit it
        self.transitions: List[Dict[str, Any]] = []
        self._transitions_limit = transitions_limit
        self.observations = 0

    # -- grading ---------------------------------------------------------------

    def violations(self, snap: LoadSnapshot) -> List[str]:
        """Which enabled targets this snapshot violates (one observation's
        burn evidence).  Latency dimensions only grade once samples exist
        (a zero p99 from an idle replica is absence, not compliance-by-
        default — but also not a violation).  The shed dimension grades
        the DELTA between consecutive observations, so a scope's first
        sighting only seeds the baseline — a monitor attached to an
        already-warm engine must not grade its since-boot counters as if
        they accrued in one interval."""
        t = self.targets
        out: List[str] = []
        if t.ttft_p99_s and snap.ttft_p99_s > t.ttft_p99_s:
            out.append("ttft")
        if t.tpot_p99_s and snap.tpot_p99_s > t.tpot_p99_s:
            out.append("tpot")
        if t.shed_rate and snap.replica in self._last_counts:
            last_shed, last_retired = self._last_counts[snap.replica]
            d_shed = max(0, snap.shed_total - last_shed)
            d_retired = max(0, snap.requests_retired - last_retired)
            if d_shed and d_shed / (d_shed + d_retired) > t.shed_rate:
                out.append("shed")
        return out

    def _burn_rates(self, scope: str) -> Tuple[float, float, bool]:
        hist = self._burn[scope]
        short = list(hist)[-self.targets.short_window:]
        short_burn = sum(short) / len(short) if short else 0.0
        long_burn = sum(hist) / len(hist) if hist else 0.0
        return short_burn, long_burn, len(hist) == self.targets.long_window

    def _grade_replica(self, snap: LoadSnapshot) -> Tuple[str, Dict[str, Any]]:
        scope = snap.replica
        if snap.state == PRESSURE_DOWN:
            self._burn.pop(scope, None)
            self._last_counts.pop(scope, None)
            return PRESSURE_DOWN, {"cause": snap.down_cause}
        violated = self.violations(snap)
        self._last_counts[scope] = (snap.shed_total, snap.requests_retired)
        hist = self._burn.setdefault(
            scope, deque(maxlen=self.targets.long_window)
        )
        hist.append(bool(violated))
        short_burn, long_burn, long_full = self._burn_rates(scope)
        evidence = {
            "violated": violated,
            "short_burn": round(short_burn, 4),
            "long_burn": round(long_burn, 4),
        }
        if short_burn >= self.targets.pressured_burn:
            if long_full and long_burn >= self.targets.saturated_burn:
                return PRESSURE_SATURATED, evidence
            return PRESSURE_PRESSURED, evidence
        return PRESSURE_HEALTHY, evidence

    def observe(self, snapshot: FleetSnapshot) -> List[Dict[str, Any]]:
        """Grade one fleet snapshot; returns the transitions it caused
        (``{scope, from, to, action, ...evidence}``), newest grades in
        ``self.grades``.  Scopes that left the fleet are forgotten."""
        self.observations += 1
        transitions: List[Dict[str, Any]] = []
        live_grades: List[str] = []
        for name, snap in snapshot.replicas.items():
            grade, evidence = self._grade_replica(snap)
            if snap.state != PRESSURE_DOWN:
                live_grades.append(grade)
            self._transition(name, grade, evidence, transitions)
        if not live_grades:
            fleet_grade = PRESSURE_DOWN
            evidence = {"cause": "no live replicas"}
        else:
            fleet_grade = worst_pressure(live_grades)
            if (
                snapshot.replicas_down
                and PRESSURE_SEVERITY[fleet_grade]
                < PRESSURE_SEVERITY[PRESSURE_PRESSURED]
            ):
                fleet_grade = PRESSURE_PRESSURED
            evidence = {
                "replicas_down": snapshot.replicas_down,
                "worst_live": worst_pressure(live_grades),
            }
        self._transition(self.FLEET, fleet_grade, evidence, transitions)
        # drop state for replicas no longer in the snapshot (removed from
        # the fleet) — a name reused later starts a fresh history
        gone = (
            set(self.grades) - set(snapshot.replicas) - {self.FLEET}
        )
        for name in gone:
            self.grades.pop(name, None)
            self._burn.pop(name, None)
            self._last_counts.pop(name, None)
        return transitions

    def _transition(
        self,
        scope: str,
        grade: str,
        evidence: Dict[str, Any],
        out: List[Dict[str, Any]],
    ) -> None:
        previous = self.grades.get(scope, PRESSURE_HEALTHY)
        self.grades[scope] = grade
        self._m.gauge(
            "fleet.pressure_level", PRESSURE_SEVERITY[grade], tags={"scope": scope}
        )
        if grade == previous:
            return
        record = {
            "scope": scope,
            "from": previous,
            "to": grade,
            "action": PRESSURE_ACTIONS[grade],
            "t": self._clock(),
            **evidence,
        }
        out.append(record)
        self.transitions.append(record)
        if len(self.transitions) > self._transitions_limit:
            del self.transitions[: len(self.transitions) - self._transitions_limit]
        self._m.count(
            "fleet.pressure_transitions",
            tags={"scope": scope, "from": previous, "to": grade},
        )

    def summary(self) -> Dict[str, Any]:
        return {
            "grades": dict(self.grades),
            "observations": self.observations,
            "transitions": len(self.transitions),
        }
