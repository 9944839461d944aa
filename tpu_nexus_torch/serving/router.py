"""Fleet router + autoscale policy: the decision layer that turns the
pressure plane (serving/loadstats.py) into routed traffic and capacity
changes.  The port of ``tpu_nexus/serving/router.py``, its imports changed.

``ServingFleet.submit`` used to be blind round-robin: a saturated replica
shed ``QueueFull`` while its neighbor sat idle, and a prefix cached on
replica A was re-prefilled on replica B (the 48x fan-out bench paid this
per replica).  :class:`FleetRouter` closes both gaps with three
compounding layers:

* **Prefix affinity** — every candidate replica is probed through
  ``ServingEngine.prefix_shared_len`` (a strictly read-only
  ``PrefixIndex.lookup(touch=False)``: an affinity probe must not refresh
  LRU clocks on replicas the request never lands on) and the request
  prefers the replica already holding the longest cached prefix.  A
  bounded sticky map keyed by the hash of the prompt's LEADING FULL
  BLOCKS covers the registration gap: the trie only learns a prefix when
  its first request's prefill COMPLETES, so a fan-out burst arriving
  within one step would scatter before any probe can see the prefix —
  the sticky entry routes wave one to the same replica the first arrival
  chose, worth exactly one block so a genuinely longer cached prefix
  elsewhere still wins.
* **Least-loaded admission with shed-and-retry** — candidates are scored
  from ``ServingFleet.snapshot()`` (:func:`load_score`: queue depth +
  in-flight + weighted token occupancy + recent TTFT/TPOT p99) and tried
  best-first.  A per-replica ``QueueFull`` is no longer terminal: the
  refusal (replica + cause) is recorded, ``serving.router_retry``
  counted, and the request tries the next-best replica — a replica that
  died between snapshot and submit (state re-check, ``FleetError``) is
  retried the same way.  Only fleet-wide exhaustion surfaces as a shed
  (``serving.fleet_shed``), and THAT ``QueueFull`` carries every replica
  tried and why each refused; a request that eventually landed carries
  its retry path on the trace timeline (``EV_ROUTER_RETRY``).
* **Scale decisions** — :data:`SCALE_DECISIONS` maps the SLO monitor's
  fleet grade to a capacity verdict; ``FleetSupervisor`` executes it
  (streaks + cooldown, serving/fleet.py) through the same pod
  create/delete seams as failure recovery.

Both decision tables are TOTAL over ``PRESSURE_STATES``.  In the JAX
package nxlint NX021 holds them to it; nxlint scans ``tpu_nexus/`` only,
so ``tests/test_torch_router.py`` checks the port's tables (equal to the
reference's, total over the port's ``PRESSURE_STATES``).
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from tpu_nexus_torch.core.telemetry import Metrics, NullMetrics
from tpu_nexus_torch.serving.loadstats import (
    PRESSURE_DOWN,
    FleetSnapshot,
    LoadSnapshot,
)
from tpu_nexus_torch.serving.request import Request
from tpu_nexus_torch.serving.scheduler import QueueFull
from tpu_nexus_torch.serving.tracing import EV_ROUTER_RETRY

logger = logging.getLogger(__name__)

#: router policies (NEXUS_ROUTER_POLICY): "pressure" is the full
#: affinity + least-loaded scorer; "round-robin" keeps the plain
#: rotation (still with shed-and-retry — retrying elsewhere is a
#: correctness property, not a policy choice) as the bench baseline
ROUTER_PRESSURE = "pressure"
ROUTER_ROUND_ROBIN = "round-robin"
ROUTER_POLICIES: Tuple[str, ...] = (ROUTER_PRESSURE, ROUTER_ROUND_ROBIN)

#: pressure grade -> admission eligibility, TOTAL over PRESSURE_STATES
#: (NX021 in the JAX package).  "prefer" and "accept" differ only in
#: rank; "avoid" keeps a SATURATED replica as a LAST resort (capacity
#: behind an SLO burn still beats a fleet-wide shed); "never" excludes it
#: outright — a DOWN replica has no engine to refuse politely.
ROUTE_ELIGIBILITY: Dict[str, str] = {
    "healthy": "prefer",
    "pressured": "accept",
    "saturated": "avoid",
    "down": "never",
}

#: eligibility -> candidate tier (lower tries first); "never" has no tier
ELIGIBILITY_RANK: Dict[str, int] = {"prefer": 0, "accept": 1, "avoid": 2}

SCALE_UP = "scale-up"
SCALE_HOLD = "hold"
SCALE_DOWN_WHEN_IDLE = "scale-down-when-idle"

#: fleet pressure grade -> capacity verdict, TOTAL over PRESSURE_STATES
#: (NX021 in the JAX package).  "down" -> "hold" is deliberate: a DOWN
#: fleet is a pod problem, and pod recovery (SERVING_POD_RECOVERY) owns
#: it — minting extra replicas while recreates are in flight would double
#: capacity the moment they land.  HEALTHY only scales down when the fleet is also
#: IDLE (the supervisor checks queue_depth == live_requests == 0), hence
#: the verdict's name.
SCALE_DECISIONS: Dict[str, str] = {
    "healthy": SCALE_DOWN_WHEN_IDLE,
    "pressured": SCALE_HOLD,
    "saturated": SCALE_UP,
    "down": SCALE_HOLD,
}


@dataclass(frozen=True)
class AutoscaleConfig:
    """Supervisor autoscaling bounds + hysteresis (docs/SERVING.md).
    ``scale_up_after``/``scale_down_after`` are CONSECUTIVE reconciles the
    scale verdict must hold (idle included, for scale-down) before the
    supervisor acts; ``cooldown_s`` then gates the NEXT action of either
    direction — both together are what keep a flapping grade from
    thrashing pods."""

    min_replicas: int
    max_replicas: int
    scale_up_after: int = 3
    scale_down_after: int = 12
    cooldown_s: float = 60.0

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError(
                f"autoscale min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscale max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if self.scale_up_after < 1 or self.scale_down_after < 1:
            raise ValueError(
                "autoscale streak thresholds must be >= 1, got "
                f"up_after={self.scale_up_after} down_after={self.scale_down_after}"
            )
        if self.cooldown_s < 0:
            raise ValueError(
                f"autoscale cooldown_s must be >= 0, got {self.cooldown_s}"
            )


def load_score(snap: LoadSnapshot) -> float:
    """Lower routes first.  Queue depth and in-flight count are the
    direct backlog; token occupancy (0..1) weighs how full the KV cache
    is (an occupied cache is the next shed); the recent-window TTFT/TPOT
    p99s fold in how the replica has actually been FEELING to clients —
    two replicas with equal backlog but unequal tail latency are not
    equally good homes.  Weights documented in docs/SERVING.md."""
    return (
        float(snap.queue_depth)
        + float(snap.live_requests)
        + 4.0 * float(snap.token_occupancy)
        + 8.0 * (float(snap.ttft_p99_s) + float(snap.tpot_p99_s))
    )


class FleetRouter:
    """The fleet's admission path (module doc): rank candidates, try them
    in order, record every refusal.  Owned by :class:`ServingFleet`
    (``fleet.router``); ``slo`` is anything with a ``grades`` dict
    (normally the supervisor's :class:`SloMonitor`) — without one every
    live replica grades healthy and routing is pure affinity + load."""

    def __init__(
        self,
        fleet: Any,
        policy: str = ROUTER_PRESSURE,
        metrics: Optional[Metrics] = None,
        slo: Optional[Any] = None,
        sticky_entries: int = 4096,
        sticky_blocks: int = 8,
    ) -> None:
        if policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router policy {policy!r} (expected one of {ROUTER_POLICIES})"
            )
        self.fleet = fleet
        self.policy = policy
        self.slo = slo
        self._m = metrics or NullMetrics()
        self._rr = 0
        #: affinity-key -> last replica that ACCEPTED that prefix, bounded
        #: LRU (a front door sees unbounded distinct prompts; the sticky
        #: map must not grow with them)
        self._sticky: "OrderedDict[int, str]" = OrderedDict()
        self._sticky_entries = sticky_entries
        #: cap on how many leading blocks the affinity key hashes — the
        #: key exists to co-locate a fan-out's FIRST wave, not to
        #: fingerprint whole prompts
        self._sticky_blocks = sticky_blocks
        # observability (tests + dashboards)
        self.retries = 0
        self.fleet_sheds = 0
        #: the LAST submit's refusal path, ``(replica, cause)`` hops —
        #: what the chaos drills assert causes against
        self.last_refusals: List[Tuple[str, str]] = []

    # -- affinity ----------------------------------------------------------------

    def _page_size(self) -> int:
        """The fleet's prefix-block granularity: the first live paged
        replica's page size (fleets mix paged/contiguous only in tests;
        a fully contiguous fleet has no prefix cache and no affinity)."""
        for rep in self.fleet.replicas.values():
            paged = getattr(rep.engine, "paged", None)
            if paged is not None:
                return int(paged.page_size)
        return 0

    def _affinity_key(self, prompt: Any) -> Optional[int]:
        """Hash of the prompt's leading FULL blocks (the trie's unit of
        sharing), None when the prompt has no full block or the fleet has
        no paged replica.  ``len - 1``: the probe clamp — the final token
        always re-prefills, so it can never be part of a shared block."""
        ps = self._page_size()
        if ps <= 0:
            return None
        n_full = min((len(prompt) - 1) // ps, self._sticky_blocks)
        if n_full <= 0:
            return None
        return hash(tuple(int(t) for t in prompt[: n_full * ps]))

    def _remember(self, key: Optional[int], replica: str) -> None:
        if key is None:
            return
        self._sticky[key] = replica
        self._sticky.move_to_end(key)
        while len(self._sticky) > self._sticky_entries:
            self._sticky.popitem(last=False)

    # -- candidate ranking -------------------------------------------------------

    def _grade(self, name: str, snap: LoadSnapshot) -> str:
        """The replica's pressure grade: the SLO monitor's when one is
        wired, else derived from the snapshot (down is down; any live
        replica without a monitor grades healthy)."""
        if self.slo is not None:
            grade = self.slo.grades.get(name)
            if grade is not None:
                return grade
        return PRESSURE_DOWN if snap.state == PRESSURE_DOWN else "healthy"

    def plan(
        self,
        prompt: Any,
        role: Optional[str] = None,
        by_blocks: bool = False,
    ) -> List[str]:
        """Candidate replicas in try-order.  Pressure policy: eligibility
        tier (ROUTE_ELIGIBILITY via the grade), then longest shared
        prefix, then :func:`load_score`, then name (determinism).  The
        fuzz drills call this directly to check the invariants (a DOWN or
        non-serving replica never appears).

        Disaggregated serving: ``role`` restricts candidates to
        one pool (``EngineReplica.role``) — admissions go to the PREFILL
        pool by load, and ``by_blocks=True`` ranks a migrated request's
        DECODE candidates by free KV blocks (most free first) instead of
        prefix affinity: the handed-off payload brings its own blocks, so
        block headroom, not cached prefixes, decides where it fits."""
        snapshot: FleetSnapshot = self.fleet.snapshot()

        def in_role(name: str) -> bool:
            if role is None:
                return True
            rep = self.fleet.replicas.get(name)
            return rep is not None and getattr(rep, "role", "fused") == role

        if self.policy == ROUTER_ROUND_ROBIN:
            names = [
                name
                for name, snap in snapshot.replicas.items()
                if snap.state == "serving" and in_role(name)
            ]
            if not names:
                return []
            start = self._rr % len(names)
            return names[start:] + names[:start]
        sticky = self._sticky.get(self._affinity_key(prompt))
        ranked: List[Tuple[int, float, float, str]] = []
        ps = self._page_size()
        for name, snap in snapshot.replicas.items():
            if snap.state != "serving" or not in_role(name):
                continue
            tier = ELIGIBILITY_RANK.get(ROUTE_ELIGIBILITY[self._grade(name, snap)])
            if tier is None:  # "never"
                continue
            if by_blocks:
                ranked.append(
                    (tier, -float(snap.blocks_free), load_score(snap), name)
                )
                continue
            rep = self.fleet.replicas.get(name)
            affinity = rep.engine.prefix_shared_len(prompt) if rep is not None else 0
            if name == sticky:
                # worth one block: covers the pre-registration window of a
                # fan-out burst without ever outbidding a longer REAL match
                affinity = max(affinity, ps)
            ranked.append((tier, -float(affinity), load_score(snap), name))
        ranked.sort()
        return [name for _, _, _, name in ranked]

    # -- admission ---------------------------------------------------------------

    @staticmethod
    def _refusal_cause(exc: BaseException) -> str:
        """Compact, bounded-cardinality cause for a per-replica refusal
        (rides metric tags — must not embed the free-form message)."""
        msg = str(exc)
        if "drain" in msg:
            return "draining"
        if "reload" in msg:
            return "reloading"
        return "queue-full"

    def submit(
        self,
        prompt: Any,
        max_new_tokens: int,
        request_id: str,
        deadline_s: Optional[float] = None,
    ) -> Request:
        """Try the ranked candidates until one admits the request (module
        doc).  ``ValueError`` (never-fits prompt, duplicate id) is a
        caller bug on EVERY replica and propagates immediately — retrying
        it elsewhere would just repeat the refusal N times."""
        from tpu_nexus_torch.serving.fleet import FleetError

        order = self.plan(prompt)
        refusals: List[Tuple[str, str]] = []
        req: Optional[Request] = None
        accepted_by = ""
        for name in order:
            rep = self.fleet.replicas.get(name)
            # snapshot-to-submit race: a replica can die (or start a
            # reload) between ranking and this attempt — that is a
            # refusal to record and route past, never an error to raise
            if rep is None or rep.state != "serving":
                refusals.append(
                    (name, "replica-gone" if rep is None else f"state:{rep.state}")
                )
                continue
            try:
                req = rep.engine.submit(
                    prompt,
                    max_new_tokens,
                    request_id=request_id,
                    deadline_s=deadline_s,
                )
            except QueueFull as exc:  # noqa: BLE001 - a per-replica shed is the ROUTED outcome, not a failure: the replica counted it on serving.shed, the router records the hop and tries the next-best replica (this fan-out is what makes one replica's pause zero-drop fleet-wide)
                refusals.append((name, self._refusal_cause(exc)))
                continue
            except FleetError as exc:  # noqa: BLE001 - the replica died between snapshot and submit (satellite: dead-replica race) — same routed outcome as QueueFull, with the loss named in the hop
                refusals.append((name, f"replica-error:{exc}"))
                continue
            accepted_by = name
            break
        self.last_refusals = refusals
        if req is None:
            self.fleet_sheds += 1
            self._m.count("serving.fleet_shed")
            down = sum(
                1
                for r in self.fleet.replicas.values()
                if r.state == PRESSURE_DOWN
            )
            reloading = sum(
                1 for r in self.fleet.replicas.values() if r.state == "reloading"
            )
            detail = (
                "; tried " + ", ".join(f"{n} ({c})" for n, c in refusals)
                if refusals
                else ""
            )
            raise QueueFull(
                f"request {request_id}: no serving replica accepted "
                f"({down} down, {reloading} reloading){detail}"
            )
        for name, cause in refusals:
            self.retries += 1
            self._m.count(
                "serving.router_retry",
                tags={"replica": name, "cause": cause.split(":", 1)[0]},
            )
        if refusals:
            rep = self.fleet.replicas[accepted_by]
            rep.engine.tracer.event(
                req,
                EV_ROUTER_RETRY,
                {"tried": [f"{n}:{c}" for n, c in refusals], "landed": accepted_by},
            )
        if self.policy == ROUTER_ROUND_ROBIN:
            self._rr += 1
        else:
            self._remember(self._affinity_key(prompt), accepted_by)
        return req
