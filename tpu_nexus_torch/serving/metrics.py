"""Serving SLO metrics: TTFT, TPOT, queue depth, slot occupancy.

Emits through the repo's :class:`tpu_nexus.core.telemetry.Metrics`
interface — ``histogram`` for the latency distributions (the DogStatsD
agent owns percentile aggregation in production), ``gauge`` for the
per-step queue/occupancy levels, ``count`` for retirement outcomes — and
additionally keeps in-process samples so ``summary()`` can report
p50/p99 for benches and tests without a metrics backend.

Definitions (the usual LLM-serving SLOs):

* **TTFT** — submit → first token (includes queue wait + prefill);
* **TPOT** — interval between consecutive tokens of one request after the
  first (decode cadence; what a streaming reader perceives);
* **queue depth** — requests waiting for a slot, sampled per step;
* **slot occupancy** — busy slots / total slots, sampled per step.

Window semantics: every latency sample series is a BOUNDED
:class:`RollingQuantile` — a serving process that never restarts must not
grow per-request lists for its lifetime (``dispatch_s`` got this first;
TTFT/TPOT/queue-wait get it here).  ``summary()`` percentiles are computed
over the retained window: EXACT whole-run percentiles for any run shorter
than :data:`ServingMetrics.WINDOW` samples (every bench and test in this
repo), trailing-window percentiles beyond it — the honest semantics for a
long-lived server, where "p99 of everything since boot" is a statistic
nobody wants anyway (the statsd histogram stream remains the unbounded
production view).  ``load_snapshot()``-facing percentiles
(:meth:`ServingMetrics.slo_window`) read a SHORTER recent window
(:data:`ServingMetrics.SNAPSHOT_WINDOW` samples) so the pressure monitor
sees current behavior, not the boot-time tail.
"""

from __future__ import annotations

from collections import deque
from itertools import islice
from typing import Deque, Dict, Iterator, Optional, Sequence

from tpu_nexus_torch.core.telemetry import Metrics, NullMetrics
from tpu_nexus_torch.serving.request import Request


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an UNSORTED sample (q in [0, 100]);
    0.0 on an empty sample — benches handle the degenerate case."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = min(len(ordered) - 1, max(0, int(round(q / 100.0 * (len(ordered) - 1)))))
    return ordered[rank]


class RollingQuantile:
    """Bounded rolling sample window with nearest-rank quantiles.

    The primitive behind the windowed SLO views: appends are
    O(1) into a ``deque(maxlen=window)`` (the hot-path cost — quantiles
    sort lazily, only when somebody asks), ``total`` counts every sample
    ever recorded (including ones the window has since dropped), and
    :meth:`quantile` reads either the whole retained window or just the
    most recent ``recent`` samples (the load-snapshot view).

    List-compatible on the surfaces the existing callers touch —
    ``append`` / ``len`` / iteration / indexing / ``== list`` — so the
    ServingMetrics fields could switch from unbounded lists without
    rewriting every test that inspects them."""

    __slots__ = ("window", "total", "_samples")

    def __init__(self, window: int = 8192) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        #: samples ever recorded (survives the window trim — the honest
        #: denominator for rates)
        self.total = 0
        self._samples: Deque[float] = deque(maxlen=window)

    def append(self, value: float) -> None:
        self._samples.append(float(value))
        self.total += 1

    def quantile(self, q: float, recent: Optional[int] = None) -> float:
        """Nearest-rank percentile (q in [0, 100]) over the retained
        window, or over the most recent ``recent`` samples of it."""
        return self.quantiles((q,), recent=recent)[0]

    def quantiles(
        self, qs: Sequence[float], recent: Optional[int] = None
    ) -> "list[float]":
        """Several nearest-rank percentiles off ONE sort of the window —
        the snapshot path asks for p50+p99 of each series per observation,
        and sorting twice for two ranks of the same sample would double
        the pressure plane's hot-path cost for nothing."""
        if recent is None or recent >= len(self._samples):
            tail = sorted(self._samples)
        elif recent < 1:
            tail = []
        else:
            tail = sorted(
                islice(self._samples, len(self._samples) - recent, None)
            )
        if not tail:
            return [0.0 for _ in qs]
        top = len(tail) - 1
        return [
            tail[min(top, max(0, int(round(q / 100.0 * top))))] for q in qs
        ]

    def __len__(self) -> int:
        return len(self._samples)

    def __bool__(self) -> bool:
        return bool(self._samples)

    def __iter__(self) -> Iterator[float]:
        return iter(self._samples)

    def __getitem__(self, idx: int) -> float:
        return self._samples[idx]

    def __eq__(self, other: object) -> bool:
        # list(self) delegates element comparison to the other side —
        # pytest.approx(list) keeps working against a rolling window
        return list(self._samples) == other

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"RollingQuantile({list(self._samples)!r}, window={self.window})"


class ServingMetrics:
    """Per-engine metrics recorder + telemetry emitter (see module doc)."""

    #: retained samples per latency series (module-doc window semantics):
    #: summary() percentiles are exact up to this many samples, trailing-
    #: window beyond it
    WINDOW = 8192
    #: the load-snapshot view (ServingEngine.load_snapshot / slo_window):
    #: percentiles over only this many most-recent samples, so the
    #: pressure monitor grades CURRENT behavior, not the since-boot tail
    SNAPSHOT_WINDOW = 512

    def __init__(self, metrics: Optional[Metrics] = None) -> None:
        self._m = metrics or NullMetrics()
        self.ttft_s = RollingQuantile(self.WINDOW)
        self.tpot_s = RollingQuantile(self.WINDOW)
        self.queue_wait_s = RollingQuantile(self.WINDOW)
        self.retired: Dict[str, int] = {}
        #: per-CAUSE retirement counts for non-FINISHED outcomes (keys are
        #: the recorded ``Request.cause`` strings: "hbm-oom", "deadline
        #: exceeded", drain wordings, ...) — what the drain protocol reports
        #: into the ledger and the chaos tests audit
        self.retired_causes: Dict[str, int] = {}
        #: admission sheds (bounded queue at capacity / engine draining)
        self.shed_total = 0
        #: classified step faults seen / transient retries spent
        self.step_faults: Dict[str, int] = {}
        self.step_retries = 0
        self.tokens_out = 0
        #: paged-cache reuse: admissions that hit a cached
        #: prefix / prompt tokens served from cache instead of prefill /
        #: copy-on-write block copies — without these the paging win is
        #: invisible in telemetry
        self.prefix_hits = 0
        self.prefix_shared_tokens = 0
        self.blocks_cow_total = 0
        #: speculative decoding: draft tokens proposed /
        #: accepted-AND-emitted, and paged-KV blocks released by verify
        #: rollback.  tokens_out and the TPOT samples count only ACCEPTED
        #: tokens — a proposed-but-rejected draft never inflates
        #: throughput or cadence metrics.
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rollback_blocks_total = 0
        #: drafter failures degraded to no-draft steps (drafts are hints:
        #: a draft-side fault never costs a request — it costs acceptance,
        #: and THIS counter is how that shows up on a dashboard)
        self.draft_faults = 0
        #: last-step token-level occupancy sample (summary convenience;
        #: the gauge stream is the production signal)
        self.token_occupancy = 0.0
        #: last-step deferred-lane sample (overlapped dispatch):
        #: slots whose tokens are dispatched but not yet materialized
        self.deferred_slots = 0
        #: completed hot weight swaps (rolling updates)
        self.weight_swaps_total = 0
        #: flight-recorder incident artifacts written: one per
        #: dump at the StepFault/DeviceStateLost/drain/replica-lost seams
        self.trace_dumps_total = 0
        #: host dispatch seconds per engine step (the flight recorder's
        #: per-step sample, histogrammed so a dashboard sees the host tax
        #: the overlap refactor exists to hide).  BOUNDED (recent window):
        #: this is sampled once per STEP forever, not once per request —
        #: an unbounded list would grow for the life of a serving process
        #: (the statsd histogram stream is the unbounded production view;
        #: summary() percentiles read the recent window)
        self.dispatch_s = RollingQuantile(4096)
        #: (series totals, window dict) — slo_window()'s memo; see its doc
        self._slo_window_cache: Optional[tuple] = None

    def queue_wait(self, seconds: float) -> None:
        """Submit → admission (slot granted), the scheduler-owned slice of
        TTFT — recorded separately so queue pressure is distinguishable
        from prefill cost."""
        self.queue_wait_s.append(seconds)
        self._m.histogram("serving.queue_wait_seconds", seconds)

    def first_token(self, req: Request) -> None:
        assert req.first_token_at is not None
        ttft = req.first_token_at - req.submitted_at
        self.ttft_s.append(ttft)
        self.tokens_out += 1
        self._m.histogram("serving.ttft_seconds", ttft)

    def token_interval(self, dt: Optional[float]) -> None:
        self.tokens_out += 1
        if dt is not None:
            self.tpot_s.append(dt)
            self._m.histogram("serving.tpot_seconds", dt)

    def retired_request(self, req: Request, action: str) -> None:
        self.retired[req.state] = self.retired.get(req.state, 0) + 1
        tags = {"state": action}
        if req.cause:
            self.retired_causes[req.cause] = self.retired_causes.get(req.cause, 0) + 1
            tags["cause"] = req.cause
        self._m.count("serving.requests_retired", tags=tags)

    def shed(self, reason: str) -> None:
        """One over-capacity (or mid-drain) submit rejected at admission."""
        self.shed_total += 1
        self._m.count("serving.shed", tags={"reason": reason})

    def step_fault(self, cause: str, retries: int) -> None:
        """One classified device fault went unrecoverable: ``cause`` is the
        taxonomy token, ``retries`` the transient attempts spent before
        giving up (0 for an immediately-fatal cause).  Retries spent here
        ship on ``serving.step_retries`` too — transient-fault pressure is
        highest exactly when the budget exhausts, and a dashboard that only
        saw recovered retries would under-report the worst regime."""
        self.step_faults[cause] = self.step_faults.get(cause, 0) + 1
        self.step_retries += retries
        self._m.count("serving.step_faults", tags={"cause": cause})
        if retries:
            self._m.count("serving.step_retries", value=retries)

    def step_recovered(self, retries: int) -> None:
        """A transient fault healed within the retry budget — ``retries``
        backoff attempts spent, no request harmed."""
        self.step_retries += retries
        self._m.count("serving.step_retries", value=retries)

    def prefix_hit(self, shared_tokens: int) -> None:
        """One admission reused a cached prompt prefix: ``shared_tokens``
        prompt tokens were served by block reference instead of prefill.
        The counter ≈ fan-out under shared-prompt traffic is the
        prefilled-exactly-once evidence the bench asserts."""
        self.prefix_hits += 1
        self.prefix_shared_tokens += shared_tokens
        self._m.count("serving.prefix_hit")
        self._m.count("serving.prefix_shared_tokens", value=shared_tokens)

    def batch_tokens(self, dt: Optional[float], n: int) -> None:
        """``n`` tokens landed for one request in ONE materialization —
        a speculative verify's accepted prefix, or a k-step decode scan's
        emissions — ``dt`` seconds since the request's previous token
        (None for a first-ever batch).  Counted as ``n`` tokens and ``n``
        TPOT samples of ``dt / n`` each — mean-preserving, so a step that
        lands 4 tokens in one 8 ms call reads as 2 ms/token, not as one
        8 ms sample plus three fake zeros (which would crater the p50)."""
        self.tokens_out += n
        if dt is None or n < 1:
            return
        per_token = dt / n
        for _ in range(n):
            self.tpot_s.append(per_token)
            self._m.histogram("serving.tpot_seconds", per_token)

    def spec_tokens(self, dt: Optional[float], n: int) -> None:
        """``n`` ACCEPTED tokens emitted by one speculative verify for one
        request — the same mean-preserving accounting as every other
        multi-token materialization (:meth:`batch_tokens`)."""
        self.batch_tokens(dt, n)

    def spec_verify(self, proposed: int, accepted: int) -> None:
        """One slot's verify outcome: ``proposed`` draft tokens scored,
        ``accepted`` of them emitted.  The ratio is the honest acceptance
        rate — padding guesses count as proposed, capped emissions do not
        count as accepted."""
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self._m.count("serving.spec_proposed", value=proposed)
        if accepted:
            self._m.count("serving.spec_accepted", value=accepted)

    def draft_fault(self) -> None:
        """One drafter failure degraded to a no-draft step/slot (see the
        engine's ``_propose_safe`` hint boundary)."""
        self.draft_faults += 1
        self._m.count("serving.draft_faults")

    def spec_rollback_blocks(self, n: int) -> None:
        """``n`` paged-KV blocks held ONLY rejected-draft garbage after a
        verify and were released (with regrowth credits) by the rollback."""
        self.spec_rollback_blocks_total += n
        self._m.count("serving.spec_rollback_blocks", value=n)

    def weight_swap(self) -> None:
        """One completed hot weight swap (the engine finished a quiesce and
        installed new verified weights — a rolling-update progress tick)."""
        self.weight_swaps_total += 1
        self._m.count("serving.weight_swaps")

    def trace_dump(self, reason: str) -> None:
        """One flight-recorder incident artifact landed on disk (the
        ``reason`` tag names the seam: step-fault cause, device-state-lost,
        drain, replica-lost)."""
        self.trace_dumps_total += 1
        self._m.count("serving.trace_dumps", tags={"reason": reason})

    def dispatch_time(self, seconds: float) -> None:
        """Host seconds one engine step spent inside jitted dispatches
        (fault-policy attempts included) — the per-step host-tax sample
        the flight recorder also rings."""
        self.dispatch_s.append(seconds)
        self._m.histogram("serving.dispatch_seconds", seconds)

    def blocks_cow(self, n: int = 1) -> None:
        """``n`` copy-on-write block copies at admission (a shared partial
        block diverged)."""
        self.blocks_cow_total += n
        self._m.count("serving.blocks_cow", value=n)

    def step_gauges(
        self,
        queue_depth: int,
        slots_used: int,
        num_slots: int,
        live_tokens: Optional[int] = None,
        token_capacity: int = 0,
        deferred_slots: int = 0,
    ) -> None:
        self._m.gauge("serving.queue_depth", queue_depth)
        self._m.gauge("serving.slot_occupancy", slots_used / max(1, num_slots))
        # deferred (dispatched-but-unmaterialized) lanes, reported
        # DISTINCTLY from the materialized occupancy above: under
        # overlapped dispatch the queue/occupancy gauges reflect the
        # host's one-step-stale view, and this gauge is the honest marker
        # of how many slots have tokens still riding the device
        self.deferred_slots = deferred_slots
        self._m.gauge("serving.deferred_slots", deferred_slots)
        if live_tokens is not None and token_capacity > 0:
            # the paging story in one gauge: slot occupancy can sit at 1.0
            # while token occupancy is tiny — that gap is the HBM the
            # block-granular cache gives back
            self.token_occupancy = live_tokens / token_capacity
            self._m.gauge("serving.token_occupancy", self.token_occupancy)

    def slo_window(self) -> Dict[str, float]:
        """The load-snapshot latency view: TTFT / TPOT /
        queue-wait p50/p99 over the most recent :data:`SNAPSHOT_WINDOW`
        samples of each series — what :meth:`ServingEngine.load_snapshot`
        embeds and the SLO monitor grades.  Distinct from ``summary()``'s
        whole-window percentiles by design: pressure is a statement about
        NOW, and a since-boot p99 buries a regression under history.

        Memoized on the series sample counts: an engine step that retired
        nothing recorded no new latency samples, so the previous window is
        still THE window — decode steady state pays a tuple compare here,
        not three sorts (the bench prices the worst case, a fresh sample
        before every observation)."""
        key = (self.ttft_s.total, self.tpot_s.total, self.queue_wait_s.total)
        cached = self._slo_window_cache
        if cached is not None and cached[0] == key:
            return dict(cached[1])
        w = self.SNAPSHOT_WINDOW
        ttft_p50, ttft_p99 = self.ttft_s.quantiles((50, 99), recent=w)
        tpot_p50, tpot_p99 = self.tpot_s.quantiles((50, 99), recent=w)
        qw_p50, qw_p99 = self.queue_wait_s.quantiles((50, 99), recent=w)
        out = {
            "ttft_p50_s": ttft_p50,
            "ttft_p99_s": ttft_p99,
            "tpot_p50_s": tpot_p50,
            "tpot_p99_s": tpot_p99,
            "queue_wait_p50_s": qw_p50,
            "queue_wait_p99_s": qw_p99,
        }
        self._slo_window_cache = (key, out)
        return dict(out)

    def summary(self) -> Dict[str, float]:
        return {
            "tokens_out": self.tokens_out,
            "requests_retired": dict(self.retired),
            "retired_causes": dict(self.retired_causes),
            "shed": self.shed_total,
            "step_faults": dict(self.step_faults),
            "step_retries": self.step_retries,
            "prefix_hits": self.prefix_hits,
            "prefix_shared_tokens": self.prefix_shared_tokens,
            "blocks_cow": self.blocks_cow_total,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance_rate": (
                self.spec_accepted / self.spec_proposed if self.spec_proposed else 0.0
            ),
            "spec_rollback_blocks": self.spec_rollback_blocks_total,
            "draft_faults": self.draft_faults,
            "weight_swaps": self.weight_swaps_total,
            "trace_dumps": self.trace_dumps_total,
            "dispatch_p50_s": percentile(self.dispatch_s, 50),
            "dispatch_p99_s": percentile(self.dispatch_s, 99),
            "token_occupancy": self.token_occupancy,
            "deferred_slots": self.deferred_slots,
            "ttft_p50_s": percentile(self.ttft_s, 50),
            "ttft_p99_s": percentile(self.ttft_s, 99),
            "tpot_p50_s": percentile(self.tpot_s, 50),
            "tpot_p99_s": percentile(self.tpot_s, 99),
            "queue_wait_p50_s": percentile(self.queue_wait_s, 50),
            "queue_wait_p99_s": percentile(self.queue_wait_s, 99),
        }
