"""The port's fleet router (``tpu_nexus_torch/serving/router.py``) on the CPU.

* The cases of ``tests/test_fleet_routing.py``: the decision tables,
  ranking, shed-and-retry elsewhere, the snapshot-to-submit race, a
  mid-burst kill, prefix affinity, the multi-seed fuzz and the
  supervisor's autoscaling (scale up on a SATURATED fleet, down when
  idle; cooldown and ``max_replicas`` gates), against the port's fleet
  over fake executors (tokens a pure function of the prompt).
* A fleet and supervisor built by ``build_fleet_supervisor`` from a
  ``ServeConfig`` env route round-robin, grade with the env's SLO
  targets, scale in its autoscale bounds and recreate with its KV budget.
* The port's four router tables equal the JAX package's and are total
  over the port's ``loadstats.PRESSURE_STATES`` (nxlint NX021 reads only
  ``tpu_nexus/serving/router.py``; this test stands in for it there).
* One recorded request trace (submits, ticks, a pause, a kill, grades)
  through both packages' ``FleetRouter.plan`` over the same fakes gives
  the same replica order at every submit.
* The fan-out workload (one shared prefix, unique tails) through a paged
  fleet of each package over the tiny f32 model (carried across with
  ``models/convert.py``): the same landing per replica, the same
  fleet-wide prefix hits (fanout - 1 under ``pressure``), the same tokens.

Engines and fleets that rank by load run on a frozen clock where the two
packages are compared: the load score reads TTFT/TPOT p99s, so wall time
would steer routing.  Tolerance: none — orders, counts and tokens are
compared exactly.
"""

import numpy as np
import pytest
import torch

import tpu_nexus.serving as jax_serving
import tpu_nexus.serving.router as jax_router
import tpu_nexus_torch.serving as port_serving
import tpu_nexus_torch.serving.router as port_router
from tpu_nexus_torch.core.telemetry import RecordingMetrics
from tpu_nexus_torch.serving import (
    CAUSE_REPLICA_LOST,
    AutoscaleConfig,
    QueueFull,
    RequestState,
    ServingEngine,
    ServingFleet,
)
from tpu_nexus_torch.serving.fleet import FleetError
from tpu_nexus_torch.serving.loadstats import (
    PRESSURE_DOWN,
    PRESSURE_HEALTHY,
    PRESSURE_PRESSURED,
    PRESSURE_SATURATED,
    PRESSURE_STATES,
    SloMonitor,
    SloTargets,
)
from tpu_nexus_torch.serving.router import (
    ELIGIBILITY_RANK,
    ROUTE_ELIGIBILITY,
    ROUTER_ROUND_ROBIN,
    SCALE_DECISIONS,
    load_score,
)
from tpu_nexus_torch.serving.scheduler import FifoScheduler, SchedulerConfig
from tpu_nexus_torch.serving.tracing import EV_ROUTER_RETRY
from test_torch_fleet import ALGO, FLEET_JS, NS, FleetFakeExecutor, _Fixture, _settle, fake_engine, pod_name, serving_jobset
from test_torch_llama import carried, tiny_configs

torch.set_num_threads(1)


def bounded_engine(slots=1, queue=3, params="v0", pkg=port_serving, clock=None):
    """Fake engine with a BOUNDED queue so per-replica sheds are cheap to
    stage (capacity before any tick = ``queue`` requests)."""
    kwargs = {} if clock is None else {"clock": clock}
    return pkg.ServingEngine(
        FleetFakeExecutor(num_slots=slots, params=params),
        scheduler=pkg.FifoScheduler(pkg.SchedulerConfig(max_queue=queue)),
        **kwargs,
    )


class FakePagedExecutor(FleetFakeExecutor):
    """Paged twin of :class:`FleetFakeExecutor`: exposing ``page_size`` /
    ``num_blocks`` flips the engine into block-granular admission, so the
    REAL ``PagedCacheManager`` + ``PrefixIndex`` run under the router's
    affinity probes with no device in sight."""

    def __init__(self, num_slots=2, max_len=64, page_size=4, num_blocks=64, params="v0"):
        super().__init__(num_slots=num_slots, max_len=max_len, params=params)
        self.page_size = page_size
        self.num_blocks = num_blocks

    def begin(self, slot, prompt, table_row=None, tail_start=0, copies=None):
        return (int(prompt[-1]) + 1) % 1000

    def step(self, tokens, cursors, tables=None):
        return np.asarray(tokens) + 1


def paged_engine(queue=0, slots=2, params="v0", pkg=port_serving, clock=None):
    kwargs = {} if clock is None else {"clock": clock}
    return pkg.ServingEngine(
        FakePagedExecutor(num_slots=slots, params=params),
        scheduler=pkg.FifoScheduler(pkg.SchedulerConfig(max_queue=queue)),
        **kwargs,
    )


def _fleet(n=3, engine=fake_engine, metrics=None, policy=None, **kw):
    kwargs = {"metrics": metrics}
    if policy is not None:
        kwargs["policy"] = policy
    fleet = ServingFleet(**kwargs)
    for i in range(n):
        fleet.add_replica(f"rep-{i}", engine(**kw), step=1)
    return fleet


class _Grades:
    """SLO-monitor stand-in: the router only reads ``.grades``."""

    def __init__(self, grades):
        self.grades = grades


def _landed_on(fleet, req):
    for name, rep in fleet.replicas.items():
        if req.request_id in rep.engine.requests:
            return name
    raise AssertionError(f"{req.request_id} landed nowhere")


def _retry_events(req):
    return [e for e in req.trace.events if e[1] == EV_ROUTER_RETRY]


def _lru_clocks(index):
    """(node identity -> last_used) over the whole prefix trie."""
    out = {}
    stack = [index._root]
    while stack:
        node = stack.pop()
        out[id(node)] = node.last_used
        stack.extend(node.children.values())
    return out


# -- tables ---------------------------------------------------------------------


class TestDecisionTables:
    def test_tables_total_over_pressure_states(self):
        assert set(ROUTE_ELIGIBILITY) == set(PRESSURE_STATES)
        assert set(SCALE_DECISIONS) == set(PRESSURE_STATES)
        # every eligibility except "never" has a tier; "never" must NOT
        assert set(ELIGIBILITY_RANK) == set(ROUTE_ELIGIBILITY.values()) - {"never"}

    @pytest.mark.parametrize("table", ["ROUTER_POLICIES", "ROUTE_ELIGIBILITY", "ELIGIBILITY_RANK", "SCALE_DECISIONS"])
    def test_tables_equal_the_jax_package_and_total(self, table):
        """The runtime stand-in for nxlint NX021 on the port: each table
        equals the reference's, and the two keyed by grade are total over
        the port's PRESSURE_STATES (which equal the reference's)."""
        from tpu_nexus.serving.loadstats import PRESSURE_STATES as JAX_STATES

        assert getattr(port_router, table) == getattr(jax_router, table)
        assert PRESSURE_STATES == JAX_STATES
        if table in ("ROUTE_ELIGIBILITY", "SCALE_DECISIONS"):
            assert tuple(getattr(port_router, table)) == tuple(PRESSURE_STATES)

    def test_autoscale_config_validates(self):
        with pytest.raises(ValueError, match="min_replicas"):
            AutoscaleConfig(min_replicas=0, max_replicas=2)
        with pytest.raises(ValueError, match="max_replicas"):
            AutoscaleConfig(min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError, match="streak"):
            AutoscaleConfig(min_replicas=1, max_replicas=2, scale_up_after=0)
        with pytest.raises(ValueError, match="cooldown"):
            AutoscaleConfig(min_replicas=1, max_replicas=2, cooldown_s=-1.0)


# -- ranking --------------------------------------------------------------------


class TestPlanning:
    def test_least_loaded_routes_first(self):
        fleet = _fleet(3)
        for _ in range(3):
            fleet.replicas["rep-0"].engine.submit(np.array([1, 2, 3]), 4)
        plan = fleet.router.plan(np.array([5, 6, 7]))
        assert plan[0] != "rep-0" and plan[-1] == "rep-0"
        req = fleet.submit(np.array([5, 6, 7]), 2)
        assert _landed_on(fleet, req) != "rep-0"

    def test_load_score_orders_backlog_and_latency(self):
        fleet = _fleet(2)
        fleet.replicas["rep-0"].engine.submit(np.array([1, 2, 3]), 4)
        snaps = fleet.snapshot().replicas
        assert load_score(snaps["rep-0"]) > load_score(snaps["rep-1"])

    def test_down_replica_never_planned(self):
        fleet = _fleet(3)
        fleet.kill_replica("rep-1", f"{CAUSE_REPLICA_LOST}:test")
        for tail in range(5):
            assert "rep-1" not in fleet.router.plan(np.array([1, 2, tail]))

    def test_down_grade_excluded_even_while_state_serving(self):
        fleet = _fleet(3)
        fleet.router.slo = _Grades({"rep-2": PRESSURE_DOWN})
        assert "rep-2" not in fleet.router.plan(np.array([1, 2, 3]))

    def test_round_robin_policy_rotates_evenly(self):
        fleet = _fleet(3, policy=ROUTER_ROUND_ROBIN)
        for i in range(6):
            fleet.submit(np.array([1, 2, i + 1]), 2)
        counts = sorted(len(rep.engine.requests) for rep in fleet.replicas.values())
        assert counts == [2, 2, 2]


# -- shed-and-retry-elsewhere ---------------------------------------------------


class TestRetryAndShed:
    def test_refusal_retries_next_best_with_metrics_and_trace(self):
        rec = RecordingMetrics()
        fleet = _fleet(2, metrics=rec)
        fleet.replicas["rep-0"].engine.pause_admission()
        req = fleet.submit(np.array([1, 2, 3]), 2)
        assert _landed_on(fleet, req) == "rep-1"
        assert fleet.router.retries == 1
        assert fleet.router.last_refusals == [("rep-0", "reloading")]
        key = ("serving.router_retry", ("cause:reloading", "replica:rep-0"))
        assert rec.tagged_counts[key] == 1
        (event,) = _retry_events(req)
        assert event[2] == {"tried": ["rep-0:reloading"], "landed": "rep-1"}
        fleet.run_until_drained()
        assert req.state == RequestState.FINISHED

    def test_fleet_wide_exhaustion_sheds_with_causes(self):
        rec = RecordingMetrics()
        fleet = _fleet(2, engine=bounded_engine, metrics=rec, queue=1)
        fleet.submit(np.array([1, 2, 3]), 2)
        fleet.submit(np.array([1, 2, 4]), 2)
        with pytest.raises(QueueFull, match="no serving replica") as exc:
            fleet.submit(np.array([1, 2, 5]), 2)
        msg = str(exc.value)
        assert "tried" in msg
        assert "rep-0 (queue-full)" in msg and "rep-1 (queue-full)" in msg
        assert fleet.router.fleet_sheds == 1
        assert rec.counters["serving.fleet_shed"] == 1
        assert "serving.router_retry" not in rec.counters

    def test_draining_replica_refusal_carries_cause(self):
        fleet = _fleet(2)
        fleet.replicas["rep-0"].engine.drain(0.0)
        req = fleet.submit(np.array([1, 2, 3]), 2)
        assert _landed_on(fleet, req) == "rep-1"
        assert fleet.router.last_refusals == [("rep-0", "draining")]

    def test_saturated_avoided_then_last_resort_then_shed(self):
        mon = SloMonitor(
            SloTargets(shed_rate=0.05, short_window=1, long_window=2, pressured_burn=1.0, saturated_burn=1.0)
        )
        fleet = _fleet(3, engine=bounded_engine, queue=3)
        fleet.router.slo = mon
        rep0 = fleet.replicas["rep-0"].engine
        for i in range(3):
            rep0.submit(np.array([1, 2, i + 1]), 2)
        mon.observe(fleet.snapshot())
        for obs in range(2):
            with pytest.raises(QueueFull):
                rep0.submit(np.array([9, 9, obs + 1]), 2)
            mon.observe(fleet.snapshot())
        assert mon.grades["rep-0"] == PRESSURE_SATURATED
        fleet.run_until_drained()
        for i in range(6):
            req = fleet.submit(np.array([4, 5, i + 1]), 2)
            assert _landed_on(fleet, req) != "rep-0"
        assert rep0.scheduler.pending == 0
        req = fleet.submit(np.array([6, 7, 8]), 2)
        assert _landed_on(fleet, req) == "rep-0"
        assert {name for name, _ in fleet.router.last_refusals} == {"rep-1", "rep-2"}
        for i in range(2):
            fleet.submit(np.array([6, 7, 10 + i]), 2)
        with pytest.raises(QueueFull, match="no serving replica"):
            fleet.submit(np.array([6, 7, 20]), 2)


# -- the snapshot-to-submit race ------------------------------------------------


class TestSnapshotSubmitRace:
    def test_kill_replica_racing_submit_is_retried(self):
        fleet = _fleet(2)
        rep0 = fleet.replicas["rep-0"]

        def dying_submit(*args, **kwargs):
            fleet.kill_replica("rep-0", f"{CAUSE_REPLICA_LOST}:race")
            raise FleetError("rep-0 vanished mid-submit")

        rep0.engine.submit = dying_submit
        req = fleet.submit(np.array([1, 2, 3]), 2)
        assert _landed_on(fleet, req) == "rep-1"
        assert rep0.state == "down"
        (refusal,) = fleet.router.last_refusals
        assert refusal[0] == "rep-0"
        assert refusal[1].startswith("replica-error:")
        (event,) = _retry_events(req)
        assert event[2]["landed"] == "rep-1"
        fleet.run_until_drained()
        assert req.state == RequestState.FINISHED

    def test_stale_snapshot_down_state_rechecked(self):
        fleet = _fleet(2)
        stale = fleet.snapshot()
        fleet.kill_replica("rep-0", f"{CAUSE_REPLICA_LOST}:stale")
        fleet.snapshot = lambda: stale
        req = fleet.submit(np.array([1, 2, 3]), 2)
        assert _landed_on(fleet, req) == "rep-1"
        assert ("rep-0", "state:down") in fleet.router.last_refusals

    def test_stale_snapshot_removed_replica_rechecked(self):
        fleet = _fleet(2)
        stale = fleet.snapshot()
        fleet.remove_replica("rep-0")
        fleet.snapshot = lambda: stale
        req = fleet.submit(np.array([1, 2, 3]), 2)
        assert _landed_on(fleet, req) == "rep-1"
        assert ("rep-0", "replica-gone") in fleet.router.last_refusals


# -- mid-burst kill -------------------------------------------------------------


class TestMidBurstKill:
    def test_zero_silent_drops_with_causes(self):
        fleet = _fleet(3, slots=2)
        reqs = [fleet.submit(np.array([1, 2, i + 1]), 4) for i in range(12)]
        fleet.tick()
        victim = fleet.replicas["rep-1"]
        assert len(victim.engine.requests) > 0
        cause = f"{CAUSE_REPLICA_LOST}:chaos-kill"
        fleet.kill_replica("rep-1", cause)
        assert not victim.engine.requests
        reqs += [fleet.submit(np.array([3, 4, i + 1]), 4) for i in range(6)]
        assert not victim.engine.requests
        fleet.run_until_drained()
        assert all(r.is_terminal() for r in reqs)
        casualties = [r for r in reqs if r.state != RequestState.FINISHED]
        assert casualties and all(r.cause == cause for r in casualties)
        assert len([r for r in reqs if r.state == RequestState.FINISHED]) == len(reqs) - len(casualties)


# -- prefix affinity ------------------------------------------------------------


class TestPrefixAffinity:
    PREFIX = np.arange(1, 17)  # 4 full blocks at page_size=4

    def _fanout(self, i):
        return np.concatenate([self.PREFIX, [100 + i, 200 + i]])

    def test_fanout_follows_registered_prefix(self):
        fleet = _fleet(2, engine=paged_engine)
        seed = fleet.submit(self._fanout(0), 3)
        home = _landed_on(fleet, seed)
        fleet.run_until_drained()
        other = ({"rep-0", "rep-1"} - {home}).pop()
        assert fleet.replicas[home].engine.prefix_shared_len(self._fanout(1)) > 0
        assert fleet.replicas[other].engine.prefix_shared_len(self._fanout(1)) == 0
        for i in range(1, 5):
            req = fleet.submit(self._fanout(i), 3)
            assert _landed_on(fleet, req) == home
        fleet.run_until_drained()

    def test_affinity_probe_never_touches_lru(self):
        fleet = _fleet(2, engine=paged_engine)
        seed = fleet.submit(self._fanout(0), 3)
        home = fleet.replicas[_landed_on(fleet, seed)].engine
        fleet.run_until_drained()
        clocks_before = _lru_clocks(home.paged.index)
        for i in range(1, 4):
            fleet.router.plan(self._fanout(i))
        assert _lru_clocks(home.paged.index) == clocks_before

    def test_sticky_map_covers_preregistration_window(self):
        fleet = _fleet(2, engine=paged_engine)
        first = fleet.submit(self._fanout(0), 3)
        home = _landed_on(fleet, first)
        for i in range(1, 4):
            req = fleet.submit(self._fanout(i), 3)
            assert _landed_on(fleet, req) == home
        fleet.run_until_drained()

    def test_affinity_never_beats_full_pool(self):
        fleet = _fleet(2, engine=paged_engine, queue=1)
        seed = fleet.submit(self._fanout(0), 3)
        home = _landed_on(fleet, seed)
        other = ({"rep-0", "rep-1"} - {home}).pop()
        fleet.run_until_drained()
        fleet.replicas[home].engine.submit(self._fanout(50), 3)
        req = fleet.submit(self._fanout(1), 3)
        assert _landed_on(fleet, req) == other
        assert (home, "queue-full") in fleet.router.last_refusals
        with pytest.raises(QueueFull, match="no serving replica"):
            fleet.submit(self._fanout(2), 3)

    def test_affinity_token_identical_to_round_robin(self):
        prompts = [self._fanout(i) for i in range(6)] + [np.arange(5, 12) * 3 for _ in range(2)]
        outs = {}
        for policy in (None, ROUTER_ROUND_ROBIN):
            fleet = _fleet(2, engine=paged_engine, policy=policy)
            reqs = [fleet.submit(p, 4) for p in prompts]
            fleet.run_until_drained()
            assert all(r.state == RequestState.FINISHED for r in reqs)
            outs[policy] = [list(r.output_tokens) for r in reqs]
        assert outs[None] == outs[ROUTER_ROUND_ROBIN]


# -- supervisor autoscaling -----------------------------------------------------


async def autoscale_fixture(cooldown_s=0.0):
    from datetime import timedelta

    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.k8s.fake import FakeKubeClient
    from tpu_nexus_torch.serving import FleetSupervisor

    client = FakeKubeClient(jobset_controller=True, emit_pod_events=True)
    client.inject("ADDED", "JobSet", serving_jobset())
    store = InMemoryCheckpointStore()
    fleet = ServingFleet()
    made = []

    def factory(name, step, kv_blocks):
        made.append((name, step, kv_blocks))
        return fake_engine(params=f"params@{step}")

    sup = FleetSupervisor(
        client, store, NS, fleet, FLEET_JS, ALGO, factory,
        grace_s=30.0, kv_blocks=64, resync_period=timedelta(0),
        slo=SloMonitor(SloTargets(shed_rate=0.05, short_window=1, long_window=2,
                                  pressured_burn=1.0, saturated_burn=1.0)),
        autoscale=AutoscaleConfig(min_replicas=3, max_replicas=4, scale_up_after=1, scale_down_after=2,
                                  cooldown_s=cooldown_s),
    )
    ctx = LifecycleContext()
    sup._factory.start(ctx)
    assert await sup._factory.wait_for_cache_sync(timeout=10.0)
    await sup.adopt_pods(step=1)
    return _Fixture(client, store, fleet, sup, ctx, made)


class TestAutoscale:
    async def test_up_then_down_converges_with_all_requests_terminal(self):
        fx = await autoscale_fixture()
        try:
            sup, fleet = fx.sup, fx.fleet
            reqs = [fleet.submit(np.array([1, 2, i + 1]), 3) for i in range(3)]
            await sup.reconcile(now=1.0)  # obs 1: seeds baselines
            assert sup.scaled_up == 0
            # a refusing replica shedding once per observation window —
            # direct submits, so the burn is independent of routing order
            overloaded = fleet.replicas[pod_name(0)].engine
            overloaded.pause_admission()
            with pytest.raises(QueueFull):
                overloaded.submit(np.array([9, 9, 1]), 2)
            await sup.reconcile(now=2.0)  # obs 2: burning -> PRESSURED, hold
            assert sup.slo.grades[pod_name(0)] == PRESSURE_PRESSURED
            assert sup.scaled_up == 0
            with pytest.raises(QueueFull):
                overloaded.submit(np.array([9, 9, 2]), 2)
            await sup.reconcile(now=3.0)  # obs 3: SATURATED -> scale up
            assert sup.slo.grades[SloMonitor.FLEET] == PRESSURE_SATURATED
            assert sup.scaled_up == 1 and len(fleet.replicas) == 4
            new = f"{FLEET_JS}-scale-1"
            assert new in fleet.replicas
            assert fleet.replicas[new].state == "serving"
            assert fx.made[-1][0] == new
            pod = fx.client._objects["Pod"][(NS, new)]
            assert pod["metadata"]["uid"].startswith("fleet-scale-")
            row = fx.ledger()
            assert "fleet autoscale: scale-up" in row.algorithm_failure_cause
            assert new in row.algorithm_failure_details
            # traffic drains: every request terminal, zero drops
            overloaded.resume_admission()
            fleet.run_until_drained()
            assert all(r.state == RequestState.FINISHED for r in reqs)
            # sustained healthy idleness: two reconciles -> scale down once
            await sup.reconcile(now=4.0)
            assert sup.scaled_down == 0
            await sup.reconcile(now=5.0)
            assert sup.slo.grades[SloMonitor.FLEET] == PRESSURE_HEALTHY
            assert sup.scaled_down == 1 and len(fleet.replicas) == 3
            down = sup.scale_events[-1]
            assert down["decision"] == "scale-down"
            assert down["drain"]["drain_evicted"] == 0  # zero-drop by idle
            assert down["pod"] in fx.client.deleted("Pod")
            assert "fleet autoscale: scale-down" in fx.ledger().algorithm_failure_cause
            # at min_replicas the fleet holds, and our own deletion never
            # echoes back as an incident/recreate
            await _settle()
            await sup.reconcile(now=6.0)
            await sup.reconcile(now=7.0)
            assert len(fleet.replicas) == 3
            assert sup.scaled_down == 1 and sup.recreated == 0
        finally:
            await fx.close()

    async def test_cooldown_and_max_replicas_gate_scale_up(self):
        fx = await autoscale_fixture(cooldown_s=100.0)
        try:
            sup, fleet = fx.sup, fx.fleet
            for rep in fleet.replicas.values():
                rep.engine.pause_admission()
            await sup.reconcile(now=1.0)  # seeds
            for tick in range(2):
                # every replica refuses -> a fleet-wide shed, one burn
                # sample on each replica per observation
                with pytest.raises(QueueFull, match="no serving replica"):
                    fleet.submit(np.array([1, 2, tick + 1]), 2)
                await sup.reconcile(now=2.0 + tick)
            assert sup.scaled_up == 1  # saturated -> one scale-up
            # still saturated, but the cooldown holds the next action
            fleet.replicas[f"{FLEET_JS}-scale-1"].engine.pause_admission()
            with pytest.raises(QueueFull):
                fleet.submit(np.array([1, 2, 9]), 2)
            await sup.reconcile(now=5.0)
            assert sup.scaled_up == 1
            # past the cooldown the fleet is at max_replicas: still capped
            with pytest.raises(QueueFull):
                fleet.submit(np.array([1, 2, 11]), 2)
            await sup.reconcile(now=200.0)
            assert sup.scaled_up == 1 and len(fleet.replicas) == 4
        finally:
            await fx.close()


#: the fleet knobs as a deployment sets them: round-robin routing, a shed
#: target graded over windows of 1 and 3 reconciles, autoscaling in [3, 4]
FLEET_ENV = {
    "NEXUS_ROUTER_POLICY": "round-robin", "NEXUS_SLO_SHED_RATE": "0.05", "NEXUS_SLO_SHORT_N": "1",
    "NEXUS_SLO_LONG_N": "3", "NEXUS_AUTOSCALE_MIN": "3", "NEXUS_AUTOSCALE_MAX": "4", "NEXUS_SCALE_UP_N": "1",
    "NEXUS_SCALE_DOWN_N": "2", "NEXUS_SCALE_COOLDOWN_S": "0", "NEXUS_PAGE_SIZE": "4", "NEXUS_KV_BLOCKS": "64",
}


async def test_fleet_knobs_from_env_route_and_scale_the_fleet():
    """``build_fleet_supervisor`` reads every fleet knob of ``ServeConfig``:
    the router rotates (``NEXUS_ROUTER_POLICY``), the supervisor grades with
    the ``NEXUS_SLO_*`` targets the router shares, scales in the
    ``NEXUS_AUTOSCALE_*``/``NEXUS_SCALE_*`` bounds, and recreates from the
    ``NEXUS_KV_BLOCKS`` budget."""
    from datetime import timedelta

    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.k8s.fake import FakeKubeClient
    from tpu_nexus_torch.workload.serve import ServeConfig, build_fleet_supervisor

    cfg = ServeConfig.from_env(FLEET_ENV)
    client = FakeKubeClient(jobset_controller=True, emit_pod_events=True)
    client.inject("ADDED", "JobSet", serving_jobset(kv=64))
    made = []

    def factory(name, step, kv_blocks):
        made.append((name, step, kv_blocks))
        return fake_engine(params=f"params@{step}")

    sup = build_fleet_supervisor(cfg, client, InMemoryCheckpointStore(), NS, FLEET_JS, ALGO, factory, grace_s=30.0,
                                 resync_period=timedelta(0))
    fleet = sup.fleet
    assert fleet.router.policy == ROUTER_ROUND_ROBIN and fleet.router.slo is sup.slo
    assert sup.slo.targets == cfg.slo_targets() and sup.autoscale == cfg.autoscale_config()
    ctx = LifecycleContext()
    sup._factory.start(ctx)
    fx = _Fixture(client, sup._store, fleet, sup, ctx, made)
    try:
        assert await sup._factory.wait_for_cache_sync(timeout=10.0)
        await sup.adopt_pods(step=1)
        reqs = [fleet.submit(np.array([1, 2, i + 1]), 3) for i in range(3)]
        assert sorted(len(rep.engine.requests) for rep in fleet.replicas.values()) == [1, 1, 1]
        await sup.reconcile(now=1.0)  # seeds the shed baselines
        overloaded = fleet.replicas[pod_name(0)].engine
        overloaded.pause_admission()
        grades = []
        for t in (2.0, 3.0):
            with pytest.raises(QueueFull):
                overloaded.submit(np.array([9, 9, int(t)]), 2)
            await sup.reconcile(now=t)
            grades.append((sup.slo.grades[pod_name(0)], sup.slo.grades[SloMonitor.FLEET]))
        # the long window of 3 fills on the second shed: PRESSURED, then
        # SATURATED and one scale-up (NEXUS_SCALE_UP_N=1) to the max of 4
        assert grades == [(PRESSURE_PRESSURED, PRESSURE_PRESSURED), (PRESSURE_SATURATED, PRESSURE_SATURATED)]
        assert sup.scaled_up == 1 and len(fleet.replicas) == 4
        overloaded.resume_admission()
        fleet.run_until_drained()
        assert all(r.state == RequestState.FINISHED for r in reqs)
        for t in (4.0, 5.0):  # two healthy idle reconciles (NEXUS_SCALE_DOWN_N=2)
            await sup.reconcile(now=t)
        assert sup.scaled_down == 1 and len(fleet.replicas) == 3
        # a lost pod comes back with the NEXUS_KV_BLOCKS budget
        victim = sorted(fleet.replicas)[0]
        await client.delete_object("Pod", NS, victim)
        await _settle()
        await sup.reconcile(now=6.0)
        assert sup.recreated == 1 and made[-1] == (victim, 1, 64)
    finally:
        await fx.close()


# -- multi-seed fuzz ------------------------------------------------------------


class TestRouterFuzz:
    @pytest.mark.parametrize("seed", range(8))
    def test_invariants_under_kills_and_bursts(self, seed):
        rng = np.random.default_rng(seed)
        fleet = _fleet(4, engine=bounded_engine, queue=2)
        dead = set()
        accepted = []
        for _round in range(20):
            op = rng.integers(0, 10)
            names = list(fleet.replicas)
            if op == 0 and len(dead) < 3:
                victim = names[rng.integers(0, len(names))]
                if victim not in dead:
                    fleet.kill_replica(victim, f"{CAUSE_REPLICA_LOST}:fuzz")
                    dead.add(victim)
            elif op <= 2:
                for _ in range(int(rng.integers(1, 4))):
                    fleet.tick()
            prompt = rng.integers(1, 900, size=int(rng.integers(2, 6)))
            plan = fleet.router.plan(prompt)
            assert all(fleet.replicas[n].state == "serving" for n in plan)
            assert not (set(plan) & dead)
            try:
                accepted.append(fleet.submit(prompt, int(rng.integers(1, 4))))
            except QueueFull:
                serving = [rep for name, rep in fleet.replicas.items() if name not in dead]
                assert all(rep.engine.scheduler.full for rep in serving)
        for name in dead:
            assert not fleet.replicas[name].engine.has_work
        fleet.run_until_drained()
        assert all(r.is_terminal() for r in accepted)
        for req in accepted:
            assert req.state == RequestState.FINISHED or req.cause


# -- the two packages side by side ----------------------------------------------


def _recorded_trace(pkg, seed):
    """A recorded request trace through ``pkg``'s router: paged and bounded
    fake replicas, shared-prefix and random prompts, ticks, a paused
    replica, a kill and SLO grades.  Returns every plan and landing."""
    frozen = lambda: 0.0  # noqa: E731 - the frozen clock both packages share
    rng = np.random.default_rng(seed)
    fleet = pkg.ServingFleet(clock=frozen)
    for i in range(2):
        fleet.add_replica(f"pg-{i}", paged_engine(slots=2, queue=4, pkg=pkg, clock=frozen), step=1)
    fleet.add_replica("bd-0", bounded_engine(slots=1, queue=3, pkg=pkg, clock=frozen), step=1)
    fleet.add_replica("bd-1", bounded_engine(slots=2, queue=2, pkg=pkg, clock=frozen), step=1)
    prefix = rng.integers(1, 500, size=12)
    log = []
    for i in range(60):
        if i == 20:
            fleet.replicas["pg-1"].engine.pause_admission()
        if i == 30:
            fleet.replicas["pg-1"].engine.resume_admission()
            fleet.router.slo = _Grades({"bd-0": "saturated", "pg-0": "pressured"})
        if i == 45:
            fleet.kill_replica("bd-1", f"{CAUSE_REPLICA_LOST}:trace")
        if rng.integers(0, 2):
            prompt = np.concatenate([prefix, rng.integers(500, 900, size=int(rng.integers(1, 4)))])
        else:
            prompt = rng.integers(1, 900, size=int(rng.integers(2, 9)))
        log.append(("plan", i, fleet.router.plan(prompt)))
        try:
            req = fleet.submit(prompt, int(rng.integers(1, 5)), request_id=f"t{i}")
            log.append(("landed", i, _landed_on(fleet, req), list(fleet.router.last_refusals)))
        except QueueFull as exc:
            log.append(("shed", i, str(exc)))
        for _ in range(int(rng.integers(0, 3))):
            fleet.tick()
    fleet.run_until_drained()
    return log, [(r.request_id, r.state, r.cause) for r in fleet.all_retired()]


@pytest.mark.parametrize("seed", [0, 1])
def test_recorded_trace_plans_as_the_jax_router(seed):
    ours = _recorded_trace(port_serving, seed)
    assert ours == _recorded_trace(jax_serving, seed)
    assert any(entry[0] == "landed" and entry[3] for entry in ours[0])  # a retry was exercised


JCFG, PCFG = tiny_configs()
FANOUT, SHARED, TAIL, GEN = 12, 16, 3, 3


def _fanout_run(pkg, params, cfg, policy):
    """The fan-out workload (``bench_serving.py::make_prefix_requests``'s
    shape at tiny size) through a 3-replica paged fleet of ``pkg``."""
    rng = np.random.default_rng(11)
    shared = rng.integers(1, cfg.vocab_size, size=SHARED).astype(np.int32)
    prompts = [
        np.concatenate([shared, rng.integers(1, cfg.vocab_size, size=TAIL).astype(np.int32)])
        for _ in range(FANOUT)
    ]
    frozen = lambda: 0.0  # noqa: E731 - see the module doc
    fleet = pkg.ServingFleet(policy=policy, clock=frozen)
    for i in range(3):
        ex = pkg.PagedModelExecutor(params, cfg, num_slots=4, max_len=SHARED + TAIL + GEN, page_size=4)
        fleet.add_replica(f"page-{i}", pkg.ServingEngine(ex, clock=frozen), step=1)
    reqs = [fleet.submit(p, GEN, request_id=f"fan-{i}") for i, p in enumerate(prompts)]
    fleet.run_until_drained()
    landed = {
        name: sum(1 for r in rep.engine.retired if r.request_id.startswith("fan-"))
        for name, rep in fleet.replicas.items()
    }
    hits = sum(rep.engine.metrics.summary()["prefix_hits"] for rep in fleet.replicas.values())
    assert all(r.state == RequestState.FINISHED for r in reqs)
    return landed, hits, [[int(t) for t in r.output_tokens] for r in reqs]


@pytest.mark.parametrize("policy", ["pressure", ROUTER_ROUND_ROBIN])
def test_fanout_lands_and_hits_as_the_jax_fleet(policy):
    jparams, pparams = carried(JCFG, PCFG)
    ours = _fanout_run(port_serving, pparams, PCFG, policy)
    assert ours == _fanout_run(jax_serving, jparams, JCFG, policy)
    landed, hits, _ = ours
    if policy == "pressure":
        assert sorted(landed.values()) == [0, 0, FANOUT] and hits == FANOUT - 1
    else:
        assert sorted(landed.values()) == [FANOUT // 3] * 3 and hits == FANOUT - 3
