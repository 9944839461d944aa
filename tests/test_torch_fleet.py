"""The port's serving fleet (``tpu_nexus_torch/serving/fleet.py``) on the CPU.

* ``TestServingFleet`` — the cases of ``tests/test_rollout_chaos.py::
  TestServingFleet`` against the port's fleet, over a fake executor
  (first token = last prompt token + 1, decode increments): rotation past
  down and reloading replicas, fleet-wide shedding, the rolling-update
  state machine (zero drop, rotten candidate, transform and swap
  failures, a down replica skipped, grace exhaustion), bounded history
  and idempotent kills.
* The same fake traffic and rollout through both packages' fleets gives
  the same landing, retirements and summary.
* ``TestRollingUpdate`` — rolling updates driven by ``start_rollout`` +
  ``tick`` over the port's ``TensorCheckpointer`` and
  ``CheckpointWatcher``, three paged replicas of the tiny f32 model
  (carried across with ``models/convert.py``): the update reaches every
  replica with zero requests dropped and post-swap tokens equal the new
  step's own; a candidate corrupted between poll and load aborts with
  ``rollout_error`` and the fleet keeps its step; a replica killed
  mid-rollout is skipped and the rollout converges.

* ``TestFleetSupervisor`` and ``TestRolloutDrills`` — the cases of
  ``tests/test_rollout_chaos.py`` against the port's ``FleetSupervisor``
  over the port's ``FakeKubeClient``: pod deletion, HBM OOM (halved KV
  budget), crash loop, the dead-pod remap, a JobSet-level escalation, the
  ledger heartbeat and the missing-pod sweep; rollouts driven by
  ``reconcile`` over real verified checkpoints (zero drop, a pod killed
  mid-rollout, a quarantined and a post-poll corrupt candidate, a replica
  SIGTERM'd mid-drain).
* ``TestSaturationDrill`` — ``tests/test_loadstats.py``'s cases: a slow
  step grades one replica HEALTHY -> PRESSURED -> SATURATED with the
  ledger write and the flight-recorder dump; a down replica grades DOWN;
  the transition log stays bounded.
* One incident script (pod deletion, BackOff, HBM OOM, preemption, an
  event for a pod the cluster does not hold) through both packages'
  supervisors, each over its own fake cluster, fake engines on a frozen
  clock: equal incidents, ledger rows (but ``last_modified``, wall time),
  counters, KV budgets, pod manifests and retirements.  Two more scripts
  the same way: autoscaling (a paused replica's sheds, scale-up to the
  max, drain, scale-down once idle) then a pod gone with no event (the
  sweep), and a role-typed JobSet (a crash-looping prefill pod and a
  silently missing decode pod recreated in their roles, scale-downs that
  stop at each role's floor): equal scale events, pressure events, SLO
  transitions, rows, counters, roles, manifests and deletions.

Tolerance: none — tokens, states and causes are compared exactly.
"""

import asyncio
import json
import os
from datetime import timedelta

import numpy as np
import pytest
import torch

import tpu_nexus.serving as jax_serving
import tpu_nexus_torch.serving as port_serving
from tpu_nexus_torch.checkpoint.models import (
    JOB_LABEL_SERVING_FLEET,
    JOB_TEMPLATE_NAME_KEY,
    NEXUS_COMPONENT_LABEL,
    LifecycleStage,
)
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.models.generate import generate
from tpu_nexus_torch.models.llama import llama_init
from tpu_nexus_torch.serving import (
    CAUSE_REPLICA_LOST,
    PRESSURE_DOWN,
    PRESSURE_HEALTHY,
    PRESSURE_PRESSURED,
    PRESSURE_SATURATED,
    ROLE_DECODE,
    ROLE_PREFILL,
    CheckpointWatcher,
    FleetSupervisor,
    PagedModelExecutor,
    QueueFull,
    RequestState,
    ServingEngine,
    ServingFleet,
    SloMonitor,
    SloTargets,
)
from tpu_nexus_torch.serving.engine import CAUSE_RELOAD_GRACE
from tpu_nexus_torch.serving.fleet import MSG_POD_MISSING, REPLICA_DOWN
from tpu_nexus_torch.serving.tracing import EngineTracer, FlightRecorder
from tpu_nexus_torch.supervisor.taxonomy import (
    MSG_HBM_OOM,
    MSG_PREEMPTED,
    MSG_STUCK_IN_PENDING,
    DecisionAction,
    FleetRecovery,
)
from tpu_nexus_torch.workload import durability
from tpu_nexus_torch.workload.faults import MSG_HBM_OOM as FAULT_HBM_OOM_TEXT
from tpu_nexus_torch.workload.faults import FaultyExecutor, flip_committed_leaf
from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer
from test_torch_llama import tiny_configs
from test_torch_supervisor import event_obj

torch.set_num_threads(1)


# -- shared fakes ---------------------------------------------------------------


class FleetFakeExecutor:
    """Deterministic device stand-in with a swappable ``params`` handle:
    first token = last prompt token + 1, decode increments.  Plain Python
    and numpy, so either package's engine can drive it."""

    def __init__(self, num_slots=2, max_len=64, params="v0"):
        self.num_slots = num_slots
        self.max_len = max_len
        self.params = params
        self.swaps = 0

    def begin(self, slot, prompt):
        return (int(prompt[-1]) + 1) % 1000

    def step(self, tokens, cursors):
        return np.asarray(tokens) + 1

    def swap_params(self, params):
        self.params = params
        self.swaps += 1


def fake_engine(params="v0", slots=2, pkg=port_serving, clock=None):
    kwargs = {} if clock is None else {"clock": clock}
    return pkg.ServingEngine(FleetFakeExecutor(num_slots=slots, params=params), **kwargs)


class FakeSource:
    """``restore_params``-shaped checkpoint source for host-only fleet
    tests; optionally fails like a rotten candidate."""

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def restore_params(self, step):
        self.calls.append(step)
        if self.fail:
            raise durability.CheckpointCorrupt(f"step {step}: injected rot")
        return f"params@{step}"


def _submit_all(fleet, n, prompt_tail=7, max_new=4):
    return [fleet.submit(np.array([1, 2, prompt_tail]), max_new) for _ in range(n)]


# -- host-side fleet + rollout state machine ------------------------------------


class TestServingFleet:
    def _fleet(self, n=3):
        fleet = ServingFleet()
        for i in range(n):
            fleet.add_replica(f"rep-{i}", fake_engine(params="v1"), step=1)
        return fleet

    def test_round_robin_skips_down_and_reloading(self):
        fleet = self._fleet(3)
        fleet.kill_replica("rep-0", "replica-lost:test")
        fleet.replicas["rep-1"].state = "reloading"
        reqs = _submit_all(fleet, 4)
        fleet.run_until_drained()
        assert all(r.state == RequestState.FINISHED for r in reqs)
        assert len(fleet.replicas["rep-2"].engine.retired) == 4

    def test_all_unavailable_sheds(self):
        fleet = self._fleet(2)
        fleet.kill_replica("rep-0", "x")
        fleet.kill_replica("rep-1", "y")
        with pytest.raises(QueueFull, match="no serving replica"):
            fleet.submit(np.array([1]), 1)

    def test_rolling_update_zero_drop(self):
        fleet = self._fleet(3)
        src = FakeSource()
        reqs = []
        assert fleet.start_rollout(src, 2, grace_s=30.0)
        assert not fleet.start_rollout(src, 3, grace_s=30.0)  # one at a time
        for _ in range(200):
            if len(reqs) < 24:
                reqs.append(fleet.submit(np.array([1, 2, 5]), 3))
            fleet.tick()
            if fleet.converged(2) and not fleet.has_work and len(reqs) >= 24:
                break
        fleet.run_until_drained()
        assert fleet.converged(2)
        assert fleet.rollouts_completed == 1
        assert src.calls == [2]  # one verified restore serves the whole fleet
        assert all(r.state == RequestState.FINISHED for r in reqs)
        assert all(rep.engine.executor.params == "params@2" for rep in fleet.replicas.values())
        assert fleet.summary()["retired_states"] == {RequestState.FINISHED: len(reqs)}

    def test_rollout_aborts_on_rotten_candidate_and_resumes_serving(self):
        fleet = self._fleet(2)
        fleet.start_rollout(FakeSource(fail=True), 2, grace_s=0.0)
        for _ in range(20):
            fleet.tick()
            if not fleet.rollout_active:
                break
        assert fleet.rollout_error is not None and "injected rot" in fleet.rollout_error[1]
        assert fleet.rollouts_completed == 0
        for rep in fleet.replicas.values():
            assert rep.state == "serving" and rep.deployed_step == 1
            assert rep.engine.executor.params == "v1"
        req = fleet.submit(np.array([1, 2, 3]), 2)
        fleet.run_until_drained()
        assert req.state == RequestState.FINISHED

    def test_rollout_spec_mismatch_in_transform_aborts_before_any_pause(self):
        fleet = self._fleet(2)

        def bad_transform(params):
            raise ValueError("missing quantization transform")

        fleet.start_rollout(FakeSource(), 2, grace_s=30.0, transform=bad_transform)
        fleet.tick()
        assert not fleet.rollout_active
        assert fleet.rollout_error[0] == 2
        assert "ValueError" in fleet.rollout_error[1]
        for rep in fleet.replicas.values():
            assert rep.state == "serving"
            assert not rep.engine.admission_paused
            assert rep.deployed_step == 1

    def test_rollout_swap_failure_resumes_replica(self):
        fleet = ServingFleet()

        class RefusingExecutor(FleetFakeExecutor):
            def swap_params(self, params):
                raise ValueError("params do not fit this engine")

        eng = ServingEngine(RefusingExecutor(num_slots=2))
        fleet.add_replica("rep-0", eng, 1)
        fleet.start_rollout(FakeSource(), 2, grace_s=0.0)
        for _ in range(5):
            fleet.tick()
            if not fleet.rollout_active:
                break
        assert not fleet.rollout_active
        assert fleet.rollout_error[0] == 2
        assert not eng.admission_paused
        assert fleet.replicas["rep-0"].state == "serving"
        req = fleet.submit(np.array([1, 2, 3]), 2)
        fleet.run_until_drained()
        assert req.state == RequestState.FINISHED

    def test_history_is_bounded_across_revives(self):
        fleet = self._fleet(1)
        rep = fleet.replicas["rep-0"]
        rep.history_limit = 5
        for _generation in range(4):
            for _ in range(3):
                fleet.submit(np.array([1, 2, 3]), 1)
            fleet.run_until_drained()
            fleet.kill_replica("rep-0", "replica-lost:test")
            fleet.revive_replica("rep-0", fake_engine(), 1)
        assert len(rep.history) <= 5

    def test_rollout_skips_down_replica_and_completes(self):
        fleet = self._fleet(3)
        fleet.start_rollout(FakeSource(), 2, grace_s=30.0)
        fleet.kill_replica("rep-1", "replica-lost:test")
        for _ in range(100):
            fleet.tick()
            if not fleet.rollout_active:
                break
        assert fleet.rollouts_completed == 1
        assert fleet.replicas["rep-0"].deployed_step == 2
        assert fleet.replicas["rep-2"].deployed_step == 2
        assert fleet.replicas["rep-1"].state == REPLICA_DOWN
        fleet.revive_replica("rep-1", fake_engine(params="params@2"), 2)
        assert fleet.converged(2)

    def test_rollout_grace_exhaustion_evicts_stragglers(self):
        fleet = self._fleet(1)
        req = fleet.submit(np.array([1, 2, 3]), 50)  # outlives a zero grace
        fleet.tick()
        fleet.start_rollout(FakeSource(), 2, grace_s=0.0)
        for _ in range(10):
            fleet.tick()
            if not fleet.rollout_active:
                break
        assert req.state == RequestState.EVICTED
        assert req.cause == CAUSE_RELOAD_GRACE
        assert fleet.converged(2)

    def test_kill_is_idempotent_and_history_survives_revive(self):
        fleet = self._fleet(1)
        req = fleet.submit(np.array([1, 2, 3]), 8)
        fleet.tick()
        assert fleet.kill_replica("rep-0", "replica-lost:test") == 1
        assert fleet.kill_replica("rep-0", "replica-lost:test") == 0
        fleet.revive_replica("rep-0", fake_engine(), 2)
        retired = fleet.all_retired()
        assert [r.request_id for r in retired] == [req.request_id]
        assert retired[0].cause == "replica-lost:test"


def _fake_drill(pkg):
    """Submits, ticks, a kill and a rollout over fakes through ``pkg``'s
    fleet; returns what both packages must agree on."""
    fleet = pkg.ServingFleet(clock=lambda: 0.0)
    for i in range(3):
        fleet.add_replica(f"rep-{i}", fake_engine(params="v1", pkg=pkg, clock=lambda: 0.0), step=1)
    reqs = []
    for i in range(30):
        reqs.append(fleet.submit(np.array([1, 2, i % 7 + 1]), 1 + i % 4, request_id=f"q{i}"))
        if i == 5:
            fleet.start_rollout(FakeSource(), 2, grace_s=30.0)
        if i == 12:
            fleet.kill_replica("rep-2", "replica-lost:drill")
        fleet.tick()
    fleet.run_until_drained()
    landed = {
        r.request_id: name for name, rep in fleet.replicas.items() for r in rep.all_retired()
    }
    summary = fleet.summary()
    summary.pop("load")
    return (
        [(r.request_id, r.state, r.cause, list(r.output_tokens)) for r in reqs],
        landed,
        summary,
        fleet.deployed_steps(),
    )


def test_fake_traffic_and_rollout_agree_with_the_jax_fleet():
    assert _fake_drill(port_serving) == _fake_drill(jax_serving)


# -- rolling updates over tensor checkpoints ------------------------------------

_, PCFG = tiny_configs()
S, T = 8, 4


class _CpuSource:
    """The rollout's source: ``TensorCheckpointer.restore_params`` onto the
    CPU (its default device is the card)."""

    def __init__(self, directory):
        self.ckpt = TensorCheckpointer(str(directory))
        self.calls = []

    def restore_params(self, step):
        self.calls.append(step)
        return self.ckpt.restore_params(step, device="cpu")


def _commit(directory, step, seed):
    params = llama_init(torch.Generator().manual_seed(seed), PCFG, device="cpu")
    ckpt = TensorCheckpointer(str(directory))
    ckpt.save(step, {"params": params, "step": torch.tensor(step, dtype=torch.int32)})
    ckpt.commit(step)
    return params


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, PCFG.vocab_size, size=S).astype(np.int32) for _ in range(n)]


def _own(params, prompt):
    return generate(params, torch.from_numpy(prompt)[None], PCFG, max_new_tokens=T, max_len=S + T)[0].tolist()


def _paged_fleet(params, n=3):
    fleet = ServingFleet()
    for i in range(n):
        ex = PagedModelExecutor(params, PCFG, num_slots=2, max_len=S + T, page_size=4)
        fleet.add_replica(f"rep-{i}", ServingEngine(ex), step=1)
    return fleet


def _watch_and_roll(fleet, watcher, source, clock, reqs, more, max_ticks=400, on_tick=None):
    """The serving loop of a fleet behind a watcher: submit ``more`` one a
    tick, offer every newer verified step to a rollout, tick."""
    for _ in range(max_ticks):
        if more:
            reqs.append(fleet.submit(more.pop(0), T))
        step = watcher.check(clock[0])
        current = max(s for s in fleet.deployed_steps().values() if s is not None)
        failed = fleet.rollout_error[0] if fleet.rollout_error else None
        if step is not None and step > current and step != failed:
            fleet.start_rollout(source, step, grace_s=30.0)
        fleet.tick()
        if on_tick is not None:
            on_tick(fleet)
        clock[0] += 1.0
        if not more and not fleet.has_work and not fleet.rollout_active:
            return
    raise AssertionError("fleet did not settle")


class TestRollingUpdate:
    def test_update_reaches_every_replica_with_zero_drops(self, tmp_path):
        p1 = _commit(tmp_path, 1, seed=1)
        fleet = _paged_fleet(TensorCheckpointer(str(tmp_path)).restore_params(1, device="cpu"))
        clock = [0.0]
        watcher = CheckpointWatcher(str(tmp_path), interval_s=2.0, clock=lambda: clock[0])
        source = _CpuSource(tmp_path)
        prompts = _prompts(12, seed=3)
        reqs = [fleet.submit(p, T) for p in prompts[:6]]
        fleet.tick()
        p2 = _commit(tmp_path, 2, seed=2)  # committed while 6 requests are in flight
        _watch_and_roll(fleet, watcher, source, clock, reqs, list(prompts[6:]))
        assert fleet.converged(2) and fleet.rollouts_completed == 1
        assert source.calls == [2]
        assert fleet.summary()["retired_states"] == {RequestState.FINISHED: 12}
        # every request ran wholly on one step's weights
        own1 = [_own(p1, p) for p in prompts]
        own2 = [_own(p2, p) for p in prompts]
        for i, req in enumerate(reqs):
            assert list(req.output_tokens) in (own1[i], own2[i]), i
        # after convergence every replica serves step 2's own tokens
        post = [fleet.submit(p, T) for p in prompts[:6]]
        fleet.run_until_drained()
        assert [list(r.output_tokens) for r in post] == own2[:6]

    def test_candidate_corrupted_between_poll_and_load_aborts(self, tmp_path):
        _commit(tmp_path, 1, seed=1)
        fleet = _paged_fleet(TensorCheckpointer(str(tmp_path)).restore_params(1, device="cpu"))
        _commit(tmp_path, 2, seed=2)
        watcher = CheckpointWatcher(str(tmp_path), interval_s=2.0, clock=lambda: 0.0)
        assert watcher.check() == 2  # verified at poll time
        flip_committed_leaf(str(tmp_path / "2"))  # rots before the load
        reqs = [fleet.submit(p, T) for p in _prompts(6, seed=4)]
        assert fleet.start_rollout(_CpuSource(tmp_path), 2, grace_s=30.0)
        fleet.run_until_drained()
        assert fleet.rollout_error is not None and fleet.rollout_error[0] == 2
        assert fleet.rollout_error[1].startswith("corrupt: ") and "checksum mismatch" in fleet.rollout_error[1]
        assert fleet.converged(1) and fleet.rollouts_completed == 0
        assert all(rep.state == "serving" and not rep.engine.admission_paused for rep in fleet.replicas.values())
        assert all(r.state == RequestState.FINISHED for r in reqs)

    def test_replica_killed_mid_rollout_is_skipped_and_the_rollout_converges(self, tmp_path):
        _commit(tmp_path, 1, seed=1)
        fleet = _paged_fleet(TensorCheckpointer(str(tmp_path)).restore_params(1, device="cpu"))
        clock = [0.0]
        watcher = CheckpointWatcher(str(tmp_path), interval_s=1.0, clock=lambda: clock[0])
        reqs = [fleet.submit(p, T) for p in _prompts(6, seed=5)]
        _commit(tmp_path, 2, seed=2)
        killed = []

        def kill_after_first_swap(fleet):
            if not killed and fleet.replicas["rep-0"].deployed_step == 2:
                fleet.kill_replica("rep-1", f"{CAUSE_REPLICA_LOST}:drill")
                killed.append("rep-1")

        _watch_and_roll(fleet, watcher, _CpuSource(tmp_path), clock, reqs, list(_prompts(6, seed=6)),
                        on_tick=kill_after_first_swap)
        assert killed and fleet.replicas["rep-1"].state == REPLICA_DOWN
        assert fleet.converged(2) and fleet.rollouts_completed == 1
        assert fleet.deployed_steps() == {"rep-0": 2, "rep-1": 1, "rep-2": 2}
        # zero silent drops: every request terminal, every casualty named
        assert all(r.is_terminal() for r in reqs)
        for req in reqs:
            assert req.state == RequestState.FINISHED or req.cause == f"{CAUSE_REPLICA_LOST}:drill"


# -- the fleet supervisor over the fake cluster ---------------------------------

NS = "nexus"
FLEET_JS = "svc"
ALGO = "svc-algo"


def serving_jobset(name=FLEET_JS, replicas=3, kv=64, ns=NS):
    return {
        "kind": "JobSet",
        "apiVersion": "jobset.x-k8s.io/v1alpha2",
        "metadata": {
            "name": name,
            "namespace": ns,
            "uid": f"js-{name}-{ns}",
            "labels": {NEXUS_COMPONENT_LABEL: JOB_LABEL_SERVING_FLEET, JOB_TEMPLATE_NAME_KEY: ALGO},
        },
        "spec": {
            "replicatedJobs": [
                {
                    "name": "replica",
                    "replicas": replicas,
                    "template": {"spec": {"parallelism": 1, "template": {"spec": {"containers": [
                        {"name": "main", "env": [{"name": "NEXUS_KV_BLOCKS", "value": str(kv)}]}
                    ]}}}},
                }
            ]
        },
        "status": {},
    }


def _role_jobset():
    """Role-typed JobSet: a 2-replica prefill pool + a 1-replica decode
    pool, roles declared through the ``NEXUS_REPLICA_ROLE`` container env
    (the same manifest seam as ``NEXUS_KV_BLOCKS``)."""

    def pool(rj_name, replicas, role):
        env = [{"name": "NEXUS_KV_BLOCKS", "value": "64"}, {"name": "NEXUS_REPLICA_ROLE", "value": role}]
        return {"name": rj_name, "replicas": replicas, "template": {"spec": {"parallelism": 1, "template": {
            "spec": {"containers": [{"name": "main", "env": env}]}}}}}

    return {
        "kind": "JobSet",
        "apiVersion": "jobset.x-k8s.io/v1alpha2",
        "metadata": {"name": FLEET_JS, "namespace": NS, "uid": "js-roles",
                     "labels": {NEXUS_COMPONENT_LABEL: JOB_LABEL_SERVING_FLEET, JOB_TEMPLATE_NAME_KEY: ALGO}},
        "spec": {"replicatedJobs": [pool("prefill", 2, ROLE_PREFILL), pool("decode", 1, ROLE_DECODE)]},
        "status": {},
    }


def pod_name(i):
    return f"{FLEET_JS}-replica-{i}-0"


async def _settle():
    for _ in range(6):
        await asyncio.sleep(0.02)


class _Fixture:
    def __init__(self, client, store, fleet, sup, ctx, made):
        self.client = client
        self.store = store
        self.fleet = fleet
        self.sup = sup
        self.ctx = ctx
        self.made = made

    async def close(self):
        self.ctx.cancel()
        await self.sup._factory.shutdown()

    def ledger(self):
        return self.store.read_checkpoint(ALGO, FLEET_JS)


def _packages(jax=False):
    """(FakeKubeClient, InMemoryCheckpointStore, LifecycleContext, serving
    package) of the port, or of the JAX package."""
    if jax:
        from tpu_nexus.checkpoint.store import InMemoryCheckpointStore as Store
        from tpu_nexus.core.signals import LifecycleContext as Ctx
        from tpu_nexus.k8s.fake import FakeKubeClient as Client

        return Client, Store, Ctx, jax_serving
    return FakeKubeClient, InMemoryCheckpointStore, LifecycleContext, port_serving


async def fleet_fixture(emit_pod_events=True, source=None, watcher=None, kv=64, missing_after_s=0.0, adopt_step=1,
                        jax=False, clock=None, jobset=None, fleet_kwargs=None, **sup_kwargs):
    """A package's ``FleetSupervisor`` over its own ``FakeKubeClient``
    seeded with ``jobset`` (the 3-replica serving JobSet by default), its
    pods adopted at ``adopt_step``; ``fleet_kwargs`` go to ``ServingFleet``
    and ``sup_kwargs`` to ``FleetSupervisor``."""
    Client, Store, Ctx, pkg = _packages(jax)
    client = Client(jobset_controller=True, emit_pod_events=emit_pod_events)
    client.inject("ADDED", "JobSet", jobset or serving_jobset(kv=kv))
    store = Store()
    fleet_kwargs = dict(fleet_kwargs or {})
    if clock is not None:
        fleet_kwargs["clock"] = clock
    fleet = pkg.ServingFleet(**fleet_kwargs)
    made = []

    def factory(name, step, kv_blocks):
        made.append((name, step, kv_blocks))
        return fake_engine(params=f"params@{step}", pkg=pkg, clock=clock)

    sup = pkg.FleetSupervisor(
        client, store, NS, fleet, FLEET_JS, ALGO, factory, source=source, watcher=watcher, grace_s=30.0,
        kv_blocks=kv, missing_after_s=missing_after_s, resync_period=timedelta(0), **sup_kwargs,
    )
    ctx = Ctx()
    sup._factory.start(ctx)
    assert await sup._factory.wait_for_cache_sync(timeout=10.0)
    adopted = await sup.adopt_pods(step=adopt_step)
    if jobset is None:
        assert adopted == sorted(pod_name(i) for i in range(3))
    return _Fixture(client, store, fleet, sup, ctx, made)


class TestFleetSupervisor:
    """The cases of ``tests/test_rollout_chaos.py::TestFleetSupervisor``
    against the port's ``FleetSupervisor``."""

    async def test_pod_deletion_recreated_with_taxonomy_cause(self):
        fx = await fleet_fixture()
        try:
            reqs = _submit_all(fx.fleet, 3)
            fx.fleet.tick()  # everyone decoding
            await fx.client.delete_object("Pod", NS, pod_name(0))
            await _settle()
            await fx.sup.reconcile()
            assert fx.sup.recreated == 1
            rep = fx.fleet.replicas[pod_name(0)]
            assert rep.state == "serving"
            # the killed replica's in-flight requests are accounted, never lost
            lost = [r for r in fx.fleet.all_retired()
                    if r.cause == f"{CAUSE_REPLICA_LOST}:{DecisionAction.TO_PREEMPT_RESTARTABLE}"]
            assert len(lost) == 1 and lost[0].state == RequestState.FAILED
            # honest cause in the ledger, row still RUNNING (fleet is alive)
            row = fx.ledger()
            assert row.lifecycle_stage == LifecycleStage.RUNNING
            assert row.algorithm_failure_cause == MSG_PREEMPTED
            assert pod_name(0) in row.algorithm_failure_details
            # a REPLACEMENT pod exists with a fresh uid
            pod = fx.client._objects["Pod"][(NS, pod_name(0))]
            assert pod["metadata"]["uid"].startswith("fleet-recreate-")
            # the untouched replicas finish their work
            fx.fleet.run_until_drained()
            assert sum(r.state == RequestState.FINISHED for r in reqs) == 2
        finally:
            await fx.close()

    async def test_hbm_oom_recreates_with_halved_kv_blocks(self):
        fx = await fleet_fixture(kv=64)
        try:
            fx.client.fail_pod(NS, pod_name(1), message=FAULT_HBM_OOM_TEXT, exit_code=137)
            await _settle()
            await fx.sup.reconcile()
            assert fx.sup.recreated == 1
            assert fx.made[-1] == (pod_name(1), 1, 32)  # halved budget
            pod = fx.client._objects["Pod"][(NS, pod_name(1))]
            env = pod["spec"]["containers"][0]["env"]
            assert {"name": "NEXUS_KV_BLOCKS", "value": "32"} in env
            assert fx.ledger().algorithm_failure_cause == MSG_HBM_OOM
            # a second OOM halves again, floored at min_kv_blocks
            fx.client.fail_pod(NS, pod_name(1), message=FAULT_HBM_OOM_TEXT, exit_code=137)
            await _settle()
            await fx.sup.reconcile()
            assert fx.made[-1] == (pod_name(1), 1, 16)
        finally:
            await fx.close()

    async def test_crash_loop_recreates(self):
        fx = await fleet_fixture()
        try:
            fx.client.fail_pod(NS, pod_name(2), message="segfault", crash_loop=True)
            await _settle()
            await fx.sup.reconcile()
            assert fx.sup.recreated == 1 and fx.sup.escalated == 0
            assert fx.sup.incidents[-1]["action"] == DecisionAction.TO_FAIL_FATAL_ERROR
            # our OWN recreate deletion must not echo as a second incident
            await _settle()
            await fx.sup.reconcile()
            assert fx.sup.recreated == 1
        finally:
            await fx.close()

    async def test_generic_pod_crash_recreates_via_quirk_remap(self):
        """A dead serving pod (the Pod-'Failed' quirk's stuck-in-pending
        class for whole runs) is remapped to the fatal-error class and
        RECREATED — one transient segfault must never shrink the fleet."""
        fx = await fleet_fixture()
        try:
            req = fx.fleet.submit(np.array([1, 2, 3]), 8)
            fx.fleet.tick()
            fx.client.fail_pod(NS, pod_name(0), message="segfault in userland")
            await _settle()
            await fx.sup.reconcile()
            assert fx.sup.recreated == 1 and fx.sup.escalated == 0
            record = fx.sup.incidents[-1]
            assert record["action"] == DecisionAction.TO_FAIL_FATAL_ERROR
            assert record["recovery"] == FleetRecovery.RECREATE
            assert fx.fleet.replicas[pod_name(0)].state == "serving"
            # whichever replica held it, the request is terminal + accounted
            routed_to_dead = req.cause.startswith(CAUSE_REPLICA_LOST)
            fx.fleet.run_until_drained()
            assert req.is_terminal()
            assert routed_to_dead or req.state == RequestState.FINISHED
        finally:
            await fx.close()

    async def test_jobset_scheduling_failure_escalates_without_phantom_replica(self):
        """JobSet-level conditions name no pod: they escalate with the cause
        recorded and never mint a phantom replica named after the JobSet."""
        fx = await fleet_fixture()
        try:
            fx.client.inject("ADDED", "Event", event_obj("FailedCreate", "quota exceeded", "JobSet", FLEET_JS))
            await _settle()
            await fx.sup.reconcile(now=50.0)
            assert fx.sup.escalated == 1 and fx.sup.recreated == 0
            record = fx.sup.incidents[-1]
            assert record["action"] == DecisionAction.TO_FAIL_STUCK_IN_PENDING
            assert record["recovery"] == FleetRecovery.ESCALATE
            assert record["pod"] == ""
            assert fx.ledger().algorithm_failure_cause == MSG_STUCK_IN_PENDING
            assert sorted(fx.fleet.replicas) == sorted(pod_name(i) for i in range(3))
            await fx.sup.reconcile(now=100.0)
            await fx.sup.reconcile(now=200.0)
            assert fx.sup.recreated == 0
        finally:
            await fx.close()

    async def test_ledger_heartbeats_per_reconcile(self):
        fx = await fleet_fixture()
        try:
            await fx.sup.reconcile(now=1.0)
            first = fx.ledger().per_chip_steps.get("fleet/reconciles", 0)
            await fx.sup.reconcile(now=2.0)
            second = fx.ledger().per_chip_steps.get("fleet/reconciles", 0)
            assert second > first >= 1
            assert fx.ledger().lifecycle_stage == LifecycleStage.RUNNING
        finally:
            await fx.close()

    async def test_watchdog_sweep_recreates_silently_missing_pod(self):
        fx = await fleet_fixture(emit_pod_events=False, missing_after_s=10.0)
        try:
            # vanish without any event reaching the informers
            fx.client._objects["Pod"].pop((NS, pod_name(1)))
            fx.sup._factory.informers["Pod"]._cache.pop((NS, pod_name(1)))
            fx.sup._pending.clear()
            await fx.sup.reconcile(now=100.0)  # first observation only
            assert fx.sup.recreated == 0
            await fx.sup.reconcile(now=105.0)  # inside the deadline
            assert fx.sup.recreated == 0
            await fx.sup.reconcile(now=111.0)  # past missing_after_s
            assert fx.sup.recreated == 1
            record = fx.sup.incidents[-1]
            assert record["action"] == DecisionAction.TO_PREEMPT_RESTARTABLE
            assert MSG_POD_MISSING in record["trace"]
            assert (NS, pod_name(1)) in fx.client._objects["Pod"]
        finally:
            await fx.close()


def _strip_dump_paths(record):
    """An incident record without the flight-recorder artifact's path and
    wall time (they name the run's own directory and clock)."""
    out = dict(record)
    if "flight_recorder" in out:
        out["flight_recorder"] = {k: v for k, v in out["flight_recorder"].items() if k not in ("path", "t", "wall_t")}
    return out


async def _incident_script(jax):
    """One recorded incident script through a package's ``FleetSupervisor``
    over its own ``FakeKubeClient``, fake engines on a frozen clock: a pod
    deletion, a BackOff (crash loop), an HBM OOM, a preemption and an event
    for a pod the cluster does not hold.  Returns what both packages must
    agree on."""
    clock = lambda: 0.0  # noqa: E731
    fx = await fleet_fixture(jax=jax, clock=clock)
    try:
        for i in range(6):
            fx.fleet.submit(np.array([1, 2, i + 1]), 6, request_id=f"q{i}")
        fx.fleet.tick()
        steps = [
            lambda: fx.client.delete_object("Pod", NS, pod_name(0)),
            lambda: fx.client.fail_pod(NS, pod_name(2), message="panic: nil deref", crash_loop=True),
            lambda: fx.client.fail_pod(NS, pod_name(1), message=FAULT_HBM_OOM_TEXT, exit_code=137),
            lambda: fx.client.inject("ADDED", "Event", event_obj("TPUPreempted", "slice preempted", "Pod",
                                                                 pod_name(1))),
            lambda: fx.client.inject("ADDED", "Event", event_obj("Failed", "boom", "Pod", f"{FLEET_JS}-ghost-0")),
        ]
        for t, step in enumerate(steps):
            out = step()
            if asyncio.iscoroutine(out):
                await out
            await _settle()
            await fx.sup.reconcile(now=float(t + 1))
            fx.fleet.tick()
        fx.fleet.run_until_drained()
        row = fx.ledger()
        row_fields = {k: v for k, v in vars(row).items() if k != "last_modified"}
        row_fields["algorithm_failure_details"] = _strip_dump_paths(json.loads(row.algorithm_failure_details))
        kv = {name: fx.sup._kv_blocks.get(name) for name in sorted(fx.fleet.replicas)}
        pods = {name: fx.client._objects["Pod"][(NS, name)]["spec"]["containers"][0]["env"]
                for name in sorted(fx.fleet.replicas)}
        retired = sorted((r.request_id, r.state, r.cause, list(r.output_tokens)) for r in fx.fleet.all_retired())
        return ([_strip_dump_paths(r) for r in fx.sup.incidents], row_fields, fx.sup.recreated, fx.sup.escalated,
                kv, pods, list(fx.made), retired)
    finally:
        await fx.close()


async def test_incident_script_agrees_with_the_jax_supervisor():
    port, ref = await _incident_script(jax=False), await _incident_script(jax=True)
    names = ("incidents", "ledger row", "recreated", "escalated", "kv_blocks", "pod env", "factory calls", "retired")
    for name, got, want in zip(names, port, ref):
        assert got == want, name
    incidents, _, recreated, escalated, kv, _, _, _ = port
    assert recreated == 4 and escalated == 0
    assert [i["action"] for i in incidents] == [
        DecisionAction.TO_PREEMPT_RESTARTABLE, DecisionAction.TO_FAIL_FATAL_ERROR, DecisionAction.TO_FAIL_HBM_OOM,
        DecisionAction.TO_PREEMPT_RESTARTABLE]
    assert kv == {pod_name(0): 64, pod_name(1): 32, pod_name(2): 64}


def _vanish(fx, pod):
    """``pod`` leaves the cluster with no event reaching the informers."""
    fx.client._objects["Pod"].pop((NS, pod))
    fx.sup._factory.informers["Pod"]._cache.pop((NS, pod))
    fx.sup._pending.clear()


def _supervisor_state(fx):
    """What both packages' supervisors must agree on after a script."""
    row = fx.ledger()
    row_fields = {k: v for k, v in vars(row).items() if k != "last_modified"}
    row_fields["algorithm_failure_details"] = _strip_dump_paths(json.loads(row.algorithm_failure_details))
    names = sorted(fx.fleet.replicas)
    sup = fx.sup
    return dict(
        incidents=[_strip_dump_paths(r) for r in sup.incidents],
        scale_events=[_strip_dump_paths(r) for r in sup.scale_events],
        pressure_events=[_strip_dump_paths(r) for r in sup.pressure_events], transitions=list(sup.slo.transitions) if sup.slo else None,
        row=row_fields, counters=(sup.recreated, sup.escalated, sup.scaled_up, sup.scaled_down),
        kv={name: sup._kv_blocks.get(name) for name in names},
        roles={name: rep.role for name, rep in fx.fleet.replicas.items()},
        pods={name: fx.client._objects["Pod"][(NS, name)]["spec"]["containers"][0]["env"] for name in names},
        deleted=sorted(fx.client.deleted("Pod")), made=list(fx.made),
        retired=sorted((r.request_id, r.state, r.cause, list(r.output_tokens)) for r in fx.fleet.all_retired()),
    )


async def _autoscale_script(jax):
    """Autoscaling and the missing-pod sweep through a package's supervisor
    (fake engines, frozen clock): a paused replica sheds until the fleet is
    SATURATED and scales up to its max of 4, drains, scales down to 3 once
    idle, and then a pod vanishes with no event and the sweep recreates
    it."""
    Client, Store, Ctx, pkg = _packages(jax)
    clock = lambda: 0.0  # noqa: E731
    targets = pkg.SloTargets(shed_rate=0.05, short_window=1, long_window=2, pressured_burn=1.0, saturated_burn=1.0)
    fx = await fleet_fixture(jax=jax, clock=clock, missing_after_s=10.0, slo=pkg.SloMonitor(targets, clock=clock),
                             autoscale=pkg.AutoscaleConfig(min_replicas=3, max_replicas=4, scale_up_after=1,
                                                           scale_down_after=2, cooldown_s=0.0))
    try:
        for i in range(3):
            fx.fleet.submit(np.array([1, 2, i + 1]), 3, request_id=f"q{i}")
        await fx.sup.reconcile(now=1.0)
        overloaded = fx.fleet.replicas[pod_name(0)].engine
        overloaded.pause_admission()
        for t in (2.0, 3.0):
            with pytest.raises(pkg.QueueFull):
                overloaded.submit(np.array([9, 9, int(t)]), 2, request_id=f"shed{int(t)}")
            await fx.sup.reconcile(now=t)
        overloaded.resume_admission()
        fx.fleet.run_until_drained()
        for t in (4.0, 5.0, 6.0):
            await fx.sup.reconcile(now=t)
        _vanish(fx, sorted(fx.fleet.replicas)[0])
        for t in (100.0, 105.0, 111.0):
            await fx.sup.reconcile(now=t)
        return _supervisor_state(fx)
    finally:
        await fx.close()


async def _roles_script(jax):
    """A role-typed JobSet (two prefill pods, one decode pod) through a
    package's supervisor: a crash-looping prefill pod and a decode pod that
    vanishes with no event are both recreated in their roles, then two
    scale-downs drain one prefill pod and stop at each role's floor."""
    Client, Store, Ctx, pkg = _packages(jax)
    clock = lambda: 0.0  # noqa: E731
    fx = await fleet_fixture(jax=jax, clock=clock, missing_after_s=10.0, jobset=_role_jobset(),
                             fleet_kwargs=dict(disagg=pkg.DisaggConfig(), handoff_sleep=lambda s: None))
    try:
        fx.client.fail_pod(NS, f"{FLEET_JS}-prefill-0-0", message="segfault", crash_loop=True)
        await _settle()
        await fx.sup.reconcile(now=1.0)
        _vanish(fx, f"{FLEET_JS}-decode-0-0")
        for t in (100.0, 111.0):
            await fx.sup.reconcile(now=t)
        for t in (120.0, 121.0):
            await fx.sup._scale_down(t, "healthy", fx.fleet.snapshot())
        return _supervisor_state(fx)
    finally:
        await fx.close()


@pytest.mark.parametrize("script", [_autoscale_script, _roles_script], ids=["autoscale_and_sweep", "roles"])
async def test_control_script_agrees_with_the_jax_supervisor(script):
    """Autoscaling (streaks, cooldown, ``max_replicas``, the scale-down
    victim), the missing-pod sweep and role-preserving recreates through
    both packages' supervisors: every record, row, counter, manifest and
    retirement equal."""
    port, ref = await script(jax=False), await script(jax=True)
    for name in port:
        assert port[name] == ref[name], name
    recreated, escalated, up, down = port["counters"]
    if script is _autoscale_script:
        assert (recreated, escalated, up, down) == (1, 0, 1, 1)
        assert [e["decision"] for e in port["scale_events"]] == ["scale-up", "scale-down"]
        assert MSG_POD_MISSING in port["incidents"][-1]["trace"]
    else:
        assert (recreated, escalated, up, down) == (2, 0, 0, 1)
        assert sorted(port["roles"].values()) == ["decode", "prefill"]
        assert [i["role"] for i in port["incidents"]] == ["prefill", "decode"]


# -- end-to-end rollout drills (real verified checkpoints) ----------------------


class _DrillSource(_CpuSource):
    """The port's ``TensorCheckpointer`` as a rollout source, restoring
    onto the CPU, with the checkpointer's ``reload``/``close``."""

    def reload(self):
        self.ckpt.reload()

    def close(self):
        self.ckpt.close()


def _commit_params(d, step, value):
    ck = TensorCheckpointer(d)
    ck.save(step, {"params": {"w": torch.full((4,), float(value), dtype=torch.float32)}})
    ck.commit(step)
    ck.close()


async def _drive(fx, reqs, target, total=24, bound=400):
    """Closed-loop client: keep submitting while reconciling until the
    fleet converges on ``target`` — fleet.submit must NEVER shed."""
    t = 0.0
    for _ in range(bound):
        if len(reqs) < total:
            reqs.append(fx.fleet.submit(np.array([1, 2, 5]), 3))
        t += 2.0
        await fx.sup.reconcile(now=t)
        if fx.fleet.converged(target) and len(reqs) >= total and not fx.fleet.has_work:
            return t
    raise AssertionError(f"fleet did not converge on step {target}: {fx.fleet.summary()}")


class TestRolloutDrills:
    """The cases of ``tests/test_rollout_chaos.py::TestRolloutDrills``
    against the port's supervisor and ``TensorCheckpointer``."""

    async def test_full_rolling_update_zero_drop(self, tmp_path):
        d = str(tmp_path / "ckpt")
        _commit_params(d, 1, 1.0)
        fx = await fleet_fixture(source=_DrillSource(d), watcher=CheckpointWatcher(d, interval_s=1.0))
        try:
            _commit_params(d, 2, 2.0)
            reqs = []
            await _drive(fx, reqs, target=2)
            assert fx.fleet.rollouts_completed == 1
            assert fx.fleet.deployed_steps() == {pod_name(i): 2 for i in range(3)}
            # the restored weights really landed in every replica
            for rep in fx.fleet.replicas.values():
                assert torch.equal(rep.engine.executor.params["w"], torch.full((4,), 2.0))
                assert rep.engine.weight_swaps == 1
            # ZERO dropped requests: every submitted request FINISHED
            assert fx.fleet.summary()["retired_states"] == {RequestState.FINISHED: len(reqs)}
        finally:
            fx.sup.source.close()
            await fx.close()

    async def test_pod_kill_mid_rollout_converges_with_causes(self, tmp_path):
        d = str(tmp_path / "ckpt")
        _commit_params(d, 1, 1.0)
        fx = await fleet_fixture(source=_DrillSource(d), watcher=CheckpointWatcher(d, interval_s=1.0))
        try:
            _commit_params(d, 2, 2.0)
            reqs = _submit_all(fx.fleet, 6, max_new=6)
            # start the rollout, then kill a pod while it is in flight
            await fx.sup.reconcile(now=0.5)
            assert fx.fleet.rollout_active
            await fx.client.delete_object("Pod", NS, pod_name(1))
            await _settle()
            await _drive(fx, reqs, target=2, total=len(reqs) + 6)
            assert fx.sup.recreated == 1
            assert fx.ledger().algorithm_failure_cause == MSG_PREEMPTED
            # revived ON the rollout's target step (factory got step=2)
            assert (pod_name(1), 2, 64) in fx.made
            for req in [*reqs, *fx.fleet.all_retired()]:
                assert req.is_terminal()
                if req.state != RequestState.FINISHED:
                    assert req.cause, f"{req.request_id} dropped without a cause"
            assert fx.fleet.converged(2)
        finally:
            fx.sup.source.close()
            await fx.close()

    async def test_corrupt_candidate_quarantined_never_loaded(self, tmp_path):
        d = str(tmp_path / "ckpt")
        _commit_params(d, 1, 1.0)
        fx = await fleet_fixture(source=_DrillSource(d), watcher=CheckpointWatcher(d, interval_s=1.0, quarantine=True))
        try:
            _commit_params(d, 2, 2.0)
            flip_committed_leaf(os.path.join(d, "2"))
            reqs = []
            await _drive(fx, reqs, target=1, total=12)
            assert os.path.exists(os.path.join(d, "2.corrupt"))
            assert fx.fleet.rollouts_completed == 0
            assert all(rep.engine.weight_swaps == 0 for rep in fx.fleet.replicas.values())
            assert fx.fleet.summary()["retired_states"] == {RequestState.FINISHED: len(reqs)}
        finally:
            fx.sup.source.close()
            await fx.close()

    async def test_corruption_after_poll_aborts_at_load_verification(self, tmp_path):
        d = str(tmp_path / "ckpt")
        _commit_params(d, 1, 1.0)
        fx = await fleet_fixture(source=_DrillSource(d), watcher=CheckpointWatcher(d, interval_s=1.0))
        try:
            _commit_params(d, 2, 2.0)
            # the poll that vouches for step 2 happens while it is GOOD...
            assert fx.sup.watcher.poller.latest_verified_step() == 2
            flip_committed_leaf(os.path.join(d, "2"))  # ...then it rots
            restores = []
            orig_restore = fx.sup.source.restore_params
            fx.sup.source.restore_params = lambda s: (restores.append(s), orig_restore(s))[1]
            reqs = []
            await _drive(fx, reqs, target=1, total=12)
            assert fx.fleet.rollout_error is not None
            assert fx.fleet.rollout_error[0] == 2
            assert "corrupt" in fx.fleet.rollout_error[1]
            assert restores == [2]  # one attempt, then the bad step is shunned
            for rep in fx.fleet.replicas.values():
                assert rep.engine.weight_swaps == 0
                assert rep.deployed_step == 1
                assert rep.state == "serving"
            assert fx.fleet.summary()["retired_states"] == {RequestState.FINISHED: len(reqs)}
            # REPAIR: quarantine the rot and re-commit a VALID step 2 — the
            # shun is keyed by directory state, so it earns a fresh attempt
            durability.quarantine_step(d, 2)
            _commit_params(d, 2, 2.0)
            fx.sup.source.reload()
            await _drive(fx, reqs, target=2, total=len(reqs) + 6)
            assert restores == [2, 2]
            assert fx.fleet.converged(2)
        finally:
            fx.sup.source.close()
            await fx.close()

    async def test_sigterm_replica_mid_drain_converges(self, tmp_path):
        d = str(tmp_path / "ckpt")
        _commit_params(d, 1, 1.0)
        fx = await fleet_fixture(source=_DrillSource(d), watcher=CheckpointWatcher(d, interval_s=1.0))
        try:
            _commit_params(d, 2, 2.0)
            # long generations so the first replica is mid-quiesce with work
            reqs = _submit_all(fx.fleet, 6, max_new=50)
            fx.fleet.tick()
            await fx.sup.reconcile(now=0.5)
            assert fx.fleet.rollout_active
            reloading = [name for name, rep in fx.fleet.replicas.items() if rep.state == "reloading"]
            assert len(reloading) == 1
            victim = fx.fleet.replicas[reloading[0]]
            assert victim.engine.has_work  # mid-drain, by construction
            victim.engine.drain(0.0)
            await fx.client.delete_object("Pod", NS, reloading[0])
            await _settle()
            for req in reqs:
                if not req.is_terminal():
                    req.cancel_requested = True
            t = 1.0
            for _ in range(200):
                t += 2.0
                await fx.sup.reconcile(now=t)
                if fx.fleet.converged(2) and not fx.fleet.has_work:
                    break
            assert fx.fleet.converged(2)
            assert fx.sup.recreated == 1
            assert (reloading[0], 2, 64) in fx.made
            for req in reqs:
                assert req.is_terminal()
                if req.state not in (RequestState.FINISHED, RequestState.CANCELLED):
                    assert req.cause, f"{req.request_id} dropped without a cause"
            drained = [r for r in fx.fleet.all_retired() if r.cause.startswith("drain:")]
            assert drained, "the mid-drain SIGTERM left no drain-cause evidence"
        finally:
            fx.sup.source.close()
            await fx.close()


# -- the saturation drill --------------------------------------------------------


def _slo_engine(slots=2, max_len=64):
    return ServingEngine(FleetFakeExecutor(num_slots=slots, max_len=max_len))


def _targets(**over):
    base = dict(ttft_p99_s=0.01, short_window=2, long_window=4)
    base.update(over)
    return SloTargets(**base)


class TestSaturationDrill:
    """The cases of ``tests/test_loadstats.py::TestSaturationDrill``: an
    injected slow step drives one replica of a supervised fleet HEALTHY ->
    PRESSURED -> SATURATED, the transition lands on the fleet's RUNNING
    ledger row, and the saturated replica's flight recorder dumps."""

    def test_slow_step_escalates_with_ledger_and_dump(self, tmp_path):
        store = InMemoryCheckpointStore()
        fleet = ServingFleet()
        slow = FaultyExecutor(FleetFakeExecutor(num_slots=2, max_len=256), "slow-step", at_step=0, slow_s=0.03)
        eng0 = ServingEngine(slow, tracer=EngineTracer(recorder=FlightRecorder(dump_dir=str(tmp_path))))
        fleet.add_replica("r0", eng0)
        fleet.add_replica("r1", _slo_engine(max_len=256))
        sup = FleetSupervisor(
            FakeKubeClient(), store, NS, fleet, FLEET_JS, ALGO, lambda name, step, kv: _slo_engine(),
            slo=SloMonitor(SloTargets(tpot_p99_s=0.005, short_window=2, long_window=4)),
        )
        # all traffic onto the slow replica directly (the blast-radius check)
        for i in range(8):
            eng0.submit(np.array([1, 2, 3]), 200, request_id=f"q{i}")
        seen = []

        async def drive():
            for _ in range(8):
                await sup.reconcile()
                seen.append(sup.slo.grades.get("r0", PRESSURE_HEALTHY))
                if sup.slo.grades.get("r0") == PRESSURE_SATURATED:
                    break

        asyncio.run(drive())
        assert seen[-1] == PRESSURE_SATURATED, seen
        assert PRESSURE_PRESSURED in seen
        tos = [t["to"] for t in sup.pressure_events if t["scope"] == "r0"]
        assert tos == [PRESSURE_PRESSURED, PRESSURE_SATURATED]
        assert sup.slo.grades["r1"] == PRESSURE_HEALTHY
        cp = store.read_checkpoint(ALGO, FLEET_JS)
        assert "fleet pressure: " in cp.algorithm_failure_cause
        details = json.loads(cp.algorithm_failure_details)
        assert details["pressure"]["to"] in (PRESSURE_PRESSURED, PRESSURE_SATURATED)
        assert details["grades"]["r0"] == PRESSURE_SATURATED
        assert details["fleet"]["replicas"]["r0"]["state"] == "serving"
        sat = next(t for t in sup.pressure_events if t["to"] == PRESSURE_SATURATED)
        assert sat["flight_recorder"]["reason"] == "saturation:slo-saturated:r0"
        with open(sat["flight_recorder"]["path"], "r", encoding="utf-8") as fh:
            artifact = json.load(fh)
        assert artifact["seam"] == "saturation"
        assert artifact["implicated_total"] > 0
        assert eng0.metrics.trace_dumps_total == 1

    def test_down_replica_graded_down_via_supervisor(self):
        store = InMemoryCheckpointStore()
        fleet = ServingFleet()
        fleet.add_replica("r0", _slo_engine())
        fleet.add_replica("r1", _slo_engine())
        sup = FleetSupervisor(FakeKubeClient(), store, NS, fleet, FLEET_JS, ALGO,
                              lambda name, step, kv: _slo_engine(), slo=SloMonitor(_targets()))
        # an incident already on the books: the pressure write that follows
        # shares the cause/details columns and must CARRY it
        sup.incidents.append({"cause": "replica-lost:test", "replica": "r0", "action": "recreate"})

        async def drive():
            await sup.reconcile()
            fleet.kill_replica("r0", "replica-lost:test")
            await sup.reconcile()

        asyncio.run(drive())
        assert sup.slo.grades["r0"] == PRESSURE_DOWN
        assert sup.slo.grades["fleet"] == PRESSURE_PRESSURED
        assert any(t["scope"] == "r0" and t["to"] == PRESSURE_DOWN for t in sup.pressure_events)
        cp = store.read_checkpoint(ALGO, FLEET_JS)
        assert cp.algorithm_failure_cause.startswith("fleet pressure: ")
        details = json.loads(cp.algorithm_failure_details)
        assert details["incidents"][-1]["cause"] == "replica-lost:test"

    def test_pressure_events_log_bounded(self):
        fleet = ServingFleet()
        fleet.add_replica("r0", _slo_engine())
        sup = FleetSupervisor(FakeKubeClient(), InMemoryCheckpointStore(), NS, fleet, FLEET_JS, ALGO,
                              lambda name, step, kv: _slo_engine(),
                              slo=SloMonitor(_targets(short_window=1, long_window=1)))
        sup._pressure_events_limit = 3

        class FlappingMonitor:
            grades = {}

            def observe(self, snapshot):
                return [{"scope": "ghost", "from": PRESSURE_HEALTHY, "to": PRESSURE_PRESSURED,
                         "action": "record", "t": 0.0}]

            def summary(self):
                return {}

        sup.slo = FlappingMonitor()

        async def drive():
            for _ in range(8):
                await sup.reconcile()

        asyncio.run(drive())
        assert len(sup.pressure_events) == 3
