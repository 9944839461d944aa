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

Tolerance: none — tokens, states and causes are compared exactly.
"""

import numpy as np
import pytest
import torch

import tpu_nexus.serving as jax_serving
import tpu_nexus_torch.serving as port_serving
from tpu_nexus_torch.models.generate import generate
from tpu_nexus_torch.models.llama import llama_init
from tpu_nexus_torch.serving import (
    CAUSE_REPLICA_LOST,
    CheckpointWatcher,
    PagedModelExecutor,
    QueueFull,
    RequestState,
    ServingEngine,
    ServingFleet,
)
from tpu_nexus_torch.serving.engine import CAUSE_RELOAD_GRACE
from tpu_nexus_torch.serving.fleet import REPLICA_DOWN
from tpu_nexus_torch.workload import durability
from tpu_nexus_torch.workload.faults import flip_committed_leaf
from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer
from test_torch_llama import tiny_configs

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
