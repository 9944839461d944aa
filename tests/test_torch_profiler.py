"""The device profiler hook of the port (``serving/tracing.py::
DeviceProfiler`` on ``torch.profiler``), against the JAX package's.

* The reference's ``TestDeviceProfiler`` cases
  (``tests/test_serving_tracing.py``) with a fake profiler behind the
  ``_profiler()`` seam: the one-shot window, ``stop()`` closing a capture
  the run ended inside of, start and stop failures counted and disabling,
  ``from_env`` and its malformed values disarming.
* A real capture on the CPU from a tiny ``run_workload`` and from a tiny
  ``run_serve_engine``: the window ends DONE with no failure and writes
  one Chrome trace JSON holding the window's host events.
* ``NEXUS_PROFILE_DIR`` parses in training and serve-engine; the
  serve-engine summary's ``"profiler"`` entry has the reference's keys and
  values for the same window (the JAX run behind a fake profiler).
"""

import dataclasses
import json

import pytest
import torch

from tpu_nexus.checkpoint.store import InMemoryCheckpointStore as JaxInMemoryStore
from tpu_nexus.parallel.distributed import ProcessContext as JaxProcessContext
from tpu_nexus.serving import tracing as jax_tracing
from tpu_nexus.workload.serve import ServeConfig as JaxServeConfig
from tpu_nexus.workload.serve import run_serve_engine as jax_run_serve_engine
from tpu_nexus_torch.checkpoint.models import LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import NullMetrics
from tpu_nexus_torch.models.registry import get_adapter
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.serving import DeviceProfiler
from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine

torch.set_num_threads(1)


class FakeProfiler:
    def __init__(self):
        self.calls = []

    def start_trace(self, d):
        self.calls.append(("start", d))

    def stop_trace(self):
        self.calls.append(("stop",))


def _patched(monkeypatch, prof, fake, cls=DeviceProfiler):
    monkeypatch.setattr(cls, "_profiler", lambda self: fake)
    return prof


class TestDeviceProfiler:
    def test_window_state_machine(self, monkeypatch, tmp_path):
        fake = FakeProfiler()
        prof = _patched(monkeypatch, DeviceProfiler(str(tmp_path / "p"), start_step=2, num_steps=3), fake)
        for step in range(10):
            prof.tick(step)
        assert fake.calls == [("start", str(tmp_path / "p")), ("stop",)]
        assert prof.state == DeviceProfiler.DONE
        prof.tick(11)  # one-shot: never re-arms
        assert len(fake.calls) == 2

    def test_stop_closes_inflight_capture(self, monkeypatch, tmp_path):
        fake = FakeProfiler()
        prof = _patched(monkeypatch, DeviceProfiler(str(tmp_path / "p"), start_step=0, num_steps=100), fake)
        prof.tick(0)
        prof.stop()  # run ended inside the window
        assert fake.calls[-1] == ("stop",)
        prof.stop()  # idempotent
        assert len(fake.calls) == 2

    def test_start_failure_counted_and_disables(self, monkeypatch, tmp_path):
        class Broken:
            def start_trace(self, d):
                raise RuntimeError("no profiler in this build")

        prof = _patched(monkeypatch, DeviceProfiler(str(tmp_path / "p"), num_steps=2), Broken())
        prof.tick(0)  # must not raise into the loop
        assert prof.failures == 1
        assert prof.state == DeviceProfiler.DONE
        assert prof.summary() == {"dir": str(tmp_path / "p"), "state": "done", "failures": 1}

    def test_stop_failure_counted(self, monkeypatch, tmp_path):
        class BrokenStop(FakeProfiler):
            def stop_trace(self):
                raise RuntimeError("export failed")

        prof = _patched(monkeypatch, DeviceProfiler(str(tmp_path / "p"), num_steps=1), BrokenStop())
        prof.tick(0)
        prof.tick(1)  # leaving the window: the stop fails, counted
        assert (prof.state, prof.failures) == (DeviceProfiler.DONE, 1)

    def test_from_env(self):
        assert DeviceProfiler.from_env({}) is None
        prof = DeviceProfiler.from_env(
            {"NEXUS_PROFILE_DIR": "/tmp/p", "NEXUS_PROFILE_START": "5", "NEXUS_PROFILE_STEPS": "7"}
        )
        assert (prof.profile_dir, prof.start_step, prof.num_steps, prof.cuda) == ("/tmp/p", 5, 7, False)
        assert DeviceProfiler.from_env({"NEXUS_PROFILE_DIR": "/tmp/p"}, cuda=True).cuda
        ref = jax_tracing.DeviceProfiler.from_env({"NEXUS_PROFILE_DIR": "/tmp/p"})
        default = DeviceProfiler.from_env({"NEXUS_PROFILE_DIR": "/tmp/p"})
        assert (default.start_step, default.num_steps) == (ref.start_step, ref.num_steps) == (0, 10)

    def test_from_env_bad_values_disarm_instead_of_raising(self):
        # the best-effort contract starts at parse: a malformed profiling
        # knob must never take down the serving/training run it rides in
        for bad in (
            {"NEXUS_PROFILE_DIR": "/tmp/p", "NEXUS_PROFILE_STEPS": "0"},
            {"NEXUS_PROFILE_DIR": "/tmp/p", "NEXUS_PROFILE_START": "abc"},
            {"NEXUS_PROFILE_DIR": "/tmp/p", "NEXUS_PROFILE_START": "-3"},
        ):
            assert DeviceProfiler.from_env(bad) is None
            assert jax_tracing.DeviceProfiler.from_env(bad) is None

    def test_rejects_bad_window(self, tmp_path):
        with pytest.raises(ValueError):
            DeviceProfiler("")
        with pytest.raises(ValueError):
            DeviceProfiler(str(tmp_path), num_steps=0)


# -- real captures on the CPU ----------------------------------------------------


def _one_trace(directory):
    traces = sorted(directory.glob("*.json"))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    return traces[0], events


def _profile_env(monkeypatch, directory, start, steps):
    monkeypatch.setenv("NEXUS_PROFILE_DIR", str(directory))
    monkeypatch.setenv("NEXUS_PROFILE_START", str(start))
    monkeypatch.setenv("NEXUS_PROFILE_STEPS", str(steps))


def test_profile_dir_parses_in_training():
    """The knobs are no longer refused at parse: the config parses and the
    same environment arms the harness's profiler."""
    env = {"NEXUS_PROFILE_DIR": "/prof", "NEXUS_PROFILE_START": "3", "NEXUS_DEVICE": "cpu"}
    assert WorkloadConfig.from_env(env).device == "cpu"
    prof = DeviceProfiler.from_env(env)
    assert (prof.profile_dir, prof.start_step, prof.num_steps, prof.state) == ("/prof", 3, 10, "idle")


def test_training_run_writes_one_trace_of_its_window(monkeypatch, tmp_path):
    _profile_env(monkeypatch, tmp_path / "prof", 2, 2)
    real = DeviceProfiler.tick
    ticks = []

    def spy(self, step):
        ticks.append(step)
        return real(self, step)

    monkeypatch.setattr(DeviceProfiler, "tick", spy)
    cfg = WorkloadConfig(model=get_adapter("tiny"), batch_size=2, seq_len=32, steps=6, heartbeat_every=2,
                         device="cpu")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="prof-train", algorithm="train", process_id=0, num_processes=1, coordinator=None)
    summary = run_workload(cfg, store=store, ctx=ctx, lifecycle=LifecycleContext(), telemetry=NullMetrics())
    assert store.read_checkpoint("train", "prof-train").lifecycle_stage == LifecycleStage.COMPLETED
    assert summary["profiler"] == {"dir": str(tmp_path / "prof"), "state": "done", "failures": 0}
    assert ticks == [1, 2, 3, 4, 5]  # the first iteration (kernel build) is never ticked
    _one_trace(tmp_path / "prof")


def test_training_run_closes_a_window_it_ends_inside_of(monkeypatch, tmp_path):
    _profile_env(monkeypatch, tmp_path / "prof", 2, 50)
    cfg = WorkloadConfig(model=get_adapter("tiny"), batch_size=2, seq_len=32, steps=4, heartbeat_every=2,
                         device="cpu")
    summary = run_workload(cfg, store=InMemoryCheckpointStore(),
                           ctx=ProcessContext(run_id="p2", algorithm="train", process_id=0, num_processes=1,
                                              coordinator=None),
                           lifecycle=LifecycleContext(), telemetry=NullMetrics())
    assert summary["profiler"]["state"] == "done" and summary["profiler"]["failures"] == 0
    _one_trace(tmp_path / "prof")


SMALL = dict(batch_size=2, prompt_len=8, gen_tokens=4, rounds=2, heartbeat_every=1)


def test_serve_engine_writes_one_trace_and_reports_the_reference_keys(monkeypatch, tmp_path):
    _profile_env(monkeypatch, tmp_path / "prof", 1, 3)
    cfg = dataclasses.replace(ServeConfig.from_env({"NEXUS_MODEL_PRESET": "tiny", "NEXUS_PAGE_SIZE": "4"}),
                              device="cpu", **SMALL)
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="prof-serve", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    summary = run_serve_engine(cfg, store=store, ctx=ctx)
    assert store.read_checkpoint("serve", "prof-serve").lifecycle_stage == LifecycleStage.COMPLETED
    assert summary["finished"] == 4
    _one_trace(tmp_path / "prof")

    # the JAX engine over the same window, its profiler faked
    fake = FakeProfiler()
    _patched(monkeypatch, None, fake, cls=jax_tracing.DeviceProfiler)
    jctx = JaxProcessContext(run_id="prof-serve", algorithm="serve", process_id=0, num_processes=1,
                             coordinator=None)
    ref = jax_run_serve_engine(dataclasses.replace(JaxServeConfig(page_size=4), **SMALL),
                               store=JaxInMemoryStore(), ctx=jctx)
    assert fake.calls == [("start", str(tmp_path / "prof")), ("stop",)]
    assert summary["profiler"] == ref["profiler"] == {"dir": str(tmp_path / "prof"), "state": "done",
                                                       "failures": 0}


def test_serve_engine_unarmed_reports_no_profiler(monkeypatch):
    monkeypatch.delenv("NEXUS_PROFILE_DIR", raising=False)
    cfg = dataclasses.replace(ServeConfig.from_env({"NEXUS_MODEL_PRESET": "tiny"}), device="cpu", **SMALL)
    summary = run_serve_engine(cfg, store=InMemoryCheckpointStore())
    assert summary["profiler"] is None


def test_a_broken_profiler_never_takes_the_run_down(monkeypatch, tmp_path):
    class Broken:
        def start_trace(self, d):
            raise RuntimeError("no CUPTI")

    _profile_env(monkeypatch, tmp_path / "prof", 0, 2)
    monkeypatch.setattr(DeviceProfiler, "_profiler", lambda self: Broken())
    cfg = dataclasses.replace(ServeConfig.from_env({"NEXUS_MODEL_PRESET": "tiny"}), device="cpu", **SMALL)
    summary = run_serve_engine(cfg, store=InMemoryCheckpointStore())
    assert summary["finished"] == 4
    assert summary["profiler"] == {"dir": str(tmp_path / "prof"), "state": "done", "failures": 1}
