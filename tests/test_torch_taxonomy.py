"""Parity of the port's control plane with the JAX package's, on the CPU.

Table-driven over the reference tests' own fixtures (``tests/
test_supervisor.py``'s Event/Pod/Job/JobSet builders, the JobSet children
that ``tests/test_jobset_children.py`` materializes through the launcher,
the wordings of ``tests/test_trace_capture.py`` and the fault modes):

* ``classify_event`` gives equal ``RunStatusAnalysisResult``s in both
  packages, with both packages' real informers synced over fakes seeded
  with the same objects;
* ``classify_tpu_failure`` agrees on every reference wording;
* ``compose_job``/``compose_jobset``/``compose_headless_service`` give equal
  manifests for the same ``LaunchSpec``;
* ``load_config(SupervisorConfig)`` gives equal configs for the same
  ``appconfig.yaml``, overlay and env.

Then the card's wordings: each maps as the port's taxonomy states (memory,
interconnect, compile), through the event classifier too, and Xid, ECC and
illegal-address errors reach the generic fatal verdict.
"""

import copy
import dataclasses
import uuid
from datetime import timedelta

import pytest

from tpu_nexus.app.config import SupervisorConfig as JaxSupervisorConfig
from tpu_nexus.core.config import load_config as jax_load_config
from tpu_nexus.core.signals import LifecycleContext as JaxLifecycleContext
from tpu_nexus.k8s.fake import FakeKubeClient as JaxFakeKubeClient
from tpu_nexus.k8s.informer import SharedInformerFactory as JaxInformerFactory
from tpu_nexus.k8s.objects import EventObj as JaxEventObj
from tpu_nexus.launcher import jobset as jax_jobset
from tpu_nexus.launcher.client import Launcher as JaxLauncher
from tpu_nexus.checkpoint.store import InMemoryCheckpointStore as JaxInMemoryStore
from tpu_nexus.supervisor import taxonomy as jax_taxonomy
from tpu_nexus.workload import faults as jax_faults
from tpu_nexus_torch.app.config import SupervisorConfig
from tpu_nexus_torch.core.config import load_config
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.k8s.informer import SharedInformerFactory
from tpu_nexus_torch.k8s.objects import EventObj
from tpu_nexus_torch.launcher import jobset as port_jobset
from tpu_nexus_torch.supervisor import taxonomy
from tpu_nexus_torch.supervisor.taxonomy import DecisionAction

from test_supervisor import NS, event_obj, job_obj, jobset_obj, pod_obj

KINDS = ("Event", "Pod", "Job", "JobSet")


def _terminated(reason, message, exit_code):
    return [{"name": "algorithm", "state": {"terminated": {
        "reason": reason, "message": message, "exitCode": exit_code}}}]


def _waiting(reason):
    return [{"name": "algorithm", "state": {"waiting": {"reason": reason}}}]


CUDA_OOM = ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 96.00 GiB. GPU 0 has a total "
            "capacity of 79.19 GiB of which 62.81 GiB is free. [hlo_trace: file:///tmp/hlo_trace_r_host0_step0.hlo]")
NCCL = "torch.distributed.DistBackendError: NCCL error in: ProcessGroupNCCL.cpp:1970, unhandled system error"
XID = "NVRM: Xid (PCI:0000:3b:00): 79, pid=4242, name=python, GPU has fallen off the bus."
ECC = "RuntimeError: CUDA error: uncorrectable ECC error encountered"
ILLEGAL = "RuntimeError: CUDA error: an illegal memory access was encountered"
PFP_137 = "Container algorithm for pod nexus/{rid}-0 failed with exit code 137 matching FailJob rule at index 0"


def _case(kind, reason, message="boom", statuses=None, conditions=None, target=None, pod_labels=True):
    """One fixture: a run's Job, Pod and JobSet (the reference tests'
    builders) plus one event on ``kind``."""
    rid = str(uuid.uuid4())
    pod = pod_obj(rid, container_statuses=statuses)
    if not pod_labels:
        pod["metadata"]["labels"] = {k: v for k, v in pod["metadata"]["labels"].items()
                                     if k != "batch.kubernetes.io/job-name"}
    objects = {"Job": [job_obj(rid)], "Pod": [pod], "JobSet": [jobset_obj(rid, conditions)]}
    name = target or {"Job": rid, "JobSet": rid, "Pod": pod["metadata"]["name"]}[kind]
    event = event_obj(reason, message.format(rid=rid), kind, name)
    objects["Event"] = [event]
    return objects, event


def _reference_cases():
    cases = {}
    for reason in ("FailedCreate", "DeadlineExceeded", "BackoffLimitExceeded", "SuccessfulCreate"):
        cases[f"job-{reason}"] = _case("Job", reason)
    for label, msg in (("137", PFP_137), ("hbm", jax_faults.MSG_HBM_OOM), ("ici", jax_faults.MSG_ICI),
                       ("xla", jax_faults.MSG_XLA_ABORT), ("hlo-ref",
                       "XLA compilation failed; HLO dumped to gs://nexus-traces/run-42/module_0001.hlo")):
        cases[f"job-PodFailurePolicy-{label}"] = _case("Job", "PodFailurePolicy", msg)
    cases["pod-Started"] = _case("Pod", "Started", "Started container algorithm")
    cases["pod-Failed-bare"] = _case("Pod", "Failed")
    cases["pod-Failed-oomkilled"] = _case("Pod", "Failed", statuses=_terminated("OOMKilled", "", 137))
    cases["pod-Failed-xla"] = _case("Pod", "Failed", "Error", statuses=_terminated(
        "Error", "jaxlib.xla_extension.XlaRuntimeError: INVALID_ARGUMENT: XLA compilation failed: HLO module "
        "has mismatched shapes", 1))
    cases["pod-Failed-hbm"] = _case("Pod", "Failed", "Error", statuses=_terminated(
        "Error", jax_faults.MSG_HBM_OOM + " [hlo_trace: file:///tmp/t/hlo_trace_r_host0_step3.hlo]", 1))
    cases["pod-BackOff"] = _case("Pod", "BackOff", "Back-off restarting failed container",
                                 statuses=_waiting("CrashLoopBackOff"))
    cases["pod-BackOff-ici"] = _case("Pod", "BackOff", jax_faults.MSG_ICI)
    for reason in ("TPUPreempted", "Preempted", "Evicted"):
        cases[f"pod-{reason}"] = _case("Pod", reason, "TPU node was preempted by Cloud provider")
    cases["pod-Pulled"] = _case("Pod", "Pulled", "Successfully pulled image")
    cases["pod-no-job-name"] = _case("Pod", "BackOff", pod_labels=False)
    cases["pod-stale"] = _case("Pod", "Failed", target="gone-pod-0")
    cases["job-stale"] = _case("Job", "FailedCreate", target="gone-job")
    for reason in ("FailedCreate", "SuspendedJobs", "DeadlineExceeded", "FailedJobs", "Started", "Unknown"):
        cases[f"jobset-{reason}"] = _case("JobSet", reason, "")
    cases["jobset-ici-condition"] = _case("JobSet", "FailedJobs", "", conditions=[
        {"type": "Failed", "status": "True", "message": "worker-2 terminated: ICI link down on chip 5, "
                                                         "interconnect failure detected"}])
    return cases


def _card_cases():
    return {
        "job-PodFailurePolicy-cuda-oom": _case("Job", "PodFailurePolicy", CUDA_OOM),
        "pod-Failed-cuda-oom": _case("Pod", "Failed", "Error", statuses=_terminated("Error", CUDA_OOM, 1)),
        "pod-BackOff-nccl": _case("Pod", "BackOff", NCCL),
        "jobset-nccl-condition": _case("JobSet", "FailedJobs", "", conditions=[
            {"type": "Failed", "status": "True", "message": NCCL}]),
        "job-PodFailurePolicy-xid": _case("Job", "PodFailurePolicy", XID),
        "pod-BackOff-ecc": _case("Pod", "BackOff", "Error", statuses=_terminated("Error", ECC, 1)),
        "job-PodFailurePolicy-illegal": _case("Job", "PodFailurePolicy", ILLEGAL),
    }


def _jobset_children_cases():
    """The children ``tests/test_jobset_children.py`` drives: a JobSet
    launched through the JAX launcher against the controller-playing fake,
    its child Job and pods listed back as plain objects."""
    import asyncio
    import threading

    async def materialize():
        client = JaxFakeKubeClient({}, jobset_controller=True)
        rid = str(uuid.uuid4())
        await JaxLauncher(client, JaxInMemoryStore(), use_jobset=True).launch(jax_jobset.LaunchSpec(
            run_id=rid, algorithm="llama-multihost", image="tpu-nexus-workload:test", num_hosts=2, namespace=NS))
        objects = {k: (await client.list_objects(k, NS))[0] for k in ("Pod", "Job", "JobSet")}
        return rid, objects

    # the tests that call this run inside an event loop: materialize on a
    # loop of its own, in a thread
    out = {}
    worker = threading.Thread(target=lambda: out.update(result=asyncio.run(materialize())))
    worker.start()
    worker.join(timeout=30)
    rid, objects = out["result"]
    cases = {}
    for label, (kind, name, reason, msg) in {
        "child-pod-preempted": ("Pod", f"{rid}-workers-0-1", "TPUPreempted", "TPU node was preempted"),
        "child-pod-started": ("Pod", f"{rid}-workers-0-0", "Started", "Started container algorithm"),
        "child-pod-backoff": ("Pod", f"{rid}-workers-0-0", "BackOff", "Back-off restarting failed container"),
        "child-job-backoff-limit": ("Job", f"{rid}-workers-0", "BackoffLimitExceeded", "Job has reached the "
                                                                                       "specified backoff limit"),
        "child-job-pfp-137": ("Job", f"{rid}-workers-0", "PodFailurePolicy", PFP_137.format(rid=rid)),
        # the card's wording (not a parity case: the port's own addition)
        "child-job-pfp-cuda-oom": ("Job", f"{rid}-workers-0", "PodFailurePolicy", CUDA_OOM),
    }.items():
        event = event_obj(reason, msg, kind, name)
        cases[label] = (dict(objects, Event=[event]), event)
    return cases


async def _classify(pkg, objects, event):
    """``classify_event`` of ``pkg`` over its real informers, synced from a
    fake seeded with ``objects``."""
    if pkg == "jax":
        fake, factory_cls, ctx, event_cls, classify = (JaxFakeKubeClient, JaxInformerFactory, JaxLifecycleContext(),
                                                       JaxEventObj, jax_taxonomy.classify_event)
    else:
        fake, factory_cls, ctx, event_cls, classify = (FakeKubeClient, SharedInformerFactory, LifecycleContext(),
                                                       EventObj, taxonomy.classify_event)
    factory = factory_cls(fake(copy.deepcopy(objects)), NS, resync_period=timedelta(0))
    for kind in KINDS:
        factory.informer_for(kind)
    factory.start(ctx)
    try:
        assert await factory.wait_for_cache_sync(timeout=10)
        return classify(event_cls.from_api(copy.deepcopy(event)), NS, factory.informers, detected_at=1.5)
    finally:
        ctx.cancel()
        await factory.shutdown()


def _fields(result):
    return None if result is None else dataclasses.asdict(result)


REFERENCE_LABELS = sorted(_reference_cases())
CHILD_LABELS = ["child-job-backoff-limit", "child-job-pfp-137", "child-pod-backoff", "child-pod-preempted",
                "child-pod-started"]


@pytest.mark.parametrize("label", REFERENCE_LABELS + CHILD_LABELS)
async def test_classify_event_matches_the_reference(label):
    objects, event = (_reference_cases() if label in REFERENCE_LABELS else _jobset_children_cases())[label]
    want = _fields(await _classify("jax", objects, event))
    got = _fields(await _classify("port", objects, event))
    assert got == want


#: what the port decides on the card's wordings (the JAX package has no
#: signature for them: the CUDA OOM and NCCL cases are the port's additions)
CARD_WANT = {
    "job-PodFailurePolicy-cuda-oom": (DecisionAction.TO_FAIL_HBM_OOM, "file:///tmp/hlo_trace_r_host0_step0.hlo"),
    "pod-Failed-cuda-oom": (DecisionAction.TO_FAIL_HBM_OOM, "file:///tmp/hlo_trace_r_host0_step0.hlo"),
    "pod-BackOff-nccl": (DecisionAction.TO_FAIL_ICI_LINK_DOWN, ""),
    "jobset-nccl-condition": (DecisionAction.TO_FAIL_ICI_LINK_DOWN, ""),
    "job-PodFailurePolicy-xid": (DecisionAction.TO_FAIL_FATAL_ERROR, ""),
    "pod-BackOff-ecc": (DecisionAction.TO_FAIL_FATAL_ERROR, ""),
    "job-PodFailurePolicy-illegal": (DecisionAction.TO_FAIL_FATAL_ERROR, ""),
}


@pytest.mark.parametrize("label", sorted(CARD_WANT))
async def test_classify_event_on_the_cards_wordings(label):
    objects, event = _card_cases()[label]
    got = await _classify("port", objects, event)
    want_action, want_ref = CARD_WANT[label]
    assert (got.action, got.hlo_trace_ref) == (want_action, want_ref)
    assert got.run_status_message == taxonomy.ACTION_MESSAGES[want_action] or got.action == (
        DecisionAction.TO_FAIL_FATAL_ERROR)
    if want_action == DecisionAction.TO_FAIL_FATAL_ERROR:
        # an unknown error in the reference takes the same generic verdict
        ref = await _classify("jax", objects, event)
        assert _fields(got) == _fields(ref)


async def test_child_job_pod_failure_policy_with_cuda_oom_names_the_owning_run():
    objects, event = _jobset_children_cases()["child-job-pfp-cuda-oom"]
    got = await _classify("port", objects, event)
    assert got.request_id == objects["JobSet"][0]["metadata"]["name"]
    assert got.action == DecisionAction.TO_FAIL_HBM_OOM


# -- classify_tpu_failure on every reference wording ---------------------------

def _reference_wordings():
    texts = [v for k, v in vars(jax_taxonomy).items() if k.startswith("MSG_") and isinstance(v, str)]
    texts += [v for k, v in vars(jax_faults).items() if k.startswith("MSG_") and isinstance(v, str)]
    texts += [
        "node shutdown: spot reclaim", "ICI link down on chip 3", "RESOURCE_EXHAUSTED: HBM OOM while allocating",
        "XLA compilation error: Mosaic lowering failed",
        "numeric health sentinel: non-finite loss/grad_norm at step 5 (loss=nan)",
        "numeric health sentinel: loss spike at step 7; skip budget exhausted",
        "step-hang: step 5 exceeded its 2s step deadline", "container exited 1: assertion failed", "",
        "jaxlib.xla_extension.XlaRuntimeError: INVALID_ARGUMENT: XLA compilation failed: HLO module has "
        "mismatched shapes",
        "worker-2 terminated: ICI link down on chip 5, interconnect failure detected",
        "TPU node was preempted by Cloud provider", PFP_137.format(rid="r"),
        "kv handoff payload crc mismatch on block 3", "replica dc-1 died mid-kv-handoff",
        "kv handoff retry budget spent after 3 hops",
    ]
    return texts


@pytest.mark.parametrize("text", _reference_wordings())
def test_classify_tpu_failure_agrees_on_reference_wordings(text):
    assert taxonomy.classify_tpu_failure(text) == jax_taxonomy.classify_tpu_failure(text)
    assert taxonomy.extract_hlo_trace_ref(text) == jax_taxonomy.extract_hlo_trace_ref(text)


def test_decision_tables_are_the_references():
    for name in ("DECISION_STAGE", "DELETES_JOB", "NON_DELETING_ACTIONS", "ACTION_MESSAGES",
                 "SERVING_POD_RECOVERY", "STEP_RETRYABLE_ACTIONS"):
        assert getattr(taxonomy, name) == getattr(jax_taxonomy, name), name
    assert {k: v for k, v in vars(taxonomy.DecisionAction).items() if k.isupper()} == {
        k: v for k, v in vars(jax_taxonomy.DecisionAction).items() if k.isupper()}


# -- manifests -------------------------------------------------------------------

SPECS = {
    "single-host": dict(run_id="r-1", algorithm="llama-pretrain", image="img:1"),
    "single-host-gpu": dict(run_id="r-2", algorithm="serve", image="img:2", command=["python", "-m",
                            "tpu_nexus_torch.workload"], resources={"nvidia.com/gpu": "1"},
                            node_selector={"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"},
                            env={"NEXUS_MODE": "serve-engine", "NEXUS_BATCH": "8"}, deadline_seconds=600,
                            backoff_limit=2, namespace="nexus"),
    "multi-host": dict(run_id="r-3", algorithm="llama-multihost", image="img:3", num_hosts=4, namespace="nexus",
                       resources={"nvidia.com/gpu": "8"}, max_restarts=5, env={"NEXUS_STEPS": "100"}),
}


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("compose", ["job", "job-under-jobset", "jobset", "headless-service", "env", "labels"])
def test_composed_manifests_match_the_reference(name, compose):
    spec, ref_spec = port_jobset.LaunchSpec(**SPECS[name]), jax_jobset.LaunchSpec(**SPECS[name])
    fns = {
        "job": lambda m, s: m.compose_job(s),
        "job-under-jobset": lambda m, s: m.compose_job(s, jobset=True),
        "jobset": lambda m, s: m.compose_jobset(s),
        "headless-service": lambda m, s: m.compose_headless_service(s),
        "env": lambda m, s: (m.workload_env(s), m.workload_env(s, jobset=False), m.coordinator_address(s)),
        "labels": lambda m, s: m.run_labels(s),
    }
    assert fns[compose](port_jobset, spec) == fns[compose](jax_jobset, ref_spec)


# -- config ------------------------------------------------------------------------

APPCONFIG = """
scylla-cql-store:
  hosts: ["10.0.0.1", "10.0.0.2"]
  port: 9142
cql-store-type: scylla
resource-namespace: nexus
workers: 3
failure-rate-base-delay: 250ms
rate-limit-elements-per-second: 12.5
watch-jobsets: false
heartbeat-stale-after: 5m
preempted-restart-deadline: 1h30m
"""
OVERLAY = """
cql-store-type: sqlite
sqlite-store-path: /data/ledger.db
log-level: debug
watchdog-interval: 10s
"""


@pytest.mark.parametrize(
    "files,env",
    [
        ({}, {}),
        ({"appconfig.yaml": APPCONFIG}, {}),
        ({"appconfig.yaml": APPCONFIG, "appconfig.units.yaml": OVERLAY}, {"APPLICATION_ENVIRONMENT": "units"}),
        ({"appconfig.yaml": APPCONFIG, "appconfig.units.yaml": OVERLAY},
         {"APPLICATION_ENVIRONMENT": "units", "NEXUS__CQL_STORE_TYPE": "memory", "NEXUS__WORKERS": "7",
          "NEXUS__SCYLLA_CQL_STORE__HOSTS": "a,b,c", "NEXUS__FAILURE_LANE_RATE_PER_SECOND": "2.5",
          "NEXUS__WATCHDOG_VERIFY_CHECKPOINTS": "false", "OTHER": "x"}),
        ("repo", {"APPLICATION_ENVIRONMENT": "local"}),
    ],
    ids=["defaults", "file", "overlay", "overlay+env", "repo-local"],
)
def test_load_config_matches_the_reference(tmp_path, files, env):
    if files == "repo":
        from pathlib import Path

        config_dir = str(Path(__file__).resolve().parents[1])
    else:
        for name, text in files.items():
            (tmp_path / name).write_text(text)
        config_dir = str(tmp_path)
    got = load_config(SupervisorConfig, config_dir=config_dir, environ=env)
    want = jax_load_config(JaxSupervisorConfig, config_dir=config_dir, environ=env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
