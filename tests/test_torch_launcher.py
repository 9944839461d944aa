"""The port's counterpart of ``tests/test_launcher.py`` (``tpu_nexus_torch``).

Launcher tests: manifest composition contract + launch/cancel flow against
the fake kube client."""

import uuid

import pytest

from tpu_nexus_torch.checkpoint.models import (
    JOB_LABEL_ALGORITHM_RUN,
    JOB_TEMPLATE_NAME_KEY,
    NEXUS_COMPONENT_LABEL,
    LifecycleStage,
)
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.launcher import (
    Launcher,
    LaunchSpec,
    compose_job,
    compose_jobset,
    coordinator_address,
)
from tpu_nexus_torch.parallel.distributed import ENV_COORDINATOR, ENV_NUM_PROCESSES


def spec(**over):
    base = dict(
        run_id=str(uuid.uuid4()),
        algorithm="llama-pretrain",
        image="ghcr.io/x/workload:1",
        command=["python", "-m", "tpu_nexus_torch.workload"],
        num_hosts=4,
        resources={"nvidia.com/gpu": "8"},
        node_selector={"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"},
        namespace="nexus",
    )
    base.update(over)
    return LaunchSpec(**base)


class TestManifests:
    def test_job_carries_supervisor_contract(self):
        s = spec(num_hosts=1)
        job = compose_job(s)
        # name IS the run id; labels are what the supervisor filters on
        assert job["metadata"]["name"] == s.run_id
        labels = job["metadata"]["labels"]
        assert labels[NEXUS_COMPONENT_LABEL] == JOB_LABEL_ALGORITHM_RUN
        assert labels[JOB_TEMPLATE_NAME_KEY] == s.algorithm
        assert job["spec"]["template"]["metadata"]["labels"][NEXUS_COMPONENT_LABEL]
        # OOM/fatal exit codes surface as PodFailurePolicy (FATAL path parity)
        codes = job["spec"]["podFailurePolicy"]["rules"][0]["onExitCodes"]["values"]
        assert codes == [137, 255]

    def test_multi_host_env_contract(self):
        s = spec(num_hosts=4)
        job = compose_job(s)
        env_list = job["spec"]["template"]["spec"]["containers"][0]["env"]
        env = {e["name"]: e.get("value") for e in env_list}
        assert env[ENV_NUM_PROCESSES] == "4"
        assert env[ENV_COORDINATOR] == coordinator_address(s, jobset=False)
        # process id comes from the completion-index annotation via downward
        # API (a $(VAR) reference would never expand — controller env comes
        # after user env)
        pid = next(e for e in env_list if e["name"] == "NEXUS_PROCESS_ID")
        assert "job-completion-index" in pid["valueFrom"]["fieldRef"]["fieldPath"]
        assert job["spec"]["completionMode"] == "Indexed"
        assert job["spec"]["completions"] == 4
        # plain-Job path gets stable pod DNS via subdomain + headless service
        assert job["spec"]["template"]["spec"]["subdomain"] == s.run_id

    def test_user_env_passthrough_carries_mesh_request(self):
        """A launch can request a specific parallelism layout: spec.env
        entries (e.g. the NEXUS_MESH contract run_workload parses) land in
        the container env of both manifest flavors."""
        s = spec(num_hosts=2, env={"NEXUS_MESH": "fsdp=2,sp=2", "NEXUS_MODEL_PRESET": "nexus_1b"})
        for manifest, path in (
            (compose_job(s), lambda m: m["spec"]["template"]),
            (compose_jobset(s), lambda m: m["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]),
        ):
            env = {
                e["name"]: e.get("value")
                for e in path(manifest)["spec"]["containers"][0]["env"]
            }
            assert env["NEXUS_MESH"] == "fsdp=2,sp=2"
            assert env["NEXUS_MODEL_PRESET"] == "nexus_1b"

    def test_jobset_coordinator_dns(self):
        s = spec(num_hosts=4)
        js = compose_jobset(s)
        tmpl = js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]
        env = {e["name"]: e.get("value") for e in tmpl["spec"]["containers"][0]["env"]}
        assert env[ENV_COORDINATOR] == coordinator_address(s, jobset=True)
        assert env[ENV_COORDINATOR].startswith(f"{s.run_id}-workers-0-0.")
        # JobSet manages its own headless service; no subdomain on the pod
        assert "subdomain" not in tmpl["spec"]

    def test_single_host_omits_coordinator(self):
        job = compose_job(spec(num_hosts=1))
        env = {e["name"] for e in job["spec"]["template"]["spec"]["containers"][0]["env"]}
        assert ENV_COORDINATOR not in env

    def test_jobset_topology(self):
        s = spec()
        js = compose_jobset(s)
        assert js["kind"] == "JobSet"
        assert js["metadata"]["name"] == s.run_id
        assert js["spec"]["replicatedJobs"][0]["template"]["spec"]["completions"] == 4
        assert js["spec"]["failurePolicy"]["maxRestarts"] == 3

    def test_gpu_resources_and_selector(self):
        pod = compose_job(spec())["spec"]["template"]["spec"]
        assert pod["containers"][0]["resources"]["limits"]["nvidia.com/gpu"] == "8"
        assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"] == "nvidia-h100-80gb"


class TestLauncher:
    async def test_launch_seeds_ledger_then_creates(self):
        store = InMemoryCheckpointStore()
        kube = FakeKubeClient()
        s = spec(num_hosts=1)
        cp = await Launcher(kube, store).launch(s, payload_uri="s3://payloads/x")
        assert cp.lifecycle_stage == LifecycleStage.BUFFERED
        assert cp.payload_uri == "s3://payloads/x"
        jobs, _ = await kube.list_objects("Job", "nexus")
        assert [j["metadata"]["name"] for j in jobs] == [s.run_id]

    async def test_multi_host_uses_jobset(self):
        store = InMemoryCheckpointStore()
        kube = FakeKubeClient()
        s = spec(num_hosts=4)
        await Launcher(kube, store).launch(s)
        jobsets, _ = await kube.list_objects("JobSet", "nexus")
        assert len(jobsets) == 1

    async def test_multi_host_plain_job_creates_headless_service(self):
        store = InMemoryCheckpointStore()
        kube = FakeKubeClient()
        s = spec(num_hosts=4)
        await Launcher(kube, store, use_jobset=False).launch(s)
        services, _ = await kube.list_objects("Service", "nexus")
        assert [sv["metadata"]["name"] for sv in services] == [s.run_id]
        assert services[0]["spec"]["clusterIP"] == "None"
        jobs, _ = await kube.list_objects("Job", "nexus")
        assert len(jobs) == 1

    async def test_cancel_guards_and_deletes(self):
        store = InMemoryCheckpointStore()
        kube = FakeKubeClient()
        s = spec(num_hosts=1)
        launcher = Launcher(kube, store)
        await launcher.launch(s)
        assert await launcher.cancel(s.algorithm, s.run_id, namespace="nexus")
        cp = store.read_checkpoint(s.algorithm, s.run_id)
        assert cp.lifecycle_stage == LifecycleStage.CANCELLED
        # second cancel is a guarded no-op
        assert not await launcher.cancel(s.algorithm, s.run_id, namespace="nexus")
