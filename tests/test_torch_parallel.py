"""The port's ``parallel/`` package against the JAX package's.

* ``MeshSpec.resolve`` and ``spec_for`` give the same sizes, specs and
  errors as the JAX functions on the same inputs; the serving rule table
  is the reference's.
* Process-group bring-up from the launcher's env contract
  (``NEXUS_COORDINATOR_ADDRESS``, ``NEXUS_PROCESS_ID``,
  ``NEXUS_NUM_PROCESSES``; the training rank plan): two processes that
  import only ``tpu_nexus_torch`` join a gloo world of 2 on the CPU under
  the explicit rehearsal map, sum a tensor and lay a ``DeviceMesh`` with the
  reference's axis names over it; each has a deadline and is killed past
  it.
* The backend rule: ``nccl`` only with one card a rank — two ranks on one
  card are refused, naming the reason — ``gloo`` on the CPU and when ranks
  share a device; the rehearsal map is never chosen without being asked.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_nexus.parallel import mesh as jax_mesh
from tpu_nexus.parallel import sharding as jax_sharding
from tpu_nexus_torch.parallel import distributed, mesh, sharding

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("spec,n", [
    (dict(), 8), (dict(tp=2), 8), (dict(pp=2, tp=2), 8), (dict(fsdp=1, tp=8), 8), (dict(fsdp=1, tp=4), 8),
    (dict(dp=3), 8), (dict(dp=-1), 8), (dict(tp=0), 8), (dict(tp=-2), 8), (dict(ep=2, sp=2, tp=2), 8),
])
def test_mesh_spec_resolve_matches_the_jax_spec(spec, n):
    try:
        want = jax_mesh.MeshSpec(**spec).resolve(n)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            mesh.MeshSpec(**spec).resolve(n)
        assert str(got.value) == str(exc)
        return
    assert mesh.MeshSpec(**spec).resolve(n) == want
    assert mesh.AXIS_ORDER == jax_mesh.AXIS_ORDER


@pytest.mark.parametrize("table", ["LOGICAL_RULES_1D", "LOGICAL_RULES_FSDP_TP", "LOGICAL_RULES_FSDP_TP_PP",
                                   "LOGICAL_RULES_SERVE_TP"])
@pytest.mark.parametrize("axes", [
    ("layers", "embed", "heads", "head_dim"), ("vocab", "embed"), ("batch", "seq"), (None, "mlp"),
    ("layers", "expert", "embed", "mlp"), ("embed", "typo"),
])
def test_spec_for_matches_the_jax_rules(table, axes):
    ours, ref = getattr(sharding, table), getattr(jax_sharding, table)
    assert ours == ref
    try:
        want = tuple(jax_sharding.spec_for(axes, ref))
    except KeyError as exc:
        with pytest.raises(KeyError) as got:
            sharding.spec_for(axes, ours)
        assert str(got.value) == str(exc)
        return
    assert sharding.spec_for(axes, ours) == want + (None,) * (len(axes) - len(want))


def test_shard_leaf_cuts_a_rank_slice():
    x = torch.arange(2 * 8 * 6).reshape(2, 8, 6)
    sizes, spec = {"tp": 4, "ep": 2}, (None, ("ep", "tp"), None)
    got = sharding.shard_leaf(x, (None, "tp", None), {"tp": 3}, sizes)
    assert torch.equal(got, x[:, 6:8])
    # two axes on one dim: major-first (ep outer, tp inner)
    with pytest.raises(ValueError, match="not divisible by 8"):
        sharding.shard_leaf(x[:, :6], spec, {"tp": 1, "ep": 1}, sizes)
    assert torch.equal(sharding.shard_leaf(torch.arange(16)[None], (None, ("ep", "tp")), {"ep": 1, "tp": 2}, sizes),
                       torch.tensor([[12, 13]]))


_RANK = """
import json, sys, torch, torch.distributed as dist
assert "jax" not in sys.modules
from tpu_nexus_torch.parallel.distributed import process_context_from_env, start_process_group, training_ranks
from tpu_nexus_torch.parallel.mesh import MeshSpec, build_mesh
ctx = process_context_from_env()
plan = training_ranks(ctx, (1, 1, -1, 1, 1, 1), "cpu", "shared")
assert (plan.local, plan.world, plan.backend) == (1, 2, "gloo"), plan
start_process_group(plan.init_method, plan.global_rank(ctx, 0), plan.world, plan.backend, 20.0)
t = torch.tensor([float(ctx.process_id + 1)])
dist.all_reduce(t)
dm = build_mesh(MeshSpec(fsdp=1, tp=2), device_type="cpu")
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(), "sum": t.item(),
                  "backend": dist.get_backend(), "names": list(dm.mesh_dim_names),
                  "tp_size": dm["tp"].size(), "jax": "jax" in sys.modules or "tpu_nexus" in sys.modules}))
dist.destroy_process_group()
"""


def test_process_group_from_the_launcher_env(tmp_path):
    port = distributed.free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith("NEXUS")}
        env.update(NEXUS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NEXUS_PROCESS_ID=str(rank),
                   NEXUS_NUM_PROCESSES="2", NEXUS_DEVICE="cpu", NEXUS_RANK_DEVICE_MAP="shared",
                   NEXUS_DIST_TIMEOUT_S="20", PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK], env=env, cwd=str(tmp_path),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert sorted(o["rank"] for o in outs) == [0, 1]
    for o in outs:
        assert (o["world"], o["sum"], o["backend"], o["tp_size"], o["jax"]) == (2, 3.0, "gloo", 2, False)
        assert o["names"] == list(mesh.AXIS_ORDER)


def test_bring_up_refuses_what_it_cannot_meet():
    ctx = distributed.process_context_from_env({"NEXUS_NUM_PROCESSES": "2", "NEXUS_PROCESS_ID": "1"})
    with pytest.raises(ValueError, match="NEXUS_COORDINATOR_ADDRESS is unset"):
        distributed.training_ranks(ctx, (1, 1, 2, 1, 1, 1), "cpu", "shared")
    ctx = distributed.ProcessContext("r", "a", 0, 2, "127.0.0.1:1")
    with pytest.raises(ValueError, match="rehearsal map must be asked for"):
        distributed.training_ranks(ctx, (1, 1, -1, 1, 1, 1), "cpu")
    with pytest.raises(ValueError, match="does not split over 2 processes"):
        distributed.training_ranks(ctx, (1, 1, 3, 1, 1, 1), "cpu", "shared")
    with pytest.raises(ValueError, match="unknown NEXUS_RANK_DEVICE_MAP"):
        distributed.training_ranks(ctx, (1, 1, 2, 1, 1, 1), "cpu", "all")
    single = distributed.ProcessContext("r", "a", 0, 1, None)
    plan = distributed.training_ranks(single, (1, 1, -1, 1, 1, 1), "cpu")
    assert (plan.local, plan.world, plan.init_method) == (1, 1, "")
    # the rehearsal map: mesh size / processes ranks a process, -1 one a process
    plan = distributed.training_ranks(ctx, (1, 2, 2, 1, 1, 1), "cpu", "shared")
    assert (plan.local, plan.world, plan.devices, plan.global_rank(ctx, 1)) == (2, 4, (torch.device("cpu"),) * 2, 1)
    assert distributed.training_ranks(ctx, (1, 1, -1, 1, 1, 1), "cpu", "shared").local == 1


@pytest.mark.parametrize("entry", ["training", "lockstep serving", "serve-engine", "serve-engine meshed"])
def test_a_multi_process_run_raises_at_start(entry):
    """What a world of two launched processes (a multi-host JobSet) cannot
    run yet is refused before any device work or ledger write, naming
    ROADMAP A6b-ii: serving in every mode (it never runs as two
    unsynchronised copies), and training with pipeline parallelism (a
    training mesh across processes runs: tests/test_torch_multiprocess.py)."""
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.parallel.mesh import MeshSpec
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine, run_serving

    ctx = distributed.process_context_from_env({
        "NEXUS_NUM_PROCESSES": "2", "NEXUS_PROCESS_ID": "0", "NEXUS_COORDINATOR_ADDRESS": "127.0.0.1:1",
        "NEXUS_RUN_ID": "multi", "NEXUS_ALGORITHM": "a",
    })
    store = InMemoryCheckpointStore()
    runs = {
        "training": lambda: run_workload(WorkloadConfig(device="cpu", mesh=MeshSpec(pp=2, fsdp=-1)), store=store,
                                         ctx=ctx, lifecycle=LifecycleContext()),
        "lockstep serving": lambda: run_serving(ServeConfig(device="cpu"), store=store, ctx=ctx),
        "serve-engine": lambda: run_serve_engine(ServeConfig(device="cpu"), store=store, ctx=ctx,
                                                 lifecycle=LifecycleContext()),
        "serve-engine meshed": lambda: run_serve_engine(
            ServeConfig(device="cpu", serve_mesh="tp=2", rank_map="shared"), store=store, ctx=ctx,
            lifecycle=LifecycleContext()),
    }
    want = r"pp=2, .* \(ROADMAP.md: A6b-ii\)" if entry == "training" else r"NEXUS_NUM_PROCESSES=2: .* \(ROADMAP.md: A6b-ii\)"
    with pytest.raises(NotImplementedError, match=want):
        runs[entry]()
    assert store.read_checkpoint("a", "multi") is None
    assert distributed.single_process(distributed.ProcessContext("r", "a", 0, 1, None), "x").num_processes == 1


def test_backend_rule():
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert distributed.backend_for([cpu, cpu]) == "gloo"
    assert distributed.backend_for([c0, c0]) == "gloo"
    assert distributed.backend_for([c0, c1]) == "nccl"
    distributed.check_backend("nccl", [c0, c1])
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one card: ranks 0 and 1 are both on cuda:0"):
        distributed.check_backend("nccl", [c0, c0])
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        distributed.check_backend("nccl", [cpu, c1])
    with pytest.raises(ValueError, match="unknown backend"):
        distributed.check_backend("mpi", [cpu])


def test_rank_devices_map_is_explicit():
    assert distributed.rank_devices(3, "cpu", "shared") == [torch.device("cpu")] * 3
    assert distributed.rank_devices(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="rehearsal map must be asked for"):
        distributed.rank_devices(2, "cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="want one card each"):
            distributed.rank_devices(2, "cuda")
    with pytest.raises(ValueError, match="unknown rank map"):
        distributed.rank_devices(2, "cpu", "all")
    with pytest.raises(ValueError, match="must be > 0"):
        distributed.timeout_from_env({"NEXUS_DIST_TIMEOUT_S": "0"})


def test_mesh_coords_are_row_major_tp_fastest():
    assert [mesh.mesh_coords(i, (2, 2)) for i in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_shard_tree_cuts_every_leaf_of_a_host_tree():
    """The counterpart of the reference's ``shard_pytree``: a nested dict of
    numpy and torch leaves, each cut to the rank's part under its spec."""
    import numpy as np

    tree = {"a": np.arange(24).reshape(4, 6), "b": {"c": torch.arange(8)}}
    specs = {"a": ("ep", "tp"), "b": {"c": (None,)}}
    got = sharding.shard_tree(tree, specs, {"ep": 1, "tp": 2}, {"ep": 2, "tp": 3})
    np.testing.assert_array_equal(got["a"], tree["a"][2:4, 4:6])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
