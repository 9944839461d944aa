"""Multi-rank rehearsal: the port of ``tpu_nexus/workload/rehearsal.py``,
and a world of spawned ranks that runs the parallel train step on one
device.

Run N containers of the rehearsal with the launcher's env contract
pointing at one coordinator::

    NEXUS_DEVICE=cpu NEXUS_RANK_DEVICE_MAP=shared NEXUS_MESH=fsdp=4 \
    NEXUS_COORDINATOR_ADDRESS=127.0.0.1:<port> NEXUS_NUM_PROCESSES=2 \
    NEXUS_PROCESS_ID=<i> NEXUS_RUN_ID=<id> NEXUS_ALGORITHM=<algo> \
    NEXUS_REHEARSAL_DB=<sqlite path> python -m tpu_nexus_torch.workload.rehearsal

Each process runs its local ranks (``workload/harness.py``), heartbeats
their ``host<i>/chip<j>`` keys into the shared sqlite ledger and prints
one ``REHEARSAL_RESULT {"final_step", "loss"}`` line — the reference's
contract minus the cards.

:class:`RankWorld` is the other half: ``world`` spawned ranks in one gloo
group (the caller is not one of them) that run jobs — functions of this
package named ``"module:function"`` — on every rank and hand back each
rank's result.  The tests and ``chip_smoke.py`` run the parallel train
step at several meshes through :func:`train_steps` on it, one world for
all of them.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def main() -> int:
    from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    db = os.environ.get("NEXUS_REHEARSAL_DB", "")
    store = SqliteCheckpointStore(db) if db else None
    try:
        # identical env-contract parsing to the production container entrypoint
        result = run_workload(WorkloadConfig.from_env(), store=store)
    finally:
        if store is not None:
            store.close()
    print("REHEARSAL_RESULT " + json.dumps({k: result[k] for k in ("final_step", "loss")}), flush=True)
    return 0


# -- a world of spawned ranks ---------------------------------------------------


class RankWorld:
    """``world`` ranks started with the ``spawn`` context, joined in one
    gloo group on ``device`` (every rank on it: the rehearsal map).
    :meth:`run` sends one job to every rank and returns their results in
    rank order; a job that raises on any rank raises here with each
    failing rank's text.  :meth:`close` stops them (killing any that
    outlive ``join_timeout_s``)."""

    def __init__(self, world: int, device: str = "cpu", timeout_s: float = 120.0,
                 join_timeout_s: float = 30.0) -> None:
        import torch.multiprocessing as mp

        from tpu_nexus_torch.parallel.distributed import reserved_port

        ctx = mp.get_context("spawn")
        self.world, self.timeout_s, self.join_timeout_s = world, timeout_s, join_timeout_s
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(world)]
        # rank 0 serves the rendezvous once it has started: its port is held
        # for the world's life, so no other socket of the host takes it first
        self._port = contextlib.ExitStack()
        init = f"tcp://127.0.0.1:{self._port.enter_context(reserved_port())}"
        self.procs = [
            ctx.Process(target=_rank_main, args=(r, world, init, device, timeout_s, self._jobs[r], self._results,
                                                 logger.getEffectiveLevel()), daemon=True)
            for r in range(world)
        ]
        for p in self.procs:
            p.start()
        self._closed = False

    def run(self, job: str, **kwargs: Any) -> List[Any]:
        """``job`` (``"module:function"`` in this package) called as
        ``fn(**kwargs)`` on every rank."""
        import queue

        for q in self._jobs:
            q.put((job, kwargs))
        got: Dict[int, Any] = {}
        errors = []
        deadline = time.monotonic() + self.timeout_s
        while len(got) + len(errors) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"job {job}: no answer (dead ranks {dead}, {self.timeout_s}s allowed)") from None
                continue
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank}: {value}")
        if errors:
            raise RuntimeError(f"job {job} failed:\n" + "\n".join(sorted(errors)))
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for q in self._jobs:
            q.put(None)
        for p in self.procs:
            p.join(self.join_timeout_s)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        self._port.close()

    def __enter__(self) -> "RankWorld":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _rank_main(rank, world, init_method, device, timeout_s, jobs, results, log_level) -> None:
    """A rank of a :class:`RankWorld`: join the group, run jobs until None."""
    import traceback

    import torch
    import torch.distributed as dist

    from tpu_nexus_torch.parallel.distributed import start_process_group

    logging.basicConfig(level=log_level, stream=sys.stderr)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # ranks sharing the host's cores: a share each
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    start_process_group(init_method, rank, world, "gloo", timeout_s)
    while True:
        msg = jobs.get()
        if msg is None:
            break
        name, kwargs = msg
        module, fn = name.split(":")
        try:
            if not module.startswith("tpu_nexus_torch."):
                raise ValueError(f"job {name!r} is not a function of tpu_nexus_torch")
            value = getattr(importlib.import_module(module), fn)(**kwargs)
            results.put((rank, True, value))
        except Exception:  # noqa: BLE001 - the caller gets every rank's failure text
            results.put((rank, False, traceback.format_exc()[-4000:]))
    dist.destroy_process_group()


# -- jobs -----------------------------------------------------------------------


def train_steps(
    spec: Dict[str, int],
    model: Any,
    train_cfg: Any,
    batches: List[Any],
    params: Optional[Dict[str, Any]] = None,
    opt_state: Optional[tuple] = None,
    seed: int = 0,
    device: str = "cpu",
    stage: Optional[List[str]] = None,
    reference: str = "",
    force_ep: bool = False,
) -> Optional[Dict[str, Any]]:
    """Train ``len(batches)`` steps of ``model`` on the mesh ``spec`` (over
    the first ranks of the world; the others only help build its groups)
    from ``params`` (the JAX package's tree, numpy) and ``opt_state``
    (``(count, [moments of each parameter])``, ``models/convert.py::
    opt_state_from_numpy``) or, without them, the init of ``seed``.  Each
    batch is the GLOBAL batch (a ``[B, S]`` token array, or MNIST's dict);
    a rank trains on its rows (``train.batch_rows``: under ``pp`` its share
    of every microbatch).  ``spec`` may name any axis, ``pp`` and ``ep``
    included; ``force_ep`` sets ``NEXUS_MOE_FORCE_EP_PATH`` for the call.
    Returns, on the mesh's first rank, the losses and grad norms and every
    parameter gathered whole (f32 numpy, by path); None elsewhere.  With
    ``reference="keep"`` the first rank keeps Adam's first moments after
    the first step ((1 - b1) x the clipped gradient; the parameters for the
    other optimizers) in this process instead of returning them, and with
    ``reference="compare"`` it returns, per path, the max-abs difference
    from the kept ones and their max-abs (the whole trees never cross a
    pipe)."""
    with _force_ep_path(force_ep):
        return _train_steps(spec, model, train_cfg, batches, params, opt_state, seed, device, stage, reference)


@contextlib.contextmanager
def _force_ep_path(force: bool):
    """``NEXUS_MOE_FORCE_EP_PATH`` set to ``force`` within the block."""
    prior = os.environ.get("NEXUS_MOE_FORCE_EP_PATH")
    os.environ["NEXUS_MOE_FORCE_EP_PATH"] = "1" if force else "0"
    try:
        yield
    finally:
        if prior is None:
            os.environ.pop("NEXUS_MOE_FORCE_EP_PATH")
        else:
            os.environ["NEXUS_MOE_FORCE_EP_PATH"] = prior


def _train_steps(spec, model, train_cfg, batches, params, opt_state, seed, device, stage, reference):
    import math

    import torch

    from tpu_nexus_torch.models.convert import opt_state_from_numpy, train_params_from_numpy
    from tpu_nexus_torch.models.registry import adapter_for
    from tpu_nexus_torch.parallel import collectives
    from tpu_nexus_torch.parallel.mesh import MeshSpec, TrainMesh
    from tpu_nexus_torch.workload.health import health_init
    from tpu_nexus_torch.workload.train import (
        batch_rows,
        init_train_state,
        make_optimizer,
        make_train_step,
        param_leaves,
        take_rows,
        train_layout,
    )

    if stage is not None:
        collectives.stage_through_host(stage)
    full = {**dict(pp=1, dp=1, fsdp=1, ep=1, sp=1, tp=1), **spec}
    mesh = TrainMesh(MeshSpec(**full), ranks=range(math.prod(full.values())))
    if not mesh.is_member:
        return None
    dev = torch.device(device)
    layout = train_layout(model, mesh) if mesh.world > 1 else None
    if params is None:
        state = init_train_state(torch.Generator(device=dev).manual_seed(seed), model, train_cfg, dev, mesh=mesh)
    else:
        p = train_params_from_numpy(params, layout, dev)
        named = param_leaves(p)
        specs = [layout.param_spec(n) for n, _ in named] if layout else None
        if opt_state is None:
            opt = make_optimizer(train_cfg, layout, specs).init([t for _, t in named])
        else:
            opt = opt_state_from_numpy(opt_state[0], opt_state[1], [n for n, _ in named], layout, dev)
        state = {"params": p, "opt_state": opt, "step": torch.zeros((), dtype=torch.int32, device=dev),
                 "health": health_init(dev)}
    step_fn = make_train_step(model, train_cfg, mesh=mesh)
    adapter = adapter_for(model)
    losses, norms = [], []
    collectives.STATS.reset()
    first = mesh.index(*mesh.sizes) == 0

    def whole_leaves(pairs, prefix=""):
        """Each (name, shard) gathered whole: kept, compared with the kept
        one (max-abs difference and the kept one's max-abs), or returned."""
        out = {}
        for name, t in pairs:
            whole = layout.gather_full(t.detach(), layout.param_spec(name)) if layout else t.detach()
            path = prefix + name.replace(".", "/")
            if not first:
                continue
            if reference == "compare":
                ref = _KEPT[path]
                out[path] = (float((whole.float() - ref).abs().max()), float(ref.abs().max()))
            elif reference == "keep":
                _KEPT[path] = whole.float().clone()
            else:
                out[path] = whole.float().cpu().numpy()
        return out

    moments = {}
    # the same on every rank: which leaves get gathered
    by_moments = bool(reference) and "mu" in state["opt_state"]["leaves"][0]
    for i, batch in enumerate(batches):
        size = len(batch["y"]) if isinstance(batch, dict) else batch.shape[0]
        rows = adapter.to_device(take_rows(batch, batch_rows(size, mesh, train_cfg)), dev)
        state, m = step_fn(state, rows)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0 and by_moments:
            # Adam's first moment after the first step: (1 - b1) x the clipped gradient
            names = [n for n, _ in param_leaves(state["params"])]
            moments = whole_leaves([(n, leaf["mu"]) for n, leaf in zip(names, state["opt_state"]["leaves"])], "mu/")
    # with the gradients kept or compared (Adam's first moments), the
    # parameters are not gathered: an update's rounding is not comparable
    out = {} if by_moments else whole_leaves(param_leaves(state["params"]))
    if not first:
        return None
    return {"loss": losses, "grad_norm": norms, "params": out, "first_moments": moments,
            "collectives": collectives.STATS.to_dict()}


def restore_on_mesh(directory: str, step: int, spec: Dict[str, int], model: Any, train_cfg: Any,
                    device: str = "cpu") -> Optional[Dict[str, Any]]:
    """Restore checkpoint ``step`` of ``directory`` onto the mesh ``spec``
    (each rank reads its slices) and, on the first rank, onto one device
    too: every leaf of the ranks' state gathered whole against the
    one-device restore.  Returns the leaf count, the leaves that differ
    (max-abs > 0) and the bytes, on the first rank; None elsewhere."""
    import math

    import torch

    from tpu_nexus_torch.parallel.mesh import MeshSpec, TrainMesh
    from tpu_nexus_torch.workload.tensor_checkpoint import StateShard, TensorCheckpointer
    from tpu_nexus_torch.workload.train import init_train_state, param_leaves, train_layout

    full = {**dict(pp=1, dp=1, fsdp=1, ep=1, sp=1, tp=1), **spec}
    mesh = TrainMesh(MeshSpec(**full), ranks=range(math.prod(full.values())))
    if not mesh.is_member:
        return None
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = init_train_state(gen, model, train_cfg, dev, mesh=mesh)
    layout = train_layout(model, mesh)
    names = [n for n, _ in param_leaves(state["params"])]
    shard = StateShard(layout, names, writer=False)
    ckpt = TensorCheckpointer(directory, shard=shard)
    if ckpt.latest_verified_step(quarantine=False) != step:  # one checksum pass a rank, kept for both restores
        raise ValueError(f"step {step} is not the newest verified step of {directory}")
    state = ckpt.restore(state, step)
    first = mesh.index(*mesh.sizes) == 0
    whole = {}

    def walk(node, path):
        if isinstance(node, torch.nn.Module):
            for name, p in node.named_parameters():
                walk(p, f"{path}/{name.replace('.', '/')}")
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif isinstance(node, torch.Tensor):
            t = shard.whole(path, node.detach())
            if first:
                whole[path] = t
    walk(state, "")
    if not first:
        return None
    one = init_train_state(torch.Generator(device=dev).manual_seed(1), model, train_cfg, dev)
    ckpt.shard = None  # the same (verified) step, onto one device
    one = ckpt.restore(one, step)
    differ, nbytes, count = [], 0, 0

    def compare(node, path):
        nonlocal nbytes, count
        if isinstance(node, torch.nn.Module):
            for name, p in node.named_parameters():
                compare(p, f"{path}/{name.replace('.', '/')}")
        elif isinstance(node, dict):
            for k, v in node.items():
                compare(v, f"{path}/{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                compare(v, f"{path}/{i}")
        elif isinstance(node, torch.Tensor):
            count += 1
            nbytes += node.numel() * node.element_size()
            if not torch.equal(node, whole[path]):
                differ.append(path)
    compare(one, "")
    return {"leaves": count, "bytes": nbytes, "differ": differ, "mesh": mesh.describe()}


#: a first rank's kept parameters (``train_steps(reference="keep")``)
_KEPT: Dict[str, Any] = {}


def sp_attention(spec: Dict[str, int], kind: str, q: Any, k: Any, v: Any, g: Any, causal: bool = True,
                 dtype: str = "float32") -> Optional[Dict[str, Any]]:
    """The sequence-parallel attention ``kind`` (``ring`` | ``ulysses``) on
    the mesh ``spec``: the global ``[B, S, H, D]`` numpy q/k/v cut to each
    rank (batch over ``(dp, fsdp)``, sequence over ``sp``, heads over
    ``tp``), the output and, for the cotangent ``g``, the q/k/v gradients
    gathered whole on the mesh's first rank (f32 numpy); None elsewhere."""
    import math

    import torch

    from tpu_nexus_torch.parallel import collectives
    from tpu_nexus_torch.parallel.mesh import MeshSpec, TrainMesh
    from tpu_nexus_torch.parallel.ring import ring_attention_sharded
    from tpu_nexus_torch.parallel.ulysses import ulysses_attention

    full = {**dict(pp=1, dp=1, fsdp=1, ep=1, sp=1, tp=1), **spec}
    mesh = TrainMesh(MeshSpec(**full), ranks=range(math.prod(full.values())))
    if not mesh.is_member:
        return None
    cuts = ((0, ("dp", "fsdp")), (1, ("sp",)), (2, ("tp",)))

    def local(a):
        t = torch.from_numpy(a).to(getattr(torch, dtype))
        for dim, axes in cuts:
            n = t.shape[dim] // mesh.size(*axes)
            t = t.narrow(dim, mesh.index(*axes) * n, n)
        return t.contiguous().requires_grad_(True)

    def whole(t):
        t = t.detach()
        for dim, axes in cuts:
            t = collectives.gather_dim(t, dim, mesh.group(*axes), mesh.size(*axes))
        return t.float().numpy()

    ql, kl, vl, gl = local(q), local(k), local(v), local(g)
    with collectives.active(mesh.comm()):
        if kind == "ring":
            out = ring_attention_sharded(ql, kl, vl, mesh, causal=causal)
        else:
            out = ulysses_attention(ql, kl, vl, mesh=mesh, causal=causal,
                                    head_axis="tp" if mesh.size("tp") > 1 else None)
        dq, dk, dv = torch.autograd.grad(out, (ql, kl, vl), gl.detach())
    result = {name: whole(t) for name, t in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}
    return result if mesh.index(*mesh.sizes) == 0 else None


def _mesh_of(spec: Dict[str, int]):
    import math

    from tpu_nexus_torch.parallel.mesh import MeshSpec, TrainMesh

    full = {**dict(pp=1, dp=1, fsdp=1, ep=1, sp=1, tp=1), **spec}
    return TrainMesh(MeshSpec(**full), ranks=range(math.prod(full.values())))


def pipeline_stack(spec: Dict[str, int], ws: Any, bs: Any, x: Any, g: Any, microbatches: int) -> Optional[Dict[str, Any]]:
    """``parallel/pipeline.py::pipeline_apply`` over the mesh's ``pp`` ranks
    of the stack ``tanh(x @ w[l] + b[l])`` (numpy ``ws [L, D, D]``, ``bs [L,
    D]``, ``x [B, D]``): each stage holds its ``L / pp`` layers.  Returns, on
    the last stage, the output and, for the cotangent ``g``, the gradients
    of ``x`` (from the first stage) and of the whole ``w`` and ``b`` (f32
    numpy); None elsewhere."""
    import torch

    from tpu_nexus_torch.parallel import collectives
    from tpu_nexus_torch.parallel.pipeline import finish_on_last_stage, pipeline_apply

    mesh = _mesh_of(spec)
    if not mesh.is_member:
        return None
    pp, s = mesh.size("pp"), mesh.stage
    per = ws.shape[0] // pp
    layers = {name: torch.from_numpy(a[s * per:(s + 1) * per]).requires_grad_() for name, a in (("w", ws), ("b", bs))}
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(g)
    with collectives.active(mesh.comm()):
        out = pipeline_apply(lambda c, layer: torch.tanh(c @ layer["w"] + layer["b"]), layers, xt, n_stages=pp,
                             microbatches=microbatches, mesh=mesh)
        loss, _ = finish_on_last_stage(mesh, out, (), lambda o: ((o * gt).sum(), {}))
        loss.backward()
    # x's gradient lives on the first stage: summed with zeros over pp
    dx = collectives._all_reduce(xt.grad if s == 0 else torch.zeros_like(xt), mesh.group("pp"), None)
    whole = {k: collectives.gather_dim(t.grad, 0, mesh.group("pp"), pp).numpy() for k, t in layers.items()}
    if s != pp - 1:
        return None
    return {"out": out.detach().numpy(), "dx": dx.numpy(), "dw": whole["w"], "db": whole["b"], "loss": float(loss)}


def moe_ffn_grads(spec: Dict[str, int], cfg: Any, x: Any, layer: Dict[str, Any],
                  force_ep: bool = False) -> Optional[Dict[str, Any]]:
    """``models/moe.py::moe_ffn`` on the training mesh ``spec``: the global
    numpy ``x [B, S, e]`` cut to the rank (rows over ``(dp, fsdp)``, the
    sequence over ``sp``), the layer's expert stacks to its experts (``ep``)
    and mlp slice (``tp``; the router whole, as the layer's fsdp gather
    leaves it).  The loss is ``sum(out ** 2)``.  Returns, on the mesh's
    first rank, the output, the aux values and the gradients of ``x`` and
    of every layer leaf, gathered whole (the weights' summed over the data
    axes, as the train step does); None elsewhere."""
    import numpy as np
    import torch

    from tpu_nexus_torch.models.moe import moe_ffn
    from tpu_nexus_torch.parallel import collectives
    from tpu_nexus_torch.parallel.mesh import DATA_AXES

    mesh = _mesh_of(spec)
    if not mesh.is_member:
        return None
    cuts = {"x": ((0, ("dp", "fsdp")), (1, ("sp",))), "router": (),
            "w_gate": ((0, ("ep",)), (2, ("tp",))), "w_up": ((0, ("ep",)), (2, ("tp",))),
            "w_down": ((0, ("ep",)), (1, ("tp",)))}

    def local(name, a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(cfg.dtype)
        for dim, axes in cuts[name]:
            n = t.shape[dim] // mesh.size(*axes)
            t = t.narrow(dim, mesh.index(*axes) * n, n)
        return t.contiguous().requires_grad_()

    def whole(name, t):
        for dim, axes in cuts[name]:
            t = collectives.gather_dim(t, dim, mesh.group(*axes), mesh.size(*axes))
        return t.float().numpy()

    xl = local("x", x)
    ll = {k: local(k, v) for k, v in layer.items()}
    with _force_ep_path(force_ep), collectives.active(mesh.comm()):
        out, aux = moe_ffn(xl, ll, cfg, mesh=mesh)
        (out.float() ** 2).sum().backward()
    data = tuple(a for a in DATA_AXES if mesh.size(a) > 1)
    grads = {}
    for k, t in ll.items():
        g = t.grad
        if data:
            g = collectives._all_reduce(g, mesh.group(*data), None)
        grads[k] = whole(k, g)
    result = {"out": whole("x", out.detach()), "aux": {k: float(v) for k, v in aux.items()},
              "dx": whole("x", xl.grad), "grads": grads}
    return result if mesh.index(*mesh.sizes) == 0 else None


if __name__ == "__main__":
    sys.exit(main())
