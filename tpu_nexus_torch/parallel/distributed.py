"""Process identity and process-group bring-up for launched workloads: the
port of ``tpu_nexus/parallel/distributed.py`` on ``torch.distributed``.

Env contract (set by the launcher): ``NEXUS_RUN_ID`` / ``NEXUS_ALGORITHM``
(ledger key), ``NEXUS_PROCESS_ID``, ``NEXUS_NUM_PROCESSES``,
``NEXUS_COORDINATOR_ADDRESS`` (``host:port`` of rank 0's rendezvous).  A
world larger than one is brought up with ``init_process_group(init_method=
"tcp://<coordinator>", rank, world_size, timeout)``
(:func:`start_process_group`, the ranks planned by :func:`rank_plan`).

Ranks and devices:

* **one card a rank** (the default map): rank ``r`` of a host runs on
  ``cuda:r``; the backend is ``nccl``.  NCCL refuses two ranks on one card,
  so a world larger than the cards raises, naming the reason.
* **the one-device rehearsal map** (``rank_map="shared"``,
  ``NEXUS_RANK_DEVICE_MAP=shared``): every rank on ONE device — ``cpu``
  in the tests, ``cuda:0`` on a one-card machine — over ``gloo``.  It is
  the counterpart of the JAX package's virtual CPU devices
  (``tpu_nexus/parallel/smap.py::force_virtual_cpu_devices``): never
  chosen automatically, a rehearsal of the collectives and the per-rank
  shapes, not a tensor-parallel speed.
* ranks on the CPU without that map: a world of one only.

Training and a serve mesh (:func:`rank_plan`) run one rank a local
device in each launched process, as the JAX package runs one process a
host driving all of its chips: process ``NEXUS_PROCESS_ID`` runs ``local``
ranks, the global rank of its ``j``-th being ``process_id · local + j``
(its ledger key ``host<process_id>/chip<j>``).  ``local`` is the process's
cards under the default map and ``mesh size / NEXUS_NUM_PROCESSES`` under
the rehearsal map, where a ``-1`` axis infers one rank a process.  Serving
without a mesh runs one copy a process on its own device; the processes
meet only at start, at :func:`process_rendezvous` (the JAX package's
``jax.distributed.initialize``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Iterator, List, Optional, Sequence

logger = logging.getLogger(__name__)

ENV_COORDINATOR = "NEXUS_COORDINATOR_ADDRESS"
ENV_PROCESS_ID = "NEXUS_PROCESS_ID"
ENV_NUM_PROCESSES = "NEXUS_NUM_PROCESSES"
ENV_RUN_ID = "NEXUS_RUN_ID"
ENV_ALGORITHM = "NEXUS_ALGORITHM"
ENV_RANK_MAP = "NEXUS_RANK_DEVICE_MAP"
ENV_TIMEOUT = "NEXUS_DIST_TIMEOUT_S"

#: "" = one card a rank; "shared" = every rank on one device (rehearsal)
RANK_MAPS = ("", "shared")
#: seconds a collective may wait for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class ProcessContext:
    """Identity of this process within a launched run."""

    run_id: str
    algorithm: str
    process_id: int
    num_processes: int
    coordinator: Optional[str]

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    def chip_key(self, local_device_index: int) -> str:
        """Ledger key for per-chip step counters, e.g. ``host0/chip1``."""
        return f"host{self.process_id}/chip{local_device_index}"


def process_context_from_env(env: Optional[dict] = None) -> ProcessContext:
    e = os.environ if env is None else env
    num_processes = int(e.get(ENV_NUM_PROCESSES, "1"))
    if num_processes > 1 and ENV_PROCESS_ID not in e:
        raise ValueError(
            f"{ENV_NUM_PROCESSES}={num_processes} but {ENV_PROCESS_ID} is unset; "
            "the launcher must inject the JobSet completion index"
        )
    return ProcessContext(
        run_id=e.get(ENV_RUN_ID, "local"),
        algorithm=e.get(ENV_ALGORITHM, "local"),
        process_id=int(e.get(ENV_PROCESS_ID, "0")),
        num_processes=num_processes,
        coordinator=e.get(ENV_COORDINATOR),
    )


def rank_devices(world: int, device: str = "cuda", rank_map: str = "") -> List["object"]:
    """The device of every rank of a ``world`` on one host.  The default map
    gives each rank its own card (``cuda:0`` .. ``cuda:world-1``) and raises
    when there are fewer cards than ranks; ``rank_map="shared"`` puts every
    rank on ``device`` (the one-device rehearsal)."""
    import torch

    if rank_map not in RANK_MAPS:
        raise ValueError(f"unknown rank map {rank_map!r}; use '' (one card a rank) or 'shared'")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and rank_map == "shared":
        dev = torch.device("cuda", torch.cuda.current_device())
    if rank_map == "shared":
        return [dev] * world
    if dev.type == "cpu":
        if world > 1:
            raise ValueError(
                f"{world} ranks on the CPU share one device: the one-device rehearsal "
                f"map must be asked for ({ENV_RANK_MAP}=shared)"
            )
        return [dev]
    n = torch.cuda.device_count()
    if world > n:
        raise ValueError(
            f"{world} ranks want one card each but torch sees {n} CUDA device(s); "
            f"the one-device rehearsal map ({ENV_RANK_MAP}=shared) runs them on one card over gloo"
        )
    return [torch.device("cuda", i) for i in range(world)]


def backend_for(devices: Sequence["object"]) -> str:
    """``gloo`` on the CPU and when ranks share a device (the rehearsal map),
    ``nccl`` when every rank has its own card."""
    if all(d.type == "cpu" for d in devices) or len(set(devices)) < len(devices):
        return "gloo"
    return "nccl"


def check_backend(backend: str, devices: Sequence["object"]) -> None:
    """Refuse a backend its devices cannot carry: NCCL needs one card a
    rank (it refuses two ranks on one card)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; use 'gloo' or 'nccl'")
    if backend != "nccl":
        return
    owner = {}
    for rank, dev in enumerate(devices):
        if dev.type != "cuda":
            raise ValueError(f"nccl needs a CUDA device for every rank; rank {rank} is on {dev}")
        if dev in owner:
            raise ValueError(
                f"NCCL refuses two ranks on one card: ranks {owner[dev]} and {rank} are both on {dev}; "
                f"the one-device rehearsal map runs them over gloo"
            )
        owner[dev] = rank


def timeout_from_env(env: Optional[dict] = None) -> float:
    e = os.environ if env is None else env
    value = float(e.get(ENV_TIMEOUT, str(DEFAULT_TIMEOUT_S)))
    if value <= 0:
        raise ValueError(f"{ENV_TIMEOUT} must be > 0 seconds, got {value}")
    return value


def free_port() -> int:
    """A free TCP port on the loopback interface, for a rendezvous this
    process serves at once: the port is free only when it returns, so any
    socket of the host may take it before it is bound again."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def reserved_port() -> Iterator[int]:
    """A loopback port held for a rendezvous that a process started later
    serves (``NEXUS_COORDINATOR_ADDRESS`` of launched processes): bound with
    ``SO_REUSEADDR`` and never listening while the block runs.  The kernel
    gives a bound port to no other socket — neither as a connection's local
    port nor to another ``bind`` to port 0 — while the serving process's
    own bind with ``SO_REUSEADDR`` (the rendezvous store's) and its listen
    succeed beside it.  Hold it until that process listens."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        yield s.getsockname()[1]


def start_process_group(
    init_method: str, rank: int, world_size: int, backend: str, timeout_s: float
) -> None:
    """``init_process_group`` with a finite timeout: a peer that never
    arrives, or stops answering, raises instead of hanging the world."""
    import torch.distributed as dist

    if timeout_s <= 0:
        raise ValueError(f"process-group timeout must be > 0 seconds, got {timeout_s}")
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=timedelta(seconds=timeout_s),
    )


@dataclass(frozen=True)
class RankPlan:
    """Where one process's ranks run: ``local`` ranks a process,
    ``world`` in all, each local rank's device, the backend and the
    rendezvous."""

    local: int
    world: int
    devices: tuple
    backend: str
    init_method: str
    rank_map: str

    def global_rank(self, ctx: ProcessContext, j: int) -> int:
        return ctx.process_id * self.local + j


def rank_plan(ctx: ProcessContext, sizes: Sequence[int], device: str, rank_map: str = "") -> RankPlan:
    """The rank plan of a training or serve-mesh process for a mesh of axis
    ``sizes`` (one ``-1`` allowed): see the module docstring.  A world of one is the
    one-device run (no process group).  A world larger than one joins the
    group at ``tcp://$NEXUS_COORDINATOR_ADDRESS`` (a loopback port when the
    world is this process's ranks alone)."""
    import math

    import torch

    if rank_map not in RANK_MAPS:
        raise ValueError(f"unknown {ENV_RANK_MAP} {rank_map!r}; use 'shared' or leave it unset")
    dev = torch.device(device)
    if rank_map == "shared":
        fixed = math.prod(sizes)
        if -1 in sizes:
            local = 1
        elif fixed % ctx.num_processes:
            raise ValueError(
                f"a mesh of {fixed} ranks does not split over {ctx.num_processes} processes "
                f"({ENV_NUM_PROCESSES})"
            )
        else:
            local = fixed // ctx.num_processes
    else:
        local = local_devices(device)
    world = local * ctx.num_processes
    if world > 1 and dev.type == "cpu" and rank_map != "shared":
        raise ValueError(
            f"{world} ranks on the CPU share one device: the one-device rehearsal map "
            f"must be asked for ({ENV_RANK_MAP}=shared)"
        )
    devices = (dev,) if local == 1 and rank_map != "shared" else tuple(rank_devices(local, device, rank_map))
    # the processes' ranks share one device under the rehearsal map: gloo
    # (this process alone cannot see that: each holds its own ranks)
    shared = rank_map == "shared" or backend_for(devices) == "gloo"
    backend = "gloo" if shared else "cpu:gloo,cuda:nccl"
    if ctx.num_processes > 1:
        init = coordinator_init(ctx)
    else:
        init = f"tcp://127.0.0.1:{free_port()}" if world > 1 else ""
    return RankPlan(local, world, devices, backend, init, rank_map)


def coordinator_init(ctx: ProcessContext) -> str:
    """``tcp://$NEXUS_COORDINATOR_ADDRESS``, where the launched processes
    meet; raises when the launcher did not inject it."""
    if not ctx.coordinator:
        raise ValueError(
            f"{ENV_NUM_PROCESSES}={ctx.num_processes} but {ENV_COORDINATOR} is unset; "
            "the launcher must inject rank 0's address"
        )
    return f"tcp://{ctx.coordinator}"


def local_devices(device: str) -> int:
    """The devices one process drives under the default map: every card
    torch sees for ``cuda``, one for a named card or the CPU (the reference's
    ``jax.local_device_count()``: one ledger key each)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return max(1, torch.cuda.device_count())
    return 1


def process_rendezvous(ctx: ProcessContext, timeout_s: float) -> bool:
    """Join the launched processes' own group (one rank a process, gloo, on
    the host) at ``tcp://$NEXUS_COORDINATOR_ADDRESS``: the serving loops'
    rendezvous at start, as ``jax.distributed.initialize`` blocks until
    every process arrives.  False (and no group) for a world of one."""
    if ctx.num_processes <= 1:
        return False
    start_process_group(coordinator_init(ctx), ctx.process_id, ctx.num_processes, "gloo", timeout_s)
    return True
