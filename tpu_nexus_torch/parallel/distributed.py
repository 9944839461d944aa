"""Process identity and process-group bring-up for launched workloads: the
port of ``tpu_nexus/parallel/distributed.py`` on ``torch.distributed``.

Env contract (set by the launcher): ``NEXUS_RUN_ID`` / ``NEXUS_ALGORITHM``
(ledger key), ``NEXUS_PROCESS_ID``, ``NEXUS_NUM_PROCESSES``,
``NEXUS_COORDINATOR_ADDRESS`` (``host:port`` of rank 0's rendezvous).  A
world larger than one is brought up with ``init_process_group(init_method=
"tcp://<coordinator>", rank, world_size, timeout)``.

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
"""

from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence

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
    """A free TCP port on the loopback interface, for a local rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


def single_process(ctx: Optional[ProcessContext], what: str) -> ProcessContext:
    """The identity of a run that ``what`` runs in ONE process.  A world of
    more processes (a multi-host JobSet) raises at start: it never runs as
    that many unsynchronised copies writing one ledger row."""
    ctx = ctx or process_context_from_env()
    if ctx.num_processes > 1:
        raise NotImplementedError(
            f"{ENV_NUM_PROCESSES}={ctx.num_processes}: {what} runs in one process; a run "
            "across processes is not ported yet (ROADMAP.md: A6b parallel training)"
        )
    return ctx


def initialize_distributed(ctx: Optional[ProcessContext] = None, env: Optional[dict] = None) -> ProcessContext:
    """Single-process runs pass through.  A world of more processes joins
    the process group at ``tcp://$NEXUS_COORDINATOR_ADDRESS``, each process
    on ``NEXUS_DEVICE`` of its own host (``cuda`` by default, backend
    ``nccl``) or, under the rehearsal map, all on one device over gloo."""
    e = os.environ if env is None else env
    ctx = ctx or process_context_from_env(e)
    if ctx.num_processes <= 1:
        return ctx
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return ctx
    if not ctx.coordinator:
        raise ValueError(
            f"{ENV_NUM_PROCESSES}={ctx.num_processes} but {ENV_COORDINATOR} is unset; "
            "the launcher must inject rank 0's address"
        )
    rank_map = e.get(ENV_RANK_MAP, "")
    if rank_map not in RANK_MAPS:
        raise ValueError(f"unknown {ENV_RANK_MAP} {rank_map!r}; use 'shared' or leave it unset")
    dev = torch.device(e.get("NEXUS_DEVICE", "cuda"))
    if dev.type == "cpu" and rank_map != "shared":
        raise ValueError(
            f"{ctx.num_processes} processes on the CPU: the one-device rehearsal map "
            f"must be asked for ({ENV_RANK_MAP}=shared)"
        )
    backend = "gloo" if dev.type == "cpu" or rank_map == "shared" else "nccl"
    logger.info(
        "joining the process group: process %d/%d coordinator=%s backend=%s",
        ctx.process_id, ctx.num_processes, ctx.coordinator, backend,
    )
    start_process_group(
        f"tcp://{ctx.coordinator}", ctx.process_id, ctx.num_processes, backend, timeout_from_env(e),
    )
    return ctx
