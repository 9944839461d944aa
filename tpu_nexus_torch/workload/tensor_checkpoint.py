"""Tensor (weights/optimizer) checkpoints of the port, hardened by the
durability layer in :mod:`tpu_nexus_torch.workload.durability`: the port
of ``tpu_nexus/workload/tensor_checkpoint.py`` with its own storage.

Distinct from the *ledger* checkpoint (run metadata): these are the
actual tensors, written to a directory; the ledger row points at them via
``tensor_checkpoint_uri`` so a preempted run restarts from its step.

That pointer is a promise, so saving splits in two, as in the reference:

* :meth:`TensorCheckpointer.save` writes the step (synchronously: the
  tensors are copied to the host and written before it returns);
* :meth:`TensorCheckpointer.commit` is the **durability barrier** —
  checksum every byte into a manifest, publish it atomically (temp →
  fsync → rename) and structurally re-verify it.  Only a URI returned by
  ``commit`` may reach the ledger (nxlint NX007).

Restores go the other way: verify first, and when the newest step is torn
or corrupt, roll back to the newest step that *proves* itself,
quarantining the bad directory and recording why (``rollbacks``).

Sharded train state (a rank of a training mesh, :class:`StateShard`) is
saved in the same layout a one-device run writes: every rank takes part
in the save, each leaf gathered whole across the ranks that cut it, and
one rank (the coordinator) writes the files; its ``commit`` is the one
checksum commit.  A restore reads each file mapped and copies only the
rank's slice, so a run resumes on another mesh, or on one device, from
the same directory.

Storage (the package imports only torch, numpy and the stdlib): a step
directory holds one file per tensor leaf, ``tensors/<n>.pt``, each a
``torch.save`` of a contiguous CPU tensor with a storage of its own, and
``_NEXUS_TREE.json``, the tree index: the nesting (dict keys, list and
tuple positions, modules by class), each tensor's file, dtype and shape,
and Python scalars inline.  Both sit inside the step directory, so the
manifest checksums the index like any payload file.  A step is written
under a temporary name (``<step>.nexus-tmp-<pid>``, never all digits, so
no step scan lists it) and renamed into place once complete, as Orbax's
finalize does; a crash mid-write leaves no step directory at all.  Loads
always go through ``torch.load(..., weights_only=True)``: a checkpoint
directory is input from another job.
"""

from __future__ import annotations

import glob
import logging
import os
import shutil
from typing import Any, Callable, Dict, List, Optional

import torch

from tpu_nexus_torch.workload import durability
from tpu_nexus_torch.workload.durability import (  # re-exported: callers catch these
    CheckpointCorrupt,
    CheckpointError,
    CheckpointMissing,
    CheckpointUncommitted,
)

__all__ = [
    "TensorCheckpointer",
    "CheckpointError",
    "CheckpointMissing",
    "CheckpointUncommitted",
    "CheckpointCorrupt",
]

logger = logging.getLogger(__name__)

#: fault-hook points (chaos harness seam, workload/faults.py): called as
#: ``hook(point, step, step_dir)`` around the commit protocol
HOOK_PRE_COMMIT = "pre-commit"
HOOK_POST_COMMIT = "post-commit"

#: data-cursor sidecar (workload/data.DataCursor.state()), written into the
#: step directory before commit so the manifest checksums it — the
#: restart-from-*data* half of the restart-from-step contract
CURSOR_SIDECAR = "_NEXUS_CURSOR.json"

#: the tree index of a step (see the module docstring)
TREE_INDEX = "_NEXUS_TREE.json"
TREE_FORMAT = 1
#: the directory of the tensor files inside a step
TENSOR_DIR = "tensors"
#: infix of a step's temporary directory while it is being written
TMP_INFIX = ".nexus-tmp-"

#: the tensor dtypes a checkpoint holds, by name
_DTYPES = frozenset(
    str(dt).removeprefix("torch.")
    for dt in (
        torch.float64, torch.float32, torch.float16, torch.bfloat16,
        torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
    )
)


def _module_types() -> Dict[str, Callable[[Dict[str, Any]], Any]]:
    """Module classes a checkpoint may hold, by name, with the constructor
    that rebuilds one from its nested parameter tree (template-free
    restores)."""
    from tpu_nexus_torch.models.llama import LlamaParams
    from tpu_nexus_torch.models.mnist import MnistParams

    return {"LlamaParams": LlamaParams, "MnistParams": lambda tree: MnistParams(tree["groups"])}


def _module_tree(module: torch.nn.Module) -> Dict[str, Any]:
    """A module's parameters as a nested dict of its dotted names."""
    if any(True for _ in module.buffers()):
        raise TypeError(f"cannot checkpoint {type(module).__name__}: modules with buffers are not supported")
    tree: Dict[str, Any] = {}
    for name, param in module.named_parameters():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = param
    return tree


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, contiguous, owning a storage of exactly its bytes
    (``torch.save`` writes a view's whole storage)."""
    out = t.detach().to("cpu").contiguous()
    if out.storage_offset() or out.untyped_storage().nbytes() != out.numel() * out.element_size():
        out = out.clone()
    return out


class StateShard:
    """How a rank of a training mesh saves and restores its train state:
    ``layout`` (``workload/train.py::Layout``) gives each leaf's spec by its
    path, ``names`` the parameters' flatten order (an optimizer leaf's
    index), and ``writer`` says whether this rank writes the files."""

    def __init__(self, layout: Any, names: List[str], writer: bool) -> None:
        self.layout, self.names, self.writer = layout, names, writer

    def spec(self, path: str) -> Any:
        return self.layout.state_spec(path, self.names)

    def whole(self, path: str, t: torch.Tensor) -> torch.Tensor:
        return self.layout.gather_full(t, self.spec(path))

    def cut(self, path: str, t: torch.Tensor) -> torch.Tensor:
        return self.layout.cut(t, self.spec(path))

    def global_shape(self, path: str, shape: Any) -> List[int]:
        return list(self.layout.global_shape(shape, self.spec(path)))


def _join(path: str, key: Any) -> str:
    return f"{path}/{key}" if path else str(key)


class _Writer:
    """Flattens a state tree into tensor files plus the index nodes.  With
    a ``shard`` each tensor is gathered whole first (every rank walks the
    tree: the gathers are collective); ``root`` None writes nothing."""

    def __init__(self, root: Optional[str], shard: Optional[StateShard] = None) -> None:
        self.root = root
        self.shard = shard
        self.count = 0

    def node(self, obj: Any, path: str = "") -> Dict[str, Any]:
        if isinstance(obj, torch.nn.Module):
            name = type(obj).__name__
            if name not in _module_types():
                raise TypeError(f"cannot checkpoint module type {name}")
            return {"module": name, "tree": self.node(_module_tree(obj), path)}
        if isinstance(obj, torch.Tensor):
            return self.tensor(obj, path)
        if isinstance(obj, dict):
            if not all(isinstance(k, str) for k in obj):
                raise TypeError("checkpoint trees take string dict keys only")
            return {"dict": [[k, self.node(v, _join(path, k))] for k, v in obj.items()]}
        if isinstance(obj, (list, tuple)):
            return {"tuple" if isinstance(obj, tuple) else "list":
                    [self.node(v, _join(path, i)) for i, v in enumerate(obj)]}
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return {"value": obj}
        raise TypeError(f"cannot checkpoint a leaf of type {type(obj).__name__}")

    def tensor(self, t: torch.Tensor, path: str = "") -> Dict[str, Any]:
        dtype = str(t.dtype).removeprefix("torch.")
        if dtype not in _DTYPES:
            raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
        if self.shard is not None:
            t = self.shard.whole(path, t.detach())
        if self.root is None:
            return {}
        rel = f"{TENSOR_DIR}/{self.count:05d}.pt"
        self.count += 1
        host = _host_copy(t)
        path = os.path.join(self.root, rel)
        with open(path, "wb") as fh:
            torch.save(host, fh)
            fh.flush()
            os.fsync(fh.fileno())
        return {"tensor": rel, "dtype": dtype, "shape": list(host.shape)}


class _Reader:
    """Loads tensor files named by index nodes onto a device.  With
    ``leaf_fn(path, tensor)`` each file is mapped (not read whole) and the
    function's result — a rank's slice — is what reaches the device."""

    def __init__(self, step_dir: str, leaf_fn: Any = None) -> None:
        self.step_dir = step_dir
        self.leaf_fn = leaf_fn

    def tensor(self, node: Dict[str, Any], device: Any, path: str = "") -> torch.Tensor:
        rel = os.path.normpath(node["tensor"])
        if os.path.isabs(rel) or rel.startswith(os.pardir):
            raise CheckpointCorrupt(f"{self.step_dir}: the index names a file outside the step: {node['tensor']!r}")
        file = os.path.join(self.step_dir, rel)
        if self.leaf_fn is None:
            t = torch.load(file, weights_only=True, map_location=torch.device(device))
        else:
            t = torch.load(file, weights_only=True, map_location="cpu", mmap=True)
        if not isinstance(t, torch.Tensor) or str(t.dtype).removeprefix("torch.") != node["dtype"] or list(
            t.shape
        ) != node["shape"]:
            raise CheckpointCorrupt(f"{file} does not hold the {node['dtype']} {node['shape']} tensor its index names")
        if self.leaf_fn is not None:
            t = self.leaf_fn(path, t).to(device, copy=True)
        return t

    def build(self, node: Dict[str, Any], device: Any, path: str = "") -> Any:
        """A fresh object from an index node (template-free); ``path`` is the
        ``/``-joined key path of the node below the restored subtree."""
        if "tensor" in node:
            return self.tensor(node, device, path)
        if "module" in node:
            return _module_types()[node["module"]](self.build(node["tree"], device, path))
        if "dict" in node:
            return {k: self.build(v, device, f"{path}/{k}" if path else k) for k, v in node["dict"]}
        if "list" in node:
            return [self.build(v, device, f"{path}/{i}" if path else str(i)) for i, v in enumerate(node["list"])]
        if "tuple" in node:
            return tuple(self.build(v, device, f"{path}/{i}" if path else str(i))
                         for i, v in enumerate(node["tuple"]))
        return node["value"]


def _template_shape(obj: Any, shard: Optional[StateShard] = None, path: str = "") -> Any:
    """The structure of a restore template — containers, module classes,
    tensor dtypes and shapes (a shard's global shapes), scalars — in the
    canonical form that :func:`_index_shape` gives a saved index (dict
    keys unordered)."""
    if isinstance(obj, torch.nn.Module):
        return {"module": type(obj).__name__, "tree": _template_shape(_module_tree(obj), shard, path)}
    if isinstance(obj, torch.Tensor):
        shape = list(obj.shape) if shard is None else shard.global_shape(path, obj.shape)
        return {"dtype": str(obj.dtype).removeprefix("torch."), "shape": shape}
    if isinstance(obj, dict):
        return {"dict": {k: _template_shape(v, shard, _join(path, k)) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"tuple" if isinstance(obj, tuple) else "list":
                [_template_shape(v, shard, _join(path, i)) for i, v in enumerate(obj)]}
    return {"value": obj}


def _index_shape(node: Dict[str, Any]) -> Any:
    if "tensor" in node:
        return {"dtype": node["dtype"], "shape": node["shape"]}
    if "module" in node:
        return {"module": node["module"], "tree": _index_shape(node["tree"])}
    if "dict" in node:
        return {"dict": {k: _index_shape(v) for k, v in node["dict"]}}
    for kind in ("list", "tuple"):
        if kind in node:
            return {kind: [_index_shape(v) for v in node[kind]]}
    return {"value": node["value"]}


def _first_difference(a: Any, b: Any, path: str = "") -> str:
    """Where two canonical structures first differ, for the mismatch error."""
    if type(a) is not type(b):
        return path or "/"
    if isinstance(a, dict):
        for key in sorted(set(a) | set(b)):
            if key not in a or key not in b:
                return f"{path}/{key}"
            if a[key] != b[key]:
                return _first_difference(a[key], b[key], f"{path}/{key}")
    if isinstance(a, list):
        if len(a) != len(b):
            return f"{path}[len {len(a)} != {len(b)}]"
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_difference(x, y, f"{path}[{i}]")
    return path or "/"


class TensorCheckpointer:
    """Save/restore the train-state tree keyed by step, with per-step
    manifests as the commit marker and checksum verification on both sides
    (the reference's contract over the port's own storage).

    ``max_to_keep`` rotates committed steps at commit time: only the newest
    ``max_to_keep`` committed steps stay; uncommitted, quarantined and
    abandoned directories are never deleted.  ``fault_hook`` is the
    chaos-injection seam (:func:`tpu_nexus_torch.workload.faults.checkpoint_fault_hook`)."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        fault_hook: Optional[Callable[[str, int, str], None]] = None,
        shard: Optional[StateShard] = None,
    ) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = directory
        #: a rank of a training mesh (see the module docstring); None: one device
        self.shard = shard
        self.max_to_keep = max_to_keep
        self._fault_hook = fault_hook
        #: newest step whose commit barrier completed IN THIS PROCESS —
        #: the emergency-save path uses it to skip a duplicate same-step save
        self.last_committed_step: Optional[int] = None
        #: newest step this process wrote (saved, not yet necessarily committed)
        self.last_saved_step: Optional[int] = None
        #: restore-time rollback events (durability.newest_verified_step
        #: records), accumulated for metrics/ledger reporting by the caller
        self.rollbacks: List[Dict[str, Any]] = []
        #: steps fully checksum-verified by THIS process's verified-step
        #: scan: restore skips the immediately-redundant re-hash.
        #: Process-local and scan-fed only — corruption arriving between
        #: the scan and the restore is outside the window this cache
        #: tolerates.
        self._scan_verified: set = set()

    def _hook(self, point: str, step: int) -> None:
        if self._fault_hook is not None:
            self._fault_hook(point, step, self.step_dir(step))

    # -- save side -------------------------------------------------------------

    def save(self, step: int, state: Dict[str, Any]) -> str:
        """Write ``state`` as step ``step``: every tensor copied to the host
        and written under a temporary directory, renamed into place when
        complete.  The returned URI is NOT durable yet — it must not be
        published until :meth:`commit` returns.  A step that already exists
        on disk is refused (as Orbax refuses it); a quarantined or abandoned
        step number is free again, so its re-save is a real save."""
        step = int(step)
        final = self.step_dir(step)
        if self.shard is not None and not self.shard.writer:
            _Writer(None, self.shard).node(state)  # this rank's part of the gathers
            self.last_saved_step = step
            return self.uri_for(step)
        if os.path.exists(final):
            raise ValueError(f"checkpoint step {step} already exists at {final}")
        os.makedirs(self.directory, exist_ok=True)
        for stale in glob.glob(glob.escape(final) + TMP_INFIX + "*"):
            # a crashed earlier writer's half-written step: never a step
            shutil.rmtree(stale, ignore_errors=True)
        tmp = f"{final}{TMP_INFIX}{os.getpid()}"
        os.makedirs(os.path.join(tmp, TENSOR_DIR))
        index = {"format": TREE_FORMAT, "step": step, "tree": _Writer(tmp, self.shard).node(state)}
        durability.write_json_sidecar(tmp, TREE_INDEX, index)
        durability._fsync_dir(os.path.join(tmp, TENSOR_DIR))
        durability._fsync_dir(tmp)
        os.rename(tmp, final)
        durability._fsync_dir(self.directory)
        self.last_saved_step = step
        return self.uri_for(step)

    def commit(self, step: int) -> str:
        """The durability barrier: manifest every byte, publish the commit
        marker atomically, and read back the commit structurally.  Returns
        the URI, now safe to write to the ledger (nxlint NX007)."""
        step_dir = self.step_dir(step)
        manifest = durability.build_manifest(step_dir, step)
        durability.write_manifest_temp(step_dir, manifest)
        # chaos seam: ckpt-crash-mid-save kills the process HERE — payload
        # durable, marker absent — the exact torn-save window the restore
        # side must survive
        self._hook(HOOK_PRE_COMMIT, step)
        durability.commit_manifest(step_dir)
        # structural read-back: marker landed, manifest parses, every file
        # present at its manifested size; build_manifest just hashed every
        # byte, and full checksums are enforced on the restore side
        durability.verify_step(step_dir, step, deep=False)
        self.last_committed_step = step
        self._rotate()
        self._hook(HOOK_POST_COMMIT, step)
        return self.uri_for(step)

    def _rotate(self) -> None:
        """Delete committed steps beyond the newest ``max_to_keep``."""
        committed = [
            s for s in durability.list_steps(self.directory)
            if os.path.isfile(os.path.join(self.step_dir(s), durability.MANIFEST_NAME))
        ]
        for s in committed[: -self.max_to_keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
            self._scan_verified.discard(s)
            logger.info("rotated out checkpoint step %d (max_to_keep=%d)", s, self.max_to_keep)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight after :meth:`save`."""

    def save_cursor(self, step: int, state: Dict[str, Any]) -> str:
        """Stage the data-cursor sidecar into step ``step``'s directory.
        Must run between :meth:`save` and :meth:`commit`; the commit
        manifest then covers the sidecar, so cursor state is exactly as
        durable and tamper-evident as the tensors it describes."""
        return durability.write_json_sidecar(self.step_dir(step), CURSOR_SIDECAR, state)

    def load_cursor(self, step: int) -> Optional[Dict[str, Any]]:
        """The cursor sidecar of a (verified) step; None for steps written
        without one — callers fall back to the plain step-count
        fast-forward."""
        return durability.read_json_sidecar(self.step_dir(step), CURSOR_SIDECAR)

    # -- verification / rollback ----------------------------------------------

    def verify(self, step: int) -> Dict[str, Any]:
        """Prove step ``step`` committed and checksum-clean (returns its
        manifest); raises the classified ``Checkpoint*`` errors."""
        return durability.verify_step(self.step_dir(step), step)

    def latest_verified_step(
        self, quarantine: bool = True, before: Optional[int] = None
    ) -> Optional[int]:
        """Newest step that passes verification, rolling back past torn or
        corrupt ones.  Bad steps are quarantined (renamed ``<step>.corrupt``)
        unless ``quarantine=False`` (read-only consumers: serving), and each
        rollback is appended to :attr:`rollbacks` for the caller to report.
        ``before`` restricts the scan to steps < ``before`` (the health
        rollback's pre-poison-window constraint)."""
        step, rollbacks = durability.newest_verified_step(
            self.directory, quarantine=quarantine, before=before
        )
        self.rollbacks.extend(rollbacks)
        if step is not None:
            self._scan_verified.add(step)
        return step

    def reload(self) -> None:
        """A no-op kept for the reference's contract: the reference drops
        Orbax's cached step list here after another process renamed steps.
        This checkpointer caches no step list — every save and scan reads
        the directory — so a re-save of a quarantined or abandoned step
        number is always a real save."""

    def latest_step(self) -> Optional[int]:
        """The UNVERIFIED newest step directory — prefer
        :meth:`latest_verified_step` anywhere the result gets restored or
        published."""
        steps = durability.list_steps(self.directory)
        return steps[-1] if steps else None

    # -- restore side ----------------------------------------------------------

    def _resolve_step(self, step: Optional[int]) -> int:
        """Explicit step: verify it (the caller demanded THAT step — a
        classified raise beats restoring garbage), unless this process's
        verified-step scan already checksummed it.  No step: newest
        verified, with rollback + quarantine."""
        if step is not None:
            if step not in self._scan_verified:
                self.verify(step)
            return step
        found = self.latest_verified_step()
        if found is None:
            detail = (
                f" ({len(self.rollbacks)} unverifiable step(s) quarantined)"
                if self.rollbacks
                else ""
            )
            raise CheckpointMissing(
                f"no verifiable checkpoint under {self.directory}{detail}"
            )
        return found

    def _index(self, step: int) -> Dict[str, Any]:
        index = durability.read_json_sidecar(self.step_dir(step), TREE_INDEX)
        if index is None or index.get("format") != TREE_FORMAT or "tree" not in index:
            raise CheckpointCorrupt(f"{self.step_dir(step)}: no readable {TREE_INDEX}")
        return index

    def restore(self, state_like: Dict[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
        """Restore into the structure of ``state_like``: the saved tree must
        match it (keys, list positions, module classes, every tensor's
        dtype and shape), else ``ValueError`` names the first difference.
        Every tensor is loaded fresh (its own storage, contiguous) onto the
        device of the template's tensor at the same place.  Containers come
        back new; a module of the template is filled in place — each
        parameter is rebound to its loaded tensor — and returned.  The step
        is verified (manifest + checksums) before anything is read."""
        step = self._resolve_step(step)
        index = self._index(step)
        saved, wanted = _index_shape(index["tree"]), _template_shape(state_like, self.shard)
        if saved != wanted:
            raise ValueError(
                f"checkpoint step {step} does not match the restore template at "
                f"{_first_difference(saved, wanted)}"
            )
        reader = _Reader(self.step_dir(step), self.shard.cut if self.shard is not None else None)

        def fill(node: Dict[str, Any], like: Any, path: str = "") -> Any:
            if isinstance(like, torch.nn.Module):
                tree = fill(node["tree"], _module_tree(like), path)
                params = dict(like.named_parameters())

                def rebind(sub: Any, prefix: str) -> None:
                    for key, value in sub.items():
                        if isinstance(value, dict):
                            rebind(value, f"{prefix}{key}.")
                        else:
                            params[prefix + key].data = value

                with torch.no_grad():
                    rebind(tree, "")
                return like
            if isinstance(like, torch.Tensor):
                return reader.tensor(node, like.device, path)
            if isinstance(like, dict):
                saved = dict(node["dict"])
                return {k: fill(saved[k], v, _join(path, k)) for k, v in like.items()}
            if isinstance(like, (list, tuple)):
                kind = "tuple" if isinstance(like, tuple) else "list"
                items = [fill(v, x, _join(path, i)) for i, (v, x) in enumerate(zip(node[kind], like))]
                return tuple(items) if isinstance(like, tuple) else items
            return node["value"]

        return fill(index["tree"], state_like)

    def restore_params(self, step: Optional[int] = None, device: Any = "cuda", leaf_fn: Any = None) -> Any:
        """Template-free restore of the ``params`` subtree only, onto
        ``device`` (``cuda`` by default, like every entry point; no card
        raises, never falls back to the CPU).

        Serving must not depend on reconstructing the *training* run's
        opt-state structure: the saved index names the params' module
        class, and only the params' tensor files are read.  Same
        verify-first contract as :meth:`restore`: every file of the step
        is checksummed before any is loaded.  ``leaf_fn(path, tensor)``
        (one rank of a sharded replica) maps each tensor file and cuts it
        (``path`` like ``layers/wq``) before its slice is copied to
        ``device``: the rank reads only its part."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"restore_params onto {device} requested, but torch sees no CUDA device"
            )
        step = self._resolve_step(step)
        tree = self._index(step)["tree"]
        params = dict(tree.get("dict", ())).get("params")
        if params is None:
            raise CheckpointCorrupt(f"{self.step_dir(step)}: the saved tree holds no 'params'")
        return _Reader(self.step_dir(step), leaf_fn).build(params, device)

    def params_ref(self, step: int) -> Any:
        """Verify ``step`` and name it for the ranks of a sharded replica
        (``serving/sharded.py::CheckpointParams``): each reads its own
        slice, so no process holds the whole tree."""
        from tpu_nexus_torch.serving.sharded import CheckpointParams

        step = self._resolve_step(step)
        return CheckpointParams(self.directory, step)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def uri_for(self, step: int) -> str:
        return f"{self.directory}/{step}"

    def close(self) -> None:
        """Nothing to release: no handle outlives a call."""
