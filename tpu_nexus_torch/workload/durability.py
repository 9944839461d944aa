"""Checkpoint durability: manifests, commit markers, verification, rollback —
a copy of ``tpu_nexus/workload/durability.py`` for the PyTorch port.

The manifest and commit-marker format is the JAX package's, byte for
byte: either package resolves and verifies a step directory the other
wrote (the supervisor, which stays the JAX package's, reads the port's
checkpoints through this format).

The restart-from-step contract (``tensor_checkpoint_uri``) is only as
trustworthy as the checkpoint it points at: a save may still be in flight
when the ledger write happens, a crash can land between the payload write
and the metadata flush, and silent media corruption flips bits in
committed leaves.  This module is the trust anchor — checksummed,
decoupled checkpoint commits over a plain filesystem:

* **manifest** — one JSON file per step directory listing every file's
  byte size and SHA-256.  Written temp → fsync → rename, so its *presence*
  is the commit marker: a step directory without ``_NEXUS_MANIFEST.json``
  was never durably committed.
* **verification** — re-reads every manifested file and recomputes the
  checksums; failures classify into :class:`CheckpointMissing` /
  :class:`CheckpointUncommitted` / :class:`CheckpointCorrupt` so callers
  (and the supervisor) can tell "nothing there" from "torn save" from
  "bit rot" — each drives a different recovery.
* **rollback** — :func:`newest_verified_step` walks steps newest-first,
  optionally quarantining bad ones (rename to ``<step>.corrupt``) so the
  restart restores the newest *provably good* step instead of crashing or
  silently loading garbage.

Deliberately stdlib-only: watchdogs and pollers import this (via
:func:`resolve_verified_uri`) and must not pay the torch import.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

#: the commit marker: a step directory is committed iff this file exists
#: (and verifiable iff its contents match the bytes on disk)
MANIFEST_NAME = "_NEXUS_MANIFEST.json"
#: suffix a quarantined step directory is renamed to — non-numeric, so
#: :func:`list_steps` (every step scan of the port) ignores it while the
#: bytes stay on disk for postmortems
QUARANTINE_SUFFIX = ".corrupt"
#: suffix for steps set aside by a HEALTH rollback (workload/health.py):
#: the bytes are intact and verified — they are just on the abandoned
#: (poisoned-window) trajectory, and a re-commit of the same step number
#: must land the retrained weights, not these.  Distinct from ``.corrupt``
#: so a postmortem can tell bit rot from a divergence recovery.
ABANDONED_SUFFIX = ".abandoned"

MANIFEST_FORMAT = 1


class CheckpointError(RuntimeError):
    """Base for classified checkpoint-durability failures.

    ``cause`` is the stable machine token recorded in metrics tags and
    ledger details — subclasses override it."""

    cause = "checkpoint-error"


class CheckpointMissing(CheckpointError, FileNotFoundError):
    """No step directory at all (empty/fresh directory, or the requested
    step does not exist).  Recovery: start from scratch.  Doubles as
    ``FileNotFoundError`` for callers holding the pre-durability contract."""

    cause = "missing"


class CheckpointUncommitted(CheckpointError):
    """The step directory exists but carries no commit marker — a torn
    save (crash/preemption between the data write and the manifest
    commit).  Recovery: roll back to the previous committed step."""

    cause = "uncommitted"


class CheckpointCorrupt(CheckpointError):
    """The commit marker exists but the bytes do not match it (bit flip,
    truncation, missing file, unreadable manifest).  Recovery: quarantine
    and roll back."""

    cause = "corrupt"


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest()


def _fsync_dir(path: str) -> None:
    """Flush a directory entry (the rename) to stable storage; best-effort
    on filesystems that reject O_RDONLY dir fsync (notably some network
    mounts — there the payload fsyncs still hold)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - unopenable dir (permissions)
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - fs without dir fsync
        pass
    finally:
        os.close(fd)


def manifest_files(step_dir: str) -> List[str]:
    """Relative (posix) paths of every payload file under ``step_dir`` —
    everything except the manifest itself and its temp."""
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(step_dir):
        dirnames.sort()
        for name in sorted(filenames):
            if name == MANIFEST_NAME or name.startswith(MANIFEST_NAME + "."):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), step_dir)
            out.append(rel.replace(os.sep, "/"))
    return out


def build_manifest(step_dir: str, step: int) -> Dict[str, Any]:
    """Checksum every payload file of a finished save.  Callers must have
    waited for the async save first (the durability barrier owns that)."""
    files: Dict[str, Dict[str, Any]] = {}
    total = 0
    for rel in manifest_files(step_dir):
        path = os.path.join(step_dir, rel)
        size = os.path.getsize(path)
        files[rel] = {"bytes": size, "sha256": _sha256_file(path)}
        total += size
    return {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "file_count": len(files),
        "total_bytes": total,
        "files": files,
    }


def write_manifest_temp(step_dir: str, manifest: Dict[str, Any]) -> str:
    """Stage the manifest next to its payload: write + flush + fsync the
    TEMP file.  The step is still *uncommitted* after this returns — only
    :func:`commit_manifest`'s rename publishes it."""
    tmp = os.path.join(step_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    return tmp


def commit_manifest(step_dir: str) -> str:
    """Atomically publish the staged manifest (rename) and flush the
    directory entry.  After this returns the step is committed."""
    tmp = os.path.join(step_dir, MANIFEST_NAME + ".tmp")
    marker = os.path.join(step_dir, MANIFEST_NAME)
    os.rename(tmp, marker)
    _fsync_dir(step_dir)
    return marker


def verify_step(
    step_dir: str, step: Optional[int] = None, deep: bool = True
) -> Dict[str, Any]:
    """Prove a step directory is committed AND checksum-clean; returns the
    manifest.  Raises the classified errors otherwise (never returns a
    half-truth — an unreadable manifest is corruption, not absence).

    ``deep=False`` skips the checksum recompute and verifies structure
    only (marker present, manifest parses, every manifested file present
    at its manifested size) — for the commit-side read-back, where the
    manifest was just built from a full hash pass and a second pass would
    re-read the page cache, not the media."""
    if not os.path.isdir(step_dir):
        raise CheckpointMissing(f"no checkpoint step directory at {step_dir}")
    marker = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.isfile(marker):
        raise CheckpointUncommitted(
            f"{step_dir} has no commit marker ({MANIFEST_NAME}) — torn save"
        )
    try:
        with open(marker, "r", encoding="utf-8") as fh:
            manifest = json.load(fh)
        # coerce the full shape HERE, inside the classified catch: a
        # manifest that parses as JSON but is wrong-shaped (files as a
        # list, a file entry as a string, a non-numeric size) is
        # corruption like any other — it must never escape as a raw
        # TypeError/AttributeError past the CheckpointError contract
        entries = sorted(
            (str(rel), int(meta["bytes"]), str(meta["sha256"]))
            for rel, meta in manifest["files"].items()
        )
    except (OSError, ValueError, KeyError, TypeError, AttributeError) as exc:
        if isinstance(exc, OSError) and not os.path.isdir(step_dir):
            # the directory was quarantine-renamed between the isdir check
            # above and the open — classify as Missing (the tolerated race),
            # never leak a raw OSError past the CheckpointError contract
            raise CheckpointMissing(
                f"{step_dir} vanished mid-verification (concurrent quarantine)"
            ) from exc
        raise CheckpointCorrupt(f"{step_dir}: unreadable manifest: {exc}") from exc
    if step is not None and manifest.get("step") != int(step):
        raise CheckpointCorrupt(
            f"{step_dir}: manifest claims step {manifest.get('step')!r}, "
            f"directory holds step {step}"
        )
    for rel, expected_bytes, expected_sha in entries:
        path = os.path.join(step_dir, rel)
        try:
            if not os.path.isfile(path):
                raise CheckpointCorrupt(
                    f"{step_dir}: manifested file {rel} is missing"
                )
            size = os.path.getsize(path)
            if size != expected_bytes:
                raise CheckpointCorrupt(
                    f"{step_dir}: {rel} is {size} bytes, manifest says {expected_bytes}"
                )
            if not deep:
                continue
            digest = _sha256_file(path)
        except OSError as exc:
            # raw stat/read failures must classify, not leak: the rollback
            # scan and the watchdog resolver catch only CheckpointError.
            # A step directory quarantine-renamed mid-walk by another host
            # is the tolerated race (Missing); anything else is corruption.
            if not os.path.isdir(step_dir):
                raise CheckpointMissing(
                    f"{step_dir} vanished mid-verification (concurrent quarantine)"
                ) from exc
            raise CheckpointCorrupt(f"{step_dir}: {rel} unreadable: {exc}") from exc
        if digest != expected_sha:
            raise CheckpointCorrupt(
                f"{step_dir}: {rel} checksum mismatch "
                f"({digest[:12]}… != manifest {expected_sha[:12]}…)"
            )
    return manifest


def list_steps(directory: str) -> List[int]:
    """Ascending step numbers with a directory present.  Only all-digit
    names count: a quarantined, abandoned or half-written (temporary) step
    directory is never listed."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.isdigit() and os.path.isdir(os.path.join(directory, name)):
            steps.append(int(name))
    return sorted(steps)


def _set_step_aside(directory: str, step: int, suffix: str) -> str:
    """Rename ``<step>`` to ``<step><suffix>`` (``<suffix>-N`` on repeat
    incidents) so no step scan ever offers it again; returns the new path.
    The bytes stay for postmortems — evidence preservation, not deletion."""
    src = os.path.join(directory, str(step))
    dst = src + suffix
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}{suffix}-{n}"
    try:
        os.rename(src, dst)
    except FileNotFoundError:
        # another host's rename won the race — the step is out of the step
        # scan either way, which is all that matters
        return dst
    _fsync_dir(directory)
    return dst


def quarantine_step(directory: str, step: int) -> str:
    """Quarantine a torn/corrupt step as ``<step>.corrupt``."""
    return _set_step_aside(directory, step, QUARANTINE_SUFFIX)


def abandon_step(directory: str, step: int) -> str:
    """Set aside a VERIFIED step that sits on an abandoned trajectory
    (health rollback skipped the data window it was trained on) as
    ``<step>.abandoned`` — the retrained run will re-commit the same step
    numbers with different weights, and the old bytes must neither shadow
    the re-save (a save refuses an existing step) nor ever be restored as if
    they were on the new schedule."""
    return _set_step_aside(directory, step, ABANDONED_SUFFIX)


def newest_verified_step(
    directory: str, quarantine: bool = True, before: Optional[int] = None
) -> "tuple[Optional[int], List[Dict[str, Any]]]":
    """Newest step that verifies, rolling past torn/corrupt ones.

    Returns ``(step, rollbacks)`` where ``rollbacks`` records every bad
    step skipped on the way down — ``{"step", "cause", "detail",
    "quarantined_to"}`` — newest first, for metrics/ledger reporting.
    ``step`` is None when nothing verifies (fresh directory, or every step
    bad).  With ``quarantine=False`` bad steps are skipped but left in
    place (read-only consumers: serving, the watchdog resolver).

    ``before`` restricts the scan to steps < ``before`` — the health
    rollback's constraint that the restored checkpoint must predate the
    poisoned data window.  Newer steps are neither verified nor
    quarantined here (they may be perfectly healthy; abandoning them is
    the RECOVERY's explicit, separate act)."""
    rollbacks: List[Dict[str, Any]] = []
    steps = list_steps(directory)
    if before is not None:
        steps = [s for s in steps if s < before]
    for step in reversed(steps):
        step_dir = os.path.join(directory, str(step))
        try:
            verify_step(step_dir, step)
            return step, rollbacks
        except (CheckpointMissing, CheckpointUncommitted, CheckpointCorrupt) as exc:
            # CheckpointMissing here means the directory vanished between
            # list_steps and verify_step — another host's quarantine rename
            # won a race this scan must tolerate, not crash on
            event = {"step": step, "cause": exc.cause, "detail": str(exc)}
            if quarantine and not isinstance(exc, CheckpointMissing):
                event["quarantined_to"] = quarantine_step(directory, step)
            logger.warning(
                "checkpoint step %d failed verification (%s); rolling back%s",
                step,
                exc.cause,
                (
                    f" — quarantined to {event['quarantined_to']}"
                    if "quarantined_to" in event
                    else ""
                ),
            )
            rollbacks.append(event)
    return None, rollbacks


def write_json_sidecar(step_dir: str, name: str, payload: Dict[str, Any]) -> str:
    """Stage a small JSON sidecar (e.g. the data-cursor state) next to a
    step's payload with the same temp → fsync → rename discipline as the
    manifest.  MUST run after the async save finalized (the step directory
    exists under its final name) and BEFORE :func:`commit_manifest` — the
    manifest then checksums the sidecar like any other payload file, so a
    tampered cursor fails verification exactly like a tampered tensor."""
    path = os.path.join(step_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.rename(tmp, path)
    return path


def read_json_sidecar(step_dir: str, name: str) -> Optional[Dict[str, Any]]:
    """Read a sidecar back; None when the step predates the sidecar (the
    fast-forward fallback), classified :class:`CheckpointCorrupt` when the
    bytes exist but do not parse — a caller holding a VERIFIED step should
    never see that, so surfacing it loudly beats a silent schedule drift."""
    path = os.path.join(step_dir, name)
    if not os.path.isfile(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as fh:
            loaded = json.load(fh)
        if not isinstance(loaded, dict):
            raise ValueError(f"sidecar is {type(loaded).__name__}, expected object")
        return loaded
    except (OSError, ValueError) as exc:
        raise CheckpointCorrupt(f"{step_dir}: unreadable sidecar {name}: {exc}") from exc


def adopt_unmanifested_steps(directory: str) -> List[int]:
    """Upgrade migration: commit a manifest for every step directory that
    has none, trusting the bytes currently on disk.

    Pre-durability releases wrote steps with no manifest — to this layer
    they are indistinguishable from torn saves, so an UN-migrated restart
    would quarantine every one of them and start training from scratch.
    Run this once per checkpoint directory before the first restart under
    the durability release (docs/RUNBOOK.md §11)::

        python -m tpu_nexus_torch.workload.durability adopt <checkpoint-dir>

    Deliberately explicit and NEVER automatic: under the new protocol a
    missing manifest means a torn save, and auto-adopting torn bytes as
    truth would gut the exact guarantee the commit marker exists for.
    Adoption only fills the integrity baseline for steps written before
    the marker existed — it cannot prove those bytes are complete."""
    adopted: List[int] = []
    for step in list_steps(directory):
        step_dir = os.path.join(directory, str(step))
        if os.path.isfile(os.path.join(step_dir, MANIFEST_NAME)):
            continue
        write_manifest_temp(step_dir, build_manifest(step_dir, step))
        commit_manifest(step_dir)
        verify_step(step_dir, step)
        logger.info("adopted pre-durability checkpoint step %d", step)
        adopted.append(step)
    return adopted


def resolve_verified_uri(uri: str) -> Optional[str]:
    """Watchdog hook: map a ledger ``tensor_checkpoint_uri`` (``<dir>/<step>``)
    to the newest VERIFIED uri under the same directory.

    Returns ``uri`` unchanged when it verifies, the newest verified
    sibling step's uri when it does not (restart-from-previous-step), and
    None when the uri is unparseable or nothing under the directory
    verifies.  Never quarantines — the workload's restore path owns
    mutation; the watchdog only repoints the ledger."""
    directory, _, step_s = uri.rstrip("/").rpartition("/")
    if not directory or not step_s.isdigit():
        return None
    try:
        verify_step(os.path.join(directory, step_s), int(step_s))
        return uri
    except CheckpointError:
        step, _ = newest_verified_step(directory, quarantine=False)
        return f"{directory}/{step}" if step is not None else None


class CachingUriResolver:
    """Memoizing wrapper around :func:`resolve_verified_uri` for
    sweep-cadence callers: the watchdog re-checks every PREEMPTED row every
    sweep, and an uncached deep verify re-reads and re-hashes the whole
    checkpoint each time (tens of seconds of I/O per sweep on a large
    step, forever, per parked row).

    A POSITIVE verification is cached against the commit marker's identity
    ``(mtime_ns, size)`` — same marker, same verdict, for the cost of one
    ``stat``.  A NEGATIVE verdict (nothing under the directory verifies —
    all steps torn/corrupt, or pre-durability and never adopted) is cached
    against a fingerprint of the directory's step entries and their marker
    identities: any commit, adoption, or quarantine changes the
    fingerprint and re-triggers a real scan, so a parked unverifiable row
    costs a ``listdir`` + ``stat``s per sweep instead of a full re-hash of
    every step, forever.  The trade-off is explicit both ways: corruption
    (or repair) arriving while the markers stay byte-identical is not
    re-detected here; the workload's own restore path still deep-verifies
    before any bytes are trusted."""

    #: cap on remembered entries (one per unique step dir / directory);
    #: arbitrary eviction beyond it — correctness never depends on a hit
    max_entries = 1024

    def __init__(self, resolve=resolve_verified_uri) -> None:
        self._resolve = resolve
        self._verified: Dict[str, "tuple[int, int]"] = {}
        self._unverifiable: Dict[str, tuple] = {}

    def _marker_id(self, step_dir: str) -> "Optional[tuple[int, int]]":
        try:
            st = os.stat(os.path.join(step_dir, MANIFEST_NAME))
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def _dir_fingerprint(self, directory: str) -> tuple:
        try:
            names = os.listdir(directory)
        except OSError:
            return ()
        return tuple(sorted(
            (name, self._marker_id(os.path.join(directory, name)))
            for name in names
            if name.isdigit()
        ))

    def _remember(self, cache: Dict[str, Any], key: str, value: Any) -> None:
        if len(cache) >= self.max_entries:
            cache.pop(next(iter(cache)))
        cache[key] = value

    def __call__(self, uri: str) -> Optional[str]:
        marker = self._marker_id(uri)
        if marker is not None and self._verified.get(uri) == marker:
            return uri
        directory = uri.rstrip("/").rpartition("/")[0]
        fingerprint = self._dir_fingerprint(directory) if directory else ()
        if fingerprint and self._unverifiable.get(directory) == fingerprint:
            return None
        resolved = self._resolve(uri)
        if resolved is not None:
            self._unverifiable.pop(directory, None)
            marker = self._marker_id(resolved)
            if marker is not None:
                self._remember(self._verified, resolved, marker)
        elif fingerprint:
            self._remember(self._unverifiable, directory, fingerprint)
        return resolved


class VerifiedStepPoller:
    """Cheap newest-verified-step polling for sweep-cadence consumers (the
    serving reload check, the fleet's checkpoint watcher): an uncached
    :func:`newest_verified_step` deep-verifies the newest step — a full
    re-hash of a multi-GB checkpoint — on EVERY poll, forever.

    Same trade as :class:`CachingUriResolver`: the scan result is cached
    against a fingerprint of the directory's step entries and their commit
    markers' identity ``(mtime_ns, size)``.  Any commit, adoption, or
    quarantine changes the fingerprint and re-triggers a real scan, so a
    steady-state poll costs one ``listdir`` + ``stat``s.  Corruption
    arriving while the markers stay byte-identical is NOT re-detected here
    — the commit marker is the poll-side trust anchor, and the load side
    (``TensorCheckpointer.restore_params``) still deep-verifies before any
    bytes are trusted, so a poll-side false positive can never be served.

    ``quarantine=True`` hands the scan mutation rights (rename bad steps
    to ``<step>.corrupt``) — only for callers that OWN the directory; the
    default is the read-only contract serving already holds."""

    def __init__(self, directory: str, quarantine: bool = False) -> None:
        self.directory = directory
        self.quarantine = quarantine
        #: rollback events accumulated across scans (same record shape as
        #: :func:`newest_verified_step`) — callers report/clear
        self.rollbacks: List[Dict[str, Any]] = []
        self.scans = 0  # real (non-cached) scans, for tests/metrics
        self._fingerprint: Optional[tuple] = None
        self._last: Optional[int] = None

    def _dir_fingerprint(self) -> tuple:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return ()
        entries = []
        for name in names:
            if not name.isdigit():
                continue
            try:
                st = os.stat(os.path.join(self.directory, name, MANIFEST_NAME))
                marker = (st.st_mtime_ns, st.st_size)
            except OSError:
                marker = None
            entries.append((name, marker))
        return tuple(sorted(entries))

    def latest_verified_step(self) -> Optional[int]:
        """Newest verified step, re-scanned only when the directory's step
        entries / commit markers changed since the last poll.  The
        fingerprint is taken BEFORE the scan: renames the scan itself
        performs (quarantine) change the directory, so the next poll pays
        one redundant scan and then stabilizes — staleness is never
        possible, only one extra scan."""
        fp = self._dir_fingerprint()
        if fp == self._fingerprint:
            return self._last
        step, rollbacks = newest_verified_step(
            self.directory, quarantine=self.quarantine
        )
        self.rollbacks.extend(rollbacks)
        self.scans += 1
        self._fingerprint = fp
        self._last = step
        return step


def _main(argv: List[str]) -> int:
    """``python -m tpu_nexus_torch.workload.durability adopt <dir>`` — the
    one-command upgrade migration (stdlib-only, safe on any host)."""
    if len(argv) != 2 or argv[0] != "adopt":
        print("usage: python -m tpu_nexus_torch.workload.durability adopt <checkpoint-dir>")
        return 2
    logging.basicConfig(level=logging.INFO)
    adopted = adopt_unmanifested_steps(argv[1])
    print(f"adopted {len(adopted)} step(s): {adopted}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main(sys.argv[1:]))
