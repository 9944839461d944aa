"""Checkpoint store backends: the port's copy of
``tpu_nexus/checkpoint/store.py`` (the port imports nothing of the JAX
package, so it keeps its own copy of the ledger backends it needs).

Equivalent of nexus-core pkg/checkpoint/request `CqlStore` as consumed at
reference app/app_dependencies.go:18-34 and services/supervisor.go:264,301
(SURVEY.md §2.3).  Contract:

  * `read_checkpoint(algorithm, id)` -> row or None;
  * `upsert_checkpoint(cp)` writes the full row (last-write-wins upsert,
    CQL semantics);
  * construction is LAZY — building a store against an unreachable backend
    must not fail until the first query (the reference test constructs
    against 127.0.0.1 unconditionally, services/supervisor_test.go:36-39);
  * secondary lookups by tag / received_by_host / lifecycle_stage mirror the
    reference's secondary indexes (test-resources/checkpoints.cql:25-29).

Backends:
  * InMemoryCheckpointStore — tests and the fake-cluster topology;
  * SqliteCheckpointStore  — durable single-file store for local runs;
  * ScyllaCqlStore / AstraCqlStore — real CQL cluster via the pure-python
    wire client in tpu_nexus_torch.checkpoint.cql (lazy session).

Stores are plain last-write-wins (CQL upsert semantics, reference parity);
lifecycle-transition guarding (IsFinished + the stage partial order) lives
in the supervisor's commit path, not here.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, List, Optional, Tuple

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest

_COLUMNS = [
    "algorithm",
    "id",
    "lifecycle_stage",
    "payload_uri",
    "result_uri",
    "algorithm_failure_cause",
    "algorithm_failure_details",
    "received_by_host",
    "received_at",
    "sent_at",
    "applied_configuration",
    "configuration_overrides",
    "content_hash",
    "last_modified",
    "tag",
    "api_version",
    "job_uid",
    "parent",
    "payload_valid_for",
    "hlo_trace_ref",
    "per_chip_steps",
    "tensor_checkpoint_uri",
    "restart_count",
    "preempted_generation",
    "max_restarts",
]

#: extension columns added after the first shipped schema, in the order they
#: shipped — upgraded stores migrate existing tables by ALTERing these in
#: (sqlite does it automatically on open; CQL via ``migrate_schema``, see
#: cql.CqlCheckpointStore.migrate_schema and docs/RUNBOOK.md)
_MIGRATED_COLUMNS = ["preempted_generation", "max_restarts"]

_INT_COLUMNS = {"restart_count", "max_restarts"}


class CheckpointStoreError(Exception):
    pass


def _normalize_sql_value(value):
    """Bind the same representations ``to_row()`` produces — sqlite3's
    implicit datetime adapter is deprecated (removal slated) and dicts
    aren't bindable at all.  Shared by every sqlite write path so CAS
    conditions always compare the representation upsert stored."""
    import json
    from datetime import datetime

    if isinstance(value, datetime):
        return value.isoformat()
    if isinstance(value, dict):
        return json.dumps(value, sort_keys=True)
    return value


def _validate_field_names(fields: Dict[str, object]) -> None:
    """Shared update_fields guard: every backend must reject per_chip_steps
    (concurrent hosts merge it) and unknown columns — a typo'd key must fail
    identically against the in-memory test store and production CQL."""
    if "per_chip_steps" in fields:
        raise ValueError("use merge_chip_steps for per_chip_steps")
    for key in fields:
        if key not in _COLUMNS:
            raise ValueError(f"unknown column {key!r}")


def _validate_cas_args(expected: Dict[str, object], fields: Dict[str, object]) -> None:
    """Shared compare_and_set guard.  Empty ``fields`` is rejected in EVERY
    backend: the backends used to disagree on it (CQL/sqlite said True
    without touching the row, in-memory verified existence), so a caller
    probing existence via an empty CAS got backend-dependent answers — the
    contract is now uniform and explicit (use read_checkpoint to probe)."""
    _validate_field_names(fields)
    _validate_field_names(expected)  # per_chip_steps is merge-only: not comparable
    if not fields:
        raise ValueError("compare_and_set requires at least one field to write")


class CheckpointStore:
    """Abstract store interface (sync; the supervisor hot path wraps calls
    in the actor's worker, and CQL/sqlite calls are fast or offloaded)."""

    def read_checkpoint(self, algorithm: str, id: str) -> Optional[CheckpointedRequest]:
        raise NotImplementedError

    def upsert_checkpoint(self, cp: CheckpointedRequest) -> None:
        raise NotImplementedError

    def query_by_stage(self, stage: str) -> List[CheckpointedRequest]:
        raise NotImplementedError

    def query_by_tag(self, tag: str) -> List[CheckpointedRequest]:
        raise NotImplementedError

    def query_by_host(self, host: str) -> List[CheckpointedRequest]:
        raise NotImplementedError

    def merge_chip_steps(self, algorithm: str, id: str, steps: Dict[str, int]) -> None:
        """Merge per-chip heartbeat counters into the row WITHOUT a full-row
        read-modify-write: N hosts heartbeat one run concurrently and each
        owns only its own ``host<i>/chip<j>`` keys — a whole-row RMW would let
        host A's write clobber host B's keys.  Backends override with an
        atomic per-key update (CQL map append; sqlite single-column txn);
        this default is only safe single-writer."""
        cp = self.read_checkpoint(algorithm, id)
        if cp is None:
            return
        cp = cp.deep_copy()
        cp.per_chip_steps.update(steps)
        self.upsert_checkpoint(cp)

    def update_fields(self, algorithm: str, id: str, fields: Dict[str, object]) -> None:
        """Column-level update (never touches columns not named — in
        particular never rewrites ``per_chip_steps``, which concurrent hosts
        are merging).  Backends override with a real partial write; this
        default RMW is only safe single-writer."""
        _validate_field_names(fields)
        cp = self.read_checkpoint(algorithm, id)
        if cp is None:
            return
        cp = cp.deep_copy()
        for key, value in fields.items():
            setattr(cp, key, value)
        self.upsert_checkpoint(cp)

    def compare_and_set(
        self,
        algorithm: str,
        id: str,
        expected: Dict[str, object],
        fields: Dict[str, object],
    ) -> bool:
        """Atomically apply ``fields`` iff every ``expected`` column still
        holds the given value; returns False (nothing written) on mismatch
        or missing row.  The supervisor's lifecycle commits ride this so two
        replicas observing one event storm cannot double-apply a transition
        (the chart's own ``replicas:`` knob scales past one at ~1000 pods —
        reference .helm/values.yaml:124-125).  Backends override with a real
        atomic primitive (CQL lightweight transaction ``UPDATE … IF``,
        sqlite conditioned UPDATE); this default check-then-write is only
        safe single-writer."""
        _validate_cas_args(expected, fields)
        cp = self.read_checkpoint(algorithm, id)
        if cp is None:
            return False
        for key, value in expected.items():
            if getattr(cp, key) != value:
                return False
        self.update_fields(algorithm, id, fields)
        return True

    def close(self) -> None:
        pass


class InMemoryCheckpointStore(CheckpointStore):
    """Thread-safe in-memory store; the test/fake-cluster backend."""

    def __init__(self) -> None:
        self._rows: Dict[Tuple[str, str], CheckpointedRequest] = {}
        self._lock = threading.Lock()

    def read_checkpoint(self, algorithm: str, id: str) -> Optional[CheckpointedRequest]:
        with self._lock:
            cp = self._rows.get((algorithm, id))
            return cp.deep_copy() if cp is not None else None

    def upsert_checkpoint(self, cp: CheckpointedRequest) -> None:
        with self._lock:
            self._rows[(cp.algorithm, cp.id)] = cp.deep_copy()

    def _query(self, pred) -> List[CheckpointedRequest]:  # noqa: ANN001
        with self._lock:
            return [cp.deep_copy() for cp in self._rows.values() if pred(cp)]

    def query_by_stage(self, stage: str) -> List[CheckpointedRequest]:
        return self._query(lambda cp: cp.lifecycle_stage == stage)

    def query_by_tag(self, tag: str) -> List[CheckpointedRequest]:
        return self._query(lambda cp: cp.tag == tag)

    def query_by_host(self, host: str) -> List[CheckpointedRequest]:
        return self._query(lambda cp: cp.received_by_host == host)

    def merge_chip_steps(self, algorithm: str, id: str, steps: Dict[str, int]) -> None:
        with self._lock:
            cp = self._rows.get((algorithm, id))
            if cp is not None:
                cp.per_chip_steps.update(steps)

    def update_fields(self, algorithm: str, id: str, fields: Dict[str, object]) -> None:
        _validate_field_names(fields)
        with self._lock:
            cp = self._rows.get((algorithm, id))
            if cp is not None:
                for key, value in fields.items():
                    setattr(cp, key, value)

    def compare_and_set(
        self,
        algorithm: str,
        id: str,
        expected: Dict[str, object],
        fields: Dict[str, object],
    ) -> bool:
        _validate_cas_args(expected, fields)
        with self._lock:
            cp = self._rows.get((algorithm, id))
            if cp is None:
                return False
            for key, value in expected.items():
                if getattr(cp, key) != value:
                    return False
            for key, value in fields.items():
                setattr(cp, key, value)
            return True


class SqliteCheckpointStore(CheckpointStore):
    """Durable single-file store (local/dev runs without a CQL cluster).

    Lazy: the file is opened on first query, honoring the store contract.
    """

    def __init__(self, path: str) -> None:
        self._path = path
        self._conn: Optional[sqlite3.Connection] = None
        self._lock = threading.Lock()

    def _connection(self) -> sqlite3.Connection:
        if self._conn is None:
            conn = sqlite3.connect(self._path, check_same_thread=False)
            # WAL + NORMAL: one fsync per batch instead of two per commit —
            # measured 12x on the 1000-run latency storm (PERF.md).  Commits
            # survive process crashes; an OS/power crash may lose the tail,
            # which matches this store's role (the durable production ledger
            # is Scylla/CQL; sqlite is the single-node/CI stand-in)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            cols = ", ".join(
                f"{c} INTEGER" if c in _INT_COLUMNS else f"{c} TEXT" for c in _COLUMNS
            )
            conn.execute(
                f"CREATE TABLE IF NOT EXISTS checkpoints ({cols}, PRIMARY KEY (algorithm, id))"
            )
            # migrate a pre-upgrade ledger.db in place: CREATE IF NOT EXISTS
            # keeps an existing table's old column set, while every SELECT /
            # INSERT here names the full current set — without this, all
            # reads and writes error out after an upgrade until the table is
            # manually altered (ADVICE r4)
            have = {row[1] for row in conn.execute("PRAGMA table_info(checkpoints)")}
            for col in _MIGRATED_COLUMNS:
                if col not in have:
                    col_type = "INTEGER" if col in _INT_COLUMNS else "TEXT"
                    conn.execute(f"ALTER TABLE checkpoints ADD COLUMN {col} {col_type}")
            for idx_col in ("tag", "received_by_host", "lifecycle_stage"):
                conn.execute(
                    f"CREATE INDEX IF NOT EXISTS idx_{idx_col} ON checkpoints ({idx_col})"
                )
            conn.commit()
            self._conn = conn
        return self._conn

    def read_checkpoint(self, algorithm: str, id: str) -> Optional[CheckpointedRequest]:
        with self._lock:
            cur = self._connection().execute(
                f"SELECT {', '.join(_COLUMNS)} FROM checkpoints WHERE algorithm=? AND id=?",
                (algorithm, id),
            )
            row = cur.fetchone()
        if row is None:
            return None
        return CheckpointedRequest.from_row(dict(zip(_COLUMNS, row)))

    def upsert_checkpoint(self, cp: CheckpointedRequest) -> None:
        row = cp.to_row()
        values = [row[c] for c in _COLUMNS]
        placeholders = ", ".join("?" for _ in _COLUMNS)
        with self._lock:
            conn = self._connection()
            conn.execute(
                f"INSERT OR REPLACE INTO checkpoints ({', '.join(_COLUMNS)}) VALUES ({placeholders})",
                values,
            )
            conn.commit()

    def _query(self, column: str, value: str) -> List[CheckpointedRequest]:
        with self._lock:
            cur = self._connection().execute(
                f"SELECT {', '.join(_COLUMNS)} FROM checkpoints WHERE {column}=?", (value,)
            )
            rows = cur.fetchall()
        return [CheckpointedRequest.from_row(dict(zip(_COLUMNS, r))) for r in rows]

    def query_by_stage(self, stage: str) -> List[CheckpointedRequest]:
        return self._query("lifecycle_stage", stage)

    def query_by_tag(self, tag: str) -> List[CheckpointedRequest]:
        return self._query("tag", tag)

    def query_by_host(self, host: str) -> List[CheckpointedRequest]:
        return self._query("received_by_host", host)

    def merge_chip_steps(self, algorithm: str, id: str, steps: Dict[str, int]) -> None:
        import json

        with self._lock:
            conn = self._connection()
            # IMMEDIATE: take the write lock before reading so two hosts'
            # merge transactions serialize instead of clobbering
            conn.execute("BEGIN IMMEDIATE")
            try:
                cur = conn.execute(
                    "SELECT per_chip_steps FROM checkpoints WHERE algorithm=? AND id=?",
                    (algorithm, id),
                )
                row = cur.fetchone()
                if row is None:
                    return
                current = json.loads(row[0]) if row[0] else {}
                current.update(steps)
                conn.execute(
                    "UPDATE checkpoints SET per_chip_steps=? WHERE algorithm=? AND id=?",
                    (json.dumps(current, sort_keys=True), algorithm, id),
                )
            finally:
                conn.commit()

    def update_fields(self, algorithm: str, id: str, fields: Dict[str, object]) -> None:
        _validate_field_names(fields)
        if not fields:
            return
        sets = ", ".join(f"{k}=?" for k in fields)
        with self._lock:
            conn = self._connection()
            conn.execute(
                f"UPDATE checkpoints SET {sets} WHERE algorithm=? AND id=?",
                [*(_normalize_sql_value(v) for v in fields.values()), algorithm, id],
            )
            conn.commit()

    def compare_and_set(
        self,
        algorithm: str,
        id: str,
        expected: Dict[str, object],
        fields: Dict[str, object],
    ) -> bool:
        """One conditioned UPDATE: sqlite serializes writers, so rowcount
        tells atomically whether every expected column still matched."""
        _validate_cas_args(expected, fields)
        sets = ", ".join(f"{k}=?" for k in fields)
        conds = " AND ".join(f"{k}=?" for k in expected) or "1=1"
        with self._lock:
            conn = self._connection()
            cur = conn.execute(
                f"UPDATE checkpoints SET {sets} WHERE algorithm=? AND id=? AND {conds}",
                [
                    *(_normalize_sql_value(v) for v in fields.values()),
                    algorithm,
                    id,
                    *(_normalize_sql_value(v) for v in expected.values()),
                ],
            )
            conn.commit()
            return cur.rowcount == 1

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
