"""Pure-python CQL binary protocol (v4) client + checkpoint stores.

Equivalent of the reference's gocql/gocqlx-backed nexus-core
`request.NewScyllaCqlStore` / `request.NewAstraCqlStore`
(app/app_dependencies.go:18-34; SURVEY.md §2.3).  No cassandra driver is
available in this environment, so the wire protocol is implemented directly:
frame header (version/flags/stream/opcode/length), STARTUP/AUTH handshake
(SASL PLAIN), QUERY with inlined CQL literals, and RESULT(Rows) decoding for
the column types the checkpoint schema uses (text, int, bigint, timestamp,
map<text,bigint>).

Contract parity:
  * LAZY sessions — constructing a store against an unreachable host does
    not fail until the first query (reference supervisor_test.go:36-39);
  * reads/upserts target `nexus.checkpoints` (schema.cql in this package);
  * `AstraCqlStore` connects over TLS using the DataStax secure connect
    bundle (base64 zip: config.json + client cert/key + CA).
"""

from __future__ import annotations

import base64
import io
import json
import random
import socket
import ssl
import struct
import tempfile
import threading
import time
import zipfile
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest
from tpu_nexus_torch.core.util import backoff_jitter_s
from tpu_nexus_torch.checkpoint.store import (
    CheckpointStore,
    CheckpointStoreError,
    _COLUMNS,
    _INT_COLUMNS,
    _MIGRATED_COLUMNS,
    _validate_cas_args,
    _validate_field_names,
)
from tpu_nexus_torch.core.telemetry import VLogger, get_logger

# -- opcodes -------------------------------------------------------------------

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003
RESULT_SCHEMA_CHANGE = 0x0005

CONSISTENCY_ONE = 0x0001
CONSISTENCY_LOCAL_QUORUM = 0x0006

# column type option ids (protocol v4 §6.2.5)
TYPE_CUSTOM = 0x0000
TYPE_ASCII = 0x0001
TYPE_BIGINT = 0x0002
TYPE_BLOB = 0x0003
TYPE_BOOLEAN = 0x0004
TYPE_DOUBLE = 0x0007
TYPE_FLOAT = 0x0008
TYPE_INT = 0x0009
TYPE_TIMESTAMP = 0x000B
TYPE_UUID = 0x000C
TYPE_VARCHAR = 0x000D
TYPE_INET = 0x0010
TYPE_SMALLINT = 0x0013
TYPE_TINYINT = 0x0014
TYPE_LIST = 0x0020
TYPE_MAP = 0x0021
TYPE_SET = 0x0022


class CqlError(CheckpointStoreError):
    pass


class CqlConnectionError(CqlError):
    """Transport-level failure (connection lost/unreachable) — the only
    class of error worth a reconnect-and-retry."""


# -- primitive encoders (shared by client and the test fake server) ------------


def write_short(n: int) -> bytes:
    return struct.pack(">H", n)


def write_int(n: int) -> bytes:
    return struct.pack(">i", n)


def write_long(n: int) -> bytes:
    return struct.pack(">q", n)


def write_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return write_short(len(b)) + b


def write_long_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return write_int(len(b)) + b


def write_bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return write_int(-1)
    return write_int(len(b)) + b


def write_string_map(m: Dict[str, str]) -> bytes:
    out = write_short(len(m))
    for k, v in m.items():
        out += write_string(k) + write_string(v)
    return out


def encode_frame(opcode: int, body: bytes, stream: int = 0, response: bool = False) -> bytes:
    version = 0x84 if response else 0x04
    return struct.pack(">BBhBi", version, 0, stream, opcode, len(body)) + body


class _Reader:
    def __init__(self, data: bytes) -> None:
        self._d = data
        self._o = 0

    def read(self, n: int) -> bytes:
        if self._o + n > len(self._d):
            raise CqlError("truncated frame body")
        out = self._d[self._o : self._o + n]
        self._o += n
        return out

    def short(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def int(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def long(self) -> int:
        return struct.unpack(">q", self.read(8))[0]

    def string(self) -> str:
        return self.read(self.short()).decode("utf-8")

    def bytes(self) -> Optional[bytes]:
        n = self.int()
        if n < 0:
            return None
        return self.read(n)


def _read_type_option(r: _Reader) -> Tuple[int, Any]:
    type_id = r.short()
    if type_id == TYPE_CUSTOM:
        return type_id, r.string()
    if type_id in (TYPE_LIST, TYPE_SET):
        return type_id, _read_type_option(r)
    if type_id == TYPE_MAP:
        return type_id, (_read_type_option(r), _read_type_option(r))
    return type_id, None


def _decode_value(type_id: int, param: Any, data: Optional[bytes]) -> Any:
    if data is None:
        return None
    if type_id in (TYPE_ASCII, TYPE_VARCHAR, TYPE_CUSTOM):
        return data.decode("utf-8")
    if type_id == TYPE_BLOB:
        return data
    if type_id == TYPE_BOOLEAN:
        return data != b"\x00"
    if type_id == TYPE_INT:
        return struct.unpack(">i", data)[0]
    if type_id == TYPE_BIGINT:
        return struct.unpack(">q", data)[0]
    if type_id == TYPE_SMALLINT:
        return struct.unpack(">h", data)[0]
    if type_id == TYPE_TINYINT:
        return struct.unpack(">b", data)[0]
    if type_id == TYPE_DOUBLE:
        return struct.unpack(">d", data)[0]
    if type_id == TYPE_FLOAT:
        return struct.unpack(">f", data)[0]
    if type_id == TYPE_TIMESTAMP:
        ms = struct.unpack(">q", data)[0]
        return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
    if type_id == TYPE_UUID:
        import uuid as _uuid

        return str(_uuid.UUID(bytes=data))
    if type_id == TYPE_MAP:
        (ktype, kparam), (vtype, vparam) = param
        r = _Reader(data)
        n = r.int()
        out = {}
        for _ in range(n):
            k = _decode_value(ktype, kparam, r.bytes())
            v = _decode_value(vtype, vparam, r.bytes())
            out[k] = v
        return out
    if type_id in (TYPE_LIST, TYPE_SET):
        etype, eparam = param
        r = _Reader(data)
        return [_decode_value(etype, eparam, r.bytes()) for _ in range(r.int())]
    return data  # unknown: raw bytes


# -- CQL literal quoting (statements are built with inlined literals; no
#    prepared statements needed for the ledger's simple access pattern) --------


def quote_text(value: str) -> str:
    return "'" + str(value).replace("'", "''") + "'"


def to_literal(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return str(value)
    if isinstance(value, datetime):
        return quote_text(value.astimezone(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z")
    if isinstance(value, dict):
        return "{" + ", ".join(f"{to_literal(k)}: {to_literal(v)}" for k, v in sorted(value.items())) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(to_literal(v) for v in value) + "]"
    return quote_text(value)


# -- connection ----------------------------------------------------------------


class CqlConnection:
    """One synchronous CQL connection (thread-safe via a lock)."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._lock = threading.Lock()
        self._stream = 0

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise CqlConnectionError("connection closed by server")
            buf += chunk
        return buf

    def request(self, opcode: int, body: bytes) -> Tuple[int, bytes]:
        with self._lock:
            self._stream = (self._stream + 1) % 32768
            self._sock.sendall(encode_frame(opcode, body, stream=self._stream))
            while True:
                header = self._recv_exact(9)
                _, _, stream, resp_opcode, length = struct.unpack(">BBhBi", header)
                resp_body = self._recv_exact(length) if length else b""
                if stream == self._stream or stream < 0:
                    return resp_opcode, resp_body

    def startup(self, user: str = "", password: str = "") -> None:
        opcode, body = self.request(OP_STARTUP, write_string_map({"CQL_VERSION": "3.0.0"}))
        if opcode == OP_AUTHENTICATE:
            token = b"\x00" + user.encode() + b"\x00" + password.encode()
            opcode, body = self.request(OP_AUTH_RESPONSE, write_bytes(token))
            if opcode != OP_AUTH_SUCCESS:
                raise CqlError(f"authentication failed (opcode {opcode:#x})")
        elif opcode != OP_READY:
            raise CqlError(f"unexpected startup response (opcode {opcode:#x}): {body[:200]!r}")

    def query(self, cql: str, consistency: int = CONSISTENCY_ONE) -> List[Dict[str, Any]]:
        body = write_long_string(cql) + write_short(consistency) + b"\x00"
        opcode, resp = self.request(OP_QUERY, body)
        if opcode == OP_ERROR:
            r = _Reader(resp)
            code = r.int()
            message = r.string()
            raise CqlError(f"CQL error {code:#x}: {message}")
        if opcode != OP_RESULT:
            raise CqlError(f"unexpected response opcode {opcode:#x}")
        r = _Reader(resp)
        kind = r.int()
        if kind != RESULT_ROWS:
            return []
        flags = r.int()
        col_count = r.int()
        if flags & 0x0002:  # has_more_pages
            r.bytes()  # paging state (ledger queries never page in practice)
        global_spec = bool(flags & 0x0001)
        if global_spec:
            r.string()
            r.string()
        cols = []
        for _ in range(col_count):
            if not global_spec:
                r.string()
                r.string()
            name = r.string()
            type_id, param = _read_type_option(r)
            cols.append((name, type_id, param))
        row_count = r.int()
        rows = []
        for _ in range(row_count):
            row = {}
            for name, type_id, param in cols:
                row[name] = _decode_value(type_id, param, r.bytes())
            rows.append(row)
        return rows


# -- stores --------------------------------------------------------------------

_SELECT_COLS = ", ".join(_COLUMNS)


class CqlCheckpointStore(CheckpointStore):
    """Shared CQL-backed store logic; subclasses provide `_connect()`.

    Lazy: `_connect` runs on first query only.
    """

    table = "nexus.checkpoints"

    #: transient-error retry budget: reconnect-and-retry attempts AFTER the
    #: initial try (so max_retries=3 means up to 4 total attempts).  The
    #: ledger is the workload's only witness — a heartbeat or terminal-state
    #: write that dies on ONE dropped TCP connection while the server rolls
    #: (a routine Scylla restart) used to surface straight to the caller and
    #: kill the run the supervisor exists to keep honest.  Auth/protocol/
    #: query errors (plain CqlError) are definitive and never retry.
    max_retries = 3
    retry_base_s = 0.1
    retry_max_s = 2.0

    def __init__(self, logger: Optional[VLogger] = None) -> None:
        self._conn: Optional[CqlConnection] = None
        self._conn_lock = threading.Lock()
        self._log = logger or get_logger("tpu_nexus_torch.cql")
        #: injectable for tests (no wall-clock waits in the suite)
        self._sleep = time.sleep
        self._rng = random.Random()

    def _connect(self) -> CqlConnection:  # pragma: no cover - abstract
        raise NotImplementedError

    def _connection(self) -> CqlConnection:
        with self._conn_lock:
            if self._conn is None:
                self._conn = self._connect()
            return self._conn

    def _drop_connection(self) -> None:
        with self._conn_lock:
            if self._conn is not None:
                self._conn.close()
            self._conn = None

    def _execute(self, cql: str) -> List[Dict[str, Any]]:
        """Run one statement with bounded reconnect-retries for TRANSIENT
        (transport) failures: the shared ``core.util.backoff_jitter_s``
        shape (full jitter — a thundering herd of N hosts retrying a
        rolled coordinator in lockstep is its own outage), same as the
        serving engine's step-fault policy.  The first retry is immediate
        (the common case is one stale long-lived connection; the server
        is already back)."""
        attempt = 0
        while True:
            try:
                return self._connection().query(cql)
            except (OSError, CqlConnectionError) as exc:
                self._drop_connection()
                if attempt >= self.max_retries:
                    raise
                if attempt > 0:
                    self._sleep(
                        backoff_jitter_s(
                            attempt - 1, self.retry_base_s, self.retry_max_s, self._rng
                        )
                    )
                attempt += 1
                self._log.warning(
                    "transient CQL failure, retrying",
                    attempt=attempt, max_retries=self.max_retries, error=repr(exc),
                )

    def apply_schema(self, schema_cql: str) -> None:
        """Apply keyspace/table DDL (idempotent).

        Full-line ``--`` comments are stripped BEFORE splitting on ';' — a
        semicolon inside a comment must not truncate the next real statement
        or get comment text executed as CQL (the old split-then-skip order
        did both: schema.cql's own header comment orphaned the CREATE TABLE
        behind a garbage prefix).  Inline trailing comments are left alone —
        they are valid CQL and carry no semicolons."""
        sql = "\n".join(
            line for line in schema_cql.splitlines()
            if not line.lstrip().startswith("--")
        )
        for statement in sql.split(";"):
            statement = statement.strip()
            if statement:
                self._execute(statement)

    def migrate_schema(self) -> None:
        """Bring an EXISTING nexus.checkpoints table up to the current column
        set.  ``create table if not exists`` keeps a pre-upgrade table's old
        columns while this client SELECTs/INSERTs the full current set — so
        an upgraded store against an old table errors on every query until
        the table is altered (ADVICE r4).  CQL has no ``ADD COLUMN IF NOT
        EXISTS``, so each ALTER is attempted and an "already exists" /
        "Invalid column" error is treated as done; transport errors still
        propagate.  Run once per upgrade (Helm pre-install hook or by hand —
        docs/RUNBOOK.md "Upgrading")."""
        for col in _MIGRATED_COLUMNS:
            cql_type = "int" if col in _INT_COLUMNS else "text"
            try:
                self._execute(f"ALTER TABLE {self.table} ADD {col} {cql_type}")
            except CqlConnectionError:
                raise
            except CqlError as exc:
                # only a POSITIVE already-exists shape means "done" (Scylla:
                # "Invalid column name ... conflicts with an existing
                # column"; Cassandra: "... already exists").  Matching the
                # bare substring "exist" also swallowed "table ... does not
                # exist" / "unconfigured table" (ADVICE r5) — a missing
                # keyspace/table or revoked ALTER permission is a REAL
                # failure: swallowing it would report a successful upgrade
                # and leave every subsequent query erroring on the missing
                # columns, the exact outage this migration prevents.
                text = str(exc).lower()
                done = "already exist" in text or "conflicts with an existing column" in text
                if "does not exist" in text or "unconfigured" in text or not done:
                    raise
                self._log.v(1).info(
                    "migration column already present", column=col, detail=str(exc)
                )

    @staticmethod
    def _row_to_checkpoint(row: Dict[str, Any]) -> CheckpointedRequest:
        data = dict(row)
        steps = data.get("per_chip_steps")
        if isinstance(steps, dict):
            data["per_chip_steps"] = {str(k): int(v) for k, v in steps.items()}
        for key in ("restart_count",):
            if data.get(key) is None:
                data[key] = 0
        for key, value in list(data.items()):
            if value is None and key not in (
                "received_at", "sent_at", "last_modified", "per_chip_steps", "max_restarts",
            ):
                data[key] = ""
        return CheckpointedRequest.from_row(data)

    def read_checkpoint(self, algorithm: str, id: str) -> Optional[CheckpointedRequest]:
        rows = self._execute(
            f"SELECT {_SELECT_COLS} FROM {self.table} "
            f"WHERE algorithm = {quote_text(algorithm)} AND id = {quote_text(id)}"
        )
        if not rows:
            return None
        return self._row_to_checkpoint(rows[0])

    def upsert_checkpoint(self, cp: CheckpointedRequest) -> None:
        values = {
            "algorithm": cp.algorithm,
            "id": cp.id,
            "lifecycle_stage": cp.lifecycle_stage,
            "payload_uri": cp.payload_uri,
            "result_uri": cp.result_uri,
            "algorithm_failure_cause": cp.algorithm_failure_cause,
            "algorithm_failure_details": cp.algorithm_failure_details,
            "received_by_host": cp.received_by_host,
            "received_at": cp.received_at,
            "sent_at": cp.sent_at,
            "applied_configuration": cp.applied_configuration,
            "configuration_overrides": cp.configuration_overrides,
            "content_hash": cp.content_hash,
            "last_modified": cp.last_modified,
            "tag": cp.tag,
            "api_version": cp.api_version,
            "job_uid": cp.job_uid,
            "parent": cp.parent,
            "payload_valid_for": cp.payload_valid_for,
            "hlo_trace_ref": cp.hlo_trace_ref,
            "per_chip_steps": {k: int(v) for k, v in cp.per_chip_steps.items()} or None,
            "tensor_checkpoint_uri": cp.tensor_checkpoint_uri,
            "restart_count": cp.restart_count,
            "preempted_generation": cp.preempted_generation,
            "max_restarts": cp.max_restarts,
        }
        cols = ", ".join(values)
        literals = ", ".join(to_literal(v) for v in values.values())
        self._execute(f"INSERT INTO {self.table} ({cols}) VALUES ({literals})")

    def merge_chip_steps(self, algorithm: str, id: str, steps: Dict[str, int]) -> None:
        """CQL map append: per-key upsert, atomic per cell — concurrent hosts
        never clobber each other's chip counters (no read needed)."""
        if not steps:
            return
        literal = to_literal({k: int(v) for k, v in steps.items()})
        self._execute(
            f"UPDATE {self.table} SET per_chip_steps = per_chip_steps + {literal} "
            f"WHERE algorithm = {quote_text(algorithm)} AND id = {quote_text(id)}"
        )

    def update_fields(self, algorithm: str, id: str, fields: Dict[str, Any]) -> None:
        """Column-level UPDATE — CQL writes are per-cell, so columns not
        named (per_chip_steps especially) are untouched."""
        # field names are interpolated into the statement text — the shared
        # guard keeps an unknown key from becoming arbitrary CQL
        _validate_field_names(fields)
        if not fields:
            return
        sets = ", ".join(f"{k} = {to_literal(v)}" for k, v in fields.items())
        self._execute(
            f"UPDATE {self.table} SET {sets} "
            f"WHERE algorithm = {quote_text(algorithm)} AND id = {quote_text(id)}"
        )

    def compare_and_set(
        self,
        algorithm: str,
        id: str,
        expected: Dict[str, Any],
        fields: Dict[str, Any],
    ) -> bool:
        """CQL lightweight transaction: ``UPDATE … IF col = val AND …``.

        The coordinator runs Paxos for the conditional write and answers
        with a result set whose first column is the ``[applied]`` boolean
        (plus the current values when not applied) — the real
        multi-replica-safe primitive the in-memory/sqlite stores emulate."""
        _validate_cas_args(expected, fields)
        sets = ", ".join(f"{k} = {to_literal(v)}" for k, v in fields.items())
        # empty `expected` still rides the LWT as IF EXISTS: a plain UPDATE
        # would blind-UPSERT a phantom row on a missing id and "succeed",
        # diverging from the other backends' row-must-exist contract
        conds = " AND ".join(f"{k} = {to_literal(v)}" for k, v in expected.items()) or "EXISTS"
        rows = self._execute(
            f"UPDATE {self.table} SET {sets} "
            f"WHERE algorithm = {quote_text(algorithm)} AND id = {quote_text(id)} "
            f"IF {conds}"
        )
        return bool(rows and rows[0].get("[applied]"))

    def _query_index(self, column: str, value: str) -> List[CheckpointedRequest]:
        rows = self._execute(
            f"SELECT {_SELECT_COLS} FROM {self.table} WHERE {column} = {quote_text(value)}"
        )
        return [self._row_to_checkpoint(r) for r in rows]

    def query_by_stage(self, stage: str) -> List[CheckpointedRequest]:
        return self._query_index("lifecycle_stage", stage)

    def query_by_tag(self, tag: str) -> List[CheckpointedRequest]:
        return self._query_index("tag", tag)

    def query_by_host(self, host: str) -> List[CheckpointedRequest]:
        return self._query_index("received_by_host", host)

    def close(self) -> None:
        with self._conn_lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None


class ScyllaCqlStore(CqlCheckpointStore):
    """Scylla/Cassandra store (reference ScyllaCqlStoreConfig:
    hosts/port/user/password/local-dc, appconfig.local.yaml:5-10)."""

    def __init__(
        self,
        hosts: Sequence[str],
        port: int = 9042,
        user: str = "",
        password: str = "",
        local_dc: str = "",
        connect_timeout: float = 5.0,
        logger: Optional[VLogger] = None,
    ) -> None:
        super().__init__(logger)
        self.hosts = list(hosts)
        self.port = int(port) if port else 9042
        self.user = user
        self.password = password
        self.local_dc = local_dc  # informational; no token-aware routing
        self.connect_timeout = connect_timeout

    def _connect(self) -> CqlConnection:
        last_error: Optional[Exception] = None
        for host in self.hosts or ["127.0.0.1"]:
            try:
                sock = socket.create_connection((host, self.port), timeout=self.connect_timeout)
                sock.settimeout(30.0)
                conn = CqlConnection(sock)
                conn.startup(self.user, self.password)
                self._log.info("connected to CQL host", host=host, port=self.port)
                return conn
            except (OSError, CqlConnectionError) as exc:
                # unreachable/lost hosts: try the next one; auth/protocol
                # errors (plain CqlError) are definitive and propagate
                last_error = exc
                self._log.warning("CQL host unreachable", host=host, error=repr(exc))
        raise CqlConnectionError(f"no CQL host reachable (tried {self.hosts}): {last_error!r}")


class AstraCqlStore(CqlCheckpointStore):
    """DataStax Astra store via secure connect bundle (reference
    AstraBundleConfig, appconfig.local.yaml:1-4).  The bundle is a base64
    zip holding config.json (host/port) + mTLS material."""

    def __init__(
        self,
        secure_connection_bundle_base64: str,
        user: str = "",
        password: str = "",
        connect_timeout: float = 10.0,
        logger: Optional[VLogger] = None,
    ) -> None:
        super().__init__(logger)
        self._bundle_b64 = secure_connection_bundle_base64
        self.user = user
        self.password = password
        self.connect_timeout = connect_timeout

    def _connect(self) -> CqlConnection:
        raw = base64.b64decode(self._bundle_b64)
        bundle = zipfile.ZipFile(io.BytesIO(raw))
        config = json.loads(bundle.read("config.json"))
        host = config.get("host", "")
        port = int(config.get("cql_port", config.get("port", 29042)))
        ctx = ssl.create_default_context(cadata=bundle.read("ca.crt").decode())
        # client cert/key must live on disk for load_cert_chain
        with tempfile.NamedTemporaryFile(suffix=".crt") as cert_file, tempfile.NamedTemporaryFile(
            suffix=".key"
        ) as key_file:
            cert_file.write(bundle.read("cert"))
            cert_file.flush()
            key_file.write(bundle.read("key"))
            key_file.flush()
            ctx.load_cert_chain(cert_file.name, key_file.name)
        sock = socket.create_connection((host, port), timeout=self.connect_timeout)
        tls = ctx.wrap_socket(sock, server_hostname=host)
        tls.settimeout(30.0)
        conn = CqlConnection(tls)
        conn.startup(self.user, self.password)
        return conn
