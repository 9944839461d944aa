"""The port's CQL wire-protocol client (``tpu_nexus_torch/checkpoint/cql.py``):
the cases of ``tests/test_cql.py`` against the port, plus one wire-parity
check against the JAX package's client.

CQL wire-protocol client tests against a loopback fake server.

The fake server speaks real CQL v4 frames over a real TCP socket: STARTUP ->
READY (or AUTHENTICATE -> AUTH_SUCCESS), QUERY -> canned RESULT frames built
with the module's own primitives.  Verifies framing, the auth handshake,
RESULT(Rows) decoding for every column type the checkpoint schema uses, and
the lazy-construction contract.  ``test_wire_frames_equal_the_jax_package``
sends one sequence of ledger operations through both packages'
``ScyllaCqlStore`` to one recording server and compares the raw request
frames byte for byte (no tolerance: the port's client is a copy)."""

import socket
import struct
import threading
from datetime import datetime, timezone

import pytest

from tpu_nexus_torch.checkpoint.cql import (
    OP_AUTH_RESPONSE,
    OP_AUTH_SUCCESS,
    OP_AUTHENTICATE,
    OP_ERROR,
    OP_QUERY,
    OP_READY,
    OP_RESULT,
    OP_STARTUP,
    RESULT_ROWS,
    RESULT_VOID,
    TYPE_BIGINT,
    TYPE_INT,
    TYPE_MAP,
    TYPE_TIMESTAMP,
    TYPE_VARCHAR,
    CqlCheckpointStore,
    CqlConnection,
    CqlConnectionError,
    CqlError,
    ScyllaCqlStore,
    encode_frame,
    quote_text,
    to_literal,
    write_bytes,
    write_int,
    write_long,
    write_short,
    write_string,
)


def rows_frame_body(columns, rows):
    """Build a RESULT(Rows) body: columns = [(name, type_id, param)], rows =
    list of lists of raw cell bytes (None = null)."""
    body = write_int(RESULT_ROWS)
    body += write_int(0x0001)  # global_tables_spec
    body += write_int(len(columns))
    body += write_string("nexus") + write_string("checkpoints")
    for name, type_id, param in columns:
        body += write_string(name) + write_short(type_id)
        if type_id == TYPE_MAP:
            (ktype, vtype) = param
            body += write_short(ktype) + write_short(vtype)
    body += write_int(len(rows))
    for row in rows:
        for cell in row:
            body += write_bytes(cell)
    return body


class FakeCqlServer(threading.Thread):
    """Single-connection fake: handshake then canned per-query responses.
    ``ssl_context`` wraps the accepted connection server-side — the seam
    the Astra (secure-connect-bundle) tests use to witness the real TLS
    handshake and mTLS client-certificate verification."""

    def __init__(self, require_auth=False, user="cassandra", password="cassandra",
                 ssl_context=None):
        super().__init__(daemon=True)
        self.require_auth = require_auth
        self.user = user
        self.password = password
        self.ssl_context = ssl_context
        self.queries = []
        self.responses = []  # list of (opcode, body) popped per QUERY
        self.tls_peer_cert = None
        self._listener = socket.socket()
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(1)
        self.port = self._listener.getsockname()[1]

    def run(self):
        conn, _ = self._listener.accept()
        if self.ssl_context is not None:
            try:
                conn = self.ssl_context.wrap_socket(conn, server_side=True)
                self.tls_peer_cert = conn.getpeercert()
            except (OSError, ConnectionError):
                return
        try:
            while True:
                header = self._recv_exact(conn, 9)
                if header is None:
                    return
                _, _, stream, opcode, length = struct.unpack(">BBhBi", header)
                body = self._recv_exact(conn, length) if length else b""
                if opcode == OP_STARTUP:
                    if self.require_auth:
                        conn.sendall(
                            encode_frame(
                                OP_AUTHENTICATE,
                                write_string("org.apache.cassandra.auth.PasswordAuthenticator"),
                                stream=stream, response=True,
                            )
                        )
                    else:
                        conn.sendall(encode_frame(OP_READY, b"", stream=stream, response=True))
                elif opcode == OP_AUTH_RESPONSE:
                    token = body[4:]  # skip [bytes] length
                    expected = b"\x00" + self.user.encode() + b"\x00" + self.password.encode()
                    if token == expected:
                        conn.sendall(
                            encode_frame(OP_AUTH_SUCCESS, write_bytes(None), stream=stream, response=True)
                        )
                    else:
                        conn.sendall(
                            encode_frame(
                                OP_ERROR, write_int(0x0100) + write_string("bad credentials"),
                                stream=stream, response=True,
                            )
                        )
                elif opcode == OP_QUERY:
                    qlen = struct.unpack(">i", body[:4])[0]
                    self.queries.append(body[4 : 4 + qlen].decode())
                    resp_opcode, resp_body = (
                        self.responses.pop(0)
                        if self.responses
                        else (OP_RESULT, write_int(RESULT_VOID))
                    )
                    conn.sendall(encode_frame(resp_opcode, resp_body, stream=stream, response=True))
        except (ConnectionError, OSError):
            pass

    @staticmethod
    def _recv_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf


def test_literal_encoding():
    assert quote_text("it's") == "'it''s'"
    assert to_literal(None) == "null"
    assert to_literal(7) == "7"
    assert to_literal(True) == "true"
    assert to_literal({"a": 1, "b": 2}) == "{'a': 1, 'b': 2}"
    dt = datetime(2023, 10, 1, 12, 0, 0, tzinfo=timezone.utc)
    assert to_literal(dt) == "'2023-10-01T12:00:00.000Z'"


def test_handshake_and_rows_decoding():
    server = FakeCqlServer()
    server.start()
    ts = datetime(2024, 5, 1, 8, 30, tzinfo=timezone.utc)
    ts_ms = int(ts.timestamp() * 1000)
    map_cell = write_int(2)
    map_cell += write_bytes(b"host0/chip0") + write_bytes(struct.pack(">q", 41))
    map_cell += write_bytes(b"host0/chip1") + write_bytes(struct.pack(">q", 42))
    server.responses.append(
        (
            OP_RESULT,
            rows_frame_body(
                [
                    ("algorithm", TYPE_VARCHAR, None),
                    ("restart_count", TYPE_INT, None),
                    ("steps", TYPE_BIGINT, None),
                    ("received_at", TYPE_TIMESTAMP, None),
                    ("per_chip_steps", TYPE_MAP, (TYPE_VARCHAR, TYPE_BIGINT)),
                    ("result_uri", TYPE_VARCHAR, None),
                ],
                [
                    [
                        b"llama3",
                        struct.pack(">i", 3),
                        struct.pack(">q", 123456789),
                        struct.pack(">q", ts_ms),
                        map_cell,
                        None,  # null cell
                    ]
                ],
            ),
        )
    )
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=2)
    conn = CqlConnection(sock)
    conn.startup()
    rows = conn.query("SELECT * FROM nexus.checkpoints")
    assert rows == [
        {
            "algorithm": "llama3",
            "restart_count": 3,
            "steps": 123456789,
            "received_at": ts,
            "per_chip_steps": {"host0/chip0": 41, "host0/chip1": 42},
            "result_uri": None,
        }
    ]
    conn.close()


def test_auth_handshake():
    server = FakeCqlServer(require_auth=True, user="u", password="p")
    server.start()
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port, user="u", password="p")
    # first query triggers lazy connect + auth; fake returns VOID
    assert store.read_checkpoint("a", "b") is None
    assert "SELECT" in server.queries[0]
    store.close()


def test_auth_failure_raises():
    server = FakeCqlServer(require_auth=True, user="u", password="right")
    server.start()
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port, user="u", password="wrong")
    with pytest.raises(CqlError):
        store.read_checkpoint("a", "b")
    store.close()


def test_lazy_construction_unreachable_host():
    # constructing against an unreachable host must not fail (reference
    # contract, supervisor_test.go:36-39); the first query raises
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=1, connect_timeout=0.2)
    with pytest.raises(CqlError):
        store.read_checkpoint("a", "b")


def test_upsert_builds_inlined_insert():
    from tpu_nexus_torch.checkpoint.models import CheckpointedRequest

    server = FakeCqlServer()
    server.start()
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port)
    store.upsert_checkpoint(
        CheckpointedRequest(
            algorithm="test-algorithm",
            id="run-1",
            lifecycle_stage="FAILED",
            algorithm_failure_cause="it's broken",
            per_chip_steps={"h0/c0": 5},
            restart_count=1,
        )
    )
    q = server.queries[0]
    assert q.startswith("INSERT INTO nexus.checkpoints")
    assert "'it''s broken'" in q  # quote escaping
    assert "{'h0/c0': 5}" in q  # map literal
    assert "'FAILED'" in q
    store.close()


def test_compare_and_set_builds_lwt_and_parses_applied():
    """compare_and_set must ride a CQL lightweight transaction (UPDATE … IF)
    and answer from the coordinator's [applied] column — the multi-replica
    atomicity primitive."""
    from tpu_nexus_torch.checkpoint.cql import TYPE_BOOLEAN

    server = FakeCqlServer()
    server.start()
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port)
    applied = rows_frame_body([("[applied]", TYPE_BOOLEAN, None)], [[b"\x01"]])
    not_applied = rows_frame_body(
        [("[applied]", TYPE_BOOLEAN, None), ("lifecycle_stage", TYPE_VARCHAR, None)],
        [[b"\x00", b"FAILED"]],
    )
    server.responses = [(OP_RESULT, applied), (OP_RESULT, not_applied)]

    ok = store.compare_and_set(
        "test-algorithm", "run-1",
        {"lifecycle_stage": "RUNNING", "restart_count": 1},
        {"lifecycle_stage": "PREEMPTED", "restart_count": 2},
    )
    assert ok is True
    q = server.queries[0]
    assert q.startswith("UPDATE nexus.checkpoints SET ")
    assert "restart_count = 2" in q and "'PREEMPTED'" in q
    assert "WHERE algorithm = 'test-algorithm' AND id = 'run-1'" in q
    assert q.endswith("IF lifecycle_stage = 'RUNNING' AND restart_count = 1")

    # coordinator reports the condition no longer holds -> False, no raise
    assert store.compare_and_set(
        "test-algorithm", "run-1",
        {"lifecycle_stage": "RUNNING"},
        {"lifecycle_stage": "FAILED"},
    ) is False
    store.close()


def test_merge_chip_steps_builds_map_append():
    server = FakeCqlServer()
    server.start()
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port)
    store.merge_chip_steps("test-algorithm", "run-1", {"host1/chip0": 7, "host1/chip1": 7})
    q = server.queries[0]
    # per-key map append: atomic per cell, no read-modify-write
    assert q.startswith("UPDATE nexus.checkpoints SET per_chip_steps = per_chip_steps + ")
    assert "{'host1/chip0': 7, 'host1/chip1': 7}" in q
    assert "WHERE algorithm = 'test-algorithm' AND id = 'run-1'" in q
    store.close()


def test_wire_bytes_conform_to_protocol_v4_spec_by_hand():
    """Independent-decoder witness (the loopback fake's frames are built
    with the MODULE'S own primitives — a symmetric encode bug would cancel
    out).  Here the client's raw
    bytes are checked against frames hand-packed in this test straight from
    the CQL native protocol v4 spec (§2 frame header, §4.1.1 STARTUP,
    §4.1.4 QUERY), and the server replies are likewise hand-packed.  No
    cql.py helper touches the expected bytes."""
    import struct as _s

    server_sock = socket.socket()
    server_sock.bind(("127.0.0.1", 0))
    server_sock.listen(1)
    port = server_sock.getsockname()[1]

    captured = {}

    def recv_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:  # peer closed: bail instead of spinning
                raise ConnectionError("client closed early")
            buf += chunk
        return buf

    def serve():
        conn, _ = server_sock.accept()
        # ---- STARTUP (client stream counter starts at 1) ----
        ver, flags, stream, opcode, length = _s.unpack(">BBhBi", recv_exact(conn, 9))
        body = recv_exact(conn, length) if length else b""
        captured["startup"] = (ver, flags, stream, opcode, body)
        # READY, hand-packed: response version 0x84, empty body
        conn.sendall(_s.pack(">BBhBi", 0x84, 0, stream, 0x02, 0))
        # ---- QUERY ----
        ver, flags, stream, opcode, length = _s.unpack(">BBhBi", recv_exact(conn, 9))
        body = recv_exact(conn, length) if length else b""
        captured["query"] = (ver, flags, stream, opcode, body)
        # RESULT(Void), hand-packed: body = [int kind=0x0001]
        conn.sendall(_s.pack(">BBhBi", 0x84, 0, stream, 0x08, 4) + _s.pack(">i", 1))
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()

    sock = socket.create_connection(("127.0.0.1", port), timeout=5)
    c = CqlConnection(sock)
    c.startup()
    cql = "SELECT algorithm FROM nexus.checkpoints"
    c.query(cql)
    c.close()
    t.join(timeout=5)

    # STARTUP: version 0x04 request, flags 0, opcode 0x01, body is a
    # [string map] {CQL_VERSION: 3.0.0}: short n, then short-len strings
    ver, flags, stream, opcode, body = captured["startup"]
    assert (ver, flags, opcode) == (0x04, 0x00, 0x01)
    expected_startup = (
        _s.pack(">H", 1)
        + _s.pack(">H", 11) + b"CQL_VERSION"
        + _s.pack(">H", 5) + b"3.0.0"
    )
    assert body == expected_startup

    # QUERY: opcode 0x07, body = [long string] + [consistency short=ONE]
    # + [flags byte 0x00]; stream increments per request
    ver, flags, stream, opcode, body = captured["query"]
    assert (ver, flags, opcode) == (0x04, 0x00, 0x07)
    assert stream == captured["startup"][2] + 1
    expected_query = (
        _s.pack(">i", len(cql)) + cql.encode()
        + _s.pack(">H", 0x0001)
        + b"\x00"
    )
    assert body == expected_query


# -- Astra secure-connect-bundle / TLS path ----------------------------------


def _x509_material():
    """Self-signed CA + server cert (SAN 127.0.0.1) + client cert/key —
    the mTLS material a DataStax secure connect bundle carries."""
    import datetime
    import ipaddress

    pytest.importorskip("cryptography")
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    def name(cn):
        return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])

    now = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)

    def make(cn, issuer_name, issuer_key, *, is_ca=False, san_ip=None):
        key = ec.generate_private_key(ec.SECP256R1())
        builder = (
            x509.CertificateBuilder()
            .subject_name(name(cn))
            .issuer_name(issuer_name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(x509.BasicConstraints(ca=is_ca, path_length=None), critical=True)
        )
        if san_ip:
            builder = builder.add_extension(
                x509.SubjectAlternativeName([x509.IPAddress(ipaddress.ip_address(san_ip))]),
                critical=False,
            )
        cert = builder.sign(issuer_key or key, hashes.SHA256())
        return cert, key

    ca_cert, ca_key = make("fake-astra-ca", name("fake-astra-ca"), None, is_ca=True)
    server_cert, server_key = make("127.0.0.1", ca_cert.subject, ca_key, san_ip="127.0.0.1")
    client_cert, client_key = make("astra-client", ca_cert.subject, ca_key)

    def pem(cert):
        return cert.public_bytes(serialization.Encoding.PEM)

    def key_pem(key):
        return key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        )

    return {
        "ca_pem": pem(ca_cert),
        "server_pem": pem(server_cert),
        "server_key_pem": key_pem(server_key),
        "client_pem": pem(client_cert),
        "client_key_pem": key_pem(client_key),
    }


def _astra_bundle_b64(material, port):
    """base64 zip in the DataStax secure-connect layout the store parses:
    config.json (host/cql_port) + ca.crt + cert + key."""
    import base64
    import io
    import json
    import zipfile

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("config.json", json.dumps({"host": "127.0.0.1", "cql_port": port}))
        z.writestr("ca.crt", material["ca_pem"])
        z.writestr("cert", material["client_pem"])
        z.writestr("key", material["client_key_pem"])
    return base64.b64encode(buf.getvalue()).decode()


def _tls_server(material, require_auth=True, require_client_cert=True):
    import ssl
    import tempfile

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    with tempfile.NamedTemporaryFile(suffix=".crt") as crt, tempfile.NamedTemporaryFile(
        suffix=".key"
    ) as key:
        crt.write(material["server_pem"])
        crt.flush()
        key.write(material["server_key_pem"])
        key.flush()
        ctx.load_cert_chain(crt.name, key.name)
    ctx.load_verify_locations(cadata=material["ca_pem"].decode())
    if require_client_cert:
        ctx.verify_mode = ssl.CERT_REQUIRED
    server = FakeCqlServer(require_auth=require_auth, user="token", password="astra-secret",
                           ssl_context=ctx)
    server.start()
    return server


def test_astra_bundle_tls_auth_and_roundtrip():
    """The full Astra path: parse the secure
    connect bundle, complete a REAL TLS handshake with mTLS client-cert
    verification against the CA the bundle names, SASL-authenticate, and
    run a read + upsert through the encrypted connection."""
    from tpu_nexus_torch.checkpoint.cql import AstraCqlStore
    from tpu_nexus_torch.checkpoint.models import CheckpointedRequest

    material = _x509_material()
    server = _tls_server(material)
    store = AstraCqlStore(
        secure_connection_bundle_base64=_astra_bundle_b64(material, server.port),
        user="token",
        password="astra-secret",
    )
    # read (canned empty result) then upsert through the same TLS session
    server.responses = [(OP_RESULT, rows_frame_body([("algorithm", TYPE_VARCHAR, None)], []))]
    assert store.read_checkpoint("alg", "missing-run") is None
    store.upsert_checkpoint(
        CheckpointedRequest(algorithm="alg", id="run-tls-1", lifecycle_stage="RUNNING")
    )
    assert len(server.queries) == 2
    assert server.queries[1].startswith("INSERT INTO nexus.checkpoints")
    # the server really verified the CLIENT certificate from the bundle
    assert server.tls_peer_cert is not None
    subject = dict(x[0] for x in server.tls_peer_cert["subject"])
    assert subject["commonName"] == "astra-client"
    store.close()


def test_astra_bundle_bad_credentials_raise():
    from tpu_nexus_torch.checkpoint.cql import AstraCqlStore

    material = _x509_material()
    server = _tls_server(material)
    store = AstraCqlStore(
        secure_connection_bundle_base64=_astra_bundle_b64(material, server.port),
        user="token",
        password="wrong",
    )
    with pytest.raises(CqlError, match="authentication failed"):
        store.read_checkpoint("alg", "run")
    store.close()


def test_astra_rejects_untrusted_server_cert():
    """A server whose certificate is NOT signed by the bundle's CA must be
    refused during the handshake — the bundle's CA pins the endpoint."""
    import ssl as _ssl

    from tpu_nexus_torch.checkpoint.cql import AstraCqlStore, CqlConnectionError

    trusted = _x509_material()
    imposter = _x509_material()  # different CA signs this server's cert
    server = _tls_server(imposter, require_client_cert=False)
    store = AstraCqlStore(
        secure_connection_bundle_base64=_astra_bundle_b64(trusted, server.port),
        user="token",
        password="astra-secret",
    )
    # one attempt: the fake server accepts one connection, so each retry
    # would wait out connect_timeout on a handshake nobody answers
    store.max_retries = 0
    with pytest.raises((_ssl.SSLError, CqlConnectionError, OSError)):
        store.read_checkpoint("alg", "run")
    store.close()


def test_astra_lazy_construction():
    """Store construction must not touch the network or even parse the
    bundle (contract parity: reference builds the store unconditionally,
    services/supervisor_test.go:36-39)."""
    from tpu_nexus_torch.checkpoint.cql import AstraCqlStore

    AstraCqlStore(secure_connection_bundle_base64="not-even-base64!!")


def test_migrate_schema_tolerates_existing_columns():
    """migrate_schema ALTERs each extension column in; an "already exists"
    CQL error means done (CQL has no ADD COLUMN IF NOT EXISTS), while
    transport errors still propagate."""
    server = FakeCqlServer()
    server.start()
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port)
    already = write_int(0x2200) + write_string("Invalid column preempted_generation because it conflicts with an existing column")
    server.responses = [(OP_ERROR, already)]  # first ALTER refused, second VOID
    store.migrate_schema()
    alters = [q for q in server.queries if q.startswith("ALTER TABLE")]
    assert alters == [
        "ALTER TABLE nexus.checkpoints ADD preempted_generation text",
        "ALTER TABLE nexus.checkpoints ADD max_restarts int",
    ]
    store.close()


def test_migrate_schema_tolerates_cassandra_already_exists():
    server = FakeCqlServer()
    server.start()
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port)
    already = write_int(0x2200) + write_string(
        "Invalid column name preempted_generation because it already exists"
    )
    server.responses = [(OP_ERROR, already)]
    store.migrate_schema()  # must not raise
    store.close()


@pytest.mark.parametrize(
    "message",
    [
        # the bare-substring-"exist" match swallowed BOTH of these — a
        # missing table reported as a successful migration
        "unconfigured table checkpoints",
        "table nexus.checkpoints does not exist",
        # and anything merely *mentioning* existence must not pass either
        "user nexus does not have ALTER permission on existing table",
    ],
)
def test_migrate_schema_reraises_non_positive_errors(message):
    """Only positive already-exists shapes mean "column done"; a missing
    keyspace/table or permission failure must abort the migration loudly,
    not report success over a broken ledger."""
    server = FakeCqlServer()
    server.start()
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port)
    server.responses = [(OP_ERROR, write_int(0x2200) + write_string(message))]
    with pytest.raises(CqlError):
        store.migrate_schema()
    store.close()


# -- transient-write retry ----------------------------------------------------


class _FlakyStore(CqlCheckpointStore):
    """Store whose connections fail transiently for the first
    ``fail_times`` queries — the rolled-coordinator shape (long-lived
    connection dropped; server back after reconnect)."""

    def __init__(self, fail_times, definitive=False):
        super().__init__()
        self.fail_times = fail_times
        self.definitive = definitive
        self.connects = 0
        self.queries = []
        self.sleeps = []
        self._sleep = self.sleeps.append  # no wall-clock waits in the suite
        import random as _random

        self._rng = _random.Random(0)

    def _connect(self):
        self.connects += 1
        outer = self

        class _Conn:
            def query(self, cql):
                outer.queries.append(cql)
                if len(outer.queries) <= outer.fail_times:
                    if outer.definitive:
                        raise CqlError("syntax error in CQL statement")
                    raise CqlConnectionError("connection closed by server")
                return []

            def close(self):
                pass

        return _Conn()


def test_transient_write_retries_then_succeeds():
    """A heartbeat/terminal write that hits two dropped connections must
    reconnect-retry and land — not surface a one-shot driver error to the
    workload (retrying exactly once is not enough)."""
    store = _FlakyStore(fail_times=2)
    store.update_fields("algo", "run-1", {"lifecycle_stage": "RUNNING"})
    assert store.connects == 3  # initial + 2 reconnects
    # first retry is immediate (stale-connection common case); the second
    # backs off with jitter under the first ceiling
    assert len(store.sleeps) == 1
    assert 0.0 <= store.sleeps[0] <= store.retry_base_s


def test_transient_retries_exhausted_raise():
    store = _FlakyStore(fail_times=99)
    with pytest.raises(CqlConnectionError, match="connection closed"):
        store.read_checkpoint("algo", "run-1")
    # initial attempt + max_retries reconnects, then give up
    assert store.connects == store.max_retries + 1
    # backoff ceilings grow exponentially (jittered below them)
    assert len(store.sleeps) == store.max_retries - 1
    for i, slept in enumerate(store.sleeps):
        assert 0.0 <= slept <= store.retry_base_s * (2.0 ** i)


def test_definitive_cql_error_never_retries():
    """Auth/protocol/query errors are facts about the request, not the
    transport — retrying replays them and hides real bugs."""
    store = _FlakyStore(fail_times=99, definitive=True)
    with pytest.raises(CqlError, match="syntax error"):
        store.read_checkpoint("algo", "run-1")
    assert store.connects == 1
    assert store.sleeps == []


# -- wire parity with the JAX package -----------------------------------------


class RecordingCqlServer(threading.Thread):
    """Accepts connections one after another and records every request
    frame of each, raw (header and body).  Answers: STARTUP -> READY; a
    lightweight transaction -> ``[applied]`` true; a SELECT -> one row; any
    other QUERY -> VOID — the same bytes whichever client asks."""

    ROW = rows_frame_body(
        [("algorithm", TYPE_VARCHAR, None), ("id", TYPE_VARCHAR, None),
         ("lifecycle_stage", TYPE_VARCHAR, None), ("restart_count", TYPE_INT, None),
         ("per_chip_steps", TYPE_MAP, (TYPE_VARCHAR, TYPE_BIGINT))],
        [[b"algo", b"run-1", b"RUNNING", struct.pack(">i", 2),
          write_int(1) + write_bytes(b"host0/chip0") + write_bytes(struct.pack(">q", 7))]],
    )

    def __init__(self):
        super().__init__(daemon=True)
        self.sessions = []
        self._listener = socket.socket()
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(4)
        self.port = self._listener.getsockname()[1]

    def run(self):
        from tpu_nexus_torch.checkpoint.cql import TYPE_BOOLEAN

        applied = rows_frame_body([("[applied]", TYPE_BOOLEAN, None)], [[b"\x01"]])
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            frames = []
            self.sessions.append(frames)
            try:
                while True:
                    header = FakeCqlServer._recv_exact(conn, 9)
                    if header is None:
                        break
                    _, _, stream, opcode, length = struct.unpack(">BBhBi", header)
                    body = FakeCqlServer._recv_exact(conn, length) if length else b""
                    frames.append(header + body)
                    if opcode == OP_STARTUP:
                        conn.sendall(encode_frame(OP_READY, b"", stream=stream, response=True))
                        continue
                    cql = body[4: 4 + struct.unpack(">i", body[:4])[0]].decode()
                    if " IF " in cql:
                        resp = applied
                    elif cql.startswith("SELECT"):
                        resp = self.ROW
                    else:
                        resp = write_int(RESULT_VOID)
                    conn.sendall(encode_frame(OP_RESULT, resp, stream=stream, response=True))
            except (ConnectionError, OSError):
                pass
            finally:
                conn.close()

    def close(self):
        self._listener.close()


def _ledger_session(cql_mod, models_mod, port):
    """One sequence of ledger operations through ``cql_mod``'s
    ``ScyllaCqlStore``; returns what the reads decoded."""
    ts = datetime(2026, 3, 1, 9, 30, 15, 250000, tzinfo=timezone.utc)
    store = cql_mod.ScyllaCqlStore(hosts=["127.0.0.1"], port=port)
    try:
        store.upsert_checkpoint(models_mod.CheckpointedRequest(
            algorithm="algo", id="run-1", lifecycle_stage="RUNNING", received_at=ts, last_modified=ts,
            algorithm_failure_cause="it's a cause", per_chip_steps={"host0/chip0": 3, "host0/chip1": 4},
            restart_count=2, tag="t1", received_by_host="host-a"))
        store.update_fields("algo", "run-1", {"algorithm_failure_details": '{"pod": "p-0"}', "last_modified": ts,
                                              "restart_count": 3})
        applied = store.compare_and_set("algo", "run-1", {"lifecycle_stage": "RUNNING"},
                                        {"lifecycle_stage": "COMPLETED", "result_uri": "s3://r"})
        exists = store.compare_and_set("algo", "run-2", {}, {"tag": "t2"})
        store.merge_chip_steps("algo", "run-1", {"fleet/reconciles": 5})
        row = store.read_checkpoint("algo", "run-1")
        by_stage = store.query_by_stage("RUNNING")
        by_tag = store.query_by_tag("t1")
        by_host = store.query_by_host("host-a")
    finally:
        store.close()
    rows = [row, *by_stage, *by_tag, *by_host]
    return applied, exists, [(r.algorithm, r.id, r.lifecycle_stage, r.restart_count, r.per_chip_steps) for r in rows]


def test_wire_frames_equal_the_jax_package():
    """Startup, upsert, ``update_fields``, ``compare_and_set`` (with
    conditions and as IF EXISTS), ``merge_chip_steps``, a read and the
    three index queries through the JAX package's client and the port's,
    against one recording server: the request frames are byte-identical
    and the reads decode alike."""
    import tpu_nexus.checkpoint.cql as jax_cql
    import tpu_nexus.checkpoint.models as jax_models
    import tpu_nexus_torch.checkpoint.cql as port_cql
    import tpu_nexus_torch.checkpoint.models as port_models

    server = RecordingCqlServer()
    server.start()
    try:
        jax_out = _ledger_session(jax_cql, jax_models, server.port)
        port_out = _ledger_session(port_cql, port_models, server.port)
    finally:
        server.close()
    assert len(server.sessions) == 2
    jax_frames, port_frames = server.sessions
    assert len(jax_frames) == 10  # STARTUP + 9 queries
    assert port_frames == jax_frames
    assert port_out == jax_out
    assert port_out[0] is True and port_out[1] is True
    assert port_out[2][0] == ("algo", "run-1", "RUNNING", 2, {"host0/chip0": 7})
