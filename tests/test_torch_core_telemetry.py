"""The port's counterpart of ``tests/test_core_telemetry.py`` (``tpu_nexus_torch``).

Tests for telemetry (nexus-core ConfigureLogger/WithStatsd parity)."""

import io
import json
import logging
import socket
import threading

import pytest

from tpu_nexus_torch.core.signals import setup_signal_context
from tpu_nexus_torch.core.telemetry import StatsdClient, Timer, RecordingMetrics, configure_logger


@pytest.fixture(autouse=True)
def _restore_port_logger():
    """configure_logger() sets propagate=False on the port's package logger
    (``tpu_nexus_torch``); restore it after every test, as the shared
    conftest does for the JAX package's."""
    lg = logging.getLogger("tpu_nexus_torch")
    saved = (lg.propagate, list(lg.handlers), lg.level)
    yield
    lg.propagate, lg.handlers[:] = saved[0], saved[1]
    lg.setLevel(saved[2])


def test_json_logger_structure_and_tags():
    buf = io.StringIO()
    log = configure_logger(tags={"environment": "units"}, level="info", verbosity=1, stream=buf)
    log.info("decision made", decision="ToRunning", request_id="abc")
    log.v(4).info("firehose suppressed")  # verbosity 1 < 4 -> dropped
    log.v(1).info("kept")
    lines = [json.loads(line) for line in buf.getvalue().strip().splitlines()]
    assert lines[0]["message"] == "decision made"
    assert lines[0]["decision"] == "ToRunning"
    assert lines[0]["tags"] == {"environment": "units"}
    assert [l["message"] for l in lines] == ["decision made", "kept"]


def test_statsd_udp_datagram_format():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(2)
    port = sock.getsockname()[1]
    client = StatsdClient("tpu_nexus_torch", address=f"udp://127.0.0.1:{port}", static_tags={"ctx": "nexus_supervisor"})
    client.count("events", 3, tags={"kind": "Job"})
    data, _ = sock.recvfrom(4096)
    assert data.decode() == "tpu_nexus_torch.events:3|c|#ctx:nexus_supervisor,kind:Job"
    client.gauge("queue_depth", 7)
    data, _ = sock.recvfrom(4096)
    assert data.decode() == "tpu_nexus_torch.queue_depth:7|g|#ctx:nexus_supervisor"
    sock.close()


def test_statsd_unreachable_never_raises():
    client = StatsdClient("ns", address="unix:///nonexistent/path.sock")
    client.count("x")  # must not raise
    client.timing("y", 0.5)
    client.histogram("z", 1.25)


def test_statsd_histogram_datagram_format():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(2)
    port = sock.getsockname()[1]
    client = StatsdClient("tpu_nexus_torch", address=f"udp://127.0.0.1:{port}")
    client.histogram("serving.ttft_seconds", 0.125, tags={"mode": "engine"})
    data, _ = sock.recvfrom(4096)
    assert data.decode() == "tpu_nexus_torch.serving.ttft_seconds:0.125|h|#mode:engine"
    sock.close()


def test_statsd_oversized_datagram_truncates_tags_with_counter():
    # the DogStatsD-over-UDP convention: a datagram past the ceiling is
    # sent WITHOUT its tag section (still a valid metric line — a byte
    # cut mid-payload would be garbage the agent rejects) and counted
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(2)
    port = sock.getsockname()[1]
    client = StatsdClient(
        "tpu_nexus_torch", address=f"udp://127.0.0.1:{port}", max_datagram_bytes=64
    )
    client.count("events", 1, tags={"blob": "x" * 200})
    data, _ = sock.recvfrom(4096)
    assert data.decode() == "tpu_nexus_torch.events:1|c"  # tags dropped, line valid
    assert client.truncated == 1
    # within the ceiling: tags ride untouched, counter unchanged
    client.count("events", 2, tags={"kind": "Job"})
    data, _ = sock.recvfrom(4096)
    assert data.decode() == "tpu_nexus_torch.events:2|c|#kind:Job"
    assert client.truncated == 1
    sock.close()


def test_statsd_oversized_base_line_dropped_with_counter():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(0.2)
    port = sock.getsockname()[1]
    client = StatsdClient(
        "tpu_nexus_torch", address=f"udp://127.0.0.1:{port}", max_datagram_bytes=64
    )
    client.count("a" * 200, 1)  # even tagless the line exceeds the ceiling
    assert client.truncated == 1
    with pytest.raises(socket.timeout):
        sock.recvfrom(4096)  # nothing was sent — a byte-cut would be garbage
    sock.close()


def test_statsd_send_failure_never_raises_and_is_counted():
    client = StatsdClient("ns", address="udp://127.0.0.1:9")  # discard port

    class ExplodingSocket:
        def send(self, payload):
            raise OSError("socket gone")

    client._sock = ExplodingSocket()
    client.count("x")  # must not raise into the engine loop
    client.gauge("y", 1.0)
    assert client.send_errors == 2


def test_statsd_bad_tag_value_never_raises_and_is_counted():
    class Unprintable:
        def __str__(self):
            raise RuntimeError("no repr for you")

    client = StatsdClient("ns", address="udp://127.0.0.1:9")
    client.count("x", tags={"bad": Unprintable()})  # formatting failure stays inside
    assert client.send_errors == 1


def test_statsd_rejects_unusable_ceiling():
    with pytest.raises(ValueError, match="max_datagram_bytes"):
        StatsdClient("ns", max_datagram_bytes=8)


def test_recording_histogram_accumulates_samples():
    m = RecordingMetrics()
    m.histogram("ttft", 0.1)
    m.histogram("ttft", 0.3)
    assert m.histograms["ttft"] == [0.1, 0.3]


def test_timer_records():
    m = RecordingMetrics()
    with Timer(m, "op"):
        pass
    assert len(m.timings["op"]) == 1


def test_signal_context_manual_cancel():
    ctx = setup_signal_context(install=False)
    assert not ctx.cancelled
    ctx.cancel()
    assert ctx.cancelled


class _FakeIntake(threading.Thread):
    """Loopback HTTP stub for the Datadog logs intake."""

    def __init__(self, status=202):
        super().__init__(daemon=True)
        import http.server

        intake = self
        intake.batches = []
        intake.api_keys = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                intake.batches.append(json.loads(body))
                intake.api_keys.append(self.headers.get("DD-API-KEY"))
                self.send_response(status)
                self.end_headers()

            def log_message(self, *a):  # noqa: ANN002 - silence stub
                pass

        self._server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_port}/api/v2/logs"

    def run(self):
        self._server.serve_forever()

    def stop(self):
        self._server.shutdown()


def test_datadog_log_handler_ships_batches():
    """The one §2.3 telemetry sub-behavior unmatched —
    logs ship to the Datadog intake (here a loopback stub) with the API key
    header, batched, while stderr JSON remains the primary stream."""
    import io

    from tpu_nexus_torch.core.telemetry import configure_logger

    intake = _FakeIntake()
    intake.start()
    stream = io.StringIO()
    log = configure_logger(
        tags={"env": "units"},
        stream=stream,
        datadog_api_key="test-key-123",
        datadog_intake_url=intake.url,
    )
    for i in range(3):
        log.info("supervised event", run_id=f"r-{i}")
    handler = logging.getLogger("tpu_nexus_torch").handlers[1]
    handler.close()  # flush
    intake.stop()
    assert handler.shipped == 3 and handler.dropped == 0
    assert intake.api_keys[0] == "test-key-123"
    entries = [e for batch in intake.batches for e in batch]
    assert len(entries) == 3
    assert entries[0]["ddsource"] == "tpu-nexus"
    assert entries[0]["service"] == "tpu-nexus-supervisor"
    inner = json.loads(entries[2]["message"])
    assert inner["message"] == "supervised event" and inner["run_id"] == "r-2"
    assert inner["tags"] == {"env": "units"}
    # stderr stream still carries every record (multi-handler tee)
    assert stream.getvalue().count("supervised event") == 3
    # reset the global logger for other tests
    logging.getLogger("tpu_nexus_torch").handlers = []


def test_datadog_log_handler_unreachable_never_raises():
    from tpu_nexus_torch.core.telemetry import DatadogLogHandler, JsonFormatter

    handler = DatadogLogHandler(
        api_key="k", intake_url="http://127.0.0.1:1/api/v2/logs", flush_interval=0.05
    )
    handler.setFormatter(JsonFormatter())
    logger = logging.Logger("doomed")
    logger.addHandler(handler)
    for i in range(5):
        logger.info("into the void %d", i)
    handler.close()
    assert handler.dropped == 5 and handler.shipped == 0


def test_datadog_handler_not_attached_without_key(monkeypatch):
    from tpu_nexus_torch.core.telemetry import configure_logger

    monkeypatch.delenv("DD_API_KEY", raising=False)
    import io

    configure_logger(stream=io.StringIO())
    handlers = logging.getLogger("tpu_nexus_torch").handlers
    assert len(handlers) == 1
    logging.getLogger("tpu_nexus_torch").handlers = []
