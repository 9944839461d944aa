"""Structured logging and metrics: a copy of ``tpu_nexus/core/
telemetry.py`` without its metric-name registry (which only the JAX
package's static checks read).

  * `configure_logger(tags, level)` — JSON structured logs on stderr with
    static tags and klog-style V-levels via `logger.v(n)` gating;
  * `DatadogLogHandler` — dependency-free HTTP log shipping to the Datadog
    logs intake, attached by `configure_logger` only when `DD_API_KEY` is
    set; batched, bounded, fire-and-forget;
  * `StatsdClient` — dependency-free DogStatsD emitter over UDP or UDS,
    fire-and-forget (never raises into the hot path), plus an in-memory
    `RecordingMetrics` for tests.  The metric names the training loop
    emits are the reference's (``train.loss``, ``train.grad_norm``,
    ``train.anomaly``, ``train.skip``, ``train.goodput``,
    ``train.tokens_per_second``, ``train.mfu``).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import sys
import threading
import time
import urllib.request
from typing import Dict, List, Mapping, Optional


class JsonFormatter(logging.Formatter):
    def __init__(self, static_tags: Optional[Mapping[str, str]] = None) -> None:
        super().__init__()
        self._tags = dict(static_tags or {})

    def format(self, record: logging.LogRecord) -> str:
        payload: Dict[str, object] = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if self._tags:
            payload["tags"] = self._tags
        extra = getattr(record, "fields", None)
        if extra:
            payload.update(extra)
        if record.exc_info and record.exc_info[0] is not None:
            payload["exception"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


class VLogger:
    """klog-style verbosity wrapper around a stdlib logger.

    `log.v(0)` is always-on info, `log.v(4)` is firehose — enabled when the
    configured verbosity >= n.  Structured fields go in as kwargs.
    """

    def __init__(self, logger: logging.Logger, verbosity: int = 0) -> None:
        self._logger = logger
        self.verbosity = verbosity

    def _emit(self, level: int, msg: str, fields: Mapping[str, object]) -> None:
        if self._logger.isEnabledFor(level):
            self._logger.log(level, msg, extra={"fields": dict(fields)} if fields else {})

    def v(self, n: int) -> "_LeveledProxy":
        return _LeveledProxy(self, enabled=n <= self.verbosity)

    def info(self, msg: str, **fields: object) -> None:
        self._emit(logging.INFO, msg, fields)

    def warning(self, msg: str, **fields: object) -> None:
        self._emit(logging.WARNING, msg, fields)

    def error(self, msg: str, **fields: object) -> None:
        self._emit(logging.ERROR, msg, fields)

    def exception(self, msg: str, **fields: object) -> None:
        self._logger.error(msg, exc_info=True, extra={"fields": dict(fields)} if fields else {})


class _LeveledProxy:
    def __init__(self, parent: VLogger, enabled: bool) -> None:
        self._parent = parent
        self._enabled = enabled

    def info(self, msg: str, **fields: object) -> None:
        if self._enabled:
            self._parent.info(msg, **fields)


_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class DatadogLogHandler(logging.Handler):
    """Ship JSON log records to the Datadog logs intake over HTTPS.

    Dependency-free (urllib) and strictly best-effort: records enqueue into
    a BOUNDED queue (full queue drops, counted in ``dropped``); one daemon
    thread batches up to ``batch_size`` records (or ``flush_interval``
    seconds) per POST; intake/network errors drop the batch.  The emitting
    thread never blocks on the network and never sees an exception — the
    same contract as :class:`StatsdClient`.

    The multi-handler shape matches the reference's telemetry (slog
    multi-handler with Datadog shipping): stderr keeps the canonical JSON
    stream for cluster collectors, this handler tees to Datadog.
    """

    def __init__(
        self,
        api_key: str,
        site: str = "datadoghq.com",
        service: str = "tpu-nexus-supervisor",
        tags: Optional[Mapping[str, str]] = None,
        intake_url: Optional[str] = None,
        batch_size: int = 50,
        flush_interval: float = 2.0,
        max_queue: int = 4096,
    ) -> None:
        super().__init__()
        self._url = intake_url or f"https://http-intake.logs.{site}/api/v2/logs"
        self._api_key = api_key
        self._service = service
        self._ddtags = ",".join(f"{k}:{v}" for k, v in (tags or {}).items())
        self._hostname = socket.gethostname()
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue(maxsize=max_queue)
        self._batch_size = batch_size
        self._flush_interval = flush_interval
        self.dropped = 0
        self.shipped = 0
        self._worker = threading.Thread(
            target=self._run, name="datadog-log-shipper", daemon=True
        )
        self._worker.start()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:  # noqa: BLE001 - formatting must not raise upward
            return
        try:
            self._queue.put_nowait(line)
        except queue.Full:
            self.dropped += 1

    def _run(self) -> None:
        batch: List[str] = []
        deadline = time.monotonic() + self._flush_interval
        while True:
            timeout = max(0.05, deadline - time.monotonic())
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                item = None
            closing = False
            if item is self._CLOSE:
                closing = True
            elif item is not None:
                batch.append(item)
            if batch and (
                closing or len(batch) >= self._batch_size or time.monotonic() >= deadline
            ):
                self._post(batch)
                batch = []
                deadline = time.monotonic() + self._flush_interval
            elif time.monotonic() >= deadline:
                deadline = time.monotonic() + self._flush_interval
            if closing:
                return

    _CLOSE = object()

    def _post(self, batch: List[str]) -> None:
        entries = []
        for line in batch:
            entries.append(
                {
                    "message": line,
                    "ddsource": "tpu-nexus",
                    "service": self._service,
                    "hostname": self._hostname,
                    "ddtags": self._ddtags,
                }
            )
        body = json.dumps(entries).encode("utf-8")
        req = urllib.request.Request(
            self._url,
            data=body,
            headers={"Content-Type": "application/json", "DD-API-KEY": self._api_key},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                resp.read()
            self.shipped += len(batch)
        except Exception:  # noqa: BLE001 - best-effort shipping, drop on failure
            self.dropped += len(batch)

    def close(self) -> None:
        # enqueue the CLOSE sentinel even against a full queue (drop ONE
        # buffered record to make room — at process exit the flush of the
        # remaining backlog matters more), and always attempt the join:
        # crash-time incident logs are the whole point of shipping
        try:
            self._queue.put_nowait(self._CLOSE)  # type: ignore[arg-type]
        except queue.Full:
            try:
                self._queue.get_nowait()
                self.dropped += 1
                self._queue.put_nowait(self._CLOSE)  # type: ignore[arg-type]
            except (queue.Empty, queue.Full):
                pass
        try:
            self._worker.join(timeout=10.0)
        except RuntimeError:
            pass
        super().close()


def configure_logger(
    tags: Optional[Mapping[str, str]] = None,
    level: str = "info",
    verbosity: int = 1,
    stream=None,
    datadog_api_key: Optional[str] = None,
    datadog_intake_url: Optional[str] = None,
) -> VLogger:
    """Configure the root tpu-nexus logger with JSON output and static tags.

    Datadog log shipping attaches when an API key is given explicitly or
    via ``DD_API_KEY`` (the Helm chart's secret wiring); site/service come
    from ``DD_SITE``/``DD_SERVICE``.  Without a key, stderr JSON remains
    the only sink (cluster log collectors pick it up)."""
    logger = logging.getLogger("tpu_nexus_torch")
    logger.setLevel(_LEVELS.get((level or "info").lower(), logging.INFO))
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonFormatter(tags))
    handlers: List[logging.Handler] = [handler]
    api_key = datadog_api_key or os.environ.get("DD_API_KEY", "")
    if api_key:
        dd = DatadogLogHandler(
            api_key=api_key,
            site=os.environ.get("DD_SITE", "datadoghq.com"),
            service=os.environ.get("DD_SERVICE", "tpu-nexus-supervisor"),
            tags=tags,
            intake_url=datadog_intake_url or os.environ.get("DD_LOGS_INTAKE_URL") or None,
        )
        dd.setFormatter(JsonFormatter(tags))
        handlers.append(dd)
    # close displaced handlers first: a reconfiguration must not leak the
    # previous shipper thread + its buffered queue for the process lifetime
    for old in logger.handlers:
        try:
            old.close()
        except Exception:  # noqa: BLE001 - teardown must not block re-init
            pass
    logger.handlers = handlers
    logger.propagate = False
    return VLogger(logger, verbosity=verbosity)


def get_logger(name: str = "tpu_nexus_torch", verbosity: int = 1) -> VLogger:
    return VLogger(logging.getLogger(name), verbosity=verbosity)


class Metrics:
    """Minimal metrics interface: counters, gauges, timings (DogStatsD verbs)."""

    def count(self, name: str, value: int = 1, tags: Optional[Mapping[str, str]] = None) -> None:
        raise NotImplementedError

    def gauge(self, name: str, value: float, tags: Optional[Mapping[str, str]] = None) -> None:
        raise NotImplementedError

    def timing(self, name: str, seconds: float, tags: Optional[Mapping[str, str]] = None) -> None:
        raise NotImplementedError

    def histogram(self, name: str, value: float, tags: Optional[Mapping[str, str]] = None) -> None:
        """Distribution sample (DogStatsD ``|h``): the agent aggregates
        percentiles server-side — the right verb for per-request latency
        SLOs (serving TTFT/TPOT) where ``timing`` would mis-tag units and
        ``gauge`` would drop all but the last sample per flush."""
        raise NotImplementedError


class NullMetrics(Metrics):
    def count(self, name, value=1, tags=None) -> None:  # noqa: ANN001
        pass

    def gauge(self, name, value, tags=None) -> None:  # noqa: ANN001
        pass

    def timing(self, name, seconds, tags=None) -> None:  # noqa: ANN001
        pass

    def histogram(self, name, value, tags=None) -> None:  # noqa: ANN001
        pass


class RecordingMetrics(Metrics):
    """In-memory recorder for tests.

    ``counters`` aggregates by bare metric name (the long-standing
    contract); ``tagged_counts`` additionally aggregates by
    ``(name, sorted "k:v" tag tuple)`` so tests can assert tag DIMENSIONS
    — e.g. that a retirement really carried its ``cause:`` tag — which the
    name-keyed dict erases."""

    def __init__(self) -> None:
        self.counters: Dict[str, int] = {}
        self.tagged_counts: Dict[tuple, int] = {}
        self.gauges: Dict[str, float] = {}
        self.timings: Dict[str, list] = {}
        self.histograms: Dict[str, list] = {}

    def count(self, name, value=1, tags=None) -> None:  # noqa: ANN001
        self.counters[name] = self.counters.get(name, 0) + value
        key = (name, tuple(sorted(f"{k}:{v}" for k, v in (tags or {}).items())))
        self.tagged_counts[key] = self.tagged_counts.get(key, 0) + value

    def gauge(self, name, value, tags=None) -> None:  # noqa: ANN001
        self.gauges[name] = value

    def timing(self, name, seconds, tags=None) -> None:  # noqa: ANN001
        self.timings.setdefault(name, []).append(seconds)

    def histogram(self, name, value, tags=None) -> None:  # noqa: ANN001
        self.histograms.setdefault(name, []).append(value)


class StatsdClient(Metrics):
    """DogStatsD-format emitter, UDP (host:port) or UDS (unix:///path).

    Fire-and-forget: socket errors are swallowed — telemetry must never take
    down the supervision hot path (the reference's statsd is equally
    best-effort UDP).
    """

    #: default datagram ceiling: the DogStatsD-over-UDP convention (1432 =
    #: ethernet MTU minus headers — datagrams above it risk IP
    #: fragmentation, and a fragmented-and-dropped datagram is a silently
    #: lost metric).  Oversized payloads are truncated tags-first (a
    #: tagless metric is still a VALID metric; a byte-truncated one is
    #: garbage the agent rejects) and counted on ``truncated``.
    DEFAULT_MAX_DATAGRAM = 1432

    def __init__(
        self,
        namespace: str,
        address: Optional[str] = None,
        static_tags: Optional[Mapping[str, str]] = None,
        max_datagram_bytes: int = DEFAULT_MAX_DATAGRAM,
    ) -> None:
        if max_datagram_bytes < 64:
            raise ValueError(
                f"max_datagram_bytes must be >= 64, got {max_datagram_bytes}"
            )
        self.namespace = namespace.rstrip(".")
        self.max_datagram_bytes = max_datagram_bytes
        #: oversized datagrams sent without tags, or dropped entirely when
        #: even the bare metric line exceeded the ceiling
        self.truncated = 0
        #: datagrams lost to socket/encoding failures (the fire-and-forget
        #: contract made auditable: the engine loop never sees a raise,
        #: but a drill can assert the failure was COUNTED, not vanished)
        self.send_errors = 0
        self._tags = [f"{k}:{v}" for k, v in (static_tags or {}).items()]
        address = address or os.environ.get("DD_DOGSTATSD_URL") or "udp://127.0.0.1:8125"
        self._sock: Optional[socket.socket] = None
        try:
            if address.startswith("unix://"):
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
                sock.connect(address[len("unix://"):])
            else:
                if address.startswith("udp://"):
                    address = address[len("udp://"):]
                host, _, port = address.partition(":")
                sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                # connect() resolves once here, not per-datagram on the hot path
                sock.connect((host, int(port or 8125)))
            sock.setblocking(False)
            self._sock = sock
        except OSError:
            self._sock = None

    def _send(self, payload: str, tags: Optional[Mapping[str, str]]) -> None:
        if self._sock is None:
            return
        try:
            base = payload.encode("utf-8")
            all_tags = self._tags + [f"{k}:{v}" for k, v in (tags or {}).items()]
            if all_tags:
                wire = base + f"|#{','.join(all_tags)}".encode("utf-8")
            else:
                wire = base
            if len(wire) > self.max_datagram_bytes:
                # truncate-with-counter: drop the tag section first (the
                # bare metric line is still valid DogStatsD; a mid-payload
                # byte cut would be garbage the agent rejects) — and when
                # even the bare line is oversized, drop the datagram
                self.truncated += 1
                if len(base) > self.max_datagram_bytes:
                    return
                wire = base
            self._sock.send(wire)
        except Exception:  # noqa: BLE001 - fire-and-forget contract (module doc): NO failure in the telemetry path — socket, encoding, a tag value whose __str__ raises — may propagate into the engine/supervision hot path; counted on send_errors so drills can assert the loss was recorded
            self.send_errors += 1

    def count(self, name, value=1, tags=None) -> None:  # noqa: ANN001
        self._send(f"{self.namespace}.{name}:{value}|c", tags)

    def gauge(self, name, value, tags=None) -> None:  # noqa: ANN001
        self._send(f"{self.namespace}.{name}:{value}|g", tags)

    def timing(self, name, seconds, tags=None) -> None:  # noqa: ANN001
        self._send(f"{self.namespace}.{name}:{seconds * 1000.0:.3f}|ms", tags)

    def histogram(self, name, value, tags=None) -> None:  # noqa: ANN001
        self._send(f"{self.namespace}.{name}:{value}|h", tags)


class Timer:
    """Context manager emitting a timing metric."""

    def __init__(self, metrics: Metrics, name: str, tags: Optional[Mapping[str, str]] = None) -> None:
        self._metrics = metrics
        self._name = name
        self._tags = tags
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:  # noqa: ANN002
        self.elapsed = time.perf_counter() - self._start
        self._metrics.timing(self._name, self.elapsed, self._tags)
