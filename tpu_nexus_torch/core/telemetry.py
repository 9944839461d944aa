"""Workload metrics: a copy of ``Metrics``, ``NullMetrics``,
``RecordingMetrics`` and ``StatsdClient`` from ``tpu_nexus/core/
telemetry.py`` (DogStatsD verbs, fire-and-forget).  The metric names the
training loop emits are the reference's (``train.loss``,
``train.grad_norm``, ``train.anomaly``, ``train.skip``, ``train.goodput``,
``train.tokens_per_second``, ``train.mfu``)."""

from __future__ import annotations

import os
import socket
from typing import Dict, Mapping, Optional


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
