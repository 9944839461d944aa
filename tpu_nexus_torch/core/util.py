"""Small helpers: a copy of ``tpu_nexus/core/util.py`` (reference: nexus-core
pkg/util, used at services/supervisor.go:71)."""

from __future__ import annotations

import random
from typing import Optional, TypeVar

T = TypeVar("T")


def coalesce(*values: Optional[T]) -> Optional[T]:
    """Return the first non-None value (reference CoalescePointer, 2-arg;
    generalized to n-ary)."""
    for v in values:
        if v is not None:
            return v
    return None


def backoff_jitter_s(
    attempt: int, base_s: float, max_s: float, rng: random.Random
) -> float:
    """Exponential backoff with FULL jitter: uniform in
    ``(0, min(max_s, base_s * 2**attempt)]`` for a 0-based ``attempt``.
    One implementation for every transient-retry loop in the repo (the
    serving step-fault policy and the CQL reconnect path) so a tuning fix
    — or a jitter-shape change — cannot silently diverge between them.
    Full jitter (vs. plain exponential) decorrelates a fleet of N hosts
    retrying the same rolled coordinator / flapped link in lockstep."""
    ceiling = min(max_s, base_s * (2.0 ** attempt))
    return rng.uniform(0.0, ceiling) if ceiling > 0 else 0.0
