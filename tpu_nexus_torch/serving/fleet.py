"""The serving fleet's checkpoint watcher: the first piece of the port of
``tpu_nexus/serving/fleet.py``.

:class:`CheckpointWatcher` polls
:class:`~tpu_nexus_torch.workload.durability.VerifiedStepPoller`
(commit-marker presence is the trust anchor; a save without its manifest
is invisible here) and offers the newest verified step to its caller —
the serve-engine loop's hot reload (``NEXUS_RELOAD_CHECK_S``).

The rest of the reference module — the replica set behind a router, the
rolling-update state machine and the fleet supervisor — is ROADMAP.md
item A1c.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from tpu_nexus_torch.workload.durability import VerifiedStepPoller


class CheckpointWatcher:
    """Interval-gated newest-verified-step watcher over one checkpoint
    directory.  Commit-marker presence is the trust anchor
    (:class:`~tpu_nexus_torch.workload.durability.VerifiedStepPoller`): a
    torn save has no manifest and simply does not exist to this watcher,
    so it can never be offered for a swap.  ``quarantine=True``
    additionally renames steps that fail verification to ``<step>.corrupt``
    — only for deployments where the fleet owns the directory; the default
    keeps the read-only contract (training owns mutation)."""

    def __init__(
        self,
        directory: str,
        interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        quarantine: bool = False,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"watcher interval_s must be > 0, got {interval_s}")
        self.poller = VerifiedStepPoller(directory, quarantine=quarantine)
        self.interval_s = interval_s
        self._clock = clock
        self._next = 0.0  # first check is immediate

    def check(self, now: Optional[float] = None) -> Optional[int]:
        """The newest VERIFIED step, at most once per interval (None
        between checks or when nothing verifies)."""
        now = self._clock() if now is None else now
        if now < self._next:
            return None
        self._next = now + self.interval_s
        return self.poller.latest_verified_step()
