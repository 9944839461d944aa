"""Signal-aware lifecycle context: a copy of ``tpu_nexus/core/signals.py``.

Returns a context object that is cancelled on the first SIGINT/SIGTERM; a
second signal hard-exits the process (the client-go convention the
supervisor's reference inherits).
"""

from __future__ import annotations

import asyncio
import os
import signal
import threading
from typing import Optional


class LifecycleContext:
    """Cancellation token usable from both sync and asyncio code.

    `done()` is an asyncio.Event bound lazily to the running loop;
    `cancelled` is a thread-safe flag for sync consumers.
    """

    def __init__(self) -> None:
        self._flag = threading.Event()
        self._async_event: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        #: WHY the context was cancelled ("SIGTERM", "SIGINT", or whatever
        #: the canceller passed) — the serving drain protocol records it in
        #: the ledger so the supervisor sees "preempted by SIGTERM", not
        #: just a stage flip.  First cancellation wins; empty until then.
        self.reason: str = ""

    @property
    def cancelled(self) -> bool:
        return self._flag.is_set()

    def cancel(self, reason: str = "") -> None:
        if reason and not self._flag.is_set():
            self.reason = reason
        self._flag.set()
        if self._loop is not None and self._async_event is not None:
            self._loop.call_soon_threadsafe(self._async_event.set)

    def done(self) -> asyncio.Event:
        """The asyncio event, bound to the current running loop on first use."""
        loop = asyncio.get_running_loop()
        if self._async_event is None or self._loop is not loop:
            self._async_event = asyncio.Event()
            self._loop = loop
            if self._flag.is_set():
                self._async_event.set()
        return self._async_event

    async def wait(self) -> None:
        await self.done().wait()


def setup_signal_context(install: bool = True) -> LifecycleContext:
    """Create a LifecycleContext cancelled on SIGINT/SIGTERM.

    With install=False, returns an uninstalled context (tests cancel it
    manually — the injection seam the reference gets from passing ctx around).
    """
    ctx = LifecycleContext()
    if not install:
        return ctx

    def _handler(signum, frame):  # noqa: ANN001
        if ctx.cancelled:
            # second signal: hard exit, matching client-go signal handler
            os._exit(1)
        ctx.cancel(reason=signal.Signals(signum).name)

    signal.signal(signal.SIGINT, _handler)
    signal.signal(signal.SIGTERM, _handler)
    return ctx
