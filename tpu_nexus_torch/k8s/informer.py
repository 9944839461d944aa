"""Shared informers: LIST+WATCH per kind with a local cache and handler
fan-out.

Parity with client-go `SharedInformerFactory` as consumed by the reference
(services/supervisor.go:69-103: factory over Events/Pods/Jobs, namespaced,
30s resync default, handlers registered per-informer; informers double as
lookup caches for the resolvers).  Injection seams mirror the reference's
(NewSupervisor optional resyncPeriod + syncState overrides,
services/supervisor.go:69,81-85): tests pass `sync_state=always_ready`.

A copy of ``tpu_nexus/k8s/informer.py``.
"""

from __future__ import annotations

import asyncio
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import VLogger, get_logger
from tpu_nexus_torch.k8s.client import KubeClient
from tpu_nexus_torch.k8s.objects import KIND_TO_TYPE

Handler = Callable[[str, Any], None]  # (event_type, typed_obj)


class Informer:
    """One kind's cache + watch loop."""

    def __init__(
        self,
        client: KubeClient,
        kind: str,
        namespace: str,
        logger: Optional[VLogger] = None,
        resync_period: Optional[timedelta] = None,
    ) -> None:
        self.kind = kind
        self.namespace = namespace
        self._client = client
        self._type = KIND_TO_TYPE[kind]
        self._cache: Dict[Tuple[str, str], Any] = {}
        self._handlers: List[Handler] = []
        self._synced = asyncio.Event()
        self._log = logger or get_logger(f"tpu_nexus_torch.informer.{kind.lower()}")
        #: periodic re-list interval repairing watch divergence (client-go
        #: resync parity, reference 30s default); <=0 disables
        self._resync_seconds = resync_period.total_seconds() if resync_period else 0.0

    # -- registration (AddEventHandler parity) -------------------------------

    def add_event_handler(self, handler: Handler) -> None:
        """Register a handler invoked with ("ADDED"|"MODIFIED"|"DELETED",
        typed object).  The reference registers AddFunc only
        (services/supervisor.go:124-128); handlers here receive the event
        type so they can filter."""
        self._handlers.append(handler)

    # -- cache (GetStore parity; used by resolvers) --------------------------

    def get(self, name: str, namespace: Optional[str] = None) -> Optional[Any]:
        return self._cache.get((namespace or self.namespace, name))

    def items(self) -> List[Any]:
        return list(self._cache.values())

    @property
    def has_synced(self) -> bool:
        return self._synced.is_set()

    # -- run loop ------------------------------------------------------------

    async def run(self, ctx: LifecycleContext) -> None:
        """LIST (seed/repair cache), then WATCH until failure or resync
        deadline, then re-LIST.  Re-lists after the initial sync DIFF against
        the existing cache and dispatch ADDED/MODIFIED/DELETED for anything
        that changed during an outage — watch gaps must not silently drop
        failures."""
        backoff = 0.1
        while not ctx.cancelled:
            try:
                items, rv = await self._client.list_objects(self.kind, self.namespace)
                new_cache = {
                    (
                        (obj.get("metadata") or {}).get("namespace", ""),
                        (obj.get("metadata") or {}).get("name", ""),
                    ): self._type.from_api(obj)
                    for obj in items
                }
                if not self._synced.is_set():
                    self._cache = new_cache
                    # deliver the initial state as ADDED, like client-go does
                    for typed in list(self._cache.values()):
                        self._dispatch("ADDED", typed)
                    self._synced.set()
                else:
                    old_cache, self._cache = self._cache, new_cache
                    for key, typed in new_cache.items():
                        old = old_cache.get(key)
                        if old is None:
                            self._dispatch("ADDED", typed)
                        elif old.raw != typed.raw:
                            self._dispatch("MODIFIED", typed)
                    for key, typed in old_cache.items():
                        if key not in new_cache:
                            self._dispatch("DELETED", typed)
                backoff = 0.1
                await self._watch_until_resync(rv)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - list/watch loop must survive any stream failure and re-list
                self._log.warning(
                    "informer stream failed; re-listing", kind=self.kind, error=repr(exc)
                )
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    async def _watch_until_resync(self, resource_version: str) -> None:
        """Consume the watch stream; return cleanly at the resync deadline
        (caller re-lists and diffs), raise on stream errors."""
        deadline = (
            asyncio.get_running_loop().time() + self._resync_seconds
            if self._resync_seconds > 0
            else None
        )
        stream = self._client.watch_objects(self.kind, self.namespace, resource_version)
        try:
            while True:
                if deadline is not None:
                    timeout = deadline - asyncio.get_running_loop().time()
                    if timeout <= 0:
                        return
                    try:
                        event_type, obj = await asyncio.wait_for(
                            stream.__anext__(), timeout=timeout
                        )
                    except (asyncio.TimeoutError, StopAsyncIteration):
                        return
                else:
                    try:
                        event_type, obj = await stream.__anext__()
                    except StopAsyncIteration:
                        return
                if event_type == "BOOKMARK":
                    continue
                meta = obj.get("metadata") or {}
                key = (meta.get("namespace", ""), meta.get("name", ""))
                typed = self._type.from_api(obj)
                if event_type == "DELETED":
                    self._cache.pop(key, None)
                else:
                    self._cache[key] = typed
                self._dispatch(event_type, typed)
        finally:
            await stream.aclose()

    def _dispatch(self, event_type: str, typed: Any) -> None:
        for handler in self._handlers:
            try:
                handler(event_type, typed)
            except Exception:  # noqa: BLE001 - one handler's bug must not starve the other handlers
                self._log.exception("informer handler raised", kind=self.kind)


def always_ready(*informers: Informer) -> bool:
    """Test sync-state override (reference alwaysReady,
    services/supervisor_test.go:20-21)."""
    return True


class SharedInformerFactory:
    def __init__(
        self,
        client: KubeClient,
        namespace: str,
        resync_period: Optional[timedelta] = None,
        logger: Optional[VLogger] = None,
    ) -> None:
        self._client = client
        self.namespace = namespace
        # resync default 30s (reference services/supervisor.go:70-71)
        self.resync_period = resync_period if resync_period is not None else timedelta(seconds=30)
        self._informers: Dict[str, Informer] = {}
        self._tasks: List[asyncio.Task] = []
        self._log = logger or get_logger("tpu_nexus_torch.informer_factory")

    def informer_for(self, kind: str) -> Informer:
        if kind not in self._informers:
            self._informers[kind] = Informer(
                self._client, kind, self.namespace, self._log,
                resync_period=self.resync_period,
            )
        return self._informers[kind]

    @property
    def informers(self) -> Dict[str, Informer]:
        """Kind-keyed informer map (reference services/supervisor.go:119-122)."""
        return dict(self._informers)

    def start(self, ctx: LifecycleContext, kinds: Optional[List[str]] = None) -> None:
        """Start informers (all, or just `kinds`).  Idempotent per kind."""
        for informer in self._informers.values():
            if kinds is not None and informer.kind not in kinds:
                continue
            if any(t.get_name() == f"informer-{informer.kind}" and not t.done() for t in self._tasks):
                continue
            self._tasks.append(asyncio.create_task(informer.run(ctx), name=f"informer-{informer.kind}"))

    async def wait_for_cache_sync(
        self,
        timeout: float = 30.0,
        sync_state: Optional[Callable[..., bool]] = None,
        kinds: Optional[List[str]] = None,
    ) -> bool:
        """Block until informer caches have completed their initial LIST
        (cache.WaitForCacheSync parity, reference services/supervisor.go:380-384).
        `sync_state` is the test override seam."""
        informers = [
            inf for inf in self._informers.values() if kinds is None or inf.kind in kinds
        ]
        if sync_state is not None:
            return sync_state(*informers)
        try:
            await asyncio.wait_for(
                asyncio.gather(*(inf._synced.wait() for inf in informers)),
                timeout=timeout,
            )
            return True
        except asyncio.TimeoutError:
            return False

    async def shutdown(self) -> None:
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
