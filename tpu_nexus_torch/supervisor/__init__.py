"""The supervision service (reference L3, services/supervisor.go), ported
from ``tpu_nexus/supervisor``: ``taxonomy`` (failure classification),
``resolvers`` (event filtering over the informer caches), ``service``
(``Supervisor``, ``ProcessingConfig``) and ``watchdog`` (ledger liveness).

Nothing is imported here: the serving engine reads ``taxonomy`` alone, and
the supervisor's service and its queues stay off that path.
"""
