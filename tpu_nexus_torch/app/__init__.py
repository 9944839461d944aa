"""App composition: typed config + dependency-injection builder
(reference app/app_config.go + app/app_dependencies.go).

A copy of ``tpu_nexus/app/__init__.py``.
"""

from tpu_nexus_torch.app.config import SupervisorConfig  # noqa: F401
from tpu_nexus_torch.app.dependencies import ApplicationServices  # noqa: F401
