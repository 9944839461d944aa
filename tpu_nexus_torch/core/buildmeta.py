"""Build metadata stamping (reference: nexus-core pkg/buildmeta, injected via
Go ldflags in .container/Dockerfile:14).  Python equivalent: env-injected at
image build time, defaulting to the package version.

A copy of ``tpu_nexus/core/buildmeta.py``.
"""

from __future__ import annotations

import os

import tpu_nexus_torch

APP_VERSION: str = os.environ.get("TPU_NEXUS_APP_VERSION", tpu_nexus_torch.__version__)
BUILD_NUMBER: str = os.environ.get("TPU_NEXUS_BUILD_NUMBER", "dev")
