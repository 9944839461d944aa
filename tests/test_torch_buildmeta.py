"""The port's counterpart of ``tests/test_buildmeta.py`` (``tpu_nexus_torch``).

buildmeta + workload entrypoint env plumbing (coverage parity: the
reference gates every file at 70%, .testcoverage.yml:3-6 — no module may
stay dark)."""

import importlib
import os
from unittest import mock

import tpu_nexus_torch


def test_buildmeta_defaults_to_package_version():
    from tpu_nexus_torch.core import buildmeta

    assert buildmeta.APP_VERSION == tpu_nexus_torch.__version__
    assert buildmeta.BUILD_NUMBER == "dev"


def test_buildmeta_env_injection():
    from tpu_nexus_torch.core import buildmeta

    with mock.patch.dict(os.environ, {
        "TPU_NEXUS_APP_VERSION": "9.9.9", "TPU_NEXUS_BUILD_NUMBER": "b42",
    }):
        importlib.reload(buildmeta)
        assert buildmeta.APP_VERSION == "9.9.9"
        assert buildmeta.BUILD_NUMBER == "b42"
    importlib.reload(buildmeta)  # restore for other tests


def test_device_env_is_cuda_without_request():
    """The reference's ``_apply_platform_env`` pins JAX's platform; the
    port's device switch is ``NEXUS_DEVICE``, and without it every mode of
    the entry point runs on the card."""
    from tpu_nexus_torch.workload.harness import WorkloadConfig
    from tpu_nexus_torch.workload.serve import ServeConfig

    assert WorkloadConfig.from_env({}).device == "cuda"
    assert ServeConfig.from_env({}).device == "cuda"


def test_device_env_applies_cpu():
    """``NEXUS_DEVICE=cpu`` (what CI and the CPU tests set) reaches the
    train and serve configs the entry point builds."""
    from tpu_nexus_torch.workload.harness import WorkloadConfig
    from tpu_nexus_torch.workload.serve import ServeConfig

    with mock.patch.dict(os.environ, {"NEXUS_DEVICE": "cpu"}):
        assert WorkloadConfig.from_env().device == "cpu"
        assert ServeConfig.from_env().device == "cpu"
