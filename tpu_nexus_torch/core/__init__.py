"""Process-level plumbing of the port: signals and telemetry (copies of the
pieces of ``tpu_nexus/core`` that the training loop needs)."""
