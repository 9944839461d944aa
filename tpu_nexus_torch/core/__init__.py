"""Process-level plumbing of the port: copies of ``tpu_nexus/core`` —
config loading, signals, logging and metrics, the pipeline actor, build
metadata and small helpers."""
