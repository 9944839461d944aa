"""Workload entrypoint and the serving loop of the port."""
