"""Observability for the port: a copy of the reference's jax-free metrics
registry (``obs/metrics.py``), which the serving telemetry sits on."""
