"""Observability for the port: copies of the reference's jax-free metrics
registry (``obs/metrics.py``), which the serving telemetry sits on, and
span tracer (``obs/trace.py``), which the continuous batcher records into."""
from .trace import NULL_TRACER, Span, Tracer  # noqa: F401
