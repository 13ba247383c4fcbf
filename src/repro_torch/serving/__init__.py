"""Event-stream serving runtime of the port (``repro.serving``, one tier)."""
from .adapt import AdaptConfig, delta_norms, make_chunk_fn
from .scheduler import StreamScheduler
from .session import (SessionStatus, StreamSession, WindowPrediction,
                      read_lane, reset_lane, write_lane)
from .stream_source import ArrivalConfig, ReplaySource, TaskStreamSource
from .telemetry import FleetTelemetry, StreamCounters

__all__ = [
    "AdaptConfig", "ArrivalConfig", "FleetTelemetry", "ReplaySource",
    "SessionStatus", "StreamCounters", "StreamScheduler", "StreamSession",
    "TaskStreamSource", "WindowPrediction", "delta_norms", "make_chunk_fn",
    "read_lane", "reset_lane", "write_lane",
]
