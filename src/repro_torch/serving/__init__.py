"""Event-stream serving runtime of the port (``repro.serving``, one tier)."""
from .adapt import (AdaptConfig, delta_norms, make_chunk_fn,
                    merge_lane_into_base)
from .scheduler import StreamScheduler
from .session import (SessionStatus, StreamSession, WindowPrediction,
                      read_lane, reset_lane, write_lane)
from .stream_source import ArrivalConfig, ReplaySource, TaskStreamSource
from .telemetry import FleetTelemetry, StreamCounters

__all__ = [
    "AdaptConfig", "ArrivalConfig", "FleetTelemetry", "ReplaySource",
    "SessionStatus", "StreamCounters", "StreamScheduler", "StreamSession",
    "TaskStreamSource", "WindowPrediction", "delta_norms", "make_chunk_fn",
    "merge_lane_into_base", "read_lane", "reset_lane", "write_lane",
]
