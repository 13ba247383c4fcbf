"""Event-stream serving runtime of the port (``repro.serving``, one tier):
sessions, the slot-multiplexed scheduler, per-stream adaptation, the live
topology service, fleet checkpoints and telemetry."""
from .adapt import (AdaptConfig, delta_norms, make_chunk_fn,
                    merge_lane_into_base)
from .checkpointing import restore_fleet, save_fleet
from .scheduler import StreamScheduler
from .session import (SessionStatus, StreamSession, WindowPrediction,
                      fresh_lane_state, read_lane, reset_lane, write_lane)
from .stream_source import ArrivalConfig, ReplaySource, TaskStreamSource
from .telemetry import FleetTelemetry, StreamCounters
from .topology_service import (TopologyEpochEvent, TopologyService,
                               TopologyServiceConfig)

__all__ = [
    "AdaptConfig", "ArrivalConfig", "FleetTelemetry", "ReplaySource",
    "SessionStatus", "StreamCounters", "StreamScheduler", "StreamSession",
    "TaskStreamSource", "TopologyEpochEvent", "TopologyService",
    "TopologyServiceConfig", "WindowPrediction", "delta_norms",
    "fresh_lane_state", "make_chunk_fn", "merge_lane_into_base", "read_lane",
    "reset_lane", "restore_fleet", "save_fleet", "write_lane",
]
