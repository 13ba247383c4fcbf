"""Event-stream serving runtime of the port (``repro.serving``): sessions,
the slot-multiplexed scheduler over per-tier chunk steps with pipelined
staging, async source ingestion, the adaptive pipeline depth, per-stream
adaptation, the live topology service, fleet checkpoints and telemetry."""
from .adapt import (AdaptConfig, delta_norms, make_chunk_fn,
                    merge_lane_into_base)
from .autopilot import AutopilotConfig, DepthAutopilot
from .checkpointing import restore_fleet, save_fleet
from .ingest import IngestConfig, IngestWorker
from .scheduler import StreamScheduler, TierConfig
from .session import (SessionStatus, StreamSession, WindowPrediction,
                      fresh_lane_state, read_lane, reset_lane, write_lane)
from .staging import InFlight, LaneRecord, StagedChunk, StagingPipeline
from .stream_source import (AERStreamSource, ArrivalConfig, ReplaySource,
                            TaskStreamSource, aer_decode, aer_encode)
from .telemetry import FleetTelemetry, StreamCounters
from .topology_service import (TopologyEpochEvent, TopologyService,
                               TopologyServiceConfig)

__all__ = [
    "AdaptConfig", "AERStreamSource", "ArrivalConfig", "AutopilotConfig",
    "DepthAutopilot", "FleetTelemetry", "InFlight", "IngestConfig",
    "IngestWorker", "LaneRecord", "ReplaySource", "SessionStatus",
    "StagedChunk", "StagingPipeline", "StreamCounters", "StreamScheduler",
    "StreamSession", "TaskStreamSource", "TierConfig", "TopologyEpochEvent",
    "TopologyService", "TopologyServiceConfig", "WindowPrediction",
    "aer_decode", "aer_encode", "delta_norms", "fresh_lane_state",
    "make_chunk_fn", "merge_lane_into_base", "read_lane", "reset_lane",
    "restore_fleet", "save_fleet", "write_lane",
]
