"""Runtime of the port (``repro.runtime``): failure recovery, straggler
policy and gradient compression with error feedback."""
from .compression import CompressionConfig, compress, decompress, ErrorFeedback  # noqa: F401
from .fault_tolerance import (HeartbeatMonitor, StragglerPolicy,  # noqa: F401
                              run_with_recovery, elastic_remesh)
