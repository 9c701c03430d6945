"""repro_torch.engine — how round 0 executes and how a run survives faults
and restarts (counterpart of ``repro.engine``): the sync and pipelined
wave schedulers, the fixed-width wave planner, ingestion hosts, fault
supervision and round-boundary checkpoints.  The width autotuner and
telemetry wait for ROADMAP queue 1 item 11 part 4."""
from repro_torch.engine.autotune import FixedWidthPlanner, WavePlanner
from repro_torch.engine.checkpoint import (AsyncCheckpointWriter,
                                           clean_stale_tmp,
                                           latest_round_checkpoint,
                                           list_round_checkpoints,
                                           load_round_checkpoint,
                                           round_checkpoint_path,
                                           write_round_checkpoint)
from repro_torch.engine.faults import (RETRYABLE, DroppedFractionExceeded,
                                       FaultInjector, FaultPolicy,
                                       FaultProfile, FaultSupervisor,
                                       GatherDeadlineExceeded,
                                       PermanentGatherError, TransientIOError)
from repro_torch.engine.planner import HostShard, IngestionPlan
from repro_torch.engine.scheduler import (ENGINES, EngineConfig, HostWave,
                                          run_waves)
from repro_torch.engine.stats import (FAULT_KINDS, CheckpointStats,
                                      EngineStats, FaultEvent, FaultStats,
                                      RoundCheckpoint, StragglerMonitor,
                                      WaveTrace, overlap_from_traces,
                                      overlap_ratio)

__all__ = [
    "FixedWidthPlanner", "WavePlanner",
    "AsyncCheckpointWriter", "clean_stale_tmp", "latest_round_checkpoint",
    "list_round_checkpoints", "load_round_checkpoint",
    "round_checkpoint_path", "write_round_checkpoint",
    "RETRYABLE", "DroppedFractionExceeded", "FaultInjector", "FaultPolicy",
    "FaultProfile", "FaultSupervisor", "GatherDeadlineExceeded",
    "PermanentGatherError", "TransientIOError",
    "HostShard", "IngestionPlan",
    "ENGINES", "EngineConfig", "HostWave", "run_waves",
    "FAULT_KINDS", "CheckpointStats", "EngineStats", "FaultEvent",
    "FaultStats", "RoundCheckpoint", "StragglerMonitor", "WaveTrace",
    "overlap_from_traces", "overlap_ratio",
]
