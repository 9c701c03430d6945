"""repro_torch.engine — how round 0 executes and how a run survives faults
and restarts (counterpart of ``repro.engine``): the sync and pipelined
wave schedulers, the wave-width planners (fixed, scheduled and the
rate-tuned autotuner with its cache), ingestion hosts, fault supervision,
round-boundary checkpoints and telemetry (spans, metrics, run
manifests)."""
from repro_torch.engine.autotune import (AutotuneCache, AutotunePlanner,
                                         FixedWidthPlanner,
                                         ScheduledWidthPlanner, WavePlanner,
                                         bucket_ladder, shape_bound,
                                         snap_down, suggest_prefetch_depth)
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
from repro_torch.engine.telemetry import (CATEGORIES, MANIFEST_NAME,
                                          SCHEMA_VERSION, Counter, Gauge,
                                          Histogram, MetricsRegistry,
                                          RunManifest, SpanEvent, Tracer,
                                          build_manifest, config_dict,
                                          config_fingerprint, dtype_label,
                                          feed_result_metrics, format_report,
                                          profiler_session,
                                          read_jsonl_events, top_spans,
                                          wave_overlap_from_spans)

__all__ = [
    "AutotuneCache", "AutotunePlanner", "FixedWidthPlanner",
    "ScheduledWidthPlanner", "WavePlanner", "bucket_ladder", "shape_bound",
    "snap_down", "suggest_prefetch_depth",
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
    "CATEGORIES", "MANIFEST_NAME", "SCHEMA_VERSION", "Counter", "Gauge",
    "Histogram", "MetricsRegistry", "RunManifest", "SpanEvent", "Tracer",
    "build_manifest", "config_dict", "config_fingerprint", "dtype_label",
    "feed_result_metrics", "format_report", "profiler_session",
    "read_jsonl_events", "top_spans", "wave_overlap_from_spans",
]
