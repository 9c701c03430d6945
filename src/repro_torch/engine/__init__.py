"""repro_torch.engine — round-0 wave execution (counterpart of
``repro.engine``): the synchronous scheduler and its per-wave trace.  The
pipelined engine, ingestion hosts, the width autotuner, fault supervision,
checkpoints and telemetry wait for ROADMAP queue 1 item 11."""
from repro_torch.engine.scheduler import HostWave, WaveTrace, run_waves

__all__ = ["HostWave", "WaveTrace", "run_waves"]
