"""Host-side spans and metrics: the port's own copy of what serving uses
from `repro.obs` (same ``REPRO_OBS`` knob, no JAX profiler hook)."""
