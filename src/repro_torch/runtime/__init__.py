"""Runtime helpers (the part of `repro.runtime` the scheduler uses)."""
