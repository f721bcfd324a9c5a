"""Runtime: the fault-tolerant training driver and the straggler watchdog."""
from .driver import DriverConfig, StragglerStats, TrainDriver, resume_or_init  # noqa: F401
