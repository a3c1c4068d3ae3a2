from .checkpoint import CheckpointManager
from .straggler import StepTimeMonitor

__all__ = ["CheckpointManager", "StepTimeMonitor"]
