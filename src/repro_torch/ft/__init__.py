from .checkpoint import (CheckpointCorrupt, CheckpointManager,
                         load_checkpoint, save_checkpoint)
from .straggler import StragglerDetector

__all__ = ["CheckpointCorrupt", "CheckpointManager", "load_checkpoint",
           "save_checkpoint", "StragglerDetector"]
