from .checkpoint import (CheckpointCorrupt, CheckpointManager,
                         load_checkpoint, save_checkpoint)
from .compression import compress_grads_int8, decompress_grads_int8
from .elastic import remicrobatch, reshard_tree
from .straggler import StragglerDetector

__all__ = ["CheckpointCorrupt", "CheckpointManager", "load_checkpoint",
           "save_checkpoint", "compress_grads_int8", "decompress_grads_int8",
           "remicrobatch", "reshard_tree", "StragglerDetector"]
