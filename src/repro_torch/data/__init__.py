from .pipeline import DataConfig, ShardIndex, SyntheticLM, make_batches

__all__ = ["DataConfig", "ShardIndex", "SyntheticLM", "make_batches"]
