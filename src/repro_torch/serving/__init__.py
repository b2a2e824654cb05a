"""Serving: bucketed dynamic batching and the hashed-classifier engine."""
from repro_torch.serving.batcher import BucketBatcher
from repro_torch.serving.engine import (HashedClassifierEngine,
                                        VersionedScore, VersionedVector)
from repro_torch.serving.reload import WeightSet
from repro_torch.serving.stats import NnzHistogram, StatsWindow

__all__ = ["BucketBatcher", "HashedClassifierEngine",
           "NnzHistogram", "StatsWindow", "VersionedScore",
           "VersionedVector", "WeightSet"]
