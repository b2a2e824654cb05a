"""Serving: bucketed dynamic batching, the hashed-classifier engine, and
the standard-library HTTP tier on top (admission control, live stats,
graceful drain, versioned hot reload, the duplicate-traffic cache).
The reference's ``greedy_generate`` decodes the LM zoo and waits for
ROADMAP A6."""
from repro_torch.serving.admission import (AdmissionController, Draining,
                                           Overloaded)
from repro_torch.serving.batcher import BucketBatcher, DynamicBatcher
from repro_torch.serving.dedup import DedupCache
from repro_torch.serving.engine import (HashedClassifierEngine,
                                        VersionedScore, VersionedVector)
from repro_torch.serving.reload import (ReloadManager, WeightSet,
                                        load_serving_params)
from repro_torch.serving.server import (HTTPStatusError, ScoreClient,
                                        ScoreServer)
from repro_torch.serving.stats import NnzHistogram, StatsWindow

__all__ = ["AdmissionController", "BucketBatcher", "DedupCache",
           "Draining", "DynamicBatcher", "HTTPStatusError",
           "HashedClassifierEngine", "NnzHistogram", "Overloaded",
           "ReloadManager", "ScoreClient", "ScoreServer", "StatsWindow",
           "VersionedScore", "VersionedVector", "WeightSet",
           "load_serving_params"]
