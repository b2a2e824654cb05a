"""Serving: bucketed dynamic batching, the hashed-classifier engine, the
LM zoo's greedy decode (``greedy_generate``), and the standard-library
HTTP tier on top (admission control, live stats, graceful drain,
versioned hot reload, the duplicate-traffic cache)."""
from repro_torch.serving.admission import (AdmissionController, Draining,
                                           Overloaded)
from repro_torch.serving.batcher import BucketBatcher, DynamicBatcher
from repro_torch.serving.dedup import DedupCache
from repro_torch.serving.engine import (HashedClassifierEngine,
                                        VersionedScore, VersionedVector,
                                        greedy_generate)
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
           "greedy_generate", "load_serving_params"]
