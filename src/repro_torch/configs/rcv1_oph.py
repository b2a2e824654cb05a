"""Expanded-rcv1 with One Permutation Hashing preprocessing (the port's
copy of ``repro/configs/rcv1_oph.py``: the fields its serial streaming
path and its serving tier read, over the port's classes).

Same learning problem as the paper's b-bit hashed linear model over the
D≈2^30 expanded feature space, but the one-time hashing pass uses
densified OPH: one hash evaluation per nonzero instead of k.  k=256 (a
power of two: OPH bins are top-bit ranges) at b=8 sits on the paper's
accuracy plateau at a quarter of the storage of k=500, b=16.

The distributed fields (``stream_data_parallel``, ``stream_procs``,
``ft_elastic``, ``stream_grad_compress``, ``ft_barrier_timeout_s``) are
the reference's and go into ``stream_kwargs`` as it puts them;
``global_batch`` is read by no streaming code in either package and is
not copied.  The cost-model fields (``profile_path``, ``calibrate_*``,
``calibrate_kwargs``) are the reference's, but the port's profile has a
file of its own (a profile of the JAX package is rejected by its
fingerprint, and the two must not overwrite each other).  Its
``serve_inflight_limit`` and
``retrieval_*`` fields are read by no code in either package and are
not copied.
"""
import dataclasses
from typing import Optional

from repro_torch.ft.retry import BackoffPolicy
from repro_torch.models.linear import BBitLinearConfig
from repro_torch.train.supervisor import RestartPolicy


@dataclasses.dataclass(frozen=True)
class OPHPaperConfig:
    name: str = "rcv1-oph"
    scheme: str = "oph"          # densified; 'oph_zero' for zero-coding
    k: int = 256                 # bins — must be a power of two
    b: int = 8
    n_classes: int = 2
    loss: str = "logistic"       # or 'squared_hinge' (Eq. 8)
    C: float = 1.0
    seed: int = 0
    # streaming preprocessing: rows per fused-encode chunk, shards per
    # archive
    preprocess_chunk: int = 4096
    preprocess_shards: int = 16
    # streaming training (train.streaming.fit_streaming): one-pass SGD +
    # Polyak tail averaging from avg_start_frac of the planned steps,
    # shard-boundary checkpoints, prefetch depth (0 = inline; any depth
    # is bit-identical)
    stream_batch: int = 1024
    stream_lr: float = 1e-2
    stream_epochs: int = 1       # one pass — the VW-online comparison
    avg_start_frac: float = 0.5
    ckpt_every_shards: int = 4
    stream_prefetch: int = 2
    # the data-parallel world (None: the serial schedule; N: N shard
    # slots a step, gradients all-reduced with psum_mean)
    stream_data_parallel: Optional[int] = None
    # fault tolerance: restart budget and capped exponential backoff of
    # train.supervisor.run_supervised, the checkpoint ring's depth, and
    # elastic resume (fold the logical world onto the devices alive;
    # power-of-two counts stay bit-identical)
    ft_max_restarts: int = 3
    ft_backoff_base_s: float = 1.0
    ft_backoff_cap_s: float = 60.0
    ft_ckpt_keep_last: int = 3
    ft_elastic: bool = True
    # gangs (train.supervisor.run_multiprocess_supervised): processes (1:
    # a single process), the coordinated checkpoint's barrier budget, and
    # error-feedback gradient compression over the gang's all-reduce
    # (None: exact float32; 8: int8 blockwise absmax; 1: sign+scale)
    stream_procs: int = 1
    ft_barrier_timeout_s: float = 120.0
    stream_grad_compress: Optional[int] = None
    # serving engine (serving.HashedClassifierEngine): micro-batch size
    # and coalescing window, replicas (cuda:0..N-1), the nnz lanes (pad
    # widths) and the batcher's dispatch/resolve overlap depth
    serve_max_batch: int = 64
    serve_max_wait_ms: float = 2.0
    serve_replicas: int = 1
    serve_nnz_buckets: tuple = (128, 512, 2048, 8192, 32768)
    serve_pipeline_depth: int = 2
    # HTTP tier (serving.ScoreServer): bind address, graceful-drain
    # budget, rolling stats window and adaptive-bucket cadence (0 =
    # static lane grid); the in-flight row budget is derived from the
    # engine's pipeline (AdmissionController.for_engine)
    serve_host: str = "127.0.0.1"
    serve_port: int = 8077
    serve_drain_timeout_s: float = 30.0
    serve_stats_window: int = 4096
    serve_adapt_every: int = 0
    # duplicate-traffic score cache (serving/dedup.py): probe on
    # dedup_probe_bands band keys, guard on exact packed-code equality,
    # invalidated per WeightSet swap; rows_per_band=4 at b=8 gives
    # 32-bit band keys, 64 bands at k=256
    dedup_cache: bool = True
    dedup_entries: int = 65536
    dedup_rows_per_band: int = 4
    dedup_probe_bands: int = 4
    # cost-model dispatch: the measured profile read by launch/train.py and
    # launch/serve.py (--profile; launch/calibrate.py writes it; a missing
    # or wrong-device file leaves the static rules), and the calibration
    # pass's own knobs
    profile_path: str = "artifacts/perf/profile_torch.json"
    calibrate_budget_s: float = 60.0
    calibrate_trials: int = 3
    calibrate_max_batch: int = 64
    calibrate_nnz_buckets: tuple = (128, 512, 2048)

    def linear_config(self) -> BBitLinearConfig:
        return BBitLinearConfig(k=self.k, b=self.b,
                                n_classes=self.n_classes)

    def stream_kwargs(self, **overrides) -> dict:
        """Keyword arguments for ``train.streaming.fit_streaming`` at this
        config's scale; overrides for scaled-down runs."""
        kw = dict(epochs=self.stream_epochs, batch_size=self.stream_batch,
                  lr=self.stream_lr, avg_start_frac=self.avg_start_frac,
                  ckpt_every_shards=self.ckpt_every_shards,
                  prefetch=self.stream_prefetch,
                  data_parallel=self.stream_data_parallel,
                  elastic=self.ft_elastic,
                  ckpt_keep_last=self.ft_ckpt_keep_last,
                  grad_compress=self.stream_grad_compress,
                  ckpt_barrier_timeout_s=self.ft_barrier_timeout_s)
        kw.update(overrides)
        return kw

    def restart_policy(self) -> RestartPolicy:
        """The ``train.supervisor.RestartPolicy`` of production runs: a
        restart budget with capped exponential backoff."""
        return RestartPolicy(
            max_restarts=self.ft_max_restarts,
            backoff=BackoffPolicy(base_s=self.ft_backoff_base_s,
                                  factor=2.0,
                                  cap_s=self.ft_backoff_cap_s,
                                  jitter_frac=0.1, seed=self.seed))

    def serve_kwargs(self, **overrides) -> dict:
        """Keyword arguments for ``serving.HashedClassifierEngine`` at
        this config's scale; overrides for scaled-down corpora."""
        kw = dict(scheme=self.scheme, max_batch=self.serve_max_batch,
                  max_wait_ms=self.serve_max_wait_ms,
                  replicas=self.serve_replicas,
                  nnz_buckets=self.serve_nnz_buckets,
                  pipeline_depth=self.serve_pipeline_depth,
                  stats_window=self.serve_stats_window,
                  adapt_every=self.serve_adapt_every)
        kw.update(overrides)
        return kw

    def dedup_kwargs(self, **overrides) -> dict:
        """Keyword arguments enabling the engine's duplicate-traffic
        score cache, to merge into ``serve_kwargs()``'s dict."""
        kw = dict(dedup_cache=self.dedup_cache,
                  dedup_entries=self.dedup_entries,
                  dedup_rows_per_band=self.dedup_rows_per_band,
                  dedup_probe_bands=self.dedup_probe_bands)
        kw.update(overrides)
        return kw

    def calibrate_kwargs(self, **overrides) -> dict:
        """Keyword arguments for ``perf.calibrate`` at this config's
        scale, the one-shot microbenchmark pass behind
        ``launch/calibrate.py``."""
        kw = dict(k=self.k, b_values=(self.b,), schemes=(self.scheme,),
                  max_batch=self.calibrate_max_batch,
                  nnz_buckets=self.calibrate_nnz_buckets,
                  trials=self.calibrate_trials,
                  budget_s=self.calibrate_budget_s, seed=self.seed)
        kw.update(overrides)
        return kw

    def http_kwargs(self, **overrides) -> dict:
        """Keyword arguments for ``serving.ScoreServer``, the HTTP front
        end around an engine built with ``serve_kwargs``."""
        kw = dict(host=self.serve_host, port=self.serve_port,
                  drain_timeout_s=self.serve_drain_timeout_s)
        kw.update(overrides)
        return kw


CONFIG = OPHPaperConfig()
