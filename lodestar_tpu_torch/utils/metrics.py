"""The metrics registry of the BLS service layer, a copy of
`lodestar_tpu/utils/metrics.py` (only the metric kinds the service, the
pipeline, the aggregator, the verifier, the breaker and the gossip queues
observe, and the whole `BlsPoolMetrics` field set).

The names are the JAX package's, verbatim: the reference's
`lodestar_bls_thread_pool_*` family and the `lodestar_bls_*` series,
which dashboards and the node read.  The Prometheus text exposition is
not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence


class Counter:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = v

    @property
    def value(self) -> float:
        return self._v


class LabeledGauge:
    """Gauge with one label dimension (the reference's per-worker
    jobsWorkerTime gauge, labelNames: ["workerId"])."""

    def __init__(self, name: str, help_: str, label: str):
        self.name, self.help, self.label = name, help_, label
        self._v: Dict[str, float] = {}
        self._lock = threading.Lock()

    def inc(self, label_value: str, amount: float) -> None:
        with self._lock:
            self._v[label_value] = self._v.get(label_value, 0.0) + amount

    def set(self, label_value: str, v: float) -> None:
        """Idempotent resample (the gossip queues' depth)."""
        with self._lock:
            self._v[label_value] = v

    def get(self, label_value: str) -> float:
        return self._v.get(label_value, 0.0)

    def label_values(self):
        with self._lock:
            return sorted(self._v)


class LabeledCounter(LabeledGauge):
    """Monotonic labeled counter."""


class Histogram:
    def __init__(self, name: str, help_: str, buckets: Sequence[float]):
        self.name, self.help = name, help_
        # finite, deduplicated bounds; the last count is the +Inf bucket
        self.buckets = sorted({float(b) for b in buckets if float(b) != float("inf")})
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum


class LabeledHistogram:
    """Histogram with one label dimension (`lodestar_bls_verify_seconds`'s
    `phase`)."""

    def __init__(self, name: str, help_: str, label: str, buckets: Sequence[float]):
        self.name, self.help, self.label = name, help_, label
        self._buckets = list(buckets)
        self._children: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def child(self, label_value: str) -> Histogram:
        h = self._children.get(label_value)
        if h is None:
            with self._lock:
                h = self._children.setdefault(label_value, Histogram(self.name, self.help, self._buckets))
        return h

    def observe(self, label_value: str, v: float) -> None:
        self.child(label_value).observe(v)

    def count(self, label_value: str) -> int:
        c = self._children.get(label_value)
        return c.count if c is not None else 0


class Registry:
    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        # registration may race between the service's threads: creation
        # must be atomic or a racing first registration loses its counts
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str) -> Counter:
        return self._get(name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str) -> Gauge:
        return self._get(name, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str, buckets) -> Histogram:
        return self._get(name, lambda: Histogram(name, help_, buckets))

    def labeled_gauge(self, name: str, help_: str, label: str) -> LabeledGauge:
        return self._get(name, lambda: LabeledGauge(name, help_, label))

    def labeled_counter(self, name: str, help_: str, label: str) -> LabeledCounter:
        return self._get(name, lambda: LabeledCounter(name, help_, label))

    def labeled_histogram(self, name: str, help_: str, label: str, buckets) -> LabeledHistogram:
        return self._get(name, lambda: LabeledHistogram(name, help_, label, buckets))

    def get(self, name: str) -> Optional[object]:
        """Registered metric by name (None when absent)."""
        return self._metrics.get(name)

    def _get(self, name, factory):
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = factory()
            return self._metrics[name]


_SECONDS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5]


_GLOBAL_REGISTRY = Registry()


def global_registry() -> Registry:
    """The process-global registry (where the gossip queues' series land
    when the processor is given none)."""
    return _GLOBAL_REGISTRY


class BlsPoolMetrics:
    """The lodestar_bls_thread_pool_* family, verbatim names (reference:
    packages/beacon-node/src/metrics/metrics/lodestar.ts:357-430), and the
    verifier's, pipeline's and aggregation stage's `lodestar_bls_*`
    series."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        p = "lodestar_bls_thread_pool_"
        self.queue_length = r.gauge(p + "queue_length", "Queued verification jobs")
        self.workers_busy = r.gauge(p + "workers_busy", "Busy device streams")
        self.job_wait_time = r.histogram(p + "queue_job_wait_time_seconds", "Time a job waits in queue", _SECONDS)
        self.job_time = r.histogram(p + "job_time_seconds", "Device time per job", _SECONDS)
        # reference name: lodestar_bls_worker_thread_time_per_sigset_seconds
        self.time_per_sig_set = r.histogram(
            "lodestar_bls_worker_thread_time_per_sigset_seconds",
            "Time to verify each sigset on the device path",
            [1e-5, 1e-4, 0.5e-3, 1e-3, 2e-3, 5e-3, 1e-2],
        )
        self.latency_to_worker = r.histogram(
            p + "latency_to_worker",
            "Time from submitting the job to the device dispatch starting",
            [0.001, 0.003, 0.01, 0.03, 0.1],
        )
        self.latency_from_worker = r.histogram(
            p + "latency_from_worker",
            "Time from the device result being ready to futures settling",
            [0.001, 0.003, 0.01, 0.03, 0.1],
        )
        self.jobs_worker_time = r.labeled_gauge(
            p + "time_seconds_sum", "Total time spent verifying signature sets on the device", "workerId"
        )
        self.main_thread_time = r.histogram(
            p + "main_thread_time_seconds", "Time to verify signatures on the main thread (fast path)", [0]
        )
        self.total_job_groups_started = r.counter(p + "job_groups_started_total", "Job groups started")
        self.total_jobs_started = r.counter(p + "jobs_started_total", "Jobs started")
        self.total_sig_sets_started = r.counter(p + "sig_sets_started_total", "Signature sets started")
        self.success_jobs = r.counter(p + "success_jobs_signature_sets_count", "Sig sets verified OK")
        self.error_jobs = r.counter(p + "error_jobs_signature_sets_count", "Error-ed signature sets")
        self.batch_retries = r.counter(p + "batch_retries_total", "Batches re-verified set-by-set")
        self.batch_sigs_success = r.counter(p + "batch_sigs_success_total", "Sig sets verified in a batch")
        self.batchable_sigs = r.counter(p + "batchable_sigs_count", "Sig sets submitted as batchable")
        self.rlc_fallback = r.counter(
            "lodestar_bls_rlc_fallback_total",
            "RLC batch checks that failed and fell back to bisection or per-set retry",
        )
        self.rlc_bisect_depth = r.histogram(
            "lodestar_bls_rlc_bisect_depth",
            "Halving depth needed to isolate bad sets in a failed RLC batch",
            [1, 2, 3, 4, 5, 6, 8, 11],
        )
        self.invalid_sets = r.counter(p + "invalid_sig_sets_count", "Sig sets that failed verification")
        self.batch_size = r.histogram(
            "lodestar_bls_batch_size",
            "Signature sets per verify_signature_sets call",
            [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048],
        )
        self.verify_seconds = r.labeled_histogram(
            "lodestar_bls_verify_seconds",
            "Wall time per verify call by phase (host prep, device sync, total)",
            "phase",
            _SECONDS,
        )
        self.bucket_fill_ratio = r.histogram(
            "lodestar_bls_bucket_fill_ratio",
            "Signature sets per flush over the padded device N-bucket",
            [0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0],
        )
        self.flush_reason = r.labeled_counter(
            "lodestar_bls_flush_reason_total",
            "Pipeline bucket flushes by trigger (fill = exact bucket | spill = partial, pushed out by an "
            "overshooting job | deadline | idle = lone critical job with nothing to coalesce against | close)",
            "reason",
        )
        self.pipeline_pending_sets = r.gauge(
            "lodestar_bls_pipeline_pending_sets",
            "Buffered + queued + in-flight signature sets (high-water unit)",
        )
        self.aggregation_factor = r.histogram(
            "lodestar_bls_aggregation_factor",
            "Contributions per verified signature set at each aggregation-stage flush "
            "(dedupe + same-root point-adds)",
            [1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0],
        )
        self.preagg_contributions = r.counter(
            "lodestar_bls_preagg_contributions_total",
            "Signature-set submissions routed through the pre-verify aggregation stage",
        )
        self.preagg_sets = r.counter(
            "lodestar_bls_preagg_sets_total",
            "Aggregated/leaf signature sets the stage handed to the verify path",
        )
        self.preagg_dedup = r.counter(
            "lodestar_bls_preagg_dedup_total",
            "Exact-duplicate contributions sharing an in-flight twin's verdict",
        )
        self.preagg_seen_served = r.counter(
            "lodestar_bls_preagg_seen_served_total",
            "Contributions served from the resolved-verdict seen-map with zero device work",
        )
        self.preagg_bisections = r.counter(
            "lodestar_bls_preagg_bisections_total",
            "Failed aggregates split contributor-wise for attribution",
        )
