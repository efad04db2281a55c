"""Serving subsystem of the port — the PC2IM serving runtime on the card.

Layered back to front: `queue` (bounded admission, deadlines, futures),
`scheduler` (shape-bucketed dynamic micro-batching keyed by the full
ExecutionPolicy — pipeline schedule included), `dispatch` (per-device
replica pool with heartbeat eviction, CUDA streams per replica and the
two-stage pipelined path), `metrics`, and `runtime` (the `ServingRuntime`
facade most callers want).  `hashing` / `preprocess_cache` implement the
cross-request preprocess cache: content-addressed duplicate clouds skip
the preprocess stage and enter the feature stage directly.  The SLO
control plane sits on top: `slo` (service classes with priority/deadline/
shed policy), `autoscaler` (replica rejoin + queue-depth/cost-signal
scaling) and `chaos` (deterministic fault injection for recovery tests).
`trace` / `obs` are the observability layer: a ring-buffered lifecycle
tracer every component reports into, and the reductions/exporters (stage
breakdown, Chrome-trace JSON, Prometheus text — live via `MetricsServer`)
built on it.  `adapt` closes the loop from observation back to the knobs:
the `AdaptiveController` retunes buckets / max_batch / batching patience
through the runtime's pause-free `reconfigure` path, which warms (on the
card: captures) the new shapes before the swap.  `pointcloud` is the
synchronous per-batch serve function, and `step` the LM serving steps
(`make_serve_fns`: prefill and greedy decode of the dense LMs).
"""

from repro_torch.serve.adapt import (  # noqa: F401
    AdaptiveConfig,
    AdaptiveController,
    Decision,
    DecisionLog,
    Histogram,
    interarrival_mean,
    padding_waste,
    propose_buckets,
    propose_wait,
)
from repro_torch.serve.autoscaler import Autoscaler, AutoscalerConfig, ScaleEvent  # noqa: F401
from repro_torch.serve.chaos import ChaosError, ChaosEvent, ChaosInjector, Fault  # noqa: F401
from repro_torch.serve.dispatch import NoReplicaAvailable, Replica, ReplicaPool  # noqa: F401
from repro_torch.serve.hashing import (  # noqa: F401
    DEFAULT_QUANT_STEP,
    content_key,
    quantize_cloud,
)
from repro_torch.serve.metrics import (  # noqa: F401
    BatchRecord,
    ClassSnapshot,
    MetricsSnapshot,
    ServeMetrics,
)
from repro_torch.serve.pointcloud import (  # noqa: F401
    PointCloudServeConfig,
    inverse_subsample_indices,
    make_pointcloud_serve_fns,
    pad_cloud,
    subsample_indices,
)
from repro_torch.serve.preprocess_cache import (  # noqa: F401
    CacheConfig,
    CacheEntry,
    PreprocessCache,
    PreprocessCacheStats,
)
from repro_torch.serve.queue import (  # noqa: F401
    AdmissionError,
    AdmissionQueue,
    DeadlineExceeded,
    QueueClosed,
    QueueFull,
    Request,
    Shed,
)
from repro_torch.serve.obs import (  # noqa: F401
    STAGES,
    BatchCheck,
    MetricsServer,
    Reporter,
    RequestTimeline,
    StageBreakdown,
    batch_crosscheck,
    graph_medians,
    graph_spans,
    graph_stage_spans,
    padded_batch_responses,
    prometheus_text,
    request_timelines,
    served_batches,
    stage_breakdown,
    to_chrome_trace,
    trace_problems,
    write_chrome_trace,
)
from repro_torch.serve.runtime import (  # noqa: F401
    RuntimeConfig,
    ServingRuntime,
    make_serving_runtime,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    BatchScheduler,
    MicroBatch,
    SchedulerConfig,
    assemble_batch,
    bucket_for,
    scatter_results,
)
from repro_torch.serve.slo import BULK, DEFAULT, INTERACTIVE, SLOClass  # noqa: F401
from repro_torch.serve.trace import (  # noqa: F401
    EVENTS,
    TERMINAL_EVENTS,
    TraceConfig,
    TraceEvent,
    Tracer,
)
from repro_torch.serve.step import make_serve_fns  # noqa: F401
