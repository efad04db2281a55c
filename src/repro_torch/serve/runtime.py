"""ServingRuntime — the user-facing facade over queue -> scheduler -> pool.

    cfg = get_config("pointnet2-cls")
    params = get_accelerator(cfg).init(torch.Generator().manual_seed(0))
    with ServingRuntime(cfg, params, RuntimeConfig(max_batch=8)) as rt:
        fut = rt.submit(cloud)                      # (n, 3+F) numpy, any n
        logits = fut.result()                       # cls: (C,);  seg: (n, C)
        print(rt.metrics.snapshot().format_row())

One runtime owns one model config; per-request `ExecutionPolicy` selects the
numeric path (fp32 vs SC W16A16) AND the execution schedule
(`pipeline="pipelined"` routes the batch group through the replica's
two-stage overlapped path — preprocess batch k+1 while batch k's feature
MLPs run, on two CUDA streams of the replica).  The scheduler guarantees a
micro-batch never mixes policies or shape buckets, so every batch resolves
to exactly one cached `PC2IMAccelerator` per device, and pipelined vs
sequential batch groups never share a micro-batch.

The runtime serves on every card by default (`device="cpu"` serves on the
CPU, where the kernels' plain versions run); without a card it raises.

With `RuntimeConfig(cache_max_bytes=...)` set, a cross-request preprocess
cache sits in front of the scheduler: content-addressed duplicate clouds
skip the FPS/kNN/partition stage on repeat requests and enter the feature
stage directly (serve/preprocess_cache.py; `rt.cache_stats()` reports
residency, `rt.metrics.snapshot()` the hit rate and saved latency).

The control plane rides on the same runtime: `autoscaler` rejoins
fault-evicted replicas warm and scales on queue depth, `adaptive` retunes
buckets, max_batch and batching patience through `reconfigure`,
`prometheus_port` serves `GET /metrics` and `/healthz`, and
`report_interval_s` prints a periodic summary line to stderr.

`RuntimeConfig(devices_per_replica=g)` carves the devices into groups of
g, one replica a group, and a policy with `sharding="batch"` or
`"tensor"` runs each of its batches over the replica's whole group
(`core.accelerator.MeshArtifacts`), bitwise equal to a single-device
`infer` of the same padded batch; unsharded policies run on the group's
first device.  Sharded batches skip the preprocess cache.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.serve.adapt.controller import AdaptiveConfig, AdaptiveController
from repro_torch.serve.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.serve.dispatch import ReplicaPool, pool_devices
from repro_torch.serve.hashing import DEFAULT_QUANT_STEP
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.obs import MetricsServer, Reporter
from repro_torch.serve.preprocess_cache import CacheConfig, PreprocessCache
from repro_torch.serve.queue import AdmissionError, AdmissionQueue, Shed
from repro_torch.serve.scheduler import BatchScheduler, MicroBatch, SchedulerConfig, bucket_for
from repro_torch.serve.slo import SLOClass
from repro_torch.serve.trace import TraceConfig, Tracer


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """All serving knobs in one hashable bundle.

    buckets=None serves every request at the model config's n_points (one
    static shape); pass e.g. (192, 256) to trade padding waste for a couple
    of extra shapes to warm.  heartbeat_timeout_s=None disables liveness
    eviction (single-process default); when set it must exceed the
    worst-case batch latency or healthy-but-slow replicas get evicted.
    cache_max_bytes > 0 enables the cross-request preprocess cache
    (serve/preprocess_cache.py): duplicate clouds — within cache_quant_step
    float noise — skip the preprocess stage on repeat requests.
    shed_threshold enables load shedding (serve/slo.py): sheddable classes
    are rejected with `Shed` once the queue backlog reaches it.
    autoscaler attaches the replica autoscaling control loop
    (serve/autoscaler.py): fault-evicted replicas rejoin warm and the pool
    grows/shrinks with queue depth.
    class_weights switches the queue drain from strict priority to
    deficit-round-robin across SLO classes (serve/queue.py): each class gets
    throughput proportional to its weight while EDF order holds within a
    class; None keeps the legacy strict-priority drain.
    oversize picks what happens to clouds larger than the biggest bucket:
    "subsample" (default) serves them at the largest bucket via random
    subsampling in pad_cloud, "reject" refuses them at submit with a
    ValueError naming the bucket set.
    prometheus_port attaches a live scrape endpoint (serve/obs.py
    MetricsServer, GET /metrics + /healthz); 0 binds an ephemeral port
    (read it from `rt.metrics_server.url`), None disables the listener.
    report_interval_s attaches the periodic reporter (serve/obs.py
    Reporter): one summary line to stderr every interval.
    adaptive attaches the feedback control loop (serve/adapt/): observed
    size/arrival/occupancy distributions periodically retune buckets,
    max_batch and per-class batching patience through the pause-free
    warm-then-swap reconfiguration path.
    """

    max_batch: int = 8
    max_wait_s: float = 0.005
    max_queue: int = 256
    buckets: tuple[int, ...] | None = None
    n_replicas: int | None = None  # None -> one per device
    # devices per replica: 1 is the one-device replica; > 1 carves the
    # devices into groups and each replica serves sharded policies over its
    # group (core.accelerator.MeshArtifacts); leftover devices are unused
    devices_per_replica: int = 1
    heartbeat_timeout_s: float | None = None
    max_retries: int = 2
    default_timeout_s: float | None = None  # per-request deadline default
    cache_max_bytes: int = 0  # 0 disables the preprocess cache
    cache_quant_step: float = DEFAULT_QUANT_STEP  # content-hash lattice pitch
    shed_threshold: int | None = None  # backlog shed budget (None disables)
    autoscaler: AutoscalerConfig | None = None  # None = no control loop
    trace: TraceConfig | None = None  # None = tracing off (no tracer anywhere)
    report_interval_s: float | None = None  # periodic metrics reporter (None = off)
    class_weights: tuple[tuple[str, float], ...] | None = None  # DRR drain
    oversize: str = "subsample"  # or "reject": refuse clouds past max bucket
    prometheus_port: int | None = None  # scrape endpoint (0 = ephemeral port)
    prometheus_host: str = "127.0.0.1"
    adaptive: AdaptiveConfig | None = None  # None = no feedback loop

    def __post_init__(self):
        if self.buckets is not None:
            b = tuple(self.buckets)
            if not b:
                raise ValueError("buckets must be None or non-empty")
            if any(int(x) != x or x < 1 for x in b):
                raise ValueError(
                    f"buckets must be positive integers, got {b}"
                )
            if any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
                # a silently-sorted or deduplicated bucket list hides a
                # config typo that would otherwise change serving shapes
                raise ValueError(
                    f"buckets must be strictly increasing, got {b} "
                    "(sort them and remove duplicates)"
                )
        if self.oversize not in ("subsample", "reject"):
            raise ValueError(
                f'oversize must be "subsample" or "reject", got {self.oversize!r}'
            )
        if self.class_weights is not None:
            for name, w in self.class_weights:
                if w <= 0:
                    raise ValueError(
                        f"class_weights[{name!r}] must be > 0, got {w}"
                    )
        if self.prometheus_port is not None and self.prometheus_port < 0:
            raise ValueError("prometheus_port must be >= 0 or None")


class ServingRuntime:
    """The user-facing serving facade: queue -> scheduler -> replica pool.

    One instance owns one model config and one params copy per replica;
    `submit` admits ragged clouds and returns per-request futures, with
    the numeric mode and execution schedule chosen per request through an
    ExecutionPolicy.  Use as a context manager (`with ServingRuntime(...)`)
    or call start()/stop() explicitly; see the module docstring for a
    worked example.  `devices` (the reference's argument; it may name one
    device more than once) or `device` (one device) names where the
    replicas run: every card by default, one replica a group of
    `devices_per_replica`.
    """

    def __init__(
        self,
        model_cfg,
        params,
        config: RuntimeConfig | None = None,
        *,
        policy: ExecutionPolicy | None = None,
        device=None,
        devices=None,
    ):
        self.model_cfg = model_cfg
        self.config = config or RuntimeConfig()
        if self.config.devices_per_replica < 1:
            raise ValueError("devices_per_replica must be >= 1")
        if self.config.max_batch % self.config.devices_per_replica != 0:
            # sharded batches split the static batch dim over the group; a
            # non-dividing group would need padding the mesh axis per batch
            raise ValueError(
                f"max_batch={self.config.max_batch} must be divisible by "
                f"devices_per_replica={self.config.devices_per_replica}"
            )
        self.default_policy = resolve_policy(model_cfg, policy)
        # validated strictly-increasing in RuntimeConfig.__post_init__ — a
        # malformed bucket list fails loudly there instead of being sorted
        self.buckets = tuple(self.config.buckets or (model_cfg.n_points,))
        self.metrics = ServeMetrics()
        self._reconfig_lock = threading.Lock()
        # constructed FIRST: every downstream component takes the tracer (or
        # None — the single-branch off path) at construction
        self.tracer = (
            Tracer(self.config.trace) if self.config.trace is not None else None
        )
        self.cache = (
            PreprocessCache(
                CacheConfig(
                    max_bytes=self.config.cache_max_bytes,
                    quant_step=self.config.cache_quant_step,
                ),
                tracer=self.tracer,
            )
            if self.config.cache_max_bytes > 0
            else None
        )
        self.queue = AdmissionQueue(
            self.config.max_queue,
            shed_threshold=self.config.shed_threshold,
            class_weights=(
                dict(self.config.class_weights)
                if self.config.class_weights is not None
                else None
            ),
            # full-queue evictions happen inside queue.submit, past the
            # runtime's admission accounting — the callback keeps the shed
            # counter (and the victim's class breakdown) truthful
            on_shed=lambda req: self.metrics.record_shed(req.slo.name),
            metrics=self.metrics,
            tracer=self.tracer,
        )
        self.pool = ReplicaPool(
            model_cfg,
            params,
            n_replicas=self.config.n_replicas,
            device=device,
            devices=devices,
            devices_per_replica=self.config.devices_per_replica,
            heartbeat_timeout_s=self.config.heartbeat_timeout_s,
            max_retries=self.config.max_retries,
            metrics=self.metrics,
            cache=self.cache,
            tracer=self.tracer,
        )
        self.autoscaler = (
            Autoscaler(self.pool, self.queue, self.config.autoscaler,
                       tracer=self.tracer, metrics=self.metrics)
            if self.config.autoscaler is not None
            else None
        )
        self.scheduler = BatchScheduler(
            self.queue,
            self.pool.submit,
            task=model_cfg.task,
            width=3 + model_cfg.in_features,
            buckets=self.buckets,
            config=SchedulerConfig(
                max_batch=self.config.max_batch,
                max_wait_s=self.config.max_wait_s,
                # two batches per replica keeps every replica busy (one
                # executing, one queued) while the REST of the backlog stays
                # in the admission queue, where priority/EDF/shedding apply
                max_inflight=2 * len(self.pool.replicas),
            ),
            metrics=self.metrics,
            cache=self.cache,
            tracer=self.tracer,
        )
        self.reporter = (
            Reporter(self.metrics, self.config.report_interval_s,
                     tracer=self.tracer)
            if self.config.report_interval_s is not None
            else None
        )
        self.controller = (
            AdaptiveController(self, self.config.adaptive)
            if self.config.adaptive is not None
            else None
        )
        self.metrics_server = (
            MetricsServer(
                self.metrics,
                host=self.config.prometheus_host,
                port=self.config.prometheus_port,
            )
            if self.config.prometheus_port is not None
            else None
        )
        self._started = False
        self._stopped = False

    def _resolve(self, policy: ExecutionPolicy | None) -> ExecutionPolicy:
        """A request's policy: None is the runtime's default policy."""
        return self.default_policy if policy is None else resolve_policy(self.model_cfg, policy)

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        """Start the scheduler thread (idempotent); returns self."""
        if self._stopped:
            # the drain thread is joined and the queue closed; a half-revived
            # runtime would accept submits it can never serve
            raise RuntimeError(
                "ServingRuntime cannot be restarted after stop(); "
                "construct a new instance"
            )
        if not self._started:
            self._started = True
            self.scheduler.start()
            if self.autoscaler is not None:
                self.autoscaler.start()
            if self.controller is not None:
                self.controller.start()
            if self.reporter is not None:
                self.reporter.start()
            if self.metrics_server is not None:
                self.metrics_server.start()
        return self

    def stop(self, drain: bool = True):
        """Stop accepting traffic; drain=True completes everything admitted.

        Safe on a never-started runtime too: the queue still closes (further
        submits raise QueueClosed) and anything admitted is cancelled rather
        than left hanging — without a scheduler nothing could complete it.
        """
        self._stopped = True
        if self.metrics_server is not None:
            self.metrics_server.stop()
        if self.reporter is not None:
            self.reporter.stop()
        if self.controller is not None:
            # stopped before the scheduler: a reconfigure racing shutdown
            # would warm shapes on a pool the shutdown below tears down
            self.controller.stop()
        if self.autoscaler is not None:
            # stopped before the scheduler: a rejoin racing shutdown would
            # spin up a fresh replica the pool.shutdown() below never sees
            self.autoscaler.stop()
        if self._started:
            self.scheduler.stop(drain=drain)
            self._started = False
        else:
            for req in self.queue.close():
                req.future.cancel()
        self.pool.shutdown()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def warmup(self, policies: tuple[ExecutionPolicy | None, ...] = (None,)):
        """Run one zero batch per (bucket, policy) on every replica.

        The first batch on a replica builds the CUDA kernels (nvcc, once per
        process), runs one eager forward and captures, with that replica's
        params copy and streams, every CUDA graph a batch of this (bucket,
        policy) can replay there (`core/graphs.py`): the forward's, and with
        the preprocess cache enabled also the two halves' (mixed and
        all-hit batches), so that nothing is captured mid-traffic, as the
        JAX package's warmup traces every artifact.  A policy with
        pipeline="pipelined" warms the replica's two-stage path, which
        captures the preprocess graph of its preprocess stream and the
        feature graph.  Each warmup batch is recorded in the metrics as a
        batch with n_real == 0, and counts the launches of one forward.  A
        sharded policy runs one eager forward over each replica's group and
        never carries the cache.  A None policy is the runtime's default
        policy, as in `submit` (the JAX package warms the config's default
        policy for None instead).
        """
        width = 3 + self.model_cfg.in_features
        for pol in policies:
            resolved = self._resolve(pol)
            for bucket in self.buckets:
                mb = MicroBatch(
                    requests=(),
                    bucket=bucket,
                    policy=resolved,
                    batch=np.zeros((self.config.max_batch, bucket, width), np.float32),
                    # sharded batches never carry the cache (scheduler parity)
                    cache=self.cache if resolved.sharding is None else None,
                )
                self.pool.warmup(mb)
        return self

    def reconfigure(
        self,
        *,
        buckets: tuple[int, ...] | None = None,
        max_batch: int | None = None,
        max_wait_s: float | None = None,
        class_max_wait: tuple[tuple[str, float], ...] | None = None,
        policies: tuple[ExecutionPolicy | None, ...] = (None,),
    ) -> int:
        """Pause-free knob swap: warm the new shapes, then flip atomically.

        Traffic keeps flowing throughout.  New (bucket x policy) shapes
        at the new (max_batch, bucket, width) are warmed on every alive
        replica FIRST (and registered for rejoin replay), then the
        bucket list and a version-bumped `SchedulerConfig` are swapped in:
        the drain loop reads its config exactly once per tick and a
        request's bucket is fixed at admission, so no in-flight batch ever
        mixes old and new shapes — old-bucket requests finish on the still-
        warmed old shapes while new admissions use the new ones.

        Returns the scheduler-config version the swap produced.  Serialized
        by a lock: concurrent reconfigurations apply one at a time.
        """
        with self._reconfig_lock:
            cur = self.scheduler.config
            new_mb = cur.max_batch if max_batch is None else int(max_batch)
            if new_mb < 1:
                raise ValueError(f"max_batch must be >= 1, got {new_mb}")
            if new_mb % self.config.devices_per_replica != 0:
                raise ValueError(
                    f"max_batch={new_mb} must be divisible by "
                    f"devices_per_replica={self.config.devices_per_replica}"
                )
            if max_wait_s is not None and max_wait_s <= 0:
                raise ValueError(f"max_wait_s must be > 0, got {max_wait_s}")
            new_buckets = self.buckets
            if buckets is not None:
                b = tuple(int(x) for x in buckets)
                if not b or any(x < 1 for x in b) or any(
                    b[i] >= b[i + 1] for i in range(len(b) - 1)
                ):
                    raise ValueError(
                        f"buckets must be non-empty, positive and strictly "
                        f"increasing, got {b}"
                    )
                new_buckets = b
            if class_max_wait is not None:
                for name, w in class_max_wait:
                    if w <= 0:
                        raise ValueError(
                            f"class_max_wait for {name!r} must be > 0, got {w}"
                        )
            if new_buckets != self.buckets or new_mb != cur.max_batch:
                # warm BEFORE the swap so the first post-swap batch never
                # pays set-up latency; pool.warmup is synchronous on every
                # alive replica and registers the shape for rejoin replay
                width = 3 + self.model_cfg.in_features
                for pol in policies:
                    resolved = self._resolve(pol)
                    for bucket in new_buckets:
                        self.pool.warmup(MicroBatch(
                            requests=(),
                            bucket=bucket,
                            policy=resolved,
                            batch=np.zeros((new_mb, bucket, width), np.float32),
                            cache=self.cache if resolved.sharding is None else None,
                        ))
            # the swap: bucket list first (affects only NEW admissions —
            # already-admitted requests carry their bucket), then the
            # scheduler config in one atomic reference assignment
            self.buckets = new_buckets
            applied = self.scheduler.apply_config(dataclasses.replace(
                cur,
                max_batch=new_mb,
                max_wait_s=cur.max_wait_s if max_wait_s is None else max_wait_s,
                class_max_wait=(
                    cur.class_max_wait if class_max_wait is None
                    else tuple(class_max_wait)
                ),
            ))
            return applied.version

    # -- traffic --------------------------------------------------------------

    def submit(
        self,
        cloud: np.ndarray,
        *,
        policy: ExecutionPolicy | None = None,
        timeout_s: float | None = None,
        slo: SLOClass | None = None,
    ):
        """Admit one (n, 3+F) cloud; returns a Future.

        Raises AdmissionError (reason "queue_full" / "closed" / "shed") as
        synchronous backpressure; the future fails with DeadlineExceeded if
        the request's deadline passes before it is batched.  `slo` selects
        the service class (serve/slo.py) — priority in drain/flush order,
        the default deadline when timeout_s is not given, and whether the
        request may be load-shed under backlog.
        """
        cloud = np.asarray(cloud, np.float32)
        if (
            cloud.ndim != 2
            or cloud.shape[0] < 1  # pad_cloud cannot fit an empty cloud
            or cloud.shape[1] != 3 + self.model_cfg.in_features
        ):
            raise ValueError(
                f"cloud must be (n >= 1, {3 + self.model_cfg.in_features}), "
                f"got {cloud.shape}"
            )
        resolved = self._resolve(policy)
        if timeout_s is None and (slo is None or slo.deadline_s is None):
            # the class's default deadline wins over the runtime-wide one;
            # queue.submit applies slo.deadline_s itself when timeout_s
            # stays None
            timeout_s = self.config.default_timeout_s
        buckets = self.buckets  # one read: stable across a concurrent swap
        if self.config.oversize == "reject" and cloud.shape[0] > buckets[-1]:
            raise ValueError(
                f"cloud has {cloud.shape[0]} points but the largest bucket "
                f"is {buckets[-1]} (buckets={buckets}); pass "
                'oversize="subsample" to serve it at the largest bucket, '
                "or add a bucket >= the cloud size"
            )
        bucket = bucket_for(cloud.shape[0], buckets)
        slo_name = slo.name if slo is not None else None
        # every request gets its trace id HERE (head sampling decides once;
        # None = untraced and no span event is ever emitted for it)
        trace_id = self.tracer.new_trace() if self.tracer is not None else None
        if trace_id is not None:
            self.tracer.emit(
                "request.submit",
                trace_id=trace_id,
                slo=slo_name or "default",
                args={"n": int(cloud.shape[0]), "bucket": bucket},
            )
        # cache probe material (bucket fit + content hash) is deliberately
        # NOT computed here: admission must stay O(1) per request on the
        # client thread, so the scheduler computes it at assembly, where it
        # overlaps batch execution (scheduler._dispatch)
        try:
            fut = self.queue.submit(
                cloud,
                bucket=bucket,
                policy=resolved,
                timeout_s=timeout_s,
                slo=slo,
                trace_id=trace_id,
            )
        except Shed:
            self.metrics.record_shed(slo_name)
            if trace_id is not None:
                self.tracer.emit(
                    "request.shed",
                    trace_id=trace_id,
                    slo=slo_name or "default",
                    args={"reason": "admission"},
                )
            raise
        except AdmissionError as e:
            self.metrics.record_rejected(slo_name)
            if trace_id is not None:
                self.tracer.emit(
                    "request.rejected",
                    trace_id=trace_id,
                    slo=slo_name or "default",
                    args={"reason": e.reason},
                )
            raise
        self.metrics.record_submitted(slo_name)
        self.metrics.record_arrival(cloud.shape[0], slo_name)
        return fut

    def infer(self, cloud: np.ndarray, **kwargs) -> np.ndarray:
        """Blocking convenience wrapper around submit()."""
        return self.submit(cloud, **kwargs).result()

    def cache_stats(self):
        """PreprocessCacheStats of the runtime's cache, None when disabled.

        Complements `metrics.snapshot()` (which carries hit/miss counters
        and the saved-latency estimate) with residency: entries, resident
        bytes, evictions, oversize refusals.
        """
        return self.cache.stats() if self.cache is not None else None

    def __repr__(self):
        return (
            f"ServingRuntime({self.model_cfg.name}, buckets={self.buckets}, "
            f"replicas={len(self.pool.replicas)}, max_batch={self.config.max_batch}, "
            f"devices={['+'.join(str(d) for d in r.devices) for r in self.pool.replicas]})"
        )


def make_serving_runtime(
    model_cfg,
    params=None,
    config: RuntimeConfig | None = None,
    *,
    policy: ExecutionPolicy | None = None,
    seed: int = 0,
    device=None,
    devices=None,
) -> ServingRuntime:
    """One-call constructor: params default to a fresh init from `seed` (demo/bench)."""
    if params is None:
        first = pool_devices(device, devices)[0]
        params = get_accelerator(model_cfg, policy, device=first).init(
            torch.Generator().manual_seed(seed)
        )
    return ServingRuntime(model_cfg, params, config, policy=policy, device=device,
                          devices=devices)
