"""PC2IMAccelerator — one (config, policy, device) triple -> the whole PC2IM pipeline.

The paper's accelerator is ONE device: the CIM preprocessing dataflow
(MSP -> L1 FPS -> lattice query) and the SC-CIM feature engine (quantized
per-point MLPs) are co-scheduled halves of the same chip.  A
`PC2IMAccelerator` owns the per-SA-stage `PreprocessEngine`s and the
policy-driven feature path, and exposes `infer` / `forward` and the two
halves on their own:

    accel = get_accelerator(get_config("pointnet2-cls"),
                            ExecutionPolicy(quant="sc_w16a16"))   # on "cuda"
    params = accel.init(torch.Generator().manual_seed(0))
    logits = accel.infer(params, points)        # (B, N, 3+F) -> (B, C)

The same holds for `get_config("pointnet2-seg")`, whose logits are per
point: (B, N, 3+F) -> (B, N, C).

A policy with `sharding` set runs over a replica's device group through
`mesh_artifacts(devices)`: `MeshArtifacts.infer` splits the batch over the
group ("batch") or also splits every weight's columns ("tensor"), bitwise
equal to the single-device `infer`.

The serving layer adds three entry points over the same two halves:
`feature_from_cached` (the preprocess cache's hit path), `infer_with_preprocess`
(logits and the preprocessing in one call, the cache's all-miss path) and
`infer_pipelined` (a stream of batches through `PipelinedExecutor`, which
overlaps batch k+1's preprocessing with batch k's feature stage on two CUDA
streams).  Each returns logits bitwise equal to `infer`: all of them run
`feature_stage(preprocess_stage(...))`, which is what `forward` is.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`, which runs the plain versions of the kernels).  Without a
card the default device raises: nothing drifts to the CPU.  The cache keys
one accelerator per (config, policy, device) so every caller of a triple
shares its engines and its compiled artifacts.

The artifacts are captured CUDA graphs (`core/graphs.py`), the counterpart
of the JAX package's jit of `forward`, `preprocess_stage`, `feature_stage`
and the fused `infer_with_pre`.  On the card, `infer`,
`infer_with_preprocess`, `preprocess_stage`, `feature_stage` and
`feature_from_cached` replay the graph of their stage for the params and
input shapes, capturing it at the first call of a shape as `jax.jit`
traces; `warmup` captures them ahead of traffic.  `loss` replays a "loss"
graph the same way.  `forward` and `loss_fn` stay eager with autograd on
(training differentiates them; `launch/train.py` captures its whole step
in a graph of its own), and on the CPU everything runs eagerly.  Inside
`graphs.eager()` the entry points run eagerly on the card too: that is the
reference side of every graph-against-eager check.
"""

from __future__ import annotations

import copy
import dataclasses
import operator
import threading

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.core.device import CAPTURE_LOCK, on_streams, resolve_device, synchronize
from repro_torch.core.engine import result_leaves, result_map, result_to
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.launch.mesh import gather_rows, make_replica_mesh, ready_event, take
from repro_torch.models import pointnet2 as PN
from repro_torch.parallel.pipeline import two_stage_schedule
from repro_torch.sharding import hints
from repro_torch.sharding.policy import replica_specs


class PC2IMAccelerator:
    """The PC2IM pipeline for one (PointNet2Config, ExecutionPolicy, device).

    Attributes:
        config  : the model/architecture description (WHAT to run).
        policy  : the execution description (HOW to run), resolved.
        device  : where inputs are placed and every kernel runs.
        engines : per-SA-stage PreprocessEngines, stage i consuming stage
                  i-1's centroid count.
        artifacts : the captured CUDA graphs of the entry points
                  (`graphs.ArtifactCache`), None on the CPU.
    """

    def __init__(self, config: PN.PointNet2Config, policy: ExecutionPolicy | None = None,
                 device=None):
        PN.check_ported(config)
        self.config = config
        self.policy = resolve_policy(config, policy)
        self.device = resolve_device(device)
        engines = []
        n = config.n_points
        for sa in config.sa:
            engines.append(PN.stage_engine(config, sa, n, self.policy))
            n = sa.n_centroids
        self.engines = tuple(engines)
        # PipelinedExecutor cache of infer_pipelined, keyed by (devices, depth)
        self._executors: dict = {}
        self._executors_lock = threading.Lock()
        # MeshArtifacts of mesh_artifacts, keyed by the group's device tuple
        self._mesh_artifacts: dict = {}
        self._mesh_lock = threading.Lock()
        # the captured CUDA graphs of the entry points (None on the CPU)
        self.artifacts = graphs.ArtifactCache(self.device) if self.device.type == "cuda" else None

    def init(self, generator: torch.Generator | None = None) -> PN.PointNet2Params:
        """Fresh parameters on this accelerator's device (drawn on the CPU from `generator`)."""
        return PN.init_params(self.config, generator, device=self.device)

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=torch.float32, device=self.device)

    def _graphed(self) -> bool:
        """Whether the entry points replay graphs here: on the card, outside `graphs.eager()`."""
        return self.artifacts is not None and not graphs.is_eager()

    @staticmethod
    def _graph_points(points):
        """The points as a static buffer takes them: float32, a tensor or a host array."""
        if isinstance(points, torch.Tensor):
            return points if points.dtype == torch.float32 else points.to(torch.float32)
        return np.asarray(points, dtype=np.float32)

    # -- the captured stages, each a function of its static inputs ------------

    # Each closes its segments with graphs.mark: in a traced capture, the
    # card's clock for CIM preprocessing and for feature computing.

    def _forward_fn(self, params):
        def forward(pts):
            pre = PN.preprocess_stage(self.config, pts, policy=self.policy)
            graphs.mark("preprocess")
            logits = PN.feature_stage(params, self.config, pts, pre, policy=self.policy)
            graphs.mark("feature")
            return logits, pre
        return forward

    def _preprocess_fn(self):
        def preprocess(pts):
            pre = PN.preprocess_stage(self.config, pts, policy=self.policy)
            graphs.mark("preprocess")
            return pre
        return preprocess

    def _feature_fn(self, params, like):
        """The feature stage over `like`'s tree structure, its leaves passed flat."""
        def feature(pts, *leaves):
            it = iter(leaves)
            pre = result_map(lambda _: next(it), like)
            logits = PN.feature_stage(params, self.config, pts, pre, policy=self.policy)
            graphs.mark("feature")
            return logits
        return feature

    def _replay_feature(self, params, points, preproc) -> torch.Tensor:
        return self.artifacts.run(params, "feature", self._feature_fn(params, preproc),
                                [self._graph_points(points), *result_leaves(preproc)])

    # -- entry points ----------------------------------------------------------

    def forward(self, params: PN.PointNet2Params, points) -> torch.Tensor:
        """Batched forward, autograd on, always eager: (B, N, 3+F) -> logits.

        Logits are (B, n_classes) for a cls config and (B, N, n_classes),
        one row a point, for a seg config.
        """
        return PN.forward(params, self.config, self._points(points), policy=self.policy)

    def infer(self, params: PN.PointNet2Params, points) -> torch.Tensor:
        """Inference entry point: `forward` under torch.inference_mode().

        (B, N, 3+F) -> (B, n_classes) for cls, (B, N, n_classes) for seg.
        On the card it replays the "forward" graph.
        """
        if self._graphed():
            return self.artifacts.run(params, "forward", self._forward_fn(params),
                                    [self._graph_points(points)], pick=operator.itemgetter(0))
        with torch.inference_mode():
            return self.forward(params, points)

    def _labels(self, labels) -> torch.Tensor:
        return torch.as_tensor(labels, device=self.device).to(torch.int64)

    def loss_fn(self, params: PN.PointNet2Params, points, labels) -> tuple:
        """Eager loss with autograd on, for `torch.autograd.grad` and training loops.

        (nll, {"loss", "accuracy"}) of `models.pointnet2.loss_fn` under this
        accelerator's policy; labels (B,) for cls, (B, N) for seg.
        """
        return PN.loss_fn(params, self.config, self._points(points), self._labels(labels),
                          policy=self.policy)

    def _loss_graph_fn(self, params):
        def loss(pts, labels):
            nll, metrics = PN.loss_fn(params, self.config, pts, labels, policy=self.policy)
            return nll, metrics["accuracy"]
        return loss

    def loss(self, params: PN.PointNet2Params, points, labels) -> tuple:
        """(loss, metrics) under torch.inference_mode(): the reference's jitted `loss`.

        On the card it replays the "loss" graph, whose static inputs are the
        points and the int64 labels.
        """
        if self._graphed():
            lab = (labels.to(torch.int64) if isinstance(labels, torch.Tensor)
                   else np.asarray(labels, dtype=np.int64))
            nll, acc = self.artifacts.run(params, "loss", self._loss_graph_fn(params),
                                          [self._graph_points(points), lab])
            return nll, {"loss": nll, "accuracy": acc}
        with torch.inference_mode():
            return self.loss_fn(params, points, labels)

    def preprocess_stage(self, points) -> tuple:
        """Params-free preprocessing half, one PreprocessResult per SA stage.

        Chains MSP partition + FPS + lattice query stage after stage; reads
        only coordinates.  On the card it replays the "preprocess" graph of
        the current stream.
        """
        if self._graphed():
            return self.artifacts.run(None, "preprocess", self._preprocess_fn(),
                                    [self._graph_points(points)])
        with torch.inference_mode():
            return PN.preprocess_stage(self.config, self._points(points), policy=self.policy)

    def feature_stage(self, params: PN.PointNet2Params, points, preproc: tuple) -> torch.Tensor:
        """Feature half: SC-CIM (or float) per-point MLPs + aggregation, and for
        seg the feature-propagation stages (3-NN interpolation + MLPs).

        `feature_stage(params, pts, preprocess_stage(pts))` equals
        `infer(params, pts)`: `forward` is exactly that composition.  On the
        card it replays the "feature" graph.
        """
        if self._graphed():
            return self._replay_feature(params, points, preproc)
        with torch.inference_mode():
            return PN.feature_stage(
                params, self.config, self._points(points), preproc, policy=self.policy
            )

    def feature_from_cached(self, params: PN.PointNet2Params, points, preproc) -> torch.Tensor:
        """Feature stage over cache-restacked neighbourhoods: the cache's hit path.

        `preproc` is a result tree reassembled from per-row cache entries
        (`core.engine.result_stack`), numpy or tensors; its leaves are
        placed on this accelerator's device and the feature stage runs as
        in `feature_stage`.  A batch whose rows are the cached canonical
        clouds therefore gets logits bitwise equal to an uncached `infer`
        of those clouds, with the whole preprocessing half skipped.  On the
        card it replays the "feature" graph, a host leaf copied straight
        into the graph's input buffer.
        """
        if self._graphed():
            return self._replay_feature(params, points, preproc)
        return self.feature_stage(params, points, result_to(preproc, self.device))

    def infer_with_preprocess(self, params: PN.PointNet2Params, points) -> tuple:
        """(logits, preprocessing) of one batch in one call: the cache's all-miss path.

        The logits are `infer`'s (the same composition); the per-stage
        PreprocessResults come out beside them for the cache fill.  On the
        card it replays the "forward" graph, as `infer` does.
        """
        if self._graphed():
            return self.artifacts.run(params, "forward", self._forward_fn(params),
                                    [self._graph_points(points)])
        with torch.inference_mode():
            return self._forward_fn(params)(self._points(points))

    def warmup(self, params: PN.PointNet2Params, points) -> tuple:
        """One eager forward of `points`, then the graph of every stage at its shapes.

        Returns the forward's (logits, preprocessing); its launches are the
        only ones counted, since a capture runs nothing.  Stages already
        captured are kept.  The "preprocess" graph is keyed by the current
        stream: warm on the stream that traffic preprocesses on.  On the CPU,
        or inside `graphs.eager()`, this is `infer_with_preprocess`.
        """
        if not self._graphed():
            return self.infer_with_preprocess(params, points)
        with CAPTURE_LOCK:  # the forward and the captures as one warm-up
            with graphs.eager():
                logits, pre = self.infer_with_preprocess(params, points)
            pts = self._graph_points(points)
            how = {"forward": (params, self._forward_fn(params), [pts]),
                   "preprocess": (None, self._preprocess_fn(), [pts]),
                   "feature": (params, self._feature_fn(params, pre),
                               [pts, *result_leaves(pre)])}
            for stage in graphs.STAGES:
                owner, fn, args = how[stage]
                self.artifacts.ensure(owner, stage, fn, args)
        return logits, pre

    def infer_pipelined(self, params: PN.PointNet2Params, batches, *, devices=None,
                        depth: int = 2) -> list:
        """Run a stream of micro-batches through the two-stage pipeline.

        Convenience wrapper over `PipelinedExecutor`: batch k+1's
        preprocessing overlaps batch k's feature stage.  Returns one logits
        tensor per input batch, in order, each bitwise equal to
        `infer(params, batch)`.  The executor is cached per (devices,
        depth), so repeated calls reuse its streams and placed parameters.
        """
        key = (tuple(resolve_device(d) for d in devices) if devices is not None else None,
               depth)
        with self._executors_lock:
            ex = self._executors.get(key)
            if ex is None:
                ex = self._executors[key] = PipelinedExecutor(self, devices=devices, depth=depth)
        return ex.run(params, batches)

    def mesh_artifacts(self, devices) -> "MeshArtifacts":
        """Sharded infer/forward over one replica's device group.

        Requires a policy with `sharding` set (the mode picks the shard
        body; see MeshArtifacts).  Built at the first call and cached per
        device tuple, so a pool of replicas sharing one accelerator builds
        each group's artifact once, and a replica rejoined on the same
        group builds nothing.
        """
        if self.policy.sharding is None:
            raise ValueError(
                "mesh_artifacts needs a policy with sharding set; "
                "use infer/forward for unsharded execution"
            )
        key = tuple(resolve_device(d) for d in devices)
        with self._mesh_lock:
            arts = self._mesh_artifacts.get(key)
            if arts is None:
                arts = self._mesh_artifacts[key] = MeshArtifacts(self, key)
        return arts

    def __repr__(self) -> str:
        return (
            f"PC2IMAccelerator({self.config.name}, quant={self.policy.quant!r}, "
            f"backend={self.policy.backend!r}, device={str(self.device)!r}, "
            f"stages={len(self.engines)})"
        )


def params_device(params: PN.PointNet2Params) -> torch.device:
    """The device a parameter module lies on (that of its first parameter)."""
    return next(params.parameters()).device


def params_copy_on(params: PN.PointNet2Params, device: torch.device) -> PN.PointNet2Params:
    """A copy of `params` on `device`; the caller's module is never moved.

    `nn.Module.to` moves a module in place, where `jax.device_put` returns
    a new copy: a replica or a second pipeline device that called `.to` on
    the caller's params would move them under every other user.
    """
    with torch.no_grad():
        return copy.deepcopy(params).to(device)


def place_on_group(params: PN.PointNet2Params, devices) -> tuple:
    """One params module a device of `devices`, in order: `params` itself on
    its own device, elsewhere a copy made now (one a distinct device)."""
    copies = {params_device(params): params}
    for d in devices:
        if d not in copies:
            copies[d] = params_copy_on(params, d)
    return tuple(copies[d] for d in devices)


class PipelinedExecutor:
    """Double-buffered two-stage executor over one accelerator's halves.

    Streams micro-batches through preprocessing -> feature stage so batch
    k+1's preprocessing (FPS and lattice kernels) overlaps batch k's
    feature MLPs:

        ex = PipelinedExecutor(get_accelerator(cfg, policy))
        logits = ex.run(params, batches)     # list, one per batch, in order

    `parallel.pipeline.two_stage_schedule` runs stage A in a producer
    thread and stage B in the caller's.  On one card each stage has its own
    CUDA stream: stage A replays the accelerator's preprocess graph on the
    preprocess stream and records an event; stage B makes the feature
    stream wait on that event, marks the hand-off tensors as used there
    (`record_stream`, so the caching allocator does not hand their memory
    out while the feature stream still reads them) and replays the feature
    graph.  Stage A runs a batch ahead, and its next replay overwrites the
    preprocess graph's static outputs while stage B may still read the
    previous batch's: the hand-off is therefore the replay's CLONES, made
    on the preprocess stream before the event (`core/graphs.py`), not a
    ring of graphs.  Neither thread synchronises the device.  With two or
    more devices, stage A runs on `devices[0]` and stage B on `devices[1]`
    (each through the accelerator of its device), with a copy of the
    parameters resident there; the hand-off copies the batch and its
    preprocessing across.  On the CPU both stages run plainly.

    Results are bitwise equal to sequential `infer` calls: both run the
    same composition.  The returned logits are ordered after the feature
    stream on the caller's current stream.
    """

    def __init__(self, accel: PC2IMAccelerator, *, devices=None, depth: int = 2):
        self.accel = accel
        self.devices = (tuple(resolve_device(d) for d in devices) if devices is not None
                        else (accel.device,))
        if not self.devices:
            raise ValueError("devices must name at least one device")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"devices must all be CUDA devices or all the CPU, got {self.devices}")
        self.depth = depth
        # last (params, copy on the feature device) pair, reused across run()
        # calls so a serving loop does not copy the weights every stream
        self._placed: tuple = (None, None)
        self._streams: tuple | None = None  # (preprocess, feature), made at the first run
        self._lock = threading.Lock()

    def _params_on(self, params, device):
        if params_device(params) == device:
            return params
        cached_key, cached_placed = self._placed
        if cached_key is params:
            return cached_placed
        # return the LOCAL: a concurrent run() with other params may
        # overwrite the cache, and this stream must keep ITS weights
        placed = params_copy_on(params, device)
        self._placed = (params, placed)
        return placed

    def _stage_streams(self, dev_pre, dev_feat) -> tuple:
        if dev_pre.type != "cuda":
            return None, None
        with self._lock:
            if self._streams is None:
                self._streams = (torch.cuda.Stream(dev_pre), torch.cuda.Stream(dev_feat))
            return self._streams

    def run(self, params: PN.PointNet2Params, batches) -> list:
        """Execute every (B, N, 3+F) batch; returns per-batch logits in order."""
        cfg, pol = self.accel.config, self.accel.policy
        dev_pre = self.devices[0]
        dev_feat = self.devices[1] if len(self.devices) >= 2 else dev_pre
        params_feat = self._params_on(params, dev_feat)
        s_pre, s_feat = self._stage_streams(dev_pre, dev_feat)
        if s_pre is not None:
            # inputs already on the card were written on the caller's stream
            s_pre.wait_stream(torch.cuda.current_stream(dev_pre))
        cross = dev_feat != dev_pre
        # each stage through the accelerator of its own device, so that its
        # work lands on its own stream, the one its event records
        accel_pre, accel_feat = (self.accel if d == self.accel.device
                                 else get_accelerator(cfg, pol, d) for d in (dev_pre, dev_feat))

        def stage_a(batch):
            with torch.inference_mode(), on_streams(s_pre):
                pts = torch.as_tensor(batch, dtype=torch.float32, device=dev_pre)
                pre = accel_pre.preprocess_stage(pts)
                done = None
                if s_pre is not None:
                    done = torch.cuda.Event()
                    done.record(s_pre)
            return pts, pre, done

        def stage_b(handoff):
            pts, pre, done = handoff
            # across devices, a copy runs on the source device's current
            # stream (the preprocess stream, after the preprocessing) and the
            # destination's current stream (the feature stream) waits for it
            with torch.inference_mode(), on_streams(*((s_pre, s_feat) if cross else (s_feat,))):
                if cross:
                    pts, pre = pts.to(dev_feat), result_to(pre, dev_feat)
                elif done is not None:
                    s_feat.wait_event(done)
                    for t in (pts, *result_leaves(pre)):
                        t.record_stream(s_feat)
                return accel_feat.feature_stage(params_feat, pts, pre)

        out = two_stage_schedule(stage_a, stage_b, batches, depth=self.depth)
        if s_feat is not None:
            caller = torch.cuda.current_stream(dev_feat)
            caller.wait_stream(s_feat)
            for logits in out:
                logits.record_stream(caller)
        return out


class MeshArtifacts:
    """Sharded whole-pipeline artifact of one accelerator over one device group.

    The serving counterpart of the paper's split-concatenate engine spanning
    subarrays: one replica owns a 1-D mesh (`launch.mesh.make_replica_mesh`)
    and the preprocess + feature composition runs once a shard, one worker
    thread a shard (`ReplicaMesh.run`), with the layout of
    `sharding.policy.replica_specs`:

      * "batch": every stage runs on the shard's rows; the only term across
        shards is the exact max that makes the SC activation scale global
        (`core.quant`), so each row's math is untouched;
      * "tensor": preprocessing runs on the shard's rows, then the points
        and every leaf of the preprocessing are gathered, the feature stage
        runs on the whole batch on every shard with every weight's columns
        split over the group (`nn.Linear`'s tensor path), and each shard
        keeps its own rows of the logits.

    Both modes are bitwise equal to the accelerator's single-device `infer`
    on the same batch on the CPU (tests/test_torch_shard_parity.py).  The
    shards run eagerly: a shard's CUDA graph could not span a collective
    that another thread's work feeds.  Calls are reentrant: two replicas
    whose groups name the same devices share one MeshArtifacts and call it
    at once, each call with a barrier and slots of its own.
    """

    def __init__(self, accel: PC2IMAccelerator, devices):
        self.mesh = make_replica_mesh(devices)
        self.config, self.policy = accel.config, accel.policy
        self.mode = self.policy.sharding
        self.specs = replica_specs(self.mode)

    def infer(self, params, points) -> torch.Tensor:
        """Sharded batched forward: (B, N, 3+F) -> logits, B % group size == 0.

        `params` is one module a shard, on its shard's device (a serving
        replica's `mesh_params`), or one module, which is placed on the
        group anew at every call (`place_on_group`), so weights updated in
        place since the last call reach every shard.  `points` is a host
        array or a tensor.  The logits lie on the group's first device,
        ordered on the caller's current stream there.
        """
        b = points.shape[0]
        g = self.mesh.size
        if b % g != 0:
            raise ValueError(
                f"batch dim {b} must divide over the replica mesh of {g} device(s)"
            )
        devices, cfg, pol = self.mesh.devices, self.config, self.policy
        if isinstance(params, PN.PointNet2Params):
            shard_params = place_on_group(params, devices)
            # the copies ran on this thread's streams, which the shards' do not
            # wait on by themselves
            placed = [None if p is params else ready_event(next(p.parameters()))
                      for p in shard_params]
        else:
            shard_params, placed = tuple(params), [None] * g
            if len(shard_params) != g:
                raise ValueError(f"{len(shard_params)} params modules for a group of "
                                 f"{g} device(s)")
        rows = b // g
        if isinstance(points, torch.Tensor):
            points = points.to(torch.float32)
            ready = ready_event(points)
        else:
            points, ready = np.asarray(points, dtype=np.float32), None

        def split(x, spec, index: int):
            """Shard `index`'s part of `x` under `spec` (its rows, or all of x)."""
            return x if spec is None else x[index * rows:(index + 1) * rows]

        def body(index: int) -> torch.Tensor:
            dev = devices[index]
            params = shard_params[index]
            if placed[index] is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(placed[index])
                for t in params.state_dict().values():
                    t.record_stream(stream)
            local = split(points, self.specs.points, index)
            pts = (take(local, ready, dev) if isinstance(local, torch.Tensor)
                   else torch.as_tensor(local, device=dev))
            pre = PN.preprocess_stage(cfg, pts, policy=pol)
            if self.mode == "batch":
                logits = PN.feature_stage(params, cfg, pts, pre, policy=pol)
            else:
                pts_all = hints.all_gather(pts, dim=0)
                pre_all = result_map(lambda t: hints.all_gather(t, dim=0), pre)
                logits = split(PN.feature_stage(params, cfg, pts_all, pre_all, policy=pol),
                               self.specs.logits, index)
            return logits.to(devices[0])

        return gather_rows(self.mesh.run(body), devices[0])

    def forward(self, params, points) -> torch.Tensor:
        """Alias of `infer`, the training-style name, as in the reference."""
        return self.infer(params, points)


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Snapshot of the accelerator cache (see `cache_stats`).

    hits/misses count `get_accelerator` calls; size is the number of live
    accelerators; keys names each as (config.name, quant, backend, pipeline,
    sharding, device).
    """

    hits: int
    misses: int
    size: int
    keys: tuple[tuple[str, str, str | None, str, str | None, str], ...]


# A dict under a lock rather than lru_cache: concurrent misses on one key
# must construct one accelerator, not two.
_lock = threading.Lock()
_artifacts: dict[tuple, PC2IMAccelerator] = {}
_hits = 0
_misses = 0


def get_accelerator(config: PN.PointNet2Config, policy: ExecutionPolicy | None = None,
                    device=None) -> PC2IMAccelerator:
    """Accelerator cache: one pipeline per (config, policy, device).

    The policy is resolved against the config and the device resolved
    ("cuda" by default) before keying the cache, so equivalent requests share
    one accelerator.  Thread-safe.
    """
    global _hits, _misses
    key = (config, resolve_policy(config, policy), resolve_device(device))
    with _lock:
        accel = _artifacts.get(key)
        if accel is None:
            _misses += 1
            accel = _artifacts[key] = PC2IMAccelerator(*key)
        else:
            _hits += 1
        return accel


def cache_stats() -> CacheStats:
    """Introspect the accelerator cache (hit/miss counters + live keys)."""
    with _lock:
        keys = tuple(
            (cfg.name, pol.quant, pol.backend, pol.pipeline, pol.sharding, str(dev))
            for cfg, pol, dev in _artifacts
        )
        return CacheStats(hits=_hits, misses=_misses, size=len(_artifacts), keys=keys)


def clear_cache() -> None:
    """Drop every cached accelerator and reset the hit/miss counters."""
    global _hits, _misses
    with _lock:
        _artifacts.clear()
        _hits = 0
        _misses = 0
