"""Replica pool — one accelerator replica per device group, least-loaded dispatch.

Each `Replica` holds its own copy of the model parameters on one carved
group of devices (CUDA cards, or the CPU when asked for; usually a group of
one, `devices_per_replica`) and executes micro-batches on its own single
worker thread, so R replicas give R-way overlap while every batch still
runs on exactly one group.  Batches under a sharded `ExecutionPolicy` run
the accelerator's `MeshArtifacts` over the group (`_execute_sharded`);
everything else runs on the group's first device.  Health is delegated to
`runtime/fault_tolerance.py`:

  * HeartbeatMonitor — a pump thread feeds a no-op beat through each of the
    replica's executor queues every timeout/4 (worker AND feature thread,
    so pipelined batches are covered too); a wedged thread (hung kernel,
    dead device) stops beating and its monitor evicts the replica.  The
    timeout must therefore exceed the worst-case batch latency.
  * StragglerMonitor — per-batch wall time; slow-but-alive replicas are
    recorded (metrics.straggler_events) for the operator, not evicted.

Eviction re-dispatches the replica's outstanding batches to the surviving
replicas, bounded by `max_retries` per batch; a batch that fails everywhere
fails its future with the last error.  Dispatch is least-loaded (smallest
in-flight count among alive replicas).

On the card each replica owns three CUDA streams: one for sequential
batches, and a preprocess/feature pair for pipelined ones.  The kernel
wrappers launch on `torch.cuda.current_stream`, which is per thread, so
every task enters its stream (`torch.cuda.stream`) on the thread that runs
it.  Streams do not order against one another, or against the default
stream, by themselves: a pipelined hand-off carries a `torch.cuda.Event`
that the feature stream waits on, and the hand-off tensors are marked as
used there (`Tensor.record_stream`) so the caching allocator does not hand
their memory out while the feature stream still reads it.  Host reads of
device results (`.cpu()`, `core.engine.result_to_host`) synchronise what
they read.

On the card every batch replays captured CUDA graphs (`core/graphs.py`)
keyed by the replica's own params copy (the preprocess graph by the stream
it runs on), and a warmup batch captures every graph a batch of its
(bucket, policy) can replay on that replica, so nothing is captured
mid-traffic.

Eviction is two-way: `rejoin()` rebuilds an evicted replica in place — a
fresh params copy on its device, fresh streams, stage executors and
heartbeat pumps, every registered warmup batch replayed (which captures the
new replica's graphs), and (when the
runtime runs a preprocess cache) the hottest cache entries pre-staged on
the device so the new replica's first all-hit batches skip the host
restack.  `add_replica()`/`retire()` grow and shrink the pool the same way.
The `chaos` hook observes every real batch at execution start (a fault
injector assigned by the caller; None by default).  A rejoined or added
replica lands on its slot's device group, so a sharded policy finds the
group's `MeshArtifacts` already built.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.core.accelerator import get_accelerator, params_copy_on, place_on_group
from repro_torch.core.device import on_streams, resolve_device, synchronize
from repro_torch.core.engine import (
    result_leaves,
    result_row,
    result_set_row,
    result_stack,
    result_to,
    result_to_host,
)
from repro_torch.launch.mesh import carve_device_groups
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, StragglerMonitor
from repro_torch.serve.metrics import BatchRecord, ServeMetrics
from repro_torch.serve.queue import try_set_exception, try_set_result


class NoReplicaAvailable(RuntimeError):
    """Every replica is dead (or was already tried for this batch)."""


def pool_devices(device=None, devices=None) -> list[torch.device]:
    """The devices a pool serves on: `devices`, else `device`, else every card.

    `devices` is the reference's argument (a list the pool carves into
    groups; it may name one device more than once, which puts several
    shards of a group on it), `device` the port's for one device.  With
    neither the pool takes every CUDA device, and raises where there is
    none (pass device="cpu" to serve on the CPU).
    """
    if device is not None and devices is not None:
        raise ValueError("pass device or devices, not both")
    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("devices must name at least one device")
        return out
    if device is not None:
        return [resolve_device(device)]
    resolve_device(None)  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _to_host(logits: torch.Tensor) -> np.ndarray:
    """Logits as numpy; on the card `.cpu()` waits for the current stream."""
    return logits.cpu().numpy()


class _Entry:
    """One in-flight batch on one replica (retry bookkeeping)."""

    def __init__(self, mb, future: Future, attempts: int, tried: frozenset):
        self.mb = mb
        self.future = future
        self.attempts = attempts
        self.tried = tried
        self.seq = -1  # assigned under the pool lock at registration


class Replica:
    """One device-group-pinned executor: params copies, CUDA streams, worker threads.

    The unit of capacity is a device GROUP (usually of one device).
    Sharded-policy batches run the accelerator's `MeshArtifacts` over the
    group against `mesh_params` (one params copy a shard, on its device;
    shards on one device share it), while unsharded batches run on the
    group's first device (`device`) with `params`, its copy there, and
    replay that device's graphs: one replica serves both kinds of traffic.

    Batches under a `pipeline="pipelined"` policy additionally use a second
    single-thread executor: the worker thread enqueues the preprocessing on
    the replica's preprocess stream and hands the batch to the feature
    thread, which runs the feature stage on the feature stream — so while
    batch k's feature MLPs run, the worker is already preprocessing batch
    k+1.  Both executors are constructed eagerly (threads spawn on first
    use), so shutdown/eviction can never race a lazy creation; when
    liveness is enabled, each executor gets its own heartbeat pump, so a
    wedge in EITHER stage evicts the replica.

    `params` is a copy of the caller's: `nn.Module.to` moves a module in
    place, so pinning the caller's own module would move it under every
    other replica and user.
    """

    def __init__(self, rid: int, device, params, *, on_straggler=None):
        self.id = rid
        # one device OR a device group, normalized to a tuple whose first
        # device runs every unsharded batch
        group = tuple(device) if isinstance(device, (tuple, list)) else (device,)
        self.devices = tuple(resolve_device(d) for d in group)
        self.device = self.devices[0]
        self.params = params_copy_on(params, self.device)
        self.mesh_params = place_on_group(self.params, self.devices)
        cuda = self.device.type == "cuda"
        # sequential batches; the preprocess/feature pair for pipelined ones
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.pre_stream = torch.cuda.Stream(self.device) if cuda else None
        self.feat_stream = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            # the copies ran on this thread's current streams, which the
            # replica's streams (and its shards') do not wait on
            for d in set(self.devices):
                synchronize(d)
        self.alive = True
        self.retired = False  # scale-down (don't auto-rejoin) vs fault eviction
        self.evicted_t: float | None = None  # when evict() ran (rejoin delay base)
        self.n_batches = 0
        # pre-staged preprocess-cache entries: key -> (id(entry), device
        # tree).  Filled at rejoin/scale-up warmup with the cache's hottest
        # entries so the first all-hit batches skip the host restack; the
        # entry id guards against an entry replaced under the same key.
        self.staged: dict[tuple, tuple[int, object]] = {}
        # (bucket, policy) -> (host, device) preprocessing of one zero filler
        # cloud: the filler rows of an all-hit batch (ReplicaPool._filler)
        self.fillers: dict[tuple, tuple] = {}
        self.inflight: dict[int, _Entry] = {}
        self.straggler = StragglerMonitor(on_straggler=on_straggler)
        self.heartbeat: HeartbeatMonitor | None = None
        self.feature_heartbeat: HeartbeatMonitor | None = None
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"pc2im-replica-{rid}"
        )
        self._feature_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"pc2im-replica-{rid}-feat"
        )
        # double-buffer bound on preprocessed-but-unconsumed batches: without
        # it a burst would let the worker race arbitrarily far ahead,
        # holding every batch's device-resident intermediates at once
        self._handoff_slots = threading.BoundedSemaphore(2)

    def acquire_handoff(self):
        """Block until a staged-batch slot frees (double buffering).

        At most two batches may sit preprocessed but not yet consumed by the
        feature thread.  Raises RuntimeError if the replica dies while
        waiting, so a blocked worker task converts to a retry instead of
        hanging.
        """
        while not self._handoff_slots.acquire(timeout=0.1):
            if not self.alive:
                raise RuntimeError(f"replica {self.id} shut down during hand-off wait")

    def release_handoff(self):
        """Free a staged-batch slot (feature stage consumed its input)."""
        self._handoff_slots.release()

    def submit(self, fn, *args) -> Future:
        """Run fn on the replica's worker thread (admission order preserved)."""
        return self._executor.submit(fn, *args)

    def submit_feature(self, fn, *args) -> Future:
        """Run fn on the feature-stage thread (pipelined batches only).

        Single-threaded, so feature stages of consecutive batches stay
        ordered per replica.
        """
        return self._feature_executor.submit(fn, *args)

    def stage_entry(self, entry) -> None:
        """Pre-stage one preprocess-cache entry as a device tree.

        The per-row payload is copied to this replica's device up front
        (on its sequential stream, which is then synchronised, so any of
        its streams may read it), and an all-hit batch made of staged
        entries stacks them device-side (`ReplicaPool._staged_stack`).
        """
        with on_streams(self.stream):
            tree = result_to(entry.pre, self.device)
        if self.stream is not None:
            self.stream.synchronize()
        self.staged[entry.key] = (id(entry), tree)

    def shutdown(self):
        """Stop both stage executors without waiting.

        In-flight work is abandoned; the pool re-dispatches it elsewhere or
        fails its futures.
        """
        self.alive = False
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.feature_heartbeat is not None:
            self.feature_heartbeat.stop()
        self._executor.shutdown(wait=False)
        self._feature_executor.shutdown(wait=False)


class ReplicaPool:
    """Least-loaded dispatch over per-device-group replicas with health tracking.

    `devices` (or `device`, one device) names where the replicas run (see
    `pool_devices`: every card by default), carved into groups of
    `devices_per_replica` (`launch.mesh.carve_device_groups`; leftover
    devices that do not fill a group are unused).  More replicas than
    groups round-robin over them, which on one card gives several workers
    with their own streams.
    """

    def __init__(
        self,
        model_cfg,
        params,
        *,
        n_replicas: int | None = None,
        device=None,
        devices=None,
        devices_per_replica: int = 1,
        heartbeat_timeout_s: float | None = None,
        max_retries: int = 2,
        metrics: ServeMetrics | None = None,
        cache=None,
        stage_top_k: int = 8,
        tracer=None,
    ):
        self._devices = pool_devices(device, devices)
        # the unit of capacity is a device GROUP: per_replica=1 is one device
        # a replica; > 1 backs each replica with a mesh over its group
        self._groups = carve_device_groups(self._devices, devices_per_replica)
        n = n_replicas if n_replicas is not None else len(self._groups)
        if n < 1:
            raise ValueError("need at least one replica")
        self.model_cfg = model_cfg
        self.max_retries = max_retries
        self.metrics = metrics or ServeMetrics()
        self.cache = cache  # PreprocessCache | None — pre-staged on rejoin
        self.stage_top_k = stage_top_k
        self.tracer = tracer  # Tracer | None — None means tracing is off
        self.chaos = None  # fault-injector hook: chaos.on_batch(pool, replica, mb)
        self._params = params  # the caller's: every replica copies it
        self._heartbeat_timeout_s = heartbeat_timeout_s
        self._warmup_mbs: list = []  # registered warmup batches, replayed on rejoin
        self._lock = threading.Lock()
        self._seq = 0
        self.replicas = [self._make_replica(i) for i in range(n)]
        # background cache fill for all-miss batches (thread spawns on first
        # submit, so uncached pools pay nothing); single-threaded, so inserts
        # land in batch-completion order and a later duplicate's
        # execution-time lookup observes them deterministically
        self._insert_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pc2im-cache-insert"
        )
        self._pumps: list[threading.Thread] = []
        for rep in self.replicas:
            self._start_liveness(rep)

    def _make_replica(self, rid: int) -> Replica:
        """Construct one fresh Replica for slot `rid` (params copied anew).

        Shared by the constructor and `rejoin`/`add_replica`: the device
        group follows the slot (round-robin over the carved groups), so a
        rejoined replica lands back on its predecessor's group, and a
        sharded policy on the group whose `MeshArtifacts` the accelerator
        already built.  Liveness pumps are NOT started here — call
        `_start_liveness` after the replica is visible in `self.replicas`.
        """
        return Replica(
            rid,
            self._groups[rid % len(self._groups)],
            self._params,
            on_straggler=lambda ev, rid=rid: self._on_straggler(rid, ev),
        )

    def _on_straggler(self, rid: int, ev) -> None:
        """Per-replica straggler beat: metrics attribution + trace event."""
        self.metrics.record_straggler(ev, replica_id=rid)
        if self.tracer is not None:
            self.tracer.emit(
                "replica.straggler",
                replica_id=rid,
                args={
                    "duration_s": ev.duration_s,
                    "median_s": ev.median_s,
                    "ratio": ev.ratio,
                },
            )

    def _emit(self, name: str, mb, rep_id: int = -1, args: dict | None = None):
        """Emit one batch-scoped trace event (no-op when untraced).

        Warmup batches carry batch_id == -1 and emit no batch event,
        matching their exclusion from metrics.  Their graph events do reach
        the stream (`_graph_trace`), with batch_id -1: warm-up is where the
        captures, and the stage marks a traced capture records, happen.
        """
        tr = self.tracer
        if tr is not None and mb.batch_id != -1:
            tr.emit(name, batch_id=mb.batch_id, replica_id=rep_id, args=args)

    def _start_liveness(self, rep: Replica) -> None:
        """Attach heartbeat monitors + pumps to one replica (when enabled)."""
        if self._heartbeat_timeout_s is None:
            return
        rep.heartbeat = HeartbeatMonitor(
            self._heartbeat_timeout_s,
            on_dead=lambda rid=rep.id: self.evict(rid, reason="heartbeat"),
        ).start()
        rep.feature_heartbeat = HeartbeatMonitor(
            self._heartbeat_timeout_s,
            on_dead=lambda rid=rep.id: self.evict(rid, reason="feature-heartbeat"),
        ).start()
        for tag, submit, monitor in (
            ("", rep.submit, rep.heartbeat),
            ("-feat", rep.submit_feature, rep.feature_heartbeat),
        ):
            pump = threading.Thread(
                target=self._pump, args=(rep, submit, monitor),
                daemon=True, name=f"pc2im-hb-pump-{rep.id}{tag}",
            )
            pump.start()
            self._pumps.append(pump)

    # -- health ---------------------------------------------------------------

    def _pump(self, rep: Replica, submit, monitor):
        """Route beats THROUGH one of the replica's executor queues.

        A wedged thread stops beating, which is exactly the liveness signal
        wanted.  Each stage executor gets its own pump + monitor: the worker
        thread never waits on device work for pipelined batches, so a hung
        feature stage is only observable through the feature executor's
        queue.
        """
        period = monitor.timeout_s / 4
        while rep.alive:
            try:
                submit(monitor.beat)
            except RuntimeError:  # executor shut down under us
                return
            time.sleep(period)

    def alive_replicas(self) -> list[Replica]:
        """Replicas currently considered healthy (dispatch candidates)."""
        with self._lock:
            return [r for r in self.replicas if r.alive]

    def evict(self, rid: int, *, reason: str):
        """Mark a replica dead and re-dispatch its outstanding batches."""
        with self._lock:
            rep = self.replicas[rid]
            if not rep.alive:
                return
            rep.alive = False
            rep.evicted_t = time.monotonic()
            orphans = list(rep.inflight.values())
            rep.inflight.clear()
        self.metrics.record_eviction()
        if self.tracer is not None:
            self.tracer.emit(
                "replica.evicted",
                replica_id=rid,
                args={"reason": reason, "orphans": len(orphans)},
            )
        rep.shutdown()
        for entry in orphans:
            if entry.future.done():
                continue
            self.metrics.record_retry()
            self._emit("batch.retry", entry.mb, rep_id=rid,
                       args={"attempts": entry.attempts + 1, "reason": reason})
            self._dispatch(
                entry.mb, entry.future, entry.attempts + 1,
                entry.tried | {rid},
                error=NoReplicaAvailable(f"replica {rid} evicted ({reason})"),
            )

    def retire(self, rid: int) -> bool:
        """Scale-down eviction: like `evict` but opts out of auto-rejoin.

        `retired=True` keeps a rejoin loop from immediately reviving the
        slot (a later scale-up still can, via `rejoin`).  Returns False if
        the replica was already dead.
        """
        with self._lock:
            rep = self.replicas[rid]
            if not rep.alive:
                return False
            rep.retired = True
        self.evict(rid, reason="scale-down")
        return True

    def _warm_and_admit(self, rep: Replica, warm: bool) -> None:
        """Warm a replica still invisible to dispatch, then make it alive."""
        try:
            if warm:
                for mb in list(self._warmup_mbs):
                    self._warmup_on(rep, mb)
                self._stage_cache(rep)
        except Exception:
            rep.shutdown()
            raise
        with self._lock:
            rep.alive = True
        self._start_liveness(rep)
        self.metrics.record_rejoin()

    def rejoin(self, rid: int, *, warm: bool = True) -> bool:
        """Re-admit an evicted replica slot with a fresh warm replica.

        A fresh `Replica` (new params copy on the slot's device, new streams
        and stage executors, new heartbeat pumps) replaces the dead one IN
        PLACE, so in-flight `tried` sets — which exclude the slot by id —
        stay meaningful for batches that failed on the predecessor.  With
        `warm=True` (the default) every registered warmup batch is replayed
        on the new replica before it is marked alive for dispatch, and the
        preprocess cache's hottest entries are pre-staged on its device
        (`Replica.stage_entry`).  Returns False when the slot is still alive
        (nothing to do).
        """
        with self._lock:
            if self.replicas[rid].alive:
                return False
            rep = self._make_replica(rid)
            # visible to dispatch only after warmup: alive=False gates _pick
            rep.alive = False
            self.replicas[rid] = rep
        self._warm_and_admit(rep, warm)
        if self.tracer is not None:
            self.tracer.emit("replica.rejoin", replica_id=rid, args={"warm": warm})
        return True

    def add_replica(self, *, warm: bool = True) -> int:
        """Grow the pool by one fresh replica slot; returns its id.

        The new replica round-robins onto the pool's devices and is warmed
        (and cache-pre-staged) exactly like a rejoin before dispatch sees
        it.
        """
        with self._lock:
            rid = len(self.replicas)
            rep = self._make_replica(rid)
            rep.alive = False  # invisible to _pick until warm
            self.replicas.append(rep)
        self._warm_and_admit(rep, warm)
        if self.tracer is not None:
            self.tracer.emit(
                "replica.rejoin", replica_id=rid, args={"warm": warm, "grew": True}
            )
        return rid

    def _stage_cache(self, rep: Replica) -> None:
        """Pre-stage the cache's hottest entries on one replica's device.

        Best-effort: a failed transfer only costs the staged fast path, so
        it must never fail a rejoin.
        """
        if self.cache is None:
            return
        try:
            for entry in self.cache.top_entries(self.stage_top_k):
                rep.stage_entry(entry)
        except Exception:  # noqa: BLE001 — staging is an optimization only
            rep.staged.clear()

    def _register(self, rep: Replica, entry: _Entry) -> None:
        with self._lock:
            self._seq += 1
            entry.seq = self._seq
            rep.inflight[entry.seq] = entry

    def _warmup_on(self, rep: Replica, mb) -> None:
        """Replay one registered warmup batch synchronously on one replica.

        Used by rejoin/add_replica while the replica is still invisible to
        dispatch (alive=False); attempts starts at the retry budget so a
        failure fails THIS future instead of re-dispatching the warmup
        batch to a healthy replica and masking the broken one.
        """
        entry = _Entry(mb, Future(), attempts=self.max_retries, tried=frozenset())
        self._register(rep, entry)
        rep.submit(self._execute, rep, entry)
        entry.future.result(timeout=300)

    def _staged_stack(self, rep: Replica, entries, total: int, filler):
        """Device-side restack of an all-hit batch from pre-staged entries.

        Returns the device tree when EVERY entry is staged on this replica
        and still current (the recorded entry id must match — an entry
        replaced under the same content address invalidates its staged
        copy); otherwise None, and the caller falls back to the host
        restack.  Mirrors `result_stack` exactly — the same filler rows,
        then a leaf-wise stack — so the result is bitwise-identical to the
        host path.  Runs on the caller's current stream.
        """
        rows = []
        for e in entries:
            rec = rep.staged.get(e.key)
            if rec is None or rec[0] != id(e):
                return None
            rows.append(rec[1])
        return result_stack(rows, total=total, filler=filler)

    def _filler(self, rep: Replica, accel, mb, pre=None) -> tuple:
        """(host, device) row tree of the filler rows of `mb`'s (bucket, policy) on `rep`.

        The preprocessing of assemble_batch's zero filler cloud, which is
        what `infer` of the padded batch computes for those rows: taken from
        a warmup batch's preprocessing `pre` (all zero clouds), else
        computed once from a zero batch, and kept on the replica.
        """
        key = (mb.bucket, mb.policy)
        got = rep.fillers.get(key)
        if got is None:
            if pre is None:
                pre = accel.preprocess_stage(np.zeros_like(mb.batch))
            row = result_row(pre, 0)
            got = rep.fillers[key] = (result_to_host(row), row)
        return got

    def _hit_payload(self, rep: Replica, accel, mb, entries):
        """The device tree of an all-hit batch: staged rows, else a host restack.

        Filler rows (a batch with fewer requests than rows) are the zero
        cloud's preprocessing, so the logits equal `infer` of the padded
        batch.
        """
        total = mb.batch.shape[0]
        host_fill, dev_fill = (self._filler(rep, accel, mb) if total > len(entries)
                               else (None, None))
        pre = self._staged_stack(rep, entries, total, dev_fill)
        if pre is None:
            pre = result_to(result_stack([e.pre for e in entries], total=total,
                                         filler=host_fill), rep.device)
        return pre

    # -- dispatch -------------------------------------------------------------

    def submit(self, mb) -> Future:
        """Run one MicroBatch somewhere healthy; future yields np logits."""
        future: Future = Future()
        self._dispatch(mb, future, attempts=0, tried=frozenset())
        return future

    def _pick(self, tried: frozenset) -> Replica | None:
        with self._lock:
            candidates = [
                r for r in self.replicas if r.alive and r.id not in tried
            ]
            if not candidates:
                return None
            return min(candidates, key=lambda r: (len(r.inflight), r.id))

    def _dispatch(self, mb, future: Future, attempts: int, tried: frozenset, error=None):
        if attempts > self.max_retries:
            try_set_exception(future, error or NoReplicaAvailable("retry budget exhausted"))
            return
        rep = self._pick(tried)
        if rep is None:
            try_set_exception(
                future, error or NoReplicaAvailable(f"no replica left (tried {sorted(tried)})")
            )
            return
        entry = _Entry(mb, future, attempts, tried)
        with self._lock:
            lost_race = not rep.alive  # evict() won between _pick and here
            if not lost_race:
                self._seq += 1
                entry.seq = self._seq
                rep.inflight[entry.seq] = entry
        if lost_race:
            self._retry(entry, rep.id, NoReplicaAvailable("replica died"))
            return
        self._emit("batch.dispatched", mb, rep_id=rep.id,
                   args={"attempts": attempts})
        try:
            rep.submit(self._execute, rep, entry)
        except RuntimeError as e:  # executor shut down between pick and submit
            with self._lock:
                was_inflight = rep.inflight.pop(entry.seq, None) is not None
            if was_inflight:  # else a concurrent evict() already re-dispatched
                self._retry(entry, rep.id, e)

    def _retry(self, entry: _Entry, rid: int, err: Exception):
        if entry.future.done():
            return
        self.metrics.record_retry()
        self._emit("batch.retry", entry.mb, rep_id=rid,
                   args={"attempts": entry.attempts + 1, "reason": repr(err)})
        self._dispatch(entry.mb, entry.future, entry.attempts + 1,
                       entry.tried | {rid}, error=err)

    def _fail(self, rep: Replica, entry: _Entry, err: Exception) -> None:
        """Retry a failed batch elsewhere — only if the entry was still ours.

        A concurrent evict() already cleared inflight AND re-dispatched it;
        retrying here too would run the batch twice.
        """
        with self._lock:
            was_inflight = rep.inflight.pop(entry.seq, None) is not None
        if was_inflight:
            self._retry(entry, rep.id, err)

    def _graph_trace(self, mb):
        """The graph layer's tracing context for one batch.

        Its replays and captures are reported on the batch's id; nothing
        when tracing is off.
        """
        if self.tracer is None:
            return contextlib.nullcontext()
        return graphs.traced(self.tracer, mb.batch_id)

    def _execute(self, rep: Replica, entry: _Entry):
        with self._graph_trace(entry.mb):
            self._execute_batch(rep, entry)

    def _execute_batch(self, rep: Replica, entry: _Entry):
        if entry.future.done():  # e.g. already re-dispatched after eviction
            with self._lock:
                rep.inflight.pop(entry.seq, None)
            return
        mb = entry.mb
        if self.chaos is not None and mb.n_real > 0:
            # deterministic fault-injection point: every REAL batch passes
            # here on its replica's worker thread before either execution
            # path (warmup batches are invisible to the injector).  A kill
            # fault evicts the replica — eviction re-dispatches this entry,
            # so the raise below must NOT retry it again (was_inflight)
            try:
                self.chaos.on_batch(self, rep, mb)
            except Exception as e:  # noqa: BLE001 — injected fault
                self._fail(rep, entry, e)
                return
        if getattr(mb.policy, "sharding", None) is not None:
            self._execute_sharded(rep, entry)
            return
        if getattr(mb.policy, "pipeline", "sequential") == "pipelined":
            self._execute_pipelined(rep, entry)
            return
        try:
            accel = get_accelerator(self.model_cfg, mb.policy, device=rep.device)
            rep.straggler.step_start()
            with on_streams(rep.stream):
                # the host batch goes straight into a graph's input buffer
                # (a warmup batch's first infer captures the forward graph)
                if mb.cache is not None:
                    logits, skipped = self._run_cached(accel, rep, mb)
                else:
                    self._emit("batch.execute_start", mb, rep_id=rep.id)
                    logits = _to_host(accel.infer(rep.params, mb.batch))
                    self._emit("batch.execute_end", mb, rep_id=rep.id)
                    skipped = False
            dt = rep.straggler.step_end(rep.n_batches)
            if rep.heartbeat is not None:
                rep.heartbeat.beat()
            self._record_success(rep, entry, logits, dt, preprocess_skipped=skipped)
        except Exception as e:  # noqa: BLE001 — any device/kernel failure
            self._fail(rep, entry, e)

    def _execute_sharded(self, rep: Replica, entry: _Entry):
        """Sharded execution of one batch over the replica's device group.

        Routes through the accelerator's `mesh_artifacts` for this group (a
        one-device group runs the unsharded math).  Straggler tracking,
        heartbeat beats, retry on failure and trace spans behave exactly
        like the sequential path (chaos already ran in `_execute`); a shard
        that fails fails the call, which retries the batch elsewhere.  The
        preprocess cache does not compose with sharded policies: the
        scheduler never attaches it to a sharded batch.  The shards run
        eagerly; a warmup batch builds the kernels and the shards' streams.
        """
        mb = entry.mb
        try:
            accel = get_accelerator(self.model_cfg, mb.policy, device=rep.device)
            arts = accel.mesh_artifacts(rep.devices)
            rep.straggler.step_start()
            self._emit("batch.execute_start", mb, rep_id=rep.id)
            with on_streams(rep.stream):
                logits = _to_host(arts.infer(rep.mesh_params, mb.batch))
            self._emit("batch.execute_end", mb, rep_id=rep.id)
            dt = rep.straggler.step_end(rep.n_batches)
            if rep.heartbeat is not None:
                rep.heartbeat.beat()
            self._record_success(rep, entry, logits, dt)
        except Exception as e:  # noqa: BLE001 — any device/kernel/shard failure
            self._fail(rep, entry, e)

    # -- preprocess-cache execution -------------------------------------------

    def _resolve_entries(self, mb) -> tuple:
        """Authoritative, counted cache lookups for one batch at execution time.

        The scheduler peeked at assembly time (to substitute canonical rows);
        by the time the batch EXECUTES, every earlier batch on this replica
        has finished inserting, so a request that peek-missed while its
        duplicate's batch was still in flight can upgrade to a hit here.
        A late hit is accepted only when the assembled batch row is
        bitwise-equal to the entry's canonical row (always true for exact
        duplicates; a sub-step-noise near-duplicate whose row was NOT
        canonicalized at assembly keeps the miss path, preserving parity).
        Returns one CacheEntry-or-None per request; exactly one counted
        lookup per addressable request.
        """
        entries = []
        hits = misses = 0
        for i, req in enumerate(mb.requests):
            ent = None
            if req.cache_key is not None:
                ent = mb.cache.lookup(req.cache_key)
                if ent is not None and not np.array_equal(mb.batch[i], ent.row):
                    ent = None
                if ent is not None:
                    hits += 1
                else:
                    misses += 1
            entries.append(ent)
        # one metrics-lock round trip per outcome, not per request — the
        # metrics lock is shared with the scheduler's hot path
        if hits:
            self.metrics.record_cache_lookup(True, hits)
        if misses:
            self.metrics.record_cache_lookup(False, misses)
        if self.tracer is not None and mb.batch_id != -1:
            for req, ent in zip(mb.requests, entries):
                if req.trace_id is not None and req.cache_key is not None:
                    self.tracer.emit(
                        "request.cache_lookup",
                        trace_id=req.trace_id,
                        batch_id=mb.batch_id,
                        slo=req.slo.name,
                        args={"hit": ent is not None},
                    )
        return tuple(entries)

    def _run_cached(self, accel, rep, mb):
        """Cache-aware execution of one batch on the current stream; returns (logits, skipped).

        All-hit: the preprocess stage is skipped outright — the per-row
        cached neighborhoods are restacked (filler rows: the zero filler
        cloud's preprocessing, `_filler`) and fed straight to
        `feature_from_cached`.
        All-miss: `infer_with_preprocess` — one forward whose second output
        feeds the background cache fill, so the 0%-duplicate workload pays
        nothing over the uncached path.
        Mixed: the batch runs `preprocess_stage` (the staged composition is
        bitwise-equal to `infer`, so miss parity is preserved), hit rows
        are spliced in on the host, and miss rows populate the cache before
        the feature stage reads the host tree.
        """
        batch = mb.batch
        if mb.n_real == 0:
            # warmup batch: one eager forward builds the kernels and warms
            # the thread's library state, then the graphs of all three
            # paths are captured on this stream (as the reference's warmup
            # traces every artifact a cached batch can touch), and the zero
            # clouds' preprocessing is kept as the filler row
            logits, pre = accel.warmup(rep.params, batch)
            self._filler(rep, accel, mb, pre)
            return _to_host(logits), False
        self._emit("batch.cache_start", mb, rep_id=rep.id)
        entries = self._resolve_entries(mb)
        n_hits = sum(1 for e in entries if e is not None)
        if n_hits == mb.n_real:
            pre = self._hit_payload(rep, accel, mb, entries)
            self._emit("batch.cache_end", mb, rep_id=rep.id,
                       args={"hits": n_hits, "skip": True})
            self._emit("batch.feature_start", mb, rep_id=rep.id)
            logits = _to_host(accel.feature_from_cached(rep.params, batch, pre))
            self._emit("batch.feature_end", mb, rep_id=rep.id)
            return logits, True
        self._emit("batch.cache_end", mb, rep_id=rep.id, args={"hits": n_hits})
        if n_hits == 0:
            self._emit("batch.execute_start", mb, rep_id=rep.id)
            logits_dev, pre = accel.infer_with_preprocess(rep.params, batch)
            logits = _to_host(logits_dev)
            self._emit("batch.execute_end", mb, rep_id=rep.id)
            self._insert_executor.submit(self._insert_misses, mb, pre, entries)
            return logits, False
        self._emit("batch.preprocess_start", mb, rep_id=rep.id)
        pre_host = result_to_host(accel.preprocess_stage(batch))
        self._emit("batch.preprocess_end", mb, rep_id=rep.id)
        self._emit("batch.splice_start", mb, rep_id=rep.id)
        pre = self._cached_splice(mb, pre_host, entries)
        self._emit("batch.splice_end", mb, rep_id=rep.id)
        self._emit("batch.feature_start", mb, rep_id=rep.id)
        logits = _to_host(accel.feature_from_cached(rep.params, batch, pre))
        self._emit("batch.feature_end", mb, rep_id=rep.id)
        return logits, False

    def _splice_or_insert(self, mb, pre, entries):
        """Route one non-all-hit pipelined cache batch's preprocess output.

        Mixed (some hits): the host splice path — hit rows must replace the
        freshly computed ones before the feature stage consumes the host
        tree (`feature_from_cached`).
        All-miss: the device tree is returned UNTOUCHED (no host round trip
        on the critical path) and miss insertion happens on the pool's
        background insert thread — cache fill is bookkeeping, not part of
        the response.
        """
        if any(e is not None for e in entries):
            return self._cached_splice(mb, pre, entries)
        self._insert_executor.submit(self._insert_misses, mb, pre, entries)
        return pre

    def _cached_splice(self, mb, pre, entries):
        """Host splice of hits + cache insertion of misses on one batch.

        `pre` is the batched `preprocess_stage` output; `entries` the
        execution-time resolved CacheEntry-or-None per request.  Returns the
        host result tree the feature stage should consume: miss rows exactly
        as the stage computed them (the round trip through the host is
        bitwise-lossless), hit rows replaced by their cached payloads
        (whose canonical clouds already sit in the batch rows).  Miss rows
        with a content address populate the cache before the feature stage
        runs, so a concurrent duplicate can hit as early as possible.
        """
        pre = result_to_host(pre)
        for i, ent in enumerate(entries):
            if ent is not None:
                result_set_row(pre, i, ent.pre)
        self._insert_misses(mb, pre, entries)
        return pre

    def _insert_misses(self, mb, pre, entries):
        """Populate the cache with one batch's miss rows (best effort).

        `pre` may be a device tree (the all-miss path, on the insert
        thread: `result_to_host` synchronises the device before reading
        it, and this task holds the tensors until their copies are done) or
        the host splice output.  Failures are swallowed: the response
        already shipped (or ships independently), and a lost fill only
        costs a future hit.
        """
        try:
            pre = result_to_host(pre)
            for i, req in enumerate(mb.requests):
                hit = i < len(entries) and entries[i] is not None
                if not hit and req.cache_key is not None:
                    mb.cache.insert(req.cache_key, mb.batch[i], result_row(pre, i))
        except Exception:  # noqa: BLE001 — cache fill must never fail a batch
            pass

    def _record_success(
        self,
        rep: Replica,
        entry: _Entry,
        logits,
        dt: float,
        *,
        preprocess_skipped: bool = False,
    ):
        """Success bookkeeping shared by the sequential and pipelined paths.

        exactly-one-winner: an evicted-but-still-running replica can race
        its batch's re-dispatched copy to this future — only the completion
        that lands records the batch, so metrics count each logical
        micro-batch once.  n_batches is under the pool lock because the
        worker AND feature threads both count here under mixed schedules.
        """
        mb = entry.mb
        with self._lock:
            rep.n_batches += 1
            rep.inflight.pop(entry.seq, None)
        if try_set_result(entry.future, logits):
            self.metrics.record_batch(BatchRecord(
                bucket=mb.bucket,
                policy_key=(
                    mb.policy.quant,
                    mb.policy.backend,
                    mb.policy.pipeline,
                    getattr(mb.policy, "sharding", None),
                ),
                n_real=mb.n_real,
                batch_size=mb.batch.shape[0],
                replica_id=rep.id,
                duration_s=dt,
                preprocess_skipped=preprocess_skipped,
                batch_id=getattr(mb, "batch_id", -1),
            ))

    def _execute_pipelined(self, rep: Replica, entry: _Entry):
        """Two-stage execution of one batch on the replica.

        Preprocessing is enqueued on the replica's preprocess stream by the
        worker thread, which never waits for it: it records an event and
        hands the batch to the feature thread, then goes on to preprocess
        the NEXT queued batch while this one's feature stage runs on the
        feature stream — the Mesorasi-style overlap, per replica.
        Liveness: each stage executor has its own heartbeat pump (when
        enabled), so a wedged feature thread stops the feature beats and
        the replica is evicted, re-dispatching its in-flight batches.
        Straggler tracking is skipped for pipelined batches (overlapping
        spans would corrupt its single-slot timer); BatchRecord.duration_s
        is measured directly.
        """
        mb = entry.mb
        try:
            accel = get_accelerator(self.model_cfg, mb.policy, device=rep.device)
            rep.acquire_handoff()  # double-buffer bound (released by feature stage)
            try:
                with on_streams(rep.pre_stream):
                    batch = torch.as_tensor(mb.batch, device=rep.device)
                    entries: tuple = ()
                    if mb.cache is not None:
                        # resolved on the worker thread: the pipelined worker
                        # runs one batch ahead of the feature thread, so late
                        # hits from the immediately preceding batch's insert
                        # may still miss — only the skip opportunity is lost
                        self._emit("batch.cache_start", mb, rep_id=rep.id)
                        entries = self._resolve_entries(mb)
                    if mb.n_real > 0 and entries and all(e is not None for e in entries):
                        # the cache skip composes with the pipeline: the
                        # worker hands the restacked payload straight to the
                        # feature thread, with no preprocessing at all
                        pre = self._hit_payload(rep, accel, mb, entries)
                        self._emit("batch.cache_end", mb, rep_id=rep.id,
                                   args={"skip": True})
                        skipped = True
                    else:
                        if mb.cache is not None:
                            self._emit("batch.cache_end", mb, rep_id=rep.id)
                        # enqueued, not waited for: the span measures the
                        # enqueue; the device time lands in the feature span
                        self._emit("batch.preprocess_start", mb, rep_id=rep.id)
                        pre = accel.preprocess_stage(batch)
                        self._emit("batch.preprocess_end", mb, rep_id=rep.id)
                        skipped = False
                        if mb.n_real == 0 and mb.cache is not None:
                            # warmup: its zero clouds' preprocessing is the filler row
                            self._filler(rep, accel, mb, pre)
                    done = None
                    if rep.pre_stream is not None:
                        done = torch.cuda.Event()
                        done.record(rep.pre_stream)
                if rep.heartbeat is not None:
                    rep.heartbeat.beat()
                rep.submit_feature(
                    self._finish_pipelined, rep, entry, accel, batch, pre, done,
                    skipped, entries,
                )
            except Exception:
                rep.release_handoff()  # the feature stage will never run for us
                raise
        except Exception as e:  # noqa: BLE001 — dispatch/executor failure
            self._fail(rep, entry, e)

    def _finish_pipelined(
        self,
        rep: Replica,
        entry: _Entry,
        accel,
        batch,
        pre,
        done,
        skipped: bool = False,
        entries: tuple = (),
    ):
        try:
            if entry.future.done():  # re-dispatched after eviction while queued
                with self._lock:
                    rep.inflight.pop(entry.seq, None)
                return
            # timed from HERE, not worker dispatch: queue wait behind earlier
            # batches' feature stages is pipeline overlap, not this batch's
            # cost (the feature stream still waits for any unfinished
            # preprocessing through the event)
            t0 = time.monotonic()
            try:
                mb = entry.mb
                with on_streams(rep.feat_stream), self._graph_trace(mb):
                    if done is not None:
                        rep.feat_stream.wait_event(done)
                        for t in (batch, *result_leaves(pre)):
                            t.record_stream(rep.feat_stream)
                    if not skipped and mb.cache is not None:
                        # mixed cache batch: host splice on the feature
                        # thread; all-miss batches keep the device tree
                        # and insert in the background
                        mixed = any(e is not None for e in entries)
                        if mixed:
                            self._emit("batch.splice_start", mb, rep_id=rep.id)
                        pre = self._splice_or_insert(mb, pre, entries)
                        if mixed:
                            self._emit("batch.splice_end", mb, rep_id=rep.id)
                    self._emit("batch.feature_start", mb, rep_id=rep.id)
                    # a host (spliced) or device tree alike
                    logits = _to_host(accel.feature_from_cached(rep.params, batch, pre))
                    self._emit("batch.feature_end", mb, rep_id=rep.id)
                dt = time.monotonic() - t0
                if rep.feature_heartbeat is not None:
                    rep.feature_heartbeat.beat()
                self._record_success(
                    rep, entry, logits, dt, preprocess_skipped=skipped
                )
            except Exception as e:  # noqa: BLE001 — any device/kernel failure
                self._fail(rep, entry, e)
        finally:
            rep.release_handoff()

    # -- lifecycle ------------------------------------------------------------

    def warmup(self, mb):
        """Run one batch synchronously on EVERY alive replica.

        Builds the kernels and captures each replica's graphs for this
        (bucket, policy) before real traffic arrives: the forward's, and
        under the preprocess cache the two halves' as well; for pipelined
        policies through the two-stage path, which captures the preprocess
        graph of the replica's preprocess stream and the feature graph.
        Under the cache it also keeps the filler row of all-hit batches.  A
        sharded policy runs one eager sharded forward over the group.
        Each distinct (bucket, policy) batch is also REGISTERED:
        rejoin/add_replica replay the registered set on a fresh replica so
        it joins warm.
        """
        with self._lock:
            for i, m in enumerate(self._warmup_mbs):
                if m.bucket == mb.bucket and m.policy == mb.policy:
                    # same key, new static shape (a live max_batch
                    # reconfiguration): rejoins must replay the CURRENT
                    # shape, so the registration is replaced, not dropped
                    if m.batch.shape != mb.batch.shape:
                        self._warmup_mbs[i] = mb
                    break
            else:
                self._warmup_mbs.append(mb)
        futs = []
        for rep in self.alive_replicas():
            entry = _Entry(mb, Future(), attempts=self.max_retries, tried=frozenset())
            self._register(rep, entry)
            rep.submit(self._execute, rep, entry)
            futs.append(entry.future)
        for f in futs:
            f.result(timeout=300)

    def shutdown(self):
        """Stop every replica (abandoning in-flight batches and cache fills)."""
        for rep in self.replicas:
            rep.shutdown()
        self._insert_executor.shutdown(wait=False)
