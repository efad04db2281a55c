"""Captured CUDA graphs: the port's counterpart of the JAX package's jit artifacts.

The JAX accelerator is a set of compiled artifacts: `jax.jit` of the
forward, of each half and of the fused forward-with-preprocessing, one per
(config, policy), traced again for each input shape.  Here an artifact is
a CUDA graph captured once per (accelerator, params, stage, input shapes)
and replayed: one graph launch in place of the few hundred kernels a
forward enqueues op by op from Python.

An `Artifact` holds

  * static input buffers (the points, and for the feature stage every leaf
    of the preprocessing tree), which each replay overwrites with the
    caller's inputs on the current stream, a host array in one H2D copy;
  * the `torch.cuda.CUDAGraph`, which `replay()` launches on the current
    stream, so a replica's or a pipeline stage's stream keeps working;
  * its static outputs, which the next replay overwrites.  A replay
    therefore returns CLONES: a caller never holds memory that a later
    replay writes (the cache-fill thread reads `infer_with_preprocess`'s
    preprocessing long after the call returned);
  * the kernel launches counted while it was captured, added to the
    registry's counters on every replay (`registry.add_launches`).

Four stages are captured, and the accelerator's entry points replay them:

    "forward"     infer, infer_with_preprocess      -> (logits, preprocessing)
    "preprocess"  preprocess_stage                  -> preprocessing
    "feature"     feature_stage, feature_from_cached -> logits
    "loss"        loss (points and int64 labels)    -> (nll, accuracy)

`warmup` captures the first three, the serving stages.

Keys.  An `ArtifactCache` belongs to one accelerator, whose config, policy
and device it shares.  A graph bakes in the addresses of the parameters it
reads, and each serving replica has its own copy (`params_copy_on`), so the
stages that read parameters are keyed weakly by the params module (an
artifact goes when its parameters do).  The params-free preprocess stage is
keyed by the stream it is called on, so two replicas never share one.
Under that key: the stage, and the shapes and dtypes of the static inputs.
A parameter updated in place is seen by the next replay.  One replaced by
a new tensor (`.cpu()` then `.cuda()`, `.half()`,
`load_state_dict(assign=True)`) would leave the graph reading freed
memory, so an artifact keeps the parameters and buffers it read alive and
a call first compares their addresses with those the module holds now: on
a change the artifact goes (after its last replay) and the call captures
again, as `jax.jit` always sees the params it is given.  The module's own
tree is walked once; a submodule replaced inside it is not seen.

Capture.  The first call for a key runs the stage eagerly on the caller's
stream (its launches count, and its result is the call's answer, as
`jax.jit`'s first call traces, compiles and runs), then captures it on a
side stream, both under `core.device.CAPTURE_LOCK`.  The eager run is the warm-up: it loads the kernel libraries'
modules and sets their shared-memory attributes (csrc/lattice.cu,
csrc/sc_matmul.cu), creates this thread's cuBLAS handle and fills the
caching allocator, none of which may happen first inside a capture.  The
cuBLAS workspaces are cleared before and after the capture, so the graph's
matmuls take a workspace of their own from the graph's memory pool rather
than one that eager work goes on using, or that another graph captured on
the same pooled stream baked in.  A capture takes no workspace of its own
(PyTorch's own CUDA-graph trees clear the same way around each recording,
`torch/_inductor/cudagraph_trees.py`).  The clear is process-wide: PyTorch
keeps the workspace map behind a mutex (`WorkspaceMapWithMutex`), and a
workspace it frees under another thread's feet goes back to the caching
allocator for the stream it was made on, where only work enqueued after
that thread's matmul can take it, since each of the port's threads that
runs matmuls does so on a stream of its own.  The capture mode is
"thread_local": a serving runtime has other threads running eager work
meanwhile.  Captures are serialised process-wide (one at a time, the CUDA
graph rule), with Python's cyclic collector off (a collection could
destroy an unreachable graph on the capturing thread, which invalidates
the capture), and no other thread's first-use set-up runs beside one; the
port's device-wide synchronisations take the lock too, since one from any
thread would invalidate a capture under way.  Every graph has a memory pool of its own, so no two
artifacts share memory, the pipelined pair that replays concurrently on two
streams included.  A capture that fails raises with the stage and shapes:
nothing on the card falls back to eager.

Sharing.  An artifact replayed from two threads or on two streams stays
right: a lock covers each replay's copy-in, launch and clone-out, and a
replay on another stream than the last one first waits for the last
replay's event.

A training step is a graph too (`GraphedStep`), the counterpart of the
reference's `jax.jit(step_fn)`: forward, `torch.autograd.grad` and the
optimizer's in-place update in one capture, replayed over the same
parameter and moment tensors.  Unlike an inference artifact it runs with
autograd on, outside inference mode, and writes the tensors it reads.

`eager()` is the counterpart of `jax.disable_jit()`: inside it the entry
points run op by op on the card, as before graphs.  It is the reference
side of every graph-against-eager check and is never entered on a caller's
behalf.  `captures()` counts captures, as the JAX `CacheStats` count
compiles: a serving run checks that it stays flat after warmup.

Tracing.  Inside `traced(tracer, batch_id)` the graph layer reports to a
`serve.trace.Tracer` (any object with its `emit`; this module imports
nothing of `serve`), stamped with `time.monotonic()` as every span of the
tracer is:

  * each replay, "graph.replay_end", emitted as it returns, whose args
    give the stage, the call's entry (`start`: `ArtifactCache.run`'s, or
    the replay's when it is called directly) and the times at which the
    artifact was found (the lookup, parameter-address walk included), the
    copy began (after the artifact's lock, a wait for another stream's
    replay and the reading of the last stage times), the inputs were
    copied in, the graph launched (`graph.replay()` returned) and the
    outputs' clones enqueued, the bytes copied in and whether each source
    was pageable host memory, pinned host memory or on a device;
  * each capture, "graph.captured": the stage, its input shapes and the
    seconds it took.  A traced capture also records timing events as nodes
    of the graph, at its start and at each `mark(name)` the stage's
    function reaches, which closes the segment `name` (the forward marks
    "preprocess" and "feature"): the card's own clock for each segment;
  * after a traced replay of a marked graph, the next traced replay of
    that artifact emits "graph.stage_times", `{<segment>_ms}` of that
    earlier replay (and `replay_t`, when it was launched), if its last mark
    has completed; if not, it counts one in `stage_times_missed()` and
    never waits.  Every replay of the graph records the marks again, so an
    untraced replay in between leaves nothing to read.

Off, the context holds None: a replay and a capture read it once and
emit nothing, record no event and build nothing; a graph captured
untraced holds no timing event.  A replay takes its clock stamps either
way, so that one body serves both.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import threading
import time
import weakref

import numpy as np
import torch

from repro_torch.core.device import CAPTURE_LOCK
from repro_torch.core.engine import result_map
from repro_torch.kernels import registry

STAGES = ("forward", "preprocess", "feature")

# how deep the current context is in eager() blocks; every thread starts in a
# fresh context, outside eager()
_eager_depth = contextvars.ContextVar("repro_torch_eager_depth", default=0)
# the (tracer, batch id) of the current context (`traced()`), None when tracing is off
_tracing = contextvars.ContextVar("repro_torch_graph_tracing", default=None)
# the timing events of the traced capture under way (`mark()`), None outside one
_marks = contextvars.ContextVar("repro_torch_graph_marks", default=None)
_stats_lock = threading.Lock()
_captures = 0
_missed = 0


@contextlib.contextmanager
def eager():
    """Run the accelerator entry points eagerly on the card, on this thread, inside the block.

    Nests; the previous mode comes back on exit.  Other threads are not
    affected.
    """
    token = _eager_depth.set(_eager_depth.get() + 1)
    try:
        yield
    finally:
        _eager_depth.reset(token)


def is_eager() -> bool:
    """Whether this thread is inside an `eager()` block."""
    return _eager_depth.get() > 0


def captures() -> int:
    """How many graphs this process has captured."""
    with _stats_lock:
        return _captures


class _Trace:
    """Where a traced context reports: the tracer and the batch its spans belong to."""

    __slots__ = ("tracer", "batch_id")

    def __init__(self, tracer, batch_id: int):
        self.tracer, self.batch_id = tracer, batch_id


@contextlib.contextmanager
def traced(tracer, batch_id: int = -1):
    """Report this thread's graph replays and captures to `tracer` inside the block.

    `batch_id` links the spans to the batch that caused them (-1: none).
    Nests; the previous context comes back on exit.  Other threads are not
    affected.
    """
    token = _tracing.set(_Trace(tracer, batch_id))
    try:
        yield
    finally:
        _tracing.reset(token)


def stage_times_missed() -> int:
    """How many marked replays the next traced replay found unfinished on the card.

    Their stage times are not read: a replay never waits for the card.
    """
    with _stats_lock:
        return _missed


def mark(name: str) -> None:
    """Close the segment `name` of the stage being captured here.

    Inside a traced capture: a timing event recorded on the capture stream,
    a node of the graph.  Anywhere else (an eager run, an untraced capture):
    nothing.
    """
    marks = _marks.get()
    if marks is not None:
        marks.append((name, _timing_event()))


def _timing_event():
    """A timing event recorded on the current stream.

    Inside a capture it is an external event-record node, which each replay
    records again.
    """
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


def _sources(args) -> tuple[list[str], int]:
    """Where each input lives, and the bytes of them all.

    Each is "pageable" or "pinned" host memory, or on a "device".
    """
    where, nbytes = [], 0
    for x in args:
        if isinstance(x, torch.Tensor):
            nbytes += x.numel() * x.element_size()
            where.append("device" if x.device.type != "cpu"
                         else "pinned" if x.is_pinned() else "pageable")
        else:
            nbytes += np.asarray(x).nbytes
            where.append("pageable")
    return where, nbytes


def _torch_dtype(x) -> torch.dtype:
    """The torch dtype of a tensor, or of a numpy array's values."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, dtype=np.asarray(x).dtype)).dtype


def _signature(args) -> tuple:
    """(shape, torch dtype) of each input: what the static buffers are made of.

    A numpy array and a tensor of the same shape and dtype have the same
    signature, so a host tree and a device tree replay one artifact.
    """
    return tuple((tuple(x.shape), _torch_dtype(x)) for x in args)


def _host_tensor(x) -> torch.Tensor:
    """A numpy input as a CPU tensor over its own memory (a copy only if read-only)."""
    x = np.asarray(x)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x)


def _on(device: torch.device, x) -> torch.Tensor:
    """An input as a tensor on `device` (the eager run's inputs)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return _host_tensor(x).to(device)


class Artifact:
    """One captured graph with its static inputs and outputs and its launch counts.

    `reads` are the parameters and buffers the graph reads: kept alive
    (detached, so a parameter given new data leaves this storage in place)
    and their addresses kept to compare with the module's.
    """

    def __init__(self, graph, inputs: list, outputs, launches: dict[str, int], reads=(),
                 stage: str = "", marks=None):
        self.graph = graph
        self.stage = stage
        # [(segment, timing event)] of a traced capture, its start first; None untraced
        self.marks = marks
        self._marked = None  # (batch id, launch time) of the last traced replay, if marked
        self.inputs = inputs
        self.outputs = outputs
        self.launches = dict(launches)
        self.reads = tuple(t.detach() for t in reads)
        self.addresses = tuple(t.data_ptr() for t in reads)
        self.device = inputs[0].device
        self._lock = threading.Lock()
        self._done = None  # CUDA event after the last replay's clones
        self._stream = None  # the stream of the last replay

    def replay(self, args, pick=None, start: float | None = None):
        """Copy `args` into the static inputs, launch the graph, return clones of its outputs.

        Everything runs on the current stream.  `pick` selects the outputs
        to return (all of them by default), so a caller clones only what it
        uses.  Inside `traced()` the replay is reported (module docstring);
        `start` is when the caller began to look this artifact up, this
        call's entry if not given.
        """
        trace = _tracing.get()
        found = time.monotonic()
        outs = self.outputs if pick is None else pick(self.outputs)
        cuda = self.device.type == "cuda"
        with self._lock, torch.inference_mode():
            if cuda:
                stream = torch.cuda.current_stream(self.device)
                if self._done is not None and stream != self._stream:
                    stream.wait_event(self._done)
            last, stages = self._marked, None
            if trace is not None and last is not None:  # before this launch records them again
                stages = self._stage_times()
            copying = time.monotonic()
            for dst, src in zip(self.inputs, args):
                dst.copy_(src if isinstance(src, torch.Tensor) else _host_tensor(src))
            copied = time.monotonic()
            self.graph.replay()
            launched = time.monotonic()
            got = result_map(torch.clone, outs)
            cloned = time.monotonic()
            if cuda:
                if self._done is None:
                    self._done = torch.cuda.Event()
                self._done.record(stream)
                self._stream = stream
            # the marks now time this replay: readable only if it is traced
            self._marked = ((trace.batch_id, launched)
                            if trace is not None and self.marks is not None else None)
        registry.add_launches(self.launches)
        if trace is not None:
            self._report(trace, args, last, stages,
                         (found if start is None else start, found, copying, copied, launched,
                          cloned))
        return got

    def _report(self, trace: _Trace, args, last, stages: dict | None, times: tuple):
        """Emit a traced replay's events.

        First the stage times of the traced replay before it (`last`, its
        batch id and launch time), if it left marks, then this replay's own
        host span, `times` = (start, found, copying, copied, launched,
        cloned).
        """
        global _missed
        end = time.monotonic()
        if last is not None:
            if stages is None:
                with _stats_lock:
                    _missed += 1
            else:
                stages.update(stage=self.stage, replay_t=last[1])
                trace.tracer.emit("graph.stage_times", batch_id=last[0], args=stages, t=end)
        sources, nbytes = _sources(args)
        trace.tracer.emit("graph.replay_end", batch_id=trace.batch_id, t=end, args={
            "stage": self.stage,
            **dict(zip(("start", "found", "copying", "copied", "launched", "cloned"), times)),
            "bytes_in": nbytes, "sources": sources})

    def _stage_times(self) -> dict | None:
        """{<segment>_ms} of the last replay from its marks, or None if it has not finished."""
        if not self.marks[-1][1].query():
            return None
        return {f"{name}_ms": a.elapsed_time(b)
                for (_, a), (name, b) in zip(self.marks, self.marks[1:])}


def capture_graph(fn, static: list, what: str):
    """Capture fn(*static) into a new CUDA graph on a side stream.

    Returns (graph, static outputs, launches counted during the capture).
    The caller has run fn eagerly at these shapes on this thread first.
    """
    graph = torch.cuda.CUDAGraph()
    # PyTorch hands streams out round-robin from pools of 32 per priority, so
    # a capture stream from the pool every replica draws on could be a live
    # replica's stream, whose work would land in the graph.  No code of the
    # port takes a high-priority stream; a graph runs at the priority of the
    # stream it is replayed on.
    side = torch.cuda.Stream(static[0].device, priority=-1)
    torch._C._cuda_clearCublasWorkspaces()
    # A cyclic collection run by an allocation inside the capture could free
    # an unreachable graph on this thread, whose destruction a capturing
    # thread may not call (it invalidates the capture): the collector is off
    # until the capture ends.  Captures are serialised (CAPTURE_LOCK).
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side), registry.recording(side.cuda_stream) as launches:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = fn(*static)
            except BaseException:
                with contextlib.suppress(RuntimeError):  # end the capture; fn's error wins
                    graph.capture_end()
                raise
            graph.capture_end()
    except Exception as e:  # noqa: BLE001 — re-raised with what was being captured
        raise RuntimeError(f"capturing {what} failed: {e}") from e
    finally:
        if collecting:
            gc.enable()
        torch._C._cuda_clearCublasWorkspaces()
    return graph, outputs, launches


def _fresh(artifacts: dict, key, addresses: tuple, lock) -> Artifact | None:
    """The artifact under `key` in `artifacts`, unless the tensors it read have
    been replaced (their addresses are not `addresses` now): then it is
    dropped, once its last replay has run.  `lock` guards `artifacts`."""
    art = artifacts.get(key)
    if art is None or art.addresses == addresses:
        return art
    with lock:
        if artifacts.get(key) is art:
            del artifacts[key]
    if art._done is not None:
        art._done.synchronize()
    return None


def _capture_artifact(capture, fn, static: list, reads, what: str, stage: str) -> Artifact:
    """fn captured over the static inputs (`capture`) as a new Artifact that
    keeps `reads` alive; counted in `captures()`.  In a traced context the
    graph holds the stage's timing marks and the capture is reported.

    The caller holds CAPTURE_LOCK and has chosen the grad mode of the capture.
    """
    global _captures
    trace = _tracing.get()
    if trace is None:
        graph, outputs, launches = capture(fn, static, what)
        marks = None
    else:
        t0 = time.monotonic()
        marks = []
        token = _marks.set(marks)
        try:
            graph, outputs, launches = capture(_started(fn), static, what)
        finally:
            _marks.reset(token)
        trace.tracer.emit("graph.captured", batch_id=trace.batch_id, args={
            "stage": stage, "shapes": [list(x.shape) for x in static],
            "seconds": time.monotonic() - t0})
    with _stats_lock:
        _captures += 1
    return Artifact(graph, static, outputs, launches, reads, stage=stage,
                    marks=marks if marks and len(marks) > 1 else None)


def _started(fn):
    """fn, with a timing mark at its start (the capture's first node)."""
    def started(*args):
        mark("")
        return fn(*args)
    return started


class _Owned:
    """The artifacts of one owner (a params module, or a stream's None), and
    where the tensors they read live."""

    def __init__(self, owner):
        # the parameter and buffer dicts of the owner's modules, walked once
        # rather than on every call: a tensor put in place of another shows
        # in them
        self.slots = [] if owner is None else [
            d for m in owner.modules() for d in (m._parameters, m._buffers) if d]
        self.artifacts: dict = {}

    def reads(self) -> tuple:
        return tuple(t for d in self.slots for t in d.values() if t is not None)

    def addresses(self) -> tuple:
        return tuple(t.data_ptr() for t in self.reads())


class ArtifactCache:
    """The captured artifacts of one accelerator (see the module docstring).

    `capture` makes one graph (`capture_graph`); the CPU tests pass a stub.
    """

    def __init__(self, device: torch.device, capture=capture_graph):
        self.device = device
        self._capture = capture
        self._by_params: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._by_stream: dict = {}
        self._lock = threading.Lock()

    def _owned(self, owner) -> _Owned:
        with self._lock:
            if owner is not None:
                owned = self._by_params.get(owner)
                if owned is None:
                    owned = self._by_params[owner] = _Owned(owner)
                return owned
            stream = (torch.cuda.current_stream(self.device).cuda_stream
                      if self.device.type == "cuda" else None)
            return self._by_stream.setdefault(stream, _Owned(None))

    def get(self, owner, stage: str, args) -> Artifact | None:
        """The artifact of (owner, stage, the inputs' shapes and dtypes), if captured
        over the tensors the owner holds now.

        `owner` is the params module, or None for the params-free stage
        (keyed by the current stream).
        """
        owned = self._owned(owner)
        return _fresh(owned.artifacts, (stage, _signature(args)), owned.addresses(), self._lock)

    def run(self, owner, stage: str, fn, args, pick=None):
        """fn(*args) through the artifact of (owner, stage, args).

        A hit replays it.  A miss runs fn eagerly on the inputs (this call's
        answer), then captures it (`ensure`).
        """
        start = time.monotonic()
        art = self.get(owner, stage, args)
        if art is not None:
            return art.replay(args, pick, start)
        with CAPTURE_LOCK, torch.inference_mode():
            out = fn(*[_on(self.device, a) for a in args])
            self.ensure(owner, stage, fn, args)
        return out if pick is None else pick(out)

    def ensure(self, owner, stage: str, fn, args) -> Artifact:
        """The artifact of (owner, stage, args), captured now if there is none.

        Runs nothing eagerly: the caller has run fn at these shapes on this
        thread (the forward warms every stage).
        """
        owned = self._owned(owner)
        key = (stage, _signature(args))
        with CAPTURE_LOCK:
            art = _fresh(owned.artifacts, key, owned.addresses(), self._lock)
            if art is None:
                what = f"the {stage} stage at input shapes {[list(s) for s, _ in key[1]]}"
                with torch.inference_mode():
                    static = [torch.empty(s, dtype=d, device=self.device) for s, d in key[1]]
                    art = _capture_artifact(self._capture, fn, static, owned.reads(), what,
                                            stage)
                with self._lock:
                    owned.artifacts[key] = art
        return art


class GraphedStep:
    """fn(*inputs), which updates tensors in place, replayed as one captured CUDA graph.

    `fn` reads and writes the tensors that `state()` returns (parameters,
    optimizer moments, the step count) in place and returns a tuple of
    tensors (the step's metrics).  The first call for an input signature
    runs fn eagerly (a real step: its updates stand and its result is the
    call's answer, as `jax.jit`'s first call runs the step it compiled),
    then captures fn on a side stream, which runs nothing, both under
    `core.device.CAPTURE_LOCK`.  No warm-up step has to be undone.  Every
    later call copies its inputs into the static input buffers and
    replays on the current stream, returning clones of the outputs.  The
    eager first step is the capture's warm-up: it loads the kernels,
    creates the cuBLAS handles of this thread and of autograd's device
    thread (which runs the backward, on the forward's stream, inside the
    capture too) and fills the caching allocator.

    The graph bakes in the addresses of the state tensors: if `state()`
    holds another tensor at the next call (a checkpoint restored by
    replacing storage), the step captures again.  Inside `eager()` fn runs
    eagerly on every call.  A caller on the CPU runs fn itself: `capture`
    makes a CUDA graph (the CPU tests pass a stub).
    """

    def __init__(self, fn, state, device: torch.device, capture=capture_graph):
        self.fn = fn
        self.state = state
        self.device = device
        self._capture = capture
        self._artifacts: dict = {}
        self._lock = threading.Lock()

    def __call__(self, *args):
        """One step on `args` (tensors or host arrays): a replay, or the eager
        first step followed by the capture."""
        if is_eager():
            return self.fn(*args)
        key = _signature(args)
        state = self.state()
        art = _fresh(self._artifacts, key, tuple(t.data_ptr() for t in state), self._lock)
        if art is not None:
            return art.replay(args)
        with CAPTURE_LOCK:
            out = self.fn(*[_on(self.device, a) for a in args])
            # static inputs outside inference mode: autograd saves them for the backward
            static = [torch.empty(s, dtype=d, device=self.device) for s, d in key]
            what = f"the training step at input shapes {[list(s) for s, _ in key]}"
            art = _capture_artifact(self._capture, self.fn, static, state, what, "train")
            with self._lock:
                self._artifacts[key] = art
        return out
