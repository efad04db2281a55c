"""The port's captured artifacts (`core/graphs.py`) on the CPU, where no graph is captured.

On the card the accelerator's entry points replay CUDA graphs; their
replays are held bitwise against `graphs.eager()` there
(tests/test_torch_gpu.py, chip_smoke.py).  Here, without a card:

  * `eager()` nests, restores and stays on its thread;
  * no CPU entry point, the serving runtime's included, touches
    `torch.cuda.graphs` or counts a capture;
  * `ArtifactCache` keys artifacts by params module, stage and input
    shapes and dtypes, drops them with their params module, captures again
    when a parameter is given new storage, and returns clones; a stub
    capture stands in for the card;
  * a pipelined executor runs each stage through its own device's
    accelerator;
  * the launch bookkeeping: a capture's launches are recorded, not counted,
    and every replay adds them (driven through a stub registry);
  * tracing (`graphs.traced`): a traced replay reports its lookup, copy-in,
    launch and clone times, bytes and sources on the context's batch; a
    traced capture reports itself and holds the stage marks whose times the
    next replay emits (stub timing events); untraced, nothing is emitted
    and no timing event is made;
  * the forward path, float and SC, cls and seg, builds no tensor from host
    data and reads nothing back to the host: what a capture forbids.

Nothing here imports jax or the JAX package.
"""

import contextlib
import dataclasses
import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from _graph_stub import STREAM, TimingEvent
from _graph_stub import stub_capture as _stub_capture
from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config
from repro_torch.core import graphs
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.engine import result_leaves, result_to_host
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.kernels import registry
from repro_torch.models import pointnet2 as PN

SC = ExecutionPolicy(quant="sc_w16a16")


# -- eager() ----------------------------------------------------------------------


def test_eager_nests_and_restores():
    assert not graphs.is_eager()
    with graphs.eager():
        assert graphs.is_eager()
        with graphs.eager():
            assert graphs.is_eager()
        assert graphs.is_eager()
    assert not graphs.is_eager()
    with pytest.raises(KeyError), graphs.eager():
        raise KeyError("inside")
    assert not graphs.is_eager()


def test_eager_is_per_thread():
    seen = []
    with graphs.eager():
        t = threading.Thread(target=lambda: seen.append(graphs.is_eager()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [False]


# -- the CPU runs eagerly ---------------------------------------------------------


class _NoGraph:
    def __init__(self, *args, **kwargs):
        raise AssertionError("a CPU entry point constructed a CUDA graph")


def test_cpu_entry_points_never_capture(monkeypatch):
    """Every entry point on the CPU, and a cached and a pipelined serving
    runtime, run without a CUDA graph and count no capture."""
    from repro_torch.serve import RuntimeConfig, ServingRuntime

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _NoGraph)
    cfg = get_config("pointnet2-cls", smoke=True)
    accel = get_accelerator(cfg, device="cpu")
    params = accel.init(torch.Generator().manual_seed(0))
    pts = np.random.default_rng(0).uniform(-1, 1, (2, cfg.n_points, 3)).astype(np.float32)
    before = graphs.captures()
    logits = accel.infer(params, pts)
    pre = accel.preprocess_stage(pts)
    torch.testing.assert_close(accel.feature_stage(params, pts, pre), logits, rtol=0, atol=0)
    torch.testing.assert_close(accel.feature_from_cached(params, pts, result_to_host(pre)),
                               logits, rtol=0, atol=0)
    for got in (accel.infer_with_preprocess(params, pts), accel.warmup(params, pts)):
        torch.testing.assert_close(got[0], logits, rtol=0, atol=0)
        for a, b in zip(result_leaves(got[1]), result_leaves(pre)):
            assert torch.equal(a, b)
    assert torch.equal(accel.infer_pipelined(params, [pts, pts])[1], logits)
    for policy in (ExecutionPolicy(), ExecutionPolicy(pipeline="pipelined")):
        with ServingRuntime(cfg, params, RuntimeConfig(max_batch=2, cache_max_bytes=2**22),
                            policy=policy, device="cpu") as rt:
            rt.warmup()
            out = rt.infer(pts[0])
        assert out.shape == (cfg.n_classes,)
    assert graphs.captures() == before


# -- ArtifactCache with a stub capture ----------------------------------------------


def _affine(x):
    return (x * 2 + 1, x.sum(dim=-1))


def test_artifact_keys_params_stage_shapes_and_dtypes():
    cache = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    p1, p2 = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    before = graphs.captures()

    def run(owner, stage, arg):
        cache.run(owner, stage, _affine, [arg])
        return graphs.captures() - before

    assert run(p1, "forward", x) == 1
    assert run(p1, "forward", x + 5) == 1  # the same key replays
    assert run(p1, "forward", x.numpy()) == 1  # a host array of the same shape and dtype too
    assert run(p2, "forward", x) == 2  # another params module
    assert run(p1, "feature", x) == 3  # another stage
    assert run(p1, "forward", x[:2]) == 4  # another shape
    assert run(p1, "forward", x.to(torch.float64)) == 5  # another dtype
    assert cache.get(p1, "forward", [x]) is not None
    assert cache.get(p2, "feature", [x]) is None


def test_artifact_dropped_with_its_params_module():
    cache = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    keep, gone = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    x = torch.ones(2, 3)
    cache.run(keep, "forward", _affine, [x])
    cache.run(gone, "forward", _affine, [x])
    ref = weakref.ref(gone)
    assert len(cache._by_params) == 2
    del gone
    gc.collect()
    assert ref() is None and len(cache._by_params) == 1
    assert cache.get(keep, "forward", [x]) is not None


def test_replaced_parameters_recapture_and_stay_alive_until_then():
    """A parameter given new storage (`.double().float()` moves every one
    away and back, as `.cpu()` then `.cuda()` does on the card) makes the
    next call capture again; an in-place update replays.  The old artifact
    kept the storage it read alive until it went."""
    cache = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    owner = torch.nn.Linear(3, 2)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)

    def fn(a):
        return (a @ owner.weight.T + owner.bias,)

    before = graphs.captures()
    cache.run(owner, "forward", fn, [x])
    cache.run(owner, "forward", fn, [x])
    assert graphs.captures() - before == 1
    with torch.no_grad():
        owner.weight.add_(1.0)  # in place: the same memory
    got = cache.run(owner, "forward", fn, [x])
    assert graphs.captures() - before == 1
    assert torch.equal(got[0], fn(x)[0])
    old = cache.get(owner, "forward", [x])
    old_weight = owner.weight.data_ptr()
    owner.double().float()
    assert owner.weight.data_ptr() != old_weight
    assert old.reads[0].data_ptr() == old_weight  # still held by the artifact
    got = cache.run(owner, "forward", fn, [x])
    assert graphs.captures() - before == 2
    assert torch.equal(got[0], fn(x)[0])
    new = cache.get(owner, "forward", [x])
    assert new is not old and new.addresses == tuple(p.data_ptr() for p in owner.parameters())
    cache.run(owner, "forward", fn, [x])
    assert graphs.captures() - before == 2


def test_pipelined_stages_run_through_their_own_devices_accelerator(monkeypatch):
    """An executor whose devices are not its accelerator's runs stage A
    through devices[0]'s accelerator, and its outputs lie there."""
    from repro_torch.core.accelerator import PipelinedExecutor

    cfg = get_config("pointnet2-cls", smoke=True)
    accel = get_accelerator(cfg, device="cpu")
    params = accel.init(torch.Generator().manual_seed(0))
    batches = [np.random.default_rng(s).uniform(-1, 1, (2, cfg.n_points, 3)).astype(np.float32)
               for s in range(3)]

    class Elsewhere:  # an accelerator of another device, which no stage may use
        config, policy, device = cfg, accel.policy, torch.device("meta")

        def preprocess_stage(self, *args):
            raise AssertionError("stage A ran on the executor's accelerator's device")

        feature_stage = preprocess_stage

    devices = []
    real = accel.preprocess_stage

    def preprocess_stage(pts):
        out = real(pts)
        devices.extend(t.device for t in result_leaves(out))
        return out

    monkeypatch.setattr(accel, "preprocess_stage", preprocess_stage)
    out = PipelinedExecutor(Elsewhere(), devices=["cpu"]).run(params, batches)
    assert devices and set(devices) == {torch.device("cpu")}
    for got, b in zip(out, batches):
        assert torch.equal(got, accel.infer(params, b))


def test_replay_rereads_inputs_and_returns_clones():
    cache = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    owner = torch.nn.Linear(1, 1)
    rng = np.random.default_rng(0)
    first = rng.standard_normal((4, 5)).astype(np.float32)
    want0 = _affine(torch.from_numpy(first))
    got0 = cache.run(owner, "forward", _affine, [first])  # the eager first call
    for a, b in zip(got0, want0):
        assert torch.equal(a, b)
    art = cache.get(owner, "forward", [first])
    outs = []
    for _ in range(3):
        x = rng.standard_normal((4, 5)).astype(np.float32)
        got = cache.run(owner, "forward", _affine, [x])
        for a, b in zip(got, _affine(torch.from_numpy(x))):
            assert torch.equal(a, b)
        assert all(g.data_ptr() != s.data_ptr() for g, s in zip(got, art.outputs))
        outs.append((x, got))
    for x, got in outs:  # a later replay never overwrote an earlier answer
        for a, b in zip(got, _affine(torch.from_numpy(x))):
            assert torch.equal(a, b)
    picked = cache.run(owner, "forward", _affine, [first], pick=lambda o: o[1])
    assert torch.equal(picked, want0[1])


def test_ensure_captures_without_running_eagerly():
    cache = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    owner = torch.nn.Linear(1, 1)
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    before = graphs.captures()
    art = cache.ensure(owner, "feature", fn, [np.zeros((2, 2), np.float32)])
    assert calls == [1]  # the capture's own trace only
    assert cache.ensure(owner, "feature", fn, [torch.zeros(2, 2)]) is art
    assert graphs.captures() - before == 1


# -- launch bookkeeping -----------------------------------------------------------


class _StubRegistry:
    """The registry's counting interface, on its own counters."""

    def __init__(self):
        self.counts = {}
        self.recordings = {}

    def count_launch(self, name, stream=None):
        target = self.recordings.get(stream, self.counts)
        target[name] = target.get(name, 0) + 1

    @contextlib.contextmanager
    def recording(self, stream):
        self.recordings[stream] = {}
        try:
            yield self.recordings[stream]
        finally:
            del self.recordings[stream]

    def add_launches(self, counts):
        for name, n in counts.items():
            self.counts[name] = self.counts.get(name, 0) + n


def test_replays_add_the_launches_their_capture_recorded(monkeypatch):
    stub = _StubRegistry()
    monkeypatch.setattr(graphs, "registry", stub)
    cache = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    owner = torch.nn.Linear(1, 1)

    def fn(x):  # its kernels launch on the capture stream, as a captured stage's do
        stub.count_launch("fps_tiles", STREAM)
        stub.count_launch("sc_matmul", STREAM)
        stub.count_launch("sc_matmul", STREAM)
        return x * 3

    x = torch.ones(2, 2)
    cache.run(owner, "forward", fn, [x])  # eager (counted) + capture (recorded only)
    assert stub.counts == {"fps_tiles": 1, "sc_matmul": 2}
    assert cache.get(owner, "forward", [x]).launches == {"fps_tiles": 1, "sc_matmul": 2}
    for _ in range(3):
        cache.run(owner, "forward", fn, [x])
    assert stub.counts == {"fps_tiles": 4, "sc_matmul": 8}


def test_registry_recording_takes_only_its_own_streams_launches():
    registry.reset_launches()
    with registry.recording(11) as rec:
        registry.count_launch("fps_tiles", 11)
        registry.count_launch("knn3", 12)  # another stream
        registry.count_launch("lattice_tiles")  # no stream named
        with pytest.raises(RuntimeError):
            with registry.recording(11):
                pass
        during = registry.launches()
    assert rec == {"fps_tiles": 1}
    assert during["fps_tiles"] == 0 and during["knn3"] == 1 and during["lattice_tiles"] == 1
    registry.count_launch("fps_tiles", 11)  # the recording has ended
    registry.add_launches(rec)
    registry.add_launches(rec)
    assert registry.launches()["fps_tiles"] == 3
    registry.reset_launches()


# -- tracing ---------------------------------------------------------------------


@pytest.fixture
def timing_events(monkeypatch):
    monkeypatch.setattr(graphs, "_timing_event", TimingEvent)
    monkeypatch.setattr(TimingEvent, "done", True)
    return TimingEvent


def _two_stages(x, labels):
    """A stage that marks two segments, as the forward does."""
    y = x * 2
    graphs.mark("preprocess")
    z = y.sum(dim=-1) + labels
    graphs.mark("feature")
    return z, y


def _refuse(*args, **kwargs):
    raise AssertionError("untraced graph work emitted an event or made a timing event")


def test_untraced_replays_and_captures_emit_nothing_and_make_no_event(monkeypatch):
    """Outside `traced()` nothing is emitted and no timing event is made: not
    by a capture, a replay, `mark()` or `GraphedStep`."""
    from repro_torch.serve.trace import Tracer

    monkeypatch.setattr(Tracer, "emit", _refuse)
    monkeypatch.setattr(graphs, "_timing_event", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    tracer = Tracer()
    cache = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    owner = torch.nn.Linear(1, 1)
    x, labels = np.ones((3, 4), np.float32), torch.arange(3)
    for _ in range(3):
        cache.run(owner, "forward", _two_stages, [x, labels])
    assert cache.get(owner, "forward", [x, labels]).marks is None
    graphs.mark("preprocess")
    step = graphs.GraphedStep(lambda a: (a + 1,), lambda: (), torch.device("cpu"),
                              capture=_stub_capture)
    step(torch.ones(2))
    step(torch.ones(2))
    assert len(tracer) == 0 and tracer.emitted == 0
    assert graphs._tracing.get() is None and graphs._marks.get() is None


def test_traced_replay_reports_its_parts_in_order(monkeypatch):
    """A traced replay emits one graph.replay_end on the context's batch: the
    stage, its inner times in order, the bytes copied in and each source's
    memory."""
    from repro_torch.serve.trace import Tracer

    cache = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    owner = torch.nn.Linear(1, 1)
    x, labels = np.ones((3, 4), np.float32), torch.arange(3)
    cache.run(owner, "forward", _two_stages, [x, labels])  # captured untraced
    tracer = Tracer()
    before = time.monotonic()
    with graphs.traced(tracer, batch_id=5):
        got = cache.run(owner, "forward", _two_stages, [x, labels])
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
        with graphs.traced(tracer, batch_id=6):  # nests
            cache.run(owner, "forward", _two_stages, [x, labels])
        art = cache.get(owner, "forward", [x, labels])
        art.replay([x, labels])  # a replay called directly: found at its entry
    after = time.monotonic()
    for a, b in zip(got, _two_stages(torch.from_numpy(x), labels)):
        assert torch.equal(a, b)
    events = tracer.events()
    assert [(e.name, e.batch_id) for e in events] == [
        ("graph.replay_end", 5), ("graph.replay_end", 6), ("graph.replay_end", 5)]
    for k, end in enumerate(events):
        a = end.args
        assert a["stage"] == "forward"
        times = [a["start"], a["found"], a["copying"], a["copied"], a["launched"], a["cloned"],
                 end.t]
        assert before <= times[0] and times == sorted(times) and end.t <= after
        assert a["bytes_in"] == 3 * 4 * 4 + 3 * 8
        assert a["sources"] == ["pageable", "pageable" if k == 0 else "pinned"]
    assert events[0].args["start"] < events[0].args["found"]  # run stamps before its lookup
    assert events[2].args["found"] == events[2].args["start"]
    assert graphs._tracing.get() is None


def test_traced_capture_reports_itself_and_times_its_marked_stages(timing_events):
    """A capture inside `traced()` emits graph.captured and holds the stage's
    marks; each later traced replay emits the stage times of the one before it,
    or counts a miss when its last mark has not finished."""
    from repro_torch.serve.trace import Tracer

    cache = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    owner = torch.nn.Linear(1, 1)
    x, labels = np.ones((3, 4), np.float32), torch.arange(3)
    tracer = Tracer()
    with graphs.traced(tracer, batch_id=2):
        cache.run(owner, "forward", _two_stages, [x, labels])  # eager, then captured
    art = cache.get(owner, "forward", [x, labels])
    assert [name for name, _ in art.marks] == ["", "preprocess", "feature"]
    (captured,) = tracer.events()
    assert (captured.name, captured.batch_id) == ("graph.captured", 2)
    assert captured.args["stage"] == "forward" and captured.args["shapes"] == [[3, 4], [3]]
    assert captured.args["seconds"] >= 0
    tracer.clear()
    for bid in (3, 4):
        with graphs.traced(tracer, batch_id=bid):
            cache.run(owner, "forward", _two_stages, [x, labels])
    events = tracer.events()
    assert [e.name for e in events] == ["graph.replay_end", "graph.stage_times",
                                        "graph.replay_end"]
    times = events[1]
    assert times.batch_id == 3 and times.args == {
        "preprocess_ms": 1.25, "feature_ms": 1.25, "stage": "forward",
        "replay_t": events[0].args["launched"]}
    missed = graphs.stage_times_missed()
    timing_events.done = False
    with graphs.traced(tracer, batch_id=5):
        cache.run(owner, "forward", _two_stages, [x, labels])
    assert graphs.stage_times_missed() == missed + 1
    assert "graph.stage_times" not in [e.name for e in tracer.events()[3:]]
    # an untraced replay records the marks again: the next traced one reads nothing
    timing_events.done = True
    cache.run(owner, "forward", _two_stages, [x, labels])
    tracer.clear()
    with graphs.traced(tracer, batch_id=6):
        cache.run(owner, "forward", _two_stages, [x, labels])
    assert [e.name for e in tracer.events()] == ["graph.replay_end"]
    assert graphs.stage_times_missed() == missed + 1


def test_traced_forward_capture_marks_preprocessing_then_features(timing_events):
    """The accelerator's captured forward closes a "preprocess" then a
    "feature" segment, and each serving stage its own."""
    from repro_torch.serve.trace import Tracer

    cfg = get_config("pointnet2-cls", smoke=True)
    accel = get_accelerator(cfg, device="cpu")
    params = accel.init(torch.Generator().manual_seed(0))
    accel = type(accel)(cfg, accel.policy, "cpu")
    accel.artifacts = graphs.ArtifactCache(torch.device("cpu"), capture=_stub_capture)
    pts = np.random.default_rng(0).uniform(-1, 1, (2, cfg.n_points, 3)).astype(np.float32)
    tracer = Tracer()
    with graphs.traced(tracer):
        accel.warmup(params, pts)
        accel.infer(params, pts)
    segments = {stage: [name for name, _ in art.marks]
                for (stage, _), art in accel.artifacts._by_params[params].artifacts.items()}
    pre = next(iter(accel.artifacts._by_stream.values())).artifacts
    segments.update({stage: [name for name, _ in art.marks]
                     for (stage, _), art in pre.items()})
    assert segments == {"forward": ["", "preprocess", "feature"], "feature": ["", "feature"],
                        "preprocess": ["", "preprocess"]}
    names = [e.name for e in tracer.events()]
    assert names.count("graph.captured") == 3 and names[-1] == "graph.replay_end"


# -- the forward path is capturable: no host data in, nothing read back --------------


class _HostDataCheck(TorchFunctionMode):
    """Records every call that builds a tensor from host data or reads one
    back to the host (or gives it a data-dependent shape)."""

    FORBIDDEN = {"tensor", "as_tensor", "asarray", "item", "tolist", "cpu", "numpy",
                 "nonzero", "argwhere", "masked_select", "unique", "__bool__", "__int__",
                 "__float__"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.FORBIDDEN:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
@pytest.mark.parametrize("policy", [ExecutionPolicy(), SC], ids=["none", "sc_w16a16"])
def test_forward_path_takes_no_host_data(model, policy):
    """What a capture records: the forward on a tensor already in place
    (`PN.preprocess_stage` then `PN.feature_stage`, the captured stages),
    here with the kernels' plain versions."""
    cfg = get_config(model, smoke=True)
    params = PN.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pts = torch.from_numpy(
        np.random.default_rng(1).uniform(-1, 1, (2, cfg.n_points, 3)).astype(np.float32))
    check = _HostDataCheck()
    with torch.inference_mode(), check:
        pre = PN.preprocess_stage(cfg, pts, policy=policy)
        logits = PN.feature_stage(params, cfg, pts, pre, policy=policy)
    assert check.seen == []
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
@pytest.mark.parametrize("preproc,aggregation", [("baseline1", "standard"),
                                                 ("baseline2", "standard"),
                                                 ("baseline1", "delayed"),
                                                 ("baseline2", "delayed"),
                                                 ("pc2im", "standard")])
def test_comparison_forward_takes_no_host_data(model, preproc, aggregation):
    """The paper's comparison paths are capturable too: the grid partition, the
    masked FPS and the ball query build nothing from host data and read
    nothing back (SC, the plain versions of the kernels)."""
    cfg = dataclasses.replace(get_config(model, smoke=True), preproc=preproc,
                              aggregation=aggregation)
    params = PN.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pts = np.random.default_rng(2).uniform(-1, 1, (2, cfg.n_points, 3)).astype(np.float32)
    pts[1, :, 2] = 0.5  # planar: empty grid cells, padded centroids
    pts = torch.from_numpy(pts)
    check = _HostDataCheck()
    with torch.inference_mode(), check:
        pre = PN.preprocess_stage(cfg, pts, policy=SC)
        logits = PN.feature_stage(params, cfg, pts, pre, policy=SC)
    assert check.seen == []
    assert bool(torch.isfinite(logits).all())
    if preproc == "baseline2":
        assert not bool(pre[0].centroid_valid[1].all())


@pytest.mark.parametrize("name", ["stablelm-1.6b", "gemma3-12b"])
@pytest.mark.parametrize("kv", ["none", "int8"])
@pytest.mark.parametrize("policy", [ExecutionPolicy(), SC], ids=["none", "sc_w16a16"])
def test_lm_prefill_and_decode_take_no_host_data(name, kv, policy):
    """The dense LM's prefill and decode_step, on tokens and a state already in
    place, build no tensor from host data and read nothing back: cache_len and
    the write index stay on the device, so decode can be captured (gemma3's
    rolling local caches included; 3 decode steps pass its window of 8 when
    the prompt is 7)."""
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(name, smoke=True), kv_quant=kv)
    params = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7)))
    check = _HostDataCheck()
    with torch.inference_mode(), check:
        logits, state = T.prefill(params, cfg, tokens, 12, policy=policy)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        for _ in range(3):
            logits, state = T.decode_step(params, cfg, state, tok, policy=policy)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    assert check.seen == []
    assert bool(torch.isfinite(logits).all()) and int(state.cache_len) == 10


@pytest.mark.parametrize("name", ["stablelm-1.6b", "gemma3-12b"])
@pytest.mark.parametrize("policy", [ExecutionPolicy(), SC], ids=["none", "sc_w16a16"])
def test_lm_loss_and_its_backward_take_no_host_data(name, policy):
    """The LM training loss and its gradient (the remat recompute, the chunked
    cross entropy's checkpointed chunks and the flash attention backward
    included), on a batch already in place, build no tensor from host data and
    read nothing back, so a later change can capture the train step."""
    from repro_torch.models import transformer as T
    from repro_torch.params import named_jax_params

    cfg = get_config(name, smoke=True)
    params = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 48)).astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    named = named_jax_params(params)
    check = _HostDataCheck()
    with check:
        loss, _ = T.lm_loss(params, cfg, batch, policy=policy)
        grads = torch.autograd.grad(loss, list(named.values()))
    assert check.seen == []
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)


FAMILIES = ["granite-moe-3b-a800m", "mamba2-1.3b", "recurrentgemma-2b", "whisper-small",
            "internvl2-2b"]


def _frontend(cfg, b: int) -> dict:
    """Seeded stub frontend outputs, already in place: whisper's 10 encoder frames,
    internvl2's patches; nothing for the other families."""
    rng = np.random.default_rng(8)
    n = {"encdec": 10, "vlm": cfg.n_patches}.get(cfg.family)
    if n is None:
        return {}
    key = "enc_embeds" if cfg.family == "encdec" else "patch_embeds"
    return {key: torch.from_numpy(rng.standard_normal((b, n, cfg.d_model)).astype(np.float32))}


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("policy", [ExecutionPolicy(), SC], ids=["none", "sc_w16a16"])
def test_lm_family_prefill_and_decode_take_no_host_data(name, policy):
    """The moe, ssm, hybrid, encdec and vlm families' prefill and decode_step,
    through the family API on inputs and a state already in place, build no tensor
    from host data and read nothing back: the MoE's routing (capacity from shapes,
    one-hot by comparison), the SSM's and RG-LRU's states, the hybrid's rolling
    local caches (a prompt of 7 and 3 steps pass its window of 8), encdec's
    position row gathered at cache_len and its cross-attention over the cached
    encoder K/V, and vlm's patches ahead of the prompt stay on the device."""
    from repro_torch.models.families import get_family_api

    cfg = get_config(name, smoke=True)
    api = get_family_api(cfg)
    params = api["init"](cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7)))
    extra = _frontend(cfg, 2)
    ahead = cfg.n_patches if cfg.family == "vlm" else 0
    check = _HostDataCheck()
    with torch.inference_mode(), check:
        logits, state = api["prefill"](params, cfg, {"tokens": tokens, **extra}, 12 + ahead,
                                       policy=policy)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        for _ in range(3):
            logits, state = api["decode_step"](params, cfg, state, {"token": tok}, policy=policy)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    assert check.seen == []
    assert bool(torch.isfinite(logits).all()) and int(state.cache_len) == 10 + ahead


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("policy", [ExecutionPolicy(), SC], ids=["none", "sc_w16a16"])
def test_lm_family_loss_and_its_backward_take_no_host_data(name, policy):
    """The moe, ssm, hybrid, encdec and vlm families' train_loss and its gradient
    (the remat recompute of each layer or group included, encdec's encoder layers
    too) build no tensor from host data and read nothing back."""
    from repro_torch.models.families import get_family_api
    from repro_torch.params import named_jax_params

    cfg = get_config(name, smoke=True)
    api = get_family_api(cfg)
    params = api["init"](cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 48)).astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1), **_frontend(cfg, 2)}
    named = named_jax_params(params)
    check = _HostDataCheck()
    with check:
        loss, _ = api["train_loss"](params, cfg, batch, policy=policy)
        grads = torch.autograd.grad(loss, list(named.values()))
    assert check.seen == []
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
