"""The benchmark's harness: one cell, one seed, one process.

Everything a cell is made of is found by name under the benchmark's root:

* `BENCHMARK.json` lists the cells (a configuration and a traffic mix),
  the end-to-end metrics and the per-layer metrics;
* `bench/configs/<file>.json` spells out every field of the program's
  `PointNet2Config` as a literal;
* `bench/traffic/<mix>.json` holds a mix's parameters: the policy, the
  clouds, the loop (a closed loop of batches, or an open loop of ragged
  requests through the serving runtime), the sample the check compares and
  its limits;
* `bench/metrics/<metric>.py` reads one per-layer metric.

A run makes its weights on the device and its clouds on the host from the
seed, warms up the cell's one shape (set-up), measures for `seconds`,
checks what the timed path produced against the plain reference
(`bench/reference/`) and returns the result line's dict.  The program under
test is imported here, and only here, from `repro_torch`.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import threading
import time

import numpy as np

from bench import devtrace, generator, work
from bench.reference import pointnet2 as ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
LATE_WAIT_S = 60.0  # how long past the window's close an answer is waited for
TRACE_EVENTS_PER_REQUEST = 16  # generous: a request's own edges and its share of its batch's
PROFILE_TRIES = 3


class BenchError(RuntimeError):
    """A cell, file or run that does not hold together."""


# -- finding things by name ---------------------------------------------------


def load_json(path: pathlib.Path) -> dict:
    """A JSON file, or BenchError naming it."""
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError) as e:
        raise BenchError(f"cannot read {path}: {e}") from e


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    """The root's BENCHMARK.json."""
    return load_json(root / "BENCHMARK.json")


def named(entries: list, name: str, what: str) -> dict:
    """The entry of `entries` called `name`."""
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchError(f"no {what} named {name!r}")


def load_config(root: pathlib.Path, bench: dict, name: str) -> dict:
    """The configuration file of configuration `name`, as it is run."""
    return load_json(root / named(bench["configs"], name, "configuration")["file"])


def load_traffic(root: pathlib.Path, name: str) -> dict:
    """The traffic mix `name`: bench/traffic/<name>.json."""
    return load_json(root / "bench" / "traffic" / f"{name}.json")


def load_metric(root: pathlib.Path, name: str):
    """The reader module of per-layer metric `name`: bench/metrics/<name>.py."""
    path = root / "bench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"per-layer metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: end-to-end ones, or with trace the per-layer ones.

    A metric with a `workloads` key belongs to the cells it lists; one
    without it to every cell, or (per-layer) to every cell that reports the
    end-to-end metric it moves.
    """
    def mine(m):
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


# -- the program under test ------------------------------------------------------


def program_config(cfg: dict):
    """The program's PointNet2Config with every field from the configuration file."""
    from repro_torch.models.pointnet2 import PointNet2Config, SAConfig

    fields = {f.name for f in dataclasses.fields(PointNet2Config)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    missing = fields - set(kw)
    if missing:
        raise BenchError(f"configuration {cfg.get('name')!r} leaves out {sorted(missing)}")
    kw["sa"] = tuple(SAConfig(s["n_centroids"], s["radius"], s["nsample"], tuple(s["mlp"]))
                     for s in cfg["sa"])
    for key in ("global_mlp", "fp_mlp", "head"):
        kw[key] = tuple(kw[key])
    return PointNet2Config(**kw)


def make_weights(torch, cfg: dict, seed: int, device) -> dict:
    """Every weight of the configuration, drawn in one call on `device` from the seed.

    w ~ N(0, 1/d_in); biases and LayerNorm shifts ~ N(0, 0.01); LayerNorm
    gains ~ 1 + N(0, 0.01): no leaf is left at a value that hides a fault.
    """
    shapes = ref.param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[at:at + n].reshape(shape)
        at += n
        if name.endswith(".w"):
            x = x / math.sqrt(shape[0])
        elif name.endswith(".g"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[name] = x
    return out


def program_params(torch, pcfg, weights: dict, device):
    """The program's parameter module holding copies of `weights`.

    The module is built on `device` (its own initial draws, from a generator
    there, are overwritten at once): building it on meta would load
    torch's meta decompositions, seconds of imports that serve no request.
    """
    from repro_torch.models.pointnet2 import PointNet2Params

    gen = torch.Generator(device=device).manual_seed(0)
    params = PointNet2Params(pcfg, generator=gen, device=device)
    names = {n for n, _ in params.named_parameters()}
    if names != set(weights):
        raise BenchError(f"the program's weights differ from the configuration's: "
                         f"{sorted(names ^ set(weights))[:6]}")
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(weights[n])
    return params


# -- what a run collects ---------------------------------------------------------


@dataclasses.dataclass
class Env:
    """Where a run runs: the device and how the card's energy is read (None: not read)."""

    torch: object
    device: object
    power: object = None  # callable() -> a PowerSampler-like context manager
    kind: str = "cpu"
    platform: str = "cpu"


@dataclasses.dataclass
class RunData:
    """What the per-layer readers read (see bench/metrics/)."""

    cell: str
    cfg: dict
    traffic: dict
    quant: str
    seconds: float
    window_s: float = 0.0
    clouds: int = 0
    spans: list = dataclasses.field(default_factory=list)  # (label, t0, t1) host spans
    stretch: devtrace.Stretch | None = None
    stretch_pool: list = dataclasses.field(default_factory=list)  # pool batch of each unit
    launches: dict = dataclasses.field(default_factory=dict)  # per forward, by kernel
    preproc_least_s: dict | None = None  # pool batch -> {kernel: least seconds}
    events: list = dataclasses.field(default_factory=list)  # serving trace events
    batch_records: list = dataclasses.field(default_factory=list)
    phases: list = dataclasses.field(default_factory=list)  # (set-up step, monotonic end)
    quiet_until: float = math.inf  # serving spans after this met the profiler's start

    def phase(self, label: str) -> None:
        """Mark the end of one step of the set-up."""
        self.phases.append((label, time.monotonic()))

    @property
    def batch(self) -> int:
        """The static batch dim of the cell's forward."""
        return self.traffic["batch"]


class Reservoir:
    """A uniform sample of k items of a stream of unknown length, drawn from the seed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        """Consider the next item of the stream."""
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class GcWatch:
    """The cyclic collector's pauses while the window is open (`gc.callbacks`).

    Use as a context manager; `summary()` gives {generation: [collections,
    seconds in all, longest seconds]}.
    """

    def __init__(self):
        self._t = None
        self.pauses: list[tuple[int, float]] = []

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"], time.perf_counter() - self._t))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def summary(self) -> dict:
        """Collections, total and longest pause by generation."""
        out: dict = {}
        for gen, secs in self.pauses:
            entry = out.setdefault(gen, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += secs
            entry[2] = max(entry[2], secs)
        return out


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """Widest gap of one answer: max |got - want| over the largest |want|."""
    if got.shape != want.shape:
        return math.inf
    return float(np.max(np.abs(got.astype(np.float64) - want)) / max(np.max(np.abs(want)), 1e-30))


def _sync(env: Env) -> None:
    if env.device.type == "cuda":
        env.torch.cuda.synchronize(env.device)


# -- the closed loop of batches --------------------------------------------------------


def run_batches(env: Env, data: RunData, pcfg, weights, pool, seed, *, trace: bool,
                quant: str, fault=None) -> dict:
    """Set up, measure and check a closed-loop cell; returns the raw readings."""
    torch = env.torch
    from repro_torch.core.accelerator import clear_cache, get_accelerator
    from repro_torch.core.policy import ExecutionPolicy

    traffic = data.traffic
    params = program_params(torch, pcfg, weights, env.device)
    accel = get_accelerator(pcfg, ExecutionPolicy(quant=quant), device=env.device)
    data.phase("the program's weights and accelerator")

    def infer(batch):
        out = accel.infer(params, batch)
        return out if fault is None else fault(out)

    infer(pool[0]).cpu()  # builds the kernels, runs eagerly, captures the graph
    data.phase("the first batch (kernel build, eager forward, capture)")
    for i in range(1, traffic["warm_batches"]):
        infer(pool[i % len(pool)]).cpu()
    _sync(env)
    data.phase("warm replays")

    keep = Reservoir(traffic["check_batches"], generator.rng_for(seed, generator.STREAM_CHECK))
    spans = data.spans
    state = {"i": 0}

    def one():
        i = state["i"]
        j = i % len(pool)
        t0 = time.monotonic()
        logits = infer(pool[j])
        t1 = time.monotonic()
        host = logits.cpu().numpy()
        t2 = time.monotonic()
        spans.append(("bench: infer (copy in, replay)", t0, t1))
        spans.append(("bench: read back the logits", t1, t2))
        keep.offer((j, host))
        state["i"] = i + 1
        return j

    sampler = env.power() if env.power is not None else None
    result: dict = {}
    watch = GcWatch()
    gc.collect()
    gc.freeze()  # set-up's objects: the window's collections scan what the window made
    if sampler is not None:
        sampler.__enter__()
    watch.__enter__()
    try:
        wall0 = time.time()
        start = time.monotonic()
        result["window_start"] = start
        deadline = start + data.seconds
        profile_at = start + min(traffic["profile_start_s"], 0.3 * data.seconds)
        profile_s = min(traffic["profile_s"], 0.3 * data.seconds)
        tries = PROFILE_TRIES if trace else 0
        while time.monotonic() < deadline:
            if tries and time.monotonic() >= profile_at:
                tries -= 1
                units, marks = [], []
                stop = time.monotonic() + profile_s

                def body():
                    one()  # left out: a session's first replay can lose records
                    marks.append(time.monotonic())
                    while time.monotonic() < stop:
                        units.append(one())
                    _sync(env)
                    return marks[0]

                stretch = devtrace.profile_stretch(torch, body, spans)
                if stretch_ok(stretch, data, len(units)):
                    data.stretch, data.stretch_pool, tries = stretch, units, 0
                continue
            one()
        end = time.monotonic()
        wall1 = time.time()
    finally:
        watch.__exit__()
        gc.unfreeze()
        if sampler is not None:
            sampler.__exit__(None, None, None)
    result["gc"] = watch.summary()
    data.window_s = end - start
    data.clouds = state["i"] * traffic["batch"]
    result["batches"] = state["i"]
    if sampler is not None:
        result["energy_j"], result["power_samples"] = sampler.energy_j(wall0, wall1)
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(env.device)
                                   if env.device.type == "cuda" else 0)
    # the program's state goes before the reference runs
    del params, accel, infer
    clear_cache()
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    gaps = []
    for j, host in keep.items:
        want = ref.forward(torch.as_tensor(pool[j], device=env.device), weights, data.cfg,
                           traffic["quant"]).cpu().numpy()
        gaps.extend(gap(host[c], want[c]) for c in range(host.shape[0]))
    result["logit_gap"] = max(gaps) if gaps else math.inf
    result["compared"] = len(gaps)
    result["missing"] = 0
    if trace and data.stretch is not None:
        data.preproc_least_s = {}
        for j in sorted(set(data.stretch_pool)):
            stages = ref.preprocess(torch.as_tensor(pool[j], device=env.device), data.cfg)
            data.preproc_least_s[j] = work.preproc_least_time(
                data.cfg, traffic["batch"], [s["scanned"] for s in stages])
    return result


def stretch_ok(stretch: devtrace.Stretch, data: RunData, units: int) -> bool:
    """Whether a profiled stretch holds every kernel launch its forwards made.

    (A session that lost device records would read a kernel's time short.)
    """
    if units == 0:
        return False
    names = {"fps": ("fps_warp_kernel", "fps_tiles_kernel"), "lattice": ("lattice_kernel",),
             "knn3": ("knn3_kernel",), "sc_matmul": ("sc_matmul_kernel", "sc_matmul_res_kernel")}
    if stretch.device_records == 0:
        return False
    for fam, per in data.launches.items():
        count, _ = stretch.kernel_time(names[fam])
        if count != per * units:
            print(f"bench: profiled stretch holds {count} {fam} launches, expected "
                  f"{per} x {units}; profiling again", file=sys.stderr, flush=True)
            return False
    return True


# -- the open loop through the serving runtime -------------------------------------------


def run_served(env: Env, data: RunData, pcfg, weights, clouds, seed, *, trace: bool,
               quant: str, fault=None, rate=None) -> dict:
    """Set up, measure and check an open-loop serving cell; returns the raw readings."""
    torch = env.torch
    from repro_torch.core.accelerator import clear_cache
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.serve.queue import AdmissionError
    from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
    from repro_torch.serve.trace import TraceConfig

    traffic = data.traffic
    due = generator.arrivals(traffic, seed, data.seconds, rate)
    order = generator.request_order(seed, len(due), len(clouds))
    n = len(due)
    params = program_params(torch, pcfg, weights, env.device)
    tracing = None
    if trace:  # the runtime's own spans, for the per-layer metrics; a ring the window fits in
        tracing = TraceConfig(capacity=TRACE_EVENTS_PER_REQUEST * (n + traffic["warm_requests"])
                              + 4096)
    rt = ServingRuntime(
        pcfg, params,
        RuntimeConfig(max_batch=traffic["batch"], max_wait_s=traffic["max_wait_s"],
                      max_queue=traffic["max_queue"], buckets=(traffic["bucket"],),
                      n_replicas=1, trace=tracing),
        policy=ExecutionPolicy(quant=quant), device=env.device)
    del params  # each replica holds its own copy
    if fault is not None:
        fault(rt)
    batches = watch_batches(rt)
    done_t = [math.nan] * n
    answers: list = [None] * n
    failed = [False] * n
    lock = threading.Lock()
    result: dict = {}
    data.phase("the runtime")
    try:
        rt.start()
        rt.warmup()
        data.phase("the runtime's warm-up (kernel build, eager forward, capture)")
        warm = [rt.submit(clouds[i % len(clouds)]) for i in range(traffic["warm_requests"])]
        for f in warm:
            f.result(timeout=LATE_WAIT_S)
        data.phase("warm requests")
        time.sleep(0.05)  # the warm batches' last trace edges and records land
        if rt.tracer is not None:
            rt.tracer.clear()
            emitted_before = rt.tracer.emitted
        records_before = len(rt.metrics.batch_records)
        batches.clear()

        def stamp(i, fut):
            t = time.monotonic()
            with lock:
                done_t[i] = t
            if fut.exception() is not None:
                failed[i] = True
            else:
                answers[i] = fut.result()

        futures = [None] * n
        state = {"next": 0}
        lateness = []

        def send_until(t_end):
            while state["next"] < n and start + due[state["next"]] < t_end:
                i = state["next"]
                target = start + due[i]
                wait = target - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                lateness.append(time.monotonic() - target)
                try:
                    fut = rt.submit(clouds[order[i]])
                except AdmissionError:
                    failed[i] = True
                    done_t[i] = math.inf
                else:
                    futures[i] = fut
                    fut.add_done_callback(lambda f, i=i: stamp(i, f))
                state["next"] = i + 1

        watch = GcWatch()
        gc.collect()
        gc.freeze()  # set-up's objects: the window's collections scan what the window made
        start = time.monotonic() + 0.01
        result["window_start"] = start
        end = start + data.seconds
        with watch:
            if trace:  # the stretch closes the window: the profiler's start stalls the host
                profile_s = min(traffic["profile_s"], 0.3 * data.seconds)
                send_until(end - min(0.5, 0.1 * data.seconds) - profile_s)
                data.quiet_until = time.monotonic()

                def body():
                    stop = time.monotonic() + profile_s
                    send_until(stop)
                    wait = stop - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)
                    _sync(env)

                data.stretch = devtrace.profile_stretch(torch, body, data.spans)
            send_until(end)
            wait = end - time.monotonic()
            if wait > 0:
                time.sleep(wait)
        gc.unfreeze()
        result["gc"] = watch.summary()
        at_close = sum(1 for i in range(n) if not (done_t[i] <= end))
        result["backlog_at_close"] = at_close
        limit = time.monotonic() + LATE_WAIT_S
        for fut in futures:
            if fut is not None:
                try:
                    fut.exception(timeout=max(0.0, limit - time.monotonic()))
                except TimeoutError:
                    pass
        result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(env.device)
                                       if env.device.type == "cuda" else 0)
        if rt.tracer is not None:
            data.events = rt.tracer.events()
            dropped = rt.tracer.emitted - emitted_before - len(data.events)
            if dropped > 0:  # the ring is sized for the window: a loss is a fault
                raise BenchError(f"the serving trace dropped {dropped} events")
        data.batch_records = list(rt.metrics.batch_records[records_before:])
    finally:
        gc.unfreeze()
        rt.stop()
        del rt
        clear_cache()
        gc.collect()
        if env.device.type == "cuda":
            torch.cuda.empty_cache()
    gave_up = time.monotonic()
    with lock:  # an answer that never came counts as the whole wait for it
        lat = [(min(t, gave_up) if t == t else gave_up) - (start + d)
               for t, d in zip(done_t, due)]
    data.window_s = data.seconds
    ok = [i for i in range(n) if answers[i] is not None and not failed[i]]
    data.clouds = len(ok)
    result["requests"] = n
    result["latencies_s"] = lat
    result["lateness_s"] = lateness
    result["missing"] = n - len(ok)
    index = {id(f): i for i, f in enumerate(futures) if f is not None}
    members = [([index[id(f)] for f in futs], bucket) for futs, bucket in batches
               if all(id(f) in index for f in futs)]
    result["logit_gap"], result["compared"] = check_served(env, data, weights, clouds, order,
                                                           answers, members, seed)
    return result


def watch_batches(rt) -> list:
    """The micro-batches a runtime's scheduler hands to its replica pool, as they go.

    Wraps the scheduler's call into the pool (the boundary between two of
    the program's layers) and records each batch's requests' futures and
    bucket, then makes the call unchanged: under SC an answer is checked
    against its batch partners, whose list the runtime keeps only in its
    (optional) trace.
    """
    seen: list = []
    dispatch = rt.scheduler.dispatch_fn

    def observed(mb):
        seen.append((tuple(r.future for r in mb.requests), mb.bucket))
        return dispatch(mb)

    rt.scheduler.dispatch_fn = observed
    return seen


def check_served(env: Env, data: RunData, weights, clouds, order, answers, batches,
                 seed) -> tuple:
    """(widest gap, answers compared) over a seeded sample of the window's batches.

    The sample holds the batches of the window's largest and smallest
    clouds, and further batches drawn from the seed until it holds
    `check_batches` batches and `check_min_answers` answers.  Each batch is
    assembled again as the runtime's contract says (each cloud fitted to the
    bucket, zero rows to `batch`), run through the reference, and each
    member's answer compared with its rows.
    """
    torch = env.torch
    traffic = data.traffic
    batches = [b for b in batches if all(answers[i] is not None for i in b[0])]
    if not batches:
        return math.inf, 0
    sizes = [max(clouds[order[i]].shape[0] for i in m) for m, _ in batches]
    small = [min(clouds[order[i]].shape[0] for i in m) for m, _ in batches]
    first = [int(np.argmax(sizes)), int(np.argmin(small))]
    order_rng = generator.rng_for(seed, generator.STREAM_CHECK)
    rest = [int(k) for k in order_rng.permutation(len(batches))]
    pick, answers_due = [], 0
    for k in dict.fromkeys(first + rest):  # the two, then the rest in a seeded order
        if len(pick) >= traffic["check_batches"] and answers_due >= traffic["check_min_answers"]:
            break
        pick.append(k)
        answers_due += len(batches[k][0])
    worst, compared = 0.0, 0
    for k in sorted(pick):
        members, bucket = batches[k]
        rows = np.zeros((traffic["batch"], bucket, 3), np.float32)
        for r, i in enumerate(members):
            rows[r] = ref.fit_cloud(clouds[order[i]], bucket)
        want = ref.forward(torch.as_tensor(rows, device=env.device), weights, data.cfg,
                           traffic["quant"]).cpu().numpy()
        for r, i in enumerate(members):
            n = clouds[order[i]].shape[0]
            worst = max(worst, gap(np.asarray(answers[i]), ref.back_to_points(want[r], n, bucket)))
            compared += 1
    return worst, compared


# -- one run ---------------------------------------------------------------------------


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, env: Env,
             root: pathlib.Path = ROOT, quant: str | None = None, tf32: bool = False,
             fault=None, rate=None, t_process: float | None = None) -> dict:
    """One run of `cell`: the contract's result dict, with the compared numbers under "checks".

    `quant` and `tf32` run the program under another precision than the
    mix states (the control); `fault` breaks the timed path (the check's own
    tests); `rate` overrides an open loop's mean rate (the knee sweep).
    """
    t_process = time.monotonic() if t_process is None else t_process
    torch = env.torch
    bench = load_benchmark(root)
    entry = named(bench["workloads"], cell, "cell")
    cfg = load_config(root, bench, entry["config"])
    traffic = load_traffic(root, entry["traffic"])
    run_quant = quant or traffic["quant"]
    data = RunData(cell=cell, cfg=cfg, traffic=traffic, quant=run_quant, seconds=seconds)
    data.launches = work.launches_per_forward(cfg, run_quant)
    data.phase("start")
    import repro_torch.core.accelerator  # noqa: F401  (the program's entry point)
    data.phase("the program's modules imported")
    pcfg = program_config(cfg)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    weights = make_weights(torch, cfg, seed, env.device)
    data.phase("weights on the device")
    if trace:
        devtrace.warm_profiler(torch)
        data.phase("the profiler's first session")
    loop = traffic["loop"]
    if loop == "closed":
        pool = generator.batch_pool(traffic, seed, cfg["n_points"])
        data.phase("the clouds")
        raw = run_batches(env, data, pcfg, weights, pool, seed, trace=trace, quant=run_quant,
                          fault=fault)
    elif loop == "open":
        clouds = generator.served_pool(traffic, seed)
        data.phase("the clouds")
        raw = run_served(env, data, pcfg, weights, clouds, seed, trace=trace, quant=run_quant,
                         fault=fault, rate=rate)
    else:
        raise BenchError(f"traffic {entry['traffic']!r}: unknown loop {loop!r}")
    setup_s = raw["window_start"] - t_process
    limits = traffic["limits"]
    checks = {"logit_gap": {"value": raw["logit_gap"], "limit": limits["logit_gap"]},
              "missing": {"value": raw["missing"], "limit": 0},
              "compared": {"value": raw["compared"], "limit": traffic["check_min_answers"]}}
    correct = (raw["logit_gap"] <= limits["logit_gap"] and raw["missing"] == 0
               and raw["compared"] >= traffic["check_min_answers"])
    values = end_to_end_values(data, raw, setup_s)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        if trace:
            value = load_metric(root, m["name"]).read(data)
        else:
            value = values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = raw.get("requests", raw.get("batches", 0) * traffic.get("batch", 1))
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(raw["missing"]),
           "metrics": metrics,
           "device": {"platform": env.platform, "kind": env.kind, "count": 1,
                      "memory_peak_bytes": int(raw["memory_peak_bytes"])}}
    if trace and data.stretch is not None:
        out["device"]["busy_s"] = data.stretch.busy_s
        out["device"]["window_s"] = data.stretch.window_s
        out["breakdown"] = {"device_ops": data.stretch.top_ops(),
                            "idle_gaps": data.stretch.top_gaps()}
    raw["phases"] = [(label, t - t_process) for label, t in data.phases]
    raw["phases"].append(("the window opens", raw["window_start"] - t_process))
    out["raw"] = raw
    out["checks"] = checks
    return out


def result_line(out: dict) -> tuple[str, dict]:
    """(the result's JSON line, the run's raw readings): `out` without "raw", "checks" last."""
    out = dict(out)
    raw = out.pop("raw")
    checks = out.pop("checks")
    out["checks"] = checks
    return json.dumps(out), raw


def end_to_end_values(data: RunData, raw: dict, setup_s: float) -> dict:
    """Every end-to-end metric a run can give, by name."""
    vals = {"setup_s": setup_s}
    if data.traffic["loop"] == "closed":
        vals["clouds_per_s"] = data.clouds / data.window_s
        if "energy_j" in raw and data.clouds:
            vals["mj_per_cloud"] = raw["energy_j"] * 1e3 / data.clouds
    else:
        lat = raw["latencies_s"]
        if lat:
            vals["latency_p95_ms"] = percentile(lat, 95) * 1e3
    return vals


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def loaded_forbidden() -> list[str]:
    """Modules of this process whose top-level name is jax, jaxlib, flax or repro."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})
