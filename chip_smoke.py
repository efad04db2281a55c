#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit code if it fails:

  1. print the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from src/repro_torch/csrc with nvcc for
     sm_90a, one nvcc per source, all at once;
  3. drive one full-width pointnet2-cls forward (8 clouds of 1024 points,
     quant="sc_w16a16") while recording every kernel call's inputs, then
     hold each kernel against its plain PyTorch version on those inputs on
     the card (bitwise), and time kernel, plain version and, for the SC
     matmul, one float64 torch.matmul of the same operands: the card's busy
     time a call from torch.profiler, and the time between CUDA events
     around back-to-back calls, which includes the host's enqueue time;
  4. the main path: with every launch counter at 0, run
     get_accelerator(CONFIG, policy).infer on a few batches of 8 clouds for
     quant="none" and quant="sc_w16a16"; check that each forward launched
     2 FPS, 2 lattice and (under SC) 12 SC-matmul kernels; time a forward
     per batch under both policies, and profile one (device time by
     kernel, and the device's idle share);
  5. check the outputs against the port's own CPU run (plain versions):
     preprocessing bitwise, logits finite, of shape (8, 8) and within the
     stated tolerance.

Then it prints one JSON line with every kernel's launches, error and times,
the card line again, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Inputs and weights come from numpy / torch generators seeded with SEED;
neither jax nor the JAX package is imported.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 8
N_BATCHES = 3
TIMED_FORWARDS = 10
# Logit tolerance card vs CPU.  Float: cuBLAS and the CPU BLAS sum the
# matmuls in different orders (~1e-7 relative per layer).  SC: the integer
# products are exact, but a float difference upstream can move an
# activation across a rounding boundary of the 16-bit quantizer, one
# quantum (max|x| / 32767) at a time.
LOGIT_ATOL = {"none": 1e-4, "sc_w16a16": 2e-3}

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12
PEAK_INT8_OPS = 1979e12

KERNELS = {
    "fps_tiles": {
        "source": "src/repro_torch/csrc/fps.cu",
        "replaces": "src/repro/kernels/fps/kernel.py:66",
    },
    "lattice_tiles": {
        "source": "src/repro_torch/csrc/lattice.cu",
        "replaces": "src/repro/kernels/lattice/kernel.py:50",
    },
    "sc_matmul": {
        "source": "src/repro_torch/csrc/sc_matmul.cu",
        "replaces": "src/repro/kernels/sc_matmul/kernel.py:89",
    },
}


def fail(msg: str) -> None:
    """Report a failed phase on stderr and exit with code 1."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    """Print one line of the report."""
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def make_clouds(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """(b, n, 3) float32 clouds: surfaces, blobs and grid-snapped copies (ties)."""
    clouds = []
    for i in range(b):
        kind = i % 4
        if kind == 0:  # sphere surface
            v = rng.normal(size=(n, 3))
            c = v / np.linalg.norm(v, axis=1, keepdims=True)
        elif kind == 1:  # cube surface
            c = rng.uniform(-1, 1, (n, 3))
            face = rng.integers(0, 3, n)
            c[np.arange(n), face] = np.sign(c[np.arange(n), face])
        elif kind == 2:  # gaussian blobs
            centers = rng.uniform(-0.7, 0.7, (4, 3))
            c = centers[rng.integers(0, 4, n)] + 0.15 * rng.normal(size=(n, 3))
        else:  # uniform in the cube, snapped to a coarse grid: many ties
            c = np.round(rng.uniform(-1, 1, (n, 3)) * 8) / 8
        if i % 3 == 2:  # snap some of the others too
            c = np.round(c * 16) / 16
        clouds.append(c)
    return np.stack(clouds).astype(np.float32)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean time of fn() from CUDA events around `reps` back-to-back calls.

    When the host takes longer to enqueue a call than the card to run it,
    this is the host's enqueue time, not the card's.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(torch, fn) -> dict[str, list]:
    """{name: [count, ms]} of the device work one fn() call enqueues (torch.profiler).

    fn runs once unprofiled first, to warm up.  Durations are the card's
    own (CUPTI), so the host's time to enqueue the work is left out.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(evt.name, [0, 0.0])
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us() / 1e3
    return by_name


def device_ms(torch, fn, reps: int) -> float:
    """Device time of one fn() call: the card's busy time over `reps` calls, divided by reps."""
    by_name = device_kernels(torch, lambda: [fn() for _ in range(reps)])
    if not by_name:
        fail("torch.profiler recorded no device activity: kernel times not measured")
    return sum(ms for _, ms in by_name.values()) / reps


def bound(name: str, args, kw, plain_out) -> tuple[float, float, float]:
    """(bytes, operations, peak operation rate) the call's work needs."""
    if name == "fps_tiles":
        pts, k = args
        t, p, _ = pts.shape
        nbytes = t * p * 3 * 4 + t * k * 4
        ops = 10 * t * p * (k - 1)  # 3 sub, 3 abs, 2 add, min, compare a point a step
        return nbytes, ops, PEAK_F32_OPS
    if name == "lattice_tiles":
        coords, cents = args
        t, p, _ = coords.shape
        kk = cents.shape[1]
        ns = kw["nsample"]
        idx, mask = plain_out
        # the walk stops once a row is full: count the points each row scans
        scanned = np.where(
            mask[..., -1].cpu().numpy(), idx[..., -1].cpu().numpy() + 1, p
        ).astype(np.int64)
        nbytes = t * kk * 3 * 4 + t * p * 3 * 4 + t * kk * ns * (4 + 1)
        ops = 9 * int(scanned.sum())  # 3 sub, 3 abs, 2 add, compare
        return nbytes, ops, PEAK_F32_OPS
    x, w = args
    m, k = x.shape
    n = w.shape[1]
    planes = kw["n_planes"]
    nbytes = (m * k + k * n + m * n) * 4
    ops = 2 * m * k * n * planes * planes  # int8 plane-pair MACs
    return nbytes, ops, PEAK_INT8_OPS


def profile_forward(torch, accel, params, batch, wall_ms: float) -> dict:
    """Device time of one forward by kernel name, from torch.profiler's CUDA events.

    busy_ms sums the kernels' durations (one stream, so they do not
    overlap); idle_share compares it with the unprofiled forward's median
    wall time.
    """
    by_name = device_kernels(torch, lambda: accel.infer(params, batch))
    if not by_name:
        return {"device_time": "not measured (the profiler recorded no CUDA events)"}
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "kernels_launched": sum(n for n, _ in by_name.values()),
        "busy_ms": busy_ms, "wall_ms": wall_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "top": [{"name": name[:80], "count": n, "ms": ms} for name, (n, ms) in top],
    }


def main() -> None:
    """Run every phase; any failure exits non-zero before the last line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"src/repro_torch not found next to {os.path.basename(__file__)}")
    sys.path.insert(0, os.path.join(ROOT, "src"))

    from repro_torch.configs.pointnet2_cls import CONFIG
    from repro_torch.core.accelerator import get_accelerator
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.kernels import build, registry
    from repro_torch.kernels.fps import ops as _fps_ops  # noqa: F401  (registers)
    from repro_torch.kernels.lattice import ops as _lattice_ops  # noqa: F401
    from repro_torch.kernels.sc_matmul import ops as _sc_ops  # noqa: F401

    for mod in sys.modules:
        if mod == "jax" or mod.startswith(("jax.", "repro.")) or mod == "repro":
            fail(f"{mod} was imported; the port must not import jax or the JAX package")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(card)
    kind = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build()
    say(f"built {len(libs)} kernel libraries with {build.nvcc_path()} "
        f"({' '.join(build.NVCC_FLAGS)}) in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        say(f"  {name}: {os.path.relpath(path, ROOT)}")
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"    {line.strip()}")

    rng = np.random.default_rng(SEED)
    batches = [make_clouds(rng, BATCH, CONFIG.n_points) for _ in range(N_BATCHES)]
    sc = ExecutionPolicy(quant="sc_w16a16")
    policies = {"none": ExecutionPolicy(quant="none"), "sc_w16a16": sc}
    n_linears = (
        sum(len(sa.mlp) for sa in CONFIG.sa) + len(CONFIG.global_mlp) + len(CONFIG.head) + 1
    )

    # -- 3. kernels against their plain versions, at main-path shapes --------
    accel_sc = get_accelerator(CONFIG, sc, device="cuda")
    params = accel_sc.init(torch.Generator().manual_seed(SEED))
    calls = {name: [] for name in KERNELS}
    specs = {name: registry.get(name) for name in KERNELS}

    def recorder(name, spec):
        def record(*args, **kw):
            calls[name].append(([a.clone() if torch.is_tensor(a) else a for a in args], dict(kw)))
            return spec.cuda(*args, **kw)
        return record

    try:
        for name, spec in specs.items():
            registry.register(name, plain=spec.plain, cuda=recorder(name, spec))
        accel_sc.infer(params, batches[0])
        torch.cuda.synchronize()
    finally:
        for name, spec in specs.items():
            registry.register(name, plain=spec.plain, cuda=spec.cuda)
    say("main-path kernel calls of one sc_w16a16 forward: "
        + ", ".join(f"{n}={len(c)}" for n, c in calls.items()))

    per_call = []
    summary = {}
    for name, spec in specs.items():
        if not calls[name]:
            fail(f"the main path made no {name} call")
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
               "ops_ms": 0.0, "library_ms": 0.0 if name == "sc_matmul" else None}
        max_err = 0.0
        for args, kw in calls[name]:
            got = spec.cuda(*args, **kw)
            want = spec.plain(*args, **kw)
            torch.cuda.synchronize()
            got_t = got if isinstance(got, tuple) else (got,)
            want_t = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got_t, want_t):
                err = (g.to(torch.float64) - w.to(torch.float64)).abs().max().item()
                max_err = max(max_err, err)
                if not torch.equal(g, w):
                    fail(f"{name} at {[tuple(a.shape) for a in args if torch.is_tensor(a)]}: "
                         f"kernel differs from its plain version (max |diff| {err})")
            # ms / plain_ms / library_ms: the card's busy time a call (profiler);
            # *_enqueue_ms: CUDA events around back-to-back calls, which is the
            # host's enqueue time wherever that exceeds the card's.
            kernel_fn = functools.partial(spec.cuda, *args, **kw)
            plain_fn = functools.partial(spec.plain, *args, **kw)
            ms = device_ms(torch, kernel_fn, reps=50)
            plain_ms = device_ms(torch, plain_fn, reps=5)
            nbytes, ops, peak = bound(name, args, kw, want)
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = ops / peak * 1e3
            row = {"kernel": name, "shapes": [list(a.shape) for a in args if torch.is_tensor(a)],
                   "kw": {k: v for k, v in kw.items()}, "ms": ms, "plain_ms": plain_ms,
                   "enqueue_ms": cuda_ms(torch, kernel_fn, reps=50),
                   "plain_enqueue_ms": cuda_ms(torch, plain_fn, reps=5, warmup=1),
                   "bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            if name == "sc_matmul":
                xd, wd = args[0].to(torch.float64), args[1].to(torch.float64)
                library_fn = functools.partial(torch.matmul, xd, wd)
                row["library_ms"] = device_ms(torch, library_fn, reps=20)
                row["library_enqueue_ms"] = cuda_ms(torch, library_fn, reps=20)
                tot["library_ms"] += row["library_ms"]
            per_call.append(row)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += row["bound_ms"]
            tot["bytes_ms"] += bytes_ms
            tot["ops_ms"] += ops_ms
        tot["max_abs_err"] = max_err
        summary[name] = tot
        say(f"{name}: {len(calls[name])} main-path calls, kernel == plain version bitwise; "
            f"per forward, device time: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.6f} ms")
    say(json.dumps({"kernel_calls": per_call}))

    # -- 4. the main path, counted -------------------------------------------
    accels = {q: get_accelerator(CONFIG, pol, device="cuda") for q, pol in policies.items()}
    logits_gpu = {}
    deltas = {}
    registry.reset_launches()
    for q, accel in accels.items():
        before = registry.launches()
        logits_gpu[q] = [accel.infer(params, b) for b in batches]
        torch.cuda.synchronize()
        after = registry.launches()
        deltas[q] = {n: after[n] - before[n] for n in KERNELS}
    launches = registry.launches()
    say(f"main path launches: {json.dumps(deltas)}")
    for q, delta in deltas.items():
        want = {"fps_tiles": 2 * N_BATCHES, "lattice_tiles": 2 * N_BATCHES,
                "sc_matmul": n_linears * N_BATCHES if q != "none" else 0}
        if delta != want:
            fail(f"quant={q}: launches {delta}, expected {want} for {N_BATCHES} forwards")
    for name in KERNELS:
        if launches[name] == 0:
            fail(f"{name} was never launched on the main path")

    forward_ms = {}
    for q, accel in accels.items():
        times = []
        for i in range(TIMED_FORWARDS + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            accel.infer(params, batches[i % N_BATCHES])
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        forward_ms[q] = {"median_ms": float(np.median(times)), "min_ms": float(np.min(times)),
                         "max_ms": float(np.max(times)), "runs": len(times)}
    say(json.dumps({"forward_per_batch": {"batch": BATCH, "n_points": CONFIG.n_points,
                                          **forward_ms}}))
    say(json.dumps({"forward_profile": {
        q: profile_forward(torch, accel, params, batches[0], forward_ms[q]["median_ms"])
        for q, accel in accels.items()
    }}))

    # -- 5. against the port's own CPU run -------------------------------------
    params_cpu = accel_sc.init(torch.Generator().manual_seed(SEED)).to("cpu")
    for q, pol in policies.items():
        accel_cpu = get_accelerator(CONFIG, pol, device="cpu")
        worst = 0.0
        for b, got in zip(batches, logits_gpu[q]):
            pre_gpu = accels[q].preprocess_stage(b)
            pre_cpu = accel_cpu.preprocess_stage(b)
            for stage, (rg, rc) in enumerate(zip(pre_gpu, pre_cpu)):
                for field in ("centroid_idx", "centroid_xyz"):
                    if not torch.equal(getattr(rg, field).cpu(), getattr(rc, field)):
                        fail(f"quant={q} stage {stage}: {field} differs from the CPU run")
                if not (torch.equal(rg.neighbors.idx.cpu(), rc.neighbors.idx)
                        and torch.equal(rg.neighbors.mask.cpu(), rc.neighbors.mask)):
                    fail(f"quant={q} stage {stage}: neighbours differ from the CPU run")
            want = accel_cpu.infer(params_cpu, b)
            got = got.cpu()
            if got.shape != (BATCH, CONFIG.n_classes) or not torch.isfinite(got).all():
                fail(f"quant={q}: logits of shape {tuple(got.shape)}, finite={bool(torch.isfinite(got).all())}")
            worst = max(worst, (got - want).abs().max().item())
        if worst > LOGIT_ATOL[q]:
            fail(f"quant={q}: logits differ from the CPU run by {worst} > {LOGIT_ATOL[q]}")
        say(f"quant={q}: preprocessing equals the CPU run bitwise; max |logit diff| "
            f"{worst:.3e} <= {LOGIT_ATOL[q]}")

    kernels = []
    for name, meta in KERNELS.items():
        tot = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
            "library_ms": tot["library_ms"],
        })
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
