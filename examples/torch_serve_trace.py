"""Request-lifecycle tracing demo on the PyTorch port: trace a serve run, export for Perfetto.

    PYTHONPATH=src python examples/torch_serve_trace.py --device cpu
    PYTHONPATH=src python examples/torch_serve_trace.py --device cpu --requests 96 --out my.json
    PYTHONPATH=src python examples/torch_serve_trace.py                       # on the card

The port's counterpart of examples/serve_trace.py.  It runs a traced
`ServingRuntime` (TraceConfig attached, a periodic Reporter printing one
metrics line an interval to stderr) over a small open-loop trace of
mixed-size clouds, then shows every consumer of the trace stream:

  * the per-SLO-class stage breakdown (`stage_breakdown(...).format_rows()`):
    p50/p95 of where each request's latency went, queue wait through the
    execute stage;
  * the batch cross-check (`batch_crosscheck`) tying batch-span durations
    back to the `BatchRecord` totals the metrics layer recorded;
  * the graph layer's spans (`graph_medians`): on the
    card each replica's replays run inside `graphs.traced`, so every
    replay's lookup, wait, copy-in, launch and clone on the host, and the card's
    own time for preprocessing and for the feature stage, are printed as
    medians a stage, with the count of stage times missed
    (`graphs.stage_times_missed`; the CPU runs the stages eagerly and has
    none);
  * a Chrome-trace JSON written by `write_chrome_trace` to --out (under
    build/ by default): open it at https://ui.perfetto.dev (or
    chrome://tracing) to see request spans, batch stage slices with the
    graph replays nested in them, the card's stage times and control-plane
    instants on one timeline;
  * the Prometheus text exposition of the final metrics snapshot.

With --device cpu it serves the reduced (smoke) config on the CPU, with
the kernels' plain versions; without --device it serves the full config
on every card and raises where there is none.  Cloud sizes scale with the
config's n_points (the JAX script's 160 / 256 / 320 at the smoke config's
256).  The last line is its check: `trace_problems` finds nothing and the
cross-check covers a batch (its worst rel_err printed), or it exits 1.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import graphs
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.device import resolve_device
from repro_torch.serve import (
    RuntimeConfig,
    ServingRuntime,
    TraceConfig,
    batch_crosscheck,
    graph_medians,
    prometheus_text,
    request_timelines,
    stage_breakdown,
    trace_problems,
    write_chrome_trace,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "pc2im_trace.json")


def main(argv=None) -> dict:
    """Serve the traced run; returns the trace problems, the cross-check and the output path."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--rate", type=float, default=150.0,
                    help="open-loop arrival rate, requests/s")
    ap.add_argument("--out", default=OUT,
                    help="Chrome-trace JSON output path (load in Perfetto)")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' serves the smoke config")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("pointnet2-cls", smoke=device.type == "cpu")
    n = cfg.n_points
    params = get_accelerator(cfg, device=device).init(torch.Generator().manual_seed(0))
    rt = ServingRuntime(cfg, params, RuntimeConfig(
        max_batch=4,
        max_wait_s=0.01,
        max_queue=max(64, args.requests),
        trace=TraceConfig(sample=1.0),  # trace every request
        report_interval_s=0.5,          # Reporter prints to stderr
    ), device=device if device.type == "cpu" else None)
    print(rt)
    print("warming up (one graph capture per bucket x policy on the card)...")
    rt.warmup()

    rng = np.random.default_rng(0)
    clouds = [rng.standard_normal((k, 3)).astype(np.float32)
              for k in (n * 160 // 256, n, n * 5 // 4)]
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests))
    futs = []
    t0 = time.perf_counter()
    with rt:
        for i in range(args.requests):
            time.sleep(max(0.0, t0 + arrivals[i] - time.perf_counter()))
            futs.append(rt.submit(clouds[i % len(clouds)]))
        for f in futs:
            f.result(timeout=300)
        deadline = time.monotonic() + 60  # a batch is recorded just after its responses
        while (sum(b.n_real for b in rt.metrics.batch_records) < args.requests
               and time.monotonic() < deadline):
            time.sleep(0.005)
    wall = time.perf_counter() - t0

    events = rt.tracer.events()
    problems = trace_problems(events)
    timelines = request_timelines(events)
    print(f"\nserved {args.requests} requests in {wall:.2f}s — "
          f"{len(events)} trace events ({rt.tracer.dropped} dropped), "
          f"{len(timelines)} request spans, "
          f"{len(problems)} malformed")

    print("\nper-class stage breakdown (p50/p95 seconds per stage):")
    for line in stage_breakdown(events).format_rows().splitlines():
        print(" ", line)

    checks = batch_crosscheck(events, rt.metrics.batch_records)
    worst = max(checks, key=lambda c: c.rel_err) if checks else None
    if worst is not None:
        print(f"\nbatch span vs BatchRecord cross-check: {len(checks)} batches,"
              f" worst rel_err {worst.rel_err:.1%} (batch {worst.batch_id})")

    replays = [ev.args["stage"] for ev in events if ev.name == "graph.replay_end"]
    if replays:
        print(f"\ngraph layer: {len(replays)} replays, {graphs.stage_times_missed()} stage "
              "times missed in this process; median host time of each part and the card's "
              "time of each marked stage:")
        for stage in sorted(set(replays)):
            for label, (ms, count) in graph_medians(events, stage).items():
                print(f"  {stage:<10} {label:<18} {ms:8.3f}ms  (n={count})")
    else:
        print("\ngraph layer: no replays (the stages run eagerly here)")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    n_events = write_chrome_trace(args.out, events)
    print(f"\nwrote {n_events} Chrome-trace events to {args.out} — "
          f"load it at https://ui.perfetto.dev")

    print("\nPrometheus exposition of the final snapshot:")
    for line in prometheus_text(rt.metrics.snapshot()).splitlines():
        print(" ", line)

    ok = not problems and worst is not None
    print(f"check: trace_problems empty ({len(problems)} found), cross-check over "
          f"{len(checks)} batches, worst rel_err "
          f"{worst.rel_err if worst is not None else float('nan'):.4f}: "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit(1)
    return {"problems": problems, "checks": checks, "out": args.out, "wall_s": wall,
            "chrome_events": n_events, "graph_replays": len(replays)}


if __name__ == "__main__":
    main()
