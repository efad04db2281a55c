"""SLO control plane demo on the PyTorch port: two classes under overload + a mid-run kill.

    PYTHONPATH=src python examples/torch_serve_slo.py --device cpu
    PYTHONPATH=src python examples/torch_serve_slo.py --device cpu --requests 300 --no-kill
    PYTHONPATH=src python examples/torch_serve_slo.py                  # two replicas on the card

The port's counterpart of examples/serve_slo.py.  It offers a mixed trace
(one third non-sheddable "interactive" requests with a deadline, two
thirds sheddable "bulk") well above what the runtime can sustain, so the
control plane has to choose: interactive requests jump the queue
(priority, then earliest deadline first) while bulk absorbs all the load
shedding (`Shed` at submit time once the backlog crosses
`shed_threshold`).  Halfway through, the chaos injector kills replica 1;
the autoscaler notices the dead slot and rejoins it warm (params copied
again, every bucket x policy graph captured again on the card) while
traffic keeps flowing on the survivor.  --no-kill skips the kill.

Both replicas run on one device: the CPU with --device cpu (the smoke
config, the kernels' plain versions), else the card (the full config;
raises where there is none).  The last line is its check: interactive
shed == 0 and, unless --no-kill, a rejoin in the autoscaler's log, or it
exits 1.
"""

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.device import resolve_device
from repro_torch.serve import (
    BULK,
    INTERACTIVE,
    AutoscalerConfig,
    ChaosInjector,
    Fault,
    RuntimeConfig,
    ServingRuntime,
    Shed,
    SLOClass,
)

REJOIN_WAIT_S = 15.0  # how long the pool is held open for the rejoin to land


def main(argv=None) -> dict:
    """Run the overload demo; returns the shed counts, the snapshot and the autoscaler's log."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=240)
    ap.add_argument("--no-kill", action="store_true",
                    help="skip the chaos kill / rejoin half of the demo")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' serves the smoke config")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("pointnet2-cls", smoke=device.type == "cpu")
    params = get_accelerator(cfg, device=device).init(torch.Generator().manual_seed(0))
    # a relaxed interactive class for a shared demo host: same priority and
    # shed exemption as serve.INTERACTIVE, roomier deadline
    interactive = SLOClass(
        "interactive",
        priority=INTERACTIVE.priority,
        deadline_s=5.0,
        sheddable=False,
        max_wait_s=0.002,
    )
    rt = ServingRuntime(cfg, params, RuntimeConfig(
        max_batch=4,
        max_wait_s=0.01,
        max_queue=max(64, args.requests // 2),
        n_replicas=2,
        shed_threshold=24,  # backlog past this sheds BULK, never interactive
        autoscaler=AutoscalerConfig(  # rejoin-only: no depth-driven scaling
            poll_interval_s=0.02, rejoin_delay_s=0.1,
            scale_up_depth=1e9, scale_down_ticks=10**9,
        ),
    ), device=device)
    print(rt)
    print("warming up (one graph capture per bucket x policy x replica on the card)...")
    rt.warmup()
    if not args.no_kill:
        chaos = ChaosInjector([Fault(replica_id=1, at_batch=5, kind="kill")])
        chaos.attach(rt.pool)

    rng = np.random.default_rng(0)
    clouds = [rng.standard_normal((cfg.n_points, 3)).astype(np.float32)
              for _ in range(8)]
    futs, shed = [], {"interactive": 0, "bulk": 0}
    t0 = time.perf_counter()
    with rt:
        for i in range(args.requests):
            slo = interactive if i % 3 == 0 else BULK
            try:
                futs.append(rt.submit(clouds[i % len(clouds)], slo=slo))
            except Shed:
                shed[slo.name] += 1
        for f in futs:
            try:
                f.result(timeout=300)
            except Exception:  # noqa: BLE001 — expired under overload
                pass
        if not args.no_kill:  # hold the pool open until the rejoin lands
            deadline = time.perf_counter() + REJOIN_WAIT_S
            while rt.metrics.rejoins < 1 and time.perf_counter() < deadline:
                time.sleep(0.02)
    wall = time.perf_counter() - t0

    snap = rt.metrics.snapshot()
    print(f"\noffered {args.requests} requests in {wall:.2f}s "
          f"(shed at submit: {shed})")
    print("aggregate:", snap.format_row())
    print("per-class breakdown:")
    for line in snap.format_class_rows().splitlines():
        print(" ", line)
    events = list(rt.autoscaler.events)
    if not args.no_kill:
        print("autoscaler log:")
        for ev in events:
            print(f"  t+{ev.t - t0:5.2f}s {ev.action:<8} replica {ev.replica_id}"
                  f" (queue depth {ev.depth:.1f})")

    cls_snap = snap.for_class("interactive")
    interactive_shed = shed["interactive"] + (cls_snap.shed if cls_snap else 0)
    rejoined = any(ev.action == "rejoin" for ev in events)
    ok = interactive_shed == 0 and (args.no_kill or rejoined)
    print(f"check: interactive shed {interactive_shed} == 0"
          + ("" if args.no_kill else f", rejoin in the autoscaler log: {rejoined}")
          + f": {'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit(1)
    return {"shed": shed, "snapshot": snap, "events": events, "wall_s": wall}


if __name__ == "__main__":
    main()
