"""Serving-runtime quickstart on the PyTorch port: ragged traffic -> bucketed micro-batches.

    PYTHONPATH=src python examples/torch_serve_runtime.py --device cpu
    PYTHONPATH=src python examples/torch_serve_runtime.py --device cpu --requests 48 --replicas 2 \\
        --mix-quant
    PYTHONPATH=src python examples/torch_serve_runtime.py --mix-quant          # on the card

The port's counterpart of examples/serve_runtime.py.  It submits a stream
of mixed-size clouds (some padded up, some stride-subsampled down to a
bucket) through the whole queue -> scheduler -> replica-pool path,
optionally alternating float and SC W16A16 requests, then prints the
latency/throughput/occupancy snapshot and the executed micro-batches:
each one a single (bucket, policy) key, so one captured CUDA graph on the
card.

With --device cpu it serves the reduced (smoke) config on the CPU, with
the kernels' plain versions; without --device it serves the full config
on every card and raises where there is none.  Sizes and buckets scale
with the config's n_points (the JAX script's 150 / 256 / 320 clouds and
(192, 256) buckets at the smoke config's 256).  The last line is its
check: every response is bitwise equal to an eager `infer` of the padded
batch it rode in (read from the runtime's trace), or it exits 1.
"""

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.accelerator import cache_stats, get_accelerator
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.serve import (
    RuntimeConfig,
    ServingRuntime,
    TraceConfig,
    padded_batch_responses,
    served_batches,
)


def mismatches(rt, params, clouds, policies, outs) -> list[int]:
    """Indices of the responses that differ from an eager infer (`graphs.eager()`) of
    the padded batch they rode in (read from the runtime's trace), at its bucket
    and under its policy; a cloud missing from every batch counts as a mismatch."""
    batches = served_batches(rt.tracer.events())
    want = padded_batch_responses(rt.model_cfg, params, clouds, policies, batches,
                                  rt.config.max_batch)
    return [i for i in range(len(clouds)) if i not in want or not np.array_equal(outs[i], want[i])]


def main(argv=None) -> dict:
    """Serve the ragged stream; returns the metrics snapshot and the check's verdict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--mix-quant", action="store_true",
                    help="alternate fp32 / sc_w16a16 per request")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' serves the smoke config")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("pointnet2-cls", smoke=device.type == "cpu")
    n = cfg.n_points
    params = get_accelerator(cfg, device=device).init(torch.Generator().manual_seed(0))
    rt = ServingRuntime(
        cfg,
        params,
        RuntimeConfig(
            max_batch=args.max_batch,
            max_wait_s=0.01,
            buckets=(n * 3 // 4, n),
            n_replicas=args.replicas,
            trace=TraceConfig(),  # the check reads each batch's members from it
        ),
        device=device if device.type == "cpu" else None,
    )
    sc = ExecutionPolicy(quant="sc_w16a16")
    policies = [None, sc] if args.mix_quant else [None]
    print(rt)
    print("warming up (one graph capture per bucket x policy x replica on the card)...")
    rt.warmup(policies=tuple(policies))

    rng = np.random.default_rng(0)
    sizes = [n * 150 // 256, n, n * 5 // 4]  # pad / exact / subsample
    clouds = [rng.standard_normal((sizes[i % 3], 3)).astype(np.float32)
              for i in range(args.requests)]
    req_policies = [policies[i % len(policies)] for i in range(args.requests)]
    t0 = time.perf_counter()
    with rt:
        futs = [rt.submit(c, policy=p) for c, p in zip(clouds, req_policies)]
        outs = [f.result(timeout=300) for f in futs]
        deadline = time.monotonic() + 60  # a batch is recorded just after its responses
        while (sum(b.n_real for b in rt.metrics.batch_records) < len(outs)
               and time.monotonic() < deadline):
            time.sleep(0.005)
    wall = time.perf_counter() - t0

    snap = rt.metrics.snapshot()
    print(f"served {len(outs)} clouds in {wall:.2f}s; logits shape {outs[0].shape}")
    print("metrics:", snap.format_row())
    print("micro-batches (bucket, policy, n_real/B, replica):")
    for b in rt.metrics.batch_records:
        if b.n_real:
            print(f"  n={b.bucket:<4} {b.policy_key[0]:<10} {b.n_real}/{b.batch_size}"
                  f"  replica {b.replica_id}  {b.duration_s * 1e3:.1f}ms")
    print("artifact cache:", cache_stats())

    bad = mismatches(rt, params, clouds, req_policies, outs)
    ok = not bad and snap.completed == len(clouds) and snap.failed == 0
    print(f"check: {len(outs)} responses bitwise equal to eager infer of their padded "
          f"batches ({len(bad)} differ): {'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit(1)
    return {"snapshot": snap, "wall_s": wall, "responses": len(outs)}


if __name__ == "__main__":
    main()
