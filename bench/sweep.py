"""The knee of an open-loop cell: its mean rate swept, one window a rate.

    python3 bench/sweep.py --workload seg-sc-served --rates 600,800,1000 [--seconds 10]

For each rate, one run of the cell at that mean rate (the mix's burst shape
kept) on the card, printing a JSON line: the rate, the 95th percentile of
the latency, the requests still unanswered when the window closed (the
backlog: it grows with the window above the knee) and the answers a second
the window completed.  The knee is written into the mix's file as a number
by hand; the benchmark's runs never search for a rate.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    """Run the sweep; return the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from bench import harness

    env = harness.Env(torch, torch.device("cuda", 0), kind=torch.cuda.get_device_name(0),
                      platform="gpu")
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        out = harness.run_cell(args.workload, args.seed + k, args.seconds, False, env=env,
                               rate=rate)
        raw = out["raw"]
        answered = raw["requests"] - raw["backlog_at_close"]
        print(json.dumps({"rate": rate, "requests": raw["requests"],
                          "p95_ms": out["metrics"].get("latency_p95_ms", {}).get("value"),
                          "p50_ms": harness.percentile(raw["latencies_s"], 50) * 1e3,
                          "backlog_at_close": raw["backlog_at_close"],
                          "answered_per_s": answered / args.seconds, "correct": out["correct"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
