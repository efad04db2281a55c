"""Readings that set a cell's check limit: the program on a dozen seeds, the control on three.

    python3 bench/control.py --workload <cell> [--seeds 12] [--control-seeds 3]
                             [--seconds 3] [--control sc_w8a8|tf32]

Runs the cell at its own sizes and load in this one process, on seeds the
benchmark's own runs do not use, and prints one JSON line a run (the
numbers the check compared) and a summary: the lower reading (the largest
gap of the program's seeds) and the upper one (the smallest gap of the
control's).  The control is the program one precision below the one the
cell's mix states, on the program's own path: W8A8 for an SC W16A16 mix,
TF32 matmuls for a float32 one.  Needs the card; prints no summary without
one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED_BASE = 3_000_000_000  # past 2**31, and apart from the seeds of the benchmark's own runs


def main(argv=None) -> int:
    """Run the readings; return the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", choices=("sc_w8a8", "tf32"), default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from bench import harness

    bench = harness.load_benchmark(ROOT)
    entry = harness.named(bench["workloads"], args.workload, "cell")
    traffic = harness.load_traffic(ROOT, entry["traffic"])
    control = args.control or ("tf32" if traffic["quant"] == "none" else "sc_w8a8")
    env = harness.Env(torch, torch.device("cuda", 0), kind=torch.cuda.get_device_name(0),
                      platform="gpu")
    readings = {"program": [], "control": []}
    for side, n in (("program", args.seeds), ("control", args.control_seeds)):
        for k in range(n):
            seed = SEED_BASE + 1000 * (side == "control") + k
            kw = {}
            if side == "control":
                kw = {"tf32": True} if control == "tf32" else {"quant": control}
            out = harness.run_cell(args.workload, seed, args.seconds, False, env=env, **kw)
            line = {"side": side, "seed": seed, "control": control if side == "control" else None,
                    "correct": out["correct"], "checks": out["checks"]}
            readings[side].append(out["checks"]["logit_gap"]["value"])
            print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "control": control,
                      "lower": max(readings["program"]), "upper": min(readings["control"]),
                      "program": readings["program"], "control_readings": readings["control"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
