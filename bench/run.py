"""Run one cell of the benchmark on the card this process is started on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a `breakdown`,
and last `checks`: each number the check compared, with its limit, which
are also the last lines of standard error.  Exits non-zero and prints no
result without a CUDA card (or with fewer than the cell asks for), when
the program cannot be imported, and when JAX or the JAX package has been
loaded by the time the window has closed.  The program's kernels build
into `build/` inside the checkout, at a fixed path, so only a checkout's
first run compiles.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def parse(argv) -> argparse.Namespace:
    """The command line: the cell, the seed, the window's seconds and whether to trace."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(msg: str) -> None:
    """One line on standard error."""
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def report(out: dict, raw: dict, limit: str) -> None:
    """The lines before the result: the generator's lateness, the power readings, the shares."""
    say("set-up, seconds from the process's start: " + "; ".join(
        f"{label} {t:.3f}" for label, t in raw["phases"]))
    late = raw.get("lateness_s")
    if late:
        ms = sorted(x * 1e3 for x in late)
        say(f"open-loop generator lateness: p50 {ms[len(ms) // 2]} ms, p99 "
            f"{ms[int(0.99 * (len(ms) - 1))]} ms, max {ms[-1]} ms over {len(ms)} requests; "
            f"backlog at the window's close {raw.get('backlog_at_close')}")
    say("the cyclic collector in the window, by generation: " + "; ".join(
        f"gen {g}: {n} collections, {tot} s, longest {mx} s" for g, (n, tot, mx)
        in sorted(raw.get("gc", {}).items())))
    if "energy_j" in raw:
        say(f"energy {raw['energy_j']} J from {raw['power_samples']} power samples "
            f"(card power limit {limit})")
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            say(f"{name} {m['value']} % (card power limit {limit})")


def main(argv=None) -> int:
    """Run the cell; return the exit code."""
    args = parse(argv)
    here = str(ROOT / "bench")
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    t_torch = time.monotonic()
    if not torch.cuda.is_available():
        say("no CUDA device is available; this benchmark measures the card")
        return 2
    from bench import harness, power

    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        say(f"the program under test cannot be imported: {e}")
        return 2
    bench = harness.load_benchmark(ROOT)
    entry = harness.named(bench["workloads"], args.workload, "cell")
    if torch.cuda.device_count() < entry["chips"]:
        say(f"{args.workload} needs {entry['chips']} cards, this host has "
            f"{torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = power.card_id(torch.cuda.get_device_properties(device))
    limit = power.query(card, "power.limit") + " W"
    kind = torch.cuda.get_device_name(device)
    say(f"card {kind} ({card}), power limit {limit}; torch imported "
        f"{t_torch - T_PROCESS:.3f} s and the card's power limit read "
        f"{time.monotonic() - T_PROCESS:.3f} s after the process's start")
    env = harness.Env(torch, device, power=lambda: power.PowerSampler(card), kind=kind,
                      platform="gpu")
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), env=env,
                           t_process=T_PROCESS)
    line, raw = harness.result_line(out)
    found = harness.loaded_forbidden()
    if found:
        say(f"JAX or the JAX package was loaded in this process: {found}")
        return 3
    report(out, raw, limit)
    if "busy_s" in out["device"]:
        say(f"profiled stretch: busy {out['device']['busy_s']} s of {out['device']['window_s']} s")
    for name, c in out["checks"].items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
