"""Dry run of the LM cells: lay every (arch x shape x mesh) cell out on a
production mesh and count its work, on meta tensors.

The JAX package's `launch/dryrun.py` lowers and compiles each cell for 256
or 512 forced host devices, which proves its distribution config coherent
and reads XLA's memory and cost analyses.  The port has no compiler to
ask, so per cell it:

  1. builds the production mesh (16 x 16 single-pod, 2 x 16 x 16
     multi-pod; `launch.mesh.make_production_mesh`, abstract);
  2. builds the parameters, AdamW state, batch and decode state as meta
     tensors (`launch.shapes`): nothing is drawn or allocated;
  3. assigns their shardings by `sharding.policy` (the reference's rules on
     the reference's tree), and from each leaf's block (`shard_shape`,
     padded) the per-device argument bytes;
  4. runs the cell's step on the meta tensors under the cell's activation
     hints ("fsdp2d" for that policy, else "off", as the reference does)
     and the op counter (`launch.hlo_analysis`): the family's train_loss
     and its backward through `train.step.make_train_step` (with
     --microbatch), or `prefill`, or one `decode_step`;
  5. runs the step once more as one device's share of the partitioned
     program (`launch.spmd.census`): the parameters, AdamW state, batch
     and decode state as DTensors over a fake world of the mesh's size,
     their local shards meta tensors; it records that device's
     collectives by kind (trip-count-scaled under `hlo_analysis`, each
     repeated body once under `collectives_raw`, the repetitions under
     `while_trip_counts`) and its memory (`memory_analysis`: argument,
     output, alias, temp and peak bytes, from the live local storages);
  6. writes the reference's JSON keys.

The counter's FLOPs and bytes are of the whole (global) program:
`hlo_analysis.roofline_ms` spreads them over the mesh.  The collectives
and `memory_analysis` are one device's, as the reference's are.  Four keys
have no counterpart and stay null: `compile_s` (nothing compiles),
`hlo_bytes` (no HLO), `cost_analysis` (XLA's own per-body-once analysis;
the counter's output is under `hlo_analysis`) and, in `memory_analysis`,
`generated_code_size_in_bytes` (no generated code).  `lower_s` is the time
to build, count and census the cell.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k \\
      --mesh single --out build/dryrun/gemma3_train4k_single.json
  python -m repro_torch.launch.dryrun --all --mesh both

Several cells run in a spawned pool, one process a cell at a time and as
many processes as the host has cores (or cells); one cell runs in this
process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import get_config
from repro_torch.launch import shapes as SH
from repro_torch.launch import spmd
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.families import get_family_api
from repro_torch.sharding import policy as POL
from repro_torch.sharding.hints import activation_sharding
from repro_torch.sharding.spec import NamedSharding

LM_ARCHS = [
    "stablelm-1.6b",
    "gemma3-12b",
    "command-r-plus-104b",
    "starcoder2-3b",
    "dbrx-132b",
    "granite-moe-3b-a800m",
    "mamba2-1.3b",
    "recurrentgemma-2b",
    "whisper-small",
    "internvl2-2b",
]

DEFAULT_OUT_DIR = os.path.join("build", "dryrun")


def apply_overrides(cfg, overrides: dict):
    """cfg with `overrides` ({field: string}) applied, each cast to the field's type."""
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


@dataclasses.dataclass
class Cell:
    """One built cell: `fn()` runs its step on meta tensors; `args` are its
    arguments in the reference's layout and `shardings` theirs."""

    fn: object
    args: tuple
    shardings: tuple
    cfg: object
    kind: str
    batch: dict
    state: object


def cell_arguments(cfg, kind: str, batch: dict, mesh, policy_name: str,
                   state=None) -> tuple[tuple, tuple]:
    """(args, shardings) of a cell in the reference's layout: (params, AdamW state,
    batch) for "train", (params, batch) for "prefill", (params, decode state,
    batch) for "decode", each a tree of meta tensors beside its NamedShardings."""
    pol = POL.POLICIES[policy_name].with_mesh(mesh)
    params_shape = SH.abstract_params(cfg)
    pspecs = POL.to_shardings(POL.param_pspecs(params_shape, mesh, pol, cfg), mesh)
    bspecs = POL.to_shardings(POL.batch_pspecs(cfg, batch, mesh, pol), mesh)
    if kind == "train":
        opt_shape = SH.adamw_init_from_shapes(params_shape)
        sspecs = POL.to_shardings(POL.state_pspecs(opt_shape, pspecs, mesh), mesh)
        return (params_shape, opt_shape, batch), (pspecs, sspecs, bspecs)
    if kind == "prefill":
        return (params_shape, batch), (pspecs, bspecs)
    stspecs = POL.to_shardings(POL.decode_state_pspecs(cfg, state, mesh, pol), mesh)
    return (params_shape, state, batch), (pspecs, stspecs, bspecs)


def _pairs(tree, specs):
    """(tensor, sharding) of every leaf of `tree` beside the same leaf of `specs`."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [p for k in tree for p in _pairs(tree[k], specs[k])]
    return [p for t, s in zip(tree, specs) for p in _pairs(t, s)]


def argument_bytes(args: tuple, shardings: tuple) -> int:
    """Bytes one device holds of `args` under `shardings`: each leaf's block
    (`NamedSharding.shard_nbytes`, padding included)."""
    total = 0
    for t, s in _pairs(args, shardings):
        if not isinstance(s, NamedSharding):
            raise TypeError(f"leaf of shape {tuple(t.shape)} has no NamedSharding: {s!r}")
        total += s.shard_nbytes(t)
    return total


def build_cell(arch: str, shape_name: str, mesh, policy_name: str = "fsdp_tp",
               overrides: dict | None = None, microbatch: int | None = None) -> Cell:
    """The cell's step on meta tensors, its arguments and their shardings."""
    cfg = apply_overrides(get_config(arch), overrides or {})
    api = get_family_api(cfg)
    info = SH.SHAPES[shape_name]
    kind = info["kind"]
    batch = SH.input_specs(cfg, shape_name)
    state = SH.decode_state_specs(cfg, shape_name) if kind == "decode" else None
    args, shardings = cell_arguments(cfg, kind, batch, mesh, policy_name, state)
    module = SH.abstract_module(cfg)

    if kind == "train":
        from repro_torch.optim.adamw import adamw_init
        from repro_torch.train.step import make_train_step

        step = make_train_step(cfg, microbatch=microbatch)
        opt = adamw_init(module)

        def fn():
            return step(module, opt, batch)
    elif kind == "prefill":
        def fn():
            with torch.no_grad():
                return api["prefill"](module, cfg, batch, info["seq"])
    else:
        def fn():
            with torch.no_grad():
                return api["decode_step"](module, cfg, state, batch)
    return Cell(fn, args, shardings, cfg, kind, batch, state)


def run_cell(arch: str, shape_name: str, mesh_kind: str, policy_name: str = "fsdp_tp",
             overrides: dict | None = None, microbatch: int | None = None) -> dict:
    """Build, lay out and count one cell: the reference's result dict ("status" ok,
    skipped with its reason, or failed with the error)."""
    t0 = time.time()
    reason = SH.skip_reason(arch, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "skipped",
                "reason": reason}

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "policy": policy_name,
        "n_devices": mesh.size,
        "overrides": overrides or {}, "microbatch": microbatch,
    }
    try:
        hint_mode = "fsdp2d" if policy_name == "fsdp2d" else "off"
        with activation_sharding(mesh, mode=hint_mode):
            cell = build_cell(arch, shape_name, mesh, policy_name, overrides, microbatch)
            args_bytes = argument_bytes(cell.args, cell.shardings)
            result["cost_analysis"] = None
            counted = analyze(cell.fn)
        t_census = time.time()
        census = spmd.census(cell.cfg, cell.kind, cell.batch, cell.state, mesh, policy_name,
                             microbatch=microbatch, s_max=SH.SHAPES[shape_name]["seq"])
        mem = census["memory"]
        result["memory_analysis"] = {
            "available": True,
            "argument_size_in_bytes": args_bytes,
            **{k: mem[k] for k in ("output_size_in_bytes", "alias_size_in_bytes",
                                   "temp_size_in_bytes", "peak_memory_in_bytes")},
            "generated_code_size_in_bytes": None,
        }
        counted["collectives"] = census["collectives"]
        counted["collective_bytes_total"] = census["collective_bytes_total"]
        counted["replicated_ops"] = census["replicated_ops"]
        counted["census_s"] = round(time.time() - t_census, 2)
        result["hlo_analysis"] = counted
        result["collectives_raw"] = census["collectives_raw"]
        result["while_trip_counts"] = census["while_trip_counts"]
        result["hlo_bytes"] = None
        result["model_flops"] = SH.model_flops(cell.cfg, shape_name)
        result["param_count"] = cell.cfg.param_count()
        result["lower_s"] = round(time.time() - t0, 2)
        result["compile_s"] = None
        result["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        result["status"] = "failed"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    return result


def _run_and_write(job: tuple) -> tuple[dict, str]:
    """Run one cell and write its JSON: (the result, the line to print)."""
    arch, shape, mk, policy, overrides, microbatch, out_path = job
    res = run_cell(arch, shape, mk, policy, overrides, microbatch)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    status = res["status"]
    if status == "failed":
        extra = res.get("error", "")
    elif status == "ok":
        h, mem = res["hlo_analysis"], res["memory_analysis"]
        extra = (f"counted in {res['lower_s']}s "
                 f"flops={h['flops']:.4g} "
                 f"model_flops={res['model_flops']:.4g} "
                 f"collective_bytes={h['collective_bytes_total']:.4g} "
                 f"peak_per_device={mem['peak_memory_in_bytes']:.4g}")
    else:
        extra = res.get("reason", "")
    return res, f"[{status:7s}] {arch} x {shape} x {mk}: {extra}"


def main(argv=None) -> int:
    """The command line: one cell (--arch, --shape) or --all, on --mesh single,
    multi or both; one JSON file a cell, several cells spread over a process a
    core.  Exits 1 if any cell failed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SH.SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--policy", default="fsdp_tp", choices=list(POL.POLICIES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--set", action="append", default=[], help="cfg override key=value")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--tag", default=None, help="suffix for the output filename")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.set)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape) for arch in LM_ARCHS for shape in SH.SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    os.makedirs(args.out_dir, exist_ok=True)
    suffix = f"__{args.tag}" if args.tag else ""
    jobs = [(arch, shape, mk, args.policy, overrides, args.microbatch,
             args.out or os.path.join(args.out_dir,
                                      f"{arch}__{shape}__{mk}__{args.policy}{suffix}.json"))
            for arch, shape in cells for mk in meshes]
    if len(jobs) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # spawned, not forked: a fork after torch's thread pools have run can hang
        pool = ProcessPoolExecutor(max_workers=min(os.cpu_count() or 1, len(jobs)),
                                   mp_context=multiprocessing.get_context("spawn"))
        results = pool.map(_run_and_write, jobs)
    else:
        pool, results = None, map(_run_and_write, jobs)
    rc = 0
    try:
        for res, line in results:
            rc |= res["status"] == "failed"
            print(line, flush=True)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
