"""PC2IM preprocessing anatomy on the PyTorch port: partition -> FPS -> lattice query.

    PYTHONPATH=src python examples/torch_preprocess_pipeline.py --device cpu
    PYTHONPATH=src python examples/torch_preprocess_pipeline.py              # on the card

The port's counterpart of examples/preprocess_pipeline.py: median spatial
partitioning against a fixed grid, the tiled L1 FPS kernel, the fused
lattice query over one flat set, the batched PreprocessEngine against the
per-cloud `core/preprocess` pipeline, L1 against L2 sampling quality, and
the energy split of `core/energy.py`.

On the card the FPS and flat lattice-query calls launch the hand-written
CUDA kernels, and each is held against its plain PyTorch version on the
same inputs, bitwise (the JAX script holds its Pallas kernels against
their XLA oracle in interpret mode).  On the CPU the plain versions run and
no kernel is compared; it says so.  Without --device it runs on the card
and raises where there is none.  The last line is its check: the batched
engine equals the per-cloud pipeline, and on the card each kernel equals
its plain version, or it exits 1.
"""

import argparse
import sys

import torch

from repro_torch.core import energy as E
from repro_torch.core import fps as F
from repro_torch.core import partition as P
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import EngineConfig, PreprocessEngine
from repro_torch.core.preprocess import preprocess_pc2im
from repro_torch.core.query import LATTICE_RANGE_FACTOR
from repro_torch.data.pointclouds import sample_batch
from repro_torch.kernels import registry
from repro_torch.kernels.fps.ops import fps_tiles
from repro_torch.kernels.lattice.ops import lattice_query_fused


def _against_plain(device, name: str, got, plain) -> bool | None:
    """Print the kernel-against-plain verdict on the card; on the CPU say that only
    the plain version ran.  Returns the verdict (None where nothing was compared)."""
    if device.type != "cuda":
        print(f"  {name}: the plain version ran on the CPU; no kernel was compared")
        return None
    same = all(torch.equal(g, w) for g, w in zip(got, plain()))
    print(f"  {name}: CUDA kernel == plain version (bitwise): {same}")
    return same


def main(argv=None) -> dict:
    """Run the anatomy; returns its figures (utilisations, verdicts, energy split)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="the card by default; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    batch, _, _ = sample_batch(torch.Generator(device).manual_seed(0), 4, 2048, device=device)
    pts = batch[0]

    # --- C2: median spatial partitioning vs fixed-grid tiles --------------------
    msp = P.median_partition(pts, depth=3)
    grid = P.grid_partition(pts, grid=2, capacity=512)
    print(f"MSP   : {msp.n_tiles} tiles x {msp.tile_size} pts, "
          f"utilisation {float(msp.utilization()):.2f}")
    print(f"grid  : {grid.n_tiles} tiles x {grid.tile_size} cap, "
          f"utilisation {float(grid.utilization()):.2f}"
          f"  <- the padding waste MSP removes (paper: +15%)")

    # --- C1+C3: tiled L1 FPS (the APD-CIM/Ping-Pong-MAX kernel) -----------------
    tiled = pts[msp.tiles].contiguous()  # (8, 256, 3)
    idx = fps_tiles(tiled, 64, metric="l1")
    fps_same = _against_plain(device, "tiled FPS", (idx,), lambda: (
        registry.get("fps_tiles").plain(tiled, 64, metric="l1"),))

    # --- C1: fused lattice query ---------------------------------------------------
    centroids = pts[msp.tiles[0][idx[0].long()]].contiguous()
    nbrs = lattice_query_fused(pts, centroids, radius=0.3, nsample=16)
    print(f"lattice query: fill-rate {float(nbrs.mask.float().mean()):.2f} (L = 1.6R)")
    lattice_same = _against_plain(device, "flat lattice query", (nbrs.idx, nbrs.mask), lambda: (
        registry.get("lattice_query").plain(pts.contiguous(), centroids, nsample=16,
                                            l_range=float(0.3 * LATTICE_RANGE_FACTOR))))

    # --- the batched PreprocessEngine (B clouds -> ONE kernel grid) ---------------
    engine = PreprocessEngine(EngineConfig(
        pipeline="pc2im", n_centroids=512, radius=0.3, nsample=16, depth=3))
    res = engine(batch)  # (4, 2048, 3) -> centroid_idx (4, 512), neighbors (4, 512, 16)
    per_cloud = preprocess_pc2im(batch[0], 512, 0.3, 16, depth=3)
    batched_same = bool(torch.equal(res.centroid_idx[0], per_cloud.centroid_idx)
                        and torch.equal(res.neighbors.idx[0], per_cloud.neighbors.idx)
                        and torch.equal(res.neighbors.mask[0], per_cloud.neighbors.mask))
    print(f"engine: {batch.shape[0]} clouds x {res.centroid_idx.shape[1]} centroids in one "
          f"launch ({registry.names()} registered); batched == per-cloud: {batched_same}")

    # --- quality: L1 sampling vs exact L2 ------------------------------------------
    i2 = F.fps(pts, 256, metric="l2")
    i1 = F.fps(pts, 256, metric="l1")
    coverage = float(F.coverage_radius(pts, i1) / F.coverage_radius(pts, i2))
    print(f"coverage radius L1/L2: {coverage:.3f} (paper: ~1, Fig 5a)")

    # --- the memory-traffic ledger (Challenge I) -------------------------------------
    b2 = E.preproc_energy_baseline2(E.WORKLOADS["semantickitti_16k"])
    print("\nTiPU-style tiled FPS energy split (paper: 41% points / 58% TDs):")
    tot = b2["fps_point"] + b2["fps_td"]
    print(f"  point reads {b2['fps_point']/tot*100:.0f}%  TD update {b2['fps_td']/tot*100:.0f}%")

    ok = batched_same and fps_same is not False and lattice_same is not False
    kernels = ("tiled FPS and flat lattice kernels == plain" if device.type == "cuda"
               else "plain versions only, no kernel compared")
    print(f"check: batched engine == per-cloud pipeline; {kernels}: {'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit(1)
    return {"msp_utilization": float(msp.utilization()),
            "grid_utilization": float(grid.utilization()), "coverage_ratio": coverage,
            "fps_point": b2["fps_point"], "fps_td": b2["fps_td"],
            "kernel_equals_plain": {"fps_tiles": fps_same, "lattice_query": lattice_same}}


if __name__ == "__main__":
    main()
