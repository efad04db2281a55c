"""Quickstart on the PyTorch port: the paper's pipeline end to end.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # smoke config, plain versions
    PYTHONPATH=src python examples/torch_quickstart.py                # full pointnet2-cls on the card

The port's counterpart of examples/quickstart.py.  It builds procedural
point clouds and runs batched PC2IM preprocessing (median partition -> L1
FPS -> lattice query) through the PreprocessEngine, all 4 clouds in one
launch of each kernel.  Then it trains a PointNet2 classifier through a
`PC2IMAccelerator`: one (config, ExecutionPolicy) pair holds the whole
pipeline, the preprocessing engines and the (optionally SC-quantized)
feature path.  Its 20 AdamW steps go through `launch.train.TrainStep`,
which on the card replays the whole step as one CUDA graph.  Last it runs
SC W16A16 inference from the same params and prints the preprocessing
energy figures of `core/energy.py`.

With --device cpu it runs the reduced (smoke) config on the CPU, with the
kernels' plain versions; without --device it runs the full config on the
card and raises where there is none.  The last line is its check: the mean
loss of the last 5 steps must be below that of the first 5, or it exits 1.
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import energy as E
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import EngineConfig, PreprocessEngine
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.data.pointclouds import sample_batch
from repro_torch.launch.train import TrainStep
from repro_torch.optim import adamw_init

STEPS = 20
LR = 2e-3
TRAIN_BATCH = 16


def main(argv=None) -> dict:
    """Run the quickstart; returns its figures (losses, energy reductions)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the smoke config")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. data + batched PC2IM preprocessing -------------------------------
    pts, _, _ = sample_batch(torch.Generator(device).manual_seed(0), 4, 512, device=device)
    engine = PreprocessEngine(EngineConfig(
        pipeline="pc2im", n_centroids=128, radius=0.3, nsample=16, depth=2))
    res = engine(pts)  # all 4 clouds in one launch
    print(f"sampled {res.centroid_idx.shape[0]}x{res.centroid_idx.shape[1]} centroids; "
          f"neighbour fill-rate {float(res.neighbors.mask.float().mean()):.2f}")

    # --- 2. train a PointNet2 through the accelerator ---------------------------
    # swap quant="sc_w16a16" to train under the paper's C4 SC-CIM feature path
    accel = get_accelerator(get_config("pointnet2-cls", smoke=device.type == "cpu"),
                            ExecutionPolicy(quant="none"), device=device)
    params = accel.init(torch.Generator().manual_seed(1))
    step = TrainStep(accel, params, adamw_init(params), lr=LR)
    losses = []
    for i in range(STEPS):
        pts, cls, _ = sample_batch(torch.Generator(device).manual_seed(100 + i), TRAIN_BATCH,
                                   accel.config.n_points, device=device)
        m = step(pts, cls)
        losses.append(float(m["loss"]))  # read now: a replay reuses its output tensors
        if i % 5 == 0:
            print(f"step {i}: loss={losses[-1]:.4f} acc={float(m['accuracy']):.3f}")

    # quantized inference from the SAME params: a second accelerator
    accel_q = get_accelerator(accel.config, ExecutionPolicy(quant="sc_w16a16"), device=device)
    logits_q = accel_q.infer(params, pts)
    print(f"SC W16A16 inference: logits {tuple(logits_q.shape)} via {accel_q!r}")

    # --- 3. the paper's energy story -----------------------------------------------
    _, rep = E.calibrate_cim()
    print(f"\npreprocessing energy (SemanticKITTI 16k): "
          f"-{rep['reduction_vs_baseline1']*100:.1f}% vs baseline-1 (paper: 97.9%), "
          f"-{rep['reduction_vs_baseline2']*100:.1f}% vs TiPU (paper: 73.4%)")

    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    ok = last < first and bool(torch.isfinite(logits_q).all())
    print(f"check: mean loss of the last 5 steps {last:.4f} < first 5 {first:.4f}, "
          f"SC logits finite: {'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit(1)
    return {"losses": losses, "reduction_vs_baseline1": rep["reduction_vs_baseline1"],
            "reduction_vs_baseline2": rep["reduction_vs_baseline2"]}


if __name__ == "__main__":
    main()
