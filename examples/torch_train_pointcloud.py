"""End-to-end driver on the PyTorch port: train PointNet2 segmentation with checkpoints.

    PYTHONPATH=src python examples/torch_train_pointcloud.py --device cpu --steps 3
    PYTHONPATH=src python examples/torch_train_pointcloud.py --steps 100        # full config, card
    PYTHONPATH=src python examples/torch_train_pointcloud.py --quant sc_w16a16

The port's counterpart of examples/train_pointcloud.py: a thin wrapper
over the port's training driver (`repro_torch.launch.train.main`) with
--arch pointnet2-seg and a checkpoint directory under build/.  The driver
builds a PC2IMAccelerator from the config and the ExecutionPolicy; --quant
selects the SC-CIM feature path (on the card, the SC matmul kernel)
without touching the config, and the seg forward runs the knn3 kernel in
its FP stages.  Every other flag is the driver's.

With --device cpu it trains the reduced (smoke) config on the CPU, with
the kernels' plain versions (the wrapper adds --smoke); without --device
it trains the full config on the card and raises where there is none.
The last line is its check: the checkpoint of the last step reads back
equal to the trained parameters, which are finite, or it exits 1.
"""

import argparse
import os
import sys

import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.core.device import resolve_device
from repro_torch.launch.train import main as train_main
from repro_torch.optim import adamw_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(ROOT, "build", "torch_train_pointcloud_ckpt")


def main(argv=None):
    """Train pointnet2-seg through the port's driver; returns the trained parameters."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--steps", type=int, default=100)
    known, _ = ap.parse_known_args(argv)
    device = resolve_device(known.device)
    smoke = ["--smoke"] if device.type == "cpu" else []
    params = train_main(["--arch", "pointnet2-seg", *smoke, "--ckpt-dir", known.ckpt_dir, *argv])

    tree = {"params": params, "opt": adamw_init(params)}
    back, step, _ = load_checkpoint(known.ckpt_dir, tree, step=known.steps, device=device)
    same = all(torch.equal(a, b) for a, b in zip(params.parameters(),
                                                  back["params"].parameters()))
    finite = all(bool(torch.isfinite(p).all()) for p in params.parameters())
    ok = same and finite and step == known.steps
    print(f"check: checkpoint of step {step} in {known.ckpt_dir} reads back equal to the "
          f"trained parameters, which are finite: {'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit(1)
    return params


if __name__ == "__main__":
    main()
