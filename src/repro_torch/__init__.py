"""repro_torch — PC2IM ported to PyTorch and hand-written CUDA kernels for Hopper.

Mirrors the JAX package `repro` by path, which stays the reference:
  core/        the paper's algorithms (MSP and the grid/Morton baselines,
               FPS, lattice and ball queries, SC quantization, grouping,
               the per-cloud pipelines, the energy model), the batched
               PreprocessEngine, the ExecutionPolicy, the PC2IMAccelerator
               entry points and their captured CUDA graphs (graphs.py, the
               jit artifacts' counterpart, the training step's too)
  kernels/     CUDA kernels (csrc/) with their plain PyTorch versions, the
               device-keyed registry and the nvcc build
  models/      PointNet2 (cls and seg; pc2im, baseline1 or baseline2
               preprocessing; standard or delayed aggregation) as
               nn.Modules, and its training loss
  configs/     pointnet2-cls and pointnet2-seg, each with its smoke config
  data/        the seeded procedural point-cloud dataset
  optim/       AdamW (in place), the learning-rate schedule and int8
               gradient compression
  checkpoint/  checkpoints in the JAX package's on-disk format
  launch/      the training entry point (python -m repro_torch.launch.train),
               and device groups with their collectives (mesh.py)
  sharding/    the replica axis of a device group and its two modes
  serve/       the serving runtime and its control plane, replicas over
               device groups included
  runtime/     heartbeat and straggler monitors
  parallel/    pipeline schedules: GPipe over stage devices, and the
               two-stage host form
  params.py    weights carried over from the JAX parameter tree and back,
               and the reference's leaf order

Imports torch and numpy (and msgpack for checkpoints) only — never jax,
never repro.
"""
