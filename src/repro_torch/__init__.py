"""repro_torch — PC2IM ported to PyTorch and hand-written CUDA kernels for Hopper.

Mirrors the JAX package `repro` by path, which stays the reference:
  core/       the paper's algorithms (MSP, FPS distances, lattice query,
              SC quantization, grouping), the batched PreprocessEngine, the
              ExecutionPolicy and the PC2IMAccelerator entry point
  kernels/    CUDA kernels (csrc/) with their plain PyTorch versions, the
              device-keyed registry and the nvcc build
  models/     PointNet2 (cls, delayed aggregation) as nn.Modules
  configs/    pointnet2-cls and its smoke config
  params.py   weights carried over from the JAX parameter tree

Imports torch and numpy only — never jax, never repro.
"""
