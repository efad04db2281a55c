"""Hand-written CUDA kernels for Hopper (sm_90a), one folder per kernel.

fps/        per-tile farthest point sampling (csrc/fps.cu)
lattice/    first-k L1 lattice query, per tile and over one flat set (csrc/lattice.cu)
sc_matmul/  split-concatenate integer matmul (csrc/sc_matmul.cu)
knn3/       k nearest neighbours, the seg FP layers' 3-NN (csrc/knn3.cu)

Each folder: kernel.py (ctypes launch wrapper), ref.py (plain PyTorch
version), ops.py (public op, registers the pair).  registry.py dispatches by
tensor device and counts launches; build.py compiles csrc/ with nvcc.
"""
