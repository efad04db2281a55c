"""Core PC2IM algorithms, the batched engine and the accelerator entry point.

C1  L1 distances + lattice query            -> fps.py, query.py
C2  median-based spatial partitioning (MSP) -> partition.py
C4  split-concatenate quantized MAC         -> quant.py, kernels/sc_matmul
C5  delayed aggregation (and standard)      -> grouping.py
Baselines 1/2 (global FPS + ball, grid)     -> preprocess.py, partition.py, query.py
Analytic energy / cycle model               -> energy.py
Batched (B, N, 3) PreprocessEngine          -> engine.py
ExecutionPolicy                             -> policy.py
3-NN + interpolation (seg FP stages)       -> query.py, grouping.py
PC2IMAccelerator                            -> accelerator.py (device.py)
"""
