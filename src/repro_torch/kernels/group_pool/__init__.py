"""group_pool kernel: kernel.py (CUDA launch), ref.py (plain version), ops.py (public op)."""
