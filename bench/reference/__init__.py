"""The plain PyTorch reference that the benchmark's check holds the program to."""
