"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their Python
wrappers, each beside its plain PyTorch version."""
