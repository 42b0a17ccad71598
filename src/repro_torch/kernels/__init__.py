"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see ``kernels/device.py`` for how they are built and picked)."""
