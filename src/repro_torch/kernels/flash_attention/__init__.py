"""K4: blockwise (flash) attention forward, CUDA kernel + plain twin."""
