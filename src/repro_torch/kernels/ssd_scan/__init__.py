"""K5: Mamba2 SSD chunked scan, CUDA kernel + plain twin."""
