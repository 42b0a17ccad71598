"""Cache engine of the port: tier chains with a CUDA-tensor HBM tier."""
