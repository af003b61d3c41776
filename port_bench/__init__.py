"""The benchmark of the PyTorch / CUDA port: see port_bench/README.md."""
