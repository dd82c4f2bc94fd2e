"""The benchmark of the PyTorch and CUDA port (``diffma_tpu_torch``): see README.md."""
