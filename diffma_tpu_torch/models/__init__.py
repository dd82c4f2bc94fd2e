"""PyTorch modules: Mamba-1 mixer, Spiral block, DiffMa, SD-VAE decoder."""
