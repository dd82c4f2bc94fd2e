"""DiffMa in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``diffma_tpu`` (JAX, Pallas, TPU) to PyTorch on an H100. It
mirrors the JAX package's module paths and names:

- ``diffma_tpu_torch.ops``       -- scan orders, causal conv, norms and the
                                    selective scan (plain PyTorch and CUDA).
- ``diffma_tpu_torch.models``    -- the Mamba-1 mixer, the Spiral block, the
                                    DiffMa denoiser and the SD-VAE decoder.
- ``diffma_tpu_torch.diffusion`` -- Gaussian diffusion sampling (DDPM, DDIM).
- ``diffma_tpu_torch.train``     -- the sampling pipeline.
- ``diffma_tpu_torch.utils``     -- config, metrics, device choice and weight
                                    conversion from the JAX package.

It imports neither JAX nor ``diffma_tpu``. Entry points run on ``cuda``
unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
