"""DiffMa in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``diffma_tpu`` (JAX, Pallas, TPU) to PyTorch on an H100. It
mirrors the JAX package's module paths and names:

- ``diffma_tpu_torch.ops``       -- scan orders, the causal conv, norms, the
                                    selective scan (plain, associative and
                                    kernels A and B), the SSD scans, the fused
                                    mixers (kernels C-H and P), the
                                    single-step ops of decode, and the build
                                    of the CUDA sources in ``csrc/``.
- ``diffma_tpu_torch.models``    -- the Mamba-1 and Mamba-2 mixers, the six
                                    block families, the DiffMa denoiser and
                                    its registry, incremental decode
                                    (``models/decode.py``), and the
                                    conditioning stack's SD-VAE, BiomedCLIP
                                    ViT and CT encoder.
- ``diffma_tpu_torch.diffusion`` -- Gaussian diffusion: training losses,
                                    DDPM and DDIM sampling (as CUDA graphs on
                                    the card), guidance, bpd and the timestep
                                    samplers.
- ``diffma_tpu_torch.train``     -- the trainer, the sampler, the CT
                                    embedder's pretraining, the train step
                                    and checkpoints.
- ``diffma_tpu_torch.data``      -- ``.npy`` triplets, synthetic triplets,
                                    the batch loader, the native C++ loader's
                                    binding and the dataset splitter.
- ``diffma_tpu_torch.utils``     -- config, metrics, device choice, CUDA
                                    graphs, the tracer's spans and counters,
                                    logging, profiling and FLOP counts, and
                                    weight conversion from the JAX package.

It imports neither JAX nor ``diffma_tpu``. Entry points run on ``cuda``
unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
