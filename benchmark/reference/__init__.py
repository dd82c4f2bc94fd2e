"""The benchmark's plain reference: DiffMa, its diffusion, training step and
VAE decoder in plain PyTorch. It imports neither JAX nor anything of the
port; every input and weight comes from the harness."""
