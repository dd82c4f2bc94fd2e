"""CT-encoder contrastive pretraining.

Usage::

    python -m diffma_tpu_torch.train.train_embedder --config configs/brain.yaml \\
        [--max-steps N] [--device cpu]

Counterpart of ``diffma_tpu/train/train_embedder.py``: train ``CTEncoder``
on the VAE latents of the 3-channel CT slices with the batch-wise InfoNCE
objective (flatten the tokens, L2-normalise, similarity over tau = 0.07,
cross-entropy against the identity pairing), AdamW (lr 1e-4, no weight
decay) and an EMA of decay 0.9999, from the ``embedder_*`` config keys. The
VAE is frozen: ``vae_ckpt`` when it names a file, else random weights drawn
from the seed. The JAX package writes Orbax; the port writes upstream's torch
layout ``{"model", "ema", "opt", "args"}``, with the CT encoder's key names,
to ``<embedder_results_dir>/NNN-vision_encoder/checkpoints/<step:07d>.pt``,
which ``ct_ckpt`` reads in both packages. The CLI takes ``--autocast`` and
nothing reads it, as in the JAX package: the CT encoder trains in fp32.

Several processes (``python -m torch.distributed.run ...``;
``parallel/mesh.py::init_distributed``): every rank is a dp rank; it reads
its shard of the loader with ``embedder_global_batch_size / world`` rows
(``diffma_tpu/train/train_embedder.py:108,120``), as many batches an epoch
as every other rank, and rank 0 writes the checkpoints (``:137``) while the
others wait. The JAX step sums no gradient over processes, so each JAX
process trains its own copy and rank 0 saves one that saw 1/dp of the
data; here the gradients (and the logged loss) are averaged over the ranks
as the trainer's are, and every rank holds the same model. The InfoNCE
negatives stay those of each rank's own batch.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch
import torch.nn.functional as F

from diffma_tpu_torch.data.npy_dataset import NpyDataset, make_loader
from diffma_tpu_torch.models.ct_encoder import CTEncoder
from diffma_tpu_torch.models.vae import AutoencoderKL
from diffma_tpu_torch.parallel.mesh import (
    broadcast_bytes,
    init_distributed,
    make_mesh,
    shard_params,
)
from diffma_tpu_torch.train.checkpoints import save_checkpoint
from diffma_tpu_torch.train.state import TrainState, adamw, make_train_step
from diffma_tpu_torch.train.train import make_dataset
from diffma_tpu_torch.utils.config import parse_cli
from diffma_tpu_torch.utils.device import resolve_device
from diffma_tpu_torch.utils.logging import create_experiment_dir, create_logger
from diffma_tpu_torch.utils.profiling import Throughput
from diffma_tpu_torch.utils.torch_io import load_weights

__all__ = ["cli", "info_nce_loss_b", "main"]


def info_nce_loss_b(x: torch.Tensor, tau: float = 0.07) -> torch.Tensor:
    """Batch-wise InfoNCE: each sample's tokens against the batch's."""
    flat = x.reshape(x.shape[0], -1).float()
    flat = flat / (flat.norm(dim=1, keepdim=True) + 1e-12)
    sim = flat @ flat.T / tau
    return F.cross_entropy(sim, torch.arange(x.shape[0], device=x.device))


def main(cfg, device="cuda"):
    """Train the CT encoder; returns the ``TrainState``."""
    device = init_distributed(resolve_device(device))
    mesh = make_mesh(device=device)
    rank, world = mesh.rank, mesh.dp
    seed = int(cfg.get("embedder_global_seed", 0))
    exp_dir = None
    if rank == 0:
        exp_dir = create_experiment_dir(str(cfg.embedder_results_dir), "vision_encoder")
    if world > 1:
        exp_dir = broadcast_bytes(exp_dir and os.path.abspath(exp_dir).encode(), mesh).decode()
    logger = create_logger(exp_dir if rank == 0 else None, rank)
    logger.info(f"Experiment directory created at {exp_dir}")

    model = CTEncoder(img_size=int(cfg.image_size) // 8,
                      patch_size=int(cfg.get("embedder_patch_size", 2)), in_channels=4,
                      embed_dim=int(cfg.get("embedder_embed_dim", 512)), contain_mask_token=True)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    shard_params(model.parameters(), mesh)
    logger.info(f"Parameters: {sum(p.numel() for p in model.parameters()):,}")

    vae = AutoencoderKL(with_encoder=True)
    vae_ckpt = cfg.get("vae_ckpt")
    if vae_ckpt and os.path.exists(str(vae_ckpt)):
        logger.info(f"sd-vae: importing weights from {vae_ckpt}")
        vae.load_state_dict(load_weights("vae", str(vae_ckpt)))
    else:
        logger.info("sd-vae weights unavailable; random frozen VAE")
        vae.init_weights(torch.Generator().manual_seed(seed + 1))
    vae = vae.to(device).eval().requires_grad_(False)

    optimizer = adamw(model.parameters(), 1e-4)
    state = TrainState(model, optimizer)

    def loss_fn(batch, generator):
        return info_nce_loss_b(model(batch["lat"])[1]), {}

    train_step = make_train_step(loss_fn, optimizer, ema_decay=0.9999, group=mesh.group("dp"))

    dataset = make_dataset(cfg, "train", synthetic_size=64)
    if isinstance(dataset, NpyDataset):
        logger.info(f"Dataset contains {len(dataset)}.")
    else:
        logger.info("dataset folders unavailable; synthetic data")

    global_batch = int(cfg.get("embedder_global_batch_size", 32))
    if global_batch % world:
        raise ValueError(f"embedder_global_batch_size {global_batch} is not divisible by the "
                         f"{world} ranks")
    batch_size = global_batch // world  # this rank's rows
    steps_per_epoch = len(dataset) // world // batch_size
    max_steps = cfg.get("max_steps")
    log_every = int(cfg.get("log_every", 10))
    ckpt_every = int(cfg.get("embedder_ckpt_every", 5000))
    generator = torch.Generator(device=device).manual_seed(seed)
    throughput = Throughput(global_batch)
    running, train_steps = [], 0
    logger.info(f"Training for {cfg.embedder_epoch} epochs...")
    try:
        for epoch in range(int(cfg.embedder_epoch)):
            logger.info(f"Beginning epoch {epoch}...")
            loader = make_loader(dataset, batch_size, seed=seed, epoch=epoch,
                                 process_index=rank, process_count=world)
            for x_ct, _mask, _mri in itertools.islice(loader, steps_per_epoch):
                x3 = torch.from_numpy(x_ct).to(device).repeat(1, 3, 1, 1)
                with torch.no_grad():
                    lat = vae.encode_sample(x3, generator)
                metrics = train_step(state, {"lat": lat}, generator)
                running.append(metrics["loss"])
                train_steps += 1
                throughput.tick()
                if train_steps % log_every == 0:
                    losses = torch.stack(running).float().cpu().numpy()
                    logger.info(f"(step={train_steps:07d}) Train Loss: {np.nanmean(losses):.8f}, "
                                f"Train Steps/Sec: {throughput.report()['steps_per_sec']:.2f}")
                    running = []
                if train_steps % ckpt_every == 0:
                    if rank == 0:
                        path = save_checkpoint(os.path.join(exp_dir, "checkpoints"), train_steps, {
                            "model": state.model.state_dict(),
                            "ema": state.ema.state_dict(),
                            "opt": state.optimizer.state_dict(),
                            "args": dict(cfg),
                        })
                        logger.info(f"Saved checkpoint to {path}")
                    if world > 1:
                        torch.distributed.barrier()
                if max_steps is not None and train_steps >= int(max_steps):
                    return state
        return state
    finally:
        logger.info("Done!")
        logger.close()


def cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--max-steps", dest="max_steps", type=int, default=None,
                        help="stop after this many steps")
    parser.add_argument("--ckpt-every", dest="embedder_ckpt_every", type=int, default=None)
    parser.add_argument("--results-dir", dest="embedder_results_dir", type=str, default=None)
    parser.add_argument("--wandb", action="store_true", default=None,
                        help="accepted and unused, as in the JAX package: the embedder logs no "
                             "metrics to wandb")
    parser.add_argument("--autocast", action="store_true", default=None,
                        help="accepted and unused: the CT encoder trains in fp32")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs on the CPU")
    cfg = parse_cli(parser, argv)
    device = cfg.pop("device")
    return main(cfg, device=device)


if __name__ == "__main__":
    cli()
