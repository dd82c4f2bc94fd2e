"""DiffMa training pipeline.

Usage::

    python -m diffma_tpu_torch.train.train --config configs/brain.yaml

Counterpart of ``diffma_tpu/train/train.py``: build the registry model with
the JAX package's effective init, train it with the hybrid MSE + VB loss
(``diffusion.training_losses``), AdamW (betas 0.9 / 0.999, eps 1e-8, no
weight decay, as ``optax.adamw`` there), an EMA of decay 0.999 and the NaN
skip (``train/state.py``), log the loss and the throughput every
``log_every`` steps, and write a checkpoint every ``ckpt_every`` steps in the
reference's torch layout, ``<results_dir>/NNN-<model>/checkpoints/<step>.pt``,
which ``train/sample.py --ckpt`` reads. Everything is fp32 on one device.

The mixers take ``scan_impl`` from the config: by default ``"fused"`` on the
card (kernels C and D; with ``use_mamba2`` the Mamba-2 mixers and kernels E
and F; as the JAX trainer defaults to its fused kernels on the TPU) and
``"auto"`` on the CPU (the plain versions). ``--model`` takes any of the
registry's 80 names; the fused route trains the Spiral, Zig and VMamba
families and DiT (which has no mixer), while ViM and EfficientVMamba train
with ``scan_impl: auto`` until kernels D and F have their vim and partition
branches (the fused route raises for them). The trainer runs on synthetic
batches, as the JAX trainer falls back to them when the dataset folders are
missing. Real data (it needs the conditioning stack), bf16 (``autocast``),
``remat``, ``resume_from`` (Orbax) and ``tp``/``sp`` above 1 are not ported,
and asking for them raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from diffma_tpu_torch.data.npy_dataset import SyntheticTriplets, make_loader
from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.train.checkpoints import load_diffma_checkpoint, save_checkpoint
from diffma_tpu_torch.train.state import TrainState, make_train_step
from diffma_tpu_torch.utils.config import parse_cli
from diffma_tpu_torch.utils.device import resolve_device
from diffma_tpu_torch.utils.logging import WandbShim, create_experiment_dir, create_logger
from diffma_tpu_torch.utils.profiling import StepProfiler, Throughput

__all__ = ["cli", "main", "make_loss_fn", "synthetic_batch"]


def synthetic_batch(generator: torch.Generator, batch_size: int, latent: int,
                    tokens: int, dim: int = 512):
    """Random latents and conditioning shaped like the real ones, drawn on
    the generator's device."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    return {
        "z": normal(batch_size, 4, latent, latent),
        "y": normal(batch_size, dim),
        "y2": normal(batch_size, tokens, dim),
        "w": torch.sigmoid(normal(batch_size, tokens, 1)),
    }


def make_loss_fn(model, diffusion):
    """``loss_fn(batch, generator) -> (loss, aux)``: ``model``'s hybrid loss,
    a mean over the batch, at timesteps drawn uniformly from [0, T) and with
    noise drawn from ``generator``. A batch may carry its own ``t`` and
    ``noise``, which then replace the draws."""

    def loss_fn(batch, generator):
        z = batch["z"].float()
        t = batch.get("t")
        if t is None:
            t = torch.randint(0, diffusion.num_timesteps, (z.shape[0],),
                              generator=generator, device=z.device)
        terms = diffusion.training_losses(
            model, z, t, generator,
            model_kwargs={"y": batch["y"], "y2": batch["y2"], "w": batch["w"]},
            noise=batch.get("noise"),
        )
        aux = {k: v.mean().detach() for k, v in terms.items() if k != "loss"}
        return terms["loss"].mean(), aux

    return loss_fn


def _refuse_unported(cfg) -> None:
    for key, what in (("autocast", "bf16 training (the fused mixers' kernels are fp32 only)"),
                      ("remat", "rematerialisation"),
                      ("resume_from", "resuming from Orbax checkpoints")):
        if cfg.get(key):
            raise NotImplementedError(f"{key}: {what} is not ported yet")
    for key in ("tp", "sp"):
        if int(cfg.get(key) or 1) > 1:
            raise NotImplementedError(f"{key} > 1: the parallel layer is not ported yet")
    folders = [cfg.get(k) for k in ("ct_image_folder_train", "mask_image_folder_train",
                                    "mir_image_folder_train")]
    if not cfg.get("synthetic_data") and all(f and os.path.isdir(str(f)) for f in folders):
        raise NotImplementedError(
            "training on the dataset folders needs the conditioning stack, which is not "
            "ported yet; set synthetic_data: true"
        )


def main(cfg, device="cuda"):
    """Train ``cfg``'s model; returns the ``TrainState``, or with
    ``return_loss_history: true`` the pair (state, per-step metrics as
    float32 arrays)."""
    device = resolve_device(device)
    _refuse_unported(cfg)
    seed = int(cfg.get("global_seed", 0))
    exp_dir = create_experiment_dir(str(cfg.results_dir), str(cfg.model))
    logger = create_logger(exp_dir)
    logger.info(f"Experiment directory created at {exp_dir}")
    wandb = WandbShim(bool(cfg.get("wandb")), str(cfg.model).replace("/", "_"))

    if cfg.image_size % 8:
        raise ValueError("image_size must be divisible by 8 (the VAE's factor)")
    latent = cfg.image_size // 8
    model = build_model(
        str(cfg.model),
        input_size=latent,
        dt_rank=int(cfg.get("dt_rank", 16)),
        d_state=int(cfg.get("d_state", 16)),
        scan_impl=str(cfg.get("scan_impl", "fused" if device.type == "cuda" else "auto")),
        use_mamba2=bool(cfg.get("use_mamba2")),
        **({"hidden_size": int(cfg.hidden_size)} if cfg.get("hidden_size") else {}),
    )
    model.init_weights(torch.Generator().manual_seed(seed))
    if cfg.get("init_from_pretrain_ckpt"):
        load_diffma_checkpoint(model, str(cfg.pretrain_ckpt_path), "model")
        logger.info(f"Loaded pretrain model from {cfg.pretrain_ckpt_path}")
        lr = float(cfg.get("lr_", cfg.lr))
        start_step = int(cfg.get("init_train_steps", 0))
    else:
        lr = float(cfg.lr)
        start_step = 0
    model = model.to(device).train()
    logger.info(f"DiffMa Parameters: {sum(p.numel() for p in model.parameters()):,}")
    logger.info(f"blocks: {model.block_type}; mixer path: "
                f"scan_impl={getattr(model.blocks[0], 'scan_impl', None)}, "
                f"use_mamba2={getattr(model.blocks[0], 'use_mamba2', None)}, device {device}")

    diffusion = create_diffusion("", device=device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.0)
    state = TrainState(model, optimizer, step=start_step)
    train_step = make_train_step(make_loss_fn(model, diffusion), optimizer,
                                 accumulation_steps=int(cfg.get("accumulation_steps", 1)))

    logger.info("dataset folders unavailable or not used; training on synthetic data")
    dataset = SyntheticTriplets(n=int(cfg.get("synthetic_dataset_size", 64)), size=cfg.image_size)
    batch_size = int(cfg.global_batch_size)
    tokens = (latent // model.patch_size) ** 2
    generator = torch.Generator(device=device).manual_seed(seed)
    fixed_batch = None
    if cfg.get("overfit_fixed_batch"):
        fixed_gen = torch.Generator(device=device).manual_seed(seed + 1)
        fixed_batch = synthetic_batch(fixed_gen, batch_size, latent, tokens,
                                      dim=model.hidden_size)

    log_every = int(cfg.get("log_every", 10))
    ckpt_every = int(cfg.get("ckpt_every", 50_000))
    max_steps = cfg.get("max_steps")
    history = [] if cfg.get("return_loss_history") else None
    running = []
    train_steps = start_step
    profiler = StepProfiler(cfg.get("profile_dir"), int(cfg.get("profile_start_step", 10)),
                            int(cfg.get("profile_steps", 5)))
    throughput = Throughput(batch_size)
    logger.info(f"Training for {cfg.epochs} epochs...")
    try:
        for epoch in range(int(cfg.epochs)):
            logger.info(f"Beginning epoch {epoch}...")
            for _triplets in make_loader(dataset, batch_size, seed=seed, epoch=epoch):
                if fixed_batch is not None:
                    batch = fixed_batch
                else:
                    batch = synthetic_batch(generator, batch_size, latent, tokens,
                                            dim=model.hidden_size)
                metrics = train_step(state, batch, generator)
                running.append(metrics["loss"])
                if history is not None:
                    history.append(metrics)
                train_steps += 1
                profiler.step(train_steps)
                throughput.tick()
                if train_steps % log_every == 0:
                    losses = torch.stack(running).float().cpu().numpy()
                    for j, v in enumerate(losses):
                        wandb.log({"loss": float(v)}, step=train_steps - len(losses) + 1 + j)
                    tp = throughput.report()
                    logger.info(
                        f"(step={train_steps:07d}) Train Loss: {np.nanmean(losses):.4f}, "
                        f"Train Steps/Sec: {tp['steps_per_sec']:.2f}, "
                        f"Images/Sec: {tp['images_per_sec']:.2f}"
                    )
                    running = []
                if train_steps % ckpt_every == 0 and train_steps > 0:
                    path = save_checkpoint(os.path.join(exp_dir, "checkpoints"), train_steps, {
                        "model": state.model.state_dict(),
                        "ema": state.ema.state_dict(),
                        "opt": state.optimizer.state_dict(),
                        "args": dict(cfg),
                    })
                    logger.info(f"Saved checkpoint to {path}")
                if max_steps is not None and train_steps >= int(max_steps):
                    return _finish(state, history)
        return _finish(state, history)
    finally:
        profiler.close()
        logger.info("Done!")
        wandb.finish()
        logger.close()


def _finish(state: TrainState, history: Optional[list]):
    if history is None:
        return state
    stacked: Dict[str, np.ndarray] = {}
    for key in history[0]:
        stacked[key] = np.asarray([float(m[key]) for m in history], np.float32)
    return state, stacked


def cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--model", type=str, default=None, help="registry name, e.g. ViM-B/2")
    parser.add_argument("--scan-impl", dest="scan_impl", type=str, default=None,
                        help="mixer path: fused (default on the card), auto/pallas, ref")
    parser.add_argument("--wandb", action="store_true", default=None)
    parser.add_argument("--autocast", action="store_true", default=None)
    parser.add_argument("--use-mamba2", dest="use_mamba2", action="store_true", default=None)
    parser.add_argument("--max-steps", dest="max_steps", type=int, default=None,
                        help="stop after this many steps")
    parser.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=None)
    parser.add_argument("--results-dir", dest="results_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch versions")
    cfg = parse_cli(parser, argv)
    device = cfg.pop("device")
    return main(cfg, device=device)


if __name__ == "__main__":
    cli()
