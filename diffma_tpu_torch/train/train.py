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
which ``train/sample.py --ckpt`` reads. One device.

``autocast`` (``--autocast``) builds the model in bfloat16, as the JAX
trainer does: its activations run in bf16 (the Mamba-1 mixers through the
bf16 variants of kernels C and D on the fused route, kernels A and B in
bf16 on the composable one; with ``use_mamba2`` the Mamba-2 mixers through
the bf16 variants of kernels E and F) and its output is cast to fp32 for
the loss; the parameters, their gradients, AdamW's moments, the EMA and
the checkpoints stay fp32, and the conditioning stack stays fp32.

On the card, at ``accumulation_steps`` 1 (the JAX trainer's fast path), the
step runs as a CUDA graph (``state.GraphedTrainStep``): the loop draws each
step's ``t`` and noise as the loss would, after the batch, and the replay
reads them with the batch from static buffers; the step never waits for the
device, so the loop does so only where it logs (the losses read to the
host, which the throughput's clock then includes) and checkpoints. With
``accumulation_steps`` above 1 the step is the same predicated one, eager.

The mixers take ``scan_impl`` from the config: by default ``"fused"`` on the
card (kernels C and D; with ``use_mamba2`` the Mamba-2 mixers and kernels E
and F; as the JAX trainer defaults to its fused kernels on the TPU) and
``"auto"`` on the CPU (the plain versions). ``--model`` takes any of the
registry's 80 names; the fused route trains every family (the Spiral, Zig,
ViM, VMamba and EfficientVMamba mixers on both Mamba versions, and DiT,
which has no mixer).

When the three train folders exist and ``synthetic_data`` is false, the
trainer reads the ``.npy`` triplets (``NpyDataset``, resized to
``image_size``), shuffled per epoch, and encodes every batch with the frozen
``Conditioning`` stack: the MRI to the latent ``z``, the CT to the CLIP
embedding ``y`` and, through its VAE latent, to the CT encoder's tokens
``y2`` and soft mask ``w``. The encode is timed as a span of its own
(``Encode ms/step`` in the log: device time on the card). Otherwise it runs
on synthetic batches, as the JAX trainer falls back to them. ``remat``,
``resume_from`` (Orbax) and ``tp``/``sp`` above 1 are not ported, and asking
for them raises.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Dict, Optional

import numpy as np
import torch

from diffma_tpu_torch.data.npy_dataset import (
    NpyDataset,
    SyntheticTriplets,
    make_loader,
    transform_test,
    transform_train,
)
from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.models.clip_vit import biomedclip_vit_b16
from diffma_tpu_torch.models.ct_encoder import CTEncoder
from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.models.vae import AutoencoderKL
from diffma_tpu_torch.train.checkpoints import load_diffma_checkpoint, save_checkpoint
from diffma_tpu_torch.train.state import GraphedTrainStep, TrainState, adamw, make_train_step
from diffma_tpu_torch.utils.config import parse_cli
from diffma_tpu_torch.utils.device import resolve_device
from diffma_tpu_torch.utils.logging import WandbShim, create_experiment_dir, create_logger
from diffma_tpu_torch.utils.profiling import SpanTimer, StepProfiler, Throughput
from diffma_tpu_torch.utils.torch_io import load_weights

__all__ = ["Conditioning", "check_width", "cli", "compute_dtype", "fp32_output", "loss_draws",
           "main", "make_dataset", "make_loss_fn", "synthetic_batch"]


def _renorm_to_unit(z: torch.Tensor) -> torch.Tensor:
    """The reference's guard: min-max rescale the whole batch to [-1, 1]
    when any value lies outside it, else leave it as it is."""
    inside = ((z >= -1) & (z <= 1)).all()
    lo, hi = z.min(), z.max()
    renormed = (z - lo) / (hi - lo).clamp_min(1e-8) * 2.0 - 1.0
    return torch.where(inside, z, renormed)


class Conditioning:
    """The frozen conditioning stack: SD-VAE, BiomedCLIP and the CT encoder,
    in eval mode. Weights come from ``vae_ckpt``, ``clip_ckpt`` and
    ``ct_ckpt`` (``utils/torch_io.load_weights``); a module without a file
    gets random weights drawn from ``seed``, and the log says so. The CT
    encoder works on the (image_size / 8)-wide latent with the patch of the
    model's name and 512 channels, the width of ``y`` and ``y2``."""

    WIDTH = 512

    def __init__(self, cfg, logger, device, seed: int = 0):
        size = int(cfg.image_size)
        patch = int(str(cfg.model)[-1])
        self.vae = AutoencoderKL(with_encoder=True)
        self.clip = biomedclip_vit_b16(img_size=size)
        self.ct = CTEncoder(img_size=size // 8, patch_size=patch, in_channels=4,
                            embed_dim=self.WIDTH, contain_mask_token=True)
        self.device = torch.device(device)
        generator = torch.Generator().manual_seed(int(seed))
        for name, key, kind, module in (("sd-vae", "vae_ckpt", "vae", self.vae),
                                        ("biomedclip", "clip_ckpt", "clip", self.clip),
                                        ("ct-encoder", "ct_ckpt", "ct", self.ct)):
            path = cfg.get(key)
            if path and os.path.exists(str(path)):
                logger.info(f"{name}: importing weights from {path}")
                module.load_state_dict(
                    load_weights(kind, str(path), str(cfg.get("load_ckpt_type", "ema"))))
            else:
                logger.info(f"{name}: no local weights found ({path!r}); using random frozen "
                            f"init -- supply a checkpoint for real data runs")
                module.init_weights(generator)
            module.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, x_ct: torch.Tensor, z_mri: torch.Tensor,
                 generator: Optional[torch.Generator] = None, noise=(None, None)):
        """(B, 3, H, W) CT and MRI images -> ``z`` (B, 4, H/8, W/8), ``y`` (B,
        512), ``y2`` (B, T, 512) and ``w`` (B, T, 1). The MRI is encoded
        first, then the CT, each with its own draw from ``generator``, or
        with ``noise`` = (the MRI's, the CT's) in their place."""
        z = self.vae.encode_sample(_renorm_to_unit(z_mri), generator, noise[0])
        x_lat = self.vae.encode_sample(x_ct, generator, noise[1])
        w, y2 = self.ct(x_lat)
        return {"z": z, "y": self.clip(x_ct), "y2": y2, "w": w}

    def encode_triplets(self, x_ct: np.ndarray, z_mri: np.ndarray,
                        generator: Optional[torch.Generator] = None):
        """A loader's (B, 1, H, W) CT and MRI arrays, repeated to 3 channels
        on the stack's device, encoded."""
        def rgb(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device).repeat(1, 3, 1, 1)

        return self(rgb(x_ct), rgb(z_mri), generator)


def make_dataset(cfg, split: str, synthetic_size: int):
    """The config's ``.npy`` triplets for ``split`` ("train" or "val"),
    resized to ``image_size``, when its three folders exist and
    ``synthetic_data`` is false; else ``SyntheticTriplets``."""
    folders = [cfg.get(f"{k}_image_folder_{split}") for k in ("ct", "mask", "mir")]
    size = int(cfg.image_size)
    if cfg.get("synthetic_data") or not all(f and os.path.isdir(str(f)) for f in folders):
        return SyntheticTriplets(n=int(cfg.get("synthetic_dataset_size", synthetic_size)),
                                 size=size)
    transform = transform_train if split == "train" else transform_test
    return NpyDataset(*map(str, folders), transform=functools.partial(transform,
                                                                      size=(size, size)))


def check_width(model) -> None:
    """``y`` is added to the timestep embedding: the model's width must be
    the conditioning stack's."""
    if model.hidden_size != Conditioning.WIDTH:
        raise ValueError(f"the conditioning stack is {Conditioning.WIDTH} wide and the model "
                         f"{model.hidden_size}: real-data runs need hidden_size "
                         f"{Conditioning.WIDTH}")


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


def compute_dtype(cfg) -> torch.dtype:
    """The model's dtype: bfloat16 under ``autocast``, else fp32."""
    return torch.bfloat16 if cfg.get("autocast") else torch.float32


def fp32_output(model):
    """``model`` with its output cast to fp32, as the JAX trainer's and
    sampler's ``model_fn``: the diffusion's arithmetic stays fp32 whatever
    the model's dtype."""

    def model_fn(x, t, **kwargs):
        return model(x, t, **kwargs).float()

    return model_fn


def make_loss_fn(model, diffusion):
    """``loss_fn(batch, generator) -> (loss, aux)``: ``model``'s hybrid loss
    on its output cast to fp32, a mean over the batch, at timesteps drawn
    uniformly from [0, T) and with noise drawn from ``generator``. A batch
    may carry its own ``t`` and ``noise``, which then replace the draws."""
    model_fn = fp32_output(model)

    def loss_fn(batch, generator):
        z = batch["z"].float()
        t = batch.get("t")
        if t is None:
            t = torch.randint(0, diffusion.num_timesteps, (z.shape[0],),
                              generator=generator, device=z.device)
        terms = diffusion.training_losses(
            model_fn, z, t, generator,
            model_kwargs={"y": batch["y"], "y2": batch["y2"], "w": batch["w"]},
            noise=batch.get("noise"),
        )
        aux = {k: v.mean().detach() for k, v in terms.items() if k != "loss"}
        return terms["loss"].mean(), aux

    return loss_fn


def loss_draws(diffusion, z: torch.Tensor, generator: torch.Generator):
    """The timesteps and the noise that ``make_loss_fn``'s loss draws for the
    latents ``z`` from ``generator``, drawn as it draws them and in its
    order: a graphed step takes them in its batch."""
    z = z.float()
    t = torch.randint(0, diffusion.num_timesteps, (z.shape[0],), generator=generator,
                      device=z.device)
    return t, torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)


def _refuse_unported(cfg) -> None:
    for key, what in (("remat", "rematerialisation"),
                      ("resume_from", "resuming from Orbax checkpoints")):
        if cfg.get(key):
            raise NotImplementedError(f"{key}: {what} is not ported yet")
    for key in ("tp", "sp"):
        if int(cfg.get(key) or 1) > 1:
            raise NotImplementedError(f"{key} > 1: the parallel layer is not ported yet")


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
        dtype=compute_dtype(cfg),
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
    logger.info(f"Use bf16 training? {bool(cfg.get('autocast'))}")
    logger.info(f"blocks: {model.block_type}; mixer path: "
                f"scan_impl={getattr(model.blocks[0], 'scan_impl', None)}, "
                f"use_mamba2={getattr(model.blocks[0], 'use_mamba2', None)}, device {device}")

    diffusion = create_diffusion("", device=device)
    optimizer = adamw(model.parameters(), lr)
    state = TrainState(model, optimizer, step=start_step)
    accumulation_steps = int(cfg.get("accumulation_steps", 1))
    train_step = make_train_step(make_loss_fn(model, diffusion), optimizer,
                                 accumulation_steps=accumulation_steps)
    graphed = device.type == "cuda" and accumulation_steps == 1
    if graphed:
        train_step = GraphedTrainStep(train_step, device)

    dataset = make_dataset(cfg, "train", synthetic_size=64)
    cond = None
    if isinstance(dataset, NpyDataset):
        check_width(model)
        cond = Conditioning(cfg, logger, device, seed)
        logger.info(f"Dataset contains {len(dataset)}.")
    else:
        logger.info("dataset folders unavailable or not used; training on synthetic data")
    encode_timer = SpanTimer(device)
    batch_size = int(cfg.global_batch_size)
    tokens = (latent // model.patch_size) ** 2
    generator = torch.Generator(device=device).manual_seed(seed)
    fixed_batch = None
    if cond is None and cfg.get("overfit_fixed_batch"):
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
            for x_ct, _mask, z_mri in make_loader(dataset, batch_size, seed=seed, epoch=epoch):
                if cond is not None:
                    with encode_timer.span():
                        batch = cond.encode_triplets(x_ct, z_mri, generator)
                elif fixed_batch is not None:
                    batch = fixed_batch
                else:
                    batch = synthetic_batch(generator, batch_size, latent, tokens,
                                            dim=model.hidden_size)
                if graphed:
                    batch = dict(batch)
                    batch["t"], batch["noise"] = loss_draws(diffusion, batch["z"], generator)
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
                    encode = (f", Encode ms/step: {encode_timer.read():.2f}"
                              if cond is not None else "")
                    logger.info(
                        f"(step={train_steps:07d}) Train Loss: {np.nanmean(losses):.4f}, "
                        f"Train Steps/Sec: {tp['steps_per_sec']:.2f}, "
                        f"Images/Sec: {tp['images_per_sec']:.2f}{encode}"
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
