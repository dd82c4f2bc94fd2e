"""DiffMa sampling pipeline.

Usage::

    python -m diffma_tpu_torch.train.sample --config configs/brain.yaml \\
        --model DiffMa-B/2 --device cuda

Counterpart of ``diffma_tpu/train/sample.py::main``: build the registry
model, take conditioning (y, y2, w), run the respaced DDPM chain (or DDIM
with ``use_ddim``) with ``clip_denoised=False``, decode ``samples /
SD_VAE_SCALE`` with the SD-VAE, and score the images against the ground-truth
MRI with PSNR/SSIM. Image grids are written as PNG with the standard library
alone.

The mixers take ``scan_impl`` from the config, by default ``"fused"`` on the
card (kernel C, or kernel E with ``--use-mamba2``, as the JAX sampler
defaults to it on the TPU) and ``"auto"`` on the CPU. ``use_mamba2`` builds
the Mamba-2 mixers. ``main`` is ``sample_batches`` around ``load_model``'s
model; a model built otherwise (``build_model(..., fuse_block=True)``, a
model option in the JAX package too) goes to ``sample_batches`` directly.
``--ckpt`` loads a reference torch checkpoint's ``load_ckpt_type`` weights
(``train/checkpoints.py``); without one the weights are random, drawn from
``seed``.

On the card the chain runs as a CUDA graph of one step
(``diffusion.ChainGraph``), captured once per batch shape (a short last
batch has its own) in one memory pool, as the JAX sampler always runs its
chain jitted; it gives the eager loop's images for a seed. The
conditioning encode and the VAE decode stay outside the graph.
``sample_batches(..., graphed=False)`` runs the eager loop on the card, for
a comparison; the CPU always runs it.

Each batch is one group of the tracer's spans (``utils/trace.py``):
``sample.request`` around ``sample.encode`` (the start noise and the
conditioning), ``diffusion.chain`` (its ``graph.replay`` spans inside),
``vae.decode`` and ``sample.report`` (the PNG grids and PSNR/SSIM). The log
line takes the request's seconds from these spans' totals and splits them
into the encode's and the report's (host time) and the chain's and the
decode's (device time on the card); a result's ``seconds`` is the request's
less its report.

When the three val folders exist and ``synthetic_data`` is false, the
sampler reads their ``.npy`` triplets in order (``NpyDataset``, resized to
``image_size``; the last batch may be short), takes y, y2 and w from the
frozen ``Conditioning`` stack (``train/train.py``) and decodes with that
stack's VAE; otherwise the conditioning is synthetic and the VAE random,
drawn from ``seed``. Orbax checkpoints come in a later slice.

``autocast`` (``--autocast``) builds the model in bfloat16, as the JAX
sampler does (the fused route through kernel C's bf16 variant, with
``use_mamba2`` kernel E's, and for a model built with ``fuse_block`` kernels
E's and G's); its weights load in fp32, its output is cast to fp32 for the
chain, and the graphed chain runs as it does in fp32.

Several processes (``python -m torch.distributed.run --nproc_per_node N -m
diffma_tpu_torch.train.sample ...``; ``parallel/mesh.py::init_distributed``):
each rank samples its shard of the loader (``make_loader``'s
``process_index`` and ``process_count``, the rank and the world, as the JAX
sampler's ``train/sample.py:145-159``) and keeps its own graphed chain: the
chain needs no collective. Every rank draws z and the synthetic
conditioning from the same seed, as every JAX process draws them from the
same key. Every JAX process writes the same ``{item}_sample_gen.png`` names
into one ``save_dir``, so the processes overwrite each other; here each
rank's files are named apart (``rank{r}_{item}_sample_gen.png``) when there
are several.
"""

from __future__ import annotations

import argparse
import logging
import os
import struct
import zlib

import numpy as np
import torch

from diffma_tpu_torch.data.npy_dataset import NpyDataset, make_loader
from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.diffusion.gaussian import ChainGraph
from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.models.vae import SD_VAE_SCALE, AutoencoderKL
from diffma_tpu_torch.parallel.mesh import init_distributed, world_rank, world_size
from diffma_tpu_torch.train.checkpoints import load_diffma_checkpoint
from diffma_tpu_torch.train.train import (
    Conditioning,
    check_width,
    compute_dtype,
    fp32_output,
    make_dataset,
    synthetic_batch,
)
from diffma_tpu_torch.utils import trace
from diffma_tpu_torch.utils.config import parse_cli
from diffma_tpu_torch.utils.device import resolve_device
from diffma_tpu_torch.utils.metrics import quality_report

__all__ = ["main", "load_model", "sample_batches", "save_image_grid", "cli"]

logger = logging.getLogger(__name__)


def _png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of an (H, W, 3) uint8 array."""
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))  # filter 0 rows
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def save_image_grid(images: np.ndarray, path: str, nrow: int = 4, value_range=(-1, 1)) -> None:
    """PNG grid (torchvision ``save_image`` layout: values normalised into
    ``value_range``, ``nrow`` images per row, 2 px padding)."""
    lo, hi = value_range
    imgs = np.clip((np.asarray(images, np.float32) - lo) / (hi - lo), 0, 1)
    if imgs.shape[1] == 1:
        imgs = np.repeat(imgs, 3, axis=1)
    imgs = (imgs[:, :3].transpose(0, 2, 3, 1) * 255).astype(np.uint8)
    n, h, w, _ = imgs.shape
    ncol = int(np.ceil(n / nrow))
    pad = 2
    canvas = np.zeros((ncol * (h + pad) + pad, nrow * (w + pad) + pad, 3), np.uint8)
    for i, img in enumerate(imgs):
        r, c = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + c * (w + pad)
        canvas[y : y + h, x : x + w] = img
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_png_bytes(canvas))


def load_model(cfg, device="cuda"):
    """``cfg``'s denoiser on ``device``, in eval mode: the checkpoint's weights
    when ``cfg.ckpt`` names a file that exists, else random ones from ``seed``."""
    device = resolve_device(device)
    model = build_model(
        str(cfg.model),
        input_size=cfg.image_size // 8,
        dt_rank=int(cfg.get("dt_rank", 16)),
        d_state=int(cfg.get("d_state", 16)),
        scan_impl=str(cfg.get("scan_impl", "fused" if device.type == "cuda" else "auto")),
        use_mamba2=bool(cfg.get("use_mamba2")),
        dtype=compute_dtype(cfg),
        **({"hidden_size": int(cfg.hidden_size)} if cfg.get("hidden_size") else {}),
    )
    ckpt_path = cfg.get("ckpt")
    if ckpt_path and os.path.exists(str(ckpt_path)):
        kind = str(cfg.get("load_ckpt_type", "ema"))
        load_diffma_checkpoint(model, str(ckpt_path), kind)
        logger.info(f"Loaded {kind} weights from {ckpt_path}")
    else:
        logger.info("No checkpoint found; sampling from random weights")
        model.init_weights(torch.Generator().manual_seed(int(cfg.get("seed", 0)) + 1))
    return model.to(device).eval()


def main(cfg, device="cuda"):
    """Sample ``cfg``'s model; returns one dict per batch with the decoded
    ``images`` (N, 3, H, W), the batch's wall ``seconds`` and its ``quality``."""
    device = init_distributed(resolve_device(device))
    return sample_batches(load_model(cfg, device), cfg, device)


def sample_batches(model, cfg, device="cuda", graphed=None, process_index=None,
                   process_count=None):
    """``main``'s loop over ``cfg``'s batches with ``model``, a denoiser on
    ``device`` in eval mode; returns what ``main`` returns. The chain is
    graphed unless ``graphed`` is false, by default on the card; a batch
    whose chain captured its graph also carries the graph's
    ``capture_seconds`` and ``pool_bytes``. The loader's shard is
    ``process_index`` of ``process_count``, by default this rank of the
    process group's ranks."""
    device = resolve_device(device)
    process_index = world_rank() if process_index is None else process_index
    process_count = world_size() if process_count is None else process_count
    prefix = f"rank{world_rank()}_" if world_size() > 1 else ""
    graphed = device.type == "cuda" if graphed is None else bool(graphed)
    seed = int(cfg.get("seed", 0))
    latent = cfg.image_size // 8
    diffusion = create_diffusion(str(cfg.get("sample_num_steps", 250)), device=device)

    dataset = make_dataset(cfg, "val", synthetic_size=8)
    cond = None
    if isinstance(dataset, NpyDataset):
        check_width(model)
        cond = Conditioning(cfg, logger, device, seed + 2)
        vae = cond.vae
    else:
        logger.info("using synthetic conditioning")
        vae = AutoencoderKL().init_weights(torch.Generator().manual_seed(seed + 2)).to(device)
        vae = vae.eval()

    loop = diffusion.ddim_sample_loop if cfg.get("use_ddim") else diffusion.p_sample_loop
    tokens = (latent // model.patch_size) ** 2
    gen = torch.Generator(device=device).manual_seed(seed)
    batch_size = int(cfg.get("sample_global_batch_size", 1))
    save_dir = str(cfg.get("save_dir", "./result_sample"))
    n_batches = int(cfg.get("sample_num_batches", 0)) or None

    results = []
    chains = {}  # batch size -> ChainGraph, all in the first one's memory pool
    loader = make_loader(dataset, batch_size, shuffle=False, drop_last=False,
                         process_index=process_index, process_count=process_count)
    _take_request()  # the totals of chains and decodes run before this call
    for item, (x_ct, _mask, z_mri) in enumerate(loader, start=1):
        n = x_ct.shape[0]
        trace.group()
        with trace.span("sample.request"):
            with trace.span("sample.encode"):
                z = torch.randn((n, 4, latent, latent), generator=gen, device=device)
                if cond is not None:
                    b = cond.encode_triplets(x_ct, z_mri, gen)
                else:
                    b = synthetic_batch(gen, n, latent, tokens, dim=model.hidden_size)
            chain = None
            if graphed:
                if n not in chains:
                    pool = next(iter(chains.values())).graph.pool if chains else None
                    chains[n] = ChainGraph(device, pool)
                chain = chains[n]
            captured = chain is not None and chain.graph.graph is None
            with torch.no_grad():
                samples = loop(
                    fp32_output(model), z.shape, gen, noise=z, clip_denoised=False,
                    model_kwargs={"y": b["y"], "y2": b["y2"], "w": b["w"]}, graph=chain,
                )
                images = vae.decode(samples / SD_VAE_SCALE).cpu().numpy()
            with trace.span("sample.report"):
                mri3 = np.concatenate([z_mri] * 3, axis=1)
                save_image_grid(images, f"{save_dir}/{prefix}{item}_sample_gen.png")
                save_image_grid(mri3, f"{save_dir}/{prefix}{item}_sample_ori.png")
                save_image_grid(np.concatenate([x_ct] * 3, axis=1),
                                f"{save_dir}/{prefix}{item}_sample_ct.png")
                q = quality_report(images, mri3)
        parts = _take_request()
        split = ", ".join(f"{label} {parts[label]:.3f} s" for label, _ in _PARTS)
        logger.info(
            f"saved sample grid {item} in {parts['request']:.3f} s ({split})  "
            f"PSNR {q['psnr_db']:.2f} dB  SSIM {q['ssim']:.4f}"
        )
        seconds = parts["request"] - parts["report"]
        results.append({"images": images, "seconds": seconds, "quality": q})
        if captured and chain.graph.graph is not None:
            results[-1].update(capture_seconds=chain.graph.capture_seconds,
                               pool_bytes=chain.graph.pool_bytes)
        if n_batches and item >= n_batches:
            break
    if results:
        logger.info(
            "quality over %d batches: PSNR %.2f dB, SSIM %.4f",
            len(results),
            float(np.mean([r["quality"]["psnr_db"] for r in results])),
            float(np.mean([r["quality"]["ssim"] for r in results])),
        )
    return results


_PARTS = (("encode", "sample.encode"), ("chain", "diffusion.chain"),
          ("decode", "vae.decode"), ("report", "sample.report"))


def _take_request() -> dict:
    """The seconds of the spans since the last call, by label: the request's
    and its parts' (device time on the card where the span has it)."""
    out = {"request": trace.take("sample.request").host_ms / 1e3}
    for label, name in _PARTS:
        tot = trace.take(name)
        out[label] = (tot.device_ms if tot.device_ms is not None else tot.host_ms) / 1e3
    return out


def cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--model", type=str, default=None, help="registry name, e.g. DiffMa-B/2")
    parser.add_argument("--ckpt", type=str, default=None, help="checkpoint path")
    parser.add_argument("--use-mamba2", dest="use_mamba2", action="store_true", default=None)
    parser.add_argument("--autocast", action="store_true", default=None,
                        help="the model in bfloat16, its weights fp32")
    parser.add_argument("--scan-impl", dest="scan_impl", type=str, default=None,
                        help="mixer path: fused (default on the card), auto/pallas, ref")
    parser.add_argument("--num-batches", dest="sample_num_batches", type=int, default=None,
                        help="stop after this many batches")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch versions")
    cfg = parse_cli(parser, argv)
    device = cfg.pop("device")
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")
    return main(cfg, device=device)


if __name__ == "__main__":
    cli()
