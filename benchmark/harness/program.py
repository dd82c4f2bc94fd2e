"""The system under test: the port's denoiser and VAE, built for a cell.

The benchmark takes from the program only the system itself (its model,
diffusion, trainer step, sampler, graphs and mixer entry points). The
weights are the benchmark's: made on the card from the seed and loaded by
the model's own parameter names. The model is built under the card as the
default device, so its modules allocate there and not on the host first.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.harness import weights

__all__ = ["DTYPES", "build_denoiser", "build_vae", "graph_note", "mixer_entry", "resolve",
           "setup_note"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve(toy: bool) -> torch.device:
    """The card, through the port's own device choice (TF32 off for cuBLAS
    and cuDNN); the CPU only for the benchmark's toy-size tests."""
    from diffma_tpu_torch.utils.device import resolve_device

    return resolve_device("cpu" if toy else "cuda")


def build_denoiser(cfg: dict, device, seed: int) -> Tuple[torch.nn.Module, Dict]:
    """The port's registry model ``cfg["model"]`` on ``device`` with the
    seed's weights; returns it with its parameter shapes by name."""
    from diffma_tpu_torch.models.diffma import build_model

    with torch.device(device):
        model = build_model(
            cfg["model"], input_size=cfg["latent_size"], d_state=cfg["d_state"],
            scan_impl=cfg["scan_impl"], use_mamba2=cfg["mixer"] == "mamba2",
            dtype=DTYPES[cfg["dtype"]], hidden_size=cfg["hidden_size"])
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    model.load_state_dict(weights.make(shapes, weights.denoiser_rule, seed, "denoiser", device))
    return model.to(device), shapes


def build_vae(cfg: dict, device, seed: int) -> Tuple[torch.nn.Module, Dict]:
    """The port's SD-VAE (decoder half) on ``device`` with the seed's weights."""
    from diffma_tpu_torch.models.vae import AutoencoderKL

    with torch.device(device):
        vae = AutoencoderKL(ch=cfg["vae_ch"], ch_mult=tuple(cfg["vae_ch_mult"]))
    shapes = {k: tuple(p.shape) for k, p in vae.named_parameters()}
    vae.load_state_dict(weights.make(shapes, weights.vae_rule, seed, "vae", device))
    return vae.to(device).eval(), shapes


def mixer_entry(model, cfg: dict, batch: int, device, seed: int, backward: bool):
    """One call of the dual-mixer entry point that the first Spiral block
    calls (both branches), on that block's weights (copied) and seeded
    inputs at ``batch``: with ``backward`` its forward and backward, else
    its forward without autograd. Returns the call as a function."""
    from diffma_tpu_torch.ops.fused_mixer import MixerWeights, mamba_dual_mixer_fused
    from diffma_tpu_torch.ops.fused_ssd import Mamba2Weights, mamba2_dual_mixer_fused

    block = model.blocks[0]
    m1, m2 = block.mamba1, block.mamba2
    mamba2 = cfg["mixer"] == "mamba2"
    kind = Mamba2Weights if mamba2 else MixerWeights
    ws = [kind(*(t.detach().clone().requires_grad_(backward) for t in m.weights()))
          for m in (m1, m2)]
    gen = weights.generator(seed, "probe", device)
    L = block.spec.seq_len
    x0, x1, g0, g1 = (torch.randn((batch, L, cfg["hidden_size"]), generator=gen, device=device)
                      for _ in range(4))
    x0.requires_grad_(backward)
    x1.requires_grad_(backward)

    def forward():
        if mamba2:
            return mamba2_dual_mixer_fused(block.spec, x0, x1, *ws, m1.dt_limit, m1.norm_eps,
                                           m1.chunk_size)
        return mamba_dual_mixer_fused(block.spec, x0, x1, *ws)

    if backward:
        leaves = [x0, x1, *(t for w in ws for t in w)]
        return lambda: torch.autograd.grad(forward(), leaves, (g0, g1))

    def no_grad():
        with torch.no_grad():
            return forward()

    return no_grad


def graph_note(what: str, graph, device) -> str:
    """A line on the program's CUDA graph after set-up: its capture's host
    seconds, the pool it reserved and the kernel wrappers' launches per
    replay (``utils/graphs.py``), with the peak device memory so far. No
    metric is computed from it."""
    if graph is None or graph.graph is None:
        return f"{what}: no CUDA graph"
    peak = torch.cuda.max_memory_allocated(device)
    return (f"{what} graph: capture {graph.capture_seconds:.4f} s, pool {graph.pool_bytes} "
            f"bytes, launches per replay {graph.launches}, peak memory so far {peak} bytes")


def setup_note(t_start: float, marks) -> str:
    """A line on where the set-up's seconds went: each named stage, ending at
    its mark, from the process's start."""
    parts, last = [], t_start
    for name, t in marks:
        parts.append(f"{name} {t - last:.2f} s")
        last = t
    return "set-up: " + ", ".join(parts)
