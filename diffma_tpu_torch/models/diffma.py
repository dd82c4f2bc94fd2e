"""DiffMa: conditional latent-diffusion denoiser with Mamba backbones.

Counterpart of ``diffma_tpu/models/diffma.py``: patchify, + 2-D sincos
pos-embed, ``depth`` blocks of one family (``block_type``) with U-Net-style
long skips, adaLN final layer, unpatchify. The public API is NCHW. The
conditioning vector is c = concat(t_emb + y, t_emb + mean(y2)), (N, 2D); w
soft-masks the second branch of every Spiral block (the other families drop
it). Layer i of a Mamba family scans ``build_scan_spec(block_type, grid, i)``:
the spiral orders (2i) % 16 and (2i) % 16 + 1, zig variant i % 8, and so on;
a DiT block has no scan spec.

The registry holds the JAX package's 80 names: ``DiffMa-`` (spiral, with an
XXL size), ``ZigMa-``, ``ViM-``, ``VMamba-``, ``EMamba-`` (EfficientVMamba)
and ``DiT-``, each in sizes XL, L, B, S (depths 28, 16, 8, 4) at patch 2, 4
and 7, the four Mamba families' ``-BL/2`` at depth 13 and ``DiT-SB/2`` at
depth 7. ``scan_impl`` picks the mixers' path for every block
(``models/mamba.py``); the sampler's default on the card is ``"fused"``.
``use_mamba2`` builds the blocks on the Mamba-2 mixer (``models/mamba2.py``),
and ``fuse_block`` with it sends each whole Spiral block through
``spiral_block_fused`` (its backward recomputes the block, so training takes
the mixer-level route); the other families ignore ``fuse_block``, and DiT
ignores all three.

``dtype`` is the compute dtype, as the JAX model's (``--autocast`` builds
it in bfloat16): the parameters stay fp32, every module computes in
``dtype`` with the JAX package's fp32 islands, the conditioning is cast to
it, and the output is in it (the loss and the sampler cast it to fp32).
bfloat16 runs every family: the Mamba-1 mixers (kernels C and D, or A and
B), the Mamba-2 mixers (kernels E and F, and with ``fuse_block`` E and G)
and DiT.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from diffma_tpu_torch.models.blocks import BLOCKS
from diffma_tpu_torch.models.mamba import check_scan_impl
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.models.layers import (
    FinalLayer,
    PatchEmbed,
    TimestepEmbed,
    get_2d_sincos_pos_embed,
)
from diffma_tpu_torch.ops.scan_orders import build_scan_spec

__all__ = ["DiffMa", "DiffMa_models", "build_model"]


class DiffMa(nn.Module):
    def __init__(
        self,
        input_size: int = 28,
        patch_size: int = 2,
        hidden_size: int = 512,
        depth: int = 16,
        block_type: str = "spiral",
        dt_rank: Optional[int] = 16,  # accepted and unused, as in the JAX package
        d_state: int = 16,
        scan_impl: str = "auto",
        use_mamba2: bool = False,
        fuse_block: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        del dt_rank
        if block_type not in BLOCKS:
            raise ValueError(f"unknown block_type {block_type!r}; expected one of {sorted(BLOCKS)}")
        check_scan_impl(scan_impl)
        self.block_type = block_type
        self.patch_size = patch_size
        self.in_channels = 4  # SD-VAE latent
        self.out_channels = 8  # epsilon and the learned-range variance
        self.grid_n = input_size // patch_size
        self.depth = depth
        self.hidden_size = hidden_size
        self.dtype = dtype

        self.x_embedder = PatchEmbed(patch_size, self.in_channels, hidden_size, dtype)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(get_2d_sincos_pos_embed(hidden_size, self.grid_n)),
            persistent=False,
        )
        self.t_embedder = TimestepEmbed(hidden_size, dtype=dtype)
        mixer_kw = dict(d_state=d_state, scan_impl=scan_impl, use_mamba2=use_mamba2, dtype=dtype)
        if block_type == "spiral":
            mixer_kw["fuse_block"] = fuse_block
        self.blocks = nn.ModuleList(
            BLOCKS[block_type](hidden_size, dtype=dtype) if block_type == "DiT" else
            BLOCKS[block_type](hidden_size, build_scan_spec(block_type, self.grid_n, i), **mixer_kw)
            for i in range(depth)
        )
        self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels, dtype)

    def set_scan_impl(self, scan_impl: str) -> "DiffMa":
        """Switch every block and mixer to ``scan_impl``; the weights stay."""
        check_scan_impl(scan_impl)
        for m in self.modules():
            if hasattr(m, "scan_impl"):  # the Mamba blocks and their mixers
                m.scan_impl = scan_impl
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DiffMa":
        """The JAX package's effective init, drawn from ``generator``: xavier
        linears with zero bias, N(0, 0.02) timestep MLP, zero adaLN and final
        layer (so every block starts as the identity), torch Conv1d init for
        the depthwise conv, D = 1; Mamba-1: A_log = log(1..n); Mamba-2:
        A_log = log U(1, 16), dt_bias the softplus inverse of a log-uniform dt
        in [1e-3, 1e-1] floored at 1e-4, norm weight 1."""

        def xavier(w):
            fan_out, fan_in = w.shape[0], w[0].numel()
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            w.uniform_(-bound, bound, generator=generator)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                xavier(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm) and m.elementwise_affine:
                m.weight.fill_(1.0)
                m.bias.zero_()
        xavier(self.x_embedder.proj.weight)
        self.x_embedder.proj.bias.zero_()
        for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
            lin.weight.normal_(0.0, 0.02, generator=generator)
        for blk in self.blocks:
            blk.adaLN_modulation[1].weight.zero_()
            blk.adaLN_modulation[1].bias.zero_()
            for mixer in blk.mixers():
                bound = 1.0 / math.sqrt(mixer.conv1d.weight.shape[-1])
                mixer.conv1d.weight.uniform_(-bound, bound, generator=generator)
                mixer.conv1d.bias.uniform_(-bound, bound, generator=generator)
                mixer.D.fill_(1.0)
                if isinstance(mixer, Mamba2):
                    u = torch.rand(mixer.dt_bias.shape, generator=generator)
                    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
                    dt = dt.clamp(min=1e-4)
                    mixer.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                    a = torch.rand(mixer.A_log.shape, generator=generator) * 15.0 + 1.0
                    mixer.A_log.copy_(torch.log(a))
                    mixer.norm.weight.fill_(1.0)
                else:
                    n = mixer.A_log.shape[1]
                    mixer.A_log.copy_(torch.log(torch.arange(1, n + 1.0)).expand_as(mixer.A_log))
        for lin in (self.final_layer.adaLN_modulation[1], self.final_layer.linear):
            lin.weight.zero_()
            lin.bias.zero_()
        return self

    def forward(
        self,
        x: torch.Tensor,  # (N, C, H, W) latent
        t: torch.Tensor,  # (N,)
        y: torch.Tensor,  # (N, D) BiomedCLIP CT embedding
        y2: torch.Tensor,  # (N, T, D) CT-encoder tokens
        w: torch.Tensor,  # (N, T, 1) CT-encoder soft mask
    ) -> torch.Tensor:
        x = self.x_embedder(x) + self.pos_embed.to(self.dtype)
        t_emb = self.t_embedder(t)
        y, y2, w = (v.to(self.dtype) for v in (y, y2, w))
        c = torch.cat([t_emb + y, t_emb + y2.mean(dim=1)], dim=1)  # (N, 2D)

        outputs = []
        for i, block in enumerate(self.blocks):
            if i == 0:
                inp = x
            elif i > self.depth / 2:
                inp = outputs[-1] + outputs[self.depth - i - 1]
            else:
                inp = outputs[-1]
            outputs.append(block(inp, c, w))
        return self.unpatchify(self.final_layer(outputs[-1], c))

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, p*p*C) -> (N, C, H, W)."""
        N = x.shape[0]
        p, c, h = self.patch_size, self.out_channels, self.grid_n
        x = x.reshape(N, h, h, p, p, c)
        x = torch.einsum("nhwpqc->nchpwq", x)
        return x.reshape(N, c, h * p, h * p)


_DEPTHS = {"XL": 28, "L": 16, "B": 8, "S": 4}


def _family(prefix: str, block_type: str, sizes: dict, extra: dict) -> dict:
    out = {f"{prefix}-{sz}/{p}": (depth, p, block_type)
           for sz, depth in sizes.items() for p in (2, 4, 7)}
    out.update({f"{prefix}-{name}": (depth, p, block_type) for name, (depth, p) in extra.items()})
    return out


#: name -> (depth, patch size, block type): the JAX package's 80 registry names.
DiffMa_models = {
    **_family("DiffMa", "spiral", {"XXL": 56, **_DEPTHS}, {}),
    **_family("ZigMa", "zig", _DEPTHS, {"BL/2": (13, 2)}),
    **_family("ViM", "vim", _DEPTHS, {"BL/2": (13, 2)}),
    **_family("VMamba", "vmamba", _DEPTHS, {"BL/2": (13, 2)}),
    **_family("EMamba", "efficientVMamba", _DEPTHS, {"BL/2": (13, 2)}),
    **_family("DiT", "DiT", _DEPTHS, {"SB/2": (7, 2)}),
}


def build_model(name: str, **kwargs) -> DiffMa:
    """Build a registry entry, e.g. ``build_model("ViM-B/2", input_size=28)``.

    ``hidden_size`` defaults to 512 and may be overridden (tests shrink it).
    An ``EMamba-`` name on an odd token grid raises ``ValueError``: the atrous
    streams need an even grid, in both packages and upstream.
    """
    if name not in DiffMa_models:
        raise KeyError(f"unknown model {name!r}")
    depth, patch, block_type = DiffMa_models[name]
    kwargs.setdefault("hidden_size", 512)
    return DiffMa(depth=depth, patch_size=patch, block_type=block_type, **kwargs)
