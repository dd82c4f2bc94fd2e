"""The DiffMa denoiser in plain PyTorch, over a dict of weights by name.

The architecture of upstream DiffMa (wongzbb/DiffMa-Diffusion-Mamba,
``model.py`` and ``block/``) as the port's modules compute it in fp32 at
commit 8e06284: patchify and 2-D sin-cos positions, a timestep MLP, c =
[t + y, t + mean(y2)], ``depth`` Spiral blocks with U-shaped long skips, an
adaLN final layer, unpatchify. A Spiral block modulates a LayerNorm of x
by adaLN, runs two mixers (the second on the tokens masked by w), mixes
their outputs by a learned per-token sigmoid weight and adds them through
a gate. A mixer is Mamba-1 (selective scan) or Mamba-2 (SSD), each over
the layer's three scan streams, merged back in token order.

The scans are the recurrences themselves, one step after another, in fp32
(no chunks, no kernels). Products go through ``Products`` (fp32; TF32 for
the control). Weight names are the port's state-dict names, which are
upstream's. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.products import Products
from benchmark.reference.scan_orders import spiral_spec

__all__ = ["Denoiser", "pos_embed"]

Weights = Dict[str, torch.Tensor]


def pos_embed(dim: int, grid_n: int) -> np.ndarray:
    """(grid_n², dim) fixed 2-D sin-cos table (upstream's, w coordinate first)."""
    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid_n, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g), axis=0).reshape(2, 1, grid_n, grid_n)
    return np.concatenate([one_d(dim // 2, grid[0]), one_d(dim // 2, grid[1])],
                          axis=1).astype(np.float32)


def _layer_norm(x, w=None, b=None, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w + b
    return y


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv_silu(x, w, b):
    """x (G, L, C), w (C, 1, K): depthwise causal conv with zero left pad, SiLU."""
    K, L = w.shape[-1], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, k:k + L] * w[:, 0, k] for k in range(K)) + b
    return F.silu(y)


class Denoiser:
    """DiffMa over the weights ``w`` (fp32 tensors by name) for a config
    dict: ``hidden_size``, ``depth``, ``patch_size``, ``latent_size``,
    ``in_channels``, ``d_state``, ``mixer`` ("mamba1" or "mamba2") and,
    for Mamba-2, ``headdim``."""

    def __init__(self, cfg: dict, w: Weights, products: Products):
        self.cfg, self.w, self.p = cfg, w, products
        dev = next(iter(w.values())).device
        self.grid_n = cfg["latent_size"] // cfg["patch_size"]
        self.tables = [tuple(torch.as_tensor(t.reshape(-1), device=dev)
                             for t in spiral_spec(self.grid_n, i)) for i in range(cfg["depth"])]
        self.pos = torch.as_tensor(pos_embed(cfg["hidden_size"], self.grid_n), device=dev)

    def __call__(self, x, t, y, y2, w_mask, mixer_wrap=None) -> torch.Tensor:
        """x (N, C, H, W), t (N,), y (N, D), y2 (N, T, D), w_mask (N, T, 1) ->
        (N, 2C, H, W). ``mixer_wrap(fn, *args)`` runs each mixer call (the
        training reference recomputes them in the backward)."""
        W, P, cfg = self.w, self.p, self.cfg
        run = mixer_wrap or (lambda fn, *a: fn(*a))
        N, C, H, _ = x.shape
        p, D, depth = cfg["patch_size"], cfg["hidden_size"], cfg["depth"]
        gh = H // p
        patches = x.reshape(N, C, gh, p, gh, p).permute(0, 2, 4, 1, 3, 5).reshape(N, gh * gh, -1)
        h = P.linear(patches, W["x_embedder.proj.weight"].reshape(D, -1),
                     W["x_embedder.proj.bias"]) + self.pos
        half = 128
        freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                          device=x.device) / half)
        args = t.float()[:, None] * freqs[None]
        temb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        temb = P.linear(F.silu(P.linear(temb, W["t_embedder.mlp.0.weight"],
                                        W["t_embedder.mlp.0.bias"])),
                        W["t_embedder.mlp.2.weight"], W["t_embedder.mlp.2.bias"])
        c = torch.cat([temb + y, temb + y2.mean(dim=1)], dim=1)
        outs = []
        for i in range(depth):
            if i == 0:
                inp = h
            elif i > depth / 2:
                inp = outs[-1] + outs[depth - i - 1]
            else:
                inp = outs[-1]
            outs.append(self._block(i, inp, c, w_mask, run))
        pre = "final_layer."
        shift, scale = P.linear(F.silu(c), W[pre + "adaLN_modulation.1.weight"],
                                W[pre + "adaLN_modulation.1.bias"]).chunk(2, dim=-1)
        o = _layer_norm(outs[-1]) * (1 + scale[:, None]) + shift[:, None]
        o = P.linear(o, W[pre + "linear.weight"], W[pre + "linear.bias"])
        co = o.shape[-1] // (p * p)
        o = o.reshape(N, gh, gh, p, p, co)
        return torch.einsum("nhwpqc->nchpwq", o).reshape(N, co, gh * p, gh * p)

    def _block(self, i, x, c, w_mask, run):
        W, P = self.w, self.p
        pre = f"blocks.{i}."
        shift, scale, gate = P.linear(F.silu(c), W[pre + "adaLN_modulation.1.weight"],
                                      W[pre + "adaLN_modulation.1.bias"]).chunk(3, dim=-1)
        xm = _layer_norm(x, W[pre + "norm1.weight"], W[pre + "norm1.bias"], 1e-5)
        xm = xm * (1 + scale[:, None]) + shift[:, None]
        mixer = self.mamba1 if self.cfg["mixer"] == "mamba1" else self.mamba2
        o0 = run(mixer, i, pre + "mamba1.", xm)
        o1 = run(mixer, i, pre + "mamba2.", xm * w_mask)
        an = pre + "attention_network."
        hh = _layer_norm(torch.cat([o0, o1], dim=-1), W[an + "0.weight"], W[an + "0.bias"], 1e-5)
        hh = F.silu(P.linear(hh, W[an + "1.weight"], W[an + "1.bias"]))
        alpha = torch.sigmoid(P.linear(hh, W[an + "3.weight"], W[an + "3.bias"]))
        return x + gate[:, None] * (alpha * o0 + (1 - alpha) * o1)

    def _streams(self, i, x):
        fwd, _ = self.tables[i]
        B_, L, _ = x.shape
        return x.index_select(1, fwd).reshape(B_ * 3, L, -1)

    def _merge(self, i, y, B_):
        _, merge = self.tables[i]
        L, d = merge.shape[0] // 3, y.shape[-1]
        return y.reshape(B_, 3 * L, d).index_select(1, merge).reshape(B_, L, 3, d).sum(dim=2)

    def mamba1(self, i, pre, x):
        """Mamba-1: in_proj, conv, x_proj, dt_proj, the selective scan gated
        by SiLU(z), merge, out_proj."""
        W, P = self.w, self.p
        B_ = x.shape[0]
        A_log = W[pre + "A_log"]
        d, n = A_log.shape
        r = W[pre + "dt_proj.weight"].shape[1]
        xz = P.linear(self._streams(i, x), W[pre + "in_proj.weight"])
        u, z = xz.split(d, dim=-1)
        u = _causal_conv_silu(u, W[pre + "conv1d.weight"], W[pre + "conv1d.bias"])
        dt_r, Bm, Cm = P.linear(u, W[pre + "x_proj.weight"]).split([r, n, n], dim=-1)
        dt = _softplus(P.linear(dt_r, W[pre + "dt_proj.weight"], W[pre + "dt_proj.bias"]))
        dA = torch.exp(dt[..., None] * -torch.exp(A_log))  # (G, L, d, n)
        dBu = (dt * u)[..., None] * Bm[:, :, None, :]
        h = torch.zeros_like(dA[:, 0])
        hs = []
        for t in range(dA.shape[1]):
            h = dA[:, t] * h + dBu[:, t]
            hs.append(h)
        hs = torch.stack(hs, dim=1)
        G, L = hs.shape[:2]
        y = P.matmul(hs, Cm[..., None].expand(G, L, n, 1).contiguous())[..., 0]
        y = (y + u * W[pre + "D"]) * F.silu(z)
        return P.linear(self._merge(i, y, B_), W[pre + "out_proj.weight"])

    def mamba2(self, i, pre, x):
        """Mamba-2: in_proj to [z | x B C | dt], conv over x B C, the SSD
        recurrence with one scalar decay per head, the gated RMSNorm,
        merge, out_proj."""
        W, P = self.w, self.p
        B_ = x.shape[0]
        d = W[pre + "norm.weight"].shape[0]
        H = W[pre + "A_log"].shape[0]
        n = (W[pre + "conv1d.weight"].shape[0] - d) // 2
        hd = d // H
        zx = P.linear(self._streams(i, x), W[pre + "in_proj.weight"])
        z, xbc, dt = zx.split([d, d + 2 * n, H], dim=-1)
        xbc = _causal_conv_silu(xbc, W[pre + "conv1d.weight"], W[pre + "conv1d.bias"])
        xs, Bm, Cm = xbc.split([d, n, n], dim=-1)
        G, L = xs.shape[:2]
        xs = xs.reshape(G, L, H, hd)
        dt = _softplus(dt + W[pre + "dt_bias"]).clamp(min=0.0)  # dt_limit (0, inf)
        dA = torch.exp(dt * -torch.exp(W[pre + "A_log"]))  # (G, L, H)
        dBx = (dt[..., None] * xs)[..., None] * Bm[:, :, None, None, :]  # (G, L, H, hd, n)
        s = torch.zeros_like(dBx[:, 0])
        ss = []
        for t in range(L):
            s = dA[:, t, :, None, None] * s + dBx[:, t]
            ss.append(s)
        ss = torch.stack(ss, dim=1)
        y = P.matmul(ss, Cm[:, :, None, :, None].expand(G, L, H, n, 1).contiguous())[..., 0]
        y = (y + W[pre + "D"][:, None] * xs).reshape(G, L, d)
        g = y * F.silu(z)
        y = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + 1e-5) * W[pre + "norm.weight"]
        return P.linear(self._merge(i, y, B_), W[pre + "out_proj.weight"])
