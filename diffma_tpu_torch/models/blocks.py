"""The six DiffMa backbone blocks.

Counterpart of ``diffma_tpu/models/blocks.py``. Every block is called as
``block(x, c, w)`` and modulates with adaLN-Zero from the conditioning vector
c (N, 2D), so it is the identity while its adaLN layer is zero.

``SpiralMambaBlock``: adaLN-Zero modulation from the conditioning vector c (N, 2D), two mixer branches
(Mamba-1, or Mamba-2 with ``use_mamba2``) where the second sees the
soft-masked tokens ``x_mod * w``, mixed by a learned per-token sigmoid
weight, and a gated residual. Three routes, as in the JAX block:

* ``fuse_block`` with ``use_mamba2`` and ``scan_impl="fused"``: the whole
  block in one call of ``spiral_block_fused`` (on the card kernel E in
  prologue mode and kernel G; its backward recomputes the block through the
  next route, so it is the inference route);
* ``scan_impl="fused"``: both branches in one call of the fused mixer
  (Mamba-1: kernel C, and kernel D in the backward; Mamba-2: kernel E, and
  kernel F in the backward);
* otherwise, and always under a mesh (``mesh``, ``tp_axis``, ``sp_axis``,
  which every Mamba block hands to its mixers), each mixer runs its own
  path.

Parameter names follow upstream DiffMa's ``block/mamba_block.py``
(``adaLN_modulation.1``, ``norm1``, ``mamba1``, ``mamba2``,
``attention_network.{0,1,3}``) on every route.

``ZigMambaBlock``, ``ViMMambaBlock``, ``VMambaMambaBlock`` and
``EfficientVMambaBlock`` are one shape (``_SingleMixerBlock``): adaLN with
three outputs, an affine LayerNorm at eps 1e-5, one mixer named ``mamba``
(Mamba-1 or Mamba-2) over the family's scan spec, and a gated residual. They
drop the soft mask ``w``. The mixer takes its own route from ``scan_impl``
(``models/mamba.py``, ``models/mamba2.py``).

``DiTBlock`` is the attention baseline: adaLN with six outputs, LayerNorms
without affine at eps 1e-6, 8-head attention with a qkv bias and an MLP of
ratio 4 with the tanh GELU. It drops ``w`` and has no scan spec. Attention
is torch operators, as it is plain ``einsum`` in the JAX package. Parameter
names are upstream's (``attn.{qkv,proj}``, ``mlp.{fc1,fc2}``).

Every block takes the compute dtype ``dtype``, as its Flax module: the
parameters stay fp32, each ``Dense`` runs in ``dtype`` (``layers.dense``),
the LayerNorms keep fp32 statistics and return their input's dtype, the
attention's softmax runs in fp32, and the residual stream keeps x's dtype.
The Mamba-2 Spiral block casts the mixers' inputs to ``dtype`` on its dual
route and x on its ``fuse_block`` route, as the JAX block does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffma_tpu_torch.models.layers import dense, modulate
from diffma_tpu_torch.models.mamba import Mamba, check_scan_impl
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.ops.fused_mixer import mamba_dual_mixer_fused
from diffma_tpu_torch.ops.fused_ssd import mamba2_dual_mixer_fused, spiral_block_fused
from diffma_tpu_torch.ops.norm import layer_norm
from diffma_tpu_torch.ops.scan_orders import ScanSpec

__all__ = [
    "BLOCKS",
    "DiTBlock",
    "EfficientVMambaBlock",
    "SpiralMambaBlock",
    "ViMMambaBlock",
    "VMambaMambaBlock",
    "ZigMambaBlock",
]


def _mixer(hidden, spec, d_state, scan_impl, use_mamba2, dtype, mesh=None, tp_axis=None,
           sp_axis=None):
    mixer = Mamba2 if use_mamba2 else Mamba
    return mixer(hidden, spec, d_state=d_state, scan_impl=scan_impl, dtype=dtype, mesh=mesh,
                 tp_axis=tp_axis, sp_axis=sp_axis)


def _adaln(block: nn.Module, c: torch.Tensor, k: int):
    """The block's adaLN modulation in its dtype, split into k parts."""
    mod = dense(block.adaLN_modulation[1], F.silu(c.to(block.dtype)), block.dtype)
    return mod.chunk(k, dim=-1)


class SpiralMambaBlock(nn.Module):
    def __init__(
        self,
        hidden: int,
        spec: ScanSpec,
        d_state: int = 16,
        scan_impl: str = "auto",
        use_mamba2: bool = False,
        fuse_block: bool = False,
        dtype: torch.dtype = torch.float32,
        mesh=None,
        tp_axis=None,
        sp_axis=None,
    ):
        super().__init__()
        self.spec = spec
        self.scan_impl = check_scan_impl(scan_impl)
        self.use_mamba2 = bool(use_mamba2)
        self.fuse_block = bool(fuse_block)
        self.dtype = dtype
        self.mesh = mesh
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(2 * hidden, 3 * hidden))
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.mamba1, self.mamba2 = (
            _mixer(hidden, spec, d_state, scan_impl, use_mamba2, dtype, mesh, tp_axis, sp_axis)
            for _ in range(2))
        self.attention_network = nn.Sequential(
            nn.LayerNorm(2 * hidden, eps=1e-5),
            nn.Linear(2 * hidden, hidden),
            nn.SiLU(),
            nn.Linear(hidden, 1),
        )

    def mixers(self):
        return (self.mamba1, self.mamba2)

    def forward(self, x: torch.Tensor, c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = _adaln(self, c, 3)
        # under a mesh neither fused route runs: each branch calls its own
        # mixer (diffma_tpu/models/blocks.py:134,166)
        fused = check_scan_impl(self.scan_impl) == "fused" and self.mesh is None
        an, fc1, _, fc2 = self.attention_network
        m1, m2 = self.mamba1, self.mamba2
        if self.fuse_block and self.use_mamba2 and fused:
            return spiral_block_fused(
                self.spec, x.to(self.dtype), w.to(self.dtype), shift, scale, gate,
                self.norm1.weight, self.norm1.bias,
                an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias,
                m1.weights(), m2.weights(), m1.dt_limit, m1.norm_eps,
            )
        x_mod = modulate(
            layer_norm(x, self.norm1.weight, self.norm1.bias, eps=self.norm1.eps),
            shift, scale,
        )
        w_in = x_mod * w  # soft mask from the CT encoder
        if fused and self.use_mamba2:
            x_ssm, w_ssm = mamba2_dual_mixer_fused(
                self.spec, x_mod.to(self.dtype), w_in.to(self.dtype), m1.weights(), m2.weights(),
                m1.dt_limit, m1.norm_eps, m1.chunk_size,
            )
        elif fused:
            x_ssm, w_ssm = mamba_dual_mixer_fused(
                self.spec, x_mod.to(self.dtype), w_in.to(self.dtype), m1.weights(), m2.weights()
            )
        else:
            x_ssm = m1(x_mod)
            w_ssm = m2(w_in)

        h = layer_norm(torch.cat([x_ssm, w_ssm], dim=-1), an.weight, an.bias, eps=an.eps)
        alpha = torch.sigmoid(dense(fc2, F.silu(dense(fc1, h, self.dtype)), self.dtype))
        mixed = alpha * x_ssm + (1.0 - alpha) * w_ssm
        return x + gate[:, None, :] * mixed


class _SingleMixerBlock(nn.Module):
    """The shape that the Zig, ViM, VMamba and EfficientVMamba blocks share."""

    def __init__(
        self,
        hidden: int,
        spec: ScanSpec,
        d_state: int = 16,
        scan_impl: str = "auto",
        use_mamba2: bool = False,
        dtype: torch.dtype = torch.float32,
        mesh=None,
        tp_axis=None,
        sp_axis=None,
    ):
        super().__init__()
        self.spec = spec
        self.scan_impl = check_scan_impl(scan_impl)
        self.use_mamba2 = bool(use_mamba2)
        self.dtype = dtype
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(2 * hidden, 3 * hidden))
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.mamba = _mixer(hidden, spec, d_state, scan_impl, use_mamba2, dtype, mesh, tp_axis,
                            sp_axis)

    def mixers(self):
        return (self.mamba,)

    def forward(self, x: torch.Tensor, c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        del w  # only the Spiral block reads the soft mask
        shift, scale, gate = _adaln(self, c, 3)
        x_mod = modulate(
            layer_norm(x, self.norm1.weight, self.norm1.bias, eps=self.norm1.eps),
            shift, scale,
        )
        return x + gate[:, None, :] * self.mamba(x_mod)


class ZigMambaBlock(_SingleMixerBlock):
    pass


class ViMMambaBlock(_SingleMixerBlock):
    pass


class VMambaMambaBlock(_SingleMixerBlock):
    pass


class EfficientVMambaBlock(_SingleMixerBlock):
    pass


class _Attention(nn.Module):
    """Multi-head self-attention with a qkv bias; the softmax runs in fp32."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H = self.num_heads
        q, k, v = dense(self.qkv, x, self.dtype).reshape(B, L, 3, H, D // H).permute(2, 0, 3, 1, 4)
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D // H)
        att = torch.softmax(att.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", att, v)
        return dense(self.proj, out.transpose(1, 2).reshape(B, L, D), self.dtype)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(dense(self.fc1, x, self.dtype), approximate="tanh")
        return dense(self.fc2, h, self.dtype)


class DiTBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(2 * hidden, 6 * hidden))
        self.attn = _Attention(hidden, num_heads, dtype)
        self.mlp = _Mlp(hidden, int(hidden * mlp_ratio), dtype)

    def mixers(self):
        return ()

    def forward(self, x: torch.Tensor, c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        del w
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = _adaln(self, c, 6)
        x = x + g_msa[:, None, :] * self.attn(modulate(layer_norm(x, eps=1e-6), s_msa, sc_msa))
        return x + g_mlp[:, None, :] * self.mlp(modulate(layer_norm(x, eps=1e-6), s_mlp, sc_mlp))


#: ``block_type`` -> block class, with the JAX package's names.
BLOCKS = {
    "spiral": SpiralMambaBlock,
    "zig": ZigMambaBlock,
    "vim": ViMMambaBlock,
    "vmamba": VMambaMambaBlock,
    "efficientVMamba": EfficientVMambaBlock,
    "DiT": DiTBlock,
}
