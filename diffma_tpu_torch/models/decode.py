"""Incremental (single-token) decode for the Mamba mixers.

Counterpart of ``diffma_tpu/models/decode.py``: the reference's
``Mamba.step`` / ``allocate_inference_cache`` (block/mamba.py:405-471) and
``Mamba2.step`` / ``allocate_inference_cache`` (block/mamba2.py:714-795) as
plain functions over an explicit cache. A step returns a new ``MixerCache``
and changes nothing it was given, so one step can be captured as a CUDA
graph whose static cache buffers the caller copies each step's cache into.

The step functions take the port's mixer, a ``Mamba`` / ``Mamba2`` module
or its ``weights()`` tuple (``MixerWeights`` / ``Mamba2Weights``), so a
trained checkpoint decodes as it is:

    cache = allocate_mamba_cache(B, d_inner=1024, device="cuda")
    y, cache = mamba_step(mixer, x_t, cache)   # x_t (B, d_model)

Iterating ``*_step`` over a sequence gives the full forward with an identity
scan order (``tests/test_torch_decode.py``); decode is defined for the
causal raster order only, as upstream. The arithmetic is x_t's dtype at the
products and fp32 in the conv, the state and the norm, as in JAX. Plain
PyTorch operators: none of this is a kernel in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.ops.conv import causal_conv1d_update
from diffma_tpu_torch.ops.fused_mixer import MixerWeights
from diffma_tpu_torch.ops.fused_ssd import Mamba2Weights
from diffma_tpu_torch.ops.norm import rms_norm_gated
from diffma_tpu_torch.ops.selective_scan import selective_state_update
from diffma_tpu_torch.ops.ssd import ssd_state_update

__all__ = [
    "MixerCache",
    "allocate_mamba2_cache",
    "allocate_mamba_cache",
    "mamba2_step",
    "mamba_step",
]


class MixerCache(NamedTuple):
    """One mixer's decode state: the rolling conv window and the SSM state (fp32)."""

    conv_state: torch.Tensor  # (B, K, conv channels), oldest first
    ssm_state: torch.Tensor  # Mamba-1: (B, d_inner, n); Mamba-2: (B, H, P, N)


def allocate_mamba_cache(
    batch: int, d_inner: int, d_conv: int = 4, d_state: int = 16,
    dtype: torch.dtype = torch.float32, *, device,
) -> MixerCache:
    """Mamba-1's zero cache (block/mamba.py:461-471) on ``device``."""
    return MixerCache(
        conv_state=torch.zeros(batch, d_conv, d_inner, dtype=dtype, device=device),
        ssm_state=torch.zeros(batch, d_inner, d_state, dtype=torch.float32, device=device),
    )


def allocate_mamba2_cache(
    batch: int, d_inner: int, d_conv: int = 4, d_state: int = 16, headdim: int = 64,
    ngroups: int = 1, dtype: torch.dtype = torch.float32, *, device,
) -> MixerCache:
    """Mamba-2's zero cache (block/mamba2.py:782-795) on ``device``."""
    conv_dim = d_inner + 2 * ngroups * d_state
    return MixerCache(
        conv_state=torch.zeros(batch, d_conv, conv_dim, dtype=dtype, device=device),
        ssm_state=torch.zeros(batch, d_inner // headdim, headdim, d_state,
                              dtype=torch.float32, device=device),
    )


def mamba_step(
    mixer: Union[Mamba, MixerWeights], x_t: torch.Tensor, cache: MixerCache
) -> Tuple[torch.Tensor, MixerCache]:
    """One Mamba-1 decode step (block/mamba.py:405-459); x_t (B, d_model)."""
    w = mixer.weights() if isinstance(mixer, Mamba) else mixer
    cd = x_t.dtype
    # Each product casts its weight to x_t's dtype (diffma_tpu/models/decode.py:83,91,104).
    x, z = F.linear(x_t, w.in_w.to(cd)).chunk(2, dim=-1)
    x, conv_state = causal_conv1d_update(x, cache.conv_state, w.conv_w[:, 0, :], w.conv_b)
    n = w.A_log.shape[1]
    r = w.dt_w.shape[1]
    dt_r, B, C = F.linear(x, w.xp_w.to(cd)).split([r, n, n], dim=-1)
    # dt_proj's weight without its bias, in fp32; the bias goes into the state
    # update's softplus (diffma_tpu/models/decode.py:95-103).
    dt = F.linear(dt_r.float(), w.dt_w.float())
    A = -torch.exp(w.A_log.float())
    y, ssm_state = selective_state_update(
        cache.ssm_state, x, dt, A, B, C, w.D, z=z, dt_bias=w.dt_b, dt_softplus=True,
    )
    return F.linear(y, w.out_w.to(y.dtype)), MixerCache(conv_state, ssm_state)


def mamba2_step(
    mixer: Union[Mamba2, Mamba2Weights], x_t: torch.Tensor, cache: MixerCache
) -> Tuple[torch.Tensor, MixerCache]:
    """One Mamba-2 (SSD) decode step (block/mamba2.py:714-780); x_t (B, d_model).

    The head width and the group count come from the weights' and the
    cache's shapes; the norm's eps is a ``Mamba2`` module's own, 1e-5 for a
    weights tuple (JAX's default). No ``dt_limit`` clip: the JAX step applies
    none, so the step agrees with a full forward only at the default limit
    (0, inf).
    """
    if isinstance(mixer, Mamba2):
        w, eps = mixer.weights(), mixer.norm_eps
    else:
        w, eps = mixer, 1e-5
    H = w.A_log.shape[0]
    cd = x_t.dtype
    zxbcdt = F.linear(x_t, w.in_w.to(cd))
    conv_dim = cache.conv_state.shape[-1]
    d_in = zxbcdt.shape[-1] - H - conv_dim
    n = cache.ssm_state.shape[-1]
    ngroups = (conv_dim - d_in) // (2 * n)
    if ngroups != 1:  # diffma_tpu/models/decode.py:114
        raise ValueError(f"the Mamba-2 decode step takes one group, not ngroups={ngroups}")
    # [z | xBC | dt] (diffma_tpu/models/decode.py:116-121)
    z, xBC, dt = zxbcdt.split([d_in, conv_dim, H], dim=-1)
    xBC, conv_state = causal_conv1d_update(xBC, cache.conv_state, w.conv_w[:, 0, :], w.conv_b)
    x, B, C = xBC.split([d_in, n, n], dim=-1)
    A = -torch.exp(w.A_log.float())
    y, ssm_state = ssd_state_update(
        cache.ssm_state, x.reshape(x.shape[0], H, d_in // H), dt, A, B, C, w.D,
        dt_bias=w.dt_bias, dt_softplus=True,
    )
    y = rms_norm_gated(y.reshape(x.shape[0], d_in), w.norm_w, z, eps=eps,
                       group_size=d_in, norm_before_gate=False)
    return F.linear(y, w.out_w.to(y.dtype)), MixerCache(conv_state, ssm_state)
