"""Carry weights from the JAX package's parameter trees to the port.

The trees are nested dicts of numpy arrays, as ``model.init(...)["params"]``
gives them after ``np.asarray``. The result is a ``state_dict`` for the
port's modules, with upstream key names. Layout changes:

* Flax ``Dense`` kernels are (in, out); torch ``Linear`` weights (out, in).
* ``PatchEmbed``'s kernel is (C*p*p, D) over channel-major patch vectors; the
  Conv2d weight is (D, C, p, p).
* The mixers' ``conv1d_weight`` is (channels, K); the depthwise Conv1d weight
  is (channels, 1, K). Mamba-2's ``norm_weight`` is ``norm.weight``.
* Flax ``Conv`` kernels are HWIO; torch Conv2d weights OIHW.

The mapping changes layouts only, so it applies to a tree of JAX gradients as
well (``jax.grad`` of the same parameters) and gives them the port's
parameter names; the tests compare the two packages' gradients that way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["diffma_params_from_jax", "vae_params_from_jax"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(out: dict, key: str, p: dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _norm(out: dict, key: str, p: dict) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def _conv(out: dict, key: str, p: dict) -> None:
    out[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    out[f"{key}.bias"] = _t(p["bias"])


def _mamba1(out: dict, key: str, p: dict) -> None:
    _linear(out, f"{key}.in_proj", p["in_proj"])
    out[f"{key}.conv1d.weight"] = _t(np.asarray(p["conv1d_weight"])[:, None, :])
    out[f"{key}.conv1d.bias"] = _t(p["conv1d_bias"])
    _linear(out, f"{key}.x_proj", p["x_proj"])
    _linear(out, f"{key}.dt_proj", p["dt_proj"])
    out[f"{key}.A_log"] = _t(p["A_log"])
    out[f"{key}.D"] = _t(p["D"])
    _linear(out, f"{key}.out_proj", p["out_proj"])


def _mamba2(out: dict, key: str, p: dict) -> None:
    _linear(out, f"{key}.in_proj", p["in_proj"])
    out[f"{key}.conv1d.weight"] = _t(np.asarray(p["conv1d_weight"])[:, None, :])
    out[f"{key}.conv1d.bias"] = _t(p["conv1d_bias"])
    out[f"{key}.dt_bias"] = _t(p["dt_bias"])
    out[f"{key}.A_log"] = _t(p["A_log"])
    out[f"{key}.D"] = _t(p["D"])
    out[f"{key}.norm.weight"] = _t(p["norm_weight"])
    _linear(out, f"{key}.out_proj", p["out_proj"])


def _spiral_block(out: dict, key: str, blk: dict, use_mamba2: bool = False) -> None:
    mixer = _mamba2 if use_mamba2 else _mamba1
    _linear(out, f"{key}.adaLN_modulation.1", blk["adaLN"]["fc"])
    _norm(out, f"{key}.norm1", blk["norm1"])
    mixer(out, f"{key}.mamba1", blk["mamba1"])
    mixer(out, f"{key}.mamba2", blk["mamba2"])
    _norm(out, f"{key}.attention_network.0", blk["attn_norm"])
    _linear(out, f"{key}.attention_network.1", blk["attn_fc1"])
    _linear(out, f"{key}.attention_network.3", blk["attn_fc2"])


def _single_mixer_block(out: dict, key: str, blk: dict, use_mamba2: bool = False) -> None:
    """A Zig, ViM, VMamba or EfficientVMamba block: one mixer, ``mamba``."""
    _linear(out, f"{key}.adaLN_modulation.1", blk["adaLN"]["fc"])
    _norm(out, f"{key}.norm1", blk["norm1"])
    (_mamba2 if use_mamba2 else _mamba1)(out, f"{key}.mamba", blk["mamba"])


def _dit_block(out: dict, key: str, blk: dict) -> None:
    """A DiT block; its LayerNorms have no parameters."""
    _linear(out, f"{key}.adaLN_modulation.1", blk["adaLN"]["fc"])
    _linear(out, f"{key}.attn.qkv", blk["attn"]["qkv"])
    _linear(out, f"{key}.attn.proj", blk["attn"]["proj"])
    _linear(out, f"{key}.mlp.fc1", blk["mlp_fc1"])
    _linear(out, f"{key}.mlp.fc2", blk["mlp_fc2"])


def _block(out: dict, key: str, blk: dict, use_mamba2: bool = False) -> None:
    """One block of any family, told apart by what its tree holds."""
    if "attn" in blk:
        _dit_block(out, key, blk)
    elif "mamba" in blk:
        _single_mixer_block(out, key, blk, use_mamba2)
    else:
        _spiral_block(out, key, blk, use_mamba2)


def diffma_params_from_jax(
    params: Dict, depth: int, use_mamba2: bool = False
) -> Dict[str, torch.Tensor]:
    """JAX ``DiffMa`` params of any block family (Mamba-1 mixers, or Mamba-2
    with ``use_mamba2``) -> port ``DiffMa`` state dict, with upstream's key
    names (``blocks.{i}.mamba1``/``mamba2`` and ``attention_network`` in a
    Spiral block, ``blocks.{i}.mamba`` in the single-mixer families,
    ``blocks.{i}.attn.{qkv,proj}`` and ``mlp.{fc1,fc2}`` in DiT)."""
    out: Dict[str, torch.Tensor] = {}
    kernel = np.asarray(params["x_embedder"]["kernel"])  # (C*p*p, D), C = 4
    p = int(round((kernel.shape[0] // 4) ** 0.5))
    if 4 * p * p != kernel.shape[0]:
        raise ValueError(f"patch kernel {kernel.shape} does not fit 4 latent channels")
    out["x_embedder.proj.weight"] = _t(kernel.T.reshape(-1, 4, p, p))
    out["x_embedder.proj.bias"] = _t(params["x_embedder"]["bias"])
    _linear(out, "t_embedder.mlp.0", params["t_embedder"]["fc1"])
    _linear(out, "t_embedder.mlp.2", params["t_embedder"]["fc2"])
    for i in range(depth):
        _block(out, f"blocks.{i}", params[f"block_{i}"], use_mamba2)
    _linear(out, "final_layer.adaLN_modulation.1", params["final_layer"]["adaLN"])
    _linear(out, "final_layer.linear", params["final_layer"]["linear"])
    return out


def _resnet(out: dict, key: str, p: dict) -> None:
    _norm(out, f"{key}.norm1", p["norm1"])
    _conv(out, f"{key}.conv1", p["conv1"])
    _norm(out, f"{key}.norm2", p["norm2"])
    _conv(out, f"{key}.conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv(out, f"{key}.conv_shortcut", p["nin_shortcut"])


def vae_params_from_jax(params: Dict, ch_mult=(1, 2, 4, 4)) -> Dict[str, torch.Tensor]:
    """JAX ``AutoencoderKL`` params -> the port's decoder half, in the
    diffusers key layout (``decoder.up_blocks.{k}`` is JAX level n-1-k)."""
    out: Dict[str, torch.Tensor] = {}
    pq = np.asarray(params["post_quant_conv"]["kernel"])  # Dense (z, z)
    out["post_quant_conv.weight"] = _t(pq.T[:, :, None, None])
    out["post_quant_conv.bias"] = _t(params["post_quant_conv"]["bias"])
    dec = params["decoder"]
    _conv(out, "decoder.conv_in", dec["conv_in"])
    _resnet(out, "decoder.mid_block.resnets.0", dec["mid_block_1"])
    attn = dec["mid_attn_1"]
    a = "decoder.mid_block.attentions.0"
    _norm(out, f"{a}.group_norm", attn["norm"])
    for jax_name, torch_name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                                 ("proj_out", "to_out.0")):
        _linear(out, f"{a}.{torch_name}", attn[jax_name])
    _resnet(out, "decoder.mid_block.resnets.1", dec["mid_block_2"])
    n = len(ch_mult)
    for k in range(n):
        lvl = n - 1 - k
        for b in range(3):  # num_res_blocks + 1
            _resnet(out, f"decoder.up_blocks.{k}.resnets.{b}", dec[f"up_{lvl}_block_{b}"])
        if lvl != 0:
            _conv(out, f"decoder.up_blocks.{k}.upsamplers.0.conv", dec[f"up_{lvl}_upsample"])
    _norm(out, "decoder.conv_norm_out", dec["norm_out"])
    _conv(out, "decoder.conv_out", dec["conv_out"])
    return out
