"""Carry weights from the JAX package's parameter trees to the port.

The trees are nested dicts of numpy arrays, as ``model.init(...)["params"]``
gives them after ``np.asarray``. The result is a ``state_dict`` for the
port's modules, with upstream key names. Layout changes:

* Flax ``Dense`` kernels are (in, out); torch ``Linear`` weights (out, in).
* ``PatchEmbed``'s kernel is (C*p*p, D) over channel-major patch vectors; the
  Conv2d weight is (D, C, p, p).
* The mixers' ``conv1d_weight`` is (channels, K); the depthwise Conv1d weight
  is (channels, 1, K). Mamba-2's ``norm_weight`` is ``norm.weight``.
* Flax ``Conv`` kernels are HWIO; torch Conv2d weights OIHW. The VAE's
  ``quant_conv`` and ``post_quant_conv`` are Flax ``Dense`` layers and 1x1
  Conv2d weights here.

The mapping changes layouts only, so it applies to a tree of JAX gradients as
well (``jax.grad`` of the same parameters) and gives them the port's
parameter names; the tests compare the two packages' gradients that way.
``adamw_state_from_optax`` puts AdamW's moments through it the same way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["adamw_state_from_optax", "clip_params_from_jax", "ct_encoder_params_from_jax",
           "diffma_params_from_jax", "vae_params_from_jax"]


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


def _patch_conv(out: dict, key: str, kernel, bias, channels: int) -> None:
    """A patchify matmul kernel (C*p*p, D) -> Conv2d weight (D, C, p, p)."""
    kernel = np.asarray(kernel)
    p = int(round((kernel.shape[0] // channels) ** 0.5))
    if channels * p * p != kernel.shape[0]:
        raise ValueError(f"patch kernel {kernel.shape} does not fit {channels} channels")
    out[f"{key}.weight"] = _t(kernel.T.reshape(-1, channels, p, p))
    out[f"{key}.bias"] = _t(bias)


def diffma_params_from_jax(
    params: Dict, depth: int, use_mamba2: bool = False, in_channels: int = 4
) -> Dict[str, torch.Tensor]:
    """JAX ``DiffMa`` params of any block family (Mamba-1 mixers, or Mamba-2
    with ``use_mamba2``) -> port ``DiffMa`` state dict, with upstream's key
    names (``blocks.{i}.mamba1``/``mamba2`` and ``attention_network`` in a
    Spiral block, ``blocks.{i}.mamba`` in the single-mixer families,
    ``blocks.{i}.attn.{qkv,proj}`` and ``mlp.{fc1,fc2}`` in DiT);
    ``in_channels`` is the model's latent channels."""
    out: Dict[str, torch.Tensor] = {}
    _patch_conv(out, "x_embedder.proj", params["x_embedder"]["kernel"],
                params["x_embedder"]["bias"], channels=in_channels)
    _linear(out, "t_embedder.mlp.0", params["t_embedder"]["fc1"])
    _linear(out, "t_embedder.mlp.2", params["t_embedder"]["fc2"])
    for i in range(depth):
        _block(out, f"blocks.{i}", params[f"block_{i}"], use_mamba2)
    _linear(out, "final_layer.adaLN_modulation.1", params["final_layer"]["adaLN"])
    _linear(out, "final_layer.linear", params["final_layer"]["linear"])
    return out


def adamw_state_from_optax(opt_state, param_names, depth: int, use_mamba2: bool = False,
                           in_channels: int = 4) -> Dict:
    """The JAX trainer's ``optax.adamw`` state, ``(ScaleByAdamState(count,
    mu, nu), EmptyState(), EmptyState())`` as numpy trees, -> a
    ``torch.optim.AdamW`` ``state_dict`` over ``param_names``, the port
    model's ``named_parameters()`` names in their order. ``mu`` and ``nu``
    have the parameters' tree and go through ``diffma_params_from_jax``
    (whose transposes and reshapes only move elements) to ``exp_avg`` and
    ``exp_avg_sq``; ``count``, the number of updates, is each parameter's
    ``step``, as a float32 scalar, torch's. ``param_groups`` holds the
    parameters' indices only: the hyperparameters are the trainer's."""
    adam = next((s for s in opt_state if all(hasattr(s, k) for k in ("count", "mu", "nu"))),
                None)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in this optimizer state")
    count, mu, nu = adam.count, adam.mu, adam.nu
    kw = dict(depth=depth, use_mamba2=use_mamba2, in_channels=in_channels)
    exp_avg, exp_avg_sq = diffma_params_from_jax(mu, **kw), diffma_params_from_jax(nu, **kw)
    names = list(param_names)
    if set(names) != set(exp_avg):
        raise KeyError(f"the optimizer state does not fit the model: missing "
                       f"{sorted(set(names) - set(exp_avg))}, unexpected "
                       f"{sorted(set(exp_avg) - set(names))}")
    step = float(np.asarray(count))
    state = {i: {"step": torch.tensor(step, dtype=torch.float32), "exp_avg": exp_avg[name],
                 "exp_avg_sq": exp_avg_sq[name]} for i, name in enumerate(names)}
    return {"state": state, "param_groups": [{"params": list(range(len(names)))}]}


def _resnet(out: dict, key: str, p: dict) -> None:
    _norm(out, f"{key}.norm1", p["norm1"])
    _conv(out, f"{key}.conv1", p["conv1"])
    _norm(out, f"{key}.norm2", p["norm2"])
    _conv(out, f"{key}.conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv(out, f"{key}.conv_shortcut", p["nin_shortcut"])


def _dense_as_conv(out: dict, key: str, p: dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
    out[f"{key}.bias"] = _t(p["bias"])


def _vae_attention(out: dict, key: str, attn: dict) -> None:
    _norm(out, f"{key}.group_norm", attn["norm"])
    for jax_name, torch_name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                                 ("proj_out", "to_out.0")):
        _linear(out, f"{key}.{torch_name}", attn[jax_name])


def _vae_mid(out: dict, key: str, tree: dict) -> None:
    _resnet(out, f"{key}.resnets.0", tree["mid_block_1"])
    _vae_attention(out, f"{key}.attentions.0", tree["mid_attn_1"])
    _resnet(out, f"{key}.resnets.1", tree["mid_block_2"])


def vae_params_from_jax(params: Dict, ch_mult=(1, 2, 4, 4)) -> Dict[str, torch.Tensor]:
    """JAX ``AutoencoderKL`` params -> the port's, in the diffusers key layout
    (``encoder.down_blocks.{l}`` is JAX level l, ``decoder.up_blocks.{k}``
    JAX level n-1-k). A tree without the encoder gives the decoder half."""
    out: Dict[str, torch.Tensor] = {}
    n = len(ch_mult)
    if "encoder" in params:
        enc = params["encoder"]
        _dense_as_conv(out, "quant_conv", params["quant_conv"])
        _conv(out, "encoder.conv_in", enc["conv_in"])
        for lvl in range(n):
            for b in range(2):  # num_res_blocks
                _resnet(out, f"encoder.down_blocks.{lvl}.resnets.{b}", enc[f"down_{lvl}_block_{b}"])
            if lvl != n - 1:
                _conv(out, f"encoder.down_blocks.{lvl}.downsamplers.0.conv",
                      enc[f"down_{lvl}_downsample"])
        _vae_mid(out, "encoder.mid_block", enc)
        _norm(out, "encoder.conv_norm_out", enc["norm_out"])
        _conv(out, "encoder.conv_out", enc["conv_out"])
    _dense_as_conv(out, "post_quant_conv", params["post_quant_conv"])
    dec = params["decoder"]
    _conv(out, "decoder.conv_in", dec["conv_in"])
    _vae_mid(out, "decoder.mid_block", dec)
    for k in range(n):
        lvl = n - 1 - k
        for b in range(3):  # num_res_blocks + 1
            _resnet(out, f"decoder.up_blocks.{k}.resnets.{b}", dec[f"up_{lvl}_block_{b}"])
        if lvl != 0:
            _conv(out, f"decoder.up_blocks.{k}.upsamplers.0.conv", dec[f"up_{lvl}_upsample"])
    _norm(out, "decoder.conv_norm_out", dec["norm_out"])
    _conv(out, "decoder.conv_out", dec["conv_out"])
    return out


def ct_encoder_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``CTEncoder`` params -> the port's, with the reference's key names
    (``vision_embedding.proj``, ``vision_embedding.mask_token``, ``fc.0``,
    ``fc.2``, ``norm``)."""
    out: Dict[str, torch.Tensor] = {}
    emb = params["vision_embedding"]
    _patch_conv(out, "vision_embedding.proj", emb["kernel"], emb["bias"], channels=4)
    if "mask_token" in emb:
        out["vision_embedding.mask_token"] = _t(emb["mask_token"])
    _linear(out, "fc.0", params["fc1"])
    _linear(out, "fc.2", params["fc2"])
    out["norm.weight"] = _t(params["norm_scale"])
    out["norm.bias"] = _t(params["norm_bias"])
    return out


def clip_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``VisionTransformer`` params -> the port's, with timm's trunk key
    names and ``head``."""
    out: Dict[str, torch.Tensor] = {}
    _patch_conv(out, "patch_embed.proj", params["patch_kernel"], params["patch_bias"],
                channels=3)
    out["cls_token"] = _t(params["cls_token"])
    out["pos_embed"] = _t(params["pos_embed"])
    depth = sum(1 for k in params if k.startswith("block_"))
    for i in range(depth):
        blk, key = params[f"block_{i}"], f"blocks.{i}"
        _norm(out, f"{key}.norm1", blk["norm1"])
        _linear(out, f"{key}.attn.qkv", blk["qkv"])
        _linear(out, f"{key}.attn.proj", blk["proj"])
        _norm(out, f"{key}.norm2", blk["norm2"])
        _linear(out, f"{key}.mlp.fc1", blk["mlp"]["fc1"])
        _linear(out, f"{key}.mlp.fc2", blk["mlp"]["fc2"])
    _norm(out, "norm", params["norm"])
    _linear(out, "head", params["head"])
    return out
