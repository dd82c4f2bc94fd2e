"""Weight files for the conditioning stack and reference checkpoints.

Counterpart of ``diffma_tpu/utils/torch_io.py``. Upstream's checkpoints are
torch pickles ``{"model", "ema", "opt", "args"}`` whose ``args`` is an
OmegaConf object, a class that may not be importable here.
``load_torch_checkpoint`` unpickles tensors, containers and a few plain
classes (below), and turns every other class into an inert stub: nothing in
the file can name a function for the unpickler to call.

The loaders give the port's modules their state dicts:

* ``ct_encoder_state_dict``: a reference CT-encoder checkpoint's
  ``load_ckpt_type`` sub-dict ("ema" by default), the key names as they are;
* ``vae_state_dict``: a diffusers ``AutoencoderKL`` state dict, optionally
  under ``"state_dict"``, with ``module.`` prefixes, the legacy attention
  names (``query``, ``key``, ``value``, ``proj_attn``) and their 1x1-conv
  weights, or CompVis's ``nin_shortcut``;
* ``clip_state_dict``: open_clip's ``visual.trunk.*`` and ``visual.head.*``,
  or a stripped trunk, the head as ``head`` or ``head.proj``;
* ``load_weights``: a torch file through the loader of its kind, any other
  file through ``np.load(...).item()`` as a JAX parameter tree and
  ``utils/convert.py``, as the JAX package's ``Conditioning`` reads them.
"""

from __future__ import annotations

import argparse
import collections
import pickle
from typing import Any, Dict

import numpy as np
import torch

from diffma_tpu_torch.utils import convert

__all__ = ["TORCH_SUFFIXES", "clip_state_dict", "ct_encoder_state_dict", "load_torch_checkpoint",
           "load_weights", "vae_state_dict"]

TORCH_SUFFIXES = (".pt", ".pth", ".bin", ".ckpt")

_ALLOWED = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("argparse", "Namespace"): argparse.Namespace,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("torch", "Size"): torch.Size,
    ("torch", "device"): torch.device,
    ("torch", "Tensor"): torch.Tensor,
    ("torch.nn.parameter", "Parameter"): torch.nn.Parameter,
}
_ALLOWED_TORCH_FUNCTIONS = {
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"),
    ("torch._utils", "_rebuild_parameter_with_state"),
    ("torch._tensor", "_rebuild_from_type_v2"),
}


class _Stub:
    """What an unpickled object of a class outside the allowed ones becomes."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__["_state"] = state

    def __repr__(self):
        return f"<stub of {type(self).__qualname__}>"


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        if (module, name) in _ALLOWED_TORCH_FUNCTIONS:
            return super().find_class(module, name)
        if module == "torch" and isinstance(getattr(torch, name, None), torch.dtype):
            return getattr(torch, name)
        return type(name, (_Stub,), {"__module__": f"stub.{module}"})


class _TolerantPickle:
    """The ``pickle_module`` that ``torch.load`` takes."""

    Unpickler = _TolerantUnpickler
    load = staticmethod(pickle.load)


def load_torch_checkpoint(path: str) -> Any:
    """The object in a torch file, on the CPU, with unknown classes stubbed."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_TolerantPickle)


def _strip_module(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k.removeprefix("module."): v for k, v in sd.items()}


def ct_encoder_state_dict(ckpt: Dict[str, Any], load_ckpt_type: str = "ema") -> Dict[str, Any]:
    """The CT encoder's weights in a reference checkpoint: its
    ``load_ckpt_type`` sub-dict, else "ema", else the file itself."""
    for key in (load_ckpt_type, "ema"):
        if key in ckpt:
            return _strip_module(ckpt[key])
    return _strip_module(ckpt)


_VAE_LEGACY = ((".query.", ".to_q."), (".key.", ".to_k."), (".value.", ".to_v."),
               (".proj_attn.", ".to_out.0."), (".nin_shortcut.", ".conv_shortcut."))


def vae_state_dict(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """A diffusers ``AutoencoderKL`` state dict in the port's key layout."""
    out = {}
    for key, value in _strip_module(ckpt.get("state_dict", ckpt)).items():
        for old, new in _VAE_LEGACY:
            key = key.replace(old, new)
        if ".attentions.0.to_" in key and key.endswith(".weight") and value.dim() == 4:
            value = value[:, :, 0, 0]  # a legacy 1x1 conv
        out[key] = value
    return out


def clip_state_dict(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """BiomedCLIP's image tower in the port's key layout: open_clip's
    ``visual.trunk.`` prefix dropped, ``visual.head.proj`` (or ``head.proj``)
    as ``head``, the text tower left out."""
    out = {}
    for key, value in _strip_module(ckpt.get("state_dict", ckpt)).items():
        if key.startswith("visual.trunk."):
            key = key.removeprefix("visual.trunk.")
        elif key.startswith("visual.head."):
            key = "head." + key.removeprefix("visual.head.")
        elif key.startswith(("text.", "logit_scale", "visual.")):
            continue
        out[key.replace("head.proj.", "head.")] = value
    return out


_FROM_JAX = {"vae": convert.vae_params_from_jax, "ct": convert.ct_encoder_params_from_jax,
             "clip": convert.clip_params_from_jax}


def load_weights(kind: str, path: str, load_ckpt_type: str = "ema") -> Dict[str, Any]:
    """The state dict of the stack's ``kind`` ("vae", "clip" or "ct") in the
    file ``path``."""
    if str(path).endswith(TORCH_SUFFIXES):
        ckpt = load_torch_checkpoint(path)
        if kind == "ct":
            return ct_encoder_state_dict(ckpt, load_ckpt_type)
        return vae_state_dict(ckpt) if kind == "vae" else clip_state_dict(ckpt)
    tree = np.load(path, allow_pickle=True).item()
    return _FROM_JAX[kind](tree.get("params", tree))
