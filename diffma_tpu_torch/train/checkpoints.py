"""DiffMa checkpoints in the reference's torch layout: write and read.

Counterpart of ``save_checkpoint``, ``find_model`` and ``load_diffma_params``
in ``diffma_tpu/train/checkpoints.py``. Upstream's trainer saves a torch
pickle ``{"model": sd, "ema": sd, "opt": ..., "args": ...}`` (its train.py)
as ``checkpoints/<step:07d>.pt``, whose state dicts carry upstream's key
names, a ``module.`` prefix when the model was wrapped in DDP, and the fixed
``pos_embed`` buffer. The port keeps those key names and writes that layout,
so loading is a strict ``load_state_dict`` after the prefix and ``pos_embed``
are dropped, and a checkpoint the port's trainer wrote is sampled by
``train/sample.py --ckpt``. The JAX package's Orbax directories are neither
written nor read: their conversion is queued.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn

from diffma_tpu_torch.utils.torch_io import load_torch_checkpoint

__all__ = ["find_model", "load_diffma_checkpoint", "save_checkpoint"]


def save_checkpoint(ckpt_dir: str, step: int, tree: Dict[str, Any]) -> str:
    """Write ``tree`` (``model``, ``ema``, ``opt`` and ``args``: tensors,
    containers and plain values only) to ``<ckpt_dir>/<step:07d>.pt``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step:07d}.pt")
    torch.save(tree, path)
    return path


def find_model(path: str, load_ckpt_type: str = "ema") -> Dict[str, Any]:
    """The ``load_ckpt_type`` sub-dict of a reference checkpoint, else the first
    of "ema", "params", "model" that it holds, else the whole file."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: Orbax checkpoints of the JAX package are not "
            "read by the port yet; give a torch checkpoint file"
        )
    # Upstream stores its config under "args", an OmegaConf object whose
    # class may not be importable: the tolerant unpickler stubs it.
    ckpt = load_torch_checkpoint(path)
    for key in (load_ckpt_type, "ema", "params", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            return ckpt[key]
    return ckpt


def load_diffma_checkpoint(model: nn.Module, path: str, load_ckpt_type: str = "ema") -> nn.Module:
    """Load a reference checkpoint's weights into ``model`` strictly; a key
    that is missing or unexpected is named in the error."""
    state = {}
    for key, value in find_model(path, load_ckpt_type).items():
        key = key.removeprefix("module.")
        if key != "pos_embed":  # a fixed buffer, rebuilt by the model
            state[key] = value
    expected = set(model.state_dict())
    missing = sorted(expected - set(state))
    unexpected = sorted(set(state) - expected)
    if missing or unexpected:
        raise KeyError(
            f"{path} does not fit {type(model).__name__}: missing {missing}, "
            f"unexpected {unexpected}"
        )
    model.load_state_dict(state, strict=True)
    return model
