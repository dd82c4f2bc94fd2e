"""DiffMa checkpoints in the reference's torch layout: write and read.

Counterpart of ``save_checkpoint``, ``find_model`` and ``load_diffma_params``
in ``diffma_tpu/train/checkpoints.py``. Upstream's trainer saves a torch
pickle ``{"model": sd, "ema": sd, "opt": ..., "args": ...}`` (its train.py)
as ``checkpoints/<step:07d>.pt``, whose state dicts carry upstream's key
names, a ``module.`` prefix when the model was wrapped in DDP, and the fixed
``pos_embed`` buffer. The port keeps those key names and writes that layout,
so loading is a strict ``load_state_dict`` after the prefix and ``pos_embed``
are dropped, and a checkpoint the port's trainer wrote is sampled by
``train/sample.py --ckpt``. ``latest_step`` and ``restore_checkpoint`` find
and read a trainer's checkpoints to resume its run (``resume_from``); the
port's trainer also saves its generator's state there, under ``rng``, which
upstream's loaders, picking a sub-dict, never read.

The JAX package's Orbax directories are not read here: the port imports no
JAX. ``tools/orbax_to_torch.py``, run where JAX and Orbax are installed,
turns one into a ``<step:07d>.pt`` file of this layout.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from diffma_tpu_torch.utils.torch_io import load_torch_checkpoint

__all__ = ["find_model", "latest_step", "load_diffma_checkpoint", "restore_checkpoint",
           "save_checkpoint"]

ORBAX_HINT = ("the port reads no Orbax checkpoint: convert it with tools/orbax_to_torch.py "
              "on a machine with JAX and Orbax, and give the .pt file it writes")


def save_checkpoint(ckpt_dir: str, step: int, tree: Dict[str, Any]) -> str:
    """Write ``tree`` (``model``, ``ema``, ``opt`` and ``args``: tensors,
    containers and plain values only) to ``<ckpt_dir>/<step:07d>.pt``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step:07d}.pt")
    torch.save(tree, path)
    return path


def _steps(ckpt_dir: str, suffix: str, want_dir: bool):
    return [int(name[: len(name) - len(suffix)]) for name in os.listdir(ckpt_dir)
            if name.endswith(suffix) and name[: len(name) - len(suffix)].isdigit()
            and os.path.isdir(os.path.join(ckpt_dir, name)) == want_dir]


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest step of the ``<step:07d>.pt`` files in ``ckpt_dir``; None
    if it holds none (other files are ignored). A directory of the JAX
    package's Orbax steps and no ``.pt`` file raises, naming the converter."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir, ".pt", want_dir=False)
    if not steps and _steps(ckpt_dir, "", want_dir=True):
        raise NotImplementedError(f"{ckpt_dir} holds Orbax checkpoints of the JAX package; "
                                  f"{ORBAX_HINT}")
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """The tree that ``save_checkpoint`` wrote at ``step``, on the CPU."""
    path = os.path.join(ckpt_dir, f"{int(step):07d}.pt")
    if not os.path.isfile(path):
        if os.path.isdir(os.path.join(ckpt_dir, f"{int(step):07d}")):
            raise NotImplementedError(f"{path[:-3]} is an Orbax checkpoint; {ORBAX_HINT}")
        raise FileNotFoundError(f"no checkpoint of step {step} in {ckpt_dir}")
    return load_torch_checkpoint(path)


def find_model(path: str, load_ckpt_type: str = "ema") -> Dict[str, Any]:
    """The ``load_ckpt_type`` sub-dict of a reference checkpoint, else the first
    of "ema", "params", "model" that it holds, else the whole file."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory, as the JAX package's Orbax checkpoints are; "
                         f"{ORBAX_HINT}")
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
