"""The card a run uses, and what a run may not have loaded.

A run needs as many CUDA cards as its cell asks for and never falls back
to the CPU. ``nvidia-smi`` gives the card's name and power limit, printed
beside every number of the run. After the window the process may hold
neither JAX nor the JAX package: the check compares top-level module names
whole, since the port's name begins with the JAX package's.
"""

from __future__ import annotations

import subprocess
import sys

__all__ = ["FORBIDDEN", "card_line", "forbidden_modules", "require_cards"]

FORBIDDEN = ("jax", "jaxlib", "flax", "diffma_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(chips: int) -> None:
    """Raise unless ``chips`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA card is available: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "nvidia-smi failed"


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
