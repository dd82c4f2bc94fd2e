"""Experiment logging.

Counterpart of ``diffma_tpu/utils/logging.py``: a timestamped logger that
writes to stdout and to ``<exp_dir>/log_0.txt``, auto-numbered experiment
directories ``NNN-<model-name>``, and a wandb shim that does nothing when
wandb is not installed or not asked for.
"""

from __future__ import annotations

import datetime
import glob
import os
from typing import Optional

__all__ = ["WandbShim", "create_experiment_dir", "create_logger"]


class _Logger:
    def __init__(self, logging_dir: str):
        os.makedirs(logging_dir, exist_ok=True)
        self._file = open(os.path.join(logging_dir, "log_0.txt"), "a")

    def info(self, msg: str) -> None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d at %H:%M:%S")
        line = f"{stamp} | INFO | {msg}"
        print(line, flush=True)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def create_logger(logging_dir: str) -> _Logger:
    return _Logger(logging_dir)


def create_experiment_dir(results_dir: str, model_name: str) -> str:
    """Auto-numbered ``NNN-<model>`` directory, with ``checkpoints/`` in it."""
    os.makedirs(results_dir, exist_ok=True)
    index = len(glob.glob(f"{results_dir}/*"))
    exp_dir = f"{results_dir}/{index:03d}-{model_name.replace('/', '-')}"
    os.makedirs(os.path.join(exp_dir, "checkpoints"), exist_ok=True)
    return exp_dir


class WandbShim:
    """wandb if it is installed and asked for, else a no-op."""

    def __init__(self, enabled: bool, project: str):
        self._w = None
        if enabled:
            try:
                import wandb
            except ImportError:
                return
            wandb.init(project=project)
            self._w = wandb

    def log(self, data: dict, step: Optional[int] = None) -> None:
        if self._w is not None:
            self._w.log(data, step=step)

    def finish(self) -> None:
        if self._w is not None:
            self._w.finish()
