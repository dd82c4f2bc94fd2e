"""Experiment logging.

Counterpart of ``diffma_tpu/utils/logging.py``: a timestamped logger that
writes to stdout and to ``<exp_dir>/log_0.txt`` on rank 0 only, auto-numbered experiment
directories ``NNN-<model-name>``, and a wandb shim that does nothing when
wandb is not asked for, not installed or fails to start.
"""

from __future__ import annotations

import datetime
import glob
import os
from typing import Optional

__all__ = ["WandbShim", "create_experiment_dir", "create_logger"]


class _Logger:
    def __init__(self, logging_dir: Optional[str], enabled: bool = True):
        self.enabled = enabled
        self._file = None
        if enabled and logging_dir is not None:
            os.makedirs(logging_dir, exist_ok=True)
            self._file = open(os.path.join(logging_dir, "log_0.txt"), "a")

    def info(self, msg: str) -> None:
        if not self.enabled:
            return
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


def create_logger(logging_dir: Optional[str], rank: int = 0) -> _Logger:
    """A logger on rank 0; on every other rank one that writes nothing."""
    return _Logger(logging_dir, enabled=(rank == 0))


def create_experiment_dir(results_dir: str, model_name: str) -> str:
    """Auto-numbered ``NNN-<model>`` directory, with ``checkpoints/`` in it."""
    os.makedirs(results_dir, exist_ok=True)
    index = len(glob.glob(f"{results_dir}/*"))
    exp_dir = f"{results_dir}/{index:03d}-{model_name.replace('/', '-')}"
    os.makedirs(os.path.join(exp_dir, "checkpoints"), exist_ok=True)
    return exp_dir


class WandbShim:
    """wandb if it is installed, asked for and starts, else a no-op. As the
    JAX package's shim, any exception from the import or from ``wandb.init``
    turns it off; ``logger`` (else stdout) gets one line saying why."""

    def __init__(self, enabled: bool, project: str, logger: Optional[_Logger] = None):
        self._w = None
        if enabled:
            try:
                import wandb

                wandb.init(project=project)
                self._w = wandb
            except Exception as e:
                msg = f"wandb is off: {type(e).__name__}: {e}"
                if logger is not None:
                    logger.info(msg)
                else:
                    print(msg, flush=True)

    def log(self, data: dict, step: Optional[int] = None) -> None:
        if self._w is not None:
            self._w.log(data, step=step)

    def finish(self) -> None:
        if self._w is not None:
            self._w.finish()
