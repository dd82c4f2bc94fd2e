"""Offline FLOP counter for the port's DiffMa denoiser configs.

The twin of ``tools/compute_gflops.py``: the same analytic fields, from the
port's ``diffma_tpu_torch.utils.profiling.model_flops`` (mixer matmuls and
the scan's elementwise work, the JAX package's count), with the depth and
patch from the port's registry and the hidden width and state size of
``DiffMa``'s defaults. It builds no model and no weights.

The JAX tool's ``--xla`` (FLOPs counted from the compiled HLO) has no
counterpart: the port has no XLA. Its ``--batch`` is read only by
``--xla``, so it is left out too.

Usage:
    python tools/compute_gflops_torch.py                       # DiffMa-B/2 @ 224
    python tools/compute_gflops_torch.py --model DiffMa-XXL/2 --image-size 224
    python tools/compute_gflops_torch.py --use-mamba2 --sample-steps 50
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffma_tpu_torch.models.diffma import DiffMa, DiffMa_models  # noqa: E402
from diffma_tpu_torch.utils.profiling import model_flops  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="DiffMa-B/2", choices=sorted(DiffMa_models))
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--use-mamba2", action="store_true")
    ap.add_argument("--sample-steps", type=int, default=250,
                    help="chain length for the per-image sampling cost")
    args = ap.parse_args(argv)

    depth, patch, _ = DiffMa_models[args.model]
    defaults = inspect.signature(DiffMa).parameters
    hidden, d_state = defaults["hidden_size"].default, defaults["d_state"].default
    latent = args.image_size // 8
    tokens = (latent // patch) ** 2
    analytic = model_flops(depth=depth, hidden=hidden, tokens=tokens, d_state=d_state)
    report = {
        "model": args.model,
        "image_size": args.image_size,
        "tokens": tokens,
        "depth": depth,
        "hidden": hidden,
        "use_mamba2": bool(args.use_mamba2),
        "analytic_fwd_gflops_per_image": round(analytic / 1e9, 3),
        "analytic_sample_tflops_per_image": round(args.sample_steps * analytic / 1e12, 3),
        "sample_steps": args.sample_steps,
    }
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
