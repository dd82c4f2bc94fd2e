"""Convert a JAX trainer's Orbax checkpoint into the PyTorch port's format.

    python tools/orbax_to_torch.py --ckpt-dir <results>/000-DiffMa-L-2/checkpoints \\
        --out <dir> [--step 50000]

Run it where JAX, Orbax and the JAX package (``diffma_tpu``) are installed;
the port (``diffma_tpu_torch``) imports none of them, so this is the bridge,
as the tests are. It reads the run's config from the ``<step:07d>.args.json``
sidecar that ``diffma_tpu.train.checkpoints.save_checkpoint`` writes,
restores ``<ckpt-dir>/<step:07d>`` (by default the latest step) with a
target built as the JAX trainer builds it for ``resume_from`` (the model's
parameters, their EMA and the ``optax.adamw`` state), and writes
``<out>/<step:07d>.pt`` in the port's layout: ``{"model", "ema", "opt",
"args"}``, the parameters under the port's key names
(``diffma_params_from_jax``) and AdamW's state as a ``torch.optim.AdamW``
``state_dict`` (``adamw_state_from_optax``). The port's trainer continues
the run from it (``resume_from: <out>``, or ``--resume-from <out>``), its
sampler reads the file (``--ckpt``). The file holds no generator state:
JAX's key stream has no torch counterpart, so the resumed run draws its
batches and noise from its seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _target(args: dict):
    """The JAX trainer's resume target for the run of ``args``: numpy zeros
    shaped as its parameters, the same for the EMA, and ``optax.adamw``'s
    state over them."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from diffma_tpu.models.diffma import build_model
    from diffma_tpu.train.state import TrainState

    latent = int(args["image_size"]) // 8
    model = build_model(
        str(args["model"]), input_size=latent, dt_rank=int(args.get("dt_rank") or 16),
        d_state=int(args.get("d_state") or 16), use_mamba2=bool(args.get("use_mamba2")),
        **({"hidden_size": int(args["hidden_size"])} if args.get("hidden_size") else {}),
    )
    tokens, dim = (latent // model.patch_size) ** 2, model.hidden_size
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, model.in_channels, latent, latent)),
        jnp.zeros((2,), jnp.int32), jnp.zeros((2, dim)), jnp.zeros((2, tokens, dim)),
        jnp.zeros((2, tokens, 1)))["params"])
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    optimizer = optax.adamw(float(args.get("lr") or 1e-4), b1=0.9, b2=0.999, weight_decay=0.0)
    state = TrainState.create(params, optimizer)
    return model, {"model": params, "ema": params, "opt": jax.device_get(state.opt_state)}


def convert(ckpt_dir: str, out_dir: str, step=None) -> str:
    """Convert ``ckpt_dir``'s Orbax checkpoint at ``step`` (the latest if
    None); returns the path of the ``.pt`` file written in ``out_dir``."""
    import jax
    import numpy as np
    import torch

    from diffma_tpu.train.checkpoints import latest_step, restore_checkpoint
    from diffma_tpu_torch.models.diffma import build_model as port_build_model
    from diffma_tpu_torch.train.checkpoints import save_checkpoint
    from diffma_tpu_torch.utils.convert import adamw_state_from_optax, diffma_params_from_jax

    ckpt_dir = os.path.abspath(ckpt_dir)
    step = int(step if step is not None else latest_step(ckpt_dir))
    with open(os.path.join(ckpt_dir, f"{step:07d}.args.json")) as f:
        args = json.load(f)
    model, target = _target(args)
    restored = jax.tree.map(np.asarray, restore_checkpoint(ckpt_dir, step, target=target))
    with torch.device("meta"):  # the port's parameter names and order, no storage
        port = port_build_model(
            str(args["model"]), input_size=int(args["image_size"]) // 8,
            use_mamba2=bool(args.get("use_mamba2")),
            **({"hidden_size": int(args["hidden_size"])} if args.get("hidden_size") else {}),
        )
    kw = dict(depth=model.depth, use_mamba2=model.use_mamba2, in_channels=model.in_channels)
    names = [name for name, _ in port.named_parameters()]
    return save_checkpoint(out_dir, step, {
        "model": diffma_params_from_jax(restored["model"], **kw),
        "ema": diffma_params_from_jax(restored["ema"], **kw),
        "opt": adamw_state_from_optax(restored["opt"], names, **kw),
        "args": args,
    })


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt-dir", required=True,
                        help="the JAX run's checkpoints/ directory (Orbax steps and sidecars)")
    parser.add_argument("--out", required=True, help="directory for <step:07d>.pt")
    parser.add_argument("--step", type=int, default=None, help="default: the latest")
    a = parser.parse_args(argv)
    path = convert(a.ckpt_dir, a.out, a.step)
    print(path)
    return path


if __name__ == "__main__":
    main()
