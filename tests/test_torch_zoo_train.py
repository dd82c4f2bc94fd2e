"""Training the port's other block families against the JAX package's, on the CPU.

The families whose fused route trains (ZigMa, VMamba, DiT) take the hybrid
loss, every gradient and two AdamW steps through both packages from the same
numpy inputs and JAX's own draws of t and noise; on the JAX side the fused
mixer's monolithic backward runs in interpret mode, on the port's side CPU
tensors take the plain versions under autograd. Bars: those of
``tests/test_torch_train.py`` (loss and gradients 2e-4, parameters and EMA
after two optimizer steps 1e-5). Then the trainer's and the sampler's CLIs
with ``--model`` for three families.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffma_tpu.diffusion import create_diffusion as jax_create_diffusion
from diffma_tpu.models.diffma import DiffMa as JaxDiffMa
from diffma_tpu.train.state import TrainState as JaxTrainState
from diffma_tpu.train.state import make_train_step as jax_make_train_step
from diffma_tpu.train.train import make_loss_fn as jax_make_loss_fn
from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.models.diffma import DiffMa, DiffMa_models
from diffma_tpu_torch.train import sample, train
from diffma_tpu_torch.train.state import TrainState, make_train_step
from diffma_tpu_torch.utils.config import Config
from diffma_tpu_torch.utils.convert import diffma_params_from_jax
from test_torch_model import randomize
from test_torch_train import _jax_draws, _torch_batch

HIDDEN = 32
INPUT = 8  # latent 8x8, patch 2 -> a 4x4 grid, 16 tokens


def _jax_family(block_type, use_mamba2=False):
    jmodel = JaxDiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=2,
                       block_type=block_type, scan_impl="fused", use_mamba2=use_mamba2)
    b = _batch()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), b["z"], jnp.zeros((1,), jnp.int32),
                                  b["y"], b["y2"], b["w"])["params"]
    return jmodel, randomize(params, 1)


def _port_family(params, block_type):
    model = DiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=2,
                   block_type=block_type, scan_impl="fused")
    model.load_state_dict(diffma_params_from_jax(params, depth=2), strict=True)
    return model


def _batch(seed=3, batch=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"z": f(batch, 4, INPUT, INPUT), "y": f(batch, HIDDEN), "y2": f(batch, 16, HIDDEN),
            "w": (1 / (1 + np.exp(-f(batch, 16, 1)))).astype(np.float32)}


@pytest.mark.parametrize("block_type", ["zig", "vmamba", "DiT"])
def test_family_train_step_matches_jax(block_type):
    """The families whose fused route trains: the hybrid loss and every
    gradient against JAX's (its fused mixer's monolithic backward in
    interpret mode), then params and EMA after two AdamW steps."""
    jmodel, params = _jax_family(block_type)
    loss_fn = jax_make_loss_fn(jmodel, jax_create_diffusion(""))
    b, rng = _batch(), jax.random.PRNGKey(7)
    (want_loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, b, rng)
    want = diffma_params_from_jax(jax.tree.map(np.asarray, grads), depth=2)
    model = _port_family(params, block_type)
    port_loss = train.make_loss_fn(model, create_diffusion("", device="cpu"))
    loss, _ = port_loss(_torch_batch(b, *_jax_draws(rng, b["z"].shape)), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4, atol=2e-4)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        assert named[name].grad is not None, name
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=name)

    batches = [_batch(10 + i) for i in range(2)]
    rngs = [jax.random.PRNGKey(20 + i) for i in range(2)]
    opt = optax.adamw(1e-3, b1=0.9, b2=0.999, weight_decay=0.0)
    jstate = JaxTrainState.create(params, opt)
    jstep = jax.jit(jax_make_train_step(loss_fn, opt, accumulation_steps=1))
    for bb, rr in zip(batches, rngs):
        jstate, _ = jstep(jstate, bb, rr)
    model = _port_family(params, block_type)
    topt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.0)
    state = TrainState(model, topt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), topt)
    for bb, rr in zip(batches, rngs):
        assert step(state, _torch_batch(bb, *_jax_draws(rr, bb["z"].shape)), None)["finite"]
    assert state.step == int(jstate.step) == 2
    for tree, module in ((jstate.params, state.model), (jstate.ema_params, state.ema)):
        ref = diffma_params_from_jax(jax.tree.map(np.asarray, tree), depth=2)
        sd = module.state_dict()
        for name, v in ref.items():
            got, v = sd[name].numpy(), v.numpy()
            if name.endswith("attn.qkv.bias"):
                # A bias on the keys shifts every score of a query alike, and the
                # softmax does not see it: its gradient is zero but for rounding,
                # and AdamW divides that rounding by its own size. So the key
                # third moves by up to lr a step in either package, by chance.
                k = np.arange(HIDDEN, 2 * HIDDEN)
                assert np.abs(got[k] - v[k]).max() <= 2 * 2 * 1e-3
                got, v = np.delete(got, k), np.delete(v, k)
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", ["ViM-S/2", "EMamba-S/2", "DiT-S/2"])
def test_trainer_and_sampler_take_every_family(tmp_path, name):
    """The trainer's and the sampler's CLIs with ``--model``: two steps on the
    CPU (the composable route), a checkpoint, and the sampler reading it back
    with the trainer's ``hidden_size``."""
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(
        "model: DiffMa-S/2\nimage_size: 64\nhidden_size: 32\nglobal_batch_size: 2\n"
        "synthetic_data: true\nsynthetic_dataset_size: 4\nepochs: 1\nlr: 1e-3\nmax_steps: 2\n"
        f"ckpt_every: 2\nlog_every: 1\nglobal_seed: 0\nresults_dir: \"{tmp_path / 'results'}\"\n"
        f"sample_num_steps: 2\nsample_num_batches: 1\nsave_dir: \"{tmp_path / 'out'}\"\n"
    )
    state = train.cli(["--config", str(cfg_path), "--model", name, "--device", "cpu"])
    assert state.step == 2 and state.model.block_type == DiffMa_models[name][2]
    (exp,) = (tmp_path / "results").iterdir()
    ckpt = exp / "checkpoints" / "0000002.pt"
    results = sample.cli(["--config", str(cfg_path), "--model", name, "--ckpt", str(ckpt),
                          "--device", "cpu"])
    assert results[0]["images"].shape == (1, 3, 64, 64) and np.isfinite(results[0]["images"]).all()
    loaded = sample.load_model(Config(model=name, image_size=64, hidden_size=32, ckpt=str(ckpt)),
                               device="cpu")
    for k, v in state.ema.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
