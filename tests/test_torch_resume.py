"""Resuming a run: the port's ``resume_from``, and a JAX run continued by the port.

* k steps, a checkpoint, and k more from it (``resume_from``) give the bits
  of 2k steps uninterrupted: the parameters, the EMA, AdamW's moments and
  step, the step count and every loss, at accumulation 1 and 2 (on the CPU
  both steps are eager; the card's graphed step is ``chip_smoke.py`` phase
  21a's). At accumulation 2, k is odd: the checkpoint falls where an update
  has just emptied the accumulated gradients, which no checkpoint holds,
  in either package.
* ``resume_step``, and ``latest_step`` on a directory that holds other files.
* The JAX trainer's quirk: the step count after a resume is the
  checkpoint's step, the count of iterations, even when a skipped batch
  left fewer finite steps (``diffma_tpu/train/train.py``, ``step=r_step``).
* A JAX ``TrainState`` after two optimizer updates, saved by the JAX
  package's ``save_checkpoint`` (Orbax), converted by
  ``tools/orbax_to_torch.py`` and restored by the port, takes its next step
  as JAX does, within 1e-5 (the bar of ``tests/test_torch_train.py``'s step
  tests): on fixed gradients (AdamW and the EMA alone), and on the model's
  loss with JAX's batch, timesteps and noise (slow: JAX compiles the step).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffma_tpu.diffusion import create_diffusion as jax_create_diffusion
from diffma_tpu.models.diffma import build_model as jax_build_model
from diffma_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from diffma_tpu.train.state import TrainState as JaxTrainState
from diffma_tpu.train.state import make_train_step as jax_make_train_step
from diffma_tpu.train.state import update_ema as jax_update_ema
from diffma_tpu.train.train import make_loss_fn as jax_make_loss_fn
from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.train import train
from diffma_tpu_torch.train.checkpoints import latest_step, restore_checkpoint
from diffma_tpu_torch.train.state import (
    TrainState,
    adamw,
    make_train_step,
    restore_train_state,
)
from diffma_tpu_torch.utils.config import Config
from diffma_tpu_torch.utils.convert import diffma_params_from_jax
from test_torch_model import randomize

HIDDEN, IMAGE, BATCH, LR = 32, 64, 2, 1e-3
LATENT = IMAGE // 8
TOKENS = (LATENT // 2) ** 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(tmp_path, name, **kw):
    cfg = Config(epochs=3, log_every=100, ckpt_every=100, lr=LR, model="DiffMa-S/2",
                 image_size=IMAGE, global_batch_size=BATCH, hidden_size=HIDDEN, global_seed=0,
                 synthetic_data=True, synthetic_dataset_size=6, return_loss_history=True,
                 results_dir=str(tmp_path / name))
    cfg.update(kw)
    return cfg


def _ckpt_dir(tmp_path, name):
    (exp,) = os.listdir(tmp_path / name)
    return str(tmp_path / name / exp / "checkpoints")


def _assert_same_state(a: TrainState, b: TrainState):
    assert int(a.step) == int(b.step)
    for ma, mb in ((a.model, b.model), (a.ema, b.ema)):
        sb = mb.state_dict()
        for name, v in ma.state_dict().items():
            assert torch.equal(v, sb[name]), name
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sa.keys() == sb.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("accumulation_steps,k", [(1, 3), (2, 3)])
def test_resume_continues_the_run_in_bits(tmp_path, accumulation_steps, k):
    full, full_hist = train.main(_cfg(tmp_path, "full", max_steps=2 * k,
                                      accumulation_steps=accumulation_steps), device="cpu")
    first, first_hist = train.main(_cfg(tmp_path, "a", max_steps=k, ckpt_every=k,
                                        accumulation_steps=accumulation_steps), device="cpu")
    ckpts = _ckpt_dir(tmp_path, "a")
    assert latest_step(ckpts) == k and "rng" in restore_checkpoint(ckpts, k)
    second, second_hist = train.main(
        _cfg(tmp_path, "b", max_steps=2 * k, resume_from=ckpts,
             accumulation_steps=accumulation_steps), device="cpu")
    assert int(second.step) == int(full.step) == 2 * k
    np.testing.assert_array_equal(np.concatenate([first_hist["loss"], second_hist["loss"]]),
                                  full_hist["loss"])
    _assert_same_state(second, full)
    with open(os.path.join(tmp_path / "b", os.listdir(tmp_path / "b")[0], "log_0.txt")) as f:
        assert f"Resumed from {ckpts} at step {k}" in f.read()


def test_resume_step_and_latest_step(tmp_path):
    """A run of 6 steps saving at 3 and 6, resumed at ``resume_step`` 3 for 3
    more, ends as it did; ``latest_step`` reads only ``<step>.pt`` files."""
    full, _ = train.main(_cfg(tmp_path, "full", max_steps=6, ckpt_every=3), device="cpu")
    ckpts = _ckpt_dir(tmp_path, "full")
    assert latest_step(ckpts) == 6
    again, hist = train.main(_cfg(tmp_path, "again", max_steps=6, resume_from=ckpts,
                                  resume_step=3), device="cpu")
    assert len(hist["loss"]) == 3
    _assert_same_state(again, full)

    other = tmp_path / "other"
    other.mkdir()
    for name in ("0000002.pt", "0000010.pt", "notes.txt", "0000011.pt.tmp", "x.pt"):
        (other / name).write_bytes(b"")
    (other / "0000020").mkdir()  # a directory, as an Orbax step is
    assert latest_step(str(other)) == 10
    assert latest_step(str(tmp_path / "absent")) is None
    empty = tmp_path / "empty"
    empty.mkdir()
    assert latest_step(str(empty)) is None
    with pytest.raises(FileNotFoundError, match="holds no checkpoint"):
        train.main(_cfg(tmp_path, "none", max_steps=1, resume_from=str(empty)), device="cpu")
    orbax = tmp_path / "orbax"
    (orbax / "0000004").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax_to_torch"):
        latest_step(str(orbax))
    with pytest.raises(NotImplementedError, match="orbax_to_torch"):
        restore_checkpoint(str(orbax), 4)


def test_step_is_the_checkpoints_step_after_a_nan_batch(tmp_path, monkeypatch):
    """A NaN batch at iteration 2 of 3: 2 finite steps, the checkpoint at
    iteration 3. Resumed, the step count starts from 3, as JAX's does, and
    one more step makes it 4, where the uninterrupted run counts 3."""
    real = train.synthetic_batch
    calls = {"n": 0}

    def with_a_nan(*args, **kw):
        batch = real(*args, **kw)
        calls["n"] += 1
        if calls["n"] == 2:
            batch["z"][0, 0, 0, 0] = float("nan")
        return batch

    monkeypatch.setattr(train, "synthetic_batch", with_a_nan)
    first, hist = train.main(_cfg(tmp_path, "a", max_steps=3, ckpt_every=3), device="cpu")
    assert int(first.step) == 2 and hist["finite"].tolist() == [1, 0, 1]
    calls["n"] = 0
    full, _ = train.main(_cfg(tmp_path, "full", max_steps=4), device="cpu")
    assert int(full.step) == 3
    resumed, hist = train.main(_cfg(tmp_path, "b", max_steps=4,
                                    resume_from=_ckpt_dir(tmp_path, "a")), device="cpu")
    assert len(hist["loss"]) == 1 and int(resumed.step) == 4


# ---------------------------------------------------------------------------
# A JAX run continued by the port: Orbax -> tools/orbax_to_torch.py -> resume
# ---------------------------------------------------------------------------

ARGS = {"model": "DiffMa-S/2", "image_size": IMAGE, "hidden_size": HIDDEN, "lr": LR,
        "global_seed": 0, "use_mamba2": False}


def _orbax_to_torch():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(ROOT, "tools", "orbax_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _zeros_like_params(jmodel):
    z = jnp.zeros((1, 4, LATENT, LATENT))
    y, y2, w = jnp.zeros((1, HIDDEN)), jnp.zeros((1, TOKENS, HIDDEN)), jnp.zeros((1, TOKENS, 1))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), z, jnp.zeros((1,), jnp.int32),
                                                y, y2, w)["params"])
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A JAX TrainState after two AdamW updates on fixed gradients, saved by
    the JAX package as its trainer saves it, converted by the tool."""
    tmp = tmp_path_factory.mktemp("orbax")
    jmodel = jax_build_model(ARGS["model"], input_size=LATENT, hidden_size=HIDDEN, scan_impl="ref")
    zeros = _zeros_like_params(jmodel)
    optimizer = optax.adamw(LR, b1=0.9, b2=0.999, weight_decay=0.0)
    state = JaxTrainState.create(randomize(zeros, 1), optimizer)
    update = jax.jit(lambda s, g: _jax_update(s, optimizer, g))
    for i in range(2):
        state = update(state, randomize(zeros, 10 + i))
    jax_save_checkpoint(str(tmp / "jax"), 2, {
        "model": jax.device_get(state.params), "ema": jax.device_get(state.ema_params),
        "opt": jax.device_get(state.opt_state), "args": ARGS})
    path = _orbax_to_torch().main(["--ckpt-dir", str(tmp / "jax"), "--out", str(tmp / "port")])
    assert path == str(tmp / "port" / "0000002.pt")
    return jmodel, zeros, optimizer, update, state, str(tmp / "port")


def _jax_update(state, optimizer, grads):
    updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return state.replace(step=state.step + 1, params=params, opt_state=opt_state,
                         ema_params=jax_update_ema(state.ema_params, params))


def _port_state(ckpt_dir):
    """The port's TrainState restored as its trainer restores it."""
    model = build_model(ARGS["model"], input_size=LATENT, hidden_size=HIDDEN)
    state = TrainState(model, adamw(model.parameters(), LR))
    tree = restore_checkpoint(ckpt_dir, latest_step(ckpt_dir))
    assert "rng" not in tree and tree["args"] == ARGS
    restore_train_state(state, tree, 2)
    return state


def _assert_like_jax(state, jstate, depth, moments=True):
    adam = jstate.opt_state[0]
    named = dict(state.model.named_parameters())
    pairs = [(jstate.params, lambda n: named[n]),
             (jstate.ema_params, state.ema.state_dict().get)]
    if moments:
        pairs += [(adam.mu, lambda n: state.optimizer.state[named[n]]["exp_avg"]),
                  (adam.nu, lambda n: state.optimizer.state[named[n]]["exp_avg_sq"])]
    assert int(state.step) == int(jstate.step)
    assert {float(state.optimizer.state[p]["step"]) for p in named.values()} == {float(adam.count)}
    for tree, get in pairs:
        for name, v in diffma_params_from_jax(jax.tree.map(np.asarray, tree), depth=depth).items():
            np.testing.assert_allclose(get(name).detach().numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_converted_orbax_checkpoint_restores_and_steps_as_jax(converted):
    """The restored tensors equal JAX's; then one more update on the same
    fixed gradients through the port's step (AdamW and the EMA) lands
    within 1e-5 of JAX's third."""
    _, zeros, _, update, jstate, port_dir = converted
    state = _port_state(port_dir)
    depth = state.model.depth
    for tree, module in ((jstate.params, state.model), (jstate.ema_params, state.ema)):
        sd = module.state_dict()
        for name, v in diffma_params_from_jax(jax.tree.map(np.asarray, tree), depth=depth).items():
            assert torch.equal(sd[name], v), name
    _assert_like_jax(state, jstate, depth)

    grads = randomize(zeros, 12)
    want = update(jstate, grads)
    g = diffma_params_from_jax(grads, depth=depth)
    named = dict(state.model.named_parameters())

    def loss_fn(batch, generator):  # whose gradient is ``g``
        return sum((named[n] * v).sum() for n, v in g.items()), {}

    assert make_train_step(loss_fn, state.optimizer)(state, {}, None)["finite"]
    _assert_like_jax(state, want, depth)


@pytest.mark.slow  # JAX compiles its training step: about 30 s
def test_converted_orbax_run_takes_jaxs_next_step(converted):
    """One step of the model's hybrid loss on JAX's batch, timesteps and
    noise, in both packages, from the converted state."""
    jmodel, _, optimizer, _, jstate, port_dir = converted
    rng = np.random.default_rng(5)
    batch = {"z": rng.standard_normal((BATCH, 4, LATENT, LATENT)).astype(np.float32),
             "y": rng.standard_normal((BATCH, HIDDEN)).astype(np.float32),
             "y2": rng.standard_normal((BATCH, TOKENS, HIDDEN)).astype(np.float32),
             "w": rng.uniform(0.1, 0.9, (BATCH, TOKENS, 1)).astype(np.float32)}
    key = jax.random.PRNGKey(9)
    step = jax.jit(jax_make_train_step(jax_make_loss_fn(jmodel, jax_create_diffusion("")),
                                       optimizer))
    want, metrics = step(jstate, batch, key)
    t_key, noise_key = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_key, (BATCH,), 0, 1000)).astype(np.int64)
    noise = np.array(jax.random.normal(noise_key, batch["z"].shape))

    state = _port_state(port_dir)
    port_step = make_train_step(train.make_loss_fn(state.model, create_diffusion("", device="cpu")),
                                state.optimizer)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb.update(t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    got = port_step(state, tb, None)
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=2e-4, atol=2e-4)
    _assert_like_jax(state, want, state.model.depth)
