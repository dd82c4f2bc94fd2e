"""The port's training path against the JAX package's, on the CPU.

Inputs, timesteps and noise come from numpy or from JAX's own draws and go
through both packages. On the JAX side the Pallas scan backward runs in
interpret mode; on the port's side CPU tensors take the plain versions
(autograd over the plain scan). Bars: the scan backward 2e-4 (rtol = atol,
the JAX package's gradient bar, ``tests/test_selective_scan.py``); the
losses 1e-5; the model's loss and gradients 2e-4 (the model-parity bar);
parameters and EMA after two optimizer steps 1e-5. The model tests run for
both mixer families: Mamba-1 against JAX's plain scan, Mamba-2
(``use_mamba2``) against JAX's fused SSD kernels, forward and backward, in
interpret mode, which is the path the JAX trainer takes.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffma_tpu.data.npy_dataset import SyntheticTriplets as JaxSyntheticTriplets
from diffma_tpu.data.npy_dataset import make_loader as jax_make_loader
from diffma_tpu.diffusion import create_diffusion as jax_create_diffusion
from diffma_tpu.models.diffma import DiffMa as JaxDiffMa
from diffma_tpu.ops.selective_scan import _selective_scan_pallas_bwd_impl
from diffma_tpu.train.state import TrainState as JaxTrainState
from diffma_tpu.train.state import make_train_step as jax_make_train_step
from diffma_tpu.train.train import make_loss_fn as jax_make_loss_fn
from diffma_tpu.utils.logging import create_experiment_dir as jax_create_experiment_dir
from diffma_tpu_torch.data.npy_dataset import SyntheticTriplets, make_loader
from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.models.diffma import DiffMa
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.ops import fused_mixer, selective_scan
from diffma_tpu_torch.ops.scan_orders import build_scan_spec
from diffma_tpu_torch.train import sample, train
from diffma_tpu_torch.train.state import TrainState, make_train_step
from diffma_tpu_torch.utils.config import Config
from diffma_tpu_torch.utils.convert import diffma_params_from_jax
from diffma_tpu_torch.utils.logging import create_experiment_dir
from test_torch_model import randomize

HIDDEN, DEPTH, INPUT, BATCH = 32, 2, 8, 2
TOKENS = (INPUT // 2) ** 2


# ---------------------------------------------------------------------------
# The selective scan's backward (kernel B's plain version)
# ---------------------------------------------------------------------------


def _scan_inputs(G, L, d, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    A = -np.exp(np.log(np.arange(1, n + 1, dtype=np.float32))[None] + 0.1 * f(d, n))
    return dict(u=f(G, L, d), delta=0.5 * f(G, L, d) - 1.0, A=A.astype(np.float32),
                B=f(G, L, n), C=f(G, L, n), D=f(d), z=f(G, L, d), g=f(G, L, d))


@pytest.mark.parametrize(
    "L,gated,zeros", [(13, True, False), (13, False, False), (28, True, False),
                      (28, False, False), (13, True, True)],
)
def test_scan_bwd_ref_matches_jax(L, gated, zeros):
    """``zeros`` puts delta = 0 at every fifth channel: the softplus's
    gradient there is sigmoid(0) = 1/2, as in JAX (and in kernel B)."""
    x = _scan_inputs(2, L, 16, 4, seed=L)
    if not gated:
        x["z"] = None
    if zeros:
        x["delta"][..., ::5] = 0.0
    order = ("u", "delta", "A", "B", "C", "D", "z", "g")
    want = _selective_scan_pallas_bwd_impl(
        *(None if x[k] is None else jnp.asarray(x[k]) for k in order))
    got = selective_scan.selective_scan_bwd_ref(
        *(None if x[k] is None else torch.from_numpy(x[k]) for k in order))
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz"), got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4, err_msg=name)


def test_scan_autograd_on_cpu_is_plain_autograd():
    """``selective_scan`` on CPU tensors is the plain scan under autograd; the
    kernels are never touched."""
    x = _scan_inputs(1, 9, 8, 16, seed=1)
    leaves = [torch.from_numpy(x[k]).requires_grad_() for k in ("u", "delta", "A", "B", "C", "D", "z")]
    before = selective_scan.selective_scan_bwd_cuda.launches
    selective_scan.selective_scan(*leaves).backward(torch.from_numpy(x["g"]))
    assert selective_scan.selective_scan_bwd_cuda.launches == before
    want = selective_scan.selective_scan_bwd_ref(*leaves, torch.from_numpy(x["g"]))
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The diffusion's hybrid loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [{}, {"rescale_learned_sigmas": True}, {"use_kl": True}])
def test_training_losses_match_jax(kind):
    rng = np.random.default_rng(5)
    x0 = np.tanh(rng.standard_normal((4, 4, 6, 6))).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 1, 500, 999])

    def model_np(x, tt, lib):  # a fixed smooth function of x_t and t
        eps = lib.tanh(0.7 * x) - 0.1
        v = lib.tanh(0.3 * x + 1e-3 * tt.reshape(-1, 1, 1, 1))
        return lib.concatenate([eps, v], 1) if lib is jnp else torch.cat([eps, v], 1)

    want = jax_create_diffusion("", **kind).training_losses(
        lambda x, tt: model_np(x, tt, jnp), jnp.asarray(x0), jnp.asarray(t, jnp.int32),
        None, noise=jnp.asarray(noise),
    )
    diffusion = create_diffusion("", device="cpu", **kind)
    got = diffusion.training_losses(
        lambda x, tt: model_np(x, tt, torch), torch.from_numpy(x0), torch.from_numpy(t),
        noise=torch.from_numpy(noise),
    )
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_vb_term_sees_a_detached_eps():
    """The VB term trains the variance only: the gradient of ``vb`` with
    respect to the epsilon half of the output is zero."""
    diffusion = create_diffusion("", device="cpu")
    out = torch.randn(2, 8, 4, 4, requires_grad=True)
    terms = diffusion.training_losses(
        lambda x, tt: out, torch.randn(2, 4, 4, 4), torch.tensor([3, 700]),
        noise=torch.randn(2, 4, 4, 4),
    )
    (grad,) = torch.autograd.grad(terms["vb"].sum(), out)
    assert grad[:, :4].abs().max() == 0 and grad[:, 4:].abs().max() > 0


# ---------------------------------------------------------------------------
# The whole model, the train step and the trainer
# ---------------------------------------------------------------------------


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"z": f(BATCH, 4, INPUT, INPUT), "y": f(BATCH, HIDDEN), "y2": f(BATCH, TOKENS, HIDDEN),
            "w": (1 / (1 + np.exp(-f(BATCH, TOKENS, 1)))).astype(np.float32)}


@pytest.fixture(scope="module")
def pair():
    """A JAX DiffMa (plain scan) with random params, and the port's holding them."""
    jmodel = JaxDiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=DEPTH,
                       scan_impl="ref")
    b = _batch()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), b["z"], jnp.zeros((1,), jnp.int32),
                                  b["y"], b["y2"], b["w"])["params"]
    params = randomize(params, 1)
    return jmodel, params


@pytest.fixture(scope="module")
def pair_mamba2():
    """The same with Mamba-2 mixers; the JAX side on its fused SSD kernels."""
    jmodel = JaxDiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=DEPTH,
                       scan_impl="fused", use_mamba2=True)
    b = _batch()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), b["z"], jnp.zeros((1,), jnp.int32),
                                  b["y"], b["y2"], b["w"])["params"]
    params = randomize(params, 2)
    return jmodel, params


FAMILIES = {"mamba1": ("pair", False), "mamba2": ("pair_mamba2", True)}


def _port_model(params, scan_impl="auto", use_mamba2=False):
    model = DiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=DEPTH,
                   scan_impl=scan_impl, use_mamba2=use_mamba2)
    model.load_state_dict(diffma_params_from_jax(params, depth=DEPTH, use_mamba2=use_mamba2),
                          strict=True)
    return model


def _jax_draws(rng, shape):
    """The t and noise that JAX's ``make_loss_fn`` draws from ``rng``."""
    t_rng, noise_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (shape[0],), 0, 1000)
    return np.asarray(t).astype(np.int64), np.asarray(jax.random.normal(noise_rng, shape))


def _torch_batch(b, t, noise):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out.update(t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("scan_impl", ["auto", "fused"])
def test_model_loss_and_grads_match_jax(request, scan_impl, family):
    fixture, use_mamba2 = FAMILIES[family]
    jmodel, params = request.getfixturevalue(fixture)
    b = _batch()
    rng = jax.random.PRNGKey(7)
    loss_fn = jax_make_loss_fn(jmodel, jax_create_diffusion(""))
    (want_loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, b, rng)
    want = diffma_params_from_jax(jax.tree.map(np.asarray, grads), depth=DEPTH,
                                  use_mamba2=use_mamba2)

    model = _port_model(params, scan_impl, use_mamba2)
    port_loss = train.make_loss_fn(model, create_diffusion("", device="cpu"))
    loss, _ = port_loss(_torch_batch(b, *_jax_draws(rng, b["z"].shape)), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4, atol=2e-4)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        got = named[name].grad
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=2e-4, atol=2e-4, err_msg=name)


def _run_jax_steps(jmodel, params, batches, rngs, accumulation_steps):
    opt = optax.adamw(1e-3, b1=0.9, b2=0.999, weight_decay=0.0)
    state = JaxTrainState.create(params, opt)
    step = jax.jit(jax_make_train_step(jax_make_loss_fn(jmodel, jax_create_diffusion("")), opt,
                                       accumulation_steps=accumulation_steps))
    for b, rng in zip(batches, rngs):
        state, _ = step(state, b, rng)
    return state


def _run_port_steps(params, batches, rngs, accumulation_steps, use_mamba2=False):
    model = _port_model(params, use_mamba2=use_mamba2)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)
    state = TrainState(model, opt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), opt,
                           accumulation_steps=accumulation_steps)
    for b, rng in zip(batches, rngs):
        assert step(state, _torch_batch(b, *_jax_draws(rng, b["z"].shape)), None)["finite"]
    return state


@pytest.mark.parametrize("family,accumulation_steps,n_steps",
                         [("mamba1", 1, 2), ("mamba1", 2, 3), ("mamba2", 1, 2)])
def test_train_step_matches_jax(request, family, accumulation_steps, n_steps):
    """Params and EMA after the same steps as JAX's; with accumulation 2 the
    updates fire on iterations 1 and 3, on undivided sums of gradients."""
    fixture, use_mamba2 = FAMILIES[family]
    jmodel, params = request.getfixturevalue(fixture)
    # AdamW divides each gradient by its own size, so where a gradient lies
    # within rounding of 0 the update follows the rounding of the sums behind
    # it, which differ between the packages. The Mamba-2 batches' seeds are
    # chosen so that no element lies there (with seeds 10 and 50, one element
    # of the model's 60,000 does, and moves 1e-4 off JAX's).
    first = 70 if use_mamba2 else 10
    batches = [_batch(first + i) for i in range(n_steps)]
    rngs = [jax.random.PRNGKey(20 + i) for i in range(n_steps)]
    want = _run_jax_steps(jmodel, params, batches, rngs, accumulation_steps)
    got = _run_port_steps(params, batches, rngs, accumulation_steps, use_mamba2)
    assert got.step == int(want.step) == n_steps
    for tree, module in ((want.params, got.model), (want.ema_params, got.ema)):
        ref = diffma_params_from_jax(jax.tree.map(np.asarray, tree), depth=DEPTH,
                                     use_mamba2=use_mamba2)
        sd = module.state_dict()
        for name, v in ref.items():
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    start = _port_model(params, use_mamba2=use_mamba2).state_dict()
    moved = sum((got.model.state_dict()[k] - v).abs().sum().item() for k, v in start.items())
    assert moved > 0


def _adam_moments(opt_state):
    """optax's ScaleByAdamState inside an adamw chain's state."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


@pytest.mark.parametrize("accumulation_steps,n_steps", [(1, 3), (2, 4)])
def test_predicated_step_matches_jax_through_a_nan_batch(pair, accumulation_steps, n_steps):
    """The predicated step against JAX's ``make_train_step``
    (``train_step_predicated`` at 1, the ``lax.cond`` path at 2) over
    batches with a NaN at the second: after every step the finite flag,
    both step counts, the parameters, the EMA and AdamW's ``exp_avg`` and
    ``exp_avg_sq`` agree, at the bars of ``test_train_step_matches_jax``."""
    jmodel, params = pair
    batches = [_batch(10 + i) for i in range(n_steps)]
    batches[1]["z"][0, 0, 0, 0] = np.nan
    rngs = [jax.random.PRNGKey(20 + i) for i in range(n_steps)]
    opt = optax.adamw(1e-3, b1=0.9, b2=0.999, weight_decay=0.0)
    jstate = JaxTrainState.create(params, opt)
    jstep = jax.jit(jax_make_train_step(jax_make_loss_fn(jmodel, jax_create_diffusion("")), opt,
                                        accumulation_steps=accumulation_steps))
    model = _port_model(params)
    topt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.0)
    state = TrainState(model, topt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), topt,
                           accumulation_steps=accumulation_steps)
    named = dict(model.named_parameters())
    for i, (b, rng) in enumerate(zip(batches, rngs)):
        jstate, jmetrics = jstep(jstate, b, rng)
        metrics = step(state, _torch_batch(b, *_jax_draws(rng, b["z"].shape)), None)
        assert bool(metrics["finite"]) == bool(jmetrics["finite"]) == (i != 1)
        assert int(state.step) == int(jstate.step)
        adam = _adam_moments(jstate.opt_state)
        pairs = [(jstate.params, lambda n: named[n]),
                 (jstate.ema_params, state.ema.state_dict().get)]
        if topt.state[named["final_layer.linear.weight"]]:  # made at the first update
            pairs += [(adam.mu, lambda n: topt.state[named[n]]["exp_avg"]),
                      (adam.nu, lambda n: topt.state[named[n]]["exp_avg_sq"])]
            steps = {float(topt.state[p]["step"]) for p in named.values()}
            assert steps == {float(adam.count)}, (i, steps, adam.count)
        else:
            assert int(adam.count) == 0
        for tree, get in pairs:
            ref = diffma_params_from_jax(jax.tree.map(np.asarray, tree), depth=DEPTH)
            for name, v in ref.items():
                np.testing.assert_allclose(get(name).detach().numpy(), v.numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=f"step {i}: {name}")


def test_accumulation_updates_on_odd_iterations(pair):
    _, params = pair
    model = _port_model(params)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.0)
    state = TrainState(model, opt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), opt,
                           accumulation_steps=2)
    changed = []
    for i in range(4):
        before = [p.detach().clone() for p in model.parameters()]
        b = _torch_batch(_batch(30 + i), *_jax_draws(jax.random.PRNGKey(i), (BATCH, 4, INPUT, INPUT)))
        step(state, b, None)
        changed.append(any(not torch.equal(a, p) for a, p in zip(before, model.parameters())))
    assert changed == [True, False, True, False]
    assert state.step == 4


def test_nan_batch_is_skipped(pair):
    _, params = pair
    model = _port_model(params)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.0)
    state = TrainState(model, opt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), opt)
    draws = _jax_draws(jax.random.PRNGKey(1), (BATCH, 4, INPUT, INPUT))
    assert step(state, _torch_batch(_batch(1), *draws), None)["finite"]
    snap = ({k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.state_dict().items()},
            {k: v.clone() for k, v in opt.state[next(model.parameters())].items()})
    bad = _batch(2)
    bad["z"][0, 0, 0, 0] = np.nan
    metrics = step(state, _torch_batch(bad, *draws), None)
    assert not metrics["finite"] and state.step == 1
    for before, now in zip(snap, (model.state_dict(), state.ema.state_dict(),
                                  opt.state[next(model.parameters())])):
        for k, v in before.items():
            assert torch.equal(v, now[k]), k


def _train_cfg(tmp_path, **kw):
    cfg = Config(
        epochs=2, log_every=2, ckpt_every=4, accumulation_steps=1, lr=1e-3,
        results_dir=str(tmp_path / "results"), model="DiffMa-S/2", image_size=64,
        global_batch_size=2, global_seed=0, dt_rank=16, d_state=16, hidden_size=HIDDEN,
        synthetic_data=True, synthetic_dataset_size=6, max_steps=4,
    )
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("use_mamba2", [False, True])
def test_trainer_writes_a_checkpoint_the_sampler_reads(tmp_path, use_mamba2):
    state, history = train.main(
        _train_cfg(tmp_path, return_loss_history=True, use_mamba2=use_mamba2), device="cpu")
    assert isinstance(state.model.blocks[0].mamba1, Mamba2 if use_mamba2 else Mamba)
    assert state.step == 4 and history["loss"].shape == (4,)
    assert np.isfinite(history["loss"]).all() and set(history) == {"loss", "finite", "mse", "vb"}
    (exp,) = os.listdir(tmp_path / "results")
    assert exp == "000-DiffMa-S-2"
    ckpt = tmp_path / "results" / exp / "checkpoints" / "0000004.pt"
    assert ckpt.exists()
    loaded = sample.load_model(
        Config(model="DiffMa-S/2", image_size=64, hidden_size=HIDDEN, ckpt=str(ckpt),
               use_mamba2=use_mamba2), "cpu")
    ema = state.ema.state_dict()
    assert any(".norm.weight" in key for key in ema) == use_mamba2  # Mamba-2's gated norm
    for key, value in loaded.state_dict().items():
        assert torch.equal(value, ema[key]), key
    with pytest.raises(KeyError, match="does not fit"):  # the other family's names
        sample.load_model(
            Config(model="DiffMa-S/2", image_size=64, hidden_size=HIDDEN, ckpt=str(ckpt),
                   use_mamba2=not use_mamba2), "cpu")


def test_trainer_cli_on_cpu(tmp_path):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(
        "epochs: 1\nlr: 1e-3\nmodel: DiffMa-S/2\nimage_size: 32\nglobal_batch_size: 2\n"
        "synthetic_data: true\nsynthetic_dataset_size: 4\nhidden_size: 32\n"
    )
    state = train.cli(["--config", str(cfg_path), "--device", "cpu", "--max-steps", "1",
                       "--ckpt-every", "1", "--results-dir", str(tmp_path / "r")])
    assert state.step == 1
    assert os.listdir(tmp_path / "r" / "000-DiffMa-S-2" / "checkpoints") == ["0000001.pt"]
    state = train.cli(["--config", str(cfg_path), "--device", "cpu", "--max-steps", "1",
                       "--use-mamba2", "--results-dir", str(tmp_path / "r")])
    assert state.step == 1 and isinstance(state.model.blocks[1].mamba2, Mamba2)


@pytest.mark.parametrize(
    "override,match",
    [({"remat": True}, "remat"), ({"resume_from": "x"}, "Orbax"), ({"tp": 2}, "parallel"),
     ({"sp": 2}, "parallel")],
)
def test_trainer_refuses_what_is_not_ported(tmp_path, override, match):
    with pytest.raises(NotImplementedError, match=match):
        train.main(_train_cfg(tmp_path, **override), device="cpu")


def test_trainer_takes_autocast_with_use_mamba2(tmp_path):
    """``autocast`` with ``use_mamba2``: one step of the bf16 Mamba-2 model on
    the CPU (the plain versions of kernels E and F), its loss finite, its
    parameters and EMA fp32."""
    state, history = train.main(
        _train_cfg(tmp_path, autocast=True, use_mamba2=True, max_steps=1,
                   return_loss_history=True), device="cpu")
    assert int(state.step) == 1 and np.isfinite(history["loss"]).all()
    assert state.model.dtype == torch.bfloat16 and isinstance(state.model.blocks[0].mamba1, Mamba2)
    assert all(p.dtype == torch.float32 for m in (state.model, state.ema) for p in m.parameters())


def test_trainer_refuses_real_data_folders(tmp_path):
    """The real-data path runs (``tests/test_torch_embedder.py``); it refuses a
    model narrower than the conditioning stack, whose ``y`` joins the
    timestep embedding."""
    folders = {}
    for key in ("ct_image_folder_train", "mask_image_folder_train", "mir_image_folder_train"):
        (tmp_path / key).mkdir()
        folders[key] = str(tmp_path / key)
    with pytest.raises(ValueError, match="need hidden_size 512"):
        train.main(_train_cfg(tmp_path, synthetic_data=False, **folders), device="cpu")


def test_cuda_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(_train_cfg(tmp_path))
    x = _scan_inputs(1, 4, 8, 16, seed=0)
    args = [torch.from_numpy(x[k]) for k in ("u", "delta", "A", "B", "C", "D", "z", "g")]
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan.selective_scan_bwd_cuda(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan.selective_scan(*args[:7], impl="kernel")
    spec = build_scan_spec("spiral", 4, 0)
    xs = (torch.zeros(1, 16, HIDDEN),)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mixer.mixer_fused_bwd_cuda(spec, xs, xs, (Mamba(HIDDEN, spec).weights(),))


# ---------------------------------------------------------------------------
# Data and logging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("epoch", [0, 1])
def test_loader_matches_jax(epoch):
    got = list(make_loader(SyntheticTriplets(n=7, size=16), 2, seed=3, epoch=epoch))
    want = list(jax_make_loader(JaxSyntheticTriplets(n=7, size=16), 2, seed=3, epoch=epoch))
    assert len(got) == len(want) == 3  # drop_last
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_loader_stops_its_thread_when_closed():
    before = threading.active_count()
    loader = make_loader(SyntheticTriplets(n=40, size=8), 2, prefetch=1)
    next(loader)
    assert threading.active_count() == before + 1
    loader.close()
    assert threading.active_count() == before


class _RaisesOnThirdItem(SyntheticTriplets):
    """A dataset whose third read raises, as a missing or short file would."""

    def __init__(self):
        super().__init__(n=8, size=8)
        self.reads = 0

    def __getitem__(self, index):
        self.reads += 1
        if self.reads == 3:
            raise OSError("item 3 is unreadable")
        return super().__getitem__(index)


def test_loader_raises_what_the_dataset_raises():
    """The producer thread's exception reaches the consumer after the batch
    before it, instead of leaving it waiting on the queue for ever. The loader
    runs in a thread of its own, so that a regression fails the join's
    timeout rather than hanging the test."""
    before = threading.active_count()
    batches, raised = [], []

    def consume():
        try:
            for batch in make_loader(_RaisesOnThirdItem(), 2, prefetch=1):
                batches.append(batch)
        except OSError as e:
            raised.append(e)

    thread = threading.Thread(target=consume, daemon=True)
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive(), "the loader hung on the dataset's exception"
    assert len(batches) == 1 and [str(e) for e in raised] == ["item 3 is unreadable"]
    assert threading.active_count() == before


def test_experiment_dirs_match_jax(tmp_path):
    for _ in range(2):
        ours = create_experiment_dir(str(tmp_path / "a"), "DiffMa-L/2")
        theirs = jax_create_experiment_dir(str(tmp_path / "b"), "DiffMa-L/2")
        assert os.path.relpath(ours, tmp_path / "a") == os.path.relpath(theirs, tmp_path / "b")
        assert os.path.isdir(os.path.join(ours, "checkpoints"))


def test_step_profiler_writes_a_trace(tmp_path):
    """The trainer's ``profile_dir`` window: steps 2 and 3 traced to one
    Chrome trace (the CPU's activity only, here)."""
    prof = tmp_path / "prof"
    train.main(_train_cfg(tmp_path, profile_dir=str(prof), profile_start_step=1, profile_steps=2),
               device="cpu")
    assert os.listdir(prof) == ["trace_2-3.json"]
