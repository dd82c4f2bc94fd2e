"""The port's whole diffusion API against the JAX package's, on the CPU.

Every ``ModelMeanType``, ``ModelVarType`` and ``LossType``: ``p_mean_variance``
(with ``denoised_fn``), ``training_losses``, guidance (``condition_mean``,
``condition_score``, and ``cond_fn`` through the DDPM and DDIM chains),
``ddim_reverse_sample``, the progressive loops, ``calc_bpd_loop`` and the
prior's bits per dim, the timestep samplers, ``create_diffusion``'s
``sigma_small``, ``predict_xstart`` and ``learn_sigma``, and the model's
``learn_sigma``, ``in_channels`` and ``forward_with_cfg``. Both packages get
the same numpy inputs and the same noise (JAX's own draws where JAX draws
it). The denoisers are fixed functions of (x, t), as in the JAX package's
``tests/test_reference_diffusion_parity.py``; ``cond_fn`` is the gradient of
a fixed scalar function, ``jax.grad`` of it on the JAX side and
``torch.autograd.grad`` of the same on the port's. Bars, the JAX package's
own: pointwise terms rtol = atol 2e-4 (``tests/test_reference_model_parity.py``),
chains a mean absolute error under 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.diffusion import create_diffusion as jax_create_diffusion
from diffma_tpu.diffusion import gaussian as jg
from diffma_tpu.diffusion import timestep_samplers as jts
from diffma_tpu.models.diffma import DiffMa as JaxDiffMa
from diffma_tpu_torch.diffusion import (
    GaussianDiffusion,
    LossSecondMomentResampler,
    LossType,
    ModelMeanType,
    ModelVarType,
    UniformSampler,
    create_diffusion,
    create_named_schedule_sampler,
    get_named_beta_schedule,
    space_timesteps,
)
from diffma_tpu_torch.models.diffma import DiffMa
from diffma_tpu_torch.utils.convert import diffma_params_from_jax
from test_torch_model import randomize

TOL = 2e-4  # pointwise: the model-parity bar
MAE = 1e-3  # chains
SHAPE = (2, 4, 7, 7)
MEANS = list(ModelMeanType)
VARS = list(ModelVarType)
LOSSES = list(LossType)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(spacing="", mean=ModelMeanType.EPSILON, var=ModelVarType.LEARNED_RANGE,
          loss=LossType.MSE, steps=1000):
    """The same process in both packages: ``spacing`` of a ``steps`` linear
    schedule, with the given types."""
    kept = sorted(space_timesteps(steps, spacing or [steps]))
    acp = np.cumprod(1.0 - get_named_beta_schedule("linear", steps))[kept]
    betas = 1.0 - acp / np.append(1.0, acp[:-1])  # as create_diffusion rebuilds them
    tmap = None if kept == list(range(steps)) else kept
    ref = jg.GaussianDiffusion.create(betas, jg.ModelMeanType[mean.name],
                                      jg.ModelVarType[var.name], jg.LossType[loss.name], tmap)
    ours = GaussianDiffusion.create(betas, mean, var, loss, tmap, device="cpu")
    return ref, ours


def _learned(var):
    return var in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE)


def _model_jax(var):
    def model(x, t, **kw):
        tt = (t.astype(jnp.float32) / 100.0)[:, None, None, None]
        out = jnp.tanh(x) * (1.0 + 0.1 * tt)
        if _learned(var):
            v = jnp.sin(x + tt) if var == ModelVarType.LEARNED_RANGE else -2.0 + 0.5 * jnp.sin(x)
            out = jnp.concatenate([out, v], axis=1)
        return out
    return model


def _model_torch(var):
    def model(x, t, **kw):
        tt = (t.float() / 100.0)[:, None, None, None]
        out = torch.tanh(x) * (1.0 + 0.1 * tt)
        if _learned(var):
            v = torch.sin(x + tt) if var == ModelVarType.LEARNED_RANGE else -2.0 + 0.5 * torch.sin(x)
            out = torch.cat([out, v], dim=1)
        return out
    return model


def _cond_jax(x, t, **kw):
    """grad of sum(sin(x) * (1 + t / 50)) / 20, a fixed log p(y | x)."""
    scale = (1.0 + t.astype(jnp.float32) / 50.0)[:, None, None, None]
    return jax.grad(lambda v: jnp.sum(jnp.sin(v) * scale) / 20.0)(x)


def _cond_torch(x, t, **kw):
    scale = (1.0 + t.float() / 50.0)[:, None, None, None]
    with torch.enable_grad():
        v = x.detach().requires_grad_(True)
        return torch.autograd.grad((torch.sin(v) * scale).sum() / 20.0, v)[0]


def _denoised_jax(x):
    return 0.9 * x + 0.05


def _denoised_torch(x):
    return 0.9 * x + 0.05


def _np(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, err="", tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=err)


@pytest.mark.parametrize("var", VARS, ids=lambda v: v.name)
@pytest.mark.parametrize("mean", MEANS, ids=lambda m: m.name)
def test_p_mean_variance_every_type_matches_jax(mean, var):
    """Respaced to 25 steps; t at both ends and inside; clipped with a
    ``denoised_fn`` and not."""
    ref, ours = _pair("25", mean, var)
    x = _np(1)
    for tv in ([0, 24], [1, 12]):
        t = np.array(tv, np.int64)
        for clip, dj, dt in ((False, None, None), (True, _denoised_jax, _denoised_torch)):
            want = ref.p_mean_variance(_model_jax(var), jnp.asarray(x), jnp.asarray(t),
                                       clip_denoised=clip, denoised_fn=dj)
            got = ours.p_mean_variance(_model_torch(var), torch.from_numpy(x),
                                       torch.from_numpy(t), clip_denoised=clip, denoised_fn=dt)
            for k in ("mean", "variance", "log_variance", "pred_xstart"):
                _close(got[k].expand(want[k].shape), want[k], f"{k} t={tv} clip={clip}")


@pytest.mark.parametrize("var", VARS, ids=lambda v: v.name)
@pytest.mark.parametrize("mean", MEANS, ids=lambda m: m.name)
@pytest.mark.parametrize("loss", LOSSES, ids=lambda v: v.name)
def test_training_losses_every_type_matches_jax(loss, mean, var):
    ref, ours = _pair("", mean, var, loss)
    x0, noise = _np(2), _np(3)
    t = np.array([0, 700], np.int64)
    want = ref.training_losses(_model_jax(var), jnp.asarray(x0), jnp.asarray(t),
                               jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    got = ours.training_losses(_model_torch(var), torch.from_numpy(x0), torch.from_numpy(t),
                               noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


def test_vb_term_trains_the_variance_only():
    """With a learned variance, the VB term's gradient reaches the variance's
    values and not the prediction (the frozen-output trick)."""
    _, ours = _pair("")
    x0, noise = torch.from_numpy(_np(4)), torch.from_numpy(_np(5))
    out = torch.from_numpy(_np(6, (2, 8, 7, 7))).requires_grad_(True)
    terms = ours.training_losses(lambda x, t: out, x0, torch.tensor([5, 600]), noise=noise)
    (g,) = torch.autograd.grad(terms["vb"].sum(), out)
    assert g[:, :4].abs().max() == 0 and g[:, 4:].abs().max() > 0


def test_condition_mean_and_score_match_jax():
    """Both guidance forms, respaced so that ``cond_fn`` gets remapped
    timesteps."""
    ref, ours = _pair("25")
    x, t = _np(7), np.array([3, 20], np.int64)
    var = ModelVarType.LEARNED_RANGE
    want_pmv = ref.p_mean_variance(_model_jax(var), jnp.asarray(x), jnp.asarray(t),
                                   clip_denoised=False)
    got_pmv = ours.p_mean_variance(_model_torch(var), torch.from_numpy(x), torch.from_numpy(t),
                                   clip_denoised=False)
    _close(ours.condition_mean(_cond_torch, got_pmv, torch.from_numpy(x), torch.from_numpy(t)),
           ref.condition_mean(_cond_jax, want_pmv, jnp.asarray(x), jnp.asarray(t)))
    got = ours.condition_score(_cond_torch, got_pmv, torch.from_numpy(x), torch.from_numpy(t))
    want = ref.condition_score(_cond_jax, want_pmv, jnp.asarray(x), jnp.asarray(t))
    for k in ("mean", "pred_xstart"):
        _close(got[k], want[k], k)


def _jax_step_noise(key, n, shape):
    """The noise JAX's loops draw at step i: ``normal(fold_in(key', i))``
    with key' the first half of ``split(key)``."""
    step_key, _ = jax.random.split(key)
    return [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(step_key, i), shape)))
            for i in range(n)]


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_guided_chains_match_jax(sampler):
    """10-step chains with ``cond_fn`` and ``denoised_fn``, DDPM on JAX's
    step noise and DDIM at eta 0 (deterministic)."""
    ref, ours = _pair("10")
    var, z, key = ModelVarType.LEARNED_RANGE, _np(8), jax.random.PRNGKey(5)
    loop_j = ref.p_sample_loop if sampler == "ddpm" else ref.ddim_sample_loop
    loop_t = ours.p_sample_loop if sampler == "ddpm" else ours.ddim_sample_loop
    want = loop_j(_model_jax(var), SHAPE, key, noise=jnp.asarray(z), clip_denoised=True,
                  cond_fn=_cond_jax, denoised_fn=_denoised_jax)
    got = loop_t(_model_torch(var), SHAPE, noise=torch.from_numpy(z), clip_denoised=True,
                 cond_fn=_cond_torch, denoised_fn=_denoised_torch,
                 step_noise=_jax_step_noise(key, 10, SHAPE))
    assert np.abs(got.numpy() - z).max() > 0.1  # the chain moved
    assert np.abs(got.numpy() - np.asarray(want)).mean() < MAE
    _close(got, want, tol=1e-3)
    with pytest.raises(ValueError, match="runs eagerly"):
        loop_t(_model_torch(var), SHAPE, noise=torch.from_numpy(z), cond_fn=_cond_torch,
               graph=object())


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_progressive_loops_match_jax(sampler):
    """Each yielded step against JAX's stacked ``sample[i]`` and
    ``pred_xstart[i]``; the last yield is the loop's result."""
    ref, ours = _pair("10")
    var, z, key = ModelVarType.LEARNED_RANGE, _np(9), jax.random.PRNGKey(6)
    if sampler == "ddpm":
        want = ref.p_sample_loop_progressive(_model_jax(var), SHAPE, key, noise=jnp.asarray(z),
                                             clip_denoised=False)
        steps = list(ours.p_sample_loop_progressive(
            _model_torch(var), SHAPE, noise=torch.from_numpy(z), clip_denoised=False,
            step_noise=_jax_step_noise(key, 10, SHAPE)))
        last = ours.p_sample_loop(_model_torch(var), SHAPE, noise=torch.from_numpy(z),
                                  clip_denoised=False, step_noise=_jax_step_noise(key, 10, SHAPE))
    else:
        want = ref.ddim_sample_loop_progressive(_model_jax(var), SHAPE, key,
                                                noise=jnp.asarray(z), clip_denoised=False)
        steps = list(ours.ddim_sample_loop_progressive(
            _model_torch(var), SHAPE, torch.Generator().manual_seed(0),
            noise=torch.from_numpy(z), clip_denoised=False))
        last = ours.ddim_sample_loop(_model_torch(var), SHAPE, torch.Generator().manual_seed(0),
                                     noise=torch.from_numpy(z), clip_denoised=False)
    assert len(steps) == ours.num_timesteps == want["sample"].shape[0]
    for i, out in enumerate(steps):
        for k in ("sample", "pred_xstart"):
            _close(out[k], want[k][i], f"step {i} {k}", tol=1e-3)
    assert torch.equal(steps[-1]["sample"], last)
    _close(last, want["final"], tol=1e-3)


def test_ddim_reverse_sample_matches_jax():
    """Respaced, at t = 0 and t = T - 1 (alphas_cumprod_next = 0), with and
    without ``cond_fn``; then 10 reverse steps from an image and the DDIM
    chain back reach it again."""
    ref, ours = _pair("25")
    var, x = ModelVarType.LEARNED_RANGE, _np(11)
    for tv in ([0, 12], [20, 24]):
        t = np.array(tv, np.int64)
        for cj, ct in ((None, None), (_cond_jax, _cond_torch)):
            want = ref.ddim_reverse_sample(_model_jax(var), jnp.asarray(x), jnp.asarray(t),
                                           clip_denoised=False, cond_fn=cj)
            got = ours.ddim_reverse_sample(_model_torch(var), torch.from_numpy(x),
                                           torch.from_numpy(t), clip_denoised=False, cond_fn=ct)
            for k in ("sample", "pred_xstart"):
                _close(got[k], want[k], f"{k} t={tv} cond={ct is not None}")


def test_calc_bpd_loop_matches_jax():
    """The whole bound on 25 steps with the same per-step noise (``noise[i]``
    at t = T-1-i): total and prior bits per dim, and the (B, T) stacks of
    the VB terms and the two MSEs, column j at t = T-1-j."""
    ref, ours = _pair("25")
    var, x0 = ModelVarType.LEARNED_RANGE, np.clip(_np(13), -1, 1)
    noise = np.random.default_rng(14).standard_normal((25,) + SHAPE).astype(np.float32)
    want = ref.calc_bpd_loop(_model_jax(var), jnp.asarray(x0), jax.random.PRNGKey(0),
                             clip_denoised=False, noise=jnp.asarray(noise))
    got = ours.calc_bpd_loop(_model_torch(var), torch.from_numpy(x0), clip_denoised=False,
                             noise=torch.from_numpy(noise))
    assert got["vb"].shape == (2, 25)
    for k in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        _close(got[k], want[k], k)
    _close(ours._prior_bpd(torch.from_numpy(x0)), ref._prior_bpd(jnp.asarray(x0)))
    drawn = ours.calc_bpd_loop(_model_torch(var), torch.from_numpy(x0),
                               torch.Generator().manual_seed(1))
    assert torch.isfinite(drawn["total_bpd"]).all()


@pytest.mark.parametrize("kw", [{}, {"sigma_small": True, "learn_sigma": False},
                                {"learn_sigma": False}, {"predict_xstart": True},
                                {"use_kl": True}, {"rescale_learned_sigmas": True}],
                         ids=lambda kw: ",".join(kw) or "default")
def test_create_diffusion_options_match_jax(kw):
    ref, ours = jax_create_diffusion("50", **kw), create_diffusion("50", device="cpu", **kw)
    assert (ours.model_mean_type.name, ours.model_var_type.name, ours.loss_type.name) == (
        ref.model_mean_type.name, ref.model_var_type.name, ref.loss_type.name)
    assert ours.original_num_steps == ref.original_num_steps == 1000
    for name in ("alphas_cumprod_next", "fixed_large_variance", "fixed_large_log_variance",
                 "posterior_variance", "betas"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))


def test_uniform_sampler():
    d = create_diffusion("", device="cpu")
    t, w = UniformSampler(d).sample(4096, torch.Generator().manual_seed(0))
    assert t.shape == w.shape == (4096,) and t.dtype == torch.long
    assert 0 <= int(t.min()) and int(t.max()) < 1000 and len(t.unique()) > 900
    assert torch.equal(w, torch.ones(4096))


def test_loss_second_moment_resampler_matches_jax():
    """The same updates give JAX's weights exactly (numpy on both sides);
    then the draws follow them and carry the weights 1 / (T p(t))."""
    kw = dict(noise_schedule="squaredcos_cap_v2", diffusion_steps=8)
    d, jd = create_diffusion("8", device="cpu", **kw), jax_create_diffusion("8", **kw)
    ours, ref = LossSecondMomentResampler(d, history_per_term=3), jts.LossSecondMomentResampler(
        jd, history_per_term=3)
    assert isinstance(create_named_schedule_sampler("loss-second-moment", d),
                      LossSecondMomentResampler)
    rng = np.random.default_rng(0)
    for step in range(5):
        ts = np.arange(8)
        losses = rng.uniform(0.1, 2.0, 8) * (1 + ts)
        ours.update_with_local_losses(torch.from_numpy(ts), torch.from_numpy(losses))
        ref.update_with_local_losses(ts, losses)
        np.testing.assert_array_equal(ours.weights(), ref.weights(), err_msg=f"update {step}")
    p = ours.weights() / ours.weights().sum()
    assert p[7] > 3 * p[0]
    t, w = ours.sample(20000, torch.Generator().manual_seed(1))
    freq = np.bincount(t.numpy(), minlength=8) / 20000
    np.testing.assert_allclose(freq, p, atol=0.015)
    np.testing.assert_allclose(w.numpy(), 1.0 / (8 * p[t.numpy()]), rtol=1e-6)


# ---------------------------------------------------------------------------
# The model: learn_sigma, in_channels, forward_with_cfg
# ---------------------------------------------------------------------------

HIDDEN, INPUT = 32, 8


def _model_pair(learn_sigma, in_channels):
    """A depth-1 zig DiffMa in both packages with the same random weights."""
    kw = dict(input_size=INPUT, patch_size=2, depth=1, block_type="zig", hidden_size=HIDDEN,
              d_state=4, learn_sigma=learn_sigma, in_channels=in_channels)
    jmodel = JaxDiffMa(scan_impl="ref", **kw)
    x, t, y, y2, w = _model_inputs(4, in_channels)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *map(jnp.asarray,
                                                                             (x, t, y, y2, w))))
    params = randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)["params"], 3)
    model = DiffMa(**kw)
    model.load_state_dict(diffma_params_from_jax(params, depth=1, in_channels=in_channels))
    return jmodel, params, model.eval()


def _model_inputs(batch, channels):
    rng = np.random.default_rng(21)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tokens = (INPUT // 2) ** 2
    return (f(batch, channels, INPUT, INPUT), np.array([3, 400, 17, 999][:batch], np.int32),
            f(batch, HIDDEN), f(batch, tokens, HIDDEN),
            (1 / (1 + np.exp(-f(batch, tokens, 1)))).astype(np.float32))


@pytest.mark.parametrize("learn_sigma,in_channels", [(False, 4), (True, 3)])
def test_learn_sigma_and_in_channels_match_jax(learn_sigma, in_channels):
    jmodel, params, model = _model_pair(learn_sigma, in_channels)
    args = _model_inputs(2, in_channels)
    want = jmodel.apply({"params": params}, *map(jnp.asarray, args))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    assert got.shape == want.shape == (2, in_channels * (2 if learn_sigma else 1), INPUT, INPUT)
    _close(got, want)


def test_forward_with_cfg_guides_three_channels_as_jax():
    """The guided prediction replaces the first 3 channels of both halves;
    the fourth latent channel and the variance stay the model's own."""
    jmodel, params, model = _model_pair(True, 4)
    x, t, y, y2, w = _model_inputs(4, 4)
    t = np.array([3, 400, 3, 400], np.int32)
    want = jmodel.forward_with_cfg({"params": params}, *map(jnp.asarray, (x, t, y, y2, w)), 4.0)
    with torch.no_grad():
        got = model.forward_with_cfg(*(torch.from_numpy(a) for a in (x, t, y, y2, w)), 4.0)
        plain = model(torch.from_numpy(np.concatenate([x[:2], x[:2]])), *(
            torch.from_numpy(a) for a in (t, y, y2, w)))
    assert got.shape == (4, 8, INPUT, INPUT)
    _close(got, want)
    assert torch.equal(got[:2, :3], got[2:, :3])
    assert torch.equal(got[:, 3:], plain[:, 3:])
    assert not torch.equal(got[:, :3], plain[:, :3])
