"""The port's diffusion samplers and VAE decoder against the JAX package's.

A 10-step respaced DDPM chain is fed JAX's own per-step noise
(``normal(fold_in(rng, i))``) through ``step_noise``; the DDIM chain (eta 0)
is deterministic. Latents and, after a small-channel VAE decode, pixels must
agree to MAE < 1e-3, the JAX package's DDIM pixel bar. The denoiser is the
small random DiffMa of ``test_torch_model``, with JAX's plain scan, and its
output head drawn at a tenth of the other weights' scale, so that its epsilon
and variance outputs stay near unit size, as a trained model's do. A random
denoiser does not predict the noise, so the chain's latents still end near
x_T / sqrt(alphabar_T), about 156 times the start (mean |latent| about 130):
the chain multiplies the model's fp32 rounding by up to that gain. With the
head at full scale (outputs about 3) the DDPM latents' MAE sat at about 1e-3,
so the bar asked for rounding luck; with the smaller head it is about 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.diffusion import create_diffusion as jax_create_diffusion
from diffma_tpu.diffusion.gaussian import space_timesteps as jax_space_timesteps
from diffma_tpu.models.diffma import build_model as jax_build_model
from diffma_tpu.models.vae import AutoencoderKL as JaxVAE
from diffma_tpu_torch.diffusion import create_diffusion, space_timesteps
from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.models.vae import AutoencoderKL
from diffma_tpu_torch.utils.convert import diffma_params_from_jax, vae_params_from_jax

from test_torch_model import HIDDEN, INPUT, _inputs, randomize

VAE_KW = dict(ch=32, ch_mult=(1, 1))
STEPS = 10
HEAD_SCALE = 0.1  # keeps the random denoiser's outputs near unit size


@pytest.mark.parametrize("spacing", ["10", "250", "ddim25", "5,3", ""])
def test_tables_and_respacing_match_jax(spacing):
    if spacing:
        assert space_timesteps(1000, spacing) == jax_space_timesteps(1000, spacing)
    ours, ref = create_diffusion(spacing, device="cpu"), jax_create_diffusion(spacing)
    assert ours.num_timesteps == ref.num_timesteps
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2", "log_betas", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    if ref.timestep_map is None:
        assert ours.timestep_map is None
    else:
        np.testing.assert_array_equal(ours.timestep_map.numpy(), np.asarray(ref.timestep_map))


@pytest.fixture(scope="module")
def pair():
    """Random JAX denoiser + VAE and the port models carrying their weights."""
    jmodel = jax_build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN, scan_impl="ref")
    x, t, y, y2, w = map(jnp.asarray, _inputs(1))
    mparams = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, t, y, y2, w)["params"], 1)
    head = mparams["final_layer"]["linear"]
    mparams["final_layer"]["linear"] = {k: HEAD_SCALE * v for k, v in head.items()}
    model = build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN)
    model.load_state_dict(diffma_params_from_jax(mparams, depth=model.depth), strict=True)

    jvae = JaxVAE(**VAE_KW)
    z = jnp.zeros((1, 4, INPUT, INPUT))
    init = jax.jit(lambda key, z: jvae.init(key, z, method=JaxVAE.decode))
    vparams = randomize(init(jax.random.PRNGKey(2), z)["params"], 4)  # decoder half
    vae = AutoencoderKL(**VAE_KW)
    vae.load_state_dict(vae_params_from_jax(vparams, ch_mult=(1, 1)), strict=True)
    return jmodel, mparams, model.eval(), jvae, vparams, vae.eval()


def test_vae_decode_matches_jax(pair):
    *_, jvae, vparams, vae = pair
    z = np.random.default_rng(7).standard_normal((2, 4, INPUT, INPUT)).astype(np.float32)
    want = np.asarray(jvae.apply({"params": vparams}, jnp.asarray(z), method=JaxVAE.decode))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 3, 2 * INPUT, 2 * INPUT)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_sampling_chain_matches_jax(pair, sampler):
    jmodel, mparams, model, jvae, vparams, vae = pair
    x, _, y, y2, w = _inputs(2)
    jdiff, diff = jax_create_diffusion(str(STEPS)), create_diffusion(str(STEPS), device="cpu")
    key = jax.random.PRNGKey(11)

    @jax.jit
    def jax_chain(z, y, y2, w):
        def model_fn(xx, tt, **kw):
            return jmodel.apply({"params": mparams}, xx, tt, **kw)

        loop = jdiff.p_sample_loop if sampler == "ddpm" else jdiff.ddim_sample_loop
        lat = loop(model_fn, z.shape, key, noise=z, clip_denoised=False,
                   model_kwargs={"y": y, "y2": y2, "w": w})
        return lat, jvae.apply({"params": vparams}, lat / 0.18215, method=JaxVAE.decode)

    want_lat, want_img = map(np.asarray, jax_chain(*map(jnp.asarray, (x, y, y2, w))))

    # JAX's per-step noise: split once, then fold in the step index.
    step_key, _ = jax.random.split(key)
    step_noise = [
        torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(step_key, i), x.shape)))
        for i in range(STEPS)
    ]
    loop = diff.p_sample_loop if sampler == "ddpm" else diff.ddim_sample_loop
    kw = {k: torch.from_numpy(v) for k, v in (("y", y), ("y2", y2), ("w", w))}
    lat = loop(model, x.shape, noise=torch.from_numpy(x), clip_denoised=False,
               model_kwargs=kw, step_noise=step_noise if sampler == "ddpm" else None)
    with torch.no_grad():
        img = vae.decode(lat / 0.18215)
    lat, img = lat.numpy(), img.numpy()

    assert np.isfinite(lat).all() and np.abs(lat - x).max() > 0.1  # the chain moved
    assert np.abs(lat - want_lat).mean() < 1e-3
    assert np.abs(img - want_img).mean() < 1e-3
