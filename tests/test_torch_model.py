"""The port's DiffMa against the JAX package's, on the CPU, in fp32.

adaLN and the final layer start at zero, so both models would output zeros;
every parameter is overwritten with seeded random values first. Weights go
from the JAX tree to the port through ``diffma_params_from_jax``. The bars
are the JAX package's own model-parity bars: MAE < 1e-4, rtol = atol = 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.models.diffma import DiffMa_models as JAX_REGISTRY
from diffma_tpu.models.diffma import build_model as jax_build_model
from diffma_tpu_torch.models.diffma import NOT_PORTED, DiffMa_models, build_model
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.ops.scan_orders import build_scan_spec
from diffma_tpu_torch.utils.convert import _mamba1, diffma_params_from_jax

HIDDEN = 64
INPUT = 8  # latent 8x8, patch 2 -> 16 tokens
TOKENS = 16


def randomize(tree, seed):
    """Every leaf replaced by itself plus seeded noise (A stays negative)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree
    )


def _inputs(batch=2, seed=3, input_size=INPUT):
    rng = np.random.default_rng(seed)
    tokens = (input_size // 2) ** 2
    x = rng.standard_normal((batch, 4, input_size, input_size)).astype(np.float32)
    t = np.array([37, 912][:batch], np.int32)
    y = rng.standard_normal((batch, HIDDEN)).astype(np.float32)
    y2 = rng.standard_normal((batch, tokens, HIDDEN)).astype(np.float32)
    w = (1 / (1 + np.exp(-rng.standard_normal((batch, tokens, 1))))).astype(np.float32)
    return x, t, y, y2, w


def build_pair(name="DiffMa-S/2", seed=0, scan_impl="pallas", input_size=INPUT):
    """The JAX model with random params, and the port model carrying them;
    both take ``scan_impl``."""
    jmodel = jax_build_model(name, input_size=input_size, hidden_size=HIDDEN, scan_impl=scan_impl)
    x, t, y, y2, w = _inputs(1, input_size=input_size)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), *map(jnp.asarray, (x, t, y, y2, w)))
    params = params["params"]
    params = randomize(params, seed + 1)
    model = build_model(name, input_size=input_size, hidden_size=HIDDEN, scan_impl=scan_impl)
    model.load_state_dict(diffma_params_from_jax(params, depth=model.depth), strict=True)
    return jmodel, params, model.eval()


def test_forward_matches_jax():
    _check_forward("pallas", INPUT)


@pytest.mark.parametrize("input_size", [INPUT, 10])
def test_fused_forward_matches_jax(input_size):
    """JAX's fused path (kernel C in interpret mode) against the port's on the
    CPU (kernel C's plain version), at 16 and 25 tokens."""
    _check_forward("fused", input_size)


def _check_forward(scan_impl, input_size):
    jmodel, params, model = build_pair(scan_impl=scan_impl, input_size=input_size)
    x, t, y, y2, w = _inputs(input_size=input_size)
    want = np.asarray(
        jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, (x, t, y, y2, w)))
    )
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t.astype(np.int64), y, y2, w))).numpy()
    assert got.shape == want.shape == (2, 8, input_size, input_size)
    mae = np.abs(got - want).mean()
    assert mae < 1e-4, f"forward MAE {mae}"
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_mixer_matches_jax():
    from diffma_tpu.models.mamba import Mamba as JaxMamba
    from diffma_tpu.ops.scan_orders import build_scan_spec as jax_spec

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, HIDDEN)).astype(np.float32)
    jm = JaxMamba(d_model=HIDDEN, scan_impl="pallas")
    spec = jax_spec("spiral", 4, 3)
    params = jax.jit(lambda k, x: jm.init(k, x, spec))(jax.random.PRNGKey(0), jnp.asarray(x))
    params = randomize(params["params"], 6)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, spec))({"params": params}, x))
    sd = {}
    _mamba1(sd, "m", params)
    m = Mamba(HIDDEN, build_scan_spec("spiral", 4, 3))
    m.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_registry_covers_jax_names():
    assert len(DiffMa_models) == 15
    assert all(name.startswith("DiffMa-") for name in DiffMa_models)
    assert len(NOT_PORTED) == 65
    assert set(DiffMa_models) | NOT_PORTED == set(JAX_REGISTRY)
    assert DiffMa_models["DiffMa-B/2"] == (8, 2)
    assert DiffMa_models["DiffMa-L/2"] == (16, 2)


@pytest.mark.parametrize("name", ["ZigMa-B/2", "DiT-SB/2", "EMamba-BL/2"])
def test_unported_names_raise(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(name)


def test_init_is_identity_at_start():
    model = build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN)
    model.init_weights(torch.Generator().manual_seed(0))
    x, t, y, y2, w = map(torch.from_numpy, _inputs())
    with torch.no_grad():
        out = model(x, t.long(), y, y2, w)
    assert torch.count_nonzero(out) == 0  # zero final layer
    a = model.blocks[0].mamba1.A_log
    np.testing.assert_allclose(a[0].detach().numpy(), np.log(np.arange(1, 17)), rtol=1e-6)
