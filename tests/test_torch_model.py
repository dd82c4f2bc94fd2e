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
from diffma_tpu_torch.models.diffma import DiffMa_models, build_model
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.models.mamba2 import Mamba2
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


def build_pair(name="DiffMa-S/2", seed=0, scan_impl="pallas", input_size=INPUT, **kw):
    """The JAX model with random params, and the port model carrying them;
    both take ``scan_impl`` and ``kw`` (``use_mamba2``, ``fuse_block``)."""
    jmodel = jax_build_model(name, input_size=input_size, hidden_size=HIDDEN, scan_impl=scan_impl,
                             **kw)
    x, t, y, y2, w = _inputs(1, input_size=input_size)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), *map(jnp.asarray, (x, t, y, y2, w)))
    params = params["params"]
    params = randomize(params, seed + 1)
    model = build_model(name, input_size=input_size, hidden_size=HIDDEN, scan_impl=scan_impl, **kw)
    state = diffma_params_from_jax(params, depth=model.depth, use_mamba2=kw.get("use_mamba2", False))
    model.load_state_dict(state, strict=True)
    return jmodel, params, model.eval()


def test_forward_matches_jax():
    _check_forward("pallas", INPUT)


@pytest.mark.parametrize("input_size", [INPUT, 10])
def test_fused_forward_matches_jax(input_size):
    """JAX's fused path (kernel C in interpret mode) against the port's on the
    CPU (kernel C's plain version), at 16 and 25 tokens."""
    _check_forward("fused", input_size)


@pytest.mark.parametrize(
    "scan_impl,fuse_block,input_size",
    [("auto", False, INPUT), ("fused", False, 10), ("fused", True, INPUT)],
)
def test_mamba2_forward_matches_jax(scan_impl, fuse_block, input_size):
    """``use_mamba2``: JAX's composable path, its fused SSD kernel and its
    whole-block kernels (interpret mode) against the port's three routes on
    the CPU (the plain versions), at 16 and 25 tokens."""
    _check_forward(scan_impl, input_size, use_mamba2=True, fuse_block=fuse_block)


def _check_forward(scan_impl, input_size, **kw):
    jmodel, params, model = build_pair(scan_impl=scan_impl, input_size=input_size, **kw)
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
    assert len(DiffMa_models) == 80
    assert set(DiffMa_models) == set(JAX_REGISTRY)
    assert sum(name.startswith("DiffMa-") for name in DiffMa_models) == 15
    assert DiffMa_models["DiffMa-B/2"] == (8, 2, "spiral")
    assert DiffMa_models["DiffMa-L/2"] == (16, 2, "spiral")
    assert DiffMa_models["EMamba-BL/2"] == (13, 2, "efficientVMamba")
    assert DiffMa_models["DiT-SB/2"] == (7, 2, "DiT")


@pytest.mark.parametrize("name", ["ZigMa-B/2", "DiT-SB/2", "EMamba-BL/2"])
def test_unported_names_raise(name):
    """No registry name is refused any more: these three, which once raised
    as not ported, build with the JAX entry's depth, patch and block family;
    only a name outside the registry raises."""
    model = build_model(name, input_size=8, hidden_size=32)
    jmodel = jax_build_model(name, input_size=8, hidden_size=32)
    assert (model.depth, model.patch_size, model.block_type) == (
        jmodel.depth, jmodel.patch_size, jmodel.block_type)
    assert len(model.blocks) == jmodel.depth
    with pytest.raises(KeyError, match="unknown model"):
        build_model(name.replace("/2", "/3"))


def test_init_is_identity_at_start():
    model = build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN)
    model.init_weights(torch.Generator().manual_seed(0))
    x, t, y, y2, w = map(torch.from_numpy, _inputs())
    with torch.no_grad():
        out = model(x, t.long(), y, y2, w)
    assert torch.count_nonzero(out) == 0  # zero final layer
    a = model.blocks[0].mamba1.A_log
    np.testing.assert_allclose(a[0].detach().numpy(), np.log(np.arange(1, 17)), rtol=1e-6)


def test_mamba2_init_statistics():
    """The Mamba-2 specials as the JAX package draws them: dt_bias the
    softplus inverse of a log-uniform dt in [1e-3, 1e-1], A_log = log U(1, 16),
    D and the norm weight 1, the conv U(+-1/2); adaLN and the final layer zero,
    so the model is the identity at the start."""
    model = build_model("DiffMa-B/2", input_size=INPUT, hidden_size=HIDDEN, use_mamba2=True)
    model.init_weights(torch.Generator().manual_seed(0))
    mixers = [m for m in model.modules() if isinstance(m, Mamba2)]
    assert len(mixers) == 16
    dt = torch.cat([torch.nn.functional.softplus(m.dt_bias.detach()) for m in mixers])
    a = torch.cat([torch.exp(m.A_log.detach()) for m in mixers])
    assert 1e-3 * (1 - 1e-4) <= dt.min() and dt.max() <= 1e-1 * (1 + 1e-4)
    assert abs(torch.log(dt).mean().item() - 0.5 * (np.log(1e-3) + np.log(1e-1))) < 0.6
    assert 1.0 <= a.min() and a.max() <= 16.0 and 5.0 < a.mean() < 12.0
    for m in mixers:
        assert torch.all(m.D == 1) and torch.all(m.norm.weight == 1)
        assert m.conv1d.weight.abs().max() <= 0.5 and m.conv1d.weight.std() > 0.2
        assert m.in_proj.weight.shape == (4 * HIDDEN + 2 * 16 + 2, HIDDEN)
    x, t, y, y2, w = map(torch.from_numpy, _inputs())
    with torch.no_grad():
        out = model(x, t.long(), y, y2, w)
    assert torch.count_nonzero(out) == 0
    # the JAX package's own draws lie in the same ranges
    jm = jax_build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN, use_mamba2=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *map(jnp.asarray, _inputs(1)))["params"]
    jdt = np.concatenate([np.asarray(jax.nn.softplus(params[f"block_{i}"][m]["dt_bias"]))
                          for i in range(4) for m in ("mamba1", "mamba2")])
    assert 1e-3 * (1 - 1e-4) <= jdt.min() and jdt.max() <= 1e-1 * (1 + 1e-4)


def test_build_model_mamba2_kwargs():
    model = build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN, use_mamba2=True,
                        fuse_block=True, scan_impl="fused")
    assert all(isinstance(b.mamba1, Mamba2) and isinstance(b.mamba2, Mamba2) and b.fuse_block
               and b.use_mamba2 for b in model.blocks)
    model.set_scan_impl("auto")
    assert {m.scan_impl for m in model.modules() if hasattr(m, "scan_impl")} == {"auto"}
    plain = build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN)
    assert all(isinstance(b.mamba1, Mamba) and not b.fuse_block for b in plain.blocks)
    assert set(model.state_dict()) != set(plain.state_dict())
    assert "blocks.0.mamba1.norm.weight" in model.state_dict()
    # fuse_block without Mamba-2 changes nothing, as in the JAX block
    m1 = build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN, fuse_block=True)
    m1.load_state_dict(plain.state_dict())
    x, t, y, y2, w = map(torch.from_numpy, _inputs())
    for m in (plain, m1):
        m.init_weights(torch.Generator().manual_seed(3))
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(4)))
    with torch.no_grad():
        torch.testing.assert_close(m1(x, t.long(), y, y2, w), plain(x, t.long(), y, y2, w),
                                   rtol=0, atol=0)
