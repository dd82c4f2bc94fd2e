"""The port's fused Mamba-1 mixer against the JAX package's, on the CPU.

On the JAX side the fused mixer runs kernel C (``_mixer_kernel``) and its
backward kernel D (``_mixer_bwd_kernel``, through ``_monolithic_bwd``) in
interpret mode, as ``tests/test_fused_mixer.py`` runs them; on the port's
side CPU tensors take the plain versions, ``mixer_ref`` and
``mixer_bwd_ref``. Inputs come from numpy with fixed seeds. Bars: 2e-5 with
inputs at the scales of ``tests/test_fused_mixer.py::_args`` (that file's
bar), 2e-4 for gradients and with parameter trees put through ``randomize``
(the composable mixer test's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.models.blocks import SpiralMambaBlock as JaxSpiralMambaBlock
from diffma_tpu.models.mamba import Mamba as JaxMamba
from diffma_tpu.ops import fused_mixer as jax_fused
from diffma_tpu.ops.scan_orders import build_scan_spec as jax_spec
from diffma_tpu_torch.models.blocks import SpiralMambaBlock
from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.ops import fused_mixer
from diffma_tpu_torch.ops.scan_orders import ScanSpec, _build_merge_table, build_scan_spec
from diffma_tpu_torch.utils.convert import _mamba1, _spiral_block
from test_torch_model import HIDDEN, randomize

# (spiral grid, layer): 16 tokens at layers 0 and 3, and 25 tokens.
SPECS = [(4, 0), (4, 3), (5, 1)]
JAX_ORDER = ("in_w", "conv_w", "conv_b", "xp_w", "dt_w", "dt_b", "A", "D", "out_w")


def _weights(seed, h=32, d=64, n=8, r=4, K=4):
    """One mixer's weights in the JAX layout, at ``_args``'s scales."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    A_log = 0.3 * f(d, n)
    return dict(
        in_w=0.1 * f(h, 2 * d), conv_w=0.3 * f(d, K), conv_b=0.1 * f(d),
        xp_w=0.1 * f(d, r + 2 * n), dt_w=0.2 * f(r, d), dt_b=0.1 * f(d),
        A=-np.exp(A_log), A_log=A_log, D=f(d), out_w=0.1 * f(d, h),
    )


def _torch_weights(w):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return fused_mixer.MixerWeights(
        t(w["in_w"].T), t(w["conv_w"][:, None, :]), t(w["conv_b"]), t(w["xp_w"].T),
        t(w["dt_w"].T), t(w["dt_b"]), t(w["A_log"]), t(w["D"]), t(w["out_w"].T),
    )


def _x(L, seed, h=32, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, L, h)).astype(np.float32)


@pytest.mark.parametrize("grid_n,layer", SPECS)
def test_dual_mixer_matches_jax(grid_n, layer):
    spec_j, spec_t = jax_spec("spiral", grid_n, layer), build_scan_spec("spiral", grid_n, layer)
    L = grid_n * grid_n
    x0, x1 = _x(L, layer), _x(L, layer + 10)
    w0, w1 = _weights(layer), _weights(layer + 20)
    stacked = [jnp.stack([w0[k], w1[k]]) for k in JAX_ORDER]
    want = np.asarray(jax_fused.mamba_dual_mixer_fused(spec_j, jnp.stack([x0, x1]), *stacked))
    got = fused_mixer.mamba_dual_mixer_fused(
        spec_t, torch.from_numpy(x0), torch.from_numpy(x1), _torch_weights(w0), _torch_weights(w1)
    )
    for m in range(2):
        np.testing.assert_allclose(got[m].numpy(), want[m], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("grid_n,layer", SPECS)
def test_single_mixer_matches_jax(grid_n, layer):
    spec_j, spec_t = jax_spec("spiral", grid_n, layer), build_scan_spec("spiral", grid_n, layer)
    x, w = _x(grid_n * grid_n, layer + 30), _weights(layer + 40)
    want = np.asarray(jax_fused.mamba_mixer_fused(spec_j, jnp.asarray(x), *(w[k] for k in JAX_ORDER)))
    got = fused_mixer.mamba_mixer_fused(spec_t, torch.from_numpy(x), _torch_weights(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("grid_n,layer", SPECS)
def test_fused_mamba_module_matches_jax(grid_n, layer):
    """Randomised parameter trees through JAX's ``Mamba(scan_impl="fused")``
    and the port's, whose ``weights()`` feed the fused mixer."""
    spec_j = jax_spec("spiral", grid_n, layer)
    x = _x(grid_n * grid_n, layer + 50, h=HIDDEN)
    jm = JaxMamba(d_model=HIDDEN, scan_impl="fused")
    params = jax.jit(lambda k, x: jm.init(k, x, spec_j))(jax.random.PRNGKey(layer), jnp.asarray(x))
    params = randomize(params["params"], layer + 60)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, spec_j))({"params": params}, x))
    sd = {}
    _mamba1(sd, "m", params)
    m = Mamba(HIDDEN, build_scan_spec("spiral", grid_n, layer), scan_impl="fused")
    m.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("grid_n,layer", [(4, 3), (5, 0)])
def test_fused_block_matches_jax(grid_n, layer):
    """The Spiral block's dual fused branch, randomised weights carried over
    with the model converter's block mapping."""
    spec_j = jax_spec("spiral", grid_n, layer)
    L = grid_n * grid_n
    rng = np.random.default_rng(layer + 70)
    x = rng.standard_normal((2, L, HIDDEN)).astype(np.float32)
    c = rng.standard_normal((2, 2 * HIDDEN)).astype(np.float32)
    w = (1 / (1 + np.exp(-rng.standard_normal((2, L, 1))))).astype(np.float32)
    jb = JaxSpiralMambaBlock(hidden=HIDDEN, scan_impl="fused")
    params = jax.jit(lambda k, *a: jb.init(k, *a, spec_j))(jax.random.PRNGKey(layer), x, c, w)
    params = randomize(params["params"], layer + 80)
    want = np.asarray(jax.jit(lambda p, *a: jb.apply(p, *a, spec_j))({"params": params}, x, c, w))
    sd = {}
    _spiral_block(sd, "b", params)
    block = SpiralMambaBlock(HIDDEN, build_scan_spec("spiral", grid_n, layer), scan_impl="fused")
    block.load_state_dict({k.removeprefix("b."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = block(*map(torch.from_numpy, (x, c, w))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "family,layer,partition",
    [("spiral", 0, False), ("zig", 2, False), ("vmamba", 0, False), ("vim", 0, False),
     ("eff", 0, False), ("eff", 0, True)],
)
def test_eligibility_matches_jax(family, layer, partition):
    ours = fused_mixer.mixer_fused_eligible(build_scan_spec(family, 4, layer), partition)
    assert ours == jax_fused.mixer_fused_eligible(jax_spec(family, 4, layer), partition)


def test_cpu_tensors_take_the_plain_version():
    spec = build_scan_spec("spiral", 4, 1)
    x, w = torch.from_numpy(_x(16, 1)), _torch_weights(_weights(1))
    before = fused_mixer.mixer_fused_cuda.launches
    got = fused_mixer.mamba_mixer_fused(spec, x, w)
    assert fused_mixer.mixer_fused_cuda.launches == before
    torch.testing.assert_close(got, fused_mixer.mixer_ref(spec, x, w), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mixer.mixer_fused_cuda(spec, (x,), (w,))
    with pytest.raises(ValueError, match="unknown impl"):
        fused_mixer.mamba_mixer_fused(spec, x, w, impl="pallas")


def test_what_is_not_ported_raises():
    """Every registry spec runs through kernels C and D now: the backward
    takes the vim quirk and the partition (on CPU tensors it gets past the
    spec checks and refuses only the device), and the fused route carries
    their gradients. What still raises is a dual call with the vim quirk,
    and a spec that is neither full-length nor an exact partition (it goes
    through ``mamba_inner_fused``, not through kernels C and D)."""
    w = _torch_weights(_weights(0))
    x = torch.from_numpy(_x(16, 0))
    vim, eff = build_scan_spec("vim", 4, 0), build_scan_spec("eff", 4, 0)
    for spec in (vim, eff):
        assert fused_mixer.mamba_mixer_fused(spec, x, w).shape == x.shape
        with pytest.raises(ValueError, match="CUDA tensors"):
            fused_mixer.mixer_fused_bwd_cuda(spec, (x,), (x,), (w,))
        xg = x.clone().requires_grad_()
        fused_mixer.mamba_mixer_fused(spec, xg, w).sum().backward()
        assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    assert Mamba(32, vim, scan_impl="fused").spec is vim
    assert Mamba(32, eff, d_state=8, scan_impl="fused")(x).shape == x.shape
    with pytest.raises(ValueError, match="vim quirk"):
        fused_mixer.mamba_dual_mixer_fused(vim, x, x, w, w)
    with pytest.raises(ValueError, match="vim quirk"):
        fused_mixer.mixer_fused_bwd_cuda(vim, (x, x), (x, x), (w, w))
    doubled = ScanSpec(fwd=np.concatenate([eff.fwd, eff.fwd[:, ::-1]]),
                       merge=_build_merge_table(np.concatenate([eff.fwd, eff.fwd[:, ::-1]]), 16),
                       scale=0.5)
    with pytest.raises(NotImplementedError, match="mamba_inner_fused"):
        fused_mixer.mamba_mixer_fused(doubled, x, w)
    with pytest.raises(NotImplementedError, match="mamba_inner_fused"):
        fused_mixer.mixer_fused_bwd_cuda(doubled, (x,), (x,), (w,))


def test_unknown_scan_impl_raises():
    spec = build_scan_spec("spiral", 4, 0)
    with pytest.raises(ValueError, match="unknown scan_impl"):
        Mamba(32, spec, scan_impl="flash")
    with pytest.raises(ValueError, match="unknown scan_impl"):
        SpiralMambaBlock(32, spec, scan_impl="mamba2")
    with pytest.raises(ValueError, match="unknown scan_impl"):
        build_model("DiffMa-S/2", input_size=8, hidden_size=32, scan_impl="tpu")
    model = build_model("DiffMa-S/2", input_size=8, hidden_size=32)
    with pytest.raises(ValueError, match="unknown scan_impl"):
        model.set_scan_impl("Fused")
    mixer = model.blocks[0].mamba1
    mixer.scan_impl = "xla"
    with pytest.raises(ValueError, match="unknown scan_impl"):
        mixer(torch.zeros(1, 16, 32))
    model.set_scan_impl("fused")
    assert {m.scan_impl for m in model.modules() if hasattr(m, "scan_impl")} == {"fused"}


def _grad_case(L, M, seed, h=16, d=32, n=4):
    ws = [_weights(seed + m, h=h, d=d, n=n) for m in range(M)]
    xs = [_x(L, seed + 10 + m, h=h) for m in range(M)]
    gs = [_x(L, seed + 20 + m, h=h) for m in range(M)]
    return ws, xs, gs


def _assert_mixer_grads(spec_t, ws, xs, gs, want_gx, want_w):
    """``mixer_bwd_ref`` against JAX's gradients (JAX weight layout), with
    A's gradient carried to A_log through A = -exp(A_log)."""
    for m, (w, x, g) in enumerate(zip(ws, xs, gs)):
        gx, gw = fused_mixer.mixer_bwd_ref(spec_t, torch.from_numpy(x), torch.from_numpy(g),
                                           _torch_weights(w))
        np.testing.assert_allclose(gx.numpy(), want_gx[m], rtol=2e-4, atol=2e-4)
        jw = {k: np.asarray(v[m]) for k, v in want_w.items()}
        jw["A_log"] = jw.pop("A") * w["A"]
        for name, got in zip(fused_mixer.MixerWeights._fields, gw):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(_torch_weights({**w, **jw})._asdict()[name]),
                rtol=2e-4, atol=2e-4, err_msg=name,
            )


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("grid_n,layer", [(4, 3), (5, 0)])
def test_mixer_bwd_matches_jax_monolithic(grid_n, layer, stacked):
    """The plain backward against JAX's monolithic backward (kernel D in
    interpret mode), one mixer or both branches stacked."""
    spec_j, spec_t = jax_spec("spiral", grid_n, layer), build_scan_spec("spiral", grid_n, layer)
    M = 2 if stacked else 1
    ws, xs, gs = _grad_case(grid_n * grid_n, M, seed=layer)
    if stacked:
        args = [jnp.stack([w[k] for w in ws]) for k in JAX_ORDER]
        out = jax_fused._monolithic_bwd(spec_j, jnp.stack(xs), jnp.stack(gs), *args, stacked=True)
    else:
        out = jax_fused._monolithic_bwd(spec_j, xs[0], gs[0], *(ws[0][k] for k in JAX_ORDER))
        out = [o[None] for o in out]
    want_w = dict(zip(JAX_ORDER, out[1:]))
    _assert_mixer_grads(spec_t, ws, xs, gs, np.asarray(out[0]), want_w)


def test_a_log_gradient_through_the_fused_vjp_matches_jax():
    """JAX's gradient of the fused mixer's A_log, through its custom VJP and
    A = -exp(A_log) outside the kernel, equals the port's."""
    spec_j, spec_t = jax_spec("spiral", 4, 1), build_scan_spec("spiral", 4, 1)
    (w,), (x,), (g,) = _grad_case(16, 1, seed=40)

    def f(A_log):
        args = [w[k] if k != "A" else -jnp.exp(A_log) for k in JAX_ORDER]
        return jnp.sum(jax_fused.mamba_mixer_fused(spec_j, jnp.asarray(x), *args) * g)

    want = np.asarray(jax.grad(f)(jnp.asarray(w["A_log"])))
    _, gw = fused_mixer.mixer_bwd_ref(spec_t, torch.from_numpy(x), torch.from_numpy(g),
                                      _torch_weights(w))
    np.testing.assert_allclose(gw.A_log.numpy(), want, rtol=2e-4, atol=2e-4)
