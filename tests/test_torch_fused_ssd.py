"""The port's fused Mamba-2 (SSD) mixer and Spiral block against the JAX package's, on the CPU.

On the JAX side ``mamba2_mixer_fused``, ``mamba2_dual_mixer_fused`` and
``spiral_block_fused`` run their Pallas kernels (``_ssd_kernel``,
``_spiral_epilogue_kernel``) in interpret mode, as ``tests/test_fused_ssd.py``
runs them; on the port's side CPU tensors take the plain versions,
``ssd_mixer_ref`` and ``spiral_block_ref``; ``ssd_mixer_bwd_ref``, the plain
version of the backward kernel, is held against JAX's ``_ssd_bwd_kernel``
(through the fused mixers' custom VJPs). Inputs come from numpy with fixed
seeds. Bars: 2e-5 with inputs at the scales of
``tests/test_fused_ssd.py::_args`` (that file's bar), 2e-4 for gradients and
with parameter trees put through ``randomize`` (the model tests' bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.models.blocks import SpiralMambaBlock as JaxSpiralMambaBlock
from diffma_tpu.models.mamba2 import Mamba2 as JaxMamba2
from diffma_tpu.ops import fused_ssd as jax_fused
from diffma_tpu.ops.scan_orders import build_scan_spec as jax_spec
from diffma_tpu_torch.models.blocks import SpiralMambaBlock
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.ops import fused_ssd
from diffma_tpu_torch.ops.scan_orders import build_scan_spec
from diffma_tpu_torch.utils.convert import _mamba2, _spiral_block
from test_torch_model import HIDDEN, randomize

NO_LIMIT = (0.0, float("inf"))
JAX_ORDER = ("in_w", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_w", "out_w")


def _weights(seed, h=32, d=64, n=8, H=4, K=4, dt_bias=None):
    """One mixer's weights in the JAX layout, at ``_args``'s scales."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dproj, conv_dim = 2 * d + 2 * n + H, d + 2 * n
    return dict(
        in_w=0.05 * f(h, dproj), conv_w=0.3 * f(conv_dim, K), conv_b=0.1 * f(conv_dim),
        dt_bias=0.2 * f(H) if dt_bias is None else np.full(H, dt_bias, np.float32),
        A_log=rng.uniform(0.0, 1.5, H).astype(np.float32), D=0.5 * f(H) + 1.0,
        norm_w=0.1 * f(d) + 1.0, out_w=0.05 * f(d, h),
    )


def _torch_weights(w):
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    return fused_ssd.Mamba2Weights(
        t(w["in_w"].T), t(w["conv_w"][:, None, :]), t(w["conv_b"]), t(w["dt_bias"]),
        t(w["A_log"]), t(w["D"]), t(w["norm_w"]), t(w["out_w"].T),
    )


def _x(L, seed, h=32, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, L, h)).astype(np.float32)


def _jax_single(spec, x, w, dt_limit=NO_LIMIT):
    return np.asarray(jax_fused.mamba2_mixer_fused(
        spec, jnp.asarray(x), *(w[k] for k in JAX_ORDER), dt_limit, 1e-5, 256))


# (family, grid, layer): spiral layers 0 and 3 at 16 tokens, 25 tokens (not a
# multiple of 8, which the TPU kernel pads to), one stream, four streams, and
# vim (Mamba-2 merges it the standard way, without Mamba-1's quirk).
SPECS = [("spiral", 4, 0), ("spiral", 4, 3), ("spiral", 5, 1), ("zig", 5, 1), ("vmamba", 4, 0),
         ("vim", 4, 0)]


@pytest.mark.parametrize("family,grid_n,layer", SPECS)
def test_single_mixer_matches_jax(family, grid_n, layer):
    spec_j, spec_t = jax_spec(family, grid_n, layer), build_scan_spec(family, grid_n, layer)
    x, w = _x(grid_n * grid_n, layer), _weights(layer + 10)
    got = fused_ssd.mamba2_mixer_fused(spec_t, torch.from_numpy(x), _torch_weights(w))
    np.testing.assert_allclose(got.numpy(), _jax_single(spec_j, x, w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("grid_n,layer", [(4, 0), (4, 3), (5, 1)])
def test_dual_mixer_matches_jax(grid_n, layer):
    spec_j, spec_t = jax_spec("spiral", grid_n, layer), build_scan_spec("spiral", grid_n, layer)
    L = grid_n * grid_n
    x0, x1 = _x(L, layer), _x(L, layer + 10)
    w0, w1 = _weights(layer), _weights(layer + 20)
    stacked = [jnp.stack([w0[k], w1[k]]) for k in JAX_ORDER]
    want = np.asarray(jax_fused.mamba2_dual_mixer_fused(
        spec_j, jnp.stack([x0, x1]), *stacked, NO_LIMIT, 1e-5, 256))
    got = fused_ssd.mamba2_dual_mixer_fused(
        spec_t, torch.from_numpy(x0), torch.from_numpy(x1), _torch_weights(w0), _torch_weights(w1)
    )
    for m in range(2):
        np.testing.assert_allclose(got[m].numpy(), want[m], rtol=2e-5, atol=2e-5)


def test_dt_limit_matches_jax_and_matters():
    spec_j, spec_t = jax_spec("spiral", 4, 1), build_scan_spec("spiral", 4, 1)
    x, w = _x(16, 3), _weights(4)
    lim = (0.01, 0.05)
    got = fused_ssd.mamba2_mixer_fused(spec_t, torch.from_numpy(x), _torch_weights(w), lim)
    np.testing.assert_allclose(got.numpy(), _jax_single(spec_j, x, w, lim), rtol=2e-5, atol=2e-5)
    free = fused_ssd.mamba2_mixer_fused(spec_t, torch.from_numpy(x), _torch_weights(w))
    assert (got - free).abs().max() > 1e-4


def test_wide_span_matches_jax():
    """dt_bias 0.65 and decay rates up to 5 put the largest per-head span of
    dt * |A| over the sequence near 90: past the 60 up to which a factored
    (rank-1) decay stays exact, and past the 88 at which exp overflows above
    the diagonal. Only the quadratic form with a selecting mask, the JAX
    default, holds there. The span is asserted, not assumed."""
    spec_j, spec_t = jax_spec("spiral", 4, 1), build_scan_spec("spiral", 4, 1)
    x, w = _x(16, 3), _weights(3, dt_bias=0.65)
    w["A_log"] = np.linspace(0.5, 1.6, 4).astype(np.float32)
    dt = jax.nn.softplus((x @ w["in_w"])[..., -4:] + w["dt_bias"])
    span = float(jnp.max(jnp.sum(dt, axis=1) * jnp.exp(w["A_log"])))
    assert span > 80.0, span
    got = fused_ssd.mamba2_mixer_fused(spec_t, torch.from_numpy(x), _torch_weights(w))
    np.testing.assert_allclose(got.numpy(), _jax_single(spec_j, x, w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("family,grid_n,layer,scan_impl,ngroups",
                         [("spiral", 4, 3, "auto", 1), ("spiral", 5, 0, "fused", 1),
                          ("vim", 4, 0, "fused", 1), ("spiral", 4, 1, "pallas", 2),
                          ("spiral", 4, 1, "fused", 2)])
def test_mamba2_module_matches_jax(family, grid_n, layer, scan_impl, ngroups):
    """Randomised parameter trees through JAX's ``Mamba2`` and the port's, on
    the composable and the fused path; two B/C groups take the composable
    path whatever ``scan_impl`` says, in both packages."""
    spec_j = jax_spec(family, grid_n, layer)
    x = _x(grid_n * grid_n, layer + 50, h=HIDDEN)
    jm = JaxMamba2(d_model=HIDDEN, scan_impl=scan_impl, ngroups=ngroups)
    params = jax.jit(lambda k, x: jm.init(k, x, spec_j))(jax.random.PRNGKey(layer), jnp.asarray(x))
    params = randomize(params["params"], layer + 60)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, spec_j))({"params": params}, x))
    sd = {}
    _mamba2(sd, "m", params)
    m = Mamba2(HIDDEN, build_scan_spec(family, grid_n, layer), scan_impl=scan_impl,
               ngroups=ngroups)
    m.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=True)
    assert set(m.state_dict()) == {
        "in_proj.weight", "conv1d.weight", "conv1d.bias", "dt_bias", "A_log", "D",
        "norm.weight", "out_proj.weight"}
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _block_case(grid_n, layer, seed, **jax_kw):
    """A JAX Mamba-2 Spiral block with randomised params, its inputs and its
    output."""
    spec_j = jax_spec("spiral", grid_n, layer)
    L = grid_n * grid_n
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, HIDDEN)).astype(np.float32)
    c = rng.standard_normal((2, 2 * HIDDEN)).astype(np.float32)
    w = (1 / (1 + np.exp(-rng.standard_normal((2, L, 1))))).astype(np.float32)
    jb = JaxSpiralMambaBlock(hidden=HIDDEN, use_mamba2=True, **jax_kw)
    params = jax.jit(lambda k, *a: jb.init(k, *a, spec_j))(jax.random.PRNGKey(layer), x, c, w)
    params = randomize(params["params"], seed + 1)
    want = np.asarray(jax.jit(lambda p, *a: jb.apply(p, *a, spec_j))({"params": params}, x, c, w))
    return params, (x, c, w), want


def _port_block(params, grid_n, layer, **kw):
    sd = {}
    _spiral_block(sd, "b", params, use_mamba2=True)
    block = SpiralMambaBlock(HIDDEN, build_scan_spec("spiral", grid_n, layer), use_mamba2=True,
                             **kw)
    block.load_state_dict({k.removeprefix("b."): v for k, v in sd.items()}, strict=True)
    return block


@pytest.mark.parametrize(
    "grid_n,layer,jax_kw",
    [(4, 3, dict(scan_impl="auto")), (5, 0, dict(scan_impl="fused")),
     (4, 1, dict(scan_impl="fused", fuse_block=True)),
     (4, 2, dict(scan_impl="fused", fuse_block=True)), (5, 2, dict(scan_impl="fused"))],
)
def test_block_routes_match_jax(grid_n, layer, jax_kw):
    """JAX's block on one route (two mixers, dual kernel, or ``fuse_block``:
    the prologue-mode kernel and the epilogue kernel in interpret mode)
    against the port's block on all three routes, one parameter set. JAX's
    ``fuse_block`` route is taken at 16 tokens only: where it has to pad the
    sequence to a multiple of 8 (25 tokens) its launcher leaves the soft mask
    unpadded and the interpreter returns NaN, so at 25 tokens the port's three
    routes are held against JAX's dual route."""
    params, inputs, want = _block_case(grid_n, layer, layer + 70, **jax_kw)
    for kw in (dict(scan_impl="auto"), dict(scan_impl="fused"),
               dict(scan_impl="fused", fuse_block=True)):
        block = _port_block(params, grid_n, layer, **kw)
        with torch.no_grad():
            got = block(*map(torch.from_numpy, inputs)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=str(kw))


def test_spiral_block_ref_matches_jax_ref():
    """``spiral_block_ref`` against JAX's ``_spiral_block_ref`` on the same
    arrays (the JAX function's mixers run the SSD kernel in interpret mode)."""
    spec_j, spec_t = jax_spec("spiral", 4, 2), build_scan_spec("spiral", 4, 2)
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    h, B_, L = 32, 2, 16
    x, wmask = f(B_, L, h), (1 / (1 + np.exp(-f(B_, L, 1)))).astype(np.float32)
    shift, scale, gate = 0.3 * f(B_, h), 0.3 * f(B_, h), f(B_, h)
    ln_w, ln_b, an_w, an_b = 1 + 0.1 * f(h), 0.1 * f(h), 1 + 0.1 * f(2 * h), 0.1 * f(2 * h)
    fc1_w, fc1_b, fc2_w, fc2_b = 0.2 * f(2 * h, h), 0.1 * f(h), 0.2 * f(h, 1), 0.1 * f(1)
    w0, w1 = _weights(12), _weights(13)
    stacked = tuple(jnp.stack([w0[k], w1[k]]) for k in JAX_ORDER)
    want = np.asarray(jax_fused._spiral_block_ref(
        spec_j, x, wmask, shift, scale, gate, ln_w, ln_b, an_w, an_b, fc1_w, fc1_b, fc2_w,
        fc2_b, stacked, NO_LIMIT, 1e-5))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = (spec_t, t(x), t(wmask), t(shift), t(scale), t(gate), t(ln_w), t(ln_b), t(an_w),
            t(an_b), t(fc1_w.T), t(fc1_b), t(fc2_w.T), t(fc2_b), _torch_weights(w0),
            _torch_weights(w1))
    got = fused_ssd.spiral_block_ref(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(fused_ssd.spiral_block_fused(*args), got, rtol=0, atol=0)


def _jax_mixer_grads(spec_j, x, g, w, fn):
    def loss(x, *ws):
        return jnp.sum(fn(spec_j, x, *ws) * g)

    grad = jax.jit(jax.grad(loss, argnums=tuple(range(9))))
    return grad(jnp.asarray(x), *(w[k] for k in JAX_ORDER))


def _assert_mixer_grads(spec_t, x, g, w, want):
    leaves = [t.requires_grad_() for t in (torch.from_numpy(x), *_torch_weights(w))]
    out = fused_ssd.mamba2_mixer_fused(spec_t, leaves[0], fused_ssd.Mamba2Weights(*leaves[1:]))
    assert out.grad_fn is not None  # on the CPU the plain version carries the gradient
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want[0]), rtol=2e-4, atol=2e-4)
    jw = dict(zip(JAX_ORDER, (np.asarray(v) for v in want[1:])))
    for name, got, ref in zip(fused_ssd.Mamba2Weights._fields, grads[1:], _torch_weights(jw)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("grid_n,layer", [(4, 3), (5, 0)])
def test_mixer_gradients_match_jax(grid_n, layer):
    """Autograd through the plain version against ``jax.grad`` of the JAX
    package's composable reference, for x and all eight weights."""
    spec_j, spec_t = jax_spec("spiral", grid_n, layer), build_scan_spec("spiral", grid_n, layer)
    L = grid_n * grid_n
    x, g, w = _x(L, layer + 1, batch=1), _x(L, layer + 2, batch=1), _weights(layer + 3)
    ref = lambda spec, x, *ws: jax_fused._ssd_mixer_ref(  # noqa: E731
        spec, x, *ws, dt_limit=NO_LIMIT, eps=1e-5, chunk_size=256)
    _assert_mixer_grads(spec_t, x, g, w, _jax_mixer_grads(spec_j, x, g, w, ref))


def test_mixer_gradients_match_jax_backward_kernel():
    """The same against JAX's hand-derived backward (``_ssd_bwd_kernel`` in
    interpret mode, through the fused mixer's custom VJP)."""
    spec_j, spec_t = jax_spec("spiral", 4, 1), build_scan_spec("spiral", 4, 1)
    x, g, w = _x(16, 5, batch=1), _x(16, 6, batch=1), _weights(7)
    fused = lambda spec, x, *ws: jax_fused.mamba2_mixer_fused(  # noqa: E731
        spec, x, *ws, NO_LIMIT, 1e-5, 256)
    _assert_mixer_grads(spec_t, x, g, w, _jax_mixer_grads(spec_j, x, g, w, fused))


def _span(x, w):
    dt = jax.nn.softplus((x @ w["in_w"])[..., -w["dt_bias"].shape[0]:] + w["dt_bias"])
    return float(jnp.max(jnp.sum(dt, axis=1) * jnp.exp(w["A_log"])))


def _wide(seed):
    """Weights whose largest per-head span of dt * |A| is near 90, as in
    ``test_wide_span_matches_jax``."""
    w = _weights(seed, dt_bias=0.65)
    w["A_log"] = np.linspace(0.5, 1.6, 4).astype(np.float32)
    return w


def _assert_bwd_ref(spec_t, x, g, w, dt_limit, want):
    """``ssd_mixer_bwd_ref`` against JAX's nine cotangents (x, then the
    weights in the JAX layout), at 2e-4 (the JAX package's gradient bar)."""
    gx, gw = fused_ssd.ssd_mixer_bwd_ref(
        spec_t, torch.from_numpy(x), torch.from_numpy(g), _torch_weights(w), dt_limit)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want[0]), rtol=2e-4, atol=2e-4)
    jw = dict(zip(JAX_ORDER, (np.asarray(v) for v in want[1:])))
    for name, got, ref in zip(fused_ssd.Mamba2Weights._fields, gw, _torch_weights(jw)):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4, err_msg=name)


# (grid, layer, dt_limit, wide span): spiral layers 0 and 3, 16 and 25 tokens
# (25 is not a multiple of 8, which the TPU kernel pads to), a dt_limit that
# clips some steps and not others, and a span of dt * |A| near 90.
BWD_CASES = [(4, 0, NO_LIMIT, False), (4, 3, NO_LIMIT, False), (5, 0, NO_LIMIT, False),
             (5, 3, NO_LIMIT, False), (4, 1, (0.55, 0.75), False), (4, 2, NO_LIMIT, True)]


@pytest.mark.parametrize("grid_n,layer,dt_limit,wide", BWD_CASES)
def test_bwd_ref_matches_jax_backward_kernel(grid_n, layer, dt_limit, wide):
    """The plain version of kernel F against JAX's ``_ssd_bwd_kernel`` in
    interpret mode, through ``mamba2_mixer_fused``'s custom VJP."""
    spec_j, spec_t = jax_spec("spiral", grid_n, layer), build_scan_spec("spiral", grid_n, layer)
    L = grid_n * grid_n
    x, g = _x(L, layer + 100), _x(L, layer + 101)
    w = _wide(layer + 102) if wide else _weights(layer + 102)
    if wide:
        assert _span(x, w) > 80.0
    if dt_limit != NO_LIMIT:
        dt = np.asarray(jax.nn.softplus((x @ w["in_w"])[..., -4:] + w["dt_bias"]))
        inside = ((dt >= dt_limit[0]) & (dt <= dt_limit[1])).mean()
        assert 0.1 < inside < 0.9, inside
    fused = lambda spec, x, *ws: jax_fused.mamba2_mixer_fused(  # noqa: E731
        spec, x, *ws, dt_limit, 1e-5, 256)
    _assert_bwd_ref(spec_t, x, g, w, dt_limit, _jax_mixer_grads(spec_j, x, g, w, fused))


@pytest.mark.parametrize("grid_n,layer", [(4, 3), (5, 0)])
def test_bwd_ref_matches_jax_dual_backward_kernel(grid_n, layer):
    """The same through ``mamba2_dual_mixer_fused``'s custom VJP: both
    branches in one call of the JAX kernel, each branch's weight gradients
    its own."""
    spec_j, spec_t = jax_spec("spiral", grid_n, layer), build_scan_spec("spiral", grid_n, layer)
    L = grid_n * grid_n
    xs = [_x(L, layer + 110 + i) for i in range(2)]
    gs = [_x(L, layer + 120 + i) for i in range(2)]
    ws = [_weights(layer + 130 + i) for i in range(2)]

    def loss(x12, *stacked):
        out = jax_fused.mamba2_dual_mixer_fused(spec_j, x12, *stacked, NO_LIMIT, 1e-5, 256)
        return jnp.sum(out * jnp.stack(gs))

    want = jax.jit(jax.grad(loss, argnums=tuple(range(9))))(
        jnp.stack(xs), *(jnp.stack([ws[0][k], ws[1][k]]) for k in JAX_ORDER))
    for m in range(2):
        _assert_bwd_ref(spec_t, xs[m], gs[m], ws[m], NO_LIMIT, [v[m] for v in want])


def test_fused_block_gradients_match_jax_fused_block():
    """The ``fuse_block`` route's gradients at 16 tokens: the port's block
    (on the CPU ``spiral_block_ref`` under autograd) against ``jax.grad``
    through JAX's ``spiral_block_fused``, whose custom VJP recomputes the
    block through the dual mixer kernel and its backward kernel."""
    grid_n, layer = 4, 1
    params, (x, c, w), _ = _block_case(grid_n, layer, 95, scan_impl="fused", fuse_block=True)
    spec_j = jax_spec("spiral", grid_n, layer)
    g = np.random.default_rng(96).standard_normal(x.shape).astype(np.float32)
    jb = JaxSpiralMambaBlock(hidden=HIDDEN, use_mamba2=True, scan_impl="fused", fuse_block=True)
    gp, gx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(jb.apply({"params": p}, x, c, w, spec_j) * g), argnums=(0, 1)
    ))(params, jnp.asarray(x))
    want = {}
    _spiral_block(want, "b", jax.tree.map(np.asarray, gp), use_mamba2=True)
    block = _port_block(params, grid_n, layer, scan_impl="fused", fuse_block=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = block(xt, torch.from_numpy(c), torch.from_numpy(w))
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-4, atol=2e-4)
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[f"b.{name}"].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("entry", ["single", "dual", "block"])
def test_fused_entry_points_carry_gradients_on_cpu(entry):
    """On CPU tensors that need a gradient each fused entry point returns a
    tensor with a ``grad_fn`` (the plain version under autograd), whose
    gradients are ``ssd_mixer_bwd_ref``'s; without one, none."""
    spec = build_scan_spec("spiral", 4, 1)
    w0, w1 = _torch_weights(_weights(1)), _torch_weights(_weights(2))
    x = torch.from_numpy(_x(16, 1)).requires_grad_()
    g = torch.from_numpy(_x(16, 2))
    if entry == "single":
        out = fused_ssd.mamba2_mixer_fused(spec, x, w0)
        assert fused_ssd.mamba2_mixer_fused(spec, x.detach(), w0).grad_fn is None
        want, _ = fused_ssd.ssd_mixer_bwd_ref(spec, x, g, w0)
    elif entry == "dual":
        out, other = fused_ssd.mamba2_dual_mixer_fused(spec, x, x.detach(), w0, w1)
        assert other.grad_fn is None
        want, _ = fused_ssd.ssd_mixer_bwd_ref(spec, x, g, w0)
    else:
        rng = np.random.default_rng(3)
        t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
        args = (torch.sigmoid(t(2, 16, 1)), 0.3 * t(2, 32), 0.3 * t(2, 32), t(2, 32),
                1 + 0.1 * t(32), 0.1 * t(32), 1 + 0.1 * t(64), 0.1 * t(64), 0.2 * t(32, 64),
                0.1 * t(32), 0.2 * t(1, 32), 0.1 * t(1), w0, w1)
        out = fused_ssd.spiral_block_fused(spec, x, *args)
        assert fused_ssd.spiral_block_fused(spec, x.detach(), *args).grad_fn is None
        (want,) = torch.autograd.grad(fused_ssd.spiral_block_ref(spec, x, *args), x, g)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, x, g)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fuse_block", [False, True])
def test_block_gradients_match_jax(fuse_block):
    """Every parameter's and the input's gradient through the port's Mamba-2
    block (on the CPU: plain autograd, on either fused route) against
    ``jax.grad`` through the JAX block's composable route."""
    grid_n, layer = 4, 2
    params, (x, c, w), _ = _block_case(grid_n, layer, 90, scan_impl="auto")
    spec_j = jax_spec("spiral", grid_n, layer)
    g = np.random.default_rng(91).standard_normal(x.shape).astype(np.float32)
    jb = JaxSpiralMambaBlock(hidden=HIDDEN, use_mamba2=True, scan_impl="auto")
    gp, gx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(jb.apply({"params": p}, x, c, w, spec_j) * g), argnums=(0, 1)
    ))(params, jnp.asarray(x))
    want = {}
    _spiral_block(want, "b", jax.tree.map(np.asarray, gp), use_mamba2=True)
    block = _port_block(params, grid_n, layer, scan_impl="fused", fuse_block=fuse_block)
    xt = torch.from_numpy(x).requires_grad_()
    block(xt, torch.from_numpy(c), torch.from_numpy(w)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-4, atol=2e-4)
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[f"b.{name}"].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_cpu_tensors_take_the_plain_versions():
    spec = build_scan_spec("spiral", 4, 1)
    x, w = torch.from_numpy(_x(16, 1)), _torch_weights(_weights(1))
    before = (fused_ssd.ssd_mixer_fused_cuda.launches, fused_ssd.spiral_epilogue_cuda.launches)
    got = fused_ssd.mamba2_mixer_fused(spec, x, w)
    torch.testing.assert_close(got, fused_ssd.ssd_mixer_ref(spec, x, w), rtol=0, atol=0)
    got2 = fused_ssd.mamba2_dual_mixer_fused(spec, x, x, w, w, impl="ref")
    torch.testing.assert_close(got2[1], got, rtol=0, atol=0)
    after = (fused_ssd.ssd_mixer_fused_cuda.launches, fused_ssd.spiral_epilogue_cuda.launches)
    assert after == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_ssd.ssd_mixer_fused_cuda(spec, (x,), (w,))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_ssd.ssd_mixer_fused_cuda(spec, (x,), (w,), want_res=True)
    backward = fused_ssd.ssd_mixer_fused_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_ssd.ssd_mixer_fused_bwd_cuda(spec, (x,), (x,), (w,), torch.zeros(1, 32, 148))
    assert fused_ssd.ssd_mixer_fused_bwd_cuda.launches == backward
    gate, an = torch.zeros(2, 32), torch.ones(64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_ssd.spiral_epilogue_cuda(x, x, x, gate, an, an, torch.zeros(32, 64),
                                       torch.zeros(32), torch.zeros(1, 32), torch.zeros(1))
    with pytest.raises(ValueError, match="unknown impl"):
        fused_ssd.mamba2_mixer_fused(spec, x, w, impl="pallas")


def test_what_is_not_ported_raises():
    """Kernel E takes partition specs (EfficientVMamba's atrous streams) now,
    so the fused entry points run them; what still raises is the backward
    kernel F and prologue mode on a partition spec (the error names kernel F
    and the route that trains)."""
    eff = build_scan_spec("eff", 4, 0)
    x, w = torch.from_numpy(_x(16, 0)), _torch_weights(_weights(0))
    want = _jax_single(jax_spec("eff", 4, 0), x.numpy(), _weights(0))
    for got in (fused_ssd.mamba2_mixer_fused(eff, x, w),
                fused_ssd.mamba2_dual_mixer_fused(eff, x, x, w, w)[1],
                fused_ssd.ssd_mixer_ref(eff, x, w)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert Mamba2(32, eff, d_state=8, headdim=16, scan_impl="fused")(x).shape == x.shape
    with pytest.raises(NotImplementedError, match="kernel F.*scan_impl: auto"):
        fused_ssd._check_spec_bwd(eff)
    with pytest.raises(NotImplementedError, match="kernel F"):
        fused_ssd.ssd_mixer_fused_bwd_cuda(eff, (x,), (x,), (w,), torch.zeros(1, 32, 148))
    fused_ssd._check_spec_bwd(build_scan_spec("vim", 4, 0))  # Mamba-2's vim spec trains
    with pytest.raises(ValueError, match="headdim"):
        Mamba2(40, eff)
    with pytest.raises(ValueError, match="ngroups"):
        Mamba2(32, eff, ngroups=3, headdim=16)
