"""The port's Mamba-1 mixer inner part and its single-mixer families' fused mixer
against the JAX package's, on the CPU.

On the JAX side ``mamba_inner_fused`` runs its Pallas kernel
(``_fused_kernel``, kernel H) in interpret mode, as ``tests/test_fused_mamba.py``
runs it, and ``mamba_mixer_fused`` runs kernel C with its vim quirk and its
partition rows; on the port's side CPU tensors take the plain versions,
``mamba_inner_ref`` and ``mixer_ref``. Inputs come from numpy with fixed
seeds. Bars: 3e-5 for kernel H's values (``tests/test_fused_mamba.py``'s
bar), 1e-4 for its gradients (that file's bar), 2e-5 for the fused mixer
with inputs at the scales of ``tests/test_fused_mixer.py::_args``, 2e-4 for
the mixers' gradients and for parameter trees put through ``randomize`` (the
composable mixer test's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.models.mamba import Mamba as JaxMamba
from diffma_tpu.ops import fused_mamba as jax_inner
from diffma_tpu.ops import fused_mixer as jax_fused
from diffma_tpu.ops.scan_orders import ScanSpec as JaxScanSpec
from diffma_tpu.ops.scan_orders import build_scan_spec as jax_spec
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.ops import fused_mamba, fused_mixer
from diffma_tpu_torch.ops.scan_orders import ScanSpec, _build_merge_table, build_scan_spec
from diffma_tpu_torch.utils.convert import _mamba1
from test_torch_fused_mixer import JAX_ORDER, _assert_mixer_grads, _torch_weights, _weights, _x
from test_torch_model import HIDDEN, randomize

INNER = ("conv_w", "conv_b", "xp_w", "dt_w", "dt_b", "A", "D")


def _inner_weights(seed, d=32, K=4, r=4, n=8):
    """The inner weights in the JAX layout (input-major), at the scales of
    ``tests/test_fused_mamba.py::_weights``."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        conv_w=0.3 * f(d, K), conv_b=0.1 * f(d), xp_w=f(d, r + 2 * n) * d**-0.5,
        dt_w=f(r, d) * r**-0.5, dt_b=0.5 * f(d) - 2.0, A=-np.exp(0.3 * f(d, n)), D=f(d),
    )


def _torch_inner(w):
    """The same weights in torch layout, the order ``mamba_inner_fused`` takes."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(w["conv_w"]), t(w["conv_b"]), t(w["xp_w"].T), t(w["dt_w"].T), t(w["dt_b"]),
            t(w["A"]), t(w["D"]))


@pytest.mark.parametrize("L", [28, 13, 16])
def test_inner_matches_jax(L):
    """13 and 28 steps make the JAX kernel pad the time axis with zeros up to
    a multiple of 16; the port pads nothing, and the valid outputs agree."""
    w = _inner_weights(L)
    xz = np.random.default_rng(L + 1).standard_normal((3, L, 64)).astype(np.float32)
    want = np.asarray(jax_inner.mamba_inner_fused(jnp.asarray(xz), *(w[k] for k in INNER)))
    before = fused_mamba.mamba_inner_fused_cuda.launches
    got = fused_mamba.mamba_inner_fused(torch.from_numpy(xz), *_torch_inner(w))
    assert fused_mamba.mamba_inner_fused_cuda.launches == before  # CPU tensors: the plain version
    assert got.shape == (3, L, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    plain = fused_mamba.mamba_inner_ref(torch.from_numpy(xz), *_torch_inner(w))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_inner_gradients_match_jax():
    """Gradients of every input through JAX's custom VJP (which recomputes
    through its composable path) and through autograd over the port's."""
    w = _inner_weights(4)
    rng = np.random.default_rng(5)
    xz = rng.standard_normal((2, 16, 64)).astype(np.float32)
    g = rng.standard_normal((2, 16, 32)).astype(np.float32)

    def loss(xz, *ws):
        return jnp.sum(jax_inner.mamba_inner_fused(xz, *ws) * g)

    want = jax.grad(loss, argnums=tuple(range(8)))(jnp.asarray(xz), *(w[k] for k in INNER))
    leaves = [torch.from_numpy(xz).requires_grad_()] + [t.requires_grad_() for t in _torch_inner(w)]
    out = fused_mamba.mamba_inner_fused(*leaves)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    transposed = {"xp_w", "dt_w"}
    for name, leaf, ref in zip(("xz", *INNER), leaves, want):
        ref = np.asarray(ref).T if name in transposed else np.asarray(ref)
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=1e-4, atol=1e-4, err_msg=name)


def test_inner_cuda_wrapper_raises_on_cpu_tensors():
    w = _torch_inner(_inner_weights(0))
    xz = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mamba.mamba_inner_fused_cuda(xz, *w)
    with pytest.raises(ValueError, match="unknown impl"):
        fused_mamba.mamba_inner_fused(xz, *w, impl="pallas")
    assert fused_mamba.mamba_inner_fused(xz, *w, impl="ref").shape == (1, 4, 32)


def _doubled_atrous(grid_n, cls, eff):
    """The four atrous streams and their reverses: every token twice, in
    streams a quarter of the sequence long. Neither full-length nor an exact
    partition, so the fused route cannot use the whole-mixer kernel."""
    fwd = np.concatenate([eff.fwd, eff.fwd[:, ::-1]])
    return cls(fwd=fwd, merge=_build_merge_table(fwd, grid_n * grid_n), scale=0.5)


@pytest.mark.parametrize("scan_impl", ["fused", "ref"])
def test_mamba_on_a_spec_kernel_c_cannot_take_matches_jax(scan_impl):
    """``Mamba`` on the doubled-atrous spec of grid 4: the JAX mixer gathers,
    projects, runs ``mamba_inner_fused`` (kernel H, interpret mode), merges
    through the merge table and projects out; the port takes the same route
    (``mixer_composable(fused_inner=True)``)."""
    spec_j = _doubled_atrous(4, JaxScanSpec, jax_spec("eff", 4, 0))
    spec_t = _doubled_atrous(4, ScanSpec, build_scan_spec("eff", 4, 0))
    assert not fused_mixer.mixer_fused_eligible(spec_t, partition=True)
    assert not jax_fused.mixer_fused_eligible(spec_j, partition=True)
    x = _x(16, 7, h=HIDDEN)
    jm = JaxMamba(d_model=HIDDEN, scan_impl=scan_impl)
    params = jax.jit(lambda k, x: jm.init(k, x, spec_j))(jax.random.PRNGKey(0), jnp.asarray(x))
    params = randomize(params["params"], 8)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, spec_j))({"params": params}, x))
    sd = {}
    _mamba1(sd, "m", params)
    m = Mamba(HIDDEN, spec_t, scan_impl=scan_impl)
    m.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = m(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=2e-4)
    got.sum().backward()  # the route carries gradients to the input and every weight
    assert xt.grad is not None and all(p.grad is not None for p in m.parameters())
    with pytest.raises(NotImplementedError, match="mamba_inner_fused"):
        fused_mixer.mamba_mixer_fused(spec_t, torch.from_numpy(x), m.weights())


# (family, grid): the vim quirk at 16 and 25 tokens, EfficientVMamba's
# partition at 16 and 36 tokens (streams of 4 and 9 steps).
FAMILY_SPECS = [("vim", 4), ("vim", 5), ("eff", 4), ("eff", 6)]


@pytest.mark.parametrize("family,grid_n", FAMILY_SPECS)
def test_family_mixer_matches_jax(family, grid_n):
    """The fused mixer (JAX: kernel C's quirk branch and partition rows in
    interpret mode) and the composable path, forward."""
    spec_j, spec_t = jax_spec(family, grid_n, 0), build_scan_spec(family, grid_n, 0)
    x, w = _x(grid_n * grid_n, grid_n + 30), _weights(grid_n + 40)
    args = [w[k] for k in JAX_ORDER]
    want = np.asarray(jax_fused.mamba_mixer_fused(spec_j, jnp.asarray(x), *args))
    composable = np.asarray(jax_fused._mixer_ref(spec_j, jnp.asarray(x), *args))
    xt, wt = torch.from_numpy(x), _torch_weights(w)
    got = fused_mixer.mamba_mixer_fused(spec_t, xt, wt)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    for impl in ("auto", "ref"):
        got = fused_mixer.mixer_composable(spec_t, xt, wt, scan_impl=impl)
        np.testing.assert_allclose(got.numpy(), composable, rtol=2e-5, atol=2e-5)
    got = fused_mixer.mixer_composable(spec_t, xt, wt, fused_inner=True)
    np.testing.assert_allclose(got.numpy(), composable, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("family,grid_n", [("vim", 4), ("eff", 4)])
def test_family_mixer_gradients_match_jax(family, grid_n):
    """The plain backward against JAX's gradients through its fused mixer's
    custom VJP, for the quirk and for the partition."""
    spec_j, spec_t = jax_spec(family, grid_n, 0), build_scan_spec(family, grid_n, 0)
    L = grid_n * grid_n
    w, x, g = _weights(3, h=16, d=32, n=4), _x(L, 13, h=16), _x(L, 23, h=16)

    def loss(x, *ws):
        return jnp.sum(jax_fused.mamba_mixer_fused(spec_j, x, *ws) * g)

    out = jax.grad(loss, argnums=tuple(range(10)))(jnp.asarray(x), *(w[k] for k in JAX_ORDER))
    want_w = {k: np.asarray(v)[None] for k, v in zip(JAX_ORDER, out[1:])}
    _assert_mixer_grads(spec_t, [w], [x], [g], np.asarray(out[0])[None], want_w)


def test_vim_quirk_flips_features_and_keeps_reversed_tokens():
    """The quirk, spelled out: out = 0.5 * (mixer(x) + flip_features(mixer(x
    reversed))) with one identity stream each, the second left in reversed
    token order. It is not the standard merge, which Mamba-2's vim spec takes."""
    spec = build_scan_spec("vim", 4, 0)
    assert spec.mamba1_vim_quirk and spec.scale == 0.5
    one = ScanSpec(fwd=spec.fwd[:1], merge=spec.merge[:, :1], scale=1.0)
    standard = ScanSpec(fwd=spec.fwd, merge=spec.merge, scale=spec.scale)
    x, w = torch.from_numpy(_x(16, 2)), _torch_weights(_weights(5))
    got = fused_mixer.mixer_ref(spec, x, w)
    fwd_out = fused_mixer.mixer_ref(one, x, w)
    rev_out = fused_mixer.mixer_ref(one, x.flip(1), w)  # row t is token 15 - t
    torch.testing.assert_close(got, 0.5 * (fwd_out + rev_out.flip(-1)), rtol=1e-6, atol=1e-6)
    merged = 0.5 * (fwd_out + rev_out.flip(1))  # what un-reversing the tokens would give
    torch.testing.assert_close(fused_mixer.mixer_ref(standard, x, w), merged, rtol=1e-5, atol=1e-5)
    assert (got - merged).abs().max() > 1e-3


@pytest.mark.parametrize("family,grid_n,scan_impl",
                         [("vim", 4, "fused"), ("vim", 5, "pallas"), ("eff", 4, "fused"),
                          ("eff", 6, "ref"), ("zig", 5, "fused"), ("vmamba", 4, "fused")])
def test_family_mamba_module_matches_jax(family, grid_n, scan_impl):
    """Randomised parameter trees through JAX's ``Mamba`` and the port's on
    each single-mixer family's spec."""
    spec_j = jax_spec(family, grid_n, 1)
    x = _x(grid_n * grid_n, grid_n + 50, h=HIDDEN)
    jm = JaxMamba(d_model=HIDDEN, scan_impl=scan_impl)
    params = jax.jit(lambda k, x: jm.init(k, x, spec_j))(jax.random.PRNGKey(1), jnp.asarray(x))
    params = randomize(params["params"], grid_n + 60)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, spec_j))({"params": params}, x))
    sd = {}
    _mamba1(sd, "m", params)
    m = Mamba(HIDDEN, build_scan_spec(family, grid_n, 1), scan_impl=scan_impl)
    m.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
