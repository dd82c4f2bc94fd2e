"""The port's Mamba-2 scans and gated RMSNorm against the JAX package's, on the CPU.

Inputs come from numpy with fixed seeds and go to ``diffma_tpu.ops.ssd`` /
``diffma_tpu.ops.norm`` and to ``diffma_tpu_torch.ops.ssd`` /
``diffma_tpu_torch.ops.norm``. Bar: rtol = atol = 2e-5, the JAX package's
own bar for these functions off the TPU (``tests/test_fused_ssd.py``); both
sides are fp32 sums in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.ops import norm as jax_norm
from diffma_tpu.ops import ssd as jax_ssd
from diffma_tpu_torch.ops import ssd
from diffma_tpu_torch.ops.norm import rms_norm_gated

TOL = dict(rtol=2e-5, atol=2e-5)
NO_LIMIT = (0.0, float("inf"))


def _scan_inputs(seed, G=2, L=37, H=4, P=8, N=8, groups=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(G, L, H, P), dt=f(G, L, H), A=-np.exp(0.5 * f(H)), B=f(G, L, groups * N),
        C=f(G, L, groups * N), D=f(H), dt_bias=0.2 * f(H), state=f(G, H, P, N),
    )


def _call(fn, a, to, **kw):
    """``fn`` on the case ``a`` with arrays converted by ``to``."""
    out = fn(
        to(a["x"]), to(a["dt"]), to(a["A"]), to(a["B"]), to(a["C"]), to(a["D"]),
        dt_bias=to(a["dt_bias"]), initial_state=to(a["state"]), return_final_state=True, **kw,
    )
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("norm_before_gate", [False, True])
@pytest.mark.parametrize("group_size,gated", [(None, True), (16, True), (None, False)])
def test_rms_norm_gated_matches_jax(norm_before_gate, group_size, gated):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    z = rng.standard_normal((3, 7, 32)).astype(np.float32) if gated else None
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    want = jax_norm.rms_norm_gated(
        jnp.asarray(x), jnp.asarray(w), None if z is None else jnp.asarray(z), eps=1e-5,
        group_size=group_size, norm_before_gate=norm_before_gate,
    )
    got = rms_norm_gated(
        torch.from_numpy(x), torch.from_numpy(w), None if z is None else torch.from_numpy(z),
        eps=1e-5, group_size=group_size, norm_before_gate=norm_before_gate,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="group_size"):
        rms_norm_gated(torch.from_numpy(x), torch.from_numpy(w), group_size=5)


@pytest.mark.parametrize("dt_limit", [NO_LIMIT, (0.05, 0.5)])
def test_ssd_ref_matches_jax(dt_limit):
    a = _scan_inputs(1, L=19)
    want = _call(jax_ssd.ssd_ref, a, jnp.asarray, dt_limit=dt_limit)
    got = _call(ssd.ssd_ref, a, torch.from_numpy, dt_limit=dt_limit)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize(
    "L,chunk_size,dt_limit",
    [(32, 16, NO_LIMIT),  # whole chunks
     (37, 16, NO_LIMIT),  # three chunks, the last one padded
     (25, 256, NO_LIMIT),  # one chunk of 32, padded
     (37, 16, (0.05, 0.5))],
)
def test_ssd_chunked_matches_jax_and_the_recurrence(L, chunk_size, dt_limit):
    """Values and the final state, from an initial state, against JAX's
    ``ssd_chunked``; the values and the final state against the port's own
    step-by-step ``ssd_ref`` too, and JAX's ``ssd_ref``."""
    a = _scan_inputs(2, L=L)
    kw = dict(dt_limit=dt_limit, chunk_size=chunk_size)
    want_y, want_state = _call(jax_ssd.ssd_chunked, a, jnp.asarray, **kw)
    got_y, got_state = _call(ssd.ssd_chunked, a, torch.from_numpy, **kw)
    np.testing.assert_allclose(got_y, want_y, **TOL)
    ref_y, ref_state = _call(ssd.ssd_ref, a, torch.from_numpy, dt_limit=dt_limit)
    np.testing.assert_allclose(got_y, ref_y, **TOL)
    np.testing.assert_allclose(got_state, ref_state, **TOL)
    _, jax_ref_state = _call(jax_ssd.ssd_ref, a, jnp.asarray, dt_limit=dt_limit)
    np.testing.assert_allclose(got_state, jax_ref_state, **TOL)
    if dt_limit[0] == 0.0:
        np.testing.assert_allclose(got_state, want_state, **TOL)
    else:
        # JAX's ssd_chunked keeps the clipped dt of the steps that pad the
        # last chunk (dt = -30 raised to dt_limit[0]), so its final state has
        # decayed by them; the port's leaves them out (a fault of the
        # reference, not copied: the sequence-parallel SSD reads the state).
        assert np.abs(got_state - want_state).max() > 1e-2


def test_ssd_chunked_without_state_arguments():
    a = _scan_inputs(3, L=21)
    t = torch.from_numpy
    y = ssd.ssd_chunked(t(a["x"]), t(a["dt"]), t(a["A"]), t(a["B"]), t(a["C"]), t(a["D"]),
                        chunk_size=16)
    want = jax_ssd.ssd_chunked(*(jnp.asarray(a[k]) for k in ("x", "dt", "A", "B", "C", "D")),
                               chunk_size=16)
    assert isinstance(y, torch.Tensor) and y.shape == (2, 21, 4, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    # D of shape (H, P), as the reference also takes it
    D2 = np.random.default_rng(4).standard_normal((4, 8)).astype(np.float32)
    y2 = ssd.ssd_chunked(t(a["x"]), t(a["dt"]), t(a["A"]), t(a["B"]), t(a["C"]), t(D2))
    want2 = jax_ssd.ssd_chunked(*(jnp.asarray(a[k]) for k in ("x", "dt", "A", "B", "C")),
                                jnp.asarray(D2))
    np.testing.assert_allclose(y2.numpy(), np.asarray(want2), **TOL)


@pytest.mark.parametrize("L,chunk_size", [(37, 16), (16, 256)])
def test_ssd_chunked_grouped_matches_jax(L, chunk_size):
    """Two B/C groups: head h reads group h // (H / 2)."""
    a = _scan_inputs(5, L=L, groups=2)
    kw = dict(ngroups=2, chunk_size=chunk_size, dt_limit=(0.0, 2.0))
    want = _call(jax_ssd.ssd_chunked_grouped, a, jnp.asarray, **kw)
    got = _call(ssd.ssd_chunked_grouped, a, torch.from_numpy, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    one = _scan_inputs(5, L=L)
    np.testing.assert_allclose(
        _call(ssd.ssd_chunked_grouped, one, torch.from_numpy, ngroups=1)[0],
        _call(ssd.ssd_chunked, one, torch.from_numpy)[0], rtol=0, atol=0,
    )
    with pytest.raises(ValueError, match="ngroups"):
        _call(ssd.ssd_chunked_grouped, one, torch.from_numpy, ngroups=3)


def test_wide_span_is_exact_and_differentiable():
    """A per-head span of dt * |A| up to some 250: above the diagonal
    cs_t - cs_s is large and positive, and exp of it overflows (at 88). The
    chunked form selects before the exp, so it equals the recurrence and its
    gradients stay finite. Against JAX the bar is 2e-5 of max |ref|: the two
    cumsums of dt * A round |cs| of some 250 differently (about 1e-7 of it),
    and the difference goes through the exp."""
    a = _scan_inputs(6, L=48)
    a["A"] = -np.linspace(1.0, 4.0, 4).astype(np.float32)
    a["dt_bias"] = np.full(4, 1.0, np.float32)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    span = (torch.nn.functional.softplus(t["dt"] + t["dt_bias"]).sum(1) * -t["A"]).max().item()
    assert span > 200, span
    leaves = {k: t[k].clone().requires_grad_() for k in ("x", "dt", "B", "C")}
    y = ssd.ssd_chunked(leaves["x"], leaves["dt"], t["A"], leaves["B"], leaves["C"], t["D"],
                        dt_bias=t["dt_bias"], chunk_size=64)
    ref = ssd.ssd_ref(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], dt_bias=t["dt_bias"])
    np.testing.assert_allclose(y.detach().numpy(), ref.numpy(), **TOL)
    want = jax_ssd.ssd_chunked(*(jnp.asarray(a[k]) for k in ("x", "dt", "A", "B", "C", "D")),
                               dt_bias=jnp.asarray(a["dt_bias"]), chunk_size=64)
    want = np.asarray(want)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5 * max(1.0, np.abs(want).max()))
    y.square().sum().backward()
    assert all(torch.isfinite(v.grad).all() for v in leaves.values())
