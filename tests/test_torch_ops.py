"""The port's ops against the JAX package's, on the CPU.

Inputs are drawn with numpy from a fixed seed and go through both. Where the
JAX function reaches a Pallas kernel it runs in interpret mode on the CPU, as
the JAX package's own tests run it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.ops import conv as jconv
from diffma_tpu.ops import norm as jnorm
from diffma_tpu.ops import scan_orders as jorders
from diffma_tpu.ops import selective_scan as jscan
from diffma_tpu_torch.ops import conv, norm, scan_orders, selective_scan

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden", "scan_orders.npz"))


@pytest.mark.parametrize("n", (4, 8, 14, 28))
def test_scan_orders_match_golden(n):
    orders, inv = scan_orders.spiral_orders(n)
    np.testing.assert_array_equal(orders, GOLDEN[f"spiral_{n}_orders"])
    np.testing.assert_array_equal(inv, GOLDEN[f"spiral_{n}_inv"])
    for i in range(16):
        order, zinv = scan_orders.zig_order(n, i)
        np.testing.assert_array_equal(order, GOLDEN[f"zig_{n}_{i}_order"])
        np.testing.assert_array_equal(zinv, GOLDEN[f"zig_{n}_{i}_inv"])
    v, vinv = scan_orders.vmamba_orders(n)
    np.testing.assert_array_equal(v, GOLDEN[f"vmamba_{n}_orders"])
    np.testing.assert_array_equal(vinv, GOLDEN[f"vmamba_{n}_inv"])


@pytest.mark.parametrize("family", ["spiral", "zig", "vim", "vmamba", "efficientVMamba"])
def test_scan_specs_match_jax(family):
    for layer in range(0, 10, 3):
        ours = scan_orders.build_scan_spec(family, 14, layer)
        ref = jorders.build_scan_spec(family, 14, layer)
        np.testing.assert_array_equal(ours.fwd, ref.fwd)
        np.testing.assert_array_equal(ours.merge, ref.merge)
        assert ours.scale == ref.scale
        assert ours.mamba1_vim_quirk == ref.mamba1_vim_quirk


def test_spiral_layers_cycle_orders():
    orders, _ = scan_orders.spiral_orders(14)
    for i in (0, 1, 7, 8, 15):
        spec = scan_orders.build_scan_spec("spiral", 14, i)
        k = (2 * i) % 16
        np.testing.assert_array_equal(spec.fwd[1], orders[k])
        np.testing.assert_array_equal(spec.fwd[2], orders[k + 1])


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("activation", ["silu", None])
def test_causal_conv1d_matches_jax(with_bias, activation):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 13, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32) if with_bias else None
    want = jconv.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), activation
    )
    got = conv.causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b),
        activation,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax(affine):
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((2, 7, 48))).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32) if affine else None
    b = rng.standard_normal(48).astype(np.float32) if affine else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = jnorm.layer_norm(j(x), j(w), j(b), eps=1e-5)
    got = norm.layer_norm(t(x), t(w), t(b), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _scan_inputs(G, L, d, n, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        u=f(G, L, d),
        delta=(0.5 * f(G, L, d) - 1.0).astype(np.float32),
        A=-np.exp(0.5 * f(d, n)).astype(np.float32),
        B=f(G, L, n),
        C=f(G, L, n),
        D=f(d),
        z=f(G, L, d),
    )


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("L", [28, 13])
def test_selective_scan_matches_jax(gated, L):
    x = _scan_inputs(2, L, 32, 16)
    if not gated:
        x["z"] = None
    jx = {k: None if v is None else jnp.asarray(v) for k, v in x.items()}
    tx = {k: None if v is None else torch.from_numpy(v) for k, v in x.items()}
    want_pallas = np.asarray(jscan.selective_scan(**jx, impl="pallas"))
    want_ref = np.asarray(jscan.selective_scan_ref(**jx))
    got = selective_scan.selective_scan(**tx)  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (2, L, 32)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=2e-5, atol=2e-5)


def test_selective_scan_bf16_returns_bf16_with_fp32_state():
    x = _scan_inputs(1, 9, 16, 16, seed=2)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    for k in ("u", "B", "C", "z"):
        tx[k] = tx[k].to(torch.bfloat16)
    jx = {k: jnp.asarray(v.float().numpy()) for k, v in tx.items()}
    got = selective_scan.selective_scan_ref(**tx)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jscan.selective_scan_ref(**jx))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_selective_scan_dispatch_on_cpu():
    tx = {k: torch.from_numpy(v) for k, v in _scan_inputs(1, 5, 8, 16).items()}
    before = selective_scan.selective_scan_cuda.launches
    selective_scan.selective_scan(**tx, impl="auto")
    assert selective_scan.selective_scan_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan.selective_scan(**tx, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        selective_scan.selective_scan(**tx, impl="pallas")
