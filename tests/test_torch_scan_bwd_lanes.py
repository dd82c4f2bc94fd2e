"""Kernel B's arithmetic (``csrc/selective_scan_bwd.cu``) modelled in plain
PyTorch on the CPU.

The model follows the kernel's order. A channel's 16 states sit on 4 lanes,
lane j holding states j, j + 4, j + 8 and j + 12; a sum over the states is
each lane's sum of its four, then two shuffles, (l0 + l1) + (l2 + l3). The
forward stores the state at the entry of every 16-step chunk; the reverse
pass recomputes each chunk from its checkpoint and sweeps it backwards. Each
decay is exp2(dt A log2(e)), and d raw is (sum_n s h exp(dt a) A log2(e)) ln 2
+ u sum_n s B, times sigmoid(raw), with softplus and sigmoid from one exp. dB
and dC sum over a warp's 8 channels as its reduce-scatter does (((c0 + c4)
+ (c2 + c6)) + ((c1 + c5) + (c3 + c7))), then over a block's 8 warps in order,
then over the blocks of 64 channels in order.

The model is held against two references: the VJP of the JAX package's
``selective_scan_ref`` and the port's ``selective_scan_bwd_ref`` (autograd
over the plain scan), at 1 to 197 steps (one step, one chunk less a step, one
chunk, one chunk and a step, the model's 196 and one more), gated and not,
at a width that leaves the last block of channels part empty, and at a span
dt |A| in the thousands. Bar: the JAX package's gradient bar, 2e-4 * max(1,
max |ref|) per gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.ops.selective_scan import selective_scan_ref as jax_selective_scan_ref
from diffma_tpu_torch.ops.selective_scan import selective_scan_bwd_ref

TOL = 2e-4
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
N, LPC, CHUNK, CPW, WARPS = 16, 4, 16, 8, 8
NAMES = ("u", "delta", "A", "B", "C", "D", "z")
GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz")


def state_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (16 states) as the kernel sums: each lane's four
    states in order, then the two shuffles."""
    lanes = x.reshape(*x.shape[:-1], LPC, LPC)  # [..., i, j]: state j + 4 i
    part = lanes[..., 0, :]
    for i in range(1, LPC):
        part = part + lanes[..., i, :]
    return (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])


def channel_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the channels (axis -2 of ``(..., d, n)``) in the kernel's order:
    the warp's reduce-scatter, the block's warps, then the blocks."""
    d = v.shape[-2]
    nblk = -(-d // (WARPS * CPW))
    pad = nblk * WARPS * CPW - d
    v = torch.cat([v, v.new_zeros(*v.shape[:-2], pad, v.shape[-1])], dim=-2)
    x = v.reshape(*v.shape[:-2], nblk, WARPS, CPW, v.shape[-1])
    c = [x[..., k, :] for k in range(CPW)]
    warp = ((c[0] + c[4]) + (c[2] + c[6])) + ((c[1] + c[5]) + (c[3] + c[7]))
    block = warp[..., 0, :]
    for w in range(1, WARPS):
        block = block + warp[..., w, :]
    total = block[..., 0, :]
    for b in range(1, nblk):
        total = total + block[..., b, :]
    return total


def scan_bwd_lanes(u, delta, A, B, C, D, z, g):
    """Kernel B's backward in its order; returns what ``selective_scan_bwd_ref``
    returns: (du, ddelta, dA, dB, dC, dD, dz), dA (d, n), dD (d,)."""
    G, L, d = u.shape
    e = torch.exp(-delta.abs())
    r = 1.0 / (1.0 + e)
    sig = torch.where(delta >= 0, r, e * r)
    dt = delta.clamp(min=0) + torch.log1p(e)
    a2 = A * LOG2E
    if z is not None:
        sz = 1.0 / (1.0 + torch.exp(-z))
        dy_all = g * z * sz
        dzf = g * sz * (1.0 + z * (1.0 - sz))
    else:
        dy_all = g
    decay = lambda t: torch.exp2(dt[:, t, :, None] * a2)  # noqa: E731
    step = lambda h, t: decay(t) * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]  # noqa: E731

    starts = list(range(0, L, CHUNK))
    ckpt, h = [], u.new_zeros(G, d, N)
    for t0 in starts:
        ckpt.append(h)
        for t in range(t0, min(L, t0 + CHUNK)):
            h = step(h, t)

    du, ddelta, dz = (torch.zeros_like(u) for _ in range(3))
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA = u.new_zeros(G, d, N)
    carry = u.new_zeros(G, d, N)
    for q in reversed(range(len(starts))):
        t0 = starts[q]
        hs = [ckpt[q]]
        for t in range(t0, min(L, t0 + CHUNK)):
            hs.append(step(hs[-1], t))
        for s in reversed(range(len(hs) - 1)):
            t = t0 + s
            if z is not None:
                y = state_sum(C[:, t, None, :] * hs[s + 1]) + D * u[:, t]
                dz[:, t] = y * dzf[:, t]
            dy = dy_all[:, t]
            gk = C[:, t, None, :] * dy[..., None] + carry
            ak = decay(t)
            gha = gk * hs[s] * ak
            dA = dA + gha * dt[:, t, :, None]
            dda = state_sum(gha * a2)
            gB = state_sum(gk * B[:, t, None, :])
            carry = ak * gk
            du[:, t] = dy * D + dt[:, t] * gB
            ddelta[:, t] = (dda * LN2 + u[:, t] * gB) * sig[:, t]
            dB[:, t] = channel_sum(gk * (dt[:, t] * u[:, t])[..., None])
            dC[:, t] = channel_sum(hs[s + 1] * dy[..., None])
    dD = (dy_all * u).sum(1).sum(0)
    return du, ddelta, dA.sum(0), dB, dC, dD, dz if z is not None else None


def scan_inputs(L: int, seed: int, wide: bool = False, G: int = 2, d: int = 72):
    """Numpy inputs: delta around -1, or, with ``wide``, dt of 30 to 60 against
    A of -50 to -100, so that dt |A| runs in the thousands over any chunk."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    u, z, B, C, g = f(G, L, d), f(G, L, d), f(G, L, N), f(G, L, N), f(G, L, d)
    if wide:
        delta = rng.uniform(30, 60, (G, L, d)).astype(np.float32)
        A = -rng.uniform(50, 100, (d, N)).astype(np.float32)
    else:
        delta = 0.5 * f(G, L, d) - 1.0
        A = -np.exp(0.5 * f(d, N)).astype(np.float32)
    return dict(u=u, delta=delta, A=A, B=B, C=C, D=f(d), z=z), g


@functools.lru_cache(maxsize=None)
def case(L: int, gated: bool, wide: bool):
    """The inputs, the model's gradients and the JAX package's, once per case."""
    x, g = scan_inputs(L, seed=L + 1000 * wide + 10 * gated, wide=wide)
    if not gated:
        x["z"] = None
    t = {k: None if v is None else torch.from_numpy(v) for k, v in x.items()}
    got = scan_bwd_lanes(*(t[k] for k in NAMES), torch.from_numpy(g))

    args = [jnp.asarray(x[k]) for k in NAMES[:6]]
    if gated:
        fn = lambda *a: jax_selective_scan_ref(*a)  # noqa: E731
        args.append(jnp.asarray(x["z"]))
    else:
        fn = lambda *a: jax_selective_scan_ref(*a, None)  # noqa: E731
    _, vjp = jax.vjp(fn, *args)
    jgrads = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    jax_grads = (*jgrads[:6], jgrads[6] if gated else None)
    return t, g, got, jax_grads


def assert_grads_close(got, want):
    for name, a, b in zip(GRADS, got, want):
        if b is None:
            assert a is None, name
            continue
        b = torch.as_tensor(np.array(b))
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        bar = TOL * max(1.0, b.abs().max().item())
        err = (a - b).abs().max().item()
        assert err <= bar, f"{name}: max |err| {err:.3e} > {bar:.3e}"


CASES = [(L, gated, False) for L in (1, 15, 16, 17, 196, 197) for gated in (True, False)]
CASES += [(196, True, True), (17, False, True)]


@pytest.mark.parametrize("L,gated,wide", CASES)
def test_lane_model_against_jax_vjp(L, gated, wide):
    _, _, got, want = case(L, gated, wide)
    assert_grads_close(got, want)


@pytest.mark.parametrize("L,gated,wide", CASES)
def test_lane_model_against_plain_backward(L, gated, wide):
    t, g, got, _ = case(L, gated, wide)
    want = selective_scan_bwd_ref(*(t[k] for k in NAMES), torch.from_numpy(g))
    assert_grads_close(got, want)


def test_wide_span_underflows_every_decay():
    """At the wide span a step's decay is 0 in fp32 for every state, so the
    model's checkpoints carry nothing across a chunk and must stay finite."""
    t, _, got, _ = case(196, True, True)
    dt = torch.nn.functional.softplus(t["delta"])
    assert torch.exp2(dt.min() * t["A"].max() * LOG2E).item() == 0.0
    assert all(torch.isfinite(v).all() for v in got if v is not None)
