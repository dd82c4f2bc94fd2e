"""The arithmetic of kernels C and D (``csrc/fused_mixer_fwd.cu``,
``csrc/fused_mixer_bwd.cu``) modelled in plain PyTorch on the CPU.

* 3xTF32 (``csrc/gemm_tc.cuh``): each operand split once into hi =
  rna_tf32(x) and lo = rna_tf32(x - hi), and lo a * hi b + hi a * lo b +
  hi a * hi b summed in fp32, against an fp64 product at the depths of the
  kernels' products: in_proj (h = 512), out_proj (d = 1024), gx (2d = 2048)
  and the weight gradients over B * S * L = 8 * 3 * 196 = 4704 stream rows.
  Bar: kernel C's, 1e-4 * max(1, max |ref|), the stricter of the two.
* Kernel C's chunked scan: each chunk's end state from a zero state and its
  sum of dt, folded in order as h = exp(A sum dt) h + h_chunk, each chunk run
  again from its entry state; against the JAX package's ``selective_scan``.
* Kernel D's scan adjoint: checkpoints every 16 steps, each chunk's states
  recomputed, the reverse sweep, and sigmoid(raw) taken as -expm1(-dt);
  against the port's ``selective_scan_bwd_ref``, the scan part of
  ``mixer_bwd_ref``. Bar: 2e-4 * max(1, max |ref|) per tensor (kernel D's).

Both scans are held at 196, 197 and 25 steps and at a wide span (dt |A| in
the thousands, where a product of decays underflows to 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.ops.selective_scan import selective_scan as jax_selective_scan
from diffma_tpu_torch.ops.selective_scan import selective_scan_bwd_ref

TOL_FWD = 1e-4
TOL_GRAD = 2e-4


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10 explicit
    mantissa bits, on the float32 bit pattern (sign and magnitude)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c = a b^T, a (M, K) and b (N, K) in fp32, as the kernels sum it."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_lo @ b_hi.T + a_hi @ b_lo.T) + a_hi @ b_hi.T


def test_tf32_rna_rounds_to_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-12, -(1.0 + 2.0**-11), 3.0e-3])
    got = tf32_rna(x)
    assert got[0] == 1.0
    assert got[1] == 1.0 + 2.0**-10  # a tie goes away from zero
    assert got[2] == 1.0 + 2.0**-10
    assert got[3] == -(1.0 + 2.0**-10)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[4] - 3.0e-3) <= 2.0**-11 * 3.0e-3


@pytest.mark.parametrize("depth", [512, 1024, 2048, 4704])
def test_3xtf32_product_meets_the_fp32_bar(depth):
    rng = np.random.default_rng(depth)
    a = torch.from_numpy(rng.standard_normal((64, depth)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, depth)).astype(np.float32))
    ref = a.double() @ b.double().T
    bar = TOL_FWD * max(1.0, ref.abs().max().item())
    err = (matmul_3xtf32(a, b).double() - ref).abs().max().item()
    one_pass = (tf32_rna(a) @ tf32_rna(b).T).double()
    assert err <= bar, (err, bar)
    # the split is what buys the digits: one TF32 product is far coarser
    assert (one_pass - ref).abs().max().item() > 50 * err


def softplus(x: torch.Tensor) -> torch.Tensor:
    """The kernels' softplus: max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def chunked_scan(u, delta, A, B, C, D, z, chunks):
    """Kernel C's scan in its order: u, delta, z (G, L, d); A (d, n);
    B, C (G, L, n); D (d,). The L steps in ``chunks`` chunks of
    ceil(L / chunks) (the last ones may be short or empty)."""
    G, L, d = u.shape
    dt = softplus(delta)
    length = -(-L // chunks)
    bounds = [(min(L, w * length), min(L, w * length + length)) for w in range(chunks)]

    def run(h, t0, t1, y=None):
        for t in range(t0, t1):
            h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
            if y is not None:
                y[:, t] = (h * C[:, t, None, :]).sum(-1) + D * u[:, t]
        return h

    ends = [(run(u.new_zeros(G, d, A.shape[1]), t0, t1), dt[:, t0:t1].sum(1))
            for t0, t1 in bounds[:-1]]
    y = torch.empty_like(u)
    for w, (t0, t1) in enumerate(bounds):
        h = u.new_zeros(G, d, A.shape[1])
        for end, span in ends[:w]:
            h = torch.exp(A * span[..., None]) * h + end
        run(h, t0, t1, y)
    return y * torch.nn.functional.silu(z)


def scan_adjoint(u, delta, A, B, C, D, z, g, chunk=16):
    """Kernel D's scan adjoint in its order: the forward storing the state at
    every chunk's entry, then per chunk in reverse the chunk's states from
    its checkpoint and the reverse sweep. Returns (du, ddelta, dA, dB, dC,
    dD, dz) as ``selective_scan_bwd_ref`` does."""
    G, L, d = u.shape
    dt = softplus(delta)
    decay = lambda t: torch.exp(dt[:, t, :, None] * A)  # noqa: E731
    step = lambda h, t: decay(t) * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]  # noqa: E731
    starts = list(range(0, L, chunk))
    ckpt, h = [], u.new_zeros(G, d, A.shape[1])
    for t0 in starts:
        ckpt.append(h)
        for t in range(t0, min(L, t0 + chunk)):
            h = step(h, t)
    du, ddelta, dz = (torch.empty_like(u) for _ in range(3))
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.zeros_like(A)
    dD = torch.zeros_like(D)
    carry = torch.zeros_like(h)
    for q in reversed(range(len(starts))):
        t0 = starts[q]
        hs = [ckpt[q]]
        for t in range(t0, min(L, t0 + chunk)):
            hs.append(step(hs[-1], t))
        for j in reversed(range(len(hs) - 1)):
            t = t0 + j
            y = (hs[j + 1] * C[:, t, None, :]).sum(-1) + D * u[:, t]
            sz = torch.sigmoid(z[:, t])
            dz[:, t] = g[:, t] * y * sz * (1 + z[:, t] * (1 - sz))
            dy = g[:, t] * z[:, t] * sz
            dD += (dy * u[:, t]).sum(0)
            gk = C[:, t, None, :] * dy[..., None] + carry
            ak = decay(t)
            gha = gk * hs[j] * ak
            dA += (gha * dt[:, t, :, None]).sum(0)
            ddt = (gha * A).sum(-1) + (gk * B[:, t, None, :]).sum(-1) * u[:, t]
            carry = ak * gk
            dB[:, t] = (gk * (dt[:, t] * u[:, t])[..., None]).sum(1)
            dC[:, t] = (hs[j + 1] * dy[..., None]).sum(1)
            ddelta[:, t] = ddt * -torch.expm1(-dt[:, t])
            du[:, t] = dy * D + dt[:, t] * (gk * B[:, t, None, :]).sum(-1)
    return du, ddelta, dA, dB, dC, dD, dz


def scan_inputs(L, seed, wide=False, G=2, d=8, n=16):
    """Numpy inputs of a gated scan: delta around 0, or, with ``wide``, dt of
    30 to 60 against A of -50 to -100, so that dt |A| runs in the thousands."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    u, z, B, C = f(G, L, d), f(G, L, d), f(G, L, n), f(G, L, n)
    if wide:
        delta = rng.uniform(30, 60, (G, L, d)).astype(np.float32)
        A = -rng.uniform(50, 100, (d, n)).astype(np.float32)
    else:
        delta = 0.5 * f(G, L, d)
        A = -np.exp(0.5 * f(d, n)).astype(np.float32)
    return dict(u=u, delta=delta, A=A, B=B, C=C, D=f(d), z=z)


CASES = [(196, False), (197, False), (25, False), (196, True)]


@pytest.mark.parametrize("chunks", [2, 4, 8])
@pytest.mark.parametrize("L,wide", CASES)
def test_chunked_scan_against_jax(L, wide, chunks):
    x = scan_inputs(L, seed=L + chunks, wide=wide)
    want = np.asarray(jax_selective_scan(*(jnp.asarray(x[k]) for k in "u delta A B C D z".split()),
                                         impl="ref"))
    got = chunked_scan(**{k: torch.from_numpy(v) for k, v in x.items()}, chunks=chunks).numpy()
    assert np.isfinite(got).all()
    bar = TOL_GRAD * max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= bar


@pytest.mark.parametrize("L,wide", CASES)
def test_scan_adjoint_against_autograd(L, wide):
    x = {k: torch.from_numpy(v) for k, v in scan_inputs(L, seed=100 + L, wide=wide).items()}
    g = torch.from_numpy(np.random.default_rng(L).standard_normal(x["u"].shape).astype(np.float32))
    want = selective_scan_bwd_ref(x["u"], x["delta"], x["A"], x["B"], x["C"], x["D"], x["z"], g)
    got = scan_adjoint(**x, g=g)
    for name, gt, wt in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz"), got, want):
        assert torch.isfinite(gt).all(), name
        bar = TOL_GRAD * max(1.0, wt.abs().max().item())
        assert (gt - wt).abs().max().item() <= bar, name
