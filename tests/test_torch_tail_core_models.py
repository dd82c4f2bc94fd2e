"""Kernels G and P's arithmetic (``csrc/spiral_epilogue.cu``,
``csrc/ssd_core_fwd.cu``) modelled in plain PyTorch on the CPU.

* G, the Spiral block's tail. The LayerNorm in the kernel's order (each
  lane's float4s, then the warp's butterfly), n = (v - mu) r an_w + an_b; fc1
  in 3xTF32: each operand split into a TF32 high part and remainder (round to
  nearest, ties away, on 10 mantissa bits) and every 8-deep step summed as
  lo.hi + hi.lo + hi.hi into the fp32 tile, the depth split in two where the
  kernel splits it and the partials added in split order; then per column
  tile of 32 the SiLU and the dot with fc2_w, each of four lanes over its
  columns and then (l0 + l1) + (l2 + l3), and the tiles summed in order
  before the bias and the sigmoid. Held against the JAX package's
  ``_spiral_epilogue_kernel`` in interpret mode (as ``_spiral_block_fwd_impl``
  launches it, rows padded to 8) at batch 1 and 2, 196 and 25 tokens, h = 512.
* P, the split probe's SSD core. Chunks balanced to the stream (196 steps:
  52, 52, 52, 40), the cumsum of dt * A in fp64 from each chunk's start,
  every chunk's end state per head and the state entering a chunk summed
  over the earlier ones in chunk order with fp64 offsets; y with the D skip
  and the silu(z) gate; each block's sum of squares over its two heads' 128
  channels (per thread over heads and its four channels, then the 16 lanes'
  butterfly) and the blocks' partials added in rank order, then the RMSNorm.
  Held against ``tools/probes/probe_split_ssd.py::_core_kernel`` in
  interpret mode at 1, 25, 196 and 197 steps and at a span of dt |A| in the
  thousands, with the probe's weights drawn as
  ``tests/test_torch_probe_split_ssd.py`` draws them.

Bar: kernel G's and P's on the card, 1e-4 * max(1, max |ref|).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffma_tpu.ops import fused_ssd as jax_fused

TOL = 1e-4
EPS = 1e-5
SMS = 132  # H100 SXM: the kernel's tile and split choice
PROBES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                      "probes")


def _bar(ref):
    return TOL * max(1.0, float(np.abs(ref).max()))


def fma(a, b, c):
    """fp32 fused multiply-add: the product and sum in fp64, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def butterfly(v, far_first=False):
    """The value every lane holds after a xor-shuffle sum over the last axis:
    offsets 1, 2, 4, ... (neighbours first), or with ``far_first`` the warp
    sum's 16, 8, 4, 2, 1."""
    while v.shape[-1] > 1:
        n = v.shape[-1] // 2
        v = v[..., :n] + v[..., n:] if far_first else v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def silu(x):
    return x / (1.0 + torch.exp(-x))


# ---- kernel G


def tf32(x):
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, ties away from 0."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32x3(a, w):
    """a (R, K) . w (N, K)^T as the 3xTF32 wgmma tile sums it: 8 deep at a
    time, lo.hi, then hi.lo, then hi.hi added to the fp32 accumulator."""
    ah, bh = tf32(a), tf32(w)
    al, bl = tf32(a - ah), tf32(w - bh)
    acc = a.new_zeros(a.shape[0], w.shape[0])
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = (acc.double() + x[:, s].double() @ y[:, s].double().T).float()
    return acc


def tail_model(o0, o1, x, gate, an_w, an_b, fc1_w, fc1_b, fc2_w, fc2_b):
    """Kernel G in its order; torch layouts, fp32, (B, L, h)."""
    B, L, h = x.shape
    R = B * L
    a, b = o0.reshape(R, h // 4, 4), o1.reshape(R, h // 4, 4)
    quad = ((a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])) + (
        (b[..., 0] + b[..., 1]) + (b[..., 2] + b[..., 3]))
    lanes = quad.reshape(R, -1, 32)  # float4 c on lane c % 32, in order
    s = lanes[:, 0]
    for it in range(1, lanes.shape[1]):
        s = s + lanes[:, it]
    mu = (butterfly(s, far_first=True) / (2 * h))[:, None]
    v = torch.cat([a, b], dim=-1) - mu[..., None]  # (R, h / 4, 8): a.x .. a.w, b.x .. b.w
    v = v.reshape(R, -1, 32, 8)
    q = torch.zeros(R, 32)
    for it in range(v.shape[1]):
        for e in range(8):
            q = fma(v[:, it, :, e], v[:, it, :, e], q)
    r = torch.rsqrt(butterfly(q, far_first=True) / (2 * h) + EPS)[:, None]
    cat = torch.cat([o0.reshape(R, h), o1.reshape(R, h)], dim=-1)
    n = fma((cat - mu) * r, an_w[None], an_b[None])

    row_tiles = -(-R // 64)
    bn = 64 if row_tiles * (h // 64) >= SMS else 32
    splits = 2 if row_tiles * (h // bn) < SMS else 1
    per = -(-2 * h // (splits * 32)) * 32
    hpre = None
    for sp in range(splits):
        part = tf32x3(n[:, sp * per:(sp + 1) * per], fc1_w[:, sp * per:(sp + 1) * per])
        hpre = part if hpre is None else hpre + part
    hm = silu(hpre + fc1_b)
    w2 = fc2_w.reshape(h)
    total = torch.zeros(R)
    for t in range(h // bn):  # column tiles in order
        lane = []
        for q4 in range(4):
            acc = torch.zeros(R)
            for j in range(bn // 8):
                for c in range(2):
                    col = t * bn + 8 * j + 2 * q4 + c
                    acc = fma(hm[:, col], w2[col], acc)
            lane.append(acc)
        total = total + ((lane[0] + lane[1]) + (lane[2] + lane[3]))
    alpha = (1.0 / (1.0 + torch.exp(-(total + fc2_b)))).reshape(B, L, 1)
    return x + gate[:, None, :] * (alpha * o0 + (1.0 - alpha) * o1)


def jax_tail(o0, o1, x, gate, an_w, an_b, fc1_w, fc1_b, fc2_w, fc2_b):
    """The JAX package's epilogue kernel in interpret mode, launched as
    ``_spiral_block_fwd_impl`` launches it; numpy in torch layouts."""
    B, L, h = x.shape
    Lp = -(-L // 8) * 8
    pad = lambda t: np.pad(t, ((0, 0), (0, Lp - L), (0, 0)))  # noqa: E731
    mods = np.zeros((B, 8, h), np.float32)
    mods[:, 2] = gate
    full = lambda i: (0, 0)  # noqa: E731
    out = pl.pallas_call(
        functools.partial(jax_fused._spiral_epilogue_kernel, h=h),
        grid=(B,),
        in_specs=[pl.BlockSpec((2, 1, Lp, h), lambda i: (0, i, 0, 0)),
                  pl.BlockSpec((1, Lp, h), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, 8, h), lambda i: (i, 0, 0)),
                  pl.BlockSpec((2, h), full), pl.BlockSpec((2, h), full),
                  pl.BlockSpec((2 * h, h), full), pl.BlockSpec((1, h), full),
                  pl.BlockSpec((h, 1), full), pl.BlockSpec((1, 1), full)],
        out_specs=pl.BlockSpec((1, Lp, h), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, Lp, h), jnp.float32),
        interpret=True,
    )(np.stack([pad(o0), pad(o1)]), pad(x), mods, an_w.reshape(2, h), an_b.reshape(2, h),
      np.ascontiguousarray(fc1_w.T), fc1_b[None], np.ascontiguousarray(fc2_w.T), fc2_b[None])
    return np.asarray(out)[:, :L]


def tail_inputs(B, L, seed, h=512):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, L, h), f(B, L, h), f(B, L, h), f(B, h), 1 + 0.1 * f(2 * h), 0.1 * f(2 * h),
            f(h, 2 * h) / np.float32(np.sqrt(2 * h)), 0.1 * f(h), f(1, h) / np.float32(np.sqrt(h)),
            0.1 * f(1))


@pytest.mark.parametrize("B,L", [(1, 196), (2, 196), (1, 25), (2, 25)])
def test_tail_model_matches_jax_epilogue_kernel(B, L):
    args = tail_inputs(B, L, seed=10 * B + L)
    want = jax_tail(*args)
    got = tail_model(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= _bar(want)


def test_tf32x3_product_keeps_fp32_accuracy():
    """The 3xTF32 split against fp64 at fc1's depth: within fp32 rounding of a
    1024-deep sum, where one TF32 product alone is not."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 1024)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 1024)).astype(np.float32))
    exact = a.double() @ w.double().T
    err3 = (tf32x3(a, w).double() - exact).abs().max().item()
    err1 = (tf32(a).double() @ tf32(w).double().T - exact).abs().max().item()
    assert err3 < 1e-4 < err1


# ---- kernel P


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(PROBES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jp():
    return _load("probe_split_ssd")


def core_weights(jp, seed, wide=False):
    """The JAX probe's weights (its layout and scales) drawn with numpy, as
    ``tests/test_torch_probe_split_ssd.py`` draws them; ``wide``: decay rates
    from 1 to 16 and dt_bias 1, a span of dt |A| in the thousands."""
    rng = np.random.default_rng(seed)
    u = lambda s, sc: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    conv_w, conv_b = u((2, jp.conv_dim, jp.K), 0.3), u((2, jp.conv_dim), 0.1)
    dt_bias, A_log = u((2, jp.H), 0.1), u((2, jp.H), 0.5)
    D, norm_w = 1 + u((2, jp.H), 0.5), 1 + u((2, jp.d), 0.5)
    if wide:
        A_log = np.log(np.tile(np.linspace(1.0, 16.0, jp.H, dtype=np.float32), (2, 1)))
        dt_bias = np.ones((2, jp.H), np.float32)
    return conv_w, conv_b, dt_bias, A_log, D, norm_w


def jax_core(jp, zx, w):
    """``_core_kernel`` in interpret mode on G sequences (two branches), the
    rows padded after each stream to a multiple of 8 (at least 8) as the probe
    pads them, rows 0 .. L - 1 kept."""
    G, L, _ = zx.shape
    Lp = max(8, -(-L // 8) * 8)
    padded = np.concatenate([zx, np.zeros((G, Lp - L, jp.dproj), np.float32)], axis=1)
    conv_w, conv_b, dt_bias, A_log, D, norm_w = map(jnp.asarray, w)
    kern = functools.partial(jp._core_kernel, L=Lp, eps=EPS, dt_lo=0.0, dt_hi=float("inf"),
                             per_branch=G // 2)
    full = lambda i: (0, 0, 0)  # noqa: E731
    wspecs = [pl.BlockSpec((2,) + s, full)
              for s in ((jp.K, jp.conv_dim), (1, jp.conv_dim), (1, jp.H), (1, jp.H), (1, jp.H),
                        (1, jp.d))]
    out = pl.pallas_call(
        kern, grid=(G,),
        in_specs=[pl.BlockSpec((1, Lp, jp.dproj), lambda i: (i, 0, 0)), *wspecs],
        out_specs=pl.BlockSpec((1, Lp, jp.d), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((G, Lp, jp.d), jnp.float32),
        scratch_shapes=[jp.pltpu.VMEM((Lp, jp.conv_dim), jnp.float32),
                        jp.pltpu.VMEM((Lp, jp.H), jnp.float32),
                        jp.pltpu.VMEM((Lp, jp.d), jnp.float32)],
        interpret=True,
    )(jnp.asarray(padded), jnp.swapaxes(conv_w, -1, -2), conv_b[:, None], dt_bias[:, None],
      -jnp.exp(A_log)[:, None], D[:, None], norm_w[:, None])
    return np.asarray(out)[:, :L]


def chunks_of(L, Q=64):
    """Kernel P's balanced chunks: nc = ceil(L / Q), each ceil(L / nc) steps
    rounded up to 4, the last one ragged."""
    nc = -(-L // Q)
    qc = -(-(-(-L // nc)) // 4) * 4
    return [(t0, min(L, t0 + qc)) for t0 in range(0, L, qc)]


def core_model(zx, w, n=16, hd=64, heads_per_block=2):
    """Kernel P in its order on one sequence zx (L, dproj) with one branch's
    weights (conv_w (d + 2n, 4), conv_b, dt_bias, A_log, D, norm_w)."""
    conv_w, conv_b, dt_bias, A_log, D, norm_w = w
    L = zx.shape[0]
    H = A_log.shape[0]
    d = H * hd
    raw = torch.cat([zx.new_zeros(3, d + 2 * n), zx[:, d:2 * d + 2 * n]])
    acc = conv_b.expand(L, -1)
    for k in range(4):
        acc = fma(conv_w[:, k], raw[k:k + L], acc)
    xbc = silu(acc)
    xs, Bs, Cs = xbc[:, :d].reshape(L, H, hd), xbc[:, d:d + n], xbc[:, d + n:]
    dt = torch.nn.functional.softplus(zx[:, 2 * d + 2 * n:] + dt_bias)  # (L, H)
    A = -torch.exp(A_log)
    z = zx[:, :d]
    y = torch.zeros(L, H, hd)
    states, sums = [], []
    chunks = chunks_of(L)
    for c, (t0, t1) in enumerate(chunks):
        q = t1 - t0
        lcs = torch.cumsum((dt[t0:t1] * A).double(), dim=0)  # (q, H)
        total = lcs[-1]
        x_c, B_c, C_c, dt_c = xs[t0:t1], Bs[t0:t1], Cs[t0:t1], dt[t0:t1]
        # the state entering the chunk: earlier states in chunk order, fp64 offsets
        hin = torch.zeros(H, n, hd)
        off = torch.zeros(H, dtype=torch.float64)
        for cp in range(c - 1, -1, -1):
            if cp + 1 != c:
                off = off + sums[cp + 1]
            hin = fma(torch.exp(off.float())[:, None, None], states[cp], hin)
        cb = torch.zeros(q, q)  # cb[t, u] = B_u . C_t, k in order
        for k in range(n):
            cb = fma(B_c[None, :, k], C_c[:, None, k], cb)
        causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
        decay = torch.exp((lcs[:, None, :] - lcs[None, :, :]).float())  # (t, u, H)
        M = torch.where(causal[..., None], cb[..., None] * decay * dt_c[None], 0.0)
        acc = torch.zeros(q, H, hd)
        for u in range(q):
            acc = fma(M[:, u, :, None], x_c[None, u], acc)
        cross = torch.zeros(q, H, hd)
        for k in range(n):
            cross = fma(C_c[:, None, k, None], hin[None, :, k], cross)
        y[t0:t1] = fma(torch.exp(lcs.float())[..., None], cross, acc) + D[None, :, None] * x_c
        if c + 1 < len(chunks):  # each chunk's end state, per head
            wB = B_c[:, None, :] * torch.exp((total[None] - lcs).float())[..., None] * dt_c[..., None]
            st = torch.zeros(H, n, hd)
            for u in range(q):
                st = fma(wB[u, :, :, None], x_c[u, :, None, :], st)
            states.append(st)
            sums.append(total)
    g = y.reshape(L, d) * silu(z)
    # sums of squares: per block of heads_per_block heads, per thread (tx) its
    # four channels of each head, then the 16 lanes; the blocks in rank order
    gb = g.reshape(L, H // heads_per_block, heads_per_block, hd // 4, 4)  # (t, rank, hh, tx, j)
    sq = torch.zeros(L, H // heads_per_block, hd // 4)
    for hh in range(heads_per_block):
        for j in range(4):
            sq = fma(gb[:, :, hh, :, j], gb[:, :, hh, :, j], sq)
    part = butterfly(sq)  # (L, ranks)
    total = torch.zeros(L)
    for r in range(part.shape[1]):
        total = total + part[:, r]
    rms = torch.rsqrt(total / d + EPS)[:, None]
    return g * rms * norm_w


@pytest.mark.parametrize("L,wide", [(1, False), (25, False), (196, False), (197, False),
                                    (196, True)])
def test_core_model_matches_jax_core_kernel(jp, L, wide):
    """One sequence per branch (G = 2), full width (d = 1024, 16 heads)."""
    w = core_weights(jp, seed=L + wide, wide=wide)
    zx = (np.random.default_rng(L).standard_normal((2, L, jp.dproj)) * 0.3).astype(np.float32)
    want = jax_core(jp, zx, w)
    got = np.stack([core_model(torch.from_numpy(zx[m]), [torch.from_numpy(a[m]) for a in w]).numpy()
                    for m in range(2)])
    if wide:
        dt = np.logaddexp(zx[..., -jp.H:] + w[2][:, None], 0.0)
        assert (dt.sum(1) * np.exp(w[3])).max() > 1000
    assert got.shape == want.shape == (2, L, jp.d) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= _bar(want)


def test_chunks_are_balanced():
    assert [t1 - t0 for t0, t1 in chunks_of(196)] == [52, 52, 52, 40]
    assert [t1 - t0 for t0, t1 in chunks_of(197)] == [52, 52, 52, 41]
    assert [t1 - t0 for t0, t1 in chunks_of(64)] == [64]
    assert [t1 - t0 for t0, t1 in chunks_of(65)] == [36, 29]
    assert [t1 - t0 for t0, t1 in chunks_of(25)] == [25]
