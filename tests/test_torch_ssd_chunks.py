"""The chunked SSD of kernels E and F (``csrc/ssd_core.cuh``,
``csrc/fused_ssd_bwd.cu``) modelled in plain PyTorch on the CPU.

* The forward: each stream cut into chunks of Q steps (the last one ragged),
  the cumsum of dt * A restarted at each chunk in fp64, each chunk's end
  state h_c = sum_u exp(sum(c) - lcs[u]) dt_u B_u (x) x_u, the state entering
  a chunk summed directly over the earlier chunks with the chunk offsets in
  fp64, and y = the chunk's causal product + exp(lcs[t]) C_t . h_in + D x;
  against the JAX package's ``ssd_ref``. Bar: kernel E's, 1e-4 * max(1,
  max |ref|).
* The adjoint: each chunk's share of the state adjoint, a_c, folded into the
  state adjoint g_h leaving each chunk; per chunk the intra-chunk products,
  the cross-chunk terms of g_xdt, g_B and g_C, and g_cs from the fp64 row and
  column sums of P with the diagonal left out, the cross-chunk parts as inner
  products with y_off and g_xdt_off; the reverse cumsum of g_cs over the whole
  stream in fp64 with a carry per chunk. Plugged into ``ssd_mixer_ref`` in
  place of its SSD and differentiated by autograd, against autograd of
  ``ssd_mixer_ref`` with an exact fp64 SSD. Bar: kernel F's, 2e-4 * max(1,
  max |ref|) per gradient.

Both are held at 25, 64 and 100 steps with Q = 16, at a span of dt |A| near
90 and at one in the thousands (where every cross-chunk decay underflows to
0 and everything must stay finite).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.ops.ssd import ssd_ref as jax_ssd_ref
from diffma_tpu_torch.ops import fused_ssd
from diffma_tpu_torch.ops.fused_ssd import Mamba2Weights, ssd_mixer_bwd_ref
from diffma_tpu_torch.ops.scan_orders import build_scan_spec

TOL_FWD = 1e-4
TOL_GRAD = 2e-4
Q = 16


def _dt(dt, dt_bias, dt_limit):
    return torch.logaddexp(dt + dt_bias, torch.zeros_like(dt)).clamp(*dt_limit)


def _chunks(L):
    return [(t0, min(L, t0 + Q)) for t0 in range(0, L, Q)]


def _fold(states, sums, c, later):
    """sum over the chunks before c (or after, ``later``) of exp(offset) st,
    the offset summed in fp64 from the chunks in between."""
    out = torch.zeros_like(states[0])
    off = torch.zeros_like(sums[0])
    order = range(c + 1, len(states)) if later else range(c - 1, -1, -1)
    for cp in order:
        out = out + torch.exp(off.float())[:, None, None] * states[cp]
        off = off + sums[cp]
    return out


def _chunk(dt, A, t0, t1):
    """lcs (q, H) in fp64, and the masked decay exp(lcs[t] - lcs[u]) (H, q, q)."""
    lcs = torch.cumsum((dt[t0:t1] * A).double(), dim=0)
    diff = (lcs[:, None, :] - lcs[None, :, :]).permute(2, 0, 1)
    causal = torch.ones(t1 - t0, t1 - t0, dtype=torch.bool).tril()
    decay = torch.exp(diff.masked_fill(~causal, float("-inf")).float())
    return lcs, decay


def chunked_fwd(x, dt, A, B, C, D):
    """One stream: x (L, H, P), dt (L, H) after softplus and clip, A (H,),
    B and C (L, N), D (H,); y (L, H, P), the chunk states (H, N, P) and sums."""
    L = x.shape[0]
    states, sums = [], []
    for t0, t1 in _chunks(L):
        lcs, _ = _chunk(dt, A, t0, t1)
        w = torch.exp((lcs[-1] - lcs).float()) * dt[t0:t1]
        states.append(torch.einsum("uh,un,uhp->hnp", w, B[t0:t1], x[t0:t1]))
        sums.append(lcs[-1])
    ys = []
    for c, (t0, t1) in enumerate(_chunks(L)):
        lcs, decay = _chunk(dt, A, t0, t1)
        m = (C[t0:t1] @ B[t0:t1].T)[None] * decay * dt[t0:t1].T[:, None, :]
        y = torch.einsum("htu,uhp->thp", m, x[t0:t1])
        h_in = _fold(states, sums, c, later=False)
        y = y + torch.exp(lcs.float())[..., None] * torch.einsum("tn,hnp->thp", C[t0:t1], h_in)
        ys.append(y + D[:, None] * x[t0:t1])
    return torch.cat(ys), states, sums


def chunked_bwd(x, dt, A, B, C, D, gy):
    """The adjoint of ``chunked_fwd`` as kernel F computes it: gradients of
    x, dt, A, B, C and D."""
    L = x.shape[0]
    _, states, sums = chunked_fwd(x, dt, A, B, C, D)
    a = []
    for t0, t1 in _chunks(L):
        lcs, _ = _chunk(dt, A, t0, t1)
        a.append(torch.einsum("th,tn,thp->hnp", torch.exp(lcs.float()), C[t0:t1], gy[t0:t1]))
    gx, gB, gC = torch.zeros_like(x), torch.zeros_like(B), torch.zeros_like(C)
    q = torch.zeros_like(dt)
    gcs = torch.zeros(dt.shape, dtype=torch.float64)
    for c, (t0, t1) in enumerate(_chunks(L)):
        lcs, decay = _chunk(dt, A, t0, t1)
        X, G, Bc, Cc, dtc = x[t0:t1], gy[t0:t1], B[t0:t1], C[t0:t1], dt[t0:t1]
        cb = (Cc @ Bc.T)[None]
        M = cb * decay                                                  # (H, t, u)
        W = torch.einsum("thp,uhp->htu", G, X) * decay * dtc.T[:, None, :]
        P = (W * cb).tril(-1).double()
        h_in, g_h = _fold(states, sums, c, later=False), _fold(a, sums, c, later=True)
        fu = torch.exp((lcs[-1] - lcs).float())                        # (u, H)
        er = torch.exp(lcs.float())                                     # (t, H)
        goff = fu[..., None] * torch.einsum("un,hnp->uhp", Bc, g_h)
        gxd = torch.einsum("htu,thp->uhp", M, G) + goff
        y_off = er[..., None] * torch.einsum("tn,hnp->thp", Cc, h_in)
        rowx = (G * y_off).double().sum(-1)
        colx = dtc.double() * (X * goff).double().sum(-1)
        gcs[t0:t1] = (P.sum(-1).T + rowx) - (P.sum(-2).T + colx)
        gx[t0:t1] = D[:, None] * G + dtc[..., None] * gxd
        q[t0:t1] = (X * gxd).sum(-1)
        gC[t0:t1] = (torch.einsum("htu,un->htn", W, Bc).sum(0)
                     + torch.einsum("th,thp,hnp->tn", er, G, h_in))
        gB[t0:t1] = (torch.einsum("htu,tn->hun", W, Cc).sum(0)
                     + torch.einsum("uh,uhp,hnp->un", fu * dtc, X, g_h))
    g_dA = torch.flip(torch.cumsum(torch.flip(gcs, [0]), 0), [0]).float()
    g_dt = q + g_dA * A
    gA = (g_dA * dt).sum(0)
    gD = (gy * x).sum((0, 2))
    return gx, g_dt, gA, gB, gC, gD


class ChunkedSsd(torch.autograd.Function):
    """``chunked_fwd`` forward, ``chunked_bwd`` backward, per sequence."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        ctx.save_for_backward(x, dt, A, B, C, D)
        return torch.stack([chunked_fwd(*t, A, B_, C_, D)[0]
                            for *t, B_, C_ in zip(x, dt, B, C)])

    @staticmethod
    def backward(ctx, gy):
        x, dt, A, B, C, D = ctx.saved_tensors
        per = [chunked_bwd(x[g], dt[g], A, B[g], C[g], D, gy[g]) for g in range(x.shape[0])]
        gx, gdt, gA, gB, gC, gD = (list(z) for z in zip(*per))
        return (torch.stack(gx), torch.stack(gdt), sum(gA), torch.stack(gB), torch.stack(gC),
                sum(gD))


def _ssd_chunked_model(x, dt, A, B, C, D, ngroups=1, dt_bias=None, dt_softplus=True,
                       dt_limit=(0.0, float("inf")), chunk_size=256):
    return ChunkedSsd.apply(x, _dt(dt, dt_bias, dt_limit), A, B, C, D)


def _ssd_exact_fp64(x, dt, A, B, C, D, ngroups=1, dt_bias=None, dt_softplus=True,
                    dt_limit=(0.0, float("inf")), chunk_size=256):
    """The whole sequence's quadratic form in fp64, the mask a selection."""
    x, dt, A, B, C, D, dt_bias = (t.double() for t in (x, dt, A, B, C, D, dt_bias))
    dtp = _dt(dt, dt_bias, dt_limit)
    cs = torch.cumsum(dtp * A, dim=1)                                     # (G, L, H)
    diff = (cs[:, :, None, :] - cs[:, None, :, :]).permute(0, 3, 1, 2)   # (G, H, t, u)
    L = x.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
    m = torch.einsum("gtn,gun->gtu", C, B)[:, None] * decay * dtp.permute(0, 2, 1)[:, :, None, :]
    y = torch.einsum("ghtu,guhp->gthp", m, x) + D[:, None] * x
    return y.float()


@pytest.mark.parametrize("L", [25, 64, 100])
@pytest.mark.parametrize("wide", [False, True])
def test_chunked_forward_matches_jax_ssd(L, wide):
    """The chunked forward against the JAX package's recurrence: ragged last
    chunk (L = 25, 100), chunk-aligned (L = 64), and a wide span."""
    rng = np.random.default_rng(L + 7 * wide)
    H, P, N = 3, 8, 16
    x = rng.standard_normal((L, H, P)).astype(np.float32)
    dt_raw = rng.standard_normal((L, H)).astype(np.float32)
    dt_bias = np.full(H, 1.5 if wide else -1.0, np.float32)
    A = -(np.linspace(1.0, 16.0, H) if wide else np.linspace(0.5, 2.0, H)).astype(np.float32)
    B = rng.standard_normal((L, N)).astype(np.float32)
    C = rng.standard_normal((L, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    want = np.asarray(jax_ssd_ref(jnp.asarray(x[None]), jnp.asarray(dt_raw[None]), jnp.asarray(A),
                                  jnp.asarray(B[None]), jnp.asarray(C[None]), jnp.asarray(D),
                                  dt_bias=jnp.asarray(dt_bias)))[0]
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, B=B, C=C, D=D, A=A).items()}
    dt = _dt(torch.from_numpy(dt_raw), torch.from_numpy(dt_bias), (0.0, float("inf")))
    span = (dt.sum(0) * -t["A"]).max().item()
    assert span > 500 if wide else span < 200, span
    got, states, sums = chunked_fwd(t["x"], dt, t["A"], t["B"], t["C"], t["D"])
    assert len(states) == -(-L // Q) and all(s.dtype == torch.float64 for s in sums)
    assert torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL_FWD * max(1.0, np.abs(want).max()), err


def _mixer(L, wide, seed):
    h, d = 64, 128  # two heads of 64
    spec = build_scan_spec("spiral", int(round(L ** 0.5)), 1)
    gen = torch.Generator().manual_seed(seed)
    H, n = d // 64, 16
    dproj, conv_dim = 2 * d + 2 * n + H, d + 2 * n
    w = Mamba2Weights(
        in_w=torch.randn(dproj, h, generator=gen) / h ** 0.5,
        conv_w=0.3 * torch.randn(conv_dim, 1, 4, generator=gen),
        conv_b=0.1 * torch.randn(conv_dim, generator=gen),
        dt_bias=torch.full((H,), 2.0 if wide else -2.0),
        A_log=torch.log(torch.tensor([8.0, 16.0] if wide else [2.5, 5.0])),
        D=torch.randn(H, generator=gen),
        norm_w=1 + 0.1 * torch.randn(d, generator=gen),
        out_w=torch.randn(h, d, generator=gen) / d ** 0.5,
    )
    x = torch.randn(1, L, h, generator=gen)
    g = torch.randn(1, L, h, generator=gen)
    return spec, x, g, w


@pytest.mark.parametrize("L,wide", [(25, False), (100, False), (64, True), (100, True)])
def test_chunked_adjoint_matches_fp64_autograd(L, wide, monkeypatch):
    """The mixer's gradients with the chunked SSD and its adjoint inside,
    against autograd of the mixer with the exact fp64 SSD, per gradient;
    spans near 90 and in the thousands, the streams of a spiral spec."""
    spec, x, g, w = _mixer(L, wide, seed=L + wide)
    monkeypatch.setattr(fused_ssd, "ssd_chunked_grouped", _ssd_exact_fp64)
    gx_want, gw_want = ssd_mixer_bwd_ref(spec, x, g, w)
    monkeypatch.setattr(fused_ssd, "ssd_chunked_grouped", _ssd_chunked_model)
    gx_got, gw_got = ssd_mixer_bwd_ref(spec, x, g, w)
    zx = torch.nn.functional.linear(x, w.in_w)
    dt = _dt(zx[..., -w.A_log.numel():], w.dt_bias, (0.0, float("inf")))
    span = (dt.sum(1) * torch.exp(w.A_log)).max().item()
    assert span > 1000 if wide else 10 < span < 200, span
    for name, got, want in [("x", gx_got, gx_want), *zip(Mamba2Weights._fields, gw_got, gw_want)]:
        assert torch.isfinite(got).all(), name
        err = (got - want).abs().max().item()
        bar = TOL_GRAD * max(1.0, want.abs().max().item())
        assert err <= bar, (name, err, bar)
