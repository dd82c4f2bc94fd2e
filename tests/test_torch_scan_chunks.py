"""The chunked forward scan of kernels A and H (``csrc/scan_fwd.cuh``)
modelled in plain PyTorch on the CPU.

The L steps of a stream are cut into ``chunks`` chunks of ceil(L / chunks)
steps (the last ones short or empty). Every chunk but the last runs from a
zero state and keeps its end state and its sum of dt; each chunk then folds
the chunks before it in order, h = exp2(A log2(e) sum dt) h + h_chunk, runs
again from that entry state and writes y. Each decay is exp2(dt A log2(e)),
as the kernel takes it. The model is held against the JAX package's
``selective_scan_ref`` at 1, 2, 4 and 8 chunks, at lengths from one step to
197, gated and ungated, and at a span dt |A| in the thousands, where every
cross-chunk decay underflows to 0 and everything must stay finite. Bar:
kernel A's, 1e-4 * max(1, max |ref|).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.ops.selective_scan import selective_scan_ref as jax_selective_scan_ref

TOL = 1e-4
LOG2E = 1.4426950408889634
NAMES = ("u", "delta", "A", "B", "C", "D", "z")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """The kernel's softplus: max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def chunked_scan(u, delta, A, B, C, D, z, chunks: int) -> torch.Tensor:
    """The kernel's scan in its order: u, delta, z (G, L, d); A (d, n);
    B, C (G, L, n); D (d,); z may be None (ungated)."""
    G, L, d = u.shape
    n = A.shape[1]
    dt = softplus(delta)
    a2 = (A * LOG2E).float()
    length = -(-L // chunks)
    bounds = [(min(L, w * length), min(L, w * length + length)) for w in range(chunks)]
    y = torch.empty_like(u)

    def run(h, t0, t1, out):
        for t in range(t0, t1):
            h = torch.exp2(dt[:, t, :, None] * a2) * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
            if out:
                y[:, t] = (h * C[:, t, None, :]).sum(-1) + D * u[:, t]
        return h

    ends = [(run(u.new_zeros(G, d, n), t0, t1, False), dt[:, t0:t1].sum(1))
            for t0, t1 in bounds[:-1]]
    for w, (t0, t1) in enumerate(bounds):
        h = u.new_zeros(G, d, n)
        for end, span in ends[:w]:
            h = torch.exp2(a2 * span[..., None]) * h + end
        run(h, t0, t1, True)
    return y if z is None else y * torch.nn.functional.silu(z)


def scan_inputs(L: int, seed: int, wide: bool = False, G: int = 2, d: int = 64, n: int = 16):
    """Numpy inputs of a gated scan: delta around -1, or, with ``wide``, dt of
    30 to 60 against A of -50 to -100, so that dt |A| runs in the thousands."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    u, z, B, C = f(G, L, d), f(G, L, d), f(G, L, n), f(G, L, n)
    if wide:
        delta = rng.uniform(30, 60, (G, L, d)).astype(np.float32)
        A = -rng.uniform(50, 100, (d, n)).astype(np.float32)
    else:
        delta = 0.5 * f(G, L, d) - 1.0
        A = -np.exp(0.5 * f(d, n)).astype(np.float32)
    return dict(u=u, delta=delta, A=A, B=B, C=C, D=f(d), z=z)


@functools.lru_cache(maxsize=None)
def case(L: int, gated: bool, wide: bool):
    """The inputs and the JAX package's output, once per case."""
    x = scan_inputs(L, seed=L + 1000 * wide, wide=wide)
    if not gated:
        x["z"] = None
    args = [None if x[k] is None else jnp.asarray(x[k]) for k in NAMES]
    return x, np.asarray(jax_selective_scan_ref(*args))


def check(L: int, gated: bool, wide: bool, chunks: int) -> None:
    x, want = case(L, gated, wide)
    got = chunked_scan(*(None if x[k] is None else torch.from_numpy(x[k]) for k in NAMES),
                       chunks=chunks).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    bar = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bar, (err, bar)


@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("L", [1, 7, 13, 49, 196, 197])
def test_chunked_scan_against_jax(L, gated, chunks):
    check(L, gated, wide=False, chunks=chunks)


@pytest.mark.parametrize("chunks", [2, 8])
@pytest.mark.parametrize("gated", [True, False])
def test_chunked_scan_at_a_wide_span(gated, chunks):
    x, _ = case(49, gated, wide=True)
    # the least span of a chunk: every cross-chunk decay exp2(a2 sum dt) underflows to 0
    span = float(softplus(torch.from_numpy(x["delta"])).min()) * float(-x["A"].max()) * (49 // chunks)
    assert span > 1000 and math.exp2(-span * LOG2E) == 0.0
    check(49, gated, wide=True, chunks=chunks)
