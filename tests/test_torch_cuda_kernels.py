"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Kernels A and B (the selective scan, forward and backward), kernels C and
D (the fused Mamba-1 mixer, forward and backward, both also on the vim quirk
and on EfficientVMamba's partition), kernels E and F (the fused Mamba-2
mixer: single, dual, prologue and residual modes, partition specs, and its
backward), kernel G (the Spiral block's tail), kernel H (the Mamba-1
mixer's inner part, and the ``Mamba`` route that reaches it) and kernel P
(the split SSD probe's core) are held against their plain versions at the
model's widths;
the tolerance of C, E, G, H and P is max |err| <= 1e-4 * max(1, max |ref|), since
their fp32 sums over K = 512 or 1024 run in another order than cuBLAS's; their
bf16 variants' is 2e-2 * max(1, max |ref|) and 5e-3 mean-rel against their
bf16 plain versions, which round at the same places, and H's and P's 2^-6 *
max(1, max |ref|) and 1e-5 mean-rel (``chip_smoke.py``'s ``TOL_HP_BF16``).
Gradients, from B, D, F and the autograd Functions, are
held per tensor to 2e-4 * max(1, max |ref|), the JAX package's gradient bar
(``tests/test_selective_scan.py``).

These tests need an NVIDIA GPU with nvcc and skip elsewhere. The file imports
neither JAX nor ``diffma_tpu``, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import math

import numpy as np
import pytest
import torch

from diffma_tpu_torch.models.blocks import SpiralMambaBlock
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.ops.fused_mamba import (
    mamba_inner_fused,
    mamba_inner_fused_cuda,
    mamba_inner_plain,
    mamba_inner_ref,
)
from diffma_tpu_torch.ops.fused_mixer import (
    mamba_dual_mixer_fused,
    mamba_mixer_fused,
    mixer_bwd_ref,
    mixer_fused_bwd_cuda,
    mixer_fused_cuda,
    mixer_ref,
)
from diffma_tpu_torch.ops.fused_ssd import (
    Mamba2Weights,
    Prologue,
    mamba2_dual_mixer_fused,
    mamba2_mixer_fused,
    spiral_block_fused,
    spiral_block_ref,
    spiral_epilogue_cuda,
    spiral_epilogue_ref,
    ssd_core_cuda,
    ssd_core_ref,
    ssd_mixer_bwd_ref,
    ssd_mixer_fused_bwd_cuda,
    ssd_mixer_fused_cuda,
    ssd_mixer_ref,
)
from diffma_tpu_torch.ops.scan_orders import ScanSpec, _build_merge_table, build_scan_spec
from diffma_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_bwd_cuda,
    selective_scan_bwd_ref,
    selective_scan_cuda,
    selective_scan_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The modules' default init draws from the global generator, which torch
    # seeds anew in every process: seeded here, each test draws the same
    # weights in every run, whatever ran before it.
    torch.manual_seed(0)
    return torch.device("cuda")


def _inputs(device, G, L, d, n, dtype, delta_dtype=None, seed=0, wide=False):
    """Kernel A's inputs; with ``wide``, dt of 30 to 60 against A of -50 to
    -100, a span dt |A| in the thousands over any chunk."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    uniform = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(*s, generator=gen)  # noqa: E731
    u = r(G, L, d).to(device, dtype)
    delta = uniform(30, 60, G, L, d) if wide else 0.5 * r(G, L, d) - 1.0
    delta = delta.to(device, delta_dtype or dtype)
    A = (-uniform(50, 100, d, n) if wide else -torch.exp(0.5 * r(d, n))).to(device)
    B = r(G, L, n).to(device, dtype)
    C = r(G, L, n).to(device, dtype)
    D = r(d).to(device)
    z = r(G, L, d).to(device, dtype)
    return u, delta, A, B, C, D, z


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("L", [196, 13, 211])
def test_kernel_matches_plain_fp32(cuda, gated, L):
    u, delta, A, B, C, D, z = _inputs(cuda, 3, L, 256, 16, torch.float32)
    z = z if gated else None
    got = selective_scan_cuda(u, delta, A, B, C, D, z)
    want = selective_scan_ref(u, delta, A, B, C, D, z)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("delta_dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_bf16(cuda, delta_dtype):
    u, delta, A, B, C, D, z = _inputs(cuda, 2, 67, 96, 16, torch.bfloat16, delta_dtype)
    got = selective_scan_cuda(u, delta, A, B, C, D, z)
    want = selective_scan_ref(u, delta, A, B, C, D, z)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize(
    "G,L,dtype,gated,wide",
    [(24, 196, torch.float32, True, False),  # the composable training step: one chunk
     (1, 1, torch.float32, True, False),  # one step
     (3, 9, torch.float32, True, False),  # fewer steps than the chunks allow
     (3, 196, torch.float32, True, True),  # every cross-chunk decay underflows
     (3, 196, torch.float32, False, True),
     (3, 196, torch.bfloat16, False, False)])  # bf16 with the most chunks (8)
def test_kernel_chunked_scan_cases(cuda, G, L, dtype, gated, wide):
    """Kernel A's scan, chunked over up to eight warps of a block, at the
    model's width (d = 1024) where the chunk count changes with G and L."""
    u, delta, A, B, C, D, z = _inputs(cuda, G, L, 1024, 16, dtype, seed=G + L, wide=wide)
    z = z if gated else None
    got = selective_scan_cuda(u, delta, A, B, C, D, z)
    want = selective_scan_ref(u, delta, A, B, C, D, z)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_auto_launches_kernel_and_counts(cuda):
    u, delta, A, B, C, D, z = _inputs(cuda, 1, 8, 32, 16, torch.float32)
    before = selective_scan_cuda.launches
    selective_scan(u, delta, A, B, C, D, z)
    assert selective_scan_cuda.launches == before + 1
    selective_scan(u, delta, A, B, C, D, z, impl="ref")
    assert selective_scan_cuda.launches == before + 1


def test_kernel_rejects_what_it_does_not_take(cuda):
    u, delta, A, B, C, D, z = _inputs(cuda, 1, 8, 32, 16, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan_cuda(u.transpose(1, 2).contiguous().transpose(1, 2), delta, A, B, C, D)
    with pytest.raises(ValueError, match="d_state"):
        selective_scan_cuda(u, delta, A[:, :8].contiguous(), B[..., :8].contiguous(),
                            C[..., :8].contiguous(), D)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        selective_scan_cuda(u.half(), delta, A, B, C, D)


HIDDEN = 512  # DiffMa's width: d_inner 1024, d_state 16, dt_rank 32


def _random_(module, seed):
    """Every parameter of ``module`` moved by seeded noise (A_log, D and the
    biases included), so that nothing sits at its init value: std 0.1 for
    vectors, 0.1 / sqrt(fan-in) for the others."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = 0.1 if p.dim() == 1 else 0.1 / math.sqrt(p.shape[-1])
            p.add_(std * torch.randn(p.shape, generator=gen))
    return module


def _mixers(device, spec, seed, count=2):
    return [
        _random_(Mamba(HIDDEN, spec), seed + i).to(device).eval() for i in range(count)
    ]


def _x(device, L, seed, batch=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(batch, L, HIDDEN, generator=gen).to(device)


def _assert_close_to_ref(got, want):
    tol = 1e-4 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert err <= tol, f"max |err| {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("grid_n,layer,batch", [(14, 0, 1), (14, 3, 1), (5, 0, 2)])
def test_fused_mixer_matches_plain_dual(cuda, grid_n, layer, batch):
    spec = build_scan_spec("spiral", grid_n, layer)
    m0, m1 = _mixers(cuda, spec, seed=layer)
    x0, x1 = _x(cuda, grid_n * grid_n, 10, batch), _x(cuda, grid_n * grid_n, 11, batch)
    with torch.no_grad():
        got = mamba_dual_mixer_fused(spec, x0, x1, m0.weights(), m1.weights())
        want = [mixer_ref(spec, x, m.weights()) for x, m in ((x0, m0), (x1, m1))]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_close_to_ref(g, w)


@pytest.mark.parametrize("grid_n,layer", [(14, 3), (5, 1)])
def test_fused_mixer_matches_plain_single(cuda, grid_n, layer):
    spec = build_scan_spec("spiral", grid_n, layer)
    (m,) = _mixers(cuda, spec, seed=7, count=1)
    x = _x(cuda, grid_n * grid_n, 12)
    with torch.no_grad():
        got = mamba_mixer_fused(spec, x, m.weights())
        want = mixer_ref(spec, x, m.weights())
    torch.cuda.synchronize()
    _assert_close_to_ref(got, want)


def test_fused_mixer_counts_calls(cuda):
    spec = build_scan_spec("spiral", 5, 0)
    m0, m1 = _mixers(cuda, spec, seed=0)
    x = _x(cuda, 25, 0)
    before, scans = mixer_fused_cuda.launches, selective_scan_cuda.launches
    with torch.no_grad():
        mamba_dual_mixer_fused(spec, x, x, m0.weights(), m1.weights())
        assert mixer_fused_cuda.launches == before + 1
        mamba_mixer_fused(spec, x, m0.weights())
        assert mixer_fused_cuda.launches == before + 2
        mamba_mixer_fused(spec, x, m0.weights(), impl="ref")
        m0.scan_impl = "fused"
        m0(x)
    assert mixer_fused_cuda.launches == before + 3
    assert selective_scan_cuda.launches == scans  # the fused path never launches kernel A


def test_fused_mixer_rejects_what_it_does_not_take(cuda):
    spec = build_scan_spec("spiral", 5, 0)
    (m,) = _mixers(cuda, spec, seed=0, count=1)
    w, x = m.weights(), _x(cuda, 25, 0)
    with pytest.raises(ValueError, match="float32"):
        mixer_fused_cuda(spec, (x.double(),), (w,))
    with pytest.raises(ValueError, match="tokens"):
        mixer_fused_cuda(spec, (x[:, :24].contiguous(),), (w,))
    with pytest.raises(ValueError, match="is on cpu"):
        mixer_fused_cuda(spec, (x,), (w._replace(D=w.D.cpu()),))
    with pytest.raises(ValueError, match="contiguous"):
        mixer_fused_cuda(spec, (x,), (w._replace(in_w=w.in_w.t().contiguous().t()),))
    with pytest.raises(ValueError, match="shape"):
        mixer_fused_cuda(spec, (x,), (w._replace(out_w=w.out_w[:, :-1]),))
    with pytest.raises(ValueError, match="d_state"):
        mixer_fused_cuda(spec, (x,), (w._replace(A_log=w.A_log[:, :8].contiguous()),))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mixer_fused_cuda(spec, (x.cpu(),), (w,))
    shifted = torch.empty(w.conv_w.numel() + 1, device=cuda)[1:].view_as(w.conv_w)
    with pytest.raises(ValueError, match="aligned"):
        mixer_fused_cuda(spec, (x,), (w._replace(conv_w=shifted.copy_(w.conv_w)),))


def test_fused_block_matches_pallas_block(cuda):
    spec = build_scan_spec("spiral", 14, 3)
    block = _random_(SpiralMambaBlock(HIDDEN, spec), 3).to(cuda).eval()
    gen = torch.Generator().manual_seed(4)
    x = _x(cuda, 196, 5)
    c = torch.randn(1, 2 * HIDDEN, generator=gen).to(cuda)
    w = torch.sigmoid(torch.randn(1, 196, 1, generator=gen)).to(cuda)
    with torch.no_grad():
        block.scan_impl = "fused"
        got = block(x, c, w)
        block.scan_impl = "pallas"
        want = block(x, c, w)
    torch.cuda.synchronize()
    _assert_close_to_ref(got, want)


GRAD_TOL = 2e-4


def _assert_grad_close(got, want, name):
    tol = GRAD_TOL * max(1.0, want.abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == want.shape and torch.isfinite(got).all(), name
    assert err <= tol, f"{name}: max |err| {err:.3e} > {tol:.3e}"


def _check_scan_bwd(device, G, L, d, dtype, delta_dtype, gated, wide=False):
    """Kernel B against ``selective_scan_bwd_ref``, called twice: the second
    call must give the first one's bits."""
    u, delta, A, B, C, D, z = _inputs(device, G, L, d, 16, dtype, delta_dtype, wide=wide)
    z = z if gated else None
    g = torch.randn(G, L, d, generator=torch.Generator().manual_seed(9)).to(device, dtype)
    got = selective_scan_bwd_cuda(u, delta, A, B, C, D, z, g)
    again = selective_scan_bwd_cuda(u, delta, A, B, C, D, z, g)
    want = selective_scan_bwd_ref(u, delta, A, B, C, D, z, g)
    torch.cuda.synchronize()
    for name, a, a2, b in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz"), got, again, want):
        if b is None:
            assert a is None and a2 is None
        else:
            _assert_grad_close(a, b, name)
            assert torch.equal(a, a2), f"{name} differs between two calls"


@pytest.mark.parametrize(
    "G,L,dtype,delta_dtype,gated",
    [(3, 196, torch.float32, None, True), (2, 13, torch.float32, None, False),
     (2, 197, torch.float32, None, True), (2, 67, torch.bfloat16, torch.float32, True),
     (24, 196, torch.float32, None, True), (24, 196, torch.float32, None, False),
     (2, 1, torch.float32, None, True), (2, 16, torch.float32, None, True),
     (2, 17, torch.float32, None, False), (3, 196, torch.bfloat16, torch.bfloat16, True),
     (3, 196, torch.bfloat16, torch.float32, False)],
)
def test_scan_bwd_kernel_matches_plain(cuda, G, L, dtype, delta_dtype, gated):
    """Kernel B: the composable path's G = 24 (DiffMa-B/2's three streams at
    batch 8) at its width d = 1024, gated and not; one step, one chunk, a
    chunk and a step, ragged lengths; both bf16 delta types."""
    _check_scan_bwd(cuda, G, L, 1024 if G == 24 else 256, dtype, delta_dtype, gated)


@pytest.mark.parametrize("L,gated", [(196, True), (17, False)])
def test_scan_bwd_kernel_at_a_wide_span(cuda, L, gated):
    """Kernel B where every decay underflows to 0 (dt |A| in the thousands)."""
    _check_scan_bwd(cuda, 3, L, 256, torch.float32, None, gated, wide=True)


def test_scan_autograd_matches_plain_autograd(cuda):
    """SelectiveScanFn (kernels A and B) gives the inputs the gradients that
    plain autograd through the plain scan gives them."""
    x = _inputs(cuda, 2, 50, 64, 16, torch.float32)
    leaves = [t.clone().requires_grad_() for t in x]
    refs = [t.clone().requires_grad_() for t in x]
    out = selective_scan(*leaves, impl="kernel")
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    before = selective_scan_bwd_cuda.launches
    out.backward(g)
    assert selective_scan_bwd_cuda.launches == before + 1
    selective_scan(*refs, impl="ref").backward(g)
    for name, a, b in zip("u delta A B C D z".split(), leaves, refs):
        _assert_grad_close(a.grad, b.grad, name)


@pytest.mark.parametrize(
    "family,grid_n,layer,batch",
    [("spiral", 14, 0, 2), ("spiral", 14, 3, 1), ("spiral", 5, 1, 2),
     ("zig", 14, 2, 1), ("vmamba", 14, 0, 1)],  # 3, 1 and 4 streams
)
def test_fused_mixer_bwd_matches_plain(cuda, family, grid_n, layer, batch):
    spec = build_scan_spec(family, grid_n, layer)
    m0, m1 = _mixers(cuda, spec, seed=layer)
    L = grid_n * grid_n
    xs = [_x(cuda, L, 20 + i, batch) for i in range(2)]
    gs = [_x(cuda, L, 30 + i, batch) for i in range(2)]
    ws = [m0.weights(), m1.weights()]
    for M in (2, 1):
        gxs, grads = mixer_fused_bwd_cuda(spec, xs[:M], gs[:M], ws[:M])
        torch.cuda.synchronize()
        for m in range(M):
            gx_ref, gw_ref = mixer_bwd_ref(spec, xs[m], gs[m], ws[m])
            _assert_grad_close(gxs[m], gx_ref, f"M={M} gx{m}")
            for name, a, b in zip(gw_ref._fields, grads[m], gw_ref):
                _assert_grad_close(a, b, f"M={M} w{m}.{name}")


def test_fused_autograd_gives_mixer_weights_their_gradients(cuda):
    """The repaired fault: through kernel C, every mixer weight gets the
    gradient plain autograd gives it, and the input too."""
    spec = build_scan_spec("spiral", 14, 3)
    block = _random_(SpiralMambaBlock(HIDDEN, spec), 5).to(cuda)
    gen = torch.Generator().manual_seed(6)
    x = _x(cuda, 196, 7, batch=2)
    c = torch.randn(2, 2 * HIDDEN, generator=gen).to(cuda)
    w = torch.sigmoid(torch.randn(2, 196, 1, generator=gen)).to(cuda)
    g = torch.randn(2, 196, HIDDEN, generator=gen).to(cuda)
    grads = {}
    for impl in ("fused", "ref"):
        block.zero_grad()
        block.scan_impl = impl
        xi = x.clone().requires_grad_()
        calls = mixer_fused_bwd_cuda.launches
        block(xi, c, w).backward(g)
        assert mixer_fused_bwd_cuda.launches == calls + (impl == "fused")
        grads[impl] = {"x": xi.grad, **{k: p.grad for k, p in block.named_parameters()}}
    for name, want in grads["ref"].items():
        got = grads["fused"][name]
        assert got is not None, f"{name} got no gradient through the kernels"
        _assert_grad_close(got, want, name)


@pytest.mark.parametrize("family,grid_n,batch",
                         [("vim", 14, 8), ("vim", 5, 2), ("eff", 14, 8), ("eff", 10, 2)])
def test_fused_mixer_bwd_branches_match_plain(cuda, family, grid_n, batch):
    """Kernel D's vim branch (196 and 25 tokens) and partition branch (4
    streams of 49 and of 25 steps, neither a multiple of the checkpoint
    chunk) against ``mixer_bwd_ref``, every gradient tensor; a dual call
    with the quirk still raises."""
    spec = build_scan_spec(family, grid_n, 1)
    (m,) = _mixers(cuda, spec, seed=grid_n, count=1)
    L = grid_n * grid_n
    x, g, w = _x(cuda, L, 40, batch), _x(cuda, L, 41, batch), m.weights()
    before = mixer_fused_bwd_cuda.launches
    (gx,), (gw,) = mixer_fused_bwd_cuda(spec, (x,), (g,), (w,))
    torch.cuda.synchronize()
    assert mixer_fused_bwd_cuda.launches == before + 1
    gx_ref, gw_ref = mixer_bwd_ref(spec, x, g, w)
    _assert_grad_close(gx, gx_ref, "gx")
    for name, a, b in zip(gw_ref._fields, gw, gw_ref):
        _assert_grad_close(a, b, name)
    if family == "vim":
        with pytest.raises(ValueError, match="vim quirk"):
            mixer_fused_bwd_cuda(spec, (x, x), (g, g), (w, w))


# ---- kernels C and D in bf16 (the bf16 model's mixers)

BF16_CASES = [("spiral", 14, 0, 1), ("spiral", 14, 0, 8), ("spiral", 5, 1, 2), ("vim", 14, 0, 1),
              ("vim", 5, 0, 2), ("eff", 14, 1, 1), ("eff", 10, 1, 2), ("zig", 14, 2, 1)]


def _bf16_case(device, family, grid_n, layer, batch):
    """Both branches for the Spiral block, one mixer otherwise; x and g bf16."""
    spec = build_scan_spec(family, grid_n, layer)
    mixers = _mixers(device, spec, seed=layer, count=2 if family == "spiral" else 1)
    L = grid_n * grid_n
    xs = [_x(device, L, 50 + i, batch).to(torch.bfloat16) for i in range(len(mixers))]
    gs = [_x(device, L, 60 + i, batch).to(torch.bfloat16) for i in range(len(mixers))]
    return spec, [m.weights() for m in mixers], xs, gs


def _mean_rel(got, want) -> float:
    return ((got.float() - want.float()).abs().mean() / want.float().abs().mean()).item()


@pytest.mark.parametrize("family,grid_n,layer,batch", BF16_CASES)
def test_fused_mixer_bf16_matches_plain(cuda, family, grid_n, layer, batch):
    """Kernel C's bf16 variant against its bf16 plain version (``mixer_ref``
    at bf16): max |err| <= 2e-2 max(1, max |ref|), mean-rel <= 5e-3, the
    same bits on a second call; counted as a bf16 launch."""
    spec, ws, xs, _ = _bf16_case(cuda, family, grid_n, layer, batch)
    launches = (mixer_fused_cuda.launches, mixer_fused_cuda.bf16.launches)
    with torch.no_grad():
        got, again = (mixer_fused_cuda(spec, xs, ws) for _ in range(2))
        want = [mixer_ref(spec, x, w) for x, w in zip(xs, ws)]
    torch.cuda.synchronize()
    assert (mixer_fused_cuda.launches, mixer_fused_cuda.bf16.launches) == (launches[0],
                                                                          launches[1] + 2)
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        assert torch.equal(g, a)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, w.float().abs().max().item()), err
        assert _mean_rel(g, w) <= 5e-3


@pytest.mark.parametrize("family,grid_n,layer,batch", BF16_CASES)
def test_fused_mixer_bwd_bf16_matches_plain(cuda, family, grid_n, layer, batch):
    """Kernel D's bf16 variant against autograd over the bf16 plain version,
    every gradient within mean-rel 1e-2, gx bf16 and the weights' gradients
    fp32, the same bits on a second call."""
    spec, ws, xs, gs = _bf16_case(cuda, family, grid_n, layer, batch)
    before = mixer_fused_bwd_cuda.bf16.launches
    got, again = (mixer_fused_bwd_cuda(spec, xs, gs, ws) for _ in range(2))
    torch.cuda.synchronize()
    assert mixer_fused_bwd_cuda.bf16.launches == before + 2
    for m in range(len(xs)):
        gx_ref, gw_ref = mixer_bwd_ref(spec, xs[m], gs[m], ws[m])
        pairs = [("gx", got[0][m], again[0][m], gx_ref)]
        pairs += [(n, a, b, r) for n, a, b, r in zip(gw_ref._fields, got[1][m], again[1][m], gw_ref)]
        for name, a, b, ref in pairs:
            assert a.dtype == (torch.bfloat16 if name == "gx" else torch.float32), name
            assert torch.equal(a, b), name
            assert _mean_rel(a, ref) <= 1e-2, (name, _mean_rel(a, ref))


def test_fused_mixer_bf16_takes_fp32_weights_only(cuda):
    """bf16 x with a bf16 weight raises, as does a bf16 g against fp32 x."""
    spec, ws, xs, gs = _bf16_case(cuda, "spiral", 5, 0, 1)
    w = ws[0]._replace(in_w=ws[0].in_w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32"):
        mixer_fused_cuda(spec, xs[:1], (w,))
    with pytest.raises(ValueError, match="float32"):
        mixer_fused_bwd_cuda(spec, xs[:1], gs[:1], (w,))
    with pytest.raises(ValueError, match="must match"):
        mixer_fused_bwd_cuda(spec, (xs[0].float(),), gs[:1], ws[:1])


@pytest.mark.parametrize("kernel", ["H", "P"])
def test_kernels_h_and_p_refuse_float16_on_the_card(cuda, kernel):
    """Kernels H and P take float32 and bfloat16: their wrappers refuse a
    float16 CUDA tensor, naming the kernel, and launch nothing."""
    f16 = torch.float16
    with pytest.raises(ValueError, match=f"kernel {kernel} takes"):
        if kernel == "H":
            xz, *weights = _inner_inputs(cuda, 1, 16, 0)
            mamba_inner_fused_cuda(xz.to(f16), *weights)
        else:
            spec = build_scan_spec("spiral", 4, 0)
            (m,) = _mixers2(cuda, spec, seed=0, count=1)
            w = m.weights()
            zx = torch.zeros(1, 16, w.in_w.shape[0], device=cuda, dtype=f16)
            ssd_core_cuda(zx, (w,))


# ---- kernel E (the fused Mamba-2 mixer) and kernel G (the Spiral block's tail)

NO_LIMIT = (0.0, float("inf"))


def _mixers2(device, spec, seed, count=2, wide=False):
    """Mamba-2 mixers with every parameter off its init. ``wide``: decay rates
    up to 16 and dt near 1, so that each head's span of dt * A over the
    sequence is far beyond what exp can hold (hundreds to thousands)."""
    mixers = [_random_(Mamba2(HIDDEN, spec), seed + i) for i in range(count)]
    if wide:
        with torch.no_grad():
            for m in mixers:
                m.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, m.A_log.numel())))
                m.dt_bias.fill_(1.0)
    return [m.to(device).eval() for m in mixers]


def _block_inputs(device, L, seed, batch):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, L, HIDDEN, generator=gen).to(device)
    c = torch.randn(batch, 2 * HIDDEN, generator=gen).to(device)
    w = torch.sigmoid(torch.randn(batch, L, 1, generator=gen)).to(device)
    return x, c, w


@pytest.mark.parametrize(
    "family,grid_n,layer,batch,dt_limit,wide",
    [("spiral", 14, 0, 1, NO_LIMIT, False), ("spiral", 14, 3, 2, NO_LIMIT, False),
     ("spiral", 5, 1, 2, NO_LIMIT, False), ("spiral", 14, 2, 1, (0.01, 0.05), False),
     ("spiral", 14, 1, 1, NO_LIMIT, True), ("zig", 14, 2, 1, NO_LIMIT, False),
     ("vmamba", 14, 0, 1, NO_LIMIT, False), ("vim", 14, 0, 1, NO_LIMIT, False)],
)
def test_fused_ssd_matches_plain(cuda, family, grid_n, layer, batch, dt_limit, wide):
    """Kernel E, dual and single, against ``ssd_mixer_ref``: 196 and 25 tokens,
    1 to 4 streams, a finite dt_limit, and a wide decay span."""
    spec = build_scan_spec(family, grid_n, layer)
    m0, m1 = _mixers2(cuda, spec, seed=layer, wide=wide)
    L = grid_n * grid_n
    x0, x1 = _x(cuda, L, 40, batch), _x(cuda, L, 41, batch)
    with torch.no_grad():
        got = mamba2_dual_mixer_fused(spec, x0, x1, m0.weights(), m1.weights(), dt_limit)
        single = mamba2_mixer_fused(spec, x1, m1.weights(), dt_limit)
        want = [ssd_mixer_ref(spec, x, m.weights(), dt_limit) for x, m in ((x0, m0), (x1, m1))]
    torch.cuda.synchronize()
    for g, w in zip((*got, single), (*want, want[1])):
        _assert_close_to_ref(g, w)


@pytest.mark.parametrize("grid_n,layer,batch", [(14, 3, 1), (14, 0, 2), (5, 1, 2), (14, 1, 8)])
def test_fused_ssd_prologue_and_epilogue_match_plain(cuda, grid_n, layer, batch):
    """Kernel E's prologue mode and kernel G, each against its plain version,
    fed by a block's own adaLN chunks (rows a stride apart); G twice, with
    equal bits."""
    spec = build_scan_spec("spiral", grid_n, layer)
    block = _random_(SpiralMambaBlock(HIDDEN, spec, use_mamba2=True), 8 + layer).to(cuda).eval()
    x, c, w = _block_inputs(cuda, grid_n * grid_n, 9 + layer, batch)
    an, fc1, _, fc2 = block.attention_network
    with torch.no_grad():
        shift, scale, gate = block.adaLN_modulation(c).chunk(3, dim=-1)
        pro = Prologue(w, block.norm1.weight, block.norm1.bias, shift, scale)
        ws = (block.mamba1.weights(), block.mamba2.weights())
        o0, o1 = ssd_mixer_fused_cuda(spec, (x,), ws, prologue=pro)
        xm = torch.nn.functional.layer_norm(x, (HIDDEN,), pro.ln_w, pro.ln_b, 1e-5)
        xm = xm * (1 + scale[:, None]) + shift[:, None]
        want0, want1 = ssd_mixer_ref(spec, xm, ws[0]), ssd_mixer_ref(spec, xm * w, ws[1])
        tail = (gate, an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)
        got_tail = spiral_epilogue_cuda(want0, want1, x, *tail)
        again = spiral_epilogue_cuda(want0, want1, x, *tail)
        want_tail = spiral_epilogue_ref(want0, want1, x, *tail)
    torch.cuda.synchronize()
    _assert_close_to_ref(o0, want0)
    _assert_close_to_ref(o1, want1)
    _assert_close_to_ref(got_tail, want_tail)
    assert torch.equal(got_tail, again)


def test_mamba2_block_routes_agree(cuda):
    """The Mamba-2 Spiral block: two composable mixers, dual kernel E, and
    ``fuse_block`` (kernel E in prologue mode + kernel G), one parameter set."""
    spec = build_scan_spec("spiral", 14, 3)
    block = _random_(SpiralMambaBlock(HIDDEN, spec, use_mamba2=True), 3).to(cuda).eval()
    x, c, w = _block_inputs(cuda, 196, 4, 2)
    e0, g0 = ssd_mixer_fused_cuda.launches, spiral_epilogue_cuda.launches
    with torch.no_grad():
        block.scan_impl = "auto"
        want = block(x, c, w)
        assert (ssd_mixer_fused_cuda.launches, spiral_epilogue_cuda.launches) == (e0, g0)
        block.scan_impl = "fused"
        dual = block(x, c, w)
        assert (ssd_mixer_fused_cuda.launches, spiral_epilogue_cuda.launches) == (e0 + 1, g0)
        block.fuse_block = True
        whole = block(x, c, w)
        assert (ssd_mixer_fused_cuda.launches, spiral_epilogue_cuda.launches) == (e0 + 2, g0 + 1)
        shift, scale, gate = block.adaLN_modulation(c).chunk(3, dim=-1)
        an, fc1, _, fc2 = block.attention_network
        args = (spec, x, w, shift, scale, gate, block.norm1.weight, block.norm1.bias, an.weight,
                an.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias, block.mamba1.weights(),
                block.mamba2.weights())
        ref = spiral_block_ref(*args)
        by_impl = spiral_block_fused(*args, impl="ref")
    torch.cuda.synchronize()
    assert (ssd_mixer_fused_cuda.launches, spiral_epilogue_cuda.launches) == (e0 + 2, g0 + 1)
    for got in (dual, whole, ref, by_impl):
        _assert_close_to_ref(got, want)


def test_fused_ssd_counts_calls(cuda):
    spec = build_scan_spec("spiral", 5, 0)
    m0, m1 = _mixers2(cuda, spec, seed=0)
    x = _x(cuda, 25, 0)
    before = ssd_mixer_fused_cuda.launches
    with torch.no_grad():
        mamba2_dual_mixer_fused(spec, x, x, m0.weights(), m1.weights())
        assert ssd_mixer_fused_cuda.launches == before + 1
        mamba2_mixer_fused(spec, x, m0.weights())
        assert ssd_mixer_fused_cuda.launches == before + 2
        mamba2_mixer_fused(spec, x, m0.weights(), impl="ref")
        m0(x)  # scan_impl "auto": the composable path
        assert ssd_mixer_fused_cuda.launches == before + 2
        m0.scan_impl = "fused"
        m0(x)
    assert ssd_mixer_fused_cuda.launches == before + 3


def test_fused_ssd_carries_gradients(cuda):
    """On CUDA tensors that need a gradient the fused entry points return a
    tensor with a ``grad_fn`` (kernel E in residual mode forward, kernel F
    backward), and the gradients are the composable route's; when nothing
    requires grad, plain kernel E runs and nothing is kept."""
    spec = build_scan_spec("spiral", 5, 0)
    block = _random_(SpiralMambaBlock(HIDDEN, spec, use_mamba2=True, scan_impl="fused"), 1).to(cuda)
    x, c, w = _block_inputs(cuda, 25, 2, 1)
    g = _x(cuda, 25, 3)
    e0, f0 = ssd_mixer_fused_cuda.launches, ssd_mixer_fused_bwd_cuda.launches
    grads = {}
    for route, fuse in (("dual", False), ("fuse_block", True)):
        block.fuse_block = fuse
        block.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        out = block(xi, c, w)  # the parameters require grad
        assert out.grad_fn is not None
        out.backward(g)
        grads[route] = {"x": xi.grad, **{k: p.grad for k, p in block.named_parameters()}}
    # dual: 1 E + 1 F; fuse_block: E (prologue) forward, E (residual) + F backward
    assert ssd_mixer_fused_cuda.launches == e0 + 3
    assert ssd_mixer_fused_bwd_cuda.launches == f0 + 2
    out = block.mamba1(x)
    assert out.grad_fn is not None and ssd_mixer_fused_cuda.launches == e0 + 4
    out = mamba2_mixer_fused(spec, x.clone().requires_grad_(), block.mamba1.weights())
    assert out.grad_fn is not None
    block.requires_grad_(False)
    assert block(x, c, w).grad_fn is None  # nothing requires grad: plain kernel E
    assert ssd_mixer_fused_bwd_cuda.launches == f0 + 2
    block.requires_grad_(True)
    block.fuse_block, block.scan_impl = False, "auto"
    block.mamba1.scan_impl = block.mamba2.scan_impl = "auto"
    block.zero_grad(set_to_none=True)
    xi = x.clone().requires_grad_()
    block(xi, c, w).backward(g)
    want = {"x": xi.grad, **{k: p.grad for k, p in block.named_parameters()}}
    for route, got in grads.items():
        for name, ref in want.items():
            assert got[name] is not None, f"{route}: {name} got no gradient through the kernels"
            _assert_grad_close(got[name], ref, f"{route} {name}")


def _assert_clip_sides_agree(xs, ws, zx, dt_limit):
    """Every step's dt = softplus(p + dt_bias), p its dt column of in_proj, on
    the same side of each limit whether p is kernel E's (``zx``, the residual
    kernel F reads) or the plain version's. The clip's gradient jumps from 1
    to 0 at a limit, and the two in_proj's (3xTF32 and cuBLAS's fp32) differ
    by about 1e-6, so a step that near a limit is clipped for one and not for
    the other, and its head's dt_bias gradient differs by the step's whole
    term: the comparison does not hold there. (At this case's shapes 4 of 300
    draws of the weights had such a step, each within 1.4e-6 of a limit; none
    of the other 296 came within 0.14 of the bar.)"""
    inside = lambda v: (v >= dt_limit[0]) & (v <= dt_limit[1])  # noqa: E731
    for m, (x, w) in enumerate(zip(xs, ws)):
        H = w.dt_bias.shape[0]
        if x.dtype == torch.bfloat16:  # bf16 operands, fp32 sums, zx rounded
            plain = torch.nn.functional.linear(x.float(), w.in_w.to(x.dtype).float())
            plain = plain.to(x.dtype).float()[..., -H:].reshape(-1, H)
        else:
            plain = torch.nn.functional.linear(x, w.in_w)[..., -H:].reshape(-1, H)
        sp_plain = torch.nn.functional.softplus(plain + w.dt_bias)
        sp_kernel = torch.nn.functional.softplus(zx[m][:, -H:] + w.dt_bias)
        differ = int((inside(sp_plain) != inside(sp_kernel)).sum().item())
        assert differ == 0, f"{differ} steps of mixer {m} lie on the two sides of a clip limit"


def _ssd_bwd_ref64(spec, x, g, w, dt_limit):
    """``ssd_mixer_bwd_ref`` on fp64 copies of its inputs. Its autograd sums
    the gathers' adjoints with atomics, in no fixed order, so in fp32 its
    gradients change from call to call in their last bits; in fp64 those
    changes lie far below fp32's rounding, and the reference is nearer the
    exact gradients than either fp32 version."""
    return ssd_mixer_bwd_ref(spec, x.double(), g.double(),
                             Mamba2Weights(*(t.double() for t in w)), dt_limit)


def _ssd_grads(gx, gw, m):
    return {f"gx{m}": gx, **{f"w{m}.{f}": t for f, t in zip(Mamba2Weights._fields, gw)}}


@pytest.mark.parametrize(
    "family,grid_n,layer,batch,dt_limit,wide",
    [("spiral", 14, 0, 2, NO_LIMIT, False), ("spiral", 14, 3, 1, NO_LIMIT, False),
     ("spiral", 5, 1, 2, NO_LIMIT, False), ("spiral", 14, 2, 1, (0.5, 0.9), False),
     ("spiral", 14, 1, 1, NO_LIMIT, True), ("zig", 14, 2, 1, NO_LIMIT, False),
     ("vmamba", 14, 0, 1, NO_LIMIT, False), ("vim", 14, 0, 2, NO_LIMIT, False)],
)
def test_fused_ssd_bwd_matches_plain(cuda, family, grid_n, layer, batch, dt_limit, wide):
    """Kernel F, dual and single, against ``ssd_mixer_bwd_ref`` in fp64: 196
    and 25 tokens, 1 to 4 streams (Mamba-2's vim spec among them: two streams merged
    the standard way), a dt_limit that clips some steps and not others,
    and a wide decay span; twice in a row with the same bits; and kernel E's
    residual mode gives plain kernel E's outputs."""
    spec = build_scan_spec(family, grid_n, layer)
    mixers = _mixers2(cuda, spec, seed=layer, wide=wide)
    ws = [m.weights() for m in mixers]
    L = grid_n * grid_n
    xs = [_x(cuda, L, 60 + i, batch) for i in range(2)]
    gs = [_x(cuda, L, 70 + i, batch) for i in range(2)]
    if dt_limit != NO_LIMIT:
        sp = torch.nn.functional.softplus(
            torch.nn.functional.linear(xs[0], ws[0].in_w)[..., -16:] + ws[0].dt_bias)
        inside = ((sp >= dt_limit[0]) & (sp <= dt_limit[1])).float().mean().item()
        assert 0.05 < inside < 0.95, inside
    with torch.no_grad():
        plain = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit)
        outs, zx = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit, want_res=True)
        _, zx1 = ssd_mixer_fused_cuda(spec, xs[1:], ws[1:], dt_limit, want_res=True)
    if dt_limit != NO_LIMIT:
        _assert_clip_sides_agree(xs, ws, zx, dt_limit)
    for a, b in zip(outs, plain):
        assert torch.equal(a, b)
    want = {}
    for m in range(2):
        want.update(_ssd_grads(*_ssd_bwd_ref64(spec, xs[m], gs[m], ws[m], dt_limit), m))
    for M, res in ((2, zx), (1, zx1)):
        first = None
        for _ in range(2):
            gxs, gws = ssd_mixer_fused_bwd_cuda(spec, xs[2 - M:], gs[2 - M:], ws[2 - M:], res,
                                                dt_limit)
            torch.cuda.synchronize()
            got = {}
            for m in range(M):
                got.update(_ssd_grads(gxs[m], gws[m], m + 2 - M))
            for name, a in got.items():
                _assert_grad_close(a, want[name], f"M={M} {name}")
            if first is not None:
                for name, a in got.items():
                    assert torch.equal(a, first[name]), f"M={M} {name} differs between two calls"
            first = got


def test_fused_ssd_autograd_matches_plain_autograd(cuda):
    """``FusedSsdFn`` under ``torch.autograd.grad``: one call of E (residual
    mode) and one of F; a missing output gradient counts as zeros."""
    spec = build_scan_spec("spiral", 14, 3)
    m0, m1 = _mixers2(cuda, spec, seed=5)
    x0, x1, g = _x(cuda, 196, 80, 2), _x(cuda, 196, 81, 2), _x(cuda, 196, 82, 2)
    leaves = [x0.clone().requires_grad_(), x1.clone().requires_grad_(),
              *m0.parameters(), *m1.parameters()]
    e0, f0 = ssd_mixer_fused_cuda.launches, ssd_mixer_fused_bwd_cuda.launches
    o0, o1 = mamba2_dual_mixer_fused(spec, leaves[0], leaves[1], m0.weights(), m1.weights())
    got = torch.autograd.grad(o0, leaves, g, allow_unused=True)  # o1's gradient is None
    assert (ssd_mixer_fused_cuda.launches, ssd_mixer_fused_bwd_cuda.launches) == (e0 + 1, f0 + 1)
    r0, r1 = mamba2_dual_mixer_fused(spec, leaves[0], leaves[1], m0.weights(), m1.weights(),
                                     impl="ref")
    want = torch.autograd.grad(r0, leaves, g, allow_unused=True)
    assert (ssd_mixer_fused_cuda.launches, ssd_mixer_fused_bwd_cuda.launches) == (e0 + 1, f0 + 1)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:  # branch 1 did not reach o0
            assert a is None or a.abs().max().item() == 0.0, i
        else:
            _assert_grad_close(a, b, f"leaf {i}")


def test_fused_ssd_bwd_rejects_what_it_does_not_take(cuda):
    spec = build_scan_spec("spiral", 5, 0)
    (m,) = _mixers2(cuda, spec, seed=0, count=1)
    w, x = m.weights(), _x(cuda, 25, 0)
    with torch.no_grad():
        _, zx = ssd_mixer_fused_cuda(spec, (x,), (w,), want_res=True)
    before = ssd_mixer_fused_bwd_cuda.launches
    with pytest.raises(ValueError, match="g0 must have shape"):
        ssd_mixer_fused_bwd_cuda(spec, (x,), (x[:, :24].contiguous(),), (w,), zx)
    with pytest.raises(ValueError, match="g0 must be float32"):
        ssd_mixer_fused_bwd_cuda(spec, (x,), (x.double(),), (w,), zx)
    with pytest.raises(ValueError, match="g0 is on cpu"):
        ssd_mixer_fused_bwd_cuda(spec, (x,), (x.cpu(),), (w,), zx)
    with pytest.raises(ValueError, match="g0 must be contiguous"):
        ssd_mixer_fused_bwd_cuda(spec, (x,), (torch.zeros(1, 25, 2 * HIDDEN, device=cuda)[..., ::2],),
                                 (w,), zx)
    with pytest.raises(ValueError, match="residual must have shape"):
        ssd_mixer_fused_bwd_cuda(spec, (x,), (x,), (w,), zx[:, :-1])
    with pytest.raises(ValueError, match="output gradients"):
        ssd_mixer_fused_bwd_cuda(spec, (x,), (x, x), (w,), zx)
    with pytest.raises(ValueError, match="inputs for"):
        ssd_mixer_fused_bwd_cuda(spec, (x, x), (x,), (w,), zx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_mixer_fused_bwd_cuda(spec, (x.cpu(),), (x,), (w,), zx)
    with pytest.raises(ValueError, match="headdim"):
        ssd_mixer_fused_bwd_cuda(spec, (x,), (x,), (w._replace(A_log=w.A_log[:8].contiguous()),), zx)
    with pytest.raises(ValueError, match="no residual"):
        ssd_mixer_fused_cuda(spec, (x,), (w, w), prologue=Prologue(x, x, x, x, x), want_res=True)
    assert ssd_mixer_fused_bwd_cuda.launches == before


def test_fused_ssd_rejects_what_it_does_not_take(cuda):
    spec = build_scan_spec("spiral", 5, 0)
    (m,) = _mixers2(cuda, spec, seed=0, count=1)
    w, x = m.weights(), _x(cuda, 25, 0)
    with pytest.raises(ValueError, match="float32"):
        ssd_mixer_fused_cuda(spec, (x.double(),), (w,))
    with pytest.raises(ValueError, match="tokens"):
        ssd_mixer_fused_cuda(spec, (x[:, :24].contiguous(),), (w,))
    with pytest.raises(ValueError, match="is on cpu"):
        ssd_mixer_fused_cuda(spec, (x,), (w._replace(D=w.D.cpu()),))
    with pytest.raises(ValueError, match="contiguous"):
        ssd_mixer_fused_cuda(spec, (x,), (w._replace(in_w=w.in_w.t().contiguous().t()),))
    with pytest.raises(ValueError, match="shape"):
        ssd_mixer_fused_cuda(spec, (x,), (w._replace(norm_w=w.norm_w[:-1]),))
    with pytest.raises(ValueError, match="headdim"):
        ssd_mixer_fused_cuda(spec, (x,), (w._replace(A_log=w.A_log[:8].contiguous()),))
    with pytest.raises(ValueError, match="d_state"):
        ssd_mixer_fused_cuda(spec, (x,), (w._replace(conv_w=w.conv_w[:-16].contiguous()),))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_mixer_fused_cuda(spec, (x.cpu(),), (w,))
    with pytest.raises(ValueError, match="inputs for"):
        ssd_mixer_fused_cuda(spec, (x, x), (w,))
    with pytest.raises(ValueError, match="both branches"):
        ssd_mixer_fused_cuda(spec, (x,), (w,), prologue=Prologue(x, x, x, x, x))
    x16 = _x(cuda, 16, 0)
    with pytest.raises(NotImplementedError, match="partition"):  # not in prologue mode
        ssd_mixer_fused_cuda(build_scan_spec("eff", 4, 0), (x16,), (w, w),
                             prologue=Prologue(x16, x16, x16, x16, x16))
    o = _x(cuda, 25, 1)
    gate = torch.zeros(1, HIDDEN, device=cuda)
    an = torch.ones(2 * HIDDEN, device=cuda)
    fc1_w, fc1_b = torch.zeros(HIDDEN, 2 * HIDDEN, device=cuda), torch.zeros(HIDDEN, device=cuda)
    fc2_w, fc2_b = torch.zeros(1, HIDDEN, device=cuda), torch.zeros(1, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        spiral_epilogue_cuda(o, o[:, :24], x, gate, an, an, fc1_w, fc1_b, fc2_w, fc2_b)
    with pytest.raises(ValueError, match="float32"):
        spiral_epilogue_cuda(o, o, x, gate, an.double(), an, fc1_w, fc1_b, fc2_w, fc2_b)
    with pytest.raises(ValueError, match="gate"):
        spiral_epilogue_cuda(o, o, x, gate[:, :-1], an, an, fc1_w, fc1_b, fc2_w, fc2_b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        spiral_epilogue_cuda(o, o, x.cpu(), gate, an, an, fc1_w, fc1_b, fc2_w, fc2_b)


def _random_spec(L, streams, seed):
    """``streams`` random permutations of L tokens, merged the standard way."""
    rng = np.random.default_rng(seed)
    fwd = np.stack([rng.permutation(L) for _ in range(streams)]).astype(np.int32)
    return ScanSpec(fwd=fwd, merge=_build_merge_table(fwd, L), scale=1.0)


@pytest.mark.parametrize(
    "family,L,batch,backward",
    [("spiral", 256, 2, True), ("random", 300, 1, True), ("spiral", 1024, 1, False),
     ("eff", 1024, 1, True)],
)
def test_fused_ssd_long_streams_match_plain(cuda, family, L, batch, backward):
    """Streams past the caps that a whole stream per block in shared memory
    set (227 steps for F, about 440 for E): kernels E (dual and single) and F
    on the spiral spec at 256 tokens, three random permutations of 300, E at
    1024, and the EfficientVMamba partition of 1024 tokens into 4 streams of
    256 steps; each within its bar, F twice with the same bits."""
    if family == "random":
        spec = _random_spec(L, 3, seed=L)
    else:
        spec = build_scan_spec(family, math.isqrt(L), 0)
    mixers = _mixers2(cuda, spec, seed=L)
    ws = [m.weights() for m in mixers]
    xs = [_x(cuda, L, 60 + i, batch) for i in range(2)]
    with torch.no_grad():
        outs, zx = ssd_mixer_fused_cuda(spec, xs, ws, want_res=True)
        single = mamba2_mixer_fused(spec, xs[1], ws[1])
        want = [ssd_mixer_ref(spec, x, w) for x, w in zip(xs, ws)]
    torch.cuda.synchronize()
    for g, w in zip((*outs, single), (*want, want[1])):
        _assert_close_to_ref(g, w)
    if not backward:
        return
    gs = [_x(cuda, L, 70 + i, batch) for i in range(2)]
    ref = {}
    for m in range(2):
        ref.update(_ssd_grads(*ssd_mixer_bwd_ref(spec, xs[m], gs[m], ws[m]), m))
    first = None
    for _ in range(2):
        gxs, gws = ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, zx)
        torch.cuda.synchronize()
        got = {**_ssd_grads(gxs[0], gws[0], 0), **_ssd_grads(gxs[1], gws[1], 1)}
        for name, a in got.items():
            _assert_grad_close(a, ref[name], name)
            assert first is None or torch.equal(a, first[name]), f"{name} differs between two calls"
        first = got


# ---- kernel C's vim and partition branches, kernel E's partition, kernel H


@pytest.mark.parametrize(
    "family,grid_n,layer,batch",
    [("vim", 14, 0, 1), ("vim", 14, 0, 8), ("vim", 5, 0, 2), ("eff", 14, 0, 1),
     ("eff", 14, 0, 8), ("eff", 6, 0, 2), ("zig", 14, 3, 8), ("vmamba", 14, 0, 8)],
)
def test_fused_mixer_families_match_plain(cuda, family, grid_n, layer, batch):
    """Kernel C's one-mixer form on every single-mixer family's spec: the vim
    quirk (out_proj per stream, the reverse stream's features flipped), the
    EfficientVMamba partition (4 streams of L / 4 steps), one stream (zig)
    and four (vmamba)."""
    spec = build_scan_spec(family, grid_n, layer)
    (m,) = _mixers(cuda, spec, seed=11 + layer, count=1)
    x = _x(cuda, grid_n * grid_n, 13, batch)
    before = mixer_fused_cuda.launches
    with torch.no_grad():
        got = mamba_mixer_fused(spec, x, m.weights())
        m.scan_impl = "fused"
        by_module = m(x)
        want = mixer_ref(spec, x, m.weights())
    torch.cuda.synchronize()
    assert mixer_fused_cuda.launches == before + 2
    _assert_close_to_ref(got, want)
    assert torch.equal(got, by_module)


def test_vim_quirk_flips_features_not_tokens(cuda):
    """The quirk's output is what its definition says, from two one-stream
    calls of kernel C: 0.5 * (mixer(x) + flip_features(mixer(x reversed))),
    the second left in reversed token order."""
    spec = build_scan_spec("vim", 14, 0)
    (m,) = _mixers(cuda, spec, seed=3, count=1)
    w, x = m.weights(), _x(cuda, 196, 2)
    plain = ScanSpec(fwd=spec.fwd, merge=spec.merge, scale=spec.scale)  # the standard merge
    one = ScanSpec(fwd=spec.fwd[:1], merge=spec.merge[:, :1], scale=1.0)  # the tokens in order
    with torch.no_grad():
        got = mamba_mixer_fused(spec, x, w)
        streams = [mamba_mixer_fused(one, xi, w) for xi in (x, x.flip(1))]
        standard = mamba_mixer_fused(plain, x, w)
    want = 0.5 * (streams[0] + streams[1].flip(-1))
    _assert_close_to_ref(got, want)
    assert (got - standard).abs().max().item() > 1e-2  # the quirk is not the standard merge


@pytest.mark.parametrize("family,mamba2", [("vim", False), ("eff", False), ("eff", True)])
def test_fused_routes_train_vim_and_partition(cuda, family, mamba2):
    """The fused route carries the gradients of the vim and partition specs:
    one kernel C and one kernel D call (kernels E and F for Mamba-2) per
    forward and backward, none of kernels A and B, and every gradient is the
    plain route's."""
    spec = build_scan_spec(family, 14, 0)
    (m,) = (_mixers2 if mamba2 else _mixers)(cuda, spec, seed=0, count=1)
    g = _x(cuda, 196, 1, 2)
    fwd, bwd = ((ssd_mixer_fused_cuda, ssd_mixer_fused_bwd_cuda) if mamba2
                else (mixer_fused_cuda, mixer_fused_bwd_cuda))
    grads = {}
    for impl in ("fused", "ref"):
        m.train().zero_grad()
        m.scan_impl = impl
        x = _x(cuda, 196, 0, 2).requires_grad_()
        counts = (fwd.launches, bwd.launches, selective_scan_cuda.launches,
                  selective_scan_bwd_cuda.launches)
        m(x).backward(g)
        step = (fwd.launches, bwd.launches, selective_scan_cuda.launches,
                selective_scan_bwd_cuda.launches)
        assert [b - a for a, b in zip(counts, step)] == ([1, 1, 0, 0] if impl == "fused"
                                                         else [0, 0, 0, 0])
        grads[impl] = {"x": x.grad, **{k: p.grad for k, p in m.named_parameters()}}
    for name, want in grads["ref"].items():
        _assert_grad_close(grads["fused"][name], want, name)


@pytest.mark.parametrize("grid_n,batch,dt_limit",
                         [(14, 8, NO_LIMIT), (10, 2, NO_LIMIT), (4, 2, (0.5, 0.9))])
def test_fused_ssd_bwd_partition_matches_plain(cuda, grid_n, batch, dt_limit):
    """Kernel F's partition branch, dual and single, against
    ``ssd_mixer_bwd_ref`` in fp64: 4 streams of 49, 25 and 4 steps, every gradient
    tensor, twice in a row with the same bits."""
    spec = build_scan_spec("eff", grid_n, 0)
    mixers = _mixers2(cuda, spec, seed=grid_n + 50)
    ws = [m.weights() for m in mixers]
    L = grid_n * grid_n
    xs = [_x(cuda, L, 90 + i, batch) for i in range(2)]
    gs = [_x(cuda, L, 95 + i, batch) for i in range(2)]
    with torch.no_grad():
        _, zx = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit, want_res=True)
        _, zx1 = ssd_mixer_fused_cuda(spec, xs[1:], ws[1:], dt_limit, want_res=True)
    if dt_limit != NO_LIMIT:
        _assert_clip_sides_agree(xs, ws, zx, dt_limit)
    want = {}
    for m in range(2):
        want.update(_ssd_grads(*_ssd_bwd_ref64(spec, xs[m], gs[m], ws[m], dt_limit), m))
    for M, res in ((2, zx), (1, zx1)):
        first = None
        for _ in range(2):
            gxs, gws = ssd_mixer_fused_bwd_cuda(spec, xs[2 - M:], gs[2 - M:], ws[2 - M:], res,
                                                dt_limit)
            torch.cuda.synchronize()
            got = {}
            for m in range(M):
                got.update(_ssd_grads(gxs[m], gws[m], m + 2 - M))
            for name, a in got.items():
                _assert_grad_close(a, want[name], f"M={M} {name}")
                assert first is None or torch.equal(a, first[name]), name
            first = got


@pytest.mark.parametrize("G,L,M,wide,off_one", [
    (48, 196, 2, False, False), (6, 196, 2, False, False), (4, 25, 1, False, False),
    (6, 196, 2, True, False), (6, 196, 2, False, True), (4, 197, 2, False, False),
    (2, 1, 1, False, False)])
def test_ssd_core_matches_plain(cuda, G, L, M, wide, off_one):
    """Kernel P against ``ssd_core_ref`` on G gathered streams of L steps,
    M weight sets (sequence g takes set g // (G / M)): 1 to 197 steps (one
    chunk, ragged chunks), a wide decay span, and D and norm_w drawn off one
    per set as ``chip_smoke.py`` phase 2m draws them; two calls, equal bits."""
    spec = build_scan_spec("spiral", 14, 3)
    ws = [m.weights() for m in _mixers2(cuda, spec, seed=G + L, count=M, wide=wide)]
    if off_one:
        gen = torch.Generator().manual_seed(80)
        ws = [w._replace(D=(1.0 + 0.5 * torch.randn(w.D.shape, generator=gen)).to(cuda),
                         norm_w=(1.0 + 0.5 * torch.randn(w.norm_w.shape, generator=gen)).to(cuda))
              for w in ws]
    gen = torch.Generator().manual_seed(G)
    x = torch.randn(G, L, HIDDEN, generator=gen).to(cuda)
    per = G // M
    with torch.no_grad():
        zx = torch.cat([torch.nn.functional.linear(x[m * per:(m + 1) * per], w.in_w)
                        for m, w in enumerate(ws)])
        before = ssd_core_cuda.launches
        got = ssd_core_cuda(zx, ws)
        again = ssd_core_cuda(zx, ws)
        want = ssd_core_ref(zx, ws)
    torch.cuda.synchronize()
    assert ssd_core_cuda.launches == before + 2
    _assert_close_to_ref(got, want)
    assert torch.equal(got, again)
    if wide:
        H = ws[0].A_log.numel()
        dt = torch.nn.functional.softplus(zx[:per, :, -H:] + ws[0].dt_bias)
        assert (dt.sum(1) * torch.exp(ws[0].A_log)).max().item() > 1000
    with pytest.raises(ValueError, match="multiple"):
        ssd_core_cuda(zx[:G - 1], ws[:1] * 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_core_cuda(zx.cpu(), ws)


@pytest.mark.parametrize("grid_n,batch,dt_limit",
                         [(14, 1, NO_LIMIT), (14, 8, NO_LIMIT), (4, 2, NO_LIMIT),
                          (14, 2, (0.01, 0.05))])
def test_fused_ssd_partition_matches_plain(cuda, grid_n, batch, dt_limit):
    """Kernel E on EfficientVMamba's partition (4 streams of L / 4 steps),
    one mixer and two, against ``ssd_mixer_ref``."""
    spec = build_scan_spec("eff", grid_n, 0)
    m0, m1 = _mixers2(cuda, spec, seed=grid_n)
    L = grid_n * grid_n
    x0, x1 = _x(cuda, L, 44, batch), _x(cuda, L, 45, batch)
    with torch.no_grad():
        got = mamba2_dual_mixer_fused(spec, x0, x1, m0.weights(), m1.weights(), dt_limit)
        single = mamba2_mixer_fused(spec, x1, m1.weights(), dt_limit)
        want = [ssd_mixer_ref(spec, x, m.weights(), dt_limit) for x, m in ((x0, m0), (x1, m1))]
    torch.cuda.synchronize()
    for g, w in zip((*got, single), (*want, want[1])):
        _assert_close_to_ref(g, w)


def _inner_inputs(device, G, L, seed, dt_bias=0.0):
    """xz and one mixer's inner weights at DiffMa's width, off their init."""
    spec = build_scan_spec("zig", 2, 0)
    m = _random_(Mamba(HIDDEN, spec), seed)
    with torch.no_grad():
        m.dt_proj.bias.add_(dt_bias)
    m = m.to(device)
    w = m.weights()
    gen = torch.Generator().manual_seed(seed + 1)
    xz = torch.randn(G, L, 4 * HIDDEN, generator=gen).to(device)
    return (xz, w.conv_w[:, 0, :].detach(), w.conv_b.detach(), w.xp_w.detach(), w.dt_w.detach(),
            w.dt_b.detach(), -torch.exp(w.A_log.detach()), w.D.detach())


@pytest.mark.parametrize("G,L,dt_bias", [(3, 196, 0.0), (24, 196, 0.0), (2, 25, -2.0),
                                         (5, 13, 2.0), (1, 1, 0.0), (2, 130, 0.0)])
def test_mamba_inner_matches_plain(cuda, G, L, dt_bias):
    """Kernel H against ``mamba_inner_ref``: the B/2 streams at batch 1 and 8,
    ragged lengths, one step, more than one staging chunk, dt_bias near -2
    and +2."""
    args = _inner_inputs(cuda, G, L, seed=G + L, dt_bias=dt_bias)
    before = mamba_inner_fused_cuda.launches
    got = mamba_inner_fused(*args)
    want = mamba_inner_ref(*args)
    torch.cuda.synchronize()
    assert mamba_inner_fused_cuda.launches == before + 1
    assert mamba_inner_fused(*args, impl="ref").shape == want.shape
    assert mamba_inner_fused_cuda.launches == before + 1
    _assert_close_to_ref(got, want)


@pytest.mark.parametrize("G,L", [(3, 50), (24, 196)])
def test_mamba_inner_gradients_match_plain_autograd(cuda, G, L):
    """``MambaInnerFn``: forward through kernel H, backward by recomputing
    through the composable operators (kernels A and B); against autograd over
    the plain version, also at the composable training path's shapes (G = 24
    streams of 196 steps, d = 1024)."""
    args = _inner_inputs(cuda, G, L, seed=9)
    g = torch.randn(G, L, 2 * HIDDEN, generator=torch.Generator().manual_seed(1)).to(cuda)
    leaves = [t.clone().requires_grad_() for t in args]
    refs = [t.clone().requires_grad_() for t in args]
    calls = (mamba_inner_fused_cuda.launches, selective_scan_cuda.launches,
             selective_scan_bwd_cuda.launches)
    out = mamba_inner_fused(*leaves)
    assert out.grad_fn is not None
    out.backward(g)
    assert (mamba_inner_fused_cuda.launches, selective_scan_cuda.launches,
            selective_scan_bwd_cuda.launches) == tuple(c + 1 for c in calls)
    mamba_inner_ref(*refs).backward(g)
    for name, a, b in zip("xz conv_w conv_b xp_w dt_w dt_b A D".split(), leaves, refs):
        _assert_grad_close(a.grad, b.grad, name)


def _doubled_atrous(grid_n):
    """A spec kernel C cannot run: the four atrous streams and their reverses
    (every token twice, in streams of L / 4 steps)."""
    eff = build_scan_spec("eff", grid_n, 0)
    fwd = torch.from_numpy(eff.fwd)
    fwd = torch.cat([fwd, fwd.flip(1)]).numpy()
    return ScanSpec(fwd=fwd, merge=_build_merge_table(fwd, grid_n * grid_n), scale=0.5)


@pytest.mark.parametrize("grid_n,batch", [(14, 1), (14, 8), (6, 2)])
def test_mamba_route_through_kernel_h(cuda, grid_n, batch):
    """``Mamba(scan_impl="fused")`` on a spec that is neither full-length nor
    an exact partition: gather, in_proj, kernel H, merge, out_proj, and no
    call of kernel C; values and gradients against the plain route."""
    spec = _doubled_atrous(grid_n)
    (m,) = _mixers(cuda, spec, seed=2, count=1)
    m.train()
    x = _x(cuda, grid_n * grid_n, 3, batch)
    g = _x(cuda, grid_n * grid_n, 4, batch)
    grads = {}
    for impl in ("fused", "ref"):
        m.scan_impl = impl
        m.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        h0, c0 = mamba_inner_fused_cuda.launches, mixer_fused_cuda.launches
        out = m(xi)
        assert (mamba_inner_fused_cuda.launches, mixer_fused_cuda.launches) == (
            h0 + (impl == "fused"), c0)
        out.backward(g)
        grads[impl] = {"out": out.detach(), "x": xi.grad,
                       **{k: p.grad for k, p in m.named_parameters()}}
    _assert_close_to_ref(grads["fused"].pop("out"), grads["ref"].pop("out"))
    for name, want in grads["ref"].items():
        _assert_grad_close(grads["fused"][name], want, name)


def test_mamba_inner_rejects_what_it_does_not_take(cuda):
    args = _inner_inputs(cuda, 2, 9, seed=0)
    names = "xz conv_w conv_b xp_w dt_w dt_b A D".split()

    def call(**kw):
        return mamba_inner_fused_cuda(*(kw.get(n, a) for n, a in zip(names, args)))

    before = mamba_inner_fused_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(xz=args[0].cpu())
    with pytest.raises(ValueError, match="float32"):
        call(D=args[7].double())
    with pytest.raises(ValueError, match="is on cpu"):
        call(dt_b=args[5].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        call(xp_w=args[3].t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        call(dt_w=args[4][:-1])
    with pytest.raises(ValueError, match="d_state"):
        call(A=args[6][:, :8].contiguous())
    with pytest.raises(ValueError, match=r"\(G, L, 2d\)"):
        call(xz=args[0][0])
    assert mamba_inner_fused_cuda.launches == before


# ---- kernels H and P in bf16: against their bf16 plain versions at their
# own bars (max |err| <= 2^-6 max(1, max |ref|), two bf16 ulps of the
# largest, and mean-rel <= 1e-5: a product that skips one of the TPU
# kernel's rounds moves the output 2e-5 to 4e-4 mean-rel), two calls in
# equal bits; gradients through MambaInnerFn at 1e-2 mean-rel.
HP_BF16, HP_BF16_MEAN = 2.0**-6, 1e-5


@pytest.mark.parametrize("G,L", [(8, 49), (24, 196), (2, 25), (1, 1)])
def test_mamba_inner_bf16_matches_plain(cuda, G, L):
    """Kernel H's bf16 variant against ``mamba_inner_plain`` at bf16 (the
    TPU kernel's rounding), counted as a bf16 launch; its gradients through
    ``MambaInnerFn`` (kernels A and B in bf16) against autograd over
    ``mamba_inner_ref``."""
    xz, *weights = _inner_inputs(cuda, G, L, seed=G + L)
    args = (xz.to(torch.bfloat16), *weights)
    launches = (mamba_inner_fused_cuda.launches, mamba_inner_fused_cuda.bf16.launches)
    with torch.no_grad():
        got, again = (mamba_inner_fused_cuda(*args) for _ in range(2))
        want = mamba_inner_plain(*args)
    torch.cuda.synchronize()
    assert (mamba_inner_fused_cuda.launches, mamba_inner_fused_cuda.bf16.launches) == (
        launches[0], launches[1] + 2)
    assert got.dtype == want.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= HP_BF16 * max(
        1.0, want.float().abs().max().item())
    assert _mean_rel(got, want) <= HP_BF16_MEAN
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)).to(cuda, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in args]
    refs = [t.clone().requires_grad_() for t in args]
    mamba_inner_fused(*leaves).backward(g)
    mamba_inner_ref(*refs).backward(g)
    for name, a, b in zip("xz conv_w conv_b xp_w dt_w dt_b A D".split(), leaves, refs):
        assert a.grad.dtype == b.grad.dtype and torch.isfinite(a.grad.float()).all(), name
        # mean-rel, written so that a gradient that is 0 on both sides (A's at
        # one step, where no earlier state decays) passes
        err = (a.grad.float() - b.grad.float()).abs().mean().item()
        assert err <= 1e-2 * b.grad.float().abs().mean().item(), name


def test_mamba_bf16_route_through_kernel_h(cuda):
    """``Mamba(dtype=bfloat16, scan_impl="fused")`` on a spec kernel C cannot
    run: kernel H's bf16 variant and no kernel C; the output against the
    plain route's at 1e-2 mean-rel, every gradient too."""
    spec = _doubled_atrous(14)
    (m,) = _mixers(cuda, spec, seed=2, count=1)
    m.dtype = torch.bfloat16
    x, g = _x(cuda, 196, 3, 8), _x(cuda, 196, 4, 8).to(torch.bfloat16)
    grads = {}
    for impl in ("fused", "ref"):
        m.scan_impl = impl
        m.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        h0, c0 = mamba_inner_fused_cuda.bf16.launches, mixer_fused_cuda.bf16.launches
        out = m(xi)
        assert out.dtype == torch.bfloat16
        assert (mamba_inner_fused_cuda.bf16.launches, mixer_fused_cuda.bf16.launches) == (
            h0 + (impl == "fused"), c0)
        out.backward(g)
        grads[impl] = {"out": out.detach(), "x": xi.grad,
                       **{k: p.grad for k, p in m.named_parameters()}}
    for name, want in grads["ref"].items():
        assert _mean_rel(grads["fused"][name], want) <= 1e-2, name


@pytest.mark.parametrize("G,L,M", [(48, 196, 2), (4, 25, 1), (6, 197, 2)])
def test_ssd_core_bf16_matches_plain(cuda, G, L, M):
    """Kernel P's bf16 variant against ``ssd_core_ref`` at bf16 (the TPU
    kernel's quadratic form, rounded as it rounds), counted as a bf16
    launch."""
    spec = build_scan_spec("spiral", 14, 3)
    ws = [m.weights() for m in _mixers2(cuda, spec, seed=G + L, count=M)]
    x = torch.randn(G, L, HIDDEN, generator=torch.Generator().manual_seed(G)).to(cuda)
    per = G // M
    with torch.no_grad():
        zx = torch.cat([torch.nn.functional.linear(x[m * per:(m + 1) * per], w.in_w)
                        for m, w in enumerate(ws)]).to(torch.bfloat16)
        launches = (ssd_core_cuda.launches, ssd_core_cuda.bf16.launches)
        got, again = (ssd_core_cuda(zx, ws) for _ in range(2))
        want = ssd_core_ref(zx, ws)
    torch.cuda.synchronize()
    assert (ssd_core_cuda.launches, ssd_core_cuda.bf16.launches) == (launches[0],
                                                                      launches[1] + 2)
    assert got.dtype == want.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= HP_BF16 * max(
        1.0, want.float().abs().max().item())
    assert _mean_rel(got, want) <= HP_BF16_MEAN


# ---- kernels E, F and G in bf16 (the bf16 Mamba-2 model)

# (family, grid, layer, batch, dt_limit): the Spiral block's dual call at the
# sampler's and the trainer's batch, 25 tokens, a dt_limit that clips some
# steps and not others, EfficientVMamba's partition, zig and vim (one mixer).
# Every stream of 196 tokens is longer than the kernels' 64-step chunk.
SSD_BF16_CASES = [("spiral", 14, 0, 1, NO_LIMIT), ("spiral", 14, 0, 8, NO_LIMIT),
                  ("spiral", 5, 1, 2, NO_LIMIT), ("spiral", 14, 2, 1, (0.5, 0.9)),
                  ("eff", 14, 1, 1, NO_LIMIT), ("eff", 10, 1, 2, NO_LIMIT),
                  ("zig", 14, 2, 1, NO_LIMIT), ("vim", 14, 0, 2, NO_LIMIT)]


def _ssd_bf16_case(device, family, grid_n, layer, batch):
    """Both branches for the Spiral block, one mixer otherwise; x and g bf16."""
    spec = build_scan_spec(family, grid_n, layer)
    mixers = _mixers2(device, spec, seed=layer, count=2 if family == "spiral" else 1)
    L = grid_n * grid_n
    xs = [_x(device, L, 80 + i, batch).to(torch.bfloat16) for i in range(len(mixers))]
    gs = [_x(device, L, 90 + i, batch).to(torch.bfloat16) for i in range(len(mixers))]
    return spec, [m.weights() for m in mixers], xs, gs


def _assert_bf16_close(got, want, what):
    """max |err| <= 2e-2 max(1, max |ref|) and mean-rel <= 5e-3."""
    assert got.dtype == want.dtype == torch.bfloat16, what
    assert got.shape == want.shape and torch.isfinite(got.float()).all(), what
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * max(1.0, want.float().abs().max().item()), (what, err)
    assert _mean_rel(got, want) <= 5e-3, (what, _mean_rel(got, want))


@pytest.mark.parametrize("family,grid_n,layer,batch,dt_limit", SSD_BF16_CASES)
def test_fused_ssd_bf16_matches_plain(cuda, family, grid_n, layer, batch, dt_limit):
    """Kernel E's bf16 variant against its bf16 plain version (kernel E's
    rounding, ``mamba2_mixer_fused(impl="ref")``), the same bits on a second
    call and in residual mode, whose zx holds bf16 values; counted as bf16
    launches."""
    spec, ws, xs, _ = _ssd_bf16_case(cuda, family, grid_n, layer, batch)
    launches = (ssd_mixer_fused_cuda.launches, ssd_mixer_fused_cuda.bf16.launches)
    with torch.no_grad():
        got, again = (ssd_mixer_fused_cuda(spec, xs, ws, dt_limit) for _ in range(2))
        res, zx = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit, want_res=True)
        want = [mamba2_mixer_fused(spec, x, w, dt_limit, impl="ref") for x, w in zip(xs, ws)]
    torch.cuda.synchronize()
    assert (ssd_mixer_fused_cuda.launches, ssd_mixer_fused_cuda.bf16.launches) == (
        launches[0], launches[1] + 3)
    assert zx.dtype == torch.float32 and torch.equal(zx, zx.to(torch.bfloat16).float())
    if dt_limit != NO_LIMIT:
        _assert_clip_sides_agree(xs, ws, zx, dt_limit)
    for m, (g, a, r, w) in enumerate(zip(got, again, res, want)):
        assert torch.equal(g, a) and torch.equal(g, r), m
        _assert_bf16_close(g, w, f"E bf16 mixer {m}")


@pytest.mark.parametrize("family,grid_n,layer,batch,dt_limit", SSD_BF16_CASES)
def test_fused_ssd_bwd_bf16_matches_plain(cuda, family, grid_n, layer, batch, dt_limit):
    """Kernel F's bf16 variant against autograd over kernel E's bf16 plain
    version, every gradient within mean-rel 1e-2, gx bf16 and the weights'
    gradients fp32, the same bits on a second call."""
    spec, ws, xs, gs = _ssd_bf16_case(cuda, family, grid_n, layer, batch)
    with torch.no_grad():
        _, zx = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit, want_res=True)
    if dt_limit != NO_LIMIT:
        _assert_clip_sides_agree(xs, ws, zx, dt_limit)
    before = ssd_mixer_fused_bwd_cuda.bf16.launches
    got, again = (ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, zx, dt_limit) for _ in range(2))
    torch.cuda.synchronize()
    assert ssd_mixer_fused_bwd_cuda.bf16.launches == before + 2
    for m in range(len(xs)):
        gx_ref, gw_ref = ssd_mixer_bwd_ref(spec, xs[m], gs[m], ws[m], dt_limit)
        pairs = [("gx", got[0][m], again[0][m], gx_ref)]
        pairs += list(zip(gw_ref._fields, got[1][m], again[1][m], gw_ref))
        for name, a, b, ref in pairs:
            assert a.dtype == (torch.bfloat16 if name == "gx" else torch.float32), name
            assert torch.equal(a, b), name
            assert _mean_rel(a, ref) <= 1e-2, (m, name, _mean_rel(a, ref))


@pytest.mark.parametrize("grid_n,layer,batch", [(14, 3, 1), (14, 0, 2), (5, 1, 2), (14, 1, 8)])
def test_fused_ssd_prologue_and_epilogue_bf16_match_plain(cuda, grid_n, layer, batch):
    """Kernel E's prologue mode and kernel G in bf16, each against its bf16
    plain version, fed by a bf16 block's own adaLN chunks; each twice, with
    equal bits; counted as bf16 launches."""
    bf16 = torch.bfloat16
    spec = build_scan_spec("spiral", grid_n, layer)
    block = _random_(SpiralMambaBlock(HIDDEN, spec, use_mamba2=True, dtype=bf16), 8 + layer)
    block = block.to(cuda).eval()
    x, c, w = (t.to(bf16) for t in _block_inputs(cuda, grid_n * grid_n, 9 + layer, batch))
    an, fc1, _, fc2 = block.attention_network
    launches = (ssd_mixer_fused_cuda.bf16.launches, spiral_epilogue_cuda.bf16.launches)
    with torch.no_grad():
        mod = torch.nn.functional.linear(torch.nn.functional.silu(c),
                                         block.adaLN_modulation[1].weight.to(bf16),
                                         block.adaLN_modulation[1].bias.to(bf16))
        shift, scale, gate = mod.chunk(3, dim=-1)
        pro = Prologue(w, block.norm1.weight, block.norm1.bias, shift, scale)
        ws = (block.mamba1.weights(), block.mamba2.weights())
        (o0, o1), (a0, a1) = (ssd_mixer_fused_cuda(spec, (x,), ws, prologue=pro)
                              for _ in range(2))
        xm = torch.nn.functional.layer_norm(x.float(), (HIDDEN,), pro.ln_w, pro.ln_b, 1e-5)
        xm = xm * (1 + scale.float()[:, None]) + shift.float()[:, None]
        want0 = mamba2_mixer_fused(spec, xm.to(bf16), ws[0], impl="ref")
        want1 = mamba2_mixer_fused(spec, (xm * w.float()).to(bf16), ws[1], impl="ref")
        tail = (gate, an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)
        got_tail, again = (spiral_epilogue_cuda(want0, want1, x, *tail) for _ in range(2))
        want_tail = spiral_epilogue_ref(want0, want1, x, *tail)
    torch.cuda.synchronize()
    assert (ssd_mixer_fused_cuda.bf16.launches, spiral_epilogue_cuda.bf16.launches) == (
        launches[0] + 2, launches[1] + 2)
    assert torch.equal(o0, a0) and torch.equal(o1, a1) and torch.equal(got_tail, again)
    _assert_bf16_close(o0, want0, "E bf16 prologue, branch 0")
    _assert_bf16_close(o1, want1, "E bf16 prologue, branch 1")
    _assert_bf16_close(got_tail, want_tail, "G bf16")


def test_mamba2_bf16_block_routes_run_the_bf16_kernels(cuda):
    """A bf16 Mamba-2 Spiral block on the dual route (E bf16; with a
    gradient, E and F bf16) and on ``fuse_block`` (E bf16 in prologue mode and
    G bf16; its backward E and F bf16): finite bf16 outputs that agree, bf16
    gx and fp32 parameter gradients; no fp32 kernel runs."""
    bf16 = torch.bfloat16
    spec = build_scan_spec("spiral", 14, 3)
    block = _random_(SpiralMambaBlock(HIDDEN, spec, use_mamba2=True, scan_impl="fused",
                                      dtype=bf16), 3).to(cuda)
    x, c, w = (t.to(bf16) for t in _block_inputs(cuda, 196, 4, 2))
    names = ("ssd_mixer_fwd", "ssd_mixer_bwd", "spiral_epilogue")
    wrappers = (ssd_mixer_fused_cuda, ssd_mixer_fused_bwd_cuda, spiral_epilogue_cuda)

    def counts():
        return {n: (f.launches, f.bf16.launches) for n, f in zip(names, wrappers)}

    start = counts()
    outs = {}
    for fuse in (False, True):
        block.fuse_block = fuse
        with torch.no_grad():
            outs[fuse] = block(x, c, w)
        xi = x.clone().requires_grad_()
        block(xi, c, w).float().sum().backward()
        assert xi.grad.dtype == bf16 and all(p.grad.dtype == torch.float32
                                             for p in block.parameters())
        block.zero_grad(set_to_none=True)
    end = counts()
    # dual: 1 E, then 1 E + 1 F; fuse_block: 1 E + 1 G, then E + G forward, E + F backward
    assert {n: (end[n][0] - start[n][0], end[n][1] - start[n][1]) for n in names} == {
        "ssd_mixer_fwd": (0, 5), "ssd_mixer_bwd": (0, 2), "spiral_epilogue": (0, 2)}
    for got in outs.values():
        assert got.dtype == bf16 and torch.isfinite(got.float()).all()
    # the two routes round in other places (the dual route's prologue in bf16)
    assert _mean_rel(outs[True], outs[False]) <= 2e-2


def test_fused_ssd_bf16_takes_fp32_weights_only(cuda):
    """bf16 x with a bf16 weight raises, as does a bf16 g against fp32 x and
    a bf16 epilogue input beside fp32 ones."""
    spec, ws, xs, gs = _ssd_bf16_case(cuda, "spiral", 5, 0, 1)
    w = ws[0]._replace(in_w=ws[0].in_w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32"):
        ssd_mixer_fused_cuda(spec, xs[:1], (w,))
    with torch.no_grad():
        _, zx = ssd_mixer_fused_cuda(spec, xs[:1], ws[:1], want_res=True)
    with pytest.raises(ValueError, match="float32"):
        ssd_mixer_fused_bwd_cuda(spec, xs[:1], gs[:1], (w,), zx)
    with pytest.raises(ValueError, match="bfloat16"):
        ssd_mixer_fused_bwd_cuda(spec, (xs[0].float(),), gs[:1], ws[:1], zx)
    o = xs[0]
    h = o.shape[-1]
    tail = (torch.ones(2 * h, device=cuda), torch.zeros(2 * h, device=cuda),
            torch.zeros(h, 2 * h, device=cuda), torch.zeros(h, device=cuda),
            torch.zeros(1, h, device=cuda), torch.zeros(1, device=cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        spiral_epilogue_cuda(o, o.float(), o, o[:, 0], *tail)
