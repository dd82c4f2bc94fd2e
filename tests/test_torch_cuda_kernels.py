"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Kernels A and B (the selective scan, forward and backward) and kernels C and
D (the fused Mamba-1 mixer, forward and backward) are held against their
plain versions at the model's widths; kernel C's tolerance is max |err| <=
1e-4 * max(1, max |ref|), since its fp32 sums over K = 1024 run in another
order than cuBLAS's. Gradients, from B, D and the autograd Functions, are
held per tensor to 2e-4 * max(1, max |ref|), the JAX package's gradient bar
(``tests/test_selective_scan.py``).

These tests need an NVIDIA GPU with nvcc and skip elsewhere. The file imports
neither JAX nor ``diffma_tpu``, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import math

import pytest
import torch

from diffma_tpu_torch.models.blocks import SpiralMambaBlock
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.ops.fused_mixer import (
    mamba_dual_mixer_fused,
    mamba_mixer_fused,
    mixer_bwd_ref,
    mixer_fused_bwd_cuda,
    mixer_fused_cuda,
    mixer_ref,
)
from diffma_tpu_torch.ops.scan_orders import build_scan_spec
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
    return torch.device("cuda")


def _inputs(device, G, L, d, n, dtype, delta_dtype=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    u = r(G, L, d).to(device, dtype)
    delta = (0.5 * r(G, L, d) - 1.0).to(device, delta_dtype or dtype)
    A = -torch.exp(0.5 * r(d, n)).to(device)
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


@pytest.mark.parametrize(
    "G,L,dtype,delta_dtype,gated",
    [(3, 196, torch.float32, None, True), (2, 13, torch.float32, None, False),
     (2, 197, torch.float32, None, True), (2, 67, torch.bfloat16, torch.float32, True)],
)
def test_scan_bwd_kernel_matches_plain(cuda, G, L, dtype, delta_dtype, gated):
    u, delta, A, B, C, D, z = _inputs(cuda, G, L, 256, 16, dtype, delta_dtype)
    z = z if gated else None
    g = torch.randn(G, L, 256, generator=torch.Generator().manual_seed(9)).to(cuda, dtype)
    got = selective_scan_bwd_cuda(u, delta, A, B, C, D, z, g)
    want = selective_scan_bwd_ref(u, delta, A, B, C, D, z, g)
    torch.cuda.synchronize()
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz"), got, want):
        if b is None:
            assert a is None
        else:
            _assert_grad_close(a, b, name)


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


def test_fused_backward_rejects_what_is_not_ported(cuda):
    w = _mixers(cuda, build_scan_spec("spiral", 4, 0), seed=0, count=1)[0].weights()
    x = _x(cuda, 16, 0)
    for family, match in (("vim", "vim"), ("eff", "partition")):
        with pytest.raises(NotImplementedError, match=match):
            mixer_fused_bwd_cuda(build_scan_spec(family, 4, 0), (x,), (x,), (w,))
