"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere. The file imports
neither JAX nor ``diffma_tpu``, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from diffma_tpu_torch.ops.selective_scan import (
    selective_scan,
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
