"""Image-quality metrics (SSIM / PSNR), numpy only.

A copy of ``diffma_tpu/utils/metrics.py``: the port keeps its own so that it
never imports the JAX package. SSIM follows Wang et al. 2004 with the 11x11
sigma-1.5 Gaussian window and K1 = 0.01, K2 = 0.03, as scikit-image's
``structural_similarity`` does by default.
"""

from __future__ import annotations

import numpy as np

__all__ = ["psnr", "ssim", "quality_report"]


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio in dB.  Default data_range=2 matches the
    [-1, 1] image convention of the pipelines."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return k / k.sum()


def _filter2d_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 2-D 'valid' convolution of (..., H, W) with a 1-D kernel."""
    n = k.size
    # rows
    out = np.zeros(img.shape[:-2] + (img.shape[-2] - n + 1, img.shape[-1]))
    for i in range(n):
        out += k[i] * img[..., i : i + out.shape[-2], :]
    # cols
    out2 = np.zeros(out.shape[:-1] + (out.shape[-1] - n + 1,))
    for i in range(n):
        out2 += k[i] * out[..., i : i + out2.shape[-1]]
    return out2


def ssim(
    a: np.ndarray,
    b: np.ndarray,
    data_range: float = 2.0,
    win_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean structural similarity over (..., H, W) images (channels and batch
    in leading dims are averaged, matching skimage with a Gaussian window)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if min(a.shape[-2:]) < win_size:
        raise ValueError("image smaller than the SSIM window")
    k = _gaussian_kernel(win_size, sigma)
    mu_a = _filter2d_valid(a, k)
    mu_b = _filter2d_valid(b, k)
    saa = _filter2d_valid(a * a, k) - mu_a**2
    sbb = _filter2d_valid(b * b, k) - mu_b**2
    sab = _filter2d_valid(a * b, k) - mu_a * mu_b
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (saa + sbb + c2)
    return float(np.mean(num / den))


def quality_report(
    generated: np.ndarray, reference: np.ndarray, data_range: float = 2.0
) -> dict:
    """PSNR/SSIM of a batch of (N, C, H, W) generated images vs ground truth."""
    return {
        "psnr_db": psnr(generated, reference, data_range),
        "ssim": ssim(generated, reference, data_range),
    }
