"""Image quality metrics (PSNR / SSIM) over NHWC batches, in f32.

The reference publishes no eval code; these support quantitative evaluation
of SR outputs against ground truth on the RealSR/DRealSR-style protocols
(``cli/eval_sr.py``), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(a, b, max_val: float = 1.0):
    """Peak signal-to-noise ratio over NHWC images; returns (B,)."""
    mse = (a.float() - b.float()).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val**2 / mse.clamp_min(1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a, b, max_val: float = 1.0, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over NHWC images (per-channel Gaussian-windowed, the
    standard Wang et al. constants, VALID windows); returns (B,)."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    c = a.shape[1]
    kernel = _gaussian_window(window_size, sigma, a.device)[None, None].expand(c, 1, -1, -1)

    def filt(x):  # depthwise, NCHW
        return F.conv2d(x, kernel, groups=c)

    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_aa = filt(a * a) - mu_aa
    sig_bb = filt(b * b) - mu_bb
    sig_ab = filt(a * b) - mu_ab
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / ((mu_aa + mu_bb + c1) * (sig_aa + sig_bb + c2))
    return s.mean(dim=(1, 2, 3))
