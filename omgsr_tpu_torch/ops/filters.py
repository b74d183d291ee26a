"""Spatial filtering: filter2D (reflect-pad per-sample kernels) and USM.

Re-implements dataset/degradations.py: filter2D (:772-796) — reflect padding
k//2 then a cross-correlation with a per-sample (B, k, k) kernel applied to
every channel — and USMSharp (:829-848) — Gaussian-blur residual sharpening
with a soft threshold mask. Images are NHWC, as in the JAX package.

The filter is a depthwise ``F.conv2d`` (one group per image and channel) on a
contiguous NCHW f32 tensor. PyTorch runs such a convolution in its own
depthwise CUDA kernel rather than cuDNN's, in f32 whatever
``torch.backends.cudnn.allow_tf32`` says.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from omgsr_tpu_torch.utils.devices import host_to_device


def reflect_pad(x, p: int):
    """x (..., H, W) padded by p on both sides of both axes as
    ``np.pad(mode="reflect")`` pads: mirrored about the end samples,
    repeatedly where p >= the axis (a length-1 axis repeats its sample).
    ``F.pad`` steps of less than the axis each, so nothing waits for the
    device (an index gather on CUDA does)."""
    ph = pw = p
    while ph or pw:
        if x.shape[-2] == 1 or x.shape[-1] == 1:
            rep = (pw if x.shape[-1] == 1 else 0, ph if x.shape[-2] == 1 else 0)
            x = F.pad(x, (rep[0], rep[0], rep[1], rep[1]), mode="replicate")
            pw, ph = pw - rep[0], ph - rep[1]
            continue
        sh, sw = min(ph, x.shape[-2] - 1), min(pw, x.shape[-1] - 1)
        x = F.pad(x, (sw, sw, sh, sh), mode="reflect")
        ph, pw = ph - sh, pw - sw
    return x


def filter2d(img, kernel):
    """img (B, H, W, C), kernel (B, k, k) or (k, k) (one for every image),
    reflect padding.

    A depthwise conv over B*C feature groups, one kernel per image (the
    reference's exact trick, dataset/degradations.py:788-796)."""
    if kernel.ndim == 2:
        kernel = kernel[None]
    b, h, w, c = img.shape
    k = kernel.shape[-1]
    if k % 2 != 1:
        raise ValueError("Wrong kernel size")
    p = k // 2
    x = reflect_pad(img.float().permute(0, 3, 1, 2).contiguous(), p)  # contiguous NCHW: not cuDNN's conv
    weight = kernel.to(device=x.device, dtype=torch.float32).expand(b, k, k).repeat_interleave(c, dim=0)
    out = F.conv2d(x.reshape(1, b * c, h + 2 * p, w + 2 * p), weight[:, None], groups=b * c)  # b-major groups
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).to(img.dtype)


def _gaussian_kernel_1d(size: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel semantics: sigma<=0 -> 0.3*((size-1)*0.5-1)+0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def usm_sharp(img, weight: float = 0.5, radius: int = 50, threshold: float = 10.0, sigma: float = 0.0):
    """Unsharp masking (USMSharp, dataset/degradations.py:829-848)."""
    if radius % 2 == 0:
        radius += 1
    k1 = _gaussian_kernel_1d(radius, sigma)
    kernel = host_to_device(np.outer(k1, k1), img.device)
    blur = filter2d(img, kernel)
    residual = img - blur
    mask = (torch.abs(residual) * 255.0 > threshold).to(img.dtype)
    soft_mask = filter2d(mask, kernel)
    sharp = torch.clamp(img + weight * residual, 0.0, 1.0)
    return soft_mask * sharp + (1 - soft_mask) * img
