"""Image resizing with torch F.interpolate semantics.

The Real-ESRGAN degradation resizes with randomly chosen 'area' / 'bilinear'
/ 'bicubic' modes (dataset/realesrgan.py:225-226, :256-258, :281-295), as
``F.interpolate(size=..., align_corners=False, antialias=False)``:

  * bilinear: src = (dst + 0.5) * in/out - 0.5, borders clamped;
  * bicubic: cubic convolution with a = -0.75, indices clamped;
  * area: adaptive average pooling.

The JAX package rebuilt these as two matrix products with host-made weights;
here they are the PyTorch functions they were rebuilt from. Images are NHWC.
"""

from __future__ import annotations

import torch.nn.functional as F


def resize(img, out_h: int, out_w: int, mode: str = "bilinear"):
    """img (B, H, W, C) -> (B, out_h, out_w, C), computed in f32."""
    x = img.float().permute(0, 3, 1, 2)
    if mode == "area":
        y = F.adaptive_avg_pool2d(x, (out_h, out_w))
    elif mode in ("bilinear", "bicubic"):
        y = F.interpolate(x, size=(out_h, out_w), mode=mode, align_corners=False, antialias=False)
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    return y.permute(0, 2, 3, 1).to(img.dtype)


def resize_by_scale(img, scale: float, mode: str = "bilinear", snap: int = 1):
    """F.interpolate(scale_factor=...) parity: out = floor(in * scale),
    optionally snapped to a multiple of ``snap``."""
    _, h, w, _ = img.shape
    oh = int(h * scale)
    ow = int(w * scale)
    if snap > 1:
        oh = max(snap, round(oh / snap) * snap)
        ow = max(snap, round(ow / snap) * snap)
    return resize(img, oh, ow, mode)
