"""DINOv3-ConvNeXt DISTS perceptual loss.

Re-implements dinov3_gan/dinov3_convnext_dists.py: features are the RGB
image (in [0,1]) plus the first three ConvNeXt stages' maps passed through a
Hanning-window L2 pooling (filter 5 -> 3x3 window after endpoint trim,
stride 1, :7-29); the DISTS score combines per-channel mean similarity
(structure) and covariance similarity (texture) with uniform weights
1/(2*sum(channels)) and returns 1 - (dist1 + dist2), meaned (:86-108).

The ConvNeXt backbone is frozen: its parameters do not require grad, and
callers never differentiate w.r.t. them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from omgsr_tpu_torch.models.convnext import convnext_features, normalize_from_pm1


def _hanning_kernel():
    a = np.hanning(5)[1:-1]  # 3 taps
    g = np.outer(a, a)
    return (g / g.sum()).astype(np.float32)


_L2POOL_KERNEL = _hanning_kernel()


def depthwise_filter(x, kernel2d, stride: int, pad: int):
    """x NHWC filtered per channel with one (kh, kw) kernel, zero padding."""
    c = x.shape[-1]
    k = torch.as_tensor(kernel2d, dtype=x.dtype, device=x.device)
    k = k[None, None].expand(c, 1, *k.shape)
    y = F.conv2d(x.permute(0, 3, 1, 2), k, stride=stride, padding=pad, groups=c)
    return y.permute(0, 2, 3, 1)


def l2_pool(x, stride: int = 1):
    """sqrt(conv(x^2, hanning_3x3) + 1e-12), depthwise, pad 1, in f32."""
    y = depthwise_filter(x.float() ** 2, _L2POOL_KERNEL, stride, 1)
    return torch.sqrt(y + 1e-12).to(x.dtype)


def init_dists(convnext_params, chns):
    """Bundle frozen backbone params with the channel list [3, c1, c2, c3]."""
    return {"backbone": convnext_params, "channels": [3] + list(chns[:3])}


def _features(backbone_params, x):
    """x in [-1,1] NHWC -> [x01, l2pool(stage1), l2pool(stage2), l2pool(stage3)]."""
    x01 = x * 0.5 + 0.5
    h = normalize_from_pm1(x)
    feats = convnext_features(backbone_params, h, num_stages=3)
    return [x01] + [l2_pool(f) for f in feats]


def dists_loss(dists_state, x, y):
    """Scalar DISTS distance between images x, y in [-1,1] NHWC."""
    backbone = dists_state["backbone"]
    channels = dists_state["channels"]
    w = 1.0 / (2.0 * sum(channels))
    feats0 = _features(backbone, x)
    feats1 = _features(backbone, y)
    c1 = c2 = 1e-6
    dist1 = 0.0
    dist2 = 0.0
    for f0, f1 in zip(feats0, feats1):
        f0 = f0.float()
        f1 = f1.float()
        x_mean = f0.mean(dim=(1, 2), keepdim=True)
        y_mean = f1.mean(dim=(1, 2), keepdim=True)
        s1 = (2 * x_mean * y_mean + c1) / (x_mean**2 + y_mean**2 + c1)
        dist1 = dist1 + (w * s1).sum(dim=3)

        x_var = ((f0 - x_mean) ** 2).mean(dim=(1, 2), keepdim=True)
        y_var = ((f1 - y_mean) ** 2).mean(dim=(1, 2), keepdim=True)
        xy_cov = (f0 * f1).mean(dim=(1, 2), keepdim=True) - x_mean * y_mean
        s2 = (2 * xy_cov + c2) / (x_var + y_var + c2)
        dist2 = dist2 + (w * s2).sum(dim=3)

    score = 1.0 - (dist1 + dist2)
    return score.mean()
