"""DINOv3 ConvNeXt backbone (feature extractor for DISTS loss + GAN disc).

Re-implements the capability the reference vendors from facebookresearch/
dinov3 (dinov3/models/convnext.py:116-306; loaded via torch.hub at
dinov3_gan/dinov3_convnext_disc.py:162-166). OMGSR uses only the first three
stages' feature maps (dinov3_gan/dinov3_convnext_dists.py:63-70).

Structure per stage i: downsample (stem 4x4/s4 for i=0, else LN+conv 2x2/s2)
then depth_i ConvNeXt blocks (dwconv 7x7 -> LN -> MLP x4 gelu -> gamma scale
-> residual). NHWC; LN eps 1e-6; exact GELU. Param paths mirror the torch
module tree (downsample_layers.0.0, stages.2.5.dwconv, ...);
convert/params.init_convnext builds a tree from a seed.
``convnext_forward_features`` is the all-stage ``forward_features`` the hub
entries expose, in the ViT's key layout.
"""

from __future__ import annotations

import torch

from omgsr_tpu_torch.models.layers import conv2d, dense, depthwise_conv2d, gelu, layer_norm

_EPS = 1e-6


def _block(p, x):
    h = depthwise_conv2d(p["dwconv"], x, padding=3)
    h = layer_norm(p["norm"], h, _EPS)
    h = dense(p["pwconv1"], h)
    h = gelu(h, approximate=False)
    h = dense(p["pwconv2"], h)
    h = p["gamma"].to(h.dtype) * h
    return x + h


def convnext_features(params, x, num_stages: int = 3):
    """NHWC image (ImageNet-normalized) -> list of per-stage NHWC feature maps.

    Mirrors _get_intermediate_layers(n=3) in the reference
    (dinov3_gan/dinov3_convnext_disc.py:179-185).
    """
    feats = []
    for i in range(num_stages):
        dl = params["downsample_layers"][str(i)]
        if i == 0:
            x = conv2d(dl["0"], x, stride=4, padding="VALID")
            x = layer_norm(dl["1"], x, _EPS)
        else:
            x = layer_norm(dl["0"], x, _EPS)
            x = conv2d(dl["1"], x, stride=2, padding="VALID")
        for j in sorted(params["stages"][str(i)], key=int):
            x = _block(params["stages"][str(i)][j], x)
        feats.append(x)
    return feats


def convnext_forward_features(params, x):
    """forward_features (convnext.py:207-235): all 4 stages, the global
    -average-pooled 'cls' token concatenated ahead of the flattened patch
    tokens, final LayerNorm over everything. Returns the same key layout as
    the ViT so the probes/dinotxt consumers are backbone-agnostic."""
    last = convnext_features(params, x, num_stages=4)[-1]
    b, h, w, c = last.shape
    tokens = torch.cat([last.mean(dim=(1, 2))[:, None], last.reshape(b, h * w, c)], dim=1)
    normed = layer_norm(params["norm"], tokens, _EPS)
    return {
        "x_norm_clstoken": normed[:, 0],
        "x_storage_tokens": normed[:, 1:1],  # no registers (convnext.py:185)
        "x_norm_patchtokens": normed[:, 1:],
        "x_prenorm": tokens,
    }


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_from_pm1(x):
    """[-1,1] NHWC image -> ImageNet-normalized (reference
    dinov3_gan/dinov3_convnext_dists.py:72-74)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x * 0.5 + 0.5 - mean) / std
