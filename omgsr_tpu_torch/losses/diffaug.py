"""DiffAugment (color / translation / cutout) with explicit random draws.

Re-implements dinov3_gan/dinov3_convnext_disc.py:11-78 on NHWC tensors. Same
op order as the reference policy string 'color,translation,cutout':
brightness, saturation, contrast, translation (zero-pad + clamped gather),
cutout (half-size zero mask). The seven random draws of one call are an
argument (``DiffAugDraws``), so a test can hand the same numbers to this
function and to the JAX package's; ``draw_diffaug`` makes them from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class DiffAugDraws(NamedTuple):
    """brightness, saturation, contrast: (B,1,1,1) uniforms in [0,1);
    ty, tx: (B,1,1) integer shifts; oy, ox: (B,1,1) integer cutout centres."""

    brightness: torch.Tensor
    saturation: torch.Tensor
    contrast: torch.Tensor
    ty: torch.Tensor
    tx: torch.Tensor
    oy: torch.Tensor
    ox: torch.Tensor


def _translation_range(h, w, ratio=0.125):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def _cutout_size(h, w, ratio=0.5):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def draw_diffaug(generator: torch.Generator, shape, device, dtype=torch.float32) -> DiffAugDraws:
    """The draws of one ``diff_augment`` call on an image batch of ``shape``
    (B,H,W,C), from ``generator`` (which must live on ``device``)."""
    b, h, w, _ = shape

    def uniform():
        return torch.rand((b, 1, 1, 1), generator=generator, device=device, dtype=torch.float32).to(dtype)

    def integers(lo, hi):
        return torch.randint(lo, hi, (b, 1, 1), generator=generator, device=device)

    sh, sw = _translation_range(h, w)
    ch, cw = _cutout_size(h, w)
    return DiffAugDraws(
        uniform(), uniform(), uniform(),
        integers(-sh, sh + 1), integers(-sw, sw + 1),
        integers(0, h + (1 - ch % 2)), integers(0, w + (1 - cw % 2)),
    )


def _brightness(r, x):
    return x + (r.to(x.dtype) - 0.5)


def _saturation(r, x):
    mean = x.mean(dim=3, keepdim=True)
    return (x - mean) * (r.to(x.dtype) * 2.0) + mean


def _contrast(r, x):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (r.to(x.dtype) + 0.5) + mean


def _translation(ty, tx, x):
    b, h, w, _ = x.shape
    gy = torch.clamp(torch.arange(h, device=x.device)[None, :, None] + ty + 1, 0, h + 1)  # (b,h,1)
    gx = torch.clamp(torch.arange(w, device=x.device)[None, None, :] + tx + 1, 0, w + 1)  # (b,1,w)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    bidx = torch.arange(b, device=x.device)[:, None, None]
    return xp[bidx, gy.expand(b, h, w), gx.expand(b, h, w)]


def _cutout(oy, ox, x):
    b, h, w, _ = x.shape
    ch, cw = _cutout_size(h, w)
    gy = torch.arange(h, device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    in_y = (gy >= oy - ch // 2) & (gy < oy - ch // 2 + ch)
    in_x = (gx >= ox - cw // 2) & (gx < ox - cw // 2 + cw)
    # the cutout window is clipped to the image, so its visible area can
    # shrink at borders (the reference's index clamping)
    mask = 1.0 - (in_y & in_x).to(x.dtype)
    return x * mask[..., None]


def diff_augment(x, draws: DiffAugDraws | None, policy: str = "color,translation,cutout"):
    """Apply the augmentation policy with the given draws; x NHWC. An empty
    policy returns x and needs no draws."""
    if not policy:
        return x
    for p in policy.split(","):
        if p == "color":
            x = _brightness(draws.brightness, x)
            x = _saturation(draws.saturation, x)
            x = _contrast(draws.contrast, x)
        elif p == "translation":
            x = _translation(draws.ty, draws.tx, x)
        elif p == "cutout":
            x = _cutout(draws.oy, draws.ox, x)
        else:
            raise ValueError(f"unknown DiffAugment policy element: {p}")
    return x
