"""FLUX latent 2x2 packing/unpacking and RoPE position ids.

FLUX's DiT consumes the 16-channel VAE latent as a token sequence where each
token is a 2x2 spatial patch (64 features). Reference behaviour:
_pack_latents / _unpack_latents / _prepare_latent_image_ids
(train/train_omgsr_f.py:55-94), on NHWC latents: feature index
c*4 + dy*2 + dx, token index (y//2)*(W//2) + (x//2).
"""

from __future__ import annotations

import torch


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """NHWC latent (B, H, W, C) -> packed tokens (B, H//2 * W//2, C*4)."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    # -> (B, H/2, W/2, C, 2, 2)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Packed tokens (B, S, C*4) -> NHWC latent (B, height, width, C);
    ``height``/``width`` are the latent dims (not pixel dims)."""
    b, s, cf = tokens.shape
    c = cf // 4
    x = tokens.reshape(b, height // 2, width // 2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, height, width, c)


def latent_image_ids(height: int, width: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """RoPE position ids of the packed token grid (``height`` x ``width``,
    the latent dims // 2): (H*W, 3) rows of (0, y, x)."""
    ids = torch.zeros((height, width, 3), dtype=torch.float32)
    ids[..., 1] = torch.arange(height, dtype=torch.float32)[:, None]
    ids[..., 2] = torch.arange(width, dtype=torch.float32)[None, :]
    return ids.reshape(height * width, 3).to(device=device, dtype=dtype)
