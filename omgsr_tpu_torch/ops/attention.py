"""Attention dispatch. All model attention in the port funnels through
``dot_product_attention``; shapes are (B, S, H, D).

Every bias-free site whose head dim the flash-attention kernel takes goes to
that kernel, whatever the sequence length or dtype: on the card the wrapper
launches the kernel or raises (a dtype it does not take raises there). Every
other site (a bias is present; the VAE mid block's single 512-wide head) is
computed as an explicit matmul -> softmax(f32) -> matmul, which is what the
JAX package leaves to XLA at those sites.
"""

from __future__ import annotations

import math

import torch

from omgsr_tpu_torch.ops import flash_attention as FA


def matmul_attention(q, k, v, *, bias=None, scale: float | None = None):
    """Explicit softmax attention; bias (B, H, Sq, Sk) is added to the scores.

    The scores are the f32 accumulation of the products, scaled, biased and
    soft-maxed in f32, as ``jax.nn.dot_product_attention`` computes them: q
    and k are widened before the product (a bf16 product is exact in f32), so
    no score is rounded to the input type on its way to the softmax."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    wide = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(qh.to(wide), kh.to(wide).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, vh).permute(0, 2, 1, 3)


def dot_product_attention(q, k, v, *, bias=None, scale: float | None = None):
    """Softmax attention over (B, S, H, D) tensors; bias (B, H, Sq, Sk)."""
    if bias is None and q.shape[-1] in FA.SUPPORTED_HEAD_DIMS:
        return FA.flash_attention(q, k, v, scale)
    return matmul_attention(q, k, v, bias=bias, scale=scale)
