"""AutoencoderKL (SD2.1: 4-channel latent, scaling 0.18215), functional.

Parameter-tree key paths mirror the HF safetensors layout
(encoder.down_blocks.0.resnets.0.conv1 ...). All tensors NHWC. GroupNorm eps
is 1e-6 throughout the VAE (diffusers default for AutoencoderKL blocks).
The GroupNorm-statistics hook and the fused-resblock selector of the JAX
package arrive with the tiled-VAE slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from omgsr_tpu_torch.models.configs import VAEConfig
from omgsr_tpu_torch.models.layers import (
    conv2d,
    dense,
    group_norm,
    group_norm_silu,
    upsample_conv_2x,
)
from omgsr_tpu_torch.ops.attention import dot_product_attention

_EPS = 1e-6


def _resnet(p, x, groups):
    h = group_norm_silu(p["norm1"], x, groups, _EPS)
    h = conv2d(p["conv1"], h, padding=1)
    h = group_norm_silu(p["norm2"], h, groups, _EPS)
    h = conv2d(p["conv2"], h, padding=1)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _mid_attention(p, x, groups):
    b, hh, ww, c = x.shape
    h = group_norm(p["group_norm"], x, groups, _EPS)
    h = h.reshape(b, hh * ww, c)
    # single-head attention over spatial tokens (diffusers VAE mid block)
    q = dense(p["to_q"], h)[:, :, None, :]
    k = dense(p["to_k"], h)[:, :, None, :]
    v = dense(p["to_v"], h)[:, :, None, :]
    o = dot_product_attention(q, k, v)[:, :, 0, :]
    o = dense(p["to_out"]["0"], o)
    return x + o.reshape(b, hh, ww, c)


def _mid_block(p, x, groups):
    x = _resnet(p["resnets"]["0"], x, groups)
    if "attentions" in p:
        x = _mid_attention(p["attentions"]["0"], x, groups)
    return _resnet(p["resnets"]["1"], x, groups)


def vae_encode_features(params, cfg: VAEConfig, x):
    """pixels (B,H,W,3) in [-1,1] -> moments (B,h,w,2*latent)."""
    p = params["encoder"]
    g = cfg.norm_num_groups
    h = conv2d(p["conv_in"], x, padding=1)
    for i in range(len(cfg.block_out_channels)):
        blk = p["down_blocks"][str(i)]
        for j in range(cfg.layers_per_block):
            h = _resnet(blk["resnets"][str(j)], h, g)
        if "downsamplers" in blk:
            h = downsample_conv_2x(blk["downsamplers"]["0"]["conv"], h)
    h = _mid_block(p["mid_block"], h, g)
    h = group_norm_silu(p["conv_norm_out"], h, g, _EPS)
    h = conv2d(p["conv_out"], h, padding=1)
    if "quant_conv" in params:
        h = conv2d(params["quant_conv"], h, padding=0)
    return h


def scale_latent(cfg: VAEConfig, z):
    """Raw VAE sample -> scaled latent. SD: z*s; with a shift: (z-shift)*s."""
    if cfg.shift_factor is not None:
        return (z - cfg.shift_factor) * cfg.scaling_factor
    return z * cfg.scaling_factor


def unscale_latent(cfg: VAEConfig, z):
    """Scaled latent -> raw decoder input (inverse of scale_latent)."""
    if cfg.shift_factor is not None:
        return z / cfg.scaling_factor + cfg.shift_factor
    return z / cfg.scaling_factor


def downsample_conv_2x(p, h):
    """diffusers Downsample2D: asymmetric pad (0,1) then stride-2 VALID conv."""
    h = F.pad(h, (0, 0, 0, 1, 0, 1))
    return conv2d(p, h, stride=2, padding="VALID")


def sample_diagonal_gaussian(moments, noise=None, generator=None, sample: bool = True):
    """moments (..., 2C) -> latent sample (..., C); logvar clamped [-30, 20]
    (diffusers DiagonalGaussianDistribution semantics). The standard-normal
    draw is ``noise`` when given, else it comes from ``generator`` (which
    must live on the moments' device)."""
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    if not sample:
        return mean
    if noise is None:
        if generator is None:
            raise ValueError("sampling needs an explicit noise tensor or a torch.Generator")
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=torch.float32)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return mean + std * noise.to(device=mean.device, dtype=mean.dtype)


def vae_encode(params, cfg: VAEConfig, x, noise=None, generator=None, sample: bool = True):
    """pixels -> scaled latent. Samples only when ``sample`` and a noise
    source (``noise`` or ``generator``) are both given; else the mean."""
    moments = vae_encode_features(params, cfg, x)
    do_sample = sample and (noise is not None or generator is not None)
    z = sample_diagonal_gaussian(moments, noise, generator, sample=do_sample)
    return scale_latent(cfg, z)


def vae_decode(params, cfg: VAEConfig, z, unscale: bool = True):
    """scaled latent -> pixels in [-1,1] (un-clamped; callers clamp)."""
    if unscale:
        z = unscale_latent(cfg, z)
    if "post_quant_conv" in params:
        z = conv2d(params["post_quant_conv"], z, padding=0)
    p = params["decoder"]
    g = cfg.norm_num_groups
    h = conv2d(p["conv_in"], z, padding=1)
    h = _mid_block(p["mid_block"], h, g)
    for i in range(len(cfg.block_out_channels)):
        blk = p["up_blocks"][str(i)]
        for j in range(cfg.layers_per_block + 1):
            h = _resnet(blk["resnets"][str(j)], h, g)
        if "upsamplers" in blk:
            h = upsample_conv_2x(blk["upsamplers"]["0"]["conv"], h)
    h = group_norm_silu(p["conv_norm_out"], h, g, _EPS)
    return conv2d(p["conv_out"], h, padding=1)
