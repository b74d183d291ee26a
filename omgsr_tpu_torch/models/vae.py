"""AutoencoderKL (SD2.1: 4-channel latent, scaling 0.18215), functional.

Parameter-tree key paths mirror the HF safetensors layout
(encoder.down_blocks.0.resnets.0.conv1 ...). All tensors NHWC. GroupNorm eps
is 1e-6 throughout the VAE (diffusers default for AutoencoderKL blocks).
With ``cfg.fused_resblocks`` every eligible resnet of the encoder, the mid
blocks and the decoder runs as ``ops/conv3x3.fused_resblock`` (two launches of
the fused GN+SiLU -> conv3x3 kernel); the others, and every resnet without
the flag, run ``_resnet``. With ``cfg.remat_blocks`` (training under gradient
checkpointing) each resnet runs under ``torch.utils.checkpoint``: its
internals are recomputed in the backward instead of held.

GroupNorm seam of the tiled VAE (``inference/tiled_vae.py``): every function
below takes ``gn_hook``. When it is given, every GroupNorm of the network
calls ``gn_hook(params, x, groups)`` instead of computing its own statistics,
which either records the statistics (the collect pass) or applies statistics
handed in from outside (the per-tile pass); the JAX package keeps the hook in
a module global. With a hook every resnet runs plain: the fused kernel takes
no statistics from outside. Without one nothing changes.

Band seam of the spatially sharded VAE (``tiled_vae.sharded_vae_*``): with a
``band`` each rank holds a band of rows of every activation, and the band
object does what needs the neighbours' rows or every band: each 3x3 conv
(``band.conv3x3``, with one halo row from each neighbour), the stride-2
downsample (``band.downsample``), every GroupNorm+SiLU
(``band.group_norm_silu``, whose statistics are summed over the bands), and
the mid block's attention input (``band.gather``: its norm, keys and values
over every band's rows, its queries of this band's, ``band.own_tokens``).
Every resnet then runs plain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from omgsr_tpu_torch.models.configs import VAEConfig
from omgsr_tpu_torch.models.layers import (
    conv2d,
    dense,
    group_norm,
    group_norm_silu,
    nearest_upsample_2x,
    silu,
    upsample_conv_2x,
)
from omgsr_tpu_torch.ops.attention import dot_product_attention
from omgsr_tpu_torch.ops.conv3x3 import fused_resblock, fused_resblock_eligible

_EPS = 1e-6


def _vae_group_norm(p, x, groups, gn_hook=None):
    if gn_hook is not None:
        return gn_hook(p, x, groups)
    return group_norm(p, x, groups, _EPS)


def _vae_group_norm_silu(p, x, groups, gn_hook=None, band=None):
    """GroupNorm+SiLU (the K3 kernels on the card) when no hook is given."""
    if band is not None:
        return band.group_norm_silu(p, x, groups, _EPS)
    if gn_hook is not None:
        return silu(gn_hook(p, x, groups))
    return group_norm_silu(p, x, groups, _EPS)


def _conv3x3(p, x, band=None):
    """A 3x3 SAME conv, across the band's edges under a band."""
    return band.conv3x3(p, x) if band is not None else conv2d(p, x, padding=1)


def _resnet(p, x, groups, gn_hook=None, band=None):
    h = _vae_group_norm_silu(p["norm1"], x, groups, gn_hook, band)
    h = _conv3x3(p["conv1"], h, band)
    h = _vae_group_norm_silu(p["norm2"], h, groups, gn_hook, band)
    h = _conv3x3(p["conv2"], h, band)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _mid_attention(p, x, groups, gn_hook=None, band=None):
    b, hh, ww, c = x.shape
    # under a band the norm, the keys and the values take every band's rows, the queries this band's
    full = band.gather(x) if band is not None else x
    h = _vae_group_norm(p["group_norm"], full, groups, gn_hook)
    h = h.reshape(b, -1, c)
    # single-head attention over spatial tokens (diffusers VAE mid block)
    q = dense(p["to_q"], band.own_tokens(h) if band is not None else h)[:, :, None, :]
    k = dense(p["to_k"], h)[:, :, None, :]
    v = dense(p["to_v"], h)[:, :, None, :]
    o = dot_product_attention(q, k, v)[:, :, 0, :]
    o = dense(p["to_out"]["0"], o)
    return x + o.reshape(b, hh, ww, c)


def _mid_block(p, x, groups, cfg: VAEConfig, gn_hook=None, band=None):
    res = _select_resnet(cfg, gn_hook, band)
    x = res(p["resnets"]["0"], x, groups)
    if "attentions" in p:
        x = _mid_attention(p["attentions"]["0"], x, groups, gn_hook, band)
    return res(p["resnets"]["1"], x, groups)


def _fused_or_plain_resnet(p, x, groups):
    if fused_resblock_eligible(p, x, groups):
        return fused_resblock(p, x, groups, _EPS)
    return _resnet(p, x, groups)


def _select_resnet(cfg: VAEConfig, gn_hook=None, band=None):
    """Resnet executor for the given config: per-resnet recompute (training),
    the fused kernels per eligible shape (inference), or the plain block; with
    a GroupNorm hook always the plain block, through the hook, and with a
    band the plain block across the bands."""
    if band is not None:
        return lambda p, x, groups: _resnet(p, x, groups, None, band)
    if cfg.remat_blocks:
        return lambda p, x, groups: checkpoint(_resnet, p, x, groups, gn_hook, use_reentrant=False)
    if gn_hook is not None:
        return lambda p, x, groups: _resnet(p, x, groups, gn_hook)
    return _fused_or_plain_resnet if cfg.fused_resblocks else _resnet


def vae_encode_features(params, cfg: VAEConfig, x, gn_hook=None, band=None):
    """pixels (B,H,W,3) in [-1,1] -> moments (B,h,w,2*latent)."""
    p = params["encoder"]
    g = cfg.norm_num_groups
    h = _conv3x3(p["conv_in"], x, band)
    res = _select_resnet(cfg, gn_hook, band)
    for i in range(len(cfg.block_out_channels)):
        blk = p["down_blocks"][str(i)]
        for j in range(cfg.layers_per_block):
            h = res(blk["resnets"][str(j)], h, g)
        if "downsamplers" in blk:
            conv = blk["downsamplers"]["0"]["conv"]
            h = band.downsample(conv, h) if band is not None else downsample_conv_2x(conv, h)
    h = _mid_block(p["mid_block"], h, g, cfg, gn_hook, band)
    h = _vae_group_norm_silu(p["conv_norm_out"], h, g, gn_hook, band)
    h = _conv3x3(p["conv_out"], h, band)
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


def vae_decode(params, cfg: VAEConfig, z, unscale: bool = True, gn_hook=None, band=None):
    """scaled latent -> pixels in [-1,1] (un-clamped; callers clamp)."""
    if unscale:
        z = unscale_latent(cfg, z)
    if "post_quant_conv" in params:
        z = conv2d(params["post_quant_conv"], z, padding=0)
    p = params["decoder"]
    g = cfg.norm_num_groups
    h = _conv3x3(p["conv_in"], z, band)
    res = _select_resnet(cfg, gn_hook, band)
    h = _mid_block(p["mid_block"], h, g, cfg, gn_hook, band)
    for i in range(len(cfg.block_out_channels)):
        blk = p["up_blocks"][str(i)]
        for j in range(cfg.layers_per_block + 1):
            h = res(blk["resnets"][str(j)], h, g)
        if "upsamplers" in blk:
            conv = blk["upsamplers"]["0"]["conv"]
            h = band.conv3x3(conv, nearest_upsample_2x(h)) if band is not None else upsample_conv_2x(conv, h)
    h = _vae_group_norm_silu(p["conv_norm_out"], h, g, gn_hook, band)
    return _conv3x3(p["conv_out"], h, band)
