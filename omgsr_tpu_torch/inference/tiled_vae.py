"""Tiled VAE for large images on one card, eager PyTorch.

Two single-card strategies, as in the JAX package's ``inference/tiled_vae.py``
(the multi-card spatially sharded mode waits for the distribution slice):

1. ``streaming_vae_encode/decode`` with ``stats="fast"`` (bounded memory): a
   two-pass scheme after vaehook's fast mode. Pass 1 runs the network on a
   downsampled copy and records every GroupNorm's statistics through the
   ``gn_hook`` seam of ``models/vae.py``; pass 2 runs overlap-padded windows
   through the network one after the other, with the recorded statistics
   frozen, and keeps each window's centre (pad 32 px encode, 11 latents
   decode), so the tiles are seamless and every tile is normalised alike.
   With ``stats="auto"`` the exact mode takes over past ``AUTO_EXACT_RATIO``.

2. ``exact_vae_encode/decode`` (also ``streaming_vae_*(..., stats="exact")``):
   exact global GroupNorm statistics, which here is the full-image VAE. The
   JAX package runs this mode as a flat op plan with row-chunk statistics, to
   keep one whole-image graph off the TPU; eager PyTorch already runs op by
   op on full-resolution buffers, the GroupNorm kernels' per-block partial
   sums give every GroupNorm its global statistics, and the mid block's
   single 512-wide head over every latent pixel (65,536 tokens at 2048 px
   output) goes to the flash-attention kernel, which streams it without an
   (S x S) score matrix. Its peak memory is the full-image VAE's, above the
   fast mode's: the fast mode is the bounded-memory one.

Randomness: a sampled encode draws each tile's noise from a generator seeded
from the caller's generator and the tile index (``fold_generator``), so no
two tiles share a draw; the numbers differ from the JAX package's folded keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from omgsr_tpu_torch.models import vae as vae_mod

ENCODER_PAD = 32  # pixels of context per tile side (vaehook.py:546)
DECODER_PAD = 11  # latents of context per tile side

# stats="auto" escalates from fast to exact above this downsample ratio
# (max(h, w) / est_size): the JAX package measured the fast mode's mean error
# at up to ~2% of the output's range below it (its tiled_vae.py:55-72)
AUTO_EXACT_RATIO = 4.0


def fold_generator(generator: torch.Generator, index: int) -> torch.Generator:
    """A generator on ``generator``'s device seeded from its initial seed and
    ``index``: the counterpart of ``jax.random.fold_in``. The parent is not
    advanced, so the draw of tile (or image) ``index`` does not depend on the
    tiles before it."""
    seed = int(np.random.SeedSequence([generator.initial_seed(), index]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=generator.device).manual_seed(seed)


# ----------------------------------------------------------------------------
# GroupNorm statistics: capture and replay
# ----------------------------------------------------------------------------


class _CollectHook:
    """Records every GroupNorm's (mean, var) over its whole input, in order."""

    def __init__(self):
        self.stats = []

    def __call__(self, p, x, groups):
        b, h, w, c = x.shape
        var, mean = torch.var_mean(x.float().reshape(b, h * w, groups, c // groups), dim=(1, 3),
                                   correction=0)
        self.stats.append((mean, var))
        return _apply_gn(p, x, groups, mean, var)


class _ReplayHook:
    """Applies the recorded statistics, one GroupNorm after the other."""

    def __init__(self, stats):
        self.stats = list(stats)
        self.i = 0

    def __call__(self, p, x, groups):
        mean, var = self.stats[self.i]
        self.i += 1
        return _apply_gn(p, x, groups, mean, var)


def _apply_gn(p, x, groups, mean, var, eps=1e-6):
    """GroupNorm of x (B,H,W,C) with the given (B, groups) statistics, f32."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h, w, groups, c // groups)
    xg = (xg - mean[:, None, None, :, None]) * torch.rsqrt(var[:, None, None, :, None] + eps)
    xn = xg.reshape(b, h, w, c)
    return (xn * p["weight"].float() + p["bias"].float()).to(x.dtype)


# ----------------------------------------------------------------------------
# single-card streaming mode
# ----------------------------------------------------------------------------


def _net_encode(params, cfg, x, generator, sample, gn_hook):
    moments = vae_mod.vae_encode_features(params, cfg, x, gn_hook=gn_hook)
    do_sample = sample and generator is not None
    z = vae_mod.sample_diagonal_gaussian(moments, generator=generator, sample=do_sample)
    return vae_mod.scale_latent(cfg, z)


def _nearest_resize(x, out_h, out_w):
    """jax.image.resize(x, ..., "nearest") on NHWC: source index
    floor((i + 0.5) * in / out), computed in f32 as JAX computes it."""

    def index(n_in, n_out):
        f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in) / np.float32(n_out)
        return torch.from_numpy(np.floor(f).astype(np.int64)).to(x.device)

    return x.index_select(1, index(x.shape[1], out_h)).index_select(2, index(x.shape[2], out_w))


def _streamed(params, cfg, x, net, tile: int, pad: int, scale_num: int, scale_den: int, est_size: int):
    """The streaming loop of both stages. ``net(params, cfg, x, gn_hook, idx)`` maps a
    window to its output, shape-preserving up to the factor
    scale_num / scale_den.

    Windows are clamped inside the image (never padded with made-up values),
    so the true image borders keep the conv stack's own zero padding, exactly
    as in full-image execution; interior tile edges get ``pad`` elements of
    real context."""
    b, h, w, c = x.shape
    if b != 1:
        raise ValueError(f"the streaming VAE takes one image at a time, got batch {b}")

    win = tile + 2 * pad
    if h <= win and w <= win:
        # one window covers the input: its own statistics are the global ones
        return net(params, cfg, x, None, None)

    # pass 1: statistics from a downsampled copy. The nearest resize keeps
    # per-pixel value statistics; the downsample still shifts the per-channel
    # moments, so they are renormalised to the full image's and clamped to its
    # range (vaehook.py:723-731)
    est_h = max(min(est_size, h) // 8 * 8, 8)
    est_w = max(min(est_size, w) // 8 * 8, 8)
    small = _nearest_resize(x, est_h, est_w)
    if (est_h, est_w) != (h, w):
        x32, s32 = x.float(), small.float()
        mean_old = x32.mean(dim=(0, 1, 2))
        std_old = x32.std(dim=(0, 1, 2), correction=0)
        mean_new = s32.mean(dim=(0, 1, 2))
        std_new = torch.clamp(s32.std(dim=(0, 1, 2), correction=0), min=1e-6)
        s32 = (s32 - mean_new) / std_new * std_old + mean_old
        small = torch.clamp(s32, x32.min(), x32.max()).to(x.dtype)
        del x32, s32
    collect = _CollectHook()
    net(params, cfg, small, collect, None)
    stats = tuple(collect.stats)

    # encoder windows stay phase-aligned with the stride-2 downsamplers: window
    # starts and tile offsets are multiples of the total downscale factor
    align = scale_den if scale_den > 1 else 1

    def axis_plan(size):
        """Per-axis tiling; an axis that fits one window is spanned whole."""
        if size <= win:
            return [0], [0], size, size
        offs, wstarts = [], []
        for i in range(math.ceil(size / tile)):
            o = min(i * tile, size - tile) // align * align
            offs.append(o)
            wstarts.append(min(max(0, o - pad), size - win) // align * align)
        return offs, wstarts, tile, win

    ys, wys, tile_h, win_h = axis_plan(h)
    xs, wxs, tile_w, win_w = axis_plan(w)
    out_th, out_tw = tile_h * scale_num // scale_den, tile_w * scale_num // scale_den
    out = None
    idx = 0
    for oy, wy in zip(ys, wys):
        for ox, wx in zip(xs, wxs):
            window = x[:, wy : wy + win_h, wx : wx + win_w]
            o = net(params, cfg, window, _ReplayHook(stats), idx)
            cy, cx = (oy - wy) * scale_num // scale_den, (ox - wx) * scale_num // scale_den
            ty, tx = oy * scale_num // scale_den, ox * scale_num // scale_den
            if out is None:
                out = o.new_zeros((1, h * scale_num // scale_den, w * scale_num // scale_den, o.shape[-1]))
            out[:, ty : ty + out_th, tx : tx + out_tw] = o[:, cy : cy + out_th, cx : cx + out_tw]
            idx += 1
    return out


def _resolve_stats(stats: str, size: int, est_size: int) -> str:
    if stats == "auto":
        return "fast" if size / est_size <= AUTO_EXACT_RATIO else "exact"
    if stats not in ("fast", "exact"):
        raise ValueError(f"stats must be 'fast', 'exact' or 'auto', got {stats!r}")
    return stats


def streaming_vae_encode(
    params, cfg, x, generator: torch.Generator | None = None, sample: bool = False, tile: int = 512,
    pad: int = ENCODER_PAD, est_size: int = 512, stats: str = "fast",
):
    """pixels (1,H,W,3) -> scaled latent, in bounded memory in the fast mode.

    stats="fast": GroupNorm statistics estimated from a downsampled copy;
    "exact": exact global statistics, the full-image VAE (``exact_vae_encode``;
    tile/pad/est_size unused); "auto": fast while the downsample ratio stays
    within AUTO_EXACT_RATIO, exact beyond it.

    Samples only when ``sample`` and a ``generator`` are given, else the mean.
    Each tile then draws from ``fold_generator(generator, tile_index)``: not
    the full-image draw, and not one repeated patch."""
    if _resolve_stats(stats, max(x.shape[1], x.shape[2]), est_size) == "exact":
        return exact_vae_encode(params, cfg, x, generator=generator, sample=sample)

    def net(p, c, xx, gn_hook, idx):
        gen = generator if generator is None or idx is None else fold_generator(generator, idx)
        return _net_encode(p, c, xx, gen, sample, gn_hook)

    return _streamed(params, cfg, x, net, tile, pad, 1, cfg.downscale, est_size)


def streaming_vae_decode(
    params, cfg, z, tile: int = 64, pad: int = DECODER_PAD, est_size: int = 64, stats: str = "fast",
):
    """scaled latent (1,h,w,C) -> pixels, in bounded memory in the fast mode. See
    ``streaming_vae_encode`` for ``stats``."""
    if _resolve_stats(stats, max(z.shape[1], z.shape[2]), est_size) == "exact":
        return exact_vae_decode(params, cfg, z)

    def net(p, c, zz, gn_hook, idx):
        return vae_mod.vae_decode(p, c, zz, gn_hook=gn_hook)

    return _streamed(params, cfg, z, net, tile, pad, cfg.downscale, 1, est_size)


# ----------------------------------------------------------------------------
# single-card exact mode
# ----------------------------------------------------------------------------


def exact_vae_encode(params, cfg, x, generator: torch.Generator | None = None, sample: bool = False):
    """pixels (B,H,W,3) -> scaled latent with exact global GroupNorm: the
    full-image VAE. Samples only when ``sample`` and a ``generator`` are
    given, else the mean."""
    return vae_mod.vae_encode(params, cfg, x, generator=generator, sample=sample)


def exact_vae_decode(params, cfg, z, unscale: bool = True):
    """scaled latent (B,h,w,C) -> pixels with exact global GroupNorm: the
    full-image VAE."""
    return vae_mod.vae_decode(params, cfg, z, unscale=unscale)


# ----------------------------------------------------------------------------
# multi-card spatially sharded mode
# ----------------------------------------------------------------------------


def sharded_vae_decode(*args, **kwargs):
    raise NotImplementedError("sharded_vae_decode: the multi-GPU VAE is not ported yet (distribution slice)")


def sharded_vae_encode(*args, **kwargs):
    raise NotImplementedError("sharded_vae_encode: the multi-GPU VAE is not ported yet (distribution slice)")
