"""VAE routing of the one-step pipeline: full-image, streaming tiled
(fast statistics) or exact tiled, with the option checks and the per-image
loop in one place, as in the JAX package's ``inference/vae_routing.py``.

The streaming tiled VAE takes one image at a time (bounded memory is its
point); a batch is run image by image, each image's noise drawn from
``fold_generator(generator, i)`` whatever the batch's size, so that an image's
draw does not depend on how requests were grouped.
"""

from __future__ import annotations

import torch

from omgsr_tpu_torch.inference.tiled_vae import (
    AUTO_EXACT_RATIO,
    exact_vae_decode,
    exact_vae_encode,
    fold_generator,
    streaming_vae_decode,
    streaming_vae_encode,
)
from omgsr_tpu_torch.models import vae as vae_mod


def validate_vae_opts(vae_tile, vae_stats: str, downscale: int) -> None:
    """Raise early on options that would corrupt the output or fail later:
    the streaming grid aligns tile offsets to the VAE's total downscale
    factor, so a tile that is not a multiple of it leaves unwritten bands in
    the latent, and a tile below it makes the latent tile empty."""
    if vae_stats not in ("fast", "exact", "auto"):
        raise ValueError(f"vae_stats must be 'fast', 'exact' or 'auto', got {vae_stats!r}")
    if vae_tile is not None:
        if vae_tile < downscale or vae_tile % downscale != 0:
            raise ValueError(
                f"vae_tile must be a positive multiple of the VAE downscale "
                f"factor ({downscale}), got {vae_tile}"
            )


def _per_image(fn, x, generator):
    """fn(x_i, generator_i) for every image of the batch, concatenated."""
    return torch.cat(
        [fn(x[i : i + 1], None if generator is None else fold_generator(generator, i))
         for i in range(x.shape[0])],
        dim=0,
    )


def routed_vae_encode(params, cfg, x, vae_tile, sample: bool, stats: str = "fast",
                      generator: torch.Generator | None = None, noise=None):
    """Full-image or streaming tiled encode. The tiled route samples from
    ``generator`` per tile (``streaming_vae_encode``) and takes no ``noise``
    tensor."""
    # gate on the largest side (vaehook.py:554): a 1024x8192 image must tile
    if vae_tile and max(x.shape[1], x.shape[2]) > vae_tile:
        if sample and noise is not None:
            raise ValueError("the tiled VAE draws its noise per tile: pass a generator, not a noise tensor")
        return _per_image(
            lambda xi, gi: streaming_vae_encode(
                params, cfg, xi, generator=gi if sample else None, sample=sample,
                tile=vae_tile, est_size=vae_tile, stats="auto" if stats == "auto" else "fast",
            ),
            x, generator,
        )
    return vae_mod.vae_encode(params, cfg, x, noise=noise, generator=generator, sample=sample)


def routed_vae_decode(params, cfg, z, vae_tile, stats: str = "fast"):
    lat_tile = vae_tile // cfg.downscale if vae_tile else 0
    if vae_tile and max(z.shape[1], z.shape[2]) > lat_tile:
        # "exact" reaches this level through exact_one_step; "auto" escalates
        # inside streaming_vae_decode past the measured-accurate ratio
        return _per_image(
            lambda zi, _gi: streaming_vae_decode(
                params, cfg, zi, tile=lat_tile, est_size=lat_tile,
                stats="auto" if stats == "auto" else "fast",
            ),
            z, None,
        )
    return vae_mod.vae_decode(params, cfg, z)


def wants_exact_path(vae_stats: str, vae_tile, lq_img) -> bool:
    """True when the exact mode should run: "exact", or "auto" past the
    measured-accurate fast-stats downsample ratio, on an image the tile does
    not cover."""
    if not (vae_tile and max(lq_img.shape[1], lq_img.shape[2]) > vae_tile):
        return False
    if vae_stats == "exact":
        return True
    if vae_stats == "auto":
        return max(lq_img.shape[1], lq_img.shape[2]) / vae_tile > AUTO_EXACT_RATIO
    return False


def exact_one_step(vae_params, cfg, lq_img, mid_fn, generator: torch.Generator | None, sample: bool):
    """Exact mode: the VAE with exact global GroupNorm statistics (the
    full-image VAE) around the latent mid-section ``mid_fn(z) -> x0 latent``."""
    z = exact_vae_encode(vae_params, cfg, lq_img, generator=generator if sample else None, sample=sample)
    img = exact_vae_decode(vae_params, cfg, mid_fn(z))
    return torch.clamp(img, -1.0, 1.0)
