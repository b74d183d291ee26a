"""OMGSR-S one-step inference pipeline (SD2.1 UNet @ mid-timestep 273).

VAE-encode the upscaled LQ image, one UNet epsilon prediction at the
calibrated mid-timestep (tiled with gaussian stitching when the latent
exceeds the tile size), recover x0, VAE-decode, clamp. Runs eagerly under
``torch.inference_mode()``. LoRA adapters are merged into the base weights
at load time, so inference runs the plain architecture. With ``vae_tile`` the
VAE stages of large images go through the tiled VAE
(``inference/vae_routing.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from omgsr_tpu_torch.diffusion.schedules import mid_timestep_coeffs_sd
from omgsr_tpu_torch.inference.tiled import tiled_denoise
from omgsr_tpu_torch.inference.vae_routing import (
    exact_one_step,
    routed_vae_decode,
    routed_vae_encode,
    validate_vae_opts,
    wants_exact_path,
)
from omgsr_tpu_torch.models import unet_sd
from omgsr_tpu_torch.models.configs import SD21_UNET, SD21_VAE, UNetConfig, VAEConfig
from omgsr_tpu_torch.utils.devices import resolve_device, tree_to


class OMGSRSPipeline:
    def __init__(
        self,
        vae_params,
        unet_params,
        vae_cfg: VAEConfig = SD21_VAE,
        unet_cfg: UNetConfig = SD21_UNET,
        mid_timestep: int = 273,
        tile_batch: int | None = None,
        vae_tile: int | None = None,
        vae_stats: str = "fast",
        device="cuda",
    ):
        """The parameter trees are moved to ``device``.

        vae_tile: when set, the VAE stages of an image whose larger side
        exceeds it run through overlap-padded tiles of this many pixels, for
        images too large for a full-image VAE pass. vae_stats: "fast"
        estimates the GroupNorm statistics from a downsampled copy; "exact"
        runs the full-image VAE (exact global statistics; see
        ``inference/tiled_vae.py``); "auto" is
        fast up to the downsample ratio ``tiled_vae.AUTO_EXACT_RATIO`` and
        exact beyond it."""
        validate_vae_opts(vae_tile, vae_stats, vae_cfg.downscale)
        self.device = resolve_device(device)
        self.vae_params = tree_to(vae_params, self.device)
        self.unet_params = tree_to(unet_params, self.device)
        self.vae_cfg = vae_cfg
        self.unet_cfg = unet_cfg
        self.mid_timestep = mid_timestep
        self.tile_batch = tile_batch
        self.vae_tile = vae_tile
        self.vae_stats = vae_stats
        self.sqrt_alpha, self.sqrt_one_minus_alpha = mid_timestep_coeffs_sd(mid_timestep)

    def shard_for_mesh(self, *args, **kwargs):
        raise NotImplementedError(
            "shard_for_mesh: tile-parallel multi-GPU serving is not ported yet (distribution slice)"
        )

    def _on_device(self, x, dtype=None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=self.device, dtype=dtype)

    # the three stages, callable on their own (chip_smoke.py times them)

    def encode(self, lq_img, noise=None, generator=None, sample_latent: bool = True):
        """pixels (B,H,W,3) in [-1,1] -> scaled latent (full-image or
        streaming tiled)."""
        return routed_vae_encode(
            self.vae_params, self.vae_cfg, lq_img, self.vae_tile, sample_latent, self.vae_stats,
            generator=generator, noise=noise,
        )

    def latent_mid(self, z, prompt_embeds, tile_size: int = 64, tile_overlap: int = 32):
        """latent -> x0 latent: tiled UNet epsilon at the mid-timestep."""

        def denoise(tiles):
            n = tiles.shape[0]
            ctx = prompt_embeds.expand(n, *prompt_embeds.shape[-2:]).to(tiles.dtype)
            return unet_sd.unet_apply(self.unet_params, self.unet_cfg, tiles, self.mid_timestep, ctx)

        eps = tiled_denoise(z, denoise, tile_size, tile_overlap, self.tile_batch)
        return (z - self.sqrt_one_minus_alpha * eps) / self.sqrt_alpha

    def decode(self, z0):
        """x0 latent -> pixels clamped to [-1,1] (full-image or streaming
        tiled)."""
        img = routed_vae_decode(self.vae_params, self.vae_cfg, z0, self.vae_tile, self.vae_stats)
        return torch.clamp(img, -1.0, 1.0)

    @torch.inference_mode()
    def __call__(
        self,
        lq_img,
        prompt_embeds,
        tile_size: int = 64,
        tile_overlap: int = 32,
        generator: torch.Generator | None = None,
        noise=None,
        sample_latent: bool = True,
    ):
        """lq_img (B,H,W,3) in [-1,1]; returns the SR image (B,H,W,3) in
        [-1,1] on the pipeline's device. The latent is sampled only when
        ``sample_latent`` and a noise source (``noise``, shaped like the
        latent, or a ``generator`` on the pipeline's device) are given;
        otherwise the posterior mean is used. A tiled VAE route takes only a
        generator."""
        lq_img = self._on_device(lq_img)
        prompt_embeds = self._on_device(prompt_embeds)
        if noise is not None:
            noise = self._on_device(noise)
        if wants_exact_path(self.vae_stats, self.vae_tile, lq_img):
            if sample_latent and noise is not None:
                raise ValueError("the exact tiled VAE samples from a generator, not a noise tensor")
            return exact_one_step(
                self.vae_params, self.vae_cfg, lq_img,
                lambda z: self.latent_mid(z, prompt_embeds, tile_size, tile_overlap),
                generator, sample_latent,
            )
        z = self.encode(lq_img, noise, generator, sample_latent)
        z0 = self.latent_mid(z, prompt_embeds, tile_size, tile_overlap)
        return self.decode(z0)
