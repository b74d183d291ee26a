"""OMGSR-F one-step inference pipeline (FLUX.1-dev DiT at mid-timestep 244).

FLUX-VAE encode; per tile a 2x2 pack, the DiT's velocity at sigma(244) with
guidance 1.0, an unpack; gaussian stitching; one Euler step z - sigma * v
(infer/omgsr_f_infer_model.py:316); decode, clamp. Runs eagerly under
``torch.inference_mode()``, the DiT's blocks as a Python loop. The RoPE ids
are built once per tile grid and shared by all tiles: every tile is exactly
``tile_size`` latents (the reference relies on the same invariant,
infer/infer_omgsr_f.py:50-55). LoRA adapters are merged into the base weights
at load time. With ``vae_tile`` the VAE stages of large images go through the
tiled VAE (``inference/vae_routing.py``), as in ``pipeline_s.py``.
``shard_for_mesh`` spreads the DiT over the ranks of a mesh (one process per
GPU): FSDP, tensor parallelism or tile parallelism.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from omgsr_tpu_torch.diffusion.packing import latent_image_ids, pack_latents, unpack_latents
from omgsr_tpu_torch.diffusion.schedules import flux_sigma_at_mid_timestep
from omgsr_tpu_torch.inference.tiled import auto_tile_batch, tiled_denoise
from omgsr_tpu_torch.inference.vae_routing import (
    exact_one_step,
    routed_vae_decode,
    routed_vae_encode,
    validate_vae_opts,
    wants_exact_path,
)
from omgsr_tpu_torch.models import flux
from omgsr_tpu_torch.models.configs import FLUX_DEV, FLUX_VAE, FluxConfig, VAEConfig
from omgsr_tpu_torch.parallel.sharding import shard_flux_params
from omgsr_tpu_torch.utils.devices import resolve_device, tree_to


def flux_tile_batch(n_tiles: int, tokens: int) -> int:
    """DiT tiles per forward for ``n_tiles`` tiles of ``tokens`` tokens each
    (image and text), the default of ``tile_batch=None``. Below 4096 tokens a
    tile: ``tiled.auto_tile_batch``. From 4096: its divisor where it divides
    the tile count, else one tile per forward, so no padded tile costs a
    forward. The JAX package's rule, measured on a TPU v5e, is one tile per
    forward from 4096 tokens; on an H100 (chip_smoke.py serve-f) nine
    4608-token tiles ran faster three a forward, and the padded and 8-tile
    counts are timed there too."""
    tb = auto_tile_batch(n_tiles)
    return tb if tokens < 4096 or n_tiles % tb == 0 else 1


class OMGSRFPipeline:
    def __init__(
        self,
        vae_params,
        flux_params,
        vae_cfg: VAEConfig = FLUX_VAE,
        flux_cfg: FluxConfig = FLUX_DEV,
        mid_timestep: int = 244,
        guidance_scale: float = 1.0,
        tile_batch: int | None = None,
        vae_tile: int | None = None,
        vae_stats: str = "fast",
        device="cuda",
    ):
        """The parameter trees are moved to ``device`` (a tree already there
        is not copied). ``tile_batch``: DiT tiles per forward; None takes
        ``flux_tile_batch``. ``vae_tile`` / ``vae_stats`` as in
        ``OMGSRSPipeline``."""
        validate_vae_opts(vae_tile, vae_stats, vae_cfg.downscale)
        self.device = resolve_device(device)
        self.vae_params = tree_to(vae_params, self.device)
        self.flux_params = tree_to(flux_params, self.device)
        self.vae_cfg = vae_cfg
        self.flux_cfg = flux_cfg
        self.mid_timestep = mid_timestep
        self.sigma_t = flux_sigma_at_mid_timestep(mid_timestep)
        self.guidance_scale = guidance_scale
        self.tile_batch = tile_batch
        self.vae_tile = vae_tile
        self.vae_stats = vae_stats
        self._img_ids = {}
        self._tile_group = None
        self._sharding = None

    def shard_for_mesh(self, mesh, strategy: str = "fsdp", *, min_size: int = 2**18):
        """Spread the 12B DiT over the ranks of ``mesh`` (bf16 or a quantised
        tree). "fsdp": each rank keeps a chunk of every leaf of ``min_size``
        elements or more over the "fsdp" axis; the chunks of a block are
        gathered just before it runs. "tp": tensor parallelism over the "tp"
        axis, each rank holding its share of the heads and the MLP width for
        good, one sum over the group per row-parallel product (the trade when
        the products dominate). "tiles": every rank keeps all the weights and
        the tiles are split over the "data" axis, near-linear single-image
        scaling when the model fits one card. The VAE stays whole on every
        rank. A later "fsdp" / "tp" call clears the tile split of an earlier
        "tiles" call; a placed DiT is not placed again. Every rank then makes
        every call with the same inputs."""
        if strategy == "tiles":
            self._tile_group = mesh.group("data")
            return self
        if strategy not in ("fsdp", "tp"):
            raise ValueError(f"strategy must be 'fsdp', 'tp' or 'tiles', got {strategy!r}")
        if self._sharding is not None:
            raise ValueError("the DiT is placed already: build a new pipeline to place it again")
        self.flux_params, self._sharding = shard_flux_params(self.flux_params, self.flux_cfg, mesh, strategy,
                                                             min_size)
        self._tile_group = None
        return self

    def _on_device(self, x, dtype=None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=self.device, dtype=dtype)

    def _ids(self, th: int, tw: int):
        if (th, tw) not in self._img_ids:
            self._img_ids[(th, tw)] = latent_image_ids(th // 2, tw // 2, device=self.device)
        return self._img_ids[(th, tw)]

    # the three stages, callable on their own (chip_smoke.py times them)

    def encode(self, lq_img, noise=None, generator=None, sample_latent: bool = True):
        """pixels (B,H,W,3) in [-1,1] -> scaled, shifted latent (full-image
        or streaming tiled)."""
        return routed_vae_encode(
            self.vae_params, self.vae_cfg, lq_img, self.vae_tile, sample_latent, self.vae_stats,
            generator=generator, noise=noise,
        )

    def latent_mid(self, z, prompt_embeds, pooled_prompt_embeds, tile_size: int = 128, tile_overlap: int = 64):
        """latent -> x0 latent: the tiled DiT velocity and an Euler step to t=0."""
        txt_ids = torch.zeros((prompt_embeds.shape[-2], 3), dtype=torch.float32, device=z.device)

        def denoise(tiles):
            n, th, tw, _ = tiles.shape
            ctx = prompt_embeds.expand(n, *prompt_embeds.shape[-2:]).to(tiles.dtype)
            pooled = pooled_prompt_embeds.expand(n, pooled_prompt_embeds.shape[-1]).to(tiles.dtype)
            v = flux.flux_apply(self.flux_params, self.flux_cfg, pack_latents(tiles), self.sigma_t,
                                self.guidance_scale, pooled, ctx, txt_ids, self._ids(th, tw), self._sharding)
            return unpack_latents(v, th, tw)

        tb = self.tile_batch
        if tb is None:
            # the tile size tiled_denoise runs: clamped to the latent
            tokens = (min(tile_size, z.shape[1], z.shape[2]) // 2) ** 2 + prompt_embeds.shape[-2]
            tb = functools.partial(flux_tile_batch, tokens=tokens)
        v = tiled_denoise(z, denoise, tile_size, tile_overlap, tb, self._tile_group)
        return z - self.sigma_t * v

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
        pooled_prompt_embeds,
        tile_size: int = 128,
        tile_overlap: int = 64,
        generator: torch.Generator | None = None,
        noise=None,
        sample_latent: bool = True,
    ):
        """lq_img (B,H,W,3) in [-1,1], prompt_embeds (1, S_txt, 4096), pooled
        (1, 768); returns the SR image (B,H,W,3) in [-1,1] on the pipeline's
        device. The latent is sampled only when ``sample_latent`` and a noise
        source (``noise`` shaped like the latent, or a ``generator`` on the
        pipeline's device) are given; otherwise the posterior mean is used."""
        lq_img = self._on_device(lq_img)
        prompt_embeds = self._on_device(prompt_embeds)
        pooled_prompt_embeds = self._on_device(pooled_prompt_embeds)
        if noise is not None:
            noise = self._on_device(noise)
        if wants_exact_path(self.vae_stats, self.vae_tile, lq_img):
            if sample_latent and noise is not None:
                raise ValueError("the exact tiled VAE samples from a generator, not a noise tensor")
            return exact_one_step(
                self.vae_params, self.vae_cfg, lq_img,
                lambda z: self.latent_mid(z, prompt_embeds, pooled_prompt_embeds, tile_size, tile_overlap),
                generator, sample_latent,
            )
        z = self.encode(lq_img, noise, generator, sample_latent)
        z0 = self.latent_mid(z, prompt_embeds, pooled_prompt_embeds, tile_size, tile_overlap)
        return self.decode(z0)
