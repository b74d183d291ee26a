"""Model architecture configs of the ported slice (SD2.1 VAE and UNet).

Values mirror the HF checkpoint configs of
stabilityai/stable-diffusion-2-1-base (vae/unet). The port keeps its own
copy of these dataclasses; the FLUX, text-encoder and ConvNeXt configs
arrive with the slices that need them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: Optional[float] = None
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True
    mid_block_attention: bool = True

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


SD21_VAE = VAEConfig()


@dataclass(frozen=True)
class UNetConfig:
    """UNet2DConditionModel, SD2.1-base layout."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    # per-block attention heads; diffusers' (misnamed) attention_head_dim
    num_attention_heads: Sequence[int] = (5, 10, 20, 20)
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_layers_per_block: int = 1
    use_linear_projection: bool = True
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0


SD21_UNET = UNetConfig()
