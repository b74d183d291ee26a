"""Model architecture configs of the ported slices (SD2.1 VAE, UNet and CLIP
text encoder, the FLUX.1-dev VAE, DiT and prompt encoders (CLIP-L, T5-XXL),
DINOv3 ConvNeXt and ViT).

Values mirror the HF checkpoint configs of
stabilityai/stable-diffusion-2-1-base (vae/unet/text_encoder) and
black-forest-labs/FLUX.1-dev (vae/transformer/text_encoder/text_encoder_2).
The port keeps its own copy of these dataclasses. ConvNeXt sizes follow
dinov3/models/convnext.py:309-326, ViT sizes dinov3/hub/backbones.py:203-497.
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
    # route every eligible resnet (ops/conv3x3.fused_resblock_eligible) through
    # the fused GN+SiLU -> conv3x3 kernels; inference only
    fused_resblocks: bool = False
    # recompute each resnet in the backward (training under gradient
    # checkpointing): the 1024-px decode's backward otherwise holds every
    # resnet's GroupNorm and conv intermediates at once
    remat_blocks: bool = False

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


SD21_VAE = VAEConfig()

# black-forest-labs/FLUX.1-dev vae/: 16 latent channels, a shift, no quant convs
FLUX_VAE = VAEConfig(
    latent_channels=16,
    scaling_factor=0.3611,
    shift_factor=0.1159,
    use_quant_conv=False,
    use_post_quant_conv=False,
)


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


@dataclass(frozen=True)
class FluxConfig:
    """FluxTransformer2DModel (FLUX.1-dev)."""

    in_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: Sequence[int] = (16, 56, 56)
    rope_theta: int = 10000
    mlp_ratio: float = 4.0
    # recompute each dual / single block in the backward, keeping one carry a
    # block (training under gradient checkpointing)
    remat_blocks: bool = False

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


FLUX_DEV = FluxConfig()


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


# stabilityai/stable-diffusion-2-1-base text_encoder (OpenCLIP ViT-H text tower)
SD21_CLIP = CLIPTextConfig()

# openai/clip-vit-large-patch14 (FLUX text_encoder, pooled embedding)
FLUX_CLIP_L = CLIPTextConfig(
    hidden_size=768,
    intermediate_size=3072,
    num_hidden_layers=12,
    num_attention_heads=12,
    hidden_act="quick_gelu",
)


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"


# google/t5-v1_1-xxl encoder (FLUX text_encoder_2)
FLUX_T5_XXL = T5Config()


@dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Sequence[int] = (3, 3, 27, 3)
    dims: Sequence[int] = (192, 384, 768, 1536)
    layer_scale_init_value: float = 1e-6


CONVNEXT_SIZES = {
    "tiny": ConvNeXtConfig(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "small": ConvNeXtConfig(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "base": ConvNeXtConfig(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "large": ConvNeXtConfig(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}


@dataclass(frozen=True)
class DinoV3ViTConfig:
    """DINOv3 ViT (dinov3/models/vision_transformer.py:55-177; size entry
    points at dinov3/hub/backbones.py:203-497)."""

    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    ffn_ratio: float = 4.0
    ffn_layer: str = "mlp"  # "mlp" | "swiglu" (align 8) | "swiglu64"
    qkv_bias: bool = True
    n_storage_tokens: int = 4
    layerscale_init: float = 1e-5
    norm_eps: float = 1e-5  # hub models use "layernormbf16" = LN(eps=1e-5)
    rope_base: float = 100.0
    rope_normalize_coords: str = "separate"  # "separate" | "min" | "max"
    untie_cls_and_patch_norms: bool = False
    in_chans: int = 3
    # per-block recompute under grad (torch.utils.checkpoint in
    # dinov3_vit_apply): the memory lever of SSL pretraining; no effect on
    # inference
    remat_blocks: bool = False

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def swiglu_hidden(self) -> int:
        # ffn_layers.py:66-69: 2/3 of the nominal hidden dim, aligned up
        align = 64 if self.ffn_layer == "swiglu64" else 8
        d = int(int(self.embed_dim * self.ffn_ratio) * 2 / 3)
        return d + (-d % align)


# The published LVD-1689M checkpoints (hub/backbones.py:203-497). All use
# rope base 100, "separate" coord normalization, LayerScale 1e-5, LN eps
# 1e-5, 4 registers, masked k bias (folded at port time).
VIT_SIZES = {
    "vits16": DinoV3ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "vits16plus": DinoV3ViTConfig(embed_dim=384, depth=12, num_heads=6, ffn_ratio=6.0, ffn_layer="swiglu"),
    "vitb16": DinoV3ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vitl16": DinoV3ViTConfig(embed_dim=1024, depth=24, num_heads=16),
    "vitl16plus": DinoV3ViTConfig(embed_dim=1024, depth=24, num_heads=16, ffn_ratio=6.0, ffn_layer="swiglu"),
    "vith16plus": DinoV3ViTConfig(embed_dim=1280, depth=32, num_heads=20, ffn_ratio=6.0, ffn_layer="swiglu"),
    "vit7b16": DinoV3ViTConfig(embed_dim=4096, depth=40, num_heads=32, ffn_ratio=3.0, ffn_layer="swiglu64",
                               qkv_bias=False),
}
