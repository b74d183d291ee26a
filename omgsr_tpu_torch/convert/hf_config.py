"""Read HF config.json files into the port's model configs.

Mirrors diffusers/transformers from_pretrained config handling, with the
same defaults as the JAX package's readers, so a checkpoint directory fully
determines the architecture.
"""

from __future__ import annotations

import json
import os

from omgsr_tpu_torch.models.configs import CLIPTextConfig, FluxConfig, T5Config, UNetConfig, VAEConfig


def _read(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def vae_config_from_json(path: str) -> VAEConfig:
    c = _read(path)
    return VAEConfig(
        in_channels=c.get("in_channels", 3),
        out_channels=c.get("out_channels", 3),
        latent_channels=c.get("latent_channels", 4),
        block_out_channels=tuple(c.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=c.get("layers_per_block", 2),
        norm_num_groups=c.get("norm_num_groups", 32),
        scaling_factor=c.get("scaling_factor", 0.18215),
        shift_factor=c.get("shift_factor"),
        use_quant_conv=c.get("use_quant_conv", True),
        use_post_quant_conv=c.get("use_post_quant_conv", True),
        mid_block_attention=c.get("mid_block_add_attention", True),
    )


def unet_config_from_json(path: str) -> UNetConfig:
    c = _read(path)
    heads = c.get("num_attention_heads") or c.get("attention_head_dim", 8)
    if isinstance(heads, int):
        heads = (heads,) * len(c.get("block_out_channels", (320, 640, 1280, 1280)))
    return UNetConfig(
        in_channels=c.get("in_channels", 4),
        out_channels=c.get("out_channels", 4),
        block_out_channels=tuple(c.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=c.get("layers_per_block", 2),
        cross_attention_dim=c.get("cross_attention_dim", 1024),
        num_attention_heads=tuple(heads),
        down_block_types=tuple(c.get("down_block_types", UNetConfig.down_block_types)),
        up_block_types=tuple(c.get("up_block_types", UNetConfig.up_block_types)),
        norm_num_groups=c.get("norm_num_groups", 32),
        norm_eps=c.get("norm_eps", 1e-5),
        transformer_layers_per_block=c.get("transformer_layers_per_block", 1),
        use_linear_projection=c.get("use_linear_projection", True),
        flip_sin_to_cos=c.get("flip_sin_to_cos", True),
        freq_shift=c.get("freq_shift", 0),
    )


def flux_config_from_json(path: str) -> FluxConfig:
    c = _read(path)
    return FluxConfig(
        in_channels=c.get("in_channels", 64),
        num_layers=c.get("num_layers", 19),
        num_single_layers=c.get("num_single_layers", 38),
        attention_head_dim=c.get("attention_head_dim", 128),
        num_attention_heads=c.get("num_attention_heads", 24),
        joint_attention_dim=c.get("joint_attention_dim", 4096),
        pooled_projection_dim=c.get("pooled_projection_dim", 768),
        guidance_embeds=c.get("guidance_embeds", True),
        axes_dims_rope=tuple(c.get("axes_dims_rope", (16, 56, 56))),
    )


def clip_config_from_json(path: str) -> CLIPTextConfig:
    c = _read(path)
    return CLIPTextConfig(
        vocab_size=c.get("vocab_size", 49408),
        hidden_size=c.get("hidden_size", 1024),
        intermediate_size=c.get("intermediate_size", 4096),
        num_hidden_layers=c.get("num_hidden_layers", 23),
        num_attention_heads=c.get("num_attention_heads", 16),
        max_position_embeddings=c.get("max_position_embeddings", 77),
        hidden_act=c.get("hidden_act", "gelu"),
        layer_norm_eps=c.get("layer_norm_eps", 1e-5),
        eos_token_id=c.get("eos_token_id", 49407),
    )


def t5_config_from_json(path: str) -> T5Config:
    c = _read(path)
    return T5Config(
        vocab_size=c.get("vocab_size", 32128),
        d_model=c.get("d_model", 4096),
        d_kv=c.get("d_kv", 64),
        d_ff=c.get("d_ff", 10240),
        num_layers=c.get("num_layers", 24),
        num_heads=c.get("num_heads", 64),
        relative_attention_num_buckets=c.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=c.get("relative_attention_max_distance", 128),
        layer_norm_epsilon=c.get("layer_norm_epsilon", 1e-6),
    )
