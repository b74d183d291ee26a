"""SD2.1 UNet2DConditionModel, functional.

Conv in/out, 4 down/up stages of ResNet blocks with timestep conditioning,
spatial transformers with self+cross attention (cross dim 1024), linear
projections (SD2.x), sinusoidal timestep embedding + MLP. Parameter-tree
paths mirror the HF safetensors keys
(down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_q ...). NHWC.
"""

from __future__ import annotations

import torch

from omgsr_tpu_torch.models.configs import UNetConfig
from omgsr_tpu_torch.models.layers import (
    conv2d,
    dense,
    gelu,
    group_norm,
    group_norm_silu,
    layer_norm,
    silu,
    timestep_embedding,
    upsample_conv_2x,
)
from omgsr_tpu_torch.ops.attention import dot_product_attention

_GN_EPS_TRANSFORMER = 1e-6  # diffusers Transformer2DModel GroupNorm eps


def _resnet(p, x, temb, groups, eps):
    h = group_norm_silu(p["norm1"], x, groups, eps)
    h = conv2d(p["conv1"], h, padding=1)
    t = dense(p["time_emb_proj"], silu(temb))
    h = h + t[:, None, None, :]
    h = group_norm_silu(p["norm2"], h, groups, eps)
    h = conv2d(p["conv2"], h, padding=1)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _attention(p, x, context, heads):
    """x (B,S,C); context (B,S_kv,C_ctx)."""
    b, s, _ = x.shape
    q = dense(p["to_q"], x)
    k = dense(p["to_k"], context)
    v = dense(p["to_v"], context)
    d = q.shape[-1] // heads
    q = q.reshape(b, s, heads, d)
    k = k.reshape(b, context.shape[1], heads, d)
    v = v.reshape(b, context.shape[1], heads, d)
    o = dot_product_attention(q, k, v).reshape(b, s, heads * d)
    return dense(p["to_out"]["0"], o)


def _transformer_block(p, x, context, heads):
    h = layer_norm(p["norm1"], x)
    x = x + _attention(p["attn1"], h, h, heads)
    x = x + _attention(p["attn2"], layer_norm(p["norm2"], x), context, heads)
    h = layer_norm(p["norm3"], x)
    h = dense(p["ff"]["net"]["0"]["proj"], h)
    a, gate = torch.chunk(h, 2, dim=-1)
    h = a * gelu(gate)
    return x + dense(p["ff"]["net"]["2"], h)


def _spatial_transformer(p, x, context, heads, groups):
    b, hh, ww, c = x.shape
    res = x
    h = group_norm(p["norm"], x, groups, _GN_EPS_TRANSFORMER)
    h = h.reshape(b, hh * ww, c)
    h = dense(p["proj_in"], h)
    for i in sorted(p["transformer_blocks"], key=int):
        h = _transformer_block(p["transformer_blocks"][i], h, context, heads)
    h = dense(p["proj_out"], h)
    return res + h.reshape(b, hh, ww, c)


_BLOCKS = ("down_blocks", "mid_block", "up_blocks")


def unet_apply(params, cfg: UNetConfig, sample, timesteps, encoder_hidden_states, sharding=None):
    """sample (B,h,w,4) latent, timesteps scalar or (B,), context (B,77,1024)
    -> epsilon prediction (B,h,w,4). Mirrors diffusers
    UNet2DConditionModel.forward dataflow. ``sharding``: the
    ``parallel.sharding.Sharding`` of a tree that ``shard_params_fsdp``
    placed; the leaves outside the blocks are gathered once a forward, each
    down, mid and up block's as it enters the block (every rank of the group
    makes the same call)."""
    g = cfg.norm_num_groups
    eps = cfg.norm_eps
    bo = list(cfg.block_out_channels)
    dtype = sample.dtype
    gather = sharding.gather if sharding is not None else (lambda tree: tree)
    if sharding is not None:
        params = {**gather({k: v for k, v in params.items() if k not in _BLOCKS}),
                  **{k: params[k] for k in _BLOCKS}}

    timesteps = torch.as_tensor(timesteps, device=sample.device).expand(sample.shape[0])
    temb = timestep_embedding(timesteps, bo[0], cfg.flip_sin_to_cos, cfg.freq_shift)
    temb = dense(params["time_embedding"]["linear_1"], temb.to(dtype))
    temb = dense(params["time_embedding"]["linear_2"], silu(temb))

    h = conv2d(params["conv_in"], sample, padding=1)
    skips = [h]

    for i in range(len(cfg.down_block_types)):
        blk = gather(params["down_blocks"][str(i)])
        heads = cfg.num_attention_heads[i]
        for j in range(cfg.layers_per_block):
            h = _resnet(blk["resnets"][str(j)], h, temb, g, eps)
            if "attentions" in blk:
                h = _spatial_transformer(blk["attentions"][str(j)], h, encoder_hidden_states, heads, g)
            skips.append(h)
        if "downsamplers" in blk:
            h = conv2d(blk["downsamplers"]["0"]["conv"], h, stride=2, padding=1)
            skips.append(h)

    mid = gather(params["mid_block"])
    h = _resnet(mid["resnets"]["0"], h, temb, g, eps)
    h = _spatial_transformer(mid["attentions"]["0"], h, encoder_hidden_states, cfg.num_attention_heads[-1], g)
    h = _resnet(mid["resnets"]["1"], h, temb, g, eps)

    rheads = list(reversed(cfg.num_attention_heads))
    for i in range(len(cfg.up_block_types)):
        blk = gather(params["up_blocks"][str(i)])
        for j in range(cfg.layers_per_block + 1):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _resnet(blk["resnets"][str(j)], h, temb, g, eps)
            if "attentions" in blk:
                h = _spatial_transformer(blk["attentions"][str(j)], h, encoder_hidden_states, rheads[i], g)
        if "upsamplers" in blk:
            h = upsample_conv_2x(blk["upsamplers"]["0"]["conv"], h)

    h = group_norm_silu(params["conv_norm_out"], h, g, eps)
    return conv2d(params["conv_out"], h, padding=1)
