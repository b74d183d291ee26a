"""DINOv3 Vision Transformer (RoPE, registers, LayerScale).

The backbone family the reference vendors and keeps off OMGSR's execution
path (dinov3/models/vision_transformer.py:55-412 and dinov3/layers/
{attention,block,rope_position_encoding,patch_embed,ffn_layers,
layer_scale}.py; built by dinov3/hub/backbones.py:63-146). OMGSR itself
loads only the ConvNeXt (models/convnext.py); the ViTs are the other hub
exports and drop in as alternative feature backbones via ``vit_features``.

Architecture (eval path: the train-only RoPE coordinate augmentations
shift/jitter/rescale and stochastic depth are sampling noise, not weights):
  patch conv P x P /P -> tokens [cls, storage*, patches]
  per block: x += ls1 * attn(LN(x))   (RoPE on patch q/k, axial sin/cos)
             x += ls2 * ffn(LN(x))    (mlp or swiglu)
  final LN (optionally untied for cls/registers vs patches)

Parameter paths mirror the torch state dict (blocks.0.attn.qkv.weight, ...),
so the hub .pth porter (``convert/porters.port_dinov3_vit``) is mechanical;
it folds the reference's masked k bias (LinearKMaskedBias,
attention.py:30-40) into the qkv bias. NHWC images, (B, N, D) tokens.

Every head goes through ``ops.attention.dot_product_attention``, so on a
CUDA tensor at head dim 64 (the hub's ViT-S..H) or 128 (ViT-7B) the
flash-attention forward kernel runs it at 1 + registers + h*w tokens (201 at
224 px, 1029 at 512 px). RoPE runs in f32 on the patch tokens only and q/k
are rounded back to the input dtype before the kernel, in the JAX
package's order.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from omgsr_tpu_torch.models.configs import VIT_SIZES, DinoV3ViTConfig
from omgsr_tpu_torch.models.layers import conv2d, dense, gelu, layer_norm, silu
from omgsr_tpu_torch.ops.attention import dot_product_attention

__all__ = [
    "DinoV3ViTConfig",
    "VIT_SIZES",
    "dinov3_vit_apply",
    "get_intermediate_layers",
    "vit_features",
    "rope_periods",
    "rope_sincos",
]


def rope_periods(cfg: DinoV3ViTConfig) -> np.ndarray:
    """base**(2i/(D_head/2)), i < D_head/4 (rope_position_encoding.py:110-113)."""
    q = cfg.head_dim // 4
    return cfg.rope_base ** (2.0 * np.arange(q, dtype=np.float64) / (cfg.head_dim // 2))


def rope_sincos(params, cfg: DinoV3ViTConfig, h: int, w: int):
    """Axial RoPE tables for an h x w patch grid -> (sin, cos), each (h*w,
    D_head) in f32 on the parameters' device.

    rope_position_encoding.py:57-107, eval path: coords at pixel centers
    normalized to [-1, 1], angles 2*pi*coord/period per axis, halves tiled so
    feature i pairs with i + D_head/2."""
    periods = params["rope_embed"]["periods"].float()
    dev = periods.device
    if cfg.rope_normalize_coords == "separate":
        dh, dw = h, w
    elif cfg.rope_normalize_coords in ("min", "max"):
        dh = dw = min(h, w) if cfg.rope_normalize_coords == "min" else max(h, w)
    else:
        raise ValueError(f"rope_normalize_coords {cfg.rope_normalize_coords!r}: 'separate', 'min' or 'max'")
    ch = (torch.arange(0.5, h, dtype=torch.float32, device=dev) / dh) * 2.0 - 1.0
    cw = (torch.arange(0.5, w, dtype=torch.float32, device=dev) / dw) * 2.0 - 1.0
    coords = torch.stack(torch.meshgrid(ch, cw, indexing="ij"), dim=-1).reshape(-1, 2)
    angles = 2.0 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = angles.reshape(angles.shape[0], -1)  # (hw, D_head/2): [h..., w...]
    angles = angles.repeat(1, 2)  # (hw, D_head)
    return torch.sin(angles), torch.cos(angles)


def _rope_apply(x, sin, cos):
    # attention.py:16-27: rotate_half([x1, x2]) = [-x2, x1]
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(p, x, sincos, n_prefix: int, cfg: DinoV3ViTConfig):
    b, n, d = x.shape
    qkv = dense(p["qkv"], x).reshape(b, n, 3, cfg.num_heads, cfg.head_dim)
    q, k, v = qkv.unbind(2)  # (B, N, H, Dh) views of the packed product
    if sincos is not None:
        # the rope math runs in f32 (attention.py:68-87), then q and k are rounded to the input dtype
        sin, cos = (t[None, :, None, :] for t in sincos)
        qp = _rope_apply(q[:, n_prefix:].float(), sin, cos)
        kp = _rope_apply(k[:, n_prefix:].float(), sin, cos)
        q = torch.cat([q[:, :n_prefix], qp.to(q.dtype)], dim=1)
        k = torch.cat([k[:, :n_prefix], kp.to(k.dtype)], dim=1)
    out = dot_product_attention(q, k, v)
    return dense(p["proj"], out.reshape(b, n, d))


def _ffn(p, x, cfg: DinoV3ViTConfig):
    if cfg.ffn_layer == "mlp":
        return dense(p["fc2"], gelu(dense(p["fc1"], x), approximate=False))
    return dense(p["w3"], silu(dense(p["w1"], x)) * dense(p["w2"], x))


def _block(p, x, sincos, n_prefix, cfg):
    h = _attention(p["attn"], layer_norm(p["norm1"], x, cfg.norm_eps), sincos, n_prefix, cfg)
    x = x + p["ls1"]["gamma"].to(x.dtype) * h
    h = _ffn(p["mlp"], layer_norm(p["norm2"], x, cfg.norm_eps), cfg)
    return x + p["ls2"]["gamma"].to(x.dtype) * h


def _prepare_tokens(params, cfg: DinoV3ViTConfig, x, masks=None):
    """NHWC image -> ([cls, storage, patch] tokens, (h, w) patch grid).

    vision_transformer.py:186-216. ``masks`` (B, hw) bool swaps masked patch
    embeddings for the shared mask token (the iBOT input path)."""
    b = x.shape[0]
    x = conv2d(params["patch_embed"]["proj"], x, stride=cfg.patch_size, padding="VALID")
    h, w = x.shape[1], x.shape[2]
    x = x.reshape(b, h * w, cfg.embed_dim)
    if masks is not None:
        x = torch.where(masks[:, :, None].to(torch.bool), params["mask_token"][None].to(x.dtype), x)
    toks = [params["cls_token"].to(x.dtype).expand(b, 1, cfg.embed_dim)]
    if cfg.n_storage_tokens > 0:
        toks.append(params["storage_tokens"].to(x.dtype).expand(b, cfg.n_storage_tokens, cfg.embed_dim))
    return torch.cat(toks + [x], dim=1), (h, w)


def _final_norm(params, cfg: DinoV3ViTConfig, x, n_prefix: int):
    """(cls and registers, patches), normed by the final LayerNorm(s)."""
    if cfg.untie_cls_and_patch_norms:
        return (layer_norm(params["cls_norm"], x[:, :n_prefix], cfg.norm_eps),
                layer_norm(params["norm"], x[:, n_prefix:], cfg.norm_eps))
    normed = layer_norm(params["norm"], x, cfg.norm_eps)
    return normed[:, :n_prefix], normed[:, n_prefix:]


def dinov3_vit_apply(params, cfg: DinoV3ViTConfig, x, masks=None):
    """NHWC image (ImageNet-normalized) -> feature dict, keys as upstream
    forward_features (vision_transformer.py:244-256): x_norm_clstoken,
    x_storage_tokens, x_norm_patchtokens (B, hw, D), x_prenorm. With
    ``cfg.remat_blocks`` and grad enabled each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its forward, K1 included,
    runs again in the backward."""
    x, (h, w) = _prepare_tokens(params, cfg, x, masks)
    n_prefix = 1 + cfg.n_storage_tokens
    sincos = rope_sincos(params, cfg, h, w)
    remat = cfg.remat_blocks and torch.is_grad_enabled()
    for i in range(cfg.depth):
        if remat:  # the block's activations are recomputed in the backward (jax.checkpoint(_block))
            x = checkpoint(_block, params["blocks"][str(i)], x, sincos, n_prefix, cfg, use_reentrant=False)
        else:
            x = _block(params["blocks"][str(i)], x, sincos, n_prefix, cfg)
    cls_reg, patch = _final_norm(params, cfg, x, n_prefix)
    return {
        "x_norm_clstoken": cls_reg[:, 0],
        "x_storage_tokens": cls_reg[:, 1:],
        "x_norm_patchtokens": patch,
        "x_prenorm": x,
    }


def get_intermediate_layers(
    params,
    cfg: DinoV3ViTConfig,
    x,
    n: int | Sequence[int] = 1,
    reshape: bool = False,
    norm: bool = True,
    return_class_token: bool = False,
    return_extra_tokens: bool = False,
):
    """Patch-token maps from the last n (or listed) blocks
    (vision_transformer.py:265-318). reshape=True returns NHWC maps at
    stride patch_size, the ViT analogue of convnext_features.
    return_class_token=True yields (patch, cls) pairs per block (the
    linear-probe evaluator's layout, eval/linear.py:148-160);
    return_extra_tokens=True appends the storage/register tokens (B, R, D)
    to each tuple (the dinotxt vision tower's input,
    eval/text/vision_tower.py:127-137)."""
    tokens, (h, w) = _prepare_tokens(params, cfg, x)
    n_prefix = 1 + cfg.n_storage_tokens
    sincos = rope_sincos(params, cfg, h, w)
    take = set(range(cfg.depth - n, cfg.depth)) if isinstance(n, int) else set(n)
    outs = []
    for i in range(cfg.depth):
        tokens = _block(params["blocks"][str(i)], tokens, sincos, n_prefix, cfg)
        if i in take:
            outs.append(tokens)
    if norm:
        outs = [torch.cat(_final_norm(params, cfg, o, n_prefix), dim=1) for o in outs]
    patches = [o[:, n_prefix:] for o in outs]
    if reshape:
        patches = [p.reshape(x.shape[0], h, w, cfg.embed_dim) for p in patches]
    if return_class_token and return_extra_tokens:
        return [(p, o[:, 0], o[:, 1:n_prefix]) for p, o in zip(patches, outs)]
    if return_class_token:
        return [(p, o[:, 0]) for p, o in zip(patches, outs)]
    if return_extra_tokens:
        return [(p, o[:, 1:n_prefix]) for p, o in zip(patches, outs)]
    return patches


def vit_features(params, cfg: DinoV3ViTConfig, x, layers: Sequence[int] | int = 4):
    """ImageNet-normalized NHWC image -> list of NHWC feature maps from
    evenly spaced (or listed) blocks: a drop-in alternative to
    convnext_features for DISTS/discriminator heads (single stride:
    patch_size)."""
    if isinstance(layers, int):
        step = cfg.depth / layers
        layers = [int(step * (i + 1)) - 1 for i in range(layers)]
    return get_intermediate_layers(params, cfg, x, n=list(layers), reshape=True)
