"""The weight bridge and the seed-based initialisers.

The JAX package's parameter trees nest dicts by HF key paths with conv
``kernel`` HWIO, dense ``kernel`` (in, out) and norm ``scale``. The port
keeps the key paths and stores every leaf in torch layout: conv ``weight``
OIHW (kept in channels_last memory format, since activations are NHWC),
dense ``weight`` (out, in), norm ``weight``. ``from_jax_tree`` converts a
tree of numpy arrays; ``init_vae`` / ``init_unet`` build trees of the same
structure from a seed (torch's default Linear/Conv2d distribution; the
values differ from the JAX initialisers', so parity tests always carry the
JAX weights across the bridge).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from omgsr_tpu_torch.models.configs import UNetConfig, VAEConfig
from omgsr_tpu_torch.utils.devices import resolve_device


def _conv_weight(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous(memory_format=torch.channels_last)


def from_jax_tree(tree, dtype=None, device="cuda"):
    """Nested dict of numpy arrays in the JAX package's layout -> nested dict
    of tensors in the port's layout, same key paths."""
    device = resolve_device(device)

    def leaf(key, arr):
        t = torch.from_numpy(np.array(arr, copy=True))
        if key == "kernel":
            if t.dim() == 4:  # HWIO -> OIHW
                return "weight", _conv_weight(t.permute(3, 2, 0, 1).to(device=device, dtype=dtype))
            if t.dim() == 2:  # (in, out) -> (out, in)
                return "weight", t.t().contiguous().to(device=device, dtype=dtype)
            raise ValueError(f"kernel of rank {t.dim()} has no torch layout here")
        if key == "scale":
            key = "weight"
        return key, t.to(device=device, dtype=dtype)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                nk, t = leaf(k, v)
                out[nk] = t
        return out

    return walk(tree)


# ----------------------------------------------------------------------------
# seed-based initialisers (torch-default: kaiming uniform, fan_in, a=sqrt(5))
# ----------------------------------------------------------------------------


class _Init:
    def __init__(self, seed: int, dtype, device):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _uniform(self, shape, bound):
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        t.uniform_(-bound, bound, generator=self.gen)
        return t.to(self.dtype)

    def dense(self, in_dim, out_dim, use_bias=True):
        b = 1.0 / math.sqrt(in_dim) if in_dim > 0 else 0.0
        p = {"weight": self._uniform((out_dim, in_dim), b)}
        if use_bias:
            p["bias"] = self._uniform((out_dim,), b)
        return p

    def conv(self, kh, kw, in_ch, out_ch, use_bias=True):
        fan_in = kh * kw * in_ch
        b = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        p = {"weight": _conv_weight(self._uniform((out_ch, in_ch, kh, kw), b))}
        if use_bias:
            p["bias"] = self._uniform((out_ch,), b)
        return p

    def norm(self, dim):
        return {
            "weight": torch.ones(dim, dtype=self.dtype, device=self.device),
            "bias": torch.zeros(dim, dtype=self.dtype, device=self.device),
        }


def _vae_resnet(it: _Init, in_ch, out_ch):
    p = {
        "norm1": it.norm(in_ch),
        "conv1": it.conv(3, 3, in_ch, out_ch),
        "norm2": it.norm(out_ch),
        "conv2": it.conv(3, 3, out_ch, out_ch),
    }
    if in_ch != out_ch:
        p["conv_shortcut"] = it.conv(1, 1, in_ch, out_ch)
    return p


def _vae_mid(it: _Init, ch, with_attention):
    p = {"resnets": {"0": _vae_resnet(it, ch, ch), "1": _vae_resnet(it, ch, ch)}}
    if with_attention:
        p["attentions"] = {
            "0": {
                "group_norm": it.norm(ch),
                "to_q": it.dense(ch, ch),
                "to_k": it.dense(ch, ch),
                "to_v": it.dense(ch, ch),
                "to_out": {"0": it.dense(ch, ch)},
            }
        }
    return p


def init_vae(seed: int, cfg: VAEConfig, dtype=torch.float32, device="cuda"):
    """Random AutoencoderKL parameters with the HF tree structure."""
    it = _Init(seed, dtype, device)
    bo = list(cfg.block_out_channels)
    lat = cfg.latent_channels

    enc = {"conv_in": it.conv(3, 3, cfg.in_channels, bo[0])}
    down = {}
    ch = bo[0]
    for i, out_ch in enumerate(bo):
        blk = {"resnets": {}}
        for j in range(cfg.layers_per_block):
            blk["resnets"][str(j)] = _vae_resnet(it, ch if j == 0 else out_ch, out_ch)
        ch = out_ch
        if i < len(bo) - 1:
            blk["downsamplers"] = {"0": {"conv": it.conv(3, 3, ch, ch)}}
        down[str(i)] = blk
    enc["down_blocks"] = down
    enc["mid_block"] = _vae_mid(it, ch, cfg.mid_block_attention)
    enc["conv_norm_out"] = it.norm(ch)
    enc["conv_out"] = it.conv(3, 3, ch, 2 * lat)

    rbo = list(reversed(bo))
    dec = {"conv_in": it.conv(3, 3, lat, rbo[0])}
    dec["mid_block"] = _vae_mid(it, rbo[0], cfg.mid_block_attention)
    up = {}
    ch = rbo[0]
    for i, out_ch in enumerate(rbo):
        blk = {"resnets": {}}
        for j in range(cfg.layers_per_block + 1):
            blk["resnets"][str(j)] = _vae_resnet(it, ch if j == 0 else out_ch, out_ch)
        ch = out_ch
        if i < len(rbo) - 1:
            blk["upsamplers"] = {"0": {"conv": it.conv(3, 3, ch, ch)}}
        up[str(i)] = blk
    dec["up_blocks"] = up
    dec["conv_norm_out"] = it.norm(ch)
    dec["conv_out"] = it.conv(3, 3, ch, cfg.out_channels)

    params = {"encoder": enc, "decoder": dec}
    if cfg.use_quant_conv:
        params["quant_conv"] = it.conv(1, 1, 2 * lat, 2 * lat)
    if cfg.use_post_quant_conv:
        params["post_quant_conv"] = it.conv(1, 1, lat, lat)
    return params


def _unet_resnet(it: _Init, in_ch, out_ch, temb_ch):
    p = {
        "norm1": it.norm(in_ch),
        "conv1": it.conv(3, 3, in_ch, out_ch),
        "time_emb_proj": it.dense(temb_ch, out_ch),
        "norm2": it.norm(out_ch),
        "conv2": it.conv(3, 3, out_ch, out_ch),
    }
    if in_ch != out_ch:
        p["conv_shortcut"] = it.conv(1, 1, in_ch, out_ch)
    return p


def _unet_attention(it: _Init, query_dim, context_dim, inner_dim):
    return {
        "to_q": it.dense(query_dim, inner_dim, use_bias=False),
        "to_k": it.dense(context_dim, inner_dim, use_bias=False),
        "to_v": it.dense(context_dim, inner_dim, use_bias=False),
        "to_out": {"0": it.dense(inner_dim, query_dim)},
    }


def _spatial_transformer(it: _Init, ch, n_layers, cross_dim):
    return {
        "norm": it.norm(ch),
        "proj_in": it.dense(ch, ch),
        "transformer_blocks": {
            str(i): {
                "norm1": it.norm(ch),
                "attn1": _unet_attention(it, ch, ch, ch),
                "norm2": it.norm(ch),
                "attn2": _unet_attention(it, ch, cross_dim, ch),
                "norm3": it.norm(ch),
                "ff": {"net": {"0": {"proj": it.dense(ch, ch * 8)}, "2": it.dense(ch * 4, ch)}},
            }
            for i in range(n_layers)
        },
        "proj_out": it.dense(ch, ch),
    }


def init_unet(seed: int, cfg: UNetConfig, dtype=torch.float32, device="cuda"):
    """Random UNet2DConditionModel parameters with the HF tree structure."""
    it = _Init(seed, dtype, device)
    bo = list(cfg.block_out_channels)
    temb_ch = bo[0] * 4
    tl = cfg.transformer_layers_per_block
    cross = cfg.cross_attention_dim

    params = {
        "conv_in": it.conv(3, 3, cfg.in_channels, bo[0]),
        "time_embedding": {
            "linear_1": it.dense(bo[0], temb_ch),
            "linear_2": it.dense(temb_ch, temb_ch),
        },
    }

    down = {}
    ch = bo[0]
    for i, (btype, out_ch) in enumerate(zip(cfg.down_block_types, bo)):
        blk = {"resnets": {}}
        if "CrossAttn" in btype:
            blk["attentions"] = {}
        for j in range(cfg.layers_per_block):
            blk["resnets"][str(j)] = _unet_resnet(it, ch if j == 0 else out_ch, out_ch, temb_ch)
            if "CrossAttn" in btype:
                blk["attentions"][str(j)] = _spatial_transformer(it, out_ch, tl, cross)
        ch = out_ch
        if i < len(bo) - 1:
            blk["downsamplers"] = {"0": {"conv": it.conv(3, 3, ch, ch)}}
        down[str(i)] = blk
    params["down_blocks"] = down

    params["mid_block"] = {
        "resnets": {
            "0": _unet_resnet(it, ch, ch, temb_ch),
            "1": _unet_resnet(it, ch, ch, temb_ch),
        },
        "attentions": {"0": _spatial_transformer(it, ch, tl, cross)},
    }

    rbo = list(reversed(bo))
    up = {}
    prev_out = rbo[0]
    for i, (btype, out_ch) in enumerate(zip(cfg.up_block_types, rbo)):
        skip_ch = rbo[min(i + 1, len(rbo) - 1)]
        blk = {"resnets": {}}
        if "CrossAttn" in btype:
            blk["attentions"] = {}
        n_res = cfg.layers_per_block + 1
        for j in range(n_res):
            res_skip = skip_ch if j == n_res - 1 else out_ch
            res_in = prev_out if j == 0 else out_ch
            blk["resnets"][str(j)] = _unet_resnet(it, res_in + res_skip, out_ch, temb_ch)
            if "CrossAttn" in btype:
                blk["attentions"][str(j)] = _spatial_transformer(it, out_ch, tl, cross)
        prev_out = out_ch
        if i < len(rbo) - 1:
            blk["upsamplers"] = {"0": {"conv": it.conv(3, 3, out_ch, out_ch)}}
        up[str(i)] = blk
    params["up_blocks"] = up

    params["conv_norm_out"] = it.norm(bo[0])
    params["conv_out"] = it.conv(3, 3, bo[0], cfg.out_channels)
    return params
