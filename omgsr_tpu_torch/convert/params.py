"""The weight bridge and the seed-based initialisers.

The JAX package's parameter trees nest dicts by HF key paths with conv
``kernel`` HWIO, dense ``kernel`` (in, out) and norm ``scale``. The port
keeps the key paths and stores every leaf in torch layout: conv ``weight``
OIHW (kept in channels_last memory format, since activations are NHWC),
dense ``weight`` (out, in), norm ``weight``. LoRA leaves follow the same
rule: conv ``lora_A`` (kh,kw,in,r) -> (r,in,kh,kw), ``lora_B`` (1,1,r,out) ->
(out,r,1,1), dense ``lora_A`` (in,r) -> (r,in), ``lora_B`` (r,out) -> (out,r);
a depthwise kernel (kh,kw,1,C) becomes (C,1,kh,kw). ``from_jax_tree`` converts
a tree of numpy arrays and ``to_jax_tree`` goes back (torch -> numpy in the
JAX layout); ``init_vae`` / ``init_unet`` / ``init_flux`` / ``init_convnext`` /
``init_dinov3_vit`` / ``init_discriminator`` / ``init_t5_encoder`` build trees of the same structure from a seed
(torch's default Linear/Conv2d distribution, and for the FLUX DiT the JAX
package's wider weight bound; the values differ from the JAX initialisers',
so parity tests always carry the JAX weights across the
bridge). On the ``meta`` device they allocate and draw nothing: the porters
take the expected structure from them that way. ``to_hf_state_dict`` flattens
a tree into the diffusers/HF state dict (dotted keys, contiguous tensors),
the inverse of ``convert/porters.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from omgsr_tpu_torch.models.configs import (
    ConvNeXtConfig,
    DinoV3ViTConfig,
    FluxConfig,
    T5Config,
    UNetConfig,
    VAEConfig,
)
from omgsr_tpu_torch.utils.devices import resolve_device


def _conv_weight(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous(memory_format=torch.channels_last)


def _unstacked(stacked):
    """A scan-stacked subtree (every leaf with a leading block axis, the JAX
    package's ``stack_block_params``) -> {"0": ..., "N-1": ...}."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))

    def take(node, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i] for k, v in node.items()}

    return {str(i): take(stacked, i) for i in range(int(np.shape(leaf)[0]))}


def from_jax_tree(tree, dtype=None, device="cuda"):
    """Nested dict of numpy arrays in the JAX package's layout -> nested dict
    of tensors in the port's layout, same key paths. A scan-stacked block
    group (``{"stacked": ...}``, as under the FLUX DiT's
    ``transformer_blocks``) is unstacked along axis 0 into "0".."N-1". A
    quantised layer's ``kernel_q`` / ``kernel_q4`` / ``kernel_scale`` become
    ``weight_q`` / ``weight_q4`` / ``weight_scale`` transposed to (out, ...)
    (int4's nibble pairs stay in their bytes) in their own dtypes, whatever
    ``dtype`` says, and an ``act_quant`` marker is kept. The DINOv3 ViT's
    RoPE ``periods`` stay f32, as its initialiser makes them."""
    device = resolve_device(device)

    def leaf(key, arr):
        t = torch.from_numpy(np.array(arr, copy=True))
        # quantised dense layers (utils/quantize.py): integer codes keep their dtype, scales stay f32
        if key in ("kernel_q", "kernel_q4"):  # (in, out) / (in/2, out) -> (out, in) / (out, in/2)
            return key.replace("kernel", "weight"), t.t().contiguous().to(device)
        if key == "kernel_scale":  # per channel (out,) or per group (in/g, out) -> (out, in/g)
            return "weight_scale", t.t().contiguous().to(device) if t.dim() == 2 else t.to(device)
        if key == "act_quant":
            return key, t.to(device)
        if key == "periods":
            return key, t.to(device=device, dtype=torch.float32)
        if key in ("lora_A", "lora_B"):
            if t.dim() == 4:
                return key, _conv_weight(t.permute(3, 2, 0, 1).to(device=device, dtype=dtype))
            if t.dim() == 2:
                return key, t.t().contiguous().to(device=device, dtype=dtype)
            raise ValueError(f"{key} of rank {t.dim()} has no torch layout here")
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
                out[k] = walk(_unstacked(v["stacked"]) if set(v) == {"stacked"} else v)
            else:
                nk, t = leaf(k, v)
                out[nk] = t
        return out

    return walk(tree)


def to_jax_tree(tree):
    """The way back: nested dict of tensors in the port's layout -> nested
    dict of f32 numpy arrays in the JAX package's layout (``weight`` of rank 4
    -> ``kernel`` HWIO, of rank 2 -> ``kernel`` (in, out), of rank 1 ->
    ``scale``; LoRA leaves transposed back; the codes and scales of a
    quantised layer transposed back in their own dtypes; everything else as
    it is)."""

    def leaf(key, t):
        if key in ("weight_q", "weight_q4", "weight_scale", "act_quant"):  # dtypes kept, as stored
            a = t.detach().cpu()
            return key.replace("weight", "kernel"), (a.t() if a.dim() == 2 else a).contiguous().numpy()
        a = t.detach().float().cpu()
        if key in ("weight", "lora_A", "lora_B"):
            name = "kernel" if key == "weight" else key
            if a.dim() == 4:
                return name, a.permute(2, 3, 1, 0).contiguous().numpy()
            if a.dim() == 2:
                return name, a.t().contiguous().numpy()
            if key == "weight" and a.dim() == 1:
                return "scale", a.numpy()
            raise ValueError(f"{key} of rank {a.dim()} has no JAX layout here")
        return key, a.numpy()

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                nk, a = leaf(k, v)
                out[nk] = a
        return out

    return walk(tree)


def to_hf_state_dict(tree, dtype=None) -> dict:
    """Nested dict of tensors in the port's layout -> the flat diffusers/HF
    state dict of a checkpoint file: dotted keys, every tensor contiguous
    (conv weights OIHW), cast to ``dtype`` when given. The porters read it
    back to the same tree."""
    from omgsr_tpu_torch.utils.tree import flatten_dict

    out = {}
    for path, t in flatten_dict(tree).items():
        t = t.detach()
        if dtype is not None:
            t = t.to(dtype)
        out[".".join(path)] = t.contiguous()
    return out


# ----------------------------------------------------------------------------
# seed-based initialisers (torch-default: kaiming uniform, fan_in, a=sqrt(5))
# ----------------------------------------------------------------------------


class _Init:
    """Draws from ``seed``: an integer, or a torch.Generator that lives on
    ``device`` and is advanced."""

    def __init__(self, seed, dtype, device):
        self.device = resolve_device(device)
        self.dtype = dtype
        if isinstance(seed, torch.Generator):
            self.gen = seed
        elif self.device.type == "meta":  # shapes only: nothing is drawn
            self.gen = None
        else:
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def _uniform(self, shape, bound):
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.gen is not None:
            t.uniform_(-bound, bound, generator=self.gen)
        return t.to(self.dtype)

    def normal(self, shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.gen is not None:
            t.normal_(0.0, std, generator=self.gen)
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


def _flux_dense(it: _Init, in_dim, out_dim):
    # the JAX package's init_dense: weight U(+-sqrt(3 / fan_in)), bias U(+-1 / sqrt(fan_in))
    return {"weight": it._uniform((out_dim, in_dim), math.sqrt(3.0 / in_dim)),
            "bias": it._uniform((out_dim,), 1.0 / math.sqrt(in_dim))}


def _flux_mlp_embedder(it: _Init, in_dim, dim):
    return {"linear_1": _flux_dense(it, in_dim, dim), "linear_2": _flux_dense(it, dim, dim)}


def _flux_rms(it: _Init, dim):
    return {"weight": torch.ones(dim, dtype=it.dtype, device=it.device)}


def _flux_ff(it: _Init, dim, mlp):
    return {"net": {"0": {"proj": _flux_dense(it, dim, mlp)}, "2": _flux_dense(it, mlp, dim)}}


def _flux_dual_block(it: _Init, cfg: FluxConfig):
    dim, hd = cfg.inner_dim, cfg.attention_head_dim
    mlp = int(dim * cfg.mlp_ratio)
    return {
        "norm1": {"linear": _flux_dense(it, dim, 6 * dim)},
        "norm1_context": {"linear": _flux_dense(it, dim, 6 * dim)},
        "attn": {
            **{name: _flux_dense(it, dim, dim)
               for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj")},
            **{name: _flux_rms(it, hd) for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k")},
            "to_out": {"0": _flux_dense(it, dim, dim)},
            "to_add_out": _flux_dense(it, dim, dim),
        },
        "ff": _flux_ff(it, dim, mlp),
        "ff_context": _flux_ff(it, dim, mlp),
    }


def _flux_single_block(it: _Init, cfg: FluxConfig):
    dim, hd = cfg.inner_dim, cfg.attention_head_dim
    mlp = int(dim * cfg.mlp_ratio)
    return {
        "norm": {"linear": _flux_dense(it, dim, 3 * dim)},
        "attn": {**{name: _flux_dense(it, dim, dim) for name in ("to_q", "to_k", "to_v")},
                 "norm_q": _flux_rms(it, hd), "norm_k": _flux_rms(it, hd)},
        "proj_mlp": _flux_dense(it, dim, mlp),
        "proj_out": _flux_dense(it, dim + mlp, dim),
    }


def init_flux(seed, cfg: FluxConfig, dtype=torch.float32, device="cuda", finish=None):
    """Random FluxTransformer2DModel parameters with the HF tree structure and
    the JAX package's init family (``omgsr_tpu/models/flux.py init_flux``).
    Each tensor is drawn in f32 on ``device`` and cast to ``dtype`` before the
    next is drawn, so the full-size tree in bf16 never exists in f32.
    ``finish(name, part)`` is applied to each top-level part and each block
    as soon as it is drawn (``utils/quantize.init_flux_quantized`` quantises
    there)."""
    it = _Init(seed, dtype, device)
    finish = finish or (lambda name, part: part)
    dim = cfg.inner_dim
    tte = {"timestep_embedder": _flux_mlp_embedder(it, 256, dim),
           "text_embedder": _flux_mlp_embedder(it, cfg.pooled_projection_dim, dim)}
    if cfg.guidance_embeds:
        tte["guidance_embedder"] = _flux_mlp_embedder(it, 256, dim)
    return {
        "x_embedder": finish("x_embedder", _flux_dense(it, cfg.in_channels, dim)),
        "context_embedder": finish("context_embedder", _flux_dense(it, cfg.joint_attention_dim, dim)),
        "time_text_embed": finish("time_text_embed", tte),
        "transformer_blocks": {str(i): finish(str(i), _flux_dual_block(it, cfg)) for i in range(cfg.num_layers)},
        "single_transformer_blocks": {str(i): finish(str(i), _flux_single_block(it, cfg))
                                      for i in range(cfg.num_single_layers)},
        "norm_out": finish("norm_out", {"linear": _flux_dense(it, dim, 2 * dim)}),
        "proj_out": finish("proj_out", _flux_dense(it, dim, cfg.in_channels)),
    }


def _t5_block(it: _Init, cfg: T5Config, has_rel_bias: bool):
    inner = cfg.num_heads * cfg.d_kv

    def dense(i, o):
        return it.dense(i, o, use_bias=False)

    attn = {"q": dense(cfg.d_model, inner), "k": dense(cfg.d_model, inner), "v": dense(cfg.d_model, inner),
            "o": dense(inner, cfg.d_model)}
    if has_rel_bias:
        attn["relative_attention_bias"] = {"weight": it.normal((cfg.relative_attention_num_buckets, cfg.num_heads),
                                                               0.02)}
    norm = {"weight": torch.ones(cfg.d_model, dtype=it.dtype, device=it.device)}
    return {"layer": {
        "0": {"SelfAttention": attn, "layer_norm": norm},
        "1": {"DenseReluDense": {"wi_0": dense(cfg.d_model, cfg.d_ff), "wi_1": dense(cfg.d_model, cfg.d_ff),
                                 "wo": dense(cfg.d_ff, cfg.d_model)},
              "layer_norm": dict(norm)},
    }}


def init_t5_encoder(seed, cfg: T5Config, dtype=torch.float32, device="cuda"):
    """Random T5 encoder parameters with the HF tree structure (``shared`` +
    ``encoder.*``; models/t5.py): the token table N(0, 1) and the relative
    position table N(0, 0.02) as in the JAX package's initialiser, dense
    layers torch's default without bias, RMS norms 1. Each tensor is drawn in
    f32 and cast before the next, so the 4.76B T5-XXL in bf16 never exists in
    f32."""
    it = _Init(seed, dtype, device)
    return {
        "shared": {"weight": it.normal((cfg.vocab_size, cfg.d_model), 1.0)},
        "encoder": {
            "block": {str(i): _t5_block(it, cfg, i == 0) for i in range(cfg.num_layers)},
            "final_layer_norm": {"weight": torch.ones(cfg.d_model, dtype=dtype, device=it.device)},
        },
    }


def _convnext_block(it: _Init, dim, ls_init):
    return {
        "dwconv": it.conv(7, 7, 1, dim),  # depthwise: (C, 1, 7, 7)
        "norm": it.norm(dim),
        "pwconv1": it.dense(dim, 4 * dim),
        "pwconv2": it.dense(4 * dim, dim),
        "gamma": torch.full((dim,), ls_init, dtype=it.dtype, device=it.device),
    }


def init_convnext(seed, cfg: ConvNeXtConfig, dtype=torch.float32, device="cuda", num_stages: int = 4,
                  with_final_norm: bool = False):
    """Random DINOv3-ConvNeXt parameters with the torch module tree's paths
    (downsample_layers.0.0, stages.2.5.dwconv, ...). ``with_final_norm`` adds
    the model-level LayerNorm (``norm``) that a published checkpoint holds and
    the DISTS / discriminator feature extractors never reach."""
    it = _Init(seed, dtype, device)
    dims = list(cfg.dims)
    params = {"downsample_layers": {}, "stages": {}}
    if with_final_norm:
        params["norm"] = it.norm(dims[-1])
    # stem: conv 4x4/s4 + channels-first LN
    params["downsample_layers"]["0"] = {"0": it.conv(4, 4, 3, dims[0]), "1": it.norm(dims[0])}
    for i in range(1, num_stages):
        params["downsample_layers"][str(i)] = {
            "0": it.norm(dims[i - 1]),
            "1": it.conv(2, 2, dims[i - 1], dims[i]),
        }
    for i in range(num_stages):
        params["stages"][str(i)] = {
            str(j): _convnext_block(it, dims[i], cfg.layer_scale_init_value)
            for j in range(cfg.depths[i])
        }
    return params


def _vit_block(it: _Init, cfg: DinoV3ViTConfig):
    d = cfg.embed_dim
    p = {
        "norm1": it.norm(d),
        "attn": {"qkv": it.dense(d, 3 * d, use_bias=cfg.qkv_bias), "proj": it.dense(d, d)},
        "ls1": {"gamma": torch.full((d,), cfg.layerscale_init, dtype=it.dtype, device=it.device)},
        "norm2": it.norm(d),
        "ls2": {"gamma": torch.full((d,), cfg.layerscale_init, dtype=it.dtype, device=it.device)},
    }
    if cfg.ffn_layer == "mlp":
        hidden = int(d * cfg.ffn_ratio)
        p["mlp"] = {"fc1": it.dense(d, hidden), "fc2": it.dense(hidden, d)}
    else:
        hidden = cfg.swiglu_hidden
        p["mlp"] = {"w1": it.dense(d, hidden), "w2": it.dense(d, hidden), "w3": it.dense(hidden, d)}
    return p


def init_dinov3_vit(seed, cfg: DinoV3ViTConfig, dtype=torch.float32, device="cuda"):
    """Random DINOv3 ViT parameters with the hub state dict's paths
    (``blocks.0.attn.qkv``, ...; blocks keyed "0".."depth-1") and the JAX
    initialiser's shapes: the cls and register tokens N(0, 0.02), the mask
    token 0, LayerScale ``layerscale_init``, the RoPE ``periods`` in f32
    whatever ``dtype`` says, dense and conv layers torch's default. Each
    tensor is drawn in f32 and cast before the next, so the 6.7B ViT-7B in
    bf16 never exists in f32."""
    from omgsr_tpu_torch.models.dinov3_vit import rope_periods

    it = _Init(seed, dtype, device)
    d = cfg.embed_dim
    params = {
        "cls_token": it.normal((1, 1, d), 0.02),
        "mask_token": torch.zeros((1, d), dtype=dtype, device=it.device),
        "patch_embed": {"proj": it.conv(cfg.patch_size, cfg.patch_size, cfg.in_chans, d)},
        "rope_embed": {"periods": torch.as_tensor(rope_periods(cfg), dtype=torch.float32).to(it.device)},
    }
    if cfg.n_storage_tokens > 0:
        params["storage_tokens"] = it.normal((1, cfg.n_storage_tokens, d), 0.02)
    params["blocks"] = {str(i): _vit_block(it, cfg) for i in range(cfg.depth)}
    params["norm"] = it.norm(d)
    if cfg.untie_cls_and_patch_norms:
        params["cls_norm"] = it.norm(d)
    return params


def init_discriminator(seed, channels, resolution: int = 512, dtype=torch.float32, device="cuda",
                       configs=None):
    """channels: first-3-stage ConvNeXt dims, e.g. (192, 384, 768) for large.

    Returns (params, sn_state, strides_meta): trainable head params,
    spectral-norm u vectors (f32 standard normals), per-level stride lists.
    ``configs`` overrides the resolution-keyed head depth (tiny shapes)."""
    from omgsr_tpu_torch.losses.discriminator import _head_configs

    it = _Init(seed, dtype, device)

    def u_vector(n):
        return torch.randn((n,), generator=it.gen, device=it.device, dtype=torch.float32)

    params = {"decoders": {}}
    sn_state = {"decoders": {}}
    cfgs = configs if configs is not None else _head_configs(resolution)
    for li, (ch, (ratios, strides)) in enumerate(zip(channels, cfgs)):
        layers, ulayers = {}, {}
        cur = ch
        for j, ratio in enumerate(ratios):
            out = int(cur * ratio)
            layers[str(j)] = it.conv(3, 3, cur, out)
            ulayers[str(j)] = {"u": u_vector(out)}
            cur = out
        layers["final"] = it.conv(1, 1, cur, 1)
        ulayers["final"] = {"u": u_vector(1)}
        params["decoders"][str(li)] = layers
        sn_state["decoders"][str(li)] = ulayers
    meta = {str(li): list(cfgs[li][1]) for li in range(len(channels))}
    return params, sn_state, meta
