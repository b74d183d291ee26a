"""Weight porters: HF checkpoints on disk -> the port's parameter trees.

The reference downloads models through diffusers/transformers
from_pretrained (train/train_omgsr_s.py:215-228 etc.); these porters read
local checkpoint directories in the HF layout instead, through the port's
own safetensors reader (``convert/safetensors_io.py``), and a DINOv3 .pth
through ``torch.load(weights_only=True)``.

A diffusers/HF tensor is already in the port's layout (conv weights OIHW,
dense weights (out, in), norm ``weight``; see ``convert/params.py``), so the
conversion is the identity on the key paths, with conv weights kept in
``channels_last`` memory. Each porter checks the leaf paths and shapes
against the structure of the port's own ``init_*`` for the config, built on
the ``meta`` device (nothing is allocated), so a missing or mistyped key
fails loudly.
"""

from __future__ import annotations

import json
import os

import torch

from omgsr_tpu_torch.convert.params import _conv_weight
from omgsr_tpu_torch.convert.safetensors_io import load_file
from omgsr_tpu_torch.utils.devices import resolve_device
from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict


def load_safetensors_dir(path: str) -> dict:
    """Every tensor of a (possibly sharded) HF checkpoint directory, on the
    CPU. With a ``*.safetensors.index.json`` the shards it names are read;
    without one, every ``*.safetensors`` file of the directory, in sorted
    order (as the JAX package reads it: a directory that also holds the
    ``*.fp16.safetensors`` variant is read twice, and the file that sorts
    last wins each key)."""
    if os.path.isfile(path):
        return load_file(path)
    index = None
    for name in os.listdir(path):
        if name.endswith(".safetensors.index.json"):
            with open(os.path.join(path, name)) as f:
                index = json.load(f)
            break
    tensors = {}
    if index is not None:
        for shard in sorted(set(index["weight_map"].values())):
            tensors.update(load_file(os.path.join(path, shard)))
    else:
        for name in sorted(os.listdir(path)):
            if name.endswith(".safetensors"):
                tensors.update(load_file(os.path.join(path, name)))
    if not tensors:
        raise FileNotFoundError(f"no safetensors found under {path}")
    return tensors


def _convert(tensors: dict, *, skip: tuple = (), dtype=torch.float32, device="cuda") -> dict:
    """HF state dict -> the port's nested tree on ``device`` in ``dtype``.
    The layouts agree, so only conv weights change (to ``channels_last``);
    every 2-D weight, dense layer or embedding table, is kept as it is.
    ``skip`` names the keys (or key prefixes) that are dropped."""
    device = resolve_device(device)
    flat = {}
    for key, w in tensors.items():
        if any(key.startswith(s) or key == s for s in skip):
            continue
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight" and w.dim() not in (1, 2, 4):
            raise ValueError(f"unexpected weight rank {w.dim()} at {key}")
        t = w.to(device).to(dtype)  # the cast runs where the tensor lands
        if leaf == "weight" and t.dim() == 4:
            t = _conv_weight(t)
        flat[tuple(key.split("."))] = t
    return unflatten_dict(flat)


def _validate_against(params: dict, expected: dict, name: str):
    """Check leaf paths and shapes against the structure ``expected`` (a tree
    from the port's ``init_*`` on the meta device)."""
    got = {p: tuple(v.shape) for p, v in flatten_dict(params).items()}
    want = {p: tuple(v.shape) for p, v in flatten_dict(expected).items()}
    missing = sorted(set(want) - set(got))[:10]
    extra = sorted(set(got) - set(want))[:10]
    wrong = sorted(p for p in set(got) & set(want) if got[p] != want[p])[:10]
    if missing or extra or wrong:
        raise ValueError(
            f"{name} port mismatch:\n missing={missing}\n extra={extra}\n wrong_shapes="
            + str([(p, got[p], want[p]) for p in wrong])
        )
    return params


def port_diffusers_vae(path: str, cfg=None, dtype=torch.float32, validate: bool = True, device="cuda"):
    """<sd_path>/vae -> VAE parameter tree."""
    from omgsr_tpu_torch.convert.params import init_vae
    from omgsr_tpu_torch.models.configs import SD21_VAE

    device = resolve_device(device)
    cfg = cfg or SD21_VAE
    params = _convert(load_safetensors_dir(path), dtype=dtype, device=device)
    if validate:
        _validate_against(params, init_vae(0, cfg, dtype, "meta"), "vae")
    return params


def port_diffusers_unet(path: str, cfg=None, dtype=torch.float32, validate: bool = True, device="cuda"):
    """<sd_path>/unet -> UNet parameter tree."""
    from omgsr_tpu_torch.convert.params import init_unet
    from omgsr_tpu_torch.models.configs import SD21_UNET

    device = resolve_device(device)
    cfg = cfg or SD21_UNET
    params = _convert(load_safetensors_dir(path), dtype=dtype, device=device)
    if validate:
        _validate_against(params, init_unet(0, cfg, dtype, "meta"), "unet")
    return params


def port_flux_transformer(path: str, cfg=None, dtype=torch.bfloat16, validate: bool = True, device="cuda"):
    """<flux_path>/transformer -> FLUX DiT parameter tree (bf16 by default:
    the published 12B model is 23.8 GB in bf16 and twice that in f32)."""
    from omgsr_tpu_torch.convert.params import init_flux
    from omgsr_tpu_torch.models.configs import FLUX_DEV

    device = resolve_device(device)
    cfg = cfg or FLUX_DEV
    params = _convert(load_safetensors_dir(path), dtype=dtype, device=device)
    if validate:
        _validate_against(params, init_flux(0, cfg, dtype, "meta"), "flux")
    return params


def port_clip_text(path: str, cfg=None, dtype=torch.float32, validate: bool = True, device="cuda"):
    """<sd_path>/text_encoder -> CLIP text-encoder parameter tree (the
    position-id buffer and a text projection, where present, are dropped)."""
    from omgsr_tpu_torch.models.clip_text import init_clip_text
    from omgsr_tpu_torch.models.configs import SD21_CLIP

    device = resolve_device(device)
    cfg = cfg or SD21_CLIP
    params = _convert(
        load_safetensors_dir(path),
        skip=("text_model.embeddings.position_ids", "text_projection"),
        dtype=dtype,
        device=device,
    )
    if validate:
        _validate_against(params, init_clip_text(0, cfg, dtype, "meta"), "clip_text")
    return params


def port_clip_vision(path: str, cfg=None, dtype=torch.float32, validate: bool = True, device="cuda"):
    """An HF CLIPVisionModel[WithProjection] or full CLIPModel directory ->
    the vision tower's tree (the text tower and the position-id buffer
    dropped; ``visual_projection`` and the learned ``logit_scale`` kept where
    present). ``cfg`` defaults to the directory's own ``config.json``
    (``vision_config`` of a CLIPModel), else CLIP-L's."""
    from omgsr_tpu_torch.models.clip_vision import clip_vision_config_from_json, init_clip_vision

    device = resolve_device(device)
    cfg = cfg or clip_vision_config_from_json(path)
    params = _convert(load_safetensors_dir(path), skip=("text_model", "text_projection",
                                                        "vision_model.embeddings.position_ids"),
                      dtype=dtype, device=device)
    if "logit_scale" in params:
        params["logit_scale"] = params["logit_scale"].float().reshape(())
    if validate:
        expected = init_clip_vision(0, cfg, dtype, "meta", with_projection="visual_projection" in params)
        if "logit_scale" in params:
            expected["logit_scale"] = params["logit_scale"]
        _validate_against(params, expected, "clip_vision")
    return params


def port_t5_encoder(path: str, cfg=None, dtype=torch.bfloat16, validate: bool = True, device="cuda"):
    """<flux_path>/text_encoder_2 -> T5 encoder parameter tree (bf16 by
    default, as the JAX porter; ``encoder.embed_tokens`` is an alias of
    ``shared`` and is dropped)."""
    from omgsr_tpu_torch.convert.params import init_t5_encoder
    from omgsr_tpu_torch.models.configs import FLUX_T5_XXL

    device = resolve_device(device)
    cfg = cfg or FLUX_T5_XXL
    params = _convert(load_safetensors_dir(path), skip=("encoder.embed_tokens",), dtype=dtype, device=device)
    if validate:
        _validate_against(params, init_t5_encoder(0, cfg, dtype, "meta"), "t5")
    return params


def port_dinov3_convnext(pth_path, cfg=None, dtype=torch.float32, validate: bool = True, device="cuda"):
    """DINOv3 ConvNeXt .pth (or an already-loaded state dict) -> backbone
    parameter tree. Only the feature-extraction subtree OMGSR touches
    (downsample_layers + stages; dinov3_gan/dinov3_convnext_dists.py:63-70)
    and the model-level ``norm.`` are ported; ``norms.3`` is its alias."""
    from omgsr_tpu_torch.convert.params import init_convnext
    from omgsr_tpu_torch.models.configs import CONVNEXT_SIZES

    device = resolve_device(device)
    cfg = cfg or CONVNEXT_SIZES["large"]
    sd = pth_path if isinstance(pth_path, dict) else torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    # the JAX porter goes through f32 numpy arrays: the same values reach the cast here
    tensors = {k: v.float() for k, v in sd.items() if k.startswith(("downsample_layers", "stages", "norm."))}
    params = _convert(tensors, dtype=dtype, device=device)
    if validate:
        expected = init_convnext(0, cfg, dtype, "meta", with_final_norm="norm" in params)
        _validate_against(params, expected, "dinov3_convnext")
    return params


def port_dinov3_vit(pth_path, cfg=None, dtype=torch.float32, validate: bool = True, device="cuda"):
    """DINOv3 ViT hub .pth (or an already-loaded state dict) -> parameter
    tree for ``models/dinov3_vit.py`` (the hub/backbones.py:63-146 load path).

    The reference's LinearKMaskedBias stores a ``bias_mask`` buffer beside
    the qkv bias and multiplies them at every forward (dinov3/layers/
    attention.py:30-40); here the product is folded into the bias once, in
    f32, and a non-finite mask is refused. ``local_cls_norm``
    (untie_global_and_local_cls_norm) is a train-only head and is dropped
    (vision_transformer.py:171 "never used during eval"); ``head`` is
    Identity and stores nothing. The leaves are checked against
    ``init_dinov3_vit``'s shapes."""
    from omgsr_tpu_torch.convert.params import init_dinov3_vit
    from omgsr_tpu_torch.models.configs import VIT_SIZES

    device = resolve_device(device)
    cfg = cfg or VIT_SIZES["vitl16"]
    sd = pth_path if isinstance(pth_path, dict) else torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    tensors = {}
    for k, v in sd.items():
        if k.startswith("local_cls_norm") or k.endswith(".bias_mask"):
            continue
        w = v.float()
        if k.endswith(".bias") and f"{k}_mask" in sd:
            mask = sd[f"{k}_mask"].float()
            if not torch.isfinite(mask).all():
                raise ValueError(f"{k}_mask contains non-finite values (uninitialized buffer?): refusing to "
                                 "fold it into the bias")
            w = w * mask
        tensors[k] = w
    params = _convert(tensors, dtype=dtype, device=device)
    if validate:
        _validate_against(params, init_dinov3_vit(0, cfg, dtype, "meta"), "dinov3_vit")
    return params
