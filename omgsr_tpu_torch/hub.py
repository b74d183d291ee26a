"""One-call model constructors mirroring the reference torch.hub entry points.

The reference exports, via torch.hub (``hubconf.py``, dinov3/hub/*.py),
11 backbones (7 ViT + 4 ConvNeXt), a linear classifier
(``dinov3_vit7b16_lc``), a DPT depther, a Mask2Former segmentor, a
Plain-DETR detector and the DINOTxt text-alignment model. This module
provides the backbones and the linear classifier under the same names, in
the port's functional style; the depther, segmentor, detector and dinotxt
entry points come with the slices that port their heads (ROADMAP.md Queue 1
items 3.3-3.4).

As in the JAX package's hub, by design:
- ``weights=`` / ``backbone_weights=`` take LOCAL ``.pth`` paths or
  in-memory torch state dicts (through the porters); ``None`` is a random
  init from ``seed`` (the reference's ``pretrained=False``);
- each entry point returns a ``HubModel``: one parameter tree (the frozen
  backbone under ``params["backbone"]``) and ``apply(params, x)`` over NHWC
  images;
- keyword overrides of the config make tiny sizes constructible; the
  defaults are the hub's configurations.

Every entry point takes ``device`` (the CUDA device unless ``"cpu"`` is asked
for) and ``dtype``.

Reference: hubconf.py:6-25; dinov3/hub/backbones.py:201-616,
classifiers.py:25-120.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from omgsr_tpu_torch.models.configs import CONVNEXT_SIZES, VIT_SIZES, DinoV3ViTConfig
from omgsr_tpu_torch.utils.devices import resolve_device

__all__ = [
    "HubModel",
    # backbones (hubconf.py:6-18)
    "dinov3_vits16",
    "dinov3_vits16plus",
    "dinov3_vitb16",
    "dinov3_vitl16",
    "dinov3_vitl16plus",
    "dinov3_vith16plus",
    "dinov3_vit7b16",
    "dinov3_convnext_tiny",
    "dinov3_convnext_small",
    "dinov3_convnext_base",
    "dinov3_convnext_large",
    # downstream models (hubconf.py:19-25)
    "dinov3_vit7b16_lc",
]


@dataclasses.dataclass
class HubModel:
    """params: full tree (frozen backbone at params['backbone']);
    apply(params, x): the model's main forward; cfgs: every config by name;
    extras: secondary entry points."""

    params: Any
    cfgs: dict
    apply: Callable
    extras: dict = dataclasses.field(default_factory=dict)


def _as_state_dict(weights):
    """LOCAL .pth path or an in-memory state dict -> plain dict."""
    sd = weights if isinstance(weights, dict) else torch.load(weights, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


# ---------------------------------------------------------------------------
# backbones (dinov3/hub/backbones.py:201-616)
# ---------------------------------------------------------------------------


def _vit_backbone(arch, weights, seed, dtype, device, overrides):
    from omgsr_tpu_torch.convert.params import init_dinov3_vit
    from omgsr_tpu_torch.convert.porters import port_dinov3_vit

    # an unknown arch (e.g. "custom") starts from the config defaults: the
    # overrides then define the size
    cfg = VIT_SIZES.get(arch, DinoV3ViTConfig())
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if weights is not None:
        params = port_dinov3_vit(weights, cfg=cfg, dtype=dtype, device=device)
    else:
        params = init_dinov3_vit(seed, cfg, dtype, device)
    return params, cfg


def _make_vit_entry(arch):
    def entry(*, weights=None, seed: int = 0, dtype=torch.float32, device="cuda", **overrides):
        from omgsr_tpu_torch.models.dinov3_vit import dinov3_vit_apply, get_intermediate_layers

        device = resolve_device(device)
        params, cfg = _vit_backbone(arch, weights, seed, dtype, device, overrides)

        def apply(p, x, **kw):
            return dinov3_vit_apply(p["backbone"], cfg, x, **kw)

        def features(p, x, **kw):
            return get_intermediate_layers(p["backbone"], cfg, x, **kw)

        return HubModel(params={"backbone": params}, cfgs={"backbone": cfg}, apply=apply,
                        extras={"get_intermediate_layers": features})

    entry.__name__ = entry.__qualname__ = f"dinov3_{arch}"
    entry.__doc__ = (
        f"DINOv3 ViT backbone '{arch}' (dinov3/hub/backbones.py size entry points). apply(params, x) == "
        "forward_features; extras['get_intermediate_layers'] mirrors the torch method."
    )
    return entry


dinov3_vits16 = _make_vit_entry("vits16")
dinov3_vits16plus = _make_vit_entry("vits16plus")
dinov3_vitb16 = _make_vit_entry("vitb16")
dinov3_vitl16 = _make_vit_entry("vitl16")
dinov3_vitl16plus = _make_vit_entry("vitl16plus")
dinov3_vith16plus = _make_vit_entry("vith16plus")
dinov3_vit7b16 = _make_vit_entry("vit7b16")


def _make_convnext_entry(size):
    def entry(*, weights=None, seed: int = 0, dtype=torch.float32, device="cuda", **overrides):
        from omgsr_tpu_torch.convert.params import init_convnext
        from omgsr_tpu_torch.convert.porters import port_dinov3_convnext
        from omgsr_tpu_torch.models.convnext import convnext_features, convnext_forward_features

        device = resolve_device(device)
        cfg = CONVNEXT_SIZES[size]
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if weights is not None:
            params = port_dinov3_convnext(weights, cfg=cfg, dtype=dtype, device=device)
        else:
            params = init_convnext(seed, cfg, dtype, device, with_final_norm=True)

        def apply(p, x, num_stages: int = 4):
            return convnext_features(p["backbone"], x, num_stages=num_stages)

        def forward_features(p, x):
            return convnext_forward_features(p["backbone"], x)

        return HubModel(params={"backbone": params}, cfgs={"backbone": cfg}, apply=apply,
                        extras={"forward_features": forward_features})

    entry.__name__ = entry.__qualname__ = f"dinov3_convnext_{size}"
    entry.__doc__ = (
        f"DINOv3 ConvNeXt-{size} backbone (dinov3/hub/backbones.py:497-616). apply(params, x) -> per-stage "
        "feature maps."
    )
    return entry


dinov3_convnext_tiny = _make_convnext_entry("tiny")
dinov3_convnext_small = _make_convnext_entry("small")
dinov3_convnext_base = _make_convnext_entry("base")
dinov3_convnext_large = _make_convnext_entry("large")


# ---------------------------------------------------------------------------
# linear classifier (dinov3/hub/classifiers.py:25-120)
# ---------------------------------------------------------------------------


def dinov3_vit7b16_lc(
    *,
    weights=None,
    backbone_weights=None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    num_classes: int = 1000,
    backbone_arch: str = "vit7b16",
    backbone_overrides: Optional[dict] = None,
):
    """ImageNet linear classifier over a frozen ViT backbone: logits =
    Linear(cat([cls_token, mean(patch_tokens)])) (classifiers.py:52-70,
    head 2*embed_dim -> 1000 at :26-35). A random head is N(0, 1/(2D)) from
    ``seed + 1`` with a zero bias."""
    from omgsr_tpu_torch.models.dinov3_vit import dinov3_vit_apply
    from omgsr_tpu_torch.models.layers import dense

    device = resolve_device(device)
    bb, cfg = _vit_backbone(backbone_arch, backbone_weights, seed, dtype, device, backbone_overrides)
    d = 2 * cfg.embed_dim
    if weights is not None:
        sd = _as_state_dict(weights)
        head = {"weight": torch.as_tensor(sd["weight"]).float().to(device, dtype),
                "bias": torch.as_tensor(sd["bias"]).float().to(device, dtype)}
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) + 1)
        w = torch.empty((num_classes, d), dtype=torch.float32, device=device).normal_(0.0, d ** -0.5, generator=gen)
        head = {"weight": w.to(dtype), "bias": torch.zeros((num_classes,), dtype=dtype, device=device)}

    def apply(p, x):
        with torch.no_grad():  # the backbone is frozen (stop_gradient in the JAX hub)
            f = dinov3_vit_apply(p["backbone"], cfg, x)
        z = torch.cat([f["x_norm_clstoken"], f["x_norm_patchtokens"].mean(dim=1)], dim=-1)
        h = p["linear_head"]
        return dense({"weight": h["weight"].to(z.dtype), "bias": h["bias"].to(z.dtype)}, z)

    return HubModel(params={"backbone": bb, "linear_head": head}, cfgs={"backbone": cfg}, apply=apply)
