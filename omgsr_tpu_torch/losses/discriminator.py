"""Vision-aided GAN discriminator on frozen DINOv3-ConvNeXt features.

Re-implements dinov3_gan/dinov3_convnext_disc.py:80-279 functionally:
  * DiffAugment on the input image (:275);
  * frozen ConvNeXt first-3-stage features (:179-192);
  * per-level trainable decoder heads: N x [BlurPool(zero-pad, filt 4,
    stride 2) -> spectral-norm Conv3x3(stride s) -> LeakyReLU(0.2)] +
    BlurPool -> SN-Conv1x1 -> 1-logit map (:217-234), with different
    (channel-ratio, stride) configs for 512 vs 1024 resolution (:203-215);
  * multi-level BCE-with-logits, soft real label alpha=0.8 (:239-260, :270).

Spectral norm keeps an explicit power-iteration vector ``u`` per conv in a
separate state tree (torch hides this in a forward pre-hook); one iteration
runs per apply. As in the JAX package, ``u`` and the new ``u`` carry no
gradient but ``v`` does, so sigma's gradient also flows through ``v`` into
the weight: this is not ``torch.nn.utils.spectral_norm``, which detaches
both vectors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from omgsr_tpu_torch.losses.diffaug import diff_augment
from omgsr_tpu_torch.losses.dists import depthwise_filter
from omgsr_tpu_torch.models.convnext import convnext_features, normalize_from_pm1

_BLUR4 = np.asarray([1.0, 3.0, 3.0, 1.0])
_BLUR4 = np.outer(_BLUR4, _BLUR4)
_BLUR4 = (_BLUR4 / _BLUR4.sum()).astype(np.float32)


def blur_pool(x, stride: int = 2):
    """Antialiased downsample: zero-pad 1, 4x4 binomial filter, stride 2
    (BlurPool(pad_type='zero'), dinov3_gan/dinov3_convnext_disc.py:80-119)."""
    return depthwise_filter(x, _BLUR4, stride, 1)


def _head_configs(resolution: int):
    """(channel_ratios, strides) per level (reference :203-215)."""
    if resolution == 1024:
        return [
            ([0.5, 1.0, 1.0, 1.0], [1, 2, 2, 2]),
            ([0.5, 0.5, 1.0, 1.0], [1, 1, 2, 2]),
            ([0.5, 0.5, 0.5, 1.0], [1, 1, 1, 2]),
        ]
    return [
        ([0.5, 1.0, 1.0], [2, 2, 2]),
        ([0.5, 0.5, 1.0], [1, 2, 2]),
        ([0.5, 0.5, 0.5], [1, 1, 2]),
    ]


def _spectral_normalize(weight, u, eps=1e-12):
    """One power iteration; returns (W/sigma, new_u). weight OIHW; with W2d
    the (fan_in, out) matrix of the JAX package (rows ordered kh, kw, in)."""
    w2d = weight.float().permute(2, 3, 1, 0).reshape(-1, weight.shape[0])  # (fan_in, out)
    u = u.detach()
    v = w2d @ u
    v = v / (torch.linalg.vector_norm(v) + eps)
    u_new = w2d.t() @ v
    u_new = (u_new / (torch.linalg.vector_norm(u_new) + eps)).detach()
    sigma = v @ (w2d @ u_new)
    return (weight.float() / sigma).to(weight.dtype), u_new


def _sn_conv(p, u, x, stride, padding):
    wn, u_new = _spectral_normalize(p["weight"], u)
    y = F.conv2d(x.permute(0, 3, 1, 2), wn.to(x.dtype), p["bias"].to(x.dtype), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1), u_new


def _head_apply(params, sn_state, strides, x):
    new_state = {}
    for j, stride in enumerate(strides):
        if min(x.shape[1], x.shape[2]) < 2:
            raise ValueError(
                "discriminator head input collapsed to zero spatial size: "
                f"feature map {tuple(x.shape)} too small for this resolution's head "
                "config; the input image must match the configured resolution"
            )
        x = blur_pool(x)
        x, u = _sn_conv(params[str(j)], sn_state[str(j)]["u"], x, stride, 1)
        new_state[str(j)] = {"u": u}
        x = F.leaky_relu(x, 0.2)
    x = blur_pool(x)
    x, u = _sn_conv(params["final"], sn_state["final"]["u"], x, 1, 0)
    new_state["final"] = {"u": u}
    return x[..., 0], new_state  # logit map (B, h, w)


def _multi_level_bce(logits, for_real: bool, for_G: bool, alpha: float = 0.8):
    """Soft-label BCE summed over levels, spatial-meaned per sample
    (MultiLevelBCELoss, reference :239-260)."""
    if for_G:
        for_real = True
    target = alpha if for_real else 0.0
    loss = 0.0
    for l in logits:
        l32 = l.float()
        # BCEWithLogits: max(l,0) - l*t + log(1+exp(-|l|))
        per = torch.clamp(l32, min=0) - l32 * target + torch.log1p(torch.exp(-torch.abs(l32)))
        loss = loss + per.mean(dim=(1, 2))
    return loss.mean()


def discriminator_loss(
    disc_params,
    sn_state,
    strides_meta,
    backbone_params,
    draws,
    x,
    for_real: bool = True,
    for_G: bool = False,
    policy: str = "color,translation,cutout",
    alpha: float = 0.8,
):
    """Full discriminator forward: DiffAugment (with the given
    ``diffaug.DiffAugDraws``) -> frozen ConvNeXt feats -> SN heads ->
    multi-level BCE. Returns (scalar loss, new_sn_state)."""
    x = diff_augment(x, draws, policy)
    h = normalize_from_pm1(x)
    feats = convnext_features(backbone_params, h, num_stages=3)
    logits = []
    new_state = {"decoders": {}}
    for li in sorted(disc_params["decoders"], key=int):
        lg, ns = _head_apply(
            disc_params["decoders"][li], sn_state["decoders"][li], strides_meta[li], feats[int(li)]
        )
        logits.append(lg)
        new_state["decoders"][li] = ns
    return _multi_level_bce(logits, for_real, for_G, alpha), new_state
