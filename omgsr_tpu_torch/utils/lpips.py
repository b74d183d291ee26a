"""LPIPS perceptual metric (Zhang et al. 2018), VGG16 backbone.

SR papers report LPIPS-VGG beside PSNR/SSIM on the RealSR/DRealSR
protocols. The VGG16 feature stack and the learned linear calibration are
owned here (no torchvision or lpips package), with a porter from the official
checkpoint layouts: a torchvision ``vgg16`` state dict and the ``lpips``
package's ``vgg.pth`` linear weights. Parameters are nested dicts keyed like
the source checkpoints (``features.<idx>.weight`` OIHW), images NHWC in
[-1, 1], as in the JAX package (whose trees hold the same convs HWIO).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from omgsr_tpu_torch.utils.devices import resolve_device

# torchvision vgg16 `features` conv indices, grouped by slice; LPIPS taps the
# activations at relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3 (a 2x2/2
# max-pool sits between consecutive slices)
VGG16_SLICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
VGG16_CHANNELS = (64, 128, 256, 512, 512)

# the official ScalingLayer constants (inputs already in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_lpips(seed, dtype=torch.float32, device="cuda"):
    """Random-weight LPIPS tree from ``seed`` (an integer, or a
    torch.Generator on ``device``): conv weights N(0, 1) / sqrt(9 cin), zero
    biases, linear weights U(0, 2 / C). Scores are self-consistent, not
    comparable to published numbers: port real checkpoints with ``port_lpips``."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=device).manual_seed(int(seed))
    feats = {}
    cin = 3
    for slice_idxs, cout in zip(VGG16_SLICES, VGG16_CHANNELS):
        for idx in slice_idxs:
            w = torch.randn((cout, cin, 3, 3), generator=gen, device=device) / math.sqrt(9 * cin)
            feats[str(idx)] = {"weight": w.to(dtype), "bias": torch.zeros(cout, dtype=dtype, device=device)}
            cin = cout
    lins = {str(i): (torch.rand(c, generator=gen, device=device) * (2.0 / c)).to(dtype)
            for i, c in enumerate(VGG16_CHANNELS)}
    return {"features": feats, "lins": lins}


def vgg_slices(features, x_pm1):
    """x in [-1, 1] NHWC -> the five LPIPS tap activations (post-ReLU), NCHW."""
    shift = torch.tensor(_SHIFT, dtype=x_pm1.dtype, device=x_pm1.device)
    scale = torch.tensor(_SCALE, dtype=x_pm1.dtype, device=x_pm1.device)
    h = ((x_pm1 - shift) / scale).permute(0, 3, 1, 2)
    taps = []
    for si, slice_idxs in enumerate(VGG16_SLICES):
        if si:
            h = F.max_pool2d(h, 2)
        for idx in slice_idxs:
            p = features[str(idx)]
            h = F.relu(F.conv2d(h, p["weight"].to(h.dtype), p["bias"].to(h.dtype), padding=1))
        taps.append(h)
    return taps


def lpips(params, x, y):
    """LPIPS distance between two [-1, 1] NHWC batches -> (N,) scores: each
    tap unit-normalised along channels (eps 1e-10 added to the norm), squared
    difference, the learned 1x1 linear combination, spatial mean, summed over
    the five taps."""
    fx = vgg_slices(params["features"], x)
    fy = vgg_slices(params["features"], y)
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        a = a / (a.float().square().sum(1, keepdim=True).sqrt() + 1e-10)
        b = b / (b.float().square().sum(1, keepdim=True).sqrt() + 1e-10)
        w = params["lins"][str(i)].float()
        total = total + ((a - b).square() * w[:, None, None]).sum(1).mean((-1, -2))
    return total


def port_lpips(vgg_pth, lins_pth, dtype=torch.float32, device="cuda"):
    """Official checkpoints -> LPIPS tree. vgg_pth: a torchvision ``vgg16``
    state dict (.pth; ``classifier.*`` ignored) or an already-loaded dict;
    lins_pth: the ``lpips`` package's calibration weights
    (``lpips/weights/v0.1/vgg.pth``: ``lin{i}.model.1.weight`` of shape (1, C,
    1, 1)) or an already-loaded dict."""
    device = resolve_device(device)

    def load(src):
        return src if isinstance(src, dict) else torch.load(src, map_location="cpu", weights_only=True)

    sd_v = load(vgg_pth)
    feats = {str(idx): {"weight": sd_v[f"features.{idx}.weight"].float().to(device=device, dtype=dtype),
                        "bias": sd_v[f"features.{idx}.bias"].float().to(device=device, dtype=dtype)}
             for slice_idxs in VGG16_SLICES for idx in slice_idxs}
    sd_l = load(lins_pth)
    lins = {}
    for i, c in enumerate(VGG16_CHANNELS):
        for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if k in sd_l:
                w = sd_l[k].float().reshape(-1)
                break
        else:
            raise KeyError(f"no lin{i} weight in {list(sd_l)[:4]}...")
        if w.shape != (c,):
            raise ValueError(f"lin{i}: expected ({c},), got {tuple(w.shape)}")
        lins[str(i)] = w.to(device=device, dtype=dtype)
    return {"features": feats, "lins": lins}
