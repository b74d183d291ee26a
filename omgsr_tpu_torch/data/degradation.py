"""Real-ESRGAN two-stage degradation pipeline, batched on the device.

Re-implements RealESRGAN_degradation.degrade_process
(dataset/realesrgan.py:203-314):

  stage 1: blur(kernel1) -> random resize (area|bilinear|bicubic, scale
  U[0.3,1.5]) -> gaussian|poisson noise -> DiffJPEG;
  stage 2: blur(kernel2, p=0.5) -> random resize toward 1/sf -> noise ->
  {JPEG then [resize-back+sinc]} or {[resize-back+sinc] then JPEG} (p=0.5);
  optional grayscale / color jitter; optional resize back to full res;
  final uint8 round-trip emulation (clamp(round(x*255))/255).

Split of responsibilities, as in the JAX package:
  * structure decisions (branch taken, resize modes, intermediate sizes) and
    the blur kernels are drawn on the host from a numpy Generator into a
    DegradationPlan: the same seed gives the JAX package's plans and kernels;
  * the tensor work (filter2d, resizes, noise, DiffJPEG) runs on the
    device of the image, with its random numbers from a draw source
    (``ops.noise.GeneratorDraws`` by default); nothing waits for the device.

Intermediate sizes are snapped to a multiple of ``size_snap`` (16 by
default); snap=1 gives the reference's exact sizes.
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from omgsr_tpu_torch.data.kernels import KernelSynthesisConfig, random_kernels
from omgsr_tpu_torch.ops.diffjpeg import diffjpeg
from omgsr_tpu_torch.ops.filters import filter2d
from omgsr_tpu_torch.ops.noise import GeneratorDraws, add_gaussian_noise, add_poisson_noise, rgb_to_gray
from omgsr_tpu_torch.ops.resize import resize
from omgsr_tpu_torch.utils.devices import host_to_device

_MODES = ("area", "bilinear", "bicubic")

# the package's copy of the Real-ESRGAN parameters, found wherever the package is
DEFAULT_PARAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                              "params_realesrgan.yml")


def load_degradation_params(path=None) -> dict:
    """The degradation parameters from a YAML file (default: the package's
    params_realesrgan.yml)."""
    import yaml

    with open(path or DEFAULT_PARAMS) as f:
        return yaml.safe_load(f)


@dataclass(frozen=True)
class DegradationPlan:
    """Host-drawn per-batch structure decisions."""

    size1: tuple  # stage-1 resize target (h, w)
    mode1: str
    gaussian1: bool
    second_blur: bool
    size2: tuple  # stage-2 resize target (h, w)
    mode2: str
    gaussian2: bool
    resize_then_jpeg: bool  # order of [resize-back+sinc] vs JPEG
    final_mode: str
    gray: bool
    jitter: bool
    jitter_order: tuple  # permutation of (brightness, contrast, saturation, hue)
    resize_bak: bool
    bak_mode: str


def _snap(v: int, snap: int) -> int:
    if snap <= 1:
        return max(1, v)
    return max(snap, round(v / snap) * snap)


def draw_plan(
    rng: np.random.Generator,
    opt: dict,
    h: int,
    w: int,
    scale_factor: int,
    resize_bak: bool,
    size_snap: int = 1,
) -> DegradationPlan:
    """Draw the branch structure, mirroring the reference's host randomness
    (dataset/realesrgan.py:218-312)."""

    def rand_scale(prob, rng_range):
        t = rng.choice(["up", "down", "keep"], p=np.asarray(prob) / np.sum(prob))
        if t == "up":
            return rng.uniform(1, rng_range[1])
        if t == "down":
            return rng.uniform(rng_range[0], 1)
        return 1.0

    s1 = rand_scale(opt["resize_prob"], opt["resize_range"])
    size1 = (_snap(int(h * s1), size_snap), _snap(int(w * s1), size_snap))
    s2 = rand_scale(opt["resize_prob2"], opt["resize_range2"])
    size2 = (
        _snap(int(h / scale_factor * s2), size_snap),
        _snap(int(w / scale_factor * s2), size_snap),
    )
    return DegradationPlan(
        size1=size1,
        mode1=str(rng.choice(_MODES)),
        gaussian1=bool(rng.uniform() < opt["gaussian_noise_prob"]),
        second_blur=bool(rng.uniform() < opt["second_blur_prob"]),
        size2=size2,
        mode2=str(rng.choice(_MODES)),
        gaussian2=bool(rng.uniform() < opt["gaussian_noise_prob2"]),
        resize_then_jpeg=bool(rng.uniform() < 0.5),
        final_mode=str(rng.choice(_MODES)),
        gray=bool(rng.uniform() < opt.get("gray_prob", 0.0)),
        jitter=bool(rng.uniform() < opt.get("color_jitter_prob", 0.0)),
        jitter_order=tuple(int(i) for i in rng.permutation(4)),
        resize_bak=resize_bak,
        bak_mode=str(rng.choice(_MODES)),
    )


_RGB2YIQ = np.array([[0.299, 0.596, 0.211], [0.587, -0.274, -0.523], [0.114, -0.322, 0.312]], np.float32)
_YIQ2RGB = np.array([[1.0, 1.0, 1.0], [0.956, -0.272, -1.106], [0.621, -0.647, 1.703]], np.float32)


@functools.lru_cache(maxsize=None)
def _yiq_tables(device: torch.device):
    return host_to_device(_RGB2YIQ, device), host_to_device(_YIQ2RGB, device)


def _color_jitter(draws, img, order=(0, 1, 2, 3), brightness=(0.5, 1.5), contrast=(0.5, 1.5),
                  saturation=(0, 1.5), hue=(-0.1, 0.1)):
    """torchvision-style jitter applied in host-shuffled ``order``
    (reference shuffles per call via randperm, dataset/realesrgan.py:101-119);
    one factor drawn for the batch per transform, when it runs."""

    def do_brightness(img):
        f = draws.uniform((), *brightness)
        return torch.clamp(img * f, 0, 1)

    def do_contrast(img):
        f = draws.uniform((), *contrast)
        return torch.clamp(rgb_to_gray(img).mean(dim=(1, 2, 3), keepdim=True) * (1 - f) + img * f, 0, 1)

    def do_saturation(img):
        f = draws.uniform((), *saturation)
        return torch.clamp(rgb_to_gray(img) * (1 - f) + img * f, 0, 1)

    def do_hue(img):
        f = draws.uniform((), *hue) * 2 * math.pi
        rgb2yiq, yiq2rgb = _yiq_tables(img.device)
        yiq = torch.einsum("bhwc,cd->bhwd", img, rgb2yiq)
        cosf, sinf = torch.cos(f), torch.sin(f)
        zero, one = torch.zeros_like(f), torch.ones_like(f)
        rot = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cosf, -sinf]),
                           torch.stack([zero, sinf, cosf])])
        yiq = torch.einsum("bhwc,cd->bhwd", yiq, rot.T)
        return torch.clamp(torch.einsum("bhwc,cd->bhwd", yiq, yiq2rgb), 0, 1)

    fns = [do_brightness, do_contrast, do_saturation, do_hue]
    for i in order:
        img = fns[i](img)
    return img


def degrade(img_gt, kernels, draws, plan: DegradationPlan, opt: dict):
    """img_gt (B, H, W, 3) in [0,1] -> img_lq per the plan. kernels: (k1, k2,
    sinc), each (B, k, k) on the image's device; draws: the draw source of
    every random number (``ops.noise``), called in the JAX package's order."""
    k1, k2, sinc = kernels
    out = img_gt

    # ---- stage 1 ----
    out = filter2d(out, k1)
    out = resize(out, *plan.size1, plan.mode1)
    if plan.gaussian1:
        out = add_gaussian_noise(draws, out, opt["noise_range"], opt["gray_noise_prob"])
    else:
        out = add_poisson_noise(draws, out, opt["poisson_scale_range"], opt["gray_noise_prob"])
    q = draws.uniform((out.shape[0],), *opt["jpeg_range"])
    out = diffjpeg(torch.clamp(out, 0, 1), q)

    # ---- stage 2 ----
    if plan.second_blur:
        out = filter2d(out, k2)
    out = resize(out, *plan.size2, plan.mode2)
    if plan.gaussian2:
        out = add_gaussian_noise(draws, out, opt["noise_range2"], opt["gray_noise_prob2"])
    else:
        out = add_poisson_noise(draws, out, opt["poisson_scale_range2"], opt["gray_noise_prob2"])

    h, w = img_gt.shape[1:3]
    final_size = (h // opt["scale"], w // opt["scale"])
    if plan.resize_then_jpeg:
        out = resize(out, *final_size, plan.final_mode)
        out = filter2d(out, sinc)
        q = draws.uniform((out.shape[0],), *opt["jpeg_range2"])
        out = diffjpeg(torch.clamp(out, 0, 1), q)
    else:
        q = draws.uniform((out.shape[0],), *opt["jpeg_range2"])
        out = diffjpeg(torch.clamp(out, 0, 1), q)
        out = resize(out, *final_size, plan.final_mode)
        out = filter2d(out, sinc)

    if plan.gray:
        # the reference returns 1 channel (which its own trainer cannot take); replicated to 3
        out = rgb_to_gray(out).expand(out.shape).contiguous()
    if plan.jitter:
        out = _color_jitter(draws, out, plan.jitter_order)

    if plan.resize_bak:
        out = resize(out, h, w, plan.bak_mode)

    # uint8 round-trip emulation (dataset/realesrgan.py:312)
    return torch.clamp(torch.round(out * 255.0), 0, 255) / 255.0


class RealESRGANDegrader:
    """Stateful wrapper: a numpy Generator for the plans, the kernels and the
    seed of each call's ``torch.Generator`` (on the image's device) that
    draws the noise, qualities and jitter factors."""

    def __init__(self, opt: dict, resolution: int = 512, size_snap: int = 16, seed: int = 0):
        self.opt = dict(opt)
        self.opt["scale"] = 4 if resolution == 512 else 8
        self.kcfg = KernelSynthesisConfig.from_opt(opt, resolution)
        self.rng = np.random.default_rng(seed)
        self.size_snap = size_snap

    def __call__(self, img_gt, draws=None, resize_bak: bool = True):
        """img_gt (B,H,W,3) [0,1] -> (img_gt, img_lq), like degrade_process
        (dataset/realesrgan.py:204). Without ``draws``, the call draws an
        integer from the numpy stream (as the JAX package draws its key) and
        seeds a torch.Generator with it."""
        b, h, w, _ = img_gt.shape
        ks = [random_kernels(self.rng, self.kcfg) for _ in range(b)]
        kernels = host_to_device(np.stack([np.stack([k[i] for k in ks]) for i in range(3)]), img_gt.device)
        plan = draw_plan(self.rng, self.opt, h, w, self.kcfg.scale_factor, resize_bak, self.size_snap)
        if draws is None:
            generator = torch.Generator(device=img_gt.device)
            generator.manual_seed(int(self.rng.integers(0, 2**31)))
            draws = GeneratorDraws(generator)
        return img_gt, degrade(img_gt, tuple(kernels), draws, plan, self.opt)
