"""Gaussian and Poisson (shot) noise, batched, and the draws they take.

Re-implements the *_pt noise family of dataset/degradations.py:
  * Gaussian: sigma drawn per sample from sigma_range, measured in /255
    units; optional per-sample gray noise blended by a bernoulli(gray_prob)
    mask (:464-557);
  * Poisson: image quantized to 255 levels, per-sample vals =
    2^ceil(log2(#unique values)), noise = poisson(img*vals)/vals - img,
    scaled per sample from scale_range, with the same gray-noise mixing
    (:563-727). The #unique count is a 256-bin histogram per sample built
    with ``scatter_add_`` (exact for the quantized image): nothing waits for
    the device, and it takes (B, 256) counts where a one-hot would take
    (B, H*W*C, 256).

Every random number comes from a draw source with ``uniform(shape, lo, hi)``,
``normal(shape)`` and ``poisson(rates)``, called in program order (the JAX
package's order of ``jax.random`` calls): ``GeneratorDraws`` draws from a
``torch.Generator``; ``ReplayDraws`` hands out draws made elsewhere (on
another device, or by the JAX package in a test).
"""

from __future__ import annotations

import numpy as np
import torch


class GeneratorDraws:
    """Draws from one ``torch.Generator``, on its device, in call order."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=self.generator, device=self.generator.device, dtype=torch.float32)
        return u * (hi - lo) + lo

    def normal(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.generator.device, dtype=torch.float32)

    def poisson(self, rates):
        return torch.poisson(rates, generator=self.generator)


class ReplayDraws:
    """Hands out recorded draws (arrays or tensors) in order, on ``device``;
    a draw of another shape than the call asks for raises."""

    def __init__(self, draws, device):
        self._draws = list(draws)
        self._device = device

    def _next(self, shape):
        if not self._draws:
            raise ValueError("no recorded draw left")
        d = self._draws.pop(0)
        t = (d if isinstance(d, torch.Tensor) else torch.from_numpy(np.array(d))).to(self._device, torch.float32)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"recorded draw of shape {tuple(t.shape)} where {tuple(shape)} is asked for")
        return t

    def uniform(self, shape, lo=0.0, hi=1.0):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)

    def poisson(self, rates):
        return self._next(rates.shape)

    def left(self) -> int:
        return len(self._draws)


def _gray_mix(noise_color, noise_gray, gray_mask):
    return noise_color * (1 - gray_mask) + noise_gray * gray_mask


def add_gaussian_noise(draws, img, sigma_range, gray_prob: float, clip: bool = True):
    """img (B,H,W,C) in [0,1]."""
    b, h, w, _ = img.shape
    sigma = draws.uniform((b, 1, 1, 1), sigma_range[0], sigma_range[1])
    gray_mask = (draws.uniform((b, 1, 1, 1)) < gray_prob).float()
    noise = draws.normal(tuple(img.shape)) * sigma / 255.0
    noise_gray = draws.normal((b, h, w, 1)) * sigma / 255.0
    out = img.float() + _gray_mix(noise, noise_gray, gray_mask)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out.to(img.dtype)


def _quantize_255(img):
    return torch.clamp(torch.round(img * 255.0), 0.0, 255.0) / 255.0


def unique_vals(imgq):
    """Per-sample 2^ceil(log2(#unique)) over a 255-quantized image (B,H,W,C)."""
    b = imgq.shape[0]
    levels = torch.round(imgq.reshape(b, -1) * 255.0).long()
    counts = torch.zeros((b, 256), dtype=torch.float32, device=imgq.device)
    counts.scatter_add_(1, levels, torch.ones(levels.shape, dtype=torch.float32, device=imgq.device))
    n_unique = (counts > 0).float().sum(dim=1)
    return 2.0 ** torch.ceil(torch.log2(n_unique))


def rgb_to_gray(img):
    """torchvision rgb_to_grayscale weights (0.2989, 0.587, 0.114), keepdim."""
    return (img[..., 0:1] * 0.2989 + img[..., 1:2] * 0.587) + img[..., 2:3] * 0.114


def add_poisson_noise(draws, img, scale_range, gray_prob: float, clip: bool = True):
    """img (B,H,W,3) in [0,1]."""
    b = img.shape[0]
    scale = draws.uniform((b, 1, 1, 1), scale_range[0], scale_range[1])
    gray_mask = (draws.uniform((b, 1, 1, 1)) < gray_prob).float()

    imgq = _quantize_255(img.float())
    vals = unique_vals(imgq)[:, None, None, None]
    noise = draws.poisson(imgq * vals) / vals - imgq

    gray = _quantize_255(rgb_to_gray(img.float()))
    gvals = unique_vals(gray)[:, None, None, None]
    noise_gray = draws.poisson(gray * gvals) / gvals - gray

    out = img.float() + _gray_mix(noise, noise_gray, gray_mask) * scale
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out.to(img.dtype)
