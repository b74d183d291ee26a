"""Random blur-kernel synthesis for the Real-ESRGAN degradation (host-side).

Re-implements the kernel family of dataset/degradations.py:87-413 and the
per-sample kernel draw of dataset/realesrgan.py:142-201 with an explicit
numpy Generator (the reference uses global np.random/random state, which is
hostile to reproducibility across workers).

Kernels are synthesized on the host (they are 21x21/41x41 tables) and padded
to the resolution-dependent max size, so one batch's kernels stack into one
tensor: 512-res -> sizes 7..21 pad 21, else 11..41 pad 41
(dataset/realesrgan.py:83-96).

The port's own copy of the JAX package's module (numpy; scipy imported where
the sinc kernel needs it): the same Generator calls in the same order, so one
seed gives the same kernels bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x**2, 0.0], [0.0, sig_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def _grid(kernel_size: int) -> np.ndarray:
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], axis=-1)  # (k, k, 2)


def _mahalanobis_sq(grid, sigma_mat):
    inv = np.linalg.inv(sigma_mat)
    return np.sum((grid @ inv) * grid, axis=2)


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, isotropic=True):
    if isotropic:
        sig_y, theta = sig_x, 0.0
    m = _mahalanobis_sq(_grid(kernel_size), sigma_matrix(sig_x, sig_y, theta))
    k = np.exp(-0.5 * m)
    return k / k.sum()


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y, theta, beta, isotropic=True):
    if isotropic:
        sig_y, theta = sig_x, 0.0
    m = _mahalanobis_sq(_grid(kernel_size), sigma_matrix(sig_x, sig_y, theta))
    k = np.exp(-0.5 * np.power(m, beta))
    return k / k.sum()


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, isotropic=True):
    if isotropic:
        sig_y, theta = sig_x, 0.0
    m = _mahalanobis_sq(_grid(kernel_size), sigma_matrix(sig_x, sig_y, theta))
    k = 1.0 / (np.power(m, beta) + 1.0)
    return k / k.sum()


def circular_lowpass_kernel(cutoff: float, kernel_size: int, pad_to: int = 0) -> np.ndarray:
    """2-D sinc (circular low-pass) kernel via Bessel J1
    (dataset/degradations.py:395-413)."""
    from scipy import special

    assert kernel_size % 2 == 1
    c = (kernel_size - 1) / 2
    y, x = np.mgrid[0:kernel_size, 0:kernel_size].astype(np.float64)
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = cutoff * special.j1(cutoff * r) / (2 * np.pi * r)
    kernel[int(c), int(c)] = cutoff**2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        p = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((p, p), (p, p)))
    return kernel


def random_mixed_kernel(
    rng: np.random.Generator,
    kernel_list,
    kernel_prob,
    kernel_size,
    sigma_range,
    rotation_range=(-math.pi, math.pi),
    betag_range=(0.5, 8),
    betap_range=(0.5, 8),
) -> np.ndarray:
    """random_mixed_kernels parity (dataset/degradations.py:330-389) with a
    seeded Generator. Sampling order per type matches the reference:
    sigma_x, [sigma_y, rotation,] [beta branch]."""
    ktype = rng.choice(kernel_list, p=np.asarray(kernel_prob) / np.sum(kernel_prob))

    def draw_sigmas(iso):
        sx = rng.uniform(*sigma_range)
        if iso:
            return sx, sx, 0.0
        sy = rng.uniform(*sigma_range)
        th = rng.uniform(*rotation_range)
        return sx, sy, th

    def draw_beta(beta_range):
        if rng.uniform() < 0.5:
            return rng.uniform(beta_range[0], 1.0)
        return rng.uniform(1.0, beta_range[1])

    if ktype == "iso":
        sx, sy, th = draw_sigmas(True)
        return bivariate_gaussian(kernel_size, sx, sy, th, isotropic=True)
    if ktype == "aniso":
        sx, sy, th = draw_sigmas(False)
        return bivariate_gaussian(kernel_size, sx, sy, th, isotropic=False)
    if ktype == "generalized_iso":
        sx, sy, th = draw_sigmas(True)
        return bivariate_generalized_gaussian(kernel_size, sx, sy, th, draw_beta(betag_range), True)
    if ktype == "generalized_aniso":
        sx, sy, th = draw_sigmas(False)
        return bivariate_generalized_gaussian(kernel_size, sx, sy, th, draw_beta(betag_range), False)
    if ktype == "plateau_iso":
        sx, sy, th = draw_sigmas(True)
        return bivariate_plateau(kernel_size, sx, sy, th, draw_beta(betap_range), True)
    if ktype == "plateau_aniso":
        sx, sy, th = draw_sigmas(False)
        return bivariate_plateau(kernel_size, sx, sy, th, draw_beta(betap_range), False)
    raise ValueError(f"unknown kernel type {ktype}")


@dataclass(frozen=True)
class KernelSynthesisConfig:
    """kernel_info block of params_realesrgan.yml + resolution geometry
    (dataset/realesrgan.py:62-96)."""

    kernel_list: tuple
    kernel_prob: tuple
    sinc_prob: float
    blur_sigma: tuple
    betag_range: tuple
    betap_range: tuple
    kernel_list2: tuple
    kernel_prob2: tuple
    sinc_prob2: float
    blur_sigma2: tuple
    betag_range2: tuple
    betap_range2: tuple
    final_sinc_prob: float
    resolution: int = 512

    @property
    def kernel_range(self):
        if self.resolution == 512:
            return [2 * v + 1 for v in range(3, 11)]  # 7..21
        return [2 * v + 1 for v in range(5, 21)]  # 11..41

    @property
    def kernel_max(self):
        return 21 if self.resolution == 512 else 41

    @property
    def kernel_mid(self):
        return 13 if self.resolution == 512 else 25

    @property
    def scale_factor(self):
        return 4 if self.resolution == 512 else 8

    @staticmethod
    def from_opt(opt: dict, resolution: int = 512):
        k = opt["kernel_info"]
        return KernelSynthesisConfig(
            kernel_list=tuple(k["kernel_list"]),
            kernel_prob=tuple(k["kernel_prob"]),
            sinc_prob=k["sinc_prob"],
            blur_sigma=tuple(k["blur_sigma"]),
            betag_range=tuple(k["betag_range"]),
            betap_range=tuple(k["betap_range"]),
            kernel_list2=tuple(k["kernel_list2"]),
            kernel_prob2=tuple(k["kernel_prob2"]),
            sinc_prob2=k["sinc_prob2"],
            blur_sigma2=tuple(k["blur_sigma2"]),
            betag_range2=tuple(k["betag_range2"]),
            betap_range2=tuple(k["betap_range2"]),
            final_sinc_prob=k["final_sinc_prob"],
            resolution=resolution,
        )


def _pulse_kernel(size: int) -> np.ndarray:
    k = np.zeros((size, size), np.float32)
    k[size // 2, size // 2] = 1.0
    return k


def _pad_to(kernel: np.ndarray, size: int) -> np.ndarray:
    p = (size - kernel.shape[0]) // 2
    return np.pad(kernel, ((p, p), (p, p)))


def random_kernels(rng: np.random.Generator, cfg: KernelSynthesisConfig):
    """(kernel1, kernel2, sinc_kernel), each padded to kernel_max
    (dataset/realesrgan.py:142-201)."""

    def stage_kernel(sinc_prob, klist, kprob, sigma, betag, betap):
        size = int(rng.choice(cfg.kernel_range))
        if rng.uniform() < sinc_prob:
            if size < cfg.kernel_mid:
                omega = rng.uniform(np.pi / 3, np.pi)
            else:
                omega = rng.uniform(np.pi / 5, np.pi)
            k = circular_lowpass_kernel(omega, size)
        else:
            k = random_mixed_kernel(
                rng, klist, kprob, size, sigma,
                betag_range=betag, betap_range=betap,
            )
        return _pad_to(k, cfg.kernel_max)

    k1 = stage_kernel(
        cfg.sinc_prob, cfg.kernel_list, cfg.kernel_prob, cfg.blur_sigma,
        cfg.betag_range, cfg.betap_range,
    )
    k2 = stage_kernel(
        cfg.sinc_prob2, cfg.kernel_list2, cfg.kernel_prob2, cfg.blur_sigma2,
        cfg.betag_range2, cfg.betap_range2,
    )
    if rng.uniform() < cfg.final_sinc_prob:
        size = int(rng.choice(cfg.kernel_range))
        omega = rng.uniform(np.pi / 3, np.pi)
        sinc = circular_lowpass_kernel(omega, size, pad_to=cfg.kernel_max)
    else:
        sinc = _pulse_kernel(cfg.kernel_max)
    return (
        k1.astype(np.float32),
        k2.astype(np.float32),
        sinc.astype(np.float32),
    )
