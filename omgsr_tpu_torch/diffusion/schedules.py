"""Diffusion noise schedule for OMGSR-S.

OMGSR-S uses the SD2.1 DDPM schedule (1000 scaled-linear betas) and needs
only the ``alphas_cumprod`` table. Pure numpy table math, computed once per
pipeline. The FLUX flow-matching schedule arrives with the -F slice.
"""

from __future__ import annotations

import math

import numpy as np

# SD2.x / diffusers DDPMScheduler defaults for stabilityai/stable-diffusion-2-1-base.
DDPM_NUM_TIMESTEPS = 1000
DDPM_BETA_START = 0.00085
DDPM_BETA_END = 0.012


def ddpm_alphas_cumprod(
    num_timesteps: int = DDPM_NUM_TIMESTEPS,
    beta_start: float = DDPM_BETA_START,
    beta_end: float = DDPM_BETA_END,
) -> np.ndarray:
    """The "scaled_linear" DDPM cumulative-alpha table used by SD2.1.

    betas are linear in sqrt-space: linspace(sqrt(b0), sqrt(b1), N)**2, as in
    diffusers' DDPMScheduler(beta_schedule="scaled_linear").
    """
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_timesteps, dtype=np.float64) ** 2
    alphas = 1.0 - betas
    return np.cumprod(alphas).astype(np.float64)


def mid_timestep_coeffs_sd(mid_timestep: int, alphas_cumprod: np.ndarray | None = None):
    """(sqrt(abar_t), sqrt(1-abar_t)) at the calibrated mid-timestep."""
    if alphas_cumprod is None:
        alphas_cumprod = ddpm_alphas_cumprod()
    a = float(alphas_cumprod[mid_timestep])
    return math.sqrt(a), math.sqrt(1.0 - a)
