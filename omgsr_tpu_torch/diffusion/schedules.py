"""Diffusion noise schedules for the two OMGSR variants.

OMGSR-S uses the SD2.1 DDPM schedule (1000 scaled-linear betas) and needs
only the ``alphas_cumprod`` table. OMGSR-F uses FLUX.1-dev's
resolution-shifted flow-matching schedule (reference:
train/train_omgsr_f.py:96-129); the mid-timestep sigma is taken from a
999-step schedule shifted for image_seq_len = (1024/8)^2/4 = 4096
(train/train_omgsr_f.py:124-129, :259-262). Pure numpy table math, computed
once per pipeline.
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


# --- FLUX flow-matching schedule ------------------------------------------------

FLUX_BASE_SHIFT = 0.5
FLUX_MAX_SHIFT = 1.15
# mu is linear in image_seq_len between (256, base_shift) and (4096, max_shift)
_FLUX_MU_X1 = 256.0
_FLUX_MU_X2 = 4096.0


def _flux_mu(image_seq_len: int, base_shift: float = FLUX_BASE_SHIFT, max_shift: float = FLUX_MAX_SHIFT) -> float:
    m = (max_shift - base_shift) / (_FLUX_MU_X2 - _FLUX_MU_X1)
    b = base_shift - m * _FLUX_MU_X1
    return m * image_seq_len + b


def _time_shift(mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
    # exp(mu) / (exp(mu) + (1/t - 1)^sigma); t=0 maps to 0 (limit), handled below.
    with np.errstate(divide="ignore"):
        shifted = math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma)
    return np.where(t == 0.0, 0.0, shifted)


def flux_shifted_sigmas(
    num_steps: int = 999,
    image_seq_len: int = (1024 // 8) * (1024 // 8) // 4,
    base_shift: float = FLUX_BASE_SHIFT,
    max_shift: float = FLUX_MAX_SHIFT,
    shift: bool = True,
) -> np.ndarray:
    """FLUX shifted schedule: num_steps+1 sigmas from 1 down to 0.

    Reference: get_schedule/time_shift/get_lin_function
    (train/train_omgsr_f.py:96-129). The default arguments reproduce
    ``get_flux_setting_timesteps(999)`` at 1024-px processing.
    """
    t = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    if shift:
        mu = _flux_mu(image_seq_len, base_shift, max_shift)
        t = _time_shift(mu, 1.0, t)
    return t


def flux_sigma_at_mid_timestep(mid_timestep: int, sigmas: np.ndarray | None = None) -> float:
    """sigma_t = timesteps[-(mid_timestep+1)] (train/train_omgsr_f.py:259-262)."""
    if sigmas is None:
        sigmas = flux_shifted_sigmas()
    return float(sigmas[-(mid_timestep + 1)])
