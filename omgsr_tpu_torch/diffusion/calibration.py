"""SNR-based mid-timestep calibration.

Re-implements the sweep of mid_timestep/mid_timestep_sd.py:59-100 and
mid_timestep_flux.py:95-105 as one broadcast over all timesteps in f32
tensor code, on the latents' device (the reference loops over t in Python):

  SD:   SNR1(t) = E[z_H^2] * abar_t / (1 - abar_t);
  FLUX: SNR1(t) = E[z_H^2] * (1-sigma_t)^2 / sigma_t^2;
  SNR2  = E[z_H^2] / E[(z_L - z_H)^2];
  t*    = argmin_t mean_batches |SNR1(t) - SNR2|.
"""

from __future__ import annotations

import numpy as np
import torch

from omgsr_tpu_torch.diffusion.schedules import ddpm_alphas_cumprod, flux_shifted_sigmas
from omgsr_tpu_torch.utils.devices import host_to_device


def _snr2(hq_latent, lq_latent):
    """(E[z_H^2], E[z_H^2] / E[(z_L - z_H)^2]) in f32."""
    hq, lq = hq_latent.float(), lq_latent.float()
    sig = torch.mean(hq**2)
    return sig, sig / torch.mean((lq - hq) ** 2)


def snr_gap_sd(hq_latent, lq_latent, alphas_cumprod=None):
    """Per-timestep |SNR1 - SNR2| (1000,) for one batch of latents."""
    if alphas_cumprod is None:
        alphas_cumprod = ddpm_alphas_cumprod()
    abar = host_to_device(np.asarray(alphas_cumprod, np.float32), hq_latent.device)
    sig, snr2 = _snr2(hq_latent, lq_latent)
    return torch.abs(sig * abar / (1.0 - abar) - snr2)


def snr_gap_flux(hq_latent, lq_latent, sigmas=None):
    """Per-index |SNR1 - SNR2| over the shifted FM schedule.

    Index convention matches the reference: entry i corresponds to
    sigma = sigmas[-(i+1)], so argmin is directly the mid_timestep
    (train/train_omgsr_f.py:259-262)."""
    if sigmas is None:
        sigmas = flux_shifted_sigmas()
    sig_t = np.clip(np.asarray(sigmas[::-1], np.float32), np.float32(1e-8), np.float32(1.0))
    sig_t = host_to_device(np.ascontiguousarray(sig_t), hq_latent.device)  # sig_t[i] = sigmas[-(i+1)]
    sig, snr2 = _snr2(hq_latent, lq_latent)
    return torch.abs(sig * (1.0 - sig_t) ** 2 / sig_t**2 - snr2)


def calibrate(gap_accumulator: np.ndarray):
    """argmin + value over the accumulated per-timestep gaps."""
    t = int(np.argmin(gap_accumulator))
    return t, float(gap_accumulator[t])
