"""Mid-timestep calibration CLI for OMGSR-F (flow-matching sigmas).

    python -m omgsr_tpu_torch.cli.mid_timestep_flux \\
        --dataset_txt_or_dir_paths /data/hq --flux_path /ckpts/FLUX.1-dev

Counterpart of mid_timestep/mid_timestep_flux.py: Real-ESRGAN pairs from the
folders, both sides through the FLUX VAE encoder of ``--flux_path/vae`` (f32,
the latent sampled from one torch.Generator), the SNR gap of the shifted
FLUX schedule (``diffusion/calibration.snr_gap_flux``) swept over the 1000
timesteps as one broadcast per batch. ``--device`` defaults to ``cuda``; the
degradation parameters default to the package's params_realesrgan.yml.
"""

from __future__ import annotations

import argparse
import os

import torch

from omgsr_tpu_torch.cli.mid_timestep_sd import run, save_plot
from omgsr_tpu_torch.diffusion.calibration import snr_gap_flux
from omgsr_tpu_torch.utils.devices import resolve_device


def main(argv=None):
    """Returns (t, the mean gap per timestep); writes the plot into the
    working directory, as the reference does."""
    args = parse_args(argv)
    from omgsr_tpu_torch.convert.hf_config import vae_config_from_json
    from omgsr_tpu_torch.convert.porters import port_diffusers_vae
    from omgsr_tpu_torch.data.dataset import PairedDataset, PairedLoader
    from omgsr_tpu_torch.data.degradation import RealESRGANDegrader, load_degradation_params
    from omgsr_tpu_torch.models.vae import vae_encode

    device = resolve_device(args.device)
    vae_dir = os.path.join(args.flux_path, "vae")
    vae_cfg = vae_config_from_json(vae_dir)
    vae_params = port_diffusers_vae(vae_dir, cfg=vae_cfg, device=device)

    degrader = RealESRGANDegrader(load_degradation_params(args.degradation_params), resolution=args.resolution)
    dataset = PairedDataset(args.dataset_txt_or_dir_paths, args.resolution)
    loader = PairedLoader(dataset, args.batch_size, degrader, device=device)

    def encode(x, generator):
        with torch.inference_mode():
            return vae_encode(vae_params, vae_cfg, x, generator=generator)

    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    t, avg = run(args, encode, loader, gap_fn=snr_gap_flux, generator=generator)
    save_plot(avg, t, f"Flux_{args.resolution}_optimal_mid-timestep.png")
    return t, avg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Find optimal mid-timestep (FLUX / FM)")
    parser.add_argument("--dataset_txt_or_dir_paths", type=str, nargs="+", required=True)
    parser.add_argument("--flux_path", type=str, required=True)
    parser.add_argument("--resolution", type=int, default=1024)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_workers", type=int, default=1)  # accepted; one producer thread decodes
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--degradation_params", type=str, default=None,
                        help="YAML of the Real-ESRGAN parameters (default: the package's params_realesrgan.yml)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
