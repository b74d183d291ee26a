"""Mid-timestep calibration CLI for OMGSR-S.

    python -m omgsr_tpu_torch.cli.mid_timestep_sd \
        --dataset_txt_or_dir_paths /data/hq --sd_path /ckpts/sd21 \
        --resolution 512 --max_samples 100

Flag-compatible with mid_timestep/mid_timestep_sd.py:142-159: Real-ESRGAN
pairs from the folders, both sides through the frozen SD2.1 VAE encoder (f32,
the latent sampled from one torch.Generator), and the 1000-t sweep as one
broadcast per batch instead of a Python loop. ``--device`` defaults to
``cuda``; the degradation parameters default to the package's
params_realesrgan.yml.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from omgsr_tpu_torch.diffusion.calibration import calibrate, snr_gap_sd
from omgsr_tpu_torch.utils.devices import resolve_device


def run(args, encode_fn, loader, gap_fn=snr_gap_sd, generator=None):
    """encode_fn(img_pm1, generator) -> latent; loader yields {'lq','hq'} in
    [-1,1]. Returns (t, the mean gap per timestep (1000,) in f64)."""
    acc = np.zeros(1000, np.float64)
    count = 0
    for i, batch in enumerate(loader):
        if args.max_samples is not None and count >= args.max_samples:
            break
        hq_lat = encode_fn(torch.as_tensor(batch["hq"]), generator)
        lq_lat = encode_fn(torch.as_tensor(batch["lq"]), generator)
        b = batch["hq"].shape[0]
        acc += gap_fn(hq_lat, lq_lat).double().cpu().numpy() * b
        count += b
        t, loss = calibrate(acc / max(count, 1))
        print(f"batch {i + 1}: best_t={t} loss={loss:.6f}")
    t, loss = calibrate(acc / max(count, 1))
    print(f"Optimal timestep t: {t}")
    print(f"Loss: {loss:.6f}")
    return t, acc / max(count, 1)


def save_plot(avg_gap, t_best, out_path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return
    plt.figure(figsize=(12, 7))
    plt.plot(np.arange(len(avg_gap)), avg_gap, linewidth=1)
    plt.plot(t_best, avg_gap[t_best], "ro", markersize=12, markerfacecolor="none")
    plt.title(f"Loss over timesteps (optimal t={t_best})")
    plt.xlabel("Timestep (t)")
    plt.ylabel("|SNR1 - SNR2|")
    plt.grid(True, linestyle="--", alpha=0.7)
    plt.tight_layout()
    plt.savefig(out_path, dpi=150)
    plt.close()
    print(f"Saved {out_path}")


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
    vae_dir = os.path.join(args.sd_path, "vae")
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
    t, avg = run(args, encode, loader, generator=generator)
    save_plot(avg, t, f"Sd_{args.resolution}_optimal_mid-timestep.png")
    return t, avg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Find optimal mid-timestep (SD / DDPM)")
    parser.add_argument("--dataset_txt_or_dir_paths", type=str, nargs="+", required=True)
    parser.add_argument("--sd_path", type=str, required=True)
    parser.add_argument("--resolution", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_workers", type=int, default=1)  # accepted; one producer thread decodes
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--degradation_params", type=str, default=None,
                        help="YAML of the Real-ESRGAN parameters (default: the package's params_realesrgan.yml)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
