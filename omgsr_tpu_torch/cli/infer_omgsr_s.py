"""OMGSR-S inference CLI, flag-compatible with the reference
(infer/infer_omgsr_s.py:112-149).

    python -m omgsr_tpu_torch.cli.infer_omgsr_s \\
        --input_image tests/imgs --output_dir out \\
        --sd_path /ckpts/stable-diffusion-2-1-base --lora_path /ckpts/omgsr_s \\
        --upscale 4 --align_method adain --mid_timestep 273

Runs on the CUDA device unless ``--device cpu`` is given (the plain PyTorch
versions of the kernels then run on the host). The VAE latent is sampled, its
noise seeded by the image's index.

Multi-GPU, one process per GPU: ``torchrun --nproc_per_node=N -m
omgsr_tpu_torch.cli.infer_omgsr_s --shard tiles ...`` splits the tiled UNet's
tiles over the ranks; every rank reads the same input list and runs each
image in lockstep, and rank 0 writes the outputs. One process started
without torchrun runs unsharded.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from omgsr_tpu_torch.parallel.distributed import is_main_process, local_device
from omgsr_tpu_torch.parallel.sharding import cli_mesh
from omgsr_tpu_torch.utils.devices import resolve_device
from omgsr_tpu_torch.utils.dtypes import resolve_dtype


def collect_images(input_image: str) -> list[str]:
    """Reference path semantics: .txt list, directory glob, or single file
    (infer/infer_omgsr_s.py:54-62)."""
    if ".txt" in input_image:
        with open(input_image) as f:
            return [l.strip() for l in f.readlines()]
    if os.path.isdir(input_image):
        return sorted(
            glob.glob(f"{input_image}/*.png") + glob.glob(f"{input_image}/*.jpg") + glob.glob(f"{input_image}/*.jpeg")
        )
    return [input_image]


def load_adapter_dir(path: str, device="cuda"):
    """Either the native adapter layout (of this port or the JAX package) or a
    torch-PEFT directory -> LoRA tree in the port's layout, f32."""
    from omgsr_tpu_torch.lora.adapter_io import import_peft_adapter, load_adapter

    cfg = os.path.join(path, "adapter_config.json")
    if os.path.exists(cfg):
        with open(cfg) as f:
            fmt = json.load(f).get("format")
        if fmt == "omgsr-tpu":
            return load_adapter(path, device=device)[0]
    return import_peft_adapter(path, device=device)[0]


def build_pipeline(args, dtype, device="cuda", mesh=None):
    """Configs from the checkpoint's JSON, weights through the porters, the
    reference's adapters (infer/omgsr_s_infer_model.py:16-21) merged into the
    VAE encoder and the UNet; on a ``mesh`` (``parallel.sharding.cli_mesh``)
    tile-parallel."""
    from omgsr_tpu_torch.convert.hf_config import unet_config_from_json, vae_config_from_json
    from omgsr_tpu_torch.convert.porters import port_diffusers_unet, port_diffusers_vae
    from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
    from omgsr_tpu_torch.lora import merge_lora

    device = resolve_device(device)
    vae_dir = os.path.join(args.sd_path, "vae")
    unet_dir = os.path.join(args.sd_path, "unet")
    vae_cfg = vae_config_from_json(vae_dir)
    unet_cfg = unet_config_from_json(unet_dir)
    vae_params = port_diffusers_vae(vae_dir, cfg=vae_cfg, dtype=dtype, device=device)
    unet_params = port_diffusers_unet(unet_dir, cfg=unet_cfg, dtype=dtype, device=device)
    if args.lora_path:
        vae_ad = os.path.join(args.lora_path, "vae_encoder_lora_adapter")
        unet_ad = os.path.join(args.lora_path, "unet_lora_adapter")
        if os.path.isdir(vae_ad):
            vae_params["encoder"] = merge_lora(vae_params["encoder"], load_adapter_dir(vae_ad, device))
        if os.path.isdir(unet_ad):
            unet_params = merge_lora(unet_params, load_adapter_dir(unet_ad, device))
    pipe = OMGSRSPipeline(
        vae_params, unet_params, vae_cfg, unet_cfg, mid_timestep=args.mid_timestep,
        vae_tile=args.vae_tile, vae_stats=args.vae_stats, device=device,
    )
    return pipe.shard_for_mesh(mesh, args.shard) if mesh is not None else pipe


def prompt_embeddings(args, dtype, device):
    """--prompt_npz, else --prompt through the checkpoint's text encoder."""
    from omgsr_tpu_torch.cli.prompts import encode_prompt_sd, load_prompt_npz

    if args.prompt_npz:
        return load_prompt_npz(args.prompt_npz)["prompt_embeds"].to(device=device, dtype=dtype)
    prompt = " ".join(args.prompt) if isinstance(args.prompt, list) else args.prompt
    return encode_prompt_sd(args.sd_path, prompt, dtype, device)


def main(args=None):
    if args is None:
        args = parse_args()
    from omgsr_tpu_torch.inference.batch_runner import run_batch

    mesh = cli_mesh(args.shard, args.device)
    device = resolve_device(local_device(args.device))
    dtype = resolve_dtype(args.weight_dtype)
    prompt_embeds = prompt_embeddings(args, dtype, device)
    pipe = build_pipeline(args, dtype, device, mesh)
    image_names = collect_images(args.input_image)
    print(f"There are {len(image_names)} images.")

    tile_size = args.process_size // 8
    tile_overlap = tile_size // 2

    def infer_fn(lq, i):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(i))
        with torch.inference_mode():
            return pipe(torch.from_numpy(lq).to(device=device, dtype=dtype), prompt_embeds, tile_size,
                        tile_overlap, generator=gen)

    return run_batch(
        image_names, infer_fn, args.output_dir, args.process_size, args.upscale, args.align_method,
        size_bucket=args.size_bucket, batch_size=args.batch_size, write=is_main_process(),
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="OMGSR-S Inference Script (PyTorch/CUDA)")
    parser.add_argument("--input_image", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--sd_path", type=str, required=True)
    parser.add_argument("--lora_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no CUDA device is present")
    parser.add_argument("--process_size", type=int, default=512)
    parser.add_argument("--upscale", type=int, default=4)
    parser.add_argument("--align_method", type=str, default="adain", choices=["wavelet", "adain", "nofix"])
    parser.add_argument("--weight_dtype", type=str, default="bf16", choices=["fp32", "bf16"],
                        help="the CUDA kernels take bf16 and f32")
    # reference parity: infer/infer_omgsr_s.py:137 takes nargs="+" so an unquoted
    # multi-word prompt parses; the words are joined into ONE prompt
    parser.add_argument("--prompt", type=str, nargs="*", default="")
    parser.add_argument("--prompt_npz", type=str, default=None, help="precomputed prompt embeddings (.npz)")
    parser.add_argument("--mid_timestep", type=int, default=273)
    parser.add_argument("--vae_tile", type=int, default=None,
                        help="tile the VAE stages of images whose larger side exceeds this many pixels")
    parser.add_argument("--vae_stats", type=str, default="fast", choices=["fast", "exact", "auto"],
                        help="GroupNorm statistics of the tiled VAE (see cli/serve.py)")
    parser.add_argument("--shard", type=str, default="none", choices=["none", "tiles"],
                        help="tiles: under torchrun, the denoiser's tiles split over the ranks")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="same-bucket batch size (images per pipeline call)")
    parser.add_argument("--size_bucket", type=int, default=64,
                        help="pad inputs to multiples of this many px; 0 disables")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
