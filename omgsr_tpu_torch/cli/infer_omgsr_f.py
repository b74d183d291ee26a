"""OMGSR-F inference CLI, flag-compatible with the reference
(infer/infer_omgsr_f.py:114-154).

    python -m omgsr_tpu_torch.cli.infer_omgsr_f \\
        --input_image tests/imgs --output_dir out \\
        --flux_path /ckpts/FLUX.1-dev --lora_path /ckpts/omgsr_f \\
        --prompt "" --process_size 1024 --upscale 4 --mid_timestep 244

Runs on the CUDA device unless ``--device cpu`` is given (the plain PyTorch
versions of the kernels then run on the host). The prompt embeddings come
from ``--prompt_npz`` (``prompt_embeds`` (1, S, 4096) and
``pooled_prompt_embeds`` (1, 768)), else from ``--prompt`` through the
checkpoint's T5-XXL and CLIP-L (``cli/prompts.encode_prompt_flux``).
``--quantize int8 | int8_w8a8 | int4`` ports the DiT to the CPU, merges the
adapter there and places only its codes on the card (utils/quantize.py): the
card never holds the bf16 DiT. The VAE latent is sampled, its noise seeded by
the image's index.

Multi-GPU, one process per GPU: ``torchrun --nproc_per_node=N -m
omgsr_tpu_torch.cli.infer_omgsr_f --shard tp|fsdp|tiles ...``. Every rank
reads the same input list and runs each image in lockstep; rank 0 writes the
outputs. One process started without torchrun runs unsharded.
"""

from __future__ import annotations

import argparse
import os

import torch

from omgsr_tpu_torch.cli.infer_omgsr_s import collect_images, load_adapter_dir
from omgsr_tpu_torch.parallel.distributed import is_main_process, local_device
from omgsr_tpu_torch.parallel.sharding import cli_mesh
from omgsr_tpu_torch.utils.devices import resolve_device
from omgsr_tpu_torch.utils.dtypes import resolve_dtype


def quantize_flux(flux_params, mode: str, min_params: int, device):
    """``--quantize`` on a float DiT tree: int8 (weight-only), int8_w8a8 (the
    w8a8 route marked) or int4, with the codes placed on ``device``."""
    from omgsr_tpu_torch.utils.quantize import quantize_flux_for_serving

    if mode not in ("int8", "int8_w8a8", "int4"):
        raise ValueError(f"--quantize {mode!r}: choose none, int8, int8_w8a8 or int4")
    return quantize_flux_for_serving(flux_params, act_quant=mode == "int8_w8a8", bits=4 if mode == "int4" else 8,
                                     min_params=min_params, device=device)


def build_pipeline(args, dtype, device="cuda", mesh=None):
    """Configs from ``--flux_path``'s ``vae/`` and ``transformer/`` JSON,
    weights through the porters, the reference's adapters
    (train/train_omgsr_f.py:150,176: ``flux_adapter/``,
    ``vae_encoder_adapter/``) merged where ``--lora_path`` holds them; on a
    ``mesh`` (``parallel.sharding.cli_mesh``) placed by ``--shard``."""
    from omgsr_tpu_torch.convert.hf_config import flux_config_from_json, vae_config_from_json
    from omgsr_tpu_torch.convert.porters import port_diffusers_vae, port_flux_transformer
    from omgsr_tpu_torch.inference.pipeline_f import OMGSRFPipeline
    from omgsr_tpu_torch.lora import merge_lora

    device = resolve_device(device)
    vae_dir = os.path.join(args.flux_path, "vae")
    flux_dir = os.path.join(args.flux_path, "transformer")
    vae_cfg = vae_config_from_json(vae_dir)
    flux_cfg = flux_config_from_json(flux_dir)
    vae_params = port_diffusers_vae(vae_dir, cfg=vae_cfg, dtype=dtype, device=device)
    # a quantised DiT is ported and merged on the CPU, and only its codes reach the card
    quantize = getattr(args, "quantize", "none")
    stage = torch.device("cpu") if quantize != "none" else device
    flux_params = port_flux_transformer(flux_dir, cfg=flux_cfg, dtype=dtype, device=stage)
    if args.lora_path:
        flux_ad = os.path.join(args.lora_path, "flux_adapter")
        vae_ad = os.path.join(args.lora_path, "vae_encoder_adapter")
        if os.path.isdir(flux_ad):
            flux_params = merge_lora(flux_params, load_adapter_dir(flux_ad, stage))
        if os.path.isdir(vae_ad):
            vae_params["encoder"] = merge_lora(vae_params["encoder"], load_adapter_dir(vae_ad, device))
    if quantize != "none":
        flux_params = quantize_flux(flux_params, quantize, args.quantize_min_params, device)
    pipe = OMGSRFPipeline(
        vae_params, flux_params, vae_cfg, flux_cfg, mid_timestep=args.mid_timestep,
        guidance_scale=args.guidance_scale, vae_tile=args.vae_tile, vae_stats=args.vae_stats, device=device,
    )
    return pipe.shard_for_mesh(mesh, args.shard) if mesh is not None else pipe


def prompt_embeddings(args, dtype, device):
    """(prompt_embeds, pooled_prompt_embeds) from ``--prompt_npz``, else
    ``--prompt`` through the text encoders of ``--flux_path``."""
    from omgsr_tpu_torch.cli.prompts import encode_prompt_flux, load_prompt_npz

    if args.prompt_npz:
        d = load_prompt_npz(args.prompt_npz)
        return (d["prompt_embeds"].to(device=device, dtype=dtype),
                d["pooled_prompt_embeds"].to(device=device, dtype=dtype))
    if not args.flux_path:
        raise ValueError("OMGSR-F needs --prompt_npz or --flux_path (whose text encoders encode --prompt)")
    prompt = " ".join(args.prompt) if isinstance(args.prompt, list) else args.prompt
    embeds, pooled, _ = encode_prompt_flux(args.flux_path, prompt, dtype=dtype, device=device)
    return embeds, pooled


def main(args=None):
    if args is None:
        args = parse_args()
    from omgsr_tpu_torch.inference.batch_runner import run_batch

    mesh = cli_mesh(args.shard, args.device)
    device = resolve_device(local_device(args.device))
    dtype = resolve_dtype(args.weight_dtype)
    prompt_embeds, pooled = prompt_embeddings(args, dtype, device)
    pipe = build_pipeline(args, dtype, device, mesh)
    image_names = collect_images(args.input_image)
    print(f"There are {len(image_names)} images.")

    tile_size = args.process_size // 8
    tile_overlap = tile_size // 2

    def infer_fn(lq, i):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(i))
        with torch.inference_mode():
            return pipe(torch.from_numpy(lq).to(device=device, dtype=dtype), prompt_embeds, pooled, tile_size,
                        tile_overlap, generator=gen)

    return run_batch(
        image_names, infer_fn, args.output_dir, args.process_size, args.upscale, args.align_method,
        size_bucket=args.size_bucket, batch_size=args.batch_size, write=is_main_process(),
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="OMGSR-F Inference Script (PyTorch/CUDA)")
    parser.add_argument("--input_image", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--flux_path", type=str, required=True)
    parser.add_argument("--lora_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no CUDA device is present")
    parser.add_argument("--process_size", type=int, default=1024)
    parser.add_argument("--upscale", type=int, default=4)
    parser.add_argument("--align_method", type=str, default="adain", choices=["wavelet", "adain", "nofix"])
    parser.add_argument("--weight_dtype", type=str, default="bf16", choices=["fp32", "bf16"],
                        help="the CUDA kernels take bf16 and f32")
    # multi-word prompt parses; the words are joined into ONE prompt
    parser.add_argument("--prompt", type=str, nargs="*", default="")
    parser.add_argument("--prompt_npz", type=str, default=None,
                        help="precomputed prompt_embeds and pooled_prompt_embeds (.npz); else --prompt is encoded")
    parser.add_argument("--mid_timestep", type=int, default=244)
    parser.add_argument("--guidance_scale", type=float, default=1.0)
    parser.add_argument("--quantize", type=str, default="none", choices=["none", "int8", "int8_w8a8", "int4"],
                        help="int8: weight-only DiT storage (11.9 GB for the 12B DiT); int8_w8a8: also "
                        "the block products int8 x int8 -> int32 with per-token activation scales; int4: "
                        "group-wise (g=128) nibble-packed storage, the minimum-memory mode")
    parser.add_argument("--quantize_min_params", type=int, default=1 << 16,
                        help="only dense weights with at least this many elements are quantized")
    parser.add_argument("--vae_tile", type=int, default=None,
                        help="tile the VAE stages of images whose larger side exceeds this many pixels")
    parser.add_argument("--vae_stats", type=str, default="fast", choices=["fast", "exact", "auto"],
                        help="GroupNorm statistics of the tiled VAE (see cli/serve.py)")
    parser.add_argument("--shard", type=str, default="none", choices=["none", "fsdp", "tp", "tiles"],
                        help="multi-GPU under torchrun: fsdp / tp place the DiT over the ranks, tiles "
                        "splits the denoiser's tiles over them")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="same-bucket batch size (images per pipeline call)")
    parser.add_argument("--size_bucket", type=int, default=64,
                        help="pad inputs to multiples of this many px; 0 disables")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
