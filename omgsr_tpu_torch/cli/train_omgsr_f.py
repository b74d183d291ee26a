"""OMGSR-F training CLI.

    python -m omgsr_tpu_torch.cli.train_omgsr_f --config omgsr_tpu_torch/configs/omgsr_f_1024.yml [key=value ...]
    torchrun --nproc_per_node=N -m omgsr_tpu_torch.cli.train_omgsr_f --config ... "mesh_shape={fsdp: N}"

Mirrors train/train_omgsr_f.py with the intended behaviour at its two shipped
bugs (accelerate.device NameError :247, missing weight_dtype argument :540):
config -> frozen FLUX VAE + DiT + LoRA (VAE-encoder and DiT, rank 64 in the
published config) -> DISTS + multi-level discriminator -> the G/D AdamW loop
of ``train_omgsr_s.train_loop`` (gradient accumulation, full-state resume,
triptychs, metrics) with the -F adapters (``vae_encoder_adapter``,
``flux_adapter``) exported at every checkpoint step and at the end.

The frozen VAE and DiT come from ``cfg.flux_path`` (bf16 under
``mixed_precision: bf16``: the 11.9B DiT is 23.8 GB, which an 80 GB card holds
beside the train step), the DINOv3 ConvNeXt from
``cfg.extra["dinov3_weights_path"]`` (from a seed, with a warning, where none
is set), and the fixed prompt's embeddings from ``cfg.fixed_prompt_path`` or
``cfg.fixed_prompt`` through the checkpoint's T5-XXL and CLIP-L. The DiT is
trained under per-block recompute when ``gradient_checkpointing`` is set (see
``training/trainer.TrainerF``). ``quantize_base: int8 | int4`` ports the DiT
to the CPU and freezes only its codes on the card (utils/quantize.py), the
LoRA training on top in the compute dtype; a quantised dense layer keeps no
float copy of its weight for the backward (``models/layers.dense``).

Under torchrun the world trains over ``cfg.mesh_shape`` as
``train_omgsr_s`` describes; with an "fsdp" axis the DiT (float, or its
``quantize_base`` codes, block by block) is ported to the host and placed on
the card leaf by leaf, so no rank holds the whole 23.8 GB tree, and each
block is gathered as it runs and again in its recompute.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from omgsr_tpu_torch.cli.train_omgsr_s import place_frozen, start_run, train_loop
from omgsr_tpu_torch.config import TrainConfig, load_config
from omgsr_tpu_torch.parallel.distributed import local_device
from omgsr_tpu_torch.parallel.sharding import cli_train_mesh, uses_fsdp
from omgsr_tpu_torch.utils.devices import resolve_device

logger = logging.getLogger("omgsr_tpu_torch.train_f")

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                              "omgsr_f_1024.yml")


def _place_quantized_dit(flux_cpu, bits, mesh, device):
    """A DiT ported to the host, quantised to ``bits`` (8 / 4) and placed by
    FSDP on ``device`` block by block (and each top-level part): every part
    leaves the host tree as its codes are placed, so no rank holds the whole
    tree of codes."""
    from omgsr_tpu_torch.parallel.sharding import shard_params_fsdp
    from omgsr_tpu_torch.utils import quantize

    def place(part):
        return shard_params_fsdp(quantize.quantize_flux_for_serving(part, bits=bits, device=device), mesh,
                                 consume=True)

    out = {}
    for name in list(flux_cpu):
        part = flux_cpu.pop(name)
        if name in ("transformer_blocks", "single_transformer_blocks"):
            out[name] = {i: place(part.pop(i)) for i in list(part)}
        else:
            out[name] = place(part)
    return out


def build_frozen_f(cfg: TrainConfig, dtype, device="cuda", mesh=None):
    """Load the frozen model bundle for -F from cfg.flux_path: (bundle, the
    ConvNeXt config). With an "fsdp" axis in ``mesh`` the DiT is ported to
    the host, for ``place_frozen`` to place on ``device`` leaf by leaf; a
    ``quantize_base`` DiT is quantised and placed here block by block
    (``_place_quantized_dit``)."""
    from omgsr_tpu_torch.convert.hf_config import flux_config_from_json, vae_config_from_json
    from omgsr_tpu_torch.convert.params import init_convnext
    from omgsr_tpu_torch.convert.porters import port_diffusers_vae, port_dinov3_convnext, port_flux_transformer
    from omgsr_tpu_torch.losses.dists import init_dists
    from omgsr_tpu_torch.models.configs import CONVNEXT_SIZES

    device = resolve_device(device)
    if cfg.quantize_base not in (None, "none", "int8", "int4"):
        raise ValueError(f"quantize_base {cfg.quantize_base!r}: choose int8 or int4 (w8a8 is inference-only), "
                         "or leave it unset to train on the float DiT")
    if not cfg.flux_path:
        raise ValueError("cfg.flux_path is not set: name the FLUX.1-dev checkpoint directory, or hand run_training "
                         "the frozen bundle in memory (frozen=...)")
    vae_dir = os.path.join(cfg.flux_path, "vae")
    flux_dir = os.path.join(cfg.flux_path, "transformer")
    vae_cfg = vae_config_from_json(vae_dir)
    flux_cfg = flux_config_from_json(flux_dir)
    vae_params = port_diffusers_vae(vae_dir, cfg=vae_cfg, dtype=dtype, device=device)
    bits = {"int8": 8, "int4": 4}.get(cfg.quantize_base)
    if uses_fsdp(mesh):
        flux_params = port_flux_transformer(flux_dir, cfg=flux_cfg, dtype=dtype, device="cpu")
        if bits:
            flux_params = _place_quantized_dit(flux_params, bits, mesh, device)
    elif bits:
        # the float DiT stays on the CPU; only its codes are placed on the card
        from omgsr_tpu_torch.utils.quantize import quantize_flux_for_serving

        flux_params = port_flux_transformer(flux_dir, cfg=flux_cfg, dtype=dtype, device="cpu")
        flux_params = quantize_flux_for_serving(flux_params, bits=bits, device=device)
    else:
        flux_params = port_flux_transformer(flux_dir, cfg=flux_cfg, dtype=dtype, device=device)

    cn_cfg = CONVNEXT_SIZES[cfg.dinov3_convnext_size]
    dinov3_path = cfg.extra.get("dinov3_weights_path")
    if dinov3_path:
        backbone = port_dinov3_convnext(dinov3_path, cfg=cn_cfg, dtype=dtype, device=device)
    else:
        logger.warning("no dinov3_weights_path set — using random ConvNeXt backbone")
        backbone = init_convnext(0, cn_cfg, dtype, device)

    return {
        "vae": vae_params,
        "vae_cfg": vae_cfg,
        "flux": flux_params,
        "flux_cfg": flux_cfg,
        "backbone": backbone,
        "dists": init_dists(backbone, cn_cfg.dims),
    }, cn_cfg


def encode_fixed_prompt_f(cfg: TrainConfig, dtype, device="cuda"):
    """(prompt_embeds, pooled_prompt_embeds) of the fixed prompt:
    cfg.fixed_prompt_path (.npz), else cfg.fixed_prompt through the text
    encoders of cfg.flux_path."""
    from omgsr_tpu_torch.cli.prompts import encode_prompt_flux, load_prompt_npz

    device = resolve_device(device)
    if cfg.fixed_prompt_path:
        d = load_prompt_npz(cfg.fixed_prompt_path)
        return (d["prompt_embeds"].to(device=device, dtype=dtype),
                d["pooled_prompt_embeds"].to(device=device, dtype=dtype))
    embeds, pooled, _ = encode_prompt_flux(cfg.flux_path, cfg.fixed_prompt, dtype=dtype, device=device)
    return embeds, pooled


def run_training(cfg: TrainConfig, frozen=None, loader=None, disc_bundle=None, trainer=None,
                 device="cuda", mesh=None):
    """Programmatic entry (also used by tests with tiny models).

    frozen: {"vae", "vae_cfg", "flux", "flux_cfg", "backbone", "dists",
    "prompt_embeds", "pooled_prompt_embeds"} with tensors on ``device``; with
    it, cfg.extra["disc_channels"] names the three ConvNeXt stage widths.
    loader, trainer and the random numbers as in
    ``train_omgsr_s.run_training``: one torch.Generator on ``device`` seeded
    with cfg.seed draws the LoRA (VAE encoder, then DiT), the discriminator
    and every step's noise. mesh: as in ``train_omgsr_s.run_training`` (the
    DiT is placed by FSDP where the mesh has "fsdp", and the tree handed in
    is consumed)."""
    from omgsr_tpu_torch.convert.params import init_discriminator
    from omgsr_tpu_torch.lora import FLUX_TARGET_MODULES, SD_TARGET_MODULES, init_lora_tree
    from omgsr_tpu_torch.training.trainer import TrainerF
    from omgsr_tpu_torch.utils.dtypes import resolve_dtype

    device = resolve_device(device)
    start_run(cfg, mesh)
    dtype = resolve_dtype(cfg.mixed_precision)

    generator = torch.Generator(device=device)
    generator.manual_seed(int(cfg.seed))
    if trainer is None:
        if frozen is None:
            frozen, cn_cfg = build_frozen_f(cfg, dtype, device, mesh)
            frozen["prompt_embeds"], frozen["pooled_prompt_embeds"] = encode_fixed_prompt_f(cfg, dtype, device)
            channels = cn_cfg.dims[:3]
        else:
            channels = cfg.extra["disc_channels"]
        place_frozen(frozen, "flux", mesh, device)

        gen_lora = {
            "vae_encoder": init_lora_tree(
                generator, frozen["vae"]["encoder"], SD_TARGET_MODULES, cfg.vae_lora_rank, dtype
            ),
            "denoiser": init_lora_tree(
                generator, frozen["flux"], FLUX_TARGET_MODULES, cfg.flux_transformer_lora_rank, dtype
            ),
        }
        if disc_bundle is None:
            disc_bundle = init_discriminator(generator, channels, cfg.resolution, dtype, device)

        trainer = TrainerF(cfg, frozen, gen_lora, disc_bundle, mesh)

    # reference -F adapter names: train/train_omgsr_f.py:150,176
    adapter_names = {"vae_encoder": "vae_encoder_adapter", "denoiser": "flux_adapter"}
    return train_loop(cfg, trainer, loader, generator, device, dtype, adapter_names)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    mesh = cli_train_mesh(cfg.mesh_shape, resolve_device(args.device))
    return run_training(cfg, device=local_device(args.device), mesh=mesh)


if __name__ == "__main__":
    main()
