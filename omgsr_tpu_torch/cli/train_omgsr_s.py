"""OMGSR-S training CLI.

    python -m omgsr_tpu_torch.cli.train_omgsr_s --config cfg.yml [key=value ...]
    torchrun --nproc_per_node=N -m omgsr_tpu_torch.cli.train_omgsr_s --config cfg.yml "mesh_shape={data: N}"

Mirrors train/train_omgsr_s.py's flow: config -> frozen VAE + UNet +
LoRA(VAE-encoder rank 16, UNet rank 32) -> DISTS + multi-level discriminator
-> G/D AdamW loop with grad accumulation -> periodic image triptychs; plus
full-state resume (the reference's resume is a TODO stub,
train/train_omgsr_s.py:394-419).

The frozen SD2.1 VAE and UNet come from ``cfg.sd_path``, the DINOv3
ConvNeXt from ``cfg.extra["dinov3_weights_path"]`` (from a seed, with a
warning, where none is set), and the fixed prompt's embeddings from
``cfg.fixed_prompt_path`` or the checkpoint's text encoder. The adapters are
exported in the reference's directory layout (``weight-{step}/``) at every
checkpoint step and at the end. The training pairs come from
``cfg.dataset_txt_or_dir_paths`` through ``data.dataset.PairedLoader``, with
the Real-ESRGAN degradation of ``cfg.degradation_params`` (default: the
package's params_realesrgan.yml) on the device; ``run_training`` also takes
an iterable of LQ/HQ pairs in memory (and optionally the frozen bundle).

Under torchrun (one process per GPU) the world trains data-parallel over
``cfg.mesh_shape`` (default: every rank on "data"): ``train_batch_size`` is
the global batch, split over "data" and replicated over "fsdp"; each rank's
loader yields its rows; the gradients are averaged over "data"
(``training/trainer.py``); with an "fsdp" axis the frozen UNet is ported to
the host and placed leaf by leaf (``parallel.sharding.shard_params_fsdp``).
Rank 0 alone writes ``cfg.yml``, the metrics, the triptychs, the checkpoints
and the adapters, and the ranks meet at a barrier after each checkpoint; on
``resume_from_checkpoint: latest`` rank 0 picks the file and every rank
restores it.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time

import numpy as np
import torch

from omgsr_tpu_torch.config import TrainConfig, load_config, save_config
from omgsr_tpu_torch.parallel.distributed import is_main_process, local_device
from omgsr_tpu_torch.parallel.sharding import cli_train_mesh, uses_fsdp
from omgsr_tpu_torch.utils.devices import resolve_device

logger = logging.getLogger("omgsr_tpu_torch.train")


def build_frozen_s(cfg: TrainConfig, dtype, device="cuda", mesh=None):
    """Load the frozen model bundle for -S from cfg.sd_path: (bundle, the
    ConvNeXt config). With an "fsdp" axis in ``mesh`` the UNet is ported to
    the host, for ``place_frozen`` to place on ``device`` leaf by leaf."""
    from omgsr_tpu_torch.convert.hf_config import unet_config_from_json, vae_config_from_json
    from omgsr_tpu_torch.convert.params import init_convnext
    from omgsr_tpu_torch.convert.porters import port_diffusers_unet, port_diffusers_vae, port_dinov3_convnext
    from omgsr_tpu_torch.losses.dists import init_dists
    from omgsr_tpu_torch.models.configs import CONVNEXT_SIZES

    device = resolve_device(device)
    if not cfg.sd_path:
        raise ValueError("cfg.sd_path is not set: name the SD2.1 checkpoint directory, or hand run_training "
                         "the frozen bundle in memory (frozen=...)")
    vae_dir = os.path.join(cfg.sd_path, "vae")
    unet_dir = os.path.join(cfg.sd_path, "unet")
    vae_cfg = vae_config_from_json(vae_dir)
    unet_cfg = unet_config_from_json(unet_dir)
    vae_params = port_diffusers_vae(vae_dir, cfg=vae_cfg, dtype=dtype, device=device)
    unet_params = port_diffusers_unet(unet_dir, cfg=unet_cfg, dtype=dtype, device="cpu" if uses_fsdp(mesh) else device)

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
        "unet": unet_params,
        "unet_cfg": unet_cfg,
        "backbone": backbone,
        "dists": init_dists(backbone, cn_cfg.dims),
    }, cn_cfg


def encode_fixed_prompt(cfg: TrainConfig, dtype, device="cuda"):
    """The fixed prompt's embeddings: cfg.fixed_prompt_path (.npz), else
    cfg.fixed_prompt through the text encoder of cfg.sd_path."""
    from omgsr_tpu_torch.cli.prompts import encode_prompt_sd, load_prompt_npz

    device = resolve_device(device)
    if cfg.fixed_prompt_path:
        return load_prompt_npz(cfg.fixed_prompt_path)["prompt_embeds"].to(device=device, dtype=dtype)
    return encode_prompt_sd(cfg.sd_path, cfg.fixed_prompt, dtype, device)


def save_triptych(path, lq, pred, hq):
    """lq|pred|hq stacked vertically, like the reference's save_image grid
    (train/train_omgsr_s.py:494-502)."""
    from omgsr_tpu_torch.utils.image_io import array01_to_pil

    rows = [x[0].detach().float().cpu().numpy() * 0.5 + 0.5 for x in (lq, pred, hq)]
    array01_to_pil(np.concatenate(rows, axis=0)).save(path)


def append_metrics_jsonl(path, global_step, metrics, s_per_step):
    """One JSON line per optimizer step (opt-in via cfg.extra
    metrics_jsonl=path): loss trajectories, GAN balance, resume continuity."""
    rec = {"step": global_step, "s_per_step": round(s_per_step, 4), "time": time.time()}
    rec.update({k: float(v) for k, v in metrics.items()})
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def build_loader(cfg: TrainConfig, device="cuda", mesh=None):
    """The Real-ESRGAN pair loader of cfg.dataset_txt_or_dir_paths, seeded
    with cfg.seed; a ValueError where it would yield no batch. On a mesh it
    yields this rank's rows of each global batch of cfg.train_batch_size,
    cropped and degraded from (cfg.seed, its "data" index) and logged so:
    the reference's per-rank loader, where the JAX loader has no
    multi-process mode."""
    from omgsr_tpu_torch.data.dataset import PairedDataset, PairedLoader, rank_seed
    from omgsr_tpu_torch.data.degradation import RealESRGANDegrader, load_degradation_params

    rank, world = (mesh.rank("data"), mesh.size("data")) if mesh is not None else (0, 1)
    seed = rank_seed(cfg.seed, rank)
    if world > 1:
        logger.info("loader: rows %d-%d of each global batch of %d; crops and degradation seeded with %d "
                    "(seed %d, data rank %d)", rank * cfg.train_batch_size // world,
                    (rank + 1) * cfg.train_batch_size // world - 1, cfg.train_batch_size, seed, cfg.seed, rank)
    degrader = RealESRGANDegrader(load_degradation_params(cfg.degradation_params), resolution=cfg.resolution,
                                  seed=seed)
    dataset = PairedDataset(cfg.dataset_txt_or_dir_paths, cfg.resolution, seed=seed)
    loader = PairedLoader(dataset, cfg.train_batch_size, degrader, seed=cfg.seed, device=device, rank=rank,
                          world=world)
    if len(loader) == 0:
        raise ValueError(f"dataset_txt_or_dir_paths {cfg.dataset_txt_or_dir_paths!r} hold {len(dataset)} images, "
                         f"fewer than one batch of train_batch_size {cfg.train_batch_size}")
    return loader


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    mesh = cli_train_mesh(cfg.mesh_shape, resolve_device(args.device))
    return run_training(cfg, device=local_device(args.device), mesh=mesh)


def run_training(cfg: TrainConfig, frozen=None, loader=None, disc_bundle=None, trainer=None,
                 device="cuda", mesh=None):
    """Programmatic entry (also used by tests with tiny models).

    frozen: {"vae", "vae_cfg", "unet", "unet_cfg", "backbone", "dists",
    "prompt_embeds"} with tensors on ``device``; with it, cfg.extra
    ["disc_channels"] names the three ConvNeXt stage widths. loader: an
    iterable of {"lq", "hq"} batches (arrays or tensors, (B,H,W,3) in
    [-1,1]), iterated again when exhausted; without it, ``build_loader``'s.
    trainer: a pre-built TrainerS to continue with; its cfg must match the
    loop-relevant fields of ``cfg``. Every random number of the step (LoRA
    init, discriminator init, the steps' noise) comes from one
    torch.Generator on ``device`` seeded with cfg.seed; the loader's from
    its own generators, seeded with cfg.seed as in the JAX package.
    mesh: the ``parallel.sharding.Mesh`` of a world of processes, every one
    of which makes this call; ``loader`` then yields this rank's rows, and
    the UNet is placed here where the mesh has "fsdp" (``place_frozen``: an
    in-memory tree handed in is consumed as it is placed; hand over a copy of
    its dicts to keep it).
    """
    from omgsr_tpu_torch.convert.params import init_discriminator
    from omgsr_tpu_torch.lora import SD_TARGET_MODULES, init_lora_tree
    from omgsr_tpu_torch.training.trainer import TrainerS
    from omgsr_tpu_torch.utils.dtypes import resolve_dtype

    device = resolve_device(device)
    start_run(cfg, mesh)
    dtype = resolve_dtype(cfg.mixed_precision)

    generator = torch.Generator(device=device)
    generator.manual_seed(int(cfg.seed))
    if trainer is None:
        if frozen is None:
            frozen, cn_cfg = build_frozen_s(cfg, dtype, device, mesh)
            frozen["prompt_embeds"] = encode_fixed_prompt(cfg, dtype, device)
            channels = cn_cfg.dims[:3]
        else:
            channels = cfg.extra["disc_channels"]
        place_frozen(frozen, "unet", mesh, device)

        gen_lora = {
            "vae_encoder": init_lora_tree(
                generator, frozen["vae"]["encoder"], SD_TARGET_MODULES, cfg.vae_lora_rank, dtype
            ),
            "denoiser": init_lora_tree(
                generator, frozen["unet"], SD_TARGET_MODULES, cfg.unet_lora_rank, dtype
            ),
        }
        if disc_bundle is None:
            disc_bundle = init_discriminator(generator, channels, cfg.resolution, dtype, device)

        trainer = TrainerS(cfg, frozen, gen_lora, disc_bundle, mesh)

    adapter_names = {"vae_encoder": "vae_encoder_lora_adapter", "denoiser": "unet_lora_adapter"}
    return train_loop(cfg, trainer, loader, generator, device, dtype, adapter_names)


def start_run(cfg: TrainConfig, mesh):
    """Logging, the output directory and its ``cfg.yml`` (rank 0 writes),
    and the mesh in the log; a global batch that does not split over "data"
    is refused first."""
    from omgsr_tpu_torch.parallel.sharding import data_rows

    data_rows(cfg.train_batch_size, mesh)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    if is_main_process():
        os.makedirs(cfg.output_dir, exist_ok=True)
        save_config(cfg, os.path.join(cfg.output_dir, "cfg.yml"))
        if mesh is not None:
            import torch.distributed as dist

            logger.info("training on a world of %d processes, mesh %s: global batch %d, %d rows a rank",
                        dist.get_world_size(), mesh.shape, cfg.train_batch_size,
                        cfg.train_batch_size // mesh.size("data"))


def place_frozen(frozen, key: str, mesh, device):
    """On a mesh with "fsdp", ``frozen[key]`` (the UNet or the DiT) placed on
    ``device`` by ``shard_params_fsdp``, leaf by leaf from wherever it lies;
    the tree it was is consumed (its dicts emptied) as it is placed."""
    from omgsr_tpu_torch.parallel.sharding import shard_params_fsdp

    if uses_fsdp(mesh):
        frozen[key] = shard_params_fsdp(frozen[key], mesh, device=device, consume=True)


def train_loop(cfg: TrainConfig, trainer, loader, generator, device, dtype, adapter_names: dict):
    """The loop both trainers share: resume (the full state) where the config
    asks, then micro-steps until ``cfg.max_train_steps`` optimizer steps, with
    metrics, triptychs, checkpoints and adapter exports (``adapter_names``:
    {"vae_encoder": ..., "denoiser": ...}) at their configured steps, and a
    last checkpoint and export at the end. Each step's noise is drawn from
    ``generator``; ``loader`` None builds ``build_loader``'s. Returns the
    trainer. On the trainer's mesh every rank draws the global batch's noise
    and keeps its rows; rank 0 alone writes."""
    from omgsr_tpu_torch.training.checkpoint import (
        export_adapters,
        latest_checkpoint,
        restore_train_state,
        save_train_state,
    )
    from omgsr_tpu_torch.parallel.distributed import barrier, broadcast_object
    from omgsr_tpu_torch.training.trainer import draw_step_noise, step_noise_rows

    mesh = trainer.mesh
    writer = is_main_process()
    data = mesh.size("data") if mesh is not None else 1

    def checkpoint(step):
        if writer:
            save_train_state(cfg.output_dir, trainer.state, step)
            export_adapters(cfg.output_dir, step, trainer.state["gen"]["lora"], cfg, adapter_names)
        if mesh is not None:
            barrier()

    # resume (full state). state["step"] counts MICRO-steps (one per
    # train_step call, in lockstep with the optimizers' accumulation
    # counters); the optimizer/global step is its floor division by the
    # accumulation factor, so a resume mid-accumulation stays aligned.
    start_step = 0
    micro_step = 0
    if cfg.resume_from_checkpoint:
        path = cfg.resume_from_checkpoint
        if path == "latest":
            path = latest_checkpoint(cfg.output_dir) if writer else None
            if mesh is not None:  # rank 0's pick, restored on every rank
                path = broadcast_object(path)
        if path:
            trainer.state = restore_train_state(path, trainer.state)
            micro_step = int(trainer.state["step"])
            start_step = micro_step // max(cfg.gradient_accumulation_steps, 1)
            logger.info(
                "resumed from %s at optimizer step %d (micro step %d)",
                path, start_step, micro_step,
            )

    if loader is None:
        loader = build_loader(cfg, device, mesh)

    if cfg.max_train_steps is None:
        # reference fallback: epochs * ceil(len(loader)/accum)
        # (train/train_omgsr_s.py:319-325)
        cfg.max_train_steps = cfg.num_train_epochs * math.ceil(
            len(loader) / cfg.gradient_accumulation_steps
        )

    vae_cfg = trainer.frozen["vae_cfg"]
    global_step = start_step
    t0 = time.time()
    metrics_jsonl = cfg.extra.get("metrics_jsonl") if writer else None
    while global_step < (cfg.max_train_steps or 0):
        for batch in loader:
            batch = {k: torch.as_tensor(v).to(device=device, dtype=dtype) for k, v in batch.items()}
            b, h, w, _ = batch["hq"].shape
            # the global batch's noise on every rank (one generator, seeded alike), then this rank's rows
            latent_shape = (b * data, h // vae_cfg.downscale, w // vae_cfg.downscale, vae_cfg.latent_channels)
            noise = draw_step_noise(generator, (b * data, h, w, 3), latent_shape, device, dtype)
            if data > 1:
                noise = step_noise_rows(noise, mesh.rank("data") * b, b)
            metrics, pred = trainer.train_step(batch, noise)
            micro_step += 1
            if micro_step % cfg.gradient_accumulation_steps == 0:
                global_step += 1
                if metrics_jsonl:
                    append_metrics_jsonl(
                        metrics_jsonl, global_step, metrics,
                        (time.time() - t0) / max(global_step - start_step, 1),
                    )
                if writer and global_step % 10 == 0:
                    logger.info(
                        "step %d | %s | %.2f s/it",
                        global_step,
                        " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()),
                        (time.time() - t0) / max(global_step - start_step, 1),
                    )
                if writer and global_step % cfg.save_img_steps == 0:
                    save_triptych(
                        os.path.join(cfg.output_dir, f"img-{global_step}.jpg"),
                        batch["lq"], pred, batch["hq"],
                    )
                if global_step % cfg.checkpointing_steps == 0:
                    checkpoint(global_step)
                if global_step >= (cfg.max_train_steps or 0):
                    break
        else:
            continue
        break

    checkpoint(global_step)
    logger.info("training done at step %d", global_step)
    return trainer


if __name__ == "__main__":
    main()
