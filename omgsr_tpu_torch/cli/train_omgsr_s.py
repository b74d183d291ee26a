"""OMGSR-S training CLI.

    python -m omgsr_tpu_torch.cli.train_omgsr_s --config cfg.yml [key=value ...]

Mirrors train/train_omgsr_s.py's flow: config -> frozen VAE + UNet +
LoRA(VAE-encoder rank 16, UNet rank 32) -> DISTS + multi-level discriminator
-> G/D AdamW loop with grad accumulation -> periodic image triptychs; plus
full-state resume (the reference's resume is a TODO stub,
train/train_omgsr_s.py:394-419).

Loading the trained SD2.1 / DINOv3 weights and the prompt encoder from
``cfg.sd_path`` is not ported yet (load-path slice), nor are the dataset and
the Real-ESRGAN degradation (data slice): ``run_training`` takes the frozen
bundle and an iterable of LQ/HQ pairs in memory, and ``main`` raises until
those slices exist. Adapter export in the reference's directory layout also
waits for the load-path slice.
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
from omgsr_tpu_torch.utils.devices import resolve_device

logger = logging.getLogger("omgsr_tpu_torch.train")


def build_frozen_s(cfg: TrainConfig, dtype, device="cuda"):
    """Load the frozen model bundle for -S from cfg.sd_path."""
    raise NotImplementedError(
        "sd_path: loading SD2.1 / DINOv3 checkpoints is not ported yet (load-path slice); "
        "hand run_training the frozen bundle in memory (frozen=...)"
    )


def encode_fixed_prompt(cfg: TrainConfig, dtype, device="cuda"):
    raise NotImplementedError(
        "text encoding is not ported yet (load-path slice): put prompt_embeds into the "
        "frozen bundle handed to run_training"
    )


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


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    run_training(cfg, device=args.device)


def run_training(cfg: TrainConfig, frozen=None, loader=None, disc_bundle=None, trainer=None,
                 device="cuda"):
    """Programmatic entry (also used by tests with tiny models).

    frozen: {"vae", "vae_cfg", "unet", "unet_cfg", "backbone", "dists",
    "prompt_embeds"} with tensors on ``device``; with it, cfg.extra
    ["disc_channels"] names the three ConvNeXt stage widths. loader: an
    iterable of {"lq", "hq"} batches (arrays or tensors, (B,H,W,3) in
    [-1,1]), iterated again when exhausted. trainer: a pre-built TrainerS to
    continue with; its cfg must match the loop-relevant fields of ``cfg``.
    Every random number (LoRA init, discriminator init, the steps' noise)
    comes from one torch.Generator on ``device`` seeded with cfg.seed.
    """
    from omgsr_tpu_torch.convert.params import init_discriminator
    from omgsr_tpu_torch.lora import SD_TARGET_MODULES, init_lora_tree
    from omgsr_tpu_torch.training.checkpoint import (
        latest_checkpoint,
        restore_train_state,
        save_train_state,
    )
    from omgsr_tpu_torch.training.trainer import TrainerS, draw_step_noise
    from omgsr_tpu_torch.utils.dtypes import resolve_dtype

    device = resolve_device(device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    os.makedirs(cfg.output_dir, exist_ok=True)
    save_config(cfg, os.path.join(cfg.output_dir, "cfg.yml"))
    dtype = resolve_dtype(cfg.mixed_precision)

    generator = torch.Generator(device=device)
    generator.manual_seed(int(cfg.seed))
    if trainer is None:
        if frozen is None:
            frozen, cn_cfg = build_frozen_s(cfg, dtype, device)
            frozen["prompt_embeds"] = encode_fixed_prompt(cfg, dtype, device)
            channels = cn_cfg.dims[:3]
        else:
            channels = cfg.extra["disc_channels"]

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

        trainer = TrainerS(cfg, frozen, gen_lora, disc_bundle)

    # resume (full state). state["step"] counts MICRO-steps (one per
    # train_step call, in lockstep with the optimizers' accumulation
    # counters); the optimizer/global step is its floor division by the
    # accumulation factor, so a resume mid-accumulation stays aligned.
    start_step = 0
    micro_step = 0
    if cfg.resume_from_checkpoint:
        path = (
            latest_checkpoint(cfg.output_dir)
            if cfg.resume_from_checkpoint == "latest"
            else cfg.resume_from_checkpoint
        )
        if path:
            trainer.state = restore_train_state(path, trainer.state)
            micro_step = int(trainer.state["step"])
            start_step = micro_step // max(cfg.gradient_accumulation_steps, 1)
            logger.info(
                "resumed from %s at optimizer step %d (micro step %d)",
                path, start_step, micro_step,
            )

    if loader is None:
        raise NotImplementedError(
            "dataset_txt_or_dir_paths: the paired dataset and the Real-ESRGAN degradation are "
            "not ported yet (data slice); hand run_training a loader of LQ/HQ pairs"
        )

    if cfg.max_train_steps is None:
        # reference fallback: epochs * ceil(len(loader)/accum)
        # (train/train_omgsr_s.py:319-325)
        cfg.max_train_steps = cfg.num_train_epochs * math.ceil(
            len(loader) / cfg.gradient_accumulation_steps
        )

    vae_cfg = trainer.frozen["vae_cfg"]
    global_step = start_step
    t0 = time.time()
    metrics_jsonl = cfg.extra.get("metrics_jsonl")
    while global_step < (cfg.max_train_steps or 0):
        for batch in loader:
            batch = {k: torch.as_tensor(v).to(device=device, dtype=dtype) for k, v in batch.items()}
            b, h, w, _ = batch["hq"].shape
            latent_shape = (b, h // vae_cfg.downscale, w // vae_cfg.downscale, vae_cfg.latent_channels)
            noise = draw_step_noise(generator, batch["hq"].shape, latent_shape, device, dtype)
            metrics, pred = trainer.train_step(batch, noise)
            micro_step += 1
            if micro_step % cfg.gradient_accumulation_steps == 0:
                global_step += 1
                if metrics_jsonl:
                    append_metrics_jsonl(
                        metrics_jsonl, global_step, metrics,
                        (time.time() - t0) / max(global_step - start_step, 1),
                    )
                if global_step % 10 == 0:
                    logger.info(
                        "step %d | %s | %.2f s/it",
                        global_step,
                        " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()),
                        (time.time() - t0) / max(global_step - start_step, 1),
                    )
                if global_step % cfg.save_img_steps == 0:
                    save_triptych(
                        os.path.join(cfg.output_dir, f"img-{global_step}.jpg"),
                        batch["lq"], pred, batch["hq"],
                    )
                if global_step % cfg.checkpointing_steps == 0:
                    save_train_state(cfg.output_dir, trainer.state, global_step)
                if global_step >= (cfg.max_train_steps or 0):
                    break
        else:
            continue
        break

    save_train_state(cfg.output_dir, trainer.state, global_step)
    logger.info("training done at step %d", global_step)
    return trainer


if __name__ == "__main__":
    main()
