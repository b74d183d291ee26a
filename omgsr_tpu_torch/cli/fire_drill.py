"""Full-architecture fabricated-checkpoint fire drill of the port: the
real-weight-day rehearsal, runnable with no checkpoint at hand.

One command exercises the whole real-weight chain at real architecture on
``--device`` (the CUDA device unless ``--device cpu``):

  1. FABRICATE a sharded HF-layout checkpoint directory on disk with the
     port's writers (``tools/sd_checkpoint.py`` / ``tools/flux_checkpoint.py``):
     the full SD2.1 VAE (83.7M) + UNet (865.9M) in f32, or FLUX at full
     depth 19 + 38 with reduced width in bf16, the UNet or DiT in
     ceil(bytes / ``--max_shard_gb``) shards of about equal size with a
     ``*.safetensors.index.json`` (one file without an index where it fits)
     and the VAE in one file; plus LoRA adapters, a prompt .npz and LQ/GT
     probe images;
  2. PORT + INFER: the infer CLI (``cli.infer_omgsr_s`` / ``_f``) loads the
     directory through ``convert/porters.py`` (leaf-set validation on) and runs
     the one-step SR pipeline end to end (infer/omgsr_s_infer_model.py:11-23 is
     the reference chain being rehearsed);
  3. SCORE: ``cli.eval_sr`` computes PSNR/SSIM + DISTS/LPIPS/NIQE of the
     outputs against the GT directory (README.md:45-90 eval protocol), writing
     metrics JSON;
  4. ADAPTER ROUND-TRIP: a LoRA tree over the full ported VAE encoder is
     exported (``lora/adapter_io.save_adapter``) and read back
     (``load_adapter``), asserted leaf-exact;
  5. TORCH PARITY: ``cli.validate_checkpoint`` ports the same weights again
     and every stage's max_rel deviation must be <= ``--tolerance`` (1e-3, the
     BASELINE.md fidelity target) against the independent torch reference.

    python -m omgsr_tpu_torch.cli.fire_drill --family sd --root drill_sd
    python -m omgsr_tpu_torch.cli.fire_drill --family flux --root drill_flux

Exit code 0 and ``"passed": true`` in <root>/drill_report.json: each stage ran
at real architecture. ``--root`` is a scratch directory the drill owns: it
must not already hold a checkpoint. Flags are the JAX CLI's, with
``--device``; ``fabricate`` / ``run_drill`` also take the model configs as
keyword arguments (the published architectures by default), so a caller can
run the drill at small sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

from omgsr_tpu_torch.utils.devices import resolve_device

logger = logging.getLogger("omgsr_tpu_torch.fire_drill")

_STEM = "diffusion_pytorch_model.safetensors"


def _shard_count(nbytes: int, max_shard_bytes: int) -> int:
    """Files for ``nbytes`` of tensors at ``max_shard_bytes`` each: the
    port's writers split into that many files of about equal size."""
    return max(1, math.ceil(nbytes / max_shard_bytes))


def save_sharded_safetensors(tensors: dict, dirpath: str, max_shard_bytes: int) -> int:
    """Write an HF-style checkpoint of ``tensors`` (torch tensors or numpy
    arrays) in ceil(bytes / ``max_shard_bytes``) shards of about equal size
    plus the weight_map index, or one ``diffusion_pytorch_model.safetensors``
    without an index where everything fits (the layouts
    ``convert/porters.load_safetensors_dir`` reads); returns the number of
    files. The port's writer (``tools/sd_checkpoint.save_sharded``) writes
    the shards."""
    from safetensors.torch import save_file

    from omgsr_tpu_torch.tools.sd_checkpoint import save_sharded

    os.makedirs(dirpath, exist_ok=True)
    state = {k: torch.as_tensor(v).contiguous() for k, v in tensors.items()}
    n = _shard_count(sum(t.numel() * t.element_size() for t in state.values()), max_shard_bytes)
    if n == 1:
        save_file(state, os.path.join(dirpath, _STEM), metadata={"format": "pt"})
        return 1
    return len(save_sharded(state, dirpath, _STEM, n))


# The reduced-width / full-depth FLUX drill architecture: every block type at
# the published depth (19 dual + 38 single, FluxConfig defaults), width cut
# 24 -> 4 heads so the fabricate + port + torch-parity loop stays small.
FLUX_DRILL_OVERRIDES = dict(
    num_attention_heads=4,  # width 512 (head_dim stays 128 = sum axes_dims_rope)
    joint_attention_dim=512,
    pooled_projection_dim=256,
)


def fabricate(family: str, root: str, seed: int, max_shard_gb: float, *, vae_cfg=None, denoiser_cfg=None,
              device="cuda"):
    """Step 1: write the checkpoint directory + adapters + probe inputs.
    ``vae_cfg`` / ``denoiser_cfg`` default to the published SD2.1 VAE and
    UNet (f32) or the FLUX VAE and the reduced-width full-depth DiT (bf16).
    Returns the paths the later steps use."""
    from PIL import Image

    from omgsr_tpu_torch.convert.params import init_flux, init_unet, init_vae
    from omgsr_tpu_torch.lora import FLUX_TARGET_MODULES, SD_TARGET_MODULES, init_lora_tree
    from omgsr_tpu_torch.lora.adapter_io import save_adapter
    from omgsr_tpu_torch.models.configs import FLUX_DEV, FLUX_VAE, SD21_UNET, SD21_VAE
    from omgsr_tpu_torch.tools.flux_checkpoint import write_flux_checkpoint
    from omgsr_tpu_torch.tools.sd_checkpoint import write_sd_checkpoint
    from omgsr_tpu_torch.utils.tree import flatten_dict

    device = resolve_device(device)
    max_shard = int(max_shard_gb * (1 << 30))

    def shards(tree, dtype):
        return _shard_count(sum(t.numel() for t in flatten_dict(tree).values()) * dtype.itemsize, max_shard)

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for sub in ("vae", "unet", "transformer"):
        if os.path.isdir(os.path.join(root, sub)):
            raise SystemExit(
                f"--root {root!r} already contains {sub}/: the drill fabricates (and later deletes) its own "
                "scratch checkpoint; point --root at an empty directory, never at real weights")

    t0 = time.time()
    if family == "sd":
        vae_cfg, denoiser_cfg = vae_cfg or SD21_VAE, denoiser_cfg or SD21_UNET
        logger.info("initializing the SD2.1 VAE + UNet in f32 on %s", device)
        vp = init_vae(seed, vae_cfg, torch.float32, device)
        dp = init_unet(seed + 1, denoiser_cfg, torch.float32, device)
        write_sd_checkpoint(root, vp, vae_cfg, dp, denoiser_cfg, dtype=torch.float32,
                            unet_shards=shards(dp, torch.float32))
        np.savez(os.path.join(root, "prompt.npz"),
                 prompt_embeds=rng.normal(size=(1, 77, denoiser_cfg.cross_attention_dim)).astype(np.float32))
        lora_targets, den_dir, den_lora_name = SD_TARGET_MODULES, "unet", "unet_lora_adapter"
        vae_ad = "vae_encoder_lora_adapter"
    elif family == "flux":
        vae_cfg = vae_cfg or FLUX_VAE
        denoiser_cfg = denoiser_cfg or dataclasses.replace(FLUX_DEV, **FLUX_DRILL_OVERRIDES)
        logger.info("initializing FLUX at depth %d+%d, width %d (bf16) on %s", denoiser_cfg.num_layers,
                    denoiser_cfg.num_single_layers, denoiser_cfg.inner_dim, device)
        vp = init_vae(seed, vae_cfg, torch.bfloat16, device)
        dp = init_flux(seed + 1, denoiser_cfg, torch.bfloat16, device)
        prompt = (rng.normal(size=(1, 128, denoiser_cfg.joint_attention_dim)).astype(np.float32),
                  rng.normal(size=(1, denoiser_cfg.pooled_projection_dim)).astype(np.float32))
        write_flux_checkpoint(root, vp, vae_cfg, dp, denoiser_cfg, dtype=torch.bfloat16,
                              transformer_shards=shards(dp, torch.bfloat16), prompt=prompt)
        # reference -F adapter names: train/train_omgsr_f.py:150,176
        lora_targets, den_dir, den_lora_name = FLUX_TARGET_MODULES, "transformer", "flux_adapter"
        vae_ad = "vae_encoder_adapter"
    else:
        raise ValueError(f"unknown family {family!r}")
    n_files = {sub: sum(name.endswith(".safetensors") for name in os.listdir(os.path.join(root, sub)))
               for sub in ("vae", den_dir)}
    logger.info("wrote the checkpoint directory (%d vae + %d %s files) in %.1f s", n_files["vae"],
                n_files[den_dir], den_dir, time.time() - t0)

    # LoRA adapters at the production rank layout (zero-init B: attaching them
    # changes no output; training would move them)
    lora_dir = os.path.join(root, "lora")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)
    save_adapter(init_lora_tree(gen, vp["encoder"], SD_TARGET_MODULES, 4), os.path.join(lora_dir, vae_ad),
                 rank=4, targets=SD_TARGET_MODULES)
    save_adapter(init_lora_tree(gen, dp, lora_targets, 4), os.path.join(lora_dir, den_lora_name), rank=4,
                 targets=lora_targets)
    del vp, dp

    # probe images: GT (reference output) + its bicubic-down LQ input
    gt_dir, lq_dir = os.path.join(root, "gt"), os.path.join(root, "lq")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(lq_dir, exist_ok=True)
    gt = rng.integers(0, 255, (128, 128, 3), dtype=np.uint8)
    Image.fromarray(gt).save(os.path.join(gt_dir, "probe.png"))
    Image.fromarray(gt).resize((32, 32), Image.BICUBIC).save(os.path.join(lq_dir, "probe.png"))
    return {"lora_dir": lora_dir, "gt_dir": gt_dir, "lq_dir": lq_dir, "den_dir": den_dir,
            "den_lora_name": den_lora_name, "lora_targets": lora_targets, "files": n_files}


def run_drill(args, *, vae_cfg=None, denoiser_cfg=None) -> dict:
    """The five stages on ``args`` (``main``'s flags); ``vae_cfg`` /
    ``denoiser_cfg`` go to ``fabricate``."""
    from omgsr_tpu_torch.cli import validate_checkpoint as VC

    device = resolve_device(args.device)
    report = {"family": args.family, "root": args.root, "stages": {}}
    t_all = time.time()

    # ---- 1. fabricate -------------------------------------------------------
    t0 = time.time()
    paths = fabricate(args.family, args.root, args.seed, args.max_shard_gb, vae_cfg=vae_cfg,
                      denoiser_cfg=denoiser_cfg, device=device)
    report["stages"]["fabricate_s"] = round(time.time() - t0, 1)
    report["stages"]["checkpoint_files"] = paths["files"]

    # ---- 2. porter -> pipeline through the infer CLI ------------------------
    t0 = time.time()
    out_dir = os.path.join(args.root, "sr_out")
    common = ["--input_image", paths["lq_dir"], "--output_dir", out_dir, "--lora_path", paths["lora_dir"],
              "--prompt_npz", os.path.join(args.root, "prompt.npz"), "--process_size", str(args.process_size),
              "--upscale", "4", "--align_method", "adain", "--device", str(device)]
    if args.family == "sd":
        from omgsr_tpu_torch.cli import infer_omgsr_s as infer

        infer.main(infer.parse_args(common + ["--sd_path", args.root, "--weight_dtype", "fp32"]))
    else:
        from omgsr_tpu_torch.cli import infer_omgsr_f as infer

        infer.main(infer.parse_args(common + ["--flux_path", args.root, "--weight_dtype", "bf16"]))
    if not os.path.isdir(out_dir) or not os.listdir(out_dir):
        raise RuntimeError("the infer CLI produced no outputs")
    report["stages"]["port_and_infer_s"] = round(time.time() - t0, 1)

    # ---- 3. eval_sr scores outputs vs GT ------------------------------------
    # PSNR/SSIM + DISTS (a random ConvNeXt-T: the drill fabricates no DINOv3
    # weights; it exercises the metric path) + LPIPS + NIQE against a pristine
    # model fitted on the drill's own GT images
    t0 = time.time()
    from PIL import Image

    from omgsr_tpu_torch.cli.eval_sr import main as eval_main
    from omgsr_tpu_torch.utils.niqe import fit_pristine, save_pristine

    gt_imgs = [np.asarray(Image.open(os.path.join(paths["gt_dir"], f)).convert("RGB"), np.float64) / 255.0
               for f in sorted(os.listdir(paths["gt_dir"]))]
    niqe_path = os.path.join(args.root, "niqe_pristine.npz")
    save_pristine(niqe_path, fit_pristine(gt_imgs))
    metrics_path = os.path.join(args.root, "sr_metrics.json")
    eval_main(["--sr_dir", out_dir, "--gt_dir", paths["gt_dir"], "--dists", "--dinov3_size", "tiny", "--lpips",
               "--niqe_params", niqe_path, "--output", metrics_path, "--device", str(device)])
    with open(metrics_path) as f:
        report["stages"]["eval_sr"] = json.load(f)
    report["stages"]["eval_sr_s"] = round(time.time() - t0, 1)

    # ---- 4. adapter export/import round-trip on the full ported VAE ---------
    t0 = time.time()
    from omgsr_tpu_torch.convert.hf_config import vae_config_from_json
    from omgsr_tpu_torch.convert.porters import port_diffusers_vae
    from omgsr_tpu_torch.lora import SD_TARGET_MODULES, init_lora_tree
    from omgsr_tpu_torch.lora.adapter_io import load_adapter, save_adapter
    from omgsr_tpu_torch.utils.tree import flatten_dict

    vae_dir = os.path.join(args.root, "vae")
    vp = port_diffusers_vae(vae_dir, cfg=vae_config_from_json(vae_dir), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(99)
    ltree = init_lora_tree(gen, vp["encoder"], SD_TARGET_MODULES, 4)
    del vp
    rt_dir = os.path.join(args.root, "lora_roundtrip")
    save_adapter(ltree, rt_dir, rank=4, targets=SD_TARGET_MODULES)
    back, meta = load_adapter(rt_dir, device=device)
    if meta.get("r") != 4:
        raise RuntimeError(f"adapter round-trip: rank {meta}")
    fa, fb = flatten_dict(ltree), flatten_dict(back)
    if set(fa) != set(fb) or not all(torch.equal(fa[p].float(), fb[p].float()) for p in fa):
        raise RuntimeError("adapter round-trip is not leaf-exact")
    report["stages"]["adapter_roundtrip_exact"] = True
    report["stages"]["adapter_roundtrip_s"] = round(time.time() - t0, 1)

    # ---- 5. torch parity at full architecture -------------------------------
    t0 = time.time()
    if args.family == "sd":
        parity = VC.validate_sd(args.root, device=device)
    else:
        parity = VC.validate_flux(args.root, tokens=args.flux_tokens, device=device)
    report["stages"]["torch_parity"] = parity
    report["stages"]["torch_parity_s"] = round(time.time() - t0, 1)
    worst = max(v["max_rel"] for v in parity.values() if isinstance(v, dict) and "max_rel" in v)
    errored = [k for k, v in parity.items() if isinstance(v, dict) and "error" in v]
    report["worst_parity_max_rel"] = worst
    report["passed"] = bool(worst <= args.tolerance and not errored)
    report["total_s"] = round(time.time() - t_all, 1)
    return report


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--family", choices=["sd", "flux"], required=True)
    parser.add_argument("--root", required=True, help="scratch dir for the fabricated checkpoint + outputs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_shard_gb", type=float, default=2.0,
                        help="shard size; SD2.1's 3.46 GB f32 UNet -> 2 shards")
    parser.add_argument("--process_size", type=int, default=128,
                        help="SR tile size for the infer step (real-weight day uses 512/1024)")
    parser.add_argument("--flux_tokens", type=int, default=64)
    parser.add_argument("--tolerance", type=float, default=1e-3)
    parser.add_argument("--keep", action="store_true",
                        help="keep the fabricated checkpoint dir (default: delete everything except "
                        "drill_report.json)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no CUDA device is present")
    return parser.parse_args(argv)


def main(argv=None, *, vae_cfg=None, denoiser_cfg=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s %(message)s")
    resolve_device(args.device)
    pre_existing = set(os.listdir(args.root)) if os.path.isdir(args.root) else set()
    report = run_drill(args, vae_cfg=vae_cfg, denoiser_cfg=denoiser_cfg)
    report_path = os.path.join(args.root, "drill_report.json")
    if not args.keep:
        # delete only what the drill created this run, never pre-existing files
        for name in set(os.listdir(args.root)) - pre_existing:
            p = os.path.join(args.root, name)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    if not report["passed"]:
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
