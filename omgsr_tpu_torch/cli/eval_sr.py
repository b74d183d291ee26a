"""Quantitative SR evaluation over an output / ground-truth folder pair.

    python -m omgsr_tpu_torch.cli.eval_sr --sr_dir out/ --gt_dir gt/ \\
        --crop_border 4 --y_channel --output metrics.json \\
        --dists --lpips --clipiqa --niqe_params pristine.npz

Pairs SR outputs with ground-truth images by file stem and reports per-image
and mean PSNR / SSIM with the SR-paper conventions (border crop, BT.601 Y
channel), and optionally DISTS (``losses/dists.py`` over a DINOv3 ConvNeXt),
LPIPS-VGG (``utils/lpips.py``), CLIP-IQA (``models/clip_vision.py``) and NIQE
(``utils/niqe.py``, on the host). Every metric but NIQE runs on ``--device``
(the CUDA device unless ``--device cpu``). Flags are the JAX CLI's.

Where the JAX CLI's behaviour was faulty, the port differs on purpose:

  * ``--output`` serialises per-image rows and the summary alike: NaN as
    null, an infinity as the string "inf" / "-inf" (the JAX CLI writes an
    infinite per-image value as null and leaves the summary non-strict);
  * ``--clip_vision_path`` reads the tower's config from the directory's
    config.json (``vision_config``), not CLIP-L's always;
  * CLIP-IQA takes the checkpoint's learned ``logit_scale`` (exp of it);
    100 is the fallback of a tower without one;
  * an image smaller than ``--metric_crop`` is scored at full size with a
    warning, not silently.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os

import numpy as np
import torch

from omgsr_tpu_torch.data.dataset import collect_paths
from omgsr_tpu_torch.utils.devices import resolve_device

logger = logging.getLogger("omgsr_tpu_torch.eval_sr")


def _load01(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _to_y(arr: np.ndarray) -> np.ndarray:
    """BT.601 luma (the SR-paper convention): Y in [0,1] from RGB in [0,1]."""
    y = arr @ np.asarray([65.481, 128.553, 24.966], np.float32) + 16.0
    return (y / 255.0)[..., None]


def pair_by_stem(sr_paths: list[str], gt_paths: list[str]):
    """Exact-stem pairing, plus a single-trailing-suffix fallback
    (``name_out.png`` -> ``name.png``) that only fires when unambiguous: if
    two SR files would strip to the same ground truth, both are reported
    missing rather than scored against the wrong reference."""
    gt_by_stem: dict[str, str] = {}
    for p in gt_paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        if stem in gt_by_stem and gt_by_stem[stem] != p:
            raise ValueError(f"duplicate ground-truth stem {stem!r}: {gt_by_stem[stem]} vs {p} "
                             "— pass disjoint --gt_dir trees or rename")
        gt_by_stem[stem] = p
    pairs, missing, fallback = [], [], {}
    claimed = set()
    for sp in sorted(sr_paths):
        stem = os.path.splitext(os.path.basename(sp))[0]
        hit = gt_by_stem.get(stem)
        if hit:
            pairs.append((sp, hit))
            claimed.add(hit)
        else:
            fallback.setdefault(stem.rsplit("_", 1)[0], []).append(sp)
    for base, sps in sorted(fallback.items()):
        hit = gt_by_stem.get(base)
        if hit and len(sps) == 1 and hit not in claimed:
            pairs.append((sps[0], hit))
        else:
            missing.extend(sps)
    return pairs, missing


def _pm1(a01, device):
    return torch.from_numpy(np.ascontiguousarray(a01))[None].to(device) * 2 - 1


def build_dists_fn(dinov3_weights_path=None, size: str = "large", device="cuda"):
    """DISTS closure (a01, b01) -> float over a ported (or random, with a
    warning) DINOv3 ConvNeXt: the training objective's perceptual stack."""
    from omgsr_tpu_torch.losses.dists import dists_loss, init_dists
    from omgsr_tpu_torch.models.configs import CONVNEXT_SIZES

    device = resolve_device(device)
    cn_cfg = CONVNEXT_SIZES[size]
    if dinov3_weights_path:
        from omgsr_tpu_torch.convert.porters import port_dinov3_convnext

        backbone = port_dinov3_convnext(dinov3_weights_path, cfg=cn_cfg, device=device)
    else:
        from omgsr_tpu_torch.convert.params import init_convnext

        logger.warning("no --dinov3_weights_path — DISTS uses a random ConvNeXt backbone "
                       "(scores self-consistent, not comparable to published numbers)")
        backbone = init_convnext(0, cn_cfg, torch.float32, device)
    bundle = init_dists(backbone, cn_cfg.dims)

    def fn(a01, b01):
        with torch.no_grad():
            return float(dists_loss(bundle, _pm1(a01, device), _pm1(b01, device)))

    return fn


def build_lpips_fn(vgg_pth=None, lins_pth=None, device="cuda"):
    """LPIPS-VGG closure (a01, b01) -> float; random weights with a warning
    unless both official checkpoints are given."""
    from omgsr_tpu_torch.utils.lpips import init_lpips, lpips, port_lpips

    device = resolve_device(device)
    if vgg_pth and lins_pth:
        params = port_lpips(vgg_pth, lins_pth, device=device)
    else:
        logger.warning("no --lpips_vgg/--lpips_lins — LPIPS uses random weights "
                       "(scores self-consistent, not comparable to published numbers)")
        params = init_lpips(0, device=device)

    def fn(a01, b01):
        with torch.no_grad():
            return float(lpips(params, _pm1(a01, device), _pm1(b01, device))[0])

    return fn


def build_clipiqa_fn(clip_vision_path=None, prompts_npz=None, cfg=None, device="cuda"):
    """CLIP-IQA closure a01 -> float (no reference; higher is better). A
    checkpoint directory brings its own config, logit_scale and, without
    ``prompts_npz``, the prompt pair encoded by its own text tower."""
    from omgsr_tpu_torch.models.clip_vision import (
        CLIP_L_VISION,
        clip_preprocess,
        clip_vision_config_from_json,
        clipiqa_score_preprocessed,
        init_clip_vision,
        logit_scale_of,
    )

    device = resolve_device(device)
    prompts = None
    if clip_vision_path:
        from omgsr_tpu_torch.convert.porters import port_clip_vision

        cfg = cfg or clip_vision_config_from_json(clip_vision_path)
        params = port_clip_vision(clip_vision_path, cfg=cfg, device=device)
        if "visual_projection" not in params:
            raise SystemExit("--clip_vision_path checkpoint has no visual_projection head (CLIP-IQA needs "
                             "CLIPModel / CLIPVisionModelWithProjection weights)")
        if not prompts_npz:
            # a real tower with random prompts would give plausible-looking, meaningless scores
            from omgsr_tpu_torch.models.clip_vision import clipiqa_prompt_embeds_from_clip_dir

            try:
                prompts = clipiqa_prompt_embeds_from_clip_dir(clip_vision_path, device=device)
            except (OSError, KeyError, ValueError) as e:
                raise SystemExit("--clipiqa with a real tower needs real prompt embeddings: pass "
                                 "--clipiqa_prompts_npz (build one with models.clip_vision."
                                 f"clipiqa_prompt_embeds_from_clip_dir) — encoding from the directory failed: {e}")
    else:
        cfg = cfg or CLIP_L_VISION
        logger.warning("no --clip_vision_path — CLIP-IQA uses a random tower "
                       "(scores self-consistent, not comparable to published numbers)")
        params = init_clip_vision(0, cfg, torch.float32, device)
        if not prompts_npz:
            gen = torch.Generator(device=device).manual_seed(1)
            prompts = torch.randn((2, cfg.projection_dim), generator=gen, device=device)
    if prompts_npz:
        prompts = np.load(prompts_npz)["prompt_embeds"]
        if prompts.shape != (2, cfg.projection_dim):
            raise SystemExit(f"--clipiqa_prompts_npz prompt_embeds must be (2, {cfg.projection_dim}), "
                             f"got {prompts.shape}")
        prompts = torch.from_numpy(np.asarray(prompts, np.float32)).to(device)
    scale = logit_scale_of(params)

    def fn(a01):
        with torch.no_grad():
            px = clip_preprocess(torch.from_numpy(np.ascontiguousarray(a01))[None].to(device), cfg)
            return float(clipiqa_score_preprocessed(params, cfg, px, prompts, scale)[0])

    return fn


def _center_crop_multiple(a, b, n, name=""):
    h = (a.shape[0] // n) * n
    w = (a.shape[1] // n) * n
    if not (h and w):
        logger.warning("%s (%dx%d) is smaller than --metric_crop %d: DISTS / LPIPS score it at full size",
                       name, a.shape[0], a.shape[1], n)
        return a, b
    y0, x0 = (a.shape[0] - h) // 2, (a.shape[1] - w) // 2
    return a[y0:y0 + h, x0:x0 + w], b[y0:y0 + h, x0:x0 + w]


def evaluate_pairs(pairs, crop_border: int = 0, y_channel: bool = False, dists_fn=None, niqe_pristine=None,
                   metric_crop: int = 0, lpips_fn=None, clipiqa_fn=None, device="cuda"):
    from omgsr_tpu_torch.utils.metrics import psnr, ssim

    device = resolve_device(device)
    rows = []
    for sr_path, gt_path in pairs:
        a, b = _load01(sr_path), _load01(gt_path)
        if a.shape != b.shape:
            raise ValueError(f"size mismatch: {sr_path} {a.shape} vs {gt_path} {b.shape}")
        if crop_border:
            a = a[crop_border:-crop_border, crop_border:-crop_border]
            b = b[crop_border:-crop_border, crop_border:-crop_border]
        a_rgb, b_rgb = a, b
        if y_channel:
            a, b = _to_y(a), _to_y(b)
        ta = torch.from_numpy(np.ascontiguousarray(a))[None].to(device)
        tb = torch.from_numpy(np.ascontiguousarray(b))[None].to(device)
        with torch.no_grad():
            row = {"name": os.path.basename(sr_path), "psnr": float(psnr(ta, tb)[0]), "ssim": float(ssim(ta, tb)[0])}
        da, db = a_rgb, b_rgb
        if metric_crop:
            da, db = _center_crop_multiple(a_rgb, b_rgb, metric_crop, row["name"])
        if dists_fn is not None:
            row["dists"] = dists_fn(da, db)
        if lpips_fn is not None:
            row["lpips"] = lpips_fn(da, db)
        if clipiqa_fn is not None:
            row["clipiqa"] = clipiqa_fn(a_rgb)  # no reference: the SR image only
        if niqe_pristine is not None:
            from omgsr_tpu_torch.utils.niqe import niqe

            try:
                row["niqe"] = niqe(a_rgb, niqe_pristine)
            except ValueError as e:
                # e.g. an image smaller than the NIQE block grid: score the rest of the folder
                print(f"WARNING: NIQE skipped for {sr_path}: {e}")
                row["niqe"] = float("nan")
        rows.append(row)
    return rows


def strict_json(value):
    """NaN -> null, +-inf -> "inf" / "-inf", elsewhere the value (recursively
    through dicts and lists): strict JSON that loses no infinity."""
    if isinstance(value, dict):
        return {k: strict_json(v) for k, v in value.items()}
    if isinstance(value, list):
        return [strict_json(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return None if math.isnan(value) else ("inf" if value > 0 else "-inf")
    return value


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sr_dir", type=str, required=True, nargs="+", help="SR output dir(s) or .txt list(s)")
    parser.add_argument("--gt_dir", type=str, required=True, nargs="+", help="ground-truth dir(s) or .txt list(s)")
    parser.add_argument("--crop_border", type=int, default=0,
                        help="pixels cropped from every edge before scoring (SR convention: the upscale factor)")
    parser.add_argument("--y_channel", action="store_true",
                        help="evaluate on the BT.601 Y channel (SR-paper convention)")
    parser.add_argument("--output", type=str, default=None, help="write per-image + summary metrics as JSON")
    parser.add_argument("--dists", action="store_true",
                        help="also report DISTS (DINOv3-ConvNeXt perceptual distance, lower=better)")
    parser.add_argument("--dinov3_weights_path", type=str, default=None,
                        help="DINOv3 ConvNeXt .pth for DISTS (random backbone with a warning when absent)")
    parser.add_argument("--dinov3_size", type=str, default="large")
    parser.add_argument("--metric_crop", type=int, default=0,
                        help="center-crop images to multiples of N before the DISTS/LPIPS forwards "
                        "(0 = full image)")
    parser.add_argument("--lpips", action="store_true",
                        help="also report LPIPS-VGG (lower=better; random weights with a warning unless "
                        "--lpips_vgg and --lpips_lins are given)")
    parser.add_argument("--lpips_vgg", type=str, default=None, help="torchvision vgg16 state-dict .pth")
    parser.add_argument("--lpips_lins", type=str, default=None,
                        help="lpips package linear weights (lpips/weights/v0.1/vgg.pth)")
    parser.add_argument("--clipiqa", action="store_true",
                        help="also report CLIP-IQA (no-reference, higher=better; random tower with a warning "
                        "unless --clip_vision_path is given)")
    parser.add_argument("--clip_vision_path", type=str, default=None,
                        help="HF CLIPModel / CLIPVisionModelWithProjection dir (safetensors) for CLIP-IQA")
    parser.add_argument("--clipiqa_prompts_npz", type=str, default=None,
                        help=".npz with prompt_embeds (2, proj_dim): CLIP text embeddings of the antonym "
                        "prompt pair ('Good photo.', 'Bad photo.')")
    parser.add_argument("--niqe_params", type=str, default=None,
                        help="pristine-model .npz (keys mu/cov; build one with utils.niqe main) — enables "
                        "the no-reference NIQE score (lower=better)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no CUDA device is present")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    pairs, missing = pair_by_stem(collect_paths(args.sr_dir), collect_paths(args.gt_dir))
    for m in missing:
        print(f"WARNING: no ground truth for {m}, skipped")
    if not pairs:
        raise SystemExit("no (SR, GT) pairs found")

    dists_fn = build_dists_fn(args.dinov3_weights_path, args.dinov3_size, device) if args.dists else None
    niqe_pristine = None
    if args.niqe_params:
        from omgsr_tpu_torch.utils.niqe import load_pristine

        niqe_pristine = load_pristine(args.niqe_params)
    lpips_fn = build_lpips_fn(args.lpips_vgg, args.lpips_lins, device) if args.lpips else None
    clipiqa_fn = build_clipiqa_fn(args.clip_vision_path, args.clipiqa_prompts_npz, device=device) \
        if args.clipiqa else None
    rows = evaluate_pairs(pairs, args.crop_border, args.y_channel, dists_fn=dists_fn, niqe_pristine=niqe_pristine,
                          metric_crop=args.metric_crop, lpips_fn=lpips_fn, clipiqa_fn=clipiqa_fn, device=device)
    for r in rows:
        line = f"{r['name']:40s} PSNR {r['psnr']:7.3f}  SSIM {r['ssim']:.4f}"
        for key, label, fmt in (("dists", "DISTS", ".4f"), ("lpips", "LPIPS", ".4f"), ("clipiqa", "CLIPIQA", ".4f"),
                                ("niqe", "NIQE", ".3f")):
            if key in r:
                line += f"  {label} {r[key]:{fmt}}"
        print(line)
    summary = {
        "n": len(rows),
        "psnr_mean": float(np.mean([r["psnr"] for r in rows])),
        "ssim_mean": float(np.mean([r["ssim"] for r in rows])),
        "crop_border": args.crop_border,
        "y_channel": args.y_channel,
    }
    for k in ("dists", "lpips", "clipiqa", "niqe"):
        if rows and k in rows[0]:
            vals = [r[k] for r in rows if np.isfinite(r[k])]
            if vals:
                summary[f"{k}_mean"] = float(np.mean(vals))
                if len(vals) < len(rows):
                    summary[f"{k}_n"] = len(vals)
    print(f"mean over {summary['n']} images: PSNR {summary['psnr_mean']:.3f} SSIM {summary['ssim_mean']:.4f}"
          + "".join(f" {label} {summary[k + '_mean']:{fmt}}" for k, label, fmt in (
              ("dists", "DISTS", ".4f"), ("lpips", "LPIPS", ".4f"), ("clipiqa", "CLIPIQA", ".4f"),
              ("niqe", "NIQE", ".3f")) if k + "_mean" in summary))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(strict_json({"summary": summary, "per_image": rows}), f, indent=2, allow_nan=False)
    return summary


if __name__ == "__main__":
    main()
