"""Real-checkpoint fidelity validation of the port.

For each component of a checkpoint directory it:
  1. ports the safetensors into the port's parameter trees
     (``convert/porters.py``, with leaf-set validation);
  2. runs the port's stages on ``--device`` in f32 (through the CUDA kernels
     on the card, TF32 off) and the SAME tree, carried back to the JAX
     package's layout by ``convert.params.to_jax_tree``, through the
     independent plain-torch re-implementations of ``tests/torch_ref_models.py``
     on the CPU, and the text towers through transformers' CLIP and T5 where
     transformers is installed, on fixed probe inputs;
  3. reports per-stage max/mean relative deviation against the 1e-3 target
     (BASELINE.md "output fidelity" row).

    python -m omgsr_tpu_torch.cli.validate_checkpoint --sd_path ckpts/sd21 \\
        [--probe_image img.png] [--report report.json] [--device cpu]
    python -m omgsr_tpu_torch.cli.validate_checkpoint --flux_path ckpts/flux \\
        [--report report.json]
    python -m omgsr_tpu_torch.cli.validate_checkpoint --dinov3_pth vitl16.pth \\
        --ref_root DIR [--dinov3_arch vitl16]

Flags and report keys are the JAX CLI's (``omgsr_tpu/cli/validate_checkpoint.py``),
with ``--device`` (the CUDA device unless ``--device cpu``) and ``--ref_root``.
Where it differs on purpose:

  * ``validate_flux`` also holds CLIP-L's pooled output and T5's hidden states
    against transformers' towers (stages ``clip_l_pooled_vs_transformers`` and
    ``t5_vs_transformers``) when the directory has ``text_encoder/`` and
    ``text_encoder_2/``;
  * ``validate_dinov3`` compares against the vendored DINOv3 tree at
    ``--ref_root``, which ``--dinov3_pth`` requires (there is no default);
    when the flag is missing or the tree is absent the CLI exits non-zero,
    naming the flag or the path, instead of reporting anything.

As in the JAX CLI, a transformers comparison that cannot run (transformers
not installed, or the comparison raised) is an ``error`` entry, listed in
``errored_stages``, and fails ``passes_1e-3_target``.

The reference re-implementations ship under tests/, so this tool runs from a
full checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from omgsr_tpu_torch.utils.devices import resolve_device

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    denom = max(float(np.abs(b).max()), 1e-12)
    return {
        "max_abs": float(np.abs(a - b).max()),
        "max_rel": float(np.abs(a - b).max() / denom),
        "mean_rel": float(np.abs(a - b).mean() / denom),
    }


def _np(t):
    return t.detach().float().cpu().numpy()


def _torch_ref():
    """The independent torch re-implementations (tests/torch_ref_models.py of
    this repository: a developer validation tool), loaded from their file, so
    another installed package named ``tests`` cannot stand in for them."""
    import importlib.util

    path = os.path.join(_ROOT, "tests", "torch_ref_models.py")
    if not os.path.isfile(path):
        raise SystemExit(f"validate_checkpoint needs the repo's tests/torch_ref_models.py (run from a full "
                         f"checkout): {path} is absent")
    spec = importlib.util.spec_from_file_location("omgsr_torch_ref_models", path)
    T = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(T)
    return T


@contextlib.contextmanager
def _exact_f32():
    """f32 products in f32 on the card: TF32 off in matmuls and cuDNN convolutions."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _transformers_stage(report, name, fn):
    """report[name] = fn(): a comparison with transformers' towers, or an
    error entry (which fails the report) where it cannot run, transformers
    not installed included."""
    try:
        report[name] = fn()
    except Exception as e:  # noqa: BLE001 - reported, and it fails the report
        report[name] = {"error": f"{type(e).__name__}: {e}"}


def validate_sd(sd_path: str, probe_image=None, device="cuda"):
    from omgsr_tpu_torch.cli.prompts import encode_prompt_sd
    from omgsr_tpu_torch.convert.hf_config import unet_config_from_json, vae_config_from_json
    from omgsr_tpu_torch.convert.params import to_jax_tree
    from omgsr_tpu_torch.convert.porters import port_diffusers_unet, port_diffusers_vae
    from omgsr_tpu_torch.models import unet_sd, vae

    device = resolve_device(device)
    T = _torch_ref()
    report = {}
    rng = np.random.default_rng(0)

    vae_dir, unet_dir = os.path.join(sd_path, "vae"), os.path.join(sd_path, "unet")
    vae_cfg = vae_config_from_json(vae_dir)
    unet_cfg = unet_config_from_json(unet_dir)
    vp = port_diffusers_vae(vae_dir, cfg=vae_cfg, dtype=torch.float32, device=device)
    up = port_diffusers_unet(unet_dir, cfg=unet_cfg, dtype=torch.float32, device=device)
    jvp, jup = to_jax_tree(vp), to_jax_tree(up)

    def nchw(a):
        return torch.from_numpy(np.asarray(a, np.float32).transpose(0, 3, 1, 2))

    def nhwc(t):
        return t.detach().numpy().transpose(0, 2, 3, 1)

    x = probe_image if probe_image is not None else np.tanh(rng.normal(size=(1, 128, 128, 3))).astype(np.float32)
    with torch.no_grad():
        ref_moments = nhwc(T.torch_vae_encode_features(jvp, vae_cfg, nchw(x)))
    with _exact_f32():
        ours_moments = _np(vae.vae_encode_features(vp, vae_cfg, torch.from_numpy(x).to(device)))
    report["vae_encode_moments"] = _rel(ours_moments, ref_moments)

    z_raw = ours_moments[..., : vae_cfg.latent_channels].astype(np.float32)
    with torch.no_grad():
        ref_img = nhwc(T.torch_vae_decode(jvp, vae_cfg, nchw(z_raw)))
    with _exact_f32():
        ours_img = _np(vae.vae_decode(vp, vae_cfg, torch.from_numpy(z_raw).to(device), unscale=False))
    report["vae_decode"] = _rel(ours_img, ref_img)

    ctx = rng.normal(size=(1, 77, unet_cfg.cross_attention_dim)).astype(np.float32)
    z_in = (z_raw * vae_cfg.scaling_factor).astype(np.float32)
    with torch.no_grad():
        ref_eps = nhwc(T.torch_unet_apply(jup, unet_cfg, nchw(z_in), 273, torch.from_numpy(ctx)))
    with _exact_f32():
        ours_eps = _np(unet_sd.unet_apply(up, unet_cfg, torch.from_numpy(z_in).to(device), 273,
                                          torch.from_numpy(ctx).to(device)))
    report["unet_eps_t273"] = _rel(ours_eps, ref_eps)

    # the text tower against transformers' implementation, same weights
    te_dir = os.path.join(sd_path, "text_encoder")
    if os.path.isdir(te_dir):
        def clip_stage():
            from transformers import AutoTokenizer, CLIPTextModel

            tok = AutoTokenizer.from_pretrained(sd_path, subfolder="tokenizer")
            hf = CLIPTextModel.from_pretrained(te_dir, torch_dtype=torch.float32)
            ids = tok("a photo of a cat", max_length=tok.model_max_length, padding="max_length", truncation=True,
                      return_tensors="pt").input_ids
            with torch.no_grad():
                ref_txt = hf(ids)[0].numpy()
            with _exact_f32():
                ours_txt = _np(encode_prompt_sd(sd_path, "a photo of a cat", torch.float32, device))
            return _rel(ours_txt, ref_txt)

        _transformers_stage(report, "clip_text_vs_transformers", clip_stage)
    return report


def _flux_text_stages(flux_path, report, device):
    """CLIP-L's pooled output and T5's hidden states of one prompt, the
    port's tokenizers and towers (f32) against transformers' (f32)."""
    from omgsr_tpu_torch.convert.hf_config import clip_config_from_json, t5_config_from_json
    from omgsr_tpu_torch.convert.porters import port_clip_text, port_t5_encoder
    from omgsr_tpu_torch.models.clip_text import clip_text_apply
    from omgsr_tpu_torch.models.clip_tokenizer import CLIPTokenizer
    from omgsr_tpu_torch.models.t5 import t5_encode
    from omgsr_tpu_torch.models.t5_tokenizer import T5Tokenizer

    prompt = "a photo of a cat"

    def clip_stage():
        import dataclasses

        from transformers import CLIPTextModel

        te_dir = os.path.join(flux_path, "text_encoder")
        tok = CLIPTokenizer.from_pretrained(os.path.join(flux_path, "tokenizer"))
        ids = tok(prompt, max_length=tok.model_max_length)
        cfg = dataclasses.replace(clip_config_from_json(te_dir), eos_token_id=tok.eos_token_id)
        hf = CLIPTextModel.from_pretrained(te_dir, torch_dtype=torch.float32)
        with torch.no_grad():
            ref = hf(ids.cpu().long()).pooler_output.numpy()
        params = port_clip_text(te_dir, cfg=cfg, dtype=torch.float32, device=device)
        with _exact_f32():
            _, pooled = clip_text_apply(params, cfg, ids.to(device))
        return _rel(_np(pooled), ref)

    def t5_stage():
        from transformers import T5EncoderModel

        te_dir = os.path.join(flux_path, "text_encoder_2")
        tok = T5Tokenizer.from_pretrained(os.path.join(flux_path, "tokenizer_2"))
        ids = tok(prompt, max_length=512)
        cfg = t5_config_from_json(te_dir)
        hf = T5EncoderModel.from_pretrained(te_dir, torch_dtype=torch.float32)
        with torch.no_grad():
            ref = hf(ids.cpu().long()).last_hidden_state.numpy()
        params = port_t5_encoder(te_dir, cfg=cfg, dtype=torch.float32, device=device)
        with _exact_f32():
            ours = t5_encode(params, cfg, ids.to(device))
        return _rel(_np(ours), ref)

    _transformers_stage(report, "clip_l_pooled_vs_transformers", clip_stage)
    _transformers_stage(report, "t5_vs_transformers", t5_stage)


def validate_flux(flux_path: str, tokens: int = 64, device="cuda"):
    from omgsr_tpu_torch.convert.hf_config import flux_config_from_json, vae_config_from_json
    from omgsr_tpu_torch.convert.params import to_jax_tree
    from omgsr_tpu_torch.convert.porters import port_diffusers_vae, port_flux_transformer
    from omgsr_tpu_torch.diffusion.packing import latent_image_ids
    from omgsr_tpu_torch.models import flux as flux_mod
    from omgsr_tpu_torch.models import vae

    device = resolve_device(device)
    T = _torch_ref()
    report = {}
    rng = np.random.default_rng(1)

    vae_dir = os.path.join(flux_path, "vae")
    fx_dir = os.path.join(flux_path, "transformer")
    vae_cfg = vae_config_from_json(vae_dir)
    fx_cfg = flux_config_from_json(fx_dir)
    vp = port_diffusers_vae(vae_dir, cfg=vae_cfg, dtype=torch.float32, device=device)

    x = np.tanh(rng.normal(size=(1, 64, 64, 3))).astype(np.float32)
    with torch.no_grad():
        ref_m = T.torch_vae_encode_features(to_jax_tree(vp), vae_cfg, torch.from_numpy(x.transpose(0, 3, 1, 2)))
    with _exact_f32():
        ours_m = _np(vae.vae_encode_features(vp, vae_cfg, torch.from_numpy(x).to(device)))
    report["flux_vae_encode_moments"] = _rel(ours_m, ref_m.numpy().transpose(0, 2, 3, 1))
    del vp

    fp = port_flux_transformer(fx_dir, cfg=fx_cfg, dtype=torch.float32, device=device)
    side = int(tokens ** 0.5)
    s_img = side * side
    img = rng.normal(size=(1, s_img, fx_cfg.in_channels)).astype(np.float32) * 0.3
    txt = rng.normal(size=(1, 16, fx_cfg.joint_attention_dim)).astype(np.float32) * 0.3
    pooled = rng.normal(size=(1, fx_cfg.pooled_projection_dim)).astype(np.float32)
    img_ids = latent_image_ids(side, side)
    txt_ids = torch.zeros((16, 3), dtype=torch.float32)
    with torch.no_grad():
        ref_v = T.torch_flux_apply(to_jax_tree(fp), fx_cfg, torch.from_numpy(img), 0.5, 1.0,
                                   torch.from_numpy(pooled), torch.from_numpy(txt), txt_ids, img_ids).numpy()
    with _exact_f32():
        ours_v = _np(flux_mod.flux_apply(
            fp, fx_cfg, torch.from_numpy(img).to(device), 0.5, 1.0, torch.from_numpy(pooled).to(device),
            torch.from_numpy(txt).to(device), txt_ids.to(device), img_ids.to(device)))
    report["flux_dit_velocity"] = _rel(ours_v, ref_v)
    del fp

    if all(os.path.isdir(os.path.join(flux_path, d)) for d in ("text_encoder", "text_encoder_2")):
        _flux_text_stages(flux_path, report, device)
    return report


def validate_dinov3(pth_path: str, ref_root: str, arch: str = "vitl16", image_size: int = 224, probe_image=None,
                   device="cuda"):
    """DINOv3 hub ViT/ConvNeXt .pth -> port -> forward parity against the
    vendored torch implementation (dinov3/models/*.py at ``ref_root``, the
    code the checkpoint was trained with), same weights, eval mode: the
    forward_features tokens and a 4-layer get_intermediate_layers probe.
    Raises FileNotFoundError, naming the path, when ``ref_root`` is absent."""
    if not os.path.isdir(os.path.join(ref_root, "dinov3")):
        raise FileNotFoundError(f"the vendored DINOv3 reference tree is absent: no {os.path.join(ref_root, 'dinov3')}"
                                " (pass --ref_root)")
    device = resolve_device(device)
    if ref_root not in sys.path:
        sys.path.insert(0, ref_root)
    report = {}
    rng = np.random.default_rng(2)
    if probe_image is not None:
        x = (probe_image + 1.0) / 2.0  # validate_* probes arrive in [-1, 1]
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
        x = ((x - mean) / std).astype(np.float32)
    else:
        x = rng.standard_normal((1, image_size, image_size, 3)).astype(np.float32)
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2))
    xd = torch.from_numpy(x).to(device)

    if arch.startswith("convnext"):
        from dinov3.models.convnext import ConvNeXt

        from omgsr_tpu_torch.convert.porters import port_dinov3_convnext
        from omgsr_tpu_torch.models.configs import CONVNEXT_SIZES
        from omgsr_tpu_torch.models.convnext import convnext_features

        cfg = CONVNEXT_SIZES[arch.split("_", 1)[1]]
        params = port_dinov3_convnext(sd, cfg=cfg, dtype=torch.float32, device=device)
        m = ConvNeXt(depths=list(cfg.depths), dims=list(cfg.dims))
        m.load_state_dict(sd, strict=False)
        m.eval()
        with _exact_f32():
            ours = [_np(f) for f in convnext_features(params, xd, num_stages=4)]
        with torch.no_grad():
            for i, (dl, st) in enumerate(zip(m.downsample_layers, m.stages)):
                tx = st(dl(tx))
                report[f"convnext_stage{i}"] = _rel(ours[i], tx.numpy().transpose(0, 2, 3, 1))
        return report

    from dinov3.models.vision_transformer import DinoVisionTransformer

    from omgsr_tpu_torch.convert.porters import port_dinov3_vit
    from omgsr_tpu_torch.models.configs import VIT_SIZES
    from omgsr_tpu_torch.models.dinov3_vit import dinov3_vit_apply, get_intermediate_layers

    cfg = VIT_SIZES[arch]
    params = port_dinov3_vit(sd, cfg=cfg, dtype=torch.float32, device=device)
    m = DinoVisionTransformer(
        img_size=image_size, patch_size=cfg.patch_size, embed_dim=cfg.embed_dim, depth=cfg.depth,
        num_heads=cfg.num_heads, ffn_ratio=cfg.ffn_ratio, ffn_layer=cfg.ffn_layer, qkv_bias=cfg.qkv_bias,
        layerscale_init=cfg.layerscale_init, n_storage_tokens=cfg.n_storage_tokens, mask_k_bias=True,
        pos_embed_rope_base=cfg.rope_base, pos_embed_rope_normalize_coords=cfg.rope_normalize_coords,
        pos_embed_rope_dtype="fp32",
        # hub models ship "layernormbf16" = plain LN(eps=1e-5) (vision_transformer.py:27-30)
        norm_layer="layernormbf16", untie_global_and_local_cls_norm=cfg.untie_cls_and_patch_norms,
    )
    missing, unexpected = m.load_state_dict(sd, strict=False)
    report["torch_load"] = {"missing": [k for k in missing if "local_cls_norm" not in k],
                            "unexpected": list(unexpected)}
    m.eval()
    idx = [i * cfg.depth // 4 - 1 for i in range(1, 5)]
    with torch.no_grad():
        ref = m.forward_features(tx)
        ref_layers = m.get_intermediate_layers(tx, n=idx, reshape=True, norm=True)
    with _exact_f32():
        out = dinov3_vit_apply(params, cfg, xd)
        ours_layers = get_intermediate_layers(params, cfg, xd, n=idx, reshape=True, norm=True)
    for k in ("x_norm_clstoken", "x_storage_tokens", "x_norm_patchtokens"):
        report[k] = _rel(_np(out[k]), ref[k].numpy())
    for i, (o, r) in enumerate(zip(ours_layers, ref_layers)):
        report[f"intermediate_layer_{idx[i]}"] = _rel(_np(o), r.numpy().transpose(0, 2, 3, 1))
    return report


def summarize(report: dict) -> dict:
    """The report's verdict keys, as the JAX CLI writes them: the worst
    max_rel over every compared stage, the stages that errored (never
    compared, so they fail the report) and ``passes_1e-3_target``."""
    worst = 0.0
    errored = []
    for name, comp in report.items():
        for stage_name, stage in comp.items():
            if isinstance(stage, dict) and "max_rel" in stage:
                worst = max(worst, stage["max_rel"])
            elif isinstance(stage, dict) and "error" in stage:
                errored.append(f"{name}.{stage_name}")
    report["worst_max_rel"] = worst
    report["errored_stages"] = errored
    report["passes_1e-3_target"] = bool(worst <= 1e-3 and not errored)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description="Real-checkpoint fidelity validation (PyTorch/CUDA port)")
    parser.add_argument("--sd_path", type=str, default=None)
    parser.add_argument("--flux_path", type=str, default=None)
    parser.add_argument("--dinov3_pth", type=str, default=None, help="DINOv3 hub backbone .pth (ViT or ConvNeXt)")
    parser.add_argument("--dinov3_arch", type=str, default="vitl16",
                        help="vits16|...|vit7b16|convnext_{tiny,small,base,large}")
    parser.add_argument("--ref_root", type=str, default=None,
                        help="directory holding the vendored dinov3/ package the DINOv3 forward is held against "
                        "(required with --dinov3_pth)")
    parser.add_argument("--probe_image", type=str, default=None)
    parser.add_argument("--report", type=str, default=None)
    parser.add_argument("--flux_tokens", type=int, default=64,
                        help="image tokens for the DiT probe (the CPU reference's cost grows with this)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the port's stages; 'cuda' raises when no CUDA device is present")
    args = parser.parse_args(argv)
    if not (args.sd_path or args.flux_path or args.dinov3_pth):
        parser.error("pass --sd_path, --flux_path and/or --dinov3_pth")
    device = resolve_device(args.device)
    if args.dinov3_pth and not args.ref_root:
        raise SystemExit("validate_checkpoint: --dinov3_pth needs --ref_root, the directory holding the vendored "
                         "DINOv3 reference tree; nothing was validated")
    if args.dinov3_pth and not os.path.isdir(os.path.join(args.ref_root, "dinov3")):
        raise SystemExit(f"validate_checkpoint: --dinov3_pth needs the vendored DINOv3 reference tree, and "
                         f"{os.path.join(args.ref_root, 'dinov3')} is absent (pass --ref_root); nothing was validated")

    probe = None
    if args.probe_image:
        from PIL import Image

        im = np.asarray(Image.open(args.probe_image).convert("RGB"), np.float32)
        side = min(im.shape[0], im.shape[1], 256) // 8 * 8
        probe = (im[None, :side, :side] / 127.5 - 1.0).astype(np.float32)

    report = {}
    if args.sd_path:
        report["sd"] = validate_sd(args.sd_path, probe, device)
    if args.flux_path:
        report["flux"] = validate_flux(args.flux_path, args.flux_tokens, device)
    if args.dinov3_pth:
        report["dinov3"] = validate_dinov3(args.dinov3_pth, arch=args.dinov3_arch, probe_image=probe,
                                           ref_root=args.ref_root, device=device)
    summarize(report)
    out = json.dumps(report, indent=2)
    print(out)
    if args.report:
        with open(args.report, "w") as f:
            f.write(out)
    return report


if __name__ == "__main__":
    main()
