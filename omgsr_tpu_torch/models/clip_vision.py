"""CLIP vision encoder (transformers CLIPVisionModel layout) and CLIP-IQA.

Not on the OMGSR execution path (the reference uses only CLIP text towers):
it serves the learned no-reference IQA metric of the SR-paper eval protocol
(CLIP-IQA, ``cli/eval_sr.py --clipiqa``), where image quality is the softmax
over the cosine similarities of the image embedding against an antonym
prompt pair.

Parameter paths mirror the HF keys under ``vision_model.*`` (plus the
CLIPModel-level ``visual_projection`` and ``logit_scale`` where present);
the patch embedding is a conv weight OIHW, activations NHWC, the same
transformer layer as ``models/clip_text`` without a mask (its attention is
``ops/attention.matmul_attention``).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from omgsr_tpu_torch.convert.params import _conv_weight, _Init
from omgsr_tpu_torch.models.clip_text import _act, _attn
from omgsr_tpu_torch.models.layers import dense, layer_norm

# CLIP image preprocessing constants (OpenAI CLIP normalize)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
# the CLIP-IQA temperature of a tower without a learned logit_scale (CLIP's exp(4.6052))
DEFAULT_LOGIT_SCALE = 100.0


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


# openai/clip-vit-large-patch14 vision tower (the CLIP-L used by FLUX)
CLIP_L_VISION = CLIPVisionConfig()


def clip_vision_config_from_json(path: str, default: CLIPVisionConfig = CLIP_L_VISION) -> CLIPVisionConfig:
    """The vision tower's config from ``<path>/config.json``: a full
    CLIPModel's ``vision_config`` or a CLIPVisionModel's own keys (the
    top-level ``projection_dim`` where the vision config has none); missing
    keys take ``default``'s values, as does a directory without config.json."""
    p = os.path.join(path, "config.json")
    if not os.path.exists(p):
        return default
    with open(p) as f:
        top = json.load(f)
    c = dict(top.get("vision_config") or top)
    c.setdefault("projection_dim", top.get("projection_dim", default.projection_dim))
    return CLIPVisionConfig(**{k: c.get(k, getattr(default, k)) for k in CLIPVisionConfig.__dataclass_fields__})


def init_clip_vision(seed, cfg: CLIPVisionConfig, dtype=torch.float32, device="cuda", with_projection: bool = True):
    """Random CLIPVisionModel parameters with the HF tree structure:
    embeddings N(0, 0.02), dense layers torch's default, norms 1 / 0."""
    it = _Init(seed, dtype, device)
    d = cfg.hidden_size
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1

    def layer():
        return {
            "layer_norm1": it.norm(d),
            "self_attn": {name: it.dense(d, d) for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm2": it.norm(d),
            "mlp": {"fc1": it.dense(d, cfg.intermediate_size), "fc2": it.dense(cfg.intermediate_size, d)},
        }

    params = {"vision_model": {
        "embeddings": {
            "class_embedding": it.normal((d,), 0.02),
            "patch_embedding": {"weight": _conv_weight(it.normal((d, 3, cfg.patch_size, cfg.patch_size), 0.02))},
            "position_embedding": {"weight": it.normal((n_pos, d), 0.02)},
        },
        "pre_layrnorm": it.norm(d),  # HF's attribute really is spelled "pre_layrnorm"
        "encoder": {"layers": {str(i): layer() for i in range(cfg.num_hidden_layers)}},
        "post_layernorm": it.norm(d),
    }}
    if with_projection:
        params["visual_projection"] = {"weight": it.dense(d, cfg.projection_dim, use_bias=False)["weight"]}
    return params


def clip_vision_apply(params, cfg: CLIPVisionConfig, pixel_values):
    """pixel_values (B, H, W, 3) CLIP-normalised -> (last_hidden (B, N+1, D),
    pooled (B, D)), as HF's CLIPVisionTransformer: last_hidden is not
    post-layer-normed; pooled = post_layernorm(the hidden state at CLS)."""
    vm = params["vision_model"]
    emb = vm["embeddings"]
    w = emb["patch_embedding"]["weight"]
    x = F.conv2d(pixel_values.permute(0, 3, 1, 2), w.to(pixel_values.dtype), stride=cfg.patch_size)
    b = x.shape[0]
    x = x.flatten(2).transpose(1, 2)  # (B, N, D), row-major patches as the JAX reshape of NHWC
    cls = emb["class_embedding"].to(x.dtype)[None, None].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + emb["position_embedding"]["weight"][None, : x.shape[1]]
    x = layer_norm(vm["pre_layrnorm"], x, cfg.layer_norm_eps)
    act = _act(cfg.hidden_act)
    for i in sorted(vm["encoder"]["layers"], key=int):
        lp = vm["encoder"]["layers"][i]
        h = layer_norm(lp["layer_norm1"], x, cfg.layer_norm_eps)
        x = x + _attn(lp["self_attn"], h, cfg.num_attention_heads, None)
        h = layer_norm(lp["layer_norm2"], x, cfg.layer_norm_eps)
        x = x + dense(lp["mlp"]["fc2"], act(dense(lp["mlp"]["fc1"], h)))
    pooled = layer_norm(vm["post_layernorm"], x[:, 0], cfg.layer_norm_eps)
    return x, pooled


def clip_image_features(params, cfg: CLIPVisionConfig, pixel_values):
    """(B, H, W, 3) CLIP-normalised -> projected image embeddings (B,
    projection_dim), HF CLIPModel.get_image_features."""
    _, pooled = clip_vision_apply(params, cfg, pixel_values)
    return F.linear(pooled, params["visual_projection"]["weight"].to(pooled.dtype))


def clip_preprocess(rgb01, cfg: CLIPVisionConfig):
    """[0, 1] RGB NHWC (any size) -> CLIP-normalised (B, image_size,
    image_size, 3) through the bicubic resize of ``ops/resize.py``."""
    from omgsr_tpu_torch.ops.resize import resize

    x = resize(rgb01, cfg.image_size, cfg.image_size, mode="bicubic").clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def clipiqa_prompt_embeds_from_clip_dir(path: str, prompts: tuple = ("Good photo.", "Bad photo."),
                                        input_ids=None, device="cuda"):
    """The CLIP-IQA antonym prompt pair through a full HF CLIPModel
    directory's text tower and ``text_projection`` -> (2, projection_dim) f32
    on ``device``. The prompts are tokenised with the directory's own
    ``vocab.json`` / ``merges.txt`` (``models/clip_tokenizer.py``), padded to
    the tower's length; ``input_ids`` (2, L) bypasses the tokenizer."""
    from omgsr_tpu_torch.convert.porters import _convert, load_safetensors_dir
    from omgsr_tpu_torch.models.clip_text import clip_text_apply
    from omgsr_tpu_torch.models.clip_tokenizer import CLIPTokenizer
    from omgsr_tpu_torch.models.configs import CLIPTextConfig
    from omgsr_tpu_torch.utils.devices import resolve_device

    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        top = json.load(f)
    c = top.get("text_config", top)  # a full CLIPModel config nests the text tower
    cfg = CLIPTextConfig(
        vocab_size=c.get("vocab_size", 49408), hidden_size=c.get("hidden_size", 512),
        intermediate_size=c.get("intermediate_size", 2048), num_hidden_layers=c.get("num_hidden_layers", 12),
        num_attention_heads=c.get("num_attention_heads", 8),
        max_position_embeddings=c.get("max_position_embeddings", 77), hidden_act=c.get("hidden_act", "quick_gelu"),
        layer_norm_eps=c.get("layer_norm_eps", 1e-5), eos_token_id=c.get("eos_token_id", 49407),
    )
    tensors = load_safetensors_dir(path)
    if "text_projection.weight" not in tensors:
        raise ValueError(f"{path} has no text_projection.weight (CLIP-IQA needs full CLIPModel weights)")
    proj = tensors["text_projection.weight"].float().to(device)  # (P, D)
    params = _convert(tensors, skip=("text_model.embeddings.position_ids", "text_projection", "vision_model",
                                     "visual_projection", "logit_scale"), device=device)
    if input_ids is None:
        tok = CLIPTokenizer.from_pretrained(path)
        input_ids = tok(list(prompts), max_length=cfg.max_position_embeddings)
    with torch.no_grad():
        _, pooled = clip_text_apply(params, cfg, torch.as_tensor(input_ids).to(device))
    return F.linear(pooled.float(), proj)


def logit_scale_of(params) -> float:
    """The CLIP-IQA temperature: exp of the checkpoint's learned
    ``logit_scale`` where the tree holds one, else ``DEFAULT_LOGIT_SCALE``."""
    if "logit_scale" in params:
        return math.exp(float(params["logit_scale"]))
    return DEFAULT_LOGIT_SCALE


def clipiqa_score_preprocessed(params, cfg: CLIPVisionConfig, pixel_values, prompt_embeds, logit_scale=None):
    """CLIP-IQA on already CLIP-preprocessed (B, S, S, 3) pixels -> (B,) the
    probability of the positive prompt. ``logit_scale`` defaults to
    ``logit_scale_of(params)``."""
    if logit_scale is None:
        logit_scale = logit_scale_of(params)
    img = clip_image_features(params, cfg, pixel_values)
    img = img / (img.norm(dim=-1, keepdim=True) + 1e-10)
    txt = torch.as_tensor(prompt_embeds).to(device=img.device, dtype=img.dtype)
    txt = txt / (txt.norm(dim=-1, keepdim=True) + 1e-10)
    logits = logit_scale * img @ txt.T  # (B, 2)
    return torch.softmax(logits, dim=-1)[:, 0]


def clipiqa_score(params, cfg: CLIPVisionConfig, rgb01, prompt_embeds, logit_scale=None):
    """CLIP-IQA of [0, 1] RGB NHWC images (any size) -> (B,). prompt_embeds:
    (2, projection_dim) text embeddings, row 0 the positive prompt ("Good
    photo."), row 1 the negative ("Bad photo."); see
    ``clipiqa_prompt_embeds_from_clip_dir``."""
    return clipiqa_score_preprocessed(params, cfg, clip_preprocess(rgb01, cfg), prompt_embeds, logit_scale)
