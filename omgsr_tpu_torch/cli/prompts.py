"""Prompt encoding for the CLIs.

The tokenizers read their files from the checkpoint directory
(``models/clip_tokenizer.py``, ``models/t5_tokenizer.py``) and the text
towers are the port's own, fed by the porters. The CLIs also accept
pre-computed embeddings (.npz), the reference's fixed_prompt_path escape
hatch (train/train_omgsr_s.py:200-201, train/train_omgsr_f.py:255-257).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from omgsr_tpu_torch.utils.devices import resolve_device


def encode_prompt_sd(sd_path: str, prompt: str, dtype=torch.float32, device="cuda"):
    """CLIP ViT-H embedding (1, 77, 1024) for OMGSR-S
    (infer/infer_omgsr_s.py:24-42 capability). The text encoder's config
    comes from ``text_encoder/config.json`` (SD2.1's where there is none);
    it runs in f32, as in the JAX package, and the result is cast to
    ``dtype``."""
    from omgsr_tpu_torch.convert.hf_config import clip_config_from_json
    from omgsr_tpu_torch.convert.porters import port_clip_text
    from omgsr_tpu_torch.models.clip_text import clip_text_apply
    from omgsr_tpu_torch.models.clip_tokenizer import CLIPTokenizer
    from omgsr_tpu_torch.models.configs import SD21_CLIP

    device = resolve_device(device)
    tokenizer = CLIPTokenizer.from_pretrained(os.path.join(sd_path, "tokenizer"))
    ids = tokenizer(prompt, max_length=tokenizer.model_max_length)
    enc_dir = os.path.join(sd_path, "text_encoder")
    has_config = os.path.exists(os.path.join(enc_dir, "config.json"))
    cfg = clip_config_from_json(enc_dir) if has_config else SD21_CLIP
    params = port_clip_text(enc_dir, cfg=cfg, dtype=torch.float32, device=device)
    with torch.no_grad():  # not inference_mode: training saves the embeddings for its backward
        hidden, _ = clip_text_apply(params, cfg, ids.to(device))
    return hidden.to(dtype)


def encode_prompt_flux(flux_path: str, prompt: str, max_sequence_length: int = 512, dtype=torch.bfloat16,
                       device="cuda"):
    """(prompt_embeds (1, 512, 4096) from T5-XXL, pooled (1, 768) from CLIP-L,
    txt_ids (512, 3)): FluxPipeline.encode_prompt's capability
    (train/train_omgsr_f.py:244-251). The encoders' configs come from
    ``text_encoder/`` and ``text_encoder_2/`` config.json (the published
    ones' where there is none); CLIP-L runs in f32 and T5 in the porter's
    default bf16, as in the JAX package. The pooled output is
    taken at the tokenizer's EOS id (transformers reads it so for CLIP-L,
    whose config names eos_token_id 2). Both results are cast to ``dtype``."""
    from omgsr_tpu_torch.convert.hf_config import clip_config_from_json, t5_config_from_json
    from omgsr_tpu_torch.convert.porters import port_clip_text, port_t5_encoder
    from omgsr_tpu_torch.models.clip_text import clip_text_apply
    from omgsr_tpu_torch.models.clip_tokenizer import CLIPTokenizer
    from omgsr_tpu_torch.models.configs import FLUX_CLIP_L, FLUX_T5_XXL
    from omgsr_tpu_torch.models.t5 import t5_encode
    from omgsr_tpu_torch.models.t5_tokenizer import T5Tokenizer

    device = resolve_device(device)

    def config(sub, read, default):
        path = os.path.join(flux_path, sub)
        return read(path) if os.path.exists(os.path.join(path, "config.json")) else default

    clip_tok = CLIPTokenizer.from_pretrained(os.path.join(flux_path, "tokenizer"))
    ids = clip_tok(prompt, max_length=clip_tok.model_max_length)
    clip_cfg = dataclasses.replace(config("text_encoder", clip_config_from_json, FLUX_CLIP_L),
                                   eos_token_id=clip_tok.eos_token_id)
    clip_params = port_clip_text(os.path.join(flux_path, "text_encoder"), cfg=clip_cfg, dtype=torch.float32,
                                 device=device)
    with torch.no_grad():  # not inference_mode: training saves the embeddings for its backward
        _, pooled = clip_text_apply(clip_params, clip_cfg, ids.to(device))
    del clip_params

    t5_tok = T5Tokenizer.from_pretrained(os.path.join(flux_path, "tokenizer_2"))
    t5_ids = t5_tok(prompt, max_length=max_sequence_length)
    t5_cfg = config("text_encoder_2", t5_config_from_json, FLUX_T5_XXL)
    t5_params = port_t5_encoder(os.path.join(flux_path, "text_encoder_2"), cfg=t5_cfg, device=device)
    with torch.no_grad():
        embeds = t5_encode(t5_params, t5_cfg, t5_ids.to(device))
    del t5_params

    txt_ids = torch.zeros((embeds.shape[1], 3), dtype=torch.float32, device=device)
    return embeds.to(dtype), pooled.to(dtype), txt_ids


def load_prompt_npz(path: str) -> dict:
    """Pre-computed embeddings: npz with prompt_embeds [, pooled_prompt_embeds,
    text_ids] arrays, as CPU tensors."""
    data = np.load(path)
    return {k: torch.from_numpy(data[k]) for k in data.files}
