"""Prompt encoding for the CLIs.

The tokenizer reads its files from the checkpoint directory
(``models/clip_tokenizer.py``) and the text tower is the port's own, fed by
the porters. The CLIs also accept pre-computed embeddings (.npz), the
reference's fixed_prompt_path escape hatch (train/train_omgsr_s.py:200-201).
FLUX's prompt encoders (T5-XXL, CLIP-L) are not ported yet: the -F CLIs take
the .npz only.
"""

from __future__ import annotations

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


def load_prompt_npz(path: str) -> dict:
    """Pre-computed embeddings: npz with prompt_embeds [, pooled_prompt_embeds,
    text_ids] arrays, as CPU tensors."""
    data = np.load(path)
    return {k: torch.from_numpy(data[k]) for k in data.files}
