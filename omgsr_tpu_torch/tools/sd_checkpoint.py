"""Write an SD2.1-base checkpoint directory in the published diffusers/HF
layout, with the port's own safetensors writer, so the load path and the CLIs
can run end to end where no trained checkpoint is at hand (``chip_smoke.py``
writes the weights it holds at full SD2.1 width). ``write_sd_checkpoint``
takes parameter trees in the port's layout (any device and dtype). The layout:

    vae/config.json, vae/diffusion_pytorch_model.safetensors
    unet/config.json, unet/diffusion_pytorch_model-0000k-of-0000n.safetensors
        + unet/diffusion_pytorch_model.safetensors.index.json
    text_encoder/config.json, text_encoder/model.safetensors
    tokenizer/vocab.json, merges.txt, special_tokens_map.json, tokenizer_config.json

The vocabulary is 256 byte symbols, the same 256 closing a word (``</w>``),
one entry per merge, then ``<|startoftext|>`` and ``<|endoftext|>`` (49,406
and 49,407 at the published size); the pad token is ``!`` (id 0), as in
SD2.1's tokenizer files. The merges are drawn from a seed: first every pair of
lower-case letters, inside and at the end of a word, then pairs of existing
symbols, so ordinary prompts merge into multi-letter tokens.
"""

from __future__ import annotations

import json
import os
import random
import time

import torch

from omgsr_tpu_torch.convert.params import to_hf_state_dict
from omgsr_tpu_torch.convert.safetensors_io import save_file
from omgsr_tpu_torch.models.clip_tokenizer import MAX_MERGES, bytes_to_unicode

BOS, EOS, PAD = "<|startoftext|>", "<|endoftext|>", "!"


def synthetic_bpe(n_merges: int = MAX_MERGES, seed: int = 0):
    """(vocab {token: id}, merges [(a, b)]) in CLIP's order."""
    rng = random.Random(seed)
    chars = list(bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars]
    seen = set(vocab)
    merges = []

    def add(a, b):
        if a + b in seen or len(merges) >= n_merges:
            return
        merges.append((a, b))
        vocab.append(a + b)
        seen.add(a + b)

    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    pairs = [(a, b) for a in letters for b in letters] + [(a, b + "</w>") for a in letters for b in letters]
    rng.shuffle(pairs)
    for a, b in pairs:
        add(a, b)
    inner = [t for t in vocab if not t.endswith("</w>")]
    while len(merges) < n_merges:
        a = inner[min(int(rng.expovariate(1.0 / 600)), len(inner) - 1)]
        b = vocab[min(int(rng.expovariate(1.0 / 900)), len(vocab) - 1)]
        if len(a) + len(b) > 24:
            continue
        n = len(merges)
        add(a, b)
        if len(merges) > n and not b.endswith("</w>"):
            inner.append(a + b)
    vocab += [BOS, EOS]
    return {t: i for i, t in enumerate(vocab)}, merges


def write_tokenizer(path: str, vocab: dict, merges: list, pad_token: str = PAD, model_max_length: int = 77):
    """vocab.json, merges.txt and the two config files of SD2.1's tokenizer/."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))

    def added(content):
        return {"content": content, "lstrip": False, "normalized": True, "rstrip": False, "single_word": False}

    special = {"bos_token": added(BOS), "eos_token": added(EOS), "pad_token": pad_token, "unk_token": added(EOS)}
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump(special, f, indent=2)
    config = {"add_prefix_space": False, "do_lower_case": True, "errors": "replace",
              "model_max_length": model_max_length, "tokenizer_class": "CLIPTokenizer",
              **{k: ({"__type": "AddedToken", **v} if isinstance(v, dict) else v) for k, v in special.items()}}
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f, indent=2)


def vae_config_json(cfg) -> dict:
    return {"_class_name": "AutoencoderKL", "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
            "latent_channels": cfg.latent_channels, "block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block, "norm_num_groups": cfg.norm_num_groups,
            "scaling_factor": cfg.scaling_factor, "shift_factor": cfg.shift_factor,
            "use_quant_conv": cfg.use_quant_conv, "use_post_quant_conv": cfg.use_post_quant_conv,
            "mid_block_add_attention": cfg.mid_block_attention,
            "down_block_types": ["DownEncoderBlock2D"] * len(cfg.block_out_channels),
            "up_block_types": ["UpDecoderBlock2D"] * len(cfg.block_out_channels)}


def unet_config_json(cfg) -> dict:
    # diffusers' SD2.1 config names the per-block head counts attention_head_dim
    return {"_class_name": "UNet2DConditionModel", "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
            "block_out_channels": list(cfg.block_out_channels), "layers_per_block": cfg.layers_per_block,
            "cross_attention_dim": cfg.cross_attention_dim, "attention_head_dim": list(cfg.num_attention_heads),
            "down_block_types": list(cfg.down_block_types), "up_block_types": list(cfg.up_block_types),
            "norm_num_groups": cfg.norm_num_groups, "norm_eps": cfg.norm_eps,
            "transformer_layers_per_block": cfg.transformer_layers_per_block,
            "use_linear_projection": cfg.use_linear_projection, "flip_sin_to_cos": cfg.flip_sin_to_cos,
            "freq_shift": cfg.freq_shift}


def clip_config_json(cfg) -> dict:
    return {"architectures": ["CLIPTextModel"], "model_type": "clip_text_model", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers, "num_attention_heads": cfg.num_attention_heads,
            "max_position_embeddings": cfg.max_position_embeddings, "hidden_act": cfg.hidden_act,
            "layer_norm_eps": cfg.layer_norm_eps, "bos_token_id": 0, "eos_token_id": cfg.eos_token_id,
            "pad_token_id": 1, "projection_dim": 512, "torch_dtype": "float32"}


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def save_sharded(state: dict, path: str, stem: str, shards: int) -> list[str]:
    """``state`` in ``shards`` files of about equal size plus the index json."""
    keys = sorted(state)
    total = sum(state[k].numel() * state[k].element_size() for k in keys)
    groups, cur, acc = [], [], 0
    for k in keys:
        cur.append(k)
        acc += state[k].numel() * state[k].element_size()
        if acc >= total * (len(groups) + 1) / shards and len(groups) < shards - 1:
            groups.append(cur)
            cur = []
    groups.append(cur)
    base, ext = stem.rsplit(".", 1)
    names = [f"{base}-{i + 1:05d}-of-{len(groups):05d}.{ext}" for i in range(len(groups))]
    weight_map = {}
    for name, group in zip(names, groups):
        save_file({k: state[k] for k in group}, os.path.join(path, name), metadata={"format": "pt"})
        weight_map.update({k: name for k in group})
    _write_json(os.path.join(path, f"{stem}.index.json"), {"metadata": {"total_size": total}, "weight_map": weight_map})
    return names


def write_sd_checkpoint(root: str, vae, vae_cfg, unet, unet_cfg, clip=None, clip_cfg=None, tokenizer=None,
                        dtype=torch.float32, unet_shards: int = 2) -> dict:
    """Write the trees (the port's layout) under ``root`` in ``dtype`` (f32 as
    published). ``tokenizer``: (vocab, merges). Returns {component: (seconds,
    bytes)}."""
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        nbytes = fn()
        out[name] = (time.perf_counter() - t0, nbytes)

    def one_file(sub, tree, stem, config):
        def write():
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            state = to_hf_state_dict(tree, dtype)
            _write_json(os.path.join(root, sub, "config.json"), config)
            if sub == "unet" and unet_shards > 1:
                save_sharded(state, os.path.join(root, sub), stem, unet_shards)
            else:
                save_file(state, os.path.join(root, sub, stem), metadata={"format": "pt"})
            return sum(t.numel() * t.element_size() for t in state.values())
        timed(sub, write)

    one_file("vae", vae, "diffusion_pytorch_model.safetensors", vae_config_json(vae_cfg))
    one_file("unet", unet, "diffusion_pytorch_model.safetensors", unet_config_json(unet_cfg))
    if clip is not None:
        one_file("text_encoder", clip, "model.safetensors", clip_config_json(clip_cfg))
    if tokenizer is not None:
        timed("tokenizer", lambda: write_tokenizer(os.path.join(root, "tokenizer"), *tokenizer) or 0)
    return out

