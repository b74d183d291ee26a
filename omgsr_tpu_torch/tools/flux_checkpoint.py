"""Write a FLUX.1-dev checkpoint directory in the published diffusers/HF
layout, with the port's own safetensors writer, so the -F load path and CLIs
can run end to end where no trained checkpoint is at hand (``chip_smoke.py``
writes the DiT it holds at full width and reduced depth).
``write_flux_checkpoint`` takes parameter trees in the port's layout (any
device and dtype). The layout:

    vae/config.json, vae/diffusion_pytorch_model.safetensors
    transformer/config.json,
        transformer/diffusion_pytorch_model-0000k-of-0000n.safetensors
        + transformer/diffusion_pytorch_model.safetensors.index.json
    text_encoder/config.json, text_encoder/model.safetensors (CLIP-L)
    tokenizer/vocab.json, merges.txt, special_tokens_map.json, tokenizer_config.json
    text_encoder_2/config.json, text_encoder_2/model-0000k-of-0000n.safetensors
        + text_encoder_2/model.safetensors.index.json (T5 encoder, bf16)
    tokenizer_2/tokenizer.json, special_tokens_map.json, tokenizer_config.json
    prompt.npz (prompt_embeds, pooled_prompt_embeds), when given

Each config.json holds the keys of the published one (the VAE's those of
``tools/sd_checkpoint.vae_config_json``, with FLUX's 16 latent channels, shift
and no quant convs); the transformer's and the T5's state the depth written.
The text encoders and their tokenizers are written when given.

The vocabularies are synthetic, from a seed, at the published sizes: CLIP-L's
that of ``tools/sd_checkpoint.synthetic_bpe`` (49,408 entries, pad token
``<|endoftext|>`` as in openai/clip-vit-large-patch14), T5's a Unigram model of
32,000 scored pieces (``<pad>``, ``</s>``, ``<unk>``, ``▁``, single characters,
then words and word pieces) plus 100 ``<extra_id_N>`` tokens, with the
published tokenizer.json's pipeline: a ``Precompiled`` charsmap
(``precompiled_charsmap``: here NFKC's mappings of a few blocks and the
compositions of accented Latin letters), ``Strip`` right, ``Replace`` of runs
of spaces, the ``Metaspace`` pre-tokenizer and the ``</s>`` template.
"""

from __future__ import annotations

import base64
import json
import math
import os
import random
import struct
import time
import unicodedata

import numpy as np
import torch

from omgsr_tpu_torch.convert.params import to_hf_state_dict
from omgsr_tpu_torch.convert.safetensors_io import save_file
from omgsr_tpu_torch.tools.sd_checkpoint import (
    clip_config_json,
    save_sharded,
    synthetic_bpe,
    vae_config_json,
    write_tokenizer,
)

T5_EXTRA_IDS = 100
T5_PIECES = 32000  # google/t5-v1_1-xxl's sentencepiece model; ids 32,000-32,099 are the extra ids


# ----------------------------------------------------------------------------
# T5's tokenizer files
# ----------------------------------------------------------------------------


def precompiled_charsmap(rules: dict) -> bytes:
    """The sentencepiece charsmap blob of ``rules`` {source: replacement}: a
    uint32 byte size, a darts-clone double-array trie over the sources' UTF-8
    bytes whose values are offsets into the replacement strings, then the
    replacements, each ended by a NUL byte. A unit holds a label (bits 0-7),
    a has-leaf flag (bit 8) and the XOR offset of its children (bits 10-30); a
    leaf unit holds its value with bit 31 set, at the offset of its parent.
    Every base is used by one node only, so no path can wander into another
    node's children, and the array is padded to a multiple of 256 units."""
    normalized, trie = bytearray(), {}
    for src, dst in sorted(rules.items()):
        key = src.encode("utf-8")
        if not key or b"\0" in key or "\0" in dst:
            raise ValueError(f"charsmap rule {src!r} -> {dst!r}")
        node = trie
        for c in key:
            node = node.setdefault(c, {})
        node[0] = len(normalized)  # label 0: the leaf
        normalized += dst.encode("utf-8") + b"\0"
    units, used, bases = {}, {0}, set()
    free = 1  # the lowest position not yet used

    def place(pos, node):
        nonlocal free
        labels = sorted(node)
        p = free
        while True:
            base = p ^ labels[0]
            if base not in bases and all((base ^ c) not in used for c in labels):
                break
            p += 1
            while p in used:
                p += 1
        bases.add(base)
        used.update(base ^ c for c in labels)
        while free in used:
            free += 1
        units[pos] = units.get(pos, 0) | ((pos ^ base) << 10)
        for c in labels:
            if c == 0:
                units[base] = node[0] | (1 << 31)
                units[pos] |= 1 << 8
            else:
                units[base ^ c] = c
        for c in labels:
            if c:
                place(base ^ c, node[c])

    place(0, trie)
    size = (max(max(units), max(bases)) | 255) + 1
    assert size < (1 << 21), size
    array = struct.pack(f"<{size}I", *(units.get(i, 0) for i in range(size)))
    return struct.pack("<I", len(array)) + array + bytes(normalized)


def nfkc_charsmap_rules() -> dict:
    """NFKC's mappings of the full-width forms, the space and punctuation
    blocks and a few compatibility characters, the compositions of accented
    Latin-1 letters, tabs and newlines to a space and other controls dropped:
    the kinds of rule the published nmt_nfkc charsmap holds."""
    rules = {}
    for lo, hi in ((0xA0, 0xBF), (0x2000, 0x206F), (0x2460, 0x24FF), (0x3000, 0x303F), (0xFB00, 0xFB06),
                   (0xFF01, 0xFFEE)):
        for cp in range(lo, hi + 1):
            ch = chr(cp)
            norm = unicodedata.normalize("NFKC", ch)
            if norm != ch and "\0" not in norm:
                rules[ch] = norm
    for cp in range(0xC0, 0x180):
        ch = chr(cp)
        nfd = unicodedata.normalize("NFD", ch)
        if nfd != ch:
            rules[nfd] = ch
    rules.update({chr(c): " " for c in (0x09, 0x0A, 0x0B, 0x0C, 0x0D)})
    rules.update({chr(c): "" for c in [*range(0x01, 0x09), *range(0x0E, 0x20), 0x7F]})
    return rules


def synthetic_unigram(n_pieces: int = T5_PIECES, seed: int = 0) -> list:
    """[(piece, score)]: ``<pad>``, ``</s>``, ``<unk>`` (score 0), ``▁``,
    the printable ASCII characters, accented Latin letters and a few CJK
    ideographs, then whole words (``▁``-prefixed) and word pieces drawn from a
    seed, with scores falling with the rank as in a trained model."""
    rng = random.Random(seed)
    specials = ["<pad>", "</s>", "<unk>"]
    chars = ["▁"] + [chr(c) for c in range(0x21, 0x7F)] + [chr(c) for c in range(0xC0, 0x180)] \
        + [chr(c) for c in range(0x4E00, 0x4E40)]
    letters = "etaoinshrdlcumwfgypbvkjxqz"
    weights = [1.0 / (i + 2) for i in range(len(letters))]
    seen, words = set(specials + chars), []
    while len(specials) + len(chars) + len(words) < n_pieces:
        w = "".join(rng.choices(letters, weights, k=max(1, min(12, int(rng.expovariate(1 / 4.0)) + 1))))
        for piece in ("▁" + w, w) if rng.random() < 0.5 else ("▁" + w,):
            if piece not in seen:
                seen.add(piece)
                words.append(piece)
    pieces = (chars + words)[: n_pieces - len(specials)]
    order = list(range(len(pieces)))
    rng.shuffle(order)
    scored = [(specials[i], 0.0) for i in range(3)]
    for rank, piece in enumerate(pieces):
        # single characters take the lower scores of the tail, as in the published model
        r = rank if len(piece) > 1 or piece == "▁" else len(pieces) - 1 - order[rank] % len(chars)
        scored.append((piece, -math.log(r + 2) - 0.01 * rng.random()))
    return scored


def t5_tokenizer_json(pieces: list, charsmap: bytes, extra_ids: int = T5_EXTRA_IDS) -> dict:
    """google/t5-v1_1-xxl's tokenizer.json layout for a Unigram vocabulary."""
    def added(i, content):
        return {"id": i, "content": content, "single_word": False, "lstrip": False, "rstrip": False,
                "normalized": False, "special": True}

    n = len(pieces)
    tokens = [added(i, pieces[i][0]) for i in range(3)]
    tokens += [added(n + i, f"<extra_id_{extra_ids - 1 - i}>") for i in range(extra_ids)]
    eos = {"id": "</s>", "ids": [1], "tokens": ["</s>"]}
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": tokens,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(charsmap).decode("ascii")},
            {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                           "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                                    {"SpecialToken": {"id": "</s>", "type_id": 0}},
                                    {"Sequence": {"id": "B", "type_id": 0}},
                                    {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                           "special_tokens": {"</s>": eos}},
        "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": 2, "vocab": [[p, s] for p, s in pieces], "byte_fallback": False},
    }


def write_t5_tokenizer(path: str, pieces: list, charsmap: bytes, extra_ids: int = T5_EXTRA_IDS,
                       model_max_length: int = 512):
    """tokenizer.json and the two config files of FLUX.1-dev's tokenizer_2/."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(t5_tokenizer_json(pieces, charsmap, extra_ids), f, ensure_ascii=False)
    extras = [f"<extra_id_{i}>" for i in range(extra_ids)]
    special = {"eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>", "additional_special_tokens": extras}
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump(special, f, indent=2)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({**special, "extra_ids": extra_ids, "legacy": True, "model_max_length": model_max_length,
                   "tokenizer_class": "T5Tokenizer", "clean_up_tokenization_spaces": True}, f, indent=2)


def t5_config_json(cfg) -> dict:
    """google/t5-v1_1-xxl's config.json (FLUX.1-dev text_encoder_2) for ``cfg``."""
    return {"architectures": ["T5EncoderModel"], "model_type": "t5", "d_ff": cfg.d_ff, "d_kv": cfg.d_kv,
            "d_model": cfg.d_model, "dense_act_fn": "gelu_new", "feed_forward_proj": cfg.feed_forward_proj,
            "is_gated_act": True, "layer_norm_epsilon": cfg.layer_norm_epsilon, "num_heads": cfg.num_heads,
            "num_layers": cfg.num_layers, "relative_attention_max_distance": cfg.relative_attention_max_distance,
            "relative_attention_num_buckets": cfg.relative_attention_num_buckets, "vocab_size": cfg.vocab_size,
            "eos_token_id": 1, "pad_token_id": 0, "tie_word_embeddings": False, "torch_dtype": "bfloat16"}


def synthetic_text_tokenizers(seed: int = 0):
    """(CLIP-L (vocab, merges), T5 (pieces, charsmap)) at the published sizes."""
    return synthetic_bpe(seed=seed), (synthetic_unigram(T5_PIECES, seed), precompiled_charsmap(nfkc_charsmap_rules()))


def flux_config_json(cfg) -> dict:
    """black-forest-labs/FLUX.1-dev transformer/config.json for ``cfg``."""
    return {"_class_name": "FluxTransformer2DModel", "attention_head_dim": cfg.attention_head_dim,
            "axes_dims_rope": list(cfg.axes_dims_rope), "guidance_embeds": cfg.guidance_embeds,
            "in_channels": cfg.in_channels, "joint_attention_dim": cfg.joint_attention_dim,
            "num_attention_heads": cfg.num_attention_heads, "num_layers": cfg.num_layers,
            "num_single_layers": cfg.num_single_layers, "patch_size": 1,
            "pooled_projection_dim": cfg.pooled_projection_dim}


def write_flux_checkpoint(root: str, vae, vae_cfg, flux, flux_cfg, dtype=torch.bfloat16,
                          transformer_shards: int = 2, prompt=None, clip=None, clip_cfg=None, t5=None, t5_cfg=None,
                          tokenizers=None) -> dict:
    """Write the trees (the port's layout) under ``root``: the VAE and the
    CLIP-L text encoder in f32, the DiT and the T5 encoder in ``dtype`` (as
    published). ``prompt``: (prompt_embeds, pooled_prompt_embeds) to store as
    prompt.npz in f32. ``tokenizers``: ``synthetic_text_tokenizers``'s pair,
    written to tokenizer/ and tokenizer_2/. Returns {component: (seconds,
    bytes)}."""
    out = {}

    def write(sub, tree, cast, config, shards, stem="diffusion_pytorch_model.safetensors"):
        t0 = time.perf_counter()
        path = os.path.join(root, sub)
        os.makedirs(path, exist_ok=True)
        state = to_hf_state_dict(tree, cast)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2)
        if shards > 1:
            save_sharded(state, path, stem, shards)
        else:
            save_file(state, os.path.join(path, stem), metadata={"format": "pt"})
        out[sub] = (time.perf_counter() - t0, sum(t.numel() * t.element_size() for t in state.values()))

    vae_json = {**vae_config_json(vae_cfg), "force_upcast": True, "sample_size": 1024}
    write("vae", vae, torch.float32, vae_json, 1)
    write("transformer", flux, dtype, flux_config_json(flux_cfg), transformer_shards)
    if clip is not None:
        write("text_encoder", clip, torch.float32, clip_config_json(clip_cfg), 1, "model.safetensors")
    if t5 is not None:
        write("text_encoder_2", t5, dtype, t5_config_json(t5_cfg), 2, "model.safetensors")
    if tokenizers is not None:
        t0 = time.perf_counter()
        (vocab, merges), (pieces, charsmap) = tokenizers
        write_tokenizer(os.path.join(root, "tokenizer"), vocab, merges, pad_token="<|endoftext|>")
        write_t5_tokenizer(os.path.join(root, "tokenizer_2"), pieces, charsmap)
        out["tokenizers"] = (time.perf_counter() - t0, sum(
            os.path.getsize(os.path.join(root, d, f)) for d in ("tokenizer", "tokenizer_2")
            for f in os.listdir(os.path.join(root, d))))
    if prompt is not None:
        embeds, pooled = (torch.as_tensor(p).detach().float().cpu().numpy() for p in prompt)
        np.savez(os.path.join(root, "prompt.npz"), prompt_embeds=embeds, pooled_prompt_embeds=pooled)
    return out
