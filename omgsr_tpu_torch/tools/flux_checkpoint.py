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
    prompt.npz (prompt_embeds, pooled_prompt_embeds), when given

Each config.json holds the keys of the published one (the VAE's those of
``tools/sd_checkpoint.vae_config_json``, with FLUX's 16 latent channels, shift
and no quant convs); the transformer's states the depth written.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from omgsr_tpu_torch.convert.params import to_hf_state_dict
from omgsr_tpu_torch.convert.safetensors_io import save_file
from omgsr_tpu_torch.tools.sd_checkpoint import save_sharded, vae_config_json


def flux_config_json(cfg) -> dict:
    """black-forest-labs/FLUX.1-dev transformer/config.json for ``cfg``."""
    return {"_class_name": "FluxTransformer2DModel", "attention_head_dim": cfg.attention_head_dim,
            "axes_dims_rope": list(cfg.axes_dims_rope), "guidance_embeds": cfg.guidance_embeds,
            "in_channels": cfg.in_channels, "joint_attention_dim": cfg.joint_attention_dim,
            "num_attention_heads": cfg.num_attention_heads, "num_layers": cfg.num_layers,
            "num_single_layers": cfg.num_single_layers, "patch_size": 1,
            "pooled_projection_dim": cfg.pooled_projection_dim}


def write_flux_checkpoint(root: str, vae, vae_cfg, flux, flux_cfg, dtype=torch.bfloat16,
                          transformer_shards: int = 2, prompt=None) -> dict:
    """Write the trees (the port's layout) under ``root``: the VAE in f32 and
    the DiT in ``dtype`` (as published). ``prompt``: (prompt_embeds,
    pooled_prompt_embeds) to store as prompt.npz in f32. Returns {component:
    (seconds, bytes)}."""
    out = {}

    def write(sub, tree, cast, config, shards):
        t0 = time.perf_counter()
        path = os.path.join(root, sub)
        os.makedirs(path, exist_ok=True)
        state = to_hf_state_dict(tree, cast)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2)
        stem = "diffusion_pytorch_model.safetensors"
        if shards > 1:
            save_sharded(state, path, stem, shards)
        else:
            save_file(state, os.path.join(path, stem), metadata={"format": "pt"})
        out[sub] = (time.perf_counter() - t0, sum(t.numel() * t.element_size() for t in state.values()))

    vae_json = {**vae_config_json(vae_cfg), "force_upcast": True, "sample_size": 1024}
    write("vae", vae, torch.float32, vae_json, 1)
    write("transformer", flux, dtype, flux_config_json(flux_cfg), transformer_shards)
    if prompt is not None:
        embeds, pooled = (torch.as_tensor(p).detach().float().cpu().numpy() for p in prompt)
        np.savez(os.path.join(root, "prompt.npz"), prompt_embeds=embeds, pooled_prompt_embeds=pooled)
    return out
