"""LoRA adapter (de)serialisation.

Two formats:
  * native: one safetensors file of the LoRA tree with dotted keys, plus
    adapter_config.json (rank, targets, ``"format": "omgsr-tpu"``), written
    per checkpoint step like the reference's ``weight-{step}/{adapter_name}``
    layout (train/train_omgsr_s.py:507-518). The file holds the JAX package's
    layout exactly (f32; conv ``lora_A`` (kh, kw, in, r), ``lora_B`` (1, 1, r,
    out); dense ``lora_A`` (in, r), ``lora_B`` (r, out)), so an adapter written
    by either package loads in the other; the port converts at the boundary,
    as ``convert/params.from_jax_tree`` / ``to_jax_tree`` do.
  * PEFT import: the reference's torch-PEFT adapter_model.safetensors (keys
    ``base_model.model.<module>.lora_{A,B}[.default].weight``), whose torch
    layout is the port's own, so published OMGSR adapters load as they are.
"""

from __future__ import annotations

import json
import os

import torch

from omgsr_tpu_torch.convert.params import _conv_weight, from_jax_tree, to_jax_tree
from omgsr_tpu_torch.convert.safetensors_io import load_file, save_file
from omgsr_tpu_torch.utils.devices import resolve_device
from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict

WEIGHTS = "adapter_model.safetensors"
CONFIG = "adapter_config.json"


def save_adapter(lora_tree, path: str, *, rank: int, targets, extra_meta: dict | None = None):
    """Write a LoRA tree (the port's layout, any device) in the native format."""
    os.makedirs(path, exist_ok=True)
    flat = {".".join(p): torch.from_numpy(v) for p, v in flatten_dict(to_jax_tree(lora_tree)).items()}
    save_file(flat, os.path.join(path, WEIGHTS))
    meta = {"r": rank, "lora_alpha": rank, "target_modules": list(targets), "format": "omgsr-tpu"}
    meta.update(extra_meta or {})
    with open(os.path.join(path, CONFIG), "w") as f:
        json.dump(meta, f, indent=2)


def load_adapter(path: str, dtype=torch.float32, device="cuda"):
    """Native format -> (LoRA tree in the port's layout on ``device``, meta)."""
    device = resolve_device(device)
    flat = load_file(os.path.join(path, WEIGHTS))
    with open(os.path.join(path, CONFIG)) as f:
        meta = json.load(f)
    tree = unflatten_dict({tuple(k.split(".")): v.float().numpy() for k, v in flat.items()})
    return from_jax_tree(tree, dtype=dtype, device=device), meta


def import_peft_adapter(path: str, dtype=torch.float32, device="cuda"):
    """A torch-PEFT adapter directory (the reference's save format) -> (LoRA
    tree with the port's parameter paths, meta). If lora_alpha != r, alpha / r
    is folded into B (in f32) so the runtime scaling stays 1.0."""
    device = resolve_device(device)
    flat = load_file(os.path.join(path, WEIGHTS))
    with open(os.path.join(path, CONFIG)) as f:
        meta = json.load(f)
    scale = float(meta.get("lora_alpha", meta["r"])) / float(meta["r"])

    out = {}
    for key, w in flat.items():
        k = key
        for prefix in ("base_model.model.", "base_model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        # strip the trailing ".weight" and the ".default" adapter scoping
        k = k.replace(".default.weight", "").replace(".weight", "")
        if k.endswith(".lora_A"):
            mpath, leaf = k[: -len(".lora_A")], "lora_A"
        elif k.endswith(".lora_B"):
            mpath, leaf = k[: -len(".lora_B")], "lora_B"
        else:
            continue
        if w.dim() not in (2, 4):
            raise ValueError(f"unexpected adapter tensor ndim {w.dim()} for {key}")
        w = w.float()
        if leaf == "lora_B":
            w = w * scale
        w = w.to(device=device, dtype=dtype)
        out[tuple(mpath.split(".")) + (leaf,)] = _conv_weight(w) if w.dim() == 4 else w.contiguous()
    return unflatten_dict(out), meta
