"""LoRA: injection by module-path matching, functional application, merge.

Reference semantics re-implemented (peft.LoraConfig usage at
train/train_omgsr_s.py:60-115):
  * targets matched by dotted-name suffix against module paths, e.g. "to_q",
    "conv1", "to_out.0";
  * rank r with alpha == r (scaling 1.0: the reference always sets
    lora_alpha=rank);
  * "gaussian" init: A ~ N(0, 1)/r, B = 0  (peft init_lora_weights="gaussian");
  * dense delta  = (x @ A^T) @ B^T with A (r, in), B (out, r);
  * conv delta   = conv(x, A (r, in, kh, kw)) then 1x1 conv B (out, r, 1, 1)
    (peft wraps Conv2d the same way);
  * merge-and-unload folds the delta into the base weight
    (infer/omgsr_s_infer_model.py:16-23).

Mechanically: a LoRA tree mirrors the base param tree at matched modules
with {"lora_A","lora_B"} leaves, in torch layout like every leaf of the port
(convert/params.py carries a JAX-layout tree across). ``attach_lora`` returns
a combined tree the model apply-fns consume: ``layers.dense`` /
``layers.conv2d`` add the low-rank delta whenever those keys are present.
Training differentiates w.r.t. the LoRA tree only; ``attach_lora`` is pure
tree surgery and copies no tensor. The FLUX DiT's blocks are a dict per
block here (no scan-stacked layout; ``convert/params.from_jax_tree`` unstacks
a JAX tree). A quantised frozen base (``weight_q`` / ``weight_q4``,
utils/quantize.py) takes LoRA too: its factors default to bf16, and the
adapter stays attached, since the delta cannot merge into codes.
"""

from __future__ import annotations

import torch

from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict

# train/train_omgsr_s.py:60-100 (same list for VAE encoder and UNet)
SD_TARGET_MODULES = (
    "conv1",
    "conv2",
    "conv_in",
    "conv_shortcut",
    "conv",
    "conv_out",
    "to_k",
    "to_q",
    "to_v",
    "to_out.0",
)

# train/train_omgsr_f.py:154-169
FLUX_TARGET_MODULES = (
    "x_embedder",
    "attn.to_k",
    "attn.to_q",
    "attn.to_v",
    "attn.to_out.0",
    "attn.add_k_proj",
    "attn.add_q_proj",
    "attn.add_v_proj",
    "attn.to_add_out",
    "ff.net.0.proj",
    "ff.net.2",
    "ff_context.net.0.proj",
    "ff_context.net.2",
)


def path_matches_targets(module_path: str, targets) -> bool:
    """peft-style suffix match on the dotted module path."""
    for t in targets:
        if module_path == t or module_path.endswith("." + t):
            return True
    return False


def _iter_matched_weights(params, targets):
    for path, leaf in flatten_dict(params).items():
        if path[-1] not in ("weight", "weight_q", "weight_q4") or len(leaf.shape) not in (2, 4):
            continue  # norm weights are rank 1 and never a target
        if path_matches_targets(".".join(path[:-1]), targets):
            yield path[:-1], leaf, path[-1] == "weight_q4"


def init_lora_tree(generator: torch.Generator, params, targets, rank: int, dtype=None):
    """A LoRA tree for every matched dense / conv weight in ``params``, float
    or quantised: A ~ N(0, 1) / rank drawn from ``generator`` (which must
    live on the parameters' device), B = 0, in ``dtype``, else the base
    weight's, else bf16 over quantised codes (int4's in dim is the packed dim
    doubled). Only the weights' shape, dtype and device are read, so a tree
    placed by FSDP (``parallel.sharding.FSDPLeaf``, whose shape is the whole
    leaf's) gets the draws of the whole tree."""
    out = {}
    matched = list(_iter_matched_weights(params, targets))
    if not matched:
        raise ValueError(f"no modules matched targets {targets}")
    for mpath, weight, packed4 in matched:
        kdtype = dtype or (weight.dtype if weight.dtype.is_floating_point else torch.bfloat16)
        if len(weight.shape) == 2:  # dense (out, in)
            out_dim, in_dim = weight.shape
            in_dim *= 2 if packed4 else 1
            a_shape, b_shape = (rank, in_dim), (out_dim, rank)
        else:  # conv (out, in, kh, kw)
            out_ch, in_ch, kh, kw = weight.shape
            a_shape, b_shape = (rank, in_ch, kh, kw), (out_ch, rank, 1, 1)
        a = torch.randn(a_shape, generator=generator, device=weight.device, dtype=torch.float32)
        out[mpath + ("lora_A",)] = (a * (1.0 / rank)).to(kdtype)
        out[mpath + ("lora_B",)] = torch.zeros(b_shape, device=weight.device, dtype=kdtype)
    return unflatten_dict(out)


def attach_lora(base_params, lora_tree):
    """Combined tree: matched module dicts gain lora_A/lora_B keys. Any
    non-dict is a leaf, so a placed base keeps its ``FSDPLeaf`` chunks beside
    the LoRA keys and a block's gather yields base plus LoRA."""
    flat = flatten_dict(base_params)
    flat.update(flatten_dict(lora_tree))
    return unflatten_dict(flat)


def split_lora(combined):
    """Inverse of attach_lora: -> (base_params, lora_tree)."""
    base, lora = {}, {}
    for path, leaf in flatten_dict(combined).items():
        (lora if path[-1] in ("lora_A", "lora_B") else base)[path] = leaf
    return unflatten_dict(base), unflatten_dict(lora)


def _merged_weight(weight, a, b):
    if weight.dim() == 2:  # (out, r) @ (r, in)
        delta = b.float() @ a.float()
    else:  # (out, r, 1, 1) x (r, in, kh, kw) -> (out, in, kh, kw)
        delta = torch.einsum("or,rihw->oihw", b.float()[:, :, 0, 0], a.float())
        delta = delta.contiguous(memory_format=torch.channels_last)
    return (weight.float() + delta).to(weight.dtype)


def merge_lora(base_params, lora_tree):
    """Fold the LoRA delta into base weights ("merge_and_unload" parity,
    infer/omgsr_s_infer_model.py:22-23)."""
    flat = flatten_dict(base_params)
    lflat = flatten_dict(lora_tree)
    for mpath in {p[:-1] for p in lflat if p[-1] == "lora_A"}:
        if mpath + ("weight",) not in flat and (mpath + ("weight_q",) in flat or mpath + ("weight_q4",) in flat):
            raise ValueError(
                f"cannot merge LoRA into a quantized kernel at {'.'.join(mpath)}: "
                "merge into the float base before quantize_tree_int8/int4, or keep "
                "the adapter attached (attach_lora applies it at run time)"
            )
        flat[mpath + ("weight",)] = _merged_weight(
            flat[mpath + ("weight",)], lflat[mpath + ("lora_A",)], lflat[mpath + ("lora_B",)]
        )
    return unflatten_dict(flat)


def lora_param_count(lora_tree) -> int:
    return sum(int(leaf.numel()) for leaf in flatten_dict(lora_tree).values())
