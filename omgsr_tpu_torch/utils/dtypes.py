"""Dtype policy helpers: names used by the CLIs -> torch dtypes."""

import torch

DTYPE_MAP = {
    "no": torch.float32,  # accelerate's --mixed_precision=no
    "fp32": torch.float32,
    "float32": torch.float32,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
}


def resolve_dtype(name):
    if isinstance(name, str):
        return DTYPE_MAP[name]
    return name
