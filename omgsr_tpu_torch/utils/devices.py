"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``. A CUDA
request on a host without a CUDA device raises: nothing runs on the CPU
unless the caller asked for it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the host"
        )
    return device


def tree_to(tree, device=None, dtype=None):
    """Move (and optionally cast) every tensor of a nested-dict parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)
