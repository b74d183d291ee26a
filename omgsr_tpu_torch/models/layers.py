"""Shared neural-net primitives: pure apply functions over parameter trees.

Parameters are nested dicts of tensors whose key paths mirror the HF
checkpoint structure; leaves are in torch layout (conv ``weight`` OIHW, dense
``weight`` (out, in), norm ``weight``/``bias``; see convert/params.py).
Activations are NHWC at every public function, like the JAX package. Inside
``conv2d`` the NHWC tensor is permuted to NCHW, which is a ``channels_last``
view and copies nothing.

Numerical conventions (GroupNorm eps 1e-6 in the VAE / 1e-5 in the UNet,
GELU exact vs tanh, ...) are arguments, set by each model's config.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from omgsr_tpu_torch.ops.fused_groupnorm import fused_group_norm_silu


def dense(p, x):
    return F.linear(x, p["weight"], p.get("bias"))


def _same_padding(size: int, k: int, stride: int):
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x, stride: int | tuple = 1, padding="SAME"):
    """NHWC conv. padding: "SAME", "VALID", int, or ((t,b),(l,r))."""
    if isinstance(stride, int):
        stride = (stride, stride)
    w = p["weight"]
    if padding == "VALID":
        padding = ((0, 0), (0, 0))
    elif padding == "SAME":
        padding = (
            _same_padding(x.shape[1], w.shape[2], stride[0]),
            _same_padding(x.shape[2], w.shape[3], stride[1]),
        )
    elif isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    (pt, pb), (pl, pr) = padding
    xc = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC tensor
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = 0
    y = F.conv2d(xc, w, p.get("bias"), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def group_norm(p, x, num_groups: int = 32, eps: float = 1e-6):
    """GroupNorm over NHWC, statistics in fp32."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h, w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xn * p["weight"].float() + p["bias"].float()).to(x.dtype)


def group_norm_silu(p, x, num_groups: int = 32, eps: float = 1e-6):
    """GroupNorm followed by SiLU: the seat of the fused GroupNorm+SiLU
    kernels. On a CUDA tensor it always goes through them; a CPU tensor takes
    their plain version."""
    return fused_group_norm_silu(x, p["weight"], p["bias"], num_groups, eps)


def layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm over the last axis (statistics in fp32 inside the op, result
    in x's dtype); p may be None (no affine) or lack a bias."""
    weight = None if p is None else p["weight"]
    bias = None if p is None else p.get("bias")
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def silu(x):
    return F.silu(x)


def gelu(x, approximate: bool = False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding with diffusers' get_timestep_embedding
    semantics; timesteps (B,) -> (B, dim) f32 on the timesteps' device."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin], dim=-1) if flip_sin_to_cos else torch.cat([sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def nearest_upsample_2x(x):
    """Nearest-neighbor 2x upsample on NHWC (diffusers Upsample2D interpolate)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
    return y.permute(0, 2, 3, 1)


def upsample_conv_2x(p, x):
    """nearest_upsample_2x followed by a 3x3 SAME conv (diffusers Upsample2D)."""
    return conv2d(p, nearest_upsample_2x(x), padding=1)


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())
