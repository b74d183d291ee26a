"""Shared neural-net primitives: pure apply functions over parameter trees.

Parameters are nested dicts of tensors whose key paths mirror the HF
checkpoint structure; leaves are in torch layout (conv ``weight`` OIHW, dense
``weight`` (out, in), norm ``weight``/``bias``; see convert/params.py).
Activations are NHWC at every public function, like the JAX package. Inside
``conv2d`` the NHWC tensor is permuted to NCHW, which is a ``channels_last``
view and copies nothing.

Numerical conventions (GroupNorm eps 1e-6 in the VAE / 1e-5 in the UNet,
GELU exact vs tanh, ...) are arguments, set by each model's config.

Each parameter is cast to the activation's dtype at the call, as the JAX
package does (``.to`` is a no-op where the dtypes agree), so a tree of f32
master parameters runs bf16 activations in bf16 with f32 gradients.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from omgsr_tpu_torch.ops.fused_groupnorm import fused_group_norm_silu
from omgsr_tpu_torch.utils.quantize import dequantize_weight


class _QuantizedLinear(torch.autograd.Function):
    """x @ W^T with W dequantised from its codes at the call. The backward
    saves the codes, not W, and dequantises again: a frozen quantised base
    keeps no float copy of its weights for the input gradient, with or
    without recompute."""

    @staticmethod
    def forward(ctx, x, p, bias=None):
        ctx.p = p
        return F.linear(x, dequantize_weight(p, x.dtype), bias)

    @staticmethod
    def backward(ctx, gy):
        return gy @ dequantize_weight(ctx.p, gy.dtype), None, None


def _dense_w8a8(p, x, tp=None):
    """The w8a8 route (inference only): x quantised per token (absmax / 127,
    rounded to int8), an s8 x s8 -> s32 product with the stored codes, both
    scales applied in f32, cast to x's dtype. On the card ``torch._int_mm``
    needs more than 16 rows (fewer are padded with zero rows, which is exact)
    and K, N multiples of 8. Row-parallel (``tp``, see ``dense``): the
    absmax is the maximum over the group, so every rank quantises with the
    same per-token scale, and the s32 products are summed over the group
    before the scales: the same numbers as on one rank."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("the w8a8 route is inference-only: train on a weight-only quantised base")
    wq = p["weight_q"]
    n, k = wq.shape
    x32 = x.float()
    m = x32.abs().amax(dim=-1, keepdim=True)
    if tp is not None:
        m = tp.tp_max(m)
    m = m.clamp_min(1e-6) / 127.0
    qx = torch.round(x32 / m).to(torch.int8).reshape(-1, k)  # |x| / m <= 127 by construction
    rows = qx.shape[0]
    if qx.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"w8a8 on CUDA needs K and N multiples of 8: x {tuple(x.shape)}, weight_q {(n, k)}")
        if rows <= 16:
            qx = F.pad(qx, (0, 0, 0, 17 - rows))
    y = torch._int_mm(qx, wq.t())[:rows]
    if tp is not None:
        y = tp.tp_sum(y.contiguous())
    return (y.reshape(*x.shape[:-1], n).float() * m * p["weight_scale"]).to(x.dtype)


def dense(p, x, tp=None):
    """x @ weight^T [+ (x @ A^T) @ B^T] [+ bias]; the low-rank term (scaling
    1.0, alpha == rank; see lora/lora.py) is added when the module dict
    carries ``lora_A`` (r, in) and ``lora_B`` (out, r). A quantised module
    (``weight_q`` / ``weight_q4`` with ``weight_scale``; utils/quantize.py)
    dequantises to x's dtype at the call, or with an ``act_quant`` marker
    takes the w8a8 route.

    ``tp`` (a ``parallel.sharding.Sharding``) makes the product
    row-parallel: x holds this rank's slice of the contraction and p the
    matching input columns; the partial products are summed over the
    tensor-parallel group. The bias enters the product of the group's first
    rank only, so the sum holds it once and one rank computes what ``dense``
    computes without ``tp``."""
    if tp is not None and "lora_A" in p:
        raise ValueError("row-parallel products take merged weights, not LoRA branches")
    lora = "lora_A" in p
    if "act_quant" in p:
        y = _dense_w8a8(p, x, tp)  # under tp summed over the group before the scales
    else:
        # the bias goes into the product when there is no low-rank term; under tp on the first rank only
        bias = None if lora or (tp is not None and tp.tp_rank != 0) else p.get("bias")
        if bias is not None:
            bias = bias.to(x.dtype)
        y = F.linear(x, p["weight"].to(x.dtype), bias) if "weight" in p else _QuantizedLinear.apply(x, p, bias)
        if tp is not None:
            return tp.tp_sum(y)
        if not lora:
            return y
    if lora:
        y = y + F.linear(F.linear(x, p["lora_A"].to(x.dtype)), p["lora_B"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _same_padding(size: int, k: int, stride: int):
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x, stride: int | tuple = 1, padding="SAME", groups: int = 1):
    """NHWC conv. padding: "SAME", "VALID", int, or ((t,b),(l,r)). With
    ``lora_A`` (r, in, kh, kw) and ``lora_B`` (out, r, 1, 1) in the module
    dict, the low-rank term is a conv with A at the base geometry followed by
    a 1x1 conv with B (peft's Conv2d LoRA)."""
    if isinstance(stride, int):
        stride = (stride, stride)
    w = p["weight"].to(x.dtype)
    bias = p.get("bias")
    if bias is not None:
        bias = bias.to(x.dtype)
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
    if "lora_A" not in p:
        y = F.conv2d(xc, w, bias, stride=stride, padding=pad, groups=groups)
        return y.permute(0, 2, 3, 1)
    y = F.conv2d(xc, w, stride=stride, padding=pad, groups=groups)
    h = F.conv2d(xc, p["lora_A"].to(x.dtype), stride=stride, padding=pad, groups=groups)
    y = y + F.conv2d(h, p["lora_B"].to(x.dtype))
    if bias is not None:
        y = y + bias[None, :, None, None]
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(p, x, padding):
    """Depthwise NHWC conv; weight (C, 1, kh, kw)."""
    return conv2d(p, x, padding=padding, groups=x.shape[-1])


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
    """LayerNorm over the last axis, statistics and affine in fp32, result in
    x's dtype; p may be None (no affine) or lack a bias. Where the affine's
    dtype is x's, the op itself widens it; where it is not (f32 masters
    beside bf16 activations), x is widened and the f32 result rounded once."""
    weight = None if p is None else p["weight"]
    bias = None if p is None else p.get("bias")
    if any(t is not None and t.dtype != x.dtype for t in (weight, bias)):
        return F.layer_norm(x.float(), (x.shape[-1],), None if weight is None else weight.float(),
                            None if bias is None else bias.float(), eps).to(x.dtype)
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def rms_norm(p, x, eps: float = 1e-6):
    """RMSNorm over the last axis: statistics in fp32, a scale (``weight``)
    only, result in x's dtype."""
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps) * p["weight"].float()).to(x.dtype)


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
    """nearest_upsample_2x followed by a 3x3 SAME conv (diffusers Upsample2D);
    a LoRA-adapted upsampler ("conv" is a LoRA target) goes the same way."""
    return conv2d(p, nearest_upsample_2x(x), padding=1)


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())
