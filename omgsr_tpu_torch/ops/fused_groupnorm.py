"""Fused GroupNorm(+SiLU) over NHWC: two hand-written CUDA kernels (stats,
apply), their wrapper and the plain PyTorch version.

Source note. ``fused_group_norm_silu`` replaces the Pallas TPU kernels
``omgsr_tpu/ops/fused_groupnorm.py:_stats_kernel`` and ``:_apply_kernel``
(reached through ``fused_group_norm_silu``). On an H100 the function is
bound by device-memory bytes: x is read twice and y written once, with no
matrix product. The kernels (``csrc/group_norm_silu.cu``) move 16-byte
vectors, give every thread one vector of neighbouring channels for the whole
kernel (its group, and in the apply kernel its folded scale and shift, stay
in registers), cut the rows into enough chunks to fill the card, and replace
the TPU's sequential accumulating grid axis by per-chunk partial sums that
the apply kernel adds in a fixed order. There are no atomics: the same input
gives the same bits on every run.

Under autograd ``fused_group_norm_silu`` is a ``torch.autograd.Function``: the
forward launches the two kernels as above and saves x, the partial sums and
the affine parameters; the backward is explicit f32 tensor code from those
(``group_norm_silu_bwd``), not a kernel: the JAX package trains through its
plain ``group_norm`` and has no backward kernel to port.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from omgsr_tpu_torch.ops.kernel_build import (
    LaunchCounter,
    launch_kernel,
    load_kernel_library,
    plain_route_active,
)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

stats_launches = LaunchCounter("group_norm_stats")
apply_launches = LaunchCounter("group_norm_apply")


def _wide(t):
    """t in the type the sums are taken in: f32, or f64 for f64 input."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def group_norm_silu_plain(x, weight, bias, groups: int = 32, eps: float = 1e-6, apply_silu: bool = True):
    """x (B, H, W, C) -> [silu](group_norm(x)), statistics in f32 over H, W
    and the group's channels, result in x's dtype. The same function as the
    kernels, used for CPU tensors, by the tests, and as the comparison on
    the card."""
    b, h, w, c = x.shape
    xg = _wide(x).reshape(b, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = xn * _wide(weight) + _wide(bias)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_stats_plain(x, groups: int = 32):
    """x (B, H, W, C) -> (B, 1, G, 2) f32: per group the sum and the sum of
    squares over H, W and the group's channels (one chunk holding all rows)."""
    b, h, w, c = x.shape
    xg = _wide(x).reshape(b, h * w, groups, c // groups)
    return torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))], dim=-1)[:, None]


def _library():
    lib = load_kernel_library("group_norm_silu")
    stats, apply = lib.group_norm_stats, lib.group_norm_apply
    if not stats.argtypes:
        vp, i = ctypes.c_void_p, ctypes.c_int
        stats.argtypes = [vp, vp] + [i] * 10 + [vp]
        stats.restype = ctypes.c_int
        apply.argtypes = [vp, vp, vp, vp, i, vp] + [i] * 10 + [ctypes.c_float, i, vp]
        apply.restype = ctypes.c_int
    return stats, apply


def _widest_vec(n: int, elem_size: int) -> int:
    vec = 16 // elem_size
    while vec > 1 and n % vec:
        vec //= 2
    return vec


def _cut_rows(rows: int, batch: int, max_blocks: int, min_rows: int):
    chunk_rows = max(-(-rows * batch // max_blocks), min_rows, 1)
    return chunk_rows, -(-rows // chunk_rows)


class Geometry(NamedTuple):
    chunk_rows: int
    nchunks: int
    vec: int
    gpb: int
    k: int
    apply_vec: int
    cvb: int
    apply_k: int
    apply_chunk_rows: int


@functools.lru_cache(maxsize=256)
def launch_geometry(rows: int, channels: int, groups: int, elem_size: int, batch: int = 1) -> Geometry:
    """The launch shapes of one call.

    A block is (channel vectors) x (k rows) and walks over its chunk of
    rows; a chunk moves at least 16 KB.
    stats: ``vec`` is the widest vector (up to 16 bytes) inside one group, a
    block covers ``gpb`` whole groups by ``k`` rows (up to 1024 threads),
    and the rows are cut into ``nchunks`` chunks of ``chunk_rows``, at most
    about 256 over the batch: every apply block adds up all partials of its
    batch element, so their number is kept small.
    apply: ``apply_vec`` is the widest vector dividing the channel count, a
    block covers ``cvb`` of them by ``apply_k`` rows (about 256 threads) over
    ``apply_chunk_rows`` rows, at most about 512 blocks over the batch."""
    cg = channels // groups
    min_rows = -(-16384 // (channels * elem_size))
    chunk_rows, nchunks = _cut_rows(rows, batch, 256, min_rows)
    vec = _widest_vec(cg, elem_size)
    w = cg // vec
    if w > 1024:
        raise NotImplementedError(f"group width {cg} is beyond the stats kernel's block")
    gpb = min(groups, max(1, 1024 // w)) if groups * w > 1024 else groups
    k = max(1, min(1024 // (gpb * w), chunk_rows))
    apply_vec = _widest_vec(channels, elem_size)
    cv = channels // apply_vec
    cvb = cv if cv <= 512 else 256
    apply_chunk_rows, _ = _cut_rows(rows, batch, 512, min_rows)
    return Geometry(chunk_rows, nchunks, vec, gpb, k, apply_vec, cvb, max(1, 256 // cvb),
                    apply_chunk_rows)


def _check(x, groups):
    if x.dim() != 4:
        raise ValueError(f"expected NHWC (B,H,W,C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if x.is_cuda and not plain_route_active():
        if x.dtype not in _DTYPE_CODE:
            raise NotImplementedError(f"group_norm kernels take bf16/f32, got {x.dtype}")
        if min(b, h * w) < 1 or b > 65535:
            raise ValueError(f"unsupported batch/rows: {tuple(x.shape)}")


def _kernel_input(x):
    """Contiguous NHWC, aligned for 16-byte vectors."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _prepare(x, groups):
    """Checked kernel input and its launch geometry."""
    _check(x, groups)
    x = _kernel_input(x)
    b, h, w, c = x.shape
    return x, launch_geometry(h * w, c, groups, x.element_size(), b)


def _check_affine(x, weight, bias):
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight/bias must be ({c},), got {tuple(weight.shape)}, {tuple(bias.shape)}")
    if not x.is_cuda or plain_route_active():
        return
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must lie on the same CUDA device")
    if weight.dtype != bias.dtype or weight.dtype not in (x.dtype, torch.float32):
        raise NotImplementedError(
            f"weight/bias must share x's dtype or be f32, got {weight.dtype}, {bias.dtype}"
        )


def _launch_stats(x, geo, groups):
    b, h, w, c = x.shape
    partial = torch.empty((b, geo.nchunks, groups, 2), dtype=torch.float32, device=x.device)
    stats, _ = _library()
    launch_kernel(stats, "group_norm_stats", x.device,
                  x.data_ptr(), partial.data_ptr(), _DTYPE_CODE[x.dtype], geo.vec, b, h * w, c,
                  groups, geo.chunk_rows, geo.nchunks, geo.gpb, geo.k)
    stats_launches.add()
    return partial


def _launch_apply(x, partial, weight, bias, geo, groups, eps, apply_silu):
    b, h, w, c = x.shape
    weight, bias = weight.contiguous(), bias.contiguous()
    y = torch.empty_like(x)
    _, apply = _library()
    launch_kernel(apply, "group_norm_apply", x.device,
                  x.data_ptr(), partial.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  int(weight.dtype == torch.float32 and x.dtype != torch.float32),
                  y.data_ptr(), _DTYPE_CODE[x.dtype], geo.apply_vec, b, h * w, c, groups,
                  geo.nchunks, geo.apply_chunk_rows, geo.cvb, geo.apply_k,
                  float(eps), int(apply_silu))
    apply_launches.add()
    return y


def group_norm_stats(x, groups: int = 32):
    """x (B, H, W, C) -> partial sums (B, nchunks, G, 2) f32: [..., 0] the
    sum and [..., 1] the sum of squares of one chunk of rows, per group.
    Their sum over axis 1 is the statistic. On a CUDA tensor this launches
    the stats kernel or raises; a CPU tensor gives one chunk, computed with
    plain PyTorch."""
    if not x.is_cuda or plain_route_active():
        _check(x, groups)
        return group_norm_stats_plain(x, groups)
    x, geo = _prepare(x, groups)
    return _launch_stats(x, geo, groups)


def group_norm_apply(x, partial, weight, bias, groups: int = 32, eps: float = 1e-6, apply_silu: bool = True):
    """[silu]((x - mean) * rsqrt(var + eps) * weight + bias) in x's dtype,
    with mean and var from the partial sums of ``group_norm_stats`` on the
    same x. On a CUDA tensor this launches the apply kernel or raises."""
    if not x.is_cuda or plain_route_active():
        _check(x, groups)
        _check_affine(x, weight, bias)
        b, h, w, c = x.shape
        n = h * w * (c // groups)
        sums = partial.sum(dim=1)
        mean = sums[..., 0] / n
        var = torch.clamp(sums[..., 1] / n - mean * mean, min=0.0)
        xg = x.float().reshape(b, h * w, groups, c // groups)
        xn = (xg - mean[:, None, :, None]) * torch.rsqrt(var + eps)[:, None, :, None]
        y = xn.reshape(b, h, w, c) * weight.float() + bias.float()
        if apply_silu:
            y = y * torch.sigmoid(y)
        return y.to(x.dtype)
    x, geo = _prepare(x, groups)
    _check_affine(x, weight, bias)
    if (partial.device != x.device or partial.dtype != torch.float32 or not partial.is_contiguous()
            or partial.shape != (x.shape[0], geo.nchunks, groups, 2)):
        raise ValueError(f"partial sums {tuple(partial.shape)} do not belong to this x")
    return _launch_apply(x, partial, weight, bias, geo, groups, eps, apply_silu)


def _forward(x, weight, bias, groups, eps, apply_silu):
    """(y, x as the kernels read it, partial sums): the two kernels on a CUDA
    tensor, else the plain version with one chunk of sums."""
    if not x.is_cuda or plain_route_active():
        _check(x, groups)
        _check_affine(x, weight, bias)
        y = group_norm_silu_plain(x, weight, bias, groups, eps, apply_silu)
        return y, x, None
    x, geo = _prepare(x, groups)
    _check_affine(x, weight, bias)
    partial = _launch_stats(x, geo, groups)
    return _launch_apply(x, partial, weight, bias, geo, groups, eps, apply_silu), x, partial


def group_norm_silu_bwd(x, partial, weight, bias, dy, groups: int = 32, eps: float = 1e-6,
                        apply_silu: bool = True):
    """(dx, dweight, dbias) of ``fused_group_norm_silu`` for the cotangent
    ``dy``, in explicit f32 tensor code from x and the partial sums of
    ``group_norm_stats`` (None: they are computed here). With xh the
    normalised x, z = xh * weight + bias and g = dy * d silu(z)/dz (or dy):
    dbias = sum g, dweight = sum g * xh, and per group
    dx = rstd * (g w - mean(g w) - xh * mean(g w * xh))."""
    b, h, w, c = x.shape
    cg = c // groups
    if partial is None:
        partial = group_norm_stats_plain(x, groups)
    n = h * w * cg
    sums = partial.sum(dim=1)
    mean = (sums[..., 0] / n)[:, None, :, None]
    var = torch.clamp(sums[..., 1] / n - mean[:, 0, :, 0] ** 2, min=0.0)
    rstd = torch.rsqrt(var + eps)[:, None, :, None]
    xh = (_wide(x).reshape(b, h * w, groups, cg) - mean) * rstd
    wf = _wide(weight).reshape(groups, cg)
    g = _wide(dy).reshape(b, h * w, groups, cg)
    if apply_silu:
        z = xh * wf + _wide(bias).reshape(groups, cg)
        sig = torch.sigmoid(z)
        g = g * (sig * (1.0 + z * (1.0 - sig)))
    dbias = g.sum(dim=(0, 1)).reshape(c)
    dweight = (g * xh).sum(dim=(0, 1)).reshape(c)
    gw = g * wf
    m1 = gw.mean(dim=(1, 3), keepdim=True)
    m2 = (gw * xh).mean(dim=(1, 3), keepdim=True)
    dx = (gw - m1 - xh * m2) * rstd
    return dx.reshape(b, h, w, c).to(x.dtype), dweight.to(weight.dtype), dbias.to(bias.dtype)


class _GroupNormSiLU(torch.autograd.Function):
    """Forward: stats kernel + apply kernel (plain version for CPU tensors).
    Backward: ``group_norm_silu_bwd`` from the saved x and partial sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, apply_silu):
        y, xk, partial = _forward(x, weight, bias, groups, eps, apply_silu)
        ctx.save_for_backward(xk, weight, bias, *(() if partial is None else (partial,)))
        ctx.args = (groups, eps, apply_silu)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias, *partial = ctx.saved_tensors
        dx, dw, db = group_norm_silu_bwd(x, partial[0] if partial else None, weight, bias, dy,
                                         *ctx.args)
        return dx, dw, db, None, None, None


def fused_group_norm_silu(x, weight, bias, groups: int = 32, eps: float = 1e-6, apply_silu: bool = True):
    """x (B, H, W, C) -> [silu](group_norm(x)) in x's dtype.

    On a CUDA tensor this launches the two kernels (stats, then apply) or
    raises; the plain version runs only for CPU tensors. Under autograd the
    backward is ``group_norm_silu_bwd``."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _GroupNormSiLU.apply(x, weight, bias, groups, eps, apply_silu)
    return _forward(x, weight, bias, groups, eps, apply_silu)[0]
