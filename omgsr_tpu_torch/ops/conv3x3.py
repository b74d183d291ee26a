"""3x3 SAME convolutions with fused epilogues and the fused VAE resblock:
hand-written CUDA kernels, their wrappers and the plain PyTorch versions.

Source note. ``conv3x3`` replaces the Pallas TPU kernel
``omgsr_tpu/ops/conv3x3.py:_kernel`` (reached through ``conv3x3_pallas``) and
``conv3x3_gn_fused`` replaces ``:_kernel_rb`` (reached through
``conv3x3_gn_fused``); ``fused_resblock`` chains two of the latter as the JAX
package does. On an H100 both are bound by operations (2 * 9 * C_in * C_out
flops per pixel against C_in + C_out elements moved). Nothing is padded in
device memory: the ring is masked where the halo is staged, after the
GroupNorm+SiLU prologue. The per-channel sums of the output are written as
one row per pixel tile and folded in a fixed order: no atomics, the same bits
on every run.

``csrc/conv3x3.cu`` holds the kernels. In bf16 both functions (the plain
conv K4 and the resblock half K5) are one implicit GEMM on Hopper's
``wgmma``: a persistent block owns 4 or 2 output rows (K5:
``gn_fused_tile_rows``; K4: ``CONV_TILE_ROWS``) x 64 columns x 128 output
channels at a time; TMA brings each chunk of 64 input channels of the
tile's halo (its zero fill outside the image is the padding) and the
weights of each (chunk, tap) through a ring of shared-memory stages, and two
warp groups run the nine shifted products. In K5 a third warp group applies
the prologue once per staged element; K4 has none and adds the bias and the
optional SiLU in its epilogue. In f32 both functions run as FMAs.
``fold_gn_sums`` turns the streamed sums into the next GroupNorm's (scale,
shift) in one launch.

Activations are NHWC at batch 1. Weights are the port's conv leaves, OIHW in
channels_last memory, which is the layout the kernels read (for each tap the
C_in values of an output channel are contiguous), so a weight of the
parameter trees is handed over as it is; any other weight is converted once
and kept (``kernel_weight``).
"""

from __future__ import annotations

import ctypes
import threading
import weakref

import torch
import torch.nn.functional as F

from omgsr_tpu_torch.models.layers import conv2d
from omgsr_tpu_torch.ops.flash_attention import sm_count
from omgsr_tpu_torch.ops.fused_groupnorm import group_norm_stats
from omgsr_tpu_torch.ops.kernel_build import (
    LaunchCounter,
    launch_kernel,
    load_kernel_library,
    plain_route_active,
)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_ACTS = {"none": 0, "silu": 1}
CHANNEL_MULTIPLE = 128

# the bf16 conv kernel's pixel tile: rows x 64 columns; a 2-row tile costs this
# much more per row than a 4-row one (its weight tiles serve half the pixels;
# check_conv3x3's sweep of the resblock half on an H100 SXM: 1.28-1.32 where
# both fill whole waves)
GN_TILE_COLS = 64
_TWO_ROW_COST = 1.3
# the bf16 plain conv's tile height at every shape: without a prologue, the 2-row
# tile's finer waves and deeper weight ring (8 slots against 5) beat the 4-row tile's
# reuse of each weight tile (check_conv3x3's sweep on an H100 SXM: 0.95-1.01 of the
# 4-row time at every bf16 row of CONV_SHAPES)
CONV_TILE_ROWS = 2

conv3x3_launches = LaunchCounter("conv3x3")
gn_fused_launches = LaunchCounter("conv3x3_gn_fused")
fold_launches = LaunchCounter("conv3x3_fold_sums")


def _wide(t):
    """t in the type the sums are taken in: f32, or f64 for f64 input."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------


def _conv_wide(x, w, b):
    """conv3x3(x) + b with x, w and b rounded to x's type and the sum taken wide."""
    xc = _wide(x).permute(0, 3, 1, 2)
    y = F.conv2d(xc, _wide(w.to(x.dtype)), _wide(b.to(x.dtype)), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_plain(x, w, b, act: str = "none"):
    """x (B, H, W, C_in) NHWC, w (C_out, C_in, 3, 3), b (C_out,): SAME
    padding, stride 1, f32 accumulation, bias and the optional SiLU in f32,
    one rounding to x's type. The same function as the kernel, used for CPU
    tensors, by the tests, and as the comparison on the card."""
    y = _conv_wide(x, w, b)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _gn_fused_plain(x, w, b, gn_scale, gn_shift, skip, emit_stats):
    """(y, sums (2, 1, C_out) or None): see ``conv3x3_gn_fused_plain``."""
    h = _wide(x) * _wide(gn_scale) + _wide(gn_shift)
    xa = (h * torch.sigmoid(h)).to(x.dtype)
    y = _conv_wide(xa, w, b)
    if skip is not None:
        y = y + _wide(skip)
    if not emit_stats:
        return y.to(x.dtype), None
    return y.to(x.dtype), torch.stack([y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2))])[:, None]


def _unpack(y, sums):
    return (y, None, None) if sums is None else (y, sums[0], sums[1])


def conv3x3_gn_fused_plain(x, w, b, gn_scale, gn_shift, skip=None, emit_stats: bool = True):
    """y = conv3x3(silu(x * gn_scale + gn_shift)) + b [+ skip] in tensor code:
    the activation in f32 and rounded to x's type before the product, the
    zero padding applied after it, the sums over the f32 y before it is
    rounded. Returns (y, ssum (1, C_out), ssq (1, C_out)), or (y, None, None)
    without ``emit_stats``."""
    return _unpack(*_gn_fused_plain(x, w, b, gn_scale, gn_shift, skip, emit_stats))


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------


def _library():
    lib = load_kernel_library("conv3x3")
    if not lib.conv3x3.argtypes:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3.argtypes = [vp] * 4 + [i] * 7 + [vp]
        lib.conv3x3.restype = i
        lib.conv3x3_gn_fused.argtypes = [vp] * 8 + [i] * 7 + [vp]
        lib.conv3x3_gn_fused.restype = i
        lib.conv3x3_partials.argtypes = [i] * 4
        lib.conv3x3_partials.restype = i
        lib.conv3x3_fold_sums.argtypes = [vp] * 5 + [i] * 4 + [ctypes.c_double, ctypes.c_float, vp]
        lib.conv3x3_fold_sums.restype = i
    return lib


def gn_fused_tile_rows(h: int, w: int, cout: int, sms: int) -> int:
    """Output rows of a tile of the bf16 resblock kernel on a card of ``sms``
    SMs: 4 (two 64-pixel rows for each consumer warp group, so each staged
    weight tile serves 256 pixels) or 2 (one row each, twice the blocks). The
    one whose waves of blocks (one block an SM) times the rows a block owns,
    a 2-row block weighted ``_TWO_ROW_COST`` per row, is least: 2 where 4-row
    tiles would leave SMs idle (the 64 x 64 mid blocks at 512 px), else 4."""
    n = -(-cout // 128) * -(-w // GN_TILE_COLS)

    def cost(rows, per_row):
        return -(-n * -(-h // rows) // sms) * rows * per_row

    return 4 if cost(4, 1.0) <= cost(2, _TWO_ROW_COST) else 2


class _KernelWeights:
    """Kernel-ready copies of the conv weights that do not already lie as the
    kernels read them, made once per weight tensor and dropped with it."""

    def __init__(self):
        self._entries = {}
        self._lock = threading.Lock()

    def get(self, w, dtype):
        if w.dtype == dtype and w.is_contiguous(memory_format=torch.channels_last) \
                and w.data_ptr() % 16 == 0:
            return w
        key = (id(w), dtype)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0]() is w and entry[1] == w._version:
                return entry[2]
            ready = w.detach().to(dtype).contiguous(memory_format=torch.channels_last)
            if ready.data_ptr() % 16:
                ready = ready.clone(memory_format=torch.channels_last)
            ref = weakref.ref(w, lambda _, key=key: self._entries.pop(key, None))
            self._entries[key] = (ref, w._version, ready)
            return ready


_kernel_weights = _KernelWeights()


def kernel_weight(w, dtype):
    """w (C_out, C_in, 3, 3) as the kernels read it: ``dtype``, channels_last
    memory (C_out, 3, 3, C_in). The leaves of the port's parameter trees come
    back as they are; anything else is converted on its first use and the
    copy is reused until the weight is changed or freed."""
    return _kernel_weights.get(w, dtype)


def _check(x, w, b):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"expected x (B,H,W,C) and w (O,I,3,3), got {tuple(x.shape)}, {tuple(w.shape)}")
    cout, cin = w.shape[:2]
    if x.shape[-1] != cin or b.shape != (cout,):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and b {tuple(b.shape)} do not fit")
    return cin, cout


def _check_kernel(x, w, b, others=()):
    """What the kernels take, beyond ``_check``; raises otherwise."""
    cin, cout = w.shape[1], w.shape[0]
    if x.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"conv3x3 kernels take bf16/f32, got {x.dtype}")
    if x.shape[0] != 1:
        raise NotImplementedError(f"conv3x3 kernels take batch 1, got {x.shape[0]}")
    if cin % CHANNEL_MULTIPLE or cout % CHANNEL_MULTIPLE:
        raise ValueError(f"conv3x3 kernels need C_in and C_out multiples of {CHANNEL_MULTIPLE}, "
                         f"got {cin} -> {cout}")
    if min(x.shape[1], x.shape[2]) < 1:
        raise ValueError(f"empty image {tuple(x.shape)}")
    for t in (w, b, *others):
        if t.device != x.device:
            raise ValueError("every operand must lie on x's CUDA device")


def _kernel_input(x):
    """Contiguous NHWC, aligned for 16-byte vectors."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def conv3x3(x, w, b, act: str = "none"):
    """x (1, H, W, C_in) NHWC, w (C_out, C_in, 3, 3), b (C_out,): SAME padding,
    stride 1, bias and optional SiLU (``act`` "none" | "silu") fused. On a CUDA
    tensor this launches the kernel or raises (C_in and C_out multiples of
    128, batch 1, bf16 or f32); the plain version runs only for CPU tensors."""
    _check(x, w, b)
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    if not x.is_cuda or plain_route_active():
        return conv3x3_plain(x, w, b, act)
    _check_kernel(x, w, b)
    x = _kernel_input(x)
    _, h, width, cin = x.shape
    cout = w.shape[0]
    wk, bk = kernel_weight(w, x.dtype), _kernel_input(b.to(x.dtype))
    y = torch.empty((1, h, width, cout), dtype=x.dtype, device=x.device)
    rows = CONV_TILE_ROWS if x.dtype == torch.bfloat16 else 0
    launch_kernel(_library().conv3x3, "conv3x3", x.device,
                  x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
                  _DTYPE_CODE[x.dtype], _ACTS[act], h, width, cin, cout, rows)
    conv3x3_launches.add()
    return y


def conv3x3_gn_fused(x, w, b, gn_scale, gn_shift, skip=None, emit_stats: bool = True):
    """Fused resblock half: y = conv3x3(silu(x * gn_scale + gn_shift)) + b
    [+ skip], and per-partial per-channel (sum, sum of squares) of the f32 y
    for the next GroupNorm's statistics.

    gn_scale / gn_shift (C_in,) fold the GroupNorm: scale = gamma * rsqrt(var
    + eps), shift = beta - mean * scale. The zero padding is applied to the
    activated tensor, as in the graph GN -> SiLU -> pad -> conv. Shapes as
    ``conv3x3``; skip (1, H, W, C_out) optional.

    Returns (y, ssum, ssq) with ssum, ssq (n_partials, C_out) f32 whose sum
    over axis 0 is the channel sum (n_partials is the kernel's own: one row
    per tile on the card, one on the CPU), or (y, None, None) without
    ``emit_stats``. On a CUDA tensor this launches the kernel or raises."""
    return _unpack(*_gn_fused(x, w, b, gn_scale, gn_shift, skip, emit_stats))


def _gn_fused(x, w, b, gn_scale, gn_shift, skip, emit_stats):
    """``conv3x3_gn_fused`` with the sums as the kernel writes them: one
    (2, n_partials, C_out) buffer, or None."""
    cin, cout = _check(x, w, b)
    if gn_scale.shape != (cin,) or gn_shift.shape != (cin,):
        raise ValueError(f"gn_scale / gn_shift must be ({cin},), got {tuple(gn_scale.shape)}, "
                         f"{tuple(gn_shift.shape)}")
    if skip is not None and skip.shape != (*x.shape[:3], cout):
        raise ValueError(f"skip {tuple(skip.shape)} does not fit the output {(*x.shape[:3], cout)}")
    if not x.is_cuda or plain_route_active():
        return _gn_fused_plain(x, w, b, gn_scale, gn_shift, skip, emit_stats)
    _check_kernel(x, w, b, (gn_scale, gn_shift) if skip is None else (gn_scale, gn_shift, skip))
    if skip is not None and skip.dtype != x.dtype:
        raise NotImplementedError(f"skip must share x's dtype {x.dtype}, got {skip.dtype}")
    x = _kernel_input(x)
    _, h, width, _ = x.shape
    wk, bk = kernel_weight(w, x.dtype), _kernel_input(b.to(x.dtype))
    a, c = _kernel_input(gn_scale.float()), _kernel_input(gn_shift.float())
    skip = None if skip is None else _kernel_input(skip)
    lib = _library()
    y = torch.empty((1, h, width, cout), dtype=x.dtype, device=x.device)
    rows = gn_fused_tile_rows(h, width, cout, sm_count(x.device)) if x.dtype == torch.bfloat16 else 0
    n_partials = lib.conv3x3_partials(_DTYPE_CODE[x.dtype], h, width, rows)
    sums = torch.empty((2, n_partials, cout), dtype=torch.float32, device=x.device) if emit_stats else None
    launch_kernel(lib.conv3x3_gn_fused, "conv3x3_gn_fused", x.device,
                  x.data_ptr(), wk.data_ptr(), bk.data_ptr(), a.data_ptr(), c.data_ptr(),
                  None if skip is None else skip.data_ptr(), y.data_ptr(),
                  None if sums is None else sums.data_ptr(),
                  _DTYPE_CODE[x.dtype], h, width, cin, cout, n_partials, rows)
    gn_fused_launches.add()
    return y, sums


# ----------------------------------------------------------------------------
# the fused resblock
# ----------------------------------------------------------------------------


def _affine_from_group_sums(sums, count: int, per: int, gamma, beta, eps):
    """sums (2, G): each group's (sum, sum of squares) over ``count`` elements
    -> the per-channel (scale, shift) of the folded GroupNorm, in f32 (f64
    kept): var = max(E[x^2] - mean^2, 0). Written with few launches: on the
    card every line is a kernel of a few hundred elements."""
    moments = sums / count
    mean = moments[0]
    var = torch.addcmul(moments[1], mean, mean, value=-1).clamp_(min=0.0)
    rstd = var.add_(eps).rsqrt_()
    scale = _wide(gamma).view(-1, per) * rstd[:, None]
    shift = torch.addcmul(_wide(beta).view(-1, per), mean[:, None], scale, value=-1)
    return scale.reshape(-1), shift.reshape(-1)


def _affine_from_stacked_sums(sums, hw: int, groups: int, gamma, beta, eps):
    """sums (2, n_partials, C) as ``_gn_fused`` returns them. The plain version
    of ``fold_gn_sums``."""
    per = sums.shape[-1] // groups
    group_sums = sums.view(2, sums.shape[1], groups, per).sum(dim=(1, 3))
    return _affine_from_group_sums(group_sums, hw * per, per, gamma, beta, eps)


def fold_gn_sums(sums, hw: int, groups: int, gamma, beta, eps: float = 1e-6):
    """The next GroupNorm's per-channel (scale, shift) from the streamed sums
    (2, n_partials, C) of ``_gn_fused``: group mean and var = E[x^2] - mean^2
    (clamped at 0) over ``hw`` pixels x C / groups channels, scale = gamma *
    rsqrt(var + eps), shift = beta - mean * scale, f32. On a CUDA tensor this
    launches the fold kernel (one launch) or raises; the plain version
    (``_affine_from_stacked_sums``, a dozen tensor ops) runs for CPU tensors."""
    c = sums.shape[-1]
    if sums.dim() != 3 or sums.shape[0] != 2 or c % groups or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"sums {tuple(sums.shape)}, gamma {tuple(gamma.shape)}, beta {tuple(beta.shape)} "
                         f"and {groups} groups do not fit")
    if not sums.is_cuda or plain_route_active():
        return _affine_from_stacked_sums(sums, hw, groups, gamma, beta, eps)
    if sums.dtype != torch.float32 or gamma.dtype != beta.dtype or gamma.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"the fold kernel takes f32 sums and bf16/f32 gamma and beta, got "
                                  f"{sums.dtype}, {gamma.dtype}, {beta.dtype}")
    if gamma.device != sums.device or beta.device != sums.device:
        raise ValueError("sums, gamma and beta must lie on one CUDA device")
    sums, gamma, beta = sums.contiguous(), gamma.contiguous(), beta.contiguous()
    scale = torch.empty(c, dtype=torch.float32, device=sums.device)
    shift = torch.empty(c, dtype=torch.float32, device=sums.device)
    launch_kernel(_library().conv3x3_fold_sums, "conv3x3_fold_sums", sums.device,
                  sums.data_ptr(), gamma.data_ptr(), beta.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                  _DTYPE_CODE[gamma.dtype], sums.shape[1], c, groups, float(hw * (c // groups)), float(eps))
    fold_launches.add()
    return scale, shift


def gn_affine_from_channel_sums(ssum, ssq, hw: int, groups: int, gamma, beta, eps: float = 1e-6):
    """Fold streamed per-channel (sum, sum of squares) partials (n, C) into
    the next conv's prologue affine: group mean / var (E[x^2] - mean^2,
    clamped at 0, f32), then per channel scale = gamma * rsqrt(var + eps),
    shift = beta - mean * scale."""
    return _affine_from_stacked_sums(torch.stack([ssum, ssq]), hw, groups, gamma, beta, eps)


def fused_resblock(p, x, groups: int, eps: float = 1e-6):
    """A whole VAE resblock through the fused conv: GroupNorm 1's group sums
    by the GroupNorm stats kernel over the input (its plain version on the
    CPU; no f32 copy of x is made), conv1 with the folded GN+SiLU prologue
    streaming GroupNorm 2's channel sums out, folded into GN2's affine in one
    launch (``fold_gn_sums``), conv2 with the folded GN2 prologue and the skip
    add (``conv_shortcut`` is a 1x1 ``conv2d`` when present). Inference only
    (the kernels have no backward).

    GroupNorm 2's statistics are E[x^2] - mean^2 over conv1's f32 accumulator,
    before the stored tensor is rounded."""
    _, h, width, cin = x.shape
    per = cin // groups
    sums0 = group_norm_stats(x, groups)[0].sum(dim=0).t()  # (nchunks, G, 2) -> (2, G)
    scale1, shift1 = _affine_from_group_sums(
        sums0, h * width * per, per, p["norm1"]["weight"], p["norm1"]["bias"], eps)
    h1, sums1 = _gn_fused(x, p["conv1"]["weight"], p["conv1"]["bias"], scale1, shift1, None, True)
    scale2, shift2 = fold_gn_sums(sums1, h * width, groups, p["norm2"]["weight"], p["norm2"]["bias"], eps)
    skip = conv2d(p["conv_shortcut"], x, padding=0) if "conv_shortcut" in p else x
    return _gn_fused(h1, p["conv2"]["weight"], p["conv2"]["bias"], scale2, shift2, skip, False)[0]


def fused_resblock_eligible(p, x, groups: int) -> bool:
    """Whether ``fused_resblock`` takes this resnet: batch 1, C_in and C_out
    multiples of 128 (the kernels' channel tiles) and of the group count, no
    LoRA branch on its 3x3 convs (the kernels compute the base conv only),
    and no gradient asked of it (the kernels have no backward; the unfused
    resnet differentiates). Any H and W will do: the kernels mask ragged
    tiles. The dtype is not part of it: a type the kernels do not take raises
    in the wrapper on the card."""
    b, _, _, cin = x.shape
    cout = p["conv1"]["weight"].shape[0]
    return (
        b == 1
        and cin % CHANNEL_MULTIPLE == 0
        and cout % CHANNEL_MULTIPLE == 0
        and cin % groups == 0
        and cout % groups == 0
        and "lora_A" not in p["conv1"]
        and "lora_A" not in p["conv2"]
        and not (torch.is_grad_enabled() and x.requires_grad)
    )
