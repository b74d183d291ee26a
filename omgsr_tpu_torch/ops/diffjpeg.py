"""DiffJPEG: batched JPEG compression emulation.

Re-implements the reference's DiffJPEG stack (dataset/degradations.py:
885-1364): RGB->YCbCr (ITU-R 601 with the exact matrices, :922-940), 2x2
chroma average-pool subsampling (:946-966), 8x8 block DCT with alpha
scaling (:994-1018), Y/C quantization by the standard tables scaled by the
quality->factor mapping (:905-918), then the inverse path with chroma
nearest upsampling, and pad-to-16 handling (:1322-1364).

Blocks are processed as (B, nb, 8, 8) einsums with the DCT basis as an
(8, 8, 8, 8) table, as in the JAX package, and rounding is hard round to
nearest even (the degradation uses differentiable=False,
dataset/realesrgan.py:98). The tables live on the device once per device.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from omgsr_tpu_torch.utils.devices import host_to_device

# quantization tables (transposed, exactly as the reference stores them,
# dataset/degradations.py:888-898)
_Y_TABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101], [72, 92, 95, 98, 112, 100, 103, 99]],
    dtype=np.float32,
).T

_C_TABLE = np.full((8, 8), 99, np.float32)
_C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]], np.float32
).T

_RGB2YCBCR = np.array(
    [[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5], [0.5, -0.418688, -0.081312]],
    np.float32,
).T
_YCBCR_SHIFT = np.array([0.0, 128.0, 128.0], np.float32)

_YCBCR2RGB = np.array(
    [[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]], np.float32
).T

_DCT = np.zeros((8, 8, 8, 8), np.float32)
for _x, _y, _u, _v in itertools.product(range(8), repeat=4):
    _DCT[_x, _y, _u, _v] = np.cos((2 * _x + 1) * _u * np.pi / 16) * np.cos(
        (2 * _y + 1) * _v * np.pi / 16
    )
_ALPHA = np.array([1.0 / np.sqrt(2)] + [1.0] * 7)
_DCT_SCALE = (np.outer(_ALPHA, _ALPHA) * 0.25).astype(np.float32)

_IDCT = np.zeros((8, 8, 8, 8), np.float32)
for _x, _y, _u, _v in itertools.product(range(8), repeat=4):
    _IDCT[_x, _y, _u, _v] = np.cos((2 * _u + 1) * _x * np.pi / 16) * np.cos(
        (2 * _v + 1) * _y * np.pi / 16
    )
_IDCT_ALPHA = np.outer(_ALPHA, _ALPHA).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    host = {"y": _Y_TABLE, "c": _C_TABLE, "rgb2ycbcr": _RGB2YCBCR, "shift": _YCBCR_SHIFT,
            "ycbcr2rgb": _YCBCR2RGB, "dct": _DCT, "dct_scale": _DCT_SCALE, "idct": _IDCT,
            "idct_alpha": _IDCT_ALPHA}
    return {k: host_to_device(np.ascontiguousarray(v), device) for k, v in host.items()}


def quality_to_factor(quality):
    """quality [1, 100] -> table scaling factor (reference :905-918), in f32:
    a tensor for a tensor, a float for a number."""
    if isinstance(quality, torch.Tensor):
        quality = quality.float()
        return torch.where(quality < 50, 5000.0 / quality, 200.0 - quality * 2.0) / 100.0
    q = np.float32(quality)
    return float((np.float32(5000.0) / q if q < 50 else np.float32(200.0) - q * np.float32(2.0)) / np.float32(100.0))


def _blocks(x):
    """(B, H, W) -> (B, H/8*W/8, 8, 8), row-major block order."""
    b, h, w = x.shape
    x = x.reshape(b, h // 8, 8, w // 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _merge(x, h, w):
    b = x.shape[0]
    x = x.reshape(b, h // 8, w // 8, 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def jpeg_coefficients(img, quality):
    """The compression half of ``diffjpeg``: img (B, H, W, 3) RGB in [0,1]
    -> (y, cb, cr), each block's DCT coefficients over its quantization
    table, before rounding ((B, nb, 8, 8) f32: Y at full size, Cb and Cr
    subsampled 2x2), and the scaled tables (yt, ct)."""
    t = _tables(img.device)
    b, h, w, _ = img.shape
    f = quality_to_factor(quality)
    if isinstance(f, torch.Tensor):
        f = f.expand(b)[:, None, None, None]

    h_pad = (16 - h % 16) % 16
    w_pad = (16 - w % 16) % 16
    x = F.pad(img.float(), (0, 0, 0, w_pad, 0, h_pad))
    hp, wp = h + h_pad, w + w_pad

    def dct(x):
        return t["dct_scale"] * torch.einsum("bnxy,xyuv->bnuv", x - 128.0, t["dct"])

    # to YCbCr
    ycc = torch.einsum("bhwc,ck->bhwk", x * 255.0, t["rgb2ycbcr"]) + t["shift"]
    y = ycc[..., 0]
    # 2x2 average chroma subsample
    cbcr = ycc[..., 1:].reshape(b, hp // 2, 2, wp // 2, 2, 2).mean(dim=(2, 4))
    cb, cr = cbcr[..., 0], cbcr[..., 1]

    yt, ct = t["y"] * f, t["c"] * f
    return (dct(_blocks(y)) / yt, dct(_blocks(cb)) / ct, dct(_blocks(cr)) / ct), (yt, ct)


def jpeg_decode(yq, cbq, crq, tables, h, w, dtype=torch.float32):
    """The decompression half of ``diffjpeg``: the rounded coefficients and
    the tables of ``jpeg_coefficients`` -> the (B, h, w, 3) image in [0,1]."""
    t = _tables(yq.device)
    yt, ct = tables
    hp, wp = h + (16 - h % 16) % 16, w + (16 - w % 16) % 16

    def idct(x):
        return 0.25 * torch.einsum("bnxy,xyuv->bnuv", x * t["idct_alpha"], t["idct"]) + 128.0

    y2 = _merge(idct(yq * yt), hp, wp)
    cb2 = _merge(idct(cbq * ct), hp // 2, wp // 2)
    cr2 = _merge(idct(crq * ct), hp // 2, wp // 2)

    def up(c):  # nearest 2x chroma upsample
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    ycc2 = torch.stack([y2, up(cb2), up(cr2)], dim=-1)
    rgb = torch.einsum("bhwc,ck->bhwk", ycc2 - t["shift"], t["ycbcr2rgb"])
    rgb = torch.clamp(rgb, 0.0, 255.0) / 255.0
    return rgb[:, :h, :w, :].to(dtype)


def diffjpeg(img, quality):
    """JPEG round-trip. img (B, H, W, 3) RGB in [0,1]; quality a number, or a
    0-d or (B,) tensor on img's device. Returns the compressed-then-decompressed
    image in [0,1]."""
    coefs, tables = jpeg_coefficients(img, quality)
    return jpeg_decode(*(torch.round(c) for c in coefs), tables, img.shape[1], img.shape[2], img.dtype)
